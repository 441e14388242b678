"""EAM forms: finite-difference force + dE/dV pressure checks on a
synthetic FCC crystal (the testForce/testPressure master pattern,
/root/reference/src/forcetest.c, masters.c:134-202)."""

import numpy as np
import pytest

import jax.numpy as jnp

from ddcmd_tpu.nbr.celllist import CellGrid, build_neighbor_list
from ddcmd_tpu.potentials.eam import EamParms, eam_device_tables, eam_eval
from ddcmd_tpu.objects import units as U


def fcc(a_lat, ncell_side):
    base = np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]])
    cells = np.stack(np.meshgrid(*[np.arange(ncell_side)] * 3, indexing="ij"),
                     -1).reshape(-1, 3)
    r = (cells[:, None, :] + base[None, :, :]).reshape(-1, 3) * a_lat
    L = a_lat * ncell_side
    return r - L / 2, L


def make_fs_parms(rcut):
    eV = U.unit_scale("eV")
    Ang = U.unit_scale("Angstrom")
    one = np.ones((1, 1))
    return EamParms(
        form="FS", n_species=1, rcut=rcut,
        pair_tables=dict(a=0.8 * eV * one, b=2.0 * eV * eV * one,
                         c=1.5 * Ang * one, m=5.0 * one, n=7.0 * one,
                         ro=1.0 * Ang * one, x=rcut * one),
        embed_tables={})


def make_sc_parms(rcut):
    eV = U.unit_scale("eV")
    Ang = U.unit_scale("Angstrom")
    one = np.ones((1, 1))
    return EamParms(
        form="SC", n_species=1, rcut=rcut,
        pair_tables=dict(eps=0.012 * eV * one, a=3.6 * Ang * one,
                         n=9.0 * one, m=6.0 * one),
        embed_tables=dict(nce=np.array([-39.4 * 0.012 * eV])))


@pytest.mark.parametrize("make", [make_fs_parms, make_sc_parms])
def test_eam_fd_forces_and_pressure(make):
    a_lat = 0.3615  # nm, Cu
    r, L = fcc(a_lat, 3)
    n = len(r)
    rng = np.random.default_rng(0)
    r = r + rng.standard_normal(r.shape) * 0.005
    rcut = 0.55
    parms = make(rcut)
    tables = eam_device_tables(parms, dtype=jnp.float64)
    grid = CellGrid.plan([L] * 3, rcut, 0.1, n, n)
    Lv = jnp.asarray([L] * 3, jnp.float64)
    rj = jnp.asarray(r, jnp.float64)
    sidx = jnp.zeros(n, jnp.int32)
    fmask = jnp.ones(n, jnp.float64)

    def energy_of(rj):
        nbr, _, ov = build_neighbor_list(rj, fmask, Lv, grid)
        assert not bool(ov)
        return eam_eval(rj, sidx, fmask, nbr, Lv, tables)

    f, e, virial, pe = energy_of(rj)
    f = np.asarray(f)
    assert np.isfinite(float(e)) and float(e) < 0  # cohesive
    assert float(jnp.sum(pe)) == pytest.approx(float(e), rel=1e-10)

    # FD forces
    h = 1e-6
    for i in (0, 17, 53):
        for ax in range(3):
            ep = float(energy_of(rj.at[i, ax].add(h))[1])
            em = float(energy_of(rj.at[i, ax].add(-h))[1])
            fd = -(ep - em) / (2 * h)
            assert f[i, ax] == pytest.approx(fd, rel=1e-5, abs=1e-6), (i, ax)

    # dE/dV vs virial pressure (configurational, per axis)
    vol = L ** 3
    delta = 1e-6
    for ax in range(3):
        lam = np.ones(3)
        lam[ax] = 1 + delta
        lamj = jnp.asarray(lam)
        # note: box scale changes both positions and cell geometry; use
        # scaled Lv too
        def e_scaled(s):
            lam2 = np.ones(3)
            lam2[ax] = s
            l2 = jnp.asarray(lam2)
            nbr, _, _ = build_neighbor_list(rj * l2, fmask, Lv * l2, grid)
            return float(eam_eval(rj * l2, sidx, fmask, nbr, Lv * l2, tables)[1])
        dvol = 2 * delta * vol
        p_fd = -(e_scaled(1 + delta) - e_scaled(1 - delta)) / dvol
        p_vir = float(virial[ax, ax]) / vol
        assert p_fd == pytest.approx(p_vir, rel=2e-3, abs=1e-3), ax


def test_eam_tabular_matches_fs():
    """TABULAR form loaded from files must reproduce the FS analytic form."""
    import os
    import tempfile

    from ddcmd_tpu.potentials.eam import EamParms, compile_eam
    from ddcmd_tpu.objects import ObjectDB

    rcut = 0.55
    fs = make_fs_parms(rcut)

    # write phi/rho and F tables sampled from the FS functions
    a, b, c = fs.pair_tables["a"][0, 0], fs.pair_tables["b"][0, 0], fs.pair_tables["c"][0, 0]
    m, nn, ro, x = (fs.pair_tables[k][0, 0] for k in ("m", "n", "ro", "x"))
    r = np.linspace(0.15, rcut - 1e-4, 4000)
    phi = a * np.exp(c / (r - x) - m * np.log(r / ro))
    rho = b * np.exp(c / (r - x) - nn * np.log(r / ro))
    d = tempfile.mkdtemp()
    with open(os.path.join(d, "pair.dat"), "w") as f:
        for i in range(len(r)):
            f.write(f"{r[i]} {phi[i]} {rho[i]}\n")
    p = np.linspace(1e-6, max(1.0, rho.max() * 30), 8000)
    with open(os.path.join(d, "embed.dat"), "w") as f:
        for i in range(len(p)):
            f.write(f"{p[i]} {-np.sqrt(p[i])}\n")

    db = ObjectDB().compile_string(
        f"pot POTENTIAL {{ type=EAM; form=TABULAR; rmax={rcut} nm; "
        f"Cu-Cu_pair=pair.dat; Cu_embed=embed.dat; }}")

    class Sp:
        name = "Cu"

    parms = compile_eam(db, "pot", [Sp()], d)
    tab_tables = eam_device_tables(parms, dtype=jnp.float64)
    fs_tables = eam_device_tables(fs, dtype=jnp.float64)

    rr, L = fcc(0.3615, 3)
    n = len(rr)
    rng = np.random.default_rng(3)
    rr = rr + rng.standard_normal(rr.shape) * 0.004
    grid = CellGrid.plan([L] * 3, rcut, 0.1, n, n)
    Lv = jnp.asarray([L] * 3, jnp.float64)
    rj = jnp.asarray(rr, jnp.float64)
    sidx = jnp.zeros(n, jnp.int32)
    fmask = jnp.ones(n, jnp.float64)
    nbr, _, _ = build_neighbor_list(rj, fmask, Lv, grid)

    f1, e1, _, _ = eam_eval(rj, sidx, fmask, nbr, Lv, fs_tables)
    f2, e2, _, _ = eam_eval(rj, sidx, fmask, nbr, Lv, tab_tables)
    assert float(e2) == pytest.approx(float(e1), rel=2e-3)
    scale = float(jnp.abs(f1).max())
    assert float(jnp.abs(f2 - f1).max()) / scale < 2e-2  # linear-interp tables


def test_eam_rational_bruteforce_and_fd():
    """RATIONAL form: FIT-object rational functions of r^2 (density/pair)
    and rho (embedding); checked against a brute-force numpy evaluation
    and FD forces (eam_rational.c:27-395)."""
    from ddcmd_tpu.objects import ObjectDB
    from ddcmd_tpu.potentials.eam import compile_eam

    eV = U.unit_scale("eV")
    rcut = 0.55                      # nm
    rc2A = (rcut * 10.0) ** 2        # fit cutoffs are in r^2 (Angstrom^2)
    a = 3.6                          # Angstrom
    epsv = 0.012                     # eV
    db = ObjectDB().compile_string(
        f"pot POTENTIAL {{ type=EAM; form=RATIONAL; rmax={rcut} nm; "
        f"density_type=elementwise; }}\n"
        f"Cu_embedding FIT {{ cutoff=1e30; orderP=2; orderQ=1; "
        f"P=0 -0.3 0.002; Q=1 0.05; xUnits=NONE; yUnits=eV; }}\n"
        f"Cu_density FIT {{ cutoff={rc2A}; orderP=0; orderQ=2; "
        f"P={a ** 4}; Q=0 0 1; xUnits=Angstrom^2; yUnits=NONE; }}\n"
        f"Cu_Cu_2body FIT {{ cutoff={rc2A}; orderP=0; orderQ=3; "
        f"P={epsv * a ** 6}; Q=0 0 0 1; xUnits=Angstrom^2; yUnits=eV; }}\n")

    class Sp:
        name = "Cu"

    parms = compile_eam(db, "pot", [Sp()])
    tables = eam_device_tables(parms, dtype=jnp.float64)

    r, L = fcc(0.3615, 3)
    n = len(r)
    rng = np.random.default_rng(7)
    r = r + rng.standard_normal(r.shape) * 0.005
    grid = CellGrid.plan([L] * 3, rcut, 0.1, n, n)
    Lv = jnp.asarray([L] * 3, jnp.float64)
    rj = jnp.asarray(r, jnp.float64)
    sidx = jnp.zeros(n, jnp.int32)
    fmask = jnp.ones(n, jnp.float64)

    def e_of(rj):
        nbr, _, ov = build_neighbor_list(rj, fmask, Lv, grid)
        assert not bool(ov)
        return eam_eval(rj, sidx, fmask, nbr, Lv, tables)

    f, e, vir, pe = e_of(rj)

    # brute force in numpy (external units, then convert)
    dr = r[:, None, :] - r[None, :, :]
    dr -= L * np.round(dr / L)
    x = np.sum(dr * dr, axis=-1) * 100.0        # r^2 in Angstrom^2
    np.fill_diagonal(x, np.inf)
    ok = x < rc2A
    rho = np.sum(np.where(ok, a ** 4 / x ** 2, 0.0), axis=1)
    phi = np.sum(np.where(ok, epsv * a ** 6 / x ** 3, 0.0))
    F = (-0.3 * rho + 0.002 * rho ** 2) / (1.0 + 0.05 * rho)
    e_ref = (0.5 * phi + F.sum()) * eV
    assert float(e) == pytest.approx(e_ref, rel=1e-10)

    # FD forces
    h = 1e-6
    for i in (0, 29, 77):
        for ax in range(3):
            ep = float(e_of(rj.at[i, ax].add(h))[1])
            em = float(e_of(rj.at[i, ax].add(-h))[1])
            fd = -(ep - em) / (2 * h)
            assert float(f[i, ax]) == pytest.approx(fd, rel=1e-5, abs=1e-6)


def test_pairenergy_series_fd():
    """PAIRENERGY series pair potential: FD force check."""
    from ddcmd_tpu.objects import ObjectDB
    from ddcmd_tpu.potentials.pairenergy import (compile_pairenergy,
                                                 pairenergy_device_tables,
                                                 pairenergy_eval)

    class Sp:
        name = "Cu"

    db = ObjectDB().compile_string(
        "pot POTENTIAL { type=PAIRENERGY; rmax=5.5 Angstrom; "
        "r_expansion=5.5 Angstrom; Cu-Cu_2body= 0.0 0.05 -0.002 0.0001 ; }")
    parms = compile_pairenergy(db, "pot", [Sp()])
    tab = pairenergy_device_tables(parms, jnp.float64)
    rng = np.random.default_rng(0)
    L = 2.2
    m = 5
    g = (np.stack(np.meshgrid(*[np.arange(m)] * 3, indexing="ij"), -1)
         .reshape(-1, 3) + 0.5) / m * L - L / 2
    r = g + rng.standard_normal(g.shape) * 0.01
    n = len(r)
    grid = CellGrid.plan([L] * 3, parms.rcut, 0.05, n, n)
    Lv = jnp.asarray([L] * 3, jnp.float64)
    rj = jnp.asarray(r)
    fmask = jnp.ones(n, jnp.float64)
    sidx = jnp.zeros(n, jnp.int32)

    def e_of(rj):
        nbr, _, ov = build_neighbor_list(rj, fmask, Lv, grid)
        assert not bool(ov)
        return pairenergy_eval(rj, sidx, fmask, nbr, Lv, tab)

    f, e, vir, pe = e_of(rj)
    h = 1e-7
    for i in (0, 30, 99):
        for ax in range(3):
            ep = float(e_of(rj.at[i, ax].add(h))[1])
            em = float(e_of(rj.at[i, ax].add(-h))[1])
            fd = -(ep - em) / (2 * h)
            assert float(f[i, ax]) == pytest.approx(fd, rel=1e-5, abs=1e-5)


def test_ordersh_q6_and_forces():
    """ORDERSH Steinhardt Q6: exact on ideal FCC, AD forces match FD."""
    from ddcmd_tpu.objects import ObjectDB
    from ddcmd_tpu.potentials.ordersh import compile_ordersh, make_ordersh_eval

    db = ObjectDB().compile_string(
        "osh POTENTIAL { type=ORDERSH; L=6; r1o=2.6 Angstrom; r2o=3.0 Angstrom; "
        "lamda=1.0 kJ/mol; }")
    p = compile_ordersh(db, "osh")
    r, L = fcc(0.3615, 3)
    n = len(r)
    ev = make_ordersh_eval(p, n, jnp.float64)
    grid = CellGrid.plan([L] * 3, p.r2o, 0.05, n, n)
    Lv = jnp.asarray([L] * 3)
    rj = jnp.asarray(r)
    fm = jnp.ones(n)
    nbr, _, _ = build_neighbor_list(rj, fm, Lv, grid)
    f, e, vir, pe, phi = ev(rj, fm, nbr, Lv)
    assert float(jnp.sqrt(phi)) == pytest.approx(0.57452, abs=2e-4)

    rng = np.random.default_rng(0)
    rd = jnp.asarray(r + rng.standard_normal(r.shape) * 0.02)
    nbr2, _, _ = build_neighbor_list(rd, fm, Lv, grid)
    f2 = ev(rd, fm, nbr2, Lv)[0]
    h = 1e-7
    for i in (0, 41):
        for ax in range(3):
            ep = float(ev(rd.at[i, ax].add(h), fm, nbr2, Lv)[1])
            em = float(ev(rd.at[i, ax].add(-h), fm, nbr2, Lv)[1])
            fd = -(ep - em) / (2 * h)
            assert float(f2[i, ax]) == pytest.approx(fd, rel=1e-5, abs=1e-6)


def test_eam_cellblock_matches_nlist():
    """Cell-block EAM engine == (N,K)-list engine on a perturbed FCC
    crystal, for the FS analytic and RATIONAL forms."""
    from ddcmd_tpu.ops.cellpair import CellBlockGrid, build_cell_slots
    from ddcmd_tpu.ops.cellpair_eam import eam_cellblock_eval

    a_lat = 0.3615
    r, L = fcc(a_lat, 3)
    n = len(r)
    rng = np.random.default_rng(2)
    r = r + rng.standard_normal(r.shape) * 0.006
    rcut = 0.55
    for make in (make_fs_parms, make_sc_parms):
        parms = make(rcut)
        tables = eam_device_tables(parms, dtype=jnp.float64)
        Lv = jnp.asarray([L] * 3, jnp.float64)
        rj = jnp.asarray(r, jnp.float64)
        sidx = jnp.zeros(n, jnp.int32)
        fmask = jnp.ones(n, jnp.float64)

        grid1 = CellGrid.plan([L] * 3, rcut, 0.1, n, n)
        nbr, _, _ = build_neighbor_list(rj, fmask, Lv, grid1)
        f1, e1, v1, pe1 = eam_eval(rj, sidx, fmask, nbr, Lv, tables)

        cgrid = CellBlockGrid.plan([L] * 3, rcut, 0.1, n)
        perm, ov = build_cell_slots(rj, fmask, Lv, cgrid)
        assert not bool(ov)
        f2, e2, v2, pe2 = eam_cellblock_eval(rj, sidx, fmask, perm, Lv,
                                             cgrid, tables)
        assert float(e2) == pytest.approx(float(e1), rel=1e-9)
        scale = float(jnp.abs(f1).max())
        assert float(jnp.abs(f2 - f1).max()) / scale < 1e-9
        assert np.asarray(v2) == pytest.approx(np.asarray(v1), rel=1e-7)
        assert np.abs(np.asarray(pe2 - pe1)).max() < 1e-9


def test_pair_tablefunction():
    """PAIR function=TableFunction: piecewise-polynomial table matches an
    analytic LJ sampled into per-interval Taylor rows
    (table_function_uniform, table_function.c:85-101)."""
    import os
    import tempfile

    from ddcmd_tpu.objects import ObjectDB
    from ddcmd_tpu.potentials.pair import (compile_pair, pair_device_tables,
                                           pair_lj)

    rcut = 0.54
    sig, eps = 0.34, 1.2

    def v(r):
        s6 = (sig / r) ** 6
        return 4 * eps * (s6 ** 2 - s6)

    def dv(r):
        s6 = (sig / r) ** 6
        return 24 * eps * (s6 - 2 * s6 ** 2) / r

    # cubic Taylor rows on uniform intervals
    x = np.linspace(0.25, 0.56, 312)
    dx = x[1] - x[0]
    h = 1e-5
    rows = []
    for xi in x:
        d2 = (dv(xi + h) - dv(xi - h)) / (2 * h)
        d3 = (dv(xi + h) - 2 * dv(xi) + dv(xi - h)) / h ** 2
        rows.append([xi * 10.0,              # Angstrom in file
                     v(xi), dv(xi) * 0.1, d2 * 0.01 / 2, d3 * 0.001 / 6])
    # file values in kJ/mol + Angstrom: energy conv 1, length conv 0.1
    d = tempfile.mkdtemp()
    with open(os.path.join(d, "table.data"), "w") as f:
        for row in rows:
            f.write(" ".join("%.12e" % z for z in row) + "\n")

    db = ObjectDB().compile_string(
        f"pot POTENTIAL {{ type=PAIR; function=TableFunction; "
        f"number_intervals={len(x)}; number_terms=4; filename=table.data; "
        f"table_energyUnits=kJ*mol^-1; table_lengthUnits=Angstrom; "
        f"Rmax={rcut} nm; }}")

    class Sp:
        name = "A"

    parms = compile_pair(db, "pot", [Sp()], d)
    tab = pair_device_tables(parms, jnp.float64)

    rng = np.random.default_rng(1)
    L = 2.0
    m = 5
    g = (np.stack(np.meshgrid(*[np.arange(m)] * 3, indexing="ij"), -1)
         .reshape(-1, 3) + 0.5) / m * L - L / 2
    r = g + rng.standard_normal(g.shape) * 0.01
    n = len(r)
    grid = CellGrid.plan([L] * 3, rcut, 0.05, n, n)
    Lv = jnp.asarray([L] * 3, jnp.float64)
    rj = jnp.asarray(r)
    fm = jnp.ones(n, jnp.float64)
    sidx = jnp.zeros(n, jnp.int32)
    nbr, _, _ = build_neighbor_list(rj, fm, Lv, grid)
    f, e, vir, pe = pair_lj(rj, sidx, fm, nbr, Lv, tab)

    # brute-force analytic reference
    dmat = r[:, None, :] - r[None, :, :]
    dmat -= L * np.round(dmat / L)
    r2 = (dmat ** 2).sum(-1)
    np.fill_diagonal(r2, np.inf)
    mm = r2 < rcut ** 2
    rr = np.sqrt(np.where(mm, r2, 1.0))
    e_ref = 0.5 * np.where(mm, v(rr), 0.0).sum()
    assert float(e) == pytest.approx(e_ref, rel=1e-6)
    coef = np.where(mm, dv(rr) / rr, 0.0)
    f_ref = -(coef[:, :, None] * dmat).sum(1)
    scale = np.abs(f_ref).max()
    assert np.abs(np.asarray(f) - f_ref).max() / scale < 1e-5


def test_eam_cellblock_half_matches_full():
    """N3L half-stencil EAM == full cell-block engine (FS + SC forms)."""
    from ddcmd_tpu.ops.cellpair import (CellBlockGrid, build_cell_slots,
                                        half_back_map, half_grid)
    from ddcmd_tpu.ops.cellpair_eam import (eam_cellblock_eval,
                                            eam_cellblock_eval_half)

    a_lat = 0.3615
    r, L = fcc(a_lat, 3)
    n = len(r)
    rng = np.random.default_rng(5)
    r = r + rng.standard_normal(r.shape) * 0.006
    rcut = 0.55
    for make in (make_fs_parms, make_sc_parms):
        parms = make(rcut)
        tables = eam_device_tables(parms, dtype=jnp.float64)
        Lv = jnp.asarray([L] * 3, jnp.float64)
        rj = jnp.asarray(r, jnp.float64)
        sidx = jnp.zeros(n, jnp.int32)
        fmask = jnp.ones(n, jnp.float64)

        cgrid = CellBlockGrid.plan([L] * 3, rcut, 0.1, n)
        perm, ov = build_cell_slots(rj, fmask, Lv, cgrid)
        assert not bool(ov)
        f1, e1, v1, pe1 = eam_cellblock_eval(rj, sidx, fmask, perm, Lv,
                                             cgrid, tables)
        hg = half_grid(cgrid)
        bm = half_back_map(hg)
        f2, e2, v2, pe2 = eam_cellblock_eval_half(rj, sidx, fmask, perm, Lv,
                                                  hg, tables, bm)
        assert float(e2) == pytest.approx(float(e1), rel=1e-9)
        scale = float(jnp.abs(f1).max())
        assert float(jnp.abs(f2 - f1).max()) / scale < 1e-9
        assert np.asarray(v2) == pytest.approx(np.asarray(v1), rel=1e-7)
        assert np.abs(np.asarray(pe2 - pe1)).max() < 1e-9


def test_eam_multispecies_asymmetric_density_fd():
    """Asymmetric 2-species density tables: forces must equal -dE/dr on
    ALL engines (the j-side embedding derivative needs the transposed
    dp(t_j, t_i); regression for the non-conservative combine rule)."""
    from ddcmd_tpu.ops.cellpair import (CellBlockGrid, build_cell_slots,
                                        half_back_map, half_grid)
    from ddcmd_tpu.ops.cellpair_eam import (eam_cellblock_eval,
                                            eam_cellblock_eval_half)

    eV = U.unit_scale("eV")
    Ang = U.unit_scale("Angstrom")
    rcut = 0.55
    # FS form with an ASYMMETRIC b (density) table: rho_i sums
    # b[t_i, t_j] (r - c)^2-style terms, so dp(t_i,t_j) != dp(t_j,t_i)
    a = np.array([[0.8, 0.7], [0.7, 0.9]]) * eV
    b = np.array([[2.0, 3.5], [1.2, 2.6]]) * eV * eV     # asymmetric!
    c = np.array([[1.5, 1.4], [1.4, 1.6]]) * Ang
    m = np.full((2, 2), 5.0)
    nn = np.full((2, 2), 7.0)
    ro = np.full((2, 2), 1.0) * Ang
    x = np.full((2, 2), rcut)
    parms = EamParms(form="FS", n_species=2, rcut=rcut,
                     pair_tables=dict(a=a, b=b, c=c, m=m, n=nn, ro=ro, x=x),
                     embed_tables={})
    tables = eam_device_tables(parms, dtype=jnp.float64)

    a_lat = 0.3615
    r, L = fcc(a_lat, 3)
    n = len(r)
    rng = np.random.default_rng(9)
    r = r + rng.standard_normal(r.shape) * 0.008
    sidx = jnp.asarray(rng.integers(0, 2, n), jnp.int32)
    rj = jnp.asarray(r, jnp.float64)
    fmask = jnp.ones(n, jnp.float64)
    Lv = jnp.asarray([L] * 3, jnp.float64)

    grid1 = CellGrid.plan([L] * 3, rcut, 0.1, n, n)
    nbr, _, _ = build_neighbor_list(rj, fmask, Lv, grid1)
    cgrid = CellBlockGrid.plan([L] * 3, rcut, 0.1, n)
    perm, _ = build_cell_slots(rj, fmask, Lv, cgrid)
    hg = half_grid(cgrid)
    bm = half_back_map(hg)

    engines = {
        "nlist": lambda rr: eam_eval(rr, sidx, fmask, nbr, Lv, tables),
        "full": lambda rr: eam_cellblock_eval(rr, sidx, fmask, perm, Lv,
                                              cgrid, tables),
        "half": lambda rr: eam_cellblock_eval_half(rr, sidx, fmask, perm,
                                                   Lv, hg, tables, bm),
    }
    outs = {k: fn(rj) for k, fn in engines.items()}
    # engines agree with each other
    for k in ("full", "half"):
        assert float(outs[k][1]) == pytest.approx(float(outs["nlist"][1]),
                                                  rel=1e-9)
        np.testing.assert_allclose(np.asarray(outs[k][0]),
                                   np.asarray(outs["nlist"][0]),
                                   rtol=1e-8, atol=1e-10)
    # FD check on a few atoms (nlist engine; lists stay valid for tiny h)
    h = 1e-6
    f = np.asarray(outs["nlist"][0])
    for i in (0, 7, 33):
        for ax in range(3):
            ep = float(engines["nlist"](rj.at[i, ax].add(h))[1])
            em = float(engines["nlist"](rj.at[i, ax].add(-h))[1])
            fd = -(ep - em) / (2 * h)
            assert f[i, ax] == pytest.approx(fd, rel=2e-5, abs=1e-7)


def test_eam_tabular_fit_rational():
    """deck `tabularFit=rational`: TABULAR tables refit to the RATIONAL
    form (analytic evaluation: pure flops, no per-pair interval gathers).
    The fitted form must track the underlying smooth FS functions the
    tables sampled."""
    import os
    import tempfile

    from ddcmd_tpu.objects import ObjectDB
    from ddcmd_tpu.potentials.eam import compile_eam

    rcut = 0.55
    fs = make_fs_parms(rcut)
    a, b, c = (fs.pair_tables[k][0, 0] for k in ("a", "b", "c"))
    m, nn, ro, x = (fs.pair_tables[k][0, 0] for k in ("m", "n", "ro", "x"))
    r = np.linspace(0.15, rcut - 1e-4, 4000)
    phi = a * np.exp(c / (r - x) - m * np.log(r / ro))
    rho = b * np.exp(c / (r - x) - nn * np.log(r / ro))
    d = tempfile.mkdtemp()
    with open(os.path.join(d, "pair.dat"), "w") as f:
        for i in range(len(r)):
            f.write(f"{r[i]} {phi[i]} {rho[i]}\n")
    p = np.linspace(1e-6, max(1.0, rho.max() * 30), 8000)
    with open(os.path.join(d, "embed.dat"), "w") as f:
        for i in range(len(p)):
            f.write(f"{p[i]} {-np.sqrt(p[i])}\n")

    db = ObjectDB().compile_string(
        f"pot POTENTIAL {{ type=EAM; form=TABULAR; rmax={rcut} nm; "
        f"tabularFit=rational; tabularFitTol=5e-3; "
        f"Cu-Cu_pair=pair.dat; Cu_embed=embed.dat; }}")

    class Sp:
        name = "Cu"

    parms = compile_eam(db, "pot", [Sp()], d)
    assert parms.form == "RATIONAL"
    fit_tables = eam_device_tables(parms, dtype=jnp.float64)
    assert fit_tables["form"] == "RATIONAL"
    fs_tables = eam_device_tables(fs, dtype=jnp.float64)

    rr, L = fcc(0.3615, 3)
    n = len(rr)
    rng = np.random.default_rng(3)
    rr = rr + rng.standard_normal(rr.shape) * 0.004
    grid = CellGrid.plan([L] * 3, rcut, 0.1, n, n)
    Lv = jnp.asarray([L] * 3, jnp.float64)
    rj = jnp.asarray(rr, jnp.float64)
    sidx = jnp.zeros(n, jnp.int32)
    fmask = jnp.ones(n, jnp.float64)
    nbr, _, _ = build_neighbor_list(rj, fmask, Lv, grid)

    f1, e1, _, _ = eam_eval(rj, sidx, fmask, nbr, Lv, fs_tables)
    f2, e2, _, _ = eam_eval(rj, sidx, fmask, nbr, Lv, fit_tables)
    assert float(e2) == pytest.approx(float(e1), rel=5e-3)
    scale = float(jnp.abs(f1).max())
    assert float(jnp.abs(f2 - f1).max()) / scale < 2e-2


def test_ordersh_multi_l_local_and_files(tmp_path):
    """ORDERSH multi-L (orderSH.c:83 takes up to 16 L values): per-atom
    local order (orderSHlocal) hits the literature FCC q6/q4, a brute
    O(N^2) cross-check validates the neighbor machinery, and the q{L}
    snapshot shards (writeqlocal, orderSH.c:832-886) roundtrip through
    the FILEHEADER reader with valid CRCs."""
    from ddcmd_tpu.io.fastio import crc32_rows
    from ddcmd_tpu.objects import ObjectDB
    from ddcmd_tpu.objects.parser import read_fileheader
    from ddcmd_tpu.potentials.ordersh import (_order_dot, _ylm_pairs,
                                              compile_ordersh,
                                              ordersh_clusters,
                                              ordersh_local,
                                              write_qlocal_files)

    db = ObjectDB().compile_string(
        "osh POTENTIAL { type=ORDERSH; L=6 4; r1o=2.6 Angstrom; "
        "r2o=3.0 Angstrom; lamda=1.0 kJ/mol; clusterWrite=1; }")
    p = compile_ordersh(db, "osh")
    assert p.L_list == (6, 4) and p.L == 6 and p.cluster_write

    # ideal FCC: literature Steinhardt values with the 12-neighbor shell
    r, L = fcc(0.3615, 3)
    loc = ordersh_local(r, [L] * 3, p)
    assert np.allclose(loc["qnorm"][6], 0.57452, atol=2e-4)
    assert np.allclose(loc["qnorm"][4], 0.19094, atol=2e-4)
    assert np.allclose(loc["Q"], 1.0, atol=1e-6)     # perfect alignment
    assert (loc["C"] == 12).all()

    # brute O(N^2) cross-check on a random config (both L values)
    rng = np.random.default_rng(7)
    n2 = 96
    L2 = 1.6
    r2 = rng.uniform(-L2 / 2, L2 / 2, (n2, 3))
    p2 = compile_ordersh(ObjectDB().compile_string(
        "o2 POTENTIAL { type=ORDERSH; L=6 4; r1o=3.5 Angstrom; "
        "r2o=5.0 Angstrom; }"), "o2")
    loc2 = ordersh_local(r2, [L2] * 3, p2)
    L3v = np.array([L2] * 3)
    for Lval in (6, 4):
        qb = np.zeros((n2, Lval + 1), complex)
        Wb = np.zeros(n2)
        for i in range(n2):
            for j in range(n2):
                if i == j:
                    continue
                d = r2[i] - r2[j]
                d -= L3v * np.round(d / L3v)
                dist = np.linalg.norm(d)
                if dist >= p2.r2o:
                    continue
                t = np.clip((dist - p2.r1o) / (p2.r2o - p2.r1o), 0, 1)
                w = 0.5 + 0.5 * np.cos(np.pi * t)
                u = (-d / dist)[None, None, :]
                qb[i] += w * _ylm_pairs(u, Lval)[0, 0]
                Wb[i] += w
        mag = np.sqrt(_order_dot(qb, qb))
        qhat = qb / mag[:, None]
        qn = mag * np.sqrt(4 * np.pi / (2 * Lval + 1)) / Wb
        assert np.abs(loc2["qlocal"][Lval] - qhat).max() < 1e-10
        assert np.abs(loc2["qnorm"][Lval] - qn).max() < 1e-10

    # q{L} files + cluster dump through a minimal sim shim
    class _NS:
        pass

    sim = _NS()
    sim.sysdef = _NS()
    sim.sysdef.potentials = [("ORDERSH", "osh", p)]
    sim.sysdef.state = _NS()
    sim.sysdef.state.n_local = len(r)
    sim.sysdef.collection = _NS()
    sim.sysdef.collection.gid = np.arange(len(r), dtype=np.int64)
    sim.ss = _NS()
    sim.ss.state = _NS()
    sim.ss.state.r = np.asarray(r)
    sim.ss.box = _NS()
    sim.ss.box.lengths = np.array([L] * 3)
    sim.ss.loop = 42
    write_qlocal_files(sim, str(tmp_path))
    for Lval in (6, 4):
        path = tmp_path / f"q{Lval}#000000"
        hdr, off = read_fileheader(path)
        assert hdr.get_int("recordLength", 0) == 4 * (1 + 2 * (Lval + 1))
        assert hdr.get_int("nrecord", 0) == len(r)
        lrec = hdr.get_int("recordLength", 0)
        blob = path.read_bytes()[off:]
        recs = np.frombuffer(blob, np.uint8).reshape(len(r), lrec)
        crc = recs[:, :4].copy().view("<u4").ravel()
        assert (crc32_rows(recs, skip=4) == crc).all()
        flat = recs[:, 4:].copy().view("<f4").reshape(len(r), -1)
        q = flat[:, 0::2] + 1j * flat[:, 1::2]
        assert np.abs(q - loc["qlocal"][Lval]).max() < 1e-6
    # single crystal: one cluster holding every atom
    rows, clusters = ordersh_clusters(r, [L] * 3, p, loc,
                                      sim.sysdef.collection.gid)
    assert len(clusters) == 1 and clusters[0]["size"] == len(r)
    assert (tmp_path / "cluster.000000").exists()
