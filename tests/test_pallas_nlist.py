"""The pallas neighbor-list pair kernel (ops/pallas_nlist.py) in interpret
mode on the CPU: parity with the XLA nlist and cellblock engines, the
in-kernel exclusion channels, the wrapper's padding, engine routing."""

import pathlib
import warnings

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from ddcmd_tpu.nbr.celllist import CellGrid, build_neighbor_list
from ddcmd_tpu.ops.cellpair import CellBlockGrid, build_cell_slots, cellpair_eval
from ddcmd_tpu.ops.pallas_nlist import (make_nlist_kernel, nlist_geom,
                                        nlist_pair_eval, pack_records)
from ddcmd_tpu.potentials.martini import martini_nonbond

from tests.test_nbr_martini import make_system


def _tables(sigma, eps, shift, rcut, krf, crf, keR, dtype=jnp.float32):
    return dict(sigma=jnp.asarray(sigma, dtype), eps=jnp.asarray(eps, dtype),
                shift=jnp.asarray(shift, dtype),
                rcut2=jnp.asarray(rcut ** 2, dtype),
                krf=jnp.asarray(krf, dtype), crf=jnp.asarray(crf, dtype),
                keR=jnp.asarray(keR, dtype))


def _system(n, L, charged, seed=11, skin=0.3):
    r, q, tidx, sigma, eps, shift, rcut, krf, crf, keR = make_system(
        n=n, L=L, seed=seed, charged=charged)
    tables = _tables(sigma, eps, shift, rcut, krf, crf, keR)
    rj = jnp.asarray(r, jnp.float32)
    Lv = jnp.asarray([L] * 3, jnp.float32)
    fmask = jnp.ones(n, jnp.float32)
    grid = CellGrid.plan([L] * 3, rcut, skin, n, n)
    nbr, _, ov = build_neighbor_list(rj, fmask, Lv, grid)
    assert not bool(ov)
    return (rj, jnp.asarray(q, jnp.float32), jnp.asarray(tidx, jnp.int32),
            fmask, nbr, Lv, tables, rcut, skin)


def _self_energy(q, fmask, tables):
    return -0.5 * q * q * fmask * tables["keR"] * tables["crf"]


@pytest.mark.parametrize("charged", [False, True])
@pytest.mark.parametrize("n,L", [(220, 4.2), (800, 6.6), (60, 2.6),
                                 (2600, 6.0)])
def test_kernel_matches_xla_engines(n, L, charged):
    """Kernel == the XLA nlist evaluation (same list) and the XLA
    cellblock engine, across cell geometries incl. 1- and 2-cell axes."""
    rj, qj, tj, fmask, nbr, Lv, tables, rcut, skin = _system(n, L, charged)
    f_n, e_n, v_n, pe_n, _ = martini_nonbond(rj, qj, tj, fmask, nbr, Lv,
                                             tables)
    f_k, e_k, v_k, pe_k = nlist_pair_eval(rj, qj, tj, fmask, nbr, Lv, tables,
                                          coulomb=charged, interpret=True)
    e_self = _self_energy(qj, fmask, tables)
    e_k = e_k + jnp.sum(e_self)
    pe_k = pe_k + e_self
    # 1e-5: XLA's float32 a - b - L*k min-image carries the box-scale
    # rounding of a - b into every boundary pair (the kernel's TwoSum
    # does not); on the dense (2600, 6.0) overlaps that is 5e-6 of the
    # largest force
    scale = max(1.0, float(jnp.abs(f_n).max()))
    assert float(jnp.abs(f_k - f_n).max()) / scale < 1e-5
    assert float(e_k) == pytest.approx(float(e_n), rel=1e-5, abs=1e-3)
    np.testing.assert_allclose(np.asarray(v_k), np.asarray(v_n),
                               rtol=1e-4, atol=1e-2)
    np.testing.assert_allclose(np.asarray(pe_k), np.asarray(pe_n),
                               rtol=1e-4, atol=1e-3)

    cgrid = CellBlockGrid.plan([L] * 3, rcut, skin, n)
    perm, ov = build_cell_slots(rj, fmask, Lv, cgrid)
    assert not bool(ov)
    f_c, e_c, v_c, _ = cellpair_eval(rj, qj, tj, perm, Lv, cgrid, tables,
                                     coulomb=charged)
    if charged:
        e_c = e_c + jnp.sum(e_self)
    assert float(jnp.abs(f_k - f_c).max()) / scale < 2e-5
    assert float(e_k) == pytest.approx(float(e_c), rel=1e-4, abs=1e-2)


def test_kernel_box_boundary_pairs_are_float32_exact():
    """Pairs across the periodic boundary keep float32 accuracy of the
    displacement (TwoSum min-image): forces match float64 evaluation of
    the same float32 inputs to ~1e-6 of scale."""
    rj, qj, tj, fmask, nbr, Lv, tables, rcut, _ = _system(800, 6.6, True)
    t64 = {k: v.astype(jnp.float64) for k, v in tables.items()}
    f64, e64, _, _, _ = martini_nonbond(
        rj.astype(jnp.float64), qj.astype(jnp.float64), tj,
        fmask.astype(jnp.float64), nbr, Lv.astype(jnp.float64), t64)
    f_k, e_k, _, _ = nlist_pair_eval(rj, qj, tj, fmask, nbr, Lv, tables,
                                     interpret=True)
    e_k = e_k + jnp.sum(_self_energy(qj, fmask, tables))
    scale = float(jnp.abs(f64).max())
    assert float(jnp.abs(f_k - f64).max()) / scale < 5e-6
    assert float(e_k) == pytest.approx(float(e64), rel=1e-6)


def test_kernel_uniform_type_scalar_params():
    """T == 1 kernel path (scalar LJ parameters) == the table path."""
    rj, qj, tj, fmask, nbr, Lv, tables, _, _ = _system(220, 4.2, True)
    t1 = dict(tables, **{k: tables[k][:1, :1] for k in
                         ("sigma", "eps", "shift")})
    t2 = dict(tables, **{k: jnp.full((2, 2), tables[k][0, 0]) for k in
                         ("sigma", "eps", "shift")})
    out1 = nlist_pair_eval(rj, qj, jnp.zeros_like(tj), fmask, nbr, Lv, t1,
                           interpret=True)
    out2 = nlist_pair_eval(rj, qj, tj, fmask, nbr, Lv, t2, interpret=True)
    for a, b in zip(out1, out2):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("block", [(16, 32), (32, 64), (64, 128)])
def test_kernel_blocks_and_padding(block):
    """Rows past N and list columns past K pad to the kernel blocks with
    sentinels; every block shape gives the same forces."""
    BM, BK = block
    rj, qj, tj, fmask, nbr, Lv, tables, _, _ = _system(61, 2.6, True)
    n = rj.shape[0]
    ref = nlist_pair_eval(rj, qj, tj, fmask, nbr, Lv, tables,
                          interpret=True)
    n_rows = -(-n // BM) * BM
    K = -(-nbr.shape[1] // BK) * BK
    ev = make_nlist_kernel(n_rows, n + 1, K, tables, block_rows=BM,
                           block_nbrs=BK, interpret=True)
    nb = jnp.pad(nbr, ((0, n_rows - n), (0, K - nbr.shape[1])),
                 constant_values=n)
    out, rows = ev(nb, pack_records(rj, qj, tj, fmask > 0),
                   nlist_geom(Lv, tables["rcut2"]))
    np.testing.assert_allclose(np.asarray(out[:3, :n].T),
                               np.asarray(ref[0]), rtol=1e-6, atol=1e-4)
    assert float(jnp.sum(rows[:, 0])) == pytest.approx(float(ref[1]),
                                                       rel=1e-6)
    # padded rows carry nothing
    assert float(jnp.abs(out[:, n:]).max(initial=0.0)) == 0.0


def test_kernel_rejects_unaligned_blocks():
    tables = _tables(np.ones((1, 1)), np.ones((1, 1)), np.zeros((1, 1)),
                     1.0, 0.0, 0.0, 0.0)
    with pytest.raises(ValueError):
        make_nlist_kernel(30, 31, 64, tables, block_rows=16)
    with pytest.raises(ValueError):
        make_nlist_kernel(32, 33, 48, tables, block_nbrs=32)


def test_kernel_uses_no_dot():
    """The tile math is exact-f32 elementwise arithmetic: no dot, so the
    GPU's TF32 tensor-core path can never enter the kernel."""
    import ddcmd_tpu.ops.pallas_nlist as mod

    src = pathlib.Path(mod.__file__).read_text()
    assert "dot(" not in src and "dot_general" not in src


def test_package_forces_full_f32_matmuls():
    """Geometry matmuls outside the kernel (min-image r @ hinv.T, NPT
    rescale r @ A.T, constraint selection matrices) would run in TF32 on
    the GPU at default precision; the package __init__ pins the global
    default to full f32."""
    import ddcmd_tpu  # noqa: F401  (import applies the config)

    assert jax.config.jax_default_matmul_precision == "highest"


def test_excl_channels_encoding():
    """The (mol, B + 2^-intra) record encoding reproduces the exclusion
    matrix exactly through the kernel's f32 bit-extraction math."""
    from ddcmd_tpu.run.forces import _excl_channels

    # a DPPC-like 12-bead chain + a 3-bead branch component
    ex = [(i, i + 1) for i in range(11)] + [(20, 21), (21, 22), (20, 22)]
    vals = _excl_channels(ex, 32)
    assert vals is not None
    v = np.asarray(vals, np.float32)
    excl_set = {(a, b) for a, b in ex} | {(b, a) for a, b in ex}
    for i in range(32):
        for j in range(32):
            if i == j:
                continue
            same = v[i, 0] == v[j, 0] and v[i, 0] != 0.0
            B_i = np.float32(np.floor(v[i, 1]))
            w_j = np.float32(v[j, 1] - np.floor(v[j, 1]))
            t = np.float32(np.floor(B_i * (w_j + w_j)))
            bit = t - 2.0 * np.float32(np.floor(t * np.float32(0.5)))
            kernel_excl = bool(same and bit > 0.5)
            assert kernel_excl == ((i, j) in excl_set), (i, j)
    # oversized component falls back (returns None)
    assert _excl_channels([(i, i + 1) for i in range(13)], 20) is None


def _bilayer(tmp_path, nx=4):
    from ddcmd_tpu.models import load, martini_bilayer

    d = str(tmp_path)
    martini_bilayer(d, nx=nx, ny=nx, water_nm=1.2)
    return lambda: load(d), d


@pytest.mark.parametrize("coords", ["deck", "compressed"])
def test_kernel_exclusions_match_nlist(tmp_path, coords):
    """Bilayer deck: the kernel's in-kernel exclusion masking == the XLA
    nlist engine's in-list masking, incl. a bonded pair compressed to
    0.12 nm (the rare deep fluctuation whose LJ wall must never enter a
    float32 sum)."""
    from ddcmd_tpu.run.forces import _excl_channels, _excl_table
    from ddcmd_tpu.potentials.martini import martini_device_tables
    from ddcmd_tpu.run.simulate import Simulation

    loader, d = _bilayer(tmp_path)
    db, base = loader()
    sim = Simulation(db, base, run_dir=d, engine="nlist")
    sd = sim.sysdef
    st = sim.ss.state
    r = np.asarray(st.r).copy()
    if coords == "compressed":
        # GL1-GL2 of the first lipid are rows 2, 3 (martini_bilayer bead order)
        dv = r[3] - r[2]
        r[3] = r[2] + dv / np.linalg.norm(dv) * 0.12
    ss = sim.ss.replace(state=st.replace(r=jnp.asarray(r, jnp.float32)))
    ss, nbr, ov = sim._build_nbr_jit(ss)
    assert not bool(ov)
    st = ss.state
    parms = next(p[2] for p in sd.potentials if p[0] == "MARTINI")
    tables = martini_device_tables(parms)
    tidx = jnp.asarray(parms.species_lj_type)[st.species]
    ex = jnp.asarray(_excl_channels(sd.bonded.exclusions, st.n_pad))
    et = jnp.asarray(_excl_table(sd.bonded.exclusions, st.n_pad))
    f0, e0, v0, _, _ = martini_nonbond(st.r, st.q, tidx, st.fmask, nbr,
                                       ss.box.lengths, tables, excl_tbl=et)
    f1, e1, v1, _ = nlist_pair_eval(st.r, st.q, tidx, st.fmask, nbr,
                                    ss.box.lengths, tables, excl_vals=ex,
                                    interpret=True)
    e1 = e1 + jnp.sum(_self_energy(st.q, st.fmask, tables))
    scale = float(jnp.abs(f0).max())
    assert scale < 1e5          # the masked LJ wall never appears
    assert float(jnp.abs(f1 - f0).max()) / scale < 1e-5   # see above
    assert float(e1) == pytest.approx(float(e0), rel=1e-6)


def test_pallas_engine_end_to_end(tmp_path):
    """Simulation(engine='pallas', interpret=True) tracks the nlist and
    cellblock engines through real MD steps on the bilayer deck (bonds,
    angles, constraints, charges, NPT, in-kernel exclusions)."""
    from ddcmd_tpu.run.forces import _inlist_excl
    from ddcmd_tpu.run.simulate import Simulation

    loader, d = _bilayer(tmp_path)
    out = {}
    for eng, kw in (("pallas", {"interpret": True}), ("nlist", {}),
                    ("cellblock", {})):
        db, base = loader()
        sim = Simulation(db, base, run_dir=d, engine=eng, **kw)
        sim.first_energy()
        sim.key = jax.random.PRNGKey(3)
        sim.run(24, print_fn=lambda s: None)
        out[eng] = (float(sim.ss.energy.eion), float(sim.ss.energy.rk))
        if eng == "pallas":
            assert _inlist_excl(sim.sysdef, "pallas")
            assert sim.n_rollbacks == 0
    assert out["pallas"][0] == pytest.approx(out["nlist"][0], rel=1e-5)
    assert out["pallas"][1] == pytest.approx(out["nlist"][1], rel=1e-4)
    assert out["pallas"][0] == pytest.approx(out["cellblock"][0], rel=2e-4)


# ---------------------------------------------------------------------------
# engine routing (run/forces.choose_engine)
# ---------------------------------------------------------------------------

def _deck(tmp_path, kind):
    from ddcmd_tpu.core.system import build_system
    from ddcmd_tpu.models import eam_crystal, lj_fluid, load, martini_bilayer

    d = str(tmp_path)
    if kind == "eam":
        eam_crystal(d, nc=3)
    elif kind == "bilayer":
        martini_bilayer(d, nx=2, ny=2, water_nm=1.0)
    else:
        lj_fluid(d, n=200)
    db, base = load(d)
    return build_system(db, base)


@pytest.mark.parametrize("kind,backend,dtype,req,expect", [
    ("lj", "cpu", "f32", "auto", "cellblock"),
    ("lj", "gpu", "f32", "auto", "pallas"),
    ("lj", "gpu", "f64", "auto", "nlist"),           # kernel is f32
    ("eam", "gpu", "f32", "auto", "nlist"),          # no EAM kernel
    ("bilayer", "gpu", "f32", "auto", "pallas"),     # in-kernel excl
    ("bilayer", "cpu", "f32", "nlist", "nlist"),
    ("lj", "cpu", "f32", "pallas", ValueError),      # no GPU
    ("eam", "gpu", "f32", "pallas", ValueError),
    ("lj", "gpu", "f32", "bogus", ValueError),
])
def test_choose_engine(tmp_path, kind, backend, dtype, req, expect):
    from ddcmd_tpu.run.forces import choose_engine

    sd = _deck(tmp_path, kind)
    dt = jnp.float64 if dtype == "f64" else jnp.float32
    if expect is ValueError:
        with pytest.raises(ValueError):
            choose_engine(sd, dt, req, backend=backend)
    else:
        assert choose_engine(sd, dt, req, backend=backend) == expect


def test_choose_engine_interpret_runs_kernel_on_cpu(tmp_path):
    from ddcmd_tpu.run.forces import choose_engine

    sd = _deck(tmp_path, "lj")
    assert choose_engine(sd, jnp.float32, "pallas", backend="cpu",
                         interpret=True) == "pallas"


def test_wide_exclusion_graph_demotes_pallas(tmp_path, monkeypatch):
    """A >12-member exclusion component never runs the kernel in f32
    compute-then-subtract mode: auto on a GPU picks the in-list-masking
    nlist engine with a warning, an explicit engine='pallas' raises, and
    DDCMD_INLIST_EXCL=0 opts back into subtract mode explicitly."""
    from ddcmd_tpu.run.forces import choose_engine

    sd = _deck(tmp_path, "bilayer")
    extra = np.stack([np.arange(14), np.arange(1, 15)], axis=1)
    sd.bonded.exclusions = np.concatenate(
        [np.asarray(sd.bonded.exclusions), extra])
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        assert choose_engine(sd, jnp.float32, "auto", backend="gpu") == "nlist"
    assert any("12-member" in str(x.message) for x in w)
    with pytest.raises(ValueError):
        choose_engine(sd, jnp.float32, "pallas", backend="gpu")
    monkeypatch.setenv("DDCMD_INLIST_EXCL", "0")
    assert choose_engine(sd, jnp.float32, "auto", backend="gpu") == "pallas"
