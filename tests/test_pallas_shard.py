"""Sharded pallas engine: the pair kernel under the brick mesh.

Validates parallel/brickstep_pallas: per-device neighbor lists of the
local rows over the local+ghost pool, frozen halo routing with per-step
position refresh, and the reverse reduce of bonded ghost shares --
against the (N,K) nlist brick engine and the single-device evaluation.
The kernel runs in interpret mode on the 8-device CPU mesh
(tests/conftest).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

import __graft_entry__ as ge
from ddcmd_tpu.core.groups import Group, GroupTable
from ddcmd_tpu.nbr.celllist import CellGrid, build_neighbor_list
from ddcmd_tpu.parallel.brick import (BrickPlan, distribute_bricks,
                                      halo_exchange_3d, halo_reduce_3d,
                                      halo_refresh_3d)
from ddcmd_tpu.parallel.brickstep import make_brick_mesh
from ddcmd_tpu.parallel.brickstep_pallas import make_brick_step_pallas
from ddcmd_tpu.potentials.martini import martini_nonbond

SHAPE = (2, 2, 2)


def _setup(L=6.4, rcut=0.6, skin=0.15):
    n = int(np.ceil(L / 0.5)) ** 3
    arrays, L, rcut, tables = ge._synthetic_system(n=n, L=L, rcut=rcut,
                                                   sigma0=0.4)
    gid64 = arrays.pop("gid")
    arrays["gid"] = np.stack([(gid64 & 0xFFFFFFFF).astype(np.uint32),
                              (gid64 >> 32).astype(np.uint32)], axis=1)
    for k in ("r", "v", "q", "mass"):
        arrays[k] = arrays[k].astype(np.float32)
    n_dev = int(np.prod(SHAPE))
    plan = BrickPlan(shape=SHAPE, local_cap=8 * n // n_dev,
                     halo_cap=4 * n // n_dev, migrate_cap=256,
                     rlist=rcut + skin)
    return arrays, L, rcut, skin, tables, plan, n


def _shard(mesh, buf):
    put = lambda a: jax.device_put(
        jnp.asarray(a), NamedSharding(mesh, P(("bx", "by", "bz"))))
    return {k: put(v) for k, v in buf.items()}, put


def _pool_grid(L, rcut, skin, n, plan):
    return CellGrid.plan([L] * 3, rcut, skin, n,
                         plan.local_cap + plan.ghost_cap)


@pytest.mark.parametrize("engine,kw,dtype,expect", [
    ("auto", {}, "f32", "nlist"),                     # CPU: no kernel
    ("auto", {"interpret": True}, "f32", "pallas"),
    ("pallas", {"interpret": True}, "f32", "pallas"),
    ("nlist", {"interpret": True}, "f32", "nlist"),
    ("auto", {"interpret": True}, "f64", "nlist"),    # kernel is f32
    ("pallas", {}, "f32", ValueError),                # needs a GPU
    ("pallas", {"interpret": True}, "f64", ValueError),
])
def test_shard_engine_routing(tmp_path, engine, kw, dtype, expect):
    """ParallelSimulation's per-device engine: the kernel where it runs
    (a GPU, or interpret mode in tests), nlist otherwise; an explicit
    request that cannot be honoured raises."""
    from ddcmd_tpu.models import lj_fluid, load
    from ddcmd_tpu.run.parallel_sim import ParallelSimulation

    lj_fluid(str(tmp_path), n=400)
    db, base = load(str(tmp_path))
    dt = jnp.float64 if dtype == "f64" else jnp.float32
    if expect is ValueError:
        with pytest.raises(ValueError):
            ParallelSimulation(db, base, shape=(1, 1, 1), dtype=dt,
                               engine=engine, **kw)
        return
    psim = ParallelSimulation(db, base, shape=(1, 1, 1), dtype=dt,
                              engine=engine, **kw)
    assert psim.shard_engine == expect


def test_halo_routing_refresh_and_reduce():
    """The frozen-routing position refresh reproduces the rebuild-time
    exchange, and the reverse reduce lands every ghost contribution on
    exactly its source atom (ddcUpdate/ddcUpdateForce semantics)."""
    arrays, L, rcut, skin, tables, plan, n = _setup()
    mesh = make_brick_mesh(SHAPE)
    buf, mask, counts = distribute_bricks(arrays, [L] * 3, plan)
    fields, put = _shard(mesh, buf)
    maskd = put(mask)

    def go(fields, mask):
        Lv = jnp.asarray([L] * 3, jnp.float32)
        ghosts, gmask, ov, routing = halo_exchange_3d(
            {k: fields[k] for k in ("r", "q")}, mask, Lv, plan,
            with_routing=True)
        # per-step refresh must rebuild the same ghost positions
        pool_r = halo_refresh_3d(fields["r"], routing, plan)
        same = jnp.where(gmask[:, None],
                         pool_r[mask.shape[0]:] - ghosts["r"], 0.0)
        # reverse reduce: charge 1 unit per VALID ghost row; each source
        # atom must receive exactly the number of ghost copies of itself
        ship = jnp.concatenate(
            [jnp.zeros((mask.shape[0], 1), jnp.float32),
             gmask[:, None].astype(jnp.float32)])
        copies = halo_reduce_3d(ship, routing, plan, mask.shape[0])
        return same, copies, gmask, ov

    from jax.sharding import PartitionSpec as P2
    PS = P2(("bx", "by", "bz"))
    f = jax.jit(jax.shard_map(
        go, mesh=mesh, in_specs=({k: PS for k in fields}, PS),
        out_specs=(PS, PS, PS, P2()), check_vma=False))
    same, copies, gmask, ov = f(fields, maskd)
    assert int(ov) == 0
    assert float(jnp.abs(same).max()) == 0.0
    # total ghost copies mesh-wide == total received back
    assert float(jnp.sum(copies)) == float(jnp.sum(gmask))
    # every valid atom has >= 1 ghost copy only if it sat in some halo
    # window; no atom receives copies without being valid
    m = np.asarray(maskd)
    assert (np.asarray(copies)[~m] == 0).all()


def test_pallas_shard_forces_match_single_device():
    """First forces via the sharded pallas engine == the single-device
    (N,K) full-list evaluation (multi-LJ-type system exercises the
    T-select path)."""
    arrays, L, rcut, skin, tables, plan, n = _setup()

    grid1 = CellGrid.plan([L] * 3, rcut, skin, n, n)
    rj = jnp.asarray(arrays["r"])
    fmask = jnp.ones(n, jnp.float32)
    Lv = jnp.asarray([L] * 3, jnp.float32)
    nbr, _, ov = build_neighbor_list(rj, fmask, Lv, grid1)
    assert not bool(ov)
    f_ref, e_ref, v_ref, pe_ref, _ = martini_nonbond(
        rj, jnp.asarray(arrays["q"]), jnp.asarray(arrays["species"]),
        fmask, nbr, Lv, tables)

    mesh = make_brick_mesh(SHAPE)
    grid = _pool_grid(L, rcut, skin, n, plan)
    coeffs = GroupTable.build(
        [Group(name="free", index=0, type="FREE")]).coefficients(0.0, 0.01)
    step_fn, first_fn, migrate_fn = make_brick_step_pallas(
        mesh, plan, grid, tables, coeffs, dt=0.02, box_lengths=[L] * 3,
        species_lj_type=np.array([0, 1], dtype=np.int32), n_global=n,
        coulomb=True, interpret=True)

    buf, mask, counts = distribute_bricks(arrays, [L] * 3, plan)
    fields, put = _shard(mesh, buf)
    maskd = put(mask)
    f, e, virial, ov = first_fn(fields, maskd, jax.random.PRNGKey(0))
    assert int(ov) == 0
    assert float(e) == pytest.approx(float(e_ref), rel=2e-5, abs=1e-2)
    assert np.asarray(virial) == pytest.approx(np.asarray(v_ref),
                                               rel=1e-3, abs=1.0)
    m = np.asarray(maskd)
    gid = np.asarray(fields["gid"])[m][:, 0].astype(np.int64)
    f_sh = np.asarray(f)[m]
    order = np.argsort(gid)
    scale = max(1.0, float(jnp.abs(f_ref).max()))
    assert np.abs(f_sh[order] - np.asarray(f_ref)).max() / scale < 2e-5


def test_pallas_shard_steps_and_migrates():
    """Chunked NVT dynamics through the pallas brick step: finite
    scalars, conservation through migration, and step-level agreement
    with the nlist brick engine over one chunk (identical kick RNG)."""
    from ddcmd_tpu.parallel.brickstep import make_brick_step

    arrays, L, rcut, skin, tables, plan, n = _setup()
    mesh = make_brick_mesh(SHAPE)
    grid = _pool_grid(L, rcut, skin, n, plan)
    coeffs = GroupTable.build(
        [Group(name="t", index=0, type="LANGEVIN", Teq=lambda t: 300.0,
               tau=1.0)]).coefficients(0.0, 0.01)
    tmap = np.array([0, 1], dtype=np.int32)
    # dt=0.01: at 0.02 the overlapping start relaxes through e_pot ~ 0
    # inside the chunk, where two float32 engines that round differently
    # (the kernel's TwoSum min-image) part by more than a 1-ulp input
    # perturbation moves either one
    kw = dict(dt=0.01, box_lengths=[L] * 3, species_lj_type=tmap,
              n_global=n, chunk_steps=5)
    out_p = make_brick_step_pallas(mesh, plan, grid, tables, coeffs,
                                   coulomb=True, interpret=True, **kw)
    out_n = make_brick_step(mesh, plan, grid, tables, coeffs, **kw)

    buf, mask, counts = distribute_bricks(arrays, [L] * 3, plan)
    res = {}
    for name, fns in (("pallas", out_p), ("nlist", out_n)):
        step_fn, first_fn, migrate_fn, chunk_fn = fns
        fields, put = _shard(mesh, buf)
        maskd = put(mask)
        key = jax.random.PRNGKey(7)
        f, e0, _, ov = first_fn(fields, maskd, key)
        assert int(ov) == 0
        fields, maskd, f, scal, ov = chunk_fn(fields, maskd, f, key)
        assert int(ov) == 0
        assert np.isfinite(np.asarray(scal)).all()
        assert int(np.asarray(maskd).sum()) == n
        res[name] = (float(e0), np.asarray(scal))
    # same RNG stream + near-identical forces: scalar rows track closely
    # over a short chunk (chaos grows later)
    e0p, sp = res["pallas"]
    e0n, sn = res["nlist"]
    assert e0p == pytest.approx(e0n, rel=2e-5, abs=1e-2)
    assert sp[:, 0] == pytest.approx(sn[:, 0], rel=2e-4, abs=1.0)
    assert sp[:, 1] == pytest.approx(sn[:, 1], rel=2e-3, abs=1.0)


@pytest.mark.slow
def test_pallas_shard_waterbox_deck(waterbox_dir):
    """The waterbox deck (NGLFCONSTRAINT + barostat) through
    ParallelSimulation's pallas shard engine: first energy
    matches the nlist engine, the NPT chunk runs and moves the box."""
    from ddcmd_tpu.run.cli import load_db
    from ddcmd_tpu.run.parallel_sim import ParallelSimulation

    def load():
        return load_db([str(waterbox_dir / "object.data")],
                       str(waterbox_dir / "snapshot.mem" / "restart"),
                       str(waterbox_dir))

    ps = ParallelSimulation(load(), str(waterbox_dir), shape=(2, 2, 2),
                            engine="pallas", interpret=True)
    assert ps.shard_engine == "pallas"
    e_p = ps.first_energy()

    ps2 = ParallelSimulation(load(), str(waterbox_dir), shape=(2, 2, 2),
                             engine="nlist")
    assert ps2.shard_engine == "nlist"
    e_n = ps2.first_energy()
    assert e_p == pytest.approx(e_n, rel=2e-5, abs=0.5)

    v0 = float(jnp.prod(ps.Lv))
    ps.run(ps.chunk_steps, print_fn=lambda s: None)
    m = np.asarray(ps.mask)
    assert int(m.sum()) == ps.sysdef.state.n_local
    assert np.isfinite(np.asarray(ps.f)[m]).all()
    v1 = float(jnp.prod(ps.Lv))
    assert np.isfinite(v1) and v1 != v0


def test_sharded_analysis_matches_gathered(waterbox_dir):
    """PAIRCORRELATION + ZDENSITY via per-device partial accumulation +
    psum (the dataExchange.c:21,107 analog) produce bin-for-bin the same
    histograms as the gathered-state evaluation on the 8-device mesh."""
    from ddcmd_tpu.analysis.registry import build_analysis
    from ddcmd_tpu.objects import ObjectDB
    from ddcmd_tpu.run.cli import load_db
    from ddcmd_tpu.run.parallel_sim import ParallelSimulation

    db = load_db([str(waterbox_dir / "object.data")],
                 str(waterbox_dir / "snapshot.mem" / "restart"),
                 str(waterbox_dir))
    ps = ParallelSimulation(db, str(waterbox_dir), shape=(2, 2, 2))
    ps.first_energy()
    view = ps.view()

    adb = ObjectDB().compile_string(
        "pc ANALYSIS { type=PAIRCORRELATION; delta_r=0.3 Angstrom; "
        "length=40; rmin=2.0 Angstrom; }\n"
        "zd ANALYSIS { type=ZDENSITY; nBins=32; }\n"
        "ke ANALYSIS { type=KINETICENERGYDISTN; nBins=24; "
        "max=12.0 kJ*mol^-1; }\n")
    for name in ("pc", "zd", "ke"):
        a_sh = build_analysis(name, adb.get(name, "ANALYSIS"))
        a_ga = build_analysis(name, adb.get(name, "ANALYSIS"))
        a_sh.eval_sharded(ps)
        a_ga.eval(view)
        hs = np.asarray(a_sh.state["hist"])
        hg = np.asarray(a_ga.state["hist"])
        assert hs.shape == hg.shape
        assert np.abs(hs - hg).max() <= 1e-6 * max(1.0, hg.max()), name

    # VCMWRITE: momentum reduction over owned rows
    vdb = ObjectDB().compile_string("vc ANALYSIS { type=VCMWRITE; }")
    v_sh = build_analysis("vc", vdb.get("vc", "ANALYSIS"))
    v_ga = build_analysis("vc", vdb.get("vc", "ANALYSIS"))
    v_sh.eval_sharded(ps)
    v_ga.eval(view)
    np.testing.assert_allclose(np.asarray(v_sh.state["rows"][0][1:]),
                               np.asarray(v_ga.state["rows"][0][1:]),
                               rtol=1e-5, atol=1e-9)

    # SSF: sharded partial rho_k sums match the gathered k-space sum
    sdb = ObjectDB().compile_string(
        "sf ANALYSIS { type=SSF; nShells=16; kmax=0.8 Angstrom^-1; }")
    s_sh = build_analysis("sf", sdb.get("sf", "ANALYSIS"))
    s_ga = build_analysis("sf", sdb.get("sf", "ANALYSIS"))
    s_sh.eval_sharded(ps)
    s_ga.eval(view)
    acc_g = np.asarray(s_ga.state["acc"])
    np.testing.assert_allclose(np.asarray(s_sh.state["acc"]), acc_g,
                               rtol=5e-4, atol=1e-6 * max(1.0, acc_g.max()))
    np.testing.assert_array_equal(s_sh.state["cnt"], s_ga.state["cnt"])

    # infeasible radius (rmax > halo rlist) must raise, not silently
    # truncate -- run_analyses falls back to the gathered path then
    bad = build_analysis("pc", ObjectDB().compile_string(
        "pc ANALYSIS { type=PAIRCORRELATION; delta_r=1.0 Angstrom; "
        "length=40; }").get("pc", "ANALYSIS"))
    with pytest.raises(ValueError):
        bad.eval_sharded(ps)


@pytest.mark.slow
def test_pallas_shard_inkernel_exclusions(tmp_path):
    """Bilayer deck over the brick mesh: the sharded pallas engine's
    in-kernel exclusion masking (channels ride a migrating field +
    halo exchange) matches the single-chip nlist gold path, and the
    rf_add bonded tables pair with it (r4 catapult fix, sharded side)."""
    import tempfile

    from ddcmd_tpu.models import load, martini_bilayer
    from ddcmd_tpu.run.parallel_sim import ParallelSimulation
    from ddcmd_tpu.run.simulate import Simulation

    d = str(tmp_path)
    martini_bilayer(d, nx=8, ny=8, water_nm=1.2)
    db, base = load(d)
    psim = ParallelSimulation(db, base, shape=(2, 2, 2), engine="pallas",
                              interpret=True)
    assert psim.shard_engine == "pallas"
    assert psim._excl_vals is not None
    e_par = psim.first_energy()
    db1, _ = load(d)
    s1 = Simulation(db1, base, run_dir=d, engine="nlist")
    s1.first_energy()
    e1 = float(s1.ss.energy.eion)
    assert e_par == pytest.approx(e1, rel=1e-5)
    psim.run(psim.chunk_steps, print_fn=lambda s: None)
    assert np.isfinite(np.asarray(psim.f)[np.asarray(psim.mask)]).all()


def test_pallas_shard_walls_forces_match_single_device():
    """Load-balanced (non-uniform tensor walls) bricks under the pallas
    shard engine: first forces/energy match the single-device
    reference."""
    arrays, L, rcut, skin, tables, _plan, n = _setup(L=8.0)
    rlist = rcut + skin
    # skewed but feasible walls on x and y (>= 2*rlist per brick on
    # 2-device axes); z stays uniform
    wx = np.array([0.0, 0.42, 1.0])
    wy = np.array([0.0, 0.58, 1.0])
    wz = np.array([0.0, 0.5, 1.0])
    assert min(np.diff(wx).min(), np.diff(wy).min()) * L >= 2 * rlist
    walls = (wx, wy, wz)
    plan = BrickPlan(shape=SHAPE, local_cap=8 * n // 8,
                     halo_cap=4 * n // 8, migrate_cap=256,
                     rlist=rlist, walls=walls)

    grid1 = CellGrid.plan([L] * 3, rcut, skin, n, n)
    rj = jnp.asarray(arrays["r"])
    fmask = jnp.ones(n, jnp.float32)
    Lv = jnp.asarray([L] * 3, jnp.float32)
    nbr, _, ov = build_neighbor_list(rj, fmask, Lv, grid1)
    assert not bool(ov)
    f_ref, e_ref, v_ref, pe_ref, _ = martini_nonbond(
        rj, jnp.asarray(arrays["q"]), jnp.asarray(arrays["species"]),
        fmask, nbr, Lv, tables)

    mesh = make_brick_mesh(SHAPE)
    grid = _pool_grid(L, rcut, skin, n, plan)
    coeffs = GroupTable.build(
        [Group(name="free", index=0, type="FREE")]).coefficients(0.0, 0.01)
    step_fn, first_fn, migrate_fn = make_brick_step_pallas(
        mesh, plan, grid, tables, coeffs, dt=0.02, box_lengths=[L] * 3,
        species_lj_type=np.array([0, 1], dtype=np.int32), n_global=n,
        coulomb=True, interpret=True)

    buf, mask, counts = distribute_bricks(arrays, [L] * 3, plan)
    # walls actually unbalance the split (the point of the test)
    per_dev = counts if np.ndim(counts) else None
    fields, put = _shard(mesh, buf)
    maskd = put(mask)
    f, e, virial, ov = first_fn(fields, maskd, jax.random.PRNGKey(0))
    assert int(ov) == 0
    assert float(e) == pytest.approx(float(e_ref), rel=2e-5, abs=1e-2)
    m = np.asarray(maskd)
    gid = np.asarray(fields["gid"])[m][:, 0].astype(np.int64)
    f_sh = np.asarray(f)[m]
    order = np.argsort(gid)
    scale = max(1.0, float(jnp.abs(f_ref).max()))
    assert np.abs(f_sh[order] - np.asarray(f_ref)).max() / scale < 2e-5

    # dynamics: one chunk runs, conserves particles, finite scalars
    kw = dict(dt=0.02, box_lengths=[L] * 3,
              species_lj_type=np.array([0, 1], np.int32),
              n_global=n, chunk_steps=4)
    step2, first2, migrate2, chunk2 = make_brick_step_pallas(
        mesh, plan, grid, tables, coeffs, coulomb=True, interpret=True,
        **kw)
    f0, e0, _, ov0 = first2(fields, maskd, jax.random.PRNGKey(1))
    assert int(ov0) == 0
    fields, maskd, f0, scal, ovc = chunk2(fields, maskd, f0,
                                          jax.random.PRNGKey(2))
    assert int(ovc) == 0
    assert np.isfinite(np.asarray(scal)).all()
    assert int(np.asarray(maskd).sum()) == n


def test_sharded_batched_bonded_matches_per_term(tmp_path, monkeypatch):
    """The sharded residue-template batched bonded path (resolve_batched
    + weighted batched_bonded_eval) == the per-term resolver on the real
    bilayer deck over the 8-device mesh."""
    from ddcmd_tpu.models import load, martini_bilayer
    from ddcmd_tpu.run.parallel_sim import ParallelSimulation

    d = str(tmp_path)
    martini_bilayer(d, nx=8, ny=8, water_nm=1.2)

    es = {}
    for mode in ("1", "0"):
        monkeypatch.setenv("DDCMD_BONDED_BATCH", mode)
        db, base = load(d)
        psim = ParallelSimulation(db, base, shape=(2, 2, 2),
                                  engine="pallas", interpret=True)
        assert psim.shard_engine == "pallas"
        if mode == "1":
            assert "__batched__" in psim._step_kwargs["bonded_tables"]
        es[mode] = psim.first_energy()
        psim.run(psim.chunk_steps, print_fn=lambda s: None)
        assert np.isfinite(np.asarray(psim.f)[np.asarray(psim.mask)]).all()
    assert es["1"] == pytest.approx(es["0"], rel=2e-6, abs=1e-2)


def test_sharded_batched_constraints_match_generic(tmp_path, monkeypatch):
    """Template-batched sharded RATTLE == the generic per-group
    projection over the 8-device mesh, and the chunk's post-drift
    constraint residual stays satisfied."""
    from ddcmd_tpu.integrators.constraints import constraint_residual
    from ddcmd_tpu.models import load, martini_bilayer
    from ddcmd_tpu.run.parallel_sim import ParallelSimulation

    d = str(tmp_path)
    martini_bilayer(d, nx=8, ny=8, water_nm=1.2)

    res = {}
    for mode in ("1", "0"):
        monkeypatch.setenv("DDCMD_CONS_BATCH", mode)
        db, base = load(d)
        psim = ParallelSimulation(db, base, shape=(2, 2, 2),
                                  engine="pallas", interpret=True)
        assert psim.shard_engine == "pallas"
        if mode == "1":
            assert "templates" in psim._step_kwargs["constraint_tables"]
        else:
            assert "templates" not in (
                psim._step_kwargs["constraint_tables"] or {})
        psim.first_energy()
        psim.run(psim.chunk_steps, print_fn=lambda s: None)
        # gather by gid for comparison + residual
        m = np.asarray(psim.mask)
        gp = np.asarray(psim.fields["gid"])[m]
        g64 = gp[:, 0].astype(np.int64) | (gp[:, 1].astype(np.int64) << 32)
        order = np.argsort(g64)
        res[mode] = (np.asarray(psim.fields["r"])[m][order],
                     np.asarray(psim.fields["v"])[m][order], psim)

    r1, v1, ps1 = res["1"]
    r0, v0, ps0 = res["0"]
    # identical RNG stream + identical projections: same trajectory to
    # f32 op-order noise over one chunk
    assert np.abs(r1 - r0).max() < 5e-4
    assert np.abs(v1 - v0).max() < 5e-3

    class _St:
        pass
    st = _St()
    sd = ps1.sysdef
    st.r = jnp.asarray(r1)
    # r1 rows are gid-sorted == collection order for this deck
    resid = constraint_residual(
        st, np.asarray(sd.bonded.cons_atoms),
        np.asarray(sd.bonded.cons_pairs), np.asarray(sd.bonded.cons_dist))
    assert resid < 5e-3, resid
