"""3D brick decomposition vs single-device: identical forces/energy."""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

import __graft_entry__ as ge
from ddcmd_tpu.core.groups import Group, GroupTable
from ddcmd_tpu.nbr.celllist import CellGrid, build_neighbor_list
from ddcmd_tpu.parallel.brick import BrickPlan, distribute_bricks
from ddcmd_tpu.parallel.brickstep import make_brick_mesh, make_brick_step
from ddcmd_tpu.potentials.martini import martini_nonbond

SHAPE = (2, 2, 2)


def setup():
    L = 6.4
    n = int(np.ceil(L / 0.5)) ** 3
    arrays, L, rcut, tables = ge._synthetic_system(n=n, L=L, rcut=0.6, sigma0=0.4)
    gid64 = arrays.pop("gid")
    arrays["gid"] = np.stack([(gid64 & 0xFFFFFFFF).astype(np.uint32),
                              (gid64 >> 32).astype(np.uint32)], axis=1)
    for k in ("r", "v", "q", "mass"):
        arrays[k] = arrays[k].astype(np.float32)
    skin = 0.15
    n_dev = int(np.prod(SHAPE))
    plan = BrickPlan(shape=SHAPE, local_cap=8 * n // n_dev,
                     halo_cap=4 * n // n_dev, migrate_cap=256,
                     rlist=rcut + skin)
    grid = CellGrid.plan([L] * 3, rcut, skin, n,
                         plan.local_cap + plan.ghost_cap)
    return arrays, L, rcut, skin, tables, plan, grid, n


def test_brick_forces_match_single_device():
    arrays, L, rcut, skin, tables, plan, grid, n = setup()

    # single-device reference
    grid1 = CellGrid.plan([L] * 3, rcut, skin, n, n)
    rj = jnp.asarray(arrays["r"])
    fmask = jnp.ones(n, jnp.float32)
    Lv = jnp.asarray([L] * 3, jnp.float32)
    nbr, _, ov = build_neighbor_list(rj, fmask, Lv, grid1)
    assert not bool(ov)
    f_ref, e_ref, v_ref, _, _ = martini_nonbond(
        rj, jnp.asarray(arrays["q"]), jnp.asarray(arrays["species"]),
        fmask, nbr, Lv, tables)

    mesh = make_brick_mesh(SHAPE)
    coeffs = GroupTable.build(
        [Group(name="free", index=0, type="FREE")]).coefficients(0.0, 0.01)
    step_fn, first_fn, migrate_fn = make_brick_step(
        mesh, plan, grid, tables, coeffs, dt=0.02, box_lengths=[L] * 3,
        species_lj_type=np.array([0, 1], dtype=np.int32), n_global=n)

    buf, mask, counts = distribute_bricks(arrays, [L] * 3, plan)
    shard = lambda a: jax.device_put(jnp.asarray(a),
                                     NamedSharding(mesh, P(("bx", "by", "bz"))))
    fields = {k: shard(v) for k, v in buf.items()}
    maskd = shard(mask)

    f, e, virial, ov = first_fn(fields, maskd, jax.random.PRNGKey(0))
    assert int(ov) == 0
    assert float(e) == pytest.approx(float(e_ref), rel=1e-5, abs=1e-2)
    assert np.asarray(virial) == pytest.approx(np.asarray(v_ref), rel=1e-3, abs=1.0)

    # per-particle force match via gid ordering
    m = np.asarray(maskd)
    gid = np.asarray(fields["gid"])[m][:, 0].astype(np.int64)
    f_sh = np.asarray(f)[m]
    order = np.argsort(gid)
    scale = max(1.0, float(jnp.abs(f_ref).max()))
    assert np.abs(f_sh[order] - np.asarray(f_ref)).max() / scale < 1e-5


def test_brick_steps_and_migrates():
    arrays, L, rcut, skin, tables, plan, grid, n = setup()
    mesh = make_brick_mesh(SHAPE)
    coeffs = GroupTable.build(
        [Group(name="t", index=0, type="LANGEVIN", Teq=lambda t: 300.0,
               tau=1.0)]).coefficients(0.0, 0.01)
    step_fn, first_fn, migrate_fn = make_brick_step(
        mesh, plan, grid, tables, coeffs, dt=0.02, box_lengths=[L] * 3,
        species_lj_type=np.array([0, 1], dtype=np.int32), n_global=n)
    buf, mask, counts = distribute_bricks(arrays, [L] * 3, plan)
    shard = lambda a: jax.device_put(jnp.asarray(a),
                                     NamedSharding(mesh, P(("bx", "by", "bz"))))
    fields = {k: shard(v) for k, v in buf.items()}
    maskd = shard(mask)
    key = jax.random.PRNGKey(1)
    f, e0, _, ov = first_fn(fields, maskd, key)
    assert int(ov) == 0
    for i in range(5):
        fields, f, scalars, ov = step_fn(fields, maskd, f, jax.random.fold_in(key, i))
        assert int(ov) == 0
        assert np.isfinite(float(scalars[0]))
    fields, maskd, f, ov = migrate_fn(fields, maskd, f)
    assert int(ov) == 0
    assert int(np.asarray(maskd).sum()) == n  # conservation through migration


def test_parallel_waterbox_deck(waterbox_dir):
    """The real waterbox deck sharded over a 2x2x2 CPU mesh: energies match
    the single-device first call, NVT steps + migration stay finite."""
    from ddcmd_tpu.run.cli import load_db
    from ddcmd_tpu.run.parallel_sim import ParallelSimulation
    from ddcmd_tpu.run.simulate import Simulation

    db = load_db([str(waterbox_dir / "object.data")],
                 str(waterbox_dir / "snapshot.mem" / "restart"),
                 str(waterbox_dir))
    psim = ParallelSimulation(db, str(waterbox_dir), shape=(2, 2, 2))
    e_par = psim.first_energy()

    db2 = load_db([str(waterbox_dir / "object.data")],
                  str(waterbox_dir / "snapshot.mem" / "restart"),
                  str(waterbox_dir))
    sim = Simulation(db2, str(waterbox_dir), run_dir=str(waterbox_dir),
                     engine="nlist")
    sim.first_energy()
    e_single = float(sim.ss.energy.eion)
    # sharded nonbond lacks the RF self-energy term (constant): add it
    from ddcmd_tpu.objects import units as U

    mp = next(p[2] for p in sim.sysdef.potentials if p[0] == "MARTINI")
    q = np.asarray(sim.sysdef.state.q[: sim.sysdef.state.n_local])
    e_self = -0.5 * float((q ** 2).sum()) * U.ke / mp.epsilon_r * mp.crf
    assert e_par + e_self == pytest.approx(e_single, rel=1e-4, abs=0.5)

    # the waterbox deck is NGLFCONSTRAINT with beta>0: the sharded run
    # exercises the NPT chunk (carried box lengths + virial diagonal)
    assert psim.barostat is not None
    v0 = float(jnp.prod(psim.Lv))
    loop0 = psim.loop
    # +3 loops: NPT advances through a compiled remainder chunk (r4:
    # partial-chunk advance replaced the whole-chunk NotImplementedError)
    psim.run(2 * psim.chunk_steps + 3, print_fn=lambda s: None)
    assert psim.loop == loop0 + 2 * psim.chunk_steps + 3
    m2 = np.asarray(psim.mask)
    assert int(m2.sum()) == sim.sysdef.state.n_local
    assert np.isfinite(np.asarray(psim.f)[m2]).all()
    v1 = float(jnp.prod(psim.Lv))
    assert np.isfinite(v1) and v1 != v0        # barostat moved the box
    # the lattice start sits far from 1 bar, so the box moves by several
    # percent over these steps; the single-device driver's move over the
    # same steps sets the scale the sharded one must match
    vs0 = float(jnp.prod(sim.ss.box.lengths))
    sim.run(2 * psim.chunk_steps + 3, print_fn=lambda s: None)
    dv_single = (float(jnp.prod(sim.ss.box.lengths)) - vs0) / vs0
    assert abs(dv_single) > 0.005
    assert (v1 - v0) / v0 == pytest.approx(dv_single, rel=0.05)

    # custom migration cadence under NPT: migrate_rate becomes the chunk
    # length (r4; was NotImplementedError)
    half = max(1, psim.chunk_steps // 2)
    psim.run(2 * half, migrate_rate=half, print_fn=lambda s: None)
    assert psim.loop == loop0 + 2 * psim.chunk_steps + 3 + 2 * half
    assert np.isfinite(np.asarray(psim.f)[np.asarray(psim.mask)]).all()

    # sharded checkpoint: gathered snapshot restartable by Simulation
    import tempfile

    ckdir = tempfile.mkdtemp()
    snap = psim.write_checkpoint(ckdir)
    db3 = load_db([str(waterbox_dir / "object.data")],
                  os.path.join(ckdir, "restart"), str(waterbox_dir))
    # collection shards live under the checkpoint dir (restart files are
    # relative to the run dir, objectSetup.c:40-44)
    sim3 = Simulation(db3, ckdir, run_dir=ckdir, engine="nlist")
    assert int(sim3.ss.loop) == psim.loop
    sim3.first_energy()
    assert np.isfinite(float(sim3.ss.energy.eion))


def test_sharded_constraints_diatomics():
    """Constrained diatomics over the brick mesh: every constraint group
    is owned exactly once across devices, bond lengths satisfy r0 through
    steps + migration, and the projection matches molecule coherence."""
    from ddcmd_tpu.parallel.bonded_shard import (bonded_gid_tables,
                                                 constraint_gid_tables)
    from ddcmd_tpu.parallel.brickstep import FIELD_KEYS
    from ddcmd_tpu.potentials.bonded import BondedTerms, device_bonded_tables

    arrays, L, rcut, skin, tables, plan, grid, n = setup()
    n_mol = n // 2
    # diatomics = ADJACENT lattice atoms constrained at their INITIAL
    # separations (no repositioning -> no hard-core clashes, original
    # capacity plans stay valid); per-group r0 varies
    r = np.asarray(arrays["r"], np.float64)
    d = r[0:2 * n_mol:2] - r[1:2 * n_mol:2]
    d = d - L * np.round(d / L)
    r0s = np.linalg.norm(d, axis=1)
    arrays["v"] = (np.asarray(arrays["v"]) * 0.05).astype(np.float32)

    mol_of = np.minimum(np.arange(n) // 2, n_mol - 1)
    atom_of = np.arange(n) - 2 * mol_of
    g64 = (mol_of.astype(np.int64) * 4) | atom_of.astype(np.int64)
    h64 = mol_of.astype(np.int64) * 4
    arrays["gid"] = np.stack([(g64 & 0xFFFFFFFF).astype(np.uint32),
                              (g64 >> 32).astype(np.uint32)], axis=1)
    arrays["hgid"] = np.stack([(h64 & 0xFFFFFFFF).astype(np.uint32),
                               (h64 >> 32).astype(np.uint32)], axis=1)

    cons_atoms = np.stack([2 * np.arange(n_mol), 2 * np.arange(n_mol) + 1],
                          axis=1).astype(np.int32)
    bt = BondedTerms(
        bonds=cons_atoms.copy(),
        bond_parms=np.stack([np.zeros(n_mol), r0s], axis=1),  # zero-k
        cons_atoms=cons_atoms,
        cons_pairs=np.tile(np.array([[[0, 1]]], np.int32), (n_mol, 1, 1)),
        cons_dist=r0s[:, None],
        n_constraints=n_mol)
    btab = bonded_gid_tables(bt, g64, device_bonded_tables(bt, jnp.float32))
    ctab = constraint_gid_tables(bt, g64)
    assert ctab is not None



    mesh = make_brick_mesh(SHAPE)
    coeffs = GroupTable.build(
        [Group(name="free", index=0, type="FREE")]).coefficients(0.0, 0.01)
    step_fn, first_fn, migrate_fn, chunk_fn = make_brick_step(
        mesh, plan, grid, tables, coeffs, dt=0.02, box_lengths=[L] * 3,
        species_lj_type=np.array([0, 1], dtype=np.int32), n_global=n,
        bonded_tables=btab, field_keys=FIELD_KEYS + ("hgid",),
        chunk_steps=5, constraint_tables=ctab)

    buf, mask, counts = distribute_bricks(arrays, [L] * 3, plan)
    shard = lambda a: jax.device_put(jnp.asarray(a),
                                     NamedSharding(mesh, P(("bx", "by", "bz"))))
    fields = {k: shard(v) for k, v in buf.items()}
    maskd = shard(mask)
    key = jax.random.PRNGKey(0)
    f, e0, _, ov = first_fn(fields, maskd, key)
    assert int(ov) == 0

    # exactly-once ownership across the mesh
    from ddcmd_tpu.parallel.bonded_shard import pack_gid, resolve_constraints

    def count_owned(fields, mask):
        g = pack_gid(fields["gid"])
        _, gw = resolve_constraints(jnp.asarray(ctab["cons_gids"]), g, mask,
                                    mask.shape[0])
        return jax.lax.psum(gw, ("bx", "by", "bz"))

    owned = jax.jit(jax.shard_map(
        count_owned, mesh=mesh,
        in_specs=({k: P(("bx", "by", "bz")) for k in fields}, P(("bx", "by", "bz"))),
        out_specs=P(), check_vma=False))(fields, maskd)
    np.testing.assert_array_equal(np.asarray(owned), np.ones(n_mol))

    # two chunks (5 steps + migration each): constraints hold throughout
    for _ in range(2):
        fields, maskd, f, scal, ov = chunk_fn(fields, maskd, f, key)
        assert int(ov) == 0
        assert np.isfinite(float(scal[-1, 0]))

    m = np.asarray(maskd)
    gids = np.asarray(fields["gid"])[m]
    g64o = gids[:, 0].astype(np.int64) | (gids[:, 1].astype(np.int64) << 32)
    rr = np.asarray(fields["r"])[m]
    row_of = {int(g): i for i, g in enumerate(g64o)}
    worst = 0.0
    for mol in range(n_mol):
        i, j = row_of[mol * 4], row_of[mol * 4 + 1]
        d = rr[i] - rr[j]
        d = d - L * np.round(d / L)
        worst = max(worst, abs(np.linalg.norm(d) - r0s[mol]) / r0s[mol])
    assert worst < 5e-3


def test_brick_tensor_walls_balance():
    """Non-uniform per-axis walls (tensor-product ORCB) balance a skewed
    density and keep forces identical to the single-device reference."""
    from ddcmd_tpu.parallel.loadbalance import clamp_walls, tensor_walls

    L = 6.4
    rcut, skin = 0.6, 0.15
    rng = np.random.default_rng(12)
    n = 1800
    # density gradient: x^2-skewed toward +x
    x = (rng.random(n) ** 0.5 - 0.5) * L
    yz = (rng.random((n, 2)) - 0.5) * L
    r = np.concatenate([x[:, None], yz], axis=1).astype(np.float32)
    arrays = dict(
        r=r, v=np.zeros((n, 3), np.float32),
        q=np.zeros(n, np.float32), mass=np.full(n, 72.0, np.float32),
        species=rng.integers(0, 2, n).astype(np.int32),
        group=np.zeros(n, np.int32),
        gid=np.stack([np.arange(n, dtype=np.uint32),
                      np.zeros(n, np.uint32)], axis=1))
    import __graft_entry__ as ge2

    _, _, _, tables = ge2._synthetic_system(n=8, L=L, rcut=rcut, sigma0=0.4)

    raw = tensor_walls(r, [L] * 3, SHAPE, work_power=1)
    walls = tuple(tuple(clamp_walls(w, 1.05 * (rcut + skin) / L))
                  for w in raw)
    n_dev = int(np.prod(SHAPE))
    plan = BrickPlan(shape=SHAPE, local_cap=8 * ((n // n_dev * 4) // 8),
                     halo_cap=8 * ((n // n_dev * 6) // 8), migrate_cap=512,
                     rlist=rcut + skin, walls=walls)
    # skewed density: plan cells for the DENSE region (2x the mean)
    grid = CellGrid.plan([L] * 3, rcut, skin, n,
                         plan.local_cap + plan.ghost_cap,
                         density_safety=4.0, max_neighbors=256)
    buf, mask, counts = distribute_bricks(arrays, [L] * 3, plan)
    # balanced: uniform walls would put ~2x the mean in the +x bricks
    assert counts.max() / max(1, counts.min()) < 1.7

    mesh = make_brick_mesh(SHAPE)
    coeffs = GroupTable.build(
        [Group(name="free", index=0, type="FREE")]).coefficients(0.0, 0.01)
    step_fn, first_fn, migrate_fn = make_brick_step(
        mesh, plan, grid, tables, coeffs, dt=0.002, box_lengths=[L] * 3,
        species_lj_type=np.array([0, 1], dtype=np.int32), n_global=n)
    shard = lambda a: jax.device_put(jnp.asarray(a),
                                     NamedSharding(mesh, P(("bx", "by", "bz"))))
    fields = {k: shard(v) for k, v in buf.items()}
    maskd = shard(mask)
    key = jax.random.PRNGKey(0)
    f, e, virial, ov = first_fn(fields, maskd, key)
    assert int(ov) == 0

    # single-device reference forces (same dense-region headroom)
    grid1 = CellGrid.plan([L] * 3, rcut, skin, n, n,
                          density_safety=4.0, max_neighbors=256)
    rj = jnp.asarray(r)
    fmask = jnp.ones(n, jnp.float32)
    Lv = jnp.asarray([L] * 3, jnp.float32)
    nbr, _, ov1 = build_neighbor_list(rj, fmask, Lv, grid1)
    assert not bool(ov1)
    f_ref, e_ref, *_ = martini_nonbond(
        rj, jnp.zeros(n), jnp.asarray(arrays["species"]), fmask, nbr, Lv,
        tables)
    assert float(e) == pytest.approx(float(e_ref), rel=1e-5, abs=1e-2)
    m = np.asarray(maskd)
    gid = np.asarray(fields["gid"])[m][:, 0].astype(np.int64)
    f_sh = np.asarray(f)[m]
    order = np.argsort(gid)
    scale = max(1.0, float(jnp.abs(f_ref).max()))
    assert np.abs(f_sh[order] - np.asarray(f_ref)).max() / scale < 1e-5

    # dynamics + migration stay consistent with the walls
    for i in range(3):
        fields, f, scal, ov = step_fn(fields, maskd, f,
                                      jax.random.fold_in(key, i))
        assert int(ov) == 0
    fields, maskd, f, ov = migrate_fn(fields, maskd, f)
    assert int(ov) == 0
    assert int(np.asarray(maskd).sum()) == n


def test_brick_eam_matches_single_device():
    """Sharded two-pass EAM (second halo for embedding derivatives) ==
    the single-device nlist engine; steps + migration stay consistent."""
    from ddcmd_tpu.models import eam_crystal, load
    from ddcmd_tpu.run.parallel_sim import ParallelSimulation
    from ddcmd_tpu.run.simulate import Simulation
    import tempfile

    d = tempfile.mkdtemp()
    eam_crystal(d, nc=6)            # 864 atoms
    db, base = load(d)
    psim = ParallelSimulation(db, base, shape=(2, 2, 2))
    assert psim.force_kind == "eam"
    e_par = psim.first_energy()

    db2, _ = load(d)
    sim = Simulation(db2, base, run_dir=d, engine="nlist")
    sim.first_energy()
    e_single = float(sim.ss.energy.eion)
    assert e_par == pytest.approx(e_single, rel=1e-5)

    # per-atom forces match via gid ordering
    m = np.asarray(psim.mask)
    gid = np.asarray(psim.fields["gid"])[m][:, 0].astype(np.int64)
    f_sh = np.asarray(psim.f)[m]
    f_ref = np.asarray(sim.ss.state.f[: sim.sysdef.state.n_local])
    order = np.argsort(gid)
    scale = max(1.0, float(np.abs(f_ref).max()))
    assert np.abs(f_sh[order] - f_ref).max() / scale < 1e-4

    psim.run(2 * psim.chunk_steps, print_fn=lambda s: None)
    m2 = np.asarray(psim.mask)
    assert int(m2.sum()) == sim.sysdef.state.n_local
    assert np.isfinite(np.asarray(psim.f)[m2]).all()


def test_brick_pair_deck():
    """PAIR (LJ) decks shard through the same nonbond path with Coulomb
    zeroed; energy matches the single-device run."""
    from ddcmd_tpu.models import lj_fluid, load
    from ddcmd_tpu.run.parallel_sim import ParallelSimulation
    from ddcmd_tpu.run.simulate import Simulation
    import tempfile

    d = tempfile.mkdtemp()
    lj_fluid(d, n=1500)
    db, base = load(d)
    psim = ParallelSimulation(db, base, shape=(2, 2, 2))
    e_par = psim.first_energy()

    db2, _ = load(d)
    sim = Simulation(db2, base, run_dir=d, engine="nlist")
    sim.first_energy()
    assert e_par == pytest.approx(float(sim.ss.energy.eion), rel=1e-5)
    psim.run(psim.chunk_steps, print_fn=lambda s: None)
    assert np.isfinite(np.asarray(psim.f)[np.asarray(psim.mask)]).all()


def test_brick_pair_table_deck():
    """Tabulated PAIR (function=TableFunction) shards via the pairtab
    brickstep path; energy matches the single-device nlist run."""
    from ddcmd_tpu.models import lj_fluid, load
    from ddcmd_tpu.run.parallel_sim import ParallelSimulation
    from ddcmd_tpu.run.simulate import Simulation
    import tempfile

    d = tempfile.mkdtemp()
    lj_fluid(d, n=1500, table=True)
    db, base = load(d)
    psim = ParallelSimulation(db, base, shape=(2, 2, 2))
    assert psim.force_kind == "pairtab"
    e_par = psim.first_energy()

    db2, _ = load(d)
    sim = Simulation(db2, base, run_dir=d, engine="nlist")
    sim.first_energy()
    assert e_par == pytest.approx(float(sim.ss.energy.eion), rel=1e-5)
    psim.run(psim.chunk_steps, print_fn=lambda s: None)
    assert np.isfinite(np.asarray(psim.f)[np.asarray(psim.mask)]).all()


def test_parallel_analyses_on_gathered_state(tmp_path):
    """Deck analyses evaluate on the gathered multi-chip state and
    match the single-device result (pair correlation on an LJ fluid)."""
    from ddcmd_tpu.models import lj_fluid, load
    from ddcmd_tpu.run.parallel_sim import ParallelSimulation
    from ddcmd_tpu.run.simulate import Simulation
    from ddcmd_tpu.analysis.registry import build_analysis
    from ddcmd_tpu.objects.parser import DeckObject

    lj_fluid(str(tmp_path), n=1000)
    db, base = load(str(tmp_path))
    db.compile_string(
        "gr ANALYSIS { type=PAIRCORRELATION; eval_rate=1; outputrate=1; "
        "rmax=8 Angstrom; nBins=40; }")
    psim = ParallelSimulation(db, base, shape=(2, 2, 1))
    psim.first_energy()
    names = psim.run_analyses(str(tmp_path))
    assert "gr" in names

    db2, _ = load(str(tmp_path))
    sim = Simulation(db2, base, run_dir=str(tmp_path), engine="nlist")
    sim.first_energy()
    a = build_analysis("gr", DeckObject(
        "gr", "ANALYSIS",
        {"type": ["PAIRCORRELATION"], "eval_rate": ["1"],
         "outputrate": ["1"], "rmax": ["8", "Angstrom"], "nBins": ["40"]}))
    a.eval(sim)
    h_single = np.asarray(a.state["hist"], dtype=np.float64)

    av = build_analysis("gr", DeckObject(
        "gr", "ANALYSIS",
        {"type": ["PAIRCORRELATION"], "eval_rate": ["1"],
         "outputrate": ["1"], "rmax": ["8", "Angstrom"], "nBins": ["40"]}))
    av.eval(psim.view())
    h_par = np.asarray(av.state["hist"], dtype=np.float64)
    np.testing.assert_allclose(h_par, h_single, rtol=1e-6)


@pytest.mark.slow
def test_sharded_molecular_pressure_bilayer(tmp_path):
    """Multi-bead NPT over the mesh: (a) the sharded barostat virial diag
    equals the single-chip MOLECULAR virial (molecularPressure.c:22-67
    rank-parallel analog); (b) a deterministic (FREE-group) sharded NPT
    run tracks the single-chip box-volume trajectory over 100+ steps."""
    import jax.numpy as jnp
    from ddcmd_tpu.core.molecule import (build_molecule_class,
                                         make_molecular_virial_fn)
    from ddcmd_tpu.core.system import build_system, plan_grid
    from ddcmd_tpu.models import load, martini_bilayer
    from ddcmd_tpu.nbr.celllist import build_neighbor_list
    from ddcmd_tpu.run.forces import build_force_fn
    from ddcmd_tpu.run.parallel_sim import ParallelSimulation
    from ddcmd_tpu.run.simulate import Simulation

    d = str(tmp_path)
    martini_bilayer(d, nx=4, ny=4, water_nm=1.2)
    # deterministic dynamics (NVE + barostat, no Langevin noise) so the
    # sharded trajectory is bitwise-comparable to single-chip modulo
    # reduction order
    deck = (tmp_path / "object.data").read_text()
    assert "type=LANGEVIN" in deck
    deck = deck.replace("free GROUP { type=LANGEVIN; Teq=323.0K; tau=1.0ps; }",
                        "free GROUP { type=FREE; }")
    (tmp_path / "object.data").write_text(deck)

    # --- (a) t=0 molecular virial diag parity --------------------------
    db, base = load(d)
    psim = ParallelSimulation(db, base, shape=(2, 2, 1))
    psim.first_energy()
    vird_par = np.asarray(psim.vird, dtype=np.float64)

    db2, _ = load(d)
    sd = build_system(db2, base, dtype=jnp.float32)
    grid = plan_grid(sd)
    force_fn = build_force_fn(sd, dtype=jnp.float32, engine="nlist")
    nbr, _, ov = build_neighbor_list(sd.state.r, sd.state.fmask,
                                     sd.box.lengths, grid)
    assert not bool(ov)
    f, e, virial, _ = force_fn(sd.state, sd.box, nbr)
    sysobj = db2.get(sd.cfg.system_name, "SYSTEM")
    mols = build_molecule_class(db2, sysobj, sd.collection.species_names,
                                sd.collection.gid)
    mol_fn = make_molecular_virial_fn(mols, dtype=jnp.float32)
    assert mol_fn is not None                  # lipids are multi-bead
    mvir = np.asarray(mol_fn(sd.state.replace(f=f), sd.box, virial),
                      dtype=np.float64)
    avir = np.asarray(virial, dtype=np.float64)
    # the molecular correction is large for 12-bead lipids: the test is
    # vacuous unless it moves the diag
    assert np.abs(np.diag(mvir) - np.diag(avir)).max() > \
        1e-3 * np.abs(np.diag(avir)).max()
    np.testing.assert_allclose(vird_par, np.diag(mvir), rtol=2e-3,
                               atol=2e-2 * np.abs(np.diag(mvir)).max())

    # --- (b) 100+ step NPT box-trajectory parity -----------------------
    # the unequilibrated bilayer compresses laterally ~6%: a (2,2,1)
    # split turns infeasible mid-run (brick 2.97/2 drops below
    # rlist=1.4 -- the brick_ok guard correctly refuses), so the
    # trajectory leg splits the 9 nm z axis instead
    db4, _ = load(d)
    psim = ParallelSimulation(db4, base, shape=(1, 1, 2))
    psim.first_energy()
    sim = Simulation(db2, base, run_dir=d, engine="nlist")
    n_steps = 9 * psim.chunk_steps             # 108 steps
    psim.run(n_steps, print_fn=lambda s: None)
    sim.run(n_steps, print_fn=lambda s: None)
    v_par = float(jnp.prod(psim.Lv))
    v_single = float(sim.ss.box.volume)
    assert np.isfinite(v_par) and v_par > 0
    # both barostats compress/expand together; f32 reduction-order noise
    # compounds through the trajectory, so compare the volume CHANGE
    dv_par = v_par / float(np.prod(np.asarray(psim._box_L))) - 1.0
    dv_single = v_single / float(sd.box.volume) - 1.0
    assert dv_single != 0.0
    assert dv_par == pytest.approx(dv_single, rel=0.15, abs=2e-4)

    # --- (c) live replan (overflow-ladder step 2) continues the run ----
    n_before = int(np.asarray(psim.mask).sum())
    psim.replan()
    assert int(np.asarray(psim.mask).sum()) == n_before
    psim.run(psim.chunk_steps, print_fn=lambda s: None)
    assert np.isfinite(np.asarray(psim.f)[np.asarray(psim.mask)]).all()


def test_brick_charmm_deck(tmp_path):
    """A real CHARMM c36 DECK (solvated tripeptide: bonds/angles/UB/
    dihedrals/impropers/CMAP + LJ/RF nonbond) through ParallelSimulation
    on a 2x2x1 mesh: e_pot and per-atom forces match the single-chip
    nlist engine, and sharded steps stay finite with all atoms owned.
    Match: bioCharmm.c:708 running under full DDC halo/migration."""
    from test_charmm_c36 import make_solvated_fixture

    from ddcmd_tpu.run.cli import load_db
    from ddcmd_tpu.run.parallel_sim import ParallelSimulation
    from ddcmd_tpu.run.simulate import Simulation

    # 32 A box so each 2-way brick axis (16 A) clears rlist (11 A).
    # Parity runs at f64: the all-atom exclusion-correction design
    # cancels ~1e6-scale pair energies, so f32 totals carry O(1)
    # engine-vs-correction op-order noise that is not a sharding defect.
    n, n_w = make_solvated_fixture(tmp_path, L=32.0, nve=True, dt_fs=0.25)
    db = load_db([str(tmp_path / "object.data")], None, str(tmp_path))
    psim = ParallelSimulation(db, str(tmp_path), shape=(2, 2, 1),
                              dtype=jnp.float64)
    e_par = psim.first_energy()

    db2 = load_db([str(tmp_path / "object.data")], None, str(tmp_path))
    sim = Simulation(db2, str(tmp_path), run_dir=str(tmp_path),
                     engine="nlist", dtype=jnp.float64)
    sim.first_energy()
    e_single = float(sim.ss.energy.eion)
    assert e_par == pytest.approx(e_single, rel=1e-8)

    # per-atom force parity via gid ordering
    m = np.asarray(psim.mask)
    assert int(m.sum()) == n
    gid = np.asarray(psim.fields["gid"])[m][:, 0].astype(np.int64)
    f_sh = np.asarray(psim.f)[m]
    f_ref = np.asarray(sim.ss.state.f[: sim.sysdef.state.n_local])
    order = np.argsort(gid)
    scale = max(1.0, float(np.abs(f_ref).max()))
    assert np.abs(f_sh[order] - f_ref).max() / scale < 1e-9

    psim.run(2 * psim.chunk_steps, print_fn=lambda s: None)
    m2 = np.asarray(psim.mask)
    assert int(m2.sum()) == n
    assert np.isfinite(np.asarray(psim.f)[m2]).all()
