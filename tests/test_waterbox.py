"""End-to-end waterbox tests: the reference's de-facto fixture
(/root/reference/examples/waterbox) driven through the full stack."""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from ddcmd_tpu.objects import ObjectDB
from ddcmd_tpu.objects import units as U
from ddcmd_tpu.run.cli import load_db
from ddcmd_tpu.run.simulate import Simulation
from ddcmd_tpu.transforms.thermalize import thermalize_velocities


def waterbox_db(waterbox_dir):
    return load_db([str(waterbox_dir / "object.data")],
                   str(waterbox_dir / "snapshot.mem" / "restart"),
                   str(waterbox_dir))


@pytest.fixture(scope="module")
def wb_db(waterbox_dir):
    return waterbox_db(waterbox_dir)


def test_waterbox_nvt_npt_runs(wb_db, waterbox_dir, tmp_path):
    sim = Simulation(wb_db, str(waterbox_dir), run_dir=str(tmp_path))
    lines = []
    sim.run(12, print_fn=lines.append)
    assert int(sim.ss.loop) == 12
    e = sim.ss.energy
    assert np.isfinite(float(e.eion)) and np.isfinite(float(e.rk))
    # Langevin from v=0: temperature must rise toward 310K
    T = float(e.temperature(sim.sysdef.state.n_local))
    assert 10.0 < T < 400.0
    # Epot/bead in the physical ballpark for Martini water (kJ/mol)
    epot_per_bead = float(e.eion) / sim.sysdef.state.n_local
    assert -40.0 < epot_per_bead < -15.0
    assert len(lines) == 12


def test_waterbox_nve_energy_conservation(waterbox_dir):
    """NVE drift check in f64 (BASELINE.json's matching-energy-drift metric).

    Swap Langevin groups for FREE, disable the barostat, thermalize to
    310K, run 100 x 20fs steps: total energy must be conserved."""
    db = waterbox_db(waterbox_dir)
    for gname in ("group", "free"):
        db.get(gname, "GROUP").keywords["type"] = ["FREE"]
    nglf = db.get("nglf", "INTEGRATOR")
    nglf.keywords["type"] = ["NGLF"]
    nglf.keywords["beta"] = ["0.0"]

    sim = Simulation(db, str(waterbox_dir), dtype=jnp.float64)
    sd = sim.sysdef
    n = sd.state.n_local
    mass = np.asarray(sd.state.mass[:n], dtype=np.float64)
    v = thermalize_velocities(mass, 310.0, seed=42)
    v_pad = np.zeros((sd.state.n_pad, 3))
    v_pad[:n] = v
    sim.ss = sim.ss.replace(state=sim.ss.state.replace(
        v=jnp.asarray(v_pad, dtype=jnp.float64)))

    sim.first_energy()
    e0 = float(sim.ss.energy.eion) + float(sim.ss.energy.rk)
    sim.run(100, print_fn=lambda s: None)
    e1 = float(sim.ss.energy.eion) + float(sim.ss.energy.rk)
    drift = abs(e1 - e0) / n  # kJ/mol per bead over 2 ps
    assert drift < 5e-3, f"NVE energy drift too large: {drift} kJ/mol/bead"


def test_waterbox_checkpoint_roundtrip(wb_db, waterbox_dir, tmp_path):
    from ddcmd_tpu.io.restart import write_checkpoint

    sim = Simulation(wb_db, str(waterbox_dir), run_dir=str(tmp_path))
    sim.run(5, print_fn=lambda s: None)
    snapdir = write_checkpoint(sim, str(tmp_path))
    assert os.path.islink(tmp_path / "restart")

    db2 = load_db([str(waterbox_dir / "object.data")],
                  str(tmp_path / "restart"), str(waterbox_dir))
    # collection files path is relative to run dir now
    sim2 = Simulation(db2, str(tmp_path), run_dir=str(tmp_path))
    assert int(sim2.ss.loop) == 5
    n = sim.sysdef.state.n_local
    r1 = np.asarray(sim.ss.state.r[:n])
    r2 = np.asarray(sim2.ss.state.r[:n])
    # written in %21.13e Ang: expect agreement to ~1e-6 nm
    assert np.abs(r1 - r2).max() < 1e-5
    v1 = np.asarray(sim.ss.state.v[:n])
    v2 = np.asarray(sim2.ss.state.v[:n])
    assert np.abs(v1 - v2).max() < 1e-5


def test_multishard_checkpoint(waterbox_dir, tmp_path):
    """nfiles=3 in the deck -> three atoms# shards, restart-readable
    (Pio_setNumWriteFiles analog)."""
    from ddcmd_tpu.io.collection import read_collection
    from ddcmd_tpu.io.restart import write_checkpoint
    from ddcmd_tpu.run.cli import load_db
    from ddcmd_tpu.run.simulate import Simulation

    db = load_db([str(waterbox_dir / "object.data")],
                 str(waterbox_dir / "snapshot.mem" / "restart"),
                 str(waterbox_dir))
    db.compile_string("simulate SIMULATE { nfiles=3; }")
    sim = Simulation(db, str(waterbox_dir), run_dir=str(tmp_path),
                     engine="nlist")
    sim.first_energy()
    snapdir = write_checkpoint(sim, str(tmp_path))
    import os

    shards = sorted(x for x in os.listdir(snapdir) if x.startswith("atoms#"))
    assert shards == ["atoms#000000", "atoms#000001", "atoms#000002"]
    col = read_collection(os.path.join(os.path.basename(snapdir), "atoms#"),
                          str(tmp_path))
    n = sim.sysdef.state.n_local
    assert col.n == n
    r = np.asarray(sim.ss.state.r[:n])
    order_a = np.argsort(col.gid)
    order_b = np.argsort(sim.sysdef.collection.gid)
    assert np.abs(col.r[order_a] - r[order_b]).max() < 1e-5


def test_restart_rng_continuity(waterbox_dir, tmp_path):
    """Checkpoint + restart reproduces the uninterrupted trajectory
    bitwise (incl. thermostat noise): the PRNG key is restart-persisted,
    the analog of the reference's per-particle RNG serialization."""
    from ddcmd_tpu.io.restart import write_checkpoint
    from ddcmd_tpu.run.cli import load_db
    from ddcmd_tpu.run.simulate import Simulation

    def fresh():
        db = load_db([str(waterbox_dir / "object.data")],
                     str(waterbox_dir / "snapshot.mem" / "restart"),
                     str(waterbox_dir))
        # the deck randomizes its seed per load; pin it so the two
        # chains share the same noise stream
        db.compile_string("lcg64 RANDOM { seed=12345; randomizeSeed=0; }")
        return db

    # reference: two 10-step dispatches, no restart in between
    simA = Simulation(fresh(), str(waterbox_dir), run_dir=str(tmp_path),
                      engine="nlist")
    simA.run(10, print_fn=lambda s: None, max_steps_per_dispatch=10)
    simA.run(10, print_fn=lambda s: None, max_steps_per_dispatch=10)
    rA = np.asarray(simA.ss.state.r)

    # checkpointed: 10 steps, write, reload, 10 more
    simB = Simulation(fresh(), str(waterbox_dir), run_dir=str(tmp_path),
                      engine="nlist")
    simB.run(10, print_fn=lambda s: None, max_steps_per_dispatch=10)
    snapdir = write_checkpoint(simB, str(tmp_path))
    import shutil

    for aux in ("martini.data", "restraint.data"):
        if (waterbox_dir / aux).exists():
            shutil.copy(waterbox_dir / aux, tmp_path / aux)
    db2 = load_db([str(waterbox_dir / "object.data")],
                  str(tmp_path / "restart"), str(tmp_path))
    db2.compile_string("lcg64 RANDOM { randomizeSeed=0; }")
    simC = Simulation(db2, str(tmp_path), run_dir=str(tmp_path),
                      engine="nlist")
    simC.run(10, print_fn=lambda s: None, max_steps_per_dispatch=10)
    n = simA.sysdef.state.n_local
    gA = simA.sysdef.collection.gid
    gC = simC.sysdef.collection.gid
    rC = np.asarray(simC.ss.state.r)
    dr = rA[: n][np.argsort(gA)] - rC[: n][np.argsort(gC)]
    dr -= np.asarray(simA.ss.box.lengths) * np.round(
        dr / np.asarray(simA.ss.box.lengths))
    # positions pass through ASCII checkpoint text (~1e-13 nm rounding);
    # identical noise keeps the trajectories locked together
    assert np.abs(dr).max() < 1e-4


def test_single_constraint_closed_form_matches_general():
    """The n=1 closed-form RATTLE projection (r4 fast path; every
    Martini constraint) matches the general iterated solver -- exercised
    by padding each group to n=2 with an invalid second pair, which
    routes through the general path on identical physics."""
    import jax.numpy as jnp
    import numpy as np

    from ddcmd_tpu.integrators.constraints import make_constraint_project

    rng = np.random.default_rng(3)
    G, m = 64, 2
    L = 5.0
    r = rng.uniform(-L / 2, L / 2, (G * m + 1, 3))
    v = rng.standard_normal((G * m + 1, 3)) * 0.5
    rmass = 1.0 / rng.uniform(40.0, 90.0, G * m + 1)
    r[-1] = v[-1] = 0.0
    rmass[-1] = 0.0
    atoms = np.arange(G * m, dtype=np.int32).reshape(G, m)
    # target = current MIN-IMAGED distance +- a small violation (the
    # solver min-images; a raw-distance target can be infeasible)
    dmi = r[atoms[:, 0]] - r[atoms[:, 1]]
    dmi -= L * np.round(dmi / L)
    d = np.linalg.norm(dmi, axis=1)
    dist = (d * rng.uniform(0.96, 1.04, G)).astype(np.float64)

    pairs1 = np.tile(np.array([[[0, 1]]], np.int32), (G, 1, 1))
    proj1 = make_constraint_project(pairs1, dist[:, None], jnp.float64, m,
                                    box_lengths=[L, L, L])
    pairs2 = np.tile(np.array([[[0, 1], [0, 1]]], np.int32), (G, 1, 1))
    dist2 = np.stack([dist, np.zeros(G)], axis=1)   # second pair invalid
    proj2 = make_constraint_project(pairs2, dist2, jnp.float64, m,
                                    box_lengths=[L, L, L])

    args = (jnp.asarray(r), jnp.asarray(v), jnp.asarray(rmass),
            jnp.asarray(atoms), jnp.ones(G), 0.02)
    for mode in (True, False):
        v1 = np.asarray(proj1(*args, jnp.asarray(mode)))
        v2 = np.asarray(proj2(*args, jnp.asarray(mode)))
        np.testing.assert_allclose(v1, v2, rtol=1e-9, atol=1e-11,
                                   err_msg=f"mode_front={mode}")
        # and the projected state satisfies the constraint (front mode)
        if mode:
            vI, vJ = v1[:, 0], v1[:, 1]
            p = dmi + 0.02 * (vI - vJ)
            np.testing.assert_allclose(np.linalg.norm(p, axis=1), dist,
                                       rtol=1e-9)


def test_fixed_rebuild_matches_adaptive(tmp_path, monkeypatch):
    """DDCMD_FIXED_REBUILD=1 (fixed-cadence rebuilds, no in-scan conds)
    reproduces the adaptive superchunk's trajectory: rebuild timing is
    physics-neutral while both lists are skin-valid (same pairs within
    rcut), and the noise stream is keyed by global step index."""
    import numpy as np

    import jax

    from ddcmd_tpu.models import load, martini_water
    from ddcmd_tpu.run.simulate import Simulation

    martini_water(str(tmp_path), n=400)
    es = {}
    for mode in ("0", "1"):
        monkeypatch.setenv("DDCMD_FIXED_REBUILD", mode)
        db, base = load(str(tmp_path))
        sim = Simulation(db, base, run_dir=str(tmp_path),
                         engine="cellblock")
        sim.first_energy()
        sim.key = jax.random.PRNGKey(12)
        rows = []
        sim.run(40, print_fn=lambda s: rows.append(s),
                max_steps_per_dispatch=40)
        es[mode] = (float(sim.ss.energy.eion), float(sim.ss.energy.rk),
                    np.asarray(sim.ss.state.r))
    e0, rk0, r_a = es["0"]
    e1, rk1, r_f = es["1"]
    assert e1 == pytest.approx(e0, rel=1e-4, abs=1e-2)
    assert rk1 == pytest.approx(rk0, rel=1e-3, abs=1e-2)
    # positions agree modulo the wrap convention (compare via min-image)
    L = np.asarray(sim.ss.box.lengths, dtype=np.float64)
    d = r_f - r_a
    d = d - L * np.round(d / L)
    assert np.abs(d).max() < 1e-3
