#!/usr/bin/env python
"""On-card smoke test of the MD main path on NVIDIA GPUs.

    python chip_smoke.py           one card: phases 1-5 below
    python chip_smoke.py --multi   four cards: the sharded bilayer only

Phases (one process; the first failure ends the run with a non-zero exit):
  1. device check: jax.devices(), device_kind, the card's name and power
     limit; exit non-zero unless the platform is 'gpu';
  2. kernel parity at full size: the pallas pair kernel
     (ops/pallas_nlist.py) against the float64 nlist reference on the
     same positions and neighbor lists -- Martini water box (6,173
     beads), Martini DPPC bilayer (48x48 lipids, ~100k beads, in-kernel
     exclusions) and, for the record, the EAM copper deck's engine;
  3. Simulation end to end through the load path: a few hundred steps of
     each deck, finite energies, no rollbacks, the bilayer on the kernel
     that masks exclusions in-engine;
  4. ParallelSimulation on a 1-device mesh (water box, bilayer): first
     energy against Simulation on the same deck, then a few chunks;
  5. the last line: {"ok": true, "device": {...}}.

--multi replaces phases 2-4 with the bilayer under ParallelSimulation
shape (2, 2, 1) with zRamp load-balanced walls on four cards, checked
against single-card Simulation.

Parity bounds: the kernel sums in float32 in a fixed order (no atomics),
so the bounds cover float32 rounding only -- max|df|/max|f| < 1e-5 and
|dE|/|E| < 1e-6 against float64.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

F_BOUND = 1e-5          # kernel: max |df| / max |f| vs float64
E_BOUND = 1e-6          # kernel: |dE| / |E| vs float64
SHARD_BOUND = 1e-4      # 1-device mesh vs Simulation, first energy
MULTI_BOUND = 2e-4      # four cards vs one card, first energy
EQUIL = (3000, 5.0)     # bilayer equilibration: steps at dt (fs)
STEPS = 400             # Simulation steps per deck


def log(msg):
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    return out.stdout.strip()


# ---------------------------------------------------------------------------
# decks
# ---------------------------------------------------------------------------

def waterbox_deck(root):
    from ddcmd_tpu.models import martini_water
    from ddcmd_tpu.run.cli import load_db

    d = os.path.join(root, "waterbox")
    os.makedirs(d)
    martini_water(d, waterbox=True)
    return lambda: load_db([os.path.join(d, "object.data")],
                           os.path.join(d, "snapshot.mem", "restart"), d), d


def eam_deck(root):
    from ddcmd_tpu.models import eam_crystal, load

    d = os.path.join(root, "eam")
    os.makedirs(d)
    eam_crystal(d, nc=12)
    return lambda: load(d)[0], d


def bilayer_deck(root, nx=48, equil=EQUIL, interpret=False):
    """The nx x nx DPPC bilayer after the short small-dt equilibration
    (models.equilibrated_bilayer) that bench.py runs too."""
    from ddcmd_tpu.models import equilibrated_bilayer, load

    d = os.path.join(root, "bilayer")
    os.makedirs(d)
    steps, dt_fs = equil
    t0 = time.perf_counter()
    restart, sim = equilibrated_bilayer(d, nx=nx, steps=steps, dt_fs=dt_fs,
                                        interpret=interpret)
    check_run(sim, "bilayer equilibration")
    log(f"bilayer: equilibrated {steps} steps at dt={dt_fs} fs on "
        f"{sim.engine} in {time.perf_counter() - t0:.1f}s")
    return lambda: load(d, restart=restart)[0], d


def check_run(sim, what):
    import numpy as np

    e = float(sim.ss.energy.eion) + float(sim.ss.energy.rk)
    if not np.isfinite(e):
        raise AssertionError(f"{what}: non-finite energy {e}")
    if sim.n_rollbacks:
        raise AssertionError(f"{what}: {sim.n_rollbacks} rollback events")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def kernel_parity(name, make_db, base, interpret=False):
    """The pair kernel vs potentials.martini.martini_nonbond in float64 on
    the same positions and neighbor list."""
    import jax.numpy as jnp
    import numpy as np

    from ddcmd_tpu.ops.pallas_nlist import nlist_pair_eval
    from ddcmd_tpu.potentials.martini import (martini_device_tables,
                                              martini_nonbond)
    from ddcmd_tpu.run.forces import _excl_channels, _excl_table, _inlist_excl
    from ddcmd_tpu.run.simulate import Simulation

    sim = Simulation(make_db(), base, engine="nlist", dtype=jnp.float64)
    sd = sim.sysdef
    ss, nbr, ov = sim._build_nbr_jit(sim.ss)
    assert not bool(ov), f"{name}: neighbor overflow"
    st = ss.state
    parms = next(p[2] for p in sd.potentials if p[0] == "MARTINI")
    tidx = jnp.asarray(parms.species_lj_type)[st.species]
    excl = _inlist_excl(sd, "pallas")
    ex = etbl = None
    if excl:
        ex = jnp.asarray(_excl_channels(sd.bonded.exclusions, st.n_pad))
        etbl = jnp.asarray(_excl_table(sd.bonded.exclusions, st.n_pad))
    # identical inputs: float32-rounded positions and box on both sides
    r32 = st.r.astype(jnp.float32)
    L32 = ss.box.lengths.astype(jnp.float32)
    t64 = martini_device_tables(parms, dtype=jnp.float64)
    f0, e0, _, _, _ = martini_nonbond(
        r32.astype(jnp.float64), st.q, tidx, st.fmask, nbr,
        L32.astype(jnp.float64), t64, excl_tbl=etbl)
    e0 = e0 - jnp.sum(-0.5 * st.q * st.q * st.fmask * t64["keR"]
                      * t64["crf"])
    t32 = martini_device_tables(parms, dtype=jnp.float32)
    coul = bool(np.any(np.asarray(st.q) != 0.0))
    f1, e1, _, _ = nlist_pair_eval(
        r32, st.q.astype(jnp.float32), tidx, st.fmask.astype(jnp.float32),
        nbr, L32, t32, coulomb=coul,
        excl_vals=ex, interpret=interpret)
    f0 = np.asarray(f0)
    df = float(np.abs(np.asarray(f1, np.float64) - f0).max()
               / np.abs(f0).max())
    de = abs(float(e1) - float(e0)) / abs(float(e0))
    log(f"parity {name}: n={sd.state.n_local} K={nbr.shape[1]} "
        f"exclusions={'in-kernel' if excl else 'none'} "
        f"max|df|/max|f|={df:.3e} |dE|/|E|={de:.3e} "
        f"(bounds {F_BOUND:g}, {E_BOUND:g})")
    assert df < F_BOUND and de < E_BOUND, f"{name}: kernel parity failed"


def engine_parity(name, make_db, base):
    """Whole-force parity of the engine a deck runs on vs float64 nlist
    (reported, not bounded: decks without a hand-written kernel)."""
    import jax.numpy as jnp
    import numpy as np

    from ddcmd_tpu.run.simulate import Simulation

    out = {}
    for key, kw in (("ref", dict(engine="nlist", dtype=jnp.float64)),
                    ("run", {})):
        sim = Simulation(make_db(), base, **kw)
        sim.first_energy()
        out[key] = (sim.engine, np.asarray(sim.ss.state.f, np.float64),
                    float(sim.ss.energy.eion))
    (_, f0, e0), (eng, f1, e1) = out["ref"], out["run"]
    log(f"engine parity {name}: {eng} vs float64 nlist "
        f"max|df|/max|f|={np.abs(f1 - f0).max() / np.abs(f0).max():.3e} "
        f"|dE|/|E|={abs(e1 - e0) / abs(e0):.3e}")


def simulate_deck(name, make_db, base, steps=STEPS, interpret=False,
                  expect_kernel=False):
    from ddcmd_tpu.run.forces import _inlist_excl
    from ddcmd_tpu.run.simulate import Simulation

    with tempfile.TemporaryDirectory() as run_dir:
        sim = Simulation(make_db(), base, run_dir=run_dir,
                         interpret=interpret)
        log(f"simulate {name}: engine={sim.engine} "
            f"n={sim.sysdef.state.n_local}")
        sim.first_energy()
        e_first = float(sim.ss.energy.eion)
        sim.run(steps, print_fn=lambda s: None)
        check_run(sim, f"simulate {name}")
        log(f"simulate {name}: {steps} steps, e_pot {e_first:.3f} -> "
            f"{float(sim.ss.energy.eion):.3f}")
        if expect_kernel:
            assert sim.engine == "pallas", f"{name}: engine {sim.engine}"
            assert _inlist_excl(sim.sysdef, sim.engine), \
                f"{name}: exclusions are not masked in the engine"
        return e_first


def shard_deck(name, make_db, base, e_single, interpret=False):
    import numpy as np

    from ddcmd_tpu.run.parallel_sim import ParallelSimulation

    psim = ParallelSimulation(make_db(), base, shape=(1, 1, 1),
                              interpret=interpret)
    e = psim.first_energy()
    rel = abs(e - e_single) / abs(e_single)
    log(f"parallel {name} (1,1,1): engine={psim.shard_engine} first "
        f"energy {e:.3f} vs Simulation {e_single:.3f} rel={rel:.2e} "
        f"(bound {SHARD_BOUND:g})")
    assert rel < SHARD_BOUND, f"parallel {name}: first-energy parity"
    psim.run(3 * psim.chunk_steps, print_fn=lambda s: None)
    f = np.asarray(psim.f)[np.asarray(psim.mask)]
    assert np.isfinite(f).all(), f"parallel {name}: non-finite forces"


def run_single(root, interpret=False, nx=48, equil=EQUIL, steps=STEPS):
    water, water_dir = waterbox_deck(root)
    eam, eam_dir = eam_deck(root)
    bilayer, bilayer_dir = bilayer_deck(root, nx=nx, equil=equil,
                                        interpret=interpret)
    # phase 2: kernel parity at full size
    kernel_parity("waterbox", water, water_dir, interpret)
    kernel_parity("bilayer", bilayer, bilayer_dir, interpret)
    engine_parity("eam", eam, eam_dir)
    # phase 3: Simulation end to end
    e_water = simulate_deck("waterbox", water, water_dir, steps, interpret)
    e_bilayer = simulate_deck("bilayer", bilayer, bilayer_dir, steps,
                              interpret, expect_kernel=True)
    simulate_deck("eam", eam, eam_dir, steps, interpret)
    # phase 4: the sharded driver on a 1-device mesh
    shard_deck("waterbox", water, water_dir, e_water, interpret)
    shard_deck("bilayer", bilayer, bilayer_dir, e_bilayer, interpret)


def run_multi(root, interpret=False, nx=48, n_chunks=3):
    """Bilayer under ParallelSimulation (2, 2, 1) with zRamp walls, checked
    against one-card Simulation (the deck at the equilibration dt)."""
    import jax
    import numpy as np

    from ddcmd_tpu.models import load, martini_bilayer
    from ddcmd_tpu.run.parallel_sim import ParallelSimulation
    from ddcmd_tpu.run.simulate import Simulation

    d = os.path.join(root, "bilayer_walls")
    os.makedirs(d)
    martini_bilayer(d, nx=nx, ny=nx, dt_fs=EQUIL[1])
    deck = os.path.join(d, "object.data")
    with open(deck) as fh:
        txt = fh.read()
    with open(deck, "w") as fh:
        fh.write(txt.replace(
            "ddc DDC { updateRate=12; }",
            "ddc DDC { updateRate=12; loadBalance=bal; }\n"
            "bal LOADBALANCE { type=ZRAMP; rate=0; }"))
    psim = ParallelSimulation(load(d)[0], d, shape=(2, 2, 1),
                              interpret=interpret)
    devs = {dev.id for dev in psim.mesh.devices.flat}
    log(f"multi: mesh {psim.mesh.devices.shape} on devices {sorted(devs)}, "
        f"walls={psim._lb_kind}, engine={psim.shard_engine}")
    assert len(devs) == 4, "the mesh does not span four devices"
    assert len(psim.fields["r"].sharding.device_set) == 4, \
        "the particle state is not spread over the four devices"
    assert psim._lb_kind == "tensor" and psim.plan.walls is not None
    assert psim.shard_engine == "pallas"
    e_par = psim.first_energy()
    sim = Simulation(load(d)[0], d, run_dir=d, interpret=interpret)
    sim.first_energy()
    e_one = float(sim.ss.energy.eion)
    rel = abs(e_par - e_one) / abs(e_one)
    log(f"multi: first energy {e_par:.3f} on 4 devices vs {e_one:.3f} on "
        f"one ({sim.engine}) rel={rel:.2e} (bound {MULTI_BOUND:g})")
    assert rel < MULTI_BOUND, "four-device first-energy parity"
    t0 = time.perf_counter()
    psim.run(n_chunks * psim.chunk_steps, print_fn=lambda s: None)
    jax.block_until_ready(psim.fields["r"])
    f = np.asarray(psim.f)[np.asarray(psim.mask)]
    assert np.isfinite(f).all(), "four-device run: non-finite forces"
    log(f"multi: {n_chunks} chunks of {psim.chunk_steps} steps with "
        f"migration in {time.perf_counter() - t0:.1f}s, forces finite")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true",
                    help="the four-card sharded bilayer only")
    args = ap.parse_args(argv)

    import jax

    devs = jax.devices()
    kind = devs[0].device_kind
    log(f"devices: {devs} kind={kind!r}")
    if devs[0].platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {devs[0].platform!r}",
              file=sys.stderr)
        return 2
    log(card_line())
    from ddcmd_tpu.utils.cache import setup_compile_cache

    log(f"compile cache: {setup_compile_cache()}")
    jax.config.update("jax_enable_x64", True)
    with tempfile.TemporaryDirectory() as root:
        if args.multi:
            if len(devs) < 4:
                print(f"chip_smoke --multi: needs 4 GPUs, found {len(devs)}",
                      file=sys.stderr)
                return 2
            run_multi(root)
        else:
            run_single(root)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": kind, "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
