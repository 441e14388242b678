#!/usr/bin/env python
"""Benchmark: Martini waterbox steps/sec on the local accelerator.

Prints ONE JSON line:
  {"metric": "waterbox_steps_per_sec", "value": N, "unit": "steps/s",
   "vs_baseline": R, ...}

Baseline note: the mounted reference (LLNL/ddcMD) canNOT be built or run
here -- its `util/` and `recbis/` submodule sources are missing (broken
symlinks) and no MPI exists in the image -- and the repo publishes no
numbers.  `vs_baseline` is therefore computed against a
DOCUMENTED ESTIMATE of CPU-ddcMD on this workload:
  6173 beads * ~80 pairs/bead / step, C code at ~50M pair-interactions/s
  per core incl. neighbor maintenance => ~100 steps/s single-core.
BASELINE.json's stated target is >=5x CPU-ddcMD per chip.
"""

import json
import os
import sys
import time

BASELINE_STEPS_PER_SEC = 100.0  # estimated CPU-ddcMD (see docstring)


def _log(msg, _t0=[None]):
    # stage timestamps on stderr (stdout stays the single JSON line); a
    # slow compile is attributable from the last stamp
    if _t0[0] is None:
        _t0[0] = time.perf_counter()
    print(f"[bench +{time.perf_counter() - _t0[0]:7.1f}s] {msg}",
          file=sys.stderr, flush=True)


def main():
    import tempfile

    import jax

    if jax.devices()[0].platform != "gpu":
        # a measurement that finds no GPU fails; it never times the CPU
        print(f"bench: needs a GPU, JAX found {jax.devices()[0].platform!r}",
              file=sys.stderr)
        return 2
    from ddcmd_tpu.models import load
    from ddcmd_tpu.run.simulate import Simulation
    from ddcmd_tpu.utils.cache import setup_compile_cache

    setup_compile_cache()
    _log(f"device: {jax.devices()[0].device_kind}")
    workload = os.environ.get("BENCH_WORKLOAD", "waterbox")
    d = tempfile.mkdtemp()
    if workload == "eam":
        # FCC copper, RATIONAL EAM (models.eam_crystal); BENCH_NC cells
        from ddcmd_tpu.models import eam_crystal

        eam_crystal(d, nc=int(os.environ.get("BENCH_NC", "12")))
        db, base = load(d)
        metric = "eam_crystal_steps_per_sec"
    elif workload == "bilayer":
        # ~100k-bead Martini DPPC bilayer: nonbond + bonds + angles +
        # constraints + semi-aniso NPT in one workload, measured at the
        # production dt after a small-dt equilibration
        # (models.equilibrated_bilayer; BENCH_EQUIL=steps,dt_fs).
        # BENCH_RESTART_DIR reuses a previously equilibrated dir.
        from ddcmd_tpu.models import equilibrated_bilayer

        restart = None
        if os.environ.get("BENCH_RESTART_DIR"):
            d = os.environ["BENCH_RESTART_DIR"]
            restart = os.path.join(d, "restart")
        else:
            eq_steps, eq_dt = os.environ.get("BENCH_EQUIL", "3000,5").split(",")
            _log(f"equilibrating {eq_steps} steps at dt={eq_dt} fs")
            restart, _ = equilibrated_bilayer(
                d, nx=int(os.environ.get("BENCH_NX", "48")),
                steps=int(eq_steps), dt_fs=float(eq_dt),
                engine=os.environ.get("BENCH_ENGINE", "auto"))
            _log(f"equilibration done (BENCH_RESTART_DIR={d} reuses it)")
        db, base = load(d, restart=restart)
        metric = "bilayer_steps_per_sec"
    else:
        # the reference's examples/waterbox deck, generated
        from ddcmd_tpu.models import martini_water
        from ddcmd_tpu.run.cli import load_db

        martini_water(d, waterbox=True)
        db = load_db([os.path.join(d, "object.data")],
                     os.path.join(d, "snapshot.mem", "restart"), d)
        base = d
        metric = "waterbox_steps_per_sec"
    if os.environ.get("BENCH_SHARD"):
        return _main_shard(db, base, metric)

    _log(f"workload={workload} loaded; building Simulation")
    sim = Simulation(db, base, run_dir=d,
                     engine=os.environ.get("BENCH_ENGINE", "auto"))
    engine = sim.engine
    _log(f"Simulation built (engine={engine}); first_energy")
    sim.first_energy()
    _log("first_energy done")
    rep = int(os.environ.get("BENCH_REPLICATE", "1"))
    if rep > 1:
        from ddcmd_tpu.objects.parser import DeckObject

        sim.apply_transform(DeckObject(
            "rep", "TRANSFORM",
            {"type": ["REPLICATE"], "nx": [str(rep)], "ny": [str(rep)],
             "nz": [str(rep)]}))
    dt_fs = sim.sysdef.cfg.dt * 1e3

    n_steps = int(os.environ.get("BENCH_STEPS", "4000"))
    # bilayer default: short dispatches keep rollback retries cheap while
    # the NPT start settles (CLAUDE.md: BENCH_DISPATCH<=400 there)
    disp_default = "400" if workload == "bilayer" else "1600"
    dispatch = int(os.environ.get("BENCH_DISPATCH", disp_default))

    # warmup: compile the dispatch-sized program + run one of them
    _log(f"warmup: {dispatch} steps (includes superchunk compile)")
    sim.run(dispatch, print_fn=lambda s: None, max_steps_per_dispatch=dispatch)
    jax.block_until_ready(sim.ss.state.r)

    # measure in windows and report the best one (max-over-windows is
    # the sustained rate the card demonstrated; all windows are printed).
    # printinfo rows are collected for a physics sidecar: the scoreboard
    # certifies steps/s AND that the energy stayed finite/stationary.
    rows = []

    def collect(line):
        try:
            parts = line.split()
            rows.append((int(parts[0]), float(parts[2])))
        except (ValueError, IndexError):
            pass

    n_windows = max(1, int(os.environ.get("BENCH_WINDOWS", "3")))
    # window length == warmup dispatch so every window reuses the SAME
    # compiled chunk shape (n_rebuilds/steps-per-rebuild are static args;
    # a different window length recompiles INSIDE the measured window --
    # observed as a consistent ~5x straggler first window)
    win = dispatch if n_steps >= dispatch else max(1, n_steps)
    n_windows = max(n_windows, n_steps // win)
    window_sps = []
    _log(f"warmup done; measuring {n_windows} windows x {win} steps")
    for wdx in range(n_windows):
        t0 = time.perf_counter()
        sim.run(win, print_fn=collect, max_steps_per_dispatch=dispatch)
        jax.block_until_ready(sim.ss.state.r)
        elapsed = time.perf_counter() - t0
        window_sps.append(win / elapsed)
        _log(f"window {wdx}: {win / elapsed:.1f} steps/s")

    steps_per_sec = max(window_sps)
    ns_per_day = steps_per_sec * dt_fs * 86400.0 / 1e6

    # energy sidecar: linear slope of per-bead Etotal over the measured
    # window (deck energy units / ns / bead).  A perf win that breaks
    # physics shows up here as drift/NaN (masters.c:470-475 discipline).
    energy = {}
    if len(rows) >= 2:
        import numpy as _np

        loops = _np.asarray([x[0] for x in rows], dtype=_np.float64)
        etot = _np.asarray([x[1] for x in rows], dtype=_np.float64)
        t_ns = loops * dt_fs * 1e-6
        slope = float(_np.polyfit(t_ns, etot, 1)[0]) if len(rows) > 2 \
            else float((etot[-1] - etot[0]) / max(t_ns[-1] - t_ns[0], 1e-12))
        energy = {
            "energy_finite": bool(_np.isfinite(etot).all()),
            "energy_drift_per_ns_bead": round(slope, 6),
            "energy_unit": getattr(sim.printinfo, "u_energy", "?"),
            "energy_first": round(float(etot[0]), 6),
            "energy_last": round(float(etot[-1]), 6),
            "energy_note": "thermostatted run: slope = stationarity, "
                           "not NVE drift",
        }

    # the single-core CPU estimate scales ~1/N: the documented ~100
    # steps/s is for the 6,173-bead waterbox, so scale it per-particle
    # for every workload (this subsumes the REPLICATE factor, and is
    # conservative for EAM/bilayer whose per-pair CPU cost exceeds LJ)
    n_particles = int(sim.sysdef.state.n_local)
    baseline = BASELINE_STEPS_PER_SEC * 6173.0 / max(n_particles, 1)
    out = {
        "metric": metric,
        "value": round(steps_per_sec, 2),
        "unit": "steps/s",
        "vs_baseline": round(steps_per_sec / baseline, 2),
        "ns_per_day": round(ns_per_day, 1),
        "n_steps": n_windows * win,
        "windows_steps_per_sec": [round(x, 2) for x in window_sps],
        "n_particles": n_particles,
        "device": jax.devices()[0].device_kind,
        "engine": engine,
        "baseline_note": "estimated CPU-ddcMD ~100 steps/s; reference binary unbuildable from mount (missing util/ and recbis/ sources, no MPI)",
        **energy,
    }
    print(json.dumps(out))


def _main_shard(db, base, metric):
    """BENCH_SHARD=1: the workload through ParallelSimulation on a
    device MESH (BENCH_SHARD_SHAPE=x,y,z; default 1,1,1 -- one card as a
    1-device mesh)."""
    import re

    import jax

    from ddcmd_tpu.run.parallel_sim import ParallelSimulation

    shape = tuple(int(x) for x in
                  os.environ.get("BENCH_SHARD_SHAPE", "1,1,1").split(","))
    psim = ParallelSimulation(db, base, shape=shape)
    _log(f"shard mode: shape={shape} engine={psim.shard_engine}")
    psim.first_energy()
    _log("first_energy done")
    k = psim.chunk_steps
    dispatch = max(1, int(os.environ.get("BENCH_DISPATCH", "1600")) // k) * k
    n_steps = int(os.environ.get("BENCH_STEPS", "4000"))
    n_windows = max(1, int(os.environ.get("BENCH_WINDOWS", "3")))
    dt_fs = psim.sysdef.cfg.dt * 1e3

    rows = []
    pat = re.compile(r"^\s*(\d+)\s+epot/N=\s*([-\d.e+]+)\s+"
                     r"ekin/N=\s*([-\d.e+]+)")

    def collect(line):
        m = pat.match(line)
        if m:
            rows.append((int(m.group(1)),
                         float(m.group(2)) + float(m.group(3))))

    _log(f"warmup: {dispatch} steps (superchunk compile; chunk={k})")
    psim.run(dispatch, print_fn=collect, max_steps_per_dispatch=dispatch)
    jax.block_until_ready(psim.fields["r"])
    rows.clear()
    win = dispatch
    window_sps = []
    _log(f"warmup done; measuring {n_windows} windows x {win} steps")
    for wdx in range(max(n_windows, n_steps // win)):
        t0 = time.perf_counter()
        psim.run(win, print_fn=collect, max_steps_per_dispatch=dispatch)
        jax.block_until_ready(psim.fields["r"])
        elapsed = time.perf_counter() - t0
        window_sps.append(win / elapsed)
        _log(f"window {wdx}: {win / elapsed:.1f} steps/s")
    steps_per_sec = max(window_sps)

    energy = {}
    if len(rows) >= 2:
        import numpy as _np

        loops = _np.asarray([x[0] for x in rows], dtype=_np.float64)
        etot = _np.asarray([x[1] for x in rows], dtype=_np.float64)
        t_ns = loops * dt_fs * 1e-6
        slope = float(_np.polyfit(t_ns, etot, 1)[0]) if len(rows) > 2 \
            else 0.0
        energy = {"energy_finite": bool(_np.isfinite(etot).all()),
                  "energy_drift_per_ns_bead": round(slope, 6)}

    n_particles = int(psim.sysdef.state.n_local)
    baseline = BASELINE_STEPS_PER_SEC * 6173.0 / max(n_particles, 1)
    out = {
        "metric": metric.replace("_steps_per_sec", "_shard_steps_per_sec"),
        "value": round(steps_per_sec, 2),
        "unit": "steps/s",
        "vs_baseline": round(steps_per_sec / baseline, 2),
        "ns_per_day": round(steps_per_sec * dt_fs * 86400.0 / 1e6, 1),
        "windows_steps_per_sec": [round(x, 2) for x in window_sps],
        "n_particles": n_particles,
        "mesh_shape": list(shape),
        "device": jax.devices()[0].device_kind,
        "engine": f"shard-{psim.shard_engine}",
        **energy,
    }
    print(json.dumps(out))


if __name__ == "__main__":
    sys.exit(main())
