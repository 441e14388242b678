#!/usr/bin/env python
"""One-shot per-phase GPU profile of a bench workload.

Answers "where do the milliseconds go": rebuild vs force vs kick vs
fused step, each as its own timed dispatch (profile_phases), plus the
production fused-loop steps/s for the same process.  One process, one
workload; fails without a GPU.

Usage:  BENCH_REPLICATE=2 python scripts/phase_profile.py
Env:    BENCH_WORKLOAD / BENCH_ENGINE / BENCH_REPLICATE as bench.py.
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import jax

    if jax.devices()[0].platform != "gpu":
        sys.exit("phase_profile: needs a GPU")
    from ddcmd_tpu.run.cli import load_db
    from ddcmd_tpu.run.simulate import Simulation
    from ddcmd_tpu.utils.cache import setup_compile_cache

    setup_compile_cache()
    print("device:", jax.devices()[0].device_kind, flush=True)

    workload = os.environ.get("BENCH_WORKLOAD", "waterbox")
    rep = 1
    if workload == "bilayer":
        import tempfile

        from ddcmd_tpu.models import load, martini_bilayer

        d = tempfile.mkdtemp()
        nx = int(os.environ.get("BENCH_NX", "48"))
        martini_bilayer(d, nx=nx, ny=nx)
        db, base = load(d)
    elif workload == "eam":
        import tempfile

        from ddcmd_tpu.models import eam_crystal, load

        d = tempfile.mkdtemp()
        eam_crystal(d, nc=int(os.environ.get("BENCH_NC", "12")))
        db, base = load(d)
    else:
        import tempfile

        from ddcmd_tpu.models import martini_water

        base = tempfile.mkdtemp()
        martini_water(base, waterbox=True)
        db = load_db([os.path.join(base, "object.data")],
                     os.path.join(base, "snapshot.mem", "restart"), base)
        rep = int(os.environ.get("BENCH_REPLICATE", "2"))
    sim = Simulation(db, base, run_dir=base,
                     engine=os.environ.get("BENCH_ENGINE", "auto"))
    if rep > 1:
        from ddcmd_tpu.objects.parser import DeckObject
        sim.apply_transform(DeckObject(
            "rep", "TRANSFORM",
            {"type": ["REPLICATE"], "nx": [str(rep)], "ny": [str(rep)],
             "nz": [str(rep)]}))
    n = sim.sysdef.state.n_local
    g = sim.grid
    print(f"n={n} engine={sim.engine} ncells={getattr(g, 'ncells', None)} "
          f"cap={getattr(g, 'cap', None)}", flush=True)

    sim.first_energy()
    t0 = time.perf_counter()
    phases = sim.profile_phases(
        n_iter=30, detail=bool(int(os.environ.get("BENCH_DETAIL", "1"))))
    print("phase profile:", flush=True)
    for k, v in sorted(phases.items()):
        if isinstance(v, float):
            print(f"  {k:<24} {v * 1e6:10.1f} us", flush=True)
        else:
            print(f"  {k:<24} {v}", flush=True)

    # production fused-loop rate (one more compile: the dispatch program)
    steps = int(os.environ.get("BENCH_STEPS", "2000"))
    disp = int(os.environ.get("BENCH_DISPATCH", "1000"))
    sim.run(disp, print_fn=lambda s: None, max_steps_per_dispatch=disp)
    jax.block_until_ready(sim.ss.state.r)
    t0 = time.perf_counter()
    sim.run(steps, print_fn=lambda s: None, max_steps_per_dispatch=disp)
    jax.block_until_ready(sim.ss.state.r)
    el = time.perf_counter() - t0
    out = dict(n=n, steps_per_sec=round(steps / el, 2),
               us_per_step=round(el / steps * 1e6, 1),
               **{k: round(v * 1e6, 1) for k, v in phases.items()
                  if isinstance(v, float)})
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
