#!/usr/bin/env python
"""End-to-end pair-engine A/B on one GPU: steps/s of each deck under each
engine, measured in turns within one process.

    python scripts/engine_ab.py [--steps 400] [--decks waterbox,bilayer,eam,eam24]

Decks: the Martini water box (6,173 beads), the 48x48 DPPC bilayer
(~100k beads, after the small-dt equilibration of
models.equilibrated_bilayer), EAM copper at nc=12 (6,912 atoms) and
nc=24 (55,296 atoms).  Engines: the pallas kernel where the deck admits
it, and XLA's plain cellblock and nlist engines.  Every engine of a deck
is compiled and warmed up first; then the timed windows run in the order
A B C C B A, so drift of the card's clocks shows as a spread instead of
a bias.  One JSON line per deck goes to stdout (host clock around
block_until_ready; steps/s per window, rollbacks, first energy).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _decks(root):
    from ddcmd_tpu.models import (eam_crystal, equilibrated_bilayer, load,
                                  martini_water)
    from ddcmd_tpu.run.cli import load_db

    def waterbox():
        d = os.path.join(root, "waterbox")
        os.makedirs(d)
        martini_water(d, waterbox=True)
        return lambda: (load_db([os.path.join(d, "object.data")],
                                os.path.join(d, "snapshot.mem", "restart"),
                                d), d)

    def bilayer():
        d = os.path.join(root, "bilayer")
        os.makedirs(d)
        restart, _ = equilibrated_bilayer(d, nx=48, steps=3000, dt_fs=5.0)
        return lambda: (load(d, restart=restart)[0], d)

    def eam(nc):
        def build():
            d = os.path.join(root, f"eam{nc}")
            os.makedirs(d)
            eam_crystal(d, nc=nc)
            return lambda: (load(d)[0], d)
        return build

    return {"waterbox": (waterbox, ("pallas", "nlist", "cellblock")),
            "bilayer": (bilayer, ("pallas", "nlist", "cellblock")),
            "eam": (eam(12), ("cellblock", "nlist")),
            "eam24": (eam(24), ("cellblock", "nlist"))}


def run_deck(name, build, engines, steps):
    import jax

    from ddcmd_tpu.run.simulate import Simulation

    make = build()
    sims = {}
    for eng in engines:
        db, base = make()
        sim = Simulation(db, base, run_dir=base, engine=eng)
        sim.first_energy()
        t0 = time.perf_counter()
        sim.run(steps, print_fn=lambda s: None, max_steps_per_dispatch=steps)
        jax.block_until_ready(sim.ss.state.r)
        sims[eng] = (sim, float(sim.ss.energy.eion),
                     time.perf_counter() - t0)
    windows = {eng: [] for eng in engines}
    for eng in list(engines) + list(reversed(engines)):
        sim = sims[eng][0]
        t0 = time.perf_counter()
        sim.run(steps, print_fn=lambda s: None, max_steps_per_dispatch=steps)
        jax.block_until_ready(sim.ss.state.r)
        windows[eng].append(steps / (time.perf_counter() - t0))
    out = {"deck": name, "n": int(sims[engines[0]][0].sysdef.state.n_local),
           "steps_per_window": steps}
    for eng, (sim, e0, warm) in sims.items():
        out[eng] = {"steps_per_s": [round(w, 2) for w in windows[eng]],
                    "first_epot": e0, "warmup_s": round(warm, 1),
                    "rollbacks": sim.n_rollbacks,
                    "epot_end": float(sim.ss.energy.eion)}
    print(json.dumps(out), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--decks", default="waterbox,bilayer,eam,eam24")
    args = ap.parse_args(argv)

    import jax

    if jax.devices()[0].platform != "gpu":
        print("engine_ab: needs a GPU", file=sys.stderr)
        return 2
    from ddcmd_tpu.utils.cache import setup_compile_cache

    setup_compile_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    with tempfile.TemporaryDirectory() as root:
        decks = _decks(root)
        for name in args.decks.split(","):
            build, engines = decks[name]
            run_deck(name, build, engines, args.steps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
