"""Command-line entry: `python -m ddcmd_tpu.run.cli [master] -o deck -r restart`.

Mirrors the reference CLI (/root/reference/src/commandLineOptions.c:69-120):
masters simulate (default) / analysis / transform / thermalize / readWrite /
testForce / testPressure / integrationTest / unitTest.
"""

from __future__ import annotations

import argparse
import os
import sys

from ..objects import ObjectDB


def load_db(object_files: list[str], restart_file: str | None, base_dir: str = "."):
    """objectSetup analog (/root/reference/src/objectSetup.c:14-79):
    compile deck(s) + restart + referenced parmfiles into one DB."""
    db = ObjectDB()
    for f in object_files:
        db.compile_file(f)
    if restart_file:
        db.compile_file(restart_file)
    # compile POTENTIAL parmfiles (martini.data etc.)
    for pot in db.by_class("POTENTIAL"):
        pf = pot.get_str("parmfile", "")
        if pf:
            path = pf if os.path.isabs(pf) else os.path.join(base_dir, pf)
            if os.path.exists(path):
                db.compile_file(path)
    return db


def main(argv=None):
    p = argparse.ArgumentParser(prog="ddcmd-tpu")
    p.add_argument("master", nargs="?", default="simulate",
                   choices=["simulate", "analysis", "transform", "thermalize",
                            "readWrite", "eightFold", "testForce",
                            "testPressure", "integrationTest", "unitTest"])
    p.add_argument("-o", "--object", action="append", default=None,
                   help="object deck file(s)")
    p.add_argument("-r", "--restart", default=None, help="restart file")
    p.add_argument("-n", "--nloops", type=int, default=None,
                   help="override number of loops (deltaloop)")
    p.add_argument("--f64", action="store_true", help="run in float64 (CPU validation)")
    p.add_argument("--cpu", action="store_true",
                   help="force the CPU backend")
    p.add_argument("--run-dir", default=".")  # created if absent (below)
    args = p.parse_args(argv)

    decks = args.object or ["object.data"]
    base_dir = os.path.dirname(os.path.abspath(decks[0]))
    db = load_db(decks, args.restart, base_dir)
    os.makedirs(args.run_dir, exist_ok=True)

    import jax
    import jax.numpy as jnp

    from ..utils.cache import setup_compile_cache

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    setup_compile_cache()
    dtype = jnp.float64 if args.f64 else jnp.float32
    if args.f64:
        jax.config.update("jax_enable_x64", True)

    if args.master == "simulate":
        from .simulate import simulate_master

        simulate_master(db, base_dir, run_dir=args.run_dir,
                        n_loops=args.nloops, dtype=dtype)
    elif args.master == "testForce":
        from .testforce import testforce_master

        testforce_master(db, base_dir, dtype=dtype)
    elif args.master == "testPressure":
        from .testpressure import testpressure_master

        # the delta-halving sweep needs f64: at f32 the central difference
        # hits roundoff after ~3 halvings and the slope check is meaningless
        jax.config.update("jax_enable_x64", True)
        testpressure_master(db, base_dir, dtype=jnp.float64,
                            out_dir=args.run_dir)
    elif args.master == "analysis":
        from .masters import analysis_master

        analysis_master(db, base_dir, run_dir=args.run_dir, dtype=dtype)
    elif args.master == "transform":
        from .masters import transform_master

        transform_master(db, base_dir, run_dir=args.run_dir, dtype=dtype)
    elif args.master == "thermalize":
        from .masters import thermalize_master

        thermalize_master(db, base_dir, run_dir=args.run_dir, dtype=dtype)
    elif args.master == "readWrite":
        from .masters import read_write_master

        read_write_master(db, base_dir, run_dir=args.run_dir, dtype=dtype)
    elif args.master == "eightFold":
        from .masters import eightfold_master

        eightfold_master(db, base_dir, run_dir=args.run_dir, dtype=dtype)
    elif args.master == "integrationTest":
        from .masters import integration_test_master

        integration_test_master(db, base_dir, run_dir=args.run_dir)
    elif args.master == "unitTest":
        from .masters import unit_test_master

        return unit_test_master()
    else:
        print(f"master {args.master!r} not implemented yet", file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
