#!/usr/bin/env python
"""Replay a captured bilayer catapult bit-exact and force-check the hot
atom against an f64 O(neighborhood) oracle.

Input: the DDCMD_BLOWUP_DUMP npz (chunk noise key + in-chunk blowup
index + pre-chunk checkpoint path) written by Simulation.run.  Because
per-step noise is fold_in(chunk_key, step_index), running a SHORTER
chunk with the same key reproduces the trajectory prefix bit-exact; we
stop one step before the velocity jump and compare the engine's force
on the hot atom with a direct f64 Martini LJ+RF sum over every bead
within rlist (scipy KDTree).  A mismatch is a missed pair / kernel
defect; a match means the approach was physical (integration/dt issue).

Usage: FOR_DUMP=/tmp/blowup.npz FOR_DECK=/tmp/tmpXXXX \
       python scripts/forensic_blowup.py        # runs on the GPU
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    import jax

    if os.environ.get("FOR_PLATFORM"):
        jax.config.update("jax_platforms", os.environ["FOR_PLATFORM"])
    import jax.numpy as jnp

    x = jnp.ones((8, 128))
    jax.block_until_ready(x @ x.T)
    print("probe ok:", jax.devices()[0], flush=True)

    dump = np.load(os.environ["FOR_DUMP"], allow_pickle=True)
    deck = os.environ["FOR_DECK"]
    snapdir = str(dump["snapdir"])
    key = jnp.asarray(dump["key"])
    hot_step = int(dump["hot_step"])
    hot_row = int(dump["hot_row"])
    print(f"replaying {snapdir} to in-chunk step {hot_step} "
          f"(hot atom row {hot_row})", flush=True)

    from ddcmd_tpu.models import load
    from ddcmd_tpu.run.simulate import Simulation

    db, base = load(deck, restart=os.path.join(snapdir, "restart"))
    sim = Simulation(db, base, run_dir="/tmp",
                     engine=os.environ.get("FOR_ENGINE", "auto"))
    sim.first_energy()
    print(f"engine={sim.engine} loop0={int(sim.ss.loop)}", flush=True)

    # replay: stop right BEFORE the jump step (prefix is bit-exact)
    stop = max(0, hot_step - 1)
    ss = sim.ss
    if stop > 0:
        ss_new, scal, ov, _ = sim._chunk_jit(
            ss, key, sim.coeffs, sim._box_lam(stop), 1, stop)
        scal = np.asarray(scal)
        print(f"replayed {stop} steps: ov={bool(ov)} "
              f"vmax2[-3:]={scal[-3:, 11].round(2)} "
              f"vrow[-3:]={scal[-3:, 12].astype(int)}", flush=True)
        ss = ss_new
    # continue two more steps one at a time to bracket the jump
    for extra in range(3):
        n = sim.sysdef.state.n_local
        st = ss.state
        r = np.asarray(st.r[:n], dtype=np.float64)
        v = np.asarray(st.v[:n], dtype=np.float64)
        if not np.isfinite(r).all():
            print(f"state non-finite at step {stop + extra}; stopping",
                  flush=True)
            break
        L = np.asarray(ss.box.lengths, dtype=np.float64)
        step_now = stop + extra
        row = int(np.argmax((v ** 2).sum(1)))
        vmax = float(np.abs(v).max())
        # engine force at this state (fresh rebuild, so any staleness in
        # the replayed trajectory is removed -- compare ORACLE vs ENGINE
        # on identical positions)
        ssr, handle, ov = sim._build_nbr_jit(ss)
        # nonbond term only (the oracle below is LJ+RF; bonded forces on
        # lipid beads would pollute the comparison)
        nb_term = next(t for t in sim.force_fn.terms
                       if "martini" in t.__name__)
        f_eng = np.asarray(nb_term(ssr.state, ssr.box, handle)[0])
        # f64 oracle on the CURRENT hot atom + the atom that is about to
        # blow (hot_row) -- direct sum over beads within rcut
        from scipy.spatial import cKDTree

        rw = np.mod(r + L / 2, L)
        tree = cKDTree(rw, boxsize=L + 1e-12)
        from ddcmd_tpu.objects import units as U

        mp = next(p[2] for p in sim.sysdef.potentials if p[0] == "MARTINI")
        sig = np.asarray(mp.sigma, np.float64)
        eps = np.asarray(mp.eps, np.float64)
        tmap = np.asarray(mp.species_lj_type)
        spec = np.asarray(sim.sysdef.state.species[:n])
        rcut = float(mp.rcut)
        q = np.asarray(sim.sysdef.state.q[:n], dtype=np.float64)
        keR = U.ke / mp.epsilon_r
        krf = float(mp.krf)
        excl = set()
        bt = sim.sysdef.bonded
        if bt is not None and bt.exclusions is not None:
            for a, b in np.asarray(bt.exclusions):
                excl.add((int(a), int(b)))
                excl.add((int(b), int(a)))

        def oracle(i):
            nbrs = tree.query_ball_point(rw[i], rcut)
            f = np.zeros(3)
            dmin, jmin = 9.0, -1
            for j in nbrs:
                if j == i or (i, j) in excl:
                    continue
                d = r[i] - r[j]
                d -= L * np.round(d / L)
                rr = np.linalg.norm(d)
                if rr >= rcut:
                    continue
                if rr < dmin:
                    dmin, jmin = rr, j
                ti, tj = tmap[spec[i]], tmap[spec[j]]
                s6 = (sig[ti, tj] / rr) ** 6
                fmag = 24.0 * eps[ti, tj] * (2 * s6 * s6 - s6) / rr
                fmag += keR * q[i] * q[j] * (1.0 / rr ** 2 - 2.0 * krf * rr)
                f += fmag * d / rr
            return f, dmin, jmin

        for tag, i in (("current-hottest", row), ("dump-hot-row", hot_row)):
            if i < 0 or i >= n:
                continue
            f_o, dmin, jmin = oracle(i)
            fe = f_eng[i]
            scale = max(1.0, np.abs(f_o).max())
            err = np.abs(fe - f_o).max() / scale
            print(f"step {step_now} {tag} row {i} "
                  f"({sim.sysdef.collection.species_names[i]}): |v|max "
                  f"{vmax:.2f} dmin {dmin:.4f} (to {jmin}) "
                  f"F_oracle {np.round(f_o, 2)} F_engine {np.round(fe, 2)} "
                  f"relerr {err:.2e} {'**MISMATCH**' if err > 1e-3 else 'ok'}",
                  flush=True)
        # advance ONE step with the replay key (indices continue the
        # chunk numbering, preserving bit-exactness)
        ss2, scal1, ov1, _ = sim._chunk_jit(
            ss, key, sim.coeffs, sim._box_lam(1), 1, 1)
        # NOTE: a 1-step chunk folds in step index 0, not step_now --
        # noise diverges from the original trajectory here, but the
        # question (does the force law see the approaching pair) is
        # noise-independent at these force scales.
        ss = ss2
        s1 = np.asarray(scal1)
        print(f"  advanced: vmax2 {s1[-1, 11]:.3g} row {int(s1[-1, 12])} "
              f"e {s1[-1, 0]:.4g}", flush=True)


if __name__ == "__main__":
    main()
