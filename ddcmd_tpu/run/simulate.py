"""simulateMaster: the MD driver loop.

Reference: ddcMD src/masters.c:369-559.  Accelerator shape:

  * ONE jitted "chunk" = neighbor-list rebuild + lax.scan over
    `updateRate` MD steps (deck `ddc DDC {updateRate=20;}`), so device
    dispatch and host sync are amortized over the rebuild cadence;
  * per-step thermodynamic scalars are stacked by the scan and printed
    by the host after each chunk (printinfo);
  * overflow flags from the neighbor build trigger a host-side
    recapacity + rebuild (the reference GPU's allocPages/checkbounds
    loop, /root/reference/src/nlistGPU.cu:378,1459);
  * NaN energy kill switch mirrors masters.c:470-475;
  * checkpoint/snapshot writes at deck rates.
"""

from __future__ import annotations

import dataclasses
import math
import os
import time as _time

import jax
import jax.numpy as jnp
import numpy as np

from ..core.energy import EnergyInfo
from ..core.molecule import build_molecule_class, make_molecular_virial_fn
from ..core.system import build_system, plan_grid
from ..integrators.nglf import StepState, first_energy_call, make_nglf_step
from ..nbr.celllist import build_neighbor_list
from ..objects import ObjectDB
from ..objects import units as U
from ..utils.profile import PROFILE
from .forces import build_force_fn, choose_engine
from .printinfo import PrintInfo


class Simulation:
    """Owns the compiled step/chunk functions and the host loop."""

    def __init__(self, db: ObjectDB, base_dir: str = ".", *,
                 dtype=jnp.float32, run_dir: str = ".", engine: str = "auto",
                 interpret: bool = False):
        """engine: 'auto' (by backend, see run/forces.choose_engine),
        'pallas', 'cellblock' or 'nlist'.  interpret=True runs the pallas
        kernel on the CPU (tests only)."""
        self.db = db
        self._base_dir = base_dir
        self.run_dir = run_dir
        self.dtype = dtype
        self.sysdef = build_system(db, base_dir, dtype=dtype)
        sd = self.sysdef
        self._interpret = interpret
        engine = choose_engine(sd, dtype, engine, interpret=interpret)
        if not sd.box.ortho:
            # triclinic boxes: the cellblock engine bins in fractional
            # coordinates with h-mapped static image shifts (reference
            # GEOM non-orthorhombic binning, src/geom.c); the nlist engine is h-aware (fractional binning + h
            # min-image, nbr/celllist.py:min_image_geom) -- PAIRENERGY/
            # ORDERSH and nlist-routed decks run triclinic natively
            hm = np.asarray(sd.box.h)
            z_decoupled = (hm[2, 0] == 0 and hm[2, 1] == 0
                           and hm[0, 2] == 0 and hm[1, 2] == 0)
            if any(g.type in ("SHEAR", "SHWALL") for g in sd.groups) \
                    and not z_decoupled:
                # the shear slabs live in Cartesian z; an xy-tilted box
                # keeps z exact, a z-coupled tilt does not (shear.c
                # assumes slab normals along z)
                raise NotImplementedError(
                    "SHEAR/SHWALL need the c lattice vector along z "
                    "(xy tilt is fine; z-coupled tilt is not)")
        self.engine = engine
        self.n_rollbacks = 0     # non-finite chunks rolled back
        # dynamic boxes (barostats / prescribed box(t)) plan the cell grid
        # with shrink headroom so compression doesn't trip the cell-edge
        # guard (and a 16s replan-recompile) right away
        ip0 = sd.integrator_parms
        dyn_box = (sd.box_time is not None
                   or sd.integrator_type in ("NPTGLF", "NGLFNK")
                   or ip0.get("beta", 0.0) > 0)
        self._plan_margin = 1.08 if dyn_box else 1.0
        self._dyn_box = dyn_box
        self.grid = self._plan(sd.box, sd.state.n_local)
        self.force_fn = self._build_force_fn()
        self.printinfo = PrintInfo.from_deck(db, sd.cfg.printinfo_name)

        sysobj = db.get(sd.cfg.system_name, "SYSTEM")
        self.molecules = build_molecule_class(
            db, sysobj, sd.collection.species_names, sd.collection.gid)
        mol_virial_fn = make_molecular_virial_fn(self.molecules, dtype=dtype)
        self.n_molecules = self.molecules.n_molecules if self.molecules else sd.state.n_local

        # integrator
        ip = sd.integrator_parms
        barostat = None
        if sd.integrator_type in ("NGLFCONSTRAINT", "NGLFCONSTRAINTGPU",
                                  "NGLFCONSTRAINTGPULANGEVIN", "NGLFGPU",
                                  "NGLFGPULANGEVIN", "NGLFNEW") and ip["beta"] > 0:
            barostat = dict(P0=ip["P0"], beta=ip["beta"], tau=ip["tauBarostat"],
                            T=ip["T"], isotropic=ip["isotropic"],
                            n_molecules=self.n_molecules)
        self.coeffs = sd.group_table.coefficients(sd.cfg.time, 0.5 * sd.cfg.dt,
                                                  dtype=dtype)
        # groups with RAMP/STEP/EXP/COS Teq need fresh coefficients each chunk
        from ..objects.eq import EqTarget

        def _td(g):
            if isinstance(g.Teq, EqTarget) and g.Teq.kind != "CONSTANT":
                return True
            vz = g.parms.get("vzeq")
            return isinstance(vz, EqTarget) and vz.kind != "CONSTANT"

        self._time_dependent_groups = any(_td(g) for g in sd.groups)
        # energy-feedback thermostat targets (Teq_dynamics=GLOBAL_ENERGY,
        # langevin.c:31-51): live Teq recomputed from the last chunk's
        # potential energy at every coefficient refresh
        self._ge_groups = {g.index: g for g in sd.group_table.groups
                           if g.parms.get("teq_dynamics") == "GLOBAL_ENERGY"}
        self._ge_total = {}
        if self._ge_groups:
            self._time_dependent_groups = True
        self._barostat = barostat
        self._mol_virial_fn = mol_virial_fn
        self._rebuild_step_fn()

        # rate-driven analyses/transforms (masters.c:295-302, transform.c:153)
        self.analyses = []
        simobj = db.by_class("SIMULATE")[0]
        for aname in simobj.get_strv("analysis"):
            aobj = db.find(aname, "ANALYSIS")
            if aobj is not None:
                from ..analysis.registry import build_analysis

                try:
                    self.analyses.append(build_analysis(aname, aobj))
                except Exception as err:  # keep decks loading (subsetWrite etc pending)
                    import warnings

                    warnings.warn(f"analysis {aname}: {err}")
        # printStress=1 in PRINTINFO auto-attaches the stress writer
        # (printinfoAll, /root/reference/src/printinfo.c:241-260)
        if self.printinfo.print_stress:
            from ..analysis.registry import StressWrite
            from ..objects.parser import DeckObject

            sw = StressWrite(name="printStress",
                             obj=DeckObject("printStress", "ANALYSIS",
                                            {"type": ["STRESSWRITE"]}),
                             eval_rate=sd.cfg.printrate or 1,
                             output_rate=sd.cfg.printrate or 1)
            sw.setup()
            self.analyses.append(sw)
        self.transforms = []
        for tname in simobj.get_strv("transform"):
            tobj = db.find(tname, "TRANSFORM")
            if tobj is not None:
                self.transforms.append((tname, tobj, tobj.get_int("rate", 0)))

        self.key = jax.random.PRNGKey(sd.random_seed)
        robj = db.find(db.get(sd.cfg.system_name, "SYSTEM")
                       .get_str("random", "random"), "RANDOM")
        if robj is not None and robj.has("keyData"):
            # restart continuity (written by io.restart.write_checkpoint)
            kd = [int(x) for x in robj.get_strv("keyData")]
            self.key = jnp.asarray(kd[:2], dtype=jnp.uint32)
        zeta0 = sd.integrator_parms["zeta"] if sd.integrator_type == "NPTGLF" else 0.0
        bdot0 = np.zeros(3)
        if sd.integrator_type == "NGLFNK":
            iobj = db.get(sd.cfg.integrator_name, "INTEGRATOR")
            bdot0 = np.asarray(iobj.get_with_unitsv("bdot", "0 0 0", "l/t"))
        self.ss = StepState(
            state=sd.state, box=sd.box, energy=EnergyInfo.zero(dtype),
            loop=jnp.asarray(sd.cfg.loop, jnp.int32),
            time=jnp.asarray(sd.cfg.time, dtype),
            zeta=jnp.asarray(zeta0, dtype),
            bdot=jnp.asarray(bdot0, dtype),
        )

        self._compile()

    # ------------------------------------------------------------------

    def _plan(self, box, n: int, margin: float | None = None, prev=None):
        """Cell plan of the current engine for `box` and n particles
        (prev: the nlist grid whose neighbor capacities carry over)."""
        sd = self.sysdef
        margin = self._plan_margin if margin is None else margin
        geom = np.asarray(box.lengths if box.ortho else box.h,
                          dtype=np.float64)
        if self.engine == "cellblock":
            from ..ops.cellpair import CellBlockGrid

            return CellBlockGrid.plan(geom, sd.rcut_max, sd.neighbor_deltaR,
                                      n, plan_margin=margin)
        if prev is None:
            return plan_grid(sd, plan_margin=margin)
        from ..nbr.celllist import CellGrid

        return CellGrid.plan(np.asarray(box.lengths, dtype=np.float64),
                             sd.rcut_max, sd.neighbor_deltaR, n,
                             sd.state.n_pad,
                             max_neighbors=prev.max_neighbors,
                             plan_margin=margin)

    def _build_force_fn(self):
        return build_force_fn(self.sysdef, dtype=self.dtype,
                              engine=self.engine, grid=self.grid,
                              interpret=self._interpret)

    def _ge_teq_override(self):
        """Live Teq per GLOBAL_ENERGY Langevin group: pins the conserved
        bath+system energy at the first real potential energy, then
        Teq = (total - E)/(Cp N) (langevin_getTemperature,
        /root/reference/src/langevin.c:31-51)."""
        if not self._ge_groups:
            return None
        e = float(self.ss.energy.eion)
        if not np.isfinite(e):
            return None
        ng = self.sysdef.state.n_local
        out = {}
        for i, g in self._ge_groups.items():
            cp_n = g.parms["Cp"] * ng
            if i not in self._ge_total:
                self._ge_total[i] = float(g.Teq(0.0)) * cp_n + e
            out[i] = (self._ge_total[i] - e) / cp_n
        return out

    def _rebuild_step_fn(self):
        sd = self.sysdef
        constraint_fn = None
        # NGLFNEW = the constraint integrator re-plumbed (nglfNew.c);
        # same step semantics here
        uses_constraints = ("CONSTRAINT" in sd.integrator_type
                            or "RATTLE" in sd.integrator_type
                            or sd.integrator_type == "NGLFNEW")
        if (sd.bonded is not None and sd.bonded.n_constraints > 0
                and uses_constraints):
            from ..integrators.constraints import (build_constraint_fn,
                                                   build_constraint_fn_batched)

            # residue-template batched single-bond RATTLE when the
            # topology is template-regular (every Martini deck);
            # DDCMD_CONS_BATCH=0 opts back into the generic projector
            constraint_fn = None
            if (sd.box.ortho
                    and os.environ.get("DDCMD_CONS_BATCH", "1") != "0"):
                constraint_fn = build_constraint_fn_batched(
                    sd.bonded.cons_atoms, sd.bonded.cons_pairs,
                    sd.bonded.cons_dist, sd.state.n_pad, self.dtype,
                    sd.residue_instances,
                    box_lengths=np.asarray(sd.box.lengths,
                                           dtype=np.float64))
            if constraint_fn is None:
                constraint_fn = build_constraint_fn(
                    sd.bonded.cons_atoms, sd.bonded.cons_pairs,
                    sd.bonded.cons_dist, sd.state.n_pad, self.dtype,
                    box_lengths=np.asarray(sd.box.lengths, dtype=np.float64))
        self.constraint_fn = constraint_fn
        wrap = self.engine != "cellblock"
        itype = sd.integrator_type
        if itype == "NPTGLF":
            from ..integrators.nptglf import make_nptglf_step

            ip = sd.integrator_parms
            npt_step = make_nptglf_step(
                self.force_fn, self.coeffs, sd.cfg.dt,
                n_global=sd.state.n_local, Gamma=ip["Gamma"],
                Peq=ip["pressure"], n_constraints=sd.n_constraints,
                wrap_positions=wrap)

            def step_fn(ss, nbr_idx, key, coeffs=None, box_lam=None):
                return npt_step(ss, nbr_idx, key, coeffs)

            self.step_fn = step_fn
            return
        if itype == "NGLFNK":
            from ..objects import units as U
            from ..integrators.nglfnk import make_nglfnk_step

            ip = sd.integrator_parms
            h_frac = None
            if not sd.box.ortho:
                # fixed-shape triclinic piston: factor h0 = h_frac diag(L0)
                # with unit-length lattice vectors so L are the per-axis
                # lattice lengths (nglfNK.c per-axis dynamics, de-tilted)
                h0 = np.asarray(sd.box.h, dtype=np.float64)
                h_frac = h0 / np.linalg.norm(h0, axis=0)[None, :]
            self.step_fn = make_nglfnk_step(
                self.force_fn, sd.cfg.dt, T=ip["T"], tau=ip["tau"],
                Peq=ip["P"], W=ip["W"], kB=U.kB, wrap_positions=wrap,
                h_frac=h_frac)
            return
        if itype in ("NVEGLF", "NVEGLF_SIMPLE"):
            # NVE variants ignore thermostats: plain leapfrog kicks
            # (/root/reference/src/nveglf.c)
            a, c_on, noise, vcm, kind, ber = self.coeffs
            self.coeffs = (jnp.ones_like(a), jnp.ones_like(c_on),
                           jnp.zeros_like(noise), jnp.zeros_like(vcm),
                           jnp.zeros_like(kind), jnp.zeros_like(ber))
            self._time_dependent_groups = False
        post_drift_fn = None
        if any(p[0] == "REFLECT" for p in sd.potentials):
            from ..potentials.reflect import make_reflect_fn

            post_drift_fn = make_reflect_fn(self.dtype)
        self.step_fn = make_nglf_step(
            self.force_fn, self.coeffs, sd.cfg.dt,
            barostat=self._barostat, n_global=sd.state.n_local,
            n_constraints=sd.n_constraints,
            molecular_virial_fn=self._mol_virial_fn,
            constraint_fn=constraint_fn,
            wrap_positions=wrap,
            post_drift_fn=post_drift_fn,
            has_berendsen=any(g.type == "BERENDSEN" for g in sd.groups),
            shear_groups=sd.group_table.shear_groups,
            has_box_time=sd.box_time is not None)

    def _compile(self):
        grid = self.grid
        step_fn = self.step_fn
        force_fn = self.force_fn

        # a shrinking box (barostat / prescribed box(t)) can drop the
        # LIVE cell edge below rlist while ncells stays static, silently
        # missing one-shell pairs; flag it as overflow so the host
        # replans (same hazard brickstep.py guards via cell_ok)
        ncells_v = np.asarray(grid.ncells, dtype=np.float64)

        def cell_edge_bad(box):
            spans = box.perp_spans
            return jnp.any(spans / jnp.asarray(ncells_v, spans.dtype)
                           < jnp.asarray(grid.rlist, spans.dtype))

        if self.engine == "cellblock":
            from ..ops.cellpair import build_cell_slots

            def build_nbr(ss):
                # wrap at rebuild; steps between rebuilds leave positions
                # unwrapped so the cell-block image shifts stay exact
                r = ss.box.back_in_box(ss.state.r)
                ss = ss.replace(state=ss.state.replace(r=r))
                geom = ss.box.lengths if ss.box.ortho else ss.box.h
                perm, overflow = build_cell_slots(
                    r, ss.state.fmask, geom, grid)
                return ss, perm, overflow | cell_edge_bad(ss.box)
        else:
            pbc_bits = int(self.sysdef.box.pbc)

            def build_nbr(ss):
                geom = ss.box.lengths if ss.box.ortho else ss.box.h
                nbr_idx, _, overflow = build_neighbor_list(
                    ss.state.r, ss.state.fmask, geom, grid, pbc=pbc_bits)
                return ss, nbr_idx, overflow | cell_edge_bad(ss.box)

        deltaR2 = float(self.sysdef.neighbor_deltaR) ** 2
        deltaR = float(self.sysdef.neighbor_deltaR)

        def superchunk(ss, key, coeffs, box_lam, n_rebuilds,
                       steps_per_rebuild):
            """ONE dispatch per n_rebuilds*steps_per_rebuild MD steps with
            DISPLACEMENT-TRIGGERED on-device rebuilds: after each step the
            verlet-skin criterion 2*max|dr| >= deltaR (neighborCheck,
            /root/reference/src/neighbor.c:117-199) decides via lax.cond
            whether to rebuild before the next step -- no fixed cadence,
            no host round trip, no stale-list physics.  Overflow flags
            are OR-reduced and checked on the host after the fact."""
            n_steps = n_rebuilds * steps_per_rebuild
            ss, nbr_idx, overflow = build_nbr(ss)
            r0 = ss.state.r
            h0 = ss.box.h

            def live(carry, i):
                ss, nbr_idx, r0, h0, ov = carry
                ss = step_fn(ss, nbr_idx, jax.random.fold_in(key, i), coeffs,
                             box_lam)
                dr = ss.box.min_image(ss.state.r - r0)
                md2 = jnp.max(jnp.sum(dr * dr, axis=-1) * ss.state.fmask)
                # Staleness budget: per-particle drift PLUS box motion.
                # Positions are wrapped for the box AT REBUILD TIME; a
                # barostat (or prescribed h(t)) changing h between
                # rebuilds puts boundary-wrapped particles outside the
                # live box, so the static cell-image geometry degrades by
                # ~|dh| per axis even while every |dr| stays tiny.  Left
                # unchecked this is a runaway: missing boundary pairs ->
                # more negative virial -> Berendsen compresses harder
                # (observed collapsing an NPT bilayer 218->180 nm^3 inside
                # one 492-step chunk).  For static boxes dh == 0 and this
                # reduces exactly to the original 4*md2 >= deltaR2 test.
                dh = jnp.max(jnp.abs(ss.box.h - h0))
                stale = 2.0 * jnp.sqrt(md2) + 4.0 * dh >= deltaR

                def do_rebuild(s):
                    s2, nb2, ov2 = build_nbr(s)
                    return s2, nb2, s2.state.r, s2.box.h, ov2

                def keep(s):
                    return s, nbr_idx, r0, h0, jnp.asarray(False)

                ss, nbr_idx, r0, h0, ov_i = jax.lax.cond(stale, do_rebuild,
                                                         keep, ss)
                return (ss, nbr_idx, r0, h0, ov | ov_i)

            def body(carry, i):
                # FREEZE once the overflow flag is set: an overflowed
                # rebuild has silently DROPPED atoms (build_cell_slots
                # mode="drop"), so every further step would integrate
                # wrong forces -- observed as an NPT-compression blowup
                # (bilayer: caps planned at start density, volume -10%
                # inside one 800-step chunk, kinetic energy 1e22 by step
                # ~100).  Freezing pins the chunk at the overflow point;
                # the host sees overflow=True, rolls back, replans at the
                # live box (replan-first ladder) and re-runs the chunk --
                # no corrupted physics ever escapes a dispatch.
                out = jax.lax.cond(carry[4], lambda c: c,
                                   lambda c: live(c, i), carry)
                ss = out[0]
                e = ss.energy
                # columns 11-12: kinetic-blowup forensics -- the hottest
                # particle and its row (a runaway injects velocity into
                # ONE atom first; the id names the species/molecule role
                # before the kill switch fires)
                v2 = jnp.sum(ss.state.v * ss.state.v, axis=-1) \
                    * ss.state.fmask
                scal = jnp.stack([
                    e.eion, e.rk,
                    jnp.trace(e.virial), ss.box.volume,
                    ss.box.lengths[0], ss.box.lengths[1], ss.box.lengths[2],
                    e.virial[0, 0], e.virial[1, 1], e.virial[2, 2],
                    jnp.trace(e.tion),
                    jnp.max(v2), jnp.argmax(v2).astype(ss.state.r.dtype),
                ])
                return out, scal

            (ss, _, _, _, overflow), scal = jax.lax.scan(
                body, (ss, nbr_idx, r0, h0, overflow), jnp.arange(n_steps))
            # adaptive mode satisfies the skin criterion by construction:
            # report zero so the host cadence guard stays quiet
            return ss, scal, overflow, jnp.zeros(())

        def _scal_row(ss):
            e = ss.energy
            v2 = jnp.sum(ss.state.v * ss.state.v, axis=-1) * ss.state.fmask
            return jnp.stack([
                e.eion, e.rk,
                jnp.trace(e.virial), ss.box.volume,
                ss.box.lengths[0], ss.box.lengths[1], ss.box.lengths[2],
                e.virial[0, 0], e.virial[1, 1], e.virial[2, 2],
                jnp.trace(e.tion),
                jnp.max(v2), jnp.argmax(v2).astype(ss.state.r.dtype),
            ])

        def superchunk_fixed(ss, key, coeffs, box_lam, n_rebuilds,
                             steps_per_rebuild):
            """Fixed-cadence variant (DDCMD_FIXED_REBUILD=1): rebuild
            every steps_per_rebuild steps with NO per-step lax.cond and
            NO freeze wrapper (the two conds are a measurable share of
            the bilayer step in an in-context ablation).  Correctness is preserved by CHECK instead
            of trigger: the per-step skin criterion (drift + box motion,
            same budget as the adaptive mode) is max-reduced and
            returned as max_disp2' = (max|dr| + 2 max|dh|)^2; the host's
            existing staleness guard then halves the cadence
            (_forced_spr) and REDOES the chunk from the intact pre-chunk
            state with the SAME noise substream (_redo_sub), and the
            rollback ladder redoes overflowed chunks -- wrong physics
            never escapes a dispatch, it just costs a redo instead of an
            in-chunk freeze."""
            spr = steps_per_rebuild

            def block(carry, j):
                ss, ov, worst = carry
                ss, nbr_idx, ov_b = build_nbr(ss)
                r0 = ss.state.r
                h0 = ss.box.h

                def inner(c, i):
                    ss, w = c
                    ss = step_fn(ss, nbr_idx,
                                 jax.random.fold_in(key, j * spr + i),
                                 coeffs, box_lam)
                    dr = ss.box.min_image(ss.state.r - r0)
                    md2 = jnp.max(jnp.sum(dr * dr, axis=-1)
                                  * ss.state.fmask)
                    dh = jnp.max(jnp.abs(ss.box.h - h0))
                    # staleness only matters if MORE steps use this list
                    eff = jnp.where(i < spr - 1,
                                    jnp.sqrt(md2) + 2.0 * dh, 0.0)
                    return (ss, jnp.maximum(w, eff)), _scal_row(ss)

                (ss, w), scal = jax.lax.scan(
                    inner, (ss, jnp.zeros((), ss.state.r.dtype)),
                    jnp.arange(spr))
                return (ss, ov | ov_b, jnp.maximum(worst, w)), scal

            (ss, overflow, worst), scal = jax.lax.scan(
                block, (ss, jnp.zeros((), jnp.bool_),
                        jnp.zeros((), ss.state.r.dtype)),
                jnp.arange(n_rebuilds))
            return (ss, scal.reshape(-1, scal.shape[-1]), overflow,
                    worst * worst)

        def first(ss):
            ss, handle, ov = build_nbr(ss)
            return first_energy_call(ss, force_fn, handle), ov

        if os.environ.get("DDCMD_FIXED_REBUILD", "0") == "1":
            self._chunk_jit = jax.jit(superchunk_fixed,
                                      static_argnums=(4, 5))
        else:
            self._chunk_jit = jax.jit(superchunk, static_argnums=(4, 5))
        self._first_jit = jax.jit(first)
        self._build_nbr_jit = jax.jit(build_nbr)

    def _grid_stale(self, slack: float = 1.0) -> bool:
        """True when the LIVE box has shrunk a cell edge below slack*rlist
        (static ncells vs barostat/prescribed-box compression) -- growing
        capacity cannot fix that; the cell plan itself must change.
        slack > 1 also catches compression that happened INSIDE the chunk
        that just overflowed (self.ss is the pre-chunk state)."""
        spans = np.asarray(self.ss.box.perp_spans, dtype=np.float64)
        ncells = np.asarray(self.grid.ncells, dtype=np.float64)
        return bool(np.any(spans / ncells < self.grid.rlist * slack))

    def replan_grid(self):
        """Re-plan the cell grid against the LIVE box (NPT compression
        dropped a cell edge below rlist; fewer, larger cells restore the
        one-shell stencil guarantee)."""
        sd = self.sysdef
        box = self.ss.box
        prev = self.grid
        self.grid = self._plan(box, sd.state.n_local, prev=prev)
        # never shrink capacity on a replan: the retry loop alternates
        # replan_grid/recapacity, and a fresh density-based plan that
        # resets a previously-grown cap would make the two undo each
        # other forever (overflow persisting through all retry rounds)
        if hasattr(prev, "cap") and self.grid.cap < prev.cap:
            self.grid = self.grid.with_cap(prev.cap)
        if (hasattr(prev, "cell_capacity")
                and self.grid.cell_capacity < prev.cell_capacity):
            self.grid = dataclasses.replace(
                self.grid, cell_capacity=prev.cell_capacity)
        self.force_fn = self._build_force_fn()
        self._rebuild_step_fn()
        self._compile()

    def recapacity(self, factor: float = 1.5):
        """Grow neighbor capacity after an overflow (allocPages analog)."""
        g = self.grid
        if self.engine == "cellblock":
            self.grid = g.with_cap(int(g.cap * factor))
            self.force_fn = self._build_force_fn()
            self._rebuild_step_fn()
        else:
            self.grid = dataclasses.replace(
                g,
                cell_capacity=((int(g.cell_capacity * factor) + 7) // 8) * 8,
                max_neighbors=((int(g.max_neighbors * factor) + 127) // 128) * 128,
            )
        self._compile()

    # ------------------------------------------------------------------

    def first_energy(self):
        # the initial plan's occupancy heuristic can undersize cells for
        # clustered configurations (a solvated molecule in a mostly-empty
        # box): a silent overflow here would return energies from a
        # dropped-pair list, so check the flag and recapacity/replan like
        # the run loop does
        for _ in range(10):     # 1.5^9 ~ 38x growth headroom
            ss, ov = self._first_jit(self.ss)
            if not bool(ov):
                self.ss = ss
                return ss
            if self._grid_stale():
                self.replan_grid()
            else:
                self.recapacity()
        raise RuntimeError(
            "neighbor overflow persists in first_energy after repeated "
            "recapacity/replan")

    def profile_phases(self, n_iter: int = 10, detail: bool = False) -> dict:
        """Per-phase time attribution (the ptiming.h per-phase timers,
        /root/reference/src/ptiming.h:10-36, profile.c:468).

        XLA fuses the whole MD step into one dispatch, so the production
        path cannot be split by host timers without destroying fusion.
        Instead, ON DEMAND (snapshot cadence with DDCMD_PROFILE_PHASES=1,
        or the `profile` runtime command) each phase runs as its OWN
        jitted dispatch -- neighbor rebuild, nonbond+bonded force eval,
        group kick, and the fused step for comparison -- timed with
        block_until_ready over n_iter reps.  Results land in the PROFILE
        table as phase.* timers (us/step = avg(ms)*1000); production
        steps pay zero overhead.
        """
        import jax

        from ..core.groups import velocity_update
        from ..utils.profile import PROFILE

        ss = self.ss
        grid = self.grid

        if self.engine == "cellblock":
            from ..ops.cellpair import build_cell_slots

            def rebuild(ss):
                r = ss.box.back_in_box(ss.state.r)
                geom = ss.box.lengths if ss.box.ortho else ss.box.h
                return build_cell_slots(r, ss.state.fmask, geom, grid)[0]
        else:
            def rebuild(ss):
                geom = ss.box.lengths if ss.box.ortho else ss.box.h
                return build_neighbor_list(ss.state.r, ss.state.fmask,
                                           geom, grid)[0]

        rebuild_j = jax.jit(rebuild)
        force_j = jax.jit(lambda ss, nbr: self.force_fn(ss.state, ss.box,
                                                        nbr)[0])
        half = 0.5 * self.sysdef.cfg.dt
        kick_j = jax.jit(lambda ss, f, key: velocity_update(
            "front", ss.state.v, f, ss.state.mass, ss.state.group,
            self.coeffs, half, key, ss.state.mask))
        key = jax.random.PRNGKey(0)
        step_j = jax.jit(lambda ss, nbr, key: self.step_fn(
            ss, nbr, key, self.coeffs))

        nbr = rebuild_j(ss)
        f = force_j(ss, nbr)
        phases = {
            "phase.nbr_rebuild": lambda: rebuild_j(ss),
            "phase.force": lambda: force_j(ss, nbr),
            "phase.group_kick": lambda: kick_j(ss, f, key),
            "phase.step_fused": lambda: step_j(ss, nbr, key),
        }
        if detail:
            # per-force-term + constraint attribution (ptiming.h's
            # per-object timers); each is ONE extra compile, so detail
            # mode is opt-in
            for term in getattr(self.force_fn, "terms", []):
                tname = term.__name__.replace("_term", "")
                term_j = jax.jit(
                    lambda ss, nbr, term=term: term(ss.state, ss.box, nbr)[0])
                phases[f"phase.term.{tname}"] = (
                    lambda ss=ss, nbr=nbr, term_j=term_j: term_j(ss, nbr))
            cfn = getattr(self, "constraint_fn", None)
            if cfn is not None:
                geom = ss.box.lengths
                cons_j = jax.jit(lambda ss: cfn(
                    ss.state, self.sysdef.cfg.dt, "front",
                    box_lengths=geom).v)
                phases["phase.constraint"] = lambda: cons_j(ss)
        out = {}
        errors = {}
        # a host-blocked dispatch adds its launch latency to every call:
        # queue n_iter async dispatches and block ONCE -- the device
        # stream executes in order, so readying the last output retires
        # them all and elapsed/n_iter is device time + one latency/n_iter.
        for name, fn in phases.items():
            try:
                jax.block_until_ready(fn())       # warmup/compile
            except Exception as err:              # e.g. step signature
                # a broken profiler must report failure, not silence
                errors[name] = f"{type(err).__name__}: {err}"
                import warnings

                warnings.warn(f"profile_phases: {name} failed ({err!r}); "
                              "phase skipped")
                continue
            t = PROFILE.timer(name)
            t.start()
            last = None
            for _ in range(n_iter):
                last = fn()
            jax.block_until_ready(last)
            t.stop()
            out[name] = t.total / max(n_iter, 1)
        # the RTT floor itself, for reading the table (per-call blocked
        # dispatch of a trivial program)
        import jax.numpy as _jnp

        tiny_j = jax.jit(lambda x: x + 1)
        jax.block_until_ready(tiny_j(_jnp.zeros((8, 128), self.dtype)))
        t0 = _time.perf_counter()
        for _ in range(5):
            jax.block_until_ready(tiny_j(_jnp.zeros((8, 128), self.dtype)))
        out["phase.rtt"] = (_time.perf_counter() - t0) / 5
        if errors:
            out["errors"] = errors
        return out

    def run_nextfile(self, print_fn=None):
        """NEXTFILE integrator: 'integrate' by loading successive snapshot
        files (replay; /root/reference/src/nextfile.c:34-63).  Each file is
        read, forces/energies evaluated once, and printinfo emitted."""
        iobj = self.db.get(self.sysdef.cfg.integrator_name, "INTEGRATOR")
        files = iobj.get_strv("files")
        from ..io.collection import read_collection

        for i, fpat in enumerate(files):
            col = read_collection(fpat, self._base_dir
                                  if hasattr(self, "_base_dir") else ".")
            n = min(col.n, self.sysdef.state.n_local)
            r = np.zeros((self.sysdef.state.n_pad, 3))
            v = np.zeros((self.sysdef.state.n_pad, 3))
            r[:n] = col.r[:n]
            v[:n] = col.v[:n]
            self.ss = self.ss.replace(
                state=self.ss.state.replace(
                    r=jnp.asarray(r, self.dtype), v=jnp.asarray(v, self.dtype)),
                loop=self.ss.loop + 1)
            self.first_energy()
            e = self.ss.energy
            line = (f"nextfile[{i}] {fpat}: eion="
                    f"{float(e.eion):.6f} rk={float(e.rk):.6f}")
            (print_fn or print)(line)
        return self.ss

    def run_nglftest(self, print_fn=None):
        """NGLFTEST / NGLFERROR integrator analogs
        (/root/reference/src/nglfTest.c:63-110, nglfError.c): integrate
        the same interval three ways -- one dt step ("single"), subDivide
        substeps ("multi"), and a fine high-accuracy reference -- and
        write per-particle position-error distributions to
        SingleStep.dist / MultiStep.dist.  Divergence from the reference:
        errors are absolute |r - r_ref| histograms (the reference
        normalizes by a half-step displacement)."""
        sd = self.sysdef
        iobj = self.db.get(sd.cfg.integrator_name, "INTEGRATOR")
        dt = sd.cfg.dt
        sub = iobj.get_int("subDivide", 4)
        # the reference deck keyword is (sic) highAccuarcyDt
        hi_dt = None
        for key in ("highAccuarcyDt", "highAccuracyDt"):
            if iobj.has(key):
                hi_dt = iobj.get_with_units(key, "0", "t")
        if not hi_dt:
            hi_dt = dt / 32.0
        n_hi = max(1, int(math.ceil(dt / hi_dt - 1e-9)))
        n = sd.state.n_local
        m = sd.state.mass[:, None]

        def substeps(ss, k, dtk):
            for _ in range(k):
                v1 = ss.state.v + 0.5 * dtk * ss.state.f / m
                r1 = ss.state.r + dtk * v1
                ss = ss.replace(state=ss.state.replace(r=r1, v=v1))
                ss, _ = self._first_jit(ss)    # rebuild + forces at r1
                v2 = ss.state.v + 0.5 * dtk * ss.state.f / m
                ss = ss.replace(state=ss.state.replace(v=v2))
            return ss

        self.first_energy()
        ss0 = self.ss
        r_single = np.asarray(substeps(ss0, 1, dt).state.r[:n])
        r_multi = np.asarray(substeps(ss0, sub, dt / sub).state.r[:n])
        r_ref = np.asarray(substeps(ss0, n_hi, dt / n_hi).state.r[:n])

        edges = np.logspace(-12, -2, 41)
        Lbox = np.asarray(ss0.box.lengths, dtype=np.float64)
        for name, rr in (("SingleStep.dist", r_single),
                         ("MultiStep.dist", r_multi)):
            # min-image: rebuilds wrap positions, so trajectories that
            # wrap on one path but not the other differ by a box vector
            d = rr - r_ref
            d = d - Lbox * np.round(d / Lbox)
            err = np.linalg.norm(d, axis=1)
            hist, _ = np.histogram(err, bins=edges)
            path = os.path.join(self.run_dir, name)
            with open(path, "w") as f:
                f.write("# |r - r_ref| (nm)   count   "
                        f"(dt={dt} ps, sub={sub}, ref {n_hi} substeps)\n")
                for c, h in zip(np.sqrt(edges[:-1] * edges[1:]), hist):
                    f.write(f"{c:.6e} {int(h)}\n")
            line = (f"{name}: median={np.median(err):.3e} "
                    f"max={err.max():.3e} nm")
            (print_fn or print)(line)
        return self.ss

    def run(self, n_loops: int | None = None, *, print_fn=None,
            on_checkpoint=None, max_seconds: float | None = None,
            max_steps_per_dispatch: int = 400):
        """Run the MD loop. Returns the final StepState.

        Dispatch granularity: ceil(k / updateRate) rebuild blocks per
        jitted call, where k is bounded by checkpoint cadence and
        max_steps_per_dispatch -- each dispatch pays a host round trip,
        so bigger is faster until compile time and print latency push
        back."""
        sd = self.sysdef
        cfg = sd.cfg
        if sd.integrator_type == "NEXTFILE":
            return self.run_nextfile(print_fn)
        if sd.integrator_type in ("NGLFTEST", "NGLFERROR"):
            return self.run_nglftest(print_fn)
        if n_loops is None:
            n_loops = (cfg.deltaloop if cfg.deltaloop
                       else cfg.maxloop - int(self.ss.loop))
        update_rate = max(1, cfg.ddc_update_rate)
        self.first_energy()

        # analyses/transforms need host callbacks at their rates
        for a in self.analyses:
            max_steps_per_dispatch = min(max_steps_per_dispatch, a.eval_rate)
        for _, _, rate in self.transforms:
            if rate:
                max_steps_per_dispatch = min(max_steps_per_dispatch, rate)

        done = 0
        retries = 0
        ov_retries = 0
        t0 = _time.monotonic()
        while done < n_loops:
            k = min(n_loops - done, max_steps_per_dispatch,
                    getattr(self, "_forced_dispatch", None) or 10 ** 9)
            if on_checkpoint and cfg.checkpointrate:
                loop_now = int(self.ss.loop)
                to_ckpt = cfg.checkpointrate - (loop_now % cfg.checkpointrate)
                k = min(k, to_ckpt)
            if on_checkpoint and cfg.snapshotrate:
                loop_now = int(self.ss.loop)
                k = min(k, cfg.snapshotrate - (loop_now % cfg.snapshotrate))
            eff_rate = min(update_rate,
                           getattr(self, "_forced_spr", None) or update_rate)
            if k >= eff_rate:
                spr = eff_rate
                n_rebuilds = k // eff_rate
            else:
                spr = k
                n_rebuilds = 1
            k = n_rebuilds * spr
            if getattr(self, "_redo_sub", None) is not None:
                # stale-chunk redo (fixed-cadence mode): reuse the SAME
                # noise substream so the redo at halved cadence replays
                # the identical thermostat noise per global step index
                # (fold_in(sub, j*spr+i) enumerates 0..k-1 for any spr)
                # -- the redo is deterministic and reproduces the
                # adaptive-mode trajectory instead of forking it
                sub = self._redo_sub
                self._redo_sub = None
            else:
                self.key, sub = jax.random.split(self.key)
            if self._time_dependent_groups:
                self.coeffs = self.sysdef.group_table.coefficients(
                    float(self.ss.time), 0.5 * cfg.dt, dtype=self.dtype,
                    teq_override=self._ge_teq_override())
            box_lam = self._box_lam(k)
            with PROFILE.phase("loop"):
                ss_new, scal, overflow, max_disp2 = self._chunk_jit(
                    self.ss, sub, self.coeffs, box_lam, n_rebuilds, spr)
                scal = np.asarray(scal, dtype=np.float64)  # device sync
            PROFILE.count("md_steps", k)
            if bool(overflow):
                # a transient density spike can overflow a cell once and
                # pass under fresh thermostat noise: retry the chunk ONCE
                # before replanning/recapacitating; deterministic NVE
                # overflows repeat and fall through
                ov_retries += 1
                self._clean_disp = 0
                if ov_retries <= 1:
                    continue
                if ov_retries > 8:
                    raise RuntimeError(
                        "neighbor overflow persists after repeated "
                        "recapacity/replan (loop "
                        f"{int(self.ss.loop)})")
                # _grid_stale sees the PRE-chunk box; in-chunk barostat
                # compression can trip cell_edge_bad while the pre-chunk
                # edge still clears rlist -- check with slack, and if
                # capacity growth isn't fixing it, replan cells anyway
                if self._dyn_box and spr > 100:
                    # a fast barostat compression can outrun one chunk:
                    # the replan below sees the PRE-chunk box (rollback
                    # point) and may reproduce the same plan that just
                    # overflowed mid-chunk.  Shorter dispatches let the
                    # ladder replan at a box closer to the live one (the
                    # overflow-freeze in superchunk already guarantees no
                    # corrupted steps escape either way).
                    self._forced_spr = max(100, spr // 2)
                if self._dyn_box and ov_retries >= 3:
                    # deterministic decks (no thermostat noise) replay
                    # the SAME mid-chunk box collapse on every retry;
                    # capacity growth cannot fix a cell edge dropping
                    # below rlist inside the dispatch.  Halve the
                    # DISPATCH so the host advances through intermediate
                    # boxes and replans along the compression (r4: the
                    # nx=4 bilayer NVE fixture crunches ~8% of the
                    # z-cell margin inside one 108-step dispatch)
                    self._forced_dispatch = max(eff_rate, k // 2)
                if self._grid_stale(slack=1.05) or ov_retries == 4:
                    # box compression, not density: replan cells once at
                    # retry 4 (capacities survive the replan); later
                    # retries keep GROWING capacity -- "always replan
                    # past 4" starved capacity growth and the ladder
                    # spun to the give-up limit (r4: nx=4 bilayer NVE)
                    self.replan_grid()
                else:
                    self.recapacity()
                continue  # redo this chunk with the new plan/capacity
            ov_retries = 0
            # decay the overflow-ladder clamps once dispatches run clean:
            # the NPT crunch that forced them settles, and a permanently
            # halved dispatch/spr pays the host round trip twice as often
            # for the rest of the run (mirrors the ov_retries reset)
            if (getattr(self, "_forced_dispatch", None) is not None
                    or getattr(self, "_forced_spr", None) is not None):
                self._clean_disp = getattr(self, "_clean_disp", 0) + 1
                if self._clean_disp >= 8:
                    self._clean_disp = 0
                    fd = getattr(self, "_forced_dispatch", None)
                    if fd is not None:
                        fd *= 2
                        self._forced_dispatch = (
                            None if fd >= max_steps_per_dispatch else fd)
                    fs = getattr(self, "_forced_spr", None)
                    if fs is not None:
                        fs *= 2
                        self._forced_spr = (
                            None if fs >= update_rate else fs)
            if not np.isfinite(scal[:, 0] + scal[:, 1]).all():
                # parity-style in-memory rollback (saveState/restoreState,
                # /root/reference/src/saveState.c:45,117; masters.c:461-466):
                # self.ss is still the pre-chunk state; redo with fresh noise
                retries += 1
                self.n_rollbacks += 1
                bad = int(np.argmax(~np.isfinite(scal[:, 0] + scal[:, 1])))
                loop0 = int(ss_new.loop) - k
                import warnings

                last_ok = scal[max(0, bad - 1)]
                hot = ""
                if scal.shape[1] > 12:
                    # trace the runaway back: first step whose hottest
                    # particle exceeded ~30x the thermal scale names the
                    # injection point and the atom row
                    v2_col = scal[:bad + 1, 11]
                    v2_ref = float(np.median(v2_col[:max(1, bad // 2)]))
                    hot_steps = np.nonzero(v2_col > 1e3 * max(v2_ref, 1e-12))[0]
                    j0 = int(hot_steps[0]) if len(hot_steps) else bad
                    hot = (f"; vmax2 {v2_col[max(0, j0 - 1)]:.3g}->"
                           f"{v2_col[j0]:.3g} at in-chunk step {j0}, "
                           f"atom row {int(scal[j0, 12])}")
                warnings.warn(
                    f"non-finite energy at step {loop0 + bad + 1} "
                    f"(chunk {loop0}+{k}, in-chunk index {bad}; last good "
                    f"row e={last_ok[0]:.4g} rk={last_ok[1]:.4g} "
                    f"vol={last_ok[3]:.4g}){hot}; rollback retry {retries}/3")
                if os.environ.get("DDCMD_BLOWUP_DUMP") \
                        and not getattr(self, "_blowup_dumped", False):
                    # forensic capture: pre-chunk checkpoint + the chunk
                    # noise key make the blowup EXACTLY replayable (noise
                    # is fold_in(key, step_index), so a shorter chunk
                    # with the same key reproduces the prefix bit-exact)
                    # -- scripts/forensic_blowup.py drives the replay
                    self._blowup_dumped = True
                    try:
                        from ..io.restart import write_checkpoint

                        snap = write_checkpoint(self, self.run_dir,
                                                update_symlink=False)
                        np.savez(os.environ["DDCMD_BLOWUP_DUMP"],
                                 key=np.asarray(sub), n_rebuilds=n_rebuilds,
                                 spr=spr, bad=bad,
                                 hot_step=int(j0 if hot else bad),
                                 hot_row=int(scal[j0, 12]) if hot else -1,
                                 snapdir=snap, vmax2=scal[:bad + 1, 11],
                                 vrow=scal[:bad + 1, 12])
                        print(f"blowup forensic dump: {snap} + "
                              f"{os.environ['DDCMD_BLOWUP_DUMP']}")
                    except Exception as err:
                        print(f"blowup dump failed: {err}")
                if retries > 3:
                    # forensic dump: the pre-chunk state reproduces the
                    # blowup in ~bad steps (write_checkpoint restores it)
                    try:
                        from ..io.restart import write_checkpoint

                        snap = write_checkpoint(self, self.run_dir,
                                                update_symlink=False)
                        print(f"kill-switch state dumped to {snap}")
                    except Exception as err:
                        print(f"kill-switch dump failed: {err}")
                    raise FloatingPointError(
                        f"non-finite energy at loop {int(ss_new.loop)} "
                        "(reference kill switch, masters.c:470-475)")
                continue
            retries = 0
            # verlet-skin staleness: 2*max|dr| (+ box-motion term, folded
            # into max_disp2 by the fixed-cadence chunk) must stay under
            # deltaR for every step that REUSED a list.  Adaptive chunks
            # rebuild in-scan and report 0 here; the fixed-cadence chunk
            # CHECKS instead of triggering, so a stale chunk is REDONE
            # from the intact pre-chunk self.ss at halved cadence (same
            # noise substream via _redo_sub) -- stale-list physics is
            # never accepted, it just costs a redo instead of an in-chunk
            # freeze.  spr==1 rebuilds before every step and cannot be
            # stale, so the ladder terminates.
            if 2.0 * math.sqrt(float(max_disp2)) >= self.sysdef.neighbor_deltaR \
                    and spr > 1:
                import warnings

                warnings.warn(
                    f"neighbor list went stale (2*max_disp="
                    f"{2 * math.sqrt(float(max_disp2)):.3f} nm >= deltaR="
                    f"{self.sysdef.neighbor_deltaR}); halving rebuild cadence "
                    "and redoing the chunk")
                self._forced_spr = max(1, spr // 2)
                self._redo_sub = sub
                continue
            self.ss = ss_new
            done += k
            with PROFILE.phase("printinfo"):
                self._emit_prints(scal, k, print_fn)
            if self.printinfo.print_graphs:
                self._emit_graphs(k)
            if len(self.sysdef.groups) > 1 and cfg.printrate \
                    and int(self.ss.loop) % cfg.printrate == 0:
                self._emit_group_files()
            loop_now = int(self.ss.loop)
            for a in self.analyses:
                if loop_now % a.eval_rate == 0:
                    a.eval(self)
                if a.output_rate and loop_now % a.output_rate == 0:
                    a.output(self, self.run_dir)
            for tname, tobj, rate in self.transforms:
                if rate and loop_now % rate == 0:
                    self.apply_transform(tobj)
            if on_checkpoint and cfg.checkpointrate and loop_now % cfg.checkpointrate == 0:
                on_checkpoint(self)
            if (cfg.snapshotrate and loop_now % cfg.snapshotrate == 0
                    and on_checkpoint is not None):
                from ..io.restart import write_snapshot

                write_snapshot(self, self.run_dir)
            if self._poll_commands(on_checkpoint):
                break
            if max_seconds is not None and _time.monotonic() - t0 > max_seconds:
                break
        for a in self.analyses:
            a.output(self, self.run_dir)
        return self.ss

    def _box_lam(self, n_steps: int):
        """Per-step box update (E, M) with h' = (E * h) @ M for the
        prescribed box(t) modes (boxPrescriptiveTime,
        /root/reference/src/boxPrescriptiveTime.c:96-145): STRAIN fills
        E elementwise (full 9-component dudt supported), DEFORMATION_RATE
        fills M = expm(D dt), VOLUME fills a diagonal E.  Constant across
        the dispatch; schedules refresh at dispatch granularity (exact at
        dispatch boundaries)."""
        bt = self.sysdef.box_time
        eye = np.eye(3)
        if bt is None:
            return (jnp.ones((3, 3), self.dtype),
                    jnp.asarray(eye, self.dtype))
        t = float(self.ss.time)
        dt = self.sysdef.cfg.dt
        S = max(1, n_steps)
        E = np.ones((3, 3))
        M = eye
        if bt["mode"] == "strain":
            E = np.array([[math.exp(eq.integral(t, t + S * dt) / S)
                           for eq in row] for row in bt["eqs"]])
        elif bt["mode"] == "deformation":
            D = np.asarray(bt["D"], dtype=np.float64) * dt
            M = eye.copy()
            term = eye.copy()
            for k in range(1, 24):                # expm series (exact to
                term = term @ D / k               # machine eps for D dt<<1)
                M = M + term
                if np.abs(term).max() < 1e-18:
                    break
        else:  # volume: hit n*Veq(t + S dt) exactly at the dispatch end
            v_now = float(self.ss.box.volume)
            v_tgt = self.sysdef.state.n_local * float(bt["eq"](t + S * dt))
            E = E * (v_tgt / v_now) ** (1.0 / (3.0 * S))
        return (jnp.asarray(E, self.dtype), jnp.asarray(M, self.dtype))

    def _emit_graphs(self, k):
        """Load-diagnostics file (graphWrite analog,
        /root/reference/src/graph.c:23-110): per-dispatch particle and
        pair-work statistics: for the cell engines the interesting
        numbers are the cell occupancy vs capacity (padded slots) and the
        pair-slot count the dense engine actually sweeps."""
        g = self.grid
        n = self.sysdef.state.n_local
        if hasattr(g, "cap"):       # cell-block engine
            pair_slots = g.ncell * getattr(g, "n_stencil", 27) * g.cap * g.cap
            line = (f"{int(self.ss.loop):10d} {float(self.ss.time):12.6f} "
                    f"nlocal={n} ncell={g.ncell} cap={g.cap} "
                    f"pair_slots={pair_slots} steps={k}")
        else:
            line = (f"{int(self.ss.loop):10d} {float(self.ss.time):12.6f} "
                    f"nlocal={n} steps={k}")
        with open(os.path.join(self.run_dir, "graphs"), "a") as f:
            f.write(line + "\n")

    def _emit_group_files(self):
        """Per-group temperature/KE files (printinfo.c:261-279), written
        at chunk boundaries from the resident state."""
        sd = self.sysdef
        n = sd.state.n_local
        st = self.ss.state
        v = np.asarray(st.v[:n])
        m = np.asarray(st.mass[:n])
        pe = np.asarray(st.pe[:n])
        gids = np.asarray(st.group[:n])
        loop = int(self.ss.loop)
        for g in sd.groups:
            sel = gids == g.index
            cnt = int(sel.sum())
            if cnt == 0:
                continue
            ke = 0.5 * (m[sel, None] * v[sel] ** 2).sum()
            T = 2.0 * ke / (3.0 * cnt * U.kB)
            with open(os.path.join(self.run_dir, f"group_{g.name}.data"), "a") as f:
                f.write(f"{loop:12d} {cnt:10d} {T:14.4f} {ke / cnt:16.8f} "
                        f"{pe[sel].sum() / cnt:16.8f}\n")

    # ------------------------------------------------------------------

    def apply_transform(self, tobj):
        """Host-side state surgery + re-upload (transform.c:153-181)."""
        from ..transforms.registry import TransformContext, apply_transform

        sd = self.sysdef
        n = sd.state.n_local
        st = self.ss.state
        ctx = TransformContext(
            r=np.asarray(st.r[:n], dtype=np.float64).copy(),
            v=np.asarray(st.v[:n], dtype=np.float64).copy(),
            gid=sd.collection.gid.copy(),
            mass=np.asarray(st.mass[:n], dtype=np.float64),
            species_names=list(sd.collection.species_names),
            group_names=list(sd.collection.group_names),
            h=np.asarray(self.ss.box.h, dtype=np.float64).copy(),
        )
        # extras used by SHOCK / CUSTOM (time bookkeeping, file output)
        ctx.time = float(self.ss.time)
        ctx.dt = sd.cfg.dt
        ctx.rate = next((rate for _, t, rate in self.transforms
                         if t is tobj), 1)
        ctx.run_dir = self.run_dir
        ctx.base_dir = self._base_dir
        apply_transform(ctx, tobj)
        from ..core.box import Box

        new_box = Box.from_h(ctx.h, pbc=self.ss.box.pbc, dtype=self.dtype)
        n_new = len(ctx.gid)
        if (n_new == n
                and ctx.species_names == sd.collection.species_names):
            # fast path: same particles, positions/velocities updated
            n_pad = st.n_pad
            r = np.zeros((n_pad, 3))
            v = np.zeros((n_pad, 3))
            r[:n] = ctx.r
            v[:n] = ctx.v
            self.ss = self.ss.replace(
                state=st.replace(r=jnp.asarray(r, self.dtype),
                                 v=jnp.asarray(v, self.dtype)),
                box=new_box)
            sd.collection.gid = ctx.gid
            sd.collection.group_names = ctx.group_names
        else:
            # particle count / species changed: rebuild the State
            from ..core.state import State

            sp_index = {s.name: s.index for s in sd.species}
            grp_index = {g.name: g.index for g in sd.groups}
            sidx = np.array([sp_index[s] for s in ctx.species_names], dtype=np.int32)
            gidx = np.array([grp_index.get(g, 0) for g in ctx.group_names], dtype=np.int32)
            mass = np.array([sd.species[i].mass for i in sidx])
            charge = np.array([sd.species[i].charge for i in sidx])
            new_state = State.create(ctx.r, ctx.v, charge, mass, sidx, gidx,
                                     ctx.gid, dtype=self.dtype)
            sd.state = new_state
            sd.collection.gid = ctx.gid
            sd.collection.species_names = ctx.species_names
            sd.collection.group_names = ctx.group_names
            sd.collection.class_names = (
                sd.collection.class_names * (n_new // max(n, 1) + 1))[:n_new]
            sd.collection.r = ctx.r
            sd.collection.v = ctx.v
            self.ss = self.ss.replace(state=new_state, box=new_box)
            # grids/force tables depend on n and box: rebuild everything
            self.grid = self._plan(new_box, n_new, margin=1.0)
            self.force_fn = self._build_force_fn()
            self._rebuild_step_fn()
            self._compile()
        self.first_energy()

    def _rescan_objects(self):
        """Re-derive live parameters from the re-compiled object DB --
        the full reach of the reference's object_rescan (readCmds.c:66-97):
        a mid-run ddcMD_CMDS can replace ANY object's text.

        * SIMULATE rates -> cfg fields (no recompile)
        * GROUP targets (Teq/vzeq ramps, Langevin tau...) -> the group
          kick coefficients are a RUNTIME arg of the jitted chunk
          (core/groups.py affine form), so a new Teq moves the compiled
          step immediately, no recompile
        * INTEGRATOR parameters (P0/beta/tau/T barostat targets) -> baked
          into the step closure; when they change, rebuild + recompile
          the step (explicit user command, one-time cost)
        * ANALYSIS / TRANSFORM rates -> host-side ints
        """
        sd = self.sysdef
        cfg = sd.cfg
        sim = self.db.by_class("SIMULATE")[0]
        cfg.printrate = sim.get_int("printrate", cfg.printrate)
        cfg.checkpointrate = sim.get_int("checkpointrate", cfg.checkpointrate)
        cfg.snapshotrate = sim.get_int("snapshotrate", cfg.snapshotrate)
        cfg.maxloop = sim.get_int("maxloop", cfg.maxloop)

        # groups: rebuild table + runtime coefficients from updated text
        from ..core.groups import GroupTable, group_from_deck
        from ..objects.eq import EqTarget

        groups = [group_from_deck(self.db, g.name, i)
                  for i, g in enumerate(sd.groups)]
        sd.groups = groups
        sd.group_table = GroupTable.build(groups)
        self.coeffs = sd.group_table.coefficients(
            float(self.ss.time), 0.5 * cfg.dt, dtype=self.dtype)

        def _td(g):
            if isinstance(g.Teq, EqTarget) and g.Teq.kind != "CONSTANT":
                return True
            vz = g.parms.get("vzeq")
            return isinstance(vz, EqTarget) and vz.kind != "CONSTANT"

        self._time_dependent_groups = any(_td(g) for g in groups)

        # integrator/barostat: recompile the step only if values moved
        from ..core.system import integrator_parms_from_deck

        itype, iparms = integrator_parms_from_deck(self.db,
                                                   cfg.integrator_name)
        if itype == sd.integrator_type and iparms != sd.integrator_parms:
            sd.integrator_parms = iparms
            if self._barostat is not None and iparms["beta"] > 0:
                self._barostat = dict(
                    P0=iparms["P0"], beta=iparms["beta"],
                    tau=iparms["tauBarostat"], T=iparms["T"],
                    isotropic=iparms["isotropic"],
                    n_molecules=self.n_molecules)
            self._rebuild_step_fn()
            self._compile()

        # analysis / transform rates (atRateTransforms, transform.c:153)
        for a in self.analyses:
            aobj = self.db.find(a.name, "ANALYSIS")
            if aobj is not None:
                a.eval_rate = aobj.get_int("eval_rate",
                                           aobj.get_int("evalrate",
                                                        a.eval_rate))
                a.output_rate = aobj.get_int("outputrate", a.output_rate)
        self.transforms = [
            (tname, self.db.find(tname, "TRANSFORM") or tobj,
             (self.db.find(tname, "TRANSFORM") or tobj).get_int("rate", rate))
            for tname, tobj, rate in self.transforms]

    def _poll_commands(self, on_checkpoint) -> bool:
        """Runtime command file (readCMDS, /root/reference/src/readCmds.c:20-58):
        ./ddcMD_CMDS may contain checkpoint / exit / kill / stop."""
        path = os.path.join(self.run_dir, "ddcMD_CMDS")
        if not os.path.exists(path):
            return False
        try:
            raw = open(path).read()
        except OSError:
            return False
        os.remove(path)
        text = raw.lower()           # command keywords are case-insensitive;
        stop = False                 # object TEXT must keep its case
        if "{" in raw:
            # live re-config: compile object text + rescan EVERYTHING the
            # text can reach -- rates, group targets, integrator/barostat
            # parameters, analysis/transform rates (object_rescan,
            # readCmds.c:66-97, masters.c:520-524)
            try:
                self.db.compile_string(raw)
                self._rescan_objects()
            except Exception as err:
                import warnings

                warnings.warn(f"ddcMD_CMDS object rescan failed: {err}")
        if "checkpoint" in text and on_checkpoint:
            on_checkpoint(self)
        if "profile" in text:
            from ..utils.profile import PROFILE

            try:
                self.profile_phases()
            except Exception as err:
                print(f"profile: FAILED ({type(err).__name__}: {err})")

            print(PROFILE.table())
        if "analysis" in text:
            # DO_ANALYSIS flag: force every registered analysis to eval +
            # output now (readCmds.c:47)
            for a in self.analyses:
                a.eval(self)
                a.output(self, self.run_dir)
        if "hpm" in text:
            # HPM_PRINT: hardware-counter wrapper is a no-op stub in the
            # reference release too (hpmWrapper.c:20-23)
            print("hpm: no-op (reference stubs HPM in this release)")
        if "exit" in text and "checkpoint" not in text and on_checkpoint:
            on_checkpoint(self)   # exit = STOP | CHECKPOINT (readCmds.c:44)
        if "kill" in text or "exit" in text or "stop" in text:
            stop = True
        return stop

    def _emit_prints(self, scal, k, print_fn):
        cfg = self.sysdef.cfg
        n_global = self.sysdef.state.n_local
        loop_end = int(self.ss.loop)
        for j in range(k):
            loop = loop_end - k + 1 + j
            if cfg.printrate and loop % cfg.printrate == 0:
                eion, rk = scal[j, 0], scal[j, 1]
                tr_vir, vol = scal[j, 2], scal[j, 3]
                hd = scal[j, 4:7]
                tr_tion = scal[j, 10]
                dof = 3.0 * n_global - self.sysdef.n_constraints
                temperature = 2.0 * rk / (dof * U.kB)
                if self.printinfo.print_molecular_pressure:
                    # single-bead molecules: molecular virial == virial;
                    # P = (tr_virial + 3 N_mol kB T) / 3V (molecularPressure.c:57-67)
                    vir = tr_vir
                    if self.molecules and not self.molecules.is_trivial:
                        vir = tr_vir  # molecular correction folded in step fn
                    pressure = (vir + 3.0 * self.n_molecules * U.kB * temperature) / (3.0 * vol)
                else:
                    pressure = (tr_vir + tr_tion) / (3.0 * vol)
                time_ps = float(self.ss.time) - (k - 1 - j) * cfg.dt
                line = self.printinfo.row(loop, time_ps, eion, rk, temperature,
                                          pressure, vol, hd, n_global)
                if print_fn:
                    print_fn(line)
                else:
                    self.printinfo.emit(line, self.run_dir)


def simulate_master(db: ObjectDB, base_dir: str = ".", run_dir: str = ".",
                    n_loops: int | None = None, dtype=jnp.float32) -> Simulation:
    sim = Simulation(db, base_dir, dtype=dtype, run_dir=run_dir)
    from ..io.restart import write_checkpoint

    sim.run(n_loops, on_checkpoint=lambda s: write_checkpoint(s, run_dir))
    return sim
