"""Deck-driven multi-chip simulation over a slab or brick mesh.

Makes the ddc decomposition usable from decks/CLI: `ddc DDC {lx=2; ly=2;
lz=2;}` (reference domain lattice keywords, ddc.c:35-137) selects a
brick mesh.  Sharded coverage: Martini/PAIR/EAM nonbond, gid-keyed
bonded terms (bonds/angles/torsions/impropers/bpairs/exclusions/CMAP),
constraints, the Berendsen-style barostat, molecule-coherent migration
(ddcRuleMolecule analog), and the Langevin/FREE group kicks.

Boxes may be orthorhombic or triclinic (BOX type=GENERAL): brick
ownership, halos and migration run in fractional coordinates with
perpendicular-span windows (parallel/brick.geom_frac) and forces
min-image against the full h.  The Berendsen barostat (affine
r' = diag(lam) r, h' = diag(lam) h) and VORONOI load balance (run in
the scaled-fractional frame where a tilted box is Euclidean) work under
general h as well.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from ..core.system import build_system
from ..nbr.celllist import CellGrid
from ..objects import ObjectDB
from ..objects import units as U
from ..potentials.martini import martini_device_tables


class ParallelSimulation:
    """Sharded driver: waterbox-class decks over an n-device mesh."""

    def __init__(self, db: ObjectDB, base_dir: str = ".", *,
                 shape=None, n_devices=None, dtype=jnp.float32,
                 engine: str = "auto", interpret: bool = False):
        """engine: per-device pair engine, 'auto' (the pallas kernel on a
        GPU where the decomposition admits it, else 'nlist'), 'pallas'
        or 'nlist'.  interpret=True runs the kernel on the CPU (tests)."""
        self.db = db
        self._engine_req = engine
        self._interpret = interpret
        self.dtype = dtype
        sd = build_system(db, base_dir, dtype=dtype)
        self.sysdef = sd
        tri = not sd.box.ortho

        # decomposition shape: deck ddc lx/ly/lz override
        sim = db.by_class("SIMULATE")[0]
        ddc = db.find(sim.get_str("ddc", "ddc"), "DDC")
        if shape is None and ddc is not None and ddc.has("lx"):
            shape = (ddc.get_int("lx", 1), ddc.get_int("ly", 1),
                     ddc.get_int("lz", 1))
        if shape is None:
            nd = n_devices or len(jax.devices())
            shape = (nd, 1, 1)
        self.shape = tuple(shape)
        n_dev = int(np.prod(self.shape))

        martini = next((p for p in sd.potentials if p[0] == "MARTINI"), None)
        eam = next((p for p in sd.potentials if p[0] == "EAM"), None)
        if martini is not None:
            parms = martini[2]
            self.tables = martini_device_tables(parms, dtype=dtype)
            tmap = parms.species_lj_type
            self.force_kind = "martini"
        elif eam is not None:
            from ..potentials.eam import eam_device_tables

            parms = None
            self.tables = eam_device_tables(eam[2], dtype=dtype)
            tmap = np.arange(len(sd.species), dtype=np.int32)
            self.force_kind = "eam"
        elif any(p[0] == "PAIR" for p in sd.potentials):
            # PAIR = the same shifted-LJ kernel with Coulomb zeroed
            from ..potentials.pair import pair_device_tables

            pp = next(p for p in sd.potentials if p[0] == "PAIR")
            parms = None
            tmap = np.arange(len(sd.species), dtype=np.int32)
            if pp[2].table is not None:
                # piecewise-polynomial TableFunction rides its own
                # brickstep force path (pair_lj table branch)
                self.tables = pair_device_tables(pp[2], dtype=dtype)
                self.force_kind = "pairtab"
            else:
                z = jnp.zeros((), dtype)
                self.tables = dict(pair_device_tables(pp[2], dtype=dtype),
                                   krf=z, crf=z, keR=z)
                self.force_kind = "martini"
        else:
            raise NotImplementedError(
                "ParallelSimulation shards MARTINI/CHARMM, EAM and PAIR "
                "decks")

        n = sd.state.n_local
        # geom feeds the step/halo math ((3,) lengths or (3,3) h); L is
        # the per-axis Cartesian brick width (perpendicular spans for a
        # tilted box) that all planning heuristics measure rlist against
        geom = np.asarray(sd.box.h if tri else sd.box.lengths,
                          dtype=np.float64)
        L = np.asarray(sd.box.perp_spans if tri else sd.box.lengths,
                       dtype=np.float64)
        rlist = sd.rcut_max + sd.neighbor_deltaR
        r_host = np.asarray(sd.state.r[:n])
        # load-balance/occupancy coordinates: fractional position scaled
        # by the perpendicular span, so per-axis binning matches the
        # fractional brick walls and cell grid
        r_lb = (r_host @ np.linalg.inv(geom).T * L[None, :]) if tri \
            else r_host

        from ..parallel.brick import BrickPlan, distribute_bricks
        from ..parallel.brickstep import make_brick_mesh

        # deck-driven load balance (loadBalance LOADBALANCE {type=zRamp}
        # on the DDC object, loadBalance_init /root/reference/src/
        # loadBalance.c:32-85): per-axis equal-work walls = the
        # tensor-product ORCB a fixed brick topology admits
        walls = None
        voronoi = None
        self.lb_rate = 0
        self._lb_kind = None
        lbobj = (db.find(ddc.get_str("loadBalance", ""), "LOADBALANCE")
                 if ddc is not None else None)
        if lbobj is not None:
            kind = lbobj.get_str("type", "").upper()
            self._lb_work_power = lbobj.get_int("workPower", 2)
            if kind == "BISECTION":
                # TRUE recursive coordinate bisection (bisectionCalc.c):
                # y walls per x-slab, z walls per (x,y) column
                from ..parallel.loadbalance import orcb_walls

                walls = orcb_walls(
                    r_lb, L, self.shape,
                    min_frac=tuple(1.05 * rlist / L[a] for a in range(3)))
                self._lb_kind = "bisection"
                self.lb_rate = lbobj.get_int("rate", 0)
            elif kind in ("ZRAMP", "TENSOR"):
                from ..parallel.loadbalance import clamp_walls, tensor_walls

                raw = tensor_walls(r_lb, L, self.shape,
                                   work_power=self._lb_work_power)
                walls = tuple(tuple(clamp_walls(w, 1.05 * rlist / L[a]))
                              for a, w in enumerate(raw))
                self._lb_kind = "tensor"
                self.lb_rate = lbobj.get_int("rate", 0)
            elif kind == "VORONOI":
                # nearest-center domains; centers start at the brick
                # centers and drift under the diffusive balancer
                # (voronoiLoadBalance registry, loadBalance.c:65-68).
                # Triclinic boxes run in the SCALED-FRACTIONAL frame
                # (fractional coords x perpendicular spans): L here is
                # already the perp-span vector and r_lb the transformed
                # positions, so centers/margins stay Euclidean
                from ..parallel.voronoi import nominal_centers

                voronoi = dict(centers=nominal_centers(L, self.shape),
                               margins=np.zeros(3), L0=L.copy())
                self._lb_kind = "voronoi"
                self._lb_eta = lbobj.get_float("eta", 0.5)
                self.lb_rate = lbobj.get_int("rate", 0)

        # decomposition restart (readPXYZ.c): when the snapshot dir this
        # run restarts from carries a pxyz with matching mesh shape and
        # balancer family, resume the SAVED walls/centers instead of the
        # freshly computed decomposition (DDCMD_PXYZ_RESTART=0 disables)
        if (self._lb_kind is not None
                and os.environ.get("DDCMD_PXYZ_RESTART", "1") != "0"):
            colobjs = db.by_class("COLLECTION")
            files_v = colobjs[0].get_str("files", "") if colobjs else ""
            pxyz_path = os.path.join(base_dir, os.path.dirname(files_v),
                                     "pxyz")
            from ..io.pxyz import restore_plan_lb

            w_saved, v_saved = restore_plan_lb(pxyz_path, self.shape,
                                               self._lb_kind)
            if w_saved is not None:
                walls = tuple(
                    tuple(w) if np.asarray(w).ndim == 1 else np.asarray(w)
                    for w in w_saved)
            if v_saved is not None:
                voronoi = v_saved

        # halo windows scale with rlist / brick width: dense short-cutoff
        # systems (EAM metals) can need windows holding most of a brick's
        # pool, so size per-phase ghost buffers from the geometry
        per_dev = max(1, n // n_dev)
        width = min(L[a] / self.shape[a] for a in range(3))
        win = rlist
        if voronoi is not None:
            # Voronoi halo windows widen by the bisector margin as the
            # balancer moves centers; reserve for the displacement bound
            from ..parallel.voronoi import beta_max

            win = rlist + 0.75 * beta_max(L, self.shape) * width
        frac = min(1.0, win / width)
        halo_est = int(per_dev * (1 + 2 * frac) ** 2 * frac * 1.8) + 64
        self.plan = BrickPlan(
            shape=self.shape,
            # one device owns exactly n forever (no migration imbalance)
            local_cap=_cap(n) if n_dev == 1 else _cap(4 * n // n_dev),
            halo_cap=_cap(max(3 * n // n_dev // 2, halo_est)),
            migrate_cap=_cap(max(256, n // (4 * n_dev))),
            rlist=rlist, walls=walls, voronoi=voronoi)
        # measured-occupancy planning: the mean-density heuristic
        # underestimates clustered decks, and when a brick's halo window
        # wraps a small box the same atom appears as multiple ghost
        # images (duplication factor = extended-span / box per axis)
        spans = [min(1.0, rlist / (L[a] / self.shape[a])) for a in range(3)]
        dup = float(np.prod([
            max(1.0, (L[a] / self.shape[a]) * (1 + 2 * spans[a]) / L[a])
            for a in range(3)]))
        # NPT decks plan cells with shrink headroom (same plan_margin the
        # single-chip superchunk uses) so a compressing box replans less
        _ipp = sd.integrator_parms or {}
        self._npt_deck = (sd.integrator_type in (
            "NGLFCONSTRAINT", "NGLFCONSTRAINTGPU",
            "NGLFCONSTRAINTGPULANGEVIN", "NGLFGPU", "NGLFGPULANGEVIN",
            "NGLFNEW", "NPTGLF", "NGLFNK") and _ipp.get("beta", 0) > 0)
        self.grid = CellGrid.plan(L, sd.rcut_max, sd.neighbor_deltaR, n,
                                  self.plan.local_cap + self.plan.ghost_cap,
                                  positions=r_lb,
                                  occupancy_factor=dup,
                                  plan_margin=1.1 if self._npt_deck else 1.0)
        self.mesh = make_brick_mesh(self.shape)
        self.coeffs = sd.group_table.coefficients(sd.cfg.time, 0.5 * sd.cfg.dt,
                                                  dtype=dtype)
        # gid-keyed bonded terms + molecule-coherent migration when the
        # system has covalent topology
        bonded_gid_tab = None
        cons_tab = None
        field_keys = None
        gid64 = sd.collection.gid
        hgid64 = None
        bt = sd.bonded if parms is not None else None
        if bt is not None and bt.counts().get("bonds", 0) + \
                bt.counts().get("angles", 0) > 0:
            from ..parallel.bonded_shard import bonded_gid_tables
            from ..parallel.brickstep import FIELD_KEYS
            from ..potentials.bonded import device_bonded_tables

            dtab = device_bonded_tables(
                bt, dtype, lj_sigma=parms.sigma, lj_eps=parms.eps,
                lj_shift=parms.shift, rcut=parms.rcut,
                keR=U.ke / parms.epsilon_r,
                charges=np.asarray(sd.state.q),
                species_lj_type=parms.species_lj_type,
                species_per_particle=np.asarray(sd.state.species))
            bonded_gid_tab = bonded_gid_tables(bt, gid64, dtab)
            field_keys = FIELD_KEYS + ("hgid",)
            if bt.n_constraints > 0 and "CONSTRAINT" in sd.integrator_type:
                from ..parallel.bonded_shard import constraint_gid_tables

                cons_tab = constraint_gid_tables(bt, gid64)
            # head bead = first atom of each CHAIN (a maximal run of
            # residue instances joined by junction terms): residue-level
            # heads would split a peptide at the C(+N) bond across
            # devices and silently drop the ghost-side bonded forces
            hgid64 = gid64.copy()
            cl = getattr(bt, "chain_links", None)
            linked = set(np.asarray(cl).tolist()) if cl is not None else set()
            head_rows = None
            for i, (_name, rows) in enumerate(sd.residue_instances or []):
                if head_rows is None or (i - 1) not in linked:
                    head_rows = rows
                hgid64[np.asarray(rows)] = gid64[head_rows[0]]

        # Berendsen-style barostat (NGLFCONSTRAINT family with beta>0):
        # sharded NPT uses the atomic virial -- identical to molecular
        # pressure for single-bead molecules (waterbox); warn otherwise
        ip = sd.integrator_parms
        barostat = None
        mol_tab = None
        if (sd.integrator_type in ("NGLFCONSTRAINT", "NGLFCONSTRAINTGPU",
                                   "NGLFCONSTRAINTGPULANGEVIN", "NGLFGPU",
                                   "NGLFGPULANGEVIN", "NGLFNEW")
                and ip["beta"] > 0):
            # triclinic NPT: the Berendsen move is r' = diag(lam) r,
            # h' = diag(lam) h (nglfconstraint.c:64-85 is affine, not
            # orthorhombic-specific); the chunk carries the full (3,3) h
            # and measures brick/cell widths by perpendicular span
            from ..core.molecule import build_molecule_class

            sysobj = db.get(sd.cfg.system_name, "SYSTEM")
            mols = build_molecule_class(db, sysobj, sd.collection.species_names,
                                        sd.collection.gid)
            n_mol = mols.n_molecules if mols else n
            if mols and n_mol < n:
                # multi-bead molecules: the barostat runs on the sharded
                # MOLECULAR virial (gid-resolved per owner, psum'd)
                from ..parallel.bonded_shard import molecule_gid_tables

                mol_tab = molecule_gid_tables(mols, gid64)
            barostat = dict(P0=ip["P0"], beta=ip["beta"],
                            tau=ip["tauBarostat"], T=ip["T"],
                            isotropic=ip["isotropic"], n_molecules=n_mol)
        self.barostat = barostat

        self.chunk_steps = max(1, int(sd.cfg.ddc_update_rate))
        # shard engine: the pallas pair kernel per device (the
        # reference's fastest-engine-under-decomposition architecture,
        # masters.c:389-403) on brick decompositions; the (N,K) nlist
        # engine otherwise (_pick_shard_engine).
        n_loc0 = sd.state.n_local
        self._coulomb = bool(np.any(np.asarray(sd.state.q[:n_loc0]) != 0.0))
        # uniform-LJ-type collapse for the pallas kernel (scalar
        # parameters; same fast path as run/forces.py's wiring)
        self._pallas_tables, self._pallas_tmap = self.tables, tmap
        if self.force_kind == "martini":
            from .forces import _uniform_type_tables

            self._pallas_tables, self._pallas_tmap = _uniform_type_tables(
                sd, self.tables, tmap)
        self.shard_engine = self._pick_shard_engine(geom, L, rlist)

        # in-kernel bonded-pair exclusions under the pallas shard engine
        # (run/forces._excl_channels; the catapult fix): rebuild the
        # bonded tables in rf_add mode (the kept-RF convention the
        # in-engine masking pairs with) and ship the exclusion channels
        # as a migrating (n, 2) field
        excl_vals = None
        if (self.shard_engine == "pallas" and bt is not None
                and bt.exclusions is not None and self.force_kind == "martini"
                and os.environ.get("DDCMD_INLIST_EXCL", "1") != "0"):
            from ..run.forces import _excl_channels

            excl_vals = _excl_channels(bt.exclusions, n)
            if excl_vals is None:
                # see Simulation's pallas->nlist exclusion demote: wide
                # exclusion components + f32 compute-then-subtract is
                # the r4 catapult mechanism.  The sharded nlist engine
                # subtracts too, so there is no safe f32 sharded path --
                # warn loudly (f64 runs are fine: residual ~1e-10 rel)
                import warnings

                warnings.warn(
                    "sharded f32 run with an exclusion graph wider than "
                    "the in-kernel encoding (>12-member component): "
                    "compute-then-subtract residuals can catapult deep "
                    "bond compressions (see docs/USAGE.md, instability "
                    "forensics); consider dtype=float64 or a smaller exclusion "
                    "graph", stacklevel=2)
            if excl_vals is not None:
                if bonded_gid_tab is not None:
                    # bonded terms exist: rebuild their tables in rf_add
                    # mode so the in-engine mask pairs with the kept-RF
                    # convention
                    from ..parallel.bonded_shard import bonded_gid_tables
                    from ..potentials.bonded import device_bonded_tables

                    dtab = device_bonded_tables(
                        bt, dtype, lj_sigma=parms.sigma, lj_eps=parms.eps,
                        lj_shift=parms.shift, rcut=parms.rcut,
                        keR=U.ke / parms.epsilon_r,
                        charges=np.asarray(sd.state.q),
                        species_lj_type=parms.species_lj_type,
                        species_per_particle=np.asarray(sd.state.species),
                        excl_mode="rf_add", krf=parms.krf, crf=parms.crf)
                    bonded_gid_tab = bonded_gid_tables(bt, gid64, dtab)
                # exclusion-only topologies (e.g. constraints without
                # bonds/angles) still take the in-kernel path: field_keys
                # is None then, so start from the base key set
                from ..parallel.brickstep import FIELD_KEYS as _FK

                field_keys = tuple(field_keys or _FK) + ("excl",)
        self._excl_vals = excl_vals

        # residue-template batched bonded terms under the pallas shard
        # engine (the r5 single-chip bonded win, sharded): intra-residue
        # terms resolve per TYPE (one searchsorted per chunk) and
        # evaluate lane-dense; junction/CMAP leftovers keep the per-term
        # resolver.  DDCMD_BONDED_BATCH=0 opts out.
        if (self.shard_engine == "pallas" and bonded_gid_tab is not None
                and sd.residue_instances
                and os.environ.get("DDCMD_BONDED_BATCH", "1") != "0"):
            from ..parallel.bonded_shard import leftover_gid_tables
            from ..potentials.bonded_batch import build_batched_bonded

            bplan, left = build_batched_bonded(
                dtab, sd.residue_instances, n, dtype, gid=gid64)
            if bplan is not None:
                bonded_gid_tab = dict(leftover_gid_tables(left, gid64),
                                      **{"__batched__": bplan})

        # template-batched single-bond RATTLE under the pallas shard
        # engine (same per-type lane math as the single-chip r5 path)
        if (self.shard_engine == "pallas" and cons_tab is not None
                and sd.residue_instances
                and os.environ.get("DDCMD_CONS_BATCH", "1") != "0"):
            from ..integrators.constraints import build_constraint_templates

            tmpl = build_constraint_templates(
                bt.cons_atoms, bt.cons_pairs, bt.cons_dist,
                sd.residue_instances, gid64)
            if tmpl is not None:
                cons_tab = dict(cons_tab, templates=tmpl)

        self._step_kwargs = dict(
            dt=sd.cfg.dt, box_lengths=geom, species_lj_type=tmap, n_global=n,
            bonded_tables=bonded_gid_tab,
            field_keys=field_keys or ("r", "v", "q", "mass", "species",
                                      "group", "gid"),
            chunk_steps=self.chunk_steps,
            constraint_tables=cons_tab, barostat=barostat,
            mol_tables=mol_tab, force_kind=self.force_kind,
            excl=excl_vals is not None)
        self._build_step_fns(geom)

        npdt = np.dtype(jnp.dtype(dtype))
        arrays = dict(
            r=np.asarray(sd.state.r[:n], dtype=npdt),
            v=np.asarray(sd.state.v[:n], dtype=npdt),
            q=np.asarray(sd.state.q[:n], dtype=npdt),
            mass=np.asarray(sd.state.mass[:n], dtype=npdt),
            species=np.asarray(sd.state.species[:n]),
            group=np.asarray(sd.state.group[:n]),
            gid=np.stack([(gid64 & 0xFFFFFFFF).astype(np.uint32),
                          (gid64 >> 32).astype(np.uint32)], axis=1),
        )
        if hgid64 is not None:
            arrays["hgid"] = np.stack(
                [(hgid64 & 0xFFFFFFFF).astype(np.uint32),
                 (hgid64 >> 32).astype(np.uint32)], axis=1)
        if excl_vals is not None:
            arrays["excl"] = np.asarray(excl_vals[:n], dtype=np.float32)
        self._host_arrays = arrays          # gid-ordered template (r/v refreshed on gather)
        self._box_L = geom
        self._lb_L = L                      # per-axis perpendicular spans
        buf, mask, counts = distribute_bricks(arrays, geom, self.plan)
        shard = lambda a: jax.device_put(
            jnp.asarray(a), NamedSharding(self.mesh, P(("bx", "by", "bz"))))
        self.fields = {k: shard(v) for k, v in buf.items()}
        self.mask = shard(mask)
        self.key = jax.random.PRNGKey(sd.random_seed)
        self.f = None
        self.loop = sd.cfg.loop
        self.Lv = jnp.asarray(geom, dtype=dtype)
        self.vird = jnp.zeros(3, dtype=dtype)

    def first_energy(self):
        self.f, e, virial, ov = self.first_fn(self.fields, self.mask, self.key)
        if int(ov):
            raise RuntimeError("neighbor overflow at first energy")
        self.vird = jnp.diagonal(virial).astype(self.dtype)
        return float(e)

    def _print_scalars(self, scalars, print_fn, loop0):
        sd = self.sysdef
        if not (print_fn and sd.cfg.printrate):
            return
        # ONE host transfer for the whole dispatch: per-row float() on a
        # device array is a separate device-to-host round trip, and a
        # 1600-step dispatch has hundreds of print rows
        scalars = np.asarray(scalars)
        n = sd.state.n_local
        k = scalars.shape[0]
        for j in range(k):
            loop = loop0 + j + 1
            if loop % sd.cfg.printrate == 0:
                e_pot, rk = float(scalars[j, 0]), float(scalars[j, 1])
                T = 2.0 * rk / (3.0 * n * U.kB)
                line = (f"{loop:10d} epot/N={e_pot / n:14.6f} "
                        f"ekin/N={rk / n:12.6f} T={T:10.2f}")
                if self.barostat is not None and scalars.shape[1] >= 7:
                    line += f" V={float(scalars[j, 6]):12.4f}"
                print_fn(line)

    def run(self, n_loops: int, *, migrate_rate: int | None = None,
            print_fn=None, max_steps_per_dispatch: int | None = None):
        """Chunked dispatch: ddc_update_rate steps + one migration per
        device round trip (the multi-chip superchunk); leftover loops go
        through the single-step path.  Passing migrate_rate switches to
        the per-step path with migration at that cadence (the pre-chunk
        semantics).

        max_steps_per_dispatch > chunk_steps batches MANY chunks into one
        device dispatch when the engine provides a superchunk (the pallas
        shard engine does) -- the host round trip then amortizes over
        hundreds of steps like the single-device driver."""
        sd = self.sysdef
        if self.f is None:
            self.first_energy()
        done = 0
        k = self.chunk_steps
        if migrate_rate is not None and migrate_rate != k:
            if self.barostat is not None:
                # NPT carries (vird, Lv) through the chunk programs, so a
                # custom migration cadence = a migrate_rate-sized chunk
                # (compiled once, cached by _chunk_for)
                k = int(migrate_rate)
            else:
                return self._run_per_step(n_loops, migrate_rate, print_fn)
        next_lb = (self.loop - self.loop % self.lb_rate + self.lb_rate
                   if self.lb_rate else None)
        redis_tries = 0
        cf = self._chunk_for(k)
        # superchunk batching (pallas shard engine): M chunks/dispatch
        M = 0
        if (max_steps_per_dispatch and max_steps_per_dispatch >= 2 * k
                and hasattr(cf, "make_super")
                and (next_lb is None)):
            M = max_steps_per_dispatch // k
            cache = getattr(self, "_super_cache", {})
            gen = getattr(self, "_prog_gen", 0)
            if cache.get("key") != (M, gen):
                cache = {"key": (M, gen),
                         "fn": cf.make_super(M)}
                self._super_cache = cache
            super_fn = cache["fn"]
        while M and done + M * k <= n_loops:
            prev = (self.fields, self.mask, self.f,
                    getattr(self, "vird", None), getattr(self, "Lv", None))
            self.key, sub = jax.random.split(self.key)
            if self.barostat is not None:
                (self.fields, self.mask, self.f, self.vird, self.Lv,
                 scalars, ov) = super_fn(
                    self.fields, self.mask, self.f, self.vird, self.Lv, sub)
            else:
                (self.fields, self.mask, self.f, scalars,
                 ov) = super_fn(self.fields, self.mask, self.f, sub)
            if int(ov):
                redis_tries += 1
                if redis_tries > 2:
                    raise RuntimeError(
                        f"overflow in superchunk at loop {self.loop}")
                self.fields, self.mask, self.f = prev[:3]
                if self.barostat is not None:
                    self.vird, self.Lv = prev[3], prev[4]
                if redis_tries == 1:
                    self.redistribute()
                else:
                    self.replan()
                # step/chunk programs changed: rebuild the superchunk
                cf = self._chunk_for(k)
                cache = {"key": (M, getattr(self, "_prog_gen", 0)),
                         "fn": cf.make_super(M)}
                self._super_cache = cache
                super_fn = cache["fn"]
                continue
            redis_tries = 0
            self._print_scalars(scalars, print_fn, self.loop)
            self.loop += M * k
            done += M * k
        while done + k <= n_loops:
            if next_lb is not None and self.loop >= next_lb:
                self.rebalance()
                next_lb += self.lb_rate
            prev = (self.fields, self.mask, self.f,
                    getattr(self, "vird", None), getattr(self, "Lv", None))
            self.key, sub = jax.random.split(self.key)
            if self.barostat is not None:
                (self.fields, self.mask, self.f, self.vird, self.Lv,
                 scalars, ov) = cf(
                    self.fields, self.mask, self.f, self.vird, self.Lv, sub)
            else:
                (self.fields, self.mask, self.f, scalars,
                 ov) = cf(self.fields, self.mask, self.f, sub)
            if int(ov):
                # roll back to the pre-chunk state, then escalate:
                # (1) host redistribute (exact ownership -- covers ORCB
                # misplacement flags and transient spikes), (2) live
                # replan (NPT shrink dropped a cell edge below rlist),
                # (3) give up
                redis_tries += 1
                if redis_tries > 2:
                    raise RuntimeError(
                        f"overflow in chunk at loop {self.loop}")
                self.fields, self.mask, self.f = prev[:3]
                if self.barostat is not None:
                    self.vird, self.Lv = prev[3], prev[4]
                if redis_tries == 1:
                    self.redistribute()
                else:
                    self.replan()
                cf = self._chunk_for(k)
                continue
            redis_tries = 0
            self._print_scalars(scalars, print_fn, self.loop)
            self.loop += k
            done += k
        if self.barostat is not None:
            # NPT remainder: a partial chunk program (compiled once per
            # distinct length) -- the per-step path has no (vird, Lv)
            # plumbing, and whole-chunk-only advance was exactly the knob
            # a production NPT run would trip on (VERDICT r3 weak#7)
            while done < n_loops:
                r = n_loops - done
                cfr = self._chunk_for(r)
                prev = (self.fields, self.mask, self.f, self.vird, self.Lv)
                self.key, sub = jax.random.split(self.key)
                (self.fields, self.mask, self.f, self.vird, self.Lv,
                 scalars, ov) = cfr(
                    self.fields, self.mask, self.f, self.vird, self.Lv, sub)
                if int(ov):
                    redis_tries += 1
                    if redis_tries > 2:
                        raise RuntimeError(
                            f"overflow in remainder chunk at loop {self.loop}")
                    (self.fields, self.mask, self.f,
                     self.vird, self.Lv) = prev
                    self.redistribute() if redis_tries == 1 else self.replan()
                    continue
                redis_tries = 0
                self._print_scalars(scalars, print_fn, self.loop)
                self.loop += r
                done += r
            return self
        while done < n_loops:
            self.key, sub = jax.random.split(self.key)
            self.fields, self.f, scalars, ov = self.step_fn(
                self.fields, self.mask, self.f, sub)
            if int(ov):
                raise RuntimeError(f"overflow at loop {self.loop}")
            self.loop += 1
            done += 1
            self._print_scalars(scalars[None, :], print_fn, self.loop - 1)
        return self

    def _run_per_step(self, n_loops, migrate_rate, print_fn):
        """Per-step dispatch with migration at migrate_rate (the
        pre-chunk semantics; non-NPT only)."""
        done = 0
        while done < n_loops:
            self.key, sub = jax.random.split(self.key)
            self.fields, self.f, scalars, ov = self.step_fn(
                self.fields, self.mask, self.f, sub)
            if int(ov):
                raise RuntimeError(f"overflow at loop {self.loop}")
            self.loop += 1
            done += 1
            self._print_scalars(scalars[None, :], print_fn, self.loop - 1)
            if self.loop % migrate_rate == 0:
                (self.fields, self.mask, self.f,
                 ov) = self.migrate_fn(self.fields, self.mask, self.f)
                if int(ov):
                    raise RuntimeError(
                        f"migration overflow at loop {self.loop}")
        return self


def _pick_shard_engine(psim, geom, L, rlist):
    """'pallas' when the kernel runs here (a GPU, or interpret=True) and
    the decomposition has brick walls (uniform OR load-balanced
    tensor/ORCB; orthorhombic box, f32, Martini/PAIR force path);
    'nlist' otherwise (Voronoi decompositions have no brick lattice).  An explicit engine='pallas' that cannot run
    raises."""
    from ..parallel.brick import walls_span_minmax

    req = psim._engine_req
    if req not in ("auto", "pallas", "nlist"):
        raise ValueError(f"unknown shard engine {req!r}")
    if req == "nlist":
        return "nlist"
    why = None
    if jax.default_backend() != "gpu" and not psim._interpret:
        why = f"the kernel needs a GPU (backend {jax.default_backend()!r})"
    elif psim.force_kind != "martini":
        why = f"{psim.force_kind} force path"
    elif np.asarray(geom).ndim != 1:
        why = "triclinic box"
    elif psim.dtype != jnp.float32:
        why = "the kernel computes in float32"
    elif psim.plan.voronoi is not None:
        why = "Voronoi decomposition"
    sf_min, _ = walls_span_minmax(psim.plan.walls, psim.shape)
    for a in range(3):
        na = psim.shape[a]
        span = L[a] * sf_min[a]
        # open axes need every brick >= rlist (1-hop halos span the
        # cutoff); 2-device axes need >= 2 rlist (an atom within rlist
        # of BOTH faces would have to appear at two ghost images, but
        # the staged exchange ships it once)
        if na > 1 and span < rlist * (2.0 if na == 2 else 1.0):
            why = why or (f"axis {a}: brick {span:.3f} too narrow for "
                          f"rlist {rlist:.3f}")
    if req == "pallas" and why:
        raise ValueError(f"engine='pallas' cannot run here: {why}")
    return "nlist" if why else "pallas"


ParallelSimulation._pick_shard_engine = _pick_shard_engine


def _make_step_fns(psim, geom, chunk_steps=None):
    """Construct (step, first, migrate, chunk) programs for the CURRENT
    plan/grid; chunk_steps overrides the ddc_update_rate-sized
    chunk (NPT remainder / custom migrate_rate chunks)."""
    from ..parallel.brickstep import make_brick_step

    kw = dict(psim._step_kwargs, box_lengths=geom)
    if chunk_steps is not None:
        kw["chunk_steps"] = chunk_steps
    if psim.shard_engine == "pallas":
        from ..parallel.brickstep_pallas import make_brick_step_pallas

        kw.pop("force_kind")
        kw["species_lj_type"] = psim._pallas_tmap
        return make_brick_step_pallas(
            psim.mesh, psim.plan, psim.grid, psim._pallas_tables,
            psim.coeffs, coulomb=psim._coulomb,
            interpret=psim._interpret, **kw)
    if kw.pop("excl", False):
        # the bonded tables were built in rf_add mode for the in-kernel
        # masking pallas engine; the nlist brick step has no in-engine
        # masking, so silently continuing would drop the exclusion terms
        raise RuntimeError(
            "sharded engine demoted to nlist with in-kernel exclusions "
            "active; rerun with engine='pallas' (brick walls) or "
            "DDCMD_INLIST_EXCL=0")
    return make_brick_step(psim.mesh, psim.plan, psim.grid, psim.tables,
                           psim.coeffs, **kw)


def _build_step_fns(psim, geom):
    """(Re)build the sharded step/first/migrate/chunk programs for the
    current plan/grid; dispatches to the per-device pallas engine when
    eligible."""
    (psim.step_fn, psim.first_fn, psim.migrate_fn,
     psim.chunk_fn) = _make_step_fns(psim, geom)
    # generation counter: caches keyed on it (NOT id(chunk_fn), which
    # CPython can reuse after the old program is collected) die on replan
    psim._prog_gen = getattr(psim, "_prog_gen", 0) + 1
    psim._box_L = geom


def _chunk_for(psim, k2):
    """Chunk program with chunk_steps=k2, cached.  k2 == chunk_steps
    returns the production program; other lengths (the NPT remainder
    chunk, a custom migrate_rate) compile once and are invalidated
    whenever replan/rebalance rebuilds the production programs (the
    cache key carries the program generation -- NOT id(chunk_fn), which
    CPython can reuse after the old program is collected)."""
    if k2 == psim.chunk_steps:
        return psim.chunk_fn
    cache = getattr(psim, "_alt_chunk_cache", {})
    gen = getattr(psim, "_prog_gen", 0)
    key = (k2, gen)
    fn = cache.get(key)
    if fn is None:
        fn = _make_step_fns(psim, psim._box_L, chunk_steps=k2)[3]
        # key on the program generation: stale variants die on replan
        cache = {kk: v for kk, v in cache.items() if kk[1] == gen}
        cache[key] = fn
        psim._alt_chunk_cache = cache
    return fn


ParallelSimulation._chunk_for = _chunk_for


ParallelSimulation._build_step_fns = _build_step_fns


def _cap(x: int) -> int:
    return ((int(x) + 7) // 8) * 8


def _gather_by_gid(psim):
    """Collect sharded fields to host in the collection's original gid
    order (pio gather analog: every row keyed by its gid)."""
    m = np.asarray(psim.mask)
    gp = np.asarray(psim.fields["gid"])[m]
    g64 = gp[:, 0].astype(np.int64) | (gp[:, 1].astype(np.int64) << 32)
    r = np.asarray(psim.fields["r"])[m]
    v = np.asarray(psim.fields["v"])[m]
    col_gid = np.asarray(psim.sysdef.collection.gid, dtype=np.int64)
    pos = {int(g): i for i, g in enumerate(col_gid)}
    idx = np.fromiter((pos[int(g)] for g in g64), dtype=np.int64,
                      count=len(g64))
    n = len(col_gid)
    R = np.zeros((n, 3)); V = np.zeros((n, 3))
    R[idx] = r
    V[idx] = v
    return R, V


class _CheckpointShim:
    """Just enough of Simulation's surface for io.restart.write_checkpoint."""

    def __init__(self, sysdef, ss, key):
        self.sysdef = sysdef
        self.ss = ss
        self.key = key


def parallel_write_checkpoint(psim, run_dir: str = ".") -> str:
    """Write a snapshot dir restartable by Simulation OR
    ParallelSimulation (writeRestart analog for the mesh driver).

    Default path (DDCMD_SHARD_WRITERS=1, ascii modes): per-DEVICE shard
    writers -- each device's OWNED rows stream to their own atoms#
    shard straight from that device's addressable block, so O(N) output
    never materializes the global arrays on one host buffer (pio's
    N-writer layout, Pio_setNumWriteFiles,
    /root/reference/src/simulate.c:212).  Binary checkpoint modes and
    DDCMD_SHARD_WRITERS=0 keep the gather-by-gid single-writer path."""
    from ..core.box import Box
    from ..core.energy import EnergyInfo
    from ..integrators.nglf import StepState
    from ..io.restart import write_checkpoint as _wc

    sd = psim.sysdef
    n = sd.state.n_local
    g = np.asarray(psim.Lv, dtype=np.float64)
    box = (Box.orthorhombic(g, dtype=jnp.float64) if g.ndim == 1
           else Box.from_h(g, dtype=jnp.float64))

    colobj = sd.db.find(
        sd.db.get(sd.cfg.system_name, "SYSTEM").get_str(
            "collection", "collection"), "COLLECTION")
    mode = (colobj.get_str("mode", "VARRECORDASCII") if colobj
            else "VARRECORDASCII")
    sharded = (os.environ.get("DDCMD_SHARD_WRITERS", "1") != "0"
               and mode.upper() not in ("FIXRECORDBINARY", "BINARY"))

    if sharded:
        state = sd.state  # records come from the device shards, not here
        writer = _make_sharded_atoms_writer(psim, box)
    else:
        R, V = _gather_by_gid(psim)
        state = sd.state.replace(
            r=sd.state.r.at[:n].set(jnp.asarray(R, sd.state.r.dtype)),
            v=sd.state.v.at[:n].set(jnp.asarray(V, sd.state.v.dtype)))
        writer = None
    ss = StepState(state=state, box=box, energy=EnergyInfo.zero(),
                   loop=jnp.asarray(psim.loop, jnp.int32),
                   time=jnp.asarray((psim.loop - sd.cfg.loop) * sd.cfg.dt
                                    + sd.cfg.time))
    shim = _CheckpointShim(sd, ss, np.asarray(psim.key))
    # pxyz records the LIVE decomposition (walls/Voronoi centers) so a
    # restart resumes the balanced domains (ddc_writePXYZ analog)
    shim.parallel_plan = psim.plan
    return _wc(shim, run_dir, atoms_writer=writer)


def _make_sharded_atoms_writer(psim, box):
    """atoms_writer callback: one atoms# shard per device from its OWNED
    rows (any record order -- readers key by gid; byte-identical to the
    gathered writer after a gid sort)."""
    from ..io.collection import _strip_header, write_collection

    sd = psim.sysdef
    col = sd.collection
    col_gid = np.asarray(col.gid, dtype=np.int64)
    pos = getattr(psim, "_gid_pos", None)
    if pos is None:
        pos = {int(g): i for i, g in enumerate(col_gid)}
        psim._gid_pos = pos
    sp_arr = np.asarray(col.species_names, dtype="U16")
    gr_arr = np.asarray(col.group_names, dtype="U16")
    cl_arr = np.asarray(col.class_names, dtype="U16")
    h = np.asarray(box.h, dtype=np.float64)

    def writer(snapdir, mode, loop, time_fs):
        f_sh = {k: sorted(psim.fields[k].addressable_shards,
                          key=lambda s: s.device.id)
                for k in ("r", "v", "gid")}
        m_sh = sorted(psim.mask.addressable_shards,
                      key=lambda s: s.device.id)
        n_dev = len(m_sh)
        total = 0
        shard0 = os.path.join(snapdir, "atoms#000000")
        for k in range(n_dev):
            m = np.asarray(m_sh[k].data)
            gp = np.asarray(f_sh["gid"][k].data)[m]
            g64 = (gp[:, 0].astype(np.int64)
                   | (gp[:, 1].astype(np.int64) << 32))
            idx = np.fromiter((pos[int(g)] for g in g64), dtype=np.int64,
                              count=len(g64))
            rk = np.asarray(f_sh["r"][k].data, dtype=np.float64)[m]
            vk = np.asarray(f_sh["v"][k].data, dtype=np.float64)[m]
            path = os.path.join(snapdir, "atoms#%06d" % k)
            write_collection(
                path, gid=g64.astype(np.uint64),
                species_names=list(sp_arr[idx]),
                group_names=list(gr_arr[idx]),
                class_names=list(cl_arr[idx]),
                r=rk, v=vk, h=h, loop=loop, time_fs=time_fs,
                group_list=[g.name for g in sd.groups],
                species_list=[s.name for s in sd.species],
                gid_format="hex" if sd.cfg.gidFormat == "hex" else "dec",
                datatype=mode)
            total += len(g64)
            if k > 0:
                # continuation shards carry records only (pio layout:
                # the FILEHEADER lives in shard 0)
                blob = open(path, "rb").read()
                open(path, "wb").write(_strip_header(blob))
        # patch shard 0's header to the global nfiles/nrecord
        blob = open(shard0, "rb").read()
        m0 = int(np.asarray(m_sh[0].data).sum())
        blob = blob.replace(b"nfiles=1;", b"nfiles=%d;" % n_dev, 1)
        blob = blob.replace(b"nrecord=%d;" % m0, b"nrecord=%d;" % total, 1)
        open(shard0, "wb").write(blob)

    return writer


ParallelSimulation.write_checkpoint = parallel_write_checkpoint


def _lb_frame(psim, R):
    """(r_lb, L, geom): load-balance coordinates, per-axis spans and the
    step geometry for the LIVE box (triclinic: fractional positions
    scaled by perpendicular spans, matching __init__)."""
    g = psim._box_L
    if psim.barostat is not None:
        g = np.asarray(psim.Lv, dtype=np.float64)
    if g.ndim == 2:
        hin = np.linalg.inv(g)
        L = 1.0 / np.linalg.norm(hin, axis=1)
        return R @ hin.T * L[None, :], L, g
    return R, g, g


def parallel_rebalance(psim):
    """Recompute the tensor-product equal-work walls from the CURRENT
    particle distribution and redistribute (loadBalance at rate,
    /root/reference/src/loadBalance.c:32-85 + ddcAssignment).  Rebuilding
    the plan recompiles the step functions -- amortized over lb_rate."""
    import dataclasses

    from jax.sharding import NamedSharding, PartitionSpec as P

    from ..parallel.brick import distribute_bricks
    from ..parallel.loadbalance import clamp_walls, tensor_walls

    R, V = _gather_by_gid(psim)
    r_lb, L, geom = _lb_frame(psim, R)
    if getattr(psim, "_lb_kind", None) == "voronoi":
        # diffusive center update from the owned counts, then host-exact
        # nearest-center redistribution (ddcAssignment + the
        # voronoiLoadBalance balanceFunction, loadBalance.c:65-68)
        from ..parallel.voronoi import balance_step

        vor = psim.plan.voronoi
        scale = L / np.asarray(vor["L0"])
        centers, margins = balance_step(
            vor["centers"] * scale[None, None, None, :],
            np.asarray(R, dtype=np.float64), L,
            psim.shape, psim.plan.rlist,
            eta=getattr(psim, "_lb_eta", 0.5))
        psim.plan = dataclasses.replace(
            psim.plan, voronoi=dict(centers=centers, margins=margins,
                                    L0=L.copy()))
        psim._build_step_fns(geom)
        arrays = dict(psim._host_arrays,
                      r=R.astype(psim._host_arrays["r"].dtype),
                      v=V.astype(psim._host_arrays["v"].dtype))
        buf, mask, counts = distribute_bricks(arrays, geom, psim.plan)
        shard = lambda a: jax.device_put(
            jnp.asarray(a), NamedSharding(psim.mesh, P(("bx", "by", "bz"))))
        psim.fields = {k: shard(v) for k, v in buf.items()}
        psim.mask = shard(mask)
        psim.f = None
        psim.first_energy()
        return counts
    if getattr(psim, "_lb_kind", None) == "bisection":
        from ..parallel.loadbalance import orcb_walls

        walls = orcb_walls(
            r_lb, L, psim.shape,
            min_frac=tuple(1.05 * psim.plan.rlist / L[a] for a in range(3)))
    else:
        raw = tensor_walls(r_lb, L, psim.shape,
                           work_power=getattr(psim, "_lb_work_power", 2))
        walls = tuple(tuple(clamp_walls(w, 1.05 * psim.plan.rlist / L[a]))
                      for a, w in enumerate(raw))
    psim.plan = dataclasses.replace(psim.plan, walls=walls)
    psim._build_step_fns(geom)

    arrays = dict(psim._host_arrays,
                  r=R.astype(psim._host_arrays["r"].dtype),
                  v=V.astype(psim._host_arrays["v"].dtype))
    buf, mask, counts = distribute_bricks(arrays, geom, psim.plan)
    shard = lambda a: jax.device_put(
        jnp.asarray(a), NamedSharding(psim.mesh, P(("bx", "by", "bz"))))
    psim.fields = {k: shard(v) for k, v in buf.items()}
    psim.mask = shard(mask)
    psim.f = None
    psim.first_energy()
    return counts


ParallelSimulation.rebalance = parallel_rebalance


def parallel_redistribute(psim):
    """Host-exact re-assignment under the CURRENT walls (no wall update,
    no recompile): recovers from staged-migration misplacement -- with
    hierarchical ORCB walls one x-hop can land a particle >1 brick from
    its owner, which migrate_3d flags as overflow."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ..parallel.brick import distribute_bricks

    R, V = _gather_by_gid(psim)
    _, _, geom = _lb_frame(psim, R)
    arrays = dict(psim._host_arrays,
                  r=R.astype(psim._host_arrays["r"].dtype),
                  v=V.astype(psim._host_arrays["v"].dtype))
    buf, mask, counts = distribute_bricks(arrays, geom, psim.plan)
    shard = lambda a: jax.device_put(
        jnp.asarray(a), NamedSharding(psim.mesh, P(("bx", "by", "bz"))))
    psim.fields = {k: shard(v) for k, v in buf.items()}
    psim.mask = shard(mask)
    psim.f = None
    psim.first_energy()
    return counts


ParallelSimulation.redistribute = parallel_redistribute


def parallel_replan(psim):
    """Replan the local cell grid against the LIVE box and rebuild the
    step programs (multi-chip analog of the single-chip superchunk's
    replan-on-shrink): a barostat-compressed box can drop a cell edge
    below rlist (cell_ok overflow) without invalidating the bricks --
    fewer, larger cells restore the one-shell stencil.  If a BRICK is
    narrower than rlist at the live box the decomposition itself is
    infeasible (1-hop halos cannot span the cutoff): raise the actionable
    error instead of retrying forever."""
    from ..nbr.celllist import CellGrid

    sd = psim.sysdef
    R, _V = _gather_by_gid(psim)
    r_lb, L, geom = _lb_frame(psim, R)
    rlist = psim.plan.rlist
    widths = [(float(np.min(np.diff(np.asarray(psim.plan.walls[a]))))
               if psim.plan.walls is not None else 1.0 / psim.shape[a])
              * L[a] for a in range(3)]
    if min(widths) < rlist:
        raise RuntimeError(
            f"brick decomposition infeasible at the live box: narrowest "
            f"brick {min(widths):.4f} < rlist {rlist:.4f} (box {L}); use "
            f"fewer bricks along the compressed axis")
    n = sd.state.n_local
    spans = [min(1.0, rlist / (L[a] / psim.shape[a])) for a in range(3)]
    dup = float(np.prod([
        max(1.0, (L[a] / psim.shape[a]) * (1 + 2 * spans[a]) / L[a])
        for a in range(3)]))
    psim.grid = CellGrid.plan(
        L, sd.rcut_max, sd.neighbor_deltaR, n,
        psim.plan.local_cap + psim.plan.ghost_cap,
        positions=r_lb, occupancy_factor=dup,
        plan_margin=1.1 if getattr(psim, "_npt_deck", False) else 1.0)
    psim._build_step_fns(geom)
    psim.redistribute()


ParallelSimulation.replan = parallel_replan


def parallel_view(psim):
    """Gather the sharded run into a Simulation-shaped view (sysdef + ss)
    so the single-chip ANALYSIS registry evaluates on multi-chip state
    (the dataExchange/getRemoteData analog: analyses see the full
    gathered system)."""
    from ..core.box import Box
    from ..core.energy import EnergyInfo
    from ..integrators.nglf import StepState

    sd = psim.sysdef
    R, V = _gather_by_gid(psim)
    n = sd.state.n_local
    state = sd.state.replace(
        r=sd.state.r.at[:n].set(jnp.asarray(R, sd.state.r.dtype)),
        v=sd.state.v.at[:n].set(jnp.asarray(V, sd.state.v.dtype)))
    if psim.f is not None:
        # forces gather exactly like positions (same mask/gid rows)
        m = np.asarray(psim.mask)
        gp = np.asarray(psim.fields["gid"])[m]
        g64 = gp[:, 0].astype(np.int64) | (gp[:, 1].astype(np.int64) << 32)
        col_gid = np.asarray(sd.collection.gid, dtype=np.int64)
        pos = {int(g): i for i, g in enumerate(col_gid)}
        idx = np.fromiter((pos[int(g)] for g in g64), dtype=np.int64,
                          count=len(g64))
        Fh = np.zeros((n, 3))
        Fh[idx] = np.asarray(psim.f)[m]
        state = state.replace(
            f=state.f.at[:n].set(jnp.asarray(Fh, state.f.dtype)))
    g = np.asarray(psim.Lv, dtype=np.float64)
    box = (Box.orthorhombic(g, dtype=sd.state.r.dtype) if g.ndim == 1
           else Box.from_h(g, dtype=sd.state.r.dtype))
    ss = StepState(state=state, box=box, energy=EnergyInfo.zero(),
                   loop=jnp.asarray(psim.loop, jnp.int32),
                   time=jnp.asarray((psim.loop - sd.cfg.loop) * sd.cfg.dt
                                    + sd.cfg.time))
    return _CheckpointShim(sd, ss, np.asarray(psim.key))


def parallel_run_analyses(psim, run_dir: str = "."):
    """Build every deck ANALYSIS and run eval + output on the gathered
    state (analysisMaster semantics for the mesh driver)."""
    from ..analysis.registry import build_analysis

    import warnings

    view = parallel_view(psim)
    done = []
    for obj in psim.db.by_class("ANALYSIS"):
        try:
            a = build_analysis(obj.name, obj)
        except Exception as err:
            warnings.warn(f"analysis {obj.name} skipped: {err}")
            continue
        # scalable path: per-device partial accumulation + psum
        # (dataExchange.c analog) when the analysis supports it and the
        # geometry allows; gathered evaluation otherwise
        if hasattr(a, "eval_sharded"):
            try:
                a.eval_sharded(psim)
            except Exception:
                a.eval(view)
        else:
            a.eval(view)
        a.output(view, run_dir)
        done.append(obj.name)
    return done


ParallelSimulation.view = parallel_view
ParallelSimulation.run_analyses = parallel_run_analyses
