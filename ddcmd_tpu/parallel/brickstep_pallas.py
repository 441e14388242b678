"""Sharded MD step with the pallas pair kernel per device.

The multi-chip analog of the reference's production choreography
(/root/reference/src/masters.c:389-403): device-resident state, the
fastest pair engine per device, communication tables rebuilt at the DDC
updateRate and per-step halos against the cached tables --

  chunk (ONE dispatch, mirroring the single-chip superchunk):
    rebuild:  wrap -> staged halo EXCHANGE with routing capture
              (ddcSendRecvTables) -> full neighbor list of the LOCAL
              rows over the local+ghost pool (nbr/celllist) -> resolve
              gid-keyed bonded/constraint/molecule tables once
    k steps:  front kick -> drift (unwrapped) -> position halo REFRESH
              along the frozen routing (ddcUpdate) -> pallas pair kernel
              (ops/pallas_nlist) on the local rows -> bonded terms ->
              reverse force/energy reduce (ddcUpdateForce) -> back kick
    migrate:  staged 1-hop migration (ddcAssignment cadence)

Each device evaluates the pairs of its own rows (full list, half of each
pair's energy and virial), so a local-ghost pair is counted once across
the mesh with no reverse reduce of pair forces; bonded terms still
reverse-reduce their ghost-row shares.

Same call signatures as parallel/brickstep.make_brick_step so
ParallelSimulation can switch engines transparently.  Constraints,
Berendsen barostat (NPT chunk), molecular virial and group kicks reuse
the brickstep machinery.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P  # noqa: F401

from ..core.groups import velocity_update
from ..nbr.celllist import CellGrid, build_neighbor_list
from ..objects import units as U
from ..ops.pallas_nlist import nlist_pair_eval
from ..potentials.bonded import bonded_eval
from .bonded_shard import (pack_gid, resolve_batched, resolve_constraints,
                           resolve_terms)
from .brick import (AXES, BrickPlan, halo_exchange_3d, halo_reduce_3d,
                    halo_refresh_3d, migrate_3d, walls_span_minmax)
from .brickstep import FIELD_KEYS, _perp_widths, _volume, _wrap


def make_brick_step_pallas(mesh: Mesh, plan: BrickPlan, grid: CellGrid,
                           tables, coeffs, dt: float, box_lengths,
                           species_lj_type, n_global: int,
                           bonded_tables=None, field_keys=FIELD_KEYS,
                           chunk_steps: int | None = None,
                           constraint_tables=None, barostat=None,
                           mol_tables=None, coulomb: bool = True,
                           interpret: bool = False, excl: bool = False):
    """Build (step, first, migrate[, chunk]) sharded functions running
    the pallas kernel per device.  `grid` is the global cell grid the
    pool's neighbor lists are binned on.  Orthorhombic boxes; uniform OR
    load-balanced (tensor/ORCB walls) bricks.  Voronoi decompositions
    stay on the nlist engine; ParallelSimulation gates accordingly.
    interpret=True runs the kernel on the CPU (tests)."""
    Lv_host = np.asarray(box_lengths, dtype=np.float64)
    assert Lv_host.ndim == 1, "pallas brick step is orthorhombic-only"
    assert plan.voronoi is None, "pallas brick step needs brick walls"
    ncells_v = np.asarray(grid.ncells, dtype=np.float64)
    tmap = jnp.asarray(species_lj_type)
    half = 0.5 * dt
    full_axes = tuple(AXES)
    halo_keys = ("r", "q", "species") + (
        ("gid",) if (bonded_tables is not None
                     or (constraint_tables is not None
                         and constraint_tables.get("templates") is not None))
        else ())
    if excl:
        # in-kernel exclusion channels (run/forces._excl_channels) ride
        # a migrating (n, 2) field and the halo exchange -- ghosts carry
        # their channels so excluded pairs mask on every owner
        halo_keys = halo_keys + ("excl",)
        assert "excl" in field_keys, "excl=True needs the 'excl' field"

    cons_templates = None
    if constraint_tables is not None:
        from ..integrators.constraints import make_constraint_project

        cons_gids = jnp.asarray(constraint_tables["cons_gids"])
        project_all = make_constraint_project(
            constraint_tables["cons_pairs"], constraint_tables["cons_dist"],
            jnp.float32, cons_gids.shape[1], box_lengths=Lv_host)
        # template-batched single-bond RATTLE (r5): per-type lane math
        # replaces the per-group extended-buffer projection
        cons_templates = constraint_tables.get("templates")

    if mol_tables is not None:
        mol_gids = jnp.asarray(mol_tables["mol_gids"])

    # -- rebuild: tables + routing + slot permutation (once per chunk) --

    def _rebuild(fields, mask, Lv):
        r0 = _wrap(fields["r"], Lv)
        fields = dict(fields, r=r0)
        ghosts, gmask, ov, routing = halo_exchange_3d(
            {k: fields[k] for k in halo_keys}, mask, Lv, plan,
            with_routing=True)
        pool_mask = jnp.concatenate([mask, gmask])
        q_pool = jnp.concatenate([fields["q"], ghosts["q"]])
        s_pool = jnp.concatenate([fields["species"], ghosts["species"]])
        tidx = tmap[s_pool]
        r_pool0 = jnp.concatenate([fields["r"], ghosts["r"]])
        row_mask = jnp.concatenate([mask, jnp.zeros_like(gmask)])
        nbr, _, ov_b = build_neighbor_list(
            r_pool0, pool_mask.astype(r0.dtype), Lv, grid,
            row_mask=row_mask.astype(r0.dtype))
        bterms = None
        bat = None
        g64 = None
        if "gid" in halo_keys:
            g64 = pack_gid(jnp.concatenate([fields["gid"], ghosts["gid"]]))
        if bonded_tables is not None:
            bplan = bonded_tables.get("__batched__")
            left = {k: v for k, v in bonded_tables.items()
                    if k != "__batched__"}
            if bplan is not None:
                # residue-template batched terms resolve per TYPE (one
                # searchsorted per chunk); junction/CMAP leftovers keep
                # the per-term resolver
                bat = resolve_batched(bplan, g64, pool_mask,
                                      fields["r"].shape[0])
            if any(k.endswith("_gids") for k in left):
                bterms = resolve_terms(left, g64, pool_mask,
                                       fields["r"].shape[0])
        cons = None
        cons_bat = None
        if constraint_tables is not None:
            if cons_templates is not None:
                # per-TYPE instance resolution against the POOL gids
                # (owned instances are wholly local by molecule
                # coherence; disowned rows weight to exact no-ops).
                # Inverse masses are static within a chunk: gather them
                # HERE, not in every projection (2x/step)
                n_l = fields["r"].shape[0]
                rmask = jnp.where(
                    mask, 1.0 / jnp.maximum(fields["mass"], 1e-30),
                    0.0).astype(jnp.float32)
                cons_bat = []
                for tp, (rows, w) in zip(
                        cons_templates[0]["types"],
                        resolve_batched(cons_templates[0], g64, pool_mask,
                                        n_l)):
                    rcl = jnp.clip(rows, 0, n_l - 1)
                    rm2 = rmask[rcl].reshape(tp["M"], tp["A"]).T
                    cons_bat.append((rows, w, rm2))
            else:
                g64l = pack_gid(fields["gid"])
                cons = resolve_constraints(cons_gids, g64l, mask,
                                           fields["r"].shape[0])
        mol = None
        if mol_tables is not None:
            g64l = pack_gid(fields["gid"])
            atoms, gw = resolve_constraints(mol_gids, g64l, mask,
                                            fields["r"].shape[0])
            # masses and validity are static within a chunk: gather once
            dt_ = fields["r"].dtype
            m_ext = jnp.concatenate([fields["mass"].astype(dt_),
                                     jnp.zeros((1,), dt_)])
            am = (atoms < fields["r"].shape[0]).astype(dt_)
            mm = m_ext[atoms] * am
            Msum = jnp.maximum(mm.sum(1, keepdims=True), 1e-30)
            mol = (atoms, gw, mm, am, Msum)
        ex_pool = None
        if excl:
            ex_pool = jnp.concatenate([fields["excl"], ghosts["excl"]])
        rb = dict(routing=routing, nbr=nbr,
                  q_pool=q_pool, tidx=tidx, pool_mask=pool_mask,
                  bterms=bterms, bat=bat, cons=cons, cons_bat=cons_bat,
                  mol=mol, ex_pool=ex_pool)
        return fields, rb, ov | ov_b

    # -- per-step pieces -----------------------------------------------

    def _apply_constraints_batched(fields, mask, v, mode_front, Lv,
                                   cons_bat):
        """Template-batched single-bond RATTLE on lane-dense (M,) math
        (integrators.constraints.build_constraint_templates); disowned
        instances write back their original velocities (exact no-op)."""
        plan_t, project = cons_templates
        dtc = v.dtype
        r_loc = fields["r"].astype(dtc)
        n_l = v.shape[0]
        for tp, (rows, w, rm2) in zip(plan_t["types"], cons_bat):
            M, A = tp["M"], tp["A"]
            rcl = jnp.clip(rows, 0, n_l - 1)
            rb3 = r_loc[rcl].reshape(M, A, 3).transpose(2, 1, 0)
            vb3 = v[rcl].reshape(M, A, 3).transpose(2, 1, 0)
            vb3 = project(rb3, vb3, rm2, w, tp["d2"], tp["li"], tp["lj"],
                          dt, mode_front, Lv)
            vout = vb3.transpose(2, 1, 0).reshape(M * A, 3)
            v = v.at[rows].set(vout, mode="drop")
        return v

    def _apply_constraints(fields, mask, v, mode_front, Lv, cons):
        atoms, gw = cons
        dtc = v.dtype
        n_l = v.shape[0]
        r_ext = jnp.concatenate([fields["r"].astype(dtc),
                                 jnp.zeros((1, 3), dtc)])
        v_ext = jnp.concatenate([v, jnp.zeros((1, 3), dtc)])
        rm = jnp.where(mask, 1.0 / jnp.maximum(fields["mass"], 1e-30),
                       0.0).astype(dtc)
        rm_ext = jnp.concatenate([rm, jnp.zeros((1,), dtc)])
        v_new = project_all(r_ext, v_ext, rm_ext, atoms, gw, dt,
                            jnp.asarray(mode_front), L=Lv)
        v_buf = jnp.concatenate([v, jnp.zeros((1, 3), dtc)])
        v_buf = v_buf.at[atoms.reshape(-1)].set(v_new.reshape(-1, 3))
        return v_buf[:n_l]

    def _mol_corr(fields, mask, f, Lv, mol):
        """Diagonal molecular-virial correction over owned molecules
        (molecularPressure.c:22-67; see brickstep._mol_corr)."""
        from ..nbr.celllist import min_image_geom

        atoms, gw, mm, am, Msum = mol
        dt_ = f.dtype
        r_ext = jnp.concatenate([fields["r"].astype(dt_),
                                 jnp.zeros((1, 3), dt_)])
        f_ext = jnp.concatenate([f, jnp.zeros((1, 3), dt_)])
        rm, fm = r_ext[atoms], f_ext[atoms]
        d = rm - rm[:, :1]
        d = min_image_geom(d, Lv)
        com = (mm[:, :, None] * d).sum(1, keepdims=True) / Msum[:, :, None]
        d = (d - com) * am[:, :, None]
        return jnp.einsum("m,mia,mia->a", gw.astype(dt_), d, fm)

    def _forces(r_local, rb, Lv):
        """Pair (kernel) + bonded forces, reverse-reduced to local rows.
        Returns (f (n_loc,3), pe (n_loc,), virial (3,3) device share,
        overflow)."""
        r_pool = halo_refresh_3d(r_local, rb["routing"], plan)
        f_pool, _, virial, pe_pool = nlist_pair_eval(
            r_pool, rb["q_pool"], rb["tidx"], rb["pool_mask"], rb["nbr"],
            Lv, tables, coulomb=coulomb, excl_vals=rb["ex_pool"],
            interpret=interpret)
        if rb["bat"] is not None:
            from ..potentials.bonded_batch import batched_bonded_eval

            fb, eb, vb, peb = batched_bonded_eval(
                r_pool, Lv, bonded_tables["__batched__"],
                r_pool.shape[0], jnp.float32, resolved=rb["bat"])
            f_pool = f_pool + fb
            pe_pool = pe_pool + peb
            virial = virial + vb
        if rb["bterms"] is not None:
            fb, eb, vb, peb = bonded_eval(r_pool, Lv, rb["bterms"],
                                          r_pool.shape[0], jnp.float32)
            f_pool = f_pool + fb
            pe_pool = pe_pool + peb
            virial = virial + vb
        n_l = r_local.shape[0]
        fp4 = jnp.concatenate([f_pool, pe_pool[:, None]], axis=1)
        red = halo_reduce_3d(fp4, rb["routing"], plan, n_l)
        # the live cell edge must stay >= rlist (NPT shrink guard, same
        # as brickstep's cell_ok)
        cell_ok = jnp.all(_perp_widths(Lv) / jnp.asarray(ncells_v, Lv.dtype)
                          >= jnp.asarray(grid.rlist, Lv.dtype))
        return red[:, :3], red[:, 3], virial, ~cell_ok

    def _coul_self(q_pool, pool_mask, n_l):
        """Reaction-field self-energy on LOCAL rows (bioMartini.c:1035):
        -1/2 q^2 keR crf per particle, exactly-once across the mesh."""
        if not coulomb:
            return 0.0
        ql = q_pool[:n_l]
        w = pool_mask[:n_l].astype(ql.dtype)
        return jnp.sum(-0.5 * ql * ql * w) * tables["keR"] * tables["crf"]

    def _step_body(fields, mask, f_prev, key, Lv, rb):
        for ax in full_axes:
            key = jax.random.fold_in(key, jax.lax.axis_index(ax))
        k1, k2 = jax.random.split(key)
        fmask = mask.astype(fields["r"].dtype)

        v = velocity_update("front", fields["v"], f_prev, fields["mass"],
                            fields["group"], coeffs, half, k1, mask)
        if rb["cons_bat"] is not None:
            v = _apply_constraints_batched(fields, mask, v, True, Lv,
                                           rb["cons_bat"])
        elif rb["cons"] is not None:
            v = _apply_constraints(fields, mask, v, True, Lv, rb["cons"])
        r = fields["r"] + dt * v                       # unwrapped in-chunk
        fields = dict(fields, r=r, v=v)

        f, pe, virial, ov_c = _forces(r, rb, Lv)
        n_l = r.shape[0]
        e_pot = jnp.sum(pe) + _coul_self(rb["q_pool"], rb["pool_mask"], n_l)

        v = velocity_update("back", fields["v"], f, fields["mass"],
                            fields["group"], coeffs, half, k2, mask)
        if rb["cons_bat"] is not None:
            v = _apply_constraints_batched(fields, mask, v, False, Lv,
                                           rb["cons_bat"])
        elif rb["cons"] is not None:
            v = _apply_constraints(fields, mask, v, False, Lv, rb["cons"])
        fields = dict(fields, v=v)

        mv = (fields["mass"] * fmask)[:, None] * v
        tion = mv.T @ v
        rk = 0.5 * jnp.trace(tion)

        e_pot = jax.lax.psum(e_pot, full_axes)
        rk = jax.lax.psum(rk, full_axes)
        virial = jax.lax.psum(virial, full_axes)
        overflow = jax.lax.pmax(ov_c.astype(jnp.int32), full_axes)
        vd = jnp.stack([virial[0, 0], virial[1, 1], virial[2, 2]])
        if rb["mol"] is not None:
            vd = vd - jax.lax.psum(
                _mol_corr(fields, mask, f, Lv, rb["mol"]), full_axes)
        scalars = jnp.stack([e_pot, rk, jnp.trace(virial),
                             vd[0], vd[1], vd[2], _volume(Lv)])
        return fields, f, scalars, overflow

    # -- public entry points (same shapes as brickstep) -----------------

    def step(fields, mask, f_prev, key):
        Lv = jnp.asarray(Lv_host, dtype=fields["r"].dtype)
        fields, rb, ov_r = _rebuild(fields, mask, Lv)
        fields, f, scalars, ov = _step_body(fields, mask, f_prev, key,
                                            Lv, rb)
        ov = ov | jax.lax.pmax(ov_r.astype(jnp.int32), full_axes)
        return fields, f, scalars, ov

    def first_forces(fields, mask, key):
        del key
        Lv = jnp.asarray(Lv_host, dtype=fields["r"].dtype)
        fields, rb, ov_r = _rebuild(fields, mask, Lv)
        f, pe, virial, ov_c = _forces(fields["r"], rb, Lv)
        e_pot = jnp.sum(pe) + _coul_self(rb["q_pool"], rb["pool_mask"],
                                         fields["r"].shape[0])
        e_pot = jax.lax.psum(e_pot, full_axes)
        virial = jax.lax.psum(virial, full_axes)
        if rb["mol"] is not None:
            corr = jax.lax.psum(
                _mol_corr(fields, mask, f, Lv, rb["mol"]), full_axes)
            virial = virial - jnp.diag(corr)
        ov = jax.lax.pmax((ov_r | ov_c).astype(jnp.int32), full_axes)
        return f, e_pot, virial, ov

    def _migrate(fields, mask, f, Lv):
        packed, new_mask, ov = migrate_3d(dict(fields, f=f), mask, Lv, plan)
        f_new = packed.pop("f")
        return (packed, new_mask, f_new,
                jax.lax.pmax(ov.astype(jnp.int32), full_axes))

    def migrate_fn(fields, mask, f):
        Lv = jnp.asarray(Lv_host, dtype=fields["r"].dtype)
        return _migrate(fields, mask, f, Lv)

    def _lam(vir_diag, Lv):
        """Berendsen per-axis scale (changeVolume,
        /root/reference/src/nglfconstraint.c:64-85); see brickstep."""
        dtb = Lv.dtype
        vol = _volume(Lv)
        nkt = barostat["n_molecules"] * barostat["T"] * U.kB
        p = (vir_diag.astype(dtb) + nkt) / vol - barostat["P0"]
        btt = barostat["beta"] * dt / barostat["tau"]
        if barostat.get("isotropic"):
            piso = jnp.sum(p) / 3.0
            return jnp.cbrt(1.0 + piso * btt) * jnp.ones(3, dtb)
        pxx = 0.5 * (p[0] + p[1])
        return jnp.cbrt(1.0 + jnp.stack([pxx, pxx, p[2]]) * btt)

    # NARROWEST brick span per axis (walls-aware): the NPT shrink guard
    # must hold for every device
    _min_brick_frac = walls_span_minmax(plan.walls, plan.shape)[0]

    def chunk(fields, mask, f_prev, key):
        Lv0 = jnp.asarray(Lv_host, dtype=fields["r"].dtype)
        fields, rb, ov_r = _rebuild(fields, mask, Lv0)

        def body(carry, i):
            fields, f, ov = carry
            fields, f, scalars, ov_i = _step_body(
                fields, mask, f, jax.random.fold_in(key, i), Lv0, rb)
            return (fields, f, ov | ov_i), scalars

        (fields, f, ov), scal = jax.lax.scan(
            body, (fields, f_prev,
                   jax.lax.pmax(ov_r.astype(jnp.int32), full_axes)),
            jnp.arange(chunk_steps))
        fields, mask, f, ov_m = _migrate(fields, mask, f, Lv0)
        return fields, mask, f, scal, ov | ov_m

    def chunk_npt(fields, mask, f_prev, vir_diag, Lv, key):
        """NPT chunk: the barostat rescales Lv and positions at the start
        of each scanned step; the frozen fractional cell grid and halo
        tables stretch affinely with the box (guards flag a shrink past
        the rlist margins for the host replan ladder)."""
        fields, rb, ov_r = _rebuild(fields, mask, Lv)

        def body(carry, i):
            fields, f, vird, Lv, ov = carry
            lam = _lam(vird, Lv)
            Lv = Lv * lam
            brick_ok = jnp.all(
                jnp.asarray(_min_brick_frac, Lv.dtype) * _perp_widths(Lv)
                >= jnp.asarray(plan.rlist, Lv.dtype))
            ov = ov | (~brick_ok).astype(ov.dtype)
            fields = dict(fields, r=fields["r"] * lam[None, :])
            fields, f, scalars, ov_i = _step_body(
                fields, mask, f, jax.random.fold_in(key, i), Lv, rb)
            vird = scalars[3:6]
            return (fields, f, vird, Lv, ov | ov_i), scalars

        (fields, f, vir_diag, Lv, ov), scal = jax.lax.scan(
            body, (fields, f_prev, vir_diag, Lv,
                   jax.lax.pmax(ov_r.astype(jnp.int32), full_axes)),
            jnp.arange(chunk_steps))
        fields, mask, f, ov_m = _migrate(fields, mask, f, Lv)
        return fields, mask, f, vir_diag, Lv, scal, ov | ov_m

    # -- superchunk: many (rebuild + k steps + migrate) cycles in ONE
    # dispatch, amortizing the host round trip the way the single-device
    # superchunk does; FREEZES on overflow so no corrupted
    # physics escapes a dispatch (the host rolls back and replans)

    def superchunk(n_super: int):
        def run(fields, mask, f_prev, key):
            def body(carry, j):
                fields, mask, f, ov = carry

                def live(c):
                    fields, mask, f, _ = c
                    fields, mask, f, scal, ov2 = chunk(
                        fields, mask, f, jax.random.fold_in(key, j))
                    return (fields, mask, f, ov2), scal

                def frozen(c):
                    return c, jnp.zeros((chunk_steps, 7), jnp.float32)

                (fields, mask, f, ov2), scal = jax.lax.cond(
                    ov > 0, frozen, live, (fields, mask, f, ov))
                return (fields, mask, f, ov | ov2), scal

            (fields, mask, f, ov), scal = jax.lax.scan(
                body, (fields, mask, f_prev, jnp.zeros((), jnp.int32)),
                jnp.arange(n_super))
            return fields, mask, f, scal.reshape(-1, 7), ov
        return run

    def superchunk_npt(n_super: int):
        def run(fields, mask, f_prev, vir_diag, Lv, key):
            def body(carry, j):
                fields, mask, f, vird, Lv, ov = carry

                def live(c):
                    fields, mask, f, vird, Lv, _ = c
                    fields, mask, f, vird, Lv, scal, ov2 = chunk_npt(
                        fields, mask, f, vird, Lv,
                        jax.random.fold_in(key, j))
                    return (fields, mask, f, vird, Lv, ov2), scal

                def frozen(c):
                    return c, jnp.zeros((chunk_steps, 7), jnp.float32)

                (fields, mask, f, vird, Lv, ov2), scal = jax.lax.cond(
                    ov > 0, frozen, live,
                    (fields, mask, f, vird, Lv, ov))
                return (fields, mask, f, vird, Lv, ov | ov2), scal

            (fields, mask, f, vir_diag, Lv, ov), scal = jax.lax.scan(
                body,
                (fields, mask, f_prev, vir_diag, Lv,
                 jnp.zeros((), jnp.int32)),
                jnp.arange(n_super))
            return fields, mask, f, vir_diag, Lv, scal.reshape(-1, 7), ov
        return run

    pspec_fields = {k: P(("bx", "by", "bz")) for k in field_keys}
    PS = P(("bx", "by", "bz"))

    step_sharded = jax.jit(jax.shard_map(
        step, mesh=mesh,
        in_specs=(pspec_fields, PS, PS, P()),
        out_specs=(pspec_fields, PS, P(), P()),
        check_vma=False))
    first_sharded = jax.jit(jax.shard_map(
        first_forces, mesh=mesh,
        in_specs=(pspec_fields, PS, P()),
        out_specs=(PS, P(), P(), P()),
        check_vma=False))
    migrate_sharded = jax.jit(jax.shard_map(
        migrate_fn, mesh=mesh,
        in_specs=(pspec_fields, PS, PS),
        out_specs=(pspec_fields, PS, PS, P()),
        check_vma=False))
    if chunk_steps:
        if barostat is not None:
            chunk_sharded = jax.jit(jax.shard_map(
                chunk_npt, mesh=mesh,
                in_specs=(pspec_fields, PS, PS, P(), P(), P()),
                out_specs=(pspec_fields, PS, PS, P(), P(), P(), P()),
                check_vma=False))

            def make_super(n_super):
                return jax.jit(jax.shard_map(
                    superchunk_npt(n_super), mesh=mesh,
                    in_specs=(pspec_fields, PS, PS, P(), P(), P()),
                    out_specs=(pspec_fields, PS, PS, P(), P(), P(), P()),
                    check_vma=False))
        else:
            chunk_sharded = jax.jit(jax.shard_map(
                chunk, mesh=mesh,
                in_specs=(pspec_fields, PS, PS, P()),
                out_specs=(pspec_fields, PS, PS, P(), P()),
                check_vma=False))

            def make_super(n_super):
                return jax.jit(jax.shard_map(
                    superchunk(n_super), mesh=mesh,
                    in_specs=(pspec_fields, PS, PS, P()),
                    out_specs=(pspec_fields, PS, PS, P(), P()),
                    check_vma=False))
        chunk_sharded.make_super = make_super
        return step_sharded, first_sharded, migrate_sharded, chunk_sharded
    return step_sharded, first_sharded, migrate_sharded
