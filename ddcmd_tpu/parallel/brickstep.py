"""Sharded MD step over a 3D brick mesh (generalizes parallel/step.py)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..core.groups import velocity_update
from ..nbr.celllist import CellGrid, build_neighbor_list, min_image_geom
from ..objects import units as U
from ..potentials.bonded import bonded_eval
from ..potentials.martini import martini_nonbond
from .bonded_shard import pack_gid, resolve_constraints, resolve_terms
from .brick import AXES, BrickPlan, halo_exchange_3d, migrate_3d

FIELD_KEYS = ("r", "v", "q", "mass", "species", "group", "gid")


def make_brick_mesh(shape, devices=None) -> Mesh:
    devs = np.array(jax.devices() if devices is None else devices)
    return Mesh(devs[: int(np.prod(shape))].reshape(shape), AXES)


def _wrap(r, g):
    """Wrap origin-centered positions back into the (3,) orthorhombic or
    (3,3) triclinic box (back_in_box analog, src/box.c)."""
    if g.ndim == 1:
        return r - g * jnp.round(r / g)
    from ..core.box import inv3x3

    return r - jnp.round(r @ inv3x3(g).T) @ g.T


def _perp_widths(g):
    """Per-axis perpendicular spans (= lengths when orthorhombic): the
    cell/brick width that a one-shell stencil measures against rlist."""
    if g.ndim == 1:
        return g
    from ..core.box import inv3x3

    hin = inv3x3(g)
    return 1.0 / jnp.sqrt(jnp.sum(hin * hin, axis=1))


def _volume(g):
    return jnp.prod(g) if g.ndim == 1 else jnp.abs(jnp.linalg.det(g))


def make_brick_step(mesh: Mesh, plan: BrickPlan, grid: CellGrid, tables,
                    coeffs, dt: float, box_lengths, species_lj_type,
                    n_global: int, bonded_tables=None,
                    field_keys=FIELD_KEYS, chunk_steps: int | None = None,
                    constraint_tables=None, barostat=None,
                    mol_tables=None, force_kind: str = "martini"):
    """barostat: None (fixed box) or dict(P0, beta, tau, T, isotropic,
    n_molecules) -- the NGLFCONSTRAINT Berendsen-style volume change
    (changeVolume, /root/reference/src/nglfconstraint.c:64-85) applied at
    the start of every scanned step with the previous step's psum'd
    virial.  With a barostat the chunk signature grows to
    chunk(fields, mask, f, vir_diag, Lv, key) ->
    (fields, mask, f, vir_diag, Lv, scalars (k,7), overflow); the carried
    Lv is the live box.  With mol_tables (multi-bead molecules) the
    barostat-facing diag in scalars[3:6] is the MOLECULAR virial
    (molecularPressure.c:22-67): each molecule is wholly local on its
    owner (molecule-coherent migration), so the intra-molecular force
    moment is computed locally per owned molecule and psum'd; without it
    the atomic virial is used (identical for single-bead molecules)."""
    Lv_host = np.asarray(box_lengths, dtype=np.float64)
    tmap = jnp.asarray(species_lj_type)
    half = 0.5 * dt
    full_axes = tuple(AXES)
    halo_keys = ("r", "q", "species") + (("gid",) if bonded_tables else ())
    ncells_v = np.asarray(grid.ncells, dtype=np.float64)

    def local_forces_eam(fields, mask, Lv):
        """Sharded two-pass EAM: pass 1 computes local densities from the
        position halo; a SECOND halo ships each ghost's embedding
        derivative dF from its owner (the reference's eam 2-pass
        communication, eam.h/opt variants); pass 2 assembles forces with
        the transposed-density combine rule.  Ghost ordering is identical
        across the two halos (same positions, same staged selection)."""
        from ..potentials.eam import _embedding, _pair_eval

        ghosts, gmask, ov = halo_exchange_3d(
            {k: fields[k] for k in ("r", "species")}, mask, Lv, plan)
        r_ext = jnp.concatenate([fields["r"], ghosts["r"]], axis=0)
        s_ext_ = jnp.concatenate([fields["species"], ghosts["species"]],
                                 axis=0)
        bin_mask = jnp.concatenate([mask, gmask]).astype(r_ext.dtype)
        row_mask = jnp.concatenate(
            [mask, jnp.zeros_like(gmask)]).astype(r_ext.dtype)
        nbr_idx, _, nbr_ov = build_neighbor_list(
            r_ext, bin_mask, Lv, grid, row_mask=row_mask)

        dt_ = r_ext.dtype
        n_pool = r_ext.shape[0]
        sentinel = n_pool
        r_pad = jnp.concatenate([r_ext, jnp.zeros((1, 3), dt_)])
        s_pad = jnp.concatenate([s_ext_, jnp.zeros((1,), s_ext_.dtype)])
        # per-component displacements on orthorhombic boxes: a
        # materialized (N,K,3) intermediate would carry a 3-wide minor dim
        ortho = np.ndim(Lv) == 1
        if ortho:
            d_c = []
            r2 = jnp.zeros(nbr_idx.shape, dt_)
            for c in range(3):
                dc = r_ext[:, c][:, None] - r_pad[:, c][nbr_idx]
                dc = dc - Lv[c] * jnp.round(dc / Lv[c])
                d_c.append(dc)
                r2 = r2 + dc * dc
        else:
            dr = r_ext[:, None, :] - r_pad[nbr_idx]
            dr = min_image_geom(dr, Lv)
            r2 = jnp.sum(dr * dr, axis=-1)
        valid = (nbr_idx != sentinel) & (r2 < tables["rcut2"]) & (r2 > 0)             & (row_mask[:, None] > 0)
        w = valid.astype(dt_)
        r2s = jnp.where(valid, r2, jnp.asarray(1.0, dt_))
        ir2 = 1.0 / r2s
        ir = jnp.sqrt(ir2)
        T = tables["n_species"]
        form = tables["form"]
        sidx = s_ext_.astype(jnp.int32)
        pair_idx = sidx[:, None] * T + s_pad[nbr_idx].astype(jnp.int32)

        e1, p1 = _pair_eval(form, tables["pair"], pair_idx, r2s, ir, ir2,
                            False)
        rho = jnp.sum(p1 * w, axis=1)
        pe_pair = 0.5 * jnp.sum(e1 * w, axis=1)
        F_i, dF = _embedding(form, tables["embed"], sidx, rho)
        F_i = F_i * row_mask
        dF = dF * row_mask

        # halo #2: owners ship dF for the same ghost rows
        n_loc = fields["r"].shape[0]
        g2, gm2, ov2 = halo_exchange_3d(
            {"r": fields["r"], "dF": dF[:n_loc]}, mask, Lv, plan)
        dF_pool = jnp.concatenate([dF[:n_loc], g2["dF"]])

        de, dp = _pair_eval(form, tables["pair"], pair_idx, r2s, ir, ir2,
                            True)
        if T == 1:
            dpT = dp
        else:
            pair_idx_T = s_pad[nbr_idx].astype(jnp.int32) * T + sidx[:, None]
            _, dpT = _pair_eval(form, tables["pair"], pair_idx_T, r2s, ir,
                                ir2, True)
        dF_pad = jnp.concatenate([dF_pool, jnp.zeros((1,), dt_)])
        coef = -(de + dp * dF[:, None] + dpT * dF_pad[nbr_idx]) * w
        if ortho:
            f = jnp.stack([jnp.sum(coef * d_c[c], axis=1)
                           for c in range(3)], axis=1)
            virial = 0.5 * jnp.asarray(
                [[jnp.sum(coef * d_c[a] * d_c[b]) for b in range(3)]
                 for a in range(3)])
        else:
            fij = coef[:, :, None] * dr
            f = jnp.sum(fij, axis=1)
            virial = 0.5 * jnp.einsum("nka,nkb->ab", fij, dr)
        pe = pe_pair + F_i
        e_pot = jnp.sum(pe)
        cell_ok = jnp.all(_perp_widths(Lv) / jnp.asarray(ncells_v, Lv.dtype)
                          >= jnp.asarray(grid.rlist, Lv.dtype))
        return (f[:n_loc], e_pot, virial, pe[:n_loc],
                ov | nbr_ov | ov2 | ~cell_ok)

    def local_forces_martini(fields, mask, Lv):
        ghosts, gmask, ov = halo_exchange_3d(
            {k: fields[k] for k in halo_keys}, mask,
            Lv, plan)
        r_ext = jnp.concatenate([fields["r"], ghosts["r"]], axis=0)
        q_ext = jnp.concatenate([fields["q"], ghosts["q"]], axis=0)
        s_ext = jnp.concatenate([fields["species"], ghosts["species"]], axis=0)
        bin_mask = jnp.concatenate([mask, gmask]).astype(r_ext.dtype)
        row_mask = jnp.concatenate([mask, jnp.zeros_like(gmask)]).astype(r_ext.dtype)
        nbr_idx, _, nbr_ov = build_neighbor_list(
            r_ext, bin_mask, Lv, grid, row_mask=row_mask)
        tidx = tmap[s_ext]
        f, e_pot, virial, pe, _ = martini_nonbond(
            r_ext, q_ext, tidx, row_mask, nbr_idx, Lv, tables)
        n_loc = fields["r"].shape[0]
        if bonded_tables is not None:
            # gid-keyed covalent terms resolved to pool rows on-device
            g64 = pack_gid(jnp.concatenate([fields["gid"], ghosts["gid"]]))
            pmask = jnp.concatenate([mask, gmask])
            bterms = resolve_terms(bonded_tables, g64, pmask, n_loc)
            fb, eb, vb, peb = bonded_eval(r_ext, Lv, bterms,
                                          r_ext.shape[0], r_ext.dtype)
            f = f + fb
            virial = virial + vb
            pe = pe + peb
            # per-particle cancellation BEFORE the device total: the
            # exclusion correction (peb, ~ -1e6/atom for all-atom 1-2
            # pairs) must cancel the nonbond pe on the same rows, not
            # between two huge f32 scalars.  Every bonded term's energy
            # lands exactly-once across the mesh: nonbond pe is zero on
            # ghost rows (row_mask), bonded pe halves live on the term
            # OWNER's pool rows (local or ghost), so the psum over
            # devices counts each half once.
            e_pot = jnp.sum(pe)
        # a shrinking NPT box can drop the cell edge below rlist, which
        # silently breaks the one-shell stencil: flag it as an overflow
        cell_ok = jnp.all(_perp_widths(Lv) / jnp.asarray(ncells_v, Lv.dtype)
                          >= jnp.asarray(grid.rlist, Lv.dtype))
        return f[:n_loc], e_pot, virial, pe[:n_loc], ov | nbr_ov | ~cell_ok

    def local_forces_pairtab(fields, mask, Lv):
        """Tabulated PAIR (function=TableFunction): the piecewise
        polynomial is evaluated per neighbor via pair_lj; halo/energy
        accounting is identical to the martini path (local rows only,
        0.5-per-pair so local-ghost pairs psum to 1 across owners)."""
        from ..potentials.pair import pair_lj

        ghosts, gmask, ov = halo_exchange_3d(
            {k: fields[k] for k in ("r", "species")}, mask, Lv, plan)
        r_ext = jnp.concatenate([fields["r"], ghosts["r"]], axis=0)
        s_ext = jnp.concatenate([fields["species"], ghosts["species"]],
                                axis=0)
        bin_mask = jnp.concatenate([mask, gmask]).astype(r_ext.dtype)
        row_mask = (jnp.concatenate([mask, jnp.zeros_like(gmask)])
                    .astype(r_ext.dtype))
        nbr_idx, _, nbr_ov = build_neighbor_list(
            r_ext, bin_mask, Lv, grid, row_mask=row_mask)
        f, e_pot, virial, pe = pair_lj(r_ext, s_ext, row_mask, nbr_idx,
                                       Lv, tables)
        n_loc = fields["r"].shape[0]
        cell_ok = jnp.all(_perp_widths(Lv) / jnp.asarray(ncells_v, Lv.dtype)
                          >= jnp.asarray(grid.rlist, Lv.dtype))
        return f[:n_loc], e_pot, virial, pe[:n_loc], ov | nbr_ov | ~cell_ok

    local_forces = {"eam": local_forces_eam,
                    "pairtab": local_forces_pairtab}.get(
                        force_kind, local_forces_martini)

    if constraint_tables is not None:
        from ..integrators.constraints import make_constraint_project

        cons_gids = jnp.asarray(constraint_tables["cons_gids"])
        project_all = make_constraint_project(
            constraint_tables["cons_pairs"], constraint_tables["cons_dist"],
            jnp.float32, cons_gids.shape[1], box_lengths=Lv_host)

    def apply_constraints(fields, mask, v, mode_front, Lv):
        """Per-residue velocity projection on LOCALLY-owned groups
        (gid-resolved each call; molecule-coherent migration keeps every
        owned group's atoms local -- no communication)."""
        dtc = v.dtype
        n_loc = v.shape[0]
        g64 = pack_gid(fields["gid"])
        atoms, gw = resolve_constraints(cons_gids, g64, mask, n_loc)
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
        return v_buf[:n_loc]

    if mol_tables is not None:
        mol_gids = jnp.asarray(mol_tables["mol_gids"])

    def _mol_corr(fields, mask, f, Lv):
        """Diagonal molecular-virial correction, summed over molecules
        owned by this device: corr_a = sum_mol sum_i d_ia f_ia with d the
        min-imaged offset from the molecule's COM.  Exactly-once across
        the mesh (a molecule resolves fully-local only on its owner)."""
        dt_ = f.dtype
        n_loc = f.shape[0]
        g64 = pack_gid(fields["gid"])
        atoms, gw = resolve_constraints(mol_gids, g64, mask, n_loc)
        r_ext = jnp.concatenate([fields["r"].astype(dt_),
                                 jnp.zeros((1, 3), dt_)])
        f_ext = jnp.concatenate([f, jnp.zeros((1, 3), dt_)])
        m_ext = jnp.concatenate([fields["mass"].astype(dt_),
                                 jnp.zeros((1,), dt_)])
        rm, fm, mm = r_ext[atoms], f_ext[atoms], m_ext[atoms]
        am = (atoms < n_loc).astype(dt_)
        mm = mm * am
        M = jnp.maximum(mm.sum(1, keepdims=True), 1e-30)
        d = rm - rm[:, :1]
        d = min_image_geom(d, Lv)                        # nearestImage
        com = (mm[:, :, None] * d).sum(1, keepdims=True) / M[:, :, None]
        d = (d - com) * am[:, :, None]
        return jnp.einsum("m,mia,mia->a", gw.astype(dt_), d, fm)

    def _step(fields, mask, f_prev, key, Lv):
        for ax in full_axes:
            key = jax.random.fold_in(key, jax.lax.axis_index(ax))
        k1, k2 = jax.random.split(key)
        fmask = mask.astype(fields["r"].dtype)

        v = velocity_update("front", fields["v"], f_prev, fields["mass"],
                            fields["group"], coeffs, half, k1, mask)
        if constraint_tables is not None:
            v = apply_constraints(fields, mask, v, True, Lv)
        r = fields["r"] + dt * v
        r = _wrap(r, Lv)
        fields = dict(fields, r=r, v=v)

        f, e_pot, virial, pe, overflow = local_forces(fields, mask, Lv)

        v = velocity_update("back", fields["v"], f, fields["mass"],
                            fields["group"], coeffs, half, k2, mask)
        if constraint_tables is not None:
            v = apply_constraints(fields, mask, v, False, Lv)
        fields = dict(fields, v=v)

        mv = (fields["mass"] * fmask)[:, None] * v
        tion = mv.T @ v
        rk = 0.5 * jnp.trace(tion)

        e_pot = jax.lax.psum(e_pot, full_axes)
        rk = jax.lax.psum(rk, full_axes)
        virial = jax.lax.psum(virial, full_axes)
        overflow = jax.lax.pmax(overflow.astype(jnp.int32), full_axes)
        vd = jnp.stack([virial[0, 0], virial[1, 1], virial[2, 2]])
        if mol_tables is not None:
            vd = vd - jax.lax.psum(_mol_corr(fields, mask, f, Lv),
                                   full_axes)
        scalars = jnp.stack([e_pot, rk, jnp.trace(virial),
                             vd[0], vd[1], vd[2], _volume(Lv)])
        return fields, f, scalars, overflow

    def step(fields, mask, f_prev, key):
        Lv = jnp.asarray(Lv_host, dtype=fields["r"].dtype)
        return _step(fields, mask, f_prev, key, Lv)

    def first_forces(fields, mask, key):
        del key
        Lv = jnp.asarray(Lv_host, dtype=fields["r"].dtype)
        f, e_pot, virial, pe, overflow = local_forces(fields, mask, Lv)
        e_pot = jax.lax.psum(e_pot, full_axes)
        virial = jax.lax.psum(virial, full_axes)
        if mol_tables is not None:
            # seed the barostat with the molecular virial diag too
            corr = jax.lax.psum(_mol_corr(fields, mask, f, Lv), full_axes)
            virial = virial - jnp.diag(corr)
        return f, e_pot, virial, jax.lax.pmax(overflow.astype(jnp.int32), full_axes)

    def _migrate(fields, mask, f, Lv):
        # forces ride along so the next front half-kick sees row-coherent
        # f after the migration permutation (stale rows = wrong kicks)
        packed, new_mask, ov = migrate_3d(dict(fields, f=f), mask, Lv, plan)
        f_new = packed.pop("f")
        return (packed, new_mask, f_new,
                jax.lax.pmax(ov.astype(jnp.int32), full_axes))

    def migrate_fn(fields, mask, f):
        Lv = jnp.asarray(Lv_host, dtype=fields["r"].dtype)
        return _migrate(fields, mask, f, Lv)

    def _lam(vir_diag, Lv):
        """Berendsen per-axis scale from the previous step's virial
        (changeVolume; P = (virial + nmol kB T I)/V with the TARGET T).
        Lv may be (3,) lengths or a (3,3) h (triclinic): the scale acts
        as r' = diag(lam) r, h' = diag(lam) h -- the same affine volume
        move the reference applies (nglfconstraint.c:64-85 is not
        orthorhombic-specific)."""
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

    def chunk(fields, mask, f_prev, key):
        """`chunk_steps` MD steps + one migration in ONE dispatch (the
        multi-chip analog of the single-chip superchunk scan): host round
        trips amortize over the DDC updateRate cadence."""
        Lv0 = jnp.asarray(Lv_host, dtype=fields["r"].dtype)

        def body(carry, i):
            fields, f, ov = carry
            fields, f, scalars, ov_i = _step(fields, mask, f,
                                             jax.random.fold_in(key, i), Lv0)
            return (fields, f, ov | ov_i), scalars

        (fields, f, ov), scal = jax.lax.scan(
            body, (fields, f_prev, jnp.zeros((), jnp.int32)),
            jnp.arange(chunk_steps))
        fields, mask, f, ov_m = _migrate(fields, mask, f, Lv0)
        return fields, mask, f, scal, ov | ov_m

    # narrowest brick as a FRACTION of its axis: the walls are clamped to
    # >= 1.05*rlist/L only at construction, but the barostat can shrink
    # the live box past that margin mid-chunk, breaking the 1-hop halo
    # assumption (a brick narrower than rlist needs 2-hop ghosts); guard
    # it in the overflow flag like cell_ok guards the cell grid
    _min_brick_frac = np.array(
        [(float(np.min(np.diff(np.asarray(plan.walls[a]))))
          if plan.walls is not None else 1.0 / plan.shape[a])
         for a in range(3)], dtype=np.float64)

    def chunk_npt(fields, mask, f_prev, vir_diag, Lv, key):
        """NPT chunk: the barostat rescales Lv and positions at the start
        of every scanned step from the previous step's virial diagonal."""
        def body(carry, i):
            fields, f, vird, Lv, ov = carry
            lam = _lam(vird, Lv)
            # h' = diag(lam) h: for a (3,3) h scale the ROWS (Cartesian
            # components); for (3,) lengths this is elementwise
            Lv = lam[:, None] * Lv if Lv.ndim == 2 else Lv * lam
            brick_ok = jnp.all(
                jnp.asarray(_min_brick_frac, Lv.dtype) * _perp_widths(Lv)
                >= jnp.asarray(plan.rlist, Lv.dtype))
            ov = ov | (~brick_ok).astype(ov.dtype)
            fields = dict(fields, r=fields["r"] * lam[None, :])
            fields, f, scalars, ov_i = _step(fields, mask, f,
                                             jax.random.fold_in(key, i), Lv)
            vird = scalars[3:6]
            return (fields, f, vird, Lv, ov | ov_i), scalars

        (fields, f, vir_diag, Lv, ov), scal = jax.lax.scan(
            body, (fields, f_prev, vir_diag, Lv, jnp.zeros((), jnp.int32)),
            jnp.arange(chunk_steps))
        fields, mask, f, ov_m = _migrate(fields, mask, f, Lv)
        return fields, mask, f, vir_diag, Lv, scal, ov | ov_m

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
        else:
            chunk_sharded = jax.jit(jax.shard_map(
                chunk, mesh=mesh,
                in_specs=(pspec_fields, PS, PS, P()),
                out_specs=(pspec_fields, PS, PS, P(), P()),
                check_vma=False))
        return step_sharded, first_sharded, migrate_sharded, chunk_sharded
    return step_sharded, first_sharded, migrate_sharded
