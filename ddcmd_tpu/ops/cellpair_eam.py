"""Cell-blocked EAM: the two-pass embedded-atom evaluation on the same
dense cell-block layout as the nonbond engine (ops/cellpair.py).

Pass 1 accumulates densities rho_i and pair energies per slot over the
27-stencil blocks; the embedding F(rho), dF/drho is evaluated per slot;
pass 2 sweeps the same blocks again with coefficients
(dphi + (dF_i + dF_j) drho)/r (eam.c:166-190 combine rule).  dF values
are re-blocked exactly like positions, so both passes are pure
batched-matmul + elementwise sweeps -- no scatter, no per-pair gather.

Functional forms are shared with the (N,K)-list path
(potentials.eam._pair_eval/_embedding), which stays as the validation
reference.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..potentials.eam import _embedding, _pair_eval
from .cellpair import CellBlockGrid, block_geometry


def eam_cellblock_eval(r, sidx, fmask, perm, box_geom,
                       grid: CellBlockGrid, tables):
    """Forces/energy/virial/per-particle pe for EAM on cell blocks.

    box_geom: (3,) lengths or (3,3) h (triclinic).  Physics identical to
    potentials.eam.eam_eval (validated by parity test); tables from
    eam_device_tables."""
    n_pad = r.shape[0]
    sentinel = n_pad
    dt = r.dtype
    ncell, cap = grid.ncell, grid.cap
    S = grid.n_stencil
    T = tables["n_species"]
    form = tables["form"]

    r_ext = jnp.concatenate([r, jnp.zeros((1, 3), dtype=dt)], axis=0)
    s_ext = jnp.concatenate([sidx, jnp.zeros((1,), dtype=sidx.dtype)], axis=0)

    P = r_ext[perm].reshape(ncell, cap, 3)
    Pt = s_ext[perm].reshape(ncell, cap)
    Pv = (perm != sentinel).reshape(ncell, cap) & \
        (jnp.concatenate([fmask, jnp.zeros(1, fmask.dtype)])[perm] > 0
         ).reshape(ncell, cap)

    stencil = jnp.asarray(grid.stencil_cells)
    shift, centers = block_geometry(grid, box_geom, dt)

    Q = P[stencil] + shift[:, :, None, :]
    # cell-centered coordinates (see cellpair.py: f32 matmul cancellation)
    Pc = P - centers[:, None, :]
    Q = (Q - centers[:, None, None, :]).reshape(ncell, S * cap, 3)
    Qt = Pt[stencil].reshape(ncell, S * cap)
    Qv = Pv[stencil].reshape(ncell, S * cap)

    slot = jnp.arange(ncell * cap, dtype=jnp.int32).reshape(ncell, cap)
    Qslot = slot[stencil].reshape(ncell, S * cap)

    hi = jax.lax.Precision.HIGHEST
    p2 = jnp.sum(Pc * Pc, axis=-1)
    q2 = jnp.sum(Q * Q, axis=-1)
    pq = jnp.einsum("ncd,nsd->ncs", Pc, Q, preferred_element_type=dt,
                    precision=hi)
    d2 = p2[:, :, None] + q2[:, None, :] - 2.0 * pq

    mask = (Pv[:, :, None] & Qv[:, None, :]
            & (slot[:, :, None] != Qslot[:, None, :])
            & (d2 < tables["rcut2"]) & (d2 > 0))
    w = mask.astype(dt)
    d2s = jnp.where(mask, d2, jnp.asarray(1.0, dt))
    ir2 = 1.0 / d2s
    ir = jnp.sqrt(ir2)

    pair_idx = Pt[:, :, None] * T + Qt[:, None, :]

    # pass 1: pair energy + density
    e1, p1 = _pair_eval(form, tables["pair"], pair_idx, d2s, ir, ir2, False)
    rho_slot = jnp.sum(p1 * w, axis=-1)                 # (C,c)
    pe_pair = 0.5 * jnp.sum(e1 * w, axis=-1)

    F_slot, dF_slot = _embedding(form, tables["embed"], Pt, rho_slot)
    wv = Pv.astype(dt)
    F_slot = F_slot * wv
    dF_slot = dF_slot * wv

    # pass 2: block the dF values like positions and combine.  As in the
    # nlist engine, the q-side embedding derivative needs the TRANSPOSED
    # density derivative dp(t_q, t_p) for asymmetric multi-species
    # density tables (eam.c:166-190)
    dFq = dF_slot[stencil].reshape(ncell, S * cap)
    de, dp = _pair_eval(form, tables["pair"], pair_idx, d2s, ir, ir2, True)
    if T == 1:
        dpT = dp
    else:
        pair_idx_T = Qt[:, None, :] * T + Pt[:, :, None]
        _, dpT = _pair_eval(form, tables["pair"], pair_idx_T, d2s, ir, ir2,
                            True)
    coef = (de + dp * dF_slot[:, :, None] + dpT * dFq[:, None, :]) * w

    csum = jnp.sum(coef, axis=-1)
    F = -Pc * csum[:, :, None] + jnp.einsum(
        "ncs,nsd->ncd", coef, Q, preferred_element_type=dt, precision=hi)

    # virial = 0.5 sum_ordered f_ij (x) dr_ij = -0.5 [A - B - B^T + C]
    A = jnp.einsum("nc,ncd,nce->de", csum, Pc, Pc, precision=hi)
    CQ = jnp.einsum("ncs,nsd->ncd", coef, Q, preferred_element_type=dt,
                    precision=hi)
    B = jnp.einsum("ncd,nce->de", Pc, CQ, precision=hi)
    qsum = jnp.sum(coef, axis=1)
    Cm = jnp.einsum("ns,nsd,nse->de", qsum, Q, Q, precision=hi)
    virial = -0.5 * (A - B - B.T + Cm)

    pe_slot = pe_pair + F_slot
    f = jnp.zeros((n_pad + 1, 3), dtype=dt).at[perm].set(
        F.reshape(-1, 3), mode="drop")[:n_pad]
    pe = jnp.zeros((n_pad + 1,), dtype=dt).at[perm].set(
        pe_slot.reshape(-1), mode="drop")[:n_pad]
    return f, jnp.sum(pe_slot), virial, pe


def eam_cellblock_eval_half(r, sidx, fmask, perm, box_geom,
                            grid: CellBlockGrid, tables, back_map):
    """N3L variant of eam_cellblock_eval: `grid` from half_grid(),
    `back_map` from half_back_map().  Pass 1 accumulates densities on
    BOTH pair sides (row sums + permuted column sums); pass 2 mirrors
    the LJ half engine's two-sided force assembly.  Parity-tested
    against the full engine."""
    import jax

    from .cellpair import block_geometry

    n_pad = r.shape[0]
    sentinel = n_pad
    dt = r.dtype
    ncell, cap = grid.ncell, grid.cap
    S = grid.n_stencil
    T = tables["n_species"]
    form = tables["form"]

    r_ext = jnp.concatenate([r, jnp.zeros((1, 3), dtype=dt)], axis=0)
    s_ext = jnp.concatenate([sidx, jnp.zeros((1,), dtype=sidx.dtype)], axis=0)

    P = r_ext[perm].reshape(ncell, cap, 3)
    Pt = s_ext[perm].reshape(ncell, cap)
    Pv = (perm != sentinel).reshape(ncell, cap) & \
        (jnp.concatenate([fmask, jnp.zeros(1, fmask.dtype)])[perm] > 0
         ).reshape(ncell, cap)

    stencil = jnp.asarray(grid.stencil_cells)
    shift, centers = block_geometry(grid, box_geom, dt)

    Q = P[stencil] + shift[:, :, None, :]
    Pc = P - centers[:, None, :]
    Q = (Q - centers[:, None, None, :]).reshape(ncell, S * cap, 3)
    Qt = Pt[stencil].reshape(ncell, S * cap)
    Qv = Pv[stencil].reshape(ncell, S * cap)

    rows = jnp.arange(cap, dtype=jnp.int32)
    lanes = jnp.arange(S * cap, dtype=jnp.int32)
    dup = (lanes[None, :] < cap) & (lanes[None, :] <= rows[:, None])

    hi = jax.lax.Precision.HIGHEST
    p2 = jnp.sum(Pc * Pc, axis=-1)
    q2 = jnp.sum(Q * Q, axis=-1)
    pq = jnp.einsum("ncd,nsd->ncs", Pc, Q, preferred_element_type=dt,
                    precision=hi)
    d2 = p2[:, :, None] + q2[:, None, :] - 2.0 * pq

    mask = (Pv[:, :, None] & Qv[:, None, :] & ~dup[None, :, :]
            & (d2 < tables["rcut2"]) & (d2 > 0))
    w = mask.astype(dt)
    d2s = jnp.where(mask, d2, jnp.asarray(1.0, dt))
    ir2 = 1.0 / d2s
    ir = jnp.sqrt(ir2)

    pair_idx = Pt[:, :, None] * T + Qt[:, None, :]
    bm = jnp.asarray(back_map)

    def fold(blk):        # (C, S, cap, ...) -> (C, cap, ...) via back map
        out = blk[bm[0], 0]
        for s in range(1, S):
            out = out + blk[bm[s], s]
        return out

    # pass 1: densities + pair energy, both sides
    e1, p1 = _pair_eval(form, tables["pair"], pair_idx, d2s, ir, ir2, False)
    rho_p = jnp.sum(p1 * w, axis=-1)                         # (C, cap)
    # the j side receives p(r_ij, t_j, t_i): identical for single-species
    # systems (the common metals case -- the pair evals dominate EAM cost,
    # so skipping the transposed calls is what makes N3L pay off here)
    if T == 1:
        p1T = p1
    else:
        pair_idx_T = Qt[:, None, :] * T + Pt[:, :, None]
        _, p1T = _pair_eval(form, tables["pair"], pair_idx_T, d2s, ir, ir2,
                            False)
    rho_q = fold(jnp.sum(p1T * w, axis=1).reshape(ncell, S, cap))
    rho_slot = rho_p + rho_q
    pe_pair_p = 0.5 * jnp.sum(e1 * w, axis=-1)
    pe_pair_q = fold((0.5 * jnp.sum(e1 * w, axis=1)).reshape(ncell, S, cap))

    F_slot, dF_slot = _embedding(form, tables["embed"], Pt, rho_slot)
    wv = Pv.astype(dt)
    F_slot = F_slot * wv
    dF_slot = dF_slot * wv

    # pass 2: dF blocked over the half stencil; i-side and j-side
    # density derivatives (dp for t_i<-t_j and the transposed pair)
    dFq = dF_slot[stencil].reshape(ncell, S * cap)
    de, dp = _pair_eval(form, tables["pair"], pair_idx, d2s, ir, ir2, True)
    if T == 1:
        dpT = dp
    else:
        _, dpT = _pair_eval(form, tables["pair"], pair_idx_T, d2s, ir, ir2,
                            True)
    # d/dr of (e_ij + F_i(rho_i) + F_j(rho_j)) along the pair:
    # coef = de + dF_i * dp_ji' ... reference combine (eam.c:166-190):
    # symmetric forms share de; density derivative toward i uses p'(t_i
    # row) and toward j the transposed one
    coef = (de + dF_slot[:, :, None] * dp + dFq[:, None, :] * dpT) * w

    csum = jnp.sum(coef, axis=-1)
    CQ = jnp.einsum("ncs,nsd->ncd", coef, Q, preferred_element_type=dt,
                    precision=hi)
    F_p = -Pc * csum[:, :, None] + CQ

    qsum = jnp.sum(coef, axis=1)
    PC = jnp.einsum("ncs,ncd->nsd", coef, Pc, preferred_element_type=dt,
                    precision=hi)
    F_q = PC - Q * qsum[:, :, None]
    F_back = fold(F_q.reshape(ncell, S, cap, 3))

    A = jnp.einsum("nc,ncd,nce->de", csum, Pc, Pc, precision=hi)
    B = jnp.einsum("ncd,nce->de", Pc, CQ, precision=hi)
    Cm = jnp.einsum("ns,nsd,nse->de", qsum, Q, Q, precision=hi)
    virial = -(A - B - B.T + Cm)

    pe_slot = pe_pair_p + pe_pair_q + F_slot
    Ftot = F_p + F_back
    f = jnp.zeros((n_pad + 1, 3), dtype=dt).at[perm].set(
        Ftot.reshape(-1, 3), mode="drop")[:n_pad]
    pe = jnp.zeros((n_pad + 1,), dtype=dt).at[perm].set(
        pe_slot.reshape(-1), mode="drop")[:n_pad]
    return f, jnp.sum(pe_slot), virial, pe
