"""Cell-blocked pair engine: XLA's dense pair path.

Replaces per-pair gathers with dense cell-block math (batched matmuls
at Precision.HIGHEST):

  * at REBUILD (deck ddc.updateRate cadence): bin particles into a
    static cell grid (edge >= rcut+skin), argsort into slot order, and
    keep the slot->particle permutation.  That's the whole rebuild --
    no neighbor matrix, no compaction (contrast the (N,K) list path in
    nbr/celllist.py, kept for validation).
  * per STEP: gather positions once into (ncell, cap, 3) slot layout,
    pull each cell's 27-stencil block (pure block-take), and evaluate
    ALL slot pairs per cell:
        |p - q|^2 = |p|^2 + |q|^2 - 2 p.q      (batched matmul)
        forces f_i = -sum_j c_ij (p_i - q_j)
              = -p_i sum_j c_ij + c @ Q        (batched matmul)
    with elementwise masking for empty slots / self / cutoff.
  * minimum image: per (cell, stencil-direction) integer wrap counts,
    precomputed once per grid -- q is shifted by wrap * L, which IS the
    nearest image for every pair within the cutoff because the cell
    edge >= rlist.  No per-pair round() at all.

This mirrors what the reference's GPU engine achieves with bin pages +
shared-memory tiles (processPairShared, /root/reference/src/
pairProcessGPU.cu:574; buildList pages /root/reference/src/
nlistGPU.cu:206) re-thought for a systolic-array machine.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from ..core.box import inv3x3


@dataclass(frozen=True)
class CellBlockGrid:
    ncells: tuple[int, int, int]
    cap: int                  # max particles per cell
    rlist: float
    # static stencil (host numpy, baked into the program):
    stencil_cells: np.ndarray   # (ncell, S) int32 neighbor cell ids
    wrap: np.ndarray            # (ncell, S, 3) int8 image wrap counts

    @property
    def ncell(self) -> int:
        nx, ny, nz = self.ncells
        return nx * ny * nz

    @property
    def n_stencil(self) -> int:
        return self.stencil_cells.shape[1]

    @classmethod
    def plan(cls, box_geom, rcut: float, skin: float, n_particles: int,
             density_safety: float = 1.6,
             plan_margin: float = 1.0) -> "CellBlockGrid":
        """box_geom: (3,) orthorhombic lengths or a full (3,3) h matrix
        (lattice vectors as columns).  For a triclinic box the cell count
        per axis comes from the PERPENDICULAR span between the opposing
        fractional-coordinate planes (the reference GEOM's non-orthorhombic
        binning, /root/reference/src/geom.c), so one stencil shell still
        covers every pair within rlist.

        plan_margin > 1 plans fewer/larger cells so a shrinking box (NPT /
        prescribed box(t)) keeps cell edge >= rlist until it has compressed
        by that factor -- avoids replan churn right at the edge."""
        spans, vol = perp_spans(box_geom)
        rlist = rcut + skin
        ncells = tuple(max(1, int(math.floor(s / (rlist * plan_margin))))
                       for s in spans)
        cell_vol = vol / np.prod(ncells)
        cap = int(n_particles / vol * cell_vol * density_safety) + 4
        cap = ((cap + 7) // 8) * 8
        stencil_cells, wrap = _build_stencil(ncells)
        return cls(ncells=ncells, cap=cap, rlist=rlist,
                   stencil_cells=stencil_cells, wrap=wrap)

    def with_cap(self, cap: int) -> "CellBlockGrid":
        cap = ((cap + 7) // 8) * 8
        return CellBlockGrid(ncells=self.ncells, cap=cap, rlist=self.rlist,
                             stencil_cells=self.stencil_cells, wrap=self.wrap)


def perp_spans(box_geom):
    """Perpendicular spans (3,) + volume of a (3,) or (3,3) box (host)."""
    g = np.asarray(box_geom, dtype=np.float64)
    if g.ndim == 1:
        return g.copy(), float(np.prod(g))
    a = g.T  # rows = lattice vectors
    vol = float(abs(np.linalg.det(g)))
    spans = np.array([vol / np.linalg.norm(np.cross(a[(i + 1) % 3],
                                                    a[(i + 2) % 3]))
                      for i in range(3)])
    return spans, vol


def frac_coords(r, box_geom):
    """Fractional coordinates in [0,1) for origin-centered positions.

    box_geom: (3,) lengths (orthorhombic fast path) or (3,3) h with
    lattice vectors as columns (triclinic)."""
    b = jnp.asarray(box_geom, r.dtype)
    if b.ndim == 1:
        return r / b + 0.5
    hinv = inv3x3(b)
    return r @ hinv.T + 0.5


def block_geometry(grid: "CellBlockGrid", box_geom, dt):
    """Cartesian image shifts (C,S,3) and cell centers (C,3).

    The static integer wrap counts / fractional cell centers map to
    Cartesian space through the (possibly traced, barostat-scaled) box:
    shift = wrap @ h^T, center = s_frac @ h^T; for a (3,) orthorhombic
    box these collapse to elementwise scales."""
    wrap = jnp.asarray(grid.wrap, dtype=dt)           # (C,S,3) fractional
    b = jnp.asarray(box_geom, dtype=dt)
    cells = np.arange(grid.ncell)
    ny, nz = grid.ncells[1], grid.ncells[2]
    cx, rem = np.divmod(cells, ny * nz)
    cy, cz = np.divmod(rem, nz)
    c3 = np.stack([cx, cy, cz], axis=1)
    sfrac = jnp.asarray((c3 + 0.5) / np.asarray(grid.ncells) - 0.5, dtype=dt)
    if b.ndim == 1:
        return wrap * b, sfrac * b
    return wrap @ b.T, sfrac @ b.T


def _axis_offsets(n: int):
    """Always (-1, 0, 1): for n == 2 the -1 and +1 offsets reach the SAME
    neighbor cell through DIFFERENT images (distinct static shifts) and
    both must be present -- collapsing to (0, 1) silently drops the
    wrapped-image pairs (the cutoff mask keeps at most one image in
    range because the cell edge >= rlist).  For n == 1 the entries are
    the cell's own periodic images; they only matter when L < 2 rcut."""
    del n
    return (-1, 0, 1)


def _build_stencil(ncells):
    """Per-cell neighbor cell ids + integer image wraps (host, static)."""
    nx, ny, nz = ncells
    offs = [(i, j, k) for i in _axis_offsets(nx) for j in _axis_offsets(ny)
            for k in _axis_offsets(nz)]
    S = len(offs)
    ncell = nx * ny * nz
    cells = np.arange(ncell)
    cx, rem = np.divmod(cells, ny * nz)
    cy, cz = np.divmod(rem, nz)
    stencil = np.zeros((ncell, S), dtype=np.int32)
    wrap = np.zeros((ncell, S, 3), dtype=np.int8)
    for s, (dx, dy, dz) in enumerate(offs):
        tx, ty, tz = cx + dx, cy + dy, cz + dz
        # wrap counts: how many boxes the neighbor cell image is offset by
        wxp = (tx >= nx).astype(np.int8) - (tx < 0).astype(np.int8)
        wyp = (ty >= ny).astype(np.int8) - (ty < 0).astype(np.int8)
        wzp = (tz >= nz).astype(np.int8) - (tz < 0).astype(np.int8)
        stencil[:, s] = ((tx % nx) * ny + (ty % ny)) * nz + (tz % nz)
        wrap[:, s, 0] = wxp
        wrap[:, s, 1] = wyp
        wrap[:, s, 2] = wzp
    return stencil, wrap


def _build_stencil_half(ncells):
    """Newton's-third-law half stencil: the self block FIRST (index 0,
    dedup'd by a triangular mask in the kernel) + the 13 lexicographically
    positive directions.  Each unordered pair appears in exactly one
    block; the q-side forces are scattered back by the per-direction cell
    permutation (see half_back_map).  For 2-cell axes the +1 offset's N3L
    partner IS the -1 offset's block of the neighbor cell (opposite wrap),
    so positive-only still covers both periodic images; for 1-cell axes
    the +1 self-image block holds both (i, j+L) and (j, i+L) ordered
    pairs, each counted once."""
    nx, ny, nz = ncells
    offs = [(0, 0, 0)] + [
        (i, j, k)
        for i in (-1, 0, 1) for j in (-1, 0, 1) for k in (-1, 0, 1)
        if (i, j, k) > (0, 0, 0)]
    S = len(offs)
    ncell = nx * ny * nz
    cells = np.arange(ncell)
    cx, rem = np.divmod(cells, ny * nz)
    cy, cz = np.divmod(rem, nz)
    stencil = np.zeros((ncell, S), dtype=np.int32)
    wrap = np.zeros((ncell, S, 3), dtype=np.int8)
    for s, (dx, dy, dz) in enumerate(offs):
        tx, ty, tz = cx + dx, cy + dy, cz + dz
        wrap[:, s, 0] = (tx >= nx).astype(np.int8) - (tx < 0).astype(np.int8)
        wrap[:, s, 1] = (ty >= ny).astype(np.int8) - (ty < 0).astype(np.int8)
        wrap[:, s, 2] = (tz >= nz).astype(np.int8) - (tz < 0).astype(np.int8)
        stencil[:, s] = ((tx % nx) * ny + (ty % ny)) * nz + (tz % nz)
    return stencil, wrap


def half_grid(grid: CellBlockGrid) -> CellBlockGrid:
    """Same cells/cap, half (N3L) stencil."""
    stencil, wrap = _build_stencil_half(grid.ncells)
    return CellBlockGrid(ncells=grid.ncells, cap=grid.cap, rlist=grid.rlist,
                         stencil_cells=stencil, wrap=wrap)


def pbc_allowed(grid: CellBlockGrid, pbc: int) -> np.ndarray | None:
    """(C, S) bool: stencil entries that do NOT cross a non-periodic
    boundary (box pbc bit i => axis i periodic, preduce.c:42-45 /
    box.c pbc bits).  None when fully periodic (pbc == 7) so the
    fully-periodic path stays branch-free."""
    if pbc & 7 == 7:
        return None
    free = np.array([not (pbc >> a) & 1 for a in range(3)])
    return ~np.any(grid.wrap.astype(bool) & free[None, None, :], axis=2)


def half_back_map(grid: CellBlockGrid) -> np.ndarray:
    """(S, ncell) int32: src_map[s, t] = the cell whose direction-s block
    targets cell t (each direction is a translation, hence a bijection)."""
    S = grid.n_stencil
    ncell = grid.ncell
    src = np.zeros((S, ncell), dtype=np.int32)
    c = np.arange(ncell)
    for s in range(S):
        src[s, grid.stencil_cells[:, s]] = c
    return src



# ---------------------------------------------------------------------------
# rebuild
# ---------------------------------------------------------------------------

def build_cell_slots(r, fmask, box_geom, grid: CellBlockGrid):
    """Sort particles into cell-slot order.

    box_geom: (3,) lengths or (3,3) h.  Returns (perm (ncell*cap,) int32
    slot->particle, sentinel n_pad for empty slots; overflow flag)."""
    n_pad = r.shape[0]
    sentinel = n_pad
    n = jnp.asarray(grid.ncells)
    s = frac_coords(r, box_geom)
    c3 = jnp.clip(jnp.floor(s * n).astype(jnp.int32), 0, n - 1)
    ny, nz = grid.ncells[1], grid.ncells[2]
    cid = (c3[:, 0] * ny + c3[:, 1]) * nz + c3[:, 2]
    cid = jnp.where(fmask > 0, cid, grid.ncell)

    order = jnp.argsort(cid)
    sorted_cid = cid[order]
    first = jnp.searchsorted(sorted_cid, sorted_cid, side="left")
    rank = jnp.arange(n_pad, dtype=jnp.int32) - first.astype(jnp.int32)

    ok = rank < grid.cap
    flat = jnp.where(ok, sorted_cid * grid.cap + rank, (grid.ncell + 1) * grid.cap)
    perm = jnp.full(((grid.ncell + 1) * grid.cap,), sentinel, dtype=jnp.int32)
    perm = perm.at[flat].set(order.astype(jnp.int32), mode="drop")
    overflow = jnp.any(~ok & (sorted_cid < grid.ncell))
    return perm[: grid.ncell * grid.cap], overflow


# ---------------------------------------------------------------------------
# per-step pair evaluation
# ---------------------------------------------------------------------------

def cellpair_eval(r, q, tidx, perm, box_geom, grid: CellBlockGrid, tables,
                  coulomb: bool = True, allowed=None):
    """Forces/energy/virial/per-particle pe for shifted-LJ (+RF Coulomb).

    box_geom: (3,) lengths or (3,3) h (triclinic).  tables: sigma/eps/
    shift (T,T), rcut2, and (if coulomb) krf/crf/keR.  Physics identical
    to potentials.martini.martini_nonbond
    (/root/reference/src/bioMartini.c:989-1120)."""
    n_pad = r.shape[0]
    sentinel = n_pad
    dt = r.dtype
    ncell, cap = grid.ncell, grid.cap
    S = grid.n_stencil

    r_ext = jnp.concatenate([r, jnp.zeros((1, 3), dtype=dt)], axis=0)
    q_ext = jnp.concatenate([q, jnp.zeros((1,), dtype=dt)], axis=0)
    t_ext = jnp.concatenate([tidx, jnp.zeros((1,), dtype=tidx.dtype)], axis=0)

    P = r_ext[perm].reshape(ncell, cap, 3)             # (C,c,3)
    Pq = q_ext[perm].reshape(ncell, cap)
    Pt = t_ext[perm].reshape(ncell, cap)
    Pv = (perm != sentinel).reshape(ncell, cap)

    stencil = jnp.asarray(grid.stencil_cells)          # (C,S)
    shift, centers = block_geometry(grid, box_geom, dt)

    Q = P[stencil]                                     # (C,S,c,3) block take
    Q = Q + shift[:, :, None, :]

    # re-center every block on its home cell: |p|^2 + |q|^2 - 2 p.q is a
    # catastrophic cancellation for box-scale coordinates (reduced-
    # precision matmul passes make it fatal); cell-relative coordinates
    # bound the
    # magnitudes at ~1.5 cell edges.  Forces/virial are translation
    # invariant, so relative coordinates flow through everything below.
    P = P - centers[:, None, :]
    Q = Q - centers[:, None, None, :]
    Qq = Pq[stencil]                                   # (C,S,c)
    Qt = Pt[stencil]
    Qv = Pv[stencil]
    if allowed is not None:
        # pbc < 7: blocks reached through a non-periodic image are
        # masked off wholesale (static per (cell, stencil) table)
        Qv = Qv & jnp.asarray(allowed)[:, :, None]
    Q = Q.reshape(ncell, S * cap, 3)
    Qq = Qq.reshape(ncell, S * cap)
    Qt = Qt.reshape(ncell, S * cap)
    Qv = Qv.reshape(ncell, S * cap)

    # slot identity for self-pair exclusion
    slot = jnp.arange(ncell * cap, dtype=jnp.int32).reshape(ncell, cap)
    Qslot = slot[stencil].reshape(ncell, S * cap)

    p2 = jnp.sum(P * P, axis=-1)                       # (C,c)
    q2 = jnp.sum(Q * Q, axis=-1)                       # (C,Sc)
    pq = jnp.einsum("ncd,nsd->ncs", P, Q, preferred_element_type=dt,
                    precision=jax.lax.Precision.HIGHEST)   # full f32
    d2 = p2[:, :, None] + q2[:, None, :] - 2.0 * pq    # (C,c,Sc)

    mask = (Pv[:, :, None] & Qv[:, None, :]
            & (slot[:, :, None] != Qslot[:, None, :])
            & (d2 < tables["rcut2"]))
    w = mask.astype(dt)

    d2s = jnp.where(mask, d2, jnp.asarray(1.0, dt))
    ir2 = 1.0 / d2s
    ir = jnp.sqrt(ir2)

    T = tables["sigma"].shape[0]
    if T == 1:
        # uniform-type system (e.g. the Martini waterbox): the three big
        # (C,c,Sc) table gathers collapse to scalars -- a large HBM saving
        sig = tables["sigma"][0, 0]
        eps = tables["eps"][0, 0]
        shf = tables["shift"][0, 0]
    else:
        pair_t = Pt[:, :, None] * T + Qt[:, None, :]
        sig = tables["sigma"].reshape(-1)[pair_t]
        eps = tables["eps"].reshape(-1)[pair_t]
        shf = tables["shift"].reshape(-1)[pair_t]

    s2 = sig * sig * ir2
    s6 = s2 * s2 * s2
    s12 = s6 * s6
    e_pair = (4.0 * eps * (s12 - s6) + shf) * w
    dvdr = 24.0 * eps * (s6 - 2.0 * s12) * ir2

    if coulomb:
        kqq = tables["keR"] * Pq[:, :, None] * Qq[:, None, :]
        e_pair = e_pair + kqq * (ir + tables["krf"] * d2s - tables["crf"]) * w
        dvdr = dvdr + kqq * (2.0 * tables["krf"] - ir2 * ir)

    coef = dvdr * w                                    # (C,c,Sc)
    csum = jnp.sum(coef, axis=-1)                      # (C,c)
    # f_i = -sum_j coef_ij (p_i - q_j) = -p_i*csum + coef @ Q
    F = -P * csum[:, :, None] + jnp.einsum(
        "ncs,nsd->ncd", coef, Q, preferred_element_type=dt,
        precision=jax.lax.Precision.HIGHEST)               # full f32

    pe_slot = 0.5 * jnp.sum(e_pair, axis=-1)           # (C,c)

    # virial = 0.5 sum f_ij (x) dr_ij, f_ij = -coef dr_ij, dr = p - q
    # = -0.5 [ A - B - B^T + C ]
    hi = jax.lax.Precision.HIGHEST
    A = jnp.einsum("nc,ncd,nce->de", csum, P, P, precision=hi)
    CQ = jnp.einsum("ncs,nsd->ncd", coef, Q, preferred_element_type=dt,
                    precision=hi)
    B = jnp.einsum("ncd,nce->de", P, CQ, precision=hi)
    qsum = jnp.sum(coef, axis=1)                       # (C,Sc)
    Cm = jnp.einsum("ns,nsd,nse->de", qsum, Q, Q, precision=hi)
    virial = -0.5 * (A - B - B.T + Cm)

    # unsort: each particle owns exactly one slot -> permutation scatter
    f = jnp.zeros((n_pad + 1, 3), dtype=dt).at[perm].set(
        F.reshape(-1, 3), mode="drop")[:n_pad]
    pe = jnp.zeros((n_pad + 1,), dtype=dt).at[perm].set(
        pe_slot.reshape(-1), mode="drop")[:n_pad]
    e_tot = jnp.sum(pe_slot)

    return f, e_tot, virial, pe


def cellpair_eval_half(r, q, tidx, perm, box_geom, grid: CellBlockGrid,
                       tables, back_map, coulomb: bool = True, allowed=None):
    """N3L variant of cellpair_eval: `grid` from half_grid() (self block
    first + 13 positive directions), `back_map` from half_back_map().
    Halves the dominant (C, c, S*c) elementwise math; the q-side reaction
    forces fold back through the static per-direction cell permutation.
    Physics identical to cellpair_eval (parity-tested)."""
    n_pad = r.shape[0]
    sentinel = n_pad
    dt = r.dtype
    ncell, cap = grid.ncell, grid.cap
    S = grid.n_stencil

    r_ext = jnp.concatenate([r, jnp.zeros((1, 3), dtype=dt)], axis=0)
    q_ext = jnp.concatenate([q, jnp.zeros((1,), dtype=dt)], axis=0)
    t_ext = jnp.concatenate([tidx, jnp.zeros((1,), dtype=tidx.dtype)], axis=0)

    P = r_ext[perm].reshape(ncell, cap, 3)
    Pq = q_ext[perm].reshape(ncell, cap)
    Pt = t_ext[perm].reshape(ncell, cap)
    Pv = (perm != sentinel).reshape(ncell, cap)

    stencil = jnp.asarray(grid.stencil_cells)
    shift, centers = block_geometry(grid, box_geom, dt)

    Q = P[stencil] + shift[:, :, None, :]
    P = P - centers[:, None, :]
    Q = (Q - centers[:, None, None, :]).reshape(ncell, S * cap, 3)
    Qq = Pq[stencil].reshape(ncell, S * cap)
    Qt = Pt[stencil].reshape(ncell, S * cap)
    Qv = Pv[stencil]
    if allowed is not None:
        Qv = Qv & jnp.asarray(allowed)[:, :, None]   # pbc < 7 (see above)
    Qv = Qv.reshape(ncell, S * cap)

    # dedup only inside the self block (index 0): keep lane > row once
    rows = jnp.arange(cap, dtype=jnp.int32)
    lanes = jnp.arange(S * cap, dtype=jnp.int32)
    dup = (lanes[None, :] < cap) & (lanes[None, :] <= rows[:, None])

    hi = jax.lax.Precision.HIGHEST
    p2 = jnp.sum(P * P, axis=-1)
    q2 = jnp.sum(Q * Q, axis=-1)
    pq = jnp.einsum("ncd,nsd->ncs", P, Q, preferred_element_type=dt,
                    precision=hi)
    d2 = p2[:, :, None] + q2[:, None, :] - 2.0 * pq

    mask = (Pv[:, :, None] & Qv[:, None, :] & ~dup[None, :, :]
            & (d2 < tables["rcut2"]))
    w = mask.astype(dt)

    d2s = jnp.where(mask, d2, jnp.asarray(1.0, dt))
    ir2 = 1.0 / d2s
    ir = jnp.sqrt(ir2)

    T = tables["sigma"].shape[0]
    if T == 1:
        sig = tables["sigma"][0, 0]
        eps = tables["eps"][0, 0]
        shf = tables["shift"][0, 0]
    else:
        pair_t = Pt[:, :, None] * T + Qt[:, None, :]
        sig = tables["sigma"].reshape(-1)[pair_t]
        eps = tables["eps"].reshape(-1)[pair_t]
        shf = tables["shift"].reshape(-1)[pair_t]

    s2 = sig * sig * ir2
    s6 = s2 * s2 * s2
    s12 = s6 * s6
    e_pair = (4.0 * eps * (s12 - s6) + shf) * w
    dvdr = 24.0 * eps * (s6 - 2.0 * s12) * ir2

    if coulomb:
        kqq = tables["keR"] * Pq[:, :, None] * Qq[:, None, :]
        e_pair = e_pair + kqq * (ir + tables["krf"] * d2s - tables["crf"]) * w
        dvdr = dvdr + kqq * (2.0 * tables["krf"] - ir2 * ir)

    coef = dvdr * w
    csum = jnp.sum(coef, axis=-1)
    CQ = jnp.einsum("ncs,nsd->ncd", coef, Q, preferred_element_type=dt,
                    precision=hi)
    F_p = -P * csum[:, :, None] + CQ
    pe_p = 0.5 * jnp.sum(e_pair, axis=-1)

    # q-side reaction: f_j = +sum_i coef_ij (p_i - q_j)
    qsum = jnp.sum(coef, axis=1)                              # (C, Sc)
    PC = jnp.einsum("ncs,ncd->nsd", coef, P, preferred_element_type=dt,
                    precision=hi)                             # (C, Sc, 3)
    F_q = PC - Q * qsum[:, :, None]
    pe_q = 0.5 * jnp.sum(e_pair, axis=1)                      # (C, Sc)

    # fold q-side back through the per-direction cell permutation
    bm = jnp.asarray(back_map)
    Fq_blk = F_q.reshape(ncell, S, cap, 3)
    pq_blk = pe_q.reshape(ncell, S, cap)
    F_back = Fq_blk[bm[0], 0]
    pe_back = pq_blk[bm[0], 0]
    for s in range(1, S):
        F_back = F_back + Fq_blk[bm[s], s]
        pe_back = pe_back + pq_blk[bm[s], s]

    # each pair counted once: no 0.5
    A = jnp.einsum("nc,ncd,nce->de", csum, P, P, precision=hi)
    B = jnp.einsum("ncd,nce->de", P, CQ, precision=hi)
    Cm = jnp.einsum("ns,nsd,nse->de", qsum, Q, Q, precision=hi)
    virial = -(A - B - B.T + Cm)

    F = F_p + F_back
    pe_slot = pe_p + pe_back
    f = jnp.zeros((n_pad + 1, 3), dtype=dt).at[perm].set(
        F.reshape(-1, 3), mode="drop")[:n_pad]
    pe = jnp.zeros((n_pad + 1,), dtype=dt).at[perm].set(
        pe_slot.reshape(-1), mode="drop")[:n_pad]
    e_tot = jnp.sum(e_pair)

    return f, e_tot, virial, pe
