"""Cell list + padded neighbor list on the device.

Replaces the reference's GEOM cell grid + FAT/SKINNY neighbor tables
(/root/reference/src/geom.h:24-110, /root/reference/src/neighbor.h:11-41)
and mirrors the *GPU* design (fixed-size neighbor "pages" + overflow
check, /root/reference/src/nlistGPU.cu:206,378) which is already the
static-shape form XLA wants:

  * particles are binned into a static cell grid (cell edge >= list
    radius), ordered by a device sort;
  * per-particle neighbor candidates come from the 27-cell stencil;
  * candidates within rcut+skin are compacted into a fixed (N, K)
    index matrix with a validity mask; overflow raises a flag and the
    host re-builds with a larger K (the reference's allocPages/
    checkbounds pattern);
  * the (N, K) list is FULL (each pair appears from both sides), so
    force accumulation is a pure gather+sum -- no scatter on the hot
    path (Newton's 3rd law costs 2x FLOPs but removes all atomics and
    makes the sums deterministic).

Rebuild cadence is driven by the caller (deck `ddc.updateRate` /
displacement trigger, /root/reference/src/ddcUpdateAll.c:48-71).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import jax.numpy as jnp
import numpy as np


@dataclass(frozen=True)
class CellGrid:
    """Static grid metadata (python ints -> shapes are compile-time)."""

    ncells: tuple[int, int, int]
    cell_capacity: int
    max_neighbors: int          # K
    rlist: float                # rcut + skin, internal units

    @property
    def ncell_total(self) -> int:
        nx, ny, nz = self.ncells
        return nx * ny * nz

    @classmethod
    def plan(cls, box_lengths, rcut: float, skin: float, n_particles: int,
             n_pad: int, density_safety: float = 2.0,
             max_neighbors: int | None = None,
             plan_margin: float = 1.0, positions=None,
             occupancy_factor: float = 1.0) -> "CellGrid":
        """positions (optional): measure the REAL peak cell occupancy and
        raise capacities above the mean-density heuristic — inhomogeneous
        systems (a solvated peptide, a droplet, a bilayer in water) bust
        the homogeneous estimate.  occupancy_factor scales the measured
        peak (e.g. sharded ghost duplication when a brick's halo window
        wraps around a small box)."""
        L = np.asarray(box_lengths, dtype=np.float64)
        rlist = rcut + skin
        ncells = tuple(max(1, int(math.floor(l / (rlist * plan_margin))))
                       for l in L)
        vol = float(np.prod(L))
        density = n_particles / vol
        cell_vol = vol / (ncells[0] * ncells[1] * ncells[2])
        cap = int(density * cell_vol * density_safety) + 8
        cap = ((cap + 7) // 8) * 8
        if max_neighbors is None:
            nsphere = density * 4.0 / 3.0 * math.pi * rlist ** 3 * 1.6
            max_neighbors = ((int(nsphere) + 127) // 128) * 128
        if positions is not None and len(positions):
            p = np.asarray(positions, dtype=np.float64)
            nc = np.asarray(ncells)
            c = np.floor((p / L + 0.5 - np.floor(p / L + 0.5)) * nc)
            c = np.clip(c.astype(np.int64), 0, nc - 1)
            lin = (c[:, 0] * nc[1] + c[:, 1]) * nc[2] + c[:, 2]
            occ = int(np.bincount(lin, minlength=int(np.prod(nc))).max())
            meas = int(occ * occupancy_factor * 1.5) + 8
            cap = max(cap, ((meas + 7) // 8) * 8)
            peak_density = occ / cell_vol
            nsph = (peak_density * 4.0 / 3.0 * math.pi * rlist ** 3
                    * 1.6 * occupancy_factor)
            max_neighbors = max(max_neighbors,
                                ((int(nsph) + 127) // 128) * 128)
        return cls(ncells=ncells, cell_capacity=cap,
                   max_neighbors=max_neighbors, rlist=rlist)


def min_image_geom(dr, geom):
    """Minimum-image reduction against (3,) orthorhombic lengths or a
    (3,3) triclinic h (columns = lattice vectors).  The fractional-round
    form is exact for reduced cells (tilt <= half the diagonal), the
    same restriction the cell-block engine's static image shifts carry
    (reference nearestImage, src/box.c)."""
    if geom.ndim == 1:
        return dr - geom * jnp.round(dr / geom)
    from ..core.box import inv3x3

    sfrac = dr @ inv3x3(geom).T
    return dr - jnp.round(sfrac) @ geom.T


def _cell_index(r, geom, ncells):
    """Cell coordinates for origin-centered positions; triclinic bins in
    fractional coordinates (GEOM non-orthorhombic binning, src/geom.c)."""
    n = jnp.asarray(ncells)
    if geom.ndim == 1:
        s = r / geom + 0.5                         # [0,1)
    else:
        from ..core.box import inv3x3

        s = r @ inv3x3(geom).T + 0.5
    c = jnp.floor(s * n).astype(jnp.int32)
    c = jnp.clip(c, 0, n - 1)
    return c


def _flat_cell(c3, ncells):
    nx, ny, nz = ncells
    return (c3[..., 0] * ny + c3[..., 1]) * nz + c3[..., 2]


def _stencil_for(ncells) -> np.ndarray:
    """Unique neighbor-cell offsets. When an axis has <3 cells the -1/+1
    offsets alias under wrap and would double-count pairs, so collapse
    them (static: ncells is compile-time)."""
    axes = []
    for n in ncells:
        if n >= 3:
            axes.append((-1, 0, 1))
        elif n == 2:
            axes.append((0, 1))
        else:
            axes.append((0,))
    return np.array([(i, j, k) for i in axes[0] for j in axes[1] for k in axes[2]],
                    dtype=np.int32)


def build_cell_table(r, fmask, box_lengths, grid: CellGrid):
    """Bin particles. Returns (table (ncell_total+1, cap) int32 particle ids,
    padded with n_pad sentinel; cell3 (N,3) cell coords; overflow flag)."""
    n_pad = r.shape[0]
    sentinel = n_pad
    c3 = _cell_index(r, box_lengths, grid.ncells)
    cid = _flat_cell(c3, grid.ncells)
    # invalid (padded) particles go to the trash cell
    cid = jnp.where(fmask > 0, cid, grid.ncell_total)

    order = jnp.argsort(cid)                       # stable
    sorted_cid = cid[order]
    # rank within cell: position - first occurrence of this cid
    first = jnp.searchsorted(sorted_cid, sorted_cid, side="left")
    rank = jnp.arange(n_pad, dtype=jnp.int32) - first.astype(jnp.int32)

    cap = grid.cell_capacity
    table = jnp.full(((grid.ncell_total + 1) * cap,), sentinel, dtype=jnp.int32)
    ok = rank < cap
    flat = jnp.where(ok, sorted_cid * cap + rank, (grid.ncell_total + 1) * cap)
    table = table.at[flat].set(order.astype(jnp.int32), mode="drop")
    overflow = jnp.any(~ok & (sorted_cid < grid.ncell_total))
    return table.reshape(grid.ncell_total + 1, cap), c3, overflow


def build_neighbor_list(r, fmask, box_lengths, grid: CellGrid, row_mask=None,
                        pbc: int = 7):
    """Full (N, K) neighbor index list within rlist. Returns
    (nbr_idx, nbr_count, overflow).  nbr_idx padded with n_pad sentinel.
    Positions must be wrapped (origin-centered).

    fmask: particles that may appear as NEIGHBORS (binned into cells).
    row_mask: particles whose own rows are built (defaults to fmask);
    the sharded path passes local+ghost as fmask but local-only rows.
    pbc: box periodicity bits (bit i => axis i periodic, preduce.c:42);
    stencil reaches that wrap a non-periodic axis are dropped."""
    n_pad = r.shape[0]
    sentinel = n_pad
    if row_mask is None:
        row_mask = fmask
    table, c3, cell_overflow = build_cell_table(r, fmask, box_lengths, grid)

    ncells = jnp.asarray(grid.ncells)
    stencil = jnp.asarray(_stencil_for(grid.ncells))
    n_stencil = stencil.shape[0]
    # (N, S, 3) neighbor cell coords with periodic wrap
    raw = c3[:, None, :] + stencil[None, :, :]
    nc3 = raw % ncells
    ncid = _flat_cell(nc3, grid.ncells)            # (N, S)
    cand = table[ncid].reshape(n_pad, n_stencil * grid.cell_capacity)  # (N, C)
    pbc_ok = None
    if pbc & 7 != 7:
        free = np.array([not (pbc >> a) & 1 for a in range(3)])
        crossed = jnp.any(((raw < 0) | (raw >= ncells))
                          & jnp.asarray(free)[None, None, :], axis=-1)
        pbc_ok = ~jnp.repeat(crossed, grid.cell_capacity, axis=1)

    # distances (min image; orthorhombic lengths or triclinic h).
    # Orthorhombic boxes compute PER COMPONENT: a materialized
    # (N, C, 3) intermediate keeps a 3-wide minor dim, which at
    # all-atom C ~ 10^4 pads into a multi-GB allocation on tiled
    # layouts (observed OOM on the c36 fixture)
    r_ext = jnp.concatenate([r, jnp.zeros((1, 3), dtype=r.dtype)], axis=0)
    if np.ndim(box_lengths) == 1:
        L = jnp.asarray(box_lengths, r.dtype)
        d2 = jnp.zeros(cand.shape, r.dtype)
        for c in range(3):
            dc = r[:, c][:, None] - r_ext[:, c][cand]
            dc = dc - L[c] * jnp.round(dc / L[c])
            d2 = d2 + dc * dc
    else:
        dr = r[:, None, :] - r_ext[cand]
        dr = min_image_geom(dr, box_lengths)
        d2 = jnp.sum(dr * dr, axis=-1)

    i_idx = jnp.arange(n_pad, dtype=jnp.int32)[:, None]
    valid = (cand != sentinel) & (cand != i_idx) & (d2 < grid.rlist ** 2) \
        & (row_mask[:, None] > 0)
    if pbc_ok is not None:
        valid = valid & pbc_ok

    K = grid.max_neighbors
    pos = jnp.cumsum(valid.astype(jnp.int32), axis=1) - 1
    count = jnp.where(valid.shape[1] > 0, pos[:, -1] + 1, 0)
    slot = jnp.where(valid & (pos < K), pos, K)
    out = jnp.full((n_pad, K + 1), sentinel, dtype=jnp.int32)
    out = out.at[i_idx, slot].set(cand, mode="drop")
    nbr_idx = out[:, :K]
    overflow = cell_overflow | jnp.any(count > K)
    return nbr_idx, count, overflow


def neighbor_displacements(r, nbr_idx, box_lengths):
    """Gather dr_ij = r_i - r_j with min image; (N,K,3), plus valid mask."""
    n_pad = r.shape[0]
    sentinel = n_pad
    r_ext = jnp.concatenate([r, jnp.zeros((1, 3), dtype=r.dtype)], axis=0)
    dr = r[:, None, :] - r_ext[nbr_idx]
    dr = min_image_geom(dr, box_lengths)
    mask = (nbr_idx != sentinel)
    return dr, mask


def max_displacement2(r, r0, fmask, box_lengths):
    """max_i |r_i - r_i0|^2 for the verlet-skin rebuild trigger
    (neighborCheck, /root/reference/src/neighbor.c:117-199)."""
    dr = r - r0
    dr = min_image_geom(dr, box_lengths)
    d2 = jnp.sum(dr * dr, axis=-1) * fmask
    return jnp.max(d2)
