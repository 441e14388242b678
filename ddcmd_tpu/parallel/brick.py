"""3D brick domain decomposition over a (nx, ny, nz) device mesh.

Generalizes the 1D slab (parallel/slab.py) to full bricks — the analog
of the reference's CUBIC domain lattice (/root/reference/src/ddc.h:42)
with plane-pruned halo exchange (ddcSendRecv.c:63-85).  Instead of 26
point-to-point neighbor sends, both halo exchange and migration use the
staged scheme (exchange +-x, then +-y including x-ghosts, then +-z):
three fixed-capacity ppermute rounds cover faces, edges and corners.

All positions are GLOBAL origin-centered coordinates; neighbor math
downstream does global min-image, so ghosts never need coordinate
rewrites.  Axis sizes of 1 need no exchange (periodicity is handled by
min-image); axis size 2 sends both windows to the single neighbor.

Boxes may be orthorhombic ((3,) lengths) or triclinic ((3,3) h with
lattice vectors as columns): ownership and halo windows live in
FRACTIONAL coordinates s = h^-1 r (the reference GEOM/ddc domains do the
same for general boxes, src/box.c nearestImage + ddc.c domain lattice).
A Cartesian halo depth `rlist` converts to the fractional window
rlist * ||row_a(h^-1)|| -- the exact slab that covers every point within
rlist of a fractional-plane face.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from .slab import compact_rows

AXES = ("bx", "by", "bz")


@dataclass(frozen=True)
class BrickPlan:
    shape: tuple[int, int, int]      # devices per axis
    local_cap: int
    halo_cap: int                    # per direction per phase
    migrate_cap: int
    rlist: float
    # per-axis non-uniform wall FRACTIONS from the load balancer; None =
    # uniform walls.  Two shapes are accepted per axis:
    #   tensor (loadbalance.tensor_walls): (n_ax+1,) -- shared walls
    #   hierarchical ORCB (loadbalance.orcb_walls): y walls (nx, ny+1)
    #     per x-slab, z walls (nx, ny, nz+1) per (x,y) column -- true
    #     recursive bisection (bisectionCalc.c analog); the staged
    #     x->y->z exchange stays valid because each phase's sender and
    #     receiver live in the same slab/column and share the wall set
    walls: tuple | None = None
    # Voronoi-center domains (parallel/voronoi.py): dict with
    #   centers (nx,ny,nz,3), margins (3,), L0 (3,)
    # Ownership is nearest-center; halo windows widen by the bisector
    # margin; centers scale affinely with a live NPT box
    # (ddcAffineUpdateCenters, /root/reference/src/ddcAssignment.c:42).
    # Mutually exclusive with walls.
    voronoi: dict | None = None

    @property
    def n_dev(self) -> int:
        nx, ny, nz = self.shape
        return nx * ny * nz

    @property
    def ghost_cap(self) -> int:
        # 2*halo per OPEN-axis phase (closed axes are skipped by the
        # staged exchange and contribute zero ghost rows; a (1,1,1)
        # mesh previously padded 6*halo of dead zeros into every pooled
        # per-step array -- r4 shard-profile finding)
        return 2 * self.halo_cap * sum(1 for s in self.shape if s > 1)


def geom_frac(box_geom, dtype):
    """(frac_fn, per_cart): origin-centered fractional coordinates
    s = h^-1 r in [-0.5, 0.5) plus the per-axis fractional width of ONE
    Cartesian length unit measured perpendicular to the brick faces
    (= 1/L orthorhombic, ||row_a(h^-1)|| triclinic); a Cartesian halo
    depth w becomes the fractional window w * per_cart."""
    g = jnp.asarray(box_geom, dtype)
    if g.ndim == 1:
        return (lambda rr: rr / g), 1.0 / g
    from ..core.box import inv3x3

    hin = inv3x3(g)
    return (lambda rr: rr @ hin.T), jnp.sqrt(jnp.sum(hin * hin, axis=1))


def _axis_bounds(n, idx, dtype, walls=None, prefix=()):
    """FRACTIONAL [lo, hi) in [-0.5, 0.5) of this device's brick along
    one axis.  walls may be a shared (n+1,) set or a hierarchical set
    with one leading dim per EARLIER mesh axis (ORCB); prefix holds those
    axes' device indices."""
    if walls is not None:
        w = jnp.asarray(walls, dtype=dtype)
        if w.ndim > 1:
            for p in prefix:
                w = w[p.astype(jnp.int32)]
        i = idx.astype(jnp.int32)
        return w[i] - 0.5, w[i + 1] - 0.5
    w = 1.0 / n
    lo = -0.5 + w * idx.astype(dtype)
    return lo, lo + w


def _exchange_axis(send_lo, send_hi, axis: str, n: int):
    """ppermute packed buffers one hop along `axis` in both directions.
    Returns (from_lo_neighbor, from_hi_neighbor) = what the -1 / +1
    neighbors sent toward us."""
    perm_up = [(i, (i + 1) % n) for i in range(n)]
    perm_dn = [(i, (i - 1) % n) for i in range(n)]
    # the lo neighbor's hi-window arrives here via a +1 shift, and vice versa
    recv_from_lo = jax.tree.map(lambda x: jax.lax.ppermute(x, axis, perm_up), send_hi)
    recv_from_hi = jax.tree.map(lambda x: jax.lax.ppermute(x, axis, perm_dn), send_lo)
    return recv_from_lo, recv_from_hi


def halo_exchange_3d(fields: dict, valid_mask, box_lengths, plan: BrickPlan,
                     with_routing: bool = False):
    """Collect ghost particles from all 26 neighbor bricks via 3 staged
    face exchanges.  fields: (local_cap, ...) per-device arrays with 'r'.
    Returns (ghost fields (ghost_cap, ...), ghost_mask, overflow)
    -- or, with_routing=True, (ghosts, gmask, overflow, routing) where
    routing is the cached send-table set (the ddcSendRecvTables analog,
    /root/reference/src/ddcSendRecv.c:41-282): per active phase
    (ax_i, src_lo, n_lo, src_hi, n_hi, ghost_off) with src_* the POOL
    rows this device selected into its lo/hi windows.  halo_refresh_3d
    re-ships live values along it; halo_reduce_3d reduces ghost
    contributions back through it."""
    dtype = fields["r"].dtype
    overflow = jnp.zeros((), bool)
    ghosts = {k: jnp.zeros((0,) + v.shape[1:], v.dtype) for k, v in fields.items()}
    gmask = jnp.zeros((0,), bool)
    routing = []

    frac, per_cart = geom_frac(box_lengths, dtype)
    pool = fields
    pool_mask = valid_mask
    for ax_i, axis in enumerate(AXES):
        n = plan.shape[ax_i]
        if n == 1:
            continue
        me = jax.lax.axis_index(axis)
        prefix = tuple(jax.lax.axis_index(a) for a in AXES[:ax_i])
        lo, hi = _axis_bounds(n, me, dtype,
                              None if plan.walls is None else plan.walls[ax_i],
                              prefix)
        win = plan.rlist
        if plan.voronoi is not None:
            # widen by the bisector-plane excursion beyond the nominal
            # face (voronoi.face_margins), scaled with the live box.
            # Voronoi state lives in the SCALED-FRACTIONAL frame
            # (fractional coords x perpendicular spans == Cartesian when
            # orthorhombic), so a triclinic h reduces to the same math
            vor = plan.voronoi
            win = win + (vor["margins"][ax_i] / vor["L0"][ax_i]
                         * (1.0 / per_cart[ax_i]))
        win_f = win * per_cart[ax_i]
        x = frac(pool["r"])[:, ax_i]
        sel_lo = pool_mask & (x < lo + win_f)
        sel_hi = pool_mask & (x >= hi - win_f)
        if n == 2:
            # both windows land on the SAME neighbor: an atom within
            # rlist of both faces (brick width < 2 rlist, dense short-
            # cutoff systems) must ship only once or its pairs double-
            # count; min-image picks the right periodic image as long as
            # the global box exceeds 2 rcut
            sel_hi = sel_hi & ~sel_lo
        aux = pool
        if with_routing:
            aux = dict(pool, __row=jnp.arange(pool_mask.shape[0],
                                              dtype=jnp.int32))
        buf_lo, n_lo, ov1 = compact_rows(aux, sel_lo, plan.halo_cap)
        buf_hi, n_hi, ov2 = compact_rows(aux, sel_hi, plan.halo_cap)
        src_lo = buf_lo.pop("__row", None)
        src_hi = buf_hi.pop("__row", None)
        overflow = overflow | ov1 | ov2

        recv_from_lo, recv_from_hi = _exchange_axis(buf_lo, buf_hi, axis, n)
        cnt_from_lo = jax.lax.ppermute(n_hi, axis, [(i, (i + 1) % n) for i in range(n)])
        cnt_from_hi = jax.lax.ppermute(n_lo, axis, [(i, (i - 1) % n) for i in range(n)])

        idx = jnp.arange(plan.halo_cap)
        new_ghosts = {k: jnp.concatenate([recv_from_lo[k], recv_from_hi[k]])
                      for k in pool}
        new_mask = jnp.concatenate([idx < cnt_from_lo, idx < cnt_from_hi])

        if with_routing:
            routing.append((ax_i, src_lo, n_lo, src_hi, n_hi,
                            gmask.shape[0]))
        ghosts = {k: jnp.concatenate([ghosts[k], new_ghosts[k]]) for k in ghosts}
        gmask = jnp.concatenate([gmask, new_mask])
        # next phase selects from local + all ghosts so far
        pool = {k: jnp.concatenate([fields[k], ghosts[k]]) for k in fields}
        pool_mask = jnp.concatenate([valid_mask, gmask])

    # pad ghosts to the static ghost_cap
    pad = plan.ghost_cap - gmask.shape[0]
    if pad > 0:
        ghosts = {k: jnp.concatenate(
            [v, jnp.zeros((pad,) + v.shape[1:], v.dtype)]) for k, v in ghosts.items()}
        gmask = jnp.concatenate([gmask, jnp.zeros((pad,), bool)])
    if with_routing:
        return ghosts, gmask, overflow, tuple(routing)
    return ghosts, gmask, overflow


def halo_refresh_3d(local_vals, routing, plan: BrickPlan):
    """Re-ship per-particle values along the FROZEN routing tables: the
    per-step position halo against cached send lists (ddcUpdate,
    /root/reference/src/ddcUpdate.c:40-89).  local_vals: (local_cap, C).
    Returns the full (local_cap + ghost_cap, C) pool with ghost rows
    refreshed (rows of skipped axes stay zero; their ghost masks were
    False at table-build time)."""
    n_local = local_vals.shape[0]
    tail = local_vals.shape[1:]
    pool = jnp.concatenate(
        [local_vals, jnp.zeros((plan.ghost_cap,) + tail, local_vals.dtype)])
    for (ax_i, src_lo, n_lo, src_hi, n_hi, goff) in routing:
        axis = AXES[ax_i]
        n = plan.shape[ax_i]
        perm_up = [(i, (i + 1) % n) for i in range(n)]
        perm_dn = [(i, (i - 1) % n) for i in range(n)]
        buf_lo = pool[src_lo]                      # (halo_cap, C)
        buf_hi = pool[src_hi]
        from_lo = jax.lax.ppermute(buf_hi, axis, perm_up)
        from_hi = jax.lax.ppermute(buf_lo, axis, perm_dn)
        pool = jax.lax.dynamic_update_slice_in_dim(
            pool, jnp.concatenate([from_lo, from_hi]),
            n_local + goff, axis=0)
    return pool


def halo_reduce_3d(pool_vals, routing, plan: BrickPlan, n_local: int):
    """Reduce ghost-row contributions back to their source rows through
    the frozen routing, phases in REVERSE (force/energy back-
    accumulation, ddcUpdateForce /root/reference/src/ddcUpdate.c:140 +
    forceaccum modes md2ddc.c:170-307).  pool_vals: (local_cap +
    ghost_cap, C) with ghost rows holding the shares computed here for
    other devices' atoms.  Returns (local_cap, C)."""
    idx = jnp.arange(plan.halo_cap)
    ones = (1,) * (pool_vals.ndim - 1)
    for (ax_i, src_lo, n_lo, src_hi, n_hi, goff) in reversed(routing):
        axis = AXES[ax_i]
        n = plan.shape[ax_i]
        perm_up = [(i, (i + 1) % n) for i in range(n)]
        perm_dn = [(i, (i - 1) % n) for i in range(n)]
        blk = jax.lax.dynamic_slice_in_dim(pool_vals, n_local + goff,
                                           2 * plan.halo_cap, axis=0)
        g_lo = blk[: plan.halo_cap]                # ghosts the lo nbr sent
        g_hi = blk[plan.halo_cap:]
        back_to_hi_sender = jax.lax.ppermute(g_lo, axis, perm_dn)
        back_to_lo_sender = jax.lax.ppermute(g_hi, axis, perm_up)
        # returned buffers correspond to OUR send selections: row i of
        # back_to_hi_sender is the share for our src_hi[i] (we sent it
        # "hi"; the hi neighbor saw it as its from_lo ghost)
        add_hi = jnp.where((idx < n_hi).reshape((-1,) + ones),
                           back_to_hi_sender, 0)
        add_lo = jnp.where((idx < n_lo).reshape((-1,) + ones),
                           back_to_lo_sender, 0)
        pool_vals = pool_vals.at[src_hi].add(add_hi, mode="drop")
        pool_vals = pool_vals.at[src_lo].add(add_lo, mode="drop")
    return pool_vals[:n_local]


def _head_positions(cur: dict, mask):
    """Per-particle position of its molecule HEAD bead (own position when
    headless or the head is off-device)."""
    from .bonded_shard import pack_gid

    g64 = pack_gid(cur["gid"])
    h64 = pack_gid(cur["hgid"])
    big = jnp.asarray(jnp.iinfo(g64.dtype).max, g64.dtype)
    keyed = jnp.where(mask, g64, big)
    order = jnp.argsort(keyed)
    sgg = keyed[order]
    pos = jnp.clip(jnp.searchsorted(sgg, h64), 0, keyed.shape[0] - 1)
    hrow = order[pos]
    ok = (sgg[pos] == h64)[:, None]
    return jnp.where(ok, cur["r"][hrow], cur["r"])


def migrate_3d(fields: dict, valid_mask, box_lengths, plan: BrickPlan):
    """Staged 1-hop migration along x, then y, then z (<=1 brick hop per
    axis per rebuild, mirroring the lazy re-bisect assumption).

    Molecule coherence: when fields carry 'hgid' (head-bead gid per
    particle), migration destinations use the HEAD bead's position so a
    molecule always moves as one unit -- the ddcRule MOLECULE analog
    (/root/reference/src/ddcRuleMolecule.c:43).

    Voronoi domains (plan.voronoi): the destination is the nearest of
    the 27 neighborhood centers, computed ONCE up front and carried as a
    per-particle hop vector through the staged hops
    (voronoiCalcParticleDestinations,
    /root/reference/src/ddcAssignment.c:105-147)."""
    overflow = jnp.zeros((), bool)
    cur = fields
    mask = valid_mask
    frac, per_cart = geom_frac(box_lengths, fields["r"].dtype)
    vor = plan.voronoi
    if vor is not None:
        from .voronoi import dest_offsets, neighborhood_centers

        dtype = fields["r"].dtype
        spans = 1.0 / per_cart          # == lengths when orthorhombic
        scale = spans / jnp.asarray(vor["L0"], dtype)
        centers_dev = jnp.asarray(vor["centers"], dtype) * scale
        c27 = neighborhood_centers(centers_dev, spans, plan.shape)
        rr = _head_positions(fields, mask) if "hgid" in fields \
            else fields["r"]
        # scaled-fractional frame: identical to Cartesian when ortho
        rr_v = frac(rr) * spans
        mig = dest_offsets(rr_v, c27, spans)
        mig = mig * jnp.asarray([int(n > 1) for n in plan.shape],
                                mig.dtype)[None, :]
        cur = dict(fields, mig=mig)
    for ax_i, axis in enumerate(AXES):
        n = plan.shape[ax_i]
        if n == 1:
            continue
        me = jax.lax.axis_index(axis)
        dtype = cur["r"].dtype
        if vor is not None:
            go_lo = mask & (cur["mig"][:, ax_i] < 0)
            go_hi = mask & (cur["mig"][:, ax_i] > 0)
        else:
            prefix = tuple(jax.lax.axis_index(a) for a in AXES[:ax_i])
            lo, hi = _axis_bounds(
                n, me, dtype,
                None if plan.walls is None else plan.walls[ax_i], prefix)
            if "hgid" in cur:
                x = frac(_head_positions(cur, mask))[:, ax_i]
            else:
                x = frac(cur["r"])[:, ax_i]
            go_lo = mask & (x < lo)
            go_hi = mask & (x >= hi)
        stay = mask & ~(go_lo | go_hi)
        buf_lo, n_lo, ov1 = compact_rows(cur, go_lo, plan.migrate_cap)
        buf_hi, n_hi, ov2 = compact_rows(cur, go_hi, plan.migrate_cap)
        recv_from_lo, recv_from_hi = _exchange_axis(buf_lo, buf_hi, axis, n)
        cnt_from_lo = jax.lax.ppermute(n_hi, axis, [(i, (i + 1) % n) for i in range(n)])
        cnt_from_hi = jax.lax.ppermute(n_lo, axis, [(i, (i - 1) % n) for i in range(n)])
        idx = jnp.arange(plan.migrate_cap)
        pool = {k: jnp.concatenate([cur[k], recv_from_lo[k], recv_from_hi[k]])
                for k in cur}
        pool_mask = jnp.concatenate([stay, idx < cnt_from_lo, idx < cnt_from_hi])
        cur, count, ov3 = compact_rows(pool, pool_mask, plan.local_cap)
        mask = jnp.arange(plan.local_cap) < count
        overflow = overflow | ov1 | ov2 | ov3

    if vor is not None:
        # containment: after the hops the nearest neighborhood center
        # must be SELF; a particle that moved >1 brick since the last
        # migration (or a center that drifted under it) flags overflow
        # so the host redistributes exactly (as for ORCB walls below)
        del cur["mig"]
        rr = _head_positions(cur, mask) if "hgid" in cur else cur["r"]
        mig2 = dest_offsets(rr, c27, box_lengths) \
            * jnp.asarray([int(n > 1) for n in plan.shape],
                          jnp.int32)[None, :]
        overflow = overflow | jnp.any(mask & jnp.any(mig2 != 0, axis=1))
        return cur, mask, overflow

    # hierarchical (ORCB) walls: crossing an x wall swaps the y/z wall
    # set, so one staged hop can leave a particle >1 brick from its owner
    # (tensor walls cannot -- the set is shared).  Verify containment
    # (head-based when molecule-coherent) and flag overflow so the host
    # redistributes exactly instead of silently mis-owning pairs.
    if plan.walls is not None and any(
            np.asarray(w).ndim > 1 for w in plan.walls):
        rr = _head_positions(cur, mask) if "hgid" in cur else cur["r"]
        dtype = rr.dtype
        ss = frac(rr)
        for ax_i, axis in enumerate(AXES):
            n = plan.shape[ax_i]
            if n == 1:
                continue
            me = jax.lax.axis_index(axis)
            prefix = tuple(jax.lax.axis_index(a) for a in AXES[:ax_i])
            lo, hi = _axis_bounds(n, me, dtype, plan.walls[ax_i], prefix)
            x = ss[:, ax_i]
            overflow = overflow | jnp.any(mask & ((x < lo) | (x >= hi)))
    return cur, mask, overflow


def distribute_bricks(arrays: dict, box_lengths, plan: BrickPlan):
    """Host-side: split arrays into flat (n_dev*local_cap, ...) by brick.
    Device order matches Mesh(devices.reshape(shape), AXES) raveling."""
    r = np.asarray(arrays["r"])
    if "hgid" in arrays:
        # molecule coherence: destination from the head bead's position
        g64 = (arrays["gid"][:, 0].astype(np.int64)
               + (arrays["gid"][:, 1].astype(np.int64) << 32))
        h64 = (arrays["hgid"][:, 0].astype(np.int64)
               + (arrays["hgid"][:, 1].astype(np.int64) << 32))
        row_of = {int(g): i for i, g in enumerate(g64)}
        r = r[[row_of[int(h)] for h in h64]]
    nx, ny, nz = plan.shape
    L = np.asarray(box_lengths, dtype=np.float64)
    if L.ndim == 2:
        fr = r @ np.linalg.inv(L).T + 0.5       # fractional, triclinic h
    else:
        fr = r / L[None, :] + 0.5
    fr = fr - np.floor(fr)
    if plan.voronoi is not None:
        from .voronoi import assign_host

        vor = plan.voronoi
        if L.ndim == 2:
            hin = np.linalg.inv(L)
            spans = 1.0 / np.sqrt((hin * hin).sum(axis=1))
            r_v = (fr - 0.5) * spans          # scaled-fractional frame
        else:
            spans = L
            r_v = r
        centers = vor["centers"] * (spans / np.asarray(vor["L0"]))[
            None, None, None, :]
        dest = assign_host(r_v, centers, spans, plan.shape)
    elif plan.walls is not None:
        from .loadbalance import walls_assign

        cx, cy, cz = walls_assign(fr, plan.walls, plan.shape)
        dest = (cx * ny + cy) * nz + cz
    else:
        cj = [np.clip(np.floor(fr[:, a] * plan.shape[a]).astype(int),
                      0, plan.shape[a] - 1) for a in range(3)]
        dest = (cj[0] * ny + cj[1]) * nz + cj[2]
    out = {}
    counts = np.zeros(plan.n_dev, dtype=np.int32)
    for d in range(plan.n_dev):
        counts[d] = int((dest == d).sum())
        if counts[d] > plan.local_cap:
            raise ValueError(f"brick {d} needs {counts[d]} > cap {plan.local_cap}")
    for k, a in arrays.items():
        a = np.asarray(a)
        buf = np.zeros((plan.n_dev, plan.local_cap) + a.shape[1:], dtype=a.dtype)
        for d in range(plan.n_dev):
            sel = a[dest == d]
            buf[d, : len(sel)] = sel
        out[k] = buf.reshape((plan.n_dev * plan.local_cap,) + a.shape[1:])
    mask = (np.arange(plan.local_cap)[None, :] < counts[:, None]).reshape(-1)
    return out, mask, counts


def walls_span_minmax(walls, shape):
    """(min, max) brick-span FRACTIONS per axis from a BrickPlan.walls
    tuple (1-D shared, or hierarchical ORCB 2-D/3-D); uniform 1/shape
    for axes without walls."""
    mins = np.empty(3)
    maxs = np.empty(3)
    for a in range(3):
        w = None if walls is None else walls[a]
        if w is None:
            mins[a] = maxs[a] = 1.0 / shape[a]
        else:
            d = np.diff(np.asarray(w, dtype=np.float64), axis=-1)
            mins[a] = float(d.min())
            maxs[a] = float(d.max())
    return mins, maxs
