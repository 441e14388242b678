"""Holonomic constraints: per-residue velocity projections.

Reference: nglfconstraint.c (/root/reference/src/nglfconstraint.c:122-178,
resMoveCons loop :200-280):

  FRONT (pre-drift):  project velocities so post-drift pair distances
    satisfy (r_ab + v_ab dt)^2 = d_ab^2; nonlinear in lambda, solved by
    iterating the linearized n x n system (reference iterates to
    |lambda| < 1e-12, maxit 500).
  BACK (post-kick):   RATTLE projection r_ab . v_ab = 0 (linear, one solve).

  M[ab,uv] = (r_ab . r_uv) * (((u==a)-(v==a)) /m_a - ((u==b)-(v==b)) /m_b)
  v_a += sum_uv ((u==a)-(v==a)) /m_a * lambda_uv * r_uv

Accelerator shape: constraint groups are padded to (G, max_atoms, max_pairs) and
solved with batched jnp.linalg.solve under vmap; fixed iteration count
replaces the reference's tolerance loop (convergence is quadratic; tests
assert the residual).

Two entry points:
  build_constraint_fn   -- single-chip: group->row tables baked in.
  make_constraint_project -- row tables passed per call (the sharded
    brick step resolves gid-keyed groups to local rows each call;
    molecule-coherent migration guarantees the rows are local).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def make_constraint_project(cons_pairs, cons_dist, dtype, m: int,
                            box_lengths=None, n_iter_front: int = 8):
    """cons_pairs (G,n,2) local atom slots; cons_dist (G,n) targets (pad 0);
    m = atoms per (padded) group.  Returns
    project_all(r_ext, v_ext, rmass_ext, atoms, group_w, dt, mode, L=None)
    -> (G,m,3) projected group velocities; `atoms` (G,m) rows into the
    *_ext buffers (pad rows -> a zeroed sentinel row), `group_w` (G,)
    gates whole groups (sharded ownership).  The per-call L overrides the
    baked box_lengths -- REQUIRED under a barostat, where the live box
    differs from the construction-time one (min-imaging a boundary-
    straddling molecule with stale lengths projects against wrong
    geometry)."""
    G, n = cons_pairs.shape[:2]

    pairs = jnp.asarray(cons_pairs)
    dist2 = jnp.asarray(cons_dist ** 2, dtype=dtype)
    pair_valid = jnp.asarray((cons_dist > 0).astype(np.float64), dtype=dtype)

    if n == 1:
        # SINGLE-distance groups (every Martini constraint: one rigid
        # bond per molecule): the RATTLE projection has a CLOSED FORM --
        # |a t + b|^2 = d^2 is one quadratic in t = 1 + dt lam mu -- so
        # the 8-iteration Newton loop with per-group 1x1 linalg.solve
        # (the dominant non-pair phase of the 94k bilayer: ~20% of the
        # step, r4 phase profile) collapses to a few vector ops over G.
        gi = pairs[:, 0, 0]
        gj = pairs[:, 0, 1]
        d2v = dist2[:, 0]
        pv = pair_valid[:, 0]
        Lv0 = None if box_lengths is None else jnp.asarray(box_lengths,
                                                          dtype=dtype)

        def project_all(r_ext, v_ext, rmass_ext, atoms, group_w, dt,
                        mode_front, L=None):
            Lv = Lv0 if L is None else jnp.asarray(L, dtype=dtype)
            r_g = r_ext[atoms]                       # (G, m, 3)
            v_g = v_ext[atoms]
            rm_g = rmass_ext[atoms]                  # (G, m)
            gidx = jnp.arange(G)
            rI, rJ = r_g[gidx, gi], r_g[gidx, gj]    # (G, 3)
            vI, vJ = v_g[gidx, gi], v_g[gidx, gj]
            rmI, rmJ = rm_g[gidx, gi], rm_g[gidx, gj]
            a = rI - rJ
            if Lv is not None:
                if Lv.ndim == 1:
                    a = a - Lv * jnp.round(a / Lv)
                else:
                    from ..core.box import inv3x3

                    a = a - jnp.round(a @ inv3x3(Lv).T) @ Lv.T
            w = pv * group_w
            mu = rmI + rmJ
            A = jnp.sum(a * a, axis=-1)
            vab = vI - vJ
            safe = (w > 0) & (mu > 0) & (A > 0)
            denom = jnp.where(safe, dt * mu, 1.0)
            b = dt * vab
            # solve A s^2 + 2 B' s + C' = 0 for s = dt lam mu, where
            # p = a + b is the unconstrained end-of-step separation;
            # Muller's form picks the SMALL-|s| root (the one Newton
            # from lam=0 converges to) without cancellation
            p = a + b
            Bp = jnp.sum(a * p, axis=-1)
            Cp = jnp.sum(p * p, axis=-1) - d2v
            disc = jnp.maximum(Bp * Bp - A * Cp, 0.0)
            sq = jnp.sqrt(disc)
            den = Bp + jnp.where(Bp >= 0, sq, -sq)
            den = jnp.where(jnp.abs(den) > 1e-30, den, 1.0)
            s = -Cp / den
            lam_front = s / denom
            lam_back = -jnp.sum(a * vab, axis=-1) / jnp.where(
                safe, A * mu, 1.0)
            lam = jnp.where(mode_front, lam_front, lam_back)
            lam = jnp.where(safe, lam, 0.0)
            dv = lam[:, None] * a                    # (G, 3)
            v_new = v_g
            v_new = v_new.at[gidx, gi].add(rmI[:, None] * dv)
            v_new = v_new.at[gidx, gj].add(-rmJ[:, None] * dv)
            return v_new

        return project_all

    # selection tensors: sel[p, a] = (pair p has atom a as I) - (as J)
    selI = jax.nn.one_hot(pairs[:, :, 0], m, dtype=dtype)   # (G,n,m)
    selJ = jax.nn.one_hot(pairs[:, :, 1], m, dtype=dtype)
    sel = selI - selJ                                        # (G,n,m)

    Lv0 = None if box_lengths is None else jnp.asarray(box_lengths, dtype=dtype)

    def project(r_g, v_g, rmass_g, d2_g, w_g, sel_g, dt, mode_front, Lv):
        """One constraint group. r_g,v_g (m,3); sel_g (n,m); w_g (n,)."""
        r_ab = sel_g @ r_g                                   # (n,3)
        if Lv is not None:  # molecule may straddle the wrapped box
            if Lv.ndim == 1:
                r_ab = r_ab - Lv * jnp.round(r_ab / Lv)
            else:             # triclinic h: fractional-space round
                from ..core.box import inv3x3

                r_ab = r_ab - jnp.round(r_ab @ inv3x3(Lv).T) @ Lv.T
        # M[ab,uv] = (r_ab . r_uv) * sum_a sel[ab,a] sel[uv,a] rmass_a
        rr = r_ab @ r_ab.T                                   # (n,n)
        smat = (sel_g * rmass_g[None, :]) @ sel_g.T          # (n,n)
        M = rr * smat
        # pad rows/cols -> identity
        wmat = w_g[:, None] * w_g[None, :]
        M = M * wmat + jnp.diag(1.0 - w_g)

        def rhs_front(v_g):
            v_ab = sel_g @ v_g
            pab = r_ab + dt * v_ab
            return -(jnp.sum(pab * pab, axis=-1) - d2_g) / (2.0 * dt) * w_g

        def rhs_back(v_g):
            v_ab = sel_g @ v_g
            return -jnp.sum(r_ab * v_ab, axis=-1) * w_g

        def apply_lambda(v_g, lam):
            # v_a += rmass_a * sum_uv sel[uv,a] lam_uv r_uv
            dv = (sel_g * rmass_g[None, :]).T @ (lam[:, None] * r_ab)
            return v_g + dv

        def front_iter(i, v_g):
            lam = jnp.linalg.solve(M, rhs_front(v_g))
            return apply_lambda(v_g, lam)

        v_front = jax.lax.fori_loop(0, n_iter_front, front_iter, v_g)
        lam_back = jnp.linalg.solve(M, rhs_back(v_g))
        v_back = apply_lambda(v_g, lam_back)
        return jnp.where(mode_front, v_front, v_back)

    vproject = jax.vmap(project,
                        in_axes=(0, 0, 0, 0, 0, 0, None, None, None))

    def project_all(r_ext, v_ext, rmass_ext, atoms, group_w, dt, mode_front,
                    L=None):
        Lv = Lv0 if L is None else jnp.asarray(L, dtype=dtype)
        r_g = r_ext[atoms]
        v_g = v_ext[atoms]
        rmass_g = rmass_ext[atoms]
        w = pair_valid * group_w[:, None]
        v_new = vproject(r_g, v_g, rmass_g, dist2, w, sel, dt, mode_front,
                         Lv)
        # gate: disowned groups return their input velocities untouched
        return jnp.where(group_w[:, None, None] > 0, v_new, v_g)

    return project_all


def build_constraint_fn(cons_atoms, cons_pairs, cons_dist, n_pad: int,
                        dtype, box_lengths=None, n_iter_front: int = 8):
    """cons_atoms (G,m) state rows (pad -1); cons_pairs (G,n,2) local slots;
    cons_dist (G,n) target distances (pad 0).  Returns
    constraint_fn(state, dt, mode) -> state with projected velocities."""
    project_all = make_constraint_project(
        cons_pairs, cons_dist, dtype, cons_atoms.shape[1],
        box_lengths=box_lengths, n_iter_front=n_iter_front)
    G = cons_atoms.shape[0]
    atoms = jnp.asarray(np.where(cons_atoms < 0, n_pad, cons_atoms))
    ones = jnp.ones((G,), dtype=dtype)

    # scatter through an extended buffer so padded atom slots land on the
    # sentinel row and are dropped
    def constraint_fn(state, dt, mode, box_lengths=None):
        mode_front = jnp.asarray(mode == "front")
        r_ext = jnp.concatenate([state.r, jnp.zeros((1, 3), dtype=dtype)])
        v_ext = jnp.concatenate([state.v, jnp.zeros((1, 3), dtype=dtype)])
        rm_ext = jnp.concatenate(
            [1.0 / state.mass, jnp.zeros((1,), dtype=dtype)])
        v_new = project_all(r_ext, v_ext, rm_ext, atoms, ones, dt, mode_front,
                            L=box_lengths)
        v_buf = jnp.concatenate([state.v, jnp.zeros((1, 3), dtype=dtype)])
        v_buf = v_buf.at[atoms.reshape(-1)].set(v_new.reshape(-1, 3))
        return state.replace(v=v_buf[:n_pad])

    return constraint_fn


def build_constraint_fn_batched(cons_atoms, cons_pairs, cons_dist,
                                n_pad: int, dtype, residue_instances,
                                box_lengths=None):
    """Residue-template batched single-bond RATTLE (fast path).

    The generic n==1 closed form pays (G, m, 3)-shaped math with tiny
    minor dims, two extended-buffer concats and a gather+set writeback
    per projection.
    Here constraint groups are batched per residue TYPE like the bonded
    terms (potentials/bonded_batch.py): one contiguous slice (or row
    gather) of the type's atoms, all closed-form math on lane-dense
    (M,) arrays with STATIC local indices, one slice writeback.

    Returns constraint_fn(state, dt, mode, box_lengths=None) or None
    when the topology is not template-regular (any group with >1 pair,
    atoms crossing instances, or uneven instantiation) -- callers fall
    back to build_constraint_fn."""
    if cons_pairs.shape[1] != 1:
        return None
    if not residue_instances:
        return None
    G = cons_atoms.shape[0]
    ca = np.asarray(cons_atoms)
    cp = np.asarray(cons_pairs)
    row_i = ca[np.arange(G), cp[:, 0, 0]]
    row_j = ca[np.arange(G), cp[:, 0, 1]]
    dist = np.asarray(cons_dist)[:, 0]

    inst_of = np.full(n_pad, -1, np.int64)
    local_of = np.full(n_pad, -1, np.int64)
    type_names: list[str] = []
    type_id: dict[str, int] = {}
    inst_type = []
    inst_rows: dict[int, list] = {}
    for i, (name, rows) in enumerate(residue_instances):
        rows = np.asarray(rows, np.int64)
        inst_of[rows] = i
        local_of[rows] = np.arange(len(rows))
        if name not in type_id:
            type_id[name] = len(type_names)
            type_names.append(name)
            inst_rows[type_id[name]] = []
        inst_type.append(type_id[name])
        inst_rows[type_id[name]].append(rows)
    inst_type = np.asarray(inst_type)

    inst = inst_of[row_i]
    if (inst < 0).any() or (inst_of[row_j] != inst).any():
        return None
    types = []
    for t in range(len(type_names)):
        sel = inst_type[inst] == t
        gids = np.nonzero(sel)[0]
        if len(gids) == 0:
            continue
        order = np.argsort(inst[gids], kind="stable")
        gids = gids[order]
        uinst, counts = np.unique(inst[gids], return_counts=True)
        M = int(np.sum(inst_type == t))
        if len(uinst) != M or counts.min() != counts.max():
            return None
        K = int(counts[0])
        li = local_of[row_i[gids]].reshape(M, K)
        lj = local_of[row_j[gids]].reshape(M, K)
        if not ((li == li[0]).all() and (lj == lj[0]).all()):
            return None
        rows = np.stack(inst_rows[t])                    # (M, A)
        Mr, A = rows.shape
        flat = rows.reshape(-1)
        start = int(flat[0])
        contiguous = bool((flat == start + np.arange(Mr * A)).all())
        types.append(dict(
            M=M, A=A, li=li[0], lj=lj[0],
            d2=jnp.asarray(dist[gids].reshape(M, K).T ** 2, dtype),  # (K, M)
            rows=None if contiguous else jnp.asarray(flat, jnp.int32),
            start=start if contiguous else None))
    if not types:
        return None
    Lv0 = None if box_lengths is None else jnp.asarray(box_lengths,
                                                       dtype=dtype)

    def constraint_fn(state, dt, mode, box_lengths=None):
        mode_front = mode == "front"
        Lv = Lv0 if box_lengths is None else jnp.asarray(box_lengths,
                                                         dtype=dtype)
        v = state.v
        for tp in types:
            M, A = tp["M"], tp["A"]
            if tp["start"] is not None:
                rblk = jax.lax.dynamic_slice(
                    state.r, (tp["start"], 0), (M * A, 3))
                vblk = jax.lax.dynamic_slice(v, (tp["start"], 0), (M * A, 3))
                mblk = jax.lax.dynamic_slice(state.mass, (tp["start"],),
                                             (M * A,))
            else:
                rblk = state.r[tp["rows"]]
                vblk = v[tp["rows"]]
                mblk = state.mass[tp["rows"]]
            rb = rblk.reshape(M, A, 3).transpose(2, 1, 0)   # (3, A, M)
            vb = vblk.reshape(M, A, 3).transpose(2, 1, 0)
            rm = (1.0 / mblk).reshape(M, A).T               # (A, M)
            for k in range(len(tp["li"])):
                li = int(tp["li"][k])
                lj = int(tp["lj"][k])
                a = rb[:, li] - rb[:, lj]                   # (3, M)
                if Lv is not None:
                    a = a - Lv[:, None] * jnp.round(a / Lv[:, None])
                vab = vb[:, li] - vb[:, lj]
                rmI = rm[li]
                rmJ = rm[lj]
                mu = rmI + rmJ
                Aq = jnp.sum(a * a, axis=0)
                if mode_front:
                    b = dt * vab
                    p = a + b
                    Bp = jnp.sum(a * p, axis=0)
                    Cp = jnp.sum(p * p, axis=0) - tp["d2"][k]
                    disc = jnp.maximum(Bp * Bp - Aq * Cp, 0.0)
                    sq = jnp.sqrt(disc)
                    den = Bp + jnp.where(Bp >= 0, sq, -sq)
                    den = jnp.where(jnp.abs(den) > 1e-30, den, 1.0)
                    lam = (-Cp / den) / (dt * mu)
                else:
                    lam = -jnp.sum(a * vab, axis=0) / (Aq * mu)
                dv = lam[None, :] * a                       # (3, M)
                vb = vb.at[:, li].add(rmI[None, :] * dv)
                vb = vb.at[:, lj].add(-rmJ[None, :] * dv)
            vout = vb.transpose(2, 1, 0).reshape(M * A, 3)
            if tp["start"] is not None:
                v = jax.lax.dynamic_update_slice(v, vout, (tp["start"], 0))
            else:
                v = v.at[tp["rows"]].set(vout)
        return state.replace(v=v)

    return constraint_fn


def build_constraint_templates(cons_atoms, cons_pairs, cons_dist,
                               residue_instances, gid):
    """Sharded analog of build_constraint_fn_batched's host analysis:
    per-residue-TYPE constraint templates keyed by instance GIDS.

    Returns (plan, project) or None when not template-regular.  plan is
    resolve_batched-compatible: {"types": [{gids (M, A), M, A, li, lj,
    d2 (K, M)}]}.  project(vblk_list, rblk_list, rmblk_list, w_list,
    dt, mode, Lv) applies the closed-form single-bond RATTLE per type on
    lane-dense (M,) math -- the caller gathers/scatters the pool rows
    (parallel/brickstep_pallas)."""
    if cons_pairs.shape[1] != 1 or not residue_instances:
        return None
    G = cons_atoms.shape[0]
    ca = np.asarray(cons_atoms)
    cp = np.asarray(cons_pairs)
    row_i = ca[np.arange(G), cp[:, 0, 0]]
    row_j = ca[np.arange(G), cp[:, 0, 1]]
    dist = np.asarray(cons_dist)[:, 0]
    gid = np.asarray(gid, np.int64)

    n_rows = len(gid)
    inst_of = np.full(n_rows, -1, np.int64)
    local_of = np.full(n_rows, -1, np.int64)
    type_names: list[str] = []
    type_id: dict[str, int] = {}
    inst_type = []
    inst_rows: dict[int, list] = {}
    for i, (name, rows) in enumerate(residue_instances):
        rows = np.asarray(rows, np.int64)
        inst_of[rows] = i
        local_of[rows] = np.arange(len(rows))
        if name not in type_id:
            type_id[name] = len(type_names)
            type_names.append(name)
            inst_rows[type_id[name]] = []
        inst_type.append(type_id[name])
        inst_rows[type_id[name]].append(rows)
    inst_type = np.asarray(inst_type)

    inst = inst_of[row_i]
    if (inst < 0).any() or (inst_of[row_j] != inst).any():
        return None
    types = []
    for t in range(len(type_names)):
        sel = inst_type[inst] == t
        gids_t = np.nonzero(sel)[0]
        if len(gids_t) == 0:
            continue
        order = np.argsort(inst[gids_t], kind="stable")
        gids_t = gids_t[order]
        uinst, counts = np.unique(inst[gids_t], return_counts=True)
        M = int(np.sum(inst_type == t))
        if len(uinst) != M or counts.min() != counts.max():
            return None
        K = int(counts[0])
        li = local_of[row_i[gids_t]].reshape(M, K)
        lj = local_of[row_j[gids_t]].reshape(M, K)
        if not ((li == li[0]).all() and (lj == lj[0]).all()):
            return None
        rows = np.stack(inst_rows[t])
        types.append(dict(
            M=M, A=rows.shape[1], li=li[0], lj=lj[0],
            d2=jnp.asarray(dist[gids_t].reshape(M, K).T ** 2, jnp.float32),
            gids=jnp.asarray(gid[rows])))
    if not types:
        return None

    def project(rb3, vb3, rm2, w, d2, li, lj, dt, mode_front, Lv):
        """One type: rb3/vb3 (3, A, M), rm2 (A, M), w (M,) ownership.
        Returns updated vb3.  Static K-loop of the Muller closed form."""
        for k in range(len(li)):
            i = int(li[k])
            j = int(lj[k])
            a = rb3[:, i] - rb3[:, j]
            if Lv is not None:
                a = a - Lv[:, None] * jnp.round(a / Lv[:, None])
            # disowned instances gather arbitrary (possibly coincident)
            # rows: swap in unit geometry so 1/A stays finite
            a = jnp.where((w > 0)[None, :], a,
                          jnp.asarray([1.0, 0.0, 0.0],
                                      a.dtype)[:, None])
            vab = vb3[:, i] - vb3[:, j]
            rmI = rm2[i]
            rmJ = rm2[j]
            mu = jnp.maximum(rmI + rmJ, 1e-30)
            Aq = jnp.sum(a * a, axis=0)
            if mode_front:
                b = dt * vab
                p = a + b
                Bp = jnp.sum(a * p, axis=0)
                Cp = jnp.sum(p * p, axis=0) - d2[k]
                disc = jnp.maximum(Bp * Bp - Aq * Cp, 0.0)
                sq = jnp.sqrt(disc)
                den = Bp + jnp.where(Bp >= 0, sq, -sq)
                den = jnp.where(jnp.abs(den) > 1e-30, den, 1.0)
                lam = (-Cp / den) / (dt * mu)
            else:
                lam = -jnp.sum(a * vab, axis=0) / (Aq * mu)
            lam = lam * w
            dv = lam[None, :] * a
            vb3 = vb3.at[:, i].add(rmI[None, :] * dv)
            vb3 = vb3.at[:, j].add(-rmJ[None, :] * dv)
        return vb3

    return dict(types=types), project


def constraint_residual(state, cons_atoms, cons_pairs, cons_dist, dt=None):
    """Max |(|r_ab| - d)/d| over all constraints (diagnostic/tests)."""
    r = np.asarray(state.r)
    worst = 0.0
    for g in range(len(cons_atoms)):
        rows = cons_atoms[g]
        for p in range(cons_pairs.shape[1]):
            d = cons_dist[g, p]
            if d <= 0:
                continue
            i = rows[cons_pairs[g, p, 0]]
            j = rows[cons_pairs[g, p, 1]]
            b = np.linalg.norm(r[i] - r[j])
            worst = max(worst, abs(b - d) / d)
    return worst
