"""Residue-template batched bonded evaluation (fast path).

The generic evaluator (bonded.bonded_eval) assembles forces with
per-term row gathers + scatter-adds, ~400k term-role rows per step at
the 100k bilayer.

This module exploits what the reference exploits with its per-residue
GPU kernels (/root/reference/src/bondedGPU.cu:1244-2988): terms are
instantiated from PER-RESIDUE-TYPE templates (bonded.instantiate_bonded),
so every instance of a type has the SAME local topology.  Batch all
instances of a type as (component, term, instance) arrays:

  * ONE row gather of the type's atoms (or a free static slice when the
    instances are contiguous in state order -- they are, for
    builder-generated decks),
  * term geometry by STATIC local indexing of an (3, A, M) block --
    no per-term gather at all,
  * per-atom force/pe accumulation as a tiny one-hot (S, A) matmul on
    a matmul -- no scatter at all,
  * ONE static slice-add (or unique-row scatter) writeback.

Instance count M rides the lane dimension, so all per-term math is
fully lane-dense -- unlike (T, 3) arrays whose minor dim pads 3 -> 128.

Terms that cross residue instances (CHARMM chain junctions, CMAP) fall
through to the generic evaluator; build_batched_bonded returns the
leftover term dict alongside the batched plan.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

# families eligible for batching: key -> (arity R, parm keys)
_FAMS = (
    ("bonds", 2, ("bond_parms",)),
    ("angles", 3, ("angle_parms", "angle_kind")),
    ("torsions", 4, ("torsion_parms",)),
    ("impropers", 4, ("improper_parms",)),
    ("bpairs", 2, ("bpair_parms",)),
    ("exclusions", 2, ("excl_tidx", "excl_qq")),
)


def build_batched_bonded(terms: dict, residue_instances, n_pad: int,
                         dtype=jnp.float32, gid=None):
    """Split the device term tables into per-residue-type batches plus a
    leftover dict for the generic evaluator.

    Returns (batch_plan, leftover_terms) -- batch_plan is None when
    nothing batches (no instances, or no family fully intra-residue).
    leftover_terms keeps every non-index entry of `terms` (modes, LJ
    flats, cmap tables) so bonded_eval can evaluate it unchanged."""
    if not residue_instances:
        return None, terms
    inst_of = np.full(n_pad, -1, np.int64)
    local_of = np.full(n_pad, -1, np.int64)
    type_names = []
    type_id = {}
    inst_type = []
    inst_rows = {}
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

    types: dict[int, dict] = {}
    leftover = {k: v for k, v in terms.items()}
    any_batched = False
    for key, R, parm_keys in _FAMS:
        if key not in terms:
            continue
        idx = np.asarray(terms[key])
        T = idx.shape[0]
        inst = inst_of[idx[:, 0]]
        ok = inst >= 0
        for rr in range(1, R):
            ok &= inst_of[idx[:, rr]] == inst
        # per-type grouping of the intra-instance terms
        spill = ~ok
        for t in range(len(type_names)):
            sel = ok & (inst_type[np.maximum(inst, 0)] == t) & (inst >= 0)
            tids = np.nonzero(sel)[0]
            if len(tids) == 0:
                continue
            insts = inst[tids]
            # stable sort by instance keeps template term order inside
            order = np.argsort(insts, kind="stable")
            tids = tids[order]
            insts = insts[order]
            uinst, counts = np.unique(insts, return_counts=True)
            M_all = np.sum(inst_type == t)
            if (len(uinst) != M_all or counts.min() != counts.max()):
                spill[tids] = True          # uneven instantiation
                continue
            Tt = int(counts[0])
            loc = local_of[idx[tids]].reshape(M_all, Tt, R)
            if not (loc == loc[0]).all():
                spill[tids] = True          # differing local patterns
                continue
            d = types.setdefault(t, {})
            fam = d.setdefault(key, {})
            fam["loc"] = loc[0].astype(np.int32)          # (Tt, R)
            # batched parms, transposed to (.., Tt, M) so M rides lanes
            for pk in parm_keys:
                pv = np.asarray(terms[pk])[tids].reshape(M_all, Tt, -1)
                fam[pk] = jnp.asarray(
                    np.moveaxis(pv, 0, -1),               # (Tt, P, M)
                    dtype if np.issubdtype(pv.dtype, np.floating)
                    else pv.dtype)
            # exclusions: pre-resolve the flat LJ lookups per term
            if key == "exclusions" and terms.get("excl_mode") != "rf_add":
                ti = np.asarray(terms["excl_tidx"])[tids].reshape(M_all, Tt)
                for nm in ("sigma_flat", "eps_flat", "shift_flat"):
                    fv = np.asarray(terms[nm])[ti]
                    fam[nm] = jnp.asarray(np.moveaxis(fv, 0, -1), dtype)
            any_batched = True
        if spill.any():
            rows = np.nonzero(spill)[0]
            leftover[key] = jnp.asarray(idx[rows])
            for pk in parm_keys:
                leftover[pk] = jnp.asarray(np.asarray(terms[pk])[rows])
            if key == "exclusions":
                for nm in ("excl_tidx", "excl_qq"):
                    leftover[nm] = jnp.asarray(np.asarray(terms[nm])[rows])
        else:
            leftover.pop(key, None)
            for pk in parm_keys:
                leftover.pop(pk, None)
    if not any_batched:
        return None, terms

    # per-type gather plan
    plan = []
    for t, fams in sorted(types.items()):
        rows = np.stack(inst_rows[t])                    # (M, A)
        M, A = rows.shape
        flat = rows.reshape(-1)
        start = int(flat[0])
        contiguous = bool((flat == start + np.arange(M * A)).all())
        tp = dict(
            name=type_names[t], fams=fams, M=M, A=A,
            rows=None if contiguous else jnp.asarray(flat, jnp.int32),
            start=start if contiguous else None,
        )
        if gid is not None:
            # gid-keyed membership for the sharded resolver
            # (parallel/bonded_shard.resolve_batched)
            tp["gids"] = jnp.asarray(
                np.asarray(gid, np.int64)[rows])         # (M, A)
        plan.append(tp)
    meta = dict(excl_mode=terms.get("excl_mode"),
                rcut2=terms.get("rcut2"),
                bpair_rcut2=terms.get("bpair_rcut2"),
                excl_krf=terms.get("excl_krf"),
                excl_crf=terms.get("excl_crf"))
    return dict(types=plan, meta=meta), leftover


def _min_image_c(d, Lc):
    return d - Lc * jnp.round(d / Lc)


def batched_bonded_eval(r, box_lengths, plan: dict, n_pad: int, dtype,
                        resolved=None):
    """Evaluate the batched types; same contract as bonded_eval:
    returns (f (n_pad,3), e, virial (3,3), pe (n_pad,)).

    resolved: None for the static single-chip path (rows baked into the
    plan), or a list aligned with plan["types"] of (rows (M*A,) traced
    pool rows, w (M,) ownership weights) from the sharded resolver
    (parallel/bonded_shard.resolve_batched) -- instances not owned by
    this device evaluate against sanitized dummy geometry with zero
    weight, so each instance's terms land exactly once across the
    mesh."""
    L = jnp.asarray(box_lengths, dtype)
    meta = plan["meta"]
    f = jnp.zeros((n_pad, 3), dtype=dtype)
    pe = jnp.zeros((n_pad,), dtype=dtype)
    e = jnp.zeros((), dtype=dtype)
    virial = jnp.zeros((3, 3), dtype=dtype)

    for itp, tp in enumerate(plan["types"]):
        M, A = tp["M"], tp["A"]
        if resolved is not None:
            rows_t, w_inst = resolved[itp]
            blk = r[rows_t]
        elif tp["start"] is not None:
            w_inst = None
            blk = jax.lax.dynamic_slice(r, (tp["start"], 0), (M * A, 3))
        else:
            w_inst = None
            blk = r[tp["rows"]]

        def san(dr, unit, w_inst=w_inst):
            """Disowned instances gather arbitrary rows; swap in a fixed
            non-degenerate geometry so 1/r and AD stay finite (the
            bonded_eval sanitize trick)."""
            if w_inst is None:
                return dr
            u = jnp.asarray(unit, dr.dtype).reshape(3, 1, 1)
            return jnp.where((w_inst > 0)[None, None, :], dr, u)

        def wmul(x, w_inst=w_inst):
            if w_inst is None:
                return x
            if x.ndim == 3:
                return x * w_inst[None, None, :]
            return x * w_inst[None, :]

        # (3, A, M): components lead, instances ride the lane dim
        rm = blk.reshape(M, A, 3).transpose(2, 1, 0)

        contribs_f = []        # (3, Tt, M) per role, concat on axis 1
        contribs_pe = []       # (Tt, M) per role
        slot_atoms = []        # local atom of each slot

        def emit(loc, fvecs, pevals):
            for rr in range(loc.shape[1]):
                contribs_f.append(fvecs[rr])
                contribs_pe.append(pevals[rr])
                slot_atoms.append(loc[:, rr])

        def gatherA(loc_col):
            return rm[:, loc_col, :]                     # (3, T, M)

        fams = tp["fams"]
        if "bonds" in fams:
            fam = fams["bonds"]
            loc = fam["loc"]
            parm = fam["bond_parms"]                     # (T, 2, M)
            dr = gatherA(loc[:, 0]) - gatherA(loc[:, 1])
            dr = san(_min_image_c(dr, L[:, None, None]), (1.0, 0.0, 0.0))
            b = jnp.sqrt(jnp.sum(dr * dr, axis=0))
            kb, b0 = parm[:, 0], parm[:, 1]
            db = b - b0
            eb = wmul(kb * db * db)
            fi = wmul(-2.0 * kb * db / b)[None] * dr
            emit(loc, [fi, -fi], [0.5 * eb, 0.5 * eb])
            virial = virial + jnp.einsum("atm,ctm->ac", fi, dr)
            e = e + jnp.sum(eb)

        if "angles" in fams:
            fam = fams["angles"]
            loc = fam["loc"]
            parm = fam["angle_parms"]                    # (T, 2, M)
            kind = fam["angle_kind"][:, 0, :]            # (T, M) int
            rij = san(_min_image_c(gatherA(loc[:, 0]) - gatherA(loc[:, 1]),
                                   L[:, None, None]), (1.0, 0.0, 0.0))
            rkj = san(_min_image_c(gatherA(loc[:, 2]) - gatherA(loc[:, 1]),
                                   L[:, None, None]), (0.0, 1.0, 0.0))
            bij = jnp.sqrt(jnp.sum(rij * rij, axis=0))
            bkj = jnp.sqrt(jnp.sum(rkj * rkj, axis=0))
            uij = rij / bij[None]
            ukj = rkj / bkj[None]
            cosA = jnp.clip(jnp.sum(uij * ukj, axis=0),
                            -1.0 + 1e-7, 1.0 - 1e-7)
            kt, t0 = parm[:, 0], parm[:, 1]
            sinA = jnp.sqrt(1.0 - cosA * cosA)
            sin2 = 1.0 - cosA * cosA
            aD_h = jnp.arccos(cosA) - t0
            e_h = kt * aD_h * aD_h
            coef_h = 2.0 * kt * aD_h / sinA
            aD_c = cosA - t0
            e_c = kt * aD_c * aD_c
            coef_c = -2.0 * kt * aD_c
            e_r = kt * aD_c * aD_c / sin2
            coef_r = -2.0 * kt * aD_c * (1.0 - cosA * t0) / (sin2 * sin2)
            e_a = wmul(jnp.select([kind == 0, kind == 1, kind == 2],
                                  [e_h, e_c, e_r]))
            coef = wmul(jnp.select([kind == 0, kind == 1, kind == 2],
                                   [coef_h, coef_c, coef_r]))
            fi = (coef / bij)[None] * (ukj - uij * cosA[None])
            fk = (coef / bkj)[None] * (uij - ukj * cosA[None])
            zA = jnp.zeros_like(e_a)
            emit(loc, [fi, -(fi + fk), fk], [zA, e_a, zA])
            virial = virial + jnp.einsum("atm,ctm->ac", fi, rij) \
                + jnp.einsum("atm,ctm->ac", fk, rkj)
            e = e + jnp.sum(e_a)

        for key, harmonic in (("torsions", False), ("impropers", True)):
            if key not in fams:
                continue
            fam = fams[key]
            loc = fam["loc"]
            parm = fam["torsion_parms" if key == "torsions"
                       else "improper_parms"]
            rj_ = gatherA(loc[:, 1])
            d0 = san(_min_image_c(gatherA(loc[:, 0]) - rj_,
                                  L[:, None, None]), (1.0, 0.0, 0.0))
            d2_ = san(_min_image_c(gatherA(loc[:, 2]) - rj_,
                                   L[:, None, None]), (0.0, 1.0, 0.0))
            d3 = san(_min_image_c(gatherA(loc[:, 3]) - rj_,
                                  L[:, None, None]), (0.0, 1.0, 1.0))

            def tors_e(d0, d2_, d3, parm=parm, harmonic=harmonic):
                b1 = -d0
                b2 = d2_
                b3 = d3 - d2_
                n1 = jnp.cross(b1, b2, axis=0)
                n2 = jnp.cross(b2, b3, axis=0)
                b2n = jnp.sqrt(jnp.sum(b2 * b2, axis=0))
                x = jnp.sum(n1 * n2, axis=0)
                y = jnp.sum(jnp.cross(n1, n2, axis=0) * b2, axis=0) / b2n
                phi = jnp.arctan2(y, x)
                if harmonic:
                    kpsi, psi0 = parm[:, 0], parm[:, 1]
                    dphi = phi - psi0
                    dphi = dphi - 2.0 * jnp.pi * jnp.round(
                        dphi / (2.0 * jnp.pi))
                    return kpsi * dphi * dphi
                kchi, nper, delta = parm[:, 0], parm[:, 1], parm[:, 2]
                return kchi * (1.0 + jnp.cos(nper * phi - delta))

            e_t, pull = jax.vjp(
                lambda a, b, c: jnp.sum(wmul(tors_e(a, b, c))), d0, d2_, d3)
            g0, g2, g3 = pull(jnp.ones((), dtype=dtype))
            e_terms = wmul(tors_e(d0, d2_, d3))
            fi, fk, fl = -g0, -g2, -g3
            fj = -(fi + fk + fl)
            zT = jnp.zeros_like(e_terms)
            emit(loc, [fi, fj, fk, fl], [zT, e_terms, zT, zT])
            virial = virial + jnp.einsum("atm,ctm->ac", fi, d0) \
                + jnp.einsum("atm,ctm->ac", fk, d2_) \
                + jnp.einsum("atm,ctm->ac", fl, d3)
            e = e + e_t

        if "bpairs" in fams:
            fam = fams["bpairs"]
            loc = fam["loc"]
            parm = fam["bpair_parms"]                    # (T, 3, M)
            dr = san(_min_image_c(gatherA(loc[:, 0]) - gatherA(loc[:, 1]),
                                  L[:, None, None]), (1.0, 0.0, 0.0))
            r2 = jnp.sum(dr * dr, axis=0)
            ir2 = 1.0 / r2
            sg, ep, sh = parm[:, 0], parm[:, 1], parm[:, 2]
            s2 = sg * sg * ir2
            s6 = s2 * s2 * s2
            s12 = s6 * s6
            within = wmul((r2 < meta["bpair_rcut2"]).astype(dtype))
            e_p = (4.0 * ep * (s12 - s6) + sh) * within
            dvdr = 24.0 * ep * (s6 - 2.0 * s12) * ir2 * within
            fi = -dvdr[None] * dr
            emit(loc, [fi, -fi], [0.5 * e_p, 0.5 * e_p])
            virial = virial + jnp.einsum("atm,ctm->ac", fi, dr)
            e = e + jnp.sum(e_p)

        if "exclusions" in fams:
            fam = fams["exclusions"]
            loc = fam["loc"]
            qq = fam["excl_qq"][:, 0, :]                 # (T, M)
            dr = san(_min_image_c(gatherA(loc[:, 0]) - gatherA(loc[:, 1]),
                                  L[:, None, None]), (1.0, 0.0, 0.0))
            r2 = jnp.sum(dr * dr, axis=0)
            w = wmul((r2 < meta["rcut2"]).astype(dtype))
            if meta.get("excl_mode") == "rf_add":
                krf = meta["excl_krf"]
                crf = meta["excl_crf"]
                e_x = qq * (krf * r2 - crf) * w
                dvdr = qq * (2.0 * krf) * w
            else:
                ir2 = 1.0 / r2
                ir = jnp.sqrt(ir2)
                sig = fam["sigma_flat"]                  # (T, M)
                eps = fam["eps_flat"]
                shf = fam["shift_flat"]
                s2 = sig * sig * ir2
                s6 = s2 * s2 * s2
                s12 = s6 * s6
                e_x = -(4.0 * eps * (s12 - s6) + shf + qq * ir) * w
                dvdr = -(24.0 * eps * (s6 - 2.0 * s12) * ir2
                         - qq * ir2 * ir) * w
            fi = -dvdr[None] * dr
            emit(loc, [fi, -fi], [0.5 * e_x, 0.5 * e_x])
            virial = virial + jnp.einsum("atm,ctm->ac", fi, dr)
            e = e + jnp.sum(e_x)

        if not contribs_f:
            continue
        # accumulate slots -> local atoms with a static one-hot matmul
        # (the matmul does the "scatter"); S = total term-role slots
        C = jnp.concatenate(contribs_f, axis=1)          # (3, S, M)
        PEc = jnp.concatenate(contribs_pe, axis=0)       # (S, M)
        slots = np.concatenate(slot_atoms)               # (S,)
        W = np.zeros((len(slots), A), np.float32)
        W[np.arange(len(slots)), slots] = 1.0
        Wj = jnp.asarray(W, dtype)
        Fmol = jnp.einsum("csm,sa->cam", C,
                          Wj, precision=jax.lax.Precision.HIGHEST)
        PEmol = jnp.einsum("sm,sa->am", PEc, Wj,
                           precision=jax.lax.Precision.HIGHEST)
        Ff = Fmol.transpose(2, 1, 0).reshape(M * A, 3)
        PEf = PEmol.transpose(1, 0).reshape(M * A)
        if resolved is not None:
            # disowned instances carry exactly-zero (weighted)
            # contributions, so their resolver-sentinel rows add nothing
            f = f.at[rows_t].add(Ff, mode="drop")
            pe = pe.at[rows_t].add(PEf, mode="drop")
        elif tp["start"] is not None:
            f = jax.lax.dynamic_update_slice(
                f, jax.lax.dynamic_slice(
                    f, (tp["start"], 0), (M * A, 3)) + Ff,
                (tp["start"], 0))
            pe = jax.lax.dynamic_update_slice(
                pe, jax.lax.dynamic_slice(
                    pe, (tp["start"],), (M * A,)) + PEf,
                (tp["start"],))
        else:
            f = f.at[tp["rows"]].add(Ff)
            pe = pe.at[tp["rows"]].add(PEf)
    return f, e, virial, pe
