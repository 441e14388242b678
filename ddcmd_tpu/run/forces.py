"""Force orchestration: one fused force function from all potentials.

ddcenergy analog (/root/reference/src/ddcenergy.c:160-238): evaluate
every POTENTIAL on the current state and accumulate force/energy/virial.
Here all terms fuse into one jitted function (XLA fuses the elementwise
chains into the neighbor gathers).
"""

from __future__ import annotations

import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np

from ..core.system import SystemDef
from ..ops.cellpair import (cellpair_eval_half, half_back_map, half_grid,
                            pbc_allowed)
from ..potentials.martini import martini_device_tables, martini_nonbond
from ..potentials.pair import pair_device_tables, pair_lj

ENGINES = ("pallas", "cellblock", "nlist")


def _inlist_excl(sysdef, engine) -> bool:
    """True when the pair engine masks excluded pairs IN-ENGINE (and the
    bonded block adds back only the kept RF term): the (N,K)-list engine
    masks in-list; the pallas kernel masks in-kernel via the exclusion
    record channels (when the topology fits the exact-f32 encoding)."""
    if (sysdef.bonded is None or sysdef.bonded.exclusions is None
            or os.environ.get("DDCMD_INLIST_EXCL", "1") == "0"):
        return False
    if engine == "nlist":
        return True
    if engine == "pallas":
        # only the MARTINI nonbond term masks in-kernel; a PAIR-potential
        # deck with exclusions keeps compute-then-subtract
        return (any(p[0] == "MARTINI" for p in sysdef.potentials)
                and _excl_channels(sysdef.bonded.exclusions,
                                   sysdef.state.n_pad) is not None)
    return False


def kernel_unsupported(sysdef, dtype) -> str | None:
    """Why the pallas pair kernel cannot run this deck (None if it can):
    float32, orthorhombic, fully periodic, MARTINI / analytic PAIR pair
    terms, and an exclusion graph that fits the in-kernel encoding."""
    if jnp.dtype(dtype) != jnp.float32:
        return "the kernel computes in float32"
    if not sysdef.box.ortho:
        return "triclinic box"
    if int(sysdef.box.pbc) & 7 != 7:
        return "non-periodic axes"
    for ptype, _, parms in sysdef.potentials:
        if ptype in ("EAM", "PAIRENERGY", "ORDERSH") or (
                ptype == "PAIR" and parms.table is not None):
            return f"{ptype} pair term"
    bt = sysdef.bonded
    if (bt is not None and bt.exclusions is not None
            and os.environ.get("DDCMD_INLIST_EXCL", "1") != "0"
            and _excl_channels(bt.exclusions, sysdef.state.n_pad) is None):
        return "exclusion graph wider than the in-kernel encoding"
    return None


def choose_engine(sysdef, dtype, requested: str = "auto",
                  backend: str | None = None,
                  interpret: bool = False) -> str:
    """The pair engine for a deck, chosen by backend:

    * decks with nlist-only terms (PAIRENERGY, ORDERSH) run on 'nlist';
    * the CPU runs the XLA 'cellblock' engine;
    * a GPU runs the 'pallas' kernel where kernel_unsupported allows it
      and 'nlist' otherwise: on an H100 XLA's nlist engine ran EAM
      copper 2x faster than cellblock (PERF.md), and it masks excluded
      pairs in-list (the f32 subtract residual is unsafe, see
      _excl_channels).

    An explicit request the backend or the deck cannot honour raises.
    interpret=True stands in for a GPU: the kernel then runs in Pallas
    interpret mode on the CPU (tests and rehearsals only)."""
    if requested not in ("auto",) + ENGINES:
        raise ValueError(f"unknown engine {requested!r}")
    gpu = (backend or jax.default_backend()) == "gpu" or interpret
    if any(p[0] in ("PAIRENERGY", "ORDERSH") for p in sysdef.potentials):
        if requested not in ("auto", "nlist"):
            raise ValueError(f"engine={requested!r}: PAIRENERGY/ORDERSH "
                             "run on the nlist engine only")
        return "nlist"
    why = kernel_unsupported(sysdef, dtype)
    if requested == "pallas":
        if not gpu:
            raise ValueError(
                "engine='pallas' needs a GPU; interpret=True runs it on "
                "the CPU for tests")
        if why:
            raise ValueError(f"engine='pallas' cannot run this deck: {why}")
        return "pallas"
    if requested != "auto":
        return requested
    if not gpu:
        return "cellblock"
    if why is None:
        return "pallas"
    if why.startswith("exclusion graph"):
        warnings.warn(
            "exclusion graph exceeds the in-kernel encoding (>12-member "
            "component): running the nlist engine, which masks excluded "
            "pairs in-list", stacklevel=3)
    return "nlist"


def _uniform_type_tables(sysdef, tables, tmap):
    """Collapse the LJ tables to 1x1 when the collection uses a single LJ
    type (the Martini waterbox): the engines then read scalar
    parameters instead of per-pair table lookups.  tmap: species -> LJ
    type."""
    n_loc = sysdef.state.n_local
    used = np.unique(np.asarray(tmap)[
        np.asarray(sysdef.state.species[:n_loc])])
    if len(used) != 1:
        return tables, tmap
    t0 = int(used[0])
    tables = dict(tables, **{k: tables[k][t0:t0 + 1, t0:t0 + 1]
                             for k in ("sigma", "eps", "shift")})
    return tables, jnp.zeros_like(tmap)


def _excl_channels(exclusions, n_pad: int):
    """Per-particle in-kernel exclusion channels (n_pad, 2) f32:
    [component_id, B + 2^-intra] with B the exclusion bitmask over the
    particle's connected component of the exclusion graph.  All values
    are EXACT in f32 when every component has <= 12 members (B < 2^12,
    2^-intra >= 2^-11 spans 23 mantissa bits); returns None otherwise
    and the caller falls back to compute-then-subtract.  Why in-kernel:
    the subtract residual is O(|F_LJ| * 5e-6) -- harmless at bond rest
    length, but a rare ~11 kT bond compression makes |F_LJ| ~ 1e9 and
    the residual becomes a catapult (the 94k-bilayer NaN forensics, r4).
    The reference prunes excluded pairs from the list for the same
    reason (nlistGPU.cu exclusion filtering)."""
    ex = np.asarray(exclusions)
    if len(ex) == 0:
        return None
    parent = np.arange(n_pad)

    def find(x):
        root = x
        while parent[root] != root:
            root = parent[root]
        while parent[x] != root:
            parent[x], x = root, parent[x]
        return root

    for i, j in ex:
        parent[find(int(i))] = find(int(j))
    from collections import defaultdict

    comps = defaultdict(list)
    for i, j in ex:
        comps[find(int(i))].append(int(i))
        comps[find(int(j))].append(int(j))
    vals = np.zeros((n_pad, 2), np.float32)
    intra = {}
    for cid, (root, members) in enumerate(comps.items()):
        members = sorted(set(members))
        if len(members) > 12:
            return None
        for k, m in enumerate(members):
            intra[m] = k
            vals[m, 0] = float(cid + 1)
    B = np.zeros(n_pad, np.int64)
    for i, j in ex:
        B[int(i)] |= 1 << intra[int(j)]
        B[int(j)] |= 1 << intra[int(i)]
    rows = np.asarray(sorted(intra.keys()))
    # fraction stores 2^-(intra+1) (intra=0 must stay fractional); the
    # kernel doubles it back -- both steps exact powers of two
    vals[rows, 1] = (B[rows] + np.exp2(
        -np.asarray([intra[m] for m in rows], np.float64) - 1.0)
    ).astype(np.float32)
    return vals


def _excl_table(exclusions, n_pad: int) -> np.ndarray:
    """(n_pad, Emax) int32 per-atom excluded-partner rows, sentinel
    n_pad, both directions of each (i, j)."""
    from collections import defaultdict

    nbrs = defaultdict(list)
    for i, j in np.asarray(exclusions):
        nbrs[int(i)].append(int(j))
        nbrs[int(j)].append(int(i))
    emax = max(len(v) for v in nbrs.values())
    tbl = np.full((n_pad, emax), n_pad, dtype=np.int32)
    for i, v in nbrs.items():
        tbl[i, :len(v)] = v
    return tbl


def _geom(box):
    """Pair-engine box geometry: (3,) lengths for an orthorhombic box,
    the full (3,3) h for a triclinic one (box.ortho is static)."""
    return box.lengths if box.ortho else box.h

def build_force_fn(sysdef: SystemDef, dtype=jnp.float32, engine: str = "cellblock",
                   grid=None, interpret: bool = False):
    """Returns force_fn(state, box, handle) -> (f, e_pot, virial, pe).

    engine 'cellblock': handle is the slot permutation from
    ops.cellpair.build_cell_slots (XLA cell blocks).
    engines 'pallas' / 'nlist': handle is the (N,K) neighbor index list;
    'pallas' evaluates MARTINI/PAIR with the GPU kernel
    (ops/pallas_nlist.py), 'nlist' in plain XLA.  interpret=True runs
    the kernel on the CPU (tests)."""
    terms = []
    for ptype, name, parms in sysdef.potentials:
        if ptype == "MARTINI":
            tables = martini_device_tables(parms, dtype=dtype)
            tmap = jnp.asarray(parms.species_lj_type)
            # reaction-field Coulomb is dead weight when every local charge
            # is zero (the Martini waterbox: W beads) -- skip the per-pair
            # RF math and the (zero) self-energy entirely
            n_loc0 = sysdef.state.n_local
            coul = bool(np.any(np.asarray(sysdef.state.q[:n_loc0]) != 0.0))

            if engine == "pallas":
                from ..ops.pallas_nlist import nlist_pair_eval

                tables, tmap = _uniform_type_tables(sysdef, tables, tmap)
                # in-kernel bonded-pair exclusions (exclude-from-list
                # discipline) -- see _excl_channels
                excl_vals = None
                if _inlist_excl(sysdef, engine):
                    excl_vals = jnp.asarray(_excl_channels(
                        sysdef.bonded.exclusions, sysdef.state.n_pad))

                def martini_term(state, box, nbr_idx, tables=tables,
                                 tmap=tmap, coul=coul, excl_vals=excl_vals):
                    f, e, virial, pe = nlist_pair_eval(
                        state.r, state.q, tmap[state.species], state.fmask,
                        nbr_idx, box.lengths, tables, coulomb=coul,
                        excl_vals=excl_vals, interpret=interpret)
                    if not coul:
                        return f, e, virial, pe
                    e_self_i = (-0.5 * state.q * state.q * state.fmask
                                * tables["keR"] * tables["crf"])
                    return f, e + jnp.sum(e_self_i), virial, pe + e_self_i
            elif engine == "cellblock":
                tables, tmap = _uniform_type_tables(sysdef, tables, tmap)
                hg = half_grid(grid)
                back = jnp.asarray(half_back_map(hg))
                allowed = pbc_allowed(hg, sysdef.box.pbc)

                def martini_term(state, box, handle, tables=tables, tmap=tmap,
                                 coul=coul, hg=hg, back=back, allowed=allowed):
                    tidx = tmap[state.species]
                    f, e, virial, pe = cellpair_eval_half(
                        state.r, state.q, tidx, handle, _geom(box), hg,
                        tables, back, coulomb=coul, allowed=allowed)
                    if not coul:
                        return f, e, virial, pe
                    e_self_i = (-0.5 * state.q * state.q * state.fmask
                                * tables["keR"] * tables["crf"])
                    return f, e + jnp.sum(e_self_i), virial, pe + e_self_i
            else:
                # (N,K)-list engine: mask excluded pairs IN-LIST when the
                # topology carries exclusions (DDCMD_INLIST_EXCL=0 opts
                # back into compute-then-subtract).  The huge 1-2/1-3
                # LJ/bare-Coulomb terms then never enter any f32 sum --
                # the reference's exclude-from-list discipline
                # (bioCharmmPar exclude lists pruned in nlistGPU.cu).
                excl_tbl = None
                if _inlist_excl(sysdef, engine):
                    excl_tbl = jnp.asarray(
                        _excl_table(sysdef.bonded.exclusions,
                                    sysdef.state.n_pad))

                def martini_term(state, box, handle, tables=tables,
                                 tmap=tmap, excl_tbl=excl_tbl):
                    tidx = tmap[state.species]
                    f, e, virial, pe, _ = martini_nonbond(
                        state.r, state.q, tidx, state.fmask, handle,
                        _geom(box), tables, excl_tbl=excl_tbl)
                    return f, e, virial, pe

            terms.append(martini_term)
        elif ptype == "PAIR":
            tables = pair_device_tables(parms, dtype=dtype)

            if engine == "pallas":
                from ..ops.pallas_nlist import nlist_pair_eval

                def pair_term(state, box, nbr_idx, tables=tables):
                    return nlist_pair_eval(
                        state.r, state.q, state.species, state.fmask,
                        nbr_idx, box.lengths, tables, coulomb=False,
                        interpret=interpret)
            elif engine == "cellblock":
                lj_tables = dict(tables)
                hg = half_grid(grid)
                back = jnp.asarray(half_back_map(hg))
                allowed = pbc_allowed(hg, sysdef.box.pbc)

                def pair_term(state, box, handle, tables=lj_tables, hg=hg,
                              back=back, allowed=allowed):
                    return cellpair_eval_half(
                        state.r, state.q, state.species, handle, _geom(box),
                        hg, tables, back, coulomb=False, allowed=allowed)
            else:
                def pair_term(state, box, handle, tables=tables):
                    return pair_lj(state.r, state.species, state.fmask, handle,
                                   _geom(box), tables)

            terms.append(pair_term)
        elif ptype == "EAM":
            from ..potentials.eam import eam_device_tables, eam_eval

            etables = eam_device_tables(parms, dtype=dtype)
            if engine == "cellblock":
                from ..ops.cellpair_eam import eam_cellblock_eval_half

                hg = half_grid(grid)
                back = jnp.asarray(half_back_map(hg))

                def eam_term(state, box, perm, etables=etables, hg=hg,
                             back=back):
                    return eam_cellblock_eval_half(
                        state.r, state.species, state.fmask, perm,
                        _geom(box), hg, etables, back)
            else:
                def eam_term(state, box, nbr_idx, etables=etables):
                    return eam_eval(state.r, state.species, state.fmask,
                                    nbr_idx, _geom(box), etables)

            terms.append(eam_term)
        elif ptype == "ORDERSH":
            from ..potentials.ordersh import make_ordersh_eval

            osh_eval = make_ordersh_eval(parms, sysdef.state.n_local, dtype)
            if engine != "nlist":
                raise NotImplementedError(
                    "ORDERSH runs on the nlist engine; Simulation auto-selects it")

            def ordersh_term(state, box, nbr_idx, osh_eval=osh_eval):
                f, e, virial, pe, phi = osh_eval(
                    state.r, state.fmask, nbr_idx, _geom(box))
                return f, e, virial, pe

            terms.append(ordersh_term)
        elif ptype == "PAIRENERGY":
            from ..potentials.pairenergy import (pairenergy_device_tables,
                                                 pairenergy_eval)

            ptables = pairenergy_device_tables(parms, dtype=dtype)
            if engine != "nlist":
                raise NotImplementedError(
                    "PAIRENERGY runs on the nlist engine; "
                    "Simulation auto-selects it")

            def pe_term(state, box, nbr_idx, ptables=ptables):
                return pairenergy_eval(state.r, state.species, state.fmask,
                                       nbr_idx, _geom(box), ptables)

            terms.append(pe_term)
        elif ptype == "RESTRAINT":
            from ..potentials.restraint import restraint_eval

            # map restrained gids -> state rows (host, once)
            gid64 = sysdef.state.gid64()
            row_of = {int(g): i for i, g in enumerate(gid64)}
            rows = jnp.asarray([row_of[int(g)] for g in parms.gids], dtype=jnp.int32)
            r0 = jnp.asarray(parms.r0, dtype=dtype)
            kb = jnp.asarray(parms.kb, dtype=dtype)
            am = jnp.asarray(parms.axis_mask, dtype=dtype)

            def restraint_term(state, box, nbr_idx, rows=rows, r0=r0, kb=kb, am=am):
                return restraint_eval(state.r, state.fmask, _geom(box),
                                      rows, r0, kb, am)

            terms.append(restraint_term)
        elif ptype in ("NONE", "REFLECT"):
            continue  # REFLECT is a post-drift hook (integrator), not a force
        else:
            raise NotImplementedError(f"force term {ptype}")

    # covalent terms (bonds/angles/torsions/bpairs/exclusion corrections)
    bt = sysdef.bonded
    if bt is not None and any(v for k, v in bt.counts().items()
                              if k not in ("n_constraints", "cons_groups")):
        from ..objects import units as U
        from ..potentials.bonded import bonded_eval, device_bonded_tables

        mparms = next(p[2] for p in sysdef.potentials if p[0] == "MARTINI")
        charges = np.asarray(sysdef.state.q)
        btab = device_bonded_tables(
            bt, dtype,
            lj_sigma=mparms.sigma, lj_eps=mparms.eps, lj_shift=mparms.shift,
            rcut=mparms.rcut, keR=U.ke / mparms.epsilon_r,
            charges=charges,
            species_lj_type=mparms.species_lj_type,
            species_per_particle=np.asarray(sysdef.state.species),
            excl_mode="rf_add" if _inlist_excl(sysdef, engine) else "subtract",
            krf=mparms.krf, crf=mparms.crf)
        n_pad = sysdef.state.n_pad
        # incidence-ledger assembly (gather instead of scatter-add; the
        # (n_pad, D) gather pads D to the max degree and row-gathers
        # n_pad*D rows vs the scatter's 2T) -- default OFF, kept for
        # A/Bs (not measured on the GPU); the production path is the
        # residue-template batched evaluator below
        if os.environ.get("DDCMD_BONDED_LEDGER", "0") == "1":
            from ..potentials.bonded import build_bonded_ledger

            led = build_bonded_ledger(btab, n_pad)
            if led is not None:
                btab = dict(btab, ledger=jnp.asarray(led))

        # residue-template batched evaluation (potentials/bonded_batch):
        # intra-residue terms run as lane-dense per-type batches with
        # one-hot matmul accumulation -- no per-term gather/scatter; terms
        # crossing instances (CHARMM junctions, CMAP) stay on the
        # generic path via the leftover dict.  DDCMD_BONDED_BATCH=0
        # opts back into the generic evaluator.
        bplan = None
        if (os.environ.get("DDCMD_BONDED_BATCH", "1") != "0"
                and sysdef.residue_instances):
            from ..potentials.bonded_batch import build_batched_bonded

            bplan, btab_left = build_batched_bonded(
                btab, sysdef.residue_instances, n_pad, dtype)

        if bplan is not None:
            from ..potentials.bonded_batch import batched_bonded_eval

            has_left = any(k in btab_left for k in
                           ("bonds", "angles", "torsions", "impropers",
                            "bpairs", "exclusions", "cmap_atoms"))

            def bonded_term(state, box, nbr_idx, bplan=bplan,
                            btab_left=btab_left, n_pad=n_pad,
                            has_left=has_left):
                f, e, virial, pe = batched_bonded_eval(
                    state.r, _geom(box), bplan, n_pad, dtype)
                if has_left:
                    f2, e2, v2, pe2 = bonded_eval(
                        state.r, _geom(box), btab_left, n_pad, dtype)
                    f, e, virial, pe = f + f2, e + e2, virial + v2, pe + pe2
                return f, e, virial, pe
        else:
            def bonded_term(state, box, nbr_idx, btab=btab, n_pad=n_pad):
                return bonded_eval(state.r, _geom(box), btab, n_pad, dtype)

        terms.append(bonded_term)

    # EXTFORCE groups: constant external force on member particles
    # (extforce.c; group contract group.h:9-80)
    ext = np.array([g.extforce for g in sysdef.groups], dtype=np.float64)
    if np.any(ext != 0.0):
        ext_j = jnp.asarray(ext, dtype=dtype)

        def extforce_term(state, box, nbr_idx, ext_j=ext_j):
            fi = ext_j[state.group] * state.fmask[:, None]
            e = -jnp.sum(fi * state.r)  # V = -F.r
            pe = -jnp.sum(fi * state.r, axis=1)
            virial = jnp.zeros((3, 3), dtype=dtype)
            return fi, e, virial, pe

        terms.append(extforce_term)

    def force_fn(state, box, nbr_idx):
        n_pad = state.n_pad
        f = jnp.zeros((n_pad, 3), dtype=dtype)
        pe = jnp.zeros((n_pad,), dtype=dtype)
        virial = jnp.zeros((3, 3), dtype=dtype)
        for term in terms:
            tf, _te, tv, tpe = term(state, box, nbr_idx)
            f = f + tf
            virial = virial + tv
            pe = pe + tpe
        # total energy from the per-particle sums, AFTER all terms: every
        # term keeps e == sum(pe) (parity-tested), and for all-atom
        # CHARMM the bonded-exclusion correction (~ -1e6) cancels the
        # nonbond engine's excluded-pair energy (~ +1e6) PER PARTICLE
        # here instead of between two huge f32 totals -- summing the
        # totals first loses ~7 digits of the reported energy
        return f, jnp.sum(pe), virial, pe

    # expose the term list for per-term phase attribution
    # (Simulation.profile_phases detail mode; ptiming.h per-object timers)
    force_fn.terms = terms
    return force_fn
