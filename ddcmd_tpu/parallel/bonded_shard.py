"""Sharded bonded terms: gid-keyed covalent topology on a device mesh.

Reference analog: ddcMD keeps covalent term lists on every rank and the
MOLECULE ddcRule rewrites migration destinations so whole molecules stay
on one rank (ddcRuleMolecule, /root/reference/src/ddcRuleMolecule.c:43);
each rank then evaluates the terms whose atoms it owns.

Device shape: the per-term PARAMETERS are row-independent constants, so the
full term lists ride along as replicated device arrays keyed by GID.
Each device resolves gids -> local pool rows (sorted local+ghost gids +
searchsorted -- a pure gather, no communication) every force call, masks
the terms whose first atom it owns, and reuses the single-chip
bonded_eval with per-term weights.  Molecule-coherent migration (anchor
= head-bead position, parallel/brick.py) guarantees every owned term's
atoms are local.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np


def pack_gid(gid_pair):
    """(n,2) uint32 [lo, hi] -> sortable scalar key.

    With jax_enable_x64: int64 lo + (hi << 32) (full bio gids).  In
    32-bit mode int64 is unavailable on device, so gids must fit the
    low word (hi == 0) and the key is the int32 low word -- callers with
    mol<<32 bio gids must enable x64 for the sharded bonded path."""
    import jax

    if jax.config.jax_enable_x64:
        g = gid_pair.astype(jnp.int64)
        return g[:, 0] + (g[:, 1] << 32)
    return gid_pair[:, 0].astype(jnp.int32)


def bonded_gid_tables(bt, gid, device_tables):
    """Host-side: replace the state-row index arrays in device_bonded_tables
    output with GID index arrays (int64).  `gid` maps rows -> gids."""
    import jax

    gid = np.asarray(gid, dtype=np.int64)
    if not jax.config.jax_enable_x64 and gid.max() >= 2 ** 31:
        raise ValueError("sharded bonded terms with >31-bit gids require "
                         "jax_enable_x64 (pack_gid key width)")
    out = dict(device_tables)
    for fam in ("bonds", "angles", "torsions", "impropers", "bpairs",
                "exclusions"):
        arr = getattr(bt, fam, None)
        if arr is not None and fam in out:
            out[fam + "_gids"] = jnp.asarray(gid[np.asarray(arr)])
            del out[fam]          # rows are resolved per device per call
    if getattr(bt, "cmap_atoms", None) is not None and "cmap_atoms" in out:
        out["cmap_atoms_gids"] = jnp.asarray(
            gid[np.asarray(bt.cmap_atoms)])
        del out["cmap_atoms"]     # resolved per device like other families
    return out


def resolve_terms(tables, pool_gid64, pool_mask, local_cap):
    """Per-device: map gid-keyed term tables to pool-row tables + weights.

    pool_gid64: (n_pool,) int64 gids of local+ghost rows; padded rows
    must be masked off by pool_mask.  A term is owned iff ALL its atoms
    resolve AND its first atom is a local (not ghost) row -- molecule
    coherence makes ownership unambiguous and exactly-once across the
    mesh."""
    n_pool = pool_gid64.shape[0]
    big = jnp.asarray(jnp.iinfo(pool_gid64.dtype).max, pool_gid64.dtype)
    keyed = jnp.where(pool_mask, pool_gid64, big)
    order = jnp.argsort(keyed)
    sg = keyed[order]

    out = {}
    for fam in ("bonds", "angles", "torsions", "impropers", "bpairs",
                "exclusions", "cmap_atoms"):
        g = tables.get(fam + "_gids")
        if g is None:
            continue
        pos = jnp.clip(jnp.searchsorted(sg, g), 0, n_pool - 1)
        rows = order[pos]
        found = sg[pos] == g
        # ownership by the anchor atom: first atom for 2/3/4-body terms,
        # the N anchor (slot 1) for 5-atom CMAP terms
        anchor = 1 if fam == "cmap_atoms" else 0
        owned = jnp.all(found, axis=-1) & (rows[:, anchor] < local_cap)
        out[fam] = jnp.where(found, rows, 0).astype(jnp.int32)
        out[fam + "_w"] = owned.astype(jnp.float32)
    # per-term constants pass through unchanged
    for k, v in tables.items():
        if not k.endswith("_gids") and k not in out:
            out[k] = v
    return out


def leftover_gid_tables(leftover: dict, gid):
    """Gid-key the row-indexed families of a bonded_batch LEFTOVER dict
    (junction terms, CMAP) for per-device resolution -- the same
    transform bonded_gid_tables applies to a full BondedTerms."""
    gid = np.asarray(gid, dtype=np.int64)
    out = dict(leftover)
    for fam in ("bonds", "angles", "torsions", "impropers", "bpairs",
                "exclusions", "cmap_atoms"):
        if fam in out:
            out[fam + "_gids"] = jnp.asarray(gid[np.asarray(out[fam])])
            del out[fam]
    return out


def resolve_batched(plan: dict, pool_gid64, pool_mask, local_cap):
    """Per-device resolution of a bonded_batch plan built with gids:
    for each residue type, map its (M, A) instance gids to pool rows.
    An instance is owned iff ALL its atoms resolve and its FIRST atom is
    a local row (molecule coherence => exactly-once across the mesh).
    Returns a list aligned with plan["types"] of
    (rows (M*A,) int32 [missing -> n_pool sentinel], w (M,) f32)."""
    n_pool = pool_gid64.shape[0]
    big = jnp.asarray(jnp.iinfo(pool_gid64.dtype).max, pool_gid64.dtype)
    keyed = jnp.where(pool_mask, pool_gid64, big)
    order = jnp.argsort(keyed)
    sg = keyed[order]
    out = []
    for tp in plan["types"]:
        g = tp["gids"].astype(pool_gid64.dtype)          # (M, A)
        pos = jnp.clip(jnp.searchsorted(sg, g), 0, n_pool - 1)
        rows = order[pos]
        found = sg[pos] == g
        owned = jnp.all(found, axis=-1) & (rows[:, 0] < local_cap)
        rows = jnp.where(found, rows, n_pool).astype(jnp.int32)
        out.append((rows.reshape(-1), owned.astype(jnp.float32)))
    return out


def constraint_gid_tables(bt, gid):
    """Host-side: gid-keyed constraint groups for the sharded step.

    Returns dict(cons_gids (G,m) int64 [pad -> -1], cons_pairs, cons_dist)
    or None when the topology has no constraints."""
    if bt.cons_atoms is None or bt.n_constraints == 0:
        return None
    gid = np.asarray(gid, dtype=np.int64)
    ca = np.asarray(bt.cons_atoms)
    cg = np.where(ca >= 0, gid[np.clip(ca, 0, len(gid) - 1)], -1)
    return dict(cons_gids=jnp.asarray(cg),
                cons_pairs=np.asarray(bt.cons_pairs),
                cons_dist=np.asarray(bt.cons_dist))


def resolve_constraints(cons_gids, pool_gid64, pool_mask, local_cap):
    """Per-device: map (G,m) gid-keyed constraint groups to pool rows.

    A group is owned iff every non-pad atom resolves to a LOCAL row and
    its first atom is local (molecule coherence makes this exactly-once
    across the mesh).  Returns (atoms (G,m) int32 rows [pad/missing ->
    n_pool sentinel], group_w (G,) f32)."""
    n_pool = pool_gid64.shape[0]
    big = jnp.asarray(jnp.iinfo(pool_gid64.dtype).max, pool_gid64.dtype)
    keyed = jnp.where(pool_mask, pool_gid64, big)
    order = jnp.argsort(keyed)
    sg = keyed[order]

    g = cons_gids
    pad = g < 0
    pos = jnp.clip(jnp.searchsorted(sg, g), 0, n_pool - 1)
    rows = order[pos]
    found = (sg[pos] == g) & ~pad
    local = found & (rows < local_cap)
    owned = (jnp.all(local | pad, axis=-1)
             & jnp.any(local, axis=-1)
             & local[:, 0])
    atoms = jnp.where(local, rows, n_pool).astype(jnp.int32)
    return atoms, owned.astype(jnp.float32)


def molecule_gid_tables(mol, gid):
    """Gid-keyed molecule membership for the sharded molecular virial
    (molecularPressure.c:22-67 rank-parallel analog).

    Returns dict(mol_gids (M,A) int64 [pad -> -1]) or None for trivial
    (single-atom) molecule classes, which need no correction.
    """
    if mol is None or mol.is_trivial:
        return None
    # single-bead molecules contribute an identically-zero correction --
    # drop them (a solvated bilayer otherwise pads ~45k waters to
    # max_atoms: ~1 M wasted gather rows per step; see the single-chip
    # make_molecular_virial_fn fix, r5)
    amask = np.asarray(mol.atom_mask)
    nz = amask.sum(axis=1) > 1.0
    if not nz.any():
        return None
    gid = np.asarray(gid, dtype=np.int64)
    rows = np.asarray(mol.atom_rows)[nz]
    amask = amask[nz]
    A = int(np.count_nonzero(amask, axis=1).max())
    mg = np.where(amask[:, :A] > 0,
                  gid[np.clip(rows[:, :A], 0, len(gid) - 1)], -1)
    return dict(mol_gids=jnp.asarray(mg))
