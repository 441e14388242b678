"""MOLECULE table (reference /root/reference/src/molecule.c:20-258).

Molecules are defined in the deck (MOLECULECLASS -> MOLECULE objects,
each naming an ordered species list).  Particles are scanned in gid
order and matched greedily against molecule species sequences
(moleculeScanState).  The table drives the molecular virial/pressure
(molecularPressure, /root/reference/src/molecularPressure.c:22-67) and
molecule-coherent domain rules.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from ..objects import DeckError, ObjectDB


@dataclass
class MoleculeClass:
    n_molecules: int
    # padded (n_molecules, max_atoms) int32 state rows; -filled with row 0
    atom_rows: np.ndarray
    atom_mask: np.ndarray       # (n_molecules, max_atoms) 1.0 valid
    owner_offset: np.ndarray    # (n_molecules,) index into atom dimension
    max_atoms: int

    @property
    def is_trivial(self) -> bool:
        """True when every molecule is a single atom (virial correction = 0)."""
        return self.max_atoms == 1


def build_molecule_class(db: ObjectDB, sysobj, species_names_per_particle,
                         gid: np.ndarray) -> MoleculeClass | None:
    mc_name = sysobj.get_str("moleculeClass", "")
    if not mc_name:
        return None
    mc = db.find(mc_name, "MOLECULECLASS")
    if mc is None:
        return None
    mol_types = []
    for mol_name in mc.get_strv("molecules"):
        mobj = db.get(mol_name, "MOLECULE")
        spec_list = mobj.get_strv("species")
        owner = mobj.get_str("ownershipSpecies", spec_list[0])
        mol_types.append((mol_name, spec_list, spec_list.index(owner)))

    order = np.argsort(gid, kind="stable")
    seq = [species_names_per_particle[i] for i in order]
    n = len(seq)
    max_atoms = max(len(s) for _, s, _ in mol_types)

    rows, masks, owners = [], [], []
    i = 0
    while i < n:
        matched = False
        for _, spec_list, own in mol_types:
            m = len(spec_list)
            if i + m <= n and seq[i:i + m] == spec_list:
                idx = [int(order[i + k]) for k in range(m)]
                rows.append(idx + [idx[0]] * (max_atoms - m))
                masks.append([1.0] * m + [0.0] * (max_atoms - m))
                owners.append(own)
                i += m
                matched = True
                break
        if not matched:
            raise DeckError(
                f"particle {order[i]} (species {seq[i]}) matches no MOLECULE sequence")
    return MoleculeClass(
        n_molecules=len(rows),
        atom_rows=np.asarray(rows, dtype=np.int32),
        atom_mask=np.asarray(masks, dtype=np.float64),
        owner_offset=np.asarray(owners, dtype=np.int32),
        max_atoms=max_atoms,
    )


def make_molecular_virial_fn(mol: MoleculeClass | None, dtype=jnp.float32):
    """molecularVirial (/root/reference/src/molecularPressure.c:22-56):
    subtract intra-molecular force moments about each molecule's COM.
    Returns fn(state, box, virial) -> corrected (3,3) virial.
    Single-atom molecules need no correction -- they are FILTERED OUT
    up front (a solvated bilayer pads ~45k single-bead waters to
    max_atoms otherwise: ~1.2 M gathered rows per step for terms that
    are identically zero).  When the remaining
    multi-bead molecules' rows are one contiguous block (builder decks),
    the gather collapses to a static slice.
    """
    if mol is None or mol.is_trivial:
        return None
    nz = np.asarray(mol.atom_mask).sum(axis=1) > 1.0
    if not nz.any():
        return None
    rows_np = np.asarray(mol.atom_rows)[nz]
    amask_np = np.asarray(mol.atom_mask)[nz]
    # trim the pad width to the widest REAL molecule
    A = int(np.count_nonzero(amask_np, axis=1).max())
    rows_np = rows_np[:, :A]
    amask_np = amask_np[:, :A]
    flat = rows_np.reshape(-1)
    start = int(flat[0]) if len(flat) else 0
    contiguous = bool((flat == start + np.arange(len(flat))).all())
    Mn, _ = rows_np.shape

    rows = jnp.asarray(rows_np)                # (M, A)
    amask = jnp.asarray(amask_np, dtype=dtype)
    own = jnp.asarray(np.asarray(mol.owner_offset)[nz])

    def fn(state, box, virial):
        L = box.lengths
        if contiguous:
            r = jax.lax.dynamic_slice(
                state.r, (start, 0), (Mn * A, 3)).reshape(Mn, A, 3)
            f = jax.lax.dynamic_slice(
                state.f, (start, 0), (Mn * A, 3)).reshape(Mn, A, 3)
            m = jax.lax.dynamic_slice(
                state.mass, (start,), (Mn * A,)).reshape(Mn, A) * amask
        else:
            r = state.r[rows]                   # (M, A, 3)
            f = state.f[rows]
            m = state.mass[rows] * amask        # (M, A)
        r0 = jnp.take_along_axis(r, own[:, None, None].repeat(3, -1), axis=1)[:, 0]
        d = r - r0[:, None, :]
        d = d - L * jnp.round(d / L)            # nearestImage
        M = jnp.sum(m, axis=1, keepdims=True)
        com = jnp.sum(m[:, :, None] * d, axis=1) / M
        d = (d - com[:, None, :]) * amask[:, :, None]
        # virial_aa -= sum d_a f_a (diagonal only, reference does diag)
        corr = jnp.einsum("mia,mia->a", d, f)
        return virial - jnp.diag(corr)

    return fn
