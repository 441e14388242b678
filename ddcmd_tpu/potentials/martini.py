"""MARTINI coarse-grained force field: nonbond + parameter compilation.

Nonbond physics verified against the reference
(martiniNonBond, /root/reference/src/bioMartini.c:989-1120):

  * shifted LJ:  v += 4 eps ((sigma/r)^12 - (sigma/r)^6) + shift,
    shift = -4 eps ((sigma/rc)^12 - (sigma/rc)^6)
    (CGLennardJones_setShift, bioMartini.c:840-848)
  * reaction-field Coulomb:
    v += (ke/eps_r) qi qj (1/r + krf r^2 - crf),
    dv/dr (1/r) += (ke/eps_r) qi qj (2 krf - 1/r^3)
    krf = (eps_rf - eps_r) / ((2 eps_rf + eps_r) rc^3),
    crf = 3 eps_rf / ((2 eps_rf + eps_r) rc);  eps_rf = -1 means
    eps_rf -> inf: krf = 1/(2 rc^3), crf = 3/(2 rc)
    (bioMartini.c:1238-1243)
  * self energy: -0.5 sum q^2 (ke/eps_r) crf (bioMartini.c:1035)
  * excluded (bonded) pairs keep the RF polarization terms
    (krf r^2 - crf), added by the intra-molecule correction
    (martiniIntraMoleReaction, bioMartini.c:1124-1208).

The XLA formulation evaluates pairs from a FULL padded neighbor list
(each pair from both sides): pure gather + masked elementwise math + row
sums;
energies/virials carry the 0.5 double-count factor.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax.numpy as jnp
import numpy as np

from ..objects import ObjectDB
from ..objects import units as U
from ..nbr.celllist import min_image_geom


@dataclass
class MartiniParms:
    """Compiled MMFF nonbond tables (host)."""

    n_types: int
    sigma: np.ndarray       # (T,T)
    eps: np.ndarray         # (T,T)
    shift: np.ndarray       # (T,T)
    rcut: float
    rcoulomb: float
    epsilon_r: float
    epsilon_rf: float
    krf: float
    crf: float
    type_names: list[str]
    # species-name -> LJ type index (from ATOMPARMS atomTypeID)
    species_to_type: dict[str, int]


def compile_martini(db: ObjectDB, potential_name: str = "martini") -> MartiniParms:
    """Build nonbond tables from the MMFF object tree
    (mmff_init + martiniLJ_parms, /root/reference/src/bioMartini.c:869-955,1210-1246)."""
    pot = db.get(potential_name, "POTENTIAL")
    mmff = db.get(potential_name, "MMFF")

    atom_types = mmff.get_strv("atomTypeList")
    n_types = len(atom_types)

    cutoff = pot.get_with_units("cutoff", "11.0", "Angstrom")
    rcoulomb = pot.get_with_units("rcoulomb", "11.0", "Angstrom")
    epsilon_r = pot.get_float("epsilon_r", 15.0)
    epsilon_rf = pot.get_float("epsilon_rf", -1.0)
    potential_shift = pot.get_int("potential-shift", 1)

    irc = 1.0 / rcoulomb
    irc3 = irc ** 3
    if epsilon_rf != -1.0:
        krf = (epsilon_rf - epsilon_r) / (2 * epsilon_rf + epsilon_r) * irc3
        crf = 3 * epsilon_rf / (2 * epsilon_rf + epsilon_r) * irc
    else:
        krf = 0.5 * irc3
        crf = 1.5 * irc

    sigma = np.zeros((n_types, n_types))
    eps = np.zeros((n_types, n_types))
    for lj_name in mmff.get_strv("ljParms"):
        lj = db.get(lj_name, "LJPARMS")
        i = lj.get_int("indexI")
        j = lj.get_int("indexJ")
        s = lj.get_with_units("sigma", "0.0", "l")
        e = lj.get_with_units("eps", "0.0", "energy")
        sigma[i, j] = sigma[j, i] = s
        eps[i, j] = eps[j, i] = e

    sr = np.divide(sigma, cutoff)
    s6 = sr ** 6
    shift = -4.0 * eps * (s6 * s6 - s6) if potential_shift else np.zeros_like(eps)

    # species name -> LJ type index via RESIPARMS/GROUPPARMS/ATOMPARMS.
    # ddcMD species for bio systems are named <atomName>x<resName> (e.g.
    # WxW = atom W of residue W); getCGLJindexbySpecie
    # (/root/reference/src/bioMartini.c:957-988) resolves by splitting on 'x'.
    species_to_type: dict[str, int] = {}
    for resi_name in mmff.get_strv("resiParms"):
        resi = db.get(resi_name, "RESIPARMS")
        res_name = resi.get_str("resName", resi_name)
        for grp_name in resi.get_strv("groupList"):
            grp = db.get(grp_name, "GROUPPARMS")
            for atom_entry in grp.get_strv("atomList"):
                ap = db.get(atom_entry, "ATOMPARMS")
                atom_name = ap.get_str("atomName")
                tindex = ap.get_int("atomTypeID")
                species_to_type[f"{atom_name}x{res_name}"] = tindex

    return MartiniParms(
        n_types=n_types, sigma=sigma, eps=eps, shift=shift,
        rcut=cutoff, rcoulomb=rcoulomb,
        epsilon_r=epsilon_r, epsilon_rf=epsilon_rf, krf=krf, crf=crf,
        type_names=atom_types, species_to_type=species_to_type,
    )


def martini_device_tables(parms: MartiniParms, dtype=jnp.float32):
    return dict(
        sigma=jnp.asarray(parms.sigma, dtype=dtype),
        eps=jnp.asarray(parms.eps, dtype=dtype),
        shift=jnp.asarray(parms.shift, dtype=dtype),
        rcut2=jnp.asarray(parms.rcut ** 2, dtype=dtype),
        krf=jnp.asarray(parms.krf, dtype=dtype),
        crf=jnp.asarray(parms.crf, dtype=dtype),
        keR=jnp.asarray(U.ke / parms.epsilon_r, dtype=dtype),
    )


def martini_nonbond(r, q, tidx, fmask, nbr_idx, box_lengths, tables,
                    excl_tbl=None):
    """Forces/energy/virial from the full neighbor list.

    Args:
      r: (N,3) wrapped positions.  q: (N,) charges.  tidx: (N,) LJ type.
      fmask: (N,) 1.0 for valid particles.  nbr_idx: (N,K) full list,
      sentinel N.  box_lengths: (3,).  tables: martini_device_tables().
      excl_tbl: optional (N, Emax) int32 per-atom excluded-partner rows
      (sentinel N) -- IN-LIST exclusion masking: excluded pairs are
      dropped here instead of computed-then-subtracted, so their ~1e6-
      scale 1-2 LJ/bare-Coulomb terms never enter any f32 accumulation
      (the reference prunes exclusions from its GPU pages the same way,
      bioCharmm exclude lists / nlistGPU).  The caller must then run the
      bonded exclusion block in "rf_add" mode to restore the RF
      polarization part the reference keeps for excluded pairs
      (bioMartini.c:1124-1208).
    Returns (f (N,3), e_pot scalar, virial (3,3), e_lj, e_ele).
    """
    n_pad = r.shape[0]
    sentinel = n_pad
    dt = r.dtype

    r_ext = jnp.concatenate([r, jnp.zeros((1, 3), dtype=dt)], axis=0)
    q_ext = jnp.concatenate([q, jnp.zeros((1,), dtype=dt)], axis=0)
    t_ext = jnp.concatenate([tidx, jnp.zeros((1,), dtype=tidx.dtype)], axis=0)

    # orthorhombic boxes keep displacements PER COMPONENT ((N,K) each):
    # a materialized (N,K,3) keeps a 3-wide minor dim that tiled layouts
    # pad many-fold (the c36 OOM); triclinic keeps the vector path
    import numpy as _np

    ortho = _np.ndim(box_lengths) == 1
    if ortho:
        L = jnp.asarray(box_lengths, dt)
        d_c = []
        r2 = jnp.zeros(nbr_idx.shape, dt)
        for c in range(3):
            dc = r[:, c][:, None] - r_ext[:, c][nbr_idx]
            dc = dc - L[c] * jnp.round(dc / L[c])
            d_c.append(dc)
            r2 = r2 + dc * dc
    else:
        dr = r[:, None, :] - r_ext[nbr_idx]                   # (N,K,3)
        dr = min_image_geom(dr, box_lengths)
        r2 = jnp.sum(dr * dr, axis=-1)                        # (N,K)

    tj = t_ext[nbr_idx]
    pair_t = tidx[:, None] * tables["sigma"].shape[0] + tj
    sig = tables["sigma"].reshape(-1)[pair_t]
    eps = tables["eps"].reshape(-1)[pair_t]
    shf = tables["shift"].reshape(-1)[pair_t]

    valid = (nbr_idx != sentinel) & (r2 < tables["rcut2"]) & (r2 > 0)
    valid = valid & (fmask[:, None] > 0)
    if excl_tbl is not None:
        excluded = jnp.any(nbr_idx[:, :, None] == excl_tbl[:, None, :],
                           axis=-1)                           # (N, K)
        valid = valid & jnp.logical_not(excluded)
    r2s = jnp.where(valid, r2, jnp.asarray(1.0, dt))          # avoid 0-div
    ir2 = 1.0 / r2s
    ir = jnp.sqrt(ir2)

    s2 = sig * sig * ir2
    s6 = s2 * s2 * s2
    s12 = s6 * s6
    e_lj_pair = 4.0 * eps * (s12 - s6) + shf
    dvdr = 24.0 * eps * (s6 - 2.0 * s12) * ir2                # (dv/dr)/r

    kqq = tables["keR"] * q[:, None] * q_ext[nbr_idx]
    e_ele_pair = kqq * (ir + tables["krf"] * r2s - tables["crf"])
    dvdr = dvdr + kqq * (2.0 * tables["krf"] - ir2 * ir)

    w = valid.astype(dt)
    coef = -(dvdr * w)                                        # (N,K)
    if ortho:
        f = jnp.stack([jnp.sum(coef * d_c[c], axis=1)
                       for c in range(3)], axis=1)            # (N,3)
        virial = 0.5 * jnp.asarray(
            [[jnp.sum(coef * d_c[a] * d_c[b]) for b in range(3)]
             for a in range(3)])
    else:
        fij = coef[:, :, None] * dr                           # force on i
        f = jnp.sum(fij, axis=1)                              # (N,3)
        # virial_ab = 0.5 sum_pairs f_ij,a dr_ij,b (both sides counted)
        virial = 0.5 * jnp.einsum("nka,nkb->ab", fij, dr)

    # per-particle potential energy: half of each pair + own self term
    e_self_i = -0.5 * q * q * fmask * tables["keR"] * tables["crf"]  # bioMartini.c:1035
    pe = 0.5 * jnp.sum((e_lj_pair + e_ele_pair) * w, axis=1) + e_self_i

    e_lj = 0.5 * jnp.sum(e_lj_pair * w)
    e_ele = 0.5 * jnp.sum(e_ele_pair * w) + jnp.sum(e_self_i)

    e_pot = e_lj + e_ele
    return f, e_pot, virial, pe, (e_lj, e_ele)
