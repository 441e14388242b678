"""Bonded (covalent) terms: bonds, angles (harmonic/cosine/REB),
torsions, impropers, bonded LJ pairs, exclusion corrections.

Forms verified against the reference's covalent engines
(/root/reference/src/bioCharmmCovalentEnergiesSorted.c):

  bond (func 1):      e = kb (b - b0)^2                      (:50-57, CHARMM
                      convention -- NO 1/2)
  angle (func 1):     e = ktheta (theta - theta0)^2, theta0 raw radians (:165-171)
  angle cos (func 2): e = ktheta (cosA - theta0)^2, theta0 raw cosine (:292-296)
  angle REB (func 10):e = ktheta (cosA - theta0)^2 / sin^2 A  (:417)
  torsion:            e = kchi (1 + cos(n phi - delta))       (:634)
  improper (CHARMM):  e = kpsi (psi - psi0)^2 wrapped to [-pi, pi]
  bpair:              shifted LJ with per-pair sigma/eps
                      (BpairLennardJones_setShift, bioMartini.c:850-866)
  exclusion:          the nonbond engine computes ALL pairs in cutoff;
                      reference excludes bonded pairs from LJ+bare-Coulomb
                      but keeps the reaction-field polarization terms
                      (martiniIntraMoleReaction, bioMartini.c:1124-1208).
                      correction here = -(LJ+shift) - keR q q / r per
                      excluded pair within cutoff.

Device shape: every term family is a flat padded array of index tuples +
parameters; evaluation is gather -> elementwise math -> scatter-add (term counts
are O(N), far off the hot path; the nonbond cell engine dominates).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np

from ..core.box import inv3x3

from ..objects import DeckError, ObjectDB


# ---------------------------------------------------------------------------
# compiled topology (host)
# ---------------------------------------------------------------------------

@dataclass
class ResidueType:
    name: str
    res_id: int
    atom_names: list[str]
    atom_types: list[int]
    charges: list[float]
    bonds: list[tuple]          # (i, j, kb, b0)
    angles_h: list[tuple]       # (i, j, k, kt, t0)
    angles_cos: list[tuple]
    angles_reb: list[tuple]
    torsions: list[tuple]       # (i, j, k, l, kchi, n, delta)
    impropers: list[tuple]      # (i, j, k, l, kpsi, psi0)
    bpairs: list[tuple]         # (i, j, sigma, eps)
    cons_groups: list[list[tuple]]  # groups of (i, j, r0)
    exclusions: list[tuple]     # (i, j)
    # species names override (terminal-patched CHARMM variants use the
    # n/c delimiter instead of x<name>); None = <atom>x<name>
    species_sig: list[str] | None = None


@dataclass
class BondedTerms:
    """Flat instantiated term arrays (host numpy; rows into State)."""

    bonds: np.ndarray = None          # (B,2) int32
    bond_parms: np.ndarray = None     # (B,2) kb,b0
    angles: np.ndarray = None         # (A,3)
    angle_parms: np.ndarray = None    # (A,2) kt,t0
    angle_kind: np.ndarray = None     # (A,) 0 harmonic, 1 cos, 2 reb
    torsions: np.ndarray = None       # (T,4)
    torsion_parms: np.ndarray = None  # (T,3) kchi,n,delta
    impropers: np.ndarray = None      # (I,4)
    improper_parms: np.ndarray = None  # (I,2) kpsi, psi0
    bpairs: np.ndarray = None         # (P,2)
    bpair_parms: np.ndarray = None    # (P,3) sigma, eps, shift
    exclusions: np.ndarray = None     # (E,2)
    # constraints: padded groups
    cons_atoms: np.ndarray = None     # (G, max_m) rows, pad=-1
    cons_pairs: np.ndarray = None     # (G, max_n, 2) local atom slots in group
    cons_dist: np.ndarray = None      # (G, max_n) r0, pad=0
    n_constraints: int = 0
    # CMAP phi/psi correction terms (charmm.add_chain_links)
    # instance i linked to i+1 (CHARMM inter-residue junctions); domain
    # decomposition keeps whole CHAINS device-coherent from this
    chain_links: np.ndarray = None    # (L,) int64
    cmap_atoms: np.ndarray = None     # (M,5) rows [-C, N, CA, C, +N]
    cmap_type: np.ndarray = None      # (M,)
    cmap_grid: np.ndarray = None      # (K, 24, 24) internal energy
    cmap_y1: np.ndarray = None        # d/dphi per node (deg^-1 scale)
    cmap_y2: np.ndarray = None
    cmap_y12: np.ndarray = None

    def counts(self):
        c = {}
        for k in ("bonds", "angles", "torsions", "impropers", "bpairs",
                  "exclusions", "cmap_atoms"):
            a = getattr(self, k)
            c["cmaps" if k == "cmap_atoms" else k] = 0 if a is None else len(a)
        c["cons_groups"] = 0 if self.cons_atoms is None else len(self.cons_atoms)
        c["n_constraints"] = self.n_constraints
        return c


def compile_residue_types(db: ObjectDB, mmff_name: str, cutoff: float) -> dict[str, ResidueType]:
    """Parse RESIPARMS trees (schema: /root/reference/src/bioMMFF.c:53-220)."""
    mmff = db.get(mmff_name, "MMFF")
    out = {}
    for rp_name in mmff.get_strv("resiParms"):
        rp = db.get(rp_name, "RESIPARMS")
        res_name = rp.get_str("resName", rp_name)
        atom_names, atom_types, charges = [], [], []
        for g in rp.get_strv("groupList"):
            gp = db.get(g, "GROUPPARMS")
            for a in gp.get_strv("atomList"):
                ap = db.get(a, "ATOMPARMS")
                atom_names.append(ap.get_str("atomName"))
                atom_types.append(ap.get_int("atomTypeID"))
                charges.append(ap.get_with_units("charge", "0.0", "q"))
        bonds, angles_h, angles_cos, angles_reb = [], [], [], []
        torsions, impropers, bpairs, exclusions = [], [], [], []
        cons_groups = []
        for b in rp.get_strv("bondList"):
            bp = db.get(b, "BONDPARMS")
            bonds.append((bp.get_int("atomI"), bp.get_int("atomJ"),
                          bp.get_with_units("kb", "0.0", "kJ*mol^-1*nm^-2"),
                          bp.get_with_units("b0", "0.0", "nm")))
        for a in rp.get_strv("angleList"):
            ap = db.get(a, "ANGLEPARMS")
            tup = (ap.get_int("atomI"), ap.get_int("atomJ"), ap.get_int("atomK"),
                   ap.get_with_units("ktheta", "0.0", "kJ*mol^-1"),
                   ap.get_float("theta0", 0.0))
            func = ap.get_int("func", 1)
            if func == 1:
                angles_h.append(tup)
            elif func == 2:
                angles_cos.append(tup)
            elif func == 10:
                angles_reb.append(tup)
            else:
                raise DeckError(f"angle func {func} not supported")
        for t in rp.get_strv("dihedralList"):
            tp = db.get(t, "TORSPARMS")
            func = tp.get_int("func", 1)
            tup4 = (tp.get_int("atomI"), tp.get_int("atomJ"),
                    tp.get_int("atomK"), tp.get_int("atomL"))
            if func == 2:  # GROMACS improper harmonic
                impropers.append(tup4 + (
                    tp.get_with_units("kchi", "0.0", "kJ*mol^-1"),
                    tp.get_float("delta", 0.0)))
            else:
                torsions.append(tup4 + (
                    tp.get_with_units("kchi", "0.0", "kJ*mol^-1"),
                    tp.get_int("n", 1), tp.get_float("delta", 0.0)))
        for e in rp.get_strv("exclusionList"):
            ep = db.get(e, "EXCLUDEPARMS")
            exclusions.append((ep.get_int("atomI"), ep.get_int("atomJ")))
        for c in rp.get_strv("constraintList"):
            cl = db.get(c, "CONSLISTPARMS")
            grp = []
            for s in cl.get_strv("constraintSubList"):
                sp = db.get(s, "CONSPARMS")
                grp.append((sp.get_int("atomI"), sp.get_int("atomJ"),
                            sp.get_with_units("r0", "0.0", "nm")))
            if grp:
                cons_groups.append(grp)
        # bonded LJ pairs ("pairList" in MMFF decks)
        for p in rp.get_strv("pairList"):
            pp = db.get(p, "BPAIRPARMS") or db.get(p, "PAIRPARMS")
            bpairs.append((pp.get_int("atomI"), pp.get_int("atomJ"),
                           pp.get_with_units("sigma", "0.0", "l"),
                           pp.get_with_units("eps", "0.0", "energy")))
        out[res_name] = ResidueType(
            name=res_name, res_id=rp.get_int("resID", 0),
            atom_names=atom_names, atom_types=atom_types, charges=charges,
            bonds=bonds, angles_h=angles_h, angles_cos=angles_cos,
            angles_reb=angles_reb, torsions=torsions, impropers=impropers,
            bpairs=bpairs, cons_groups=cons_groups, exclusions=exclusions)
    return out


def scan_residues(res_types: dict[str, ResidueType], species_names, gid):
    """Map particles to residue instances by gid-ordered species matching
    (<atomName>x<resName>, moleculeScanState analog,
    /root/reference/src/molecule.c:117)."""
    order = np.argsort(np.asarray(gid), kind="stable")
    seq = [species_names[i] for i in order]
    # residue signature: list of species names in atom order
    sigs = {rn: (rt.species_sig or [f"{an}x{rn}" for an in rt.atom_names])
            for rn, rt in res_types.items()}
    instances = []  # (res_name, [state rows])
    i, n = 0, len(seq)
    while i < n:
        for rn, sig in sigs.items():
            m = len(sig)
            if i + m <= n and seq[i:i + m] == sig:
                instances.append((rn, [int(order[i + k]) for k in range(m)]))
                i += m
                break
        else:
            raise DeckError(f"particle {order[i]} ({seq[i]}) starts no known residue")
    return instances


def instantiate_bonded(res_types: dict[str, ResidueType], instances,
                       lj_cutoff: float) -> BondedTerms:
    """Expand per-type term templates over residue instances."""
    bonds, bparm = [], []
    angles, aparm, akind = [], [], []
    tors, tparm = [], []
    imps, iparm = [], []
    bprs, bpparm = [], []
    excl = []
    cons_atoms, cons_pairs, cons_dist = [], [], []

    for rn, rows in instances:
        rt = res_types[rn]
        rows = np.asarray(rows)
        for (i, j, kb, b0) in rt.bonds:
            bonds.append((rows[i], rows[j]))
            bparm.append((kb, b0))
            excl.append((rows[i], rows[j]))
        for kind, lst in ((0, rt.angles_h), (1, rt.angles_cos), (2, rt.angles_reb)):
            for (i, j, k, kt, t0) in lst:
                angles.append((rows[i], rows[j], rows[k]))
                aparm.append((kt, t0))
                akind.append(kind)
        for (i, j, k, l, kchi, n, delta) in rt.torsions:
            tors.append((rows[i], rows[j], rows[k], rows[l]))
            tparm.append((kchi, float(n), delta))
        for (i, j, k, l, kpsi, psi0) in rt.impropers:
            imps.append((rows[i], rows[j], rows[k], rows[l]))
            iparm.append((kpsi, psi0))
        for (i, j, sigma, eps) in rt.bpairs:
            sr6 = (sigma / lj_cutoff) ** 6
            shift = -4.0 * eps * (sr6 * sr6 - sr6)
            bprs.append((rows[i], rows[j]))
            bpparm.append((sigma, eps, shift))
        for (i, j) in rt.exclusions:
            excl.append((rows[i], rows[j]))
        for grp in rt.cons_groups:
            atoms = sorted({a for (i, j, _) in grp for a in (i, j)})
            amap = {a: s for s, a in enumerate(atoms)}
            cons_atoms.append([rows[a] for a in atoms])
            cons_pairs.append([(amap[i], amap[j]) for (i, j, _) in grp])
            cons_dist.append([r0 for (_, _, r0) in grp])
            for (i, j, _) in grp:
                excl.append((rows[i], rows[j]))

    def arr(x, dt=np.int32):
        return np.asarray(x, dtype=dt) if x else None

    # pad constraint groups
    CA = CP = CD = None
    n_cons = 0
    if cons_atoms:
        max_m = max(len(a) for a in cons_atoms)
        max_n = max(len(p) for p in cons_pairs)
        CA = np.full((len(cons_atoms), max_m), -1, dtype=np.int32)
        CP = np.zeros((len(cons_atoms), max_n, 2), dtype=np.int32)
        CD = np.zeros((len(cons_atoms), max_n), dtype=np.float64)
        for g, (a, p, d) in enumerate(zip(cons_atoms, cons_pairs, cons_dist)):
            CA[g, : len(a)] = a
            CP[g, : len(p)] = p
            CD[g, : len(d)] = d
            n_cons += len(p)

    # dedupe exclusions
    if excl:
        es = sorted({(min(i, j), max(i, j)) for (i, j) in excl})
        excl = np.asarray(es, dtype=np.int32)
    else:
        excl = None

    return BondedTerms(
        bonds=arr(bonds), bond_parms=arr(bparm, np.float64),
        angles=arr(angles), angle_parms=arr(aparm, np.float64),
        angle_kind=arr(akind),
        torsions=arr(tors), torsion_parms=arr(tparm, np.float64),
        impropers=arr(imps), improper_parms=arr(iparm, np.float64),
        bpairs=arr(bprs), bpair_parms=arr(bpparm, np.float64),
        exclusions=excl,
        cons_atoms=CA, cons_pairs=CP, cons_dist=CD, n_constraints=n_cons,
    )


# ---------------------------------------------------------------------------
# device evaluation
# ---------------------------------------------------------------------------

def _min_image(dr, L):
    """Nearest-image reduction; L is (3,) lengths or (3,3) h (triclinic).
    Bonded displacements are far shorter than any box span, so the
    fractional-space round is the exact nearest image."""
    b = jnp.asarray(L, dr.dtype)
    if b.ndim == 1:
        return dr - b * jnp.round(dr / b)
    hinv = inv3x3(b)
    return dr - jnp.round(dr @ hinv.T) @ b.T


def bonded_eval(r, box_lengths, terms: dict, n_pad: int, dtype):
    """Evaluate all bonded term families.  terms: device arrays built by
    device_bonded_tables.  Returns (f, e, virial, pe).

    Optional per-family weights terms["<family>_w"] (T,) gate individual
    terms (0 = off); the sharded path (parallel/bonded_shard.py) uses
    them to mask terms not owned by / resolvable on this device."""

    def famw(key, x):
        w = terms.get(key + "_w")
        return x if w is None else x * w

    def sanitize(key, dr, unit):
        """Masked-off terms resolve to arbitrary (possibly coincident)
        rows; replace their geometry with a fixed non-degenerate vector so
        1/r and AD paths stay finite (0 * inf = nan otherwise)."""
        w = terms.get(key + "_w")
        if w is None:
            return dr
        u = jnp.asarray(unit, dtype=dr.dtype)
        return jnp.where((w > 0)[:, None], dr, u)
    L = box_lengths
    f = jnp.zeros((n_pad, 3), dtype=dtype)
    pe = jnp.zeros((n_pad,), dtype=dtype)
    e = jnp.zeros((), dtype=dtype)
    virial = jnp.zeros((3, 3), dtype=dtype)

    # static-incidence "ledger" mode (single-chip path, topology fixed):
    # per-(term, role) force/pe contributions are appended to flat
    # buffers in LEDGER_FAMILIES order and summed into per-atom rows by
    # ONE gather at the end, replacing the scatter-add (`.at[].add`).  The
    # sharded path (dynamic per-device rows + _w weights) keeps scatter.
    ledger = terms.get("ledger")
    contrib_f: list = []
    contrib_pe: list = []

    def emit(idx, fvecs, pevals):
        """idx (T, R) atom rows; fvecs/pevals: R per-role (T,3)/(T,)
        contributions in COLUMN order (slot = t*R + r, matching
        build_bonded_ledger)."""
        nonlocal f, pe
        if ledger is not None:
            contrib_f.append(jnp.stack(fvecs, axis=1).reshape(-1, 3))
            contrib_pe.append(jnp.stack(pevals, axis=1).reshape(-1))
        else:
            for rr in range(len(fvecs)):
                f = f.at[idx[:, rr]].add(fvecs[rr])
                pe = pe.at[idx[:, rr]].add(pevals[rr])

    if "bonds" in terms:
        idx, parm = terms["bonds"], terms["bond_parms"]
        ri, rj = r[idx[:, 0]], r[idx[:, 1]]
        dr = sanitize("bonds", _min_image(ri - rj, L), (1.0, 0.0, 0.0))
        b = jnp.sqrt(jnp.sum(dr * dr, axis=-1))
        db = b - parm[:, 1]
        eb = famw("bonds", parm[:, 0] * db * db)      # kb (b-b0)^2, no 1/2
        fi = famw("bonds", -2.0 * parm[:, 0] * db / b)[:, None] * dr
        emit(idx, [fi, -fi], [0.5 * eb, 0.5 * eb])
        virial = virial + jnp.einsum("ba,bc->ac", fi, dr)
        e = e + jnp.sum(eb)

    if "angles" in terms:
        idx, parm, kind = terms["angles"], terms["angle_parms"], terms["angle_kind"]
        rij = sanitize("angles", _min_image(r[idx[:, 0]] - r[idx[:, 1]], L),
                       (1.0, 0.0, 0.0))
        rkj = sanitize("angles", _min_image(r[idx[:, 2]] - r[idx[:, 1]], L),
                       (0.0, 1.0, 0.0))
        bij = jnp.sqrt(jnp.sum(rij * rij, axis=-1))
        bkj = jnp.sqrt(jnp.sum(rkj * rkj, axis=-1))
        uij = rij / bij[:, None]
        ukj = rkj / bkj[:, None]
        cosA = jnp.clip(jnp.sum(uij * ukj, axis=-1), -1.0 + 1e-7, 1.0 - 1e-7)
        kt, t0 = parm[:, 0], parm[:, 1]
        sinA = jnp.sqrt(1.0 - cosA * cosA)
        sin2 = 1.0 - cosA * cosA

        # harmonic (theta-space): e = kt (acos - t0)^2
        aD_h = jnp.arccos(cosA) - t0
        e_h = kt * aD_h * aD_h
        coef_h = 2.0 * kt * aD_h / sinA               # dE/dcosA * (-1) folded

        # cosine: e = kt (cosA - t0)^2
        aD_c = cosA - t0
        e_c = kt * aD_c * aD_c
        coef_c = -2.0 * kt * aD_c

        # REB: e = kt (cosA - t0)^2 / sin^2
        e_r = kt * aD_c * aD_c / sin2
        coef_r = -2.0 * kt * aD_c * (1.0 - cosA * t0) / (sin2 * sin2)

        e_a = famw("angles",
                   jnp.select([kind == 0, kind == 1, kind == 2],
                              [e_h, e_c, e_r]))
        coef = famw("angles",
                    jnp.select([kind == 0, kind == 1, kind == 2],
                               [coef_h, coef_c, coef_r]))
        fi = (coef / bij)[:, None] * (ukj - uij * cosA[:, None])
        fk = (coef / bkj)[:, None] * (uij - ukj * cosA[:, None])
        zA = jnp.zeros_like(e_a)
        emit(idx, [fi, -(fi + fk), fk], [zA, e_a, zA])
        virial = virial + jnp.einsum("ba,bc->ac", fi, rij) \
            + jnp.einsum("ba,bc->ac", fk, rkj)
        e = e + jnp.sum(e_a)

    for key, harmonic in (("torsions", False), ("impropers", True)):
        if key not in terms:
            continue
        idx = terms[key]
        parm = terms["torsion_parms" if key == "torsions" else "improper_parms"]
        # gather the four corner positions as min-image displacements about
        # atom j so the energy is a smooth function of the local geometry
        rj_ = r[idx[:, 1]]
        d0 = sanitize(key, _min_image(r[idx[:, 0]] - rj_, L),
                      (1.0, 0.0, 0.0))
        d2_ = sanitize(key, _min_image(r[idx[:, 2]] - rj_, L),
                       (0.0, 1.0, 0.0))
        d3 = sanitize(key, _min_image(r[idx[:, 3]] - rj_, L),
                      (0.0, 1.0, 1.0))

        def torsion_energy(d0, d2_, d3, parm=parm, harmonic=harmonic):
            b1 = -d0                    # r_j - r_i
            b2 = d2_                    # r_k - r_j
            b3 = d3 - d2_               # r_l - r_k
            n1 = jnp.cross(b1, b2)
            n2 = jnp.cross(b2, b3)
            b2n = jnp.sqrt(jnp.sum(b2 * b2, axis=-1))
            x = jnp.sum(n1 * n2, axis=-1)
            y = jnp.sum(jnp.cross(n1, n2) * b2, axis=-1) / b2n
            phi = jnp.arctan2(y, x)
            if harmonic:
                kpsi, psi0 = parm[:, 0], parm[:, 1]
                dphi = phi - psi0
                dphi = dphi - 2.0 * jnp.pi * jnp.round(dphi / (2.0 * jnp.pi))
                return kpsi * dphi * dphi
            kchi, nper, delta = parm[:, 0], parm[:, 1], parm[:, 2]
            return kchi * (1.0 + jnp.cos(nper * phi - delta))

        def torsion_energy_w(a, b, c, key=key):
            return famw(key, torsion_energy(a, b, c))

        # forces by reverse-mode AD of the per-term energies (exact; the
        # hand-derived force decomposition is easy to get subtly wrong)
        e_t, pull = jax.vjp(lambda a, b, c: jnp.sum(torsion_energy_w(a, b, c)),
                            d0, d2_, d3)
        g0, g2, g3 = pull(jnp.ones((), dtype=dtype))
        e_terms = torsion_energy_w(d0, d2_, d3)
        fi = -g0
        fk = -g2
        fl = -g3
        fj = -(fi + fk + fl)            # momentum conservation
        zT = jnp.zeros_like(e_terms)
        emit(idx, [fi, fj, fk, fl], [zT, e_terms, zT, zT])
        e = e + e_t
        virial = virial + jnp.einsum("ba,bc->ac", fi, d0) \
            + jnp.einsum("ba,bc->ac", fk, d2_) \
            + jnp.einsum("ba,bc->ac", fl, d3)

    if "cmap_atoms" in terms:
        # CMAP phi/psi bicubic correction (calculateCMAPValues,
        # /root/reference/src/bioCharmmCovalentEnergies.c:395-497; grid
        # coordinate u = 180 - deg(dihedral), resCmap :670-677).  Forces
        # by reverse-mode AD like the torsion terms.
        idx = terms["cmap_atoms"]         # (M,5) [-C, N, CA, C, +N]
        ctype = terms["cmap_type"]
        grid = terms["cmap_grid"]
        y1 = terms["cmap_y1"]
        y2 = terms["cmap_y2"]
        y12 = terms["cmap_y12"]
        ng = grid.shape[-1]
        res = 360.0 / ng
        from .charmm import _CMAP_AINV

        ainv = jnp.asarray(_CMAP_AINV, dtype=dtype)
        rj_ = r[idx[:, 1]]                # anchor at N
        dP = _min_image(r[idx[:, 0]] - rj_, L)
        dCA = _min_image(r[idx[:, 2]] - rj_, L)
        dC = _min_image(r[idx[:, 3]] - rj_, L)
        dN2 = _min_image(r[idx[:, 4]] - rj_, L)
        cw = terms.get("cmap_atoms_w")
        if cw is not None:
            # sharded path: unresolved terms gather coincident sentinel
            # rows; swap in a fixed non-degenerate dihedral geometry so
            # the AD pullback stays finite (0 * nan otherwise)
            u_ = jnp.asarray([-1.0, 0.0, 0.0], dtype=dtype)
            vg = jnp.asarray([0.0, 1.0, 0.0], dtype=dtype)
            wg = jnp.asarray([0.0, 1.0, 1.0], dtype=dtype)
            xg = jnp.asarray([1.0, 1.0, 1.0], dtype=dtype)
            on = (cw > 0)[:, None]
            dP = jnp.where(on, dP, u_)
            dCA = jnp.where(on, dCA, vg)
            dC = jnp.where(on, dC, wg)
            dN2 = jnp.where(on, dN2, xg)

        def dihed(b1, b2, b3):
            n1 = jnp.cross(b1, b2)
            n2 = jnp.cross(b2, b3)
            b2n = jnp.sqrt(jnp.sum(b2 * b2, axis=-1))
            x = jnp.sum(n1 * n2, axis=-1)
            y = jnp.sum(jnp.cross(n1, n2) * b2, axis=-1) / b2n
            return jnp.arctan2(y, x)

        def cmap_energy(dP, dCA, dC, dN2):
            phi = dihed(-dP, dCA, dC - dCA)
            psi = dihed(dCA, dC - dCA, dN2 - dC)
            u = 180.0 - phi * (180.0 / jnp.pi)
            v = 180.0 - psi * (180.0 / jnp.pi)
            iu = jax.lax.stop_gradient(
                jnp.clip(jnp.floor(u / res), 0, ng - 1).astype(jnp.int32))
            iv = jax.lax.stop_gradient(
                jnp.clip(jnp.floor(v / res), 0, ng - 1).astype(jnp.int32))
            iup = (iu + 1) % ng
            ivp = (iv + 1) % ng

            def corners(tab, scale):
                return [tab[ctype, iu, iv] * scale, tab[ctype, iup, iv] * scale,
                        tab[ctype, iu, ivp] * scale, tab[ctype, iup, ivp] * scale]

            x16 = jnp.stack(corners(grid, 1.0) + corners(y1, res)
                            + corners(y2, res) + corners(y12, res * res))
            coef = ainv @ x16                     # (16, M)
            c = coef.reshape(4, 4, -1).transpose(1, 0, 2)  # c[i,j] = coef[j,i]
            t1 = (u - iu.astype(dtype) * res) / res
            t2 = (v - iv.astype(dtype) * res) / res
            p1 = jnp.stack([jnp.ones_like(t1), t1, t1 * t1, t1 ** 3])
            p2 = jnp.stack([jnp.ones_like(t2), t2, t2 * t2, t2 ** 3])
            return jnp.einsum("ijm,im,jm->m", c, p1, p2)

        wvec = (jnp.ones(idx.shape[0], dtype=dtype) if cw is None
                else cw.astype(dtype))
        e_t, pull = jax.vjp(
            lambda a, b, cc, d: jnp.sum(cmap_energy(a, b, cc, d) * wvec),
            dP, dCA, dC, dN2)
        gP, gCA, gC, gN2 = pull(jnp.ones((), dtype=dtype))
        e_terms = cmap_energy(dP, dCA, dC, dN2) * wvec
        fP, fCA, fC, fN2 = -gP, -gCA, -gC, -gN2
        fN = -(fP + fCA + fC + fN2)
        zC = jnp.zeros_like(e_terms)
        emit(idx, [fP, fN, fCA, fC, fN2], [zC, e_terms, zC, zC, zC])
        e = e + e_t
        virial = virial + jnp.einsum("ba,bc->ac", fP, dP) \
            + jnp.einsum("ba,bc->ac", fCA, dCA) \
            + jnp.einsum("ba,bc->ac", fC, dC) \
            + jnp.einsum("ba,bc->ac", fN2, dN2)

    if "bpairs" in terms:
        idx, parm = terms["bpairs"], terms["bpair_parms"]
        dr = sanitize("bpairs", _min_image(r[idx[:, 0]] - r[idx[:, 1]], L),
                      (1.0, 0.0, 0.0))
        r2 = jnp.sum(dr * dr, axis=-1)
        ir2 = 1.0 / r2
        s2 = parm[:, 0] * parm[:, 0] * ir2
        s6 = s2 * s2 * s2
        s12 = s6 * s6
        within = famw("bpairs", (r2 < terms["bpair_rcut2"]).astype(dtype))
        e_p = (4.0 * parm[:, 1] * (s12 - s6) + parm[:, 2]) * within
        dvdr = 24.0 * parm[:, 1] * (s6 - 2.0 * s12) * ir2 * within
        fi = -dvdr[:, None] * dr
        emit(idx, [fi, -fi], [0.5 * e_p, 0.5 * e_p])
        virial = virial + jnp.einsum("ba,bc->ac", fi, dr)
        e = e + jnp.sum(e_p)

    if "exclusions" in terms:
        idx = terms["exclusions"]
        tidx = terms["excl_tidx"]
        qq = terms["excl_qq"]
        dr = sanitize("exclusions",
                      _min_image(r[idx[:, 0]] - r[idx[:, 1]], L),
                      (1.0, 0.0, 0.0))
        r2 = jnp.sum(dr * dr, axis=-1)
        within = r2 < terms["rcut2"]
        w = famw("exclusions", within.astype(dtype))
        if terms.get("excl_mode") == "rf_add":
            # the nonbond engine masked excluded pairs IN-LIST (nothing
            # to cancel); add back only the RF polarization part the
            # reference keeps for excluded pairs within cutoff
            # (bioMartini.c:1124-1208): e = kqq (krf r^2 - crf)
            krf = terms["excl_krf"]
            crf = terms["excl_crf"]
            e_x = qq * (krf * r2 - crf) * w
            dvdr = qq * (2.0 * krf) * w
        else:
            # subtract LJ + bare Coulomb the nonbond engine added for
            # excluded pairs (RF polarization terms stay)
            ir2 = 1.0 / r2
            ir = jnp.sqrt(ir2)
            sig = terms["sigma_flat"][tidx]
            eps = terms["eps_flat"][tidx]
            shf = terms["shift_flat"][tidx]
            s2 = sig * sig * ir2
            s6 = s2 * s2 * s2
            s12 = s6 * s6
            e_x = -(4.0 * eps * (s12 - s6) + shf + qq * ir) * w
            dvdr = -(24.0 * eps * (s6 - 2.0 * s12) * ir2 - qq * ir2 * ir) * w
        fi = -dvdr[:, None] * dr
        emit(idx, [fi, -fi], [0.5 * e_x, 0.5 * e_x])
        virial = virial + jnp.einsum("ba,bc->ac", fi, dr)
        e = e + jnp.sum(e_x)

    if ledger is not None and contrib_f:
        F = jnp.concatenate(contrib_f + [jnp.zeros((1, 3), dtype=dtype)])
        PE = jnp.concatenate(contrib_pe + [jnp.zeros((1,), dtype=dtype)])
        f = f + jnp.sum(F[ledger], axis=1)
        pe = pe + jnp.sum(PE[ledger], axis=1)

    return f, e, virial, pe


# family -> role arity, in the fixed slot order build_bonded_ledger and
# bonded_eval's emit() share (slot of term t, role r = offset + t*R + r)
LEDGER_FAMILIES = (("bonds", 2), ("angles", 3), ("torsions", 4),
                   ("impropers", 4), ("cmap_atoms", 5), ("bpairs", 2),
                   ("exclusions", 2))


def build_bonded_ledger(terms: dict, n_pad: int) -> np.ndarray | None:
    """Per-atom incidence table (n_pad, D) int32 of contribution-slot
    indices (sentinel = C, a zero pad row) for bonded_eval's gather-sum
    force/pe assembly.  Only valid for STATIC topologies (single-chip
    path): the sharded path resolves term rows dynamically per device
    and must keep scatter-add."""
    assert not any(k.endswith("_w") for k in terms), \
        "ledger mode is incompatible with sharded per-family weights"
    cols_all = []
    slots_all = []
    off = 0
    for key, R in LEDGER_FAMILIES:
        if key not in terms:
            continue
        idx = np.asarray(terms[key])
        T = idx.shape[0]
        t_ids = np.arange(T, dtype=np.int64) * R
        for rr in range(R):
            cols_all.append(idx[:, rr].astype(np.int64))
            slots_all.append(off + t_ids + rr)
        off += T * R
    if not cols_all:
        return None
    cols = np.concatenate(cols_all)
    slots = np.concatenate(slots_all)
    order = np.argsort(cols, kind="stable")
    cols = cols[order]
    slots = slots[order]
    counts = np.bincount(cols, minlength=n_pad)
    D = int(counts.max())
    led = np.full((n_pad, D), off, dtype=np.int32)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    pos = np.arange(len(cols)) - starts[cols]
    led[cols, pos] = slots
    return led


def device_bonded_tables(bt: BondedTerms, dtype, *, lj_sigma=None, lj_eps=None,
                         lj_shift=None, rcut=None, keR=None, charges=None,
                         species_lj_type=None, species_per_particle=None,
                         excl_mode="subtract", krf=None, crf=None):
    """Move instantiated terms to device; precompute exclusion pair data.

    excl_mode "subtract" (default) cancels what the nonbond engine added
    for excluded pairs; "rf_add" pairs with IN-LIST exclusion masking
    (martini_nonbond excl_tbl) and adds back only the kept RF
    polarization term (needs krf/crf)."""
    t = {}
    if bt.bonds is not None:
        t["bonds"] = jnp.asarray(bt.bonds)
        t["bond_parms"] = jnp.asarray(bt.bond_parms, dtype=dtype)
    if bt.angles is not None:
        t["angles"] = jnp.asarray(bt.angles)
        t["angle_parms"] = jnp.asarray(bt.angle_parms, dtype=dtype)
        t["angle_kind"] = jnp.asarray(bt.angle_kind)
    if bt.torsions is not None:
        t["torsions"] = jnp.asarray(bt.torsions)
        t["torsion_parms"] = jnp.asarray(bt.torsion_parms, dtype=dtype)
    if bt.impropers is not None:
        t["impropers"] = jnp.asarray(bt.impropers)
        t["improper_parms"] = jnp.asarray(bt.improper_parms, dtype=dtype)
    if bt.bpairs is not None:
        t["bpairs"] = jnp.asarray(bt.bpairs)
        t["bpair_parms"] = jnp.asarray(bt.bpair_parms, dtype=dtype)
        t["bpair_rcut2"] = jnp.asarray(rcut ** 2, dtype=dtype)
    if bt.cmap_atoms is not None:
        t["cmap_atoms"] = jnp.asarray(bt.cmap_atoms)
        t["cmap_type"] = jnp.asarray(bt.cmap_type)
        for k in ("cmap_grid", "cmap_y1", "cmap_y2", "cmap_y12"):
            t[k] = jnp.asarray(getattr(bt, k), dtype=dtype)
    if bt.exclusions is not None and lj_sigma is not None:
        ex = bt.exclusions
        tmap = np.asarray(species_lj_type)
        sp = np.asarray(species_per_particle)
        T = lj_sigma.shape[0]
        ti = tmap[sp[ex[:, 0]]]
        tj = tmap[sp[ex[:, 1]]]
        t["exclusions"] = jnp.asarray(ex)
        t["excl_tidx"] = jnp.asarray(ti * T + tj)
        qv = np.asarray(charges)
        t["excl_qq"] = jnp.asarray(keR * qv[ex[:, 0]] * qv[ex[:, 1]], dtype=dtype)
        t["sigma_flat"] = jnp.asarray(np.asarray(lj_sigma).reshape(-1), dtype=dtype)
        t["eps_flat"] = jnp.asarray(np.asarray(lj_eps).reshape(-1), dtype=dtype)
        t["shift_flat"] = jnp.asarray(np.asarray(lj_shift).reshape(-1), dtype=dtype)
        t["rcut2"] = jnp.asarray(rcut ** 2, dtype=dtype)
        if excl_mode == "rf_add":
            t["excl_mode"] = "rf_add"
            t["excl_krf"] = jnp.asarray(krf, dtype=dtype)
            t["excl_crf"] = jnp.asarray(crf, dtype=dtype)
    return t
