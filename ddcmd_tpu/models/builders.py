"""Programmatic model families: deck builders for canonical systems.

The reference ships example decks (examples/waterbox, examples/object);
these builders generate equivalent object-format decks for the working
model families so benchmarks/tests/users can spin up systems at any
size without hand-editing files.  Everything is written in the same
deck grammar the parser reads back (objects/parser.py).
"""

from __future__ import annotations

import os

import numpy as np

__all__ = ["write_atoms", "lj_fluid", "eam_crystal", "martini_water",
           "martini_bilayer", "load"]


def write_atoms(path, r, v, species, groups, h, classes=None):
    """VARRECORDASCII atoms# shard with FILEHEADER (collection_write
    analog; units are Angstrom / Angstrom/fs external)."""
    n = len(r)
    classes = classes or ["ATOM"] * n
    rows = [f"{i} {classes[i]} {species[i]} {groups[i]} "
            + " ".join("%.8f" % x for x in r[i])
            + " " + " ".join("%.8f" % x for x in v[i]) for i in range(n)]
    hflat = " ".join("%.6f" % x for x in np.asarray(h).T.reshape(-1))
    hdr = (f"particle FILEHEADER {{type=MULTILINE; datatype=VARRECORDASCII;"
           f" checksum=NONE;\nloop=0; time=0.0;\nnfiles=1; nrecord={n};"
           f" nfields=10;\n"
           f"field_names=id class type group rx ry rz vx vy vz;\n"
           f"field_types=u s s s f f f f f f;\n"
           f"h= {hflat} ;\n}}\n\n")
    with open(path, "w") as f:
        f.write(hdr + "\n".join(rows) + "\n")
    return n


def _lattice(n_target, L, jitter, seed):
    rng = np.random.default_rng(seed)
    m = int(np.ceil(n_target ** (1 / 3)))
    g = np.stack(np.meshgrid(*[np.arange(m)] * 3, indexing="ij"),
                 -1).reshape(-1, 3)[:n_target]
    r = ((g + 0.5) / m - 0.5) * L + (rng.random((n_target, 3)) - 0.5) * jitter
    return r, rng


def lj_fluid(out_dir, *, n=4096, density=0.0208, T=120.0,
             eps_ev=0.0104, sigma_ang=3.4, mass=39.948, dt_fs=4.0,
             cutoff_ang=8.5, seed=0, integrator="NGLF", table=False):
    """Lennard-Jones fluid (argon-like) at number density (1/Ang^3).

    table=True writes the same LJ sampled into per-interval cubic Taylor
    rows (table_function_uniform format, table_function.c:85-101) and a
    function=TableFunction deck — the tabulated-PAIR fixture.
    """
    L = (n / density) ** (1 / 3)
    r, rng = _lattice(n, L, 0.05 * L / n ** (1 / 3), seed)
    kB_ev = 8.617333e-5
    # write_atoms emits velocities in Angstrom/fs: 1 amu*(Ang/fs)^2 =
    # 103.64 eV, so v = sqrt(kB T / (m * 103.64)) gives T exactly
    v = rng.standard_normal((n, 3)) * np.sqrt(kB_ev * T / (mass * 103.64))
    v *= 1e-2  # start cool; the thermostat warms it
    write_atoms(os.path.join(out_dir, "atoms#000000"), r, v,
                ["Ar"] * n, ["free"] * n, np.diag([L] * 3))
    if table:
        def vfun(rr):
            s6 = (sigma_ang / rr) ** 6
            return 4 * eps_ev * (s6 ** 2 - s6)

        def dv(rr):
            s6 = (sigma_ang / rr) ** 6
            return 24 * eps_ev * (s6 - 2 * s6 ** 2) / rr

        x = np.linspace(0.8 * sigma_ang, cutoff_ang + 0.2, 512)
        h = 1e-4
        rows = []
        for xi in x:
            d2 = (dv(xi + h) - dv(xi - h)) / (2 * h)
            d3 = (dv(xi + h) - 2 * dv(xi) + dv(xi - h)) / h ** 2
            rows.append([xi, vfun(xi), dv(xi), d2 / 2, d3 / 6])
        with open(os.path.join(out_dir, "table.data"), "w") as f:
            for row in rows:
                f.write(" ".join("%.12e" % z for z in row) + "\n")
        pot = (f"pot POTENTIAL {{ type=PAIR; function=TableFunction;\n"
               f"  number_intervals={len(x)}; number_terms=4;\n"
               f"  filename=table.data; table_energyUnits=eV;\n"
               f"  table_lengthUnits=Angstrom;\n"
               f"  Rmax={cutoff_ang} Angstrom; }}")
    else:
        pot = (f"pot POTENTIAL {{ type=PAIR; cutoff={cutoff_ang} Angstrom;\n"
               f"  eps={eps_ev} eV; sigma={sigma_ang} Angstrom; }}")
    deck = f"""
simulate SIMULATE {{ type=MD; system=system; integrator=integ; dt={dt_fs};
  maxloop=100000; printrate=100; checkpointrate=10000; ddc=ddc; }}
ddc DDC {{ updateRate=20; }}
{pot}
integ INTEGRATOR {{ type={integrator}; T={T}K; }}
system SYSTEM {{ type=NORMAL; potential=pot; neighbor=nbr; groups=free;
  box=box; collection=collection; species=Ar; }}
Ar SPECIES {{ type=ATOM; mass={mass}; charge=0; }}
box BOX {{ type=ORTHORHOMBIC; pbc=7; h= {L:.6f} 0 0 0 {L:.6f} 0 0 0 {L:.6f} ; }}
nbr NEIGHBOR {{ type=NORMAL; deltaR=1.2; }}
free GROUP {{ type=LANGEVIN; Teq={T}K; tau=0.5ps; }}
collection COLLECTION {{ mode=VARRECORDASCII; size={n}; files=atoms#; }}
"""
    with open(os.path.join(out_dir, "object.data"), "w") as f:
        f.write(deck)
    return out_dir


def eam_crystal(out_dir, *, nc=8, a_lat=3.615, T=300.0, dt_fs=2.0,
                seed=1, jitter=0.03):
    """FCC copper with the RATIONAL EAM form (eam_rational.c analog) --
    4 nc^3 atoms."""
    L = a_lat * nc
    base = np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]])
    cells = np.stack(np.meshgrid(*[np.arange(nc)] * 3, indexing="ij"),
                     -1).reshape(-1, 3)
    r = (cells[:, None, :] + base[None, :, :]).reshape(-1, 3) * a_lat - L / 2
    rng = np.random.default_rng(seed)
    r = r + rng.standard_normal(r.shape) * jitter
    n = len(r)
    v = np.zeros((n, 3))
    write_atoms(os.path.join(out_dir, "atoms#000000"), r, v,
                ["Cu"] * n, ["free"] * n, np.diag([L] * 3))
    rc2 = 5.5 ** 2
    deck = f"""
simulate SIMULATE {{ type=MD; system=system; integrator=nglf; dt={dt_fs};
  maxloop=100000; printrate=100; checkpointrate=10000; ddc=ddc; }}
ddc DDC {{ updateRate=20; }}
pot POTENTIAL {{ type=EAM; form=RATIONAL; rmax=5.5 Angstrom;
  density_type=elementwise; }}
Cu_embedding FIT {{ cutoff=1e30; orderP=2; orderQ=1; P=0 -0.3 0.002;
  Q=1 0.05; xUnits=NONE; yUnits=eV; }}
Cu_density FIT {{ cutoff={rc2}; orderP=0; orderQ=2; P={3.6 ** 4}; Q=0 0 1;
  xUnits=Angstrom^2; yUnits=NONE; }}
Cu_Cu_2body FIT {{ cutoff={rc2}; orderP=0; orderQ=3; P={0.012 * 3.6 ** 6};
  Q=0 0 0 1; xUnits=Angstrom^2; yUnits=eV; }}
nglf INTEGRATOR {{ type=NGLF; T={T}K; }}
system SYSTEM {{ type=NORMAL; potential=pot; neighbor=nbr; groups=free;
  box=box; collection=collection; species=Cu; }}
Cu SPECIES {{ type=ATOM; mass=63.55; charge=0; }}
box BOX {{ type=ORTHORHOMBIC; pbc=7; h= {L} 0 0 0 {L} 0 0 0 {L} ; }}
nbr NEIGHBOR {{ type=NORMAL; deltaR=1.0; }}
free GROUP {{ type=LANGEVIN; Teq={T}K; tau=0.1ps; }}
collection COLLECTION {{ mode=VARRECORDASCII; size={n}; files=atoms#; }}
"""
    with open(os.path.join(out_dir, "object.data"), "w") as f:
        f.write(deck)
    return out_dir


def martini_water(out_dir, *, n=6173, density_nm3=7.47, T=310.0,
                  dt_fs=20.0, seed=2, waterbox=False):
    """Martini coarse-grained water at the waterbox state point; MMFF
    objects inline (the waterbox martini.data schema, bioMMFF.c).

    waterbox=True writes the reference's examples/waterbox deck instead:
    6,173 beads in a 93.858 Angstrom cube at 310 K and 1 bar
    (NGLFCONSTRAINT with beta=3e-4/bar, tauBarostat=1 ps), cutoff 11
    Angstrom, epsilon_r=15, dt=20 fs, LANGEVIN group `group` plus a FREE
    group `free`, an lcg64 RANDOM, W and WF residues in martini.data, and
    the start configuration (zero velocities) under snapshot.mem/ with a
    restart object file -- load it with
    load_db([object.data], snapshot.mem/restart, out_dir)."""
    if waterbox:
        return _reference_waterbox(out_dir, seed)
    L_nm = (n / density_nm3) ** (1 / 3)
    L = L_nm * 10.0
    r, rng = _lattice(n, L, 0.4, seed)
    v = np.zeros((n, 3))
    write_atoms(os.path.join(out_dir, "atoms#000000"), r, v,
                ["WxW"] * n, ["solvent"] * n, np.diag([L] * 3))
    deck = f"""
simulate SIMULATE {{ type=MD; system=system; integrator=integ; dt={dt_fs};
  maxloop=100000; printrate=100; checkpointrate=10000; ddc=ddc; }}
ddc DDC {{ updateRate=20; }}
martini POTENTIAL {{ type=MARTINI; parmfile=martini.data;
  rcoulomb=11 Angstrom; rmax=11 Angstrom; epsilon_r=15; epsilon_rf=-1; }}
integ INTEGRATOR {{ type=NGLF; T={T}K; }}
system SYSTEM {{ type=NORMAL; potential=martini; neighbor=nbr;
  groups=solvent; box=box; collection=collection; species=WxW; }}
WxW SPECIES {{ type=ATOM; mass=72.0; charge=0; }}
box BOX {{ type=ORTHORHOMBIC; pbc=7; h= {L:.6f} 0 0 0 {L:.6f} 0 0 0 {L:.6f} ; }}
nbr NEIGHBOR {{ type=NORMAL; deltaR=4.0 Angstrom; }}
solvent GROUP {{ type=LANGEVIN; Teq={T}K; tau=1.0ps; }}
collection COLLECTION {{ mode=VARRECORDASCII; size={n}; files=atoms#; }}
"""
    mmff = """
martini MMFF {
  resiParms=W ;
  atomTypeList=P4 ;
  ljParms=P4_P4 ;
}
P4 MASSPARMS { atomType=P4; atomTypeID=0; mass=72.0 M_p ; }
W RESIPARMS { resID=1; resType=0; resName=W; charge=0.0;
  groupList=W_g0; centerAtom=0; }
W_g0 GROUPPARMS { groupID=0; atomList=W_W ; }
W_W ATOMPARMS { atomID=0; atomName=W; atomType=P4; atomTypeID=0;
  charge=0.0; mass=72.0 M_p ; }
P4_P4 LJPARMS { atomtypeI=P4; indexI=0; atomtypeJ=P4; indexJ=0;
  sigma=0.47 nm; eps=5.0 kJ*mol^-1; }
"""
    with open(os.path.join(out_dir, "object.data"), "w") as f:
        f.write(deck)
    with open(os.path.join(out_dir, "martini.data"), "w") as f:
        f.write(mmff)
    return out_dir


_WATERBOX_DECK = """
simulate SIMULATE { type=MD; system=system; integrator=nglf; dt=20;
  maxloop=1000000; printrate=1; snapshotrate=0; checkpointrate=100000;
  ddc=ddc; printinfo=printinfo; }
ddc DDC { updateRate=20; }
martini POTENTIAL { type=MARTINI; parmfile=martini.data;
  cutoff=11 Angstrom; rcoulomb=11 Angstrom; epsilon_r=15; epsilon_rf=-1; }
nglf INTEGRATOR { type=NGLFCONSTRAINT; T=310 K; P0=1.0 bar;
  beta=3.0e-4/bar; tauBarostat=1 ps; }
system SYSTEM { type=NORMAL; potential=martini; neighbor=nbr;
  groups=group free; random=lcg64; box=box; collection=collection;
  species=WxW; }
group GROUP { type=LANGEVIN; Teq=310 K; tau=1 ps; }
free GROUP { type=FREE; }
lcg64 RANDOM { type=LCG64; seed=385212586; randomizeSeed=1; }
WxW SPECIES { type=ATOM; mass=72.0 M_p; charge=0; }
box BOX { type=ORTHORHOMBIC; pbc=7; }
nbr NEIGHBOR { type=NORMAL; deltaR=4.0 Angstrom; }
printinfo PRINTINFO { ENERGY=kJ/mol; TEMPERATURE=K; PRESSURE=bar;
  VOLUME=Ang^3; TIME=fs; }
collection COLLECTION { mode=VARRECORDASCII; size=6173;
  files=snapshot.mem/atoms#; }
"""

_WATERBOX_MMFF = """
martini MMFF {
  resiParms= W WF ;
  atomTypeList= P4 BP4 ;
  ljParms= P4_P4 P4_BP4 BP4_BP4 ;
}
P4 MASSPARMS { atomType=P4; atomTypeID=0; mass=72.0 M_p ; }
BP4 MASSPARMS { atomType=BP4; atomTypeID=1; mass=72.0 M_p ; }
W RESIPARMS { resID=1; resType=0; resName=W; charge=0.0;
  groupList=W_g0; centerAtom=0; }
W_g0 GROUPPARMS { groupID=0; atomList= W_W ; }
W_W ATOMPARMS { atomID=0; atomName=W; atomType=P4; atomTypeID=0;
  charge=0.0; mass=72.0 M_p ; }
WF RESIPARMS { resID=2; resType=0; resName=WF; charge=0.0;
  groupList=WF_g0; centerAtom=0; }
WF_g0 GROUPPARMS { groupID=0; atomList= WF_WF ; }
WF_WF ATOMPARMS { atomID=0; atomName=WF; atomType=BP4; atomTypeID=1;
  charge=0.0; mass=72.0 M_p ; }
P4_P4 LJPARMS { atomtypeI=P4; indexI=0; atomtypeJ=P4; indexJ=0;
  sigma=0.47 nm; eps=5.0 kJ*mol^-1; }
P4_BP4 LJPARMS { atomtypeI=BP4; indexI=1; atomtypeJ=P4; indexJ=0;
  sigma=0.57 nm; eps=5.6 kJ*mol^-1; }
BP4_BP4 LJPARMS { atomtypeI=BP4; indexI=1; atomtypeJ=BP4; indexJ=1;
  sigma=0.47 nm; eps=5.0 kJ*mol^-1; }
"""


def _reference_waterbox(out_dir, seed):
    n, L = 6173, 93.858
    r, _ = _lattice(n, L, 0.4, seed)
    snap = os.path.join(out_dir, "snapshot.mem")
    os.makedirs(snap, exist_ok=True)
    write_atoms(os.path.join(snap, "atoms#000000"), r, np.zeros((n, 3)),
                ["WxW"] * n, ["group"] * n, np.diag([L] * 3))
    hstr = " ".join("%.6f" % x for x in np.diag([L] * 3).reshape(-1))
    with open(os.path.join(snap, "restart"), "w") as f:
        f.write("simulate SIMULATE { loop=0; time=0.000000 ;}\n"
                f"box BOX {{ h= {hstr} ; }}\n"
                f"collection COLLECTION {{ mode=VARRECORDASCII; size={n};"
                " files=snapshot.mem/atoms#;}\n")
    with open(os.path.join(out_dir, "object.data"), "w") as f:
        f.write(_WATERBOX_DECK)
    with open(os.path.join(out_dir, "martini.data"), "w") as f:
        f.write(_WATERBOX_MMFF)
    return out_dir


# ---------------------------------------------------------------------------
# Martini DPPC-like bilayer (the reference's production-class workload:
# the full bioMartini pipeline /root/reference/src/bioMartini.c:1357 --
# nonbond + bonds + cosine angles + constraints (genConstraint :445) +
# RF electrostatics + semi-anisotropic NPT, at ~100k beads)
# ---------------------------------------------------------------------------

# 12-bead DPPC topology (atom order = RTF order = species signature):
#   0 NC3(Q0,+1)  1 PO4(Qa,-1)  2 GL1(Na)  3 GL2(Na)
#   4-7 C1A..C4A(C1)            8-11 C1B..C4B(C1)
_DPPC_ATOMS = [("NC3", "Q0", 1.0), ("PO4", "Qa", -1.0),
               ("GL1", "Na", 0.0), ("GL2", "Na", 0.0),
               ("C1A", "C1", 0.0), ("C2A", "C1", 0.0),
               ("C3A", "C1", 0.0), ("C4A", "C1", 0.0),
               ("C1B", "C1", 0.0), ("C2B", "C1", 0.0),
               ("C3B", "C1", 0.0), ("C4B", "C1", 0.0)]
# harmonic bonds (i, j, b0 nm); kb = 1250 kJ/mol/nm^2 (Martini v2 DPPC)
_DPPC_BONDS = [(1, 2, 0.47), (2, 3, 0.37), (2, 4, 0.47), (4, 5, 0.47),
               (5, 6, 0.47), (6, 7, 0.47), (3, 8, 0.47), (8, 9, 0.47),
               (9, 10, 0.47), (10, 11, 0.47)]
# G96 cosine angles (i, j, k, theta0 deg); k = 25 kJ/mol.  The MMFF
# func=2 form is kt*(cosA - t0)^2 so kt = k/2, t0 = cos(theta0).
_DPPC_ANGLES = [(1, 2, 3, 120.0), (1, 2, 4, 180.0), (2, 4, 5, 180.0),
                (4, 5, 6, 180.0), (5, 6, 7, 180.0), (3, 8, 9, 180.0),
                (8, 9, 10, 180.0), (9, 10, 11, 180.0)]
# the NC3-PO4 link rides the constraint solver (r0 = 0.47) so the
# workload exercises genConstraint/NGLFCONSTRAINT at scale.  (Standard
# Martini DPPC uses a 1250 bond here; divergence is intentional and the
# physics is equivalent at dt=20fs.)
_DPPC_CONS = [(0, 1, 0.47)]

# Martini v2-level LJ matrix for the 5 bead types used here.
_LJ_TYPES = ["Q0", "Qa", "Na", "C1", "P4"]
_LJ_EPS = {("Q0", "Q0"): 3.5, ("Q0", "Qa"): 4.5, ("Q0", "Na"): 4.0,
           ("Q0", "C1"): 2.0, ("Q0", "P4"): 5.6,
           ("Qa", "Qa"): 5.0, ("Qa", "Na"): 4.0, ("Qa", "C1"): 2.0,
           ("Qa", "P4"): 5.6,
           ("Na", "Na"): 4.0, ("Na", "C1"): 2.7, ("Na", "P4"): 4.0,
           ("C1", "C1"): 3.5, ("C1", "P4"): 2.0,
           ("P4", "P4"): 5.0}
# super-repulsive charged/apolar pairs get the wide core (Martini v2)
_LJ_SIGMA_BIG = {("Q0", "C1"), ("Qa", "C1")}


def _dppc_mmff() -> str:
    """MMFF object tree for DPPC + W (bioMMFF.c schema)."""
    out = ["bilayer MMFF {",
           "  resiParms= DPPC W ;",
           "  atomTypeList= " + " ".join(_LJ_TYPES) + " ;",
           "  ljParms= " + " ".join(
               f"{a}_{b}" for i, a in enumerate(_LJ_TYPES)
               for b in _LJ_TYPES[i:]) + " ;",
           "}"]
    for i, t in enumerate(_LJ_TYPES):
        out.append(f"{t} MASSPARMS {{ atomType={t}; atomTypeID={i}; "
                   f"mass=72.0 amu; }}")
    for i, a in enumerate(_LJ_TYPES):
        for b in _LJ_TYPES[i:]:
            eps = _LJ_EPS[(a, b)]
            sig = 0.62 if (a, b) in _LJ_SIGMA_BIG else 0.47
            out.append(f"{a}_{b} LJPARMS {{ atomtypeI={a}; "
                       f"indexI={_LJ_TYPES.index(a)}; atomtypeJ={b}; "
                       f"indexJ={_LJ_TYPES.index(b)}; sigma={sig} nm; "
                       f"eps={eps} kJ*mol^-1; }}")
    atoms = " ".join(f"DPPC_{an}" for an, _, _ in _DPPC_ATOMS)
    out += [
        "DPPC RESIPARMS {",
        "  resID=1; resType=0; resName=DPPC; charge=0.0;",
        "  groupList=DPPC_g0; centerAtom=0;",
        "  bondList= " + " ".join(f"DPPC_b{i}"
                                  for i in range(len(_DPPC_BONDS))) + " ;",
        "  angleList= " + " ".join(f"DPPC_a{i}"
                                   for i in range(len(_DPPC_ANGLES))) + " ;",
        "  constraintList= DPPC_cl ;",
        "}",
        f"DPPC_g0 GROUPPARMS {{ groupID=0; atomList= {atoms} ; }}",
    ]
    for aid, (an, at, q) in enumerate(_DPPC_ATOMS):
        out.append(f"DPPC_{an} ATOMPARMS {{ atomID={aid}; atomName={an}; "
                   f"atomType={at}; atomTypeID={_LJ_TYPES.index(at)}; "
                   f"charge={q}; mass=72.0 amu; }}")
    for bi, (i, j, b0) in enumerate(_DPPC_BONDS):
        out.append(f"DPPC_b{bi} BONDPARMS {{ atomI={i}; atomJ={j}; func=1; "
                   f"kb=1250 kJ*mol^-1*nm^-2; b0={b0} nm; }}")
    for ai, (i, j, k, th0) in enumerate(_DPPC_ANGLES):
        t0 = np.cos(np.deg2rad(th0))
        out.append(f"DPPC_a{ai} ANGLEPARMS {{ atomI={i}; atomJ={j}; "
                   f"atomK={k}; func=2; ktheta=12.5 kJ*mol^-1; "
                   f"theta0={t0:.6f}; }}")
    out.append("DPPC_cl CONSLISTPARMS { constraintSubList= "
               + " ".join(f"DPPC_c{i}" for i in range(len(_DPPC_CONS)))
               + " ; }")
    for ci, (i, j, r0) in enumerate(_DPPC_CONS):
        out.append(f"DPPC_c{ci} CONSPARMS {{ atomI={i}; atomJ={j}; func=1; "
                   f"r0={r0} nm; }}")
    out += [
        "W RESIPARMS { resID=2; resType=0; resName=W; charge=0.0;",
        "  groupList=W_g0; centerAtom=0; }",
        "W_g0 GROUPPARMS { groupID=0; atomList= W_W ; }",
        "W_W ATOMPARMS { atomID=0; atomName=W; atomType=P4; "
        f"atomTypeID={_LJ_TYPES.index('P4')}; charge=0.0; mass=72.0 amu; }}",
    ]
    return "\n".join(out) + "\n"


def martini_bilayer(out_dir, *, nx=48, ny=48, apl_nm2=0.64, water_nm=2.2,
                    density_nm3=7.47, T=323.0, dt_fs=20.0, seed=4,
                    beta_per_bar=3.0e-4, tau_ps=1.0, isotropic=0):
    """DPPC-like Martini bilayer in water: 2*nx*ny lipids (12 beads each)
    + two water slabs of thickness `water_nm`.  Defaults give ~100k beads
    (48x48: 55,296 lipid + ~45,000 W).  Semi-anisotropic NPT via
    NGLFCONSTRAINT (changeVolume, /root/reference/src/nglfconstraint.c:64).

    The start is built NEAR EQUILIBRIUM on purpose: apl 0.64 nm^2 (fluid
    DPPC/Martini at 323 K), ladder spacing = bond b0, Maxwell-Boltzmann
    velocities at T.  A colder/denser lattice start (apl 0.55, 0 K)
    relaxed so violently under dt=20 fs NPT that the potential-energy
    avalanche overheated the box to ~4800 K and core overlaps tripped
    the kill switch faster than the rollback ladder could recover."""
    rng = np.random.default_rng(seed)
    a = float(np.sqrt(apl_nm2))          # in-plane lattice (nm)
    Lx, Ly = nx * a, ny * a
    dzb = 0.47                           # bead ladder spacing = bond b0 (nm)
    z_gl = 2.10                          # glycerol plane: C4 tails end at
    #                                      z=0.30, leaving a 0.6 nm
    #                                      inter-leaflet gap
    z_head = z_gl + 2 * dzb              # NC3 at 3.0
    z_w0 = z_head + 0.30                 # water slab starts
    Lz = 2.0 * (z_w0 + water_nm)

    # per-lipid bead template (dx, dy, z), TOP leaflet.  The sn-2 chain
    # sits on the (a/2, a/2) checkerboard so all chain columns form a
    # square sub-lattice of spacing a/sqrt(2) (~0.57 nm > sigma): no
    # chain-chain core overlaps at apl ~0.64.
    bx = a / 2
    g2 = 0.37 / np.sqrt(2.0)             # GL1->GL2 diagonal (|b0| = 0.37)
    tmpl = [(0.0, 0.0, z_gl + 2 * dzb),          # NC3
            (0.0, 0.0, z_gl + dzb),              # PO4
            (0.0, 0.0, z_gl),                    # GL1
            (g2, g2, z_gl),                      # GL2
            (0.0, 0.0, z_gl - dzb), (0.0, 0.0, z_gl - 2 * dzb),
            (0.0, 0.0, z_gl - 3 * dzb), (0.0, 0.0, z_gl - 4 * dzb),
            (bx, bx, z_gl - dzb), (bx, bx, z_gl - 2 * dzb),
            (bx, bx, z_gl - 3 * dzb), (bx, bx, z_gl - 4 * dzb)]
    names = [an for an, _, _ in _DPPC_ATOMS]

    r, species = [], []
    for leaf in (+1, -1):
        for ix in range(nx):
            for iy in range(ny):
                x0 = (ix + 0.25) * a - Lx / 2 + rng.uniform(-0.02, 0.02)
                y0 = (iy + 0.25) * a - Ly / 2 + rng.uniform(-0.02, 0.02)
                for (dx, dy, z) in tmpl:
                    r.append((x0 + dx, y0 + dy, leaf * z))
                species.extend(f"{an}xDPPC" for an in names)
    n_lipid_beads = len(r)

    # water slabs on a jittered cubic grid at the waterbox density
    # (round, don't floor: floored counts with span-filling spacing left
    # the slab ~40% under-dense and the barostat collapsed the vacuum)
    s = (1.0 / density_nm3) ** (1.0 / 3.0)
    mx, my = max(1, round(Lx / s)), max(1, round(Ly / s))
    mz = max(1, round(water_nm / s))
    for leaf in (+1, -1):
        for ix in range(mx):
            for iy in range(my):
                for iz in range(mz):
                    x = (ix + 0.5) * Lx / mx - Lx / 2
                    y = (iy + 0.5) * Ly / my - Ly / 2
                    z = leaf * (z_w0 + (iz + 0.5) * water_nm / mz)
                    jit = rng.uniform(-0.04, 0.04, 3)
                    r.append((x + jit[0], y + jit[1], z + jit[2]))
                    species.append("WxW")
    n = len(r)
    r = np.asarray(r) * 10.0             # -> Angstrom for write_atoms
    # Maxwell-Boltzmann at T (all beads 72 amu): nm/ps -> Angstrom/fs
    from ..objects.units import kB

    v = rng.normal(size=(n, 3)) * np.sqrt(kB * T / 72.0) * 0.01
    write_atoms(os.path.join(out_dir, "atoms#000000"), r, v, species,
                ["free"] * n, np.diag([Lx * 10, Ly * 10, Lz * 10]))

    lipid_species = " ".join(f"{an}xDPPC" for an in names)
    # SPECIES declarations carry mass/charge (reference decks declare
    # every <atomName>x<resName> species; examples/waterbox/object.data:111)
    species_decls = "\n".join(
        f"{an}xDPPC SPECIES {{ type=ATOM; charge={q}; id={i}; "
        f"mass=72.0 amu; }}"
        for i, (an, _, q) in enumerate(_DPPC_ATOMS)) + (
        f"\nWxW SPECIES {{ type=ATOM; charge=0.0; id={len(_DPPC_ATOMS)}; "
        f"mass=72.0 amu; }}")
    deck = f"""
simulate SIMULATE {{ type=MD; system=system; integrator=integ; dt={dt_fs};
  maxloop=1000000; printrate=200; checkpointrate=50000; ddc=ddc; }}
ddc DDC {{ updateRate=12; }}
bilayer POTENTIAL {{ type=MARTINI; parmfile=bilayer.data;
  cutoff=11 Angstrom; rcoulomb=11 Angstrom; epsilon_r=15; epsilon_rf=-1; }}
integ INTEGRATOR {{ type=NGLFCONSTRAINT; T={T}K; P0=1.0 bar;
  beta={beta_per_bar}/bar; tauBarostat={tau_ps} ps; isotropic={isotropic}; }}
system SYSTEM {{ type=NORMAL; potential=bilayer; neighbor=nbr; groups=free;
  box=box; collection=collection; moleculeClass=moleculeClass; }}
box BOX {{ type=ORTHORHOMBIC; pbc=7;
  h= {Lx * 10:.6f} 0 0 0 {Ly * 10:.6f} 0 0 0 {Lz * 10:.6f} ; }}
nbr NEIGHBOR {{ type=NORMAL; deltaR=3.0 Angstrom; }}
free GROUP {{ type=LANGEVIN; Teq={T}K; tau=1.0ps; }}
collection COLLECTION {{ mode=VARRECORDASCII; size={n}; files=atoms#; }}
moleculeClass MOLECULECLASS {{ molecules= DppcM WatM ; }}
DppcM MOLECULE {{ ownershipSpecies=NC3xDPPC; species= {lipid_species} ; }}
WatM MOLECULE {{ ownershipSpecies=WxW; species= WxW ; }}
{species_decls}
"""
    with open(os.path.join(out_dir, "object.data"), "w") as f:
        f.write(deck)
    with open(os.path.join(out_dir, "bilayer.data"), "w") as f:
        f.write(_dppc_mmff())
    return out_dir


def equilibrated_bilayer(out_dir, *, nx=48, steps=3000, dt_fs=5.0,
                         **sim_kw):
    """Build the nx x nx DPPC bilayer in out_dir and settle its start at a
    small dt: under NPT the synthetic start compresses ~29% in volume
    within ~10 ps, which at the production dt (20 fs) can catapult beads
    through the rollback ladder.  Runs `steps` steps at dt_fs on a copy
    of the deck (Simulation keyword arguments in sim_kw) and checkpoints
    into out_dir.  Returns (restart path, the Simulation that ran)."""
    from ..io.restart import write_checkpoint
    from ..run.simulate import Simulation

    martini_bilayer(out_dir, nx=nx, ny=nx)
    eq_dir = os.path.join(out_dir, "equilibration")
    os.makedirs(eq_dir, exist_ok=True)
    martini_bilayer(eq_dir, nx=nx, ny=nx, dt_fs=dt_fs)
    db, base = load(eq_dir)
    sim = Simulation(db, base, run_dir=out_dir, **sim_kw)
    sim.run(steps, print_fn=lambda s: None,
            max_steps_per_dispatch=min(500, steps))
    # the restart's relative files= path resolves against out_dir
    write_checkpoint(sim, out_dir)
    return os.path.join(out_dir, "restart"), sim


def load(out_dir, restart=None):
    """Compile a built model dir into (db, base_dir) ready for Simulation."""
    from ..run.cli import load_db

    decks = [os.path.join(out_dir, "object.data")]
    return load_db(decks, restart, out_dir), out_dir
