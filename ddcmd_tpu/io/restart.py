"""Checkpoint write: snapshot dir + atoms# shards + restart object file.

Reference: writeRestart (/root/reference/src/io.c:58-114).  Properties
kept: the restart file is itself an object deck that participates in
config compilation; atomic `restart` symlink; self-describing atoms#
FILEHEADER.
"""

from __future__ import annotations

import os

import numpy as np

from ..objects import units as U
from .collection import write_collection


def write_snapshot(sim, run_dir: str = ".") -> str:
    """Lightweight trajectory dump at snapshotrate (writeBXYZ analog,
    /root/reference/src/io.c:144): atoms shard + bxyz + profile, NO
    restart symlink update."""
    snapdir = write_checkpoint(sim, run_dir, update_symlink=False)
    write_bxyz(sim, snapdir)
    if any(p[0] == "ORDERSH" for p in sim.sysdef.potentials):
        # per-L q{L}# shards (+ optional cluster dump) at the snapshot
        # cadence (writeqlocal, /root/reference/src/masters.c:348)
        from ..potentials.ordersh import write_qlocal_files

        write_qlocal_files(sim, snapdir)
    return snapdir


def write_bxyz(sim, snapdir: str) -> str:
    """bxyz: compact binary per-particle dump (collection_writeBXYZ
    mode 1, /root/reference/src/collection_write.c:338-410):
    checksum u4 | id b8 | pinfo b2 | rx ry rz vx vy vz energy virial f4
    in external units (Angstrom, Angstrom/fs, eV)."""
    sd = sim.sysdef
    ss = sim.ss
    n = sd.state.n_local
    r = np.asarray(ss.state.r[:n], dtype=np.float64) * U.LENGTH_TO_ANG
    v = np.asarray(ss.state.v[:n], dtype=np.float64) \
        * (U.LENGTH_TO_ANG / U.TIME_TO_FS)
    pe = np.asarray(ss.state.pe[:n], dtype=np.float64) / U.unit_scale("eV")
    gid = ss.state.gid64()[:n]
    col = sd.collection
    groups = [g.name for g in sd.groups]
    specs = [s.name for s in sd.species]
    smap = {s: i for i, s in enumerate(specs)}
    gmap = {g: i for i, g in enumerate(groups)}
    n_groups = max(1, len(groups))
    pinfo = np.array([smap.get(s, 0) * n_groups + gmap.get(g, 0)
                      for s, g in zip(col.species_names, col.group_names)],
                     dtype="<u2")
    lrec = 4 + 8 + 2 + 8 * 4
    recs = np.zeros((n, lrec), dtype=np.uint8)
    recs[:, 4:12] = gid.astype("<u8").view(np.uint8).reshape(n, 8)
    recs[:, 12:14] = pinfo.view(np.uint8).reshape(n, 2)
    payload = np.concatenate(
        [r, v, pe[:, None], np.zeros((n, 1))], axis=1).astype("<f4")
    recs[:, 14:] = payload.view(np.uint8).reshape(n, 32)
    from .fastio import crc32_rows

    recs[:, 0:4] = crc32_rows(recs, skip=4).astype("<u4").view(
        np.uint8).reshape(n, 4)
    path = os.path.join(snapdir, "bxyz#000000")
    hdr = (f"bxyz FILEHEADER {{type=FIXRECORDBINARY; lrec={lrec};"
           f" nrecord={n}; nfields=11; endian_key=875770417;\n"
           "field_names=checksum id pinfo rx ry rz vx vy vz energy virial;\n"
           "field_types=u4 b8 b2 f4 f4 f4 f4 f4 f4 f4 f4;\n"
           "field_units=1 1 1 Angstrom Angstrom Angstrom Angstrom/fs "
           "Angstrom/fs Angstrom/fs eV eV;\n"
           f"groups={' '.join(groups)};\nspecies={' '.join(specs)};\n}}\n\n")
    with open(path, "wb") as f:
        f.write(hdr.encode())
        f.write(recs.tobytes())
    return path


def write_checkpoint(sim, run_dir: str = ".", update_symlink: bool = True,
                     atoms_writer=None) -> str:
    """Write snapshot.<loop>/ with atoms#000000 + restart, update symlink.

    atoms_writer(snapdir, mode, loop, time_fs): optional override for the
    particle-record output -- the sharded driver's per-device N-writer
    path (pio Pio_setNumWriteFiles analog) plugs in here so the restart/
    pxyz/profile scaffolding stays shared."""
    sd = sim.sysdef
    ss = sim.ss
    loop = int(ss.loop)
    # host-side f64 time: loop count is exact, device time is f32
    time_fs = (sd.cfg.time + (loop - sd.cfg.loop) * sd.cfg.dt) * U.TIME_TO_FS
    ndig = max(sd.cfg.nLoopDigits, 6)
    snapdir = os.path.join(run_dir, f"snapshot.{loop:0{ndig}d}")
    os.makedirs(snapdir, exist_ok=True)

    col = sd.collection
    h = np.asarray(ss.box.h, dtype=np.float64)

    colobj = sd.db.find(
        sd.db.get(sd.cfg.system_name, "SYSTEM").get_str("collection", "collection"),
        "COLLECTION")
    mode = colobj.get_str("mode", "VARRECORDASCII") if colobj else "VARRECORDASCII"
    n = ss.state.n_local
    if atoms_writer is not None:
        atoms_writer(snapdir, mode, loop, time_fs)
    else:
        state = ss.state
        r = np.asarray(state.r[:n], dtype=np.float64)
        v = np.asarray(state.v[:n], dtype=np.float64)
        gid = state.gid64()
        write_collection(
            os.path.join(snapdir, "atoms#000000"),
            gid=gid,
            species_names=col.species_names,
            group_names=col.group_names,
            class_names=col.class_names,
            r=r, v=v, h=h, loop=loop, time_fs=time_fs,
            group_list=[g.name for g in sd.groups],
            species_list=[s.name for s in sd.species],
            gid_format="hex" if sd.cfg.gidFormat == "hex" else "dec",
            datatype=mode,
            nfiles=sd.cfg.nfiles,
            precision=sd.cfg.checkpointprecision,
        )

    hang = h * U.LENGTH_TO_ANG
    hstr = "\n".join("     %22.14g %22.14g %22.14g" % tuple(row) for row in hang)
    with open(os.path.join(snapdir, "restart"), "w") as f:
        f.write(f"simulate SIMULATE {{ loop={loop}; time={time_fs:.6f} ;}}\n")
        f.write(f"box BOX {{\nh={hstr} ;\n}}\n")
        if sd.integrator_type == "NPTGLF":
            # zeta is restart-persisted (nptglf_writedynamic, nptglf.c:34)
            zeta_ext = U.convert(float(ss.zeta), None, "pressure*t")
            f.write(f"{sd.cfg.integrator_name} INTEGRATOR {{ zeta={zeta_ext:.12e} ; }}\n")
        elif sd.integrator_type == "NGLFNK":
            # piston velocities dL/dt persist across restarts (the
            # integrator writedynamic contract, integrator.c:173-175)
            bd = [U.convert(float(x), None, "l/t") for x in np.asarray(ss.bdot)]
            f.write(f"{sd.cfg.integrator_name} INTEGRATOR {{ bdot="
                    + " ".join(f"{x:.12e}" for x in bd)
                    + " Angstrom/fs ; }\n")
        f.write(f"collection COLLECTION {{ mode={mode}; size={n};"
                f" files={os.path.basename(snapdir)}/atoms#;}}\n")
        # RNG continuity: the PRNG key is the JAX analog of the
        # reference's per-particle random-stream serialization (lcg64.c
        # bwrite); restoring it makes restarted thermostat noise identical
        key = np.asarray(getattr(sim, "key", np.zeros(2, np.uint32)))
        rname = sd.db.get(sd.cfg.system_name, "SYSTEM").get_str(
            "random", "random")
        f.write("%s RANDOM { keyData=%d %d; }\n"
                % (rname, int(key[0]), int(key[1])))

    # per-phase timing table into the snapshot (dumpprofile, ddcMD.c:209-223)
    from ..utils.profile import PROFILE

    if os.environ.get("DDCMD_PROFILE_PHASES"):
        # opt-in: time rebuild/force/kick as separate dispatches so the
        # snapshot profile has per-phase attribution (ptiming.h analog);
        # off by default -- it re-runs phases outside the fused step
        try:
            sim.profile_phases()
        except Exception as err:   # broken profiler must report, not hide
            print(f"profile_phases: FAILED ({type(err).__name__}: {err})")
    PROFILE.write(snapdir)

    # domain-center decomposition file (writePXYZ, io.c:113)
    from .pxyz import write_pxyz

    write_pxyz(os.path.join(snapdir, "pxyz"),
               np.asarray(ss.box.lengths, dtype=np.float64),
               getattr(sim, "parallel_plan", None))

    if not update_symlink:
        return snapdir

    # atomic restart symlink (io.c:106-110)
    link = os.path.join(run_dir, "restart")
    tmp = link + ".tmp"
    target = os.path.join(os.path.basename(snapdir), "restart")
    if os.path.islink(tmp) or os.path.exists(tmp):
        os.remove(tmp)
    os.symlink(target, tmp)
    os.replace(tmp, link)
    return snapdir
