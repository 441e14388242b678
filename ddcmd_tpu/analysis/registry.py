"""ANALYSIS registry: rate-driven measurement modules.

Reference: /root/reference/src/analysis.c:148-395 (~18 modules).
Interface mirrors the reference contract {startup, eval at eval_rate,
output at outputrate} (/root/reference/src/masters.c:295-302).  Device
math runs jitted on the padded state; accumulation/state lives on host.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np

from ..objects import DeckError, DeckObject
from ..objects import units as U


@dataclass
class Analysis:
    name: str
    obj: DeckObject
    eval_rate: int
    output_rate: int
    state: dict = field(default_factory=dict)

    def eval(self, sim):
        raise NotImplementedError

    def output(self, sim, run_dir="."):
        raise NotImplementedError

    def _shard_jit(self, psim, build, key=()):
        """Per-instance cache for jit(shard_map(...)) programs: building
        the closure fresh on every eval retraces AND recompiles each
        time.  Keyed on the mesh + any closure-captured values that can
        change."""
        k = (id(psim.mesh),) + tuple(key)
        if getattr(self, "_sjit_key", None) != k:
            self._sjit = build()
            self._sjit_key = k
        return self._sjit


# ---------------------------------------------------------------------------

class PairCorrelation(Analysis):
    """g(r) histogram (reference paircorrelation.c, 547 LoC)."""

    def setup(self):
        self.delta_r = self.obj.get_with_units("delta_r", "1.0", "l")
        self.n_bins = self.obj.get_int("length", 1)
        self.rmin = self.obj.get_with_units("rmin", "0.0", "l")
        self.filename = self.obj.get_str("filename", "paircorrelation.dat")
        self.state["hist"] = np.zeros(self.n_bins)
        self.state["count"] = 0
        self._jit = None

    def eval(self, sim):
        ss = sim.ss
        n = sim.sysdef.state.n_local
        if self._jit is None:
            rmin, dr, nb = self.rmin, self.delta_r, self.n_bins

            def hist_fn(r, L, fmask):
                d = r[:, None, :] - r[None, :, :]
                d = d - L * jnp.round(d / L)
                dist = jnp.sqrt(jnp.sum(d * d, axis=-1))
                w = fmask[:, None] * fmask[None, :]
                w = w * (1.0 - jnp.eye(r.shape[0], dtype=r.dtype))
                b = jnp.floor((dist - rmin) / dr).astype(jnp.int32)
                b = jnp.where((b >= 0) & (b < nb), b, nb)
                return jnp.zeros(nb + 1).at[b.reshape(-1)].add(w.reshape(-1))[:nb]

            self._jit = jax.jit(hist_fn)
        h = self._jit(ss.state.r, ss.box.lengths, ss.state.fmask)
        self.state["hist"] += np.asarray(h, dtype=np.float64)
        self.state["count"] += 1
        self.state["volume"] = float(ss.box.volume)
        self.state["n"] = n

    def eval_sharded(self, psim):
        """Per-device partial histogram + psum over the mesh instead of
        gathering the whole system to host (the scalable remote-data
        path, /root/reference/src/dataExchange.c:21,107: analyses
        accumulate where the particles live; only reductions travel).
        Each ordered pair is counted on its row-atom's owner exactly
        once, so the result matches the gathered eval bin-for-bin.
        Requires rmax <= the halo window (plan.rlist)."""
        import jax
        from jax.sharding import PartitionSpec as P

        from ..parallel.brick import AXES, halo_exchange_3d

        rmax = self.rmin + self.n_bins * self.delta_r
        if rmax > psim.plan.rlist + 1e-12:
            raise ValueError(
                f"sharded PAIRCORRELATION needs rmax {rmax:.3f} <= halo "
                f"rlist {psim.plan.rlist:.3f}; use the gathered path")
        rmin, dr, nb = self.rmin, self.delta_r, self.n_bins
        Lv = jnp.asarray(psim.Lv)
        plan = psim.plan

        if self._jit is None or getattr(self, "_jit_kind", "") != "shard":
            def local_hist(fields, mask):
                r = fields["r"]
                ghosts, gmask, ov = halo_exchange_3d(
                    {"r": r}, mask, Lv, plan)
                r_all = jnp.concatenate([r, ghosts["r"]])
                m_all = jnp.concatenate([mask, gmask]).astype(r.dtype)
                d = r[:, None, :] - r_all[None, :, :]
                d = d - Lv * jnp.round(d / Lv)
                dist = jnp.sqrt(jnp.sum(d * d, axis=-1))
                w = mask.astype(r.dtype)[:, None] * m_all[None, :]
                # self-pair: local row i is column i of the pool
                n_loc = r.shape[0]
                eye = (jnp.arange(n_loc)[:, None]
                       == jnp.arange(r_all.shape[0])[None, :])
                w = jnp.where(eye, 0.0, w)
                b = jnp.floor((dist - rmin) / dr).astype(jnp.int32)
                b = jnp.where((b >= 0) & (b < nb), b, nb)
                h = jnp.zeros(nb + 1).at[b.reshape(-1)].add(
                    w.reshape(-1))[:nb]
                return jax.lax.psum(h, tuple(AXES))

            PS = P(("bx", "by", "bz"))
            self._jit = jax.jit(jax.shard_map(
                local_hist, mesh=psim.mesh,
                in_specs=({"r": PS}, PS), out_specs=P(),
                check_vma=False))
            self._jit_kind = "shard"
        h = self._jit({"r": psim.fields["r"]}, psim.mask)
        self.state["hist"] += np.asarray(h, dtype=np.float64)
        self.state["count"] += 1
        self.state["volume"] = float(np.prod(np.asarray(psim.Lv)))
        self.state["n"] = psim.sysdef.state.n_local

    def output(self, sim, run_dir="."):
        h = self.state["hist"]
        cnt = max(self.state["count"], 1)
        n = self.state["n"]
        rho = n / self.state["volume"]
        lines = ["# r(Ang) g(r)"]
        for b in range(self.n_bins):
            r_lo = self.rmin + b * self.delta_r
            r_hi = r_lo + self.delta_r
            shell = 4.0 / 3.0 * np.pi * (r_hi ** 3 - r_lo ** 3)
            g = h[b] / cnt / (n * rho * shell)
            lines.append(f"{(r_lo + 0.5 * self.delta_r) * U.LENGTH_TO_ANG:10.4f} {g:12.6f}")
        with open(os.path.join(run_dir, self.filename), "w") as f:
            f.write("\n".join(lines) + "\n")


class VcmWrite(Analysis):
    """center-of-mass velocity/momentum log (vcmWrite.c)."""

    def setup(self):
        self.filename = self.obj.get_str("filename", "vcm.data")
        self.state["rows"] = []

    def eval(self, sim):
        st = sim.ss.state
        n = sim.sysdef.state.n_local
        m = np.asarray(st.mass[:n])
        v = np.asarray(st.v[:n])
        vcm = (m[:, None] * v).sum(axis=0) / m.sum()
        self.state["rows"].append((int(sim.ss.loop), *vcm))

    def eval_sharded(self, psim):
        """Owned-row momentum partial sums + psum (dataExchange.c
        analog: only the reduction travels, never the particles)."""
        import jax
        from jax.sharding import PartitionSpec as P

        from ..parallel.brick import AXES

        def local(v, m, mask):
            w = m * mask.astype(m.dtype)
            p = jax.lax.psum(jnp.sum(w[:, None] * v, axis=0), tuple(AXES))
            msum = jax.lax.psum(jnp.sum(w), tuple(AXES))
            return p / msum

        PS = P(("bx", "by", "bz"))
        fn = self._shard_jit(psim, lambda: jax.jit(jax.shard_map(
            local, mesh=psim.mesh, in_specs=(PS, PS, PS), out_specs=P(),
            check_vma=False)))
        vcm = np.asarray(fn(psim.fields["v"], psim.fields["mass"],
                            psim.mask), dtype=np.float64)
        self.state["rows"].append((int(psim.loop), *vcm))

    def output(self, sim, run_dir="."):
        with open(os.path.join(run_dir, self.filename), "a") as f:
            for row in self.state["rows"]:
                f.write("%12d %18.10e %18.10e %18.10e\n" % row)
        self.state["rows"] = []


class KineticEnergyDistn(Analysis):
    """per-particle KE histogram (kineticEnergyDistn.c)."""

    def setup(self):
        self.n_bins = self.obj.get_int("nBins", 100)
        self.emax = self.obj.get_with_units("max", "1.0", "energy")
        self.filename = self.obj.get_str("filename", "keDistn.dat")
        self.state["hist"] = np.zeros(self.n_bins)

    def eval(self, sim):
        st = sim.ss.state
        n = sim.sysdef.state.n_local
        m = np.asarray(st.mass[:n])
        v = np.asarray(st.v[:n])
        ke = 0.5 * m * (v ** 2).sum(axis=1)
        h, _ = np.histogram(ke, bins=self.n_bins, range=(0, self.emax))
        self.state["hist"] += h

    def eval_sharded(self, psim):
        """Per-device KE histogram of owned rows + psum."""
        import jax
        from jax.sharding import PartitionSpec as P

        from ..parallel.brick import AXES

        nb, emax = self.n_bins, float(self.emax)

        def local(v, m, mask):
            ke = 0.5 * m * jnp.sum(v * v, axis=1)
            b = jnp.floor(ke / emax * nb).astype(jnp.int32)
            # np.histogram semantics: right edge inclusive into last bin
            b = jnp.where((b == nb) & (ke <= emax), nb - 1, b)
            b = jnp.where((b >= 0) & (b < nb) & mask, b, nb)
            h = jnp.zeros(nb + 1).at[b].add(1.0)[:nb]
            return jax.lax.psum(h, tuple(AXES))

        PS = P(("bx", "by", "bz"))
        fn = self._shard_jit(psim, lambda: jax.jit(jax.shard_map(
            local, mesh=psim.mesh, in_specs=(PS, PS, PS), out_specs=P(),
            check_vma=False)))
        h = np.asarray(fn(psim.fields["v"], psim.fields["mass"],
                          psim.mask), dtype=np.float64)
        self.state["hist"] += h

    def output(self, sim, run_dir="."):
        db = self.emax / self.n_bins
        with open(os.path.join(run_dir, self.filename), "w") as f:
            f.write("# KE(kJ/mol) count\n")
            for b, c in enumerate(self.state["hist"]):
                f.write(f"{(b + 0.5) * db:12.5f} {c:14.1f}\n")


class ZDensity(Analysis):
    """density profile along z (zdensity.c)."""

    def setup(self):
        self.n_bins = self.obj.get_int("nBins", 100)
        self.filename = self.obj.get_str("filename", "zdensity.dat")
        self.state["hist"] = None
        self.state["count"] = 0

    def eval(self, sim):
        st = sim.ss.state
        n = sim.sysdef.state.n_local
        z = np.asarray(st.r[:n, 2])
        Lz = float(sim.ss.box.lengths[2])
        h, _ = np.histogram(z, bins=self.n_bins, range=(-Lz / 2, Lz / 2))
        if self.state["hist"] is None:
            self.state["hist"] = np.zeros(self.n_bins)
        self.state["hist"] += h
        self.state["count"] += 1
        self.state["Lz"] = Lz

    def eval_sharded(self, psim):
        """Per-device z histogram of OWNED rows + psum (dataExchange
        analog; no host gather)."""
        import jax
        from jax.sharding import PartitionSpec as P

        from ..parallel.brick import AXES

        Lz = float(np.asarray(psim.Lv)[2])
        nb = self.n_bins

        def local_hist(r, mask, Lz):
            # np.histogram semantics (the gathered eval): out-of-range
            # dropped, right edge inclusive into the last bin.  Lz is a
            # runtime arg so NPT box changes don't retrace.
            z = r[:, 2]
            b = jnp.floor((z / Lz + 0.5) * nb).astype(jnp.int32)
            b = jnp.where((b == nb) & (z <= 0.5 * Lz), nb - 1, b)
            b = jnp.where((b >= 0) & (b < nb) & mask, b, nb)
            h = jnp.zeros(nb + 1).at[b].add(1.0)[:nb]
            return jax.lax.psum(h, tuple(AXES))

        PS = P(("bx", "by", "bz"))
        fn = self._shard_jit(psim, lambda: jax.jit(jax.shard_map(
            local_hist, mesh=psim.mesh, in_specs=(PS, PS, P()),
            out_specs=P(), check_vma=False)))
        h = np.asarray(fn(psim.fields["r"], psim.mask,
                          jnp.asarray(Lz, psim.fields["r"].dtype)),
                       dtype=np.float64)
        if self.state["hist"] is None:
            self.state["hist"] = np.zeros(self.n_bins)
        self.state["hist"] += h
        self.state["count"] += 1
        self.state["Lz"] = Lz

    def output(self, sim, run_dir="."):
        cnt = max(self.state["count"], 1)
        Lz = self.state["Lz"]
        dz = Lz / self.n_bins
        with open(os.path.join(run_dir, self.filename), "w") as f:
            f.write("# z(Ang) count/frame\n")
            for b, c in enumerate(self.state["hist"]):
                z = -Lz / 2 + (b + 0.5) * dz
                f.write(f"{z * U.LENGTH_TO_ANG:10.4f} {c / cnt:14.4f}\n")


class Ssf(Analysis):
    """static structure factor S(k) on a k-shell grid (ssf.c)."""

    def setup(self):
        self.n_shells = self.obj.get_int("nShells", 32)
        self.kmax = self.obj.get_with_units("kmax", "10.0", "1/l")
        self.filename = self.obj.get_str("filename", "ssf.dat")
        self.state["acc"] = np.zeros(self.n_shells)
        self.state["cnt"] = np.zeros(self.n_shells)
        self._kvecs = None

    def _kvectors(self, L):
        if self._kvecs is None:
            mmax = int(np.floor(self.kmax * L.min() / (2 * np.pi)))
            mmax = max(1, min(mmax, 12))
            ks = []
            for ix in range(0, mmax + 1):
                for iy in range(-mmax, mmax + 1):
                    for iz in range(-mmax, mmax + 1):
                        if ix == 0 and (iy < 0 or (iy == 0 and iz <= 0)):
                            continue
                        k = 2 * np.pi * np.array([ix, iy, iz]) / L
                        if np.linalg.norm(k) <= self.kmax:
                            ks.append(k)
            self._kvecs = np.asarray(ks)
        return self._kvecs

    def _bin_shells(self, s):
        kn = np.linalg.norm(self._kvecs, axis=1)
        shell = np.minimum((kn / self.kmax * self.n_shells).astype(int),
                           self.n_shells - 1)
        np.add.at(self.state["acc"], shell, s)
        np.add.at(self.state["cnt"], shell, 1.0)

    def eval(self, sim):
        ss = sim.ss
        n = sim.sysdef.state.n_local
        L = np.asarray(ss.box.lengths, dtype=np.float64)
        kv = self._kvectors(L)
        r = np.asarray(ss.state.r[:n])
        phase = r @ kv.T
        rho_k = np.exp(1j * phase).sum(axis=0)
        s = (rho_k * rho_k.conj()).real / n
        self._bin_shells(s)

    def eval_sharded(self, psim):
        """Per-device partial rho_k = sum_owned exp(i k.r) + psum; the
        |rho_k|^2 shell binning runs on the tiny k-grid host-side.  The
        k-space sum is the textbook shardable reduction -- no particle
        ever leaves its owner (ssf.c under MPI does the same allreduce)."""
        import jax
        from jax.sharding import PartitionSpec as P

        from ..parallel.brick import AXES

        L = np.asarray(psim.Lv, dtype=np.float64)
        kv = jnp.asarray(self._kvectors(L), psim.fields["r"].dtype)

        def local(r, mask):
            ph = r @ kv.T
            w = mask.astype(r.dtype)[:, None]
            c = jax.lax.psum(jnp.sum(w * jnp.cos(ph), axis=0), tuple(AXES))
            s = jax.lax.psum(jnp.sum(w * jnp.sin(ph), axis=0), tuple(AXES))
            return c, s

        PS = P(("bx", "by", "bz"))
        fn = self._shard_jit(psim, lambda: jax.jit(jax.shard_map(
            local, mesh=psim.mesh, in_specs=(PS, PS), out_specs=P(),
            check_vma=False)), key=(kv.shape,))
        c, s = fn(psim.fields["r"], psim.mask)
        n = psim.sysdef.state.n_local
        sk = (np.asarray(c, np.float64) ** 2
              + np.asarray(s, np.float64) ** 2) / n
        self._bin_shells(sk)

    def output(self, sim, run_dir="."):
        with open(os.path.join(run_dir, self.filename), "w") as f:
            f.write("# k(1/Ang) S(k)\n")
            for b in range(self.n_shells):
                if self.state["cnt"][b] == 0:
                    continue
                k = (b + 0.5) * self.kmax / self.n_shells
                f.write(f"{k / U.LENGTH_TO_ANG:10.5f} "
                        f"{self.state['acc'][b] / self.state['cnt'][b]:12.6f}\n")


class VelocityAutocorrelation(Analysis):
    """VAF C(t) = <v(0).v(t)> (velocityAutocorrelation.c)."""

    def setup(self):
        self.length = self.obj.get_int("length", 100)
        self.filename = self.obj.get_str("filename", "vaf.dat")
        self.state["v0"] = None
        self.state["rows"] = []

    def eval(self, sim):
        st = sim.ss.state
        n = sim.sysdef.state.n_local
        v = np.asarray(st.v[:n])
        if self.state["v0"] is None or len(self.state["rows"]) >= self.length:
            self.state["v0"] = v.copy()
            self.state["rows"] = []
        c = (v * self.state["v0"]).sum() / n
        self.state["rows"].append((int(sim.ss.loop), c))

    def output(self, sim, run_dir="."):
        with open(os.path.join(run_dir, self.filename), "w") as f:
            f.write("# loop C(t) (nm/ps)^2\n")
            for loop, c in self.state["rows"]:
                f.write(f"{loop:12d} {c:16.8e}\n")


class SubsetWrite(Analysis):
    """subsetWrite: periodic trajectory dumps of a particle subset
    (subsetWrite.c, 568 LoC; formats ascii | binaryCharmm).  The
    binaryCharmm format here is a simple float32 (n,3) frame stream with
    an ASCII header file, serving the same post-processing role."""

    def setup(self):
        self.format = self.obj.get_str("format", "ascii")
        self.dirname = self.obj.get_str("dirname", "subset")
        self.species = self.obj.get_strv("species")
        self.state["frame"] = 0

    def eval(self, sim):
        pass  # write at outputrate only

    def output(self, sim, run_dir="."):
        sd = sim.sysdef
        n = sd.state.n_local
        sel = np.ones(n, dtype=bool)
        if self.species:
            sel = np.isin(np.asarray(sd.collection.species_names), self.species)
        r = np.asarray(sim.ss.state.r[:n])[sel]
        outdir = os.path.join(run_dir, self.dirname)
        os.makedirs(outdir, exist_ok=True)
        loop = int(sim.ss.loop)
        if self.format.lower() == "binarycharmm":
            path = os.path.join(outdir, f"frame_{loop:012d}.bin")
            (r * U.LENGTH_TO_ANG).astype("<f4").tofile(path)
            with open(os.path.join(outdir, "header"), "w") as f:
                f.write(f"n={sel.sum()}; fields=rx ry rz; units=Ang; "
                        f"dtype=float32; last_loop={loop};\n")
        else:
            from ..io.collection import write_collection

            gid = sd.collection.gid[sel]
            write_collection(
                os.path.join(outdir, f"atoms_{loop:012d}#000000"),
                gid=gid,
                species_names=[s for s, m in zip(sd.collection.species_names, sel) if m],
                group_names=[g for g, m in zip(sd.collection.group_names, sel) if m],
                class_names=[c for c, m in zip(sd.collection.class_names, sel) if m],
                r=r, v=np.asarray(sim.ss.state.v[:n])[sel],
                h=np.asarray(sim.ss.box.h), loop=loop,
                time_fs=float(sim.ss.time) * U.TIME_TO_FS)
        self.state["frame"] += 1


class StressWrite(Analysis):
    """stressWrite: append the global stress tensor (stressWrite.c)."""

    def setup(self):
        self.filename = self.obj.get_str("filename", "stress.data")
        self.state["rows"] = []

    def eval(self, sim):
        e = sim.ss.energy
        vol = float(sim.ss.box.volume)
        sion = -(np.asarray(e.virial) + np.asarray(e.tion)) / vol
        c = U.convert(1.0, None, "bar")
        self.state["rows"].append((int(sim.ss.loop),) + tuple(
            sion[i, j] * c for i, j in
            ((0, 0), (1, 1), (2, 2), (0, 1), (0, 2), (1, 2))))

    def output(self, sim, run_dir="."):
        path = os.path.join(run_dir, self.filename)
        new = not os.path.exists(path)
        with open(path, "a") as f:
            if new:
                f.write("#loop sxx syy szz sxy sxz syz (bar)\n")
            for row in self.state["rows"]:
                f.write("%12d" % row[0] + "".join(" %16.8e" % v for v in row[1:]) + "\n")
        self.state["rows"] = []


class ForceAverage(Analysis):
    """forceAverage: time-averaged per-species mean |F| (forceAverage.c)."""

    def setup(self):
        self.filename = self.obj.get_str("filename", "forceAverage.dat")
        self.state["acc"] = {}
        self.state["count"] = 0

    def eval(self, sim):
        sd = sim.sysdef
        n = sd.state.n_local
        f = np.asarray(sim.ss.state.f[:n])
        sp = np.asarray(sd.collection.species_names)
        for name in np.unique(sp):
            m = sp == name
            self.state["acc"].setdefault(name, 0.0)
            self.state["acc"][name] += np.linalg.norm(f[m], axis=1).mean()
        self.state["count"] += 1

    def output(self, sim, run_dir="."):
        cnt = max(self.state["count"], 1)
        with open(os.path.join(run_dir, self.filename), "w") as f:
            f.write("# species <|F|> (kJ/mol/nm)\n")
            for name, acc in sorted(self.state["acc"].items()):
                f.write(f"{name:12s} {acc / cnt:16.8e}\n")


def _dsf_shell(m):
    """Integer k-triples with i^2+j^2+k^2 = m^2, half-space deduped
    (addKvectors, dsf.c:237-268).  The FULL shell, not the reference's
    axis-aligned 'testing!!!!!' restriction (dsf.c:258) -- that line is
    an obviously-temporary debug clamp left in the open release."""
    out = []
    msq = m * m
    for i in range(-m, m + 1):
        for j in range(-m, m + 1):
            for k in range(0, m + 1):
                if k == 0 and (j < 0 or (j == 0 and i <= 0)):
                    continue
                if i * i + j * j + k * k == msq:
                    out.append((i, j, k))
    return out


class Dsf(Analysis):
    """rho_k(t) series on integer reciprocal-lattice shells (dsf.c).

    Deck: m= list of integer shell radii (every (i,j,k) with
    |k|^2 = m^2, half-space deduped); species= optional filter;
    weight=charge (reference, dsf.c:205) or number.  Legacy kmax= decks
    get shells m=1..floor(kmax L/2pi) (capped at 8).  Two outputs:
    the reference-format rho_k series table (loop, time, Re/Im per k;
    dsf_output, dsf.c:98-124) and the derived S(k,omega) periodogram.
    """

    def setup(self):
        ms = [int(v) for v in self.obj.get_floatv("m", "")]
        self.kmax = self.obj.get_with_units("kmax", "5.0", "1/l")
        self.species = self.obj.get_str("species", "")
        self.weight = self.obj.get_str("weight", "charge").lower()
        base = "rho_k" + (f"_{self.species}" if self.species else "")
        self.series_file = self.obj.get_str("seriesFilename", base + ".data")
        self.filename = self.obj.get_str("filename", "dsf.dat")
        self._m_list = ms
        self.state["series"] = []
        self.state["meta"] = []                 # (loop, time) rows
        self._kvecs = None
        self._ktrip = None

    def _plan_k(self, box):
        ms = self._m_list
        L = np.asarray(box.lengths, dtype=np.float64)
        if not ms:
            mmax = max(1, min(int(self.kmax * L.min() / (2 * np.pi)), 8))
            ms = list(range(1, mmax + 1))
        trips = []
        for m in ms:
            trips.extend(_dsf_shell(m))
        self._ktrip = np.asarray(trips, dtype=np.int64)
        # reciprocal basis rows b_a (b_a . h_col_b = 2 pi delta_ab):
        # exact for triclinic h
        h = np.asarray(box.h, dtype=np.float64)
        recip = 2.0 * np.pi * np.linalg.inv(h)
        self._kvecs = self._ktrip @ recip

    def eval(self, sim):
        ss = sim.ss
        n = sim.sysdef.state.n_local
        if self._kvecs is None:
            self._plan_k(ss.box)
        r = np.asarray(ss.state.r[:n], dtype=np.float64)
        if self.weight == "charge":
            w = np.asarray(ss.state.q[:n], dtype=np.float64)
        else:
            w = np.ones(n)
        count = n
        if self.species:
            names = np.asarray(sim.sysdef.collection.species_names)
            m = names == self.species
            r, w = r[m], w[m]
            count = int(m.sum())
        rho_k = (w[:, None] * np.exp(1j * (r @ self._kvecs.T))).sum(axis=0)
        rho_k /= max(count, 1)                  # dsf.c:214-216
        self.state["series"].append(rho_k)
        self.state["meta"].append((int(ss.loop), float(getattr(ss, "time", 0.0))))

    def output(self, sim, run_dir="."):
        series = np.asarray(self.state["series"])
        if not len(series):
            return
        # reference-format rho_k table (appended per output like dsf.c)
        path = os.path.join(run_dir, self.series_file)
        new = not os.path.exists(path)
        with open(path, "a") as f:
            if new:
                f.write("#loop            time")
                for t in self._ktrip:
                    f.write("    (%d,%d,%d)" % tuple(t))
                f.write("\n")
            for (loop, time), row in zip(self.state["meta"], series):
                f.write(f"{loop:08d} {time:16.6f}")
                for z in row:
                    f.write(f"   {z.real:13.6e} {z.imag:13.6e}")
                f.write("\n")
        self.state["meta"] = []
        if len(series) < 4:
            return
        # S(k, w) = |FFT_t rho_k(t)|^2 / T  (rho_k is complex: full FFT)
        F = np.fft.fft(series, axis=0)
        S = (F * F.conj()).real / len(series)
        kn = np.linalg.norm(self._kvecs, axis=1)
        with open(os.path.join(run_dir, self.filename), "w") as f:
            f.write("# k(1/Ang) omega_index S(k,omega)\n")
            for ki in range(S.shape[1]):
                for wi in range(S.shape[0]):
                    f.write(f"{kn[ki] / U.LENGTH_TO_ANG:10.5f} {wi:6d} "
                            f"{S[wi, ki]:14.6e}\n")


def _knn(r, L, K, tie_desc_d=False):
    """K nearest neighbors per particle: (idx (n,K), disp (n,K,3)) with
    disp = r_i - r_j min-imaged.  Small systems take the direct O(N^2)
    route; large ones go through the framework's cell-list candidate
    search (nbr/celllist -- the pairFinder-family service the reference
    analyses share, src/pairFinder.c) and select the K nearest among
    candidates, so a 94k-atom bilayer evaluates in seconds instead of
    materializing an (n, n, 3) displacement tensor.

    tie_desc_d: equal-distance ties rank by DESCENDING (dx, dy, dz)
    (the environment-invariant order quaternion.c:93 relies on);
    default ties rank by neighbor index."""
    n = len(r)
    if n <= 4096:
        d = r[:, None, :] - r[None, :, :]
        d -= L * np.round(d / L)
        dist2 = (d ** 2).sum(axis=-1)
        np.fill_diagonal(dist2, np.inf)
        if tie_desc_d:
            order = np.lexsort((-d[..., 2], -d[..., 1], -d[..., 0], dist2),
                               axis=1)[:, :K]
        else:
            order = np.lexsort((np.broadcast_to(np.arange(n), (n, n)),
                                dist2), axis=1)[:, :K]
        disp = np.take_along_axis(d, order[:, :, None], axis=1)
        return order, disp

    import jax.numpy as jnp

    from ..nbr.celllist import CellGrid, build_neighbor_list

    # candidate radius from density: sphere holding ~K neighbors + margin
    rho = n / float(np.prod(L))
    rlist = 1.35 * (3.0 * (K + 1) / (4.0 * np.pi * rho)) ** (1.0 / 3.0)
    rw = r - L * np.round(r / L)               # celllist wants wrapped
    for _ in range(5):
        grid = CellGrid.plan(L, rlist, 0.0, n, n)
        nbr, _, ov = build_neighbor_list(
            jnp.asarray(rw, jnp.float32), jnp.ones(n, jnp.float32),
            jnp.asarray(L, jnp.float32), grid)
        nbr = np.asarray(nbr)
        if not bool(ov) and ((nbr != n).sum(axis=1) >= K).all():
            break
        rlist *= 1.3
    else:
        raise RuntimeError(f"_knn: {K} neighbors not found within {rlist}")
    # exact f64 selection among candidates (f32 only prefilters)
    rows = np.arange(n)[:, None]
    r_ext = np.concatenate([r, np.zeros((1, 3))])
    d = r[:, None, :] - r_ext[nbr]
    d -= L * np.round(d / L)
    d2 = (d * d).sum(axis=-1)
    d2[nbr == n] = np.inf
    if tie_desc_d:
        sub = np.lexsort((-d[..., 2], -d[..., 1], -d[..., 0], d2),
                         axis=1)[:, :K]
    else:
        sub = np.lexsort((nbr, d2), axis=1)[:, :K]
    idx = nbr[rows, sub]
    disp = d[rows, sub]
    return idx, disp


def _nearest_neighbors(sim, n_neighbors):
    """Indices+displacements of the n nearest neighbors per particle."""
    n = sim.sysdef.state.n_local
    r = np.asarray(sim.ss.state.r[:n], dtype=np.float64)
    L = np.asarray(sim.ss.box.lengths, dtype=np.float64)
    return _knn(r, L, n_neighbors)


class Centrosym(Analysis):
    """centrosymmetry parameter (centrosym.c): for each particle, pair up
    the nNeighbors nearest neighbors to minimize |d_i + d_j|^2 (greedy)."""

    def setup(self):
        self.n_neighbors = self.obj.get_int("nNeighbors", 12)
        self.filename = self.obj.get_str("filename", "centrosym.dat")

    def eval(self, sim):
        idx, disp = _nearest_neighbors(sim, self.n_neighbors)
        n, K = disp.shape[0], self.n_neighbors
        # greedy antiparallel pairing, vectorized over particles: each
        # round pairs the first still-active bond with its best partner
        # (same pick order as the reference's per-atom scan)
        cs = np.zeros(n)
        active = np.ones((n, K), bool)
        rows = np.arange(n)
        for _ in range(K // 2):
            a = np.argmax(active, axis=1)               # first active bond
            va = disp[rows, a]
            s = ((disp + va[:, None, :]) ** 2).sum(-1)  # (n, K)
            s[~active] = np.inf
            s[rows, a] = np.inf
            b = np.argmin(s, axis=1)                    # ties: smallest b
            cs += s[rows, b]
            active[rows, a] = False
            active[rows, b] = False
        self.state["cs"] = cs

    def output(self, sim, run_dir="."):
        if "cs" not in self.state:
            return
        cs = self.state["cs"] * U.LENGTH_TO_ANG ** 2
        with open(os.path.join(run_dir, self.filename), "w") as f:
            f.write(f"# loop {int(sim.ss.loop)}: centrosymmetry (Ang^2) per particle\n")
            for v in cs:
                f.write(f"{v:12.6f}\n")


class AcklandJones(Analysis):
    """Ackland-Jones local crystal-structure classifier (ackland_jones.c):
    angular histogram over the 14 nearest neighbors -> FCC/HCP/BCC/ICO/UNK."""

    LABELS = ("UNKNOWN", "FCC", "HCP", "BCC", "ICO")

    def setup(self):
        self.filename = self.obj.get_str("filename", "acklandJones.dat")

    def eval(self, sim):
        idx, disp = _nearest_neighbors(sim, 14)
        n = disp.shape[0]
        # chi-bin boundaries from Ackland & Jones (PRB 73, 054104):
        # reference cosines -1 (chi0), -1/3 & -0.577 (chi4), 0 (chi5),
        # 1/3 & 0.5 & 0.577 (chi7); chi8 (>0.795) flags disorder.
        edges = np.array([-1.001, -0.945, -0.915, -0.755, -0.705, -0.195,
                          0.195, 0.245, 0.795, 1.001])
        d2 = (disp ** 2).sum(axis=-1)                   # (n, 14)
        r2_6 = d2[:, :6].mean(axis=1)
        sel = d2 < 1.45 * r2_6[:, None]                 # angular set
        n1 = sel.sum(axis=1)
        nrm = np.sqrt(np.where(d2 > 0, d2, 1.0))
        u = disp / nrm[:, :, None]
        cos = np.einsum("nkd,nld->nkl", u, u)
        kk, ll = np.arange(14)[:, None], np.arange(14)[None, :]
        pmask = sel[:, :, None] & sel[:, None, :] & (kk < ll)[None]
        chi = np.stack(
            [((cos >= edges[b]) & (cos < edges[b + 1]) & pmask).sum((1, 2))
             for b in range(9)], axis=1)                # (n, 9)
        x0, x1, x2, x3, x4, x5, x6, x7, x8 = (chi[:, b] for b in range(9))
        denom = x5 + x6 + x7 - x4
        delta_bcc = np.where(denom > 0,
                             0.35 * x4 / np.where(denom != 0, denom, 1),
                             10.0)
        delta_cp = np.abs(1.0 - x7 / 24.0)
        delta_fcc = 0.61 * (np.abs(x0 + x1 - 6) + x2) / 6.0
        delta_hcp = (np.abs(x0 - 3) + np.abs(x0 + x1 + x2 + x3 - 9)) / 12.0
        delta_bcc = np.where(x0 == 7, 0.0, delta_bcc)
        delta_fcc = np.where((x0 == 6) & (x0 != 7), 0.0, delta_fcc)
        delta_hcp = np.where((x0 <= 3), 0.0, delta_hcp)
        kinds = np.select(
            [n1 < 6,                                    # too few: UNKNOWN
             x8 > 0,                                    # near-parallel
             x4 < 3,
             delta_bcc <= delta_cp,
             (n1 > 12) | (n1 < 11),
             delta_fcc < delta_hcp],
            [0,
             0,
             np.where((n1 >= 11) & (n1 <= 13), 4, 0),
             np.where(n1 >= 11, 3, 0),
             0,
             1],
            default=2).astype(np.int32)
        self.state["kinds"] = kinds

    def output(self, sim, run_dir="."):
        if "kinds" not in self.state:
            return
        kinds = self.state["kinds"]
        counts = np.bincount(kinds, minlength=5)
        with open(os.path.join(run_dir, self.filename), "a") as f:
            f.write(f"loop={int(sim.ss.loop)} " + " ".join(
                f"{self.LABELS[k]}={counts[k]}" for k in range(5)) + "\n")


class CoarseGrain(Analysis):
    """coarsegrain.c (600 LoC): per-(cell, species) grid records with
    CIC smearing, accumulated between outputs.

    Deck: nx/ny/nz, smearRadius (0 = nearest-cell impulse),
    smearMethod=impulse|hat (coarsegrain.c:343-356), outputMode 1/2/3
    (field sets, coarsegrain.c:459-496), filename.  Fields follow the
    reference records: number_particles, mass, Kx/Ky/Kz, U (per-atom
    potential), px/py/pz; mode 2 adds the stress tensor; mode 3 swaps
    to the electrostatic view (Ex/Ey/Ez = f/q, ESpotential = U/q).
    Deviation (documented): the reference's per-atom configurational
    virial/stress (sion) is a CPU-engine running tally; these engines
    reduce the virial globally, so mode 1's `virial` column and mode 2's
    vir_* columns here carry the KINETIC part (m v_a v_b) only.
    """

    def setup(self):
        self.nx = self.obj.get_int("nx", 8)
        self.ny = self.obj.get_int("ny", 8)
        self.nz = self.obj.get_int("nz", 8)
        self.mode = self.obj.get_int("outputMode", 2)
        self.smear = self.obj.get_with_units("smearRadius", "0", "l")
        self.smethod = self.obj.get_str("smearMethod", "impulse").lower()
        self.filename = self.obj.get_str("filename", "cgrid")
        self.state["acc"] = None
        self.state["frames"] = 0

    def _weights(self, r, L, dims):
        """Cell indices + CIC weights: (P, 8) flat cells and weights.
        smearRadius<=0: single nearest cell (impulse into one cell)."""
        g = (r / L + 0.5 - np.floor(r / L + 0.5)) * dims   # [0, dims)
        if self.smear <= 0:
            c = np.clip(g.astype(int), 0, dims - 1)
            flat = (c[:, 0] * dims[1] + c[:, 1]) * dims[2] + c[:, 2]
            return flat[:, None], np.ones((len(r), 1))
        cell = L / dims
        l_sm = np.minimum(2.0 * self.smear, cell)          # coarsegrain.c:280
        wall = np.floor(g + 0.5)
        # physical offset of the atom from the nearest cell wall, clipped
        # to the smearing half-width and normalized by the smear width
        d = np.clip((wall - g), -0.5 * l_sm / cell, 0.5 * l_sm / cell) \
            * (cell / l_sm)
        if self.smethod == "hat":
            w0 = 0.5 + 2 * d * (1.0 - np.abs(d))
        else:                                              # impulse
            w0 = 0.5 + d
        lo = (wall.astype(int) - 1) % dims
        hi = wall.astype(int) % dims
        flats = np.empty((len(r), 8), dtype=np.int64)
        ws = np.empty((len(r), 8))
        k = 0
        for ii, wxi in ((0, w0[:, 0]), (1, 1 - w0[:, 0])):
            cx = lo[:, 0] if ii == 0 else hi[:, 0]
            for jj, wyi in ((0, w0[:, 1]), (1, 1 - w0[:, 1])):
                cy = lo[:, 1] if jj == 0 else hi[:, 1]
                for kk, wzi in ((0, w0[:, 2]), (1, 1 - w0[:, 2])):
                    cz = lo[:, 2] if kk == 0 else hi[:, 2]
                    flats[:, k] = (cx * dims[1] + cy) * dims[2] + cz
                    ws[:, k] = wxi * wyi * wzi
                    k += 1
        return flats, ws

    def eval(self, sim):
        st = sim.ss.state
        n = sim.sysdef.state.n_local
        r = np.asarray(st.r[:n], dtype=np.float64)
        v = np.asarray(st.v[:n], dtype=np.float64)
        m = np.asarray(st.mass[:n], dtype=np.float64)
        q = np.asarray(st.q[:n], dtype=np.float64)
        f = np.asarray(st.f[:n], dtype=np.float64)
        pe = np.asarray(st.pe[:n], dtype=np.float64)
        sp = np.asarray(st.species[:n])
        L = np.asarray(sim.ss.box.lengths, dtype=np.float64)
        dims = np.array([self.nx, self.ny, self.nz])
        nsp = int(sp.max()) + 1 if n else 1
        size = int(np.prod(dims))

        # per-atom field columns (coarsegrain.c:371-396)
        qs = np.where(np.abs(q) > 1e-12, q, np.inf)        # E undefined q=0
        cols = dict(
            number=np.ones(n), mass=m,
            Kx=0.5 * m * v[:, 0] ** 2, Ky=0.5 * m * v[:, 1] ** 2,
            Kz=0.5 * m * v[:, 2] ** 2, U=pe,
            virial=m * (v ** 2).sum(1) / 3.0,              # kinetic part
            px=m * v[:, 0], py=m * v[:, 1], pz=m * v[:, 2],
            vir_xx=m * v[:, 0] ** 2, vir_yy=m * v[:, 1] ** 2,
            vir_zz=m * v[:, 2] ** 2, vir_xy=m * v[:, 0] * v[:, 1],
            vir_xz=m * v[:, 0] * v[:, 2], vir_yz=m * v[:, 1] * v[:, 2],
            Ex=f[:, 0] / qs, Ey=f[:, 1] / qs, Ez=f[:, 2] / qs,
            ESpotential=pe / qs,
        )
        names = self._field_names()
        if self.state["acc"] is None or \
                self.state["acc"].shape != (size, nsp, len(names)):
            self.state["acc"] = np.zeros((size, nsp, len(names)))
        flats, ws = self._weights(r, L, dims)
        acc = self.state["acc"]
        for k in range(flats.shape[1]):
            keep = ws[:, k] > 1e-20
            idx = (flats[keep, k], sp[keep])
            for ci, nm in enumerate(names):
                np.add.at(acc, idx + (ci,), ws[keep, k] * cols[nm][keep])
        self.state["frames"] += 1
        self.state["vol_cell"] = float(np.prod(L)) / size

    def _field_names(self):
        if self.mode == 3:
            return ["number", "mass", "px", "py", "pz",
                    "Ex", "Ey", "Ez", "ESpotential"]
        base = ["number", "mass", "Kx", "Ky", "Kz", "U", "virial",
                "px", "py", "pz"]
        if self.mode == 2:
            base += ["vir_xx", "vir_yy", "vir_zz",
                     "vir_xy", "vir_xz", "vir_yz"]
        return base

    def output(self, sim, run_dir="."):
        if self.state["frames"] == 0 or self.state["acc"] is None:
            return
        frames = self.state["frames"]
        names = self._field_names()
        spnames = [s.name for s in getattr(sim.sysdef, "species", [])]
        acc = self.state["acc"] / frames
        with open(os.path.join(run_dir, self.filename), "w") as fh:
            fh.write("# label species_index " + " ".join(names) + "\n")
            fh.write(f"# nx={self.nx} ny={self.ny} nz={self.nz} "
                     f"frames={frames} species={','.join(spnames)}\n")
            for cell in range(acc.shape[0]):
                for s in range(acc.shape[1]):
                    row = acc[cell, s]
                    if row[0] < 1e-20:          # number_particles == 0
                        continue
                    fh.write(f"{cell:8d} {s:3d} " +
                             " ".join(f"{x:14.6e}" for x in row) + "\n")


class PairAnalysis(Analysis):
    """pairAnalysis (nbrList method): count pairs within rmax and print
    the count; output (re)creates an empty file -- faithful to the
    reference's shipped behavior, whose geom/grid methods are commented
    out (pairAnalysis.c:90-379)."""

    def setup(self):
        self.rmax = self.obj.get_with_units("rmax", "0", "l")
        self.filename = self.obj.get_str("filename", "pairAnalysis.dat")

    def eval(self, sim):
        n = sim.sysdef.state.n_local
        r = np.asarray(sim.ss.state.r[:n], dtype=np.float64)
        L = np.asarray(sim.ss.box.lengths, dtype=np.float64)
        d = r[:, None, :] - r[None, :, :]
        d -= L * np.round(d / L)
        r2 = (d * d).sum(-1)
        np.fill_diagonal(r2, np.inf)
        cnt = int((r2 < self.rmax ** 2).sum())  # ordered pairs, as reference
        self.state["cnt"] = cnt
        print(f"cnt={cnt}")

    def output(self, sim, run_dir="."):
        open(os.path.join(run_dir, self.filename), "w").close()


class Quaternion(Analysis):
    """quaternion: per-particle grain-orientation color from antiparallel
    bond pairs (quaternion_calc, /root/reference/src/quaternion.c:83-237).

    For each particle: of the 4*nPairs nearest neighbors, keep those with
    r^2 < rfcut * mean(6 nearest r^2); over all ordered pairs of kept bonds
    with cos(theta) in [-1.001, -0.945) pick the difference directions
    maximizing (dx+dy+dz) and (-dx+dy+dz); if the antiparallel-pair count
    equals NNs, build the local frame and emit the (QR,QG,QB) color,
    else (-0.1,-0.1,-0.1)."""

    def setup(self):
        self.n_pairs = self.obj.get_int("nPairs", 7)
        self.rcut = self.obj.get_with_units("rcut", "0.0", "l")
        self.rfcut = self.obj.get_float("rfcut", 1.65)
        self.nns = self.obj.get_int("NNs", 8)
        self.filename = self.obj.get_str("filename", "quaternion")

    def eval(self, sim):
        pass  # computed at output (quaternion_eval is empty, :64-67)

    def compute(self, r, L):
        n = len(r)
        K = 4 * self.n_pairs
        rows = np.arange(n)[:, None]
        # environment-invariant neighbor order: (r2, dx, dy, dz) so
        # equivalent atoms scan their bond pairs identically (the
        # reference relies on its pair-finder order, quaternion.c:93);
        # _knn routes big systems through the cell-list candidate search
        idx, dnn = _knn(r, L, K, tie_desc_d=True)
        disp = -dnn                                # displacement TO neighbor
        r2s = (dnn * dnn).sum(-1)                  # (n,K) ascending
        r2_1 = self.rfcut * r2s[:, :6].mean(axis=1)
        N0 = (r2s < r2_1[:, None]).sum(axis=1)     # prefix count (sorted)
        jj = np.arange(K)
        ok = (jj[None, :, None] < N0[:, None, None]) \
            & (jj[None, None, :] < N0[:, None, None])
        dots = np.einsum("njx,nkx->njk", disp, disp)
        norm = np.sqrt(r2s[:, :, None] * r2s[:, None, :])
        cth = dots / norm
        anti = ok & (cth >= -1.001) & (cth < -0.945)
        nns = anti.sum(axis=(1, 2))
        dd = disp[:, :, None, :] - disp[:, None, :, :]
        dn = np.linalg.norm(dd, axis=-1)
        with np.errstate(invalid="ignore", divide="ignore"):
            u = dd / dn[..., None]
        s1 = np.where(anti, u.sum(-1), -np.inf).reshape(n, -1)
        s2 = np.where(anti, -u[..., 0] + u[..., 1] + u[..., 2],
                      -np.inf).reshape(n, -1)
        uf = u.reshape(n, -1, 3)
        # reference keeps the LAST maximum (>= updates, quaternion.c:137-148)
        last = s1.shape[1] - 1
        nvec = uf[rows[:, 0], last - np.argmax(s1[:, ::-1], axis=1)]
        mvec = uf[rows[:, 0], last - np.argmax(s2[:, ::-1], axis=1)]
        p = np.cross(nvec, mvec)
        pnorm = np.linalg.norm(p, axis=1, keepdims=True)
        frame_ok = pnorm[:, 0] > 1e-10
        with np.errstate(invalid="ignore", divide="ignore"):
            p = p / np.where(pnorm > 0, pnorm, 1.0)
        f = 1.0 - 1e-5
        with np.errstate(invalid="ignore", divide="ignore"):
            theta = np.arccos(np.clip(f * nvec.sum(1) / np.sqrt(3.0), -1, 1))
            st = np.sin(theta)
            zero = theta == 0.0
            phi = np.where(zero, 0.0,
                           np.arcsin(np.clip(f * (-nvec[:, 1] + nvec[:, 2])
                                             / (np.sqrt(2.0) * np.where(zero, 1, st)), -1, 1)))
            psi = np.where(zero,
                           np.arccos(np.clip(f * (-p[:, 1] + p[:, 2]) / np.sqrt(2.0), -1, 1)),
                           np.arcsin(np.clip(f * p.sum(1)
                                             / (np.sqrt(3.0) * np.where(zero, 1, st)), -1, 1)))
        QR = (1.0 + np.sin(theta / 2) * np.cos((phi - psi) / 2)) / 2
        QG = (1.0 + np.sin(theta / 2) * np.sin((phi - psi) / 2)) / 2
        QB = (1.0 + np.cos(theta / 2) * np.sin((phi + psi) / 2)) / 2
        good = (nns == self.nns) & frame_ok
        QR = np.where(good, QR, -0.1)
        QG = np.where(good, QG, -0.1)
        QB = np.where(good, QB, -0.1)
        return QR, QG, QB

    def output(self, sim, run_dir="."):
        sd = sim.sysdef
        n = sd.state.n_local
        r = np.asarray(sim.ss.state.r[:n], dtype=np.float64)
        L = np.asarray(sim.ss.box.lengths, dtype=np.float64)
        QR, QG, QB = self.compute(r, L)
        loop = int(sim.ss.loop)
        outdir = os.path.join(run_dir, f"snapshot.{loop:012d}")
        os.makedirs(outdir, exist_ok=True)
        gid = sd.collection.gid
        rw = r - L * np.round(r / L)
        import zlib

        lrec = 112
        with open(os.path.join(outdir, self.filename + "#000000"), "wb") as fh:
            hdr = (f"quaternion FILEHEADER {{type=FIXRECORDASCII; lrec={lrec};"
                   f" nrecord={n}; nfields=10;\n"
                   "field_names=checksum label rx ry rz quaternion_0 "
                   "quaternion_1 quaternion_2 quaternion_3 quaternion_h;\n"
                   "field_types=u u f f f f f f f f;\n}\n\n")
            fh.write(hdr.encode())
            for i in range(n):
                q = (QR[i], QG[i], QB[i])
                line = ("%08x %12d %14.4f %14.4f %14.4f %8.4f %8.4f %8.4f "
                        "%8.4f %8.4f" % (
                            0, int(gid[i]),
                            rw[i, 0] * U.LENGTH_TO_ANG,
                            rw[i, 1] * U.LENGTH_TO_ANG,
                            rw[i, 2] * U.LENGTH_TO_ANG,
                            (q[0] + q[1] + q[2]) / 3.0, q[0], q[1], q[2],
                            q[0] * q[1] * q[2]))
                line = line.ljust(lrec - 1) + "\n"
                ck = zlib.crc32(line[8:].encode()) & 0xFFFFFFFF
                fh.write(("%08x" % ck).encode() + line[8:].encode())


class CholAnalysis(Analysis):
    """cholAnalysis: out-of-plane distances of the CHOL ring beads
    (cholAnalysis_eval, /root/reference/src/cholAnalysis.c:109-163):
    dR1 = A.(BxC)/|BxC| with A,B,C bonds from bead 0 to 1,2,3;
    dR5 = -D.(ExF)/|ExF| with D,E,F bonds from bead 4 to 5,3,6.
    Histograms + running min/max/ave appended to dataFilename."""

    def setup(self):
        self.resname = self.obj.get_str("resName", "CHOL")
        self.filename = self.obj.get_str("filename", "cholAnalysis.distn")
        self.data_filename = self.obj.get_str("dataFilename",
                                              "cholAnalysis.data")
        self.rmin = self.obj.get_with_units("rmin", "0", "l")
        self.rmax = self.obj.get_with_units("rmax", "0", "l")
        delta = self.obj.get_with_units("delta", "0.1", "l")
        self.nbins = max(1, round((self.rmax - self.rmin) / delta))
        self.delta = (self.rmax - self.rmin) / self.nbins
        self.state["cnt"] = np.zeros((2, self.nbins))
        self.state["acc"] = []

    def _rings(self, sim):
        inst = sim.sysdef.residue_instances or []
        return [rows for name, rows in inst if name == self.resname]

    def eval(self, sim):
        n = sim.sysdef.state.n_local
        r = np.asarray(sim.ss.state.r[:n], dtype=np.float64)
        L = np.asarray(sim.ss.box.lengths, dtype=np.float64)

        def bond(a, b):
            d = r[b] - r[a]
            return d - L * np.round(d / L)

        for rows in self._rings(sim):
            A = bond(rows[0], rows[1])
            B = bond(rows[0], rows[2])
            C = bond(rows[0], rows[3])
            D = bond(rows[4], rows[5])
            E = bond(rows[4], rows[3])
            F = bond(rows[4], rows[6])
            x1 = np.cross(B, C)
            dR1 = float(x1 @ A / np.linalg.norm(x1))
            x3 = np.cross(E, F)
            dR5 = float(-(x3 @ D) / np.linalg.norm(x3))
            self.state["acc"].append((dR1, dR5))
            for col, v in ((0, dR1), (1, dR5)):
                b = int(min(max((v - self.rmin) / self.delta, 0),
                            self.nbins - 1))
                self.state["cnt"][col, b] += 1

    def output(self, sim, run_dir="."):
        acc = np.asarray(self.state["acc"]) if self.state["acc"] else \
            np.zeros((0, 2))
        cnt = self.state["cnt"]
        lc = U.LENGTH_TO_ANG
        if len(acc):
            with open(os.path.join(run_dir, self.data_filename), "a") as f:
                f.write("%d %f %f %f %f %f %f %f\n" % (
                    int(sim.ss.loop), float(sim.ss.time),
                    acc[:, 0].min() * lc, acc[:, 0].max() * lc,
                    acc[:, 0].mean() * lc,
                    acc[:, 1].min() * lc, acc[:, 1].max() * lc,
                    acc[:, 1].mean() * lc))
        c1 = max(cnt[0].sum(), 1.0)
        c3 = max(cnt[1].sum(), 1.0)
        with open(os.path.join(run_dir, self.filename), "w") as f:
            for i in range(self.nbins):
                rr = self.rmin + (i + 0.5) * self.delta
                f.write(" %e %e %e\n" % (
                    rr * lc, cnt[0, i] / lc / (c1 * self.delta),
                    cnt[1, i] / lc / (c3 * self.delta)))
        self.state["cnt"] = np.zeros((2, self.nbins))
        self.state["acc"] = []


class DataSubset(Analysis):
    """dataSubset: time-averaged per-subset scalars appended to a file
    (/root/reference/src/dataSubset.c).  fields from {time, nSamples,
    nParticles, Etotal, Ekinetic, Epotential, Rx..Rz, Vx..Vz, Fx..Fz},
    species= selects the subset; values in external units (eV, Ang...)."""

    FIELDS = ("time", "nSamples", "nParticles", "Etotal", "Ekinetic",
              "Epotential", "Rx", "Ry", "Rz", "Vx", "Vy", "Vz",
              "Fx", "Fy", "Fz")

    def setup(self):
        self.fields = self.obj.get_strv("fields") or list(self.FIELDS[:6])
        for f in self.fields:
            if f not in self.FIELDS:
                raise DeckError(f"dataSubset: unknown field {f}")
        self.species = self.obj.get_strv("species")
        self.filename = self.obj.get_str("filename", self.name + ".data")
        self._clear()

    def _clear(self):
        self.state["sums"] = np.zeros(len(self.FIELDS))
        self.state["nsamples"] = 0

    def eval(self, sim):
        sd = sim.sysdef
        n = sd.state.n_local
        sel = np.ones(n, dtype=bool)
        if self.species:
            sel = np.isin(np.asarray(sd.collection.species_names),
                          self.species)
        st = sim.ss.state
        m = np.asarray(st.mass[:n])[sel]
        v = np.asarray(st.v[:n])[sel]
        rr = np.asarray(st.r[:n])[sel]
        ff = np.asarray(st.f[:n])[sel]
        pe = np.asarray(st.pe[:n])[sel]
        ke = 0.5 * m * (v * v).sum(1)
        s = self.state["sums"]
        s[0] += float(sim.ss.time)
        s[1] += 1
        s[2] += sel.sum()
        s[3] += (ke + pe).sum()
        s[4] += ke.sum()
        s[5] += pe.sum()
        s[6:9] += rr.sum(0)
        s[9:12] += v.sum(0)
        s[12:15] += ff.sum(0)
        self.state["nsamples"] += 1

    def output(self, sim, run_dir="."):
        if self.state["nsamples"] == 0:
            return
        ns = self.state["nsamples"]
        s = self.state["sums"] / ns
        nparticles = max(s[2], 1.0)
        conv = {"time": U.TIME_TO_FS, "nSamples": 1.0, "nParticles": 1.0,
                "Etotal": 1.0 / U.unit_scale("eV"),
                "Ekinetic": 1.0 / U.unit_scale("eV"),
                "Epotential": 1.0 / U.unit_scale("eV"),
                "Rx": U.LENGTH_TO_ANG, "Ry": U.LENGTH_TO_ANG,
                "Rz": U.LENGTH_TO_ANG}
        vals = []
        for f in self.fields:
            i = self.FIELDS.index(f)
            x = s[i]
            if f == "nSamples":
                x = ns
            elif f in ("Rx", "Ry", "Rz", "Vx", "Vy", "Vz",
                       "Fx", "Fy", "Fz"):
                x = x / nparticles
            vals.append(x * conv.get(f, 1.0))
        path = os.path.join(run_dir, self.filename)
        new = not os.path.exists(path)
        with open(path, "a") as fh:
            if new:
                fh.write("# " + " ".join(self.fields) + "\n")
            fh.write(" ".join("%16.8g" % v for v in vals) + "\n")
        self._clear()


REGISTRY = {
    "COARSEGRAIN": CoarseGrain,
    "DSF": Dsf,
    "CENTROSYM": Centrosym,
    "ACKLAND_JONES": AcklandJones,
    "ACKLANDJONES": AcklandJones,
    "PAIRCORRELATION": PairCorrelation,
    "VCMWRITE": VcmWrite,
    "KINETICENERGYDISTN": KineticEnergyDistn,
    "ZDENSITY": ZDensity,
    "SSF": Ssf,
    "VELOCITYAUTOCORRELATION": VelocityAutocorrelation,
    "SUBSETWRITE": SubsetWrite,
    "STRESSWRITE": StressWrite,
    "FORCEAVERAGE": ForceAverage,
    "QUATERNION": Quaternion,
    "PAIRANALYSIS": PairAnalysis,
    "CHOLANALYSIS": CholAnalysis,
    "DATASUBSET": DataSubset,
}


def build_analysis(name: str, obj: DeckObject) -> Analysis:
    atype = obj.get_str("type").upper()
    cls = REGISTRY.get(atype)
    if cls is None:
        raise DeckError(f"ANALYSIS type {atype} not implemented "
                        f"(have: {sorted(REGISTRY)})")
    a = cls(name=name, obj=obj,
            eval_rate=obj.get_int("eval_rate", obj.get_int("evalrate", 1)),
            output_rate=obj.get_int("outputrate", 1000))
    a.setup()
    return a
