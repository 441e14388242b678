"""Pallas (Triton route) neighbor-list pair kernel for NVIDIA GPUs.

Evaluates Martini LJ + reaction-field Coulomb (and plain shifted-LJ
PAIR) over the full (N, K) neighbor list that nbr/celllist.py builds:

  grid = (n_rows / BM,)                one program per BM particle rows
  per program:
    i-side fields <- records[:, rows]  (BM,) contiguous loads
    loop over the list in (BM, BK) chunks:
      j indices <- nbr[rows, chunk]; j fields gathered from the records
      min-image distances, LJ + RF, in-kernel exclusions, all in exact
      f32 elementwise arithmetic (no dot, so TF32 never enters)
      accumulate f_i, pe_i and the virial rows in registers
    store [fx fy fz pe] for its rows and [e, virial6] for the program

Each pair appears in both rows' lists, so there are no atomics: the
result is deterministic, and energy and virial carry a factor 1/2.

Records: (8, n_rec) f32 [x, y, z, q, type, valid, ex6, ex7] with one
trailing all-zero column for the list sentinel; ex6/ex7 are the
in-kernel exclusion channels (run/forces._excl_channels).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

# block shape and warps from the card sweep (PERF.md): BM particle rows
# per program, BK list entries per chunk
BLOCK_ROWS = 16
BLOCK_NBRS = 32
NUM_WARPS = 4


def _min_image(a, b, L, iL):
    """a - b reduced to the nearest image, accurate to float32 rounding
    of the RESULT: the difference of two box-scale coordinates is split
    into s + err exactly (TwoSum), the image shift is subtracted from s
    exactly (|s| >= L/2 whenever it applies, so Sterbenz holds), and the
    small error term is added back last.  Plain a - b - L*k would carry
    the ~1e-7 relative rounding of the box-scale s into every pair that
    crosses the periodic boundary."""
    s = a - b
    bb = s - a
    err = (a - (s - bb)) - (b + bb)
    return (s - L * jnp.floor(s * iL + 0.5)) + err


def _nlist_kernel(nbr_ref, rec_ref, geom_ref, sig_ref, eps_ref, shf_ref,
                  out_ref, row_ref, *, n_rows: int, n_rec: int, K: int,
                  BM: int, BK: int, T: int, coulomb: bool, excl: bool,
                  krf: float, crf: float, keR: float):
    b = pl.program_id(0)
    f32 = jnp.float32
    r0 = pl.multiple_of(b * BM, BM)
    Lx, Ly, Lz = geom_ref[0], geom_ref[1], geom_ref[2]
    iLx, iLy, iLz = geom_ref[3], geom_ref[4], geom_ref[5]
    rcut2 = geom_ref[6]

    def own(k):
        return rec_ref[pl.ds(pl.multiple_of(k * n_rec + r0, BM), BM)][:, None]

    xi, yi, zi, qi = own(0), own(1), own(2), own(3)
    vi = own(5) > 0.0
    if excl:
        mi = own(6)
        bi = jnp.floor(own(7))                    # exclusion bitmask B_i
    if T == 1:
        params = (sig_ref[0], eps_ref[0], shf_ref[0])
    else:
        ti = own(4).astype(jnp.int32) * T
    rows = r0 + jax.lax.broadcasted_iota(jnp.int32, (BM, BK), 0)
    lanes = jax.lax.broadcasted_iota(jnp.int32, (BM, BK), 1)

    def body(kc, carry):
        fx, fy, fz, pe, e, vxx, vyy, vzz, vxy, vxz, vyz = carry
        j = nbr_ref[rows * K + kc * BK + lanes]

        def other(k):
            return rec_ref[k * n_rec + j]

        dx = _min_image(xi, other(0), Lx, iLx)
        dy = _min_image(yi, other(1), Ly, iLy)
        dz = _min_image(zi, other(2), Lz, iLz)
        d2 = dx * dx + dy * dy + dz * dz
        valid = vi & (other(5) > 0.0) & (d2 < rcut2)
        if excl:
            # pair masked when i's exclusion bitmask holds j's bit; the
            # record fraction is 2^-(intra+1), doubled back exactly
            w7 = other(7)
            frac = w7 - jnp.floor(w7)
            t_bit = jnp.floor(bi * (frac + frac))
            bit = t_bit - 2.0 * jnp.floor(t_bit * 0.5)
            valid = valid & ~((mi == other(6)) & (bit > 0.5))
        if T == 1:
            sig, eps, shf = params
        else:
            pidx = ti + other(4).astype(jnp.int32)
            sig, eps, shf = sig_ref[pidx], eps_ref[pidx], shf_ref[pidx]
        w = valid.astype(f32)
        d2s = jnp.where(valid, d2, 1.0)
        ir2 = 1.0 / d2s
        s2 = sig * sig * ir2
        s6 = s2 * s2 * s2
        s12 = s6 * s6
        e_pair = (4.0 * eps * (s12 - s6) + shf) * w
        dvdr = 24.0 * eps * (s6 - 2.0 * s12) * ir2
        if coulomb:
            ir = jax.lax.rsqrt(d2s)
            kqq = keR * qi * other(3)
            e_pair = e_pair + kqq * (ir + krf * d2s - crf) * w
            dvdr = dvdr + kqq * (2.0 * krf - ir2 * ir)
        coef = dvdr * w
        gx = coef * dx
        gy = coef * dy
        gz = coef * dz
        return (fx - jnp.sum(gx, axis=1), fy - jnp.sum(gy, axis=1),
                fz - jnp.sum(gz, axis=1), pe + jnp.sum(e_pair, axis=1),
                e + jnp.sum(e_pair, axis=1),
                vxx - jnp.sum(gx * dx, axis=1), vyy - jnp.sum(gy * dy, axis=1),
                vzz - jnp.sum(gz * dz, axis=1), vxy - jnp.sum(gx * dy, axis=1),
                vxz - jnp.sum(gx * dz, axis=1), vyz - jnp.sum(gy * dz, axis=1))

    zv = jnp.zeros((BM,), f32)
    # int32 bounds: the list index math stays 32-bit under jax_enable_x64
    fx, fy, fz, pe, *scal = jax.lax.fori_loop(
        jnp.int32(0), jnp.int32(K // BK), body, (zv,) * 11)
    for k, v in enumerate((fx, fy, fz, 0.5 * pe)):
        out_ref[pl.ds(pl.multiple_of(k * n_rows + r0, BM), BM)] = v
    lane = jax.lax.broadcasted_iota(jnp.int32, (8,), 0)
    row = jnp.zeros((8,), f32)
    for k, v in enumerate(scal):
        row = jnp.where(lane == k, 0.5 * jnp.sum(v), row)
    row_ref[pl.ds(pl.multiple_of(b * 8, 8), 8)] = row


def make_nlist_kernel(n_rows: int, n_rec: int, K: int, tables, *,
                      coulomb: bool = True, excl: bool = False,
                      interpret: bool = False, block_rows: int = BLOCK_ROWS,
                      block_nbrs: int = BLOCK_NBRS):
    """eval(nbr (n_rows, K) int32, rec (8, n_rec) f32, geom (8,) f32) ->
    (out (4, n_rows) [fx, fy, fz, pe], rows (n_rows/BM, 8) [e, vxx, vyy,
    vzz, vxy, vxz, vyz, 0]).  n_rows must be a multiple of block_rows
    and K of block_nbrs; list entries index record columns (the sentinel
    points at an all-zero column).  geom = [L (3), 1/L (3), rcut^2, 0].
    interpret=True runs on the CPU (tests only)."""
    if n_rows % block_rows or K % block_nbrs:
        raise ValueError(f"n_rows={n_rows} / K={K} not multiples of the "
                         f"({block_rows}, {block_nbrs}) block")
    T = int(tables["sigma"].shape[0])
    n_blk = n_rows // block_rows
    kernel = functools.partial(
        _nlist_kernel, n_rows=n_rows, n_rec=n_rec, K=K, BM=block_rows,
        BK=block_nbrs, T=T, coulomb=coulomb, excl=excl,
        krf=float(tables.get("krf", 0.0)), crf=float(tables.get("crf", 0.0)),
        keR=float(tables.get("keR", 0.0)))
    call = pl.pallas_call(
        kernel,
        grid=(n_blk,),
        out_shape=[jax.ShapeDtypeStruct((4 * n_rows,), jnp.float32),
                   jax.ShapeDtypeStruct((8 * n_blk,), jnp.float32)],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name="pair_nlist",
    )
    sig = jnp.asarray(tables["sigma"], jnp.float32).reshape(-1)
    eps = jnp.asarray(tables["eps"], jnp.float32).reshape(-1)
    shf = jnp.asarray(tables["shift"], jnp.float32).reshape(-1)

    def eval_fn(nbr, rec, geom):
        out, rows = call(nbr.reshape(-1).astype(jnp.int32), rec.reshape(-1),
                         geom.astype(jnp.float32), sig, eps, shf)
        return out.reshape(4, n_rows), rows.reshape(n_blk, 8)

    return eval_fn


def pack_records(r, q, tidx, valid, excl_vals=None):
    """(8, n + 1) f32 records [x, y, z, q, type, valid, ex6, ex7]; the last
    column (the list sentinel's) is all zero."""
    n = r.shape[0]
    f32 = jnp.float32
    ex = (jnp.zeros((n, 2), f32) if excl_vals is None
          else excl_vals.astype(f32))
    rec = jnp.concatenate([
        r.astype(f32).T, q.astype(f32)[None], tidx.astype(f32)[None],
        valid.astype(f32)[None], ex.T], axis=0)
    return jnp.pad(rec, ((0, 0), (0, 1)))


def nlist_geom(box_lengths, rcut2):
    L = jnp.asarray(box_lengths, jnp.float32)
    return jnp.concatenate([L, 1.0 / L,
                            jnp.asarray([rcut2, 0.0], jnp.float32)])


def nlist_pair_eval(r, q, tidx, fmask, nbr_idx, box_lengths, tables, *,
                    coulomb: bool = True, excl_vals=None,
                    interpret: bool = False):
    """(f, e, virial, pe) of the pair term over the full (N, K) list
    nbr_idx (sentinel N) -- the kernel form of potentials.martini.
    martini_nonbond without the RF self-energy.  Rows past N and list
    columns past K are padded to the kernel's blocks."""
    n_pad, K = nbr_idx.shape
    n_rows = -(-n_pad // BLOCK_ROWS) * BLOCK_ROWS
    k_pad = -(-K // BLOCK_NBRS) * BLOCK_NBRS
    eval_fn = make_nlist_kernel(n_rows, n_pad + 1, k_pad, tables,
                                coulomb=coulomb,
                                excl=excl_vals is not None,
                                interpret=interpret)
    rec = pack_records(r, q, tidx, fmask > 0, excl_vals)
    nbr = jnp.pad(nbr_idx, ((0, n_rows - n_pad), (0, k_pad - K)),
                  constant_values=n_pad)
    out, rows = eval_fn(nbr, rec, nlist_geom(box_lengths, tables["rcut2"]))
    v = jnp.sum(rows[:, 1:7], axis=0)
    virial = jnp.asarray([[v[0], v[3], v[4]],
                          [v[3], v[1], v[5]],
                          [v[4], v[5], v[2]]])
    return out[:3, :n_pad].T, jnp.sum(rows[:, 0]), virial, out[3, :n_pad]
