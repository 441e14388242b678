"""Particle state: fixed-capacity SoA pytree.

Replacement for the reference's STATE/COLLECTION
(/root/reference/src/state.h:7-27, /root/reference/src/collection.h:19-35).
The reference stores dynamic-size double arrays and calls resize(); under
XLA every shape is static, so State is a *fixed-capacity* padded pytree:
arrays have capacity `n_pad` rows, the first `n_local` are valid (mask).
"Resize" = re-pad outside jit.

Positions/velocities/forces are (n_pad, 3) in internal units (nm, nm/ps).
gid is the 64-bit global particle id stored as (n_pad, 2) uint32
[lo, hi] so we never require jax x64 (/root/reference/src/gid.h:3-15).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
from ..utils import pytree as struct


def pad_to(n: int, multiple: int = 128) -> int:
    return ((n + multiple - 1) // multiple) * multiple


@struct.dataclass
class State:
    r: jnp.ndarray          # (n_pad, 3) positions
    v: jnp.ndarray          # (n_pad, 3) velocities
    f: jnp.ndarray          # (n_pad, 3) forces (filled by energy eval)
    pe: jnp.ndarray         # (n_pad,) per-particle potential energy
    q: jnp.ndarray          # (n_pad,) charge
    mass: jnp.ndarray       # (n_pad,) mass
    species: jnp.ndarray    # (n_pad,) int32 species index
    group: jnp.ndarray      # (n_pad,) int32 group index
    gid: jnp.ndarray        # (n_pad, 2) uint32 [lo, hi]
    n_local: int = struct.field(pytree_node=False)

    @property
    def n_pad(self) -> int:
        return self.r.shape[0]

    @property
    def mask(self) -> jnp.ndarray:
        return (jnp.arange(self.n_pad) < self.n_local)

    @property
    def fmask(self) -> jnp.ndarray:
        return self.mask.astype(self.r.dtype)

    # ------------------------------------------------------------------

    @classmethod
    def create(cls, r, v, q, mass, species, group, gid, *,
               dtype=jnp.float32, pad_multiple: int = 128) -> "State":
        r = np.asarray(r, dtype=np.float64).reshape(-1, 3)
        n = r.shape[0]
        n_pad = pad_to(max(n, 1), pad_multiple)

        def padf(a, shape_tail=()):
            a = np.asarray(a, dtype=np.float64).reshape((n,) + shape_tail)
            out = np.zeros((n_pad,) + shape_tail, dtype=np.float64)
            out[:n] = a
            return jnp.asarray(out, dtype=dtype)

        def padi(a, fill=0, dt=np.int32):
            a = np.asarray(a, dtype=dt).reshape(n)
            out = np.full(n_pad, fill, dtype=dt)
            out[:n] = a
            return jnp.asarray(out)

        gid64 = np.asarray(gid, dtype=np.uint64).reshape(n)
        gid_pair = np.zeros((n_pad, 2), dtype=np.uint32)
        gid_pair[:n, 0] = (gid64 & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        gid_pair[:n, 1] = (gid64 >> np.uint64(32)).astype(np.uint32)

        # padded slots get unit mass so 1/mass is finite everywhere
        mass_pad = np.ones(n_pad)
        mass_pad[:n] = np.asarray(mass, dtype=np.float64)

        return cls(
            r=padf(r, (3,)),
            v=padf(v, (3,)),
            f=jnp.zeros((n_pad, 3), dtype=dtype),
            pe=jnp.zeros((n_pad,), dtype=dtype),
            q=padf(q),
            mass=jnp.asarray(mass_pad, dtype=dtype),
            species=padi(species),
            group=padi(group),
            gid=jnp.asarray(gid_pair),
            n_local=int(n),
        )

    def gid64(self) -> np.ndarray:
        """Host-side 64-bit gids of the valid rows."""
        g = np.asarray(self.gid[: self.n_local])
        return g[:, 0].astype(np.uint64) | (g[:, 1].astype(np.uint64) << np.uint64(32))
