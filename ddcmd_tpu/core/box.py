"""Simulation box: h-matrix, periodic wrap, minimum image.

Replacement for the reference's box.c / preduce.c
(/root/reference/src/box.c:50-513, /root/reference/src/preduce.c:42-45).
Coordinates follow the reference convention: particles live in the box
*centered on the origin*, components in [-L/2, L/2) for an orthorhombic
box; `back_in_box` re-centers with a round(), `min_image` reduces a
displacement to the nearest image.  General (triclinic) boxes go through
reduced coordinates s = r @ hinv.

The h matrix holds lattice vectors as columns (reference three_algebra
convention); for the orthorhombic boxes used by every working example it
is diagonal, and we fast-path that.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
from ..utils import pytree as struct


def inv3x3(h):
    """Analytic 3x3 inverse (adjugate/det).

    The closed form is cheaper than jnp.linalg.inv's LU path, batches
    without a solver call, and is dtype-agnostic."""
    a, b, c = h[:, 0], h[:, 1], h[:, 2]
    cbc = jnp.cross(b, c)
    cca = jnp.cross(c, a)
    cab = jnp.cross(a, b)
    det = jnp.dot(a, cbc)
    return jnp.stack([cbc, cca, cab], axis=0) / det


@struct.dataclass
class Box:
    h: jnp.ndarray  # (3,3) lattice vectors as columns, internal length units
    pbc: int = struct.field(pytree_node=False, default=7)  # bit i => axis i periodic
    # static: barostat scaling preserves orthorhombic-ness, so this is a
    # construction-time property, never derived from the (possibly traced) h
    ortho: bool = struct.field(pytree_node=False, default=True)

    # -- static helpers -----------------------------------------------------

    @classmethod
    def orthorhombic(cls, lengths, pbc: int = 7, dtype=jnp.float32) -> "Box":
        L = jnp.asarray(lengths, dtype=dtype)
        return cls(h=jnp.diag(L), pbc=pbc, ortho=True)

    @classmethod
    def from_h(cls, h, pbc: int = 7, dtype=jnp.float32) -> "Box":
        h = np.asarray(h, dtype=np.float64).reshape(3, 3)
        ortho = bool(np.allclose(h, np.diag(np.diagonal(h))))
        return cls(h=jnp.asarray(h, dtype=dtype), pbc=pbc, ortho=ortho)

    # -- derived quantities --------------------------------------------------

    @property
    def lengths(self) -> jnp.ndarray:
        return jnp.diagonal(self.h)

    @property
    def volume(self) -> jnp.ndarray:
        return jnp.abs(jnp.linalg.det(self.h))

    @property
    def is_orthorhombic(self) -> bool:
        return self.ortho

    @property
    def perp_spans(self) -> jnp.ndarray:
        """Per-axis perpendicular spans (= lengths when orthorhombic)."""
        if self.is_orthorhombic:
            return self.lengths
        # span_i = volume / |a_j x a_k|
        a = self.h.T  # rows = lattice vectors
        v = self.volume
        return jnp.stack([
            v / jnp.linalg.norm(jnp.cross(a[1], a[2])),
            v / jnp.linalg.norm(jnp.cross(a[2], a[0])),
            v / jnp.linalg.norm(jnp.cross(a[0], a[1])),
        ])

    @property
    def minspan(self) -> jnp.ndarray:
        """Smallest perpendicular span (reference MINSPAN, box.c)."""
        return jnp.min(self.perp_spans)

    @property
    def pbc_mask(self) -> jnp.ndarray:
        return jnp.asarray([(self.pbc >> i) & 1 for i in range(3)], dtype=self.h.dtype)

    # -- wrap / image --------------------------------------------------------

    def back_in_box(self, r: jnp.ndarray) -> jnp.ndarray:
        """Wrap positions into the origin-centered box (backInBox_fast)."""
        L = self.lengths
        mask = self.pbc_mask
        if self.is_orthorhombic:
            return r - L * jnp.round(r / L) * mask
        hinv = inv3x3(self.h)
        s = r @ hinv.T
        s = s - jnp.round(s) * mask
        return s @ self.h.T

    def min_image(self, dr: jnp.ndarray) -> jnp.ndarray:
        """Minimum-image reduction of displacement(s) (nearestImage)."""
        return self.back_in_box(dr)

    def scale(self, lam: jnp.ndarray) -> "Box":
        """h <- diag(lam) @ h (barostat volume change, nglfconstraint.c:64)."""
        lam = jnp.asarray(lam, dtype=self.h.dtype)
        return self.replace(h=lam[:, None] * self.h)
