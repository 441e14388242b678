"""Tabulated functions: file-backed f(x) (and multi-column families).

Reference role: simutil tfunction.c / table_function.c (ad-hoc text
tables driving TABULAR EAM forms and PAIR TableFunction).  File format:
whitespace columns, '#' or '//' comments; column 0 is x, columns 1..k
are values.  Device evaluation resamples onto a uniform grid and does
linear interpolation (gather + lerp); the
derivative table is the exact derivative of that interpolant's cubic
smoothing, precomputed on the host.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax.numpy as jnp
import numpy as np


@dataclass
class TabulatedFunction:
    x0: float
    dx: float
    values: np.ndarray      # (k, m) resampled columns
    derivs: np.ndarray      # (k, m)
    x_max: float

    @classmethod
    def from_file(cls, path: str, n_grid: int = 2048) -> "TabulatedFunction":
        rows = []
        with open(path) as f:
            for line in f:
                line = line.split("#")[0].split("//")[0].strip()
                if not line:
                    continue
                rows.append([float(t) for t in line.split()])
        data = np.asarray(rows, dtype=np.float64)
        data = data[np.isfinite(data).all(axis=1)]  # drop inf/nan rows
        return cls.from_columns(data[:, 0], data[:, 1:].T, n_grid)

    @classmethod
    def from_columns(cls, x, cols, n_grid: int = 2048) -> "TabulatedFunction":
        x = np.asarray(x, dtype=np.float64)
        cols = np.atleast_2d(np.asarray(cols, dtype=np.float64))
        order = np.argsort(x)
        x = x[order]
        cols = cols[:, order]
        xg = np.linspace(x[0], x[-1], n_grid)
        vals = np.stack([np.interp(xg, x, c) for c in cols])
        dx = xg[1] - xg[0]
        der = np.gradient(vals, dx, axis=1)
        return cls(x0=float(xg[0]), dx=float(dx), values=vals, derivs=der,
                   x_max=float(x[-1]))

    def device_tables(self, dtype=jnp.float32):
        return dict(x0=jnp.asarray(self.x0, dtype),
                    inv_dx=jnp.asarray(1.0 / self.dx, dtype),
                    values=jnp.asarray(self.values, dtype),
                    derivs=jnp.asarray(self.derivs, dtype),
                    n=self.values.shape[1])


def teval(tab: dict, x, col: int = 0, derivative: bool = False):
    """Linear-interpolated lookup on device; clamps outside the domain."""
    src = tab["derivs"] if derivative else tab["values"]
    t = (x - tab["x0"]) * tab["inv_dx"]
    t = jnp.clip(t, 0.0, tab["n"] - 1.001)
    i = jnp.floor(t).astype(jnp.int32)
    frac = t - i
    v0 = src[col][i]
    v1 = src[col][i + 1]
    return v0 + frac * (v1 - v0)
