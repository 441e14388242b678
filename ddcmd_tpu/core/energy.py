"""Energy/virial/temperature accounting (ETYPE equivalent).

Reference: kinetic_terms (/root/reference/src/energy.c:48-160) and
eval_energyInfo (/root/reference/src/energyInfo.c:75-160).  Everything
here is pure-functional on the State pytree; global scalars come out of
masked reductions (psum across a device mesh happens one level up).
"""

from __future__ import annotations

import jax.numpy as jnp
from ..utils import pytree as struct

from ..objects import units as U


@struct.dataclass
class EnergyInfo:
    """Global (per-step) energy accounting; virials are 3x3 symmetric."""

    eion: jnp.ndarray       # potential energy (kJ/mol), summed
    rk: jnp.ndarray         # kinetic energy
    virial: jnp.ndarray     # (3,3) configurational virial: sum f_ij (x) r_ij
    tion: jnp.ndarray       # (3,3) kinetic tensor: sum m v (x) v
    number: jnp.ndarray     # particle count (float)

    @classmethod
    def zero(cls, dtype=jnp.float32) -> "EnergyInfo":
        z = jnp.zeros((), dtype=dtype)
        z33 = jnp.zeros((3, 3), dtype=dtype)
        return cls(eion=z, rk=z, virial=z33, tion=z33, number=z)

    # -- derived -------------------------------------------------------------

    def temperature(self, n_global, n_constraints=0):
        """2K / ((3N - nCons) kB)  -> Kelvin (energyInfo.c:119)."""
        dof = 3.0 * n_global - n_constraints
        return 2.0 * self.rk / (dof * U.kB)

    def stress(self, volume):
        """sion = -(virial + tion)/V (energyInfo.c:104-117)."""
        return -(self.virial + self.tion) / volume

    def pressure(self, volume):
        """pion = -tr(sion)/3 = (tr(virial) + 2K_tensor)/3V."""
        return jnp.trace(self.virial + self.tion) / (3.0 * volume)


def kinetic_terms(v, mass, fmask):
    """Masked kinetic energy + kinetic tensor (energy.c:48).

    Returns (rk, tion) where tion[a,b] = sum_i m_i v_ia v_ib.
    """
    mv = (mass * fmask)[:, None] * v          # (N,3)
    tion = mv.T @ v                            # (3,3) as one matmul
    rk = 0.5 * jnp.trace(tion)
    return rk, tion
