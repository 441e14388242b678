"""ddcmd_tpu — classical molecular dynamics in JAX.

A from-scratch re-design of LLNL/ddcMD's capability set
(https://github.com/LLNL/ddcMD) for JAX/XLA with Pallas kernels on
NVIDIA GPUs (CPU for tests):

  * object-deck config compatibility (objects/)
  * fixed-capacity SoA particle state as a pytree (core/)
  * cell-list + padded dense neighbor machinery (nbr/)
  * potentials: PAIR/LJ, MARTINI, CHARMM-covalent forms, EAM, RESTRAINT (potentials/)
  * NGLF-family integrators incl. constraints + Berendsen barostat (integrators/)
  * spatial domain decomposition over jax.sharding.Mesh (parallel/)
  * pio-compatible checkpoint/snapshot I/O (io/)
  * simulate/analysis/transform masters + CLI (run/)
"""

__version__ = "0.1.0"

import jax as _jax

# Every matmul in this package is geometry or physics: positions through
# box transforms (min-image, fractional halos, NPT rescales), constraint
# selection matrices, kinetic stress, the cellblock engine's distance
# blocks.  At default precision XLA:GPU may run float32 matmuls in TF32
# on the tensor cores (10-bit mantissa), which rounds positions --
# enough to flip a periodic image near a boundary or drift constraint
# lengths.  Force full-f32 globally; hot paths that can prove reduced
# precision is safe must opt in explicitly (none currently do).
_jax.config.update("jax_default_matmul_precision", "highest")
