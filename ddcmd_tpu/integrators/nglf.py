"""NGLF integrator family: velocity-Verlet/leapfrog with GROUP kicks.

Canonical step (reference nglf, /root/reference/src/nglf.c:67-112):

  1. per-particle GROUP velocityUpdate(FRONT, 0.5 dt)   [half kick]
  2. r += dt v ; backInBox                              [drift]
  3. ddcenergy  (neighbor update + forces)
  4. GROUP velocityUpdate(BACK, 0.5 dt)                 [half kick]
  5. kinetic_terms

The whole step is ONE jitted pure function over the (State, Box)
pytree; the neighbor list is an explicit argument rebuilt at the deck's
`ddc.updateRate` cadence / displacement trigger by the driver
(simulateMaster analog, run/simulate.py).

NGLFCONSTRAINT (without constraint groups) adds the start-of-step
Berendsen-style barostat (changeVolume,
/root/reference/src/nglfconstraint.c:64-85,510-575): semi-anisotropic
lambda = cbrt(1 + (P - P0) beta dt / tau) from the molecular pressure
tensor, h <- lambda h, positions affinely rescaled.  Constraint
projections (per-residue SHAKE/RATTLE-style solves) live in
constraints.py and are applied when the topology has CONSPAIR groups.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import jax
import jax.numpy as jnp
from ..utils import pytree as struct

from ..core.energy import EnergyInfo, kinetic_terms
from ..core.groups import velocity_update
from ..objects import units as U


def _hooks_at(time, box, hook_groups):
    """Advance DOUBLE_MIRROR plane points to the current time
    (doubleMirror_Update, /root/reference/src/doubleMirror.c:51-65:
    point += v*n*dt each half step, wrapped back into the box)."""
    hooks = []
    for p in hook_groups:
        if p.get("style") == "mirror":
            q = dict(p)
            dt_el = time - p.get("t0", 0.0)
            for key, vkey, nkey in (("point1", "v1", "normal1"),
                                    ("point2", "v2", "normal2")):
                pt = jnp.asarray(p[key]) + p[vkey] * jnp.asarray(p[nkey]) * dt_el
                q[key] = box.back_in_box(pt[None, :])[0]
            hooks.append(q)
        else:
            hooks.append(p)
    return tuple(hooks)


@struct.dataclass
class StepState:
    """Everything that evolves across steps (a single pytree)."""

    state: object            # core.state.State
    box: object              # core.box.Box
    energy: EnergyInfo
    loop: jnp.ndarray        # int32
    time: jnp.ndarray        # f32, internal ps
    # NPTGLF barostat friction variable (restart-persisted in the
    # reference, integrator.c:173-175); unused by other integrators
    zeta: jnp.ndarray = struct.field(default_factory=lambda: jnp.zeros(()))
    # NGLFNK per-axis box-length velocities dL/dt (box_get_dhdt diagonal,
    # /root/reference/src/nglfNK.c:53); zeros for every other integrator
    bdot: jnp.ndarray = struct.field(default_factory=lambda: jnp.zeros(3))


def make_nglf_step(force_fn: Callable, default_coeffs, dt: float, *,
                   barostat=None, n_global: int, n_constraints: int = 0,
                   has_berendsen: bool = False,
                   constraint_fn: Callable | None = None,
                   molecular_virial_fn: Callable | None = None,
                   wrap_positions: bool = True,
                   post_drift_fn: Callable | None = None,
                   shear_groups: tuple = (),
                   has_box_time: bool = False):
    """Build the jittable MD step.

    force_fn(state, box, nbr_idx) -> (f (N,3), e_pot, virial (3,3), pe (N,))
    barostat: None or dict(P0=..., beta=..., tau=..., T=..., isotropic=bool)
    constraint_fn(state, dt, mode) -> state with projected velocities
    molecular_virial_fn(state, box, virial) -> corrected molecular virial
    shear_groups: static SHEAR-group parameter dicts
      (GroupTable.shear_groups; shear.c two-slice driver)
    wrap_positions: wrap into the box after drift (backInBox, nglf.c:90).
      MUST be False for the cell-block pair engine, whose static image
      shifts require positions to stay consistent with the rebuild-time
      cell assignment -- the driver wraps at each rebuild instead.
    """

    def step(ss: StepState, nbr_idx, key, coeffs=None,
             box_lam=None) -> StepState:
        state, box = ss.state, ss.box
        half = 0.5 * dt
        if coeffs is None:
            coeffs = default_coeffs

        # --- barostat (nglfconstraint.c:518-527) -------------------------
        if barostat is not None:
            virial = ss.energy.virial
            if molecular_virial_fn is not None:
                virial = molecular_virial_fn(state, box, virial)
            nmol = barostat.get("n_molecules", n_global)
            kT = barostat["T"] * U.kB
            vol = box.volume
            p_tensor = (virial + nmol * kT * jnp.eye(3, dtype=virial.dtype)) / vol
            p_tensor = p_tensor - barostat["P0"] * jnp.eye(3, dtype=virial.dtype)
            btt = barostat["beta"] * dt / barostat["tau"]
            if barostat.get("isotropic"):
                p_iso = jnp.trace(p_tensor) / 3.0
                lam_xyz = jnp.cbrt(1.0 + p_iso * btt) * jnp.ones(3, dtype=virial.dtype)
            else:
                # semi-anisotropic: Pxx=Pyy averaged, Pzz separate
                pxx = 0.5 * (p_tensor[0, 0] + p_tensor[1, 1])
                pzz = p_tensor[2, 2]
                lam = jnp.cbrt(1.0 + jnp.stack([pxx, pxx, pzz]) * btt)
                lam_xyz = lam
            box = box.scale(lam_xyz)
            state = state.replace(r=state.r * lam_xyz[None, :])

        mask = state.mask

        # --- front half kick ---------------------------------------------
        k1, k2 = jax.random.split(jax.random.fold_in(key, 0))
        shear_ctx = ((state.r, box.lengths,
                      _hooks_at(ss.time, box, shear_groups))
                     if shear_groups else None)
        v = velocity_update("front", state.v, state.f, state.mass, state.group,
                            coeffs, half, k1, mask, has_berendsen,
                            shear_ctx=shear_ctx)
        if constraint_fn is not None:
            # live box geometry: the barostat above may have rescaled
            bgeom = box.lengths if box.ortho else box.h
            v = constraint_fn(state.replace(v=v), dt, "front",
                              box_lengths=bgeom).v
        state = state.replace(v=v)

        # --- drift (+ wrap unless the pair engine forbids it) ---------------
        r = state.r + dt * state.v
        # prescribed box(t): h <- h(t+dt), positions affinely rescaled
        # (scalePositionsByBoxChange, /root/reference/src/nglf.c:89)
        if has_box_time and box_lam is not None:
            # generalized update h' = (E * h) @ M (boxPrescriptiveTime.c:
            # 96-145): E carries STRAIN's elementwise exp-integral factors
            # (a diagonal scale is E = lam[:,None]), M carries
            # DEFORMATION_RATE's expm(D dt); positions map affinely by
            # A = h' h^-1 (scalePositionsByBoxChange)
            from ..core.box import inv3x3

            E, M = box_lam
            h_new = (E * box.h) @ M
            A = h_new @ inv3x3(box.h)
            box = box.replace(h=h_new)
            r = r @ A.T
        if wrap_positions:
            r = box.back_in_box(r)
        state = state.replace(r=r)
        if post_drift_fn is not None:      # e.g. REFLECT walls (reflect.c:41)
            state = post_drift_fn(state, box)

        # --- forces ---------------------------------------------------------
        f, e_pot, virial, pe = force_fn(state, box, nbr_idx)
        state = state.replace(f=f, pe=pe)

        # --- back half kick -------------------------------------------------
        shear_ctx = ((state.r, box.lengths,
                      _hooks_at(ss.time + dt, box, shear_groups))
                     if shear_groups else None)
        v = velocity_update("back", state.v, state.f, state.mass, state.group,
                            coeffs, half, k2, mask, has_berendsen,
                            shear_ctx=shear_ctx)
        if constraint_fn is not None:
            v = constraint_fn(state.replace(v=v), dt, "back",
                              box_lengths=box.lengths if box.ortho
                              else box.h).v
        state = state.replace(v=v)

        # --- accounting ------------------------------------------------------
        rk, tion = kinetic_terms(state.v, state.mass, state.fmask)
        energy = EnergyInfo(eion=e_pot, rk=rk, virial=virial, tion=tion,
                            number=jnp.sum(state.fmask))
        return StepState(state=state, box=box, energy=energy,
                         loop=ss.loop + 1, time=ss.time + dt, zeta=ss.zeta)

    return step


def first_energy_call(ss: StepState, force_fn, nbr_idx) -> StepState:
    """firstEnergyCall analog (/root/reference/src/masters.c:579-612)."""
    f, e_pot, virial, pe = force_fn(ss.state, ss.box, nbr_idx)
    state = ss.state.replace(f=f, pe=pe)
    rk, tion = kinetic_terms(state.v, state.mass, state.fmask)
    energy = EnergyInfo(eion=e_pot, rk=rk, virial=virial, tion=tion,
                        number=jnp.sum(state.fmask))
    return StepState(state=state, box=ss.box, energy=energy, loop=ss.loop,
                     time=ss.time, zeta=ss.zeta)
