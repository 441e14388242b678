"""Non-periodic boundaries (pbc < 7): slab/wire/cluster systems.

The reference treats box pbc bits as first-class (preduce.c:42-45,
box.c pbc masks); these tests cover the cell engine's static stencil
allowance masks (ops/cellpair.pbc_allowed), the (N,K) list's dynamic
crossing mask (nbr/celllist.build_neighbor_list pbc=), and a REFLECT-
walled slab deck end-to-end (reflect.c walls + pbc=3)."""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from ddcmd_tpu.nbr.celllist import CellGrid, build_neighbor_list
from ddcmd_tpu.ops.cellpair import (CellBlockGrid, build_cell_slots,
                                    cellpair_eval_half, half_back_map,
                                    half_grid, pbc_allowed)


def _pair_system(L=6.0, dz=0.4):
    """Two particles straddling the z face: interacting only through the
    periodic z image (distance dz through the face, L - dz directly)."""
    r = np.array([[0.1, 0.2, L / 2 - dz / 2 - 1e-3],
                  [0.1, 0.2, -L / 2 + dz / 2 + 1e-3]], np.float64)
    return r, np.array([L, L, L])


def test_pbc_allowed_masks_z_images():
    grid = CellBlockGrid.plan([6.0, 6.0, 6.0], 1.1, 0.3, 2)
    hg = half_grid(grid)
    assert pbc_allowed(hg, 7) is None
    allowed = pbc_allowed(hg, 3)             # x,y periodic; z free
    assert allowed.shape == (hg.ncell, hg.n_stencil)
    # exactly the entries with a z wrap are disallowed
    zwrap = hg.wrap[:, :, 2] != 0
    assert (allowed == ~zwrap).all()
    # and some DO wrap in z on this small grid
    assert zwrap.any()


@pytest.mark.parametrize("pbc,expect_pair", [(7, True), (3, False)])
def test_cellblock_pbc_pair_across_z(pbc, expect_pair):
    rcut, skin = 1.1, 0.3
    r, L = _pair_system()
    grid = half_grid(CellBlockGrid.plan(L, rcut, skin, 2))
    tables = dict(sigma=jnp.ones((1, 1), jnp.float32) * 0.3,
                  eps=jnp.ones((1, 1), jnp.float32),
                  shift=jnp.zeros((1, 1), jnp.float32),
                  rcut2=jnp.asarray(rcut ** 2, jnp.float32))
    rj = jnp.asarray(r, jnp.float32)
    Lv = jnp.asarray(L, jnp.float32)
    perm, ov = build_cell_slots(rj, jnp.ones(2, jnp.float32), Lv, grid)
    assert not bool(ov)
    f, e, vir, pe = cellpair_eval_half(
        rj, jnp.zeros(2, jnp.float32), jnp.zeros(2, jnp.int32), perm, Lv,
        grid, tables, jnp.asarray(half_back_map(grid)), coulomb=False,
        allowed=pbc_allowed(grid, pbc))
    interacting = abs(float(e)) > 1e-8
    assert interacting == expect_pair
    if expect_pair:                      # forces equal+opposite through z
        fz = np.asarray(f)[:, 2]
        assert fz[0] * fz[1] < 0 and abs(fz).min() > 1.0


@pytest.mark.parametrize("pbc,expect_pair", [(7, True), (3, False)])
def test_nlist_pbc_pair_across_z(pbc, expect_pair):
    rcut, skin = 1.1, 0.3
    r, L = _pair_system()
    grid = CellGrid.plan(L, rcut, skin, 2, n_pad=2, max_neighbors=8,
                         density_safety=64.0)
    rj = jnp.asarray(r, jnp.float32)
    nbr, count, ov = build_neighbor_list(
        rj, jnp.ones(2, jnp.float32), jnp.asarray(L, jnp.float32), grid,
        pbc=pbc)
    assert not bool(ov)
    has_pair = int(count[0]) > 0
    assert has_pair == expect_pair


def test_reflect_slab_deck_e2e(tmp_path):
    """pbc=3 LJ slab with REFLECT z-walls: NVE-stable, atoms stay inside
    the walls, and the z faces exert no periodic interaction (reflect.c
    + preduce pbc bits end-to-end)."""
    import tempfile

    from ddcmd_tpu.models import lj_fluid, load
    from ddcmd_tpu.run.simulate import Simulation

    d = tempfile.mkdtemp()
    lj_fluid(d, n=500, T=80.0, dt_fs=3.0, integrator="NVEGLF")
    # retrofit the deck: pbc=3 + a REFLECT wall potential
    deck = open(os.path.join(d, "object.data")).read()
    deck = deck.replace("pbc=7", "pbc=3")
    deck = deck.replace("potential=pot;", "potential=pot walls;")
    deck += "\nwalls POTENTIAL { type=REFLECT; }\n"
    open(os.path.join(d, "object.data"), "w").write(deck)

    db, base = load(d)
    sim = Simulation(db, base, run_dir=str(tmp_path), dtype=jnp.float64,
                     engine="cellblock")
    assert sim.sysdef.box.pbc == 3
    sim.first_energy()
    e0 = float(sim.ss.energy.eion + sim.ss.energy.rk)
    sim.run(150, print_fn=lambda s: None, max_steps_per_dispatch=30)
    n = sim.sysdef.state.n_local
    rz = np.asarray(sim.ss.state.r[:n, 2])
    Lz = float(np.asarray(sim.ss.box.lengths)[2])
    assert np.isfinite(np.asarray(sim.ss.state.r[:n])).all()
    assert rz.max() <= 0.5 * Lz + 1e-6 and rz.min() >= -0.5 * Lz - 1e-6
    e1 = float(sim.ss.energy.eion + sim.ss.energy.rk)
    # NVE with reflective walls conserves energy (reflection preserves
    # |v|); generous f64 drift bound for 150 steps
    assert e1 == pytest.approx(e0, rel=5e-4, abs=5.0)
