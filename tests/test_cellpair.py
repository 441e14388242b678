"""Cell-blocked matmul pair engine vs the (N,K) list engine: identical physics."""

import numpy as np
import pytest

import jax.numpy as jnp

from ddcmd_tpu.nbr.celllist import CellGrid, build_neighbor_list
from ddcmd_tpu.ops.cellpair import CellBlockGrid, build_cell_slots, cellpair_eval
from ddcmd_tpu.potentials.martini import martini_nonbond

from tests.test_nbr_martini import make_system


@pytest.mark.parametrize("charged", [False, True])
def test_cellpair_matches_nlist(charged):
    r, q, tidx, sigma, eps, shift, rcut, krf, crf, keR = make_system(
        n=200, L=4.2, seed=7, charged=charged)
    n = len(r)
    L = 4.2
    skin = 0.3
    tables = dict(
        sigma=jnp.asarray(sigma, jnp.float32), eps=jnp.asarray(eps, jnp.float32),
        shift=jnp.asarray(shift, jnp.float32), rcut2=jnp.asarray(rcut ** 2, jnp.float32),
        krf=jnp.asarray(krf, jnp.float32), crf=jnp.asarray(crf, jnp.float32),
        keR=jnp.asarray(keR, jnp.float32))
    rj = jnp.asarray(r, jnp.float32)
    qj = jnp.asarray(q, jnp.float32)
    tj = jnp.asarray(tidx, jnp.int32)
    Lv = jnp.asarray([L] * 3, jnp.float32)
    fmask = jnp.ones(n, jnp.float32)

    # list engine
    grid1 = CellGrid.plan([L] * 3, rcut, skin, n, n)
    nbr, _, ov1 = build_neighbor_list(rj, fmask, Lv, grid1)
    assert not bool(ov1)
    f1, e1, v1, pe1, _ = martini_nonbond(rj, qj, tj, fmask, nbr, Lv, tables)

    # cell-block engine (no RF self term in either call here)
    grid2 = CellBlockGrid.plan([L] * 3, rcut, skin, n)
    perm, ov2 = build_cell_slots(rj, fmask, Lv, grid2)
    assert not bool(ov2)
    f2, e2, v2, pe2 = cellpair_eval(rj, qj, tj, perm, Lv, grid2, tables,
                                    coulomb=charged)
    e_self = -0.5 * float(jnp.sum(qj * qj)) * keR * crf if charged else 0.0

    scale = max(1.0, float(jnp.abs(f1).max()))
    assert float(jnp.abs(f2 - f1).max()) / scale < 2e-5
    assert float(e2) + e_self == pytest.approx(float(e1), rel=2e-5, abs=1e-3)
    assert np.asarray(v2) == pytest.approx(np.asarray(v1), rel=5e-3, abs=0.5)
    assert np.asarray(pe2) + (np.asarray(-0.5 * qj * qj * keR * crf) if charged else 0.0) \
        == pytest.approx(np.asarray(pe1), rel=1e-3, abs=1e-3)


def test_cellpair_overflow_flag():
    # cram particles into one cell: capacity must overflow, not corrupt
    n = 64
    r = np.zeros((n, 3), dtype=np.float32)
    grid = CellBlockGrid.plan([3.0] * 3, 1.0, 0.2, 8)  # planned for 8 particles
    perm, ov = build_cell_slots(jnp.asarray(r), jnp.ones(n, jnp.float32),
                                jnp.asarray([3.0] * 3, jnp.float32), grid)
    assert bool(ov)


def test_cellpair_two_cell_axis_images():
    """Axes with only 2 cells: the -1 and +1 offsets reach the same
    neighbor cell through different periodic images and BOTH must be in
    the stencil (regression: collapsing to (0,1) dropped wrapped-image
    pairs, ~35% energy error on thin boxes)."""
    rng = np.random.default_rng(0)
    L = np.array([3.2, 3.2, 1.5])
    rcut, skin = 0.6, 0.15
    g = np.stack(np.meshgrid(np.arange(8), np.arange(8), np.arange(4),
                             indexing="ij"), -1).reshape(-1, 3)
    r = (g + 0.5) / [8, 8, 4] * L - L / 2 \
        + rng.standard_normal((256, 3)) * 0.02
    n = len(r)
    grid = CellBlockGrid.plan(L, rcut, skin, n)
    assert grid.ncells[2] == 2
    q = rng.uniform(-1, 1, n)
    tables = dict(sigma=jnp.full((1, 1), 0.4), eps=jnp.full((1, 1), 1.0),
                  shift=jnp.zeros((1, 1)), rcut2=jnp.asarray(rcut ** 2),
                  krf=jnp.asarray(0.5 / rcut ** 3),
                  crf=jnp.asarray(1.5 / rcut), keR=jnp.asarray(138.935))
    rj = jnp.asarray(r)
    perm, ov = build_cell_slots(rj, jnp.ones(n), jnp.asarray(L), grid)
    assert not bool(ov)
    f, e, vir, pe = cellpair_eval(rj, jnp.asarray(q),
                                  jnp.zeros(n, jnp.int32), perm,
                                  jnp.asarray(L), grid, tables)
    d = r[:, None, :] - r[None, :, :]
    d -= L * np.round(d / L)
    r2 = (d * d).sum(-1)
    np.fill_diagonal(r2, np.inf)
    m = r2 < rcut ** 2
    ir2 = np.where(m, 1 / r2, 0.0)
    s6 = (0.4 ** 2 * ir2) ** 3
    kqq = 138.935 * q[:, None] * q[None, :]
    ir = np.sqrt(ir2)
    epair = np.where(m, 4 * (s6 * s6 - s6)
                     + kqq * (ir + 0.5 / rcut ** 3 * r2 - 1.5 / rcut), 0.0)
    assert float(e) == pytest.approx(0.5 * epair.sum(), rel=1e-8)
    coef = np.where(m, 24 * (s6 - 2 * s6 * s6) * ir2
                    + kqq * (2 * 0.5 / rcut ** 3 - ir2 * ir), 0.0)
    f_ref = -(coef[:, :, None] * d).sum(1)
    assert np.abs(np.asarray(f) - f_ref).max() < 1e-8


def test_cellblock_half_matches_full():
    """N3L half-stencil XLA engine == full engine (LJ + RF Coulomb)."""
    from ddcmd_tpu.ops.cellpair import (CellBlockGrid, build_cell_slots,
                                        cellpair_eval, cellpair_eval_half,
                                        half_back_map, half_grid)
    from tests.test_nbr_martini import make_system

    for n, L in ((220, 4.2), (500, 5.6), (60, 2.6)):
        r, q, tidx, sigma, eps, shift, rcut, krf, crf, keR = make_system(
            n=n, L=L, seed=31, charged=True)
        tables = dict(
            sigma=jnp.asarray(sigma, jnp.float64),
            eps=jnp.asarray(eps, jnp.float64),
            shift=jnp.asarray(shift, jnp.float64),
            rcut2=jnp.asarray(rcut ** 2, jnp.float64),
            krf=jnp.asarray(krf, jnp.float64),
            crf=jnp.asarray(crf, jnp.float64),
            keR=jnp.asarray(keR, jnp.float64))
        grid = CellBlockGrid.plan([L] * 3, rcut, 0.3, n)
        rj = jnp.asarray(r, jnp.float64)
        qj = jnp.asarray(q, jnp.float64)
        tj = jnp.asarray(tidx, jnp.int32)
        Lv = jnp.asarray([L] * 3, jnp.float64)
        perm, ov = build_cell_slots(rj, jnp.ones(n), Lv, grid)
        assert not bool(ov)
        f1, e1, v1, pe1 = cellpair_eval(rj, qj, tj, perm, Lv, grid, tables)
        hg = half_grid(grid)
        bm = half_back_map(hg)
        f2, e2, v2, pe2 = cellpair_eval_half(rj, qj, tj, perm, Lv, hg,
                                             tables, bm)
        assert float(e2) == pytest.approx(float(e1), rel=1e-11)
        scale = max(1.0, float(jnp.abs(f1).max()))
        assert float(jnp.abs(f2 - f1).max()) / scale < 1e-11
        np.testing.assert_allclose(np.asarray(v2), np.asarray(v1), rtol=1e-9)
        np.testing.assert_allclose(np.asarray(pe2), np.asarray(pe1),
                                   rtol=1e-8, atol=1e-12)


def test_overflow_recapacity_completes(tmp_path):
    """Capacity overflow triggers host recapacity + chunk redo
    (allocPages/checkbounds analog) on the cellblock engine (cell cap)
    and the pallas kernel (neighbor-list width)."""
    import dataclasses

    from ddcmd_tpu.models import lj_fluid, load
    from ddcmd_tpu.run.simulate import Simulation

    lj_fluid(str(tmp_path), n=400)
    small = 8
    for engine in ("cellblock", "pallas"):
        db, base = load(str(tmp_path))
        sim = Simulation(db, base, run_dir=str(tmp_path), engine=engine,
                         interpret=engine == "pallas")
        # sabotage: shrink the capacity so the first build overflows
        if engine == "cellblock":
            assert sim.grid.cap > small
            sim.grid = sim.grid.with_cap(small)
        else:
            assert sim.grid.max_neighbors > small
            sim.grid = dataclasses.replace(sim.grid, max_neighbors=small)
        sim.force_fn = sim._build_force_fn()
        sim._rebuild_step_fn()
        sim._compile()
        sim.first_energy()
        sim.run(10, print_fn=lambda s: None)
        assert np.isfinite(float(sim.ss.energy.eion))
        cap = sim.grid.cap if engine == "cellblock" else sim.grid.max_neighbors
        assert cap > small                  # recapacity actually fired


def test_pallas_recapacity_replans_to_aligned_caps(tmp_path):
    """Pallas overflow recovery stays ON the pallas engine and grows the
    neighbor-list width in whole kernel blocks: every recapacity()
    leaves max_neighbors a multiple of the kernel's BLOCK_NBRS, so no
    list is padded with a ragged tail of sentinel entries.  (No silent
    fall back to an XLA engine: engine choice is explicit.)"""
    from ddcmd_tpu.models import lj_fluid, load
    from ddcmd_tpu.ops.pallas_nlist import BLOCK_NBRS
    from ddcmd_tpu.run.simulate import Simulation

    lj_fluid(str(tmp_path), n=400)
    db, base = load(str(tmp_path))
    sim = Simulation(db, base, run_dir=str(tmp_path), engine="pallas",
                     interpret=True)
    assert sim.engine == "pallas"
    sim.first_energy()
    k0 = sim.grid.max_neighbors
    for _ in range(2):
        sim.recapacity()
        assert sim.engine == "pallas"
        assert sim.grid.max_neighbors % BLOCK_NBRS == 0
    assert sim.grid.max_neighbors > k0
    sim.run(10, print_fn=lambda s: None)
    assert np.isfinite(float(sim.ss.energy.eion))
