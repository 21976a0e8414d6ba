"""RI3 intensity refinement (segmentation.refine_by_intensity) on hand-
built grids: qualifying-edge merges fuse clusters transitively, and
non-qualifying neighbours never merge (reference predicate and fusion:
src/ssc.cpp:571-635; radius shrink: src/ssc.cpp:397-399)."""

import dataclasses

import numpy as np
import jax.numpy as jnp

from dr_using_scv_od_tpu import config
from dr_using_scv_od_tpu.models import segmentation
from dr_using_scv_od_tpu.ops import clustering
from dr_using_scv_od_tpu.types import VoxelGrid


def _cfg(shape3, far_range_frac=1.0):
    """A config whose curved grid has exactly `shape3` = (A, R, S) cells,
    with the reference's RI3 thresholds (search_c 2, cov 1, diff 2)."""
    A, R, S = shape3
    grid = config.GridConfig(min_dis=0.0, max_dis=float(R), range_res=1.0,
                             min_angle=0.0, max_angle=360.0,
                             sector_res=360.0 / S, min_azimuth=0.0,
                             max_azimuth=2.0 * A, azimuth_res=2.0)
    base = config.tiny_test()
    cfg = dataclasses.replace(
        base, grid=grid, seg=dataclasses.replace(
            base.seg, search_c=2, intensity_cov=1.0, intensity_diff=2.0,
            far_range_frac=far_range_frac))
    assert cfg.grid.shape == shape3
    return cfg


def _run(occ, av, var, far_range_frac=1.0):
    cfg = _cfg(occ.shape, far_range_frac)
    roots = clustering.connected_components(jnp.asarray(occ))
    grid = VoxelGrid(count=jnp.asarray(occ.reshape(-1).astype(np.int32)),
                     intensity_mean=jnp.asarray(av.reshape(-1)),
                     intensity_var=jnp.asarray(var.reshape(-1)))
    fused = segmentation.refine_by_intensity(roots, grid, cfg)
    return np.asarray(fused).reshape(occ.shape)


def test_merge_via_qualifying_gap():
    """Two clusters 2 voxels apart in sector with matching intensity stats
    merge; a third far away with the same stats stays separate."""
    shape3 = (4, 8, 32)
    occ = np.zeros(shape3, bool)
    occ[1, 3, 5] = occ[1, 3, 7] = occ[1, 3, 20] = True
    av = np.zeros(shape3, np.float32)
    av[1, 3, 5], av[1, 3, 7], av[1, 3, 20] = 100.0, 101.0, 100.0
    var = np.zeros(shape3, np.float32)
    f = _run(occ, av, var)
    assert f[1, 3, 5] == f[1, 3, 7], "matching intensities must merge"
    assert f[1, 3, 5] != f[1, 3, 20], "distant cluster must not merge"


def test_no_merge_when_variance_bad():
    shape3 = (4, 8, 32)
    occ = np.zeros(shape3, bool)
    occ[1, 3, 5] = occ[1, 3, 7] = True
    av = np.full(shape3, 100.0, np.float32)
    var = np.zeros(shape3, np.float32)
    var[1, 3, 5] = var[1, 3, 7] = 50.0     # both above intensity_cov
    f = _run(occ, av, var)
    assert f[1, 3, 5] != f[1, 3, 7]


def test_no_merge_when_intensity_differs():
    shape3 = (4, 8, 32)
    occ = np.zeros(shape3, bool)
    occ[1, 3, 5] = occ[1, 3, 7] = True
    av = np.zeros(shape3, np.float32)
    av[1, 3, 5], av[1, 3, 7] = 100.0, 150.0   # |diff| > 2
    var = np.zeros(shape3, np.float32)
    f = _run(occ, av, var)
    assert f[1, 3, 5] != f[1, 3, 7]


def test_merged_label_spreads_across_cluster():
    """When one edge merges two clusters, ALL voxels of both take one
    label (whole-cluster fusion, src/ssc.cpp:613-626), even through
    voxels whose own variance disqualifies them."""
    shape3 = (4, 8, 32)
    occ = np.zeros(shape3, bool)
    occ[1, 3, 2:6] = True          # cluster A: s = 2..5
    occ[1, 3, 7:11] = True         # cluster B: s = 7..10, Chebyshev gap 2
    av = np.zeros(shape3, np.float32)
    av[1, 3, 2:6], av[1, 3, 7:11] = 100.0, 101.0
    var = np.zeros(shape3, np.float32)
    var[1, 3, 3] = var[1, 3, 9] = 99.0
    f = _run(occ, av, var)
    labs = set(f[1, 3, 2:6].tolist()) | set(f[1, 3, 7:11].tolist())
    assert len(labs) == 1, f"expected one fused label, got {labs}"


def test_radius_shrink_at_far_range():
    """Beyond far_range_frac * R the neighbourhood shrinks to radius 1:
    a 2-gap merge must NOT happen there."""
    shape3 = (4, 16, 32)
    occ = np.zeros(shape3, bool)
    occ[1, 14, 5] = occ[1, 14, 7] = True      # far range bin
    av = np.full(shape3, 100.0, np.float32)
    var = np.zeros(shape3, np.float32)
    f = _run(occ, av, var, far_range_frac=0.6)
    assert f[1, 14, 5] != f[1, 14, 7]
    # the same pair at near range (radius search_c = 2) does merge
    near = np.zeros(shape3, bool)
    near[1, 2, 5] = near[1, 2, 7] = True
    g = _run(near, av, var, far_range_frac=0.6)
    assert g[1, 2, 5] == g[1, 2, 7]
