"""APRI curved-voxel quantization + dense voxel statistics.

Vectorized replacement of `SSC::makeApriVec` (src/ssc.cpp:155-195) and
`SSC::makeHashCloud` (src/ssc.cpp:253-289): the per-point loop becomes fully
vectorized trig + integer quantization, and the `unordered_map<int, Voxel>`
becomes a dense flat grid filled by segment-sum scatters.

Deliberate divergences from reference bugs (SURVEY.md section 7.3):
  * indices are clipped into [0, n-1] (the reference's
    `ceil((v-min)/res)-1` yields -1 exactly at the lower bound and its
    overflow check `voxel_idx > bin_num` is off by one, src/ssc.cpp:189);
  * voxel centers use true bin centers (the reference's `(2i+1)/2` is C++
    integer division == i, so its "centers" sit on lower bin corners,
    src/ssc.cpp:271-273).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from ..config import GridConfig
from ..types import VoxelGrid
from . import geometry


def quantize(xyz: jnp.ndarray, valid: jnp.ndarray, grid: GridConfig
             ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Per-point curved-voxel coordinates.

    Returns (idx3 [N,3] int32 as (azimuth, range, sector), flat voxel id [N]
    int32 with -1 for out-of-FOV/invalid, in_fov [N] bool).

    Reference formulas: src/ssc.cpp:158-188 (range/angle/azimuth + ceil
    quantization + azimuth-major flat id).
    """
    dis = geometry.range2d(xyz)
    angle = geometry.polar_angle_deg(xyz)
    azim = geometry.azimuth_deg(xyz)

    in_fov = (
        valid
        & (dis >= grid.min_dis) & (dis <= grid.max_dis)
        & (angle >= grid.min_angle) & (angle <= grid.max_angle)
        & (azim >= grid.min_azimuth) & (azim <= grid.max_azimuth)
    )

    def _idx(v, lo, res, n):
        i = jnp.ceil((v - lo) / res).astype(jnp.int32) - 1
        return jnp.clip(i, 0, n - 1)

    r_idx = _idx(dis, grid.min_dis, grid.range_res, grid.range_num)
    s_idx = _idx(angle, grid.min_angle, grid.sector_res, grid.sector_num)
    a_idx = _idx(azim, grid.min_azimuth, grid.azimuth_res, grid.azimuth_num)

    flat = (a_idx * grid.range_num * grid.sector_num
            + r_idx * grid.sector_num + s_idx)
    flat = jnp.where(in_fov, flat, -1)
    idx3 = jnp.stack([a_idx, r_idx, s_idx], axis=-1)
    return idx3, flat, in_fov


def voxel_stats(flat_voxel: jnp.ndarray, intensity: jnp.ndarray,
                in_fov: jnp.ndarray, grid: GridConfig) -> VoxelGrid:
    """Scatter per-point intensities into dense per-voxel count/mean/var.

    Replaces the hash-map insert loop + second normalization pass of
    makeHashCloud (src/ssc.cpp:253-289). Variance matches the reference's
    population variance sum((x-mean)^2)/n, computed as E[x^2]-mean^2.
    """
    g = grid.bin_num
    seg = jnp.where(in_fov, flat_voxel, g)  # overflow bucket for invalid
    ones = in_fov.astype(jnp.float32)
    count = jax.ops.segment_sum(ones, seg, num_segments=g + 1)[:g]
    s1 = jax.ops.segment_sum(jnp.where(in_fov, intensity, 0.0), seg,
                             num_segments=g + 1)[:g]
    s2 = jax.ops.segment_sum(jnp.where(in_fov, intensity ** 2, 0.0), seg,
                             num_segments=g + 1)[:g]
    safe_n = jnp.maximum(count, 1.0)
    mean = s1 / safe_n
    var = jnp.maximum(s2 / safe_n - mean ** 2, 0.0)
    return VoxelGrid(count=count.astype(jnp.int32),
                     intensity_mean=mean, intensity_var=var)


def voxel_stats_moments(flat_voxel: jnp.ndarray, xyz: jnp.ndarray,
                        intensity: jnp.ndarray, in_fov: jnp.ndarray,
                        grid: GridConfig
                        ) -> Tuple[VoxelGrid, jnp.ndarray]:
    """voxel_stats PLUS per-voxel xyz first/second moment sums, all in ONE
    wide [N,12] segment-sum.

    One 12-column scatter replaces the 3 narrow voxel_stats scatters AND
    the 10 narrow planarity-moment scatters the recognition stage used to
    pay separately (reference: makeHashCloud's per-voxel stats,
    src/ssc.cpp:282-288, + the region-growing normals it feeds to RPC,
    src/ssc.cpp:806-814). A scatter's fixed cost dominated on the
    previous accelerator; on the H100 it is queued for measurement.

    Returns (VoxelGrid, moments [G, 9]) with moment columns
    (sx, sy, sz, sxx, syy, szz, sxy, sxz, syz) - raw SUMS (not centred);
    consumers divide by count (recognition.voxel_planarity_from_moments).
    """
    g = grid.bin_num
    seg = jnp.where(in_fov, flat_voxel, g)
    ones = in_fov.astype(jnp.float32)
    x, y, z = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    cols = jnp.stack([
        jnp.ones_like(x), intensity, intensity ** 2,
        x, y, z, x * x, y * y, z * z, x * y, x * z, y * z,
    ], axis=-1) * ones[:, None]
    s = jax.ops.segment_sum(cols, seg, num_segments=g + 1)[:g]  # [G,12]
    count = s[:, 0]
    safe_n = jnp.maximum(count, 1.0)
    mean = s[:, 1] / safe_n
    var = jnp.maximum(s[:, 2] / safe_n - mean ** 2, 0.0)
    vg = VoxelGrid(count=count.astype(jnp.int32),
                   intensity_mean=mean, intensity_var=var)
    return vg, s[:, 3:]


def voxel_centers(grid: GridConfig) -> jnp.ndarray:
    """[G,3] analytic voxel centers x=r cos(s), y=r sin(s), z=r tan(a).

    Reference: src/ssc.cpp:271-276 (with the integer-division and
    unit-mix quirks fixed, see module docstring).
    """
    A, R, S = grid.shape
    a = jnp.arange(A, dtype=jnp.float32)
    r = jnp.arange(R, dtype=jnp.float32)
    s = jnp.arange(S, dtype=jnp.float32)
    range_c = (r + 0.5) * grid.range_res + grid.min_dis
    sector_c = ((s + 0.5) * grid.sector_res + grid.min_angle) * geometry.DEG2RAD
    azim_c = ((a + 0.5) * grid.azimuth_res + grid.min_azimuth) * geometry.DEG2RAD
    rc = range_c[None, :, None]
    sc = sector_c[None, None, :]
    ac = azim_c[:, None, None]
    x = rc * jnp.cos(sc) + 0.0 * ac
    y = rc * jnp.sin(sc) + 0.0 * ac
    z = rc * jnp.tan(ac) + 0.0 * sc
    return jnp.stack([x, y, z], axis=-1).reshape(grid.bin_num, 3)


def voxel_downsample(xyz: jnp.ndarray, valid: jnp.ndarray, leaf: float,
                     bound: float = 200.0) -> jnp.ndarray:
    """Cartesian voxel-grid downsample mask: keeps the first valid point per
    occupied leaf (deterministic by point order).

    Functional replacement for pcl::VoxelGrid used at scan load
    (src/ssc.cpp:1108-1121). The reference emits leaf centroids; keeping a
    representative point instead preserves exact point identities, which the
    evaluation chain needs. Returns a [N] bool keep-mask.
    """
    n = xyz.shape[0]
    dim = int(2.0 * bound / leaf)
    ijk = jnp.clip(((xyz + bound) / leaf).astype(jnp.int32), 0, dim - 1)
    # invalid points sort last (and are never kept)
    ijk = jnp.where(valid[:, None], ijk, dim)
    # lexicographic grouping via three stable sorts (dim**3 exceeds int32,
    # and x64 is disabled, so no single scalar key exists)
    order = jnp.argsort(ijk[:, 2], stable=True)
    order = order[jnp.argsort(ijk[order, 1], stable=True)]
    order = order[jnp.argsort(ijk[order, 0], stable=True)]
    s = ijk[order]
    first = jnp.concatenate([
        jnp.ones((1,), bool), jnp.any(s[1:] != s[:-1], axis=1)])
    keep_sorted = first & (s[:, 0] != dim)
    keep = jnp.zeros((n,), bool).at[order].set(keep_sorted)
    return keep
