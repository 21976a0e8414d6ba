"""Voxelized GICP registration (scan-to-scan and scan-to-map).

NEW capability: the reference never estimates motion - it consumes
ground-truth KITTI poses (src/ssc.cpp:913-995) and its `gicp.cpp` tool
contains no ICP at all (SURVEY.md section 2.2). This module supplies the
odometry the north star requires, designed for accelerators in the spirit
of VGICP (Koide et al.) rather than as a PCL port:

  * the target scan/map becomes per-voxel Gaussians on a bounded Cartesian
    grid - means/covariances via scalar segment-sums (one pass, no kd-tree);
  * covariances are regularised to plane-like ellipsoids; the GICP weight
    W = (C_reg + delta I)^-1 comes from a closed-form Sherman-Morrison
    identity (C_reg = lam_max (I - (1-eps) n n^T) needs only the dominant
    eigenvalue and the plane normal - no 3x3 inverse, no eigenvector
    basis);
  * correspondence is O(1): a source point looks up the voxel it lands in
    (plus nothing else - VGICP's single-voxel variant);
  * Gauss-Newton runs as OUTER correspondence passes (voxel lookup +
    target gathers) around INNER relinearised steps that reuse the frozen
    correspondences - the expensive gathers amortise over several updates.

Layout: everything is STRUCTURE-OF-ARRAYS - [G] / [N] scalar planes,
never [N,3,3] / [G,3,3] stacks, so every op is a long contiguous
elementwise pass (the stacked layout padded badly on the previous
accelerator; the SoA form is also the natural coalesced layout for a
GPU).

All loops are `lax.while_loop`/`fori_loop` with static caps; every tensor
is fixed shape.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import GicpConfig
from ..ops import geometry


class VoxelMap(NamedTuple):
    """Running Gaussian statistics per Cartesian voxel (sums, so maps merge
    by addition - the basis for incremental scan-to-map odometry and the
    distributed keyframe-block map). SoA layout: component-major so the
    [G] axis is the long contiguous one."""
    n: jnp.ndarray      # [G]
    sum_x: jnp.ndarray  # [3,G]
    sum_xx: jnp.ndarray  # [6,G]  (xx,yy,zz,xy,xz,yz)
    n_oob: jnp.ndarray  # scalar int32 - valid points outside the grid
    #                     bounds (cfg.xy_extent / z_min / z_max); counted,
    #                     never silently dropped

    def merge(self, other: "VoxelMap") -> "VoxelMap":
        return VoxelMap(self.n + other.n, self.sum_x + other.sum_x,
                        self.sum_xx + other.sum_xx,
                        self.n_oob + other.n_oob)


class GicpTarget(NamedTuple):
    """Finalized per-voxel Gaussians with precomputed GICP weights
    (component-major SoA: mean [3,G], weight [6,G] packed symmetric
    (w00,w11,w22,w01,w02,w12))."""
    mean: jnp.ndarray    # [3,G]
    weight: jnp.ndarray  # [6,G]
    valid: jnp.ndarray   # [G] bool


class GicpResult(NamedTuple):
    T: jnp.ndarray          # [4,4] target_T_source
    n_iters: jnp.ndarray    # int32 (outer correspondence passes)
    final_error: jnp.ndarray  # mean Mahalanobis cost (weighted)
    n_corr: jnp.ndarray     # int32 correspondences at convergence
    rmse: jnp.ndarray       # Euclidean RMS residual of inliers (metres)
    n_oob: jnp.ndarray      # int32 valid source points outside the grid
    #                         bounds at the final iterate


def _grid_dims(cfg: GicpConfig):
    nxy = int(2 * cfg.xy_extent / cfg.voxel_size)
    nz = int((cfg.z_max - cfg.z_min) / cfg.voxel_size)
    return nxy, nz


def _voxel_index_s(x, y, z, valid, cfg: GicpConfig):
    """Flat Cartesian voxel id from scalar coordinate planes."""
    nxy, nz = _grid_dims(cfg)
    ix = jnp.floor((x + cfg.xy_extent) / cfg.voxel_size).astype(jnp.int32)
    iy = jnp.floor((y + cfg.xy_extent) / cfg.voxel_size).astype(jnp.int32)
    iz = jnp.floor((z - cfg.z_min) / cfg.voxel_size).astype(jnp.int32)
    ok = (valid & (ix >= 0) & (ix < nxy) & (iy >= 0) & (iy < nxy)
          & (iz >= 0) & (iz < nz))
    flat = (ix * nxy + iy) * nz + iz
    return jnp.where(ok, flat, -1), ok


def voxel_index(xyz: jnp.ndarray, valid: jnp.ndarray, cfg: GicpConfig):
    """Flat Cartesian voxel id; -1 for out-of-bound/invalid."""
    return _voxel_index_s(xyz[:, 0], xyz[:, 1], xyz[:, 2], valid, cfg)


def build_voxel_map(xyz: jnp.ndarray, valid: jnp.ndarray,
                    cfg: GicpConfig) -> VoxelMap:
    """Accumulate Gaussian sums per voxel in ONE wide [N,10] segment-sum.

    One 10-column scatter replaces ten narrow per-moment scatters (a
    scatter's fixed cost dominated on the previous accelerator; queued
    for measurement on the H100). The wide [G,10] result transposes to the
    component-major SoA planes the registration math wants."""
    nxy, nz = _grid_dims(cfg)
    g = nxy * nxy * nz
    flat, ok = voxel_index(xyz, valid, cfg)
    seg = jnp.where(ok, flat, g)

    x, y, z = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    cols = jnp.stack([jnp.ones_like(x), x, y, z,
                      x * x, y * y, z * z, x * y, x * z, y * z],
                     axis=-1) * ok.astype(xyz.dtype)[:, None]
    s = jax.ops.segment_sum(cols, seg, num_segments=g + 1)[:g].T  # [10,G]
    n_oob = jnp.sum(valid & ~ok).astype(jnp.int32)
    return VoxelMap(n=s[0], sum_x=s[1:4], sum_xx=s[4:10], n_oob=n_oob)


def _eig3_lo_hi(c00, c01, c02, c11, c12, c22):
    """Smallest/largest eigenvalues of symmetric 3x3 batches given as six
    [G] scalar planes (Smith's trigonometric closed form, SoA layout)."""
    q = (c00 + c11 + c22) / 3.0
    b00, b11, b22 = c00 - q, c11 - q, c22 - q
    p2 = (b00 ** 2 + b11 ** 2 + b22 ** 2
          + 2.0 * (c01 ** 2 + c02 ** 2 + c12 ** 2))
    iso = p2 <= 1e-18
    p = jnp.sqrt(jnp.where(iso, 1.0, p2 / 6.0))
    detB = (b00 * (b11 * b22 - c12 ** 2)
            - c01 * (c01 * b22 - c12 * c02)
            + c02 * (c01 * c12 - b11 * c02))
    r = jnp.clip(detB / (2.0 * p ** 3), -1.0, 1.0)
    phi = jnp.arccos(r) / 3.0
    e_hi = jnp.where(iso, q, q + 2.0 * p * jnp.cos(phi))
    e_lo = jnp.where(iso, q, q + 2.0 * p * jnp.cos(phi + 2.0 * jnp.pi / 3.0))
    return e_lo, e_hi


def _normal_from_cov(c00, c01, c02, c11, c12, c22, lam):
    """Unit eigenvector for eigenvalue `lam` (the plane normal when lam is
    the smallest eigenvalue), scalar planes in, scalar planes out.
    Returns (vx, vy, vz, ok): `ok` is False where all three row
    cross-products vanish (exactly rank-1 / isotropic covariance - e.g. a
    collinear pole). Callers must zero such voxels' weights: any fallback
    direction (the +z this returns) can be parallel to the point line and
    would over-penalize the high-variance direction."""
    r0x, r0y, r0z = c00 - lam, c01, c02
    r1x, r1y, r1z = c01, c11 - lam, c12
    r2x, r2y, r2z = c02, c12, c22 - lam

    def cross(ax, ay, az, bx, by, bz):
        return ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx

    ax01, ay01, az01 = cross(r0x, r0y, r0z, r1x, r1y, r1z)
    ax02, ay02, az02 = cross(r0x, r0y, r0z, r2x, r2y, r2z)
    ax12, ay12, az12 = cross(r1x, r1y, r1z, r2x, r2y, r2z)
    n01 = ax01 ** 2 + ay01 ** 2 + az01 ** 2
    n02 = ax02 ** 2 + ay02 ** 2 + az02 ** 2
    n12 = ax12 ** 2 + ay12 ** 2 + az12 ** 2

    use02 = n02 > n01
    bx = jnp.where(use02, ax02, ax01)
    by = jnp.where(use02, ay02, ay01)
    bz = jnp.where(use02, az02, az01)
    bn = jnp.maximum(n01, n02)
    use12 = n12 > bn
    bx = jnp.where(use12, ax12, bx)
    by = jnp.where(use12, ay12, by)
    bz = jnp.where(use12, az12, bz)
    bn = jnp.maximum(bn, n12)

    safe = bn > 1e-24
    inv = jax.lax.rsqrt(jnp.maximum(bn, 1e-30))
    vx = jnp.where(safe, bx * inv, 0.0)
    vy = jnp.where(safe, by * inv, 0.0)
    vz = jnp.where(safe, bz * inv, 1.0)
    return vx, vy, vz, safe


def finalize_target(vm: VoxelMap, cfg: GicpConfig) -> GicpTarget:
    """Means + regularized inverse covariances per occupied voxel.

    W = (C_reg + delta I)^-1 with C_reg = lam_max (I - (1-eps) n n^T)
    (the GICP plane-to-plane model: eigenvalues scaled to (eps,1,1)),
    expanded via Sherman-Morrison:
        W = (1/a) I + (b / (a (a - b))) n n^T,
        a = lam_max + delta,  b = lam_max (1 - eps).
    Identical to inverting the regularised covariance, ~60 scalar ops per
    voxel instead of an eigenvector-basis reconstruction + 3x3 inverse.
    """
    n = jnp.maximum(vm.n, 1.0)
    mx, my, mz = vm.sum_x[0] / n, vm.sum_x[1] / n, vm.sum_x[2] / n
    c00 = vm.sum_xx[0] / n - mx * mx
    c11 = vm.sum_xx[1] / n - my * my
    c22 = vm.sum_xx[2] / n - mz * mz
    c01 = vm.sum_xx[3] / n - mx * my
    c02 = vm.sum_xx[4] / n - mx * mz
    c12 = vm.sum_xx[5] / n - my * mz

    e_lo, e_hi = _eig3_lo_hi(c00, c01, c02, c11, c12, c22)
    vx, vy, vz, n_ok = _normal_from_cov(c00, c01, c02, c11, c12, c22, e_lo)

    delta = 1e-3
    lam = jnp.maximum(e_hi, 1e-9)
    a = lam + delta
    b = lam * (1.0 - cfg.plane_eps)
    # degenerate covariance (no recoverable normal): zero the whole weight
    # so the voxel contributes nothing, rather than penalizing along an
    # arbitrary +z that may be parallel to a collinear voxel's point line
    k = jnp.where(n_ok, b / (a * (a - b)), 0.0)
    inv_a = jnp.where(n_ok, 1.0 / a, 0.0)
    w00 = inv_a + k * vx * vx
    w11 = inv_a + k * vy * vy
    w22 = inv_a + k * vz * vz
    w01 = k * vx * vy
    w02 = k * vx * vz
    w12 = k * vy * vz
    weight = jnp.stack([w00, w11, w22, w01, w02, w12], axis=0)
    # non-finite guard (degenerate covariances): zero weight, never poison
    # the normal equations
    weight = jnp.where(jnp.all(jnp.isfinite(weight), axis=0,
                               keepdims=True), weight, 0.0)
    mean = jnp.stack([mx, my, mz], axis=0)
    valid = vm.n >= cfg.min_pts_per_voxel
    return GicpTarget(mean=mean, weight=weight, valid=valid)


def register(source_xyz: jnp.ndarray, source_valid: jnp.ndarray,
             target: GicpTarget, cfg: GicpConfig,
             T_init: jnp.ndarray | None = None) -> GicpResult:
    """Gauss-Newton alignment of a source scan to a voxelized target.

    Returns T with target_point ~= T @ source_point.

    Structure: each OUTER pass re-establishes correspondences (voxel
    lookup + 10 gathers of target stats) and then runs `cfg.inner_iters`
    relinearised Gauss-Newton updates against those frozen Gaussians -
    with ~1 m voxels the correspondences barely change between nearby
    iterates, so the gathers amortise ~3x. The
    per-point math is pure scalar planes; the only non-elementwise ops
    per inner step are ~30 [N]-length reductions and one 6x6 solve.
    """
    if T_init is None:
        T_init = jnp.eye(4, dtype=source_xyz.dtype)
    nxy, nz = _grid_dims(cfg)
    G = nxy * nxy * nz
    inner = max(int(cfg.inner_iters), 1)
    outer_cap = -(-int(cfg.max_iters) // inner)

    # source subsample by STATIC stride (a strided slice is free; a
    # validity-compacted gather is not). Every correspondence pass gathers
    # [9, N_src] target stats, so N_src directly prices the solver; 32k
    # sources keep the 6-DoF problem massively over-determined while
    # cutting the gather work 4x. The TARGET map
    # keeps full density (voxel Gaussians want every point).
    if (cfg.max_source_points and
            source_xyz.shape[0] > cfg.max_source_points):
        stride = -(-source_xyz.shape[0] // cfg.max_source_points)
        source_xyz = source_xyz[::stride]
        source_valid = source_valid[::stride]

    sx = source_xyz[:, 0]
    sy = source_xyz[:, 1]
    sz = source_xyz[:, 2]
    max_d2 = cfg.max_corr_dist ** 2

    def warp(T):
        R, t = T[:3, :3], T[:3, 3]
        px = R[0, 0] * sx + R[0, 1] * sy + R[0, 2] * sz + t[0]
        py = R[1, 0] * sx + R[1, 1] * sy + R[1, 2] * sz + t[1]
        pz = R[2, 0] * sx + R[2, 1] * sy + R[2, 2] * sz + t[2]
        return px, py, pz

    def gn_step(T, gathered):
        mx, my, mz, w00, w11, w22, w01, w02, w12, okg = gathered
        px, py, pz = warp(T)
        rx, ry, rz = mx - px, my - py, mz - pz
        d2 = rx * rx + ry * ry + rz * rz
        m = (okg & (d2 < max_d2)).astype(source_xyz.dtype)

        qx = (w00 * rx + w01 * ry + w02 * rz) * m
        qy = (w01 * rx + w11 * ry + w12 * rz) * m
        qz = (w02 * rx + w12 * ry + w22 * rz) * m

        # M = W [p]x  (columns of [p]x: (0,pz,-py), (-pz,0,px), (py,-px,0))
        M00 = w01 * pz - w02 * py
        M01 = -w00 * pz + w02 * px
        M02 = w00 * py - w01 * px
        M10 = w11 * pz - w12 * py
        M11 = -w01 * pz + w12 * px
        M12 = w01 * py - w11 * px
        M20 = w12 * pz - w22 * py
        M21 = -w02 * pz + w22 * px
        M22 = w02 * py - w12 * px
        # A = [p]x M   (H_rr = [p]x^T W [p]x = -A)
        A00 = -pz * M10 + py * M20
        A01 = -pz * M11 + py * M21
        A02 = -pz * M12 + py * M22
        A11 = pz * M01 - px * M21
        A12 = pz * M02 - px * M22
        A22 = -py * M02 + px * M12

        # ONE fused reduction for every accumulator (30 separate [N] sums
        # cost ~30 reduction passes; a single [30, N] row-sum is one)
        planes = jnp.stack([
            w00 * m, w01 * m, w02 * m, w11 * m, w12 * m, w22 * m,  # H_tt
            M00 * m, M01 * m, M02 * m, M10 * m, M11 * m, M12 * m,  # H_tr
            M20 * m, M21 * m, M22 * m,
            A00 * m, A01 * m, A02 * m, A11 * m, A12 * m, A22 * m,  # H_rr
            qx, qy, qz,                                            # g_t
            py * qz - pz * qy, pz * qx - px * qz, px * qy - py * qx,
            rx * qx + ry * qy + rz * qz,                           # err
            d2 * m, m])
        S = jnp.sum(planes, axis=1)
        (s00, s01, s02, s11, s12, s22,
         m00, m01, m02, m10, m11_, m12_,
         m20, m21, m22,
         a00, a01, a02, a11, a12, a22,
         gqx, gqy, gqz, gcx, gcy, gcz, serr, sd2, n_ok) = S

        # H blocks: H_tt = sum W, H_tr = -sum M, H_rr = -sum A
        htt = jnp.array([[s00, s01, s02], [s01, s11, s12], [s02, s12, s22]])
        htr = -jnp.array([[m00, m01, m02], [m10, m11_, m12_],
                          [m20, m21, m22]])
        hrr = -jnp.array([[a00, a01, a02], [a01, a11, a12], [a02, a12, a22]])
        H = jnp.block([[htt, htr], [htr.T, hrr]])
        # g = J^T W r with J = [-I | [p]x]: g_t = -sum q, g_r = -sum p x q
        g = -jnp.array([gqx, gqy, gqz, gcx, gcy, gcz])
        H = H + 1e-6 * jnp.eye(6, dtype=H.dtype)
        dxi = -jnp.linalg.solve(H, g)
        # a singular solve yields inf/nan - zero the step instead of letting
        # it poison the pose (the fallback path in callers handles recovery)
        dxi = jnp.where(jnp.isfinite(dxi), dxi, 0.0)
        # trust region: cap the step so a degenerate Hessian (correspondence
        # collapse) cannot fling the iterate to infinity; skip the update
        # entirely below 6 correspondences (6-DoF underdetermined)
        tn = jnp.linalg.norm(dxi[:3])
        rn = jnp.linalg.norm(dxi[3:])
        scale = jnp.minimum(1.0, jnp.minimum(
            cfg.max_step_t / jnp.maximum(tn, 1e-12),
            cfg.max_step_r / jnp.maximum(rn, 1e-12)))
        dxi = dxi * scale * (n_ok >= 6)
        sn = jnp.maximum(n_ok, 1.0)
        err = serr / sn
        rmse = jnp.sqrt(sd2 / sn)
        T_new = geometry.matmul(geometry.exp_se3(dxi), T)
        stats = (err, n_ok.astype(jnp.int32), rmse, jnp.linalg.norm(dxi))
        return T_new, stats

    # one [9, G] stats plane so each correspondence pass is a SINGLE
    # shared-index gather instead of nine
    tgt_all = jnp.concatenate([target.mean, target.weight], axis=0)

    def outer(state):
        T, it, _, _, _, _ = state
        px, py, pz = warp(T)
        flat, ok = _voxel_index_s(px, py, pz, source_valid, cfg)
        f = jnp.clip(flat, 0, G - 1)
        okg = ok & target.valid[f]
        ga = tgt_all[:, f]
        gathered = (ga[0], ga[1], ga[2], ga[3], ga[4], ga[5], ga[6],
                    ga[7], ga[8], okg)

        def inner_body(i, carry):
            T, _, first_delta = carry
            T_new, stats = gn_step(T, gathered)
            # convergence must be judged on the FIRST step after a
            # re-correspondence: later inner steps converge to the frozen-
            # correspondence fixpoint and their delta goes ~0 even when a
            # fresh lookup would still move the pose
            first_delta = jnp.where(i == 0, stats[3], first_delta)
            return T_new, stats, first_delta

        T_new, (err, ncorr, rmse, _), delta = jax.lax.fori_loop(
            0, inner, inner_body,
            (T, (jnp.asarray(jnp.inf), jnp.zeros((), jnp.int32),
                 jnp.asarray(jnp.inf), jnp.asarray(jnp.inf)),
             jnp.asarray(jnp.inf)))
        return (T_new, it + 1, err, ncorr, rmse, delta)

    def cond(state):
        _, it, _, _, _, delta = state
        return (it < outer_cap) & (delta > cfg.tolerance)

    init = (T_init, jnp.zeros((), jnp.int32), jnp.asarray(jnp.inf),
            jnp.zeros((), jnp.int32), jnp.asarray(jnp.inf),
            jnp.asarray(jnp.inf))
    T, it, err, ncorr, rmse, _ = jax.lax.while_loop(cond, outer, init)
    T = geometry.orthonormalize_se3(T)
    # out-of-bounds accounting at the final iterate (valid source points
    # the grid could not see - surfaced, not silently dropped)
    px, py, pz = warp(T)
    _, ok_final = _voxel_index_s(px, py, pz, source_valid, cfg)
    n_oob = jnp.sum(source_valid & ~ok_final).astype(jnp.int32)
    return GicpResult(T=T, n_iters=it, final_error=err, n_corr=ncorr,
                      rmse=rmse, n_oob=n_oob)


def pool_voxel_map(vm: VoxelMap, cfg: GicpConfig,
                   factor: int) -> VoxelMap:
    """Downsample a voxel map by `factor` per axis. Gaussian SUMS are
    additive, so a coarse voxel is just the sum of its factor^3 fine
    children - one reshape-sum, no re-binning of points."""
    nxy, nz = _grid_dims(cfg)
    assert nxy % factor == 0 and nz % factor == 0, \
        f"grid ({nxy},{nz}) not divisible by pyramid factor {factor}"
    cx, cz = nxy // factor, nz // factor

    def pool(a):
        lead = a.shape[:-1]
        a = a.reshape(lead + (cx, factor, cx, factor, cz, factor))
        k = len(lead)
        return a.sum(axis=(k + 1, k + 3, k + 5)).reshape(
            lead + (cx * cx * cz,))

    return VoxelMap(n=pool(vm.n), sum_x=pool(vm.sum_x),
                    sum_xx=pool(vm.sum_xx), n_oob=vm.n_oob)


def _coarse_cfg(cfg: GicpConfig, factor: int) -> GicpConfig:
    import dataclasses
    return dataclasses.replace(
        cfg, voxel_size=cfg.voxel_size * factor,
        max_corr_dist=cfg.max_corr_dist * factor,
        max_iters=max(cfg.max_iters // 2, 8))


def build_targets(vm: VoxelMap, cfg: GicpConfig):
    """Finalize the coarse+fine registration targets of a voxel map ONCE.

    finalize_target is [G]-wide eigen math, and pool+coarse-finalize adds
    more - refinalizing per registration was the single largest odometry
    cost on the previous accelerator. Freezing the (coarse, fine) target
    pair and registering several scans against it amortises that cost
    across a whole refresh chunk of the engine."""
    tgt_c = ccfg = None
    if cfg.coarse_factor > 1:
        ccfg = _coarse_cfg(cfg, cfg.coarse_factor)
        tgt_c = finalize_target(pool_voxel_map(vm, cfg, cfg.coarse_factor),
                                ccfg)
    return tgt_c, ccfg, finalize_target(vm, cfg)


def register_targets(source_xyz: jnp.ndarray, source_valid: jnp.ndarray,
                     tgt_coarse: GicpTarget | None, ccfg: GicpConfig | None,
                     tgt_fine: GicpTarget, cfg: GicpConfig,
                     T_init: jnp.ndarray | None = None) -> GicpResult:
    """Coarse-to-fine registration against PREBUILT targets (see
    build_targets): pure Gauss-Newton, no per-call map finalization."""
    if tgt_coarse is not None:
        res_c = register(source_xyz, source_valid, tgt_coarse, ccfg, T_init)
        T_init = res_c.T
    return register(source_xyz, source_valid, tgt_fine, cfg, T_init)


def register_pyramid(source_xyz: jnp.ndarray, source_valid: jnp.ndarray,
                     vm: VoxelMap, cfg: GicpConfig,
                     T_init: jnp.ndarray | None = None) -> GicpResult:
    """Coarse-to-fine registration: solve first against a factor-pooled
    voxel map (correspondence radius scaled up with it), then refine at
    full resolution from the coarse pose. Robust to inter-scan motion
    several times `max_corr_dist` - e.g. skip-sampled KITTI windows
    (~2-7 m/frame, the regime the reference sidesteps by reading GT
    poses, src/ssc.cpp:913-995)."""
    tgt_c, ccfg, tgt_f = build_targets(vm, cfg)
    return register_targets(source_xyz, source_valid, tgt_c, ccfg,
                            tgt_f, cfg, T_init)


def register_global(source_xyz: jnp.ndarray, source_valid: jnp.ndarray,
                    vm: VoxelMap, cfg: GicpConfig,
                    n_yaw: int = 16) -> GicpResult:
    """Globally initialized registration: sweep `n_yaw` yaw hypotheses
    through the cheap coarse pyramid level, keep the basin with the most
    correspondences, refine at full resolution. For cold starts with no
    motion prior (sequence start, kidnapped re-localization) where the
    attraction basin of a single GICP solve is narrower than the unknown
    rotation."""
    factor = max(cfg.coarse_factor, 2)
    ccfg = _coarse_cfg(cfg, factor)
    vmc = pool_voxel_map(vm, cfg, factor)
    tgt_c = finalize_target(vmc, ccfg)

    def try_yaw(yaw):
        c, s = jnp.cos(yaw), jnp.sin(yaw)
        Ti = jnp.array([[c, -s, 0, 0], [s, c, 0, 0],
                        [0, 0, 1, 0], [0, 0, 0, 1]], source_xyz.dtype)
        res = register(source_xyz, source_valid, tgt_c, ccfg, Ti)
        # rank by correspondence count, tie-broken by residual
        score = res.n_corr.astype(jnp.float32) - res.rmse
        return score, res.T

    yaws = jnp.arange(n_yaw, dtype=source_xyz.dtype) * (2 * jnp.pi / n_yaw)
    scores, Ts = jax.lax.map(try_yaw, yaws)
    best = jnp.argmax(scores)
    tgt = finalize_target(vm, cfg)
    return register(source_xyz, source_valid, tgt, cfg, T_init=Ts[best])


def scan_to_scan(source_xyz: jnp.ndarray, source_valid: jnp.ndarray,
                 target_xyz: jnp.ndarray, target_valid: jnp.ndarray,
                 cfg: GicpConfig,
                 T_init: jnp.ndarray | None = None) -> GicpResult:
    vm = build_voxel_map(target_xyz, target_valid, cfg)
    return register_pyramid(source_xyz, source_valid, vm, cfg, T_init)
