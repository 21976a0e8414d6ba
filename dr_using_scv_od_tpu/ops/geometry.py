"""Vectorized geometric primitives.

Vectorized replacements of the reference's per-point helpers
(include/utility.h:346-405): polar angle, azimuth, point transforms, and
SE(3)/Euler conversions. Everything is batched and jit-friendly; the OpenMP
`transformCloud` loop (include/utility.h:395-406) becomes a single matmul.

Pose algebra runs its float32 products at HIGHEST precision (`matmul`
below, `precision="highest"` on einsums): a GPU may otherwise run them in
TF32, whose ~1e-3 relative error compounds along a trajectory. The
products are 3x3/4x4, so the full-precision path costs nothing.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

RAD2DEG = 180.0 / jnp.pi
DEG2RAD = jnp.pi / 180.0


def matmul(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """`a @ b` at full float32 precision (see module docstring)."""
    return jnp.matmul(a, b, precision="highest")


def range2d(xyz: jnp.ndarray) -> jnp.ndarray:
    """2-D (x,y) range. Reference: pointDistance2d (utility.h:371-374)."""
    return jnp.sqrt(xyz[..., 0] ** 2 + xyz[..., 1] ** 2)


def range3d(xyz: jnp.ndarray) -> jnp.ndarray:
    return jnp.sqrt(jnp.sum(xyz[..., :3] ** 2, axis=-1))


def polar_angle_deg(xyz: jnp.ndarray) -> jnp.ndarray:
    """Polar angle in degrees, [0, 360).

    Reference: getPolarAngle (utility.h:376-387) - atan2 shifted into
    [0, 2pi) for y < 0, and defined as 0 at the origin.
    """
    x, y = xyz[..., 0], xyz[..., 1]
    ang = jnp.arctan2(y, x)
    ang = jnp.where(y < 0, ang + 2.0 * jnp.pi, ang)
    ang = jnp.where((x == 0) & (y == 0), 0.0, ang)
    return ang * RAD2DEG


def azimuth_deg(xyz: jnp.ndarray) -> jnp.ndarray:
    """Elevation angle in degrees. Reference: getAzimuth (utility.h:389-392)."""
    return jnp.arctan2(xyz[..., 2], range2d(xyz)) * RAD2DEG


def transform_points(T: jnp.ndarray, xyz: jnp.ndarray) -> jnp.ndarray:
    """Apply a [4,4] rigid transform to [...,3] points.

    Reference: transformCloud (utility.h:395-406), OpenMP loop -> matmul.
    """
    return matmul(xyz, T[:3, :3].T) + T[:3, 3]


def euler_to_matrix(roll: jnp.ndarray, pitch: jnp.ndarray,
                    yaw: jnp.ndarray) -> jnp.ndarray:
    """R = Rz(yaw) @ Ry(pitch) @ Rx(roll) - the convention of
    pcl::getTransformation used throughout the reference
    (e.g. src/ssc.cpp:1163, 1255-1256)."""
    cr, sr = jnp.cos(roll), jnp.sin(roll)
    cp, sp = jnp.cos(pitch), jnp.sin(pitch)
    cy, sy = jnp.cos(yaw), jnp.sin(yaw)
    R = jnp.stack([
        jnp.stack([cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr], -1),
        jnp.stack([sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr], -1),
        jnp.stack([-sp, cp * sr, cp * cr], -1),
    ], axis=-2)
    return R


def pose_to_matrix(xyzrpy: jnp.ndarray) -> jnp.ndarray:
    """[..., 6] (x,y,z,roll,pitch,yaw) -> [...,4,4] homogeneous transform."""
    R = euler_to_matrix(xyzrpy[..., 3], xyzrpy[..., 4], xyzrpy[..., 5])
    t = xyzrpy[..., :3]
    top = jnp.concatenate([R, t[..., :, None]], axis=-1)
    bottom = jnp.broadcast_to(
        jnp.array([0.0, 0.0, 0.0, 1.0], dtype=top.dtype),
        top.shape[:-2] + (1, 4))
    return jnp.concatenate([top, bottom], axis=-2)


def matrix_to_euler(R: jnp.ndarray) -> jnp.ndarray:
    """Rotation matrix -> (roll, pitch, yaw).

    Reference: rotationMatrixToEulerAngles (utility.h:488-505) with the same
    singularity guard.
    """
    sy = jnp.sqrt(R[..., 0, 0] ** 2 + R[..., 1, 0] ** 2)
    singular = sy < 1e-6
    x = jnp.where(singular,
                  jnp.arctan2(-R[..., 1, 2], R[..., 1, 1]),
                  jnp.arctan2(R[..., 2, 1], R[..., 2, 2]))
    y = jnp.arctan2(-R[..., 2, 0], sy)
    z = jnp.where(singular, 0.0, jnp.arctan2(R[..., 1, 0], R[..., 0, 0]))
    return jnp.stack([x, y, z], axis=-1)


def inverse_se3(T: jnp.ndarray) -> jnp.ndarray:
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = jnp.swapaxes(R, -1, -2)
    ti = -jnp.einsum('...ij,...j->...i', Rt, t, precision="highest")
    top = jnp.concatenate([Rt, ti[..., :, None]], axis=-1)
    bottom = jnp.broadcast_to(
        jnp.array([0.0, 0.0, 0.0, 1.0], dtype=T.dtype),
        T.shape[:-2] + (1, 4))
    return jnp.concatenate([top, bottom], axis=-2)


# ---------------------------------------------------------------------------
# se(3) exponential / hat maps for the GICP Gauss-Newton solver (new
# capability; the reference consumes ground-truth poses).
# ---------------------------------------------------------------------------

def hat(w: jnp.ndarray) -> jnp.ndarray:
    """[...,3] -> [...,3,3] skew-symmetric matrix."""
    zeros = jnp.zeros_like(w[..., 0])
    return jnp.stack([
        jnp.stack([zeros, -w[..., 2], w[..., 1]], -1),
        jnp.stack([w[..., 2], zeros, -w[..., 0]], -1),
        jnp.stack([-w[..., 1], w[..., 0], zeros], -1),
    ], axis=-2)


def exp_so3(w: jnp.ndarray) -> jnp.ndarray:
    """Rodrigues' formula, numerically safe near theta=0."""
    theta = jnp.sqrt(jnp.sum(w ** 2, axis=-1, keepdims=True) + 1e-24)
    th = theta[..., None]
    W = hat(w / theta)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return eye + jnp.sin(th) * W + (1.0 - jnp.cos(th)) * matmul(W, W)


def orthonormalize_se3(T: jnp.ndarray) -> jnp.ndarray:
    """Project the rotation block back onto SO(3) (Gram-Schmidt on
    columns), keeping the translation. Long compose/invert/recompose
    chains in f32 accumulate an orthogonality defect that GROWS
    geometrically once poses round-trip through relative-transform
    extraction (engine window recomposition) - one projection per window
    keeps it at the 1e-7 noise floor. Batch-safe ([...,4,4])."""
    R = T[..., :3, :3]
    x = R[..., :, 0]
    x = x / jnp.linalg.norm(x, axis=-1, keepdims=True)
    y = R[..., :, 1]
    y = y - jnp.sum(x * y, axis=-1, keepdims=True) * x
    y = y / jnp.linalg.norm(y, axis=-1, keepdims=True)
    z = jnp.cross(x, y)
    Ro = jnp.stack([x, y, z], axis=-1)
    top = jnp.concatenate([Ro, T[..., :3, 3:4]], axis=-1)
    bottom = jnp.broadcast_to(
        jnp.array([0.0, 0.0, 0.0, 1.0], dtype=T.dtype),
        T.shape[:-2] + (1, 4))
    return jnp.concatenate([top, bottom], axis=-2)


def exp_se3(xi: jnp.ndarray) -> jnp.ndarray:
    """[...,6] twist (v, w) -> [...,4,4]. Uses the closed-form V matrix."""
    v, w = xi[..., :3], xi[..., 3:]
    theta = jnp.sqrt(jnp.sum(w ** 2, axis=-1, keepdims=True) + 1e-24)
    th = theta[..., None]
    W = hat(w / theta)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=xi.dtype), W.shape)
    R = eye + jnp.sin(th) * W + (1.0 - jnp.cos(th)) * matmul(W, W)
    V = (eye + (1.0 - jnp.cos(th)) / th * W
         + (th - jnp.sin(th)) / th * matmul(W, W))
    t = jnp.einsum('...ij,...j->...i', V, v, precision="highest")
    top = jnp.concatenate([R, t[..., :, None]], axis=-1)
    bottom = jnp.broadcast_to(
        jnp.array([0.0, 0.0, 0.0, 1.0], dtype=xi.dtype),
        top.shape[:-2] + (1, 4))
    return jnp.concatenate([top, bottom], axis=-2)
