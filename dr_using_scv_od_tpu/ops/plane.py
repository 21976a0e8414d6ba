"""Batched 3x3 symmetric eigendecomposition and plane fitting.

The reference runs one Eigen::JacobiSVD per patch inside a serial loop
(include/patchwork.h:217-232, ~420 calls per scan); here all patches (and all
voxels, for GICP covariances) are solved as one batched closed-form
symmetric 3x3 eigen problem - small-matrix-heavy elementwise work.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp


def eigh3x3(A: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Eigenvalues (ascending) + eigenvectors of symmetric [...,3,3] batches.

    Uses the trigonometric closed form (Smith's algorithm) for eigenvalues
    and cross-product eigenvector recovery; falls back gracefully near
    degenerate spectra. Avoids jnp.linalg.eigh's general-purpose QR path,
    which XLA lowers poorly for huge small-matrix batches.
    """
    a00 = A[..., 0, 0]; a01 = A[..., 0, 1]; a02 = A[..., 0, 2]
    a11 = A[..., 1, 1]; a12 = A[..., 1, 2]; a22 = A[..., 2, 2]

    q = (a00 + a11 + a22) / 3.0
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    p2 = (b00 ** 2 + b11 ** 2 + b22 ** 2
          + 2.0 * (a01 ** 2 + a02 ** 2 + a12 ** 2))
    isotropic = p2 <= 1e-18  # near-scalar matrix: all eigenvalues == q
    p = jnp.sqrt(jnp.where(isotropic, 1.0, p2 / 6.0))
    # det(B/p) / 2
    detB = (b00 * (b11 * b22 - a12 ** 2)
            - a01 * (a01 * b22 - a12 * a02)
            + a02 * (a01 * a12 - b11 * a02))
    r = jnp.clip(detB / (2.0 * p ** 3), -1.0, 1.0)
    phi = jnp.arccos(r) / 3.0
    e_hi = jnp.where(isotropic, q, q + 2.0 * p * jnp.cos(phi))
    e_lo = jnp.where(isotropic, q,
                     q + 2.0 * p * jnp.cos(phi + 2.0 * jnp.pi / 3.0))
    e_mid = 3.0 * q - e_hi - e_lo
    evals = jnp.stack([e_lo, e_mid, e_hi], axis=-1)  # ascending

    def eigvec(lam):
        # rows of (A - lam I); eigenvector orthogonal to two independent rows
        r0 = jnp.stack([a00 - lam, a01, a02], axis=-1)
        r1 = jnp.stack([a01, a11 - lam, a12], axis=-1)
        r2 = jnp.stack([a02, a12, a22 - lam], axis=-1)
        c01 = jnp.cross(r0, r1)
        c02 = jnp.cross(r0, r2)
        c12 = jnp.cross(r1, r2)
        n01 = jnp.sum(c01 ** 2, -1, keepdims=True)
        n02 = jnp.sum(c02 ** 2, -1, keepdims=True)
        n12 = jnp.sum(c12 ** 2, -1, keepdims=True)
        best = jnp.where(n01 >= n02, c01, c02)
        bestn = jnp.maximum(n01, n02)
        best = jnp.where(bestn >= n12, best, c12)
        bestn = jnp.maximum(bestn, n12)
        safe = bestn > 1e-24
        v = jnp.where(safe, best / jnp.sqrt(jnp.maximum(bestn, 1e-30)),
                      jnp.zeros_like(best))
        # degenerate (isotropic) fallback: any unit vector works
        fallback = jnp.broadcast_to(
            jnp.array([0.0, 0.0, 1.0], dtype=A.dtype), v.shape)
        return jnp.where(safe, v, fallback)

    v_lo = eigvec(e_lo)
    v_hi = eigvec(e_hi)
    # Robust orthogonal completion (handles repeated eigenvalues, where the
    # cross-product recovery returns parallel/degenerate vectors): project
    # v_hi off v_lo; if that collapses, pick any direction orthogonal to
    # v_lo instead.
    v_hi = v_hi - jnp.sum(v_hi * v_lo, -1, keepdims=True) * v_lo
    nh = jnp.sum(v_hi ** 2, -1, keepdims=True)
    alt_a = jnp.cross(v_lo, jnp.broadcast_to(
        jnp.array([1.0, 0.0, 0.0], dtype=A.dtype), v_lo.shape))
    alt_b = jnp.cross(v_lo, jnp.broadcast_to(
        jnp.array([0.0, 1.0, 0.0], dtype=A.dtype), v_lo.shape))
    na = jnp.sum(alt_a ** 2, -1, keepdims=True)
    nb = jnp.sum(alt_b ** 2, -1, keepdims=True)
    alt = jnp.where(na >= nb, alt_a, alt_b)
    nalt = jnp.maximum(na, nb)
    use_alt = nh < 1e-12
    v_hi = jnp.where(use_alt, alt, v_hi)
    nh = jnp.where(use_alt, nalt, nh)
    v_hi = v_hi / jnp.sqrt(jnp.maximum(nh, 1e-30))
    # middle vector completes the right-handed orthonormal frame
    v_mid = jnp.cross(v_hi, v_lo)
    nm = jnp.sqrt(jnp.maximum(jnp.sum(v_mid ** 2, -1, keepdims=True), 1e-30))
    v_mid = v_mid / nm
    evecs = jnp.stack([v_lo, v_mid, v_hi], axis=-1)  # columns are vectors
    return evals, evecs


def masked_mean_cov(xyz: jnp.ndarray, mask: jnp.ndarray
                    ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Mean and covariance of [..., K, 3] points under [..., K] mask.

    Population covariance (divide by n), matching
    pcl::computeMeanAndCovarianceMatrix used by estimate_plane_
    (include/patchwork.h:218).
    """
    m = mask.astype(xyz.dtype)
    n = jnp.sum(m, axis=-1)
    safe_n = jnp.maximum(n, 1.0)
    mean = jnp.sum(xyz * m[..., None], axis=-2) / safe_n[..., None]
    d = (xyz - mean[..., None, :]) * m[..., None]
    cov = jnp.einsum('...ki,...kj->...ij', d, d,
                     precision="highest") / safe_n[..., None, None]
    return mean, cov, n


def fit_plane(xyz: jnp.ndarray, mask: jnp.ndarray
              ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Least-squares plane per batch: returns (normal [...,3] with n_z >= 0,
    mean [...,3], singular values ascending [...,3], n_pts [...]).

    Replaces PatchWork::estimate_plane_ (include/patchwork.h:217-232). The
    normal is canonicalized to n_z >= 0 (Eigen's SVD column sign is
    arbitrary; the intended semantics - points more than th_dist above the
    plane are non-ground - require the upward orientation).
    """
    mean, cov, n = masked_mean_cov(xyz, mask)
    evals, evecs = eigh3x3(cov)
    normal = evecs[..., :, 0]  # smallest-eigenvalue direction
    sign = jnp.where(normal[..., 2] < 0, -1.0, 1.0)
    normal = normal * sign[..., None]
    return normal, mean, evals, n
