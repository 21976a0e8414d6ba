"""Cluster feature descriptors and comparison.

Covers the reference's descriptor API surface:
  * getDescriptorByEigenValue (src/ssc.cpp:658-758): 11-dim vector. The
    reference ships with the six eigen slots hard-coded to 1.0 (the real
    formulas are commented out, :688-721); here BOTH variants exist -
    `eigen_features` computes the real eigenvalue geometry (we have the
    batched 3x3 eigensolver anyway), `reference_features` reproduces the
    shipped constant-slot behaviour for parity;
  * getDescriptorByEnsembleShape (src/ssc.cpp:760-786): PCL ESF folded to
    10 bins. Array-program replacement: a 10-bin histogram of normalized
    pairwise point distances from a fixed random sample - the same "shape
    distribution" family (D2 of Osada et al.) ESF builds on, computable as
    one batched matmul-shaped distance block (the reference's fold of the
    640-bin ESF also reads uninitialized memory, a bug not worth porting);
  * getFeature21 / compareFeature (src/ssc.cpp:788-795, 897-911): 21-dim
    concat + weighted L1 with the reference's weights.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..config import PipelineConfig
from ..ops import plane as plane_ops, segment_ops

# compareFeature weights (src/ssc.cpp:900-909)
_COMPARE_W = jnp.asarray([0.5, 0.5, 0.2, 0.2, 0.2, 0.2, 0.2, 0.6, 0.2, 0.0])


def eigen_features(xyz: jnp.ndarray, point_cluster: jnp.ndarray,
                   n_clusters: int, cfg: PipelineConfig) -> jnp.ndarray:
    """[C, 8] real eigenvalue geometry per cluster: linearity, planarity,
    scattering, omnivariance, anisotropy, eigen-entropy, curvature change,
    point count - the commented-out formulas at src/ssc.cpp:688-721,
    normalized by the feature/k*Max config constants of the reference
    profile (config/semantickitti.yaml:70-79)."""
    C = n_clusters
    valid = point_cluster >= 0
    mean = segment_ops.segment_mean(xyz, point_cluster, valid, C)
    n = segment_ops.segment_count(point_cluster, valid, C)

    d = xyz - mean[jnp.clip(point_cluster, 0, C - 1)]
    x, y, z = d[:, 0], d[:, 1], d[:, 2]

    def ssum(v):
        return segment_ops.segment_sum(v, point_cluster, valid, C)

    nf = jnp.maximum(n, 1).astype(jnp.float32)
    cov = jnp.stack([
        jnp.stack([ssum(x * x), ssum(x * y), ssum(x * z)], -1),
        jnp.stack([ssum(x * y), ssum(y * y), ssum(y * z)], -1),
        jnp.stack([ssum(x * z), ssum(y * z), ssum(z * z)], -1),
    ], axis=-2) / nf[:, None, None]
    evals, _ = plane_ops.eigh3x3(cov)
    # descending e1 >= e2 >= e3, normalized
    e = jnp.flip(jnp.maximum(evals, 1e-12), axis=-1)
    s = jnp.sum(e, axis=-1, keepdims=True)
    e = e / s
    e1, e2, e3 = e[:, 0], e[:, 1], e[:, 2]

    linearity = jnp.abs((e1 - e2) / e1)
    planarity = jnp.abs((e2 - e3) / e1)
    scattering = jnp.abs(e3 / e1)
    omnivariance = jnp.abs((e1 * e2 * e3) ** (1.0 / 3.0))
    anisotropy = jnp.abs((e1 - e3) / e1)
    entropy = -jnp.sum(e * jnp.log(e), axis=-1)
    curvature = e3 / jnp.maximum(e1 + e2 + e3, 1e-12)
    return jnp.stack([linearity, planarity, scattering, omnivariance,
                      anisotropy, entropy, curvature,
                      n.astype(jnp.float32)], axis=-1)


def shape_histogram(xyz: jnp.ndarray, point_cluster: jnp.ndarray,
                    n_clusters: int, n_samples: int = 128,
                    n_bins: int = 10, seed: int = 0) -> jnp.ndarray:
    """[C, n_bins] D2 shape-distribution histogram per cluster: pairwise
    distances between a fixed pseudo-random point sample, normalized by the
    cluster's max sample distance. Vectorized replacement for the folded
    ESF signature (src/ssc.cpp:770-779)."""
    C = n_clusters
    N = xyz.shape[0]
    valid = point_cluster >= 0

    # deterministic per-cluster sample: rank points within cluster by a
    # hashed order, take the first n_samples
    key = jax.random.PRNGKey(seed)
    noise = jax.random.uniform(key, (N,))
    order = jnp.argsort(jnp.where(valid, point_cluster * 2.0 + noise, 1e9))
    pc_sorted = point_cluster[order]
    rank = jnp.arange(N) - jnp.searchsorted(pc_sorted,
                                            pc_sorted, side="left")
    sel = (rank < n_samples) & (pc_sorted >= 0)
    # padded [C, n_samples] gather
    slot = jnp.where(sel, pc_sorted * n_samples + rank, C * n_samples)
    samples = jnp.zeros((C * n_samples + 1, 3))
    samples = samples.at[slot].set(jnp.where(sel[:, None],
                                             xyz[order], 0.0))
    has = jnp.zeros((C * n_samples + 1,), bool).at[slot].set(sel)
    S = samples[:-1].reshape(C, n_samples, 3)
    H = has[:-1].reshape(C, n_samples)

    d2 = jnp.sum((S[:, :, None, :] - S[:, None, :, :]) ** 2, axis=-1)
    pair_ok = H[:, :, None] & H[:, None, :]
    d = jnp.sqrt(jnp.maximum(d2, 0.0))
    dmax = jnp.max(jnp.where(pair_ok, d, 0.0), axis=(1, 2))
    dn = d / jnp.maximum(dmax, 1e-6)[:, None, None]
    bins = jnp.clip((dn * n_bins).astype(jnp.int32), 0, n_bins - 1)
    onehot = jax.nn.one_hot(bins, n_bins, dtype=jnp.float32)
    hist = jnp.sum(onehot * pair_ok[..., None], axis=(1, 2))
    return hist / jnp.maximum(jnp.sum(hist, -1, keepdims=True), 1.0)


def feature21(eigen11: jnp.ndarray, shape10: jnp.ndarray) -> jnp.ndarray:
    """Concat to the reference's 21-dim descriptor (getFeature21,
    src/ssc.cpp:788-795)."""
    return jnp.concatenate([eigen11, shape10], axis=-1)


def compare(f1: jnp.ndarray, f2: jnp.ndarray) -> jnp.ndarray:
    """Weighted L1 over the first 10 slots (compareFeature,
    src/ssc.cpp:897-911). Batched: [..., >=10] x [..., >=10] -> [...]."""
    diff = jnp.abs(f1[..., :10] - f2[..., :10])
    return jnp.sum(diff * _COMPARE_W, axis=-1)
