"""Frame-level place-recognition descriptor (loop-closure retrieval).

The reference's SCV-OD descriptor is the set of curved voxels a cluster
occupies, matched by voxel-set overlap (src/ssc.cpp:1336). Loop retrieval
needs the same idea pooled to frame level AND independent of pose
estimates (pose-proximity proposal fails exactly when odometry drift is
large): each scan is summarized as a ring x sector occupancy signature
(max height per polar cell - a scan-context-style descriptor re-derived
on the egocentric polar grid), and retrieval scores candidates by
cosine similarity maximized over sector shifts, which makes the match
invariant to the yaw difference between the two visits. The best shift
doubles as the yaw warm start for GICP verification.

Everything is fixed shape: descriptors are [R, S] f32, a keyframe bank is
[K, R, S], and the shift-max similarity is one einsum over all rolls.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax.numpy as jnp


@dataclasses.dataclass(frozen=True)
class DescriptorConfig:
    rings: int = 8
    sectors: int = 24
    min_range: float = 1.5
    max_range: float = 30.0
    # floor offset added to z so empty cells (0) sit below any real return
    z_offset: float = 3.0


def descriptor(xyz: jnp.ndarray, valid: jnp.ndarray,
               cfg: DescriptorConfig) -> jnp.ndarray:
    """[N,3] sensor-frame scan -> [rings, sectors] max-height signature."""
    r = jnp.sqrt(xyz[:, 0] ** 2 + xyz[:, 1] ** 2)
    th = jnp.arctan2(xyz[:, 1], xyz[:, 0])
    th = jnp.where(th < 0, th + 2 * jnp.pi, th)
    ok = valid & (r > cfg.min_range) & (r < cfg.max_range)
    ring = ((r - cfg.min_range) / (cfg.max_range - cfg.min_range)
            * cfg.rings).astype(jnp.int32)
    ring = jnp.clip(ring, 0, cfg.rings - 1)
    sect = (th / (2 * jnp.pi) * cfg.sectors).astype(jnp.int32)
    sect = jnp.clip(sect, 0, cfg.sectors - 1)
    flat = jnp.where(ok, ring * cfg.sectors + sect, cfg.rings * cfg.sectors)
    z = jnp.where(ok, xyz[:, 2] + cfg.z_offset, -jnp.inf)
    d = jnp.full((cfg.rings * cfg.sectors + 1,), -jnp.inf, xyz.dtype)
    d = d.at[flat].max(z)
    d = jnp.where(jnp.isfinite(d), d, 0.0)[:-1]
    return d.reshape(cfg.rings, cfg.sectors)


class Retrieval(NamedTuple):
    scores: jnp.ndarray   # [K] best-shift cosine similarity per keyframe
    shifts: jnp.ndarray   # [K] int32 argmax sector shift
    yaw: jnp.ndarray      # [K] f32 implied yaw of the candidate match


def similarity(query: jnp.ndarray, bank: jnp.ndarray,
               bank_valid: jnp.ndarray) -> Retrieval:
    """Shift-max cosine similarity of `query` [R,S] against `bank` [K,R,S].

    Rows with bank_valid False score -inf. The returned yaw converts the
    winning sector shift into the rotation that maps the candidate frame
    onto the query frame (GICP warm start).
    """
    R, S = query.shape
    rolls = jnp.stack([jnp.roll(query, s, axis=1) for s in range(S)])  # [S,R,S]
    qn = rolls / jnp.maximum(
        jnp.linalg.norm(rolls.reshape(S, -1), axis=1), 1e-9)[:, None, None]
    bn = bank / jnp.maximum(
        jnp.linalg.norm(bank.reshape(bank.shape[0], -1), axis=1),
        1e-9)[:, None, None]
    sim = jnp.einsum('ars,krs->ka', qn, bn.astype(qn.dtype),
                     precision="highest")  # [K,S]
    best = jnp.argmax(sim, axis=1).astype(jnp.int32)
    score = jnp.max(sim, axis=1)
    score = jnp.where(bank_valid, score, -jnp.inf)
    # rolling the query by `s` aligns it with the bank entry when the query
    # heading is rotated by -s sectors relative to the stored frame
    yaw = best.astype(jnp.float32) * (2 * jnp.pi / S)
    return Retrieval(scores=score, shifts=best, yaw=yaw)
