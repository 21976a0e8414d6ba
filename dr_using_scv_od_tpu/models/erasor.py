"""ERASOR-style map cleaning: egocentric ratio of pseudo-occupancy.

The reference compares against ERASOR externally (doc/note.txt:6 via the
`ufo_erasor` tool, src/erasor_dynamic.cpp) but does not implement it; the
north star (BASELINE.json) requires ERASOR-style removal as a first-class
stage. This is an accelerator-native implementation of the method's core
(Lim et al., RA-L 2021), not a port:

  * R-POD: map and scan points bin into an egocentric polar grid
    (ring x sector); per-bin pseudo-occupancy = z-extent, via segment
    reductions;
  * scan-ratio test: bins whose map z-extent greatly exceeds the scan's
    are candidates containing points of objects that have left;
  * R-GPF: inside candidate bins, a batched plane fit (ops/plane.py)
    retains ground; non-ground map points in candidate bins are dynamic.

Everything is fixed-shape: M map points, per-bin stats over R*S bins,
one batched plane fit over all candidate bins at once.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops import plane as plane_ops


@dataclasses.dataclass(frozen=True)
class ErasorConfig:
    max_range: float = 60.0
    min_range: float = 2.0
    num_rings: int = 20
    num_sectors: int = 60
    # scan-ratio test thresholds (height in metres)
    min_h: float = 0.2
    scan_ratio: float = 0.2     # scan_h / map_h below this -> candidate
    # R-GPF
    th_dist: float = 0.15
    num_lpr: int = 12
    th_seeds: float = 0.5
    max_pts_per_bin: int = 1024
    iterations: int = 3


class ErasorResult(NamedTuple):
    dynamic: jnp.ndarray        # [M] bool - map points judged dynamic
    candidate_bins: jnp.ndarray  # [R*S] bool
    bin_overflow: jnp.ndarray   # scalar int32


def _bin_index(xyz: jnp.ndarray, valid: jnp.ndarray, ego: jnp.ndarray,
               cfg: ErasorConfig):
    rel = xyz - ego[None, :]
    r = jnp.sqrt(rel[:, 0] ** 2 + rel[:, 1] ** 2)
    th = jnp.arctan2(rel[:, 1], rel[:, 0])
    th = jnp.where(th < 0, th + 2 * jnp.pi, th)
    ring = ((r - cfg.min_range)
            / (cfg.max_range - cfg.min_range) * cfg.num_rings)
    ring = jnp.clip(ring.astype(jnp.int32), 0, cfg.num_rings - 1)
    sect = jnp.clip((th / (2 * jnp.pi) * cfg.num_sectors).astype(jnp.int32),
                    0, cfg.num_sectors - 1)
    ok = valid & (r > cfg.min_range) & (r < cfg.max_range)
    flat = ring * cfg.num_sectors + sect
    nb = cfg.num_rings * cfg.num_sectors
    return jnp.where(ok, flat, nb), ok


def _bin_stats(flat, ok, z, nb):
    zmin = jax.ops.segment_min(jnp.where(ok, z, jnp.inf), flat,
                               num_segments=nb + 1)[:nb]
    zmax = jax.ops.segment_max(jnp.where(ok, z, -jnp.inf), flat,
                               num_segments=nb + 1)[:nb]
    n = jax.ops.segment_sum(ok.astype(jnp.int32), flat,
                            num_segments=nb + 1)[:nb]
    h = jnp.where(n > 0, zmax - zmin, 0.0)
    return zmin, zmax, n, h


def clean_map(map_xyz: jnp.ndarray, map_valid: jnp.ndarray,
              scan_xyz: jnp.ndarray, scan_valid: jnp.ndarray,
              ego: jnp.ndarray, cfg: ErasorConfig) -> ErasorResult:
    """Judge map points dynamic w.r.t. one scan taken at `ego` (world
    frame [3])."""
    nb = cfg.num_rings * cfg.num_sectors
    m_flat, m_ok = _bin_index(map_xyz, map_valid, ego, cfg)
    s_flat, s_ok = _bin_index(scan_xyz, scan_valid, ego, cfg)

    m_zmin, m_zmax, m_n, m_h = _bin_stats(m_flat, m_ok, map_xyz[:, 2], nb)
    s_zmin, s_zmax, s_n, s_h = _bin_stats(s_flat, s_ok, scan_xyz[:, 2], nb)

    # scan-ratio test: the map towers above what the scan currently sees
    cand = ((m_n > 0) & (s_n > 0)
            & (m_h > cfg.min_h)
            & (s_h < cfg.scan_ratio * m_h + cfg.min_h * 0.5))

    # ---- R-GPF over candidate bins: batched padded gather of map points
    M = map_xyz.shape[0]
    K = cfg.max_pts_per_bin
    order = jnp.argsort(jnp.where(m_ok, m_flat, nb) * jnp.int32(1))
    # order by (bin, z): two stable sorts
    z_ord = jnp.argsort(jnp.where(m_ok, map_xyz[:, 2], jnp.inf))
    key2 = jnp.where(m_ok, m_flat, nb)[z_ord]
    order = z_ord[jnp.argsort(key2, stable=True)]

    counts = jax.ops.segment_sum(m_ok.astype(jnp.int32), m_flat,
                                 num_segments=nb + 1)[:nb]
    offs = jnp.concatenate([jnp.zeros(1, jnp.int32),
                            jnp.cumsum(counts)[:-1].astype(jnp.int32)])
    k_ar = jnp.arange(K, dtype=jnp.int32)
    gidx = jnp.clip(offs[:, None] + k_ar[None, :], 0, M - 1)
    pidx = order[gidx]                               # [nb, K]
    in_bin = k_ar[None, :] < counts[:, None]
    overflow = jnp.sum(jnp.maximum(counts - K, 0))

    px = map_xyz[:, 0][pidx]
    py = map_xyz[:, 1][pidx]
    pz = map_xyz[:, 2][pidx]
    pts = jnp.stack([px, py, pz], axis=-1)

    # seeds: lowest num_lpr points (rows sorted by z within bin)
    rank = jnp.cumsum(in_bin.astype(jnp.int32), axis=1)
    lpr_sel = in_bin & (rank <= cfg.num_lpr)
    lpr_cnt = jnp.maximum(jnp.sum(lpr_sel, 1), 1)
    lpr_h = jnp.sum(jnp.where(lpr_sel, pz, 0.0), 1) / lpr_cnt
    gmask = in_bin & (pz < (lpr_h[:, None] + cfg.th_seeds))
    for _ in range(cfg.iterations):
        normal, mean, _, _ = plane_ops.fit_plane(pts, gmask)
        dist = jnp.einsum('bkc,bc->bk', pts, normal, precision="highest")
        th = cfg.th_dist + jnp.einsum('bc,bc->b', normal, mean,
                                         precision="highest")
        gmask = in_bin & (dist < th[:, None])

    # dynamic: non-ground map points inside candidate bins
    dyn_bin = cand[:, None] & in_bin & ~gmask
    dynamic = jnp.zeros((M,), bool).at[pidx.reshape(-1)].max(
        dyn_bin.reshape(-1))
    dynamic = dynamic & map_valid
    return ErasorResult(dynamic=dynamic, candidate_bins=cand,
                        bin_overflow=overflow.astype(jnp.int32))
