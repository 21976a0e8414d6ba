"""Patchwork ground segmentation as batched array programs.

Re-design of the reference's header-only PatchWork
(include/patchwork.h:38-504): the serial per-patch loop (~420 patches x 3
plane-fit iterations, each an Eigen JacobiSVD) becomes one batched program:

  1. per-point Concentric-Zone-Model binning (pc2czm, patchwork.h:431-459)
     -> a flat patch id per point;
  2. a single sort by (patch, z) builds padded [P, K] per-patch tensors
     (the z-sort doubles as the reference's global z-sort, patchwork.h:295);
  3. seed selection (extract_initial_seeds_, patchwork.h:235-268) and the
     3-iteration plane fit (extract_piecewiseground, patchwork.h:463-504)
     run batched over all patches with masked closed-form 3x3 eigen solves;
  4. patch accept/reject rules (uprightness / elevation / flatness,
     patchwork.h:339-384) produce a per-patch verdict, scattered back to a
     per-point ground mask.

Semantics preserved from the reference, including its filtering quirks:
  * points with r outside (min_range, max_range] never reach either output
    (dropped, patchwork.h:436);
  * points with z < -1.8 * sensor_height are erased up front
    (patchwork.h:302-310);
  * patches with <= num_min_pts points are skipped entirely - their points
    reach neither ground nor nonground (patchwork.h:331);
  * the elevation/flatness recovery only applies to the first
    `num_rings_of_interest` concentric rings with thresholds indexed
    `ring_idx + 2 * zone` (patchwork.h:351-353).

Deliberate divergence: plane normals are canonicalized to n_z >= 0 (the
reference inherits Eigen's arbitrary SVD column sign; see ops/plane.py).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import PatchworkConfig
from ..ops import plane as plane_ops


class PatchworkResult(NamedTuple):
    """No overflow counter: the sort-free formulation below has no
    per-patch point cap, so truncation is impossible by construction
    (every point participates in its patch's segment reductions)."""
    ground: jnp.ndarray      # [N] bool - accepted ground points
    nonground: jnp.ndarray   # [N] bool - rejected / non-ground points
    dropped: jnp.ndarray     # [N] bool - never reached either output
    # diagnostics (per patch)
    patch_normal: jnp.ndarray    # [P,3]
    patch_mean_z: jnp.ndarray    # [P]


def _patch_tables(cfg: PatchworkConfig):
    """Static per-patch lookup tables: concentric ring index and
    elevation/flatness threshold slot (or -1 when not applicable)."""
    conc, thr_slot = [], []
    concentric = 0
    for zone, (ns, nr) in enumerate(zip(cfg.num_sectors_each_zone,
                                        cfg.num_rings_each_zone)):
        for ring in range(nr):
            slot = ring + 2 * zone
            use = concentric < cfg.num_rings_of_interest
            for _ in range(ns):
                conc.append(concentric)
                thr_slot.append(slot if use and slot < len(cfg.elevation_thr)
                                else -1)
            concentric += 1
    return (jnp.asarray(conc, jnp.int32), jnp.asarray(thr_slot, jnp.int32))


def _patch_id(xyz: jnp.ndarray, valid: jnp.ndarray, cfg: PatchworkConfig):
    """Flat patch id per point; P (=cfg.num_patches) for out-of-range or
    invalid points. Mirrors pc2czm (patchwork.h:431-459)."""
    x, y = xyz[..., 0], xyz[..., 1]
    r = jnp.sqrt(x * x + y * y)
    theta = jnp.arctan2(y, x)
    theta = jnp.where(y < 0, theta + 2.0 * jnp.pi, theta)

    P = cfg.num_patches
    pid = jnp.full(r.shape, P, jnp.int32)
    base = 0
    mrs = cfg.min_ranges + (cfg.max_range,)
    for zone in range(cfg.num_zones):
        ns, nr = cfg.num_sectors_each_zone[zone], cfg.num_rings_each_zone[zone]
        ring_size, sector_size = cfg.ring_sizes[zone], cfg.sector_sizes[zone]
        in_zone = (r > mrs[zone]) & (r <= mrs[zone + 1]) if zone < 3 else \
            (r > mrs[zone]) & (r <= cfg.max_range)
        ring = jnp.minimum((r - mrs[zone]) / ring_size, nr - 1).astype(jnp.int32)
        sect = jnp.minimum(theta / sector_size, ns - 1).astype(jnp.int32)
        ring = jnp.clip(ring, 0, nr - 1)
        sect = jnp.clip(sect, 0, ns - 1)
        pid = jnp.where(in_zone, base + ring * ns + sect, pid)
        base += ns * nr
    # reference erases points below -1.8 * sensor_height before binning
    too_low = xyz[..., 2] < -1.8 * cfg.sensor_height
    pid = jnp.where(valid & ~too_low, pid, P)
    return pid


def estimate_ground(xyz: jnp.ndarray, valid: jnp.ndarray,
                    cfg: PatchworkConfig) -> PatchworkResult:
    """Batched Patchwork. xyz [N,3] f32, valid [N] bool.

    Sort-free formulation: the reference's z-sorted per-patch point lists
    exist only to pick the num_lpr lowest points (extract_initial_seeds_,
    patchwork.h:235-268). Here that quantile comes from a per-patch
    z-HISTOGRAM (segment scatter-add) - no global sort, no padded [P, K]
    gathers - and every plane fit runs as masked per-patch segment-sums
    keyed by patch id. LPR heights are exact up to one histogram bin
    (~5 cm), well inside th_seeds = 0.3 m.
    """
    N = xyz.shape[0]
    P = cfg.num_patches
    NB = 128  # z-histogram bins per patch

    pid = _patch_id(xyz, valid, cfg)
    binned = pid < P
    z = xyz[..., 2]

    # All per-patch reductions below run as ONE-HOT MATMULS
    # ([P, N] selector @ [N, F] features) instead of ~30 segment-sum
    # scatters (a choice made for the previous accelerator, queued for
    # measurement on the H100).
    #
    # The [P, N] selector is built ONCE and shared by every reduction -
    # per-call masks move to the FEATURE side ((oh & mask) @ F ==
    # oh @ (mask * F), since the selector routes each point to one patch
    # row either way). Rebuilding the 220 MB selector per call was ~4x
    # this stage's whole HBM budget (round-3 roofline: 5.3 GB/frame).
    patch_iota = jnp.arange(P, dtype=jnp.int32)[:, None]
    oh_pid = (pid[None, :] == patch_iota).astype(jnp.float32)  # [P, N]

    def psum(mask, feats, precision):
        return jnp.matmul(oh_pid,
                          feats * mask[:, None].astype(feats.dtype),
                          precision=precision,
                          preferred_element_type=jnp.float32)

    counts = psum(binned, jnp.ones((N, 1), jnp.float32),
                  "default")[:, 0].astype(jnp.int32)

    # ---- LPR seed height via per-patch z histogram
    from ..ops import segment_ops
    zone0 = _zone0_mask(cfg)
    margin = cfg.adaptive_seed_selection_margin * cfg.sensor_height
    pid_c = jnp.clip(pid, 0, P - 1)
    # per-point reads of per-patch tables run as select trees / matmuls
    # against the shared selector instead of [N]-shaped gathers from
    # small tables (segment_ops.small_table_lookup)
    zone0_pt = segment_ops.small_table_lookup(zone0, pid_c, 1)
    # zone0 skips the sorted prefix below the margin (patchwork.h:245-253)
    in_hist = binned & ~(zone0_pt & (z < margin))
    z_lo = -1.8 * cfg.sensor_height          # points below got erased
    z_hi = z_lo + 8.0                        # seeds live near the ground
    zbin = jnp.clip(((z - z_lo) / (z_hi - z_lo) * NB), 0, NB - 1
                    ).astype(jnp.int32)
    # one [P, N] @ [N, 2*NB] matmul yields count- and z-sum histograms
    zoh = (zbin[:, None] == jnp.arange(NB, dtype=jnp.int32)[None, :]) \
        & in_hist[:, None]
    zoh = zoh.astype(jnp.float32)
    both = psum(in_hist, jnp.concatenate([zoh, zoh * z[:, None]], axis=1),
                "default")
    hist = both[:, :NB].astype(jnp.int32)
    zsum = both[:, NB:]
    cum = jnp.cumsum(hist, axis=1)
    # bin where the cumulative count reaches num_lpr
    need = jnp.minimum(cfg.num_lpr, jnp.maximum(cum[:, -1], 1))
    lpr_bin = jnp.argmax(cum >= need[:, None], axis=1)
    take = cum[jnp.arange(P), lpr_bin]
    zsum_cum = jnp.cumsum(zsum, axis=1)[jnp.arange(P), lpr_bin]
    lpr_height = zsum_cum / jnp.maximum(take, 1)

    # lpr_height broadcast to points by matmul against the selector
    lpr_pt = jnp.matmul(lpr_height[None, :].astype(jnp.float32), oh_pid,
                        precision="highest",
                        preferred_element_type=jnp.float32)[0]
    seeds = in_hist & (z < (lpr_pt + cfg.th_seeds))

    # ---- iterative plane fit: one [P, N] @ [N, 10] moment matmul per
    # masked fit ('highest' precision - second moments need the f32 path,
    # bf16 matmul passes would swamp the ~1e-2 m^2 patch variances)
    x, y, zz = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    moment_feats = jnp.stack(
        [jnp.ones_like(x), x, y, zz, x * x, y * y, zz * zz,
         x * y, x * zz, y * zz], axis=-1)

    def fit(mask):
        m = psum(mask, moment_feats, "highest")
        n = m[:, 0]
        sn = jnp.maximum(n, 1.0)
        mx, my, mz = m[:, 1] / sn, m[:, 2] / sn, m[:, 3] / sn
        cxx = m[:, 4] / sn - mx * mx
        cyy = m[:, 5] / sn - my * my
        czz = m[:, 6] / sn - mz * mz
        cxy = m[:, 7] / sn - mx * my
        cxz = m[:, 8] / sn - mx * mz
        cyz = m[:, 9] / sn - my * mz
        cov = jnp.stack([
            jnp.stack([cxx, cxy, cxz], -1),
            jnp.stack([cxy, cyy, cyz], -1),
            jnp.stack([cxz, cyz, czz], -1)], axis=-2)
        evals, evecs = plane_ops.eigh3x3(cov)
        normal = evecs[..., :, 0]
        sign = jnp.where(normal[..., 2] < 0, -1.0, 1.0)
        normal = normal * sign[..., None]
        mean = jnp.stack([mx, my, mz], axis=-1)
        return normal, mean, evals

    mask = seeds
    for _ in range(cfg.num_iter):
        normal, mean, evals = fit(mask)
        # th_dist_d = th_dist - d, d = -n . mean  (patchwork.h:229-231)
        th = cfg.th_dist + jnp.einsum('pc,pc->p', normal, mean)
        # per-point (normal, th) via ONE [4,P] @ [P,N] matmul on the
        # shared selector instead of two [N]-from-[P] gathers
        coeff = jnp.concatenate([normal, th[:, None]], axis=1)  # [P,4]
        cpt = jnp.matmul(coeff.T, oh_pid, precision="highest",
                         preferred_element_type=jnp.float32)    # [4,N]
        dist = (xyz[:, 0] * cpt[0] + xyz[:, 1] * cpt[1]
                + xyz[:, 2] * cpt[2])
        mask = binned & (dist < cpt[3])

    # ---- patch verdicts (patchwork.h:339-384)
    conc_idx, thr_slot = _patch_tables(cfg)
    uprightness = jnp.abs(normal[:, 2])
    elevation = mean[:, 2]
    surface_var = evals[:, 0] / jnp.maximum(
        evals[:, 0] + evals[:, 1] + evals[:, 2], 1e-12)

    elev_thr = jnp.asarray(cfg.elevation_thr, xyz.dtype)
    flat_thr = jnp.asarray(cfg.flatness_thr, xyz.dtype)
    slot_t = jnp.clip(thr_slot, 0, len(cfg.elevation_thr) - 1)
    has_slot = thr_slot >= 0
    too_high = has_slot & (elevation > elev_thr[slot_t])
    flat_enough = has_slot & (surface_var < flat_thr[slot_t])

    upright = uprightness >= cfg.uprightness_thr
    accept = upright & (~too_high | flat_enough)
    processed = counts > cfg.num_min_pts             # patchwork.h:331

    proc_pt = segment_ops.small_table_lookup(processed, pid_c, 1)
    acc_pt = segment_ops.small_table_lookup(accept, pid_c, 1)
    ground = binned & proc_pt & acc_pt & mask
    nonground = binned & proc_pt & ~ground
    ground = ground & valid
    nonground = nonground & valid
    dropped = valid & ~ground & ~nonground
    return PatchworkResult(ground=ground, nonground=nonground,
                           dropped=dropped,
                           patch_normal=normal, patch_mean_z=elevation)


def _zone0_mask(cfg: PatchworkConfig) -> jnp.ndarray:
    n0 = cfg.num_sectors_each_zone[0] * cfg.num_rings_each_zone[0]
    m = jnp.zeros((cfg.num_patches,), bool)
    return m.at[:n0].set(True)
