"""Distributed pose-graph Gauss-Newton via Schur-complement reduction.

The north star (BASELINE.json) asks for "distributed bundle-adjustment-style
optimization via Schur-complement reduction over psum/all-gather
collectives". `distributed_pgo.py` covers the matrix-free CG path; this
module is the direct Schur design:

  * keyframes split into B contiguous blocks (one per device along the mesh
    axis); the SEPARATOR set is each block's first keyframe plus both
    endpoints of every cross-block edge (loop closures), so every edge's
    endpoints lie in (own block interior) U (separators) - the classic
    two-level nested-dissection structure of an odometry chain;
  * each device assembles its local dense normal equations over
    [interior(K) + separators(S)] slots only, eliminates its interior
    (one [6K x 6K] solve per device, all devices in parallel), and emits
    its Schur contribution S_b = C_b - B_b^T A_b^{-1} B_b;
  * one `psum` reduces {S_b, r_b} to the global separator system
    (6S x 6S - tiny: separators are block boundaries, not keyframes),
    solved replicated on every device; interiors back-substitute locally.

Per GN iteration: 2 collectives (psum of the separator system, psum of the
scattered interior update) regardless of block size - versus one psum per
CG *iteration* in distributed_pgo.py. Schur wins when collective latency
dominates (deep graphs, many CG iterations); CG wins on memory (never
materializes dense blocks). Both coexist deliberately.

Gauge freedom is fixed with a strong prior on keyframe 0 (a separator by
construction).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..models import posegraph as pgo
from ..models.posegraph import _edge_jacobians, residuals
from ..ops import geometry


class SchurPartition(NamedTuple):
    """Host-side static partition of a PoseGraph for B blocks."""
    sep_ids: np.ndarray     # [S] sorted global keyframe ids of separators
    edge_block: np.ndarray  # [B, E_max] edge index into the padded graph
    n_blocks: int
    block_size: int         # K = F / B


def partition_graph(pg: pgo.PoseGraph, n_blocks: int
                    ) -> Tuple[pgo.PoseGraph, SchurPartition]:
    """Pad edges to equal-size per-block shards and compute the separator
    set. F must be a multiple of n_blocks (pad the window upstream)."""
    F = int(pg.poses.shape[0])
    if F % n_blocks:
        raise ValueError(f"F={F} not divisible by n_blocks={n_blocks}")
    K = F // n_blocks
    ei = np.asarray(pg.edge_i)
    ej = np.asarray(pg.edge_j)
    blk_i, blk_j = ei // K, ej // K

    sep = {b * K for b in range(n_blocks)}
    cross = blk_i != blk_j
    # a cross-block edge is exact in the two-level partition only if both
    # endpoints are separators - lift them
    sep.update(ei[cross].tolist())
    sep.update(ej[cross].tolist())
    sep_ids = np.asarray(sorted(sep), np.int32)

    owner = np.minimum(blk_i, blk_j)
    counts = np.bincount(owner, minlength=n_blocks)
    e_max = max(int(counts.max()), 1)

    # pad the graph with weight-0 self edges at keyframe 0 (a separator)
    n_pad = n_blocks * e_max - len(ei)
    eye = jnp.broadcast_to(jnp.eye(4, dtype=pg.edge_T.dtype),
                           (n_pad, 4, 4))
    padded = pgo.PoseGraph(
        poses=pg.poses,
        edge_i=jnp.concatenate([pg.edge_i,
                                jnp.zeros((n_pad,), jnp.int32)]),
        edge_j=jnp.concatenate([pg.edge_j,
                                jnp.zeros((n_pad,), jnp.int32)]),
        edge_T=jnp.concatenate([pg.edge_T, eye], axis=0),
        edge_w=jnp.concatenate([pg.edge_w, jnp.zeros((n_pad,))]))

    edge_block = np.full((n_blocks, e_max), len(ei), np.int64)
    fill = np.zeros(n_blocks, np.int64)
    for e, b in enumerate(owner):
        edge_block[b, fill[b]] = e
        fill[b] += 1
    pad_ptr = len(ei)
    for b in range(n_blocks):
        while fill[b] < e_max:
            edge_block[b, fill[b]] = pad_ptr
            pad_ptr += 1
            fill[b] += 1
    return padded, SchurPartition(sep_ids=sep_ids,
                                  edge_block=edge_block,
                                  n_blocks=n_blocks, block_size=K)


def _local_slot(g: jnp.ndarray, my_block: jnp.ndarray, sep_ids: jnp.ndarray,
                K: int) -> jnp.ndarray:
    """Global keyframe id -> local slot: [0,K) interior of my block,
    [K, K+S) separator. Every edge endpoint is one of the two by
    construction of partition_graph."""
    pos = jnp.searchsorted(sep_ids, g)
    pos = jnp.clip(pos, 0, sep_ids.shape[0] - 1)
    is_sep = sep_ids[pos] == g
    return jnp.where(is_sep, K + pos, g - my_block * K)


def _block_step(poses, ei, ej, eT, ew, *, sep_ids, K: int, axis: str,
                lam: float, prior_w: float):
    """One distributed GN step; returns (new_poses replicated, sum r^2)."""
    S = sep_ids.shape[0]
    L = K + S
    my_block = jax.lax.axis_index(axis)
    F = poses.shape[0]

    g = pgo.PoseGraph(poses=poses, edge_i=ei, edge_j=ej, edge_T=eT,
                      edge_w=ew)
    r = residuals(g)                         # [E,6] (weighted once)
    Ji, Jj = _edge_jacobians(g)
    w = ew[:, None]

    si = _local_slot(ei, my_block, sep_ids, K)
    sj = _local_slot(ej, my_block, sep_ids, K)

    # dense local normal equations over L slots
    H = jnp.zeros((L, L, 6, 6))
    gvec = jnp.zeros((L, 6))
    JiW = Ji * w[..., None]                 # weight applied once per J
    JjW = Jj * w[..., None]
    H = H.at[si, si].add(jnp.einsum('eba,ebc->eac', JiW, JiW,
                                    precision="highest"))
    H = H.at[si, sj].add(jnp.einsum('eba,ebc->eac', JiW, JjW,
                                    precision="highest"))
    H = H.at[sj, si].add(jnp.einsum('eba,ebc->eac', JjW, JiW,
                                    precision="highest"))
    H = H.at[sj, sj].add(jnp.einsum('eba,ebc->eac', JjW, JjW,
                                    precision="highest"))
    gvec = gvec.at[si].add(-jnp.einsum('eba,eb->ea', JiW, r,
                                       precision="highest"))
    gvec = gvec.at[sj].add(-jnp.einsum('eba,eb->ea', JjW, r,
                                       precision="highest"))

    Hm = H.transpose(0, 2, 1, 3).reshape(L * 6, L * 6)
    gv = gvec.reshape(L * 6)

    # interior slots that are actually separators get a decoupled identity
    # row (their update flows through the separator system)
    blk_ids = my_block * K + jnp.arange(K)
    pos = jnp.clip(jnp.searchsorted(sep_ids, blk_ids), 0, S - 1)
    int_valid = sep_ids[pos] != blk_ids                     # [K]
    ivm = jnp.repeat(int_valid, 6)                          # [K*6]

    A = Hm[:K * 6, :K * 6]
    A = jnp.where(ivm[:, None] & ivm[None, :], A, 0.0)
    A = A + jnp.diag(jnp.where(ivm, lam, 1.0))
    B = jnp.where(ivm[:, None], Hm[:K * 6, K * 6:], 0.0)
    C = Hm[K * 6:, K * 6:]
    gi = jnp.where(ivm, gv[:K * 6], 0.0)
    gs = gv[K * 6:]

    AinvB = jnp.linalg.solve(A, B)                          # [6K, 6S]
    Ainvg = jnp.linalg.solve(A, gi)                         # [6K]
    S_loc = C - geometry.matmul(B.T, AinvB)
    r_loc = gs - geometry.matmul(B.T, Ainvg)

    # global separator system: one psum; lam + gauge prior added once
    S_glob = jax.lax.psum(S_loc, axis)
    r_glob = jax.lax.psum(r_loc, axis)
    diag_prior = jnp.full((S * 6,), lam).at[:6].add(
        jnp.where(sep_ids[0] == 0, prior_w, 0.0))
    S_glob = S_glob + jnp.diag(diag_prior)
    xs = jnp.linalg.solve(S_glob, r_glob)                   # [6S] replicated

    # local back-substitution
    xi = Ainvg - geometry.matmul(AinvB, xs)                 # [6K]
    xi = jnp.where(ivm, xi, 0.0)

    # assemble the global update: scatter interiors (psum) + separators
    dx = jnp.zeros((F, 6))
    dx = dx.at[blk_ids].set(xi.reshape(K, 6) * int_valid[:, None])
    dx = jax.lax.psum(dx, axis)
    dx = dx.at[sep_ids].set(xs.reshape(S, 6))
    dx = dx.at[0].set(0.0)                                  # gauge
    new_poses = jax.vmap(
        lambda T, d: geometry.matmul(T, geometry.exp_se3(d)))(poses, dx)
    err = jax.lax.psum(jnp.sum(r * r), axis)
    return new_poses, err


def optimize_schur(pg: pgo.PoseGraph, mesh: Mesh, axis: str = "dp",
                   gn_iters: int = 8, lam: float = 1e-4,
                   prior_w: float = 1e6
                   ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Distributed Schur-complement Gauss-Newton.

    Returns (optimized poses [F,4,4] replicated, final error scalar)."""
    n_blocks = int(mesh.shape[axis])
    padded, part = partition_graph(pg, n_blocks)
    eb = part.edge_block.reshape(-1)
    ei = padded.edge_i[eb].reshape(part.n_blocks, -1)
    ej = padded.edge_j[eb].reshape(part.n_blocks, -1)
    eT = padded.edge_T[eb].reshape(part.n_blocks, -1, 4, 4)
    ew = padded.edge_w[eb].reshape(part.n_blocks, -1)
    sep_ids = jnp.asarray(part.sep_ids)

    step = functools.partial(_block_step, sep_ids=sep_ids,
                             K=part.block_size, axis=axis, lam=lam,
                             prior_w=prior_w)

    def body(poses, ei, ej, eT, ew):
        ei, ej, ew = ei[0], ej[0], ew[0]
        eT = eT[0]

        def it(p, _):
            return step(p, ei, ej, eT, ew)
        poses, errs = jax.lax.scan(it, poses, None, length=gn_iters)
        return poses, errs[-1]

    fn = jax.shard_map(body, mesh=mesh,
                       in_specs=(P(), P(axis), P(axis), P(axis), P(axis)),
                       out_specs=(P(), P()),
                       check_vma=False)
    return jax.jit(fn)(pg.poses, ei, ej, eT, ew)
