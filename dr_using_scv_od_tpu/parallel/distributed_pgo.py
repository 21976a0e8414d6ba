"""Distributed pose-graph optimization: keyframe-block edge sharding.

The north star (BASELINE.json) calls for the pose graph partitioned by
keyframe blocks across a device mesh with collective reductions. Design:

  * edges (odometry + loop closures) sort by min keyframe id, so a
    contiguous edge shard corresponds to a keyframe block; each device
    holds one shard;
  * pose estimates are replicated [F, 4, 4] (6 DoF x F is tiny - the heavy
    state is edges/residuals/Jacobians, which shard);
  * every matrix-free H@v product and every CG inner product is a local
    edge-parallel computation + one `psum` over the mesh axis - the
    Schur-free equivalent of distributed normal-equation assembly;
  * all devices apply identical (replicated) pose updates, so no gather
    of the solution is ever needed.

Weight-0 padding edges make shards equal-sized without changing the
optimum.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..models import posegraph as pgo
from ..ops import geometry


def pad_and_sort_edges(pg: pgo.PoseGraph, n_shards: int) -> pgo.PoseGraph:
    """Sort edges by min endpoint (keyframe-block locality) and pad with
    weight-0 self-edges to a multiple of n_shards."""
    order = jnp.argsort(jnp.minimum(pg.edge_i, pg.edge_j))
    ei = pg.edge_i[order]
    ej = pg.edge_j[order]
    eT = pg.edge_T[order]
    ew = pg.edge_w[order]
    E = ei.shape[0]
    pad = (-E) % n_shards
    if pad:
        ei = jnp.concatenate([ei, jnp.zeros((pad,), jnp.int32)])
        ej = jnp.concatenate([ej, jnp.zeros((pad,), jnp.int32)])
        eT = jnp.concatenate(
            [eT, jnp.broadcast_to(jnp.eye(4, dtype=eT.dtype),
                                  (pad, 4, 4))])
        ew = jnp.concatenate([ew, jnp.zeros((pad,))])
    return pgo.PoseGraph(poses=pg.poses, edge_i=ei, edge_j=ej,
                         edge_T=eT, edge_w=ew)


def _block_optimize(poses, ei, ej, eT, ew, *, axis: str, gn_iters: int,
                    cg_iters: int, lam: float, fix_first: bool):
    F = poses.shape[0]
    gauge = jnp.ones((F, 1))
    if fix_first:
        gauge = gauge.at[0].set(0.0)

    def local_graph(p):
        return pgo.PoseGraph(poses=p, edge_i=ei, edge_j=ej, edge_T=eT,
                             edge_w=ew)

    def accumulate(g, vec_fn):
        """Edge-parallel J^T W (.) accumulation + psum over shards."""
        out = vec_fn(g)
        return jax.lax.psum(out, axis)

    def gn_step(p, _):
        g = local_graph(p)
        r = pgo.residuals(g)
        Ji, Jj = pgo._edge_jacobians(g)
        w = g.edge_w[:, None]
        b = jnp.zeros((F, 6))
        b = b.at[g.edge_i].add(jnp.einsum('eba,eb->ea', Ji, r,
                                             precision="highest") * w)
        b = b.at[g.edge_j].add(jnp.einsum('eba,eb->ea', Jj, r,
                                             precision="highest") * w)
        b = jax.lax.psum(b, axis)
        b = -b * gauge

        def hv(v):
            local = pgo._hv(g, v, 0.0)
            return jax.lax.psum(local, axis) * gauge + lam * v

        def cg_body(carry, _):
            x, rr, p_dir = carry
            hp = hv(p_dir) * gauge
            alpha = jnp.sum(rr * rr) / jnp.maximum(
                jnp.sum(p_dir * hp), 1e-12)
            x = x + alpha * p_dir
            rr_new = rr - alpha * hp
            beta = jnp.sum(rr_new * rr_new) / jnp.maximum(
                jnp.sum(rr * rr), 1e-12)
            return (x, rr_new, rr_new + beta * p_dir), None

        (x, _, _), _ = jax.lax.scan(cg_body,
                                    (jnp.zeros((F, 6)), b, b), None,
                                    length=cg_iters)
        dx = x * gauge
        new_p = jax.vmap(
            lambda T, xi: geometry.matmul(T, geometry.exp_se3(xi)))(p, dx)
        err = jax.lax.psum(jnp.sum(r * r), axis)
        return new_p, err

    poses, errs = jax.lax.scan(gn_step, poses, None, length=gn_iters)
    return poses, errs[-1]


def optimize_distributed(pg: pgo.PoseGraph, mesh: Mesh, axis: str = "dp",
                         gn_iters: int = 10, cg_iters: int = 50,
                         lam: float = 1e-4,
                         fix_first: bool = True
                         ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Returns (optimized poses [F,4,4] replicated, final error scalar)."""
    n = mesh.shape[axis]
    pgs = pad_and_sort_edges(pg, n)
    fn = jax.shard_map(
        functools.partial(_block_optimize, axis=axis, gn_iters=gn_iters,
                          cg_iters=cg_iters, lam=lam, fix_first=fix_first),
        mesh=mesh,
        in_specs=(P(), P(axis), P(axis), P(axis), P(axis)),
        out_specs=(P(), P()),
        check_vma=False,
    )
    return jax.jit(fn)(pgs.poses, pgs.edge_i, pgs.edge_j, pgs.edge_T,
                       pgs.edge_w)
