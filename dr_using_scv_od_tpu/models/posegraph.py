"""SE(3) pose-graph optimization backend.

NEW capability (the reference has no backend - it trusts GT poses and its
"mapping" is commented out, src/ssc.cpp:1454-1546). Accelerator-first design:

  * the graph is a fixed-size edge table (i, j, T_ij measurement, weight);
  * each Gauss-Newton step solves the normal equations with MATRIX-FREE
    conjugate gradient: H @ v is computed per edge (gather poses, 6x6
    block products batched over edges) and scatter-added per node - no
    sparse matrix assembly, no sequential factorization;
  * under a keyframe-block mesh, edges shard across devices and the CG
    reductions become `psum`s - the distributed path of the north star
    (BASELINE.json): edge-parallel Hv products + collective reductions.

Error convention: e_ij = log(T_ij^-1 * T_i^-1 * T_j) with a Gauss-Newton
approximation that linearizes on the left of each pose; rotations stay
small per iteration so the chordal-style Jacobian below is accurate.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops import geometry


class PoseGraph(NamedTuple):
    poses: jnp.ndarray      # [F, 4, 4] current estimates (world_T_i)
    edge_i: jnp.ndarray     # [E] int32
    edge_j: jnp.ndarray     # [E] int32
    edge_T: jnp.ndarray     # [E, 4, 4] measured i_T_j
    edge_w: jnp.ndarray     # [E] float32 weight (0 disables an edge)


class PgoResult(NamedTuple):
    poses: jnp.ndarray
    final_error: jnp.ndarray
    n_iters: jnp.ndarray


def _log_so3(R: jnp.ndarray) -> jnp.ndarray:
    """[...,3,3] -> [...,3] rotation log, safe near identity."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos = jnp.clip((tr - 1.0) / 2.0, -1.0, 1.0)
    theta = jnp.arccos(cos)
    w = jnp.stack([R[..., 2, 1] - R[..., 1, 2],
                   R[..., 0, 2] - R[..., 2, 0],
                   R[..., 1, 0] - R[..., 0, 1]], axis=-1)
    s = jnp.where(theta < 1e-5, 0.5, theta / (2.0 * jnp.sin(theta + 1e-30)))
    return w * s[..., None]


def _log_se3(T: jnp.ndarray) -> jnp.ndarray:
    """Approximate se(3) log (first-order V^-1; exact enough for residuals
    of near-consistent graphs)."""
    w = _log_so3(T[..., :3, :3])
    return jnp.concatenate([T[..., :3, 3], w], axis=-1)


def residuals(pg: PoseGraph) -> jnp.ndarray:
    """[E, 6] weighted edge residuals."""
    Ti = pg.poses[pg.edge_i]
    Tj = pg.poses[pg.edge_j]
    pred = geometry.matmul(geometry.inverse_se3(Ti), Tj)
    err = _log_se3(geometry.matmul(geometry.inverse_se3(pg.edge_T), pred))
    return err * pg.edge_w[:, None]


def _adjoint(T: jnp.ndarray) -> jnp.ndarray:
    """SE(3) adjoint for (v, w)-ordered twists: Ad(T) = [[R, [t]x R],[0, R]].
    exp(Ad(T) xi) = T exp(xi) T^-1."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    tR = geometry.matmul(geometry.hat(t), R)
    Z = jnp.zeros_like(R)
    return jnp.concatenate([
        jnp.concatenate([R, tR], axis=-1),
        jnp.concatenate([Z, R], axis=-1)], axis=-2)


def _edge_jacobians(pg: PoseGraph):
    """Exact first-order Jacobians for right-multiplicative updates
    T_k <- T_k exp(xi_k) of the error e = log(T_ij^-1 T_i^-1 T_j):
    J_j = I, J_i = -Ad(T_j^-1 T_i)."""
    Ti = pg.poses[pg.edge_i]
    Tj = pg.poses[pg.edge_j]
    Tji = geometry.matmul(geometry.inverse_se3(Tj), Ti)
    Ji = -_adjoint(Tji)
    Jj = jnp.broadcast_to(jnp.eye(6, dtype=Ti.dtype), Ji.shape)
    return Ji, Jj


def _hv(pg: PoseGraph, v: jnp.ndarray, lam: jnp.ndarray) -> jnp.ndarray:
    """Matrix-free H @ v: per-edge block products + scatter-add.
    v: [F, 6] -> returns [F, 6]. H = J^T W J + lam I (Levenberg damping)."""
    Ji, Jj = _edge_jacobians(pg)
    w = pg.edge_w[:, None]
    vi = v[pg.edge_i]
    vj = v[pg.edge_j]
    # r_e = Ji vi + Jj vj   (per-edge predicted residual change)
    re = (jnp.einsum('eab,eb->ea', Ji, vi, precision="highest")
          + jnp.einsum('eab,eb->ea', Jj, vj, precision="highest")) * w
    out = jnp.zeros_like(v)
    out = out.at[pg.edge_i].add(jnp.einsum('eba,eb->ea', Ji, re,
                                               precision="highest") * w)
    out = out.at[pg.edge_j].add(jnp.einsum('eba,eb->ea', Jj, re,
                                               precision="highest") * w)
    return out + lam * v


def optimize(pg: PoseGraph, gn_iters: int = 10, cg_iters: int = 50,
             lam: float = 1e-4, fix_first: bool = True) -> PgoResult:
    """Gauss-Newton with matrix-free CG inner solves."""
    F = pg.poses.shape[0]

    gauge = jnp.ones((F, 1))
    if fix_first:
        gauge = gauge.at[0].set(0.0)  # gauge-fix node 0

    def gn_step(pg_poses, _):
        g = pg._replace(poses=pg_poses)
        r = residuals(g)                                  # [E, 6]
        Ji, Jj = _edge_jacobians(g)
        w = g.edge_w[:, None]
        b = jnp.zeros((F, 6))
        b = b.at[g.edge_i].add(jnp.einsum('eba,eb->ea', Ji, r,
                                             precision="highest") * w)
        b = b.at[g.edge_j].add(jnp.einsum('eba,eb->ea', Jj, r,
                                             precision="highest") * w)
        b = -b * gauge

        # CG solve H x = b
        def cg_body(carry, _):
            x, rr, p = carry
            hp = _hv(g, p, lam) * gauge
            alpha = jnp.sum(rr * rr) / jnp.maximum(jnp.sum(p * hp), 1e-12)
            x = x + alpha * p
            rr_new = rr - alpha * hp
            beta = jnp.sum(rr_new * rr_new) / jnp.maximum(
                jnp.sum(rr * rr), 1e-12)
            p = rr_new + beta * p
            return (x, rr_new, p), None

        x0 = jnp.zeros((F, 6))
        (x, _, _), _ = jax.lax.scan(cg_body, (x0, b, b), None,
                                    length=cg_iters)
        dx = x * gauge
        new_poses = jax.vmap(
            lambda T, xi: geometry.matmul(T, geometry.exp_se3(xi)))(
            pg_poses, dx)
        return geometry.orthonormalize_se3(new_poses), jnp.sum(r * r)

    poses, errs = jax.lax.scan(gn_step, pg.poses, None, length=gn_iters)
    return PgoResult(poses=poses, final_error=errs[-1],
                     n_iters=jnp.asarray(gn_iters))


def odometry_chain(rel_T: jnp.ndarray) -> jnp.ndarray:
    """Compose relative transforms [F-1,4,4] into world poses [F,4,4]
    (pose 0 = identity). The sequential analog the graph refines."""
    def step(T, rel):
        Tn = geometry.matmul(T, rel)
        return Tn, Tn
    T0 = jnp.eye(4, dtype=rel_T.dtype)
    _, rest = jax.lax.scan(step, T0, rel_T)
    return jnp.concatenate([T0[None], rest], axis=0)


def make_odometry_graph(poses_init: jnp.ndarray, rel_T: jnp.ndarray,
                        loop_i: jnp.ndarray | None = None,
                        loop_j: jnp.ndarray | None = None,
                        loop_T: jnp.ndarray | None = None,
                        loop_w: jnp.ndarray | None = None) -> PoseGraph:
    """Sequential odometry edges + optional loop-closure edges."""
    F = poses_init.shape[0]
    ei = jnp.arange(F - 1, dtype=jnp.int32)
    ej = ei + 1
    ew = jnp.ones((F - 1,))
    eT = rel_T
    if loop_i is not None:
        ei = jnp.concatenate([ei, loop_i.astype(jnp.int32)])
        ej = jnp.concatenate([ej, loop_j.astype(jnp.int32)])
        eT = jnp.concatenate([eT, loop_T], axis=0)
        ew = jnp.concatenate([ew, loop_w])
    return PoseGraph(poses=poses_init, edge_i=ei, edge_j=ej,
                     edge_T=eT, edge_w=ew)
