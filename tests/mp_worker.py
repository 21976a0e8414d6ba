"""Multi-process worker for test_multiprocess.py.

Launched as `python mp_worker.py <process_id> <num_processes> <port>`.
Each process owns 4 virtual CPU devices; together they form one global
8-device mesh with REAL cross-process collectives (gloo), proving the
sharded pipeline and the distributed Schur pose-graph solve survive a
process boundary — the DCN-analog path SURVEY.md §2.4/§5 calls for that
a single-process virtual mesh cannot exercise.

Prints `MP_OK` on success; any assertion failure raises and the launcher
sees a non-zero exit.
"""

import os
import sys

pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=4").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

jax.distributed.initialize(coordinator_address=f"127.0.0.1:{port}",
                           num_processes=nproc, process_id=pid)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.experimental import multihost_utils  # noqa: E402
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P  # noqa: E402

from dr_using_scv_od_tpu import config  # noqa: E402
from dr_using_scv_od_tpu.models import pipeline, posegraph  # noqa: E402
from dr_using_scv_od_tpu.parallel import schur_pgo, sharded_pipeline  # noqa: E402
from dr_using_scv_od_tpu.utils import synthetic  # noqa: E402


def main():
    assert jax.process_count() == nproc, jax.process_count()
    devs = jax.devices()
    assert len(devs) == 4 * nproc, devs
    mesh = Mesh(np.array(devs), ("dp",))

    # every process builds the identical global window (fixed seed)
    cfg = config.tiny_test()
    spec = synthetic.SceneSpec(ground_pts=1200, building_pts=250,
                               tree_pts=80, car_pts=100, n_buildings=2,
                               n_trees=2, n_parked_cars=2, n_moving_cars=2,
                               extent=14.0, moving_speed=4.0, ego_speed=1.0)
    scene = synthetic.make_scene(spec)
    F = len(devs) * 2
    win = synthetic.render_window(scene, F, cfg.shapes.max_points)

    def dist(a, spec):
        a = np.asarray(a)
        sh = NamedSharding(mesh, spec)
        return jax.make_array_from_callback(a.shape, sh, lambda i: a[i])

    # ---- 1. sharded segmentation+tracking window across both processes
    removed, states, n_dyn = sharded_pipeline.sharded_run_window(
        dist(win["xyz"], P("dp")), dist(win["intensity"], P("dp")),
        dist(win["valid"], P("dp")), dist(win["poses"], P("dp")),
        cfg, mesh)
    n_dyn = multihost_utils.process_allgather(n_dyn, tiled=True)
    removed = multihost_utils.process_allgather(removed, tiled=True)
    assert n_dyn.shape == (F,) and removed.shape == win["xyz"].shape[:2]
    # global final frame carries no verdicts (reference semantics)
    assert int(n_dyn[-1]) == 0, n_dyn

    # single-device reference on local device 0: non-boundary frames must
    # agree exactly (block boundaries may differ in split/merge
    # bookkeeping only — see sharded_pipeline docstring)
    ref = pipeline.run_window(
        jnp.asarray(win["xyz"]), jnp.asarray(win["intensity"]),
        jnp.asarray(win["valid"]), jnp.asarray(win["poses"]), cfg)
    ref_ndyn = np.asarray(ref.n_dynamic)
    block = F // len(devs)
    interior = [f for f in range(F - 1) if (f + 1) % block != 0]
    assert interior, "no interior frames to compare"
    for f in interior:
        assert int(n_dyn[f]) == int(ref_ndyn[f]), (f, n_dyn, ref_ndyn)

    # ---- 2. distributed Schur pose-graph solve across both processes
    from dr_using_scv_od_tpu.ops import geometry
    rng = np.random.default_rng(7)
    Fp = 32
    t = np.linspace(0, 1.5 * np.pi, Fp)
    gt = np.tile(np.eye(4, dtype=np.float32), (Fp, 1, 1))
    yaw = t + np.pi / 2
    gt[:, 0, 0] = np.cos(yaw); gt[:, 0, 1] = -np.sin(yaw)
    gt[:, 1, 0] = np.sin(yaw); gt[:, 1, 1] = np.cos(yaw)
    gt[:, 0, 3] = 5 * np.cos(t); gt[:, 1, 3] = 5 * np.sin(t)
    gt = jnp.asarray(gt)
    rel = jnp.einsum('fij,fjk->fik', geometry.inverse_se3(gt[:-1]), gt[1:])
    noise = jnp.asarray(rng.normal(0, 0.02, (Fp - 1, 6)).astype(np.float32))
    rel_noisy = jnp.einsum('fij,fjk->fik', rel,
                           jnp.stack([geometry.exp_se3(n) for n in noise]))
    init = posegraph.odometry_chain(rel_noisy)
    li = jnp.asarray([0, 3], jnp.int32)
    lj = jnp.asarray([Fp - 1, Fp - 5], jnp.int32)
    lT = jnp.einsum('fij,fjk->fik', geometry.inverse_se3(gt[li]), gt[lj])
    pg = posegraph.make_odometry_graph(init, rel_noisy, li, lj, lT,
                                       jnp.ones((2,)))
    err0 = float(jnp.sum(posegraph.residuals(pg) ** 2))
    poses, err = schur_pgo.optimize_schur(pg, mesh, gn_iters=8)
    # err is replicated over the global mesh; in multi-process mode the
    # global array is not fully addressable, so read the local replica
    err1 = float(np.asarray(err.addressable_shards[0].data).ravel()[0])
    assert np.isfinite(err1) and err1 < 0.25 * err0, (err0, err1)

    print("MP_OK", flush=True)


if __name__ == "__main__":
    main()
