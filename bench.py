"""Benchmark: full dynamic-removal pipeline throughput, ms per frame.

Prints ONE JSON line {"metric", "value", "unit", "vs_baseline"} on stdout.
Everything else (per-stage device timings, odometry throughput, roofline
estimates) goes to stderr.

Baseline: the reference C++ pipeline logs 213.67 ms/frame on SemanticKITTI
seq 00 (doc/note.txt:2, 8-core desktop CPU; BASELINE.md). The dataset is
not available in this environment, so the bench runs synthetic scans of
comparable size (~75k raw points -> ~130k cap) through the identical
pipeline stages (ground seg + curved-voxel build + clustering + RI3 +
recognition + tracking pair). vs_baseline = reference_ms / our_ms
(higher is better).

Measurement discipline: repetitions run INSIDE one jit (a production
pipeline streams scans with data resident on device), and every rep's
input depends on the previous rep's OUTPUT (a 1e-30-scaled carry term), so
XLA's loop-invariant code motion cannot hoist the body out of the loop -
each rep genuinely recomputes the pipeline. Each timed call ends in a host
fetch of its result.

Every result names the device it ran on; a device kind missing from the
peak table below is an error, not a silent skip of the roofline.
"""

import json
import sys
import time

import numpy as np

REPS = 12   # reps per timed call: the per-call dispatch + fetch cost
#             amortizes over REPS*F frames
BASELINE_MS = 213.67  # doc/note.txt:2 (seq 00, full method)

# Published peaks per device_kind, dense rates: (bf16 TFLOP/s, TF32
# TFLOP/s, HBM TB/s). Source: NVIDIA H100 SXM data sheet (at its 700 W
# power limit; a card set lower cannot hold its top clock under load,
# so report the card's power.limit beside any share of these).
_PEAKS = {
    "NVIDIA H100 80GB HBM3": (989.0, 495.0, 3.35),
}


def peaks_for(kind: str) -> tuple[float, float, float]:
    """(bf16 TFLOP/s, TF32 TFLOP/s, HBM TB/s) of a device kind; a kind
    missing from the table raises."""
    if kind not in _PEAKS:
        raise KeyError(f"no published peaks for device kind {kind!r}; "
                       f"add it to bench._PEAKS with its source")
    return _PEAKS[kind]


def _loop(fn, n, *args):
    """Build a jitted n-rep loop of fn whose body is NOT loop-invariant:
    each rep's first input is perturbed by 1e-30 * (previous output sum),
    far below f32 resolution of the coordinates yet opaque to XLA."""
    import jax
    import jax.numpy as jnp

    def run(*a):
        def body(_, acc):
            out = fn(a[0] + 1e-30 * acc, *a[1:])
            leaves = [jnp.sum(x.astype(jnp.float32)) for x in
                      jax.tree.leaves(out) if jnp.issubdtype(
                          jnp.asarray(x).dtype, jnp.number)]
            # the carry GENUINELY depends on the output (scaled so the
            # perturbation stays ~1e-40, far below f32 input resolution)
            return acc + 1.0 + 1e-20 * jnp.sum(jnp.stack(leaves))
        return jax.lax.fori_loop(0, n, body, jnp.zeros((), jnp.float32))

    return jax.jit(run)


def _time(jfn, *args):
    """Compile, warm, then time one call (host fetch = sync)."""
    np.asarray(jfn(*args))
    t0 = time.perf_counter()
    np.asarray(jfn(*args))
    return time.perf_counter() - t0


def _cost(fn, *args):
    """XLA cost analysis (flops, bytes) of a SINGLE-call jit.

    NB: cost must be read off the plain jitted function - wrapping the
    body in the rep fori_loop hides its cost from XLA's analysis (the
    round-2 bench reported 0 flops for exactly that reason).
    """
    import jax
    c = jax.jit(fn).lower(*args).compile().cost_analysis()
    if isinstance(c, list):
        c = c[0]
    return float(c.get("flops", 0.0)), float(c.get("bytes accessed", 0.0))


def _device_ms_from_trace(logdir: str) -> float:
    """Device busy time (ms) of the newest trace jax.profiler wrote under
    `logdir` (`jax.profiler.trace(logdir, create_perfetto_trace=True)`):
    the union of the intervals of every event (kernels and copies, device
    clock) on the "Stream #..." threads of the "/device:GPU:N" processes.
    Raises when there is no trace or it holds no such event."""
    import glob
    import gzip
    paths = sorted(glob.glob(
        f"{logdir}/plugins/profile/*/perfetto_trace.json.gz"))
    if not paths:
        raise FileNotFoundError(f"no perfetto trace under {logdir}")
    with gzip.open(paths[-1]) as f:
        events = json.load(f)["traceEvents"]
    gpu_pids = {e["pid"] for e in events
                if e.get("ph") == "M" and e.get("name") == "process_name"
                and e["args"]["name"].startswith("/device:GPU:")}
    streams = {(e["pid"], e["tid"]) for e in events
               if e.get("ph") == "M" and e.get("name") == "thread_name"
               and e["pid"] in gpu_pids
               and e["args"]["name"].startswith("Stream #")}
    spans = sorted((e["ts"], e["ts"] + e.get("dur", 0)) for e in events
                   if e.get("ph") == "X"
                   and (e["pid"], e.get("tid")) in streams)
    if not spans:
        raise ValueError("no GPU stream events in the trace")
    busy, (lo, hi) = 0.0, spans[0]
    for s, e in spans[1:]:
        if s > hi:
            busy += hi - lo
            lo, hi = s, e
        else:
            hi = max(hi, e)
    return (busy + hi - lo) / 1e3


def main():
    import jax
    import jax.numpy as jnp
    from dr_using_scv_od_tpu import config
    from dr_using_scv_od_tpu.models import odometry, pipeline
    from dr_using_scv_od_tpu.utils import compile_cache, synthetic

    compile_cache.enable()
    dev = jax.devices()[0]
    kind = dev.device_kind
    peaks = peaks_for(kind)
    err = lambda *a: print(*a, file=sys.stderr)
    err(f"[device] {dev.platform} {kind} x{len(jax.devices())}")

    cfg = config.semantickitti()
    scene = synthetic.make_scene()
    F = 6
    win = synthetic.render_window(scene, F, cfg.shapes.max_points)
    xyz = jnp.asarray(win["xyz"])
    inten = jnp.asarray(win["intensity"])
    valid = jnp.asarray(win["valid"])
    poses = jnp.asarray(win["poses"])

    # ---- headline: full removal pipeline, ms/frame
    run = _loop(lambda x, i, v, p: pipeline.run_window(x, i, v, p, cfg),
                REPS, xyz, inten, valid, poses)
    dt = _time(run, xyz, inten, valid, poses)
    ms_per_frame = dt / REPS / F * 1000.0

    # ---- per-stage device timings + roofline (each stage timed as its
    # own rep loop; flops/bytes read off the stage's SINGLE-call compile,
    # where XLA's cost model actually reports them)
    stage_jfns = []   # (name, jfn, args, per_frame) for trace replay
    from dr_using_scv_od_tpu.models import (patchwork, recognition,
                                            segmentation, tracking)

    x0, i0, v0, p0 = xyz[0], inten[0], valid[0], poses[0]
    stages = []

    def stage(name, fn, *args, per_frame=1):
        jfn = _loop(fn, REPS, *args)
        t = _time(jfn, *args) / REPS / per_frame
        fl, by = _cost(fn, *args)
        stages.append((name, t, fl / per_frame, by / per_frame))
        stage_jfns.append((name, jfn, args, per_frame))
        return t

    stage("patchwork",
          lambda x, v: patchwork.estimate_ground(x, v, cfg.patchwork),
          x0, v0)
    pw = jax.jit(lambda x, v: patchwork.estimate_ground(
        x, v, cfg.patchwork))(x0, v0)
    stage("segment",
          lambda x, i, ng, g, d: segmentation.segment_frame(
              x, i, ng, g, d, cfg),
          x0, i0, pw.nonground, pw.ground, pw.dropped)
    seg, point_voxel, vgrid = jax.jit(
        lambda x, i, ng, g, d: segmentation.segment_frame(
            x, i, ng, g, d, cfg))(x0, i0, pw.nonground, pw.ground,
                                  pw.dropped)
    stage("recognize",
          lambda x, pc, pv: recognition.recognize(
              seg.clusters, x, pc, pv, cfg,
              label_grid=seg.label_grid, voxel_count=vgrid.count,
              planar_vox=seg.planar_vox, n_planar=seg.n_planar),
          x0, seg.point_cluster, point_voxel)
    frames = jax.jit(lambda *a: pipeline.process_window(*a, cfg))(
        xyz, inten, valid, poses)
    in_grid = frames.state.point_voxel >= 0
    stage("tracking",
          lambda x, pv, pva, lg, po: tracking.track_window(
              x, pv, pva, lg, frames.state.clusters, po, cfg),
          xyz, frames.state.point_voxel, in_grid & valid,
          frames.state.label_grid, poses, per_frame=F)

    tot_t = sum(s[1] for s in stages)
    tot_fl = sum(s[2] for s in stages)
    tot_by = sum(s[3] for s in stages)
    err(f"[stages ms/frame] "
        + "  ".join(f"{n}={t * 1e3:.2f}" for n, t, _, _ in stages)
        + f"  (sum={tot_t * 1e3:.2f}, e2e={ms_per_frame:.2f})")
    for n, t, fl, by in stages:
        err(f"[roofline] {n:<10} {fl / t / 1e12:6.2f} TFLOP/s  "
            f"{by / t / 1e12:6.3f} TB/s  "
            f"MFU {100 * fl / t / 1e12 / peaks[0]:5.2f}%  "
            f"HBM {100 * by / t / 1e12 / peaks[2]:5.1f}%")
    err(f"[roofline] device={kind}  pipeline total "
        f"{tot_fl / tot_t / 1e12:.2f} TFLOP/s, "
        f"{tot_by / tot_t / 1e12:.3f} TB/s (XLA cost model, "
        f"per-stage compiles)"
        f"  -> MFU {100 * tot_fl / tot_t / 1e12 / peaks[0]:.2f}%"
        f", HBM util {100 * tot_by / tot_t / 1e12 / peaks[2]:.1f}%")

    # cross-check one stage's flops by hand: patchwork's dominant cost
    # is its one-hot moment/histogram matmuls (models/patchwork.py) -
    # 2*P*N per output column: 10 moment cols x num_iter fits + 2*NB
    # histogram cols + 1 count col.
    P = cfg.patchwork.num_patches
    N = cfg.shapes.max_points
    cols = 10 * cfg.patchwork.num_iter + 2 * 128 + 1
    hand = 2.0 * P * N * cols
    xla_pw = stages[0][2]
    err(f"[roofline] hand-check patchwork matmul flops: "
        f"{hand / 1e9:.2f} GFLOP vs XLA total {xla_pw / 1e9:.2f} GFLOP "
        f"(matmuls should dominate; ratio {xla_pw / hand:.2f}x)")

    # ---- device-trace reconciliation: re-run each stage's already-
    # compiled rep loop under jax.profiler and extract the DEVICE time of
    # its XLA module executions from the xplane artifact - the auditable
    # anchor for the cost-model roofline above (SURVEY section 5's
    # "jax.profiler traces + per-kernel counters"). Wall-vs-device delta
    # exposes dispatch/host overhead per stage.
    import tempfile
    trace_dir = tempfile.mkdtemp(prefix="bench_trace_")
    for name, jfn, args, per_frame in stage_jfns:
        sub = f"{trace_dir}/{name}"
        with jax.profiler.trace(sub, create_perfetto_trace=True):
            np.asarray(jfn(*args))
        dev_ms = _device_ms_from_trace(sub) / REPS / per_frame
        wall = next(t for n, t, _, _ in stages if n == name)
        err(f"[trace] {name:<10} device {dev_ms:7.2f} ms/frame  "
            f"wall {wall * 1e3:7.2f}  "
            f"(host/dispatch {wall * 1e3 - dev_ms:+6.2f})")
    err(f"[trace] profiler artifacts under {trace_dir}")

    # ---- secondary metric: GICP scan-to-scan odometry throughput
    from dr_using_scv_od_tpu.models import gicp as gicp_mod
    t_odo = _time(_loop(
        lambda x, v: odometry.estimate_window_poses(x, v, cfg),
        REPS, xyz, valid), xyz, valid) / REPS / (F - 1)
    err(f"[odometry] {t_odo * 1e3:.2f} ms/frame (scan-to-scan GICP)")

    # GICP roofline: flops/bytes of one register_pyramid pair off its
    # single-call compile. NB the XLA cost model counts while_loop
    # bodies ONCE, so this is a LOWER bound on flops (the GN solver
    # runs several outer passes); utilisation numbers are therefore
    # conservative floors.
    vm0 = jax.jit(lambda x, v: gicp_mod.build_voxel_map(
        x, v, cfg.gicp))(xyz[0], valid[0])
    pair = lambda x, v: gicp_mod.register_pyramid(x, v, vm0,
                                                  cfg.gicp).T
    t_pair = _time(_loop(pair, REPS, xyz[1], valid[1]),
                   xyz[1], valid[1]) / REPS
    fl, by = _cost(pair, xyz[1], valid[1])
    err(f"[roofline] gicp pair {t_pair * 1e3:6.2f} ms  "
        f">={fl / t_pair / 1e12:5.2f} TFLOP/s  "
        f">={by / t_pair / 1e12:6.3f} TB/s (cost model counts "
        f"while bodies once)"
        f"  MFU >={100 * fl / t_pair / 1e12 / peaks[0]:.2f}%  "
        f"HBM >={100 * by / t_pair / 1e12 / peaks[2]:.1f}%")

    # ---- flagship: the composed streaming SLAM engine on a loop scene
    # (odometry + tracking + submaps + loop closure + PGO; the driver the
    # reference left commented out, src/ssc.cpp:1454-1546). Steady-state
    # windows only (the first window pays compile + cold caches).
    from dr_using_scv_od_tpu.models import engine as engine_mod
    spec = synthetic.SceneSpec(
        trajectory="loop", loop_frames=24, loop_radius=18.0,
        n_moving_cars=2)
    scene_l = synthetic.make_scene(spec)
    Fs = 71          # 14 windows: 6 sync (all 3 jit variants compile
    #                  + 3 warm latency samples) then 8 PIPELINED
    win_l = synthetic.render_window(scene_l, Fs, cfg.shapes.max_points)
    import dataclasses as _dc
    # EXACTLY the config of the 512-scan cli demo (`slam --scene loop
    # --frames 512 --kf-dist 4.0 --loop-min-score 0.84
    # --erasor-max-range 45 --erasor-max-pts 256`), so that run
    # reuses these compiled executables. kf_dist=4.0 < the 4.7 m
    # frame step of this scene -> every scan still keyframes (the
    # round-4 comparable behavior) while the GATED code path runs.
    ec = engine_mod.EngineConfig(
        window=6, max_keyframes=128, submap_points=4096,
        local_map_kf=3, kf_dist=4.0,
        loop_min_gap=8, loop_min_score=0.84, max_loop_edges=32,
        erasor=_dc.replace(engine_mod.erasor_mod.ErasorConfig(),
                           max_range=45.0, max_pts_per_bin=256),
        erasor_every=4)   # periodic ERASOR INCLUDED in the headline
    # device-resident streaming: scans pre-staged on device, outputs
    # left on device (a production consumer is the next device stage;
    # pulling ~15 arrays to the host per window costs a blocking round
    # trip each). One SCALAR fetch per window is the
    # sync point - the executable computes all outputs before any is
    # fetchable, so it proves the whole window step finished.
    eng = engine_mod.SlamEngine(cfg, ec, materialize_outputs=False)
    xyz_d = jax.device_put(jnp.asarray(win_l["xyz"]))
    int_d = jax.device_put(jnp.asarray(win_l["intensity"]))
    val_d = jax.device_put(jnp.asarray(win_l["valid"]))
    # Two-phase measurement. Windows 1..PIPE_FROM-1 run SYNCHRONOUSLY
    # (a host fetch per window): the first occurrence of each jit
    # variant (first / steady / erasor) compiles here, and the warm
    # sync windows give the per-window LATENCY. Windows >= PIPE_FROM
    # run depth-1 PIPELINED - window k+1 is dispatched before window
    # k's output is fetched, so host/dispatch time overlaps device
    # compute exactly as a production streaming consumer would run it
    # (eng.feed performs no host fetch; every step is still synced,
    # one window behind). That stretch is the THROUGHPUT number.
    PIPE_FROM = 7
    t_steps = []
    seen_variants = set()
    snap = None       # (state, first_frame) before a steady window
    pipe_t0 = None
    pipe_frames = 0
    pipe_windows = 0
    pipe_erasor = 0
    prev_out = None
    for f in range(Fs):
        run_er = (ec.erasor_every > 0
                  and (eng.windows + 1) % ec.erasor_every == 0)
        variant = (eng.windows == 0, run_er)
        will_run = (len(eng._pending) + 1
                    >= (ec.window if eng.windows == 0
                        else ec.window - 1))
        if will_run and snap is None and variant in seen_variants \
                and not run_er:
            snap = (eng.state, eng.n_frames - 1)
        t0 = time.perf_counter()
        out = eng.feed(xyz_d[f], int_d[f], val_d[f])
        if out is None:
            continue
        if eng.windows < PIPE_FROM:
            float(out.pgo_error)        # host fetch = device sync
            # each (first, run_erasor) jit VARIANT compiles on its
            # first execution; steady state excludes exactly those first
            # occurrences
            warm = variant in seen_variants
            seen_variants.add(variant)
            if warm:
                t_steps.append((time.perf_counter() - t0,
                                out.removed.shape[0]))
            if eng.windows == PIPE_FROM - 1:
                pipe_t0 = time.perf_counter()
        else:
            if prev_out is not None:
                float(prev_out.pgo_error)   # sync window k-1
            prev_out = out
            pipe_windows += 1
            pipe_frames += out.removed.shape[0]
            pipe_erasor += int(run_er)
    if prev_out is not None:
        float(prev_out.pgo_error)           # drain the pipeline
    pipe_wall = (time.perf_counter() - pipe_t0
                 if pipe_t0 is not None else 0.0)
    eng.finalize(final_erasor=True)
    ms_slam = (sum(t for t, _ in t_steps)
               / max(sum(k for _, k in t_steps), 1) * 1e3)
    ms_pipe = pipe_wall / max(pipe_frames, 1) * 1e3
    ate = float(odometry.ate_rmse(
        jnp.asarray(eng.poses()),
        jnp.asarray(win_l["poses"][eng.kf_frames()])))
    n_loops = int(eng.state.n_loops)
    err(f"[slam] {ms_pipe:.2f} ms/frame streaming throughput "
        f"(depth-1 pipelined, {pipe_windows} steady windows incl. "
        f"{pipe_erasor} ERASOR passes), window latency "
        f"{ms_slam:.2f} ms/frame ({len(t_steps)} sync windows), "
        f"ATE {ate:.3f} m, {n_loops} loop edge(s), "
        f"{int(eng.state.odo_fallbacks)} odo fallbacks")

    # ---- per-phase DEVICE-time breakdown of one steady engine step:
    # odometry / loops / PGO / ERASOR each as its own jit traced once;
    # tracking+submaps+gating is the remainder of the full-step device
    # total.
    import tempfile
    st5, f0 = snap
    W = ec.window
    xb, ib, vb = (xyz_d[f0:f0 + W], int_d[f0:f0 + W],
                  val_d[f0:f0 + W])

    def _dev_of(fn, *args, jit=True):
        jfn = jax.jit(fn) if jit else fn
        jax.tree.map(np.asarray, jfn(*args))      # compile+warm
        sub = tempfile.mkdtemp(prefix="eng_trace_")
        with jax.profiler.trace(sub, create_perfetto_trace=True):
            jax.tree.map(np.asarray, jfn(*args))
        return _device_ms_from_trace(sub)

    # process_window is ALREADY jitted (the steady executable of
    # the main loop) - re-jitting would compile the whole step again
    dev_step = _dev_of(
        lambda s, x, i, v: engine_mod.process_window(
            s, x, i, v, False, False, ec, cfg),
        st5, xb, ib, vb, jit=False)
    dev_odo = _dev_of(
        lambda s, x, v: engine_mod._window_odometry(
            s, x, v, False, ec, cfg), st5, xb, vb)

    def loops_fn(s, x, v):
        descs = jax.lax.map(
            lambda f: engine_mod.scan_context.descriptor(
                x[f], v[f], ec.desc), jnp.arange(W))
        slots = s.n - 1 + jnp.arange(W, dtype=jnp.int32)
        return engine_mod._window_loops(
            s, x, v, descs, slots, jnp.ones((W,), bool),
            False, ec, cfg)
    dev_loops = _dev_of(loops_fn, st5, xb, vb)
    dev_pgo = _dev_of(
        lambda s: engine_mod._run_pgo(s, s.n, ec), st5)
    dev_er = _dev_of(
        lambda s, x, v: engine_mod._erasor_pass(
            s, x, v, s.last_pose, ec), st5, xb[-1], vb[-1])
    rest = dev_step - dev_odo - dev_loops
    err(f"[engine-trace] step device {dev_step:7.2f} ms "
        f"({dev_step / (W - 1):.2f} ms/frame over {W - 1} judged)")
    err(f"[engine-trace] odometry {dev_odo:7.2f}  "
        f"tracking+submaps(remainder) {max(rest, 0.0):7.2f}  "
        f"loops(retrieval+verify) {dev_loops:7.2f}")
    err(f"[engine-trace] pgo {dev_pgo:7.2f} (loop windows only)  "
        f"erasor {dev_er:7.2f} (every {ec.erasor_every} windows)")

    print(json.dumps({
        "metric": "dynamic_removal_ms_per_frame",
        "value": round(ms_per_frame, 3),
        "unit": "ms/frame",
        "vs_baseline": round(BASELINE_MS / ms_per_frame, 3),
        "device": {"platform": dev.platform, "kind": kind,
                   "count": len(jax.devices())},
    }))


if __name__ == "__main__":
    sys.exit(main())
