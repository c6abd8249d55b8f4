#!/usr/bin/env python
"""Benchmark: full fused localization (deskew + ICP + EKF) scans/sec on a GPU.

Headline metric (BASELINE.json): fused P2P scans/sec at 128k raw points per
scan. ``vs_baseline`` is measured against the native single-core C++ scan
step (native/src/scan_step.cpp — the same math over the same packed map
arrays, the honest stand-in for the reference's CPU pipeline normalized to
one core); the well-vectorized NumPy implementation is reported alongside.

Also recorded: per-ICP-method fused throughput + ATE on a smaller log, and
the trajectory-parity ATE of the float32 device pipeline vs the float64
CPU-oracle pipeline (reference_cpu.CpuPipeline) on that same log.

Every device time is host wall-clock around work that ends in
``jax.block_until_ready``. The run refuses a backend other than a GPU, and a
phase that fails makes the exit code non-zero.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...extras}.
"""

import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

import jax
import jax.numpy as jnp

from elimaloc_tpu.config import ElimalocConfig, IcpMethod
from elimaloc_tpu.map import TileQueryBudget
from elimaloc_tpu.map.builder import build_voxel_map
from elimaloc_tpu.pipeline import (
    LocalizationPipeline,
    ate_rmse,
    make_world,
    synthesize_log,
)
from elimaloc_tpu.reference_cpu import CpuPipeline, CpuVoxelGrid, cpu_scan_step

RAW_POINTS = int(os.environ.get("BENCH_RAW_POINTS", 131072))
INDEX_SAMPLING = 5          # reference: input_index_sampling (ini :88)
N_SCANS = int(os.environ.get("BENCH_SCANS", 40))
CPU_SCANS = int(os.environ.get("BENCH_CPU_SCANS", 3))
METHOD_SCANS = int(os.environ.get("BENCH_METHOD_SCANS", 15))
SKIP_METHODS = bool(int(os.environ.get("BENCH_SKIP_METHODS", "0")))
# Repeat counts (recorded in the JSON so a reader can judge the spread):
HEADLINE_REPEATS = int(os.environ.get("BENCH_HEADLINE_REPEATS", 3))
METHOD_REPEATS = int(os.environ.get("BENCH_METHOD_REPEATS", 3))
LATENCY_FRAMES = int(os.environ.get("BENCH_LATENCY_FRAMES", 60))


def _cfg(method=IcpMethod.P2P):
    cfg = ElimalocConfig()
    cfg.pcm.icp_method = method
    cfg.pcm.lidar_time_delay = 0.0
    cfg.ekf.ekf_init_x_m = 60.0
    cfg.ekf.ekf_init_y_m = 0.0
    cfg.ekf.ekf_init_yaw_deg = 90.0
    cfg.calib.ego_to_lidar_trans = (0.0, 0.0, 0.0)
    cfg.calib.ego_to_lidar_rot_deg = (0.0, 0.0, 0.0)
    if method in (IcpMethod.VGICP, IcpMethod.AVGICP):
        # voxel-mean fitness floor (see tests/test_icp.py): the mean
        # |residual| to voxel MEANS is ~0.5 m by construction at 1 m voxels
        cfg.pcm.max_fitness_score = 2.0
    return cfg


def autosize_budgets(log, voxel_ds, tile_size, qb=32, headroom=0.15):
    """Static shape budgets sized FROM the log (host numpy pre-pass):
    ds_points covers the densest scan's occupied downsample voxels plus
    ``headroom``; max_slots covers that scan's occupied query tiles plus the
    per-tile chunking overhead."""
    max_kept = 0
    max_slots = 0
    for k in range(len(log.scan_t)):
        p = log.scan_points[k][log.scan_valid[k]]
        vox = np.unique(np.floor(p / voxel_ds).astype(np.int64), axis=0)
        kept = len(vox)
        # slots: one per (tile, qb-chunk); ds points land one-per-voxel
        tiles, cnt = np.unique(
            np.floor(vox[:, :2] * voxel_ds / tile_size).astype(np.int64),
            axis=0, return_counts=True,
        )
        slots = int(np.ceil(cnt / qb).sum())
        max_kept = max(max_kept, kept)
        max_slots = max(max_slots, slots)
    rup = lambda x, m: int(np.ceil(x / m) * m)
    return (
        rup(max_kept * (1 + headroom), 512),
        rup(max_slots * (1 + headroom), 8),
    )


def headline_world():
    """The headline deployment's 600k-point procedural world (120 m)."""
    return make_world(seed=3, extent=120.0, n_ground=400_000, n_wall=200_000)


def headline_log(world, seed=4):
    """A seeded headline drive: ``RAW_POINTS``-point scans at 10 Hz with a
    100 m range, index-sampled 1/``INDEX_SAMPLING`` at ingest like the
    reference (pcm_matching.cpp:908-921)."""
    log = synthesize_log(
        world,
        duration=(N_SCANS + 3) * 0.1,
        points_per_scan=RAW_POINTS,
        max_range=100.0,
        seed=seed,
    )
    sl = slice(None, None, INDEX_SAMPLING)
    log.scan_points = np.ascontiguousarray(log.scan_points[:, sl])
    log.scan_times = np.ascontiguousarray(log.scan_times[:, sl])
    log.scan_valid = np.ascontiguousarray(log.scan_valid[:, sl])
    return log


def build_everything():
    """The headline pipeline (P2P, autosized budgets at qb=16) and its log."""
    world = headline_world()
    log = headline_log(world)
    cfg = _cfg()
    ds_points, max_slots = autosize_budgets(
        log, float(cfg.pcm.input_voxel_ds_m), 4.0 * cfg.pcm.pcm_voxel_size,
        qb=16,
    )
    pipe = LocalizationPipeline(
        cfg, world,
        ds_points=ds_points,
        tile_budget=TileQueryBudget(qb=16, max_slots=max_slots),
        ego_ring_size=512, imu_ring_size=256,
    )
    return pipe, log


def nvidia_smi() -> str:
    """``name, power.limit`` of each visible card, as nvidia-smi reports it."""
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return "; ".join(line.strip() for line in r.stdout.splitlines()
                     if line.strip())


def device_record() -> dict:
    """The device a measurement ran on, as JAX and nvidia-smi report it."""
    devs = jax.devices()
    return {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
        "nvidia_smi": nvidia_smi(),
    }


def timed(fn):
    """(wall seconds of ``fn()`` up to the moment its result is ready,
    the result)."""
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    return time.perf_counter() - t0, out


def bench_headline(pipe, log):
    """Steady-state fused throughput: host batch prep (log load + H2D) is
    timed separately — it happens once per log and overlaps with streaming
    in production, while the jitted replay is the recurring cost."""
    from elimaloc_tpu.pipeline.runtime import build_fused_batches

    state = pipe.reset()
    pipe._rebase(min(log.imu_t[0], log.scan_t[0]))
    tb = pipe.time_base
    t0 = time.perf_counter()
    batches = jax.device_put(build_fused_batches(log, time_base=tb))
    jax.block_until_ready(batches)
    host_prep = time.perf_counter() - t0
    compile_s, _ = timed(
        lambda: pipe._fused(state, batches, pipe.map))  # compile + run
    # best-of-N with the full run-time spread recorded, so a reader can tell
    # a real regression from one quiet run: best AND median AND raw spread
    runs = []
    for _ in range(HEADLINE_REPEATS):
        state2 = pipe.reset()
        pipe.time_base = tb
        t0 = time.perf_counter()
        state, outs = pipe._fused(state2, batches, pipe.map)
        jax.block_until_ready(outs)
        runs.append(time.perf_counter() - t0)
    dt = min(runs)
    dt_med = float(np.median(runs))
    outs["ego_t_abs"] = np.asarray(outs["ego_t"], np.float64) + tb
    n = len(log.scan_t)
    t_abs = np.asarray(outs["ego_t_abs"])
    pos = np.asarray(outs["ego_pos"])
    ate = ate_rmse(t_abs, pos, log.truth_t, log.truth_pos)
    tail = t_abs > log.scan_t[0] + 0.6 * (log.scan_t[-1] - log.scan_t[0])
    ate_tail = ate_rmse(t_abs[tail], pos[tail], log.truth_t, log.truth_pos)
    applied = float(np.asarray(outs["applied"]).mean())
    dropped = int(np.asarray(outs["slots_dropped"]).max())
    ds_kept = int(np.asarray(outs["ds_kept"]).max())
    # Saturation is REPORTED, not asserted (a seed change must not break the
    # one-JSON-line contract); budgets come from autosize_budgets with >=15%
    # headroom, so nonzero drops here mean that policy failed.
    if dropped:
        print(f"WARNING: tile-slot budget undersized: {dropped} dropped",
              file=sys.stderr)
    if ds_kept >= pipe.static.ds_points:
        print("WARNING: downsample budget saturated", file=sys.stderr)

    # Analytic FLOP model of the executed math (XLA's cost_analysis does not
    # descend into scan/while bodies), shared with utils/roofline.frame_model.
    iters_total = int(np.asarray(outs["iterations"]).sum())
    s_slots = pipe.static.icp_static.tile_budget.max_slots
    qb = pipe.static.icp_static.tile_budget.qb
    mhp = int(pipe.map.halo_points.shape[1])
    n_imu = int(batches["imu_t"].shape[0] * batches["imu_t"].shape[1])
    n_raw = int(batches["scan_points"].shape[1])
    flops = (
        iters_total * (s_slots * qb * mhp * 16           # dense corr + select
                       + pipe.static.ds_points * 400)    # GN tail per row
        + n_imu * 81_000                                 # 27x27 F P F^T + Q
        + n * n_raw * 80                                 # deskew per point
    )
    tflops = flops / dt / 1e12

    return dict(
        scans_per_s=n / dt, scans_per_s_median=n / dt_med,
        run_times_s=[round(x, 4) for x in runs],
        ate=ate, ate_tail=ate_tail, applied=applied,
        ds_kept=ds_kept, host_prep=host_prep, dropped=dropped,
        ds_budget=pipe.static.ds_points,
        ds_headroom=round(1.0 - ds_kept / pipe.static.ds_points, 4),
        flops_per_scan=flops / n, achieved_tflops=round(tflops, 3),
        first_call_s=compile_s,
    )


def bench_latency(pipe, log, n_frames=None):
    """Single-frame latency (the online serving metric): one
    fused_frame_at call per frame, waited for with block_until_ready.

    Tail forensics: each frame is dispatched 3 times from the SAME input
    state (the step is a pure function, so the re-dispatches compute the
    identical frame) — the first timing is the one-shot host number, the
    min-of-3 strips host hiccups and is the device+dispatch floor.
    p95(host) - p95(best) is the host tail; if the two agree, the tail is
    real device work. The log is cycled if shorter than ``n_frames`` (state
    advances each frame either way — frame k's program is index-fed, so
    wraparound stays in-bounds)."""
    from elimaloc_tpu.pipeline.runtime import build_fused_batches

    if n_frames is None:
        n_frames = LATENCY_FRAMES
    state = pipe.reset()
    pipe._rebase(min(log.imu_t[0], log.scan_t[0]))
    batches = jax.device_put(
        build_fused_batches(log, time_base=pipe.time_base))
    # warm up the frame program
    state, out = pipe._frame_at(state, batches, jnp.asarray(0, jnp.int32),
                                pipe.map)
    jax.block_until_ready(out)
    n_log = len(log.scan_t)
    host, best = [], []
    for i in range(n_frames):
        k = 1 + i % (n_log - 1)
        samples = []
        for _ in range(3):
            t0 = time.perf_counter()
            state2, out = pipe._frame_at(
                state, batches, jnp.asarray(k, jnp.int32), pipe.map
            )
            jax.block_until_ready(out)
            samples.append(time.perf_counter() - t0)
        host.append(samples[0])
        best.append(min(samples))
        state = state2
    host = np.asarray(host) * 1e3
    best = np.asarray(best) * 1e3
    pct = lambda a, q: float(np.percentile(a, q))
    return dict(
        p50_ms=pct(host, 50), p95_ms=pct(host, 95),
        device_p50_ms=pct(best, 50), device_p95_ms=pct(best, 95),
        frames=n_frames,
    )


def bench_streaming(pipe, log):
    """Frame-streamed online mode (run_frames): one dispatch per scan frame,
    single end-of-run readback. Batches are prebuilt (steady-state — host
    prep is per-log, reported as host_batch_prep_s)."""
    from elimaloc_tpu.pipeline.runtime import build_fused_batches

    pipe.reset()
    pipe._rebase(min(log.imu_t[0], log.scan_t[0]))
    batches = build_fused_batches(log, time_base=pipe.time_base)
    pipe.run_frames(log, batches=batches)   # compile + run
    best = min(timed(lambda: pipe.run_frames(log, batches=batches))[0]
               for _ in range(2))
    return len(log.scan_t) / best


def bench_windowed(pipe, log):
    """Active-window streaming (run_frames + map_window_radius): the resident
    window re-crops with async prefetch as the vehicle arcs, so crop + H2D +
    adopt hiccups are folded into the measured throughput (the city-scale
    RSS bound lives in tests/test_city_scale.py). The sensor gate is reduced
    to 40 m so a 48 m window both covers the full sensor range AND actually
    swaps over the ~34 m bench arc — a separate, labeled workload from the
    100 m-gate headline row. Reuses the already-packed tile map."""
    from elimaloc_tpu.pipeline.runtime import build_fused_batches

    cfg = _cfg()
    cfg.pcm.input_max_dist = 40.0
    wpipe = LocalizationPipeline(
        cfg, pipe._tiles_host_full,
        ds_points=pipe.static.ds_points,
        tile_budget=pipe.static.icp_static.tile_budget,
        ego_ring_size=512, imu_ring_size=256,
        map_window_radius=48.0,
    )
    wpipe.reset()
    wpipe._rebase(min(log.imu_t[0], log.scan_t[0]))
    batches = build_fused_batches(log, time_base=wpipe.time_base)
    # headline: CHUNKED windowed replay (run_fused routes windowed pipelines
    # through replay_fused_chunk — one dispatch per 8 frames, window swaps
    # between chunks); the per-frame loop is the secondary row below
    state, outs = wpipe.run_frames(log, batches=batches, chunk=8)  # compile
    applied = float(np.asarray(outs["applied"]).mean())
    start_xy = np.array([cfg.ekf.ekf_init_x_m, cfg.ekf.ekf_init_y_m])
    runs, all_stats = [], []
    for _ in range(3):
        # re-position the window at the route start UNTIMED: a replay rerun
        # otherwise begins with a cold jump-back swap from the previous
        # run's arc end — a bench-loop artifact real serving never pays
        wpipe._set_window(start_xy)
        wpipe.window_stats = {k: (0 if isinstance(v, int) else 0.0)
                              for k, v in wpipe.window_stats.items()}
        runs.append(timed(
            lambda: wpipe.run_frames(log, batches=batches, chunk=8))[0])
        all_stats.append(dict(wpipe.window_stats))
    best = min(runs)
    stats = all_stats[int(np.argmin(runs))]  # the stats OF the best run
    stats["scans_per_s_median"] = round(len(log.scan_t) / np.median(runs), 2)
    # secondary: the per-frame streaming loop (one dispatch per frame) for
    # the chunked-vs-streamed split
    wpipe.run_frames(log, batches=batches)  # compile the per-frame program
    wpipe._set_window(start_xy)  # untimed re-position (see above)
    stream = timed(lambda: wpipe.run_frames(log, batches=batches))[0]
    stats = {k: (round(v, 4) if isinstance(v, float) else v)
             for k, v in stats.items()}
    stats["stream_scans_per_s"] = round(len(log.scan_t) / stream, 2)
    return len(log.scan_t) / best, stats, applied


def bench_ekf_steps(pipe):
    """EKF predict steps/sec (27-state propagate, in-device loop)."""
    from elimaloc_tpu.ekf import ImuMeas, predict_imu

    state = pipe.reset()
    state = state.replace(
        ekf=state.ekf.replace(
            reset_for_init_prediction=jnp.asarray(False),
            state_initialized=jnp.asarray(True),
        )
    )
    k = 20000

    def run(ekf):
        def body(i, s):
            imu = ImuMeas(
                timestamp=0.001 * (i + 1).astype(jnp.float32),
                acc=jnp.asarray([0.0, 0.0, 9.81], jnp.float32),
                gyro=jnp.asarray([0.0, 0.0, 0.01], jnp.float32),
            )
            return predict_imu(s, imu, pipe.params.ekf, pipe.static.ekf_flags)

        return jax.lax.fori_loop(0, k, body, ekf).pos

    f = jax.jit(run)
    jax.block_until_ready(f(state.ekf))
    return k / timed(lambda: f(state.ekf))[0]


def bench_icp_batched(pipe, log, batch=8):
    """Independent-scan ICP throughput (the raw registration metric): vmap
    over a batch of downsampled 128k-pt scans against the map."""
    from elimaloc_tpu.map.grid import voxel_downsample
    from elimaloc_tpu.register import run_register
    from elimaloc_tpu.pipeline.log import _traj

    t0_log = float(log.imu_t[0])
    scans, inits = [], []
    batch = min(batch, len(log.scan_t) - 2)  # short BENCH_SCANS smoke runs
    for k in range(2, 2 + batch):
        pts = jnp.asarray(log.scan_points[k], jnp.float32)
        v = jnp.asarray(log.scan_valid[k])
        ds, dsv, _ = jax.jit(
            lambda p, vv: voxel_downsample(p, vv, 1.5, 16384)
        )(pts, v)
        scans.append((ds, dsv))
        pose_t, yaw, _, _, _ = _traj(
            np.array([float(log.scan_t[k]) - t0_log]), ramp=3.0
        )
        T = np.eye(4, dtype=np.float32)
        c, s_ = np.cos(yaw[0]), np.sin(yaw[0])
        T[:2, :2] = [[c, -s_], [s_, c]]
        T[:3, 3] = pose_t[0] + [0.2, -0.1, 0.02]
        inits.append(T)
    ds_b = jnp.stack([a for a, _ in scans])
    dsv_b = jnp.stack([b for _, b in scans])
    init_b = jnp.asarray(np.stack(inits))

    reps = 5

    def run(ds, dsv, init):
        def body(i, c):
            res = jax.vmap(
                lambda s1, v1, i1: run_register(
                    s1, v1, pipe.map, i1, pipe.params.icp,
                    pipe.static.icp_static,
                )
            )(ds, dsv, init)
            # real data dependency (a "* 0" trick is one constant-folding
            # pass away from benchmarking nothing)
            return c + jnp.sum(res.pose[:, :3, 3]) * 1e-12

        return jax.lax.fori_loop(0, reps, body, jnp.asarray(0.0, jnp.float32))

    f = jax.jit(run)
    jax.block_until_ready(f(ds_b, dsv_b, init_b))
    return batch * reps / timed(lambda: f(ds_b, dsv_b, init_b))[0]


def _cpu_scan_inputs(pipe, log, k):
    from elimaloc_tpu.pipeline.log import _traj

    t0_log = float(log.imu_t[0])
    stamp = float(log.scan_t[k])
    pts = log.scan_points[k][log.scan_valid[k]].astype(np.float64)
    rel_raw = log.scan_times[k][log.scan_valid[k]].astype(np.float64)
    front = rel_raw[0]
    scan_end = stamp
    scan_cur = stamp + front
    rel = rel_raw - front
    pos, yaw, vel, _, _ = _traj(np.array([scan_cur - t0_log]), ramp=3.0)
    incre = vel[0] * (scan_end - scan_cur)
    init = np.eye(4)
    th = yaw[0]
    init[:2, :2] = [[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]]
    pose_t, _, _, _, _ = _traj(np.array([scan_end - t0_log]), ramp=3.0)
    init[:3, 3] = pose_t[0] + [0.2, -0.1, 0.02]
    return (pts, rel, log.imu_t - t0_log, log.imu_gyro,
            scan_cur - t0_log, scan_end - t0_log, incre, init)


def bench_cpu_numpy(pipe, log):
    """Single-core NumPy reference scan step, truth-initialized."""
    grid = CpuVoxelGrid(pipe.built)
    times = []
    for k in range(2, 2 + CPU_SCANS):
        args = _cpu_scan_inputs(pipe, log, k)
        t1 = time.perf_counter()
        pose, ok, fit = cpu_scan_step(grid, *args)
        times.append(time.perf_counter() - t1)
        assert ok, "CPU reference ICP failed"
    # best-case CPU time (conservative for the speedup claim on a shared host)
    return 1.0 / float(np.min(times))


def ensure_native():
    """Load the native C++ module, BUILDING it first if absent.

    The .so is untracked (CLAUDE.md: native code auto-falls back to NumPy),
    so a fresh driver checkout has none — and without it the headline
    ``vs_baseline`` degrades to the NumPy strawman BASELINE.md disavows.
    ``make -C native`` takes seconds; a failed build degrades loudly."""
    from elimaloc_tpu.map import native_builder

    nb = native_builder.maybe_load()
    if nb is not None and getattr(nb, "_has_scan_step", False):
        return nb
    makedir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "native")
    try:
        r = subprocess.run(
            ["make", "-C", makedir], capture_output=True, text=True,
            timeout=300,
        )
    except Exception as e:  # noqa: BLE001 — degrade to NumPy, loudly
        print(f"WARNING: native build failed to launch: {e}", file=sys.stderr)
        return None
    if r.returncode != 0:
        tail = (r.stderr or r.stdout).strip().splitlines()[-3:]
        print("WARNING: native build failed: " + " | ".join(tail),
              file=sys.stderr)
        return None
    nb = native_builder.maybe_load(force_recheck=True)
    if nb is None or not getattr(nb, "_has_scan_step", False):
        print("WARNING: native build succeeded but the module did not load",
              file=sys.stderr)
        return None
    return nb


def bench_cpu_native(pipe, log):
    """Single-core native C++ scan step (same packed map, same math)."""
    nb = ensure_native()
    if nb is None:
        return None
    times = []
    for k in range(2, 2 + CPU_SCANS):
        pts, rel, imu_t, imu_gyro, scan_cur, scan_end, incre, init = (
            _cpu_scan_inputs(pipe, log, k))
        t1 = time.perf_counter()
        res = nb.scan_step_p2p(
            pipe.built, pts, rel, imu_t, imu_gyro, scan_cur, scan_end,
            incre, init)
        times.append(time.perf_counter() - t1)
        assert res is not None and res[1], "native scan step failed"
    return 1.0 / float(np.min(times))


# BASELINE config 5 flagship last: AVGICP with the full PCM/GPS/CAN fusion
METHOD_CASES = tuple((m, False) for m in (
    IcpMethod.P2P, IcpMethod.GICP, IcpMethod.VGICP, IcpMethod.AVGICP,
)) + ((IcpMethod.AVGICP, True),)


def case_name(method, full_fusion):
    return method.name + ("+GPS+CAN" if full_fusion else "")


def methods_world():
    """The per-method deployment's 230k-point world (60 m)."""
    return make_world(seed=7, extent=60.0, n_ground=150_000, n_wall=80_000)


def methods_map(world):
    """The per-method map, with every method's covariance payload built."""
    return build_voxel_map(
        world, 1.0, 30,
        compute_voxel_cov=True, compute_point_cov=True,
        use_native=True,
    )


def methods_drive(world, seed=8):
    """A seeded per-method drive of 16,384-point scans at 10 Hz."""
    return synthesize_log(
        world, duration=(METHOD_SCANS + 3) * 0.1, points_per_scan=16384,
        max_range=60.0, seed=seed,
    )


def methods_log():
    """(map, log) of the per-method deployment."""
    world = methods_world()
    return methods_map(world), methods_drive(world)


def method_pipeline(method, full_fusion, built):
    cfg = _cfg(method)
    if full_fusion:
        cfg.ekf.use_gps = True
        cfg.ekf.use_can = True
    pipe = LocalizationPipeline(
        cfg, built, ds_points=4096,
        tile_budget=TileQueryBudget(qb=16, max_slots=1024),
        ego_ring_size=512, imu_ring_size=256,
    )
    return cfg, pipe


def oracle_trajectory(cfg, built, log, time_base):
    """The float64 CPU-oracle replay of ``log`` (reference_cpu.CpuPipeline).

    frame_ordered: the fused mode batches can/gps per scan frame (a
    documented deterministic reordering, replay_fused docstring); the parity
    metric isolates NUMERICS by matching that order. With strict time order
    the full-fusion P2P case reads ~25 mm of pure ordering skew vs 1.6 mm of
    actual numeric divergence."""
    oracle = CpuPipeline(cfg, built, ego_ring_size=512, imu_ring_size=256)
    return oracle.run(log, time_base=time_base, frame_ordered=True)


def trajectory_rmse(pos, ref_pos):
    """RMS position difference over the frames both trajectories have."""
    n = min(len(pos), len(ref_pos))
    err = np.linalg.norm(np.asarray(pos)[:n] - np.asarray(ref_pos)[:n],
                         axis=1)
    return float(np.sqrt(np.mean(err ** 2)))


def bench_methods():
    """Per-ICP-method fused throughput + accuracy + device-vs-oracle parity
    on a smaller self-contained log."""
    built, log = methods_log()
    out = {}
    for method, full_fusion in METHOD_CASES:
        t_case = time.perf_counter()
        cfg, pipe = method_pipeline(method, full_fusion, built)
        jax.block_until_ready(pipe.run_fused(log))
        runs = []
        for _ in range(METHOD_REPEATS):
            t0 = time.perf_counter()
            state, outs = pipe.run_fused(log)
            jax.block_until_ready(outs)
            runs.append(time.perf_counter() - t0)
        dt, dt_med = min(runs), float(np.median(runs))
        pos = np.asarray(outs["ego_pos"])
        t_abs = np.asarray(outs["ego_t_abs"])
        ate = ate_rmse(t_abs, pos, log.truth_t, log.truth_pos)

        t_oracle = time.perf_counter()
        ctraj = oracle_trajectory(cfg, built, log, pipe.time_base)
        parity = trajectory_rmse(pos, ctraj["pos"])
        name = case_name(method, full_fusion)
        print(f"bench: methods case {name} done in "
              f"{time.perf_counter() - t_case:.0f}s (oracle "
              f"{time.perf_counter() - t_oracle:.0f}s)", file=sys.stderr,
              flush=True)
        out[name] = {
            "scans_per_s": round(len(log.scan_t) / dt, 2),
            "scans_per_s_median": round(len(log.scan_t) / dt_med, 2),
            "ate_m": round(ate, 4),
            "oracle_parity_ate_m": round(parity, 4),
            "applied": round(float(np.asarray(outs["applied"]).mean()), 3),
        }
        if full_fusion:
            # The fusion row's closed-loop ATE is dominated by the synthetic
            # GPS noise, not by device numerics (oracle parity is mm-scale).
            # The f64 oracle's OWN ATE on the same noisy-GPS log is the noise
            # floor the device number must be judged against.
            floor = ate_rmse(ctraj["t"], ctraj["pos"],
                             log.truth_t, log.truth_pos)
            out[name]["gps_noise_floor_ate_m"] = round(floor, 4)
    return out


def bench_roofline(pipe, log, frame_ms):
    """Measured memory/FMA roofline of the fused frame: on-card ceiling
    measurements + the analytic byte/flop model of the frame
    at bench shapes, reported as ``roofline_frac`` = bound/measured. See
    elimaloc_tpu/utils/roofline.py; the hot loops being modeled are the
    reference's voxel_hash_map.cpp:31-88 + registration.cpp:15-66."""
    from elimaloc_tpu.pipeline.runtime import build_fused_batches
    from elimaloc_tpu.utils.roofline import roofline_report

    state = pipe.reset()
    pipe._rebase(min(log.imu_t[0], log.scan_t[0]))
    batches = build_fused_batches(log, time_base=pipe.time_base)
    # one (already-compiled) replay for the executed-iteration count
    _, outs = pipe._fused(state, batches, pipe.map)
    jax.block_until_ready(outs)
    return roofline_report(pipe, outs, batches, frame_ms)


def bench_reloc():
    """Cold-registration (relocalization) latency:
    initialize_at-style registrations from a 0.4 m / 5 deg initial-pose
    error at the full max_iteration=10 budget — the many-iteration regime
    the reference's initial-pose alignment runs in (pcm_matching.cpp:356-447)
    and the claimed win region of correspondence reuse (corr_refresh_dist_m,
    measured negative for warm 1.7-iteration serving).
    Reports per-registration latency and executed GN iterations with reuse
    OFF (reference behavior) and ON (0.5 m refresh bound)."""
    from elimaloc_tpu.map.grid import voxel_downsample
    from elimaloc_tpu.register import (
        make_icp_params, make_icp_static, run_register,
    )
    from elimaloc_tpu.pipeline.log import _traj

    world = make_world(seed=7, extent=60.0, n_ground=150_000, n_wall=80_000)
    log = synthesize_log(
        world, duration=1.6, points_per_scan=16384, max_range=60.0, seed=8,
    )
    cfg = _cfg()
    pipe = LocalizationPipeline(
        cfg, world, ds_points=4096,
        tile_budget=TileQueryBudget(qb=16, max_slots=1024),
        ego_ring_size=64, imu_ring_size=64,
    )
    t0_log = float(log.imu_t[0])
    rng = np.random.default_rng(11)
    batch = min(8, len(log.scan_t) - 2)
    scans, inits = [], []
    for k in range(2, 2 + batch):
        pts = jnp.asarray(log.scan_points[k], jnp.float32)
        v = jnp.asarray(log.scan_valid[k])
        ds, dsv, _ = jax.jit(
            lambda p, vv: voxel_downsample(p, vv, 1.0, 4096)
        )(pts, v)
        scans.append((ds, dsv))
        pose_t, yaw, _, _, _ = _traj(
            np.array([float(log.scan_t[k]) - t0_log]), ramp=3.0
        )
        # reloc-grade init error: 0.4 m translation (random planar heading)
        # + 5 deg yaw — pcm's initialize regime, not warm odometry
        th_err = np.deg2rad(5.0) * rng.choice([-1.0, 1.0])
        d_xy = 0.4 * np.array([np.cos(a := rng.uniform(0, 2 * np.pi)),
                               np.sin(a)])
        T = np.eye(4, dtype=np.float32)
        c, s_ = np.cos(yaw[0] + th_err), np.sin(yaw[0] + th_err)
        T[:2, :2] = [[c, -s_], [s_, c]]
        T[:3, 3] = pose_t[0] + [d_xy[0], d_xy[1], 0.03]
        inits.append(T)
    ds_b = jnp.stack([a for a, _ in scans])
    dsv_b = jnp.stack([b for _, b in scans])
    init_b = jnp.asarray(np.stack(inits))

    out = {}
    poses = {}
    for tag, refresh in (("no_reuse", 0.0), ("reuse", 0.5)):
        cfg2 = _cfg()
        cfg2.pcm.corr_refresh_dist_m = refresh
        static = make_icp_static(
            cfg2.pcm, backend="tile",
            tile_budget=pipe.static.icp_static.tile_budget,
        )
        params = make_icp_params(cfg2.pcm, dtype=jnp.float32)

        @jax.jit
        def run(ds, dsv, init):
            return jax.vmap(
                lambda s1, v1, i1: run_register(
                    s1, v1, pipe.map, i1, params, static,
                )
            )(ds, dsv, init)

        res = jax.block_until_ready(run(ds_b, dsv_b, init_b))  # compile
        best = min(timed(lambda: run(ds_b, dsv_b, init_b))[0]
                   for _ in range(3))
        poses[tag] = np.asarray(res.pose[:, :3, 3])
        out[tag] = dict(
            reloc_ms=round(best / batch * 1e3, 3),
            gn_iterations=round(float(np.asarray(res.iterations).mean()), 2),
            success=round(float(np.asarray(res.success).mean()), 3),
        )
    # the two variants must converge to the same registration (the reuse
    # fixed-point equivalence is pinned <=1 cm by tests/test_icp.py; this
    # records it at bench scale)
    out["variant_agreement_m"] = round(float(np.max(np.linalg.norm(
        poses["reuse"] - poses["no_reuse"], axis=1))), 4)
    return out


def bench_fleet(pipe, log, lanes=8):
    """Multi-stream serving throughput: ``lanes`` independent replay lanes
    vmapped on the one card (run_fused_fleet). Fleet-vs-single lane parity
    is pinned by tests/test_pipeline_modes.py; this measures total scans/s.
    Lanes replay the same log tensor (identical-lane timing is valid — the
    device does not dedupe lanes)."""
    from elimaloc_tpu.parallel import replay_fused_fleet
    from elimaloc_tpu.pipeline.runtime import build_fused_batches

    state = pipe.reset()
    pipe._rebase(min(log.imu_t[0], log.scan_t[0]))
    batches = build_fused_batches(log, time_base=pipe.time_base)
    bcast = lambda t: jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (lanes,) + x.shape), t)
    st_b = jax.device_put(bcast(state))
    bt_b = jax.device_put(bcast(batches))
    run = lambda: replay_fused_fleet(st_b, bt_b, pipe.map, pipe.params,
                                     pipe.static)
    jax.block_until_ready(run())  # compile
    dt = min(timed(run)[0] for _ in range(2))
    return lanes * len(log.scan_t) / dt


def _guard(label, fn, default, failed: list):
    """Run an optional bench phase. A failure prints its traceback, appends
    ``label`` to ``failed`` (which makes the exit code non-zero) and yields
    ``default``, so the phases after it still run and report."""
    t0 = time.perf_counter()
    try:
        out = fn()
    except Exception:  # noqa: BLE001 — recorded, reported, exit non-zero
        traceback.print_exc()
        print(f"bench: phase {label!r} FAILED", file=sys.stderr, flush=True)
        failed.append(label)
        return default
    print(f"bench: phase {label!r} done in {time.perf_counter() - t0:.0f}s",
          file=sys.stderr, flush=True)
    return out


def _rnd(v, nd=2):
    return None if v is None else round(v, nd)


def main() -> int:
    if jax.devices()[0].platform != "gpu":
        print(f"bench: no GPU (backend {jax.default_backend()!r}); the "
              "benchmark measures the card and has no CPU fallback",
              file=sys.stderr)
        return 2
    device = device_record()
    failed = []
    t0 = time.perf_counter()
    pipe, log = build_everything()
    print(f"bench: build_everything done in {time.perf_counter() - t0:.0f}s",
          file=sys.stderr, flush=True)
    # host-load proxy: the native baseline is timed BEFORE and AFTER the
    # device phases; the pre/post ratio is the same-session host-load
    # indicator that separates shared-host noise from a real regression
    cpu_native_pre = _guard("cpu_native_pre",
                            lambda: bench_cpu_native(pipe, log), None, failed)
    t0 = time.perf_counter()
    r = bench_headline(pipe, log)  # headline — a failure here SHOULD crash
    print(f"bench: phase 'headline' done in {time.perf_counter() - t0:.0f}s",
          file=sys.stderr, flush=True)
    lat = _guard("latency", lambda: bench_latency(pipe, log), {}, failed)
    roofline = _guard(
        "roofline",
        lambda: bench_roofline(pipe, log, 1e3 / r["scans_per_s"]), None,
        failed)
    stream_sps = _guard("streaming", lambda: bench_streaming(pipe, log), None,
                        failed)
    windowed_sps, window_stats, windowed_applied = _guard(
        "windowed", lambda: bench_windowed(pipe, log), (None, None, None),
        failed)
    icp_sps = _guard("icp_batched", lambda: bench_icp_batched(pipe, log),
                     None, failed)
    ekf_sps = _guard("ekf", lambda: bench_ekf_steps(pipe), None, failed)
    fleet_sps = _guard("fleet", lambda: bench_fleet(pipe, log), None, failed)
    reloc = {} if SKIP_METHODS else _guard("reloc", bench_reloc, {}, failed)
    methods = ({} if SKIP_METHODS
               else _guard("methods", bench_methods, {}, failed))
    cpu_native_post = _guard("cpu_native_post",
                             lambda: bench_cpu_native(pipe, log), None,
                             failed)
    t0 = time.perf_counter()
    cpu_numpy_sps = bench_cpu_numpy(pipe, log)
    print(f"bench: phase 'cpu_numpy' done in {time.perf_counter() - t0:.0f}s",
          file=sys.stderr, flush=True)
    natives = [x for x in (cpu_native_pre, cpu_native_post) if x]
    # the FASTEST native observation is the conservative denominator for the
    # speedup claim (a loaded-host native run would inflate vs_baseline)
    cpu_native_sps = max(natives) if natives else None
    baseline = cpu_native_sps if cpu_native_sps else cpu_numpy_sps
    host_load_ratio = (round(max(natives) / min(natives), 2)
                       if len(natives) == 2 else None)
    print(
        json.dumps(
            {
                "metric": "fused localization scans/sec (128k-pt scans, "
                          "deskew+P2P ICP+EKF)",
                "value": round(r["scans_per_s"], 2),
                "unit": "scans/s",
                "vs_baseline": round(r["scans_per_s"] / baseline, 2),
                "baseline_kind": (
                    "native C++ single-core scan step" if cpu_native_sps
                    else "NumPy single-core scan step"
                ),
                # variance evidence: repeat counts, best AND median per row,
                # raw headline spread, and the pre/post native-baseline
                # host-load proxy
                "repeats": {
                    "headline": HEADLINE_REPEATS,
                    "methods": METHOD_REPEATS,
                    "latency_frames": lat.get("frames"),
                },
                "headline_median_scans_per_s": _rnd(
                    r.get("scans_per_s_median")),
                "headline_run_times_s": r.get("run_times_s"),
                "headline_first_call_s": _rnd(r.get("first_call_s"), 3),
                "cpu_native_scans_per_s": (
                    round(cpu_native_sps, 3) if cpu_native_sps else None
                ),
                "cpu_native_pre_scans_per_s": _rnd(cpu_native_pre, 3),
                "cpu_native_post_scans_per_s": _rnd(cpu_native_post, 3),
                "host_load_ratio": host_load_ratio,
                "cpu_numpy_scans_per_s": round(cpu_numpy_sps, 3),
                "streaming_scans_per_s": _rnd(stream_sps),
                # active-window mode (48 m window / 40 m gate — a separate,
                # smaller workload than the 100 m-gate headline; see
                # bench_windowed): swap machinery folded into the rate
                "windowed_scans_per_s": _rnd(windowed_sps),
                "windowed_applied": _rnd(windowed_applied, 3),
                "window_stats": window_stats,
                # serving mode: 8 vmapped lanes on this one card
                "fleet8_scans_per_s": _rnd(fleet_sps),
                "fleet8_vs_baseline": _rnd(
                    fleet_sps / baseline if fleet_sps else None),
                # one-shot single-frame latency, and the min-of-3
                # device+dispatch floor that strips host hiccups (if p95 -
                # device_p95 is large, the tail is the host, not the device)
                "latency_p50_ms": _rnd(lat.get("p50_ms")),
                "latency_p95_ms": _rnd(lat.get("p95_ms")),
                "latency_device_p50_ms": _rnd(lat.get("device_p50_ms")),
                "latency_device_p95_ms": _rnd(lat.get("device_p95_ms")),
                # measured memory/FMA roofline of the frame:
                # roofline_frac = analytic bound / measured frame time
                "roofline": roofline,
                # cold-registration (relocalization) row: 0.4 m / 5 deg init
                # error at max_iteration=10, corr reuse off vs on
                "reloc": reloc,
                "icp_batched_scans_per_s": _rnd(icp_sps),
                "ekf_steps_per_s": _rnd(ekf_sps, 1),
                "ate_rmse_m": round(r["ate"], 4),
                "ate_tail_m": round(r["ate_tail"], 4),
                "applied_ratio": round(r["applied"], 3),
                "ds_kept_max": r["ds_kept"],
                "ds_budget": r["ds_budget"],
                "ds_headroom": r["ds_headroom"],
                "slots_dropped": r["dropped"],
                "flops_per_scan": round(r["flops_per_scan"]),
                "achieved_tflops": r["achieved_tflops"],
                "host_batch_prep_s": round(r["host_prep"], 3),
                "per_method": methods,
                "failed_phases": failed,
                "device": device,
            }
        )
    )
    return 1 if failed else 0


if __name__ == "__main__":
    from elimaloc_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    sys.exit(main())
