#!/usr/bin/env python
"""Proof that the localization system runs, and computes right, on a GPU.

    python chip_smoke.py               # one card: every phase below
    python chip_smoke.py --devices 4   # four cards: the dp and sp replays

One card drives the public API (README quick start) through five phases:

  device    the backend must be a GPU (there is no CPU fallback); prints the
            card, builds the native map builder with ``make -C native``;
  headline  the ``bench.build_everything`` deployment — 600k-point world,
            131,072-point scans at 10 Hz sampled 1/5, 100 m gate, P2P —
            through ``run_fused``: ATE < 0.1 m, every scan applied, no tile
            slot dropped; compile seconds and scans/s are informative;
  oracle    the per-method log through ``run_fused`` in float32 on the card
            against ``reference_cpu.CpuPipeline`` in float64: trajectory
            RMSE <= 1 cm for P2P and AVGICP+GPS+CAN, and for GICP, VGICP
            and AVGICP in a last phase (``oracle-more``) when the run is
            still well inside its time limit (each case is a fresh compile);
  backends  one headline scan registered with the tile engine and with the
            hash-grid reference: final poses within 1 mm, the same matched
            points at the initial pose;
  modes     ``run_frames``, an 8-lane ``run_fused_fleet`` (each within 1 mm
            of ``run_fused``) and the 48 m active-window
            ``run_frames(chunk=8)`` at a 40 m gate (max < 3 cm, median < 5 mm, last frames < 5 mm of
            the full-map replay, as tests/test_pipeline_modes.py holds it).

``--devices 4`` runs only the multi-card paths and their references, on the
per-method deployment with P2P: a dp replay of four seeded logs (each lane
within 1 mm of its one-card ``run_fused``) and the slot-sharded sp replay
of one log (within 1 cm; the psum order differs).

Each phase prints one line: its seconds and each checked number beside its
limit. A failed check or phase exits 1, a missing GPU exits 2; either way
the final line is not printed. On success the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import traceback

import numpy as np

# Contract limits (metres unless named otherwise).
HEADLINE_ATE_M = 0.1
ORACLE_PARITY_M = 0.01
SAME_PROGRAM_M = 1e-3       # run_frames / fleet / dp lanes vs run_fused
BACKEND_POSE_M = 1e-3       # tile vs hash final pose
BACKEND_DIST_M = 1e-4       # tile vs hash nearest distance (f32 rounding)
SP_REPLAY_M = 0.01          # slot-sharded psum order differs
WINDOW_MAX_M = 0.03         # windowed vs full-map contract
WINDOW_MEDIAN_M = 0.005
WINDOW_TAIL_M = 0.005
FLEET_LANES = 8
# The last oracle cases run only if this many seconds have not yet passed:
# a cold run on an H100 reaches that point at ~665 s and ends at ~830 s,
# so a slower host skips them instead of crossing a 1200 s limit.
MORE_ORACLE_BEFORE_S = 750.0


class Checks:
    """The named comparisons of one phase, each kept with its limit."""

    def __init__(self):
        self.items = []  # (text, ok)

    def _add(self, text, ok):
        self.items.append((text, bool(ok)))
        return bool(ok)

    def at_most(self, name, value, limit):
        value = float(value)
        return self._add(f"{name}={value:.6g}<={limit:g}",
                         np.isfinite(value) and value <= limit)

    def below(self, name, value, limit):
        value = float(value)
        return self._add(f"{name}={value:.6g}<{limit:g}",
                         np.isfinite(value) and value < limit)

    def equal(self, name, value, expected):
        return self._add(f"{name}={value}=={expected}", value == expected)

    def note(self, name, value):
        """An informative number: printed, never failed."""
        if isinstance(value, float):
            value = f"{value:.6g}"
        return self._add(f"{name}={value}", True)

    def fail(self, text):
        return self._add(text, False)

    @property
    def ok(self):
        return all(ok for _, ok in self.items)

    def line(self):
        return " ".join(text if ok else f"{text} FAIL"
                        for text, ok in self.items)


def max_gap_m(a, b):
    """Largest per-frame distance between two [..., n, 3] trajectories."""
    d = np.asarray(a, np.float64) - np.asarray(b, np.float64)
    return float(np.max(np.linalg.norm(d, axis=-1)))


def check_tracks_full(checks, prefix, err):
    """The windowed-vs-full contract over per-frame distances ``err``:
    a bounded transient, sustained sub-centimetre tracking, and
    re-contraction by the end of the log."""
    err = np.asarray(err, np.float64)
    checks.below(f"{prefix}_max_m", np.max(err), WINDOW_MAX_M)
    checks.below(f"{prefix}_median_m", np.median(err), WINDOW_MEDIAN_M)
    checks.below(f"{prefix}_tail_m", np.max(err[-3:]), WINDOW_TAIL_M)


def run_phase(name, fn):
    """Run one phase, print its line, return whether every check held."""
    checks = Checks()
    t0 = time.perf_counter()
    try:
        fn(checks)
    except Exception:  # noqa: BLE001 — reported, and fails the run
        traceback.print_exc()
        checks.fail("exception")
    dt = time.perf_counter() - t0
    status = "ok" if checks.ok else "FAILED"
    print(f"[{name}] {status} {dt:.1f} s | {checks.line()}", flush=True)
    return checks.ok


# --------------------------------------------------------------------------- #
# Phases
# --------------------------------------------------------------------------- #

def phase_device(checks, bench, n_devices):
    import jax
    from elimaloc_tpu.map import native_builder

    devs = jax.devices()
    checks.equal("platform", devs[0].platform, "gpu")
    checks.note("kind", repr(devs[0].device_kind))
    checks.at_most("devices_needed", n_devices, len(devs))
    checks.note("matmul_precision", jax.config.jax_default_matmul_precision)
    nb = bench.ensure_native()
    checks.note("map_builder", "C++" if nb is not None
                and native_builder.maybe_load() is not None else "NumPy")


def phase_headline(checks, bench, pipe, log, card):
    r = bench.bench_headline(pipe, log)
    steady = float(np.median(r["run_times_s"]))
    _, outs = pipe.run_fused(log)
    t_abs = np.asarray(outs["ego_t_abs"])
    ate = bench.ate_rmse(t_abs, np.asarray(outs["ego_pos"]),
                         log.truth_t, log.truth_pos)
    checks.note("scans", len(log.scan_t))
    checks.note("raw_points_per_scan", bench.RAW_POINTS)
    checks.note("points_after_ingest", int(log.scan_points.shape[1]))
    checks.below("ate_m", ate, HEADLINE_ATE_M)
    checks.equal("applied", float(np.asarray(outs["applied"]).mean()), 1.0)
    checks.equal("slots_dropped",
                 int(np.asarray(outs["slots_dropped"]).max()), 0)
    checks.note("compile_s", r["first_call_s"] - steady)
    checks.note("scans_per_s", len(log.scan_t) / steady)
    checks.note("card", repr(card))


def phase_oracle(checks, bench, built, log, cases):
    for method, full_fusion in cases:
        name = bench.case_name(method, full_fusion)
        cfg, pipe = bench.method_pipeline(method, full_fusion, built)
        first_s, (_, outs) = bench.timed(lambda: pipe.run_fused(log))
        ref = bench.oracle_trajectory(cfg, built, log, pipe.time_base)
        checks.at_most(f"{name}_rmse_m",
                       bench.trajectory_rmse(outs["ego_pos"], ref["pos"]),
                       ORACLE_PARITY_M)
        checks.note(f"{name}_applied",
                    float(np.asarray(outs["applied"]).mean()))
        checks.note(f"{name}_first_call_s", first_s)


def phase_backends(checks, bench, pipe, log, k=2):
    import jax
    import jax.numpy as jnp
    from elimaloc_tpu.map import grid as hashgrid
    from elimaloc_tpu.map import tiles
    from elimaloc_tpu.map.grid import voxel_downsample
    from elimaloc_tpu.ops import lie
    from elimaloc_tpu.pipeline import circle_traj
    from elimaloc_tpu.register import make_icp_static, run_register

    ds, dsv, _ = jax.jit(voxel_downsample, static_argnums=3)(
        jnp.asarray(log.scan_points[k], jnp.float32),
        jnp.asarray(log.scan_valid[k]),
        pipe.params.input_voxel_ds, pipe.static.ds_points)
    pos, yaw, _, _, _ = circle_traj(
        np.array([float(log.scan_t[k]) - float(log.imu_t[0])]), ramp=3.0)
    init = np.eye(4, dtype=np.float32)
    c, s = np.cos(yaw[0]), np.sin(yaw[0])
    init[:2, :2] = [[c, -s], [s, c]]
    init[:3, 3] = pos[0] + [0.2, -0.1, 0.02]
    init = jnp.asarray(init)

    hmap = hashgrid.to_device(pipe.built, dtype=jnp.float32)
    st_tile = pipe.static.icp_static
    st_hash = make_icp_static(pipe.cfg.pcm, backend="hash")
    params = pipe.params.icp
    reg = jax.jit(run_register, static_argnums=5)

    # the same correspondences at the initial pose
    q = lie.transform_points(init, ds)
    budget = st_tile.tile_budget
    t_t, v_t = jax.jit(tiles.query_nearest_point, static_argnums=4)(
        pipe.map, q, dsv, params.max_search_dist, budget)
    t_h, v_h, _, _ = jax.jit(hashgrid.query_nearest_point)(
        hmap, q, params.max_search_dist)
    v_t, v_h = np.asarray(v_t), np.asarray(v_h) & np.asarray(dsv)
    checks.note("queries", int(np.asarray(dsv).sum()))
    checks.note("matched_tile", int(v_t.sum()))
    checks.at_most("matched_mismatch", int((v_t != v_h).sum()), 0)
    both = v_t & v_h
    qn = np.asarray(q)
    d_t = np.linalg.norm(np.asarray(t_t) - qn, axis=1)[both]
    d_h = np.linalg.norm(np.asarray(t_h) - qn, axis=1)[both]
    checks.at_most("nearest_dist_gap_m",
                   float(np.max(np.abs(d_t - d_h))) if both.any() else 0.0,
                   BACKEND_DIST_M)

    res = {}
    for name, grid, st in (("tile", pipe.map, st_tile),
                           ("hash", hmap, st_hash)):
        jax.block_until_ready(reg(ds, dsv, grid, init, params, st))
        times = []
        for _ in range(5):
            dt, out = bench.timed(lambda: reg(ds, dsv, grid, init, params, st))
            times.append(dt)
        res[name] = out
        checks.note(f"{name}_ms", 1e3 * float(np.median(times)))
        checks.note(f"{name}_iterations", int(out.iterations))
    checks.at_most("pose_gap_m",
                   max_gap_m(np.asarray(res["tile"].pose)[:3, 3],
                             np.asarray(res["hash"].pose)[:3, 3]),
                   BACKEND_POSE_M)
    checks.equal("both_success",
                 bool(res["tile"].success) and bool(res["hash"].success),
                 True)


def phase_modes(checks, bench, pipe, logs):
    from elimaloc_tpu.pipeline import LocalizationPipeline

    log = logs[0]
    _, ref = pipe.run_fused(log)
    ref_pos = np.asarray(ref["ego_pos"])

    _, frames = pipe.run_frames(log)
    checks.at_most("frames_gap_m", max_gap_m(frames["ego_pos"], ref_pos),
                   SAME_PROGRAM_M)
    checks.note("frames_bitwise",
                bool(np.array_equal(frames["ego_pos"], ref_pos)))

    singles = [np.asarray(pipe.run_fused(lg)[1]["ego_pos"]) for lg in logs]
    _, fleet = pipe.run_fused_fleet(logs)
    lanes = np.asarray(fleet["ego_pos"])
    checks.equal("fleet_lanes", lanes.shape[0], len(logs))
    checks.at_most("fleet_gap_m", max_gap_m(lanes, np.stack(singles)),
                   SAME_PROGRAM_M)
    checks.note("fleet_bitwise",
                bool(np.array_equal(lanes, np.stack(singles))))

    # active window: 48 m window, 40 m gate, so the window covers the
    # sensor range and still swaps over the drive; the full-map reference
    # takes the same gate as a value-only reload (no recompile)
    wcfg = bench._cfg()
    wcfg.pcm.input_max_dist = 40.0
    wpipe = LocalizationPipeline(
        wcfg, pipe._tiles_host_full,
        ds_points=pipe.static.ds_points,
        tile_budget=pipe.static.icp_static.tile_budget,
        ego_ring_size=512, imu_ring_size=256,
        map_window_radius=48.0,
    )
    _, win = wpipe.run_frames(log, chunk=8)
    pipe.reload_config(wcfg)
    _, full40 = pipe.run_fused(log)
    err = np.linalg.norm(np.asarray(win["ego_pos"], np.float64)
                         - np.asarray(full40["ego_pos"], np.float64), axis=1)
    check_tracks_full(checks, "window", err)
    checks.at_most("window_swaps_min", 1, wpipe.window_stats["swaps"])
    checks.note("window_sync_swaps", wpipe.window_stats["sync_swaps"])


def phase_multi(checks, bench, pipe, logs, n_devices):
    import jax
    from elimaloc_tpu.parallel import (
        make_mesh, replay_fused_dp, replay_fused_sp, stack_streams,
    )
    from elimaloc_tpu.pipeline.runtime import build_fused_batches

    checks.at_most("devices_needed", n_devices, len(jax.devices()))
    singles = [np.asarray(pipe.run_fused(lg)[1]["ego_pos"]) for lg in logs]
    batches = []
    for lg in logs:
        tb = float(np.floor(min(lg.imu_t[0], lg.scan_t[0])))
        batches.append(build_fused_batches(lg, time_base=tb))

    mesh_dp = make_mesh(n_devices, dp=n_devices)
    states = stack_streams([pipe.reset() for _ in logs])
    run_dp = lambda: replay_fused_dp(
        states, stack_streams(batches), pipe.map, pipe.params, pipe.static,
        mesh_dp)
    first_s, (_, dp) = bench.timed(run_dp)
    steady_s, _ = bench.timed(run_dp)
    checks.at_most("dp_gap_m", max_gap_m(dp["ego_pos"], np.stack(singles)),
                   SAME_PROGRAM_M)
    checks.note("dp_first_call_s", first_s)
    checks.note("dp_scans_per_s", len(logs) * len(logs[0].scan_t) / steady_s)

    mesh_sp = make_mesh(n_devices, dp=1)
    sp_jit = jax.jit(replay_fused_sp, static_argnums=(4, 5, 6))
    run_sp = lambda: sp_jit(
        pipe.reset(), batches[0], pipe.map, pipe.params, pipe.static,
        mesh_sp, "sp")
    first_s, (_, sp) = bench.timed(run_sp)
    steady_s, _ = bench.timed(run_sp)
    checks.at_most("sp_gap_m", max_gap_m(sp["ego_pos"], singles[0]),
                   SP_REPLAY_M)
    checks.note("sp_first_call_s", first_s)
    checks.note("sp_scans_per_s", len(logs[0].scan_t) / steady_s)


# --------------------------------------------------------------------------- #

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--devices", type=int, choices=(1, 4), default=1,
                    help="4 runs only the multi-card replays")
    args = ap.parse_args(argv)

    t_start = time.perf_counter()
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX backend {devs[0].platform!r}); "
              "refusing to run anywhere else", file=sys.stderr)
        return 2

    import bench
    from elimaloc_tpu.utils.compile_cache import enable_compile_cache

    print(f"compile cache: {enable_compile_cache()}", flush=True)
    card = bench.nvidia_smi()
    print(f"nvidia-smi: {card}", flush=True)
    print(f"jax {jax.__version__}: {len(devs)} x {devs[0].device_kind}",
          flush=True)

    ok = run_phase("device", lambda c: phase_device(c, bench, args.devices))
    t0 = time.perf_counter()
    if args.devices > 1:
        world = bench.methods_world()
        built = bench.methods_map(world)
        logs = [bench.methods_drive(world, seed=8 + i)
                for i in range(args.devices)]
        _, pipe = bench.method_pipeline(bench.IcpMethod.P2P, False, built)
        print(f"setup: per-method deployment built in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        ok &= run_phase("multi", lambda c: phase_multi(
            c, bench, pipe, logs, args.devices))
    else:
        pipe, log = bench.build_everything()
        print(f"setup: headline deployment built in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        ok &= run_phase("headline", lambda c: phase_headline(
            c, bench, pipe, log, card))
        t0 = time.perf_counter()
        built, mlog = bench.methods_log()
        print(f"setup: per-method deployment built in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        first, *more, last = bench.METHOD_CASES
        ok &= run_phase("oracle", lambda c: phase_oracle(
            c, bench, built, mlog, (first, last)))
        ok &= run_phase("backends", lambda c: phase_backends(
            c, bench, pipe, log))
        world = bench.headline_world()
        logs = [log] + [bench.headline_log(world, seed=4 + i)
                        for i in range(1, FLEET_LANES)]
        ok &= run_phase("modes", lambda c: phase_modes(c, bench, pipe, logs))
        elapsed = time.perf_counter() - t_start
        if elapsed < MORE_ORACLE_BEFORE_S:
            ok &= run_phase("oracle-more", lambda c: phase_oracle(
                c, bench, built, mlog, more))
        else:
            print(f"[oracle-more] skipped: {elapsed:.0f} s elapsed "
                  f"(runs before {MORE_ORACLE_BEFORE_S:.0f} s)", flush=True)

    if not ok:
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
