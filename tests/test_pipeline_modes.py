"""Pipeline mode coverage: GPS fusion, non-IMU tick mode, hot reload."""

import copy

import jax.numpy as jnp
import numpy as np
import pytest

from elimaloc_tpu.config import ElimalocConfig, GpsType, IcpMethod
from elimaloc_tpu.map import TileQueryBudget
from elimaloc_tpu.pipeline import (
    LocalizationPipeline,
    ate_rmse,
    make_world,
    synthesize_log,
)



pytestmark = pytest.mark.slow  # every test builds/replays a pipeline

def tiny_pipe(gps_hz=1.0, duration=3.0, **ekf_overrides):
    world = make_world(seed=9, extent=70.0, n_ground=60_000, n_wall=30_000)
    log = synthesize_log(
        world, duration=duration, points_per_scan=1024, max_range=50.0,
        seed=10, gps_hz=gps_hz,
    )
    cfg = ElimalocConfig()
    cfg.pcm.icp_method = IcpMethod.P2P
    cfg.pcm.input_voxel_ds_m = 1.0
    cfg.pcm.lidar_time_delay = 0.0
    cfg.ekf.ekf_init_x_m = 60.0
    cfg.ekf.ekf_init_yaw_deg = 90.0
    cfg.calib.ego_to_lidar_trans = (0.0, 0.0, 0.0)
    cfg.calib.ego_to_lidar_rot_deg = (0.0, 0.0, 0.0)
    for k, v in ekf_overrides.items():
        setattr(cfg.ekf, k, v)
    pipe = LocalizationPipeline(
        cfg, world, ds_points=1024,
        tile_budget=TileQueryBudget(qb=8, max_slots=1024),
        use_native=False, ego_ring_size=128, imu_ring_size=128,
    )
    return pipe, log


class TestGpsFusion:
    def test_navsatfix_fuses_with_pcm(self):
        # GPS-only is a degenerate config in the reference too: NavSatFix
        # carries no yaw, so the filter never passes CheckStateInitialized
        # and predictions stay blocked (yaw comes from PCM or the dead
        # BESTVEL path). Fuse GPS alongside PCM instead and require that the
        # extra (noisy, min-cov-inflated) fixes do not degrade tracking.
        pipe, log = tiny_pipe(gps_hz=10.0, use_gps=True,
                              gps_type=GpsType.NAVSATFIX)
        state, traj = pipe.run(log)
        tail = traj["t"] > log.scan_t[0] + 2.0
        ate = ate_rmse(traj["t"][tail], traj["pos"][tail],
                       log.truth_t, log.truth_pos)
        assert ate < 0.5, f"GPS+PCM ATE {ate}"

    def test_bestpos_source_flows(self):
        pipe, log = tiny_pipe(use_gps=True, gps_type=GpsType.BESTPOS)
        state = pipe.reset()
        t = jnp.float32(0.5)
        s2 = pipe._gps_step(
            state, t, jnp.asarray([60.0, 0.1, 0.0], jnp.float32),
            jnp.asarray([0.3, 0.3, 0.3], jnp.float32),
        )
        # an accepted 3-DOF update shrinks the position covariance
        assert float(s2.ekf.P[0, 0]) < float(state.ekf.P[0, 0])

    def test_gate_rejects_uncertain_fix(self):
        pipe, log = tiny_pipe(use_gps=True, gnss_uncertainty_max_m=0.5)
        state = pipe.reset()
        s2 = pipe._gps_step(
            state, jnp.float32(0.5), jnp.asarray([60.0, 0.0, 0.0], jnp.float32),
            jnp.asarray([5.0, 5.0, 5.0], jnp.float32),  # squared -> 25 > 0.5
        )
        np.testing.assert_array_equal(np.asarray(s2.ekf.P), np.asarray(state.ekf.P))


def test_tick_mode_without_imu():
    pipe, log = tiny_pipe(use_imu=False)
    assert pipe.static.use_imu is False
    state, traj = pipe.run(log)
    # CA-model predictions + PCM updates still localize coarsely.
    tail = traj["t"] > log.scan_t[0] + 2.0
    ate = ate_rmse(traj["t"][tail], traj["pos"][tail],
                   log.truth_t, log.truth_pos)
    assert ate < 2.0, f"tick-mode ATE {ate}"


def test_reload_config_swaps_params_without_losing_state():
    pipe, log = tiny_pipe()
    state = pipe.reset()
    state = pipe._imu_step(
        state, jnp.float32(0.01), jnp.asarray([0.0, 0, 9.81], jnp.float32),
        jnp.zeros(3, jnp.float32),
    )
    old_max = float(pipe.params.icp.max_search_dist)
    cfg2 = copy.deepcopy(pipe.cfg)
    cfg2.pcm.max_search_dist = 2.5
    cfg2.ekf.use_zupt = True  # static flag change -> re-jit
    pipe.reload_config(cfg2)
    assert float(pipe.params.icp.max_search_dist) == 2.5 != old_max
    assert pipe.static.ekf_flags.use_zupt is True
    # state pytree remains valid with the new handlers
    state = pipe._imu_step(
        state, jnp.float32(0.02), jnp.asarray([0.0, 0, 9.81], jnp.float32),
        jnp.zeros(3, jnp.float32),
    )
    assert np.isfinite(np.asarray(state.ekf.P)).all()


def test_ini_hot_reload_mid_replay(tmp_path):
    """The run loops poll a ConfigWatcher per frame (the
    reference's ProcessINI-per-IMU-callback, ekf_localization.cpp:141).
    Editing the ini mid-replay must swap continuous params WITHOUT losing
    filter state and WITHOUT re-jitting (value-only changes hit the live
    trace cache)."""
    import os

    from elimaloc_tpu.config import export_ini

    pipe, log = tiny_pipe(duration=3.0)
    ini = tmp_path / "localization.ini"
    export_ini(pipe.cfg, str(ini))
    pipe.watch_config(str(ini))
    jits_before = pipe._jits
    old_max = float(pipe.params.icp.max_search_dist)
    assert old_max != 3.75
    n_scans = len(log.scan_t)
    progress = {"k": 0, "edited_at": None}

    def on_scan(out):
        progress["k"] += 1
        if progress["k"] == n_scans // 2 and progress["edited_at"] is None:
            cfg2 = copy.deepcopy(pipe.cfg)
            cfg2.pcm.max_search_dist = 3.75
            export_ini(cfg2, str(ini))
            st = os.stat(str(ini))
            os.utime(str(ini), ns=(st.st_atime_ns, st.st_mtime_ns + 1))
            progress["edited_at"] = progress["k"]

    state, outs = pipe.run_frames(log, on_scan=on_scan)
    assert progress["edited_at"] is not None
    assert float(pipe.params.icp.max_search_dist) == 3.75
    # value-only swap: the jitted programs are the SAME objects (no re-jit)
    assert pipe._jits is jits_before
    # filter state survived the swap: the replay kept localizing across it
    pos = np.asarray(outs["ego_pos"])
    assert np.isfinite(pos).all()
    tail = np.asarray(outs["ego_t_abs"]) > log.scan_t[0] + 2.0
    ate = ate_rmse(np.asarray(outs["ego_t_abs"])[tail], pos[tail],
                   log.truth_t, log.truth_pos)
    assert ate < 0.5, f"post-reload ATE {ate}"


def test_dashboard_emits_during_run(capsys):
    """debug_print streams the 1 Hz (sim-time) sigma/config
    dashboard during replay (PrintState from the reference's 1 s timer,
    ekf_algorithm.cpp:176-180)."""
    pipe, log = tiny_pipe(duration=3.0)
    pipe.cfg.ekf.debug_print = True
    pipe.run_frames(log)
    text = capsys.readouterr().out
    # each dashboard frame is fenced by two 40-dash rules
    assert text.count("-" * 40) >= 4, "expected >=2 dashboard frames in 3 s"
    assert "State Std" in text and "Yaw" in text


def test_vgicp_end_to_end():
    """The full fused loop with the voxelized matcher (BASELINE config 4)."""
    pipe, log = tiny_pipe()
    cfg = copy.deepcopy(pipe.cfg)
    cfg.pcm.icp_method = IcpMethod.VGICP
    cfg.pcm.max_fitness_score = 2.0  # fitness ~ |r| to voxel means
    world = make_world(seed=9, extent=70.0, n_ground=60_000, n_wall=30_000)
    vpipe = LocalizationPipeline(
        cfg, world, ds_points=1024,
        tile_budget=TileQueryBudget(qb=8, max_slots=1024),
        use_native=False, ego_ring_size=128, imu_ring_size=128,
    )
    state, outs = vpipe.run_fused(log)
    applied = np.asarray(outs["applied"])
    assert applied[5:].mean() > 0.8
    t_abs = np.asarray(outs["ego_t_abs"])
    tail = t_abs > log.scan_t[0] + 2.0
    ate = ate_rmse(t_abs[tail], np.asarray(outs["ego_pos"])[tail],
                   log.truth_t, log.truth_pos)
    assert ate < 0.6, f"VGICP fused ATE {ate}"


def test_fused_matches_host_with_gps_and_can():
    pipe, log = tiny_pipe(gps_hz=5.0, duration=2.0, use_gps=True, use_can=True)
    _, traj = pipe.run(log)
    _, outs = pipe.run_fused(log)
    # The fused mode batches events per scan frame (imu -> can -> gps ->
    # scan, replay_fused docstring) while the host loop interleaves in
    # strict time order, so trajectories agree only to the ordering skew.
    np.testing.assert_allclose(
        traj["pos"][-1], np.asarray(outs["ego_pos"])[-1], atol=0.15
    )


def test_run_frames_matches_fused():
    """The frame-streamed online mode is the same program as the fused
    replay, dispatched one frame at a time; results must match bit-tight."""
    pipe, log = tiny_pipe(duration=2.0)
    _, of = pipe.run_fused(log)
    _, osf = pipe.run_frames(log)
    np.testing.assert_allclose(
        np.asarray(of["ego_pos"]), osf["ego_pos"], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(np.asarray(of["applied"]), osf["applied"])


def _assert_tracks_full(err, label):
    """Windowed-vs-full trajectory contract.

    The two pipelines compute in different f32 coordinate representations
    (window-local origin vs global), so they differ at the ulp level from
    the first frame — bit-equality is unachievable (origin subtraction
    cannot be exact for points near the global origin). The ICP<->EKF
    closed loop amplifies those ulps through discrete decisions (GN
    iteration-count / gate flips) into occasional cm-scale single-frame
    transients that the loop then contracts away (measured on this log:
    peak 1.48 cm at one frame, back to 1.5 mm within 8 frames, after an
    unrelated EKF f32 rounding-order change re-rolled the dice). The
    invariants that ARE the contract: bounded transient, sustained
    sub-centimeter tracking, and re-contraction by the end of the log.
    """
    assert float(np.max(err)) < 0.03, f"{label} max diff {err.max()}"
    assert float(np.median(err)) < 0.005, (
        f"{label} median diff {np.median(err)}")
    assert float(np.max(err[-3:])) < 0.005, (
        f"{label} tail diff {err[-3:]} (no re-contraction)")


@pytest.mark.parametrize("prefetch", ["off", "forced"])
def test_windowed_map_replay_matches_full(prefetch):
    """Active-window mode (map_window_radius): the drive crosses window
    boundaries (several re-crops) and the trajectory must track the
    full-map pipeline (see _assert_tracks_full for the exact contract).
    The "forced" variant waits for the async prefetch worker before every
    potential swap, so every boundary crossing MUST be served by the
    double-buffered prefetched window and still track the full map."""
    world = make_world(seed=9, extent=70.0, n_ground=60_000, n_wall=30_000)
    log = synthesize_log(
        world, duration=3.0, points_per_scan=1024, max_range=40.0,
        seed=10,
    )
    cfg = ElimalocConfig()
    cfg.pcm.input_voxel_ds_m = 1.0
    cfg.ekf.ekf_init_x_m = 60.0
    cfg.ekf.ekf_init_y_m = 0.0
    cfg.ekf.ekf_init_yaw_deg = 90.0
    cfg.calib.ego_to_lidar_trans = (0.0, 0.0, 0.0)
    cfg.calib.ego_to_lidar_rot_deg = (0.0, 0.0, 0.0)
    cfg.pcm.lidar_time_delay = 0.0
    kw = dict(ds_points=1024,
              tile_budget=TileQueryBudget(qb=32, max_slots=512),
              use_native=False, ego_ring_size=128, imu_ring_size=128)
    full = LocalizationPipeline(cfg, world, **kw)
    _, traj_full = full.run(log)

    win = LocalizationPipeline(cfg, world, map_window_radius=48.0,
                               map_window_prefetch=(prefetch == "forced"),
                               **kw)
    assert win._host_tmap is not None
    if prefetch == "forced":
        orig_start = win._start_prefetch

        def start_and_wait(pos_xy):
            orig_start(pos_xy)
            if win._prefetch is not None:
                win._prefetch["done"].wait()

        win._start_prefetch = start_and_wait
    centers = []
    orig = win._maybe_rewindow

    def spy(pos_xy, vel_xy=None):
        before = tuple(win._window_center)
        orig(pos_xy, vel_xy)
        if tuple(win._window_center) != before:
            centers.append(tuple(win._window_center))

    win._maybe_rewindow = spy
    _, traj_win = win.run(log)
    assert len(centers) >= 1, "drive should cross a window boundary"

    err = np.linalg.norm(traj_full["pos"] - traj_win["pos"], axis=1)
    _assert_tracks_full(err, "windowed-vs-full")
    if prefetch == "forced":
        assert win.window_stats["swaps"] >= 1
        assert win.window_stats["sync_swaps"] == 0, win.window_stats
        assert win.window_stats["prefetch_hits"] == win.window_stats["swaps"]

    # windowed run_fused = CHUNKED fused replay (replay_fused_chunk): one
    # compiled chunk program, window management between chunks. Must match
    # the full-map trajectory like the streaming mode does (the chunk-stale
    # window ladder is absorbed by the window margin), across a chunk size
    # that divides the log and one that leaves a ragged final chunk.
    for chunk in (4, 7):
        win2 = LocalizationPipeline(cfg, world, map_window_radius=48.0,
                                    map_window_prefetch=(prefetch == "forced"),
                                    **kw)
        _, of = win2.run_fused(log, window_chunk=chunk)
        assert of["ego_pos"].shape[0] == len(log.scan_t)
        err = np.linalg.norm(traj_full["pos"] - of["ego_pos"], axis=1)
        _assert_tracks_full(err, f"windowed-fused(chunk={chunk})-vs-full")


def test_fleet_lanes_match_single_stream():
    """run_fused_fleet = vmapped lanes of run_fused: each lane's trajectory
    must match its own single-stream replay (different logs per lane, with
    different per-frame sub-batch capacities to exercise the fleet padding).
    """
    pipe, log_a = tiny_pipe(duration=2.0)
    world = make_world(seed=9, extent=70.0, n_ground=60_000, n_wall=30_000)
    log_b = synthesize_log(
        world, duration=2.0, points_per_scan=1024, max_range=50.0, seed=77,
    )
    _, oa = pipe.run_fused(log_a)
    _, ob = pipe.run_fused(log_b)
    _, fleet = pipe.run_fused_fleet([log_a, log_b])
    pos = np.asarray(fleet["ego_pos"])
    np.testing.assert_allclose(pos[0], np.asarray(oa["ego_pos"]),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(pos[1], np.asarray(ob["ego_pos"]),
                               rtol=0, atol=1e-6)
    np.testing.assert_array_equal(
        np.asarray(fleet["applied"])[0], np.asarray(oa["applied"]))
    np.testing.assert_array_equal(
        np.asarray(fleet["applied"])[1], np.asarray(ob["applied"]))
    assert fleet["ego_t_abs"].shape == pos.shape[:2]
