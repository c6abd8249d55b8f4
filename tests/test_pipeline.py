"""Pipeline tests: rings, covariance shaping, and end-to-end replay."""

import jax.numpy as jnp
import numpy as np
import pytest

from elimaloc_tpu.config import ElimalocConfig, IcpMethod
from elimaloc_tpu.map import TileQueryBudget
from elimaloc_tpu.pipeline import (
    LocalizationPipeline,
    ReplayLog,
    ate_rmse,
    get_interpolated_pose,
    gnss_time_compensation,
    make_ego_ring,
    make_imu_ring,
    make_world,
    push_ego,
    push_imu,
    shape_icp_covariance,
    synthesize_log,
)
from elimaloc_tpu.ops import lie

import ref_numpy as ref

RNG = np.random.default_rng(41)


class TestRings:
    def test_push_and_dedupe(self):
        r = make_ego_ring(8, jnp.float64)
        z = jnp.zeros(3, jnp.float64)
        r = push_ego(r, jnp.float64(1.0), z + 1, z, z, z)
        r = push_ego(r, jnp.float64(1.0), z + 2, z, z, z)  # same t: rejected
        assert int(r.count) == 1
        np.testing.assert_array_equal(np.asarray(r.pos[0]), [1, 1, 1])
        r = push_ego(r, jnp.float64(1.1), z + 2, z, z, z)
        assert int(r.count) == 2

    def test_regression_clears(self):
        r = make_ego_ring(8, jnp.float64)
        z = jnp.zeros(3, jnp.float64)
        for t in (1.0, 2.0, 3.0):
            r = push_ego(r, jnp.float64(t), z, z, z, z)
        assert int(r.count) == 3
        r = push_ego(r, jnp.float64(1.5), z + 9, z, z, z)
        assert int(r.count) == 1
        assert float(r.t[0]) == 1.5

    def test_capacity_rolls(self):
        r = make_imu_ring(4, jnp.float64)
        z = jnp.zeros(3, jnp.float64)
        for t in range(1, 7):
            r = push_imu(r, jnp.float64(t), z + t, z)
        assert int(r.count) == 4
        np.testing.assert_allclose(np.asarray(r.t), [3, 4, 5, 6])

    def test_batch_push_matches_sequential(self):
        """rings._push_arrays_batch == M sequential pushes, across empty
        rings, eps-duplicates, invalid rows, capacity overflow, and a
        first-sample regression (its stated precondition: nondecreasing t
        over valid rows)."""
        from elimaloc_tpu.pipeline.rings import push_ego_batch, push_imu_batch

        rng = np.random.default_rng(5)
        for trial in range(30):
            m = int(rng.integers(1, 9))
            cap = int(rng.integers(m, 13))  # precondition: M <= capacity
            # pre-fill 0..cap existing entries at increasing times
            n0 = int(rng.integers(0, cap + 1))
            r_seq = make_ego_ring(cap, jnp.float64)
            z = jnp.zeros(3, jnp.float64)
            for i in range(n0):
                r_seq = push_ego(r_seq, jnp.float64(i * 0.5), z + i, z, z, z)
            r_bat = r_seq
            # batch: sorted times, some duplicated (eps reject), some
            # invalid; occasionally start BEFORE the ring's last (regress)
            start = (n0 - 1) * 0.5 + (0.3 if rng.random() < 0.7 else -0.4)
            ts = np.sort(start + np.cumsum(
                rng.choice([0.0, 0.25], size=m, p=[0.3, 0.7])))
            valid = rng.random(m) < 0.8
            vals = rng.normal(size=(m, 3))
            for i in range(m):
                if valid[i]:
                    r_seq = push_ego(r_seq, jnp.float64(ts[i]),
                                     jnp.asarray(vals[i]), z, z, z)
            r_bat = push_ego_batch(
                r_bat, jnp.asarray(ts), jnp.asarray(vals),
                jnp.zeros((m, 3)), jnp.zeros((m, 3)), jnp.zeros((m, 3)),
                jnp.asarray(valid))
            assert int(r_bat.count) == int(r_seq.count), (trial, ts, valid)
            c = int(r_seq.count)
            np.testing.assert_array_equal(
                np.asarray(r_bat.t[:c]), np.asarray(r_seq.t[:c]))
            np.testing.assert_array_equal(
                np.asarray(r_bat.pos[:c]), np.asarray(r_seq.pos[:c]))
        # imu ring smoke (eps=0 path)
        ri_s = make_imu_ring(6, jnp.float64)
        ri_b = ri_s
        ts = jnp.asarray([0.1, 0.1, 0.2, 0.3])
        g = jnp.arange(12.0).reshape(4, 3)
        for i in range(4):
            ri_s = push_imu(ri_s, ts[i], g[i], g[i])
        ri_b = push_imu_batch(ri_b, ts, g, g, jnp.ones(4, bool))
        assert int(ri_b.count) == int(ri_s.count)
        np.testing.assert_array_equal(np.asarray(ri_b.gyro),
                                      np.asarray(ri_s.gyro))

    def test_batch_push_overflow_beyond_capacity(self):
        """M > capacity degrades like M sequential rolling pushes (the old
        trace-time assert made fused tracing fail where the per-sample path
        rolled gracefully)."""
        from elimaloc_tpu.pipeline.rings import push_imu_batch

        cap, m = 5, 9
        ri_s = make_imu_ring(cap, jnp.float64)
        ri_b = ri_s
        ts = jnp.asarray(np.linspace(0.1, 0.9, m))
        g = jnp.arange(3.0 * m).reshape(m, 3)
        for i in range(m):
            ri_s = push_imu(ri_s, ts[i], g[i], g[i])
        ri_b = push_imu_batch(ri_b, ts, g, g, jnp.ones(m, bool))
        assert int(ri_b.count) == int(ri_s.count) == cap
        np.testing.assert_array_equal(np.asarray(ri_b.t), np.asarray(ri_s.t))
        np.testing.assert_array_equal(np.asarray(ri_b.gyro),
                                      np.asarray(ri_s.gyro))

    def test_imu_subbatch_matches_sequential_steps(self):
        """runtime.imu_subbatch == scanning imu_step per sample (the fused
        frame's IMU chain was restructured for launch count; the
        trajectory-visible state must be unchanged)."""
        import jax

        from elimaloc_tpu.pipeline.runtime import (
            _select_state, imu_step, imu_subbatch,
        )

        world = make_world(seed=3, extent=60.0, n_ground=40_000,
                           n_wall=20_000)
        cfg = ElimalocConfig()
        pipe = LocalizationPipeline(
            cfg, world, ds_points=512,
            tile_budget=TileQueryBudget(qb=8, max_slots=256),
            use_native=False, ego_ring_size=32, imu_ring_size=16,
        )
        st = pipe.reset()
        rng = np.random.default_rng(9)
        m = 7
        b = {
            "imu_t": jnp.asarray(0.01 + np.arange(m) * 0.01, pipe.dtype),
            "imu_acc": jnp.asarray(
                rng.normal([0, 0, 9.81], 0.05, (m, 3)), pipe.dtype),
            "imu_gyro": jnp.asarray(rng.normal(0, 0.02, (m, 3)), pipe.dtype),
            "imu_valid": jnp.asarray([True] * 5 + [False] * 2),
        }
        seq = st
        for i in range(m):
            s2 = imu_step(seq, b["imu_t"][i], b["imu_acc"][i],
                          b["imu_gyro"][i], pipe.params, pipe.static)
            seq = _select_state(b["imu_valid"][i], s2, seq)
        bat = imu_subbatch(st, b, pipe.params, pipe.static)
        for name in ("pos", "rot", "vel", "P", "prev_timestamp"):
            np.testing.assert_allclose(
                np.asarray(getattr(bat.ekf, name)),
                np.asarray(getattr(seq.ekf, name)), rtol=0, atol=1e-12,
                err_msg=name)
        assert int(bat.ego_ring.count) == int(seq.ego_ring.count)
        assert int(bat.imu_ring.count) == int(seq.imu_ring.count)
        for ring in ("ego_ring", "imu_ring"):
            for leaf in ("t",):
                np.testing.assert_allclose(
                    np.asarray(getattr(getattr(bat, ring), leaf)),
                    np.asarray(getattr(getattr(seq, ring), leaf)),
                    atol=1e-12, err_msg=f"{ring}.{leaf}")
        np.testing.assert_allclose(
            np.asarray(bat.ego_ring.pos), np.asarray(seq.ego_ring.pos),
            atol=1e-12)
        np.testing.assert_allclose(
            np.asarray(bat.ego_ring.rpy), np.asarray(seq.ego_ring.rpy),
            atol=1e-6)
        np.testing.assert_allclose(
            np.asarray(bat.ego_ring.vel_local),
            np.asarray(seq.ego_ring.vel_local), atol=1e-6)
        np.testing.assert_allclose(
            np.asarray(bat.imu_ring.gyro), np.asarray(seq.imu_ring.gyro),
            atol=1e-7)

    def test_interpolated_pose(self):
        r = make_ego_ring(16, jnp.float64)
        z = jnp.zeros(3, jnp.float64)
        # Straight line at 2 m/s in +x, yaw 0
        for t in np.arange(0.0, 1.01, 0.25):
            r = push_ego(
                r, jnp.float64(t), jnp.asarray([2 * t, 0, 0.0]), z,
                jnp.asarray([2.0, 0, 0]), z,
            )
        pose, found = get_interpolated_pose(r, jnp.float64(0.6))
        assert bool(found)
        np.testing.assert_allclose(
            np.asarray(pose)[:3, 3], [1.2, 0, 0], atol=1e-9
        )
        # Extrapolation past the last sample uses local velocity
        pose, found = get_interpolated_pose(r, jnp.float64(1.5))
        assert bool(found)
        np.testing.assert_allclose(np.asarray(pose)[:3, 3], [3.0, 0, 0], atol=1e-9)
        # Before the first sample: not found
        _, found = get_interpolated_pose(r, jnp.float64(-0.5))
        assert not bool(found)

    def test_latency_compensation(self):
        r = make_ego_ring(16, jnp.float64)
        z = jnp.zeros(3, jnp.float64)
        for t in np.arange(0.0, 1.01, 0.1):
            r = push_ego(
                r, jnp.float64(t), jnp.asarray([3 * t, 0, 0.0]),
                jnp.asarray([0.0, 0, 0.1 * t]), z, z,
            )
        # measurement 0.3 s old: shift by the state delta over that window
        t2, p2, q2, ok = gnss_time_compensation(
            r, jnp.float64(0.7), jnp.asarray([2.0, 0.0, 0.0]),
            lie.quat_identity(jnp.float64),
        )
        assert bool(ok)
        assert float(t2) == pytest.approx(1.0)
        # closest = first state after 0.7 (t=0.8); ratio = 0.3/0.2 (reference
        # semantics), dx = (3.0-2.4)*1.5 = 0.9
        assert float(p2[0]) == pytest.approx(2.0 + 0.9, abs=1e-9)
        # empty ring fails
        r0 = make_ego_ring(4, jnp.float64)
        _, _, _, ok0 = gnss_time_compensation(
            r0, jnp.float64(0.5), jnp.zeros(3), lie.quat_identity(jnp.float64)
        )
        assert not bool(ok0)


class TestCovShaping:
    def test_golden(self):
        local_cov = np.diag([0.5, 1.0, 2.0, 0.01, 0.02, 0.04])
        rot = ref.euler_to_rot([0.0, 0.0, 0.4])
        fitness = 0.1  # below floor -> std = 0.25
        pc, rc = shape_icp_covariance(
            jnp.asarray(rot), jnp.asarray(local_cov), jnp.asarray(fitness)
        )
        t_cov = rot @ local_cov[:3, :3] @ rot.T
        norm_t = np.minimum(t_cov / t_cov.diagonal().min(), 5.0)
        np.testing.assert_allclose(np.asarray(pc), norm_t * 0.25**2, atol=1e-9)
        r_cov = local_cov[3:, 3:]
        norm_r = np.minimum(r_cov / r_cov.diagonal().min(), 5.0)
        angle_std = 0.25 * np.pi / 180
        np.testing.assert_allclose(np.asarray(rc), norm_r * angle_std**2, atol=1e-12)

    def test_tiny_diagonal_guard(self):
        local_cov = np.eye(6) * 1e-12
        pc, _ = shape_icp_covariance(
            jnp.eye(3), jnp.asarray(local_cov), jnp.asarray(1.0)
        )
        assert np.isfinite(np.asarray(pc)).all()


def small_setup(method=IcpMethod.P2P, duration=4.0, seed=5):
    world = make_world(seed=seed, extent=90.0, n_ground=120_000, n_wall=60_000)
    log = synthesize_log(
        world, duration=duration, points_per_scan=2048, max_range=60.0,
        seed=seed + 1, imu_noise_gyro=0.001, imu_noise_acc=0.01,
    )
    cfg = ElimalocConfig()
    cfg.pcm.icp_method = method
    cfg.pcm.input_voxel_ds_m = 1.0
    cfg.ekf.ekf_init_x_m = 60.0
    cfg.ekf.ekf_init_y_m = 0.0
    cfg.ekf.ekf_init_yaw_deg = 90.0
    # synthetic scans are generated in the ego frame: identity extrinsics,
    # and the log has no sensor output delay
    cfg.calib.ego_to_lidar_trans = (0.0, 0.0, 0.0)
    cfg.calib.ego_to_lidar_rot_deg = (0.0, 0.0, 0.0)
    cfg.pcm.lidar_time_delay = 0.0
    pipe = LocalizationPipeline(
        cfg, world, ds_points=2048,
        tile_budget=TileQueryBudget(qb=32, max_slots=768),
        use_native=False, ego_ring_size=256, imu_ring_size=128,
    )
    return pipe, log, world


@pytest.mark.slow
class TestEndToEnd:
    def test_fused_replay_tracks_truth(self):
        # The cold-started EKF (P = 100 I, static initial guess, moving
        # vehicle, IMU biases) takes ~3.5 s to converge; measure the tail.
        pipe, log, _ = small_setup(duration=6.0)
        state, outs = pipe.run_fused(log)
        applied = np.asarray(outs["applied"])
        assert applied[5:].mean() > 0.8, "most scans should apply"
        t_abs = np.asarray(outs["ego_t_abs"])
        tail = t_abs > log.scan_t[0] + 4.0
        ate = ate_rmse(
            t_abs[tail], np.asarray(outs["ego_pos"])[tail],
            log.truth_t, log.truth_pos,
        )
        assert ate < 0.25, f"converged ATE {ate}"

    def test_fused_replay_matches_host_loop(self):
        pipe, log, _ = small_setup(duration=2.0)
        _, traj = pipe.run(log)
        state_f, outs = pipe.run_fused(log)
        pos_f = np.asarray(outs["ego_pos"])
        # host-loop trajectory records after each scan; compare final frames
        np.testing.assert_allclose(
            traj["pos"][-1], pos_f[-1], atol=1e-4
        )

    def test_initialize_at_relocalizes(self):
        pipe, log, world = small_setup(duration=2.0)
        state = pipe.reset()
        # feed some IMU so the rings have context
        state, ok = pipe.initialize_at(
            state, 61.0, 0.5, np.pi / 2 * 0.98,
            log.scan_points[0], log.scan_valid[0], log.scan_t[0],
        )
        assert ok
        assert bool(state.ekf.pcm_init_on_going)
        # Coarse relocalization: the raw (motion-distorted) scan is matched,
        # exactly like the reference's init flow; compare against the truth at
        # the scan stamp with a smear-sized tolerance.
        pos = np.asarray(state.ekf.pos)
        assert np.linalg.norm(pos[:2] - log.truth_pos[0][:2]) < 1.5


def test_log_save_load_roundtrip(tmp_path):
    world = make_world(seed=0, extent=40.0, n_ground=5000, n_wall=2000)
    log = synthesize_log(world, duration=1.0, points_per_scan=256)
    p = str(tmp_path / "log.npz")
    log.save(p)
    log2 = ReplayLog.load(p)
    np.testing.assert_array_equal(log.imu_t, log2.imu_t)
    np.testing.assert_array_equal(log.scan_points, log2.scan_points)
    np.testing.assert_array_equal(log.truth_pos, log2.truth_pos)


def test_fused_batches_nonmonotonic_arrival():
    """Jittered sweeps can deliver scans out of header order: scan A stamped
    10.00 whose last point is +0.12 arrives AFTER scan B stamped 10.05 with
    last point +0.05. Bucketing must follow arrival order (searchsorted over
    an unsorted array would silently mis-bucket events)."""
    from elimaloc_tpu.pipeline.runtime import (
        build_fused_batches,
        scan_arrival_times,
    )

    n = 16
    scan_points = np.zeros((2, n, 3), np.float32)
    scan_valid = np.ones((2, n), bool)
    scan_times = np.stack([
        np.linspace(0.0, 0.12, n).astype(np.float32),   # arrival 10.12
        np.linspace(0.0, 0.05, n).astype(np.float32),   # arrival 10.10
    ])
    imu_t = np.array([10.02, 10.07, 10.11, 10.115, 10.125])
    log = ReplayLog(
        imu_t=imu_t,
        imu_acc=np.zeros((5, 3)),
        imu_gyro=np.zeros((5, 3)),
        scan_t=np.array([10.00, 10.05]),
        scan_points=scan_points,
        scan_times=scan_times,
        scan_valid=scan_valid,
    )
    arrival = scan_arrival_times(log)
    np.testing.assert_allclose(arrival, [10.12, 10.10])
    b = build_fused_batches(log, time_base=10.0)
    # frames are processed in ARRIVAL order: frame 0 == the scan arriving at
    # 10.10 (header 10.05), frame 1 == 10.12 (header 10.00)
    np.testing.assert_allclose(np.asarray(b["scan_t"]), [0.05, 0.00],
                               atol=1e-6)
    # imu events at 10.02/10.07 precede the first arrival; 10.11/10.115 fall
    # between the arrivals -> frame 1; 10.125 is after the last arrival and
    # is dropped (no frame to attach to)
    v = np.asarray(b["imu_valid"])
    t = np.asarray(b["imu_t"])
    frame0 = sorted(t[0][v[0]])
    frame1 = sorted(t[1][v[1]])
    np.testing.assert_allclose(frame0, [0.02, 0.07], atol=1e-6)
    np.testing.assert_allclose(frame1, [0.11, 0.115], atol=1e-6)
