"""Oracle-parity tests.

1. Quarantine golden: the jitted EKF stepped THROUGH a PCM_INIT -> release
   window matches the float64 CpuEkf oracle at every intermediate state,
   pinning the prev_timestamp / warm-up-counter semantics
   (ekf_algorithm.cpp:81-194, 318-364).
2. Trajectory parity: the full JAX pipeline (float64, host event loop) vs
   the CpuPipeline oracle on the same log — the closed-loop analog of the
   per-step golden tests.
3. Byte-level end-to-end: PCD map on disk + Ouster-packed scan bytes through
   convert_scan -> LocalizationPipeline, mirroring the reference's ingest
   path (pcm_matching.cpp:69-79, 198-224, 900-930).
"""

import numpy as np
import jax.numpy as jnp
import pytest

from elimaloc_tpu.config import ElimalocConfig, GnssSource, IcpMethod
from elimaloc_tpu.ekf import (
    EkfFlags,
    GnssMeas,
    ImuMeas,
    init_state,
    make_params,
    predict_imu,
    update_gnss,
)
from elimaloc_tpu.map import TileQueryBudget
from elimaloc_tpu.map.builder import build_voxel_map
from elimaloc_tpu.map.pcd import read_pcd_points, write_pcd
from elimaloc_tpu.pipeline import (
    LocalizationPipeline,
    ate_rmse,
    make_world,
    synthesize_log,
)
from elimaloc_tpu.pipeline.pointcloud import (
    OUSTER_POINT_STEP,
    convert_scan,
)
from elimaloc_tpu import reference_cpu as oracle


class TestQuarantineGolden:
    def test_pcm_init_release_window(self):
        """Step both filters through: cold IMU -> PCM_INIT reset -> 12
        interleaved (IMU, PCM) pairs -> release. Compare everything."""
        cfg = ElimalocConfig()
        cfg.ekf.ekf_init_x_m = 1.0
        cfg.ekf.ekf_init_yaw_deg = 30.0
        params = make_params(cfg.ekf, dtype=jnp.float64)
        flags = EkfFlags.from_config(cfg.ekf)
        js = init_state(params, dtype=jnp.float64)
        cs = oracle.CpuEkf(cfg)

        rng = np.random.default_rng(7)

        def step_imu(js, cs, t):
            acc = np.array([0.1, 0.0, 9.81]) + rng.normal(0, 0.01, 3)
            gyro = np.array([0.0, 0.0, 0.05]) + rng.normal(0, 0.001, 3)
            js = predict_imu(
                js,
                ImuMeas(timestamp=jnp.float64(t), acc=jnp.asarray(acc),
                        gyro=jnp.asarray(gyro)),
                params, flags,
            )
            cs.run_prediction_imu(t, acc, gyro)
            return js, cs

        def step_pcm(js, cs, t, source, pos, yaw):
            rot = oracle.rot_to_quat(oracle.euler_to_rot([0.0, 0.0, yaw]))
            pc = np.eye(3) * (1e-9 if source == GnssSource.PCM_INIT else 0.05)
            rc = np.eye(3) * (1e-9 if source == GnssSource.PCM_INIT else 0.01)
            js = update_gnss(
                js,
                GnssMeas(timestamp=jnp.float64(t),
                         source=jnp.asarray(int(source)),
                         pos=jnp.asarray(pos, jnp.float64),
                         rot=jnp.asarray(rot, jnp.float64),
                         pos_cov=jnp.asarray(pc), rot_cov=jnp.asarray(rc)),
                params, flags,
            )
            cs.run_gnss_update(t, source, np.asarray(pos, float), rot, pc, rc)
            return js, cs

        def compare(js, cs, tag):
            # rtol=0: the two implementations differ only by f64
            # summation order; tiny components otherwise trip rtol
            np.testing.assert_allclose(np.asarray(js.pos), cs.pos, rtol=0,
                                       atol=1e-6, err_msg=f"{tag}: pos")
            np.testing.assert_allclose(np.asarray(js.vel), cs.vel, rtol=0,
                                       atol=1e-6, err_msg=f"{tag}: vel")
            q_j = np.asarray(js.rot)
            q_c = cs.rot if np.dot(cs.rot, q_j) >= 0 else -cs.rot
            np.testing.assert_allclose(q_j, q_c, rtol=0, atol=1e-6,
                                       err_msg=f"{tag}: rot")
            # atol covers f64 summation-order differences in F P F^T
            # (einsum vs chained matmul) on entries up to INIT_STATE_COV
            np.testing.assert_allclose(np.asarray(js.P), cs.P, rtol=0,
                                       atol=1e-5, err_msg=f"{tag}: P")
            assert float(js.prev_timestamp) == pytest.approx(
                cs.prev_timestamp, abs=1e-12), tag
            assert bool(js.pcm_init_on_going) == cs.pcm_init_on_going, tag
            assert int(js.pcm_update_count) == cs.pcm_update_count, tag
            assert bool(js.state_initialized) == cs.state_initialized, tag

        t = 1.0
        # cold IMU: first call seeds reset_for_init path, next ones hit the
        # uninitialized gate (CF runs only once yaw is initialized)
        for _ in range(5):
            js, cs = step_imu(js, cs, t)
            compare(js, cs, f"cold imu @{t:.2f}")
            t += 0.01

        # PCM_INIT hard reset
        js, cs = step_pcm(js, cs, t, GnssSource.PCM_INIT,
                          [2.0, -1.0, 0.2], 0.6)
        compare(js, cs, "pcm_init")

        # quarantine: IMU must NOT predict but must stamp prev_timestamp;
        # 12 PCM updates release the quarantine after count > 10
        for k in range(12):
            t += 0.01
            js, cs = step_imu(js, cs, t)
            compare(js, cs, f"quarantine imu {k}")
            t += 0.001
            js, cs = step_pcm(js, cs, t, GnssSource.PCM,
                              [2.0 + 0.01 * k, -1.0, 0.2], 0.6)
            compare(js, cs, f"quarantine pcm {k}")
        assert not bool(js.pcm_init_on_going), "released after >10 updates"

        # post-release IMU predicts again
        for _ in range(5):
            t += 0.01
            js, cs = step_imu(js, cs, t)
            compare(js, cs, f"released imu @{t:.2f}")

        # duplicate timestamp: no-op on both (prev_timestamp kept)
        js2, _ = step_imu(js, cs, t)


@pytest.mark.slow
class TestTrajectoryParity:
    @pytest.mark.parametrize(
        "method", [IcpMethod.P2P, IcpMethod.GICP, IcpMethod.VGICP,
                   IcpMethod.AVGICP]
    )
    def test_pipeline_matches_oracle(self, method):
        """Full closed-loop parity: JAX pipeline (f64) vs float64 oracle on
        the same log, ALL FOUR ICP methods. This is the measured stand-in
        for 'ATE within 1 cm of the C++ reference' (BASELINE.json north
        star). The parity bound is implementation-vs-implementation, so it
        holds for AVGICP too; only the truth-ATE bound reflects the
        voxel-mean objective's accuracy floor (see tests/test_icp.py).

        AVGICP gets the denser bench-style world: on the sparse default
        world the method itself is marginal (10-iteration non-convergence,
        fitness ~1.0, truth ATE ~1.2 m for BOTH implementations — verified
        per-step identical to 1e-16), and a chaotic estimator amplifies
        boundary-flip noise into decimeters of implementation divergence
        that says nothing about parity."""
        if method == IcpMethod.AVGICP:
            world = make_world(seed=7, extent=60.0, n_ground=150_000,
                               n_wall=80_000)
            log = synthesize_log(
                world, duration=4.0, points_per_scan=8192, max_range=60.0,
                seed=8, imu_noise_gyro=0.001, imu_noise_acc=0.01,
            )
        else:
            world = make_world(seed=5, extent=90.0, n_ground=120_000,
                               n_wall=60_000)
            log = synthesize_log(
                world, duration=4.0, points_per_scan=2048, max_range=60.0,
                seed=6, imu_noise_gyro=0.001, imu_noise_acc=0.01,
            )
        cfg = ElimalocConfig()
        cfg.pcm.icp_method = method
        if method != IcpMethod.AVGICP:
            cfg.pcm.input_voxel_ds_m = 1.0
        cfg.ekf.ekf_init_x_m = 60.0
        cfg.ekf.ekf_init_y_m = 0.0
        cfg.ekf.ekf_init_yaw_deg = 90.0
        cfg.calib.ego_to_lidar_trans = (0.0, 0.0, 0.0)
        cfg.calib.ego_to_lidar_rot_deg = (0.0, 0.0, 0.0)
        cfg.pcm.lidar_time_delay = 0.0
        if method in (IcpMethod.VGICP, IcpMethod.AVGICP):
            cfg.pcm.max_fitness_score = 2.0  # voxel-mean fitness floor

        built = build_voxel_map(
            world, cfg.pcm.pcm_voxel_size, cfg.pcm.pcm_voxel_max_point,
            compute_voxel_cov=method in (IcpMethod.VGICP, IcpMethod.AVGICP),
            compute_point_cov=method == IcpMethod.GICP,
            use_native=False,
        )
        pipe = LocalizationPipeline(
            cfg, built, dtype=jnp.float64,
            ds_points=4096 if method == IcpMethod.AVGICP else 2048,
            tile_budget=TileQueryBudget(qb=32, max_slots=768),
            ego_ring_size=256, imu_ring_size=128,
        )
        _, traj = pipe.run(log)

        cpu = oracle.CpuPipeline(cfg, built, ego_ring_size=256,
                                 imu_ring_size=128)
        ctraj = cpu.run(log, time_base=pipe.time_base)

        assert len(traj["t"]) == len(ctraj["t"])
        # trajectory ATE between the two implementations
        err = np.linalg.norm(traj["pos"] - ctraj["pos"], axis=1)
        parity_ate = float(np.sqrt(np.mean(err ** 2)))
        # Closed-loop divergence stays at the centimeter scale; both
        # trajectories also track truth.
        assert parity_ate < 0.01, f"pipeline-vs-oracle ATE {parity_ate}"
        ate_dev = ate_rmse(traj["t"], traj["pos"], log.truth_t, log.truth_pos)
        ate_cpu = ate_rmse(ctraj["t"], ctraj["pos"], log.truth_t,
                           log.truth_pos)
        # AVGICP's voxel-MEAN objective carries an intrinsic accuracy floor
        # at 1 m voxels (the reference behaves identically — see the parity
        # bound above, which is the actual implementation comparison)
        bound = 0.8 if method == IcpMethod.AVGICP else 0.25
        assert ate_dev < bound and ate_cpu < bound, (ate_dev, ate_cpu)


@pytest.mark.slow
class TestByteLevelEndToEnd:
    def test_pcd_map_and_ouster_bytes(self, tmp_path):
        """The reference's actual startup/ingest path: load a PCD map from
        disk, decode byte-packed Ouster scans, replay, check ATE."""
        world = make_world(seed=9, extent=90.0, n_ground=120_000,
                           n_wall=60_000)
        pcd = tmp_path / "map.pcd"
        write_pcd(str(pcd), world.astype(np.float32), mode="binary")
        map_pts = read_pcd_points(str(pcd))
        assert map_pts.shape == world.shape

        # Ouster convention: per-point times are POSITIVE ns from scan start
        log = synthesize_log(
            world, duration=3.0, points_per_scan=2048, max_range=60.0,
            seed=10, imu_noise_gyro=0.001, imu_noise_acc=0.01,
            scan_time_end=False,
        )

        cfg = ElimalocConfig()
        cfg.pcm.icp_method = IcpMethod.P2P
        cfg.pcm.lidar_type = "ouster"
        cfg.pcm.lidar_scan_time_end = False
        cfg.pcm.input_voxel_ds_m = 1.0
        cfg.ekf.ekf_init_x_m = 60.0
        cfg.ekf.ekf_init_y_m = 0.0
        cfg.ekf.ekf_init_yaw_deg = 90.0
        cfg.calib.ego_to_lidar_trans = (0.0, 0.0, 0.0)
        cfg.calib.ego_to_lidar_rot_deg = (0.0, 0.0, 0.0)
        cfg.pcm.lidar_time_delay = 0.0

        pipe = LocalizationPipeline(
            cfg, map_pts, ds_points=2048,
            tile_budget=TileQueryBudget(qb=32, max_slots=768),
            use_native=False, ego_ring_size=256, imu_ring_size=128,
        )
        state = pipe.reset()

        # pack every scan as Ouster wire bytes, decode via convert_scan
        def pack_ouster(pts, times, valid):
            pts = pts[valid]
            t_ns = (times[valid].astype(np.float64) * 1e9).astype(np.uint32)
            n = len(pts)
            buf = np.zeros(n, dtype=np.dtype({
                "names": ["x", "y", "z", "intensity", "t", "reflectivity",
                          "ring", "ambient", "range"],
                "offsets": [0, 4, 8, 16, 20, 24, 26, 28, 32],
                "formats": [np.float32, np.float32, np.float32, np.float32,
                            np.uint32, np.uint16, np.uint16, np.uint16,
                            np.uint32],
                "itemsize": OUSTER_POINT_STEP,
            }))
            buf["x"], buf["y"], buf["z"] = pts[:, 0], pts[:, 1], pts[:, 2]
            buf["t"] = t_ns
            buf["reflectivity"] = 100
            return buf.tobytes()

        from elimaloc_tpu.pipeline.runtime import scan_arrival_times

        events = [("imu", i, t) for i, t in enumerate(log.imu_t)]
        # scans arrive at sweep end (positive per-point times here)
        events += [("scan", i, t)
                   for i, t in enumerate(scan_arrival_times(log))]
        events.sort(key=lambda e: e[2])
        est_t, est_pos = [], []
        n_pad = 2048
        for kind, i, t in events:
            tv = jnp.asarray(
                pipe._rebase(t if kind == "imu" else log.scan_t[i]),
                jnp.float64)
            if kind == "imu":
                state = pipe._imu_step(
                    state, tv, jnp.asarray(log.imu_acc[i], jnp.float64),
                    jnp.asarray(log.imu_gyro[i], jnp.float64))
            else:
                raw = pack_ouster(log.scan_points[i], log.scan_times[i],
                                  log.scan_valid[i])
                xyz, intensity, times = convert_scan("ouster", raw,
                                                     index_sampling=1)
                assert intensity[: len(xyz) - 1].max() > 0
                pts = np.full((n_pad, 3), 1e9, np.float32)
                tms = np.zeros(n_pad, np.float32)
                val = np.zeros(n_pad, bool)
                k = min(len(xyz), n_pad)
                pts[:k], tms[:k] = xyz[:k], times[:k]
                # the ouster resize quirk can leave one default point; mask it
                val[:k] = np.linalg.norm(xyz[:k], axis=1) > 1e-6
                state, out = pipe._scan_step(
                    state, tv, jnp.asarray(pts), jnp.asarray(tms),
                    jnp.asarray(val), pipe.map)
                from elimaloc_tpu.ekf import ego_state
                es = ego_state(state.ekf)
                est_t.append(float(es["timestamp"]) + pipe.time_base)
                est_pos.append(np.asarray(es["pos"]))

        ate = ate_rmse(np.asarray(est_t), np.stack(est_pos),
                       log.truth_t, log.truth_pos)
        assert ate < 0.3, f"byte-level e2e ATE {ate}"


class TestZuptGolden:
    def test_stationary_zupt_matches_oracle(self):
        """BASELINE config 2 (IMU-only EKF + ZUPT): a stationary vehicle with
        use_zupt — velocity decay, bias learning and gravity-z correction
        must match the float64 oracle step for step
        (ekf_algorithm.cpp:508-565)."""
        cfg = ElimalocConfig()
        cfg.ekf.use_zupt = True
        # CF off: its est_acc_x = dvel/dt term amplifies f64 op-ordering
        # noise 100x per step, swamping the ZUPT comparison (the CF path is
        # pinned by TestQuarantineGolden)
        cfg.ekf.use_complementary_filter = False
        params = make_params(cfg.ekf, dtype=jnp.float64)
        flags = EkfFlags.from_config(cfg.ekf)
        js = init_state(params, dtype=jnp.float64)
        cs = oracle.CpuEkf(cfg)

        # make the filter "initialized" so prediction (and ZUPT) runs
        rot = np.array([1.0, 0.0, 0.0, 0.0])
        for k in range(3):
            t = 1.0 + 0.05 * k
            pc = np.eye(3) * 0.01
            rc = np.eye(3) * 0.001
            js = update_gnss(
                js,
                GnssMeas(timestamp=jnp.float64(t),
                         source=jnp.asarray(int(GnssSource.NOVATEL)),
                         pos=jnp.zeros(3, jnp.float64),
                         rot=jnp.asarray(rot, jnp.float64),
                         pos_cov=jnp.asarray(pc), rot_cov=jnp.asarray(rc)),
                params, flags)
            cs.run_gnss_update(t, GnssSource.NOVATEL, np.zeros(3), rot, pc, rc)

        rng = np.random.default_rng(3)
        t = 1.2
        for k in range(40):
            t += 0.01
            acc = np.array([0.0, 0.0, 9.81]) + rng.normal(0, 0.005, 3)
            gyro = rng.normal(0, 0.0005, 3)
            js = predict_imu(
                js,
                ImuMeas(timestamp=jnp.float64(t), acc=jnp.asarray(acc),
                        gyro=jnp.asarray(gyro)),
                params, flags)
            cs.run_prediction_imu(t, acc, gyro)
            # atol covers f64 op-ordering (quat-rotate vs matrix paths)
            np.testing.assert_allclose(np.asarray(js.vel), cs.vel, rtol=0,
                                       atol=1e-6, err_msg=f"step {k}: vel")
            np.testing.assert_allclose(np.asarray(js.bg), cs.bg, rtol=0,
                                       atol=1e-6, err_msg=f"step {k}: bg")
            np.testing.assert_allclose(np.asarray(js.ba), cs.ba, rtol=0,
                                       atol=1e-6, err_msg=f"step {k}: ba")
            np.testing.assert_allclose(np.asarray(js.grav), cs.grav, rtol=0,
                                       atol=1e-6, err_msg=f"step {k}: grav")
        # ZUPT actually engaged: biases moved off zero
        assert np.abs(cs.bg).max() > 0


class TestCaModelGolden:
    def test_ca_prediction_matches_oracle(self):
        """use_imu=False mode: the 100 Hz CA-model tick (RunPrediction,
        ekf_algorithm.cpp:81-165) vs the oracle, interleaved with CAN
        updates so gyro/acc states are nonzero."""
        from elimaloc_tpu.ekf import predict, update_can
        from elimaloc_tpu.ekf.state import CanMeas

        cfg = ElimalocConfig()
        cfg.ekf.use_can = True
        params = make_params(cfg.ekf, dtype=jnp.float64)
        flags = EkfFlags.from_config(cfg.ekf)
        js = init_state(params, dtype=jnp.float64)
        cs = oracle.CpuEkf(cfg)

        t = 1.0
        for k in range(30):
            t += 0.01
            js = predict(js, jnp.float64(t), params)
            cs.run_prediction(t)
            if k % 5 == 2:
                vel_x, yaw_rate = 2.0 + 0.1 * k, 0.1
                z = jnp.float64(0.0)
                js = update_can(
                    js,
                    CanMeas(timestamp=jnp.float64(t),
                            vel=jnp.stack([jnp.float64(vel_x), z, z]),
                            gyro=jnp.stack([z, z, jnp.float64(yaw_rate)])),
                    params, flags)
                cs.run_can_update(t, vel_x, yaw_rate)
            np.testing.assert_allclose(np.asarray(js.pos), cs.pos, rtol=0,
                                       atol=1e-7, err_msg=f"step {k}: pos")
            np.testing.assert_allclose(np.asarray(js.vel), cs.vel, rtol=0,
                                       atol=1e-7, err_msg=f"step {k}: vel")
            q_j = np.asarray(js.rot)
            q_c = cs.rot if np.dot(cs.rot, q_j) >= 0 else -cs.rot
            np.testing.assert_allclose(q_j, q_c, rtol=0, atol=1e-7,
                                       err_msg=f"step {k}: rot")
            np.testing.assert_allclose(np.asarray(js.P), cs.P, rtol=0,
                                       atol=1e-4, err_msg=f"step {k}: P")
            assert float(js.prev_timestamp) == pytest.approx(
                cs.prev_timestamp, abs=1e-12)
