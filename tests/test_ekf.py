"""Golden-value and property tests for the 27-state EKF vs the NumPy oracle."""

import jax
import jax.numpy as jnp
import numpy as np

from elimaloc_tpu.config import EkfConfig, GnssSource
from elimaloc_tpu.ekf import (
    CanMeas,
    EkfFlags,
    GnssMeas,
    ImuMeas,
    ego_state,
    init_state,
    make_params,
    predict_imu,
    update_can,
    update_gnss,
)
from elimaloc_tpu.ops import lie

import ref_numpy as ref

RNG = np.random.default_rng(7)

CFG = EkfConfig(use_zupt=False, use_complementary_filter=False,
                imu_estimate_gravity=True, imu_estimate_calibration=False)
FLAGS = EkfFlags.from_config(CFG)
PARAMS = make_params(CFG, dtype=jnp.float64)

NP_PARAMS = {
    "gravity": CFG.imu_gravity,
    "imu_bias_cov_gyro": CFG.imu_bias_cov_gyro,
    "imu_bias_cov_acc": CFG.imu_bias_cov_acc,
    "state_std_pos_m": CFG.state_std_pos_m,
    "state_std_rot_deg": CFG.state_std_rot_deg,
    "state_std_vel_mps": CFG.state_std_vel_mps,
    "imu_std_gyro_dps": CFG.imu_std_gyro_dps,
    "imu_std_acc_mps": CFG.imu_std_acc_mps,
    "gnss_min_cov_x_m": CFG.gnss_min_cov_x_m,
    "gnss_min_cov_y_m": CFG.gnss_min_cov_y_m,
    "gnss_min_cov_z_m": CFG.gnss_min_cov_z_m,
    "gnss_min_cov_roll_deg": CFG.gnss_min_cov_roll_deg,
    "gnss_min_cov_pitch_deg": CFG.gnss_min_cov_pitch_deg,
    "gnss_min_cov_yaw_deg": CFG.gnss_min_cov_yaw_deg,
    "can_vel_scale": CFG.can_vel_scale_factor,
    "can_unc_vel": CFG.can_meas_uncertainty_vel_mps,
    "can_unc_yaw_rate_deg": CFG.can_meas_uncertainty_yaw_rate_deg,
}


def fresh_state(initialized=True, dtype=jnp.float64):
    s = init_state(PARAMS, dtype=dtype)
    if initialized:
        # Past the first-call gates: reset consumed, state considered init'd,
        # prev timestamp seeded.
        s = s.replace(
            reset_for_init_prediction=jnp.asarray(False),
            state_initialized=jnp.asarray(True),
            yaw_initialized=jnp.asarray(True),
            prev_timestamp=jnp.asarray(100.0, dtype=dtype),
        )
    return s


def randomize(s):
    """Give the filter a non-trivial operating point (shared with the oracle)."""
    rot = ref.so3_exp(RNG.normal(size=3) * 0.3)
    d = {
        "pos": RNG.normal(size=3) * 10,
        "rot": rot,
        "vel": RNG.normal(size=3) * 3,
        "gyro": RNG.normal(size=3) * 0.2,
        "acc": RNG.normal(size=3),
        "bg": RNG.normal(size=3) * 0.01,
        "ba": RNG.normal(size=3) * 0.05,
        "grav": np.array([0.0, 0.0, 9.81]),
        "imu_rot": np.eye(3),
    }
    A = RNG.normal(size=(27, 27)) * 0.1
    d["P"] = A @ A.T + np.eye(27) * 0.5
    js = s.replace(
        pos=jnp.asarray(d["pos"]),
        rot=lie.rot_to_quat(jnp.asarray(d["rot"])),
        vel=jnp.asarray(d["vel"]),
        gyro=jnp.asarray(d["gyro"]),
        acc=jnp.asarray(d["acc"]),
        bg=jnp.asarray(d["bg"]),
        ba=jnp.asarray(d["ba"]),
        grav=jnp.asarray(d["grav"]),
        P=jnp.asarray(d["P"]),
    )
    return js, d


def assert_state_close(js, nd, atol=1e-9):
    np.testing.assert_allclose(np.asarray(js.pos), nd["pos"], atol=atol)
    np.testing.assert_allclose(
        np.asarray(lie.quat_to_rot(js.rot)), nd["rot"], atol=atol
    )
    np.testing.assert_allclose(np.asarray(js.vel), nd["vel"], atol=atol)
    np.testing.assert_allclose(np.asarray(js.gyro), nd["gyro"], atol=atol)
    np.testing.assert_allclose(np.asarray(js.acc), nd["acc"], atol=atol)
    np.testing.assert_allclose(np.asarray(js.bg), nd["bg"], atol=atol)
    np.testing.assert_allclose(np.asarray(js.ba), nd["ba"], atol=atol)
    np.testing.assert_allclose(np.asarray(js.grav), nd["grav"], atol=atol)
    np.testing.assert_allclose(np.asarray(js.P), nd["P"], atol=atol)


class TestPredictImu:
    def test_golden_vs_oracle(self):
        js, nd = randomize(fresh_state())
        dt = 0.01
        acc = RNG.normal(size=3) + np.array([0, 0, 9.81])
        gyro = RNG.normal(size=3) * 0.1
        imu = ImuMeas(
            timestamp=jnp.asarray(100.0 + dt),
            acc=jnp.asarray(acc),
            gyro=jnp.asarray(gyro),
        )
        out = jax.jit(predict_imu, static_argnums=3)(js, imu, PARAMS, FLAGS)
        want = ref.ekf_predict_imu_np(nd, acc, gyro, dt, NP_PARAMS)
        assert_state_close(out, want)
        assert float(out.prev_timestamp) == 100.0 + dt

    def test_reset_gate_consumes_flag_only(self):
        js, _ = randomize(fresh_state())
        js = js.replace(reset_for_init_prediction=jnp.asarray(True))
        imu = ImuMeas(jnp.asarray(105.0), jnp.zeros(3), jnp.zeros(3))
        out = predict_imu(js, imu, PARAMS, FLAGS)
        np.testing.assert_array_equal(np.asarray(out.pos), np.asarray(js.pos))
        np.testing.assert_array_equal(np.asarray(out.P), np.asarray(js.P))
        assert float(out.prev_timestamp) == 105.0
        assert not bool(out.reset_for_init_prediction)

    def test_pcm_init_quarantine_blocks_prediction(self):
        js, _ = randomize(fresh_state())
        js = js.replace(pcm_init_on_going=jnp.asarray(True))
        imu = ImuMeas(jnp.asarray(100.5), jnp.ones(3), jnp.ones(3))
        out = predict_imu(js, imu, PARAMS, FLAGS)
        np.testing.assert_array_equal(np.asarray(out.P), np.asarray(js.P))
        assert float(out.prev_timestamp) == 100.5

    def test_stale_timestamp_noop(self):
        js, _ = randomize(fresh_state())
        imu = ImuMeas(jnp.asarray(100.0), jnp.ones(3), jnp.ones(3))
        out = predict_imu(js, imu, PARAMS, FLAGS)
        np.testing.assert_array_equal(np.asarray(out.P), np.asarray(js.P))
        assert float(out.prev_timestamp) == 100.0

    def test_covariance_stays_symmetric_psd(self):
        js, _ = randomize(fresh_state())
        t = 100.0
        step = jax.jit(predict_imu, static_argnums=3)
        for _ in range(50):
            t += 0.01
            imu = ImuMeas(
                timestamp=jnp.asarray(t),
                acc=jnp.asarray(RNG.normal(size=3) + [0, 0, 9.81]),
                gyro=jnp.asarray(RNG.normal(size=3) * 0.1),
            )
            js = step(js, imu, PARAMS, FLAGS)
        P = np.asarray(js.P)
        np.testing.assert_allclose(P, P.T, atol=1e-9)
        assert np.linalg.eigvalsh(P).min() > 0

    def test_scan_over_imu_batch(self):
        js, _ = randomize(fresh_state())
        n = 32
        ts = 100.0 + 0.01 * np.arange(1, n + 1)
        accs = RNG.normal(size=(n, 3)) + [0, 0, 9.81]
        gyrs = RNG.normal(size=(n, 3)) * 0.1
        batch = ImuMeas(jnp.asarray(ts), jnp.asarray(accs), jnp.asarray(gyrs))

        @jax.jit
        def run(s, b):
            return jax.lax.scan(
                lambda c, m: (predict_imu(c, m, PARAMS, FLAGS), None), s, b
            )[0]

        scanned = run(js, batch)
        looped = js
        for i in range(n):
            looped = predict_imu(
                looped,
                ImuMeas(jnp.asarray(ts[i]), jnp.asarray(accs[i]), jnp.asarray(gyrs[i])),
                PARAMS,
                FLAGS,
            )
        np.testing.assert_allclose(
            np.asarray(scanned.P), np.asarray(looped.P), atol=1e-9
        )
        np.testing.assert_allclose(
            np.asarray(scanned.pos), np.asarray(looped.pos), atol=1e-9
        )


class TestUpdateGnss:
    def test_pcm_6dof_golden(self):
        js, nd = randomize(fresh_state())
        pos = nd["pos"] + RNG.normal(size=3) * 0.1
        rotm = nd["rot"] @ ref.so3_exp(RNG.normal(size=3) * 0.02)
        pos_cov = np.diag(RNG.uniform(0.01, 0.3, 3))
        rot_cov = np.diag(RNG.uniform(0.001, 0.01, 3))
        meas = GnssMeas(
            timestamp=jnp.asarray(100.05),
            source=jnp.asarray(int(GnssSource.PCM)),
            pos=jnp.asarray(pos),
            rot=lie.rot_to_quat(jnp.asarray(rotm)),
            pos_cov=jnp.asarray(pos_cov),
            rot_cov=jnp.asarray(rot_cov),
        )
        out = jax.jit(update_gnss, static_argnums=3)(js, meas, PARAMS, FLAGS)
        want = ref.ekf_update_gnss_np(nd, pos, rotm, pos_cov, rot_cov, NP_PARAMS, "PCM")
        assert_state_close(out, want, atol=1e-8)
        assert float(out.prev_gnss_timestamp) == 100.05

    def test_navsatfix_3dof_golden(self):
        js, nd = randomize(fresh_state())
        pos = nd["pos"] + RNG.normal(size=3) * 0.5
        pos_cov = np.diag(RNG.uniform(0.01, 0.3, 3))
        meas = GnssMeas(
            timestamp=jnp.asarray(100.05),
            source=jnp.asarray(int(GnssSource.NAVSATFIX)),
            pos=jnp.asarray(pos),
            rot=lie.quat_identity(jnp.float64),
            pos_cov=jnp.asarray(pos_cov),
            rot_cov=jnp.zeros((3, 3)),
        )
        out = update_gnss(js, meas, PARAMS, FLAGS)
        # Flags are refreshed from P inside; with a large randomized P yaw is
        # uninitialized -> the +3.0 antenna inflation applies.
        yaw_init = np.sqrt(nd["P"][5, 5]) < 5.0 * np.pi / 180.0
        want = ref.ekf_update_gnss_np(
            nd, pos, np.eye(3), pos_cov, np.zeros((3, 3)), NP_PARAMS,
            "NAVSATFIX", yaw_initialized=yaw_init,
        )
        assert_state_close(out, want, atol=1e-8)

    def test_pcm_init_hard_reset(self):
        js, nd = randomize(fresh_state())
        pos = np.array([1.0, 2.0, 3.0])
        rotm = ref.so3_exp([0.0, 0.0, 0.7])
        meas = GnssMeas(
            timestamp=jnp.asarray(100.05),
            source=jnp.asarray(int(GnssSource.PCM_INIT)),
            pos=jnp.asarray(pos),
            rot=lie.rot_to_quat(jnp.asarray(rotm)),
            pos_cov=jnp.eye(3) * 1e-9,
            rot_cov=jnp.eye(3) * 1e-9,
        )
        out = update_gnss(js, meas, PARAMS, FLAGS)
        np.testing.assert_allclose(np.asarray(out.pos), pos)
        np.testing.assert_allclose(
            np.asarray(lie.quat_to_rot(out.rot)), rotm, atol=1e-12
        )
        np.testing.assert_array_equal(np.asarray(out.vel), np.zeros(3))
        P = np.asarray(out.P)
        np.testing.assert_allclose(P[:15, :15], np.eye(15) * 100.0, atol=1e-12)
        # Blocks outside the reset window are preserved.
        np.testing.assert_allclose(P[15:, 15:], nd["P"][15:, 15:], atol=1e-12)
        assert bool(out.pcm_init_on_going)
        assert bool(out.state_initialized)
        # prev_gnss is NOT recorded on the init branch (cpp returns at :348).
        assert float(out.prev_gnss_timestamp) == float(js.prev_gnss_timestamp)

    def test_pcm_warmup_counter_release(self):
        js, _ = randomize(fresh_state())
        js = js.replace(pcm_init_on_going=jnp.asarray(True))
        meas = GnssMeas(
            timestamp=jnp.asarray(100.05),
            source=jnp.asarray(int(GnssSource.PCM)),
            pos=js.pos,
            rot=js.rot,
            pos_cov=jnp.eye(3) * 0.01,
            rot_cov=jnp.eye(3) * 0.001,
        )
        for i in range(11):
            js = update_gnss(js, meas, PARAMS, FLAGS)
            assert bool(js.pcm_init_on_going), f"released too early at {i}"
        js = update_gnss(js, meas, PARAMS, FLAGS)  # count was 11 > 10 -> release
        assert not bool(js.pcm_init_on_going)


class TestUpdateCan:
    def test_golden(self):
        js, nd = randomize(fresh_state())
        js = js.replace(prev_can_timestamp=jnp.asarray(99.0))
        can_vel = np.array([5.0, 0.0, 0.0])
        can = CanMeas(
            timestamp=jnp.asarray(100.0),
            vel=jnp.asarray(can_vel),
            gyro=jnp.asarray([0.0, 0.0, 0.1]),
        )
        out = jax.jit(update_can, static_argnums=3)(js, can, PARAMS, FLAGS)
        want = ref.ekf_update_can_np(nd, can_vel, 0.1, NP_PARAMS)
        # |can vel| > 0.05 so ZuptCan is inert.
        assert_state_close(out, want, atol=1e-8)
        assert float(out.prev_can_timestamp) == 100.0

    def test_dt_gate(self):
        js, _ = randomize(fresh_state())
        js = js.replace(prev_can_timestamp=jnp.asarray(99.995))
        can = CanMeas(jnp.asarray(100.0), jnp.asarray([5.0, 0, 0]), jnp.zeros(3))
        out = update_can(js, can, PARAMS, FLAGS)
        np.testing.assert_array_equal(np.asarray(out.P), np.asarray(js.P))
        assert float(out.prev_can_timestamp) == 99.995

    def test_zupt_can_bias_learning(self):
        js, _ = randomize(fresh_state())
        js = js.replace(prev_can_timestamp=jnp.asarray(99.0))
        can = CanMeas(
            jnp.asarray(100.0), jnp.asarray([0.01, 0, 0]), jnp.asarray([0, 0, 0.02])
        )
        out = update_can(js, can, PARAMS, FLAGS)
        # bias <- 0.05 * 0.02 + 0.95 * 0
        assert abs(float(out.can_yaw_rate_bias) - 0.001) < 1e-12


class TestAux:
    def test_zupt_imu_pulls_velocity_down(self):
        cfg = EkfConfig(use_zupt=True, use_complementary_filter=False)
        flags = EkfFlags.from_config(cfg)
        js = fresh_state()
        js = js.replace(
            vel=jnp.asarray([0.05, 0.2, 0.1]),
            gyro=jnp.zeros(3),
            acc=jnp.zeros(3),
        )
        imu = ImuMeas(jnp.asarray(100.01), jnp.asarray([0.0, 0, 9.81]), jnp.zeros(3))
        out = predict_imu(js, imu, PARAMS, flags)
        assert float(jnp.linalg.norm(out.vel)) < float(jnp.linalg.norm(js.vel))

    def test_complementary_filter_first_call_seeds_statics(self):
        cfg = EkfConfig(use_complementary_filter=True)
        flags = EkfFlags.from_config(cfg)
        js = fresh_state()
        imu = ImuMeas(jnp.asarray(100.01), jnp.asarray([0.0, 0, 9.81]), jnp.zeros(3))
        out = predict_imu(js, imu, PARAMS, flags)
        assert bool(out.cf_initialized)
        assert float(out.cf_prev_time) == 100.01
        # Second call with dt > 0 actually updates roll/pitch covariance.
        imu2 = ImuMeas(jnp.asarray(100.02), jnp.asarray([0.0, 0, 9.81]), jnp.zeros(3))
        out2 = predict_imu(out, imu2, PARAMS, flags)
        assert float(out2.P[3, 3]) < float(out.P[3, 3]) + 1e-9

    def test_calibration_runs_when_moving_and_stable(self):
        cfg = EkfConfig(use_complementary_filter=False, imu_estimate_calibration=True)
        flags = EkfFlags.from_config(cfg)
        js = fresh_state()
        P = np.asarray(js.P).copy()
        for i in range(3, 6):
            P[i, i] = (0.1 * np.pi / 180) ** 2  # rotation stabilized
        js = js.replace(P=jnp.asarray(P), vel=jnp.asarray([10.0, 0.5, 0.0]))
        imu = ImuMeas(jnp.asarray(100.01), jnp.asarray([0.0, 0, 9.81]), jnp.zeros(3))
        out = predict_imu(js, imu, PARAMS, flags)
        assert bool(out.vehicle_imu_calib_started)
        # imu_rot moved off identity
        assert float(jnp.abs(out.imu_rot[3])) > 0 or float(out.P[26, 26]) < float(js.P[26, 26])


def test_ego_state_output():
    js, nd = randomize(fresh_state())
    out = ego_state(js)
    rpy = ref.rot_to_euler(nd["rot"])
    np.testing.assert_allclose(np.asarray(out["rpy"]), rpy, atol=1e-9)
    np.testing.assert_allclose(
        np.asarray(out["vel_local"]),
        ref.global_to_local_velocity(nd["vel"], rpy),
        atol=1e-9,
    )
    np.testing.assert_allclose(
        np.asarray(out["pos_cov_local"]),
        np.abs(ref.global_to_local_velocity(np.diag(nd["P"])[:3], rpy)),
        atol=1e-9,
    )


class TestJosephForm:
    def test_long_f32_run_stays_symmetric_psd(self):
        cfg = EkfConfig(use_complementary_filter=False)
        flags_j = EkfFlags.from_config(cfg)
        flags_j = __import__("dataclasses").replace(flags_j, joseph_form=True)
        params32 = make_params(cfg, dtype=jnp.float32)
        s = init_state(params32, dtype=jnp.float32)
        s = s.replace(
            reset_for_init_prediction=jnp.asarray(False),
            state_initialized=jnp.asarray(True),
            yaw_initialized=jnp.asarray(True),
            prev_timestamp=jnp.float32(0.0),
        )
        rng = np.random.default_rng(2)
        pred = jax.jit(predict_imu, static_argnums=3)
        upd = jax.jit(update_gnss, static_argnums=3)
        for k in range(1, 401):
            t = jnp.float32(0.01 * k)
            imu = ImuMeas(t, jnp.asarray(rng.normal(0, 0.02, 3) + [0, 0, 9.81],
                                         jnp.float32),
                          jnp.asarray(rng.normal(0, 0.002, 3), jnp.float32))
            s = pred(s, imu, params32, flags_j)
            if k % 10 == 0:
                meas = GnssMeas(t, jnp.asarray(int(GnssSource.PCM)),
                                jnp.zeros(3, jnp.float32),
                                lie.quat_identity(jnp.float32),
                                jnp.eye(3, dtype=jnp.float32) * 0.01,
                                jnp.eye(3, dtype=jnp.float32) * 0.001)
                s = upd(s, meas, params32, flags_j)
        P = np.asarray(s.P, np.float64)
        np.testing.assert_allclose(P, P.T, atol=1e-5)
        assert np.linalg.eigvalsh(P).min() > -1e-6

    def test_joseph_matches_reference_form_in_f64(self):
        cfg = EkfConfig(use_complementary_filter=False)
        flags_j = __import__("dataclasses").replace(FLAGS, joseph_form=True)
        js, nd = randomize(fresh_state())
        meas = GnssMeas(jnp.asarray(100.05), jnp.asarray(int(GnssSource.PCM)),
                        js.pos + 0.01, js.rot,
                        jnp.eye(3) * 0.01, jnp.eye(3) * 0.001)
        a = update_gnss(js, meas, PARAMS, FLAGS)
        b = update_gnss(js, meas, PARAMS, flags_j)
        # identical in exact arithmetic; f64 keeps them very close
        np.testing.assert_allclose(np.asarray(a.P), np.asarray(b.P), atol=1e-8)
        np.testing.assert_allclose(np.asarray(a.pos), np.asarray(b.pos), atol=1e-12)


def test_fpf_sparse_matches_dense():
    """The f32 sparse block form of F P F^T (filter._fpf_sparse) is
    algebraically identical to the dense Jacobian form the f64 oracle-parity
    mode keeps (filter._fpf_dense) for symmetric P. Pinned here in f64 so
    the production form's algebra is validated independently of the
    closed-loop parity tests (which require the dense accumulation order —
    see filter._latency_forms)."""
    from elimaloc_tpu.ekf import filter as flt

    rng = np.random.default_rng(11)
    for grav_flag in (False, True):
        flags = __import__("dataclasses").replace(
            FLAGS, imu_estimate_gravity=grav_flag)
        for trial in range(3):
            A = rng.normal(size=(27, 27))
            P = jnp.asarray(A @ A.T + np.eye(27) * 1e-3)
            G_R_I = jnp.asarray(ref.so3_exp(rng.normal(size=3)))
            gyro = jnp.asarray(rng.normal(size=3) * 0.3)
            dt = 0.011
            Jr = lie.right_jacobian_d_rot_d_gyro(gyro, dt)
            dense = flt._fpf_dense(P, G_R_I, Jr, dt, flags, jnp.float64)
            sparse = flt._fpf_sparse(P, G_R_I, Jr, dt, flags)
            np.testing.assert_allclose(np.asarray(sparse), np.asarray(dense),
                                       rtol=1e-12, atol=1e-12)
    # dispatch: f32 takes the latency forms, f64 the oracle-parity dense forms
    assert (flt._latency_forms(jnp.float32)
            and not flt._latency_forms(jnp.float64))
