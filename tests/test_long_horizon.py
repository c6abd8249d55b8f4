"""Long-horizon float32 stability of the full closed loop.

The 4-second parity loops (test_oracle_parity) bound implementation-vs-
implementation divergence but say nothing about CUMULATIVE float32 drift
over the real use case — minutes-to-hours of driving. This replays a
62 s / ~600-scan synthetic log through ``run_fused`` in float32 (the device
production dtype) and asserts:

  * the tracking error shows no growth trend (slope of |err|(t) bounded),
  * the EKF covariance stays symmetric with positive diagonals on EVERY
    frame (telemetry from fused_frame) and is PSD at the end,
  * the Joseph-form update (flags.joseph_form) agrees with the reference's
    plain ``P -= KHP`` (ekf_algorithm.hpp:144) at trajectory level while
    keeping P at least as healthy.

The float64 NumPy oracle runs ~0.1 scans/s, so a 600-scan oracle parity
run is out of budget here; long-horizon evidence is against ground truth
(oracle parity is pinned by the 4 s tests).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from elimaloc_tpu.config import ElimalocConfig, IcpMethod
from elimaloc_tpu.map import TileQueryBudget
from elimaloc_tpu.pipeline import (
    LocalizationPipeline,
    ate_rmse,
    make_world,
    synthesize_log,
)

DURATION = 62.0


def _pipe_and_log(joseph: bool):
    world = make_world(seed=15, extent=90.0, n_ground=150_000, n_wall=70_000)
    log = synthesize_log(
        world, duration=DURATION, points_per_scan=2048, max_range=60.0,
        seed=16, imu_noise_gyro=0.001, imu_noise_acc=0.01,
    )
    cfg = ElimalocConfig()
    cfg.pcm.icp_method = IcpMethod.P2P
    cfg.pcm.input_voxel_ds_m = 1.0
    cfg.pcm.lidar_time_delay = 0.0
    cfg.ekf.ekf_init_x_m = 60.0
    cfg.ekf.ekf_init_y_m = 0.0
    cfg.ekf.ekf_init_yaw_deg = 90.0
    cfg.calib.ego_to_lidar_trans = (0.0, 0.0, 0.0)
    cfg.calib.ego_to_lidar_rot_deg = (0.0, 0.0, 0.0)
    pipe = LocalizationPipeline(
        cfg, world, dtype=jnp.float32, ds_points=2048,
        tile_budget=TileQueryBudget(qb=32, max_slots=768),
        ego_ring_size=256, imu_ring_size=128, use_native=False,
    )
    if joseph:
        pipe.static = dataclasses.replace(
            pipe.static,
            ekf_flags=dataclasses.replace(pipe.static.ekf_flags,
                                          joseph_form=True),
        )
        pipe._build_jitted()
    return pipe, log


def _per_scan_error(outs, log):
    t = np.asarray(outs["ego_t_abs"])
    pos = np.asarray(outs["ego_pos"])
    truth = np.stack([
        np.interp(t, log.truth_t, log.truth_pos[:, k]) for k in range(3)
    ], axis=1)
    return t, np.linalg.norm(pos - truth, axis=1)


@pytest.mark.slow
@pytest.mark.parametrize("joseph", [False, True], ids=["plain", "joseph"])
def test_600_scan_f32_replay_is_drift_free(joseph):
    pipe, log = _pipe_and_log(joseph)
    state, outs = pipe.run_fused(log)
    n = len(log.scan_t)
    assert n >= 600
    assert float(np.asarray(outs["applied"]).mean()) == 1.0

    t, err = _per_scan_error(outs, log)
    ate = ate_rmse(t, np.asarray(outs["ego_pos"]), log.truth_t, log.truth_pos)
    assert ate < 0.15, f"long-horizon ATE {ate}"

    # no drift trend: after convergence (skip the first 10 s cold start),
    # the error slope must be < 1 mm/s (< 6 cm over a minute)
    warm = t > t[0] + 10.0
    slope = np.polyfit(t[warm] - t[0], err[warm], 1)[0]
    assert abs(slope) < 1e-3, f"error drifts at {slope * 1e3:.2f} mm/s"
    # ...and the tail is no worse than the middle
    third = (len(t) - warm.argmax()) // 3
    mid = err[warm][third:2 * third]
    tail = err[warm][-third:]
    assert np.sqrt(np.mean(tail ** 2)) < np.sqrt(np.mean(mid ** 2)) + 0.05

    # covariance health on EVERY frame (f32 P -= KHP is the risk point)
    asym = np.asarray(outs["p_asym"])
    dmin = np.asarray(outs["p_min_diag"])
    assert dmin.min() > 0.0, "EKF covariance lost a positive diagonal"
    assert asym.max() < 1e-2, f"EKF covariance asymmetry {asym.max()}"
    if joseph:
        # Joseph form is symmetric by construction up to rounding
        assert asym.max() < 1e-4

    # final P is PSD
    P = np.asarray(state.ekf.P, np.float64)
    eig = np.linalg.eigvalsh(0.5 * (P + P.T))
    assert eig.min() > -1e-6, f"final P not PSD: {eig.min()}"
