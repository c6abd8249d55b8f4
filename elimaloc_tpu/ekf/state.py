"""EKF state pytrees for the JAX ELiMaLoc rebuild.

The reference keeps a 27-dimensional error-state EKF (reference:
src/app/localization/ekf_localization/include/ekf_algorithm.hpp:41-69) as a
mutex-guarded C++ object. Here the full filter state — nominal state,
covariance, convergence flags, and the small pieces of auxiliary mutable state
the reference hides in member variables and function statics — is one explicit,
immutable pytree threaded through pure update functions (SURVEY.md §2 C13:
mutexes disappear under functional state threading).

State vector layout (identical to ekf_algorithm.hpp:41-67):
  0:3   position (global)         12:15 acceleration (global)  21:24 gravity
  3:6   rotation (roll,pitch,yaw) 15:18 gyro bias              24:27 imu mount rot
  6:9   velocity (global)         18:21 accel bias
  9:12  angular rate (body)
"""

from __future__ import annotations

import jax.numpy as jnp
from .. import pytree

# State indices (reference: ekf_algorithm.hpp:41-67)
S_X, S_Y, S_Z = 0, 1, 2
S_ROLL, S_PITCH, S_YAW = 3, 4, 5
S_VX, S_VY, S_VZ = 6, 7, 8
S_ROLL_RATE, S_PITCH_RATE, S_YAW_RATE = 9, 10, 11
S_AX, S_AY, S_AZ = 12, 13, 14
S_B_ROLL_RATE, S_B_PITCH_RATE, S_B_YAW_RATE = 15, 16, 17
S_B_AX, S_B_AY, S_B_AZ = 18, 19, 20
S_G_X, S_G_Y, S_G_Z = 21, 22, 23
S_IMU_ROLL, S_IMU_PITCH, S_IMU_YAW = 24, 25, 26

STATE_ORDER = 27
GNSS_MEAS_ORDER = 6
INIT_STATE_COV = 100.0  # reference: ekf_algorithm.hpp:73


@pytree.dataclass
class EkfState:
    """Nominal state + covariance + filter bookkeeping (one pytree).

    Mirrors EkfAlgorithm's member state (ekf_algorithm.hpp:262-289):
    ``S_`` -> (pos..imu_rot), ``P_`` -> P, the six booleans, the CAN yaw-rate
    bias, the PCM warm-up counter, and prev timestamps. The complementary
    filter's C++ function statics (ekf_algorithm.cpp:613-614) are ``cf_*``.
    """

    pos: jnp.ndarray        # [3] global position
    rot: jnp.ndarray        # [4] quaternion (w,x,y,z), global attitude
    vel: jnp.ndarray        # [3] global velocity
    gyro: jnp.ndarray       # [3] body angular rate (bias-corrected estimate)
    acc: jnp.ndarray        # [3] global acceleration (gravity-free)
    bg: jnp.ndarray         # [3] gyro bias
    ba: jnp.ndarray         # [3] accel bias
    grav: jnp.ndarray       # [3] gravity vector (global)
    imu_rot: jnp.ndarray    # [4] quaternion, vehicle->IMU mounting rotation
    P: jnp.ndarray          # [27, 27] covariance

    # Filter bookkeeping (ekf_algorithm.hpp:269-289)
    reset_for_init_prediction: jnp.ndarray  # bool
    state_initialized: jnp.ndarray          # bool
    yaw_initialized: jnp.ndarray            # bool
    rotation_stabilized: jnp.ndarray        # bool
    state_stabilized: jnp.ndarray           # bool
    pcm_init_on_going: jnp.ndarray          # bool
    vehicle_imu_calib_started: jnp.ndarray  # bool
    can_yaw_rate_bias: jnp.ndarray          # scalar
    pcm_update_count: jnp.ndarray           # int32
    prev_timestamp: jnp.ndarray             # scalar, last prediction time
    prev_gnss_timestamp: jnp.ndarray        # scalar
    prev_can_timestamp: jnp.ndarray         # scalar

    # Complementary-filter statics (ekf_algorithm.cpp:613-614)
    cf_initialized: jnp.ndarray             # bool
    cf_prev_vel_local_x: jnp.ndarray        # scalar
    cf_prev_time: jnp.ndarray               # scalar


@pytree.dataclass
class ImuMeas:
    """Ego-frame IMU sample (reference: ImuStruct, localization_struct.hpp:126)."""

    timestamp: jnp.ndarray
    acc: jnp.ndarray   # [3]
    gyro: jnp.ndarray  # [3]


@pytree.dataclass
class GnssMeas:
    """6-DOF pose measurement (reference: EkfGnssMeasurement,
    localization_struct.hpp:146-153)."""

    timestamp: jnp.ndarray
    source: jnp.ndarray   # int32, GnssSource value
    pos: jnp.ndarray      # [3]
    rot: jnp.ndarray      # [4] quaternion (w,x,y,z)
    pos_cov: jnp.ndarray  # [3,3]
    rot_cov: jnp.ndarray  # [3,3]


@pytree.dataclass
class CanMeas:
    """CAN wheel-speed sample (reference: CanStruct, localization_struct.hpp:120)."""

    timestamp: jnp.ndarray
    vel: jnp.ndarray   # [3] local, only x valid
    gyro: jnp.ndarray  # [3] local, only z valid


@pytree.dataclass
class EkfParams:
    """Continuous EKF parameters as dynamic pytree leaves so hot-reloaded
    config changes (SURVEY.md §5.6) do not trigger recompilation. Built from
    :class:`elimaloc_tpu.config.EkfConfig` by :func:`make_params`."""

    init_pos: jnp.ndarray           # [3]
    init_rpy: jnp.ndarray           # [3] radians
    imu_gravity: jnp.ndarray
    state_std_pos_m: jnp.ndarray
    state_std_rot_rad: jnp.ndarray
    state_std_vel_mps: jnp.ndarray
    state_std_gyro_dps: jnp.ndarray   # used by the non-IMU CA model, raw dps
    state_std_acc_mps: jnp.ndarray
    imu_std_gyro_rad: jnp.ndarray     # converted to rad as the reference does
    imu_std_acc_mps: jnp.ndarray
    imu_bias_cov_gyro: jnp.ndarray
    imu_bias_cov_acc: jnp.ndarray
    gnss_min_cov: jnp.ndarray         # [6] x,y,z then roll,pitch,yaw (rad-scaled)
    can_vel_scale: jnp.ndarray
    can_meas_uncertainty_vel: jnp.ndarray
    can_meas_uncertainty_yaw_rate_rad: jnp.ndarray


def make_params(cfg, dtype=jnp.float32) -> EkfParams:
    """EkfConfig -> EkfParams (unit conversions as in ekf_algorithm.cpp)."""
    d2r = jnp.pi / 180.0
    f = lambda v: jnp.asarray(v, dtype=dtype)
    return EkfParams(
        init_pos=f([cfg.ekf_init_x_m, cfg.ekf_init_y_m, cfg.ekf_init_z_m]),
        init_rpy=f(
            [
                cfg.ekf_init_roll_deg * jnp.pi / 180.0,
                cfg.ekf_init_pitch_deg * jnp.pi / 180.0,
                cfg.ekf_init_yaw_deg * jnp.pi / 180.0,
            ]
        ),
        imu_gravity=f(cfg.imu_gravity),
        state_std_pos_m=f(cfg.state_std_pos_m),
        state_std_rot_rad=f(cfg.state_std_rot_deg * jnp.pi / 180.0),
        state_std_vel_mps=f(cfg.state_std_vel_mps),
        state_std_gyro_dps=f(cfg.state_std_gyro_dps),
        state_std_acc_mps=f(cfg.state_std_acc_mps),
        imu_std_gyro_rad=f(cfg.imu_std_gyro_dps * jnp.pi / 180.0),
        imu_std_acc_mps=f(cfg.imu_std_acc_mps),
        imu_bias_cov_gyro=f(cfg.imu_bias_cov_gyro),
        imu_bias_cov_acc=f(cfg.imu_bias_cov_acc),
        gnss_min_cov=f(
            [
                cfg.gnss_min_cov_x_m,
                cfg.gnss_min_cov_y_m,
                cfg.gnss_min_cov_z_m,
                cfg.gnss_min_cov_roll_deg * jnp.pi / 180.0,
                cfg.gnss_min_cov_pitch_deg * jnp.pi / 180.0,
                cfg.gnss_min_cov_yaw_deg * jnp.pi / 180.0,
            ]
        ),
        can_vel_scale=f(cfg.can_vel_scale_factor),
        can_meas_uncertainty_vel=f(cfg.can_meas_uncertainty_vel_mps),
        can_meas_uncertainty_yaw_rate_rad=f(
            cfg.can_meas_uncertainty_yaw_rate_deg * jnp.pi / 180.0
        ),
    )
