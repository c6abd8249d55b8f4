"""27-state error-state EKF — pure-function re-implementation in JAX.

Every routine mirrors the math and gating of the reference EkfAlgorithm
(reference: src/app/localization/ekf_localization/src/ekf_algorithm.cpp) but is
a pure function  (state, input, params) -> state  built from masked selects
instead of early returns, so the whole filter jits, scans, and vmaps. The
reference's mutex/try_lock priority scheme (ekf_algorithm.cpp:167-173)
disappears: the replay runtime feeds events in deterministic time order.

Known reference quirks preserved deliberately (see SURVEY.md §7):
  * Non-IMU CA model Q uses the gyro std in deg/s unscaled (cpp:139).
  * Q bias blocks square an already-covariance-named config value (cpp:266-270).
  * CalibrateVehicleToImu computes an adaptive R then overwrites it with the
    fixed (1 deg)^2 diagonal (cpp:759-763) — we implement the effective fixed R.
  * ZuptImu computes gyro/acc coefficients it never uses (cpp:536-537).
  * The PCM warm-up counter is never reset by PCM_INIT (cpp:324-349).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp

from ..config import EkfConfig, GnssSource, GpsType
from ..ops.lie import _HI
from ..ops import lie
from ..ops.frames import global_to_local_velocity
from .state import (
    CanMeas,
    EkfParams,
    EkfState,
    GnssMeas,
    ImuMeas,
    INIT_STATE_COV,
    STATE_ORDER,
    S_AX,
    S_AZ,
    S_B_AX,
    S_B_ROLL_RATE,
    S_G_X,
    S_G_Z,
    S_IMU_ROLL,
    S_PITCH,
    S_ROLL,
    S_ROLL_RATE,
    S_VX,
    S_VZ,
    S_X,
    S_YAW,
    S_YAW_RATE,
    S_Z,
)

_D2R = jnp.pi / 180.0


def _bmm(a, b):
    """Small [m,k]@[k,n] as broadcast-multiply-reduce.

    Exact f32 elementwise arithmetic that fuses with neighboring work; a
    ``jnp.matmul(..., precision=HIGHEST)`` on these tiny shapes is a
    separate dot per product inside the latency-bound 100-400 Hz IMU
    chain."""
    return jnp.sum(a[:, :, None] * b[None, :, :], axis=1)


def _latency_forms(dtype) -> bool:
    """True when the latency-oriented elementwise forms (``_bmm``, sparse
    F P F^T) should replace dense HIGHEST-precision matmuls.

    f32 is the device production dtype — there the forms are exact (f32
    elementwise arithmetic). f64 is the ORACLE-PARITY mode: the
    closed-loop parity tests (tests/test_oracle_parity.py) pin the pipeline
    against the float64 NumPy transliteration at centimeter bounds, which
    requires matching its dense accumulation order — an algebraically
    identical reordering drifts a rounding-level per-step difference
    through the ICP feedback loop's discrete decisions (measured: 1e-16
    open-loop, decimeters closed-loop on GICP). The two forms' algebraic
    identity is pinned directly by tests/test_ekf.py (sparse-vs-dense
    propagate on symmetric P)."""
    return dtype == jnp.float32


@dataclasses.dataclass(frozen=True)
class EkfFlags:
    """Static (compile-time) feature switches — the reference's boolean config
    reads become trace-time Python branches."""

    use_zupt: bool = False
    use_complementary_filter: bool = True
    imu_estimate_gravity: bool = True
    imu_estimate_calibration: bool = False
    gps_type: int = int(GpsType.NAVSATFIX)
    # Joseph-form covariance update (I-KH)P(I-KH)^T + KRK^T instead of the
    # reference's plain P -= KHP (ekf_algorithm.hpp:144). Off by default for
    # parity; recommended for long float32 runs (keeps P symmetric PSD).
    joseph_form: bool = False

    @classmethod
    def from_config(cls, cfg: EkfConfig) -> "EkfFlags":
        return cls(
            use_zupt=cfg.use_zupt,
            use_complementary_filter=cfg.use_complementary_filter,
            imu_estimate_gravity=cfg.imu_estimate_gravity,
            imu_estimate_calibration=cfg.imu_estimate_calibration,
            gps_type=int(cfg.gps_type),
        )

    @property
    def run_cf(self) -> bool:
        # reference: ekf_algorithm.cpp:203, 312
        return self.gps_type == int(GpsType.BESTPOS) or self.use_complementary_filter


def _select(pred, new_state: EkfState, old_state: EkfState) -> EkfState:
    """Pytree-wide where(pred, new, old) for scalar bool pred."""
    return jax.tree_util.tree_map(
        lambda a, b: jnp.where(pred, a, b), new_state, old_state
    )


# --------------------------------------------------------------------------- #
# Init (ekf_algorithm.cpp:22-66)
# --------------------------------------------------------------------------- #

def init_state(params: EkfParams, dtype=jnp.float32) -> EkfState:
    rot = lie.rot_to_quat(lie.euler_to_rot(params.init_rpy.astype(dtype)))
    P = jnp.eye(STATE_ORDER, dtype=dtype) * INIT_STATE_COV
    diag_idx = jnp.arange(STATE_ORDER)
    bias_gyro = params.imu_bias_cov_gyro.astype(dtype)
    bias_acc = params.imu_bias_cov_acc.astype(dtype)
    for i in range(S_B_ROLL_RATE, S_B_ROLL_RATE + 3):
        P = P.at[i, i].set(bias_gyro)
    for i in range(S_B_AX, S_B_AX + 3):
        P = P.at[i, i].set(bias_acc)
    for i in range(S_G_X, S_G_X + 3):
        P = P.at[i, i].set(bias_acc)
    for i in range(S_IMU_ROLL, S_IMU_ROLL + 3):
        P = P.at[i, i].set(bias_gyro)
    del diag_idx

    z3 = jnp.zeros(3, dtype=dtype)
    f = lambda v: jnp.asarray(v, dtype=dtype)
    b = lambda v: jnp.asarray(v, dtype=bool)
    return EkfState(
        pos=params.init_pos.astype(dtype),
        rot=rot.astype(dtype),
        vel=z3,
        gyro=z3,
        acc=z3,
        bg=z3,
        ba=z3,
        grav=jnp.array([0.0, 0.0, 1.0], dtype=dtype) * params.imu_gravity.astype(dtype),
        imu_rot=lie.quat_identity(dtype),
        P=P,
        reset_for_init_prediction=b(True),
        state_initialized=b(False),
        yaw_initialized=b(False),
        rotation_stabilized=b(False),
        state_stabilized=b(False),
        pcm_init_on_going=b(False),
        vehicle_imu_calib_started=b(False),
        can_yaw_rate_bias=f(0.0),
        pcm_update_count=jnp.asarray(0, dtype=jnp.int32),
        prev_timestamp=f(0.0),
        prev_gnss_timestamp=f(0.0),
        prev_can_timestamp=f(0.0),
        cf_initialized=b(False),
        cf_prev_vel_local_x=f(0.0),
        cf_prev_time=f(0.0),
    )


# --------------------------------------------------------------------------- #
# Convergence gates (ekf_algorithm.hpp:148-209)
# --------------------------------------------------------------------------- #

def _std(P, i):
    return jnp.sqrt(jnp.maximum(P[i, i], 0.0))


def check_state_initialized(P):
    lim = 5.0 * _D2R
    return (
        (_std(P, S_ROLL) < lim)
        & (_std(P, S_PITCH) < lim)
        & (_std(P, S_YAW) < lim)
        & (_std(P, S_X) < 1.0)
        & (_std(P, S_X + 1) < 1.0)
    )


def check_yaw_initialized(P):
    return _std(P, S_YAW) < 5.0 * _D2R


def check_rotation_stabilized(P):
    lim = 0.2 * _D2R
    return (_std(P, S_ROLL) < lim) & (_std(P, S_PITCH) < lim) & (_std(P, S_YAW) < lim)


def check_state_stabilized(P):
    lim = 0.2 * _D2R
    return (
        (_std(P, S_ROLL) < lim)
        & (_std(P, S_PITCH) < lim)
        & (_std(P, S_YAW) < lim)
        & (_std(P, S_X) < 0.5)
        & (_std(P, S_X + 1) < 0.5)
    )


# --------------------------------------------------------------------------- #
# Generic measurement injection (ekf_algorithm.hpp:116-145)
# --------------------------------------------------------------------------- #

def _ekf_measurement_update(state: EkfState, idx: Tuple[int, ...], Y, R,
                            joseph: bool = False):
    """One Kalman update where H is a 0/1 selector of state indices ``idx``
    (true for every observation model in the reference). Returns the updated
    nominal state pieces and P; caller applies masking."""
    P = state.P
    idx_a = jnp.asarray(idx)
    Pi = P[idx_a, :]                    # H P, [m,27]
    S = Pi[:, idx_a] + R                # H P H^T + R
    PHt = P[:, idx_a]                   # [27,m]
    m = len(idx)
    small = m <= 3 and _latency_forms(P.dtype)
    mm = _bmm if small else (lambda a, b: jnp.matmul(a, b, precision=_HI))
    if m == 2:
        # closed-form 2x2 inverse: linalg.solve lowers to an LU custom call
        # on every step of the 100-400 Hz IMU chain; S is SPD here, the
        # adjugate form is numerically fine
        det = S[0, 0] * S[1, 1] - S[0, 1] * S[1, 0]
        Sinv = jnp.array([[S[1, 1], -S[0, 1]],
                          [-S[1, 0], S[0, 0]]]) / det
        K = mm(PHt, Sinv)
    elif m == 3:
        Sinv = lie.inv3x3(S)
        K = mm(PHt, Sinv)
    else:
        K = jnp.linalg.solve(S.T, PHt.T).T  # K = P H^T S^-1
    if small:
        su = jnp.sum(K * Y[None, :], axis=1)  # full-state additive update
    else:
        su = jnp.matmul(K, Y, precision=_HI)
    if joseph:
        # (I-KH)P(I-KH)^T + KRK^T with H a selector: KH = scatter of K's
        # columns into the observed state columns.
        ikh = jnp.eye(P.shape[0], dtype=P.dtype).at[:, idx_a].add(-K)
        P_new = (
            jnp.einsum("ij,jk,lk->il", ikh, P, ikh, precision=_HI)
            + jnp.einsum("ij,jk,lk->il", K, R, K, precision=_HI)
        )
    else:
        # P -= K H P (reference form)
        P_new = P - mm(K, Pi)

    rot = lie.quat_normalize(
        lie.quat_mul(state.rot, lie.quat_from_axis_angle(su[3:6]))
    )
    imu_rot = lie.quat_normalize(
        lie.quat_mul(state.imu_rot, lie.quat_from_axis_angle(su[24:27]))
    )
    return state.replace(
        pos=state.pos + su[0:3],
        vel=state.vel + su[6:9],
        gyro=state.gyro + su[9:12],
        acc=state.acc + su[12:15],
        bg=state.bg + su[15:18],
        ba=state.ba + su[18:21],
        grav=state.grav + su[21:24],
        rot=rot,
        imu_rot=imu_rot,
        P=P_new,
    )


# --------------------------------------------------------------------------- #
# IMU prediction (ekf_algorithm.cpp:167-316)
# --------------------------------------------------------------------------- #

def _fpf_dense(P, G_R_I, Jr, dt, flags: EkfFlags, dtype):
    """F P F^T with the dense state-transition Jacobian (cpp:275-297) —
    the oracle-parity form (matches reference_cpu's accumulation order)."""
    eye3 = jnp.eye(3, dtype=dtype)
    F = jnp.eye(STATE_ORDER, dtype=dtype)
    F = F.at[S_X:S_X + 3, S_VX:S_VX + 3].set(eye3 * dt)
    F = F.at[S_X:S_X + 3, S_B_AX:S_B_AX + 3].set(-0.5 * G_R_I * dt * dt)
    F = F.at[S_ROLL:S_ROLL + 3, S_B_ROLL_RATE:S_B_ROLL_RATE + 3].set(-Jr)
    F = F.at[S_VX:S_VX + 3, S_B_AX:S_B_AX + 3].set(-G_R_I * dt)
    F = F.at[S_ROLL_RATE:S_ROLL_RATE + 3, S_B_ROLL_RATE:S_B_ROLL_RATE + 3].set(-eye3)
    F = F.at[S_AX:S_AX + 3, S_B_AX:S_B_AX + 3].set(-G_R_I)
    if flags.imu_estimate_gravity:
        F = F.at[S_Z, S_G_Z].set(-0.5 * dt * dt)
        F = F.at[S_VZ, S_G_Z].set(-dt)
        F = F.at[S_AZ, S_G_Z].set(-1.0)
    return jnp.einsum("ij,jk,lk->il", F, P, F, precision=_HI)


def _fpf_sparse(P, G_R_I, Jr, dt, flags: EkfFlags):
    """F P F^T in sparse block form — the f32 production form.

    F = I + A where A's only nonzero rows are 0:15 (pos/rot/vel/gyro/acc
    blocks vs the vel / bias-gyro / bias-acc / gravity-z columns). With P
    symmetric,
        F P F^T = P + B + B^T + A B^T,   B = A P,
    and each block-row of "A @ X" is a couple of 3x3 @ 3xN products — fused
    elementwise arithmetic instead of two dense 27x27 HIGHEST-precision
    dots in the latency-bound IMU chain. Algebraic identity with
    ``_fpf_dense`` is pinned by tests/test_ekf.py::test_fpf_sparse_matches_dense;
    f64 keeps the dense form for closed-loop oracle-parity bit compatibility
    (see ``_latency_forms``)."""

    def a_rows(X):
        """Rows 0:15 of A @ X for X of shape [27, n]."""
        Gx = _bmm(G_R_I, X[S_B_AX:S_B_AX + 3])
        Jx = _bmm(Jr, X[S_B_ROLL_RATE:S_B_ROLL_RATE + 3])
        r_pos = dt * X[S_VX:S_VX + 3] - (0.5 * dt * dt) * Gx
        r_rot = -Jx
        r_vel = -dt * Gx
        r_gyro = -X[S_B_ROLL_RATE:S_B_ROLL_RATE + 3]
        r_acc = -Gx
        if flags.imu_estimate_gravity:
            gz = X[S_G_Z]
            r_pos = r_pos.at[2].add(-(0.5 * dt * dt) * gz)
            r_vel = r_vel.at[2].add(-dt * gz)
            r_acc = r_acc.at[2].add(-gz)
        return jnp.concatenate([r_pos, r_rot, r_vel, r_gyro, r_acc], axis=0)

    B = a_rows(P)                # [15, 27] = nonzero rows of A P
    C = a_rows(B.T)              # [15, 15] = nonzero block of A (A P)^T
    P_new = P.at[:15, :].add(B)
    P_new = P_new.at[:, :15].add(B.T)
    return P_new.at[:15, :15].add(C)


def _propagate_imu(state: EkfState, imu: ImuMeas, dt, params: EkfParams,
                   flags: EkfFlags) -> EkfState:
    """FAST-LIO-style nominal propagation + covariance (cpp:228-300)."""
    dtype = state.P.dtype
    G_R_I = lie.quat_to_rot(state.rot)

    corrected_gyro = imu.gyro - state.bg
    delta_rot = lie.exp_gyro_to_quat(corrected_gyro, dt)
    rot_new = lie.quat_normalize(lie.quat_mul(state.rot, delta_rot))

    corrected_accel = imu.acc - state.ba
    accel_global = jnp.matmul(G_R_I, corrected_accel, precision=_HI) - state.grav

    pos_new = state.pos + state.vel * dt + 0.5 * accel_global * dt * dt
    vel_new = state.vel + accel_global * dt

    # Process noise Q (cpp:256-272)
    dt2 = dt * dt
    qd = jnp.zeros(STATE_ORDER, dtype=dtype)
    qd = qd.at[S_X:S_X + 3].set(params.state_std_pos_m**2 * dt2)
    qd = qd.at[S_ROLL:S_ROLL + 3].set(params.state_std_rot_rad**2 * dt2)
    qd = qd.at[S_VX:S_VX + 3].set(params.state_std_vel_mps**2 * dt2)
    qd = qd.at[S_ROLL_RATE:S_ROLL_RATE + 3].set(params.imu_std_gyro_rad**2 * dt2)
    qd = qd.at[S_AX:S_AX + 3].set(params.imu_std_acc_mps**2 * dt2)
    qd = qd.at[S_B_ROLL_RATE:S_B_ROLL_RATE + 3].set(params.imu_bias_cov_gyro**2 * dt2)
    qd = qd.at[S_B_AX:S_B_AX + 3].set(params.imu_bias_cov_acc**2 * dt2)
    qd = qd.at[S_G_X:S_G_X + 3].set(params.imu_bias_cov_acc**2 * dt2)
    qd = qd.at[S_IMU_ROLL:S_IMU_ROLL + 3].set(params.state_std_rot_rad**2 * dt2)
    Q = jnp.diag(qd)

    Jr = lie.right_jacobian_d_rot_d_gyro(corrected_gyro, dt)
    if _latency_forms(dtype):
        P_new = _fpf_sparse(state.P, G_R_I, Jr, dt, flags) + Q
    else:
        P_new = _fpf_dense(state.P, G_R_I, Jr, dt, flags, dtype) + Q

    return state.replace(
        pos=pos_new,
        rot=rot_new,
        vel=vel_new,
        gyro=corrected_gyro,
        acc=accel_global,
        P=P_new,
    )


def _zupt_imu(state: EkfState, imu: ImuMeas, flags: EkfFlags) -> EkfState:
    """Zero-velocity potential update (cpp:508-565), masked."""
    alpha = 0.01
    gamma = 0.01
    vel_thre, gyro_thre, acc_thre = 0.1, 0.1, 0.1

    vel_local = lie.quat_rotate(lie.quat_conj(state.rot), state.vel)
    vel_ok = jnp.abs(vel_local[0]) <= vel_thre

    vel_coeff = (vel_thre - jnp.abs(vel_local[0])) / vel_thre * 0.1
    vel_new = state.vel + vel_coeff * (-state.vel)
    vel_new = jnp.where(vel_ok, vel_new, state.vel)

    bias_ok = vel_ok & (
        jnp.linalg.norm(state.gyro) <= gyro_thre
    ) & (jnp.linalg.norm(state.acc[:2]) <= acc_thre)

    gyro_error = imu.gyro - state.bg
    bg_new = jnp.where(bias_ok, state.bg + gamma * gyro_error, state.bg)

    grav_local = lie.quat_rotate(lie.quat_conj(state.rot), state.grav)
    acc_error_loc = imu.acc - (grav_local + state.ba)
    acc_error_global = lie.quat_rotate(state.rot, imu.acc - state.ba) - state.grav
    ba_new = jnp.where(bias_ok, state.ba + alpha * acc_error_loc, state.ba)

    grav_new = state.grav
    if flags.imu_estimate_gravity:
        grav_new = grav_new.at[2].set(
            jnp.where(bias_ok, state.grav[2] + alpha * acc_error_global[2], state.grav[2])
        )

    return state.replace(vel=vel_new, bg=bg_new, ba=ba_new, grav=grav_new)


def _complementary_filter(state: EkfState, imu: ImuMeas, params: EkfParams,
                          flags: EkfFlags) -> EkfState:
    """Gravity-direction roll/pitch correction (cpp:597-701), masked."""
    acc_meas = imu.acc - state.ba
    vel_local = lie.quat_rotate(lie.quat_conj(state.rot), state.vel)
    centripetal_acc = vel_local[0] * state.gyro[2]

    # C++ function statics: first invocation seeds them and falls through the
    # dt < 1e-6 early-return (cpp:613-617).
    first = ~state.cf_initialized
    prev_t = jnp.where(first, imu.timestamp, state.cf_prev_time)
    prev_vx = jnp.where(first, vel_local[0], state.cf_prev_vel_local_x)
    dt = imu.timestamp - prev_t
    run = dt >= 1e-6

    safe_dt = jnp.where(run, dt, 1.0)
    est_acc_x = (vel_local[0] - prev_vx) / safe_dt

    compensated = acc_meas - jnp.array([0.0, 1.0, 0.0], dtype=acc_meas.dtype) * centripetal_acc
    compensated = jnp.where(
        state.rotation_stabilized,
        compensated - jnp.array([1.0, 0.0, 0.0], dtype=acc_meas.dtype) * est_acc_x,
        compensated,
    )

    acc_diff = jnp.linalg.norm(acc_meas) - jnp.linalg.norm(state.grav)

    norm_c = jnp.linalg.norm(compensated)
    run = run & (norm_c > 1e-12)  # guard: reference would NaN on a zero vector
    gdir = compensated / jnp.where(norm_c > 1e-12, norm_c, 1.0)

    z = jnp.stack(
        [jnp.arctan2(gdir[1], gdir[2]), -jnp.arcsin(jnp.clip(gdir[0], -1.0, 1.0))]
    )
    rpy = lie.rot_to_euler(lie.quat_to_rot(state.rot))
    innovation = lie.norm_angle_rad(z - rpy[:2])

    base_unc = jnp.where(state.state_initialized, 1.0 * _D2R, 10.0 * _D2R)
    centr_unc = jnp.abs(centripetal_acc) / 9.81 * 10.0
    longi_unc = jnp.abs(est_acc_x) / 9.81 * 10.0
    accd_unc = jnp.abs(acc_diff) / 9.81 * 10.0
    lat_scale = 1.0 + accd_unc + centr_unc
    longi_scale = 1.0 + accd_unc + longi_unc
    min_r = (1.0 * _D2R) ** 2
    R = jnp.diag(
        jnp.stack(
            [
                jnp.maximum((base_unc * lat_scale) ** 2, min_r),
                jnp.maximum((base_unc * longi_scale) ** 2, min_r),
            ]
        )
    ).astype(state.P.dtype)

    updated = _ekf_measurement_update(state, (S_ROLL, S_PITCH), innovation, R, joseph=flags.joseph_form)
    updated = updated.replace(
        cf_initialized=jnp.asarray(True),
        cf_prev_vel_local_x=vel_local[0],
        cf_prev_time=imu.timestamp,
    )
    # Statics advance whenever the body runs past the dt guard; on the guarded
    # path only the (possibly first-call) seed is kept.
    seeded = state.replace(
        cf_initialized=jnp.asarray(True),
        cf_prev_vel_local_x=prev_vx,
        cf_prev_time=prev_t,
    )
    return _select(run, updated, seeded)


def _calibrate_vehicle_to_imu(state: EkfState, imu: ImuMeas,
                              joseph: bool = False) -> EkfState:
    """Online vehicle->IMU mounting calibration (cpp:703-776), masked."""
    run = (jnp.linalg.norm(state.vel) >= 3.0) & state.rotation_stabilized

    # (R_veh * R_imu^-1)^-1 * vel  =  R_imu * R_veh^T * vel
    q = lie.quat_mul(state.rot, lie.quat_conj(state.imu_rot))
    v_local = lie.quat_rotate(lie.quat_conj(q), state.vel)
    n = jnp.linalg.norm(v_local)
    v_dir = v_local / jnp.where(n > 1e-12, n, 1.0)

    yaw = jnp.arctan2(v_dir[1], v_dir[0])
    pitch = -jnp.arcsin(jnp.clip(v_dir[2], -1.0, 1.0))
    innovation = jnp.stack([jnp.zeros_like(yaw), -pitch, -yaw])

    # The adaptive R computed at cpp:744-759 is immediately overwritten with a
    # fixed (1 deg)^2 diagonal at cpp:761-763; implement the effective value.
    R = jnp.eye(3, dtype=state.P.dtype) * (1.0 * _D2R) ** 2

    updated = _ekf_measurement_update(
        state, (S_IMU_ROLL, S_IMU_ROLL + 1, S_IMU_ROLL + 2), innovation, R,
        joseph=joseph,
    )
    updated = updated.replace(vehicle_imu_calib_started=jnp.asarray(True))
    return _select(run, updated, state)


def predict_imu(state: EkfState, imu: ImuMeas, params: EkfParams,
                flags: EkfFlags) -> EkfState:
    """RunPredictionImu (cpp:167-316) with the early returns as masks.

    Gate order matches the reference exactly:
      reset-for-init -> pcm-init quarantine -> rotation-stabilized refresh ->
      state-initialized (complementary filter only) -> new-data -> propagate.
    """
    t = imu.timestamp
    reset = state.reset_for_init_prediction
    pcm_going = state.pcm_init_on_going
    gate_early = reset | pcm_going

    rot_stab = jnp.where(
        gate_early, state.rotation_stabilized, check_rotation_stabilized(state.P)
    )
    state = state.replace(rotation_stabilized=rot_stab)

    initialized = state.state_initialized
    dt = t - state.prev_timestamp
    new_data = jnp.abs(dt) >= 1e-6
    do_predict = (~gate_early) & initialized & new_data

    # Nominal + covariance propagation (always traced, masked in).
    propagated = _propagate_imu(state, imu, jnp.where(do_predict, dt, 1e-3), params, flags)
    state = _select(do_predict, propagated, state)

    if flags.use_zupt:
        state = _select(do_predict, _zupt_imu(state, imu, flags), state)

    if flags.run_cf:
        cf_mask = do_predict | ((~gate_early) & (~initialized) & state.yaw_initialized)
        state = _select(cf_mask, _complementary_filter(state, imu, params, flags), state)

    if flags.imu_estimate_calibration:
        state = _select(do_predict, _calibrate_vehicle_to_imu(state, imu, flags.joseph_form), state)

    prev_ts = jnp.where(gate_early | (~initialized) | do_predict, t, state.prev_timestamp)
    return state.replace(
        prev_timestamp=prev_ts,
        reset_for_init_prediction=jnp.zeros_like(reset),
    )


# --------------------------------------------------------------------------- #
# Non-IMU constant-acceleration prediction (ekf_algorithm.cpp:81-165)
# --------------------------------------------------------------------------- #

def predict(state: EkfState, timestamp, params: EkfParams) -> EkfState:
    """RunPrediction — the system-clock CA fallback when use_imu is off."""
    t = jnp.asarray(timestamp, dtype=state.P.dtype)
    reset = state.reset_for_init_prediction
    pcm_going = state.pcm_init_on_going
    gate_early = reset | pcm_going
    dt = t - state.prev_timestamp
    new_data = jnp.abs(dt) >= 1e-6
    do_predict = (~gate_early) & new_data
    dts = jnp.where(do_predict, dt, 1e-3)

    dtype = state.P.dtype
    delta_rot = lie.exp_gyro_to_quat(state.gyro, dts)
    pos_new = state.pos + state.vel * dts + 0.5 * state.acc * dts * dts
    rot_new = lie.quat_normalize(lie.quat_mul(state.rot, delta_rot))
    vel_new = state.vel + state.acc * dts

    dt2 = dts * dts
    qd = jnp.zeros(STATE_ORDER, dtype=dtype)
    qd = qd.at[S_X:S_X + 3].set(params.state_std_pos_m**2 * dt2)
    qd = qd.at[S_ROLL:S_ROLL + 3].set(params.state_std_rot_rad**2 * dt2)
    qd = qd.at[S_VX:S_VX + 3].set(params.state_std_vel_mps**2 * dt2)
    # Quirk preserved: gyro std used in deg/s without conversion (cpp:138-139).
    qd = qd.at[S_ROLL_RATE:S_ROLL_RATE + 3].set(params.state_std_gyro_dps**2 * dt2)
    qd = qd.at[S_AX:S_AX + 3].set(params.state_std_acc_mps**2 * dt2)
    Q = jnp.diag(qd)

    eye3 = jnp.eye(3, dtype=dtype)
    F = jnp.eye(STATE_ORDER, dtype=dtype)
    F = F.at[S_X:S_X + 3, S_VX:S_VX + 3].set(eye3 * dts)
    F = F.at[S_ROLL:S_ROLL + 3, S_ROLL_RATE:S_ROLL_RATE + 3].set(eye3 * dts)
    F = F.at[S_X:S_X + 3, S_AX:S_AX + 3].set(eye3 * 0.5 * dt2)
    F = F.at[S_VX:S_VX + 3, S_AX:S_AX + 3].set(eye3 * dts)
    P_new = jnp.einsum("ij,jk,lk->il", F, state.P, F, precision=_HI) + Q

    predicted = state.replace(pos=pos_new, rot=rot_new, vel=vel_new, P=P_new)
    state = _select(do_predict, predicted, state)

    prev_ts = jnp.where(gate_early | do_predict, t, state.prev_timestamp)
    return state.replace(
        prev_timestamp=prev_ts, reset_for_init_prediction=jnp.zeros_like(reset)
    )


# --------------------------------------------------------------------------- #
# GNSS / PCM pose update (ekf_algorithm.cpp:318-432)
# --------------------------------------------------------------------------- #

def update_gnss(state: EkfState, meas: GnssMeas, params: EkfParams,
                flags: EkfFlags) -> EkfState:
    dtype = state.P.dtype
    src = meas.source

    # ---- PCM_INIT hard reset branch (cpp:324-349) ----
    z3 = jnp.zeros(3, dtype=dtype)
    P_reset = state.P.at[: S_AZ + 1, : S_AZ + 1].set(
        jnp.eye(S_AZ + 1, dtype=dtype) * INIT_STATE_COV
    )
    reset_state = state.replace(
        pos=meas.pos,
        rot=lie.quat_normalize(meas.rot),
        vel=z3,
        gyro=z3,
        acc=z3,
        bg=z3,
        ba=z3,
        grav=jnp.array([0.0, 0.0, 1.0], dtype=dtype) * params.imu_gravity.astype(dtype),
        P=P_reset,
        state_initialized=jnp.asarray(True),
        yaw_initialized=jnp.asarray(True),
        pcm_init_on_going=jnp.asarray(True),
    )
    is_init = src == int(GnssSource.PCM_INIT)

    # ---- Regular path ----
    # Flag refresh (cpp:351-354)
    P = state.P
    st = state.replace(
        yaw_initialized=check_yaw_initialized(P),
        state_initialized=check_state_initialized(P),
        rotation_stabilized=check_rotation_stabilized(P),
        state_stabilized=check_state_stabilized(P),
    )

    # PCM warm-up release (cpp:357-364); the counter is intentionally never
    # reset elsewhere (reference behavior).
    is_pcm = src == int(GnssSource.PCM)
    warm = st.pcm_init_on_going & is_pcm
    release = warm & (st.pcm_update_count > 10)
    st = st.replace(
        pcm_init_on_going=jnp.where(release, False, st.pcm_init_on_going),
        pcm_update_count=jnp.where(warm, st.pcm_update_count + 1, st.pcm_update_count),
    )

    # Measurement covariance (cpp:383-397)
    R6 = jnp.zeros((6, 6), dtype=dtype)
    R6 = R6.at[:3, :3].set(meas.pos_cov.astype(dtype))
    R6 = R6.at[3:, 3:].set(meas.rot_cov.astype(dtype))
    is_gps_like = (
        (src == int(GnssSource.NOVATEL))
        | (src == int(GnssSource.BESTPOS))
        | (src == int(GnssSource.NAVSATFIX))
    )
    R6 = R6 + jnp.where(is_gps_like, 1.0, 0.0) * jnp.diag(
        params.gnss_min_cov.astype(dtype)
    )

    # Residual (cpp:406-410)
    res_euler = lie.euler_residual_from_quats(st.rot, lie.quat_normalize(meas.rot))
    Y6 = jnp.concatenate([meas.pos - st.pos, res_euler])

    # 3-DOF position-only path for NavSatFix / BESTPOS (cpp:412-425), with the
    # antenna-offset inflation while yaw is uninitialized.
    is_3dof = (src == int(GnssSource.NAVSATFIX)) | (src == int(GnssSource.BESTPOS))
    inflate = jnp.where(is_3dof & (~st.yaw_initialized), 3.0, 0.0)
    R3 = R6[:3, :3] + jnp.diag(jnp.stack([inflate, inflate, jnp.zeros_like(inflate)]))

    upd6 = _ekf_measurement_update(st, tuple(range(6)), Y6, R6,
                                   joseph=flags.joseph_form)
    upd3 = _ekf_measurement_update(st, (0, 1, 2), Y6[:3], R3,
                                   joseph=flags.joseph_form)
    updated = _select(is_3dof, upd3, upd6)

    out = _select(is_init, reset_state, updated)
    # prev_gnss_ is only recorded on the regular path (the PCM_INIT branch
    # returns before cpp:430).
    return out.replace(
        prev_gnss_timestamp=jnp.where(
            is_init, state.prev_gnss_timestamp, meas.timestamp
        )
    )


# --------------------------------------------------------------------------- #
# CAN update (ekf_algorithm.cpp:434-506)
# --------------------------------------------------------------------------- #

def update_can(state: EkfState, can: CanMeas, params: EkfParams,
               flags: EkfFlags) -> EkfState:
    dtype = state.P.dtype
    can_dt = can.timestamp - state.prev_can_timestamp
    run = jnp.abs(can_dt) >= 0.01

    unbiased_gyro_z = can.gyro[2] - state.can_yaw_rate_bias
    unbiased_vel = can.vel.at[0].multiply(params.can_vel_scale.astype(dtype))

    rot_m = lie.quat_to_rot(state.rot)
    can_vel_global = jnp.matmul(rot_m, unbiased_vel, precision=_HI)

    Z = jnp.concatenate([can_vel_global, unbiased_gyro_z[None]])
    Z_state = jnp.concatenate([state.vel, state.gyro[2][None]])
    Y = Z - Z_state

    unc = params.can_meas_uncertainty_vel.astype(dtype)
    R_local = jnp.diag(jnp.stack([unc**2, (2 * unc) ** 2, (2 * unc) ** 2]))
    R = jnp.zeros((4, 4), dtype=dtype)
    R = R.at[:3, :3].set(
        jnp.einsum("ij,jk,lk->il", rot_m, R_local, rot_m, precision=_HI)
    )
    R = R.at[3, 3].set(params.can_meas_uncertainty_yaw_rate_rad.astype(dtype) ** 2)

    updated = _ekf_measurement_update(
        state, (S_VX, S_VX + 1, S_VZ, S_YAW_RATE), Y, R,
        joseph=flags.joseph_form,
    )
    updated = updated.replace(prev_can_timestamp=can.timestamp)

    # ZuptCan (cpp:567-587) runs on the raw (biased) input after the update.
    zupt_on = jnp.linalg.norm(can.vel) <= 0.05
    a = 0.05
    bias_new = a * can.gyro[2] + (1.0 - a) * updated.can_yaw_rate_bias
    zupted = updated.replace(
        can_yaw_rate_bias=jnp.where(zupt_on, bias_new, updated.can_yaw_rate_bias),
        vel=jnp.where(zupt_on, (1.0 - a) * updated.vel, updated.vel),
    )
    return _select(run, zupted, state)


# --------------------------------------------------------------------------- #
# EgoState output (ekf_algorithm.cpp:778-833)
# --------------------------------------------------------------------------- #

def imu_calibration(state: EkfState):
    """Estimated vehicle->IMU mounting rotation as Euler angles (radians) —
    GetImuCalibration equivalent (ekf_algorithm.cpp:835-838)."""
    return lie.rot_to_euler(lie.quat_to_rot(state.imu_rot))


def ego_state(state: EkfState):
    """Pure output function: the published odometry-view of the filter.

    Returns a dict matching the reference's EgoState fields
    (localization_struct.hpp:30-73). The reference's timestamp-dedup early
    return lives in the replay runtime instead.
    """
    rpy = lie.rot_to_euler(lie.quat_to_rot(state.rot))
    v_local = global_to_local_velocity(state.vel, rpy)
    a_local = global_to_local_velocity(state.acc, rpy)
    P = state.P
    pos_var = jnp.stack([P[S_X, S_X], P[S_X + 1, S_X + 1], P[S_Z, S_Z]])
    # Reference rotates the covariance *diagonal* like a vector and takes abs
    # (cpp:814-820) — preserved.
    cov_local = jnp.abs(global_to_local_velocity(pos_var, rpy))
    return {
        "timestamp": state.prev_timestamp,
        "pos": state.pos,
        "rpy": rpy,
        "vel_local": v_local,
        "acc_local": a_local,
        "gyro": state.gyro,
        "pos_cov_local": cov_local,
        "pos_std_global": jnp.sqrt(jnp.maximum(pos_var, 0.0)),
        "rot_cov": jnp.stack(
            [P[S_ROLL, S_ROLL], P[S_PITCH, S_PITCH], P[S_YAW, S_YAW]]
        ),
    }
