"""Fixed-size device rings — the functional replacement for the reference's
sensor/state deques.

The reference keeps mutex-guarded ``std::deque``s: the 1000-deep EgoState
queue for measurement-latency compensation (reference: ekf_localization.cpp:
397-410, hpp:130), the PCM node's odometry deque for deskewing/pose sync
(pcm_matching.cpp:338-354) and its IMU deque (cpp:326-336). Here each becomes
a chronologically-ordered fixed array + count carried through the jitted
pipeline; "pop front when full" is a roll, and the reference's
clear-on-time-regression guards are masked resets.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from .. import pytree

from ..ops import lie


@pytree.dataclass
class EgoRing:
    """Published EKF state history (the fields PCM consumes from
    /app/loc/ekf_pose_odom: pose, local twist — see UpdateEkfOdom,
    ekf_localization.cpp:518-556)."""

    t: jnp.ndarray          # [R]
    pos: jnp.ndarray        # [R,3]
    rpy: jnp.ndarray        # [R,3]
    vel_local: jnp.ndarray  # [R,3]
    gyro: jnp.ndarray       # [R,3]
    count: jnp.ndarray      # int32 valid entries (chronological prefix)

    @property
    def capacity(self) -> int:
        return self.t.shape[0]

    def valid_mask(self):
        return jnp.arange(self.capacity) < self.count


@pytree.dataclass
class ImuRing:
    t: jnp.ndarray     # [R]
    gyro: jnp.ndarray  # [R,3]
    acc: jnp.ndarray   # [R,3]
    count: jnp.ndarray

    @property
    def capacity(self) -> int:
        return self.t.shape[0]

    def valid_mask(self):
        return jnp.arange(self.capacity) < self.count


def make_ego_ring(capacity: int, dtype=jnp.float32) -> EgoRing:
    z = lambda *shape: jnp.zeros(shape, dtype=dtype)
    return EgoRing(
        t=z(capacity), pos=z(capacity, 3), rpy=z(capacity, 3),
        vel_local=z(capacity, 3), gyro=z(capacity, 3),
        count=jnp.asarray(0, jnp.int32),
    )


def make_imu_ring(capacity: int, dtype=jnp.float32) -> ImuRing:
    z = lambda *shape: jnp.zeros(shape, dtype=dtype)
    return ImuRing(
        t=z(capacity), gyro=z(capacity, 3), acc=z(capacity, 3),
        count=jnp.asarray(0, jnp.int32),
    )


def _push_arrays(ring, fields, new_t, guard_eps, clear_on_regress):
    """Shared push: append chronologically; full ring rolls left; a
    time-regression clears first (pcm_matching.cpp:330-334, 345-350 /
    ekf_localization.cpp:405)."""
    cap = ring.capacity
    count = ring.count
    last_t = ring.t[jnp.maximum(count - 1, 0)]
    has = count > 0

    regress = has & (last_t > new_t)
    count = jnp.where(regress & clear_on_regress, 0, count)
    has = count > 0
    last_t = ring.t[jnp.maximum(count - 1, 0)]

    # EKF-side dedupe: only push if newer by eps (ekf_localization.cpp:402)
    accept = (~has) | (last_t + guard_eps < new_t)

    full = count >= cap
    write_idx = jnp.where(full, cap - 1, count)

    def upd(arr, val):
        rolled = jnp.where(full, jnp.roll(arr, -1, axis=0), arr)
        return jnp.where(
            accept, rolled.at[write_idx].set(jnp.asarray(val, arr.dtype)), arr
        )

    new_fields = {k: upd(getattr(ring, k), v) for k, v in fields.items()}
    new_count = jnp.where(accept, jnp.minimum(count + 1, cap), count)
    return ring.replace(count=new_count, **new_fields)


def push_ego(ring: EgoRing, t, pos, rpy, vel_local, gyro) -> EgoRing:
    return _push_arrays(
        ring,
        dict(t=t * jnp.ones(()), pos=pos, rpy=rpy, vel_local=vel_local, gyro=gyro),
        t,
        guard_eps=1e-5,
        clear_on_regress=jnp.asarray(True),
    )


def push_imu(ring: ImuRing, t, gyro, acc) -> ImuRing:
    return _push_arrays(
        ring,
        dict(t=t * jnp.ones(()), gyro=gyro, acc=acc),
        t,
        guard_eps=0.0,
        clear_on_regress=jnp.asarray(True),
    )


def _push_arrays_batch(ring, fields, new_t, valid, guard_eps):
    """M chronological pushes at once — same result as M sequential
    :func:`_push_arrays` calls, but the ring buffers are touched ONCE (one
    variable roll + one scatter per field) instead of per sample. In the
    fused frame the per-sample pushes were a sequence of small ring updates
    per IMU sample.

    PRECONDITION: ``new_t`` is nondecreasing over ``valid`` samples — true
    for build_fused_batches sub-batches (events are bucketed time-sorted).
    Under that ordering a time regression can only occur at the FIRST valid
    sample (handled: clears like the sequential guard); the eps-dedupe
    acceptance chain is computed exactly with a scalar scan."""
    cap = ring.capacity
    if new_t.shape[0] > cap:
        # Degrade like the sequential path: M rolling pushes into a cap-deep
        # ring retain (at most) the last cap samples, so only the last cap
        # rows can survive — push exactly those. (A pathological dedupe that
        # rejects some of them could differ from true sequential semantics
        # by retaining fewer; monotone fused sub-batches never hit that.)
        new_t = new_t[-cap:]
        valid = valid[-cap:]
        fields = {k: v[-cap:] for k, v in fields.items()}
    count0 = ring.count
    has0 = count0 > 0
    last0 = ring.t[jnp.maximum(count0 - 1, 0)]

    any_valid = jnp.any(valid)
    first_t = new_t[jnp.argmax(valid)]
    regress = any_valid & has0 & (last0 > first_t)
    count0 = jnp.where(regress, 0, count0)
    has0 = count0 > 0
    last0 = jnp.where(has0, ring.t[jnp.maximum(count0 - 1, 0)], -jnp.inf)

    def acc_body(last, tv):
        t, v = tv
        a = v & (last + guard_eps < t)
        return jnp.where(a, t, last), a

    _, accept = jax.lax.scan(acc_body, last0.astype(new_t.dtype),
                             (new_t, valid))
    ranks = jnp.cumsum(accept.astype(jnp.int32)) - 1
    n_acc = ranks[-1] + 1
    # rolling once by the total overflow == rolling by 1 per overflowing
    # push (both drop the same oldest entries)
    roll_amt = jnp.maximum(count0 + n_acc - cap, 0)
    base = count0 - roll_amt
    dst = jnp.where(accept, base + ranks, cap)  # cap row = dropped

    def upd(arr, vals):
        return jnp.roll(arr, -roll_amt, axis=0).at[dst].set(
            jnp.asarray(vals, arr.dtype), mode="drop")

    new_fields = {k: upd(getattr(ring, k), v) for k, v in fields.items()}
    new_count = jnp.minimum(count0 + n_acc, cap)
    return ring.replace(count=new_count, **new_fields)


def push_ego_batch(ring: EgoRing, t, pos, rpy, vel_local, gyro,
                   valid) -> EgoRing:
    """Batch form of :func:`push_ego` for the fused frame's IMU sub-batch."""
    return _push_arrays_batch(
        ring, dict(t=t, pos=pos, rpy=rpy, vel_local=vel_local, gyro=gyro),
        t, valid, guard_eps=1e-5,
    )


def push_imu_batch(ring: ImuRing, t, gyro, acc, valid) -> ImuRing:
    """Batch form of :func:`push_imu`."""
    return _push_arrays_batch(
        ring, dict(t=t, gyro=gyro, acc=acc), t, valid, guard_eps=0.0,
    )


# --------------------------------------------------------------------------- #
# Pose interpolation at scan-end time (GetInterpolatedPose,
# pcm_matching.cpp:933-1045)
# --------------------------------------------------------------------------- #

def get_interpolated_pose(ring: EgoRing, t):
    """Ego pose at time t from the odometry ring: slerp between the bracketing
    samples, or velocity/Euler-rate extrapolation past the last one.
    Returns (pose [4,4], found bool)."""
    dtype = ring.pos.dtype
    valid = ring.valid_mask()
    le = valid & (ring.t <= t)
    gt = valid & (ring.t > t)
    found_before = jnp.any(le)
    found_after = jnp.any(gt)

    n = ring.capacity
    before_idx = jnp.where(found_before, n - 1 - jnp.argmax(le[::-1]), 0)
    after_idx = jnp.where(found_after, jnp.argmax(gt), before_idx)

    def tf_of(i):
        return lie.make_transform(lie.euler_to_rot(ring.rpy[i]), ring.pos[i])

    tf_before = tf_of(before_idx)

    # Extrapolated "after" sample (cpp:956-1011)
    last = jnp.maximum(ring.count - 1, 0)
    dt_ex = t - ring.t[last]
    rpy_l = ring.rpy[last]
    rot_l = lie.euler_to_rot(rpy_l)
    v_glob = jnp.matmul(rot_l, ring.vel_local[last], precision=lie._HI)
    pos_ex = ring.pos[last] + v_glob * dt_ex
    rpy_ex = rpy_l + ring.gyro[last] * dt_ex
    tf_after_ex = lie.make_transform(lie.euler_to_rot(rpy_ex), pos_ex)
    t_after_ex = t

    tf_after = jnp.where(found_after, tf_of(after_idx), tf_after_ex)
    t_after = jnp.where(found_after, ring.t[after_idx], t_after_ex)

    between = lie.compose(lie.transform_inverse(tf_before), tf_after)
    dt_scan = t - ring.t[before_idx]
    dt_trans = t_after - ring.t[before_idx]
    interp = lie.interpolate_tf_with_time(between, dt_scan, dt_trans)
    pose = lie.compose(tf_before, interp)
    return pose.astype(dtype), found_before


# --------------------------------------------------------------------------- #
# Measurement-latency compensation (GnssTimeCompensation,
# ekf_localization.cpp:323-394)
# --------------------------------------------------------------------------- #

def gnss_time_compensation(ring: EgoRing, meas_t, meas_pos, meas_quat):
    """Forward-extrapolate a late measurement to the EKF's current time by
    linear-ratio interpolation over the ego-state ring.

    Returns (t', pos', quat', ok). ok=False when the ring is empty or its
    oldest entry is already newer than the measurement (cpp:331-336) —
    the caller must then drop the measurement."""
    valid = ring.valid_mask()
    has = ring.count > 0
    last = jnp.maximum(ring.count - 1, 0)
    cur_t = ring.t[last]
    cur_pos = ring.pos[last]
    cur_rpy = ring.rpy[last]

    front_idx = 0
    ok = has & (ring.t[front_idx] <= meas_t)

    # closest = first entry with t > meas_t, else the last entry (cpp:339-345)
    gt = valid & (ring.t > meas_t)
    closest_idx = jnp.where(jnp.any(gt), jnp.argmax(gt), last)

    dt = cur_t - meas_t
    need = dt > 0.0
    span = cur_t - ring.t[closest_idx]
    do = need & (jnp.abs(span) > 1e-5)
    ratio = jnp.where(do, dt / jnp.where(span == 0, 1.0, span), 0.0)

    dpos = (cur_pos - ring.pos[closest_idx]) * ratio
    drpy = lie.norm_angle_rad(cur_rpy - ring.rpy[closest_idx]) * ratio

    out_t = jnp.where(need, cur_t, meas_t)
    out_pos = meas_pos + jnp.where(need, dpos, 0.0)
    dq = lie.rot_to_quat(lie.euler_to_rot(jnp.where(need, drpy, jnp.zeros_like(drpy))))
    out_quat = lie.quat_normalize(lie.quat_mul(meas_quat, dq))
    return out_t, out_pos, out_quat, ok
