"""LiDAR motion compensation (deskewing) — LIO-SAM-style, vectorized.

Re-implements the reference's deskew stage (reference: src/app/localization/
pcm_matching/src/pcm_matching.cpp:467-824):

  * scan-time normalization incl. the ``lidar_scan_time_end`` mode where point
    times are negative offsets from the last point (cpp:477-486);
  * ImuDeskewInfo (cpp:533-585): integrate raw gyro into per-axis rotation
    lookup arrays over the scan span — here one masked ``cumsum`` over a
    fixed-size IMU window;
  * OdomDeskewInfo (cpp:587-729): scan-start -> scan-end translation increment
    from the EKF odometry ring, extrapolating past the last sample by rotated
    local velocity and Euler-rate integration;
  * DeskewPoint (cpp:780-824): per-point rotation (linear interpolation into
    the IMU arrays, FindRotation cpp:731-762) and translation (linear time
    ratio, FindPosition cpp:764-778) to the scan-END frame — one vmapped
    rigid transform over the padded point tensor.

The reference's deques become fixed rings with validity masks; all early
returns become ``available`` booleans.

Known reference bug, OFF by default: DeskewPoint's z translation uses the
interpolated z *rotation* instead of the z position increment
(``f_pos_z_from_end = f_rot_z_cur - f_odom_incre_z_``, cpp:804). Pass
``bug_compat_z=True`` to reproduce it for parity runs.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from . import pytree

from .ops import lie
from .ops.frames import local_to_global_velocity


@pytree.dataclass
class DeskewInfo:
    """Precomputed per-scan deskew state (the reference's member arrays)."""

    imu_time: jnp.ndarray      # [M] sample times (ring order)
    imu_rot: jnp.ndarray       # [M,3] integrated rotation at each sample
    imu_included: jnp.ndarray  # [M] bool: inside the scan window
    first_idx: jnp.ndarray     # index of the first included sample
    last_idx: jnp.ndarray      # index of the last included sample
    odom_incre: jnp.ndarray    # [3] scan-start->end translation (start frame)
    scan_cur: jnp.ndarray      # scan start time
    scan_end: jnp.ndarray      # scan end time
    imu_available: jnp.ndarray  # bool
    odom_available: jnp.ndarray  # bool
    # True when the ring still held the scan-start sample. The reference
    # prunes its deque and silently anchors at whatever remains
    # (pcm_matching.cpp:536-549) — same behavior here, but an undersized
    # ring (reference reserves 2000 slots, pcm_matching.hpp:113) becomes
    # OBSERVABLE instead of a silent partial deskew.
    imu_covers_start: jnp.ndarray  # bool


def normalize_scan_times(times, valid, header_stamp, scan_time_end: bool):
    """Per-point times + header stamp -> (rel_times from scan start,
    scan_cur, scan_end). Reference: DeskewPointCloud cpp:473-486."""
    times = jnp.asarray(times)
    n = times.shape[0]
    idx = jnp.arange(n)
    first = jnp.argmax(valid)
    last = n - 1 - jnp.argmax(valid[::-1])
    front_t = times[first]
    back_t = times[last]
    if scan_time_end:
        scan_end = header_stamp
        scan_cur = scan_end + front_t  # front is negative
        rel = times - front_t
    else:
        scan_cur = header_stamp
        scan_end = header_stamp + back_t
        rel = times
    del idx
    return rel, scan_cur, scan_end


def imu_deskew_info(imu_time, imu_gyro, imu_valid, scan_cur, scan_end):
    """Integrate gyro over the scan window (ImuDeskewInfo, cpp:533-585).

    The ring must be time-ordered; included samples are those within
    [scan_cur - 0.01, scan_end + 0.01] (the reference's prune + break
    bounds). Returns (imu_rot [M,3], included [M], first_idx, last_idx,
    available)."""
    inc = imu_valid & (imu_time >= scan_cur - 0.01) & (imu_time <= scan_end + 0.01)
    m = imu_time.shape[0]
    idx = jnp.arange(m)
    first = jnp.argmax(inc)  # first included (0 if none; gated by available)
    last = m - 1 - jnp.argmax(inc[::-1])
    prev_inc = jnp.concatenate([jnp.zeros(1, dtype=bool), inc[:-1]])
    dt = jnp.where(
        inc & prev_inc,
        imu_time - jnp.concatenate([imu_time[:1], imu_time[:-1]]),
        0.0,
    )
    rot = jnp.cumsum(imu_gyro * dt[:, None], axis=0)
    # Anchor: rotation is zero at the first included sample.
    rot = rot - rot[first]
    rot = jnp.where(inc[:, None], rot, 0.0)
    available = jnp.sum(inc) >= 2
    del idx
    return rot, inc, first, last, available


def odom_deskew_info(ring_time, ring_pos, ring_rpy, ring_vel_local,
                     ring_gyro, ring_valid, scan_cur, scan_end):
    """Scan-start -> scan-end translation increment from the odometry ring
    (OdomDeskewInfo, cpp:587-729). Returns (incre [3], available)."""
    dtype = ring_pos.dtype
    fresh = ring_valid & (ring_time >= scan_cur - 0.1)
    n = ring_time.shape[0]
    have_any = jnp.any(fresh)
    # front of the pruned deque must not be after scan_cur (cpp:604-607)
    first_fresh = jnp.argmax(fresh)
    front_ok = have_any & (ring_time[first_fresh] <= scan_cur)

    # start odom: first fresh entry with t >= scan_cur; if none, the last
    # fresh entry (the reference's loop leaves the final element).
    ge_cur = fresh & (ring_time >= scan_cur)
    last_fresh = n - 1 - jnp.argmax(fresh[::-1])
    start_idx = jnp.where(jnp.any(ge_cur), jnp.argmax(ge_cur), last_fresh)

    # end odom: first entry with t >= scan_end, else velocity extrapolation
    ge_end = fresh & (ring_time >= scan_end)
    has_end = jnp.any(ge_end)
    end_idx = jnp.where(has_end, jnp.argmax(ge_end), last_fresh)

    def tf_of(i):
        return lie.make_transform(lie.euler_to_rot(ring_rpy[i]), ring_pos[i])

    tf_start = tf_of(start_idx)

    # Extrapolated end pose (cpp:648-708)
    lt = ring_time[last_fresh]
    dt_ex = scan_end - lt
    rpy_l = ring_rpy[last_fresh]
    v_glob = local_to_global_velocity(ring_vel_local[last_fresh], rpy_l)
    pos_ex = ring_pos[last_fresh] + v_glob * dt_ex
    rpy_ex = rpy_l + ring_gyro[last_fresh] * dt_ex  # Euler-rate integration
    tf_end_ex = lie.make_transform(lie.euler_to_rot(rpy_ex), pos_ex)
    tf_end_meas = tf_of(end_idx)
    tf_end = jnp.where(has_end, tf_end_meas, tf_end_ex)
    t_end = jnp.where(has_end, ring_time[end_idx], scan_end)

    between = lie.compose(lie.transform_inverse(tf_start), tf_end)
    dt_scan = scan_end - scan_cur
    dt_trans = t_end - ring_time[start_idx]
    interp = lie.interpolate_tf_with_time(between, dt_scan, dt_trans)
    incre = interp[:3, 3].astype(dtype)
    return jnp.where(front_ok, incre, jnp.zeros(3, dtype)), front_ok


def make_deskew_info(imu_time, imu_gyro, imu_valid, ring_time, ring_pos,
                     ring_rpy, ring_vel_local, ring_gyro, ring_valid,
                     scan_cur, scan_end,
                     window_budget: int = 64) -> DeskewInfo:
    """``window_budget``: the per-point interpolation (the [N, W] clipped
    interval weights in _find_rotation_batch) pays for the full ring width, but only
    the samples inside the scan window matter and the ring is chronological
    — so the window is COMPACTED to a contiguous W-slice first (at a
    256-slot ring and 26k points, [N, 64] instead of [N, 256]). 64 covers a
    0.11 s sweep at up to ~580 Hz IMU; an overflowing window clamps its
    tail and clears ``imu_covers_start``."""
    rot, inc, first, last, imu_ok = imu_deskew_info(
        imu_time, imu_gyro, imu_valid, scan_cur, scan_end
    )
    incre, odom_ok = odom_deskew_info(
        ring_time, ring_pos, ring_rpy, ring_vel_local, ring_gyro, ring_valid,
        scan_cur, scan_end,
    )
    m = imu_time.shape[0]
    w = min(int(window_budget), m)
    start = jnp.clip(first, 0, m - w)
    truncated = (last - start) > (w - 1)
    covers = imu_ok & (imu_time[first] <= scan_cur + 0.01) & ~truncated
    sl = lambda a: jax.lax.dynamic_slice_in_dim(a, start, w, axis=0)
    return DeskewInfo(
        imu_time=sl(imu_time),
        imu_rot=sl(rot),
        imu_included=sl(inc),
        first_idx=first - start,
        last_idx=jnp.clip(last - start, 0, w - 1),
        odom_incre=incre,
        scan_cur=scan_cur,
        scan_end=scan_end,
        imu_available=imu_ok,
        odom_available=odom_ok,
        imu_covers_start=covers,
    )


def _find_rotation_batch(info: DeskewInfo, point_times):
    """FindRotation (cpp:731-762) for all points at once, gather-free.

    Per-point random access into the IMU arrays would be one gather per
    point; this form has none. The reference's two-sample linear interpolation
    into the integrated-rotation table is a piecewise-linear function of
    time, which is algebraically a sum over sample INTERVALS:

        rot(t) = sum_k d_rot_k * clip((t - t_{k-1}) / dt_k, 0, 1)

    with d_rot_k the rotation increment over interval k. Points before the
    first included sample get weight 0 everywhere (-> rot = 0, the anchored
    front sample, cpp:747-751); points past the last clip every weight to 1
    (-> rot = rot_last, the "beyond back" branch cpp:740-745); interior
    points interpolate exactly. One [N,W] clipped-ratio weight tensor and a
    single [N,W] x [W,3] matmul replace searchsorted plus two one-hot
    selections — one HBM pass over the [N,W] plane instead of three.
    """
    t = info.imu_time
    rot = info.imu_rot
    inc = info.imu_included
    t_prev = jnp.concatenate([t[:1], t[:-1]])
    rot_prev = jnp.concatenate([jnp.zeros_like(rot[:1]), rot[:-1]])
    pair_ok = inc & jnp.concatenate([jnp.zeros(1, dtype=bool), inc[:-1]])
    dt = jnp.where(pair_ok, t - t_prev, 1.0)
    dt = jnp.where(dt == 0.0, 1.0, dt)
    d_rot = jnp.where(pair_ok[:, None], rot - rot_prev, 0.0)      # [W,3]
    w = jnp.clip(
        (point_times[:, None] - t_prev[None, :]) / dt[None, :], 0.0, 1.0
    )                                                             # [N,W]
    return jnp.matmul(w, d_rot, precision=jax.lax.Precision.HIGHEST)


def deskew_points(points, rel_times, valid, info: DeskewInfo, *,
                  run_deskew: bool = True, bug_compat_z: bool = False):
    """Transform every point to the scan-end frame (DeskewPoint, cpp:780-824).

    Returns (points' [N,3], ok): when deskew is disabled or IMU/odom info is
    unavailable the input passes through untouched (cpp:494-525 behavior: the
    whole scan is rejected upstream when info is missing; here we surface
    ``ok`` and pass points through so callers can gate)."""
    if not run_deskew:
        return points, info.imu_available & info.odom_available

    rot_end = info.imu_rot[info.last_idx]
    point_time = info.scan_cur + rel_times

    rot_cur = _find_rotation_batch(info, point_time)

    span = info.scan_end - info.scan_cur
    ratio = rel_times / jnp.where(span == 0, 1.0, span)
    pos_cur = ratio[:, None] * info.odom_incre[None, :]

    rot_from_end = rot_cur - rot_end[None, :]
    pos_from_end = pos_cur - info.odom_incre[None, :]
    if bug_compat_z:
        # cpp:804: z uses the interpolated z ROTATION minus the z increment.
        pos_from_end = pos_from_end.at[:, 2].set(
            rot_cur[:, 2] - info.odom_incre[2]
        )

    rot_m = lie.euler_to_rot(rot_from_end)           # [N,3,3]
    moved = (
        jnp.einsum("nij,nj->ni", rot_m, points, precision=jax.lax.Precision.HIGHEST)
        + pos_from_end
    )
    ok = info.imu_available & info.odom_available
    out = jnp.where((valid & ok)[:, None], moved, points)
    return out, ok
