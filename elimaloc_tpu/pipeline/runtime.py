"""The localization runtime: both reference nodes fused into jitted steps.

The reference runs two ROS processes exchanging topics (SURVEY.md §2 C12):
``ekf_localization`` (IMU/GNSS/CAN fusion at 100 Hz) and ``pcm_matching``
(deskew + scan-to-map ICP per LiDAR frame), closed through
/app/loc/ekf_pose_odom and /app/loc/pcm_odom. Here the topic graph becomes
explicit dataflow: one :class:`PipelineState` pytree (EKF state + ego/IMU
rings) threaded through four pure event steps —

  imu_step   = CallbackImu + RunPredictionImu + PublishInThread
               (ekf_localization.cpp:139-145, 397-424) and the PCM node's
               IMU/odom intake (pcm_matching.cpp:326-354);
  scan_step  = CallbackPointCloud end-to-end (pcm_matching.cpp:198-324):
               range gate -> deskew -> pose sync -> voxel downsample -> ICP ->
               covariance shaping (PublishPcmOdom cpp:1047-1101) -> latency
               compensation (GnssTimeCompensation) -> EKF pose update;
  gps_step   = CallbackNavsatFix (ekf_localization.cpp:92-125);
  can_step   = CallbackCAN (cpp:127-137).

Asynchronous callback ordering and try_lock drop/priority behavior are
replaced by deterministic event-time replay (SURVEY.md §5.8). Two drive
modes: a host event loop (`LocalizationPipeline.run`) for arbitrary logs, and
a fully-fused `replay_fused` that lax.scans the whole log in one compiled
program (fixed event rates), used for throughput benchmarking.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from .. import pytree

from .. import deskew as deskew_mod
from ..config import ElimalocConfig, GnssSource, IcpMethod
from ..ekf import (
    CanMeas,
    EkfFlags,
    EkfParams,
    EkfState,
    GnssMeas,
    ImuMeas,
    ego_state,
    init_state,
    make_params,
    predict_imu,
    update_can,
    update_gnss,
)
from ..map import builder as map_builder
from ..map import tiles as map_tiles
from ..map import grid as map_grid
from ..map.grid import voxel_downsample
from ..ops import lie
from ..ops.frames import global_to_local_velocity, imu_to_ego
from ..register import IcpStatic, make_icp_params, make_icp_static, run_register
from ..register.icp import IcpParams
from . import rings
from .log import ReplayLog


@pytree.dataclass
class PipelineState:
    ekf: EkfState
    ego_ring: rings.EgoRing
    imu_ring: rings.ImuRing


@pytree.dataclass
class PipelineParams:
    """Dynamic parameters shared by all steps."""

    ekf: EkfParams
    icp: IcpParams
    tf_ego_to_lidar: jnp.ndarray      # [4,4]
    tf_lidar_to_ego: jnp.ndarray      # [4,4]
    ego_to_imu_rot: jnp.ndarray       # [3,3]
    ego_to_imu_trans: jnp.ndarray     # [3]
    lidar_time_delay: jnp.ndarray
    input_max_dist: jnp.ndarray
    input_voxel_ds: jnp.ndarray
    gnss_uncertainty_max: jnp.ndarray


@dataclasses.dataclass(frozen=True)
class PipelineStatic:
    """Compile-time switches shared by all steps."""

    ekf_flags: EkfFlags
    icp_static: IcpStatic
    run_deskew: bool = True
    scan_time_end: bool = True
    bug_compat_deskew_z: bool = False
    ds_points: int = 8192
    use_gps: bool = False
    use_can: bool = False
    use_pcm: bool = True
    use_imu: bool = True
    tick_hz: float = 100.0  # CA-prediction rate when use_imu is off
    # lax.scan unroll for the per-frame IMU/CAN/GPS sub-batches: unrolling
    # lets XLA fuse across consecutive steps' non-dependent pieces. On an
    # H100, 4 beats 1 by ~13% in headline scans/s (a few % in frame
    # latency) for ~2x the fused compile time (PERF.md); trajectories agree
    # to ~1e-5 m, not bitwise. On the CPU backend the unroll buys nothing
    # and the 4x-bigger fused body costs compile memory and minutes of
    # compile, so make_pipeline_static picks 1 there.
    sub_unroll: int = 4


def make_pipeline_params(cfg: ElimalocConfig, dtype=jnp.float32) -> PipelineParams:
    d2r = np.pi / 180.0
    r_lidar = np.asarray(
        lie.euler_to_rot(jnp.asarray(cfg.calib.ego_to_lidar_rot_deg) * d2r)
    )
    tf = np.eye(4)
    tf[:3, :3] = r_lidar
    tf[:3, 3] = cfg.calib.ego_to_lidar_trans
    r_imu = np.asarray(
        lie.euler_to_rot(jnp.asarray(cfg.calib.ego_to_imu_rot_deg) * d2r)
    )
    f = lambda v: jnp.asarray(v, dtype=dtype)
    return PipelineParams(
        ekf=make_params(cfg.ekf, dtype=dtype),
        icp=make_icp_params(cfg.pcm, dtype=dtype),
        tf_ego_to_lidar=f(tf),
        tf_lidar_to_ego=f(np.linalg.inv(tf)),
        ego_to_imu_rot=f(r_imu),
        ego_to_imu_trans=f(cfg.calib.ego_to_imu_trans),
        lidar_time_delay=f(cfg.pcm.lidar_time_delay),
        input_max_dist=f(cfg.pcm.input_max_dist),
        input_voxel_ds=f(cfg.pcm.input_voxel_ds_m),
        gnss_uncertainty_max=f(cfg.ekf.gnss_uncertainty_max_m),
    )


def make_pipeline_static(cfg: ElimalocConfig, backend: str = "tile",
                         tile_budget=None, ds_points: int = 8192,
                         bug_compat_deskew_z: bool = False,
                         sub_unroll: int | None = None,
                         reassign_each_iter: bool | None = None,
                         ) -> PipelineStatic:
    if sub_unroll is None:
        # see PipelineStatic.sub_unroll
        sub_unroll = 1 if jax.default_backend() == "cpu" else 4
    return PipelineStatic(
        ekf_flags=EkfFlags.from_config(cfg.ekf),
        icp_static=make_icp_static(cfg.pcm, backend=backend,
                                   tile_budget=tile_budget,
                                   reassign_each_iter=reassign_each_iter),
        run_deskew=cfg.pcm.run_deskew,
        scan_time_end=cfg.pcm.lidar_scan_time_end,
        bug_compat_deskew_z=bug_compat_deskew_z,
        ds_points=ds_points,
        use_gps=cfg.ekf.use_gps,
        use_can=cfg.ekf.use_can,
        use_pcm=cfg.ekf.use_pcm_matching,
        use_imu=cfg.ekf.use_imu,
        sub_unroll=sub_unroll,
    )


def _select_state(pred, a: PipelineState, b: PipelineState) -> PipelineState:
    return jax.tree_util.tree_map(lambda x, y: jnp.where(pred, x, y), a, b)


def _push_ego(state: PipelineState) -> PipelineState:
    es = ego_state(state.ekf)
    ring = rings.push_ego(
        state.ego_ring, es["timestamp"], es["pos"], es["rpy"],
        es["vel_local"], es["gyro"],
    )
    return state.replace(ego_ring=ring)


# --------------------------------------------------------------------------- #
# Event steps
# --------------------------------------------------------------------------- #

def imu_step(state: PipelineState, t, acc_raw, gyro_raw,
             pp: PipelineParams, ps: PipelineStatic) -> PipelineState:
    """IMU sample -> EKF prediction -> published state into the rings."""
    acc, gyro = imu_to_ego(acc_raw, gyro_raw, pp.ego_to_imu_rot,
                           pp.ego_to_imu_trans)
    meas = ImuMeas(timestamp=t, acc=acc, gyro=gyro)
    ekf = predict_imu(state.ekf, meas, pp.ekf, ps.ekf_flags)
    state = state.replace(ekf=ekf)
    state = _push_ego(state)
    # PCM's IMU intake rotates but does not lever-arm compensate (cpp:328).
    gyro_pcm = jnp.matmul(pp.ego_to_imu_rot, gyro_raw, precision=lie._HI)
    acc_pcm = jnp.matmul(pp.ego_to_imu_rot, acc_raw, precision=lie._HI)
    state = state.replace(
        imu_ring=rings.push_imu(state.imu_ring, t, gyro_pcm, acc_pcm)
    )
    return state


def gps_step(state: PipelineState, t, pos, cov_diag,
             pp: PipelineParams, ps: PipelineStatic) -> PipelineState:
    """GPS fix update. The measurement source follows the configured
    gps_type (NAVSATFIX / BESTPOS take the position-only 3-DOF path inside
    update_gnss with antenna-offset inflation; ODOMETRY maps to the NOVATEL
    6-DOF source — its subscriber is dead code in the reference,
    ekf_localization.cpp:49-51, but the filter path exists)."""
    if not ps.use_gps:
        return state
    from ..config import GpsType

    src = {
        int(GpsType.NAVSATFIX): GnssSource.NAVSATFIX,
        int(GpsType.BESTPOS): GnssSource.BESTPOS,
        int(GpsType.ODOMETRY): GnssSource.NOVATEL,
    }[ps.ekf_flags.gps_type]
    # Reference quirk: the NavSatFix covariance field is squared again
    # (ekf_localization.cpp:104-106).
    var = cov_diag * cov_diag
    ok = (var[0] <= pp.gnss_uncertainty_max) & (var[1] <= pp.gnss_uncertainty_max)
    meas = GnssMeas(
        timestamp=t,
        source=jnp.asarray(int(src)),
        pos=pos,
        rot=lie.quat_identity(pos.dtype),
        pos_cov=jnp.diag(var),
        rot_cov=jnp.zeros((3, 3), pos.dtype),
    )
    ekf = update_gnss(state.ekf, meas, pp.ekf, ps.ekf_flags)
    return _select_state(ok, state.replace(ekf=ekf), state)


def imu_ring_step(state: PipelineState, t, acc_raw, gyro_raw,
                  pp: PipelineParams, ps: PipelineStatic) -> PipelineState:
    """PCM-side IMU intake only (no EKF prediction): when use_imu is off the
    matching node still consumes IMU for deskewing (the reference's PCM node
    subscribes IMU independently, pcm_matching.cpp:39, 326-336)."""
    gyro_pcm = jnp.matmul(pp.ego_to_imu_rot, gyro_raw, precision=lie._HI)
    acc_pcm = jnp.matmul(pp.ego_to_imu_rot, acc_raw, precision=lie._HI)
    return state.replace(
        imu_ring=rings.push_imu(state.imu_ring, t, gyro_pcm, acc_pcm)
    )


def tick_step(state: PipelineState, t, pp: PipelineParams,
              ps: PipelineStatic) -> PipelineState:
    """System-clock CA prediction tick for use_imu=False mode (the
    reference's 100 Hz MainLoop -> RunPrediction, ekf_localization.cpp:
    206-216, 660-676)."""
    from ..ekf import predict

    ekf = predict(state.ekf, t, pp.ekf)
    return _push_ego(state.replace(ekf=ekf))


def can_step(state: PipelineState, t, vel_x, yaw_rate,
             pp: PipelineParams, ps: PipelineStatic) -> PipelineState:
    if not ps.use_can:
        return state
    z = jnp.zeros((), vel_x.dtype)
    meas = CanMeas(
        timestamp=t,
        vel=jnp.stack([vel_x, z, z]),
        gyro=jnp.stack([z, z, yaw_rate]),
    )
    return state.replace(
        ekf=update_can(state.ekf, meas, pp.ekf, ps.ekf_flags)
    )


def shape_icp_covariance(rot_ego, local_cov, fitness):
    """ICP (JTJ+λI)^-1 -> measurement covariance (PublishPcmOdom,
    pcm_matching.cpp:1073-1098 + NormalizeCovariance hpp:251-275).

    Note: the reference also computes diagonal-normalized *vectors*
    (NormalizeDiagonalCovariance) but never uses them; only the full-matrix
    normalization reaches the published covariance."""
    std = jnp.maximum(fitness, 0.25)
    angle_std = std * jnp.pi / 180.0

    def normalize(cov):
        diag = jnp.diagonal(cov)
        min_diag = jnp.min(diag)
        scale_up = min_diag <= 1e-9
        cov2 = jnp.where(scale_up, cov * 1e9, cov)
        min2 = jnp.maximum(jnp.min(jnp.diagonal(cov2)), 1e-9)
        return jnp.minimum(cov2 / min2, 5.0)

    t_cov = jnp.einsum("ij,jk,lk->il", rot_ego, local_cov[:3, :3],
                       rot_ego, precision=lie._HI)
    r_cov = local_cov[3:, 3:]
    return normalize(t_cov) * std * std, normalize(r_cov) * angle_std * angle_std


def scan_step(state: PipelineState, stamp, points, rel_raw, valid, tmap,
              pp: PipelineParams, ps: PipelineStatic):
    """One LiDAR frame through the full matching pipeline.

    Returns (state', out) with out = dict(icp pose, flags, diagnostics)."""
    dtype = points.dtype
    stamp = stamp - pp.lidar_time_delay

    # Range gate (FilterPointsByDistance, cpp:451-465)
    dist = jnp.linalg.norm(points, axis=1)
    valid = valid & (dist <= pp.input_max_dist)

    rel, scan_cur, scan_end = deskew_mod.normalize_scan_times(
        rel_raw, valid, stamp, ps.scan_time_end
    )

    imu_r = state.imu_ring
    ego_r = state.ego_ring
    info = deskew_mod.make_deskew_info(
        imu_r.t, imu_r.gyro, imu_r.valid_mask(),
        ego_r.t, ego_r.pos, ego_r.rpy, ego_r.vel_local, ego_r.gyro,
        ego_r.valid_mask(), scan_cur, scan_end,
    )
    pts_d, desk_ok = deskew_mod.deskew_points(
        points, rel, valid, info,
        run_deskew=ps.run_deskew, bug_compat_z=ps.bug_compat_deskew_z,
    )
    if ps.run_deskew:
        usable = desk_ok
    else:
        usable = jnp.asarray(True)

    sync_pose, found = rings.get_interpolated_pose(ego_r, scan_end)
    usable = usable & found & (ego_r.count > 0)

    ds_pts, ds_valid, ds_kept = voxel_downsample(
        pts_d, valid, pp.input_voxel_ds, ps.ds_points
    )

    init_guess = lie.compose(sync_pose, pp.tf_ego_to_lidar)
    res = run_register(ds_pts, ds_valid, tmap, init_guess, pp.icp, ps.icp_static)

    icp_ego_pose = lie.compose(res.pose, pp.tf_lidar_to_ego)
    rot_ego = icp_ego_pose[:3, :3]
    pos = icp_ego_pose[:3, 3]
    quat = lie.rot_to_quat(rot_ego)
    pos_cov, rot_cov = shape_icp_covariance(rot_ego, res.local_cov, res.fitness)

    ct, cpos, cquat, comp_ok = rings.gnss_time_compensation(
        ego_r, scan_end, pos, quat
    )
    meas = GnssMeas(
        timestamp=ct,
        source=jnp.asarray(int(GnssSource.PCM)),
        pos=cpos,
        rot=cquat,
        pos_cov=pos_cov.astype(dtype),
        rot_cov=rot_cov.astype(dtype),
    )
    apply = usable & res.success & comp_ok & ps.use_pcm
    ekf2 = update_gnss(state.ekf, meas, pp.ekf, ps.ekf_flags)
    new_state = _select_state(apply, state.replace(ekf=ekf2), state)

    out = {
        "scan_end": scan_end,
        "icp_pose": icp_ego_pose,
        "applied": apply,
        "icp_success": res.success,
        "deskew_ok": desk_ok,
        "pose_sync_ok": found,
        # False = the IMU ring no longer held the scan-start sample and the
        # deskew anchored late (the reference's silent partial-deque case,
        # pcm_matching.cpp:536-549); size imu_ring_size for the IMU rate x
        # worst-case scan latency (the reference reserves 2000 slots)
        "deskew_full_cover": info.imu_covers_start,
        "fitness": res.fitness,
        "overlap": res.overlap,
        "iterations": res.iterations,
        # capacity diagnostics: nonzero slots_dropped / ds_kept at the budget
        # ceiling mean the static shape budgets are undersized for this scan
        "slots_dropped": res.dropped,
        "ds_kept": ds_kept,
    }
    return new_state, out


def pcm_init_step(state: PipelineState, t, pose, pp: PipelineParams,
                  ps: PipelineStatic) -> PipelineState:
    """Feed a relocalization result into the EKF (CallbackPcmInitOdom,
    ekf_localization.cpp:181-204: covariance 1e-9, source PCM_INIT)."""
    dtype = pose.dtype
    meas = GnssMeas(
        timestamp=t,
        source=jnp.asarray(int(GnssSource.PCM_INIT)),
        pos=pose[:3, 3],
        rot=lie.rot_to_quat(pose[:3, :3]),
        pos_cov=jnp.eye(3, dtype=dtype) * 1e-9,
        rot_cov=jnp.eye(3, dtype=dtype) * 1e-9,
    )
    return state.replace(ekf=update_gnss(state.ekf, meas, pp.ekf, ps.ekf_flags))


# --------------------------------------------------------------------------- #
# Fully-fused replay (one compiled program per log shape)
# --------------------------------------------------------------------------- #

def imu_subbatch(st: PipelineState, b, pp: PipelineParams,
                 ps: PipelineStatic) -> PipelineState:
    """The frame's IMU sub-batch with the SEQUENTIAL chain reduced to the
    EKF filter only. Equivalent to scanning :func:`imu_step` per sample, but
    with far fewer sequential steps: the sensor-frame conversion
    is batched up front (state-independent), the per-sample scan carries
    only the EkfState (not the ring buffers), the ego-state output
    conversions (Euler/local-twist) are batched AFTER the scan, and both
    rings are written once via the batch push (rings._push_arrays_batch)."""
    ts, accs, gyros, valids = (
        b["imu_t"], b["imu_acc"], b["imu_gyro"], b["imu_valid"])
    acc_e, gyro_e = imu_to_ego(accs, gyros, pp.ego_to_imu_rot,
                               pp.ego_to_imu_trans)
    # PCM's IMU intake rotates but does not lever-arm compensate (cpp:328)
    gyro_pcm = jnp.einsum("ij,nj->ni", pp.ego_to_imu_rot, gyros,
                          precision=lie._HI)
    acc_pcm = jnp.einsum("ij,nj->ni", pp.ego_to_imu_rot, accs,
                         precision=lie._HI)

    def body(ekf, x):
        t, acc, gyro, v = x
        ekf2 = predict_imu(ekf, ImuMeas(timestamp=t, acc=acc, gyro=gyro),
                           pp.ekf, ps.ekf_flags)
        ekf2 = jax.tree_util.tree_map(
            lambda a_, b_: jnp.where(v, a_, b_), ekf2, ekf)
        return ekf2, (ekf2.prev_timestamp, ekf2.pos, ekf2.rot, ekf2.vel,
                      ekf2.gyro)

    ekf, (t_s, pos_s, rot_s, vel_s, gyro_s) = jax.lax.scan(
        body, st.ekf, (ts, acc_e, gyro_e, valids), unroll=ps.sub_unroll)
    rpy_s = jax.vmap(lambda q: lie.rot_to_euler(lie.quat_to_rot(q)))(rot_s)
    vloc_s = global_to_local_velocity(vel_s, rpy_s)
    ego_ring = rings.push_ego_batch(
        st.ego_ring, t_s, pos_s, rpy_s, vloc_s, gyro_s, valids)
    imu_ring = rings.push_imu_batch(st.imu_ring, ts, gyro_pcm, acc_pcm,
                                    valids)
    return st.replace(ekf=ekf, ego_ring=ego_ring, imu_ring=imu_ring)


def fused_frame(st: PipelineState, b, tmap, pp: PipelineParams,
                ps: PipelineStatic):
    """One scan frame: the frame's IMU / CAN / GPS sub-batches (masked fixed
    budgets) then the scan itself. Event order within an inter-scan window is
    imu -> can -> gps -> scan. Shared by the whole-log fused replay
    (:func:`replay_fused`) and the per-frame streaming mode
    (:meth:`LocalizationPipeline.run_frames`)."""
    st = imu_subbatch(st, b, pp, ps)

    if ps.use_can:
        def can_body(s, x):
            t, vel, yr, v = x
            s2 = can_step(s, t, vel, yr, pp, ps)
            return _select_state(v, s2, s), None

        st = jax.lax.scan(
            can_body, st,
            (b["can_t"], b["can_vel"], b["can_yaw"], b["can_valid"]),
            unroll=ps.sub_unroll,
        )[0]

    if ps.use_gps:
        def gps_body(s, x):
            t, pos, cov, v = x
            s2 = gps_step(s, t, pos, cov, pp, ps)
            return _select_state(v, s2, s), None

        st = jax.lax.scan(
            gps_body, st,
            (b["gps_t"], b["gps_pos"], b["gps_cov"], b["gps_valid"]),
            unroll=ps.sub_unroll,
        )[0]

    st, out = scan_step(
        st, b["scan_t"], b["scan_points"], b["scan_times"],
        b["scan_valid"], tmap, pp, ps,
    )
    es = ego_state(st.ekf)
    out["ego_pos"] = es["pos"]
    out["ego_rpy"] = es["rpy"]
    out["ego_t"] = es["timestamp"]
    # covariance-health telemetry (cheap 27x27 reductions): long f32 runs
    # must keep P symmetric with positive diagonals — tests/test_long_horizon
    # asserts these per frame over 600-scan replays
    P = st.ekf.P
    out["p_asym"] = jnp.max(jnp.abs(P - P.T))
    out["p_min_diag"] = jnp.min(jnp.diagonal(P))
    return st, out


def fused_frame_at(state: PipelineState, batches, k, tmap,
                   pp: PipelineParams, ps: PipelineStatic):
    """:func:`fused_frame` for frame ``k`` of a whole-log batch tensor —
    the slice happens INSIDE the jitted program (one dispatch per frame;
    host-side tree slicing costs ~a dozen extra device calls per frame)."""
    b = jax.tree_util.tree_map(lambda x: x[k], batches)
    return fused_frame(state, b, tmap, pp, ps)


def replay_fused(state: PipelineState, batches, tmap,
                 pp: PipelineParams, ps: PipelineStatic):
    """lax.scan of :func:`fused_frame` over all scan frames.

    ``batches`` comes from :func:`build_fused_batches`.
    """
    return jax.lax.scan(
        lambda st, b: fused_frame(st, b, tmap, pp, ps), state, batches
    )


def replay_fused_chunk(state: PipelineState, batches, k0, tmap,
                       pp: PipelineParams, ps: PipelineStatic, chunk: int):
    """lax.scan of :func:`fused_frame` over frames [k0, k0+chunk) of a
    whole-log batch tensor — the dispatch unit of the CHUNKED windowed
    replay (``LocalizationPipeline.run_frames(chunk=...)``): one device
    call and one pose readback per ``chunk`` frames instead of per frame,
    while the host still gets control between chunks to swap the active
    map window. Frames past the log end (the final ragged chunk) read a
    clamped index and leave the state untouched; the host discards their
    output rows."""
    n = batches["scan_t"].shape[0]
    ks = k0 + jnp.arange(chunk, dtype=jnp.int32)

    def body(st, k):
        valid = k < n
        b = jax.tree_util.tree_map(lambda x: x[jnp.minimum(k, n - 1)], batches)
        st2, out = fused_frame(st, b, tmap, pp, ps)
        return _select_state(valid, st2, st), out

    return jax.lax.scan(body, state, ks)


# Active-window incremental shifts (tiles.shift_window): largest per-axis
# tile shift serviced incrementally (bigger jumps — relocalization — full
# crop), and the window-local coordinate drift at which a full crop
# re-centers the origin (f32 ulp at 2 km is ~1e-4 m, two orders below the
# voxel scale).
_MAX_INCR_SHIFT = 3
_INCR_DRIFT_LIMIT_M = 2048.0


def _async_host_fetch(arr) -> None:
    """Kick off a device->host copy without blocking (stale-by-one window
    poses: the value is consumed a frame/chunk later, by which time the
    copy has landed). Silently a no-op on runtimes without the API."""
    try:
        arr.copy_to_host_async()
    except (AttributeError, NotImplementedError):
        pass


def scan_arrival_times(log: ReplayLog) -> np.ndarray:
    """Delivery time of each scan = time of its last point. Header-relative
    point times are non-positive in lidar_scan_time_end mode (arrival ==
    header) and positive otherwise (arrival == header + sweep)."""
    rel_last = np.where(log.scan_valid, log.scan_times, -np.inf).max(axis=1)
    return log.scan_t + np.maximum(rel_last.astype(np.float64), 0.0)


def build_fused_batches(log: ReplayLog, dtype=np.float32, time_base: float = 0.0):
    """Group a ReplayLog into per-scan-frame sub-batches with fixed budgets.
    Timestamps are rebased by ``time_base`` (see LocalizationPipeline)."""
    ns = len(log.scan_t)
    arrival = scan_arrival_times(log)
    # Frames are bucketed by DELIVERY time; with jittered sweeps arrival can
    # be non-monotonic even when headers are sorted, and searchsorted over an
    # unsorted array would silently mis-bucket events. Process frames in
    # arrival order (the reference's callbacks likewise fire in arrival
    # order) and keep the scan arrays aligned.
    order = np.argsort(arrival, kind="stable")
    if not np.array_equal(order, np.arange(ns)):
        arrival = arrival[order]
        log = dataclasses.replace(
            log,
            scan_t=log.scan_t[order],
            scan_points=log.scan_points[order],
            scan_times=log.scan_times[order],
            scan_valid=log.scan_valid[order],
        )

    def bucket(ts, *arrays):
        if ts is None:
            return None
        # vectorized bucketing (a per-event Python loop here costs more than
        # the entire on-device replay at 100 Hz IMU rates)
        idx = np.searchsorted(arrival, ts, side="left")
        keep = idx < ns
        fi = idx[keep]
        counts = np.bincount(fi, minlength=ns)
        cap = max(int(counts.max()), 1)
        starts = np.zeros(ns + 1, np.int64)
        np.cumsum(counts, out=starts[1:])
        # per-event slot position inside its frame (events are time-sorted,
        # so same-frame events are contiguous)
        k = np.arange(len(fi)) - starts[fi]
        t_b = np.zeros((ns, cap), dtype)
        v_b = np.zeros((ns, cap), bool)
        # rebase in float64 BEFORE the float32 store: epoch-scale stamps
        # quantize to ~0.1 s in f32
        t_b[fi, k] = np.asarray(ts, np.float64)[keep] - time_base
        v_b[fi, k] = True
        arr_bs = []
        for a in arrays:
            a = np.asarray(a)
            ab = np.zeros((ns, cap) + a.shape[1:], dtype)
            ab[fi, k] = a[keep]
            arr_bs.append(ab)
        return [t_b, v_b] + arr_bs

    imu = bucket(log.imu_t, log.imu_acc, log.imu_gyro)
    batches = {
        "scan_t": jnp.asarray(log.scan_t - time_base, dtype),
        "scan_points": jnp.asarray(log.scan_points, dtype),
        "scan_times": jnp.asarray(log.scan_times, dtype),
        "scan_valid": jnp.asarray(log.scan_valid),
        "imu_t": jnp.asarray(imu[0]),
        "imu_valid": jnp.asarray(imu[1]),
        "imu_acc": jnp.asarray(imu[2]),
        "imu_gyro": jnp.asarray(imu[3]),
    }
    if log.can_t is not None:
        can = bucket(log.can_t, log.can_vel, log.can_yaw_rate)
        batches.update(
            can_t=jnp.asarray(can[0]), can_valid=jnp.asarray(can[1]),
            can_vel=jnp.asarray(can[2]), can_yaw=jnp.asarray(can[3]),
        )
    if log.gps_t is not None:
        gps = bucket(log.gps_t, log.gps_pos, log.gps_cov)
        batches.update(
            gps_t=jnp.asarray(gps[0]), gps_valid=jnp.asarray(gps[1]),
            gps_pos=jnp.asarray(gps[2]), gps_cov=jnp.asarray(gps[3]),
        )
    return batches


# --------------------------------------------------------------------------- #
# Host-facing pipeline
# --------------------------------------------------------------------------- #

class LocalizationPipeline:
    """End-to-end localization over a prebuilt map.

    Replaces the two-node ROS runtime: construct with a config and map
    points, feed events (or a whole ReplayLog), read fused poses.

    Timestamps are rebased to ``time_base`` (set on the first event) before
    entering device code: epoch-scale stamps in float32 carry ~0.1 s
    quantization, which is fatal to deskewing and dt arithmetic. All returned
    trajectories are in absolute time again.
    """

    def __init__(self, cfg: ElimalocConfig, map_points, *,
                 dtype=jnp.float32, backend: str = "tile", tile_budget=None,
                 ds_points: int = 8192, ego_ring_size: int = 1024,
                 imu_ring_size: int = 512, tile_voxels: int = 4,
                 use_native: bool = True,
                 map_window_radius: Optional[float] = None,
                 map_window_prefetch: bool = True,
                 halo_margin: Optional[int] = None):
        """``map_window_radius`` (meters, tile backend only) enables the
        active-window mode for maps too large for HBM: only the
        (2r+1)x(2r+1)-tile window around the vehicle is device-resident,
        re-cropped with hysteresis as the pose nears the edge. Window swaps
        never recompile (window-local coordinates, map/tiles.crop_window).
        Use the event loop (:meth:`run`) or frame streaming
        (:meth:`run_frames`); the single-program :meth:`run_fused` cannot
        swap maps mid-program.

        ``halo_margin`` (tile backend): per-tile halo growth in voxels for
        the packed tile map (map/tiles._halo_membership). Default: 2 for
        AVGICP — the wider halo keeps the HOISTED slot assignment exact
        under up to one voxel of GN pose drift, so the method no longer
        pays a per-iteration re-sort/re-pack for its oracle parity
        (reference semantics: registration.cpp:310-347 re-looks-up tiles
        from the current pose each iteration) — and 1 otherwise. Ignored
        when ``map_points`` is an already-packed HostTileMap (its build-time
        margin is used)."""
        self.cfg = cfg
        self.dtype = dtype
        method = cfg.pcm.icp_method
        prebuilt_tiles = None
        if isinstance(map_points, map_tiles.HostTileMap):
            # a packed (possibly disk-backed, map_tiles.load_tile_map) tile
            # map: city-scale serving without rebuilding or loading the raw
            # cloud; ground-height probes fall back to the resident window
            prebuilt_tiles = map_points
            self.built = None
        elif isinstance(map_points, map_builder.BuiltMap):
            # prebuilt / checkpointed map (utils.checkpoint.load_built_map)
            self.built = map_points
        else:
            self.built = map_builder.build_voxel_map(
                map_points,
                cfg.pcm.pcm_voxel_size,
                cfg.pcm.pcm_voxel_max_point,
                compute_voxel_cov=method in (IcpMethod.VGICP, IcpMethod.AVGICP),
                compute_point_cov=method == IcpMethod.GICP,
                gicp_cov_search_dist=cfg.pcm.gicp_cov_search_dist,
                use_native=use_native,
            )
        self.map_window_radius = map_window_radius
        self._host_tmap = None
        self._window_center = None
        self._window_origin_anchor = None
        self._prefetch = None
        self._window_prefetch = map_window_prefetch
        self.window_stats = {
            "swaps": 0, "prefetch_hits": 0, "prefetch_joins": 0,
            "sync_swaps": 0, "incr_crops": 0,
            # time split: host crop seconds, H2D upload
            # seconds (both accumulated wherever they run, including the
            # prefetch worker thread), and seconds the FRAME LOOP actually
            # stalled waiting for a swap (joins + sync swaps) — the only
            # component on the serving critical path
            "crop_s": 0.0, "h2d_s": 0.0, "swap_wait_s": 0.0,
        }
        if prebuilt_tiles is not None and backend != "tile":
            raise ValueError("a HostTileMap input requires the tile backend")
        reassign = None  # make_icp_static's method-dependent default
        if backend == "tile":
            if prebuilt_tiles is not None:
                host_tmap = prebuilt_tiles
            else:
                if halo_margin is None:
                    # AVGICP: margin 2 (~1.8x halo candidates) buys back the
                    # hoisted slot assignment (see __init__ docstring)
                    halo_margin = 2 if method == IcpMethod.AVGICP else 1
                host_tmap = map_tiles.build_tile_map(
                    self.built, tile_voxels=tile_voxels,
                    halo_margin=halo_margin)
            if host_tmap.halo_margin >= 2:
                reassign = False
            if map_window_radius is not None:
                self._host_tmap = host_tmap
                self._window_tiles = max(
                    int(np.ceil(map_window_radius / host_tmap.tile_size)), 2
                )
                # first window around the configured init pose (cropping
                # around the map centroid would be discarded by the first
                # scan's re-window — a wasted multi-GB upload on big maps)
                c0 = np.array([cfg.ekf.ekf_init_x_m, cfg.ekf.ekf_init_y_m])
                self._set_window(c0)
            else:
                self.map = host_tmap.to_device(dtype=dtype)
            self._tiles_host_full = host_tmap
        else:
            if map_window_radius is not None:
                raise ValueError("map_window_radius requires the tile backend")
            self.map = map_grid.to_device(self.built, dtype=dtype)
        # a property of the MAP (constant across config hot-reloads): with a
        # margin>=2 halo the hoisted assignment is exact for every method
        self._reassign_override = reassign
        self.params = make_pipeline_params(cfg, dtype=dtype)
        self.static = make_pipeline_static(
            cfg, backend=backend, tile_budget=tile_budget,
            ds_points=ds_points, reassign_each_iter=reassign,
        )
        self._ego_ring_size = ego_ring_size
        self._imu_ring_size = imu_ring_size
        self.time_base = None

        self._build_jitted()

    def _build_jitted(self):
        """(Re)build the jitted step programs for the CURRENT PipelineStatic.

        Only ``ps`` (the compile-time switches) is partial-bound here; the
        dynamic ``PipelineParams`` pytree is passed at CALL time by the thin
        ``_imu_step``/... methods below. That keeps continuous parameters
        out of the trace: a config hot-reload that only changes values
        (thresholds, noise densities, extrinsics — the reference's
        UpdateDynamicConfig subset, ekf_algorithm.cpp:68-79) swaps
        ``self.params`` and hits the SAME trace-cache entry — no retrace, no
        recompile, no stream stall. Flag changes produce a new
        PipelineStatic and genuinely re-jit (reload_config)."""
        ps = self.static
        self._jits = {
            name: jax.jit(functools.partial(fn, ps=ps))
            for name, fn in (
                ("imu", imu_step), ("scan", scan_step), ("gps", gps_step),
                ("can", can_step), ("pcm_init", pcm_init_step),
                ("tick", tick_step), ("imu_ring", imu_ring_step),
                # One persistent jitted fused-replay callable: re-wrapping
                # per call would defeat the jit cache and recompile each run.
                ("fused", replay_fused), ("frame", fused_frame),
                ("frame_at", fused_frame_at),
            )
        }
        self._jits["register"] = jax.jit(
            functools.partial(run_register, static=ps.icp_static)
        )
        # chunked windowed replay programs, one per chunk size
        self._chunk_jits = {}
        # committed device copy of the params pytree: passing host leaves
        # per call would re-upload them on every dispatch
        self._dev_params = jax.device_put(self.params)

    # thin call-throughs adding the dynamic params at call time (the jit
    # trace cache is keyed by tree structure/shape, so value-only swaps of
    # self.params reuse the compiled program)
    def _imu_step(self, *a):
        return self._jits["imu"](*a, pp=self._dev_params)

    def _scan_step(self, *a):
        return self._jits["scan"](*a, pp=self._dev_params)

    def _gps_step(self, *a):
        return self._jits["gps"](*a, pp=self._dev_params)

    def _can_step(self, *a):
        return self._jits["can"](*a, pp=self._dev_params)

    def _pcm_init_step(self, *a):
        return self._jits["pcm_init"](*a, pp=self._dev_params)

    def _tick_step(self, *a):
        return self._jits["tick"](*a, pp=self._dev_params)

    def _imu_ring_step(self, *a):
        return self._jits["imu_ring"](*a, pp=self._dev_params)

    def _fused(self, *a):
        return self._jits["fused"](*a, pp=self._dev_params)

    def _frame(self, *a):
        return self._jits["frame"](*a, pp=self._dev_params)

    def _frame_at(self, *a):
        return self._jits["frame_at"](*a, pp=self._dev_params)

    def _register(self, *a):
        return self._jits["register"](*a, params=self._dev_params.icp)

    # ---- active-window management ----
    def _window_dims(self):
        h = self._host_tmap
        n = 2 * self._window_tiles + 1
        return (min(n, h.tx_dim), min(n, h.ty_dim))

    def _adopt_window(self, dev_map, center, anchor, origin_anchor):
        self.map = dev_map
        self._window_center = center
        self._window_offset_tiles = anchor
        self._window_origin_anchor = origin_anchor

    def _window_enqueue(self, center_xy, base_map=None, base_anchor=None,
                        origin_anchor=None):
        """Build the window at ``center_xy`` and ENQUEUE its device transfer
        WITHOUT waiting for it: returns ``(dev_map, center, anchor,
        origin_anchor, host_s)``. The returned pytree is immediately valid
        to pass into jitted programs — the device stream orders the H2D
        before any consumer — so adoption never has to stall on transfer
        completion. Callers MUST follow up with
        :meth:`_window_finalize` (possibly from another thread) for the
        h2d accounting + page-cache release.

        Given a resident window whose move is a small shift, the window
        moves INCREMENTALLY on device (tiles.shift_window): H2D shrinks to
        the entering tile rows and retained rows keep their exact bits
        because the coordinate origin stays fixed. A full crop (which
        re-centers the origin) is taken for the first window, big jumps
        (relocalization), and when accumulated drift from the origin
        approaches f32-precision limits."""
        import time as _time

        h = self._host_tmap
        dims = self._window_dims()
        anchor = h.window_anchor(np.asarray(center_xy, float), dims)
        incr = None
        if base_map is not None and origin_anchor is not None:
            dx = anchor[0] - base_anchor[0]
            dy = anchor[1] - base_anchor[1]
            k = max(abs(dx), abs(dy))
            drift = max(abs(anchor[0] - origin_anchor[0]) + dims[0],
                        abs(anchor[1] - origin_anchor[1]) + dims[1])
            if 0 < k <= _MAX_INCR_SHIFT \
                    and drift * h.tile_size <= _INCR_DRIFT_LIMIT_M:
                incr = (dx, dy, k)
        t0 = _time.time()
        if incr is None:
            host_win = h.crop_window(
                np.asarray(center_xy, float), self._window_tiles,
                dims=dims, offset_dtype=np.dtype(self.dtype),
            )
            t1 = _time.time()
            dev = host_win.to_device(dtype=self.dtype)
            ts = h.tile_size
            center = np.array(host_win.world_offset) + 0.5 * np.array(
                [host_win.tx_dim, host_win.ty_dim]) * ts
            return dev, center, anchor, anchor, t1 - t0
        dx, dy, k = incr
        r_pad = k * (dims[0] + dims[1])  # bucketed: <=3 compiled scatters
        dst, payload = h.crop_entering_rows(
            base_anchor, anchor, dims, origin_anchor, r_pad,
            offset_dtype=np.dtype(self.dtype),
        )
        t1 = _time.time()
        dev = map_tiles.shift_window(base_map, dx, dy, dst, payload)
        self.window_stats["incr_crops"] += 1
        off, _ = h._origin_offsets(anchor, np.dtype(self.dtype))
        center = off + 0.5 * np.array(dims) * h.tile_size
        return dev, center, anchor, origin_anchor, t1 - t0

    def _window_finalize(self, dev, host_s):
        """Wait out an enqueued window's H2D (accounting) and release the
        crop's file pages. drop_page_cache is deliberately synchronous with
        the transfer: deferring it further overlapped the eviction with the
        NEXT prefetch's crop, which re-faulted the evicted pages mid-read."""
        import time as _time

        t1 = _time.time()
        jax.block_until_ready(jax.tree_util.tree_leaves(dev))
        t2 = _time.time()
        self._host_tmap.drop_page_cache()
        self.window_stats["crop_s"] += host_s
        self.window_stats["h2d_s"] += t2 - t1

    def _build_window(self, center_xy, base_map=None, base_anchor=None,
                      origin_anchor=None):
        """Synchronous enqueue + finalize (see :meth:`_window_enqueue`)."""
        dev, center, anchor, oa, host_s = self._window_enqueue(
            center_xy, base_map=base_map, base_anchor=base_anchor,
            origin_anchor=origin_anchor,
        )
        self._window_finalize(dev, host_s)
        return dev, center, anchor, oa

    def _set_window(self, center_xy):
        dev, center, anchor, oa = self._build_window(
            center_xy,
            base_map=getattr(self, "map", None),
            base_anchor=getattr(self, "_window_offset_tiles", None),
            origin_anchor=self._window_origin_anchor,
        )
        self._adopt_window(dev, center, anchor, oa)

    def _window_margin(self):
        ts = self._host_tmap.tile_size
        half = self._window_tiles * ts
        sensor = float(self.cfg.pcm.input_max_dist)
        return max(half - sensor - 2.0 * ts, ts)

    def _start_prefetch(self, pos_xy):
        """Kick off crop + H2D of the window centered at the CURRENT pose in
        a background thread (double buffering: the old window keeps serving
        frames until the new one is resident).

        Two-stage completion: ``built`` fires as soon as the device transfer
        is ENQUEUED (the window pytree is valid to adopt — the device stream
        orders the H2D before any consumer), ``done`` after the transfer has
        landed and the crop's file pages are released. Adoption waits only
        for ``built`` (milliseconds of host crop work), so a swap that
        catches the worker mid-H2D no longer stalls the frame loop for the
        transfer — the next chunk simply queues behind it on device."""
        import threading

        anchor = self._host_tmap.window_anchor(
            np.asarray(pos_xy, float), self._window_dims()
        )
        pf = self._prefetch
        if anchor == self._window_offset_tiles:
            return
        if pf is not None:
            if not pf["done"].is_set():
                return  # let the in-flight crop finish (replacing it every
                # tile crossing would mean no prefetch ever completes)
            if pf["anchor"] == anchor:
                return  # the finished one is already ideal
        holder = {"anchor": anchor, "built": threading.Event(),
                  "done": threading.Event()}
        center_xy = np.asarray(pos_xy, float).copy()
        # snapshot the resident window on the MAIN thread: adoption may
        # replace self.map while the worker runs
        base = (self.map, self._window_offset_tiles,
                self._window_origin_anchor)

        def work():
            try:
                dev, center, _, oa, host_s = self._window_enqueue(
                    center_xy, base_map=base[0], base_anchor=base[1],
                    origin_anchor=base[2],
                )
                holder["map"] = dev
                holder["center"] = center
                holder["origin_anchor"] = oa
                holder["built"].set()
                self._window_finalize(dev, host_s)
            finally:
                holder["built"].set()  # no-op if already set; unblocks a
                # joiner when the ENQUEUE itself raised
                holder["done"].set()

        self._prefetch = holder
        # non-daemon: an H2D in flight while the interpreter tears down the
        # PJRT client aborts the process (a post-swap prefetch nobody
        # consumed did this); a clean exit waits out the crop instead
        threading.Thread(target=work, daemon=False).start()

    def _maybe_rewindow(self, pos_xy, lookahead_xy=None):
        """Re-crop before sensor-range correspondences can truncate at the
        window edge (and never re-upload an identical window — a boundary-
        clamped window cannot follow the pose, which would otherwise thrash
        a full crop+upload every scan).

        With ``map_window_prefetch`` (default) the next window's crop + H2D
        runs in a background thread while frames keep flowing on the current
        window (double buffering). The anchor-divergence ladder makes the
        prefetch deterministic: when the ideal window anchor drifts ONE tile
        from the resident one, that window is warmed in the background; only
        at TWO tiles (one more tile of driving — ample time for the worker)
        does the swap fire, and the warmed window is then always within one
        tile of ideal, which the 2-tile slack inside ``_window_margin``
        absorbs losslessly. The boundary hiccup becomes a pointer swap
        instead of a synchronous crop+upload.

        ``lookahead_xy``: predicted displacement (m) the vehicle covers
        before this ladder is consulted again — the PREFETCH stage is
        evaluated at ``pos + lookahead`` so coarse-grained callers still
        give the background crop its notice (the chunked replay reads the
        pose back once per ``chunk`` frames, which at speed skips straight
        from div=0 past the div>=2 swap trigger between consultations, and
        every swap then turns synchronous). The swap decision itself stays
        at the real
        pose."""
        if self._host_tmap is None:
            return
        pos = np.asarray(pos_xy, float)
        ts = self._host_tmap.tile_size
        margin = self._window_margin()
        dist = np.max(np.abs(pos - self._window_center))
        anchor = self._host_tmap.window_anchor(pos, self._window_dims())
        div = max(abs(anchor[0] - self._window_offset_tiles[0]),
                  abs(anchor[1] - self._window_offset_tiles[1]))
        must_swap = dist > margin and div >= 2
        if not must_swap:
            # start early: a city-window crop+upload takes ~0.5-2 s (mmap
            # page-in + H2D) and needs several frames of notice
            ahead = pos
            dist_a, div_a = dist, div
            if lookahead_xy is not None:
                ahead = pos + np.asarray(lookahead_xy, float)
                dist_a = np.max(np.abs(ahead - self._window_center))
                anchor_a = self._host_tmap.window_anchor(
                    ahead, self._window_dims())
                div_a = max(abs(anchor_a[0] - self._window_offset_tiles[0]),
                            abs(anchor_a[1] - self._window_offset_tiles[1]))
            if (
                self._window_prefetch and div_a >= 1
                and dist_a > max(margin - 6.0 * ts, 0.0)
            ):
                self._start_prefetch(ahead)
            return
        pf = self._prefetch
        # Adopt when the warmed window is close enough to the anchor a
        # synchronous swap would pick that the sensor range still fits with
        # a voxel to spare: each tile of staleness costs one tile of the
        # window's (half - sensor) slack. Degenerate windows (smaller than
        # the sensor range) keep a 1-tile tolerance — margin semantics are
        # best-effort there anyway.
        sensor = float(self.cfg.pcm.input_max_dist)
        slack_tiles = max(
            int((self._window_tiles * ts - sensor) / ts) - 1, 1
        )
        import time as _time

        adopted = False
        if (
            pf is not None
            and max(abs(pf["anchor"][0] - anchor[0]),
                    abs(pf["anchor"][1] - anchor[1])) <= slack_tiles
        ):
            if pf["built"].is_set():
                key = "prefetch_hits"
            else:
                # the crop is still in flight: JOIN it rather than starting
                # a from-scratch synchronous crop. Only the BUILT stage is
                # waited for (host crop + enqueue, milliseconds) — the H2D
                # itself needs no wait, the device stream orders it before
                # the next chunk (see _start_prefetch).
                key = "prefetch_joins"
                t0 = _time.time()
                pf["built"].wait()
                self.window_stats["swap_wait_s"] += _time.time() - t0
            if "map" in pf:  # absent if the worker crashed
                self._adopt_window(pf["map"], pf["center"], pf["anchor"],
                                   pf["origin_anchor"])
                self.window_stats[key] += 1
                adopted = True
        if not adopted:
            t0 = _time.time()
            if pf is not None and not pf["done"].is_set():
                # A stale in-flight crop (anchor drifted beyond slack) must
                # not run CONCURRENTLY with the synchronous crop below — on a
                # starved host two full crops would compete for the core and
                # evict each other's page cache at exactly the swap-hiccup
                # moment. Drain it first, then crop.
                pf["done"].wait()
            self._set_window(pos)
            self.window_stats["sync_swaps"] += 1
            self.window_stats["swap_wait_s"] += _time.time() - t0
        self._prefetch = None
        self.window_stats["swaps"] += 1
        if self._window_prefetch and lookahead_xy is not None:
            # Warm the NEXT window immediately: at speed the inter-swap
            # interval is the only wall-clock the crop+H2D worker gets, and
            # waiting for the ladder's div>=1 stage to trigger again gives
            # it one consult (~a chunk) of notice, and most chunked-replay
            # swaps stay synchronous that way. The FULL lookahead: callers
            # pass a one-consult horizon (the chunked loop predicts exactly
            # one further chunk), so the warm target IS the next consult's
            # expected pose — a shorter one leaves the warmed window a tile
            # short of the next swap's anchor, turning it synchronous. A
            # wrong guess just discards the warmed window.
            self._start_prefetch(pos + np.asarray(lookahead_xy, float))

    def _ground_from_tiles(self, position_xy, search_range: float = 5.0):
        """FindGroundHeight from the packed tile map (for pipelines built
        from a HostTileMap, where the raw BuiltMap is not loaded): mean z of
        the 5 lowest halo points of the query tile within range — the halo
        spans the tile +- 1 voxel, covering the 5 m probe at default sizes."""
        h = self._host_tmap if self._host_tmap is not None \
            else self._tiles_host_full
        ts = h.tile_size
        tx = int(np.floor(position_xy[0] / ts)) - h.tx0
        ty = int(np.floor(position_xy[1] / ts)) - h.ty0
        if not (0 <= tx < h.tx_dim and 0 <= ty < h.ty_dim):
            return False, 0.0
        pts = np.asarray(h.halo_points[tx * h.ty_dim + ty])
        pts = pts[np.isfinite(pts[:, 0])]
        d2 = np.sum((pts[:, :2] - np.asarray(position_xy)) ** 2, axis=1)
        within = pts[d2 <= search_range * search_range]
        if within.shape[0] <= 3:
            return False, 0.0
        low = within[np.argsort(within[:, 2])[:5]]
        return True, float(low[:, 2].mean())

    def _rebase(self, t):
        if self.time_base is None:
            self.time_base = float(np.floor(np.min(np.asarray(t))))
        return np.asarray(t, np.float64) - self.time_base

    def reset(self) -> PipelineState:
        self.time_base = None
        return PipelineState(
            ekf=init_state(self.params.ekf, dtype=self.dtype),
            ego_ring=rings.make_ego_ring(self._ego_ring_size, self.dtype),
            imu_ring=rings.make_imu_ring(self._imu_ring_size, self.dtype),
        )

    def reload_config(self, cfg: ElimalocConfig) -> None:
        """Hot-reload (the reference's ProcessINI + UpdateDynamicConfig,
        ekf_localization.cpp:218-320 / ekf_algorithm.cpp:68-79): continuous
        parameters swap in without recompilation (they are pytree leaves);
        changed feature flags produce a new PipelineStatic and re-jit (the
        compile cache keeps previously-seen configurations warm)."""
        self.cfg = cfg
        old_static = self.static
        self.params = make_pipeline_params(cfg, dtype=self.dtype)
        self.static = make_pipeline_static(
            cfg,
            backend=old_static.icp_static.backend,
            tile_budget=old_static.icp_static.tile_budget,
            ds_points=old_static.ds_points,
            bug_compat_deskew_z=old_static.bug_compat_deskew_z,
            sub_unroll=old_static.sub_unroll,
            reassign_each_iter=self._reassign_override,
        )
        if self.static == old_static:
            # value-only change: swap the device params pytree; the live jit
            # wrappers hit their existing trace-cache entries (no recompile,
            # no stream stall — the common mid-run hot-reload case)
            self._dev_params = jax.device_put(self.params)
        else:
            self._build_jitted()

    def project_gps(self, lat, lon, height):
        """lat/lon/h -> local xyz using the configured geodetic origin
        (ProjectGpsPoint, ekf_localization.cpp:643-648). projection_mode
        selects ENU ("Cartesian", localization.ini:14) or the UTM plane (dead
        config in the reference; implemented here)."""
        from ..ops import geo

        e = self.cfg.ekf
        fwd = (geo.project_gps_point_utm
               if self.cfg.pcm.projection_mode.upper() == "UTM"
               else geo.project_gps_point)
        return np.asarray(
            fwd(lat, lon, height, e.ref_latitude, e.ref_longitude, e.ref_height)
        )

    def unproject(self, xyz):
        """Local xyz -> (lat, lon, h) — LocalCartesian::Reverse equivalent
        (ekf_localization.cpp:412-418), honoring projection_mode."""
        from ..ops import geo

        e = self.cfg.ekf
        rev = (geo.unproject_local_point_utm
               if self.cfg.pcm.projection_mode.upper() == "UTM"
               else geo.unproject_local_point)
        lat, lon, h = rev(xyz, e.ref_latitude, e.ref_longitude, e.ref_height)
        return np.asarray(lat), np.asarray(lon), np.asarray(h)

    # ---- relocalization (CallbackInitialPose, pcm_matching.cpp:356-447) ----
    def initialize_at(self, state: PipelineState, x, y, yaw, scan_points,
                      scan_valid, timestamp) -> Tuple[PipelineState, bool]:
        """rviz-click flow: ground-height fix -> ICP from the clicked pose ->
        PCM_INIT hard reset into the EKF."""
        timestamp = float(self._rebase(timestamp))
        if self.built is not None:
            found, ground_z = map_builder.find_ground_height(
                self.built, [x, y])
        else:
            found, ground_z = self._ground_from_tiles([x, y])
        if not found:
            return state, False
        if self._host_tmap is not None:
            # relocalization usually targets a pose far outside the resident
            # window — re-crop around the click before registering
            self._maybe_rewindow(np.asarray([x, y], float))
        pose = np.eye(4)
        pose[:3, :3] = np.asarray(lie.euler_to_rot(jnp.asarray([0.0, 0.0, yaw])))
        pose[:3, 3] = [x, y, ground_z]
        init_lidar = lie.compose(
            jnp.asarray(pose, self.dtype), self.params.tf_ego_to_lidar
        )
        ds_pts, ds_valid, _ = voxel_downsample(
            jnp.asarray(scan_points, self.dtype), jnp.asarray(scan_valid),
            self.params.input_voxel_ds, self.static.ds_points,
        )
        res = self._register(ds_pts, ds_valid, self.map, init_lidar)
        if not bool(res.success):
            return state, False
        final = lie.compose(res.pose, self.params.tf_lidar_to_ego)
        state = self._pcm_init_step(
            state, jnp.asarray(timestamp, self.dtype), final
        )
        return state, True

    # ---- host event loop ----
    def run(self, log: ReplayLog, state: Optional[PipelineState] = None,
            collect_every_imu: bool = False, on_scan=None):
        """Replay a log in event-time order. Returns (state, trajectory dict).

        ``on_scan(out)``: observer invoked after every scan with the scan
        diagnostics plus ego_pos/ego_t — e.g. ``utils.viz.LiveViz.on_scan``
        for a browser view that follows the run."""
        state = state if state is not None else self.reset()
        base_candidates = [log.imu_t[0], log.scan_t[0]]
        self._rebase(min(base_candidates))
        events = []
        if self.static.use_imu:
            events += [
                ("imu", i, t) for i, t in enumerate(self._rebase(log.imu_t))
            ]
        else:
            # the reference's 100 Hz MainLoop drives CA predictions; the PCM
            # node still consumes raw IMU for deskewing
            events += [
                ("pcm_imu", i, t) for i, t in enumerate(self._rebase(log.imu_t))
            ]
            t0r = float(self._rebase(log.imu_t[0]))
            t1r = float(self._rebase(log.imu_t[-1]))
            ticks = np.arange(t0r, t1r, 1.0 / self.static.tick_hz)
            events += [("tick", i, t) for i, t in enumerate(ticks)]
        # Scans are DELIVERED when the sweep completes: with
        # lidar_scan_time_end the header IS the last point time, otherwise
        # the last point trails the header by up to a sweep (the reference's
        # callback likewise fires on message arrival, after acquisition).
        arrival = scan_arrival_times(log)
        scan_stamps = self._rebase(log.scan_t)
        events += [
            ("scan", i, t) for i, t in enumerate(self._rebase(arrival))
        ]
        if log.gps_t is not None and self.static.use_gps:
            events += [("gps", i, t) for i, t in enumerate(self._rebase(log.gps_t))]
        if log.can_t is not None and self.static.use_can:
            events += [("can", i, t) for i, t in enumerate(self._rebase(log.can_t))]
        events.sort(key=lambda e: e[2])

        traj_t, traj_pos, traj_rpy, scan_log = [], [], [], []
        f = self.dtype
        for kind, i, t in events:
            if kind in ("imu", "pcm_imu", "tick"):
                # the reference polls ProcessINI inside every IMU callback
                # (ekf_localization.cpp:141); a host mtime stat is ~free
                self._poll_config()
            tv = jnp.asarray(t, f)
            if kind == "tick":
                state = self._tick_step(state, tv)
            elif kind == "pcm_imu":
                state = self._imu_ring_step(
                    state, tv, jnp.asarray(log.imu_acc[i], f),
                    jnp.asarray(log.imu_gyro[i], f),
                )
            elif kind == "imu":
                state = self._imu_step(
                    state, tv, jnp.asarray(log.imu_acc[i], f),
                    jnp.asarray(log.imu_gyro[i], f),
                )
                if collect_every_imu:
                    es = ego_state(state.ekf)
                    traj_t.append(float(es["timestamp"]) + self.time_base)
                    traj_pos.append(np.asarray(es["pos"]))
                    traj_rpy.append(np.asarray(es["rpy"]))
            elif kind == "scan":
                if self._host_tmap is not None:
                    pv = np.asarray(jnp.concatenate(
                        [state.ekf.pos[:2], state.ekf.vel[:2]]))
                    # ~1 s of motion at the current velocity as prefetch
                    # notice (a city crop+H2D takes ~0.5-2 s)
                    self._maybe_rewindow(pv[:2], pv[2:] * 1.0)
                state, out = self._scan_step(
                    state, jnp.asarray(scan_stamps[i], f),
                    jnp.asarray(log.scan_points[i], f),
                    jnp.asarray(log.scan_times[i], f),
                    jnp.asarray(log.scan_valid[i]),
                    self.map,
                )
                es = ego_state(state.ekf)
                traj_t.append(float(es["timestamp"]) + self.time_base)
                traj_pos.append(np.asarray(es["pos"]))
                traj_rpy.append(np.asarray(es["rpy"]))
                scan_log.append(
                    {k: np.asarray(v) for k, v in out.items()}
                )
                if on_scan is not None:
                    on_scan({**scan_log[-1], "ego_pos": traj_pos[-1],
                             "ego_t": traj_t[-1]})
                self._maybe_dashboard(state)
            elif kind == "gps":
                state = self._gps_step(
                    state, tv, jnp.asarray(log.gps_pos[i], f),
                    jnp.asarray(log.gps_cov[i], f),
                )
            elif kind == "can":
                state = self._can_step(
                    state, tv, jnp.asarray(log.can_vel[i], f),
                    jnp.asarray(log.can_yaw_rate[i], f),
                )
        traj = {
            "t": np.asarray(traj_t),
            "pos": np.stack(traj_pos) if traj_pos else np.zeros((0, 3)),
            "rpy": np.stack(traj_rpy) if traj_rpy else np.zeros((0, 3)),
            "scans": scan_log,
        }
        return state, traj

    # ---- config hot-reload + live dashboard hooks ----
    def watch_config(self, localization_ini: str,
                     calibration_ini: Optional[str] = None) -> None:
        """Arm per-frame ini hot-reload for :meth:`run` / :meth:`run_frames`
        (the reference polls ProcessINI inside every IMU callback,
        ekf_localization.cpp:141/218-320). Polling is a host-side mtime
        stat per frame; on change the new config is applied via
        :meth:`reload_config` — continuous parameters swap in, flag changes
        re-jit — without touching the filter state."""
        from ..config import ConfigWatcher

        self._config_watcher = ConfigWatcher(localization_ini, calibration_ini)
        # the watcher's constructor poll loaded current file contents; treat
        # those as already applied (the caller constructed us with them)
        self._config_watcher.cfg = self.cfg

    def _poll_config(self) -> None:
        w = getattr(self, "_config_watcher", None)
        if w is not None and w.poll():
            self.reload_config(w.cfg)

    def _maybe_dashboard(self, state: PipelineState) -> None:
        """1 Hz (sim-time) σ/config dashboard while running, gated on the
        reference's debug_print flag (ekf_algorithm.cpp:176-180 prints
        PrintState from a 1 s ROS timer)."""
        if not self.cfg.ekf.debug_print:
            return
        from ..utils.observability import state_dashboard

        t = float(state.ekf.prev_timestamp)
        last = getattr(self, "_last_dashboard_t", None)
        if last is None or t - last >= 1.0:
            self._last_dashboard_t = t
            print(state_dashboard(state.ekf, self.cfg.ekf), flush=True)

    # ---- frame-batched streaming (the online serving mode) ----
    def run_frames(self, log: ReplayLog,
                   state: Optional[PipelineState] = None, *, batches=None,
                   on_scan=None, chunk: Optional[int] = None):
        """Streaming replay at fused efficiency: ONE jitted call per scan
        frame (that frame's IMU/CAN/GPS sub-batch + the scan), host loop
        across frames. This is the online mode — per-event dispatch
        (:meth:`run`) costs a host round-trip per sensor message, while a
        frame is one dispatch per LiDAR period. Returns (state, outs) with
        the same fields as :meth:`run_fused`.

        ``chunk`` (windowed replays): dispatch ``chunk`` frames per device
        call via :func:`replay_fused_chunk` — fused-level throughput for
        maps that cannot run :meth:`run_fused`'s single program because the
        active window must swap mid-log. The host reads the pose back once
        per chunk (instead of once per frame) to drive the window ladder,
        so the window margin must absorb ``chunk`` frames of motion; the
        prefetch ladder's tile-hysteresis already provides several tiles of
        slack at default sizes."""
        state = state if state is not None else self.reset()
        self._rebase(min(log.imu_t[0], log.scan_t[0]))
        if batches is None:
            batches = build_fused_batches(log, time_base=self.time_base)
        # one explicit H2D for the whole log: the per-frame loop must never
        # depend on implicit argument-transfer caching (a numpy leaf here
        # would re-upload the full log every frame)
        batches = jax.device_put(batches)
        n = len(log.scan_t)
        outs = []
        if chunk is not None and chunk > 1:
            def chunk_fn(*a):
                # looked up PER CHUNK, not captured before the loop: a
                # mid-run hot-reload that changes a compile-time flag
                # rebuilds self._chunk_jits (reload_config -> _build_jitted)
                # and the remaining chunks must run the NEW-flag program —
                # a stale capture would silently mix old-flag code with
                # new param values
                if chunk not in self._chunk_jits:
                    self._chunk_jits[chunk] = jax.jit(functools.partial(
                        replay_fused_chunk, ps=self.static, chunk=chunk,
                    ))
                return self._chunk_jits[chunk](*a, pp=self._dev_params)

            # FREE-RUNNING dispatch: reading one pose back per chunk would
            # serialize every chunk with a host round-trip AND consult the
            # window ladder only at chunk cadence — at speed the pose skips
            # from div=0 past the div>=2 swap trigger between consults, so
            # the prefetcher never gets wall-clock notice. So chunks are
            # dispatched back-to-back with NO per-chunk sync:
            # each chunk's per-frame poses are fetched asynchronously, the
            # newest LANDED fetch re-anchors a host-side motion model
            # (constant-acceleration fit of the chunk's frame deltas), and
            # the ladder is consulted at the PREDICTED pose of the chunk
            # about to be dispatched. Prediction error is bounded by the
            # window's (half - sensor) slack like any other staleness; a
            # wrong prefetch guess just discards a warmed window. One
            # blocking seed read (chunk 0) starts the model.
            pend = []          # (first_frame, ego_pos device array)
            motion = None      # (f_last, xy_last, d, a): frame of the last
            #                    observed pose, its xy, per-frame velocity,
            #                    per-frame acceleration
            windowed = self._host_tmap is not None

            def _fit_motion(ppos, f0):
                xy = np.asarray(ppos, np.float64)[:, :2]
                f_last = f0 + len(xy) - 1
                if len(xy) >= 3:
                    d = xy[1:] - xy[:-1]
                    return (f_last, xy[-1], d[-1],
                            (d[-1] - d[0]) / max(len(d) - 1, 1))
                if len(xy) == 2:
                    return f_last, xy[-1], xy[-1] - xy[0], np.zeros(2)
                return f_last, xy[-1], np.zeros(2), np.zeros(2)

            def _predict(f):
                f_last, xy, d, a = motion
                k = max(f - f_last, 0)
                return xy + k * d + a * (k * (k + 1)) / 2.0

            if windowed and self._window_prefetch:
                # Warm the FORWARD window before the first frame: the first
                # swap of a run otherwise has zero notice (the ladder cannot
                # see motion before the first chunk lands). The configured
                # initial heading is the serving-time equivalent of the
                # reference operator's init pose (ekf_init_* ini keys); a
                # wrong guess is discarded like any stale prefetch.
                yaw = np.deg2rad(self.cfg.ekf.ekf_init_yaw_deg)
                fwd = 2.0 * self._host_tmap.tile_size * np.array(
                    [np.cos(yaw), np.sin(yaw)])
                self._start_prefetch(np.asarray(self._window_center) + fwd)
            for ci, k0 in enumerate(range(0, n, chunk)):
                self._poll_config()
                if windowed:
                    if motion is None and ci == 1:
                        # seed the motion model: one blocking read, once
                        motion = _fit_motion(np.asarray(pend[0][1]),
                                             pend[0][0])
                        pend = pend[1:]
                    else:
                        # re-anchor from the newest chunk whose async fetch
                        # has LANDED — never block the dispatch loop
                        for i in range(len(pend) - 1, -1, -1):
                            f0, arr = pend[i]
                            ready = getattr(arr, "is_ready", None)
                            if ready is not None and ready():
                                motion = _fit_motion(np.asarray(arr), f0)
                                pend = pend[i + 1:]
                                break
                    if motion is not None:
                        # consult at the predicted END of the chunk being
                        # dispatched (any farther and early-chunk frames
                        # could see the window centered beyond the sensor
                        # slack); lookahead = one further chunk, so the
                        # prefetch targets where the NEXT consult will swap
                        pred = _predict(k0 + chunk - 1)
                        la = _predict(k0 + 2 * chunk - 1) - pred
                        self._maybe_rewindow(pred, la)
                state, out = chunk_fn(
                    state, batches, jnp.asarray(k0, jnp.int32), self.map
                )
                if windowed:
                    _async_host_fetch(out["ego_pos"])
                    pend.append((k0, out["ego_pos"]))
                    del pend[:-8]  # prediction only needs the newest few
                outs.append(out)
                if on_scan is not None:
                    # trim the final ragged chunk's pad rows (they re-ran the
                    # last frame with a clamped index); observers must see
                    # each real frame exactly once
                    live = min(chunk, n - k0)
                    on_scan(out if live == chunk else jax.tree_util.tree_map(
                        lambda x: x[:live], out))
                self._maybe_dashboard(state)
            stacked_dev = jax.tree_util.tree_map(
                lambda *xs: jnp.concatenate(xs), *outs
            )
            stacked_dev = jax.tree_util.tree_map(
                lambda x: x[:n], stacked_dev   # drop ragged-chunk pad rows
            )
        else:
            pose_pending = None
            for k in range(n):
                self._poll_config()
                if self._host_tmap is not None:
                    if pose_pending is not None:
                        # one-frame-stale pose: reading the CURRENT pose
                        # would synchronize every frame with the host; the
                        # window ladder has tiles of slack, one frame of
                        # vehicle motion is noise against it
                        self._maybe_rewindow(np.asarray(pose_pending)[:2])
                    else:
                        pv = np.asarray(state.ekf.pos[:2])
                        self._maybe_rewindow(pv)
                state, out = self._frame_at(
                    state, batches, jnp.asarray(k, jnp.int32), self.map
                )
                if self._host_tmap is not None:
                    pose_pending = out["ego_pos"]
                    _async_host_fetch(pose_pending)
                outs.append(out)
                if on_scan is not None:
                    # observer sees device arrays; converting syncs — that
                    # is the observer's (throttled) choice, not the frame
                    # loop's
                    on_scan(out)
                self._maybe_dashboard(state)
            # stack on device, read back once (each host sync stalls the
            # dispatch loop)
            stacked_dev = jax.tree_util.tree_map(
                lambda *xs: jnp.stack(xs), *outs
            )
        stacked = {k: np.asarray(v)
                   for k, v in jax.device_get(stacked_dev).items()}
        stacked["ego_t_abs"] = (
            np.asarray(stacked["ego_t"], np.float64) + self.time_base
        )
        return state, stacked

    # ---- fused replay ----
    def run_fused(self, log: ReplayLog, state: Optional[PipelineState] = None,
                  window_chunk: int = 8):
        """Whole-log fused replay. Full-map pipelines compile ONE program
        over the log; active-window pipelines (map_window_radius) cannot —
        the window must swap mid-log — so they run the CHUNKED fused path
        (:func:`replay_fused_chunk` via ``run_frames(chunk=window_chunk)``):
        one compiled chunk program reused across the log with window
        management between chunks. Same return shape either way."""
        if self._host_tmap is not None:
            return self.run_frames(log, state, chunk=max(int(window_chunk), 1))
        state = state if state is not None else self.reset()
        self._rebase(min(log.imu_t[0], log.scan_t[0]))
        batches = build_fused_batches(log, time_base=self.time_base)
        state, outs = self._fused(state, batches, self.map)
        outs["ego_t_abs"] = np.asarray(outs["ego_t"], np.float64) + self.time_base
        return state, outs

    def run_fused_fleet(self, logs, states=None):
        """Multi-stream fused replay: ``B`` independent logs localized
        against the shared map in ONE vmapped program (the single-chip
        serving/fleet mode — see :func:`~elimaloc_tpu.parallel.sharding.
        replay_fused_fleet`; on a mesh the same lanes shard with
        ``replay_fused_dp``). The reference runs one vehicle per process
        pair (SURVEY.md §2 C12); lanes here amortize the fixed per-frame
        dispatch overhead of the tiny per-vehicle tensors.

        Logs must share a scan count (frame axis); per-frame sub-batch
        capacities are padded to the fleet max (pad rows carry
        ``valid=False``, which every consumer masks). Returns
        ``(states, outs)`` with a leading lane axis on every field;
        per-lane trajectories are identical to :meth:`run_fused` runs.
        """
        from ..parallel import replay_fused_fleet, stack_streams

        if self._host_tmap is not None:
            raise ValueError(
                "fleet replay compiles the whole log batch into one program "
                "and cannot swap map windows; use run()/run_frames() per "
                "stream with map_window_radius"
            )
        ns = {len(log.scan_t) for log in logs}
        if len(ns) != 1:
            raise ValueError(
                f"fleet logs must share a scan count, got {sorted(ns)}"
            )
        if states is None:
            states = [self.reset() for _ in logs]
        bases, batch_list = [], []
        for log in logs:
            tb = float(np.floor(min(log.imu_t[0], log.scan_t[0])))
            bases.append(tb)
            batch_list.append(build_fused_batches(log, time_base=tb))
        keys = set(batch_list[0])
        if any(set(b) != keys for b in batch_list[1:]):
            raise ValueError("fleet logs must share sensor streams (can/gps)")
        # pad per-frame capacity axes to the fleet max; pad rows are
        # valid=False (np.zeros) so the masked consumers ignore them
        for k in keys:
            shapes = [b[k].shape for b in batch_list]
            mx = tuple(max(s[d] for s in shapes)
                       for d in range(len(shapes[0])))
            for b in batch_list:
                if b[k].shape != mx:
                    a = np.asarray(b[k])
                    pad = [(0, m - s) for s, m in zip(a.shape, mx)]
                    b[k] = jnp.asarray(np.pad(a, pad))
        states_b = stack_streams(states)
        batches_b = stack_streams(batch_list)
        states_b, outs = replay_fused_fleet(
            states_b, batches_b, self.map, self.params, self.static
        )
        outs["ego_t_abs"] = (
            np.asarray(outs["ego_t"], np.float64)
            + np.asarray(bases)[:, None]
        )
        self.time_base = None  # per-lane bases; the host clock is lane-local
        return states_b, outs
