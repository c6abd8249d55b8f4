"""Scan-to-map registration: P2P / GICP / VGICP / AVGICP in JAX.

Re-implements the reference's Registration module (reference:
src/app/localization/pcm_matching/src/registration.cpp) as one jitted
fixed-shape Gauss-Newton/LM loop:

  * RunRegister's iterate-until-converged outer loop (cpp:273-418) becomes a
    ``lax.while_loop`` whose carry holds (pose, iteration, fitness, local_cov,
    done/failed flags) — early exits (overlap gate cpp:351-356, termination
    cpp:380-391) are loop-carried booleans, not control flow;
  * the per-point 6x6 JTJ / 6x1 JTr accumulations of the four AlignClouds*
    solvers (cpp:15-225) become masked batched einsums with the Jacobian's
    [I | -skew(p)] block structure expanded analytically;
  * correspondence search is the packed-grid query (map/grid.py).

Reference quirks preserved:
  * the robust weight is th^2 / (th + |r|^2)^2 — th is NOT squared in the
    denominator's first term (cpp:44, 121, 199);
  * VGICP/AVGICP skip residuals with weight < 0.01 from both JTJ and the
    fitness numerator, but the denominator stays the full match count
    (cpp:199-207);
  * AVGICP's overlap ratio counts (point, voxel) PAIRS against the point
    count, so it can exceed 1 (cpp:349-351 with GetCorrespondencesAllCov);
  * only the GICP solver writes local_cov; other methods leave it identity
    (cpp:280, 140-142) — the downstream covariance shaping sees identity;
  * use_radar_cov point covariances are computed from the *globally
    transformed* cloud once per registration (cpp:302-305) and the scaling is
    R @ S, not R S R^T (hpp:186-208).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
from .. import pytree

# GPU f32 matmuls may default to TF32; Gauss-Newton accumulation and
# frame transforms need true f32.
_HI = jax.lax.Precision.HIGHEST

from ..config import IcpMethod, PcmConfig
from ..map import grid as mapgrid
from ..map import tiles as maptiles
from ..ops import lie


@pytree.dataclass
class IcpParams:
    """Continuous registration parameters (dynamic pytree leaves).
    Mirrors RegistrationConfig (registration.hpp:62-85)."""

    max_search_dist: jnp.ndarray
    lm_lambda: jnp.ndarray
    termination_threshold: jnp.ndarray
    min_overlap_ratio: jnp.ndarray
    max_fitness_score: jnp.ndarray
    range_variance_m: jnp.ndarray
    azimuth_variance_deg: jnp.ndarray
    elevation_variance_deg: jnp.ndarray
    # correspondence-reuse bound (extension, PcmConfig.corr_refresh_dist_m
    # — 0 re-searches every iteration like the reference, cpp:310-347)
    corr_refresh_dist: jnp.ndarray


@dataclasses.dataclass(frozen=True)
class IcpStatic:
    """Compile-time registration switches.

    ``backend`` selects the correspondence engine: "tile" (default) runs the
    tile-blocked dense path (map/tiles.py); "hash" runs the gather-based
    hash-grid reference path (map/grid.py). Results agree up to argmin tie
    order. ``tile_budget`` bounds the slot
    packing; overflow drops queries conservatively (they count as unmatched).
    """

    method: int = int(IcpMethod.GICP)
    max_iteration: int = 10
    use_radar_cov: bool = False
    backend: str = "tile"
    # Compile-time gate for the correspondence-reuse loop (tile backend):
    # when False (the default, corr_refresh_dist_m == 0) the while body is
    # the plain search+solve dataflow with NO match carry — the lax.cond
    # boundary and the per-iteration carry copy of the match tensors cost
    # fused throughput, so reference behavior must not pay for the feature.
    corr_reuse: bool = False
    # Re-run the tile-slot assignment from the CURRENT pose every GN
    # iteration (exact reference search semantics, registration.cpp:310-347)
    # instead of freezing it at the initial guess. Required for AVGICP
    # oracle parity (see make_icp_static); mutually exclusive with
    # corr_reuse (reused matches are indexed by a fixed assignment).
    reassign_each_iter: bool = False
    tile_budget: maptiles.TileQueryBudget = maptiles.TileQueryBudget()
    # When set, the source-point axis is sharded across this mesh axis:
    # per-device partial (matched, JTJ, JTr, fitness numerator, valid count)
    # are psum'd so every device runs the identical LM solve and termination
    # logic in lockstep (SURVEY.md §5.7: the reduction is associative, the
    # same property tbb::parallel_reduce exploits on the CPU).
    psum_axis: str | None = None
    # When set (tile backend), inputs are REPLICATED and the tile-SLOT axis
    # is sharded across this mesh axis instead: every device runs the cheap
    # sort/pack stages identically, evaluates the dense
    # correspondence + Gauss-Newton partials for its own 1/n_dev slot range,
    # and psums the 6x6 partials. This is how the FUSED pipeline multi-chips
    # a single scan: spatially-random point sharding would leave each shard
    # touching nearly every tile (slot count is tile-bound, not query-bound),
    # so the slot axis — not the point axis — is the scaling dimension.
    slot_shard_axis: str | None = None


def make_icp_params(cfg: PcmConfig, dtype=jnp.float32) -> IcpParams:
    f = lambda v: jnp.asarray(v, dtype=dtype)
    return IcpParams(
        max_search_dist=f(cfg.max_search_dist),
        lm_lambda=f(cfg.lm_lambda),
        termination_threshold=f(cfg.icp_termination_threshold_m),
        min_overlap_ratio=f(cfg.min_overlap_ratio),
        max_fitness_score=f(cfg.max_fitness_score),
        range_variance_m=f(cfg.range_variance_m),
        azimuth_variance_deg=f(cfg.azimuth_variance_deg),
        elevation_variance_deg=f(cfg.elevation_variance_deg),
        corr_refresh_dist=f(cfg.corr_refresh_dist_m),
    )


def make_icp_static(cfg: PcmConfig, backend: str = "tile",
                    tile_budget: maptiles.TileQueryBudget | None = None,
                    reassign_each_iter: bool | None = None) -> IcpStatic:
    if reassign_each_iter is None:
        # AVGICP sums ALL 7 face-adjacent voxel covs per point, so losing
        # halo-edge candidates to a stale initial-guess tile assignment is a
        # systematic bias (1.9-13.4 mm/registration vs the f64 oracle at
        # 0.3 m init error); the argmin methods
        # are insensitive (~1e-6 m) and keep the cheaper hoisted assignment.
        # an explicit corr_refresh_dist_m opt-in takes precedence (the two
        # are mutually exclusive; reused matches index a fixed assignment)
        reassign_each_iter = (
            int(cfg.icp_method) == int(IcpMethod.AVGICP)
            and not float(cfg.corr_refresh_dist_m) > 0.0
        )
    return IcpStatic(
        method=int(cfg.icp_method),
        max_iteration=int(cfg.max_iteration),
        use_radar_cov=bool(cfg.use_radar_cov),
        backend=backend,
        corr_reuse=float(cfg.corr_refresh_dist_m) > 0.0,
        reassign_each_iter=bool(reassign_each_iter),
        tile_budget=tile_budget or maptiles.TileQueryBudget(),
    )


@pytree.dataclass
class IcpResult:
    pose: jnp.ndarray        # [4,4] refined sensor pose (global)
    success: jnp.ndarray     # bool
    fitness: jnp.ndarray     # scalar (method-specific score, lower = better)
    local_cov: jnp.ndarray   # [6,6] (JTJ + lambda diag)^-1 — GICP only
    iterations: jnp.ndarray  # int32
    overlap: jnp.ndarray     # last correspondence ratio
    dropped: jnp.ndarray     # int32 queries dropped on tile-slot overflow
                             # (0 on the hash backend; nonzero means the
                             # TileQueryBudget is undersized for this scan)


# --------------------------------------------------------------------------- #
# Small linear-algebra helpers
# --------------------------------------------------------------------------- #

# batched closed-form 3x3 inverse (lives in ops/lie.py; kept name)
_inv3x3 = lie.inv3x3


def _accumulate_gn(src_local, tgt_global, maha, w, mask, pose):
    """Masked sum of J^T M J and J^T M r with J = [I | -skew(p_local)]
    (cpp:36-48 / 115-125 / 193-205). All inputs are flat [K,...] batches."""
    inv_pose = lie.transform_inverse(pose)
    tgt_local = (
        jnp.einsum("ij,kj->ki", inv_pose[:3, :3], tgt_global, precision=_HI) + inv_pose[:3, 3]
    )
    r = tgt_local - src_local                                  # [K,3]
    wm = (w * mask)[:, None, None]
    A = wm * maha                                              # [K,3,3]
    S = lie.skew(src_local)                                    # [K,3,3]
    # No symmetry assumed on A: the reference's SVD-regularized covariances
    # (U diag V^T) are asymmetric at degenerate singular values, and it feeds
    # them into J^T M J verbatim — so bl != tr^T in general.
    AS = jnp.einsum("kij,kjl->kil", A, S, precision=_HI)                      # [K,3,3]
    tl = jnp.sum(A, axis=0)                                    # sum M
    tr = -jnp.sum(AS, axis=0)                                  # sum -M S
    bl = jnp.einsum("kij,kjl->il", S, A, precision=_HI)                       # sum S M
    br = -jnp.einsum("kij,kjl->il", S, AS, precision=_HI)                     # sum -S M S
    Ar = jnp.einsum("kij,kj->ki", A, r, precision=_HI)                        # [K,3]
    jtr_top = jnp.sum(Ar, axis=0)
    jtr_bot = jnp.einsum("kij,kj->i", S, Ar, precision=_HI)                   # sum S M r
    JTJ = jnp.block([[tl, tr], [bl, br]])
    JTr = jnp.concatenate([jtr_top, jtr_bot])
    return JTJ, JTr, r


def _solve_step(JTJ, JTr, lm_lambda):
    """LM-damped solve (cpp:55-56) -> (x, regularized JTJ)."""
    reg = JTJ + lm_lambda * jnp.diag(jnp.diag(JTJ))
    x = jnp.linalg.solve(reg, JTr)
    return x, reg


def _step_transform(x):
    """6-vector -> small SE(3) transform (cpp:58-62)."""
    return lie.make_transform(lie.so3_exp(x[3:6]), x[0:3])


def _smallest_eigvec(covs):
    """Unit eigenvector of the smallest eigenvalue for [N,3,3] symmetric
    matrices (cpp:88-95 uses SelfAdjointEigenSolver's first column).

    Closed form (trigonometric eigenvalues + null-space cross products):
    elementwise and fusable, where jnp.linalg.eigh on 8k matrices is a
    batched library call. Sign and the fully-degenerate case may differ from
    eigh; the consumer only uses |r . n|."""
    a = covs
    q = jnp.trace(a, axis1=-2, axis2=-1) / 3.0
    eye = jnp.eye(3, dtype=a.dtype)
    b = a - q[..., None, None] * eye
    p2 = jnp.sum(b * b, axis=(-2, -1)) / 6.0
    p = jnp.sqrt(jnp.maximum(p2, 1e-30))
    bn = b / p[..., None, None]
    det = (
        bn[..., 0, 0] * (bn[..., 1, 1] * bn[..., 2, 2] - bn[..., 1, 2] * bn[..., 2, 1])
        - bn[..., 0, 1] * (bn[..., 1, 0] * bn[..., 2, 2] - bn[..., 1, 2] * bn[..., 2, 0])
        + bn[..., 0, 2] * (bn[..., 1, 0] * bn[..., 2, 1] - bn[..., 1, 1] * bn[..., 2, 0])
    )
    r = jnp.clip(det / 2.0, -1.0, 1.0)
    phi = jnp.arccos(r) / 3.0
    lam_min = q + 2.0 * p * jnp.cos(phi + 2.0 * jnp.pi / 3.0)

    c = a - lam_min[..., None, None] * eye
    r0, r1, r2 = c[..., 0, :], c[..., 1, :], c[..., 2, :]
    cands = jnp.stack(
        [jnp.cross(r0, r1), jnp.cross(r0, r2), jnp.cross(r1, r2)], axis=-2
    )
    norms = jnp.linalg.norm(cands, axis=-1)
    best = jnp.argmax(norms, axis=-1)
    v = jnp.take_along_axis(cands, best[..., None, None], axis=-2)[..., 0, :]
    n = jnp.linalg.norm(v, axis=-1, keepdims=True)
    fallback = jnp.zeros_like(v).at[..., 2].set(1.0)
    return jnp.where(n > 1e-20, v / jnp.maximum(n, 1e-30), fallback)


def radar_point_cov(points, params: IcpParams):
    """Per-point range/azimuth/elevation covariance (reference: CalPointCov,
    registration.hpp:186-208). Quirk preserved: returns R @ S (no R^T)."""
    x, y, z = points[:, 0], points[:, 1], points[:, 2]
    dist = jnp.sqrt(x * x + y * y)
    d2r = jnp.pi / 180.0
    s_x = jnp.broadcast_to(params.range_variance_m, dist.shape)
    s_y = jnp.maximum(0.1, dist * jnp.sin(params.azimuth_variance_deg * d2r))
    s_z = jnp.maximum(0.1, dist * jnp.sin(params.elevation_variance_deg * d2r))
    ele = jnp.arctan2(z, dist)
    azi = jnp.arctan2(y, x)
    cy, sy_ = jnp.cos(azi), jnp.sin(azi)
    cp, sp = jnp.cos(ele), jnp.sin(ele)
    # R = Rz(azi) @ Ry(ele)
    zero = jnp.zeros_like(azi)
    R = jnp.stack(
        [
            jnp.stack([cy * cp, -sy_, cy * sp], -1),
            jnp.stack([sy_ * cp, cy, sy_ * sp], -1),
            jnp.stack([-sp, zero, cp], -1),
        ],
        axis=-2,
    )
    S = jnp.zeros(points.shape[:-1] + (3, 3), dtype=points.dtype)
    S = S.at[..., 0, 0].set(s_x).at[..., 1, 1].set(s_y).at[..., 2, 2].set(s_z)
    return jnp.einsum("kij,kjl->kil", R, S, precision=_HI)


# --------------------------------------------------------------------------- #
# One correspondence + align iteration per method
# --------------------------------------------------------------------------- #

def _p2p_tail(pose, src, target, valid, params):
    """Shared P2P solve step given correspondences (AlignCloudsLocal,
    registration.cpp:15-66).

    The Mahalanobis matrix is the identity here, so the generic
    ``_accumulate_gn`` blocks collapse analytically — skew(p)skew(p) =
    p p^T - |p|^2 I and skew(p) r = p x r — and no [K,3,3] tensor is ever
    materialized: every reduction runs over [K] / [K,3] planes."""
    dtype = src.dtype
    matched = jnp.sum(valid)
    inv_pose = lie.transform_inverse(pose)
    tgt_local = (
        jnp.einsum("ij,kj->ki", inv_pose[:3, :3], target, precision=_HI) + inv_pose[:3, 3]
    )
    r = tgt_local - src
    r2 = jnp.sum(r * r, axis=-1)
    th = params.max_search_dist
    w = th * th / (th + r2) ** 2
    wv = w * valid.astype(dtype)                       # [K]
    wp = wv[:, None] * src                             # [K,3]
    sw = jnp.sum(wv)
    swp = jnp.sum(wp, axis=0)                          # sum w p
    ppT = jnp.einsum("kp,kq->pq", wp, src, precision=_HI)  # sum w p p^T
    wp2 = jnp.trace(ppT)                               # sum w |p|^2
    eye = jnp.eye(3, dtype=dtype)
    S_swp = lie.skew(swp)
    # JTJ blocks for J = [I | -S], M = w I (cpp:36-48):
    #   tl =  sum w I          tr = -sum w S = -skew(sum w p)
    #   bl =  sum w S          br = -sum w S S = sum w (|p|^2 I - p p^T)
    JTJ = jnp.block([
        [sw * eye, -S_swp],
        [S_swp, wp2 * eye - ppT],
    ])
    JTr = jnp.concatenate([
        jnp.sum(wv[:, None] * r, axis=0),              # sum w r
        jnp.sum(jnp.cross(wp, r), axis=0),             # sum w p x r
    ])
    fit_num = jnp.sum(jnp.where(valid, jnp.sqrt(r2), 0.0))
    return matched, JTJ, JTr, fit_num


def _gicp_tail(pose, src, cov, cov_mean, valid, params, static, radar_cov):
    """Shared GICP solve step (AlignCloudsLocalPointCov, cpp:68-152).
    Residuals run against the neighborhood mean, not the matched point
    (cpp:97-101 reads target.covariance.mean)."""
    dtype = src.dtype
    rot_inv = pose[:3, :3].T
    matched = jnp.sum(valid)
    RCR = jnp.einsum("ij,kjl,ml->kim", rot_inv, cov, rot_inv, precision=_HI)
    if static.use_radar_cov:
        RCR = RCR + radar_cov
    maha = _inv3x3(RCR)
    inv_pose = lie.transform_inverse(pose)
    tgt_local = (
        jnp.einsum("ij,kj->ki", inv_pose[:3, :3], cov_mean, precision=_HI) + inv_pose[:3, 3]
    )
    r = tgt_local - src
    r2 = jnp.sum(r * r, axis=-1)
    th = params.max_search_dist
    w = th * th / (th + r2) ** 2 * 0.8 + 0.2
    JTJ, JTr, _ = _accumulate_gn(src, cov_mean, maha, w, valid.astype(dtype), pose)
    normal_local = jnp.einsum("ij,kj->ki", rot_inv, _smallest_eigvec(cov), precision=_HI)
    normal_local = normal_local / jnp.maximum(
        jnp.linalg.norm(normal_local, axis=-1, keepdims=True), 1e-30
    )
    fit_num = jnp.sum(
        jnp.where(valid, jnp.abs(jnp.sum(r * normal_local, axis=-1)), 0.0)
    )
    return matched, JTJ, JTr, fit_num


def _voxcov_tail(pose, src_flat, cov_flat, mean_flat, valid_flat, params,
                 static, radar_flat):
    """Shared VGICP/AVGICP solve step (AlignCloudsLocalVoxelCov,
    cpp:154-225) over flattened (point, voxel) pairs."""
    dtype = src_flat.dtype
    rot_inv = pose[:3, :3].T
    matched = jnp.sum(valid_flat)
    RCR = jnp.einsum("ij,kjl,ml->kim", rot_inv, cov_flat, rot_inv, precision=_HI)
    if static.use_radar_cov:
        RCR = RCR + radar_flat
    maha = _inv3x3(RCR)
    inv_pose = lie.transform_inverse(pose)
    tgt_local = (
        jnp.einsum("ij,kj->ki", inv_pose[:3, :3], mean_flat, precision=_HI) + inv_pose[:3, 3]
    )
    r = tgt_local - src_flat
    r2 = jnp.sum(r * r, axis=-1)
    th = params.max_search_dist
    w = th * th / (th + r2) ** 2
    keep = valid_flat & (w >= 0.01)  # weight cutoff (cpp:199-201)
    JTJ, JTr, _ = _accumulate_gn(
        src_flat, mean_flat, maha, w, keep.astype(dtype), pose
    )
    fit_num = jnp.sum(jnp.where(keep, jnp.sqrt(r2), 0.0))
    return matched, JTJ, JTr, fit_num


def _avg_voxcov_tail(pose, src, q_world, cov, mean, ok, params):
    """AVGICP solve step with the 7-voxel axis reduced BEFORE the GN
    accumulation (AlignCloudsLocalVoxelCov, cpp:154-225, fed with up to 7
    pairs per point — cpp:349).

    For a rotation R, ``(R^T C R)^-1 = R^T C^-1 R``, so each pair's weighted
    Mahalanobis matrix ``w_i (R^T C_i R)^-1`` and its residual product can be
    summed over the 7 candidate voxels in the WORLD frame first and
    conjugated into the sensor frame once per point:

        A_p = R^T (sum_i w_i C_i^-1) R
        b_p = R^T  sum_i w_i C_i^-1 (mu_i - q)

    These feed the same ``J = [I | -skew(p)]`` blocks as the flattened
    7x-pair form — identical math (residual norms are rotation-invariant, so
    the robust weights are unchanged; the identity needs no symmetry of C) —
    but with ~7x less conjugation/accumulation work and no 7x repeat of the
    source tensor. NOT valid with ``use_radar_cov``: the additive radar term
    inside the inverse breaks the conjugation identity, so that path keeps
    the flattened ``_voxcov_tail``.
    """
    matched = jnp.sum(ok)
    d = mean - q_world[:, None, :]                       # [K,7,3] world frame
    r2 = jnp.sum(d * d, axis=-1)                         # [K,7]
    th = params.max_search_dist
    w = th * th / (th + r2) ** 2
    keep = ok & (w >= 0.01)  # weight cutoff (cpp:199-201)
    wk = jnp.where(keep, w, 0.0)
    cinv = _inv3x3(cov)                                  # [K,7,3,3]
    P = jnp.einsum("ko,koij->kij", wk, cinv, precision=_HI)
    bw = jnp.einsum("ko,koij,koj->ki", wk, cinv, d, precision=_HI)
    rot = pose[:3, :3]
    A = jnp.einsum("ji,kjl,lm->kim", rot, P, rot, precision=_HI)   # R^T P R
    b = jnp.einsum("ji,kj->ki", rot, bw, precision=_HI)            # R^T bw
    S = lie.skew(src)                                    # [K,3,3]
    AS = jnp.einsum("kij,kjl->kil", A, S, precision=_HI)
    tl = jnp.sum(A, axis=0)
    tr = -jnp.sum(AS, axis=0)
    bl = jnp.einsum("kij,kjl->il", S, A, precision=_HI)
    br = -jnp.einsum("kij,kjl->il", S, AS, precision=_HI)
    jtr_top = jnp.sum(b, axis=0)
    jtr_bot = jnp.einsum("kij,kj->i", S, b, precision=_HI)
    JTJ = jnp.block([[tl, tr], [bl, br]])
    JTr = jnp.concatenate([jtr_top, jtr_bot])
    fit_num = jnp.sum(jnp.where(keep, jnp.sqrt(r2), 0.0))
    return matched, JTJ, JTr, fit_num


def _iteration(pose, src_local, src_valid, grid, params, static, radar_cov):
    """One RunRegister loop body (hash-grid backend): correspondence ->
    (matched, JTJ, JTr, fit_num) for the configured method."""
    src_global = lie.transform_points(pose, src_local)
    method = static.method

    if method == int(IcpMethod.P2P):
        target, valid, _, _ = mapgrid.query_nearest_point(
            grid, src_global, params.max_search_dist
        )
        valid = valid & src_valid
        return _p2p_tail(pose, src_local, target, valid, params)

    if method == int(IcpMethod.GICP):
        target, cov, cov_mean, valid = mapgrid.query_nearest_point_cov(
            grid, src_global, params.max_search_dist
        )
        valid = valid & src_valid
        return _gicp_tail(pose, src_local, cov, cov_mean, valid, params,
                          static, radar_cov)

    if method == int(IcpMethod.VGICP):
        cov, mean, valid = mapgrid.query_nearest_voxel_cov(
            grid, src_global, params.max_search_dist
        )
        valid = valid & src_valid
        return _voxcov_tail(pose, src_local, cov, mean, valid, params,
                            static, radar_cov)

    # AVGICP: up to 7 (point, voxel) pairs per point
    cov, mean, valid = mapgrid.query_all_voxel_cov(
        grid, src_global, params.max_search_dist
    )
    valid = valid & src_valid[:, None]
    if not static.use_radar_cov:
        return _avg_voxcov_tail(pose, src_local, src_global, cov, mean,
                                valid, params)
    n, k = valid.shape
    src_flat = jnp.repeat(src_local, k, axis=0)
    radar_flat = jnp.repeat(radar_cov, k, axis=0)
    return _voxcov_tail(
        pose, src_flat, cov.reshape(n * k, 3, 3), mean.reshape(n * k, 3),
        valid.reshape(n * k), params, static, radar_flat,
    )


def _fl(x):
    return x.reshape((-1,) + x.shape[2:])


def _search_slots(pose, sbuf, asg, tmap, params, static):
    """Correspondence search on the SLOT layout at ``pose`` — the expensive
    half of a RunRegister iteration (halo-row DMA + dense [QB, MH] distance
    + one-hot selection). Returns a method-specific flat match pytree that
    :func:`_tails_from_matches` turns into GN partials; the split exists so
    the while-loop can REUSE matches across iterations
    (PcmConfig.corr_refresh_dist_m) instead of re-searching every time like
    the reference (registration.cpp:310-347)."""
    budget = static.tile_budget
    method = static.method
    qbuf = (
        jnp.einsum("ij,sqj->sqi", pose[:3, :3], sbuf, precision=_HI)
        + pose[:3, 3]
    )
    qvox = jnp.floor(qbuf / tmap.voxel_size).astype(jnp.int32)

    if method == int(IcpMethod.P2P):
        tgt, ok = maptiles.nearest_point_slots(
            tmap, asg.slot_tile, qbuf, qvox, asg.qmask,
            params.max_search_dist, budget,
        )
        return {"tgt": _fl(tgt), "ok": _fl(ok)}

    if method == int(IcpMethod.GICP):
        _, ok, cov, cov_mean = maptiles.nearest_point_slots(
            tmap, asg.slot_tile, qbuf, qvox, asg.qmask,
            params.max_search_dist, budget, with_point_cov=True,
        )
        return {"cov": _fl(cov), "mean": _fl(cov_mean), "ok": _fl(ok)}

    if method == int(IcpMethod.VGICP):
        cov, mean, ok = maptiles.nearest_voxel_cov_slots(
            tmap, asg.slot_tile, qbuf, qvox, asg.qmask,
            params.max_search_dist, budget,
        )
        return {"cov": _fl(cov), "mean": _fl(mean), "ok": _fl(ok)}

    # AVGICP: up to 7 (point, voxel) pairs per slot row
    cov, mean, ok = maptiles.all_voxel_cov_slots(
        tmap, asg.slot_tile, qbuf, qvox, asg.qmask,
        params.max_search_dist, budget,
    )
    return {"cov": _fl(cov), "mean": _fl(mean), "ok": _fl(ok)}


def _tails_from_matches(pose, sbuf, matches, params, static, radar_sbuf):
    """The cheap half of a RunRegister iteration: GN partials over the
    flattened [S*QB] slot rows (masked) given already-found matches. The GN
    reduction is permutation-invariant, so no scatter back to query order is
    ever needed. Match targets/covs are fixed world(-window) geometry —
    evaluating them under a newer pose than the one they were searched at is
    the standard lazy-matching ICP approximation."""
    method = static.method
    src_flat = _fl(sbuf)
    radar_flat = None if radar_sbuf is None else _fl(radar_sbuf)

    if method == int(IcpMethod.P2P):
        return _p2p_tail(pose, src_flat, matches["tgt"], matches["ok"],
                         params)

    if method == int(IcpMethod.GICP):
        return _gicp_tail(pose, src_flat, matches["cov"], matches["mean"],
                          matches["ok"], params, static, radar_flat)

    if method == int(IcpMethod.VGICP):
        return _voxcov_tail(pose, src_flat, matches["cov"], matches["mean"],
                            matches["ok"], params, static, radar_flat)

    # AVGICP
    cov, mean, ok = matches["cov"], matches["mean"], matches["ok"]
    if not static.use_radar_cov:
        q_world = (
            jnp.einsum("ij,kj->ki", pose[:3, :3], src_flat, precision=_HI)
            + pose[:3, 3]
        )
        return _avg_voxcov_tail(pose, src_flat, q_world, cov, mean, ok,
                                params)
    k = 7
    src7 = jnp.repeat(src_flat, k, axis=0)
    radar7 = jnp.repeat(radar_flat, k, axis=0)
    return _voxcov_tail(
        pose, src7, cov.reshape(-1, 3, 3), mean.reshape(-1, 3),
        ok.reshape(-1), params, static, radar7,
    )


def _shard_slots(asg: maptiles.SlotAssignment, sbuf, radar_sbuf, axis: str,
                 chunk: int = 8):
    """Slice this device's slot range out of a (replicated) assignment."""
    n_dev = jax.lax.axis_size(axis)
    s_total = asg.slot_tile.shape[0]
    s_loc = s_total // n_dev
    assert s_loc * n_dev == s_total, (
        f"max_slots={s_total} must divide the {axis!r} mesh axis ({n_dev})"
    )
    assert s_loc % chunk == 0, (s_loc, chunk)
    lo = jax.lax.axis_index(axis) * s_loc
    sl = lambda x: jax.lax.dynamic_slice_in_dim(x, lo, s_loc, axis=0)
    asg_loc = maptiles.SlotAssignment(
        qbuf=sl(asg.qbuf), qvox=sl(asg.qvox), qmask=sl(asg.qmask),
        qidx=sl(asg.qidx), slot_tile=sl(asg.slot_tile), dropped=asg.dropped,
    )
    return asg_loc, sl(sbuf), None if radar_sbuf is None else sl(radar_sbuf)


# --------------------------------------------------------------------------- #
# RunRegister (cpp:273-418)
# --------------------------------------------------------------------------- #

def run_register(
    src_local,
    src_valid,
    grid: mapgrid.MapGrid,
    initial_guess,
    params: IcpParams,
    static: IcpStatic,
) -> IcpResult:
    """Register a sensor-frame scan against the map from an initial pose.

    Args:
      src_local: [N,3] scan points in the sensor frame (padded).
      src_valid: [N] validity mask for padding.
      grid: device map.
      initial_guess: [4,4] global sensor pose to start from.

    Returns IcpResult; on failure (empty map handled by caller, overlap or
    fitness gate) ``pose`` is the last composed pose like the reference.
    """
    dtype = src_local.dtype
    pose0 = jnp.asarray(initial_guess, dtype=dtype)
    total = jnp.sum(src_valid)
    # Point-sharded mode: inputs are split, so the overlap denominator needs
    # the global count. Slot-sharded mode: inputs are replicated — only the
    # per-iteration partials cross devices.
    if static.psum_axis is not None:
        total = jax.lax.psum(total, static.psum_axis)
    total = jnp.maximum(total, 1).astype(dtype)
    partial_axis = static.psum_axis or static.slot_shard_axis

    radar_cov = None
    if static.use_radar_cov:
        # Computed once from the initially-transformed cloud (cpp:302-305),
        # in WORLD coordinates (before any window-origin shift).
        radar_cov = radar_point_cov(
            lie.transform_points(pose0, src_local), params
        )

    # Active-window maps store window-LOCAL coordinates with a dynamic world
    # origin (map/tiles.crop_window): run the whole registration in the
    # window frame and shift the result back. Pure translation conjugation —
    # rotations, covariances and residuals are unaffected.
    origin = getattr(grid, "origin", None)
    if origin is not None:
        pose0 = pose0.at[:2, 3].add(-origin.astype(dtype))

    reassign_on = static.backend == "tile" and static.reassign_each_iter
    if reassign_on and static.corr_reuse:
        raise ValueError(
            "reassign_each_iter and corr_reuse are mutually exclusive: "
            "reused matches are indexed by a fixed slot assignment"
        )

    def _assign(p):
        """Tile-slot assignment + slot-packed source (and radar covs) at
        pose ``p``: sort + scatter over the query axis."""
        a = maptiles.assign_slots(
            grid, lie.transform_points(p, src_local), src_valid,
            static.tile_budget,
        )
        n = src_local.shape[0]
        safe_idx = jnp.minimum(a.qidx, n - 1)
        sb = jnp.where(a.qmask[..., None], src_local[safe_idx], 0.0)
        rb = None
        if static.use_radar_cov:
            # pack the (world-frame, pre-window-shift) per-point radar
            # covariances into the slot layout
            rb = jnp.where(a.qmask[..., None, None], radar_cov[safe_idx], 0.0)
        if static.slot_shard_axis is not None:
            a, sb, rb = _shard_slots(a, sb, rb, static.slot_shard_axis)
        return a, sb, rb

    if static.backend == "tile":
        # Hoist the tile-slot assignment out of the GN loop: sort + scatter
        # once, from the initial guess. The GN iterations then run entirely
        # on the SLOT layout (_search_slots/_tails_from_matches) — the
        # masked sums are permutation-invariant, so no scatter back to query
        # order is ever needed (no per-iteration scatter + [N]-row tails,
        # and it is what the slot-sharded multi-chip mode partitions). With
        # reassign_each_iter the loop body re-runs _assign from the current
        # pose instead and the dropped diagnostic is accumulated through the
        # carry.
        if reassign_on:
            asg = sbuf = radar_sbuf = None
            dropped = jnp.asarray(0, jnp.int32)
        else:
            asg, sbuf, radar_sbuf = _assign(pose0)
            dropped = asg.dropped.astype(jnp.int32)
    else:
        dropped = jnp.asarray(0, jnp.int32)

    reuse_on = static.backend == "tile" and static.corr_reuse
    if reuse_on:
        # Scan radius bound for the rotation term of the reuse ladder: a
        # step rotating by dtheta moves a point at range r by <= dtheta * r.
        # Computed from the FULL (pre-shard) inputs, not the slot-packed
        # buffer: under slot_shard_axis the sbuf slice is device-local and a
        # per-device src_r would diverge the while-loop trip counts of a
        # body that contains lax.psum (deadlock/corruption). src_local and
        # src_valid are replicated in that mode, so this bound is identical
        # on every device (and >= the packed max — dropped queries only make
        # the refresh ladder conservative, never stale).
        src_r = jnp.sqrt(jnp.max(jnp.where(
            src_valid, jnp.sum(src_local * src_local, axis=-1), 0.0)))
        # zero-valued match pytree shaped like a real search — the first
        # iteration always refreshes (moved starts at +inf), so these values
        # are never consumed
        matches0 = jax.tree_util.tree_map(
            lambda sd: jnp.zeros(sd.shape, sd.dtype),
            jax.eval_shape(
                lambda p: _search_slots(p, sbuf, asg, grid, params, static),
                pose0,
            ),
        )
    else:
        # scalar placeholders: the carry layout is shared, its cost is not
        matches0 = {"ok": jnp.zeros((), bool)}
        src_r = jnp.asarray(0.0, dtype)

    def cond(carry):
        return (carry[1] < static.max_iteration) & ~carry[2] & ~carry[3]

    def body(carry):
        (pose, it, done, failed, fitness, local_cov, overlap, matches,
         moved, dropped_c) = carry
        if reassign_on:
            # Exact reference search semantics (registration.cpp:310-347):
            # the voxel-cube candidates come from the CURRENT pose. The
            # hoisted assignment freezes each query's tile at the initial
            # guess; once GN steps move an edge query toward a neighboring
            # tile, cube voxels beyond the 1-voxel halo margin are silently
            # lost — invisible to the argmin methods but a systematic pair
            # loss for AVGICP, which sums all 7 face-adjacent covariances
            # (1.9-13.4 mm/registration at 0.3 m init error, vs ~1e-6 m
            # with per-iteration assignment).
            asg_i, sbuf_i, radar_i = _assign(pose)
            dropped_c = jnp.maximum(dropped_c, asg_i.dropped.astype(jnp.int32))
            matched, JTJ, JTr, fit_num = _tails_from_matches(
                pose, sbuf_i,
                _search_slots(pose, sbuf_i, asg_i, grid, params, static),
                params, static, radar_i,
            )
        elif reuse_on:
            # Correspondence reuse (PcmConfig.corr_refresh_dist_m): re-search
            # only when the pose has moved more than the bound since the last
            # search.
            refresh = moved >= params.corr_refresh_dist
            matches = jax.lax.cond(
                refresh,
                lambda: _search_slots(pose, sbuf, asg, grid, params, static),
                lambda: matches,
            )
            moved = jnp.where(refresh, 0.0, moved)
            matched, JTJ, JTr, fit_num = _tails_from_matches(
                pose, sbuf, matches, params, static, radar_sbuf
            )
        elif static.backend == "tile":
            # reference behavior: search every iteration (cpp:310-347), one
            # straight-line search+solve dataflow with no cond/carry
            matched, JTJ, JTr, fit_num = _tails_from_matches(
                pose, sbuf,
                _search_slots(pose, sbuf, asg, grid, params, static),
                params, static, radar_sbuf,
            )
        else:
            matched, JTJ, JTr, fit_num = _iteration(
                pose, src_local, src_valid, grid, params, static, radar_cov
            )
        if partial_axis is not None:
            matched = jax.lax.psum(matched, partial_axis)
            JTJ = jax.lax.psum(JTJ, partial_axis)
            JTr = jax.lax.psum(JTr, partial_axis)
            fit_num = jax.lax.psum(fit_num, partial_axis)
        fit = fit_num / jnp.maximum(matched, 1).astype(dtype)
        ratio = matched.astype(dtype) / total
        overlap_ok = ratio >= params.min_overlap_ratio

        x, reg = _solve_step(JTJ, JTr, params.lm_lambda)
        x = jnp.where(overlap_ok, x, jnp.zeros_like(x))
        step_tf = _step_transform(x)
        # lie.compose, NOT `@`: at default GPU matmul precision (TF32) a
        # centimeter step rounds back into the unchanged pose.
        pose_new = jnp.where(overlap_ok, lie.compose(pose, step_tf), pose)

        rot_norm = jnp.linalg.norm(lie.so3_log(step_tf[:3, :3]))
        transform_norm = rot_norm + jnp.linalg.norm(x[0:3])
        step_small = overlap_ok & (transform_norm < params.termination_threshold)
        if reuse_on:
            # Termination must be CONFIRMED on fresh matches: on a fixed
            # correspondence set the damped GN/IRLS solve converges in 1-2
            # steps, so a small step on STALE matches only means the stale
            # set's optimum was reached — force a re-search next iteration
            # and terminate only when a fresh search also yields a small
            # step (the exact reference condition, cpp:380-391).
            terminated = step_small & refresh
            # accumulated worst-case point motion since the last search
            # (zero when the step was gated off — x is zeroed above)
            moved = moved + jnp.linalg.norm(x[0:3]) + rot_norm * src_r
            moved = jnp.where(step_small & ~refresh, jnp.inf, moved)
        else:
            terminated = step_small

        fitness_new = jnp.where(overlap_ok, fit, fitness)
        if static.method == int(IcpMethod.GICP):
            # Only the GICP solver exports (JTJ + lambda diag)^-1 (cpp:140-142).
            local_cov_new = jnp.where(overlap_ok, jnp.linalg.inv(reg), local_cov)
        else:
            local_cov_new = local_cov
        return (
            pose_new,
            it + 1,
            terminated,
            ~overlap_ok,
            fitness_new,
            local_cov_new,
            ratio,
            matches,
            moved,
            dropped_c,
        )

    carry0 = (
        pose0,
        jnp.asarray(0, jnp.int32),
        jnp.asarray(False),
        jnp.asarray(False),
        jnp.asarray(0.0, dtype),
        jnp.eye(6, dtype=dtype),
        jnp.asarray(0.0, dtype),
        matches0,
        jnp.asarray(jnp.inf, dtype),  # force a search on iteration 0
        dropped,
    )
    final = jax.lax.while_loop(cond, body, carry0)
    pose, it, done, failed, fitness, local_cov, overlap = final[:7]
    dropped = final[9]
    if origin is not None:
        pose = pose.at[:2, 3].add(origin.astype(dtype))
    success = ~failed & (fitness <= params.max_fitness_score)
    return IcpResult(
        pose=pose,
        success=success,
        fitness=fitness,
        local_cov=local_cov,
        iterations=it,
        overlap=overlap,
        dropped=dropped,
    )


# --------------------------------------------------------------------------- #
# Misc utilities mirrored for API parity
# --------------------------------------------------------------------------- #

def align_clouds_global(src_global, tgt_global, valid, params: IcpParams):
    """One global-frame P2P Gauss-Newton step -> [4,4] correction transform
    (reference: AlignCloudsGlobal, registration.cpp:227-271 — dead code
    there, mirrored for API completeness). Differences from the local
    solver: J = [I | -skew(p_GLOBAL)], residuals in the global frame, and
    the returned transform is a global left-correction, not a pose update.
    """
    dtype = src_global.dtype
    r = tgt_global - src_global                                    # [K,3]
    r2 = jnp.sum(r * r, axis=-1)
    th = params.max_search_dist
    w = th * th / (th + r2) ** 2                                   # cpp:246
    w = jnp.where(valid & jnp.isfinite(w), w, 0.0)
    S = lie.skew(src_global)                                       # [K,3,3]
    # JTJ blocks for J = [I | -S]: [[sum w, -sum w S], [sum w S^T? ...]]
    # expanded analytically like _accumulate_gn with M = w*I
    wS = w[:, None, None] * S
    tl = jnp.sum(w) * jnp.eye(3, dtype=dtype)
    tr = -jnp.sum(wS, axis=0)
    bl = tr.T                                                      # S^T = -S
    br = -jnp.einsum("kij,kjl->il", S, wS, precision=_HI)
    JTJ = jnp.block([[tl, tr], [bl, br]])
    wr = w[:, None] * r
    JTr = jnp.concatenate([
        jnp.sum(wr, axis=0),
        jnp.einsum("kij,kj->i", S, wr, precision=_HI),
    ])
    x, _ = _solve_step(JTJ, JTr, params.lm_lambda)
    return _step_transform(x)


def calculate_velocity(transform, dt):
    """Rigid transform over dt -> (linear, angular) velocity (reference:
    CalculateVelocity, registration.hpp:167-184)."""
    linear = transform[:3, 3] / dt
    angular = lie.so3_log(transform[:3, :3]) / dt
    return linear, angular


def separate_points_z(points, valid, z):
    """Split a masked point set by z (reference: SeperatePointsZ,
    registration.hpp:150-165). Returns (up_mask, down_mask)."""
    up = valid & (points[:, 2] > z)
    down = valid & ~(points[:, 2] > z)
    return up, down
