"""Device-resident voxel grid: open-addressing lookup + vectorized queries.

Static-shape replacement for the reference's pointer-chasing voxel hash map
(reference: src/app/localization/pcm_matching/include/voxel_hash_map.hpp and
src/voxel_hash_map.cpp). The three correspondence kernels — nearest point in
the 27-voxel neighborhood (cpp:31-88), nearest voxel covariance (cpp:90-151),
and all 7 face-adjacent voxel covariances (cpp:153-206) — become masked
gathers over packed HBM tensors: every source point probes its neighbor voxels
through a linear-probing hash table whose worst-case probe length is known at
build time, so the probe loop is a short unrolled sequence of gathers and the
whole query is one fused XLA computation (no per-point control flow).

Invalid/padding slots hold +inf coordinates so distance argmins ignore them
without branches; a sentinel voxel row (index V) absorbs failed lookups.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from .. import pytree

from .builder import BuiltMap

_SENTINEL_COORD = np.int32(2**30)

# 3x3x3 neighborhood (reference: GetAdjacentVoxels range==2, cpp:232-241)
OFFSETS_27 = np.array(
    [[i, j, k] for i in (-1, 0, 1) for j in (-1, 0, 1) for k in (-1, 0, 1)],
    dtype=np.int32,
)
# Center + 6 face-adjacent (reference: GetAdjacentVoxels range==1, cpp:223-231)
OFFSETS_7 = np.array(
    [[0, 0, 0], [1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]],
    dtype=np.int32,
)


@pytree.dataclass
class MapGrid:
    """Packed map tensors. Row V (the last) of every voxel-indexed array is a
    sentinel: coords that never match, counts 0, +inf geometry."""

    table: jnp.ndarray            # [T+P] int32: voxel row or -1 (P-extended
                                  #   with the wrapped head so probe windows
                                  #   never wrap)
    table_fp: jnp.ndarray         # [T+P] uint32 coordinate fingerprint
    vox_coords: jnp.ndarray       # [V+1,3] int32
    points: jnp.ndarray           # [V+1,M,3] f32, padded +inf
    counts: jnp.ndarray           # [V+1] int32
    vox_mean: jnp.ndarray         # [V+1,3] f32, sentinel +inf
    vox_cov: jnp.ndarray          # [V+1,3,3] f32
    point_cov: Optional[jnp.ndarray]       # [V+1,M,3,3] f32 or None (GICP only)
    point_cov_mean: Optional[jnp.ndarray]  # [V+1,M,3] f32 or None

    voxel_size: float = pytree.field(pytree_node=False)
    table_size: int = pytree.field(pytree_node=False)
    max_probe: int = pytree.field(pytree_node=False)

    @property
    def num_voxels(self) -> int:
        return self.vox_coords.shape[0] - 1

    @property
    def sentinel(self) -> int:
        return self.vox_coords.shape[0] - 1


def to_device(built: BuiltMap, dtype=jnp.float32) -> MapGrid:
    """BuiltMap (host NumPy) -> MapGrid (device, with sentinel row appended)."""
    v = built.num_voxels
    m = built.max_points_per_voxel

    vox_coords = np.concatenate(
        [built.vox_coords, np.full((1, 3), _SENTINEL_COORD, np.int32)], axis=0
    )
    points = np.concatenate(
        [built.points, np.full((1, m, 3), np.inf, np.float32)], axis=0
    )
    counts = np.concatenate([built.counts, np.zeros(1, np.int32)])
    vox_mean = np.concatenate(
        [built.vox_mean, np.full((1, 3), np.inf, np.float32)], axis=0
    )
    vox_cov = np.concatenate(
        [built.vox_cov, np.eye(3, dtype=np.float32)[None]], axis=0
    )
    point_cov = point_cov_mean = None
    if built.point_cov is not None:
        point_cov = jnp.asarray(
            np.concatenate(
                [built.point_cov, np.tile(np.eye(3, dtype=np.float32), (1, m, 1, 1))],
                axis=0,
            ),
            dtype=dtype,
        )
        point_cov_mean = jnp.asarray(
            np.concatenate(
                [built.point_cov_mean, np.full((1, m, 3), np.inf, np.float32)], axis=0
            ),
            dtype=dtype,
        )
    p = built.max_probe
    return MapGrid(
        table=jnp.asarray(np.concatenate([built.table, built.table[:p]])),
        table_fp=jnp.asarray(np.concatenate([built.table_fp, built.table_fp[:p]])),
        vox_coords=jnp.asarray(vox_coords),
        points=jnp.asarray(points, dtype=dtype),
        counts=jnp.asarray(counts),
        vox_mean=jnp.asarray(vox_mean, dtype=dtype),
        vox_cov=jnp.asarray(vox_cov, dtype=dtype),
        point_cov=point_cov,
        point_cov_mean=point_cov_mean,
        voxel_size=float(built.voxel_size),
        table_size=int(built.table_size),
        max_probe=int(built.max_probe),
    )


def point_to_voxel(points, voxel_size):
    """floor(p / voxel) (reference: PointToVoxel, hpp:176-180)."""
    return jnp.floor(points / voxel_size).astype(jnp.int32)


def _mix(coords, seed=0x9E3779B1):
    """Chained uint32 mix + fmix32 — identical to builder._mix_coords."""
    c = coords.astype(jnp.uint32)
    u = jnp.uint32
    h = u(seed) ^ (c[..., 0] * u(0x85EBCA6B))
    h = (h ^ (h >> u(13))) * u(0xC2B2AE35)
    h = h ^ (c[..., 1] * u(0x27D4EB2F))
    h = (h ^ (h >> u(13))) * u(0x165667B1)
    h = h ^ (c[..., 2] * u(0x9E3779B1))
    h = h ^ (h >> u(16))
    h = h * u(0x7FEB352D)
    h = h ^ (h >> u(15))
    h = h * u(0x846CA68B)
    h = h ^ (h >> u(16))
    return h


def _hash(coords, table_size):
    return (_mix(coords) & jnp.uint32(table_size - 1)).astype(jnp.int32)


def _fingerprint(coords):
    fp = _mix(coords, seed=0x51ED270B)
    return jnp.where(fp == jnp.uint32(0), jnp.uint32(1), fp)


def lookup(grid: MapGrid, coords) -> jnp.ndarray:
    """Voxel coords [...,3] -> voxel row index; misses map to the sentinel row.

    One windowed gather of the whole probe chain (the table is extended by
    max_probe entries so windows never wrap), then a branch-free resolve:
    a slot hits when its 32-bit coordinate fingerprint matches and no empty
    slot precedes it in the chain (std::unordered_map find semantics). The
    fingerprint replaces the reference-style full-coordinate verify (one
    gather per probe instead of a 3-element row gather); the
    residual false-hit probability is ~max_probe * 2^-32 per query.
    """
    sent = grid.sentinel
    p = grid.max_probe
    h = _hash(coords, grid.table_size)
    fp = _fingerprint(coords)
    # Window gathers: [..., P] contiguous slots in two sliced gathers.
    idx = h[..., None] + jnp.arange(p, dtype=jnp.int32)
    rows = grid.table[idx]
    fps = grid.table_fp[idx]
    empty = rows < 0
    empty_before = jnp.cumsum(empty, axis=-1) - empty.astype(jnp.int32) > 0
    hit = (fps == fp[..., None]) & ~empty & ~empty_before
    any_hit = jnp.any(hit, axis=-1)
    first = jnp.argmax(hit, axis=-1)
    row = jnp.take_along_axis(rows, first[..., None], axis=-1)[..., 0]
    return jnp.where(any_hit, row, sent)


def query_nearest_point(grid: MapGrid, queries, max_dist) -> Tuple[jnp.ndarray, ...]:
    """Nearest map point within the 27-voxel neighborhood of each query.

    Reference semantics: GetCorrespondencePoints (cpp:31-88) — scan every
    point of every existing voxel in the 3x3x3 neighborhood, keep the closest,
    gate on max_dist. Returns (target [N,3], valid [N], rows [N], slots [N])
    where (row, slot) address the winning point for follow-up gathers (GICP).
    """
    n = queries.shape[0]
    c = point_to_voxel(queries, grid.voxel_size)
    nb = c[:, None, :] + jnp.asarray(OFFSETS_27)[None, :, :]      # [N,27,3]
    rows = lookup(grid, nb)                                        # [N,27]
    cand = grid.points[rows]                                       # [N,27,M,3]
    diff = cand - queries[:, None, None, :]
    d2 = jnp.sum(diff * diff, axis=-1)                             # [N,27,M]
    d2_flat = d2.reshape(n, -1)
    best = jnp.argmin(d2_flat, axis=1)
    best_d2 = jnp.take_along_axis(d2_flat, best[:, None], axis=1)[:, 0]
    m = grid.points.shape[1]
    best_vox = best // m
    best_slot = best % m
    best_row = jnp.take_along_axis(rows, best_vox[:, None], axis=1)[:, 0]
    target = grid.points[best_row, best_slot]
    valid = best_d2 < max_dist * max_dist
    target = jnp.where(valid[:, None], target, queries)  # sanitize padding infs
    return target, valid, best_row, best_slot


def query_nearest_point_cov(grid: MapGrid, queries, max_dist):
    """GICP correspondence: nearest point (as above) + that point's
    precomputed neighborhood covariance and mean (reference: the GICP branch
    feeds GetCorrespondencePoints output into AlignCloudsLocalPointCov, which
    reads target.covariance.{cov,mean}, registration.cpp:89-101)."""
    target, valid, row, slot = query_nearest_point(grid, queries, max_dist)
    if grid.point_cov is None:
        raise ValueError(
            "MapGrid was built without per-point covariances; "
            "build with compute_point_cov=True for GICP"
        )
    cov = grid.point_cov[row, slot]
    mean = grid.point_cov_mean[row, slot]
    eye = jnp.broadcast_to(jnp.eye(3, dtype=cov.dtype), cov.shape)
    cov = jnp.where(valid[:, None, None], cov, eye)
    mean = jnp.where(valid[:, None], mean, queries)
    return target, cov, mean, valid


def query_nearest_voxel_cov(grid: MapGrid, queries, max_dist):
    """VGICP correspondence: the covariance of the neighborhood voxel whose
    mean is closest to the query (reference: GetCorrespondencesCov,
    cpp:90-151). Returns (cov [N,3,3], mean [N,3], valid [N])."""
    c = point_to_voxel(queries, grid.voxel_size)
    nb = c[:, None, :] + jnp.asarray(OFFSETS_27)[None, :, :]
    rows = lookup(grid, nb)                                        # [N,27]
    means = grid.vox_mean[rows]                                    # [N,27,3]
    occupied = grid.counts[rows] > 0
    diff = means - queries[:, None, :]
    d2 = jnp.where(occupied, jnp.sum(diff * diff, axis=-1), jnp.inf)
    best = jnp.argmin(d2, axis=1)
    best_d2 = jnp.take_along_axis(d2, best[:, None], axis=1)[:, 0]
    best_row = jnp.take_along_axis(rows, best[:, None], axis=1)[:, 0]
    valid = best_d2 < max_dist * max_dist
    cov = grid.vox_cov[best_row]
    mean = grid.vox_mean[best_row]
    eye = jnp.broadcast_to(jnp.eye(3, dtype=cov.dtype), cov.shape)
    cov = jnp.where(valid[:, None, None], cov, eye)
    mean = jnp.where(valid[:, None], mean, queries)
    return cov, mean, valid


def query_all_voxel_cov(grid: MapGrid, queries, max_dist):
    """AVGICP correspondence: every occupied voxel among the 7 face-adjacent
    ones within max_dist contributes (reference: GetCorrespondencesAllCov,
    cpp:153-206 — note range==1 -> 7 voxels, not the 27 the README claims).
    Returns (cov [N,7,3,3], mean [N,7,3], valid [N,7])."""
    c = point_to_voxel(queries, grid.voxel_size)
    nb = c[:, None, :] + jnp.asarray(OFFSETS_7)[None, :, :]
    rows = lookup(grid, nb)                                        # [N,7]
    means = grid.vox_mean[rows]
    occupied = grid.counts[rows] > 0
    diff = means - queries[:, None, :]
    d2 = jnp.sum(diff * diff, axis=-1)
    valid = occupied & (d2 < max_dist * max_dist)
    cov = grid.vox_cov[rows]
    eye = jnp.broadcast_to(jnp.eye(3, dtype=cov.dtype), cov.shape)
    cov = jnp.where(valid[:, :, None, None], cov, eye)
    mean = jnp.where(valid[:, :, None], means, queries[:, None, :])
    return cov, mean, valid


def voxel_downsample(points, valid, voxel_size, out_size: int):
    """Keep the first valid point per voxel, static output budget.

    Device equivalent of VoxelDownsample (hpp:260-283): "first" follows input
    order, exactly like the reference's insert-if-absent. Returns
    (points [out_size,3], valid [out_size], kept_count).

    The voxel key is a *mixed* (hashed) packing so (a) one stable sort
    replaces a 4-key lexsort, and (b) when
    the number of occupied voxels exceeds ``out_size`` the dropped voxels are
    spatially unbiased — a coordinate-ordered sort would cut off one side of
    the cloud, which measurably biases downstream ICP."""
    n = points.shape[0]
    keys = point_to_voxel(points, voxel_size)
    # 32-bit mixed key (uint64 needs x64 mode): rare hash collisions are
    # resolved by comparing the sorted neighbors' actual coords, so at worst
    # an interleaved collision keeps one extra point for a voxel. 0xFFFFFFFF
    # is RESERVED for invalid rows (a valid point hashing there would sort
    # among the pads, whose garbage coords could swallow its first-per-voxel
    # slot); clamping to 0xFFFFFFFE merely adds one more benign collision.
    key = jnp.where(
        valid,
        jnp.minimum(_mix(keys), jnp.uint32(0xFFFFFFFE)),
        jnp.uint32(0xFFFFFFFF),
    )
    # Multi-operand sort: carrying the payload lanes THROUGH the sort
    # (XLA sorts tuples natively) replaces argsort + 7 permutation gathers.
    # Stable + same key => bitwise-identical to argsort(stable) + gathers.
    (_, cx, cy, cz, sv, px, py, pz) = jax.lax.sort(
        (key, keys[:, 0], keys[:, 1], keys[:, 2], valid,
         points[:, 0], points[:, 1], points[:, 2]),
        num_keys=1, is_stable=True,
    )
    sc = jnp.stack([cx, cy, cz], axis=-1)
    sp = jnp.stack([px, py, pz], axis=-1)
    first = jnp.ones(n, dtype=bool).at[1:].set(
        jnp.any(sc[1:] != sc[:-1], axis=-1)
    )
    keep = first & sv
    rank = jnp.cumsum(keep) - 1
    dst = jnp.where(keep, rank, out_size)  # out-of-range rows are dropped
    out_pts = jnp.zeros((out_size, 3), dtype=points.dtype)
    out_pts = out_pts.at[dst].set(sp, mode="drop")
    kept = jnp.sum(keep)
    out_valid = jnp.arange(out_size) < kept
    return out_pts, out_valid, jnp.minimum(kept, out_size)


def find_ground_height(grid: MapGrid, position_xy, search_range=5.0, k: int = 5):
    """Mean z of the k lowest map points within search_range (XY) — device
    version of FindGroundHeight (hpp:285-322). Returns (found, ground_z)."""
    pts = grid.points[:-1].reshape(-1, 3)  # exclude sentinel row
    finite = jnp.isfinite(pts[:, 0])
    d2 = jnp.sum((pts[:, :2] - jnp.asarray(position_xy)) ** 2, axis=1)
    within = finite & (d2 <= search_range * search_range)
    neg_z = jnp.where(within, -pts[:, 2], -jnp.inf)
    top_z, _ = jax.lax.top_k(neg_z, k)
    found = jnp.sum(within) > 3
    ground_z = -jnp.mean(top_z)
    return found, ground_z
