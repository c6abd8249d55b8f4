"""Host-side voxel-hash map builder -> packed device tensors.

The reference builds an ``unordered_map<Vector3i, VoxelBlock>`` on the CPU at
node startup (reference: src/app/localization/pcm_matching/src/
voxel_hash_map.cpp:270-285 AddPoints; include/voxel_hash_map.hpp:94-148
VoxelBlock/CalVoxelCov, 195-257 per-point GICP covariance). A pointer-chasing
hash map cannot live in a static-shape device program, so the builder
produces a *packed* static-shape representation instead (SURVEY.md §7 step
3):

  * ``vox_coords [V,3] int32`` — integer voxel coordinates, one row per
    occupied voxel;
  * ``points [V,M,3]`` + ``counts [V]`` — up to M=max_points_per_voxel points
    per voxel, inserted with the reference's min-spacing rule;
  * ``vox_mean [V,3]`` / ``vox_cov [V,3,3]`` — per-voxel SVD-regularized
    covariance (VGICP/AVGICP);
  * ``point_cov [V,M,3,3]`` / ``point_cov_mean [V,M,3]`` — per-point GICP
    covariance over the 27-voxel neighborhood;
  * an open-addressing hash ``table [T]`` (linear probing) mapping a voxel
    coordinate to its row, with a build-time-known worst-case probe length so
    the device lookup is a short unrolled loop.

Build is one-time per map (the reference takes minutes on big maps for the
same precompute); a C++ native fast path is provided in native/ with this
NumPy implementation as the always-available fallback.

Divergence from the reference, on purpose: insertion buckets points with
``floor(p / voxel)`` for negative coordinates, where the reference truncates
toward zero on insert (voxel_hash_map.cpp:275) but floors on query
(voxel_hash_map.hpp:176-180). The floor/floor pairing is self-consistent; the
27-voxel probe makes the observable difference negligible away from the origin.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

# Same 3-prime mix as the reference (voxel_hash_map.hpp:150-155), minus the
# 20-bit mask: the table is sized per map instead.
_P1, _P2, _P3 = 73856093, 19349669, 83492791


def _mix_coords(coords: np.ndarray, seed: int = 0x9E3779B1) -> np.ndarray:
    """Sequentially-chained multiplicative mix + murmur3 fmix32 avalanche, in
    wrapping uint32 arithmetic identical to the device side (grid._mix).

    Note: the reference's 3-prime XOR-of-products hash (voxel_hash_map.hpp:
    150-155) loses entropy on grid-structured coordinates (XOR of correlated
    products collides for ~40% of coords in a city-sized block) — acceptable
    for std::unordered_map buckets, fatal for our fingerprint verify. The
    chained mix below is collision-free on such blocks."""
    c = coords.astype(np.int64).astype(np.uint32)
    with np.errstate(over="ignore"):
        h = np.uint32(seed) ^ (c[..., 0] * np.uint32(0x85EBCA6B))
        h = (h ^ (h >> np.uint32(13))) * np.uint32(0xC2B2AE35)
        h = h ^ (c[..., 1] * np.uint32(0x27D4EB2F))
        h = (h ^ (h >> np.uint32(13))) * np.uint32(0x165667B1)
        h = h ^ (c[..., 2] * np.uint32(0x9E3779B1))
        h ^= h >> np.uint32(16)
        h *= np.uint32(0x7FEB352D)
        h ^= h >> np.uint32(15)
        h *= np.uint32(0x846CA68B)
        h ^= h >> np.uint32(16)
    return h


def hash_coords(coords: np.ndarray, table_size: int) -> np.ndarray:
    """Voxel-coordinate hash -> slot in [0, table_size); power-of-two table."""
    return (_mix_coords(coords) & np.uint32(table_size - 1)).astype(np.int64)


def fingerprint_coords(coords: np.ndarray) -> np.ndarray:
    """Secondary 32-bit fingerprint used to verify probe hits without
    gathering the full 3-int coordinate row (one 32-bit compare per probe
    instead of three). Independent seed from the slot hash;
    never 0, so 0 marks empty slots."""
    fp = _mix_coords(coords, seed=0x51ED270B)
    return np.where(fp == 0, np.uint32(1), fp)


@dataclasses.dataclass
class BuiltMap:
    """Raw NumPy arrays produced by the builder; see MapGrid for the device view."""

    voxel_size: float
    max_points_per_voxel: int
    vox_coords: np.ndarray        # [V,3] int32
    points: np.ndarray            # [V,M,3] f32 (padded with +inf)
    counts: np.ndarray            # [V] int32
    vox_mean: np.ndarray          # [V,3] f32
    vox_cov: np.ndarray           # [V,3,3] f32
    table: np.ndarray             # [T] int32, voxel row or -1
    table_fp: np.ndarray          # [T] uint32 coordinate fingerprint (0=empty)
    table_size: int
    max_probe: int                # worst-case linear-probe length (>=1)
    point_cov: Optional[np.ndarray] = None       # [V,M,3,3] f32
    point_cov_mean: Optional[np.ndarray] = None  # [V,M,3] f32

    @property
    def num_voxels(self) -> int:
        return int(self.vox_coords.shape[0])

    def all_points(self) -> np.ndarray:
        """Flattened valid map points (reference: Pointcloud(), cpp:245-255)."""
        m = self.points.shape[1]
        mask = np.arange(m)[None, :] < self.counts[:, None]
        return self.points[mask]


def _plane_regularized_cov(pts: np.ndarray):
    """Mean + SVD-regularized covariance with eigenvalues (1, 1, 1e-3)
    (reference: CalVoxelCov, voxel_hash_map.hpp:114-148)."""
    n = pts.shape[0]
    if n == 0:
        return np.zeros(3), np.eye(3)
    if n == 1:
        return pts[0].astype(np.float64), np.eye(3)
    mean = pts.mean(axis=0)
    centered = (pts - mean).T  # 3 x n
    cov = centered @ centered.T / (n - 1)
    u, _, vt = np.linalg.svd(cov)
    cov = u @ np.diag([1.0, 1.0, 1e-3]) @ vt
    return mean, cov


def _plane_regularize_batch(covs: np.ndarray) -> np.ndarray:
    """Batched plane regularization: U diag(1,1,1e-3) V^T per matrix
    (reference: CalVoxelCov, voxel_hash_map.hpp:114-148).

    An eigh-based identity form (I - (1-1e-3) q3q3^T) is ~1.4x faster but
    picks a DIFFERENT arbitrary basis than LAPACK's SVD on degenerate
    covariances (zero / rank-1 — e.g. <2 neighbors), and the reference's
    Eigen SVD convention there is observable through GICP weights — so the
    SVD form is kept for parity (measured: the eigh variant flips ~20% of
    degenerate point covs to diag(1e-3,1,1) vs the SVD's diag(1,1,1e-3))."""
    if covs.shape[0] == 0:
        return covs
    u, _, vt = np.linalg.svd(covs)
    return np.einsum(
        "nij,j,njk->nik", u, np.array([1.0, 1.0, 1e-3]), vt
    )


def build_voxel_map(
    points: np.ndarray,
    voxel_size: float,
    max_points_per_voxel: int = 30,
    *,
    compute_voxel_cov: bool = False,
    compute_point_cov: bool = False,
    gicp_cov_search_dist: float = 0.4,
    table_load_factor: float = 0.25,
    probe_limit: int = 16,
    use_native: bool = True,
) -> BuiltMap:
    """Build the packed voxel map from an [N,3] point array.

    Mirrors AddPoints' min-spacing insertion (voxel_hash_map.cpp:270-285),
    CalVoxelCovAll (hpp:183-193) and CalPointCovAll (hpp:195-257).
    """
    points = np.ascontiguousarray(points, dtype=np.float64)
    if points.ndim != 2 or points.shape[1] != 3:
        raise ValueError(f"points must be [N,3], got {points.shape}")

    native = None
    if use_native:
        from . import native_builder

        native = native_builder.maybe_load()

    # Covariances are computed from the float32-rounded points that are
    # actually stored on device, so the build output is self-consistent (the
    # SVD plane regularization is eigenvector-sensitive for degenerate voxels;
    # mixing precisions would make stored cov inconsistent with stored points).
    if native is not None:
        # The native finish pass rounds the block, pads with inf, and
        # accumulates mean + raw cov per voxel while it is hot in cache —
        # this skips four full-block NumPy passes (~3x build wall-clock).
        vox_coords, padded_block, counts, vox_mean, raw = native.build_map(
            points, voxel_size, max_points_per_voxel
        )
        v = vox_coords.shape[0]
        m = max_points_per_voxel
        vox_cov = np.tile(np.eye(3), (v, 1, 1))
        if compute_voxel_cov:
            multi = counts > 1
            vox_cov[multi] = _plane_regularize_batch(raw[multi])
    else:
        vox_coords, pts_block, counts = _insert_points_numpy(
            points, voxel_size, max_points_per_voxel
        )
        v = vox_coords.shape[0]
        m = max_points_per_voxel
        pts_block = pts_block.astype(np.float32).astype(np.float64)

        # --- Per-voxel covariance (VGICP/AVGICP precompute), vectorized ---
        slot_mask = np.arange(m)[None, :] < counts[:, None]
        safe_cnt = np.maximum(counts, 1)
        masked = np.where(slot_mask[:, :, None], pts_block, 0.0)
        vox_mean = masked.sum(axis=1) / safe_cnt[:, None]
        vox_cov = np.tile(np.eye(3), (v, 1, 1))
        if compute_voxel_cov:
            centered = np.where(
                slot_mask[:, :, None], pts_block - vox_mean[:, None, :], 0.0
            )
            raw = np.einsum("vmi,vmj->vij", centered, centered) / np.maximum(
                counts - 1, 1
            )[:, None, None]
            multi = counts > 1
            vox_cov[multi] = _plane_regularize_batch(raw[multi])
        padded_block = _pad_inf(pts_block, counts)

    # --- Hash table with bounded probe length ---
    table, table_fp, table_size, max_probe = _build_table(
        vox_coords, table_load_factor, probe_limit
    )

    built = BuiltMap(
        voxel_size=float(voxel_size),
        max_points_per_voxel=m,
        vox_coords=vox_coords.astype(np.int32),
        points=padded_block.astype(np.float32),
        counts=counts.astype(np.int32),
        vox_mean=vox_mean.astype(np.float32),
        vox_cov=vox_cov.astype(np.float32),
        table=table,
        table_fp=table_fp,
        table_size=table_size,
        max_probe=max_probe,
    )

    # --- Per-point GICP covariance (hpp:195-257) ---
    if compute_point_cov:
        built.point_cov, built.point_cov_mean = _point_cov_all(
            built, gicp_cov_search_dist
        )
    return built


def _pack_keys(keys: np.ndarray) -> np.ndarray:
    """[N,3] int voxel coords -> unique int64 key (21 bits/axis, offset)."""
    k = keys.astype(np.int64) + (1 << 20)
    if (k < 0).any() or (k >= (1 << 21)).any():
        raise ValueError("voxel coordinates exceed +-2^20")
    return (k[:, 0] << 42) | (k[:, 1] << 21) | k[:, 2]


def _insert_points_numpy(points, voxel_size, max_pts):
    """Insertion with the reference's min-spacing rule (cpp:270-285):
    a point enters a voxel only if the voxel has < max_pts points and no
    existing point lies within sqrt(voxel^2 / max_pts)."""
    map_resolution = np.sqrt(voxel_size * voxel_size / max_pts)
    res2 = map_resolution * map_resolution

    keys = np.floor(points / voxel_size).astype(np.int64)
    # Group points by voxel, preserving input order within groups. Offset to
    # non-negative before packing (disjoint 21-bit fields; XOR-packing would
    # corrupt fields via sign extension for negative coords).
    packed = _pack_keys(keys)
    order = np.argsort(packed, kind="stable")
    sorted_packed = packed[order]
    group_starts = np.flatnonzero(
        np.r_[True, sorted_packed[1:] != sorted_packed[:-1]]
    )
    group_ends = np.r_[group_starts[1:], len(order)]

    v = len(group_starts)
    vox_coords = np.zeros((v, 3), dtype=np.int64)
    block = np.zeros((v, max_pts, 3), dtype=np.float64)
    counts = np.zeros(v, dtype=np.int64)

    for gi, (s, e) in enumerate(zip(group_starts, group_ends)):
        idxs = np.sort(order[s:e])  # restore insertion order within the voxel
        vox_coords[gi] = keys[idxs[0]]
        cnt = 0
        for pi in idxs:
            if cnt >= max_pts:
                break
            p = points[pi]
            if cnt > 0:
                d2 = np.sum((block[gi, :cnt] - p) ** 2, axis=1)
                if d2.min() < res2:
                    continue
            block[gi, cnt] = p
            cnt += 1
        counts[gi] = cnt
    return vox_coords, block, counts


def _pad_inf(block, counts):
    """Fill unused point slots with +inf so distance argmins ignore them."""
    out = block.copy()
    m = block.shape[1]
    mask = np.arange(m)[None, :] >= counts[:, None]
    out[mask] = np.inf
    return out


def _build_table(vox_coords, load_factor, probe_limit):
    v = max(1, vox_coords.shape[0])
    table_size = 1
    while table_size < v / load_factor:
        table_size <<= 1
    fps = fingerprint_coords(vox_coords)
    while True:
        table = np.full(table_size, -1, dtype=np.int32)
        table_fp = np.zeros(table_size, dtype=np.uint32)
        max_probe = 1
        ok = True
        h0 = hash_coords(vox_coords, table_size)
        for i in range(vox_coords.shape[0]):
            h = int(h0[i])
            for k in range(probe_limit):
                slot = (h + k) % table_size
                if table[slot] < 0:
                    table[slot] = i
                    table_fp[slot] = fps[i]
                    max_probe = max(max_probe, k + 1)
                    break
            else:
                ok = False
                break
        if ok:
            return table, table_fp, table_size, max_probe
        table_size <<= 1  # too clustered: grow and retry


def _point_cov_all(built: BuiltMap, search_dist: float, chunk: int = 4096):
    """Per-point covariance over neighbors in the 27-voxel neighborhood
    (reference: ProcessVoxelBlock/CalPointCovAll, hpp:195-257), vectorized.

    Reference quirk kept: the query point seeds the neighbor list AND is found
    again during the voxel sweep (distance 0), so it is counted twice."""
    v, m = built.counts.shape[0], built.max_points_per_voxel
    d2_max = search_dist * search_dist

    # windowed-probe lookup over the already-built table
    p = built.max_probe
    table_ext = np.concatenate([built.table, built.table[:p]])
    fp_ext = np.concatenate([built.table_fp, built.table_fp[:p]])
    offsets = np.array(
        [[i, j, k] for i in (-1, 0, 1) for j in (-1, 0, 1) for k in (-1, 0, 1)],
        dtype=np.int64,
    )

    def lookup(coords):
        h = hash_coords(coords, built.table_size)
        fp = fingerprint_coords(coords)
        idx = h[..., None] + np.arange(p)
        rows = table_ext[idx]
        fps = fp_ext[idx]
        empty = rows < 0
        empty_before = np.cumsum(empty, axis=-1) - empty > 0
        hit = (fps == fp[..., None]) & ~empty & ~empty_before
        any_hit = hit.any(axis=-1)
        first = hit.argmax(axis=-1)
        row = np.take_along_axis(rows, first[..., None], axis=-1)[..., 0]
        return np.where(any_hit, row, v)  # v = sentinel row below

    pts_pad = np.concatenate(
        [np.where(np.isfinite(built.points), built.points, np.inf),
         np.full((1, m, 3), np.inf, np.float32)],
        axis=0,
    ).astype(np.float64)

    slot_mask = np.arange(m)[None, :] < built.counts[:, None]
    flat_pts = built.points[slot_mask].astype(np.float64)          # [P,3]
    flat_vox = np.repeat(np.arange(v), m).reshape(v, m)[slot_mask]  # [P]
    n_pts = len(flat_pts)

    means = np.zeros((n_pts, 3))
    covs = np.tile(np.eye(3), (n_pts, 1, 1))
    for s0 in range(0, n_pts, chunk):
        sl = slice(s0, min(s0 + chunk, n_pts))
        q = flat_pts[sl]                                           # [C,3]
        nb = built.vox_coords[flat_vox[sl]].astype(np.int64)[:, None, :] + offsets
        rows = lookup(nb)                                          # [C,27]
        cand = pts_pad[rows].reshape(len(q), -1, 3)                # [C,27m,3]
        diff = cand - q[:, None, :]
        d2 = np.einsum("cki,cki->ck", diff, diff)
        keep = np.isfinite(d2) & (d2 <= d2_max)
        cand0 = np.where(keep[:, :, None], cand, 0.0)
        # the self point appears once in cand (d=0) and once as the seed
        cnt = keep.sum(axis=1) + 1
        mean = (cand0.sum(axis=1) + q) / cnt[:, None]
        cen = np.where(keep[:, :, None], cand - mean[:, None, :], 0.0)
        qc = q - mean
        raw = (
            np.einsum("cki,ckj->cij", cen, cen)
            + np.einsum("ci,cj->cij", qc, qc)
        ) / np.maximum(cnt - 1, 1)[:, None, None]
        multi = cnt > 1
        reg = covs[sl]
        reg[multi] = _plane_regularize_batch(raw[multi])
        covs[sl] = reg
        mean_out = np.where(multi[:, None], mean, q)
        means[sl] = mean_out

    point_cov = np.tile(np.eye(3, dtype=np.float32), (v, m, 1, 1))
    point_cov_mean = np.zeros((v, m, 3), np.float32)
    point_cov[slot_mask] = covs.astype(np.float32)
    point_cov_mean[slot_mask] = means.astype(np.float32)
    return point_cov, point_cov_mean


def _point_cov_all_loop(built: BuiltMap, search_dist: float):
    """Original per-voxel Python-loop implementation (kept as an oracle)."""
    v, m = built.counts.shape[0], built.max_points_per_voxel
    d2_max = search_dist * search_dist
    coord_to_row = {tuple(c): i for i, c in enumerate(built.vox_coords)}
    offsets = np.array(
        [[i, j, k] for i in (-1, 0, 1) for j in (-1, 0, 1) for k in (-1, 0, 1)]
    )

    point_cov = np.tile(np.eye(3, dtype=np.float32), (v, m, 1, 1))
    point_cov_mean = np.zeros((v, m, 3), dtype=np.float32)
    for vi in range(v):
        base = built.vox_coords[vi]
        neighbor_rows = [
            coord_to_row.get(tuple(base + o)) for o in offsets
        ]
        cand = []
        for r in neighbor_rows:
            if r is not None and built.counts[r] > 0:
                cand.append(built.points[r, : built.counts[r]].astype(np.float64))
        cand = np.concatenate(cand, axis=0) if cand else np.zeros((0, 3))
        for pi in range(built.counts[vi]):
            p = built.points[vi, pi].astype(np.float64)
            if cand.shape[0]:
                d2 = np.sum((cand - p) ** 2, axis=1)
                neigh = cand[d2 <= d2_max]
            else:
                neigh = np.zeros((0, 3))
            neighbors = np.concatenate([p[None, :], neigh], axis=0)
            if neighbors.shape[0] == 1:
                point_cov[vi, pi] = np.eye(3)
                point_cov_mean[vi, pi] = p
            else:
                mean, cov = _plane_regularized_cov(neighbors)
                point_cov[vi, pi] = cov
                point_cov_mean[vi, pi] = mean
    return point_cov, point_cov_mean


def find_ground_height(built: BuiltMap, position_xy, search_range: float = 5.0):
    """Mean z of the 5 lowest map points within ``search_range`` of the XY
    position (reference: FindGroundHeight, voxel_hash_map.hpp:285-322).
    Returns (found, ground_z)."""
    pts = built.all_points()
    d2 = np.sum((pts[:, :2] - np.asarray(position_xy)) ** 2, axis=1)
    within = pts[d2 <= search_range * search_range]
    if within.shape[0] <= 3:
        return False, 0.0
    low = within[np.argsort(within[:, 2])[:5]]
    return True, float(low[:, 2].mean())


def voxel_downsample_host(points: np.ndarray, voxel_size: float) -> np.ndarray:
    """One point per voxel, first-come (reference: VoxelDownsample,
    voxel_hash_map.hpp:260-283). Host-side variant for init flows."""
    keys = np.floor(np.asarray(points, dtype=np.float64) / voxel_size).astype(np.int64)
    packed = _pack_keys(keys)
    _, first = np.unique(packed, return_index=True)
    return np.asarray(points)[np.sort(first)]
