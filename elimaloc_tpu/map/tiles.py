"""Tile-blocked correspondence engine — the default ICP backend.

The hash-grid queries in grid.py are semantically exact but gather-bound:
8192 queries x 27 probes x the voxel's points are random-access reads. This
module restructures the same correspondence semantics (reference:
voxel_hash_map.cpp:31-206) into a dense, contiguous-read dataflow:

  1. Map points/voxels are sorted into 2D spatial TILES (a few voxels wide,
     full z column). At build time each tile precomputes its HALO candidate
     block: every map point/voxel inside the tile's footprint grown by ONE
     voxel on each side — exactly the voxels any in-tile query's 27-voxel
     cube can reach — packed as one contiguous padded row.
  2. At query time, scan points are sorted by tile id and packed into fixed
     [slot, QB] blocks (a slot = one tile's queries, chunked by QB).
  3. Each slot fetches its halo row with a single contiguous read and
     evaluates the dense [QB, MH] distance matrix, masked back to
     the exact 27-voxel cube so results match the hash grid bit-for-bit (up
     to argmin tie order).
  4. Results scatter back through the sort permutation.

The halo layout replaced round 1/2's 9-neighbor-tile gather ([QB, 9*MTP]
candidates): growing a 4x4-voxel tile by one voxel is a 6x6 footprint, so the
dense matrix shrinks ~5x for a ~2.3x duplication of map points in device
memory. Halo rows of window-edge tiles keep
their full-map contents, so active-window crops stay exact one voxel past the
window boundary.

This is also the natural multi-chip decomposition: slots shard over devices
(parallel/sharding.py).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from .. import pytree

# GPU f32 matmuls may default to TF32; distance matrices and one-hot
# selections need true f32.
_HI = jax.lax.Precision.HIGHEST

from .builder import BuiltMap
from .grid import OFFSETS_7

_COORD_SENTINEL = np.int32(2**30)


@pytree.dataclass
class TileMap:
    """Tile-blocked map tensors. Row T (last) of tile-indexed arrays is a
    sentinel (count 0, +inf geometry)."""

    # point level (P2P / GICP): per-tile halo candidate blocks
    halo_points: jnp.ndarray            # [T+1, MHP, 3] f32, pad +inf
    halo_point_cov: Optional[jnp.ndarray]       # [T+1, MHP, 3, 3] or None
    halo_point_cov_mean: Optional[jnp.ndarray]  # [T+1, MHP, 3] or None

    # voxel level (VGICP / AVGICP)
    halo_vox_mean: jnp.ndarray          # [T+1, MHV, 3] f32, pad +inf
    halo_vox_cov: jnp.ndarray           # [T+1, MHV, 3, 3]
    halo_vox_coord: jnp.ndarray         # [T+1, MHV, 3] int32, pad sentinel

    voxel_size: float = pytree.field(pytree_node=False)
    tile_size: float = pytree.field(pytree_node=False)
    tx0: int = pytree.field(pytree_node=False)   # tile-grid origin (tile units)
    ty0: int = pytree.field(pytree_node=False)
    tx_dim: int = pytree.field(pytree_node=False)
    ty_dim: int = pytree.field(pytree_node=False)

    # world offset of the map's coordinate frame (nonzero for active-window
    # crops: point coords are stored window-locally so the window can move
    # WITHOUT recompiling — the origin is a dynamic pytree leaf while the
    # grid geometry stays static). run_register conjugates poses by it.
    origin: jnp.ndarray = None               # [2] f32 (x, y), 0 for full maps

    # Window anchor in TILE units relative to ``origin`` — zeros for full
    # maps and fresh crops. Incremental window shifts (:func:`shift_window`)
    # keep the coordinate origin FIXED (retained tile rows then need no
    # coordinate rewrite, only a device-side row roll) and move this anchor
    # instead; a dynamic leaf like ``origin``, so shifts never recompile.
    tile_anchor: jnp.ndarray = None          # [2] int32, 0 for full maps

    @property
    def num_tiles(self) -> int:
        return self.tx_dim * self.ty_dim

    @property
    def sentinel(self) -> int:
        return self.num_tiles


@dataclasses.dataclass(frozen=True)
class TileQueryBudget:
    """Static shape budgets for one query batch."""

    qb: int = 32           # queries per slot
    max_slots: int = 2560  # >= N/qb + (#occupied query tiles)
    # Slots vmapped per lax.map step of the correspondence pass. Small chunks
    # serialize S/chunk small fusions per pass; large chunks grow the live
    # [chunk, QB, MHP] candidate tensors. Not yet tuned for the GPU.
    chunk: int = 88

    def for_queries(self, n: int):
        return self


def _halo_membership(vox_xy, tile_voxels, tx0, ty0, tx_dim, ty_dim,
                     margin: int = 1):
    """(tile_row, item_idx) pairs: item k belongs to the halo of every tile
    whose (tile +- ``margin`` voxels) footprint contains its voxel column.

    margin=1 is the exact reach of an IN-TILE query's 27-voxel cube; a
    voxel at in-tile offset < margin also serves the -1 neighbor, offset
    >= tv - margin the +1 neighbor (both, per axis, when they overlap).
    margin=2 keeps the cube covered for queries that have DRIFTED up to one
    voxel outside their assigned tile — what lets AVGICP hoist the slot
    assignment out of the GN loop without the halo-edge candidate loss.
    Requires margin <= tile_voxels
    (a wider margin would need +-2 tile membership)."""
    tv = tile_voxels
    if not 1 <= margin <= tv:
        raise ValueError(f"halo margin {margin} must be in [1, {tv}]")
    vx, vy = vox_xy[:, 0], vox_xy[:, 1]
    tx, ty = vx // tv, vy // tv
    ox, oy = vx - tx * tv, vy - ty * tv
    rows, idxs = [], []
    for dx in (-1, 0, 1):
        mx = (np.ones_like(ox, bool) if dx == 0
              else (ox < margin) if dx == -1 else (ox >= tv - margin))
        for dy in (-1, 0, 1):
            my = (np.ones_like(oy, bool) if dy == 0
                  else (oy < margin) if dy == -1 else (oy >= tv - margin))
            gx, gy = tx + dx - tx0, ty + dy - ty0
            ok = (mx & my & (gx >= 0) & (gx < tx_dim)
                  & (gy >= 0) & (gy < ty_dim))
            rows.append(gx[ok] * ty_dim + gy[ok])
            idxs.append(np.nonzero(ok)[0])
    return np.concatenate(rows), np.concatenate(idxs)


def _pack_halo(rows, idxs, t, fills_payloads, out_path=None):
    """Scatter (tile_row, item) membership into padded [T+1, M, ...] blocks.
    ``fills_payloads`` = [(name, fill_value_or_array, payload [K, ...]),...].
    With ``out_path`` the blocks are disk-backed ``np.memmap`` files
    (<out_path>/<name>.npy) so city-scale packing never holds the dense
    tensors in host RAM."""
    order = np.argsort(rows, kind="stable")
    sr = rows[order]
    rank = np.arange(len(order)) - np.searchsorted(sr, sr)
    m = int(np.bincount(sr, minlength=t).max()) if len(sr) else 1
    out = []
    for name, fill, payload in fills_payloads:
        shape = (t + 1, m) + payload.shape[1:]
        if out_path is None:
            block = np.empty(shape, payload.dtype)
        else:
            block = np.lib.format.open_memmap(
                str(out_path / f"{name}.npy"), mode="w+",
                dtype=payload.dtype, shape=shape,
            )
        block[...] = np.asarray(fill, payload.dtype)
        block[sr, rank] = payload[idxs[order]]
        out.append(block)
    return out


def build_tile_map(built: BuiltMap, tile_voxels: int = 4,
                   storage_dir=None, halo_margin: int = 1) -> "HostTileMap":
    """Re-block a BuiltMap into per-tile halo candidate tensors (host side).

    ``storage_dir``: back the packed tensors with ``np.memmap`` files there
    instead of RAM — required for city-scale maps (a 20M-point map packs to
    ~1.5-4 GB of halo tensors; the active-window pipeline only ever reads
    the resident window's rows, so the host footprint stays at window size).
    Reopen later with :func:`load_tile_map`.

    ``halo_margin``: voxels of halo growth per tile (see
    :func:`_halo_membership`). 1 covers in-tile queries exactly; 2 keeps
    hoisted slot assignments exact under up to one voxel of GN pose drift
    (AVGICP) at ~1.8x the candidate count.
    """
    import json
    import pathlib

    out_path = None
    if storage_dir is not None:
        out_path = pathlib.Path(storage_dir)
        out_path.mkdir(parents=True, exist_ok=True)
    vs = built.voxel_size
    ts = vs * tile_voxels
    # numpy // floors for negative ints, matching floor(p / tile_size).
    vox_tx = built.vox_coords[:, 0] // tile_voxels
    vox_ty = built.vox_coords[:, 1] // tile_voxels
    tx0, ty0 = int(vox_tx.min()), int(vox_ty.min())
    tx_dim = int(vox_tx.max()) - tx0 + 1
    ty_dim = int(vox_ty.max()) - ty0 + 1
    t = tx_dim * ty_dim

    v, m = built.counts.shape[0], built.max_points_per_voxel

    # --- voxel-level halo blocks ---
    vrows, vidxs = _halo_membership(
        built.vox_coords[:, :2], tile_voxels, tx0, ty0, tx_dim, ty_dim,
        margin=halo_margin)
    halo_vox_mean, halo_vox_cov, halo_vox_coord = _pack_halo(
        vrows, vidxs, t,
        [
            ("halo_vox_mean", np.inf, built.vox_mean.astype(np.float32)),
            ("halo_vox_cov", np.eye(3, dtype=np.float32),
             built.vox_cov.astype(np.float32)),
            ("halo_vox_coord", _COORD_SENTINEL,
             built.vox_coords.astype(np.int32)),
        ],
        out_path=out_path,
    )

    # --- point-level halo blocks (flatten voxel blocks, keep payloads) ---
    pt_mask = np.arange(m)[None, :] < built.counts[:, None]          # [V, M]
    flat_pts = built.points[pt_mask].astype(np.float32)               # [P,3]
    pt_vox = np.repeat(np.arange(v), m).reshape(v, m)[pt_mask]
    prows, pidxs = _halo_membership(
        built.vox_coords[pt_vox][:, :2], tile_voxels, tx0, ty0,
        tx_dim, ty_dim, margin=halo_margin)
    payloads = [("halo_points", np.inf, flat_pts)]
    if built.point_cov is not None:
        payloads += [
            ("halo_point_cov", np.eye(3, dtype=np.float32),
             built.point_cov[pt_mask].astype(np.float32)),
            ("halo_point_cov_mean", np.inf,
             built.point_cov_mean[pt_mask].astype(np.float32)),
        ]
    packed = _pack_halo(prows, pidxs, t, payloads, out_path=out_path)
    halo_points = packed[0]
    halo_point_cov = packed[1] if built.point_cov is not None else None
    halo_point_cov_mean = packed[2] if built.point_cov is not None else None

    if out_path is not None:
        meta = dict(voxel_size=float(vs), tile_size=float(ts), tx0=tx0,
                    ty0=ty0, tx_dim=tx_dim, ty_dim=ty_dim,
                    halo_margin=int(halo_margin),
                    has_point_cov=built.point_cov is not None)
        (out_path / "meta.json").write_text(json.dumps(meta))
        for b in packed + [halo_vox_mean, halo_vox_cov, halo_vox_coord]:
            b.flush()

    return HostTileMap(
        halo_points=halo_points,
        halo_point_cov=halo_point_cov,
        halo_point_cov_mean=halo_point_cov_mean,
        halo_vox_mean=halo_vox_mean,
        halo_vox_cov=halo_vox_cov,
        halo_vox_coord=halo_vox_coord,
        voxel_size=float(vs),
        tile_size=float(ts),
        tx0=tx0,
        ty0=ty0,
        tx_dim=tx_dim,
        ty_dim=ty_dim,
        halo_margin=int(halo_margin),
    )


def load_tile_map(storage_dir, mmap: bool = True) -> "HostTileMap":
    """Reopen a tile map persisted by ``build_tile_map(storage_dir=...)``.

    With ``mmap`` (default) the halo tensors stay disk-backed and pages are
    read on demand — the host RSS for active-window serving is bounded by
    the window size, not the map size (the reference loads the whole PCD
    into RAM, pcm_matching.cpp:69-79)."""
    import json
    import pathlib

    p = pathlib.Path(storage_dir)
    meta = json.loads((p / "meta.json").read_text())
    meta.setdefault("halo_margin", 1)  # maps persisted without the key
    mode = "r" if mmap else None
    ld = lambda name: np.load(str(p / f"{name}.npy"), mmap_mode=mode)
    has_cov = meta.pop("has_point_cov")
    return HostTileMap(
        halo_points=ld("halo_points"),
        halo_point_cov=ld("halo_point_cov") if has_cov else None,
        halo_point_cov_mean=ld("halo_point_cov_mean") if has_cov else None,
        halo_vox_mean=ld("halo_vox_mean"),
        halo_vox_cov=ld("halo_vox_cov"),
        halo_vox_coord=ld("halo_vox_coord"),
        **meta,
    )


@dataclasses.dataclass
class HostTileMap:
    halo_points: np.ndarray
    halo_point_cov: Optional[np.ndarray]
    halo_point_cov_mean: Optional[np.ndarray]
    halo_vox_mean: np.ndarray
    halo_vox_cov: np.ndarray
    halo_vox_coord: np.ndarray
    voxel_size: float
    tile_size: float
    tx0: int
    ty0: int
    tx_dim: int
    ty_dim: int
    world_offset: tuple = (0.0, 0.0)
    # halo growth in voxels (see _halo_membership): >= 2 keeps a hoisted
    # slot assignment exact under up to (margin - 1) voxels of pose drift
    halo_margin: int = 1

    def to_device(self, dtype=jnp.float32) -> TileMap:
        cast = lambda x: None if x is None else jnp.asarray(x, dtype=dtype)
        return TileMap(
            halo_points=cast(self.halo_points),
            halo_point_cov=cast(self.halo_point_cov),
            halo_point_cov_mean=cast(self.halo_point_cov_mean),
            halo_vox_mean=cast(self.halo_vox_mean),
            halo_vox_cov=cast(self.halo_vox_cov),
            halo_vox_coord=jnp.asarray(self.halo_vox_coord),
            voxel_size=self.voxel_size,
            tile_size=self.tile_size,
            tx0=self.tx0,
            ty0=self.ty0,
            tx_dim=self.tx_dim,
            ty_dim=self.ty_dim,
            origin=jnp.asarray(self.world_offset, dtype=dtype),
            tile_anchor=jnp.zeros(2, jnp.int32),
        )

    def drop_page_cache(self):
        """Release file-backed pages of memmapped halo tensors (crops copy
        what they need; the touched pages would otherwise accumulate in RSS
        for the life of the process). No-op for RAM-backed maps."""
        import mmap as _mmap

        for a in (self.halo_points, self.halo_point_cov,
                  self.halo_point_cov_mean, self.halo_vox_mean,
                  self.halo_vox_cov, self.halo_vox_coord):
            mm = getattr(a, "_mmap", None)
            if mm is not None:
                try:
                    mm.madvise(_mmap.MADV_DONTNEED)
                except (AttributeError, OSError):
                    # keep evicting the OTHER tensors: one transiently
                    # failing madvise must not silently pin the rest in RSS
                    continue

    def window_anchor(self, center_xy, dims):
        """(x0, y0) tile anchor a crop_window at this center would use —
        cheap no-op detection for window management (clamped at map edges,
        where the window cannot follow the pose)."""
        nx, ny = dims
        cx = int(np.floor(center_xy[0] / self.tile_size))
        cy = int(np.floor(center_xy[1] / self.tile_size))
        x0 = int(np.clip(cx - nx // 2, self.tx0, self.tx0 + self.tx_dim - nx))
        y0 = int(np.clip(cy - ny // 2, self.ty0, self.ty0 + self.ty_dim - ny))
        return x0, y0

    def _origin_offsets(self, anchor, offset_dtype=np.float32):
        """(coordinate shift, voxel-coordinate shift) for a window whose
        coordinate origin is tile ``anchor``. Quantized to the DEVICE dtype:
        the same value must be subtracted host-side and added back by
        run_register's origin conjugation, or city-scale coordinates
        (~1e6 m, f32 ulp ~0.06 m) pick up a per-window pose bias."""
        off = np.array([anchor[0] * self.tile_size,
                        anchor[1] * self.tile_size])
        off = off.astype(offset_dtype).astype(np.float64)
        voff = (np.array(anchor)
                * int(round(self.tile_size / self.voxel_size)))
        return off, voff

    def _pack_rows(self, rows, off, voff):
        """Gather full-map halo rows ``rows`` (sentinel index allowed) and
        shift their coordinates into the origin frame given by
        (``off``, ``voff``) — the shared kernel of :meth:`crop_window`
        (all window rows) and :meth:`crop_entering_rows` (the few rows an
        incremental shift must upload)."""
        def sel(a):
            return None if a is None else a[rows]

        def shift_xy(a, o, sentinel=None):
            if a is None:
                return None
            a = a.copy()
            # padded entries (coord sentinel) must KEEP their sentinel
            # value: the voxel paths test coords against _COORD_SENTINEL
            # exactly, and a shifted pad would read as occupied (NaN means
            # downstream)
            keep = None if sentinel is None else (a[..., 0] == sentinel)
            a[..., 0] -= o[0]
            a[..., 1] -= o[1]
            if keep is not None:
                a[keep] = sentinel
            return a

        return dict(
            halo_points=shift_xy(sel(self.halo_points), off),
            halo_point_cov=sel(self.halo_point_cov),
            halo_point_cov_mean=shift_xy(sel(self.halo_point_cov_mean), off),
            halo_vox_mean=shift_xy(sel(self.halo_vox_mean), off),
            halo_vox_cov=sel(self.halo_vox_cov),
            halo_vox_coord=shift_xy(sel(self.halo_vox_coord), voff,
                                    sentinel=_COORD_SENTINEL),
        )

    def crop_window(self, center_xy, radius_tiles: int,
                    dims: Optional[tuple] = None,
                    offset_dtype=np.float32) -> "HostTileMap":
        """Fixed-size active-window crop in WINDOW-LOCAL coordinates.

        City-scale maps (10-100M points) do not fit HBM; the pipeline keeps
        a (2*radius_tiles+1)^2-tile window around the vehicle resident and
        re-crops when the pose nears the edge. The window's point/voxel
        coordinates are shifted by the window origin and the grid is
        anchored at tx0=ty0=0, so every crop has IDENTICAL static metadata
        — swapping windows never recompiles. The world offset rides along
        as ``world_offset`` (a dynamic device leaf after ``to_device``);
        ``register.run_register`` conjugates poses by it, making results
        identical to the full map for any query whose tile lies inside the
        window (halo rows carry their full-map contents, so exactness
        extends one voxel past the window boundary). Out-of-map tiles are
        filled from the sentinel row (empty).

        Note: the offset is an exact multiple of tile_size quantized to the
        device dtype; for voxel sizes whose tile_size is not exactly
        f32-representable the shifted floor(p/voxel) binning can differ from
        the full map for points within one ulp of a voxel boundary.
        """
        if dims is None:
            nx = min(2 * radius_tiles + 1, self.tx_dim)
            ny = min(2 * radius_tiles + 1, self.ty_dim)
        else:
            nx, ny = dims
        del dims
        x0, y0 = self.window_anchor(center_xy, (nx, ny))
        t_full = self.tx_dim * self.ty_dim  # sentinel row index
        gx = np.arange(x0 - self.tx0, x0 - self.tx0 + nx)
        gy = np.arange(y0 - self.ty0, y0 - self.ty0 + ny)
        in_map = (gx[:, None] >= 0) & (gx[:, None] < self.tx_dim) \
            & (gy[None, :] >= 0) & (gy[None, :] < self.ty_dim)
        rows = gx[:, None] * self.ty_dim + gy[None, :]
        rows = np.where(in_map, rows, t_full).reshape(-1)
        rows = np.concatenate([rows, [t_full]])  # + sentinel row

        off, voff = self._origin_offsets((x0, y0), offset_dtype)
        packed = self._pack_rows(rows, off, voff)
        return HostTileMap(
            **packed,
            voxel_size=self.voxel_size,
            tile_size=self.tile_size,
            tx0=0,
            ty0=0,
            tx_dim=nx,
            ty_dim=ny,
            world_offset=(float(off[0]), float(off[1])),
            halo_margin=self.halo_margin,
        )

    def crop_entering_rows(self, old_anchor, new_anchor, dims,
                           origin_anchor, r_pad: int,
                           offset_dtype=np.float32):
        """The rows an incremental window shift ``old_anchor ->
        new_anchor`` must upload: window rows (new layout) whose source
        tile was not resident before. Coordinates are shifted by
        ``origin_anchor`` — the FIXED origin of the incrementally-
        maintained window (see :func:`shift_window`), NOT the new anchor —
        so entering rows are bit-identical to a fresh crop at that origin.
        Returns ``(dst_rows [r_pad] int32, payload dict)``; pad entries
        point past the sentinel row and are dropped by the device scatter.
        """
        nx, ny = dims
        dx = new_anchor[0] - old_anchor[0]
        dy = new_anchor[1] - old_anchor[1]
        ii, jj = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
        src_i, src_j = ii + dx, jj + dy
        entering = ((src_i < 0) | (src_i >= nx)
                    | (src_j < 0) | (src_j >= ny))
        wrows = np.nonzero(entering.reshape(-1))[0].astype(np.int32)
        if len(wrows) > r_pad:
            raise ValueError(
                f"entering rows {len(wrows)} exceed pad budget {r_pad} "
                f"(shift ({dx},{dy}) on {nx}x{ny})"
            )
        gx = new_anchor[0] + (wrows // ny) - self.tx0
        gy = new_anchor[1] + (wrows % ny) - self.ty0
        t_full = self.tx_dim * self.ty_dim
        in_map = ((gx >= 0) & (gx < self.tx_dim)
                  & (gy >= 0) & (gy < self.ty_dim))
        rows_full = np.where(in_map, gx * self.ty_dim + gy, t_full)
        off, voff = self._origin_offsets(origin_anchor, offset_dtype)
        packed = self._pack_rows(rows_full, off, voff)

        def pad(a):
            if a is None:
                return None
            out = np.zeros((r_pad,) + a.shape[1:], a.dtype)
            out[: len(a)] = a
            return out

        dst = np.full(r_pad, nx * ny + 1, np.int32)  # pad -> dropped
        dst[: len(wrows)] = wrows
        return dst, {k: pad(v) for k, v in packed.items()}


# --------------------------------------------------------------------------- #
# Slot assignment: sort queries by tile, pack into [max_slots, qb] blocks
def _shift_window_impl(tmap: TileMap, dx, dy, dst_rows, payload) -> TileMap:
    nx, ny = tmap.tx_dim, tmap.ty_dim
    t = nx * ny
    i = jnp.arange(nx, dtype=jnp.int32)[:, None]
    j = jnp.arange(ny, dtype=jnp.int32)[None, :]
    si, sj = i + dx, j + dy
    ok = (si >= 0) & (si < nx) & (sj >= 0) & (sj < ny)
    # retained rows gather from their pre-shift position; vacated rows read
    # the sentinel (then the entering-row scatter overwrites the real ones)
    src = jnp.where(ok, si * ny + sj, t).reshape(-1)
    src = jnp.concatenate([src, jnp.array([t], jnp.int32)])  # sentinel stays

    def move(a, rows_new):
        if a is None:
            return None
        rolled = a[src]
        return rolled.at[dst_rows].set(
            jnp.asarray(rows_new, a.dtype), mode="drop")

    anchor = tmap.tile_anchor + jnp.stack([dx, dy]).astype(jnp.int32)
    return tmap.replace(
        halo_points=move(tmap.halo_points, payload["halo_points"]),
        halo_point_cov=move(tmap.halo_point_cov, payload["halo_point_cov"]),
        halo_point_cov_mean=move(tmap.halo_point_cov_mean,
                                 payload["halo_point_cov_mean"]),
        halo_vox_mean=move(tmap.halo_vox_mean, payload["halo_vox_mean"]),
        halo_vox_cov=move(tmap.halo_vox_cov, payload["halo_vox_cov"]),
        halo_vox_coord=move(tmap.halo_vox_coord, payload["halo_vox_coord"]),
        tile_anchor=anchor,
    )


_shift_window_jit = jax.jit(_shift_window_impl)


def shift_window(tmap: TileMap, dx: int, dy: int, dst_rows, payload) -> TileMap:
    """Move a resident device window by (dx, dy) tiles WITHOUT re-uploading
    it: retained tile rows roll on device (one contiguous-row gather), the
    entering rows from
    :meth:`HostTileMap.crop_entering_rows` scatter in (the only H2D), and
    the dynamic ``tile_anchor`` leaf advances while the coordinate
    ``origin`` stays FIXED — so retained coordinates are untouched bits and
    the result is bit-identical to a fresh crop sharing that origin. H2D
    shrinks from the full window to ``O(shift * window_side)`` rows
    (~15-30% for 1-2 tile shifts at default sizes); precision-wise,
    window-local coordinates grow with total drift from the origin — the
    runtime re-crops (re-centering the origin) past ~2 km, two orders of
    magnitude before f32 ulp reaches the voxel scale."""
    return _shift_window_jit(
        tmap, jnp.asarray(dx, jnp.int32), jnp.asarray(dy, jnp.int32),
        jnp.asarray(dst_rows), payload,
    )


# --------------------------------------------------------------------------- #

@pytree.dataclass
class SlotAssignment:
    qbuf: jnp.ndarray       # [S, QB, 3] queries (garbage where ~qmask)
    qvox: jnp.ndarray       # [S, QB, 3] int32 query voxel coords
    qmask: jnp.ndarray      # [S, QB] bool
    qidx: jnp.ndarray       # [S, QB] int32 original query index (N if unused)
    slot_tile: jnp.ndarray  # [S] int32 tile id (sentinel T if unused)
    dropped: jnp.ndarray    # number of queries dropped on slot overflow


def assign_slots(tmap: TileMap, queries, valid, budget: TileQueryBudget) -> SlotAssignment:
    n = queries.shape[0]
    qb, s = budget.qb, budget.max_slots
    t_sent = tmap.sentinel

    # effective tile-grid origin: static tx0/ty0 plus the dynamic window
    # anchor (zeros for full maps; traced i32 for incrementally-shifted
    # windows — see shift_window)
    ax0 = tmap.tx0 if tmap.tile_anchor is None else tmap.tx0 + tmap.tile_anchor[0]
    ay0 = tmap.ty0 if tmap.tile_anchor is None else tmap.ty0 + tmap.tile_anchor[1]
    qv = jnp.floor(queries / tmap.voxel_size).astype(jnp.int32)
    tx = jnp.floor(queries[:, 0] / tmap.tile_size).astype(jnp.int32) - ax0
    ty = jnp.floor(queries[:, 1] / tmap.tile_size).astype(jnp.int32) - ay0
    # A query up to one voxel OUTSIDE the tile grid still reaches in-grid
    # voxels with its 27-voxel cube (hash-grid semantics); clamp its tile to
    # the edge — the edge tile's halo holds exactly the reachable voxels and
    # the cube mask rejects the rest. Farther out the cube is provably empty.
    tv = int(round(tmap.tile_size / tmap.voxel_size))
    in_reach = (
        (qv[:, 0] >= ax0 * tv - 1)
        & (qv[:, 0] <= (ax0 + tmap.tx_dim) * tv)
        & (qv[:, 1] >= ay0 * tv - 1)
        & (qv[:, 1] <= (ay0 + tmap.ty_dim) * tv)
    )
    tx = jnp.clip(tx, 0, tmap.tx_dim - 1)
    ty = jnp.clip(ty, 0, tmap.ty_dim - 1)
    tile = jnp.where(valid & in_reach, tx * tmap.ty_dim + ty, t_sent)

    # Multi-operand sort: payload lanes ride the sort instead of argsort +
    # 7 permutation gathers. Stable + same key =>
    # identical layout to the argsort form.
    idx = jnp.arange(n, dtype=jnp.int32)
    (st, order, q0, q1, q2, v0, v1, v2) = jax.lax.sort(
        (tile, idx, queries[:, 0], queries[:, 1], queries[:, 2],
         qv[:, 0], qv[:, 1], qv[:, 2]),
        num_keys=1, is_stable=True,
    )
    first = jnp.ones(n, dtype=bool).at[1:].set(st[1:] != st[:-1])
    seg_start = jax.lax.cummax(jnp.where(first, idx, 0))
    rank = idx - seg_start
    new_slot = first | (rank % qb == 0)
    slot = jnp.cumsum(new_slot) - 1
    pos = rank % qb

    usable = (slot < s) & (st != t_sent)
    flat = jnp.where(usable, slot * qb + pos, s * qb)  # drop target

    q_sorted = jnp.stack([q0, q1, q2], axis=-1)
    qv_sorted = jnp.stack([v0, v1, v2], axis=-1)
    qbuf = jnp.zeros((s * qb, 3), dtype=queries.dtype).at[flat].set(
        q_sorted, mode="drop"
    ).reshape(s, qb, 3)
    qvox = jnp.full((s * qb, 3), 0, dtype=jnp.int32).at[flat].set(
        qv_sorted, mode="drop"
    ).reshape(s, qb, 3)
    qmask = jnp.zeros((s * qb,), dtype=bool).at[flat].set(
        usable, mode="drop"
    ).reshape(s, qb)
    qidx = jnp.full((s * qb,), n, dtype=jnp.int32).at[flat].set(
        order.astype(jnp.int32), mode="drop"
    ).reshape(s, qb)
    slot_tile = jnp.full((s + 1,), t_sent, dtype=jnp.int32).at[
        jnp.where(usable, slot, s)
    ].set(st, mode="drop")[:s]
    dropped = jnp.sum((st != t_sent) & ~usable)
    return SlotAssignment(
        qbuf=qbuf, qvox=qvox, qmask=qmask, qidx=qidx, slot_tile=slot_tile,
        dropped=dropped,
    )


def _slot_centers(tmap: TileMap, slot_tile, dtype):
    """Per-slot tile-center offsets. Distances are evaluated on tile-local
    coordinates so the |q|^2 - 2 q.c + |c|^2 expansion keeps full f32
    precision at map-scale coordinates (z is left global: vehicle maps are
    z-shallow)."""
    ax0 = tmap.tx0 if tmap.tile_anchor is None else tmap.tx0 + tmap.tile_anchor[0]
    ay0 = tmap.ty0 if tmap.tile_anchor is None else tmap.ty0 + tmap.tile_anchor[1]
    tx = (slot_tile // tmap.ty_dim + ax0).astype(dtype)
    ty = (slot_tile % tmap.ty_dim + ay0).astype(dtype)
    zeros = jnp.zeros_like(tx)
    return jnp.stack(
        [(tx + 0.5) * tmap.tile_size, (ty + 0.5) * tmap.tile_size, zeros], axis=-1
    )


def _cube_mask(qvox, cvox):
    """27-voxel cube membership: all(|cvox - qvox| <= 1).

    qvox: [..., QB, 3]; cvox: [..., K, 3] -> [..., QB, K] bool.
    """
    ok = jnp.ones(qvox.shape[:-2] + (qvox.shape[-2], cvox.shape[-2]), dtype=bool)
    for d in range(3):
        diff = jnp.abs(
            cvox[..., None, :, d] - qvox[..., :, None, d]
        )
        ok = ok & (diff <= 1)
    return ok


def _chunked(fn, xs_tree, chunk: int):
    """scan(vmap(fn)) over the leading axis in chunks (bounded memory).

    ``chunk`` is a request: the effective chunk is the largest divisor of the
    slot count not exceeding it, so any max_slots that is a multiple of 8
    works with any requested chunk (no padding, no wasted slots)."""
    leaves = jax.tree_util.tree_leaves(xs_tree)
    s = leaves[0].shape[0]
    chunk = max(d for d in range(1, min(chunk, s) + 1) if s % d == 0)
    assert s % chunk == 0, (s, chunk)
    resh = jax.tree_util.tree_map(
        lambda x: x.reshape((s // chunk, chunk) + x.shape[1:]), xs_tree
    )
    out = jax.lax.map(lambda c: jax.vmap(fn)(c), resh)
    return jax.tree_util.tree_map(
        lambda x: x.reshape((s,) + x.shape[2:]), out
    )


def _scatter_back(n, qidx, *fields):
    """[S,QB,...] slot results -> [N,...] original order (defaults kept where
    a query was dropped)."""
    flat_idx = qidx.reshape(-1)
    outs = []
    for default, buf in fields:
        flat = buf.reshape((-1,) + buf.shape[2:])
        out = jnp.broadcast_to(default, (n,) + flat.shape[1:]).astype(flat.dtype)
        outs.append(out.at[flat_idx].set(flat, mode="drop"))
    return outs


# --------------------------------------------------------------------------- #
# Queries
# --------------------------------------------------------------------------- #

def nearest_point_slots(tmap: TileMap, slot_tile, qbuf, qvox, qmask, max_dist,
                        budget: TileQueryBudget, *, with_point_cov: bool = False,
                        chunk: int | None = None):
    """Slot-layout core of :func:`query_nearest_point`: correspondence for
    pre-assigned per-tile query blocks, no scatter back to query order. Used
    directly by the ICP inner loop, where slot assignment is hoisted out of
    the Gauss-Newton iteration (the sort and scatter run once per
    registration; the GN sums are permutation-invariant so results never
    need re-ordering).

    Returns (target [S,QB,3], ok [S,QB]) + (cov [S,QB,3,3], mean [S,QB,3])
    when ``with_point_cov``.
    """
    mhp = tmap.halo_points.shape[1]

    def per_slot(args):
        q, qv, qm, tid, ctr = args                       # [QB,3],[QB,3],[QB],[],[3]
        cand = tmap.halo_points[tid]                     # [MHP,3] one row
        finite = jnp.isfinite(cand[:, 0])
        cand_safe = jnp.where(finite[:, None], cand, 0.0)  # keep inf out
        cvox = jnp.floor(cand_safe / tmap.voxel_size).astype(jnp.int32)
        cube = _cube_mask(qv, cvox) & finite[None, :]    # [QB, MHP]
        # dense squared distance on tile-local coordinates as exact
        # elementwise diff^2 sums: a K=3 contraction gains nothing from a
        # matmul unit, and this form avoids the q^2+c^2-2qc cancellation
        ql = q - ctr
        cl = jnp.where(finite[:, None], cand_safe - ctr, 0.0)
        diff = ql[:, None, :] - cl[None, :, :]           # [QB, MHP, 3]
        d2 = jnp.where(cube, jnp.sum(diff * diff, axis=-1), jnp.inf)
        best = jnp.argmin(d2, axis=1)
        best_d2 = jnp.min(d2, axis=1)
        ok = qm & (best_d2 < max_dist * max_dist)
        # gather-free selection: one-hot row-select as a matmul. All selected
        # fields ride ONE [MHP, K] payload so the [QB, MHP] one-hot streams
        # from HBM once (each output column is the same exact dot product as
        # a separate matmul).
        onehot = (
            jnp.arange(mhp, dtype=jnp.int32)[None, :] == best[:, None]
        ).astype(q.dtype)                                # [QB, MHP]
        if with_point_cov:
            ccov = tmap.halo_point_cov[tid].reshape(mhp, 9)
            cmean = tmap.halo_point_cov_mean[tid]
            cmean = jnp.where(finite[:, None], cmean, 0.0)  # inf pad -> NaN in matmul
            payload = jnp.concatenate([cand_safe, ccov, cmean], axis=1)
            sel = jnp.matmul(onehot, payload, precision=_HI)  # [QB, 15]
            tgt = jnp.where(ok[:, None], sel[:, 0:3], q)
            bc = sel[:, 3:12].reshape(-1, 3, 3)
            eye = jnp.broadcast_to(jnp.eye(3, dtype=bc.dtype), bc.shape)
            return (
                tgt, ok,
                jnp.where(ok[:, None, None], bc, eye),
                jnp.where(ok[:, None], sel[:, 12:15], q),
            )
        tgt = jnp.where(
            ok[:, None], jnp.matmul(onehot, cand_safe, precision=_HI), q
        )
        return (tgt, ok)

    centers = _slot_centers(tmap, slot_tile, qbuf.dtype)
    xs = (qbuf, qvox, qmask, slot_tile, centers)
    return _chunked(per_slot, xs, budget.chunk if chunk is None else chunk)


def query_nearest_point(tmap: TileMap, queries, valid, max_dist,
                        budget: TileQueryBudget, *, with_point_cov: bool = False,
                        chunk: int | None = None):
    """Nearest map point within the exact 27-voxel cube of each query
    (hash-grid/GetCorrespondencePoints semantics). Returns
    (target [N,3], valid [N]) plus (cov [N,3,3], cov_mean [N,3]) when
    ``with_point_cov`` (GICP)."""
    n = queries.shape[0]
    asg = assign_slots(tmap, queries, valid, budget)
    res = nearest_point_slots(
        tmap, asg.slot_tile, asg.qbuf, asg.qvox, asg.qmask, max_dist, budget,
        with_point_cov=with_point_cov, chunk=chunk,
    )
    fields = [(queries[0] * 0.0, res[0]), (jnp.asarray(False), res[1])]
    if with_point_cov:
        fields += [
            (jnp.eye(3, dtype=queries.dtype), res[2]),
            (queries[0] * 0.0, res[3]),
        ]
    out = _scatter_back(n, asg.qidx, *fields)
    # default target/mean for dropped queries: the query itself (sanitized)
    out[0] = jnp.where(out[1][:, None], out[0], queries)
    if with_point_cov:
        out[3] = jnp.where(out[1][:, None], out[3], queries)
    return tuple(out)


def nearest_voxel_cov_slots(tmap: TileMap, slot_tile, qbuf, qvox, qmask,
                            max_dist, budget: TileQueryBudget, chunk: int | None = None):
    """Slot-layout core of :func:`query_nearest_voxel_cov` (see
    :func:`nearest_point_slots` for why). Returns
    (cov [S,QB,3,3], mean [S,QB,3], ok [S,QB])."""
    mhv = tmap.halo_vox_mean.shape[1]

    def per_slot(args):
        q, qv, qm, tid, ctr = args
        means = tmap.halo_vox_mean[tid]                  # [MHV,3]
        cvox = tmap.halo_vox_coord[tid]                  # [MHV,3]
        occupied = cvox[:, 0] != _COORD_SENTINEL
        cube = _cube_mask(qv, cvox) & occupied[None, :]
        m_safe = jnp.where(occupied[:, None], means, 0.0)
        # exact elementwise diff^2 (see nearest_point_slots)
        ql = q - ctr
        ml = jnp.where(occupied[:, None], m_safe - ctr, 0.0)
        diff = ql[:, None, :] - ml[None, :, :]
        d2 = jnp.where(cube, jnp.sum(diff * diff, axis=-1), jnp.inf)
        best = jnp.argmin(d2, axis=1)
        best_d2 = jnp.min(d2, axis=1)
        ok = qm & (best_d2 < max_dist * max_dist)
        onehot = (
            jnp.arange(mhv, dtype=jnp.int32)[None, :] == best[:, None]
        ).astype(q.dtype)
        # one [MHV, 12] cov|mean payload: the one-hot streams once (see
        # nearest_point_slots)
        payload = jnp.concatenate(
            [tmap.halo_vox_cov[tid].reshape(mhv, 9), m_safe], axis=1
        )
        sel = jnp.matmul(onehot, payload, precision=_HI)  # [QB, 12]
        covs = sel[:, 0:9].reshape(-1, 3, 3)
        bmean = sel[:, 9:12]
        eye = jnp.broadcast_to(jnp.eye(3, dtype=covs.dtype), covs.shape)
        return (
            jnp.where(ok[:, None, None], covs, eye),
            jnp.where(ok[:, None], bmean, q),
            ok,
        )

    centers = _slot_centers(tmap, slot_tile, qbuf.dtype)
    return _chunked(per_slot, (qbuf, qvox, qmask, slot_tile, centers),
                    budget.chunk if chunk is None else chunk)


def query_nearest_voxel_cov(tmap: TileMap, queries, valid, max_dist,
                            budget: TileQueryBudget, chunk: int | None = None):
    """VGICP: covariance of the 27-neighborhood voxel whose mean is closest.
    Returns (cov [N,3,3], mean [N,3], valid [N])."""
    n = queries.shape[0]
    asg = assign_slots(tmap, queries, valid, budget)
    res = nearest_voxel_cov_slots(
        tmap, asg.slot_tile, asg.qbuf, asg.qvox, asg.qmask, max_dist, budget,
        chunk=chunk,
    )
    cov, mean, ok = _scatter_back(
        n,
        asg.qidx,
        (jnp.eye(3, dtype=queries.dtype), res[0]),
        (queries[0] * 0.0, res[1]),
        (jnp.asarray(False), res[2]),
    )
    mean = jnp.where(ok[:, None], mean, queries)
    return cov, mean, ok


def all_voxel_cov_slots(tmap: TileMap, slot_tile, qbuf, qvox, qmask,
                        max_dist, budget: TileQueryBudget, chunk: int | None = None):
    """Slot-layout core of :func:`query_all_voxel_cov` (see
    :func:`nearest_point_slots` for why). Returns
    (cov [S,QB,7,3,3], mean [S,QB,7,3], ok [S,QB,7])."""
    mhv = tmap.halo_vox_mean.shape[1]
    off7 = jnp.asarray(OFFSETS_7)

    def per_slot(args):
        q, qv, qm, tid = args
        means = tmap.halo_vox_mean[tid]
        cvox = tmap.halo_vox_coord[tid]
        covs = tmap.halo_vox_cov[tid]
        occupied = cvox[:, 0] != _COORD_SENTINEL
        want = qv[:, None, :] + off7[None, :, :]          # [QB,7,3]
        # exact-coordinate match over the candidate set; a coordinate occurs
        # at most once, so eq doubles as a one-hot selector
        eq = jnp.all(
            cvox[None, None, :, :] == want[:, :, None, :], axis=-1
        ) & occupied[None, None, :]                        # [QB,7,MHV]
        found = jnp.any(eq, axis=-1)
        sel = eq.astype(q.dtype)
        means_safe = jnp.where(occupied[:, None], means, 0.0)
        m_safe = jnp.einsum("qon,nk->qok", sel, means_safe, precision=_HI)
        d2 = jnp.sum((m_safe - q[:, None, :]) ** 2, axis=-1)
        ok = qm[:, None] & found & (d2 < max_dist * max_dist)
        c = jnp.einsum(
            "qon,nk->qok", sel, covs.reshape(mhv, 9), precision=_HI
        ).reshape(-1, 7, 3, 3)
        eye = jnp.broadcast_to(jnp.eye(3, dtype=c.dtype), c.shape)
        return (
            jnp.where(ok[..., None, None], c, eye),
            jnp.where(ok[..., None], m_safe, q[:, None, :]),
            ok,
        )

    return _chunked(per_slot, (qbuf, qvox, qmask, slot_tile),
                    budget.chunk if chunk is None else chunk)


def query_all_voxel_cov(tmap: TileMap, queries, valid, max_dist,
                        budget: TileQueryBudget, chunk: int | None = None):
    """AVGICP: the 7 face-adjacent voxels' covariances where they exist and
    their means pass the distance gate (GetCorrespondencesAllCov semantics).
    Returns (cov [N,7,3,3], mean [N,7,3], valid [N,7])."""
    n = queries.shape[0]
    asg = assign_slots(tmap, queries, valid, budget)
    res = all_voxel_cov_slots(
        tmap, asg.slot_tile, asg.qbuf, asg.qvox, asg.qmask, max_dist, budget,
        chunk=chunk,
    )
    cov, mean, ok = _scatter_back(
        n,
        asg.qidx,
        (jnp.eye(3, dtype=queries.dtype), res[0]),
        (jnp.zeros(3, dtype=queries.dtype), res[1]),
        (jnp.zeros(7, dtype=bool), res[2]),
    )
    mean = jnp.where(ok[..., None], mean, queries[:, None, :])
    return cov, mean, ok
