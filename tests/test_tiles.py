"""Tile-blocked queries must agree with the hash-grid reference queries."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from elimaloc_tpu.map import (
    TileQueryBudget,
    build_tile_map,
    build_voxel_map,
    to_device,
)
from elimaloc_tpu.map import grid as hashgrid
from elimaloc_tpu.map import tiles

RNG = np.random.default_rng(33)
BUDGET = TileQueryBudget(qb=32, max_slots=1024)
BUDGET_S = TileQueryBudget(qb=8, max_slots=1024)  # small-qb slot shape


def make_maps(n=4000, extent=15.0, voxel=1.0, max_pts=10, **kw):
    pts = RNG.uniform(-extent, extent, size=(n, 3))
    built = build_voxel_map(pts, voxel, max_pts, use_native=False, **kw)
    return to_device(built), build_tile_map(built, tile_voxels=4).to_device()


def queries(n=512, extent=16.0):
    # include out-of-map and negative-coordinate queries
    return jnp.asarray(RNG.uniform(-extent, extent, size=(n, 3)), jnp.float32)


class TestNearestPoint:
    @pytest.mark.parametrize("budget", [BUDGET, BUDGET_S],
                             ids=["qb32", "qb8"])
    def test_matches_hash_grid(self, budget):
        grid, tmap = make_maps()
        q = queries()
        v_in = jnp.ones(q.shape[0], bool)
        t_h, v_h, _, _ = hashgrid.query_nearest_point(grid, q, 5.0)
        t_t, v_t = tiles.query_nearest_point(tmap, q, v_in, 5.0, budget)
        np.testing.assert_array_equal(np.asarray(v_t), np.asarray(v_h))
        # same nearest distance (tie order may differ)
        d_h = np.linalg.norm(np.asarray(t_h) - np.asarray(q), axis=1)
        d_t = np.linalg.norm(np.asarray(t_t) - np.asarray(q), axis=1)
        np.testing.assert_allclose(
            d_t[np.asarray(v_t)], d_h[np.asarray(v_h)], atol=1e-5
        )

    def test_respects_input_validity(self):
        grid, tmap = make_maps()
        q = queries()
        v_in = jnp.arange(q.shape[0]) % 2 == 0
        t_t, v_t = tiles.query_nearest_point(tmap, q, v_in, 5.0, BUDGET)
        assert not np.asarray(v_t)[1::2].any()

    @pytest.mark.parametrize("budget", [BUDGET, BUDGET_S],
                             ids=["qb32", "qb8"])
    def test_gicp_payloads_match(self, budget):
        grid, tmap = make_maps(compute_point_cov=True, gicp_cov_search_dist=0.5)
        q = queries(256)
        v_in = jnp.ones(q.shape[0], bool)
        t_h, c_h, m_h, v_h = hashgrid.query_nearest_point_cov(grid, q, 5.0)
        t_t, v_t, c_t, m_t = tiles.query_nearest_point(
            tmap, q, v_in, 5.0, budget, with_point_cov=True
        )
        np.testing.assert_array_equal(np.asarray(v_t), np.asarray(v_h))
        sel = np.asarray(v_t)
        # payloads agree wherever the same point was selected (non-tie)
        same = np.all(np.isclose(np.asarray(t_t), np.asarray(t_h)), axis=1) & sel
        np.testing.assert_allclose(
            np.asarray(c_t)[same], np.asarray(c_h)[same], atol=1e-5
        )
        np.testing.assert_allclose(
            np.asarray(m_t)[same], np.asarray(m_h)[same], atol=1e-5
        )


class TestVoxelCov:
    @pytest.mark.parametrize("budget", [BUDGET, BUDGET_S],
                             ids=["qb32", "qb8"])
    def test_matches_hash_grid(self, budget):
        grid, tmap = make_maps(compute_voxel_cov=True)
        q = queries()
        v_in = jnp.ones(q.shape[0], bool)
        c_h, m_h, v_h = hashgrid.query_nearest_voxel_cov(grid, q, 5.0)
        c_t, m_t, v_t = tiles.query_nearest_voxel_cov(tmap, q, v_in, 5.0, budget)
        np.testing.assert_array_equal(np.asarray(v_t), np.asarray(v_h))
        sel = np.asarray(v_t)
        np.testing.assert_allclose(
            np.asarray(m_t)[sel], np.asarray(m_h)[sel], atol=1e-5
        )
        np.testing.assert_allclose(
            np.asarray(c_t)[sel], np.asarray(c_h)[sel], atol=1e-5
        )


class TestAllVoxelCov:
    @pytest.mark.parametrize("budget", [BUDGET, BUDGET_S],
                             ids=["qb32", "qb8"])
    def test_matches_hash_grid(self, budget):
        grid, tmap = make_maps(compute_voxel_cov=True)
        q = queries()
        v_in = jnp.ones(q.shape[0], bool)
        c_h, m_h, v_h = hashgrid.query_all_voxel_cov(grid, q, 5.0)
        c_t, m_t, v_t = tiles.query_all_voxel_cov(tmap, q, v_in, 5.0, budget)
        np.testing.assert_array_equal(np.asarray(v_t), np.asarray(v_h))
        sel = np.asarray(v_t)
        np.testing.assert_allclose(
            np.asarray(m_t)[sel], np.asarray(m_h)[sel], atol=1e-5
        )
        np.testing.assert_allclose(
            np.asarray(c_t)[sel], np.asarray(c_h)[sel], atol=1e-5
        )


def test_slot_overflow_drops_gracefully():
    grid, tmap = make_maps()
    q = queries(512)
    tiny = TileQueryBudget(qb=8, max_slots=8)  # way too small
    t_t, v_t = tiles.query_nearest_point(tmap, q, jnp.ones(512, bool), 5.0, tiny)
    # Dropped queries come back invalid, never wrong.
    t_h, v_h, _, _ = hashgrid.query_nearest_point(grid, q, 5.0)
    kept = np.asarray(v_t)
    assert kept.sum() < np.asarray(v_h).sum()
    d_h = np.linalg.norm(np.asarray(t_h) - np.asarray(q), axis=1)
    d_t = np.linalg.norm(np.asarray(t_t) - np.asarray(q), axis=1)
    np.testing.assert_allclose(d_t[kept], d_h[kept], atol=1e-5)


def test_assignment_covers_all_queries_with_budget():
    _, tmap = make_maps()
    q = queries(512)
    asg = tiles.assign_slots(tmap, q, jnp.ones(512, bool), BUDGET)
    assert int(asg.dropped) == 0
    assert int(asg.qmask.sum()) == 512


class TestSlotStaleness:
    """The ICP inner loop hoists tile-slot assignment out of the GN
    iterations (register/icp.py:_iteration_slots_flat); the assignment stays valid
    while the accumulated correction remains within ~(tile_size - voxel) of
    the initial guess. Drive ICP with an initial error that forces a long
    walk and check the tile backend tracks the hash backend (which reassigns
    implicitly every iteration)."""

    def _world(self, rng):
        ground = np.c_[rng.uniform(-25, 25, (30_000, 2)),
                       rng.normal(0, 0.05, 30_000)]
        wall_y = np.c_[rng.uniform(-25, 25, 6000),
                       np.full(6000, 8.0) + rng.normal(0, 0.05, 6000),
                       rng.uniform(0, 4, 6000)]
        wall_x = np.c_[np.full(6000, -6.0) + rng.normal(0, 0.05, 6000),
                       rng.uniform(-25, 25, 6000),
                       rng.uniform(0, 4, 6000)]
        return np.r_[ground, wall_y, wall_x]

    def test_long_walk_within_bound_matches_hash(self):
        from elimaloc_tpu.config import IcpMethod, PcmConfig
        from elimaloc_tpu.register import (
            make_icp_params,
            make_icp_static,
            run_register,
        )
        from elimaloc_tpu.map import grid as hashgrid

        rng = np.random.default_rng(21)
        world = self._world(rng)
        built = build_voxel_map(world, 1.0, 60, use_native=False)
        tmap = build_tile_map(built, tile_voxels=4).to_device(
            dtype=jnp.float64)
        hmap = to_device(built, dtype=jnp.float64)

        scan = world[rng.choice(len(world), 3000, replace=False)]
        true_pose = np.eye(4)
        true_pose[:3, 3] = [1.0, 2.0, 0.0]
        src = jnp.asarray(scan - true_pose[:3, 3])
        sv = jnp.ones(len(scan), bool)
        # 1.3 m initial error: needs a multi-iteration walk approaching the
        # 27-voxel reachability limit, still inside the ~3 m staleness bound
        init = true_pose.copy()
        init[:3, 3] += [0.9, -0.9, 0.1]

        cfg = PcmConfig(icp_method=IcpMethod.P2P, max_iteration=30)
        params = make_icp_params(cfg, dtype=jnp.float64)
        st_tile = make_icp_static(
            cfg, backend="tile",
            tile_budget=tiles.TileQueryBudget(qb=32, max_slots=512))
        st_hash = make_icp_static(cfg, backend="hash")

        res_t = jax.jit(run_register, static_argnums=5)(
            src, sv, tmap, jnp.asarray(init), params, st_tile)
        res_h = jax.jit(run_register, static_argnums=5)(
            src, sv, hmap, jnp.asarray(init), params, st_hash)
        assert int(res_t.dropped) == 0
        assert bool(res_t.success) and bool(res_h.success)
        # both walk home; the hoisted assignment must not lose
        # correspondences along the way
        err_t = np.linalg.norm(np.asarray(res_t.pose)[:3, 3] - true_pose[:3, 3])
        err_h = np.linalg.norm(np.asarray(res_h.pose)[:3, 3] - true_pose[:3, 3])
        assert err_h < 0.15, f"hash backend failed to converge: {err_h}"
        assert err_t < 0.15, f"tile backend failed to converge: {err_t}"
        np.testing.assert_allclose(
            np.asarray(res_t.pose)[:3, 3], np.asarray(res_h.pose)[:3, 3],
            rtol=0, atol=0.02)

    def test_avgicp_reassign_matches_hash_tightly(self):
        """AVGICP sums ALL 7 face-adjacent voxel covs, so halo-edge pairs
        lost to a stale initial-guess assignment are a systematic bias
        (round 4: 1.9-13.4 mm vs the hash backend at 0.3 m init error).
        With the default per-iteration reassignment (IcpStatic.
        reassign_each_iter) the tile backend must track the hash backend to
        ~micrometres — the hash path reassigns implicitly every iteration."""
        from elimaloc_tpu.config import IcpMethod, PcmConfig
        from elimaloc_tpu.register import (
            make_icp_params,
            make_icp_static,
            run_register,
        )

        rng = np.random.default_rng(23)
        world = self._world(rng)
        built = build_voxel_map(world, 1.0, 60, use_native=False,
                                compute_voxel_cov=True)
        tmap = build_tile_map(built, tile_voxels=4).to_device(
            dtype=jnp.float64)
        hmap = to_device(built, dtype=jnp.float64)
        scan = world[rng.choice(len(world), 3000, replace=False)]
        true_pose = np.eye(4)
        true_pose[:3, 3] = [1.0, 2.0, 0.0]
        src = jnp.asarray(scan - true_pose[:3, 3])
        sv = jnp.ones(len(scan), bool)
        cfg = PcmConfig(icp_method=IcpMethod.AVGICP, max_iteration=20,
                        max_fitness_score=2.0)
        params = make_icp_params(cfg, dtype=jnp.float64)
        st_tile = make_icp_static(
            cfg, backend="tile",
            tile_budget=tiles.TileQueryBudget(qb=32, max_slots=512))
        assert st_tile.reassign_each_iter  # the AVGICP default
        st_hash = make_icp_static(cfg, backend="hash")
        for off in ((0.3, 0.0, 0.0), (0.0, -0.3, 0.05), (-0.25, 0.25, 0.0)):
            init = true_pose.copy()
            init[:3, 3] += off
            res_t = jax.jit(run_register, static_argnums=5)(
                src, sv, tmap, jnp.asarray(init), params, st_tile)
            res_h = jax.jit(run_register, static_argnums=5)(
                src, sv, hmap, jnp.asarray(init), params, st_hash)
            assert bool(res_t.success) and bool(res_h.success)
            gap = np.linalg.norm(np.asarray(res_t.pose)[:3, 3]
                                 - np.asarray(res_h.pose)[:3, 3])
            assert gap < 1e-4, f"off={off}: tile-vs-hash {gap * 1e3:.3f} mm"

    def test_overflowed_budget_reports_dropped(self):
        from elimaloc_tpu.config import IcpMethod, PcmConfig
        from elimaloc_tpu.register import (
            make_icp_params,
            make_icp_static,
            run_register,
        )

        rng = np.random.default_rng(22)
        world = self._world(rng)
        built = build_voxel_map(world, 1.0, 20, use_native=False)
        tmap = build_tile_map(built, tile_voxels=4).to_device(
            dtype=jnp.float64)
        scan = world[rng.choice(len(world), 3000, replace=False)]
        src = jnp.asarray(scan - np.array([1.0, 2.0, 0.0]))
        sv = jnp.ones(len(scan), bool)
        init = np.eye(4)
        init[:3, 3] = [1.0, 2.0, 0.0]

        cfg = PcmConfig(icp_method=IcpMethod.P2P)
        params = make_icp_params(cfg, dtype=jnp.float64)
        # deliberately undersized slot budget: dropped must be surfaced
        st_small = make_icp_static(
            cfg, backend="tile",
            tile_budget=tiles.TileQueryBudget(qb=8, max_slots=64))
        res = jax.jit(run_register, static_argnums=5)(
            src, sv, tmap, jnp.asarray(init), params, st_small)
        assert int(res.dropped) > 0, "undersized budget must report drops"


class TestMapWindow:
    """Active-window crops (crop_window): window-local coordinates with a
    dynamic world origin — query results must match the full map for points
    whose 3x3-tile neighborhood lies inside the window, and window swaps
    must not change static metadata (so they never recompile)."""

    def test_window_queries_match_full_map(self):
        rng = np.random.default_rng(31)
        pts = rng.uniform(-40, 40, (40_000, 3)) * np.array([1, 1, 0.08])
        built = build_voxel_map(pts, 1.0, 20, use_native=False)
        host = build_tile_map(built, tile_voxels=4)
        full = host.to_device(dtype=jnp.float64)
        win_host = host.crop_window(np.array([10.0, -5.0]), 5)  # 5-tile radius
        win = win_host.to_device(dtype=jnp.float64)
        # identical static metadata across windows at different centers
        win2 = host.crop_window(np.array([-12.0, 9.0]), 5)
        assert (win2.tx_dim, win2.ty_dim) == (win_host.tx_dim, win_host.ty_dim)
        assert (win2.tx0, win2.ty0) == (win_host.tx0, win_host.ty0) == (0, 0)

        # interior queries (well inside the window)
        q = np.array([10.0, -5.0]) + rng.uniform(-8, 8, (256, 2))
        q = np.c_[q, rng.uniform(-1, 1, 256)]
        qd = jnp.asarray(q)
        v = jnp.ones(len(q), bool)
        budget = TileQueryBudget(qb=32, max_slots=128)
        tgt_f, ok_f = tiles.query_nearest_point(full, qd, v, 5.0, budget)[:2]
        origin = np.asarray(win.origin)
        q_loc = q.copy()
        q_loc[:, :2] -= origin
        tgt_w, ok_w = tiles.query_nearest_point(
            win, jnp.asarray(q_loc), v, 5.0, budget)[:2]
        np.testing.assert_array_equal(np.asarray(ok_f), np.asarray(ok_w))
        tgt_w_world = np.array(tgt_w)
        tgt_w_world[:, :2] += origin
        # window-local f32 storage quantizes shifted coordinates by ~1 ulp
        # (micrometers at map scale) — far below any localization tolerance
        np.testing.assert_allclose(np.asarray(tgt_f), tgt_w_world,
                                   rtol=0, atol=1e-5)

    def test_incremental_shift_bit_identical(self):
        """tiles.shift_window: an incrementally-maintained window (device
        row roll + entering-row scatter, FIXED coordinate origin) must be
        bit-identical to packing the same tile rows fresh at that origin —
        across multi-step shift chains, both axes, map-edge clipping, and
        the 1/2/3-tile shift buckets."""
        rng = np.random.default_rng(41)
        pts = rng.uniform(-40, 40, (30_000, 3)) * np.array([1, 1, 0.08])
        built = build_voxel_map(pts, 1.0, 20, use_native=False,
                                compute_voxel_cov=True)
        host = build_tile_map(built, tile_voxels=4)
        dims = (7, 7)
        c0 = np.array([-20.0, -20.0])
        origin_anchor = host.window_anchor(c0, dims)
        dev = host.crop_window(c0, 3, dims=dims).to_device()
        anchor = origin_anchor
        t_full = host.tx_dim * host.ty_dim
        # a drive across the map: mixed-axis shifts incl. a 3-tile jump and
        # an edge-clamped segment
        for step in [(1, 0), (1, 1), (0, 2), (3, 1), (2, 2), (1, 0)]:
            new_anchor = (
                int(np.clip(anchor[0] + step[0], host.tx0,
                            host.tx0 + host.tx_dim - dims[0])),
                int(np.clip(anchor[1] + step[1], host.ty0,
                            host.ty0 + host.ty_dim - dims[1])),
            )
            k = max(abs(new_anchor[0] - anchor[0]),
                    abs(new_anchor[1] - anchor[1]))
            if k == 0:
                anchor = new_anchor
                continue
            r_pad = k * (dims[0] + dims[1])
            dst, payload = host.crop_entering_rows(
                anchor, new_anchor, dims, origin_anchor, r_pad)
            dev = tiles.shift_window(
                dev, new_anchor[0] - anchor[0], new_anchor[1] - anchor[1],
                dst, payload)
            anchor = new_anchor

            # expected: the same rows packed fresh with the SAME origin
            gx = np.arange(anchor[0] - host.tx0, anchor[0] - host.tx0 + dims[0])
            gy = np.arange(anchor[1] - host.ty0, anchor[1] - host.ty0 + dims[1])
            in_map = (gx[:, None] >= 0) & (gx[:, None] < host.tx_dim) \
                & (gy[None, :] >= 0) & (gy[None, :] < host.ty_dim)
            rows = np.where(in_map, gx[:, None] * host.ty_dim + gy[None, :],
                            t_full).reshape(-1)
            rows = np.concatenate([rows, [t_full]])
            off, voff = host._origin_offsets(origin_anchor)
            exp = host._pack_rows(rows, off, voff)
            for name, e in exp.items():
                if e is None:
                    continue
                got = np.asarray(getattr(dev, name))
                np.testing.assert_array_equal(
                    got, e.astype(got.dtype), err_msg=f"{name} @ {anchor}")
            np.testing.assert_array_equal(
                np.asarray(dev.tile_anchor),
                np.array(anchor) - np.array(origin_anchor))

    def test_incremental_shift_icp_matches_fresh_crop(self):
        """ICP against an incrementally-shifted window == ICP against a
        fresh crop at the same anchor (different coordinate origins; the
        origin conjugation must absorb the difference)."""
        from elimaloc_tpu.config import IcpMethod, PcmConfig
        from elimaloc_tpu.register import (
            make_icp_params,
            make_icp_static,
            run_register,
        )

        rng = np.random.default_rng(42)
        pts = rng.uniform(-40, 40, (40_000, 3)) * np.array([1, 1, 0.08])
        built = build_voxel_map(pts, 1.0, 20, use_native=False)
        host = build_tile_map(built, tile_voxels=4)
        dims = (9, 9)
        origin_anchor = host.window_anchor(np.array([-10.0, -10.0]), dims)
        dev = host.crop_window(np.array([-10.0, -10.0]), 4,
                               dims=dims).to_device(dtype=jnp.float64)
        anchor = origin_anchor
        for target in ([-2.0, -6.0], [6.0, 2.0]):
            new_anchor = host.window_anchor(np.array(target), dims)
            k = max(abs(new_anchor[0] - anchor[0]),
                    abs(new_anchor[1] - anchor[1]))
            dst, payload = host.crop_entering_rows(
                anchor, new_anchor, dims, origin_anchor,
                k * (dims[0] + dims[1]), offset_dtype=np.float64)
            dev = tiles.shift_window(
                dev, new_anchor[0] - anchor[0], new_anchor[1] - anchor[1],
                dst, payload)
            anchor = new_anchor
        fresh = host.crop_window(np.array([6.0, 2.0]),
                                 4, dims=dims).to_device(dtype=jnp.float64)

        true_pose = np.eye(4)
        true_pose[:3, 3] = [6.0, 2.0, 0.0]
        sel = pts[np.linalg.norm(pts[:, :2] - true_pose[:2, 3], axis=1) < 12]
        scan = sel[rng.choice(len(sel), 2000, replace=False)]
        src = jnp.asarray(scan - true_pose[:3, 3])
        sv = jnp.ones(len(scan), bool)
        init = true_pose.copy()
        init[:3, 3] += [0.3, -0.2, 0.05]
        cfg = PcmConfig(icp_method=IcpMethod.P2P, max_iteration=15)
        params = make_icp_params(cfg, dtype=jnp.float64)
        static = make_icp_static(
            cfg, backend="tile",
            tile_budget=TileQueryBudget(qb=16, max_slots=512))
        res_i = jax.jit(run_register, static_argnums=5)(
            src, sv, dev, jnp.asarray(init), params, static)
        res_f = jax.jit(run_register, static_argnums=5)(
            src, sv, fresh, jnp.asarray(init), params, static)
        assert bool(res_i.success) and bool(res_f.success)
        # different coordinate origins change f64 rounding in the distance
        # sums -> slightly different GN trajectories; a micrometer bound is
        # far below any localization tolerance
        np.testing.assert_allclose(
            np.asarray(res_i.pose), np.asarray(res_f.pose), rtol=0,
            atol=1e-6)

    def test_windowed_icp_matches_full_map(self):
        from elimaloc_tpu.config import IcpMethod, PcmConfig
        from elimaloc_tpu.register import (
            make_icp_params,
            make_icp_static,
            run_register,
        )

        rng = np.random.default_rng(32)
        ground = np.c_[rng.uniform(-40, 40, (40_000, 2)),
                       rng.normal(0, 0.05, 40_000)]
        wall_y = np.c_[rng.uniform(-40, 40, 8000),
                       np.full(8000, 6.0) + rng.normal(0, 0.05, 8000),
                       rng.uniform(0, 4, 8000)]
        wall_x = np.c_[np.full(8000, -4.0) + rng.normal(0, 0.05, 8000),
                       rng.uniform(-40, 40, 8000),
                       rng.uniform(0, 4, 8000)]
        world = np.r_[ground, wall_y, wall_x]
        built = build_voxel_map(world, 1.0, 30, use_native=False)
        host = build_tile_map(built, tile_voxels=4)
        full = host.to_device(dtype=jnp.float64)
        win = host.crop_window(np.array([2.0, 3.0]), 6).to_device(
            dtype=jnp.float64)

        scan = world[rng.choice(len(world), 2000, replace=False)]
        true_pose = np.eye(4)
        true_pose[:3, 3] = [2.0, 3.0, 0.0]
        src = jnp.asarray(scan - true_pose[:3, 3])
        sv = jnp.ones(len(scan), bool)
        init = true_pose.copy()
        init[:3, 3] += [0.2, -0.15, 0.03]

        cfg = PcmConfig(icp_method=IcpMethod.P2P)
        params = make_icp_params(cfg, dtype=jnp.float64)
        st = make_icp_static(cfg, backend="tile",
                             tile_budget=TileQueryBudget(qb=32, max_slots=512))
        res_f = jax.jit(run_register, static_argnums=5)(
            src, sv, full, jnp.asarray(init), params, st)
        res_w = jax.jit(run_register, static_argnums=5)(
            src, sv, win, jnp.asarray(init), params, st)
        assert bool(res_f.success) and bool(res_w.success)
        # the window covers the whole 47-m scan? No — points beyond the
        # window have no correspondences; the poses still agree closely
        # because the interior dominates. Exactness is asserted at the
        # query level above; here assert consistent convergence.
        np.testing.assert_allclose(
            np.asarray(res_w.pose)[:3, 3], np.asarray(res_f.pose)[:3, 3],
            rtol=0, atol=0.02)

    def test_window_voxel_queries_match_full_map(self):
        """The voxel-cov paths test coords against the EXACT sentinel; a
        shifted pad once read as occupied and produced NaN means (0*inf in
        the one-hot select). Windowed VGICP/AVGICP queries must match the
        full map and stay finite."""
        rng = np.random.default_rng(33)
        pts = rng.uniform(-40, 40, (40_000, 3)) * np.array([1, 1, 0.08])
        built = build_voxel_map(pts, 1.0, 20, compute_voxel_cov=True,
                                use_native=False)
        host = build_tile_map(built, tile_voxels=4)
        full = host.to_device(dtype=jnp.float64)
        win_h = host.crop_window(np.array([6.0, -3.0]), 5)
        win = win_h.to_device(dtype=jnp.float64)
        origin = np.asarray(win.origin)

        q = np.array([6.0, -3.0]) + rng.uniform(-8, 8, (192, 2))
        q = np.c_[q, rng.uniform(-1, 1, 192)]
        v = jnp.ones(len(q), bool)
        budget = TileQueryBudget(qb=32, max_slots=128)
        q_loc = q.copy()
        q_loc[:, :2] -= origin

        cov_f, mean_f, ok_f = tiles.query_nearest_voxel_cov(
            full, jnp.asarray(q), v, 5.0, budget)
        cov_w, mean_w, ok_w = tiles.query_nearest_voxel_cov(
            win, jnp.asarray(q_loc), v, 5.0, budget)
        assert np.isfinite(np.asarray(mean_w)).all()
        np.testing.assert_array_equal(np.asarray(ok_f), np.asarray(ok_w))
        mean_w_world = np.array(mean_w)
        mean_w_world[:, :2] += origin
        np.testing.assert_allclose(np.asarray(mean_f), mean_w_world,
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(np.asarray(cov_f), np.asarray(cov_w),
                                   rtol=0, atol=1e-6)

        cov7_f, mean7_f, ok7_f = tiles.query_all_voxel_cov(
            full, jnp.asarray(q), v, 5.0, budget)
        cov7_w, mean7_w, ok7_w = tiles.query_all_voxel_cov(
            win, jnp.asarray(q_loc), v, 5.0, budget)
        assert np.isfinite(np.asarray(mean7_w)).all()
        np.testing.assert_array_equal(np.asarray(ok7_f), np.asarray(ok7_w))


def test_drop_page_cache_survives_one_failing_madvise():
    """A single failing madvise must not abort eviction of the remaining
    tensors (a regression once returned instead of continuing)."""
    import mmap as _mmap

    calls = []

    class FakeMmap:
        def __init__(self, name, fail):
            self.name, self.fail = name, fail

        def madvise(self, flag):
            assert flag == _mmap.MADV_DONTNEED
            if self.fail:
                raise OSError("transient madvise failure")
            calls.append(self.name)

    class FakeArr(np.ndarray):
        pass

    def arr(name, fail):
        a = np.zeros(1).view(FakeArr)
        a._mmap = FakeMmap(name, fail)
        return a

    host = tiles.HostTileMap(
        halo_points=arr("points", fail=True),       # first one fails...
        halo_point_cov=arr("pcov", fail=False),
        halo_point_cov_mean=arr("pmean", fail=False),
        halo_vox_mean=arr("vmean", fail=False),
        halo_vox_cov=arr("vcov", fail=False),
        halo_vox_coord=arr("vcoord", fail=False),
        voxel_size=1.0, tile_size=4.0, tx0=0, ty0=0, tx_dim=1, ty_dim=1,
    )
    host.drop_page_cache()
    # ...and every later tensor is still evicted
    assert calls == ["pcov", "pmean", "vmean", "vcov", "vcoord"]
