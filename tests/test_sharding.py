"""Multi-device sharding tests on the 8-device virtual CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from elimaloc_tpu.config import IcpMethod, PcmConfig
from elimaloc_tpu.map import TileQueryBudget, build_tile_map, build_voxel_map
from elimaloc_tpu.parallel import (
    make_mesh,
    register_batch_2d,
    register_batch_dp,
    register_sharded,
)
from elimaloc_tpu.register import make_icp_params, make_icp_static, run_register

import ref_numpy as ref

RNG = np.random.default_rng(55)


def setup(n_scan=512):
    ext = 30.0
    g = np.c_[RNG.uniform(-ext, ext, (6000, 2)), RNG.normal(0, 0.02, 6000)]
    w1 = np.c_[
        RNG.uniform(-ext, ext, 3000),
        np.full(3000, 15.0) + RNG.normal(0, 0.02, 3000),
        RNG.uniform(0, 4, 3000),
    ]
    w2 = np.c_[
        np.full(3000, -10.0) + RNG.normal(0, 0.02, 3000),
        RNG.uniform(-ext, ext, 3000),
        RNG.uniform(0, 4, 3000),
    ]
    mp = np.r_[g, w1, w2]
    built = build_voxel_map(mp, 1.0, 20, use_native=False)
    tmap = build_tile_map(built, tile_voxels=4).to_device(dtype=jnp.float64)
    truth = np.eye(4)
    truth[:3, :3] = ref.euler_to_rot([0, 0, 0.4])
    truth[:3, 3] = [2.0, 1.0, 0.0]
    d = np.linalg.norm(mp[:, :2] - truth[:2, 3], axis=1)
    near = mp[d < 25]
    sel = near[RNG.choice(len(near), n_scan)]
    scan = (sel - truth[:3, 3]) @ truth[:3, :3]
    init = truth.copy()
    init[:3, 3] += [0.3, -0.2, 0.05]
    cfg = PcmConfig(icp_method=IcpMethod.P2P)
    params = make_icp_params(cfg, dtype=jnp.float64)
    static = make_icp_static(
        cfg, backend="tile", tile_budget=TileQueryBudget(qb=32, max_slots=256)
    )
    return tmap, jnp.asarray(scan), jnp.asarray(init), params, static, truth


def test_mesh_has_8_devices():
    assert len(jax.devices()) == 8


def test_point_sharded_matches_single_device():
    tmap, scan, init, params, static, truth = setup()
    valid = jnp.ones(scan.shape[0], bool)
    ref_res = run_register(scan, valid, tmap, init, params, static)

    mesh = make_mesh(8, dp=1, axis_names=("dp", "sp"))
    res = register_sharded(scan, valid, tmap, init, params, static, mesh, "sp")
    assert bool(res.success)
    # Same scan split 8 ways: identical math up to summation order.
    np.testing.assert_allclose(
        np.asarray(res.pose), np.asarray(ref_res.pose), atol=1e-8
    )
    np.testing.assert_allclose(
        float(res.fitness), float(ref_res.fitness), atol=1e-10
    )
    err = np.linalg.norm(np.asarray(res.pose)[:3, 3] - truth[:3, 3])
    assert err < 0.1


def test_dp_batch_sharded():
    tmap, scan, init, params, static, truth = setup()
    b = 8
    scans = jnp.stack([scan] * b)
    valids = jnp.ones((b, scan.shape[0]), bool)
    inits = jnp.stack([jnp.asarray(init)] * b)
    mesh = make_mesh(8, dp=8, axis_names=("dp", "sp"))
    res = register_batch_dp(scans, valids, tmap, inits, params, static, mesh)
    assert res.pose.shape == (b, 4, 4)
    assert bool(np.asarray(res.success).all())
    errs = np.linalg.norm(np.asarray(res.pose)[:, :3, 3] - truth[:3, 3], axis=1)
    assert errs.max() < 0.1


def test_slot_sharded_matches_single_device():
    """slot_shard_axis: replicated inputs, slots split 8 ways, psum'd
    partials — must reproduce the single-device registration exactly (f64:
    summation order is the only difference)."""
    import dataclasses
    import functools
    from jax.sharding import PartitionSpec as P

    tmap, scan, init, params, static, truth = setup()
    valid = jnp.ones(scan.shape[0], bool)
    ref_res = run_register(scan, valid, tmap, init, params, static)

    mesh = make_mesh(8, dp=1, axis_names=("dp", "sp"))
    st_sp = dataclasses.replace(static, slot_shard_axis="sp")
    rep = jax.tree_util.tree_map(lambda _: P(), (tmap, params))

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(), P(), rep[0], P(), rep[1]),
        out_specs=P(), check_vma=False,
    )
    def inner(s, v, g, i, p):
        return run_register(s, v, g, i, p, st_sp)

    res = inner(scan, valid, tmap, init, params)
    assert bool(res.success)
    np.testing.assert_allclose(
        np.asarray(res.pose), np.asarray(ref_res.pose), atol=1e-8
    )
    np.testing.assert_allclose(
        float(res.fitness), float(ref_res.fitness), atol=1e-10
    )
    np.testing.assert_allclose(
        float(res.overlap), float(ref_res.overlap), atol=1e-10
    )
    assert int(res.iterations) == int(ref_res.iterations)


@pytest.mark.slow
def test_sp_fused_replay_matches_single_device():
    """The FULL fused pipeline under slot sharding (replay_fused_sp) must
    produce the single-device trajectory: deskew/downsample/EKF run
    replicated, ICP partials psum over the sp axis (the flagship pipeline is
    multi-device, not just standalone registration)."""
    from elimaloc_tpu.config import ElimalocConfig
    from elimaloc_tpu.parallel.sharding import replay_fused_sp
    from elimaloc_tpu.pipeline import (
        LocalizationPipeline,
        make_world,
        synthesize_log,
    )
    from elimaloc_tpu.pipeline.runtime import build_fused_batches

    world = make_world(seed=11, extent=40.0, n_ground=40_000, n_wall=20_000)
    log = synthesize_log(world, duration=2.0, points_per_scan=2048,
                         max_range=40.0, seed=12)
    cfg = ElimalocConfig()
    cfg.pcm.lidar_time_delay = 0.0
    cfg.ekf.ekf_init_x_m = 60.0
    cfg.ekf.ekf_init_y_m = 0.0
    cfg.ekf.ekf_init_yaw_deg = 90.0
    cfg.calib.ego_to_lidar_trans = (0.0, 0.0, 0.0)
    cfg.calib.ego_to_lidar_rot_deg = (0.0, 0.0, 0.0)
    cfg.pcm.icp_method = IcpMethod.P2P
    pipe = LocalizationPipeline(
        cfg, world, dtype=jnp.float64, ds_points=1024,
        tile_budget=TileQueryBudget(qb=16, max_slots=512),
        ego_ring_size=256, imu_ring_size=128,
    )
    state, outs = pipe.run_fused(log)
    pos_ref = np.asarray(outs["ego_pos"])
    assert float(np.asarray(outs["applied"]).mean()) == 1.0

    mesh = make_mesh(8, dp=1, axis_names=("dp", "sp"))
    state2 = pipe.reset()
    pipe._rebase(min(log.imu_t[0], log.scan_t[0]))
    batches = build_fused_batches(log, time_base=pipe.time_base)
    _, outs_sp = replay_fused_sp(
        state2, batches, pipe.map, pipe.params, pipe.static, mesh, "sp"
    )
    pos_sp = np.asarray(outs_sp["ego_pos"])
    assert float(np.asarray(outs_sp["applied"]).mean()) == 1.0
    np.testing.assert_allclose(pos_sp, pos_ref, rtol=0, atol=1e-7)


def test_2d_mesh_dp_x_sp():
    tmap, scan, init, params, static, truth = setup()
    b = 4
    scans = jnp.stack([scan] * b)
    valids = jnp.ones((b, scan.shape[0]), bool)
    inits = jnp.stack([jnp.asarray(init)] * b)
    mesh = make_mesh(8, dp=4, axis_names=("dp", "sp"))  # 4 x 2
    res = register_batch_2d(scans, valids, tmap, inits, params, static, mesh)
    assert res.pose.shape == (b, 4, 4)
    assert bool(np.asarray(res.success).all())
    errs = np.linalg.norm(np.asarray(res.pose)[:, :3, 3] - truth[:3, 3], axis=1)
    assert errs.max() < 0.1
