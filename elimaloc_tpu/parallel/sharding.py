"""Multi-chip scaling via jax.sharding: SPMD over scan batch + point axis.

The reference's complete concurrency story is intra-process TBB data
parallelism over points plus two localhost ROS processes (SURVEY.md §2
C11-C13); there is no multi-machine path. The multi-device equivalents:

  * ``sp`` (spatial/point parallel): one registration's source-point axis is
    sharded over devices with ``shard_map``; the per-iteration Gauss-Newton
    partials (matched count, 6x6 JTJ, 6x1 JTr, fitness numerator) are psum'd
    so every device runs the identical LM solve and termination in
    lockstep — the associative reduction tbb::parallel_reduce exploits on CPU
    (voxel_hash_map.cpp:57-84), expressed as an XLA collective.
  * ``dp`` (data parallel): independent registrations (multi-vehicle fleets,
    batched log replay, relocalization hypothesis search) shard over the
    batch axis with no cross-talk.

The map itself is replicated (tens of MB — broadcast once); sharding the
map axis instead would be the memory-bound regime, not the compute-bound one.
"""

from __future__ import annotations

import functools

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..register import run_register
from ..register.icp import IcpParams, IcpStatic


def make_mesh(n_devices: int | None = None, dp: int | None = None,
              axis_names=("dp", "sp"), devices=None) -> Mesh:
    """Build a (dp, sp) mesh over ``devices`` (default: ``jax.devices()``)."""
    devs = np.asarray(jax.devices() if devices is None else devices)
    n = n_devices or len(devs)
    devs = devs[:n]
    if dp is None:
        # favor point-sharding for a single registration, square-ish otherwise
        dp = 1
        for cand in range(int(np.sqrt(n)), 0, -1):
            if n % cand == 0:
                dp = cand
                break
    sp = n // dp
    return Mesh(devs.reshape(dp, sp), axis_names)


def register_sharded(scan, valid, grid, init_pose, params: IcpParams,
                     static: IcpStatic, mesh: Mesh, axis: str = "sp"):
    """One registration with the point axis sharded over ``axis``.

    scan [N,3] / valid [N] are split along N; the map and initial pose are
    replicated. Returns a fully-replicated IcpResult.
    """
    static_sp = IcpStatic(
        method=static.method,
        max_iteration=static.max_iteration,
        use_radar_cov=static.use_radar_cov,
        backend=static.backend,
        tile_budget=static.tile_budget,
        psum_axis=axis,
    )

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(
            P(axis), P(axis),
            jax.tree_util.tree_map(lambda _: P(), grid),
            P(), jax.tree_util.tree_map(lambda _: P(), params),
        ),
        out_specs=P(),
        check_vma=False,
    )
    def inner(scan_l, valid_l, grid_l, init_l, params_l):
        return run_register(scan_l, valid_l, grid_l, init_l, params_l, static_sp)

    return inner(scan, valid, grid, init_pose, params)


def register_batch_dp(scans, valids, grid, init_poses, params: IcpParams,
                      static: IcpStatic, mesh: Mesh, axis: str = "dp"):
    """Batch of independent registrations sharded over ``axis`` (vmap inside
    each shard). scans [B,N,3], valids [B,N], init_poses [B,4,4]."""

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(
            P(axis), P(axis),
            jax.tree_util.tree_map(lambda _: P(), grid),
            P(axis), jax.tree_util.tree_map(lambda _: P(), params),
        ),
        out_specs=P(axis),
        check_vma=False,
    )
    def inner(scans_l, valids_l, grid_l, inits_l, params_l):
        return jax.vmap(
            lambda s, v, i: run_register(s, v, grid_l, i, params_l, static)
        )(scans_l, valids_l, inits_l)

    return inner(scans, valids, grid, init_poses, params)


def register_batch_2d(scans, valids, grid, init_poses, params: IcpParams,
                      static: IcpStatic, mesh: Mesh,
                      dp_axis: str = "dp", sp_axis: str = "sp"):
    """Full 2D decomposition: batch over ``dp_axis`` x points over ``sp_axis``
    — every device holds a [B/dp, N/sp] tile; GN partials psum over sp only.
    This is the framework's flagship multi-chip step."""
    static_sp = IcpStatic(
        method=static.method,
        max_iteration=static.max_iteration,
        use_radar_cov=static.use_radar_cov,
        backend=static.backend,
        tile_budget=static.tile_budget,
        psum_axis=sp_axis,
    )

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(
            P(dp_axis, sp_axis), P(dp_axis, sp_axis),
            jax.tree_util.tree_map(lambda _: P(), grid),
            P(dp_axis), jax.tree_util.tree_map(lambda _: P(), params),
        ),
        out_specs=P(dp_axis),
        check_vma=False,
    )
    def inner(scans_l, valids_l, grid_l, inits_l, params_l):
        return jax.vmap(
            lambda s, v, i: run_register(s, v, grid_l, i, params_l, static_sp)
        )(scans_l, valids_l, inits_l)

    return inner(scans, valids, grid, init_poses, params)


def _slot_shard_static(ps, axis: str):
    """PipelineStatic with the ICP slot axis sharded over ``axis``."""
    import dataclasses

    return dataclasses.replace(
        ps,
        icp_static=dataclasses.replace(ps.icp_static, slot_shard_axis=axis),
    )


def replay_fused_sp(state, batches, tmap, pp, ps, mesh: Mesh,
                    axis: str = "sp"):
    """The FULL fused pipeline (IMU sub-scan + deskew + downsample + ICP +
    EKF) for ONE stream, multi-chip: every stage runs replicated except the
    ICP correspondence + Gauss-Newton partials, whose tile-slot axis shards
    over ``axis`` (register/icp.py slot_shard_axis) with one 6x6-partial
    psum per iteration. State/batches/map are replicated; outputs
    are identical on every device (up to f32 summation order).

    This is the single-stream LATENCY mode: the dense correspondence —
    the dominant per-frame cost — divides by the mesh size while the psum
    payload is ~60 scalars per ICP iteration."""
    from ..pipeline.runtime import replay_fused

    ps_sp = _slot_shard_static(ps, axis)
    rep = jax.tree_util.tree_map(lambda _: P(), (state, batches, tmap, pp))

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=rep, out_specs=P(),
        check_vma=False,
    )
    def inner(state_l, batches_l, tmap_l, pp_l):
        return replay_fused(state_l, batches_l, tmap_l, pp_l, ps_sp)

    return inner(state, batches, tmap, pp)


def replay_fused_2d(states, batches, tmap, pp, ps, mesh: Mesh,
                    dp_axis: str = "dp", sp_axis: str = "sp"):
    """Flagship 2D multi-chip fused replay: independent streams shard over
    ``dp_axis`` (fleet replay, zero cross-talk) while each stream's ICP slot
    axis shards over ``sp_axis``. A (dp, sp) mesh runs dp streams at sp-chip
    single-stream latency."""
    from ..pipeline.runtime import replay_fused

    ps_sp = _slot_shard_static(ps, sp_axis)
    dp_spec = jax.tree_util.tree_map(lambda _: P(dp_axis), (states, batches))
    rep_spec = jax.tree_util.tree_map(lambda _: P(), (tmap, pp))

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(dp_spec[0], dp_spec[1], rep_spec[0], rep_spec[1]),
        out_specs=P(dp_axis),
        check_vma=False,
    )
    def inner(states_l, batches_l, tmap_l, pp_l):
        return jax.vmap(
            lambda s, b: replay_fused(s, b, tmap_l, pp_l, ps_sp)
        )(states_l, batches_l)

    sh_b = NamedSharding(mesh, P(dp_axis))
    states = jax.tree_util.tree_map(lambda x: jax.device_put(x, sh_b), states)
    batches = jax.tree_util.tree_map(lambda x: jax.device_put(x, sh_b), batches)
    tmap = replicate(tmap, mesh)
    return inner(states, batches, tmap, pp)


def replicate(tree, mesh: Mesh):
    """Place a pytree fully replicated on the mesh."""
    sharding = NamedSharding(mesh, P())
    return jax.tree_util.tree_map(
        lambda x: jax.device_put(x, sharding) if hasattr(x, "shape") else x,
        tree,
    )


def replay_fused_dp(states, batches, tmap, pp, ps, mesh: Mesh,
                    axis: str = "dp"):
    """Data-parallel FUSED replay: a batch of independent logs, one full
    pipeline (IMU sub-scan + deskew + ICP + EKF) per ``axis`` shard.

    ``states``/``batches`` carry a leading batch axis (a multiple of the
    mesh's ``axis`` size); the map and parameters are replicated. This is the
    fleet/parallel-log-replay scaling mode: zero cross-shard communication,
    XLA partitions the vmapped program over the devices.
    """
    batch_sharding = NamedSharding(mesh, P(axis))
    states = jax.tree_util.tree_map(
        lambda x: jax.device_put(x, batch_sharding), states
    )
    batches = jax.tree_util.tree_map(
        lambda x: jax.device_put(x, batch_sharding), batches
    )
    tmap = replicate(tmap, mesh)
    return _replay_fused_dp_jit(states, batches, tmap, pp, ps)


@functools.cache
def _replay_dp_inner():
    # deferred: pipeline.runtime imports this package
    from ..pipeline.runtime import replay_fused

    return jax.jit(
        jax.vmap(replay_fused, in_axes=(0, 0, None, None, None)),
        static_argnums=(4,),
    )


def _replay_fused_dp_jit(states, batches, tmap, pp, ps):
    """Module-level jit cache: a fresh closure per call would re-trace and
    recompile the fused pipeline on every invocation."""
    return _replay_dp_inner()(states, batches, tmap, pp, ps)


def stack_streams(trees):
    """Stack a list of identically-shaped pytrees (states or fused-batch
    dicts) along a new leading lane axis."""
    import jax.numpy as jnp

    return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *trees)


def replay_fused_fleet(states, batches, tmap, pp, ps):
    """Multi-stream fused replay on the CURRENT device set without a mesh:
    ``B`` independent logs vmapped over a leading lane axis, one shared map.

    This is the single-device serving/fleet mode (B vehicles localized by
    one card): the per-frame tensors are small enough that lanes amortize
    the fixed per-frame dispatch/fusion overhead. For a multi-device fleet use
    :func:`replay_fused_dp`, which is the same vmapped program with the lane
    axis sharded over the mesh. Lane trajectories are identical to
    single-stream :func:`~elimaloc_tpu.pipeline.runtime.replay_fused` runs
    (vmap does not change the math; the batched ICP while_loop iterates
    until every lane's gates release, masked per lane).

    ``states``/``batches`` carry the leading lane axis (see
    :func:`stack_streams`).
    """
    return _replay_dp_inner()(states, batches, tmap, pp, ps)
