"""Measured memory/FMA roofline model of the fused frame (recorded by
bench.py).

These helpers measure the card the bench runs on instead of quoting a data
sheet, and set the frame's analytic cost against those ceilings:

- :func:`measure_hbm_gbps`: a resident 256 MB f32 buffer updated in place
  (``x*a+b``) inside a fori_loop — 2 bytes moved per element-op per pass
  (read + write), amortized over many passes.
- :func:`measure_fma_gflops`: a long f32 FMA chain on a 1 MB [2048,128]
  block inside a fori_loop — flops = 2 * chain * size * iters; the block
  stays on chip, so this isolates the f32 arithmetic units (no tensor
  cores: the package pins matmul precision to ``highest``).
- :func:`frame_model`: an analytic byte/flop count of the fused frame at
  bench shapes (same constants as bench.py's FLOP model, plus a byte model
  of what actually re-reads device memory per GN iteration: the halo
  coordinate blocks).

Together they give the per-frame memory-bound and FMA-bound lower-bound
times to put next to the measured frame time: how far the pipeline sits
from ITS OWN roofline. Reference frame being modeled:
voxel_hash_map.cpp:31-88 + registration.cpp:15-66 hot loops.
"""
import time

import numpy as np

import jax
import jax.numpy as jnp


def _time(fn, *args):
    """Best-of-3 wall time of fn(*args), waited for with block_until_ready
    (the first call compiles and is not timed)."""
    jax.block_until_ready(fn(*args))
    best = np.inf
    for _ in range(3):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best


def measure_hbm_gbps(mb=256, passes=40):
    n = mb * (1 << 20) // 4
    x = jnp.ones((n,), jnp.float32)

    @jax.jit
    def run(x):
        def body(_, x):
            return x * 1.0000001 + 1e-7
        return jax.lax.fori_loop(0, passes, body, x)

    dt = _time(run, x)
    gb = passes * 2 * n * 4 / 1e9  # read + write per pass
    return gb / dt


def measure_fma_gflops(chain=256, iters=400):
    x = jnp.ones((2048, 128), jnp.float32)
    a = jnp.float32(1.0000001)
    b = jnp.float32(1e-9)

    @jax.jit
    def run(x):
        def body(_, x):
            for _ in range(chain):
                x = x * a + b
            return x
        return jax.lax.fori_loop(0, iters, body, x)

    dt = _time(run, x)
    flops = 2 * chain * iters * x.size
    return flops / dt / 1e9


def frame_model(pipe, outs, batches):
    """Per-frame device-memory bytes and f32 flops at the bench shapes (see
    bench.bench_headline for the flop constants). Returns (flops, bytes, iters)
    where iters is the mean GN iterations per frame actually executed."""
    n = int(np.asarray(outs["applied"]).shape[0])
    iters = int(np.asarray(outs["iterations"]).sum()) / n
    tb = pipe.static.icp_static.tile_budget
    s, qb = tb.max_slots, tb.qb
    mhp = int(pipe.map.halo_points.shape[1])
    dsp = pipe.static.ds_points
    n_imu = int(batches["imu_t"].shape[1])
    n_raw = int(batches["scan_points"].shape[1])

    flops = (
        iters * (s * qb * mhp * 16 + dsp * 400)
        + n_imu * 81_000
        + n_raw * 80
    )
    # device-memory re-reads per frame: halo coord blocks per GN iteration
    # (too big to stay on chip across iterations), raw scan points twice
    # (gate + deskew read, downsample read) + sort traffic ~ 4 passes of 8 lanes,
    # slot scatter write, per-iteration query/source slot buffers.
    halo = s * mhp * 3 * 4
    bytes_ = (
        iters * (halo + 2 * s * qb * 3 * 4)
        + n_raw * (4 * 4 + 3 * 4)            # gate+normalize+deskew pass
        + 4 * n_raw * 8 * 4                  # multi-operand sort passes
        + s * qb * 3 * 4                     # slot scatter
        + n_imu * 27 * 27 * 4 * 2            # P in/out per predict
    )
    return flops, bytes_, iters


def roofline_report(pipe, outs, batches, frame_ms):
    """Full roofline record for the bench JSON: measured ceilings + model
    bounds + the measured/bound fraction (1.0 = at the roofline)."""
    hbm = measure_hbm_gbps()
    fma = measure_fma_gflops()
    flops, bytes_, iters = frame_model(pipe, outs, batches)
    t_fma_ms = flops / (fma * 1e9) * 1e3
    t_hbm_ms = bytes_ / (hbm * 1e9) * 1e3
    bound_ms = max(t_fma_ms, t_hbm_ms)
    return dict(
        hbm_gbps=round(hbm, 1),
        fma_tflops=round(fma / 1e3, 3),
        model_gn_iters_per_frame=round(iters, 2),
        fma_bound_ms=round(t_fma_ms, 3),
        hbm_bound_ms=round(t_hbm_ms, 3),
        bound_kind="FMA" if t_fma_ms > t_hbm_ms else "HBM",
        measured_frame_ms=round(frame_ms, 3),
        # fraction of the frame's own roofline it achieves (bound/measured):
        # >=0.5 means the remaining gap is dependency-chain/dispatch, not
        # unexploited arithmetic or bandwidth
        roofline_frac=round(bound_ms / frame_ms, 3) if frame_ms else None,
    )
