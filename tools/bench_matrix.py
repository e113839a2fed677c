"""Throughput matrix: ratios x DCT algorithms (BASELINE configs 2 & 3).

Batch 8 x 1080p, device-resident inputs, the same program as bench.py:
the jitted program returns the per-image payload bytes AND bit counts (so
the u32->byte serialization is part of the measurement, exactly like a
production encode). Timing enqueues K encodes and then fetches one scalar
of the last, which waits for all K; K is calibrated for a run of a few
seconds.

Prints one markdown table row per configuration.
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from jpeg_encoder_tpu.utils import compile_cache  # noqa: E402

compile_cache.enable()
import jax  # noqa: E402
import jax.numpy as jnp
import numpy as np

from jpeg_encoder_tpu import pipeline
from jpeg_encoder_tpu.config import DctAlgorithm, EncoderConfig

H, W, B = 1088, 1920, 8
MIN_TIMED_SECONDS = 3.0
key = jax.random.key(0)
base = jax.random.uniform(key, (B, H // 8, W // 8, 3))
img = jax.image.resize(base, (B, H, W, 3), "linear")
noise = jax.random.uniform(jax.random.key(100), (B, H, W, 3)) * 0.1
images = ((img * 0.9 + noise) * 255).astype(jnp.uint8)

print("| ratio | algorithm | Mpixel/s |")
print("|---|---|---|")
for ratio in [(4, 2, 0), (4, 2, 2), (4, 4, 4)]:
    for algo in [DctAlgorithm.REAL_DCT, DctAlgorithm.BIN_DCT]:
        config = EncoderConfig(subsampling_ratio=ratio, dct_algorithm=algo)
        geom = config.geometry(W, H)
        cap = pipeline.default_capacity_bytes(
            geom, config.capacity_bytes_per_pixel)

        @jax.jit
        def go(imgs, geom=geom, algo=algo, cap=cap):
            def one(rgb):
                out = pipeline.encode_core(
                    rgb, geom, algo, cap, with_coeffs=False)
                return out["payload"], out["total_bits"]
            return jax.vmap(one)(imgs)

        def timed_run(iters):
            t0 = time.perf_counter()
            for _ in range(iters):
                _, bits = go(images)
            np.asarray(bits[0])
            return time.perf_counter() - t0

        _, bits = go(images)
        _ = np.asarray(bits[0])
        for _ in range(2):
            timed_run(1)
        est = timed_run(4) / 4
        iters = max(8, min(2048, int(MIN_TIMED_SECONDS / max(est, 1e-5))))
        dt = timed_run(iters) / iters
        name = ":".join(str(x) for x in ratio)
        print(f"| {name} | {algo.value} | {B*H*W/dt/1e6:.0f} |", flush=True)
