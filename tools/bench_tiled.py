"""Tiled (MCU-band) encode throughput on hardware: one 4K image.

Times the jitted band-sharded program (parallel/tiled.compiled_tiled_encoder)
on a 1-device mesh against the plain single-image program
(pipeline.encode_core) on the same device-resident 4K input (enqueue K
encodes, then fetch one scalar of the last). This records what the tiled
MODE costs on hardware (its program structure: shard_map, ppermute DC
exchange, per-band capacity), separate from the virtual-mesh correctness
tests.

    python tools/bench_tiled.py [height width]
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
from jax.sharding import Mesh

from jpeg_encoder_tpu import pipeline
from jpeg_encoder_tpu.config import DctAlgorithm, EncoderConfig
from jpeg_encoder_tpu.parallel import tiled
from jpeg_encoder_tpu.parallel.mesh import DATA_AXIS

H = int(sys.argv[1]) if len(sys.argv) > 1 else 2160
W = int(sys.argv[2]) if len(sys.argv) > 2 else 3840
MIN_TIMED_SECONDS = 3.0

config = EncoderConfig(subsampling_ratio=(4, 2, 0))
geom = config.geometry(W, H)

key = jax.random.key(0)
base = jax.random.uniform(key, (H // 8, W // 8, 3))
img = jax.image.resize(base, (H, W, 3), "linear")
noise = jax.random.uniform(jax.random.key(100), (H, W, 3)) * 0.1
rgb = ((img * 0.9 + noise) * 255).astype(jnp.uint8)


def timed(go, fetch_bits, label, pixels):
    bits = fetch_bits(go())
    _ = np.asarray(bits)
    for _ in range(2):
        go()
        _ = np.asarray(fetch_bits(go()))
    t0 = time.perf_counter()
    _ = np.asarray(fetch_bits(go()))
    est = max(time.perf_counter() - t0, 1e-5)
    iters = max(8, min(2048, int(MIN_TIMED_SECONDS / est)))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = go()
    _ = np.asarray(fetch_bits(out))
    dt = (time.perf_counter() - t0) / iters
    print(f"{label:28s} {dt*1e3:8.2f} ms  {pixels/dt/1e6:7.1f} Mpix/s",
          flush=True)
    return dt


# --- plain single-image program ---
cap = pipeline.default_capacity_bytes(geom, config.capacity_bytes_per_pixel)


@jax.jit
def plain(x):
    out = pipeline.encode_core(
        x, geom, DctAlgorithm.REAL_DCT, cap, with_coeffs=False
    )
    return out["payload"], out["total_bits"]


timed(lambda: plain(rgb), lambda o: o[1], f"plain {W}x{H}", H * W)

# --- tiled program, 1-device mesh (band == whole image) ---
mesh = Mesh(np.array(jax.devices()[:1]), (DATA_AXIS,))
band_rows = tiled._band_rows(geom, 1)
band_h = band_rows * 8 * geom.v_factor
padded = jnp.zeros((band_h, W, 3), jnp.uint8).at[:H].set(rgb)
band_cap = pipeline.default_capacity_bytes(
    tiled._band_geometry(geom, band_h), config.capacity_bytes_per_pixel
)
enc = tiled.compiled_tiled_encoder(
    mesh, geom, DctAlgorithm.REAL_DCT, band_cap
)
timed(lambda: enc(padded), lambda o: o[1][0], "tiled 1-band mesh", H * W)
