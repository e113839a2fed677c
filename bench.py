"""Throughput benchmark: steady-state single-device encode rate.

Prints ONE JSON line: {"metric", "value", "unit", "device"}.

Measures the full device encode program (color convert -> subsample ->
RealDCT -> quantize -> run-length -> Huffman bit packing) on a batch of
1080p images resident on device, in Mpixel/s of *original image* pixels.
Input data is generated on device (jax PRNG), so the number excludes the
host->device transfer of the inputs. Details, including the card's name
and power limit where nvidia-smi is present, go to stderr; the JSON line
is the only stdout output.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import time

from jpeg_encoder_tpu.utils import compile_cache

compile_cache.enable()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from jpeg_encoder_tpu import pipeline  # noqa: E402
from jpeg_encoder_tpu.config import DctAlgorithm, EncoderConfig  # noqa: E402

HEIGHT, WIDTH = 1088, 1920  # 1080p rounded to an MCU multiple
BATCH = 8
WARMUP_ITERS = 2
MIN_TIMED_SECONDS = 3.0


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def gpu_name_and_power_limit() -> str | None:
    """`name, power.limit` of the cards as nvidia-smi reports them."""
    if shutil.which("nvidia-smi") is None:
        return None
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=30,
    ).stdout.strip()


def main() -> None:
    config = EncoderConfig(subsampling_ratio=(4, 2, 0))
    geom = config.geometry(WIDTH, HEIGHT)
    capacity = pipeline.default_capacity_bytes(
        geom, config.capacity_bytes_per_pixel
    )

    def make_batch(seed):
        key = jax.random.key(seed)
        # Smooth-ish synthetic content (pure noise over-weights the packer).
        base = jax.random.uniform(key, (BATCH, HEIGHT // 8, WIDTH // 8, 3))
        img = jax.image.resize(base, (BATCH, HEIGHT, WIDTH, 3), "linear")
        noise = jax.random.uniform(jax.random.key(seed + 1),
                                   (BATCH, HEIGHT, WIDTH, 3)) * 0.1
        return ((img * 0.9 + noise) * 255).astype(jnp.uint8)

    def encode_batch(images):
        def one(rgb):
            out = pipeline.encode_core(
                rgb, geom, DctAlgorithm.REAL_DCT, capacity, fast_dct=False,
                with_coeffs=False,
            )
            return out["payload"], out["total_bits"]
        return jax.vmap(one)(images)

    make_batch = jax.jit(make_batch, static_argnums=0)
    encode = jax.jit(encode_batch)

    device = jax.devices()[0]
    card = gpu_name_and_power_limit()
    if card:
        log(f"card: {card}")
    log(f"device: {device.platform} {device.device_kind}, batch {BATCH} x "
        f"{WIDTH}x{HEIGHT} RGB, RealDCT 4:2:0")

    images = jax.block_until_ready(make_batch(0))
    t0 = time.perf_counter()
    payloads, bits = jax.block_until_ready(encode(images))
    log(f"first call (incl. compile): {time.perf_counter() - t0:.2f}s, "
        f"mean payload {float(jnp.mean(bits)) / 8 / 1024:.1f} KiB")
    if int(jnp.max(bits)) > 8 * capacity:
        raise RuntimeError(
            "benchmark payload overflowed the capacity estimate; a "
            "production encode would retry with pipeline.next_capacity_bytes"
        )

    def timed_run(iters: int) -> float:
        t0 = time.perf_counter()
        for _ in range(iters):
            out = encode(images)
        jax.block_until_ready(out)
        return time.perf_counter() - t0

    for _ in range(WARMUP_ITERS):
        timed_run(1)

    pixels_per_iter = BATCH * HEIGHT * WIDTH
    est = timed_run(4) / 4
    iters = max(8, min(2048, int(MIN_TIMED_SECONDS / max(est, 1e-5))))
    elapsed = timed_run(iters)

    mpix_s = pixels_per_iter * iters / elapsed / 1e6
    log(f"steady state: {elapsed / iters * 1e3:.3f} ms/batch over {iters} "
        f"iters, {mpix_s:.2f} Mpixel/s")

    print(json.dumps({
        "metric": "encode_throughput_1080p_420_realdct",
        "value": mpix_s,
        "unit": "Mpixel/s",
        "device": {
            "platform": device.platform,
            "kind": device.device_kind,
            "count": len(jax.devices()),
        },
    }))


if __name__ == "__main__":
    main()
