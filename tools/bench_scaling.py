"""Scaling-efficiency harness: per-device throughput over 1..N devices.

The data-parallel batch path (parallel/batch.py) has no cross-device
communication, so efficiency loss can only come from dispatch overhead
and host-side result handling:

* with >1 attached device (several GPUs, or the CPU mesh via
  --virtual-devices N): runs the shard_map batch encoder over meshes of
  1, 2, 4, ... N devices with a proportionally growing batch (weak
  scaling) and reports per-device throughput + efficiency vs 1 device;
* ``--batch-curve`` records the batch-size scaling curve (batch 1/2/4/8
  on one device) — the dispatch-overhead proxy: if doubling the batch
  doubles throughput until compute saturates, per-device work dominates
  fixed overhead and the multi-device DP path (identical per-device
  program, zero collectives) inherits that profile.

Timing enqueues K encodes, then fetches one scalar of the last (which
waits for all K).

    python tools/bench_scaling.py --batch-curve          # one device
    python tools/bench_scaling.py --virtual-devices 8    # CPU mesh demo
    python tools/bench_scaling.py                        # all devices
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument(
        "--virtual-devices", type=int, default=0,
        help="force the CPU backend with N virtual devices (harness demo / "
        "CI; real runs use whatever devices are attached)",
    )
    parser.add_argument(
        "--batch-curve", action="store_true",
        help="single-device batch-size curve (dispatch-overhead proxy)",
    )
    parser.add_argument("--height", type=int, default=1088)
    parser.add_argument("--width", type=int, default=1920)
    parser.add_argument(
        "--per-device-batch", type=int, default=4,
        help="images per device in the weak-scaling sweep",
    )
    parser.add_argument("--min-seconds", type=float, default=3.0)
    args = parser.parse_args()

    if args.virtual_devices:
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={args.virtual_devices}"
        )

    import jax

    if args.virtual_devices:
        jax.config.update("jax_platforms", "cpu")
    from jpeg_encoder_tpu.utils import compile_cache

    compile_cache.enable()

    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh

    from jpeg_encoder_tpu import pipeline
    from jpeg_encoder_tpu.config import EncoderConfig
    from jpeg_encoder_tpu.parallel.batch import compiled_batch_encoder
    from jpeg_encoder_tpu.parallel.mesh import DATA_AXIS

    height, width = args.height, args.width
    config = EncoderConfig(subsampling_ratio=(4, 2, 0))
    geom = config.geometry(width, height)
    capacity = pipeline.default_capacity_bytes(
        geom, config.capacity_bytes_per_pixel
    )

    def make_batch(batch: int) -> jnp.ndarray:
        """Smooth-ish content generated on device (see bench.py)."""
        key = jax.random.key(7)
        base = jax.random.uniform(key, (batch, height // 8, width // 8, 3))
        img = jax.image.resize(base, (batch, height, width, 3), "linear")
        noise = (
            jax.random.uniform(jax.random.key(8), (batch, height, width, 3))
            * 0.1
        )
        return ((img * 0.9 + noise) * 255).astype(jnp.uint8)

    def timed(encode, images, min_seconds: float) -> float:
        """Seconds per call: enqueue-K then fetch one scalar of the last."""
        _, bits = encode(images)
        np.asarray(bits[0])  # warm (compile happened on the caller's side)
        t0 = time.perf_counter()
        _, bits = encode(images)
        np.asarray(bits[0])
        est = max(time.perf_counter() - t0, 1e-5)
        iters = max(4, min(2048, int(min_seconds / est)))
        t0 = time.perf_counter()
        for _ in range(iters):
            _, bits = encode(images)
        np.asarray(bits[0])
        return (time.perf_counter() - t0) / iters

    devices = jax.devices()
    log(f"backend {jax.default_backend()}, {len(devices)} device(s), "
        f"{width}x{height} RealDCT 4:2:0")

    rows = []
    if args.batch_curve or len(devices) == 1:
        mesh = Mesh(np.array(devices[:1]), (DATA_AXIS,))
        encode = compiled_batch_encoder(
            mesh, geom, config.dct_algorithm, capacity
        )
        base_mpix = None
        for batch in (1, 2, 4, 8):
            images = jax.block_until_ready(make_batch(batch))
            sec = timed(encode, images, args.min_seconds)
            mpix = batch * height * width / sec / 1e6
            if base_mpix is None:
                base_mpix = mpix
            rows.append((
                f"batch {batch}", mpix, mpix / batch,
                mpix / (base_mpix * batch),
            ))
            log(f"batch {batch}: {sec * 1e3:.2f} ms/call, {mpix:.1f} Mpix/s "
                f"({mpix / batch:.1f}/image, "
                f"{mpix / (base_mpix * batch):.1%} vs linear-from-batch-1)")
        print("\n| config | Mpix/s | Mpix/s per image | vs linear |")
        print("|---|---|---|---|")
        for name, mpix, per, eff in rows:
            print(f"| {name} | {mpix:.1f} | {per:.1f} | {eff:.1%} |")
        return 0

    # Weak-scaling sweep over device counts (1, 2, 4, ... N).
    counts = [d for d in (1, 2, 4, 8, 16, 32) if d <= len(devices)]
    base_per_dev = None
    for n_dev in counts:
        mesh = Mesh(np.array(devices[:n_dev]), (DATA_AXIS,))
        encode = compiled_batch_encoder(
            mesh, geom, config.dct_algorithm, capacity
        )
        batch = n_dev * args.per_device_batch
        images = jax.block_until_ready(make_batch(batch))
        sec = timed(encode, images, args.min_seconds)
        mpix = batch * height * width / sec / 1e6
        per_dev = mpix / n_dev
        if base_per_dev is None:
            base_per_dev = per_dev
        rows.append((n_dev, mpix, per_dev, per_dev / base_per_dev))
        log(f"{n_dev} device(s): {sec * 1e3:.2f} ms/call, {mpix:.1f} Mpix/s "
            f"aggregate, {per_dev:.1f}/device "
            f"({per_dev / base_per_dev:.1%} efficiency)")
    print("\n| devices | aggregate Mpix/s | per-device Mpix/s | efficiency |")
    print("|---|---|---|---|")
    for n_dev, mpix, per_dev, eff in rows:
        print(f"| {n_dev} | {mpix:.1f} | {per_dev:.1f} | {eff:.1%} |")
    return 0


if __name__ == "__main__":
    sys.exit(main())
