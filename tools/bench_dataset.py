"""File-to-file dataset benchmark: BMPs on disk in -> JPEGs on disk out.

The honest end-to-end number for the scale configs (BASELINE configs 4/5):
unlike bench.py's device-resident enqueue-K measurement, this pays every
real leg — BMP decode (native threaded loader), sharded H2D, device
compute, D2H fetch, 0xFF stuffing, file writes — through the overlapped
decode | compute | write engine (parallel/stream.py). Also records peak
host RSS and peak device HBM, pinning the memory-boundedness of the
chunked dispatch (parallel/batch.chunk_size_images).

Usage:
    python tools/bench_dataset.py [--images N] [--width W] [--height H]
        [--dir DIR] [--keep] [--ratio 4:2:0] [--chunk-budget BYTES]

Generates N BMPs of corpus-class content (deterministic), encodes them via
multihost.encode_dataset (the --dataset CLI body), verifies a sample
against the single-image path, and prints one JSON line.
"""

import argparse
import json
import os
import resource
import shutil
import sys
import tempfile
import time

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

from jpeg_encoder_tpu.utils import compile_cache  # noqa: E402

compile_cache.enable()
import jax  # noqa: E402
import numpy as np  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--images", type=int, default=100)
    ap.add_argument("--width", type=int, default=3840)
    ap.add_argument("--height", type=int, default=2160)
    ap.add_argument("--dir", default="")
    ap.add_argument("--keep", action="store_true")
    ap.add_argument("--ratio", default="4:2:0")
    ap.add_argument("--optimize", action="store_true",
                    help="per-image optimized Huffman (pipelined two-pass)")
    ap.add_argument("--chunk-budget", type=int, default=0)
    ap.add_argument("--verify", type=int, default=3,
                    help="sample size for byte-identity vs single-image")
    args = ap.parse_args()

    if args.chunk_budget:
        from jpeg_encoder_tpu.parallel import batch as batch_lib

        batch_lib.chunk_input_budget = lambda: args.chunk_budget

    from jpeg_encoder_tpu import pipeline
    from jpeg_encoder_tpu.config import EncoderConfig, parse_subsampling_ratio
    from jpeg_encoder_tpu.io import bmp
    from jpeg_encoder_tpu.parallel import multihost
    from jpeg_encoder_tpu.utils import corpus

    root = args.dir or tempfile.mkdtemp(prefix="jpeg_tpu_ds_")
    src = os.path.join(root, "bmp")
    out = os.path.join(root, "out")
    os.makedirs(src, exist_ok=True)

    # Deterministic corpus-class content, tiled up to the target size.
    # Generating N full 4K spectral images is slow; instead build 4 base
    # images (one per content class) and emit byte-varied copies (a
    # per-image brightness offset) so every file still decodes/encodes
    # uniquely but generation stays O(4) spectral synths.
    h, w = args.height, args.width
    print(f"generating {args.images} {w}x{h} BMPs into {src} ...",
          file=sys.stderr)
    bases = []
    for name, img in corpus.images(h=h, w=w).items():
        bases.append(img)
    t0 = time.perf_counter()
    paths = []
    for i in range(args.images):
        p = os.path.join(src, f"img{i:04d}.bmp")
        paths.append(p)
        if os.path.exists(p):
            continue
        img = bases[i % len(bases)]
        if i >= len(bases):
            img = ((img.astype(np.int16) + (i * 7) % 32) % 256).astype(
                np.uint8
            )
        bmp.write(p, img)
    gen_s = time.perf_counter() - t0
    print(f"generated in {gen_s:.1f}s", file=sys.stderr)

    config = EncoderConfig(
        subsampling_ratio=parse_subsampling_ratio(args.ratio),
        optimize_huffman=args.optimize,
    )

    dev = jax.devices()[0]
    # Warm the compile caches so the measurement is the steady-state
    # pipeline, not one-time compilation (the CLI's AOT cache gives real
    # cold starts the same steady state after the first run).
    from jpeg_encoder_tpu.parallel import batch as batch_lib
    from jpeg_encoder_tpu.parallel import mesh as mesh_lib

    geom = config.geometry(w, h)
    n_dev = len(jax.local_devices())
    chunk = batch_lib.chunk_size_images(geom, n_dev)
    # Warm every dispatch-ladder rung the run will hit: full chunks plus
    # the final remainder's rung.
    rungs = {min(chunk, args.images)}
    rem = args.images % chunk if args.images > chunk else 0
    if rem:
        rungs.add(batch_lib._dispatch_size(rem, n_dev, chunk))
    warm = np.zeros((1, h, w, 3), np.uint8)
    for rung in sorted(rungs):
        batch_lib.encode_batch(
            np.broadcast_to(warm, (rung, h, w, 3)), config,
            mesh_lib.data_mesh()
        )
    print(f"warmed rungs {sorted(rungs)} (chunk={chunk}) over {n_dev} "
          "device(s)", file=sys.stderr)

    rss0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    t0 = time.perf_counter()
    result = multihost.encode_dataset(paths, out, config, resume=False)
    wall = time.perf_counter() - t0
    rss_peak_kb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    try:
        mem = dev.memory_stats()
        hbm_peak = int(mem.get("peak_bytes_in_use", 0))
    except Exception:
        hbm_peak = -1

    # Spot check: byte-identity vs the single-image path (fixed tables),
    # or — in optimize mode, whose single-image programs would be fresh
    # multi-minute compiles here while the batched-vs-single identity is
    # already pinned by the CPU suite — an independent PIL decode.
    for i in range(0, args.images, max(1, args.images // args.verify))[
        : args.verify
    ]:
        with open(os.path.join(out, f"img{i:04d}.jpeg"), "rb") as f:
            got = f.read()
        if args.optimize:
            import io as iolib

            from PIL import Image

            img = Image.open(iolib.BytesIO(got))
            img.load()
            assert img.size == (w, h), f"bad decode at image {i}"
        else:
            want = pipeline.encode_array(
                bmp.read(paths[i]), config
            ).file_bytes
            assert got == want, f"mismatch at image {i}"

    pixels = result.pixels
    line = {
        "metric": "dataset_file_to_file_throughput",
        "value": round(pixels / result.seconds / 1e6, 1),
        "unit": "Mpixel/s",
        "images": result.encoded,
        "optimize": args.optimize,
        "geometry": f"{w}x{h}",
        "chunk_images": chunk,
        "wall_seconds": round(wall, 2),
        "encode_seconds": round(result.seconds, 2),
        "decode_seconds": round(result.decode_seconds, 2),
        "write_seconds": round(result.write_seconds, 2),
        "output_mb": round(result.output_bytes / 1e6, 1),
        "host_rss_peak_mb": round(rss_peak_kb / 1024, 1),
        "host_rss_before_mb": round(rss0 / 1024, 1),
        "device_hbm_peak_mb": round(hbm_peak / 1e6, 1),
        "verified_byte_identical": args.verify,
    }
    print(json.dumps(line))
    if not args.keep and not args.dir:
        shutil.rmtree(root)


if __name__ == "__main__":
    main()
