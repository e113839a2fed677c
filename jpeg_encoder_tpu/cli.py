"""Command-line interface: BMP -> baseline JPEG.

Feature-parity with the reference CLI (arguments.rs:4-67, main.rs:8-68):
`--image` (required, must end in .bmp), `--output` (defaults to the input
path with a .jpeg suffix), `--subsampling-ratio {4:4:4,4:2:2,4:2:0}`
(default 4:2:0), `--dct-algorithm {real-dct,bin-dct}` (default real-dct),
plus extensions: multi-image batch input (globs), datasets, fast-DCT mode,
quality scaling, optimized Huffman tables, restart markers, band tiling
over several devices, and stage timing.
"""

from __future__ import annotations

import argparse
import glob as globlib
import json
import sys
import time

from jpeg_encoder_tpu.config import (
    DctAlgorithm,
    EncoderConfig,
    parse_subsampling_ratio,
)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="jpeg-encoder-tpu",
        description="BMP to baseline JPEG (JFIF) encoder on JAX devices",
    )
    parser.add_argument(
        "-i", "--image", action="append", default=None,
        help="input BMP path or glob (repeatable; must end in .bmp)",
    )
    parser.add_argument(
        "--dataset", default="", metavar="DIR",
        help="encode every .bmp in DIR (top level) as a (multi-host-shardable) "
        "dataset: each process takes a strided share, writes outputs plus "
        "a resumable manifest into -o, and the final summary aggregates "
        "over all processes (BASELINE config 5). Single-process runs "
        "encode everything locally",
    )
    parser.add_argument(
        "--coordinator", default="", metavar="HOST:PORT",
        help="with --dataset: jax.distributed coordinator address for "
        "multi-process runs (every process passes the same address)",
    )
    parser.add_argument(
        "--process-id", type=int, default=None, metavar="N",
        help="with --coordinator: this process's index in 0..num-processes",
    )
    parser.add_argument(
        "--num-processes", type=int, default=None, metavar="M",
        help="with --coordinator: total process count",
    )
    parser.add_argument(
        "--no-resume", action="store_true",
        help="with --dataset: re-encode files the manifest already records "
        "instead of skipping them",
    )
    parser.add_argument(
        "-o", "--output", default="",
        help="output JPEG path (default: input path with .jpeg suffix; "
        "for batch input, a directory)",
    )
    parser.add_argument(
        "-s", "--subsampling-ratio", default="4:2:0",
        help="chroma subsampling ratio: 4:4:4, 4:2:2 or 4:2:0 (default 4:2:0)",
    )
    parser.add_argument(
        "-d", "--dct-algorithm", default="real-dct",
        choices=[a.value for a in DctAlgorithm],
        help="DCT algorithm (default real-dct)",
    )
    parser.add_argument(
        "--bin-dct-descale", action="store_true",
        help="with -d bin-dct: fold the lifting network's diagonal gains "
        "into quantization (the corrected binDCT-C) instead of reproducing "
        "the reference's de-scaling bug",
    )
    parser.add_argument(
        "-q", "--quality", type=int, default=None, metavar="1..100",
        help="scale the quantization tables with the standard libjpeg "
        "quality formula (50 = the default Annex-K tables; higher = better "
        "fidelity, bigger files). Omit for reference-parity fixed tables",
    )
    parser.add_argument(
        "--optimize-huffman", action="store_true",
        help="two-pass encode with per-image optimal Huffman tables "
        "(smaller files, custom DHT segments; libjpeg's -optimize analog). "
        "Off by default (reference parity: fixed Annex-K tables)",
    )
    parser.add_argument(
        "--restart-interval", type=int, default=None, metavar="N",
        help="emit DRI/RSTn restart markers every N MCUs: each interval is "
        "an independently decodable scan segment (DC predictors reset, "
        "byte-aligned), making the file parallel-decodable. Off by default "
        "(reference parity: one unbroken scan)",
    )
    parser.add_argument(
        "--fast-dct", action="store_true",
        help="use the matmul RealDCT (fastest; quantized coefficients may "
        "differ from the scalar reference in ~1e-5 of values, by one step)",
    )
    parser.add_argument(
        "--devices", type=int, default=0, metavar="N",
        help="mesh size: shard work over the first N attached devices "
        "(default: all devices for batch input, single-device otherwise)",
    )
    parser.add_argument(
        "--tile-bands", action="store_true",
        help="single-image mode: shard the image's MCU-row bands across "
        "the device mesh (DC predictors chained between devices), instead "
        "of encoding it on one device",
    )
    parser.add_argument(
        "--timing", action="store_true", help="print per-image timing as JSON"
    )
    parser.add_argument(
        "--trace", default="", metavar="DIR",
        help="capture a jax.profiler trace of the encode into DIR "
        "(view with TensorBoard / xprof)",
    )
    return parser


def default_output_path(image_path: str) -> str:
    return image_path[: -len(".bmp")] + ".jpeg"


def _maybe_trace(trace_dir: str):
    """jax.profiler trace context when --trace is given (else a no-op).

    The reference's only observability is println! stage banners
    (main.rs:16-67); the equivalent here is a real profiler trace of
    the device program plus the --timing JSON counters.
    """
    import contextlib

    if not trace_dir:
        return contextlib.nullcontext()
    import jax

    return jax.profiler.trace(trace_dir)


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)

    if not args.image and not args.dataset:
        print("error: provide --image or --dataset", file=sys.stderr)
        return 2

    inputs: list[str] = []
    for pattern in args.image or []:
        matches = sorted(globlib.glob(pattern)) or [pattern]
        inputs.extend(matches)
    for path in inputs:
        if not path.endswith(".bmp"):
            print(f"error: input image must be a .bmp file: {path}", file=sys.stderr)
            return 2

    try:
        ratio = parse_subsampling_ratio(args.subsampling_ratio)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    try:
        config = EncoderConfig(
            subsampling_ratio=ratio,
            dct_algorithm=DctAlgorithm(args.dct_algorithm),
            fast_dct=args.fast_dct,
            bin_dct_descale=args.bin_dct_descale,
            quality=args.quality,
            restart_interval=args.restart_interval,
            optimize_huffman=args.optimize_huffman,
        )
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    if args.dataset:
        return _run_dataset(inputs, args, config)
    if len(inputs) > 1:
        return _run_batch(inputs, args, config)

    image_path = inputs[0]
    output_path = args.output or default_output_path(image_path)
    print(f'image: "{image_path}"')
    print(f'output: "{output_path}"')
    print(f'subsampling ratio: "{ratio}"')
    print(f'dct algorithm: "{args.dct_algorithm}"')
    print()

    from jpeg_encoder_tpu.utils import aot_cache, compile_cache

    compile_cache.enable()  # cold starts pay the compile ONCE per config
    aot_cache.enable()  # ... and later starts skip even trace+lower
    from jpeg_encoder_tpu import pipeline  # defer jax import past arg errors
    from jpeg_encoder_tpu.io import bmp

    # Stage banners match the reference's println! sequence (main.rs:16-67).
    # Note the middle three stages are ONE fused device program here
    # (pipeline.encode_core), so their banners bracket a single dispatch;
    # they mark reference-parity checkpoints, not separate host stages.
    t0 = time.perf_counter()
    try:
        with _maybe_trace(args.trace):
            print("Loading bmp...")
            rgb = bmp.read(image_path)
            print("Loaded!")
            print("Chrominance downsampling...")
            print("Done!")
            print("Performing Discrete Cosine Transform + Quantization...")
            print("Done!")
            print("Entropy encoding...")
            if args.tile_bands:
                from jpeg_encoder_tpu.parallel import mesh as mesh_lib
                from jpeg_encoder_tpu.parallel import tiled

                mesh = mesh_lib.data_mesh(args.devices or None)
                result = tiled.encode_tiled(rgb, config, mesh)
            else:
                result = pipeline.encode_array(rgb, config)
            print("Done!")
            print("Creating file")
            with open(output_path, "wb") as f:
                f.write(result.file_bytes)
            print("Done!")
    except (OSError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    elapsed = time.perf_counter() - t0
    print(f"wrote {output_path} ({len(result.file_bytes)} bytes)")
    if args.timing:
        pixels = result.geom.width * result.geom.height
        print(json.dumps({
            "seconds": elapsed,
            "megapixels_per_second": pixels / elapsed / 1e6,
            "output_bytes": len(result.file_bytes),
        }))
    return 0


def _run_dataset(inputs: list[str], args, config: EncoderConfig) -> int:
    """Multi-host dataset mode: the CLI surface for BASELINE config 5.

    Wires parallel/multihost: distributed rendezvous (when --coordinator
    is given), strided file assignment by process index, batch encode over
    this process's local devices, a resumable per-process manifest, and a
    cross-process summary allgather. The reference's only interface is its
    CLI (main.rs:8-68); this makes our flagship scale mode drivable the
    same way.
    """
    import os

    from jpeg_encoder_tpu.utils import aot_cache, compile_cache

    compile_cache.enable()
    aot_cache.enable()
    from jpeg_encoder_tpu.parallel import multihost

    kwargs = {}
    if args.coordinator:
        kwargs["coordinator_address"] = args.coordinator
        if args.num_processes is not None:
            kwargs["num_processes"] = args.num_processes
        if args.process_id is not None:
            kwargs["process_id"] = args.process_id
    try:
        idx, count = multihost.initialize(**kwargs)
    except (RuntimeError, ValueError) as e:
        print(f"error: distributed initialization failed: {e}",
              file=sys.stderr)
        return 1

    paths = sorted(globlib.glob(os.path.join(args.dataset, "*.bmp")))
    paths.extend(inputs)
    if not paths:
        print(f"error: no .bmp files under {args.dataset}", file=sys.stderr)
        return 1
    out_dir = args.output or "."

    t0 = time.perf_counter()
    try:
        result = multihost.encode_dataset(
            paths, out_dir, config, resume=not args.no_resume
        )
    except (OSError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    summary = multihost.global_summary(result)
    elapsed = time.perf_counter() - t0
    line = {
        "process_index": idx,
        "process_count": count,
        "encoded": result.encoded,
        "skipped": result.skipped,
        "output_bytes": result.output_bytes,
        "manifest": result.manifest_path,
        "summary": summary,
    }
    if args.timing:
        line["seconds"] = elapsed
        if result.seconds > 0:
            # File-to-file throughput of THIS process's encode loop (the
            # honest end-to-end number: BMPs on disk in, JPEGs out).
            line["megapixels_per_second"] = (
                result.pixels / result.seconds / 1e6
            )
            line["decode_seconds"] = result.decode_seconds
            line["write_seconds"] = result.write_seconds
    print(json.dumps(line))
    return 0


def _run_batch(inputs: list[str], args, config: EncoderConfig) -> int:
    """Batch encode through the overlapped decode | compute | write engine.

    Images load through the native threaded BMP loader and encode as
    chunked, sharded device batches (parallel/stream.py + batch.py) —
    BMP decode of chunk k+1 and file writes of chunk k-1 run concurrently
    with chunk k's device program. On a single device each dispatch is a
    vmapped program; on several each device takes a slice of the batch.
    """
    import os

    from jpeg_encoder_tpu.utils import aot_cache, compile_cache

    compile_cache.enable()
    aot_cache.enable()
    from jpeg_encoder_tpu.parallel import mesh as mesh_lib
    from jpeg_encoder_tpu.parallel import stream

    out_dir = args.output or "."
    os.makedirs(out_dir, exist_ok=True)

    mesh = mesh_lib.data_mesh(args.devices or None)

    def emit(path: str, data: bytes):
        name = os.path.splitext(os.path.basename(path))[0] + ".jpeg"
        with open(os.path.join(out_dir, name), "wb") as f:
            f.write(data)
        print(f"encoded {path} -> {os.path.join(out_dir, name)}")

    try:
        stats = stream.encode_paths(inputs, config, mesh, emit)
    except (OSError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1

    if args.timing:
        print(json.dumps({
            "images": stats.encoded,
            "seconds": stats.seconds,
            "megapixels_per_second": stats.pixels / stats.seconds / 1e6,
            "decode_seconds": stats.decode_seconds,
            "write_seconds": stats.write_seconds,
        }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
