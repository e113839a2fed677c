"""Smoke test on the card: the encoder's main path on a GPU, byte for byte.

Run from the root of a checkout on a machine with an NVIDIA GPU:

    python chip_smoke.py               # one card: phases device .. aot
    python chip_smoke.py --four-cards  # four cards: the multi-device paths

Phases on one card:

device  JAX must report platform "gpu". Prints the card's name and power
        limit (nvidia-smi) and whether the native host library loaded.
colour  All 2^24 RGB triples through the jitted colour conversion against
        oracle.rgb_to_ycbcr_exact: 0 mismatches.
dct     2^20 blocks of mixed content (noise, gradients, flat, binary)
        through ops/dct.dct_quantize_planes at qualities None, 35 and 90:
        the RealDCT ordered chain, binDCT and descaled binDCT with 0
        mismatches against the oracle; --fast-dct within one quantization
        step on at most 1e-4 of coefficients up to quality 50 and 5e-4
        above it (the shares are printed).
files   The CLI as users run it — one image, a multi-image stream and
        --dataset — on BMPs written from utils/corpus, then a 1080p matrix
        of ratios x DCT algorithms plus restart markers, optimized Huffman
        and quality 85. Every file must equal the oracle's file.
aot     Build the 512x512 4:2:0 AOT artifact, clear the in-process caches,
        load it back from disk and encode: identical bytes, and the
        artifact untouched on disk (the load path, not a silent rebuild).

With --four-cards only the multi-device paths run, on a 4-card mesh:
batch data parallelism over 8 x 1080p against single-device encodes; band
tiling of 4K images (even and uneven splits, restart framing) against
single-device encodes and the oracle; tiled optimized Huffman; and the AOT
cache in a process that sees four cards.

Each phase prints one line with its result and wall time; lines starting
with "info" are informational. The last line is one JSON object,
{"ok": true, "device": {"platform", "kind", "count"}}. A failed phase
raises: the script exits non-zero and prints no result line. Without a
GPU it exits non-zero before the first phase.
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import io
import json
import os
import shutil
import subprocess
import tempfile
import time

import numpy as np

from jpeg_encoder_tpu.utils import compile_cache

compile_cache.enable()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from jpeg_encoder_tpu import cli, native, oracle, pipeline, tables  # noqa: E402
from jpeg_encoder_tpu.config import DctAlgorithm, EncoderConfig  # noqa: E402
from jpeg_encoder_tpu.io import bmp, jfif  # noqa: E402
from jpeg_encoder_tpu.ops import color, dct  # noqa: E402
from jpeg_encoder_tpu.parallel import batch, mesh as mesh_lib, tiled  # noqa: E402
from jpeg_encoder_tpu.utils import aot_cache, corpus  # noqa: E402

HD = (1080, 1920)
UHD = (2160, 3840)


def fast_dct_max_share(quality: int | None) -> float:
    """--fast-dct's bound on coefficients one step off the reference.

    1e-4 with the default tables and up to quality 50 (config.py's
    fast_dct contract). The share grows as the quantization steps shrink,
    since more coefficients then sit near a step boundary (quality 90:
    2.1e-4 on the CPU backend), so above quality 50 the bound is the 5e-4
    regression bound of tests/test_ops.py.
    """
    return 1e-4 if quality is None or quality <= 50 else 5e-4


_CORPUS = (corpus.landscape, corpus.portrait, corpus.foliage,
           corpus.architecture)


class SmokeError(RuntimeError):
    """A phase found the system wrong."""


def check(condition: bool, message: str) -> None:
    if not condition:
        raise SmokeError(message)


def card_name_and_power_limit() -> str | None:
    """nvidia-smi's `name, power.limit` line(s), or None without it."""
    if shutil.which("nvidia-smi") is None:
        return None
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def corpus_image(index: int, height: int, width: int) -> np.ndarray:
    """Deterministic photographic-statistics content, cycling the classes."""
    return _CORPUS[index % len(_CORPUS)](height, width, seed=1000 + index)


def mixed_blocks(n: int, seed: int = 0) -> np.ndarray:
    """(n, 8, 8) uint8 blocks: a quarter each of noise, gradients, flat
    blocks and binary (0/255) blocks."""
    rng = np.random.default_rng(seed)
    k = n // 4
    noise = rng.integers(0, 256, (k, 8, 8), dtype=np.uint8)
    x = np.arange(8)[None, :, None]
    y = np.arange(8)[None, None, :]
    slope_x = rng.uniform(-40, 40, (k, 1, 1))
    slope_y = rng.uniform(-40, 40, (k, 1, 1))
    base = rng.uniform(0, 255, (k, 1, 1))
    grad = np.clip(
        slope_x * x + slope_y * y + base + rng.normal(0, 2, (k, 8, 8)), 0, 255
    ).astype(np.uint8)
    flat = np.broadcast_to(
        rng.integers(0, 256, (k, 1, 1), dtype=np.uint8), (k, 8, 8)
    )
    binary = (rng.integers(0, 2, (n - 3 * k, 8, 8)) * 255).astype(np.uint8)
    return np.concatenate([noise, grad, flat, binary])


# --------------------------------------------------------------------------
# Phases
# --------------------------------------------------------------------------

def phase_device(platform: str = "gpu", count: int = 1) -> str:
    devices = jax.devices()
    check(
        devices[0].platform == platform,
        f"JAX reports platform {devices[0].platform!r}, not {platform!r}",
    )
    check(len(devices) >= count,
          f"{len(devices)} {platform} device(s), {count} needed")
    card = card_name_and_power_limit()
    check(card is not None or platform != "gpu", "nvidia-smi not found")
    print(f"card: {card}", flush=True)
    lib = "loaded" if native.load() is not None else "not loaded"
    return (f"{devices[0].platform} {devices[0].device_kind} x"
            f"{len(devices)}; native host library {lib}")


def phase_colour(step: int = 1) -> str:
    """Every RGB triple with channel values in range(0, 256, step)."""
    levels = np.arange(0, 256, step, dtype=np.uint8)
    r, g, b = np.meshgrid(levels, levels, levels, indexing="ij")
    rgb = np.stack([r.ravel(), g.ravel(), b.ravel()], -1)
    got = jax.jit(color.rgb_to_ycbcr)(jnp.asarray(rgb))
    want = oracle.rgb_to_ycbcr_exact(rgb)
    bad = sum(int((np.asarray(a) != w).sum()) for a, w in zip(got, want))
    check(bad == 0, f"colour: {bad} mismatched channel values")
    return f"0 mismatches over {len(rgb)} RGB triples"


def phase_dct(n_blocks: int = 1 << 20, qualities=(None, 35, 90),
              seed: int = 0) -> str:
    """Device DCT + quantization against the oracle on mixed blocks.

    The first half of the blocks is quantized as luma, the rest as chroma,
    through the production three-plane entry point.
    """
    blocks = mixed_blocks(n_blocks, seed)
    ny, nc = n_blocks // 2, n_blocks // 4
    planes = (blocks[:ny], blocks[ny:ny + nc], blocks[ny + nc:])
    dev_planes = [jnp.asarray(p.reshape(-1, 64)) for p in planes]
    real = oracle.real_dct_exact(blocks)
    work = oracle.bin_dct_transform_exact(blocks)
    factors = dct.bindct_descale_2d()

    def device(algorithm, fast, descale, quality):
        fn = jax.jit(lambda y, cb, cr: jnp.concatenate(dct.dct_quantize_planes(
            y, cb, cr, algorithm, fast_dct=fast, bin_dct_descale=descale,
            quality=quality,
        )))
        return np.asarray(fn(*dev_planes)).reshape(-1, 8, 8)

    def per_plane(fn, q_luma, q_chroma):
        return np.concatenate([fn(slice(0, ny), q_luma),
                               fn(slice(ny, None), q_chroma)])

    report = []
    for quality in qualities:
        q_luma, q_chroma = tables.scaled_quant_tables(quality)
        want_real = per_plane(
            lambda s, q: oracle.quantize_real_exact(real[s], q),
            q_luma, q_chroma)
        want_bin = per_plane(
            lambda s, q: oracle.quantize_bin_exact(work[s], q),
            q_luma, q_chroma)
        want_desc = per_plane(
            lambda s, q: oracle.bin_dct_descale_quant_exact(
                work[s], q, factors),
            q_luma, q_chroma)
        cases = (
            ("real-dct", DctAlgorithm.REAL_DCT, False, want_real),
            ("bin-dct", DctAlgorithm.BIN_DCT, False, want_bin),
            ("bin-dct-descale", DctAlgorithm.BIN_DCT, True, want_desc),
        )
        for name, algorithm, descale, want in cases:
            bad = int((device(algorithm, False, descale, quality)
                       != want).sum())
            check(bad == 0, f"dct {name} q={quality}: {bad} mismatched "
                            f"coefficients of {want.size}")
        diff = np.abs(device(DctAlgorithm.REAL_DCT, True, False, quality)
                      .astype(np.int32) - want_real)
        share = float((diff != 0).mean())
        check(diff.max() <= 1 and share <= fast_dct_max_share(quality),
              f"fast-dct q={quality}: max step {diff.max()}, share {share}")
        report.append(f"q={quality}: exact 0/0/0, fast-dct share {share:.3e}")
    return (f"{n_blocks} blocks, real/bin/descale mismatches; "
            + "; ".join(report))


def oracle_file(rgb: np.ndarray, cfg: EncoderConfig) -> bytes:
    """The reference's file for rgb under cfg, from the NumPy oracle.

    Optimized-Huffman files use the tables the encoder's statistics pass
    builds for this image; the bitstream under them comes from the oracle.
    """
    plain = EncoderConfig(
        subsampling_ratio=cfg.subsampling_ratio,
        dct_algorithm=cfg.dct_algorithm, quality=cfg.quality,
    )
    ref = oracle.encode_oracle(rgb, plain)
    coeffs = (ref.y_coeffs, ref.cb_coeffs, ref.cr_coeffs)
    specs = None
    if cfg.optimize_huffman:
        hist = np.asarray(pipeline.compiled_stats_encoder(
            ref.geom, cfg.dct_algorithm, quality=cfg.quality,
            restart_mcus=cfg.restart_interval,
        )(jnp.asarray(rgb)))
        specs, _, _ = pipeline.optimal_specs_and_luts(hist)
    if cfg.restart_interval is not None:
        check(specs is None, "restart + optimize is not in the matrix")
        segments, bits = oracle.entropy_encode_restart(
            *coeffs, ref.geom, cfg.restart_interval
        )
        return jfif.assemble_restart(
            ref.geom, [np.frombuffer(s, np.uint8) for s in segments], bits,
            cfg.restart_interval, quality=cfg.quality,
        )
    payload = ref.entropy_bytes
    if specs is not None:
        payload, _ = oracle.entropy_encode(*coeffs, ref.geom, specs=specs)
    return jfif.assemble(ref.geom, payload, quality=cfg.quality,
                         dht_specs=specs)


def run_cli(args: list[str]) -> None:
    with contextlib.redirect_stdout(io.StringIO()):
        code = cli.main(args)
    check(code == 0, f"CLI {' '.join(args)} exited {code}")


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def phase_files(workdir: str, hd: tuple[int, int] = HD,
                uhd: tuple[int, int] = UHD, n_hd: int = 16,
                n_uhd: int = 2) -> str:
    """CLI single image, stream and --dataset, then the 1080p matrix."""
    in_dir = os.path.join(workdir, "in")
    os.makedirs(in_dir)
    images = {}
    for i in range(n_hd + n_uhd):
        shape = hd if i < n_hd else uhd
        name = f"img{i:02d}"
        images[name] = corpus_image(i, *shape)
        bmp.write(os.path.join(in_dir, name + ".bmp"), images[name])
    single_bmp = os.path.join(workdir, "single.bmp")
    single = corpus_image(len(images), *hd)
    bmp.write(single_bmp, single)

    base = EncoderConfig()
    want = {name: oracle_file(rgb, base) for name, rgb in images.items()}

    out = os.path.join(workdir, "single.jpeg")
    run_cli(["-i", single_bmp, "-o", out])
    check(_read(out) == oracle_file(single, base),
          "single-image CLI file differs from the oracle")

    for mode, args in (
        ("stream", ["-i", os.path.join(in_dir, "*.bmp")]),
        ("dataset", ["--dataset", in_dir]),
    ):
        out_dir = os.path.join(workdir, mode)
        run_cli(args + ["-o", out_dir])
        for name, data in want.items():
            got = _read(os.path.join(out_dir, name + ".jpeg"))
            check(got == data, f"{mode}: {name} differs from the oracle")

    matrix = [
        (["-s", ratio, "-d", algorithm],
         EncoderConfig(subsampling_ratio=tuple(map(int, ratio.split(":"))),
                       dct_algorithm=DctAlgorithm(algorithm)))
        for ratio in ("4:4:4", "4:2:2", "4:2:0")
        for algorithm in ("real-dct", "bin-dct")
    ] + [
        (["--restart-interval", "120"], EncoderConfig(restart_interval=120)),
        (["--optimize-huffman"], EncoderConfig(optimize_huffman=True)),
        (["-q", "85"], EncoderConfig(quality=85)),
    ]
    for k, (flags, cfg) in enumerate(matrix):
        out = os.path.join(workdir, f"matrix{k}.jpeg")
        run_cli(["-i", single_bmp, "-o", out] + flags)
        check(_read(out) == oracle_file(single, cfg),
              f"CLI {' '.join(flags)} file differs from the oracle")
    return (f"{len(images)} stream + {len(images)} dataset + 1 single + "
            f"{len(matrix)} matrix files byte-identical to the oracle")


def phase_aot(workdir: str, size: tuple[int, int] = (512, 512)) -> str:
    """Build the AOT artifact, drop the in-process caches, load it back."""
    cache = os.path.join(workdir, "aot_cache")
    rgb = corpus.portrait(*size, seed=9)
    cfg = EncoderConfig()
    aot_cache.enable(cache)
    try:
        pipeline.compiled_encoder.cache_clear()
        built = pipeline.encode_array(rgb, cfg).file_bytes
        artifacts = glob.glob(os.path.join(cache, "aot", "exe_*.pkl"))
        check(len(artifacts) == 1,
              f"{len(artifacts)} AOT artifacts after the build, 1 expected")
        before = os.stat(artifacts[0])
        pipeline.compiled_encoder.cache_clear()
        loaded = pipeline.encode_array(rgb, cfg).file_bytes
        check(os.path.exists(artifacts[0]),
              "the AOT artifact was deleted: its load failed")
        after = os.stat(artifacts[0])
        check((after.st_ino, after.st_mtime_ns)
              == (before.st_ino, before.st_mtime_ns),
              "the AOT artifact was rewritten: its load failed and the "
              "program was rebuilt")
    finally:
        aot_cache.disable()
        pipeline.compiled_encoder.cache_clear()
    check(loaded == built, "AOT-loaded encode differs from the built one")
    check(built == oracle_file(rgb, cfg), "AOT encode differs from the oracle")
    return (f"{size[1]}x{size[0]} 4:2:0 artifact built, loaded from disk "
            "unchanged, byte-identical to the oracle")


def phase_batch_dp(mesh, hd: tuple[int, int] = HD, n: int = 8) -> str:
    images = np.stack([corpus_image(i, *hd) for i in range(n)])
    cfg = EncoderConfig()
    files = batch.encode_batch(images, cfg, mesh)
    for i in range(n):
        check(files[i] == pipeline.encode_array(images[i], cfg).file_bytes,
              f"batch DP image {i} differs from the single-device encode")
    return (f"{n} x {hd[1]}x{hd[0]} over {mesh.devices.size} devices "
            "byte-identical to single-device encodes")


def phase_tiled(mesh, width: int = UHD[1], even_height: int = UHD[0] + 16,
                restart: int = UHD[1] // 16) -> str:
    """Band tiling: an even split, an uneven one, and restart framing.

    even_height must give a multiple of the device count in MCU rows;
    16 rows fewer leaves one band short. restart is one MCU row at 4:2:0.
    """
    cases = (
        ("even", even_height, None),
        ("uneven", even_height - 16, None),
        (f"restart {restart}", even_height - 16, restart),
    )
    for k, (name, height, interval) in enumerate(cases):
        rgb = corpus_image(20 + k, height, width)
        cfg = EncoderConfig(restart_interval=interval)
        got = tiled.encode_tiled(rgb, cfg, mesh).file_bytes
        check(got == pipeline.encode_array(rgb, cfg).file_bytes,
              f"tiled {name} differs from the single-device encode")
        check(got == oracle_file(rgb, cfg),
              f"tiled {name} differs from the oracle")
    return (f"{width}-wide bands over {mesh.devices.size} devices (even, "
            "uneven, restart) byte-identical to single-device and oracle")


def phase_tiled_optimize(mesh, height: int = UHD[0],
                         width: int = UHD[1]) -> str:
    rgb = corpus_image(30, height, width)
    cfg = EncoderConfig(optimize_huffman=True)
    got = tiled.encode_tiled(rgb, cfg, mesh).file_bytes
    check(got == pipeline.encode_array(rgb, cfg).file_bytes,
          "tiled optimized Huffman differs from the single-device encode")
    return (f"{width}x{height} over {mesh.devices.size} devices "
            "byte-identical to the single-device optimized encode")


# --------------------------------------------------------------------------

def _peak_bytes() -> str:
    stats = jax.local_devices()[0].memory_stats() or {}
    return str(stats.get("peak_bytes_in_use", "not reported"))


def run_phase(name: str, fn, *args) -> None:
    t0 = time.perf_counter()
    detail = fn(*args)
    print(f"phase {name}: ok — {detail} [{time.perf_counter() - t0:.1f} s]",
          flush=True)
    print(f"info {name}: device 0 peak_bytes_in_use {_peak_bytes()}",
          flush=True)


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument(
        "--four-cards", action="store_true",
        help="run only the multi-device paths, on a 4-card mesh",
    )
    args = parser.parse_args(argv)
    count = 4 if args.four_cards else 1
    run_phase("device", phase_device, "gpu", count)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        if args.four_cards:
            mesh = mesh_lib.data_mesh(4)
            run_phase("batch-dp", phase_batch_dp, mesh)
            run_phase("tiled", phase_tiled, mesh)
            run_phase("tiled-optimize", phase_tiled_optimize, mesh)
            run_phase("aot", phase_aot, work)
        else:
            run_phase("colour", phase_colour)
            run_phase("dct", phase_dct)
            run_phase("files", phase_files, work)
            run_phase("aot", phase_aot, work)
    device = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": device.platform,
        "kind": device.device_kind,
        "count": len(jax.devices()),
    }}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
