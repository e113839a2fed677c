"""One matrix cell, fast: `python tools/bench_cell.py 4:4:4 [bin] [restart=N]
[optimize]`.

restart=N frames the scan into N-MCU restart intervals (the opt-in
DRI/RSTn extension) so its device cost is measurable with the same
methodology.

`optimize` measures the BATCHED two-pass optimized-Huffman mode: per
iteration, the device stats pass + host table build + the vmapped-LUT
encode pass (with traced tables). Reported both as the
full two-pass cost (what --optimize-huffman pays) and the encode pass
alone (comparable to the fixed-table cell).

Same methodology as tools/bench_matrix.py (payloads materialized,
enqueue-K + scalar fetch), one (ratio, algorithm) configuration only —
for quick A/B iteration on changes to the encode program.
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
from jpeg_encoder_tpu.config import parse_subsampling_ratio

H, W, B = 1088, 1920, 8
MIN_TIMED_SECONDS = 3.0
ratio = parse_subsampling_ratio(sys.argv[1]) if len(sys.argv) > 1 else (4, 4, 4)
algo = DctAlgorithm.BIN_DCT if "bin" in sys.argv[2:] else DctAlgorithm.REAL_DCT
restart = next(
    (int(a.split("=")[1]) for a in sys.argv[2:] if a.startswith("restart=")),
    None,
)
optimize = "optimize" in sys.argv[2:]
fast = "fast" in sys.argv[2:]  # --fast-dct MXU matmul RealDCT (not bit-exact)

key = jax.random.key(0)
base = jax.random.uniform(key, (B, H // 8, W // 8, 3))
img = jax.image.resize(base, (B, H, W, 3), "linear")
noise = jax.random.uniform(jax.random.key(100), (B, H, W, 3)) * 0.1
images = ((img * 0.9 + noise) * 255).astype(jnp.uint8)

config = EncoderConfig(
    subsampling_ratio=ratio, dct_algorithm=algo, restart_interval=restart
)
geom = config.geometry(W, H)
if restart is not None:
    cap = pipeline.restart_default_capacity_bytes(
        geom, restart, config.capacity_bytes_per_pixel
    )
else:
    cap = pipeline.default_capacity_bytes(geom, config.capacity_bytes_per_pixel)


@jax.jit
def go(imgs):
    def one(rgb):
        if restart is not None:
            out = pipeline.encode_core_restart(
                rgb, geom, algo, cap, restart, fast_dct=fast
            )
            return out["payloads"], out["bits"].max()
        out = pipeline.encode_core(
            rgb, geom, algo, cap, fast_dct=fast, with_coeffs=False
        )
        return out["payload"], out["total_bits"]
    return jax.vmap(one)(imgs)


def timed_run(iters):
    t0 = time.perf_counter()
    for _ in range(iters):
        _, bits = go(images)
    np.asarray(bits[0])
    return time.perf_counter() - t0


def measure(run):
    run(1)  # warm (compile)
    for _ in range(2):
        run(1)
    est = run(4) / 4
    iters = max(8, min(2048, int(MIN_TIMED_SECONDS / max(est, 1e-5))))
    return run(iters) / iters


if optimize:
    import jax.numpy as jnp

    from jpeg_encoder_tpu.parallel import batch as batch_lib
    from jpeg_encoder_tpu.parallel import mesh as mesh_lib

    mesh = mesh_lib.data_mesh()
    stats_enc = batch_lib.compiled_batch_stats_encoder(
        mesh, geom, algo, restart_interval=restart
    )
    custom_enc = batch_lib.compiled_batch_custom_encoder(
        mesh, geom, algo, cap, restart
    )

    def build_luts(hists):
        dc = np.empty((B, 2, 256), np.int32)
        ac = np.empty((B, 2, 256), np.int32)
        for i in range(B):
            _, d, a = pipeline.optimal_specs_and_luts(hists[i])
            dc[i] = np.asarray(d)
            ac[i] = np.asarray(a)
        return jnp.asarray(dc), jnp.asarray(ac)

    def two_pass(iters):
        t0 = time.perf_counter()
        for _ in range(iters):
            hists = np.asarray(stats_enc(images))
            dc, ac = build_luts(hists)
            _, bits = custom_enc(images, dc, ac)
        np.asarray(bits).max()
        return time.perf_counter() - t0

    # Encode pass alone (tables prebuilt): the cell comparable to the
    # fixed-table measurement.
    hists0 = np.asarray(stats_enc(images))
    dc0, ac0 = build_luts(hists0)

    def encode_only(iters):
        t0 = time.perf_counter()
        for _ in range(iters):
            _, bits = custom_enc(images, dc0, ac0)
        np.asarray(bits).max()
        return time.perf_counter() - t0

    dt_full = measure(two_pass)
    dt_enc = measure(encode_only)
    tag = f" restart={restart}" if restart is not None else ""
    print(
        f"{':'.join(map(str, ratio))} {algo.value}{tag} optimize: "
        f"two-pass {dt_full*1e3:.2f} ms/batch {B*H*W/dt_full/1e6:.0f} "
        f"Mpix/s | encode pass {dt_enc*1e3:.2f} ms/batch "
        f"{B*H*W/dt_enc/1e6:.0f} Mpix/s"
    )
    raise SystemExit(0)

dt = measure(timed_run)
tag = f" restart={restart}" if restart is not None else ""
print(f"{':'.join(map(str, ratio))} {algo.value}{tag}: {dt*1e3:.2f} ms/batch  "
      f"{B*H*W/dt/1e6:.0f} Mpix/s")
