"""Decoded-PSNR + compression-ratio table over the photographic corpus.

Evidence for the "PSNR >= Rust reference on Kodak" target analog
(BASELINE.json): since output files are byte-identical to the
reference semantics (the real guarantee), this table makes the claim
concrete on photographic-statistics content — per image x subsampling
ratio x DCT algorithm, with PIL as the independent decoder.

    python tools/corpus_report.py          # markdown table on stdout
"""

import io
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

if "--cpu" in sys.argv:
    jax.config.update("jax_platforms", "cpu")
from jpeg_encoder_tpu.utils import compile_cache  # noqa: E402

compile_cache.enable()

import numpy as np
from PIL import Image

from jpeg_encoder_tpu import pipeline
from jpeg_encoder_tpu.config import DctAlgorithm, EncoderConfig
from jpeg_encoder_tpu.utils import corpus


def main() -> int:
    images = corpus.images()
    ratios = [(4, 4, 4), (4, 2, 2), (4, 2, 0)]
    modes = [
        ("real-dct", DctAlgorithm.REAL_DCT, False),
        ("bin-dct", DctAlgorithm.BIN_DCT, False),
        ("bin-dct-descale", DctAlgorithm.BIN_DCT, True),
    ]
    print(f"backend: {jax.default_backend()}")
    print()
    print("| image | ratio | algorithm | PSNR (dB) | bits/px | vs 24-bpp BMP |")
    print("|---|---|---|---|---|---|")
    for name, rgb in images.items():
        npx = rgb.shape[0] * rgb.shape[1]
        for ratio in ratios:
            for label, alg, descale in modes:
                cfg = EncoderConfig(
                    subsampling_ratio=ratio,
                    dct_algorithm=alg,
                    bin_dct_descale=descale,
                )
                res = pipeline.encode_array(rgb, cfg)
                dec = np.asarray(
                    Image.open(io.BytesIO(res.file_bytes)).convert("RGB")
                )
                p = corpus.psnr(rgb, dec)
                bpp = len(res.file_bytes) * 8 / npx
                ratio_s = ":".join(map(str, ratio))
                print(
                    f"| {name} | {ratio_s} | {label} | {p:.2f} | "
                    f"{bpp:.2f} | {24 / bpp:.0f}x |"
                )
    return 0


if __name__ == "__main__":
    sys.exit(main())
