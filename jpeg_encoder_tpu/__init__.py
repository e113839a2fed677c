"""jpeg_encoder_tpu: a baseline JPEG (JFIF) encoder on JAX accelerators.

A from-scratch JAX/XLA re-design of the capabilities of the
uriGrif/jpeg-encoder reference (Rust BMP -> baseline JPEG CLI):

* RGB -> YCbCr color conversion (BT.601 constants, truncating casts)
* 4:4:4 / 4:2:2 / 4:2:0 box-filter chroma subsampling
* 8x8 block tiling with zero padding to MCU multiples
* RealDCT (f32) and integer binDCT-C, Annex-K quantization
* zigzag + run-length + canonical Huffman entropy coding, packed on device
* JFIF container emission with 0xFF byte stuffing
* batch/data-parallel scale-out over a jax.sharding.Mesh

The whole per-image compute path — color convert, subsample, DCT, quantize,
run-length symbolization, Huffman bit packing — is a single jittable program;
only file I/O and the final byte-stuff/concat run on the host.
"""

from jpeg_encoder_tpu.config import (  # noqa: F401
    DctAlgorithm,
    EncoderConfig,
    FrameGeometry,
    parse_subsampling_ratio,
)

__version__ = "0.1.0"
