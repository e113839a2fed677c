"""Encoder configuration and the shape algebra of the baseline JPEG pipeline.

Shape rules mirror the reference encoder exactly so that coefficients (and
therefore bitstreams) are reproducible:

* luma plane is zero-padded up to a multiple of ``8 * h_factor`` wide and
  ``8 * v_factor`` tall (jpeg_image.rs:36-49);
* subsampled chroma dims are ``floor(dim / factor)`` rounded *up* to a
  multiple of 8 (sampling.rs:24-44) — note floor of the *original* dim, not
  the padded one.
"""

from __future__ import annotations

import dataclasses
import enum


class DctAlgorithm(enum.Enum):
    REAL_DCT = "real-dct"
    BIN_DCT = "bin-dct"


SUBSAMPLING_FACTORS: dict[tuple[int, int, int], tuple[int, int]] = {
    (4, 4, 4): (1, 1),
    (4, 2, 0): (2, 2),
    (4, 2, 2): (2, 1),
}


def parse_subsampling_ratio(text: str) -> tuple[int, int, int]:
    parts = text.split(":")
    if len(parts) != 3:
        raise ValueError("subsampling ratio must be in the format A:B:C")
    try:
        ratio = tuple(int(p) for p in parts)
    except ValueError as e:
        raise ValueError(
            "subsampling ratio must consist of three integers separated by colons"
        ) from e
    if ratio not in SUBSAMPLING_FACTORS:
        raise ValueError(
            f"invalid chrominance subsampling ratio {text!r}; "
            f"supported: 4:4:4, 4:2:2, 4:2:0"
        )
    return ratio  # type: ignore[return-value]


def _round_up(value: int, multiple: int) -> int:
    return -(-value // multiple) * multiple


@dataclasses.dataclass(frozen=True)
class FrameGeometry:
    """All static shapes of one encode, derived from (width, height, ratio)."""

    width: int
    height: int
    h_factor: int
    v_factor: int

    @classmethod
    def create(
        cls, width: int, height: int, ratio: tuple[int, int, int]
    ) -> "FrameGeometry":
        if width <= 0 or height <= 0:
            raise ValueError(f"invalid image dimensions {width}x{height}")
        if width > 65535 or height > 65535:
            raise ValueError("baseline JFIF dimensions are limited to 65535")
        h, v = SUBSAMPLING_FACTORS[ratio]
        return cls(width=width, height=height, h_factor=h, v_factor=v)

    # ---- luma plane (all three planes before subsampling) ----

    @property
    def padded_width(self) -> int:
        return _round_up(self.width, 8 * self.h_factor)

    @property
    def padded_height(self) -> int:
        return _round_up(self.height, 8 * self.v_factor)

    # ---- subsampled chroma plane ----

    @property
    def chroma_width(self) -> int:
        return _round_up(self.width // self.h_factor, 8)

    @property
    def chroma_height(self) -> int:
        return _round_up(self.height // self.v_factor, 8)

    @property
    def mcu_grid_aligned(self) -> bool:
        """True when the scan's MCU count matches the SOF-implied grid.

        The reference's dim % (8*factor) == 1 quirk (sampling.rs:24-44 +
        the chroma-keyed MCU loop, entropy_coding.rs:97) makes it emit
        FEWER MCUs than ceil(dim / (8*factor)) — a decoder reading the
        SOF dimensions expects more. Harmless for one unbroken scan
        (decoders read sequentially and both sides stay in lockstep,
        reference-parity), but fatal for any framing that gives the
        decoder absolute positions: restart markers resync interval k to
        MCU k*N of the DECODER's grid, and band-local tiling assumes the
        grids agree (parallel/tiled.tileable). Such modes require this
        predicate.
        """
        return self.chroma_width == self.padded_width // self.h_factor and (
            self.chroma_height == self.padded_height // self.v_factor
        )

    # ---- block/MCU bookkeeping ----

    @property
    def luma_blocks_x(self) -> int:
        return self.padded_width // 8

    @property
    def luma_blocks_y(self) -> int:
        return self.padded_height // 8

    @property
    def num_luma_blocks(self) -> int:
        return self.luma_blocks_x * self.luma_blocks_y

    @property
    def chroma_blocks_x(self) -> int:
        return self.chroma_width // 8

    @property
    def chroma_blocks_y(self) -> int:
        return self.chroma_height // 8

    @property
    def num_chroma_blocks(self) -> int:
        return self.chroma_blocks_x * self.chroma_blocks_y

    @property
    def num_mcus(self) -> int:
        """Scan is driven by the chroma block count (entropy_coding.rs:97)."""
        return self.num_chroma_blocks

    @property
    def mcu_cols(self) -> int:
        """Luma superblock grid width, in superblocks of 8h x 8v."""
        return self.padded_width // (8 * self.h_factor)

    @property
    def mcu_rows(self) -> int:
        return self.padded_height // (8 * self.v_factor)

    @property
    def blocks_per_mcu(self) -> int:
        return self.h_factor * self.v_factor + 2

    @property
    def num_scan_entries(self) -> int:
        """Total 8x8 blocks emitted into the scan."""
        return self.num_mcus * self.blocks_per_mcu


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    subsampling_ratio: tuple[int, int, int] = (4, 2, 0)
    dct_algorithm: DctAlgorithm = DctAlgorithm.REAL_DCT
    # RealDCT flavor. False (default) = reference-parity accumulation order:
    # quantized coefficients are bit-identical to the scalar reference.
    # True = single (N, 64) @ (64, 64) f32 matmul: same math, different f32
    # summation order; ~1e-5 of coefficients land one quantization step away
    # from the reference (visually and PSNR-wise indistinguishable).
    fast_dct: bool = False
    # binDCT flavor. False (default) = reference bug-parity: raw lifting
    # outputs quantized directly, reproducing the acknowledged de-scaling
    # defect (dct_quant.rs:182-186, "weird line patterns" per
    # jpeg_theory.md:145-147). True = scale-folded binDCT-C: the lifting
    # network's diagonal gains are folded into the quantization step
    # (ops/dct.bindct_descale_2d), giving properly normalized coefficients
    # and image quality within a few dB of real-dct.
    bin_dct_descale: bool = False
    # Initial output-bitstream capacity estimate in bytes per pixel of the
    # original image. The packer's cost scales with this buffer, so it is an
    # estimate (typical Annex-K-table payloads are 0.1-0.4 B/px), not a
    # bound: the pipeline reports the true bit length, detects overflow, and
    # automatically retries with a larger buffer (pipeline.encode_array).
    capacity_bytes_per_pixel: float = 0.5
    # Quality setting 1..100 scaling the quantization tables with the
    # standard libjpeg formula (tables.scaled_quant_tables). None (default)
    # = the reference's fixed Annex-K tables; 50 is numerically identical
    # to None. Extension beyond the reference (its tables are fixed;
    # jpeg_theory.md:162 lists quality scaling as unimplemented).
    quality: int | None = None
    # Two-pass optimized Huffman coding (libjpeg's -optimize analog): a
    # statistics pass histograms the scan's symbols on device, optimal
    # per-image canonical tables are built host-side (tables.optimal_spec,
    # ITU-T T.81 K.2), and the encode pass emits them in the DHT segments.
    # Files shrink by the tables' fit to the content (typically 2-10%);
    # any baseline decoder reads them. Off by default (reference parity:
    # fixed Annex-K tables, huffman_tables.rs).
    optimize_huffman: bool = False
    # Emit DRI/RSTn restart markers every N MCUs (1..65535). Each restart
    # interval is an independently decodable scan segment: DC predictors
    # reset, the bitstream byte-aligns (1-padded, per spec) before each
    # marker. JPEG's native answer to parallel decode AND to the band-splice
    # problem the tiled encoder otherwise solves with bit-level splicing.
    # None (default) = reference scope: a single unbroken scan
    # (file.rs:77-90 has no DRI segment).
    restart_interval: int | None = None
    # Check the reference's entropy-range invariants (DC difference category
    # <= 11, AC size <= 10 — panics in entropy_coding.rs:153-155,188-191)
    # and raise host-side before emitting a corrupt scan. Unreachable for
    # valid u8 image input, so off by default (costs one extra reduction).
    validate: bool = False

    def __post_init__(self) -> None:
        if self.quality is not None and not 1 <= self.quality <= 100:
            raise ValueError(
                f"quality must be in 1..100, got {self.quality}"
            )
        if self.restart_interval is not None and not (
            1 <= self.restart_interval <= 65535
        ):
            raise ValueError(
                "restart interval must be in 1..65535 MCUs, got "
                f"{self.restart_interval}"
            )

    def geometry(self, width: int, height: int) -> FrameGeometry:
        return FrameGeometry.create(width, height, self.subsampling_ratio)

    def quant_tables(self):
        """(luma, chroma) uint8 quantization tables for this config."""
        from jpeg_encoder_tpu import tables

        return tables.scaled_quant_tables(self.quality)

    @property
    def factors(self) -> tuple[int, int]:
        return SUBSAMPLING_FACTORS[self.subsampling_ratio]
