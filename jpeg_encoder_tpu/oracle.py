"""Golden-model encoder: a NumPy emulation of the reference's exact semantics.

The upstream reference (uriGrif/jpeg-encoder, Rust) cannot be compiled in this
environment, so this module is the executable stand-in used by the test suite
to pin down bit-level behavior. It reproduces, deliberately and exactly, every
numeric quirk of the reference pipeline:

* truncating (toward zero) casts everywhere — color conversion
  (colorspace.rs:10-12), quantization division (dct_quant.rs:182-186,227-230);
* f32 expression trees evaluated with per-operation rounding, in the same
  association order as the Rust source (no FMA contraction);
* RealDCT accumulation in (x outer, y inner) order with f32 partial sums
  (dct_quant.rs:217-225);
* integer all-lifting binDCT-C with arithmetic shifts and *no* output
  de-scaling — the reference's acknowledged defect (jpeg_theory.md:145-147);
* box-filter chroma subsampling over the zero-padded plane, with results
  assembled in block-scan push order and re-read row-major — including the
  misalignment that occurs when width % (8*h_factor) == 1
  (sampling.rs:63-101, pixel_matrix.rs:35-44);
* interleaved MCU scan driven by the chroma block count, three running DC
  predictors, zigzag RLE with ZRL/EOB, canonical Huffman emission, and a
  zero-padded final byte (entropy_coding.rs, bitvec_utils.rs, file.rs:92-103).

This is NOT the production path — see pipeline.py for the device encoder. It is
kept vectorized only enough to make tests fast on small images.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from jpeg_encoder_tpu.config import DctAlgorithm, EncoderConfig, FrameGeometry
from jpeg_encoder_tpu import tables

_F32 = np.float32


# --------------------------------------------------------------------------
# Color conversion
# --------------------------------------------------------------------------

def rgb_to_ycbcr_exact(rgb: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """RGB (..., 3) uint8 -> (y, cb, cr) uint8 with reference f32 semantics.

    Every multiply/add is a separately-rounded float32 operation, matching the
    left-to-right evaluation in colorspace.rs:10-12; the final cast truncates
    toward zero and saturates like Rust's `as u8`.
    """
    r = rgb[..., 0].astype(_F32)
    g = rgb[..., 1].astype(_F32)
    b = rgb[..., 2].astype(_F32)

    def f(c: float) -> np.float32:
        return _F32(c)

    y = (f(0.299) * r + f(0.587) * g) + f(0.114) * b
    cb = ((f(128.0) - f(0.168736) * r) - f(0.331264) * g) + f(0.5) * b
    cr = ((f(128.0) + f(0.5) * r) - f(0.418688) * g) - f(0.081312) * b

    def to_u8(x: np.ndarray) -> np.ndarray:
        return np.clip(np.trunc(x), 0.0, 255.0).astype(np.uint8)

    return to_u8(y), to_u8(cb), to_u8(cr)


# --------------------------------------------------------------------------
# Plane construction / subsampling
# --------------------------------------------------------------------------

def build_padded_planes(
    rgb: np.ndarray, geom: FrameGeometry
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Zero-padded Y/Cb/Cr planes of shape (padded_height, padded_width)."""
    y, cb, cr = rgb_to_ycbcr_exact(rgb)
    out = []
    for plane in (y, cb, cr):
        padded = np.zeros((geom.padded_height, geom.padded_width), dtype=np.uint8)
        padded[: geom.height, : geom.width] = plane
        out.append(padded)
    return out[0], out[1], out[2]


def subsample_plane(plane: np.ndarray, geom: FrameGeometry) -> np.ndarray:
    """Box-filter downsample of a padded chroma plane, push-order faithful.

    The reference averages every full h x v window of the *padded* plane
    (so edge windows include the zero padding), appends the averages in
    block-scan order, and re-reads them through a matrix of the `floor/8`
    rounded chroma shape — take-first-then-reshape reproduces that exactly,
    including the width % (8h) == 1 misalignment quirk.
    """
    h, v = geom.h_factor, geom.v_factor
    if h == 1 and v == 1:
        return plane
    ph, pw = plane.shape
    windows = plane.reshape(ph // v, v, pw // h, h).astype(np.int64)
    averages = windows.sum(axis=(1, 3)) // (h * v)  # integer floor mean
    flat = averages.reshape(-1)
    n = geom.chroma_height * geom.chroma_width
    return flat[:n].astype(np.uint8).reshape(geom.chroma_height, geom.chroma_width)


def blockify(plane: np.ndarray) -> np.ndarray:
    """(H, W) -> (H//8 * W//8, 8, 8) in row-major block order."""
    hgt, wdt = plane.shape
    return (
        plane.reshape(hgt // 8, 8, wdt // 8, 8)
        .transpose(0, 2, 1, 3)
        .reshape(-1, 8, 8)
    )


# --------------------------------------------------------------------------
# DCT variants + quantization
# --------------------------------------------------------------------------

def dct_basis_f32() -> np.ndarray:
    """B[u, x] = cos(((2x+1) * u) * pi / 16) with reference f32 arithmetic.

    The argument is built exactly as the Rust source does: integer product,
    cast to f32, multiplied by f32 pi, divided by 16 (exact). The cosine is
    the correctly-rounded f32 value (computed in f64, rounded once).
    """
    u = np.arange(8, dtype=np.int64)[:, None]
    x = np.arange(8, dtype=np.int64)[None, :]
    arg = ((2 * x + 1) * u).astype(_F32) * _F32(np.float32(np.pi)) / _F32(16.0)
    return np.cos(arg.astype(np.float64)).astype(_F32)


def real_dct_quant_exact(blocks: np.ndarray, quant: np.ndarray) -> np.ndarray:
    """Reference-faithful RealDCT + quantization over (N, 8, 8) uint8 blocks.

    Accumulates the 64 spatial terms in (x, y) scan order with f32 partial
    sums and per-operation rounding, then divides by the quant table in f32
    and truncates toward zero — the exact arithmetic of
    dct_quant.rs:189-234. Returns int16 coefficients in natural order.
    """
    return quantize_real_exact(real_dct_exact(blocks), quant)


def real_dct_exact(blocks: np.ndarray) -> np.ndarray:
    """The unquantized half of real_dct_quant_exact: (N, 8, 8) f32
    coefficients scale[u, v] * acc[u, v], before the quant division."""
    basis = dct_basis_f32()
    shifted = (blocks.astype(np.int16) - 128).astype(_F32)  # level shift
    n = blocks.shape[0]
    acc = np.zeros((n, 8, 8), dtype=_F32)
    for x in range(8):
        cos_u = basis[:, x]  # (8,) indexed by u
        for y in range(8):
            cos_v = basis[:, y]  # (8,) indexed by v
            term = shifted[:, x, y, None, None] * cos_u[None, :, None]
            term = term * cos_v[None, None, :]
            acc = acc + term
    inv_sqrt2 = _F32(1.0) / _F32(np.sqrt(2.0))  # f32(sqrt2) like f32::consts::SQRT_2
    alpha = np.where(np.arange(8) == 0, inv_sqrt2, _F32(1.0)).astype(_F32)
    scale = (_F32(0.25) * alpha[:, None]) * alpha[None, :]
    return scale[None] * acc


def quantize_real_exact(coeffs: np.ndarray, quant: np.ndarray) -> np.ndarray:
    """f32 divide by the (8, 8) quant table, truncate toward zero."""
    return np.trunc(coeffs / quant.astype(_F32)[None]).astype(np.int16)


def _bindct_lifting_1d(x: list[np.ndarray]) -> list[np.ndarray]:
    """One 8-point all-lifting binDCT-C pass over int32 lanes.

    Shift/add butterfly network of dct_quant.rs:84-129 (derived from the
    Tran "intDCT" paper's binDCT-C variant). Input x[0..7], output in
    *natural frequency order* (the permuted stores at :122-129 folded in).
    """
    x0, x1, x2, x3, x4, x5, x6, x7 = x

    s7 = x0 - x7
    s0 = x0 - (s7 >> 1)
    s6 = x1 - x6
    s1 = x1 - (s6 >> 1)
    s5 = x2 - x5
    s2 = x2 - (s5 >> 1)
    s4 = x3 - x4
    s3 = x3 - (s4 >> 1)

    s6 = ((s5 * 3) >> 3) + s6
    s5 = ((s6 * 5) >> 3) - s5

    t0 = s0 + s3
    t3 = s0 - s3
    t1 = s1 + s2
    t2 = s1 - s2
    t4 = s4 + s5
    t5 = s4 - s5
    t6 = s7 - s6
    t7 = s7 + s6

    t4 = t4 - (t7 >> 3)
    t0 = t0 + t1
    t1 = -t1 + (t0 >> 1)
    t2 = t2 - ((t3 * 3) >> 3)
    t3 = t3 + ((t2 * 3) >> 3)
    t5 = t5 + ((t6 * 7) >> 3)
    t6 = t6 - (t5 >> 1)

    # Frequency-order outputs: DC, then the permuted AC lanes.
    return [t0, t7, t3, t6, t1, t5, t2, t4]


def bin_dct_quant_exact(blocks: np.ndarray, quant: np.ndarray) -> np.ndarray:
    """Reference-faithful binDCT-C + quantization over (N, 8, 8) uint8 blocks.

    Integer-only: arithmetic shifts, truncating division by the quant table.
    Reproduces the reference's omission of the de-scaling stage (the lifting
    network's diagonal gains are NOT folded out), so outputs match
    dct_quant.rs:67-187 bit for bit.
    """
    return quantize_bin_exact(bin_dct_transform_exact(blocks), quant)


def quantize_bin_exact(work: np.ndarray, quant: np.ndarray) -> np.ndarray:
    """Integer division of raw lifting outputs, truncating toward zero."""
    q = quant.astype(np.int32)[None]
    return (np.sign(work) * (np.abs(work) // q)).astype(np.int16)


def bin_dct_transform_exact(blocks: np.ndarray) -> np.ndarray:
    """(N, 8, 8) uint8 -> (N, 8, 8) int32 raw binDCT-C lifting outputs."""
    work = blocks.astype(np.int32) - 128
    rows = _bindct_lifting_1d([work[:, :, i] for i in range(8)])
    work = np.stack(rows, axis=2)  # row transform: frequency along axis 2
    cols = _bindct_lifting_1d([work[:, i, :] for i in range(8)])
    return np.stack(cols, axis=1)


def bin_dct_descale_quant_exact(
    work: np.ndarray, quant: np.ndarray, factors: np.ndarray
) -> np.ndarray:
    """The corrected binDCT-C quantizer (--bin-dct-descale), which the
    reference lacks: raw lifting outputs (bin_dct_transform_exact) times
    the (64,) f32 gain factors, divided by the quant table, each an f32
    operation rounded on its own, then truncated toward zero."""
    scaled = work.astype(_F32) * factors.reshape(1, 8, 8).astype(_F32)
    return np.trunc(scaled / quant.astype(_F32)[None]).astype(np.int16)


def dct_and_quantize(
    plane: np.ndarray, quant: np.ndarray, algorithm: DctAlgorithm
) -> np.ndarray:
    blocks = blockify(plane)
    if algorithm == DctAlgorithm.REAL_DCT:
        return real_dct_quant_exact(blocks, quant)
    return bin_dct_quant_exact(blocks, quant)


# --------------------------------------------------------------------------
# Entropy coding
# --------------------------------------------------------------------------

class BitWriter:
    """MSB-first bit accumulator; final partial byte is zero-filled.

    Matches bitvec_utils.rs:3-8 + BitVec::as_raw_slice zero-fill semantics
    (the reference does NOT 1-pad the last byte as the spec suggests).
    """

    def __init__(self) -> None:
        self._bits: list[int] = []

    def write(self, value: int, length: int) -> None:
        for i in range(length - 1, -1, -1):
            self._bits.append((value >> i) & 1)

    @property
    def bit_length(self) -> int:
        return len(self._bits)

    def to_bytes(self) -> bytes:
        out = bytearray((len(self._bits) + 7) // 8)
        for i, bit in enumerate(self._bits):
            if bit:
                out[i >> 3] |= 0x80 >> (i & 7)
        return bytes(out)


def _bit_length(value: int) -> int:
    """Magnitude category: bits needed for a non-negative value."""
    return int(value).bit_length()


def encode_block(
    zz: np.ndarray,
    prev_dc: int,
    dc_table: tables.HuffmanSpec,
    ac_table: tables.HuffmanSpec,
    writer: BitWriter,
) -> int:
    """Entropy-encode one block given zigzag-ordered coefficients.

    Returns the block's DC value (the new predictor). Implements the DC
    difference + magnitude-category amplitude scheme with ZRL (0xF0) runs and
    EOB (0x00) exactly as entropy_coding.rs:144-227.
    """
    dc = int(zz[0])
    diff = dc - prev_dc
    dc_bits = _bit_length(abs(diff))
    if dc_bits > 11:
        raise ValueError("DC coefficient bit length greater than 11")
    amplitude = diff + (1 << dc_bits) - 1 if diff < 0 else diff
    code, code_len = dc_table.encode_symbol(dc_bits)
    writer.write(code, code_len)
    writer.write(amplitude, dc_bits)

    zeros = 0
    i = 1
    while i < 64:
        while i < 64 and zz[i] == 0:
            zeros += 1
            i += 1
        if i == 64:
            code, code_len = ac_table.encode_symbol(0x00)  # EOB
            writer.write(code, code_len)
            break
        while zeros >= 16:
            code, code_len = ac_table.encode_symbol(0xF0)  # ZRL
            writer.write(code, code_len)
            zeros -= 16
        ac = int(zz[i])
        ac_bits = _bit_length(abs(ac))
        if ac_bits > 10:
            raise ValueError("AC coefficient bit length greater than 10")
        amplitude = ac + (1 << ac_bits) - 1 if ac < 0 else ac
        code, code_len = ac_table.encode_symbol((zeros << 4) | ac_bits)
        writer.write(code, code_len)
        writer.write(amplitude & ((1 << ac_bits) - 1), ac_bits)
        zeros = 0
        i += 1
    return dc


def luma_scan_order(geom: FrameGeometry) -> np.ndarray:
    """Luma block indices in interleaved-scan order, (num_mcus, h*v).

    MCU i takes luma *superblock* i in row-major superblock-grid order, and
    within it the h x v sub-blocks row-major (entropy_coding.rs:74-103). When
    the chroma grid is smaller than the luma superblock grid (the
    width % (8h) == 1 quirk) the trailing superblocks are simply never
    emitted — faithfully reproduced by taking the first num_mcus entries.
    """
    h, v = geom.h_factor, geom.v_factor
    order = np.empty((geom.mcu_rows * geom.mcu_cols, v * h), dtype=np.int64)
    k = 0
    for sr in range(geom.mcu_rows):
        for sc in range(geom.mcu_cols):
            sub = []
            for br in range(v):
                for bc in range(h):
                    row = sr * v + br
                    col = sc * h + bc
                    sub.append(row * geom.luma_blocks_x + col)
            order[k] = sub
            k += 1
    return order[: geom.num_mcus]


def entropy_encode(
    y_coeffs: np.ndarray,
    cb_coeffs: np.ndarray,
    cr_coeffs: np.ndarray,
    geom: FrameGeometry,
    specs: tuple | None = None,
    init_dc: tuple[int, int, int] = (0, 0, 0),
    num_mcus: int | None = None,
) -> tuple[bytes, int]:
    """Interleaved scan over MCUs -> (entropy bytes, bit length).

    specs = (Y-DC, C-DC, Y-AC, C-AC) HuffmanSpecs replaces the Annex-K
    tables (the optimized-Huffman mode); init_dc seeds the (Y, Cb, Cr) DC
    predictors (a band's predecessor's last DCs); num_mcus encodes only
    that many leading MCUs.
    """
    if specs is None:
        specs = (tables.Y_DC_HUFFMAN, tables.C_DC_HUFFMAN,
                 tables.Y_AC_HUFFMAN, tables.C_AC_HUFFMAN)
    y_dc, c_dc, y_ac, c_ac = specs
    writer = BitWriter()
    zz = tables.ZIGZAG_ORDER
    y_zz = y_coeffs.reshape(-1, 64)[:, zz]
    cb_zz = cb_coeffs.reshape(-1, 64)[:, zz]
    cr_zz = cr_coeffs.reshape(-1, 64)[:, zz]
    luma_order = luma_scan_order(geom)

    prev = dict(zip(("y", "cb", "cr"), (int(d) for d in init_dc)))
    for mcu in range(geom.num_mcus if num_mcus is None else num_mcus):
        for block_idx in luma_order[mcu]:
            prev["y"] = encode_block(
                y_zz[block_idx], prev["y"], y_dc, y_ac, writer
            )
        prev["cb"] = encode_block(cb_zz[mcu], prev["cb"], c_dc, c_ac, writer)
        prev["cr"] = encode_block(cr_zz[mcu], prev["cr"], c_dc, c_ac, writer)
    return writer.to_bytes(), writer.bit_length


def entropy_encode_restart(
    y_coeffs: np.ndarray,
    cb_coeffs: np.ndarray,
    cr_coeffs: np.ndarray,
    geom: FrameGeometry,
    restart_mcus: int,
) -> tuple[list[bytes], list[int]]:
    """Restart-framed scan: one independent segment per N-MCU interval.

    The golden model for the restart extension (ITU-T T.81 E.2.4): DC
    predictors reset at every interval, and each segment byte-aligns with
    1-bits (B.1.1.5) — both re-derived here from the spec, independent of
    the production io/jfif + device implementations the tests compare
    against. Returns (padded unstuffed segment bytes, true bit counts).
    """
    zz = tables.ZIGZAG_ORDER
    y_zz = y_coeffs.reshape(-1, 64)[:, zz]
    cb_zz = cb_coeffs.reshape(-1, 64)[:, zz]
    cr_zz = cr_coeffs.reshape(-1, 64)[:, zz]
    luma_order = luma_scan_order(geom)

    segments: list[bytes] = []
    bit_counts: list[int] = []
    for start in range(0, geom.num_mcus, restart_mcus):
        writer = BitWriter()
        prev = {"y": 0, "cb": 0, "cr": 0}
        for mcu in range(start, min(start + restart_mcus, geom.num_mcus)):
            for block_idx in luma_order[mcu]:
                prev["y"] = encode_block(
                    y_zz[block_idx], prev["y"],
                    tables.Y_DC_HUFFMAN, tables.Y_AC_HUFFMAN, writer,
                )
            prev["cb"] = encode_block(
                cb_zz[mcu], prev["cb"],
                tables.C_DC_HUFFMAN, tables.C_AC_HUFFMAN, writer,
            )
            prev["cr"] = encode_block(
                cr_zz[mcu], prev["cr"],
                tables.C_DC_HUFFMAN, tables.C_AC_HUFFMAN, writer,
            )
        raw = bytearray(writer.to_bytes())
        rem = writer.bit_length & 7
        if rem:
            raw[-1] |= 0xFF >> rem  # spec padding: 1-bits to the boundary
        segments.append(bytes(raw))
        bit_counts.append(writer.bit_length)
    return segments, bit_counts


# --------------------------------------------------------------------------
# Full-pipeline oracle
# --------------------------------------------------------------------------

@dataclasses.dataclass
class OracleResult:
    y_coeffs: np.ndarray  # (num_luma_blocks, 8, 8) int16, natural order
    cb_coeffs: np.ndarray
    cr_coeffs: np.ndarray
    entropy_bytes: bytes
    bit_length: int
    geom: FrameGeometry


def encode_oracle(rgb: np.ndarray, config: EncoderConfig) -> OracleResult:
    """rgb (H, W, 3) uint8 -> reference-faithful coefficients + scan bytes."""
    hgt, wdt = rgb.shape[:2]
    geom = config.geometry(wdt, hgt)
    y, cb, cr = build_padded_planes(rgb, geom)
    cb = subsample_plane(cb, geom)
    cr = subsample_plane(cr, geom)
    q_luma, q_chroma = tables.scaled_quant_tables(config.quality)
    y_q = dct_and_quantize(y, q_luma, config.dct_algorithm)
    cb_q = dct_and_quantize(cb, q_chroma, config.dct_algorithm)
    cr_q = dct_and_quantize(cr, q_chroma, config.dct_algorithm)
    payload, bit_length = entropy_encode(
        y_q.reshape(-1, 8, 8), cb_q.reshape(-1, 8, 8), cr_q.reshape(-1, 8, 8), geom
    )
    return OracleResult(
        y_coeffs=y_q.reshape(-1, 8, 8),
        cb_coeffs=cb_q.reshape(-1, 8, 8),
        cr_coeffs=cr_q.reshape(-1, 8, 8),
        entropy_bytes=payload,
        bit_length=bit_length,
        geom=geom,
    )
