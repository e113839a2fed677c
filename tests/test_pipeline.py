"""End-to-end pipeline: full JFIF files, oracle parity, independent decode."""

import io as _io

import numpy as np
import pytest
from PIL import Image

from jpeg_encoder_tpu import oracle, pipeline
from jpeg_encoder_tpu.config import DctAlgorithm, EncoderConfig
from jpeg_encoder_tpu.io import bmp, jfif


def _gradient_image(width, height):
    """Smooth synthetic content (photographic-ish, compresses well)."""
    x = np.linspace(0, 255, width)[None, :]
    y = np.linspace(0, 255, height)[:, None]
    r = (x + y) / 2
    g = np.abs(x - y)
    b = 255 - r
    return np.stack(np.broadcast_arrays(r, g, b), axis=-1).astype(np.uint8)


@pytest.mark.parametrize("ratio", [(4, 4, 4), (4, 2, 2), (4, 2, 0)])
@pytest.mark.parametrize(
    "algorithm", [DctAlgorithm.REAL_DCT, DctAlgorithm.BIN_DCT]
)
def test_file_bytes_match_oracle(ratio, algorithm, rng):
    """The device pipeline's complete file must equal the golden model's."""
    rgb = rng.integers(0, 256, size=(24, 40, 3), dtype=np.uint8)
    config = EncoderConfig(subsampling_ratio=ratio, dct_algorithm=algorithm)
    device = pipeline.encode_array(rgb, config)
    golden = oracle.encode_oracle(rgb, config)
    golden_file = jfif.assemble(golden.geom, golden.entropy_bytes)
    assert device.bit_length == golden.bit_length
    assert device.file_bytes == golden_file


@pytest.mark.parametrize("size", [(8, 8), (17, 16), (40, 24), (31, 9)])
def test_file_bytes_match_oracle_odd_sizes(size, rng):
    width, height = size
    rgb = rng.integers(0, 256, size=(height, width, 3), dtype=np.uint8)
    config = EncoderConfig(subsampling_ratio=(4, 2, 0))
    device = pipeline.encode_array(rgb, config)
    golden = oracle.encode_oracle(rgb, config)
    assert device.file_bytes == jfif.assemble(golden.geom, golden.entropy_bytes)


def test_coefficients_match_oracle(rng):
    rgb = rng.integers(0, 256, size=(16, 24, 3), dtype=np.uint8)
    config = EncoderConfig(subsampling_ratio=(4, 2, 0))
    _, (y_q, cb_q, cr_q) = pipeline.encode_array(rgb, config, return_coeffs=True)
    golden = oracle.encode_oracle(rgb, config)
    assert np.array_equal(y_q.reshape(-1, 8, 8), golden.y_coeffs)
    assert np.array_equal(cb_q.reshape(-1, 8, 8), golden.cb_coeffs)
    assert np.array_equal(cr_q.reshape(-1, 8, 8), golden.cr_coeffs)


@pytest.mark.parametrize("ratio", [(4, 4, 4), (4, 2, 2), (4, 2, 0)])
def test_decode_psnr_smooth_content(ratio):
    """Independent decoder round-trip: PSNR must be healthy for smooth input."""
    rgb = _gradient_image(64, 48)
    config = EncoderConfig(subsampling_ratio=ratio)
    result = pipeline.encode_array(rgb, config)
    decoded = np.asarray(Image.open(_io.BytesIO(result.file_bytes)).convert("RGB"))
    assert decoded.shape == rgb.shape
    mse = np.mean((decoded.astype(np.float64) - rgb.astype(np.float64)) ** 2)
    psnr = 10 * np.log10(255.0**2 / max(mse, 1e-12))
    assert psnr > 30.0, f"PSNR {psnr:.2f} dB too low for smooth content"


def _decode_psnr(rgb, file_bytes):
    decoded = np.asarray(Image.open(_io.BytesIO(file_bytes)).convert("RGB"))
    mse = np.mean((decoded.astype(np.float64) - rgb.astype(np.float64)) ** 2)
    return 10 * np.log10(255.0**2 / max(mse, 1e-12))


def test_fast_dct_pipeline_decodes_and_matches_exact_quality():
    """--fast-dct (the matmul RealDCT) must produce a valid decodable
    file whose quality matches the exact ordered-chain encode — the mode
    trades bit-exactness vs the reference for speed, not visible
    quality."""
    rgb = _gradient_image(64, 48)
    exact = pipeline.encode_array(rgb, EncoderConfig())
    fast = pipeline.encode_array(rgb, EncoderConfig(fast_dct=True))
    assert abs(_decode_psnr(rgb, fast.file_bytes)
               - _decode_psnr(rgb, exact.file_bytes)) < 0.5


@pytest.mark.slow
def test_bin_dct_descale_fixes_quality():
    """The corrected binDCT (scale-folded gains) must erase the reference's
    de-scaling artifact: decoded PSNR within a few dB of real-dct on the
    same content, and far above the bug-parity binDCT, with smaller files
    (SURVEY quirk 2; dct_quant.rs:182-186, jpeg_theory.md:145-147)."""
    rgb = _gradient_image(64, 48)
    real = pipeline.encode_array(
        rgb, EncoderConfig(dct_algorithm=DctAlgorithm.REAL_DCT)
    )
    parity = pipeline.encode_array(
        rgb, EncoderConfig(dct_algorithm=DctAlgorithm.BIN_DCT)
    )
    fixed = pipeline.encode_array(
        rgb,
        EncoderConfig(dct_algorithm=DctAlgorithm.BIN_DCT, bin_dct_descale=True),
    )
    psnr_real = _decode_psnr(rgb, real.file_bytes)
    psnr_parity = _decode_psnr(rgb, parity.file_bytes)
    psnr_fixed = _decode_psnr(rgb, fixed.file_bytes)
    assert psnr_fixed > psnr_parity + 5.0, (
        f"descale {psnr_fixed:.1f} dB should beat parity {psnr_parity:.1f} dB"
    )
    assert psnr_fixed > psnr_real - 6.0, (
        f"descale {psnr_fixed:.1f} dB too far below real-dct {psnr_real:.1f} dB"
    )
    assert len(fixed.file_bytes) < len(parity.file_bytes)


@pytest.mark.slow
def test_bin_dct_descale_coefficients_near_real_dct(rng):
    """Descaled binDCT quantized coefficients approximate the real DCT's
    (that is the point of folding the gains); bug-parity ones do not."""
    rgb = rng.integers(0, 256, size=(16, 16, 3), dtype=np.uint8)
    config_real = EncoderConfig(subsampling_ratio=(4, 4, 4))
    _, real_coeffs = pipeline.encode_array(rgb, config_real, return_coeffs=True)
    _, fixed_coeffs = pipeline.encode_array(
        rgb,
        EncoderConfig(
            subsampling_ratio=(4, 4, 4),
            dct_algorithm=DctAlgorithm.BIN_DCT,
            bin_dct_descale=True,
        ),
        return_coeffs=True,
    )
    _, parity_coeffs = pipeline.encode_array(
        rgb,
        EncoderConfig(
            subsampling_ratio=(4, 4, 4), dct_algorithm=DctAlgorithm.BIN_DCT
        ),
        return_coeffs=True,
    )
    err_fixed = np.mean(
        np.abs(fixed_coeffs[0].astype(np.int32) - real_coeffs[0].astype(np.int32))
    )
    err_parity = np.mean(
        np.abs(parity_coeffs[0].astype(np.int32) - real_coeffs[0].astype(np.int32))
    )
    assert err_fixed < 1.0, f"mean |descale - real| = {err_fixed:.2f}"
    assert err_fixed < err_parity / 2


def test_compression_actually_compresses():
    rgb = _gradient_image(128, 96)
    result = pipeline.encode_array(rgb, EncoderConfig())
    raw_bytes = 128 * 96 * 3
    assert len(result.file_bytes) < raw_bytes // 4


def test_encode_file_bmp_roundtrip(tmp_path, rng):
    rgb = rng.integers(0, 256, size=(24, 33, 3), dtype=np.uint8)
    bmp_path = tmp_path / "input.bmp"
    out_path = tmp_path / "output.jpeg"
    bmp.write(bmp_path, rgb)
    assert np.array_equal(bmp.read(bmp_path), rgb)
    result = pipeline.encode_file(bmp_path, out_path, EncoderConfig())
    data = out_path.read_bytes()
    assert data == result.file_bytes
    img = Image.open(_io.BytesIO(data))
    img.load()
    assert img.size == (33, 24)


def test_pil_decodes_our_bmp_writer(tmp_path, rng):
    """Our BMP fixtures must be readable by an independent implementation."""
    rgb = rng.integers(0, 256, size=(21, 13, 3), dtype=np.uint8)
    path = tmp_path / "x.bmp"
    bmp.write(path, rgb)
    via_pil = np.asarray(Image.open(path).convert("RGB"))
    assert np.array_equal(via_pil, rgb)


def test_ff_stuffing():
    payload = np.array([0x12, 0xFF, 0x00, 0xFF, 0xFF, 0x34], dtype=np.uint8)
    assert jfif.stuff_bytes(payload) == bytes(
        [0x12, 0xFF, 0x00, 0x00, 0xFF, 0x00, 0xFF, 0x00, 0x34]
    )
    clean = np.array([1, 2, 3], dtype=np.uint8)
    assert jfif.stuff_bytes(clean) == bytes([1, 2, 3])


def test_header_structure():
    geom = EncoderConfig(subsampling_ratio=(4, 2, 0)).geometry(100, 50)
    header = jfif.header_bytes(geom)
    assert header.startswith(b"\xff\xd8\xff\xe0")
    # SOF0 carries height then width, big-endian, and Y sampling 0x22.
    sof = header[header.index(b"\xff\xc0"):]
    assert sof[5:7] == (50).to_bytes(2, "big")
    assert sof[7:9] == (100).to_bytes(2, "big")
    assert sof[11] == 0x22
    # Ends with the SOS header, spectral selection 0..63.
    assert header.endswith(bytes([0, 63, 0]))


def test_capacity_overflow_retry(rng):
    """An undersized capacity estimate must detect overflow and retry.

    Noise at 256x256 4:4:4 packs well over the 16 KiB capacity floor, so a
    tiny bytes-per-pixel estimate forces at least one trip up the
    pipeline.next_capacity_bytes ladder; the result must be identical to an
    encode whose first buffer already fit.
    """
    rgb = rng.integers(0, 256, size=(256, 256, 3), dtype=np.uint8)
    roomy = EncoderConfig(subsampling_ratio=(4, 4, 4))
    tight = EncoderConfig(
        subsampling_ratio=(4, 4, 4), capacity_bytes_per_pixel=1e-6
    )
    geom = roomy.geometry(256, 256)
    first_cap = pipeline.default_capacity_bytes(geom, 1e-6)
    reference = pipeline.encode_array(rgb, roomy)
    assert reference.bit_length > 8 * first_cap, "content must overflow"
    retried = pipeline.encode_array(rgb, tight)
    assert retried.file_bytes == reference.file_bytes


def test_capacity_ladder_caps_at_worst_case():
    geom = EncoderConfig().geometry(64, 64)
    worst = pipeline.worst_case_capacity_bytes(geom)
    cap = pipeline.default_capacity_bytes(geom)
    seen = set()
    while cap < worst:
        assert cap not in seen, "ladder must strictly grow"
        seen.add(cap)
        cap = pipeline.next_capacity_bytes(geom, cap)
    assert cap == worst
    assert pipeline.next_capacity_bytes(geom, cap) == worst


def test_validate_flag_passes_for_valid_input(rng):
    rgb = rng.integers(0, 256, size=(16, 24, 3), dtype=np.uint8)
    config = EncoderConfig(subsampling_ratio=(4, 2, 0), validate=True)
    plain = EncoderConfig(subsampling_ratio=(4, 2, 0))
    a = pipeline.encode_array(rgb, config)
    b = pipeline.encode_array(rgb, plain)
    assert a.file_bytes == b.file_bytes


def test_validate_scan_ranges_raises_like_reference():
    with pytest.raises(ValueError, match="DC coefficient bit length"):
        pipeline.validate_scan_ranges(1 << 11, 0)
    with pytest.raises(ValueError, match="AC coefficient bit length"):
        pipeline.validate_scan_ranges(0, 1 << 10)
    pipeline.validate_scan_ranges((1 << 11) - 1, (1 << 10) - 1)


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_fuzzed_geometries_match_oracle(seed):
    """Random odd geometries across ratios, full-file byte identity."""
    rng = np.random.default_rng(seed)
    width = int(rng.integers(1, 70))
    height = int(rng.integers(1, 70))
    ratio = [(4, 4, 4), (4, 2, 2), (4, 2, 0)][seed % 3]
    rgb = rng.integers(0, 256, size=(height, width, 3), dtype=np.uint8)
    config = EncoderConfig(subsampling_ratio=ratio)
    device = pipeline.encode_array(rgb, config)
    golden = oracle.encode_oracle(rgb, config)
    assert device.file_bytes == jfif.assemble(golden.geom, golden.entropy_bytes)
