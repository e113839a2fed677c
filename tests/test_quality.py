"""The --quality extension: libjpeg-scaled quantization tables.

The reference has fixed Annex-K tables (quant_tables.rs:2-23;
jpeg_theory.md:162 lists quality scaling as an unimplemented
consideration). Our extension applies the standard libjpeg formula
(tables.scaled_quant_tables) end to end: DCT quantization, DQT emission,
and the oracle. quality=None stays reference-parity; quality=50 must be
numerically identical to None.
"""

import io

import numpy as np
import pytest
from PIL import Image

from jpeg_encoder_tpu import oracle, pipeline, tables
from jpeg_encoder_tpu.config import DctAlgorithm, EncoderConfig
from jpeg_encoder_tpu.io import jfif
from jpeg_encoder_tpu.utils import corpus


def _decode(file_bytes: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(file_bytes)).convert("RGB"))


# ---------------------------------------------------------------------------
# Table scaling math
# ---------------------------------------------------------------------------

def test_quality_50_is_identity():
    qy, qc = tables.scaled_quant_tables(50)
    assert np.array_equal(qy, tables.Y_QUANT_TABLE)
    assert np.array_equal(qc, tables.C_QUANT_TABLE)


def test_quality_none_is_base_tables():
    qy, qc = tables.scaled_quant_tables(None)
    assert qy is tables.Y_QUANT_TABLE
    assert qc is tables.C_QUANT_TABLE


def test_quality_scaling_monotone_and_clamped():
    # Lower quality -> coarser (entrywise >=); q=1 clamps to 255, q=100
    # floors at 1 (the libjpeg formula gives scale=0 -> all-1 tables).
    prev = None
    for q in (1, 10, 25, 50, 75, 90, 100):
        qy, qc = tables.scaled_quant_tables(q)
        assert qy.dtype == np.uint8 and qc.dtype == np.uint8
        assert qy.min() >= 1 and qc.min() >= 1
        if prev is not None:
            assert (prev[0].astype(int) >= qy.astype(int)).all()
            assert (prev[1].astype(int) >= qc.astype(int)).all()
        prev = (qy, qc)
    q1 = tables.scaled_quant_tables(1)[0]
    assert q1.max() == 255 and q1.min() == 255  # 5000% scale clamps all
    q100 = tables.scaled_quant_tables(100)[0]
    assert q100.max() == 1  # scale=0: every entry (0*b+50)//100 = 0 -> 1


def test_quality_out_of_range_rejected():
    with pytest.raises(ValueError):
        tables.scaled_quant_tables(0)
    with pytest.raises(ValueError):
        tables.scaled_quant_tables(101)
    with pytest.raises(ValueError):
        EncoderConfig(quality=0)


# ---------------------------------------------------------------------------
# End-to-end behavior
# ---------------------------------------------------------------------------

def test_quality_50_files_byte_identical_to_default(rng):
    rgb = rng.integers(0, 256, size=(40, 56, 3), dtype=np.uint8)
    base = pipeline.encode_array(rgb, EncoderConfig())
    q50 = pipeline.encode_array(rgb, EncoderConfig(quality=50))
    assert base.file_bytes == q50.file_bytes


@pytest.mark.parametrize("quality", [25, 85])
@pytest.mark.parametrize("ratio", [(4, 2, 0), (4, 4, 4)])
def test_device_matches_oracle_at_quality(rng, quality, ratio):
    """The scaled tables flow through the device DCT, the scan encoder and
    the DQT segments exactly as through the scalar oracle."""
    rgb = rng.integers(0, 256, size=(24, 40, 3), dtype=np.uint8)
    cfg = EncoderConfig(subsampling_ratio=ratio, quality=quality)
    golden = oracle.encode_oracle(rgb, cfg)
    device = pipeline.encode_array(rgb, cfg)
    assert device.bit_length == golden.bit_length
    assert device.file_bytes == jfif.assemble(
        golden.geom, golden.entropy_bytes, quality=quality
    )


def test_dqt_segments_carry_scaled_tables():
    header = jfif.header_bytes(
        EncoderConfig(quality=80).geometry(16, 16), quality=80
    )
    qy, qc = tables.scaled_quant_tables(80)
    want_y = qy.reshape(64)[tables.ZIGZAG_ORDER].tobytes()
    want_c = qc.reshape(64)[tables.ZIGZAG_ORDER].tobytes()
    assert want_y in header and want_c in header
    # And the default tables must NOT appear (they differ at q=80).
    base_y = tables.Y_QUANT_TABLE.reshape(64)[tables.ZIGZAG_ORDER].tobytes()
    assert base_y not in header


@pytest.mark.slow
def test_quality_psnr_and_size_tradeoff():
    """Higher quality -> higher decoded PSNR and larger files on
    photographic-statistics content (the whole point of the knob)."""
    rgb = corpus.images(128, 192)["portrait"]
    stats = {}
    for q in (10, None, 90):
        res = pipeline.encode_array(rgb, EncoderConfig(quality=q))
        stats[q] = (corpus.psnr(rgb, _decode(res.file_bytes)),
                    len(res.file_bytes))
    assert stats[10][0] < stats[None][0] < stats[90][0]
    assert stats[10][1] < stats[None][1] < stats[90][1]
    assert stats[90][0] > 30.0  # q90 4:2:0 should be comfortably good


@pytest.mark.slow
def test_batch_and_tiled_quality_match_single(rng):
    import jax
    from jax.sharding import Mesh

    from jpeg_encoder_tpu.parallel import batch as batch_lib
    from jpeg_encoder_tpu.parallel import tiled
    from jpeg_encoder_tpu.parallel.mesh import DATA_AXIS

    cfg = EncoderConfig(quality=70)
    images = rng.integers(0, 256, size=(4, 32, 48, 3), dtype=np.uint8)
    singles = [pipeline.encode_array(im, cfg).file_bytes for im in images]

    mesh = Mesh(np.array(jax.devices()[:4]), (DATA_AXIS,))
    files = batch_lib.encode_batch(images, cfg, mesh)
    assert files == singles

    mesh2 = Mesh(np.array(jax.devices()[:2]), (DATA_AXIS,))
    tiled_res = tiled.encode_tiled(np.asarray(images[0]), cfg, mesh2)
    assert tiled_res.file_bytes == singles[0]


def test_cli_quality_flag(tmp_path, rng):
    from jpeg_encoder_tpu import cli
    from jpeg_encoder_tpu.io import bmp

    rgb = rng.integers(0, 256, size=(16, 24, 3), dtype=np.uint8)
    path = tmp_path / "img.bmp"
    bmp.write(path, rgb)

    assert cli.main(["-i", str(path), "-q", "0"]) == 2
    assert cli.main(["-i", str(path), "-q", "101"]) == 2

    out_default = tmp_path / "default.jpeg"
    out_q50 = tmp_path / "q50.jpeg"
    out_q90 = tmp_path / "q90.jpeg"
    assert cli.main(["-i", str(path), "-o", str(out_default)]) == 0
    assert cli.main(["-i", str(path), "-o", str(out_q50), "-q", "50"]) == 0
    assert cli.main(["-i", str(path), "-o", str(out_q90), "-q", "90"]) == 0
    assert out_q50.read_bytes() == out_default.read_bytes()
    img = Image.open(out_q90)
    img.load()
    assert img.size == (24, 16)
