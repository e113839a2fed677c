"""Optimized Huffman tables (--optimize-huffman): the -optimize analog.

Two-pass encoding: a device statistics pass (ops/entropy.symbol_histograms)
feeds ITU-T T.81 K.2 table construction (tables.optimal_spec), and the
encode pass emits per-image canonical tables through the DHT segments.
Correctness anchors: PIL decodes the optimized file PIXEL-IDENTICALLY to
the fixed-table file (same coefficients, different codes), the NumPy
oracle re-encoding with the same specs reproduces the bitstream BYTE for
byte, and files never grow.
"""

import io

import numpy as np
import pytest
from PIL import Image

from jpeg_encoder_tpu import oracle, pipeline, tables
from jpeg_encoder_tpu.config import EncoderConfig
from jpeg_encoder_tpu.utils import corpus


def _decode(file_bytes: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(file_bytes)).convert("RGB"))


@pytest.mark.parametrize("ratio", [(4, 2, 0), (4, 4, 4)])
def test_optimized_decodes_identically_and_shrinks(ratio):
    rgb = corpus.landscape(96, 144)
    std = pipeline.encode_array(rgb, EncoderConfig(subsampling_ratio=ratio))
    opt = pipeline.encode_array(
        rgb, EncoderConfig(subsampling_ratio=ratio, optimize_huffman=True)
    )
    assert np.array_equal(_decode(std.file_bytes), _decode(opt.file_bytes))
    assert len(opt.file_bytes) < len(std.file_bytes)
    # The scan itself must shrink too, not just the smaller DHT segments.
    assert opt.bit_length < std.bit_length


def test_optimized_bitstream_matches_oracle_with_same_specs():
    """Byte-level anchor: re-derive the stream with the oracle's bit-serial
    encoder using the device-built specs; file and payload must match."""
    from jpeg_encoder_tpu.io import jfif
    from jpeg_encoder_tpu.ops import entropy
    import jax.numpy as jnp

    rgb = corpus.portrait(80, 112)
    cfg = EncoderConfig()
    geom = cfg.geometry(112, 80)
    opt = pipeline.encode_array(
        rgb, EncoderConfig(optimize_huffman=True)
    )
    hist = np.asarray(pipeline.compiled_stats_encoder(
        geom, cfg.dct_algorithm
    )(jnp.asarray(rgb)))
    specs, _, _ = pipeline.optimal_specs_and_luts(hist)

    ref = oracle.encode_oracle(rgb, cfg)
    payload, bit_length = oracle.entropy_encode(
        ref.y_coeffs, ref.cb_coeffs, ref.cr_coeffs, ref.geom, specs=specs
    )
    assert opt.bit_length == bit_length
    assert opt.entropy_payload == payload
    assert opt.file_bytes == jfif.assemble(
        ref.geom, payload, dht_specs=specs
    )


def test_optimized_composes_with_restart_and_quality():
    rgb = corpus.foliage(64, 96)
    base_cfg = EncoderConfig(quality=85)
    cfg = EncoderConfig(
        quality=85, optimize_huffman=True, restart_interval=2
    )
    std = pipeline.encode_array(rgb, base_cfg)
    opt = pipeline.encode_array(rgb, cfg)
    assert np.array_equal(_decode(std.file_bytes), _decode(opt.file_bytes))
    assert b"\xff\xdd" in opt.file_bytes  # DRI present
    assert b"\xff\xd0" in opt.file_bytes  # restart markers present


def test_optimized_batch_matches_single():
    from jpeg_encoder_tpu.parallel import batch as batch_lib
    from jpeg_encoder_tpu.parallel import mesh as mesh_lib

    images = np.stack(
        [corpus.landscape(48, 64, seed=s) for s in (7, 8)]
    )
    cfg = EncoderConfig(optimize_huffman=True)
    files = batch_lib.encode_batch(images, cfg, mesh_lib.data_mesh(2))
    for i in range(2):
        assert files[i] == pipeline.encode_array(images[i], cfg).file_bytes


def test_optimized_tiled_matches_single_device():
    """Band tiling + optimized Huffman: the cross-band table agreement
    (per-band histograms with chained DC predictors, psum'd over ICI,
    one table set for all bands) must reproduce the single-device
    optimized file byte for byte — including uneven band splits."""
    from jpeg_encoder_tpu.parallel import mesh as mesh_lib
    from jpeg_encoder_tpu.parallel import tiled

    rgb = corpus.landscape(96, 64)
    cfg = EncoderConfig(optimize_huffman=True)
    single = pipeline.encode_array(rgb, cfg)
    for n_dev in (2, 3, 8):  # 8 over 6 MCU rows = dead trailing bands
        got = tiled.encode_tiled(rgb, cfg, mesh_lib.data_mesh(n_dev))
        assert got.file_bytes == single.file_bytes, n_dev
        assert got.bit_length == single.bit_length


def test_optimized_tiled_restart_matches_single_device():
    """The triple composition — band tiling + restart framing + optimized
    Huffman — byte-identical to the single-device encode (per-interval DC
    resets make the stats pass chain-free; tables still agree globally)."""
    from jpeg_encoder_tpu.parallel import mesh as mesh_lib
    from jpeg_encoder_tpu.parallel import tiled

    rgb = corpus.portrait(96, 64)
    cfg = EncoderConfig(optimize_huffman=True, restart_interval=4)
    single = pipeline.encode_array(rgb, cfg)
    got = tiled.encode_tiled(rgb, cfg, mesh_lib.data_mesh(2))
    assert got.file_bytes == single.file_bytes
    assert b"\xff\xd0" in got.file_bytes


def test_optimized_return_coeffs_refused():
    with pytest.raises(ValueError, match="optimized Huffman"):
        pipeline.encode_array(
            corpus.landscape(16, 16),
            EncoderConfig(optimize_huffman=True), return_coeffs=True,
        )


def test_optimal_spec_properties_fuzz():
    """K.2 construction invariants over random frequency profiles."""
    rng = np.random.default_rng(0)
    for trial in range(60):
        n_active = int(rng.integers(1, 257))
        freq = np.zeros(256, np.int64)
        idx = rng.choice(256, n_active, replace=False)
        # heavy-tailed counts force deep trees (exercises the K.3 fold)
        freq[idx] = np.maximum(
            1, (rng.pareto(0.3, n_active) * 10).astype(np.int64)
        )
        spec = tables.optimal_spec(freq)
        lens = spec.lengths_by_order
        assert len(spec.symbols) == n_active
        assert int(lens.max()) <= 16
        kraft = sum(2.0 ** -int(l) for l in lens)
        assert kraft < 1.0 + 1e-12, (trial, kraft)
        for c, l in zip(spec.codes_by_order, lens):
            assert int(c) != (1 << int(l)) - 1, (trial, "all-ones code")
        assert sorted(set(spec.symbols)) == sorted(idx.tolist())


def test_cli_optimize_flag(tmp_path):
    from jpeg_encoder_tpu import cli
    from jpeg_encoder_tpu.io import bmp

    rgb = corpus.landscape(48, 64)
    path = tmp_path / "img.bmp"
    bmp.write(path, rgb)
    plain = tmp_path / "plain.jpeg"
    opt = tmp_path / "opt.jpeg"
    assert cli.main(["-i", str(path), "-o", str(plain)]) == 0
    assert cli.main(
        ["-i", str(path), "-o", str(opt), "--optimize-huffman"]
    ) == 0
    a = _decode(plain.read_bytes())
    b = _decode(opt.read_bytes())
    assert np.array_equal(a, b)
    assert opt.stat().st_size < plain.stat().st_size


def test_optimized_batch_chunked_matches_single(monkeypatch):
    """Batched optimize across several chunks (forced tiny), including
    padding rows, must reproduce the single-image optimized encodes."""
    from jpeg_encoder_tpu.parallel import batch as batch_lib
    from jpeg_encoder_tpu.parallel import mesh as mesh_lib

    monkeypatch.setattr(batch_lib, "chunk_input_budget", lambda: 48 * 64 * 3)
    images = np.stack(
        [corpus.landscape(48, 64, seed=s) for s in (7, 8, 9)]
    )
    cfg = EncoderConfig(optimize_huffman=True)
    files = batch_lib.encode_batch(images, cfg, mesh_lib.data_mesh(2))
    assert len(files) == 3
    for i in range(3):
        assert files[i] == pipeline.encode_array(images[i], cfg).file_bytes


def test_optimized_batch_restart_matches_single():
    from jpeg_encoder_tpu.parallel import batch as batch_lib
    from jpeg_encoder_tpu.parallel import mesh as mesh_lib

    images = np.stack(
        [corpus.foliage(48, 64, seed=s) for s in (3, 4)]
    )
    cfg = EncoderConfig(optimize_huffman=True, restart_interval=2)
    files = batch_lib.encode_batch(images, cfg, mesh_lib.data_mesh(2))
    for i in range(2):
        assert files[i] == pipeline.encode_array(images[i], cfg).file_bytes


def test_optimized_tiled_restart_uneven_matches_single_device():
    """Quadruple composition: band tiling + UNEVEN split + restart framing
    + optimized Huffman — dead-band stats masking, auto-aligned bands, and
    the shared table set must still reproduce the single-device file."""
    from jpeg_encoder_tpu.parallel import mesh as mesh_lib
    from jpeg_encoder_tpu.parallel import tiled

    rgb = corpus.foliage(96, 64)  # 6 MCU rows at 4:2:0
    cfg = EncoderConfig(optimize_huffman=True, restart_interval=4)
    single = pipeline.encode_array(rgb, cfg)
    # 8 devices over 6 MCU rows: every band is one MCU row (4 MCUs =
    # one interval), two devices fully dead.
    got = tiled.encode_tiled(rgb, cfg, mesh_lib.data_mesh(8))
    assert got.file_bytes == single.file_bytes
