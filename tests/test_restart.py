"""Restart-marker extension (DRI/RSTn): structure, semantics, decode parity.

The reference has no restart machinery (file.rs:77-90 emits one unbroken
scan); this opt-in extension (EncoderConfig.restart_interval / CLI
--restart-interval) re-encodes each N-MCU run as an independent segment
with reset DC predictors, 1-bit byte alignment, and RST(n mod 8) joins —
ITU-T T.81 B.2.4.4 / E.2.4 semantics. The decisive check: PIL (an
independent decoder) must produce PIXEL-IDENTICAL output for the restart
file and the unbroken-scan file of the same image — the quantized
coefficients are the same, only the stream framing differs.
"""

import io

import numpy as np
import pytest
from PIL import Image

from jpeg_encoder_tpu import pipeline
from jpeg_encoder_tpu.config import EncoderConfig


def _image(h=75, w=99, seed=3):
    rng = np.random.default_rng(seed)
    return rng.normal(128, 40, (h, w, 3)).clip(0, 255).astype(np.uint8)


def _markers(file_bytes: bytes) -> list[int]:
    """RSTn indices in emission order (stuffing makes 0xFF 0xDn unambiguous)."""
    found = []
    data = file_bytes
    i = data.index(b"\xff\xda")  # scan starts after SOS
    while i < len(data) - 1:
        if data[i] == 0xFF and 0xD0 <= data[i + 1] <= 0xD7:
            found.append(data[i + 1] - 0xD0)
        i += 1
    return found


@pytest.mark.parametrize("ratio", [(4, 2, 0), (4, 2, 2), (4, 4, 4)])
@pytest.mark.parametrize("interval", [1, 3])
def test_restart_decodes_identically(ratio, interval):
    rgb = _image()
    plain = pipeline.encode_array(
        rgb, EncoderConfig(subsampling_ratio=ratio)
    ).file_bytes
    restart = pipeline.encode_array(
        rgb, EncoderConfig(subsampling_ratio=ratio, restart_interval=interval)
    ).file_bytes

    geom = EncoderConfig(subsampling_ratio=ratio).geometry(99, 75)
    n_int = -(-geom.num_mcus // interval)
    # DRI segment with the interval value sits before SOS.
    assert (b"\xff\xdd" + (4).to_bytes(2, "big")
            + interval.to_bytes(2, "big")) in restart
    marks = _markers(restart)
    assert marks == [k % 8 for k in range(n_int - 1)]

    img_plain = np.asarray(Image.open(io.BytesIO(plain)).convert("RGB"))
    img_restart = np.asarray(Image.open(io.BytesIO(restart)).convert("RGB"))
    assert np.array_equal(img_plain, img_restart)


def test_restart_interval_beyond_image_has_no_markers():
    rgb = _image(40, 40)
    cfg = EncoderConfig(restart_interval=10_000)
    out = pipeline.encode_array(rgb, cfg)
    assert _markers(out.file_bytes) == []
    assert b"\xff\xdd" in out.file_bytes
    img = np.asarray(Image.open(io.BytesIO(out.file_bytes)).convert("RGB"))
    plain = pipeline.encode_array(rgb, EncoderConfig()).file_bytes
    assert np.array_equal(
        img, np.asarray(Image.open(io.BytesIO(plain)).convert("RGB"))
    )


def test_restart_validates_interval_range():
    with pytest.raises(ValueError):
        EncoderConfig(restart_interval=0)
    with pytest.raises(ValueError):
        EncoderConfig(restart_interval=70_000)
    with pytest.raises(ValueError):
        pipeline.encode_array(
            _image(16, 16), EncoderConfig(restart_interval=4),
            return_coeffs=True,
        )


def test_restart_quality_and_descale_compose():
    rgb = _image(64, 48, seed=9)
    cfg = EncoderConfig(
        restart_interval=2, quality=80,
        bin_dct_descale=True,
        dct_algorithm=pipeline.DctAlgorithm.BIN_DCT,
    )
    out = pipeline.encode_array(rgb, cfg)
    img = np.asarray(Image.open(io.BytesIO(out.file_bytes)).convert("RGB"))
    assert img.shape == (64, 48, 3)
    # Framing only: same config without markers decodes identically.
    plain_cfg = EncoderConfig(
        quality=80, bin_dct_descale=True,
        dct_algorithm=pipeline.DctAlgorithm.BIN_DCT,
    )
    plain = pipeline.encode_array(rgb, plain_cfg).file_bytes
    assert np.array_equal(
        img, np.asarray(Image.open(io.BytesIO(plain)).convert("RGB"))
    )


def test_restart_batch_path_matches_single(tmp_path):
    """encode_batch with restart produces the single-image path's files,
    sharded over the virtual 8-device mesh."""
    from jpeg_encoder_tpu.parallel import batch as batch_lib
    from jpeg_encoder_tpu.parallel import mesh as mesh_lib

    rng = np.random.default_rng(21)
    images = rng.normal(128, 40, (3, 48, 64, 3)).clip(0, 255).astype(np.uint8)
    cfg = EncoderConfig(restart_interval=2)
    files = batch_lib.encode_batch(images, cfg, mesh_lib.data_mesh(8))
    assert len(files) == 3
    for i, f in enumerate(files):
        single = pipeline.encode_array(images[i], cfg).file_bytes
        assert f == single


def test_restart_tiled_byte_identical_to_single_device():
    """Tiled restart framing = the single-device restart file, byte for
    byte: with intervals aligned to band boundaries the interval
    partition is identical, DC predictors reset at each one (no
    cross-band state), and assembly is the same concatenation."""
    from jpeg_encoder_tpu.parallel import mesh as mesh_lib
    from jpeg_encoder_tpu.parallel import tiled

    rgb = _image(96, 64, seed=13)  # 4:2:0: 6 MCU rows x 4 cols
    for n_dev, interval in ((2, 4), (3, 2), (4, 1)):
        cfg = EncoderConfig(restart_interval=interval)
        single = pipeline.encode_array(rgb, cfg)
        tiled_r = tiled.encode_tiled(rgb, cfg, mesh_lib.data_mesh(n_dev))
        assert tiled_r.file_bytes == single.file_bytes, (n_dev, interval)
        assert tiled_r.bit_length == single.bit_length


def test_restart_tiled_uneven_bands():
    """8 devices over 6 MCU rows: trailing dead bands' intervals drop."""
    from jpeg_encoder_tpu.parallel import mesh as mesh_lib
    from jpeg_encoder_tpu.parallel import tiled

    rgb = _image(96, 64, seed=14)
    cfg = EncoderConfig(restart_interval=4)
    single = pipeline.encode_array(rgb, cfg)
    tiled_r = tiled.encode_tiled(rgb, cfg, mesh_lib.data_mesh(8))
    assert tiled_r.file_bytes == single.file_bytes


def test_restart_tiled_auto_aligns_band_split():
    """When the even band split misaligns with the interval, encode_tiled
    picks a larger interval-aligned band instead of collapsing to one
    device: 6x4 MCUs over 2 devices with interval 5 re-splits to 5-row
    bands (20 MCUs = 4 whole intervals; band 1 ends the image mid-
    interval, which is legal). No warning, byte-identical output."""
    import warnings as warnings_mod

    from jpeg_encoder_tpu.parallel import mesh as mesh_lib
    from jpeg_encoder_tpu.parallel import tiled

    rgb = _image(96, 64, seed=15)
    cfg = EncoderConfig(restart_interval=5)  # 5 does not divide 3x4 MCUs
    with warnings_mod.catch_warnings():
        warnings_mod.simplefilter("error")
        out = tiled.encode_tiled(rgb, cfg, mesh_lib.data_mesh(2))
    assert out.file_bytes == pipeline.encode_array(rgb, cfg).file_bytes


def test_restart_tiled_alignment_matrix():
    """Mesh-size x interval matrix: every cell either auto-aligns (byte-
    identical, no warning) or — only when NO aligned multi-band split
    exists — falls back with the warning."""
    import warnings as warnings_mod

    from jpeg_encoder_tpu.parallel import mesh as mesh_lib
    from jpeg_encoder_tpu.parallel import tiled

    rgb = _image(96, 64, seed=16)  # 4:2:0: 6 MCU rows x 4 cols = 24 MCUs
    geom = EncoderConfig().geometry(64, 96)
    fallbacks = 0
    for n_dev in (2, 3, 4):
        for interval in (1, 2, 3, 5, 7, 8, 11, 24):
            cfg = EncoderConfig(restart_interval=interval)
            single = pipeline.encode_array(rgb, cfg)
            base = -(-geom.mcu_rows // n_dev)
            aligned = tiled._aligned_band_rows(geom, n_dev, interval)
            has_aligned = (
                (base * geom.mcu_cols) % interval == 0
                or -(-geom.mcu_rows // base) == 1
                or (aligned is not None and -(-geom.mcu_rows // aligned) > 1)
            )
            if has_aligned:
                with warnings_mod.catch_warnings():
                    warnings_mod.simplefilter("error")
                    out = tiled.encode_tiled(
                        rgb, cfg, mesh_lib.data_mesh(n_dev)
                    )
            else:
                with pytest.warns(RuntimeWarning, match="no band split"):
                    out = tiled.encode_tiled(
                        rgb, cfg, mesh_lib.data_mesh(n_dev)
                    )
                fallbacks += 1
            assert out.file_bytes == single.file_bytes, (n_dev, interval)
    assert fallbacks >= 1  # the matrix must exercise the no-split branch


def test_restart_capacity_retry_ladder():
    """A too-small initial per-interval buffer walks the ladder and still
    produces the byte-identical file (capacity is an implementation
    detail, never a semantic)."""
    rng = np.random.default_rng(33)
    rgb = rng.integers(0, 256, (128, 128, 3), dtype=np.uint8)  # noise
    big = EncoderConfig(restart_interval=10_000, quality=95)
    small = EncoderConfig(
        restart_interval=10_000, quality=95, capacity_bytes_per_pixel=0.01
    )
    cap0 = pipeline.restart_default_capacity_bytes(
        big.geometry(128, 128), 10_000, 0.01
    )
    out_small = pipeline.encode_array(rgb, small)
    assert out_small.bit_length > 8 * cap0  # the ladder really fired
    assert out_small.file_bytes == pipeline.encode_array(rgb, big).file_bytes


def test_restart_batch_retry_matches(tmp_path):
    """Batch restart overflow retries per image and matches single-image."""
    from jpeg_encoder_tpu.parallel import batch as batch_lib
    from jpeg_encoder_tpu.parallel import mesh as mesh_lib

    rng = np.random.default_rng(34)
    images = rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    cfg = EncoderConfig(
        restart_interval=10_000, quality=95, capacity_bytes_per_pixel=0.01
    )
    files = batch_lib.encode_batch(images, cfg, mesh_lib.data_mesh(2))
    for i in range(2):
        assert files[i] == pipeline.encode_array(images[i], cfg).file_bytes


@pytest.mark.parametrize("dims", [(33, 49), (41, 33), (17, 17)])
def test_restart_refuses_quirk_geometries(dims):
    """dim % (8*factor) == 1 quirk geometries make the reference emit
    fewer MCUs than the SOF implies; restart markers would resync the
    decoder to absolute positions and the file would decode shifted
    (observed with PIL: trailing gray). The encoder must refuse, in every
    mode."""
    h, w = dims
    rgb = _image(h, w, seed=40 + h)
    cfg = EncoderConfig(restart_interval=2)
    with pytest.raises(ValueError, match="quirk geometry"):
        pipeline.encode_array(rgb, cfg)

    from jpeg_encoder_tpu.parallel import batch as batch_lib
    from jpeg_encoder_tpu.parallel import mesh as mesh_lib
    from jpeg_encoder_tpu.parallel import tiled

    with pytest.raises(ValueError, match="quirk geometry"):
        batch_lib.encode_batch(rgb[None], cfg, mesh_lib.data_mesh(2))
    with pytest.raises(ValueError, match="quirk geometry"):
        tiled.encode_tiled(rgb, cfg, mesh_lib.data_mesh(2))


def test_restart_odd_but_aligned_dims_decode_identically():
    """Odd dims whose chroma grid still aligns (75x99) keep working."""
    rgb = _image(75, 99, seed=44)
    plain = pipeline.encode_array(rgb, EncoderConfig()).file_bytes
    marked = pipeline.encode_array(
        rgb, EncoderConfig(restart_interval=2)
    ).file_bytes
    a = np.asarray(Image.open(io.BytesIO(plain)).convert("RGB"))
    b = np.asarray(Image.open(io.BytesIO(marked)).convert("RGB"))
    assert np.array_equal(a, b)


def test_restart_tiled_444():
    from jpeg_encoder_tpu.parallel import mesh as mesh_lib
    from jpeg_encoder_tpu.parallel import tiled

    rgb = _image(48, 64, seed=16)  # 4:4:4: 6 MCU rows x 8 cols
    cfg = EncoderConfig(subsampling_ratio=(4, 4, 4), restart_interval=8)
    single = pipeline.encode_array(rgb, cfg)
    tiled_r = tiled.encode_tiled(rgb, cfg, mesh_lib.data_mesh(3))
    assert tiled_r.file_bytes == single.file_bytes


@pytest.mark.slow
def test_restart_fuzz_geometries_vs_pil():
    """Random geometries x ratios x intervals: aligned grids must decode
    pixel-identically to the unbroken scan; misaligned ones must refuse."""
    rng = np.random.default_rng(77)
    ratios = [(4, 2, 0), (4, 2, 2), (4, 4, 4)]
    checked = refused = 0
    for _ in range(24):
        h = int(rng.integers(9, 120))
        w = int(rng.integers(9, 120))
        ratio = ratios[int(rng.integers(3))]
        interval = int(rng.integers(1, 9))
        rgb = rng.normal(128, 40, (h, w, 3)).clip(0, 255).astype(np.uint8)
        cfg = EncoderConfig(subsampling_ratio=ratio, restart_interval=interval)
        geom = cfg.geometry(w, h)
        if not geom.mcu_grid_aligned:
            with pytest.raises(ValueError, match="quirk geometry"):
                pipeline.encode_array(rgb, cfg)
            refused += 1
            continue
        marked = pipeline.encode_array(rgb, cfg).file_bytes
        plain = pipeline.encode_array(
            rgb, EncoderConfig(subsampling_ratio=ratio)
        ).file_bytes
        a = np.asarray(Image.open(io.BytesIO(plain)).convert("RGB"))
        b = np.asarray(Image.open(io.BytesIO(marked)).convert("RGB"))
        assert np.array_equal(a, b), (h, w, ratio, interval)
        checked += 1
    assert checked >= 10  # the draw must actually exercise the hot path


@pytest.mark.parametrize("ratio", [(4, 2, 0), (4, 2, 2), (4, 4, 4)])
def test_restart_full_file_byte_identical_to_oracle(ratio):
    """BYTE identity of restart files against the NumPy golden model:
    oracle.entropy_encode_restart re-derives interval segmentation, DC
    resets, and spec 1-padding from T.81 independently of the device
    path and of io/jfif's padding helper."""
    from jpeg_encoder_tpu import oracle
    from jpeg_encoder_tpu.io import jfif

    rgb = _image(40, 48, seed=50)
    for interval in (1, 3, 7):
        cfg = EncoderConfig(subsampling_ratio=ratio, restart_interval=interval)
        got = pipeline.encode_array(rgb, cfg)
        ref = oracle.encode_oracle(
            rgb, EncoderConfig(subsampling_ratio=ratio)
        )
        segments, bits = oracle.entropy_encode_restart(
            ref.y_coeffs, ref.cb_coeffs, ref.cr_coeffs, ref.geom, interval
        )
        expect = jfif.assemble_restart(
            ref.geom,
            [np.frombuffer(s, np.uint8) for s in segments],
            bits, interval,
        )
        assert got.file_bytes == expect, (ratio, interval)
        assert got.entropy_payload == b"".join(segments)
        assert got.bit_length == sum(bits)


def test_assemble_restart_drops_dead_suffix_segments():
    """Zero-bit (fully dead) trailing intervals must not emit an empty
    segment + spurious RSTn: assemble_restart filters them itself, so any
    caller (not just the band-tiled assembler) gets a valid stream."""
    from jpeg_encoder_tpu.io import jfif

    rgb = _image(16, 16, seed=7)
    cfg = EncoderConfig(subsampling_ratio=(4, 4, 4), restart_interval=2)
    geom = cfg.geometry(16, 16)
    expect = pipeline.encode_array(rgb, cfg)

    # Re-assemble from the live segments PLUS two dead (0-bit) suffix
    # entries; the file must be identical to the clean assembly.
    out = pipeline.compiled_restart_encoder(
        geom, cfg.dct_algorithm,
        pipeline.restart_default_capacity_bytes(geom, 2), 2,
    )(rgb)
    b = np.asarray(out["bits"])
    p = np.asarray(out["payloads"])
    segs = [p[i] for i in range(b.size)]
    bits = [int(x) for x in b]
    clean = jfif.assemble_restart(geom, segs, bits, 2)
    assert clean == expect.file_bytes
    dead = np.zeros_like(segs[0])
    padded = jfif.assemble_restart(
        geom, segs + [dead, dead], bits + [0, 0], 2
    )
    assert padded == expect.file_bytes
