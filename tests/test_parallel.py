"""Sharded encode paths on a virtual 8-device CPU mesh."""

import numpy as np
import pytest

import jax

from jpeg_encoder_tpu import oracle, pipeline
from jpeg_encoder_tpu.config import DctAlgorithm, EncoderConfig
from jpeg_encoder_tpu.io import jfif
from jpeg_encoder_tpu.parallel import batch, mesh as mesh_lib, tiled
from jpeg_encoder_tpu.utils.bits import splice_bitstreams


@pytest.fixture(scope="module")
def mesh8():
    devices = jax.devices()
    if len(devices) < 8:
        pytest.skip("needs 8 virtual devices")
    return mesh_lib.data_mesh(8)


def test_splice_bitstreams_basic():
    # "10110" + "01" + "111111111" = 10110011 11111111 (16 bits)
    a = np.frombuffer(int("10110000", 2).to_bytes(1, "big"), np.uint8)
    b = np.frombuffer(int("01000000", 2).to_bytes(1, "big"), np.uint8)
    c = np.frombuffer(int("1111111110000000", 2).to_bytes(2, "big"), np.uint8)
    out, bits = splice_bitstreams([(a, 5), (b, 2), (c, 9)])
    assert bits == 16
    assert out == bytes([0b10110011, 0b11111111])


def test_splice_bitstreams_random_vs_bitjoin(rng):
    chunks = []
    stream = ""
    for _ in range(17):
        nbits = int(rng.integers(0, 40))
        bits = "".join(rng.choice(["0", "1"], size=nbits))
        stream += bits
        nbytes = (nbits + 7) // 8
        arr = (
            np.frombuffer(
                int(bits.ljust(nbytes * 8, "0") or "0", 2).to_bytes(
                    max(nbytes, 1), "big"
                ),
                np.uint8,
            )
            if nbits
            else np.zeros(0, np.uint8)
        )
        chunks.append((arr[:nbytes], nbits))
    out, total = splice_bitstreams(chunks)
    assert total == len(stream)
    expected_bytes = (len(stream) + 7) // 8
    expected = (
        int(stream.ljust(expected_bytes * 8, "0"), 2).to_bytes(expected_bytes, "big")
        if stream
        else b""
    )
    assert out == expected


def test_batch_encode_matches_single(mesh8, rng):
    images = rng.integers(0, 256, size=(11, 24, 32, 3), dtype=np.uint8)
    config = EncoderConfig(subsampling_ratio=(4, 2, 0))
    files = batch.encode_batch(images, config, mesh8)
    assert len(files) == 11
    for i in (0, 5, 10):
        single = pipeline.encode_array(images[i], config)
        assert files[i] == single.file_bytes


@pytest.mark.slow
def test_batch_overflow_retries_only_overflowed_images(mesh8, rng, monkeypatch):
    """One noisy image in a smooth batch overflows a deliberately tiny
    capacity estimate: only that image may re-encode (through the
    single-image ladder), and every output must match the unconstrained
    per-image encode."""
    # 288x288 noise packs ~180 kbit at 4:2:0 — past the 16384-byte
    # (131072-bit) default_capacity_bytes floor — while the smooth
    # gradient stays ~12 kbit, so exactly one batch member overflows.
    side = 288
    x = np.linspace(0, 255, side)[None, :, None]
    smooth = np.broadcast_to(x, (side, side, 3)).astype(np.uint8)
    images = np.stack([smooth] * 7 + [
        rng.integers(0, 256, size=(side, side, 3), dtype=np.uint8)
    ])
    config = EncoderConfig(
        subsampling_ratio=(4, 2, 0), capacity_bytes_per_pixel=0.07
    )
    geom = config.geometry(side, side)
    capacity = pipeline.default_capacity_bytes(
        geom, config.capacity_bytes_per_pixel
    )
    noisy_bits = pipeline.encode_array(images[7], config).bit_length
    smooth_bits = pipeline.encode_array(images[0], config).bit_length
    assert smooth_bits <= 8 * capacity < noisy_bits, (
        f"test premise broken: smooth {smooth_bits} / cap {8 * capacity} / "
        f"noisy {noisy_bits} bits"
    )

    calls = []
    real_encode_array = pipeline.encode_array

    def counting_encode_array(rgb, cfg, **kwargs):
        calls.append(kwargs.get("_initial_capacity_bytes"))
        return real_encode_array(rgb, cfg, **kwargs)

    monkeypatch.setattr(pipeline, "encode_array", counting_encode_array)
    files = batch.encode_batch(images, config, mesh8)
    monkeypatch.undo()

    assert len(calls) == 1, f"expected 1 single-image retry, saw {len(calls)}"
    assert calls[0] == pipeline.next_capacity_bytes(geom, capacity)
    for i in range(8):
        assert files[i] == pipeline.encode_array(images[i], config).file_bytes


@pytest.mark.parametrize(
    "ratio",
    [
        pytest.param((4, 4, 4), marks=pytest.mark.slow),
        pytest.param((4, 2, 2), marks=pytest.mark.slow),
        (4, 2, 0),  # production default stays in the fast tier
    ],
)
def test_tiled_encode_matches_single(mesh8, ratio, rng):
    config = EncoderConfig(subsampling_ratio=ratio)
    # 8 mesh devices need mcu_rows % 8 == 0: height 128 gives 16/8 MCU rows.
    height = 128
    rgb = rng.integers(0, 256, size=(height, 48, 3), dtype=np.uint8)
    result = tiled.encode_tiled(rgb, config, mesh8)
    single = pipeline.encode_array(rgb, config)
    assert result.bit_length == single.bit_length
    assert result.file_bytes == single.file_bytes


@pytest.mark.slow
def test_tiled_encode_unpadded_height(mesh8, rng):
    """Original height not a multiple of the band split (121 -> pad 128)."""
    config = EncoderConfig(subsampling_ratio=(4, 2, 0))
    rgb = rng.integers(0, 256, size=(121, 32, 3), dtype=np.uint8)
    result = tiled.encode_tiled(rgb, config, mesh8)
    single = pipeline.encode_array(rgb, config)
    assert result.file_bytes == single.file_bytes
    # And the golden model agrees end to end.
    golden = oracle.encode_oracle(rgb, config)
    assert result.file_bytes == jfif.assemble(golden.geom, golden.entropy_bytes)


def test_tiled_quirk_width_falls_back_to_single_device(mesh8, rng):
    """width % (8h) == 1 hits the reference's global chroma-grid
    misalignment, which band-local encoding cannot reproduce; encode_tiled
    must fall back to the single-device path (with a warning) instead of
    refusing an input the reference accepts (main.rs:8-68)."""
    config = EncoderConfig(subsampling_ratio=(4, 2, 0))
    rgb = rng.integers(0, 256, size=(128, 17, 3), dtype=np.uint8)
    with pytest.warns(RuntimeWarning, match="quirk"):
        result = tiled.encode_tiled(rgb, config, mesh8)
    single = pipeline.encode_array(rgb, config)
    assert result.file_bytes == single.file_bytes


@pytest.mark.parametrize(
    "height,ratio",
    [
        (48, (4, 2, 0)),   # 3 MCU rows over 8 devices: 5 fully dead bands
        # 34 MCU rows (4K-height analog): ceil -> 5-row bands, band 6
        # partial (4 live rows), band 7 dead. Slow tier: the 48/72 cases
        # cover the dead- and partial-band edges at smaller cost.
        pytest.param(544, (4, 2, 0), marks=pytest.mark.slow),
        (72, (4, 4, 4)),   # 9 MCU rows: 2-row bands, band 4 partial
    ],
)
def test_tiled_encode_uneven_bands(mesh8, height, ratio, rng):
    """MCU row counts that do NOT divide the mesh size still encode
    byte-identically: trailing bands carry padding rows whose scan entries
    are masked to emit zero bits."""
    config = EncoderConfig(subsampling_ratio=ratio)
    rgb = rng.integers(0, 256, size=(height, 32, 3), dtype=np.uint8)
    result = tiled.encode_tiled(rgb, config, mesh8)
    single = pipeline.encode_array(rgb, config)
    assert result.bit_length == single.bit_length
    assert result.file_bytes == single.file_bytes


@pytest.mark.slow
def test_tiled_overflow_retries_only_overflowed_bands(mesh8, rng, monkeypatch):
    """One noisy MCU band in a smooth image overflows a deliberately tiny
    capacity estimate: only that band re-encodes (alone, off-mesh), and the
    spliced file still matches the single-device encode."""
    # 256 rows = 16 MCU rows at 4:2:0 -> 8 bands of 32 rows; rows 96-128
    # (band 3) are noise, the rest a horizontal gradient. The width makes
    # the noise band's payload (~2.2 bits/px * 81920 px ~ 180 kbit) clear
    # the 16384-byte default_capacity_bytes floor, while each gradient
    # band stays far under it.
    height, width = 256, 2560
    x = np.linspace(0, 255, width)[None, :, None]
    rgb = np.broadcast_to(x, (height, width, 3)).astype(np.uint8).copy()
    rgb[96:128] = rng.integers(0, 256, size=(32, width, 3), dtype=np.uint8)

    config = EncoderConfig(
        subsampling_ratio=(4, 2, 0), capacity_bytes_per_pixel=0.04
    )
    band_geom = config.geometry(width, 32)
    band_capacity = pipeline.default_capacity_bytes(
        band_geom, config.capacity_bytes_per_pixel
    )
    noisy_bits = pipeline.encode_array(rgb[96:128], config).bit_length
    assert noisy_bits > 8 * band_capacity, (
        f"test premise broken: noise band {noisy_bits} bits vs capacity "
        f"{8 * band_capacity}"
    )
    retries = []
    real_band_encoder = tiled.compiled_band_encoder

    def counting_band_encoder(band_geom, *a, **k):
        retries.append(band_geom)
        return real_band_encoder(band_geom, *a, **k)

    monkeypatch.setattr(tiled, "compiled_band_encoder", counting_band_encoder)
    result = tiled.encode_tiled(rgb, config, mesh8)
    monkeypatch.undo()

    single = pipeline.encode_array(rgb, config)
    assert result.file_bytes == single.file_bytes
    assert len(retries) >= 1, "expected at least one band retry"
    # Only the noisy band (rows 96-128 = band 3 of 8) should have retried:
    # every retry geometry is one 32-row band, never the whole image.
    assert all(g.height == 32 for g in retries)


def test_encode_dataset_manifest_and_resume(tmp_path, rng):
    """Multi-host dataset sharding, degenerate single-process case: outputs,
    manifest bookkeeping, and resume-skip must all work."""
    from jpeg_encoder_tpu.config import EncoderConfig
    from jpeg_encoder_tpu.io import bmp
    from jpeg_encoder_tpu.parallel import multihost

    src = tmp_path / "src"
    out = tmp_path / "out"
    src.mkdir()
    paths = []
    for i in range(5):
        rgb = rng.integers(0, 256, size=(16, 24, 3), dtype=np.uint8)
        p = src / f"img{i}.bmp"
        bmp.write(p, rgb)
        paths.append(p)
    # One differently-sized image exercises the dimension grouping.
    odd = src / "odd.bmp"
    bmp.write(odd, rng.integers(0, 256, size=(8, 8, 3), dtype=np.uint8))
    paths.append(odd)

    config = EncoderConfig(subsampling_ratio=(4, 2, 0))
    res = multihost.encode_dataset(paths, str(out), config)
    assert res.encoded == 6 and res.skipped == 0
    for p in paths:
        assert (out / (p.stem + ".jpeg")).exists()
    summary = multihost.global_summary(res)
    assert summary["encoded"] == 6 and summary["processes"] == 1

    # Resume: everything already recorded -> all skipped.
    res2 = multihost.encode_dataset(paths, str(out), config)
    assert res2.encoded == 0 and res2.skipped == 6

    # Deleting one output forces just that file to re-encode.
    (out / "img3.jpeg").unlink()
    res3 = multihost.encode_dataset(paths, str(out), config)
    assert res3.encoded == 1 and res3.skipped == 5

    # Outputs are the standard pipeline bytes.
    from jpeg_encoder_tpu import pipeline

    want = pipeline.encode_array(bmp.read(paths[0]), config).file_bytes
    assert (out / "img0.jpeg").read_bytes() == want


def test_chunk_size_images_bounds():
    """The per-dispatch cap honors the per-device input budget (>= 1
    image/device, mesh-multiple, bounded bytes for big geometries)."""
    cfg = EncoderConfig()
    g4k = cfg.geometry(3840, 2160)
    n = batch.chunk_size_images(g4k, 8)
    assert n % 8 == 0
    per_dev = n // 8
    assert 1 <= per_dev <= batch.MAX_IMAGES_PER_DEVICE
    if per_dev > 1:
        assert per_dev * 3840 * 2160 * 3 <= batch.chunk_input_budget()
    # Tiny geometry: the image-count cap applies, not the byte budget.
    tiny = cfg.geometry(16, 16)
    assert batch.chunk_size_images(tiny, 8) == 8 * batch.MAX_IMAGES_PER_DEVICE


def test_batch_encode_chunked_dispatch_matches_single(mesh8, rng, monkeypatch):
    """With the chunk cap forced tiny, a 10-image batch runs as several
    bounded dispatches and still reproduces the per-image encodes."""
    monkeypatch.setattr(batch, "chunk_input_budget", lambda: 24 * 32 * 3)  # 1/dev
    dispatches = []
    real_dispatch = batch.dispatch_chunk

    def counting_dispatch(images, *a, **k):
        dispatches.append(images.shape[0])
        return real_dispatch(images, *a, **k)

    monkeypatch.setattr(batch, "dispatch_chunk", counting_dispatch)
    images = rng.integers(0, 256, size=(10, 24, 32, 3), dtype=np.uint8)
    config = EncoderConfig(subsampling_ratio=(4, 2, 0))
    files = batch.encode_batch(images, config, mesh8)
    assert len(files) == 10
    assert len(dispatches) == 2          # chunk = 8 -> 8 + 2(padded to 8)
    assert all(d <= 8 for d in dispatches)
    for i in range(10):
        single = pipeline.encode_array(images[i], config)
        assert files[i] == single.file_bytes


def test_shard_to_devices_places_slices(mesh8, rng):
    """Every device must hold exactly its own batch slice (the H2D path
    must never stage the whole batch through one device)."""
    images = rng.integers(0, 256, size=(8, 16, 16, 3), dtype=np.uint8)
    arr = batch.shard_to_devices(images, mesh8)
    assert arr.shape == images.shape
    for shard in arr.addressable_shards:
        assert shard.data.shape[0] == 1  # one image per device
        i = shard.index[0].start or 0
        assert np.array_equal(np.asarray(shard.data)[0], images[i])


def test_stream_encode_paths_matches_single(tmp_path, rng, monkeypatch):
    """The overlapped decode|compute|write engine must emit byte-identical
    files, across mixed dimension groups and multiple chunks."""
    from jpeg_encoder_tpu.io import bmp
    from jpeg_encoder_tpu.parallel import stream

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    mesh = mesh_lib.data_mesh(8)
    monkeypatch.setattr(batch, "chunk_input_budget", lambda: 24 * 32 * 3)
    paths = []
    expected = {}
    config = EncoderConfig(subsampling_ratio=(4, 2, 0))
    for i in range(9):
        shape = (24, 32, 3) if i % 3 else (16, 24, 3)
        rgb = rng.integers(0, 256, size=shape, dtype=np.uint8)
        p = str(tmp_path / f"img{i:02d}.bmp")
        bmp.write(p, rgb)
        paths.append(p)
        expected[p] = pipeline.encode_array(rgb, config).file_bytes

    got = {}
    stats = stream.encode_paths(paths, config, mesh, got.__setitem__)
    assert stats.encoded == 9
    assert got == expected
    assert stats.pixels == sum(
        24 * 32 if i % 3 else 16 * 24 for i in range(9)
    )
    assert stats.output_bytes == sum(len(v) for v in expected.values())


def test_stream_encode_paths_propagates_writer_errors(tmp_path, rng):
    """An emit() failure must surface as the caller's exception (no hang,
    no silent success)."""
    from jpeg_encoder_tpu.io import bmp
    from jpeg_encoder_tpu.parallel import stream

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    mesh = mesh_lib.data_mesh(8)
    config = EncoderConfig(subsampling_ratio=(4, 2, 0))
    paths = []
    for i in range(3):
        rgb = rng.integers(0, 256, size=(16, 16, 3), dtype=np.uint8)
        p = str(tmp_path / f"e{i}.bmp")
        bmp.write(p, rgb)
        paths.append(p)

    def bad_emit(path, data):
        raise OSError("disk full (simulated)")

    with pytest.raises(OSError, match="disk full"):
        stream.encode_paths(paths, config, mesh, bad_emit)


def test_stream_encode_paths_restart_and_optimize(tmp_path, rng, monkeypatch):
    """The stream engine's restart (overlapped) and optimize (batched
    two-pass) modes must both emit the single-image path's files."""
    from jpeg_encoder_tpu.io import bmp
    from jpeg_encoder_tpu.parallel import stream

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    mesh = mesh_lib.data_mesh(2)
    monkeypatch.setattr(batch, "chunk_input_budget", lambda: 32 * 48 * 3)
    paths = []
    rgbs = {}
    for i in range(4):
        rgb = rng.integers(0, 256, size=(32, 48, 3), dtype=np.uint8)
        p = str(tmp_path / f"m{i}.bmp")
        bmp.write(p, rgb)
        paths.append(p)
        rgbs[p] = rgb

    for config in (
        EncoderConfig(subsampling_ratio=(4, 2, 0), restart_interval=2),
        EncoderConfig(subsampling_ratio=(4, 2, 0), optimize_huffman=True),
    ):
        got = {}
        stats = stream.encode_paths(paths, config, mesh, got.__setitem__)
        assert stats.encoded == 4
        for p in paths:
            want = pipeline.encode_array(rgbs[p], config).file_bytes
            assert got[p] == want, (p, config)
