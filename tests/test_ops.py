"""Device ops vs the golden oracle: bit-level agreement of every stage."""

import numpy as np
import jax.numpy as jnp
import pytest

from jpeg_encoder_tpu import oracle, tables
from jpeg_encoder_tpu.config import EncoderConfig
from jpeg_encoder_tpu.ops import color, dct, sample


def test_color_conversion_matches_oracle_random(rng):
    rgb = rng.integers(0, 256, size=(64, 64, 3), dtype=np.uint8)
    ye, cbe, cre = oracle.rgb_to_ycbcr_exact(rgb)
    yd, cbd, crd = color.rgb_to_ycbcr(jnp.asarray(rgb))
    assert np.array_equal(np.asarray(yd), ye)
    assert np.array_equal(np.asarray(cbd), cbe)
    assert np.array_equal(np.asarray(crd), cre)


@pytest.mark.slow
def test_color_exhaustive_cpu():
    """Every 2^24 RGB triple vs the oracle on the CPU backend.

    Historical loophole: the multiply-chain formulation let XLA:CPU form
    FMAs (immune to optimization_barrier), flipping ~2e-4 of triples at
    rounding ties — the suite passed only because fixed seeds avoided
    them. The LUT formulation (ops/color.py) is contraction-proof; this
    pins that, tie triples included, with no sampling.
    """
    r, g, b = np.meshgrid(
        np.arange(256, dtype=np.uint8),
        np.arange(256, dtype=np.uint8),
        np.arange(256, dtype=np.uint8),
        indexing="ij",
    )
    allrgb = np.stack([r.ravel(), g.ravel(), b.ravel()], -1).reshape(
        4096, 4096, 3
    )
    got = color.rgb_to_ycbcr(jnp.asarray(allrgb))
    want = oracle.rgb_to_ycbcr_exact(allrgb)
    for a, e in zip(got, want):
        assert np.array_equal(np.asarray(a), e)


def test_color_known_tie_triples():
    """The documented FMA-tie triples convert exactly on this backend."""
    # (1, 233, 245) hits the y-chain tie 164.99999237 (ops/color.py); the
    # neighbors cover the adjacent tie band.
    ties = np.array(
        [[1, 233, 245], [1, 233, 244], [2, 233, 245], [255, 1, 3]],
        dtype=np.uint8,
    ).reshape(1, -1, 3)
    ye, cbe, cre = oracle.rgb_to_ycbcr_exact(ties)
    yd, cbd, crd = color.rgb_to_ycbcr(jnp.asarray(ties))
    assert np.array_equal(np.asarray(yd), ye)
    assert np.array_equal(np.asarray(cbd), cbe)
    assert np.array_equal(np.asarray(crd), cre)


def test_color_conversion_matches_oracle_exhaustive_channel_extremes():
    """All (r, g) pairs at b in {0, 128, 255}: 196,608 triples, exact."""
    r, g = np.meshgrid(
        np.arange(256, dtype=np.uint8), np.arange(256, dtype=np.uint8)
    )
    for b in (0, 128, 255):
        rgb = np.stack([r, g, np.full_like(r, b)], axis=-1)
        ye, cbe, cre = oracle.rgb_to_ycbcr_exact(rgb)
        yd, cbd, crd = color.rgb_to_ycbcr(jnp.asarray(rgb))
        assert np.array_equal(np.asarray(yd), ye)
        assert np.array_equal(np.asarray(cbd), cbe)
        assert np.array_equal(np.asarray(crd), cre)


@pytest.mark.parametrize("ratio", [(4, 4, 4), (4, 2, 2), (4, 2, 0)])
@pytest.mark.parametrize("size", [(16, 16), (17, 16), (24, 40), (20, 12)])
def test_subsample_matches_oracle(ratio, size, rng):
    width, height = size
    geom = EncoderConfig(subsampling_ratio=ratio).geometry(width, height)
    plane = np.zeros((geom.padded_height, geom.padded_width), dtype=np.uint8)
    plane[:height, :width] = rng.integers(0, 256, size=(height, width), dtype=np.uint8)
    expected = oracle.subsample_plane(plane, geom)
    got = np.asarray(sample.subsample_plane(jnp.asarray(plane), geom))
    assert np.array_equal(got, expected)


def test_blockify_roundtrip(rng):
    plane = rng.integers(0, 256, size=(24, 32), dtype=np.uint8)
    blocks = sample.blockify(jnp.asarray(plane))
    assert blocks.shape == (12, 64)
    # First block is the top-left 8x8 tile, row-major.
    assert np.array_equal(np.asarray(blocks)[0], plane[:8, :8].reshape(64))
    back = sample.unblockify(blocks, 24, 32)
    assert np.array_equal(np.asarray(back), plane)
    # Matches the oracle's tiling.
    assert np.array_equal(
        np.asarray(blocks), oracle.blockify(plane).reshape(-1, 64)
    )


def test_bin_dct_matches_oracle_exactly(rng):
    blocks = rng.integers(0, 256, size=(257, 8, 8), dtype=np.uint8)
    expected = oracle.bin_dct_quant_exact(blocks, tables.Y_QUANT_TABLE)
    got = np.asarray(
        dct.bin_dct_quant(jnp.asarray(blocks.reshape(-1, 64)), tables.Y_QUANT_TABLE)
    )
    assert np.array_equal(got.reshape(-1, 8, 8), expected)


def test_real_dct_ordered_matches_oracle_exactly(rng):
    blocks = rng.integers(0, 256, size=(64, 8, 8), dtype=np.uint8)
    expected = oracle.real_dct_quant_exact(blocks, tables.Y_QUANT_TABLE)
    got = np.asarray(
        dct.real_dct_quant_ordered(
            jnp.asarray(blocks.reshape(-1, 64)), tables.Y_QUANT_TABLE
        )
    )
    assert np.array_equal(got.reshape(-1, 8, 8), expected)


def test_real_dct_fast_matches_oracle(rng):
    """The opt-in matmul path: same math, different f32 summation order.

    Truncation-boundary flips are expected at a ~1e-4 rate (measured 3e-5
    over 6.7e7 coefficients of mixed content on an H100); anything beyond
    one quantization step or a rate above 5e-4 indicates a real
    regression.
    """
    blocks = rng.integers(0, 256, size=(1024, 8, 8), dtype=np.uint8)
    expected = oracle.real_dct_quant_exact(blocks, tables.Y_QUANT_TABLE)
    got = np.asarray(
        dct.real_dct_quant(jnp.asarray(blocks.reshape(-1, 64)), tables.Y_QUANT_TABLE)
    ).reshape(-1, 8, 8)
    diff = np.abs(got.astype(np.int32) - expected.astype(np.int32))
    assert diff.max() <= 1
    mismatch_rate = float((diff != 0).mean())
    assert mismatch_rate <= 5e-4, f"mismatch rate {mismatch_rate} vs oracle"


def test_real_dct_fast_wikipedia_block():
    wiki = np.array(
        [52, 55, 61, 66, 70, 61, 64, 73, 63, 59, 55, 90, 109, 85, 69, 72,
         62, 59, 68, 113, 144, 104, 66, 73, 63, 58, 71, 122, 154, 106, 70, 69,
         67, 61, 68, 104, 126, 88, 68, 70, 79, 65, 60, 70, 77, 68, 58, 75,
         85, 71, 64, 59, 55, 61, 65, 83, 87, 79, 69, 68, 65, 76, 78, 94],
        dtype=np.uint8,
    )
    got = np.asarray(
        dct.real_dct_quant(jnp.asarray(wiki[None]), tables.Y_QUANT_TABLE)
    ).reshape(8, 8)
    expected = oracle.real_dct_quant_exact(
        wiki.reshape(1, 8, 8), tables.Y_QUANT_TABLE
    )[0]
    assert np.array_equal(got, expected)


@pytest.mark.parametrize("quality", [None, 35, 90])
@pytest.mark.parametrize("variant", ["real-dct", "bin-dct", "bin-dct-descale"])
def test_dct_quantize_planes_matches_oracle(variant, quality):
    """The production three-plane DCT entry point, bit for bit, on 4096
    blocks of mixed content: half quantized as luma, half as chroma."""
    import chip_smoke
    from jpeg_encoder_tpu.config import DctAlgorithm

    blocks = chip_smoke.mixed_blocks(4096, seed=len(variant))
    ny = nc = 1024
    y, cb, cr = blocks[:2 * ny], blocks[2 * ny:2 * ny + nc], blocks[-nc:]
    q_luma, q_chroma = tables.scaled_quant_tables(quality)
    if variant == "real-dct":
        ref = oracle.real_dct_exact(blocks)
        want = [oracle.quantize_real_exact(ref[:2 * ny], q_luma),
                oracle.quantize_real_exact(ref[2 * ny:], q_chroma)]
    else:
        work = oracle.bin_dct_transform_exact(blocks)
        if variant == "bin-dct":
            want = [oracle.quantize_bin_exact(work[:2 * ny], q_luma),
                    oracle.quantize_bin_exact(work[2 * ny:], q_chroma)]
        else:
            f = dct.bindct_descale_2d()
            want = [
                oracle.bin_dct_descale_quant_exact(work[:2 * ny], q_luma, f),
                oracle.bin_dct_descale_quant_exact(work[2 * ny:], q_chroma, f),
            ]
    algorithm = (DctAlgorithm.REAL_DCT if variant == "real-dct"
                 else DctAlgorithm.BIN_DCT)
    got = dct.dct_quantize_planes(
        *(jnp.asarray(p.reshape(-1, 64)) for p in (y, cb, cr)),
        algorithm, bin_dct_descale=variant == "bin-dct-descale",
        quality=quality,
    )
    got = np.concatenate([np.asarray(g) for g in got]).reshape(-1, 8, 8)
    assert np.array_equal(got, np.concatenate(want))


def test_quant_divide_rounds_like_ieee_division():
    """The exact quantizer division against NumPy's IEEE f32 division on
    values sitting a few ulps either side of multiples of the steps."""
    rng = np.random.default_rng(21)
    n = 100_000
    q = rng.integers(1, 256, n).astype(np.float32)
    k = rng.integers(-15, 16, n).astype(np.float32)
    x = (k * q).astype(np.float32)
    x = (x.view(np.int32) + np.where(k != 0, rng.integers(-3, 4, n), 0)
         .astype(np.int32)).view(np.float32)
    want = np.trunc(x / q)
    got = np.asarray(dct._quant_divide(jnp.asarray(x), jnp.asarray(q)))
    assert np.array_equal(got, want)
