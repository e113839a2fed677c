"""Device entropy coding vs the oracle: bit-exact payloads."""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from jpeg_encoder_tpu import oracle
from jpeg_encoder_tpu.config import EncoderConfig
from jpeg_encoder_tpu.ops import entropy


@functools.lru_cache(maxsize=64)
def _jitted_encode_scan(geom, capacity):
    return jax.jit(
        lambda y, cb, cr: entropy.encode_scan(y, cb, cr, geom, capacity)
    )


def _device_payload(y, cb, cr, geom):
    capacity = ((geom.num_scan_entries * 220) + 3) // 4 * 4
    payload, bits = _jitted_encode_scan(geom, capacity)(
        jnp.asarray(y.reshape(-1, 64)),
        jnp.asarray(cb.reshape(-1, 64)),
        jnp.asarray(cr.reshape(-1, 64)),
    )
    bits = int(bits)
    return np.asarray(payload)[: (bits + 7) // 8].tobytes(), bits


def _oracle_payload(y, cb, cr, geom):
    return oracle.entropy_encode(
        y.reshape(-1, 8, 8), cb.reshape(-1, 8, 8), cr.reshape(-1, 8, 8), geom
    )


def _check(y, cb, cr, geom):
    got, got_bits = _device_payload(y, cb, cr, geom)
    want, want_bits = _oracle_payload(y, cb, cr, geom)
    assert got_bits == want_bits
    assert got == want


def test_all_zero_blocks():
    geom = EncoderConfig(subsampling_ratio=(4, 4, 4)).geometry(16, 16)
    z = np.zeros((4, 64), np.int16)
    _check(z, z, z, geom)


def test_single_block_known_values():
    geom = EncoderConfig(subsampling_ratio=(4, 4, 4)).geometry(8, 8)
    y = np.zeros((1, 64), np.int16)
    y[0, :8] = [-26, -3, 1, -2, 0, 0, 5, 0]  # natural-order row 0
    c = np.zeros((1, 64), np.int16)
    _check(y, c, c, geom)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("ratio", [(4, 4, 4), (4, 2, 2), (4, 2, 0)])
def test_random_small_coefficients(ratio, seed):
    """Dense small coefficients: exercises DC chains and short runs."""
    rng = np.random.default_rng(seed)
    geom = EncoderConfig(subsampling_ratio=ratio).geometry(32, 48)
    y = rng.integers(-4, 5, size=(geom.num_luma_blocks, 64)).astype(np.int16)
    cb = rng.integers(-4, 5, size=(geom.num_chroma_blocks, 64)).astype(np.int16)
    cr = rng.integers(-4, 5, size=(geom.num_chroma_blocks, 64)).astype(np.int16)
    _check(y, cb, cr, geom)


@pytest.mark.parametrize("ratio", [(4, 4, 4), (4, 2, 2), (4, 2, 0)])
def test_sparse_coefficients_long_runs(ratio):
    """Sparse coefficients: exercises ZRL insertion (runs >= 16, 32, 48)."""
    rng = np.random.default_rng(7)
    geom = EncoderConfig(subsampling_ratio=ratio).geometry(40, 24)
    def sparse(n):
        coeffs = np.zeros((n, 64), np.int16)
        mask = rng.random((n, 64)) < 0.04
        coeffs[mask] = rng.integers(-100, 101, size=int(mask.sum()))
        return coeffs
    _check(sparse(geom.num_luma_blocks),
           sparse(geom.num_chroma_blocks),
           sparse(geom.num_chroma_blocks), geom)


def test_exactly_16_zero_run_then_nonzero():
    """Z == 16 must emit one ZRL then a zero-run-0 symbol."""
    geom = EncoderConfig(subsampling_ratio=(4, 4, 4)).geometry(8, 8)
    from jpeg_encoder_tpu import tables
    y = np.zeros((1, 64), np.int16)
    zz_coeffs = np.zeros(64, np.int16)
    zz_coeffs[17] = 3  # zigzag position 17: preceded by 16 zeros
    y[0, tables.ZIGZAG_ORDER] = zz_coeffs
    c = np.zeros((1, 64), np.int16)
    _check(y, c, c, geom)


def test_trailing_run_of_exactly_48_zeros_no_zrl():
    """Trailing zeros emit only EOB, never ZRL."""
    geom = EncoderConfig(subsampling_ratio=(4, 4, 4)).geometry(8, 8)
    from jpeg_encoder_tpu import tables
    y = np.zeros((1, 64), np.int16)
    zz_coeffs = np.zeros(64, np.int16)
    zz_coeffs[15] = -7
    y[0, tables.ZIGZAG_ORDER] = zz_coeffs
    c = np.zeros((1, 64), np.int16)
    _check(y, c, c, geom)


def test_last_zigzag_coefficient_nonzero_no_eob():
    geom = EncoderConfig(subsampling_ratio=(4, 4, 4)).geometry(8, 8)
    from jpeg_encoder_tpu import tables
    y = np.zeros((1, 64), np.int16)
    zz_coeffs = np.zeros(64, np.int16)
    zz_coeffs[63] = 1  # run of 62 zeros (3 ZRLs + run 14), then no EOB
    y[0, tables.ZIGZAG_ORDER] = zz_coeffs
    c = np.zeros((1, 64), np.int16)
    _check(y, c, c, geom)


def test_negative_dc_and_amplitudes():
    geom = EncoderConfig(subsampling_ratio=(4, 4, 4)).geometry(16, 8)
    y = np.zeros((2, 64), np.int16)
    y[0, 0] = -1024  # DC category 11 boundary
    y[1, 0] = 1023   # diff = 2047, category 11
    c = np.zeros((2, 64), np.int16)
    _check(y, c, c, geom)


def test_quirk_width_17_mcu_alignment():
    """width % 16 == 1 at 4:2:0: luma superblock grid > chroma grid."""
    rng = np.random.default_rng(3)
    geom = EncoderConfig(subsampling_ratio=(4, 2, 0)).geometry(17, 16)
    y = rng.integers(-6, 7, size=(geom.num_luma_blocks, 64)).astype(np.int16)
    cb = rng.integers(-6, 7, size=(geom.num_chroma_blocks, 64)).astype(np.int16)
    cr = rng.integers(-6, 7, size=(geom.num_chroma_blocks, 64)).astype(np.int16)
    _check(y, cb, cr, geom)


def test_pack_bits_word_boundary_spans():
    """Codes that straddle u32 word boundaries pack correctly."""
    # 5 slots of 27 bits: offsets 0, 27, 54, 81, 108 — spans everywhere.
    bits = jnp.asarray(
        np.array([0x7FFFFFF, 0x5555555, 0x2AAAAAA, 0x7FFFFFF, 0x1234567],
                 dtype=np.uint32)
    )
    lens = jnp.asarray(np.full(5, 27, dtype=np.int32))
    payload, total = entropy.pack_bits(bits, lens, 32)
    assert int(total) == 135
    got = np.asarray(payload)
    stream = "".join(
        format(v, "027b")
        for v in (0x7FFFFFF, 0x5555555, 0x2AAAAAA, 0x7FFFFFF, 0x1234567)
    )
    expected = np.frombuffer(
        int(stream.ljust(32 * 8, "0"), 2).to_bytes(32, "big"), dtype=np.uint8
    )
    assert np.array_equal(got, expected)


def _content(kind, n, rng):
    """(n, 64) natural-order coefficients shaped like one content class."""
    if kind == "noise":  # dense, large: long codes, many word spans
        return rng.integers(-300, 300, (n, 64)).astype(np.int16)
    c = np.zeros((n, 64), np.int16)
    if kind == "gradient":  # slowly drifting DC, a few low-frequency ACs
        c[:, 0] = np.cumsum(rng.integers(-3, 4, n)) + 40
        c[:, [1, 8, 9]] = rng.integers(-6, 7, (n, 3))
    else:  # flat: one DC value, no AC at all (shortest possible entries)
        c[:, 0] = 17
    return c


def _coeffs(geom, kind, rng):
    return (_content(kind, geom.num_luma_blocks, rng),
            _content(kind, geom.num_chroma_blocks, rng),
            _content(kind, geom.num_chroma_blocks, rng))


RATIOS = [(4, 4, 4), (4, 2, 2), (4, 2, 0)]


@pytest.mark.parametrize("kind", ["noise", "gradient", "flat"])
@pytest.mark.parametrize("ratio", RATIOS)
def test_xla_packer_matches_oracle(ratio, kind):
    rng = np.random.default_rng(sum(ratio))
    geom = EncoderConfig(subsampling_ratio=ratio).geometry(48, 32)
    _check(*_coeffs(geom, kind, rng), geom)


@pytest.mark.parametrize("ratio", RATIOS)
def test_xla_packer_init_dc_chaining(ratio):
    """Non-zero initial DC predictors (a band's predecessor's last DCs)."""
    rng = np.random.default_rng(5)
    geom = EncoderConfig(subsampling_ratio=ratio).geometry(32, 32)
    y, cb, cr = _coeffs(geom, "gradient", rng)
    init = (7, -3, 11)
    cap = 1 << 14
    payload, bits = jax.jit(
        lambda a, b, c: entropy.encode_scan(
            a, b, c, geom, cap, init_dc=jnp.asarray(init, jnp.int32)
        )
    )(jnp.asarray(y), jnp.asarray(cb), jnp.asarray(cr))
    want, want_bits = oracle.entropy_encode(y, cb, cr, geom, init_dc=init)
    assert int(bits) == want_bits
    assert np.asarray(payload)[: (want_bits + 7) // 8].tobytes() == want


@pytest.mark.parametrize("ratio", RATIOS)
def test_xla_packer_live_entries_masking(ratio):
    """Entries past live_entries (the trailing band's padding in uneven
    band tiling) emit nothing, whatever their coefficients hold."""
    rng = np.random.default_rng(9)
    geom = EncoderConfig(subsampling_ratio=ratio).geometry(48, 48)
    y, cb, cr = _coeffs(geom, "noise", rng)
    live_mcus = (geom.mcu_rows - 1) * geom.mcu_cols
    live = jnp.asarray(live_mcus * geom.blocks_per_mcu, jnp.int32)
    cap = 1 << 15
    fn = jax.jit(lambda a, b, c: entropy.encode_scan(
        a, b, c, geom, cap, live_entries=live))
    payload, bits = fn(jnp.asarray(y), jnp.asarray(cb), jnp.asarray(cr))
    want, want_bits = oracle.entropy_encode(
        y, cb, cr, geom, num_mcus=live_mcus
    )
    assert int(bits) == want_bits
    assert np.asarray(payload)[: (want_bits + 7) // 8].tobytes() == want

    # Different garbage in the dead suffix changes nothing.
    last_luma = geom.h_factor * geom.v_factor * geom.mcu_cols
    y[-last_luma:] = rng.integers(-999, 999, (last_luma, 64))
    cb[-geom.mcu_cols:] = rng.integers(-999, 999, (geom.mcu_cols, 64))
    cr[-geom.mcu_cols:] = rng.integers(-999, 999, (geom.mcu_cols, 64))
    p2, b2 = fn(jnp.asarray(y), jnp.asarray(cb), jnp.asarray(cr))
    assert int(b2) == int(bits)
    assert np.array_equal(np.asarray(p2), np.asarray(payload))


def test_xla_packer_under_vmap():
    """The batch path vmaps the encode: each batch member must equal its
    own single encode and the oracle."""
    rng = np.random.default_rng(13)
    geom = EncoderConfig(subsampling_ratio=(4, 2, 0)).geometry(32, 32)
    members = [_coeffs(geom, kind, rng) for kind in ("noise", "gradient")]
    stacked = [jnp.asarray(np.stack([m[i] for m in members]))
               for i in range(3)]
    cap = 1 << 14
    pv, bv = jax.jit(jax.vmap(
        lambda a, b, c: entropy.encode_scan(a, b, c, geom, cap)
    ))(*stacked)
    for i, (y, cb, cr) in enumerate(members):
        want, want_bits = oracle.entropy_encode(y, cb, cr, geom)
        assert int(bv[i]) == want_bits
        assert np.asarray(pv[i])[: (want_bits + 7) // 8].tobytes() == want


def test_xla_packer_custom_luts_match_pack_bits(monkeypatch):
    """Per-image tables with 1-bit codes (2-bit entries, so up to 16
    entries start inside one output word): the widened assembly must pack
    exactly what the scatter-add reference pack_bits packs, and the
    stream must be the oracle's under the same tables."""
    from jpeg_encoder_tpu import pipeline

    geom = EncoderConfig(subsampling_ratio=(4, 2, 0)).geometry(64, 48)
    y, cb, cr = _coeffs(geom, "flat", np.random.default_rng(0))
    y[::7, 1] = 3  # a few other symbols beside the dominant DC-0 / EOB
    hist = np.asarray(entropy.symbol_histograms(
        jnp.asarray(y), jnp.asarray(cb), jnp.asarray(cr), geom
    ))
    specs, dc_lut, ac_lut = pipeline.optimal_specs_and_luts(hist)
    assert int(specs[2].length_lut[0x00]) == 1  # 1-bit luma EOB

    seen = {}
    real_pack = entropy.pack_entries

    def recording_pack(slot_bits, slot_lens, capacity, candidates):
        seen.update(bits=slot_bits, lens=slot_lens, candidates=candidates)
        return real_pack(slot_bits, slot_lens, capacity, candidates)

    monkeypatch.setattr(entropy, "pack_entries", recording_pack)
    cap = 1 << 12
    payload, bits = entropy.encode_scan(
        jnp.asarray(y), jnp.asarray(cb), jnp.asarray(cr), geom, cap,
        luts=(dc_lut, ac_lut),
    )
    assert seen["candidates"] == entropy.ASSEMBLE_CANDIDATES_CUSTOM
    ref, ref_bits = entropy.pack_bits(
        seen["bits"].reshape(-1), seen["lens"].reshape(-1), cap
    )
    assert int(ref_bits) == int(bits)
    assert np.array_equal(np.asarray(ref), np.asarray(payload))
    want, want_bits = oracle.entropy_encode(y, cb, cr, geom, specs=specs)
    assert int(bits) == want_bits
    assert np.asarray(payload)[: (want_bits + 7) // 8].tobytes() == want
