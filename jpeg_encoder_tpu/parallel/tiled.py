"""Sharded single-image encode: MCU bands across the mesh + collectives.

The answer to "the image is too big for one device" (the analog of
sequence parallelism): split the image into contiguous MCU-row bands, one
per device. Every stage is band-local except two genuinely global pieces of
state, both tiny:

* the running DC predictors — each band's first DC difference depends on
  the previous band's final DC value. Since raw DCs are known after the
  DCT, one `lax.ppermute` (three int32 per device) shifts each
  band's final (Y, Cb, Cr) DCs to its successor; band 0 receives the
  implicit zero predictors. No serial chain, one hop.
* the bitstream itself — each band packs its own byte-aligned stream and
  reports its exact bit length; the host splices them at bit level
  (utils/bits.py), which costs O(payload bytes).

The result is byte-identical to the single-device encode (asserted in
tests on a virtual 8-device mesh).

Uneven splits are supported: when the MCU row count does not divide by the
mesh size, every device still gets ceil(mcu_rows / n_dev) MCU rows of
(zero-padded) input, and trailing scan entries beyond the image's real MCU
rows are masked to emit zero bits (ops/entropy.encode_scan live_entries).
Dead entries are always a suffix of the scan — only the last partially- or
fully-dead bands carry them — so the live bit prefix is untouched, and a
dead band's (meaningless) final-DC handoff is only ever consumed by a band
that emits nothing.

The degenerate width/height % (8*factor) == 1 geometries (where the
reference's chroma grid misaligns with the luma superblock grid; see
oracle.subsample_plane) are rejected — band-local encoding cannot reproduce
that global misalignment, and no real image hits it deliberately.
"""

from __future__ import annotations

import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from jpeg_encoder_tpu import pipeline
from jpeg_encoder_tpu.config import DctAlgorithm, EncoderConfig, FrameGeometry
from jpeg_encoder_tpu.io import jfif
from jpeg_encoder_tpu.ops import color, entropy, sample
from jpeg_encoder_tpu.parallel.mesh import DATA_AXIS
from jpeg_encoder_tpu.utils.bits import splice_bitstreams


def tileable(geom: FrameGeometry) -> bool:
    """Band-local encoding requires aligned luma/chroma grids.

    dim % (8*factor) == 1 images hit the reference's global chroma/luma
    grid misalignment (sampling.rs:63-101, pixel_matrix.rs:35-44; see
    oracle.subsample_plane) which band-local encoding cannot reproduce —
    encode_tiled falls back to the single-device path for them.
    """
    return geom.mcu_grid_aligned


def _band_rows(geom: FrameGeometry, n_dev: int) -> int:
    """MCU rows per band: ceil so n_dev equal bands cover the image."""
    return -(-geom.mcu_rows // n_dev)


def _aligned_band_rows(
    geom: FrameGeometry, n_dev: int, restart: int
) -> int | None:
    """Smallest restart-aligned band size that still splits the image.

    Restart framing needs every NON-final band to hold a whole number of
    intervals (an interval must not straddle a device boundary); the final
    band may end mid-interval — it ends the image. The band size is ours
    to choose, so instead of falling back to one device on misalignment,
    search upward from the even split for the smallest band_rows whose
    full band is interval-aligned. The search is bounded at 2x the even
    split: past that, most devices idle on dead bands and the padded
    input balloons (n_dev * band height), so the single-device fallback
    is the cheaper program — e.g. an interval coprime to the MCU-grid
    width would otherwise force band_rows = interval, nearly the whole
    image per band. Returns None when no aligned split within the bound
    exists (or only the degenerate single-live-band one does).
    """
    base = _band_rows(geom, n_dev)
    for rows in range(base, min(2 * base + 1, geom.mcu_rows)):
        if (rows * geom.mcu_cols) % restart == 0:
            return rows
    return None


def _live_mcu_rows(geom: FrameGeometry, band_rows: int, idx: int) -> int:
    return max(0, min(geom.mcu_rows - idx * band_rows, band_rows))


def _band_coeffs(rgb_band, band_geom, algorithm, fast_dct, bin_dct_descale,
                 live_px_rows=None, quality=None):
    """One band's front half: RGB rows -> zigzag quantized coefficients.

    Shared by the encode pass and the optimized-Huffman statistics pass
    so both see identical arithmetic. live_px_rows (traced scalar) zeroes
    plane rows at or beyond the original image height AFTER color
    conversion — the reference's padding lives in the Y/Cb/Cr planes
    (value 0), not in RGB space, where zero pixels would convert to
    Cb = Cr = 128.
    """
    y, cb, cr = color.rgb_to_ycbcr(rgb_band)
    if live_px_rows is not None:
        live = (jnp.arange(rgb_band.shape[0]) < live_px_rows)[:, None]
        y = jnp.where(live, y, 0)
        cb = jnp.where(live, cb, 0)
        cr = jnp.where(live, cr, 0)
    y = sample.pad_plane(y, band_geom)
    cb = sample.subsample_plane(sample.pad_plane(cb, band_geom), band_geom)
    cr = sample.subsample_plane(sample.pad_plane(cr, band_geom), band_geom)
    return pipeline.dct_planes_zigzag(
        y, cb, cr, algorithm, fast_dct, bin_dct_descale, quality
    )


def _encode_band(rgb_band, band_geom, algorithm, capacity, fast_dct,
                 bin_dct_descale, init_dc, live_entries=None,
                 live_px_rows=None, quality=None, restart=None, luts=None):
    """One band's full compute: planes -> coefficients -> packed bits.

    Shared between the shard_map program and the single-band overflow
    retry so both are the same arithmetic (byte-identical outputs). The
    DCT runs through pipeline.dct_planes_zigzag, the same production path
    as the batch encode.

    init_dc is either the (3,) initial DC predictors, or a callable that
    maps this band's final (Y, Cb, Cr) DC values to its predictors — the
    shard_map program passes the ppermute chain here, since the exchange
    can only happen once the band's own DCT output exists.

    live_px_rows (traced scalar) zeroes plane rows at or beyond the
    original image height AFTER color conversion — the reference's padding
    lives in the Y/Cb/Cr planes (value 0), not in RGB space, where zero
    pixels would convert to Cb = Cr = 128.

    restart (static int) switches the scan stage to per-interval restart
    framing (ops/entropy.encode_scan_restart): DC predictors reset at
    every interval, so init_dc is ignored — no cross-band exchange exists
    — and the returns become ((n_int, capacity) payloads, (n_int,) bits,
    zero predictors). `capacity` is then PER INTERVAL.

    `luts` = (dc, ac) traced (2, 256) packed tables routes every band
    through the per-image optimized codes (the cross-band table-agreement
    mode; all bands share ONE table set built from the psum'd statistics).

    Returns (payload, bits, init_dc_resolved).
    """
    y_q, cb_q, cr_q = _band_coeffs(
        rgb_band, band_geom, algorithm, fast_dct, bin_dct_descale,
        live_px_rows, quality,
    )
    if restart is not None:
        payloads, bits = entropy.encode_scan_restart(
            y_q, cb_q, cr_q, band_geom, capacity, restart,
            coeffs_zigzagged=True, live_entries=live_entries, luts=luts,
        )
        return payloads, bits, jnp.zeros((3,), jnp.int32)
    if callable(init_dc):
        # DC sits at column 0 in zigzag order too, so final_dc reads the
        # same values it would from natural-order coefficients.
        init_dc = init_dc(entropy.final_dc(y_q, cb_q, cr_q, band_geom))
    payload, bits = entropy.encode_scan(
        y_q, cb_q, cr_q, band_geom, capacity, init_dc=init_dc,
        live_entries=live_entries, coeffs_zigzagged=True, luts=luts,
    )
    return payload, bits, init_dc


@functools.lru_cache(maxsize=32)
def compiled_tiled_encoder(
    mesh: Mesh,
    geom: FrameGeometry,
    algorithm: DctAlgorithm,
    capacity: int,
    fast_dct: bool = False,
    bin_dct_descale: bool = False,
    quality: int | None = None,
    replicate_out: bool = False,
    restart: int | None = None,
    band_rows: int | None = None,
    custom_luts: bool = False,
):
    """Jitted (n_dev * band_h, W, 3) -> ((n_dev, cap) payloads,
    (n_dev,) bit lengths, (n_dev, 3) per-band initial DC predictors).

    replicate_out=True makes XLA all-gather the outputs onto every device
    so each PROCESS of a multi-host
    mesh holds the full payload set for host-side splicing — the
    device-side "collective bitstream assembly" of BASELINE config 5.

    restart (static int, MCUs — caller guarantees it divides the band MCU
    count) switches every band to per-interval restart framing: the
    payload/bits outputs gain an interval axis ((n_dev, n_int, cap),
    (n_dev, n_int)), the DC ppermute disappears (predictors reset at each
    interval), and host assembly is marker concatenation instead of
    bit-level splicing.

    band_rows overrides the even ceil(mcu_rows / n_dev) split — the
    restart mode passes a larger interval-aligned band when the even one
    would put an interval across a device boundary (_aligned_band_rows);
    trailing devices then carry fully dead bands, which emit nothing.

    custom_luts=True makes the jitted fn take (rgb, dc_lut, ac_lut): the
    (2, 256) packed tables are replicated traced operands and every band
    codes with them (the optimized-Huffman tiled mode; tables come from
    the psum'd statistics pass, compiled_tiled_stats)."""
    n_dev = mesh.devices.size
    if band_rows is None:
        band_rows = _band_rows(geom, n_dev)
    band_h = band_rows * 8 * geom.v_factor
    band_geom = _band_geometry(geom, band_h)
    uneven = band_rows * n_dev != geom.mcu_rows
    entries_per_mcu_row = geom.mcu_cols * geom.blocks_per_mcu

    def shard_fn(rgb_band, *luts):  # (band_h, W, 3) uint8
        idx = jax.lax.axis_index(DATA_AXIS)
        # Rows at or beyond the original image height are zero in the
        # reference's planes (the host hands us arbitrary padding content).
        live_px_rows = jnp.clip(geom.height - idx * band_h, 0, band_h)

        if uneven:
            live_mcu = jnp.clip(
                geom.mcu_rows - idx * band_rows, 0, band_rows
            ).astype(jnp.int32)
            live_entries = live_mcu * entries_per_mcu_row
        else:
            live_entries = None

        # Chain DC predictors: my final DCs become my successor's initers.
        # (A trailing dead band receives a value derived from padding
        # blocks, but it emits zero bits, so it never surfaces.)
        def chain(lasts):
            return jax.lax.ppermute(
                lasts, DATA_AXIS, [(i, i + 1) for i in range(n_dev - 1)]
            )  # band 0 gets zeros: the scan's initial predictors

        payload, bits, prev = _encode_band(
            rgb_band, band_geom, algorithm, capacity, fast_dct,
            bin_dct_descale, chain, live_entries, live_px_rows,
            quality, restart, luts or None,
        )
        return payload[None], bits[None], prev[None]

    payload_spec = (
        P(DATA_AXIS, None, None) if restart is not None
        else P(DATA_AXIS, None)
    )
    bits_spec = (
        P(DATA_AXIS, None) if restart is not None else P(DATA_AXIS)
    )
    in_specs = P(DATA_AXIS, None, None)
    if custom_luts:
        in_specs = (in_specs, P(None, None), P(None, None))
    sharded = shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=in_specs,
        out_specs=(payload_spec, bits_spec, P(DATA_AXIS, None)),
        check_vma=False,
    )
    if replicate_out:
        rep = jax.sharding.NamedSharding(mesh, P())
        return jax.jit(sharded, out_shardings=(rep, rep, rep))
    return jax.jit(sharded)


@functools.lru_cache(maxsize=32)
def compiled_tiled_stats(
    mesh: Mesh,
    geom: FrameGeometry,
    algorithm: DctAlgorithm,
    fast_dct: bool = False,
    bin_dct_descale: bool = False,
    quality: int | None = None,
    restart: int | None = None,
    band_rows: int | None = None,
):
    """Jitted (n_dev * band_h, W, 3) -> (4, 256) whole-scan symbol counts.

    The statistics pass of the tiled optimized-Huffman mode: each band
    histograms its own scan slice — with DC predictor chains seeded from
    its ppermuted predecessors (or per-interval resets under restart
    framing) and uneven-band padding masked out — and one psum over the
    band axis (4x256 ints) yields the whole scan's counts,
    replicated so the host can build ONE table set for every band.
    """
    n_dev = mesh.devices.size
    if band_rows is None:
        band_rows = _band_rows(geom, n_dev)
    band_h = band_rows * 8 * geom.v_factor
    band_geom = _band_geometry(geom, band_h)
    uneven = band_rows * n_dev != geom.mcu_rows
    entries_per_mcu_row = geom.mcu_cols * geom.blocks_per_mcu

    def shard_fn(rgb_band):
        idx = jax.lax.axis_index(DATA_AXIS)
        live_px_rows = jnp.clip(geom.height - idx * band_h, 0, band_h)
        if uneven:
            live_mcu = jnp.clip(
                geom.mcu_rows - idx * band_rows, 0, band_rows
            ).astype(jnp.int32)
            live_entries = live_mcu * entries_per_mcu_row
        else:
            live_entries = None
        y_q, cb_q, cr_q = _band_coeffs(
            rgb_band, band_geom, algorithm, fast_dct, bin_dct_descale,
            live_px_rows, quality,
        )
        if restart is None:
            init_dc = jax.lax.ppermute(
                entropy.final_dc(y_q, cb_q, cr_q, band_geom),
                DATA_AXIS, [(i, i + 1) for i in range(n_dev - 1)],
            )
        else:
            init_dc = None  # interval framing resets the predictors
        hist = entropy.symbol_histograms(
            y_q, cb_q, cr_q, band_geom, coeffs_zigzagged=True,
            restart_mcus=restart, init_dc=init_dc,
            live_entries=live_entries,
        )
        return jax.lax.psum(hist, DATA_AXIS)

    sharded = shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=P(DATA_AXIS, None, None),
        out_specs=P(None, None),
        check_vma=False,
    )
    return jax.jit(sharded)


@functools.lru_cache(maxsize=32)
def compiled_band_encoder(
    band_geom: FrameGeometry,
    algorithm: DctAlgorithm,
    capacity: int,
    fast_dct: bool = False,
    bin_dct_descale: bool = False,
    quality: int | None = None,
    custom_luts: bool = False,
):
    """Jitted single-band re-encode for overflow retry: (band_h, W, 3) uint8
    + (3,) int32 init_dc -> ((capacity,) payload, bits). Runs the exact
    arithmetic of the in-mesh band program on the band's LIVE rows only
    (the live scan prefix of a padded band equals the scan of the live-row
    geometry), so the retried payload is byte-identical."""

    def fn(rgb_band, init_dc, live_px_rows, *luts):
        payload, bits, _ = _encode_band(
            rgb_band, band_geom, algorithm, capacity, fast_dct,
            bin_dct_descale, init_dc,
            live_px_rows=live_px_rows, quality=quality, luts=luts or None,
        )
        return payload, bits

    del custom_luts  # part of the cache key; fn adapts to *luts itself
    return jax.jit(fn)


def _band_geometry(geom: FrameGeometry, band_h: int) -> FrameGeometry:
    """Geometry of one full-width MCU band of band_h pixel rows."""
    band = FrameGeometry(
        width=geom.width,
        height=band_h,
        h_factor=geom.h_factor,
        v_factor=geom.v_factor,
    )
    assert band.padded_height == band_h  # band_h is a multiple of 8*v
    return band


def encode_tiled(
    rgb: np.ndarray,
    config: EncoderConfig,
    mesh: Mesh,
) -> pipeline.EncodeResult:
    """Encode one (H, W, 3) image sharded into MCU bands across the mesh.

    With config.restart_interval set, the bands emit DRI/RSTn restart
    framing instead of one unbroken scan — the JPEG-native parallel
    encode: every interval's DC predictors reset, so the ppermute DC
    exchange disappears, and assembly is byte-aligned marker
    concatenation (io/jfif.assemble_restart) instead of bit-level
    splicing. Non-final bands must hold whole intervals (no interval may
    straddle a device boundary); when the even split misaligns, the band
    size is re-chosen as the smallest aligned one (_aligned_band_rows),
    and only geometries with NO aligned multi-band split fall back to the
    single-device restart encode with a warning.
    """
    height, width = rgb.shape[:2]
    geom = config.geometry(width, height)
    n_dev = mesh.devices.size
    if config.restart_interval is not None:
        # Raise the clear restart-vs-quirk-geometry error here rather
        # than warning about tiling first and raising from the fallback.
        pipeline.check_restart_geometry(geom)
    if not tileable(geom):
        # The reference accepts these inputs (main.rs:8-68), so refusing
        # them from an advertised mode would be a parity gap: encode on
        # one device instead, byte-identically, and say so.
        warnings.warn(
            f"dimensions {geom.width}x{geom.height} hit the reference's "
            "dim % (8*factor) == 1 chroma-grid misalignment quirk, which "
            "band-local encoding cannot reproduce; falling back to a "
            "single-device encode",
            RuntimeWarning,
            stacklevel=2,
        )
        return pipeline.encode_array(rgb, config)

    band_rows = _band_rows(geom, n_dev)
    restart = config.restart_interval
    live_bands = -(-geom.mcu_rows // band_rows)
    if restart is not None and live_bands > 1 and (
        (band_rows * geom.mcu_cols) % restart != 0
    ):
        # The even split puts an interval across a device boundary, but
        # the band size is ours to choose: take the smallest aligned
        # band_rows instead (trailing devices go dead but the mesh stays
        # busy). Only when NO aligned multi-band split exists does the
        # n-device -> 1-device fallback fire.
        aligned = _aligned_band_rows(geom, n_dev, restart)
        if aligned is not None and -(-geom.mcu_rows // aligned) > 1:
            band_rows = aligned
        else:
            warnings.warn(
                f"restart interval {restart} admits no band split of the "
                f"{geom.mcu_rows}x{geom.mcu_cols}-MCU grid over the "
                f"{n_dev}-device mesh (every candidate band would put an "
                "interval across a device boundary); falling back to a "
                "single-device restart encode",
                RuntimeWarning,
                stacklevel=2,
            )
            return pipeline.encode_array(rgb, config)
    band_h = band_rows * 8 * geom.v_factor
    total_h = band_h * n_dev  # >= geom.padded_height; extra rows stay zero
    padded = np.zeros((total_h, width, 3), np.uint8)
    padded[:height] = rgb

    band_geom = _band_geometry(geom, band_h)
    if restart is not None:
        capacity = pipeline.restart_default_capacity_bytes(
            band_geom, restart, config.capacity_bytes_per_pixel
        )
    else:
        capacity = pipeline.default_capacity_bytes(
            band_geom, config.capacity_bytes_per_pixel
        )
    # A mesh spanning several processes (multi-host: one huge image across
    # hosts) needs the global input assembled from per-process shards and
    # the outputs replicated back to every process; in-process meshes keep
    # the cheaper local paths.
    multi = any(
        d.process_index != jax.process_index() for d in mesh.devices.flat
    )
    if multi:
        in_sharding = jax.sharding.NamedSharding(mesh, P(DATA_AXIS, None, None))
        device_rgb = jax.make_array_from_callback(
            padded.shape, in_sharding, lambda idx: padded[idx]
        )
    else:
        device_rgb = jnp.asarray(padded)
    if config.optimize_huffman:
        # Cross-band table agreement: every band's statistics psum into
        # one whole-scan histogram (4x256 ints), the host builds
        # ONE optimal table set, and every band codes with it — so the
        # tiled optimized file equals the single-device optimized file.
        hist = np.asarray(compiled_tiled_stats(
            mesh, geom, config.dct_algorithm, config.fast_dct,
            config.bin_dct_descale, config.quality, restart, band_rows,
        )(device_rgb))
        dht_specs, dc_lut, ac_lut = pipeline.optimal_specs_and_luts(hist)
        # Retry paths re-encode a band on a process-LOCAL device; keep the
        # tables as host arrays there so each jit commits them locally.
        luts = (np.asarray(dc_lut), np.asarray(ac_lut))
        if multi:
            # Every process built identical tables from the replicated
            # histogram; assemble them as replicated GLOBAL arrays — the
            # multi-process mesh program cannot consume process-local
            # single-device arrays.
            rep = jax.sharding.NamedSharding(mesh, P())
            dc_lut = jax.make_array_from_callback(
                luts[0].shape, rep, lambda idx: luts[0][idx]
            )
            ac_lut = jax.make_array_from_callback(
                luts[1].shape, rep, lambda idx: luts[1][idx]
            )
        encoder = compiled_tiled_encoder(
            mesh, geom, config.dct_algorithm, capacity, config.fast_dct,
            config.bin_dct_descale, config.quality, replicate_out=multi,
            restart=restart, band_rows=band_rows, custom_luts=True,
        )
        payloads, bit_lengths, init_dcs = encoder(device_rgb, dc_lut, ac_lut)
    else:
        dht_specs = None
        luts = None
        encoder = compiled_tiled_encoder(
            mesh, geom, config.dct_algorithm, capacity, config.fast_dct,
            config.bin_dct_descale, config.quality, replicate_out=multi,
            restart=restart, band_rows=band_rows,
        )
        payloads, bit_lengths, init_dcs = encoder(device_rgb)
    bit_lengths = np.asarray(bit_lengths)
    # Device-side prefix slice before the fetch: the capacity rectangle
    # is ~5x the real payloads (pipeline.bucket_fetch_bytes keeps the
    # slice shapes stable).
    max_bytes = pipeline.bucket_fetch_bytes(
        (int(bit_lengths.max()) + 7) // 8, capacity
    )
    payloads = np.asarray(payloads[..., :max_bytes])
    init_dcs = np.asarray(init_dcs)

    if restart is not None:
        return _assemble_tiled_restart(
            padded, geom, config, n_dev, capacity, payloads, bit_lengths,
            band_rows, dht_specs=dht_specs, luts=luts,
        )

    chunks = []
    for i in range(n_dev):
        bits = int(bit_lengths[i])
        if bits <= 8 * capacity:
            chunks.append((payloads[i], bits))
            continue
        # This band overflowed the shared capacity estimate: re-encode only
        # it (with the init_dc the mesh program handed it) at larger
        # capacities — never the whole image.
        chunks.append(
            _retry_band(
                padded, geom, config, n_dev, i, capacity, init_dcs[i], luts
            )
        )

    spliced, total_bits = splice_bitstreams(chunks)
    return pipeline.EncodeResult(
        file_bytes=jfif.assemble(
            geom, spliced, quality=config.quality, dht_specs=dht_specs
        ),
        entropy_payload=spliced,
        bit_length=total_bits,
        geom=geom,
    )


def _assemble_tiled_restart(
    padded: np.ndarray,
    geom: FrameGeometry,
    config: EncoderConfig,
    n_dev: int,
    capacity: int,
    payloads: np.ndarray,      # (n_dev, n_int, <= capacity) byte prefixes
    bit_lengths: np.ndarray,   # (n_dev, n_int)
    band_rows: int,
    dht_specs: tuple | None = None,
    luts: tuple | None = None,
) -> pipeline.EncodeResult:
    """Band-tiled restart assembly: interval concatenation, no splicing.

    Walks bands in order, keeps each band's LIVE intervals (the trailing
    band's fully-dead padding intervals report 0 bits and are dropped by
    construction), retries an overflowed band through the single-band
    restart program, and hands the flat interval sequence to
    jfif.assemble_restart (which numbers RSTn mod 8 across the whole
    image). EncodeResult fields follow _encode_array_restart's contract.
    """
    restart = config.restart_interval
    segments: list[np.ndarray] = []
    bits_list: list[int] = []
    for i in range(n_dev):
        live_mcus = _live_mcu_rows(geom, band_rows, i) * geom.mcu_cols
        n_live = -(-live_mcus // restart)
        if n_live == 0:
            continue
        if int(bit_lengths[i, :n_live].max()) > 8 * capacity:
            band_segments = _retry_band_restart(
                padded, geom, config, band_rows, i, capacity, luts
            )
        else:
            band_segments = [
                (payloads[i, j], int(bit_lengths[i, j]))
                for j in range(n_live)
            ]
        for payload, bits in band_segments:
            segments.append(payload)
            bits_list.append(bits)
    return pipeline.restart_result(
        geom, segments, bits_list, restart, config.quality,
        dht_specs=dht_specs,
    )


def _retry_band_restart(
    padded: np.ndarray,
    geom: FrameGeometry,
    config: EncoderConfig,
    band_rows: int,
    idx: int,
    capacity: int,
    luts: tuple | None = None,
) -> list[tuple[np.ndarray, int]]:
    """Re-encode band `idx`'s restart intervals at larger capacities."""
    restart = config.restart_interval
    band_h = band_rows * 8 * geom.v_factor
    live_rows = _live_mcu_rows(geom, band_rows, idx)
    live_geom = _band_geometry(geom, live_rows * 8 * geom.v_factor)
    band_rgb = jnp.asarray(
        padded[idx * band_h : idx * band_h + live_geom.padded_height]
    )
    live_px = jnp.int32(
        max(0, min(geom.height - idx * band_h, live_geom.padded_height))
    )
    n_live = -(-live_geom.num_mcus // restart)
    while True:
        if capacity >= pipeline.restart_worst_case_capacity_bytes(
            live_geom, restart
        ):
            raise AssertionError(
                "interval bit length exceeds the worst-case capacity — "
                "entropy packer invariant violated"
            )
        capacity = pipeline.restart_next_capacity_bytes(
            live_geom, restart, capacity
        )
        enc = compiled_band_restart_encoder(
            live_geom, config.dct_algorithm, capacity, restart,
            config.fast_dct, config.bin_dct_descale, config.quality,
            custom_luts=luts is not None,
        )
        payloads, bits = (
            enc(band_rgb, live_px, *luts) if luts is not None
            else enc(band_rgb, live_px)
        )
        bits = np.asarray(bits)
        if int(bits[:n_live].max()) <= 8 * capacity:
            max_bytes = (int(bits[:n_live].max()) + 7) // 8
            payloads = np.asarray(payloads[:, :max_bytes])
            return [(payloads[j], int(bits[j])) for j in range(n_live)]


@functools.lru_cache(maxsize=32)
def compiled_band_restart_encoder(
    band_geom: FrameGeometry,
    algorithm: DctAlgorithm,
    capacity: int,
    restart: int,
    fast_dct: bool = False,
    bin_dct_descale: bool = False,
    quality: int | None = None,
    custom_luts: bool = False,
):
    """Jitted single-band restart re-encode for overflow retry."""

    def fn(rgb_band, live_px_rows, *luts):
        payloads, bits, _ = _encode_band(
            rgb_band, band_geom, algorithm, capacity, fast_dct,
            bin_dct_descale, None, live_px_rows=live_px_rows,
            quality=quality, restart=restart, luts=luts or None,
        )
        return payloads, bits

    del custom_luts  # part of the cache key; fn adapts to *luts itself
    return jax.jit(fn)


def _retry_band(
    padded: np.ndarray,
    geom: FrameGeometry,
    config: EncoderConfig,
    n_dev: int,
    idx: int,
    capacity: int,
    init_dc: np.ndarray,
    luts: tuple | None = None,
) -> tuple[np.ndarray, int]:
    """Re-encode band `idx` alone, walking the capacity ladder upward."""
    band_rows = _band_rows(geom, n_dev)
    band_h = band_rows * 8 * geom.v_factor
    live_rows = _live_mcu_rows(geom, band_rows, idx)
    live_geom = _band_geometry(geom, live_rows * 8 * geom.v_factor)
    band_rgb = jnp.asarray(
        padded[idx * band_h : idx * band_h + live_geom.padded_height]
    )
    init = jnp.asarray(init_dc.astype(np.int32))
    live_px = jnp.int32(
        max(0, min(geom.height - idx * band_h, live_geom.padded_height))
    )
    while True:
        if capacity >= pipeline.worst_case_capacity_bytes(live_geom):
            raise AssertionError(
                "band bit length exceeds the worst-case capacity — "
                "entropy packer invariant violated"
            )
        capacity = pipeline.next_capacity_bytes(live_geom, capacity)
        enc = compiled_band_encoder(
            live_geom, config.dct_algorithm, capacity, config.fast_dct,
            config.bin_dct_descale, config.quality,
            custom_luts=luts is not None,
        )
        payload, bits = (
            enc(band_rgb, init, live_px, *luts) if luts is not None
            else enc(band_rgb, init, live_px)
        )
        bits = int(bits)
        if bits <= 8 * capacity:
            return np.asarray(payload[: (bits + 7) // 8]), bits
