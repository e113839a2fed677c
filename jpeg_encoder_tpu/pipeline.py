"""End-to-end encode pipeline: one jitted device program + host assembly.

The reference runs five sequential host stages with two thread-scope forks
(main.rs:8-68). Here the entire compute path — color conversion, padding,
subsampling, both DCT variants, quantization, run-length symbolization and
Huffman bit packing — is a single device program of plain XLA ops per
(geometry, algorithm, capacity) tuple, traced once and cached. The host
(C++ where hot: native/host_runtime.cpp) only decodes the BMP, slices the
packed payload, stuffs 0xFF bytes, and concatenates the JFIF container.

The per-channel thread parallelism of the reference (sampling.rs:83-98,
dct_quant.rs:29-60) is subsumed by batching: all three channels' blocks flow
through the same vectorized ops, and XLA schedules them across the device.
"""

from __future__ import annotations

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np

from jpeg_encoder_tpu import tables
from jpeg_encoder_tpu.config import DctAlgorithm, EncoderConfig, FrameGeometry
from jpeg_encoder_tpu.io import bmp, jfif
from jpeg_encoder_tpu.ops import color, dct, entropy, sample
from jpeg_encoder_tpu.utils import aot_cache

# Hard upper bound on packed bits per scan entry (one 8x8 block):
# DC slot <= 11+11, 63 AC slots <= 16+10, EOB <= 16. We use the round
# 65 * 27 bound; with it, overflow is impossible and no retry path is needed.
WORST_CASE_BITS_PER_ENTRY = entropy.SLOTS_PER_ENTRY * 27


def worst_case_capacity_bytes(geom: FrameGeometry) -> int:
    bits = geom.num_scan_entries * WORST_CASE_BITS_PER_ENTRY
    return (bits // 8 + 4) // 4 * 4


def default_capacity_bytes(
    geom: FrameGeometry, bytes_per_pixel: float = 0.5
) -> int:
    """Initial output-buffer size: a content estimate, not the worst case.

    The packer's cost scales with the buffer (its level-2 assembly visits
    every output word), and the worst case (~27 bytes per 8x8 block) is
    ~100x any real image's payload — sizing for it once made packing the
    entire pipeline cost. Instead start from
    `bytes_per_pixel` (default 0.5 B/px = 4 bits/px, several times the
    typical Annex-K-table rate; EncoderConfig.capacity_bytes_per_pixel
    overrides), bucket to a power of two so the retry ladder compiles
    O(log) program variants, and let callers retry with
    `next_capacity_bytes` on the (detectable, rare) overflow.
    """
    worst = worst_case_capacity_bytes(geom)
    est = max(int(geom.width * geom.height * bytes_per_pixel), 16384)
    cap = 1 << (est - 1).bit_length()
    return min(cap, worst)


def next_capacity_bytes(geom: FrameGeometry, capacity_bytes: int) -> int:
    """The retry ladder: 8x the buffer, capped at the true worst case."""
    return min(capacity_bytes * 8, worst_case_capacity_bytes(geom))


def restart_worst_case_capacity_bytes(
    geom: FrameGeometry, restart_mcus: int
) -> int:
    """Worst case for ONE restart interval (its entries only)."""
    entries = min(restart_mcus, geom.num_mcus) * geom.blocks_per_mcu
    bits = entries * WORST_CASE_BITS_PER_ENTRY
    return (bits // 8 + 4) // 4 * 4


def restart_default_capacity_bytes(
    geom: FrameGeometry, restart_mcus: int, bytes_per_pixel: float = 0.5
) -> int:
    """Initial per-interval buffer: the whole-image estimate split evenly.

    Same power-of-two bucketing / retry-ladder contract as
    default_capacity_bytes, floored at 4 KiB so tiny intervals don't
    thrash the ladder on content spikes.
    """
    worst = restart_worst_case_capacity_bytes(geom, restart_mcus)
    n_int = -(-geom.num_mcus // restart_mcus)
    est = max(
        int(geom.width * geom.height * bytes_per_pixel) // n_int, 4096
    )
    cap = 1 << (est - 1).bit_length()
    return min(cap, worst)


def bucket_fetch_bytes(num_bytes: int, capacity_bytes: int) -> int:
    """Round a device->host payload-fetch length up to a power of two.

    Every distinct slice length is its own compiled slice program on any
    backend, so content-exact lengths would compile one for every image
    or chunk. <= 2x extra fetched bytes buys O(log capacity) stable
    shapes per capacity rung.
    """
    return min(capacity_bytes, 1 << (max(num_bytes, 1) - 1).bit_length())


def restart_next_capacity_bytes(
    geom: FrameGeometry, restart_mcus: int, capacity_bytes: int
) -> int:
    """The restart-mode retry ladder (per-interval buffers): 8x, capped."""
    return min(
        capacity_bytes * 8,
        restart_worst_case_capacity_bytes(geom, restart_mcus),
    )


def dct_planes_zigzag(
    y_plane: jnp.ndarray,
    cb_plane: jnp.ndarray,
    cr_plane: jnp.ndarray,
    algorithm: DctAlgorithm,
    fast_dct: bool = False,
    bin_dct_descale: bool = False,
    quality: int | None = None,
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Padded planes -> zigzag quantized coefficients (production path).

    Shared by the batch pipeline (encode_core) and the MCU-band-sharded
    path (parallel/tiled.py) so both run identical arithmetic. Bit-exact
    vs the reference semantics (dct_quant.rs:189-234 for RealDCT,
    :67-187 for binDCT) except for the documented --fast-dct contract.
    """
    return dct.dct_quantize_planes(
        sample.blockify(y_plane), sample.blockify(cb_plane),
        sample.blockify(cr_plane), algorithm, fast_dct,
        zigzag_out=True, bin_dct_descale=bin_dct_descale, quality=quality,
    )


def encode_core(
    rgb: jnp.ndarray,
    geom: FrameGeometry,
    algorithm: DctAlgorithm,
    capacity_bytes: int,
    fast_dct: bool = False,
    validate: bool = False,
    with_coeffs: bool = True,
    bin_dct_descale: bool = False,
    quality: int | None = None,
) -> dict[str, jnp.ndarray]:
    """(H, W, 3) uint8 -> packed entropy payload + quantized coefficients.

    Pure, jittable, and vmap/shard_map-compatible for fixed static args.
    The DCT emits zigzag-ordered coefficients (the permutation is folded
    into its constants) feeding the scan encoder gather-free; coefficient
    outputs are un-permuted to natural order, and with_coeffs=False drops
    them so callers that only want the bitstream skip that work.
    """
    # The zigzag scan permutation is folded into the DCT constants, so
    # the scan encoder skips its lane gather; returned coefficients are
    # un-permuted below. All three planes run through one transform
    # chain with a per-row quant-table select (bit-identical to
    # per-plane calls, one fusion instead of three).
    y_z, cb_z, cr_z = _planes_zigzag(
        rgb, geom, algorithm, fast_dct, bin_dct_descale, quality
    )
    payload, total_bits = entropy.encode_scan(
        y_z, cb_z, cr_z, geom, capacity_bytes, coeffs_zigzagged=True,
    )
    result = {"payload": payload, "total_bits": total_bits}
    if with_coeffs:
        inv_zz = jnp.asarray(np.argsort(tables.ZIGZAG_ORDER))
        result["y_coeffs"] = y_z[:, inv_zz].astype(jnp.int16)
        result["cb_coeffs"] = cb_z[:, inv_zz].astype(jnp.int16)
        result["cr_coeffs"] = cr_z[:, inv_zz].astype(jnp.int16)
    if validate:
        # Ranges are permutation-invariant: DC stays at column 0 and the
        # AC value set is unchanged by the zigzag ordering.
        result["max_dc_diff"], result["max_ac"] = entropy.coefficient_ranges(
            y_z, cb_z, cr_z, geom
        )
    return result


@functools.lru_cache(maxsize=64)
def compiled_encoder(
    geom: FrameGeometry,
    algorithm: DctAlgorithm,
    capacity_bytes: int,
    fast_dct: bool = False,
    validate: bool = False,
    with_coeffs: bool = False,
    bin_dct_descale: bool = False,
    quality: int | None = None,
):
    """Jitted encode_core for one static configuration (cached).

    With utils/aot_cache enabled (the CLI does), the compiled executable
    is deserialized straight from disk — skipping trace + lower +
    compile-cache load, which otherwise dominate a warm process start —
    and serialized back on a miss. The input shape is fully determined by
    `geom`, so the example spec needs no caller input.
    """

    def fn(rgb: jnp.ndarray) -> dict[str, jnp.ndarray]:
        return encode_core(
            rgb, geom, algorithm, capacity_bytes, fast_dct,
            validate, with_coeffs, bin_dct_descale, quality,
        )

    jitted = jax.jit(fn)
    if aot_cache.enabled():
        spec = jax.ShapeDtypeStruct(
            (geom.height, geom.width, 3), jnp.uint8
        )
        key = (
            "encode_core", geom, algorithm.value, capacity_bytes, fast_dct,
            validate, with_coeffs, bin_dct_descale, quality,
        )
        loaded = aot_cache.get_or_build(key, jitted, spec)
        if loaded is not None:
            return loaded
    return jitted


def encode_core_restart(
    rgb: jnp.ndarray,
    geom: FrameGeometry,
    algorithm: DctAlgorithm,
    capacity_bytes: int,
    restart_mcus: int,
    fast_dct: bool = False,
    validate: bool = False,
    bin_dct_descale: bool = False,
    quality: int | None = None,
) -> dict[str, jnp.ndarray]:
    """encode_core for the restart-marker mode: one stream per interval.

    Identical front half (color, subsample, fused DCT); the scan stage
    encodes each run of `restart_mcus` MCUs as an independent segment with
    reset DC predictors (ops/entropy.encode_scan_restart), vmapped so all
    intervals pack concurrently. `capacity_bytes` is per interval. Restart
    markers don't exist in the reference (file.rs:77-90) — this is the
    opt-in extension producing parallel-decodable, spec-valid files.
    """
    y_z, cb_z, cr_z = _planes_zigzag(
        rgb, geom, algorithm, fast_dct, bin_dct_descale, quality
    )
    payloads, bits = entropy.encode_scan_restart(
        y_z, cb_z, cr_z, geom, capacity_bytes, restart_mcus,
        coeffs_zigzagged=True,
    )
    result = {"payloads": payloads, "bits": bits}
    if validate:
        result["max_dc_diff"], result["max_ac"] = entropy.coefficient_ranges(
            y_z, cb_z, cr_z, geom
        )
    return result


@functools.lru_cache(maxsize=64)
def compiled_restart_encoder(
    geom: FrameGeometry,
    algorithm: DctAlgorithm,
    capacity_bytes: int,
    restart_mcus: int,
    fast_dct: bool = False,
    validate: bool = False,
    bin_dct_descale: bool = False,
    quality: int | None = None,
):
    """Jitted encode_core_restart (AOT-cached like compiled_encoder)."""

    def fn(rgb: jnp.ndarray) -> dict[str, jnp.ndarray]:
        return encode_core_restart(
            rgb, geom, algorithm, capacity_bytes, restart_mcus, fast_dct,
            validate, bin_dct_descale, quality,
        )

    jitted = jax.jit(fn)
    if aot_cache.enabled():
        spec = jax.ShapeDtypeStruct(
            (geom.height, geom.width, 3), jnp.uint8
        )
        key = (
            "encode_core_restart", geom, algorithm.value, capacity_bytes,
            restart_mcus, fast_dct, validate, bin_dct_descale, quality,
        )
        loaded = aot_cache.get_or_build(key, jitted, spec)
        if loaded is not None:
            return loaded
    return jitted


def _planes_zigzag(rgb, geom, algorithm, fast_dct, bin_dct_descale,
                   quality):
    """Shared front half: RGB -> zigzag coefficients (the colour,
    subsample and DCT stages of every encode and statistics pass).

    The named scopes label the stages' operations in profiler traces.
    """
    with jax.named_scope("colour_subsample"):
        y, cb, cr = color.rgb_to_ycbcr(rgb)
        y = sample.pad_plane(y, geom)
        cb = sample.subsample_plane(sample.pad_plane(cb, geom), geom)
        cr = sample.subsample_plane(sample.pad_plane(cr, geom), geom)
    with jax.named_scope("dct"):
        return dct_planes_zigzag(
            y, cb, cr, algorithm, fast_dct, bin_dct_descale, quality
        )


def stats_core(
    rgb: jnp.ndarray,
    geom: FrameGeometry,
    algorithm: DctAlgorithm,
    fast_dct: bool = False,
    bin_dct_descale: bool = False,
    quality: int | None = None,
    restart_mcus: int | None = None,
) -> jnp.ndarray:
    """Statistics pass body: rgb -> (4, 256) Huffman symbol counts.

    Pure and vmap/shard_map-compatible (the batched optimize path maps it
    over the image axis). restart_mcus must match the encode pass's
    framing (interval DC resets change the DC categories the tables must
    cover)."""
    y_z, cb_z, cr_z = _planes_zigzag(
        rgb, geom, algorithm, fast_dct, bin_dct_descale, quality
    )
    return entropy.symbol_histograms(
        y_z, cb_z, cr_z, geom, coeffs_zigzagged=True,
        restart_mcus=restart_mcus,
    )


@functools.lru_cache(maxsize=64)
def compiled_stats_encoder(
    geom: FrameGeometry,
    algorithm: DctAlgorithm,
    fast_dct: bool = False,
    bin_dct_descale: bool = False,
    quality: int | None = None,
    restart_mcus: int | None = None,
):
    """Jitted stats_core for one static configuration (cached)."""

    def fn(rgb: jnp.ndarray) -> jnp.ndarray:
        return stats_core(
            rgb, geom, algorithm, fast_dct, bin_dct_descale, quality,
            restart_mcus,
        )

    return jax.jit(fn)


def custom_core(
    rgb: jnp.ndarray,
    dc_lut: jnp.ndarray,
    ac_lut: jnp.ndarray,
    geom: FrameGeometry,
    algorithm: DctAlgorithm,
    capacity_bytes: int,
    restart_mcus: int | None = None,
    fast_dct: bool = False,
    validate: bool = False,
    bin_dct_descale: bool = False,
    quality: int | None = None,
) -> dict[str, jnp.ndarray]:
    """Encode with TRACED Huffman tables ((2, 256) packed LUT operands).

    Pure and vmap/shard_map-compatible like encode_core; the tables are
    operands, so one compiled program serves every per-image optimized
    table set.
    """
    y_z, cb_z, cr_z = _planes_zigzag(
        rgb, geom, algorithm, fast_dct, bin_dct_descale, quality
    )
    luts = (dc_lut, ac_lut)
    if restart_mcus is not None:
        payloads, bits = entropy.encode_scan_restart(
            y_z, cb_z, cr_z, geom, capacity_bytes, restart_mcus,
            coeffs_zigzagged=True, luts=luts,
        )
        result = {"payloads": payloads, "bits": bits}
    else:
        payload, total_bits = entropy.encode_scan(
            y_z, cb_z, cr_z, geom, capacity_bytes,
            coeffs_zigzagged=True, luts=luts,
        )
        result = {"payload": payload, "total_bits": total_bits}
    if validate:
        result["max_dc_diff"], result["max_ac"] = (
            entropy.coefficient_ranges(y_z, cb_z, cr_z, geom)
        )
    return result


@functools.lru_cache(maxsize=64)
def compiled_custom_encoder(
    geom: FrameGeometry,
    algorithm: DctAlgorithm,
    capacity_bytes: int,
    restart_mcus: int | None = None,
    fast_dct: bool = False,
    validate: bool = False,
    bin_dct_descale: bool = False,
    quality: int | None = None,
):
    """Jitted custom_core: fn(rgb, dc_lut, ac_lut) (cached)."""

    def fn(rgb, dc_lut, ac_lut):
        return custom_core(
            rgb, dc_lut, ac_lut, geom, algorithm, capacity_bytes,
            restart_mcus, fast_dct, validate, bin_dct_descale, quality,
        )

    return jax.jit(fn)


def optimal_specs_and_luts(hist: np.ndarray):
    """(4, 256) symbol counts -> (specs 4-tuple, (dc, ac) device LUTs)."""
    specs = tuple(tables.optimal_spec(hist[i]) for i in range(4))
    dc_lut = jnp.asarray(np.stack(
        [entropy.pack_lut(specs[0]), entropy.pack_lut(specs[1])]
    ))
    ac_lut = jnp.asarray(np.stack(
        [entropy.pack_lut(specs[2]), entropy.pack_lut(specs[3])]
    ))
    return specs, dc_lut, ac_lut


def _encode_array_optimized(
    rgb: np.ndarray, config: EncoderConfig, geom: FrameGeometry
) -> EncodeResult:
    """Two-pass optimized-Huffman encode (encode_array body).

    Pass 1 histograms the scan's symbols on device; the host builds the
    four optimal canonical tables (tables.optimal_spec); pass 2 encodes
    with the tables as traced operands and writes them into the DHT
    segments. Composes with restart framing (the interval streams code
    with the same per-image tables).
    """
    restart = config.restart_interval
    if restart is not None:
        check_restart_geometry(geom)
    device_rgb = jnp.asarray(rgb, dtype=jnp.uint8)
    hist = np.asarray(compiled_stats_encoder(
        geom, config.dct_algorithm, config.fast_dct,
        config.bin_dct_descale, config.quality, restart,
    )(device_rgb))
    specs, dc_lut, ac_lut = optimal_specs_and_luts(hist)

    if restart is not None:
        capacity = restart_default_capacity_bytes(
            geom, restart, config.capacity_bytes_per_pixel
        )
    else:
        capacity = default_capacity_bytes(
            geom, config.capacity_bytes_per_pixel
        )
    while True:
        out = compiled_custom_encoder(
            geom, config.dct_algorithm, capacity, restart,
            config.fast_dct, config.validate, config.bin_dct_descale,
            config.quality,
        )(device_rgb, dc_lut, ac_lut)
        if config.validate:
            validate_scan_ranges(
                int(out["max_dc_diff"]), int(out["max_ac"])
            )
        if restart is not None:
            bits = np.asarray(out["bits"])
            if int(bits.max()) <= 8 * capacity:
                break
            if capacity >= restart_worst_case_capacity_bytes(geom, restart):
                raise AssertionError("packer invariant violated")
            capacity = restart_next_capacity_bytes(geom, restart, capacity)
        else:
            bit_length = int(out["total_bits"])
            if bit_length <= 8 * capacity:
                break
            if capacity >= worst_case_capacity_bytes(geom):
                raise AssertionError("packer invariant violated")
            capacity = next_capacity_bytes(geom, capacity)

    if restart is not None:
        max_bytes = min(capacity, (int(bits.max()) + 7) // 8)
        payloads = np.asarray(out["payloads"][:, :max_bytes])
        return restart_result(
            geom, list(payloads), [int(b) for b in bits], restart,
            config.quality, dht_specs=specs,
        )
    num_bytes = (bit_length + 7) // 8
    payload = np.asarray(out["payload"][:num_bytes]).tobytes()
    return EncodeResult(
        file_bytes=jfif.assemble(
            geom, payload, quality=config.quality, dht_specs=specs
        ),
        entropy_payload=payload,
        bit_length=bit_length,
        geom=geom,
    )


def validate_scan_ranges(max_dc_diff: int, max_ac: int) -> None:
    """Raise like the reference panics (entropy_coding.rs:153-155,188-191)."""
    if max_dc_diff.bit_length() > 11:
        raise ValueError("DC coefficient bit length greater than 11!")
    if max_ac.bit_length() > 10:
        raise ValueError("AC coefficient bit length greater than 10!")


@dataclasses.dataclass
class EncodeResult:
    file_bytes: bytes
    entropy_payload: bytes  # unstuffed scan payload
    bit_length: int
    geom: FrameGeometry


def encode_array(
    rgb: np.ndarray,
    config: EncoderConfig = EncoderConfig(),
    *,
    return_coeffs: bool = False,
    _initial_capacity_bytes: int | None = None,
):
    """Encode an (H, W, 3) uint8 RGB array into JFIF bytes.

    _initial_capacity_bytes starts the capacity ladder at a known rung
    (used by the batch path to retry a single overflowed image without
    repeating the rungs it already saw fail).
    """
    if rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError("expected (H, W, 3) RGB input")
    height, width = rgb.shape[:2]
    geom = config.geometry(width, height)
    if config.optimize_huffman:
        if return_coeffs:
            raise ValueError(
                "return_coeffs is not supported with optimized Huffman"
            )
        return _encode_array_optimized(rgb, config, geom)
    if config.restart_interval is not None:
        if return_coeffs:
            raise ValueError(
                "return_coeffs is not supported with restart markers"
            )
        return _encode_array_restart(
            rgb, config, geom,
            _initial_capacity_bytes=_initial_capacity_bytes,
        )
    capacity = _initial_capacity_bytes or default_capacity_bytes(
        geom, config.capacity_bytes_per_pixel
    )
    device_rgb = jnp.asarray(rgb, dtype=jnp.uint8)
    while True:
        out = compiled_encoder(
            geom, config.dct_algorithm, capacity, config.fast_dct,
            config.validate, return_coeffs,
            config.bin_dct_descale, config.quality,
        )(device_rgb)
        if config.validate:
            validate_scan_ranges(
                int(out["max_dc_diff"]), int(out["max_ac"])
            )
        bit_length = int(out["total_bits"])
        if bit_length <= 8 * capacity:
            break
        # Payload overflowed the estimate (pack_entries drops the excess but
        # reports the true length): re-encode with a bigger buffer. The
        # ladder tops out at the worst case; exceeding THAT means the
        # bits-per-entry bound was violated (a packer bug) — raise rather
        # than retry the same capacity forever.
        if capacity >= worst_case_capacity_bytes(geom):
            raise AssertionError(
                f"packed bit length {bit_length} exceeds the worst-case "
                f"capacity {capacity} B — entropy packer invariant violated"
            )
        capacity = next_capacity_bytes(geom, capacity)
    num_bytes = (bit_length + 7) // 8
    # Slice ON DEVICE before fetching: the capacity buffer is ~5x the
    # payload, so this moves ~5x fewer bytes to the host. The slice
    # length is BUCKETED (bucket_fetch_bytes): content-exact lengths
    # would compile a new slice program per image.
    bucket = bucket_fetch_bytes(num_bytes, capacity)
    payload = np.asarray(out["payload"][:bucket])[:num_bytes].tobytes()
    result = EncodeResult(
        file_bytes=jfif.assemble(geom, payload, quality=config.quality),
        entropy_payload=payload,
        bit_length=bit_length,
        geom=geom,
    )
    if return_coeffs:
        coeffs = tuple(
            np.asarray(out[k]) for k in ("y_coeffs", "cb_coeffs", "cr_coeffs")
        )
        return result, coeffs
    return result


def check_restart_geometry(geom: FrameGeometry) -> None:
    """Refuse restart framing on MCU-grid-misaligned quirk geometries.

    The reference's quirk geometries emit fewer MCUs than the SOF
    dimensions imply (config.FrameGeometry.mcu_grid_aligned). An unbroken
    scan hides that (decoders read sequentially, staying in lockstep with
    the reference-parity stream), but restart markers RESYNC the decoder
    to absolute MCU positions — interval k starts at MCU k*N of the
    DECODER's grid — so a framed file would decode shifted and truncated
    (verified against PIL). Refuse loudly instead.
    """
    if not geom.mcu_grid_aligned:
        raise ValueError(
            f"restart markers are unsupported for {geom.width}x"
            f"{geom.height} at {geom.h_factor}:{geom.v_factor} "
            "subsampling: the reference-parity scan omits trailing MCU "
            "columns/rows on this dim % (8*factor) == 1 quirk geometry, "
            "which is incompatible with the absolute MCU positions "
            "restart markers give the decoder; encode without "
            "--restart-interval"
        )


def restart_result(
    geom: FrameGeometry,
    segments: list[np.ndarray],
    bits_list: list[int],
    restart_mcus: int,
    quality: int | None,
    dht_specs: tuple | None = None,
) -> EncodeResult:
    """EncodeResult for a restart-framed encode, from per-interval streams.

    Single place defining the restart-mode result contract (shared by the
    single-device and band-tiled paths): file_bytes via
    jfif.assemble_restart; entropy_payload = the byte-aligned (1-padded),
    unstuffed interval segments concatenated WITHOUT the RSTn markers;
    bit_length = the sum of the segments' true bit counts (no padding).
    """
    padded_segs = [
        jfif.pad_final_byte(
            np.ascontiguousarray(p[: (b + 7) // 8], dtype=np.uint8), b
        )
        for p, b in zip(segments, bits_list)
    ]
    return EncodeResult(
        file_bytes=jfif.assemble_restart(
            geom, segments, bits_list, restart_mcus, quality=quality,
            dht_specs=dht_specs,
        ),
        entropy_payload=b"".join(s.tobytes() for s in padded_segs),
        bit_length=int(sum(bits_list)),
        geom=geom,
    )


def _encode_array_restart(
    rgb: np.ndarray,
    config: EncoderConfig,
    geom: FrameGeometry,
    _initial_capacity_bytes: int | None = None,
) -> EncodeResult:
    """encode_array body for restart-marker mode (per-interval streams).

    The capacity ladder keys on the LARGEST interval's bit count; the
    EncodeResult's entropy_payload is the concatenation of the byte-aligned
    (1-padded), unstuffed interval segments WITHOUT the RSTn markers, and
    bit_length sums the segments' true bit counts (excluding padding).
    _initial_capacity_bytes starts the ladder past a rung the batch path
    already saw overflow.
    """
    restart = config.restart_interval
    check_restart_geometry(geom)
    capacity = _initial_capacity_bytes or restart_default_capacity_bytes(
        geom, restart, config.capacity_bytes_per_pixel
    )
    device_rgb = jnp.asarray(rgb, dtype=jnp.uint8)
    while True:
        out = compiled_restart_encoder(
            geom, config.dct_algorithm, capacity, restart, config.fast_dct,
            config.validate, config.bin_dct_descale, config.quality,
        )(device_rgb)
        if config.validate:
            validate_scan_ranges(
                int(out["max_dc_diff"]), int(out["max_ac"])
            )
        bits = np.asarray(out["bits"])
        if int(bits.max()) <= 8 * capacity:
            break
        if capacity >= restart_worst_case_capacity_bytes(geom, restart):
            raise AssertionError(
                f"interval bit length {int(bits.max())} exceeds the "
                f"worst-case capacity {capacity} B — packer invariant "
                "violated"
            )
        capacity = restart_next_capacity_bytes(geom, restart, capacity)
    # Fetch only the longest interval's byte prefix of every row (the
    # buffer is an estimate-sized rectangle; bucket_fetch_bytes keeps the
    # slice shapes stable).
    max_bytes = bucket_fetch_bytes((int(bits.max()) + 7) // 8, capacity)
    payloads = np.asarray(out["payloads"][:, :max_bytes])
    return restart_result(
        geom, list(payloads), [int(b) for b in bits], restart,
        config.quality,
    )


def encode_file(
    bmp_path: str | os.PathLike,
    output_path: str | os.PathLike,
    config: EncoderConfig = EncoderConfig(),
) -> EncodeResult:
    """BMP file -> JFIF file (the reference's single-image CLI path)."""
    rgb = bmp.read(bmp_path)
    result = encode_array(rgb, config)
    with open(output_path, "wb") as f:
        f.write(result.file_bytes)
    return result
