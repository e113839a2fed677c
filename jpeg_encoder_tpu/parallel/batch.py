"""Data-parallel batch encode: shard a batch of images across the mesh.

Each device encodes whole images independently (embarrassingly parallel —
the "100x 4K over several devices" configuration). The per-image program
is the same jitted pipeline as single-image encode, vmapped over the
device-local batch and laid out with shard_map so XLA keeps every image's
data resident on its own device; the only cross-device traffic is the
result fetch.

Memory bounds (the scale-out configurations' survival conditions):

* the host->device transfer is SHARDED — each device receives only its
  own batch slice (jax.make_array_from_callback with the batch
  NamedSharding), never the whole batch via device 0;
* dispatches are CHUNKED — encode_batch caps images per dispatch at a
  static per-geometry size (chunk_size_images: an input-byte budget per
  device), so a 1000x4K dataset flows through bounded device memory per
  step instead of one dispatch holding ~25 GB of input per process. Chunk
  shapes come from a power-of-two ladder over the device count, so any
  dataset size compiles O(log) program variants, not O(N).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from jpeg_encoder_tpu.config import DctAlgorithm, EncoderConfig, FrameGeometry
from jpeg_encoder_tpu.io import jfif
from jpeg_encoder_tpu import pipeline
from jpeg_encoder_tpu.parallel.mesh import DATA_AXIS

# Input bytes one dispatch may hold per device, as a share of the memory
# the device reports: the encode program's intermediates (coefficients,
# per-slot codes, packer buffers) take tens of bytes per input byte, so
# 1/128 of the device leaves room for them. Where the device reports no
# limit (the CPU backend), a fixed 128 MiB.
_BUDGET_SHARE = 128
_DEFAULT_INPUT_BUDGET = 128 * 1024 * 1024
# Hard cap on images per device per dispatch (tiny images would otherwise
# blow the vmapped program's size before hitting the byte budget).
MAX_IMAGES_PER_DEVICE = 64


def chunk_input_budget() -> int:
    """Per-device input-byte budget for one batch dispatch."""
    stats = jax.local_devices()[0].memory_stats() or {}
    limit = stats.get("bytes_limit")
    if not limit:
        return _DEFAULT_INPUT_BUDGET
    return int(limit) // _BUDGET_SHARE


@functools.lru_cache(maxsize=32)
def compiled_batch_encoder(
    mesh: Mesh,
    geom: FrameGeometry,
    algorithm: DctAlgorithm,
    capacity_bytes: int,
    fast_dct: bool = False,
    bin_dct_descale: bool = False,
    quality: int | None = None,
    restart_interval: int | None = None,
):
    """Jitted (B, H, W, 3) -> ((B, capacity) payloads, (B,) bit lengths).

    With restart_interval set, the per-image program is the restart-mode
    core instead and the outputs gain an interval axis:
    (B, n_intervals, capacity) payloads and (B, n_intervals) bit lengths
    (capacity_bytes is then PER INTERVAL).
    """

    def per_image(rgb):
        if restart_interval is not None:
            out = pipeline.encode_core_restart(
                rgb, geom, algorithm, capacity_bytes, restart_interval,
                fast_dct, bin_dct_descale=bin_dct_descale, quality=quality,
            )
            return out["payloads"], out["bits"]
        out = pipeline.encode_core(
            rgb, geom, algorithm, capacity_bytes, fast_dct,
            bin_dct_descale=bin_dct_descale, quality=quality,
        )
        return out["payload"], out["total_bits"]

    def per_shard(batch):  # (B_local, H, W, 3)
        return jax.vmap(per_image)(batch)

    if mesh.devices.size == 1:
        # Degenerate mesh: shard_map adds nothing, so single-device
        # batches take the plain vmapped program.
        return jax.jit(per_shard)
    sharded = shard_map(
        per_shard,
        mesh=mesh,
        in_specs=P(DATA_AXIS),
        out_specs=(P(DATA_AXIS), P(DATA_AXIS)),
        check_vma=False,
    )
    return jax.jit(sharded)


@functools.lru_cache(maxsize=32)
def compiled_batch_stats_encoder(
    mesh: Mesh,
    geom: FrameGeometry,
    algorithm: DctAlgorithm,
    fast_dct: bool = False,
    bin_dct_descale: bool = False,
    quality: int | None = None,
    restart_interval: int | None = None,
):
    """Jitted (B, H, W, 3) -> (B, 4, 256) Huffman symbol counts.

    The statistics pass of the BATCHED two-pass optimized-Huffman mode:
    the same shard_map layout as the encode pass, so each device
    histograms its own images.
    """

    def per_shard(batch):
        return jax.vmap(
            lambda rgb: pipeline.stats_core(
                rgb, geom, algorithm, fast_dct, bin_dct_descale, quality,
                restart_interval,
            )
        )(batch)

    if mesh.devices.size == 1:
        return jax.jit(per_shard)  # see compiled_batch_encoder
    sharded = shard_map(
        per_shard,
        mesh=mesh,
        in_specs=P(DATA_AXIS),
        out_specs=P(DATA_AXIS),
        check_vma=False,
    )
    return jax.jit(sharded)


@functools.lru_cache(maxsize=32)
def compiled_batch_custom_encoder(
    mesh: Mesh,
    geom: FrameGeometry,
    algorithm: DctAlgorithm,
    capacity_bytes: int,
    restart_interval: int | None = None,
    fast_dct: bool = False,
    bin_dct_descale: bool = False,
    quality: int | None = None,
):
    """Jitted (images, dc_luts, ac_luts) -> per-image payloads + bits.

    The encode pass of the batched optimized-Huffman mode: per-image
    (2, 256) packed tables ride the batch axis as traced operands, so
    ONE compiled program serves any set of per-image tables.
    """

    def per_image(rgb, dc_lut, ac_lut):
        out = pipeline.custom_core(
            rgb, dc_lut, ac_lut, geom, algorithm, capacity_bytes,
            restart_interval, fast_dct, False, bin_dct_descale, quality,
        )
        if restart_interval is not None:
            return out["payloads"], out["bits"]
        return out["payload"], out["total_bits"]

    def per_shard(batch, dc_luts, ac_luts):
        return jax.vmap(per_image)(batch, dc_luts, ac_luts)

    if mesh.devices.size == 1:
        return jax.jit(per_shard)  # see compiled_batch_encoder
    sharded = shard_map(
        per_shard,
        mesh=mesh,
        in_specs=(P(DATA_AXIS), P(DATA_AXIS), P(DATA_AXIS)),
        out_specs=(P(DATA_AXIS), P(DATA_AXIS)),
        check_vma=False,
    )
    return jax.jit(sharded)


def chunk_size_images(geom: FrameGeometry, n_dev: int) -> int:
    """Images per dispatch for this geometry: a static cap, mesh-multiple.

    Derived from chunk_input_budget() bytes of decoded input per device
    so one dispatch's device-resident footprint is bounded regardless of
    the dataset size; always at least one image per device.
    """
    per_image = geom.height * geom.width * 3
    per_dev = max(
        1, min(MAX_IMAGES_PER_DEVICE, chunk_input_budget() // per_image)
    )
    return per_dev * n_dev


def _dispatch_size(batch: int, n_dev: int, chunk: int) -> int:
    """Smallest n_dev * 2^k >= batch, capped at the chunk size.

    Dispatch shapes come from this ladder so any dataset compiles O(log)
    batch-program variants (the final partial chunk reuses a rung instead
    of minting a one-off shape).
    """
    size = n_dev
    while size < min(batch, chunk):
        size *= 2
    return min(size, chunk)


def shard_to_devices(images: np.ndarray, mesh: Mesh) -> jax.Array:
    """Host batch -> device array sharded over the mesh's batch axis.

    Each device receives exactly its own slice (no whole-batch staging on
    device 0 — the jnp.asarray pitfall); works for single- and
    multi-process meshes alike since every process only materializes its
    addressable shards.
    """
    sharding = NamedSharding(mesh, P(DATA_AXIS))
    return jax.make_array_from_callback(
        images.shape, sharding, lambda idx: images[idx]
    )


def encode_batch(
    images: np.ndarray,
    config: EncoderConfig,
    mesh: Mesh,
) -> list[bytes]:
    """Encode (B, H, W, 3) uint8 images -> list of B JFIF files.

    B is padded up to the dispatch-ladder size with blank images (their
    outputs are discarded), so any batch size works; batches beyond the
    geometry's chunk size run as several bounded dispatches.
    """
    if images.ndim != 4 or images.shape[3] != 3:
        raise ValueError("expected (B, H, W, 3) uint8 batch")
    batch, height, width = images.shape[:3]
    geom = config.geometry(width, height)
    if config.restart_interval is not None:
        pipeline.check_restart_geometry(geom)
    n_dev = mesh.devices.size
    chunk = chunk_size_images(geom, n_dev)
    # Optimized Huffman runs the batched two-pass program (stats shard_map
    # -> host table build -> vmapped-LUT encode); fixed tables the
    # single-pass one. Both are chunk-bounded.
    encode_one_chunk = (
        _encode_chunk_optimized if config.optimize_huffman else _encode_chunk
    )
    files: list[bytes] = []
    for start in range(0, batch, chunk):
        files.extend(
            encode_one_chunk(
                images[start : start + chunk], config, mesh, geom
            )
        )
    return files


def chunk_capacity_bytes(config: EncoderConfig, geom: FrameGeometry) -> int:
    """The batch dispatch's shared initial capacity for this config."""
    if config.restart_interval is not None:
        return pipeline.restart_default_capacity_bytes(
            geom, config.restart_interval, config.capacity_bytes_per_pixel
        )
    return pipeline.default_capacity_bytes(
        geom, config.capacity_bytes_per_pixel
    )


def dispatch_chunk(
    images: np.ndarray,
    config: EncoderConfig,
    mesh: Mesh,
    geom: FrameGeometry,
    capacity: int,
) -> tuple[jax.Array, jax.Array]:
    """Pad to the ladder size, shard to devices, enqueue the encode.

    Returns DEVICE arrays (payloads, bit lengths) — the dispatch is
    asynchronous, so the caller can overlap further work (the streaming
    engine decodes chunk k+1 and writes chunk k-1 while this one runs)
    and fetch/assemble later via fetch_chunk + assemble_chunk.
    """
    batch, height, width = images.shape[:3]
    n_dev = mesh.devices.size
    padded_batch = _dispatch_size(batch, n_dev, chunk_size_images(geom, n_dev))
    if padded_batch != batch:
        pad = np.zeros((padded_batch - batch, height, width, 3), np.uint8)
        images = np.concatenate([images, pad])
    device_images = shard_to_devices(images, mesh)
    encoder = compiled_batch_encoder(
        mesh, geom, config.dct_algorithm, capacity, config.fast_dct,
        config.bin_dct_descale, config.quality, config.restart_interval,
    )
    return encoder(device_images)


def fetch_chunk(
    payloads: jax.Array, bit_lengths: jax.Array, capacity: int
) -> tuple[np.ndarray, np.ndarray]:
    """Device results -> host arrays, prefix-sliced ON DEVICE first.

    The capacity rectangle is ~5x the real payloads — slice to the
    longest payload's byte count before fetching.
    """
    bits_np = np.asarray(bit_lengths)
    max_bytes = pipeline.bucket_fetch_bytes(
        (int(bits_np.max()) + 7) // 8, capacity
    )
    return np.asarray(payloads[..., :max_bytes]), bits_np


def assemble_chunk(
    images: np.ndarray,
    config: EncoderConfig,
    geom: FrameGeometry,
    capacity: int,
    payloads: np.ndarray,
    bit_lengths: np.ndarray,
) -> list[bytes]:
    """Host-side file assembly for one chunk's fetched results.

    `images` are the chunk's REAL members (unpadded; row i retried alone
    through the single-image path if its bits overflowed `capacity`).
    """
    batch = images.shape[0]
    restart = config.restart_interval
    files = []
    if restart is not None:
        for i in range(batch):
            bits_i = bit_lengths[i]
            if int(bits_i.max()) > 8 * capacity:
                # Per-image retry through the single-image restart path
                # (identical program semantics), starting past the rung
                # that just overflowed.
                files.append(
                    pipeline.encode_array(
                        np.asarray(images[i]), config,
                        _initial_capacity_bytes=(
                            pipeline.restart_next_capacity_bytes(
                                geom, restart, capacity
                            )
                        ),
                    ).file_bytes
                )
                continue
            files.append(jfif.assemble_restart(
                geom, payloads[i], [int(b) for b in bits_i], restart,
                quality=config.quality,
            ))
        return files
    header = jfif.header_bytes(geom, config.quality)
    for i in range(batch):
        bits = int(bit_lengths[i])
        if bits > 8 * capacity:
            # This image overflowed the shared capacity estimate. Re-encode
            # only it through the single-image path (same program semantics,
            # so the payload is byte-identical), starting at the next
            # capacity rung. Re-running the whole batch at 8x capacity would
            # inflate every member's buffer for one pathological image.
            result = pipeline.encode_array(
                np.asarray(images[i]), config,
                _initial_capacity_bytes=pipeline.next_capacity_bytes(
                    geom, capacity
                ),
            )
            files.append(result.file_bytes)
            continue
        nbytes = (bits + 7) // 8
        scan = jfif.stuff_bytes(payloads[i, :nbytes])
        files.append(header + scan + jfif.EOI)
    return files


def _encode_chunk(
    images: np.ndarray,
    config: EncoderConfig,
    mesh: Mesh,
    geom: FrameGeometry,
) -> list[bytes]:
    """One bounded dispatch, synchronously: dispatch -> fetch -> assemble."""
    capacity = chunk_capacity_bytes(config, geom)
    payloads, bits = dispatch_chunk(images, config, mesh, geom, capacity)
    payloads_np, bits_np = fetch_chunk(payloads, bits, capacity)
    return assemble_chunk(images, config, geom, capacity, payloads_np, bits_np)


def _encode_chunk_optimized(
    images: np.ndarray,
    config: EncoderConfig,
    mesh: Mesh,
    geom: FrameGeometry,
) -> list[bytes]:
    """One bounded optimized-Huffman dispatch: the batched two-pass form.

    Pass 1 histograms every chunk member's scan symbols in one shard_map
    dispatch; the host builds each image's optimal canonical tables
    (pipeline.optimal_specs_and_luts); pass 2 encodes the whole chunk
    with the per-image packed LUTs sharded along the batch axis as traced
    operands, so batch+optimize is not a sequential per-image loop.
    """
    batch = images.shape[0]
    capacity = chunk_capacity_bytes(config, geom)
    device_images, hists_dev = dispatch_optimized_stats(
        images, config, mesh, geom
    )
    specs_list, dc_luts, ac_luts = build_chunk_luts(
        np.asarray(hists_dev), batch
    )
    payloads, bits = dispatch_optimized_encode(
        device_images, dc_luts, ac_luts, config, mesh, geom, capacity
    )
    payloads_np, bits_np = fetch_chunk(payloads, bits, capacity)
    return assemble_chunk_optimized(
        images, config, geom, capacity, payloads_np, bits_np, specs_list
    )


def dispatch_optimized_stats(
    images: np.ndarray,
    config: EncoderConfig,
    mesh: Mesh,
    geom: FrameGeometry,
) -> tuple[jax.Array, jax.Array]:
    """Pad + shard one optimize chunk and enqueue its statistics pass.

    Returns (device_images, hists) — both asynchronous, so the caller can
    keep later chunks' stats in flight while earlier chunks build tables
    and encode (the streaming engine's software pipeline).
    """
    batch, height, width = images.shape[:3]
    n_dev = mesh.devices.size
    padded_batch = _dispatch_size(batch, n_dev, chunk_size_images(geom, n_dev))
    if padded_batch != batch:
        pad = np.zeros((padded_batch - batch, height, width, 3), np.uint8)
        images = np.concatenate([images, pad])
    device_images = shard_to_devices(images, mesh)
    hists = compiled_batch_stats_encoder(
        mesh, geom, config.dct_algorithm, config.fast_dct,
        config.bin_dct_descale, config.quality, config.restart_interval,
    )(device_images)
    return device_images, hists


def dispatch_optimized_encode(
    device_images: jax.Array,
    dc_luts: np.ndarray,
    ac_luts: np.ndarray,
    config: EncoderConfig,
    mesh: Mesh,
    geom: FrameGeometry,
    capacity: int,
) -> tuple[jax.Array, jax.Array]:
    """Enqueue the vmapped-LUT encode pass for an already-sharded chunk."""
    return compiled_batch_custom_encoder(
        mesh, geom, config.dct_algorithm, capacity, config.restart_interval,
        config.fast_dct, config.bin_dct_descale, config.quality,
    )(
        device_images,
        shard_to_devices(dc_luts, mesh),
        shard_to_devices(ac_luts, mesh),
    )


def build_chunk_luts(
    hists: np.ndarray, batch: int
) -> tuple[list, np.ndarray, np.ndarray]:
    """(padded_B, 4, 256) histograms -> (specs per REAL member, LUT arrays).

    Padding rows' outputs are discarded; they reuse member 0's tables
    rather than building throwaway specs for blank images (which bits
    they emit is irrelevant — they only need in-range gather indices).
    """
    padded_batch = hists.shape[0]
    specs_list = []
    dc_luts = np.empty((padded_batch, 2, 256), np.int32)
    ac_luts = np.empty((padded_batch, 2, 256), np.int32)
    for i in range(batch):
        specs, dc, ac = pipeline.optimal_specs_and_luts(hists[i])
        specs_list.append(specs)
        dc_luts[i] = np.asarray(dc)
        ac_luts[i] = np.asarray(ac)
    dc_luts[batch:] = dc_luts[0]
    ac_luts[batch:] = ac_luts[0]
    return specs_list, dc_luts, ac_luts


def assemble_chunk_optimized(
    images: np.ndarray,
    config: EncoderConfig,
    geom: FrameGeometry,
    capacity: int,
    payloads_np: np.ndarray,
    bits_np: np.ndarray,
    specs_list: list,
) -> list[bytes]:
    """Host assembly for one optimized chunk (per-image DHT specs)."""
    batch = images.shape[0]
    restart = config.restart_interval
    files = []
    for i in range(batch):
        bits_i = bits_np[i]
        over = (
            int(bits_i.max()) if restart is not None else int(bits_i)
        ) > 8 * capacity
        if over:
            # Rare overflow: re-run this member alone through the
            # single-image optimized two-pass (its own capacity ladder).
            files.append(
                pipeline.encode_array(np.asarray(images[i]), config)
                .file_bytes
            )
            continue
        if restart is not None:
            files.append(pipeline.restart_result(
                geom, list(payloads_np[i]), [int(b) for b in bits_i],
                restart, config.quality, dht_specs=specs_list[i],
            ).file_bytes)
        else:
            nbytes = (int(bits_i) + 7) // 8
            files.append(jfif.assemble(
                geom, payloads_np[i, :nbytes].tobytes(),
                quality=config.quality, dht_specs=specs_list[i],
            ))
    return files
