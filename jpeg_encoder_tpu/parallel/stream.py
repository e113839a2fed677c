"""Overlapped file-to-file dataset encoding: decode | compute | write.

The reference's pipeline is file-to-file but strictly sequential
(main.rs:8-68: read BMP, compute, write). Run that way, BMP decode -> H2D
-> device compute -> D2H -> stuff -> write have zero overlap, and the host
legs serialize with the device. This engine runs the three legs
concurrently:

  loader thread   : BMP decode (native threaded loader) + sharded H2D of
                    chunk k+1  (parallel/batch.shard_to_devices)
  main thread     : asynchronous dispatch of chunk k's device program
                    (dispatch is enqueue-only; JAX returns immediately)
  writer thread   : D2H fetch (device-side prefix slice first), JFIF
                    assembly, 0xFF stuffing, file writes for chunk k-1

Bounded queues (depth 2) give backpressure, so host RSS and device memory
hold at most ~3 chunks regardless of dataset size; chunk sizes come from
parallel/batch.chunk_size_images (a per-device input-byte budget).

The optimized-Huffman two-pass mode rides the same pipeline: the loader
additionally enqueues each chunk's statistics pass right after decoding
it, so chunk k+1's stats run on device while the main thread builds
chunk k's tables (native K.2) and dispatches its encode.

Used by the --dataset CLI path (parallel/multihost.encode_dataset) and
the multi-image batch CLI; the plain encode_batch array API stays
synchronous for library callers.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time

import numpy as np

from jpeg_encoder_tpu.config import EncoderConfig
from jpeg_encoder_tpu.io import bmp
from jpeg_encoder_tpu.parallel import batch as batch_lib

_DONE = object()


@dataclasses.dataclass
class StreamStats:
    encoded: int = 0
    output_bytes: int = 0
    pixels: int = 0
    seconds: float = 0.0          # wall clock, files-on-disk to files-on-disk
    decode_seconds: float = 0.0   # loader-thread busy time (overlapped)
    write_seconds: float = 0.0    # writer-thread busy time (overlapped)


def _chunks(seq: list, size: int):
    for start in range(0, len(seq), size):
        yield seq[start : start + size]


def encode_paths(
    paths: list[str],
    config: EncoderConfig,
    mesh,
    emit,
) -> StreamStats:
    """Encode BMP files at `paths` through the overlapped pipeline.

    `emit(path, file_bytes)` is called once per input, from the writer
    thread, in path order within each dimension group (groups run in
    first-seen order) — callers write the output file and any manifest
    bookkeeping there; calls are serialized (single writer thread).

    Raises the first exception from any stage after unwinding the
    pipeline (no silent partial results; already-emitted files stand,
    which is what the manifest/resume contract wants).
    """
    t0 = time.perf_counter()
    # Group by dimensions (order-preserving): each group feeds one
    # compiled program shape.
    groups: dict[tuple[int, int], list[str]] = {}
    for path in paths:
        with open(path, "rb") as f:
            head = f.read(64)
        groups.setdefault(bmp.probe_dimensions(head), []).append(path)
    n_dev = mesh.devices.size
    optimize = config.optimize_huffman

    work: list[tuple[tuple[int, int], list[str]]] = []
    for (width, height), group in groups.items():
        geom = config.geometry(width, height)
        if config.restart_interval is not None:
            from jpeg_encoder_tpu import pipeline

            pipeline.check_restart_geometry(geom)
        chunk = batch_lib.chunk_size_images(geom, n_dev)
        for chunk_paths in _chunks(group, chunk):
            work.append(((width, height), chunk_paths))

    load_q: queue.Queue = queue.Queue(maxsize=2)
    write_q: queue.Queue = queue.Queue(maxsize=2)
    stats = StreamStats()
    errors: list[BaseException] = []
    stop = threading.Event()

    def loader():
        try:
            for (width, height), chunk_paths in work:
                if stop.is_set():
                    return
                t = time.perf_counter()
                images = bmp.read_batch(chunk_paths)
                stats.decode_seconds += time.perf_counter() - t
                if optimize:
                    # Enqueue the statistics pass HERE so chunk k+1's
                    # stats are in flight while the main thread builds
                    # chunk k's tables and dispatches its encode (the
                    # two-pass mode's software pipeline).
                    geom = config.geometry(width, height)
                    dev_images, hists = batch_lib.dispatch_optimized_stats(
                        images, config, mesh, geom
                    )
                    load_q.put(
                        ((width, height), chunk_paths, images, dev_images,
                         hists)
                    )
                else:
                    load_q.put(
                        ((width, height), chunk_paths, images, None, None)
                    )
        except BaseException as e:  # propagate to the main thread
            errors.append(e)
        finally:
            load_q.put(_DONE)

    def writer():
        try:
            while True:
                item = write_q.get()
                if item is _DONE:
                    return
                (chunk_paths, images, geom, capacity, payloads, bits,
                 specs_list) = item
                t = time.perf_counter()
                payloads_np, bits_np = batch_lib.fetch_chunk(
                    payloads, bits, capacity
                )
                if specs_list is None:
                    files = batch_lib.assemble_chunk(
                        images, config, geom, capacity, payloads_np, bits_np
                    )
                else:
                    files = batch_lib.assemble_chunk_optimized(
                        images, config, geom, capacity, payloads_np,
                        bits_np, specs_list,
                    )
                for path, data in zip(chunk_paths, files):
                    emit(path, data)
                    stats.encoded += 1
                    stats.output_bytes += len(data)
                    stats.pixels += geom.width * geom.height
                stats.write_seconds += time.perf_counter() - t
        except BaseException as e:
            errors.append(e)
            stop.set()
            # Drain so the dispatcher's put() never deadlocks.
            while True:
                if write_q.get() is _DONE:
                    return

    lt = threading.Thread(target=loader, name="jpeg-tpu-loader")
    wt = threading.Thread(target=writer, name="jpeg-tpu-writer")
    lt.start()
    wt.start()
    loader_done = False
    try:
        while True:
            item = load_q.get()
            if item is _DONE:
                loader_done = True
                break
            (width, height), chunk_paths, images, dev_images, hists = item
            if stop.is_set():
                continue  # drain after a writer error
            geom = config.geometry(width, height)
            capacity = batch_lib.chunk_capacity_bytes(config, geom)
            if optimize:
                specs_list, dc_luts, ac_luts = batch_lib.build_chunk_luts(
                    np.asarray(hists), images.shape[0]
                )
                payloads, bits = batch_lib.dispatch_optimized_encode(
                    dev_images, dc_luts, ac_luts, config, mesh, geom,
                    capacity,
                )
            else:
                specs_list = None
                payloads, bits = batch_lib.dispatch_chunk(
                    images, config, mesh, geom, capacity
                )
            write_q.put(
                (chunk_paths, images, geom, capacity, payloads, bits,
                 specs_list)
            )
    finally:
        stop.set()
        # Unblock a loader stuck on a full queue before joining it (the
        # error paths leave the stream mid-flight).
        while not loader_done:
            if load_q.get() is _DONE:
                loader_done = True
        write_q.put(_DONE)
        wt.join()
        lt.join()
    if errors:
        raise errors[0]
    stats.seconds = time.perf_counter() - t0
    return stats
