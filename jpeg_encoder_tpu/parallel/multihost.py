"""Multi-host dataset encoding: shard a file list across processes.

The reference is a single-process CLI (main.rs); this build's scale-out
story for the "1000x 4K across >= 2 hosts" configuration (BASELINE.json
config 5) is deliberately simple, following the batch-parallel mapping in
SURVEY.md section 2:

* `initialize()` wraps jax.distributed.initialize — after it, jax.devices()
  spans every process's devices and every parallel/ helper works unchanged;
* each process takes a strided slice of the file list (no coordination:
  whole images are independent), and pushes it through the overlapped
  decode | compute | write engine (parallel/stream.py) over its *local*
  devices — chunked, memory-bounded dispatches of the shard_map batch
  encoder, with BMP decode and file writes running concurrently with the
  device;
* every process writes its outputs plus a JSON manifest. Reruns skip files
  whose outputs the manifest already records (the checkpoint/resume
  equivalent for a batch tool — SURVEY.md section 5), so a failed host can
  simply be restarted;
* the only cross-host traffic is the optional final byte-count summary
  (a process_allgather over a few integers).

Single-process (or single-device) use degrades gracefully: the same code
encodes everything locally.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time

import numpy as np

from jpeg_encoder_tpu.config import EncoderConfig
from jpeg_encoder_tpu.parallel import mesh as mesh_lib
from jpeg_encoder_tpu.parallel import stream


def initialize(**kwargs) -> tuple[int, int]:
    """jax.distributed.initialize when launched multi-process; else no-op.

    Returns (process_index, process_count).
    """
    import jax

    if kwargs.get("coordinator_address") or os.environ.get(
        "JAX_COORDINATOR_ADDRESS"
    ):
        jax.distributed.initialize(**kwargs)
    return jax.process_index(), jax.process_count()


@dataclasses.dataclass
class DatasetResult:
    encoded: int
    skipped: int
    output_bytes: int
    manifest_path: str
    pixels: int = 0            # pixels encoded this run (not skipped ones)
    seconds: float = 0.0       # file-to-file wall clock of the encode loop
    decode_seconds: float = 0.0  # loader-thread busy time (overlapped)
    write_seconds: float = 0.0   # writer-thread busy time (overlapped)


def _manifest_path(out_dir: str, process_index: int) -> str:
    return os.path.join(out_dir, f"manifest-{process_index:05d}.json")


def _load_manifest(path: str) -> dict:
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return {"files": {}}


def encode_dataset(
    paths: list,
    out_dir: str,
    config: EncoderConfig = EncoderConfig(),
    local_mesh=None,
    resume: bool = True,
) -> DatasetResult:
    """Encode this process's share of `paths` into out_dir.

    Files are assigned round-robin by process index (strided), grouped by
    dimensions, and batch-encoded over the process's local devices. A
    manifest records every completed file with its output size; with
    `resume`, files already in the manifest (and present on disk) are
    skipped.
    """
    import jax

    os.makedirs(out_dir, exist_ok=True)
    pidx, pcount = jax.process_index(), jax.process_count()
    mine = [str(p) for p in paths][pidx::pcount]

    manifest_file = _manifest_path(out_dir, pidx)
    manifest = _load_manifest(manifest_file)
    done = manifest["files"]

    def out_name(path: str) -> str:
        return os.path.splitext(os.path.basename(path))[0] + ".jpeg"

    todo = []
    skipped = 0
    for path in mine:
        name = out_name(path)
        if (
            resume
            and name in done
            and os.path.exists(os.path.join(out_dir, name))
        ):
            skipped += 1
        else:
            todo.append(path)

    if local_mesh is None:
        local_mesh = mesh_lib.data_mesh(devices=jax.local_devices())

    def persist_manifest():
        manifest["updated"] = time.time()
        with open(manifest_file, "w") as f:
            json.dump(manifest, f, indent=1)

    emitted = 0

    def emit(path: str, data: bytes):
        nonlocal emitted
        name = out_name(path)
        with open(os.path.join(out_dir, name), "wb") as f:
            f.write(data)
        done[name] = {"bytes": len(data), "source": path}
        emitted += 1
        # Persist periodically so a crash loses at most ~one chunk's worth
        # of bookkeeping (the files themselves are already on disk and the
        # next run re-records any the manifest missed by re-encoding them).
        if emitted % 32 == 0:
            persist_manifest()

    try:
        stats = stream.encode_paths(todo, config, local_mesh, emit)
    finally:
        persist_manifest()

    return DatasetResult(
        encoded=stats.encoded,
        skipped=skipped,
        output_bytes=stats.output_bytes,
        manifest_path=manifest_file,
        pixels=stats.pixels,
        seconds=stats.seconds,
        decode_seconds=stats.decode_seconds,
        write_seconds=stats.write_seconds,
    )


def global_summary(result: DatasetResult) -> dict:
    """Aggregate per-host results over DCN; single-process returns as-is."""
    import jax

    if jax.process_count() == 1:
        return {
            "processes": 1,
            "encoded": result.encoded,
            "skipped": result.skipped,
            "output_bytes": result.output_bytes,
        }
    from jax.experimental import multihost_utils

    agg = multihost_utils.process_allgather(
        np.array(
            [result.encoded, result.skipped, result.output_bytes], np.int64
        )
    )
    return {
        "processes": int(jax.process_count()),
        "encoded": int(agg[:, 0].sum()),
        "skipped": int(agg[:, 1].sum()),
        "output_bytes": int(agg[:, 2].sum()),
    }
