"""Worker process for the 2-process multi-host integration test.

Launched by tests/test_multihost.py as a pair of real OS processes — this
is the only place `jax.distributed.initialize`, the `process_index()`
file striding, and the `global_summary` cross-process allgather
(parallel/multihost.py) execute with process_count > 1, which no
single-process test can reach.

Not a pytest module (no test_ prefix): invoked as
`python tests/multihost_worker.py <coordinator> <pid> <nproc> <src> <out>`.
"""

import json
import os
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)


def main() -> int:
    coordinator, pid, nproc, src_dir, out_dir = sys.argv[1:6]

    import jax

    # Same platform override as tests/conftest.py: the workers run on the
    # CPU whatever devices the machine has. Gloo drives the cross-process
    # CPU collectives.
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_cpu_collectives_implementation", "gloo")

    from jpeg_encoder_tpu import cli
    from jpeg_encoder_tpu.utils import compile_cache

    compile_cache.enable()
    from jpeg_encoder_tpu.config import EncoderConfig

    # Phase 1 drives the CLI's --dataset surface (the user-facing entry
    # for BASELINE config 5): rendezvous, strided shares, manifest,
    # cross-process summary — all through argument parsing, exactly as a
    # pod-slice user would invoke it.
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main([
            "--dataset", src_dir, "-o", out_dir, "-s", "4:2:0",
            "--coordinator", coordinator,
            "--process-id", pid, "--num-processes", nproc,
            "--timing",
        ])
    assert rc == 0, f"cli --dataset failed (rc={rc}):\n{buf.getvalue()}"
    cli_line = json.loads(buf.getvalue().strip().splitlines()[-1])
    idx, count = cli_line["process_index"], cli_line["process_count"]
    assert idx == int(pid), (idx, pid)
    assert count == int(nproc), (count, nproc)
    summary = cli_line["summary"]
    config = EncoderConfig(subsampling_ratio=(4, 2, 0))

    # Phase 2: ONE image's MCU bands sharded across the GLOBAL mesh (both
    # processes' devices): ppermute DC chaining and the replicated-output
    # payload gather cross the process boundary (DCN in production, gloo
    # here). 288 rows = 18 MCU rows over 4 devices: an UNEVEN split (5 per
    # band, last band partially dead), exercising live-entry masking too.
    import numpy as np

    from jpeg_encoder_tpu import pipeline
    from jpeg_encoder_tpu.parallel import mesh as mesh_lib
    from jpeg_encoder_tpu.parallel import tiled

    rng = np.random.default_rng(123)
    big = rng.integers(0, 256, size=(288, 32, 3), dtype=np.uint8)
    global_mesh = mesh_lib.data_mesh(devices=jax.devices())
    tiled_result = tiled.encode_tiled(big, config, global_mesh)
    local_single = pipeline.encode_array(big, config)
    assert tiled_result.file_bytes == local_single.file_bytes, (
        "cross-host tiled encode diverged from the local single encode"
    )

    # Phase 3: the same cross-host band shard with RESTART framing — no
    # DC ppermute, byte-aligned marker assembly; each band covers whole
    # 5-MCU intervals (band = 5 MCU rows x 2 cols = 10 MCUs). Must equal
    # the local single-device restart encode byte for byte.
    config_r = EncoderConfig(
        subsampling_ratio=(4, 2, 0), restart_interval=5
    )
    tiled_restart = tiled.encode_tiled(big, config_r, global_mesh)
    local_restart = pipeline.encode_array(big, config_r)
    assert tiled_restart.file_bytes == local_restart.file_bytes, (
        "cross-host restart-tiled encode diverged from the local encode"
    )

    # Phase 4: cross-host band shard with OPTIMIZED Huffman — the stats
    # psum rides the cross-process mesh and the shared tables go back in
    # as replicated GLOBAL operand arrays (the path a process-local array
    # cannot serve).
    config_o = EncoderConfig(
        subsampling_ratio=(4, 2, 0), optimize_huffman=True
    )
    tiled_opt = tiled.encode_tiled(big, config_o, global_mesh)
    local_opt = pipeline.encode_array(big, config_o)
    assert tiled_opt.file_bytes == local_opt.file_bytes, (
        "cross-host optimized-Huffman tiled encode diverged from the "
        "local encode"
    )

    with open(os.path.join(out_dir, f"result-{idx}.json"), "w") as f:
        json.dump(
            {
                "process_index": idx,
                "process_count": count,
                "local_devices": len(jax.local_devices()),
                "global_devices": len(jax.devices()),
                "encoded": cli_line["encoded"],
                "skipped": cli_line["skipped"],
                "manifest_path": cli_line["manifest"],
                "summary": summary,
                "tiled_bytes": len(tiled_result.file_bytes),
                "tiled_bits": int(tiled_result.bit_length),
                "tiled_restart_bytes": len(tiled_restart.file_bytes),
            },
            f,
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
