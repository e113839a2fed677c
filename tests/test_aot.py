"""AOT executable cache: byte-identity, artifact reuse, corruption recovery.

The cache exists to cut CLI warm starts; these tests pin its correctness
contract: an encode through a deserialized executable is byte-identical
to the plain jit path, and a damaged artifact can only cost a rebuild,
never a wrong file. Because the cache declines multi-device CPU hosts
(XLA:CPU AOT under device-count spoofing fails at run time), the load
path runs in fresh single-device CPU subprocesses — the same process
shape as a cold CLI start.
"""

import glob
import os
import subprocess
import sys

import numpy as np
import pytest

from jpeg_encoder_tpu import pipeline
from jpeg_encoder_tpu.config import EncoderConfig
from jpeg_encoder_tpu.utils import aot_cache

WORKER = os.path.join(os.path.dirname(__file__), "aot_worker.py")


def _run_worker(cache_dir, out_file):
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS", "PYTHONPATH")}
    subprocess.run(
        [sys.executable, WORKER, str(cache_dir), str(out_file)],
        check=True, env=env, timeout=240,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    )
    with open(out_file, "rb") as f:
        return f.read()


@pytest.mark.slow
def test_aot_roundtrip_reuse_and_recovery(tmp_path):
    """Build -> load -> corrupt -> rebuild, all byte-identical."""
    rng = np.random.default_rng(11)
    rgb = rng.integers(0, 256, (40, 56, 3), dtype=np.uint8)
    plain = pipeline.encode_array(rgb, EncoderConfig()).file_bytes

    built = _run_worker(tmp_path, tmp_path / "a.jpeg")
    assert built == plain
    [artifact] = glob.glob(str(tmp_path / "aot" / "exe_*.pkl"))
    mtime = os.path.getmtime(artifact)

    loaded = _run_worker(tmp_path, tmp_path / "b.jpeg")
    assert loaded == plain
    assert os.path.getmtime(artifact) == mtime  # reused, not rebuilt

    with open(artifact, "wb") as f:
        f.write(b"not a pickle")
    recovered = _run_worker(tmp_path, tmp_path / "c.jpeg")
    assert recovered == plain
    [artifact2] = glob.glob(str(tmp_path / "aot" / "exe_*.pkl"))
    assert os.path.getsize(artifact2) > 1024  # fresh serialization


def test_aot_declines_multi_device_cpu(tmp_path):
    """On the virtual 8-device mesh the cache must stand down cleanly."""
    aot_cache.enable(str(tmp_path))
    try:
        pipeline.compiled_encoder.cache_clear()
        rng = np.random.default_rng(11)
        rgb = rng.integers(0, 256, (40, 56, 3), dtype=np.uint8)
        result = pipeline.encode_array(rgb, EncoderConfig())
        assert result.file_bytes[:2] == b"\xff\xd8"
        assert glob.glob(str(tmp_path / "aot" / "exe_*.pkl")) == []
    finally:
        aot_cache.disable()
        pipeline.compiled_encoder.cache_clear()


def test_aot_disabled_by_env(tmp_path, monkeypatch):
    monkeypatch.setenv("JPEG_TPU_NO_AOT", "1")
    assert aot_cache.enable(str(tmp_path)) is None
    assert not aot_cache.enabled()


@pytest.mark.parametrize("env_set", [True, False])
def test_cache_root_rule(env_set, tmp_path, monkeypatch):
    """JAX_COMPILATION_CACHE_DIR when set, else the checkout's .jax_cache;
    the AOT artifacts live under the same root."""
    from jpeg_encoder_tpu.utils import compile_cache

    checkout = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if env_set:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        want = str(tmp_path)
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        want = os.path.join(checkout, ".jax_cache")
    monkeypatch.delenv("JPEG_TPU_NO_CACHE", raising=False)
    monkeypatch.delenv("JPEG_TPU_NO_AOT", raising=False)
    assert compile_cache.cache_dir() == want
    try:
        assert aot_cache.enable() == os.path.join(want, "aot")
    finally:
        aot_cache.disable()
