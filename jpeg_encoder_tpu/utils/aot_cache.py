"""Ahead-of-time executable cache: sub-second warm starts for the CLI.

The persistent XLA compilation cache (utils/compile_cache.py) removes the
*compile* from a cold process, but the production path still pays
trace + lower + cache-deserialize + executable-load on every start.
Serializing the COMPILED executable via
jax.experimental.serialize_executable and reloading it in a fresh process
skips all of that but the load. The reference binary's startup is a
process exec (main.rs:8) — this is the closest a jit-compiled pipeline
gets to that UX.

Safety: artifacts are keyed by a sha256 over (package source fingerprint,
jax version, device platform+kind, the encoder's static config), so any
code or environment change misses and falls back to the normal jit path,
which then refreshes the artifact. Any load/deserialize failure does the
same — the cache can only ever cost one rebuild, never a wrong program.

Opt-in via enable() (the CLI calls it next to compile_cache.enable());
library/test callers that never enable it see pure jax.jit behavior.

Trust model: artifacts are pickled executables, so LOADING one executes
whatever the file deserializes to — the cache directory must be writable
only by the user running the CLI (it is created 0o700 below, and
JAX_COMPILATION_CACHE_DIR should never point at a shared/world-writable
path).
Corruption is recovered from; tampering is not defended against beyond
that permission boundary.
"""

from __future__ import annotations

import glob
import hashlib
import os
import pickle

_enabled = False
_dir: str | None = None
_fingerprint: str | None = None


def enable(cache_dir: str | None = None) -> str | None:
    """Turn on the AOT executable cache (idempotent).

    Artifacts go to <root>/aot, where root is the explicit argument or
    else compile_cache.cache_dir(). JPEG_TPU_NO_CACHE=1 or
    JPEG_TPU_NO_AOT=1 disables (returns None).
    """
    global _enabled, _dir
    if os.environ.get("JPEG_TPU_NO_CACHE") == "1":
        return None
    if os.environ.get("JPEG_TPU_NO_AOT") == "1":
        return None
    from jpeg_encoder_tpu.utils import compile_cache

    root = cache_dir or compile_cache.cache_dir()
    _dir = os.path.join(root, "aot")
    # 0o700: artifacts are pickles, so the dir must not be writable (or
    # readable, they encode local source) by other users. Applies only on
    # creation; pre-existing permissive dirs are the user's call.
    os.makedirs(_dir, mode=0o700, exist_ok=True)
    _enabled = True
    return _dir


def disable() -> None:
    """Turn the cache back off (tests; prod processes never need it)."""
    global _enabled, _dir
    _enabled = False
    _dir = None


def enabled() -> bool:
    return _enabled


def _package_fingerprint() -> str:
    """sha256 over every package source file (computed once per process).

    Covers .py sources and the native library sources — any edit changes
    the digest and invalidates every artifact, the same contract the
    persistent compile cache gets for free from hashing the HLO.
    """
    global _fingerprint
    if _fingerprint is not None:
        return _fingerprint
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    h = hashlib.sha256()
    paths = sorted(
        glob.glob(os.path.join(pkg, "**", "*.py"), recursive=True)
        + glob.glob(os.path.join(pkg, "native", "*.cpp"))
    )
    for path in paths:
        h.update(path.encode())
        with open(path, "rb") as f:
            h.update(f.read())
    _fingerprint = h.hexdigest()
    return _fingerprint


def _artifact_path(key: tuple) -> str:
    import jax

    dev = jax.local_devices()[0]
    h = hashlib.sha256()
    h.update(_package_fingerprint().encode())
    h.update(jax.__version__.encode())
    h.update(f"{dev.platform}/{dev.device_kind}".encode())
    h.update(repr(key).encode())
    return os.path.join(_dir, f"exe_{h.hexdigest()[:24]}.pkl")


def get_or_build(key: tuple, jitted, *example_args):
    """Return a loaded Compiled for `jitted`, from disk when possible.

    `key` must determine the traced program together with the example
    argument shapes. On a cache miss (or any artifact problem) the program
    is lowered + compiled here and the executable serialized back — the
    persistent compile cache still makes that rebuild cheap. Returns None
    when the cache is disabled (callers fall back to plain jit dispatch).
    """
    if not _enabled:
        return None
    import jax
    from jax.experimental import serialize_executable as se

    devices = jax.devices()
    if devices[0].platform == "cpu" and len(devices) > 1:
        # XLA:CPU executables deserialized under a forced multi-device
        # host (the virtual test mesh) fail at RUN time with missing
        # fusion symbols even when pinned to one device — verified, so
        # decline rather than risk it. Single-device CPU processes load
        # fine (tests/test_aot.py), and so do GPU processes with one
        # card or four (chip_smoke.py's AOT phases).
        return None

    path = _artifact_path(key)
    if os.path.exists(path):
        try:
            with open(path, "rb") as f:
                payload, in_tree, out_tree = pickle.load(f)
            # Pin the single-device program to the first LOCAL device —
            # the default spreads it over ALL devices, which breaks on
            # multi-device processes (the virtual 8-CPU test mesh), and
            # jax.devices()[0] is another process's device on multi-host.
            return se.deserialize_and_load(
                payload, in_tree, out_tree,
                execution_devices=[jax.local_devices()[0]],
            )
        except Exception:
            try:
                os.remove(path)  # corrupt/stale: rebuild below
            except OSError:
                pass  # another process raced on the same artifact
    compiled = jitted.lower(*example_args).compile()
    try:
        payload, in_tree, out_tree = se.serialize(compiled)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "wb") as f:
            pickle.dump((payload, in_tree, out_tree), f)
        os.replace(tmp, path)
    except Exception:
        pass  # not serializable here: still return the live executable
    return compiled
