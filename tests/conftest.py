"""Test configuration: deterministic CPU backend with 8 virtual devices.

The suite runs on the CPU. Multi-device sharding tests run on a virtual
CPU mesh (the standard JAX pattern for testing shard_map layouts without
hardware); the GPU path is exercised by chip_smoke.py on the card. The
platform is forced through jax.config before any backend initializes.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from jpeg_encoder_tpu.utils import compile_cache  # noqa: E402

# Persistent compile cache (JAX_COMPILATION_CACHE_DIR, else the checkout's
# .jax_cache): the suite compiles ~25 pipeline variants; cold runs pay
# once, subsequent runs are seconds.
compile_cache.enable()

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng() -> np.random.Generator:
    return np.random.default_rng(0x5EED)
