"""RGB -> YCbCr color conversion (BT.601 / JFIF constants).

One vectorized elementwise pass over the whole image, fused by XLA with the
surrounding pad/reshape, instead of the reference's per-pixel scalar loop
(colorspace.rs:5-15, jpeg_image.rs:121-134).

Numerics contract: float32 with per-operation rounding and the same
association order as the reference, final cast truncating toward zero with
saturation (Rust `as u8`).

The per-operation rounding is load-bearing: contracting `a * b + c` into
an FMA merges two roundings into one and flips pixels whose exact value
lands on a rounding tie (e.g. RGB (1, 233, 245): the reference's f32 chain
hits the exact tie 164.99999237 and rounds-to-even to 165.0; the FMA's
exact product steers it to 164.99998 — truncating to 164). Rust never
contracts (LLVM default fp-contract=off), so the oracle is ground truth.

XLA:CPU forms such FMAs (a plain multiply chain flipped ~3.5k of the 2^24
triples by one), so the traced program contains no multiplication at all:
each per-channel PRODUCT comes from a precomputed 256-entry f32 table
(NumPy computes the exact per-op-rounded values host-side), and an add
chain has no multiply to contract with. Verified exhaustively against the
oracle over all 2^24 RGB triples on the CPU backend
(tests/test_ops.py::test_color_exhaustive_cpu) and on an NVIDIA H100
(chip_smoke.py, colour phase: 0 mismatches).
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np

_F = jnp.float32
_F32 = np.float32


@functools.cache
def _channel_luts() -> tuple[np.ndarray, ...]:
    """Per-channel contribution tables, exactly per-op-rounded in f32.

    Each table entry is the f32 value the reference's scalar chain holds
    after the multiplications touching that channel (colorspace.rs:10-12):
    NumPy evaluates them elementwise with one rounding per operation and
    no contraction, so gather + add/sub reproduces the chain bit-exactly.
    """
    c = np.arange(256, dtype=_F32)
    y_r = _F32(0.299) * c
    y_g = _F32(0.587) * c
    y_b = _F32(0.114) * c
    cb_r = _F32(128.0) - _F32(0.168736) * c  # first two ops of the cb chain
    cb_g = _F32(0.331264) * c
    cb_b = _F32(0.5) * c
    cr_r = _F32(128.0) + _F32(0.5) * c
    cr_g = _F32(0.418688) * c
    cr_b = _F32(0.081312) * c
    return y_r, y_g, y_b, cb_r, cb_g, cb_b, cr_r, cr_g, cr_b


def _to_u8(x: jnp.ndarray) -> jnp.ndarray:
    return jnp.clip(jnp.trunc(x), 0.0, 255.0).astype(jnp.uint8)


def rgb_to_ycbcr(rgb: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """(..., 3) uint8 RGB -> three uint8 planes (y, cb, cr).

    Products come from tables, adds run in the traced program: nothing
    for an FMA to merge (see the module docstring).
    """
    y_r, y_g, y_b, cb_r, cb_g, cb_b, cr_r, cr_g, cr_b = (
        jnp.asarray(t) for t in _channel_luts()
    )
    r = rgb[..., 0].astype(jnp.int32)
    g = rgb[..., 1].astype(jnp.int32)
    b = rgb[..., 2].astype(jnp.int32)
    y = (y_r[r] + y_g[g]) + y_b[b]
    cb = (cb_r[r] - cb_g[g]) + cb_b[b]
    cr = (cr_r[r] - cr_g[g]) - cr_b[b]
    return _to_u8(y), _to_u8(cb), _to_u8(cr)


def ycbcr_to_rgb(y: jnp.ndarray, cb: jnp.ndarray, cr: jnp.ndarray) -> jnp.ndarray:
    """Inverse transform (colorspace.rs:17-27 equivalent), for round-trips."""
    yf = y.astype(_F)
    cbf = cb.astype(_F) - _F(128.0)
    crf = cr.astype(_F) - _F(128.0)
    r = yf + _F(1.402) * crf
    g = (yf - _F(0.344136) * cbf) - _F(0.714136) * crf
    b = yf + _F(1.772) * cbf
    rgb = jnp.stack([r, g, b], axis=-1)
    return jnp.clip(jnp.trunc(rgb), 0.0, 255.0).astype(jnp.uint8)
