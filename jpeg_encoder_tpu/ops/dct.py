"""Forward 8x8 DCT variants + quantization over block batches.

The separable 2-D DCT of an 8x8 block is a single 64x64 matmul over the
flattened block,

    coeff[uv] = sum_xy  shifted[xy] * (scale[u,v] * B[u,x] * B[v,y])

i.e. the Kronecker product of the 1-D cosine basis with the alpha
normalization folded in. A batch of blocks is then one (N, 64) @ (64, 64)
f32 matmul, replacing the reference's per-block quadruple loop with 8,192
cosine evaluations (dct_quant.rs:189-234). The basis matrix is a
compile-time constant built with the reference's exact f32 cosine
arguments, so only the accumulation order differs from the scalar loop:
that is the `--fast-dct` mode. The default is the ordered chain
(real_dct_quant_ordered), which keeps the reference's accumulation order
and is bit-exact.

The binDCT path (dct_quant.rs:67-187, after the Tran intDCT paper's
binDCT-C) is integer shift/add lifting, vectorized over the whole block
batch at once. The reference's omission of output de-scaling is
reproduced (coefficient parity beats spec fidelity for this port target).

Two compiler rewrites would break bit parity, and the code here is shaped
so that neither can apply:

* The quotient by the quantization step must be the correctly rounded
  f32 quotient before truncation. The GPU backend divides approximately,
  and XLA replaces a division by a constant with a multiplication by the
  rounded reciprocal; either moved RealDCT coefficients one step (4 in
  6.7e7 on an H100 before the fix). _quant_divide corrects the backend's
  quotient with exact integer-valued comparisons.
* XLA:CPU contracts `acc + p * b` into one FMA, which rounds once where
  the reference rounds twice (10 coefficients in 4.2e6 moved). The
  ordered chain adds each product through a select
  (real_dct_quant_ordered), which no backend contracts across.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from jpeg_encoder_tpu.config import DctAlgorithm

_F32 = np.float32
# Above any partial sum of the ordered chain (see real_dct_quant_ordered).
_ACC_BOUND = _F32(2.0**20)


@functools.cache
def dct_basis_f32() -> np.ndarray:
    """B[u, x] = f32 cos(((2x+1) * u) * pi_f32 / 16), correctly rounded."""
    u = np.arange(8, dtype=np.int64)[:, None]
    x = np.arange(8, dtype=np.int64)[None, :]
    arg = ((2 * x + 1) * u).astype(_F32) * _F32(np.pi) / _F32(16.0)
    return np.cos(arg.astype(np.float64)).astype(_F32)


@functools.cache
def dct_kron_matrix() -> np.ndarray:
    """K[xy, uv] = scale[u,v] * B[u,x] * B[v,y] as (64, 64) f32.

    Per-entry products are computed with the reference's f32 association
    ((0.25 * alpha_u) * alpha_v, then the two cosines) so the only numeric
    difference vs the scalar loop is summation order.
    """
    basis = dct_basis_f32()
    inv_sqrt2 = _F32(1.0) / _F32(np.sqrt(2.0))
    alpha = np.where(np.arange(8) == 0, inv_sqrt2, _F32(1.0)).astype(_F32)
    scale = (_F32(0.25) * alpha[:, None]) * alpha[None, :]  # (u, v)
    # K[(x*8+y), (u*8+v)]
    k = np.einsum(
        "uv,ux,vy->xyuv", scale, basis, basis, dtype=np.float64
    ).astype(_F32)
    return k.reshape(64, 64)


def level_shift(blocks_u8: jnp.ndarray) -> jnp.ndarray:
    """uint8 -> int16 centered at 0 (dct_shift_range, dct_quant.rs:63-65)."""
    return blocks_u8.astype(jnp.int16) - 128


def _trunc_div_int(values: jnp.ndarray, divisor: jnp.ndarray) -> jnp.ndarray:
    """Integer division truncating toward zero (Rust `/` semantics)."""
    return jnp.sign(values) * (jnp.abs(values) // divisor)


def _pow2(exponent: jnp.ndarray) -> jnp.ndarray:
    """2.0 ** exponent as f32 for int32 exponents in the normal range."""
    return jax.lax.bitcast_convert_type(
        (exponent + 127) << 23, jnp.float32
    )


def _quant_divide(values: jnp.ndarray, q_rows: jnp.ndarray) -> jnp.ndarray:
    """trunc(values / q_rows) for f32 values, with the quotient rounded to
    f32 first exactly as an IEEE division rounds it (Rust `(x / q) as i16`).

    q_rows holds positive integers (quantization steps). The backend's
    division is only a first guess: the GPU backend divides approximately
    (about a quarter of f32 quotients differ in the last bits), and XLA
    replaces a division by a constant with a multiplication by the rounded
    reciprocal on every backend. The guess is then made exact with exact
    operations only: t = floor(|x| / q) is corrected by comparing |x|
    with the integer products q * t and q * (t + 1), which are exact in
    f32 while they stay below 2^24; the correctly rounded quotient reaches
    t + 1 exactly when |x| lies within half a float spacing (just below
    t + 1, scaled by q) of q * (t + 1), ties rounding up to the even
    integer. Every product and difference involved is exact, so the
    result does not depend on how a backend rounds or contracts them.
    """
    a = jnp.abs(values)
    t = jnp.floor(a / q_rows)
    t = jnp.where(
        q_rows * (t + 1) <= a, t + 1, jnp.where(q_rows * t > a, t - 1, t)
    )
    ti = t.astype(jnp.int32)
    # Exponent of the float spacing just below the integer t + 1.
    below = jnp.where(ti > 0, 31 - jax.lax.clz(ti), -1) - 23
    half_gap = q_rows * _pow2(below - 1)
    rounds_up = q_rows * (t + 1) - a <= half_gap
    return jnp.sign(values) * (t + rounds_up)


def _default_q_rows(quant: np.ndarray, zigzag_out: bool) -> jnp.ndarray:
    """(1, 64) f32 quant row, zigzag-permuted when the outputs are."""
    q = quant.reshape(64).astype(np.float32)
    if zigzag_out:
        from jpeg_encoder_tpu import tables

        q = q[tables.ZIGZAG_ORDER]
    return jnp.asarray(q)[None, :]


def real_dct_quant(
    blocks_u8: jnp.ndarray, quant: np.ndarray, zigzag_out: bool = False,
    q_rows: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """(N, 64) uint8 blocks -> (N, 64) int16 quantized coefficients.

    Level shift, 64x64 Kronecker-basis matmul (f32, HIGHEST precision so the
    product is not computed in a reduced-precision format such as TF32),
    f32 divide by the quant table, truncate toward zero.
    """
    shifted = level_shift(blocks_u8).astype(jnp.float32)
    k = dct_kron_matrix()
    if zigzag_out:
        from jpeg_encoder_tpu import tables

        k = k[:, tables.ZIGZAG_ORDER]
    if q_rows is None:
        q_rows = _default_q_rows(quant, zigzag_out)
    coeffs = jnp.dot(
        shifted, jnp.asarray(k),
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    return _quant_divide(coeffs, q_rows).astype(jnp.int16)


def dct_quantize_planes(
    y_blocks: jnp.ndarray,
    cb_blocks: jnp.ndarray,
    cr_blocks: jnp.ndarray,
    algorithm: DctAlgorithm,
    fast_dct: bool = False,
    zigzag_out: bool = False,
    bin_dct_descale: bool = False,
    quality: int | None = None,
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """All three planes through ONE transform chain (one fusion instead of
    three).

    The quantization table is the only per-plane difference, and it is
    elementwise: select the luma/chroma row per block row (Annex-K, or
    quality-scaled when `quality` is set). The per-lane arithmetic is
    identical to the per-plane calls (bit-exact).

    RealDCT default is the ordered chain (reference accumulation order).
    Returns (y, cb, cr).
    """
    from jpeg_encoder_tpu import tables

    q_luma, q_chroma = tables.scaled_quant_tables(quality)
    ny, nc = y_blocks.shape[0], cb_blocks.shape[0]
    allb = jnp.concatenate([y_blocks, cb_blocks, cr_blocks], axis=0)
    is_y = (jnp.arange(allb.shape[0]) < ny)[:, None]

    def per_row_q(qy: np.ndarray, qc: np.ndarray, dtype) -> jnp.ndarray:
        qy = qy.reshape(64).astype(dtype)
        qc = qc.reshape(64).astype(dtype)
        if zigzag_out and algorithm == DctAlgorithm.REAL_DCT:
            qy = qy[tables.ZIGZAG_ORDER]
            qc = qc[tables.ZIGZAG_ORDER]
        return jnp.where(is_y, jnp.asarray(qy)[None, :], jnp.asarray(qc)[None, :])

    if algorithm == DctAlgorithm.REAL_DCT:
        q = per_row_q(q_luma, q_chroma, np.float32)
        if fast_dct:
            out = real_dct_quant(allb, quant=None, zigzag_out=zigzag_out,
                                 q_rows=q)
        else:
            out = real_dct_quant_ordered(allb, quant=None,
                                         zigzag_out=zigzag_out, q_rows=q)
    elif bin_dct_descale:
        q = per_row_q(q_luma, q_chroma, np.float32)
        s = jnp.asarray(bindct_descale_2d())[None, :]
        work = _bindct_transform(allb)
        out = _quant_divide(work.astype(jnp.float32) * s, q).astype(jnp.int16)
        if zigzag_out:
            out = out[:, tables.ZIGZAG_ORDER]
    else:
        q = per_row_q(q_luma, q_chroma, np.int32)
        work = _bindct_transform(allb)
        out = _trunc_div_int(work, q).astype(jnp.int16)
        if zigzag_out:
            out = out[:, tables.ZIGZAG_ORDER]
    return out[:ny], out[ny : ny + nc], out[ny + nc :]


def real_dct_quant_ordered(
    blocks_u8: jnp.ndarray, quant: np.ndarray, zigzag_out: bool = False,
    q_rows: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """Reference-parity RealDCT (the default path).

    64 f32 accumulation steps in (x, y) scan order with per-term association
    (px * cos_u) * cos_v — bit-identical quantized coefficients to
    dct_quant.rs:217-225 (verified against the oracle). XLA fuses the whole
    chain into one elementwise pass over the block batch (~192 flops per
    coefficient); the matmul variant above exists for when raw throughput
    matters more than the last ~1e-5 of coefficient parity.
    """
    # Flat (N, 64) formulation: step k = (x, y) contributes
    # (px * basis[u, x]) * basis[v, y] to every output lane uv — the
    # reference's association order.
    basis = dct_basis_f32()
    u_of = np.arange(64) // 8
    v_of = np.arange(64) % 8
    if zigzag_out:
        # Output lanes are independent, so permuting the per-lane constants
        # reorders the outputs with identical arithmetic (bit-exact).
        from jpeg_encoder_tpu import tables

        u_of = u_of[tables.ZIGZAG_ORDER]
        v_of = v_of[tables.ZIGZAG_ORDER]
    x_of = np.arange(64) // 8
    y_of = np.arange(64) % 8
    a_steps = jnp.asarray(basis[u_of[None, :], x_of[:, None]])  # (step, uv)
    b_steps = jnp.asarray(basis[v_of[None, :], y_of[:, None]])
    shifted = level_shift(blocks_u8).astype(jnp.float32).reshape(-1, 64)
    acc = jnp.zeros_like(shifted)
    for k in range(64):
        term = (shifted[:, k : k + 1] * a_steps[k : k + 1, :]) * (
            b_steps[k : k + 1, :]
        )
        # The select keeps the product a separately rounded value: a
        # backend that contracts mul + add into an FMA (XLA:CPU does)
        # cannot contract across it. It always picks the term, since each
        # |term| <= 128 keeps |acc| <= 8192. A select on the pixel instead
        # of on acc cost ~1.8x the whole 1080p encode on an H100.
        acc = acc + jnp.where(acc > _ACC_BOUND, 0.0, term)
    inv_sqrt2 = _F32(1.0) / _F32(np.sqrt(2.0))
    alpha = np.where(np.arange(8) == 0, inv_sqrt2, _F32(1.0)).astype(_F32)
    scale = ((_F32(0.25) * alpha[u_of]) * alpha[v_of]).astype(_F32)
    if q_rows is None:
        q_rows = _default_q_rows(quant, zigzag_out)
    coeffs = _quant_divide(jnp.asarray(scale)[None, :] * acc, q_rows)
    return coeffs.astype(jnp.int16)


def _bindct_lifting_1d(x: list[jnp.ndarray]) -> list[jnp.ndarray]:
    """8-point all-lifting binDCT-C pass over int32 lanes (natural-order out).

    Same shift/add network as the oracle (see oracle._bindct_lifting_1d and
    dct_quant.rs:84-129); jnp's >> on int32 is an arithmetic shift, matching
    Rust.
    """
    x0, x1, x2, x3, x4, x5, x6, x7 = x

    s7 = x0 - x7
    s0 = x0 - (s7 >> 1)
    s6 = x1 - x6
    s1 = x1 - (s6 >> 1)
    s5 = x2 - x5
    s2 = x2 - (s5 >> 1)
    s4 = x3 - x4
    s3 = x3 - (s4 >> 1)

    s6 = ((s5 * 3) >> 3) + s6
    s5 = ((s6 * 5) >> 3) - s5

    t0 = s0 + s3
    t3 = s0 - s3
    t1 = s1 + s2
    t2 = s1 - s2
    t4 = s4 + s5
    t5 = s4 - s5
    t6 = s7 - s6
    t7 = s7 + s6

    t4 = t4 - (t7 >> 3)
    t0 = t0 + t1
    t1 = -t1 + (t0 >> 1)
    t2 = t2 - ((t3 * 3) >> 3)
    t3 = t3 + ((t2 * 3) >> 3)
    t5 = t5 + ((t6 * 7) >> 3)
    t6 = t6 - (t5 >> 1)

    return [t0, t7, t3, t6, t1, t5, t2, t4]


@functools.cache
def bindct_descale_2d() -> np.ndarray:
    """(64,) f32 factors mapping raw binDCT outputs to true DCT coefficients.

    The reference never de-scales its lifting outputs before quantization
    (dct_quant.rs:182-186) — the acknowledged "weird line patterns" bug
    (jpeg_theory.md:145-147). The fix: linearize the lifting network
    (shift -> exact division), fit each output row to its cosine-basis row
    by least squares to get the per-frequency gain g_u (negative where the
    network flips the sign), and fold the 2-D correction
    0.25 * alpha_u * alpha_v / (g_u * g_v) into the quantization step, so
    out[u,v] * factor ~= the normalized DCT-II coefficient the Annex-K
    tables were designed for.
    """
    def lift(x):
        x0, x1, x2, x3, x4, x5, x6, x7 = x
        s7 = x0 - x7
        s0 = x0 - s7 / 2
        s6 = x1 - x6
        s1 = x1 - s6 / 2
        s5 = x2 - x5
        s2 = x2 - s5 / 2
        s4 = x3 - x4
        s3 = x3 - s4 / 2
        s6 = (s5 * 3) / 8 + s6
        s5 = (s6 * 5) / 8 - s5
        t0 = s0 + s3
        t3 = s0 - s3
        t1 = s1 + s2
        t2 = s1 - s2
        t4 = s4 + s5
        t5 = s4 - s5
        t6 = s7 - s6
        t7 = s7 + s6
        t4 = t4 - t7 / 8
        t0 = t0 + t1
        t1 = -t1 + t0 / 2
        t2 = t2 - (t3 * 3) / 8
        t3 = t3 + (t2 * 3) / 8
        t5 = t5 + (t6 * 7) / 8
        t6 = t6 - t5 / 2
        return [t0, t7, t3, t6, t1, t5, t2, t4]

    t = np.zeros((8, 8))
    for i in range(8):
        e = [0.0] * 8
        e[i] = 1.0
        t[:, i] = lift(e)
    u = np.arange(8)[:, None]
    x = np.arange(8)[None, :]
    braw = np.cos((2 * x + 1) * u * np.pi / 16)
    gains = np.array(
        [(t[r] @ braw[r]) / (braw[r] @ braw[r]) for r in range(8)]
    )
    alpha = np.where(np.arange(8) == 0, 1.0 / np.sqrt(2.0), 1.0)
    per_axis = 0.5 * alpha / gains  # sqrt of the 2-D 0.25 normalization
    return (per_axis[:, None] * per_axis[None, :]).reshape(64).astype(_F32)


def _bindct_transform(blocks_u8: jnp.ndarray) -> jnp.ndarray:
    """(N, 64) uint8 -> (N, 64) int32 un-quantized binDCT coefficients."""
    work = blocks_u8.astype(jnp.int32).reshape(-1, 8, 8) - 128
    rows = _bindct_lifting_1d([work[:, :, i] for i in range(8)])
    work = jnp.stack(rows, axis=2)
    cols = _bindct_lifting_1d([work[:, i, :] for i in range(8)])
    return jnp.stack(cols, axis=1).reshape(-1, 64)


def bin_dct_quant(
    blocks_u8: jnp.ndarray, quant: np.ndarray, descale: bool = False
) -> jnp.ndarray:
    """(N, 64) uint8 blocks -> (N, 64) int16 quantized binDCT coefficients.

    descale=False reproduces the reference's bug-parity path (raw lifting
    outputs divided by the Annex-K table); descale=True folds the lifting
    network's diagonal gains into the quantization (bindct_descale_2d) so
    the output approximates a properly normalized DCT — the corrected
    binDCT-C the reference acknowledges it lacks.
    """
    work = _bindct_transform(blocks_u8)
    if descale:
        s = jnp.asarray(bindct_descale_2d())[None, :]
        q = jnp.asarray(quant.reshape(64).astype(np.float32))[None, :]
        return _quant_divide(work.astype(jnp.float32) * s, q).astype(jnp.int16)
    q = jnp.asarray(quant.reshape(64).astype(np.int32))
    return _trunc_div_int(work, q).astype(jnp.int16)
