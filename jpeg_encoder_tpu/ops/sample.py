"""Plane padding, chroma subsampling, and 8x8 block tiling.

The reference's PixelMatrix + block-iterator machinery (pixel_matrix.rs,
block_iterator.rs) dissolves into reshape/transpose on the device: an image
plane padded to MCU multiples is exactly a (by, 8, bx, 8) tensor, and zero
padding comes from jnp.pad. Subsampling (sampling.rs:46-102) becomes an
integer window mean — including the reference's push-order assembly quirk,
reproduced with a flatten/slice/reshape (see oracle.subsample_plane for the
full story).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from jpeg_encoder_tpu.config import FrameGeometry


def pad_plane(plane: jnp.ndarray, geom: FrameGeometry) -> jnp.ndarray:
    """Zero-pad (H, W) up to (padded_height, padded_width).

    Zero padding (not edge replication) matches jpeg_image.rs:59-84 where the
    planes are allocated zero-filled and only the image region is written.
    """
    return jnp.pad(
        plane,
        ((0, geom.padded_height - geom.height), (0, geom.padded_width - geom.width)),
    )


def subsample_plane(plane: jnp.ndarray, geom: FrameGeometry) -> jnp.ndarray:
    """Box-filter downsample a padded chroma plane -> (chroma_h, chroma_w).

    Integer floor mean over each h x v window of the padded plane (windows at
    the right/bottom edge therefore average in the zero padding), assembled
    in block-scan push order: flatten, truncate to the chroma plane size,
    reshape. Bit-identical to the reference for every width including the
    width % (8h) == 1 misalignment case.
    """
    h, v = geom.h_factor, geom.v_factor
    if h == 1 and v == 1:
        return plane
    if h not in (1, 2) or v not in (1, 2):
        # The strided-pair path below covers factors 1 and 2 only (all three
        # reference ratios); a factor-4 ratio (4:1:1) must not silently skip
        # the reduction.
        raise NotImplementedError(f"unsupported subsampling factors ({h}, {v})")
    # Pairwise strided adds over ROWS instead of a 4-D reshape + two-axis
    # reduction; int16 holds the <= 1020 window sums. The COLUMN pairing
    # avoids a strided lane slice (which XLA may lower to a gather plus
    # transposes): bitcasting adjacent int16 pairs to one int32 keeps it
    # elementwise, since both halves are < 2^15, so low = w & 0xFFFF and
    # high = w >> 16 recover the pair exactly. Values are identical either
    # way: same windows, same floor mean.
    x = plane.astype(jnp.int16)
    if v == 2:
        x = x[0::2, :] + x[1::2, :]
    if h == 2:
        hh, ww = x.shape
        w32 = jax.lax.bitcast_convert_type(x.reshape(hh, ww // 2, 2), jnp.int32)
        x = (w32 & 0xFFFF) + (w32 >> 16)
    averages = x.astype(jnp.int32) // (h * v)
    flat = averages.reshape(-1)
    n = geom.chroma_height * geom.chroma_width
    return flat[:n].astype(jnp.uint8).reshape(geom.chroma_height, geom.chroma_width)


def blockify(plane: jnp.ndarray) -> jnp.ndarray:
    """(H, W) -> (H//8 * W//8, 64): row-major blocks, row-major within.

    uint8 planes transpose as bitcast int32 words (each 8-pixel block row
    is two words, and both bitcasts are byte-order-preserving), moving a
    quarter of the elements — measured ~30% faster than the u8 transpose.
    """
    hgt, wdt = plane.shape
    if plane.dtype == jnp.uint8 and wdt % 8 == 0:
        p32 = jax.lax.bitcast_convert_type(
            plane.reshape(hgt, wdt // 4, 4), jnp.int32
        )
        out32 = (
            p32.reshape(hgt // 8, 8, wdt // 8, 2)
            .transpose(0, 2, 1, 3)
            .reshape(-1, 16)
        )
        return jax.lax.bitcast_convert_type(
            out32[..., None], jnp.uint8
        ).reshape(-1, 64)
    return (
        plane.reshape(hgt // 8, 8, wdt // 8, 8)
        .transpose(0, 2, 1, 3)
        .reshape(-1, 64)
    )


def unblockify(blocks: jnp.ndarray, height: int, width: int) -> jnp.ndarray:
    """(N, 64) -> (height, width); inverse of blockify."""
    return (
        blocks.reshape(height // 8, width // 8, 8, 8)
        .transpose(0, 2, 1, 3)
        .reshape(height, width)
    )
