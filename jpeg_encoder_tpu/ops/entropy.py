"""Device-side run-length + Huffman entropy coding and bitstream packing.

The reference encoder streams blocks through three running DC predictors and
a single append-only bit vector (entropy_coding.rs:16-124), which serializes
the entire stage. Here the same bitstream is produced with no sequential
dependency at all:

1. every block's DC value exists after the DCT, so the "running predictor"
   is just a shifted subtraction over the per-component scan sequence;
2. zero-run bookkeeping (run lengths, ZRL insertion, EOB) is a cummax/cumsum
   over the 64-lane zigzag axis — each of the 64 coefficient positions of
   every block independently knows what it must emit;
3. every emission slot's Huffman code is a table gather, giving a
   (bits, length) pair per slot;
4. exclusive scans over the slot lengths yield every slot's absolute bit
   offset, and the slots are OR-ed into u32 words (pack_entries; the
   scatter-add reference packer pack_bits states the same semantics).
   Bit ranges never overlap, so add == or.

The result is bit-identical to the reference's sequential walk (verified
against the oracle), fully vectorized, and vmap/shard_map friendly. Slot
layout per block: slot 0 = DC, slots 1..63 = that zigzag position's emission
(nonzero coefficient, a ZRL it is responsible for, or nothing), slot 64 =
EOB. A slot emits at most code(<=16) + amplitude(<=11) = 27 bits, so u32
carries any slot and a slot spans at most two output words.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from jpeg_encoder_tpu import tables
from jpeg_encoder_tpu.config import FrameGeometry

SLOTS_PER_ENTRY = 65


# --------------------------------------------------------------------------
# Static scan layout (host-side, cached per geometry)
# --------------------------------------------------------------------------

def _luma_scan_order(geom: FrameGeometry) -> np.ndarray:
    """Luma block indices in interleaved scan order, shape (num_mcus * h*v,).

    MCU i reads luma superblock i of the row-major superblock grid and emits
    its h x v 8x8 sub-blocks row-major (entropy_coding.rs:74-103). Trailing
    superblocks beyond the chroma-driven MCU count are never emitted.
    """
    h, v = geom.h_factor, geom.v_factor
    sup_rows = np.arange(geom.mcu_rows * geom.mcu_cols) // geom.mcu_cols
    sup_cols = np.arange(geom.mcu_rows * geom.mcu_cols) % geom.mcu_cols
    sub_r = (np.arange(v * h) // h)[None, :]
    sub_c = (np.arange(v * h) % h)[None, :]
    rows = sup_rows[:, None] * v + sub_r
    cols = sup_cols[:, None] * h + sub_c
    order = rows * geom.luma_blocks_x + cols
    return order[: geom.num_mcus].reshape(-1).astype(np.int32)


@dataclasses.dataclass(frozen=True)
class ScanLayout:
    """Precomputed static index arrays describing the interleaved scan."""

    luma_order: np.ndarray      # (num_mcus * h*v,) rows into y coeffs
    entry_row: np.ndarray       # (E,) rows into concat(y, cb, cr) coeffs
    entry_is_luma: np.ndarray   # (E,) bool
    entry_diff_src: np.ndarray  # (E,) rows into concat(diff_y, diff_cb, diff_cr)
    num_entries: int


@functools.lru_cache(maxsize=256)
def scan_layout(geom: FrameGeometry) -> ScanLayout:
    h, v = geom.h_factor, geom.v_factor
    hv = h * v
    m = geom.num_mcus
    bpm = geom.blocks_per_mcu
    e = np.arange(m * bpm)
    mcu = e // bpm
    slot = e % bpm

    luma_order = _luma_scan_order(geom)
    ny = geom.num_luma_blocks

    entry_row = np.where(
        slot < hv,
        luma_order[np.minimum(mcu * hv + slot, luma_order.size - 1)],
        np.where(slot == hv, ny + mcu, ny + m + mcu),
    ).astype(np.int32)
    entry_is_luma = slot < hv
    entry_diff_src = np.where(
        slot < hv,
        mcu * hv + slot,
        np.where(slot == hv, m * hv + mcu, m * hv + m + mcu),
    ).astype(np.int32)
    return ScanLayout(
        luma_order=luma_order,
        entry_row=entry_row,
        entry_is_luma=entry_is_luma,
        entry_diff_src=entry_diff_src,
        num_entries=m * bpm,
    )


# --------------------------------------------------------------------------
# Device-side symbolization + packing
# --------------------------------------------------------------------------

def _bit_length(values: jnp.ndarray) -> jnp.ndarray:
    """Magnitude category of |values| (int32): 32 - clz(|v|); bl(0) = 0."""
    return 32 - jax.lax.clz(jnp.abs(values))


def _seq_diff(seq: jnp.ndarray, init: jnp.ndarray) -> jnp.ndarray:
    """diff[k] = seq[k] - seq[k-1], with `init` as the predictor before k=0."""
    return seq - jnp.concatenate([init.reshape(1).astype(seq.dtype), seq[:-1]])


def marshal_scan_inputs(
    y_coeffs: jnp.ndarray,
    cb_coeffs: jnp.ndarray,
    cr_coeffs: jnp.ndarray,
    geom: FrameGeometry,
    init_dc: jnp.ndarray | None = None,
    coeffs_zigzagged: bool = False,
    want_diff: bool = True,
) -> tuple[jnp.ndarray, jnp.ndarray | None]:
    """Natural-order coefficient planes -> (scan-entry rows, DC diffs).

    want_diff=False skips the DC-difference computation (callers that
    difference per restart interval do it themselves from the raw DCs in
    slot 0) and returns None in its place.

    Scan-entry ordering via pure layout ops (no gathers): luma blocks
    regroup into h x v superblocks with one reshape/transpose; MCU k's
    entries are [superblock k row-major | cb k | cr k]
    (entropy_coding.rs:97-124). Superblocks past the chroma-driven MCU
    count are never emitted (quirk geometries; see _luma_scan_order).
    Marshalling keeps the input dtype (usually int16): the layout work
    is bound by memory bandwidth, and the consumers widen it themselves.
    The DC "running predictor" is a shifted subtraction per component
    chain, seeded from init_dc (zeros, or a previous shard's final DCs).
    """
    h, v = geom.h_factor, geom.v_factor
    hv = h * v
    m = geom.num_mcus
    bpm = geom.blocks_per_mcu
    by, bx = geom.luma_blocks_y, geom.luma_blocks_x
    if v == 1:
        # Superblocks are h CONSECUTIVE row-major blocks (4:2:2 / 4:4:4), so
        # the luma scan order is the IDENTITY and sup is a pure reshape.
        sup = y_coeffs.reshape(-1, hv, 64)
    else:
        sup = (
            y_coeffs
            .reshape(by // v, v, bx // h, h, 64)
            .transpose(0, 2, 1, 3, 4)
            .reshape(-1, hv, 64)
        )
    y_mcu = sup[:m]  # (m, hv, 64)
    if v == 1:
        # 4:2:2 / 4:4:4 fast interleave: each MCU's h luma blocks are
        # CONSECUTIVE row-major rows, so the whole MCU flattens to one
        # (64 * bpm)-lane row [Y_hk..Y_hk+h-1 | Cb_k | Cr_k] and the
        # interleave is a LANE concat plus a free reshape: (m, 64 * bpm)
        # row-major IS the scan-entry sequence.
        y2 = y_mcu.reshape(m, 64 * hv)
        rows = jnp.concatenate(
            [y2, cb_coeffs[:m], cr_coeffs[:m]], axis=1
        ).reshape(m * bpm, 64)
    else:
        rows = jnp.concatenate(
            [y_mcu, cb_coeffs[:, None, :], cr_coeffs[:, None, :]], axis=1
        ).reshape(m * bpm, 64)
    if not coeffs_zigzagged:
        rows = rows[:, jnp.asarray(tables.ZIGZAG_ORDER)]
    if not want_diff:
        return rows, None

    if init_dc is None:
        init_dc = jnp.zeros((3,), jnp.int32)
    diff_y = _seq_diff(y_mcu[:, :, 0].astype(jnp.int32).reshape(-1), init_dc[0])
    diff_cb = _seq_diff(cb_coeffs[:, 0].astype(jnp.int32), init_dc[1])
    diff_cr = _seq_diff(cr_coeffs[:, 0].astype(jnp.int32), init_dc[2])
    entry_diff = jnp.concatenate(
        [diff_y.reshape(m, hv), diff_cb[:, None], diff_cr[:, None]], axis=1
    ).reshape(m * bpm)
    return rows, entry_diff


def encode_scan(
    y_coeffs: jnp.ndarray,
    cb_coeffs: jnp.ndarray,
    cr_coeffs: jnp.ndarray,
    geom: FrameGeometry,
    capacity_bytes: int,
    init_dc: jnp.ndarray | None = None,
    coeffs_zigzagged: bool = False,
    live_entries: jnp.ndarray | None = None,
    luts: tuple[jnp.ndarray, jnp.ndarray] | None = None,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Quantized coefficients -> packed entropy bytes.

    Args:
      y_coeffs:  (num_luma_blocks, 64) int, natural (row-major) order.
      cb_coeffs: (num_chroma_blocks, 64) int.
      cr_coeffs: (num_chroma_blocks, 64) int.
      geom: frame geometry (static).
      capacity_bytes: static output buffer size (multiple of 4).
      init_dc: optional (3,) int32 initial DC predictors (Y, Cb, Cr); defaults
        to zeros. Non-zero values are how MCU-band-sharded encodes chain
        their predictors across devices (see parallel/tiled.py).
      coeffs_zigzagged: the inputs are already in zigzag order (the DCT
        folds the zigzag permutation into its constants), so skip the
        gather here. DC stays at column 0 either way.
      live_entries: optional traced scalar; scan entries at index >=
        live_entries emit zero bits (their coefficients may be arbitrary).
        Used by uneven MCU-band sharding (parallel/tiled.py) where the
        trailing band(s) carry padding rows: dead entries are always a
        suffix of the scan, so the live prefix's bits and total are
        unaffected.
      luts: optional (dc, ac) packed (2, 256) code tables replacing the
        Annex-K ones (see encode_entries_xla).

    Returns:
      (bytes_u8 of shape (capacity_bytes,), total_bits scalar int32). The
      payload occupies the first ceil(total_bits / 8) bytes; the final
      partial byte is zero-filled like the reference (file.rs:92-103). If
      total_bits > 8 * capacity_bytes the caller must re-encode with a
      larger capacity (excess writes are dropped, never corrupted).
    """
    assert capacity_bytes % 4 == 0
    hv = geom.h_factor * geom.v_factor
    with jax.named_scope("scan_marshal"):
        z, entry_diff = marshal_scan_inputs(
            y_coeffs, cb_coeffs, cr_coeffs, geom, init_dc, coeffs_zigzagged
        )
    with jax.named_scope("entropy_pack"):
        return encode_entries_xla(
            z.astype(jnp.int32), entry_diff, hv, capacity_bytes,
            live_entries, luts,
        )


def default_packed_luts() -> tuple[np.ndarray, np.ndarray]:
    """(dc, ac) (2, 256) (length << 20) | code LUTs for the Annex-K tables.

    Row 0 = luma table, row 1 = chroma; one gather yields both fields
    (code <= 16 bits, length <= 16, so the packing is lossless). The
    same packed form carries per-image optimized tables
    (tables.optimal_spec) through the identical encode program.
    """
    dc = (tables.DC_LEN_LUT.astype(np.int32) << 20) | (
        tables.DC_CODE_LUT.astype(np.int32)
    )
    ac = (tables.AC_LEN_LUT.astype(np.int32) << 20) | (
        tables.AC_CODE_LUT.astype(np.int32)
    )
    return dc, ac


def pack_lut(spec) -> np.ndarray:
    """One HuffmanSpec -> 256-entry (length << 20) | code LUT row."""
    return (spec.length_lut.astype(np.int32) << 20) | (
        spec.code_lut.astype(np.int32)
    )


def encode_entries_xla(
    z: jnp.ndarray,
    entry_diff: jnp.ndarray,
    hv: int,
    capacity_bytes: int,
    live_entries: jnp.ndarray | None = None,
    luts: tuple[jnp.ndarray, jnp.ndarray] | None = None,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Marshaled scan entries -> packed bytes (the XLA symbolization body).

    Factored out of encode_scan so interval-shaped callers (the restart-
    marker encoder, which vmaps over independent restart intervals) can
    symbolize any MCU-aligned entry slice: `z` is (E, 64) zigzag entries
    with raw DC at slot 0, `entry_diff` the (E,) DC differences, and the
    luma/chroma pattern repeats every hv+2 entries.

    luts = (dc, ac) packed (2, 256) arrays overrides the Annex-K code
    tables — traced operands, so the optimized-Huffman mode reuses ONE
    compiled program for any per-image tables.
    """
    m = z.shape[0] // (hv + 2)

    is_luma = jnp.asarray(
        np.tile(np.array([True] * hv + [False, False]), m)
    )
    tbl = jnp.where(is_luma, 0, 1)  # (E,) table id: 0 luma, 1 chroma

    if luts is None:
        dc_np, ac_np_packed = default_packed_luts()
        dc_lut, ac_lut = jnp.asarray(dc_np), jnp.asarray(ac_np_packed)
        candidates = ASSEMBLE_CANDIDATES
    else:
        dc_lut, ac_lut = luts
        # Custom tables can assign 1-bit codes -> 2-bit minimum entries;
        # the output assembly must consider more intersecting entries per
        # word.
        candidates = ASSEMBLE_CANDIDATES_CUSTOM

    # ---- DC slot (slot 0) ----
    dc_bl = _bit_length(entry_diff)
    dc_ampl = jnp.where(
        entry_diff < 0, entry_diff + (1 << dc_bl) - 1, entry_diff
    ) & ((1 << dc_bl) - 1)
    dc_cl = dc_lut[tbl, dc_bl]
    dc_code = dc_cl & 0xFFFFF
    dc_len = (dc_cl >> 20) + dc_bl
    dc_bits = (dc_code << dc_bl) | dc_ampl

    # ---- AC slots (positions 1..63, computed for all 64 lanes) ----
    pos = jnp.arange(64, dtype=jnp.int32)[None, :]
    nz_marker = jnp.where((z != 0) & (pos > 0), pos, 0)
    run_base = jnp.concatenate(
        [jnp.zeros_like(nz_marker[:, :1]),
         jax.lax.cummax(nz_marker, axis=1)[:, :-1]],
        axis=1,
    )  # previous nonzero position (0 if none), exclusive
    last_nz = jax.lax.cummax(nz_marker, axis=1)[:, -1:]  # (E, 1)

    is_nonzero = (z != 0) & (pos > 0)
    run_dist = pos - run_base  # distance to previous nonzero (>= 1)
    zeros_before = run_dist - 1  # full zero run preceding a nonzero

    ac_bl = _bit_length(z)
    ac_sym = ((zeros_before & 15) << 4) | ac_bl
    ac_ampl = jnp.where(z < 0, z + (1 << ac_bl) - 1, z) & ((1 << ac_bl) - 1)
    tbl_b = tbl[:, None]
    nz_cl = ac_lut[tbl_b, ac_sym]
    nz_len = (nz_cl >> 20) + ac_bl
    nz_bits = ((nz_cl & 0xFFFFF) << ac_bl) | ac_ampl

    # A zero lane emits one ZRL iff it is the 16th/32nd/48th zero of a run
    # that terminates at a later nonzero (never for trailing zeros). ZRL
    # and EOB codes are two values per table, read from the (possibly
    # per-image) packed LUT rows: a (E, 1)-shaped gather each (XLA folds
    # it to a select when the LUT is a compile-time constant).
    is_zero_lane = (z == 0) & (pos > 0)
    zrl_here = is_zero_lane & (pos <= last_nz) & (run_dist % 16 == 0)
    zrl_cl = ac_lut[tbl[:, None], 0xF0]  # (E, 1)
    zrl_code = zrl_cl & 0xFFFFF
    zrl_len = zrl_cl >> 20

    ac_bits = jnp.where(is_nonzero, nz_bits, jnp.where(zrl_here, zrl_code, 0))
    ac_len = jnp.where(is_nonzero, nz_len, jnp.where(zrl_here, zrl_len, 0))

    # ---- EOB slot (slot 64): emitted iff the last zigzag coefficient is 0 ----
    eob_needed = z[:, 63] == 0
    eob_cl = ac_lut[tbl, 0x00]  # (E,)
    eob_bits = jnp.where(eob_needed, eob_cl & 0xFFFFF, 0)
    eob_len = jnp.where(eob_needed, eob_cl >> 20, 0)

    # ---- assemble slots: [DC | AC lanes 1..63 | EOB] per entry ----
    slot_bits = jnp.concatenate(
        [dc_bits[:, None], ac_bits[:, 1:], eob_bits[:, None]], axis=1
    ).astype(jnp.uint32)
    slot_lens = jnp.concatenate(
        [dc_len[:, None], ac_len[:, 1:], eob_len[:, None]], axis=1
    ).astype(jnp.int32)

    if live_entries is not None:
        # Dead suffix entries (padding MCU rows of an uneven band split)
        # emit nothing. Their slot buffers zero out, so the packer's gather
        # windows read zeros past the live stream, and the cumsum-derived
        # total counts only live bits.
        live = (
            jnp.arange(slot_lens.shape[0], dtype=jnp.int32)
            < live_entries
        )[:, None]
        slot_lens = jnp.where(live, slot_lens, 0)
        slot_bits = jnp.where(live, slot_bits, jnp.uint32(0))

    return pack_entries(slot_bits, slot_lens, capacity_bytes, candidates)


def symbol_histograms(
    y_coeffs: jnp.ndarray,
    cb_coeffs: jnp.ndarray,
    cr_coeffs: jnp.ndarray,
    geom: FrameGeometry,
    coeffs_zigzagged: bool = False,
    restart_mcus: int | None = None,
    init_dc: jnp.ndarray | None = None,
    live_entries: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """Huffman symbol counts for the scan: (4, 256) int32 on device.

    Rows: Y-DC, C-DC, Y-AC, C-AC — the statistics pass of two-pass
    optimized-Huffman encoding (the analog of libjpeg's -optimize
    gather). Symbol derivation mirrors encode_entries_xla exactly: DC
    magnitude categories, (run << 4) | size AC symbols at nonzero
    positions, ZRL at completed 16-zero runs, EOB when the block's tail
    is zero. One segment-sum over combined (table, symbol) ids; masked
    slots land in a 1025th trash bin.

    restart_mcus MUST match the encode pass's framing: restart intervals
    reset the DC predictors, changing the DC difference categories — a
    category unseen by mismatched statistics would have no code and emit
    zero bits (a corrupt stream). The interval-framed DC diffs come from
    the same interval_dc_diffs the encoder uses.

    init_dc seeds the DC predictor chains like encode_scan's: the
    MCU-band-sharded two-pass mode histograms each band with its
    ppermuted predecessors so the psum of band counts equals the whole
    scan's. live_entries masks the scan suffix into the trash bin
    (uneven-band padding must not count symbols the encode never emits).
    """
    hv = geom.h_factor * geom.v_factor
    z, entry_diff = marshal_scan_inputs(
        y_coeffs, cb_coeffs, cr_coeffs, geom, init_dc, coeffs_zigzagged,
        want_diff=restart_mcus is None,
    )
    z = z.astype(jnp.int32)
    m = geom.num_mcus
    if restart_mcus is not None:
        bpm = geom.blocks_per_mcu
        num_entries = m * bpm
        epi = min(restart_mcus, m) * bpm
        n_int = -(-m // restart_mcus)
        pad = n_int * epi - num_entries
        zp = (
            jnp.concatenate([z, jnp.zeros((pad, 64), z.dtype)]) if pad
            else z
        )
        entry_diff = jax.vmap(
            lambda zi: interval_dc_diffs(zi, hv)
        )(zp.reshape(n_int, epi, 64)).reshape(-1)[:num_entries]
    is_luma = jnp.asarray(
        np.tile(np.array([True] * hv + [False, False]), m)
    )
    tbl = jnp.where(is_luma, 0, 1)

    dc_sym = _bit_length(entry_diff)                     # (E,)
    dc_ids = tbl * 256 + dc_sym

    pos = jnp.arange(64, dtype=jnp.int32)[None, :]
    nz_marker = jnp.where((z != 0) & (pos > 0), pos, 0)
    run_base = jnp.concatenate(
        [jnp.zeros_like(nz_marker[:, :1]),
         jax.lax.cummax(nz_marker, axis=1)[:, :-1]],
        axis=1,
    )
    last_nz = jax.lax.cummax(nz_marker, axis=1)[:, -1:]
    is_nonzero = (z != 0) & (pos > 0)
    run_dist = pos - run_base
    zeros_before = run_dist - 1
    ac_sym = ((zeros_before & 15) << 4) | _bit_length(z)
    is_zero_lane = (z == 0) & (pos > 0)
    zrl_here = is_zero_lane & (pos <= last_nz) & (run_dist % 16 == 0)
    sym = jnp.where(is_nonzero, ac_sym, 0xF0)
    emit = is_nonzero | zrl_here
    ac_base = (2 + tbl)[:, None] * 256
    ac_ids = jnp.where(emit, ac_base + sym, 1024)        # (E, 64)
    eob_ids = jnp.where(z[:, 63] == 0, ac_base[:, 0], 1024)

    if live_entries is not None:
        live = (
            jnp.arange(dc_ids.shape[0], dtype=jnp.int32)
            < jnp.asarray(live_entries, jnp.int32)
        )
        dc_ids = jnp.where(live, dc_ids, 1024)
        ac_ids = jnp.where(live[:, None], ac_ids, 1024)
        eob_ids = jnp.where(live, eob_ids, 1024)

    ids = jnp.concatenate([dc_ids, ac_ids.reshape(-1), eob_ids])
    hist = jax.ops.segment_sum(
        jnp.ones_like(ids), ids, num_segments=1025
    )
    return hist[:1024].reshape(4, 256)


def interval_dc_diffs(z: jnp.ndarray, hv: int) -> jnp.ndarray:
    """Raw slot-0 DCs of one restart interval -> running DC differences.

    Per-component predictor chains seeded at 0, exactly the reset the DRI
    spec mandates at every restart marker (and what marshal_scan_inputs
    does for a whole scan with init_dc=0). `z` is (E, 64) entries in
    MCU-interleaved order; the component of entry e is determined by
    e mod (hv+2): the first hv slots are luma, then Cb, then Cr.
    """
    zi = z.reshape(-1, hv + 2, 64)
    zero = jnp.zeros((), jnp.int32)
    dy = _seq_diff(zi[:, :hv, 0].astype(jnp.int32).reshape(-1), zero)
    dcb = _seq_diff(zi[:, hv, 0].astype(jnp.int32), zero)
    dcr = _seq_diff(zi[:, hv + 1, 0].astype(jnp.int32), zero)
    return jnp.concatenate(
        [dy.reshape(-1, hv), dcb[:, None], dcr[:, None]], axis=1
    ).reshape(-1)


def encode_scan_restart(
    y_coeffs: jnp.ndarray,
    cb_coeffs: jnp.ndarray,
    cr_coeffs: jnp.ndarray,
    geom: FrameGeometry,
    capacity_bytes: int,
    restart_mcus: int,
    coeffs_zigzagged: bool = False,
    live_entries: jnp.ndarray | None = None,
    luts: tuple[jnp.ndarray, jnp.ndarray] | None = None,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Quantized coefficients -> one packed stream PER RESTART INTERVAL.

    Each run of `restart_mcus` MCUs encodes as an independent scan segment
    (DC predictors reset to zero — the semantics DRI/RSTn markers define);
    the host then byte-aligns each segment and joins them with RST(n mod 8)
    markers (io/jfif.assemble_restart). `capacity_bytes` is PER INTERVAL.

    Device shape: the marshaled (E, 64) entry stream reshapes to
    (n_intervals, restart_mcus * bpm, 64) — interval boundaries are MCU
    boundaries, so the per-entry component pattern stays aligned — and the
    scan encoder vmaps over the interval axis: every interval packs
    concurrently, each an instance of the same symbolize + pack program
    the unbroken scan uses. A short trailing interval rides the
    live-entry masking the uneven-band tiled path uses. Restart markers
    are absent from the reference (file.rs:77-90); this extension makes
    the emitted files parallel-decodable (and band-splicing trivial).

    Returns (payload bytes (n_intervals, capacity_bytes), bits
    (n_intervals,)). Overflow handling is per the unbroken scan: if any
    interval's bits exceed 8*capacity_bytes the caller re-encodes with a
    larger capacity.

    live_entries (traced scalar, default: all) masks the scan suffix to
    emit zero bits, interval-wise: interval j keeps
    clip(live_entries - j*epi, 0, epi) live entries. The band-tiled
    restart mode uses it for the trailing band's padding rows; fully dead
    intervals report 0 bits and are dropped by the assembler.
    """
    assert capacity_bytes % 4 == 0
    hv = geom.h_factor * geom.v_factor
    bpm = geom.blocks_per_mcu
    m = geom.num_mcus
    n_int = -(-m // restart_mcus)
    # Clamp the interval to the image: a huge --restart-interval (legal up
    # to 65535) on a small image must not pad the single interval out to
    # restart_mcus' worth of dead entries.
    epi = min(restart_mcus, m) * bpm
    num_entries = m * bpm

    z, _ = marshal_scan_inputs(
        y_coeffs, cb_coeffs, cr_coeffs, geom, None, coeffs_zigzagged,
        want_diff=False,
    )
    pad = n_int * epi - num_entries
    if pad:
        z = jnp.concatenate([z, jnp.zeros((pad, 64), z.dtype)])
    zi = z.reshape(n_int, epi, 64)
    total = (
        jnp.int32(num_entries) if live_entries is None
        else jnp.asarray(live_entries, jnp.int32)
    )
    live = jnp.clip(
        total - jnp.arange(n_int, dtype=jnp.int32) * epi, 0, epi
    )

    def one(zz, lv):
        zz = zz.astype(jnp.int32)
        return encode_entries_xla(
            zz, interval_dc_diffs(zz, hv), hv, capacity_bytes, lv, luts,
        )

    return jax.vmap(one)(zi, live)


def coefficient_ranges(
    y_coeffs: jnp.ndarray,
    cb_coeffs: jnp.ndarray,
    cr_coeffs: jnp.ndarray,
    geom: FrameGeometry,
    init_dc: jnp.ndarray | None = None,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """(max |DC difference|, max |AC coefficient|) over the whole scan.

    The reference panics when a DC difference needs more than 11 bits or an
    AC coefficient more than 10 (entropy_coding.rs:153-155,188-191) — both
    unreachable for valid u8 image input, but reachable when callers feed
    raw coefficient arrays. The device program reports them and the host
    checks them (pipeline.validate_scan_ranges).
    """
    h, v = geom.h_factor, geom.v_factor
    m = geom.num_mcus
    by, bx = geom.luma_blocks_y, geom.luma_blocks_x
    y_mcu = (
        y_coeffs.astype(jnp.int32)
        .reshape(by // v, v, bx // h, h, 64)
        .transpose(0, 2, 1, 3, 4)
        .reshape(-1, h * v, 64)
    )[:m]
    if init_dc is None:
        init_dc = jnp.zeros((3,), jnp.int32)
    diffs = [
        _seq_diff(y_mcu[:, :, 0].reshape(-1), init_dc[0]),
        _seq_diff(cb_coeffs[:, 0].astype(jnp.int32), init_dc[1]),
        _seq_diff(cr_coeffs[:, 0].astype(jnp.int32), init_dc[2]),
    ]
    max_dc = jnp.maximum(
        jnp.max(jnp.abs(diffs[0])),
        jnp.maximum(jnp.max(jnp.abs(diffs[1])), jnp.max(jnp.abs(diffs[2]))),
    )
    acs = [
        jnp.max(jnp.abs(y_mcu[:, :, 1:])),
        jnp.max(jnp.abs(cb_coeffs[:, 1:].astype(jnp.int32))),
        jnp.max(jnp.abs(cr_coeffs[:, 1:].astype(jnp.int32))),
    ]
    max_ac = jnp.maximum(acs[0], jnp.maximum(acs[1], acs[2]))
    return max_dc, max_ac


def final_dc(
    y_coeffs: jnp.ndarray,
    cb_coeffs: jnp.ndarray,
    cr_coeffs: jnp.ndarray,
    geom: FrameGeometry,
) -> jnp.ndarray:
    """(3,) int32: last DC value of each component chain in scan order.

    This is what the next MCU band's predictors must start from when one
    image is sharded across devices.
    """
    layout = scan_layout(geom)
    return jnp.stack(
        [
            y_coeffs[int(layout.luma_order[-1]), 0].astype(jnp.int32),
            cb_coeffs[-1, 0].astype(jnp.int32),
            cr_coeffs[-1, 0].astype(jnp.int32),
        ]
    )


# Max u32 words one entry's packed stream can span: 65 slots * 27 bits =
# 1755 bits -> words 0..54, plus one spill word.
ENTRY_WORDS = 56

# Entries intersecting one 32-bit output word: the entry covering the word's
# first bit plus every entry that *starts* inside the word. With the
# Annex-K tables the shortest possible entry is 4 bits (chroma DC
# category 0 + chroma EOB, 2+2), so at most 8 entries start within 32
# bits -> 9 candidates; one extra for margin. Per-image OPTIMIZED tables
# can assign 1-bit codes, shrinking the minimum entry to 2 bits (DC cat 0
# + EOB): 16 starts + 1 covering + 1 margin -> 18 (pack_entries takes the
# count as a parameter; encode_entries_xla widens it for custom luts --
# a 10-candidate assembly silently DROPS contributions for such streams).
ASSEMBLE_CANDIDATES = 10
ASSEMBLE_CANDIDATES_CUSTOM = 18


def _split_slot_words(
    slot_bits: jnp.ndarray, slot_lens: jnp.ndarray, offsets: jnp.ndarray
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """MSB-first alignment of each slot at its bit offset.

    Returns (word_index, hi, lo): the slot's contribution to word_index is
    `hi`, and `lo` spills into word_index + 1 when the slot crosses the
    32-bit boundary (lo == 0 otherwise).
    """
    start = offsets & 31
    end = start + slot_lens  # in [0, 58]
    shift_hi = jnp.clip(32 - end, 0, 31)
    hi = jnp.where(
        end <= 32,
        slot_bits << shift_hi.astype(jnp.uint32),
        slot_bits >> jnp.clip(end - 32, 0, 31).astype(jnp.uint32),
    )
    lo = jnp.where(
        end > 32, slot_bits << jnp.clip(64 - end, 0, 31).astype(jnp.uint32), 0
    )
    return offsets >> 5, hi, lo


def _pack_level1(
    slot_bits: jnp.ndarray, slot_lens: jnp.ndarray
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """(E, S) slot codes -> ((E, ENTRY_WORDS) u32 buffers, (E,) bit counts).

    Per entry: slots pack into a private (ENTRY_WORDS,) u32 buffer via a
    masked-OR sweep — S fused elementwise steps over (E, ENTRY_WORDS), no
    cross-entry interaction.
    """
    num_entries, slots = slot_bits.shape
    local_off = jnp.cumsum(slot_lens, axis=1) - slot_lens  # (E, S) exclusive
    entry_bits = local_off[:, -1] + slot_lens[:, -1]  # (E,)
    word_idx, hi, lo = _split_slot_words(slot_bits, slot_lens, local_off)

    col = jnp.arange(ENTRY_WORDS, dtype=jnp.int32)[None, :]
    entry_words = jnp.zeros((num_entries, ENTRY_WORDS), jnp.uint32)
    for s in range(slots):
        w = word_idx[:, s : s + 1]
        entry_words = entry_words | jnp.where(col == w, hi[:, s : s + 1], 0)
        entry_words = entry_words | jnp.where(col == w + 1, lo[:, s : s + 1], 0)
    return entry_words, entry_bits


def _words_to_bytes(words: jnp.ndarray) -> jnp.ndarray:
    """Big-endian byte serialization: MSB-first bitstream order.

    bitcast yields each u32's bytes little-endian; reversing the byte axis
    gives the MSB-first order without the (n, 4) int32 shift/mask temp.
    """
    return jax.lax.bitcast_convert_type(words, jnp.uint8)[:, ::-1].reshape(-1)


def pack_entries(
    slot_bits: jnp.ndarray, slot_lens: jnp.ndarray, capacity_bytes: int,
    candidates: int = ASSEMBLE_CANDIDATES,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Scatter-free bitstream packing of (E, S) per-entry slot codes.

    Two levels, both plain vector code with no scatter:

    1. Per entry: _pack_level1's masked-OR sweep.
    2. Global: entry e's stream starts at bit offset O[e] (one exclusive
       cumsum). Each *output word* gathers the <= ASSEMBLE_CANDIDATES
       entries that can intersect it (found with one searchsorted) and ORs
       32-bit windows extracted from their entry buffers. Out-of-range
       candidates self-mask: their extraction indices fall outside the
       entry buffer and read as zero.

    Returns (bytes_u8 (capacity_bytes,), total_bits).
    """
    assert capacity_bytes % 4 == 0
    num_entries, _ = slot_bits.shape
    entry_words, entry_bits = _pack_level1(slot_bits, slot_lens)

    # ---- level 2: output-centric assembly ----
    start_bit = jnp.cumsum(entry_bits) - entry_bits  # O[e], strictly increasing
    total_bits = (start_bit[-1] + entry_bits[-1]).astype(jnp.int32)

    num_words = capacity_bytes // 4
    base = jnp.arange(num_words, dtype=jnp.int32) * 32
    first = jnp.searchsorted(start_bit, base, side="right").astype(jnp.int32) - 1

    flat_words = entry_words.reshape(-1)
    out = jnp.zeros((num_words,), jnp.uint32)
    for k in range(candidates):
        e = jnp.clip(first + k, 0, num_entries - 1)
        p = base - start_bit[e]  # signed bit position of the word in entry e
        j = p >> 5  # floor division: -1 when the entry starts mid-word
        sh = (p & 31).astype(jnp.uint32)
        w0 = jnp.where(
            (j >= 0) & (j < ENTRY_WORDS),
            flat_words[jnp.clip(e * ENTRY_WORDS + j, 0, None)], 0
        )
        j1 = j + 1
        w1 = jnp.where(
            (j1 >= 0) & (j1 < ENTRY_WORDS),
            flat_words[jnp.clip(e * ENTRY_WORDS + j1, 0, None)], 0
        )
        # MSB-first 32-bit window at bit position p of entry e's stream.
        contrib = jnp.where(sh == 0, w0, (w0 << sh) | (w1 >> (32 - sh)))
        out = out | contrib
        # Trailing garbage is impossible: entry buffers are zero past their
        # stream and candidates past the last entry clamp to repeats of it,
        # whose windows are zero once p >= its bit length (idempotent OR
        # makes the one genuine repeat harmless).

    return _words_to_bytes(out), total_bits


def pack_bits(
    slot_bits: jnp.ndarray, slot_lens: jnp.ndarray, capacity_bytes: int
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Reference packer: scatter-add of flat (S,) slot codes.

    Kept as the simple oracle for pack_entries; the clearest statement of
    the packing semantics.
    """
    offsets = jnp.cumsum(slot_lens) - slot_lens
    total_bits = (offsets[-1] + slot_lens[-1]).astype(jnp.int32)

    word = offsets >> 5
    start = offsets & 31
    end = start + slot_lens  # in (0, 58]

    # Contribution to `word`: the code aligned so its MSB sits at `start`.
    shift_hi = jnp.clip(32 - end, 0, 31)
    hi = jnp.where(
        end <= 32,
        slot_bits << shift_hi.astype(jnp.uint32),
        slot_bits >> jnp.clip(end - 32, 0, 31).astype(jnp.uint32),
    )
    # Spill into `word + 1` when the slot crosses the word boundary.
    spill = end > 32
    lo = jnp.where(
        spill, slot_bits << jnp.clip(64 - end, 0, 31).astype(jnp.uint32), 0
    )

    num_words = capacity_bytes // 4
    words = jnp.zeros((num_words,), jnp.uint32)
    words = words.at[word].add(hi, mode="drop")
    words = words.at[jnp.where(spill, word + 1, num_words)].add(lo, mode="drop")

    # Big-endian byte serialization: MSB-first bitstream order.
    shifts = jnp.array([24, 16, 8, 0], dtype=jnp.uint32)
    byte_matrix = (words[:, None] >> shifts[None, :]) & jnp.uint32(0xFF)
    return byte_matrix.reshape(-1).astype(jnp.uint8), total_bits
