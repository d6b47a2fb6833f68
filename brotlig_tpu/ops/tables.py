"""Batched (SPMD) Brotli-G page-header parsing and Huffman table loading.

Everything here is vectorized over a batch of pages [P] with 32 lanes per
page — the XLA analog of the reference GPU kernel's cooperative table build
(BrotliGCompute.hlsl:1198-1203, 612-692). The RLE code-length stream is
decoded *speculatively per lane*: lane s owns items s, s+32, ... of the
round-robin schedule, so all 32 lanes parse in lockstep and the true item
count / per-lane bit positions are reconciled afterwards — same trick as the
HLSL wave decode, recast as fixed-depth vector ops.

Returns canonical *range-search* decode structures (first_code/limit/offset
per length + rank-ordered symbol dictionary) instead of the reference CPU
decoder's 2^15 flat tables — O(alphabet) memory per page.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..format import constants as C
from .bits import peek_bits

I32 = jnp.int32
U32 = jnp.uint32

CL_ORDER = (1, 2, 3, 4, 0, 5, 17, 6, 16, 7, 8, 9, 10, 11, 12, 13, 14, 15)


def bit_length(x: jnp.ndarray) -> jnp.ndarray:
    """Integer bit_length (position of highest set bit + 1), vectorized."""
    x = x.astype(jnp.uint32)
    r = jnp.zeros_like(x, dtype=I32)
    for s in (16, 8, 4, 2, 1):
        t = x >> s
        take = t > 0
        r = r + jnp.where(take, s, 0)
        x = jnp.where(take, t, x)
    return r + (x > 0).astype(I32)


def parse_page_headers(words: jnp.ndarray, in_sizes: jnp.ndarray):
    """Parse page header + size table for a batch of compressed pages.

    words: uint32 [P, W]; in_sizes: int32 [P] compressed byte sizes.
    Returns (npostfix [P], ndirect [P], isdelta [P], lane_bitpos [P,32]).
    Mirrors PageDecoder.cpp:83-121.
    """
    return parse_page_headers_full(words, in_sizes)[:4]


def parse_page_headers_full(words: jnp.ndarray, in_sizes: jnp.ndarray):
    """parse_page_headers plus per-lane stream byte offsets [P, 32]
    (needed by narrow_stream_view)."""
    P = words.shape[0]
    nbs = C.NUM_BITSTREAMS
    pos0 = jnp.zeros((P, 1), dtype=I32)
    npostfix = peek_bits(words, pos0, 2).astype(I32)[:, 0]
    ndbits = peek_bits(words, pos0 + 2, 4).astype(I32)[:, 0]
    ndirect = ndbits << npostfix
    isdelta = peek_bits(words, pos0 + 6, 1).astype(I32)[:, 0]

    r_avg = (in_sizes + nbs - 1) // nbs
    base_size_bits = bit_length(r_avg)
    delta_bits_size_bits = bit_length(bit_length(in_sizes - 1))

    p8 = jnp.full((P, 1), 8, dtype=I32)
    base_size = peek_bits(words, p8, base_size_bits[:, None]).astype(I32)[:, 0]
    delta_size_bits = peek_bits(
        words, p8 + base_size_bits[:, None],
        delta_bits_size_bits[:, None]).astype(I32)[:, 0]

    header_bits = (8 + base_size_bits + delta_bits_size_bits
                   + nbs * delta_size_bits)
    header_bits = (header_bits + 31) // 32 * 32

    lane = jnp.arange(nbs, dtype=I32)[None, :]
    delta_pos = (8 + base_size_bits + delta_bits_size_bits)[:, None] \
        + lane * delta_size_bits[:, None]
    deltas = peek_bits(words, delta_pos,
                       delta_size_bits[:, None]).astype(I32)
    stream_len = base_size[:, None] + deltas
    stream_start = jnp.cumsum(stream_len, axis=1) - stream_len
    stream_bytes = header_bits[:, None] // 8 + stream_start
    lane_bitpos = stream_bytes * 8
    return npostfix, ndirect, isdelta, lane_bitpos, stream_bytes


# Bits of page header + size table never exceed 8 + 20 + 5 + 32*18 < 1024
# (widths derive from in_size <= 128 KiB), so header parsing only needs the
# first HEADER_WORDS words of each page.
HEADER_WORDS = 32


def narrow_stream_view(words: jnp.ndarray, stream_bytes: jnp.ndarray,
                       tl: int):
    """Compact per-stream table view: the first `tl` words of each of the
    32 sub-streams, stream-major — buf[p, s*tl + w] = bytes
    [stream_bytes[p,s] + 4w, +4) of page p.

    The three Huffman tables live in the first <=30 words of every stream
    (commands <=23 RLE items x <=12 bits + cl codes, see BrotligHuffman.cpp
    round-robin storage), but their bit positions are spread across the
    whole compressed page. Re-basing load_table's ~140 peeks onto this
    32*tl-word view (tl=64 -> 8 KB/page) keeps them inside one small,
    cache-resident operand.

    Returns (view [P, 32*tl] uint32, bp0 [P, 32] flat bit positions of
    each stream's start within the view). Positions inside the view
    advance intra-stream only (tables + speculative-RLE drift < 32 words
    < tl), so load_table needs no changes — hand it (view, bp0) in place
    of (words, lane_bitpos) and convert the returned positions back with
    `stream_bytes*8 + (bp - bp0)`."""
    P, W = words.shape
    w_idx = jnp.arange(tl + 1, dtype=I32)
    byte0 = stream_bytes[:, :, None] + 4 * w_idx[None, None, :]
    flat = byte0.reshape(P, 32 * (tl + 1))
    lo_i = jnp.clip(flat >> 2, 0, W - 1)
    g = jnp.take_along_axis(words, lo_i, axis=1).astype(U32) \
        .reshape(P, 32, tl + 1)
    sh = ((byte0 & 3) * 8).astype(U32)
    shl = sh[:, :, :tl]
    val = (g[:, :, :tl] >> shl) | jnp.where(
        shl == 0, jnp.uint32(0),
        g[:, :, 1:] << (jnp.uint32(32) - shl))
    view = val.reshape(P, 32 * tl)
    lane = jnp.arange(32, dtype=I32)[None, :]
    bp0 = jnp.broadcast_to(lane * (tl * 32), stream_bytes.shape)
    return view, bp0


# ---------------------------------------------------------------------------
# Canonical range-search structures
# ---------------------------------------------------------------------------

def build_search(lengths: jnp.ndarray, max_len: int, table_bits: int):
    """lengths [P, A] -> dict of canonical range-search arrays.

    limit[l]  : [P, max_len+1] left-aligned first-invalid code per length
    first[l]  : [P, max_len+1] canonical first code per length
    offset[l] : [P, max_len+1] rank of first symbol of length l
    symdict   : [P, A] symbols in canonical (len, symbol) order
    """
    P, A = lengths.shape
    L16 = max_len + 1
    lens_i = jnp.clip(lengths, 0, max_len).astype(I32)
    # one-hot over code lengths: ONE [P, A, L16] tensor replaces the
    # per-length count/rank loops (~45 tiny ops -> ~6)
    oh = (lens_i[:, :, None]
          == jnp.arange(L16, dtype=I32)[None, None, :]).astype(I32)
    counts = jnp.sum(oh, axis=1)                    # [P, L16]
    counts = counts.at[:, 0].set(0)

    # canonical first code per length, first[l] = (first[l-1] +
    # counts[l-1]) << 1 (counts[0] forced 0): shifts and adds on int32,
    # exact on every backend (no matrix unit, no float path)
    cols = [jnp.zeros((P,), I32)]
    for l in range(1, L16):
        cols.append((cols[-1] + counts[:, l - 1]) << 1)
    first = jnp.stack(cols, axis=1)

    limit = (first + counts) << (
        table_bits - jnp.arange(max_len + 1, dtype=I32))[None, :]
    offset = jnp.cumsum(counts, axis=1) - counts

    # canonical (len, symbol) order via counting ranks + one scatter —
    # no argsort over the alphabet
    excl = jnp.cumsum(oh, axis=1) - oh              # [P, A, L16]
    rank_same = jnp.where(
        lens_i > 0,
        jnp.take_along_axis(excl, lens_i[:, :, None], axis=2)[:, :, 0], 0)
    off_sym = jnp.take_along_axis(
        offset, jnp.clip(lengths, 0, max_len).astype(I32), axis=1)
    rank = jnp.where(lengths > 0, off_sym + rank_same, A)
    rows = jnp.arange(P, dtype=I32)[:, None]
    sym_ids = jnp.broadcast_to(jnp.arange(A, dtype=I32)[None, :], (P, A))
    symdict = jnp.zeros((P, A), I32).at[rows, rank].set(
        sym_ids, mode="drop")
    return dict(first=first, limit=limit, offset=offset, symdict=symdict)


def search_decode(search, window: jnp.ndarray, max_len: int, table_bits: int):
    """Decode one symbol per element from MSB-aligned windows.

    window: int32 [...] table_bits-wide MSB-first code windows (already
    bit-reversed from the LSB wire). Returns (symbol_rank_gatherable via
    symdict, code_len). Caller gathers symdict.
    """
    w = window.astype(I32)
    length = jnp.ones_like(w)
    for l in range(1, max_len):
        # search arrays are [P, L+1]; window is [P, K]
        length = length + (w >= search["limit"][:, l][:, None]).astype(I32)
    first_l = jnp.take_along_axis(search["first"], length, axis=1)
    off_l = jnp.take_along_axis(search["offset"], length, axis=1)
    code = w >> (table_bits - length)
    rank = off_l + code - first_l
    A = search["symdict"].shape[1]
    rank = jnp.clip(rank, 0, A - 1)
    sym = jnp.take_along_axis(search["symdict"], rank, axis=1)
    return sym, length


# ---------------------------------------------------------------------------
# Table loading
# ---------------------------------------------------------------------------

def _rev_n(v: jnp.ndarray, n: int) -> jnp.ndarray:
    """Bit-reverse the low n bits (n <= 16), vectorized."""
    v = v.astype(U32)
    r = jnp.zeros_like(v)
    for i in range(n):
        r = r | (((v >> i) & 1) << (n - 1 - i))
    return r.astype(I32)


def load_table(words, lane_bitpos, alphabet_size: int):
    """Load one Huffman table for every page in the batch.

    Returns (lengths [P, A] int32, trivial_sym [P] int32 (-1 if none),
    new_lane_bitpos [P, 32]).
    """
    P = words.shape[0]
    A = alphabet_size
    max_bits = (A - 1).bit_length()
    bp = lane_bitpos

    s0 = bp[:, 0:1]
    ttype = peek_bits(words, s0, 2).astype(I32)[:, 0]
    m_triv = ttype == 0
    m_simp = ttype == 1
    m_cplx = ttype == 2

    # --- trivial ---
    triv_sym = peek_bits(words, s0 + 6, max_bits).astype(I32)[:, 0]
    trivial_sym = jnp.where(m_triv, triv_sym, -1)

    # --- simple ---
    nsym = peek_bits(words, s0 + 2, 2).astype(I32)[:, 0] + 1
    tsel = peek_bits(words, s0 + 4, 1).astype(I32)[:, 0]
    # fixed length rows: idx 0:(1,1) 1:(1,2,2) 2:(2,2,2,2) 3:(1,2,3,3)
    fixed = jnp.asarray([[1, 1, 0, 0], [1, 2, 2, 0],
                         [2, 2, 2, 2], [1, 2, 3, 3]], dtype=I32)
    tbl_idx = jnp.where(nsym < 4, nsym - 2, jnp.where(tsel == 1, 3, 2))
    tbl_idx = jnp.clip(tbl_idx, 0, 3)

    lengths = jnp.zeros((P, A + 1), dtype=I32)
    new_bp = bp
    # stream 0 header consumption
    adv0 = jnp.where(m_triv | m_simp, 6, jnp.where(m_cplx, 6, 0))
    # trivial also reads its symbol from stream 0
    adv0 = adv0 + jnp.where(m_triv, max_bits, 0)
    # simple symbol reads: symbol i from stream i at its own position
    simple_syms = []
    for i in range(4):
        read_pos = jnp.where(jnp.asarray(i == 0), bp[:, i] + 6, bp[:, i])
        sym_i = peek_bits(words, read_pos[:, None],
                          max_bits).astype(I32)[:, 0]
        active = m_simp & (i < nsym)
        simple_syms.append((sym_i, active))
        if i == 0:
            adv0 = adv0 + jnp.where(m_simp, max_bits, 0)
        else:
            new_bp = new_bp.at[:, i].add(
                jnp.where(active, max_bits, 0))
    rows = jnp.arange(P, dtype=I32)
    for i in range(4):
        sym_i, active = simple_syms[i]
        col = jnp.where(active, sym_i, A)  # A = trash column
        lengths = lengths.at[rows, col].set(
            jnp.where(active, fixed[tbl_idx, i], lengths[rows, col]))

    # --- complex ---
    nlen = peek_bits(words, s0 + 2, 4).astype(I32)[:, 0] + 4
    adv0 = adv0 + jnp.where(m_cplx, 0, 0)
    cl_lengths = jnp.zeros((P, C.CODE_LENGTH_CODES), dtype=I32)
    cplx_bp = new_bp
    for i in range(C.CODE_LENGTH_CODES):
        read_pos = cplx_bp[:, i] + jnp.where(jnp.asarray(i == 0), 6, 0)
        v = peek_bits(words, read_pos[:, None], 5).astype(I32)[:, 0]
        active = m_cplx & (i < nlen)
        v = jnp.where(active, v, 0)
        cl_lengths = cl_lengths.at[:, CL_ORDER[i]].set(v)
        if i == 0:
            adv0 = adv0 + jnp.where(m_cplx, 5, 0)
        else:
            cplx_bp = cplx_bp.at[:, i].add(jnp.where(active, 5, 0))
    # apply stream-0 advances now
    cplx_bp = cplx_bp.at[:, 0].add(adv0)
    new_bp = cplx_bp

    # speculative RLE decode: lane s owns items s, s+32, ...
    steps = (A + C.NUM_BITSTREAMS - 1) // C.NUM_BITSTREAMS
    cl_search = build_search(cl_lengths, 9, 9)

    def rle_step(carry, _):
        bpos = carry
        win = peek_bits(words, bpos, 9).astype(I32)
        idx = _rev_n(win, 9)
        sym, ln = search_decode(cl_search, idx, 9, 9)
        is16 = sym == C.REPEAT_PREVIOUS_CODE_LENGTH
        is17 = sym == C.REPEAT_ZERO_CODE_LENGTH
        ebits = jnp.where(is16, 2, jnp.where(is17, 3, 0))
        extra = peek_bits(words, bpos + ln, ebits).astype(I32)
        bpos2 = bpos + ln + ebits
        return bpos2, (sym, extra, bpos2)

    rle_bp0 = new_bp
    # unroll: the body is ~15 tiny [P,32] ops, so straight-line code
    # beats paying loop machinery per step
    rle_bp_final, (syms_t, extra_t, bp_hist) = jax.lax.scan(
        rle_step, rle_bp0, None, length=steps, unroll=steps)
    # item-major order: item g = step g//32, lane g%32
    syms_g = jnp.moveaxis(syms_t, 0, 1).reshape(P, steps * 32)
    extra_g = jnp.moveaxis(extra_t, 0, 1).reshape(P, steps * 32)

    is16g = syms_g == C.REPEAT_PREVIOUS_CODE_LENGTH
    is17g = syms_g == C.REPEAT_ZERO_CODE_LENGTH
    lit_g = ~(is16g | is17g)
    run = jnp.where(lit_g, 1, extra_g + 3)
    cum = jnp.cumsum(run, axis=1)
    # last item index: first g with cum >= A
    g_last = jnp.sum((cum < A).astype(I32), axis=1)  # [P]
    valid_g = jnp.arange(steps * 32, dtype=I32)[None, :] <= g_last[:, None]

    # repeat-previous value: last literal value before g (init 8)
    gidx = jnp.arange(steps * 32, dtype=I32)[None, :]
    lit_pos = jnp.where(lit_g, gidx, -1)
    last_lit = jax.lax.cummax(lit_pos, axis=1)
    prev_lit = jnp.concatenate(
        [jnp.full((P, 1), -1, I32), last_lit[:, :-1]], axis=1)
    prev_val = jnp.where(
        prev_lit >= 0,
        jnp.take_along_axis(syms_g, jnp.clip(prev_lit, 0, None), axis=1),
        C.INITIAL_REPEATED_CODE_LENGTH)
    val_g = jnp.where(lit_g, syms_g, jnp.where(is16g, prev_val, 0))
    run_valid = jnp.where(valid_g, run, 0)

    # expand runs -> lengths[t] = val of covering item
    cumv = jnp.cumsum(run_valid, axis=1)
    t_idx = jnp.broadcast_to(jnp.arange(A, dtype=I32)[None, :], (P, A))
    item_of_t = jax.vmap(
        lambda cv, t: jnp.searchsorted(cv, t, side="right"))(cumv, t_idx)
    item_of_t = jnp.clip(item_of_t, 0, steps * 32 - 1)
    cplx_lengths = jnp.take_along_axis(val_g, item_of_t, axis=1)

    # reconcile per-lane bit positions: lane s consumed
    # n_s = floor((g_last - s)/32) + 1 real items (0 if g_last < s)
    lanes = jnp.arange(32, dtype=I32)[None, :]
    n_s = jnp.where(g_last[:, None] >= lanes,
                    (g_last[:, None] - lanes) // 32 + 1, 0)
    hist = jnp.concatenate([rle_bp0[None], bp_hist], axis=0)  # [steps+1,P,32]
    hist = jnp.moveaxis(hist, 0, 2)  # [P, 32, steps+1]
    rle_bp_done = jnp.take_along_axis(hist, n_s[:, :, None],
                                      axis=2)[:, :, 0]

    # --- merge branches ---
    out_lengths = jnp.where(m_cplx[:, None],
                            cplx_lengths, lengths[:, :A])
    final_bp = jnp.where(m_cplx[:, None], rle_bp_done, new_bp)
    return out_lengths, trivial_sym, final_bp
