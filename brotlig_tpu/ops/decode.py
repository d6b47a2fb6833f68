"""Batched Brotli-G page decoder on the default JAX device.

Architecture (vs the reference GPU kernel BrotliGCompute.hlsl:1349-1432):

* Phase A — wavefront symbol decode over [pages, 32 lanes]. Each round
  decodes one command per lane (speculatively; lanes past the sentinel
  are rolled back), translates nothing, and decodes the round's literal
  batches — exactly the reference round-robin schedule
  (PageDecoder.cpp:158-236) with the wave intrinsics replaced by masked
  vector ops. Output: dense command arrays + a literal buffer per page.
  Two routes compute it: `_phase_a` (XLA, vectorized over the batch) and
  `phase_a_triton.phase_a_triton` (one Pallas kernel, one program per
  page, compiled through Triton on a GPU).

* Phase B — log-depth LZ77 resolution. The distance ring
  (PageDecoder.cpp:345-404) is a linear recurrence over pushes, resolved by
  pointer doubling with additive deltas; each output byte's source is then
  a copy-chain pointer resolved by a second pointer-doubling pass, and one
  final gather places literals. No serialized byte copies anywhere — the
  approach the parallel-LZ77 literature calls source-chain resolution,
  mapped onto XLA gathers.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..format import constants as C
from . import arith_lut
from .bits import extract_bits, fetch_window, reverse_bits_15
from .tables import build_search, load_table, search_decode

I32 = jnp.int32
NBS = C.NUM_BITSTREAMS


def _flat_decode_window(search, trivial, window15):
    """Symbol decode from an already-extracted 15-bit window.

    Canonical range search: the length comes from 15 compares against
    per-length limits (slice broadcasts, no gather) and only the final
    symbol lookup gathers — from the [P, alphabet] canonical dictionary
    (<=3KB/page) instead of a 2^15 flat table (128KB/page).
    """
    idx = reverse_bits_15(window15).astype(I32)
    sym, ln = search_decode(search, idx, C.HUFFMAN_NUM_CODE_LENGTH,
                            C.HUFFMAN_TABLE_BITS)
    is_triv = (trivial >= 0)[:, None]
    sym = jnp.where(is_triv, trivial[:, None], sym)
    ln = jnp.where(is_triv, 0, ln)
    return sym, ln


LIT_UNROLL = 8  # literal batches decoded per loop iteration (see below)


def _mk_search(lengths):
    return build_search(lengths, C.HUFFMAN_NUM_CODE_LENGTH,
                        C.HUFFMAN_TABLE_BITS)


def _phase_a(words, lane_bp, icp, dist, lit, npostfix, ndirect,
             page_size: int, max_cmds: int):
    """Wavefront command/literal decode. Returns dense command arrays.

    Every loop trip costs several device dispatches, so literal batches
    are unrolled LIT_UNROLL at a time and the common case (a round's
    literals fit one unrolled chunk) runs inline with zero extra loop
    trips.
    """
    P = words.shape[0]
    lane = jnp.arange(NBS, dtype=I32)[None, :]
    max_rounds = (max_cmds + NBS - 1) // NBS
    lit_cap = page_size + 64
    chunk_w = LIT_UNROLL * NBS                    # literals per chunk slot
    # one chunk per round + loop-trip chunks; generous because lockstep
    # trips follow the per-round max across pages
    max_chunks = max_rounds + 4 * (lit_cap // chunk_w) + 2

    icp_s, icp_t = icp
    dist_s, dist_t = dist
    lit_s, lit_t = lit

    # Literal values land in a dense slot buffer via dynamic_update_slice
    # (one contiguous block write per chunk instead of a per-element
    # scatter). Slot chunk c holds the round's literals [256c, 256c+256);
    # per-chunk (queue_start, count) records let a bulk pass compact the
    # slots into the real literal queue afterwards.

    def lit_chunk(j0, bp, cidx, qtail, rlit, slotbuf, ch_start, ch_count):
        """Decode one chunk (LIT_UNROLL batches of 32 literals).

        One 6-word window gather serves the whole chunk: each lane consumes
        <= 15 bits per batch, so 8 batches fit the 192-bit hold
        (31-bit shift + 8*15 + final 15-bit peek = 166 bits): one gather
        instead of eight."""
        win, sh = fetch_window(words, bp, 6)
        delta = jnp.zeros_like(bp)
        batch_syms = []
        for jj in range(LIT_UNROLL):
            j = j0 + jj
            active = (j * NBS + lane) < rlit[:, None]
            window15 = extract_bits(win, sh, delta, 15, 6).astype(I32)
            sym, ln = _flat_decode_window(lit_s, lit_t, window15)
            delta = delta + jnp.where(active, ln, 0)
            batch_syms.append(sym.astype(jnp.uint8))
        bp = bp + delta
        block = jnp.concatenate(batch_syms, axis=1)  # [P, 256]
        slotbuf = jax.lax.dynamic_update_slice(slotbuf, block,
                                               (0, cidx * chunk_w))
        # clamp: when another page forces extra lockstep trips past this
        # page's rlit, record an empty chunk at qtail+rlit to keep the
        # per-page chunk-end sequence monotone for the compaction search
        start = qtail + jnp.minimum(j0 * NBS, rlit)
        count = jnp.clip(rlit - j0 * NBS, 0, chunk_w)
        ch_start = jax.lax.dynamic_update_slice(
            ch_start, start[:, None], (0, cidx))
        ch_count = jax.lax.dynamic_update_slice(
            ch_count, count[:, None], (0, cidx))
        return bp, cidx + 1, slotbuf, ch_start, ch_count

    def lit_batch_body(state):
        j, bp, cidx, qtail, rlit, slotbuf, ch_start, ch_count = state
        bp, cidx, slotbuf, ch_start, ch_count = lit_chunk(
            j, bp, cidx, qtail, rlit, slotbuf, ch_start, ch_count)
        return (j + LIT_UNROLL, bp, cidx, qtail, rlit, slotbuf,
                ch_start, ch_count)

    def lit_batch_cond(state):
        j = state[0]
        rlit = state[4]
        return j * NBS < jnp.max(rlit)

    def round_body(carry):
        (r, bp, done, ncmds, prev_tail, qtail, cidx, slotbuf,
         ch_start, ch_count, ins_a, cpy_a, dcode_a, dextra_a) = carry
        active = ~done

        # --- one mega-window gather covers the whole command per lane:
        # code(<=15) + ins extra(<=24) + cpy extra(<=24) + dist code(<=15)
        # + dist extra(<=30) + intra-word shift(<=31) = 139+31 <= 6*32 bits
        win, sh = fetch_window(words, bp, 6)
        cmd_window = extract_bits(win, sh, 0, 15, 6).astype(I32)
        sym, ln = _flat_decode_window(icp_s, icp_t, cmd_window)
        bp1 = bp + ln
        is_norm = sym < C.NUM_COMMAND_SYMBOLS
        is_sent_like = sym == C.SENTINEL_COMMAND
        is_insonly = sym > C.NUM_COMMAND_SYMBOLS

        ic_norm, cc_norm = arith_lut.split_command(sym)
        inscode = jnp.where(is_insonly, sym - C.NUM_COMMAND_SYMBOLS,
                            jnp.where(is_norm, ic_norm, 0))
        inscode = jnp.clip(inscode, 0, 23)
        copycode = jnp.clip(jnp.where(is_norm, cc_norm, 0), 0, 23)
        ins_bits = jnp.where(is_sent_like, 0,
                             arith_lut.insert_extra(inscode))
        ins_base = jnp.where(is_sent_like, 0,
                             arith_lut.insert_base(inscode))
        cpy_bits = jnp.where(is_norm, arith_lut.copy_extra(copycode), 0)
        cpy_base = jnp.where(is_norm, arith_lut.copy_base(copycode), 0)

        ins_extra = extract_bits(win, sh, ln, ins_bits, 6).astype(I32)
        cpy_extra = extract_bits(win, sh, ln + ins_bits, cpy_bits,
                                 6).astype(I32)
        insert_len = ins_base + ins_extra
        copy_len = cpy_base + cpy_extra
        bp2 = bp1 + ins_bits + cpy_bits
        d_off = ln + ins_bits + cpy_bits

        # --- distance symbol + extra (only commands >= 128) ---
        need_dist = is_norm & (sym >= 128)
        dist_window = extract_bits(win, sh, d_off, 15, 6).astype(I32)
        dsym, dln = _flat_decode_window(dist_s, dist_t, dist_window)
        bp3 = bp2 + jnp.where(need_dist, dln, 0)
        npf = npostfix[:, None]
        ndir = ndirect[:, None]
        is_long = dsym >= (16 + ndir)
        dnb = jnp.where(need_dist & is_long,
                        1 + ((jnp.maximum(dsym - ndir - 16, 0))
                             >> (npf + 1)), 0)
        dnb = jnp.clip(dnb, 0, 30)
        dextra = extract_bits(
            win, sh, d_off + jnp.where(need_dist, dln, 0), dnb,
            6).astype(I32)
        bp4 = bp3 + dnb

        # --- sentinel lane + rollback ---
        k = jnp.min(jnp.where(is_sent_like, lane, NBS), axis=1)  # [P]
        k = jnp.where(active, k, 0)
        valid = active[:, None] & (lane < k[:, None])
        bp_next = jnp.where(valid, bp4,
                            jnp.where(active[:, None] & (lane == k[:, None]),
                                      bp1, bp))

        insert_len = jnp.where(valid, insert_len, 0)
        copy_len = jnp.where(valid, copy_len, 0)
        dcode = jnp.where(valid & need_dist, dsym,
                          jnp.where(valid & is_norm, 0, -1))
        dextra = jnp.where(valid, dextra, 0)

        col0 = r * NBS
        ins_a = jax.lax.dynamic_update_slice(ins_a, insert_len, (0, col0))
        cpy_a = jax.lax.dynamic_update_slice(cpy_a, copy_len, (0, col0))
        dcode_a = jax.lax.dynamic_update_slice(dcode_a, dcode, (0, col0))
        dextra_a = jax.lax.dynamic_update_slice(dextra_a, dextra, (0, col0))
        ncmds = ncmds + jnp.where(active, k, 0)

        # --- literal batches for this round ---
        litcount = jnp.sum(insert_len, axis=1)
        bs = k
        aclit = jnp.maximum(litcount - prev_tail, 0)
        mult = jnp.where(bs > 0, (aclit + bs - 1) // jnp.maximum(bs, 1), 0)
        rlit = jnp.where(active, bs * mult, 0)
        prev_tail = jnp.where(active, rlit + prev_tail - litcount, prev_tail)

        # common case inline: one unrolled chunk covers the whole round
        bp_after, cidx, slotbuf, ch_start, ch_count = lit_chunk(
            jnp.int32(0), bp_next, cidx, qtail, rlit,
            slotbuf, ch_start, ch_count)
        (_, bp_after, cidx, _, _, slotbuf, ch_start,
         ch_count) = jax.lax.while_loop(
            lit_batch_cond, lit_batch_body,
            (jnp.int32(LIT_UNROLL), bp_after, cidx, qtail, rlit,
             slotbuf, ch_start, ch_count))
        qtail = qtail + rlit

        done = done | (active & (k < NBS))
        return (r + 1, bp_after, done, ncmds, prev_tail, qtail, cidx,
                slotbuf, ch_start, ch_count, ins_a, cpy_a, dcode_a,
                dextra_a)

    def round_cond(carry):
        r, _, done, *_ = carry
        return (~jnp.all(done)) & (r < max_rounds)

    init = (
        jnp.int32(0), lane_bp, jnp.zeros((P,), bool),
        jnp.zeros((P,), I32), jnp.zeros((P,), I32), jnp.zeros((P,), I32),
        jnp.int32(0),
        jnp.zeros((P, max_chunks * chunk_w), jnp.uint8),
        jnp.full((P, max_chunks), lit_cap, I32),   # start: lit_cap keeps
        jnp.zeros((P, max_chunks), I32),           # unwritten ends sorted
        jnp.zeros((P, max_cmds), I32), jnp.zeros((P, max_cmds), I32),
        jnp.full((P, max_cmds), -1, I32), jnp.zeros((P, max_cmds), I32),
    )
    (_, _, _, ncmds, _, _, _, slotbuf, ch_start, ch_count, ins_a, cpy_a,
     dcode_a, dextra_a) = jax.lax.while_loop(round_cond, round_body, init)

    # bulk compaction: slot chunks -> dense literal queue. The covering
    # chunk per queue position comes from a scatter-max at the non-empty
    # chunk starts + cummax forward fill (chunk queue-ranges partition the
    # queue, and chunk indices increase with their starts).
    q = jnp.broadcast_to(jnp.arange(lit_cap, dtype=I32)[None, :],
                         (P, lit_cap))
    rows2 = jnp.arange(P, dtype=I32)[:, None]
    chunk_ids = jnp.broadcast_to(
        jnp.arange(max_chunks, dtype=I32)[None, :], (P, max_chunks))
    nonempty = ch_count > 0
    cmark = jnp.zeros((P, lit_cap), I32)
    cpos = jnp.where(nonempty, jnp.clip(ch_start, 0, lit_cap), lit_cap)
    cmark = cmark.at[rows2, cpos].max(chunk_ids, mode="drop")
    chunk_of = jnp.clip(jax.lax.cummax(cmark, axis=1), 0, max_chunks - 1)
    st = jnp.take_along_axis(ch_start, chunk_of, axis=1)
    slot = jnp.clip(chunk_of * chunk_w + (q - st), 0,
                    max_chunks * chunk_w - 1)
    litbuf = jnp.take_along_axis(slotbuf, slot, axis=1)

    return ncmds, litbuf[:, :page_size], ins_a, cpy_a, dcode_a, dextra_a


def _resolve_distances(ins_a, cpy_a, dcode_a, dextra_a, ncmds,
                       npostfix, ndirect, max_cmds: int):
    """Distance-ring resolution via pointer doubling (PageDecoder.cpp:345-404
    semantics). Returns dist [P, N] absolute distances."""
    P, N = dcode_a.shape
    cid = jnp.arange(N, dtype=I32)[None, :]
    valid = cid < ncmds[:, None]
    code = jnp.where(valid, dcode_a, -1)

    npf = npostfix[:, None]
    ndir = ndirect[:, None]
    is_dir = (code >= 16) & (code < 16 + ndir)
    is_long = code >= 16 + ndir
    s = jnp.maximum(code - ndir - 16, 0)
    nbits = 1 + (s >> (npf + 1))
    hcode = s >> npf
    lcode = s & ((1 << npf) - 1)
    offs = ((2 + (hcode & 1)) << nbits) - 4
    long_val = ((offs + dextra_a) << npf) + lcode + ndir + 1
    abs_val = jnp.where(is_dir, code - 15, long_val)

    # ring-relative codes 0..15 -> (depth, delta)
    is_rel = (code >= 0) & (code < 16)
    depth = jnp.where(code < 4, jnp.maximum(code, 0),
                      jnp.where(code < 10, 0, 1))
    d_off = jnp.maximum(code - 4, 0)
    delta_mag = (d_off % 6) // 2 + 1
    delta_sign = jnp.where((code & 1) == 1, 1, -1)
    delta = jnp.where((code >= 4) & (code < 16), delta_sign * delta_mag, 0)

    # push ranks: virtual pushes 0..3 hold the initial ring
    is_push = valid & (code > 0)
    rank = 4 + jnp.cumsum(is_push.astype(I32), axis=1) \
        - is_push.astype(I32)  # exclusive
    ref_push = rank - 1 - depth

    # push number -> command index: the j-th push is the first command
    # whose running push count reaches j+1, found by a log-depth binary
    # search over the monotone prefix; virtual pushes 0..3 map to nodes
    # N..N+3.
    push_cum = jnp.cumsum(is_push.astype(I32), axis=1)
    want = jnp.clip(ref_push - 4, 0, N - 1) + 1
    ref_cmd = jnp.zeros((P, N), I32)       # count of entries < want
    step = 1 << max(0, (N - 1).bit_length() - 1)
    while step:
        probe = jnp.clip(ref_cmd + step - 1, 0, N - 1)
        v = jnp.take_along_axis(push_cum, probe, axis=1)
        ref_cmd = jnp.where((ref_cmd + step <= N) & (v < want),
                            ref_cmd + step, ref_cmd)
        step >>= 1
    ref_cmd = jnp.clip(ref_cmd, 0, N - 1)
    parent = jnp.where(is_rel,
                       jnp.where(ref_push < 4, N + jnp.clip(ref_push, 0, 3),
                                 ref_cmd),
                       cid)  # absolute/no-dist: self-root
    dl = jnp.where(is_rel, delta, 0)

    # node value base (roots): commands with absolute code; virtual ring
    val = jnp.where(is_long | is_dir, abs_val, 0)
    virt = jnp.asarray([16, 15, 11, 4], dtype=I32)
    val = jnp.concatenate([val, jnp.broadcast_to(virt[None, :], (P, 4))],
                          axis=1)
    parent = jnp.concatenate(
        [parent, jnp.arange(N, N + 4, dtype=I32)[None, :]
         + jnp.zeros((P, 4), I32)], axis=1)
    dl = jnp.concatenate([dl, jnp.zeros((P, 4), I32)], axis=1)

    iters = max(1, (N + 4 - 1).bit_length())

    def dbl_body(c):
        i, parent, dl, _ = c
        par_par = jnp.take_along_axis(parent, parent, axis=1)
        dl_par = jnp.take_along_axis(dl, parent, axis=1)
        return i + 1, par_par, dl + dl_par, jnp.any(par_par != parent)

    def dbl_cond(c):
        i, _, _, changed = c
        # ring chains are short (depth <= 3 + small delta hops); exit as
        # soon as doubling reaches a fixed point instead of log2(N) rounds
        return (i < iters) & changed

    _, parent, dl, _ = jax.lax.while_loop(
        dbl_cond, dbl_body,
        (jnp.int32(0), parent, dl, jnp.bool_(True)))

    dist = jnp.take_along_axis(val, parent, axis=1) + dl
    return dist[:, :N]


def _phase_b(ncmds, litbuf, ins_a, cpy_a, dist, page_size: int):
    """Source-chain LZ77 resolution -> output bytes [P, page_size]."""
    P, N = ins_a.shape
    S = page_size
    cov = ins_a + cpy_a
    starts = jnp.cumsum(cov, axis=1) - cov          # exclusive
    lit_starts = jnp.cumsum(ins_a, axis=1) - ins_a  # exclusive

    pos = jnp.broadcast_to(jnp.arange(S, dtype=I32)[None, :], (P, S))
    # covering command per position: scatter each command's index at its
    # start (duplicates from zero-coverage commands resolve to the last,
    # matching searchsorted-right semantics) and forward-fill with cummax —
    # one scatter + one scan instead of a log-depth search over [P, S]
    rows = jnp.arange(P, dtype=I32)[:, None]
    cid = jnp.broadcast_to(jnp.arange(N, dtype=I32)[None, :], (P, N))
    in_cmds = cid < ncmds[:, None]
    mark = jnp.full((P, S), 0, I32)
    scatter_pos = jnp.where(in_cmds, jnp.clip(starts, 0, S), S)
    mark = mark.at[rows, scatter_pos].max(cid, mode="drop")
    cmd_of = jax.lax.cummax(mark, axis=1)
    cmd_of = jnp.clip(cmd_of, 0, N - 1)

    st = jnp.take_along_axis(starts, cmd_of, axis=1)
    ins_c = jnp.take_along_axis(ins_a, cmd_of, axis=1)
    lst = jnp.take_along_axis(lit_starts, cmd_of, axis=1)
    dst = jnp.take_along_axis(dist, cmd_of, axis=1)

    in_insert = pos < st + ins_c
    # copy source with the overlap resolved up front: position p of a copy
    # with distance d reads cstart - d + (p - cstart) % d, which always
    # lands OUTSIDE the copy's own region — so chains only hop across
    # distinct commands and the pointer doubling below converges in a few
    # iterations even for distance-1 runs (depth S chains otherwise)
    cstart = st + ins_c
    d_safe = jnp.maximum(dst, 1)
    src_copy = cstart - d_safe + (pos - cstart) % d_safe
    src = jnp.where(in_insert,
                    S + lst + (pos - st),
                    jnp.clip(src_copy, 0, S - 1))

    iters = max(1, (S - 1).bit_length())

    def chase_body(c):
        i, src = c
        nxt = jnp.take_along_axis(src, jnp.clip(src, 0, S - 1), axis=1)
        return i + 1, jnp.where(src < S, nxt, src)

    def chase_cond(c):
        i, src = c
        # early exit: copy chains usually resolve in far fewer than
        # log2(S) doublings
        return (i < iters) & jnp.any(src < S)

    _, src = jax.lax.while_loop(chase_cond, chase_body, (jnp.int32(0), src))

    lit_idx = jnp.clip(src - S, 0, litbuf.shape[1] - 1)
    out = jnp.take_along_axis(litbuf, lit_idx, axis=1)
    return out


ROUTES = ("xla", "triton")


def _default_platform() -> str:
    # the default device is what jit targets (tests pin it to a CPU device)
    dev = jax.config.jax_default_device or jax.devices()[0]
    return dev if isinstance(dev, str) else dev.platform


def resolve_route(route: str | None = None, interpret: bool = False) -> str:
    """The phase-A route for the default device, chosen explicitly.

    None picks by platform: the Triton kernel on a GPU, the XLA route on a
    CPU; any other platform raises. "triton" runs compiled on a GPU, or
    through the Pallas interpreter on a CPU when interpret=True; asking
    for it otherwise raises rather than falling back to another route."""
    platform = _default_platform()
    if route is None:
        defaults = {"gpu": "triton", "cpu": "xla"}
        if platform not in defaults:
            raise ValueError(f"no decode route for platform {platform!r}")
        route = defaults[platform]
    if route not in ROUTES:
        raise ValueError(f"route={route!r} not in {ROUTES}")
    if route == "xla":
        if interpret:
            raise ValueError("interpret=True applies to the triton route")
    elif interpret and platform != "cpu":
        raise ValueError("the triton route runs compiled on a "
                         f"{platform!r} device, never interpreted")
    elif not interpret and platform != "gpu":
        raise ValueError(f"the triton route needs a GPU, not {platform!r}; "
                         "pass interpret=True to run it through the Pallas "
                         "interpreter")
    return route


def symbol_inputs(words: jnp.ndarray, in_sizes: jnp.ndarray):
    """Headers + the three Huffman tables -> phase-A inputs.

    Returns (lane_bp, icp, dist, lit, npostfix, ndirect, isdelta), where
    icp/dist/lit are (build_search dict, trivial symbol) pairs."""
    from .tables import HEADER_WORDS, narrow_stream_view, \
        parse_page_headers_full
    W = words.shape[1]
    # headers fit the first HEADER_WORDS; tables re-base onto the
    # stream-major view, whose peeks stay inside 8 KB per page
    npostfix, ndirect, isdelta, _, stream_bytes = \
        parse_page_headers_full(words[:, :min(W, HEADER_WORDS)], in_sizes)
    view, vbp0 = narrow_stream_view(words, stream_bytes, 64)
    bp = vbp0
    icp_len, icp_triv, bp = load_table(
        view, bp, C.NUM_COMMAND_SYMBOLS_EFFECTIVE)
    dst_len, dst_triv, bp = load_table(view, bp, C.NUM_DISTANCE_SYMBOLS)
    lit_len, lit_triv, bp = load_table(view, bp, C.NUM_LITERAL_SYMBOLS)
    lane_bp = stream_bytes * 8 + (bp - vbp0)
    return (lane_bp, (_mk_search(icp_len), icp_triv),
            (_mk_search(dst_len), dst_triv), (_mk_search(lit_len), lit_triv),
            npostfix, ndirect, isdelta)


@partial(jax.jit, static_argnames=("page_size", "max_cmds", "route",
                                   "interpret"))
def _stage_symbols(words: jnp.ndarray, in_sizes: jnp.ndarray,
                   page_size: int, max_cmds: int, route: str = "xla",
                   interpret: bool = False):
    """Headers + tables + wavefront symbol decode (Phase A)."""
    lane_bp, icp, dst, lit, npostfix, ndirect, isdelta = symbol_inputs(
        words, in_sizes)
    if route == "triton":
        from .phase_a_triton import phase_a_triton
        phase_a = partial(phase_a_triton, interpret=interpret)
    else:
        phase_a = _phase_a
    ncmds, litbuf, ins_a, cpy_a, dcode_a, dextra_a = phase_a(
        words, lane_bp, icp, dst, lit, npostfix, ndirect, page_size,
        max_cmds)
    # batch-max command count rides along so the caller's bucketing fetch
    # needs no extra reduction dispatch
    return (ncmds, litbuf, ins_a, cpy_a, dcode_a, dextra_a,
            npostfix, ndirect, isdelta, jnp.max(ncmds))


@partial(jax.jit, static_argnums=(8, 9))
def _stage_lz(ncmds, litbuf, ins_a, cpy_a, dcode_a, dextra_a,
              npostfix, ndirect, page_size: int, max_cmds: int):
    """Distance-ring resolution + source-chain LZ77 execution (Phase B)."""
    # The Triton phase A leaves command rows past a page's sentinel
    # unwritten; zero them so phase B's coverage cumsums see the same
    # arrays the XLA phase A produces.
    in_cmds = jnp.arange(ins_a.shape[1], dtype=I32)[None, :] < ncmds[:, None]
    ins_a = jnp.where(in_cmds, ins_a, 0)
    cpy_a = jnp.where(in_cmds, cpy_a, 0)
    dist = _resolve_distances(ins_a, cpy_a, dcode_a, dextra_a, ncmds,
                              npostfix, ndirect, max_cmds)
    return _phase_b(ncmds, litbuf, ins_a, cpy_a, dist, page_size)


@partial(jax.jit, donate_argnums=(0,))
def _plane_scatter(plane, rows_ix, pages):
    """Scatter decoded page rows into the resident output plane IN PLACE:
    the plane is donated, so XLA aliases input and output buffers and the
    update touches only the written rows — without donation every batch
    drain would copy the whole [num_pages, page_size] plane."""
    return plane.at[rows_ix].set(pages, unique_indices=True)


def decode_pages_start(words: jnp.ndarray, in_sizes: jnp.ndarray,
                       page_size: int, max_cmds: int,
                       route: str | None = None, interpret: bool = False):
    """Dispatch phase A for a batch (async). Returns an opaque state for
    decode_pages_finish. Splitting dispatch from finish lets the stream
    loop enqueue batch k+1's phase A before fetching batch k's command
    count, so the bucketing fetch never stalls the device pipeline.

    route / interpret: see resolve_route."""
    route = resolve_route(route, interpret)
    return _stage_symbols(words, in_sizes, page_size, max_cmds, route,
                          interpret)


def decode_pages_finish(state, page_size: int, max_cmds: int):
    """Bucket command arrays by the batch's real peak and run phase B."""
    (ncmds, litbuf, ins_a, cpy_a, dcode_a, dextra_a, npostfix, ndirect,
     isdelta, ncmds_max) = state
    # bucket the command arrays down to the batch's real command count:
    # phase B's searches/gathers scale with this width, and typical pages
    # use a fraction of the worst-case bound
    peak = int(ncmds_max) + 1
    bucket = max_cmds
    for b in (max_cmds // 8, max_cmds // 4, max_cmds // 2):
        if peak <= b:
            bucket = b
            break
    if bucket < max_cmds:
        ins_a = ins_a[:, :bucket]
        cpy_a = cpy_a[:, :bucket]
        dcode_a = dcode_a[:, :bucket]
        dextra_a = dextra_a[:, :bucket]
    out = _stage_lz(ncmds, litbuf, ins_a, cpy_a, dcode_a, dextra_a,
                    npostfix, ndirect, page_size, bucket)
    return out, isdelta


def decode_pages(words: jnp.ndarray, in_sizes: jnp.ndarray,
                 page_size: int, max_cmds: int,
                 route: str | None = None, interpret: bool = False):
    """Decode a batch of compressed (non-raw) pages.

    words: uint32 [P, W]; in_sizes: int32 [P].
    Returns (out [P, page_size] uint8, isdelta [P] int32).

    Phase A runs on `route` (see resolve_route); phase B is the XLA
    source-chain resolution. The two stages stay separately jitted, so
    the command arrays can be bucketed to the batch's real peak between
    them."""
    state = decode_pages_start(words, in_sizes, page_size, max_cmds,
                               route, interpret)
    return decode_pages_finish(state, page_size, max_cmds)


# ---------------------------------------------------------------------------
# Stream-level wrapper
# ---------------------------------------------------------------------------

def _batch_pages(payload: bytes, offsets, sizes, compressed_idx, W):
    P = len(compressed_idx)
    arr = np.zeros((P, W * 4), dtype=np.uint8)
    in_sizes = np.zeros(P, dtype=np.int32)
    for row, i in enumerate(compressed_idx):
        off, sz = int(offsets[i]), int(sizes[i])
        arr[row, :sz] = np.frombuffer(payload, dtype=np.uint8,
                                      count=sz, offset=off)
        in_sizes[row] = sz
    return jnp.asarray(arr.view(np.uint32).reshape(P, W)), \
        jnp.asarray(in_sizes)


def max_cmds_for(page_size: int) -> int:
    n = page_size // 2 + 2
    return (n + NBS - 1) // NBS * NBS


def decode_stream_jax(data: bytes, batch_pages: int = 256,
                      route: str | None = None, feedback=None,
                      return_device: bool = False):
    """Decode a full Brotli-G container on the default JAX device.

    Pages are processed in fixed-size device batches of `batch_pages`
    (padded on the last chunk so every call reuses one compiled program);
    dispatch is async, so host staging of chunk k+1 overlaps device decode
    of chunk k. This is the single-device path for multi-GB bundles
    (BASELINE config 4). route: see resolve_route.

    feedback: optional callable(progress_float_0_100) -> bool, invoked
    after each device batch drains (the decode-side analog of the
    reference's BROTLIG_Feedback_Proc, BrotligDecoder.cpp:318-325);
    returning True aborts with BrotligAborted."""
    from ..format.headers import parse_container

    route = resolve_route(route)
    info = parse_container(data)
    header, dc_params = info.header, info.dc_params
    if header.num_pages == 0:
        return b""
    page_size = header.page_size
    out_size = info.out_size
    offsets, sizes = info.offsets, info.sizes
    page_out_sizes = info.page_out_sizes
    payload = data

    out = bytearray(out_size)
    comp_idx = info.compressed_page_indices()
    # batch similar-cost pages together: the XLA route's round loop runs
    # to the slowest page of its batch
    comp_idx.sort(key=lambda i: int(sizes[i]))

    for i in info.raw_page_indices():
        off = int(offsets[i])
        out[i * page_size: i * page_size + page_out_sizes[i]] = \
            payload[off: off + page_out_sizes[i]]

    if comp_idx:
        W = page_size // 4 + 8
        mc = max_cmds_for(page_size)
        isdelta_pages: set = set()

        drained = [0]
        # Fused-decondition path: decoded pages STAY on device and are
        # scattered into a resident [num_pages, page_size] plane; the delta
        # decode + decondition gather then run on that plane with cached
        # map arrays — no host roundtrip of the uncompressed bytes (ref
        # writes BCn bytes straight from the decode kernel,
        # BrotliGCompute.hlsl:978-1031). Bounded to 1 GiB so config-4
        # multi-GB bundles keep the chunked host assembly.
        fuse_dc = (dc_params is not None
                   and header.num_pages * page_size <= (1 << 30))
        dev_plane = [None]

        def drain(slot):
            group, pages_out, isdelta = slot
            isdelta_np = np.asarray(isdelta)
            for row, i in enumerate(group):
                if isdelta_np[row]:
                    isdelta_pages.add(i)
            if fuse_dc:
                if dev_plane[0] is None:
                    dev_plane[0] = jnp.zeros(
                        (header.num_pages, page_size), jnp.uint8)
                rows_ix = jnp.asarray(np.asarray(group, np.int32))
                dev_plane[0] = _plane_scatter(
                    dev_plane[0], rows_ix, pages_out[: len(group)])
            else:
                pages_np = np.asarray(pages_out)
                for row, i in enumerate(group):
                    out[i * page_size: i * page_size + page_out_sizes[i]] = \
                        pages_np[row, : page_out_sizes[i]].tobytes()
            drained[0] += len(group)
            if feedback is not None:
                from ..format.errors import Aborted
                if feedback(drained[0] * 100.0 / max(len(comp_idx), 1)):
                    raise Aborted("decode aborted by feedback proc")

        # Two-level pipeline: phase-A dispatches run ahead of the bucketing
        # fetch in decode_pages_finish (which blocks on that batch's phase A
        # only), and result drains run behind phase B — so host staging and
        # the per-batch ncmds fetch overlap device decode instead of
        # serializing it.
        # Chunked batches pad the final chunk to batch_pages so one
        # compiled program serves every chunk; dummy rows reuse page 0.
        stage_q: list = []
        finish_q: list = []

        def start_batch(rows):
            # long multi-shape runs (cold test suite, many-archive
            # services) accumulate LLVM-JIT mmap regions until the
            # kernel's vm.max_map_count kills the process; dropping jax's
            # in-process caches here costs one /proc read per batch and
            # recompiles load from disk
            from ..utils import jaxcache as _jc
            _jc.clear_if_bloated()
            words, in_sizes = _batch_pages(payload, offsets, sizes, rows, W)
            return decode_pages_start(words, in_sizes, page_size, mc, route)

        for c0 in range(0, len(comp_idx), batch_pages):
            group = comp_idx[c0: c0 + batch_pages]
            rows = group + [group[0]] * (batch_pages - len(group)) \
                if len(comp_idx) > batch_pages else group
            stage_q.append((group, start_batch(rows)))
            if len(stage_q) > 1:
                g, st = stage_q.pop(0)
                finish_q.append((g, *decode_pages_finish(st, page_size, mc)))
            if len(finish_q) > 2:
                drain(finish_q.pop(0))
        for g, st in stage_q:
            finish_q.append((g, *decode_pages_finish(st, page_size, mc)))
        for slot in finish_q:
            drain(slot)

    if dc_params is not None:
        from .precondition import (postprocess_device,
                                   postprocess_flat_device)
        pages_flagged = isdelta_pages if comp_idx else set()
        if comp_idx and fuse_dc and dev_plane[0] is not None:
            raw_idx = info.raw_page_indices()
            if raw_idx:
                raw_rows = np.zeros((len(raw_idx), page_size), np.uint8)
                for r, i in enumerate(raw_idx):
                    off = int(offsets[i])
                    raw_rows[r, : page_out_sizes[i]] = np.frombuffer(
                        payload, np.uint8, count=page_out_sizes[i],
                        offset=off)
                dev_plane[0] = _plane_scatter(
                    dev_plane[0],
                    jnp.asarray(np.asarray(raw_idx, np.int32)),
                    jnp.asarray(raw_rows))
            flat = dev_plane[0].reshape(-1)[:out_size]
            res = postprocess_flat_device(flat, dc_params, page_size,
                                          pages_flagged)
            if return_device:
                # the deconditioned bytes stay resident so a timed region
                # can end in block_until_ready without a host readback
                return res
            return np.asarray(res).tobytes()
        # host-assembled fallback (multi-GB bundles / raw-only streams)
        return postprocess_device(bytes(out), dc_params, page_size,
                                  pages_flagged)
    return bytes(out[:out_size])
