"""Phase-A symbol decode as one Pallas kernel compiled through Triton.

One program decodes one page with 32 lanes, lane s reading sub-bitstream
s — the reference decoder's one-wave-per-page shape
(BrotliGCompute.hlsl:1349-1432). Each lane keeps its bit cursor in
registers and the whole round loop runs inside the kernel: a round decodes
one command per lane (lanes past the sentinel are rolled back), then the
round's literal batches. Symbols are found by canonical range search in
the per-page dictionaries that `tables.build_search` makes; only the final
symbol lookup reads memory.

It is a drop-in for `decode._phase_a`: same inputs, same outputs
(ncmds, litbuf, ins_a, cpy_a, dcode_a, dextra_a). Command rows past a
page's `ncmds` and literal slots past its literal count are left
unwritten; `decode._stage_lz` masks both.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from ..format import constants as C
from . import arith_lut

I32 = jnp.int32
U32 = jnp.uint32
NBS = C.NUM_BITSTREAMS
WIN = 6           # words fetched per lane: one command needs <= 170 bits
LIT_UNROLL = 8    # literal batches per window (8 x 15 + 31 + 15 <= 192)
L16 = 16          # code lengths 1..16 held as one power-of-two vector
_NEVER = 1 << 30  # limit that no 15-bit window reaches


def pack_search(search):
    """build_search dict -> (limit [P,16], rank_base [P,16], symdict).

    limit[:, l-1] is the first window of codes longer than l (l = 1..15);
    rank_base[:, l-1] = offset[l] - first[l], so a window of length l
    decodes to rank rank_base + (window >> (15 - l))."""
    lim = search["limit"][:, 1:L16]
    lim = jnp.concatenate(
        [lim, jnp.full((lim.shape[0], 1), _NEVER, I32)], axis=1)
    base = (search["offset"] - search["first"])[:, 1:L16 + 1]
    return lim.astype(I32), base.astype(I32), search["symdict"]


def _rev15(v):
    v = v.astype(U32)
    v = ((v & 0x5555) << 1) | ((v >> 1) & 0x5555)
    v = ((v & 0x3333) << 2) | ((v >> 2) & 0x3333)
    v = ((v & 0x0F0F) << 4) | ((v >> 4) & 0x0F0F)
    v = ((v & 0x00FF) << 8) | ((v >> 8) & 0x00FF)
    return (v >> 1).astype(I32)


def _extract(win, sh, delta, n):
    """n (<= 30) bits at bit offset sh + delta of a lane's fetched window."""
    off = sh + delta
    widx = off >> 5
    b = (off & 31).astype(U32)
    w0, w1 = win[0], win[1]
    for k in range(1, WIN):
        sel = widx == k
        w0 = jnp.where(sel, win[k], w0)
        w1 = jnp.where(sel, win[k + 1] if k + 1 < WIN else U32(0), w1)
    # (w1 << 1) << (31 - b) never shifts by the full word width
    hi = jnp.where(b == 0, U32(0), (w1 << U32(1)) << (U32(31) - b))
    mask = (U32(1) << jnp.asarray(n).astype(U32)) - U32(1)
    return ((w0 >> b) | hi) & mask


def _kernel(words_ref, bp_ref, npf_ref, ndir_ref,
            icp_lim, icp_base, icp_sd, icp_tr,
            dst_lim, dst_base, dst_sd, dst_tr,
            lit_lim, lit_base, lit_sd, lit_tr,
            ncmds_ref, litbuf_ref, ins_ref, cpy_ref, dcode_ref, dextra_ref,
            *, page_size: int, max_cmds: int):
    p = pl.program_id(0)
    W = words_ref.shape[1]
    lane = jnp.arange(NBS, dtype=I32)
    l16 = jnp.arange(1, L16 + 1, dtype=I32)
    max_rounds = (max_cmds + NBS - 1) // NBS
    lit_cap = page_size + 64

    def table(lim_ref, base_ref, sd_ref, tr_ref):
        return (lim_ref[p, :], base_ref[p, :], sd_ref, tr_ref[p],
                sd_ref.shape[1])

    icp = table(icp_lim, icp_base, icp_sd, icp_tr)
    dst = table(dst_lim, dst_base, dst_sd, dst_tr)
    lit = table(lit_lim, lit_base, lit_sd, lit_tr)
    npf = npf_ref[p]
    ndir = ndir_ref[p]

    def fetch(bp):
        wi = bp >> 5
        win = [words_ref[p, jnp.minimum(jnp.maximum(wi + k, 0), W - 1)]
               for k in range(WIN)]
        return win, bp & 31

    def decode(tab, window15):
        lim, base, sd_ref, triv, A = tab
        idx = _rev15(window15)
        length = 1 + jnp.sum((idx[:, None] >= lim[None, :]).astype(I32),
                             axis=1)
        rb = jnp.sum(jnp.where(length[:, None] == l16[None, :],
                               base[None, :], 0), axis=1)
        code = jnp.where(length > 15, 0,
                         idx >> jnp.maximum(15 - length, 0))
        rank = jnp.minimum(jnp.maximum(rb + code, 0), A - 1)
        sym = sd_ref[p, rank]
        is_triv = triv >= 0
        return jnp.where(is_triv, triv, sym), jnp.where(is_triv, 0, length)

    def lit_loop(bp, qtail, rlit):
        def cond(c):
            j, _ = c
            return (j * NBS < rlit) & (qtail + j * NBS < lit_cap)

        def body(c):
            j, bp = c
            win, sh = fetch(bp)
            delta = jnp.zeros_like(bp)
            for jj in range(LIT_UNROLL):
                q = (j + jj) * NBS + lane
                act = q < rlit
                w15 = _extract(win, sh, delta, 15).astype(I32)
                sym, ln = decode(lit, w15)
                delta = delta + jnp.where(act, ln, 0)
                pos = qtail + q
                ok = act & (pos < page_size)
                plt.store(litbuf_ref.at[p, jnp.minimum(pos, page_size - 1)],
                          sym.astype(jnp.uint8), mask=ok)
            return j + LIT_UNROLL, bp + delta

        return jax.lax.while_loop(cond, body, (jnp.int32(0), bp))[1]

    def round_body(carry):
        r, bp, _, ncmds, prev_tail, qtail = carry
        win, sh = fetch(bp)
        sym, ln = decode(icp, _extract(win, sh, 0, 15).astype(I32))
        bp1 = bp + ln
        is_norm = sym < C.NUM_COMMAND_SYMBOLS
        is_sent = sym == C.SENTINEL_COMMAND
        is_insonly = sym > C.NUM_COMMAND_SYMBOLS

        ic_norm, cc_norm = arith_lut.split_command(sym)
        inscode = jnp.where(is_insonly, sym - C.NUM_COMMAND_SYMBOLS,
                            jnp.where(is_norm, ic_norm, 0))
        inscode = jnp.minimum(jnp.maximum(inscode, 0), 23)
        copycode = jnp.minimum(jnp.maximum(
            jnp.where(is_norm, cc_norm, 0), 0), 23)
        ins_bits = jnp.where(is_sent, 0, arith_lut.insert_extra(inscode))
        ins_base = jnp.where(is_sent, 0, arith_lut.insert_base(inscode))
        cpy_bits = jnp.where(is_norm, arith_lut.copy_extra(copycode), 0)
        cpy_base = jnp.where(is_norm, arith_lut.copy_base(copycode), 0)
        insert_len = ins_base + _extract(win, sh, ln, ins_bits).astype(I32)
        copy_len = cpy_base + _extract(
            win, sh, ln + ins_bits, cpy_bits).astype(I32)
        d_off = ln + ins_bits + cpy_bits

        need_dist = is_norm & (sym >= 128)
        dsym, dln = decode(dst, _extract(win, sh, d_off, 15).astype(I32))
        dln = jnp.where(need_dist, dln, 0)
        is_long = dsym >= 16 + ndir
        dnb = jnp.where(need_dist & is_long,
                        1 + (jnp.maximum(dsym - ndir - 16, 0) >> (npf + 1)),
                        0)
        dnb = jnp.minimum(jnp.maximum(dnb, 0), 30)
        dextra = _extract(win, sh, d_off + dln, dnb).astype(I32)
        bp4 = bp1 + ins_bits + cpy_bits + dln + dnb

        # sentinel lane + rollback: lanes past it keep their cursor
        k = jnp.min(jnp.where(is_sent, lane, NBS))
        valid = lane < k
        bp_next = jnp.where(valid, bp4, jnp.where(lane == k, bp1, bp))
        insert_len = jnp.where(valid, insert_len, 0)
        col = r * NBS + lane
        plt.store(ins_ref.at[p, col], insert_len)
        plt.store(cpy_ref.at[p, col], jnp.where(valid, copy_len, 0))
        plt.store(dcode_ref.at[p, col],
                  jnp.where(valid & need_dist, dsym,
                            jnp.where(valid & is_norm, 0, -1)))
        plt.store(dextra_ref.at[p, col], jnp.where(valid, dextra, 0))

        # literal batches: rlit literals, round-robin over the 32 lanes,
        # rounded up to a multiple of the round's command count
        litcount = jnp.sum(insert_len)
        aclit = jnp.maximum(litcount - prev_tail, 0)
        rlit = jnp.where(k > 0, k * ((aclit + k - 1) // jnp.maximum(k, 1)),
                         0)
        prev_tail = rlit + prev_tail - litcount
        bp_next = lit_loop(bp_next, qtail, rlit)
        return (r + 1, bp_next, k < NBS, ncmds + k, prev_tail,
                qtail + rlit)

    def round_cond(carry):
        r, _, done, *_ = carry
        return jnp.logical_not(done) & (r < max_rounds)

    init = (jnp.int32(0), bp_ref[p, :], jnp.bool_(False), jnp.int32(0),
            jnp.int32(0), jnp.int32(0))
    ncmds = jax.lax.while_loop(round_cond, round_body, init)[3]
    ncmds_ref[p] = ncmds


def phase_a_triton(words, lane_bp, icp, dist, lit, npostfix, ndirect,
                   page_size: int, max_cmds: int, interpret: bool = False):
    """Drop-in for decode._phase_a (one program per page, Triton route).

    icp/dist/lit are (build_search dict, trivial symbol [P]) pairs, as
    _phase_a takes them. interpret=True runs the kernel through the Pallas
    interpreter (CPU tests); otherwise it is compiled for the GPU.

    max_cmds must be a multiple of 32: each round stores one full row of
    32 command slots unmasked, so that keeps every store in bounds."""
    if max_cmds % NBS:
        raise ValueError(f"max_cmds={max_cmds} is not a multiple of {NBS}")
    P = words.shape[0]
    tabs = []
    for search, trivial in (icp, dist, lit):
        tabs += [*pack_search(search), trivial.astype(I32)]
    out_shape = (
        jax.ShapeDtypeStruct((P,), I32),
        jax.ShapeDtypeStruct((P, page_size), jnp.uint8),
        *[jax.ShapeDtypeStruct((P, max_cmds), I32)] * 4,
    )
    kernel = partial(_kernel, page_size=page_size, max_cmds=max_cmds)
    return pl.pallas_call(
        kernel, out_shape=out_shape, grid=(P,), backend="triton",
        interpret=interpret, name="phase_a_triton",
        compiler_params=plt.CompilerParams(num_warps=1, num_stages=1),
    )(words, lane_bp.astype(I32), npostfix.astype(I32),
      ndirect.astype(I32), *tabs)
