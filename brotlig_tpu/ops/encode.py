"""Device bulk-greedy LZ77 match finding (the encode-side compute kernel).

The reference encoder's hot loop is sequential Zopfli match finding
(PageEncoder.cpp:87-147). A sequential parse cannot map to wide vectors, so
this is a from-scratch parallel formulation:

1. candidate generation — group equal 4-byte hashes with one stable sort
   per page; each position's candidates are its nearest predecessors in the
   sorted order (bulk gathers, no hash chains);
2. match verification/length — vectorized LCP over 4-byte words with a
   byte-granular tail, capped at MAX_MATCH; distance-1 runs (the RLE case
   the cap would hurt) get exact lengths from a run-length pass;
3. greedy parse — the classic sequential cover becomes log-depth: build
   jump tables step^(2^k) by pointer doubling and list the greedy chain's
   nodes with the orbit-doubling identity node[j + 2^k] = step^(2^k)(node[j]).

Output is dense (ins, cpy, dist) command arrays per page, serialized by the
native packer (native/brotlig_encode.cpp::blg_encode_page_cmds) which owns
distance-ring codes, Huffman tables and the swizzle format.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

I32 = jnp.int32
U32 = jnp.uint32

import os as _os

HASH_MUL = np.uint32(0x1E35A7BD)
HASH_BITS = 16                # 17 bits measured ratio-neutral
MAX_MATCH_WORDS = 16          # LCP probes 64 bytes per round
MIN_MATCH = 4
# quality/speed knob: nearest same-hash predecessors probed per position.
# Measured on the text corpus (hybrid path): K=2 -> 4.50x, 4 -> 4.70x,
# 8 -> 4.99x (native q11 chain search: 6.02x); cost is ~linear in K.
# Default 8 -> 16 since round 2: the reference point is q11
# (quality-first); K=8 closed the device-full text gap by 5.8%
# (86284 -> 81308 B) and K=16 a further 1.8% on text under the DP parse
# (55336 -> 54316 B on the 400 KB A/B; structured/repetitive unchanged —
# their residual is cost-model, not candidates). Deeper DP iteration
# (BLG_DP_ITERS=5) measured neutral-to-worse; keep 3.
NUM_CANDIDATES = int(_os.environ.get("BLG_CANDS", "16"))
EXT_ROUNDS = 3                # contiguous LCP cap = EXT_ROUNDS * 64 bytes
                              # (longer matches chain in log depth below)


def _quads(pages: jnp.ndarray) -> jnp.ndarray:
    """4-byte little-endian word starting at every byte offset [P, S]."""
    b = pages.astype(jnp.uint32)
    q = b
    for k in range(1, 4):
        shifted = jnp.concatenate(
            [b[:, k:], jnp.zeros((b.shape[0], k), jnp.uint32)], axis=1)
        q = q | (shifted << (8 * k))
    return q


def _ctz_bytes(x: jnp.ndarray) -> jnp.ndarray:
    """Number of trailing zero BYTES of a uint32 (4 when x == 0)."""
    b0 = (x & 0xFF) == 0
    b1 = (x & 0xFFFF) == 0
    b2 = (x & 0xFFFFFF) == 0
    b3 = x == 0
    return (b0.astype(I32) + b1.astype(I32) + b2.astype(I32)
            + b3.astype(I32))


def _match_len(quads, pos, cand, limit, words: int = MAX_MATCH_WORDS):
    """LCP of the suffixes at pos/cand in bytes, capped at 4*words.

    quads: [P, S]; pos/cand: [P, S] int32 (cand < pos; cand = -1 -> 0).
    limit: [P, 1] page sizes.
    """
    S = quads.shape[1]
    valid = cand >= 0
    ml = jnp.zeros_like(pos)
    still = valid
    for w in range(words):
        qa = jnp.take_along_axis(quads, jnp.clip(pos + 4 * w, 0, S - 1),
                                 axis=1)
        qb = jnp.take_along_axis(quads, jnp.clip(cand + 4 * w, 0, S - 1),
                                 axis=1)
        x = qa ^ qb
        eq = x == 0
        ml = ml + jnp.where(still, jnp.where(eq, 4, _ctz_bytes(x)), 0)
        still = still & eq
    ml = jnp.minimum(ml, jnp.maximum(limit - pos, 0))
    return jnp.where(valid, ml, 0)


def _match_len_at(quads, cand, limit, off: int,
                  words: int = MAX_MATCH_WORDS):
    """LCP of the suffixes at (iota + off) vs cand, capped at 4*words —
    the winner-verification form of _match_len. The position side reads
    at STATIC offsets iota + off + 4w, which are row shifts instead of
    gathers, halving the full-operand gather scans (the measured
    dominant term of the round-4 matcher, /tmp profile: one 16-word
    _match_len = 32 gather scans, this = 16). Beyond-page garbage
    differs from _match_len's clamp-to-last-word garbage, but both are
    clamped by the same `limit - pos` bound, so post-clamp lengths are
    identical."""
    P, S = quads.shape
    valid = cand >= 0
    iota = jnp.arange(S, dtype=I32)[None, :]
    ml = jnp.zeros((P, S), I32)
    still = valid
    for w in range(words):
        sh = off + 4 * w
        if sh == 0:
            qa = quads
        elif sh >= S:
            qa = jnp.zeros((P, S), quads.dtype)
        else:
            qa = jnp.concatenate(
                [quads[:, sh:], jnp.zeros((P, sh), quads.dtype)], axis=1)
        qb = jnp.take_along_axis(quads, jnp.clip(cand + 4 * w, 0, S - 1),
                                 axis=1)
        x = qa ^ qb
        eq = x == 0
        ml = ml + jnp.where(still, jnp.where(eq, 4, _ctz_bytes(x)), 0)
        still = still & eq
    ml = jnp.minimum(ml, jnp.maximum(limit - (iota + off), 0))
    return jnp.where(valid, ml, 0)


NUM_NEAR = 3        # 4-byte-key candidates exported to the DP parse
NUM_CANDIDATES_8 = 4  # nearest probes in the 8-byte-key family
NUM_NEAR_8 = 2      # 8-byte-key candidates exported to the DP parse
FAST_PROBE_WORDS = 3  # fast tier: candidate ranking LCP cap = 12 bytes

# Probe-rank schedules beyond the nearest 1..nprobe are a MEASURED DEAD
# END (round 3, tools/ab_parse.py): a geometric schedule reaching depth
# 87 made ratio WORSE than the 16 nearest ranks — near-dense candidates
# (cheap distance codes) beat depth reach; do not retry.


def _scan_matches(pages: jnp.ndarray, in_sizes: jnp.ndarray,
                  fast: bool = False, with_tri: bool = False):
    """Shared match scan: longest candidate per position (with run-1 and
    log-depth chain extension) plus the NUM_NEAR nearest-predecessor
    candidates.

    Returns (best_len, best_dist, near_len, near_dist) with near_* shaped
    [P, S, NUM_NEAR] — the k=1..NUM_NEAR (smallest-distance first)
    candidates before the best fold. The DP parse (ops/parse_dp.py)
    relaxes all of them as alternatives (a nearer occurrence has a
    cheaper distance symbol even when shorter); greedy uses only `best`
    (XLA dead-code-eliminates `near` there).

    Candidate verification runs in HASH-SORTED space (round 4): the
    suffix words of every sorted rank are gathered ONCE per word offset
    (qs[w][r] = quads[order[r] + 4w]), after which the rank-k probe's
    LCP is a plain vector compare against the row shifted by k — no
    per-probe gathers at all. The old formulation paid
    nprobe x (probe_words + extension) full-operand gather scans
    (~1900 per batch at the q11 settings, PERF.md round-3 encode
    profile); this one pays probe_words gathers + nprobe x probe_words
    elementwise compares, with only the per-position WINNER getting the
    full position-space LCP + capped extension afterwards.

    fast=True is the q1 speed tier: ranking depth drops to
    FAST_PROBE_WORDS words (12 bytes); exact ranks at 64 bytes.
    """
    P, S = pages.shape
    limit = in_sizes[:, None]
    iota = jnp.broadcast_to(jnp.arange(S, dtype=I32)[None, :], (P, S))

    quads = _quads(pages)
    cap = 4 * MAX_MATCH_WORDS

    def probe_family(h, nprobe, nnear, rank_words):
        """Rank the `nprobe` nearest same-hash predecessors of every
        position by an LCP capped at 4*rank_words bytes; returns
        (best_len, best_dist, near_len, near_dist) in position space,
        near_* capturing probes 1..nnear (smallest distance first).
        Stable sort groups positions by hash in ascending position
        order, so rank r-k IS the k-th nearest predecessor whenever its
        hash matches."""
        order = jnp.argsort(h, axis=1, stable=True).astype(I32)
        h_sorted = jnp.take_along_axis(h, order, axis=1)
        inv = jnp.argsort(order, axis=1, stable=True).astype(I32)
        qs = [jnp.take_along_axis(
            quads, jnp.clip(order + 4 * w, 0, S - 1), axis=1)
            for w in range(rank_words)]
        rem_s = jnp.maximum(limit - order, 0)

        def shift_r(x, k, fill):
            return jnp.concatenate(
                [jnp.full((P, k), fill, x.dtype), x[:, :-k]], axis=1)

        best_len = jnp.zeros((P, S), I32)
        best_dist = jnp.zeros((P, S), I32)
        near_len = jnp.zeros((P, S, nnear), I32) if nnear else None
        near_dist = jnp.zeros((P, S, nnear), I32) if nnear else None
        for k in range(1, nprobe + 1):
            same = h_sorted == shift_r(h_sorted, k, -1)
            cand = shift_r(order, k, 0)
            ml = jnp.zeros((P, S), I32)
            still = same
            for w in range(rank_words):
                x = qs[w] ^ shift_r(qs[w], k, 0)
                ml = ml + jnp.where(
                    still, jnp.where(x == 0, 4, _ctz_bytes(x)), 0)
                still = still & (x == 0)
            ml = jnp.where(same, jnp.minimum(ml, rem_s), 0)
            dist = order - cand
            better = ml > best_len
            if nnear and k <= nnear:
                near_len = near_len.at[:, :, k - 1].set(ml)
                near_dist = near_dist.at[:, :, k - 1].set(
                    jnp.where(ml > 0, dist, 0))
            best_len = jnp.where(better, ml, best_len)
            best_dist = jnp.where(better, dist, best_dist)

        def unsort(x):
            return jnp.take_along_axis(x, inv, axis=1)

        if nnear:
            near_len = jnp.stack(
                [unsort(near_len[:, :, j]) for j in range(nnear)], axis=2)
            near_dist = jnp.stack(
                [unsort(near_dist[:, :, j]) for j in range(nnear)], axis=2)
        else:
            near_len = jnp.zeros((P, S, 0), I32)
            near_dist = jnp.zeros((P, S, 0), I32)
        return unsort(best_len), unsort(best_dist), near_len, near_dist

    rank_words = FAST_PROBE_WORDS if fast else MAX_MATCH_WORDS

    # family 1: 4-byte keys — dense groups, nearest occurrences
    h4 = ((quads * HASH_MUL) >> np.uint32(32 - HASH_BITS)).astype(I32)
    h4 = jnp.where(iota + MIN_MATCH <= limit, h4,
                   (1 << HASH_BITS) + (iota & 0xFF))
    best_len, best_dist, near_len, near_dist = probe_family(
        h4, NUM_CANDIDATES, 0 if fast else NUM_NEAR, rank_words)

    # family 2: 8-byte keys — sparse groups whose nearest members reach
    # far back, standing in for the reference's 256-deep hash chains
    # (PageEncoder.cpp's HQ Zopfli hasher) at log-sort cost
    q_hi = jnp.concatenate(
        [quads[:, 4:], jnp.zeros((P, 4), jnp.uint32)], axis=1)
    h8 = (((quads * HASH_MUL) ^ (q_hi * np.uint32(0x9E3779B1)))
          >> np.uint32(32 - HASH_BITS)).astype(I32)
    h8 = jnp.where(iota + 8 <= limit, h8,
                   (1 << HASH_BITS) + (iota & 0xFF))
    b8_len, b8_dist, n8_len, n8_dist = probe_family(
        h8, NUM_CANDIDATES_8, 0 if fast else NUM_NEAR_8, rank_words)
    far_better = b8_len > best_len
    best_len = jnp.where(far_better, b8_len, best_len)
    best_dist = jnp.where(far_better, b8_dist, best_dist)
    near_len = jnp.concatenate([near_len, n8_len], axis=2)
    near_dist = jnp.concatenate([near_dist, n8_dist], axis=2)

    # one full LCP + capped extension of each position's winner (the
    # ranking above caps at 4*rank_words; chains below go further)
    cand = jnp.where(best_len > 0, iota - best_dist, -1)
    ml = _match_len_at(quads, cand, limit, 0)
    for ext in range(1, EXT_ROUNDS):
        capped = (ml == ext * cap) & (cand >= 0)
        more = _match_len_at(quads,
                             jnp.where(capped, cand + ext * cap, -1),
                             limit, ext * cap)
        ml = ml + jnp.where(capped, more, 0)
    best_len = ml

    # distance-1 runs: exact lengths (uncapped) for byte repeats
    b = pages.astype(I32)
    prev_b = jnp.concatenate([jnp.full((P, 1), -1, I32), b[:, :-1]], axis=1)
    eq = (b == prev_b) & (iota < limit)
    # next position where eq is False, scanning right (suffix min of flips)
    flip = jnp.where(~eq, iota, S)
    next_flip = jax.lax.cummin(flip[:, ::-1], axis=1)[:, ::-1]
    run_len = jnp.where(eq, next_flip - iota, 0)
    run_len = jnp.minimum(run_len, jnp.maximum(limit - iota, 0))
    better = run_len > best_len
    best_len = jnp.where(better, run_len, best_len)
    best_dist = jnp.where(better, 1, best_dist)

    # unbounded match extension in log depth: a match capped at
    # capmax = EXT_ROUNDS*64 bytes whose continuation position holds a
    # full-cap match at the SAME distance is one contiguous match of both
    # (s[i..i+c) == s[i-d..) and s[i+c..i+2c) == s[i+c-d..) compose).
    # Chain lengths come from pointer doubling over stride capmax, so
    # multi-KB matches (big repetitive wins) cost ~log2(S/capmax) gathers
    # instead of one _match_len sweep per 64-byte block.
    capmax = (EXT_ROUNDS - 1) * cap + cap  # == EXT_ROUNDS * cap
    d_pad = jnp.concatenate([best_dist, jnp.zeros((P, 1), I32)], axis=1)
    l_pad = jnp.concatenate([best_len, jnp.zeros((P, 1), I32)], axis=1)
    nxt_i = jnp.minimum(iota + capmax, S)
    cont = ((best_len == capmax)
            & (jnp.take_along_axis(d_pad, nxt_i, axis=1) == best_dist)
            & (jnp.take_along_axis(l_pad, nxt_i, axis=1) > 0))
    cnt = cont.astype(I32)
    link = jnp.where(cont, nxt_i, S)
    nblocks = (S + capmax - 1) // capmax
    for _ in range(max(1, (nblocks - 1).bit_length())):
        cnt_pad = jnp.concatenate([cnt, jnp.zeros((P, 1), I32)], axis=1)
        cnt = cnt + jnp.take_along_axis(cnt_pad, link, axis=1)
        link_ext = jnp.concatenate([link, jnp.full((P, 1), S, I32)], axis=1)
        link = jnp.take_along_axis(link_ext, link, axis=1)
    term = jnp.minimum(iota + capmax * cnt, S)
    tail_len = jnp.take_along_axis(l_pad, term, axis=1)
    ext_len = capmax * cnt + tail_len
    chained = cnt > 0
    best_len = jnp.where(chained, ext_len, best_len)
    best_len = jnp.minimum(best_len, jnp.maximum(limit - iota, 0))
    near_len = jnp.minimum(near_len,
                           jnp.maximum(limit - iota, 0)[:, :, None])

    # family 3 (DP only): 3-byte keys, the len-2/3 short-copy candidates
    # the 4-byte families cannot see. Short copies at small distances pay
    # under the searched ndirect / ring offset codes (the native round-5
    # 3-gram probe's device twin); LCP cap 8 bytes — longer matches are
    # the other families' job. Hash collisions are harmless: the ranking
    # LCP counts real bytes, so false pairs gate out at < 2.
    if with_tri and not fast:
        b0 = pages.astype(jnp.uint32)
        tri = b0
        for k in range(1, 3):
            tri = tri | (jnp.concatenate(
                [b0[:, k:], jnp.zeros((P, k), jnp.uint32)], axis=1)
                << (8 * k))
        h3 = ((tri * np.uint32(0x9E3779B1))
              >> np.uint32(32 - HASH_BITS)).astype(I32)
        h3 = jnp.where(iota + 3 <= limit, h3,
                       (1 << HASH_BITS) + (iota & 0xFF))
        _, _, t_len, t_dist = probe_family(h3, 2, 2, 2)
        t_len = jnp.where(t_len >= 2, t_len, 0)
        t_len = jnp.minimum(t_len, jnp.maximum(limit - iota, 0)[:, :, None])
        return best_len, best_dist, near_len, near_dist, (t_len, t_dist)
    return best_len, best_dist, near_len, near_dist


@partial(jax.jit, static_argnums=(2,))
def find_candidates(pages: jnp.ndarray, in_sizes: jnp.ndarray, cap: int):
    """Per-position match candidates for the DP parse: slot 0 = longest,
    then the nearest 4/8-byte-key predecessors (smallest distance
    first), then two 3-byte-key channels whose len-2/3 short copies only
    the DP can price (gated at >= 2 instead of MIN_MATCH). Lengths
    clipped to `cap` (the DP's relaxation window). Returns
    (cand_len, cand_dist) [P, S, K] int32."""
    best_len, best_dist, near_len, near_dist, (t_len, t_dist) = \
        _scan_matches(pages, in_sizes, with_tri=True)
    cand_len = jnp.concatenate(
        [jnp.minimum(best_len, cap)[:, :, None],
         jnp.minimum(near_len, cap)], axis=2)
    cand_dist = jnp.concatenate(
        [best_dist[:, :, None], near_dist], axis=2)
    cand_len = jnp.where(cand_len >= MIN_MATCH, cand_len, 0)
    cand_len = jnp.concatenate([cand_len, jnp.minimum(t_len, cap)], axis=2)
    cand_dist = jnp.concatenate([cand_dist, t_dist], axis=2)
    return cand_len, cand_dist


@partial(jax.jit, static_argnums=(2, 3))
def find_commands(pages: jnp.ndarray, in_sizes: jnp.ndarray, max_cmds: int,
                  fast: bool = False):
    """Bulk-greedy LZ77 over a batch of pages.

    pages: uint8 [P, S]; in_sizes: int32 [P].
    Returns (ins, cpy, dist [P, max_cmds] int32, ncmds [P]) — commands cover
    a prefix of each page; the remaining tail is the caller's insert-only
    command.
    """
    P, S = pages.shape
    limit = in_sizes[:, None]
    iota = jnp.broadcast_to(jnp.arange(S, dtype=I32)[None, :], (P, S))
    best_len, best_dist, _, _ = _scan_matches(pages, in_sizes, fast)

    # (measured: brotli-style distance gates and 1-byte lazy matching both
    # LOWER the packed ratio here — the native packer's entropy coding
    # makes even minimal far matches profitable, and lazy's extra literals
    # cost more than the longer match saves. Keep plain greedy.)
    taken = (best_len >= MIN_MATCH) & (iota + best_len <= limit)

    # next taken match start at or after i (suffix min over masked iota);
    # the greedy orbit jumps match start -> match start, so literal runs
    # cost no orbit nodes (listing positions instead truncated coverage at
    # max_cmds BYTES on literal-heavy pages)
    taken_pos = jnp.where(taken, iota, S)
    nxt = jax.lax.cummin(taken_pos[:, ::-1], axis=1)[:, ::-1]
    nxt_pad = jnp.concatenate([nxt, jnp.full((P, 1), S, I32)], axis=1)
    # step over matches: from a match at i the next command starts at the
    # first match position >= i + len; sentinel S is a fixed point
    step = jnp.take_along_axis(nxt_pad,
                               jnp.clip(iota + best_len, 0, S), axis=1)
    step_pad = jnp.concatenate([step, jnp.full((P, 1), S, I32)], axis=1)

    # jump doubling + orbit listing: node[j + 2^k] = step^(2^k)(node[j]),
    # over the padded index space [0, S] so the sentinel saturates
    levels = max(1, (max_cmds - 1).bit_length())
    nodes = jnp.concatenate(
        [nxt[:, :1], jnp.zeros((P, (1 << levels) - 1), I32)], axis=1)
    jk = step_pad
    size = 1
    for k in range(levels):
        nxt_nodes = jnp.take_along_axis(jk, nodes[:, :size], axis=1)
        nodes = jax.lax.dynamic_update_slice(nodes, nxt_nodes, (0, size))
        jk = jnp.take_along_axis(jk, jnp.minimum(jk, S), axis=1)
        size *= 2

    nodes = nodes[:, :max_cmds]
    node_match = nodes < jnp.minimum(limit, S)
    node_len = jnp.take_along_axis(best_len, jnp.clip(nodes, 0, S - 1),
                                   axis=1)
    node_dist = jnp.take_along_axis(best_dist, jnp.clip(nodes, 0, S - 1),
                                    axis=1)

    # every listed node is a match command already (monotone by
    # construction); just count them
    ncmds = jnp.sum(node_match.astype(I32), axis=1)
    in_range = jnp.arange(max_cmds, dtype=I32)[None, :] < ncmds[:, None]
    cmd_pos = jnp.where(in_range, nodes, 0)
    cmd_len = jnp.where(in_range, node_len, 0)
    cmd_dist = jnp.where(in_range, node_dist, 0)

    prev_end = jnp.concatenate(
        [jnp.zeros((P, 1), I32), (cmd_pos + cmd_len)[:, :-1]], axis=1)
    ins = jnp.where(in_range, cmd_pos - prev_end, 0)
    cpy = jnp.where(in_range, cmd_len, 0)
    dist = jnp.where(in_range, cmd_dist, 0)
    return ins, cpy, dist, ncmds


# ---------------------------------------------------------------------------
# Stream-level wrapper: device match finding + native serialization
# ---------------------------------------------------------------------------

def encode_stream_device(data: bytes, page_size: int = 65536,
                         batch_pages: int = 64, dc_params=None,
                         feedback=None) -> bytes:
    """Compress a container with device bulk match finding.

    The LZ77 parse (the encode hot loop) runs batched on the device; the
    per-page entropy coding and swizzle serialization run in the native C++
    packer. Ratio is slightly below the CPU path (greedy, 64-byte match cap
    except runs) — see ops/encode.py docstring. `dc_params` enables BCn
    preconditioning (condition gather + delta on device).

    feedback(msg_type, text) -> bool is called once per device batch;
    returning True aborts with errors.Aborted (the device-path analog of the
    reference's BROTLIG_Feedback_Proc)."""
    from ..format import constants as C
    from ..format.errors import Aborted, MessageType
    from ..format.headers import (PreconditionHeader, StreamHeader,
                                  pack_page_table)
    from .. import native

    if not (C.MIN_PAGE_SIZE <= page_size <= C.MAX_PAGE_SIZE):
        raise ValueError("page size out of range")
    precondition = dc_params is not None and dc_params.precondition
    if precondition and not dc_params.initialize(len(data)):
        precondition = False  # geometry mismatch: downgrade (ref behavior)
    header = StreamHeader.for_input(len(data), page_size, precondition)
    if len(data) == 0:
        return header.pack()
    num_pages = header.num_pages
    max_cmds = page_size // 2 + 2

    raw_form = data
    isdelta_flags = [False] * num_pages
    if precondition:
        from .precondition import preprocess_device
        raw_form, work, isdelta_flags = preprocess_device(
            data, dc_params, page_size)
    else:
        work = data

    pages_out = []
    for c0 in range(0, num_pages, batch_pages):
        group = list(range(c0, min(c0 + batch_pages, num_pages)))
        Pb = len(group)
        arr = np.zeros((Pb, page_size), dtype=np.uint8)
        sizes = np.zeros(Pb, dtype=np.int32)
        for row, i in enumerate(group):
            chunk = work[i * page_size: (i + 1) * page_size]
            arr[row, : len(chunk)] = np.frombuffer(chunk, np.uint8)
            sizes[row] = len(chunk)
        ins, cpy, dist, ncmds = find_commands(
            jnp.asarray(arr), jnp.asarray(sizes), max_cmds)
        ins_n = np.asarray(ins)
        cpy_n = np.asarray(cpy)
        dist_n = np.asarray(dist)
        nc_n = np.asarray(ncmds)

        def pack(row_i):
            row, i = row_i
            n = int(sizes[row])
            k = int(nc_n[row])
            blob = native.encode_page_cmds(
                arr[row, :n].tobytes(), i == num_pages - 1,
                ins_n[row, :k], cpy_n[row, :k], dist_n[row, :k],
                isdelta=isdelta_flags[i])
            if len(blob) == n:
                # raw fallback stores the non-delta conditioned bytes
                blob = raw_form[i * page_size: i * page_size + n]
            return blob

        # native packing is page-parallel (the device matcher is async, so
        # the next batch's match finding overlaps this packing)
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor() as ex:
            pages_out.extend(ex.map(pack, list(enumerate(group))))
        if feedback is not None and feedback(
                MessageType.PROGRESS,
                f"pages {len(pages_out)}/{num_pages}"):
            raise Aborted("encode aborted by feedback callback")

    out = bytearray()
    out += header.pack()
    if precondition:
        out += PreconditionHeader(
            swizzled=dc_params.swizzle,
            pitch_d3d12_aligned=dc_params.pitch_d3d12_aligned,
            width_in_blocks=dc_params.width_in_blocks[0],
            height_in_blocks=dc_params.height_in_blocks[0],
            data_format=dc_params.format,
            num_mips=dc_params.num_mip_levels,
            pitch_in_bytes=dc_params.pitch_in_bytes[0],
        ).pack()
    out += pack_page_table([len(p) for p in pages_out])
    for p in pages_out:
        out += p
    return bytes(out)
