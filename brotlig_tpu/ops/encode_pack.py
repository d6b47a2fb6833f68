"""Fully-device Brotli-G page serialization (the encode_pack kernel).

Completes the device encode pipeline (SURVEY §7 step 4): given bulk-greedy
commands (ops/encode.py::find_commands), this packs whole compressed pages
on the device — histograms, prefix codes, the exact 32-lane round-robin
schedule and the self-describing size table — with no sequential bit
writing anywhere:

* code lengths: ceil(-log2 p) is prefix-free by construction (2^-L <= p
  sums below 1), so no Huffman tree walk is needed; a bounded widen loop
  absorbs the rare depth-15 clip overflow;
* tables are stored like the reference encoder stores them
  (BrotligHuffman.cpp:262-363): trivial / simple / complex mode chosen
  per page, complex tables run-coded with the exact reference RLE
  splitting (codes 16/17, _rle_items). Item counts are data-dependent
  but bounded by the alphabet, so the emission block keeps a static
  shape with per-item validity — item j rides stream j%32, matching the
  decoder's speculative lane ownership;
* the literal interleave follows R_k = 32*ceil(cumlit_k/32) — the
  prev_tail recurrence (PageEncoder.cpp:518-522) has this closed form for
  full rounds, proven by induction;
* bit packing: every emission (<=30 bits) contributes to at most two
  32-bit words; per-stream word values come from a wraparound-safe
  prefix-sum-and-difference over the sorted contributions, not scatters.

Decoded by all four decoders (oracle, native, device, and the reference SDK's
own decoder in tools/reference_oracle).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..format import constants as C
from . import arith_lut

I32 = jnp.int32
U32 = jnp.uint32
NBS = 32

A_CMD = C.NUM_COMMAND_SYMBOLS_EFFECTIVE  # 728
A_DST = C.NUM_DISTANCE_SYMBOLS           # 544
A_LIT = C.NUM_LITERAL_SYMBOLS            # 256
CL_ORDER = (1, 2, 3, 4, 0, 5, 17, 6, 16, 7, 8, 9, 10, 11, 12, 13, 14, 15)


def _rev_bits(v, n):
    """Bit-reverse the low `n` bits; n is a per-element array (<=15)."""
    v = v.astype(U32)
    r = jnp.zeros_like(v)
    for i in range(15):
        r = r | (jnp.where(i < n, (v >> i) & 1, 0)
                 << jnp.maximum(n - 1 - i, 0).astype(U32))
    return r.astype(I32)


def _lengths_from_hist(hist, total):
    """Kraft-safe code lengths: ceil(log2(total/count)) clipped to [1,15].

    hist: [P, A] int32; total: [P] (>0 where any symbol used).
    """
    P, A = hist.shape
    t = jnp.maximum(total, 1)[:, None]
    # ceil(log2(t/c)) = bitlength(ceil(t/c) - 1)
    ratio = (t + jnp.maximum(hist, 1) - 1) // jnp.maximum(hist, 1)
    bl = jnp.zeros((P, A), I32)
    x = jnp.maximum(ratio - 1, 0)
    for s in (16, 8, 4, 2, 1):
        take = (x >> s) > 0
        bl = bl + jnp.where(take, s, 0)
        x = jnp.where(take, x >> s, x)
    bl = bl + (x > 0)
    lens = jnp.clip(bl, 1, 15)
    lens = jnp.where(hist > 0, lens, 0)
    # widen until Kraft holds (clip at 15 can overflow the budget)
    for _ in range(15):
        units = jnp.where(lens > 0, jnp.int32(1) << (15 - lens), 0)
        over = jnp.sum(units, axis=1) > (1 << 15)
        lens = jnp.where(over[:, None] & (lens > 0),
                         jnp.minimum(lens + 1, 15), lens)
    # refine: ceil(-log2 p) wastes up to 1 bit/symbol; hand the remaining
    # Kraft slack to the most frequent symbols. Vectorized prefix
    # allocation (round 5): ONE sort by count, then each pass shortens
    # the count-ordered prefix whose cumulative widening cost fits the
    # slack — ~40 ops instead of the 48-pick argmax loop's ~1800 (the
    # serializer's single largest op-count block). A symbol can shorten
    # once per
    # pass, so repeats recover the old loop's multi-shortenings.
    units = jnp.where(lens > 0, jnp.int32(1) << (15 - lens), 0)
    slack = (1 << 15) - jnp.sum(units, axis=1)
    order = jnp.argsort(-jnp.where(hist > 0, hist, -1), axis=1,
                        stable=True)
    inv = jnp.argsort(order, axis=1, stable=True)
    hist_s = jnp.take_along_axis(hist, order, axis=1)
    for _ in range(3):
        elig = (lens > 1) & (hist > 0)
        cost = jnp.where(elig, jnp.int32(1) << (15 - jnp.clip(lens, 1, 15)),
                         0)
        cost_s = jnp.take_along_axis(cost, order, axis=1)
        elig_s = jnp.take_along_axis(elig.astype(I32), order, axis=1) > 0
        cum = jnp.cumsum(cost_s, axis=1)
        pay_s = elig_s & (cum <= slack[:, None]) & (hist_s > 0)
        slack = slack - jnp.sum(jnp.where(pay_s, cost_s, 0), axis=1)
        pay = jnp.take_along_axis(pay_s.astype(I32), inv, axis=1)
        lens = lens - pay
    return lens


def _canonical_codes(lens):
    """Canonical MSB codes per symbol (assigned in symbol order per length),
    returned bit-reversed for LSB-first writing. lens: [P, A]."""
    P, A = lens.shape
    counts = []
    for l in range(16):
        counts.append(jnp.sum(lens == l, axis=1))
    counts = jnp.stack(counts, axis=1)
    counts = counts.at[:, 0].set(0)
    first = [jnp.zeros((P,), I32)]
    for l in range(1, 16):
        first.append((first[l - 1] + counts[:, l - 1]) << 1)
    first = jnp.stack(first, axis=1)  # [P, 16]
    # rank of each symbol within its length class
    rank = jnp.zeros((P, A), I32)
    for l in range(1, 16):
        m = (lens == l).astype(I32)
        rank = rank + jnp.where(lens == l,
                                jnp.cumsum(m, axis=1) - 1, 0)
    code = jnp.take_along_axis(first, jnp.clip(lens, 0, 15), axis=1) + rank
    return _rev_bits(code, lens), code


def _histogram(values, valid, alphabet):
    """Sorted-values histogram [P, A]; values int32, valid bool (same shape).

    Invalid entries are mapped to `alphabet` and dropped.
    """
    P = values.shape[0]
    v = jnp.where(valid, values, alphabet)
    sv = jnp.sort(v, axis=1)
    bounds = jnp.broadcast_to(
        jnp.arange(alphabet + 1, dtype=I32)[None, :], (P, alphabet + 1))
    lo = jax.vmap(lambda a, b: jnp.searchsorted(a, b, side="left"))(sv,
                                                                    bounds)
    return (lo[:, 1:] - lo[:, :-1]).astype(I32)


def _encode_distance_vec(d, npostfix, ndirect):
    """Vector EncodeDistance (format/lut.py:125-142) with per-page params.

    d: [P, N] distances >= 1; npostfix/ndirect: [P] ints.
    Returns (sym, nbits, extra)."""
    np_ = npostfix[:, None]
    nd_ = ndirect[:, None]
    direct = d <= nd_
    dd = jnp.maximum(d - nd_ - 1, 0)
    postfix = dd & ((jnp.int32(1) << np_) - 1)
    hval = dd >> np_
    nb = _bitlen_arr(hval + 4) - 2
    b = ((hval + 4) >> nb) & 1
    extra = hval + 4 - ((2 + b) << nb)
    sym = 16 + nd_ + (((2 * (nb - 1) + b) << np_) | postfix)
    sym = jnp.where(direct, 16 + d - 1, sym)
    nb = jnp.where(direct, 0, nb)
    extra = jnp.where(direct, 0, extra)
    return sym, nb, extra


def ins_code_vec(v):
    """Insert-length code (RFC 7932 table; format/lut.py), vectorized."""
    r = jnp.where(v < 6, v, 0)
    nb = jnp.zeros_like(v)
    x2 = jnp.maximum(v - 2, 1)
    for s in (16, 8, 4, 2, 1):
        take = (x2 >> s) > 0
        nb = nb + jnp.where(take, s, 0)
        x2 = jnp.where(take, x2 >> s, x2)
    nb = nb + (x2 > 0) - 2
    mid = (nb << 1) + ((jnp.maximum(v - 2, 0)) >> jnp.maximum(nb, 0)) + 2
    nb2 = jnp.zeros_like(v)
    x3 = jnp.maximum(v - 66, 1)
    for s in (16, 8, 4, 2, 1):
        take = (x3 >> s) > 0
        nb2 = nb2 + jnp.where(take, s, 0)
        x3 = jnp.where(take, x3 >> s, x3)
    nb2 = nb2 + (x3 > 0)
    hi = nb2 + 9
    return jnp.where(v < 6, r,
                     jnp.where(v < 130, mid,
                               jnp.where(v < 2114, hi,
                                         jnp.where(v < 6210, 21,
                                                   jnp.where(v < 22594, 22,
                                                             23)))))


def cpy_code_vec(v):
    """Copy-length code (RFC 7932 table; format/lut.py), vectorized."""
    nb = jnp.zeros_like(v)
    x2 = jnp.maximum(v - 6, 1)
    for s in (16, 8, 4, 2, 1):
        take = (x2 >> s) > 0
        nb = nb + jnp.where(take, s, 0)
        x2 = jnp.where(take, x2 >> s, x2)
    nb = nb + (x2 > 0) - 2
    mid = (nb << 1) + ((jnp.maximum(v - 6, 0)) >> jnp.maximum(nb, 0)) + 4
    nb2 = jnp.zeros_like(v)
    x3 = jnp.maximum(v - 70, 1)
    for s in (16, 8, 4, 2, 1):
        take = (x3 >> s) > 0
        nb2 = nb2 + jnp.where(take, s, 0)
        x3 = jnp.where(take, x3 >> s, x3)
    nb2 = nb2 + (x3 > 0)
    hi = nb2 + 11
    return jnp.where(v < 10, jnp.maximum(v - 2, 0),
                     jnp.where(v < 134, mid,
                               jnp.where(v < 2118, hi, 23)))


def combine_codes_vec(ic, cc, use_last):
    """CombineLengthCodes (format/lut.py) vector form: the joint command
    prefix symbol for insert code `ic`, copy code `cc`, implicit-ring0
    flag `use_last` (bool array)."""
    bits64 = (cc & 7) | ((ic & 7) << 3)
    cell = 2 * ((cc >> 3) + 3 * (ic >> 3))
    off = (cell << 5) + 0x40 + ((0x520D40 >> jnp.clip(cell, 0, 20)) & 0xC0)
    prefix_nl = off | bits64
    prefix_l = jnp.where(cc < 8, bits64, bits64 | 64)
    return jnp.where(use_last, prefix_l, prefix_nl)


def _ring_before(dist, valid):
    """Exact distance-ring state before each command, vectorized.

    The push rule (sym != 0 pushes) only depends on d_j != ring[0], and
    ring[0] before command j is always d_{j-1} (pushed or not), so the
    ring evolution is a pure function of the distance sequence: pushes
    happen exactly where the distance changes, and each push displaces
    the then-ring[0] into ring[1]. ring[k] before j is therefore the
    displaced value at the k-th most recent change (PageDecoder.cpp ring
    semantics; initial ring {4, 11, 15, 16})."""
    P, N = dist.shape
    d = jnp.where(valid, dist, 0)
    r0 = jnp.concatenate([jnp.full((P, 1), 4, I32), d[:, :-1]], axis=1)
    push = (d != r0) & valid
    t_inc = jnp.cumsum(push.astype(I32), axis=1)
    t_exc = t_inc - push.astype(I32)          # pushes strictly before j
    rows = jnp.arange(P, dtype=I32)[:, None]
    # displaced values in push order, prefixed by the initial ring tail
    # (each push shifts the initial 11/15/16 one slot deeper):
    # pv_ext = [16, 15, 11, pv_1, pv_2, ...]; ring[k] before j with t
    # prior pushes is pv_ext[3 + t - k]
    pv_seq = jnp.zeros((P, N + 1), I32).at[
        rows, jnp.where(push, t_exc, N)].add(r0, mode="drop")[:, :N]
    init = jnp.broadcast_to(
        jnp.asarray([16, 15, 11], dtype=I32)[None, :], (P, 3))
    pv_ext = jnp.concatenate([init, pv_seq], axis=1)

    def back(k):
        idx = 3 + t_exc - k
        return jnp.take_along_axis(pv_ext, jnp.clip(idx, 0, N + 2), axis=1)

    return r0, back(1), back(2), back(3)


def _build_fields(pages, in_sizes, ins, cpy, dist, ncmds, max_cmds):
    """Per-command wire fields. Returns dict of [P, NT] arrays where
    NT = max_cmds + 2 (tail insert-only command + sentinel), plus the
    per-page distance params (npostfix, ndist) for the page header."""
    P, S = pages.shape
    N = ins.shape[1]
    NT = N + 2
    cid = jnp.arange(N, dtype=I32)[None, :]
    valid = cid < ncmds[:, None]

    covered = jnp.sum(ins + cpy, axis=1)
    tail = in_sizes - covered

    # ---- distance ring codes 0-15 (exact ring state, zero extra bits) ----
    is_copy = valid & (cpy > 0) & (dist > 0)
    d = jnp.maximum(dist, 1)
    r0, r1, r2, r3 = _ring_before(dist, is_copy)
    ring_code = jnp.full((P, N), -1, I32)
    # native RingShortCode order: exact hits 0-3, then ring[0/1] +/- 1..3
    cands = [(r0, 0), (r1, 1), (r2, 2), (r3, 3)]
    for k in range(3):
        cands += [(r0 - (k + 1), 4 + 2 * k), (r0 + (k + 1), 5 + 2 * k)]
    for k in range(3):
        cands += [(r1 - (k + 1), 10 + 2 * k), (r1 + (k + 1), 11 + 2 * k)]
    for val, code in reversed(cands):
        ring_code = jnp.where(d == val, code, ring_code)
    ring_code = jnp.where(is_copy, ring_code, -1)
    code0 = ring_code == 0

    def dist_cost(syms, extra_nb, mask, presorted: bool = False):
        """Entropy + extra bits + ~6 bits/used-symbol storage estimate
        (native brotlig_encode.cpp:513-519). syms masked to A_DST.
        presorted=True skips the sort (caller guarantees syms ascending
        under the mask, mask-false entries at the end)."""
        n_m = jnp.sum(mask.astype(I32), axis=1).astype(jnp.float32)
        if presorted:
            sv = jnp.where(mask, syms, A_DST)
        else:
            sv = jnp.sort(jnp.where(mask, syms, A_DST), axis=1)
        seg = jnp.concatenate(
            [jnp.ones((P, 1), bool), sv[:, 1:] != sv[:, :-1]],
            axis=1) & (sv < A_DST)
        # per-run counts evaluated in place: the next run start after
        # each seg position via an exclusive suffix-min (round 4 —
        # replaces a position-compaction sort per evaluation; with the
        # presorted distance grid this leaves 3 sorts total in
        # _build_fields instead of 36)
        pos = jnp.broadcast_to(cid, (P, N))
        segpos = jnp.where(seg, pos, N)
        sfx = jax.lax.cummin(segpos[:, ::-1], axis=1)[:, ::-1]
        nxt = jnp.concatenate([sfx[:, 1:], jnp.full((P, 1), N, I32)],
                              axis=1)
        cnt = jnp.where(seg, jnp.minimum(nxt, N) - pos, 0)
        limit = n_m[:, None] - pos.astype(jnp.float32)
        cntf = jnp.minimum(cnt.astype(jnp.float32), jnp.maximum(limit, 0))
        live = seg & (cntf > 0)
        ent = jnp.sum(jnp.where(
            live, cntf * (jnp.log2(jnp.maximum(n_m[:, None], 1))
                          - jnp.log2(jnp.maximum(cntf, 1))) + 6.0, 0),
            axis=1)
        return ent + jnp.sum(
            jnp.where(mask, extra_nb, 0), axis=1).astype(jnp.float32)

    # ---- per-page (npostfix, ndirect) search over the non-exact-ring
    # distances (native brotlig_encode.cpp:474-527, ref PageEncoder.cpp:
    # 324-377): exact-hit codes 0-3 excluded from the candidate set.
    # The distance -> symbol map is monotone non-decreasing in the
    # distance for every (np, nd), so ONE sort of the distances serves
    # all 16 grid points (round 4: replaces a sort per grid point — the
    # serializer's dominant op cost) ----
    exact_hit = (ring_code >= 0) & (ring_code <= 3)
    search = is_copy & ~exact_hit
    BIGD = jnp.int32(1) << 28
    d_srt = jnp.sort(jnp.where(search, d, BIGD), axis=1)
    m_srt = d_srt < BIGD
    d_eval = jnp.where(m_srt, d_srt, 1)
    best_cost = jnp.full((P,), jnp.inf, jnp.float32)
    best_np = jnp.zeros((P,), I32)
    best_ndist = jnp.zeros((P,), I32)
    for np_c in range(4):
        for ndist_c in (0, 3, 8, 15):
            npv = jnp.full((P,), np_c, I32)
            ndv = jnp.full((P,), ndist_c << np_c, I32)
            sym_c, nb_c, _ = _encode_distance_vec(d_eval, npv, ndv)
            cost = dist_cost(sym_c, nb_c, m_srt, presorted=True)
            take = cost < best_cost
            best_cost = jnp.where(take, cost, best_cost)
            best_np = jnp.where(take, np_c, best_np)
            best_ndist = jnp.where(take, ndist_c, best_ndist)
    npostfix = best_np
    ndirect = best_ndist << best_np

    # ---- ring mode choice: exact hits only (0-3) vs also the offset
    # codes 4-15 — the offset codes cost zero extra bits but widen the
    # histogram; neither dominates (native brotlig_encode.cpp:530-560) ----
    dsym_l, dnb_l, dx_l = _encode_distance_vec(d, npostfix, ndirect)
    ring_exact = jnp.where(exact_hit, ring_code, -1)
    use_last_m = (ring_code == 0)  # same for both variants
    mask_m = is_copy & ~use_last_m
    costs = []
    for rc in (ring_exact, ring_code):
        sym_v = jnp.where(rc >= 0, rc, dsym_l)
        nb_v = jnp.where(rc >= 0, 0, dnb_l)
        costs.append(dist_cost(sym_v, nb_v, mask_m))
    all_wins = (costs[1] < costs[0])[:, None]
    ring_sel = jnp.where(all_wins, ring_code, ring_exact)

    use_ring = ring_sel >= 0
    dsym = jnp.where(use_ring, ring_sel, dsym_l)
    dnbits = jnp.where(use_ring, 0, dnb_l)
    dextra = jnp.where(use_ring, 0, dx_l)

    ic = ins_code_vec(ins)
    cc = cpy_code_vec(cpy)
    use_last = code0 & (ic < 8) & (cc < 16)
    prefix = combine_codes_vec(ic, cc, use_last)
    store_dist = valid & ~use_last

    ins_bits = arith_lut.insert_extra(ic)
    ins_base = arith_lut.insert_base(ic)
    cpy_bits = arith_lut.copy_extra(cc)
    cpy_base = arith_lut.copy_base(cc)
    ins_extra = ins - ins_base
    cpy_extra = jnp.where(cc > 1, cpy - cpy_base, cpy)

    # tail insert-only command + sentinel, represented virtually: command
    # slot t maps to (t < ncmds: array column t), (t == ncmds & has_tail:
    # the tail command), else the sentinel — see cmd_field()
    tail_code = ins_code_vec(tail[:, None])[:, 0]
    has_tail = tail > 0
    ntotal = ncmds + 1 + has_tail.astype(I32)

    fields = dict(
        prefix=(jnp.where(valid, prefix, 0),
                jnp.where(has_tail, 704 + tail_code, 704),
                jnp.full((P,), 704, I32)),
        ins=(jnp.where(valid, ins, 0), tail, jnp.zeros((P,), I32)),
        cpy=(jnp.where(valid, cpy, 0), jnp.zeros((P,), I32),
             jnp.zeros((P,), I32)),
        insb=(jnp.where(valid, ins_bits, 0),
              jnp.where(has_tail, arith_lut.insert_extra(tail_code), 0),
              jnp.zeros((P,), I32)),
        insx=(jnp.where(valid, ins_extra, 0),
              jnp.where(has_tail, tail - arith_lut.insert_base(tail_code),
                        0), jnp.zeros((P,), I32)),
        cpyb=(jnp.where(valid, cpy_bits, 0), jnp.zeros((P,), I32),
              jnp.zeros((P,), I32)),
        cpyx=(jnp.where(valid, cpy_extra, 0), jnp.zeros((P,), I32),
              jnp.zeros((P,), I32)),
        dsym=(jnp.where(store_dist, dsym, 0), jnp.zeros((P,), I32),
              jnp.zeros((P,), I32)),
        dnb=(jnp.where(store_dist, dnbits, 0), jnp.zeros((P,), I32),
             jnp.zeros((P,), I32)),
        dx=(jnp.where(store_dist, dextra, 0), jnp.zeros((P,), I32),
            jnp.zeros((P,), I32)),
        sdist=(store_dist.astype(I32), jnp.zeros((P,), I32),
               jnp.zeros((P,), I32)),
    )
    return fields, ntotal, tail, has_tail, npostfix, best_ndist


def cmd_field(fields, name, t_idx, ncmds, has_tail):
    """Virtual gather over [commands..., tail?, sentinel] at slots t_idx.

    t_idx: [P, K] command-slot indices. Out-of-range slots return the
    sentinel values (harmless: they are masked by the schedule)."""
    arr, tail_v, sent_v = fields[name]
    N = arr.shape[1]
    g = jnp.take_along_axis(arr, jnp.clip(t_idx, 0, N - 1), axis=1)
    is_tail = has_tail[:, None] & (t_idx == ncmds[:, None])
    in_arr = t_idx < ncmds[:, None]
    return jnp.where(in_arr, g,
                     jnp.where(is_tail, tail_v[:, None], sent_v[:, None]))


# ---------------------------------------------------------------------------
# Emission schedule + bit packing
# ---------------------------------------------------------------------------

def _bitlen_arr(x):
    bl = jnp.zeros_like(x)
    for s in (16, 8, 4, 2, 1):
        take = (x >> s) > 0
        bl = bl + jnp.where(take, s, 0)
        x = jnp.where(take, x >> s, x)
    return bl + (x > 0)


def _rle_items(lens, A):
    """Run-coded table items, exactly mirroring the reference's splitting
    (format/rle.py::compute_rle_codes, BrotligUtils.cpp:76-228): literal
    lengths 0..15, code 16 = repeat prev nonzero 3..6 (2 extra bits),
    code 17 = repeat zero 3..10 (3 extra bits), with the first-position
    literal and the reps==11 / reps==7 split quirks.

    lens: [P, A]. Returns (codes, extra, ewidth) each [P, A32] int32 and
    item count M [P], where A32 = ceil(A/32)*32; items j >= M are zeroed.
    """
    P = lens.shape[0]
    A32 = (A + 31) // 32 * 32
    rows = jnp.arange(P, dtype=I32)[:, None]
    pos = jnp.broadcast_to(jnp.arange(A, dtype=I32)[None, :], (P, A))

    # runs: position 0 is always its own unit; real runs start at 1
    prev_len = jnp.concatenate(
        [jnp.zeros((P, 1), I32), lens[:, :-1]], axis=1)
    start = (pos <= 1) | (lens != prev_len)
    run_id = jnp.cumsum(start.astype(I32), axis=1) - 1          # [P, A]
    nruns = run_id[:, -1] + 1

    # per-run start position / value / reps / prev value (run index space
    # shares the [P, A] shape; rows >= nruns are padding)
    rs = jnp.zeros((P, A + 1), I32).at[
        rows, jnp.where(start, run_id, A)].add(pos, mode="drop")[:, :A]
    v = jnp.take_along_axis(lens, jnp.clip(rs, 0, A - 1), axis=1)
    r_next = jnp.concatenate([rs[:, 1:], jnp.full((P, 1), A, I32)], axis=1)
    ridx = jnp.broadcast_to(jnp.arange(A, dtype=I32)[None, :], (P, A))
    r_end = jnp.where(ridx + 1 < nruns[:, None], r_next, A)
    reps = jnp.maximum(r_end - rs, 0)
    prev = jnp.concatenate([jnp.full((P, 1), 8, I32), v[:, :-1]], axis=1)

    is0 = ridx == 0
    zero = v == 0
    # zero runs: optional leading literal 0 (reps==11), chunks of <=10
    leadz = (reps == 11).astype(I32)
    rz = reps - leadz
    tz, remz = rz // 10, rz % 10
    kz = tz + (remz >= 3)
    lz = jnp.where(remz >= 3, 0, remz)
    # nonzero runs: literal if prev differs, second literal if then 7 left
    lead1 = (prev != v).astype(I32)
    r1 = reps - lead1
    lead2 = (r1 == 7).astype(I32)
    rn = r1 - lead2
    tn, remn = rn // 6, rn % 6
    kn = tn + (remn >= 3)
    ln = jnp.where(remn >= 3, 0, remn)

    lead = jnp.where(is0, 1, jnp.where(zero, leadz, lead1 + lead2))
    k = jnp.where(is0, 0, jnp.where(zero, kz, kn))
    ltr = jnp.where(is0, 0, jnp.where(zero, lz, ln))
    t = jnp.where(zero, tz, tn)
    rem = jnp.where(zero, remz, remn)
    n_items = jnp.where(ridx < nruns[:, None], lead + k + ltr, 0)

    off = jnp.cumsum(n_items, axis=1) - n_items                 # exclusive
    M = off[:, -1] + n_items[:, -1]

    # map item index -> run (scatter starts, forward-fill)
    tgt = jnp.where((n_items > 0) & (ridx < nruns[:, None]), off, A32)
    mark = jnp.zeros((P, A32 + 1), I32).at[rows, tgt].max(
        ridx, mode="drop")[:, :A32]
    run_of = jax.lax.cummax(mark, axis=1)
    q = jnp.arange(A32, dtype=I32)[None, :] - jnp.take_along_axis(
        off, run_of, axis=1)

    def g(a):
        return jnp.take_along_axis(a, run_of, axis=1)

    vi, leadi, ki, ti, remi = g(v), g(lead), g(k), g(t), g(rem)
    zi = vi == 0
    in_code = (q >= leadi) & (q < leadi + ki)
    codes = jnp.where(in_code, jnp.where(zi, 17, 16), vi)
    extra = jnp.where(in_code,
                      jnp.where(q - leadi < ti,
                                jnp.where(zi, 7, 3), remi - 3), 0)
    ewidth = jnp.where(in_code, jnp.where(zi, 3, 2), 0)
    live = jnp.arange(A32, dtype=I32)[None, :] < M[:, None]
    return (jnp.where(live, codes, 0), jnp.where(live, extra, 0),
            jnp.where(live, ewidth, 0), M)


def _choose_table(hist, total, A):
    """Pick the cheapest storage mode per page like the reference encoder
    (BrotligHuffman.cpp:262-363): <=1 used symbol -> trivial (symbols then
    cost 0 bits), <=4 -> simple with the decoder's fixed length rows,
    else complex. Returns (lens [P,A], mode [P] 0/1/2, emit_syms [P,4] in
    (length, symbol) order, tsel [P], count [P])."""
    P = hist.shape[0]
    count = jnp.sum((hist > 0).astype(I32), axis=1)
    lens_cplx = _lengths_from_hist(hist, total)

    # used symbols ascending (padding A), their counts
    symid = jnp.broadcast_to(jnp.arange(A, dtype=I32)[None, :], (P, A))
    s4 = jnp.sort(jnp.where(hist > 0, symid, A), axis=1)[:, :4]
    c4 = jnp.take_along_axis(hist, jnp.clip(s4, 0, A - 1), axis=1)
    c4 = jnp.where(s4 < A, c4, 0)

    # order the four by count desc (stable on symbol asc) for assignment
    order = jnp.argsort(-c4, axis=1, stable=True)   # rank -> slot index
    cd = jnp.take_along_axis(c4, order, axis=1)     # counts desc
    # count==4: flat {2,2,2,2} vs skew {1,2,3,3} by actual coded bits
    cost_flat = 2 * jnp.sum(cd, axis=1)
    cost_skew = cd[:, 0] + 2 * cd[:, 1] + 3 * (cd[:, 2] + cd[:, 3])
    tsel = ((count == 4) & (cost_skew < cost_flat)).astype(I32)
    skew = jnp.asarray([1, 2, 3, 3], dtype=I32)
    flat = jnp.asarray([2, 2, 2, 2], dtype=I32)
    three = jnp.asarray([1, 2, 2, 0], dtype=I32)
    two = jnp.asarray([1, 1, 0, 0], dtype=I32)
    lens_by_rank = jnp.where(count[:, None] == 2, two[None, :],
                             jnp.where(count[:, None] == 3, three[None, :],
                                       jnp.where(tsel[:, None] == 1,
                                                 skew[None, :],
                                                 flat[None, :])))
    rank_of_slot = jnp.argsort(order, axis=1)
    len4 = jnp.take_along_axis(lens_by_rank, rank_of_slot, axis=1)
    len4 = jnp.where(s4 < A, len4, 0)
    rows = jnp.arange(P, dtype=I32)[:, None]
    lens_simp = jnp.zeros((P, A + 1), I32).at[
        rows, jnp.clip(s4, 0, A)].max(len4, mode="drop")[:, :A]

    mode = jnp.where(count <= 1, 0, jnp.where(count <= 4, 1, 2))
    lens = jnp.where(mode[:, None] == 0, 0,
                     jnp.where(mode[:, None] == 1, lens_simp, lens_cplx))
    # emission order: decoder assigns its fixed rows in listed order, and
    # those rows are nondecreasing -> sort by (length, symbol)
    ek = jnp.where(s4 < A, len4 * (A + 1) + s4, 16 * (A + 1) + A)
    eord = jnp.argsort(ek, axis=1)
    emit_syms = jnp.take_along_axis(s4, eord, axis=1)
    emit_syms = jnp.where(emit_syms < A, emit_syms, 0)
    return lens, mode, emit_syms, tsel, count


def _table_block(mode, cl_lens, cl_codes, item_c, item_x, item_w, M,
                 emit_syms, tsel, count, A):
    """Emission slots for one table, per stream, all three storage modes.

    Returns (nbits [P,32,K], vals [P,32,K]) with K = 2 + ceil(A/32):
    [header, cl-lens/simple-syms, item_0.., item_k]. Streams advance
    round-robin per serialized unit and reset per section, so unit j of a
    section lands in stream j%32 (format/swizzle.py; huffman.py
    build_and_store_table).
    """
    P = cl_lens.shape[0]
    kmax = (A + 31) // 32
    max_bits = (A - 1).bit_length()
    s_idx = jnp.arange(32, dtype=I32)[None, :]
    m_t = (mode == 0)[:, None]
    m_s = (mode == 1)[:, None]
    m_c = (mode == 2)[:, None]
    cols_n = []
    cols_v = []
    # header column, stream 0 only. trivial: type0 + 4 pad bits + symbol;
    # simple: type1 + (count-1) + 2 select bits + first symbol; complex:
    # type2 + (18-4). (huffman.py:169-240)
    hdr_t = (0 | (1 << 2)) | (emit_syms[:, 0] << 6)
    hdr_s = (1 | (jnp.maximum(count - 1, 0) << 2) | (tsel << 4)
             | (emit_syms[:, 0] << 6))
    hdr_c = jnp.full((P,), 2 | ((18 - 4) << 2), I32)
    hdr_v = jnp.where(mode == 0, hdr_t,
                      jnp.where(mode == 1, hdr_s, hdr_c))
    hdr_n = jnp.where(mode == 2, 6, 6 + max_bits)
    cols_n.append(jnp.where(s_idx == 0, hdr_n[:, None], 0))
    cols_v.append(jnp.broadcast_to(hdr_v[:, None], (P, 32)))
    # second column: complex cl lengths (5 bits, streams 0..17, CL_ORDER);
    # simple remaining symbols (max_bits, streams 1..count-1)
    order = jnp.asarray(CL_ORDER, dtype=I32)
    cl_at = jnp.take_along_axis(
        cl_lens, jnp.broadcast_to(order[None, :], (P, 18)), axis=1)
    cl_slot_v = jnp.concatenate([cl_at, jnp.zeros((P, 14), I32)], axis=1)
    sym_slot_v = jnp.concatenate(
        [jnp.zeros((P, 1), I32), emit_syms[:, 1:4],
         jnp.zeros((P, 28), I32)], axis=1)
    n2 = jnp.where(m_c & (s_idx < 18), 5, 0)
    n2 = jnp.where(m_s & (s_idx >= 1) & (s_idx < count[:, None]),
                   max_bits, n2)
    cols_n.append(n2)
    cols_v.append(jnp.where(m_c, cl_slot_v, jnp.where(m_s, sym_slot_v, 0)))
    # item columns (complex only): item j = k*32 + s, run-coded; the
    # extra bits ride in the same stream slot as their code
    cl_n_of = jnp.take_along_axis(cl_lens, jnp.clip(item_c, 0, 17), axis=1)
    cl_v_of = jnp.take_along_axis(cl_codes, jnp.clip(item_c, 0, 17),
                                  axis=1)
    it_n = cl_n_of + item_w
    it_v = cl_v_of | (item_x << jnp.minimum(cl_n_of, 15))
    for k in range(kmax):
        j = k * 32 + s_idx
        live = m_c & (j < M[:, None])
        jc = jnp.clip(j, 0, item_c.shape[1] - 1)
        cols_n.append(jnp.where(
            live, jnp.take_along_axis(it_n, jnp.broadcast_to(
                jc, (P, 32)), axis=1), 0))
        cols_v.append(jnp.where(
            live, jnp.take_along_axis(it_v, jnp.broadcast_to(
                jc, (P, 32)), axis=1), 0))
    return (jnp.stack(cols_n, axis=2).astype(I32),
            jnp.stack(cols_v, axis=2).astype(I32))


def pack_pages_device(pages, in_sizes, ins, cpy, dist, ncmds,
                      page_size: int, max_cmds: int, isdelta=None):
    """Serialize compressed pages fully on device.

    Returns (out_bytes [P, cap] uint8, out_sizes [P] int32); a page whose
    compressed size >= its input size must be stored raw by the caller
    (out_sizes is still the compressed size; caller compares).
    isdelta: optional [P] int32 delta-encoded flags for the page header byte.
    """
    P, S = pages.shape
    N = ins.shape[1]
    fields, ntotal, tail, has_tail, h_np, h_ndist = _build_fields(
        pages, in_sizes, ins, cpy, dist, ncmds, max_cmds)

    # ---- histograms ----
    NT = N  # command array width (tail+sentinel virtual)
    cid = jnp.arange(N, dtype=I32)[None, :]
    valid = cid < ncmds[:, None]
    prefix_arr = fields["prefix"][0]
    hist_cmd = _histogram(prefix_arr, valid, A_CMD)
    # add tail + sentinel
    rows = jnp.arange(P, dtype=I32)
    tail_pref = fields["prefix"][1]
    hist_cmd = hist_cmd.at[rows, jnp.clip(tail_pref, 0, A_CMD - 1)].add(
        has_tail.astype(I32))
    hist_cmd = hist_cmd.at[:, 704].add(1)

    dsym_arr = fields["dsym"][0]
    sdist_arr = fields["sdist"][0]
    hist_dst = _histogram(dsym_arr, sdist_arr > 0, A_DST)

    # literal histogram over insert regions + tail
    pos_idx = jnp.broadcast_to(jnp.arange(S, dtype=I32)[None, :], (P, S))
    cov = ins + cpy
    starts = jnp.cumsum(cov, axis=1) - cov          # page pos of cmd start
    cum_ins = jnp.cumsum(ins, axis=1)               # inclusive
    # per position: is it a literal (inside an insert region or the tail)?
    # covering command: starts are nondecreasing, so a log-depth
    # searchsorted gives the last command with start <= pos (ties pick
    # the largest index, matching the old scatter-max semantics)
    starts_m = jnp.where(valid, starts, jnp.int32(1) << 29)
    cmd_of = jnp.clip(jax.vmap(
        lambda a, q: jnp.searchsorted(a, q, side="right"))(
        starts_m, pos_idx) - 1, 0, N - 1)
    st_of = jnp.take_along_axis(starts, cmd_of, axis=1)
    ins_of = jnp.take_along_axis(ins, cmd_of, axis=1)
    covered = fields_covered = jnp.sum(cov, axis=1)
    in_lit = ((pos_idx < st_of + ins_of)
              | (pos_idx >= covered[:, None])) & (pos_idx < in_sizes[:, None])
    hist_lit = _histogram(pages.astype(I32), in_lit, A_LIT)
    n_lits = jnp.sum(hist_lit, axis=1)
    most_freq = jnp.argmax(hist_lit, axis=1).astype(I32)

    # ---- storage mode + code lengths + canonical codes ----
    cmd_lens, cmd_mode, cmd_es, cmd_ts, cmd_cnt = _choose_table(
        hist_cmd, jnp.sum(hist_cmd, axis=1), A_CMD)
    dst_lens, dst_mode, dst_es, dst_ts, dst_cnt = _choose_table(
        hist_dst, jnp.sum(hist_dst, axis=1), A_DST)
    lit_lens, lit_mode, lit_es, lit_ts, lit_cnt = _choose_table(
        hist_lit, n_lits, A_LIT)
    cmd_codes, _ = _canonical_codes(cmd_lens)
    dst_codes, _ = _canonical_codes(dst_lens)
    lit_codes, _ = _canonical_codes(lit_lens)

    # cl trees (depth <= 9) over the run-coded item histograms
    def cl_tree(item_c, item_live, M):
        h = _histogram(item_c, item_live, 18)
        L = _lengths_from_hist(h, M)
        L = jnp.minimum(L, 9)
        for _ in range(9):
            units = jnp.where(L > 0, jnp.int32(1) << (9 - L), 0)
            over = jnp.sum(units, axis=1) > (1 << 9)
            L = jnp.where(over[:, None] & (L > 0), jnp.minimum(L + 1, 9), L)
        codes, _ = _canonical_codes(L)
        return L, codes

    # ---- table emission block (mode-dependent, run-coded items) ----
    tb_n = []
    tb_v = []
    for md, sy_l, es, ts, cnt, A in (
            (cmd_mode, cmd_lens, cmd_es, cmd_ts, cmd_cnt, A_CMD),
            (dst_mode, dst_lens, dst_es, dst_ts, dst_cnt, A_DST),
            (lit_mode, lit_lens, lit_es, lit_ts, lit_cnt, A_LIT)):
        it_c, it_x, it_w, M = _rle_items(sy_l, A)
        live = jnp.arange(it_c.shape[1], dtype=I32)[None, :] < M[:, None]
        cl_l, cl_c = cl_tree(it_c, live, M)
        n, v = _table_block(md, cl_l, cl_c, it_c, it_x, it_w, M,
                            es, ts, cnt, A)
        tb_n.append(n)
        tb_v.append(v)
    table_n = jnp.concatenate(tb_n, axis=2)
    table_v = jnp.concatenate(tb_v, axis=2)
    TBL = table_n.shape[2]

    # ---- round schedule ----
    R = (max_cmds + 2 + NBS - 1) // NBS
    slot_ids = jnp.arange(R * NBS, dtype=I32)[None, :]
    ins_slots = cmd_field(fields, "ins",
                          jnp.broadcast_to(slot_ids, (P, R * NBS)),
                          ncmds, has_tail)
    ins_slots = jnp.where(slot_ids < ntotal[:, None], ins_slots, 0)
    litcount_r = jnp.sum(ins_slots.reshape(P, R, NBS), axis=2)
    cumlit = jnp.cumsum(litcount_r, axis=1)
    eff = jnp.minimum(ntotal, NBS)
    f_round = (ntotal - 1) // NBS                       # final round index
    R_full = 32 * ((cumlit + 31) // 32)
    r_idx = jnp.arange(R, dtype=I32)[None, :]
    Rf_prev = jnp.where(f_round > 0,
                        jnp.take_along_axis(
                            R_full, jnp.maximum(f_round - 1, 0)[:, None],
                            axis=1)[:, 0], 0)
    cum_f = jnp.take_along_axis(cumlit, f_round[:, None], axis=1)[:, 0]
    ac_f = jnp.maximum(cum_f - Rf_prev, 0)
    e = jnp.maximum(eff, 1)
    R_final = Rf_prev + e * ((ac_f + e - 1) // e)
    Rarr = jnp.where(r_idx < f_round[:, None], R_full,
                     R_final[:, None])
    Rprev = jnp.concatenate([jnp.zeros((P, 1), I32), Rarr[:, :-1]], axis=1)
    lits_r = jnp.maximum(Rarr - Rprev, 0)               # [P, R]

    # per-(round, stream) literal counts and slot bases
    s_ids = jnp.arange(NBS, dtype=I32)[None, None, :]          # [1,1,32]
    cnt = (jnp.maximum(lits_r[:, :, None] - s_ids, 0) + 31) // 32
    per_rs = 5 + cnt                                            # [P,R,32]
    base = jnp.cumsum(per_rs, axis=1) - per_rs                  # exclusive
    base = jnp.moveaxis(base, 1, 2)                             # [P,32,R]
    cnt_sr = jnp.moveaxis(cnt, 1, 2)                            # [P,32,R]
    Rprev_b = Rprev                                             # [P,R]

    lit_cap = page_size + 64
    Edyn = 6 * R + lit_cap // 32 + 2
    e_ids = jnp.broadcast_to(jnp.arange(Edyn, dtype=I32)[None, None, :],
                             (P, NBS, Edyn))
    r_of = jax.vmap(jax.vmap(
        lambda b, e: jnp.searchsorted(b, e, side="right")))(base, e_ids)
    r_of = jnp.clip(r_of - 1, 0, R - 1)
    base_r = jnp.take_along_axis(base, r_of, axis=2)
    u = e_ids - base_r
    cnt_r = jnp.take_along_axis(cnt_sr, r_of, axis=2)

    s_col = jnp.arange(NBS, dtype=I32)[None, :, None]
    cmd_slot = r_of * NBS + s_col                                # [P,32,E]
    slot_exists = cmd_slot < ntotal[:, None, None]
    is_cmd_field = (u < 5) & slot_exists
    is_lit = (u >= 5) & (u - 5 < cnt_r)

    # ---- literal queue (page bytes of insert regions + tail + padding) ----
    lit_rank = jnp.cumsum(in_lit.astype(I32), axis=1)           # inclusive
    q_ids = jnp.broadcast_to(jnp.arange(lit_cap, dtype=I32)[None, :],
                             (P, lit_cap))
    lq_pos = jax.vmap(
        lambda c, q: jnp.searchsorted(c, q, side="left"))(lit_rank,
                                                          q_ids + 1)
    lq_pos = jnp.clip(lq_pos, 0, S - 1)
    lq = jnp.take_along_axis(pages.astype(I32), lq_pos, axis=1)
    lq = jnp.where(q_ids < n_lits[:, None], lq, most_freq[:, None])

    # ---- resolve dynamic slots to (nbits, value) ----
    def vgather(name):
        flat = cmd_slot.reshape(P, NBS * Edyn)
        g = cmd_field(fields, name, flat, ncmds, has_tail)
        return g.reshape(P, NBS, Edyn)

    pfx = vgather("prefix")
    pfx_c = jnp.clip(pfx, 0, A_CMD - 1)
    code_n = jnp.take_along_axis(
        cmd_lens, pfx_c.reshape(P, -1), axis=1).reshape(P, NBS, Edyn)
    code_v = jnp.take_along_axis(
        cmd_codes, pfx_c.reshape(P, -1), axis=1).reshape(P, NBS, Edyn)
    insb = vgather("insb")
    insx = vgather("insx")
    cpyb = vgather("cpyb")
    cpyx = vgather("cpyx")
    sd = vgather("sdist")
    dsymg = jnp.clip(vgather("dsym"), 0, A_DST - 1)
    dln = jnp.where(sd > 0, jnp.take_along_axis(
        dst_lens, dsymg.reshape(P, -1), axis=1).reshape(P, NBS, Edyn), 0)
    dcv = jnp.take_along_axis(
        dst_codes, dsymg.reshape(P, -1), axis=1).reshape(P, NBS, Edyn)
    dnbg = vgather("dnb")
    dxg = vgather("dx")

    # literal slot values
    Rprev_bc = jnp.broadcast_to(Rprev_b[:, None, :], (P, NBS, R))
    j_global = (jnp.take_along_axis(Rprev_bc, r_of, axis=2)
                + (u - 5) * NBS + s_col)
    j_c = jnp.clip(j_global, 0, lit_cap - 1)
    lbyte = jnp.take_along_axis(
        lq, j_c.reshape(P, -1), axis=1).reshape(P, NBS, Edyn)
    lit_n = jnp.take_along_axis(
        lit_lens, lbyte.reshape(P, -1), axis=1).reshape(P, NBS, Edyn)
    lit_v = jnp.take_along_axis(
        lit_codes, lbyte.reshape(P, -1), axis=1).reshape(P, NBS, Edyn)

    nb = jnp.where(is_cmd_field & (u == 0), code_n, 0)
    vv = jnp.where(is_cmd_field & (u == 0), code_v, 0)
    nb = jnp.where(is_cmd_field & (u == 1), insb, nb)
    vv = jnp.where(is_cmd_field & (u == 1), insx, vv)
    nb = jnp.where(is_cmd_field & (u == 2), cpyb, nb)
    vv = jnp.where(is_cmd_field & (u == 2), cpyx, vv)
    nb = jnp.where(is_cmd_field & (u == 3), dln, nb)
    vv = jnp.where(is_cmd_field & (u == 3), dcv, vv)
    nb = jnp.where(is_cmd_field & (u == 4), jnp.where(sd > 0, dnbg, 0), nb)
    vv = jnp.where(is_cmd_field & (u == 4), dxg, vv)
    nb = jnp.where(is_lit, lit_n, nb)
    vv = jnp.where(is_lit, lit_v, vv)

    # prepend the static table block
    nbits_all = jnp.concatenate([table_n, nb], axis=2)
    vals_all = jnp.concatenate([table_v, vv], axis=2)
    E = nbits_all.shape[2]

    # ---- bit packing per stream ----
    offs = jnp.cumsum(nbits_all, axis=2) - nbits_all            # exclusive
    stream_bits = offs[:, :, -1] + nbits_all[:, :, -1]
    sh = (offs & 31).astype(U32)
    valu = vals_all.astype(U32)
    contrib_a = (valu << sh).astype(U32)
    contrib_b = jnp.where(sh == 0, jnp.uint32(0),
                          valu >> (jnp.uint32(32) - sh))
    widx_a = offs >> 5
    widx_b = (offs >> 5) + 1
    # empty emissions must not contribute
    contrib_a = jnp.where(nbits_all > 0, contrib_a, 0)
    contrib_b = jnp.where(nbits_all > 0, contrib_b, 0)

    Wst = (page_size // NBS) // 4 * 3 + 16
    w_ids = jnp.broadcast_to(jnp.arange(Wst + 1, dtype=I32)[None, None, :],
                             (P, NBS, Wst + 1))

    def word_sum(contrib, widx):
        csum = jnp.cumsum(contrib.astype(U32), axis=2)  # wraparound-safe
        bound = jax.vmap(jax.vmap(
            lambda wi, w: jnp.searchsorted(wi, w, side="left")))(widx, w_ids)
        bz = jnp.concatenate(
            [jnp.zeros((P, NBS, 1), U32), csum], axis=2)
        at = jnp.take_along_axis(bz, bound, axis=2)
        return at[:, :, 1:] - at[:, :, :-1]

    words_a = word_sum(contrib_a, widx_a)
    words_b = word_sum(contrib_b, widx_b)
    stream_words = (words_a + words_b).astype(U32)              # [P,32,Wst]
    overflow = stream_bits > 32 * Wst

    # ---- page header + size table (BrotligSwizzler.cpp:68-142 fixed point)
    stream_bytes = (stream_bits + 7) // 8                       # [P,32]
    tot_sb = jnp.sum(stream_bytes, axis=1)
    mn_sb = jnp.min(stream_bytes, axis=1)
    off_sb = stream_bytes - mn_sb[:, None]
    delta_bits = jnp.maximum(jnp.max(_bitlen_arr(off_sb), axis=1), 1)

    hdr_bits0 = jnp.full((P,), 8, I32)  # page header byte
    est = ((hdr_bits0 + 7) // 8 + 3) // 4 * 4 + tot_sb
    base_bits = jnp.zeros((P,), I32)
    dbs_bits = jnp.zeros((P,), I32)
    for _ in range(6):  # fixed point converges in <= a few steps
        r_avg = (est + 31) // 32
        base_bits = _bitlen_arr(r_avg[:, None])[:, 0]
        dbs_bits = _bitlen_arr(
            _bitlen_arr(jnp.maximum(est - 1, 1)[:, None]))[:, 0]
        nh = hdr_bits0 + base_bits + dbs_bits + NBS * delta_bits
        est = ((nh + 7) // 8 + 3) // 4 * 4 + tot_sb

    hdr_total_bits = hdr_bits0 + base_bits + dbs_bits + NBS * delta_bits
    hdr_words_n = ((hdr_total_bits + 31) // 32)
    HW = 8 + (2 + NBS * 20 + 40) // 32  # static bound on header words (<=30)
    HW = 24
    hdr_words = jnp.zeros((P, HW), U32)

    def hput(words, bitoff, nbits, value):
        """Insert one variable-width field per page into the header words."""
        w = bitoff >> 5
        shl = (bitoff & 31).astype(U32)
        v = value.astype(U32) & jnp.where(
            nbits >= 32, jnp.uint32(0xFFFFFFFF),
            (jnp.uint32(1) << nbits.astype(U32)) - 1)
        rowsh = jnp.arange(P, dtype=I32)
        words = words.at[rowsh, jnp.clip(w, 0, HW - 1)].add(
            jnp.where(nbits > 0, v << shl, 0))
        spill = jnp.where(shl > 0, v >> (jnp.uint32(32) - shl),
                          jnp.uint32(0))
        words = words.at[rowsh, jnp.clip(w + 1, 0, HW - 1)].add(
            jnp.where(nbits > 0, spill, 0))
        return words, bitoff + nbits

    zero = jnp.zeros((P,), I32)
    bo = zero
    # page header byte LSB-first: npostfix(2), ndist(4), isdelta(1),
    # reserved(1)=0 (format/constants.py:44-47); ndirect = ndist<<npostfix
    hdr_byte0 = h_np | (h_ndist << 2)
    if isdelta is not None:
        hdr_byte0 = hdr_byte0 | ((isdelta.astype(I32) & 1) << 6)
    hdr_words, bo = hput(hdr_words, bo, jnp.full((P,), 8, I32), hdr_byte0)
    hdr_words, bo = hput(hdr_words, bo, base_bits, mn_sb)
    hdr_words, bo = hput(hdr_words, bo, dbs_bits, delta_bits)
    for s in range(NBS):
        hdr_words, bo = hput(hdr_words, bo, delta_bits, off_sb[:, s])
    hdr_bytes = hdr_words_n * 4

    # ---- assemble: header words + concatenated streams, DWORD padded ----
    out_total = hdr_bytes + ((tot_sb + 3) // 4) * 4
    cap = page_size  # >= input means raw anyway
    sb_prefix = jnp.concatenate(
        [jnp.zeros((P, 1), I32), jnp.cumsum(stream_bytes, axis=1)], axis=1)
    b_ids = jnp.broadcast_to(jnp.arange(cap, dtype=I32)[None, :], (P, cap))
    pay_b = b_ids - hdr_bytes[:, None]
    strm_of = jax.vmap(
        lambda pre, b: jnp.searchsorted(pre, b, side="right"))(sb_prefix,
                                                               pay_b)
    strm_of = jnp.clip(strm_of - 1, 0, NBS - 1)
    in_strm = pay_b - jnp.take_along_axis(sb_prefix, strm_of, axis=1)
    # byte from stream words
    sw_flat = stream_words.reshape(P, NBS * Wst)
    widx = jnp.clip(strm_of * Wst + (in_strm >> 2), 0, NBS * Wst - 1)
    wval = jnp.take_along_axis(sw_flat, widx, axis=1)
    pay_byte = (wval >> ((in_strm & 3) << 3).astype(U32)) & 0xFF
    hw_byte = jnp.take_along_axis(
        hdr_words, jnp.clip(b_ids >> 2, 0, HW - 1), axis=1)
    hdr_byte = (hw_byte >> ((b_ids & 3) << 3).astype(U32)) & 0xFF
    out = jnp.where(b_ids < hdr_bytes[:, None], hdr_byte,
                    jnp.where(pay_b < ((tot_sb[:, None] + 3) // 4) * 4,
                              pay_byte, 0)).astype(jnp.uint8)
    bad = jnp.any(overflow, axis=1)
    out_sizes = jnp.where(bad, page_size + 1, out_total)
    return out, out_sizes.astype(I32)


@partial(jax.jit, static_argnums=(2, 3))
def _pack_jit(pages, in_sizes, page_size, max_cmds, ins, cpy, dist, ncmds,
              isdelta):
    return pack_pages_device(pages, in_sizes, ins, cpy, dist, ncmds,
                             page_size, max_cmds, isdelta)


def _pack_partitioned(pages, in_sizes, page_size: int, max_cmds: int,
                      ins, cpy, dist, ncmds, isdelta):
    """Pack pages in command-count groups (round 5).

    The emission schedule's round count R — and with it every
    [P, 32, Edyn] emission plane — derives from the command bound, which
    was the worst case page_size/4 for every page. Grouping pages by
    their REAL command count (known before packing) onto a power-of-two
    bucket ladder shrinks the schedule ~2-8x for typical pages without
    letting one dense page widen the whole batch; group row counts are
    power-of-two padded so compiled shapes stay bounded. Returns
    (out [P, cap] uint8 np, out_sizes [P] int32 np)."""
    P = pages.shape[0]
    nc = np.asarray(ncmds)
    groups: dict = {}
    for i in range(P):
        b = 2048
        while b < int(nc[i]) + 2:
            b *= 2
        b = min(b, max_cmds)
        groups.setdefault(b, []).append(i)
    outs = np.zeros((P, page_size), np.uint8)
    out_sizes = np.zeros(P, np.int32)
    ncj = jnp.asarray(ncmds)
    isdj = jnp.asarray(isdelta)
    for b, idxs in sorted(groups.items()):
        g = len(idxs)
        gb = 1
        while gb < g:
            gb *= 2
        rows = idxs + [idxs[0]] * (gb - g)
        rix = jnp.asarray(np.asarray(rows, np.int32))
        o, sz = _pack_jit(pages[rix], in_sizes[rix], page_size, b,
                          ins[rix, :b], cpy[rix, :b], dist[rix, :b],
                          ncj[rix], isdj[rix])
        o_np = np.asarray(o)
        sz_np = np.asarray(sz)
        for r, i in enumerate(idxs):
            outs[i] = o_np[r]
            out_sizes[i] = sz_np[r]
    return outs, out_sizes


def encode_pages_device(pages_np, in_sizes_np, page_size: int,
                        isdelta_np=None, raw_pages_np=None,
                        quality: int = 11):
    """Device end-to-end page encode: bulk matcher + device serializer.

    quality >= 10 adds the windowed-DP optimal parse (ops/parse_dp.py)
    and keeps the smaller of greedy/DP per page — the device analog of
    the native q11 best-of (brotlig_encode.cpp::EncodePage).

    Returns a list of page blobs: the compressed page, or the raw page
    bytes when not smaller. For preconditioned streams pages_np holds the
    delta-encoded form and raw_pages_np the conditioned non-delta form the
    raw fallback must store (the decoder skips delta decode on raw pages).
    """
    from .encode import find_commands
    from ..utils import jaxcache as _jc
    _jc.clear_if_bloated()   # LLVM-JIT mmap-region guard (see decode.py)
    max_cmds = page_size // 4 + 16   # every command copies >= MIN_MATCH=4
    pages = jnp.asarray(pages_np)
    in_sizes = jnp.asarray(in_sizes_np)
    # q1 tier ranks candidates with the short-probe matcher (~6x fewer
    # gathers); the q11 tier keeps full-depth ranking since its greedy
    # parse both competes and seeds the DP
    greedy = find_commands(pages, in_sizes, max_cmds, quality < 10)
    if isdelta_np is None:
        isdelta_np = np.zeros(pages_np.shape[0], dtype=np.int32)
    isdelta = jnp.asarray(isdelta_np, dtype=jnp.int32)
    out_np, sizes_np = _pack_partitioned(pages, in_sizes, page_size,
                                         max_cmds, *greedy, isdelta)
    if quality >= 10:
        from .parse_dp import find_commands_dp
        dcmds = find_commands_dp(pages_np, in_sizes_np, max_cmds,
                                 greedy_cmds=greedy)
        out2_np, sizes2_np = _pack_partitioned(
            pages, in_sizes, page_size, max_cmds,
            *(jnp.asarray(x) for x in dcmds), isdelta)
        win = sizes2_np < sizes_np
        out_np = np.where(win[:, None], out2_np, out_np)
        sizes_np = np.where(win, sizes2_np, sizes_np)
    raw_src = pages_np if raw_pages_np is None else raw_pages_np
    blobs = []
    for i in range(pages_np.shape[0]):
        n = int(in_sizes_np[i])
        sz = int(sizes_np[i])
        if sz >= n:
            blobs.append(raw_src[i, :n].tobytes())
        else:
            blobs.append(out_np[i, :sz].tobytes())
    return blobs


def encode_stream_device_full(data: bytes, page_size: int = 65536,
                              batch_pages: int = 64,
                              dc_params=None, feedback=None,
                              quality: int = 11) -> bytes:
    """Container encode with BOTH match finding and serialization on device
    (the native packer is not involved). `dc_params` enables BCn
    preconditioning: the condition gather + per-page delta also run on
    device (ops/precondition.py::preprocess_device). quality >= 10 runs
    the windowed-DP optimal parse, best-of against greedy per page.

    feedback(msg_type, text) -> bool is called once per device batch;
    returning True aborts with errors.Aborted."""
    from ..format.errors import Aborted, MessageType
    from ..format.headers import (PreconditionHeader, StreamHeader,
                                  pack_page_table)

    if not (C.MIN_PAGE_SIZE <= page_size <= C.MAX_PAGE_SIZE):
        raise ValueError("page size out of range")
    precondition = dc_params is not None and dc_params.precondition
    if precondition and not dc_params.initialize(len(data)):
        precondition = False  # geometry mismatch: downgrade (ref behavior)
    header = StreamHeader.for_input(len(data), page_size, precondition)
    if len(data) == 0:
        return header.pack()
    num_pages = header.num_pages

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
        raw = np.zeros((Pb, page_size), dtype=np.uint8)
        sizes = np.zeros(Pb, dtype=np.int32)
        isdelta = np.zeros(Pb, dtype=np.int32)
        for row, i in enumerate(group):
            chunk = work[i * page_size: (i + 1) * page_size]
            arr[row, : len(chunk)] = np.frombuffer(chunk, np.uint8)
            rchunk = raw_form[i * page_size: (i + 1) * page_size]
            raw[row, : len(rchunk)] = np.frombuffer(rchunk, np.uint8)
            sizes[row] = len(chunk)
            isdelta[row] = int(isdelta_flags[i])
        pages_out.extend(encode_pages_device(arr, sizes, page_size,
                                             isdelta, raw,
                                             quality=quality))
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
