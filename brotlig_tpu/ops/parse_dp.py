"""Device optimal parse (windowed DP) — the data-parallel analog of Zopfli.

The reference encoder's ratio comes from brotli's q11 optimal parse
(reference PageEncoder.cpp:87-147 wraps BrotliCreateHqZopfliBackwardReferences):
a shortest path over literal/match transitions under a cost model fit to
the previous pass. The native twin here is
native/brotlig_encode.cpp::ParseOptimal — inherently sequential (each
dp[i] depends on dp[i-1]). This module is the data-parallel
reformulation:

* pass 1: the bulk-greedy parse (ops/encode.py) supplies command/literal/
  distance histograms; the cost model mirrors what the device serializer
  will actually pay — the serializer's own table lengths
  (encode_pack._choose_table), the page's searched (npostfix, ndirect),
  per-copy-code command-symbol costs weighted over the insert-code
  distribution, and per-literal amortization of insert extra bits. Same
  blueprint as the native BuildCostModel (brotlig_encode.cpp:703-784),
  vectorized over pages.
* pass 2: dp[p] = min bits to encode the first p bytes. The sequential
  relaxation becomes a `lax.scan` over B-position blocks with a W-deep
  source window: literal chains of any length collapse into ONE cummin
  per round (a literal run's cost is a prefix-sum difference, so
  dp[t] = A[t] + min_{t'<=t}(dp[t'] - A[t']) — no per-byte steps), and
  match edges relax by gather over the static copy-code bucket base
  lengths plus one scatter-min for each candidate's full length. R
  rounds per block bound how many match edges can chain inside one
  block; denser paths degrade gracefully to valid (slightly suboptimal)
  parses because every relaxation writes a realizable backpointer.

Costs are half-bit fixed point packed with the backpointer length into
one int32 ((cost << 10) | from_len), so min() carries the argmin for
free; ties break toward shorter lengths. Backtracking runs on host,
vectorized over literal runs (one bisect per command, not per byte).
"""
from __future__ import annotations

import bisect
from functools import partial

import os

import jax
import jax.numpy as jnp
import numpy as np

from . import arith_lut
from .encode import _match_len, _quads, find_candidates, find_commands
from .encode_pack import (A_CMD, A_DST, A_LIT, _build_fields, _choose_table,
                          _encode_distance_vec, _histogram, _ring_before,
                          combine_codes_vec, cpy_code_vec, ins_code_vec)

I32 = jnp.int32

# copy-length code base lengths (RFC 7932; native kCpyBase)
CPY_BASE = (2, 3, 4, 5, 6, 7, 8, 9, 10, 12, 14, 18, 22, 30, 38, 54, 70,
            102, 134, 198, 262, 390, 518, 774)

COST_BITS = 21                    # half-bit cost field
LEN_BITS = 10                     # from_len field (W <= 1023)
INF_Q = (1 << COST_BITS) - 1      # saturating cost, half-bits


def _copy_code_static(L: int) -> int:
    """GetCopyCode for a static length (python int)."""
    cc = 0
    for i, b in enumerate(CPY_BASE):
        if b <= L:
            cc = i
    return cc


@partial(jax.jit, static_argnums=(8,))
def build_cost_model(pages, in_sizes, ins, cpy, dist, ncmds, base_len,
                     base_dist, max_cmds: int):
    """Per-page DP cost tables + candidate set from a previous parse.

    Mirrors native BuildCostModel (brotlig_encode.cpp:703-784) but uses
    the device serializer's own table-mode lengths and the page's
    searched (npostfix, ndirect), so costs are serializer-exact. The
    ring approximation mirrors the native ring-aware pass
    (brotlig_encode.cpp:830-886): each byte inherits the distance-ring
    state the PREVIOUS parse would have at its covering command, the four
    ring distances are probed as extra match candidates (native limit 16
    bytes), and any candidate whose distance ring-codes against the
    inherited state is credited the ring symbol's cost (zero extra bits).

    Returns (litq [P,S], jointEq/jointLq [P,576],
    cand_len/cand_dist/dpackq [P,S,K+4]):
      litq    — cost of byte p as a literal (pure table cost)
      jointEq — joint (ins,cpy) command-symbol cost, explicit-distance form
      jointLq — same, implicit-ring0 (use_last) form; INF where the form
                does not exist (ic >= 8 or cc >= 16)
      dpackq  — (distance cost of candidate k at p << 1) | ring0-hit flag
    """
    P, S = pages.shape
    N = ins.shape[1]
    fields, ntotal, tail, has_tail, npostfix, best_ndist = _build_fields(
        pages, in_sizes, ins, cpy, dist, ncmds, max_cmds)
    ndirect = best_ndist << npostfix
    rows = jnp.arange(P, dtype=I32)
    cid = jnp.arange(N, dtype=I32)[None, :]
    valid = cid < ncmds[:, None]

    # ---- histograms, exactly as pack_pages_device builds them ----
    prefix_arr = fields["prefix"][0]
    hist_cmd = _histogram(prefix_arr, valid, A_CMD)
    tail_pref = fields["prefix"][1]
    hist_cmd = hist_cmd.at[rows, jnp.clip(tail_pref, 0, A_CMD - 1)].add(
        has_tail.astype(I32))
    hist_cmd = hist_cmd.at[:, 704].add(1)
    hist_dst = _histogram(fields["dsym"][0], fields["sdist"][0] > 0, A_DST)

    pos_idx = jnp.broadcast_to(jnp.arange(S, dtype=I32)[None, :], (P, S))
    cov = ins + cpy
    starts = jnp.cumsum(cov, axis=1) - cov
    # covering command via searchsorted over the nondecreasing starts
    starts_m = jnp.where(valid, starts, jnp.int32(1) << 29)
    cmd_of = jnp.clip(jax.vmap(
        lambda a, q: jnp.searchsorted(a, q, side="right"))(
        starts_m, pos_idx) - 1, 0, N - 1)
    st_of = jnp.take_along_axis(starts, cmd_of, axis=1)
    ins_of = jnp.take_along_axis(ins, cmd_of, axis=1)
    covered = jnp.sum(cov, axis=1)
    in_lit = ((pos_idx < st_of + ins_of)
              | (pos_idx >= covered[:, None])) & (pos_idx < in_sizes[:, None])
    hist_lit = _histogram(pages.astype(I32), in_lit, A_LIT)
    n_lits = jnp.sum(hist_lit, axis=1)

    # ---- serializer table lengths -> per-symbol half-bit costs ----
    def sym_cost(hist, total, A, unseen_pad):
        lens, _, _, _, _ = _choose_table(hist, total, A)
        tot = jnp.maximum(total, 1).astype(jnp.float32)
        unseen = jnp.minimum(
            15.0, jnp.log2(tot) + unseen_pad)[:, None]
        c = jnp.where(hist > 0, lens.astype(jnp.float32), unseen)
        return c  # bits, float32 [P, A]

    lit_c = sym_cost(hist_lit, n_lits, A_LIT, 2.0)
    dst_c = sym_cost(hist_dst, jnp.sum(hist_dst, axis=1), A_DST, 4.0)
    cmd_c = sym_cost(hist_cmd, jnp.sum(hist_cmd, axis=1), A_CMD, 2.0)

    # ---- exact joint (ins, cpy) command-symbol costs [P, 576]: the DP
    # carries each node's pending-insert anchor, so relax prices the REAL
    # joint symbol + both extra-bit fields instead of the insert-code
    # expectation (mirrors native CostModel::cmd_sym, round-4 — the
    # expectation understated long-insert text commands) ----
    grid = jnp.arange(24, dtype=I32)
    pe = combine_codes_vec(grid[:, None], grid[None, :],
                           jnp.zeros((24, 24), bool))       # [ic, cc]
    pe_cost = cmd_c[:, pe.reshape(-1)].reshape(P, 24, 24)   # [P, ic, cc]
    jointEq = jnp.round(2.0 * pe_cost).astype(I32).reshape(P, 576)
    pl = combine_codes_vec(grid[:, None], grid[None, :],
                           jnp.ones((24, 24), bool))
    pl_cost = cmd_c[:, pl.reshape(-1)].reshape(P, 24, 24)
    repr_ok = (grid[:, None] < 8) & (grid[None, :] < 16)    # use_last form
    jointLq = jnp.where(repr_ok[None],
                        jnp.round(2.0 * pl_cost).astype(I32),
                        INF_Q).reshape(P, 576)

    # ---- per-byte literal cost (pure table cost: insert extra bits are
    # now paid exactly at the command via the anchor) ----
    lit_of_byte = jnp.take_along_axis(lit_c, pages.astype(I32), axis=1)
    litq = jnp.round(2.0 * lit_of_byte).astype(I32)

    # ---- inherited ring state per byte (exact replay of the previous
    # parse via _ring_before; tail bytes inherit the post-parse state) ----
    is_copy = valid & (cpy > 0) & (dist > 0)
    dist_e = jnp.concatenate([dist, jnp.zeros((P, 1), I32)], axis=1)
    val_e = jnp.concatenate([is_copy, jnp.zeros((P, 1), bool)], axis=1)
    rings = _ring_before(dist_e, val_e)                 # 4 x [P, N+1]
    cmd_of_e = jnp.where(pos_idx >= covered[:, None], ncmds[:, None],
                         cmd_of)
    rb = [jnp.take_along_axis(r, jnp.clip(cmd_of_e, 0, N), axis=1)
          for r in rings]                               # 4 x [P, S]

    # ---- ring-distance probe candidates (native limit: 16 bytes) ----
    quads = _quads(pages)
    limit = in_sizes[:, None]
    ring_l, ring_d = [], []
    for r in rb:
        cnd = jnp.where((r >= 1) & (pos_idx - r >= 0), pos_idx - r, -1)
        ml = _match_len(quads, pos_idx, cnd, limit, words=4)
        ok = ml >= 2
        ring_l.append(jnp.where(ok, ml, 0))
        ring_d.append(jnp.where(ok, r, 0))
    cand_len = jnp.concatenate(
        [base_len, jnp.stack(ring_l, axis=2)], axis=2)
    cand_dist = jnp.concatenate(
        [base_dist, jnp.stack(ring_d, axis=2)], axis=2)

    # ---- candidate distance costs: explicit symbol + extra bits,
    # credited with the ring code against the inherited state when the
    # distance hits (codes 0-15 cost their table symbol, no extra) ----
    K = cand_dist.shape[2]
    d_flat = jnp.maximum(cand_dist.reshape(P, S * K), 1)
    dsym, dnb, _ = _encode_distance_vec(d_flat, npostfix, ndirect)
    dbits = jnp.where(dsym < A_DST,
                      jnp.take_along_axis(dst_c, jnp.clip(dsym, 0, A_DST - 1),
                                          axis=1), 40.0)
    dq = jnp.round(2.0 * dbits).astype(I32) + 2 * dnb
    dq = dq.reshape(P, S, K)

    rsym = jnp.full((P, S, K), -1, I32)
    d3 = cand_dist
    pairs = [(rb[0], 0), (rb[1], 1), (rb[2], 2), (rb[3], 3)]
    for j in range(3):
        pairs += [(rb[0] - (j + 1), 4 + 2 * j), (rb[0] + (j + 1), 5 + 2 * j)]
    for j in range(3):
        pairs += [(rb[1] - (j + 1), 10 + 2 * j),
                  (rb[1] + (j + 1), 11 + 2 * j)]
    for val, code in reversed(pairs):
        rsym = jnp.where((d3 == val[:, :, None]) & (d3 >= 1), code, rsym)
    ring_bits = jnp.take_along_axis(
        dst_c, jnp.clip(rsym, 0, A_DST - 1).reshape(P, S * K),
        axis=1).reshape(P, S, K)
    ring_q = jnp.round(2.0 * ring_bits).astype(I32)
    dq = jnp.where(rsym >= 0, jnp.minimum(dq, ring_q), dq)
    # low bit flags a ring-0 hit: relax may then use the implicit-ring0
    # (use_last) joint symbol with NO distance emission (jointLq), the
    # native rsym==0 channel (brotlig_encode.cpp:888-892)
    dpackq = (jnp.minimum(dq, INF_Q) << 1) | (rsym == 0)
    return litq, jointEq, jointLq, cand_len, cand_dist, dpackq


# copy extra-bit widths by code (RFC 7932), half-bit units. Insert extra
# bits are priced at runtime via 2*arith_lut.insert_extra (ADVICE r4
# removed the dead static twin); this copy table is pinned equal to
# 2*arith_lut.copy_extra by tests/test_ops_encode.py.
_CPY_EXTRA_Q = 2 * np.asarray(
    [0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 2, 2, 3, 3, 4, 4,
     5, 5, 6, 7, 8, 9, 10, 24], np.int32)


@partial(jax.jit, static_argnums=(5, 6, 7))
def dp_parse(litq, cand_len, dpackq, jointEq, jointLq,
             B: int, W: int, R: int):
    """Windowed-DP shortest path. Returns combined [P, S] int32 where
    column p-1 holds ((dp[p] half-bits) << LEN_BITS) | from_len(p);
    from_len 0 means a literal step.

    litq/cand_len/dpackq/jointEq/jointLq from build_cost_model;
    B = block size, W = source window (max match length relaxed), R =
    match-edge rounds per block. Requires S % B == 0, W % B == 0,
    W <= 1023, B <= 63.

    Each node carries its pending-insert ANCHOR (absolute position of the
    last command end on its best path; native ParseOptimalPass `anch`,
    brotlig_encode.cpp:837-841), so match relaxes price the exact joint
    (ins, cpy) symbol + insert extra bits instead of the insert-code
    expectation. Anchors propagate through the literal closure via a
    packed argmin-cummin; a match relax that wins sets the target's
    anchor to the target itself (a command ends there)."""
    P, S = litq.shape
    K = cand_len.shape[2]
    assert S % B == 0 and W % B == 0 and W < (1 << LEN_BITS) and B <= 63
    nblocks = S // B
    INF_C = INF_Q << LEN_BITS

    # left-pad byte-indexed arrays by W so window slices start at >= 0, and
    # right-pad by B so the LAST block's slice start (s0+1) is never clamped
    # by dynamic_slice (a clamp silently shifts the whole window one byte)
    litq_p = jnp.concatenate(
        [jnp.zeros((P, W), I32), litq, jnp.zeros((P, B), I32)], axis=1)
    clen_p = jnp.concatenate(
        [jnp.zeros((P, W, K), I32), cand_len,
         jnp.zeros((P, B, K), I32)], axis=1)
    dpk_p = jnp.concatenate(
        [jnp.full((P, W, K), INF_Q << 1, I32), dpackq,
         jnp.full((P, B, K), INF_Q << 1, I32)], axis=1)

    # static bucket-base edge tables
    LENS = [l for l in CPY_BASE if l <= W]
    nL = len(LENS)
    lens_np = np.asarray(LENS, np.int32)
    cc_np = np.asarray([_copy_code_static(l) for l in LENS], np.int32)
    # source index in the [dpwin | dp_blk] concat for target t, length L
    u_grid = np.asarray(
        [[W + t - l for l in LENS] for t in range(B)], np.int32)  # [B, nL]

    lens_c = jnp.asarray(lens_np)
    cpyx_b = jnp.asarray(_CPY_EXTRA_Q[cc_np])               # [nL]
    ccb = jnp.asarray(cc_np)

    rows = jnp.arange(P, dtype=I32)[:, None]

    init_win = jnp.full((P, W), INF_C, I32).at[:, W - 1].set(0)
    init_anch = jnp.zeros((P, W), I32)      # node dp[0] has anchor 0

    def block(carry, k):
        dpwin, anchwin = carry
        s0 = k * B
        litw = jax.lax.dynamic_slice(litq_p, (0, s0 + 1), (P, W + B))
        clenw = jax.lax.dynamic_slice(clen_p, (0, s0 + 1, 0), (P, W + B, K))
        dpkw = jax.lax.dynamic_slice(dpk_p, (0, s0 + 1, 0), (P, W + B, K))
        dcw = dpkw >> 1
        rs0w = (dpkw & 1) > 0               # ring-0 hit flag per candidate

        # full-length edges: the dist + copy-extra part is dp-independent
        ccf = cpy_code_vec(jnp.maximum(clenw, 2))
        cpyx_f = 2 * arith_lut.copy_extra(ccf)
        full_rest = jnp.minimum(dcw + cpyx_f, INF_Q)
        o_idx = jnp.arange(W + B, dtype=I32)[None, :, None]
        full_t = o_idx + clenw - W
        full_ok = (clenw >= 2) & (full_t >= 0) & (full_t < B)
        full_ti = jnp.where(full_ok, full_t, B).reshape(P, -1)

        # bucket-base edges: dist + copy-extra part [P, B, nL, K]
        cl_g = clenw[:, u_grid, :]                          # [P, B, nL, K]
        dc_g = dcw[:, u_grid, :]
        rs0_g = rs0w[:, u_grid, :]
        base_rest = jnp.minimum(
            dc_g + cpyx_b[None, None, :, None], INF_Q)
        base_ok = cl_g >= lens_c[None, None, :, None]
        base_tag = lens_c[None, None, :, None]              # from_len

        # literal prefix sums for the closure: lp[t] = litq(byte s0+t)
        lp = litw[:, W - 1: W + B - 1]
        A = jnp.cumsum(lp, axis=1)                          # inclusive

        seed = dpwin[:, W - 1] >> LEN_BITS
        seed_anch = anchwin[:, W - 1]
        # absolute node position of concat cell u / block cell t
        pos_cat = s0 + 1 + jnp.arange(W + B, dtype=I32)[None, :] - W
        pos_blk = pos_cat[:, W:]
        bidx = jnp.arange(B, dtype=I32)[None, :]

        def closure(dp_blk, anch_blk):
            c = dp_blk >> LEN_BITS
            m = c - A
            srcm = jnp.concatenate([seed[:, None], m[:, :-1]], axis=1)
            # packed argmin: value in high bits, source cell in low 6
            # (m >= -A_total > -4096: litq < 64 half-bits/byte, B <= 63)
            zp = jax.lax.cummin(((srcm + 4096) << 6) | bidx, axis=1)
            z = (zp >> 6) - 4096
            widx = zp & 63
            litc = jnp.minimum(z + A, INF_Q)
            take_lit = litc < c
            anch_src = jnp.concatenate(
                [seed_anch[:, None], anch_blk[:, :-1]], axis=1)
            win_anch = jnp.take_along_axis(anch_src, widx, axis=1)
            dp_blk = jnp.where(take_lit, litc << LEN_BITS, dp_blk)
            anch_blk = jnp.where(take_lit, win_anch, anch_blk)
            return dp_blk, anch_blk

        def round_body(_, carry_rb):
            dp_blk, anch_blk = carry_rb
            dp_blk, anch_blk = closure(dp_blk, anch_blk)
            dp0 = dp_blk
            dp_cat = jnp.concatenate([dpwin, dp_blk], axis=1)
            cost_cat = dp_cat >> LEN_BITS
            anch_cat = jnp.concatenate([anchwin, anch_blk], axis=1)
            pend = jnp.clip(pos_cat - anch_cat, 0, 1 << 22)
            ic_u = ins_code_vec(pend)                       # [P, W+B]
            insx_u = 2 * arith_lut.insert_extra(ic_u)

            # gather relax over bucket-base lengths (cc static per l)
            src = cost_cat[:, u_grid]                       # [P, B, nL]
            ic_g = ic_u[:, u_grid]
            jidx = (ic_g * 24 + ccb[None, None, :]).reshape(P, -1)
            jE = jnp.take_along_axis(jointEq, jidx, axis=1) \
                .reshape(P, B, nL)
            jL = jnp.take_along_axis(jointLq, jidx, axis=1) \
                .reshape(P, B, nL)
            cmd_e = src + insx_u[:, u_grid] + jE            # [P, B, nL]
            tot = jnp.minimum(cmd_e[:, :, :, None] + base_rest, INF_Q)
            # use_last channel: ring-0 candidates emit no distance at all
            cmd_l = src + insx_u[:, u_grid] + jL
            totL = jnp.minimum(
                cmd_l[:, :, :, None] + cpyx_b[None, None, :, None], INF_Q)
            tot = jnp.where(rs0_g, jnp.minimum(tot, totL), tot)
            tot = jnp.where(base_ok, tot, INF_Q)
            comb = (tot << LEN_BITS) | base_tag
            best = jnp.min(comb.reshape(P, B, nL * K), axis=2)
            dp_blk = jnp.minimum(dp_blk, best)

            # scatter relax for full candidate lengths
            jfi = (ic_u[:, :, None] * 24 + ccf).reshape(P, -1)
            jEf = jnp.take_along_axis(jointEq, jfi, axis=1) \
                .reshape(P, W + B, K)
            jLf = jnp.take_along_axis(jointLq, jfi, axis=1) \
                .reshape(P, W + B, K)
            head = cost_cat[:, :, None] + insx_u[:, :, None]
            fE = jnp.minimum(head + jEf + full_rest, INF_Q)
            fL = jnp.minimum(head + jLf + cpyx_f, INF_Q)
            fcost = jnp.where(rs0w, jnp.minimum(fE, fL), fE)
            fcost = jnp.where(full_ok, fcost, INF_Q)
            fcomb = ((fcost << LEN_BITS) | clenw).reshape(P, -1)
            dp_blk = dp_blk.at[rows, full_ti].min(fcomb, mode="drop")

            # a winning match relax ends a command at its target
            anch_blk = jnp.where(dp_blk < dp0, pos_blk, anch_blk)
            return dp_blk, anch_blk

        dp_blk, anch_blk = jax.lax.fori_loop(
            0, R, round_body,
            (jnp.full((P, B), INF_C, I32), jnp.zeros((P, B), I32)))
        dp_blk, anch_blk = closure(dp_blk, anch_blk)
        new_win = jnp.concatenate([dpwin, dp_blk], axis=1)[:, -W:]
        new_anch = jnp.concatenate([anchwin, anch_blk], axis=1)[:, -W:]
        return (new_win, new_anch), dp_blk

    _, blocks = jax.lax.scan(block, (init_win, init_anch),
                             jnp.arange(nblocks))
    return jnp.transpose(blocks, (1, 0, 2)).reshape(P, S)



def backtrack(combined_np, cand_len_np, cand_dist_np, dpackq_np,
              in_sizes_np, max_cmds: int):
    """Walk DP backpointers into dense (ins, cpy, dist, ncmds) arrays.

    Literal runs cost one bisect per command, not one step per byte:
    `ends` lists every dp index whose best in-edge is a match, and the
    literal chase from q is exactly "last such index <= q".

    dpackq_np carries (distance cost << 1) | ring0 flag: the DP edge may
    have won through the implicit-ring0 (use_last) channel, which only a
    ring0 candidate realizes, so one is preferred at the winning
    (start, L) before falling back to the cheapest explicit distance
    (ADVICE r4: emitting the explicit argmin there mismatched the cost
    the DP priced)."""
    P, S = combined_np.shape
    flen = (combined_np & ((1 << LEN_BITS) - 1)).astype(np.int64)
    ins_o = np.zeros((P, max_cmds), np.int32)
    cpy_o = np.zeros((P, max_cmds), np.int32)
    dist_o = np.zeros((P, max_cmds), np.int32)
    nc_o = np.zeros(P, np.int32)
    for p in range(P):
        n = int(in_sizes_np[p])
        if n == 0:
            continue
        fl = flen[p]
        ends = (np.nonzero(fl[:n] > 0)[0] + 1).tolist()
        cmds = []
        q = n
        while True:
            j = bisect.bisect_right(ends, q) - 1
            if j < 0:
                break
            e = ends[j]
            L = int(fl[e - 1])
            start = e - L
            ks = np.nonzero(cand_len_np[p, start] >= L)[0]
            pk = dpackq_np[p, start, ks]
            r0 = ks[(pk & 1) > 0]
            if r0.size:
                # a ring0 candidate realizes the use_last channel the DP
                # may have priced (no distance emission at all)
                k = r0[np.argmin(dpackq_np[p, start, r0] >> 1)]
            else:
                k = ks[np.argmin(pk >> 1)]
            cmds.append((start, L, int(cand_dist_np[p, start, k])))
            q = start
        if len(cmds) > max_cmds:
            nc_o[p] = -1        # overflow: caller falls back to greedy
            continue
        cmds.reverse()
        pos = 0
        for i, (start, L, d) in enumerate(cmds):
            ins_o[p, i] = start - pos
            cpy_o[p, i] = L
            dist_o[p, i] = d
            pos = start + L
        nc_o[p] = len(cmds)
    return ins_o, cpy_o, dist_o, nc_o


def find_commands_dp(pages, in_sizes, max_cmds: int,
                     iters: int | None = None,
                     B: int = 32, W: int = 512, R: int = 16,
                     greedy_cmds=None):
    """Two-pass optimal parse on device (greedy stats -> DP, iterated).

    pages: uint8 [P, S] jnp/np; in_sizes: int32 [P].
    Returns (ins, cpy, dist, ncmds) numpy arrays like find_commands;
    pages whose DP parse overflows max_cmds (len-2 copies can double the
    command count) keep their greedy commands. The native analog
    iterates the cost model the same way
    (brotlig_encode.cpp::ParseOptimal, ring-aware iters=3).
    greedy_cmds: optional precomputed find_commands output to seed the
    cost model (avoids recomputing the match scan)."""
    from ..utils import jaxcache as _jc
    _jc.clear_if_bloated()   # LLVM-JIT mmap-region guard (see decode.py)
    if iters is None:
        # cost-model iterations (native ring-aware default: 3); env knob
        # for quality/compile-time experiments
        iters = int(os.environ.get("BLG_DP_ITERS", "3"))
    pages = jnp.asarray(pages)
    sizes = jnp.asarray(in_sizes)
    if greedy_cmds is None:
        greedy_cmds = find_commands(pages, sizes, max_cmds)
    ins, cpy, dist, ncmds = (jnp.asarray(x) for x in greedy_cmds)
    greedy = tuple(np.asarray(x) for x in (ins, cpy, dist, ncmds))
    base_len, base_dist = find_candidates(pages, sizes, W)
    for _ in range(iters):
        (litq, jointEq, jointLq, cand_len, cand_dist,
         dpackq) = build_cost_model(
            pages, sizes, ins, cpy, dist, ncmds, base_len, base_dist,
            max_cmds)
        ins_n, cpy_n, dist_n, nc_n = backtrack(
            np.asarray(dp_parse(litq, cand_len, dpackq, jointEq, jointLq,
                                B, W, R)),
            np.asarray(cand_len), np.asarray(cand_dist),
            np.asarray(dpackq), np.asarray(in_sizes), max_cmds)
        over = nc_n < 0
        if over.any():
            for p in np.nonzero(over)[0]:
                ins_n[p], cpy_n[p], dist_n[p] = (
                    greedy[0][p], greedy[1][p], greedy[2][p])
                nc_n[p] = greedy[3][p]
        ins, cpy, dist, ncmds = (jnp.asarray(ins_n), jnp.asarray(cpy_n),
                                 jnp.asarray(dist_n), jnp.asarray(nc_n))
    return ins_n, cpy_n, dist_n, nc_n
