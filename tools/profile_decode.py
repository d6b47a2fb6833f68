"""Stage profile of the device decode path on one GPU.

    python tools/profile_decode.py [--pages 256] [--route triton]
                                   [--trace DIR]

On one batch of the chip_smoke corpus (64 KiB pages, native q5 encode):
times the table build, phase A on `--route`, and phase B, each ending in
block_until_ready. With --trace, records a jax.profiler trace of one
decode_pages call into DIR and prints the device time per operation name
(largest first) and the device busy share of the traced window.
"""
import argparse
import glob
import json
import os
import sys
import time
from collections import Counter

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as CS  # noqa: E402


def timeit(fn, reps):
    import jax
    jax.block_until_ready(fn())
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return min(ts)


def device_op_times(trace_dir: str, top: int = 15):
    """(per-op device seconds, busy share) from the newest xplane trace."""
    import jax
    path = sorted(glob.glob(os.path.join(
        trace_dir, "plugins", "profile", "*", "*.xplane.pb")))[-1]
    data = jax.profiler.ProfileData.from_file(path)
    per_op: Counter = Counter()
    spans = []
    for plane in data.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            for ev in line.events:
                per_op[ev.name] += ev.duration_ns * 1e-9
                spans.append((ev.start_ns, ev.start_ns + ev.duration_ns))
    busy = 0.0
    if spans:
        spans.sort()
        cur_s, cur_e = spans[0]
        for s, e in spans[1:]:
            if s > cur_e:
                busy += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        busy += cur_e - cur_s
        window = max(e for _, e in spans) - spans[0][0]
        busy = busy / window if window else 0.0
    return per_op.most_common(top), busy


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--pages", type=int, default=256)
    ap.add_argument("--route", default=None)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--trace", default=None)
    args = ap.parse_args()
    jax = CS.require_gpu()
    from brotlig_tpu import native
    from brotlig_tpu.ops.decode import (_stage_symbols, decode_pages,
                                        decode_pages_finish, max_cmds_for,
                                        resolve_route, symbol_inputs)
    from brotlig_tpu.utils import jaxcache
    jaxcache.enable()
    route = resolve_route(args.route)
    ps = CS.PAGE_SIZE
    data = CS.make_corpus(args.pages, 0)
    blob = native.encode(data, page_size=ps, quality=CS.BUNDLE_QUALITY)
    words, sizes, _ = CS.page_batch(data, blob, args.pages)
    mc = max_cmds_for(ps)
    state = _stage_symbols(words, sizes, ps, mc, route)
    res = {
        "tables_s": timeit(lambda: jax.jit(symbol_inputs)(words, sizes),
                           args.reps),
        "symbols_s": timeit(lambda: _stage_symbols(words, sizes, ps, mc,
                                                   route), args.reps),
        "lz_s": timeit(lambda: decode_pages_finish(state, ps, mc)[0],
                       args.reps),
        "decode_pages_s": timeit(lambda: decode_pages(
            words, sizes, ps, mc, route)[0], args.reps),
    }
    print(json.dumps({"route": route, "pages": args.pages, **res,
                      "card": CS.card_line()}), flush=True)
    if args.trace:
        with jax.profiler.trace(args.trace):
            jax.block_until_ready(decode_pages(words, sizes, ps, mc,
                                               route)[0])
        ops, busy = device_op_times(args.trace)
        print(json.dumps({"device_busy_share": busy,
                          "top_ops_s": ops}), flush=True)


if __name__ == "__main__":
    main()
