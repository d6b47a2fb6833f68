"""Stage-level profile of the device encode path (PERF.md encode section).

Times, on the default jax device over a mixed corpus batch:
  matcher   — ops/encode.py::find_commands (bulk-greedy LZ77)
  dp        — ops/parse_dp.py::find_commands_dp (windowed-DP optimal parse)
  pack      — ops/encode_pack.py::pack_pages_device (device serializer)
  e2e_q1    — encode_pages_device(quality=1)  (matcher + pack)
  e2e_q11   — encode_pages_device(quality=11) (matcher + DP + pack, best-of)

Each stage ends in block_until_ready. Compare shares within one run;
absolute times need the card's name and power limit beside them.

Usage: [BENCH_PAGES=64] [PROF_REPS=3] python tools/profile_encode.py
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from brotlig_tpu.utils import jaxcache

jaxcache.enable()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from chip_smoke import PAGE_SIZE, make_corpus  # noqa: E402
from brotlig_tpu.ops.encode import find_commands  # noqa: E402
from brotlig_tpu.ops.encode_pack import _pack_jit, \
    encode_pages_device  # noqa: E402
from brotlig_tpu.ops.parse_dp import find_commands_dp  # noqa: E402


def fetch(tree):
    return jax.block_until_ready(tree)


def timeit(label, fn, reps):
    fn()                       # warmup / compile
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    best = min(ts)
    print(json.dumps({"stage": label, "ms": round(best * 1e3, 2),
                      "all_ms": [round(t * 1e3, 1) for t in ts]}),
          flush=True)
    return best


def main():
    n_pages = int(os.environ.get("BENCH_PAGES", "64"))
    reps = int(os.environ.get("PROF_REPS", "3"))
    arr = np.frombuffer(make_corpus(n_pages, 0), np.uint8).reshape(
        n_pages, PAGE_SIZE)
    total = arr.size
    sizes = np.full(n_pages, PAGE_SIZE, dtype=np.int32)
    pages = jnp.asarray(arr)
    in_sizes = jnp.asarray(sizes)
    max_cmds = PAGE_SIZE // 4 + 16
    isdelta = jnp.zeros(n_pages, dtype=jnp.int32)

    t_match = timeit("matcher", lambda: fetch(
        find_commands(pages, in_sizes, max_cmds)), reps)
    timeit("matcher_fast", lambda: fetch(
        find_commands(pages, in_sizes, max_cmds, True)), reps)

    greedy = find_commands(pages, in_sizes, max_cmds)
    greedy = tuple(jnp.asarray(np.asarray(g)) for g in greedy)

    t_pack = timeit("pack", lambda: fetch(
        _pack_jit(pages, in_sizes, PAGE_SIZE, max_cmds, *greedy, isdelta)),
        reps)

    t_dp = timeit("dp", lambda: fetch(tuple(
        jnp.asarray(x) for x in find_commands_dp(
            arr, sizes, max_cmds, greedy_cmds=greedy))), reps)

    def e2e(q):
        blobs = encode_pages_device(arr, sizes, PAGE_SIZE, quality=q)
        return sum(len(b) for b in blobs)

    t_q1 = timeit("e2e_q1", lambda: e2e(1), reps)
    t_q11 = timeit("e2e_q11", lambda: e2e(11), reps)

    comp = e2e(11)
    print(json.dumps({
        "pages": n_pages, "bytes": total,
        "q1_gbps": round(total / t_q1 / 1e9, 6),
        "q11_gbps": round(total / t_q11 / 1e9, 6),
        "ratio_q11": round(total / comp, 3),
        "shares": {"matcher": round(t_match / t_q11, 3),
                   "dp": round(t_dp / t_q11, 3),
                   "pack": round(t_pack / t_q11, 3)},
    }), flush=True)


if __name__ == "__main__":
    main()
