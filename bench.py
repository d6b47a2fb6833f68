"""Brotli-G decode benchmark on one GPU.

    python bench.py

Prints ONE JSON line. The headline metric is served-path decode
throughput (uncompressed GB/s): `brotlig_tpu.decode` over the whole
container of a seeded mixed corpus (chip_smoke.make_corpus, PAGES x 64 KiB),
from host bytes in to host bytes out, validated against the input. The
native C++ decoder is timed over the same container in the same run (one
thread and all threads); `vs_baseline` divides the headline by the
one-thread figure. Per-layer fields: `device_batch_gbps` is the same pages
as one `decode_pages` batch already on the device, timed with
block_until_ready; then the preconditioned-texture and pooled-archive
decode rates, the device encoders' ratios, and the device and card.

A run that finds no GPU fails; it does not fall back to the CPU.
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402

import chip_smoke as CS  # noqa: E402
from chip_smoke import check  # noqa: E402

PAGE_SIZE = CS.PAGE_SIZE
PAGES = 256
REPS = 5
SEED = 0


def _best(fn, reps):
    import jax
    jax.block_until_ready(fn())                      # warm / compile
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return min(ts)


def _wall(fn, reps):
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return min(ts)


def main():
    jax = CS.require_gpu()
    from brotlig_tpu import native
    from brotlig_tpu.ops.decode import (decode_pages, max_cmds_for,
                                        resolve_route)
    from brotlig_tpu.utils import jaxcache
    jaxcache.enable()

    import brotlig_tpu
    data = CS.make_corpus(PAGES, SEED)
    blob = native.encode(data, page_size=PAGE_SIZE, quality=11)
    nbytes = len(data)

    check(brotlig_tpu.decode(blob) == data, "decode != input")
    served_s = _wall(lambda: brotlig_tpu.decode(blob), REPS)
    gbps = nbytes / served_s / 1e9

    words, sizes, truth = CS.page_batch(data, blob, PAGES)
    mc = max_cmds_for(PAGE_SIZE)
    out = decode_pages(words, sizes, PAGE_SIZE, mc)[0]
    check((np.asarray(out) == truth).all(), "batch decode != input")
    batch_s = _best(lambda: decode_pages(words, sizes, PAGE_SIZE, mc)[0],
                    REPS)

    check(native.decode(blob, num_threads=1) == data,
          "native decode != input")
    cpu_1t = nbytes / _wall(lambda: native.decode(blob, num_threads=1),
                            3) / 1e9
    cpu_mt = nbytes / _wall(lambda: native.decode(blob), 3) / 1e9

    texture = _texture(SEED, REPS)
    archives = _archives(SEED, REPS)
    enc = {}
    sub = data[: 32 * PAGE_SIZE]
    for backend in ("device", "device-full"):
        b = brotlig_tpu.encode(sub, page_size=PAGE_SIZE, backend=backend)
        check(native.decode(b) == sub, f"{backend} encode != input")
        enc[f"encode_ratio_{backend}"] = len(sub) / len(b)

    dev = jax.devices()[0]
    print(json.dumps({
        "metric": "decode_throughput", "value": gbps, "unit": "GB/s",
        "route": resolve_route(), "pages": PAGES, "decode_s": served_s,
        "vs_baseline": gbps / cpu_1t,
        "device_batch_gbps": nbytes / batch_s / 1e9, "batch_s": batch_s,
        "input_sha256": CS.sha(data),
        "native_cpu_gbps_1t": cpu_1t, "native_cpu_gbps_mt": cpu_mt,
        "native_threads": os.cpu_count(),
        "ratio_q11": len(data) / len(blob),
        **texture, **archives, **enc,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "card": CS.card_line(),
    }))


def _texture(seed, reps):
    """BASELINE config 3: BC1 4096x8192, precondition + swizzle + delta,
    decoded with the deconditioning left on the device."""
    import brotlig_tpu
    from brotlig_tpu.format import constants as FC
    from brotlig_tpu.format.precondition import DataConditionParams
    from brotlig_tpu.ops.decode import decode_stream_jax
    w, h = 4096, 8192
    tex = CS.make_bc1(w, h, seed)
    params = DataConditionParams(
        precondition=True, swizzle=True, delta_encode=True,
        format=FC.DATA_FORMAT_BC1, width_in_pixels=w, height_in_pixels=h,
        num_mip_levels=1)
    blob = brotlig_tpu.encode(tex, page_size=PAGE_SIZE, dc_params=params,
                              backend="device")
    check(brotlig_tpu.decode(blob) == tex, "texture decode != input")
    dt = _best(lambda: decode_stream_jax(blob, return_device=True), reps)
    return {"precond_gbps": len(tex) / dt / 1e9,
            "precond_ratio": len(tex) / len(blob)}


def _archives(seed, reps):
    """BASELINE config 2's shape: 16 x 1 MiB archives, pooled batches."""
    from brotlig_tpu import native
    from brotlig_tpu.parallel.runtime import decode_archives_batched
    size = 1 << 20
    corpus = CS.make_corpus(16 * size // PAGE_SIZE, seed + 1)
    datas = [corpus[i * size: (i + 1) * size] for i in range(16)]
    blobs = [native.encode(d, page_size=PAGE_SIZE) for d in datas]
    check(decode_archives_batched(blobs) == datas, "archives != input")
    dt = _wall(lambda: decode_archives_batched(blobs), reps)
    return {"archives_gbps": 16 * size / dt / 1e9,
            "archives_ratio": 16 * size / sum(map(len, blobs))}


if __name__ == "__main__":
    main()
