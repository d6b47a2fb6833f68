"""Bring-up smoke run of the Brotli-G decode path on a GPU.

    python chip_smoke.py [--seed N] [--pages N] [--only PHASES] [--four-cards]

Drives the main path once at full size in one process and prints one line
per phase; any failure ends the run with a non-zero exit and no result.

  device    the default JAX device is a GPU; the card's name, power limit
  bundle    a seeded mixed corpus (4096 x 64 KiB pages = 256 MiB) of
            generated pages and slices of pinned committed files (see
            SOURCE_FILES), native encode, brotlig_tpu.decode == input ==
            native decoder, end-to-end GB/s
  kernel    one 256-page batch: Triton phase A vs XLA phase A (six arrays,
            rows up to ncmds), decoded pages byte-equal, both routes timed
            end to end through decode_pages, and the stage split; then the
            batch with every odd page corrupted through the compiled
            kernel: no fault, and the even pages still byte-equal
  texture   a 4096x8192 BC1 texture, precondition + swizzle + delta,
            device-encoded, decode == input
  archives  decode_archives_batched over 16 x 1 MiB archives
  encoder   the device encoders on 32 pages, native decode == input, ratio

--four-cards runs only the sharded path: decode_stream_sharded over a
four-GPU 'pages' mesh against the one-card decode of the same bundle.
--only and --pages exist only to split the work into short calls (a first
check after a kernel change: --only kernel --pages 512); the default runs
every phase at full size.

Every phase line carries `input_sha256`, the first 16 hex digits of the
sha256 of the bytes it decoded or encoded: two runs compare only where
these agree.

The last line of stdout is {"ok": true, "device": {...}} with the device
as JAX reports it.
"""
import argparse
import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
PAGE_SIZE = 64 * 1024
BUNDLE_QUALITY = 5      # native greedy-lazy tier: q11 encodes ~1 MB/s
ARCHIVE_QUALITY = 11
PHASES = ("bundle", "kernel", "texture", "archives", "encoder")

_WORDS = (b"the of and to in is that for it as with was on be by this "
          b"page stream decode huffman literal copy distance window lane "
          b"block texture compress buffer offset length symbol table "
          b"header bitstream device kernel batch round command").split()


_STUBS = "tools/reference_oracle/stubs/"
# Committed files that the project keeps unedited (the reference analysis,
# the original brief, third-party snippets and header stubs), so that the
# corpus is the same bytes in every checkout. SOURCE_SHA256 pins them.
SOURCE_FILES = (
    "SURVEY.md", "PAPER.md", "SNIPPETS.md", "BASELINE.json",
    _STUBS + "Windows.h", _STUBS + "d3d12.h",
    *(_STUBS + "brotli/c/" + f for f in (
        "common/constants.h", "common/context.h", "common/platform.h",
        "dec/bit_reader.h", "dec/huffman.h", "enc/bit_cost.h",
        "enc/command.h", "enc/entropy_encode.h", "enc/fast_log.h",
        "enc/quality.h", "include/brotli/types.h")),
)
SOURCE_SHA256 = (
    "49afcbb12b6c6c913e0272b63e0e626d0b345c8e120554aa9b5614f1a32c75c1")


def sha(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()[:16]


def _sources() -> bytes:
    """SOURCE_FILES concatenated; fails if they are not the pinned bytes
    (numbers from another corpus do not compare)."""
    src = b"".join(open(os.path.join(ROOT, f), "rb").read()
                   for f in SOURCE_FILES)
    check(hashlib.sha256(src).hexdigest() == SOURCE_SHA256,
          "corpus source files differ from SOURCE_SHA256")
    return src


def make_corpus(n_pages: int, seed: int) -> bytes:
    """n_pages x 64 KiB of mixed content from `seed`: prose-like text,
    fixed-width structured records, repetitive patterns with sparse
    mutations, and slices of SOURCE_FILES."""
    rng = np.random.default_rng(seed)
    src = np.frombuffer(_sources(), np.uint8)
    reps = -(-(PAGE_SIZE * 2) // len(src))
    src = np.tile(src, reps)
    vocab = [w + b" " for w in _WORDS]
    ranks = 1.0 / np.arange(1, len(vocab) + 1)
    ranks /= ranks.sum()
    out = np.empty((n_pages, PAGE_SIZE), np.uint8)
    for i in range(n_pages):
        kind = int(rng.integers(0, 4))
        if kind == 0:
            idx = rng.choice(len(vocab), PAGE_SIZE // 3, p=ranks)
            txt = b"".join(vocab[j] for j in idx)
            out[i] = np.frombuffer(txt[:PAGE_SIZE], np.uint8)
        elif kind == 1:
            rec = np.zeros((PAGE_SIZE // 16, 16), np.uint8)
            ids = np.arange(len(rec), dtype=np.uint32) + int(
                rng.integers(0, 1 << 20))
            rec[:, :4] = ids.view(np.uint8).reshape(-1, 4)
            rec[:, 4:8] = rng.integers(0, 4, (len(rec), 4))
            rec[:, 8:16] = rng.integers(0, 256, (1, 8))
            out[i] = rec.reshape(-1)
        elif kind == 2:
            pat = rng.integers(0, 256, int(rng.integers(16, 512)), np.uint8)
            page = np.resize(pat, PAGE_SIZE)
            hits = rng.integers(0, PAGE_SIZE, PAGE_SIZE // 256)
            page[hits] = rng.integers(0, 256, len(hits))
            out[i] = page
        else:
            off = int(rng.integers(0, len(src) - PAGE_SIZE))
            out[i] = src[off: off + PAGE_SIZE]
    return out.tobytes()


def make_bc1(w: int, h: int, seed: int) -> bytes:
    """A BC1 texture: correlated endpoint colors, low-entropy indices."""
    r = np.random.default_rng(seed)
    n = (w // 4) * (h // 4)
    c0 = (r.integers(0, 64, n) * 1024 + np.arange(n) % 1024).astype("<u2")
    c1 = (c0.astype(np.uint32) * 3 // 4).astype("<u2")
    blocks = np.zeros((n, 8), np.uint8)
    blocks[:, 0:2] = c0.view(np.uint8).reshape(-1, 2)
    blocks[:, 2:4] = c1.view(np.uint8).reshape(-1, 2)
    blocks[:, 4:8] = r.integers(0, 4, (n, 4)).astype(np.uint8) * 0x55
    return blocks.tobytes()


def check(ok, what) -> None:
    """Fail the run (asserts vanish under python -O)."""
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True, timeout=60)
    return "; ".join(x.strip() for x in r.stdout.splitlines() if x.strip())


class Smoke:
    def __init__(self, jax, card: str):
        self.jax = jax
        self.card = card

    def say(self, phase: str, **fields):
        print(f"[{phase}] {json.dumps(fields)} card: {self.card}",
              flush=True)

    def timed(self, fn, reps: int):
        """Seconds per rep; each rep ends when its result is ready."""
        ts = []
        out = None
        for _ in range(reps):
            t0 = time.perf_counter()
            out = self.jax.block_until_ready(fn())
            ts.append(time.perf_counter() - t0)
        return out, ts


def require_gpu():
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"chip_smoke: needs a GPU, JAX found {dev.platform!r}")
    return jax


def phase_bundle(s, data, blob):
    import brotlig_tpu
    from brotlig_tpu.ops.decode import resolve_route
    got = brotlig_tpu.decode(blob)          # compiles every batch shape
    check(got == data, "bundle decode != input")
    _, ts = s.timed(lambda: brotlig_tpu.decode(blob), 2)
    ref, tn = s.timed(lambda: brotlig_tpu.decode_cpu(blob), 1)
    check(ref == got, "bundle decode != native decoder")
    s.say("bundle", input_sha256=sha(data), route=resolve_route(),
          pages=len(data) // PAGE_SIZE,
          bytes=len(data), quality=BUNDLE_QUALITY,
          ratio=len(data) / len(blob), decode_s=ts,
          decode_gbps=len(data) / min(ts) / 1e9,
          native_cpu_gbps=len(data) / tn[0] / 1e9,
          native_threads=os.cpu_count())


def page_batch(data, blob, n):
    from brotlig_tpu.format.headers import parse_container
    from brotlig_tpu.ops.decode import _batch_pages
    info = parse_container(blob)
    idx = info.compressed_page_indices()[:n]
    check(len(idx) == n, "bundle has too few compressed pages")
    words, sizes = _batch_pages(blob, info.offsets, info.sizes, idx,
                                PAGE_SIZE // 4 + 8)
    truth = np.frombuffer(data, np.uint8).reshape(-1, PAGE_SIZE)[idx]
    return words, sizes, truth


def corrupt_rows(words, sizes, rows, seed):
    """A host copy of the batch with `rows` damaged: eight flipped bytes
    and a 16-byte noise burst inside each row's compressed bytes."""
    rng = np.random.default_rng(seed)
    b = np.array(words).view(np.uint8)
    sz = np.asarray(sizes)
    for r in rows:
        n = int(sz[r])
        b[r, rng.integers(0, n, 8)] ^= rng.integers(1, 256, 8, np.uint8)
        i = int(rng.integers(0, n - 16))
        b[r, i: i + 16] = rng.integers(0, 256, 16, np.uint8)
    return b.view(np.uint32)


def phase_kernel(s, data, blob, seed, n=256, reps=5):
    import jax
    from brotlig_tpu.ops.decode import (_stage_symbols, decode_pages,
                                        decode_pages_finish, max_cmds_for,
                                        symbol_inputs)
    words, sizes, truth = page_batch(data, blob, n)
    mc = max_cmds_for(PAGE_SIZE)
    sym = {r: _stage_symbols(words, sizes, PAGE_SIZE, mc, r)
           for r in ("xla", "triton")}
    x, t = [[np.asarray(a) for a in sym[r][:6]] for r in ("xla", "triton")]
    check((x[0] == t[0]).all(), "ncmds differ")
    for p, k in enumerate(x[0]):
        for i in range(2, 6):
            check((x[i][p, :k] == t[i][p, :k]).all(),
                  f"command array {i} differs on page {p}")
        nlit = int(x[2][p, :k].sum())
        check((x[1][p, :nlit] == t[1][p, :nlit]).all(),
              f"literals differ on page {p}")
    res = {}
    for r in ("xla", "triton"):
        out, ts = s.timed(lambda r=r: decode_pages(
            words, sizes, PAGE_SIZE, mc, route=r)[0], reps + 1)
        check((np.asarray(out) == truth).all(), f"{r} pages != input")
        res[r] = ts[1:]
    tables = jax.jit(symbol_inputs)
    _, t_tab = s.timed(lambda: tables(words, sizes), reps + 1)
    split = {"tables_s": min(t_tab[1:])}
    for r in ("xla", "triton"):
        _, ts = s.timed(lambda r=r: _stage_symbols(
            words, sizes, PAGE_SIZE, mc, r), reps + 1)
        split[f"symbols_{r}_s"] = min(ts[1:])
    _, ts = s.timed(lambda: decode_pages_finish(
        sym["triton"], PAGE_SIZE, mc)[0], reps + 1)
    split["lz_s"] = min(ts[1:])
    # memory safety on hostile input: corrupt pages decode to garbage, but
    # nothing faults and no neighbour row is touched
    bad = jax.numpy.asarray(corrupt_rows(words, sizes, range(1, n, 2), seed))
    out = np.asarray(jax.block_until_ready(decode_pages(
        bad, sizes, PAGE_SIZE, mc, route="triton")[0]))
    check(out.shape == truth.shape, "corrupt batch output shape")
    check((out[0::2] == truth[0::2]).all(),
          "a corrupt page disturbed a valid neighbour")
    nbytes = n * PAGE_SIZE
    s.say("kernel", input_sha256=sha(data), pages=n, arrays_equal=True,
          pages_equal=True, corrupt_pages=n // 2, neighbours_equal=True,
          xla_s=res["xla"], triton_s=res["triton"],
          xla_gbps=nbytes / min(res["xla"]) / 1e9,
          triton_gbps=nbytes / min(res["triton"]) / 1e9,
          triton_speedup=min(res["xla"]) / min(res["triton"]), **split)


def phase_texture(s, seed, w=4096, h=8192):
    import brotlig_tpu
    from brotlig_tpu.format import constants as FC
    from brotlig_tpu.format.precondition import DataConditionParams
    from brotlig_tpu.ops.decode import decode_stream_jax
    tex = make_bc1(w, h, seed)
    params = DataConditionParams(
        precondition=True, swizzle=True, delta_encode=True,
        format=FC.DATA_FORMAT_BC1, width_in_pixels=w, height_in_pixels=h,
        num_mip_levels=1)
    t0 = time.perf_counter()
    blob = brotlig_tpu.encode(tex, page_size=PAGE_SIZE, dc_params=params,
                              backend="device")
    enc_s = time.perf_counter() - t0
    check(brotlig_tpu.decode(blob) == tex, "texture decode != input")
    _, ts = s.timed(lambda: decode_stream_jax(blob, return_device=True), 3)
    s.say("texture", input_sha256=sha(tex), width=w, height=h,
          bytes=len(tex), ratio=len(tex) / len(blob), encode_s=enc_s,
          decode_s=ts, decode_gbps=len(tex) / min(ts) / 1e9)


def phase_archives(s, seed, n=16, size=1 << 20):
    from brotlig_tpu import native
    from brotlig_tpu.parallel.runtime import decode_archives_batched
    corpus = make_corpus(n * size // PAGE_SIZE, seed + 1)
    datas = [corpus[i * size: (i + 1) * size] for i in range(n)]
    blobs = [native.encode(d, page_size=PAGE_SIZE, quality=ARCHIVE_QUALITY)
             for d in datas]
    outs = decode_archives_batched(blobs)
    check(outs == datas, "pooled archive decode != input")
    _, ts = s.timed(lambda: decode_archives_batched(blobs), 2)
    s.say("archives", input_sha256=sha(b"".join(datas)), archives=n,
          bytes=n * size, quality=ARCHIVE_QUALITY,
          ratio=n * size / sum(map(len, blobs)), decode_s=ts,
          decode_gbps=n * size / min(ts) / 1e9)


def phase_encoder(s, data, n=32):
    import brotlig_tpu
    from brotlig_tpu import native
    pages = data[: n * PAGE_SIZE]
    res = {}
    for backend in ("device", "device-full"):
        t0 = time.perf_counter()
        blob = brotlig_tpu.encode(pages, page_size=PAGE_SIZE,
                                  backend=backend)
        res[f"{backend}_s"] = time.perf_counter() - t0
        check(native.decode(blob) == pages,
              f"{backend} encode != input")
        res[f"{backend}_ratio"] = len(pages) / len(blob)
    s.say("encoder", input_sha256=sha(pages), pages=n, **res)


def phase_four_cards(s, data, blob):
    import brotlig_tpu
    from brotlig_tpu.parallel.sharding import (decode_stream_sharded,
                                               make_mesh)
    devs = s.jax.devices()
    check(len(devs) >= 4,
          f"--four-cards needs 4 GPUs, found {len(devs)}")
    one = brotlig_tpu.decode(blob)
    check(one == data, "one-card decode != input")
    mesh = make_mesh(devs[:4])
    four = decode_stream_sharded(blob, mesh)
    check(four == one, "four-card decode != one-card decode")
    _, t1 = s.timed(lambda: brotlig_tpu.decode(blob), 1)
    _, t4 = s.timed(lambda: decode_stream_sharded(blob, mesh), 2)
    s.say("four_cards", input_sha256=sha(data), devices=4,
          bytes=len(data), byte_equal=True, one_card_s=t1, four_card_s=t4,
          one_card_gbps=len(data) / t1[0] / 1e9,
          four_card_gbps=len(data) / min(t4) / 1e9)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--pages", type=int, default=4096,
                    help="bundle size in 64 KiB pages")
    ap.add_argument("--only", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    ap.add_argument("--four-cards", action="store_true")
    args = ap.parse_args(argv)
    only = args.only.split(",")
    check(set(only) <= set(PHASES), f"unknown phase in {only}")

    jax = require_gpu()
    sys.path.insert(0, ROOT)
    from brotlig_tpu import native
    from brotlig_tpu.utils import jaxcache
    jaxcache.enable()
    dev = jax.devices()[0]
    s = Smoke(jax, card_line())
    print(f"card: {s.card}", flush=True)
    s.say("device", platform=dev.platform, kind=dev.device_kind,
          count=len(jax.devices()))

    t0 = time.perf_counter()
    data = make_corpus(args.pages, args.seed)
    t1 = time.perf_counter()
    blob = native.encode(data, page_size=PAGE_SIZE, quality=BUNDLE_QUALITY)
    s.say("corpus", input_sha256=sha(data), source_sha256=SOURCE_SHA256,
          pages=args.pages, seed=args.seed, build_s=t1 - t0,
          encode_s=time.perf_counter() - t1, quality=BUNDLE_QUALITY)

    if args.four_cards:
        phase_four_cards(s, data, blob)
    else:
        if "bundle" in only:
            phase_bundle(s, data, blob)
        if "kernel" in only:
            phase_kernel(s, data, blob, args.seed)
        if "texture" in only:
            phase_texture(s, args.seed)
        if "archives" in only:
            phase_archives(s, args.seed)
        if "encoder" in only:
            phase_encoder(s, data)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
