"""Multi-archive / multi-host decode orchestration.

BASELINE configs 4 and 5: a multi-GB bundle on one chip/host (chunked,
pipelined page batches — ops/decode.decode_stream_jax) and a many-archive
stream sharded across N>=2 hosts with ordered gather.

Multi-host model (jax.distributed): archives are statically interleaved
across processes (archive i -> process i % nprocs, the deterministic
schedule that replaces the reference's atomic work queue per SURVEY §5.8);
each process decodes its subset on its local devices; the ordered gather is
by construction — every output keeps its archive index. Cross-host traffic
is zero for the codec itself (pages are independent); only the optional
final concatenation across hosts uses `multihost_utils.process_allgather`.
On this single-host machine the same code path runs with nprocs=1; the
scaling test shards over the virtual CPU mesh instead.
"""
from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np

import jax

from ..ops.decode import decode_stream_jax


def process_info():
    try:
        return jax.process_index(), jax.process_count()
    except Exception:
        return 0, 1


def my_archive_indices(n_archives: int, process=None) -> list[int]:
    """Static interleaved assignment of archives to this process.

    `process=(pid, nprocs)` overrides auto-detection (jax.distributed is
    not available under every launcher; an MPI-style runner passes its own
    identity)."""
    pid, nproc = process if process is not None else process_info()
    return list(range(pid, n_archives, nproc))


def decode_archives(blobs: Sequence[bytes],
                    batch_pages: int = 256,
                    process=None) -> dict[int, bytes]:
    """Decode this process's share of `blobs`.

    Returns {archive_index: decompressed bytes} for locally-owned archives;
    with one process this is every archive, in order. For the full
    multi-host gather, callers either write per-archive outputs to shared
    storage keyed by index (the intended 100 GB flow — no inter-host
    traffic) or all-gather small results.
    """
    out: dict[int, bytes] = {}
    for i in my_archive_indices(len(blobs), process):
        out[i] = decode_stream_jax(blobs[i], batch_pages=batch_pages)
    return out


def decode_archives_gather(blobs: Sequence[bytes],
                           batch_pages: int = 256,
                           process=None) -> list[bytes]:
    """Decode the local share, then all-gather so EVERY process holds all
    outputs in archive order.

    The exchange is owned-bytes-only: each process concatenates just its
    OWN archives' outputs into one ragged buffer (padded to the largest
    per-process share), and ONE `multihost_utils.process_allgather` moves
    them. Every receiver gets each archive's bytes exactly once —
    O(total_bytes) per receiver, the information-theoretic floor for
    "every process holds every output" — instead of the round-2 full
    [n_archives, max_out] plane whose traffic was O(total * nprocs) with
    an OR-reduce over mostly-zero rows. Per-archive offsets within each
    owner's buffer are recomputed identically on every process from the
    stream headers (out sizes are header-derived, no size exchange
    needed). The multi-host analog of the reference's shared output
    buffer + work queue (BrotligDecoder.cpp:296-329). Requires
    jax.distributed (or nprocs == 1, where it degrades to a local
    decode). For the zero-traffic 100 GB flow see
    decode_archives_to_dir."""
    from ..format.headers import StreamHeader

    local = decode_archives(blobs, batch_pages, process)
    pid, nproc = process if process is not None else process_info()
    out_sizes = [StreamHeader.unpack(b).uncompressed_size for b in blobs]
    if nproc == 1:
        return [local[i] for i in range(len(blobs))]

    import jax.numpy as jnp
    from jax.experimental import multihost_utils

    n = len(blobs)
    # owner p's buffer layout: archives p, p+nproc, ... concatenated
    offsets = {}
    share = [0] * nproc
    for i in range(n):
        p = i % nproc
        offsets[i] = share[p]
        share[p] += out_sizes[i]
    pad = max(max(share), 1)
    buf = np.zeros(pad, np.uint8)
    for i, data in local.items():
        buf[offsets[i]: offsets[i] + len(data)] = \
            np.frombuffer(data, np.uint8)
    g = np.asarray(multihost_utils.process_allgather(jnp.asarray(buf)))
    return [g[i % nproc, offsets[i]: offsets[i] + out_sizes[i]].tobytes()
            for i in range(n)]


def decode_archives_to_dir(blobs: Sequence[bytes], out_dir,
                           batch_pages: int = 256,
                           process=None, name=None) -> list:
    """The shared-storage multi-host flow (BASELINE config 5's 100 GB
    shape): each process decodes its owned archives and writes them to
    `out_dir/<name(i)>` — zero inter-host traffic, each archive's bytes
    move host->storage exactly once. Returns the paths this process
    wrote. `name(i)` defaults to 'archive_%05d.bin'."""
    import os

    os.makedirs(out_dir, exist_ok=True)
    if name is None:
        name = lambda i: f"archive_{i:05d}.bin"  # noqa: E731
    paths = []
    for i in my_archive_indices(len(blobs), process):
        data = decode_stream_jax(blobs[i], batch_pages=batch_pages)
        path = os.path.join(out_dir, name(i))
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
        paths.append(path)
    return paths


def decode_archives_batched(blobs: Sequence[bytes],
                            batch_pages: int = 256) -> list[bytes]:
    """Decode MANY containers in shared device batches.

    The reference GPU decoder drains a meta buffer listing thousands of
    independent streams in one dispatch (BrotliGCompute.hlsl:1755-1882,
    SURVEY §2.12.4); here pages from all archives are pooled into the same
    fixed-size device batches regardless of archive boundaries, so small
    archives amortize like big ones. Outputs keep archive order. The
    platform picks the phase-A route (ops.decode.resolve_route).
    """
    from ..format.headers import parse_container
    from ..ops.decode import decode_pages, max_cmds_for
    from ..ops.precondition import postprocess_device
    import jax.numpy as jnp

    outs: list[bytearray] = []
    metas = []
    # job = (archive, page_index, payload_off, size, out_size)
    jobs_by_psize: dict[int, list] = {}
    for ai, blob in enumerate(blobs):
        info = parse_container(blob)
        header, dc = info.header, info.dc_params
        outs.append(bytearray(info.out_size))
        metas.append((header, dc, set()))
        ps = header.page_size
        for i in info.raw_page_indices():
            off, posz = int(info.offsets[i]), info.page_out_sizes[i]
            outs[ai][i * ps: i * ps + posz] = blob[off: off + posz]
        for i in info.compressed_page_indices():
            jobs_by_psize.setdefault(ps, []).append(
                (ai, i, int(info.offsets[i]), int(info.sizes[i]),
                 info.page_out_sizes[i]))

    for ps, jobs in jobs_by_psize.items():
        W = ps // 4 + 8
        mc = max_cmds_for(ps)
        # similar-size pages decode in lockstep (same rule as
        # decode_stream_jax)
        jobs.sort(key=lambda j: j[3])
        for c0 in range(0, len(jobs), batch_pages):
            group = jobs[c0: c0 + batch_pages]
            rows = group + [group[0]] * (batch_pages - len(group)) \
                if len(jobs) > batch_pages else group
            arr = np.zeros((len(rows), W * 4), dtype=np.uint8)
            in_sizes = np.zeros(len(rows), dtype=np.int32)
            for r, (ai, i, off, sz, posz) in enumerate(rows):
                arr[r, :sz] = np.frombuffer(blobs[ai], np.uint8, sz, off)
                in_sizes[r] = sz
            pages_out, isdelta = decode_pages(
                jnp.asarray(arr.view(np.uint32).reshape(len(rows), W)),
                jnp.asarray(in_sizes), ps, mc)
            pages_np = np.asarray(pages_out)
            isdelta_np = np.asarray(isdelta)
            for r, (ai, i, off, sz, posz) in enumerate(group):
                outs[ai][i * ps: i * ps + posz] = \
                    pages_np[r, :posz].tobytes()
                if isdelta_np[r]:
                    metas[ai][2].add(i)

    results = []
    for ai, (header, dc, delta_pages) in enumerate(metas):
        if dc is not None:
            results.append(postprocess_device(
                bytes(outs[ai]), dc, header.page_size, delta_pages))
        else:
            results.append(bytes(outs[ai]))
    return results


def encode_archives(datas: Sequence[bytes], page_size: int = 65536,
                    process=None, quality: int = 11) -> dict[int, bytes]:
    """Encode this process's share of inputs (native CPU encoder)."""
    from .. import api
    out: dict[int, bytes] = {}
    for i in my_archive_indices(len(datas), process):
        out[i] = api.encode(datas[i], page_size=page_size,
                            quality=quality)
    return out


def encode_archives_gather(datas: Sequence[bytes],
                           page_size: int = 65536,
                           process=None, quality: int = 11
                           ) -> list[bytes]:
    """Encode the local share, then all-gather so EVERY process holds all
    compressed archives in input order — the multi-host analog of the
    reference's container assembly (BrotligEncoder.cpp:469-516), and the
    encode mirror of decode_archives_gather's owned-bytes exchange.

    Unlike decode (where output sizes derive from headers every process
    already holds), compressed sizes are only known to the owner, so ONE
    small [n] size allgather precedes the owned-bytes payload exchange;
    the payload buffers stay O(total_bytes) per receiver — the
    information-theoretic floor — padded to the largest per-process
    share. Requires jax.distributed (nprocs == 1 degrades to a local
    encode)."""
    local = encode_archives(datas, page_size, process, quality)
    pid, nproc = process if process is not None else process_info()
    n = len(datas)
    if nproc == 1:
        return [local[i] for i in range(n)]

    import jax.numpy as jnp
    from jax.experimental import multihost_utils

    sz_local = np.zeros(n, np.int64)
    for i, b in local.items():
        sz_local[i] = len(b)
    sz_all = np.asarray(
        multihost_utils.process_allgather(jnp.asarray(sz_local)))
    sizes = [int(sz_all[i % nproc, i]) for i in range(n)]

    # owner p's buffer layout: archives p, p+nproc, ... concatenated
    offsets = {}
    share = [0] * nproc
    for i in range(n):
        p = i % nproc
        offsets[i] = share[p]
        share[p] += sizes[i]
    pad = max(max(share), 1)
    buf = np.zeros(pad, np.uint8)
    for i, b in local.items():
        buf[offsets[i]: offsets[i] + len(b)] = np.frombuffer(b, np.uint8)
    g = np.asarray(multihost_utils.process_allgather(jnp.asarray(buf)))
    return [g[i % nproc, offsets[i]: offsets[i] + sizes[i]].tobytes()
            for i in range(n)]
