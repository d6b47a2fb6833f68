"""Distributed decode runtime: pages sharded data-parallel over a device mesh.

The Brotli-G format guarantees zero cross-page dependence (SURVEY.md §2.12),
so the parallel decomposition is pure DP over a 'pages' mesh axis: inputs
(padded compressed pages + sizes) are sharded on their leading axis, every
shard runs the whole decode pipeline on its own pages under shard_map with
no collectives, and the ordered gather of decompressed pages is the output
sharding hand-off. This replaces the reference's atomic work-queue
scheduling (BrotligEncoder.cpp:389, BrotliGCompute.hlsl:1810-1821) with a
static interleaved assignment — deterministic schedules beat work stealing
under SPMD because page cost variance is bounded by the 2x compressed-size
bound. The mesh is flat: every device reaches every other at one rate.
"""
from __future__ import annotations

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.decode import (_stage_lz, _stage_symbols, max_cmds_for,
                          resolve_route)


def make_mesh(devices=None, axis: str = "pages") -> Mesh:
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (axis,))


def pad_batch(n: int, n_devices: int) -> int:
    """Pages per shard x devices >= n."""
    return (n + n_devices - 1) // n_devices * n_devices


@partial(jax.jit, static_argnums=(2, 3, 4))
def _decode_sharded(words, in_sizes, page_size: int, mesh: Mesh,
                    route: str):
    max_cmds = max_cmds_for(page_size)
    spec = P(mesh.axis_names[0])

    def step(w, s):
        sym = _stage_symbols.__wrapped__(w, s, page_size, max_cmds, route)
        out = _stage_lz.__wrapped__(*sym[:8], page_size, max_cmds)
        return out, sym[8]

    # check_vma off: the Triton kernel's outputs carry no varying-mesh-axes
    # annotation for the checker (each shard touches only its own pages)
    return jax.shard_map(step, mesh=mesh, in_specs=(spec, spec),
                         out_specs=(spec, spec), check_vma=False)(
        words, in_sizes)


def decode_pages_sharded(words, in_sizes, page_size: int, mesh: Mesh,
                         route: str | None = None):
    """Decode a batch of compressed pages sharded over the mesh's axis.

    words: uint32 [P, W] with P divisible by mesh size. route: the phase-A
    route (see ops.decode.resolve_route), the same on every shard.
    Returns (out [P, page_size] uint8, isdelta [P]) with the same sharding.
    """
    route = resolve_route(route)
    shard = NamedSharding(mesh, P(mesh.axis_names[0]))
    words = jax.device_put(words, shard)
    in_sizes = jax.device_put(in_sizes, shard)
    return _decode_sharded(words, in_sizes, page_size, mesh, route)


def decode_stream_sharded(data: bytes, mesh: Mesh | None = None,
                          batch_pages: int = 256) -> bytes:
    """Stream-level decode with pages sharded across the mesh.

    Single-host orchestration: the container is parsed on host, compressed
    pages are padded into [batch_pages x devices, W] batches (the last one
    padded to a mesh multiple with empty dummy pages), decoded SPMD on the
    platform's route, and gathered in stream order.
    """
    from ..format.headers import parse_container
    from ..format.precondition import delta_decode_page, decondition

    if mesh is None:
        mesh = make_mesh()
    info = parse_container(data)
    header, dc_params = info.header, info.dc_params
    if header.num_pages == 0:
        return b""
    page_size = header.page_size
    out_size = info.out_size
    offsets, sizes = info.offsets, info.sizes
    payload = data  # offsets are absolute
    page_out_sizes = info.page_out_sizes
    comp_idx = info.compressed_page_indices()

    out = bytearray(out_size)
    for i in info.raw_page_indices():
        off = int(offsets[i])
        out[i * page_size: i * page_size + page_out_sizes[i]] = \
            payload[off: off + page_out_sizes[i]]

    n_dev = len(mesh.devices.flat)
    step = batch_pages * n_dev
    W = page_size // 4 + 8
    # dummy rows: a minimal valid page (decodes fast, result dropped)
    dummy = _dummy_page(page_size)
    for c0 in range(0, len(comp_idx), step):
        group = comp_idx[c0: c0 + step]
        P_pad = pad_batch(len(group), n_dev)
        arr = np.zeros((P_pad, W * 4), dtype=np.uint8)
        in_sizes = np.zeros(P_pad, dtype=np.int32)
        for row in range(P_pad):
            if row < len(group):
                i = group[row]
                off, sz = int(offsets[i]), int(sizes[i])
                arr[row, :sz] = np.frombuffer(payload, np.uint8, sz, off)
                in_sizes[row] = sz
            else:
                arr[row, : len(dummy)] = np.frombuffer(dummy, np.uint8)
                in_sizes[row] = len(dummy)
        pages_out, isdelta = decode_pages_sharded(
            jnp.asarray(arr.view(np.uint32).reshape(P_pad, W)),
            jnp.asarray(in_sizes), page_size, mesh)
        pages_np = np.asarray(pages_out)
        isdelta_np = np.asarray(isdelta)
        for row, i in enumerate(group):
            chunk = pages_np[row, : page_out_sizes[i]].tobytes()
            if isdelta_np[row] and dc_params is not None:
                chunk = delta_decode_page(chunk, i * page_size, dc_params)
            out[i * page_size: i * page_size + page_out_sizes[i]] = chunk

    if dc_params is not None:
        return decondition(bytes(out), dc_params)
    return bytes(out[:out_size])


_dummy_cache: dict[int, bytes] = {}


def _dummy_page(page_size: int) -> bytes:
    """A tiny valid compressed page used to pad batches to mesh multiples."""
    from ..refimpl.page_encoder import encode_page
    if page_size not in _dummy_cache:
        blob = encode_page(bytes(page_size), is_last=True)
        assert blob is not None and len(blob) != page_size
        _dummy_cache[page_size] = blob
    return _dummy_cache[page_size]
