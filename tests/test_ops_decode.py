"""Batched device-path decoder vs the scalar oracle and original data."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from brotlig_tpu.format import constants as C
from brotlig_tpu.ops.decode import (decode_pages, decode_stream_jax,
                                    max_cmds_for)
from brotlig_tpu.refimpl.codec import encode
from brotlig_tpu.refimpl.page_encoder import encode_page

from test_roundtrip import make_data


def batch(comp_pages, page_size):
    W = page_size // 4 + 2
    P = len(comp_pages)
    arr = np.zeros((P, W * 4), dtype=np.uint8)
    sizes = np.zeros(P, dtype=np.int32)
    for i, c in enumerate(comp_pages):
        arr[i, : len(c)] = np.frombuffer(c, dtype=np.uint8)
        sizes[i] = len(c)
    return jnp.asarray(arr.view(np.uint32).reshape(P, W)), jnp.asarray(sizes)


class TestDecodePages:
    @pytest.mark.parametrize("kind", ["text", "zeros", "repetitive",
                                      "structured"])
    def test_single_page_kinds(self, kind):
        n = 32768
        data = make_data(kind, n, seed=7)
        comp = encode_page(data, is_last=True)
        if comp is None:
            pytest.skip("stored raw")
        words, sizes = batch([comp], n)
        out, isdelta = decode_pages(words, sizes, n, max_cmds_for(n))
        got = np.asarray(out)[0, :n].tobytes()
        assert got == data, f"{kind}: device-path decode mismatch"

    def test_mixed_batch(self):
        n = 32768
        kinds = ["text", "zeros", "repetitive", "structured", "text"]
        datas = [make_data(k, n, seed=i) for i, k in enumerate(kinds)]
        comps = [encode_page(d, is_last=True) for d in datas]
        keep = [(c, d) for c, d in zip(comps, datas) if c is not None]
        words, sizes = batch([c for c, _ in keep], n)
        out, _ = decode_pages(words, sizes, n, max_cmds_for(n))
        for i, (_, d) in enumerate(keep):
            assert np.asarray(out)[i, :n].tobytes() == d, f"page {i}"

    def test_partial_last_page(self):
        n = 20000  # not a power of two, not full page
        data = make_data("text", n, seed=3)
        comp = encode_page(data, is_last=True)
        words, sizes = batch([comp], 32768)
        out, _ = decode_pages(words, sizes, 32768, max_cmds_for(32768))
        assert np.asarray(out)[0, :n].tobytes() == data

    def test_small_page_few_commands(self):
        # fewer than 32 commands: single-round page with early sentinel
        data = (b"abcdefgh" * 20) + b"tail-literals-xyz"
        comp = encode_page(data, is_last=True)
        if comp is None:
            pytest.skip("raw")
        words, sizes = batch([comp], 32768)
        out, _ = decode_pages(words, sizes, 32768, max_cmds_for(32768))
        assert np.asarray(out)[0, : len(data)].tobytes() == data


class TestStreamJax:
    @pytest.mark.parametrize("kind,n", [
        ("text", 1000), ("text", 65537), ("repetitive", 200_000),
        ("random", 80_000), ("zeros", 131072), ("structured", 100_000),
    ])
    def test_roundtrip(self, kind, n):
        data = make_data(kind, n, seed=n)
        blob = encode(data)
        assert decode_stream_jax(blob) == data

    def test_128k_pages(self):
        # the max page size (BrotligConstants.h:85) through the device route
        data = make_data("text", 200_000, seed=77)
        blob = encode(data, page_size=131072)
        assert decode_stream_jax(blob) == data

    def test_mixed_raw_and_compressed(self):
        # interleave compressible and incompressible pages
        rng = np.random.default_rng(0)
        parts = []
        for i in range(4):
            parts.append(make_data("text", 65536, seed=i))
            parts.append(rng.integers(0, 256, 65536,
                                      dtype=np.uint8).tobytes())
        data = b"".join(parts)
        blob = encode(data)
        assert decode_stream_jax(blob) == data

    def test_preconditioned_stream(self):
        from brotlig_tpu.format.precondition import DataConditionParams
        rng = np.random.default_rng(1)
        size = 128 * 128 * 8  # 512x512 BC1
        base = (rng.integers(0, 8, size=size)
                + (np.arange(size) // 64) % 32) % 256
        tex = base.astype(np.uint8).tobytes()
        p = DataConditionParams(
            precondition=True, swizzle=True, delta_encode=True,
            format=C.DATA_FORMAT_BC1, width_in_pixels=512,
            height_in_pixels=512, num_mip_levels=1)
        blob = encode(tex, page_size=C.MIN_PAGE_SIZE, dc_params=p)
        assert decode_stream_jax(blob) == tex

    def test_api_auto_backend(self):
        import brotlig_tpu
        data = make_data("text", 50_000, seed=9)
        blob = brotlig_tpu.encode(data)
        assert brotlig_tpu.decode(blob) == data

    def test_decode_feedback_progress_and_abort(self):
        """Decode-side feedback proc (BrotligDecoder.cpp:318-325 analog):
        monotone progress per device batch; returning True aborts."""
        from brotlig_tpu.format.errors import Aborted
        data = make_data("text", 65536 * 3, seed=11)
        blob = encode(data)
        seen = []
        assert decode_stream_jax(
            blob, batch_pages=1,
            feedback=lambda p: (seen.append(p), False)[1]) == data
        assert seen and seen == sorted(seen) and seen[-1] == 100.0
        with pytest.raises(Aborted):
            decode_stream_jax(blob, batch_pages=1, feedback=lambda p: True)


class TestDevicePrecondition:
    @pytest.mark.parametrize("swizzle,delta", [(False, False), (True, True),
                                               (False, True)])
    def test_matches_oracle(self, swizzle, delta):
        from brotlig_tpu.format.precondition import DataConditionParams
        from brotlig_tpu.refimpl.codec import decode as py_decode
        rng = np.random.default_rng(4)
        size = 128 * 128 * 8  # 512x512 BC1
        base = (rng.integers(0, 8, size=size)
                + (np.arange(size) // 64) % 32) % 256
        tex = base.astype(np.uint8).tobytes()
        p = DataConditionParams(
            precondition=True, swizzle=swizzle, delta_encode=delta,
            format=C.DATA_FORMAT_BC1, width_in_pixels=512,
            height_in_pixels=512, num_mip_levels=1)
        blob = encode(tex, page_size=C.MIN_PAGE_SIZE, dc_params=p)
        got = decode_stream_jax(blob)
        assert got == py_decode(blob)
        assert got == tex

    def test_mips_and_pitch(self):
        from brotlig_tpu.format.precondition import DataConditionParams
        rng = np.random.default_rng(5)
        # BC3 64x64 with 2 mips
        size = 16 * (256 + 64)
        tex = (rng.integers(0, 16, size) + np.arange(size) // 32
               ).astype(np.uint8).tobytes()
        p = DataConditionParams(
            precondition=True, swizzle=True, delta_encode=True,
            format=C.DATA_FORMAT_BC3, width_in_pixels=64,
            height_in_pixels=64, num_mip_levels=2)
        blob = encode(tex, page_size=C.MIN_PAGE_SIZE, dc_params=p)
        assert decode_stream_jax(blob) == tex


def test_plane_scatter_updates_rows_in_place():
    """The stream loop's resident-plane drain must be a donated scatter
    (an undonated .at[].set would copy the whole [num_pages, page_size]
    plane every batch). XLA:CPU ignores donation, so this checks the
    result only."""
    import jax
    from brotlig_tpu.ops.decode import _plane_scatter
    plane = jnp.zeros((8, 256), jnp.uint8)
    rows = jnp.asarray([1, 3], jnp.int32)
    pages = jnp.full((2, 256), 7, jnp.uint8)
    out = np.asarray(_plane_scatter(plane, rows, pages))
    expect = np.zeros((8, 256), np.uint8)
    expect[[1, 3]] = 7
    assert np.array_equal(out, expect)
