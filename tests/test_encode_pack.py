"""Fully-device page serialization vs every decoder."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")

from brotlig_tpu import native
from brotlig_tpu.ops.encode_pack import (encode_pages_device,
                                         encode_stream_device_full)
from brotlig_tpu.refimpl.codec import decode as py_decode
from brotlig_tpu.refimpl.page_decoder import decode_page

from test_roundtrip import make_data


class TestDevicePack:
    @pytest.mark.parametrize("kind", ["text", "zeros", "repetitive",
                                      "structured", "random"])
    def test_page_kinds(self, kind):
        S = 32768
        d = make_data(kind, S, seed=hash(kind) % 97)
        arr = np.frombuffer(d, np.uint8)[None, :].copy()
        blobs = encode_pages_device(arr, np.array([S], np.int32), S)
        b = blobs[0]
        if len(b) == len(d):
            return  # raw: trivially correct
        out, _ = decode_page(b, S)
        assert out == d
        assert native.decode_page(b, S) == d

    def test_partial_and_tiny_pages(self):
        S = 32768
        cases = [make_data("text", 20000, seed=1), b"xyz" * 40, b"Q"]
        arr = np.zeros((len(cases), S), np.uint8)
        sizes = np.zeros(len(cases), np.int32)
        for i, d in enumerate(cases):
            arr[i, : len(d)] = np.frombuffer(d, np.uint8)
            sizes[i] = len(d)
        blobs = encode_pages_device(arr, sizes, S)
        for d, b in zip(cases, blobs):
            if len(b) != len(d):
                out, _ = decode_page(b, len(d))
                assert out == d

    def test_stream_roundtrip_all_decoders(self):
        data = make_data("text", 150_000, seed=5)
        blob = encode_stream_device_full(data, page_size=32768)
        assert py_decode(blob) == data
        assert native.decode(blob) == data
        from brotlig_tpu.ops.decode import decode_stream_jax
        assert decode_stream_jax(blob) == data

    def test_reference_oracle_decodes_device_packed(self, tmp_path):
        from test_reference_oracle import _ensure_oracle, ref_decode
        if not _ensure_oracle():
            pytest.skip("no reference oracle")
        data = make_data("text", 100_000, seed=6)
        blob = encode_stream_device_full(data, page_size=32768)
        assert ref_decode(blob, tmp_path) == data
