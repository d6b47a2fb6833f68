"""Bit-exactness against the ACTUAL reference decoder.

tools/reference_oracle compiles the reference SDK's CPU decoder sources
(read directly from /root/reference) with stub brotli headers; every stream
our encoders produce must decode byte-identically through it. This is the
format contract BASELINE.json demands, checked against the reference's own
code rather than our oracle.
"""
import os
import subprocess

import numpy as np
import pytest

from brotlig_tpu import native
from brotlig_tpu.format import constants as C
from brotlig_tpu.format.precondition import DataConditionParams
from brotlig_tpu.refimpl.codec import encode as py_encode

from test_roundtrip import make_data

ORACLE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools", "reference_oracle")
ORACLE = os.path.join(ORACLE_DIR, "reference_oracle")


def _ensure_oracle():
    if os.path.exists(ORACLE):
        return True
    if not os.path.exists("/root/reference"):
        return False
    try:
        subprocess.run([os.path.join(ORACLE_DIR, "build.sh")], check=True,
                       capture_output=True, timeout=300)
        return os.path.exists(ORACLE)
    except Exception:
        return False


pytestmark = pytest.mark.skipif(not _ensure_oracle(),
                                reason="reference oracle unavailable")


def ref_decode(blob: bytes, tmp_path) -> bytes:
    src = tmp_path / "in.brotlig"
    dst = tmp_path / "out.bin"
    src.write_bytes(blob)
    subprocess.run([ORACLE, str(src), str(dst)], check=True,
                   capture_output=True, timeout=120)
    return dst.read_bytes()


class TestReferenceDecodesOurStreams:
    @pytest.mark.parametrize("kind,n", [
        ("text", 200_000), ("repetitive", 150_000), ("zeros", 131072),
        ("structured", 120_000), ("random", 80_000), ("text", 1),
        ("text", 65536),
    ])
    def test_native_encoders(self, kind, n, tmp_path):
        data = make_data(kind, n, seed=n + 17)
        for q in (11, 1):
            blob = native.encode(data, quality=q)
            assert ref_decode(blob, tmp_path) == data, f"q{q}"

    def test_python_encoder(self, tmp_path):
        data = make_data("text", 120_000, seed=3)
        assert ref_decode(py_encode(data), tmp_path) == data

    def test_tpu_encoder(self, tmp_path):
        from brotlig_tpu.ops.encode import encode_stream_device
        data = make_data("structured", 100_000, seed=4)
        assert ref_decode(encode_stream_device(data), tmp_path) == data

    @pytest.mark.parametrize("kind,n", [
        ("text", 150_000),        # complex tables, run-coded storage
        ("repetitive", 80_000),   # simple/trivial tables
        ("zeros", 131072),        # trivial literal table (0-bit symbols)
    ])
    def test_tpu_full_encoder(self, kind, n, tmp_path):
        from brotlig_tpu.ops.encode_pack import encode_stream_device_full
        data = make_data(kind, n, seed=n + 5)
        assert ref_decode(encode_stream_device_full(data), tmp_path) == data

    def test_preconditioned(self, tmp_path):
        rng = np.random.default_rng(0)
        size = 128 * 128 * 8
        tex = ((rng.integers(0, 8, size) + np.arange(size) // 64) % 256
               ).astype(np.uint8).tobytes()
        p = DataConditionParams(
            precondition=True, swizzle=True, delta_encode=True,
            format=C.DATA_FORMAT_BC1, width_in_pixels=512,
            height_in_pixels=512)
        blob = py_encode(tex, page_size=C.MIN_PAGE_SIZE, dc_params=p)
        assert ref_decode(blob, tmp_path) == tex

    def test_page_size_variants(self, tmp_path):
        data = make_data("text", 300_000, seed=5)
        for ps in C.PAGE_SIZE_CHOICES:
            blob = native.encode(data, page_size=ps)
            assert ref_decode(blob, tmp_path) == data, ps
