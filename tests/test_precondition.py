"""BCn preconditioning tests: bijection, swizzle, delta, full roundtrip."""
import numpy as np
import pytest

from brotlig_tpu.format import constants as C
from brotlig_tpu.format.precondition import (DataConditionParams,
                                             build_cond_map, condition,
                                             decondition, delta_decode_page,
                                             delta_encode_page)
from brotlig_tpu.refimpl.codec import decode, encode


def make_params(fmt, w_px, h_px, mips=1, swizzle=False, delta=False,
                pitch_aligned=False):
    p = DataConditionParams(
        precondition=True, swizzle=swizzle, delta_encode=delta,
        format=fmt, width_in_pixels=w_px, height_in_pixels=h_px,
        num_mip_levels=mips, pitch_d3d12_aligned=pitch_aligned)
    return p


def texture_size(p: DataConditionParams) -> int:
    return p.mip_offsets_bytes[p.num_mip_levels]


class TestGeometry:
    def test_bc1_geometry(self):
        p = make_params(C.DATA_FORMAT_BC1, 64, 64)
        assert p.initialize(8 * 16 * 16)
        assert p.block_size_bytes == 8
        assert p.t_num_blocks == 256
        assert p.sub_stream_offsets == [0, 512, 1024, 2048]

    def test_bc3_mips(self):
        p = make_params(C.DATA_FORMAT_BC3, 64, 64, mips=3)
        size = 16 * (16 * 16 + 8 * 8 + 4 * 4)
        assert p.initialize(size)
        assert p.num_blocks[0] == 256
        assert p.num_blocks[1] == 64
        assert p.num_blocks[2] == 16
        assert p.t_num_blocks == 336

    def test_size_mismatch_rejected(self):
        p = make_params(C.DATA_FORMAT_BC1, 64, 64)
        assert not p.initialize(12345)


class TestCondMap:
    @pytest.mark.parametrize("fmt", [C.DATA_FORMAT_BC1, C.DATA_FORMAT_BC2,
                                     C.DATA_FORMAT_BC3, C.DATA_FORMAT_BC4,
                                     C.DATA_FORMAT_BC5])
    @pytest.mark.parametrize("swizzle", [False, True])
    def test_bijection(self, fmt, swizzle):
        p = make_params(fmt, 32, 16, swizzle=swizzle)
        bb = C.BCN_GEOMETRY[fmt]["block_bytes"]
        assert p.initialize(bb * 8 * 4)
        m = build_cond_map(p)
        assert len(m) == p.t_num_blocks * p.block_size_bytes
        assert len(np.unique(m)) == len(m), "map must be a bijection"

    def test_bijection_with_mips_and_pitch(self):
        p = make_params(C.DATA_FORMAT_BC1, 64, 32, mips=2,
                        pitch_aligned=True)
        size = 256 * 8 + 256 * 4  # pitch 256 per row, 8+4 rows
        assert p.initialize(size)
        m = build_cond_map(p)
        assert len(np.unique(m)) == len(m)
        assert m.max() < size

    def test_condition_matches_reference_walk(self):
        # independent scalar re-implementation of the reference's forward
        # walk (ConditionBC1_5) must agree with the closed-form map
        p = make_params(C.DATA_FORMAT_BC1, 16, 8)
        w, h = 4, 2
        size = 8 * w * h
        assert p.initialize(size)
        data = np.arange(size, dtype=np.uint8)
        got = np.frombuffer(condition(data.tobytes(), p), dtype=np.uint8)
        expect = np.zeros(size, dtype=np.uint8)
        ptrs = list(p.sub_stream_offsets[:-1])
        for row in range(h):
            for col in range(w):
                src = row * p.pitch_in_bytes[0] + col * 8
                for sub, ssz in enumerate(p.sub_block_sizes):
                    expect[ptrs[sub]: ptrs[sub] + ssz] = \
                        data[src: src + ssz]
                    src += ssz
                    ptrs[sub] += ssz
        np.testing.assert_array_equal(got, expect)

    def test_swizzle_matches_reference_walk(self):
        # 4x4 block texture with 2x2 tile swizzle, checked against a direct
        # simulation of the reference Swizzle() block permutation
        p = make_params(C.DATA_FORMAT_BC4, 16, 16, swizzle=True)
        size = 8 * 16
        assert p.initialize(size)
        data = np.arange(size, dtype=np.uint8)
        got = np.frombuffer(condition(data.tobytes(), p), dtype=np.uint8)

        # reference: walk 2x2 tiles row-major, blocks within tile row-major,
        # writing blocks to consecutive positions
        blocks = data.reshape(4, 4, 8)  # row, col, bytes
        seq = []
        for trow in range(0, 4, 2):
            for tcol in range(0, 4, 2):
                for r in range(2):
                    for c in range(2):
                        seq.append(blocks[trow + r, tcol + c])
        swizzled = np.stack(seq).reshape(16, 8)
        expect = np.zeros(size, dtype=np.uint8)
        ptr = 0
        for sub, ssz in enumerate(p.sub_block_sizes):
            off = p.sub_block_offsets[sub]
            for b in range(16):
                expect[ptr: ptr + ssz] = swizzled[b, off: off + ssz]
                ptr += ssz
        np.testing.assert_array_equal(got, expect)

    def test_condition_decondition_identity(self):
        p = make_params(C.DATA_FORMAT_BC3, 64, 64, mips=2, swizzle=True)
        size = 16 * (256 + 64)
        assert p.initialize(size)
        rng = np.random.default_rng(0)
        data = rng.integers(0, 256, size=size, dtype=np.uint8).tobytes()
        assert decondition(condition(data, p), p) == data


class TestDelta:
    def test_delta_roundtrip_one_page(self):
        p = make_params(C.DATA_FORMAT_BC1, 64, 64, delta=True)
        size = 8 * 256
        assert p.initialize(size)
        rng = np.random.default_rng(1)
        page = rng.integers(0, 256, size=size, dtype=np.uint8).tobytes()
        enc, did = delta_encode_page(page, 0, p)
        assert did
        assert delta_decode_page(enc, 0, p) == page

    def test_delta_roundtrip_split_pages(self):
        p = make_params(C.DATA_FORMAT_BC1, 128, 128, delta=True)
        size = 8 * 1024
        assert p.initialize(size)
        rng = np.random.default_rng(2)
        data = rng.integers(0, 256, size=size, dtype=np.uint8).tobytes()
        ps = 4096
        out = bytearray()
        for start in range(0, size, ps):
            page = data[start: start + ps]
            enc, did = delta_encode_page(page, start, p)
            out += delta_decode_page(enc, start, p) if did else page
        assert bytes(out) == data


class TestEndToEnd:
    def _texture(self, fmt, w, h, mips, seed=0):
        p = make_params(fmt, w, h, mips=mips)
        # compute size via a scratch params object
        scratch = make_params(fmt, w, h, mips=mips)
        bb = C.BCN_GEOMETRY[fmt]["block_bytes"]
        # derive size: width/height blocks per mip
        bp = C.BCN_GEOMETRY[fmt]["block_pixels"]
        size = 0
        wpx, hpx = w, h
        wb0 = (w + bp - 1) // bp
        hb0 = (h + bp - 1) // bp
        size += wb0 * bb * hb0
        mw, mh = (wb0 * bp) // 2, (hb0 * bp) // 2
        for m in range(1, mips):
            wb = (mw + bp - 1) // bp
            hb = (mh + bp - 1) // bp
            size += wb * bb * hb
            mw //= 2
            mh //= 2
        rng = np.random.default_rng(seed)
        # structured data so it actually compresses
        base = rng.integers(0, 8, size=size).astype(np.int64)
        grad = (np.arange(size, dtype=np.int64) // 64) % 32
        return (base + grad).astype(np.uint8).tobytes()

    @pytest.mark.parametrize("fmt", [C.DATA_FORMAT_BC1, C.DATA_FORMAT_BC5])
    @pytest.mark.parametrize("swizzle,delta", [(False, False), (True, True)])
    def test_preconditioned_stream_roundtrip(self, fmt, swizzle, delta):
        data = self._texture(fmt, 256, 256, mips=2)
        p = make_params(fmt, 256, 256, mips=2, swizzle=swizzle, delta=delta)
        blob = encode(data, page_size=C.MIN_PAGE_SIZE, dc_params=p)
        out = decode(blob)
        assert out == data


class TestDeviceEncode:
    """Preconditioned encode on the device backends (ops/precondition.py::
    preprocess_device feeding ops/encode.py and ops/encode_pack.py)."""

    def _texture(self, fmt, w, h, mips, seed=0, random=False):
        bb = C.BCN_GEOMETRY[fmt]["block_bytes"]
        bp = C.BCN_GEOMETRY[fmt]["block_pixels"]
        size = 0
        wb0 = (w + bp - 1) // bp
        hb0 = (h + bp - 1) // bp
        size += wb0 * bb * hb0
        mw, mh = (wb0 * bp) // 2, (hb0 * bp) // 2
        for m in range(1, mips):
            wb = (mw + bp - 1) // bp
            hb = (mh + bp - 1) // bp
            size += wb * bb * hb
            mw //= 2
            mh //= 2
        rng = np.random.default_rng(seed)
        if random:
            return rng.integers(0, 256, size=size).astype(np.uint8).tobytes()
        base = rng.integers(0, 8, size=size).astype(np.int64)
        grad = (np.arange(size, dtype=np.int64) // 64) % 32
        return (base + grad).astype(np.uint8).tobytes()

    @pytest.mark.parametrize("backend", ["device", "device-full"])
    @pytest.mark.parametrize("swizzle,delta", [(False, False), (True, True)])
    def test_preconditioned_tpu_encode(self, backend, swizzle, delta):
        from brotlig_tpu import api
        data = self._texture(C.DATA_FORMAT_BC1, 256, 256, mips=2)
        p = make_params(C.DATA_FORMAT_BC1, 256, 256, mips=2,
                        swizzle=swizzle, delta=delta)
        blob = api.encode(data, page_size=C.MIN_PAGE_SIZE, dc_params=p,
                          backend=backend, quality=1)
        assert decode(blob) == data           # oracle decoder
        assert api.decode(blob, backend="device") == data
        if delta:
            assert len(blob) < len(data)

    @pytest.mark.parametrize("backend", ["device", "device-full"])
    def test_preconditioned_raw_fallback(self, backend):
        # incompressible texture: pages store raw, which must hold the
        # conditioned NON-delta bytes (decoder skips delta on raw pages)
        from brotlig_tpu import api
        data = self._texture(C.DATA_FORMAT_BC3, 128, 128, mips=1,
                             random=True)
        p = make_params(C.DATA_FORMAT_BC3, 128, 128, swizzle=True,
                        delta=True)
        blob = api.encode(data, page_size=C.MIN_PAGE_SIZE, dc_params=p,
                          backend=backend, quality=1)
        assert decode(blob) == data
        assert api.decode(blob, backend="device") == data

    def test_preprocess_matches_oracle(self):
        # device preprocessing == oracle condition + per-page delta
        from brotlig_tpu.format.precondition import condition
        from brotlig_tpu.ops.precondition import preprocess_device
        data = self._texture(C.DATA_FORMAT_BC5, 128, 64, mips=1, seed=3)
        p = make_params(C.DATA_FORMAT_BC5, 128, 64, swizzle=True,
                        delta=True)
        p.initialize(len(data))
        cond, work, flags = preprocess_device(data, p, C.MIN_PAGE_SIZE)
        assert cond == condition(data, p)
        exp = bytearray()
        for i in range(0, len(cond), C.MIN_PAGE_SIZE):
            page = cond[i: i + C.MIN_PAGE_SIZE]
            enc, did = delta_encode_page(page, i, p)
            exp += enc if did else page
            assert flags[i // C.MIN_PAGE_SIZE] == did
        assert work == bytes(exp)

    @pytest.mark.parametrize("backend", ["cpu", "device", "device-full"])
    def test_geometry_mismatch_downgrades(self, backend):
        # params that do not describe the input: encoder must downgrade to
        # a plain (non-preconditioned) stream, like the reference
        from brotlig_tpu import api
        from brotlig_tpu.format.headers import StreamHeader
        data = self._texture(C.DATA_FORMAT_BC1, 64, 64, mips=1)
        p = make_params(C.DATA_FORMAT_BC1, 512, 512, swizzle=True,
                        delta=True)
        blob = api.encode(data, page_size=C.MIN_PAGE_SIZE, dc_params=p,
                          backend=backend, quality=1)
        assert not StreamHeader.unpack(blob).preconditioned
        assert decode(blob) == data
