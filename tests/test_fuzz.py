"""Corruption fuzzing: decoders must reject or produce garbage — never
crash, hang, or read out of bounds."""
import numpy as np
import pytest

from brotlig_tpu import native
from brotlig_tpu.format.errors import BrotligError
from brotlig_tpu.refimpl.codec import decode as py_decode, encode

from test_roundtrip import make_data


@pytest.fixture(scope="module")
def blob():
    return encode(make_data("text", 100_000, seed=42), page_size=32768)


def corruptions(blob, rng, n):
    out = []
    for _ in range(n):
        b = bytearray(blob)
        kind = rng.integers(0, 4)
        if kind == 0:      # flip random byte
            b[rng.integers(0, len(b))] ^= int(rng.integers(1, 256))
        elif kind == 1:    # truncate
            b = b[: rng.integers(8, len(b))]
        elif kind == 2:    # corrupt page table region
            i = int(rng.integers(8, min(40, len(b))))
            b[i] ^= 0xFF
        else:              # burst of noise in payload
            i = int(rng.integers(50, len(b) - 16))
            for j in range(16):
                b[i + j] = int(rng.integers(0, 256))
        out.append(bytes(b))
    return out


class TestFuzz:
    def test_python_oracle_never_crashes(self, blob):
        rng = np.random.default_rng(0)
        for c in corruptions(blob, rng, 60):
            try:
                py_decode(c)
            except (BrotligError, ValueError):
                pass

    @pytest.mark.skipif(not native.available(), reason="no toolchain")
    def test_native_never_crashes(self, blob):
        rng = np.random.default_rng(1)
        for c in corruptions(blob, rng, 400):
            try:
                native.decode(c)
            except (ValueError, NotImplementedError):
                pass

    def test_tpu_never_crashes(self, blob):
        from brotlig_tpu.ops.decode import decode_stream_jax
        # The fuzz target is the shared host-side stream validation +
        # device decode robustness, on the default (XLA, here) route.
        rng = np.random.default_rng(2)
        # batch_pages=1 pins the batch shape: corrupted page counts and
        # truncations then share one compiled program per words-bucket
        for c in corruptions(blob, rng, 32):
            try:
                decode_stream_jax(c, batch_pages=1, route="xla")
            except (BrotligError, ValueError, IndexError):
                pass

    def test_tpu_targeted_header_corruptions(self, blob):
        """Deterministic high-value corruption targets for the device
        route: stream header fields, page header byte, size-table region,
        and the Huffman table area of page 0 (XLA route, see above)."""
        from brotlig_tpu.format.headers import StreamHeader
        from brotlig_tpu.ops.decode import decode_stream_jax
        payload0 = 8 + 4 * int.from_bytes(blob[2:4], "little")
        # stream header bytes + page-0 header byte + Huffman table area.
        # Deep-payload flips are covered by the random corruption tests
        # above; here they would only force cold compiles of the max
        # command-count bucket (a legal but otherwise-unreached shape
        # that costs ~9 min of XLA CPU compile).
        targets = (
            list(range(0, 8))
            + [payload0, payload0 + 1, payload0 + 2, payload0 + 5]
        )
        for t in targets:
            for val in (0x00, 0xFF, 0x55):
                b = bytearray(blob)
                if t < len(b):
                    b[t] = val
                try:
                    # corruptions that change only the claimed page size
                    # are format-legal and would each cold-compile a new
                    # shape-specialized program just to reinterpret the
                    # same payload bits; payload corruptions at the true
                    # page size cover the device paths without that cost
                    hdr = StreamHeader.unpack(bytes(b[:8]))
                    if hdr.page_size != 32768:
                        continue
                except BrotligError:
                    pass  # header rejects — the cheap, valuable case
                try:
                    decode_stream_jax(bytes(b), batch_pages=1,
                                      route="xla")
                except (BrotligError, ValueError, IndexError):
                    pass

    def test_triton_route_corrupt_pages_stay_in_their_rows(self):
        """Corrupt pages through the Triton phase A (Pallas interpreter)
        and phase B: nothing crashes, and the valid pages batched beside
        them still decode exactly, so a corrupt page's reads and stores
        stay inside its own rows."""
        from brotlig_tpu.format import constants as C
        from brotlig_tpu.ops.decode import decode_pages, max_cmds_for
        from brotlig_tpu.refimpl.page_encoder import encode_page
        from test_ops_decode import batch
        ps = C.MIN_PAGE_SIZE
        datas = [make_data(k, 3000, seed=40 + i)
                 for i, k in enumerate(["text", "structured"])]
        comps = [encode_page(d, is_last=True) for d in datas]
        rng = np.random.default_rng(4)
        for _ in range(3):
            bad = [corrupt_page(c, rng) for c in comps]
            words, sizes = batch([comps[0], bad[0], comps[1], bad[1]], ps)
            out, _ = decode_pages(words, sizes, ps, max_cmds_for(ps),
                                  route="triton", interpret=True)
            out = np.asarray(out)
            assert out.shape == (4, ps)
            assert out[0, :len(datas[0])].tobytes() == datas[0]
            assert out[2, :len(datas[1])].tobytes() == datas[1]


def corrupt_page(comp, rng):
    """One compressed page with flipped bytes, a noise burst, or cut
    short."""
    b = bytearray(comp)
    kind = rng.integers(0, 3)
    if kind == 0:
        for _ in range(4):
            b[rng.integers(0, len(b))] ^= int(rng.integers(1, 256))
    elif kind == 1:
        i = int(rng.integers(0, len(b) - 16))
        b[i: i + 16] = rng.integers(0, 256, 16, np.uint8).tobytes()
    else:
        b = b[: rng.integers(4, len(b))]
    return bytes(b)


class TestPageTableValidation:
    """decode_stream_jax must reject out-of-bounds page tables with a typed
    CorruptStream, like the native decoder (brotlig_core.cpp:436-439)."""

    def test_tpu_rejects_bad_table(self, blob):
        from brotlig_tpu.format.errors import CorruptStream
        from brotlig_tpu.ops.decode import decode_stream_jax
        # entry 1 is page 1's offset: point it far past the payload
        b = bytearray(blob)
        b[12:16] = (2 ** 31 - 1).to_bytes(4, "little")
        with pytest.raises(CorruptStream):
            decode_stream_jax(bytes(b))

    def test_tpu_rejects_truncated_table(self, blob):
        from brotlig_tpu.format.errors import CorruptStream
        from brotlig_tpu.ops.decode import decode_stream_jax
        with pytest.raises(CorruptStream):
            decode_stream_jax(blob[:10])

    def test_tpu_rejects_truncated_header(self):
        from brotlig_tpu.format.errors import CorruptStream
        from brotlig_tpu.ops.decode import decode_stream_jax
        with pytest.raises(CorruptStream):
            decode_stream_jax(b"\x05\xfa\x01")

    @pytest.mark.skipif(not native.available(), reason="no toolchain")
    def test_native_bounded_insert_dos(self):
        """A page declaring huge inserts must be rejected before the literal
        fill loop allocates (round-1 ADVICE item 1): decode of random noise
        pages completes quickly and raises, never ballooning memory."""
        rng = np.random.default_rng(7)
        for _ in range(50):
            page = rng.integers(0, 256, 200, dtype=np.uint8).tobytes()
            try:
                native.decode_page(page, 131072)
            except ValueError:
                pass
