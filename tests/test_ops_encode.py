"""Device bulk-greedy encoder: command validity and end-to-end roundtrips."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from brotlig_tpu import native
from brotlig_tpu.ops.encode import encode_stream_device, find_commands
from brotlig_tpu.refimpl.codec import decode as py_decode

from test_roundtrip import make_data

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="needs native packer")


def cmds_for(data: bytes, S=32768, fast=False):
    arr = np.zeros((1, S), np.uint8)
    arr[0, : len(data)] = np.frombuffer(data, np.uint8)
    sizes = np.array([len(data)], np.int32)
    ins, cpy, dist, nc = find_commands(jnp.asarray(arr), jnp.asarray(sizes),
                                       S // 2 + 2, fast)
    k = int(nc[0])
    return (np.asarray(ins)[0, :k], np.asarray(cpy)[0, :k],
            np.asarray(dist)[0, :k])


class TestFindCommands:
    @pytest.mark.parametrize("kind", ["text", "zeros", "repetitive",
                                      "structured"])
    @pytest.mark.parametrize("fast", [False, True])
    def test_commands_are_valid(self, kind, fast):
        data = make_data(kind, 20000, seed=1)
        ins, cpy, dist = cmds_for(data, fast=fast)
        pos = 0
        for i, c, d in zip(ins, cpy, dist):
            pos += int(i)
            assert c >= 4
            assert 1 <= d <= pos, (pos, d)
            # the copy must reproduce the original bytes
            src = bytearray(data[:pos])
            for j in range(int(c)):
                src.append(src[pos - int(d) + j])
            assert bytes(src[pos: pos + int(c)]) == \
                data[pos: pos + int(c)], "match bytes differ"
            pos += int(c)
        assert pos <= len(data)

    @pytest.mark.parametrize("fast", [False, True])
    def test_run_detection_uncapped(self, fast):
        data = b"x" * 10000
        ins, cpy, dist = cmds_for(data, fast=fast)
        # one d=1 run command should cover nearly everything
        assert len(ins) == 1
        assert dist[0] == 1
        assert cpy[0] >= 9990

    def test_empty_and_tiny(self):
        for n in (0, 1, 3, 4, 5):
            data = make_data("text", n, seed=2)
            blob = encode_stream_device(data)
            assert py_decode(blob) == data


class TestStreamTpuEncode:
    @pytest.mark.parametrize("kind,n", [
        ("text", 150_000), ("repetitive", 100_000), ("zeros", 131072),
        ("structured", 100_000), ("random", 70_000),
    ])
    def test_roundtrip_both_decoders(self, kind, n):
        data = make_data(kind, n, seed=n + 3)
        blob = encode_stream_device(data)
        assert py_decode(blob) == data
        assert native.decode(blob) == data

    def test_tpu_decodes_tpu_encoded(self):
        from brotlig_tpu.ops.decode import decode_stream_jax
        data = make_data("text", 100_000, seed=9)
        assert decode_stream_jax(encode_stream_device(data)) == data

    def test_api_backend_tpu(self):
        import brotlig_tpu
        data = make_data("text", 80_000, seed=10)
        blob = brotlig_tpu.encode(data, backend="device")
        assert brotlig_tpu.decode(blob, backend="cpu") == data

    def test_ratio_not_catastrophic(self):
        data = make_data("text", 200_000, seed=11)
        dev = len(encode_stream_device(data))
        cpu = len(native.encode(data))
        assert dev <= cpu * 1.5, (dev, cpu)


class TestRatioRegression:
    """Compression-ratio floors for the device paths (guards matcher and
    packer quality; values are ~5% below levels measured 2026-08-17, see
    PERF.md encoder ledger)."""

    def test_device_full_ratio_floors(self):
        from test_roundtrip import make_data
        from brotlig_tpu.ops.encode_pack import encode_stream_device_full
        floors = {"text": 4.3, "structured": 1.35, "repetitive": 200.0}
        for kind, floor in floors.items():
            d = make_data(kind, 128 * 1024, seed=11)
            blob = encode_stream_device_full(d, page_size=65536)
            ratio = len(d) / len(blob)
            assert ratio >= floor, f"{kind}: {ratio:.2f}x < {floor}x"

    def test_hybrid_ratio_floors(self):
        from test_roundtrip import make_data
        from brotlig_tpu.ops.encode import encode_stream_device
        from brotlig_tpu import native
        if not (native.available() and native.has_encoder()):
            import pytest
            pytest.skip("native packer unavailable")
        floors = {"text": 4.4, "repetitive": 500.0}
        for kind, floor in floors.items():
            d = make_data(kind, 128 * 1024, seed=11)
            blob = encode_stream_device(d, page_size=65536)
            ratio = len(d) / len(blob)
            assert ratio >= floor, f"{kind}: {ratio:.2f}x < {floor}x"


class TestParseDP:
    """Device windowed-DP optimal parse (ops/parse_dp.py): validity,
    roundtrips, and parity with greedy. Small shapes keep the scan
    compile bounded."""

    B, W, R = 32, 256, 6

    def _dp(self, arr, sizes, max_cmds, iters=2):
        from brotlig_tpu.ops.parse_dp import find_commands_dp
        return find_commands_dp(arr, sizes, max_cmds, iters=iters,
                                B=self.B, W=self.W, R=self.R)

    def _pages(self, kinds, S=2048):
        arr = np.zeros((len(kinds), S), np.uint8)
        sizes = np.zeros(len(kinds), np.int32)
        for i, (kind, n) in enumerate(kinds):
            d = make_data(kind, n, seed=i + 20)
            arr[i, :n] = np.frombuffer(d, np.uint8)
            sizes[i] = n
        return arr, sizes

    def test_dp_commands_valid_and_roundtrip(self):
        from brotlig_tpu.ops.encode_pack import _pack_jit
        S = 2048
        arr, sizes = self._pages(
            [("text", S), ("structured", S - 97), ("repetitive", S),
             ("random", 1000), ("zeros", S)], S)
        max_cmds = S // 2 + 2
        ins, cpy, dist, nc = self._dp(arr, sizes, max_cmds)
        for p in range(arr.shape[0]):
            data = arr[p, :sizes[p]].tobytes()
            pos = 0
            for i, c, d in zip(ins[p, :nc[p]], cpy[p, :nc[p]],
                               dist[p, :nc[p]]):
                pos += int(i)
                assert c >= 2
                assert 1 <= d <= pos, (p, pos, d)
                src = bytearray(data[:pos])
                for j in range(int(c)):
                    src.append(src[pos - int(d) + j])
                assert bytes(src[pos: pos + int(c)]) == \
                    data[pos: pos + int(c)], (p, pos)
                pos += int(c)
            assert pos <= sizes[p]
        out, osz = _pack_jit(jnp.asarray(arr), jnp.asarray(sizes), S,
                             max_cmds, jnp.asarray(ins), jnp.asarray(cpy),
                             jnp.asarray(dist), jnp.asarray(nc),
                             jnp.zeros(arr.shape[0], jnp.int32))
        out, osz = np.asarray(out), np.asarray(osz)
        for p in range(arr.shape[0]):
            blob = out[p, :osz[p]].tobytes()
            assert native.decode_page(blob, int(sizes[p])) == \
                arr[p, :sizes[p]].tobytes(), f"page {p} roundtrip"

    def test_dp_beats_greedy_on_text(self):
        from brotlig_tpu.ops.encode_pack import _pack_jit
        S = 2048
        arr, sizes = self._pages([("text", S), ("text", S - 13)], S)
        max_cmds = S // 2 + 2
        sizes_of = {}
        g = find_commands(jnp.asarray(arr), jnp.asarray(sizes), max_cmds)
        d = tuple(jnp.asarray(x) for x in self._dp(arr, sizes, max_cmds))
        for name, cmds in (("greedy", g), ("dp", d)):
            _, osz = _pack_jit(jnp.asarray(arr), jnp.asarray(sizes), S,
                               max_cmds, *cmds,
                               jnp.zeros(arr.shape[0], jnp.int32))
            sizes_of[name] = int(np.asarray(osz).sum())
        assert sizes_of["dp"] < sizes_of["greedy"], sizes_of


def test_parse_dp_static_copy_extra_matches_lut():
    # the DP's static half-bit copy-extra table must equal the runtime
    # arithmetic LUT (ADVICE r4: a drifting static twin prices edges wrong)
    from brotlig_tpu.ops import arith_lut
    from brotlig_tpu.ops.parse_dp import _CPY_EXTRA_Q
    got = 2 * np.asarray(arith_lut.copy_extra(jnp.arange(24, dtype=jnp.int32)))
    assert np.array_equal(_CPY_EXTRA_Q, got)
