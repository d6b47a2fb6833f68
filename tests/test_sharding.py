"""Multi-device (virtual 8-CPU mesh) sharded decode == single-device."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")

from brotlig_tpu.format import constants as C
from brotlig_tpu.parallel.sharding import (decode_stream_sharded, make_mesh,
                                           pad_batch)
from brotlig_tpu.refimpl.codec import encode

from test_roundtrip import make_data


@pytest.fixture(scope="module")
def cpu_mesh():
    devs = jax.devices("cpu")
    assert len(devs) >= 8, "conftest should expose 8 virtual CPU devices"
    return make_mesh(devs[:8])


class TestShardedDecode:
    def test_eight_way_roundtrip(self, cpu_mesh):
        # 10 pages over 8 devices -> padded to 16 with dummy pages
        data = make_data("text", 10 * C.MIN_PAGE_SIZE - 1234, seed=5)
        blob = encode(data, page_size=C.MIN_PAGE_SIZE)
        out = decode_stream_sharded(blob, cpu_mesh)
        assert out == data

    def test_matches_unsharded(self, cpu_mesh):
        from brotlig_tpu.ops.decode import decode_stream_jax
        data = make_data("repetitive", 5 * C.MIN_PAGE_SIZE, seed=6)
        blob = encode(data, page_size=C.MIN_PAGE_SIZE)
        assert decode_stream_sharded(blob, cpu_mesh) == \
            decode_stream_jax(blob)

    def test_pad_batch(self):
        assert pad_batch(10, 8) == 16
        assert pad_batch(8, 8) == 8
        assert pad_batch(1, 8) == 8


class TestChunkedBundle:
    def test_chunked_equals_unchunked(self):
        """Many pages decoded in small fixed batches == oracle."""
        from brotlig_tpu.ops.decode import decode_stream_jax
        data = make_data("text", 9 * C.MIN_PAGE_SIZE + 777, seed=21)
        blob = encode(data, page_size=C.MIN_PAGE_SIZE)
        assert decode_stream_jax(blob, batch_pages=4) == data

    def test_chunked_with_raw_pages(self):
        import numpy as np
        from brotlig_tpu.ops.decode import decode_stream_jax
        rng = np.random.default_rng(0)
        parts = []
        for i in range(3):
            parts.append(make_data("text", C.MIN_PAGE_SIZE, seed=i))
            parts.append(rng.integers(0, 256, C.MIN_PAGE_SIZE,
                                      dtype=np.uint8).tobytes())
        data = b"".join(parts)
        blob = encode(data, page_size=C.MIN_PAGE_SIZE)
        assert decode_stream_jax(blob, batch_pages=2) == data


class TestArchives:
    def test_multi_archive_roundtrip(self):
        from brotlig_tpu.parallel.runtime import (decode_archives,
                                                  encode_archives)
        datas = [make_data("text", 40_000 + i * 1000, seed=30 + i)
                 for i in range(3)]
        blobs = encode_archives(datas)
        assert sorted(blobs) == [0, 1, 2]
        outs = decode_archives([blobs[i] for i in range(3)],
                               batch_pages=2)
        for i in range(3):
            assert outs[i] == datas[i]

    def test_decode_archives_to_dir(self, tmp_path):
        """Shared-storage flow: outputs land as files keyed by archive
        index, zero gather traffic (the 100 GB config-5 shape)."""
        from brotlig_tpu.parallel.runtime import decode_archives_to_dir
        datas = [make_data("text", 35_000 + i * 900, seed=70 + i)
                 for i in range(3)]
        blobs = [encode(d, page_size=C.MIN_PAGE_SIZE) for d in datas]
        paths = decode_archives_to_dir(blobs, tmp_path / "out",
                                       batch_pages=2, process=(0, 1))
        assert len(paths) == 3
        for i, d in enumerate(datas):
            assert (tmp_path / "out" / f"archive_{i:05d}.bin"
                    ).read_bytes() == d

    def test_batched_multi_archive(self):
        """Pages of many archives pooled into shared device batches."""
        import numpy as np
        from brotlig_tpu.parallel.runtime import decode_archives_batched
        from brotlig_tpu.format.precondition import DataConditionParams
        rng = np.random.default_rng(7)
        datas = [make_data(["text", "repetitive", "structured"][i % 3],
                           30_000 + i * 7000, seed=50 + i) for i in range(5)]
        blobs = [encode(d, page_size=C.MIN_PAGE_SIZE) for d in datas]
        # include a preconditioned archive and a raw-ish (random) one
        tex = ((rng.integers(0, 8, 128 * 128 * 8)
                + np.arange(128 * 128 * 8) // 64) % 256
               ).astype(np.uint8).tobytes()
        p = DataConditionParams(precondition=True, swizzle=True,
                                delta_encode=True, format=C.DATA_FORMAT_BC1,
                                width_in_pixels=512, height_in_pixels=512)
        datas.append(tex)
        blobs.append(encode(tex, page_size=C.MIN_PAGE_SIZE, dc_params=p))
        datas.append(rng.integers(0, 256, 40_000, dtype=np.uint8).tobytes())
        blobs.append(encode(datas[-1], page_size=C.MIN_PAGE_SIZE))

        outs = decode_archives_batched(blobs, batch_pages=4)
        for i, d in enumerate(datas):
            assert outs[i] == d, f"archive {i}"

    def test_archive_interleaving(self, monkeypatch):
        """Static interleave covers all archives exactly once across procs."""
        from brotlig_tpu.parallel import runtime
        seen = []
        for pid in range(3):
            monkeypatch.setattr(runtime, "process_info", lambda p=pid: (p, 3))
            seen.extend(runtime.my_archive_indices(10))
        assert sorted(seen) == list(range(10))

    def test_two_process_distributed_decode(self, tmp_path):
        """Real multi-process run: 2 workers with explicit identities decode
        disjoint archive subsets (BASELINE config 5's orchestration)."""
        import pickle
        import subprocess
        import sys as _sys
        from brotlig_tpu import native
        datas = [make_data("text", 40_000 + i * 4000, seed=80 + i)
                 for i in range(5)]
        blobs = [native.encode(d, page_size=32768) for d in datas]
        (tmp_path / "blobs.pkl").write_bytes(pickle.dumps(blobs))
        worker = tmp_path / "worker.py"
        worker.write_text(f"""
import pickle, sys
import jax
jax.config.update("jax_default_device", jax.devices("cpu")[0])
sys.path.insert(0, {str(C.__file__.rsplit('/brotlig_tpu/', 1)[0])!r})
from brotlig_tpu.utils import jaxcache
jaxcache.enable()
from brotlig_tpu.parallel.runtime import decode_archives
pid = int(sys.argv[1])
blobs = pickle.loads(open({str(tmp_path / 'blobs.pkl')!r}, 'rb').read())
outs = decode_archives(blobs, batch_pages=2, process=(pid, 2))
open({str(tmp_path)!r} + f"/out_{{pid}}.pkl", "wb").write(
    pickle.dumps(outs))
""")
        import os as _os
        env = dict(_os.environ)
        env["PYTHONPATH"] = C.__file__.rsplit('/brotlig_tpu/', 1)[0]
        # the workers stay on the CPU and never open a GPU: a JAX process
        # reserves most of a card's memory, so two on one card fail
        env["JAX_PLATFORMS"] = "cpu"
        procs = [subprocess.Popen([_sys.executable, str(worker), str(i)],
                                  env=env)
                 for i in range(2)]
        for p in procs:
            assert p.wait(timeout=500) == 0
        o0 = pickle.loads((tmp_path / "out_0.pkl").read_bytes())
        o1 = pickle.loads((tmp_path / "out_1.pkl").read_bytes())
        assert set(o0) & set(o1) == set()
        merged = {**o0, **o1}
        assert sorted(merged) == list(range(5))
        for i, d in enumerate(datas):
            assert merged[i] == d

    def test_two_process_allgather_decode(self, tmp_path):
        """jax.distributed 2-process run: decode_archives_gather's
        process_allgather hands EVERY process the full ordered output
        (the cross-host gather BASELINE config 5 requires)."""
        import pickle
        import socket
        import subprocess
        import sys as _sys
        import os as _os
        from brotlig_tpu import native
        # near-identical sizes keep the workers' compile/decode times
        # aligned (the gloo key exchange only waits ~30s for the peer);
        # the small spread exercises the gather's ragged per-owner offsets
        datas = [make_data("text", 30_000 + 700 * i, seed=90 + i)
                 for i in range(5)]
        blobs = [native.encode(d, page_size=32768) for d in datas]
        (tmp_path / "blobs.pkl").write_bytes(pickle.dumps(blobs))
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        repo = C.__file__.rsplit('/brotlig_tpu/', 1)[0]
        worker = tmp_path / "worker_ag.py"
        worker.write_text(f"""
import pickle, sys
import jax
jax.distributed.initialize("127.0.0.1:{port}", num_processes=2,
                           process_id=int(sys.argv[1]))
from jax.experimental import multihost_utils
multihost_utils.sync_global_devices("warmup")  # build the gloo context
sys.path.insert(0, {repo!r})
from brotlig_tpu.utils import jaxcache
jaxcache.enable()
from brotlig_tpu.parallel.runtime import decode_archives_gather
pid = int(sys.argv[1])
blobs = pickle.loads(open({str(tmp_path / 'blobs.pkl')!r}, 'rb').read())
outs = decode_archives_gather(blobs, batch_pages=2)
open({str(tmp_path)!r} + f"/ag_{{pid}}.pkl", "wb").write(
    pickle.dumps(outs))
""")
        env = dict(_os.environ)
        env["PYTHONPATH"] = repo
        # CPU workers: one JAX process per card at most (see above)
        env["JAX_PLATFORMS"] = "cpu"
        procs = [subprocess.Popen([_sys.executable, str(worker), str(i)],
                                  env=env)
                 for i in range(2)]
        for p in procs:
            assert p.wait(timeout=500) == 0
        for pid in range(2):
            outs = pickle.loads((tmp_path / f"ag_{pid}.pkl").read_bytes())
            assert len(outs) == len(datas)
            for i, d in enumerate(datas):
                assert outs[i] == d, f"proc {pid} archive {i}"

    def test_two_process_allgather_encode(self, tmp_path):
        """jax.distributed 2-process run: encode_archives_gather's
        owned-bytes exchange (size allgather + payload allgather) hands
        EVERY process the full ordered set of compressed archives — the
        encode mirror of the decode gather (round-3 VERDICT item 7;
        reference analog: container assembly BrotligEncoder.cpp:469-516)."""
        import pickle
        import socket
        import subprocess
        import sys as _sys
        import os as _os
        from brotlig_tpu import native
        datas = [make_data("text", 24_000 + 900 * i, seed=70 + i)
                 for i in range(5)]
        (tmp_path / "datas.pkl").write_bytes(pickle.dumps(datas))
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        repo = C.__file__.rsplit('/brotlig_tpu/', 1)[0]
        worker = tmp_path / "worker_enc_ag.py"
        worker.write_text(f"""
import pickle, sys
import jax
jax.distributed.initialize("127.0.0.1:{port}", num_processes=2,
                           process_id=int(sys.argv[1]))
from jax.experimental import multihost_utils
multihost_utils.sync_global_devices("warmup")  # build the gloo context
sys.path.insert(0, {repo!r})
from brotlig_tpu.utils import jaxcache
jaxcache.enable()
from brotlig_tpu.parallel.runtime import encode_archives_gather
pid = int(sys.argv[1])
datas = pickle.loads(open({str(tmp_path / 'datas.pkl')!r}, 'rb').read())
blobs = encode_archives_gather(datas, page_size=32768)
open({str(tmp_path)!r} + f"/eag_{{pid}}.pkl", "wb").write(
    pickle.dumps(blobs))
""")
        env = dict(_os.environ)
        env["PYTHONPATH"] = repo
        # CPU workers: one JAX process per card at most (see above)
        env["JAX_PLATFORMS"] = "cpu"
        procs = [subprocess.Popen([_sys.executable, str(worker), str(i)],
                                  env=env)
                 for i in range(2)]
        for p in procs:
            assert p.wait(timeout=500) == 0
        all_blobs = []
        for pid in range(2):
            blobs = pickle.loads((tmp_path / f"eag_{pid}.pkl").read_bytes())
            assert len(blobs) == len(datas)
            all_blobs.append(blobs)
        assert all_blobs[0] == all_blobs[1]   # both hold identical sets
        for i, d in enumerate(datas):
            assert native.decode(all_blobs[0][i]) == d, f"archive {i}"
