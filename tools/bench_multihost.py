"""Multi-process decode AND encode scaling (BASELINE config 5).

Runs the same archive workload with 1, 2 and 4 worker processes (CPU
backend, each process pinned to ONE core so per-process compute is
constant across every point) and reports wall time +
scaling efficiency T1 / (nproc * Tn). Multi-process runs use
jax.distributed and finish with the real owned-bytes ordered all-gathers
(`decode_archives_gather` / `encode_archives_gather`), so the measured
times include the cross-process assembly.

Usage: python tools/bench_multihost.py [n_archives] [archive_kb]
"""
import os
import pickle
import socket
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

WORKER = r'''
import pickle, sys, time
import jax
coord, nproc, pid, path = (sys.argv[1], int(sys.argv[2]),
                           int(sys.argv[3]), sys.argv[4])
if nproc > 1:
    jax.distributed.initialize(coord, num_processes=nproc, process_id=pid)
    from jax.experimental import multihost_utils
    multihost_utils.sync_global_devices("warmup")
sys.path.insert(0, {repo!r})
from brotlig_tpu.utils import jaxcache
jaxcache.enable()
from brotlig_tpu.parallel.runtime import decode_archives_gather
blobs = pickle.loads(open(path, "rb").read())
proc = None if nproc > 1 else (0, 1)
# warmup pass compiles every program; the timed pass measures decode
decode_archives_gather(blobs, batch_pages=8, process=proc)
from brotlig_tpu.parallel.runtime import decode_archives
if nproc > 1:
    from jax.experimental import multihost_utils
    multihost_utils.sync_global_devices("timed-start")
t0 = time.perf_counter()
local = decode_archives(blobs, batch_pages=8, process=proc)
t_dec = time.perf_counter() - t0
if nproc > 1:
    multihost_utils.sync_global_devices("gather-start")
t0 = time.perf_counter()
outs = decode_archives_gather(blobs, batch_pages=8, process=proc)
dt = time.perf_counter() - t0
print(f"WORKER {{pid}} time {{dt:.3f}}s decode {{t_dec:.3f}}s "
      f"n={{len(outs)}}", flush=True)
# encode points: local-share encode, then the owned-bytes encode gather
from brotlig_tpu.parallel.runtime import (encode_archives,
                                          encode_archives_gather)
datas = [outs[i] for i in range(len(outs))]
encode_archives(datas[:1], page_size=32768, process=proc)   # warm
if nproc > 1:
    multihost_utils.sync_global_devices("enc-start")
t0 = time.perf_counter()
encode_archives(datas, page_size=32768, process=proc)
t_enc = time.perf_counter() - t0
if nproc > 1:
    multihost_utils.sync_global_devices("encg-start")
t0 = time.perf_counter()
eouts = encode_archives_gather(datas, page_size=32768, process=proc)
t_encg = time.perf_counter() - t0
print(f"WORKER {{pid}} encode {{t_enc:.3f}}s encode+gather "
      f"{{t_encg:.3f}}s n={{len(eouts)}}", flush=True)
'''


def run(nproc: int, blob_path: str, n_arch: int) -> float:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    with tempfile.NamedTemporaryFile("w", suffix=".py", delete=False) as f:
        f.write(WORKER.format(repo=REPO))
        wpath = f.name
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    # the workers stay on the CPU: a JAX process reserves most of a GPU's
    # memory, so several processes on one card fail (one per card at most)
    env["JAX_PLATFORMS"] = "cpu"
    procs = []
    t0 = time.perf_counter()
    for pid in range(nproc):
        cores = str(pid)
        procs.append(subprocess.Popen(
            ["taskset", "-c", cores, sys.executable, wpath,
             f"127.0.0.1:{port}", str(nproc), str(pid), blob_path],
            env=env, stdout=subprocess.PIPE, text=True))
    outs = [p.communicate(timeout=1800)[0] for p in procs]
    wall = time.perf_counter() - t0
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o
    lines = [ln for o in outs for ln in o.splitlines() if "WORKER" in ln]
    dec_lines = [ln for ln in lines if " time " in ln]
    enc_lines = [ln for ln in lines if " encode " in ln]
    tt = [float(ln.split("time ")[1].split("s")[0]) for ln in dec_lines]
    td = [float(ln.split("decode ")[1].split("s")[0]) for ln in dec_lines]
    te = [float(ln.split("encode ")[1].split("s")[0]) for ln in enc_lines]
    tg = [float(ln.split("encode+gather ")[1].split("s")[0])
          for ln in enc_lines]
    return max(tt), max(td), max(te), max(tg)


def main():
    n_arch = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    kb = int(sys.argv[2]) if len(sys.argv) > 2 else 256
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from test_roundtrip import make_data
    from brotlig_tpu import native
    datas = [make_data("text", kb * 1024, seed=100 + i)
             for i in range(n_arch)]
    blobs = [native.encode(d, page_size=32768) for d in datas]
    total = sum(len(d) for d in datas)
    with tempfile.NamedTemporaryFile("wb", suffix=".pkl",
                                     delete=False) as f:
        pickle.dump(blobs, f)
        path = f.name
    t1, t1d, t1e, t1g = run(1, path, n_arch)
    print(f"archives={n_arch} x {kb}KiB total={total/1e6:.1f}MB")
    print(f"1-proc: decode {t1d:.2f}s, decode+gather {t1:.2f}s, "
          f"encode {t1e:.2f}s, encode+gather {t1g:.2f}s")
    for n in (2, 4):
        tn, tnd, tne, tng = run(n, path, n_arch)
        print(f"{n}-proc: decode {tnd:.2f}s, decode+gather {tn:.2f}s, "
              f"encode {tne:.2f}s, encode+gather {tng:.2f}s")
        print(f"scaling efficiency (n={n}): decode-only "
              f"{t1d/(n*tnd):.3f}, with ordered gather {t1/(n*tn):.3f}, "
              f"encode-only {t1e/(n*tne):.3f}, with gather "
              f"{t1g/(n*tng):.3f}")


if __name__ == "__main__":
    main()
