"""Route selection, compile-cache placement and the chip smoke's refusal.

Every choice of decode route is explicit: the default follows the
platform, a route that cannot run on it raises, and nothing falls back.
"""
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from brotlig_tpu.format import constants as C  # noqa: E402
from brotlig_tpu.ops.decode import (ROUTES, decode_pages,  # noqa: E402
                                    decode_stream_jax, max_cmds_for,
                                    resolve_route)
from brotlig_tpu.refimpl.codec import encode  # noqa: E402

from test_roundtrip import make_data  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_cpu_default_is_xla():
    assert resolve_route() == "xla"
    assert resolve_route("xla") == "xla"
    assert set(ROUTES) == {"xla", "triton"}


def test_triton_on_cpu_needs_interpret():
    with pytest.raises(ValueError, match="needs a GPU"):
        resolve_route("triton")
    assert resolve_route("triton", interpret=True) == "triton"


@pytest.mark.parametrize("route", ["fused", "two_phase", "pallas", "gpu"])
def test_unknown_route_raises(route):
    with pytest.raises(ValueError, match="not in"):
        resolve_route(route)


def test_interpret_only_for_triton():
    with pytest.raises(ValueError, match="triton route"):
        resolve_route("xla", interpret=True)


def test_decode_pages_refuses_triton_without_interpret():
    words = jax.numpy.zeros((1, 64), jax.numpy.uint32)
    sizes = jax.numpy.ones((1,), jax.numpy.int32)
    with pytest.raises(ValueError, match="needs a GPU"):
        decode_pages(words, sizes, C.MIN_PAGE_SIZE,
                     max_cmds_for(C.MIN_PAGE_SIZE), route="triton")


def test_stream_decode_refuses_triton_on_cpu():
    blob = encode(make_data("text", 3000, seed=1))
    with pytest.raises(ValueError, match="needs a GPU"):
        decode_stream_jax(blob, route="triton")


@pytest.mark.parametrize("backend", ["gpu", "cuda", "device-fast"])
def test_api_rejects_old_backend_names(backend):
    from brotlig_tpu import api
    blob = encode(make_data("text", 3000, seed=2))
    with pytest.raises(ValueError, match="unknown backend"):
        api.decode(blob, backend=backend)
    with pytest.raises(ValueError, match="unknown backend"):
        api.encode(b"abc" * 100, backend=backend)


def test_api_device_backend_decodes():
    from brotlig_tpu import api
    data = make_data("structured", 40_000, seed=3)
    assert api.decode(encode(data), backend="device") == data


@pytest.fixture
def cache_config():
    """Restore the process-wide cache settings that jaxcache.enable()
    writes, so one test's cache path does not outlive it."""
    names = ("jax_compilation_cache_dir",
             "jax_persistent_cache_min_compile_time_secs")
    saved = {n: getattr(jax.config, n) for n in names}
    yield
    for n, v in saved.items():
        jax.config.update(n, v)


def test_jaxcache_honours_env(monkeypatch, tmp_path, cache_config):
    from brotlig_tpu.utils import jaxcache
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
    assert jaxcache.enable() == str(tmp_path / "c")
    assert jax.config.jax_compilation_cache_dir == before
    assert not (tmp_path / "c").exists()


def test_jaxcache_fixed_path_otherwise(monkeypatch, cache_config):
    from brotlig_tpu.utils import jaxcache
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert jaxcache.CACHE_DIR == os.path.join(REPO, ".jax_cache")
    assert jaxcache.enable() == jaxcache.CACHE_DIR
    assert jax.config.jax_compilation_cache_dir == jaxcache.CACHE_DIR
    assert os.path.isdir(jaxcache.CACHE_DIR)


def _run_smoke(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_chip_smoke_refuses_cpu():
    r = _run_smoke(REPO)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "needs a GPU" in r.stderr


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run_smoke(tmp_path)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_chip_smoke_sources_are_pinned():
    """The smoke corpus reads only SOURCE_FILES, and they hash to the
    pinned SOURCE_SHA256: every checkout builds the same corpus."""
    import hashlib
    import chip_smoke
    src = chip_smoke._sources()
    assert hashlib.sha256(src).hexdigest() == chip_smoke.SOURCE_SHA256
    assert len(src) >= 2 * 4096


def test_chip_smoke_corpus_is_seeded():
    import chip_smoke  # the checkout root is on sys.path (conftest)
    a = chip_smoke.make_corpus(8, seed=5)
    b = chip_smoke.make_corpus(8, seed=5)
    c = chip_smoke.make_corpus(8, seed=6)
    assert len(a) == 8 * chip_smoke.PAGE_SIZE
    assert a == b and a != c
    pages = np.frombuffer(a, np.uint8).reshape(8, -1)
    assert len({p.tobytes() for p in pages}) == 8
