"""Triton phase-A kernel (Pallas interpreter on the CPU) vs XLA `_phase_a`.

Both routes take the same table build of the same batch; every command row
up to ncmds and every queued literal must be equal. On a GPU the kernel
compiles instead (the `gpu` test below, and chip_smoke.py at full size).
"""
from functools import partial

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from brotlig_tpu.format import constants as C  # noqa: E402
from brotlig_tpu.ops.decode import (_phase_a, decode_pages,  # noqa: E402
                                    max_cmds_for, symbol_inputs)
from brotlig_tpu.ops.phase_a_triton import phase_a_triton  # noqa: E402
from brotlig_tpu.refimpl.page_encoder import encode_page  # noqa: E402

from test_ops_decode import batch  # noqa: E402
from test_roundtrip import make_data  # noqa: E402


@partial(jax.jit, static_argnums=(2, 3))
def _both_routes(words, sizes, page_size, max_cmds):
    args = symbol_inputs(words, sizes)[:6]
    return (_phase_a(words, *args, page_size, max_cmds),
            phase_a_triton(words, *args, page_size, max_cmds,
                           interpret=True))


def assert_same_phase_a(comps, page_size):
    words, sizes = batch(comps, page_size)
    xla, tri = _both_routes(words, sizes, page_size,
                            max_cmds_for(page_size))
    xla = [np.asarray(a) for a in xla]
    tri = [np.asarray(a) for a in tri]
    assert (xla[0] == tri[0]).all(), "ncmds"
    for p in range(len(comps)):
        k = int(xla[0][p])
        assert k > 0
        for name, i in (("ins", 2), ("cpy", 3), ("dcode", 4),
                        ("dextra", 5)):
            assert (xla[i][p, :k] == tri[i][p, :k]).all(), (name, p)
        nlit = int(xla[2][p, :k].sum())
        assert (xla[1][p, :nlit] == tri[1][p, :nlit]).all(), ("lit", p)
    return xla


def _page(kind, n, seed, page_size=C.MIN_PAGE_SIZE):
    comp = encode_page(make_data(kind, n, seed=seed), is_last=True)
    assert comp is not None and len(comp) < page_size
    return comp


@pytest.mark.parametrize("kind", ["text", "zeros", "repetitive",
                                  "structured"])
def test_page_kinds(kind):
    assert_same_phase_a([_page(kind, 3000, 11)], C.MIN_PAGE_SIZE)


def test_mixed_batch():
    comps = [_page(k, 2500 + 300 * i, i + 1) for i, k in
             enumerate(["text", "repetitive", "structured", "zeros"])]
    assert_same_phase_a(comps, C.MIN_PAGE_SIZE)


def test_partial_last_page():
    # 5000 bytes of a 32 KiB page: the short last page of a stream
    assert_same_phase_a([_page("text", 5000, 3)], C.MIN_PAGE_SIZE)


def test_one_command_full_page():
    """One command covering the whole page: a tiled 173-byte pattern, so
    the literal queue holds one pattern and the copy spans the rest."""
    n = C.MIN_PAGE_SIZE
    pat = np.random.default_rng(0).integers(0, 256, 173, np.uint8).tobytes()
    comp = encode_page((pat * (n // 173 + 1))[:n], is_last=True)
    xla = assert_same_phase_a([comp], n)
    assert int(xla[3][0, : xla[0][0]].sum()) + int(
        xla[2][0, : xla[0][0]].sum()) == n


def test_dense_commands():
    """(ins=1, cpy=2, dist=1) triples: 2048 commands, 64 full rounds."""
    from brotlig_tpu import native
    if not native.available():
        pytest.skip("native encoder unavailable")
    ncmd = 2048
    r = np.random.default_rng(9)
    data = np.repeat(r.integers(0, 256, ncmd, dtype=np.uint8), 3).tobytes()
    ones = np.ones(ncmd, np.uint32)
    comp = native.encode_page_cmds(data, True, ones, 2 * ones, ones)
    assert len(comp) < len(data)
    xla = assert_same_phase_a([comp], C.MIN_PAGE_SIZE)
    assert int(xla[0][0]) >= ncmd


@pytest.mark.parametrize("page_size", [32768, 65536, 131072])
def test_page_sizes(page_size):
    assert_same_phase_a([_page("text", 4000, 21, page_size)], page_size)


def test_decode_pages_triton_route_end_to_end():
    """Kernel phase A + XLA phase B through the public batch entry."""
    datas = [make_data(k, 2000, seed=31 + i) for i, k in
             enumerate(["text", "repetitive"])]
    words, sizes = batch([encode_page(d, is_last=True) for d in datas],
                         C.MIN_PAGE_SIZE)
    out, _ = decode_pages(words, sizes, C.MIN_PAGE_SIZE,
                          max_cmds_for(C.MIN_PAGE_SIZE), route="triton",
                          interpret=True)
    for i, d in enumerate(datas):
        assert np.asarray(out)[i, : len(d)].tobytes() == d


def test_kernel_lowers_for_cuda():
    """The Pallas -> Triton lowering accepts the kernel at a real width
    (64 KiB pages); only PTX generation is left to the GPU."""
    from brotlig_tpu.ops.decode import _stage_symbols
    ps = 65536
    f = partial(_stage_symbols.__wrapped__, page_size=ps,
                max_cmds=max_cmds_for(ps), route="triton")
    lowered = jax.jit(f).trace(
        jax.ShapeDtypeStruct((2, ps // 4 + 8), jnp.uint32),
        jax.ShapeDtypeStruct((2,), jnp.int32),
    ).lower(lowering_platforms=("cuda",))
    assert "triton" in lowered.as_text()


@pytest.mark.parametrize("max_cmds", [33, 16416 + 8])
def test_kernel_refuses_ragged_command_rows(max_cmds):
    """Each round stores a full 32-slot row unmasked: a max_cmds that is
    not a multiple of 32 would let the last round store past the end."""
    # the check comes before any input is read
    words = jnp.zeros((1, C.MIN_PAGE_SIZE // 4 + 2), jnp.uint32)
    with pytest.raises(ValueError, match="multiple of 32"):
        phase_a_triton(words, *[None] * 6, C.MIN_PAGE_SIZE, max_cmds,
                       interpret=True)


def test_pack_search_matches_search_decode():
    """The kernel's packed (limit, rank_base) vectors decode every 15-bit
    window to the same (symbol, length) as tables.search_decode."""
    from brotlig_tpu.ops.phase_a_triton import pack_search
    from brotlig_tpu.ops.tables import build_search, search_decode
    lengths = np.zeros((1, 256), np.int32)
    # a complete prefix code with lengths 1..15
    lengths[0, :15] = np.arange(1, 16)
    lengths[0, 15] = 15
    s = build_search(jnp.asarray(lengths), 16, 15)
    win = jnp.arange(1 << 15, dtype=jnp.int32)[None, :]
    sym_x, len_x = search_decode(s, win, 16, 15)
    lim, base, sd = [np.asarray(a)[0] for a in pack_search(s)]
    w = np.arange(1 << 15)
    ln = 1 + (w[:, None] >= lim[None, :]).sum(1)
    code = np.where(ln > 15, 0, w >> np.maximum(15 - ln, 0))
    rank = np.clip(base[ln - 1] + code, 0, sd.shape[0] - 1)
    assert (ln == np.asarray(len_x)[0]).all()
    assert (sd[rank] == np.asarray(sym_x)[0]).all()


def test_first_codes_exact_when_oversubscribed():
    """build_search's canonical first codes are exact int32 values even
    for corrupt, oversubscribed length tables (up to ~2^24)."""
    from brotlig_tpu.ops.tables import build_search
    lengths = np.full((2, 704), 15, np.int32)
    lengths[1, ::3] = 1
    first = np.asarray(build_search(jnp.asarray(lengths), 16, 15)["first"])
    for p in range(2):
        counts = np.bincount(lengths[p], minlength=17)[:17].astype(np.int64)
        counts[0] = 0
        expect = [0]
        for ln in range(1, 17):
            expect.append((expect[-1] + counts[ln - 1]) * 2)
        assert first[p].tolist() == expect
    assert first.max() > 1 << 20


@pytest.mark.gpu
def test_compiled_kernel_matches_xla_on_gpu():
    """On a GPU: the compiled kernel's six arrays equal the XLA route's."""
    from brotlig_tpu.ops.decode import _stage_symbols
    comps = [_page(k, 3000, i) for i, k in
             enumerate(["text", "repetitive", "structured"])]
    words, sizes = batch(comps, C.MIN_PAGE_SIZE)
    mc = max_cmds_for(C.MIN_PAGE_SIZE)
    x = _stage_symbols(words, sizes, C.MIN_PAGE_SIZE, mc, "xla")
    t = _stage_symbols(words, sizes, C.MIN_PAGE_SIZE, mc, "triton")
    ncmds = np.asarray(x[0])
    assert (ncmds == np.asarray(t[0])).all()
    for i in range(2, 6):
        a, b = np.asarray(x[i]), np.asarray(t[i])
        for p, k in enumerate(ncmds):
            assert (a[p, :k] == b[p, :k]).all()
