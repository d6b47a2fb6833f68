"""Native CPU decoder bindings (ctypes over brotlig_core.cpp).

The shared library builds on demand with g++ -O3 (no pybind11 in this
environment). `available()` is False when no toolchain exists; callers fall
back to the Python oracle.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading

from numpy import ctypeslib as np_ctypeslib

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRCS = [os.path.join(_DIR, "brotlig_core.cpp"),
         os.path.join(_DIR, "brotlig_encode.cpp")]
_LIB = os.path.join(_DIR, "libbrotlig_core.so")
_lock = threading.Lock()
_lib = None
_build_error: str | None = None

# Progress/abort callback into the native encoder pool:
# fn(msg_type, pages_done, pages_total) -> nonzero aborts.
FEEDBACK_FN = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_int,
                               ctypes.c_uint32, ctypes.c_uint32)


def _build() -> None:
    cmd = ["g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
           "-o", _LIB] + _SRCS + ["-lpthread"]
    subprocess.run(cmd, check=True, capture_output=True)


def _load():
    global _lib, _build_error
    with _lock:
        if _lib is not None or _build_error is not None:
            return _lib
        try:
            if (not os.path.exists(_LIB)
                    or any(os.path.getmtime(_LIB) < os.path.getmtime(s)
                           for s in _SRCS)):
                _build()
            lib = ctypes.CDLL(_LIB)
            lib.blg_decompressed_size.restype = ctypes.c_uint64
            lib.blg_decompressed_size.argtypes = [
                ctypes.c_char_p, ctypes.c_uint64]
            lib.blg_decode.restype = ctypes.c_int
            lib.blg_decode.argtypes = [
                ctypes.c_char_p, ctypes.c_uint64,
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_uint64,
                ctypes.POINTER(ctypes.c_uint64), ctypes.c_int]
            lib.blg_decode_page.restype = ctypes.c_int
            lib.blg_decode_page.argtypes = [
                ctypes.c_char_p, ctypes.c_uint64,
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_uint64]
            lib.blg_encode.restype = ctypes.c_int
            lib.blg_encode.argtypes = [
                ctypes.c_char_p, ctypes.c_uint64,
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_uint64,
                ctypes.POINTER(ctypes.c_uint64), ctypes.c_uint32,
                ctypes.c_int, ctypes.c_int, ctypes.c_int]
            lib.blg_encode_ex.restype = ctypes.c_int
            lib.blg_encode_ex.argtypes = [
                ctypes.c_char_p, ctypes.c_uint64,
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_uint64,
                ctypes.POINTER(ctypes.c_uint64), ctypes.c_uint32,
                ctypes.c_int, ctypes.c_int, ctypes.c_int,
                FEEDBACK_FN]
            u32p = np_ctypeslib.ndpointer(dtype="uint32", flags="C")
            lib.blg_encode_page_cmds.restype = ctypes.c_int
            lib.blg_encode_page_cmds.argtypes = [
                ctypes.c_char_p, ctypes.c_uint64, ctypes.c_int,
                ctypes.c_int, u32p, u32p, u32p, ctypes.c_uint64,
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_uint64,
                ctypes.POINTER(ctypes.c_uint64)]
            lib.blg_parse_page.restype = ctypes.c_int
            lib.blg_parse_page.argtypes = [
                ctypes.c_char_p, ctypes.c_uint64, ctypes.c_int,
                ctypes.c_int, u32p, u32p, u32p, ctypes.c_uint64,
                ctypes.POINTER(ctypes.c_uint64),
                ctypes.POINTER(ctypes.c_uint64)]
            _lib = lib
        except Exception as e:  # toolchain missing / build failure
            _build_error = str(e)
        return _lib


def available() -> bool:
    return _load() is not None


def decompressed_size(data: bytes) -> int:
    lib = _load()
    return int(lib.blg_decompressed_size(data, len(data)))


def decode(data: bytes, num_threads: int = 0) -> bytes:
    """Decode a non-preconditioned container with the native decoder.

    Raises NotImplementedError for preconditioned streams (the Python layer
    handles deconditioning) and ValueError on corrupt input.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native decoder unavailable: {_build_error}")
    padded = data + b"\x00" * 16  # slack for the 64-bit bit-reader loads
    n = decompressed_size(data)
    # The output allocation is driven by the header-claimed size (up to
    # 65535 pages x 128 KiB ~ 8.5 GB); require the page table those pages
    # imply to actually be present before trusting it, so an 8-byte corrupt
    # header cannot demand a multi-GB buffer.
    if n:
        num_pages = int.from_bytes(data[2:4], "little")
        precon = bool(data[6] & 0x10)  # bit 20 of the header bits word
        table_off = 8 + (8 if precon else 0)
        if len(data) < table_off + 4 * num_pages:
            raise ValueError("corrupt stream (truncated page table)")
        # plausibility: every page needs at least one payload byte (real
        # compressed pages need ~6; a raw last page can be 1), so a tiny
        # input cannot claim a multi-GB decompressed size
        if len(data) < table_off + 4 * num_pages + num_pages:
            raise ValueError("corrupt stream (payload too small for "
                             "claimed page count)")
    out = (ctypes.c_uint8 * max(n, 1))()
    out_size = ctypes.c_uint64(0)
    rc = lib.blg_decode(padded, len(data), out, n,
                        ctypes.byref(out_size), num_threads)
    if rc == 2:
        raise NotImplementedError("preconditioned stream")
    if rc != 0:
        raise ValueError(f"corrupt stream (native decoder rc={rc})")
    return bytes(bytearray(out)[: out_size.value])


def has_encoder() -> bool:
    lib = _load()
    return lib is not None and hasattr(lib, "blg_encode")


def encode(data: bytes, page_size: int = 65536, max_chain: int = 64,
           num_threads: int = 0, quality: int = 11,
           feedback=None) -> bytes:
    """Compress a container with the native encoder (no preconditioning).

    quality >= 10 uses the two-pass cost-model optimal parse; lower values
    use the greedy-lazy parse (faster, worse ratio).

    feedback(msg_type, text) -> bool mirrors BROTLIG_Feedback_Proc
    (reference BrotligEncoder.cpp:402-409): called from the worker pool
    after every encoded page; returning True aborts (raises Aborted)."""
    from ..format import constants as C
    from ..format.errors import Aborted, MessageType
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native encoder unavailable: {_build_error}")
    cap = C.max_compressed_size(len(data), page_size=page_size)
    out = (ctypes.c_uint8 * cap)()
    out_size = ctypes.c_uint64(0)
    if feedback is None:
        rc = lib.blg_encode(data, len(data), out, cap,
                            ctypes.byref(out_size), page_size, max_chain,
                            num_threads, quality)
    else:
        cb_error: list = []

        def _cb(msg_type, done, total):
            try:
                return 1 if feedback(MessageType(msg_type),
                                     f"pages {done}/{total}") else 0
            except Exception as e:  # don't unwind through C
                cb_error.append(e)
                return 1
        c_cb = FEEDBACK_FN(_cb)
        rc = lib.blg_encode_ex(data, len(data), out, cap,
                               ctypes.byref(out_size), page_size, max_chain,
                               num_threads, quality, c_cb)
        if cb_error:
            raise cb_error[0]
        if rc == 5:
            raise Aborted("encode aborted by feedback callback")
    if rc != 0:
        raise ValueError(f"native encode failed (rc={rc})")
    return bytes(bytearray(out)[: out_size.value])


def encode_page_cmds(data: bytes, is_last: bool, ins, cpy, dist,
                     isdelta: bool = False) -> bytes:
    """Serialize one page from external (ins, cpy, dist) command arrays.

    Returns the compressed page, or the raw page bytes when incompressible
    (detected by the caller via len == page size)."""
    import numpy as np
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native encoder unavailable: {_build_error}")
    n = len(data)
    cap = max(2 * n + 64, 1024)
    out = (ctypes.c_uint8 * cap)()
    out_size = ctypes.c_uint64(0)
    ins = np.ascontiguousarray(ins, dtype=np.uint32)
    cpy = np.ascontiguousarray(cpy, dtype=np.uint32)
    dist = np.ascontiguousarray(dist, dtype=np.uint32)
    rc = lib.blg_encode_page_cmds(data, n, int(is_last), int(isdelta),
                                  ins, cpy, dist, len(ins), out, cap,
                                  ctypes.byref(out_size))
    if rc != 0:
        raise ValueError(f"native page encode failed (rc={rc})")
    return bytes(bytearray(out)[: out_size.value])


def parse_page(data: bytes, max_chain: int = 64, quality: int = 11):
    """Return the q11-winning command stream (ins, cpy, dist arrays, tail)
    for one page — analysis hook for parse-quality comparisons."""
    import numpy as np
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native encoder unavailable: {_build_error}")
    cap = len(data) // 2 + 64
    ins = np.zeros(cap, dtype=np.uint32)
    cpy = np.zeros(cap, dtype=np.uint32)
    dist = np.zeros(cap, dtype=np.uint32)
    ncmds = ctypes.c_uint64(0)
    tail = ctypes.c_uint64(0)
    rc = lib.blg_parse_page(data, len(data), max_chain, quality, ins, cpy,
                            dist, cap, ctypes.byref(ncmds),
                            ctypes.byref(tail))
    if rc != 0:
        raise ValueError(f"parse failed (rc={rc})")
    k = ncmds.value
    return ins[:k], cpy[:k], dist[:k], int(tail.value)


def decode_page(data: bytes, out_size: int) -> bytes:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native decoder unavailable: {_build_error}")
    padded = data + b"\x00" * 16
    out = (ctypes.c_uint8 * max(out_size, 1))()
    rc = lib.blg_decode_page(padded, len(data), out, out_size)
    if rc != 0:
        raise ValueError(f"corrupt page (native decoder rc={rc})")
    return bytes(bytearray(out)[:out_size])
