"""Public Brotli-G API (mirrors the reference C API, inc/BrotliG.h:25-26).

encode()            -> native/device encoder by backend (all support feedback)
decode()            -> device decoder on the default JAX device
decode_cpu()        -> CPU oracle decoder
decompressed_size() -> header-only size query
max_compressed_size() -> one-shot output buffer bound
"""
from __future__ import annotations

from .format import constants as C
from .format.precondition import DataConditionParams
from .refimpl import codec as _cpu

max_compressed_size = C.max_compressed_size


def encode(data: bytes, page_size: int = C.DEFAULT_PAGE_SIZE,
           dc_params: DataConditionParams | None = None,
           max_chain: int = 64, feedback=None,
           backend: str = "auto", quality: int = 11) -> bytes:
    """Compress a Brotli-G container.

    backend: "cpu" (native C++ page-parallel encoder, best ratio),
    "device" (device bulk match finding + native serialization),
    "device-full" (match finding AND serialization on device), or "auto"
    (cpu). quality >= 10 selects the optimal-parse tier (native two-pass
    DP / device windowed DP); lower values use the greedy parse. The
    "device" hybrid always parses greedily (its serializer is the native
    packer).
    `feedback(type, text) -> bool` mirrors BROTLIG_Feedback_Proc; returning
    True aborts (errors.Aborted) on every backend: the native pool calls it
    per encoded page, the device paths per page batch.

    Note: with dc_params set, "auto" routes through the Python encoder
    (the native encoder has no preconditioning path); use a device
    backend for device-side preconditioning."""
    if backend == "device-full":
        from .ops.encode_pack import encode_stream_device_full
        return encode_stream_device_full(data, page_size=page_size,
                                         dc_params=dc_params,
                                         feedback=feedback, quality=quality)
    if backend == "device":
        from .ops.encode import encode_stream_device
        return encode_stream_device(data, page_size=page_size,
                                    dc_params=dc_params, feedback=feedback)
    if backend not in ("auto", "cpu"):
        raise ValueError(f"unknown backend {backend!r}")
    if dc_params is None:
        from .format.errors import Aborted
        try:
            from . import native
            if native.available() and native.has_encoder():
                return native.encode(data, page_size=page_size,
                                     quality=quality, feedback=feedback)
        except Aborted:
            raise
        except Exception:
            pass
    return _cpu.encode(data, page_size=page_size, dc_params=dc_params,
                       max_chain=max_chain, feedback=feedback)


def decode_cpu(data: bytes, num_threads: int = 0) -> bytes:
    """CPU decode: native C++ decoder when available (multithreaded over
    pages), Python oracle otherwise / for preconditioned streams."""
    try:
        from . import native
        if native.available():
            return native.decode(data, num_threads=num_threads)
    except (NotImplementedError, RuntimeError):
        pass
    return _cpu.decode(data)


def decompressed_size(data: bytes) -> int:
    return _cpu.decompressed_size(data)


def decode(data: bytes, backend: str = "auto", feedback=None) -> bytes:
    """Decode a Brotli-G container.

    backend: "device" (or "auto") decodes on the default JAX device, "cpu"
    with the native decoder / scalar oracle. The device path never falls
    back to the CPU: its failures raise. The platform picks the device
    route (ops.decode.resolve_route).
    feedback: optional callable(progress 0..100) -> bool invoked per device
    batch (decode analog of BROTLIG_Feedback_Proc,
    BrotligDecoder.cpp:318-325); returning True raises errors.Aborted.
    """
    if backend == "cpu":
        return decode_cpu(data)
    if backend not in ("auto", "device"):
        raise ValueError(f"unknown backend {backend!r}")
    from .ops.decode import decode_stream_jax
    return decode_stream_jax(data, feedback=feedback)
