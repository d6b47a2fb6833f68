"""brotlig_tpu: a Brotli-G codec on JAX devices (XLA + a Triton kernel).

Public API mirrors the reference C API (inc/BrotliG.h):
encode / decode / decompressed_size / max_compressed_size.
"""
from .api import (decode, decode_cpu, decompressed_size, encode,
                  max_compressed_size)

__all__ = ["encode", "decode", "decode_cpu", "decompressed_size",
           "max_compressed_size"]
__version__ = "0.1.0"
