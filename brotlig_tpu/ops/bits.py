"""Vectorized LSB-first bit reads over batched uint32 word buffers.

The device decoder keeps each page's compressed bytes as a row of uint32 words
and addresses them with absolute bit positions per (page, lane). A read
gathers two words and funnel-shifts — the vector analog of the reference's
64-bit hold (inc/common/BrotligDeswizzler.h:139-192) without mutable state.
"""
from __future__ import annotations

import jax.numpy as jnp


def bytes_to_words(data: bytes, pad_words: int = 2) -> jnp.ndarray:
    import numpy as np
    n = (len(data) + 3) // 4 + pad_words
    buf = np.zeros(n * 4, dtype=np.uint8)
    buf[: len(data)] = np.frombuffer(data, dtype=np.uint8)
    return jnp.asarray(buf.view(np.uint32))


def peek_bits(words: jnp.ndarray, bitpos: jnp.ndarray, n_bits) -> jnp.ndarray:
    """Peek up to 30 bits at `bitpos` (no consume).

    words: uint32 [P, W] (padded by >=2 words past the data end)
    bitpos: int32 [P, ...] absolute bit positions into the row's words
    n_bits: scalar or array broadcastable to bitpos (0..30)
    Returns uint32 values shaped like bitpos.
    """
    word_idx = (bitpos >> 5).astype(jnp.int32)
    sh = (bitpos & 31).astype(jnp.uint32)
    w0 = jnp.take_along_axis(words, word_idx, axis=-1)
    w1 = jnp.take_along_axis(words, word_idx + 1, axis=-1)
    lo = w0 >> sh
    hi = jnp.where(sh == 0, jnp.uint32(0), w1 << (jnp.uint32(32) - sh))
    window = lo | hi
    n = jnp.asarray(n_bits, dtype=jnp.uint32)
    mask = jnp.where(n >= 32, jnp.uint32(0xFFFFFFFF),
                     (jnp.uint32(1) << n) - jnp.uint32(1))
    return jnp.where(n == 0, jnp.uint32(0), window & mask)


def fetch_window(words: jnp.ndarray, bitpos: jnp.ndarray, n_words: int):
    """Fetch n_words consecutive uint32 words per lane with ONE gather.

    Returns (stacked [..., K, n_words] uint32, shift [..., K] = bitpos&31).
    Bit offset d within the window is then extracted with extract_bits.
    """
    word_idx = (bitpos >> 5).astype(jnp.int32)
    K = word_idx.shape[-1]
    idx = jnp.concatenate([word_idx + k for k in range(n_words)], axis=-1)
    g = jnp.take_along_axis(words, idx, axis=-1)
    win = jnp.stack([g[..., k * K:(k + 1) * K] for k in range(n_words)],
                    axis=-1)
    return win, (bitpos & 31).astype(jnp.int32)


def extract_bits(win: jnp.ndarray, sh: jnp.ndarray, delta, n_bits,
                 n_words: int) -> jnp.ndarray:
    """Extract an n_bits field at bit offset sh+delta from a fetched window.

    win: [..., K, n_words] uint32; sh, delta, n_bits broadcastable [..., K].
    Requires sh+delta+n_bits <= 32*n_words (caller guarantees).
    """
    off = sh + jnp.asarray(delta, dtype=jnp.int32)
    widx = off >> 5
    bitoff = (off & 31).astype(jnp.uint32)
    # select word widx and widx+1 via a where-ladder (no gather)
    w0 = win[..., 0]
    w1 = win[..., 1] if n_words > 1 else jnp.zeros_like(w0)
    for k in range(1, n_words):
        sel = widx == k
        w0 = jnp.where(sel, win[..., k], w0)
        w1 = jnp.where(sel, win[..., k + 1] if k + 1 < n_words
                       else jnp.zeros_like(w0), w1)
    lo = w0 >> bitoff
    hi = jnp.where(bitoff == 0, jnp.uint32(0),
                   w1 << (jnp.uint32(32) - bitoff))
    window = lo | hi
    n = jnp.asarray(n_bits, dtype=jnp.uint32)
    mask = jnp.where(n >= 32, jnp.uint32(0xFFFFFFFF),
                     (jnp.uint32(1) << n) - jnp.uint32(1))
    return jnp.where(n == 0, jnp.uint32(0), window & mask)


def reverse_bits_15(v: jnp.ndarray) -> jnp.ndarray:
    """Bit-reverse a 15-bit value (vectorized)."""
    v = v.astype(jnp.uint32)
    # reverse 16 bits then shift right by 1
    v = ((v & 0x5555) << 1) | ((v >> 1) & 0x5555)
    v = ((v & 0x3333) << 2) | ((v >> 2) & 0x3333)
    v = ((v & 0x0F0F) << 4) | ((v >> 4) & 0x0F0F)
    v = ((v & 0x00FF) << 8) | ((v >> 8) & 0x00FF)
    return v >> 1
