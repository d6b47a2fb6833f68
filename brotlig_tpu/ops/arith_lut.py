"""Branchless arithmetic forms of the RFC 7932 command/length tables.

The insert/copy code tables (format/lut.py) are re-derived here as
where-ladders over vector registers, so the decode loops (XLA route and
the Triton kernel alike) need no table gather per command. Verified exhaustively against
the table forms in tests/test_ops_decode.py.
"""
from __future__ import annotations

import jax.numpy as jnp

I32 = jnp.int32


def insert_extra(c):
    """INSERT_EXTRA[c] for insert codes 0..23."""
    c = c.astype(I32)
    v = jnp.where(c < 6, 0, ((c - 6) >> 1) + 1)
    v = jnp.where(c >= 16, c - 10, v)
    v = jnp.where(c == 21, 12, v)
    v = jnp.where(c == 22, 14, v)
    v = jnp.where(c == 23, 24, v)
    return v


def insert_base(c):
    """INSERT_BASE[c] for insert codes 0..23."""
    c = c.astype(I32)
    e = ((c - 6) >> 1) + 1
    v = jnp.where(c < 6, c, ((2 + (c & 1)) << jnp.maximum(e, 0)) + 2)
    v = jnp.where(c >= 16, (1 << jnp.clip(c - 10, 0, 11)) + 66, v)
    v = jnp.where(c == 21, 2114, v)
    v = jnp.where(c == 22, 6210, v)
    v = jnp.where(c == 23, 22594, v)
    return v


def copy_extra(c):
    """COPY_EXTRA[c] for copy codes 0..23."""
    c = c.astype(I32)
    v = jnp.where(c < 8, 0, ((c - 8) >> 1) + 1)
    v = jnp.where(c >= 18, c - 12, v)
    v = jnp.where(c == 23, 24, v)
    return v


def copy_base(c):
    """COPY_BASE[c] for copy codes 0..23."""
    c = c.astype(I32)
    e = ((c - 8) >> 1) + 1
    v = jnp.where(c < 8, c + 2, ((2 + (c & 1)) << jnp.maximum(e, 0)) + 6)
    v = jnp.where(c >= 18, (1 << jnp.clip(c - 12, 0, 10)) + 70, v)
    v = jnp.where(c == 23, 2118, v)
    return v


def split_command(sym):
    """Command prefix 0..703 -> (insert_code, copy_code).

    RFC 7932 section 5 command code table (blocks of 64), as arithmetic.
    """
    sym = sym.astype(I32)
    low_ins = (sym >> 3) & 7
    low_cpy = sym & 7
    # sym < 128: implicit-distance block
    ins_lt = low_ins
    cpy_lt = low_cpy + jnp.where(sym >= 64, 8, 0)
    # sym >= 128: cell (sym>>6)-2 in 0..8
    cell = jnp.clip((sym >> 6) - 2, 0, 8)
    # ins_high by cell: [0,0,1,1,0,2,1,2,2]; cpy_high: [0,1,0,1,2,0,2,1,2]
    # packed as per-bit masks indexed by cell
    ins_hi = ((76 >> cell) & 1) | (((416 >> cell) & 1) << 1)
    cpy_hi = ((138 >> cell) & 1) | (((336 >> cell) & 1) << 1)
    ins_ge = (ins_hi << 3) | low_ins
    cpy_ge = (cpy_hi << 3) | low_cpy
    lt = sym < 128
    return jnp.where(lt, ins_lt, ins_ge), jnp.where(lt, cpy_lt, cpy_ge)
