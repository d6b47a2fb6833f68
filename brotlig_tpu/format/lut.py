"""RFC 7932 command/length/distance code tables, generated from spec math.

The Brotli-G command model is plain Brotli (RFC 7932 section 5) plus a
sentinel symbol (704) and 23 insert-only tail codes (705..727). The reference
ships these as a literal LUT (inc/common/BrotligCommandLut.h); here every
table is derived programmatically from the spec formulas so that the encoder,
the refimpl decoder and the device kernels all share one generated source.
"""
from __future__ import annotations

import numpy as np

from . import constants as C

# --- Insert / copy length code tables (RFC 7932 section 5) -----------------
INSERT_BASE = np.array(
    [0, 1, 2, 3, 4, 5, 6, 8, 10, 14, 18, 26, 34, 50, 66, 98, 130, 194, 322,
     578, 1090, 2114, 6210, 22594], dtype=np.int32)
INSERT_EXTRA = np.array(
    [0, 0, 0, 0, 0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6, 7, 8, 9, 10, 12, 14,
     24], dtype=np.int32)
COPY_BASE = np.array(
    [2, 3, 4, 5, 6, 7, 8, 9, 10, 12, 14, 18, 22, 30, 38, 54, 70, 102, 134,
     198, 326, 582, 1094, 2118], dtype=np.int32)
COPY_EXTRA = np.array(
    [0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6, 7, 8, 9, 10,
     24], dtype=np.int32)


def get_insert_length_code(insert_len: int) -> int:
    """Insert length -> code 0..23 (ref semantics: BrotligCommand.h:110-131)."""
    if insert_len < 6:
        return insert_len
    if insert_len < 130:
        nbits = (insert_len - 2).bit_length() - 2
        return (nbits << 1) + ((insert_len - 2) >> nbits) + 2
    if insert_len < 2114:
        return (insert_len - 66).bit_length() + 9
    if insert_len < 6210:
        return 21
    if insert_len < 22594:
        return 22
    return 23


def get_copy_length_code(copy_len: int) -> int:
    """Copy length -> code 0..23 (ref semantics: BrotligCommand.h:133-150)."""
    if copy_len == 0:
        return 0
    if copy_len < 10:
        return copy_len - 2
    if copy_len < 134:
        nbits = (copy_len - 6).bit_length() - 2
        return (nbits << 1) + ((copy_len - 6) >> nbits) + 4
    if copy_len < 2118:
        return (copy_len - 70).bit_length() + 11
    return 23


def combine_length_codes(inscode: int, copycode: int,
                         use_last_distance: bool) -> int:
    """Insert code x copy code -> command prefix (RFC 7932 section 5)."""
    bits64 = (copycode & 0x7) | ((inscode & 0x7) << 3)
    if use_last_distance and inscode < 8 and copycode < 16:
        return bits64 if copycode < 8 else (bits64 | 64)
    offset = 2 * ((copycode >> 3) + 3 * (inscode >> 3))
    offset = (offset << 5) + 0x40 + ((0x520D40 >> offset) & 0xC0)
    return offset | bits64


def _build_cmd_lut():
    """Invert combine_length_codes over the full 704-code alphabet.

    Produces, for each command prefix 0..704 (704 = sentinel):
      insert_code, copy_code, implicit_distance (cmd < 128 reuses last dist).
    Entry 704 carries zeros so that (insert_base==0 and copy_base==0)
    uniquely flags the sentinel, as in the reference decoder
    (PageDecoder.cpp:296-307).
    """
    n = C.NUM_COMMAND_SYMBOLS_WITH_SENTINEL
    ins_code = np.zeros(n, dtype=np.int32)
    cpy_code = np.zeros(n, dtype=np.int32)
    seen = np.zeros(n, dtype=bool)
    for ic in range(24):
        for cc in range(24):
            for use_last in (False, True):
                cmd = combine_length_codes(ic, cc, use_last)
                want_last = use_last and ic < 8 and cc < 16
                if (cmd < 128) != want_last:
                    continue
                if seen[cmd]:
                    assert ins_code[cmd] == ic and cpy_code[cmd] == cc
                    continue
                seen[cmd] = True
                ins_code[cmd] = ic
                cpy_code[cmd] = cc
    assert seen[:C.NUM_COMMAND_SYMBOLS].all(), "command code space not covered"
    return ins_code, cpy_code


CMD_INSERT_CODE, CMD_COPY_CODE = _build_cmd_lut()

# Flattened per-command tables used by decoders. Sentinel row (704) is zeros.
CMD_INSERT_BASE = INSERT_BASE[CMD_INSERT_CODE].copy()
CMD_INSERT_EXTRA = INSERT_EXTRA[CMD_INSERT_CODE].copy()
CMD_COPY_BASE = COPY_BASE[CMD_COPY_CODE].copy()
CMD_COPY_EXTRA = COPY_EXTRA[CMD_COPY_CODE].copy()
CMD_INSERT_BASE[C.SENTINEL_COMMAND] = 0
CMD_INSERT_EXTRA[C.SENTINEL_COMMAND] = 0
CMD_COPY_BASE[C.SENTINEL_COMMAND] = 0
CMD_COPY_EXTRA[C.SENTINEL_COMMAND] = 0


def distance_context(cmd_prefix: int) -> int:
    """Distance context 0..3 of a command (ref: BrotligCommand.h:88-96)."""
    r = cmd_prefix >> 6
    c = cmd_prefix & 7
    if r in (0, 2, 4, 7) and c <= 2:
        return c
    return 3


# --- Distance prefix coding -------------------------------------------------

def encode_distance(dist: int, npostfix: int, ndirect: int):
    """Distance -> (symbol >= 16, num_extra_bits, extra_bits_value).

    Inverse of the decoder's long-code formula (PageDecoder.cpp:367-393).
    `dist` must be > 0 and not representable as a short code the caller
    wanted; direct codes cover dist <= ndirect.
    """
    if 0 < dist <= ndirect:
        return 16 + dist - 1, 0, 0
    d = dist - ndirect - 1
    postfix = d & ((1 << npostfix) - 1)
    hval = d >> npostfix
    nbits = (hval + 4).bit_length() - 2
    b = ((hval + 4) >> nbits) & 1
    extra = hval + 4 - ((2 + b) << nbits)
    assert 0 <= extra < (1 << nbits)
    symbol = 16 + ndirect + (((2 * (nbits - 1) + b) << npostfix) | postfix)
    return symbol, nbits, extra


def decode_distance_symbol(symbol: int, extra: int, npostfix: int,
                           ndirect: int) -> int:
    """Long/direct distance symbol (+extra) -> distance.

    Mirrors PageDecoder.cpp:367-393; symbol must be >= 16.
    """
    if ndirect > 0 and symbol < 16 + ndirect:
        return symbol - 15
    s = symbol - ndirect - 16
    nbits = 1 + (s >> (npostfix + 1))
    hcode = s >> npostfix
    lcode = s & ((1 << npostfix) - 1)
    offset = ((2 + (hcode & 1)) << nbits) - 4
    return ((offset + extra) << npostfix) + lcode + ndirect + 1


def distance_symbol_extra_bits(symbol: int, npostfix: int, ndirect: int) -> int:
    """Number of extra bits following a distance symbol (0 for short/direct)."""
    if symbol < 16 + ndirect:
        return 0
    return 1 + ((symbol - ndirect - 16) >> (npostfix + 1))
