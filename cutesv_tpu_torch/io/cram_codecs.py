"""CRAM 3.0 primitive codecs: ITF8/LTF8 varints and the rANS 4x8 entropy
codec (order-0 and order-1), implemented from the CRAM 3.0 specification.

The rANS variant is the spec's static arithmetic coder: 12-bit
frequencies normalized to 4096, four interleaved states, lower renorm
bound 2^23, byte-wise renormalization.
"""
from __future__ import annotations

import struct
from typing import List, Tuple

# ---------------------------------------------------------------------------
# varints
# ---------------------------------------------------------------------------


def read_itf8(buf: bytes, off: int) -> Tuple[int, int]:
    b0 = buf[off]
    if b0 < 0x80:
        return b0, off + 1
    if b0 < 0xC0:
        return ((b0 & 0x3F) << 8) | buf[off + 1], off + 2
    if b0 < 0xE0:
        return (((b0 & 0x1F) << 16) | (buf[off + 1] << 8)
                | buf[off + 2]), off + 3
    if b0 < 0xF0:
        return (((b0 & 0x0F) << 24) | (buf[off + 1] << 16)
                | (buf[off + 2] << 8) | buf[off + 3]), off + 4
    val = (((b0 & 0x0F) << 28) | (buf[off + 1] << 20)
           | (buf[off + 2] << 12) | (buf[off + 3] << 4)
           | (buf[off + 4] & 0x0F))
    # values are signed 32-bit
    if val >= 1 << 31:
        val -= 1 << 32
    return val, off + 5


def write_itf8(value: int) -> bytes:
    value &= 0xFFFFFFFF
    if value < 0x80:
        return bytes([value])
    if value < 0x4000:
        return bytes([0x80 | (value >> 8), value & 0xFF])
    if value < 0x200000:
        return bytes([0xC0 | (value >> 16), (value >> 8) & 0xFF,
                      value & 0xFF])
    if value < 0x10000000:
        return bytes([0xE0 | (value >> 24), (value >> 16) & 0xFF,
                      (value >> 8) & 0xFF, value & 0xFF])
    return bytes([0xF0 | ((value >> 28) & 0x0F), (value >> 20) & 0xFF,
                  (value >> 12) & 0xFF, (value >> 4) & 0xFF, value & 0x0F])


def read_ltf8(buf: bytes, off: int) -> Tuple[int, int]:
    b0 = buf[off]
    n_extra = 0
    mask = 0x80
    while n_extra < 8 and (b0 & mask):
        n_extra += 1
        mask >>= 1
    if n_extra == 0:
        return b0, off + 1
    if n_extra == 8:
        val = int.from_bytes(buf[off + 1:off + 9], "big")
        return val, off + 9
    prefix_bits = b0 & (0xFF >> (n_extra + 1))
    val = prefix_bits
    for k in range(n_extra):
        val = (val << 8) | buf[off + 1 + k]
    return val, off + 1 + n_extra


def write_ltf8(value: int) -> bytes:
    if value < 0x80:
        return bytes([value])
    for n_extra in range(1, 8):
        bits = 7 * (n_extra + 1)  # prefix bits shrink as extras grow
        prefix_bits = 7 - n_extra
        if value < (1 << (prefix_bits + 8 * n_extra)):
            head = (0xFF << (8 - n_extra)) & 0xFF
            head |= value >> (8 * n_extra)
            body = [(value >> (8 * k)) & 0xFF
                    for k in range(n_extra - 1, -1, -1)]
            return bytes([head] + body)
    return bytes([0xFF]) + value.to_bytes(8, "big")


# ---------------------------------------------------------------------------
# rANS 4x8
# ---------------------------------------------------------------------------

TOTFREQ = 4096
RANS_LOW = 1 << 23


def _normalize_freqs(counts: List[int]) -> List[int]:
    total = sum(counts)
    if total == 0:
        return counts
    freqs = [0] * 256
    # scale to TOTFREQ keeping every present symbol >= 1
    acc = 0
    for s in range(256):
        if counts[s]:
            f = max(1, counts[s] * TOTFREQ // total)
            freqs[s] = f
            acc += f
    # fix rounding drift on the most frequent symbol
    if acc != TOTFREQ:
        top = max(range(256), key=lambda s: freqs[s])
        freqs[top] += TOTFREQ - acc
        assert freqs[top] > 0
    return freqs


def _write_freq_table(freqs: List[int]) -> bytes:
    """Spec RLE: symbol byte, then itf8 freq; ascending runs compress as
    (sym, run_len)."""
    out = bytearray()
    syms = [s for s in range(256) if freqs[s] > 0]
    i = 0
    while i < len(syms):
        run = 0
        while (i + run + 1 < len(syms)
               and syms[i + run + 1] == syms[i + run] + 1):
            run += 1
        out.append(syms[i])
        out += write_itf8(freqs[syms[i]])
        if run >= 1:
            # a consecutive group encodes as: first sym+freq, then the
            # second symbol byte (== first+1) acting as the run marker,
            # a count of symbols after the second, then bare frequencies
            out.append(syms[i] + 1)
            out.append(run - 1)
            for k in range(1, run + 1):
                out += write_itf8(freqs[syms[i + k]])
            i += run + 1
        else:
            i += 1
    out.append(0)
    return bytes(out)


def _read_freq_table(buf: bytes, off: int):
    freqs = [0] * 256
    rle = 0
    sym = buf[off]
    off += 1
    while True:
        f, off = read_itf8(buf, off)
        freqs[sym] = f
        if rle > 0:
            rle -= 1
            sym += 1
        else:
            nxt = buf[off]
            off += 1
            if nxt == sym + 1:
                rle = buf[off]
                off += 1
                sym = nxt
            else:
                sym = nxt
        if sym == 0 and rle == 0:
            break
    return freqs, off


def _cumulative(freqs: List[int]) -> List[int]:
    cum = [0] * 257
    for s in range(256):
        cum[s + 1] = cum[s] + freqs[s]
    return cum


def _sym_lookup(freqs: List[int]):
    cum = _cumulative(freqs)
    table = bytearray(TOTFREQ)
    for s in range(256):
        for k in range(cum[s], cum[s + 1]):
            table[k] = s
    return cum, bytes(table)


def rans_encode_o0(data: bytes) -> bytes:
    counts = [0] * 256
    for b in data:
        counts[b] += 1
    if not data:
        return b"\x00" + struct.pack("<II", 0, 0)
    freqs = _normalize_freqs(counts)
    cum = _cumulative(freqs)
    states = [RANS_LOW] * 4
    out_rev = bytearray()
    # encode in reverse, interleaving states round-robin by index
    for i in range(len(data) - 1, -1, -1):
        k = i & 3
        s = data[i]
        f = freqs[s]
        x = states[k]
        x_max = ((RANS_LOW >> 12) << 8) * f
        while x >= x_max:
            out_rev.append(x & 0xFF)
            x >>= 8
        states[k] = (x // f) * TOTFREQ + (x % f) + cum[s]
    head = bytearray()
    for k in range(4):
        head += struct.pack("<I", states[k])
    comp = bytes(head) + bytes(reversed(out_rev))
    table = _write_freq_table(freqs)
    payload = table + comp
    return b"\x00" + struct.pack("<II", len(payload), len(data)) + payload


def _check_rans_raw_len(raw_len: int, n: int):
    # a 4-state 12-bit rANS stream cannot emit more than ~22.7k bytes per
    # input byte plus ~365k from the initial states; a crafted raw_len
    # above that would allocate GiBs and spin ~4e9 loop iterations
    if raw_len > n * 23000 + 500000:
        raise ValueError("rANS raw length implausible for payload size")


def rans_decode_o0(buf: bytes):
    order = buf[0]
    assert order == 0
    comp_len, raw_len = struct.unpack_from("<II", buf, 1)
    _check_rans_raw_len(raw_len, len(buf))
    if raw_len == 0:
        return b""
    off = 9
    freqs, off = _read_freq_table(buf, off)
    cum, table = _sym_lookup(freqs)
    states = list(struct.unpack_from("<4I", buf, off))
    off += 16
    out = bytearray(raw_len)
    n = len(buf)
    for i in range(raw_len):
        k = i & 3
        x = states[k]
        m = x & (TOTFREQ - 1)
        s = table[m]
        out[i] = s
        x = freqs[s] * (x >> 12) + m - cum[s]
        while x < RANS_LOW and off < n:
            x = (x << 8) | buf[off]
            off += 1
        states[k] = x
    return bytes(out)


def rans_encode_o1(data: bytes) -> bytes:
    """Order-1: four states each encode one contiguous quarter with a
    per-state last-symbol context (context of the first byte of each
    quarter is 0)."""
    if len(data) < 4:
        # tiny inputs fall back to order-0 container (spec allows either)
        return rans_encode_o0(data)
    counts = [[0] * 256 for _ in range(256)]
    n = len(data)
    q = n >> 2
    starts = [0, q, 2 * q, 3 * q]
    for k in range(4):
        last = 0
        end = starts[k + 1] if k < 3 else n
        for i in range(starts[k], end):
            counts[last][data[i]] += 1
            last = data[i]
    freqs = [None] * 256
    cums = [None] * 256
    for c in range(256):
        if sum(counts[c]):
            freqs[c] = _normalize_freqs(counts[c])
            cums[c] = _cumulative(freqs[c])
    states = [RANS_LOW] * 4

    out_rev = bytearray()

    def push(k, ctx, s):
        f = freqs[ctx][s]
        x = states[k]
        x_max = ((RANS_LOW >> 12) << 8) * f
        while x >= x_max:
            out_rev.append(x & 0xFF)
            x >>= 8
        states[k] = (x // f) * TOTFREQ + (x % f) + cums[ctx][s]

    # Renorm bytes must appear in the exact reverse of the decoder's
    # consumption order: the decoder runs lockstep steps (k=0..3 per step)
    # over the quarters, then state 3 finishes the tail. So encode the
    # tail backwards first, then steps in reverse with k=3..0.
    for i in range(n - 1, starts[3] + q - 1, -1):
        push(3, data[i - 1] if i > starts[3] else 0, data[i])
    for step in range(q - 1, -1, -1):
        for k in range(3, -1, -1):
            i = starts[k] + step
            ctx = data[i - 1] if i > starts[k] else 0
            push(k, ctx, data[i])
    head = b"".join(struct.pack("<I", states[k]) for k in range(4))
    comp = head + bytes(reversed(out_rev))
    # tables: outer RLE over contexts, inner order-0 table per context
    table = bytearray()
    ctxs = [c for c in range(256) if freqs[c] is not None]
    i = 0
    while i < len(ctxs):
        run = 0
        while (i + run + 1 < len(ctxs)
               and ctxs[i + run + 1] == ctxs[i + run] + 1):
            run += 1
        table.append(ctxs[i])
        table += _write_freq_table(freqs[ctxs[i]])
        if run >= 1:
            table.append(ctxs[i] + 1)
            table.append(run - 1)
            for k2 in range(1, run + 1):
                table += _write_freq_table(freqs[ctxs[i + k2]])
            i += run + 1
        else:
            i += 1
    table.append(0)
    payload = bytes(table) + comp
    return b"\x01" + struct.pack("<II", len(payload), len(data)) + payload


def rans_decode_o1(buf: bytes):
    order = buf[0]
    if order == 0:
        return rans_decode_o0(buf)
    comp_len, raw_len = struct.unpack_from("<II", buf, 1)
    _check_rans_raw_len(raw_len, len(buf))
    if raw_len == 0:
        return b""
    off = 9
    freqs = [None] * 256
    lookups = [None] * 256
    rle = 0
    ctx = buf[off]
    off += 1
    while True:
        f, off = _read_freq_table(buf, off)
        freqs[ctx] = f
        lookups[ctx] = _sym_lookup(f)
        if rle > 0:
            rle -= 1
            ctx += 1
        else:
            nxt = buf[off]
            off += 1
            if nxt == ctx + 1:
                rle = buf[off]
                off += 1
                ctx = nxt
            else:
                ctx = nxt
        if ctx == 0 and rle == 0:
            break
    states = list(struct.unpack_from("<4I", buf, off))
    off += 16
    n_buf = len(buf)
    out = bytearray(raw_len)
    q = raw_len >> 2
    starts = [0, q, 2 * q, 3 * q, raw_len]
    lasts = [0, 0, 0, 0]
    ptr = [starts[k] for k in range(4)]
    # decode interleaved: advance each state over its quarter in lockstep
    for step in range(q):
        for k in range(4):
            i = starts[k] + step
            x = states[k]
            m = x & (TOTFREQ - 1)
            cum, table = lookups[lasts[k]]
            s = table[m]
            out[i] = s
            x = freqs[lasts[k]][s] * (x >> 12) + m - cum[s]
            while x < RANS_LOW and off < n_buf:
                x = (x << 8) | buf[off]
                off += 1
            states[k] = x
            lasts[k] = s
    # tail (raw_len % 4) handled by state 3
    for i in range(starts[3] + q, raw_len):
        x = states[3]
        m = x & (TOTFREQ - 1)
        cum, table = lookups[lasts[3]]
        s = table[m]
        out[i] = s
        x = freqs[lasts[3]][s] * (x >> 12) + m - cum[s]
        while x < RANS_LOW and off < n_buf:
            x = (x << 8) | buf[off]
            off += 1
        states[3] = x
        lasts[3] = s
    return bytes(out)


def rans_decode(buf: bytes) -> bytes:
    return rans_decode_o0(buf) if buf[0] == 0 else rans_decode_o1(buf)
