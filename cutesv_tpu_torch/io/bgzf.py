"""BGZF (blocked gzip) reader/writer.

BGZF is the container format of BAM: a sequence of independent gzip members,
each at most 64 KiB uncompressed, carrying the compressed block size in a
``BC`` extra subfield so blocks can be located without inflating. The file
ends with a fixed 28-byte empty block (EOF marker).

This mirrors what htslib's ``bgzf.c`` provides for the reference caller via
pysam (reference touchpoints: cuteSV:686,709,1013). Pure Python + zlib; the
C++ decoder in ``native/`` has its own multithreaded implementation.
"""
from __future__ import annotations

import io
import struct
import zlib

# Fixed EOF marker block (empty payload), from the SAM spec appendix.
BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")

_HDR = struct.Struct("<4BI2BH")  # magic(2) CM FLG MTIME XFL OS XLEN


def _read_block(fh) -> bytes | None:
    """Read one BGZF block from ``fh``; returns inflated bytes or None at EOF."""
    head = fh.read(12)
    if len(head) == 0:
        return None
    if len(head) < 12:
        raise ValueError("truncated BGZF block header")
    magic1, magic2, method, flags, _mtime, _xfl, _os, xlen = _HDR.unpack(head)
    if (magic1, magic2) != (0x1F, 0x8B) or method != 8 or not flags & 4:
        raise ValueError("not a BGZF block (bad gzip header)")
    extra = fh.read(xlen)
    if len(extra) < xlen:
        raise ValueError("truncated BGZF extra field")
    bsize = None
    off = 0
    while off + 4 <= xlen:
        si1, si2, slen = extra[off], extra[off + 1], int.from_bytes(
            extra[off + 2:off + 4], "little")
        if si1 == 66 and si2 == 67 and slen == 2:  # 'B','C'
            bsize = int.from_bytes(extra[off + 4:off + 6], "little")
        off += 4 + slen
    if bsize is None:
        raise ValueError("gzip block without BC subfield: not BGZF")
    cdata_len = bsize + 1 - 12 - xlen - 8
    if cdata_len < 0:
        # a crafted/corrupt BSIZE would make fh.read(negative) slurp the
        # whole remaining file into memory before failing downstream
        raise ValueError("invalid BGZF BSIZE (underflow)")
    cdata = fh.read(cdata_len)
    tail = fh.read(8)
    if len(cdata) < cdata_len or len(tail) < 8:
        raise ValueError("truncated BGZF block")
    crc, isize = struct.unpack("<II", tail)
    data = zlib.decompress(cdata, wbits=-15)
    if len(data) != isize:
        raise ValueError("BGZF ISIZE mismatch")
    if zlib.crc32(data) != crc:
        raise ValueError("BGZF CRC mismatch")
    return data


class BgzfReader(io.RawIOBase):
    """Streaming reader exposing the concatenated inflated payload."""

    def __init__(self, path_or_fh):
        if isinstance(path_or_fh, (str, bytes)):
            self._fh = open(path_or_fh, "rb")
            self._owns = True
        else:
            self._fh = path_or_fh
            self._owns = False
        self._buf = b""
        self._pos = 0  # position inside _buf

    def readable(self):
        return True

    def _fill(self) -> bool:
        while self._pos >= len(self._buf):
            block = _read_block(self._fh)
            if block is None:
                return False
            self._buf = block
            self._pos = 0
        return True

    def read(self, n=-1) -> bytes:
        if n is None or n < 0:
            chunks = [self._buf[self._pos:]]
            self._buf = b""
            self._pos = 0
            while True:
                block = _read_block(self._fh)
                if block is None:
                    break
                chunks.append(block)
            return b"".join(chunks)
        out = bytearray()
        while len(out) < n:
            if not self._fill():
                break
            take = min(n - len(out), len(self._buf) - self._pos)
            out += self._buf[self._pos:self._pos + take]
            self._pos += take
        return bytes(out)

    def read_exact(self, n: int) -> bytes:
        data = self.read(n)
        if len(data) != n:
            raise EOFError("unexpected EOF inside BGZF payload")
        return data

    def at_eof(self) -> bool:
        return not self._fill()

    def close(self):
        if self._owns:
            self._fh.close()
        super().close()


class BgzfWriter(io.RawIOBase):
    """Writer producing spec-compliant BGZF (used by the test BAM writer)."""

    MAX_BLOCK = 0xFF00  # uncompressed payload per block, htslib default

    def __init__(self, path_or_fh, level: int = 6):
        if isinstance(path_or_fh, (str, bytes)):
            self._fh = open(path_or_fh, "wb")
            self._owns = True
        else:
            self._fh = path_or_fh
            self._owns = False
        self._level = level
        self._buf = bytearray()

    def writable(self):
        return True

    def write(self, data: bytes) -> int:
        self._buf += data
        while len(self._buf) >= self.MAX_BLOCK:
            self._flush_block(self._buf[:self.MAX_BLOCK])
            del self._buf[:self.MAX_BLOCK]
        return len(data)

    def _flush_block(self, payload: bytes):
        co = zlib.compressobj(self._level, zlib.DEFLATED, -15)
        cdata = co.compress(payload) + co.flush()
        bsize = len(cdata) + 25  # 12 hdr + 6 extra + 8 tail - 1
        block = (
            b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff"
            + b"\x06\x00BC\x02\x00"
            + struct.pack("<H", bsize)
            + cdata
            + struct.pack("<II", zlib.crc32(payload), len(payload))
        )
        self._fh.write(block)

    def close(self):
        if self.closed:
            return
        if self._buf:
            self._flush_block(bytes(self._buf))
            self._buf.clear()
        self._fh.write(BGZF_EOF)
        if self._owns:
            self._fh.close()
        super().close()


def scan_block_table(path: str):
    """Chain-scan BGZF block headers (payloads skipped): returns
    (offsets, isizes) int64 arrays — each block's compressed file offset
    and uncompressed size. This is the shared, communication-free basis
    for sharded decode: every process scans the same file and derives
    identical block-aligned byte ranges (the BGZF BSIZE chain is
    deterministic). The C++ decoder's mmap scanner
    (``io/native.py::scan_bgzf_native``) handles regular files; it
    returns None for a non-regular file or malformed input, which the
    Python loop below then scans: the loop owns the designed
    malformed-input errors. A decoder that fails to build raises.
    """
    import numpy as np

    from cutesv_tpu_torch.io.native import scan_bgzf_native

    got = scan_bgzf_native(path)
    if got is not None:
        return got
    offs: list = []
    isizes: list = []
    with open(path, "rb") as fh:
        fh.seek(0, 2)
        fsize = fh.tell()
        off = 0
        while off < fsize:
            fh.seek(off)
            hdr = fh.read(12)
            if len(hdr) < 12 or hdr[:2] != b"\x1f\x8b":
                raise ValueError("not BGZF data at offset %d in %s"
                                 % (off, path))
            xlen = hdr[10] | (hdr[11] << 8)
            extra = fh.read(xlen)
            if len(extra) != xlen:
                raise ValueError("truncated BGZF header in %s" % path)
            bsize = None
            o = 0
            while o + 4 <= xlen:
                slen = extra[o + 2] | (extra[o + 3] << 8)
                if (extra[o] == 66 and extra[o + 1] == 67 and slen == 2
                        and o + 6 <= xlen):
                    bsize = extra[o + 4] | (extra[o + 5] << 8)
                if o + 4 + slen > xlen:
                    break
                o += 4 + slen
            if bsize is None:
                raise ValueError("BGZF block without BSIZE in %s" % path)
            total = bsize + 1
            if off + total > fsize:
                raise ValueError("truncated BGZF block in %s" % path)
            fh.seek(off + total - 4)
            isize = int.from_bytes(fh.read(4), "little")
            if isize > 65536:
                # BGZF caps a block's inflated size at 64 KiB; the
                # decoders reject such footers too
                raise ValueError("implausible BGZF isize at offset %d "
                                 "in %s" % (off, path))
            offs.append(off)
            isizes.append(isize)
            off += total
    return (np.asarray(offs, np.int64), np.asarray(isizes, np.int64))
