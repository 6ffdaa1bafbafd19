"""BAM container reader/writer (pure Python).

Implements the BAM v1 encoding from the SAM specification. The reader is a
single streaming pass — the engine's design does not need random access
(the reference caller fetches per-interval because of its multiprocessing
layout, cuteSV:709; we stream once and shard downstream on device).

The writer exists to build test fixtures and synthetic benchmarks, since the
environment has no samtools/pysam.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from cutesv_tpu_torch.io.bgzf import BgzfReader, BgzfWriter

# packed-byte -> hi/lo nibble ASCII luts (vectorized SEQ decode); and
# char -> nt16 code for the writer
_NT16_ASCII = np.frombuffer(b"=ACMGRSVTWYHKDBN", np.uint8)
_HI_CHAR = _NT16_ASCII[np.arange(256) >> 4]
_LO_CHAR = _NT16_ASCII[np.arange(256) & 0xF]
_CHAR_TO_CODE = np.full(256, 15, np.uint8)
for _i, _c in enumerate("=ACMGRSVTWYHKDBN"):
    _CHAR_TO_CODE[ord(_c)] = _i
    _CHAR_TO_CODE[ord(_c.lower())] = _i

BAM_MAGIC = b"BAM\x01"

CIGAR_OPS = "MIDNSHP=X"
_SEQ_NT16 = "=ACMGRSVTWYHKDBN"
_NT16_CODE = {c: i for i, c in enumerate(_SEQ_NT16)}
# ops consuming query / reference (SAM spec table)
CONSUMES_QUERY = (True, True, False, False, True, False, False, True, True)
CONSUMES_REF = (True, False, True, True, False, False, False, True, True)

FUNMAP = 0x4
FREVERSE = 0x10
FSECONDARY = 0x100
FSUPPLEMENTARY = 0x800


@dataclass
class BamRecord:
    qname: str
    flag: int
    ref_id: int
    pos: int                       # 0-based leftmost
    mapq: int
    cigar: List[Tuple[int, int]]   # [(op, length)] op in 0..8
    seq: str
    tags: dict

    @property
    def is_unmapped(self) -> bool:
        return bool(self.flag & FUNMAP) or self.ref_id < 0

    @property
    def query_length(self) -> int:
        """Length of SEQ (pysam read.query_length semantics)."""
        return len(self.seq)

    @property
    def reference_end(self) -> int:
        end = self.pos
        for op, ln in self.cigar:
            if CONSUMES_REF[op]:
                end += ln
        return end


def _parse_tags(buf: bytes) -> dict:
    tags = {}
    i = 0
    n = len(buf)
    int_fmt = {ord("c"): "<b", ord("C"): "<B", ord("s"): "<h",
               ord("S"): "<H", ord("i"): "<i", ord("I"): "<I"}
    int_size = {ord("c"): 1, ord("C"): 1, ord("s"): 2,
                ord("S"): 2, ord("i"): 4, ord("I"): 4}
    while i + 3 <= n:
        tag = buf[i:i + 2].decode("ascii")
        vt = buf[i + 2]
        i += 3
        if vt in int_fmt:
            tags[tag] = struct.unpack_from(int_fmt[vt], buf, i)[0]
            i += int_size[vt]
        elif vt == ord("f"):
            tags[tag] = struct.unpack_from("<f", buf, i)[0]
            i += 4
        elif vt == ord("A"):
            tags[tag] = chr(buf[i])
            i += 1
        elif vt in (ord("Z"), ord("H")):
            j = buf.index(0, i)
            tags[tag] = buf[i:j].decode("ascii")
            i = j + 1
        elif vt == ord("B"):
            sub = buf[i]
            cnt = struct.unpack_from("<I", buf, i + 1)[0]
            i += 5
            size = int_size.get(sub, 4)
            fmt = int_fmt.get(sub, "<f")
            vals = [struct.unpack_from(fmt, buf, i + k * size)[0]
                    for k in range(cnt)]
            tags[tag] = vals
            i += cnt * size
        else:
            raise ValueError("unknown BAM tag type %r" % chr(vt))
    return tags


class BamReader:
    """Streaming BAM reader.

    Attributes:
        references: list of (name, length) in header order.
    """

    def __init__(self, path):
        if isinstance(path, (str, bytes)):
            with open(path, "rb") as probe:
                head = probe.read(4)
            if head == b"CRAM":
                raise ValueError(
                    "CRAM input is not supported yet; convert with "
                    "'samtools view -b -T ref.fa in.cram -o in.bam'")
        self._bgzf = BgzfReader(path)
        magic = self._bgzf.read_exact(4)
        if magic != BAM_MAGIC:
            raise ValueError("not a BAM file (bad magic)")
        (l_text,) = struct.unpack("<i", self._bgzf.read_exact(4))
        self.header_text = self._bgzf.read_exact(l_text).decode(
            "utf-8", "replace")
        (n_ref,) = struct.unpack("<i", self._bgzf.read_exact(4))
        refs = []
        for _ in range(n_ref):
            (l_name,) = struct.unpack("<i", self._bgzf.read_exact(4))
            name = self._bgzf.read_exact(l_name)[:-1].decode("ascii")
            (l_ref,) = struct.unpack("<i", self._bgzf.read_exact(4))
            refs.append((name, l_ref))
        self.references = refs

    def __iter__(self) -> Iterator[BamRecord]:
        read = self._bgzf.read
        while True:
            head = read(4)
            if len(head) == 0:
                return
            if len(head) < 4:
                raise EOFError("truncated BAM record")
            (block_size,) = struct.unpack("<i", head)
            buf = self._bgzf.read_exact(block_size)
            yield self._parse_record(buf)

    @staticmethod
    def _parse_record(buf: bytes) -> BamRecord:
        (ref_id, pos, l_qname, mapq, _bin, n_cigar, flag, l_seq,
         _next_ref, _next_pos, _tlen) = struct.unpack_from("<iiBBHHHiiii", buf)
        off = 32
        qname = buf[off:off + l_qname - 1].decode("ascii")
        off += l_qname
        cigar = []
        for k in range(n_cigar):
            (v,) = struct.unpack_from("<I", buf, off + 4 * k)
            cigar.append((v & 0xF, v >> 4))
        off += 4 * n_cigar
        nbytes = (l_seq + 1) // 2
        packed = np.frombuffer(buf, np.uint8, nbytes, off)
        chars = np.empty(nbytes * 2, np.uint8)
        chars[0::2] = _HI_CHAR[packed]
        chars[1::2] = _LO_CHAR[packed]
        seq = chars.tobytes()[:l_seq].decode("ascii")
        off += nbytes + l_seq  # skip qual
        tags = _parse_tags(buf[off:])
        # long-CIGAR convention (SAM spec 4.2.2): records whose real CIGAR
        # has >65535 ops carry the sentinel ``<l_seq>S<ref_len>N`` in the
        # CIGAR field and the true ops in a CG:B,I tag (htslib writes and
        # transparently rewrites these; ultralong ONT reads hit it)
        if (len(cigar) == 2 and cigar[0] == (4, l_seq) and cigar[1][0] == 3
                and isinstance(tags.get("CG"), list) and tags["CG"]):
            cigar = [(v & 0xF, v >> 4) for v in tags["CG"]]
        return BamRecord(qname=qname, flag=flag, ref_id=ref_id, pos=pos,
                         mapq=mapq, cigar=cigar, seq=seq, tags=tags)

    def close(self):
        self._bgzf.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _reg2bin(beg: int, end: int) -> int:
    """UCSC binning (SAM spec section 5.3)."""
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


class BamWriter:
    """Minimal BAM writer for fixtures/benchmarks.

    ``references`` is a list of (name, length). Records must be appended in
    coordinate-sorted order if downstream consumers assume sorting (ours do).
    """

    def __init__(self, path, references: Sequence[Tuple[str, int]],
                 extra_header: str = ""):
        self._bgzf = BgzfWriter(path)
        self.references = list(references)
        header = "@HD\tVN:1.6\tSO:coordinate\n"
        for name, length in self.references:
            header += "@SQ\tSN:%s\tLN:%d\n" % (name, length)
        header += extra_header
        htext = header.encode()
        out = bytearray()
        out += BAM_MAGIC
        out += struct.pack("<i", len(htext))
        out += htext
        out += struct.pack("<i", len(self.references))
        for name, length in self.references:
            nb = name.encode() + b"\x00"
            out += struct.pack("<i", len(nb)) + nb + struct.pack("<i", length)
        self._bgzf.write(bytes(out))

    def write(self, qname: str, flag: int, ref_id: int, pos: int, mapq: int,
              cigar: Sequence[Tuple[int, int]], seq: str,
              tags: Optional[dict] = None):
        qb = qname.encode() + b"\x00"
        rec = bytearray()
        end = pos
        for op, ln in cigar:
            if CONSUMES_REF[op]:
                end += ln
        stored = list(cigar)
        if len(stored) > 65535:
            # long-CIGAR convention (SAM spec 4.2.2): sentinel
            # ``<l_seq>S<ref_len>N`` in the CIGAR field, real ops in CG:B,I
            tags = dict(tags or {})
            tags["CG"] = [(ln << 4) | op for op, ln in cigar]
            stored = [(4, len(seq)), (3, end - pos)]
        rec += struct.pack("<iiBBHHHiiii", ref_id, pos, len(qb), mapq,
                           _reg2bin(pos, max(end, pos + 1)), len(stored),
                           flag, len(seq), -1, -1, 0)
        rec += qb
        for op, ln in stored:
            rec += struct.pack("<I", (ln << 4) | op)
        codes = _CHAR_TO_CODE[np.frombuffer(seq.encode("ascii"), np.uint8)]
        if len(codes) & 1:
            codes = np.concatenate([codes, np.zeros(1, np.uint8)])
        packed = (codes[0::2] << 4) | codes[1::2]
        rec += packed.tobytes()
        rec += b"\xff" * len(seq)  # qual: 0xFF = unavailable
        for tag, val in (tags or {}).items():
            tb = tag.encode()
            if isinstance(val, str):
                rec += tb + b"Z" + val.encode() + b"\x00"
            elif isinstance(val, int):
                rec += tb + b"i" + struct.pack("<i", val)
            elif isinstance(val, float):
                rec += tb + b"f" + struct.pack("<f", val)
            elif isinstance(val, (list, tuple)):  # B,I array (e.g. CG)
                rec += tb + b"BI" + struct.pack("<I", len(val))
                rec += np.asarray(val, "<u4").tobytes()
            else:
                raise TypeError("unsupported tag value %r" % (val,))
        self._bgzf.write(struct.pack("<i", len(rec)) + bytes(rec))

    def close(self):
        self._bgzf.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def cigar_to_string(cigar: Sequence[Tuple[int, int]]) -> str:
    return "".join("%d%s" % (ln, CIGAR_OPS[op]) for op, ln in cigar)


def parse_cigar_string(s: str) -> List[Tuple[int, int]]:
    out = []
    num = 0
    for ch in s:
        if ch.isdigit():
            num = num * 10 + ord(ch) - 48
        else:
            out.append((CIGAR_OPS.index(ch), num))
            num = 0
    return out
