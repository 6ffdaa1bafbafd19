"""ctypes binding for the native BAM/CRAM signature decoder (``native/``).

:func:`decode` runs ``native/bamdecode.cpp`` over a whole BAM, or a CRAM
with its reference FASTA (the CRAM front end of ``cramdecode.inc``), and
returns the same logical content as the Python decoder's signature
extraction, as numpy SoA arrays; :class:`StreamingDecode` runs it on a
native thread and snapshots completed chromosomes while it runs; both
take the ``byte_range`` of a sharded (``--distributed``) decode;
:func:`scan_bgzf_native` lists a BAM's BGZF blocks for the shard plan;
:func:`block_decode` decodes one CRAM block. The library is built with
``g++`` at first use (``ops/build.py::decoder_library``); a failed build
or load raises, and nothing here falls back to the Python reader.

Where a BAM's BGZF blocks inflate follows the ``device`` the decode is
given: on a CUDA device, on the card; on a CPU device or none, in the
decoder's zlib threads. A CRAM's blocks use zlib either way. The CUDA
library exports two entry points for this: ``cutesv_inflate_launch`` (one
kernel launch over device buffers, ``ops/inflate.py::inflate_tensors``)
and ``cutesv_inflate_create``, which makes the decoder's back end on a
device: a ``CardInflate`` table of C functions (``csrc/card_inflate.h``:
acquire, submit a batch, fetch it into a pinned slot, wait, release, and
the launches made) over buffers made once per process and device
(``ops/inflate.py::card_table``). Its address goes to
``bamdecode_run``/``bamdecode_start``; a block that does not inflate to
its size fails the decode with status 5. The decode reports how many
blocks each back end inflated (``blocks_card``, ``blocks_host``) and, on
the card, how many batches the decoder handed the back end and how many
kernel launches the back end made (``batches_card``, ``launches_card``).

Field ids are kept in lockstep with the switch in bamdecode.cpp.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Dict, List

import numpy as np
import torch

from cutesv_tpu_torch.ops import build

_lib = None


def get_lib() -> ctypes.CDLL:
    """The decoder library (built and loaded on first use), bound."""
    global _lib
    if _lib is not None:
        return _lib
    lib = build.decoder_library()
    vp, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.bamdecode_run.restype = vp
    lib.bamdecode_run.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.POINTER(i64),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(i64),
        ctypes.POINTER(i64), i64, vp]
    lib.bamdecode_status.restype = ctypes.c_int
    lib.bamdecode_status.argtypes = [vp]
    lib.bamdecode_n_records.restype = i64
    lib.bamdecode_n_records.argtypes = [vp]
    for fn in ("bamdecode_walk_seconds", "bamdecode_inflate_core_seconds",
               "bamdecode_records_core_seconds"):
        getattr(lib, fn).restype = ctypes.c_double
        getattr(lib, fn).argtypes = [vp]
    for fn in ("bamdecode_walk_start_ns", "bamdecode_walk_end_ns"):
        getattr(lib, fn).restype = i64
        getattr(lib, fn).argtypes = [vp]
    lib.bamdecode_blocks.restype = None
    lib.bamdecode_blocks.argtypes = [vp] + [ctypes.POINTER(i64)] * 4
    lib.bamdecode_err.restype = ctypes.c_char_p
    lib.bamdecode_err.argtypes = [vp]
    lib.bamdecode_get.restype = ctypes.c_int
    lib.bamdecode_get.argtypes = [vp, ctypes.c_int, ctypes.POINTER(vp),
                                  ctypes.POINTER(i64)]
    lib.bamdecode_free.argtypes = [vp]
    # streaming decode (StreamingDecode)
    lib.bamdecode_start.restype = vp
    lib.bamdecode_start.argtypes = lib.bamdecode_run.argtypes
    lib.bamdecode_poll.restype = ctypes.c_int32
    lib.bamdecode_poll.argtypes = [vp]
    lib.bamdecode_wait.restype = ctypes.c_int32
    lib.bamdecode_wait.argtypes = [vp, ctypes.c_int32, i64]
    lib.bamdecode_n_refs.restype = ctypes.c_int32
    lib.bamdecode_n_refs.argtypes = [vp]
    lib.bamdecode_range_refids.restype = None
    lib.bamdecode_range_refids.argtypes = [
        vp, ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32)]
    lib.bamdecode_join.restype = ctypes.c_int
    lib.bamdecode_join.argtypes = [vp]
    lib.bamdecode_snapshot.restype = i64
    lib.bamdecode_snapshot.argtypes = [vp, ctypes.c_int, ctypes.c_int32]
    lib.bamdecode_snapshot_get.restype = ctypes.c_int
    lib.bamdecode_snapshot_get.argtypes = [vp, ctypes.c_int,
                                           ctypes.POINTER(vp),
                                           ctypes.POINTER(i64)]
    lib.bamdecode_ins_seq_spans.restype = i64
    lib.bamdecode_ins_seq_spans.argtypes = [
        vp, ctypes.POINTER(i64), ctypes.POINTER(i64), i64, ctypes.c_char_p]
    # one CRAM block payload (block_decode)
    lib.bamdecode_block_decode.restype = vp
    lib.bamdecode_block_decode.argtypes = [
        ctypes.c_int, ctypes.c_char_p, i64, i64, ctypes.POINTER(i64),
        ctypes.POINTER(ctypes.c_char_p)]
    lib.bamdecode_block_free.argtypes = [vp]
    # BGZF block table (scan_bgzf_native)
    lib.bamdecode_scan_bgzf.restype = ctypes.c_int
    lib.bamdecode_scan_bgzf.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.POINTER(i64)),
        ctypes.POINTER(ctypes.POINTER(i64)), ctypes.POINTER(i64)]
    lib.bamdecode_scan_free.argtypes = [ctypes.POINTER(i64)]
    _lib = lib
    return lib


def scan_bgzf_native(path: str):
    """The C++ decoder's BGZF block-table scan (mmap): (offsets, isizes)
    int64 arrays, or None for a non-regular file or malformed input,
    whose designed error the Python scanner
    (``io/bgzf.py::scan_block_table``) owns."""
    lib = get_lib()
    offs = ctypes.POINTER(ctypes.c_int64)()
    isz = ctypes.POINTER(ctypes.c_int64)()
    n = ctypes.c_int64()
    rc = lib.bamdecode_scan_bgzf(path.encode(), ctypes.byref(offs),
                                 ctypes.byref(isz), ctypes.byref(n))
    if rc != 0:
        return None
    try:
        o = np.ctypeslib.as_array(offs, shape=(n.value,)).copy()
        i = np.ctypeslib.as_array(isz, shape=(n.value,)).copy()
    finally:
        lib.bamdecode_scan_free(offs)
        lib.bamdecode_scan_free(isz)
    return o, i


def block_decode(method: int, data: bytes, raw_size: int) -> bytes:
    """Decompress one CRAM block payload with the native decoder's codec
    for ``method`` (0-8): the seam that holds the C++ block codecs
    against the Python ones of ``io/cram_codecs*.py``. Raises ValueError
    with the native message on failure."""
    lib = get_lib()
    out_len = ctypes.c_int64()
    err = ctypes.c_char_p()
    ptr = lib.bamdecode_block_decode(method, data, len(data), raw_size,
                                     ctypes.byref(out_len),
                                     ctypes.byref(err))
    if not ptr:
        raise ValueError("native block decode: %s"
                         % (err.value or b"?").decode())
    try:
        return ctypes.string_at(ptr, out_len.value)
    finally:
        lib.bamdecode_block_free(ptr)


_DTYPES = {  # field id -> numpy dtype (None = raw bytes)
    0: None, 1: np.int64, 2: np.int64, 3: None, 4: np.int64, 5: np.int64,
    10: np.int32, 11: np.int64, 12: np.int64, 13: np.int64,
    20: np.int32, 21: np.int64, 22: np.int64, 23: np.int64,
    24: np.int64, 25: np.int64, 26: None, 27: np.int64,
    30: np.int32, 31: np.int64, 32: np.int64, 33: np.int64,
    40: np.int32, 41: np.int8, 42: np.int64, 43: np.int64, 44: np.int64,
    50: np.int32, 51: np.int8, 52: np.int64, 53: np.int32, 54: np.int64,
    55: np.int64,
    60: np.int32, 61: np.int64, 62: np.int64, 63: np.int8, 64: np.int64,
    70: np.int32, 71: np.int64, 72: np.int64, 73: np.int8, 74: np.int64,
    80: np.int64, 81: np.int64,
}


@dataclass
class NativeDecode:
    """Decoded signature tensors. Names/chroms are Python string lists;
    per-type signature arrays use name ids (``names[id]``) and chrom ids
    (``chroms[id]``); ``name_rank`` maps id -> lexicographic rank."""

    names: List[str]
    name_rank: np.ndarray
    chroms: List[str]
    ref_lengths: np.ndarray       # header refs only (len == n header refs)
    n_records: int
    arrays: Dict[str, np.ndarray]
    ins_seq_blob: bytes
    # uncompressed offsets, relative to the byte range's start, of the
    # first record boundary and of the first record NOT owned by this
    # range (== the next shard's first); sharded decodes check them
    # against each other
    first_u: int = 0
    next_u: int = 0
    # decoder-internal record-walk wall (s), and its start and end on
    # the epoch clock (ns; 0 when the walk did not run)
    walk_s: float = 0.0
    walk_t0_ns: int = 0
    walk_t1_ns: int = 0
    # busy CORE-seconds, summed over all participating threads: inflate
    # (zlib spans) and record-parse loops
    inflate_core_s: float = 0.0
    records_core_s: float = 0.0
    # BGZF blocks inflated on the card and by the zlib threads; on the
    # card, the batches the decoder handed it and the kernel launches made
    blocks_card: int = 0
    blocks_host: int = 0
    batches_card: int = 0
    launches_card: int = 0

    def ins_seq(self, i: int) -> str:
        off = self.arrays["ins_seq_off"][i]
        ln = self.arrays["ins_seq_len"][i]
        return self.ins_seq_blob[off:off + ln].decode("ascii")


_FIELDS = {
    "del_chr": 10, "del_pos": 11, "del_len": 12, "del_name": 13,
    "ins_chr": 20, "ins_posx2": 21, "ins_len": 22, "ins_name": 23,
    "ins_seq_off": 24, "ins_seq_len": 25, "ins_seq_rank": 27,
    "dup_chr": 30, "dup_p1": 31, "dup_p2": 32, "dup_name": 33,
    "inv_chr": 40, "inv_strand": 41, "inv_b1": 42, "inv_b2": 43,
    "inv_name": 44,
    "tra_chr1": 50, "tra_type": 51, "tra_p1": 52, "tra_chr2": 53,
    "tra_p2": 54, "tra_name": 55,
    "cen_chr": 60, "cen_start": 61, "cen_end": 62, "cen_prim": 63,
    "cen_name": 64,
    "all_chr": 70, "all_start": 71, "all_end": 72, "all_prim": 73,
    "all_name": 74,
}


def _fetch(lib, handle, field: int):
    data = ctypes.c_void_p()
    n = ctypes.c_int64()
    rc = lib.bamdecode_get(handle, field, ctypes.byref(data),
                           ctypes.byref(n))
    if rc != 0:
        raise RuntimeError("bamdecode_get(%d) failed" % field)
    dtype = _DTYPES[field]
    if n.value == 0:
        return b"" if dtype is None else np.empty(0, dtype)
    if dtype is None:
        return ctypes.string_at(data, n.value)
    # single copy straight out of the native buffer
    ctype = np.ctypeslib.as_ctypes_type(np.dtype(dtype))
    view = np.ctypeslib.as_array(ctypes.cast(data, ctypes.POINTER(ctype)),
                                 shape=(n.value,))
    return view.copy()


def _err_detail(lib, handle) -> str:
    try:
        msg = lib.bamdecode_err(handle)
        return msg.decode("utf-8", "replace") if msg else ""
    except Exception:
        return ""


class NativeUnsupported(IOError):
    """The native decoder met a feature it does not implement (status 10,
    e.g. a legacy lzma-"alone" CRAM block, a CRAM 2.x file or a CRAM
    without its reference FASTA). ``pipeline.decode_bam`` hands such a
    file to the Python reader and reports ``decoder="python"``."""


def _call_args(cfg, bed_ids, reference, byte_range=None):
    rng_start, rng_ulen = byte_range if byte_range else (0, 0)
    params = (ctypes.c_int64 * 11)(
        cfg.min_size, cfg.min_mapq, cfg.max_split_parts, cfg.min_read_len,
        cfg.min_siglength, cfg.merge_del_threshold, cfg.merge_ins_threshold,
        cfg.max_size, getattr(cfg, "threads", 2), rng_start, rng_ulen)
    keepalive = []
    if bed_ids is not None and len(bed_ids[0]):
        bc = np.ascontiguousarray(bed_ids[0], np.int32)
        bs = np.ascontiguousarray(bed_ids[1], np.int64)
        be = np.ascontiguousarray(bed_ids[2], np.int64)
        keepalive = [bc, bs, be]
        n_bed = len(bc)
        bc_p = bc.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
        bs_p = bs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
        be_p = be.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
    else:
        n_bed = 0
        bc_p = ctypes.POINTER(ctypes.c_int32)()
        bs_p = ctypes.POINTER(ctypes.c_int64)()
        be_p = ctypes.POINTER(ctypes.c_int64)()
    ref_arg = reference.encode() if reference else None
    return params, ref_arg, bc_p, bs_p, be_p, n_bed, keepalive


def _card(device):
    """The card back end for a CUDA ``device`` (a BAM's BGZF blocks then
    inflate on the card), None (zlib threads) for a CPU device or none."""
    if device is None or torch.device(device).type != "cuda":
        return None
    from cutesv_tpu_torch.ops import inflate
    return inflate.card_table(device)


def _check_status(status: int, path: str, detail: str = ""):
    if status == 10:
        raise NativeUnsupported(
            "native decode: unsupported CRAM feature in %s%s"
            % (path, ": " + detail if detail else ""))
    if status != 0:
        base = {1: "cannot open file", 2: "not BGZF data",
                3: "bad BAM header", 4: "malformed record",
                5: "truncated file",
                6: "mapped record without a CIGAR passes --min_mapq "
                   "(its coordinates cannot be interpreted; re-align "
                   "or fix the input)"}.get(status, "")
        if detail:
            base = (base + " — " + detail) if base else detail
        raise IOError("native BAM decode failed (status %d%s) for %s"
                      % (status, ": " + base if base else "", path))


def _extract(lib, handle, path: str) -> NativeDecode:
    blocks = [ctypes.c_int64() for _ in range(4)]
    lib.bamdecode_blocks(handle, *map(ctypes.byref, blocks))
    blocks_card, blocks_host, batches_card, launches_card = (
        b.value for b in blocks)
    name_blob = _fetch(lib, handle, 0)
    name_off = _fetch(lib, handle, 1)
    # one whole-blob decode + str slicing; BAM qnames are ASCII by spec,
    # so validate the blob once (io/bam.py raises on bytes >= 0x80 too)
    if not name_blob.isascii():
        name_blob.decode("ascii")  # raises the Python reader's error
    blob_s = name_blob.decode("latin-1")
    offs = name_off.tolist()
    names = [blob_s[offs[i]:offs[i + 1]] for i in range(len(offs) - 1)]
    name_rank = _fetch(lib, handle, 2)
    chrom_blob = _fetch(lib, handle, 3)
    chrom_off = _fetch(lib, handle, 4)
    chroms = [chrom_blob[chrom_off[i]:chrom_off[i + 1]].decode("ascii")
              for i in range(len(chrom_off) - 1)]
    ref_lengths = _fetch(lib, handle, 5)
    arrays = {k: _fetch(lib, handle, f) for k, f in _FIELDS.items()}
    ins_seq_blob = _fetch(lib, handle, 26)
    return NativeDecode(names=names, name_rank=name_rank, chroms=chroms,
                        ref_lengths=ref_lengths,
                        n_records=lib.bamdecode_n_records(handle),
                        arrays=arrays, ins_seq_blob=ins_seq_blob,
                        first_u=int(_fetch(lib, handle, 80)[0]),
                        next_u=int(_fetch(lib, handle, 81)[0]),
                        walk_s=float(lib.bamdecode_walk_seconds(handle)),
                        walk_t0_ns=int(lib.bamdecode_walk_start_ns(handle)),
                        walk_t1_ns=int(lib.bamdecode_walk_end_ns(handle)),
                        inflate_core_s=float(
                            lib.bamdecode_inflate_core_seconds(handle)),
                        records_core_s=float(
                            lib.bamdecode_records_core_seconds(handle)),
                        blocks_card=blocks_card, blocks_host=blocks_host,
                        batches_card=batches_card,
                        launches_card=launches_card)


def decode(path: str, cfg, bed_ids=None, reference=None,
           byte_range=None, device=None) -> NativeDecode:
    """Run the native decoder over the file (BAM; CRAM when ``reference``
    names the FASTA). ``bed_ids``: optional (chr_id, start, end) int
    arrays in header chrom-id space (already ±1000-padded).
    ``cfg.threads`` sets the decode threads. ``byte_range``: optional
    (compressed_offset, length) of a sharded decode — a BAM decodes the
    records whose uncompressed start offset relative to the BGZF block
    at the offset is below the uncompressed length, a CRAM the
    containers inside the compressed length (0 = unbounded, -1 = none);
    the result's ``first_u``/``next_u`` are the range's boundary
    offsets for the cross-shard agreement check. ``device``: a CUDA
    device inflates a BAM's BGZF blocks on the card (:func:`_card`)."""
    lib = get_lib()
    params, ref_arg, bc_p, bs_p, be_p, n_bed, _ka = _call_args(
        cfg, bed_ids, reference, byte_range)
    handle = lib.bamdecode_run(path.encode(), ref_arg, params, bc_p, bs_p,
                               be_p, n_bed, _card(device))
    try:
        _check_status(lib.bamdecode_status(handle), path,
                      _err_detail(lib, handle))
        return _extract(lib, handle, path)
    finally:
        lib.bamdecode_free(handle)


_SNAP_FIELDS = ("pos", "length", "name_id", "name_lrank", "seq_len",
                "seq_lrank", "seq_off")


class StreamingDecode:
    """Decode on a native thread; poll per-chromosome completion and
    snapshot completed chromosomes' rows mid-run, then join for the full
    NativeDecode. Snapshot name/seq ranks are LOCAL to the snapshot
    (order-isomorphic to the final global ranks restricted to the same
    rows); callers must validate a snapshot against the final store
    before trusting work derived from it (a later read's SA tag can add
    rows to an already-passed chromosome). Use as a context manager or
    call :meth:`free`; freeing joins the decode thread."""

    DONE = 2 ** 31 - 1  # INT32_MAX progress sentinel

    def __init__(self, path: str, cfg, bed_ids=None, reference=None,
                 byte_range=None, device=None):
        """``reference``: the FASTA of a CRAM input (None for a BAM);
        ``byte_range``, ``device``: as for :func:`decode`."""
        self._lib = get_lib()
        self._path = path
        params, ref_arg, bc_p, bs_p, be_p, n_bed, ka = _call_args(
            cfg, bed_ids, reference, byte_range)
        self._keepalive = ka
        self._handle = self._lib.bamdecode_start(
            path.encode(), ref_arg, params, bc_p, bs_p, be_p, n_bed,
            _card(device))

    def poll(self) -> int:
        """refID currently being decoded (chroms below it are complete
        modulo late SA rows); DONE when the run has finished."""
        return int(self._lib.bamdecode_poll(self._handle))

    def wait(self, seen: int, timeout_ms: int) -> int:
        """poll() once it has passed ``seen`` (or is DONE), or after
        ``timeout_ms`` whatever it is. Sleeps in the decoder, on a
        condition variable that every progress store signals, with the GIL
        released."""
        return int(self._lib.bamdecode_wait(self._handle, seen, timeout_ms))

    def n_refs(self) -> int:
        """Header reference count; valid once poll() returned >= 0
        (including DONE)."""
        return int(self._lib.bamdecode_n_refs(self._handle))

    def range_refids(self):
        """(first, last) refid merged so far (-1 while nothing merged):
        under a byte range these are the possibly-partial boundary
        chromosomes, whose census/sig completeness cannot be assumed."""
        first = ctypes.c_int32()
        last = ctypes.c_int32()
        self._lib.bamdecode_range_refids(self._handle, ctypes.byref(first),
                                         ctypes.byref(last))
        return int(first.value), int(last.value)

    _SNAP_TYPE = {"DEL": 0, "INS": 1, "DUP": 2, "INV": 3, "TRA": 4,
                  "CEN": 5}
    # (field_id, name) per snapshot type; DUP reuses pos/length for
    # (p1, p2), INV adds the strand, TRA the bnd type + mate chrom id,
    # CEN is the per-chromosome read census
    _SNAP_LAYOUT = {
        0: tuple(enumerate(_SNAP_FIELDS[:4])),
        1: tuple(enumerate(_SNAP_FIELDS)),
        2: tuple(enumerate(_SNAP_FIELDS[:4])),
        3: tuple(enumerate(_SNAP_FIELDS[:4])) + ((4, "strand"),),
        4: tuple(enumerate(_SNAP_FIELDS[:4])) + ((4, "bnd_type"),
                                                 (6, "chr2")),
        5: ((0, "start"), (1, "end"), (4, "is_primary"), (2, "name")),
    }

    def snapshot(self, sv_type: str, chrom_id: int) -> Dict[str,
                                                            np.ndarray]:
        """Copy one chromosome's rows seen so far. sv_type: DEL / INS /
        DUP / INV / TRA / CEN. Returns int64 arrays keyed per type (pos
        is INS pos*2 / DUP p1 / INV b1 / TRA p1; length is INS len /
        DUP p2 / INV b2 / TRA p2)."""
        t = self._SNAP_TYPE[sv_type]
        n = self._lib.bamdecode_snapshot(self._handle, t, chrom_id)
        out = {}
        for i, name in self._SNAP_LAYOUT[t]:
            data = ctypes.c_void_p()
            ln = ctypes.c_int64()
            rc = self._lib.bamdecode_snapshot_get(
                self._handle, i, ctypes.byref(data), ctypes.byref(ln))
            if rc != 0:
                raise RuntimeError("bamdecode_snapshot_get(%d) failed" % i)
            if ln.value == 0:
                out[name] = np.empty(0, np.int64)
            else:
                # single copy (see _fetch): these run inside the
                # mid-decode poll loop, competing with the inflate pool
                view = np.ctypeslib.as_array(
                    ctypes.cast(data, ctypes.POINTER(ctypes.c_int64)),
                    shape=(ln.value,))
                out[name] = view.copy()
        if any(len(v) != n for v in out.values()):
            raise RuntimeError("bamdecode_snapshot: column lengths differ "
                               "from its row count %d" % n)
        return out

    def ins_seq_spans(self, offs, lens) -> bytes:
        """Copy INS sequence blob spans (safe mid-decode: the read takes
        the decoder's merge lock). Returns the concatenated bytes."""
        offs = np.ascontiguousarray(offs, np.int64)
        lens = np.ascontiguousarray(lens, np.int64)
        total = int(lens.sum())
        out = np.empty(max(total, 1), np.uint8)
        w = self._lib.bamdecode_ins_seq_spans(
            self._handle,
            offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(offs), out.ctypes.data_as(ctypes.c_char_p))
        if w != total:
            raise RuntimeError("bamdecode_ins_seq_spans(%d != %d)"
                               % (w, total))
        return out[:total].tobytes()

    def join(self) -> NativeDecode:
        """Wait for the decode thread, check status, extract everything."""
        status = self._lib.bamdecode_join(self._handle)
        _check_status(status, self._path,
                      _err_detail(self._lib, self._handle))
        return _extract(self._lib, self._handle, self._path)

    def free(self):
        if self._handle is not None:
            self._lib.bamdecode_free(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.free()
