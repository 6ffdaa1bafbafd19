"""BGZF block inflate on the GPU: wrapper of the CUDA kernel
csrc/bgzf_inflate.cu, and the native decoder's back end on the card.

A batch of BGZF blocks is one byte buffer ``src`` and an int32 ``meta``
array of four columns a block: where its raw-deflate stream starts in
``src``, the stream's length, where its output starts in ``out``, and its
inflated size (BGZF's ISIZE). Each block gets a status: 0 when its
stream ends inside its bytes with exactly ISIZE bytes out, else the
fault's code (``_ZLIB_STATUS``). On a CUDA
device :func:`inflate_tensors` launches the kernel (one warp a block, one
launch a batch) or raises; only the CPU takes the plain version,
:func:`inflate_plain` (zlib). :func:`card_table` is the decoder's back end
on a CUDA device: ``io/native.py`` hands it to ``native/bamdecode.cpp``,
which then inflates every BGZF block of a BAM on the card.
"""
from __future__ import annotations

import ctypes
import threading
import zlib

import numpy as np
import torch

from cutesv_tpu_torch.ops import build
from cutesv_tpu_torch.utils.torchsetup import resolve_device

# kernel launches made by inflate_tensors (tests and the kernel benchmark
# read it); the decoder's batches are counted by its own counters
# (``decode.walk``'s ``blocks_card``)
LAUNCHES = 0
# zlib's messages, by the status the kernel gives the same fault (the
# kernel's Status: 1 block type 3, 2 a stored block's LEN, 3 code lengths,
# 4 a code or distance, 5 not ISIZE bytes, 6 past the stream's bytes)
_ZLIB_STATUS = (("invalid block type", 1), ("stored block lengths", 2),
                ("length or distance symbols", 3), ("code lengths set", 3),
                ("bit length repeat", 3), ("lengths set", 3),
                ("distances set", 3), ("missing end-of-block", 3))

_tables: dict = {}
_lock = threading.Lock()


def bgzf_batch(path: str) -> tuple:
    """Every BGZF block of the file at ``path`` as one batch: (the file's
    bytes, ``meta``), the outputs laid end to end. The blocks are found by
    ``io/bgzf.py::scan_block_table``, which raises on a malformed file."""
    from cutesv_tpu_torch.io.bgzf import scan_block_table

    offs, isizes = scan_block_table(path)
    with open(path, "rb") as fh:
        data = fh.read()
    xlen = np.frombuffer(data, np.uint8)[offs + 10].astype(np.int64) \
        | np.frombuffer(data, np.uint8)[offs + 11].astype(np.int64) << 8
    start = offs + 12 + xlen
    ends = np.append(offs[1:], len(data))
    out = np.concatenate([[0], np.cumsum(isizes)[:-1]])
    meta = np.stack([start, ends - 8 - start, out, isizes], 1)
    return data, meta.astype(np.int32).reshape(-1, 4)


def _check(src_bytes: int, meta: np.ndarray) -> int:
    """Validate a batch; returns its output bytes."""
    if meta.ndim != 2 or meta.shape[1] != 4:
        raise ValueError("meta is (blocks, 4): src offset, length, out "
                         "offset, inflated size")
    if len(meta) == 0:
        return 0
    m = meta.astype(np.int64)
    if (m < 0).any() or (m[:, 0] + m[:, 1] > src_bytes).any():
        raise ValueError("a block's stream lies outside src")
    if (m[:, 3] > 65536).any():
        raise ValueError("a BGZF block inflates to at most 65536 bytes")
    return int((m[:, 2] + m[:, 3]).max())


def inflate_plain(src, meta) -> tuple:
    """zlib over the batch: (out uint8, status int32) numpy arrays, with
    the kernel's statuses for the faults zlib names (a block that does not
    inflate leaves its output bytes unspecified)."""
    src = bytes(src)
    meta = np.asarray(meta)
    out = np.zeros(_check(len(src), meta), np.uint8)
    status = np.zeros(len(meta), np.int32)
    for i, (so, cl, oo, isz) in enumerate(meta.tolist()):
        d = zlib.decompressobj(-15)
        try:
            got = d.decompress(src[so:so + cl], isz + 1)
        except zlib.error as exc:
            msg = str(exc)
            status[i] = next((code for text, code in _ZLIB_STATUS
                              if text in msg), 4)
            continue
        if not d.eof:
            status[i] = 5 if len(got) > isz else 6
        elif len(got) != isz:
            status[i] = 5
        else:
            out[oo:oo + isz] = np.frombuffer(got, np.uint8)
    return out, status


def inflate_tensors(src: torch.Tensor, meta: torch.Tensor,
                    out: torch.Tensor = None) -> tuple:
    """One kernel launch on the current stream over a batch on a CUDA
    device: ``src`` contiguous uint8, ``meta`` contiguous int32 (blocks,
    4); returns (out uint8, status int32) on that device. ``out``: the
    output buffer to write into (a new one when None)."""
    global LAUNCHES
    if src.device.type != "cuda" or meta.device != src.device:
        raise ValueError("the inflate kernel takes tensors on one CUDA "
                         "device")
    if src.dtype != torch.uint8 or src.dim() != 1 \
            or not src.is_contiguous() or src.data_ptr() % 4:
        raise ValueError("src is a contiguous, 4-byte aligned uint8 vector")
    if meta.dtype != torch.int32 or not meta.is_contiguous():
        raise ValueError("meta is contiguous int32")
    n_out = _check(src.numel(), meta.cpu().numpy())
    n = meta.shape[0]
    if out is None:
        out = torch.empty(n_out, dtype=torch.uint8, device=src.device)
    elif out.device != src.device or out.dtype != torch.uint8 \
            or not out.is_contiguous() or out.numel() < n_out:
        raise ValueError("out is a contiguous uint8 buffer of the batch's "
                         "output bytes on src's device")
    status = torch.empty(n, dtype=torch.int32, device=src.device)
    lib = build.library()
    with torch.cuda.device(src.device):
        err = lib.cutesv_inflate_launch(
            src.data_ptr(), src.numel(), meta.data_ptr(), n, out.data_ptr(),
            status.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError("bgzf_inflate kernel launch failed: CUDA error %d"
                           % err)
    LAUNCHES += 1
    return out, status


def inflate_batch(src, meta, device=None) -> tuple:
    """The batch on ``device`` as numpy (out, status): the kernel on a CUDA
    device, the plain version on the CPU."""
    device = resolve_device(device)
    meta = np.ascontiguousarray(meta, np.int32)
    if device.type == "cpu":
        return inflate_plain(src, meta)
    buf = torch.frombuffer(bytearray(bytes(src)), dtype=torch.uint8)
    out, status = inflate_tensors(buf.to(device), torch.from_numpy(meta)
                                  .to(device))
    return out.cpu().numpy(), status.cpu().numpy()


def card_table(device) -> int:
    """The decoder's back end on a CUDA ``device`` (the address of its
    table of C functions, ``cutesv_inflate_create``): pinned and device
    buffers for a few batches in flight, made once per process and device
    at the first decode on it. Raises where they cannot be made."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError("the card back end needs a CUDA device, not %s"
                         % device)
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    with _lock:
        table = _tables.get(index)
        if table is None:
            ptr = ctypes.c_void_p()
            err = build.library().cutesv_inflate_create(index,
                                                        ctypes.byref(ptr))
            if err != 0:
                raise RuntimeError("card inflate: CUDA error %d making the "
                                   "back end on cuda:%d" % (err, index))
            table = _tables[index] = ptr.value
    return table
