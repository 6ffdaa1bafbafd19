"""Build and load the hand-written CUDA kernels of ``csrc/``.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` process (all
started together) for ``sm_90a`` into an object file, and the objects are
linked into one shared library with a plain C interface,
``build/torch_kernels/<key>/libcutesv_torch_kernels.so`` beside the
package, which is loaded with ``ctypes``. ``<key>`` hashes every file of
``csrc/`` and the compiler flags, so a change to either builds a new
library. Nothing here runs at import time: the first kernel
launch builds, so machines without ``nvcc`` (CPU-only test runs) never
reach it. A failed build raises with the compiler's output.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
LIB_NAME = "libcutesv_torch_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib = None
# filled by build(): seconds spent and the compiler's -Xptxas -v report
build_info: dict = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (needed to build the CUDA kernels "
                       "in %s)" % CSRC)


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _key() -> str:
    """Hash of every file of csrc/ (sources and headers) and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(p for p in CSRC.iterdir() if p.is_file()):
        h.update(f.name.encode() + b"\0" + f.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile (unless this key's library exists) and return the library
    path; records the wall seconds and the compiler's resource report in
    :data:`build_info`."""
    out_dir = BUILD_DIR / _key()
    lib = out_dir / LIB_NAME
    if lib.exists():
        build_info.setdefault("seconds", 0.0)
        return lib
    t0 = time.time()
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for src in _sources():
        # per-process names: concurrent builders never share a file
        obj = out_dir / ("%s.%d.o" % (src.stem, os.getpid()))
        procs.append((src, obj, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    report = []
    failed = []
    for src, obj, proc in procs:
        out, _ = proc.communicate()
        report.append("%s:\n%s" % (src.name, out))
        if proc.returncode != 0:
            failed.append(src.name)
    if failed:
        raise RuntimeError("nvcc failed on %s:\n%s"
                           % (", ".join(failed), "\n".join(report)))
    tmp = out_dir / ("%s.%d.tmp" % (LIB_NAME, os.getpid()))
    link = subprocess.run(
        [nvcc, "-shared", "-o", str(tmp)] + [str(o) for _, o, _ in procs],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for _, obj, _ in procs:
        obj.unlink()
    if link.returncode != 0:
        raise RuntimeError("nvcc link failed:\n%s" % link.stdout)
    os.replace(tmp, lib)  # atomic: a concurrent loader never sees half a file
    build_info.update(seconds=time.time() - t0, report="\n".join(report))
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use), with argtypes set:
    every pointer and the stream as ``c_void_p`` so 64-bit values are not
    cut to 32 bits."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            vp, ci = ctypes.c_void_p, ctypes.c_int
            lib.cutesv_cover_count.argtypes = [vp, vp, ci, vp, vp, ci, vp,
                                               vp]
            lib.cutesv_cover_count.restype = ci
            _lib = lib
    return _lib
