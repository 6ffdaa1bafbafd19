"""Build and load the port's two native libraries.

* The hand-written CUDA kernels of ``csrc/``: every ``*.cu`` file is
  compiled by its own ``nvcc`` process (all started together) for
  ``sm_90a`` into an object file, and the objects are linked into one
  shared library with a plain C interface,
  ``build/torch_kernels/<key>/libcutesv_torch_kernels.so``.
* The C++ BAM decoder of ``native/``: ``bamdecode.cpp`` (which includes
  ``cramdecode.inc``) compiled by ``g++`` into
  ``build/native/<key>/libbamdecode.so``, linked against the runtime
  zlib, liblzma and libbz2 only (no development headers needed).

``build/`` sits beside the package. ``<key>`` hashes every file of the
library's source folder and the compiler flags (for the decoder, built
with ``-march=native``, also the host CPU's model and feature flags), so
a change to any of them builds a new library. Both load with ``ctypes``.
Nothing here runs at import time: the first use builds, so machines
without ``nvcc`` (CPU-only test runs) never reach the kernel build. A
build writes to per-process temporary names and publishes with
``os.replace``, so concurrent builds never share a file; a failed
build raises with the compiler's output.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading
import time
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
NATIVE = PKG / "native"
BUILD_ROOT = PKG.parent / "build"
LIB_NAME = "libcutesv_torch_kernels.so"
DECODER_NAME = "libbamdecode.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
GXX = "g++"
GXX_FLAGS = ["-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall",
             "-Wextra", "-Wno-unused-parameter", "-shared"]
# runtime sonames: present without the -dev packages' unversioned links
GXX_LIBS = ["-l:libz.so.1", "-l:liblzma.so.5", "-l:libbz2.so.1.0",
            "-lpthread"]

# one lock per library, so the two can build at the same time
_locks = {"kernels": threading.Lock(), "decoder": threading.Lock()}
_libs: dict = {}
# filled per library ("kernels", "decoder") at build time: wall seconds
# and the compiler's report (nvcc's -Xptxas -v, g++'s warnings)
build_info: dict = {}


def _find(tool: str, what: str, extra=()) -> str:
    for cand in (shutil.which(tool), *extra):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("%s not found (needed to build %s)" % (tool, what))


def _cpu_id() -> bytes:
    """The host CPU's model and feature flags (what -march=native
    compiles for); empty where /proc/cpuinfo does not exist."""
    try:
        with open("/proc/cpuinfo") as fh:
            lines = [l for l in fh.read().splitlines()
                     if l.startswith(("model name", "flags"))][:2]
    except OSError:
        lines = []
    return ("\n".join(lines) + platform.machine()).encode()


def _key(src_dir: Path, flags, extra: bytes = b"") -> str:
    """Hash of every file of ``src_dir`` (sources and headers), the flags
    and ``extra``."""
    h = hashlib.sha256(" ".join(flags).encode() + b"\0" + extra)
    for f in sorted(p for p in src_dir.iterdir() if p.is_file()):
        h.update(f.name.encode() + b"\0" + f.read_bytes())
    return h.hexdigest()[:16]


def _run(cmd) -> subprocess.Popen:
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def build() -> Path:
    """Compile the CUDA kernels (unless this key's library exists) and
    return the library path; records the wall seconds and the compiler's
    resource report in ``build_info["kernels"]``."""
    out_dir = BUILD_ROOT / "torch_kernels" / _key(CSRC, NVCC_FLAGS)
    lib = out_dir / LIB_NAME
    if lib.exists():
        build_info.setdefault("kernels", dict(seconds=0.0, report=""))
        return lib
    t0 = time.time()
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _find("nvcc", "the CUDA kernels in %s" % CSRC,
                 ["/usr/local/cuda/bin/nvcc"])
    procs = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = out_dir / ("%s.%d.o" % (src.stem, os.getpid()))
        procs.append((src, obj, _run([nvcc, *NVCC_FLAGS, "-c", str(src),
                                      "-o", str(obj)])))
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
    build_info["kernels"] = dict(seconds=time.time() - t0,
                                 report="\n".join(report))
    return lib


def build_decoder() -> Path:
    """Compile the BAM decoder (unless this key's library exists) and
    return the library path; records the wall seconds and g++'s output
    in ``build_info["decoder"]``."""
    flags = GXX_FLAGS + GXX_LIBS
    out_dir = BUILD_ROOT / "native" / _key(NATIVE, flags, _cpu_id())
    lib = out_dir / DECODER_NAME
    if lib.exists():
        build_info.setdefault("decoder", dict(seconds=0.0, report=""))
        return lib
    t0 = time.time()
    gxx = _find(GXX, "the BAM decoder in %s" % NATIVE)
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / ("%s.%d.tmp" % (DECODER_NAME, os.getpid()))
    proc = _run([gxx, *GXX_FLAGS, str(NATIVE / "bamdecode.cpp"), "-o",
                 str(tmp), *GXX_LIBS])
    out, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError("g++ failed on %s:\n%s"
                           % (NATIVE / "bamdecode.cpp", out))
    os.replace(tmp, lib)
    build_info["decoder"] = dict(seconds=time.time() - t0, report=out)
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use), with argtypes set:
    every pointer and the stream as ``c_void_p`` so 64-bit values are not
    cut to 32 bits."""
    with _locks["kernels"]:
        lib = _libs.get("kernels")
        if lib is None:
            lib = ctypes.CDLL(str(build()))
            vp, ci, cs = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
            lib.cutesv_cover_scratch_bytes.argtypes = [ci, ci]
            lib.cutesv_cover_scratch_bytes.restype = cs
            lib.cutesv_cover_count.argtypes = [vp, vp, ci, vp, vp, ci, vp,
                                               cs, vp, vp]
            lib.cutesv_cover_count.restype = ci
            _libs["kernels"] = lib
    return lib


def decoder_library() -> ctypes.CDLL:
    """The loaded BAM decoder library (built on first use); its argtypes
    are set by ``io/native.py``, which binds it."""
    with _locks["decoder"]:
        lib = _libs.get("decoder")
        if lib is None:
            lib = ctypes.CDLL(str(build_decoder()))
            _libs["decoder"] = lib
    return lib
