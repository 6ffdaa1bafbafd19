"""FASTA access (replaces pysam.FastaFile for VCF REF/ALT assembly).

The VCF emitter only needs whole-contig strings (reference touchpoint:
cuteSV_genotype.py:254-259 fetches the full chromosome). Supports plain and
BGZF-compressed FASTA. Plain files are memory-mapped and indexed with one
vectorized newline scan (the faidx idea); a contig's bytes are only decoded
when fetched, so a run over a 3 GB genome pays for the contigs it emits
calls on, not the whole file.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from cutesv_tpu_torch.io.bgzf import _read_block


def _read_all_bgzf(path: str) -> bytes:
    with open(path, "rb") as fh:
        chunks = []
        while True:
            block = _read_block(fh)
            if block is None:
                break
            chunks.append(block)
        return b"".join(chunks)


class FastaFile:
    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as fh:
            head = fh.read(2)
        if head == b"\x1f\x8b":
            buf = np.frombuffer(_read_all_bgzf(path), np.uint8)
        elif len(head) == 0:  # np.memmap rejects empty files
            buf = np.empty(0, np.uint8)
        else:
            buf = np.memmap(path, np.uint8, mode="r")
        self._buf = buf
        n = len(buf)
        # one equality pass for '>' bytes only (tiny result array), then a
        # line-start filter via the preceding byte — the full-newline index
        # the old code built was the dominant open cost on big genomes
        gt = np.flatnonzero(buf == ord(">"))
        if len(gt):
            at_line_start = np.empty(len(gt), bool)
            at_line_start[0] = gt[0] == 0
            if len(gt) > 1:
                at_line_start[1:] = buf[gt[1:] - 1] == 10
            if gt[0] != 0:
                at_line_start[0] = buf[gt[0] - 1] == 10
            hdr_starts = gt[at_line_start]
        else:
            hdr_starts = gt
        self._order: List[str] = []
        self._regions: Dict[str, Tuple[int, int]] = {}
        self._lengths: Dict[str, int] = {}
        n_h = len(hdr_starts)
        for k in range(n_h):
            h = int(hdr_starts[k])
            data_end = int(hdr_starts[k + 1]) if k + 1 < n_h else n
            # find the header's line end with bounded small-slice scans
            line_end = data_end
            probe = h
            while probe < data_end:
                win = np.flatnonzero(buf[probe:min(probe + 65536,
                                                   data_end)] == 10)
                if len(win):
                    line_end = probe + int(win[0])
                    break
                probe += 65536
            name = bytes(buf[h + 1:line_end]).split()[0].decode("ascii") \
                if line_end > h + 1 else ""
            data_start = min(line_end + 1, n)
            self._order.append(name)
            self._regions[name] = (data_start, max(data_end, data_start))

    @property
    def references(self) -> List[str]:
        return list(self._order)

    def length(self, name: str) -> int:
        if name not in self._lengths:
            s, e = self._regions[name]
            self._lengths[name] = int(np.count_nonzero(self._buf[s:e] > 32))
        return self._lengths[name]

    def lengths(self) -> List[Tuple[str, int]]:
        return [(n, self.length(n)) for n in self._order]

    def fetch(self, name: str) -> str:
        if name not in self._regions:
            raise KeyError(name)
        s, e = self._regions[name]
        arr = np.asarray(self._buf[s:e])
        return arr[arr > 32].tobytes().decode("ascii")

    def fetch_lazy(self, name: str):
        """A string-like view decoding only the bases that are indexed —
        the VCF emitter touches a handful of REF positions per call, so
        whole-chromosome decodes (O(genome) bytes) are wasted work. Falls
        back to the eager string when the contig's line layout is not
        the uniform-width faidx shape.

        The uniform-layout proof costs two O(contig) passes; its verdict
        is a pure function of the file bytes, so it is resolved from (in
        order): a standard ``.fai`` sidecar (trusted exactly as htslib
        trusts faidx output), our own size+mtime-keyed verdict cache
        written after the first validation, or the full validation pass."""
        if name not in self._regions:
            raise KeyError(name)
        s, e = self._regions[name]
        arr = np.asarray(self._buf[s:e])
        m = int(e - s)
        if m == 0:
            return self.fetch(name)
        layout = self._layouts().get(name)
        if layout is not None:
            w, n_bases = layout
            if w <= 0:
                return self.fetch(name)
            return _ChromView(arr, w, n_bases)
        head_nl = np.flatnonzero(arr[:65536] == 10)
        if len(head_nl) == 0:
            self._save_layout(name, 0, 0)
            return self.fetch(name)
        w = int(head_nl[0])
        if w <= 0:
            self._save_layout(name, 0, 0)
            return self.fetch(name)
        # uniform layout iff every full line is w bases + newline, i.e.
        # bytes at offsets k*(w+1)+w are newlines; verify with a strided
        # gather instead of a full newline index. The final line (tail)
        # may be shorter, with or without a trailing newline.
        n_full = m // (w + 1)
        exp_nl = arr[w::w + 1]
        if len(exp_nl) < n_full or not bool(np.all(exp_nl[:n_full] == 10)):
            self._save_layout(name, 0, 0)
            return self.fetch(name)
        tail = arr[n_full * (w + 1):]
        n_tail = len(tail)
        if n_tail:
            if n_tail > w + 1:
                self._save_layout(name, 0, 0)
                return self.fetch(name)
            trailing_nl = int(tail[-1]) == 10
            if trailing_nl:
                n_tail -= 1
                tail = tail[:-1]
            if bool(np.any(tail <= 32)):
                self._save_layout(name, 0, 0)
                return self.fetch(name)
            n_nl = n_full + (1 if trailing_nl else 0)
        else:
            n_nl = n_full
        # the eager path strips EVERY byte <= 32 (\r, spaces); the view's
        # offset formula only accounts for the newlines — one count pass
        # (no index materialization) proves they coincide
        if int(np.count_nonzero(arr <= 32)) != n_nl:
            self._save_layout(name, 0, 0)
            return self.fetch(name)
        self._save_layout(name, w, m - n_nl)
        return _ChromView(arr, w, m - n_nl)

    # --- uniform-layout verdict sources ------------------------------------

    def _layouts(self) -> Dict[str, Tuple[int, int]]:
        """name -> (line_width, n_bases); line_width<=0 means 'eager'.
        Merged from the .fai sidecar and our own verdict cache."""
        if getattr(self, "_layout_map", None) is not None:
            return self._layout_map
        import json
        import os
        out: Dict[str, Tuple[int, int]] = {}
        try:  # our cache (written by _save_layout; keyed to file identity)
            st = os.stat(self.path)
            d = json.load(open(self.path + ".lazyidx.json"))
            if (d.get("size") == st.st_size
                    and d.get("mtime_ns") == st.st_mtime_ns):
                for k, v in d.get("contigs", {}).items():
                    out[k] = (int(v[0]), int(v[1]))
        except Exception:
            pass
        try:  # standard faidx: NAME LENGTH OFFSET LINEBASES LINEWIDTH.
            # LINEWIDTH == LINEBASES+1 is exactly the uniform '\n' layout
            # the view needs; OFFSET must agree with our own header scan
            # (it is an uncompressed-space offset for bgzf FASTA too)
            with open(self.path + ".fai") as fh:
                for line in fh:
                    f = line.rstrip("\n").split("\t")
                    if len(f) < 5:
                        continue
                    nm, ln, off, lb, lw = (f[0], int(f[1]), int(f[2]),
                                           int(f[3]), int(f[4]))
                    if nm in out or nm not in self._regions:
                        continue
                    if (lw == lb + 1 and lb > 0
                            and self._regions[nm][0] == off):
                        out[nm] = (lb, ln)
        except Exception:
            pass
        self._layout_map = out
        return out

    def _save_layout(self, name: str, w: int, n_bases: int) -> None:
        """Record a validation verdict in the sidecar cache (best-effort:
        read-only directories simply skip the write)."""
        self._layouts()[name] = (w, n_bases)
        import json
        import os
        try:
            st = os.stat(self.path)
            cache_path = self.path + ".lazyidx.json"
            d = {"size": 0, "mtime_ns": 0, "contigs": {}}
            try:
                old = json.load(open(cache_path))
                if (old.get("size") == st.st_size
                        and old.get("mtime_ns") == st.st_mtime_ns):
                    d = old
            except Exception:
                pass
            d["size"] = st.st_size
            d["mtime_ns"] = st.st_mtime_ns
            d.setdefault("contigs", {})[name] = [int(w), int(n_bases)]
            tmp = cache_path + ".tmp.%d" % os.getpid()
            with open(tmp, "w") as fh:
                json.dump(d, fh)
            os.replace(tmp, cache_path)
        except Exception:
            pass

    def __contains__(self, name: str) -> bool:
        return name in self._regions


class _ChromView:
    """Lazy contig: base index p of a uniform-width-w FASTA body lives at
    byte p + p//w. Slicing decodes only the touched bytes and returns
    plain str, so it drops into the emitter wherever a full chromosome
    string is expected."""

    def __init__(self, arr, w: int, n_bases: int):
        self._arr = arr
        self._w = w
        self._n = n_bases

    def __len__(self):
        return self._n

    def __getitem__(self, k):
        w = self._w
        if isinstance(k, slice):
            a, b, step = k.indices(self._n)
            if step != 1:
                # decode the covering range, then apply the stride on the
                # str so semantics match an eagerly fetched string
                lo, hi = min(a, b), max(a, b)
                if step < 0:
                    lo, hi = lo + 1, hi + 1
                return self[lo:hi][::step] if hi > lo else ""
            if b <= a:
                return ""
            lo = a + a // w
            hi = (b - 1) + (b - 1) // w + 1
            chunk = self._arr[lo:hi]
            return chunk[chunk > 32].tobytes().decode("ascii")
        if k < 0:
            k += self._n
        if not 0 <= k < self._n:
            raise IndexError(k)
        return chr(self._arr[k + k // w])


def write_fasta(path: str, seqs: Dict[str, str], width: int = 60):
    """Test helper: write a plain FASTA file."""
    with open(path, "w") as fh:
        for name, seq in seqs.items():
            fh.write(">%s\n" % name)
            for i in range(0, len(seq), width):
                fh.write(seq[i:i + width] + "\n")
