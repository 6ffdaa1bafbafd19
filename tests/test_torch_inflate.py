"""BGZF block inflate: the kernel's plain version (zlib over a batch's
arrays, with the kernel's statuses) and the native decoder's back end,
which the decode's device picks; on a CUDA GPU (marker ``cuda``) the
kernel (csrc/bgzf_inflate.cu) against zlib, and a whole-BAM decode and
run on the card against the same on the CPU. This file imports neither
jax nor the JAX package, so on a GPU machine without JAX the card tests
run as

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_inflate.py -q
"""
import array
import copy
import fcntl
import os
import termios
import threading
import time
import zlib

import numpy as np
import pytest
import torch

from cutesv_tpu_torch.config import Config
from cutesv_tpu_torch.io import native
from cutesv_tpu_torch.ops import inflate
from cutesv_tpu_torch.pipeline import run_pipeline
from svbench import corpus, registry


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (a hand-written kernel has no CPU "
                    "mode)")
    return torch.device("cuda")


def _deflate(data: bytes, level: int) -> bytes:
    co = zlib.compressobj(level, zlib.DEFLATED, -15)
    return co.compress(data) + co.flush()


class _Bits:
    """A raw-deflate bit writer (RFC 1951): fields from their low bit,
    Huffman codes from their high bit."""

    def __init__(self):
        self.acc, self.n, self.out = 0, 0, bytearray()

    def put(self, value: int, bits: int):
        self.acc |= value << self.n
        self.n += bits
        while self.n >= 8:
            self.out.append(self.acc & 0xFF)
            self.acc >>= 8
            self.n -= 8

    def code(self, code: int, bits: int):
        self.put(int(format(code, "0%db" % bits)[::-1], 2), bits)

    def literal(self, sym: int):  # the fixed literal/length code
        if sym < 144:
            self.code(0x30 + sym, 8)
        elif sym < 256:
            self.code(0x190 + sym - 144, 9)
        elif sym < 280:
            self.code(sym - 256, 7)
        else:
            self.code(0xC0 + sym - 280, 8)

    def done(self) -> bytes:
        if self.n:
            self.out.append(self.acc & 0xFF)
        return bytes(self.out)


def _far_stream(head: bytes, repeats: int) -> bytes:
    """One fixed-Huffman block: ``head`` as literals, then ``repeats``
    matches of 258 bytes at distance 32,768 (zlib's encoder never reaches
    that far back)."""
    b = _Bits()
    b.put(1, 1)
    b.put(1, 2)
    for byte in head:
        b.literal(byte)
    for _ in range(repeats):
        b.literal(285)                  # length 258, no extra bits
        b.code(29, 5)                   # distance code 29: 24577 + 13 bits
        b.put(32768 - 24577, 13)
    b.literal(256)
    return b.done()


def _streams() -> dict:
    """Named (raw-deflate stream, inflated bytes) pairs."""
    rng = np.random.default_rng(7)
    seq = rng.choice(np.frombuffer(b"ACGT", np.uint8), 65280).tobytes()
    noise = rng.integers(0, 256, 65536, dtype=np.uint8).tobytes()
    head = rng.integers(0, 256, 32768, dtype=np.uint8).tobytes()
    far = head + (head * 2)[:258 * 4]
    cases = {"level%d" % level: (_deflate(seq, level), seq)
             for level in (0, 1, 6, 9)}
    for n in (1, 7, 40):               # zlib codes these with fixed codes
        cases["fixed%d" % n] = (_deflate(seq[:n], 6), seq[:n])
    cases["incompressible"] = (_deflate(noise, 9), noise)
    cases["far"] = (_far_stream(head, 4), far)
    cases["eof_block"] = (corpus.BGZF_EOF[18:-8], b"")
    return cases


def _corrupt() -> dict:
    """Named (stream, ISIZE, status) cases: each fault with its status."""
    ok = _deflate(b"ACGT" * 5000, 6)
    back = _Bits()
    back.put(1, 1)
    back.put(1, 2)
    back.literal(257)                   # length 3 ...
    back.code(0, 5)                     # ... at distance 1, before byte 0
    many = _Bits()
    many.put(1, 1)
    many.put(2, 2)
    many.put(31, 5)                     # HLIT 288 > 286
    many.put(0, 9)
    return {"block_type": (bytes([0b111, 0, 0, 0]), 4, 1),
            "stored_length": (bytes([1, 5, 0, 0, 0]) + b"hello", 5, 2),
            "code_count": (many.done() + bytes(8), 10, 3),
            "too_far_back": (back.done() + bytes(4), 3, 4),
            "isize_above": (ok, 20001, 5),
            "isize_below": (ok, 19999, 5),
            "cut_short": (ok[:len(ok) // 2], 20000, 6)}


def _batch(pairs):
    """(src, meta) of streams laid end to end, each at a 4-byte boundary,
    with outputs laid end to end."""
    src, rows, out = bytearray(), [], 0
    for stream, isize in pairs:
        rows.append((len(src), len(stream), out, isize))
        src += stream + bytes(-len(stream) % 4)
        out += isize
    return bytes(src), np.asarray(rows, np.int32).reshape(-1, 4)


def _tiny_bam(tmp_path, workload="hifi.germline"):
    """A small BAM and FASTA of the benchmark's generator: three contigs
    of ~250-310 kb at 6x."""
    cell = registry.cell(registry.load_benchmark(registry.ROOT), workload)
    cfg = copy.deepcopy(cell["config_data"])
    cfg["genome"].update(contigs=["chr1", "chr2", "chr3"],
                         source_mb=[249, 242, 198], divisor=800)
    cfg["reads"]["coverage"] = 6
    bam, fa = str(tmp_path / "tiny.bam"), str(tmp_path / "tiny.fa")
    corpus.write_corpus(2**31 + 77, cfg, cell["traffic_data"], bam, fa, 1)
    return bam, fa


def _stored_bam(tmp_path, bam):
    """``bam``'s records re-blocked at zlib level 0 (stored blocks), so its
    compressed bytes are its inflated bytes: ~8 MB for ``_tiny_bam``."""
    raw, status = inflate.inflate_plain(*inflate.bgzf_batch(bam))
    assert not status.any()
    path = tmp_path / "stored.bam"
    path.write_bytes(corpus.bgzf(raw.tobytes(), 0) + corpus.BGZF_EOF)
    return str(path)


def _stream(path, fifo):
    """Serve the file at ``path`` through the FIFO ``fifo`` (a stream the
    decoder cannot map); returns the serving thread. The decoder opens its
    input twice, a probe of the magic (one read) and then the run: the
    first 4 bytes go out alone, and the rest once the probe has read
    them. Held open for reading and writing, the FIFO always has a
    reader, so no write fails and no open blocks."""
    data = open(path, "rb").read()
    os.mkfifo(fifo)

    def serve():
        fd = os.open(fifo, os.O_RDWR)
        try:
            os.write(fd, data[:4])
            left = array.array("i", [1])
            while left[0]:
                fcntl.ioctl(fd, termios.FIONREAD, left)
                time.sleep(0.001)
            view = memoryview(data)
            while len(view):
                view = view[os.write(fd, view):]
        finally:
            os.close(fd)

    th = threading.Thread(target=serve, daemon=True)
    th.start()
    return th


def _assert_same_decode(got, want):
    for field in ("names", "chroms", "n_records", "ins_seq_blob", "first_u",
                  "next_u"):
        assert getattr(got, field) == getattr(want, field), field
    for field in ("name_rank", "ref_lengths"):
        assert np.array_equal(getattr(got, field), getattr(want, field))
    assert got.arrays.keys() == want.arrays.keys()
    for k in want.arrays:
        assert np.array_equal(got.arrays[k], want.arrays[k]), k


# --- the plain version (CPU) ---------------------------------------------

def test_plain_inflates_every_stream():
    cases = _streams()
    src, meta = _batch([(s, len(raw)) for s, raw in cases.values()])
    out, status = inflate.inflate_plain(src, meta)
    assert status.tolist() == [0] * len(cases)
    for (o, (_, raw)) in zip(meta[:, 2], cases.values()):
        assert out[o:o + len(raw)].tobytes() == raw


def test_plain_gives_the_kernels_status_for_each_fault():
    cases = _corrupt()
    src, meta = _batch([(s, n) for s, n, _ in cases.values()])
    _, status = inflate.inflate_plain(src, meta)
    assert dict(zip(cases, status.tolist())) == {
        name: want for name, (_, _, want) in cases.items()}


def test_plain_over_a_bam_equals_its_blocks(tmp_path):
    bam, _ = _tiny_bam(tmp_path)
    data, meta = inflate.bgzf_batch(bam)
    offs, isizes = native.scan_bgzf_native(bam)
    assert np.array_equal(meta[:, 3], isizes)
    assert np.array_equal(meta[:, 0], offs + 18)   # BGZF's 18-byte header
    out, status = inflate.inflate_batch(data, meta, "cpu")
    assert not status.any()
    whole = b"".join(zlib.decompress(data[s:s + c], wbits=-15)
                     for s, c, _, _ in meta.tolist())
    assert out.tobytes() == whole


def test_batch_outside_its_buffers_raises():
    src, meta = _batch([(_deflate(b"abc", 6), 3)])
    bad = meta.copy()
    bad[0, 1] = len(src) + 1
    with pytest.raises(ValueError, match="outside src"):
        inflate.inflate_plain(src, bad)
    bad = meta.copy()
    bad[0, 3] = 65537
    with pytest.raises(ValueError, match="65536"):
        inflate.inflate_plain(src, bad)
    with pytest.raises(ValueError, match="CUDA device"):
        inflate.card_table("cpu")


def test_cpu_decode_inflates_every_block_on_the_host(tmp_path):
    """A decode on a CPU device runs the zlib threads over every block of
    the BAM, the header's included, and its walk span says so."""
    bam, fa = _tiny_bam(tmp_path)
    n_blocks = len(native.scan_bgzf_native(bam)[0])
    cfg = Config(input=bam, reference=fa, output=str(tmp_path / "o.vcf"),
                 work_dir=str(tmp_path / "w"), genotype=True, min_support=3)
    nd = native.decode(bam, cfg, device=torch.device("cpu"))
    assert (nd.blocks_card, nd.blocks_host) == (0, n_blocks)
    assert (nd.batches_card, nd.launches_card) == (0, 0)
    stats = run_pipeline(cfg, ["x"], device="cpu")
    walks = [s["counters"] for s in stats["trace"]["spans"]
             if s["name"] == "decode.walk"]
    assert [(w["blocks_card"], w["blocks_host"]) for w in walks] == [
        (0, n_blocks)]


@pytest.mark.parametrize("level", ["zlib", "stored"])
def test_cpu_decode_of_a_stream_equals_the_files(tmp_path, level):
    """A BAM read as a stream (a FIFO, read block by block, not mapped)
    decodes on a CPU device as the file does, every block by zlib."""
    bam, _ = _tiny_bam(tmp_path)
    if level == "stored":
        bam = _stored_bam(tmp_path, bam)
    cfg = Config(input=bam)
    cpu = torch.device("cpu")
    want = native.decode(bam, cfg, device=cpu)
    fifo = str(tmp_path / "stream.bam")
    th = _stream(bam, fifo)
    got = native.decode(fifo, cfg, device=cpu)
    th.join(30)
    _assert_same_decode(got, want)
    assert (got.blocks_card, got.blocks_host) == (0, want.blocks_host)
    assert (got.batches_card, got.launches_card) == (0, 0)


# --- the kernel and the card back end (CUDA) ------------------------------

@pytest.mark.cuda
def test_kernel_equals_zlib(card):
    cases = _streams()
    src, meta = _batch([(s, len(raw)) for s, raw in cases.values()])
    before = inflate.LAUNCHES
    out, status = inflate.inflate_batch(src, meta, card)
    assert inflate.LAUNCHES == before + 1
    assert dict(zip(cases, status.tolist())) == dict.fromkeys(cases, 0)
    for name, o in zip(cases, meta[:, 2]):
        raw = cases[name][1]
        assert out[o:o + len(raw)].tobytes() == raw, name


@pytest.mark.cuda
def test_kernel_statuses_and_no_unwritten_bytes(card):
    """Each fault gives its status (a cut stream any fault: the kernel reads
    on into the next bytes before it knows); every block with status 0
    holds zlib's bytes whatever the buffer held before."""
    bad = _corrupt()
    good = _streams()
    pairs = [(s, n) for s, n, _ in bad.values()]
    pairs += [(s, len(raw)) for s, raw in good.values()]
    src, meta = _batch(pairs)
    ref, ref_status = inflate.inflate_plain(src, meta)
    srct = torch.frombuffer(bytearray(src), dtype=torch.uint8).to(card)
    metat = torch.from_numpy(meta).to(card)
    for fill in (0xAA, 0x55):
        out = torch.full((len(ref),), fill, dtype=torch.uint8, device=card)
        _, status = inflate.inflate_tensors(srct, metat, out)
        status = status.cpu().numpy()
        got = dict(zip(bad, status[:len(bad)].tolist()))
        assert got.pop("cut_short") != 0
        assert got == {name: want for name, (_, _, want) in bad.items()
                       if name != "cut_short"}
        assert np.array_equal(status, np.where(ref_status == 0, 0, status))
        assert not status[len(bad):].any()
        host = out.cpu().numpy()
        for (o, n), st in zip(meta[:, 2:].tolist(), status.tolist()):
            if st == 0:
                assert np.array_equal(host[o:o + n], ref[o:o + n])


@pytest.mark.cuda
def test_kernel_over_a_bam_equals_zlib(card, tmp_path):
    bam, _ = _tiny_bam(tmp_path, "ont.germline")
    data, meta = inflate.bgzf_batch(bam)
    src, rows = bytearray(), []
    for s, c, o, n in meta.tolist():        # payloads packed, 4-aligned
        rows.append((len(src), c, o, n))
        src += data[s:s + c] + bytes(-c % 4)
    packed = np.asarray(rows, np.int32)
    want, _ = inflate.inflate_plain(data, meta)
    got, status = inflate.inflate_batch(bytes(src), packed, card)
    assert not status.any()
    assert np.array_equal(got, want)


@pytest.mark.cuda
def test_card_decode_equals_cpu_decode(card, tmp_path):
    """A whole-BAM decode on the card (every BGZF block inflated there)
    gives every decoder output of the CPU's zlib decode, and a run on the
    card the CPU run's VCF body."""
    bam, fa = _tiny_bam(tmp_path)
    n_blocks = len(native.scan_bgzf_native(bam)[0])
    cfg = Config(input=bam, reference=fa, genotype=True, min_support=3)
    host = native.decode(bam, cfg, device=torch.device("cpu"))
    dev = native.decode(bam, cfg, device=card)
    assert (host.blocks_card, host.blocks_host) == (0, n_blocks)
    # a decode of the whole file reads on from its header's batch, so the
    # card inflates each block once, one launch a batch
    assert (dev.blocks_card, dev.blocks_host) == (n_blocks, 0)
    assert dev.launches_card == dev.batches_card >= 1
    assert dev.inflate_core_s == 0.0
    _assert_same_decode(dev, host)
    bodies = {}
    for device in ("cuda", "cpu"):
        out = tmp_path / ("%s.vcf" % device)
        run = Config(input=bam, reference=fa, output=str(out),
                     work_dir=str(tmp_path / device), genotype=True,
                     min_support=3)
        stats = run_pipeline(run, ["x"], device=device)
        walk = [s["counters"] for s in stats["trace"]["spans"]
                if s["name"] == "decode.walk"][0]
        assert (walk["blocks_card"] > 0) == (device == "cuda")
        assert (walk["blocks_host"] > 0) == (device == "cpu")
        bodies[device] = [l for l in out.read_text().splitlines()
                          if not l.startswith(("##fileDate",
                                               "##CommandLine"))]
    assert bodies["cuda"] == bodies["cpu"]
    assert sum(1 for l in bodies["cpu"] if not l.startswith("#")) >= 3


@pytest.mark.cuda
def test_card_decode_of_a_corrupt_block_fails(card, tmp_path):
    """A block that does not inflate to its ISIZE fails the card decode
    with status 5, as zlib's failure does on the CPU; nothing falls back."""
    bam, _ = _tiny_bam(tmp_path)
    data, meta = inflate.bgzf_batch(bam)
    data = bytearray(data)
    s, c, o, n = meta[len(meta) // 2].tolist()
    end = s + c + 8                       # the block's ISIZE field ends here
    data[end - 4:end] = (n - 1).to_bytes(4, "little")
    bad = tmp_path / "bad.bam"
    bad.write_bytes(bytes(data))
    cfg = Config(input=str(bad))
    for device in (torch.device("cpu"), card):
        with pytest.raises(IOError, match="status 5"):
            native.decode(str(bad), cfg, device=device)


@pytest.mark.cuda
def test_card_batches_fit_the_staging_span(card, tmp_path):
    """Stored blocks (~8 MB of compressed bytes) split into batches of at
    most the back end's 4 MiB staging span (csrc/bgzf_inflate.cu IN_CAP),
    from the mapped file and from a stream alike, one launch a batch, and
    decode as the CPU does."""
    bam = _stored_bam(tmp_path, _tiny_bam(tmp_path)[0])
    n_blocks = len(native.scan_bgzf_native(bam)[0])
    cfg = Config(input=bam)
    want = native.decode(bam, cfg, device=torch.device("cpu"))
    fifo = str(tmp_path / "stream.bam")
    th = _stream(bam, fifo)
    streamed = native.decode(fifo, cfg, device=card)
    th.join(30)
    payload = int(inflate.bgzf_batch(bam)[1][:, 1].sum())
    floor = -(-payload // (4 << 20))
    for got in (native.decode(bam, cfg, device=card), streamed):
        _assert_same_decode(got, want)
        assert (got.blocks_card, got.blocks_host) == (n_blocks, 0)
        assert got.launches_card == got.batches_card >= max(floor, 2)
