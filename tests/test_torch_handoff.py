"""Decode's hand-off between the native decoder and the main thread.

On the CPU: ``StreamingDecode.wait`` (the decoder's ``bamdecode_wait``)
returns once the progress passes what the caller has seen, at DONE, or at
its timeout, and releases the GIL while it sleeps; a streaming run whose
main thread falls behind the decoder (chromosomes pile up for the DONE
batch) writes the plain decode's VCF and counts the DONE batch's
chromosomes; an exception in the poll loop frees the decoder and leaves
no thread of it running. On a CUDA GPU (marker ``cuda``) the card path's
submitter thread, which stages and launches the batches: the decode equals
the CPU's, from the mapped file and from a stream; a lying ISIZE fails
with status 5 and leaves no thread running; two decodes in a row reuse
the back end. This file imports neither jax nor the JAX package, so on a
GPU machine without JAX the card tests run as

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_handoff.py -q
"""
import json
import os
import subprocess
import sys
import threading
import time

import pytest
import torch

from cutesv_tpu_torch import pipeline, sigstore
from cutesv_tpu_torch.config import Config
from cutesv_tpu_torch.io import native
from cutesv_tpu_torch.ops import inflate
from test_torch_inflate import _assert_same_decode, _stream, _tiny_bam

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# a child process (the decoder reads its pacing once per process) that
# waits on a decode paced to sleep after its one batch of records
_WAIT_CHILD = r"""
import json, sys, threading, time
import torch
from cutesv_tpu_torch.config import Config
from cutesv_tpu_torch.io import native

bam = sys.argv[1]
sd = native.StreamingDecode(bam, Config(input=bam), device=torch.device("cpu"))
out = {}
try:
    t0 = time.monotonic()
    seen = sd.wait(-1, 20000)
    out["first"] = [seen, time.monotonic() - t0]
    ticks, stop = [], []

    def spin():
        while not stop:
            ticks.append(time.monotonic())

    th = threading.Thread(target=spin)
    th.start()
    time.sleep(0.02)
    t0 = time.monotonic()
    got = sd.wait(seen, 300)
    t1 = time.monotonic()
    stop.append(1)
    th.join()
    out["stalled"] = [got, t1 - t0,
                      sum(1 for t in ticks if t0 + 0.05 < t < t1 - 0.05)]
    steps = []
    while seen != sd.DONE:
        t0 = time.monotonic()
        got = sd.wait(seen, 20000)
        steps.append([seen, got, time.monotonic() - t0])
        seen = got
    out["steps"] = steps
    t0 = time.monotonic()
    out["after"] = [sd.wait(sd.DONE, 20000), sd.wait(0, 20000),
                    time.monotonic() - t0]
    sd.join()
finally:
    sd.free()
print(json.dumps(out))
"""


def _threads() -> int:
    return len(os.listdir("/proc/self/task"))


def _card_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (a hand-written kernel has no CPU "
                    "mode)")
    return torch.device("cuda")


def _device(name):
    return _card_or_skip() if name == "cuda" else torch.device("cpu")


def _cfg(bam, fa, tmp_path, tag):
    return Config(input=bam, reference=fa, output=str(tmp_path / (tag
                                                                 + ".vcf")),
                  work_dir=str(tmp_path / ("w" + tag)), genotype=True,
                  min_support=3, engine="device", decoder="native")


def _body(path):
    return [l for l in open(path).read().splitlines()
            if not l.startswith(("##fileDate", "##CommandLine"))]


def _chrom_spans(stats):
    return [s for s in stats["trace"]["spans"]
            if s["name"] == "decode.dispatch" and "chroms" in s["counters"]]


def _corrupt_bam(tmp_path):
    """The tiny BAM, and a copy of it with one block's ISIZE one byte
    short."""
    bam, _ = _tiny_bam(tmp_path)
    data, meta = inflate.bgzf_batch(bam)
    data = bytearray(data)
    s, c, o, n = meta[len(meta) // 2].tolist()
    end = s + c + 8                       # the block's ISIZE field ends here
    data[end - 4:end] = (n - 1).to_bytes(4, "little")
    bad = tmp_path / "bad.bam"
    bad.write_bytes(bytes(data))
    return bam, str(bad)


# --- the wait, and the poll loop that uses it (CPU) ----------------------

def test_wait_returns_on_progress_on_done_and_on_its_timeout(tmp_path):
    """The decode publishes its one batch's chromosome, then sleeps 3 s
    before DONE: the first wait returns that chromosome at once, a wait
    past it returns at its 300 ms timeout with the same value while
    another Python thread runs (the GIL is released), and the next
    returns DONE as the decode ends, long before its own timeout; at DONE
    every wait returns at once."""
    bam, _ = _tiny_bam(tmp_path)
    env = dict(os.environ, CUTESV_DECODE_CHUNK_DELAY_MS="3000",
               PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", _WAIT_CHILD, bam],
                          capture_output=True, text=True, env=env,
                          timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    done = native.StreamingDecode.DONE
    first, first_s = out["first"]
    assert 0 <= first < done and first_s < 2.5
    got, stalled_s, ticks = out["stalled"]
    assert got == first
    assert 0.29 <= stalled_s < 2.5
    assert ticks > 0
    assert out["steps"] and out["steps"][-1][1] == done
    for seen, got, seconds in out["steps"]:
        assert got > seen and seconds < 15
    assert out["after"][:2] == [done, done] and out["after"][2] < 1.0


@pytest.mark.parametrize("late", ["first_poll", "every_dispatch"])
def test_slow_main_thread_gives_the_plain_decodes_output(tmp_path,
                                                         monkeypatch, late):
    """A streaming run whose main thread falls behind the decoder (its
    first poll only once the decode is DONE, or 50 ms added to every
    chromosome's prepare) writes the plain decode's VCF from the same
    signatures, its store reuses every early program, it dispatches each
    chromosome once, and it counts those of the DONE batch: all three
    when the loop starts late."""
    bam, fa = _tiny_bam(tmp_path)
    monkeypatch.setenv("CUTESV_STREAM_DISPATCH", "0")
    plain = pipeline.run_pipeline(_cfg(bam, fa, tmp_path, "plain"), ["x"],
                                  device="cpu")
    assert not _chrom_spans(plain)
    monkeypatch.setenv("CUTESV_STREAM_DISPATCH", "1")
    if late == "first_poll":
        real = native.StreamingDecode.poll

        def poll(self):
            while real(self) != self.DONE:
                time.sleep(0.005)
            return real(self)
        monkeypatch.setattr(native.StreamingDecode, "poll", poll)
    else:
        real = sigstore.prepare_snapshot

        def prepare(*a, **k):
            time.sleep(0.05)
            return real(*a, **k)
        monkeypatch.setattr(sigstore, "prepare_snapshot", prepare)
    stats = pipeline.run_pipeline(_cfg(bam, fa, tmp_path, "stream"), ["x"],
                                  device="cpu")
    assert _body(tmp_path / "stream.vcf") == _body(tmp_path / "plain.vcf")
    assert sum(1 for l in _body(tmp_path / "plain.vcf")
               if not l.startswith("#")) >= 3
    assert stats["n_sigs"] == plain["n_sigs"]
    assert stats["n_records"] == plain["n_records"]
    # the store took every early program and tail: each snapshot validated
    assert stats["early_dispatched"] >= 3
    assert stats["early_kernels"] + stats["early_tails"] == \
        stats["early_dispatched"]
    chroms = _chrom_spans(stats)
    assert sum(s["counters"]["chroms"] for s in chroms) == 3
    done_batch = sum(s["counters"]["chroms"] for s in chroms
                     if s["counters"]["done"] == 1)
    assert done_batch == 3 if late == "first_poll" else done_batch >= 1


@pytest.mark.parametrize("device", [
    "cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_poll_loop_exception_frees_the_decoder(tmp_path, monkeypatch,
                                               device):
    """An exception in the poll loop's dispatch reaches the caller, frees
    the decoder (its thread, pools and, on the card, submitter joined)
    and leaves the back end free for the next decode."""
    dev = _device(device)
    bam, fa = _tiny_bam(tmp_path)
    monkeypatch.setenv("CUTESV_STREAM_DISPATCH", "1")
    pipeline.run_pipeline(_cfg(bam, fa, tmp_path, "warm"), ["x"],
                          device=dev)

    def planted(*a, **k):
        raise RuntimeError("planted dispatch failure")
    with monkeypatch.context() as mp:
        mp.setattr(sigstore, "prepare_snapshot", planted)
        # the first failure also starts whatever pools the libraries make
        # on first use; the second may start no thread that outlives it
        for k in range(2):
            before = _threads()
            with pytest.raises(RuntimeError, match="planted"):
                pipeline.run_pipeline(_cfg(bam, fa, tmp_path, "bad%d" % k),
                                      ["x"], device=dev)
    assert _threads() <= before
    done = []
    th = threading.Thread(target=lambda: done.append(
        native.decode(bam, Config(input=bam), device=dev)), daemon=True)
    th.start()
    th.join(120)
    assert done and done[0].n_records > 0


# --- the submitter (CUDA) ----------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("source", ["mapped", "stream"])
@pytest.mark.parametrize("workload", ["hifi.germline", "ont.germline"])
def test_card_decode_with_the_submitter_equals_cpu(tmp_path, workload,
                                                   source):
    """Every block of a corpus BAM inflates on the card, one launch a batch
    the submitter staged, and the decode equals the CPU's, read from the
    mapped file or from a FIFO."""
    card = _card_or_skip()
    bam, _ = _tiny_bam(tmp_path, workload)
    n_blocks = len(native.scan_bgzf_native(bam)[0])
    cfg = Config(input=bam)
    want = native.decode(bam, cfg, device=torch.device("cpu"))
    path, th = bam, None
    if source == "stream":
        path = str(tmp_path / "stream.bam")
        th = _stream(bam, path)
    got = native.decode(path, cfg, device=card)
    if th is not None:
        th.join(30)
    _assert_same_decode(got, want)
    assert (got.blocks_card, got.blocks_host) == (n_blocks, 0)
    assert got.launches_card == got.batches_card >= 1


@pytest.mark.cuda
@pytest.mark.parametrize("streaming", [False, True])
def test_card_lying_isize_fails_with_every_thread_joined(tmp_path,
                                                         streaming):
    """A block that does not inflate to its ISIZE fails the card decode with
    status 5, plain or streaming, and no thread of the decoder (its
    submitter included) is left running."""
    card = _card_or_skip()
    bam, bad = _corrupt_bam(tmp_path)
    cfg = Config(input=bad)
    native.decode(bam, cfg, device=card)   # the back end made, warm
    for k in range(2):      # as in the poll loop's test: the second counts
        before = _threads()
        with pytest.raises(IOError, match="status 5"):
            if streaming:
                with native.StreamingDecode(bad, cfg, device=card) as sd:
                    while sd.wait(-1, 1000) != sd.DONE:
                        pass
                    sd.join()
            else:
                native.decode(bad, cfg, device=card)
    assert _threads() <= before


@pytest.mark.cuda
def test_two_card_decodes_reuse_the_back_end(tmp_path):
    """The back end is made once and taken again: two decodes in a row on
    the card use one table, count their own launches, and equal the CPU's
    decode."""
    card = _card_or_skip()
    bam, _ = _tiny_bam(tmp_path)
    cfg = Config(input=bam)
    want = native.decode(bam, cfg, device=torch.device("cpu"))
    table = inflate.card_table(card)
    runs = [native.decode(bam, cfg, device=card) for _ in range(2)]
    assert inflate.card_table(card) == table
    for got in runs:
        _assert_same_decode(got, want)
        assert got.launches_card == got.batches_card >= 1
    assert runs[0].launches_card == runs[1].launches_card
