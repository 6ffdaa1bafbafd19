"""The port's CRAM input against the JAX package's, on the CPU.

* ``cutesv_tpu_torch.io.cram.CramWriter`` writes the same bytes as
  ``cutesv_tpu.io.cram.CramWriter`` (the writer profiles of
  tests/test_native_cram.py, CRAM 3.0 and 3.1), and the port's
  ``CramReader`` yields the same records as the JAX package's.
* The port's native decoder gives the same ``NativeDecode`` on a CRAM as
  on the BAM it was made from, field by field, and its block codecs
  (``native.block_decode``) equal the port's Python codecs.
* Pipeline VCF bodies on a CRAM (Python reader, native plain, native
  streaming; ``--device cpu``) equal the JAX package's on the same CRAM
  and the port's on the BAM; a CRAM feature the native decoder does not
  implement is read by the Python reader and reported as such.
All comparisons are exact.
"""
import dataclasses
import random

import pytest

import chip_smoke
from cutesv_tpu import pipeline as jpipe
from cutesv_tpu.config import Config as JConfig
from cutesv_tpu.io import cram as jcram
from cutesv_tpu.io.bam import BamReader
from cutesv_tpu_torch import pipeline as tpipe
from cutesv_tpu_torch.config import Config as TConfig
from cutesv_tpu_torch.io import cram as tcram
from cutesv_tpu_torch.io import native as tnative
from cutesv_tpu_torch.io.cram_codecs import rans_encode_o0, rans_encode_o1
from cutesv_tpu_torch.io.cram_codecs31 import (AR_CAT, AR_ORDER1, AR_PACK,
                                               AR_RLE, AR_STRIPE, NX_CAT,
                                               NX_N32, NX_ORDER1, NX_PACK,
                                               NX_RLE, NX_STRIPE,
                                               arith_decode, arith_encode,
                                               fqz_decode, fqz_encode,
                                               name_tok_decode,
                                               name_tok_encode,
                                               rans_nx16_decode,
                                               rans_nx16_encode)
from cutesv_tpu_torch.io.fasta import write_fasta
from tests.test_cram import _write_recompressed_cram
from tests.test_e2e_alltypes import _build as build_alltypes
from tests.test_engine_equivalence import _strip_volatile
from tests.test_native_cram import _random_ref
from tests.test_native_decoder import _make_random_bam, _native_tuples

# the writer profiles of tests/test_native_cram.py
PROFILES = [(0, False, {}), (0, True, {}), (1, False, {}), (2, True, {}),
            (3, True, dict(core_series=True)),
            (4, False, dict(core_series=True)),
            (5, True, dict(detached_mates=True)),
            (6, True, dict(multi_ref=True)),
            (7, False, dict(core_series=True, detached_mates=True,
                            multi_ref=True)),
            (8, True, dict(rans_order=1)),
            (9, False, dict(rans_order=1, core_series=True))]


def _write_cram(module, bam, cram, ref_seqs=None, **kwargs):
    """``bam`` re-encoded as CRAM by ``module``'s CramWriter (the JAX
    package's or the port's); returns the header references."""
    with BamReader(str(bam)) as r:
        refs = r.references
        with module.CramWriter(str(cram), refs, ref_seqs=ref_seqs,
                               **kwargs) as w:
            for rec in r:
                w.write(rec)
    return refs


def _random_corpus(tmp_path, seed, n_reads=120):
    """A random BAM (tests/test_native_decoder.py) and a random FASTA of
    its references: (bam, fasta path, {chrom: sequence})."""
    rng = random.Random(seed)
    bam = tmp_path / "r.bam"
    fa = tmp_path / "r.fa"
    _make_random_bam(str(bam), rng, n_reads=n_reads)
    with BamReader(str(bam)) as r:
        seqs = _random_ref(rng, r.references)
    write_fasta(str(fa), seqs)
    return bam, fa, seqs


def _profile_crams(tmp_path, profile, version, writers=("jax", "port")):
    """A profile's BAM, FASTA and CRAM by each of ``writers``."""
    seed, ref_based, kwargs = profile
    bam, fa, seqs = _random_corpus(tmp_path, seed)
    paths = {}
    for tag, module in (("jax", jcram), ("port", tcram)):
        if tag not in writers:
            continue
        paths[tag] = tmp_path / ("%s.cram" % tag)
        _write_cram(module, bam, paths[tag],
                    ref_seqs=seqs if ref_based else None, version=version,
                    **kwargs)
    return bam, fa, paths


@pytest.mark.parametrize("version", [(3, 0), (3, 1)], ids=["3.0", "3.1"])
@pytest.mark.parametrize("profile", PROFILES,
                         ids=["p%d" % i for i in range(len(PROFILES))])
def test_writer_bytes_equal_jax(tmp_path, profile, version):
    _, _, paths = _profile_crams(tmp_path, profile, version)
    got = paths["port"].read_bytes()
    assert got[:6] == b"CRAM" + bytes(version)
    assert got == paths["jax"].read_bytes()


def _records(reader):
    with reader as r:
        return [dataclasses.astuple(rec) for rec in r]


@pytest.mark.parametrize("version", [(3, 0), (3, 1)], ids=["3.0", "3.1"])
@pytest.mark.parametrize("profile", PROFILES[::2],
                         ids=["p%d" % i for i in range(0, len(PROFILES), 2)])
def test_reader_records_equal_jax(tmp_path, profile, version):
    bam, fa, paths = _profile_crams(tmp_path, profile, version, ("port",))
    got = _records(tcram.CramReader(str(paths["port"]), reference=str(fa)))
    assert got == _records(jcram.CramReader(str(paths["port"]),
                                            reference=str(fa)))
    assert len(got) == 120
    # and the records are the BAM's, through the port's dispatching opener
    assert [r[:4] for r in got] == [
        r[:4] for r in _records(tcram.open_alignment_file(str(bam)))]


def _assert_same_decode(nd_bam, nd_cram):
    """The checks of tests/test_native_cram.py::_assert_same_decode."""
    assert nd_cram.names == nd_bam.names
    assert nd_cram.chroms == nd_bam.chroms
    assert list(nd_cram.ref_lengths) == list(nd_bam.ref_lengths)
    assert nd_cram.n_records == nd_bam.n_records
    assert _native_tuples(nd_cram) == _native_tuples(nd_bam)
    for key in nd_bam.arrays:
        assert list(nd_cram.arrays[key]) == list(nd_bam.arrays[key]), key
    assert nd_cram.ins_seq_blob == nd_bam.ins_seq_blob


@pytest.mark.parametrize("version", [(3, 0), (3, 1)], ids=["3.0", "3.1"])
@pytest.mark.parametrize("profile", PROFILES,
                         ids=["p%d" % i for i in range(len(PROFILES))])
def test_native_decode_cram_equals_bam(tmp_path, profile, version):
    bam, fa, paths = _profile_crams(tmp_path, profile, version, ("port",))
    cfg = TConfig(input=str(bam), min_support=3)
    nd_bam = tnative.decode(str(bam), cfg)
    nd_cram = tnative.decode(str(paths["port"]), cfg, reference=str(fa))
    _assert_same_decode(nd_bam, nd_cram)
    assert nd_bam.n_records > 0


# ---------------------------------------------------------------------------
# block codecs: native vs the port's Python codecs
# ---------------------------------------------------------------------------

NX_FLAGS = [0, NX_ORDER1, NX_N32, NX_ORDER1 | NX_N32, NX_RLE, NX_PACK,
            NX_RLE | NX_PACK | NX_ORDER1, NX_STRIPE,
            NX_STRIPE | NX_ORDER1, NX_CAT]
AR_FLAGS = [0, AR_ORDER1, AR_RLE, AR_PACK, AR_RLE | AR_PACK | AR_ORDER1,
            AR_STRIPE, AR_STRIPE | AR_ORDER1, AR_CAT]


def _rnd(rng, n, alphabet=256):
    return bytes(rng.randrange(alphabet) for _ in range(n))


def test_block_decode_legacy_methods():
    import bz2
    import lzma
    import zlib

    rng = random.Random(1000)
    for data in (b"", b"x", _rnd(rng, 4000, 7), _rnd(rng, 2500)):
        co = zlib.compressobj(6, zlib.DEFLATED, 31)
        assert tnative.block_decode(0, data, len(data)) == data
        assert tnative.block_decode(1, co.compress(data) + co.flush(),
                                    len(data)) == data
        assert tnative.block_decode(2, bz2.compress(data), len(data)) == data
        assert tnative.block_decode(
            3, lzma.compress(data, format=lzma.FORMAT_XZ), len(data)) == data
        if data:
            for enc in (rans_encode_o0, rans_encode_o1):
                assert tnative.block_decode(4, enc(data), len(data)) == data


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("method", ["nx16", "arith", "fqz", "name_tok"])
def test_block_decode_equals_python(method, seed):
    rng = random.Random(41000 + 97 * seed + len(method))
    for _ in range(4):
        if method == "nx16":
            n = rng.randrange(0, 3000)
            data = _rnd(rng, n, rng.randrange(1, 257))
            enc = rans_nx16_encode(data, rng.choice(NX_FLAGS))
            assert rans_nx16_decode(enc, n) == data
            code = 5
        elif method == "arith":
            n = rng.randrange(0, 2500)
            data = _rnd(rng, n, rng.randrange(1, 257))
            enc = arith_encode(data, rng.choice(AR_FLAGS))
            assert arith_decode(enc, n) == data
            code = 6
        elif method == "fqz":
            lens = [rng.randrange(1, 200)
                    for _ in range(rng.randrange(1, 25))]
            data = _rnd(rng, sum(lens), rng.randrange(1, 250))
            enc = fqz_encode(data, lens, dedup=bool(rng.random() < 0.5))
            assert fqz_decode(enc, len(data)) == data
            code = 7
        else:
            names = [("r%d_%d:%s" % (rng.randrange(10 ** 9), k,
                                     rng.choice("abXY_/"))).encode()
                     for k in range(rng.randrange(0, 60))]
            data = b"".join(x + b"\x00" for x in names)
            enc = name_tok_encode(data)
            assert name_tok_decode(enc) == data
            code = 8
        assert tnative.block_decode(code, enc, len(data)) == data


def test_block_decode_corrupt_raises_on_both_stacks():
    rng = random.Random(7005)
    data = _rnd(rng, 600, 60)
    enc = rans_nx16_encode(data, NX_ORDER1)
    for _ in range(25):
        blob = bytearray(enc)
        for _ in range(3):
            blob[rng.randrange(len(blob))] = rng.randrange(256)
        blob = bytes(blob)
        try:
            py = rans_nx16_decode(blob, len(data))
        except ValueError:
            py = None
        try:
            nat = tnative.block_decode(5, blob, len(data))
        except ValueError:
            nat = None
        assert py == nat




# ---------------------------------------------------------------------------
# the pipeline on a CRAM
# ---------------------------------------------------------------------------

def _alltypes_cram(tmp_path, version):
    """The all-types fixture (tests/test_e2e_alltypes.py) and its
    reference-based CRAM, written by the port in small slices."""
    bam, fa = build_alltypes(tmp_path)
    cram = tmp_path / "all.cram"
    chip_smoke.write_cram(str(bam), str(fa), str(cram), version,
                          max_slice=200)
    return bam, fa, cram


def _port_run(inp, fa, tmp_path, tag, decoder, monkeypatch, stream="0",
              **kw):
    """The port's pipeline on the CPU: (VCF body, stats)."""
    monkeypatch.setenv("CUTESV_STREAM_DISPATCH", stream)
    out = tmp_path / ("%s.vcf" % tag)
    cfg = TConfig(input=str(inp), reference=str(fa), output=str(out),
                  work_dir=str(tmp_path / ("wd_" + tag)), genotype=True,
                  min_support=3, decoder=decoder, **kw)
    stats = tpipe.run_pipeline(cfg, ["x"], device="cpu")
    return _strip_volatile(out.read_text()), stats


def _jax_run(inp, fa, tmp_path, tag, **kw):
    """The JAX package's pipeline (python reader, host engine)."""
    out = tmp_path / ("%s.vcf" % tag)
    cfg = JConfig(input=str(inp), reference=str(fa), output=str(out),
                  work_dir=str(tmp_path / ("wd_" + tag)), genotype=True,
                  min_support=3, engine="host", decoder="python", **kw)
    jpipe.run_pipeline(cfg, ["x"])
    return _strip_volatile(out.read_text())


@pytest.mark.parametrize("version", [(3, 0), (3, 1)], ids=["3.0", "3.1"])
def test_pipeline_cram_bodies_equal(tmp_path, monkeypatch, version):
    bam, fa, cram = _alltypes_cram(tmp_path, version)
    want = _jax_run(cram, fa, tmp_path, "jax")
    assert len([l for l in want.splitlines() if l[:1] != "#"]) >= 4
    runs = {"python": ("python", "0"), "native": ("native", "0"),
            "native_stream": ("native", "1")}
    for tag, (decoder, stream) in runs.items():
        body, stats = _port_run(cram, fa, tmp_path, tag, decoder,
                                monkeypatch, stream)
        assert body == want, tag
        assert stats["decoder"] == decoder, tag
        assert bool(stats.get("streaming")) == (stream == "1"), tag
    assert _port_run(bam, fa, tmp_path, "bam", "native",
                     monkeypatch)[0] == want


@pytest.mark.parametrize("decoder", ["native", "auto"])
def test_lzma_alone_cram_takes_the_python_reader(tmp_path, monkeypatch,
                                                 decoder):
    """A legacy lzma-"alone" block is a CRAM feature the C++ decoder does
    not implement: the port reads the file with the Python reader, as the
    JAX package does, and says so in its stats."""
    import lzma

    bam, fa, cram = _write_recompressed_cram(
        tmp_path, monkeypatch, 3,
        lambda d: lzma.compress(d, format=lzma.FORMAT_ALONE),
        b"\x5d\x00\x00")
    with pytest.raises(tnative.NativeUnsupported):
        tnative.decode(str(cram), TConfig(input=str(cram)),
                       reference=str(fa))
    body, stats = _port_run(cram, fa, tmp_path, "cram", decoder,
                            monkeypatch, "1")
    assert stats["decoder"] == "python"
    assert body == _port_run(bam, fa, tmp_path, "bam", decoder,
                             monkeypatch)[0]
    assert body == _jax_run(cram, fa, tmp_path, "jax")
    assert "SVTYPE=DEL" in body


@pytest.mark.parametrize("codec", ["bzip2", "xz"])
def test_bzip2_xz_cram_stays_native(tmp_path, monkeypatch, codec):
    """bzip2 and xz-framed blocks are the C++ decoder's own: no route to
    the Python reader, and the body equals the BAM's."""
    import bz2
    import lzma

    method, compress, magic = {
        "bzip2": (2, bz2.compress, b"BZh"),
        "xz": (3, lambda d: lzma.compress(d, format=lzma.FORMAT_XZ),
               b"\xfd7zXZ\x00")}[codec]
    bam, fa, cram = _write_recompressed_cram(tmp_path, monkeypatch, method,
                                             compress, magic)
    body, stats = _port_run(cram, fa, tmp_path, "cram", "native",
                            monkeypatch)
    assert stats["decoder"] == "native"
    assert body == _port_run(bam, fa, tmp_path, "bam", "native",
                             monkeypatch)[0]


def _small_cram(tmp_path, seed, n_reads=40, ref_based=False):
    bam, fa, seqs = _random_corpus(tmp_path, seed, n_reads)
    cram = tmp_path / "s.cram"
    _write_cram(tcram, bam, cram, ref_seqs=seqs if ref_based else None)
    return bam, fa, cram


def test_cram_v2_raises_major_version(tmp_path):
    """CRAM 2.x: the C++ decoder reports it unsupported, the Python
    reader raises the JAX package's "major version 2" error."""
    _, fa, cram = _small_cram(tmp_path, 3)
    raw = bytearray(cram.read_bytes())
    raw[4] = 2
    cram.write_bytes(bytes(raw))
    with pytest.raises(tnative.NativeUnsupported):
        tnative.decode(str(cram), TConfig(input=str(cram)),
                       reference=str(fa))
    for decoder in ("auto", "native", "python"):
        cfg = TConfig(input=str(cram), reference=str(fa), decoder=decoder,
                      min_support=3)
        with pytest.raises(ValueError, match="major version 2.*version=3.0"):
            tpipe.decode_bam(cfg, device="cpu")


def _outcome(fn):
    try:
        nd = fn()
    except IOError:
        return "raised"
    return nd.n_records


@pytest.mark.parametrize("seed", range(6))
def test_corrupt_cram_raises_not_crash(tmp_path, seed):
    """Byte-flipped CRAMs: the port's C++ decoder rejects or decodes them
    as the JAX package's does, and the port's Python reader fails with a
    typed error (the checks of tests/test_native_cram.py and
    tests/test_cram.py)."""
    from cutesv_tpu.config import Config as JC
    from cutesv_tpu.io import native as jnative

    rng = random.Random(900 + seed)
    _, fa, cram = _small_cram(tmp_path, seed)
    raw = bytearray(cram.read_bytes())
    for _ in range(rng.randrange(1, 40)):
        raw[rng.randrange(len(raw))] = rng.randrange(256)
    cram.write_bytes(bytes(raw))
    got = _outcome(lambda: tnative.decode(str(cram), TConfig(input=str(cram)),
                                          reference=str(fa)))
    assert got == _outcome(lambda: jnative.decode(
        str(cram), JC(input=str(cram)), reference=str(fa)))
    try:
        n = sum(1 for _ in tcram.CramReader(str(cram), reference=str(fa)))
        assert n >= 0
    except (ValueError, IOError, EOFError, KeyError, AssertionError):
        pass


def test_cram_without_reference_raises(tmp_path):
    """A reference-based CRAM needs its FASTA: the C++ decoder reports it
    unsupported, and the Python reader then raises the error the JAX
    package raises."""
    _, fa, cram = _small_cram(tmp_path, 4, ref_based=True)
    with pytest.raises(tnative.NativeUnsupported):
        tnative.decode(str(cram), TConfig(input=str(cram)))
    with pytest.raises(ValueError) as want:
        jpipe.decode_bam(JConfig(input=str(cram), reference="",
                                 min_support=3))
    with pytest.raises(ValueError) as got:
        tpipe.decode_bam(TConfig(input=str(cram), reference="",
                                 min_support=3), device="cpu")
    assert str(got.value) == str(want.value)
    assert "requires the reference FASTA" in str(got.value)


def test_include_bed_on_cram_equals_jax(tmp_path, monkeypatch):
    bam, fa, cram = _alltypes_cram(tmp_path, (3, 0))
    bed = tmp_path / "inc.bed"
    bed.write_text("chr1\t8000\t32000\nchr2\t100\t200\n")
    want = _jax_run(cram, fa, tmp_path, "jax", include_bed=str(bed))
    body = [l for l in want.splitlines() if l[:1] != "#"]
    assert {l.split("SVTYPE=")[1].split(";")[0] for l in body} == \
        {"DEL", "DUP", "INV"}
    for tag, (decoder, stream) in {"python": ("python", "0"),
                                   "native": ("native", "0"),
                                   "native_stream": ("native", "1")}.items():
        assert _port_run(cram, fa, tmp_path, tag, decoder, monkeypatch,
                         stream, include_bed=str(bed))[0] == want, tag


@pytest.mark.parametrize("codecs", [dict(arith=True), dict(fqz=True),
                                    dict(arith=True, fqz=True)],
                         ids=["arith", "fqz", "arith+fqz"])
def test_writer_31_codecs_bytes_equal_jax(tmp_path, codecs):
    """CRAM 3.1 with the adaptive arithmetic coder and fqzcomp qualities:
    the port's writer writes the JAX package's bytes and its reader reads
    the BAM's records back."""
    bam, fa, seqs = _random_corpus(tmp_path, 11, n_reads=40)
    paths = {}
    for tag, module in (("jax", jcram), ("port", tcram)):
        paths[tag] = tmp_path / ("%s.cram" % tag)
        _write_cram(module, bam, paths[tag], ref_seqs=seqs, version=(3, 1),
                    store_quals=True, **codecs)
    assert paths["port"].read_bytes() == paths["jax"].read_bytes()
    got = _records(tcram.CramReader(str(paths["port"]), reference=str(fa)))
    assert [r[:4] for r in got] == [
        r[:4] for r in _records(tcram.open_alignment_file(str(bam)))]
