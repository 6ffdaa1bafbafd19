"""The benchmark's corpus: a random genome, planted SVs and the reads of
one sample, made from ``--seed`` and written as a FASTA and a
coordinate-sorted BAM.

Everything that varies between cells is data: the configuration (genome
layout and read model of a sequencing platform, ``configs/*.json``) and
the traffic (the SVs planted, ``traffic/*.json``). One contig is one
unit of work: :func:`contig_plan` makes its reference and its reads'
alignments (a :class:`Plan`) from ``(seed, contig)`` alone, so contigs
are made in parallel processes, and the plain reference rebuilds the
same plans after the timed window instead of reading them back.

The shapes are those of the repo's simulators (``simulate``,
``simulate_messy``, ``replay`` and the all-types grid), rewritten with
NumPy over whole contigs: reads carry DEL/INS SVs and noise as CIGAR
indels, and DUP/INV/BND carriers are two-segment split reads (a primary
alignment with a soft clip and an ``SA`` tag), as ``replay`` plants them.
The BAM writer is this module's own (``encode_records``, ``bgzf``).
"""
from __future__ import annotations

import os
import struct
import zlib
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np

OP_M, OP_I, OP_D, OP_S = 0, 1, 2, 4
# nt16 code of A, C, G, T (the BAM's 4-bit SEQ encoding)
_NT16 = np.array([1, 2, 4, 8], np.uint8)
BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")
BGZF_BLOCK = 0xFF00
FLANK = 1000          # replay's split-carrier flank
ZONE = 50             # clearance around a kept event for lesser events
END_MARGIN = 600      # no noise within this many bp of a read's ends


def rng_for(seed: int, *path: int) -> np.random.Generator:
    """The generator of one part of the corpus: the same (seed, path)
    always draws the same numbers, whatever else is made."""
    return np.random.default_rng([int(seed) % (1 << 63), *path])


def contig_sizes(config: dict) -> List[int]:
    g = config["genome"]
    return [int(mb * 1_000_000 // g["divisor"]) for mb in g["source_mb"]]


def contig_ref(seed: int, ci: int, size: int) -> np.ndarray:
    """Base codes (0-3 = ACGT) of contig ``ci``."""
    return rng_for(seed, 1, ci).integers(0, 4, size=size, dtype=np.uint8)


def codes_to_bytes(codes) -> bytes:
    return np.frombuffer(b"ACGT", np.uint8)[codes].tobytes()


# ---------------------------------------------------------------------------
# planted SVs
# ---------------------------------------------------------------------------

def _draw_len(rng, spec) -> int:
    lo, hi, dist = spec
    if dist == "loguniform":
        return int(round(np.exp(rng.uniform(np.log(lo), np.log(hi)))))
    return int(rng.integers(lo, hi))


def sv_plan(seed: int, ci: int, sizes: List[int], traffic: dict) -> List[dict]:
    """The SVs planted on contig ``ci``: one every ``spacing`` bp from
    ``margin`` to the contig's end less ``margin``, the kinds in turn.
    A BND is a reciprocal translocation whose mate lies on one of the
    next two contigs."""
    sv = traffic["sv"]
    rng = rng_for(seed, 2, ci)
    n = sizes[ci]
    kinds = sv["kinds"]
    out = []
    for k, s in enumerate(range(sv["margin"], n - sv["margin"],
                                sv["spacing"])):
        kind = kinds[k % len(kinds)]
        ln = _draw_len(rng, sv["len"][kind])
        hom = bool(rng.random() < sv["hom_fraction"])
        rec = dict(kind=kind, s=s, len=ln, hom=hom,
                   e=s if kind == "INS" else s + ln)
        if kind == "INS":
            rec["seq"] = rng.integers(0, 4, size=ln, dtype=np.uint8)
        elif kind == "BND":
            ci2 = (ci + 1 + (k // len(kinds)) % 2) % len(sizes)
            rec.update(ci2=ci2,
                       p2=int(rng.integers(sv["margin"],
                                           sizes[ci2] - sv["margin"] - ln)),
                       s1="fr"[int(rng.integers(0, 2))],
                       s2="fr"[int(rng.integers(0, 2))])
        out.append(rec)
    return out


def bnd_breakends(start: int, end: int, start2: int, s1: str, s2: str):
    """The breakend pairs of a reciprocal translocation, one carrier
    cluster each (``tools/simulate.py::_bnd_breakends``)."""
    d = end - start
    if s1 == "f":
        if s2 == "f":
            return [(start, start2), (end, start2 + d)]
        return [(start, start2), (start, start2 + d),
                (end, start2), (end, start2 + d)]
    if s2 == "f":
        return [(start, start2 + d), (start, start2),
                (end, start2), (end, start2 + d)]
    return [(start, start2 + d), (end, start2)]


# ---------------------------------------------------------------------------
# the alignments of one contig
# ---------------------------------------------------------------------------

@dataclass
class Plan:
    """The records of one contig, sorted by position. Op ``k`` of record
    ``r`` is ``ops[op_off[r] + k]``; its bases come from the contig's
    reference at ``src`` (M), from ``pool`` at ``src`` (I, S), or from
    nowhere (D, src -1)."""
    chrom: str
    pos: np.ndarray
    flag: np.ndarray
    mapq: np.ndarray
    names: List[str]
    op_off: np.ndarray
    ops: np.ndarray
    lens: np.ndarray
    src: np.ndarray
    pool: np.ndarray
    sa: Dict[int, str] = field(default_factory=dict)

    def __len__(self):
        return len(self.pos)

    def cigar(self, r: int):
        lo, hi = self.op_off[r], self.op_off[r + 1]
        return list(zip(self.ops[lo:hi].tolist(), self.lens[lo:hi].tolist()))

    def query(self, r: int, ref: np.ndarray) -> np.ndarray:
        """Base codes of record ``r``'s query sequence."""
        lo, hi = self.op_off[r], self.op_off[r + 1]
        parts = []
        for op, ln, s in zip(self.ops[lo:hi], self.lens[lo:hi],
                             self.src[lo:hi]):
            if op == OP_M:
                parts.append(ref[s:s + ln])
            elif op in (OP_I, OP_S):
                parts.append(self.pool[s:s + ln])
        return np.concatenate(parts)


class _Table:
    """Records under construction (one kind at a time)."""

    def __init__(self):
        self.pos, self.flag, self.mapq, self.names = [], [], [], []
        self.cigars, self.sa = [], []

    def add(self, pos, flag, mapq, name, cigar, sa=None):
        self.pos.append(pos)
        self.flag.append(flag)
        self.mapq.append(mapq)
        self.names.append(name)
        self.cigars.append(cigar)   # [(op, len, src)]
        self.sa.append(sa)


def _read_lengths(rng, spec, n):
    if spec["dist"] == "normal":
        x = rng.normal(spec["mean"], spec["sd"], n)
    else:
        x = np.exp(rng.normal(np.log(spec["median"]), spec["sigma"], n))
    return np.clip(x, spec["min"], spec["max"]).astype(np.int64)


def _layout_reads(rng, n: int, reads: dict):
    """Starts and reference spans of the background reads: uniform starts
    at the mean coverage, or a walk whose step follows a coverage wave
    (``simulate_messy``'s 5-32x sine, scaled to the mean)."""
    spec = reads["length"]
    cov = reads["coverage"]
    wave = reads.get("wave")
    if wave is None:
        count = int(n * cov // spec["mean"])
        lens = _read_lengths(rng, spec, count)
        starts = (rng.random(count) * (n - lens - 1)).astype(np.int64)
        order = np.argsort(starts, kind="stable")
        return starts[order], lens[order]
    lo, hi = wave["low"], wave["high"]
    scale = cov / ((lo + hi) / 2)
    pool = _read_lengths(rng, spec, int(n * wave["high"] * scale
                                        // spec["min"]) + 16)
    starts, lens = [], []
    start, k = 0, 0
    limit = n - spec["max"] - 5_000
    while start < limit:
        rlen = int(pool[k])
        k += 1
        c = scale * (lo + (hi - lo) * (1 + np.sin(
            2 * np.pi * start / wave["period"])) / 2)
        starts.append(start)
        lens.append(rlen)
        start += max(150, int(rlen / c))
    return np.asarray(starts, np.int64), np.asarray(lens, np.int64)


def _in_zones(keys, lens, zlo, zhi):
    """Whether [key, key + len] touches any zone [zlo, zhi]."""
    if len(zlo) == 0:
        return np.zeros(len(keys), bool)
    order = np.argsort(zlo, kind="stable")
    zlo, zhi = zlo[order], np.maximum.accumulate(zhi[order])
    hit = np.zeros(len(keys), bool)
    for pt in (keys, keys + lens):
        j = np.searchsorted(zlo, pt, side="right") - 1
        hit |= (j >= 0) & (zhi[np.maximum(j, 0)] >= pt)
    # a zone lying wholly inside the event
    j = np.searchsorted(zlo, keys, side="right")
    hit |= (j < len(zlo)) & (zlo[np.minimum(j, len(zlo) - 1)]
                             <= keys + lens)
    return hit


def contig_plan(seed: int, ci: int, config: dict, traffic: dict):
    """(Plan, reference codes, SV list) of contig ``ci``."""
    sizes = contig_sizes(config)
    names = config["genome"]["contigs"]
    n = sizes[ci]
    chrom = names[ci]
    ref = contig_ref(seed, ci, n)
    svs = sv_plan(seed, ci, sizes, traffic)
    reads = config["reads"]
    rng = rng_for(seed, 3, ci)
    pool: List[np.ndarray] = []
    pool_len = [0]

    def to_pool(codes) -> int:
        off = pool_len[0]
        pool.append(codes)
        pool_len[0] += len(codes)
        return off

    starts, rlens = _layout_reads(rng, n, reads)
    nr = len(starts)
    hap0 = rng.random(nr) < 0.5
    mix = rng.random(nr)
    mapq = np.full(nr, reads["mapq"], np.int64)
    edge = 0.0
    for q, share in reads.get("low_mapq", []):
        mapq[(mix >= edge) & (mix < edge + share)] = q
        edge += share
    flag = np.where(rng.random(nr) < reads.get("secondary", 0.0), 256, 0)
    chimeric = (rng.random(nr) < reads.get("chimeric", 0.0)) & (flag == 0)

    # events: (read, pos, kind, len, src); tier 0 = the planted DEL/INS
    ev = {k: [] for k in ("read", "pos", "kind", "len", "src")}
    max_len = int(rlens.max()) if nr else 0
    for sv in svs:
        if sv["kind"] not in ("DEL", "INS"):
            continue
        dl = sv["len"] if sv["kind"] == "DEL" else 0
        lo = np.searchsorted(starts, sv["s"] + dl + END_MARGIN - max_len)
        hi = np.searchsorted(starts, sv["s"] - END_MARGIN)
        idx = np.arange(lo, hi)
        idx = idx[(starts[idx] + rlens[idx] - END_MARGIN > sv["s"] + dl)
                  & (sv["hom"] | hap0[idx])]
        src = to_pool(sv["seq"]) if sv["kind"] == "INS" else -1
        ev["read"].append(idx)
        ev["pos"].append(np.full(len(idx), sv["s"]))
        ev["kind"].append(np.full(len(idx), OP_I if dl == 0 else OP_D))
        ev["len"].append(np.full(len(idx), sv["len"]))
        ev["src"].append(np.full(len(idx), src))
    cat = {k: (np.concatenate(v).astype(np.int64) if v
               else np.zeros(0, np.int64)) for k, v in ev.items()}
    keep_keys = (cat["read"] << 32) + cat["pos"]
    zlo = keep_keys - ZONE
    zhi = keep_keys + np.where(cat["kind"] == OP_D, cat["len"], 0) + ZONE

    # noise tiers, longest first: one indel per cell of `every` bp
    for tier in sorted(reads.get("noise", []), key=lambda t: -t["max"]):
        every = tier["every"]
        ncell = np.maximum(0, (rlens - 2 * END_MARGIN) // every)
        r = np.repeat(np.arange(nr), ncell)
        cell = np.arange(len(r)) - np.repeat(np.cumsum(ncell) - ncell, ncell)
        span = max(1, every - 20 - tier["max"])
        pos = (starts[r] + END_MARGIN + cell * every + 10
               + rng.integers(0, span, len(r)))
        kind = np.where(rng.random(len(r)) < 0.5, OP_D, OP_I)
        ln = rng.integers(tier["min"], tier["max"] + 1, len(r))
        keys = (r << 32) + pos
        ok = ~_in_zones(keys, np.where(kind == OP_D, ln, 0), zlo, zhi)
        r, pos, kind, ln, keys = r[ok], pos[ok], kind[ok], ln[ok], keys[ok]
        ins_total = int(ln[kind == OP_I].sum())
        src = np.full(len(r), -1, np.int64)
        if ins_total:
            base = to_pool(rng.integers(0, 4, size=ins_total,
                                        dtype=np.uint8))
            il = ln[kind == OP_I]
            src[kind == OP_I] = base + np.cumsum(il) - il
        for k, v in (("read", r), ("pos", pos), ("kind", kind), ("len", ln),
                     ("src", src)):
            cat[k] = np.concatenate([cat[k], v])
        zlo = np.concatenate([zlo, keys - ZONE])
        zhi = np.concatenate([zhi, keys + np.where(kind == OP_D, ln, 0)
                              + ZONE])

    order = np.lexsort((cat["pos"], cat["read"]))
    er, ep, ek, el, es = (cat[k][order] for k in
                          ("read", "pos", "kind", "len", "src"))
    ne = len(er)
    k_of = np.bincount(er, minlength=nr)
    op_off = np.zeros(nr + 1, np.int64)
    op_off[1:] = np.cumsum(2 * k_of + 1)
    first = np.ones(ne, bool)
    first[1:] = er[1:] != er[:-1]
    after = ep + np.where(ek == OP_D, el, 0)   # ref cursor after the event
    cur = np.where(first, starts[er], np.roll(after, 1))
    j = np.arange(ne) - np.repeat(np.cumsum(k_of) - k_of, k_of)
    n_ops = int(op_off[-1])
    ops = np.zeros(n_ops, np.uint8)
    lens = np.zeros(n_ops, np.int64)
    src = np.zeros(n_ops, np.int64)
    m_at = op_off[er] + 2 * j
    ops[m_at], lens[m_at], src[m_at] = OP_M, ep - cur, cur
    ops[m_at + 1], lens[m_at + 1], src[m_at + 1] = ek, el, es
    last = op_off[1:] - 1
    tail_cur = starts.copy()
    has = k_of > 0
    last_ev = np.cumsum(k_of) - 1
    tail_cur[has] = after[last_ev[has]]
    ops[last], lens[last], src[last] = OP_M, starts + rlens - tail_cur, \
        tail_cur
    if (lens[ops == OP_M] <= 0).any():
        raise AssertionError("a match of length <= 0 in contig %s" % chrom)

    qlen = np.add.reduceat(np.where(ops != OP_D, lens, 0), op_off[:-1]) \
        if nr else np.zeros(0, np.int64)
    sa = {}
    n_contigs = len(sizes)
    for r in np.nonzero(chimeric)[0].tolist():
        c2 = (ci + 1) % n_contigs
        p2 = int(rng.integers(10_000, sizes[c2] - 10_000))
        q = int(qlen[r])
        sa[r] = "%s,%d,+,%dS%dM,60,0;" % (names[c2], p2 + 1, q // 2,
                                          q - q // 2)
    bg_names = ["%s_m%07d" % (chrom, r) for r in range(nr)]

    # split carriers (DUP, INV, BND) and clip storms
    extra = _Table()
    n_car = max(4, reads["coverage"] // 2)
    rid = 0
    mates: Dict[int, np.ndarray] = {}
    for sv in svs:
        kind, s, e = sv["kind"], sv["s"], sv["e"]
        if kind not in ("DUP", "INV", "BND"):
            continue
        for k in range(n_car):
            jk = k * 5
            rid += 1
            if kind == "DUP":
                p = e - FLANK - jk
                extra.add(p, 0, 60, "%s_sv%06d" % (chrom, rid),
                          [(OP_M, FLANK, p),
                           (OP_S, FLANK, to_pool(ref[s:s + FLANK]))],
                          "%s,%d,+,%dS%dM,60,0;" % (chrom, s - jk + 1,
                                                    FLANK, FLANK))
            elif kind == "INV":
                p = s - FLANK - jk
                extra.add(p, 0, 60, "%s_sv%06d" % (chrom, rid),
                          [(OP_M, FLANK, p),
                           (OP_S, FLANK,
                            to_pool(3 - ref[e - FLANK:e][::-1]))],
                          "%s,%d,-,%dM%dS,60,0;" % (chrom, e - FLANK - jk + 1,
                                                    FLANK, FLANK))
            else:
                ci2 = sv["ci2"]
                if ci2 not in mates:
                    mates[ci2] = contig_ref(seed, ci2, sizes[ci2])
                pairs = bnd_breakends(s, e, sv["p2"], sv["s1"], sv["s2"])
                for cj, (p1, p2) in enumerate(pairs):
                    p = p1 + cj * 150 - FLANK - jk
                    extra.add(p, 0, 60, "%s_sv%06d_%d" % (chrom, rid, cj),
                              [(OP_M, FLANK, p),
                               (OP_S, FLANK,
                                to_pool(mates[ci2][p2:p2 + FLANK]))],
                              "%s,%d,+,%dS%dM,60,0;" % (names[ci2], p2 + 1,
                                                        FLANK, FLANK))
    storms = reads.get("clip_storms", 0)
    if storms:
        sp = rng.integers(50_000, n - 50_000, storms)
        for si, p0 in enumerate(sp.tolist()):
            for jj in range(8):
                p = p0 + jj * 11
                extra.add(p, 0, 60, "%s_clip%02d_%02d" % (chrom, si, jj),
                          [(OP_M, 2_000, p),
                           (OP_S, 1_400, to_pool(rng.integers(
                               0, 4, size=1_400, dtype=np.uint8)))])

    # merge: background first, then the extra records, stably by position
    x_ops = [o for cig in extra.cigars for o, _, _ in cig]
    x_len = [ln for cig in extra.cigars for _, ln, _ in cig]
    x_src = [sr for cig in extra.cigars for _, _, sr in cig]
    x_n = np.array([len(c) for c in extra.cigars], np.int64)
    all_pos = np.concatenate([starts, np.asarray(extra.pos, np.int64)])
    all_flag = np.concatenate([flag, np.asarray(extra.flag, np.int64)])
    all_mapq = np.concatenate([mapq, np.asarray(extra.mapq, np.int64)])
    all_n = np.concatenate([2 * k_of + 1, x_n])
    all_ops = np.concatenate([ops, np.asarray(x_ops, np.uint8)])
    all_len = np.concatenate([lens, np.asarray(x_len, np.int64)])
    all_src = np.concatenate([src, np.asarray(x_src, np.int64)])
    all_names = bg_names + extra.names
    all_sa = dict(sa)
    for k, t in enumerate(extra.sa):
        if t is not None:
            all_sa[nr + k] = t
    order = np.argsort(all_pos, kind="stable")
    off_old = np.zeros(len(all_n) + 1, np.int64)
    off_old[1:] = np.cumsum(all_n)
    n_sorted = all_n[order]
    off_new = np.zeros(len(order) + 1, np.int64)
    off_new[1:] = np.cumsum(n_sorted)
    gather = (np.repeat(off_old[:-1][order] - off_new[:-1], n_sorted)
              + np.arange(int(off_new[-1])))
    rank = np.empty(len(order), np.int64)
    rank[order] = np.arange(len(order))
    plan = Plan(chrom=chrom, pos=all_pos[order], flag=all_flag[order],
                mapq=all_mapq[order], names=[all_names[i] for i in order],
                op_off=off_new, ops=all_ops[gather], lens=all_len[gather],
                src=all_src[gather],
                pool=(np.concatenate(pool) if pool
                      else np.zeros(0, np.uint8)),
                sa={int(rank[r]): t for r, t in all_sa.items()})
    return plan, ref, svs


# ---------------------------------------------------------------------------
# BAM encoding
# ---------------------------------------------------------------------------

_HDR = np.dtype([("block_size", "<i4"), ("ref_id", "<i4"), ("pos", "<i4"),
                 ("l_name", "u1"), ("mapq", "u1"), ("bin", "<u2"),
                 ("n_cigar", "<u2"), ("flag", "<u2"), ("l_seq", "<i4"),
                 ("next_ref", "<i4"), ("next_pos", "<i4"), ("tlen", "<i4")])


def reg2bin(beg: np.ndarray, end: np.ndarray) -> np.ndarray:
    """UCSC bins (SAM spec 5.3) of [beg, end)."""
    end = end - 1
    out = np.zeros(len(beg), np.int64)
    done = np.zeros(len(beg), bool)
    for shift, base in ((14, 4681), (17, 585), (20, 73), (23, 9), (26, 1)):
        hit = ~done & ((beg >> shift) == (end >> shift))
        out[hit] = base + (beg[hit] >> shift)
        done |= hit
    return out


def _segments(starts, lengths):
    """Indices start..start+len of every segment, concatenated (int32
    where they fit: the gathers and scatters are most of the encoding)."""
    total = int(lengths.sum())
    top = int(starts.max()) + int(lengths.max()) if len(starts) else 0
    dt = np.int32 if max(total, top) < 2**31 else np.int64
    out = np.repeat((starts - (np.cumsum(lengths) - lengths)).astype(dt),
                    lengths)
    out += np.arange(total, dtype=dt)
    return out


def encode_records(plan: Plan, ref: np.ndarray, ref_id: int, lo: int,
                   hi: int) -> bytes:
    """The uncompressed BAM records ``lo:hi`` of ``plan`` (qualities
    0xFF, tags SA:Z only)."""
    r = np.arange(lo, hi)
    o_lo, o_hi = plan.op_off[lo], plan.op_off[hi]
    ops, lens, src = (plan.ops[o_lo:o_hi], plan.lens[o_lo:o_hi],
                      plan.src[o_lo:o_hi])
    n_ops = np.diff(plan.op_off[lo:hi + 1])
    rec_of_op = np.repeat(np.arange(len(r)), n_ops)
    qmask = ops != OP_D
    l_seq = np.bincount(rec_of_op, np.where(qmask, lens, 0),
                        minlength=len(r)).astype(np.int64)
    ref_span = np.bincount(rec_of_op, np.where(ops != OP_I,
                                               np.where(ops == OP_S, 0, lens),
                                               0),
                           minlength=len(r)).astype(np.int64)
    names = [plan.names[i].encode() + b"\0" for i in range(lo, hi)]
    l_name = np.array([len(x) for x in names], np.int64)
    tags = [b"SAZ" + plan.sa[i].encode() + b"\0" if i in plan.sa else b""
            for i in range(lo, hi)]
    l_tag = np.array([len(t) for t in tags], np.int64)
    packed = (l_seq + 1) // 2
    body = 32 + l_name + 4 * n_ops + packed + l_seq + l_tag
    rec_off = np.zeros(len(r) + 1, np.int64)
    rec_off[1:] = np.cumsum(body + 4)
    buf = np.full(int(rec_off[-1]), 0xFF, np.uint8)

    pos = plan.pos[lo:hi]
    hdr = np.zeros(len(r), _HDR)
    hdr["block_size"] = body
    hdr["ref_id"] = ref_id
    hdr["pos"] = pos
    hdr["l_name"] = l_name
    hdr["mapq"] = plan.mapq[lo:hi]
    hdr["bin"] = reg2bin(pos, np.maximum(pos + ref_span, pos + 1))
    hdr["n_cigar"] = n_ops
    hdr["flag"] = plan.flag[lo:hi]
    hdr["l_seq"] = l_seq
    hdr["next_ref"] = -1
    hdr["next_pos"] = -1
    starts = rec_off[:-1]
    buf[_segments(starts, np.full(len(r), 36))] = \
        np.frombuffer(hdr.tobytes(), np.uint8)
    buf[_segments(starts + 36, l_name)] = np.frombuffer(b"".join(names),
                                                        np.uint8)
    cig = ((lens << 4) | ops).astype("<u4")
    buf[_segments(starts + 36 + l_name, 4 * n_ops)] = \
        np.frombuffer(cig.tobytes(), np.uint8)
    # query bases: a gather over [reference | pool]
    q_ops = np.nonzero(qmask)[0]
    q_src = np.where(ops[q_ops] == OP_M, src[q_ops],
                     len(ref) + src[q_ops])
    bases = np.concatenate([ref, plan.pool])[_segments(q_src,
                                                       lens[q_ops])]
    nib = np.zeros(2 * int(packed.sum()), np.uint8)
    p_off = np.cumsum(packed) - packed
    nib[_segments(2 * p_off, l_seq)] = _NT16[bases]
    seq = (nib[0::2] << 4) | nib[1::2]
    seq_at = starts + 36 + l_name + 4 * n_ops
    buf[_segments(seq_at, packed)] = seq
    if l_tag.any():
        buf[_segments(seq_at + packed + l_seq, l_tag)] = \
            np.frombuffer(b"".join(tags), np.uint8)
    return buf.tobytes()


def bam_header(contigs) -> bytes:
    text = "@HD\tVN:1.6\tSO:coordinate\n" + "".join(
        "@SQ\tSN:%s\tLN:%d\n" % (c, n) for c, n in contigs)
    out = bytearray(b"BAM\x01")
    out += struct.pack("<i", len(text)) + text.encode()
    out += struct.pack("<i", len(contigs))
    for c, n in contigs:
        nb = c.encode() + b"\0"
        out += struct.pack("<i", len(nb)) + nb + struct.pack("<i", n)
    return bytes(out)


def bgzf(data: bytes, level: int = 1) -> bytes:
    """``data`` as BGZF blocks of at most 0xFF00 bytes (no EOF block)."""
    out = []
    view = memoryview(data)
    for i in range(0, len(data), BGZF_BLOCK):
        chunk = view[i:i + BGZF_BLOCK]
        co = zlib.compressobj(level, zlib.DEFLATED, -15)
        cdata = co.compress(chunk) + co.flush()
        out.append(b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff\x06\x00BC"
                   b"\x02\x00" + struct.pack("<H", len(cdata) + 25) + cdata
                   + struct.pack("<II", zlib.crc32(chunk), len(chunk)))
    return b"".join(out)


def make_contig(args) -> tuple:
    """Worker: (ci, BGZF bytes of the contig's records, FASTA text of the
    contig, records, query bases). Records are encoded and compressed in
    chunks that end on a record, each chunk's blocks independent."""
    seed, ci, config, traffic, chunk = args
    plan, ref, _ = contig_plan(seed, ci, config, traffic)
    parts = []
    pending = b""
    for lo in range(0, len(plan), chunk):
        raw = pending + encode_records(plan, ref, ci, lo,
                                       min(len(plan), lo + chunk))
        cut = len(raw) - len(raw) % BGZF_BLOCK
        parts.append(bgzf(raw[:cut]))
        pending = raw[cut:]
    parts.append(bgzf(pending))
    text = codes_to_bytes(ref)
    fasta = b">" + plan.chrom.encode() + b"\n" + b"\n".join(
        text[i:i + 10_000] for i in range(0, len(text), 10_000)) + b"\n"
    bases = int(np.where(plan.ops != OP_D, plan.lens, 0).sum())
    return ci, b"".join(parts), fasta, len(plan), bases


def write_corpus(seed: int, config: dict, traffic: dict, bam_path: str,
                 fasta_path: str, workers: int, chunk: int = 2_000) -> dict:
    """Write the sample's BAM and FASTA, one contig per task over
    ``workers`` spawned processes (in-process with ``workers`` <= 1).
    Returns the record and base counts."""
    sizes = contig_sizes(config)
    contigs = list(zip(config["genome"]["contigs"], sizes))
    tasks = [(seed, ci, config, traffic, chunk) for ci in range(len(sizes))]
    n_rec = n_bases = 0
    with open(bam_path, "wb") as bam, open(fasta_path, "wb") as fa:
        bam.write(bgzf(bam_header(contigs)))

        def take(res):
            nonlocal n_rec, n_bases
            _, blob, fasta, k, b = res
            bam.write(blob)
            fa.write(fasta)
            n_rec += k
            n_bases += b

        if workers <= 1:
            for t in tasks:
                take(make_contig(t))
        else:
            import multiprocessing as mp
            with mp.get_context("spawn").Pool(workers) as pool:
                for res in pool.imap(make_contig, tasks):
                    take(res)
        bam.write(BGZF_EOF)
        # on disk before the window, so that no write-back runs inside it
        for fh in (bam, fa):
            fh.flush()
            os.fsync(fh.fileno())
    return dict(records=n_rec, bases=n_bases, contigs=len(contigs))
