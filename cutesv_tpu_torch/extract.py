"""Per-read SV signature extraction (host side, Python reference engine).

Reproduces the signature semantics of the reference caller's stage 1
(parse_read cuteSV:606-681, generate_combine_sigs cuteSV:515-575,
organize_split_signal cuteSV:483-513, analysis_split_read cuteSV:190-464,
analysis_inv cuteSV:50-94, analysis_bnd cuteSV:97-188) on top of our own BAM
reader. This module is the behavioral oracle; the C++ decoder in ``native/``
implements the same contract for the hot path and is golden-tested against it.

Signature tuples produced (per read), matching the reference's spill format:
    DEL: (pos, len, read_name, "DEL", chrom)
    INS: (pos, len, read_name, seq, "INS", chrom)          # pos may be *.5
    DUP: (pos1, pos2, read_name, "DUP", chrom)
    INV: (strand, bp1, bp2, read_name, "INV", chrom)       # strand "++"/"--"
    TRA: (bnd_type, pos1, chr2, pos2, read_name, "TRA", chrom)
"""
from __future__ import annotations

from typing import Dict, List

from cutesv_tpu_torch.io.bam import BamRecord

# IUPAC-complete complement (Bio.Seq.reverse_complement equivalent).
_COMP = str.maketrans(
    "ACGTUacgtuRYKMrykmBVDHbvdhNnSsWw-",
    "TGCAAtgcaaYRMKyrmkVBHDvbhdNnSsWw-")


def revcomp(seq: str) -> str:
    return seq.translate(_COMP)[::-1]


def detect_flag(flag: int) -> int:
    """SAM FLAG -> extraction class (cuteSV:32-48).

    1: forward primary, 2: reverse primary, 3/4: supplementary (+/-),
    0: anything else (incl. unmapped=4 and unrecognized combinations).
    """
    return {4: 0, 0: 1, 16: 2, 2048: 3, 2064: 4}.get(flag, 0)


# per-CIGAR-op: does the op advance the reference cursor for signature
# placement (cuteSV:592-603 REFCHANGEOP: M/D/N/=/X).
_REF_ADVANCE = (True, False, True, True, False, False, False, True, True)


def _combine_ins(sigs: List[list], chrom: str, qname: str,
                 merge_dis: int, out: List[tuple]):
    """Chain nearby INS signatures of one read (cuteSV:515-555).

    Gap measured from the previous signature's *position*; lengths sum and
    sequences concatenate.
    """
    if not sigs:
        return
    cur_pos, cur_len, cur_seq = sigs[0]
    last_pos = cur_pos
    for pos, ln, seq in sigs[1:]:
        if pos - last_pos <= merge_dis:
            cur_len += ln
            cur_seq += seq
            last_pos = pos
        else:
            out.append((cur_pos, cur_len, qname, cur_seq, "INS", chrom))
            cur_pos, cur_len, cur_seq = pos, ln, seq
            last_pos = pos
    out.append((cur_pos, cur_len, qname, cur_seq, "INS", chrom))


def _combine_del(sigs: List[list], chrom: str, qname: str,
                 merge_dis: int, out: List[tuple]):
    """Chain nearby DEL signatures of one read (cuteSV:556-575).

    Gap measured to the previous signature's *end* (pos+len) while a
    chain grows — but after a chain break the reference re-anchors at the
    new signature's POSITION (`temp_sig.append(i[0])`, cuteSV:570), not
    its end; only the initial cluster starts at pos+len. Reproduced
    exactly (differential-tested against the reference code)."""
    if not sigs:
        return
    cur_pos, cur_len = sigs[0]
    last_end = cur_pos + cur_len
    for pos, ln in sigs[1:]:
        if pos - last_end <= merge_dis:
            cur_len += ln
            last_end = pos + ln
        else:
            out.append((cur_pos, cur_len, qname, "DEL", chrom))
            cur_pos, cur_len = pos, ln
            last_end = pos
    out.append((cur_pos, cur_len, qname, "DEL", chrom))


def _clip_profile(sa_cigar: str):
    """Leading/trailing soft-clip lengths + reference span of an SA CIGAR
    (cuteSV:466-481). Hard clips are deliberately NOT treated as clips here,
    matching the reference (it only looks at 'S')."""
    first_clip = last_clip = 0
    ref_span = 0
    items = []
    num = 0
    for ch in sa_cigar:
        if ch.isdigit():
            num = num * 10 + ord(ch) - 48
        else:
            items.append((num, ch))
            num = 0
    if items and items[0][1] == "S":
        first_clip = items[0][0]
    if items and items[-1][1] == "S":
        last_clip = items[-1][0]
    for ln, ch in items:
        if ch in "MD=X":
            ref_span += ln
    return first_clip, last_clip, ref_span


def _emit_inv(e1, e2, qname: str, inv_out: List[tuple], sv_size: int):
    """Head-to-head / tail-to-tail inversion breakpoints from two same-chrom
    opposite-strand segments (cuteSV:50-94)."""
    chrom = e1[4]
    if e1[5] == "+":
        if e1[3] - e2[3] >= sv_size and e2[0] + 0.5 * (e1[3] - e2[3]) >= e1[1]:
            inv_out.append(("++", e2[3], e1[3], qname, "INV", chrom))
        if e2[3] - e1[3] >= sv_size and e2[0] + 0.5 * (e2[3] - e1[3]) >= e1[1]:
            inv_out.append(("++", e1[3], e2[3], qname, "INV", chrom))
    else:
        if e2[2] - e1[2] >= sv_size and e2[0] + 0.5 * (e2[2] - e1[2]) >= e1[1]:
            inv_out.append(("--", e1[2], e2[2], qname, "INV", chrom))
        if e1[2] - e2[2] >= sv_size and e2[0] + 0.5 * (e1[2] - e2[2]) >= e1[1]:
            inv_out.append(("--", e2[2], e1[2], qname, "INV", chrom))


def _emit_bnd(e1, e2, qname: str, tra_out: List[tuple]):
    """Breakend record for two different-chrom segments (cuteSV:97-188).

    BND types: A = N[chr:pos[, B = N]chr:pos], C = [chr:pos[N, D = ]chr:pos]N.
    Record layout: (type, pos1, chr2, pos2, qname, "TRA", chr1).
    """
    if e2[0] - e1[1] > 100:
        return
    s1, s2 = e1[5], e2[5]
    if s1 == "+":
        if s2 == "+":
            if e1[4] < e2[4]:
                tra_out.append(("A", e1[3], e2[4], e2[2], qname, "TRA", e1[4]))
            else:
                tra_out.append(("D", e2[2], e1[4], e1[3], qname, "TRA", e2[4]))
        else:
            if e1[4] < e2[4]:
                tra_out.append(("B", e1[3], e2[4], e2[3], qname, "TRA", e1[4]))
            else:
                tra_out.append(("B", e2[3], e1[4], e1[3], qname, "TRA", e2[4]))
    else:
        if s2 == "+":
            if e1[4] < e2[4]:
                tra_out.append(("C", e1[2], e2[4], e2[2], qname, "TRA", e1[4]))
            else:
                tra_out.append(("C", e2[2], e1[4], e1[2], qname, "TRA", e2[4]))
        else:
            if e1[4] < e2[4]:
                tra_out.append(("D", e1[2], e2[4], e2[3], qname, "TRA", e1[4]))
            else:
                tra_out.append(("A", e2[3], e1[4], e1[2], qname, "TRA", e2[4]))


def _flip(seg, rlen: int):
    """Mirror a segment's read coordinates to the opposite orientation."""
    return [rlen - seg[1], rlen - seg[0]] + list(seg[2:])


def _emit_indel_pair(e1, e2, query_res: str, qname: str, sv_size: int,
                     max_size: int, out: Dict[str, list],
                     ins_guard: bool = True, del_guard: bool = True):
    """The shared INS/DEL emission rules for a collinear same-strand segment
    pair in read orientation (cuteSV:241-257, 358-399, 412-429).

    ``ins_guard``/``del_guard`` encode the extra ``ele_3[2] >= ele_2[3]``
    window condition the 3-segment sliding window applies (cuteSV:361,371).
    """
    chrom = e2[4]
    # unaligned read bases in excess of the reference gap -> INS
    delta = e2[0] + e1[3] - e2[2] - e1[1]
    if e1[3] - e2[2] < max(sv_size, delta / 5) and delta >= sv_size:
        if e2[2] - e1[3] <= max(100, delta / 5) and (delta <= max_size
                                                     or max_size == -1):
            if ins_guard:
                half = int((e2[2] - e1[3]) / 2)
                out["INS"].append(((e2[2] + e1[3]) / 2, delta, qname,
                                   str(query_res[e1[1] + half:e2[0] - half]),
                                   "INS", chrom))
    # reference gap in excess of read gap -> DEL
    delta = e2[2] - e2[0] + e1[1] - e1[3]
    if e1[3] - e2[2] < max(sv_size, delta / 5) and delta >= sv_size:
        if e2[0] - e1[1] <= max(100, delta / 5) and (delta <= max_size
                                                     or max_size == -1):
            if del_guard:
                out["DEL"].append((e1[3], delta, qname, "DEL", chrom))


def _analyse_two_segments(sp, sv_size: int, rlen: int, qname: str,
                          out: Dict[str, list], max_size: int, query: str):
    """2-segment split-read classification (cuteSV:205-259)."""
    e1, e2 = sp[0], sp[1]
    if e1[4] != e2[4]:
        _emit_bnd(e1, e2, qname, out["TRA"])
        return
    if e1[5] != e2[5]:
        _emit_inv(e1, e2, qname, out["INV"], sv_size)
        return
    # same chrom, same strand: DUP / INS / DEL
    if e1[5] == "-":
        e1, e2 = _flip(sp[1], rlen), _flip(sp[0], rlen)
        query = revcomp(query)
    if e1[3] - e2[2] >= sv_size:
        # overlapping reference span: duplicated read bases or duplication
        if e2[0] - e1[1] >= e1[3] - e2[2]:
            half = int((e2[2] - e1[3]) / 2)
            out["INS"].append(((e1[3] + e2[2]) / 2,
                               e2[0] + e1[3] - e2[2] - e1[1], qname,
                               str(query[e1[1] + half:e2[0] - half]),
                               "INS", e2[4]))
        else:
            out["DUP"].append((e2[2], e1[3], qname, "DUP", e2[4]))
    _emit_indel_pair(e1, e2, query, qname, sv_size, max_size, out)


def _analyse_multi_segments(sp, sv_size: int, rlen: int, qname: str,
                            out: Dict[str, list], max_size: int, query: str):
    """3+-segment sliding-window state machine (cuteSV:261-464).

    Windows of 3 consecutive segments; detects full inversions (+-+/-+-),
    terminal inversions, DUPs from backward reference jumps, collinear
    INS/DEL, cross-chrom breakends, and the INS-within-translocation
    recovery over the first/last segment pair.
    """
    n = len(sp)
    saw_bnd = False
    for a in range(n - 2):
        e1, e2, e3 = sp[a], sp[a + 1], sp[a + 2]
        if e1[4] != e2[4]:
            saw_bnd = True
            _emit_bnd(e1, e2, qname, out["TRA"])
            if a == n - 3 and e2[4] != e3[4]:
                _emit_bnd(e2, e3, qname, out["TRA"])
            continue
        if e2[4] == e3[4]:
            if e1[5] == e3[5] and e1[5] != e2[5]:
                if e2[5] == "-":
                    # +-+ full inversion: emit both breakend pairs
                    if (e2[0] + 0.5 * (e3[2] - e1[3]) >= e1[1]
                            and e3[0] + 0.5 * (e3[2] - e1[3]) >= e2[1]):
                        if e2[2] >= e1[3] and e3[2] >= e2[3]:
                            out["INV"].append(("++", e1[3], e2[3], qname,
                                               "INV", e1[4]))
                            out["INV"].append(("--", e2[2], e3[2], qname,
                                               "INV", e1[4]))
                else:
                    # -+- full inversion
                    if (e1[1] <= e2[0] + 0.5 * (e1[2] - e3[3])
                            and e3[0] + 0.5 * (e1[2] - e3[3]) >= e2[1]):
                        if e2[2] - e3[3] >= -50 and e1[2] - e2[3] >= -50:
                            out["INV"].append(("++", e3[3], e2[3], qname,
                                               "INV", e1[4]))
                            out["INV"].append(("--", e2[2], e1[2], qname,
                                               "INV", e1[4]))
            if a == n - 3 and e1[5] != e3[5]:
                if e2[5] == e1[5]:
                    _emit_inv(e2, e3, qname, out["INV"], sv_size)
                else:
                    _emit_inv(e1, e2, qname, out["INV"], sv_size)

            if e1[5] == e3[5] and e1[5] == e2[5]:
                # collinear triple: DUP / INS / DEL in read orientation
                if e1[5] == "-":
                    e1 = _flip(sp[a + 2], rlen)
                    e2 = _flip(sp[a + 1], rlen)
                    e3 = _flip(sp[a], rlen)
                    query_res = revcomp(query)
                else:
                    query_res = query
                if e2[3] - e3[2] >= sv_size and e2[2] < e3[3]:
                    out["DUP"].append((e3[2], e2[3], qname, "DUP", e2[4]))
                if a == 0 and e1[3] - e2[2] >= sv_size:
                    out["DUP"].append((e2[2], e1[3], qname, "DUP", e2[4]))
                guard = e3[2] >= e2[3]
                _emit_indel_pair(e1, e2, query_res, qname, sv_size, max_size,
                                 out, ins_guard=guard, del_guard=guard)
                if a == n - 3:
                    # trailing pair of the final window
                    _emit_indel_pair(e2, e3, query_res, qname, sv_size,
                                     max_size, out)
                continue

            # mixed-strand windows: analyse the same-strand pair in read
            # orientation. Replicates the reference's index quirk
            # (cuteSV:401-411): the final ++-/--+ window re-labels
            # (e2,e3) as the pair but still flips via sp[a]/sp[a+1].
            tail_mixed = (a == n - 3 and e1[5] != e2[5] and e2[5] == e3[5])
            if tail_mixed:
                e1, e2, e3 = e2, e3, None
            if e3 is None or (e1[5] == e2[5] and e2[5] != e3[5]):
                if e1[5] == "-":
                    e1 = _flip(sp[a + 1], rlen)
                    e2 = _flip(sp[a], rlen)
                    query_res = revcomp(query)
                else:
                    query_res = query
                _emit_indel_pair(e1, e2, query_res, qname, sv_size, max_size,
                                 out)

    if saw_bnd:
        # INS recovered inside a translocation: compare first/last segment
        # (cuteSV:439-464)
        first, last = sp[0], sp[-1]
        if first[4] == last[4] and first[5] == last[5]:
            if first[5] == "+":
                e1, e2 = first, last
                query_res = query
            else:
                e1, e2 = _flip(last, rlen), _flip(first, rlen)
                query_res = revcomp(query)
            dis_ref = e2[2] - e1[3]
            dis_read = e2[0] - e1[1]
            excess = dis_read - dis_ref
            if (abs(dis_ref) < max(sv_size, excess / 5) and excess >= sv_size
                    and (excess <= max_size or max_size == -1)):
                half = int(dis_ref / 2)
                out["INS"].append((min(e2[2], e1[3]), excess, qname,
                                   str(query_res[e1[1] + half:e2[0] - half]),
                                   "INS", e2[4]))
            if dis_ref <= -sv_size:
                out["DUP"].append((e2[2], e1[3], qname, "DUP", e2[4]))


def _analyse_split_read(split_read, sv_size: int, rlen: int, qname: str,
                        out: Dict[str, list], max_size: int, query: str):
    sp = sorted(split_read, key=lambda x: x[0])
    if len(sp) < 2:
        return
    if len(sp) == 2:
        _analyse_two_segments(sp, sv_size, rlen, qname, out, max_size, query)
    else:
        _analyse_multi_segments(sp, sv_size, rlen, qname, out, max_size,
                                query)


def extract_read(rec: BamRecord, out: Dict[str, list], chrom: str,
                 sv_size: int, min_mapq: int, max_split_parts: int,
                 min_read_len: int, min_siglength: int,
                 merge_del_threshold: int, merge_ins_threshold: int,
                 max_size: int) -> None:
    """Extract all signatures of one BAM record into ``out``.

    Parameter order mirrors parse_read (cuteSV:606) for auditability;
    ``sv_size`` is the CLI's min_size.
    """
    if rec.query_length < min_read_len:
        return
    ins_sigs: List[list] = []
    del_sigs: List[list] = []
    process_signal = detect_flag(rec.flag)
    softclip_left = softclip_right = 0
    pos_start = pos_end = 0
    if rec.mapq >= min_mapq:
        pos_start = rec.pos
        pos_end = rec.reference_end
        cig = rec.cigar
        if not cig:
            # the reference crashes on read.cigartuples[0] here
            # (cuteSV:614); a designed error beats an IndexError, and the
            # native decoder raises its status-6 equivalent at the same
            # point
            raise ValueError(
                "mapped record '%s' passes --min_mapq but has no CIGAR; "
                "its coordinates cannot be interpreted (re-align or fix "
                "the input)" % rec.qname)
        hardclip_left = hardclip_right = 0
        if cig[0][0] == 4:
            softclip_left = cig[0][1]
        elif cig[0][0] == 5:
            hardclip_left = cig[0][1]
        sig_start = pos_start
        # read-offset cursor: every op except DEL advances it (cuteSV:629-632,
        # including soft/hard clips, skips and pads — hard clips cancel the
        # initial -hardclip_left shift, the rest reproduces reference
        # behavior verbatim).
        shift = -hardclip_left
        seq = rec.seq
        for op, oplen in cig:
            if op != 2:
                shift += oplen
            if oplen >= min_siglength and (op == 1 or op == 2):
                if op == 2:
                    del_sigs.append([sig_start, oplen])
                    sig_start += oplen
                else:
                    ins_sigs.append([sig_start, oplen,
                                     str(seq[shift - oplen:shift])])
            elif _REF_ADVANCE[op]:
                sig_start += oplen
        if cig[-1][0] == 4:
            softclip_right = cig[-1][1]
        elif cig[-1][0] == 5:
            hardclip_right = cig[-1][1]
        if hardclip_left != 0:
            softclip_left = hardclip_left
        if hardclip_right != 0:
            softclip_right = hardclip_right

    _combine_ins(ins_sigs, chrom, rec.qname, merge_ins_threshold, out["INS"])
    _combine_del(del_sigs, chrom, rec.qname, merge_del_threshold, out["DEL"])

    if process_signal not in (1, 2):
        return
    sa = rec.tags.get("SA")
    if sa is None:
        return
    # primary segment from clip lengths, in original read orientation
    if rec.mapq >= min_mapq:
        if process_signal == 1:
            primary = [softclip_left, rec.query_length - softclip_right,
                       pos_start, pos_end, chrom, "+"]
        else:
            primary = [softclip_right, rec.query_length - softclip_left,
                       pos_start, pos_end, chrom, "-"]
    else:
        primary = []
    query_seq = rec.seq if process_signal == 1 else revcomp(rec.seq)

    split_read = []
    sa_min_mapq = min_mapq
    if primary:
        split_read.append(primary)
        sa_min_mapq = 0
    total_l = rec.query_length
    for entry in sa.split(";")[:-1]:
        fields = entry.split(",")
        sa_chr = fields[0]
        sa_pos = int(fields[1]) - 1  # SA pos is 1-based (SAM spec)
        sa_strand = fields[2]
        sa_cigar = fields[3]
        sa_mapq = int(fields[4])
        if sa_mapq < sa_min_mapq:
            continue
        first_clip, last_clip, ref_span = _clip_profile(sa_cigar)
        if sa_strand == "+":
            split_read.append([first_clip, total_l - last_clip, sa_pos,
                               sa_pos + ref_span, sa_chr, sa_strand])
        else:
            split_read.append([last_clip, total_l - first_clip, sa_pos,
                               sa_pos + ref_span, sa_chr, sa_strand])
    if len(split_read) <= max_split_parts or max_split_parts == -1:
        _analyse_split_read(split_read, sv_size, total_l, rec.qname, out,
                            max_size, query_seq)


def new_candidate_dict() -> Dict[str, list]:
    return {"DEL": [], "INS": [], "DUP": [], "INV": [], "TRA": []}
