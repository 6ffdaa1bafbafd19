// bamdecode: native BAM -> SV-signature tensor decoder.
//
// Host-side hot path of the cutesv-tpu engine (SURVEY §7 L0): streams a
// BGZF/BAM file once (bounded memory), walks every alignment record, and
// reproduces the reference caller's stage-1 signature semantics
// (parse_read cuteSV:606-681, generate_combine_sigs cuteSV:515-575,
// organize_split_signal cuteSV:483-513, analysis_split_read
// cuteSV:190-464) into dense structure-of-arrays outputs ready for
// numpy/PyTorch. Behavior is golden-tested record-for-record against
// cutesv_tpu_torch/extract.py.
//
// A BAM's BGZF blocks inflate where the decode's device is: given the
// card back end (a CardInflate table from cutesv_tpu_torch/csrc/
// bgzf_inflate.cu, passed in by io/native.py for a CUDA device), a
// submitter thread stages and launches batches of blocks on the card while
// this thread parses the batch before, and no zlib thread runs; without
// it, a pool of zlib threads inflates them (a CPU device). A CRAM's blocks, and a bgzipped FASTA's, always use
// zlib. This file includes no CUDA header: the card is reached only
// through the table's C functions.
//
// C ABI at the bottom; consumed by cutesv_tpu_torch/io/native.py via
// ctypes. Built by cutesv_tpu_torch/ops/build.py with
//   g++ -O3 -march=native -std=c++17 -fPIC -shared bamdecode.cpp
//       -l:libz.so.1 -l:liblzma.so.5 -l:libbz2.so.1.0 -lpthread

#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#include <algorithm>
#include <array>
#include <atomic>
#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <stdexcept>
#include <string>
#include <string_view>
#include <thread>
#include <mutex>
#include <condition_variable>
#include <memory>
#include <unordered_map>
#include <vector>
#include <chrono>
#include <deque>
#include <functional>
#include <set>

// the card back end's table (CardInflate), shared with bgzf_inflate.cu
#include "../csrc/card_inflate.h"

// ---------------------------------------------------------------------------
// compression back end: zlib (raw deflate, gzip, zlib framing, CRC-32) and
// liblzma (xz), declared here instead of through zlib.h / lzma.h. Only the
// runtime libraries (libz.so.1, liblzma.so.5; libbz2.so.1.0 in
// cramdecode.inc) can be assumed where this builds, not their development
// headers. The declarations follow the stable public ABI of zlib 1.2/1.3
// and liblzma 5; inflateInit2_ itself rejects a z_stream whose size
// differs from the library's.
// ---------------------------------------------------------------------------
extern "C" {
struct z_stream_s {
  const unsigned char* next_in;
  unsigned int avail_in;
  unsigned long total_in;
  unsigned char* next_out;
  unsigned int avail_out;
  unsigned long total_out;
  const char* msg;
  void* state;
  void* (*zalloc)(void*, unsigned int, unsigned int);
  void (*zfree)(void*, void*);
  void* opaque;
  int data_type;
  unsigned long adler;
  unsigned long reserved;
};
const char* zlibVersion(void);
int inflateInit2_(z_stream_s* strm, int window_bits, const char* version,
                  int stream_size);
int inflate(z_stream_s* strm, int flush);
int inflateReset(z_stream_s* strm);
int inflateEnd(z_stream_s* strm);
unsigned long crc32(unsigned long crc, const unsigned char* buf,
                    unsigned int len);
// lzma_ret is an enum; LZMA_OK == 0
int lzma_stream_buffer_decode(uint64_t* memlimit, uint32_t flags,
                              const void* allocator, const uint8_t* in,
                              size_t* in_pos, size_t in_size, uint8_t* out,
                              size_t* out_pos, size_t out_size);
}

namespace {

// now on the epoch clock, in ns (what Python's time.time_ns() reads)
int64_t epoch_ns() {
  return std::chrono::duration_cast<std::chrono::nanoseconds>(
             std::chrono::system_clock::now().time_since_epoch())
      .count();
}

// One reusable zlib inflate stream; ``window_bits`` picks the framing as
// for inflateInit2 (-15 raw deflate, 15 zlib, 31 gzip).
class ZInflater {
 public:
  explicit ZInflater(int window_bits) {
    memset(&s_, 0, sizeof(s_));
    ok_ = inflateInit2_(&s_, window_bits, zlibVersion(),
                        (int)sizeof(s_)) == 0 /*Z_OK*/;
  }
  ~ZInflater() {
    if (ok_) inflateEnd(&s_);
  }
  ZInflater(const ZInflater&) = delete;
  ZInflater& operator=(const ZInflater&) = delete;
  bool ok() const { return ok_; }

  // Inflate one whole stream from src[0, n) into dst[0, cap). True when
  // the stream ended (Z_STREAM_END) inside the input with its output
  // fitting in cap; *actual is then the inflated length. Input after the
  // stream's end is ignored, as libdeflate's one-shot calls do.
  bool run(const void* src, size_t n, void* dst, size_t cap,
           size_t* actual) {
    *actual = 0;
    if (!ok_ || inflateReset(&s_) != 0) return false;
    unsigned char scratch = 0;  // zlib rejects a null next_out
    s_.next_in = (const unsigned char*)src;
    s_.next_out = dst ? (unsigned char*)dst : &scratch;
    size_t in_left = n, out_left = dst ? cap : 0;
    for (;;) {
      // avail_* are 32-bit: feed inputs and outputs above 1 GiB in pieces
      unsigned int ai = (unsigned int)std::min<size_t>(in_left, 1u << 30);
      unsigned int ao = (unsigned int)std::min<size_t>(out_left, 1u << 30);
      s_.avail_in = ai;
      s_.avail_out = ao;
      int rc = inflate(&s_, 0 /*Z_NO_FLUSH*/);
      in_left -= ai - s_.avail_in;
      out_left -= ao - s_.avail_out;
      if (rc == 1 /*Z_STREAM_END*/) {
        *actual = (dst ? cap : 0) - out_left;
        return true;
      }
      // Z_BUF_ERROR (input used up or output full before the end) and
      // every data or memory error end the call
      if (rc != 0 /*Z_OK*/) return false;
    }
  }

 private:
  z_stream_s s_;
  bool ok_ = false;
};

// ---------------------------------------------------------------------------
// small infra
// ---------------------------------------------------------------------------

struct Params {
  int64_t min_size;            // SV_size
  int64_t min_mapq;
  int64_t max_split_parts;
  int64_t min_read_len;
  int64_t min_siglength;
  int64_t merge_del_threshold;
  int64_t merge_ins_threshold;
  int64_t max_size;
  int64_t n_threads;
  // sharded decode (multi-host): seek to this compressed offset (a BGZF
  // block boundary; <=0 = whole file) and own records whose uncompressed
  // start offset (relative to the range start) is < range_ulen (<=0 =
  // unbounded)
  int64_t range_start = 0;
  int64_t range_ulen = 0;
};

template <class T>
struct Out {
  std::vector<T> v;
  void push(T x) { v.push_back(x); }
};

// Python-equivalent string slice: negative indices count from the end,
// bounds clamp, empty when start >= stop.
inline std::string pyslice(const std::string& s, int64_t a, int64_t b) {
  int64_t n = (int64_t)s.size();
  if (a < 0) a += n;
  if (b < 0) b += n;
  a = std::max<int64_t>(0, std::min(a, n));
  b = std::max<int64_t>(0, std::min(b, n));
  if (a >= b) return std::string();
  return s.substr(a, b - a);
}

// IUPAC-complete complement table (Bio.Seq.reverse_complement equivalent;
// mirrors cutesv_tpu/extract.py::_COMP).
struct RC {
  char t[256];
  RC() {
    for (int i = 0; i < 256; i++) t[i] = (char)i;
    const char* from = "ACGTUacgtuRYKMrykmBVDHbvdhNnSsWw-";
    const char* to = "TGCAAtgcaaYRMKyrmkVBHDvbhdNnSsWw-";
    for (int i = 0; from[i]; i++) t[(unsigned char)from[i]] = to[i];
  }
};
const RC kRC;

inline std::string revcomp(const std::string& s) {
  std::string out(s.rbegin(), s.rend());
  for (auto& c : out) c = kRC.t[(unsigned char)c];
  return out;
}

const char kSeqNT16[17] = "=ACMGRSVTWYHKDBN";

// packed byte -> two ASCII bases at once
struct SeqLut {
  uint16_t t[256];
  SeqLut() {
    for (int b = 0; b < 256; b++) {
      uint16_t hi = (uint8_t)kSeqNT16[b >> 4];
      uint16_t lo = (uint8_t)kSeqNT16[b & 0xF];
      t[b] = (uint16_t)(hi | (lo << 8));  // little-endian: hi char first
    }
  }
};
const SeqLut kSeqLut;

// MurmurHash64A-style byte hash for the name intern tables: hashing the
// qname bytes in place avoids the per-record std::string construction +
// std::hash the unordered_map path paid, and the stored 64-bit hash lets
// chunk merges re-probe without re-reading the bytes.
inline uint64_t hash_bytes(const void* key, size_t len) {
  const uint64_t m = 0xc6a4a7935bd1e995ULL;
  uint64_t h = 0x8445d61a4e774912ULL ^ (len * m);
  const unsigned char* p = (const unsigned char*)key;
  size_t n8 = len / 8;
  for (size_t i = 0; i < n8; i++) {
    uint64_t k;
    memcpy(&k, p + 8 * i, 8);
    k *= m; k ^= k >> 47; k *= m;
    h ^= k; h *= m;
  }
  uint64_t k = 0;
  const unsigned char* tail = p + 8 * n8;
  switch (len & 7) {
    case 7: k ^= (uint64_t)tail[6] << 48; [[fallthrough]];
    case 6: k ^= (uint64_t)tail[5] << 40; [[fallthrough]];
    case 5: k ^= (uint64_t)tail[4] << 32; [[fallthrough]];
    case 4: k ^= (uint64_t)tail[3] << 24; [[fallthrough]];
    case 3: k ^= (uint64_t)tail[2] << 16; [[fallthrough]];
    case 2: k ^= (uint64_t)tail[1] << 8; [[fallthrough]];
    case 1: k ^= (uint64_t)tail[0]; h ^= k; h *= m; break;
    case 0: break;
  }
  h ^= h >> 47; h *= m; h ^= h >> 47;
  return h;
}

// ---------------------------------------------------------------------------
// output collector
// ---------------------------------------------------------------------------

struct Collector {
  // interned read names (first-appearance order): open-addressed table
  // keyed by byte hash — per-id blob offsets + stored hashes instead of
  // an unordered_map<string> (no per-record string allocation, and chunk
  // merges re-probe with the stored hash rather than rehashing bytes)
  std::string name_blob;
  std::vector<int64_t> name_off{0};
  std::vector<uint64_t> name_hash;  // per interned id
  std::vector<int64_t> nh_slot;     // id+1; 0 = empty (pow2 size)
  size_t nh_mask = 0;

  // interned chromosome names: [0, n_refs) header refs, then extras seen in
  // SA tags that are absent from the header
  std::vector<std::string> chroms;
  std::unordered_map<std::string, int32_t> chrom_ids;

  // DEL: (pos, len, name) per chrom
  Out<int32_t> del_chr; Out<int64_t> del_pos, del_len, del_name;
  // INS: pos doubled to stay integral for split-read midpoints
  Out<int32_t> ins_chr; Out<int64_t> ins_posx2, ins_len, ins_name;
  Out<int64_t> ins_seq_off, ins_seq_len;
  std::string ins_seq_blob;
  // DUP
  Out<int32_t> dup_chr; Out<int64_t> dup_p1, dup_p2, dup_name;
  // INV: strand 0='++', 1='--'
  Out<int32_t> inv_chr; Out<int8_t> inv_strand;
  Out<int64_t> inv_b1, inv_b2, inv_name;
  // TRA: bnd type 0..3 = A..D
  Out<int32_t> tra_chr1, tra_chr2; Out<int8_t> tra_type;
  Out<int64_t> tra_p1, tra_p2, tra_name;
  // census (filtered records) + allreads (every mapped record)
  Out<int32_t> cen_chr; Out<int64_t> cen_start, cen_end, cen_name;
  Out<int8_t> cen_prim;
  Out<int32_t> all_chr; Out<int64_t> all_start, all_end, all_name;
  Out<int8_t> all_prim;

  int64_t n_records = 0;

  // per-stream chrom id -> [first,last] row index, maintained at merge
  // so snapshots scan one chromosome's span instead of the whole stream
  // (the input is coordinate-sorted, so spans are tight modulo late
  // SA-tag rows); only the merged-into global collector populates these
  std::unordered_map<int32_t, std::pair<size_t, size_t>> rng[6];

  void note_range(int which, const std::vector<int32_t>& chr,
                  size_t from) {
    auto& m = rng[which];
    for (size_t i = from; i < chr.size(); i++) {
      auto ins = m.emplace(chr[i], std::make_pair(i, i));
      if (!ins.second) ins.first->second.second = i;
    }
  }

  void nh_grow() {
    size_t cap = nh_slot.empty() ? 4096 : nh_slot.size() * 2;
    nh_slot.assign(cap, 0);
    nh_mask = cap - 1;
    for (size_t id = 0; id < name_hash.size(); id++) {
      size_t i = name_hash[id] & nh_mask;
      while (nh_slot[i]) i = (i + 1) & nh_mask;
      nh_slot[i] = (int64_t)id + 1;
    }
  }
  int64_t intern_name_raw(const char* p, size_t n, uint64_t h) {
    if ((name_hash.size() + 1) * 10 >= nh_slot.size() * 7) nh_grow();
    size_t i = h & nh_mask;
    while (nh_slot[i]) {
      int64_t id = nh_slot[i] - 1;
      if (name_hash[id] == h &&
          name_off[id + 1] - name_off[id] == (int64_t)n &&
          memcmp(name_blob.data() + name_off[id], p, n) == 0)
        return id;
      i = (i + 1) & nh_mask;
    }
    int64_t id = (int64_t)name_off.size() - 1;
    nh_slot[i] = id + 1;
    name_hash.push_back(h);
    name_blob.append(p, n);
    name_off.push_back((int64_t)name_blob.size());
    return id;
  }
  int64_t intern_name(const std::string& s) {
    return intern_name_raw(s.data(), s.size(), hash_bytes(s.data(),
                                                          s.size()));
  }
  int32_t intern_chrom(const std::string& s) {
    auto it = chrom_ids.find(s);
    if (it != chrom_ids.end()) return it->second;
    int32_t id = (int32_t)chroms.size();
    chroms.push_back(s);
    chrom_ids.emplace(s, id);
    return id;
  }
  // Append another collector's outputs (a worker's chunk share),
  // remapping its interned name/chrom ids into this table. Row order is
  // preserved, so per-chunk, per-range concatenation keeps file order.
  void merge_from(const Collector& o) {
    std::vector<int64_t> nmap(o.name_off.size() - 1);
    for (size_t i = 0; i + 1 < o.name_off.size(); i++)
      nmap[i] = intern_name_raw(o.name_blob.data() + o.name_off[i],
                                (size_t)(o.name_off[i + 1] - o.name_off[i]),
                                o.name_hash[i]);
    std::vector<int32_t> cmap(o.chroms.size());
    for (size_t i = 0; i < o.chroms.size(); i++)
      cmap[i] = intern_chrom(o.chroms[i]);
    auto cat_n = [&](Out<int64_t>& d, const Out<int64_t>& s) {
      for (auto v : s.v) d.push(nmap[v]);
    };
    auto cat_c = [&](Out<int32_t>& d, const Out<int32_t>& s) {
      for (auto v : s.v) d.push(cmap[v]);
    };
    auto cat = [&](auto& d, const auto& s) {
      d.v.insert(d.v.end(), s.v.begin(), s.v.end());
    };
    size_t f_del = del_chr.v.size(), f_ins = ins_chr.v.size();
    size_t f_dup = dup_chr.v.size(), f_inv = inv_chr.v.size();
    size_t f_tra = tra_chr1.v.size(), f_cen = cen_chr.v.size();
    cat_c(del_chr, o.del_chr); cat(del_pos, o.del_pos);
    cat(del_len, o.del_len); cat_n(del_name, o.del_name);
    int64_t soff = (int64_t)ins_seq_blob.size();
    cat_c(ins_chr, o.ins_chr); cat(ins_posx2, o.ins_posx2);
    cat(ins_len, o.ins_len); cat_n(ins_name, o.ins_name);
    for (auto v : o.ins_seq_off.v) ins_seq_off.push(v + soff);
    cat(ins_seq_len, o.ins_seq_len);
    ins_seq_blob += o.ins_seq_blob;
    cat_c(dup_chr, o.dup_chr); cat(dup_p1, o.dup_p1);
    cat(dup_p2, o.dup_p2); cat_n(dup_name, o.dup_name);
    cat_c(inv_chr, o.inv_chr); cat(inv_strand, o.inv_strand);
    cat(inv_b1, o.inv_b1); cat(inv_b2, o.inv_b2); cat_n(inv_name, o.inv_name);
    cat_c(tra_chr1, o.tra_chr1); cat(tra_type, o.tra_type);
    cat(tra_p1, o.tra_p1); cat_c(tra_chr2, o.tra_chr2);
    cat(tra_p2, o.tra_p2); cat_n(tra_name, o.tra_name);
    cat_c(cen_chr, o.cen_chr); cat(cen_start, o.cen_start);
    cat(cen_end, o.cen_end); cat(cen_prim, o.cen_prim);
    cat_n(cen_name, o.cen_name);
    note_range(0, del_chr.v, f_del);
    note_range(1, ins_chr.v, f_ins);
    note_range(2, dup_chr.v, f_dup);
    note_range(3, inv_chr.v, f_inv);
    note_range(4, tra_chr1.v, f_tra);
    note_range(5, cen_chr.v, f_cen);
    cat_c(all_chr, o.all_chr); cat(all_start, o.all_start);
    cat(all_end, o.all_end); cat(all_prim, o.all_prim);
    cat_n(all_name, o.all_name);
    n_records += o.n_records;
  }

  // Reset a worker-local collector for reuse on the next chunk: outputs
  // and the name table clear but keep their capacity; the chrom table
  // persists (header chroms keep their ids; SA-extra chroms are remapped
  // at merge anyway).
  void reset_outputs() {
    name_blob.clear();
    name_off.assign(1, 0);
    name_hash.clear();
    std::fill(nh_slot.begin(), nh_slot.end(), 0);
    auto clr = [](auto& o) { o.v.clear(); };
    clr(del_chr); clr(del_pos); clr(del_len); clr(del_name);
    clr(ins_chr); clr(ins_posx2); clr(ins_len); clr(ins_name);
    clr(ins_seq_off); clr(ins_seq_len);
    ins_seq_blob.clear();
    clr(dup_chr); clr(dup_p1); clr(dup_p2); clr(dup_name);
    clr(inv_chr); clr(inv_strand); clr(inv_b1); clr(inv_b2); clr(inv_name);
    clr(tra_chr1); clr(tra_chr2); clr(tra_type); clr(tra_p1); clr(tra_p2);
    clr(tra_name);
    clr(cen_chr); clr(cen_start); clr(cen_end); clr(cen_name);
    clr(cen_prim);
    clr(all_chr); clr(all_start); clr(all_end); clr(all_name);
    clr(all_prim);
    for (auto& m : rng) m.clear();
    n_records = 0;
  }

  void add_ins(int32_t chr, int64_t posx2, int64_t len, int64_t name,
               const std::string& seq) {
    ins_chr.push(chr); ins_posx2.push(posx2); ins_len.push(len);
    ins_name.push(name);
    ins_seq_off.push((int64_t)ins_seq_blob.size());
    ins_seq_len.push((int64_t)seq.size());
    ins_seq_blob.append(seq);
  }
};

// ---------------------------------------------------------------------------
// split-read segment
// ---------------------------------------------------------------------------

struct Seg {
  int64_t rs, re;   // read-coordinate start/end
  int64_t qs, qe;   // reference start/end
  int32_t chr;
  char strand;      // '+' / '-'
};

inline Seg flip(const Seg& s, int64_t rlen) {
  Seg o = s;
  o.rs = rlen - s.re;
  o.re = rlen - s.rs;
  return o;
}

// ---------------------------------------------------------------------------
// extraction (semantics of cutesv_tpu/extract.py == reference stage 1)
// ---------------------------------------------------------------------------

struct Extractor {
  const Params& P;
  Collector& C;

  Extractor(const Params& p, Collector& c) : P(p), C(c) {}

  // --- shared INS/DEL rules for a collinear pair (cuteSV:241-257 etc.) ---
  void emit_indel_pair(const Seg& e1, const Seg& e2,
                       const std::string& query_res, int64_t name,
                       bool ins_guard, bool del_guard) {
    int64_t delta = e2.rs + e1.qe - e2.qs - e1.re;
    double d5 = (double)delta / 5.0;
    if ((double)(e1.qe - e2.qs) < std::max((double)P.min_size, d5) &&
        delta >= P.min_size) {
      if ((double)(e2.qs - e1.qe) <= std::max(100.0, d5) &&
          (delta <= P.max_size || P.max_size == -1)) {
        if (ins_guard) {
          int64_t half = (e2.qs - e1.qe) / 2;  // trunc toward 0, like int()
          C.add_ins(e2.chr, e2.qs + e1.qe, delta, name,
                    pyslice(query_res, e1.re + half, e2.rs - half));
        }
      }
    }
    delta = e2.qs - e2.rs + e1.re - e1.qe;
    d5 = (double)delta / 5.0;
    if ((double)(e1.qe - e2.qs) < std::max((double)P.min_size, d5) &&
        delta >= P.min_size) {
      if ((double)(e2.rs - e1.re) <= std::max(100.0, d5) &&
          (delta <= P.max_size || P.max_size == -1)) {
        if (del_guard) {
          C.del_chr.push(e2.chr);
          C.del_pos.push(e1.qe);
          C.del_len.push(delta);
          C.del_name.push(name);
        }
      }
    }
  }

  // --- inversion breakpoints (cuteSV:50-94) ---
  void emit_inv(const Seg& e1, const Seg& e2, int64_t name) {
    if (e1.strand == '+') {
      if (e1.qe - e2.qe >= P.min_size &&
          (double)e2.rs + 0.5 * (double)(e1.qe - e2.qe) >= (double)e1.re) {
        C.inv_chr.push(e1.chr); C.inv_strand.push(0);
        C.inv_b1.push(e2.qe); C.inv_b2.push(e1.qe); C.inv_name.push(name);
      }
      if (e2.qe - e1.qe >= P.min_size &&
          (double)e2.rs + 0.5 * (double)(e2.qe - e1.qe) >= (double)e1.re) {
        C.inv_chr.push(e1.chr); C.inv_strand.push(0);
        C.inv_b1.push(e1.qe); C.inv_b2.push(e2.qe); C.inv_name.push(name);
      }
    } else {
      if (e2.qs - e1.qs >= P.min_size &&
          (double)e2.rs + 0.5 * (double)(e2.qs - e1.qs) >= (double)e1.re) {
        C.inv_chr.push(e1.chr); C.inv_strand.push(1);
        C.inv_b1.push(e1.qs); C.inv_b2.push(e2.qs); C.inv_name.push(name);
      }
      if (e1.qs - e2.qs >= P.min_size &&
          (double)e2.rs + 0.5 * (double)(e1.qs - e2.qs) >= (double)e1.re) {
        C.inv_chr.push(e1.chr); C.inv_strand.push(1);
        C.inv_b1.push(e2.qs); C.inv_b2.push(e1.qs); C.inv_name.push(name);
      }
    }
  }

  // --- breakends (cuteSV:97-188); chrom ORDER is by name string ---------
  void emit_bnd(const Seg& e1, const Seg& e2, int64_t name) {
    if (e2.rs - e1.re > 100) return;
    bool lt = C.chroms[e1.chr] < C.chroms[e2.chr];
    int8_t type;
    int64_t p1, p2;
    int32_t c1, c2;
    if (e1.strand == '+') {
      if (e2.strand == '+') {
        if (lt) { type = 0; p1 = e1.qe; c2 = e2.chr; p2 = e2.qs; c1 = e1.chr; }
        else    { type = 3; p1 = e2.qs; c2 = e1.chr; p2 = e1.qe; c1 = e2.chr; }
      } else {
        if (lt) { type = 1; p1 = e1.qe; c2 = e2.chr; p2 = e2.qe; c1 = e1.chr; }
        else    { type = 1; p1 = e2.qe; c2 = e1.chr; p2 = e1.qe; c1 = e2.chr; }
      }
    } else {
      if (e2.strand == '+') {
        if (lt) { type = 2; p1 = e1.qs; c2 = e2.chr; p2 = e2.qs; c1 = e1.chr; }
        else    { type = 2; p1 = e2.qs; c2 = e1.chr; p2 = e1.qs; c1 = e2.chr; }
      } else {
        if (lt) { type = 3; p1 = e1.qs; c2 = e2.chr; p2 = e2.qe; c1 = e1.chr; }
        else    { type = 0; p1 = e2.qe; c2 = e1.chr; p2 = e1.qs; c1 = e2.chr; }
      }
    }
    C.tra_chr1.push(c1); C.tra_type.push(type); C.tra_p1.push(p1);
    C.tra_chr2.push(c2); C.tra_p2.push(p2); C.tra_name.push(name);
  }

  void analyse_two(const std::vector<Seg>& sp, int64_t rlen, int64_t name,
                   const std::string& query_in) {
    Seg e1 = sp[0], e2 = sp[1];
    if (e1.chr != e2.chr) { emit_bnd(e1, e2, name); return; }
    if (e1.strand != e2.strand) { emit_inv(e1, e2, name); return; }
    std::string query = query_in;
    if (e1.strand == '-') {
      e1 = flip(sp[1], rlen);
      e2 = flip(sp[0], rlen);
      query = revcomp(query_in);
    }
    if (e1.qe - e2.qs >= P.min_size) {
      if (e2.rs - e1.re >= e1.qe - e2.qs) {
        int64_t half = (e2.qs - e1.qe) / 2;
        C.add_ins(e2.chr, e1.qe + e2.qs, e2.rs + e1.qe - e2.qs - e1.re, name,
                  pyslice(query, e1.re + half, e2.rs - half));
      } else {
        C.dup_chr.push(e2.chr); C.dup_p1.push(e2.qs); C.dup_p2.push(e1.qe);
        C.dup_name.push(name);
      }
    }
    emit_indel_pair(e1, e2, query, name, true, true);
  }

  void analyse_multi(const std::vector<Seg>& sp, int64_t rlen, int64_t name,
                     const std::string& query) {
    int64_t n = (int64_t)sp.size();
    bool saw_bnd = false;
    std::string query_rc;  // lazily computed
    auto rc = [&]() -> const std::string& {
      if (query_rc.empty()) query_rc = revcomp(query);
      return query_rc;
    };
    for (int64_t a = 0; a + 2 < n; a++) {
      Seg e1 = sp[a], e2 = sp[a + 1], e3 = sp[a + 2];
      bool have_e3 = true;
      if (e1.chr != e2.chr) {
        saw_bnd = true;
        emit_bnd(e1, e2, name);
        if (a == n - 3 && e2.chr != e3.chr) emit_bnd(e2, e3, name);
        continue;
      }
      if (e2.chr != e3.chr) continue;  // reference: outer if falls through

      if (e1.strand == e3.strand && e1.strand != e2.strand) {
        if (e2.strand == '-') {  // +-+ full inversion
          double mid = 0.5 * (double)(e3.qs - e1.qe);
          if ((double)e2.rs + mid >= (double)e1.re &&
              (double)e3.rs + mid >= (double)e2.re) {
            if (e2.qs >= e1.qe && e3.qs >= e2.qe) {
              C.inv_chr.push(e1.chr); C.inv_strand.push(0);
              C.inv_b1.push(e1.qe); C.inv_b2.push(e2.qe);
              C.inv_name.push(name);
              C.inv_chr.push(e1.chr); C.inv_strand.push(1);
              C.inv_b1.push(e2.qs); C.inv_b2.push(e3.qs);
              C.inv_name.push(name);
            }
          }
        } else {  // -+-
          double mid = 0.5 * (double)(e1.qs - e3.qe);
          if ((double)e1.re <= (double)e2.rs + mid &&
              (double)e3.rs + mid >= (double)e2.re) {
            if (e2.qs - e3.qe >= -50 && e1.qs - e2.qe >= -50) {
              C.inv_chr.push(e1.chr); C.inv_strand.push(0);
              C.inv_b1.push(e3.qe); C.inv_b2.push(e2.qe);
              C.inv_name.push(name);
              C.inv_chr.push(e1.chr); C.inv_strand.push(1);
              C.inv_b1.push(e2.qs); C.inv_b2.push(e1.qs);
              C.inv_name.push(name);
            }
          }
        }
      }
      if (a == n - 3 && e1.strand != e3.strand) {
        if (e2.strand == e1.strand) emit_inv(e2, e3, name);
        else emit_inv(e1, e2, name);
      }

      if (e1.strand == e3.strand && e1.strand == e2.strand) {
        // collinear triple (cuteSV:333-399)
        const std::string* query_res = &query;
        if (e1.strand == '-') {
          e1 = flip(sp[a + 2], rlen);
          e2 = flip(sp[a + 1], rlen);
          e3 = flip(sp[a], rlen);
          query_res = &rc();
        }
        if (e2.qe - e3.qs >= P.min_size && e2.qs < e3.qe) {
          C.dup_chr.push(e2.chr); C.dup_p1.push(e3.qs); C.dup_p2.push(e2.qe);
          C.dup_name.push(name);
        }
        if (a == 0 && e1.qe - e2.qs >= P.min_size) {
          C.dup_chr.push(e2.chr); C.dup_p1.push(e2.qs); C.dup_p2.push(e1.qe);
          C.dup_name.push(name);
        }
        bool guard = e3.qs >= e2.qe;
        emit_indel_pair(e1, e2, *query_res, name, guard, guard);
        if (a == n - 3) emit_indel_pair(e2, e3, *query_res, name, true, true);
        continue;
      }

      // mixed-strand windows (cuteSV:401-429, with the reference's
      // sp[a]/sp[a+1] flip-index quirk preserved)
      bool tail_mixed =
          (a == n - 3 && e1.strand != e2.strand && e2.strand == e3.strand);
      if (tail_mixed) {
        e1 = e2;
        e2 = e3;
        have_e3 = false;
      }
      if (!have_e3 || (e1.strand == e2.strand && e2.strand != e3.strand)) {
        const std::string* query_res = &query;
        if (e1.strand == '-') {
          e1 = flip(sp[a + 1], rlen);
          e2 = flip(sp[a], rlen);
          query_res = &rc();
        }
        emit_indel_pair(e1, e2, *query_res, name, true, true);
      }
    }

    if (n >= 3 && saw_bnd) {
      // INS inside a translocation (cuteSV:439-464)
      const Seg& first = sp[0];
      const Seg& last = sp[n - 1];
      if (first.chr == last.chr && first.strand == last.strand) {
        Seg e1, e2;
        const std::string* query_res;
        if (first.strand == '+') {
          e1 = first; e2 = last; query_res = &query;
        } else {
          e1 = flip(last, rlen); e2 = flip(first, rlen); query_res = &rc();
        }
        int64_t dis_ref = e2.qs - e1.qe;
        int64_t dis_read = e2.rs - e1.re;
        int64_t excess = dis_read - dis_ref;
        if ((double)std::llabs(dis_ref) <
                std::max((double)P.min_size, (double)excess / 5.0) &&
            excess >= P.min_size &&
            (excess <= P.max_size || P.max_size == -1)) {
          int64_t half = dis_ref / 2;
          C.add_ins(e2.chr, 2 * std::min(e2.qs, e1.qe), excess, name,
                    pyslice(*query_res, e1.re + half, e2.rs - half));
        }
        if (dis_ref <= -P.min_size) {
          C.dup_chr.push(e2.chr); C.dup_p1.push(e2.qs); C.dup_p2.push(e1.qe);
          C.dup_name.push(name);
        }
      }
    }
  }

  void analyse_split(std::vector<Seg>& sp, int64_t rlen, int64_t name,
                     const std::string& query) {
    std::stable_sort(sp.begin(), sp.end(),
                     [](const Seg& a, const Seg& b) { return a.rs < b.rs; });
    if (sp.size() < 2) return;
    if (sp.size() == 2) analyse_two(sp, rlen, name, query);
    else analyse_multi(sp, rlen, name, query);
  }
};

// ---------------------------------------------------------------------------
// BGZF chunked reader (multithreaded inflate)
// ---------------------------------------------------------------------------

// growable raw byte buffer: no zero-fill on growth, reused across chunks
// (std::string::resize would write the whole chunk twice — zero-fill then
// inflate — and reallocate every iteration). It may instead view memory it
// does not own (a card back end's pinned slot, ``view``), which never grows.
struct RawBuf {
  std::unique_ptr<char[]> mem;
  char* ext = nullptr;
  size_t cap = 0;
  size_t start = 0, len = 0;  // valid payload = [start, len)
  void ensure(size_t n) {
    if (cap >= n) return;
    if (ext) throw std::runtime_error("card inflate: a batch overflows its slot");
    size_t nc = std::max(n, cap * 2);
    std::unique_ptr<char[]> nm(new char[nc]);
    if (len > 0) memcpy(nm.get(), mem.get(), len);
    mem.swap(nm);
    cap = nc;
  }
  void view(char* p, size_t n) {
    mem.reset();
    ext = p;
    cap = n;
  }
  char* data() { return ext ? ext : mem.get(); }
  const char* data() const { return ext ? ext : mem.get(); }
};

// Parse one BGZF block header inside a mapping; fills the payload span,
// inflated size and the next block position. False on ANY irregularity
// (magic, overruns, missing BSIZE, isize beyond the 64 KiB spec cap) —
// callers decide truncated vs fallback. Shared by the chunk reader and
// the block-table scanner so their validation cannot drift.
inline bool bgzf_parse_block_at(const uint8_t* map, size_t size,
                                size_t pos, size_t* cdata_off,
                                uint32_t* cdata_len, uint32_t* isize,
                                size_t* next_pos) {
  if (pos + 28 > size) return false;
  const uint8_t* h = map + pos;
  if (h[0] != 0x1f || h[1] != 0x8b) return false;
  uint16_t xlen = (uint16_t)(h[10] | (h[11] << 8));
  if (pos + 12 + (size_t)xlen > size) return false;
  const uint8_t* extra = h + 12;
  int bsize = -1;
  for (int o = 0; o + 4 <= (int)xlen;) {
    uint8_t s1 = extra[o], s2 = extra[o + 1];
    uint16_t slen = (uint16_t)(extra[o + 2] | (extra[o + 3] << 8));
    if (s1 == 66 && s2 == 67 && slen == 2 && o + 6 <= (int)xlen)
      bsize = extra[o + 4] | (extra[o + 5] << 8);
    if (o + 4 + (int)slen > (int)xlen) break;
    o += 4 + slen;
  }
  if (bsize < 0 || (size_t)bsize + 1 < 12u + xlen + 8u
      || pos + (size_t)bsize + 1 > size)
    return false;
  size_t cl = (size_t)bsize + 1 - 12 - xlen - 8;
  const uint8_t* tail = h + 12 + xlen + cl;
  uint32_t is = (uint32_t)tail[4] | ((uint32_t)tail[5] << 8)
                | ((uint32_t)tail[6] << 16) | ((uint32_t)tail[7] << 24);
  if (is > 65536) return false;
  *cdata_off = pos + 12 + xlen;
  *cdata_len = (uint32_t)cl;
  *isize = is;
  *next_pos = pos + (size_t)bsize + 1;
  return true;
}

// Two back ends inflate the blocks: a pool of zlib threads (the caller's
// thread helps), or, given a CardInflate, the card: batches of blocks
// inflate there while the caller parses, with no zlib thread at all.
struct BgzfChunkReader {
  FILE* f;
  int n_threads;
  bool eof = false;
  bool truncated = false;  // stream ended mid-block (corrupt/cut file)
  // a stream's block whose header read_chunk read but whose payload it
  // left for the next chunk (its length; 0: none)
  size_t held_cdata = 0;
  std::atomic<bool> inflate_bad{false};  // a block failed to inflate
  // blocks inflated by each back end
  std::atomic<int64_t> blocks_host{0};
  int64_t blocks_card = 0;
  // zero-copy mode: regular files are mmap'd and blocks reference the
  // mapping directly — the per-chunk fread copy of ~the whole file is
  // the single biggest avoidable decode cost on CPU-starved hosts
  const uint8_t* map = nullptr;
  size_t map_size = 0, map_pos = 0;

  struct Blk {
    size_t off;  // into the chunk's flat compressed buffer (or the map)
    uint32_t clen;
    uint32_t isize;
    size_t out_off;
  };
  // compressed payloads live in one flat reused buffer per chunk (two
  // chunks alive at once: the one being inflated and the read-ahead)
  struct Chunk {
    RawBuf cbuf;
    std::vector<Blk> blocks;
    size_t total = 0;
  };
  Chunk cur, ra;
  std::thread rat;        // read-ahead thread filling ``ra``
  bool ra_active = false;

  explicit BgzfChunkReader(FILE* fh, int threads,
                           const CardInflate* card_ = nullptr)
      : f(fh), n_threads(std::max(1, threads)), card(card_) {
    // more inflate participants than cores only adds contention: with
    // the persistent pool + async jobs the caller already helps in
    // finish_raw, so hw participants total measures fastest (round-5
    // A/B at 2 cores: hw -> 3.99 s wall / 6.6 inflate core-s, hw+1 ->
    // 4.3 s / 7.0-7.3 core-s on the 200 Mb corpus)
    int hw = (int)std::thread::hardware_concurrency();
    if (hw > 0) n_threads = std::min(n_threads, std::max(2, hw));
    static const int env_it = getenv("CUTESV_INFLATE_THREADS")
        ? atoi(getenv("CUTESV_INFLATE_THREADS")) : 0;
    if (env_it > 0) n_threads = env_it;
    int fd = fileno(fh);
    struct stat st;
    if (fd >= 0 && fstat(fd, &st) == 0 && S_ISREG(st.st_mode)
        && st.st_size > 0) {
      void* m = mmap(nullptr, (size_t)st.st_size, PROT_READ, MAP_PRIVATE,
                     fd, 0);
      if (m != MAP_FAILED) {
        map = (const uint8_t*)m;
        map_size = (size_t)st.st_size;
        madvise(m, map_size, MADV_SEQUENTIAL);
      }
    }
    if (card) {
      card->acquire(card->ctx);
      card_chunks.resize(card->lanes);
      card_slot_busy.assign(card->slots, 0);
      card_slot_total.assign(card->slots, 0);
      card_slot_blocks.assign(card->slots, 0);
      return;
    }
    // persistent inflate workers (the caller thread participates too, so
    // pool size is n_threads-1): spawning threads + allocating a
    // decompressor per chunk cost ~3 spawns x ~775 chunks per 200 Mb
    caller_d.reset(new ZInflater(-15));
    for (int i = 0; i < n_threads - 1; i++)
      pool.emplace_back([this]() { pool_main(); });
  }
  ~BgzfChunkReader() {
    stop_submitter();  // before the back end is released
    if (rat.joinable()) rat.join();
    finish_raw();  // a pending async job writes into caller-owned memory
    if (card) note_card(card->release(card->ctx));  // waits for all
    {
      std::lock_guard<std::mutex> lk(job_mu);
      shutdown_ = true;
    }
    job_cv.notify_all();
    for (auto& t : pool) t.join();
    if (map) munmap((void*)map, map_size);
  }

  // --- persistent inflate pool ---------------------------------------------
  // One job (chunk -> dst) at a time; jobs are published either
  // synchronously (inflate_blocks: caller helps, then waits) or
  // asynchronously (start_next_raw/finish_raw: workers inflate the NEXT
  // chunk while the caller parses the current one — this replaces the
  // old per-chunk outer prefetch thread). All publish/consume calls come
  // from one consumer thread at a time.
  std::vector<std::thread> pool;
  std::mutex job_mu;
  std::condition_variable job_cv, done_cv;
  const Chunk* job_chunk = nullptr;
  char* job_dst = nullptr;
  std::atomic<size_t> job_next{0};
  uint64_t job_gen = 0;
  int job_running = 0;
  bool job_pending = false;  // async job published; finish_raw() due
  bool shutdown_ = false;
  std::unique_ptr<ZInflater> caller_d;  // the caller thread's stream
  std::atomic<uint64_t> inflate_core_ns{0};  // busy core-ns in inflate_span

  void inflate_span(ZInflater* d, const Chunk& c, char* dst) {
    // always-on core-second accounting (one clock pair per participant
    // per chunk — ~3 calls per 128-block chunk, negligible): the bench
    // artifact publishes busy inflate CORE-seconds so "decode sits at
    // the inflate floor" is auditable from the JSON, not asserted.
    // CLOCK_THREAD_CPUTIME_ID: genuine CPU time of this thread — a
    // descheduled participant (3 inflate threads on 2 cores) does NOT
    // count its wait as work, unlike a steady_clock span
    struct Acc {
      std::atomic<uint64_t>& ns;
      timespec t0;
      Acc(std::atomic<uint64_t>& a) : ns(a) {
        clock_gettime(CLOCK_THREAD_CPUTIME_ID, &t0);
      }
      ~Acc() {
        timespec t1;
        clock_gettime(CLOCK_THREAD_CPUTIME_ID, &t1);
        ns.fetch_add((uint64_t)(t1.tv_sec - t0.tv_sec) * 1000000000u
                         + (uint64_t)(t1.tv_nsec - t0.tv_nsec),
                     std::memory_order_relaxed);
      }
    } acc{inflate_core_ns};
    if (!d || !d->ok()) {
      // decompressor allocation failed (OOM): claim nothing — the other
      // participants finish the chunk and the decode degrades to fewer
      // workers. The publish/consume sites verify job_next covered every
      // block after the join; only if EVERY participant was null does
      // the chunk flag bad there.
      return;
    }
    for (;;) {
      size_t i = job_next.fetch_add(1);
      if (i >= c.blocks.size()) break;
      const Blk& b = c.blocks[i];
      const char* src = map ? (const char*)map + b.off
                            : c.cbuf.data() + b.off;
      size_t actual = 0;
      bool ok = d->run(src, b.clen, dst + b.out_off, b.isize, &actual);
      // a corrupt deflate stream or an isize lying about the inflated
      // length must not leave uninitialized bytes to be parsed as
      // records: flag the chunk and let the consumer raise
      if (!ok || actual != b.isize)
        inflate_bad.store(true, std::memory_order_relaxed);
      blocks_host.fetch_add(1, std::memory_order_relaxed);
    }
  }

  void pool_main() {
    // this worker's own stream, released when the thread ends (at join)
    ZInflater d(-15);
    uint64_t seen = 0;
    for (;;) {
      const Chunk* c;
      char* dst;
      {
        std::unique_lock<std::mutex> lk(job_mu);
        job_cv.wait(lk, [&] { return shutdown_ || job_gen != seen; });
        if (shutdown_) break;
        seen = job_gen;
        c = job_chunk;
        dst = job_dst;
      }
      inflate_span(&d, *c, dst);
      {
        std::lock_guard<std::mutex> lk(job_mu);
        if (--job_running == 0) done_cv.notify_all();
      }
    }
  }

  void publish(const Chunk& c, char* dst) {
    std::lock_guard<std::mutex> lk(job_mu);
    job_chunk = &c;
    job_dst = dst;
    job_next.store(0, std::memory_order_relaxed);
    job_running = (int)pool.size();
    job_gen++;
    job_cv.notify_all();
  }

  void wait_done() {
    std::unique_lock<std::mutex> lk(job_mu);
    done_cv.wait(lk, [&] { return job_running == 0; });
  }

  bool seek_to(int64_t off) {
    map_pos = (size_t)off;
    if (!map) return fseek(f, (long)off, SEEK_SET) == 0;
    return true;
  }

  // --- the card back end ---------------------------------------------
  // Batches are read in order: submitted to the lanes round robin (the
  // lanes in use are the ``card_flight`` ones, oldest first), fetched into
  // free host slots in the same order (``card_ready``), and handed to the
  // caller in that order (``card_handed``; finish_raw waits for the last
  // one handed out). A lane is free once its batch is fetched, a slot once
  // the caller is done with its batch.
  //
  // From the caller's first card_next_raw on, a submitter thread reads,
  // stages and launches the batches (sub_main) while the caller fetches,
  // waits for and parses them: the two meet in ``card_flight`` under
  // ``sub_mu``. A lane's batch (``card_chunks[k]``) is the submitter's
  // until it is in flight, then the caller's until it is fetched; the
  // reader's position in the input (``map_pos``, ``eof``, ``truncated``,
  // the FILE) is the submitter's until stop_submitter has joined it.
  const CardInflate* card = nullptr;
  std::vector<Chunk> card_chunks;     // each lane's batch
  std::deque<int> card_flight;        // lanes submitted, not yet fetched
  std::deque<int> card_ready;         // slots fetched, not yet handed out
  std::deque<int> card_handed;        // slots handed out, oldest first
  std::vector<char> card_slot_busy;
  std::vector<size_t> card_slot_total, card_slot_blocks;
  int64_t card_seq = 0;               // batches submitted
  int card_pending = -1;              // the handed slot not yet waited for
  std::vector<uint32_t> card_meta;
  std::atomic<int> card_err{0};       // the back end's first CUDA error
  int64_t card_bad = 0;               // blocks that did not inflate
  std::thread sub;                    // the submitter
  bool sub_started = false;
  std::mutex sub_mu;
  std::condition_variable sub_cv;     // a batch in flight, a lane freed,
                                      // the submitter's end or its stop
  bool sub_stop = false;              // the caller ends the submitter
  bool sub_end = false;               // the submitter submits no more

  // The next batch for the card: up to max_blocks blocks whose payloads
  // span at most in_cap bytes (a single block always fits).
  void read_chunk_card(Chunk& c) {
    if (!map) { read_chunk(c, card->max_blocks, card->in_cap); return; }
    c.blocks.clear();
    c.total = 0;
    c.cbuf.len = 0;
    const size_t span0 = map_pos;
    for (int i = 0; i < card->max_blocks; i++) {
      if (map_pos >= map_size) { eof = true; break; }
      size_t coff, nxt;
      uint32_t clen, isize;
      if (!bgzf_parse_block_at(map, map_size, map_pos, &coff, &clen,
                               &isize, &nxt))
        { eof = true; truncated = true; break; }
      if (!c.blocks.empty() && nxt - span0 > card->in_cap) break;
      c.blocks.push_back({coff, clen, isize, c.total});
      c.total += isize;
      map_pos = nxt;
    }
  }

  void note_card(int err) {
    if (err == 0) return;
    int none = 0;
    card_err.compare_exchange_strong(none, err);
    inflate_bad.store(true, std::memory_order_relaxed);
  }

  // Read the next batch into lane k and submit it; false at end of stream.
  // From the mapping the batch's payloads lie in one span of the file; a
  // stream's are packed in the chunk's buffer.
  bool card_submit(int k) {
    Chunk& c = card_chunks[k];
    read_chunk_card(c);
    if (c.blocks.empty()) return false;
    const unsigned char* src = (const unsigned char*)c.cbuf.data();
    size_t base = 0, src_bytes = c.cbuf.len;
    if (map) {
      base = c.blocks.front().off;
      src = map + base;
      src_bytes = c.blocks.back().off + c.blocks.back().clen - base;
    }
    card_meta.resize(4 * c.blocks.size());
    for (size_t i = 0; i < c.blocks.size(); i++) {
      const Blk& b = c.blocks[i];
      card_meta[4 * i] = (uint32_t)(b.off - base);
      card_meta[4 * i + 1] = b.clen;
      card_meta[4 * i + 2] = (uint32_t)b.out_off;
      card_meta[4 * i + 3] = b.isize;
    }
    note_card(card->submit(card->ctx, k, src, src_bytes, card_meta.data(),
                           (int)c.blocks.size(), c.total));
    return true;
  }

  void card_fetch(int k, int j) {
    note_card(card->fetch(card->ctx, k, j));
    card_slot_busy[j] = 1;
    card_slot_total[j] = card_chunks[k].total;
    card_slot_blocks[j] = card_chunks[k].blocks.size();
  }

  void card_wait(int j) {
    int n_bad = 0;
    note_card(card->wait(card->ctx, j, &n_bad));
    if (n_bad != 0) inflate_bad.store(true, std::memory_order_relaxed);
    card_bad += n_bad;
    blocks_card += (int64_t)card_slot_blocks[j];
  }

  // The submitter: keeps every lane busy, reading, staging and launching
  // the batches in order until the input ends or the caller stops it.
  void sub_main() {
    for (;;) {
      int k;
      {
        std::unique_lock<std::mutex> lk(sub_mu);
        sub_cv.wait(lk, [&] {
          return sub_stop || (int)card_flight.size() < card->lanes;
        });
        if (sub_stop) break;
        k = (int)(card_seq % card->lanes);
      }
      const bool more = !eof && card_submit(k);
      {
        std::lock_guard<std::mutex> lk(sub_mu);
        if (more) {
          card_seq++;
          card_flight.push_back(k);
        } else {
          sub_end = true;
        }
      }
      sub_cv.notify_all();
      if (!more) break;
    }
  }

  // Joins the submitter (a no-op without one); after it the caller owns
  // the reader's position and counters again.
  void stop_submitter() {
    if (!sub.joinable()) return;
    {
      std::lock_guard<std::mutex> lk(sub_mu);
      sub_stop = true;
    }
    sub_cv.notify_all();
    sub.join();
  }

  // Fetch the oldest batches in flight into the free slots, waiting for the
  // submitter while none is fetched and the input has not ended. A fetch
  // frees its lane, so it happens under the lock, before the submitter may
  // reuse the lane.
  void card_top_up() {
    if (!sub_started) {
      sub_started = true;
      sub = std::thread([this]() { sub_main(); });
    }
    std::unique_lock<std::mutex> lk(sub_mu);
    for (;;) {
      bool freed = false;
      for (int j = 0; j < card->slots && !card_flight.empty(); j++) {
        if (card_slot_busy[j]) continue;
        card_fetch(card_flight.front(), j);
        card_flight.pop_front();
        card_ready.push_back(j);
        freed = true;
      }
      if (freed) sub_cv.notify_all();
      if (!card_ready.empty() || sub_stop
          || (sub_end && card_flight.empty()))
        return;
      sub_cv.wait(lk);
    }
  }

  // One batch, synchronously (the header; a range's first records): no
  // batch is on the card yet.
  bool card_next_chunk(std::string& out) {
    const int k = (int)(card_seq % card->lanes), j = 0;
    if (!card_submit(k)) return false;
    card_seq++;
    card_fetch(k, j);
    card_wait(j);
    card_slot_busy[j] = 0;
    out.assign(card->host_out(card->ctx, j) + card->gap, card_slot_total[j]);
    return true;
  }

  // Free the slot handed out before the last one (the caller is done with
  // it), top the card up, and hand the oldest batch fetched to ``out``,
  // which then views its slot: the caller parses the last batch handed
  // out while this one and the others inflate.
  bool card_next_raw(RawBuf& out, size_t prefix) {
    if (prefix != card->gap)
      throw std::runtime_error("card inflate: the back end's gap is not "
                               "the decoder's");
    while (card_handed.size() > 1) {
      card_slot_busy[card_handed.front()] = 0;
      card_handed.pop_front();
    }
    card_top_up();
    if (card_ready.empty()) return false;
    const int j = card_ready.front();
    card_ready.pop_front();
    card_handed.push_back(j);
    card_pending = j;
    out.view(card->host_out(card->ctx, j), card->gap + card->out_cap);
    out.start = prefix;
    out.len = prefix + card_slot_total[j];
    return true;
  }

  // Scan up to max_blocks BGZF block headers in the mapping (no copy).
  void read_chunk_map(Chunk& c, int max_blocks) {
    c.blocks.clear();
    c.total = 0;
    c.cbuf.len = 0;
    for (int i = 0; i < max_blocks; i++) {
      if (map_pos >= map_size) { eof = true; break; }
      size_t coff, nxt;
      uint32_t clen, isize;
      if (!bgzf_parse_block_at(map, map_size, map_pos, &coff, &clen,
                               &isize, &nxt))
        { eof = true; truncated = true; break; }
      c.blocks.push_back({coff, clen, isize, c.total});
      c.total += isize;
      map_pos = nxt;
    }
  }

  // Read up to max_blocks BGZF block payloads into ``c``.
  void read_chunk(Chunk& c, int max_blocks, size_t max_bytes = SIZE_MAX) {
    if (map) { read_chunk_map(c, max_blocks); return; }
    c.blocks.clear();
    c.total = 0;
    c.cbuf.len = 0;
    size_t used = 0;
    for (int i = 0; i < max_blocks; i++) {
      size_t cdata_len = held_cdata;
      held_cdata = 0;
      if (cdata_len == 0 && !read_block_header(&cdata_len)) break;
      // a block that would take the chunk's payloads past max_bytes
      // waits, its header read, for the next chunk
      if (!c.blocks.empty() && used + cdata_len > max_bytes) {
        held_cdata = cdata_len;
        break;
      }
      c.cbuf.len = used;  // growth must preserve the payloads so far
      c.cbuf.ensure(used + cdata_len);
      if (fread(c.cbuf.data() + used, 1, cdata_len, f) != cdata_len)
        { eof = true; truncated = true; break; }
      unsigned char tail[8];
      if (fread(tail, 1, 8, f) != 8)
        { eof = true; truncated = true; break; }
      uint32_t isize = (uint32_t)tail[4] | ((uint32_t)tail[5] << 8) |
                       ((uint32_t)tail[6] << 16) | ((uint32_t)tail[7] << 24);
      // BGZF caps a block's inflated size at 64 KiB; a corrupt footer
      // claiming more would balloon the chunk allocation
      if (isize > 65536) { eof = true; truncated = true; break; }
      c.blocks.push_back({used, (uint32_t)cdata_len, isize, c.total});
      used += cdata_len;
      c.total += isize;
    }
    c.cbuf.len = used;
  }

  // Read the stream's next BGZF header, up to its payload, and give the
  // payload's length. False at the stream's end, or at a malformed or cut
  // header (which also sets ``truncated``).
  bool read_block_header(size_t* cdata_len) {
    unsigned char hdr[12];
    size_t got = fread(hdr, 1, 12, f);
    if (got == 0) { eof = true; return false; }
    if (got < 12 || hdr[0] != 0x1f || hdr[1] != 0x8b)
      { eof = true; truncated = true; return false; }
    uint16_t xlen = (uint16_t)(hdr[10] | (hdr[11] << 8));
    unsigned char extra[65536];
    if (fread(extra, 1, xlen, f) != xlen)
      { eof = true; truncated = true; return false; }
    int bsize = -1;
    for (int off = 0; off + 4 <= xlen;) {
      uint8_t si1 = extra[off], si2 = extra[off + 1];
      uint16_t slen = (uint16_t)(extra[off + 2] | (extra[off + 3] << 8));
      // the 2-byte BSIZE payload itself must lie inside the extra
      // field (a BC header in the last <2 bytes would read past what
      // fread filled — and past the array at xlen=65535)
      if (si1 == 66 && si2 == 67 && slen == 2 && off + 6 <= (int)xlen)
        bsize = extra[off + 4] | (extra[off + 5] << 8);
      if (off + 4 + (int)slen > (int)xlen) break;  // payload overflows
      off += 4 + slen;
    }
    // BSIZE is total-block-size-1; anything smaller than the fixed
    // header+footer would underflow cdata_len below (corrupt/crafted)
    if (bsize < 0 || (size_t)bsize + 1 < 12u + xlen + 8u)
      { eof = true; truncated = true; return false; }
    *cdata_len = (size_t)bsize + 1 - 12 - xlen - 8;
    return true;
  }

  // synchronous inflate (header phase, CRAM FASTA load): caller helps
  // the pool, returns with the whole chunk inflated. Must not be called
  // while an async job is pending.
  // every participant may have failed decompressor allocation (each
  // claims nothing then) — a chunk is only complete when job_next
  // covered every block
  void check_span_complete(const Chunk& c) {
    if (job_next.load(std::memory_order_relaxed) < c.blocks.size())
      inflate_bad.store(true, std::memory_order_relaxed);
  }

  void inflate_blocks(const Chunk& c, char* dst) {
    finish_raw();  // self-enforce the precondition: a pending async job
                   // shares job_next/job_running with this one; drain it
                   // (no-op when nothing is pending)
    if (pool.empty() || c.blocks.size() < 4) {
      job_next.store(0, std::memory_order_relaxed);
      inflate_span(caller_d.get(), c, dst);
    } else {
      publish(c, dst);
      inflate_span(caller_d.get(), c, dst);
      wait_done();
    }
    check_span_complete(c);
  }

  // Pull the next chunk: join the read-ahead (or read synchronously), then
  // kick off the next read so fread overlaps the inflate + parse below.
  // Callers consume chunks strictly sequentially from one thread at a time.
  bool advance(int max_blocks) {
    if (ra_active) {
      rat.join();
      ra_active = false;
      std::swap(cur, ra);
    } else {
      read_chunk(cur, max_blocks);
    }
    if (!eof) {
      rat = std::thread([this, max_blocks]() { read_chunk(ra, max_blocks); });
      ra_active = true;
    }
    return !cur.blocks.empty();
  }

  // string variant (header phase, FASTA load): simple, zero-fills. On the
  // card a chunk is one batch, whatever max_blocks asks for.
  bool next_chunk(std::string& out, int max_blocks = 4096) {
    if (card) return card_next_chunk(out);
    if (!advance(max_blocks)) return false;
    out.clear();
    out.resize(cur.total);
    inflate_blocks(cur, &out[0]);
    return true;
  }

  // async raw variant: advance + hand the inflate to the pool and return
  // immediately so the caller can parse the PREVIOUS chunk while this one
  // inflates. finish_raw() must run before ``out`` is read, moved, or
  // destroyed. (On the non-mmap path advance() may block in the
  // read-ahead join before parsing — regular files all take mmap.)
  bool start_next_raw(RawBuf& out, size_t prefix, int max_blocks = 128) {
    if (card) return card_next_raw(out, prefix);
    if (!advance(max_blocks)) return false;
    out.len = 0;  // nothing to preserve on growth
    out.ensure(prefix + cur.total);
    out.start = prefix;
    out.len = prefix + cur.total;
    if (pool.empty()) {
      job_next.store(0, std::memory_order_relaxed);
      inflate_span(caller_d.get(), cur, out.data() + prefix);
      check_span_complete(cur);
    } else {
      publish(cur, out.data() + prefix);
      job_pending = true;
    }
    return true;
  }

  // join the pending async inflate, helping with leftover blocks. Safe
  // no-op when nothing is pending.
  void finish_raw() {
    if (card_pending >= 0) {
      card_wait(card_pending);
      card_pending = -1;
    }
    if (!job_pending) return;
    inflate_span(caller_d.get(), *job_chunk, job_dst);
    wait_done();
    check_span_complete(*job_chunk);
    job_pending = false;
  }
};

// ---------------------------------------------------------------------------
// little-endian readers
// ---------------------------------------------------------------------------

inline int32_t rd_i32(const char* p) { int32_t v; memcpy(&v, p, 4); return v; }
inline uint32_t rd_u32(const char* p) { uint32_t v; memcpy(&v, p, 4); return v; }
inline uint16_t rd_u16(const char* p) { uint16_t v; memcpy(&v, p, 2); return v; }

// Walk the BAM tag block; returns the value pointer (just past the type
// byte) of tag ``t0 t1`` with value type ``vt_want``, or nullptr.
inline const char* find_bam_tag(const char* p, const char* end, char t0,
                                char t1, char vt_want) {
  while (p + 3 <= end) {
    char a = p[0], b = p[1], vt = p[2];
    const char* val = p + 3;
    size_t sz = 0;
    switch (vt) {
      case 'c': case 'C': case 'A': sz = 1; break;
      case 's': case 'S': sz = 2; break;
      case 'i': case 'I': case 'f': sz = 4; break;
      case 'Z': case 'H': {
        const char* q = val;
        while (q < end && *q) q++;
        sz = (size_t)(q - val) + 1;
        break;
      }
      case 'B': {
        if (val + 5 > end) return nullptr;
        char sub = val[0];
        uint32_t cnt = rd_u32(val + 1);
        size_t esz = (sub == 'c' || sub == 'C') ? 1
                     : (sub == 's' || sub == 'S') ? 2 : 4;
        sz = 5 + (size_t)cnt * esz;
        break;
      }
      default: return nullptr;  // unknown type: cannot skip safely
    }
    if (a == t0 && b == t1 && vt == vt_want) return val;
    p = val + sz;
  }
  return nullptr;
}

// ---------------------------------------------------------------------------
// decoder main
// ---------------------------------------------------------------------------

struct BedRegions {
  // per chrom-id: sorted starts + prefix-max of ends
  std::vector<std::vector<int64_t>> starts, maxend;
  bool enabled = false;
  bool pass(int32_t chr, int64_t s, int64_t e) const {
    if (!enabled) return true;
    if (chr >= (int32_t)starts.size() || starts[chr].empty()) return false;
    const auto& st = starts[chr];
    const auto& me = maxend[chr];
    // any region with start < e and end > s ?
    auto it = std::lower_bound(st.begin(), st.end(), e);
    size_t idx = (size_t)(it - st.begin());
    if (idx == 0) return false;
    return me[idx - 1] > s;
  }
};

struct NoCigarError {};

struct Worker {
  const Params& P;
  const BedRegions& bed;
  Collector C;
  std::string seq_scratch;
  // per-record scratch reused across records (no per-record allocation)
  struct IS { int64_t pos, len, soff, slen; };
  struct DS { int64_t pos, len; };
  std::vector<IS> ins_sigs;
  std::vector<DS> del_sigs;
  std::string ins_scratch;

  Worker(const Params& p, const BedRegions& b,
         const std::vector<std::string>& header_chroms)
      : P(p), bed(b) {
    for (const auto& s : header_chroms) C.intern_chrom(s);
  }

  // -- SA CIGAR clip profile (cuteSV:466-481): only 'S' counts as clip --
  static void clip_profile(const char* s, const char* end, int64_t* first,
                           int64_t* last, int64_t* span) {
    *first = *last = *span = 0;
    int64_t num = 0;
    bool first_item = true;
    int64_t last_clip = 0;
    while (s < end) {
      char ch = *s++;
      if (ch >= '0' && ch <= '9') { num = num * 10 + (ch - '0'); continue; }
      if (first_item) {
        if (ch == 'S') *first = num;
        first_item = false;
      }
      last_clip = (ch == 'S') ? num : 0;
      if (ch == 'M' || ch == 'D' || ch == '=' || ch == 'X') *span += num;
      num = 0;
    }
    *last = last_clip;
  }

  void process_record(const char* rec, int32_t block_size) {
    if (block_size < 32)
      throw std::runtime_error("malformed BAM record (short block)");
    int32_t ref_id = rd_i32(rec);
    int64_t pos = rd_i32(rec + 4);
    uint8_t l_qname = (uint8_t)rec[8];
    uint8_t mapq = (uint8_t)rec[9];
    uint16_t n_cigar = rd_u16(rec + 12);
    uint16_t flag = rd_u16(rec + 14);
    int64_t l_seq = rd_i32(rec + 16);
    const char* qname_p = rec + 32;
    const char* cigar_p = qname_p + l_qname;
    const char* seq_p = cigar_p + 4ll * n_cigar;
    const char* tag_p = seq_p + (l_seq + 1) / 2 + l_seq;
    const char* rec_end = rec + block_size;
    // internal lengths must be consistent with the block span, or the
    // cigar/seq/tag walks below would read out of bounds (fuzz-hardened)
    if (l_seq < 0 || tag_p > rec_end)
      throw std::runtime_error("malformed BAM record (lengths exceed "
                               "block)");

    if (ref_id < 0 || (flag & 0x4)) return;
    C.n_records++;

    // long-CIGAR convention (SAM spec 4.2.2): records whose real CIGAR
    // has >65535 ops store the sentinel ``<l_seq>S<ref_len>N`` in the
    // CIGAR field and the true ops in a CG:B,I tag (ultralong reads)
    const char* ops_p = cigar_p;
    int64_t n_ops = n_cigar;
    if (n_cigar == 2) {
      uint32_t v0 = rd_u32(cigar_p), v1 = rd_u32(cigar_p + 4);
      if ((v0 & 0xF) == 4 && (int64_t)(v0 >> 4) == l_seq &&
          (v1 & 0xF) == 3) {
        const char* cg = find_bam_tag(tag_p, rec_end, 'C', 'G', 'B');
        if (cg && cg[0] == 'I') {
          uint32_t cnt = rd_u32(cg + 1);
          if (cnt > 0 && cg + 5 + 4ll * cnt <= rec_end) {
            ops_p = cg + 5;
            n_ops = cnt;
          }
        }
      }
    }

    // reference end from CIGAR; records that will also take the
    // signature walk below (the common case) get ONE fused pass that
    // collects the I/D signatures and the clip profile alongside
    // ref_end instead of walking the ops twice
    int64_t ref_end = pos;
    int64_t softclip_left = 0, softclip_right = 0;
    int64_t hardclip_left = 0, hardclip_right = 0;
    ins_sigs.clear();
    del_sigs.clear();
    bool sigs_ready = false;
    const bool sig_eligible =
        mapq >= P.min_mapq && n_ops > 0 && flag != 256 && flag != 272 &&
        l_seq >= P.min_read_len && !bed.enabled;
    if (sig_eligible) {
      uint32_t v0 = rd_u32(ops_p);
      if ((v0 & 0xF) == 4) softclip_left = v0 >> 4;
      else if ((v0 & 0xF) == 5) hardclip_left = v0 >> 4;
      int64_t sig_start = pos;
      int64_t shift = -hardclip_left;
      for (int64_t i = 0; i < n_ops; i++) {
        uint32_t v = rd_u32(ops_p + 4ll * i);
        uint32_t op = v & 0xF;
        int64_t ln = v >> 4;
        if (op != 2) shift += ln;
        if (ln >= P.min_siglength && (op == 1 || op == 2)) {
          if (op == 2) {
            del_sigs.push_back({sig_start, ln});
            sig_start += ln;
          } else {
            int64_t a = shift - ln, b = shift;
            a = std::max<int64_t>(0, std::min(a, l_seq));
            b = std::max<int64_t>(0, std::min(b, l_seq));
            ins_sigs.push_back({sig_start, ln, a, b > a ? b - a : 0});
          }
        } else if (op == 0 || op == 2 || op == 3 || op == 7 || op == 8) {
          sig_start += ln;
        }
      }
      uint32_t vl = rd_u32(ops_p + 4ll * (n_ops - 1));
      if ((vl & 0xF) == 4) softclip_right = vl >> 4;
      else if ((vl & 0xF) == 5) hardclip_right = vl >> 4;
      if (hardclip_left != 0) softclip_left = hardclip_left;
      if (hardclip_right != 0) softclip_right = hardclip_right;
      ref_end = sig_start;  // the walk advanced on exactly the
                            // reference-consuming ops
      sigs_ready = true;
    } else {
      for (int64_t i = 0; i < n_ops; i++) {
        uint32_t v = rd_u32(ops_p + 4ll * i);
        uint32_t op = v & 0xF, ln = v >> 4;
        if (op == 0 || op == 2 || op == 3 || op == 7 || op == 8)
          ref_end += ln;
      }
    }

    // allreads row: everything mapped, before any filter (count_coverage
    // re-scan source)
    int8_t prim = (flag == 0 || flag == 16) ? 1 : 0;
    int64_t name_id = C.intern_name_raw(
        qname_p, l_qname ? l_qname - 1 : 0,
        hash_bytes(qname_p, l_qname ? l_qname - 1 : 0));
    C.all_chr.push(ref_id); C.all_start.push(pos); C.all_end.push(ref_end);
    C.all_prim.push(prim); C.all_name.push(name_id);
    if (flag == 256 || flag == 272) return;
    if (!bed.pass(ref_id, pos, ref_end)) return;
    if (mapq >= P.min_mapq) {
      C.cen_chr.push(ref_id); C.cen_start.push(pos); C.cen_end.push(ref_end);
      C.cen_prim.push(prim); C.cen_name.push(name_id);
    }

    if (l_seq < P.min_read_len) return;  // query_length gate (cuteSV:607)

    // SEQ decode is lazy: INS signatures need only their slices; the full
    // read is materialized only for SA-tagged reads (split analysis works
    // in query orientation). decode_slice_append clamps like a python
    // slice and appends into a reused scratch string (no per-signature
    // allocation).
    auto decode_slice_append = [&](int64_t a, int64_t b, std::string& out) {
      a = std::max<int64_t>(0, std::min(a, l_seq));
      b = std::max<int64_t>(0, std::min(b, l_seq));
      if (a >= b) return;
      size_t base = out.size();
      out.resize(base + (b - a));
      for (int64_t k = a; k < b; k++) {
        uint8_t byte = (uint8_t)seq_p[k >> 1];
        out[base + (k - a)] = kSeqNT16[(k & 1) ? (byte & 0xF) : (byte >> 4)];
      }
    };
    auto decode_full = [&]() {
      seq_scratch.resize((size_t)l_seq + 1);
      char* dst = &seq_scratch[0];
      int64_t nb = (l_seq + 1) / 2;
      for (int64_t k = 0; k < nb; k++) {
        uint16_t pair = kSeqLut.t[(uint8_t)seq_p[k]];
        memcpy(dst + 2 * k, &pair, 2);
      }
      seq_scratch.resize(l_seq);
    };

    int process_signal;
    switch (flag) {
      case 4: process_signal = 0; break;
      case 0: process_signal = 1; break;
      case 16: process_signal = 2; break;
      case 2048: process_signal = 3; break;
      case 2064: process_signal = 4; break;
      default: process_signal = 0; break;
    }

    // CIGAR intra-read signatures (cuteSV:614-658). A mapped record that
    // passes the mapq gate but has NO cigar cannot be processed (the
    // reference crashes on read.cigartuples[0] here); raise the designed
    // no-CIGAR error instead of silently treating it as signature-free,
    // which would diverge from the python oracle. The fused pass above
    // already collected sigs + clips for the common case; the loop here
    // keeps the original two-pass form for bed-filtered runs (whose
    // bed.pass gate needs ref_end before sig eligibility is known).
    if (mapq >= P.min_mapq && n_ops == 0) throw NoCigarError{};
    if (mapq >= P.min_mapq && !sigs_ready) {
      uint32_t v0 = rd_u32(ops_p);
      if ((v0 & 0xF) == 4) softclip_left = v0 >> 4;
      else if ((v0 & 0xF) == 5) hardclip_left = v0 >> 4;
      int64_t sig_start = pos;
      int64_t shift = -hardclip_left;
      for (int64_t i = 0; i < n_ops; i++) {
        uint32_t v = rd_u32(ops_p + 4ll * i);
        uint32_t op = v & 0xF;
        int64_t ln = v >> 4;
        if (op != 2) shift += ln;
        if (ln >= P.min_siglength && (op == 1 || op == 2)) {
          if (op == 2) {
            del_sigs.push_back({sig_start, ln});
            sig_start += ln;
          } else {
            // slice [shift-ln, shift) of SEQ, python-clamped, decoded
            // on demand
            int64_t a = shift - ln, b = shift;
            a = std::max<int64_t>(0, std::min(a, l_seq));
            b = std::max<int64_t>(0, std::min(b, l_seq));
            ins_sigs.push_back({sig_start, ln, a, b > a ? b - a : 0});
          }
        } else if (op == 0 || op == 2 || op == 3 || op == 7 || op == 8) {
          sig_start += ln;
        }
      }
      uint32_t vl = rd_u32(ops_p + 4ll * (n_ops - 1));
      if ((vl & 0xF) == 4) softclip_right = vl >> 4;
      else if ((vl & 0xF) == 5) hardclip_right = vl >> 4;
      if (hardclip_left != 0) softclip_left = hardclip_left;
      if (hardclip_right != 0) softclip_right = hardclip_right;
    }

    // same-read signature chaining (cuteSV:515-575)
    if (!ins_sigs.empty()) {
      IS cur = ins_sigs[0];
      std::string& cur_seq = ins_scratch;
      cur_seq.clear();
      decode_slice_append(cur.soff, cur.soff + cur.slen, cur_seq);
      int64_t last_pos = cur.pos;
      for (size_t i = 1; i < ins_sigs.size(); i++) {
        const IS& s = ins_sigs[i];
        if (s.pos - last_pos <= P.merge_ins_threshold) {
          cur.len += s.len;
          decode_slice_append(s.soff, s.soff + s.slen, cur_seq);
          last_pos = s.pos;
        } else {
          C.add_ins(ref_id, 2 * cur.pos, cur.len, name_id, cur_seq);
          cur = s;
          cur_seq.clear();
          decode_slice_append(s.soff, s.soff + s.slen, cur_seq);
          last_pos = s.pos;
        }
      }
      C.add_ins(ref_id, 2 * cur.pos, cur.len, name_id, cur_seq);
    }
    if (!del_sigs.empty()) {
      DS cur = del_sigs[0];
      int64_t last_end = cur.pos + cur.len;
      for (size_t i = 1; i < del_sigs.size(); i++) {
        const DS& s = del_sigs[i];
        if (s.pos - last_end <= P.merge_del_threshold) {
          cur.len += s.len;
          last_end = s.pos + s.len;
        } else {
          C.del_chr.push(ref_id); C.del_pos.push(cur.pos);
          C.del_len.push(cur.len); C.del_name.push(name_id);
          cur = s;
          // reference quirk (cuteSV:570 `temp_sig.append(i[0])`): after a
          // chain break the gap anchor is the new signature's POSITION,
          // not its end — only the initial cluster starts at pos+len
          last_end = s.pos;
        }
      }
      C.del_chr.push(ref_id); C.del_pos.push(cur.pos);
      C.del_len.push(cur.len); C.del_name.push(name_id);
    }

    if (process_signal != 1 && process_signal != 2) return;

    // find SA tag
    const char* sa = nullptr;
    const char* sa_end = nullptr;
    for (const char* p = tag_p; p + 3 <= rec_end;) {
      char t0 = p[0], t1 = p[1], vt = p[2];
      p += 3;
      size_t sz = 0;
      switch (vt) {
        case 'c': case 'C': case 'A': sz = 1; break;
        case 's': case 'S': sz = 2; break;
        case 'i': case 'I': case 'f': sz = 4; break;
        case 'Z': case 'H': {
          const char* z = p;
          while (z < rec_end && *z) z++;
          if (t0 == 'S' && t1 == 'A' && vt == 'Z') { sa = p; sa_end = z; }
          p = z + 1;
          continue;
        }
        case 'B': {
          if (p + 5 > rec_end) return;  // malformed array tag header
          char sub = *p;
          uint32_t cnt = rd_u32(p + 1);
          size_t esz = (sub == 'c' || sub == 'C') ? 1
                       : (sub == 's' || sub == 'S') ? 2 : 4;
          p += 5 + (size_t)cnt * esz;
          continue;
        }
        default:
          return;  // unknown tag type; bail on this record's tags
      }
      p += sz;
    }
    if (!sa) return;

    decode_full();
    // query in original read orientation
    std::string query_seq =
        (process_signal == 1) ? seq_scratch : revcomp(seq_scratch);

    std::vector<Seg> split;
    int64_t sa_min_mapq = P.min_mapq;
    if (mapq >= P.min_mapq) {
      Seg prim_seg;
      if (process_signal == 1) {
        prim_seg = {softclip_left, l_seq - softclip_right, pos, ref_end,
                    ref_id, '+'};
      } else {
        prim_seg = {softclip_right, l_seq - softclip_left, pos, ref_end,
                    ref_id, '-'};
      }
      split.push_back(prim_seg);
      sa_min_mapq = 0;
    }
    // split SA entries on ';', DROPPING the final element (cuteSV:678)
    {
      const char* p = sa;
      std::vector<std::pair<const char*, const char*>> entries;
      const char* st = p;
      for (const char* q = p; q <= sa_end; q++) {
        if (q == sa_end || *q == ';') {
          entries.push_back({st, q});
          st = q + 1;
        }
      }
      if (!entries.empty()) entries.pop_back();
      for (auto& ent : entries) {
        // rname,pos,strand,cigar,mapq,nm
        const char* fields[6];
        const char* fe[6];
        int nf = 0;
        const char* s = ent.first;
        const char* fstart = s;
        for (const char* q = s; q <= ent.second && nf < 6; q++) {
          if (q == ent.second || *q == ',') {
            fields[nf] = fstart;
            fe[nf] = q;
            nf++;
            fstart = q + 1;
          }
        }
        if (nf < 5) continue;
        int64_t sa_pos = 0;
        for (const char* q = fields[1]; q < fe[1]; q++)
          sa_pos = sa_pos * 10 + (*q - '0');
        sa_pos -= 1;  // SA pos is 1-based
        char sa_strand = *fields[2];
        int64_t sa_mapq = 0;
        for (const char* q = fields[4]; q < fe[4]; q++)
          sa_mapq = sa_mapq * 10 + (*q - '0');
        if (sa_mapq < sa_min_mapq) continue;
        int64_t fc, lc, span;
        clip_profile(fields[3], fe[3], &fc, &lc, &span);
        int32_t sa_chr =
            C.intern_chrom(std::string(fields[0], fe[0] - fields[0]));
        if (sa_strand == '+') {
          split.push_back({fc, l_seq - lc, sa_pos, sa_pos + span, sa_chr,
                           '+'});
        } else {
          split.push_back({lc, l_seq - fc, sa_pos, sa_pos + span, sa_chr,
                           '-'});
        }
      }
    }
    if ((int64_t)split.size() <= P.max_split_parts ||
        P.max_split_parts == -1) {
      Extractor ex(P, C);
      ex.analyse_split(split, l_seq, name_id, query_seq);
    }
  }

};

// --- sharded-decode record-boundary discovery -------------------------
// A BAM record start is identified by validating its fixed fields and
// chaining: refID/pos ranges, l_read_name, a size lower bound implied by
// n_cigar/l_seq, and the qname NUL. Chained over up to 4 records this is
// statistically unambiguous, and the caller cross-checks neighbouring
// shards' boundaries for exact agreement.
inline bool bam_rec_plausible(const char* d, size_t len, size_t p,
                              int32_t n_ref) {
  if (len - p < 4) return true;  // ran out: earlier links vouch
  int64_t bs = (int64_t)(int32_t)rd_i32(d + p);
  if (bs < 32 || bs > (64 << 20)) return false;
  size_t have = len - p - 4;
  if (have < 32) return true;  // partial fixed block at buffer end
  const char* q = d + p + 4;
  int32_t refid = rd_i32(q), pos = rd_i32(q + 4);
  uint8_t l_rn = (uint8_t)q[8];
  uint16_t n_cig = (uint16_t)((uint8_t)q[12] | ((uint8_t)q[13] << 8));
  int32_t l_seq = rd_i32(q + 16);
  int32_t nref2 = rd_i32(q + 20), npos = rd_i32(q + 24);
  if (refid < -1 || refid >= n_ref) return false;
  if (pos < -1 || npos < -1) return false;
  if (nref2 < -1 || nref2 >= n_ref) return false;
  if (l_rn < 1) return false;
  if (l_seq < 0 || l_seq > (1 << 29)) return false;
  int64_t bs_min = 32 + (int64_t)l_rn + 4 * (int64_t)n_cig +
                   ((int64_t)l_seq + 1) / 2 + (int64_t)l_seq;
  if (bs < bs_min) return false;
  if (have >= 32u + l_rn && q[32 + l_rn - 1] != '\0') return false;
  return true;
}

inline bool bam_chain_valid(const char* d, size_t len, size_t p,
                            int32_t n_ref, int depth = 4) {
  for (int k = 0; k < depth; k++) {
    if (len - p < 4) return true;
    if (!bam_rec_plausible(d, len, p, n_ref)) return false;
    int64_t bs = (int64_t)(int32_t)rd_i32(d + p);
    if ((uint64_t)(4 + bs) > len - p) return true;  // partial tail
    p += 4 + (size_t)bs;
  }
  return true;
}

struct Decoder {
  Params P;
  Collector C;
  BedRegions bed;
  std::vector<int64_t> ref_lens;
  std::vector<std::string> header_chroms;
  // the record walk: its wall (s) and its start and end on the epoch
  // clock (system_clock ns; the program's spans use the same clock)
  double t_records = 0;
  int64_t walk_t0_ns = 0, walk_t1_ns = 0;
  // always-on core-second accounting for the bench artifact: busy
  // parse core-ns (all workers) + the reader's busy inflate core-s,
  // copied out of the run()-local reader before it is destroyed
  std::atomic<uint64_t> records_core_ns{0};
  double inflate_core_s = 0;
  // the card back end (null: zlib threads), the BGZF blocks each back
  // end inflated, and on the card the batches the reader submitted and
  // the kernel launches the back end made
  const CardInflate* card = nullptr;
  int64_t blocks_card = 0, blocks_host = 0;
  int64_t batches_card = 0, launches_card = 0;
  // streaming: merges into C and snapshot reads share this lock; progress
  // holds the refID currently being decoded (records are coordinate-
  // sorted, so every chromosome with a smaller id has all of its
  // record-order rows merged). INT32_MAX once the run is complete.
  std::mutex snap_mu;
  std::atomic<int32_t> progress{-1};
  // every store to ``progress`` signals prog_cv (publish_progress), which
  // bamdecode_wait sleeps on
  std::mutex prog_mu;
  std::condition_variable prog_cv;

  void publish_progress(int32_t v) {
    {
      std::lock_guard<std::mutex> lk(prog_mu);
      progress.store(v, std::memory_order_release);
    }
    prog_cv.notify_all();
  }

  // The progress once it passes ``seen`` (or is DONE), or after
  // ``timeout_ms`` whatever it is.
  int32_t wait_progress(int32_t seen, int64_t timeout_ms) {
    std::unique_lock<std::mutex> lk(prog_mu);
    prog_cv.wait_for(lk, std::chrono::milliseconds(timeout_ms), [&] {
      const int32_t p = progress.load(std::memory_order_acquire);
      return p > seen || p == INT32_MAX;
    });
    return progress.load(std::memory_order_acquire);
  }
  // first/last refid actually merged — under a byte range these name the
  // possibly-partial boundary chromosomes (the python side excludes them
  // from mid-decode tails; census/sig completeness cannot be assumed)
  std::atomic<int32_t> first_ref{-1};
  std::atomic<int32_t> last_ref{-1};
  std::string err_msg;  // set on decode failure (see bamdecode_err)
  // sharded decode outputs, in uncompressed offsets relative to the
  // range start (global when range_start<=0): first record boundary
  // discovered, and the first record NOT owned (the next host's first)
  int64_t first_u = 0;
  int64_t next_u = 0;

  // shared parallel record processing (BAM chunks and CRAM-synthesized
  // chunks go through the same path): thread-local collectors are merged
  // in range order so global row order equals input record order.
  // Workers persist across chunks (reset_outputs keeps table/vector
  // capacity), so per-chunk Collector construction and its allocation
  // churn are paid once per run, not once per chunk.
  int fail_status = 4;  // process_recs failure detail (6 = no CIGAR)
  std::vector<std::unique_ptr<Worker>> worker_pool;

  Worker* pool_worker(size_t i) {
    while (worker_pool.size() <= i)
      worker_pool.emplace_back(new Worker(P, bed, header_chroms));
    Worker* w = worker_pool[i].get();
    w->C.reset_outputs();
    return w;
  }

  // --- persistent parse pool ------------------------------------------
  // Threads created once per run (not per chunk); one job at a time,
  // published by process_recs from the consumer thread. Pool thread idx
  // parses contiguous range idx+1 with worker_pool[idx+1]; the caller
  // parses range 0 and waits.
  std::vector<std::thread> parse_pool;
  std::mutex pp_mu;
  std::condition_variable pp_cv, pp_done_cv;
  bool pp_stop = false;
  uint64_t pp_gen = 0;
  int pp_running = 0;
  const char* pp_base = nullptr;
  const std::vector<std::pair<size_t, int32_t>>* pp_recs = nullptr;
  std::vector<Worker*>* pp_ws = nullptr;
  size_t pp_per = 0;
  int pp_n = 0;
  std::atomic<bool> pp_err{false}, pp_err_nocigar{false};

  ~Decoder() {
    {
      std::lock_guard<std::mutex> lk(pp_mu);
      pp_stop = true;
    }
    pp_cv.notify_all();
    for (auto& t : parse_pool) t.join();
  }

  void parse_range(Worker* w, const char* base,
                   const std::vector<std::pair<size_t, int32_t>>& recs,
                   size_t lo, size_t hi) {
    timespec t0, t1;  // per-thread CPU time: contention-honest core-s
    clock_gettime(CLOCK_THREAD_CPUTIME_ID, &t0);
    try {
      for (size_t i = lo; i < hi; i++)
        w->process_record(base + recs[i].first, recs[i].second);
    } catch (const NoCigarError&) {
      pp_err.store(true);
      pp_err_nocigar.store(true);
    } catch (...) {
      pp_err.store(true);
    }
    clock_gettime(CLOCK_THREAD_CPUTIME_ID, &t1);
    records_core_ns.fetch_add(
        (uint64_t)(t1.tv_sec - t0.tv_sec) * 1000000000u
            + (uint64_t)(t1.tv_nsec - t0.tv_nsec),
        std::memory_order_relaxed);
  }

  void parse_pool_main(int idx, uint64_t seen) {
    // ``seen`` is the pp_gen value read by the creating (consumer) thread
    // at spawn time — a thread created after generations have already run
    // must wait for the NEXT publication, never fire on a stale pp_ws.
    for (;;) {
      {
        std::unique_lock<std::mutex> lk(pp_mu);
        pp_cv.wait(lk, [&] { return pp_stop || pp_gen != seen; });
        if (pp_stop) break;
        seen = pp_gen;
      }
      int t = idx + 1;  // caller owns range 0
      if (t < pp_n) {
        size_t lo = (size_t)t * pp_per;
        size_t hi = std::min(pp_recs->size(), lo + pp_per);
        parse_range((*pp_ws)[t], pp_base, *pp_recs, lo, hi);
      }
      {
        std::lock_guard<std::mutex> lk(pp_mu);
        if (--pp_running == 0) pp_done_cv.notify_all();
      }
    }
  }

  bool process_recs(const char* base,
                    const std::vector<std::pair<size_t, int32_t>>& recs) {
    // parse workers cap at the core count: the fused single-pass walk +
    // raw-hash interning left so little per-record work (~0.3 core-s per
    // 200 Mb) that oversubscription only steals cycles from the inflate
    // workers (measured 3.62 -> 3.48 s wall at 2 cores going 8 -> 2)
    int n_workers = (int)std::min<int64_t>(
        std::max<int64_t>(P.n_threads, 1),
        (int64_t)std::max(1u, std::thread::hardware_concurrency()));
    static const int env_pw = getenv("CUTESV_PARSE_WORKERS")
        ? atoi(getenv("CUTESV_PARSE_WORKERS")) : 0;
    if (env_pw > 0) n_workers = env_pw;
    bool failed = false;
    bool nocigar = false;
    if (n_workers <= 1 || recs.size() < 512) {
      Worker* w = pool_worker(0);
      timespec ts0, ts1;
      clock_gettime(CLOCK_THREAD_CPUTIME_ID, &ts0);
      try {
        for (auto& r : recs)
          w->process_record(base + r.first, r.second);
      } catch (const NoCigarError&) { failed = true; nocigar = true;
      } catch (...) { failed = true; }
      clock_gettime(CLOCK_THREAD_CPUTIME_ID, &ts1);
      records_core_ns.fetch_add(
          (uint64_t)(ts1.tv_sec - ts0.tv_sec) * 1000000000u
              + (uint64_t)(ts1.tv_nsec - ts0.tv_nsec),
          std::memory_order_relaxed);
      {
        std::lock_guard<std::mutex> g(snap_mu);
        C.merge_from(w->C);
      }
    } else {
      // workers + ranges are published to the persistent pool; the
      // caller thread parses range 0 and waits for the rest
      std::vector<Worker*> ws;
      for (int t = 0; t < n_workers; t++) ws.push_back(pool_worker(t));
      while ((int)parse_pool.size() < n_workers - 1) {
        int idx = (int)parse_pool.size();
        uint64_t gen0 = pp_gen;  // only this thread increments pp_gen
        parse_pool.emplace_back(
            [this, idx, gen0]() { parse_pool_main(idx, gen0); });
      }
      size_t per = (recs.size() + n_workers - 1) / n_workers;
      pp_err.store(false);
      pp_err_nocigar.store(false);
      {
        std::lock_guard<std::mutex> lk(pp_mu);
        pp_base = base;
        pp_recs = &recs;
        pp_ws = &ws;
        pp_per = per;
        pp_n = n_workers;
        pp_running = (int)parse_pool.size();
        pp_gen++;
      }
      pp_cv.notify_all();
      parse_range(ws[0], base, recs, 0, std::min(recs.size(), per));
      {
        std::unique_lock<std::mutex> lk(pp_mu);
        pp_done_cv.wait(lk, [&] { return pp_running == 0; });
      }
      failed = pp_err.load();
      nocigar = pp_err_nocigar.load();
      {
        std::lock_guard<std::mutex> g(snap_mu);
        for (auto* w : ws) C.merge_from(w->C);
      }
    }
    if (nocigar) fail_status = 6;  // designed no-CIGAR status; a throw
                                   // here would terminate (the caller
                                   // holds a joinable prefetch thread)
    if (!failed && !recs.empty()) {
      // refID of the last merged record: chromosomes below it are final.
      // The unmapped tail (refid -1) sorts after every mapped record, so
      // a batch ending in unmapped reads must scan back to the last
      // MAPPED one — recs.back() alone would leave last_ref pointing at
      // an earlier batch's chromosome
      int32_t refid = -1;
      for (auto it = recs.rbegin(); it != recs.rend(); ++it) {
        int32_t r = rd_i32(base + it->first);
        if (r >= 0) { refid = r; break; }
      }
      int32_t cur = progress.load(std::memory_order_relaxed);
      if (refid > cur) publish_progress(refid);
      if (refid >= 0) last_ref.store(refid, std::memory_order_release);
      if (first_ref.load(std::memory_order_relaxed) < 0) {
        for (auto& rr : recs) {  // first MAPPED record of the range
          int32_t fr = rd_i32(base + rr.first);
          if (fr >= 0) {
            first_ref.store(fr, std::memory_order_release);
            break;
          }
        }
      }
    }
    return !failed;
  }

  // returns 0 on success
  int run(const char* path) {
    FILE* f = fopen(path, "rb");
    if (!f) return 1;
    // A/B are declared BEFORE the reader so that if an exception ever
    // unwinds out of the record loop with an async inflate pending, the
    // reader's destructor (which finishes that job) runs while the
    // buffers it writes into are still alive
    RawBuf A, B;
    BgzfChunkReader rd(f, (int)P.n_threads, card);
    auto take_counters = [&]() {
      rd.stop_submitter();
      inflate_core_s = rd.inflate_core_ns.load() * 1e-9;
      blocks_card = rd.blocks_card;
      blocks_host = rd.blocks_host.load();
      batches_card = rd.card_seq;
      launches_card = card ? card->launched(card->ctx) : 0;
      if (rd.card_err.load() != 0)
        err_msg = "card inflate: CUDA error "
                  + std::to_string(rd.card_err.load());
      else if (rd.card_bad != 0)
        err_msg = "card inflate: " + std::to_string(rd.card_bad)
                  + " BGZF blocks did not inflate to their size";
    };
    // every early return must finish any pending pool inflate (it writes
    // into a caller-owned buffer) and join the read-ahead thread BEFORE
    // closing the FILE* it may still be fread()ing from
    auto bail = [&](int status) {
      rd.finish_raw();
      if (rd.rat.joinable()) rd.rat.join();
      rd.ra_active = false;
      take_counters();
      fclose(f);
      return status;
    };
    std::string chunk;
    // --- header ---
    // keep pulling chunks until we have the full header
    if (!rd.next_chunk(chunk, 1024)) return bail(2);
    auto need = [&](size_t n) {
      while (chunk.size() < n) {
        std::string more;
        if (!rd.next_chunk(more, 1024)) break;
        chunk += more;
      }
      return chunk.size() >= n;
    };
    if (!need(12) || memcmp(chunk.data(), "BAM\x01", 4) != 0)
      return bail(3);
    size_t off = 4;
    int32_t l_text = rd_i32(chunk.data() + off);
    off += 4;
    if (l_text < 0 || !need(off + (size_t)l_text + 4)) return bail(3);
    off += l_text;
    int32_t n_ref = rd_i32(chunk.data() + off);
    off += 4;
    if (n_ref < 0) return bail(3);
    for (int32_t i = 0; i < n_ref; i++) {
      if (!need(off + 4)) return bail(3);
      int32_t l_name = rd_i32(chunk.data() + off);
      off += 4;
      // l_name counts the NUL; 0/negative or absurd values are corrupt
      if (l_name <= 0 || l_name > (1 << 20)) return bail(3);
      if (!need(off + (size_t)l_name + 4)) return bail(3);
      std::string nm(chunk.data() + off, l_name - 1);
      off += l_name;
      int32_t l_ref = rd_i32(chunk.data() + off);
      off += 4;
      C.intern_chrom(nm);
      header_chroms.push_back(nm);
      ref_lens.push_back(l_ref);
    }
    if (rd.inflate_bad.load(std::memory_order_relaxed)) return bail(5);
    // --- records --- (the next chunk inflates on worker threads while the
    // main thread parses the current one; raw double buffers with a
    // leftover gap avoid re-copying the inflated stream every iteration)
    walk_t0_ns = epoch_ns();
    constexpr size_t GAP = 1 << 20;  // holds any partial trailing record
    bool ranged = P.range_start > 0;
    uint64_t uA;  // uncompressed offset of A.data()+A.start (range-local)
    if (!ranged) {
      A.ensure(chunk.size() - off);
      memcpy(A.data(), chunk.data() + off, chunk.size() - off);
      A.start = 0;
      A.len = chunk.size() - off;
      uA = off;
      first_u = (int64_t)off;
    } else {
      // reset the reader onto the (block-aligned) range start, then find
      // the first record boundary by validated chaining
      if (rd.rat.joinable()) rd.rat.join();
      rd.ra_active = false;
      rd.eof = false;
      rd.truncated = false;
      if (!rd.seek_to(P.range_start)) return bail(5);
      std::string first;
      bool stream_ended = false;
      if (!rd.next_chunk(first, 1024)) stream_ended = true;
      size_t b = 0;
      bool found = false;
      int32_t nref_i = (int32_t)header_chroms.size();
      while (!stream_ended) {
        for (; b < first.size(); b++) {
          if (bam_chain_valid(first.data(), first.size(), b, nref_i)) {
            found = true;
            break;
          }
        }
        if (found) break;
        std::string more;
        if (!rd.next_chunk(more, 1024)) { stream_ended = true; break; }
        first += more;
        if (first.size() > (256u << 20)) return bail(4);
      }
      if (!found) {
        // range holds no record boundary (tiny tail range)
        first_u = next_u = (int64_t)first.size();
        if (rd.rat.joinable()) rd.rat.join();
        take_counters();
        fclose(f);
        return 0;
      }
      first_u = (int64_t)b;
      A.ensure(first.size() - b);
      memcpy(A.data(), first.data() + b, first.size() - b);
      A.start = 0;
      A.len = first.size() - b;
      uA = b;
    }
    chunk.clear();
    chunk.shrink_to_fit();
    // >0: budget; 0: unbounded; <0: own nothing (an empty shard still
    // reports its discovered boundary for the cross-shard check)
    uint64_t ulen = P.range_ulen > 0 ? (uint64_t)P.range_ulen
                    : (P.range_ulen < 0 ? 0 : UINT64_MAX);
    bool stopped = false;
    // the inflate pool fills B while this thread parses A (start/finish
    // replace the old per-chunk outer prefetch thread)
    bool have_next = rd.start_next_raw(B, GAP);
    for (;;) {
      // index record payload offsets in this buffer
      std::vector<std::pair<size_t, int32_t>> recs;
      size_t p = A.start;
      for (;;) {
        if (A.len - p < 4) break;
        int32_t bs = rd_i32(A.data() + p);
        if (bs < 0 || A.len - p < 4 + (size_t)bs) break;
        uint64_t u_rec = uA + (p - A.start);
        if (u_rec >= ulen) {
          // first record of the next shard: not ours
          stopped = true;
          next_u = (int64_t)u_rec;
          break;
        }
        recs.push_back({p + 4, bs});
        p += 4 + (size_t)bs;
      }
      if (!process_recs(A.data(), recs)) {
        return bail(fail_status);
      }
      // test-only pacing knob: lets streaming-overlap tests observe
      // per-chromosome completion deterministically on corpora that
      // would otherwise decode before the python loop takes a chromosome
      static const int chunk_delay_ms =
          getenv("CUTESV_DECODE_CHUNK_DELAY_MS")
              ? atoi(getenv("CUTESV_DECODE_CHUNK_DELAY_MS")) : 0;
      if (chunk_delay_ms > 0)
        std::this_thread::sleep_for(
            std::chrono::milliseconds(chunk_delay_ms));
      rd.finish_raw();
      if (stopped) break;
      if (rd.inflate_bad.load(std::memory_order_relaxed)) return bail(5);
      if (!have_next) {
        // a partial record at end-of-stream means the file was cut —
        // unless an uncompressed-length budget truncated the last shard
        if (A.len - p != 0 && ulen == UINT64_MAX) return bail(5);
        next_u = (int64_t)(uA + (p - A.start));
        break;
      }
      uA += p - A.start;
      size_t leftover = A.len - p;
      if (leftover <= GAP) {
        memcpy(B.data() + GAP - leftover, A.data() + p, leftover);
        B.start = GAP - leftover;
      } else {
        // a partial record larger than the gap (ultralong read): fall
        // back to one explicit stitch copy
        RawBuf C2;
        C2.ensure(leftover + (B.len - B.start));
        memcpy(C2.data(), A.data() + p, leftover);
        memcpy(C2.data() + leftover, B.data() + B.start,
               B.len - B.start);
        C2.start = 0;
        C2.len = leftover + (B.len - B.start);
        std::swap(B, C2);
      }
      std::swap(A, B);
      have_next = rd.start_next_raw(B, GAP);
    }
    walk_t1_ns = epoch_ns();
    t_records = (walk_t1_ns - walk_t0_ns) * 1e-9;
    rd.stop_submitter();  // it owns the end-of-input flags until joined
    if (rd.truncated || rd.inflate_bad.load(std::memory_order_relaxed))
      return bail(5);
    take_counters();
    fclose(f);
    return 0;
  }
};

// CRAM 3.0 front-end (same anonymous namespace; synthesizes BAM-layout
// records fed through Decoder::process_recs)
#include "cramdecode.inc"

// ---------------------------------------------------------------------------
// rank helpers: lexicographic ranks over the interned name table; INS seq
// content ranks (equal content -> equal rank) for the reference's sort keys
// ---------------------------------------------------------------------------

std::vector<int64_t> name_ranks(const Collector& C) {
  int64_t n = (int64_t)C.name_off.size() - 1;
  std::vector<int64_t> idx(n);
  for (int64_t i = 0; i < n; i++) idx[i] = i;
  auto view = [&](int64_t i) {
    return std::string_view(C.name_blob.data() + C.name_off[i],
                            C.name_off[i + 1] - C.name_off[i]);
  };
  auto lt = [&](int64_t a, int64_t b) { return view(a) < view(b); };
  std::vector<int64_t> rank(n);
  if (n < (1 << 16) || std::thread::hardware_concurrency() < 2) {
    std::sort(idx.begin(), idx.end(), lt);
    for (int64_t r = 0; r < n; r++) rank[idx[r]] = r;
    return rank;
  }
  // the lexicographic sort over millions of interned names is the
  // largest post-walk serial cost — split it across two threads and
  // assign ranks in a two-pointer merge pass (names are UNIQUE by
  // interning, so rank order is total and the merge needs no tie-break)
  int64_t mid = n / 2;
  std::thread lo([&]() { std::sort(idx.begin(), idx.begin() + mid, lt); });
  std::sort(idx.begin() + mid, idx.end(), lt);
  lo.join();
  int64_t a = 0, b = mid, r = 0;
  while (a < mid && b < n)
    rank[lt(idx[a], idx[b]) ? idx[a++] : idx[b++]] = r++;
  while (a < mid) rank[idx[a++]] = r++;
  while (b < n) rank[idx[b++]] = r++;
  return rank;
}

std::vector<int64_t> seq_ranks(const Collector& C) {
  int64_t n = (int64_t)C.ins_seq_off.v.size();
  std::vector<int64_t> idx(n);
  for (int64_t i = 0; i < n; i++) idx[i] = i;
  auto view = [&](int64_t i) {
    return std::string_view(C.ins_seq_blob.data() + C.ins_seq_off.v[i],
                            C.ins_seq_len.v[i]);
  };
  std::sort(idx.begin(), idx.end(), [&](int64_t a, int64_t b) {
    auto va = view(a), vb = view(b);
    if (va != vb) return va < vb;
    return a < b;
  });
  std::vector<int64_t> rank(n);
  int64_t r = -1;
  std::string_view prev;
  for (int64_t k = 0; k < n; k++) {
    auto v = view(idx[k]);
    if (k == 0 || v != prev) { r++; prev = v; }
    rank[idx[k]] = r;
  }
  return rank;
}

}  // namespace

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------

extern "C" {

struct CBuf {
  const void* data;
  int64_t len;
};

struct Snapshot {
  std::vector<int64_t> pos, len, nameid, lrank, seqlen, sqrank, seqoff;
};

struct CResult {
  Decoder* dec;  // owner
  std::vector<int64_t>* nrank;
  std::vector<int64_t>* srank;
  std::string* chrom_blob;
  std::vector<int64_t>* chrom_off;
  std::vector<int64_t>* ref_lens;
  int32_t n_header_refs;
  int64_t n_records;
  int status;
  std::thread* th = nullptr;     // streaming run
  bool finalized = false;
  Snapshot snap;                 // last bamdecode_snapshot result
};

static CResult* bamdecode_setup(const char* path, const int64_t* params,
                                const int32_t* bed_chr,
                                const int64_t* bed_start,
                                const int64_t* bed_end, int64_t n_bed,
                                const void* card, bool* is_cram_out) {
  auto* r = new CResult();
  auto* d = new Decoder();
  r->dec = d;
  d->card = static_cast<const CardInflate*>(card);
  d->P.min_size = params[0];
  d->P.min_mapq = params[1];
  d->P.max_split_parts = params[2];
  d->P.min_read_len = params[3];
  d->P.min_siglength = params[4];
  d->P.merge_del_threshold = params[5];
  d->P.merge_ins_threshold = params[6];
  d->P.max_size = params[7];
  d->P.n_threads = params[8];
  d->P.range_start = params[9];
  d->P.range_ulen = params[10];
  r->status = -1;
  r->nrank = nullptr;
  // BED regions must be registered after header parse for chrom ids, so the
  // caller passes ids in header space; build structure lazily on first use.
  if (n_bed > 0) {
    d->bed.enabled = true;
    int32_t maxc = 0;
    for (int64_t i = 0; i < n_bed; i++) maxc = std::max(maxc, bed_chr[i]);
    d->bed.starts.resize(maxc + 1);
    d->bed.maxend.resize(maxc + 1);
    std::vector<std::vector<std::pair<int64_t, int64_t>>> tmp(maxc + 1);
    for (int64_t i = 0; i < n_bed; i++)
      tmp[bed_chr[i]].push_back({bed_start[i], bed_end[i]});
    for (int32_t c = 0; c <= maxc; c++) {
      std::sort(tmp[c].begin(), tmp[c].end());
      int64_t m = INT64_MIN;
      for (auto& pr : tmp[c]) {
        d->bed.starts[c].push_back(pr.first);
        m = std::max(m, pr.second);
        d->bed.maxend[c].push_back(m);
      }
    }
  }
  // CRAM by magic sniff, BGZF/BAM otherwise
  bool is_cram = false;
  if (FILE* probe = fopen(path, "rb")) {
    char magic[4];
    is_cram = fread(magic, 1, 4, probe) == 4
              && memcmp(magic, "CRAM", 4) == 0;
    fclose(probe);
  }
  *is_cram_out = is_cram;
  return r;
}

static void bamdecode_finalize(CResult* r) {
  if (r->finalized) return;
  r->finalized = true;  // set FIRST: a failed attempt must not re-run
                        // (callers turn a throw into status 4; results
                        // are only extracted when status == 0)
  Decoder* d = r->dec;
  r->n_records = d->C.n_records;
  // the two rank computations are independent — overlap them (seq_ranks
  // is the smaller; name_ranks additionally parallelizes internally).
  // Exceptions on either side are captured so the helper thread is
  // always joined before any rethrow (a joinable thread destroyed
  // during unwind would std::terminate the host process).
  std::vector<int64_t> sr, nr;
  std::exception_ptr seq_err, name_err;
  std::thread srt([&]() {
    try {
      sr = seq_ranks(d->C);
    } catch (...) {
      seq_err = std::current_exception();
    }
  });
  try {
    nr = name_ranks(d->C);
  } catch (...) {
    name_err = std::current_exception();
  }
  srt.join();
  if (name_err) std::rethrow_exception(name_err);
  if (seq_err) std::rethrow_exception(seq_err);
  r->nrank = new std::vector<int64_t>(std::move(nr));
  r->srank = new std::vector<int64_t>(std::move(sr));
  r->chrom_blob = new std::string();
  r->chrom_off = new std::vector<int64_t>{0};
  for (auto& s : d->C.chroms) {
    r->chrom_blob->append(s);
    r->chrom_off->push_back((int64_t)r->chrom_blob->size());
  }
  r->ref_lens = new std::vector<int64_t>(d->ref_lens);
  r->n_header_refs = (int32_t)d->ref_lens.size();
  r->finalized = true;
}

// No exception may cross the extern "C"/thread boundary: a malformed
// header (or OOM) that throws would std::terminate the host Python
// process instead of reporting a status.
static int run_guarded(Decoder& d, const char* path, const char* ref_path,
                       bool is_cram) {
  try {
    return is_cram ? cram_run(d, path, ref_path) : d.run(path);
  } catch (const NoCigarError&) {
    return 6;
  } catch (const std::exception& e) {
    d.err_msg = e.what();
    return 4;
  } catch (...) {
    return 4;
  }
}

// human-readable detail for the last failure (empty when none); valid
// until bamdecode_free
extern "C" const char* bamdecode_err(CResult* r) {
  return r->dec->err_msg.c_str();
}

// ``card``: a CardInflate (cutesv_inflate_create) that inflates a BAM's
// BGZF blocks on the card, or null for zlib threads; a CRAM ignores it.
CResult* bamdecode_run(const char* path, const char* ref_path,
                       const int64_t* params, const int32_t* bed_chr,
                       const int64_t* bed_start, const int64_t* bed_end,
                       int64_t n_bed, const void* card) {
  bool is_cram = false;
  CResult* r = bamdecode_setup(path, params, bed_chr, bed_start, bed_end,
                               n_bed, card, &is_cram);
  Decoder* d = r->dec;
  r->status = run_guarded(*d, path, ref_path, is_cram);
  d->publish_progress(INT32_MAX);
  // finalize only successful runs (results are never extracted on a
  // nonzero status), and never let its throw cross the extern "C"
  // boundary
  if (r->status == 0) {
    try {
      bamdecode_finalize(r);
    } catch (const std::exception& e) {
      d->err_msg = e.what();
      r->status = 4;
    } catch (...) {
      r->status = 4;
    }
  }
  return r;
}

// Streaming variant: decode on a private thread; the caller polls
// progress, snapshots completed chromosomes, then joins.
CResult* bamdecode_start(const char* path, const char* ref_path,
                         const int64_t* params, const int32_t* bed_chr,
                         const int64_t* bed_start, const int64_t* bed_end,
                         int64_t n_bed, const void* card) {
  bool is_cram = false;
  CResult* r = bamdecode_setup(path, params, bed_chr, bed_start, bed_end,
                               n_bed, card, &is_cram);
  Decoder* d = r->dec;
  std::string p(path), rp(ref_path ? ref_path : "");
  bool has_ref = ref_path != nullptr;
  r->th = new std::thread([r, d, p, rp, has_ref, is_cram]() {
    r->status = run_guarded(*d, p.c_str(),
                            has_ref ? rp.c_str() : nullptr, is_cram);
    d->publish_progress(INT32_MAX);
    // finalize (rank sorts) on THIS thread: it overlaps the caller's
    // DONE-batch python work instead of serializing inside join().
    // Safe: the collector is immutable once run() returns (snapshots
    // only read it), and join() joins this thread before touching the
    // finalized results
    if (r->status == 0) {
      try {
        bamdecode_finalize(r);
      } catch (const std::exception& e) {
        d->err_msg = e.what();
        r->status = 4;
      } catch (...) {
        r->status = 4;
      }
    }
  });
  return r;
}

// refID currently being decoded: every chromosome with a smaller header id
// has all of its record-order rows merged (modulo SA-tag rows emitted by
// later reads — the Python side validates before reusing a snapshot).
// INT32_MAX once decoding is finished.
int32_t bamdecode_poll(CResult* r) {
  return r->dec->progress.load(std::memory_order_acquire);
}

// bamdecode_poll once the progress has passed ``seen`` or the decode is
// finished, whichever comes first, or after ``timeout_ms``: the caller
// sleeps until there is a chromosome to take. ctypes releases the GIL for
// the call.
int32_t bamdecode_wait(CResult* r, int32_t seen, int64_t timeout_ms) {
  return r->dec->wait_progress(seen, timeout_ms);
}

// number of header reference sequences; valid once poll() has returned
// a non-negative value (the header parse completes before the progress
// store that publishes the first refid, and before the DONE sentinel)
int32_t bamdecode_n_refs(CResult* r) {
  return (int32_t)r->dec->ref_lens.size();
}

// first/last refid merged so far (-1 while nothing merged): the
// possibly-partial boundary chromosomes of a ranged (sharded) decode
void bamdecode_range_refids(CResult* r, int32_t* first, int32_t* last) {
  *first = r->dec->first_ref.load(std::memory_order_acquire);
  *last = r->dec->last_ref.load(std::memory_order_acquire);
}

int bamdecode_join(CResult* r) {
  if (r->th) {
    r->th->join();
    delete r->th;
    r->th = nullptr;
  }
  // normally a no-op (the decode thread finalizes successful runs);
  // guards the throw like bamdecode_run and skips failed runs
  if (r->status == 0 && !r->finalized) {
    try {
      bamdecode_finalize(r);
    } catch (const std::exception& e) {
      r->dec->err_msg = e.what();
      r->status = 4;
    } catch (...) {
      r->status = 4;
    }
  }
  return r->status;
}

// Copy one chromosome's DEL (type 0) or INS (type 1) rows observed so far,
// with name ranks (and INS sequence-content ranks) computed LOCALLY over
// the snapshot — order-isomorphic to the final global ranks restricted to
// these rows, which is all the sort keys need. Returns the row count;
// arrays are fetched with bamdecode_snapshot_get until the next call.
int64_t bamdecode_snapshot(CResult* r, int type, int32_t chrom) {
  Decoder* d = r->dec;
  Snapshot& s = r->snap;
  s.pos.clear(); s.len.clear(); s.nameid.clear();
  s.lrank.clear(); s.seqlen.clear(); s.sqrank.clear(); s.seqoff.clear();
  std::vector<std::pair<int64_t, int64_t>> seq_spans;  // (off, len)
  // The walk thread takes snap_mu for every parse batch's merge, so time
  // spent here under the lock stalls decode directly. Phase 1 copies the
  // row columns (reserved, memcpy-speed); the rank SORTS run outside the
  // lock over bytes phase 2 copies out (both blobs are append-only with
  // immutable content — only the buffer base can move on realloc, which
  // is exactly what the byte copies make safe).
  {
    std::lock_guard<std::mutex> g(d->snap_mu);
    Collector& C = d->C;
    // scan only the chromosome's [first,last] row span (maintained at
    // merge) — the whole-stream scans were O(n_chroms * total rows)
    // across a run, a real stall under the merge lock at 24-contig
    // human scale
    auto span = [&](int which) {
      auto it = C.rng[which].find(chrom);
      if (it == C.rng[which].end())
        return std::make_pair((size_t)0, (size_t)0);
      return std::make_pair(it->second.first, it->second.second + 1);
    };
    if (type == 0) {
      auto [lo, hi] = span(0);
      s.pos.reserve(hi - lo); s.len.reserve(hi - lo);
      s.nameid.reserve(hi - lo);
      for (size_t i = lo; i < hi; i++) {
        if (C.del_chr.v[i] != chrom) continue;
        s.pos.push_back(C.del_pos.v[i]);
        s.len.push_back(C.del_len.v[i]);
        s.nameid.push_back(C.del_name.v[i]);
      }
    } else if (type == 2) {  // DUP: (p1, p2, name)
      auto [lo, hi] = span(2);
      s.pos.reserve(hi - lo); s.len.reserve(hi - lo);
      s.nameid.reserve(hi - lo);
      for (size_t i = lo; i < hi; i++) {
        if (C.dup_chr.v[i] != chrom) continue;
        s.pos.push_back(C.dup_p1.v[i]);
        s.len.push_back(C.dup_p2.v[i]);
        s.nameid.push_back(C.dup_name.v[i]);
      }
    } else if (type == 3) {  // INV: (b1, b2, strand, name)
      auto [lo, hi] = span(3);
      s.pos.reserve(hi - lo); s.len.reserve(hi - lo);
      s.seqlen.reserve(hi - lo); s.nameid.reserve(hi - lo);
      for (size_t i = lo; i < hi; i++) {
        if (C.inv_chr.v[i] != chrom) continue;
        s.pos.push_back(C.inv_b1.v[i]);
        s.len.push_back(C.inv_b2.v[i]);
        s.seqlen.push_back(C.inv_strand.v[i]);
        s.nameid.push_back(C.inv_name.v[i]);
      }
    } else if (type == 4) {  // TRA (keyed by chr1): (p1, chr2, p2, type)
      auto [lo, hi] = span(4);
      s.pos.reserve(hi - lo); s.len.reserve(hi - lo);
      s.seqlen.reserve(hi - lo); s.seqoff.reserve(hi - lo);
      s.nameid.reserve(hi - lo);
      for (size_t i = lo; i < hi; i++) {
        if (C.tra_chr1.v[i] != chrom) continue;
        s.pos.push_back(C.tra_p1.v[i]);
        s.len.push_back(C.tra_p2.v[i]);
        s.seqlen.push_back(C.tra_type.v[i]);
        s.seqoff.push_back(C.tra_chr2.v[i]);
        s.nameid.push_back(C.tra_name.v[i]);
      }
    } else if (type == 5) {  // census: (start, end, is_primary, name_id)
      auto [lo, hi] = span(5);
      s.pos.reserve(hi - lo); s.len.reserve(hi - lo);
      s.seqlen.reserve(hi - lo); s.nameid.reserve(hi - lo);
      for (size_t i = lo; i < hi; i++) {
        if (C.cen_chr.v[i] != chrom) continue;
        s.pos.push_back(C.cen_start.v[i]);
        s.len.push_back(C.cen_end.v[i]);
        s.seqlen.push_back(C.cen_prim.v[i]);
        s.nameid.push_back(C.cen_name.v[i]);
      }
      return (int64_t)s.pos.size();  // no local ranks needed
    } else {
      auto [lo, hi] = span(1);
      s.pos.reserve(hi - lo); s.len.reserve(hi - lo);
      s.seqlen.reserve(hi - lo); s.seqoff.reserve(hi - lo);
      s.nameid.reserve(hi - lo);
      seq_spans.reserve(hi - lo);
      for (size_t i = lo; i < hi; i++) {
        if (C.ins_chr.v[i] != chrom) continue;
        s.pos.push_back(C.ins_posx2.v[i]);
        s.len.push_back(C.ins_len.v[i]);
        s.nameid.push_back(C.ins_name.v[i]);
        s.seqlen.push_back(C.ins_seq_len.v[i]);
        s.seqoff.push_back(C.ins_seq_off.v[i]);
        seq_spans.push_back({C.ins_seq_off.v[i], C.ins_seq_len.v[i]});
      }
    }
  }
  // distinct name ids (outside the lock: the row sort is the most
  // expensive part of the old under-lock critical section)
  std::vector<int64_t> ids(s.nameid);
  std::sort(ids.begin(), ids.end());
  ids.erase(std::unique(ids.begin(), ids.end()), ids.end());
  // phase 2: copy the bytes the sorts will compare (short lock)
  std::string names_local, seqs_local;
  std::vector<int64_t> noff(1, 0), soff_local(1, 0);
  {
    std::lock_guard<std::mutex> g(d->snap_mu);
    Collector& C = d->C;
    int64_t ntotal = 0;
    for (int64_t id : ids) ntotal += C.name_off[id + 1] - C.name_off[id];
    names_local.reserve((size_t)ntotal);
    noff.reserve(ids.size() + 1);
    for (int64_t id : ids) {
      names_local.append(C.name_blob.data() + C.name_off[id],
                         (size_t)(C.name_off[id + 1] - C.name_off[id]));
      noff.push_back((int64_t)names_local.size());
    }
    if (type == 1) {
      int64_t stotal = 0;
      for (auto& sp : seq_spans) stotal += sp.second;
      seqs_local.reserve((size_t)stotal);
      soff_local.reserve(seq_spans.size() + 1);
      for (auto& sp : seq_spans) {
        seqs_local.append(C.ins_seq_blob.data() + sp.first,
                          (size_t)sp.second);
        soff_local.push_back((int64_t)seqs_local.size());
      }
    }
  }
  // local name ranks: sort the snapshot's distinct names by string;
  // interning guarantees distinct ids have distinct bytes (no ties)
  std::vector<int64_t> order(ids.size());
  for (size_t k = 0; k < order.size(); k++) order[k] = (int64_t)k;
  auto nview = [&](int64_t k) {
    return std::string_view(names_local.data() + noff[k],
                            (size_t)(noff[k + 1] - noff[k]));
  };
  std::sort(order.begin(), order.end(), [&](int64_t a, int64_t b) {
    return nview(a) < nview(b);
  });
  std::vector<int64_t> rank(ids.size());
  for (size_t k = 0; k < order.size(); k++) rank[order[k]] = (int64_t)k;
  s.lrank.resize(s.nameid.size());
  for (size_t i = 0; i < s.nameid.size(); i++) {
    size_t k = (size_t)(std::lower_bound(ids.begin(), ids.end(),
                                         s.nameid[i]) - ids.begin());
    s.lrank[i] = rank[k];
  }
  if (type == 1) {
    // local sequence-content ranks (equal content -> equal rank)
    size_t m = seq_spans.size();
    std::vector<int64_t> idx(m);
    for (size_t i = 0; i < m; i++) idx[i] = (int64_t)i;
    auto sview = [&](int64_t i) {
      return std::string_view(seqs_local.data() + soff_local[i],
                              (size_t)(soff_local[i + 1] - soff_local[i]));
    };
    std::sort(idx.begin(), idx.end(), [&](int64_t a, int64_t b) {
      auto va = sview(a), vb = sview(b);
      if (va != vb) return va < vb;
      return a < b;
    });
    s.sqrank.resize(m);
    int64_t rr = -1;
    std::string_view prev;
    for (size_t k = 0; k < m; k++) {
      auto v = sview(idx[k]);
      if (k == 0 || v != prev) { rr++; prev = v; }
      s.sqrank[idx[k]] = rr;
    }
  }
  return (int64_t)s.pos.size();
}

// fields: 0 pos (DEL pos / INS pos*2), 1 len, 2 name id, 3 local name
// rank, 4 INS seq len, 5 INS local seq rank, 6 INS seq blob offset
// (global: the blob only appends, so snapshot offsets stay valid)
int bamdecode_snapshot_get(CResult* r, int field, const void** data,
                           int64_t* len) {
  Snapshot& s = r->snap;
  auto set = [&](const std::vector<int64_t>& v) {
    *data = v.data();
    *len = (int64_t)v.size();
    return 0;
  };
  switch (field) {
    case 0: return set(s.pos);
    case 1: return set(s.len);
    case 2: return set(s.nameid);
    case 3: return set(s.lrank);
    case 4: return set(s.seqlen);
    case 5: return set(s.sqrank);
    case 6: return set(s.seqoff);
    default: return 1;
  }
}

// Copy ``n`` spans of the (append-only) INS sequence blob into a caller
// buffer laid end to end; safe mid-decode (the blob may reallocate on
// growth, so reads take the same lock the workers' merges do). Returns
// the bytes written, or -1 when a span is out of range.
int64_t bamdecode_ins_seq_spans(CResult* r, const int64_t* offs,
                                const int64_t* lens, int64_t n,
                                char* out) {
  Decoder* d = r->dec;
  std::lock_guard<std::mutex> g(d->snap_mu);
  const std::string& blob = d->C.ins_seq_blob;
  int64_t w = 0;
  for (int64_t i = 0; i < n; i++) {
    if (offs[i] < 0 || lens[i] < 0
        || (uint64_t)(offs[i] + lens[i]) > (uint64_t)blob.size())
      return -1;
    memcpy(out + w, blob.data() + offs[i], (size_t)lens[i]);
    w += lens[i];
  }
  return w;
}

// mmap a whole regular file read-only; shared prologue of the scan and
// floor entry points. Returns nullptr when the caller should fall back.
static const uint8_t* map_whole_file(const char* path, size_t* size_out) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  int fd = fileno(f);
  struct stat st;
  if (fd < 0 || fstat(fd, &st) != 0 || !S_ISREG(st.st_mode)
      || st.st_size <= 0) {
    fclose(f);
    return nullptr;
  }
  const uint8_t* map = (const uint8_t*)mmap(nullptr, (size_t)st.st_size,
                                            PROT_READ, MAP_PRIVATE, fd, 0);
  fclose(f);
  if (map == MAP_FAILED) return nullptr;
  madvise((void*)map, (size_t)st.st_size, MADV_SEQUENTIAL);
  *size_out = (size_t)st.st_size;
  return map;
}

// BGZF block-table scan for sharded-decode planning (mmap'd, ~30x the
// pure-python scanner at human-genome scale). Returns 0 and malloc'd
// int64 arrays (caller frees with bamdecode_scan_free); non-zero means
// the caller should fall back to the python scanner (which raises the
// designed error messages on malformed input).
int bamdecode_scan_bgzf(const char* path, int64_t** offs_out,
                        int64_t** isizes_out, int64_t* n_out) {
  size_t size = 0;
  const uint8_t* map = map_whole_file(path, &size);
  if (!map) return 2;
  size_t pos = 0;
  std::vector<int64_t> offs, isz;
  int rc = 0;
  while (pos < size) {
    size_t coff, nxt;
    uint32_t clen, isize;
    if (!bgzf_parse_block_at(map, size, pos, &coff, &clen, &isize,
                             &nxt)) {
      rc = 3;  // malformed: python scanner owns the designed error
      break;
    }
    offs.push_back((int64_t)pos);
    isz.push_back((int64_t)isize);
    pos = nxt;
  }
  munmap((void*)map, size);
  if (rc) return rc;
  int64_t n = (int64_t)offs.size();
  int64_t* po = (int64_t*)malloc(sizeof(int64_t) * (size_t)(n ? n : 1));
  int64_t* pi = (int64_t*)malloc(sizeof(int64_t) * (size_t)(n ? n : 1));
  if (!po || !pi) { free(po); free(pi); return 2; }
  memcpy(po, offs.data(), sizeof(int64_t) * (size_t)n);
  memcpy(pi, isz.data(), sizeof(int64_t) * (size_t)n);
  *offs_out = po;
  *isizes_out = pi;
  *n_out = n;
  return 0;
}

void bamdecode_scan_free(int64_t* p) { free(p); }

// Pure BGZF inflate wall for ``path`` with ``threads`` workers, block
// table pre-scanned (bench artifact support: the measured lower bound
// of the decode stage on this host, so "decode sits at the inflate
// floor" is verifiable from the emitted JSON). Inflates into small
// per-thread scratch buffers — decompression compute only. Returns
// seconds, or -1 on any error.
double bamdecode_inflate_floor(const char* path, int threads) {
  size_t size = 0;
  const uint8_t* map = map_whole_file(path, &size);
  if (!map) return -1;
  size_t pos = 0;
  struct Span { size_t off; uint32_t clen, isize; };
  std::vector<Span> blocks;
  while (pos < size) {
    size_t coff, nxt;
    uint32_t clen, isize;
    if (!bgzf_parse_block_at(map, size, pos, &coff, &clen, &isize,
                             &nxt)) {
      munmap((void*)map, size);
      return -1;
    }
    blocks.push_back({coff, clen, isize});
    pos = nxt;
  }
  if (threads < 1) threads = 1;
  std::atomic<size_t> next{0};
  std::atomic<bool> bad{false};
  auto t0 = std::chrono::steady_clock::now();
  auto worker = [&]() {
    ZInflater d(-15);
    if (!d.ok()) { bad.store(true, std::memory_order_relaxed); return; }
    std::vector<char> scratch(65536);
    for (;;) {
      size_t i = next.fetch_add(1);
      if (i >= blocks.size()) break;
      size_t actual = 0;
      if (!d.run(map + blocks[i].off, blocks[i].clen, scratch.data(),
                 blocks[i].isize, &actual)
          || actual != blocks[i].isize)  // same test inflate_blocks uses
        bad.store(true, std::memory_order_relaxed);
    }
  };
  std::vector<std::thread> ts;
  for (int i = 0; i < threads; i++) ts.emplace_back(worker);
  for (auto& t : ts) t.join();
  double dt = std::chrono::duration<double>(
      std::chrono::steady_clock::now() - t0).count();
  munmap((void*)map, size);
  return bad.load() ? -1 : dt;
}

int bamdecode_status(CResult* r) { return r->status; }
int64_t bamdecode_n_records(CResult* r) { return r->n_records; }

// decoder-internal record-walk wall (seconds): the BGZF record loop from
// end-of-header to end-of-stream (a CRAM's container loop) — the
// quantity the measured inflate floor lower-bounds
double bamdecode_walk_seconds(CResult* r) { return r->dec->t_records; }

// the record walk's start and end on the epoch clock (system_clock ns,
// the clock of the program's spans and of torch.profiler's events); 0
// when the walk did not run to its end
int64_t bamdecode_walk_start_ns(CResult* r) { return r->dec->walk_t0_ns; }
int64_t bamdecode_walk_end_ns(CResult* r) { return r->dec->walk_t1_ns; }

// busy core-seconds (not walls): summed over all participating threads.
// inflate = time inside zlib inflate spans; records = time inside the
// record-parse loops. Published in the bench artifact so the inflate-
// floor argument is auditable from the JSON.
double bamdecode_inflate_core_seconds(CResult* r) {
  return r->dec->inflate_core_s;
}
double bamdecode_records_core_seconds(CResult* r) {
  return r->dec->records_core_ns.load() * 1e-9;
}

// the BGZF blocks the card and the zlib threads inflated in the call, the
// batches the reader handed the card and the kernel launches made for them
void bamdecode_blocks(CResult* r, int64_t* card, int64_t* host,
                      int64_t* batches, int64_t* launches) {
  *card = r->dec->blocks_card;
  *host = r->dec->blocks_host;
  *batches = r->dec->batches_card;
  *launches = r->dec->launches_card;
}

// generic array accessor: returns pointer + element count via out params.
// field ids documented in io/native.py (kept in lockstep).
int bamdecode_get(CResult* r, int field, const void** data, int64_t* len) {
  Collector& C = r->dec->C;
  auto set = [&](const void* d, int64_t n) {
    *data = d;
    *len = n;
    return 0;
  };
  switch (field) {
    case 0: return set(C.name_blob.data(), (int64_t)C.name_blob.size());
    case 1: return set(C.name_off.data(), (int64_t)C.name_off.size());
    case 2: return set(r->nrank->data(), (int64_t)r->nrank->size());
    case 3: return set(r->chrom_blob->data(), (int64_t)r->chrom_blob->size());
    case 4: return set(r->chrom_off->data(), (int64_t)r->chrom_off->size());
    case 5: return set(r->ref_lens->data(), (int64_t)r->ref_lens->size());
    case 80: { *data = &r->dec->first_u; *len = 1; return 0; }
    case 81: { *data = &r->dec->next_u; *len = 1; return 0; }
    case 10: return set(C.del_chr.v.data(), (int64_t)C.del_chr.v.size());
    case 11: return set(C.del_pos.v.data(), (int64_t)C.del_pos.v.size());
    case 12: return set(C.del_len.v.data(), (int64_t)C.del_len.v.size());
    case 13: return set(C.del_name.v.data(), (int64_t)C.del_name.v.size());
    case 20: return set(C.ins_chr.v.data(), (int64_t)C.ins_chr.v.size());
    case 21: return set(C.ins_posx2.v.data(), (int64_t)C.ins_posx2.v.size());
    case 22: return set(C.ins_len.v.data(), (int64_t)C.ins_len.v.size());
    case 23: return set(C.ins_name.v.data(), (int64_t)C.ins_name.v.size());
    case 24: return set(C.ins_seq_off.v.data(),
                        (int64_t)C.ins_seq_off.v.size());
    case 25: return set(C.ins_seq_len.v.data(),
                        (int64_t)C.ins_seq_len.v.size());
    case 26: return set(C.ins_seq_blob.data(),
                        (int64_t)C.ins_seq_blob.size());
    case 27: return set(r->srank->data(), (int64_t)r->srank->size());
    case 30: return set(C.dup_chr.v.data(), (int64_t)C.dup_chr.v.size());
    case 31: return set(C.dup_p1.v.data(), (int64_t)C.dup_p1.v.size());
    case 32: return set(C.dup_p2.v.data(), (int64_t)C.dup_p2.v.size());
    case 33: return set(C.dup_name.v.data(), (int64_t)C.dup_name.v.size());
    case 40: return set(C.inv_chr.v.data(), (int64_t)C.inv_chr.v.size());
    case 41: return set(C.inv_strand.v.data(),
                        (int64_t)C.inv_strand.v.size());
    case 42: return set(C.inv_b1.v.data(), (int64_t)C.inv_b1.v.size());
    case 43: return set(C.inv_b2.v.data(), (int64_t)C.inv_b2.v.size());
    case 44: return set(C.inv_name.v.data(), (int64_t)C.inv_name.v.size());
    case 50: return set(C.tra_chr1.v.data(), (int64_t)C.tra_chr1.v.size());
    case 51: return set(C.tra_type.v.data(), (int64_t)C.tra_type.v.size());
    case 52: return set(C.tra_p1.v.data(), (int64_t)C.tra_p1.v.size());
    case 53: return set(C.tra_chr2.v.data(), (int64_t)C.tra_chr2.v.size());
    case 54: return set(C.tra_p2.v.data(), (int64_t)C.tra_p2.v.size());
    case 55: return set(C.tra_name.v.data(), (int64_t)C.tra_name.v.size());
    case 60: return set(C.cen_chr.v.data(), (int64_t)C.cen_chr.v.size());
    case 61: return set(C.cen_start.v.data(), (int64_t)C.cen_start.v.size());
    case 62: return set(C.cen_end.v.data(), (int64_t)C.cen_end.v.size());
    case 63: return set(C.cen_prim.v.data(), (int64_t)C.cen_prim.v.size());
    case 64: return set(C.cen_name.v.data(), (int64_t)C.cen_name.v.size());
    case 70: return set(C.all_chr.v.data(), (int64_t)C.all_chr.v.size());
    case 71: return set(C.all_start.v.data(), (int64_t)C.all_start.v.size());
    case 72: return set(C.all_end.v.data(), (int64_t)C.all_end.v.size());
    case 73: return set(C.all_prim.v.data(), (int64_t)C.all_prim.v.size());
    case 74: return set(C.all_name.v.data(), (int64_t)C.all_name.v.size());
    default: return 1;
  }
}

void bamdecode_free(CResult* r) {
  if (r->th) {
    r->th->join();
    delete r->th;
  }
  delete r->nrank;
  delete r->srank;
  delete r->chrom_blob;
  delete r->chrom_off;
  delete r->ref_lens;
  delete r->dec;
  delete r;
}

// Test seam: decompress one CRAM block payload with the given method id
// (0-8), for direct python-vs-native codec differentials without
// crafting whole container files. Returns a malloc'd buffer the caller
// frees with bamdecode_block_free; on failure returns nullptr and
// writes a static error string pointer to *err.
char* bamdecode_block_decode(int method, const uint8_t* data, int64_t len,
                             int64_t raw_size, int64_t* out_len,
                             const char** err) {
  static thread_local std::string err_buf;
  *out_len = 0;
  *err = nullptr;
  try {
    CramBlock blk;
    blk.method = method;
    blk.comp = data;
    blk.comp_len = (size_t)len;
    blk.raw_size = raw_size;
    blk.decompress();
    char* out = (char*)malloc(blk.data.size() ? blk.data.size() : 1);
    if (!out) throw std::bad_alloc();
    memcpy(out, blk.data.data(), blk.data.size());
    *out_len = (int64_t)blk.data.size();
    return out;
  } catch (const std::exception& e) {
    err_buf = e.what();
    *err = err_buf.c_str();
    return nullptr;
  } catch (...) {
    err_buf = "unknown native block decode failure";
    *err = err_buf.c_str();
    return nullptr;
  }
}

void bamdecode_block_free(char* p) { free(p); }

}  // extern "C"
