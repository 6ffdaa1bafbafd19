// BGZF block inflate on the card, hand-written for Hopper (sm_90a).
//
// Replaces no kernel of the JAX package: cutesv_tpu inflates a BAM's BGZF
// blocks on the host (libdeflate; the port's C++ decoder used zlib threads).
// It was added because that inflate was most of a call's time while the
// card sat idle: every BGZF block is an independent raw-deflate stream
// (RFC 1951) of at most 64 KiB out, so a batch of blocks is a batch of
// independent serial decodes.
//
// Design. One warp per BGZF block, every block of a batch in one launch.
// Lane 0 walks the block's bit stream: for a dynamic-Huffman block it reads
// the code-length code and the code lengths; for each Huffman block the
// warp builds the literal/length and distance codes together in shared
// memory as direct-lookup tables (LIT_BITS and DIST_BITS bits; a longer
// code falls back to a canonical walk over the sorted symbols). Lane 0 then
// decodes up to QUEUE symbols into a queue in shared memory, and the warp
// executes the queue together: a warp scan gives each symbol its output
// offset, the literals are stored at once, and each match is copied by the
// 32 lanes in order (byte k of a match at distance d < length repeats byte
// k mod d before it, so no lane waits on another inside a match). Stored
// blocks are copied by the warp. Fixed-Huffman blocks build their tables
// from the fixed lengths. Output goes straight to the block's out_off in
// one device buffer; nothing is staged.
//
// Status. One word per block: 0 when the stream ended (its final block)
// inside the block's compressed bytes with exactly isize bytes written;
// otherwise the first fault met (BadType, BadStored, BadCodes, BadSymbol,
// BadSize, BadInput below). The rules are zlib's for raw deflate: a code
// must not be over-subscribed and must be complete unless it is a single
// code of length 1 (an all-zero distance code is allowed and fails at its
// first use), a distance may not reach before the block's first byte, and
// bytes after the stream's end are ignored. A block whose status is not 0
// may have written any bytes inside [out_off, out_off + isize), never
// outside; the caller treats the whole batch as failed.
//
// What bounds it. Not bytes: a batch reads its compressed bytes once and
// writes its output once (~6x the input for a BAM at zlib level 1), so at
// 3.35 TB/s a 24 MiB batch is ~9 us of traffic. The bit stream of one
// block is inherently serial, so a block takes as long as lane 0's decode
// loop (one table lookup in shared memory and a few shifts a symbol) plus
// the warp's copies, and a launch as long as its slowest block; throughput
// comes from many blocks in flight on the 132 SMs (WARPS per CTA, several
// CTAs per SM). On the decoder's path the PCIe transfers around the kernel
// (the compressed bytes up, the inflated bytes down) are the floor.
//
// Two entry points:
// * cutesv_inflate_launch: one launch over device buffers on the caller's
//   stream (ops/inflate.py; the card tests and the kernel benchmark);
// * cutesv_inflate_create: the decoder's back end (native/bamdecode.cpp),
//   a table of C functions over buffers allocated once per process and
//   device: LANES batches inflate at once, each lane on a non-blocking
//   stream of its own, and their output comes down into SLOTS pinned host
//   buffers (after HOST_GAP bytes that the decoder keeps for a record cut
//   at the previous batch's end); see the back end's section below.

#include <cuda_runtime.h>

#include "card_inflate.h"

#include <cstddef>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <new>

namespace {

constexpr int WARPS = 8;              // BGZF blocks (one warp each) per CTA
constexpr int LIT_BITS = 10;          // direct-lookup bits, literal/length
constexpr int DIST_BITS = 9;          // direct-lookup bits, distance
constexpr int QUEUE = 32;             // symbols lane 0 hands the warp at once
constexpr uint16_t LONG_CODE = 0x8000;  // entry: a code longer than the bits
constexpr uint32_t LITERAL = 0x80000000u;

enum Status : int32_t {
  Ok = 0,
  BadType = 1,     // block type 3
  BadStored = 2,   // a stored block's LEN is not ~NLEN
  BadCodes = 3,    // code lengths: counts, repeats, over-subscribed,
                   // incomplete, no end-of-block code
  BadSymbol = 4,   // a bit pattern with no code, literal/length 286-287,
                   // distance 30-31, a distance before the first byte
  BadSize = 5,     // more than isize bytes, or fewer at the stream's end
  BadInput = 6,    // the stream runs past the block's compressed bytes
};

enum Cmd : int32_t { Continue = 0, Stored = 1, Build = 2, Done = 3, Fail = 4 };

__constant__ uint16_t kLenBase[29] = {
    3,  4,  5,  6,  7,  8,  9,  10, 11,  13,  15,  17,  19,  23, 27,
    31, 35, 43, 51, 59, 67, 83, 99, 115, 131, 163, 195, 227, 258};
__constant__ uint8_t kLenExtra[29] = {0, 0, 0, 0, 0, 0, 0, 0, 1, 1,
                                      1, 1, 2, 2, 2, 2, 3, 3, 3, 3,
                                      4, 4, 4, 4, 5, 5, 5, 5, 0};
__constant__ uint16_t kDistBase[30] = {
    1,    2,    3,    4,    5,    7,     9,     13,    17,  25,
    33,   49,   65,   97,   129,  193,   257,   385,   513, 769,
    1025, 1537, 2049, 3073, 4097, 6145, 8193, 12289, 16385, 24577};
__constant__ uint8_t kDistExtra[30] = {0, 0, 0, 0, 1, 1, 2,  2,  3,  3,
                                       4, 4, 5, 5, 6, 6, 7,  7,  8,  8,
                                       9, 9, 10, 10, 11, 11, 12, 12, 13, 13};
__constant__ uint8_t kClOrder[19] = {16, 17, 18, 0, 8,  7, 9,  6, 10, 5,
                                     11, 4,  12, 3, 13, 2, 14, 1, 15};

// One warp's shared memory (~4.5 KB).
struct WarpSmem {
  uint16_t lit[1 << LIT_BITS];   // entry: symbol | length << 9, 0: no code
  uint16_t dist[1 << DIST_BITS];
  uint16_t lit_sym[288];         // symbols sorted by (length, symbol)
  uint16_t dist_sym[32];         // (also the code-length code's, 19)
  int32_t lit_count[16];         // codes of each length
  int32_t dist_count[16];        // (also the code-length code's, 1-7)
  int32_t offs[16];              // build scratch: first sorted index
  int32_t first[16];             // build scratch: first code of a length
  int32_t run[16];               // build scratch: next sorted index
  uint32_t queue[QUEUE];         // literal: LITERAL | byte; match:
                                 // length << 16 | distance
  uint8_t lens[288 + 32];        // literal/length lengths, then distance
  int32_t cmd, qn, base;         // next command, queued symbols, their
                                 // first output offset
  int32_t arg0, arg1, arg2;      // Stored: src, length, out; Build: n_lit,
                                 // n_dist, fixed
  int32_t ok;                    // Build: both codes usable
};

__device__ __forceinline__ uint32_t load_word(const uint8_t* __restrict__ src,
                                              uint64_t bytes, uint64_t i) {
  // i is a multiple of 4 and src is 4-aligned; bytes past the buffer read 0
  if (i + 4 <= bytes) return __ldg(reinterpret_cast<const uint32_t*>(src + i));
  uint32_t w = 0;
  for (int k = 0; k < 4; k++)
    if (i + k < bytes) w |= static_cast<uint32_t>(__ldg(src + i + k)) << (8 * k);
  return w;
}

// Canonical decode (RFC 1951 3.2.2) of the code at the bottom of `bits`:
// the symbol, with its length in *used, or -1 when no code matches.
__device__ __forceinline__ int canon_decode(uint64_t bits,
                                            const int32_t* count,
                                            const uint16_t* sym, int max_len,
                                            int* used) {
  int code = 0, first = 0, index = 0;
  for (int len = 1; len <= max_len; len++) {
    code |= static_cast<int>(bits & 1);
    bits >>= 1;
    const int c = count[len];
    if (code - c < first) {
      *used = len;
      return sym[index + (code - first)];
    }
    index += c;
    first += c;
    first <<= 1;
    code <<= 1;
  }
  return -1;
}

// The warp builds one canonical code from lens[0, n): its count per length,
// its symbols sorted by (length, symbol) and its direct-lookup table of
// 2^bits entries. Returns on every lane whether the code is usable.
__device__ bool build_code(WarpSmem& w, const uint8_t* lens, int n,
                           uint16_t* tab, int bits, int32_t* count,
                           uint16_t* sym, int lane) {
  const unsigned full = 0xffffffffu;
  const unsigned lt = (1u << lane) - 1u;
  if (lane < 16) count[lane] = 0;
  __syncwarp();
  // counts: the lowest lane of each group of equal lengths adds the group
  for (int c = 0; c < n; c += 32) {
    const int s = c + lane;
    const int len = s < n ? lens[s] : 0;
    const unsigned grp = __match_any_sync(full, len);
    if (len && (grp & lt) == 0) count[len] += __popc(grp);
    __syncwarp();
  }
  if (lane == 0) {
    int left = 1, max = 0, off = 0, code = 0;
    bool ok = true;
    for (int len = 1; len < 16; len++) {
      left = (left << 1) - count[len];
      if (left < 0) ok = false;          // over-subscribed
      if (count[len]) max = len;
    }
    if (left > 0 && max > 1) ok = false;  // incomplete (zlib's rule)
    for (int len = 1; len < 16; len++) {  // RFC 1951 3.2.2 (count[0] is 0)
      code = (code + count[len - 1]) << 1;
      w.first[len] = code;
      w.offs[len] = off;
      w.run[len] = off;
      off += count[len];
    }
    w.ok = ok;
  }
  for (int j = lane; j < (1 << bits); j += 32) tab[j] = 0;
  __syncwarp();
  // sorted symbols: rank inside each group of equal lengths by lane order
  for (int c = 0; c < n; c += 32) {
    const int s = c + lane;
    const int len = s < n ? lens[s] : 0;
    const unsigned grp = __match_any_sync(full, len);
    if (len) sym[w.run[len] + __popc(grp & lt)] = static_cast<uint16_t>(s);
    __syncwarp();
    if (len && (grp & lt) == 0) w.run[len] += __popc(grp);
    __syncwarp();
  }
  // the table: each code's entry at its bit-reversed code, repeated over
  // every value of the bits above its length
  const int n_codes = w.offs[15] + count[15];
  const bool ok = w.ok;
  if (ok) {
    const int mask = (1 << bits) - 1;
    for (int i = lane; i < n_codes; i += 32) {
      const int s = sym[i];
      const int len = lens[s];
      const int code = w.first[len] + (i - w.offs[len]);
      const int rev = static_cast<int>(__brev(static_cast<unsigned>(code)) >>
                                       (32 - len));
      if (len <= bits) {
        const uint16_t e = static_cast<uint16_t>(s | (len << 9));
        for (int j = rev; j <= mask; j += 1 << len) tab[j] = e;
      } else {
        tab[rev & mask] = LONG_CODE;
      }
    }
  }
  __syncwarp();
  return ok;
}

// out[o + k] = out[o - d + k] for k in [0, len), by the warp.
__device__ __forceinline__ void copy_match(uint8_t* dst, int o, int len,
                                           int d, int lane) {
  if (d >= len) {
    for (int k = lane; k < len; k += 32) dst[o + k] = dst[o - d + k];
  } else {
    // the match repeats its first d bytes: byte k is byte k mod d of them
    int r = lane % d;
    const int step = 32 % d;
    for (int k = lane; k < len; k += 32) {
      dst[o + k] = dst[o - d + r];
      r += step;
      if (r >= d) r -= d;
    }
  }
}

__global__ void __launch_bounds__(WARPS * 32)
    bgzf_inflate_kernel(const uint8_t* __restrict__ src, uint64_t src_bytes,
                        const uint32_t* __restrict__ meta, int n_blocks,
                        uint8_t* out, int32_t* __restrict__ status) {
  __shared__ WarpSmem smem[WARPS];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * WARPS + warp;
  if (b >= n_blocks) return;  // the whole warp
  WarpSmem& w = smem[warp];
  const uint64_t s_off = meta[4 * b];
  const uint32_t clen = meta[4 * b + 1];
  uint8_t* dst = out + meta[4 * b + 2];
  const int isize = static_cast<int>(meta[4 * b + 3]);

  // lane 0's decoder state: the bit reader (a 64-bit buffer refilled by
  // aligned words, the next word already loaded), the output count, and
  // where the stream stands
  uint64_t bitbuf = 0, wpos = 0;
  uint32_t next = 0;
  int bitcnt = 0, produced = 0, st = Ok;
  bool in_huff = false, last = false;
  auto seek = [&](uint64_t p) {  // start reading at byte p
    const uint64_t a = p & ~uint64_t{3};
    const int skip = static_cast<int>(p - a) * 8;
    bitbuf = load_word(src, src_bytes, a) >> skip;
    bitcnt = 32 - skip;
    wpos = a + 4;
    next = load_word(src, src_bytes, wpos);
  };
  auto refill = [&]() {
    if (bitcnt <= 32) {
      bitbuf |= static_cast<uint64_t>(next) << bitcnt;
      bitcnt += 32;
      wpos += 4;
      next = load_word(src, src_bytes, wpos);
    }
  };
  auto drop = [&](int k) {
    bitbuf >>= k;
    bitcnt -= k;
  };
  auto consumed_bits = [&]() {
    return (wpos - s_off) * 8 - static_cast<uint64_t>(bitcnt);
  };
  if (lane == 0) seek(s_off);

  for (;;) {
    if (lane == 0) {
      int qn = 0, cmd = Continue;
      w.base = produced;
      for (;;) {
        if (wpos > s_off + clen + 8) {  // every bit of the block is used
          st = BadInput;
          cmd = Fail;
          break;
        }
        if (!in_huff) {
          if (last) {
            cmd = Done;
            break;
          }
          refill();
          last = bitbuf & 1;
          const int type = static_cast<int>(bitbuf >> 1) & 3;
          drop(3);
          if (type == 0) {  // stored: LEN, NLEN from the next byte boundary
            drop(bitcnt & 7);
            refill();
            const int len = static_cast<int>(bitbuf & 0xffff);
            const int nlen = static_cast<int>(bitbuf >> 16) & 0xffff;
            drop(32);
            if (len != (~nlen & 0xffff)) {
              st = BadStored;
              cmd = Fail;
              break;
            }
            const uint64_t at = consumed_bits() / 8;  // into the block
            if (at + len > clen) {
              st = BadInput;
              cmd = Fail;
              break;
            }
            if (produced + len > isize) {
              st = BadSize;
              cmd = Fail;
              break;
            }
            w.arg0 = static_cast<int32_t>(at);
            w.arg1 = len;
            w.arg2 = produced;
            produced += len;
            seek(s_off + at + len);
            cmd = Stored;
            break;
          }
          if (type == 1) {  // fixed Huffman codes
            w.arg0 = 288;
            w.arg1 = 32;
            w.arg2 = 1;
            in_huff = true;
            cmd = Build;
            break;
          }
          if (type == 3) {
            st = BadType;
            cmd = Fail;
            break;
          }
          // dynamic: HLIT, HDIST, HCLEN, the code-length code's lengths
          refill();
          const int hlit = static_cast<int>(bitbuf & 31) + 257;
          const int hdist = static_cast<int>(bitbuf >> 5 & 31) + 1;
          const int hclen = static_cast<int>(bitbuf >> 10 & 15) + 4;
          drop(14);
          if (hlit > 286 || hdist > 30) {
            st = BadCodes;
            cmd = Fail;
            break;
          }
          uint8_t cl[19];
          for (int i = 0; i < 19; i++) cl[i] = 0;
          for (int i = 0; i < hclen; i++) {
            refill();
            cl[kClOrder[i]] = static_cast<uint8_t>(bitbuf & 7);
            drop(3);
          }
          // its canonical code, serially (19 symbols), in the distance
          // code's arrays; it must be complete
          for (int len = 0; len < 8; len++) w.dist_count[len] = 0;
          for (int s = 0; s < 19; s++) w.dist_count[cl[s]]++;
          w.dist_count[0] = 0;
          int left = 1, offs[8], off = 0;
          for (int len = 1; len < 8; len++) {
            left = (left << 1) - w.dist_count[len];
            offs[len] = off;
            off += w.dist_count[len];
          }
          if (left != 0) {
            st = BadCodes;
            cmd = Fail;
            break;
          }
          for (int s = 0; s < 19; s++)
            if (cl[s]) w.dist_sym[offs[cl[s]]++] = static_cast<uint16_t>(s);
          // the literal/length and distance code lengths, with repeats
          const int total = hlit + hdist;
          int i = 0;
          while (i < total) {
            refill();
            int used = 0;
            const int s = canon_decode(bitbuf, w.dist_count, w.dist_sym, 7,
                                       &used);
            if (s < 0) break;
            drop(used);
            if (s < 16) {
              w.lens[i++] = static_cast<uint8_t>(s);
              continue;
            }
            int rep, val = 0;
            if (s == 16) {
              if (i == 0) break;
              val = w.lens[i - 1];
              rep = 3 + static_cast<int>(bitbuf & 3);
              drop(2);
            } else if (s == 17) {
              rep = 3 + static_cast<int>(bitbuf & 7);
              drop(3);
            } else {
              rep = 11 + static_cast<int>(bitbuf & 127);
              drop(7);
            }
            if (i + rep > total) break;
            while (rep--) w.lens[i++] = static_cast<uint8_t>(val);
          }
          if (i < total || w.lens[256] == 0) {
            st = BadCodes;
            cmd = Fail;
            break;
          }
          // the distance lengths move up to lens[288]; the warp builds
          for (int k = hdist - 1; k >= 0; k--) w.lens[288 + k] = w.lens[hlit + k];
          w.arg0 = hlit;
          w.arg1 = hdist;
          w.arg2 = 0;
          in_huff = true;
          cmd = Build;
          break;
        }
        if (qn == QUEUE) break;  // Continue: the warp writes the queue
        refill();
        int sym, used;
        const uint16_t e = w.lit[bitbuf & ((1 << LIT_BITS) - 1)];
        if (e & LONG_CODE) {
          sym = canon_decode(bitbuf, w.lit_count, w.lit_sym, 15, &used);
        } else {
          sym = e ? (e & 511) : -1;
          used = e >> 9;
        }
        if (sym < 0 || sym > 285) {
          st = BadSymbol;
          cmd = Fail;
          break;
        }
        drop(used);
        if (sym < 256) {
          if (produced >= isize) {
            st = BadSize;
            cmd = Fail;
            break;
          }
          w.queue[qn++] = LITERAL | static_cast<uint32_t>(sym);
          produced++;
          continue;
        }
        if (sym == 256) {  // end of block
          in_huff = false;
          continue;
        }
        const int li = sym - 257;
        const int len = kLenBase[li] +
                        static_cast<int>(bitbuf & ((1u << kLenExtra[li]) - 1));
        drop(kLenExtra[li]);
        refill();
        int ds, dused;
        const uint16_t de = w.dist[bitbuf & ((1 << DIST_BITS) - 1)];
        if (de & LONG_CODE) {
          ds = canon_decode(bitbuf, w.dist_count, w.dist_sym, 15, &dused);
        } else {
          ds = de ? (de & 511) : -1;
          dused = de >> 9;
        }
        if (ds < 0 || ds > 29) {
          st = BadSymbol;
          cmd = Fail;
          break;
        }
        drop(dused);
        const int dist = kDistBase[ds] +
                         static_cast<int>(bitbuf & ((1u << kDistExtra[ds]) - 1));
        drop(kDistExtra[ds]);
        if (dist > produced) {
          st = BadSymbol;
          cmd = Fail;
          break;
        }
        if (produced + len > isize) {
          st = BadSize;
          cmd = Fail;
          break;
        }
        w.queue[qn++] = static_cast<uint32_t>(len) << 16 |
                        static_cast<uint32_t>(dist);
        produced += len;
      }
      w.qn = qn;
      w.cmd = cmd;
    }
    __syncwarp();
    const int qn = w.qn;
    const int cmd = w.cmd;
    if (qn > 0) {
      // offsets by a warp scan; literals at once, then each match in order
      const uint32_t e = lane < qn ? w.queue[lane] : 0;
      const bool lit = lane < qn && (e & LITERAL);
      const int len = lane < qn ? (lit ? 1 : static_cast<int>(e >> 16)) : 0;
      int incl = len;
      for (int d = 1; d < 32; d <<= 1) {
        const int t = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane >= d) incl += t;
      }
      const int o = w.base + incl - len;
      if (lit) dst[o] = static_cast<uint8_t>(e);
      unsigned matches = __ballot_sync(0xffffffffu, lane < qn && !lit);
      __syncwarp();
      while (matches) {
        const int j = __ffs(matches) - 1;
        matches &= matches - 1;
        const int mo = __shfl_sync(0xffffffffu, o, j);
        const uint32_t me = __shfl_sync(0xffffffffu, e, j);
        copy_match(dst, mo, static_cast<int>(me >> 16),
                   static_cast<int>(me & 0xffff), lane);
        __syncwarp();
      }
    }
    if (cmd == Stored) {
      const uint8_t* from = src + s_off + w.arg0;
      const int len = w.arg1, o = w.arg2;
      for (int k = lane; k < len; k += 32) dst[o + k] = from[k];
      __syncwarp();
    } else if (cmd == Build) {
      if (w.arg2) {  // the fixed codes' lengths
        for (int s = lane; s < 288; s += 32)
          w.lens[s] = s < 144 ? 8 : s < 256 ? 9 : s < 280 ? 7 : 8;
        w.lens[288 + lane] = 5;
        __syncwarp();
      }
      const int n_lit = w.arg0, n_dist = w.arg1;
      const bool ok_lit = build_code(w, w.lens, n_lit, w.lit, LIT_BITS,
                                     w.lit_count, w.lit_sym, lane);
      const bool ok_dist = build_code(w, w.lens + 288, n_dist, w.dist,
                                      DIST_BITS, w.dist_count, w.dist_sym,
                                      lane);
      if (!ok_lit || !ok_dist) {
        if (lane == 0) st = BadCodes;
        break;
      }
    } else if (cmd == Done) {
      if (lane == 0) {
        if (consumed_bits() > static_cast<uint64_t>(clen) * 8) st = BadInput;
        else if (produced != isize) st = BadSize;
      }
      break;
    } else if (cmd == Fail) {
      break;
    }
  }
  if (lane == 0) status[b] = st;
}

// --- the decoder's back end ---------------------------------------------
//
// A launch takes as long as its slowest block (lane 0's serial decode), so
// throughput comes from many blocks at once: LANES batches inflate on the
// card together, each in pinned and device buffers of its own on a
// non-blocking stream of its own, while only SLOTS batches need pinned
// host memory for their output's copy down. submit stages a batch's
// compressed span (at most IN_CAP bytes; the decoder cuts its batches so)
// in the lane's pinned buffer, copies it up and launches on the lane's
// stream; fetch enqueues the copy down of the lane's output into a host
// slot behind that launch (the lane may then take the next batch: its
// stream orders the next copy up and launch after the copy down); wait
// blocks on the slot. Nothing one lane does waits on another lane.

constexpr int LANES = 8;                      // batches inflating at once
constexpr int SLOTS = 3;                      // host buffers: the batch being
                                              // parsed, the next, one arriving
constexpr int MAX_BLOCKS = 384;               // BGZF blocks a batch
constexpr uint64_t OUT_CAP = uint64_t{MAX_BLOCKS} << 16;  // 24 MiB
constexpr uint64_t IN_CAP = uint64_t{4} << 20;  // compressed bytes a batch
constexpr uint64_t HOST_GAP = uint64_t{1} << 20;  // the decoder's GAP

struct Lane {
  unsigned char* h_in = nullptr;   // pinned: the compressed span, IN_CAP
  uint32_t* h_meta = nullptr;      // pinned: 4 words a block
  uint8_t* d_in = nullptr;         // device: IN_CAP
  uint8_t* d_out = nullptr;
  uint32_t* d_meta = nullptr;
  int32_t* d_status = nullptr;
  cudaStream_t stream = nullptr;
  cudaEvent_t up = nullptr;        // h_in and h_meta may be written again
  int n = 0;
  uint64_t out_bytes = 0;
};

struct Slot {
  char* h_out = nullptr;           // pinned: HOST_GAP + OUT_CAP
  int32_t* h_status = nullptr;     // pinned: a word a block
  cudaEvent_t done = nullptr;
  int n = 0;
};

struct Ctx {
  int dev = 0;
  Lane lane[LANES];
  Slot slot[SLOTS];
  std::mutex use;  // one decode at a time
  int64_t launches = 0;  // kernel launches since the decode's acquire
  CardInflate table{};
};

int launch(const uint8_t* src, uint64_t src_bytes, const uint32_t* meta,
           int n, uint8_t* out, int32_t* status, cudaStream_t stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  const int grid = (n + WARPS - 1) / WARPS;
  bgzf_inflate_kernel<<<grid, WARPS * 32, 0, stream>>>(src, src_bytes, meta,
                                                       n, out, status);
  return static_cast<int>(cudaGetLastError());
}

int ctx_acquire(void* c) {
  Ctx* x = static_cast<Ctx*>(c);
  x->use.lock();
  x->launches = 0;
  return 0;
}

int64_t ctx_launched(void* c) { return static_cast<Ctx*>(c)->launches; }

// Ends a decode's use: waits for everything it enqueued (a copy down may
// still target a slot the next decode reuses).
int ctx_release(void* c) {
  Ctx* x = static_cast<Ctx*>(c);
  cudaError_t err = cudaSetDevice(x->dev);
  for (Lane& l : x->lane) {
    const cudaError_t e = cudaStreamSynchronize(l.stream);
    if (err == cudaSuccess) err = e;
  }
  x->use.unlock();
  return static_cast<int>(err);
}

char* ctx_host_out(void* c, int k) {
  return static_cast<Ctx*>(c)->slot[k].h_out;
}

int ctx_submit(void* c, int k, const unsigned char* src, uint64_t src_bytes,
               const uint32_t* meta, int n, uint64_t out_bytes) {
  Ctx* x = static_cast<Ctx*>(c);
  if (k < 0 || k >= LANES || n < 0 || n > MAX_BLOCKS || out_bytes > OUT_CAP ||
      src_bytes > IN_CAP)
    return static_cast<int>(cudaErrorInvalidValue);
  Lane& l = x->lane[k];
  // the lane's previous batch went up long ago (its copy down is queued
  // behind it on the lane's stream), so this wait is short
  cudaError_t err = cudaSetDevice(x->dev);
  if (err == cudaSuccess) err = cudaEventSynchronize(l.up);
  if (err != cudaSuccess) return static_cast<int>(err);
  memcpy(l.h_meta, meta, sizeof(uint32_t) * 4 * static_cast<size_t>(n));
  memcpy(l.h_in, src, src_bytes);
  err = cudaMemcpyAsync(l.d_meta, l.h_meta, sizeof(uint32_t) * 4 * n,
                        cudaMemcpyHostToDevice, l.stream);
  if (err == cudaSuccess)
    err = cudaMemcpyAsync(l.d_in, l.h_in, src_bytes, cudaMemcpyHostToDevice,
                          l.stream);
  if (err == cudaSuccess) err = cudaEventRecord(l.up, l.stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  l.n = n;
  l.out_bytes = out_bytes;
  err = static_cast<cudaError_t>(
      launch(l.d_in, src_bytes, l.d_meta, n, l.d_out, l.d_status, l.stream));
  if (err == cudaSuccess && n > 0) x->launches++;
  return static_cast<int>(err);
}

int ctx_fetch(void* c, int k, int j) {
  Ctx* x = static_cast<Ctx*>(c);
  if (k < 0 || k >= LANES || j < 0 || j >= SLOTS)
    return static_cast<int>(cudaErrorInvalidValue);
  Lane& l = x->lane[k];
  Slot& s = x->slot[j];
  cudaError_t err = cudaSetDevice(x->dev);
  if (err == cudaSuccess)
    err = cudaMemcpyAsync(s.h_out + HOST_GAP, l.d_out, l.out_bytes,
                          cudaMemcpyDeviceToHost, l.stream);
  if (err == cudaSuccess)
    err = cudaMemcpyAsync(s.h_status, l.d_status, sizeof(int32_t) * l.n,
                          cudaMemcpyDeviceToHost, l.stream);
  if (err == cudaSuccess) err = cudaEventRecord(s.done, l.stream);
  s.n = l.n;
  return static_cast<int>(err);
}

int ctx_wait(void* c, int j, int* n_bad) {
  Ctx* x = static_cast<Ctx*>(c);
  Slot& s = x->slot[j];
  *n_bad = 0;
  cudaError_t err = cudaSetDevice(x->dev);
  if (err == cudaSuccess) err = cudaEventSynchronize(s.done);
  if (err != cudaSuccess) return static_cast<int>(err);
  for (int i = 0; i < s.n; i++) *n_bad += s.h_status[i] != Ok;
  return 0;
}

void free_ctx(Ctx* x) {
  for (Lane& l : x->lane) {
    cudaFreeHost(l.h_in);
    cudaFreeHost(l.h_meta);
    cudaFree(l.d_in);
    cudaFree(l.d_out);
    cudaFree(l.d_meta);
    cudaFree(l.d_status);
    if (l.stream) cudaStreamDestroy(l.stream);
    if (l.up) cudaEventDestroy(l.up);
  }
  for (Slot& s : x->slot) {
    cudaFreeHost(s.h_out);
    cudaFreeHost(s.h_status);
    if (s.done) cudaEventDestroy(s.done);
  }
  delete x;
}

}  // namespace

// Inflate n BGZF blocks on the current device, enqueued on `stream`: block
// i is the raw-deflate stream at src[meta[4i], + meta[4i+1]) and inflates
// to out[meta[4i+2], + meta[4i+3]); status[i] gets its status (0: exactly
// that many bytes). src is 4-byte aligned and src_bytes long; nothing is
// read past it.
extern "C" int cutesv_inflate_launch(const void* src, uint64_t src_bytes,
                                     const void* meta, int n, void* out,
                                     void* status, void* stream) {
  return launch(static_cast<const uint8_t*>(src), src_bytes,
                static_cast<const uint32_t*>(meta), n,
                static_cast<uint8_t*>(out), static_cast<int32_t*>(status),
                static_cast<cudaStream_t>(stream));
}

// The decoder's back end on device `dev`: its buffers, streams and events,
// and the table of functions over them (*table_out). Returns the first CUDA
// error (nothing is kept then). Made once per process and device; never
// freed. Pinned host memory: SLOTS x (HOST_GAP + OUT_CAP) + LANES x IN_CAP
// (107 MiB); device memory: LANES x (IN_CAP + OUT_CAP) (224 MiB).
extern "C" int cutesv_inflate_create(int dev, void** table_out) {
  *table_out = nullptr;
  Ctx* x = new (std::nothrow) Ctx();
  if (x == nullptr) return static_cast<int>(cudaErrorMemoryAllocation);
  x->dev = dev;
  cudaError_t err = cudaSetDevice(dev);
  for (Lane& l : x->lane) {
    if (err == cudaSuccess) err = cudaHostAlloc(&l.h_in, IN_CAP, 0);
    if (err == cudaSuccess)
      err = cudaHostAlloc(&l.h_meta, sizeof(uint32_t) * 4 * MAX_BLOCKS, 0);
    if (err == cudaSuccess) err = cudaMalloc(&l.d_in, IN_CAP);
    if (err == cudaSuccess) err = cudaMalloc(&l.d_out, OUT_CAP);
    if (err == cudaSuccess)
      err = cudaMalloc(&l.d_meta, sizeof(uint32_t) * 4 * MAX_BLOCKS);
    if (err == cudaSuccess)
      err = cudaMalloc(&l.d_status, sizeof(int32_t) * MAX_BLOCKS);
    if (err == cudaSuccess)
      err = cudaStreamCreateWithFlags(&l.stream, cudaStreamNonBlocking);
    if (err == cudaSuccess)
      err = cudaEventCreateWithFlags(&l.up, cudaEventDisableTiming);
  }
  for (Slot& s : x->slot) {
    if (err == cudaSuccess)
      err = cudaHostAlloc(&s.h_out, HOST_GAP + OUT_CAP, 0);
    if (err == cudaSuccess)
      err = cudaHostAlloc(&s.h_status, sizeof(int32_t) * MAX_BLOCKS, 0);
    if (err == cudaSuccess)
      err = cudaEventCreateWithFlags(&s.done, cudaEventDisableTiming);
  }
  if (err != cudaSuccess) {
    free_ctx(x);
    return static_cast<int>(err);
  }
  CardInflate& t = x->table;
  t.ctx = x;
  t.lanes = LANES;
  t.slots = SLOTS;
  t.max_blocks = MAX_BLOCKS;
  t.in_cap = IN_CAP;
  t.out_cap = OUT_CAP;
  t.gap = HOST_GAP;
  t.acquire = ctx_acquire;
  t.release = ctx_release;
  t.host_out = ctx_host_out;
  t.submit = ctx_submit;
  t.fetch = ctx_fetch;
  t.wait = ctx_wait;
  t.launched = ctx_launched;
  *table_out = &t;
  return 0;
}
