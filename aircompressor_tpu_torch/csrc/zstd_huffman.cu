// zstd Huffman literal streams for a whole batch of frames, one warp per
// stream.
//
// Replaces the TPU kernel aircompressor_tpu/ops/zstd_pallas.py::_huffman_kernel
// (kernel A of the zstd device decode) and computes what it computes. Each
// stream is described by one row of 32 int32 (byte_lo, rem, nsym, out_base,
// table_log, 0, 0, 0, rank_start[1..12], cum_syms[0..11]) and a 256-byte
// canonical permutation (host/zstd/device_prep.py). The stream is a backward
// bitstream over the original input from byte_lo: `rem` payload bits remain.
// For each of nsym symbols the top `table_log` bits are peeked, zero-padded
// below the stream's start near its end (take = min(rem, log), value <<
// (log - take)); the canonical walk picks the largest weight w whose region
// start rank_start[w] <= peek, the rank cum_syms[w-1] + ((peek -
// rank_start[w]) >> (w-1)) and the code length log + 1 - w; the byte is
// perm[rank] and rem drops by the code length. The stream's final rem goes
// out: 0 for a stream that was consumed exactly, positive for one with bits
// left after nsym symbols, negative for one read past its start.
//
// Design (the self-synchronising decode of Weissenberger and Schmidt,
// "Massively Parallel Huffman Decoding on GPUs", ICPP 2018):
// - the warp builds the stream's decode table in shared memory, 2^log
//   entries of (byte, code length), lane k filling peeks k, k + 32, ...;
//   a lane's peeks rise and the walk's weight only grows with the peek, so
//   it walks again only where a larger weight's region starts. A symbol
//   then costs a shift, a mask and one shared load.
// - the stream's bits are cut from the top into 32 sub-ranges of S bits (S
//   a multiple of 32 of at most kSubBits, so at least the longest code).
//   The warp stages the words those bits lie in into shared memory, 16
//   bytes a lane (byte by byte at the stream's first word and at the
//   input's end: no byte below byte_lo or at or past src_len is read); each
//   lane keeps a 64-bit window and the two words below it in registers.
// - lane k decodes from the top of its sub-range as if a code started
//   there, marks each code start in the top kMapBits of it in a bitmap in
//   shared memory (word j of lane k at j * 32 + k), counts those below,
//   and records where it left the sub-range. Then in rounds every lane
//   whose predecessor's exit is not where it started restarts there: a
//   marked start means the two decodes agree from there on; else it
//   decodes, re-marking, until it meets a mark (its exit and the count
//   below hold) or leaves the sub-range (a new exit and count). The words
//   it walks are held in registers and written once each. Lane 0 starts
//   right, so after round r lanes 0..r are right and the rounds end within
//   32. Real codes agree again within tens of codes of a sub-range's top,
//   so one round usually does it.
// - each lane's count is its bitmap's popcount and the count below it; a
//   warp scan places its symbols, and a second pass decodes them again,
//   bytes one at a time up to a 16-byte boundary of lit, then 16 a store
//   (unrolled, each byte in its register place), then one at a time: each
//   stream gets exactly nsym bytes from out_base; lit is zeroed by the
//   caller.
// - a stream of more than 32 sub-ranges of kSubBits goes by segments,
//   each starting at the previous one's exit. The lane that writes symbol
//   nsym - 1 reports the position after it. Past position 0 every peek is
//   0, so the symbols a stream lacks are table[0]'s: rem falls by its code
//   length for each.
// - a table of log 12 (past the 2^11 entries the table holds) or one whose
//   walk gives a code of no bits (as no planner gives) is walked by lane 0
//   alone, symbol by symbol, with nsym as its bound.
//
// What bounds it on this card: each lane is still a dependent chain, of
// about S / 8 table steps in each of two passes and the round's steps (a
// shared load and a dozen integer operations a step, ~100 ns at one wave).
// The bytes bound (the streams read once, the literals written once) is far
// below it. At thousands of streams the table, bitmaps and staged words
// (14,464 B a warp) cap the warps an SM holds at 15, so there the chains'
// latency, not the issue rate, sets the time. One warp a block, sub-ranges
// of up to 1536 bits (one segment for a stream of up to 49,152 bits) and
// the largest shared-memory carveout timed fastest at 4096 frames of the
// settings PERF.md lists.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kParamWords = 32;
constexpr int kRankStart = 8;  // rank_start[1..12] at words 8..19
constexpr int kCumSyms = 20;   // cum_syms[0..11] at words 20..31
constexpr int kMaxLog = 11;
constexpr int kTableBytes = 2 << kMaxLog;  // 2^11 uint16 entries: byte | length << 8
constexpr int kMapBits = 1024;             // the top of a sub-range each bitmap covers
constexpr int kMapWords = kMapBits / 32;
constexpr int kMapBytes = 32 * kMapBits / 8;
constexpr int kSubBits = 1536;             // the most bits of a lane's sub-range, a multiple of 32
constexpr int kBufPad = 32;                // words staged beyond a segment's bits (and 256 B at least)
constexpr int kSmemBytes = kTableBytes + kMapBytes + 4 * (kSubBits + kBufPad);
constexpr unsigned kFull = 0xffffffffu;
static_assert(kSubBits % 32 == 0 && kSmemBytes <= 48 * 1024, "static shared memory");

// A lane's view of one stream: a 64-bit window over bits [wb, wb + 64),
// counted from bit 0 of the aligned word w0 that holds the stream's first
// byte, and the two words below it, loaded ahead, all from the segment's
// words staged in shared memory (words i0 .. i0 + n - 1; others read as 0).
struct Reader {
  const uint32_t* buf;
  int i0, n, boff, wb;
  uint64_t win;
  uint32_t nxt, nxt2;

  __device__ __forceinline__ uint32_t word(int i) const {
    return static_cast<unsigned>(i - i0) < static_cast<unsigned>(n) ? buf[i - i0] : 0;
  }

  // Place the window for peeks from stream position p downward.
  __device__ __forceinline__ void seek(int p) {
    wb = (((p + boff - 1) >> 5) - 1) * 32;
    const int i = wb >> 5;
    win = static_cast<uint64_t>(word(i)) | static_cast<uint64_t>(word(i + 1)) << 32;
    nxt = word(i - 1);
    nxt2 = word(i - 2);
  }

  // The `log` bits below stream position p (p no higher than the last
  // peek's or seek's): one shift of the window at most.
  __device__ __forceinline__ uint32_t peek(int p, int log) {
    const int lo = p + boff - log;
    if (lo < wb) {
      win = win << 32 | nxt;
      nxt = nxt2;
      wb -= 32;
      nxt2 = word((wb >> 5) - 2);
    }
    return static_cast<uint32_t>(win >> (lo - wb)) & ((1u << log) - 1);
  }
};

// Stage input words i0 .. i0 + n - 1 (counted from the aligned word w0;
// w0 + i0 a multiple of 4) into `buf`, 16 bytes a lane a step; bytes below
// the stream's first byte (lo_addr) or at or past the input's end read as 0.
__device__ __forceinline__ void stage(uint32_t* buf, long long w0, int i0, int n,
                                      long long lo_addr, long long end_addr, int lane) {
  for (int c = lane; 4 * c < n; c += 32) {
    const long long a = 4 * (w0 + i0 + 4 * c);
    uint4 v;
    if (a >= lo_addr && a + 16 <= end_addr) {
      v = __ldg(reinterpret_cast<const uint4*>(a));
    } else {
      uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
      for (int k = 0; k < 16; ++k)
        if (a + k >= lo_addr && a + k < end_addr)
          w[k >> 2] |= static_cast<uint32_t>(*reinterpret_cast<const uint8_t*>(a + k)) << (8 * (k & 3));
      v = make_uint4(w[0], w[1], w[2], w[3]);
    }
    reinterpret_cast<uint4*>(buf)[c] = v;
  }
  __syncwarp();
}

// Lane 0 alone: the canonical walk, symbol by symbol, reading each peek as
// the plain version does (3 bytes from the peek's lowest bit; none once the
// walk is past the stream's start).
__device__ void walk_stream(const uint8_t* src, long long src_len, long long byte_lo,
                            int rem, int nsym, int log, const int* rs, const int* cum,
                            const uint8_t* pm, uint8_t* out, int32_t* rem_out) {
  for (int i = 0; i < nsym; ++i) {
    const int take = min(max(rem, 0), log);
    const int lo = rem - take;
    uint64_t v = 0;
    for (int k = 0; take > 0 && k < 3; ++k) {
      const long long idx = byte_lo + (lo >> 3) + k;
      if (idx < src_len) v |= static_cast<uint64_t>(src[idx]) << (8 * k);
    }
    const long long st = static_cast<long long>(((v >> (lo & 7)) & ((1ull << take) - 1)) << (log - take));
    int rank = 0, nb = 0;
#pragma unroll
    for (int w = 0; w < 12; ++w) {  // weight w + 1
      if (st >= rs[w]) {
        rank = cum[w] + static_cast<int>((st - rs[w]) >> w);
        nb = log - w;
      }
    }
    out[i] = __ldg(pm + (rank & 255));
    rem -= nb;
  }
  *rem_out = rem;
}

__global__ void huffman_kernel(const uint8_t* __restrict__ src, long long src_len,
                               const int32_t* __restrict__ params,
                               const uint8_t* __restrict__ perm, int n_streams,
                               uint8_t* __restrict__ lit, int32_t* __restrict__ rem_out) {
  __shared__ uint4 smem[kSmemBytes / 16];
  const int lane = threadIdx.x;
  const int h = blockIdx.x;
  uint8_t* base = reinterpret_cast<uint8_t*>(smem);
  uint16_t* table = reinterpret_cast<uint16_t*>(base);
  uint32_t* map = reinterpret_cast<uint32_t*>(base + kTableBytes) + lane;
  uint32_t* buf = reinterpret_cast<uint32_t*>(base + kTableBytes + kMapBytes);

  const int pw = params[static_cast<size_t>(h) * kParamWords + lane];
  const long long byte_lo = __shfl_sync(kFull, pw, 0);
  const int rem = __shfl_sync(kFull, pw, 1);
  const int nsym = __shfl_sync(kFull, pw, 2);
  uint8_t* slot = lit + static_cast<long long>(__shfl_sync(kFull, pw, 3));
  const int mis = static_cast<int>(reinterpret_cast<uintptr_t>(slot) & 15);
  uint8_t* out = slot - mis;  // aligned: the slot's bytes from out + mis
  const int log = __shfl_sync(kFull, pw, 4);
  int rs[12], cum[12];
#pragma unroll
  for (int w = 0; w < 12; ++w) {
    rs[w] = __shfl_sync(kFull, pw, kRankStart + w);
    cum[w] = __shfl_sync(kFull, pw, kCumSyms + w);
  }
  const uint8_t* pm = perm + static_cast<size_t>(h) * 256;
  if (nsym <= 0) {
    if (lane == 0) rem_out[h] = rem;
    return;
  }

  // The decode table, from the permutation staged in `buf`.
  bool regular = log >= 1 && log <= kMaxLog;
  if (regular) {
    uint8_t* spm = reinterpret_cast<uint8_t*>(buf);
#pragma unroll
    for (int k = 0; k < 8; ++k) spm[lane * 8 + k] = __ldg(pm + lane * 8 + k);
    __syncwarp();
    // A lane's peeks rise, and the walk's weight (the largest w with
    // rs[w] <= peek) only grows with the peek: walk again only where a
    // larger weight's region starts.
    bool bad = false;
    int ws = -1, rs_w = 0, cum_w = 0, next = 0;
    for (int st = lane; st < (1 << log); st += 32) {
      if (st >= next) {
        ws = -1;
        next = INT_MAX;
#pragma unroll
        for (int w = 0; w < 12; ++w) {
          if (st >= rs[w]) {
            ws = w;
            rs_w = rs[w];
            cum_w = cum[w];
          }
        }
#pragma unroll
        for (int w = 0; w < 12; ++w)
          if (w > ws) next = min(next, rs[w]);
      }
      const int rank = ws >= 0 ? cum_w + ((st - rs_w) >> ws) : 0;
      const int nb = ws >= 0 ? log - ws : 0;
      bad |= nb < 1;
      table[st] = static_cast<uint16_t>(spm[rank & 255] | (nb & 0xff) << 8);
    }
    regular = !__any_sync(kFull, bad);
    __syncwarp();
  }
  if (!regular) {
    if (lane == 0) walk_stream(src, src_len, byte_lo, rem, nsym, log, rs, cum, pm, slot, rem_out + h);
    return;
  }

  const long long lo_addr = reinterpret_cast<long long>(src) + byte_lo;
  const long long end_addr = reinterpret_cast<long long>(src) + src_len;
  Reader rd;
  rd.buf = buf;
  rd.boff = static_cast<int>(lo_addr & 3) * 8;
  const long long w0 = lo_addr >> 2;
  int seg_hi = rem, seg_base = 0;
  while (seg_hi > 0 && seg_base < nsym) {
    const int S = min(kSubBits, (seg_hi + 1023) / 1024 * 32);
    const int hi = seg_hi - lane * S, lo = max(hi - S, 0);
    const bool active = hi > 0;
    const int last = min((seg_hi + S - 1) / S, 32) - 1;  // the last active lane

    // Stage the words the segment's peeks read: bits from one word below
    // its lowest sub-range to its top.
    const int seg_lo = max(seg_hi - 32 * S, 0);
    rd.i0 = static_cast<int>(((w0 + ((seg_lo + rd.boff - 32) >> 5)) & ~3LL) - w0);
    const int top = ((seg_hi + rd.boff - 1) >> 5) + 1;
    rd.n = (top - rd.i0 + 3) & ~3;
    stage(buf, w0, rd.i0, rd.n, lo_addr, end_addr, lane);

    // The speculative pass: from the top of the sub-range, as if a code
    // started there; codes below the bitmap's reach are counted.
    int exit = hi, below = 0;
    if (active) {
      rd.seek(hi);
      int p = hi, cj = 0;
      uint32_t cur = 0;
      while (p > lo) {
        const int b = hi - p;
        const bool in = b < kMapBits;
        const int jb = b >> 5;
        cur = (jb != cj ? 0u : cur) | 1u << (b & 31);
        cj = in ? jb : cj;
        if (in) map[jb * 32] = cur;  // each step, so no branch: the last store holds
        below += !in;
        p -= table[rd.peek(p, log)] >> 8;
      }
      for (int j = cj + 1; j < kMapWords; ++j) map[j * 32] = 0;
      exit = p;
    }

    // Rounds: restart from the predecessor's exit until no exit changes.
    int start = hi;
    for (;;) {
      int pred = __shfl_up_sync(kFull, exit, 1);
      if (lane == 0) pred = seg_hi;
      const bool need = active && pred != start;
      if (!__any_sync(kFull, need)) break;
      if (need) {
        start = pred;
        // Drop the marks above pred; a mark at pred means the decodes agree.
        // Else walk from pred, keeping the word being walked (old) and the
        // next (nold) in registers: each word left behind is written once,
        // with the new marks (cur) only.
        const int d = hi - pred;  // below the longest code: in word 0
        uint32_t old = map[0] & ~((1u << d) - 1);
        if ((old >> d) & 1) {
          map[0] = old;
        } else {
          rd.seek(pred);
          uint32_t cur = 0, nold = map[32];
          int cj = 0, fresh = 0;
          for (int p = pred;;) {
            const int q = p - (table[rd.peek(p, log)] >> 8);
            const int b = hi - p, b2 = hi - q;
            if (b < kMapBits) cur |= 1u << (b & 31);
            else ++fresh;
            if ((b2 >> 5) != cj && cj < kMapWords) {  // into the next word
              map[cj * 32] = cur;
              cur = 0;
              old = nold;
              ++cj;
              if (cj + 1 < kMapWords) nold = map[(cj + 1) * 32];
            }
            const uint32_t kept = cj < kMapWords ? old & ~((1u << (b2 & 31)) - 1) : 0;
            if (q <= lo) {
              if (cj < kMapWords) map[cj * 32] = cur | kept;
              exit = q;
              below = fresh;
              break;
            }
            if (b2 < kMapBits && (kept & 1u << (b2 & 31))) {
              map[cj * 32] = cur | kept;
              break;
            }
            p = q;
          }
        }
      }
    }

    // Counts, their scan, and the second pass that writes the symbols.
    int cnt = 0;
    if (active) {
      cnt = below;
#pragma unroll
      for (int j = 0; j < kMapWords; ++j) cnt += __popc(map[j * 32]);
    }
    int incl = cnt;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += v;
    }
    const int first = seg_base + incl - cnt;
    if (active && first < nsym) {
      // Bytes one at a time up to a 16-byte boundary of lit, then 16 at a
      // time (unrolled, each byte in its place), then the rest one at a time.
      const int n = min(cnt, nsym - first);
      rd.seek(start);
      int p = start, o = mis + first, j = 0;
      for (; j < n && (o & 15); ++j, ++o) {
        const uint32_t e = table[rd.peek(p, log)];
        out[o] = static_cast<uint8_t>(e);
        p -= e >> 8;
      }
      for (; j + 16 <= n; j += 16, o += 16) {
        uint32_t w4[4] = {0, 0, 0, 0};
#pragma unroll
        for (int t = 0; t < 16; ++t) {
          const uint32_t e = table[rd.peek(p, log)];
          w4[t >> 2] |= (e & 0xff) << (8 * (t & 3));
          p -= e >> 8;
        }
        *reinterpret_cast<uint4*>(out + o) = make_uint4(w4[0], w4[1], w4[2], w4[3]);
      }
      for (; j < n; ++j, ++o) {
        const uint32_t e = table[rd.peek(p, log)];
        out[o] = static_cast<uint8_t>(e);
        p -= e >> 8;
      }
      if (first + n == nsym) rem_out[h] = p;  // this lane wrote symbol nsym - 1
    }
    seg_base += __shfl_sync(kFull, incl, 31);
    seg_hi = __shfl_sync(kFull, exit, last);
    __syncwarp();  // the next segment's words replace these
  }

  if (seg_base < nsym) {  // the symbols past position 0: table[0]'s
    const uint32_t e = table[0], sym = e & 0xff;
    if (lane == 0) rem_out[h] = seg_hi - (nsym - seg_base) * static_cast<int>(e >> 8);
    const int a = mis + seg_base, b = mis + nsym;
    const int a16 = min((a + 15) & ~15, b), b16 = max(b & ~15, a16);
    for (int i = a + lane; i < a16; i += 32) out[i] = static_cast<uint8_t>(sym);
    const uint32_t rep = sym * 0x01010101u;
    for (int c = a16 + 16 * lane; c < b16; c += 512)
      *reinterpret_cast<uint4*>(out + c) = make_uint4(rep, rep, rep, rep);
    for (int i = b16 + lane; i < b; i += 32) out[i] = static_cast<uint8_t>(sym);
  }
}

}  // namespace

// Launches the decode on `stream`, one warp a stream, and returns
// cudaGetLastError() (or the error of the carveout's setting, made on every
// call: it holds for the current device only). The caller allocates lit
// (zeroed, 16-byte aligned) and rem_out (n_streams,) int32.
extern "C" int acx_zstd_huffman(const void* src, long long src_len,
                                const void* params, const void* perm,
                                int n_streams, void* lit, void* rem_out, void* stream) {
  if (n_streams > 0) {
    const cudaError_t err = cudaFuncSetAttribute(
        huffman_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
        cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return static_cast<int>(err);
    huffman_kernel<<<n_streams, 32, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(src), src_len,
        static_cast<const int32_t*>(params), static_cast<const uint8_t*>(perm),
        n_streams, static_cast<uint8_t*>(lit), static_cast<int32_t*>(rem_out));
  }
  return static_cast<int>(cudaGetLastError());
}
