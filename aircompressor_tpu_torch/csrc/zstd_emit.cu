// zstd entropy emission for a batch of planned blocks: four Huffman literal
// streams and one FSE sequences bitstream a block, one block of five warps
// per planned block.
//
// Replaces aircompressor_tpu/ops/zstd_encode_jax.py::_emit_device with its
// bit packer _pack_bits (XLA there, not Pallas: a per-symbol gather and a
// serial three-state walk, which in tensor ops is a loop of thousands of
// dependent steps) and writes what it writes, byte for byte: for each row,
// four streams of (4, 24576) bytes and their bit totals, and one sequences
// stream of 98304 bytes and its bit total, zero past each stream's last byte.
// A stream packs its ops least significant bit first, each value masked to
// its width (widths are clamped to [0, 31]; the packer gives none outside),
// then one end-mark bit. Huffman stream s takes the literals of its segment
// [start, start + count) in reverse order, code and length from the row's
// table. The sequences stream, in writer order: the extra bits of the last
// sequence (LL, ML, OF); for i = nseq - 2 down to 0, the OF, ML and LL state
// bits, then the LL, ML and OF extra bits of sequence i; then the final ML,
// OF and LL states at their table logs. A state starts at ns[((nb0 << 16) -
// d) >> nb0 + f] with nb0 = (d + 2^15) >> 16 for the last sequence's code; a
// step writes the state at nb = (st + d) >> 16 bits and moves to
// ns[(st >> nb) + f], every table index clamped as the JAX function clamps
// it. A row with nseq = 0 writes no sequence bits but the end mark.
//
// Design: packing by prefix sums of the widths, as the plain version packs.
// - Warp s < 4 writes Huffman stream s by rounds of 256 symbols, 8 a lane:
//   each lane reads its literals (the next round's loaded ahead) and their
//   codes and lengths from the shared table, a warp scan of its 8 lengths
//   gives its bit offset, and it ORs each code into a ring of 256 words in
//   shared memory (a code of <= 31 bits spans at most two words). Words
//   below the round's end are then whole: the warp stores them, one word a
//   lane, and clears them.
// - Warp 4 writes the sequences stream by windows of 128 groups: the head,
//   one group a sequence (six fields), the flush. The warp stages each
//   window's table entries and extra bits in shared memory; lanes 0-2 walk
//   the LL, ML and OF states through it in writer order (each chain is
//   independent of the bits written and of the others; each step's table
//   entries are loaded a step ahead), leaving each state and its width;
//   then the warp packs the window as the Huffman warps do, 32 groups a
//   round. The states carry from one window to the next.
// - A word at or past a stream's capacity is dropped and the bit total
//   still counts it, so the caller sees an overflow (none is possible for a
//   planned block of 64 KB: 16384 symbols of at most 11 bits, 8192
//   sequences of at most 76 bits). Then all five warps zero the streams
//   past their last word, 16 bytes a store. (Zeroing the streams first, so
//   that the stores drain while the warps pack, timed slower.)
//
// What bounds it on this card: at one wave (a few hundred rows) the chains
// of rounds (a scan, the ORs and a flush each; 20 rounds for a segment of
// 5,000 literals) and of the FSE walk (~300 steps of one dependent shared
// load and a few integer operations). Each row also writes 192 KB, the
// zero tails included: that is the bytes bound, and at thousands of rows
// most of the time, with the packing that the tails' stores do not hide
// on top of it.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLitCap = 65536;
constexpr int kSegCap = kLitCap / 4;
constexpr int kLStreamCap = 24576;
constexpr int kSCap = 8192;
constexpr int kSStreamCap = 98304;
constexpr int kNsCap = 512;
constexpr int kSymCap = 64;
constexpr int kWindow = 128;   // groups a window of the sequences stream
constexpr int kPerLane = 8;    // Huffman symbols a lane a round
constexpr int kLRing = 256;    // words of a Huffman stream's ring: a round's 256 codes
                               // of <= 31 bits and the partial word before them
constexpr int kSRing = 512;    // words of the sequences stream's ring
constexpr int kWarps = 5;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return min(max(v, lo), hi); }

// One stream's packing by a warp: `pos` bits so far, words below `flushed`
// stored. Each round, every lane ORs its values into the ring at offsets
// from a warp scan of its widths; then the whole words go out.
struct Packer {
  uint32_t* ring;
  int mask;           // ring words - 1
  uint32_t* dst;      // the stream in device memory
  int cap_words;
  int pos = 0, flushed = 0;

  __device__ Packer(uint32_t* r, int words, uint8_t* d, int cap)
      : ring(r), mask(words - 1), dst(reinterpret_cast<uint32_t*>(d)), cap_words(cap / 4) {}

  __device__ __forceinline__ void put(int off, uint32_t v, int nb) {
    if (nb == 0) return;
    const uint64_t x = static_cast<uint64_t>(v & ((1u << nb) - 1)) << (off & 31);
    atomicOr(&ring[(off >> 5) & mask], static_cast<uint32_t>(x));
    if ((off & 31) + nb > 32) atomicOr(&ring[((off >> 5) + 1) & mask], static_cast<uint32_t>(x >> 32));
  }

  // The lane's bit offset for `bits` of its own, in lane order; moves pos
  // past the whole round.
  __device__ __forceinline__ int claim(int bits, int lane) {
    int incl = bits;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += v;
    }
    const int off = pos + incl - bits;
    pos += __shfl_sync(kFull, incl, 31);
    return off;
  }

  // Store and clear the words below `upto`.
  __device__ __forceinline__ void flush(int upto, int lane) {
    __syncwarp();
    for (int w = flushed + lane; w < upto; w += 32) {
      uint32_t* r = &ring[w & mask];
      if (w < cap_words) dst[w] = *r;
      *r = 0;
    }
    flushed = upto;
    __syncwarp();
  }

  // The end mark, the last words; returns the bytes written (capped).
  __device__ __forceinline__ int finish(int lane) {
    if (lane == 0) ring[(pos >> 5) & mask] |= 1u << (pos & 31);
    flush((pos >> 5) + 1, lane);
    return min(4 * flushed, 4 * cap_words);
  }
};

__global__ void __launch_bounds__(32 * kWarps)
zstd_emit_kernel(const uint8_t* __restrict__ lit, const int32_t* __restrict__ lit_seg,
                 const int32_t* __restrict__ huff, const int32_t* __restrict__ seq,
                 const int32_t* __restrict__ nseq_in, const int32_t* __restrict__ fse_sym,
                 const int32_t* __restrict__ fse_ns, const int32_t* __restrict__ flush_bits,
                 uint8_t* __restrict__ lit_bytes, int32_t* __restrict__ lit_tot,
                 uint8_t* __restrict__ seq_bytes, int32_t* __restrict__ seq_tot) {
  __shared__ int32_t s_huff[2 * 256];          // codes, then bit counts
  __shared__ int32_t s_sym[3 * 2 * kSymCap];   // LL, ML, OF: delta_nb_bits, delta_find_state
  __shared__ int32_t s_ns[3 * kNsCap];         // LL, ML, OF: next_state
  __shared__ uint32_t s_lring[4][kLRing];
  __shared__ uint32_t s_sring[kSRing];
  // A window of the sequences stream, by field (LL, ML, OF) and group: the
  // table entries of its code, the state and its width, the extra bits and
  // their width.
  __shared__ int32_t s_d[3][kWindow], s_f[3][kWindow], s_st[3][kWindow], s_nb[3][kWindow];
  __shared__ int32_t s_xv[3][kWindow], s_xb[3][kWindow];
  __shared__ int s_end[5];                     // each stream's bytes written, capped
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t row = blockIdx.x;

  // The tables, their loads unrolled so that they are in flight together.
  constexpr int kThreads = 32 * kWarps;
#pragma unroll
  for (int it = 0; it < (2 * 256 + kThreads - 1) / kThreads; ++it) {
    const int i = threadIdx.x + it * kThreads;
    if (i < 2 * 256) s_huff[i] = huff[row * 2 * 256 + i];
  }
#pragma unroll
  for (int it = 0; it < (3 * 2 * kSymCap + kThreads - 1) / kThreads; ++it) {
    const int i = threadIdx.x + it * kThreads;
    if (i < 3 * 2 * kSymCap) s_sym[i] = fse_sym[row * 3 * 2 * kSymCap + i];
  }
#pragma unroll
  for (int it = 0; it < (3 * kNsCap + kThreads - 1) / kThreads; ++it) {
    const int i = threadIdx.x + it * kThreads;
    if (i < 3 * kNsCap) s_ns[i] = fse_ns[row * 3 * kNsCap + i];
  }
  for (int i = threadIdx.x; i < 4 * kLRing; i += 32 * kWarps) (&s_lring[0][0])[i] = 0;
  for (int i = threadIdx.x; i < kSRing; i += 32 * kWarps) s_sring[i] = 0;
  __syncthreads();

  if (warp < 4) {
    Packer pk(s_lring[warp], kLRing, lit_bytes + (row * 4 + warp) * kLStreamCap, kLStreamCap);
    const uint8_t* lrow = lit + row * kLitCap;
    const int start = lit_seg[(row * 4 + warp) * 2];
    const int cnt = lit_seg[(row * 4 + warp) * 2 + 1];
    const int steps = clampi(cnt, 0, kSegCap);
    // symbol j of the stream is literal start + cnt - 1 - j, clamped to the row
    auto load = [&](int r0, uint32_t* sym) {
#pragma unroll
      for (int t = 0; t < kPerLane; ++t) {
        const int j = r0 + kPerLane * lane + t;
        sym[t] = j < steps ? lrow[clampi(start + cnt - 1 - j, 0, kLitCap - 1)] : 256;
      }
    };
    // One round: kPerLane symbols a lane, their codes at offsets from a scan
    // of their lengths. Two sets of symbols alternate, each loaded a round
    // ahead.
    auto round = [&](const uint32_t* sym) {
      int nb[kPerLane], bits = 0;
      uint32_t code[kPerLane];
#pragma unroll
      for (int t = 0; t < kPerLane; ++t) {
        const bool on = sym[t] < 256;
        code[t] = on ? static_cast<uint32_t>(s_huff[sym[t]]) : 0;
        nb[t] = on ? clampi(s_huff[256 + sym[t]], 0, 31) : 0;
        bits += nb[t];
      }
      int off = pk.claim(bits, lane);
#pragma unroll
      for (int t = 0; t < kPerLane; ++t) {
        pk.put(off, code[t], nb[t]);
        off += nb[t];
      }
      pk.flush(pk.pos >> 5, lane);
    };
    constexpr int kRound = 32 * kPerLane;
    uint32_t a[kPerLane], b[kPerLane];
    load(0, a);
    load(kRound, b);
    for (int r0 = 0; r0 < steps; r0 += 2 * kRound) {
      round(a);
      load(r0 + 2 * kRound, a);
      if (r0 + kRound >= steps) break;
      round(b);
      load(r0 + 3 * kRound, b);
    }
    s_end[warp] = pk.finish(lane);
    if (lane == 0) lit_tot[row * 4 + warp] = pk.pos;
  } else {
    Packer pk(s_sring, kSRing, seq_bytes + row * kSStreamCap, kSStreamCap);
    const int32_t* fields = seq + row * 9 * kSCap;  // ll, ml, of codes; extras; extra bits
    const int nseq = clampi(nseq_in[row], 0, kSCap);
    const int last = max(nseq - 1, 0);
    int st = 0;  // lane f < 3: the state of field f (LL, ML, OF)
    if (lane < 3) {
      const int c = clampi(fields[lane * kSCap + last], 0, kSymCap - 1);
      const int d = s_sym[(lane * 2) * kSymCap + c];
      const int fs = s_sym[(lane * 2 + 1) * kSymCap + c];
      const int nb = clampi((d + (1 << 15)) >> 16, 0, 31);
      const int sub = ((nb << 16) - d) >> nb;
      st = s_ns[lane * kNsCap + clampi(sub + fs, 0, kNsCap - 1)];
    }
    // groups: 0 the head, g in [1, last] sequence last - g, last + 1 the flush
    const int groups = nseq > 0 ? last + 2 : 0;
    for (int w0 = 0; w0 < groups; w0 += kWindow) {
#pragma unroll
      for (int it = 0; it < 3 * kWindow / 32; ++it) {  // unrolled: the loads go together
        const int i = lane + 32 * it;
        const int f = i / kWindow, k = i % kWindow, g = w0 + k;
        const int s = g == 0 ? last : last - g;  // the head's extras are the last sequence's
        if (g >= 1 && g <= last) {
          const int c = clampi(fields[f * kSCap + s], 0, kSymCap - 1);
          s_d[f][k] = s_sym[(f * 2) * kSymCap + c];
          s_f[f][k] = s_sym[(f * 2 + 1) * kSymCap + c];
        }
        if (g <= last) {
          s_xv[f][k] = fields[(3 + f) * kSCap + s];
          s_xb[f][k] = clampi(fields[(6 + f) * kSCap + s], 0, 31);
        }
      }
      __syncwarp();
      if (lane < 3) {
        const int f = lane;
        const int k_end = min(last + 1 - w0, kWindow);
        int k = max(1 - w0, 0);
        int d = s_d[f][k], fs = s_f[f][k];  // this step's entries; the next's loaded ahead
        for (; k < k_end; ++k) {
          const int d1 = s_d[f][min(k + 1, kWindow - 1)], fs1 = s_f[f][min(k + 1, kWindow - 1)];
          const int nb = clampi((st + d) >> 16, 0, 31);
          s_st[f][k] = st;
          s_nb[f][k] = nb;
          st = s_ns[f * kNsCap + clampi((st >> nb) + fs, 0, kNsCap - 1)];
          d = d1;
          fs = fs1;
        }
        if (last + 1 - w0 < kWindow) s_st[f][last + 1 - w0] = st;  // the flush
      }
      __syncwarp();
      for (int k0 = 0; k0 < kWindow && w0 + k0 < groups; k0 += 32) {
        const int k = k0 + lane, g = w0 + k;
        uint32_t v[6] = {0, 0, 0, 0, 0, 0};
        int nb[6] = {0, 0, 0, 0, 0, 0};
        if (g == 0) {  // LL, ML, OF extras of the last sequence
#pragma unroll
          for (int f = 0; f < 3; ++f) v[f] = s_xv[f][k], nb[f] = s_xb[f][k];
        } else if (g <= last) {  // OF, ML, LL states; LL, ML, OF extras
#pragma unroll
          for (int f = 0; f < 3; ++f) {
            v[2 - f] = s_st[f][k], nb[2 - f] = s_nb[f][k];
            v[3 + f] = s_xv[f][k], nb[3 + f] = s_xb[f][k];
          }
        } else if (g == last + 1) {  // the final ML, OF, LL states at the flush widths
          const int32_t* fb = flush_bits + row * 3;
          v[0] = s_st[1][k], nb[0] = clampi(fb[0], 0, 31);
          v[1] = s_st[2][k], nb[1] = clampi(fb[1], 0, 31);
          v[2] = s_st[0][k], nb[2] = clampi(fb[2], 0, 31);
        }
        int bits = 0;
#pragma unroll
        for (int t = 0; t < 6; ++t) bits += nb[t];
        int off = pk.claim(bits, lane);
#pragma unroll
        for (int t = 0; t < 6; ++t) {
          pk.put(off, v[t], nb[t]);
          off += nb[t];
        }
        pk.flush(pk.pos >> 5, lane);
      }
    }
    s_end[4] = pk.finish(lane);
    if (lane == 0) seq_tot[row] = pk.pos;
  }
  __syncthreads();

  // Zero each stream past its last word: words up to a 16-byte boundary,
  // then 16 bytes a thread.
  for (int s = 0; s < 5; ++s) {
    uint8_t* dst = s < 4 ? lit_bytes + (row * 4 + s) * kLStreamCap : seq_bytes + row * kSStreamCap;
    const int cap = s < 4 ? kLStreamCap : kSStreamCap;
    const int end = s_end[s];
    const int aligned = min((end + 15) & ~15, cap);
    uint32_t* dst32 = reinterpret_cast<uint32_t*>(dst);
    for (int j = end / 4 + threadIdx.x; j < aligned / 4; j += 32 * kWarps) dst32[j] = 0;
    uint4* dst4 = reinterpret_cast<uint4*>(dst);
    for (int j = aligned / 16 + threadIdx.x; j < cap / 16; j += 32 * kWarps)
      dst4[j] = make_uint4(0, 0, 0, 0);
  }
}

}  // namespace

// Launches the emission on `stream` and returns cudaGetLastError(). The
// inputs are contiguous: lit (batch, 65536) uint8, lit_seg (batch, 4, 2),
// huff (batch, 2, 256), seq (batch, 9, 8192), nseq (batch,), fse_sym (batch,
// 3, 2, 64), fse_ns (batch, 3, 512), flush_bits (batch, 3), all int32. The
// caller allocates the outputs: lit_bytes (batch, 4, 24576) uint8, lit_tot
// (batch, 4) int32, seq_bytes (batch, 98304) uint8, seq_tot (batch,) int32.
extern "C" int acx_zstd_emit(const void* lit, const void* lit_seg, const void* huff,
                             const void* seq, const void* nseq, const void* fse_sym,
                             const void* fse_ns, const void* flush_bits, int batch,
                             void* lit_bytes, void* lit_tot, void* seq_bytes,
                             void* seq_tot, void* stream) {
  if (batch > 0) {
    zstd_emit_kernel<<<batch, 32 * kWarps, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(lit), static_cast<const int32_t*>(lit_seg),
        static_cast<const int32_t*>(huff), static_cast<const int32_t*>(seq),
        static_cast<const int32_t*>(nseq), static_cast<const int32_t*>(fse_sym),
        static_cast<const int32_t*>(fse_ns), static_cast<const int32_t*>(flush_bits),
        static_cast<uint8_t*>(lit_bytes), static_cast<int32_t*>(lit_tot),
        static_cast<uint8_t*>(seq_bytes), static_cast<int32_t*>(seq_tot));
  }
  return static_cast<int>(cudaGetLastError());
}
