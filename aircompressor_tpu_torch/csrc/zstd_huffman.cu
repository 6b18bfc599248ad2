// zstd Huffman literal streams for a whole batch of frames, one thread per
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
// out: 0 for a stream that was consumed exactly, negative for one read past
// its start.
//
// Design: a 64-bit window of the stream, refilled with 8 byte loads when the
// next peek falls below it; one refill serves at least 3 symbols (45 bits).
// The walk is 12 compares, unrolled, with rank_start and cum_syms in
// registers. Decoded bytes are staged in a 64-bit register and stored 8 at
// a time: out_base is a multiple of 8 and a stream's slot is rounded up to
// 128 bytes by the planner, so the last word stays inside it.
//
// What bounds it on this card: each symbol's peek depends on the bits the
// symbol before it consumed, so one stream is a serial chain of about 40
// dependent instructions per symbol. The bytes bound (the streams read once,
// the literals written once) is far below that chain: a batch of 4096 frames
// of 64 KB holds about 16,000 streams, some 130 threads on each SM, so the
// card runs latency bound. Left for later: a decode table in shared memory
// (one lookup instead of the walk) and several symbols per peek.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;
constexpr int kParamWords = 32;
constexpr int kRankStart = 8;  // rank_start[1..12] at words 8..19
constexpr int kCumSyms = 20;   // cum_syms[0..11] at words 20..31

// 64 bits of the stream from bit `base` (a multiple of 8, may be negative):
// bytes below the stream's first byte, or past the buffer, read as 0.
__device__ __forceinline__ uint64_t load_window(const uint8_t* __restrict__ src,
                                                long long src_len,
                                                long long byte_lo, int base) {
  uint64_t w = 0;
  const int b0 = base >> 3;  // exact: base is a multiple of 8
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const long long idx = byte_lo + b0 + k;
    if (b0 + k >= 0 && idx < src_len)
      w |= static_cast<uint64_t>(__ldg(src + idx)) << (8 * k);
  }
  return w;
}

__global__ void __launch_bounds__(kThreads)
huffman_kernel(const uint8_t* __restrict__ src, long long src_len,
               const int32_t* __restrict__ params,
               const uint8_t* __restrict__ perm, int n_streams,
               uint8_t* __restrict__ lit, int32_t* __restrict__ rem_out) {
  const int h = blockIdx.x * kThreads + threadIdx.x;
  if (h >= n_streams) return;
  const int32_t* p = params + static_cast<size_t>(h) * kParamWords;
  const long long byte_lo = p[0];
  int rem = p[1];
  const int nsym = p[2];
  const long long out_base = p[3];
  const int log = p[4];
  int rs[12], cum[12];
#pragma unroll
  for (int w = 0; w < 12; ++w) {
    rs[w] = p[kRankStart + w];
    cum[w] = p[kCumSyms + w];
  }
  const uint8_t* pm = perm + static_cast<size_t>(h) * 256;
  uint64_t* out = reinterpret_cast<uint64_t*>(lit + out_base);

  int base = INT_MAX;
  uint64_t win = 0;
  uint64_t staged = 0;
  for (int i = 0; i < nsym; ++i) {
    const int take = min(max(rem, 0), log);
    const int lo = rem - take;
    uint32_t v = 0;
    if (take > 0) {
      if (lo < base) {  // the window [base, base + 64) must hold [lo, rem)
        base = ((rem - 57) >> 3) << 3;
        win = load_window(src, src_len, byte_lo, base);
      }
      v = static_cast<uint32_t>(win >> (lo - base)) & ((1u << take) - 1);
    }
    const int st = static_cast<int>(v << (log - take));
    int rank = 0, nb = 0;
#pragma unroll
    for (int w = 0; w < 12; ++w) {  // weight w + 1
      if (st >= rs[w]) {
        rank = cum[w] + ((st - rs[w]) >> w);
        nb = log - w;
      }
    }
    rem -= nb;
    staged |= static_cast<uint64_t>(__ldg(pm + (rank & 255))) << (8 * (i & 7));
    if ((i & 7) == 7) {
      out[i >> 3] = staged;
      staged = 0;
    }
  }
  if (nsym & 7) out[nsym >> 3] = staged;
  rem_out[h] = rem;
}

}  // namespace

// Launches the decode on `stream` and returns cudaGetLastError(). The caller
// allocates lit (zeroed, each stream's slot rounded up to 8 bytes inside it)
// and rem_out (n_streams,) int32.
extern "C" int acx_zstd_huffman(const void* src, long long src_len,
                                const void* params, const void* perm,
                                int n_streams, void* lit, void* rem_out,
                                void* stream) {
  if (n_streams > 0) {
    const int blocks = (n_streams + kThreads - 1) / kThreads;
    huffman_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(src), src_len,
        static_cast<const int32_t*>(params), static_cast<const uint8_t*>(perm),
        n_streams, static_cast<uint8_t*>(lit), static_cast<int32_t*>(rem_out));
  }
  return static_cast<int>(cudaGetLastError());
}
