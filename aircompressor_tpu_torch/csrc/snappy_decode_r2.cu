// Snappy block decode, the r2 design, for a batch of chunks of at most 64 KB:
// one warp per chunk, one output window of at most 128 bytes an iteration.
//
// Replaces the TPU kernel aircompressor_tpu/ops/snappy_pallas8.py::_decode_kernel
// and keeps its contract and its loop: a (B, cap) uint8 batch with (B,) int32
// compressed lengths gives (B, out_cap) bytes, (B,) int32 output lengths and
// (B,) ok flags, with the validation of csrc/snappy_decode.cu (a 4-byte copy
// offset with a nonzero high byte fails). Each iteration of a chunk's loop
// parses a token when the one before is done, then emits one window:
// take = min(rem, 128 - (op & 127)) bytes, and for a copy at most dist; a
// copy window of exactly dist bytes doubles dist (capped at 64 KB), since
// the bytes just written repeat the pattern. A token that fails its parse
// ends the chunk and costs its iteration. As in the TPU kernel, the varint
// length is a signed 32-bit value: a length with bit 31 set passes the first
// check and fails at the first token.
//
// With a non-null `steps`, lane 0 writes each chunk's iterations (0 for a
// chunk rejected before its first token). The TPU kernel reports the largest
// count of each group of 32 chunks, which the wrapper takes from these.
//
// Design: lanes 0-4 load the token's bytes and __shfl_sync hands them to
// every lane, so the whole warp follows one token. In a window, lane l owns
// bytes 4l .. 4l+3 of the 128-byte block of output that holds op. A copy
// takes at most dist bytes, so every byte of a window reads a byte written
// before the window began: one pass, then __syncwarp() before the next
// window reads it. Output is stored straight to device memory; stores at or
// past out_cap are dropped, and a copy only reads bytes below the one it
// writes, so every byte below out_cap is exact. The (SUB, 128) state tiles,
// lane rotations and pad rows of the TPU kernel stay behind.
//
// What bounds it on this card: each chunk is a serial chain of windows, each
// one a dependent round of loads, stores and a warp barrier; a short copy
// distance costs a window per doubling. The card is filled only by the
// chunks in flight (one warp each; an SM holds 64 warps, 132 SMs hold 8448).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr unsigned kAllLanes = 0xffffffffu;
constexpr int kMaxOut = 65536;
constexpr int kWindow = 128;

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
snappy_decode_r2_kernel(const uint8_t* __restrict__ comp,
                        const int32_t* __restrict__ comp_lens, int batch,
                        int cap, uint8_t* out, int32_t* __restrict__ out_lens,
                        uint8_t* __restrict__ ok, int out_cap,
                        int32_t* __restrict__ steps) {
  const int lane = threadIdx.x & 31;
  const int chunk = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (chunk >= batch) return;  // the same for every lane of the warp
  const uint8_t* src = comp + static_cast<size_t>(chunk) * cap;
  uint8_t* dst = out + static_cast<size_t>(chunk) * out_cap;
  const int clen = comp_lens[chunk];
  const int readable = max(0, min(clen, cap));

  // Lane k < 5 holds byte at+k of the chunk, 0 past its readable prefix.
  auto peek = [&](int at) -> int {
    return (lane < 5 && at + lane < readable) ? src[at + lane] : 0;
  };

  // Varint uncompressed length, at most 5 bytes, truncated to 32 bits and
  // read as signed.
  const int head = peek(0);
  uint32_t varint = 0;
  int vlen = 1;
  bool more = true;
  for (int k = 0; k < 5; ++k) {
    const int b = __shfl_sync(kAllLanes, head, k);
    if (k == 0) {
      varint = b & 0x7f;
    } else if (more) {
      varint |= static_cast<uint32_t>(b & 0x7f) << (7 * k);
      ++vlen;
    }
    if (k < 4) more = more && b >= 128;
  }
  const int64_t declared = static_cast<int32_t>(varint);

  bool err = declared > kMaxOut || vlen > clen || clen > cap;
  int ip = vlen;
  int op = 0;
  int rem = 0;    // bytes of the current token still to emit
  int from = 0;   // a literal's next input byte
  int dist = 0;   // a copy's distance
  bool literal = false;
  int count = 0;
  while (!err && (rem > 0 || ip < clen)) {
    ++count;
    if (rem == 0) {
      const int bytes = peek(ip);
      const int tag = __shfl_sync(kAllLanes, bytes, 0);
      const uint32_t b1 = __shfl_sync(kAllLanes, bytes, 1);
      const uint32_t b2 = __shfl_sync(kAllLanes, bytes, 2);
      const uint32_t b3 = __shfl_sync(kAllLanes, bytes, 3);
      const uint32_t b4 = __shfl_sync(kAllLanes, bytes, 4);
      const uint32_t word = b1 | (b2 << 8) | (b3 << 16) | (b4 << 24);
      const int type = tag & 3;
      const int n = tag >> 2;
      literal = type == 0;
      int tok;
      int64_t len;
      if (literal) {
        const int extra = min(max(n - 59, 0), 4);
        const uint64_t mask = (uint64_t{1} << (8 * extra)) - 1;
        len = (extra == 0 ? n : static_cast<int64_t>(word & mask)) + 1;
        tok = 1 + extra;
        err = len > kMaxOut || ip + tok + len > clen || op + len > declared;
        from = ip + tok;
      } else {
        tok = type == 1 ? 2 : (type == 2 ? 3 : 5);
        len = type == 1 ? 4 + (n & 7) : n + 1;
        const int64_t d = type == 1 ? static_cast<int64_t>(((tag >> 5) << 8) | b1)
                                    : (type == 2 ? static_cast<int64_t>(word & 0xffff)
                                                 : static_cast<int64_t>(word));
        err = ip + tok > clen || op + len > declared || d <= 0 || d > op;
        dist = static_cast<int>(d);
      }
      if (err) break;
      rem = static_cast<int>(len);
      ip += tok + (literal ? rem : 0);
    }

    const int o = op & (kWindow - 1);
    const int take = min(min(rem, kWindow - o), literal ? kWindow : dist);
    const int base = op - o;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int j = 4 * lane + t;
      const int at = base + j;
      if (j >= o && j < o + take && at < out_cap)
        dst[at] = literal ? src[from + (j - o)] : dst[at - dist];
    }
    __syncwarp();
    if (literal) {
      from += take;
    } else if (take == dist) {
      dist = min(2 * dist, kMaxOut);
    }
    op += take;
    rem -= take;
  }

  for (int j = min(op, out_cap) + lane; j < out_cap; j += 32) dst[j] = 0;
  if (lane == 0) {
    out_lens[chunk] = op;
    ok[chunk] = !err && op == declared;
    if (steps != nullptr) steps[chunk] = count;
  }
}

}  // namespace

// Launches the decode on `stream` and returns cudaGetLastError(). The caller
// allocates every buffer: out (batch, out_cap) uint8, out_lens (batch,)
// int32, ok (batch,) bool, and steps (batch,) int32 or null.
extern "C" int acx_snappy_decode_r2(const void* comp, const void* comp_lens,
                                    int batch, int cap, void* out,
                                    void* out_lens, void* ok, int out_cap,
                                    void* steps, void* stream) {
  if (batch > 0) {
    const int blocks = (batch + kWarpsPerBlock - 1) / kWarpsPerBlock;
    snappy_decode_r2_kernel<<<blocks, kWarpsPerBlock * 32, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(comp),
        static_cast<const int32_t*>(comp_lens), batch, cap,
        static_cast<uint8_t*>(out), static_cast<int32_t*>(out_lens),
        static_cast<uint8_t*>(ok), out_cap, static_cast<int32_t*>(steps));
  }
  return static_cast<int>(cudaGetLastError());
}
