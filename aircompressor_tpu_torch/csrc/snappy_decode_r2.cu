// Snappy block decode, the r2 design, for a batch of chunks of at most 64 KB:
// one warp per chunk, one output window of at most 128 bytes an iteration,
// with the chunk's input and its recent output in shared memory.
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
// Design. The loop, its windows and its counts are the TPU kernel's (the r2
// design is the ablation baseline beside csrc/snappy_decode.cu, so it keeps
// one window an iteration and does not group or read ahead); what changes is
// where its bytes live, with the input ring and output window of
// csrc/decode_window.cuh:
// - Input ring (2 KB; 4 KB beside the 32 KB window). Every lane reads a
//   token's header (tag and up to 4 bytes) by one 8-byte broadcast read of
//   the ring, and a literal window's bytes from it.
// - Output window (kWindow bytes). In a window, lane l owns bytes 4l .. 4l+3
//   of the 128-byte block of output that holds op: four reads, four writes
//   to the window, then one __syncwarp(). A copy takes at most dist bytes,
//   so every byte it reads was written before the window began. A copy with
//   dist <= kReach = kWindow - kWindow / 16 reads the window; a farther one
//   (dists reach 65,535) reads device memory, where those bytes are already
//   drained, and only for destinations below out_cap.
// The window drains to device memory in 16-byte stores whenever half of it
// waits (a window adds at most 128 <= kWindow / 16 bytes, so no write
// overwrites a byte not yet drained and a far read's source is drained);
// the zero tail is stored the same way. Nothing is stored at or past
// out_cap, and a copy only reads bytes below the one it writes, so every
// byte below out_cap is exact.
//
// Two instantiations of the one template, picked by the batch as for
// csrc/lz4_decode.cu: 4 KB windows (6 KB of shared memory a chunk, 32 chunks
// an SM) above 792 chunks, and 32 KB windows (36 KB with the ring, 6 chunks
// an SM) up to 792.
//
// What bounds it on this card: each chunk is a serial chain of windows, each
// a round of shared-memory reads and writes and a warp barrier; a short copy
// distance costs a window per doubling, so the longest group of 32 chunks
// (64 KB of dist-1 copies: 7,168 windows) sets a one-wave batch's time.

#include "decode_window.cuh"

namespace {

constexpr int kMaxOut = 65536;
constexpr int kBlock = 128;  // the TPU kernel's window: at most 128 bytes, 128-aligned
constexpr int kSmallBatchChunks = 792;  // 6 chunks an SM on 132 SMs

template <int kWindow, int kMinBlocks>
__global__ void __launch_bounds__(32, kMinBlocks)
snappy_decode_r2_kernel(const uint8_t* __restrict__ comp,
                        const int32_t* __restrict__ comp_lens, int cap,
                        uint8_t* out, int32_t* __restrict__ out_lens,
                        uint8_t* __restrict__ ok, int out_cap,
                        int32_t* __restrict__ steps) {
  constexpr int kReach = kWindow - kWindow / 16;  // farthest dist read from the window
  static_assert(kBlock <= kWindow / 16, "a window adds at most kWindow / 16 bytes");
  constexpr int kRingBytes = ring_bytes(kWindow);
  __shared__ uint4 ring4[kRingBytes / 16];
  __shared__ uint4 win4[kWindow / 16];

  const int lane = threadIdx.x;
  const int chunk = blockIdx.x;
  const uint8_t* src = comp + static_cast<size_t>(chunk) * cap;
  uint8_t* row = out + static_cast<size_t>(chunk) * out_cap;
  const int clen = comp_lens[chunk];
  const int readable = max(0, min(clen, cap));

  InputRing<kRingBytes> in;
  in.start(smem_addr(ring4), src, cap, 0, readable, lane);
  in.ring = opaque(in.ring);
  const int sr = in.lo;  // the ring coordinate of input byte 0
  OutWindow<kWindow> w;
  w.init(win4, row, out_cap, lane);
  w.win = opaque(w.win);

  // Bytes at..at+7 of the chunk (0 at and past readable), from the ring.
  auto read8 = [&](int at) -> uint64_t {
    const int p = at + sr;
    in.need(min(p + 8, in.hi));
    const int a = p & ~7;
    const uint64_t lo = in.at8(a), hi = in.at8(a + 8);
    const int sh = 8 * (p & 7);
    const uint64_t v = sh ? (lo >> sh) | (hi << (64 - sh)) : lo;
    const int valid = min(max(readable - at, 0), 8);
    return valid == 8 ? v : v & ((uint64_t{1} << (8 * valid)) - 1);
  };

  // Varint uncompressed length, at most 5 bytes, truncated to 32 bits and
  // read as signed.
  const uint64_t head = read8(0);
  uint32_t varint = 0;
  int vlen = 1;
  bool more = true;
  for (int k = 0; k < 5; ++k) {
    const int b = static_cast<int>((head >> (8 * k)) & 0xff);
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
  int count = 0;
  const int lane_at = 4 * lane + w.so;  // this lane's first byte's slot, from op - (op & 127)
  // Each token: its parse (which fails, or emits in the same iteration) and
  // its windows, one iteration each. Literal, window-copy and far-copy
  // windows run in loops of their own: a token's kind holds for all its
  // windows, and a copy's dist doubles only up to 128.
  while (!err && ip < clen) {
    const uint64_t h = read8(ip);
    const int tag = static_cast<int>(h & 0xff);
    const uint32_t b1 = static_cast<uint32_t>(h >> 8) & 0xff;
    const uint32_t word = static_cast<uint32_t>(h >> 8);  // bytes 1-4
    const int type = tag & 3;
    const int n = tag >> 2;
    int tok, dist = 0;
    int64_t len;
    if (type == 0) {
      const int extra = min(max(n - 59, 0), 4);
      const uint64_t mask = (uint64_t{1} << (8 * extra)) - 1;
      len = (extra == 0 ? n : static_cast<int64_t>(word & mask)) + 1;
      tok = 1 + extra;
      err = len > kMaxOut || ip + tok + len > clen || op + len > declared;
    } else {
      tok = type == 1 ? 2 : (type == 2 ? 3 : 5);
      len = type == 1 ? 4 + (n & 7) : n + 1;
      const int64_t d = type == 1 ? static_cast<int64_t>(((tag >> 5) << 8) | b1)
                                  : (type == 2 ? static_cast<int64_t>(word & 0xffff)
                                               : static_cast<int64_t>(word));
      err = ip + tok > clen || op + len > declared || d <= 0 || d > op;
      dist = static_cast<int>(d);
    }
    if (err) {  // the failed parse costs its iteration
      ++count;
      break;
    }
    int rem = static_cast<int>(len);
    if (type == 0) {  // a literal: windows of up to 128 bytes from the ring
      int from = ip + tok + sr;  // the ring coordinate of its next byte
      ip += tok + rem;
      do {
        ++count;
        const int o = op & (kBlock - 1);
        const int take = min(rem, kBlock - o);
        if (__builtin_expect(from + take > in.ready_end(), 0)) in.need(from + take);
        const int s0 = from + 4 * lane - o, d0 = op - o + lane_at;
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const uint32_t b = in.at(s0 + t);
          sts_u8_if(static_cast<unsigned>(4 * lane + t - o) < static_cast<unsigned>(take),
                    w.win + ((d0 + t) & (kWindow - 1)), b);
        }
        from += take;
        op += take;
        rem -= take;
        __syncwarp();
        if (__builtin_expect(op >= w.drain_at, 0)) w.drain(op);
      } while (rem > 0);
    } else if (dist <= kReach) {  // a copy from the window
      ip += tok;
      do {
        ++count;
        const int o = op & (kBlock - 1);
        const int take = min(min(rem, kBlock - o), dist);
        const int d0 = op - o + lane_at;
        uint32_t b[4];
#pragma unroll
        for (int t = 0; t < 4; ++t) b[t] = lds_u8(w.win + ((d0 + t - dist) & (kWindow - 1)));
#pragma unroll
        for (int t = 0; t < 4; ++t)
          sts_u8_if(static_cast<unsigned>(4 * lane + t - o) < static_cast<unsigned>(take),
                    w.win + ((d0 + t) & (kWindow - 1)), b[t]);
        dist = take == dist ? min(2 * dist, kMaxOut) : dist;
        op += take;
        rem -= take;
        __syncwarp();
        if (__builtin_expect(op >= w.drain_at, 0)) w.drain(op);
      } while (rem > 0);
    } else {  // a far copy: drained device memory, for destinations below out_cap
      ip += tok;
      do {
        ++count;
        const int o = op & (kBlock - 1);
        const int take = min(min(rem, kBlock - o), dist);
        const int at0 = op - o + 4 * lane, d0 = op - o + lane_at;
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const bool live = static_cast<unsigned>(4 * lane + t - o) < static_cast<unsigned>(take) &&
                            at0 + t < out_cap;
          const uint32_t b = live ? w.dst[at0 + t - dist] : 0;
          sts_u8_if(live, w.win + ((d0 + t) & (kWindow - 1)), b);
        }
        dist = take == dist ? min(2 * dist, kMaxOut) : dist;
        op += take;
        rem -= take;
        __syncwarp();
        if (__builtin_expect(op >= w.drain_at, 0)) w.drain(op);
      } while (rem > 0);
    }
  }

  w.finish(op);
  cp_async_wait_all();
  if (lane == 0) {
    out_lens[chunk] = op;
    ok[chunk] = !err && op == declared;
    if (steps != nullptr) steps[chunk] = count;
  }
}

template <int kWindow, int kMinBlocks>
cudaError_t launch(const uint8_t* comp, const int32_t* comp_lens, int batch,
                   int cap, uint8_t* out, int32_t* out_lens, uint8_t* ok,
                   int out_cap, int32_t* steps, cudaStream_t stream) {
  static const cudaError_t carveout = cudaFuncSetAttribute(
      snappy_decode_r2_kernel<kWindow, kMinBlocks>,
      cudaFuncAttributePreferredSharedMemoryCarveout,
      static_cast<int>(cudaSharedmemCarveoutMaxShared));
  if (carveout != cudaSuccess) return carveout;
  snappy_decode_r2_kernel<kWindow, kMinBlocks><<<batch, 32, 0, stream>>>(
      comp, comp_lens, cap, out, out_lens, ok, out_cap, steps);
  return cudaGetLastError();
}

}  // namespace

// Launches the decode on `stream` and returns cudaGetLastError(). The caller
// allocates every buffer: out (batch, out_cap) uint8, out_lens (batch,)
// int32, ok (batch,) bool, and steps (batch,) int32 or null.
extern "C" int acx_snappy_decode_r2(const void* comp, const void* comp_lens,
                                    int batch, int cap, void* out,
                                    void* out_lens, void* ok, int out_cap,
                                    void* steps, void* stream) {
  if (batch <= 0) return static_cast<int>(cudaGetLastError());
  const auto* c = static_cast<const uint8_t*>(comp);
  const auto* cl = static_cast<const int32_t*>(comp_lens);
  auto* o = static_cast<uint8_t*>(out);
  auto* ol = static_cast<int32_t*>(out_lens);
  auto* k = static_cast<uint8_t*>(ok);
  auto* st = static_cast<int32_t*>(steps);
  auto* s = static_cast<cudaStream_t>(stream);
  if (batch <= kSmallBatchChunks)
    return static_cast<int>(launch<32768, 6>(c, cl, batch, cap, o, ol, k, out_cap, st, s));
  return static_cast<int>(launch<4096, 32>(c, cl, batch, cap, o, ol, k, out_cap, st, s));
}
