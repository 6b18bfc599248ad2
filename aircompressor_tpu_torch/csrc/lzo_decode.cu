// LZO1X block decode for a batch of chunks of at most 64 KB, one warp per
// chunk, with the chunk's input and its recent output in shared memory.
//
// Replaces the TPU kernel aircompressor_tpu/ops/lzo_pallas_w.py::_decode_kernel
// and keeps its contract: a (B, cap) uint8 batch with (B,) int32 compressed
// lengths gives (B, out_cap) bytes, (B,) int32 output lengths and (B,) ok
// flags. It follows aircompressor_tpu/lzo/block_ref.py::decompress rule by
// rule. A chunk whose length is not in [1, cap] is malformed. A first byte
// t > 17 is a literal run of t - 17 bytes. Then each command's first byte t
// is read with `state`, the literals that ended the previous command (4
// after a literal-run command):
//   t < 16, state 0:    literal run of t + 3 (t = 0: zero-extended, + 18);
//   t < 16, state 1-3:  match of 2, dist (t >> 2) + (next << 2) + 1;
//   t < 16, state >= 4: match of 3, dist (t >> 2) + (next << 2) + 2049;
//   16 <= t < 32 (M4):  match of (t & 7) + 2 (0: zero-extended, + 9), then a
//                       little-endian word w: dist 16384 + ((t & 8) << 11) +
//                       (w >> 2); dist 16384 is the stop command;
//   32 <= t < 64 (M3):  match of (t & 31) + 2 (0: zero-extended, + 33), then
//                       w: dist (w >> 2) + 1;
//   t >= 64 (M2):       match of (t >> 5) + 1, dist ((t >> 2) & 7) +
//                       (next << 3) + 1.
// A zero-extended length adds 255 for each zero byte and ends with the first
// byte that is not zero. After a match, the low 2 bits of w (of t for the
// 2-byte commands) are a count of literals that follow, and the next state.
// A command or literal run that reads past the chunk, a zero run that
// reaches its end, a match from before the output's start, or output past
// 64 KB is malformed; the chunk stops there, and its output length counts
// the bytes produced before the failing step (a match whose trailing
// literals fail counts its own bytes). ok = the stop command was reached
// with no error (bytes after it are ignored). Bytes at or past the output
// length are zero.
//
// With a non-null `steps`, lane 0 also writes the iterations of the command
// loop for each chunk: the commands parsed after the first-byte literal run,
// the stop command and the failing one included (a missing stop command is
// one failing iteration); 0 for a chunk rejected before the loop. A null
// `steps` writes nothing more.
//
// Design. Each block is one warp and decodes one chunk, so 256 chunks spread
// over all 132 SMs. The warp keeps the input ring and the output window of
// csrc/decode_window.cuh:
// - Input ring (2 KB; 4 KB beside the 32 KB window, which keeps six slices
//   of 512 B in flight for the literal runs). Every lane reads a command's
//   bytes from it (one 8-byte broadcast read covers the first byte, the
//   operand word and up to 3 trailing literals), the next command's bytes
//   are read before this one's moves, a zero run is found by a ballot over
//   32 ring bytes a round, and a literal run streams from it into the
//   window in pieces of at most one ready stretch.
// - Output window (kWindow bytes). One step moves at most kStep =
//   kWindow / 16 bytes: a match and its 0-3 trailing literals (from the ring,
//   so the two moves do not conflict), lane k moving bytes k, k + 32, ...
//   four reads before four writes, an overlapping match's k mod dist by the
//   reciprocal table, then one __syncwarp(). A match with dist <=
//   kWindow - kStep reads its source in the window, where no write of the
//   step meets it; a farther one (LZO's M4 reaches 49,151 bytes) reads
//   device memory, where those bytes already are, and only for destinations
//   below out_cap. A match longer than a step (zero-extended lengths) moves
//   in pieces at the same dist, its trailing literals with the last. Every
//   source byte lies before op, so the reads of a step never wait on its
//   writes.
// The window drains to device memory in 16-byte stores whenever half of it
// waits (a step adds at most kWindow / 16, so no write overwrites a byte not
// yet drained and a far read's source is drained); the zero tail is stored
// the same way. Nothing is stored at or past out_cap, so out_cap = 4093
// takes bytes at the row's edge.
//
// Two instantiations of the one template, picked by the batch: 4 KB windows
// (6 KB of shared memory a chunk, 32 chunks an SM, so 4096 chunks are one
// wave) above 792 chunks, and 32 KB windows (36 KB with the ring, 6 chunks
// an SM) up to 792,
// where one wave holds the batch anyway: on the generated corpus 97% of the
// matches (and of their bytes) lie within the 32 KB window's reach of
// 30,720 against 33% within the 4 KB window's 3,840
// (lzo_decode.distance_shares).
//
// What bounds it on this card: the commands of a chunk are parsed one after
// another, each start depending on the command before, so one chunk is a
// serial chain of shared-memory reads, 32-lane byte moves and a warp barrier
// a step. A one-wave batch takes as long as its longest chain; at 32 chunks
// an SM the instructions the warps issue bound it.

#include "decode_window.cuh"

namespace {

constexpr int kMaxOut = 65536;
constexpr int kSmallBatchChunks = 792;  // 6 chunks an SM on 132 SMs
// A zero run longer than this makes a length past 64 KB, malformed whatever
// its last byte; cutting it here keeps the length in an int.
constexpr int kLongRun = 258;

template <int kWindow, int kMinBlocks>
__global__ void __launch_bounds__(32, kMinBlocks)
lzo_decode_kernel(const uint8_t* __restrict__ comp,
                  const int32_t* __restrict__ comp_lens, int cap, uint8_t* out,
                  int32_t* __restrict__ out_lens, uint8_t* __restrict__ ok,
                  int out_cap, int32_t* __restrict__ steps) {
  constexpr int kStep = kWindow / 16;       // output bytes a step may add
  constexpr int kReach = kWindow - kStep;  // farthest dist read from the window
  static_assert(2 * kStep <= OutWindow<kWindow>::kFlushAt, "a far read's source is drained");
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
  const int sr = in.lo;  // the ring coordinate of input byte 0
  const int in_end = in.hi;
  OutWindow<kWindow> w;
  w.init(win4, row, out_cap, lane);

  // Bytes at..at+7 of the chunk (0 at and past readable), from the ring; the
  // ring holds them.
  auto read8 = [&](int at) -> uint64_t {
    const int p = at + sr;
    in.need(min(p + 8, in_end));
    const int a = p & ~7;
    const uint64_t lo = in.at8(a), hi = in.at8(a + 8);
    const int sh = 8 * (p & 7);
    const uint64_t v = sh ? (lo >> sh) | (hi << (64 - sh)) : lo;
    const int valid = min(max(readable - at, 0), 8);  // bytes below readable
    return valid == 8 ? v : v & ((uint64_t{1} << (8 * valid)) - 1);
  };

  // Position of the first nonzero byte at or after p, or -1 where the zero
  // run reaches the end of the chunk: a ballot over 32 ring bytes a round.
  auto zero_run_end = [&](int p) -> int {
    while (true) {
      in.need(min(p + sr + 32, in_end));
      const int at = p + lane;
      const int b = at < readable ? static_cast<int>(in.at(at + sr)) : -1;
      const unsigned hit = __ballot_sync(kAllLanes, b != 0);
      if (hit != 0) {
        const int k = __ffs(hit) - 1;
        return __shfl_sync(kAllLanes, b, k) < 0 ? -1 : p + k;
      }
      p += 32;
    }
  };

  int op = 0;
  // One step: `total` bytes to the window at op. Bytes k < mlen repeat the
  // byte dist back (window or device memory); the others are input bytes
  // from lit_at + k - mlen, in the ring. Lane k moves bytes k, k + 32, ...,
  // four reads before four writes. Then __syncwarp() and a drain.
  auto step = [&](int dist, int mlen, int total, int lit_at) {
    const int from = op - dist;
    if (mlen > 0 && dist <= kReach) {  // from the window; reads only bytes before op
      int r = lane, stride = 32;  // k mod dist for an overlapping match
      if (dist < mlen) mod_walk(dist, lane, r, stride);
      for (int k0 = 0; k0 < mlen; k0 += 128) {
        uint32_t b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          b[i] = w.get(from + (dist >= mlen ? k0 + 32 * i + lane : r));
          r += stride;
          if (r >= dist) r -= dist;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int k = k0 + 32 * i + lane;
          w.put_if(k < mlen, op + k, b[i]);
        }
      }
    } else if (mlen > 0) {  // from device memory, for destinations below out_cap
      for (int k0 = 0; k0 < mlen; k0 += 128) {
        uint32_t b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int k = k0 + 32 * i + lane;
          b[i] = k < mlen && op + k < out_cap ? w.dst[from + k] : 0;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int k = k0 + 32 * i + lane;
          w.put_if(k < mlen && op + k < out_cap, op + k, b[i]);
        }
      }
    }
    const int lit = lit_at + sr - mlen;
    for (int k0 = mlen; k0 < total; k0 += 128) {  // literal bytes from the ring
      uint32_t b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) b[i] = in.at(lit + k0 + 32 * i + lane);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = k0 + 32 * i + lane;
        w.put_if(k < total, op + k, b[i]);
      }
    }
    op += total;
    __syncwarp();
    w.drain(op);
  };
  // A literal run of n input bytes from `from`, in pieces of at most kStep
  // bytes and one ready stretch of the ring.
  auto literals = [&](int from, int n) {
    while (n > 0) {
      const int p = from + sr;
      in.need(p + 1);
      const int piece = min(min(n, kStep), in.ready_end() - p);
      step(0, 0, piece, from);
      from += piece;
      n -= piece;
    }
  };

  bool err = clen <= 0 || clen > cap;
  bool done = false;
  int ip = 0;
  int state = 0;
  int count = 0;
  uint64_t bytes = read8(0);  // the next command's bytes, read one step ahead
  if (!err && (bytes & 0xff) > 17) {  // first-byte literal run
    const int n = static_cast<int>(bytes & 0xff) - 17;
    err = 1 + n > clen;
    if (!err) {
      literals(1, n);
      ip = 1 + n;
      state = min(n, 4);
      bytes = read8(ip);
    }
  }
  while (!err) {
    ++count;
    if (ip >= clen) {  // missing stop command
      err = true;
      break;
    }
    const int t = static_cast<int>(bytes & 0xff);
    if (t < 16 && state == 0) {  // literal run
      int len = t + 3;
      int from = ip + 1;
      if (t == 0) {
        const int z = zero_run_end(ip + 1);
        err = z < 0;
        if (err) break;
        len = 255 * min(z - ip - 1, kLongRun) + static_cast<int>(in.at(z + sr)) + 18;
        from = z + 1;
      }
      err = len > clen - from || op + len > kMaxOut;
      if (err) break;
      literals(from, len);
      ip = from + len;
      state = 4;
      bytes = read8(ip);
      continue;
    }
    int len, dist, trailing, end;
    if (t < 16 || t >= 64) {  // the 2-byte commands
      const int next = static_cast<int>((bytes >> 8) & 0xff);
      end = ip + 2;
      trailing = t & 3;
      if (t >= 64) {
        len = (t >> 5) + 1;
        dist = ((t >> 2) & 7) + (next << 3) + 1;
      } else {
        len = state < 4 ? 2 : 3;
        dist = (t >> 2) + (next << 2) + (state < 4 ? 1 : 2049);
      }
    } else {  // M4 and M3
      const bool m4 = t < 32;
      const int low = m4 ? t & 7 : t & 31;
      int word = static_cast<int>((bytes >> 8) & 0xffff);
      int wat = ip + 1;
      len = low + 2;
      if (low == 0) {
        const int z = zero_run_end(ip + 1);
        err = z < 0;
        if (err) break;
        len = 255 * min(z - ip - 1, kLongRun) + static_cast<int>(in.at(z + sr)) + (m4 ? 9 : 33);
        wat = z + 1;
        word = static_cast<int>(read8(wat) & 0xffff);
      }
      end = wat + 2;
      trailing = word & 3;
      dist = m4 ? 16384 + ((t & 8) << 11) + (word >> 2) : (word >> 2) + 1;
      if (m4 && dist == 16384 && end <= clen) {  // stop command
        done = true;
        break;
      }
    }
    err = end > clen || dist > op || op + len > kMaxOut;
    if (err) break;
    // Trailing literals that fail are not moved; the match still counts.
    const bool tail_err =
        trailing != 0 && (end + trailing > clen || op + len + trailing > kMaxOut);
    const int tail = tail_err ? 0 : trailing;
    ip = end + tail;
    bytes = read8(ip);  // ahead of this step's moves, so the two overlap
    for (int rem = len;;) {  // the match in pieces at one dist, tail with the last
      const int piece = min(rem, kStep - tail);
      rem -= piece;
      step(dist, piece, piece + (rem == 0 ? tail : 0), end);
      if (rem == 0) break;
    }
    err = tail_err;
    state = trailing;
  }

  w.finish(op);
  cp_async_wait_all();
  if (lane == 0) {
    out_lens[chunk] = op;
    ok[chunk] = !err && done;
    if (steps != nullptr) steps[chunk] = count;
  }
}

template <int kWindow, int kMinBlocks>
cudaError_t launch(const uint8_t* comp, const int32_t* comp_lens, int batch,
                   int cap, uint8_t* out, int32_t* out_lens, uint8_t* ok,
                   int out_cap, int32_t* steps, cudaStream_t stream) {
  static const cudaError_t carveout = cudaFuncSetAttribute(
      lzo_decode_kernel<kWindow, kMinBlocks>,
      cudaFuncAttributePreferredSharedMemoryCarveout,
      static_cast<int>(cudaSharedmemCarveoutMaxShared));
  if (carveout != cudaSuccess) return carveout;
  lzo_decode_kernel<kWindow, kMinBlocks><<<batch, 32, 0, stream>>>(
      comp, comp_lens, cap, out, out_lens, ok, out_cap, steps);
  return cudaGetLastError();
}

}  // namespace

// Launches the decode on `stream` and returns cudaGetLastError(). The caller
// allocates every buffer: out (batch, out_cap) uint8, out_lens (batch,)
// int32, ok (batch,) bool, and steps (batch,) int32 or null.
extern "C" int acx_lzo_decode(const void* comp, const void* comp_lens,
                              int batch, int cap, void* out, void* out_lens,
                              void* ok, int out_cap, void* steps, void* stream) {
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
