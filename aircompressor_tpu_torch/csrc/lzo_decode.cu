// LZO1X block decode for a batch of chunks of at most 64 KB, one warp per chunk.
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
// the bytes produced before the failing step. ok = the stop command was
// reached with no error (bytes after it are ignored). Bytes at or past the
// output length are zero.
//
// With a non-null `steps`, lane 0 also writes the iterations of the command
// loop for each chunk: the commands parsed after the first-byte literal run,
// the stop command and the failing one included (a missing stop command is
// one failing iteration); 0 for a chunk rejected before the loop. A null
// `steps` writes nothing more.
//
// Design: the lanes of a warp walk the command chain together (every lane
// reads the same command bytes, one transaction). A zero run is read 32
// bytes a step, one a lane, and __ballot_sync finds its first nonzero byte.
// Literal runs and matches are copied by all 32 lanes; a match writes
// out[op+k] = out[op-dist + k % dist], which is exact for overlapping
// matches and reads only bytes before op. __syncwarp() after each copy makes
// its stores visible to the next copy's loads. Output goes straight to
// device memory; stores at or past out_cap are dropped, and since a match
// only reads bytes before the one it writes, every byte below out_cap is
// still exact.
//
// What bounds it on this card: the commands of a chunk are parsed one after
// another, each start depending on the command before, so one chunk is a
// serial chain of dependent loads; the card is filled only by the chunks in
// flight (one warp each). Left for later: staging the output in shared
// memory, and coalesced 16-byte stores of finished output.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr unsigned kAllLanes = 0xffffffffu;
constexpr int kMaxOut = 65536;
// A zero run longer than this makes a length past 64 KB, malformed whatever
// its last byte; cutting it here keeps the length in an int.
constexpr int kLongRun = 258;

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
lzo_decode_kernel(const uint8_t* __restrict__ comp,
                  const int32_t* __restrict__ comp_lens, int batch, int cap,
                  uint8_t* out, int32_t* __restrict__ out_lens,
                  uint8_t* __restrict__ ok, int out_cap,
                  int32_t* __restrict__ steps) {
  const int lane = threadIdx.x & 31;
  const int chunk = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (chunk >= batch) return;  // the same for every lane of the warp
  const uint8_t* src = comp + static_cast<size_t>(chunk) * cap;
  uint8_t* dst = out + static_cast<size_t>(chunk) * out_cap;
  const int clen = comp_lens[chunk];

  auto byte_at = [&](int p) -> int { return p < clen ? src[p] : 0; };

  // Position of the first nonzero byte at or after p, or -1 where the zero
  // run reaches the end of the chunk.
  auto zero_run_end = [&](int p) -> int {
    while (true) {
      const int at = p + lane;
      const int b = at < clen ? src[at] : -1;
      const unsigned hit = __ballot_sync(kAllLanes, b != 0);
      if (hit != 0) {
        const int k = __ffs(hit) - 1;
        return __shfl_sync(kAllLanes, b, k) < 0 ? -1 : p + k;
      }
      p += 32;
    }
  };

  int op = 0;
  auto copy_literals = [&](int from, int n) {
    const int n_store = min(n, out_cap - op);
    for (int k = lane; k < n_store; k += 32) dst[op + k] = src[from + k];
    op += n;
    __syncwarp();
  };

  bool err = clen <= 0 || clen > cap;
  bool done = false;
  int ip = 0;
  int state = 0;
  int count = 0;
  if (!err && src[0] > 17) {  // first-byte literal run
    const int n = src[0] - 17;
    err = 1 + n > clen;
    if (!err) {
      copy_literals(1, n);
      ip = 1 + n;
      state = min(n, 4);
    }
  }
  while (!err) {
    ++count;
    if (ip >= clen) {  // missing stop command
      err = true;
      break;
    }
    const int t = src[ip];
    if (t < 16 && state == 0) {  // literal run
      int len = t + 3;
      int from = ip + 1;
      if (t == 0) {
        const int z = zero_run_end(ip + 1);
        err = z < 0;
        if (err) break;
        len = 255 * min(z - ip - 1, kLongRun) + src[z] + 18;
        from = z + 1;
      }
      err = len > clen - from || op + len > kMaxOut;
      if (err) break;
      copy_literals(from, len);
      ip = from + len;
      state = 4;
      continue;
    }
    int len, dist, trailing, end;
    if (t < 16 || t >= 64) {  // the 2-byte commands
      const int next = byte_at(ip + 1);
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
      int w = ip + 1;
      len = low + 2;
      if (low == 0) {
        const int z = zero_run_end(ip + 1);
        err = z < 0;
        if (err) break;
        len = 255 * min(z - ip - 1, kLongRun) + src[z] + (m4 ? 9 : 33);
        w = z + 1;
      }
      const int word = byte_at(w) | (byte_at(w + 1) << 8);
      end = w + 2;
      trailing = word & 3;
      dist = m4 ? 16384 + ((t & 8) << 11) + (word >> 2) : (word >> 2) + 1;
      if (m4 && dist == 16384 && end <= clen) {  // stop command
        done = true;
        break;
      }
    }
    err = end > clen || dist > op || op + len > kMaxOut;
    if (err) break;
    const int n_store = min(len, out_cap - op);
    const uint8_t* from = dst + (op - dist);
    for (int k = lane; k < n_store; k += 32)
      dst[op + k] = from[dist >= n_store ? k : k % dist];
    op += len;
    ip = end;
    __syncwarp();
    if (trailing != 0) {
      err = ip + trailing > clen || op + trailing > kMaxOut;
      if (err) break;
      copy_literals(ip, trailing);
      ip += trailing;
    }
    state = trailing;
  }

  for (int j = max(0, min(op, out_cap)) + lane; j < out_cap; j += 32) dst[j] = 0;
  if (lane == 0) {
    out_lens[chunk] = op;
    ok[chunk] = !err && done;
    if (steps != nullptr) steps[chunk] = count;
  }
}

}  // namespace

// Launches the decode on `stream` and returns cudaGetLastError(). The caller
// allocates every buffer: out (batch, out_cap) uint8, out_lens (batch,)
// int32, ok (batch,) bool, and steps (batch,) int32 or null.
extern "C" int acx_lzo_decode(const void* comp, const void* comp_lens,
                              int batch, int cap, void* out, void* out_lens,
                              void* ok, int out_cap, void* steps, void* stream) {
  if (batch > 0) {
    const int blocks = (batch + kWarpsPerBlock - 1) / kWarpsPerBlock;
    lzo_decode_kernel<<<blocks, kWarpsPerBlock * 32, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(comp),
        static_cast<const int32_t*>(comp_lens), batch, cap,
        static_cast<uint8_t*>(out), static_cast<int32_t*>(out_lens),
        static_cast<uint8_t*>(ok), out_cap, static_cast<int32_t*>(steps));
  }
  return static_cast<int>(cudaGetLastError());
}
