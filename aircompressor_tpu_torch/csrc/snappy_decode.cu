// Snappy block decode for a batch of chunks of at most 64 KB, one warp per chunk.
//
// Replaces the TPU kernel aircompressor_tpu/ops/snappy_pallas_w.py::_decode_kernel
// and keeps its contract: a (B, cap) uint8 batch with (B,) int32 compressed
// lengths gives (B, out_cap) bytes, (B,) int32 output lengths and (B,) ok flags.
// It keeps that kernel's validation: declared > 64 KB, varint longer than the
// chunk, chunk longer than its row, a token or literal running past the chunk,
// output past the declared length, a copy with dist <= 0 or dist > op. On an
// error the chunk stops; its output length is the bytes produced before the
// bad token. ok = no error and op == declared. Bytes at or past the output
// length are zero. A 4-byte-offset copy takes all 32 bits of its offset, as
// the format and the host decoders do, so a nonzero high byte fails.
//
// Design: lanes 0-4 load the next token's bytes (bounds-checked against the
// chunk, never past the row) and __shfl_sync hands them to every lane, so
// the whole warp decodes the same token. A literal is copied by all 32
// lanes; a copy writes out[op+k] = out[op-dist + k % dist], which is exact
// for overlapping copies and reads only bytes before op. __syncwarp() between
// tokens makes a token's stores visible to the next token's loads. Output is
// stored straight to device memory; stores at or past out_cap are dropped,
// and since a copy only reads bytes before the one it writes, every byte
// below out_cap is still exact.
//
// With a non-null `steps`, lane 0 also writes the iterations of the token
// loop for each chunk: the tokens parsed, the failing one included, 0 for a
// chunk rejected before its first token. A null `steps` writes nothing more.
//
// What bounds it on this card: the tokens of a chunk are parsed one after
// another, each start depending on the token before, so one chunk is a serial
// chain of dependent loads. The card is filled only by the number of chunks
// in flight (one warp each; an SM holds 64 warps, 132 SMs hold 8448).
// Left for later: staging the 64 KB output in shared memory so that copies
// read their history there, and coalesced 16-byte stores of finished output.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr unsigned kAllLanes = 0xffffffffu;
constexpr int64_t kMaxOut = 65536;

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
snappy_decode_kernel(const uint8_t* __restrict__ comp,
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
  const int readable = max(0, min(clen, cap));

  // Lane k < 5 holds byte at+k of the chunk, 0 past its readable prefix.
  auto peek = [&](int at) -> int {
    return (lane < 5 && at + lane < readable) ? src[at + lane] : 0;
  };

  // Varint uncompressed length, at most 5 bytes, truncated to 32 bits.
  const int head = peek(0);
  uint32_t declared = 0;
  int vlen = 1;
  bool more = true;
  for (int k = 0; k < 5; ++k) {
    const int b = __shfl_sync(kAllLanes, head, k);
    if (k == 0) {
      declared = b & 0x7f;
    } else if (more) {
      declared |= static_cast<uint32_t>(b & 0x7f) << (7 * k);
      ++vlen;
    }
    if (k < 4) more = more && b >= 128;
  }

  bool err = declared > kMaxOut || vlen > clen || clen > cap;
  int ip = vlen;
  int op = 0;
  int count = 0;
  while (!err && ip < clen) {
    ++count;
    const int bytes = peek(ip);
    const int tag = __shfl_sync(kAllLanes, bytes, 0);
    const uint32_t b1 = __shfl_sync(kAllLanes, bytes, 1);
    const uint32_t b2 = __shfl_sync(kAllLanes, bytes, 2);
    const uint32_t b3 = __shfl_sync(kAllLanes, bytes, 3);
    const uint32_t b4 = __shfl_sync(kAllLanes, bytes, 4);
    const uint32_t word = b1 | (b2 << 8) | (b3 << 16) | (b4 << 24);
    const int type = tag & 3;
    const int n = tag >> 2;
    const bool literal = type == 0;

    int tok;
    int64_t len;
    int64_t dist = 0;
    if (literal) {
      const int extra = min(max(n - 59, 0), 4);
      const uint64_t mask = (uint64_t{1} << (8 * extra)) - 1;
      len = (extra == 0 ? n : static_cast<int64_t>(word & mask)) + 1;
      tok = 1 + extra;
      err = len > kMaxOut || ip + tok + len > clen || op + len > declared;
    } else {
      tok = type == 1 ? 2 : (type == 2 ? 3 : 5);
      len = type == 1 ? 4 + (n & 7) : n + 1;
      dist = type == 1 ? static_cast<int64_t>(((tag >> 5) << 8) | b1)
                       : (type == 2 ? static_cast<int64_t>(word & 0xffff)
                                    : static_cast<int64_t>(word));
      err = ip + tok > clen || op + len > declared || dist <= 0 || dist > op;
    }
    if (err) break;

    const int n_out = static_cast<int>(len);
    const int n_store = min(n_out, out_cap - op);
    if (literal) {
      const uint8_t* lit = src + ip + tok;
      for (int k = lane; k < n_store; k += 32) dst[op + k] = lit[k];
      ip += tok + n_out;
    } else {
      const int d = static_cast<int>(dist);
      const uint8_t* from = dst + (op - d);
      for (int k = lane; k < n_store; k += 32)
        dst[op + k] = from[d >= n_store ? k : k % d];
      ip += tok;
    }
    op += n_out;
    __syncwarp();
  }

  for (int j = min(op, out_cap) + lane; j < out_cap; j += 32) dst[j] = 0;
  if (lane == 0) {
    out_lens[chunk] = op;
    ok[chunk] = !err && static_cast<uint32_t>(op) == declared;
    if (steps != nullptr) steps[chunk] = count;
  }
}

}  // namespace

// Launches the decode on `stream` and returns cudaGetLastError(). The caller
// allocates every buffer: out (batch, out_cap) uint8, out_lens (batch,)
// int32, ok (batch,) bool, and steps (batch,) int32 or null.
extern "C" int acx_snappy_decode(const void* comp, const void* comp_lens,
                                 int batch, int cap, void* out, void* out_lens,
                                 void* ok, int out_cap, void* steps,
                                 void* stream) {
  if (batch > 0) {
    const int blocks = (batch + kWarpsPerBlock - 1) / kWarpsPerBlock;
    snappy_decode_kernel<<<blocks, kWarpsPerBlock * 32, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(comp),
        static_cast<const int32_t*>(comp_lens), batch, cap,
        static_cast<uint8_t*>(out), static_cast<int32_t*>(out_lens),
        static_cast<uint8_t*>(ok), out_cap, static_cast<int32_t*>(steps));
  }
  return static_cast<int>(cudaGetLastError());
}
