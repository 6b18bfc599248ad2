// LZ4 block decode for a batch of chunks of at most 64 KB, one warp per chunk.
//
// Replaces the TPU kernel aircompressor_tpu/ops/lz4_pallas_w.py::_decode_kernel
// and keeps its contract: a (B, cap) uint8 batch with (B,) int32 compressed
// lengths gives (B, out_cap) bytes, (B,) int32 output lengths and (B,) ok
// flags. It keeps that kernel's rules: a chunk whose length is not in
// [1, cap] is malformed; a token holds a 4-bit literal length and a 4-bit
// match length less 4, and a nibble of 15 is followed by 255-extension bytes
// ended by the first byte that is not 0xFF; the offset is 2 bytes, little-
// endian, and bad when 0 or past the output; a parse that reads past the
// chunk, or a run that would take the output past 64 KB, is malformed. On an
// error the chunk stops; its output length counts the bytes produced before
// it. ok = no error and the block ended right after a literal run (the last
// sequence is literals only). Bytes at or past the output length are zero.
//
// Design: every lane reads the token byte (one address, one transaction).
// An extension string is read 32 bytes a step, one a lane, and __ballot_sync
// finds the byte that ends it; a 64 KB literal run has 257 of them, 9 steps.
// Literals are copied by all 32 lanes; a match writes out[op+k] =
// out[op-dist + k % dist], which is exact for overlapping matches and reads
// only bytes before op. __syncwarp() after each copy makes its stores visible
// to the next copy's loads. Output is stored straight to device memory;
// stores at or past out_cap are dropped, and since a match only reads bytes
// before the one it writes, every byte below out_cap is still exact.
//
// With a non-null `steps`, lane 0 also writes the iterations of the
// sequence loop for each chunk: the sequences parsed, the failing one
// included, 0 for a chunk rejected before its first sequence. A null `steps`
// writes nothing more.
//
// What bounds it on this card: the sequences of a chunk are parsed one after
// another, each start depending on the sequence before, so one chunk is a
// serial chain of dependent loads. The card is filled only by the chunks in
// flight (one warp each; an SM holds 64 warps, 132 SMs hold 8448). Left for
// later: staging the output in shared memory so that matches read their
// history there, and coalesced 16-byte stores of finished output.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr unsigned kAllLanes = 0xffffffffu;
constexpr int kMaxOut = 65536;

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
lz4_decode_kernel(const uint8_t* __restrict__ comp,
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

  // Sum of the 255-extension string at ip, and ip moved past it; -1 where
  // the string runs past the chunk or its sum passes 64 KB (the run it
  // lengthens is then malformed whatever follows).
  auto read_ext = [&](int& ip) -> int {
    int sum = 0;
    while (true) {
      const int at = ip + lane;
      const int b = at < clen ? src[at] : -1;
      const unsigned ends = __ballot_sync(kAllLanes, b != 255);
      if (ends == 0) {
        sum += 255 * 32;
        ip += 32;
        if (sum > kMaxOut) return -1;
        continue;
      }
      const int k = __ffs(ends) - 1;
      const int last = __shfl_sync(kAllLanes, b, k);
      if (last < 0) return -1;
      ip += k + 1;
      return sum + 255 * k + last;
    }
  };

  bool err = clen <= 0 || clen > cap;
  bool ended = false;
  int ip = 0;
  int op = 0;
  int count = 0;
  while (!err && ip < clen) {
    ++count;
    const int token = src[ip++];
    int lit = token >> 4;
    if (lit == 15) {
      const int more = read_ext(ip);
      err = more < 0;
      if (err) break;
      lit += more;
    }
    err = ip + lit > clen || op + lit > kMaxOut;
    if (err) break;
    const int n_lit = min(lit, out_cap - op);
    for (int k = lane; k < n_lit; k += 32) dst[op + k] = src[ip + k];
    op += lit;
    ip += lit;
    __syncwarp();
    if (ip == clen) {  // the last sequence: literals only
      ended = true;
      break;
    }

    err = ip + 2 > clen;
    if (err) break;
    const int dist = src[ip] | (src[ip + 1] << 8);
    ip += 2;
    err = dist == 0 || dist > op;
    if (err) break;
    int ml = token & 15;
    if (ml == 15) {
      const int more = read_ext(ip);
      err = more < 0;
      if (err) break;
      ml += more;
    }
    ml += 4;
    err = op + ml > kMaxOut;
    if (err) break;
    const int n_store = min(ml, out_cap - op);
    const uint8_t* from = dst + (op - dist);
    for (int k = lane; k < n_store; k += 32)
      dst[op + k] = from[dist >= n_store ? k : k % dist];
    op += ml;
    __syncwarp();
  }

  for (int j = min(op, out_cap) + lane; j < out_cap; j += 32) dst[j] = 0;
  if (lane == 0) {
    out_lens[chunk] = op;
    ok[chunk] = !err && ended;
    if (steps != nullptr) steps[chunk] = count;
  }
}

}  // namespace

// Launches the decode on `stream` and returns cudaGetLastError(). The caller
// allocates every buffer: out (batch, out_cap) uint8, out_lens (batch,)
// int32, ok (batch,) bool, and steps (batch,) int32 or null.
extern "C" int acx_lz4_decode(const void* comp, const void* comp_lens,
                              int batch, int cap, void* out, void* out_lens,
                              void* ok, int out_cap, void* steps, void* stream) {
  if (batch > 0) {
    const int blocks = (batch + kWarpsPerBlock - 1) / kWarpsPerBlock;
    lz4_decode_kernel<<<blocks, kWarpsPerBlock * 32, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(comp),
        static_cast<const int32_t*>(comp_lens), batch, cap,
        static_cast<uint8_t*>(out), static_cast<int32_t*>(out_lens),
        static_cast<uint8_t*>(ok), out_cap, static_cast<int32_t*>(steps));
  }
  return static_cast<int>(cudaGetLastError());
}
