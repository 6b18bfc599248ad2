// Batched XXH32 with a seed, one thread per stream.
//
// Replaces aircompressor_tpu/ops/xxhash_jax.py::xxh32, which is XLA there, not
// Pallas: each 16-byte stripe depends on the one before, so in tensor ops a
// 64 KB stream is a loop of 4096 dependent steps, each a launch. One thread
// here holds one stream's state through stripes, tail and avalanche. Row i of
// a (B, L) uint8 batch is hashed over its first lengths[i] bytes, clamped to
// [0, L] so that no read leaves the row; the 32 hash bits are written to an
// int64 slot. Any B and L are accepted.
//
// What bounds it on this card: as for csrc/xxh64.cu, each stream's stripe
// loop is sequential and a warp's 32 threads read 32 rows that lie L bytes
// apart, so loads are not coalesced. Left for later: splitting a stream
// across the lanes of a warp (stripe-parallel accumulate, then a shuffle
// merge) and staging rows through shared memory.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreadsPerBlock = 128;
constexpr uint32_t kP1 = 2654435761u;
constexpr uint32_t kP2 = 2246822519u;
constexpr uint32_t kP3 = 3266489917u;
constexpr uint32_t kP4 = 668265263u;
constexpr uint32_t kP5 = 374761393u;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ uint32_t round32(uint32_t acc, uint32_t lane) {
  return rotl(acc + lane * kP2, 13) * kP1;
}

// Little-endian load; kAligned when every row starts on a 4-byte boundary,
// which makes the loads at stripe and tail offsets aligned too.
template <bool kAligned>
__device__ __forceinline__ uint32_t load32(const uint8_t* p) {
  if constexpr (kAligned) return *reinterpret_cast<const uint32_t*>(p);
  uint32_t v = 0;
  for (int k = 3; k >= 0; --k) v = (v << 8) | p[k];
  return v;
}

template <bool kAligned>
__global__ void __launch_bounds__(kThreadsPerBlock)
xxh32_kernel(const uint8_t* __restrict__ data,
             const int32_t* __restrict__ lengths, int batch, int row_len,
             uint32_t seed, int64_t* __restrict__ out) {
  const int row = blockIdx.x * kThreadsPerBlock + threadIdx.x;
  if (row >= batch) return;
  const uint8_t* p = data + static_cast<size_t>(row) * row_len;
  const int n = min(max(lengths[row], 0), row_len);

  int off = 0;
  uint32_t h;
  if (n >= 16) {
    uint32_t v1 = seed + kP1 + kP2, v2 = seed + kP2, v3 = seed, v4 = seed - kP1;
    for (; off + 16 <= n; off += 16) {
      v1 = round32(v1, load32<kAligned>(p + off));
      v2 = round32(v2, load32<kAligned>(p + off + 4));
      v3 = round32(v3, load32<kAligned>(p + off + 8));
      v4 = round32(v4, load32<kAligned>(p + off + 12));
    }
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
  } else {
    h = seed + kP5;
  }
  h += static_cast<uint32_t>(n);

  for (; off + 4 <= n; off += 4) h = rotl(h + load32<kAligned>(p + off) * kP3, 17) * kP4;
  for (; off < n; ++off) h = rotl(h + p[off] * kP5, 11) * kP1;

  h ^= h >> 15;
  h *= kP2;
  h ^= h >> 13;
  h *= kP3;
  h ^= h >> 16;
  out[row] = static_cast<int64_t>(h);
}

}  // namespace

// Launches the hash with `seed` on `stream` and returns cudaGetLastError().
// out is a (batch,) int64 buffer that receives each hash's 32 bits.
extern "C" int acx_xxh32(const void* data, const void* lengths, int batch,
                         int row_len, uint32_t seed, void* out, void* stream) {
  if (batch > 0) {
    const int blocks = (batch + kThreadsPerBlock - 1) / kThreadsPerBlock;
    const bool aligned =
        reinterpret_cast<uintptr_t>(data) % 4 == 0 && row_len % 4 == 0;
    auto* s = static_cast<cudaStream_t>(stream);
    const auto* d = static_cast<const uint8_t*>(data);
    const auto* l = static_cast<const int32_t*>(lengths);
    auto* o = static_cast<int64_t*>(out);
    if (aligned)
      xxh32_kernel<true><<<blocks, kThreadsPerBlock, 0, s>>>(d, l, batch, row_len, seed, o);
    else
      xxh32_kernel<false><<<blocks, kThreadsPerBlock, 0, s>>>(d, l, batch, row_len, seed, o);
  }
  return static_cast<int>(cudaGetLastError());
}
