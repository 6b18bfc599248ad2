// Batched XXH64 with a seed, one thread per stream.
//
// Replaces the TPU kernel aircompressor_tpu/ops/xxhash_pallas.py::_stripe_kernel
// together with the merge, tail and avalanche that ran after it as jnp code
// (xxhash_pallas.py::_finalize). One thread holds one stream's whole state, so
// the finalize costs nothing extra inside the kernel. Arithmetic is native
// uint64_t; the TPU's u32-pair emulation is not needed. Row i of a (B, L)
// uint8 batch is hashed over its first lengths[i] bytes, clamped to [0, L] so
// that no read leaves the row. Any B and L are accepted.
//
// What bounds it on this card: each stream's stripe loop is sequential, and a
// warp's 32 threads read 32 rows that lie L bytes apart, so its loads are not
// coalesced; with one thread per stream, 4096 streams are 128 warps, one per
// SM. Left for later: splitting a stream across the lanes of a warp
// (stripe-parallel accumulate, then a shuffle merge) and staging rows through
// shared memory with coalesced loads.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreadsPerBlock = 128;
constexpr uint64_t kP1 = 0x9E3779B185EBCA87ull;
constexpr uint64_t kP2 = 0xC2B2AE3D27D4EB4Full;
constexpr uint64_t kP3 = 0x165667B19E3779F9ull;
constexpr uint64_t kP4 = 0x85EBCA77C2B2AE63ull;
constexpr uint64_t kP5 = 0x27D4EB2F165667C5ull;

__device__ __forceinline__ uint64_t rotl(uint64_t x, int r) {
  return (x << r) | (x >> (64 - r));
}

__device__ __forceinline__ uint64_t round64(uint64_t acc, uint64_t lane) {
  return rotl(acc + lane * kP2, 31) * kP1;
}

__device__ __forceinline__ uint64_t merge64(uint64_t h, uint64_t v) {
  return (h ^ round64(0, v)) * kP1 + kP4;
}

// Little-endian loads; kAligned when every row starts on an 8-byte boundary,
// which makes the 8-byte loads at stripe and tail offsets aligned too.
template <bool kAligned>
__device__ __forceinline__ uint64_t load64(const uint8_t* p) {
  if constexpr (kAligned) return *reinterpret_cast<const uint64_t*>(p);
  uint64_t v = 0;
  for (int k = 7; k >= 0; --k) v = (v << 8) | p[k];
  return v;
}

template <bool kAligned>
__device__ __forceinline__ uint64_t load32(const uint8_t* p) {
  if constexpr (kAligned) return *reinterpret_cast<const uint32_t*>(p);
  uint32_t v = 0;
  for (int k = 3; k >= 0; --k) v = (v << 8) | p[k];
  return v;
}

template <bool kAligned>
__global__ void __launch_bounds__(kThreadsPerBlock)
xxh64_kernel(const uint8_t* __restrict__ data,
             const int32_t* __restrict__ lengths, int batch, int row_len,
             uint64_t seed, uint64_t* __restrict__ out) {
  const int row = blockIdx.x * kThreadsPerBlock + threadIdx.x;
  if (row >= batch) return;
  const uint8_t* p = data + static_cast<size_t>(row) * row_len;
  const int n = min(max(lengths[row], 0), row_len);

  int off = 0;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = seed + kP1 + kP2, v2 = seed + kP2, v3 = seed, v4 = seed - kP1;
    for (; off + 32 <= n; off += 32) {
      v1 = round64(v1, load64<kAligned>(p + off));
      v2 = round64(v2, load64<kAligned>(p + off + 8));
      v3 = round64(v3, load64<kAligned>(p + off + 16));
      v4 = round64(v4, load64<kAligned>(p + off + 24));
    }
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = merge64(h, v1);
    h = merge64(h, v2);
    h = merge64(h, v3);
    h = merge64(h, v4);
  } else {
    h = seed + kP5;
  }
  h += static_cast<uint64_t>(n);

  for (; off + 8 <= n; off += 8)
    h = rotl(h ^ round64(0, load64<kAligned>(p + off)), 27) * kP1 + kP4;
  if (off + 4 <= n) {
    h = rotl(h ^ (load32<kAligned>(p + off) * kP1), 23) * kP2 + kP3;
    off += 4;
  }
  for (; off < n; ++off) h = rotl(h ^ (p[off] * kP5), 11) * kP1;

  h ^= h >> 33;
  h *= kP2;
  h ^= h >> 29;
  h *= kP3;
  h ^= h >> 32;
  out[row] = h;
}

}  // namespace

// Launches the hash with `seed` on `stream` and returns cudaGetLastError().
// out is a (batch,) int64 buffer that receives each hash's 64 bits.
extern "C" int acx_xxh64(const void* data, const void* lengths, int batch,
                         int row_len, uint64_t seed, void* out, void* stream) {
  if (batch > 0) {
    const int blocks = (batch + kThreadsPerBlock - 1) / kThreadsPerBlock;
    const bool aligned =
        reinterpret_cast<uintptr_t>(data) % 8 == 0 && row_len % 8 == 0;
    auto* s = static_cast<cudaStream_t>(stream);
    const auto* d = static_cast<const uint8_t*>(data);
    const auto* l = static_cast<const int32_t*>(lengths);
    auto* o = static_cast<uint64_t*>(out);
    if (aligned)
      xxh64_kernel<true><<<blocks, kThreadsPerBlock, 0, s>>>(d, l, batch, row_len, seed, o);
    else
      xxh64_kernel<false><<<blocks, kThreadsPerBlock, 0, s>>>(d, l, batch, row_len, seed, o);
  }
  return static_cast<int>(cudaGetLastError());
}
