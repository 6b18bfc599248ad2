// Batched XXH64 with a seed, one lane per accumulator over staged loads.
//
// Replaces the TPU kernel aircompressor_tpu/ops/xxhash_pallas.py::_stripe_kernel
// together with the merge, tail and avalanche that ran after it as jnp code
// (xxhash_pallas.py::_finalize). Arithmetic is native uint64_t; the TPU's
// u32-pair emulation is not needed. Row i of a (B, L) uint8 batch is hashed
// over its first lengths[i] bytes, clamped to [0, L] so that no read leaves
// the row. Any B and L are accepted.
//
// Design. XXH64 keeps four accumulators v1..v4; accumulator j takes bytes
// 8j..8j+7 of every 32-byte stripe, in order. The stripes of one accumulator
// cannot be split (each round feeds the next), but the four are independent.
// So four lanes hold one stream's v1..v4 and a warp hashes up to 8 streams.
// After the stripe loop the first lane of each stream gathers v2..v4 by
// __shfl_sync and runs the merge, the <= 31-byte tail and the avalanche in
// the reference's order. A block is one warp with 1, 2, 4 or 8 streams: the
// fewest that fit the batch in 132 blocks, at most 8. So 256 streams take 128
// SMs and 4096 streams all 132.
//
// Staged variant (rows 16-byte aligned: base and L % 16 == 0): each stream
// has a ring of 8 stages of 512 B in shared memory; the warp fills a stage
// of every stream by cp.async, 16 B a lane and 512 B of one stream a load
// instruction, seven stages ahead of the one it hashes (28 KB in flight a
// warp of 8 streams, ~110 KB an SM at 4096 streams, against the ~20 KB that
// 3.35 TB/s x ~0.8 us over 132 SMs needs). A whole stage is hashed with no
// branch, so its shared-memory reads are issued ahead of the chain. A
// stream's ring is padded by 32 bytes, so the 8 streams' 32-byte stripes
// fall on distinct banks and the 32 lanes' 8-byte reads take the two
// wavefronts 256 bytes need. Other rows take the plain variant: the same
// lanes and merge, each lane reading its 8 bytes from device memory a byte
// at a time. It is exact, only slower.
//
// What bounds it on this card: at 4096 streams of 64 KB, the 268 MB read
// (0.080 ms at 3.35 TB/s). At 256 streams, the serial chain of each
// accumulator: 2,048 dependent rounds of a 64-bit add, rotate and multiply
// (~35 cycles each if nothing else waits, ~40 us). Left for later: fusing
// the hash into the decode kernel that produced the bytes, which saves the
// read.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint64_t kP1 = 0x9E3779B185EBCA87ull;
constexpr uint64_t kP2 = 0xC2B2AE3D27D4EB4Full;
constexpr uint64_t kP3 = 0x165667B19E3779F9ull;
constexpr uint64_t kP4 = 0x85EBCA77C2B2AE63ull;
constexpr uint64_t kP5 = 0x27D4EB2F165667C5ull;
constexpr unsigned kAllLanes = 0xffffffffu;
constexpr int kMaxStreams = 8;                 // streams a warp
constexpr int kStage = 512;                    // bytes of one stream a stage
constexpr int kSlots = 8;                      // stages in a stream's ring
constexpr int kStride = kSlots * kStage + 32;  // a stream's ring, padded
constexpr int kSms = 132;

__device__ __forceinline__ uint64_t rotl(uint64_t x, int r) {
  return (x << r) | (x >> (64 - r));
}

__device__ __forceinline__ uint64_t round64(uint64_t acc, uint64_t lane) {
  return rotl(acc + lane * kP2, 31) * kP1;
}

__device__ __forceinline__ uint64_t merge64(uint64_t h, uint64_t v) {
  return (h ^ round64(0, v)) * kP1 + kP4;
}

// Little-endian loads; kAligned when the 8- or 4-byte word is aligned.
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

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

template <bool kStaged>
__global__ void __launch_bounds__(32)
xxh64_kernel(const uint8_t* __restrict__ data,
             const int32_t* __restrict__ lengths, int batch, int row_len,
             uint64_t seed, uint64_t* __restrict__ out, int streams) {
  const int lane = threadIdx.x;
  const int g = lane >> 2;  // this lane's stream in the warp
  const int j = lane & 3;   // and its accumulator
  const int row = blockIdx.x * streams + g;
  const bool active = g < streams && row < batch;
  const uint8_t* p = data + static_cast<size_t>(active ? row : 0) * row_len;
  const int n = active ? min(max(lengths[row], 0), row_len) : 0;
  const int stripes = n >> 5;

  uint64_t v = j == 0 ? seed + kP1 + kP2
             : j == 1 ? seed + kP2
             : j == 2 ? seed : seed - kP1;
  if constexpr (kStaged) {
    __shared__ __align__(16) uint8_t ring[kMaxStreams * kStride];
    // Bytes of stripes of each stream of the warp (0 past the batch).
    int body[kMaxStreams];
#pragma unroll
    for (int s = 0; s < kMaxStreams; ++s)
      body[s] = 32 * __shfl_sync(kAllLanes, stripes, 4 * s);
    const int stages = (32 * __reduce_max_sync(kAllLanes, stripes) + kStage - 1) / kStage;
    const uint8_t* base = data + static_cast<size_t>(blockIdx.x) * streams * row_len;
    // Stage t of every stream into slot t % kSlots; one group, empty or not.
    auto issue = [&](int t) {
      if (t < stages) {
        const int off = t * kStage;
        uint8_t* slot = ring + (t % kSlots) * kStage;
#pragma unroll
        for (int s = 0; s < kMaxStreams; ++s) {  // a stage of stream s: 16 B a lane
          const int at = off + 16 * lane;
          if (s < streams && at < body[s])
            cp_async16(slot + s * kStride + (at - off),
                       base + static_cast<size_t>(s) * row_len + at);
        }
      }
      asm volatile("cp.async.commit_group;\n" ::);
    };
#pragma unroll
    for (int t = 0; t < kSlots - 1; ++t) issue(t);
    for (int t = 0; t < stages; ++t) {
      asm volatile("cp.async.wait_group %0;\n" ::"n"(kSlots - 2) : "memory");
      __syncwarp();  // stage t has landed; slot (t - 1) % kSlots is free
      issue(t + kSlots - 1);
      const uint8_t* at = ring + g * kStride + (t % kSlots) * kStage + 8 * j;
      const int rounds = active ? min(kStage / 32, stripes - t * (kStage / 32)) : 0;
      if (rounds == kStage / 32) {  // a whole stage: no branch, so the reads go first
#pragma unroll
        for (int r = 0; r < kStage / 32; ++r)
          v = round64(v, *reinterpret_cast<const uint64_t*>(at + 32 * r));
      } else {
        for (int r = 0; r < rounds; ++r)
          v = round64(v, *reinterpret_cast<const uint64_t*>(at + 32 * r));
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  } else {
    for (int s = 0; s < stripes; ++s) v = round64(v, load64<false>(p + 32 * s + 8 * j));
  }

  const int first = lane & ~3;
  const uint64_t v1 = __shfl_sync(kAllLanes, v, first);
  const uint64_t v2 = __shfl_sync(kAllLanes, v, first + 1);
  const uint64_t v3 = __shfl_sync(kAllLanes, v, first + 2);
  const uint64_t v4 = __shfl_sync(kAllLanes, v, first + 3);
  if (!active || j != 0) return;

  uint64_t h;
  if (n >= 32) {
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = merge64(h, v1);
    h = merge64(h, v2);
    h = merge64(h, v3);
    h = merge64(h, v4);
  } else {
    h = seed + kP5;
  }
  h += static_cast<uint64_t>(n);

  int off = 32 * stripes;
  for (; off + 8 <= n; off += 8)
    h = rotl(h ^ round64(0, load64<kStaged>(p + off)), 27) * kP1 + kP4;
  if (off + 4 <= n) {
    h = rotl(h ^ (load32<kStaged>(p + off) * kP1), 23) * kP2 + kP3;
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
    int streams = 1;  // a warp's streams: 1, 2, 4 or 8, spreading the batch
    while (streams < kMaxStreams && streams * kSms < batch) streams *= 2;
    const int blocks = (batch + streams - 1) / streams;
    const bool staged =
        reinterpret_cast<uintptr_t>(data) % 16 == 0 && row_len % 16 == 0;
    auto* s = static_cast<cudaStream_t>(stream);
    const auto* d = static_cast<const uint8_t*>(data);
    const auto* l = static_cast<const int32_t*>(lengths);
    auto* o = static_cast<uint64_t*>(out);
    if (staged) {
      static const cudaError_t carveout = cudaFuncSetAttribute(
          xxh64_kernel<true>, cudaFuncAttributePreferredSharedMemoryCarveout,
          static_cast<int>(cudaSharedmemCarveoutMaxShared));
      if (carveout != cudaSuccess) return static_cast<int>(carveout);
      xxh64_kernel<true><<<blocks, 32, 0, s>>>(d, l, batch, row_len, seed, o, streams);
    } else {
      xxh64_kernel<false><<<blocks, 32, 0, s>>>(d, l, batch, row_len, seed, o, streams);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
