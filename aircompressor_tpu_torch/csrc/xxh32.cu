// Batched XXH32 with a seed, one lane per accumulator over staged loads.
//
// Replaces aircompressor_tpu/ops/xxhash_jax.py::xxh32, which is XLA there, not
// Pallas: each 16-byte stripe depends on the one before, so in tensor ops a
// 64 KB stream is a loop of 4096 dependent steps. Row i of a (B, L) uint8
// batch is hashed over its first lengths[i] bytes, clamped to [0, L] so that
// no read leaves the row; the 32 hash bits are written to an int64 slot. Any
// B and L are accepted.
//
// Design, that of csrc/xxh64.cu. XXH32 keeps four accumulators v1..v4;
// accumulator j takes bytes 4j..4j+3 of every 16-byte stripe, in order. The
// stripes of one accumulator cannot be split (each round feeds the next),
// but the four are independent. So four lanes hold one stream's v1..v4 and a
// warp hashes up to 8 streams. After the stripe loop the first lane of each
// stream gathers v2..v4 by __shfl_sync and runs the rotate-sum, the length
// add, the tail of <= 3 words and <= 3 bytes and the avalanche in the
// reference's order. A block is one warp with 1, 2, 4 or 8 streams: the
// fewest that keep the batch within 4 blocks an SM (528 blocks), at most 8.
// A warp issues each instruction for all its lanes at once, so a small batch
// runs fastest spread one stream a warp (256 streams: 256 warps, the chains
// side by side), and a large one as few warps of 8 streams (4096 streams:
// 512 warps, where 4096 warps of one stream would issue eight times the
// instructions and take longer).
//
// Staged variant (rows 16-byte aligned: base and L % 16 == 0): each stream
// has a ring of 4 stages of 1 KB (64 stripes) in dynamic shared memory
// (4,112 B a stream, for the warp's streams only); the warp fills a stage
// of every stream by cp.async, 16 B a lane over the 16-byte units of its
// streams, three stages ahead of the one it hashes (24 KB in flight a warp
// of 8 streams). A whole stage is hashed with no
// branch: its 64 shared-memory reads and the lanes' products (4 bytes times
// PRIME32_2) are off the chain, and a round on the chain is a funnel shift
// and one IMAD (the running value is kept as acc + lane * PRIME32_2, and the
// IMAD is inline PTX so that the compiler does not fold the lane's product
// back into it). A stream's ring is padded by 16 bytes, so the 8 streams'
// 16-byte stripes fall on distinct banks and the 32 lanes' 4-byte reads take
// one wavefront. Other rows take the plain variant: the same lanes and
// merge, each lane reading its 4 bytes from device memory a byte at a time.
// It is exact, only slower.
//
// What bounds it on this card: at 4096 streams of 64 KB, the 268 MB read
// (0.080 ms at 3.35 TB/s). At 256 streams, the serial chain of each
// accumulator: 4,096 dependent rounds, each a funnel shift and an IMAD
// (the compiler's own form of round32 puts three instructions on the chain:
// an IMAD, a funnel shift and an IMUL). Left for later: fusing the hash into
// the decode kernel that produced the bytes, which saves the read.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kP1 = 2654435761u;
constexpr uint32_t kP2 = 2246822519u;
constexpr uint32_t kP3 = 3266489917u;
constexpr uint32_t kP4 = 668265263u;
constexpr uint32_t kP5 = 374761393u;
constexpr unsigned kAllLanes = 0xffffffffu;
constexpr int kMaxStreams = 8;                 // streams a warp
constexpr int kStage = 1024;                   // bytes of one stream a stage
constexpr int kSlots = 4;                      // stages in a stream's ring
constexpr int kStride = kSlots * kStage + 16;  // a stream's ring, padded
constexpr int kSms = 132;
constexpr int kBlocksPerSm = 4;  // blocks an SM up to which a warp takes fewer than 8 streams

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// a * PRIME32_1 + c as one IMAD that the compiler cannot split.
__device__ __forceinline__ uint32_t mad_p1(uint32_t a, uint32_t c) {
  uint32_t d;
  asm("mad.lo.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(kP1), "r"(c));
  return d;
}

__device__ __forceinline__ uint32_t round32(uint32_t acc, uint32_t lane) {
  return rotl(acc + lane * kP2, 13) * kP1;
}

// Little-endian load; kAligned when the 4-byte word is aligned.
template <bool kAligned>
__device__ __forceinline__ uint32_t load32(const uint8_t* p) {
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
xxh32_kernel(const uint8_t* __restrict__ data,
             const int32_t* __restrict__ lengths, int batch, int row_len,
             uint32_t seed, int64_t* __restrict__ out, int streams) {
  const int lane = threadIdx.x;
  const int g = lane >> 2;  // this lane's stream in the warp
  const int j = lane & 3;   // and its accumulator
  const int row = blockIdx.x * streams + g;
  const bool active = g < streams && row < batch;
  const uint8_t* p = data + static_cast<size_t>(active ? row : 0) * row_len;
  const int n = active ? min(max(lengths[row], 0), row_len) : 0;
  const int stripes = n >> 4;

  uint32_t v = j == 0 ? seed + kP1 + kP2
             : j == 1 ? seed + kP2
             : j == 2 ? seed : seed - kP1;
  if constexpr (kStaged) {
    extern __shared__ __align__(16) uint8_t ring[];  // streams * kStride bytes
    // Bytes of stripes of each stream of the warp (0 past the batch).
    int body[kMaxStreams];
#pragma unroll
    for (int s = 0; s < kMaxStreams; ++s)
      body[s] = 16 * __shfl_sync(kAllLanes, stripes, 4 * s);
    auto body_of = [&](int s) {
      int b = body[0];
#pragma unroll
      for (int k = 1; k < kMaxStreams; ++k) b = s == k ? body[k] : b;
      return b;
    };
    const int stages = (16 * __reduce_max_sync(kAllLanes, stripes) + kStage - 1) / kStage;
    const uint8_t* base = data + static_cast<size_t>(blockIdx.x) * streams * row_len;
    // Stage t of every stream into slot t % kSlots; one group, empty or not.
    auto issue = [&](int t) {
      if (t < stages) {
        const int off = t * kStage;
        uint8_t* slot = ring + (t % kSlots) * kStage;
        constexpr int kUnits = kStage / 16;  // unit c: stream c / kUnits, bytes 16 (c % kUnits) on
        for (int c = lane; c < streams * kUnits; c += 32) {
          const int s = c / kUnits, at = off + 16 * (c % kUnits);
          if (at < body_of(s))
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
      const uint8_t* at = ring + g * kStride + (t % kSlots) * kStage + 4 * j;
      const int rounds = active ? min(kStage / 16, stripes - t * (kStage / 16)) : 0;
      if (rounds == kStage / 16) {  // a whole stage: no branch, so the reads go first
        uint32_t x[kStage / 16];  // the lanes' products, off the chain
#pragma unroll
        for (int r = 0; r < kStage / 16; ++r)
          x[r] = *reinterpret_cast<const uint32_t*>(at + 16 * r) * kP2;
        uint32_t s = v + x[0];
#pragma unroll
        for (int r = 1; r < kStage / 16; ++r) s = mad_p1(rotl(s, 13), x[r]);
        v = rotl(s, 13) * kP1;
      } else {
        for (int r = 0; r < rounds; ++r)
          v = round32(v, *reinterpret_cast<const uint32_t*>(at + 16 * r));
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  } else {
    for (int s = 0; s < stripes; ++s) v = round32(v, load32<false>(p + 16 * s + 4 * j));
  }

  const int first = lane & ~3;
  const uint32_t v1 = __shfl_sync(kAllLanes, v, first);
  const uint32_t v2 = __shfl_sync(kAllLanes, v, first + 1);
  const uint32_t v3 = __shfl_sync(kAllLanes, v, first + 2);
  const uint32_t v4 = __shfl_sync(kAllLanes, v, first + 3);
  if (!active || j != 0) return;

  uint32_t h = n >= 16 ? rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18)
                       : seed + kP5;
  h += static_cast<uint32_t>(n);

  int off = 16 * stripes;
  for (; off + 4 <= n; off += 4) h = rotl(h + load32<kStaged>(p + off) * kP3, 17) * kP4;
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
    int streams = 1;  // a warp's streams: 1, 2, 4 or 8, spreading the batch
    while (streams < kMaxStreams && (batch + streams - 1) / streams > kBlocksPerSm * kSms)
      streams *= 2;
    const int blocks = (batch + streams - 1) / streams;
    const bool staged =
        reinterpret_cast<uintptr_t>(data) % 16 == 0 && row_len % 16 == 0;
    auto* s = static_cast<cudaStream_t>(stream);
    const auto* d = static_cast<const uint8_t*>(data);
    const auto* l = static_cast<const int32_t*>(lengths);
    auto* o = static_cast<int64_t*>(out);
    if (staged) {
      static const cudaError_t carveout = cudaFuncSetAttribute(
          xxh32_kernel<true>, cudaFuncAttributePreferredSharedMemoryCarveout,
          static_cast<int>(cudaSharedmemCarveoutMaxShared));
      if (carveout != cudaSuccess) return static_cast<int>(carveout);
      xxh32_kernel<true><<<blocks, 32, streams * kStride, s>>>(d, l, batch, row_len, seed, o,
                                                               streams);
    } else {
      xxh32_kernel<false><<<blocks, 32, 0, s>>>(d, l, batch, row_len, seed, o, streams);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
