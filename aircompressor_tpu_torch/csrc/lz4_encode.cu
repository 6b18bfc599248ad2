// LZ4 block encode for a batch of chunks of at most 64 KB, one warp per chunk.
//
// Replaces the TPU kernel aircompressor_tpu/ops/lz4_encode_pallas.py::
// _encode_kernel and computes what it computes, byte for byte: a (B, cap)
// uint8 batch with (B,) int32 lengths (clamped to [0, cap]) gives (B, 66560)
// LZ4 blocks, zero at and past each length, (B,) int32 lengths and (B,) ok
// flags. The matcher (see ops/lz4_encode.py for the list): one 2^14-entry
// hash table per chunk, hash (u32le(p) * 2654435761) >> 18; scan while
// ip < len - 12, inserting every probed ip and taking the entry before the
// insert as the candidate, ip += skip >> 6 and ++skip on a miss (skip starts
// at 64); forward extension from 4 bytes up to len - 5; backward extension
// ("catch up") by at most min(ip - anchor, cand, 127) bytes, keeping the
// offset; token, 255-extension strings whose last byte is always written,
// literals, LE16 offset; after a match mend - 2 enters the table, ip =
// anchor = mend, skip = 64; the tail is one literals-only sequence.
//
// Design: the whole warp walks the same chunk. The hash table lives in
// shared memory as uint16 positions (32 KB a block), 0xffff for "empty":
// every stored position is below 65532, so an empty entry fails the
// cand < ip test by itself. Lane 0 reads and writes the table and
// __shfl_sync hands the candidate to every lane, so control flow stays the
// same on all lanes. Forward and backward extension compare 32 bytes a step,
// one per lane, and __ballot_sync finds the first mismatch. Literal bytes and
// the 0xFF strings of long lengths are written by all 32 lanes. No byte at or
// past a chunk's length is read: a probe reads below len - 8, extension below
// len - 5, the seed at mend - 2 below len - 3.
//
// With a non-null `steps`, lane 0 also writes the iterations of the
// match-search loop for each chunk: the probes of the scan, a probe that hits
// and the match it emits being one. A null `steps` writes nothing more.
//
// What bounds it on this card: the scan is a serial chain per chunk, each
// probe's position depending on the probe before, with a table lookup and a
// load of the candidate's bytes on its path. The card is filled only by the
// chunks in flight: the 32 KB table allows 6 blocks (6 chunks) an SM, 792 on
// 132 SMs. Left for later: speculative probing of the next positions on idle
// lanes, staging the input in shared memory, more chunks an SM.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kHashLog = 14;
constexpr int kTableSize = 1 << kHashLog;
constexpr int kOutCap = 66560;
constexpr int kMatchFindLimit = 12;
constexpr int kLastLiterals = 5;
constexpr int kMinMatch = 4;
constexpr int kBackCap = 127;
constexpr unsigned kAllLanes = 0xffffffffu;

__device__ __forceinline__ uint32_t load_u32(const uint8_t* p) {
  return static_cast<uint32_t>(p[0]) | (static_cast<uint32_t>(p[1]) << 8) |
         (static_cast<uint32_t>(p[2]) << 16) | (static_cast<uint32_t>(p[3]) << 24);
}

__device__ __forceinline__ int hash_of(uint32_t word) {
  return static_cast<int>((word * 2654435761u) >> (32 - kHashLog));
}

__global__ void __launch_bounds__(32)
lz4_encode_kernel(const uint8_t* __restrict__ data,
                  const int32_t* __restrict__ lengths, int cap,
                  uint8_t* __restrict__ comp, int32_t* __restrict__ comp_lens,
                  uint8_t* __restrict__ ok, int32_t* __restrict__ steps) {
  __shared__ uint4 table4[kTableSize * sizeof(uint16_t) / sizeof(uint4)];
  uint16_t* table = reinterpret_cast<uint16_t*>(table4);
  const int lane = threadIdx.x;
  const int chunk = blockIdx.x;
  const uint8_t* src = data + static_cast<size_t>(chunk) * cap;
  uint8_t* dst = comp + static_cast<size_t>(chunk) * kOutCap;
  const int n = min(max(lengths[chunk], 0), cap);

  for (int i = lane; i < kTableSize * 2 / 16; i += 32)
    table4[i] = make_uint4(kAllLanes, kAllLanes, kAllLanes, kAllLanes);
  __syncwarp();

  auto put = [&](int pos, int value) {
    if (pos < kOutCap) dst[pos] = static_cast<uint8_t>(value);
  };

  int op = 0;

  // The 255-extension of a length >= 15: (len - 15) / 255 bytes of 0xFF,
  // then (len - 15) % 255, written even when it is 0.
  auto emit_length = [&](int len) {
    const int rest = len - 15;
    const int fills = rest / 255;
    for (int k = lane; k <= fills; k += 32) put(op + k, k < fills ? 255 : rest % 255);
    op += fills + 1;
  };

  // One sequence: lit literals from `from`, then a match of ml bytes at dist,
  // or none where ml is 0 (the last sequence).
  auto emit_sequence = [&](int from, int lit, int ml, int dist) {
    if (lane == 0) put(op, (min(lit, 15) << 4) | (ml ? min(ml - kMinMatch, 15) : 0));
    ++op;
    if (lit >= 15) emit_length(lit);
    for (int k = lane; k < lit; k += 32) put(op + k, src[from + k]);
    op += lit;
    if (ml) {
      if (lane == 0) {
        put(op, dist & 255);
        put(op + 1, dist >> 8);
      }
      op += 2;
      if (ml - kMinMatch >= 15) emit_length(ml - kMinMatch);
    }
  };

  const int find_limit = n - kMatchFindLimit;
  const int match_limit = n - kLastLiterals;
  int ip = 0;
  int anchor = 0;
  int skip = 64;
  int count = 0;
  while (ip < find_limit) {
    ++count;
    const uint32_t word = load_u32(src + ip);
    const int h = hash_of(word);
    int cand = 0;
    if (lane == 0) {
      cand = table[h];
      table[h] = static_cast<uint16_t>(ip);
    }
    cand = __shfl_sync(kAllLanes, cand, 0);
    if (cand >= ip || load_u32(src + cand) != word) {
      ip += skip >> 6;
      ++skip;
      continue;
    }

    // Forward: the first lane whose byte differs, or lies at or past len - 5.
    int mlen = kMinMatch;
    while (true) {
      const int a = ip + mlen + lane;
      const bool diff = a >= match_limit || src[a] != src[cand + mlen + lane];
      const unsigned mask = __ballot_sync(kAllLanes, diff);
      if (mask) {
        mlen += __ffs(mask) - 1;
        break;
      }
      mlen += 32;
    }
    const int mend = ip + mlen;

    // Backward: bytes ip-1-k against cand-1-k for k < room.
    const int room = min(min(ip - anchor, cand), kBackCap);
    int back = 0;
    while (back < room) {
      const int k = back + lane;
      const bool diff = k >= room || src[ip - 1 - k] != src[cand - 1 - k];
      const unsigned mask = __ballot_sync(kAllLanes, diff);
      if (mask) {
        back += __ffs(mask) - 1;
        break;
      }
      back += 32;
    }

    emit_sequence(anchor, ip - back - anchor, mlen + back, ip - cand);
    if (lane == 0) table[hash_of(load_u32(src + mend - 2))] = static_cast<uint16_t>(mend - 2);
    ip = mend;
    anchor = mend;
    skip = 64;
  }
  emit_sequence(anchor, n - anchor, 0, 0);

  // Zero the rest of the row: bytes up to a 16-byte boundary, then 16 a lane.
  const int aligned = min((op + 15) & ~15, kOutCap);
  for (int j = op + lane; j < aligned; j += 32) dst[j] = 0;
  uint4* dst4 = reinterpret_cast<uint4*>(dst);
  for (int j = aligned / 16 + lane; j < kOutCap / 16; j += 32)
    dst4[j] = make_uint4(0, 0, 0, 0);
  if (lane == 0) {
    comp_lens[chunk] = min(op, kOutCap);
    ok[chunk] = op + 8 <= kOutCap;
    if (steps != nullptr) steps[chunk] = count;
  }
}

}  // namespace

// Launches the encode on `stream` and returns cudaGetLastError(). The caller
// allocates every buffer: comp (batch, 66560) uint8, comp_lens (batch,)
// int32, ok (batch,) bool, steps (batch,) int32 or null; comp must start
// 16-byte aligned.
extern "C" int acx_lz4_encode(const void* data, const void* lengths, int batch,
                              int cap, void* comp, void* comp_lens, void* ok,
                              void* steps, void* stream) {
  if (batch > 0) {
    static const cudaError_t carveout = cudaFuncSetAttribute(
        lz4_encode_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
        static_cast<int>(cudaSharedmemCarveoutMaxShared));
    if (carveout != cudaSuccess) return static_cast<int>(carveout);
    lz4_encode_kernel<<<batch, 32, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(data), static_cast<const int32_t*>(lengths),
        cap, static_cast<uint8_t*>(comp), static_cast<int32_t*>(comp_lens),
        static_cast<uint8_t*>(ok), static_cast<int32_t*>(steps));
  }
  return static_cast<int>(cudaGetLastError());
}
