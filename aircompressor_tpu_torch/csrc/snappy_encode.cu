// Snappy block encode for a batch of chunks of at most 64 KB, one warp per chunk.
//
// Replaces the TPU kernel aircompressor_tpu/ops/snappy_encode_pallas.py::
// _encode_kernel and computes what it computes, byte for byte: a (B, cap)
// uint8 batch with (B,) int32 lengths (clamped to [0, cap]) gives (B, 76800)
// Snappy blocks, zero at and past each length, (B,) int32 lengths and (B,)
// ok flags. The matcher (see ops/snappy_encode.py for the list): varint
// header; one 2^14-entry hash table per chunk, hash (u32le(p) * 0x1E35A7BD)
// >> 18; scan while ip < len - 15, inserting every probed ip and taking the
// entry before the insert as the candidate, ip += skip >> 5 and ++skip on a
// miss; forward extension to the chunk's end; backward extension by at most
// min(ip - anchor, cand, 127) bytes, keeping the offset; copies in pieces of
// 64 / 60 / rest; after a match mend - 1 enters the table, ip = anchor =
// mend, skip = 32; the tail is one literal run.
//
// Design: the whole warp walks the same chunk. The hash table lives in
// shared memory as uint16 positions (32 KB a block), 0xffff for "empty":
// every stored position is below 65521, so an empty entry fails the
// cand < ip test by itself. Lane 0 reads and writes the table and
// __shfl_sync hands the candidate to every lane, so control flow stays the
// same on all lanes. Forward and backward extension compare 32 bytes a step,
// one per lane, and __ballot_sync finds the first mismatch. Literal bytes
// and the 64-byte copy pieces are written by all 32 lanes. The table insert
// after a match is made only where a later probe can read it (mend < len -
// 15), so no byte at or past a chunk's length is ever read.
//
// With a non-null `steps`, lane 0 also writes the iterations of the
// match-search loop for each chunk: the probes of the scan, a probe that hits
// and the match it emits being one. A null `steps` writes nothing more.
//
// What bounds it on this card: the scan is a serial chain per chunk, each
// probe's position depending on the probe before, with a table lookup and a
// load of the candidate's bytes on its path. The card is filled only by the
// chunks in flight: the 32 KB table allows 6 blocks (6 chunks) an SM, 792 on
// 132 SMs. Left for later: speculative probing of the next positions on
// idle lanes, staging the input in shared memory, more chunks an SM.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kHashLog = 14;
constexpr int kTableSize = 1 << kHashLog;
constexpr int kOutCap = 76800;
constexpr int kInputMargin = 15;
constexpr unsigned kAllLanes = 0xffffffffu;

__device__ __forceinline__ uint32_t load_u32(const uint8_t* p) {
  return static_cast<uint32_t>(p[0]) | (static_cast<uint32_t>(p[1]) << 8) |
         (static_cast<uint32_t>(p[2]) << 16) | (static_cast<uint32_t>(p[3]) << 24);
}

__device__ __forceinline__ int hash_of(uint32_t word) {
  return static_cast<int>((word * 0x1E35A7BDu) >> (32 - kHashLog));
}

__global__ void __launch_bounds__(32)
snappy_encode_kernel(const uint8_t* __restrict__ data,
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

  // Varint length header, at most 3 bytes for n <= 65536.
  int op = n < 128 ? 1 : (n < (1 << 14) ? 2 : 3);
  if (lane == 0) {
    int m = n;
    for (int k = 0; k < op; ++k, m >>= 7) put(k, k + 1 < op ? (m & 127) | 128 : m);
  }

  auto emit_literal = [&](int from, int len) {
    const int n1 = len - 1;
    const int hlen = n1 < 60 ? 1 : (n1 < 256 ? 2 : 3);
    if (lane == 0) {
      put(op, n1 < 60 ? n1 << 2 : (n1 < 256 ? 60 << 2 : 61 << 2));
      if (hlen >= 2) put(op + 1, n1 & 255);
      if (hlen == 3) put(op + 2, n1 >> 8);
    }
    op += hlen;
    for (int k = lane; k < len; k += 32) put(op + k, src[from + k]);
    op += len;
  };

  auto emit_copy = [&](int len, int dist) {
    const int n64 = len >= 68 ? (len - 68) / 64 + 1 : 0;
    for (int i = lane; i < n64; i += 32) {
      put(op + 3 * i, 2 | (63 << 2));
      put(op + 3 * i + 1, dist & 255);
      put(op + 3 * i + 2, dist >> 8);
    }
    op += 3 * n64;
    int rest = len - 64 * n64;
    if (rest > 64) {
      if (lane == 0) {
        put(op, 2 | (59 << 2));
        put(op + 1, dist & 255);
        put(op + 2, dist >> 8);
      }
      op += 3;
      rest -= 60;
    }
    if (rest <= 11 && dist < 2048) {
      if (lane == 0) {
        put(op, 1 | ((rest - 4) << 2) | ((dist >> 8) << 5));
        put(op + 1, dist & 255);
      }
      op += 2;
    } else {
      if (lane == 0) {
        put(op, 2 | ((rest - 1) << 2));
        put(op + 1, dist & 255);
        put(op + 2, dist >> 8);
      }
      op += 3;
    }
  };

  int ip = 0;
  int anchor = 0;
  int skip = 32;
  int count = 0;
  while (ip < n - kInputMargin) {
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
      ip += skip >> 5;
      ++skip;
      continue;
    }

    // Forward: the first lane whose byte differs, or lies at or past n.
    int mlen = 4;
    while (true) {
      const int a = ip + mlen + lane;
      const bool diff = a >= n || src[a] != src[cand + mlen + lane];
      const unsigned mask = __ballot_sync(kAllLanes, diff);
      if (mask) {
        mlen += __ffs(mask) - 1;
        break;
      }
      mlen += 32;
    }
    const int mend = ip + mlen;

    // Backward: bytes ip-1-k against cand-1-k for k < room.
    const int room = min(min(ip - anchor, cand), 127);
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

    if (ip - back > anchor) emit_literal(anchor, ip - back - anchor);
    emit_copy(mlen + back, ip - cand);
    if (lane == 0 && mend < n - kInputMargin)
      table[hash_of(load_u32(src + mend - 1))] = static_cast<uint16_t>(mend - 1);
    ip = mend;
    anchor = mend;
    skip = 32;
  }
  if (n > anchor) emit_literal(anchor, n - anchor);

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
// allocates every buffer: comp (batch, 76800) uint8, comp_lens (batch,)
// int32, ok (batch,) bool, steps (batch,) int32 or null; data rows must
// start 16-byte aligned in comp.
extern "C" int acx_snappy_encode(const void* data, const void* lengths,
                                 int batch, int cap, void* comp,
                                 void* comp_lens, void* ok, void* steps,
                                 void* stream) {
  if (batch > 0) {
    static const cudaError_t carveout = cudaFuncSetAttribute(
        snappy_encode_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
        static_cast<int>(cudaSharedmemCarveoutMaxShared));
    if (carveout != cudaSuccess) return static_cast<int>(carveout);
    snappy_encode_kernel<<<batch, 32, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(data), static_cast<const int32_t*>(lengths),
        cap, static_cast<uint8_t*>(comp), static_cast<int32_t*>(comp_lens),
        static_cast<uint8_t*>(ok), static_cast<int32_t*>(steps));
  }
  return static_cast<int>(cudaGetLastError());
}
