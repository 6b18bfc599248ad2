// Device code shared by the LZ4 and Snappy block encode kernels
// (lz4_encode.cu, snappy_encode.cu): one warp walks one chunk of at most
// 64 KB, with a 2^14-entry table of uint16 positions in shared memory.
//
// - probe_round: rounds of 32 probes. Between two matches the scan's
//   positions depend only on the round's ip and skip: p(k + 1) = p(k) +
//   ((skip + k) >> shift). skip starts at 1 << shift, grows by one a miss
//   and is reset by a match, and a round ends either with all 32 probes
//   missing or with a match, so skip is a multiple of 32 at every round's
//   start and the step skip >> shift is the same for all 32 lanes: lane k
//   probes ip + k * step. Its candidate is the position of the highest lane
//   below it with the same hash (__match_any_sync), whose word it takes by
//   shuffle, else the table's entry as the round found it: what the k-th
//   serial probe would read. The first lane m that hits ends the round
//   (__ballot_sync); probes 0..m ran, and for each hash only the highest
//   lane <= m that has it writes its position, so the table holds what the
//   serial scan leaves.
// - extend_forward, extend_backward: 128 bytes a ballot, 4 a lane; the first
//   differing byte is the lowest (forward) or highest (backward) differing
//   byte of the first lane with a difference.
// - copy_bytes, fill3: the emitters' literal copies and repeated byte
//   strings, 16 bytes a lane into 16-byte aligned stores, several loads in
//   flight a lane before the stores, bytes at the ragged ends one a lane.
//
// No byte of a chunk at or past its length is read: a word is read with two
// aligned loads only where both aligned words lie inside the chunk, else
// byte by byte.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace acx_encode {

constexpr int kHashLog = 14;
constexpr int kTableSize = 1 << kHashLog;
constexpr unsigned kAllLanes = 0xffffffffu;
constexpr int kCopyUnroll = 4;  // 16-byte blocks a lane has in flight

__device__ __forceinline__ bool inside(const uint8_t* row, int limit, uintptr_t lo, uintptr_t hi) {
  return lo >= reinterpret_cast<uintptr_t>(row) && hi <= reinterpret_cast<uintptr_t>(row + limit);
}

// Bytes pos..pos+3 of the row (little endian); those outside [0, limit) are
// 0 and not read.
__device__ __forceinline__ uint32_t load4(const uint8_t* row, int pos, int limit) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(row + pos);
  const uintptr_t base = a & ~uintptr_t{3};
  const int sh = static_cast<int>(a & 3);
  if (pos >= 0 && inside(row, limit, base, base + (sh ? 8 : 4))) {
    const uint32_t* w = reinterpret_cast<const uint32_t*>(base);
    const uint32_t lo = __ldg(w);
    return sh ? __funnelshift_r(lo, __ldg(w + 1), 8 * sh) : lo;
  }
  uint32_t v = 0;
  for (int i = 0; i < 4; ++i)
    if (pos + i >= 0 && pos + i < limit)
      v |= static_cast<uint32_t>(__ldg(row + pos + i)) << (8 * i);
  return v;
}

__device__ __forceinline__ void prefetch_l2(const uint8_t* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

__device__ __forceinline__ int hash_of(uint32_t word, uint32_t mul) {
  return static_cast<int>((word * mul) >> (32 - kHashLog));
}

struct Round {
  int ran;   // probes that ran: lanes 0..ran-1
  int hit;   // the lane that hit, or -1
  int cand;  // its candidate
};

// One round from ip at `step` (see the file's head); lanes whose position is
// at or past find_limit do not run. ip < find_limit, so lane 0 runs.
__device__ __forceinline__ Round probe_round(const uint8_t* src, int n, uint16_t* table,
                                             uint32_t mul, int ip, int step,
                                             int find_limit, int lane) {
  const int p = ip + lane * step;
  const bool active = p < find_limit;
  const int n_active = __popc(__ballot_sync(kAllLanes, active));  // a prefix
  const uint32_t word = active ? load4(src, p, n) : 0;
  const int h = hash_of(word, mul);
  // Lanes with the same hash; an idle lane matches none.
  const unsigned same = __match_any_sync(kAllLanes, active ? h : (1 << 16) | lane);
  const unsigned prev = same & ((1u << lane) - 1);
  const int from = prev ? 31 - __clz(prev) : lane;
  const int from_p = __shfl_sync(kAllLanes, p, from);
  const uint32_t from_word = __shfl_sync(kAllLanes, word, from);
  int cand = 0xffff;  // empty: fails cand < p
  bool hit = false;
  if (active) {
    if (prev) {
      cand = from_p;
      hit = from_word == word;
    } else {
      cand = table[h];
      hit = cand < p && load4(src, cand, n) == word;
    }
  }
  const unsigned hits = __ballot_sync(kAllLanes, hit);
  const int last = hits ? __ffs(hits) - 1 : n_active - 1;
  const unsigned ran = (2u << last) - 1;
  if (active && lane <= last && !(same & ran & ~((2u << lane) - 1)))
    table[h] = static_cast<uint16_t>(p);
  __syncwarp();
  return Round{last + 1, hits ? last : -1, __shfl_sync(kAllLanes, cand, last)};
}

// The length of the match at ip against cand < ip, 4 bytes known equal: up
// to the first byte that differs or lies at or past `limit`.
__device__ __forceinline__ int extend_forward(const uint8_t* src, int ip, int cand, int limit,
                                              int lane) {
  int mlen = 4;
  while (true) {
    const int a = ip + mlen + 4 * lane;
    const int valid = min(max(limit - a, 0), 4);
    uint32_t diff = valid ? load4(src, a, limit) ^ load4(src, cand + mlen + 4 * lane, limit) : 0;
    if (valid < 4) diff |= 0xffffffffu << (8 * valid);
    const unsigned mask = __ballot_sync(kAllLanes, diff != 0);
    if (mask) {
      const int f = __ffs(mask) - 1;
      const uint32_t fd = __shfl_sync(kAllLanes, diff, f);
      return mlen + 4 * f + ((__ffs(fd) - 1) >> 3);
    }
    mlen += 128;
  }
}

// How far the match at ip against cand extends backward: bytes ip-1-k
// against cand-1-k for k < room <= 127, one ballot (lane l takes k = 4l ..
// 4l+3).
__device__ __forceinline__ int extend_backward(const uint8_t* src, int n, int ip, int cand,
                                               int room, int lane) {
  if (room <= 0) return 0;
  const int q = 4 * lane;  // byte i of the words is k = q + 3 - i
  uint32_t diff = 0;
  if (q < room) diff = load4(src, ip - 4 - q, n) ^ load4(src, cand - 4 - q, n);
  if (q + 4 > room)  // bytes with k >= room differ
    diff |= q >= room ? 0xffffffffu : 0xffffffffu >> (8 * (room - q));
  const unsigned mask = __ballot_sync(kAllLanes, diff != 0);
  const int f = __ffs(mask) - 1;
  const uint32_t fd = __shfl_sync(kAllLanes, diff, f);
  return 4 * f + 3 - ((31 - __clz(fd)) >> 3);
}

// 16 bytes from p, which lie inside the row's first `limit` bytes: aligned
// word loads where the aligned words do too, else byte loads.
__device__ __forceinline__ uint4 load16(const uint8_t* row, int limit, const uint8_t* p) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  const uintptr_t base = a & ~uintptr_t{3};
  const int sh = static_cast<int>(a & 3);
  uint32_t w[5];
  if (inside(row, limit, base, base + (sh ? 20 : 16))) {
    const uint32_t* s = reinterpret_cast<const uint32_t*>(base);
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = __ldg(s + i);
    w[4] = sh ? __ldg(s + 4) : 0;
    const int bits = 8 * sh;
    return make_uint4(__funnelshift_r(w[0], w[1], bits), __funnelshift_r(w[1], w[2], bits),
                      __funnelshift_r(w[2], w[3], bits), __funnelshift_r(w[3], w[4], bits));
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    w[i] = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) w[i] |= static_cast<uint32_t>(__ldg(p + 4 * i + j)) << (8 * j);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// The bytes of dst's 16-byte aligned blocks inside [to, to + len), and the
// ragged head and tail around them, for the copies below.
struct Blocks {
  int head;    // bytes before the first block
  int blocks;  // whole 16-byte blocks
  int tail;    // offset of the bytes after the last block
};

__device__ __forceinline__ Blocks blocks_of(const uint8_t* dst, int to, int len) {
  const int misalign = static_cast<int>(reinterpret_cast<uintptr_t>(dst + to) & 15);
  const int head = min((16 - misalign) & 15, len);
  const int blocks = (len - head) >> 4;
  return Blocks{head, blocks, head + (blocks << 4)};
}

// dst[to..to+len) = row[from..from+len), all lanes; from + len <= limit.
__device__ __forceinline__ void copy_bytes(uint8_t* dst, int to, const uint8_t* row, int limit,
                                           int from, int len, int lane) {
  if (len <= 0) return;
  const Blocks b = blocks_of(dst, to, len);
  if (lane < b.head) dst[to + lane] = __ldg(row + from + lane);
  if (lane < len - b.tail) dst[to + b.tail + lane] = __ldg(row + from + b.tail + lane);
  uint4* d = reinterpret_cast<uint4*>(dst + to + b.head);
  const uint8_t* s = row + from + b.head;
  for (int k = lane; k < b.blocks; k += 32 * kCopyUnroll) {
    uint4 v[kCopyUnroll];
#pragma unroll
    for (int u = 0; u < kCopyUnroll; ++u)
      if (k + 32 * u < b.blocks) v[u] = load16(row, limit, s + 16 * (k + 32 * u));
#pragma unroll
    for (int u = 0; u < kCopyUnroll; ++u)
      if (k + 32 * u < b.blocks) d[k + 32 * u] = v[u];
  }
}

// dst[to + t] = byte t % 3 of pat (little endian) for t < count, all lanes:
// a run of one byte where pat holds it three times, or Snappy's 3-byte copy
// pieces.
__device__ __forceinline__ void fill3(uint8_t* dst, int to, int count, uint32_t pat, int lane) {
  if (count <= 0) return;
  const Blocks b = blocks_of(dst, to, count);
  auto byte_at = [&](int t) { return static_cast<uint8_t>(pat >> (8 * (t % 3))); };
  if (lane < b.head) dst[to + lane] = byte_at(lane);
  if (lane < count - b.tail) dst[to + b.tail + lane] = byte_at(b.tail + lane);
  uint4* d = reinterpret_cast<uint4*>(dst + to + b.head);
  for (int k = lane; k < b.blocks; k += 32) {
    const int r = (b.head + 16 * k) % 3;  // the phase of the block's first byte
    const uint32_t x = ((pat >> (8 * r)) | (pat << (24 - 8 * r))) & 0xffffffu;
    const uint32_t w0 = x | (x << 24), w1 = (x >> 8) | (x << 16), w2 = (x >> 16) | (x << 8);
    d[k] = make_uint4(w0, w1, w2, w0);
  }
}

// Zeroes dst[from..cap) of a 16-byte aligned row of cap bytes (a multiple of
// 16), all lanes.
__device__ __forceinline__ void zero_tail(uint8_t* dst, int from, int cap, int lane) {
  const int aligned = min((from + 15) & ~15, cap);
  for (int j = from + lane; j < aligned; j += 32) dst[j] = 0;
  uint4* dst4 = reinterpret_cast<uint4*>(dst);
  for (int j = aligned / 16 + lane; j < cap / 16; j += 32) dst4[j] = make_uint4(0, 0, 0, 0);
}

// Sets the kernel's preferred shared-memory carveout (percent of the most
// shared memory an SM has) where it differs from the last one set.
template <typename Kernel>
__host__ cudaError_t set_carveout(Kernel kernel, int percent, int* last) {
  if (percent == *last) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, percent);
  if (err == cudaSuccess) *last = percent;
  return err;
}

}  // namespace acx_encode
