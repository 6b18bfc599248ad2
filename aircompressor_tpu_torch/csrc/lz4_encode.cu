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
// With a non-null `steps`, lane 0 also writes each chunk's probes of that
// serial scan (a probe that hits and the match it emits being one). A null
// `steps` writes nothing more.
//
// Design: rounds of 32 probes (encode_rounds.cuh). The table lives in
// shared memory as uint16 positions (32 KB a block), 0xffff for "empty":
// every stored position is below 65524, so an empty entry fails cand < ip by
// itself. Lane k of a round probes ip + k * (skip >> 6) and reads the table
// as the probes before it left it (the highest earlier lane with its hash,
// else the round's entry); the first hit ends the round and only probes up
// to it write. Forward and backward extension compare 128 bytes a ballot;
// the mend - 2 insert follows the round's writes, as in the serial scan.
// Literals are copied 16 bytes a lane into aligned stores with four blocks'
// loads in flight a lane, the 0xFF strings of long lengths likewise; lane 0
// writes tokens and offsets. No byte at or past a chunk's length is read: a
// probe reads below len - 8, extension below len - 5, the seed at mend - 2
// below len - 3, and word loads fall back to bytes at the chunk's edges.
//
// What bounds it on this card: each chunk is still a serial chain, now of
// rounds and extension ballots, each a few dependent trips to L1 or L2 (the
// words at the probes, the table entries, the candidates' words) and to
// shared memory; the card is filled only by the chunks in flight, the 32 KB
// table a block allowing 6 blocks (6 chunks) an SM at the largest carveout.
// The carveout (`carveout`, percent of the SM's most shared memory) trades
// chunks an SM against L1 for the candidate loads, which land anywhere in
// the chunk: the wrapper takes a small one (3 chunks an SM beside 156 KB of
// L1) for a batch that fits one wave of those, the largest otherwise
// (ops/_rows.py::encode_carveout; PERF.md has the settings timed).

#include <cstdint>
#include <cuda_runtime.h>

#include "encode_rounds.cuh"

namespace {

using namespace acx_encode;

constexpr int kOutCap = 66560;
constexpr int kMatchFindLimit = 12;
constexpr int kLastLiterals = 5;
constexpr int kMinMatch = 4;
constexpr int kBackCap = 127;
constexpr int kSkipShift = 6;
constexpr uint32_t kHashMul = 2654435761u;

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

  int op = 0;
  auto put = [&](int pos, int value) {
    if (pos < kOutCap) dst[pos] = static_cast<uint8_t>(value);
  };
  auto room_at = [&](int len) { return max(0, min(len, kOutCap - op)); };

  // The 255-extension of a length >= 15: (len - 15) / 255 bytes of 0xFF,
  // then (len - 15) % 255, written even when it is 0.
  auto emit_length = [&](int len) {
    const int rest = len - 15;
    const int fills = rest / 255;
    fill3(dst, op, room_at(fills), 0xffffffu, lane);
    if (lane == 0) put(op + fills, rest % 255);
    op += fills + 1;
  };

  // One sequence: lit literals from `from`, then a match of ml bytes at dist,
  // or none where ml is 0 (the last sequence).
  auto emit_sequence = [&](int from, int lit, int ml, int dist) {
    if (lane == 0) put(op, (min(lit, 15) << 4) | (ml ? min(ml - kMinMatch, 15) : 0));
    ++op;
    if (lit >= 15) emit_length(lit);
    copy_bytes(dst, op, src, n, from, room_at(lit), lane);
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
  int skip = 1 << kSkipShift;
  int count = 0;
  while (ip < find_limit) {
    // The lanes also pull the next 1 KB of the chunk into L2, ahead of the scan.
    prefetch_l2(src + min(ip + 1024 + 32 * lane, n - 1));
    const int step = skip >> kSkipShift;
    const Round r = probe_round(src, n, table, kHashMul, ip, step, find_limit, lane);
    count += r.ran;
    if (r.hit < 0) {  // all missed; fewer than 32 ran only at the find limit
      skip += r.ran;
      ip += 32 * step;
      continue;
    }
    ip += r.hit * step;
    const int cand = r.cand;
    const int mlen = extend_forward(src, ip, cand, match_limit, lane);
    const int back = extend_backward(src, n, ip, cand, min(min(ip - anchor, cand), kBackCap), lane);
    emit_sequence(anchor, ip - back - anchor, mlen + back, ip - cand);
    const int mend = ip + mlen;
    if (lane == 0)
      table[hash_of(load4(src, mend - 2, n), kHashMul)] = static_cast<uint16_t>(mend - 2);
    __syncwarp();
    ip = mend;
    anchor = mend;
    skip = 1 << kSkipShift;
  }
  emit_sequence(anchor, n - anchor, 0, 0);

  zero_tail(dst, op, kOutCap, lane);
  if (lane == 0) {
    comp_lens[chunk] = min(op, kOutCap);
    ok[chunk] = op + 8 <= kOutCap;
    if (steps != nullptr) steps[chunk] = count;
  }
}

}  // namespace

// Launches the encode on `stream` and returns cudaGetLastError() (or the
// error of setting the carveout, percent of the SM's most shared memory).
// The caller allocates every buffer: comp (batch, 66560) uint8, comp_lens
// (batch,) int32, ok (batch,) bool, steps (batch,) int32 or null; comp must
// start 16-byte aligned.
extern "C" int acx_lz4_encode(const void* data, const void* lengths, int batch,
                              int cap, void* comp, void* comp_lens, void* ok,
                              void* steps, int carveout, void* stream) {
  if (batch > 0) {
    static int last_carveout = -1;
    const cudaError_t set = set_carveout(lz4_encode_kernel, carveout, &last_carveout);
    if (set != cudaSuccess) return static_cast<int>(set);
    lz4_encode_kernel<<<batch, 32, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(data), static_cast<const int32_t*>(lengths),
        cap, static_cast<uint8_t*>(comp), static_cast<int32_t*>(comp_lens),
        static_cast<uint8_t*>(ok), static_cast<int32_t*>(steps));
  }
  return static_cast<int>(cudaGetLastError());
}
