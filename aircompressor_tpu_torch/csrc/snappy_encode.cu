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
// With a non-null `steps`, lane 0 also writes each chunk's probes of that
// serial scan (a probe that hits and the match it emits being one). A null
// `steps` writes nothing more.
//
// Design: rounds of 32 probes (encode_rounds.cuh). The table lives in
// shared memory as uint16 positions (32 KB a block), 0xffff for "empty":
// every stored position is below 65521, so an empty entry fails cand < ip by
// itself. Lane k of a round probes ip + k * (skip >> 5) and reads the table
// as the probes before it left it (the highest earlier lane with its hash,
// else the round's entry); the first hit ends the round and only probes up
// to it write. Forward and backward extension compare 128 bytes a ballot.
// Literal runs are copied 16 bytes a lane into aligned stores with four
// blocks' loads in flight a lane, and the 3-byte pieces of a long copy are
// written as one periodic string likewise; lane 0 writes the headers. The
// table insert after a match is made only where a later probe can read it
// (mend < len - 15), so no byte at or past a chunk's length is ever read,
// and word loads fall back to bytes at the chunk's edges.
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

constexpr int kOutCap = 76800;
constexpr int kInputMargin = 15;
constexpr int kSkipShift = 5;
constexpr uint32_t kHashMul = 0x1E35A7BDu;

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
  auto room_at = [&](int len) { return max(0, min(len, kOutCap - op)); };

  auto emit_literal = [&](int from, int len) {
    const int n1 = len - 1;
    const int hlen = n1 < 60 ? 1 : (n1 < 256 ? 2 : 3);
    if (lane == 0) {
      put(op, n1 < 60 ? n1 << 2 : (n1 < 256 ? 60 << 2 : 61 << 2));
      if (hlen >= 2) put(op + 1, n1 & 255);
      if (hlen == 3) put(op + 2, n1 >> 8);
    }
    op += hlen;
    copy_bytes(dst, op, src, n, from, room_at(len), lane);
    op += len;
  };

  // One 3-byte COPY_2 piece of `len` bytes at dist, by lane 0.
  auto emit_copy2 = [&](int len, int dist) {
    if (lane == 0) {
      put(op, 2 | ((len - 1) << 2));
      put(op + 1, dist & 255);
      put(op + 2, dist >> 8);
    }
    op += 3;
  };

  auto emit_copy = [&](int len, int dist) {
    const int n64 = len >= 68 ? (len - 68) / 64 + 1 : 0;
    fill3(dst, op, room_at(3 * n64),
          (2 | (63 << 2)) | static_cast<uint32_t>(dist & 255) << 8 |
              static_cast<uint32_t>(dist >> 8) << 16,
          lane);
    op += 3 * n64;
    int rest = len - 64 * n64;
    if (rest > 64) {
      emit_copy2(60, dist);
      rest -= 60;
    }
    if (rest <= 11 && dist < 2048) {
      if (lane == 0) {
        put(op, 1 | ((rest - 4) << 2) | ((dist >> 8) << 5));
        put(op + 1, dist & 255);
      }
      op += 2;
    } else {
      emit_copy2(rest, dist);
    }
  };

  const int find_limit = n - kInputMargin;
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
    const int mlen = extend_forward(src, ip, cand, n, lane);
    const int back = extend_backward(src, n, ip, cand, min(min(ip - anchor, cand), 127), lane);
    if (ip - back > anchor) emit_literal(anchor, ip - back - anchor);
    emit_copy(mlen + back, ip - cand);
    const int mend = ip + mlen;
    if (lane == 0 && mend < find_limit)
      table[hash_of(load4(src, mend - 1, n), kHashMul)] = static_cast<uint16_t>(mend - 1);
    __syncwarp();
    ip = mend;
    anchor = mend;
    skip = 1 << kSkipShift;
  }
  if (n > anchor) emit_literal(anchor, n - anchor);

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
// The caller allocates every buffer: comp (batch, 76800) uint8, comp_lens
// (batch,) int32, ok (batch,) bool, steps (batch,) int32 or null; comp must
// start 16-byte aligned.
extern "C" int acx_snappy_encode(const void* data, const void* lengths,
                                 int batch, int cap, void* comp,
                                 void* comp_lens, void* ok, void* steps,
                                 int carveout, void* stream) {
  if (batch > 0) {
    static int last_carveout = -1;
    const cudaError_t set = set_carveout(snappy_encode_kernel, carveout, &last_carveout);
    if (set != cudaSuccess) return static_cast<int>(set);
    snappy_encode_kernel<<<batch, 32, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(data), static_cast<const int32_t*>(lengths),
        cap, static_cast<uint8_t*>(comp), static_cast<int32_t*>(comp_lens),
        static_cast<uint8_t*>(ok), static_cast<int32_t*>(steps));
  }
  return static_cast<int>(cudaGetLastError());
}
