// Snappy block decode for a batch of chunks of at most 64 KB, one warp per
// chunk, with the chunk's input and its recent output in shared memory.
//
// Replaces the TPU kernel aircompressor_tpu/ops/snappy_pallas_w.py::_decode_kernel
// and keeps its contract: a (B, cap) uint8 batch with (B,) int32 compressed
// lengths gives (B, out_cap) bytes, (B,) int32 output lengths and (B,) ok flags.
// It keeps that kernel's validation: declared > 64 KB, varint longer than the
// chunk, chunk longer than its row, a token or literal running past the chunk,
// output past the declared length, a copy with dist <= 0 or dist > op. On an
// error the chunk stops; its output length is the bytes produced before the
// bad token. ok = no error and op == declared. Bytes at or past the output
// length are zero. A 4-byte-offset copy takes all 32 bits of its offset, as
// the format and the host decoders do, so a nonzero high byte fails.
//
// With a non-null `steps`, lane 0 also writes the iterations of the token
// loop for each chunk: the tokens parsed, the failing one included, 0 for a
// chunk rejected before its first token. A null `steps` writes nothing more.
//
// Design. Each block is one warp and decodes one chunk, so 256 chunks spread
// over all 132 SMs. The warp keeps two rings in shared memory:
// - Input ring (kRing = 2 KB, four quarters of 512 B). Quarters arrive by
//   cp.async, 16 B a lane, two quarters ahead of the one being parsed; a
//   quarter is issued only once the one four back is consumed. Every lane
//   reads a token's tag and operand bytes from the ring (two 8-byte
//   broadcast reads), so the whole warp decodes the same token with no
//   device-memory trip and no shuffle; a copy's next token is read before
//   the copy moves its bytes, so the two overlap. A literal streams from the
//   ring into the window in pieces of at most one ready stretch (< 1 KB).
// - Output window (kWindow bytes) holding the most recent output. Literals
//   and copies write into it. A copy with dist <= kWindow - 64 reads its
//   source there; a farther one reads device memory, where those bytes
//   already are. A copy's bytes k and k + 32 go to lane k, k mod d for an
//   overlapping copy by a reciprocal table. The window drains to device
//   memory with 16-byte stores (bytes only where a row's edge cuts a 16-byte
//   unit) whenever kWindow / 2 bytes are waiting, then __syncwarp(): at any
//   token start fewer than kWindow / 2 bytes are waiting and a step adds at
//   most kRun, so a far copy's source is in device memory and no write
//   clobbers a byte not yet drained. The zero tail is stored the same way.
//   Bytes at or past out_cap are never stored; a far copy reads only for a
//   destination below out_cap.
// Both rings are addressed by (position + row address) mod size, so a
// 16-byte unit of device memory is a 16-byte unit of shared memory.
//
// Runs. The compressor cuts a long match into identical 64-byte copy
// tokens at one dist, and a run of identical tokens at dist d is one copy
// at dist d (each byte repeats the byte d before it). When the next token
// repeats this one, lane k compares the k-th token from here, a ballot
// counts the run (up to 32 tokens and kRun bytes; d + its length <=
// kWindow for a window read), and the run moves in one pass, four reads
// ahead of four writes. Literal pieces move the same way.
//
// Two instantiations of the one template, picked by the batch: 4 KB windows
// (6 KB of shared memory a chunk, 32 chunks an SM, so 4096 chunks are one
// wave) above 792 chunks, and 32 KB windows (6 chunks an SM) up to 792, where
// one wave holds the batch anyway and 97% of the generated corpus's copies
// fall inside 32 KB against 32% inside 4 KB.
//
// What bounds it on this card: the steps of a chunk (a literal, a run or a
// single copy) follow one another, each start depending on the one before,
// so one chunk is a serial chain of shared-memory reads, 32-lane byte moves
// and a warp barrier a step, several hundred cycles each. A one-wave batch
// takes as long as its longest chain (on the generated corpus a text chunk,
// tens of literals and hundreds of copies); at 32 chunks an SM the
// instructions the warps issue bound it. Left for later: fewer instructions and dependent steps a single
// copy. Parsing a round of up to 32 tokens ahead (a shuffle walk of the
// tags, offsets by a warp prefix sum, independent copies without barriers)
// was built and measured slower on this card: its walk, prefix sum and
// checks alone took more cycles a token than the whole loop here.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int64_t kMaxOut = 65536;
constexpr int kRing = 2048;           // input ring bytes
constexpr int kQuarter = kRing / 4;   // one cp.async a lane
constexpr int kRun = 1024;            // output bytes a run of copies may add
constexpr int kSmallBatchChunks = 792;  // 6 chunks an SM on 132 SMs
constexpr unsigned kAllLanes = 0xffffffffu;

// ceil(65536 / d) for d in [1, 64): (k * kRecip[d]) >> 16 == k / d for every
// k < 64, which gives an overlapping copy's k mod d without a division.
__constant__ uint32_t kRecip[64] = {
    0, 65536, 32768, 21846, 16384, 13108, 10923, 9363, 8192, 7282, 6554, 5958,
    5462, 5042, 4682, 4370, 4096, 3856, 3641, 3450, 3277, 3121, 2979, 2850,
    2731, 2622, 2521, 2428, 2341, 2260, 2185, 2115, 2048, 1986, 1928, 1873,
    1821, 1772, 1725, 1681, 1639, 1599, 1561, 1525, 1490, 1457, 1425, 1395,
    1366, 1338, 1311, 1286, 1261, 1237, 1214, 1192, 1171, 1150, 1130, 1111,
    1093, 1075, 1058, 1041};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

template <int kWindow, int kMinBlocks>
__global__ void __launch_bounds__(32, kMinBlocks)
snappy_decode_kernel(const uint8_t* __restrict__ comp,
                     const int32_t* __restrict__ comp_lens, int cap,
                     uint8_t* out, int32_t* __restrict__ out_lens,
                     uint8_t* __restrict__ ok, int out_cap,
                     int32_t* __restrict__ steps) {
  constexpr int kReach = kWindow - 64;   // farthest dist read from the window
  constexpr int kFlushAt = kWindow / 2;  // bytes waiting that start a drain
  __shared__ uint4 ring4[kRing / 16];
  __shared__ uint4 win4[kWindow / 16];
  uint8_t* ring = reinterpret_cast<uint8_t*>(ring4);
  uint8_t* win = reinterpret_cast<uint8_t*>(win4);

  const int lane = threadIdx.x;
  const int chunk = blockIdx.x;
  const uint8_t* src = comp + static_cast<size_t>(chunk) * cap;
  uint8_t* dst = out + static_cast<size_t>(chunk) * out_cap;
  const int clen = comp_lens[chunk];
  const int readable = max(0, min(clen, cap));

  // Ring coordinates: P = position + sr, so P % 16 == 0 is a 16-byte
  // boundary of device memory; window coordinates likewise with so.
  const int sr = static_cast<int>(reinterpret_cast<uintptr_t>(src) & 15);
  const int so = static_cast<int>(reinterpret_cast<uintptr_t>(dst) & 15);
  const uint8_t* src16 = src - sr;
  uint8_t* dst16 = dst - so;
  const int in_end = sr + readable;  // ring coordinate of the input's end
  const int n_quarters = readable > 0 ? (in_end + kQuarter - 1) / kQuarter : 0;
  auto wslot = [&](int pos) -> int { return (pos + so) & (kWindow - 1); };

  // Quarter q: the 16-byte units of [q * kQuarter, (q + 1) * kQuarter) that
  // hold readable bytes, one a lane; units cut by the row's edges by bytes.
  int issued = 0;
  auto issue = [&]() {
    if (issued < n_quarters) {
      const int u0 = issued * kQuarter;
      const int lo = u0 + 16 * lane;
      if (lo < in_end) {
        uint8_t* to = ring + (lo & (kRing - 1));
        if (lo >= sr && lo + 16 <= sr + cap) {
          cp_async16(to, src16 + lo);
        } else {
          for (int p = max(lo, sr); p < min(lo + 16, in_end); ++p)
            to[p - lo] = src16[p];
        }
      }
    }
    cp_async_commit();  // one group per quarter, empty or not
    ++issued;
  };
  int ready = 0;  // quarters arrived and visible to the warp
  auto need = [&](int end) {  // ring bytes below coordinate `end` are ready
    while (ready * kQuarter < end) {
      cp_async_wait_all_but_one();
      __syncwarp();
      ++ready;
      issue();
    }
  };
  // Bytes at..at+7 of the chunk (0 at and past readable), from the ring;
  // those past the ones it holds are stale.
  auto peek8 = [&](int at) -> uint64_t {
    const int p = at + sr;
    const int a = p & ~7;
    const uint64_t lo = *reinterpret_cast<const uint64_t*>(ring + (a & (kRing - 1)));
    const uint64_t hi = *reinterpret_cast<const uint64_t*>(ring + ((a + 8) & (kRing - 1)));
    const int sh = 8 * (p & 7);
    const uint64_t w = sh ? (lo >> sh) | (hi << (64 - sh)) : lo;
    const int valid = min(max(readable - at, 0), 8);  // bytes below readable
    return valid == 8 ? w : w & ((uint64_t{1} << (8 * valid)) - 1);
  };
  auto read8 = [&](int at) -> uint64_t {  // the ring holds at..at+5 when they exist
    need(min(at + sr + 6, in_end));
    return peek8(at);
  };

  // Device-memory stores of window bytes [a, b) (b <= out_cap), or zeros.
  auto store = [&](int a, int b, bool zeros) {
    const int ap = a + so, bp = b + so;
    for (int u = (ap >> 4) + lane; u < ((bp + 15) >> 4); u += 32) {
      const int lo = max(u << 4, ap), hi = min((u << 4) + 16, bp);
      if (hi - lo == 16) {
        reinterpret_cast<uint4*>(dst16)[u] =
            zeros ? make_uint4(0, 0, 0, 0) : win4[u & (kWindow / 16 - 1)];
      } else {
        for (int p = lo; p < hi; ++p) dst16[p] = zeros ? 0 : win[p & (kWindow - 1)];
      }
    }
  };

  int op = 0;
  int flushed = 0;  // output bytes below this are in device memory (or >= out_cap)
  int drain_at = kFlushAt;  // op that starts the next drain; none once out_cap is stored
  auto drain = [&]() {  // after a __syncwarp()
    if (op >= drain_at) {
      const int lim = op >= out_cap ? out_cap : ((op + so) & ~15) - so;
      store(flushed, lim, false);
      flushed = lim;
      drain_at = flushed < out_cap ? flushed + kFlushAt : INT_MAX;
      __syncwarp();
    }
  };

  issue();
  issue();

  // Varint uncompressed length, at most 5 bytes, truncated to 32 bits.
  const uint64_t head = read8(0);
  uint32_t declared = head & 0x7f;
  int vlen = 1;
  bool more = (head & 0x80) != 0;
  for (int k = 1; k < 5; ++k) {
    const uint32_t b = (head >> (8 * k)) & 0xff;
    if (more) {
      declared |= (b & 0x7f) << (7 * k);
      ++vlen;
    }
    more = more && b >= 128;
  }

  bool err = declared > kMaxOut || vlen > clen || clen > cap;
  int ip = vlen;
  int count = 0;
  uint64_t bytes = read8(ip);  // the next token's bytes, read one step ahead
  while (!err && ip < clen) {
    ++count;
    const int tag = static_cast<int>(bytes & 0xff);
    const uint32_t word = static_cast<uint32_t>(bytes >> 8);
    const int type = tag & 3;
    const int n = tag >> 2;
    if (type == 0) {  // literal: streams from the ring, one ready stretch a piece
      const int extra = min(max(n - 59, 0), 4);
      const uint64_t mask = (uint64_t{1} << (8 * extra)) - 1;
      const int64_t len = (extra == 0 ? n : static_cast<int64_t>(word & mask)) + 1;
      const int tok = 1 + extra;
      err = len > kMaxOut || ip + tok + len > clen || op + len > declared;
      if (err) break;
      int from = ip + tok;
      int rem = static_cast<int>(len);
      while (rem > 0) {
        const int p = from + sr;
        need(p + 1);
        const int piece = min(rem, ready * kQuarter - p);
        for (int k0 = 0; k0 < piece; k0 += 128) {  // four reads, then four writes
          uint8_t b[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int k = k0 + 32 * i + lane;
            b[i] = k < piece ? ring[(p + k) & (kRing - 1)] : 0;
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int k = k0 + 32 * i + lane;
            if (k < piece) win[wslot(op + k)] = b[i];
          }
        }
        from += piece;
        op += piece;
        rem -= piece;
        __syncwarp();
        drain();
      }
      ip = from;
      bytes = read8(ip);
      continue;
    }
    // A copy, or a run of identical copies (see Runs above).
    const int tok = type == 1 ? 2 : (type == 2 ? 3 : 5);
    const int len = type == 1 ? 4 + (n & 7) : n + 1;
    const uint32_t dist = type == 1 ? ((tag >> 5) << 8) | (word & 0xff)
                                    : (type == 2 ? word & 0xffff : word);
    err = ip + tok > clen || op + len > static_cast<int64_t>(declared) || dist == 0 ||
          dist > static_cast<uint32_t>(op);
    if (err) break;
    const int d = static_cast<int>(dist);
    int run = 1;
    if (type == 2 && ((bytes >> 24) & 0xffffff) == (bytes & 0xffffff)) {
      const int room = d <= kReach ? min(kRun, kWindow - d) : kRun;
      need(min(ip + sr + 96, in_end));
      const int at = ip + 3 * lane;  // lane k: the k-th token from ip
      const int q = at + sr;
      const int upto = (lane + 1) * len;  // output of tokens 0..k
      const bool same = upto <= room && op + upto <= static_cast<int>(declared) &&
                        at + 3 <= clen &&
                        ring[q & (kRing - 1)] == (bytes & 0xff) &&
                        ring[(q + 1) & (kRing - 1)] == ((bytes >> 8) & 0xff) &&
                        ring[(q + 2) & (kRing - 1)] == ((bytes >> 16) & 0xff);
      const unsigned lanes = __ballot_sync(kAllLanes, same);
      run = lanes == kAllLanes ? 32 : max(1, __ffs(~lanes) - 1);
      count += run - 1;
    }
    ip += tok * run;
    bytes = read8(ip);  // ahead of this step's moves, so the two overlap
    if (run == 1) {  // lane k moves bytes k and k + 32
      const bool has0 = lane < len, has1 = lane + 32 < len;
      if (d <= kReach) {  // from the window; reads only bytes before op
        int r0 = lane, r1 = lane + 32;
        if (d < len) {  // overlapping: byte k repeats byte k mod d (d < 64)
          const uint32_t m = kRecip[d];
          r0 -= d * static_cast<int>((r0 * m) >> 16);
          r1 -= d * static_cast<int>((r1 * m) >> 16);
        }
        const uint8_t b0 = has0 ? win[wslot(op - d + r0)] : 0;
        const uint8_t b1 = has1 ? win[wslot(op - d + r1)] : 0;
        if (has0) win[wslot(op + lane)] = b0;
        if (has1) win[wslot(op + lane + 32)] = b1;
      } else {  // from device memory: d > 64 >= len, no overlap
        if (has0 && op + lane < out_cap) win[wslot(op + lane)] = dst[op - d + lane];
        if (has1 && op + lane + 32 < out_cap) win[wslot(op + lane + 32)] = dst[op - d + lane + 32];
      }
      op += len;
    } else {  // a run of `run` tokens: byte k repeats byte k mod d
      const int total = run * len;
      if (d <= kReach) {
        int r = lane, step = 32;  // k mod d and 32 mod d, kept as k steps by 32
        if (d <= 32) {
          const uint32_t m = kRecip[d];
          r -= d * static_cast<int>((r * m) >> 16);
          step -= d * static_cast<int>((32 * m) >> 16);
        }
        // Every source lies before op and d + total <= kWindow: no read
        // meets a write of the run, so four reads go before four writes.
        for (int k0 = 0; k0 < total; k0 += 128) {
          uint8_t b[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int k = k0 + 32 * i + lane;
            b[i] = k < total ? win[wslot(op - d + (d >= total ? k : r))] : 0;
            r += step;
            if (r >= d) r -= d;
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int k = k0 + 32 * i + lane;
            if (k < total) win[wslot(op + k)] = b[i];
          }
        }
      } else {  // d > kReach >= kRun >= total: no overlap
        for (int k = lane; k < total; k += 32)
          if (op + k < out_cap) win[wslot(op + k)] = dst[op - d + k];
      }
      op += total;
    }
    __syncwarp();
    drain();
  }

  // The rest of the row: what the window still holds, then the zero tail.
  if (op < out_cap) {
    const int unit_end = min(((op + so + 15) & ~15) - so, out_cap);
    for (int p = op + lane; p < unit_end; p += 32) win[wslot(p)] = 0;
    __syncwarp();
    store(flushed, unit_end, false);
    store(unit_end, out_cap, true);
  } else if (flushed < out_cap) {
    store(flushed, out_cap, false);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  if (lane == 0) {
    out_lens[chunk] = op;
    ok[chunk] = !err && static_cast<uint32_t>(op) == declared;
    if (steps != nullptr) steps[chunk] = count;
  }
}

template <int kWindow, int kMinBlocks>
cudaError_t launch(const uint8_t* comp, const int32_t* comp_lens, int batch,
                   int cap, uint8_t* out, int32_t* out_lens, uint8_t* ok,
                   int out_cap, int32_t* steps, cudaStream_t stream) {
  static const cudaError_t carveout = cudaFuncSetAttribute(
      snappy_decode_kernel<kWindow, kMinBlocks>,
      cudaFuncAttributePreferredSharedMemoryCarveout,
      static_cast<int>(cudaSharedmemCarveoutMaxShared));
  if (carveout != cudaSuccess) return carveout;
  snappy_decode_kernel<kWindow, kMinBlocks><<<batch, 32, 0, stream>>>(
      comp, comp_lens, cap, out, out_lens, ok, out_cap, steps);
  return cudaGetLastError();
}

}  // namespace

// Launches the decode on `stream` and returns cudaGetLastError(). The caller
// allocates every buffer: out (batch, out_cap) uint8, out_lens (batch,)
// int32, ok (batch,) bool, and steps (batch,) int32 or null.
extern "C" int acx_snappy_decode(const void* comp, const void* comp_lens,
                                 int batch, int cap, void* out, void* out_lens,
                                 void* ok, int out_cap, void* steps, void* stream) {
  if (batch <= 0) return static_cast<int>(cudaGetLastError());
  const auto* c = static_cast<const uint8_t*>(comp);
  const auto* cl = static_cast<const int32_t*>(comp_lens);
  auto* o = static_cast<uint8_t*>(out);
  auto* ol = static_cast<int32_t*>(out_lens);
  auto* k = static_cast<uint8_t*>(ok);
  auto* st = static_cast<int32_t*>(steps);
  auto* s = static_cast<cudaStream_t>(stream);
  if (batch <= kSmallBatchChunks)
    return static_cast<int>(launch<32768, 6>(c, cl, batch, cap, o, ol, k, out_cap, st, s));
  return static_cast<int>(launch<4096, 32>(c, cl, batch, cap, o, ol, k, out_cap, st, s));
}
