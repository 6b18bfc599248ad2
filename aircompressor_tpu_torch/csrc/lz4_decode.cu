// LZ4 block decode for a batch of chunks of at most 64 KB, one warp per
// chunk, with the chunk's input and its recent output in shared memory.
//
// Replaces the TPU kernel aircompressor_tpu/ops/lz4_pallas_w.py::_decode_kernel
// and keeps its contract: a (B, cap) uint8 batch with (B,) int32 compressed
// lengths gives (B, out_cap) bytes, (B,) int32 output lengths and (B,) ok
// flags. It keeps that kernel's rules: a chunk whose length is not in
// [1, cap] is malformed; a token holds a 4-bit literal length and a 4-bit
// match length less 4, and a nibble of 15 is followed by 255-extension bytes
// ended by the first byte that is not 0xFF; the offset is 2 bytes, little-
// endian, and bad when 0 or past the output; a parse that reads past the
// chunk, or a run that would take the output past 64 KB, is malformed. On an
// error the chunk stops; its output length counts the bytes produced before
// it (the failing sequence's literals too where only its match part fails).
// ok = no error and the block ended right after a literal run (the last
// sequence is literals only). Bytes at or past the output length are zero.
//
// With a non-null `steps`, lane 0 also writes the iterations of the
// sequence loop for each chunk: the sequences parsed, the failing one
// included, 0 for a chunk rejected before its first sequence. A null
// `steps` writes nothing more.
//
// Design. Each block is one warp and decodes one chunk, so 256 chunks spread
// over all 132 SMs. The warp keeps the input ring and the output window of
// csrc/decode_window.cuh:
// - Input ring (2 KB; 4 KB beside the 32 KB window). Every lane reads a
//   sequence's header from it by one 8-byte broadcast read (the token, and
//   the offset where the literals are at most 5 bytes), a 255-extension is
//   found by a ballot over 32 ring bytes a round (beside the 32 KB window,
//   one that ends within the bytes read so is summed from them), and the
//   next sequence's header is read before this one's bytes move.
// - Output window (kWindow bytes). One step moves at most kStep =
//   kWindow / 16 bytes: a sequence's literals (from the ring) and then its
//   match, lane k moving bytes k, k + 32, ..., four reads before four
//   writes, an overlapping match's k mod dist by the reciprocal table, then
//   one __syncwarp(). LZ4 puts the literals before the match, so a match
//   byte whose source lies in this step's literals reads it from the ring,
//   where it still is, and not from the window slot the same step writes;
//   every other source byte lies before the step. A match with dist <=
//   kReach = kWindow - kStep reads the window, where no write of the step
//   meets it; a farther one (offsets reach 65,535) reads device memory,
//   where those bytes already are, and only for destinations below
//   out_cap. A match longer than a step (255-extended lengths) moves in
//   pieces at the same dist, the literals with its first piece where they
//   take at most half a step.
// - Literal runs that the ring would drop before their match is parsed
//   (long runs: a ring read past them issues slices into their places)
//   stream into the window first, in pieces of at most kStep bytes and one
//   ready stretch of the ring; so does the last sequence's run.
// The window drains to device memory in 16-byte stores whenever half of it
// waits (a step adds at most kWindow / 16, so no write overwrites a byte not
// yet drained and a far read's source is drained); the zero tail is stored
// the same way. Nothing is stored at or past out_cap, so out_cap = 4093
// takes bytes at the row's edge.
//
// Two instantiations of the one template, picked by the batch as for
// csrc/lzo_decode.cu: 4 KB windows (6 KB of shared memory a chunk, 32 chunks
// an SM, so 4096 chunks are one wave) above 792 chunks, and 32 KB windows
// (36 KB with the ring, 6 chunks an SM) up to 792, where one wave holds the
// batch anyway (lz4_decode.distance_shares gives the share of the corpus's
// matches within each reach).
//
// What bounds it on this card: the sequences of a chunk are parsed one after
// another, each start depending on the sequence before, so one chunk is a
// serial chain of shared-memory reads, 32-lane byte moves and a warp barrier
// a step. A one-wave batch takes as long as its longest chain; at 32 chunks
// an SM the instructions the warps issue bound it.

#include "decode_window.cuh"

namespace {

constexpr int kMaxOut = 65536;
constexpr int kSmallBatchChunks = 792;  // 6 chunks an SM on 132 SMs

template <int kWindow, int kMinBlocks>
__global__ void __launch_bounds__(32, kMinBlocks)
lz4_decode_kernel(const uint8_t* __restrict__ comp,
                  const int32_t* __restrict__ comp_lens, int cap, uint8_t* out,
                  int32_t* __restrict__ out_lens, uint8_t* __restrict__ ok,
                  int out_cap, int32_t* __restrict__ steps) {
  constexpr int kStep = kWindow / 16;       // output bytes a step may add
  constexpr int kReach = kWindow - kStep;  // farthest dist read from the window
  static_assert(2 * kStep <= OutWindow<kWindow>::kFlushAt, "a far read's source is drained");
  constexpr int kRingBytes = ring_bytes(kWindow);
  __shared__ uint4 ring4[kRingBytes / 16];
  __shared__ uint4 win4[kWindow / 16];

  const int lane = threadIdx.x;
  const int chunk = blockIdx.x;
  const uint8_t* src = comp + static_cast<size_t>(chunk) * cap;
  uint8_t* row = out + static_cast<size_t>(chunk) * out_cap;
  const int clen = comp_lens[chunk];
  const int readable = max(0, min(clen, cap));

  InputRing<kRingBytes> in;
  in.start(smem_addr(ring4), src, cap, 0, readable, lane);
  const int sr = in.lo;  // the ring coordinate of input byte 0
  const int in_end = in.hi;
  OutWindow<kWindow> w;
  w.init(win4, row, out_cap, lane);

  int op = 0;
  // One step: n_lit input bytes from lit_at (the ring) to the window at op,
  // then mlen bytes that repeat the byte dist back (the window, this step's
  // literals in the ring, or device memory). Lane k moves bytes k, k + 32,
  // ..., four reads before four writes. Then __syncwarp() and a drain.
  auto step = [&](int n_lit, int lit_at, int dist, int mlen) {
    const int lr = lit_at + sr;  // the ring coordinate of output byte op
    for (int k0 = 0; k0 < n_lit; k0 += 128) {
      uint32_t b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) b[i] = in.at(lr + k0 + 32 * i + lane);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = k0 + 32 * i + lane;
        w.put_if(k < n_lit, op + k, b[i]);
      }
    }
    const int at = op + n_lit;
    const int from = at - dist;
    if (mlen > 0 && dist <= kReach) {  // the window, or this step's literals
      int r = lane, stride = 32;  // k mod dist for an overlapping match
      if (dist < mlen) mod_walk(dist, lane, r, stride);
      for (int k0 = 0; k0 < mlen; k0 += 128) {
        uint32_t b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int q = from + (dist >= mlen ? k0 + 32 * i + lane : r);
          b[i] = lds_u8(q >= op ? in.ring + ((lr + q - op) & (kRingBytes - 1))
                                : w.win + w.slot(q));
          r += stride;
          if (r >= dist) r -= dist;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int k = k0 + 32 * i + lane;
          w.put_if(k < mlen, at + k, b[i]);
        }
      }
    } else if (mlen > 0) {  // device memory, for destinations below out_cap
      for (int k0 = 0; k0 < mlen; k0 += 128) {
        uint32_t b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int k = k0 + 32 * i + lane;
          b[i] = k < mlen && at + k < out_cap ? w.dst[from + k] : 0;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int k = k0 + 32 * i + lane;
          w.put_if(k < mlen && at + k < out_cap, at + k, b[i]);
        }
      }
    }
    op = at + mlen;
    __syncwarp();
    w.drain(op);
  };
  // A literal run of n input bytes from `from`, in pieces of at most kStep
  // bytes and one ready stretch of the ring.
  auto literals = [&](int from, int n) {
    while (n > 0) {
      const int p = from + sr;
      in.need(p + 1);
      const int piece = min(min(n, kStep), in.ready_end() - p);
      step(piece, from, 0, 0);
      from += piece;
      n -= piece;
    }
  };

  // The current sequence's literals, parsed but not moved yet.
  int pend_at = 0, pend_n = 0;
  // Ring bytes below coordinate end, readable: first the pending literals
  // move where the ring would drop them.
  auto fetch = [&](int end) {
    if (pend_n > 0 && pend_at + sr < in.kept_from(end)) {
      literals(pend_at, pend_n);
      pend_n = 0;
    }
    in.need(end);
  };
  // Bytes at..at+7 of the chunk (0 at and past readable), from the ring.
  auto read8 = [&](int at) -> uint64_t {
    const int p = at + sr;
    fetch(min(p + 8, in_end));
    const int a = p & ~7;
    const uint64_t lo = in.at8(a), hi = in.at8(a + 8);
    const int sh = 8 * (p & 7);
    const uint64_t v = sh ? (lo >> sh) | (hi << (64 - sh)) : lo;
    const int valid = min(max(readable - at, 0), 8);  // bytes below readable
    return valid == 8 ? v : v & ((uint64_t{1} << (8 * valid)) - 1);
  };
  // Sum of the 255-extension string at p, and p moved past it, by a ballot
  // over 32 ring bytes a round; -1 where the string runs past the chunk or
  // its sum passes 64 KB (the run it lengthens is then malformed whatever
  // follows; the cut keeps the sum in an int).
  auto read_ext = [&](int& p) -> int {
    int sum = 0;
    while (true) {
      fetch(min(p + sr + 32, in_end));
      const int at = p + lane;
      const int b = at < readable ? static_cast<int>(in.at(at + sr)) : -1;
      const unsigned ends = __ballot_sync(kAllLanes, b != 255);
      if (ends == 0) {
        sum += 255 * 32;
        p += 32;
        if (sum > kMaxOut) return -1;
        continue;
      }
      const int k = __ffs(ends) - 1;
      const int last = __shfl_sync(kAllLanes, b, k);
      if (last < 0) return -1;
      p += k + 1;
      return sum + 255 * k + last;
    }
  };

  // The 255-extension at p where it ends within w, the next `valid` chunk
  // bytes from p (bytes already read): its sum, and p moved past it; else
  // read_ext's ballot from p. Only beside the 32 KB window: at 32 chunks an
  // SM, where issued instructions bound the kernel, the ballot alone is faster.
  auto ext_at = [&](uint64_t w, int valid, int& p) -> int {
    if constexpr (kWindow < 32768) return read_ext(p);
    const uint64_t ends = ~w & (valid >= 8 ? ~uint64_t{0} : (uint64_t{1} << (8 * valid)) - 1);
    if (ends == 0) return read_ext(p);
    const int k = (__ffsll(static_cast<long long>(ends)) - 1) >> 3;  // the first byte not 0xFF
    p += k + 1;
    return 255 * k + static_cast<int>((w >> (8 * k)) & 0xff);
  };

  bool err = clen <= 0 || clen > cap;
  bool ended = false;
  int ip = 0;
  int count = 0;
  uint64_t bytes = read8(0);  // the next sequence's header, read one step ahead
  while (!err && ip < clen) {
    ++count;
    const int token = static_cast<int>(bytes & 0xff);
    int lit = token >> 4;
    int lit_at = ip + 1;
    if (lit == 15) {
      const int more = ext_at(bytes >> 8, max(min(readable - lit_at, 7), 0), lit_at);
      err = more < 0;
      if (err) break;
      lit += more;
    }
    err = lit > clen - lit_at || op + lit > kMaxOut;
    if (err) break;
    const int lit_end = lit_at + lit;
    if (lit_end == clen) {  // the last sequence: literals only
      literals(lit_at, lit);
      ended = true;
      break;
    }
    pend_at = lit_at;
    pend_n = lit;
    const int lop = op + lit;  // the output after the literals
    int mat = lit_end + 2;     // the input after the offset
    err = mat > clen;
    int dist = 0;
    uint64_t w8 = 0;  // the bytes from lit_end that were read
    int w8_bytes = 0;
    if (!err) {
      const bool in_header = mat <= ip + 8;
      w8 = in_header ? bytes >> (8 * (lit_end - ip)) : read8(lit_end);
      w8_bytes = in_header ? ip + 8 - lit_end : 8;
      dist = static_cast<int>(w8 & 0xffff);
      err = dist == 0 || dist > lop;
    }
    int ml = token & 15;
    if (!err && ml == 15) {
      const int more = ext_at(w8 >> 16, max(min(readable - mat, w8_bytes - 2), 0), mat);
      err = more < 0;
      ml += more;
    }
    ml += 4;
    err = err || ml > kMaxOut - lop;
    if (err) {  // the literals count; the match does not
      literals(pend_at, pend_n);
      break;
    }
    ip = mat;
    bytes = read8(ip);  // ahead of this sequence's moves, so the two overlap
    if (pend_n > kStep / 2) {
      literals(pend_at, pend_n);
      pend_n = 0;
    }
    for (int rem = ml; rem > 0;) {  // the match in pieces at one dist
      const int piece = min(rem, kStep - pend_n);
      step(pend_n, pend_at, dist, piece);
      pend_n = 0;
      rem -= piece;
    }
  }

  w.finish(op);
  cp_async_wait_all();
  if (lane == 0) {
    out_lens[chunk] = op;
    ok[chunk] = !err && ended;
    if (steps != nullptr) steps[chunk] = count;
  }
}

template <int kWindow, int kMinBlocks>
cudaError_t launch(const uint8_t* comp, const int32_t* comp_lens, int batch,
                   int cap, uint8_t* out, int32_t* out_lens, uint8_t* ok,
                   int out_cap, int32_t* steps, cudaStream_t stream) {
  static const cudaError_t carveout = cudaFuncSetAttribute(
      lz4_decode_kernel<kWindow, kMinBlocks>,
      cudaFuncAttributePreferredSharedMemoryCarveout,
      static_cast<int>(cudaSharedmemCarveoutMaxShared));
  if (carveout != cudaSuccess) return carveout;
  lz4_decode_kernel<kWindow, kMinBlocks><<<batch, 32, 0, stream>>>(
      comp, comp_lens, cap, out, out_lens, ok, out_cap, steps);
  return cudaGetLastError();
}

}  // namespace

// Launches the decode on `stream` and returns cudaGetLastError(). The caller
// allocates every buffer: out (batch, out_cap) uint8, out_lens (batch,)
// int32, ok (batch,) bool, and steps (batch,) int32 or null.
extern "C" int acx_lz4_decode(const void* comp, const void* comp_lens,
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
