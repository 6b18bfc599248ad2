// zstd sequence execution for a whole batch of frames, one warp per frame,
// with the frame's recent output in shared memory and its sequences taken in
// rounds of 32.
//
// Replaces the TPU kernel aircompressor_tpu/ops/zstd_pallas.py::_execute_kernel
// (kernel D of the zstd device decode) and keeps its rules. A frame is a run
// of blocks, each one row of 16 int32: n_seq, seq_base, lit_total, 0, then
// four literal pieces as kind[4], src[4], end[4]. A piece covers the block's
// literal positions from the end of the piece before it (0 for the first) to
// its own end; a position takes the first piece whose end lies above it.
// PIECE_HUFF (0) reads the decoded literals at src + offset, PIECE_RAW (1) the
// input at src + offset (a byte outside its buffer reads as 0), any other
// kind is the byte src (RLE). For each of the block's sequences (ll, ml,
// offset) from seq3[seq_base + i], in order, ll literals from the block's
// literal position, then ml bytes from offset back in the frame's output;
// after the last sequence the block's trailing literals, lit_total less those
// consumed. A frame is not ok on ml < 0, ll < 0 or literal position + ll >
// lit_total; on a literal position that no piece covers; on offset <= 0 or
// past the frame's output before the match; on output past out_cap. Raw and
// RLE blocks are blocks of no sequences and one piece. ok frames get out_len
// = their output length and zeros past it; frames that are not ok get
// out_len -1 and a row of zeros.
//
// Design. Each block is one warp and executes one frame, so 256 frames spread
// over all 132 SMs. The warp keeps an output window and a literal ring of
// csrc/decode_window.cuh in shared memory and takes a block's sequences in
// rounds:
// - Lane k holds triple k of the round, loaded by the warp in one coalesced
//   pass, the next round's while this one moves its bytes. Warp prefix sums
//   of ll and ml give each sequence's literal position and output offset;
//   lengths are clamped to 65,537 first (past any out_cap, so a bad sequence
//   stays bad and the sums cannot wrap; every sequence before the first bad
//   one keeps its exact value). Every rule that makes a frame not ok is
//   checked for the whole round by one ballot: the first bad sequence is
//   judged at its exact offsets, and since a frame that is not ok becomes a
//   row of zeros, the round needs only the flag.
// - A round takes the leading sequences whose output fits kRound bytes (at
//   least one). Its literals go first, in one warp-wide pass over their
//   concatenated bytes: lane k takes bytes k, k + 32, ..., finds its
//   sequence by a binary search of the literal sums across lanes, and reads
//   the byte from the literal ring, which streams the current piece's source
//   by cp.async (a piece is resolved when the literal position reaches it, and
//   an RLE piece needs no ring). Then the round's matches, in order, each
//   with one __syncwarp(): lane k moves bytes k, k + 32, ..., four reads
//   before four writes, k mod offset of an overlapping match by the
//   reciprocal table. This order is exact: a literal's source is never the
//   output, each match's source lies before its own destination, so no later
//   literal of the round is in it, and no literal lands in a match's bytes.
//   Moving a round's independent matches in one pass instead, their bytes
//   spread over the lanes by a binary search of the ml sums, was built and
//   measured about three times slower on this card (PERF.md, PR 12): the
//   corpus's matches are long, so a search a byte costs more than the
//   barriers it saves.
// - A match with offset <= kWindow - kRound reads the window; a farther one
//   reads device memory, where the window has drained those bytes. A round
//   adds at most kRound <= kWindow / 4 bytes and the window drains when half
//   of it waits, so neither read meets a byte the round overwrote or not yet
//   drained. A sequence longer than kRound moves alone: its literals, then
//   its match, in pieces of kRound at the same offset; the block's trailing
//   literals the same way. Drains store 16-byte units; a frame that is not
//   ok stores zeros over its whole row.
//
// Two instantiations of the one template, picked by the batch: 4 KB windows
// (1 KB rounds, a 2 KB literal ring, 32 frames an SM, so 4096 frames are
// one wave) above 792 frames, and 32 KB windows (4 KB rounds, a 4 KB ring,
// 6 frames an SM) up to 792, where one wave holds the batch anyway: on the
// generated corpus 96% of the matches (and of their bytes) lie within the
// 32 KB window's reach of 28,672 against 26% within the 4 KB window's 3,072
// (zstd_decode.offset_shares).
//
// What bounds it on this card: a frame's rounds follow one another, and a
// round's matches one another, so a frame is a serial chain of shared-memory
// moves and warp barriers; the card is filled only by the frames in flight.
// The bytes bound is the triples, the literals and the output, each moved
// once.

#include "decode_window.cuh"

namespace {

constexpr int kBlockWords = 16;
constexpr int kPieceHuff = 0;
constexpr int kPieceRaw = 1;
constexpr int kPieceRle = 2;
constexpr int kSmallBatchFrames = 792;  // 6 frames an SM on 132 SMs
constexpr int kClamp = 65537;           // a length past any out_cap

template <int kWindow, int kMinBlocks>
__global__ void __launch_bounds__(32, kMinBlocks)
execute_kernel(const uint8_t* __restrict__ src, long long src_len,
               const uint8_t* __restrict__ lit, long long lit_len,
               const int32_t* __restrict__ seq3,
               const int32_t* __restrict__ frames,
               const int32_t* __restrict__ blocks, uint8_t* out, int out_cap,
               int32_t* __restrict__ out_len, uint8_t* __restrict__ ok) {
  constexpr int kRound = kWindow / 4 < 4096 ? kWindow / 4 : 4096;  // output bytes a round adds
  constexpr int kReach = kWindow - kRound;  // farthest offset read from the window
  static_assert(2 * kRound <= OutWindow<kWindow>::kFlushAt, "a far read's source is drained");
  constexpr int kRingBytes = ring_bytes(kWindow);
  __shared__ uint4 ring4[kRingBytes / 16];
  __shared__ uint4 win4[kWindow / 16];

  const int lane = threadIdx.x;
  const int f = blockIdx.x;
  uint8_t* row = out + static_cast<size_t>(f) * out_cap;
  OutWindow<kWindow> w;
  w.init(win4, row, out_cap, lane);
  InputRing<kRingBytes> in;  // started for each Huffman or raw piece; RLE reads drop its bytes
  in.ring = smem_addr(ring4);
  in.n_slices = in.issued = in.ready = in.lo = in.hi = 0;

  const int first = frames[2 * f];
  const int n_blocks = frames[2 * f + 1];
  bool err = false;
  int op = 0;

  // One match of len <= kRound bytes to position p, from offset d back: lane
  // k moves bytes k, k + 32, ..., four reads before four writes; then
  // __syncwarp().
  auto match = [&](int p, int d, int len) {
    const int from = p - d;
    if (d <= kReach) {  // from the window; reads only bytes before p
      int r = lane, stride = 32;
      if (d < len) mod_walk(d, lane, r, stride);
      for (int k0 = 0; k0 < len; k0 += 128) {
        uint32_t b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          b[i] = w.get(from + (d >= len ? k0 + 32 * i + lane : r));
          r += stride;
          if (r >= d) r -= d;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int k = k0 + 32 * i + lane;
          w.put_if(k < len, p + k, b[i]);
        }
      }
    } else {  // from device memory, drained: d > kReach >= len, no overlap
      for (int k0 = 0; k0 < len; k0 += 128) {
        uint32_t b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int k = k0 + 32 * i + lane;
          b[i] = k < len ? w.dst[from + k] : 0;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int k = k0 + 32 * i + lane;
          w.put_if(k < len, p + k, b[i]);
        }
      }
    }
    __syncwarp();
  };

  for (int b = first; b < first + n_blocks && !err; ++b) {
    const int32_t* d = blocks + static_cast<size_t>(b) * kBlockWords;
    const int n_seq = max(d[0], 0);
    const int seq_base = d[1];
    const int lit_total = d[2];
    int kind[4], psrc[4], pend[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      kind[q] = d[4 + q];
      psrc[q] = d[8 + q];
      pend[q] = d[12 + q];
    }
    const int cover = max(max(pend[0], pend[1]), max(pend[2], pend[3]));
    int litpos = 0;  // the block's literal position

    // The piece the literal stream is in: literal position pos reads source
    // index base + pos of its buffer (or is the byte rle), up to piece_end.
    int piece_end = INT_MIN, piece_kind = kPieceRle, rle = 0;
    long long base = 0;
    auto enter_piece = [&](int pos) {
      const int q = pos < pend[0] ? 0 : pos < pend[1] ? 1 : pos < pend[2] ? 2 : 3;
      const int prev = q == 0 ? 0 : q == 1 ? pend[0] : q == 2 ? pend[1] : pend[2];
      piece_end = q == 0 ? pend[0] : q == 1 ? pend[1] : q == 2 ? pend[2] : INT_MAX;
      const int k = q == 0 ? kind[0] : q == 1 ? kind[1] : q == 2 ? kind[2] : kind[3];
      const int s = q == 0 ? psrc[0] : q == 1 ? psrc[1] : q == 2 ? psrc[2] : psrc[3];
      piece_kind = k == kPieceHuff || k == kPieceRaw ? k : kPieceRle;
      rle = s & 0xff;
      base = static_cast<long long>(s) - prev;
      if (piece_kind != kPieceRle) {
        cp_async_wait_all();  // the ring's last piece may still be arriving
        __syncwarp();
        const uint8_t* buf = piece_kind == kPieceHuff ? lit : src;
        const long long len = piece_kind == kPieceHuff ? lit_len : src_len;
        in.start(smem_addr(ring4), buf, len, base + pos,
                 base + min(piece_end, cover), lane);
      }
    };

    // lt literal bytes from litpos to the window at op: byte j of the round
    // goes to op + j + the match bytes of the sequences before its own, found
    // by a binary search of the lanes' inclusive literal sums `lincl` (the
    // match sums before each lane's sequence in `mexcl`); with `single`, all
    // belong to one sequence at op.
    auto literal_pass = [&](int lt, int lincl, int mexcl, bool single) {
      for (int j = 0; j < lt;) {
        const int pos = litpos + j;
        if (pos >= piece_end) enter_piece(pos);
        int n = min(lt - j, piece_end - pos);
        int p0 = 0;
        if (piece_kind != kPieceRle) {
          p0 = static_cast<int>(base + pos - in.origin);
          in.need(p0 + 1);
          n = min(n, in.ready_end() - p0);
        }
        for (int k0 = 0; k0 < n; k0 += 128) {
          uint32_t v[4];
          int to[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int k = k0 + 32 * i + lane;  // byte j + k of the round
            int m = 0;
            if (!single) {
              int s = 0;
#pragma unroll
              for (int half = 16; half > 0; half >>= 1)
                if (__shfl_sync(kAllLanes, lincl, s + half - 1) <= j + k) s += half;
              m = __shfl_sync(kAllLanes, mexcl, s);
            }
            to[i] = op + j + k + m;
            const int p = p0 + k;
            const uint32_t byte = in.at(p);
            v[i] = piece_kind == kPieceRle ? rle : (p >= in.lo && p < in.hi ? byte : 0);
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) w.put_if(k0 + 32 * i + lane < n, to[i], v[i]);
        }
        j += n;
      }
    };

    // A literal run of n bytes alone (a long sequence's, the block's
    // trailing ones), in pieces of kRound.
    auto literal_run = [&](int n) {
      while (n > 0) {
        const int piece = min(n, kRound);
        literal_pass(piece, 0, 0, true);
        litpos += piece;
        op += piece;
        n -= piece;
        __syncwarp();
        w.drain(op);
      }
    };

    // Triples of sequences from..from+31, lane k the k-th (zeros past n_seq).
    auto load = [&](int from, int& ll, int& ml, int& of) {
      ll = ml = of = 0;
      if (from + lane < n_seq) {
        const int32_t* t = seq3 + 3 * (static_cast<long long>(seq_base) + from + lane);
        ll = t[0];
        ml = t[1];
        of = t[2];
      }
    };
    int ll, ml, of;
    load(0, ll, ml, of);
    for (int i = 0; i < n_seq;) {
      const bool live = lane < n_seq - i;
      const int llc = live ? min(max(ll, 0), kClamp) : 0;
      const int mlc = live ? min(max(ml, 0), kClamp) : 0;
      int lincl = llc, oincl = llc + mlc;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int a = __shfl_up_sync(kAllLanes, lincl, o);
        const int c = __shfl_up_sync(kAllLanes, oincl, o);
        if (lane >= o) {
          lincl += a;
          oincl += c;
        }
      }
      const int lexcl = lincl - llc, oexcl = oincl - llc - mlc;
      const unsigned fit = __ballot_sync(kAllLanes, live && oincl <= kRound);
      const int n = max(fit == kAllLanes ? 32 : __ffs(~fit) - 1, 1);
      const long long lpos = static_cast<long long>(litpos) + lexcl;
      const int dl = op + oexcl, dm = dl + llc;  // literal and match destinations
      const bool bad =
          ml < 0 || ll < 0 || lpos + ll > lit_total ||
          (ll > 0 && (lpos + ll > cover || static_cast<long long>(dl) + ll > out_cap)) ||
          (ml > 0 && (of <= 0 || of > dm || static_cast<long long>(dm) + ml > out_cap));
      if (__ballot_sync(kAllLanes, lane < n && bad) != 0) {
        err = true;
        break;
      }
      int nll, nml, nof;
      load(i + n, nll, nml, nof);  // the next round's, in flight during this one
      if (n == 1 && __shfl_sync(kAllLanes, oincl, 0) > kRound) {  // a long sequence, alone
        const int l0 = __shfl_sync(kAllLanes, llc, 0);
        const int m0 = __shfl_sync(kAllLanes, mlc, 0);
        const int of0 = __shfl_sync(kAllLanes, of, 0);
        literal_run(l0);
        for (int rem = m0; rem > 0;) {
          const int piece = min(rem, kRound);
          match(op, of0, piece);
          op += piece;
          rem -= piece;
          w.drain(op);
        }
      } else {
        const int lt = __shfl_sync(kAllLanes, lincl, n - 1);
        literal_pass(lt, lincl, oexcl - lexcl, false);
        __syncwarp();
        for (int s = 0; s < n; ++s) {
          const int m = __shfl_sync(kAllLanes, mlc, s);
          const int o = __shfl_sync(kAllLanes, of, s);
          const int p = __shfl_sync(kAllLanes, dm, s);
          if (m > 0) match(p, o, m);
        }
        litpos += lt;
        op += __shfl_sync(kAllLanes, oincl, n - 1);
        w.drain(op);
      }
      i += n;
      ll = nll;
      ml = nml;
      of = nof;
    }
    if (!err) {  // the block's trailing literals
      const long long rest = static_cast<long long>(lit_total) - litpos;
      if (rest > 0) {
        err = litpos + rest > cover || op + rest > out_cap;
        if (!err) literal_run(static_cast<int>(rest));
      }
    }
  }

  if (err) {
    w.store(0, out_cap, true);
  } else {
    w.finish(op);
  }
  cp_async_wait_all();
  if (lane == 0) {
    out_len[f] = err ? -1 : op;
    ok[f] = !err;
  }
}

template <int kWindow, int kMinBlocks>
cudaError_t launch(const uint8_t* src, long long src_len, const uint8_t* lit,
                   long long lit_len, const int32_t* seq3, const int32_t* frames,
                   const int32_t* blocks, int n_frames, uint8_t* out, int out_cap,
                   int32_t* out_len, uint8_t* ok, cudaStream_t stream) {
  static const cudaError_t carveout = cudaFuncSetAttribute(
      execute_kernel<kWindow, kMinBlocks>, cudaFuncAttributePreferredSharedMemoryCarveout,
      static_cast<int>(cudaSharedmemCarveoutMaxShared));
  if (carveout != cudaSuccess) return carveout;
  execute_kernel<kWindow, kMinBlocks><<<n_frames, 32, 0, stream>>>(
      src, src_len, lit, lit_len, seq3, frames, blocks, out, out_cap, out_len, ok);
  return cudaGetLastError();
}

}  // namespace

// Launches the execution on `stream` and returns cudaGetLastError(). The
// caller allocates out (n_frames, out_cap) uint8, out_len (n_frames,) int32
// and ok (n_frames,) bool; frames is (n_frames, 2) int32: each frame's first
// block and count.
extern "C" int acx_zstd_execute(const void* src, long long src_len,
                                const void* lit, long long lit_len,
                                const void* seq3, const void* frames,
                                const void* blocks, int n_frames, void* out,
                                int out_cap, void* out_len, void* ok,
                                void* stream) {
  if (n_frames <= 0) return static_cast<int>(cudaGetLastError());
  const auto* s = static_cast<const uint8_t*>(src);
  const auto* l = static_cast<const uint8_t*>(lit);
  const auto* t = static_cast<const int32_t*>(seq3);
  const auto* fr = static_cast<const int32_t*>(frames);
  const auto* bl = static_cast<const int32_t*>(blocks);
  auto* o = static_cast<uint8_t*>(out);
  auto* ol = static_cast<int32_t*>(out_len);
  auto* k = static_cast<uint8_t*>(ok);
  auto* st = static_cast<cudaStream_t>(stream);
  if (n_frames <= kSmallBatchFrames)
    return static_cast<int>(launch<32768, 6>(s, src_len, l, lit_len, t, fr, bl, n_frames, o,
                                             out_cap, ol, k, st));
  return static_cast<int>(launch<4096, 32>(s, src_len, l, lit_len, t, fr, bl, n_frames, o,
                                           out_cap, ol, k, st));
}
