// zstd sequence execution for a whole batch of frames, one warp per frame.
//
// Replaces the TPU kernel aircompressor_tpu/ops/zstd_pallas.py::_execute_kernel
// (kernel D of the zstd device decode) and keeps its rules. A frame is a run
// of blocks, each one row of 16 int32: n_seq, seq_base, lit_total, 0, then
// four literal pieces as kind[4], src[4], end[4]. A piece covers the block's
// literal positions from the end of the piece before it (0 for the first) to
// its own end; a position takes the first piece whose end lies above it.
// PIECE_HUFF (0) reads the decoded literals at src + offset, PIECE_RAW (1) the
// input at src + offset, any other kind is the byte src (RLE). For each of
// the block's sequences (ll, ml, offset) from seq3[seq_base + i], the warp
// copies ll literals from the block's literal position, then ml bytes from
// offset back in the frame's output; after the last sequence it copies the
// block's trailing literals, lit_total less those consumed. A frame is not
// ok on ml < 0, ll < 0 or literal position + ll > lit_total; on a literal
// position that no piece covers; on offset <= 0 or past the frame's output
// before the match; on output past out_cap. Raw and RLE blocks are blocks of
// no sequences and one piece. ok frames get out_len = their output length
// and zeros past it; frames that are not ok get out_len -1 and a row of
// zeros.
//
// Design: as csrc/lz4_decode.cu. Every lane reads the same descriptor and
// triple (one address, one transaction); literals are copied by all 32
// lanes, each finding its byte's piece; a match writes out[op + k] =
// out[op - offset + k % offset], exact for overlapping matches in one pass
// since it reads only bytes before op. __syncwarp() after each copy makes
// its stores visible to the next copy's loads.
//
// What bounds it on this card: the sequences of a frame run one after
// another, each copy a few dependent loads and stores, so a frame is a
// serial chain; the card is filled only by the frames in flight (one warp
// each). The bytes bound is the triples, the literals and the output, each
// moved once. Left for later: output staged in shared memory, 16-byte
// stores, and splitting a frame's sequences across warps once their output
// offsets are known from a prefix sum.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kBlockWords = 16;
constexpr int kPieceHuff = 0;
constexpr int kPieceRaw = 1;

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
execute_kernel(const uint8_t* __restrict__ src, long long src_len,
               const uint8_t* __restrict__ lit, long long lit_len,
               const int32_t* __restrict__ seq3,
               const int32_t* __restrict__ frames,
               const int32_t* __restrict__ blocks, int n_frames, uint8_t* out,
               int out_cap, int32_t* __restrict__ out_len,
               uint8_t* __restrict__ ok) {
  const int lane = threadIdx.x & 31;
  const int f = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (f >= n_frames) return;  // the same for every lane of the warp
  uint8_t* dst = out + static_cast<size_t>(f) * out_cap;
  const int first = frames[2 * f];
  const int n_blocks = frames[2 * f + 1];

  bool err = false;
  int op = 0;
  for (int b = first; b < first + n_blocks && !err; ++b) {
    const int32_t* d = blocks + static_cast<size_t>(b) * kBlockWords;
    const int n_seq = max(d[0], 0);
    const int seq_base = d[1];
    const int lit_total = d[2];
    int kind[4], psrc[4], pend[4], cover = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      kind[q] = d[4 + q];
      psrc[q] = d[8 + q];
      pend[q] = d[12 + q];
      cover = max(cover, pend[q]);
    }
    int litpos = 0;
    for (int i = 0; i <= n_seq; ++i) {
      int ll, ml = 0, dist = 0;
      if (i < n_seq) {
        const int32_t* t = seq3 + 3 * (static_cast<size_t>(seq_base) + i);
        ll = t[0];
        ml = t[1];
        dist = t[2];
        if (ml < 0 || ll < 0 || litpos + ll > lit_total) {
          err = true;
          break;
        }
      } else {
        ll = lit_total - litpos;  // the block's trailing literals
      }
      if (ll > 0) {
        if (litpos + ll > cover || op + ll > out_cap) {
          err = true;
          break;
        }
        for (int k = lane; k < ll; k += 32) {
          const int pos = litpos + k;
          int q = 0, prev = 0;
          while (q < 3 && pos >= pend[q]) prev = pend[q++];
          const long long at = static_cast<long long>(psrc[q]) + (pos - prev);
          uint8_t byte;
          if (kind[q] == kPieceHuff)
            byte = (at >= 0 && at < lit_len) ? lit[at] : 0;
          else if (kind[q] == kPieceRaw)
            byte = (at >= 0 && at < src_len) ? src[at] : 0;
          else
            byte = static_cast<uint8_t>(psrc[q]);
          dst[op + k] = byte;
        }
        op += ll;
        litpos += ll;
        __syncwarp();
      }
      if (ml > 0) {
        if (dist <= 0 || dist > op || op + ml > out_cap) {
          err = true;
          break;
        }
        const uint8_t* from = dst + (op - dist);
        for (int k = lane; k < ml; k += 32)
          dst[op + k] = from[dist >= ml ? k : k % dist];
        op += ml;
        __syncwarp();
      }
    }
  }

  for (int j = (err ? 0 : op) + lane; j < out_cap; j += 32) dst[j] = 0;
  if (lane == 0) {
    out_len[f] = err ? -1 : op;
    ok[f] = !err;
  }
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
  if (n_frames > 0) {
    const int grid = (n_frames + kWarpsPerBlock - 1) / kWarpsPerBlock;
    execute_kernel<<<grid, kWarpsPerBlock * 32, 0,
                     static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(src), src_len,
        static_cast<const uint8_t*>(lit), lit_len,
        static_cast<const int32_t*>(seq3), static_cast<const int32_t*>(frames),
        static_cast<const int32_t*>(blocks), n_frames,
        static_cast<uint8_t*>(out), out_cap, static_cast<int32_t*>(out_len),
        static_cast<uint8_t*>(ok));
  }
  return static_cast<int>(cudaGetLastError());
}
