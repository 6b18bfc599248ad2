// zstd FSE sequences sections for a whole batch of frames, one thread per
// frame, with the repeat offsets carried across the frame's blocks.
//
// Replaces the TPU kernel aircompressor_tpu/ops/zstd_pallas.py::_fse_kernel
// (kernel C of the zstd device decode) and computes what it computes, but for
// one thing: the Pallas kernel starts every sequences section at repeat
// offsets (1, 4, 8), while the format carries them from block to block within
// a frame, as the host decoder does. Here each thread walks its frame's
// sections in block order and starts at (1, 4, 8) once per frame.
//
// A section is one row of 8 int32 (byte_lo, rem, nseq, out_base, ll_state,
// of_state, ml_state, 0) and 1280 packed FSE entries (LL 512, OF 256, ML 512;
// each sym | nbits << 6 | new_state_base << 10). Per sequence: the three
// states are looked up; extra bits are read in the order OF, ML, LL; an OF
// code above 23 sets err (and reads 23 bits); the repeat offsets resolve as
// RFC 8878 3.1.1.5, and one that resolves to <= 0 sets err; unless it is the
// section's last sequence, the states update in the order LL, ML, OF. Bits
// are read backward from `rem`, and bits below the stream's start read as 0;
// a section that reads below it sets err. The (ll, ml, offset) triple goes to
// seq3[out_base + i]; the section's final rem and err go out.
//
// Design: a 64-bit window of the stream, refilled with 8 byte loads when a
// read falls below it; LL and ML baselines and extra-bit counts in constant
// memory; FSE entries read through the read-only cache.
//
// What bounds it on this card: each sequence's reads depend on the state
// lookups of the one before, and the repeat offsets chain the sections of a
// frame, so one frame is a serial chain of dependent table lookups. The bytes
// bound (the sections and their tables read once, 12 bytes a sequence
// written) is small beside it, and a batch of 4096 frames is only 4096
// threads. Left for later: one thread per section with the repeat offsets
// resolved in a second pass, since they depend only on the offset values.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 32;
constexpr int kParamWords = 8;
constexpr int kTableWords = 1280;
constexpr int kOfTable = 512;
constexpr int kMlTable = 768;

__constant__ int32_t kLLBase[36] = {
    0,    1,    2,    3,    4,     5,     6,     7,     8,    9,    10,   11,
    12,   13,   14,   15,   16,    18,    20,    22,    24,   28,   32,   40,
    48,   64,   128,  256,  512,   1024,  2048,  4096,  8192, 16384, 32768, 65536};
__constant__ int32_t kLLBits[36] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,  0,  1,  1,
    1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
__constant__ int32_t kMLBase[53] = {
    3,  4,  5,  6,  7,  8,  9,  10, 11,  12,  13,  14,   15,   16,
    17, 18, 19, 20, 21, 22, 23, 24, 25,  26,  27,  28,   29,   30,
    31, 32, 33, 34, 35, 37, 39, 41, 43,  47,  51,  59,   67,   83,
    99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
__constant__ int32_t kMLBits[53] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1,
    2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};

struct BitWindow {
  const uint8_t* src;
  long long src_len;
  long long byte_lo;
  int base;  // bit position of the window's lowest bit, a multiple of 8
  uint64_t win;

  // Bits [pos, pos + n) of the stream, n <= 32, reads going downward; bits
  // below the stream's start are 0.
  __device__ __forceinline__ uint32_t read(int pos, int n) {
    if (n <= 0 || pos + n <= 0) return 0;
    if (pos < base) {  // the window [base, base + 64) must hold [pos, pos + n)
      base = ((pos + n - 57) >> 3) << 3;
      win = 0;
      const int b0 = base >> 3;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const long long idx = byte_lo + b0 + k;
        if (b0 + k >= 0 && idx < src_len)
          win |= static_cast<uint64_t>(__ldg(src + idx)) << (8 * k);
      }
    }
    return static_cast<uint32_t>(win >> (pos - base)) &
           static_cast<uint32_t>((1ull << n) - 1);
  }
};

__global__ void __launch_bounds__(kThreads)
fse_kernel(const uint8_t* __restrict__ src, long long src_len,
           const int32_t* __restrict__ params, const int32_t* __restrict__ tabs,
           const int32_t* __restrict__ frames, int n_frames,
           int32_t* __restrict__ seq3, int32_t* __restrict__ rem_out,
           int32_t* __restrict__ err_out) {
  const int f = blockIdx.x * kThreads + threadIdx.x;
  if (f >= n_frames) return;
  const int first = frames[2 * f];
  const int count = frames[2 * f + 1];
  int rep0 = 1, rep1 = 4, rep2 = 8;
  for (int s = first; s < first + count; ++s) {
    const int32_t* p = params + static_cast<size_t>(s) * kParamWords;
    const int32_t* tab = tabs + static_cast<size_t>(s) * kTableWords;
    BitWindow bits{src, src_len, p[0], INT_MAX, 0};
    int rem = p[1];
    const int nseq = p[2];
    int32_t* out = seq3 + 3 * static_cast<size_t>(p[3]);
    int lls = p[4], ofs = p[5], mls = p[6];
    int err = 0;
    for (int i = 0; i < nseq; ++i) {
      const int le = __ldg(tab + (lls & 511));
      const int oe = __ldg(tab + kOfTable + (ofs & 255));
      const int me = __ldg(tab + kMlTable + (mls & 511));
      const int llc = le & 63, mlc = me & 63;
      int ofc = oe & 63;
      if (ofc > 23) {
        err = 1;
        ofc = 23;
      }
      const int ll_bits = llc < 36 ? kLLBits[llc] : 0;
      const int ml_bits = mlc < 53 ? kMLBits[mlc] : 0;
      int pos = rem - ofc;
      const int of_value = (1 << ofc) + static_cast<int>(bits.read(pos, ofc));
      pos -= ml_bits;
      const int ml = (mlc < 53 ? kMLBase[mlc] : 0) +
                     static_cast<int>(bits.read(pos, ml_bits));
      pos -= ll_bits;
      const int ll = (llc < 36 ? kLLBase[llc] : 0) +
                     static_cast<int>(bits.read(pos, ll_bits));

      int offset;
      if (of_value > 3) {
        offset = of_value - 3;
        rep2 = rep1;
        rep1 = rep0;
        rep0 = offset;
      } else {
        const int idx = of_value - 1 + (ll == 0 ? 1 : 0);
        if (idx == 0) {
          offset = rep0;
        } else {
          offset = idx == 1 ? rep1 : idx == 2 ? rep2 : rep0 - 1;
          if (offset <= 0) err = 1;
          if (idx != 1) rep2 = rep1;
          rep1 = rep0;
          rep0 = offset;
        }
      }

      if (i != nseq - 1) {
        const int ll_nb = (le >> 6) & 15, ml_nb = (me >> 6) & 15,
                  of_nb = (oe >> 6) & 15;
        pos -= ll_nb;
        lls = (le >> 10) + static_cast<int>(bits.read(pos, ll_nb));
        pos -= ml_nb;
        mls = (me >> 10) + static_cast<int>(bits.read(pos, ml_nb));
        pos -= of_nb;
        ofs = (oe >> 10) + static_cast<int>(bits.read(pos, of_nb));
      }
      if (pos < 0) err = 1;
      rem = pos;
      out[3 * i] = ll;
      out[3 * i + 1] = ml;
      out[3 * i + 2] = offset;
    }
    rem_out[s] = rem;
    err_out[s] = err;
  }
}

}  // namespace

// Launches the decode on `stream` and returns cudaGetLastError(). The caller
// allocates seq3 (slots, 3) int32 and rem_out, err_out (sections,) int32;
// frames is (n_frames, 2) int32: each frame's first section and count.
extern "C" int acx_zstd_fse(const void* src, long long src_len,
                            const void* params, const void* tabs,
                            const void* frames, int n_frames, void* seq3,
                            void* rem_out, void* err_out, void* stream) {
  if (n_frames > 0) {
    const int blocks = (n_frames + kThreads - 1) / kThreads;
    fse_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(src), src_len,
        static_cast<const int32_t*>(params), static_cast<const int32_t*>(tabs),
        static_cast<const int32_t*>(frames), n_frames,
        static_cast<int32_t*>(seq3), static_cast<int32_t*>(rem_out),
        static_cast<int32_t*>(err_out));
  }
  return static_cast<int>(cudaGetLastError());
}
