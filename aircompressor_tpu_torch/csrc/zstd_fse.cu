// zstd FSE sequences sections for a whole batch of frames, a group of 8
// lanes per frame, with the repeat offsets carried across the frame's
// blocks.
//
// Replaces the TPU kernel aircompressor_tpu/ops/zstd_pallas.py::_fse_kernel
// (kernel C of the zstd device decode) and computes what it computes, but for
// one thing: the Pallas kernel starts every sequences section at repeat
// offsets (1, 4, 8), while the format carries them from block to block within
// a frame, as the host decoder does. Here each frame's sections are walked
// in block order, starting at (1, 4, 8) once per frame.
//
// A section is one row of 8 int32 (byte_lo, rem, nseq, out_base, ll_state,
// of_state, ml_state, logs: ll_log | of_log << 8 | ml_log << 16) and 1280
// packed FSE entries (LL 512, OF 256, ML 512; each sym | nbits << 6 |
// new_state_base << 10, nothing above bit 19), of which a table of log L
// uses the first 2^L (L at most 9, 8, 9). A state indexes its table mod
// 2^L: the plain version's mod 512 and 256 give the same entry for every
// state below 2^L, which is every state a table built from a normalized
// distribution gives (its initial states are L bits, its next states
// base + bits below 2^L). Per sequence: the
// three states are looked up; extra bits are read in the order OF, ML, LL;
// an OF code above 23 sets err (and reads 23 bits); the repeat offsets
// resolve as RFC 8878 3.1.1.5, and one that resolves to <= 0 sets err;
// unless it is the section's last sequence, the states update in the order
// LL, ML, OF. Bits are read backward from `rem`, and bits below the
// stream's start (or past the input) read as 0; a section that reads below
// its start sets err. The (ll, ml, offset) triple goes to seq3[out_base + i];
// the section's final rem and err go out.
//
// What bounds it on this card: each sequence's reads depend on the states
// and the bit position the one before left, and the repeat offsets chain
// the sections of a frame, so a frame is a serial chain; the bytes bound
// (the sections and their tables read once, 12 bytes a sequence written) is
// small beside it. A group of lanes walks one chain, in order, so what
// sets a frame's time is the instructions of a step and the loads it waits
// for. The design keeps every access of the chain in shared memory:
// - Table. For each section the lanes stage the 2^L entries each of LL, OF
//   and ML uses into the frame's 1280 words of shared memory by cp.async
//   (at the corpus's logs about a third of them), then fold each
//   LL and ML entry's extra-bit count into its bits 20-24, so that the
//   entries alone give every bit count of the sequence.
// - Bits. The section's bytes come through a backward ring in shared memory
//   (csrc/decode_window.cuh, BackRing: 1 KB, slices of 256 B issued from the
//   top of the section down, all lanes issuing). A 64-bit window ending at
//   the sequence's bit position comes from two 8-byte loads of the ring; a
//   sequence of at most 57 bits reads every field from it in registers (a
//   longer one reloads it).
// - Walk. Every lane of the frame's group runs the same walk on the same
//   values (its loads are shared-memory broadcasts), so the group walks as
//   one lane with no divergence, and all its lanes reach the ring's need()
//   together and issue the next slice. Each sequence issues the next one's
//   three table loads and window loads as soon as its states and bit
//   position are known, before its own repeat offsets and stores, which
//   cover their latency. Lane k of the group keeps the triple of every
//   sequence k mod (group size), and the group stores them together after
//   each round of that many sequences: 12-byte triples, coalesced.
// - Launch. One warp a block walks four frames, one a group of 8 lanes, so
//   that four frames share each instruction where a large batch makes the
//   SMs issue-bound: 6,144 B of tables and ring a frame, so 4096 frames run
//   in one wave. One frame a warp measured 6% faster at 256 frames and 2.8x
//   slower at 4096 (PERF.md). The code baselines of a sequence
//   come from constant memory (the same code for every lane: a copy in
//   shared memory measured no faster); the fold, whose lanes look up
//   different codes, reads a copy in shared memory.

#include "decode_window.cuh"

namespace {

constexpr int kParamWords = 8;
constexpr int kTableWords = 1280;
constexpr int kOfTable = 512;
constexpr int kMlTable = 768;
constexpr int kRingBytes = 1024;  // the backward ring: four slices of 256 B
constexpr int kFrameBytes = 4 * kTableWords + kRingBytes;  // a frame's shared memory
constexpr int kLanes = 8;             // lanes a frame
constexpr int kGroups = 32 / kLanes;  // frames a warp (one warp a block)
constexpr int kXBits = 20;        // a staged LL or ML entry's extra-bit count
constexpr int kLLCodes = 36, kMLCodes = 53;
constexpr int kCodeSlots = 64;  // a code is 6 bits: codes past a table give 0

// Baseline | extra-bit count << 24 of LL codes 0-35 at 0-35, and of ML
// codes 0-52 at 64-116; 0 elsewhere.
__constant__ uint32_t kCodes[2 * kCodeSlots] = {
    0,          1,          2,          3,          4,          5,
    6,          7,          8,          9,          10,         11,
    12,         13,         14,         15,         16 | 1 << 24, 18 | 1 << 24,
    20 | 1 << 24, 22 | 1 << 24, 24 | 2 << 24, 28 | 2 << 24, 32 | 3 << 24, 40 | 3 << 24,
    48 | 4 << 24, 64 | 6 << 24, 128 | 7 << 24, 256 | 8 << 24, 512 | 9 << 24, 1024 | 10 << 24,
    2048 | 11 << 24, 4096 | 12 << 24, 8192 | 13 << 24, 16384 | 14 << 24, 32768 | 15 << 24,
    65536 | 16u << 24,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    3,  4,  5,  6,  7,  8,  9,  10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20,
    21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34,
    35 | 1 << 24, 37 | 1 << 24, 39 | 1 << 24, 41 | 1 << 24, 43 | 2 << 24, 47 | 2 << 24,
    51 | 3 << 24, 59 | 3 << 24, 67 | 4 << 24, 83 | 4 << 24, 99 | 5 << 24, 131 | 7 << 24,
    259 | 8 << 24, 515 | 9 << 24, 1027 | 10 << 24, 2051 | 11 << 24, 4099 | 12 << 24,
    8195 | 13 << 24, 16387 | 14 << 24, 32771 | 15 << 24, 65539 | 16u << 24,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
static_assert(kLLCodes + 28 == kCodeSlots && kMLCodes + 11 == kCodeSlots, "padded tables");

__device__ __forceinline__ uint32_t lds_u32(uint32_t a) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];" : "=r"(v) : "r"(a));
  return v;
}

__device__ __forceinline__ void sts_u32(uint32_t a, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;" ::"r"(a), "r"(v) : "memory");
}

// n <= 23 bits of w from bit s, 0 <= s <= 64 - n.
__device__ __forceinline__ int take_bits(uint64_t w, int s, int n) {
  return static_cast<int>(static_cast<uint32_t>(w >> min(s, 63)) & ((1u << n) - 1));
}

// Stages n words of a packed table (n a power of two) to shared address
// `to`: 16-byte cp.async units where n >= 4, else word copies.
__device__ __forceinline__ void stage(uint32_t to, const int32_t* row, int n, int gl) {
  if (n >= 4) {
    for (int k = 4 * gl; k < n; k += 4 * kLanes) cp_async16(to + 4 * k, row + k);
  } else if (gl < n) {
    sts_u32(to + 4 * gl, static_cast<uint32_t>(__ldg(row + gl)));
  }
}

__global__ void __launch_bounds__(32)
fse_kernel(const uint8_t* __restrict__ src, long long src_len,
           const int32_t* __restrict__ params, const int32_t* __restrict__ tabs,
           const int32_t* __restrict__ frames, int n_frames,
           int32_t* __restrict__ seq3, int32_t* __restrict__ rem_out,
           int32_t* __restrict__ err_out) {
  __shared__ uint4 frames_s[kGroups * kFrameBytes / 16];  // each frame: tables, ring
  __shared__ uint32_t codes_s[2 * kCodeSlots];
  const int lane = threadIdx.x;
  for (int k = lane; k < 2 * kCodeSlots; k += 32) codes_s[k] = kCodes[k];
  __syncwarp();
  const int group = lane / kLanes;
  const int gl = static_cast<int>(opaque(lane % kLanes));
  const unsigned mask = ((1u << kLanes) - 1) << (group * kLanes);
  const int f = blockIdx.x * kGroups + group;
  if (f >= n_frames) return;  // the same for every lane of the group
  const uint32_t codes = opaque(smem_addr(codes_s));
  const uint32_t tab = opaque(smem_addr(frames_s) + group * kFrameBytes);
  const uint32_t ring_s = tab + 4 * kTableWords;

  const int first = frames[2 * f];
  const int count = frames[2 * f + 1];
  int rep0 = 1, rep1 = 4, rep2 = 8;
  BackRing<kRingBytes, kLanes> ring;
  for (int s = first; s < first + count; ++s) {
    const int32_t* p = params + static_cast<size_t>(s) * kParamWords;
    const int32_t* row = tabs + static_cast<size_t>(s) * kTableWords;
    const long long byte_lo = p[0];
    int rem = p[1];
    const int nseq = p[2];
    int32_t* out = seq3 + 3 * static_cast<size_t>(p[3]);
    int lls = p[4], ofs = p[5], mls = p[6];
    const int logs = p[7];
    const int ll_n = 1 << min(logs & 255, 9), of_n = 1 << min((logs >> 8) & 255, 8),
              ml_n = 1 << min((logs >> 16) & 255, 9);

    // The previous section's ring copies have landed and every lane is done
    // with its table: stage this one's, start its ring, then fold the
    // extra-bit counts into the LL and ML entries.
    cp_async_wait_all();
    __syncwarp(mask);
    stage(tab, row, ll_n, gl);
    stage(tab + 4 * kOfTable, row + kOfTable, of_n, gl);
    stage(tab + 4 * kMlTable, row + kMlTable, ml_n, gl);
    cp_async_commit();
    const long long top = byte_lo + max((rem + 7) >> 3, 0);  // bytes that hold bits below rem
    ring.start(ring_s, src, src_len, byte_lo, top, gl, mask);
    ring.ring = opaque(ring.ring);
    const int lo = ring.lo;
    const int valid = ring.hi - lo;  // section bytes [0, valid) are loaded
    cp_async_wait_pending<BackRing<kRingBytes, kLanes>::kAhead>();  // the table
    __syncwarp(mask);
    for (int k = gl; k < ll_n + ml_n; k += kLanes) {
      const bool ll = k < ll_n;
      const uint32_t a = tab + 4 * (ll ? k : kMlTable + k - ll_n);
      const uint32_t e = lds_u32(a);
      const uint32_t c = lds_u32(codes + 4 * ((ll ? 0 : kCodeSlots) + (e & 63)));
      sts_u32(a, e | (c >> 24) << kXBits);
    }
    __syncwarp(mask);
    // Loop invariants, kept in registers.
    const uint32_t t_ll = opaque(tab), t_of = opaque(tab + 4 * kOfTable),
                   t_ml = opaque(tab + 4 * kMlTable);
    const int m_ll = static_cast<int>(opaque(ll_n - 1)),
              m_of = static_cast<int>(opaque(of_n - 1)),
              m_ml = static_cast<int>(opaque(ml_n - 1));

    // The window: section bytes [b, b + 8) (0 outside [0, valid)), from the
    // ring, as bits [wb, wb + 64): fetched (two 8-byte loads), then formed.
    uint64_t win = 0, wx = 0, wy = 0;
    int wb = 0, wbyte = 0;
    auto fetch = [&](int b) {
      ring.need(max(b, 0) + lo);
      const int a = (b + lo) & ~7;
      wx = ring.at8(a);
      wy = ring.at8(a + 8);
      wbyte = b;
    };
    auto form = [&] {
      const int b = wbyte, sh = 8 * ((b + lo) & 7);
      win = (wx >> sh) | ((wy << (63 - sh)) << 1);
      wb = 8 * b;
      if (__builtin_expect(b < 0 || b > valid - 8, 0)) {  // near the section's ends only
        const int cut = min(-b, 8), keep = max(valid - b, 0);
        if (cut > 0) win = cut == 8 ? 0 : win & (~0ull << (8 * cut));
        if (keep < 8) win &= (1ull << (8 * keep)) - 1;
      }
    };

    // Software-pipelined: each sequence issues the next one's table and
    // window loads before its own output work, which covers their latency.
    int err = 0;
    int keep_ll = 0, keep_ml = 0, keep_of = 0;  // the triple this lane stores
    int le = static_cast<int>(lds_u32(t_ll + 4 * (lls & m_ll)));
    int oe = static_cast<int>(lds_u32(t_of + 4 * (ofs & m_of)));
    int me = static_cast<int>(lds_u32(t_ml + 4 * (mls & m_ml)));
    fetch(((rem + 7) >> 3) - 8);  // at least 57 bits below rem
    for (int i = 0; i < nseq; ++i) {
      form();
      int ofc = oe & 63;
      err |= ofc > 23;
      ofc = min(ofc, 23);
      const bool last = i == nseq - 1;
      // Widths, then positions, of the six reads: OF, ML and LL extra bits,
      // then the LL, ML and OF state bits (none after the last sequence).
      const int n1 = ofc, n2 = (me >> kXBits) & 31, n3 = (le >> kXBits) & 31;
      const int n4 = last ? 0 : (le >> 6) & 15, n5 = last ? 0 : (me >> 6) & 15,
                n6 = last ? 0 : (oe >> 6) & 15;
      const int p1 = rem - n1, p2 = p1 - n2, p3 = rem - (n1 + n2 + n3);
      const int p4 = p3 - n4, p5 = p4 - n5, p6 = p3 - (n4 + n5 + n6);
      int v1, v2, v3, v4, v5, v6;
      if (__builtin_expect(p6 >= wb, 1)) {  // every read lies in the window
        v1 = take_bits(win, p1 - wb, n1);
        v2 = take_bits(win, p2 - wb, n2);
        v3 = take_bits(win, p3 - wb, n3);
        v4 = take_bits(win, p4 - wb, n4);
        v5 = take_bits(win, p5 - wb, n5);
        v6 = take_bits(win, p6 - wb, n6);
      } else {  // reload, ending at the top byte of the first read below
        auto bits = [&](int at, int n) -> int {
          if (n == 0) return 0;
          if (at < wb) {
            fetch(((at + n + 7) >> 3) - 8);
            form();
          }
          return take_bits(win, at - wb, n);
        };
        v1 = bits(p1, n1);
        v2 = bits(p2, n2);
        v3 = bits(p3, n3);
        v4 = bits(p4, n4);
        v5 = bits(p5, n5);
        v6 = bits(p6, n6);
      }
      lls = ((le >> 10) & 1023) + v4;
      mls = ((me >> 10) & 1023) + v5;
      ofs = ((oe >> 10) & 1023) + v6;
      err |= p6 < 0;
      rem = p6;
      const int llc = le & 63, mlc = me & 63;
      const uint32_t ml_code = kCodes[kCodeSlots + mlc];
      const uint32_t ll_code = kCodes[llc];
      // The next sequence's loads (harmless after the last one: the states
      // index their tables, and the window lies in the ring).
      le = static_cast<int>(lds_u32(t_ll + 4 * (lls & m_ll)));
      oe = static_cast<int>(lds_u32(t_of + 4 * (ofs & m_of)));
      me = static_cast<int>(lds_u32(t_ml + 4 * (mls & m_ml)));
      fetch(((rem + 7) >> 3) - 8);

      // Repeat offsets (RFC 8878 3.1.1.5); ll is 0 exactly for LL code 0 and
      // the codes past the table (baseline 0, no extra bits).
      const int of_value = (1 << ofc) + v1;
      // As selects: a branch here is taken on most sequences.
      const bool direct = of_value > 3;
      const int idx = direct ? 4 : of_value - 1 + (llc == 0 || llc >= kLLCodes ? 1 : 0);
      const int offset = direct ? of_value - 3
                                : idx == 0 ? rep0 : idx == 1 ? rep1 : idx == 2 ? rep2 : rep0 - 1;
      err |= !direct && idx != 0 && offset <= 0;
      rep2 = idx >= 2 ? rep1 : rep2;
      rep1 = idx != 0 ? rep0 : rep1;
      rep0 = offset;
      const int ml = static_cast<int>(ml_code & 0xffffff) + v2;
      const int ll = static_cast<int>(ll_code & 0xffffff) + v3;

      const int k = i & (kLanes - 1);
      keep_ll = gl == k ? ll : keep_ll;
      keep_ml = gl == k ? ml : keep_ml;
      keep_of = gl == k ? offset : keep_of;
      if (__builtin_expect(k == kLanes - 1 || last, 0)) {
        if (gl <= k) {
          int32_t* o = out + 3 * static_cast<size_t>(i - k + gl);
          o[0] = keep_ll;
          o[1] = keep_ml;
          o[2] = keep_of;
        }
      }
    }
    if (gl == 0) {
      rem_out[s] = rem;
      err_out[s] = err;
    }
  }
  cp_async_wait_all();
}

}  // namespace

// Launches the decode on `stream` and returns cudaGetLastError(). The caller
// allocates seq3 (slots, 3) int32 and rem_out, err_out (sections,) int32;
// frames is (n_frames, 2) int32: each frame's first section and count;
// tabs must be 16-byte aligned.
extern "C" int acx_zstd_fse(const void* src, long long src_len,
                            const void* params, const void* tabs,
                            const void* frames, int n_frames,
                            void* seq3, void* rem_out, void* err_out, void* stream) {
  if (n_frames <= 0) return static_cast<int>(cudaGetLastError());
  static const cudaError_t carveout = cudaFuncSetAttribute(
      fse_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      static_cast<int>(cudaSharedmemCarveoutMaxShared));
  if (carveout != cudaSuccess) return carveout;
  const int blocks = (n_frames + kGroups - 1) / kGroups;
  fse_kernel<<<blocks, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(src), src_len, static_cast<const int32_t*>(params),
      static_cast<const int32_t*>(tabs), static_cast<const int32_t*>(frames), n_frames,
      static_cast<int32_t*>(seq3), static_cast<int32_t*>(rem_out),
      static_cast<int32_t*>(err_out));
  return cudaGetLastError();
}

// Blocks of one warp (four frames) that fit an SM (a negative CUDA error
// where the query fails).
extern "C" int acx_zstd_fse_blocks_per_sm() {
  int n = 0;
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fse_kernel, 32, 0);
  return e == cudaSuccess ? n : -static_cast<int>(e);
}
