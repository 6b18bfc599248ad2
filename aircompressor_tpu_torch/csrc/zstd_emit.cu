// zstd entropy emission for a batch of planned blocks: four Huffman literal
// streams and one FSE sequences bitstream a block, one warp per block.
//
// Replaces aircompressor_tpu/ops/zstd_encode_jax.py::_emit_device with its
// bit packer _pack_bits (XLA there, not Pallas: a per-symbol gather and a
// serial three-state walk, which in tensor ops is a loop of thousands of
// dependent steps) and writes what it writes, byte for byte: for each row,
// four streams of (4, 24576) bytes and their bit totals, and one sequences
// stream of 98304 bytes and its bit total, zero past each stream's last byte.
// A stream packs its ops least significant bit first, each value masked to
// its width (widths are clamped to [0, 31]; the packer gives none outside),
// then one end-mark bit. Huffman stream s takes the literals of its segment
// [start, start + count) in reverse order, code and length from the row's
// table. The sequences stream, in writer order: the extra bits of the last
// sequence (LL, ML, OF); for i = nseq - 2 down to 0, the OF, ML and LL state
// bits, then the LL, ML and OF extra bits of sequence i; then the final ML,
// OF and LL states at their table logs. A state starts at ns[((nb0 << 16) -
// d) >> nb0 + f] with nb0 = (d + 2^15) >> 16 for the last sequence's code; a
// step writes the state at nb = (st + d) >> 16 bits and moves to
// ns[(st >> nb) + f], every table index clamped as the JAX function clamps
// it. A row with nseq = 0 writes no sequence bits but the end mark.
//
// Design: lane s < 4 of a row's warp writes Huffman stream s and lane 4 the
// sequences stream, each with a 64-bit bit accumulator that stores whole
// bytes forward; the Huffman codes and the three FSE tables sit in shared
// memory. A store at or past a stream's capacity is dropped and the bit
// total still counts it, so the caller sees an overflow (none is possible
// for a planned block of 64 KB: 16384 symbols of at most 11 bits, 8192
// sequences of at most 76 bits). Then all 32 lanes zero the tails.
//
// What bounds it on this card: each stream is a serial chain, one symbol or
// one sequence a step, the sequences stream the longest (three dependent
// table loads a sequence); 5 of 32 lanes work during it. Rows run in
// parallel, 32 warps an SM. Left for later: splitting the Huffman streams
// across lanes by prefix sums of code lengths, as the plain version does.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLitCap = 65536;
constexpr int kSegCap = kLitCap / 4;
constexpr int kLStreamCap = 24576;
constexpr int kSCap = 8192;
constexpr int kSStreamCap = 98304;
constexpr int kNsCap = 512;
constexpr int kSymCap = 64;

struct BitWriter {
  uint8_t* dst;
  int cap;
  int pos = 0;
  int total = 0;
  int nacc = 0;
  uint64_t acc = 0;

  __device__ BitWriter(uint8_t* d, int c) : dst(d), cap(c) {}

  __device__ __forceinline__ void put(uint64_t byte) {
    if (pos < cap) dst[pos] = static_cast<uint8_t>(byte);
    ++pos;
  }

  __device__ __forceinline__ void add(int32_t value, int nb) {
    nb = min(max(nb, 0), 31);
    if (nb == 0) return;
    acc |= (static_cast<uint64_t>(static_cast<uint32_t>(value)) & ((1ull << nb) - 1)) << nacc;
    nacc += nb;
    total += nb;
    while (nacc >= 8) {
      put(acc);
      acc >>= 8;
      nacc -= 8;
    }
  }

  // The end-mark bit, then the last partial byte.
  __device__ __forceinline__ void finish() {
    acc |= 1ull << nacc;
    for (nacc += 1; nacc > 0; nacc -= 8) {
      put(acc);
      acc >>= 8;
    }
  }
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return min(max(v, lo), hi); }

__global__ void __launch_bounds__(32)
zstd_emit_kernel(const uint8_t* __restrict__ lit, const int32_t* __restrict__ lit_seg,
                 const int32_t* __restrict__ huff, const int32_t* __restrict__ seq,
                 const int32_t* __restrict__ nseq_in, const int32_t* __restrict__ fse_sym,
                 const int32_t* __restrict__ fse_ns, const int32_t* __restrict__ flush_bits,
                 uint8_t* __restrict__ lit_bytes, int32_t* __restrict__ lit_tot,
                 uint8_t* __restrict__ seq_bytes, int32_t* __restrict__ seq_tot) {
  __shared__ int32_t s_huff[2 * 256];          // codes, then bit counts
  __shared__ int32_t s_sym[3 * 2 * kSymCap];   // LL, ML, OF: delta_nb_bits, delta_find_state
  __shared__ int32_t s_ns[3 * kNsCap];         // LL, ML, OF: next_state
  __shared__ int s_end[5];                     // each stream's bytes written, capped
  const int lane = threadIdx.x;
  const size_t row = blockIdx.x;

  for (int i = lane; i < 2 * 256; i += 32) s_huff[i] = huff[row * 2 * 256 + i];
  for (int i = lane; i < 3 * 2 * kSymCap; i += 32) s_sym[i] = fse_sym[row * 3 * 2 * kSymCap + i];
  for (int i = lane; i < 3 * kNsCap; i += 32) s_ns[i] = fse_ns[row * 3 * kNsCap + i];
  __syncthreads();

  if (lane < 4) {
    BitWriter w(lit_bytes + (row * 4 + lane) * kLStreamCap, kLStreamCap);
    const uint8_t* lrow = lit + row * kLitCap;
    const int start = lit_seg[(row * 4 + lane) * 2];
    const int cnt = lit_seg[(row * 4 + lane) * 2 + 1];
    const int steps = clampi(cnt, 0, kSegCap);
    for (int j = 0; j < steps; ++j) {
      const int sym = lrow[clampi(start + cnt - 1 - j, 0, kLitCap - 1)];
      w.add(s_huff[sym], s_huff[256 + sym]);
    }
    w.finish();
    lit_tot[row * 4 + lane] = w.total;
    s_end[lane] = min(w.pos, w.cap);
  } else if (lane == 4) {
    BitWriter w(seq_bytes + row * kSStreamCap, kSStreamCap);
    const int32_t* fields = seq + row * 9 * kSCap;  // ll, ml, of codes; extras; extra bits
    const int nseq = clampi(nseq_in[row], 0, kSCap);
    const int last = max(nseq - 1, 0);
    int st[3];
    for (int f = 0; f < 3; ++f) {  // LL, ML, OF
      const int c = clampi(fields[f * kSCap + last], 0, kSymCap - 1);
      const int d = s_sym[(f * 2) * kSymCap + c];
      const int fs = s_sym[(f * 2 + 1) * kSymCap + c];
      const int nb = clampi((d + (1 << 15)) >> 16, 0, 31);
      const int sub = ((nb << 16) - d) >> nb;
      st[f] = s_ns[f * kNsCap + clampi(sub + fs, 0, kNsCap - 1)];
    }
    if (nseq > 0)
      for (int f = 0; f < 3; ++f) w.add(fields[(3 + f) * kSCap + last], fields[(6 + f) * kSCap + last]);
    for (int i = last - 1; i >= 0; --i) {
      for (int f = 2; f >= 0; --f) {  // OF, ML, LL
        const int c = clampi(fields[f * kSCap + i], 0, kSymCap - 1);
        const int d = s_sym[(f * 2) * kSymCap + c];
        const int fs = s_sym[(f * 2 + 1) * kSymCap + c];
        const int nb = clampi((st[f] + d) >> 16, 0, 31);
        w.add(st[f], nb);
        st[f] = s_ns[f * kNsCap + clampi((st[f] >> nb) + fs, 0, kNsCap - 1)];
      }
      for (int f = 0; f < 3; ++f) w.add(fields[(3 + f) * kSCap + i], fields[(6 + f) * kSCap + i]);
    }
    if (nseq > 0) {
      const int32_t* fb = flush_bits + row * 3;  // ML, OF, LL
      w.add(st[1], fb[0]);
      w.add(st[2], fb[1]);
      w.add(st[0], fb[2]);
    }
    w.finish();
    seq_tot[row] = w.total;
    s_end[4] = min(w.pos, w.cap);
  }
  __syncthreads();

  // Zero each stream past its last byte: bytes up to a 16-byte boundary,
  // then 16 a lane.
  for (int s = 0; s < 5; ++s) {
    uint8_t* dst = s < 4 ? lit_bytes + (row * 4 + s) * kLStreamCap : seq_bytes + row * kSStreamCap;
    const int cap = s < 4 ? kLStreamCap : kSStreamCap;
    const int end = s_end[s];
    const int aligned = min((end + 15) & ~15, cap);
    for (int j = end + lane; j < aligned; j += 32) dst[j] = 0;
    uint4* dst4 = reinterpret_cast<uint4*>(dst);
    for (int j = aligned / 16 + lane; j < cap / 16; j += 32) dst4[j] = make_uint4(0, 0, 0, 0);
  }
}

}  // namespace

// Launches the emission on `stream` and returns cudaGetLastError(). The
// inputs are contiguous: lit (batch, 65536) uint8, lit_seg (batch, 4, 2),
// huff (batch, 2, 256), seq (batch, 9, 8192), nseq (batch,), fse_sym (batch,
// 3, 2, 64), fse_ns (batch, 3, 512), flush_bits (batch, 3), all int32. The
// caller allocates the outputs: lit_bytes (batch, 4, 24576) uint8, lit_tot
// (batch, 4) int32, seq_bytes (batch, 98304) uint8, seq_tot (batch,) int32.
extern "C" int acx_zstd_emit(const void* lit, const void* lit_seg, const void* huff,
                             const void* seq, const void* nseq, const void* fse_sym,
                             const void* fse_ns, const void* flush_bits, int batch,
                             void* lit_bytes, void* lit_tot, void* seq_bytes,
                             void* seq_tot, void* stream) {
  if (batch > 0) {
    zstd_emit_kernel<<<batch, 32, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(lit), static_cast<const int32_t*>(lit_seg),
        static_cast<const int32_t*>(huff), static_cast<const int32_t*>(seq),
        static_cast<const int32_t*>(nseq), static_cast<const int32_t*>(fse_sym),
        static_cast<const int32_t*>(fse_ns), static_cast<const int32_t*>(flush_bits),
        static_cast<uint8_t*>(lit_bytes), static_cast<int32_t*>(lit_tot),
        static_cast<uint8_t*>(seq_bytes), static_cast<int32_t*>(seq_tot));
  }
  return static_cast<int>(cudaGetLastError());
}
