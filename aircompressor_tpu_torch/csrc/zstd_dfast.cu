// zstd level-3 DFAST match finding for a batch of chunks of at most 64 KB, one
// warp per chunk.
//
// Replaces the TPU kernel aircompressor_tpu/ops/zstd_dfast_pallas.py::
// _encode_kernel and computes what it computes, output for output: a (B, cap)
// uint8 batch with (B,) int32 lengths (clamped to [0, cap]) gives (B, 16384)
// int32 literal lengths, match lengths and real offsets, zero at and past
// each chunk's sequence count, and (B,) int32 nseq and last_lit and (B,) ok
// flags. The matcher (see ops/zstd_dfast.py for the list): a long table (hash
// of 8 bytes) and a short one (hash of 5 bytes), 2^14 entries each; while ip
// < len - 12 every probe reads both entries at ip and then writes ip into
// both; priority repeat offset at ip + 1, then long, then short, each needing
// 4 equal bytes (no long probe at ip + 1); a miss advances by 1 + ((ip -
// anchor) >> 8); forward extension to the chunk's end, backward extension by
// at most min(mstart - anchor, cand, 127) bytes keeping the offset; rep0
// starts at 1 and takes each match's offset; a chunk under 24 bytes has no
// sequences. Each chunk has its own cap of 4 * 65536 steps (a probe or a
// match each), which no chunk of 64 KB reaches; one that does is not ok.
//
// Design: the whole warp walks the same chunk with the same scan state. Both
// tables live in dynamic shared memory as uint16 positions (2 x 32 KB a
// block, over the 48 KB default, so the launch opts in), 0xffff for "empty":
// every stored position is below 65524, so an empty entry fails cand < ip by
// itself. Lane 0 reads and writes the tables and __shfl_sync hands the two
// candidates to every lane. Forward and backward extension compare 32 bytes
// a step, one a lane, and __ballot_sync finds the first mismatch. Lane 0
// writes each sequence; all lanes zero the rows past the last one.
//
// What bounds it on this card: the scan is a serial chain per chunk, each
// probe's position depending on the probe before, with a table lookup and
// loads of the candidates' bytes from device memory on its path. The card is
// filled only by the chunks in flight: 64 KB of tables a block allows 3
// blocks (3 chunks) an SM, 396 on 132 SMs. Left for later: staging the chunk
// in shared memory, probing the next positions on idle lanes, smaller tables.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kHashLog = 14;
constexpr int kTableSize = 1 << kHashLog;
constexpr int kSeqCap = 16384;
constexpr int kTailMargin = 12;
constexpr int kMinMatch = 4;
constexpr int kStepCap = 4 * 65536;
constexpr int kSmemBytes = 2 * kTableSize * static_cast<int>(sizeof(uint16_t));
constexpr unsigned kAllLanes = 0xffffffffu;

__device__ __forceinline__ uint32_t load_u32(const uint8_t* p) {
  return static_cast<uint32_t>(p[0]) | (static_cast<uint32_t>(p[1]) << 8) |
         (static_cast<uint32_t>(p[2]) << 16) | (static_cast<uint32_t>(p[3]) << 24);
}

__global__ void __launch_bounds__(32)
zstd_dfast_kernel(const uint8_t* __restrict__ data,
                  const int32_t* __restrict__ lengths, int cap,
                  int32_t* __restrict__ ll, int32_t* __restrict__ ml,
                  int32_t* __restrict__ of, int32_t* __restrict__ nseq_out,
                  int32_t* __restrict__ last_lit, uint8_t* __restrict__ ok) {
  extern __shared__ uint4 tables4[];
  uint16_t* tab_l = reinterpret_cast<uint16_t*>(tables4);
  uint16_t* tab_s = tab_l + kTableSize;
  const int lane = threadIdx.x;
  const int chunk = blockIdx.x;
  const uint8_t* src = data + static_cast<size_t>(chunk) * cap;
  int32_t* ll_row = ll + static_cast<size_t>(chunk) * kSeqCap;
  int32_t* ml_row = ml + static_cast<size_t>(chunk) * kSeqCap;
  int32_t* of_row = of + static_cast<size_t>(chunk) * kSeqCap;
  const int n = min(max(lengths[chunk], 0), cap);

  for (int i = lane; i < kSmemBytes / 16; i += 32)
    tables4[i] = make_uint4(kAllLanes, kAllLanes, kAllLanes, kAllLanes);
  __syncwarp();

  const int limit = n - kTailMargin;
  int ip = 0, anchor = 0, rep0 = 1, nseq = 0, steps = 0;
  bool err = false;
  if (n >= kTailMargin + kMinMatch + 8) {
    while (ip < limit) {
      if (steps >= kStepCap) {
        err = true;
        break;
      }
      ++steps;
      const uint32_t lo = load_u32(src + ip);
      const uint32_t b4 = src[ip + 4];
      const uint32_t hi3 = static_cast<uint32_t>(src[ip + 5]) |
                           (static_cast<uint32_t>(src[ip + 6]) << 8) |
                           (static_cast<uint32_t>(src[ip + 7]) << 16);
      const int h_l = static_cast<int>(
          ((lo * 0x1E35A7BDu) ^ (hi3 * 0x9E3779B9u) ^ (b4 * 0x85EBCA77u)) >> (32 - kHashLog));
      const int h_s = static_cast<int>(
          ((lo * 0x9E3779B9u) ^ (b4 * 0x1E35A7BDu)) >> (32 - kHashLog));
      int cand_l = 0, cand_s = 0;
      if (lane == 0) {
        cand_l = tab_l[h_l];
        cand_s = tab_s[h_s];
        tab_l[h_l] = static_cast<uint16_t>(ip);
        tab_s[h_s] = static_cast<uint16_t>(ip);
      }
      cand_l = __shfl_sync(kAllLanes, cand_l, 0);
      cand_s = __shfl_sync(kAllLanes, cand_s, 0);

      const int ip1 = ip + 1;
      const int rep_pos = ip1 - rep0;
      int mstart, cand;
      if (rep0 > 0 && rep_pos >= 0 && load_u32(src + rep_pos) == load_u32(src + ip1)) {
        mstart = ip1;
        cand = rep_pos;
      } else if (cand_l < ip && load_u32(src + cand_l) == lo) {
        mstart = ip;
        cand = cand_l;
      } else if (cand_s < ip && load_u32(src + cand_s) == lo) {
        mstart = ip;
        cand = cand_s;
      } else {
        ip += 1 + ((ip - anchor) >> 8);
        continue;
      }

      // Forward: the first lane whose byte differs, or lies at or past n.
      int mlen = kMinMatch;
      while (true) {
        const int a = mstart + mlen + lane;
        const bool diff = a >= n || src[a] != src[cand + mlen + lane];
        const unsigned mask = __ballot_sync(kAllLanes, diff);
        if (mask) {
          mlen += __ffs(mask) - 1;
          break;
        }
        mlen += 32;
      }

      // Backward: bytes mstart-1-k against cand-1-k for k < room.
      const int room = min(min(mstart - anchor, cand), 127);
      int back = 0;
      while (back < room) {
        const int k = back + lane;
        const bool diff = k >= room || src[mstart - 1 - k] != src[cand - 1 - k];
        const unsigned mask = __ballot_sync(kAllLanes, diff);
        if (mask) {
          back += __ffs(mask) - 1;
          break;
        }
        back += 32;
      }

      ++steps;
      const int f_start = mstart - back;
      const int f_len = mlen + back;
      const int f_ll = f_start - anchor;
      const int moff = mstart - cand;
      if (lane == 0 && nseq < kSeqCap) {
        ll_row[nseq] = f_ll;
        ml_row[nseq] = f_len;
        of_row[nseq] = moff;
      }
      ++nseq;
      rep0 = moff;
      ip = anchor = f_start + f_len;
      if (nseq > kSeqCap || f_ll < 0 || moff <= 0 || moff > f_start) {
        err = true;
        break;
      }
    }
  }

  for (int j = min(nseq, kSeqCap) + lane; j < kSeqCap; j += 32) {
    ll_row[j] = 0;
    ml_row[j] = 0;
    of_row[j] = 0;
  }
  if (lane == 0) {
    nseq_out[chunk] = nseq;
    last_lit[chunk] = n - anchor;
    ok[chunk] = !err;
  }
}

}  // namespace

// Launches the matcher on `stream` and returns cudaGetLastError() (or the
// error of the shared-memory opt-in). The caller allocates every buffer: ll,
// ml, of (batch, 16384) int32, nseq and last_lit (batch,) int32, ok (batch,)
// bool.
extern "C" int acx_zstd_dfast(const void* data, const void* lengths, int batch,
                              int cap, void* ll, void* ml, void* of, void* nseq,
                              void* last_lit, void* ok, void* stream) {
  if (batch > 0) {
    static const cudaError_t opt_in = cudaFuncSetAttribute(
        zstd_dfast_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
    zstd_dfast_kernel<<<batch, 32, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(data), static_cast<const int32_t*>(lengths), cap,
        static_cast<int32_t*>(ll), static_cast<int32_t*>(ml), static_cast<int32_t*>(of),
        static_cast<int32_t*>(nseq), static_cast<int32_t*>(last_lit),
        static_cast<uint8_t*>(ok));
  }
  return static_cast<int>(cudaGetLastError());
}
