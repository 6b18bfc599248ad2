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
// With a non-null `steps`, lane 0 also writes each chunk's steps of that
// serial scan (probes and matches; for a chunk the cap cut, STEP_CAP, or
// one more where a match took it there). A null `steps` writes nothing more.
//
// Design: rounds of 32 probes. Both tables live in dynamic shared memory as
// uint16 positions (2 x 32 KB a block, over the 48 KB default, so the launch
// opts in), 0xffff for "empty": every stored position is below 65524, so an
// empty entry fails cand < ip by itself. Between two matches the probe
// positions depend only on the anchor (p0 = ip, p_{k+1} = p_k + 1 + ((p_k -
// anchor) >> 8)), so lane k takes p_k and probes it at once:
// - its candidate in each table is the position of the highest lane j < k
//   with the same hash in that table (__match_any_sync), else the entry as
//   the round found it: what the k-th serial probe would read;
// - each lane makes the three checks on its own bytes (rep0 is fixed within
//   a round), and the first lane m that finds a match ends the round
//   (__ballot_sync): probes 0..m count as executed, and for each hash the
//   highest lane <= m that has it writes its position into the table;
//   writes of lanes above m are dropped. With no match all active lanes
//   commit and the next round starts after lane 31's position.
// A lane is active while its position is below len - 12 and the steps
// before it are below the cap, so the cap fires at the probe where the
// serial scan fires it. Forward and backward extension compare 128 bytes a
// step, 4 a lane, and __ballot_sync finds the first mismatch. The chunk's
// bytes stay in device memory (no room beside 64 KB of tables) and are read
// through the read-only path, the next 1 KB prefetched into L2 at each
// round and extension step. Lane 0 writes each sequence; all lanes zero
// the rows past the last one.
//
// What bounds it on this card: each chunk is still a serial chain, now of
// rounds and extension steps, each a few dependent trips to L1 or L2 (the
// bytes at the probes, the table entries, the candidates' bytes); 64 KB of
// tables a block allows 3 blocks (3 chunks) an SM, 396 on 132 SMs, so a
// batch of 4096 chunks takes about 10 waves. The tables in device memory
// (32 chunks an SM, one wave) measured slower at 4096 chunks: every table
// read then waits on device memory.

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

// Bytes p..p+7 of the row; all eight must lie inside it. Two aligned loads,
// each of a word that holds one of those bytes.
__device__ __forceinline__ uint64_t load8(const uint8_t* p) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  const unsigned long long* w = reinterpret_cast<const unsigned long long*>(a & ~uintptr_t{7});
  const int sh = static_cast<int>(a & 7) * 8;
  const uint64_t lo = __ldg(w);
  return sh ? (lo >> sh) | (__ldg(w + 1) << (64 - sh)) : lo;
}

// Bytes pos..pos+3 of the row (little endian), those outside [0, n) as 0.
__device__ __forceinline__ uint32_t load4(const uint8_t* row, int pos, int n) {
  if (pos >= 0 && pos + 4 <= n) {
    const uintptr_t a = reinterpret_cast<uintptr_t>(row + pos);
    const uint32_t* w = reinterpret_cast<const uint32_t*>(a & ~uintptr_t{3});
    const int sh = static_cast<int>(a & 3) * 8;
    const uint32_t lo = __ldg(w);
    return sh ? __funnelshift_r(lo, __ldg(w + 1), sh) : lo;
  }
  uint32_t v = 0;
  for (int i = 0; i < 4; ++i)
    if (pos + i >= 0 && pos + i < n) v |= static_cast<uint32_t>(__ldg(row + pos + i)) << (8 * i);
  return v;
}

__device__ __forceinline__ void prefetch_l2(const uint8_t* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

// The position of the lane-th probe from ip while no match is found.
__device__ __forceinline__ int probe_position(int ip, int anchor, int lane) {
  int d = ip - anchor;
  const int step = (d >> 8) + 1;
  if (d + 31 * step < ((d >> 8) + 1) << 8) return ip + lane * step;  // one band
  int k = lane;
  while (true) {  // band by band: in band b the step is b + 1
    const int s = (d >> 8) + 1;
    const int left = ((s << 8) - d + s - 1) / s;  // probes before the next band
    if (k < left) return anchor + d + k * s;
    d += left * s;
    k -= left;
  }
}

__global__ void __launch_bounds__(32)
zstd_dfast_kernel(const uint8_t* __restrict__ data,
                  const int32_t* __restrict__ lengths, int cap,
                  int32_t* __restrict__ ll, int32_t* __restrict__ ml,
                  int32_t* __restrict__ of, int32_t* __restrict__ nseq_out,
                  int32_t* __restrict__ last_lit, uint8_t* __restrict__ ok,
                  int32_t* __restrict__ steps_out) {
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
  const unsigned below = (1u << lane) - 1;   // lanes under this one
  const unsigned upto_me = (2u << lane) - 1;  // this lane and those under it
  int ip = 0, anchor = 0, rep0 = 1, nseq = 0, steps = 0;
  bool err = false;
  if (n >= kTailMargin + kMinMatch + 8) {
    while (ip < limit) {
      // One round: lane k probes the k-th position from ip. The lanes also
      // pull the next 1 KB of the chunk into L2, ahead of the scan.
      prefetch_l2(src + min(ip + 1024 + 32 * lane, n - 1));
      const int p = probe_position(ip, anchor, lane);
      const bool active = p < limit && steps + lane < kStepCap;
      const int n_active = __popc(__ballot_sync(kAllLanes, active));  // a prefix
      const uint64_t w = active ? load8(src + p) : 0;
      const int rep_pos = p + 1 - rep0;
      const uint32_t lo = static_cast<uint32_t>(w);
      const uint32_t b4 = static_cast<uint32_t>(w >> 32) & 0xff;
      const uint32_t hi3 = static_cast<uint32_t>(w >> 40);
      const bool rep_hit = active && rep_pos >= 0 &&
                           load4(src, rep_pos, n) == static_cast<uint32_t>(w >> 8);
      const int h_l = static_cast<int>(
          ((lo * 0x1E35A7BDu) ^ (hi3 * 0x9E3779B9u) ^ (b4 * 0x85EBCA77u)) >> (32 - kHashLog));
      const int h_s = static_cast<int>(
          ((lo * 0x9E3779B9u) ^ (b4 * 0x1E35A7BDu)) >> (32 - kHashLog));
      // Lanes with the same hash, each table apart; an idle lane matches none.
      const unsigned same_l = __match_any_sync(kAllLanes, active ? h_l : (1 << 16) | lane);
      const unsigned same_s = __match_any_sync(kAllLanes, active ? h_s : (1 << 16) | lane);
      const unsigned prev_l = same_l & below, prev_s = same_s & below;
      const int from_l = __shfl_sync(kAllLanes, p, prev_l ? 31 - __clz(prev_l) : lane);
      const int from_s = __shfl_sync(kAllLanes, p, prev_s ? 31 - __clz(prev_s) : lane);
      int cand_l = 0xffff, cand_s = 0xffff;
      if (active) {
        cand_l = prev_l ? from_l : tab_l[h_l];
        cand_s = prev_s ? from_s : tab_s[h_s];
      }
      const bool long_hit = active && !rep_hit && cand_l < p && load4(src, cand_l, n) == lo;
      const bool short_hit =
          active && !rep_hit && !long_hit && cand_s < p && load4(src, cand_s, n) == lo;
      const unsigned hits = __ballot_sync(kAllLanes, rep_hit || long_hit || short_hit);

      // Probes 0..last ran; the highest of them with each hash writes it.
      const int last = hits ? __ffs(hits) - 1 : n_active - 1;
      const unsigned ran = (2u << last) - 1;
      if (active && lane <= last) {
        if (!(same_l & ran & ~upto_me)) tab_l[h_l] = static_cast<uint16_t>(p);
        if (!(same_s & ran & ~upto_me)) tab_s[h_s] = static_cast<uint16_t>(p);
      }
      __syncwarp();
      if (!hits) {
        steps += n_active;
        if (n_active == 32) {
          ip = __shfl_sync(kAllLanes, p + 1 + ((p - anchor) >> 8), 31);
          continue;
        }
        ip = __shfl_sync(kAllLanes, p, n_active);  // the first probe not run
        err = ip < limit;  // it was below the limit: the cap stopped it
        break;
      }
      steps += last + 1;
      const int mstart = __shfl_sync(kAllLanes, rep_hit ? p + 1 : p, last);
      const int cand = __shfl_sync(
          kAllLanes, rep_hit ? rep_pos : (long_hit ? cand_l : cand_s), last);

      // Forward: the first byte that differs, or lies at or past n; lane k
      // compares bytes 4k..4k+3 of the step.
      int mlen = kMinMatch;
      while (true) {
        const int a = mstart + mlen + 4 * lane;
        prefetch_l2(src + min(a + 1024, n - 1));
        const int valid = min(max(n - a, 0), 4);
        uint32_t diff = valid ? load4(src, a, n) ^ load4(src, cand + mlen + 4 * lane, n) : 0;
        if (valid < 4) diff |= 0xffffffffu << (8 * valid);
        const unsigned mask = __ballot_sync(kAllLanes, diff != 0);
        if (mask) {
          const int f = __ffs(mask) - 1;
          const uint32_t fd = __shfl_sync(kAllLanes, diff, f);
          mlen += 4 * f + ((__ffs(fd) - 1) >> 3);
          break;
        }
        mlen += 128;
      }

      // Backward: bytes mstart-1-k against cand-1-k for k < room <= 127,
      // lane k takes k = 4k..4k+3, one step.
      const int room = min(min(mstart - anchor, cand), 127);
      int back = 0;
      if (room > 0) {
        const int q = 4 * lane;  // byte i of the words is k = q + 3 - i
        uint32_t diff = 0;
        if (q < room)
          diff = load4(src, mstart - 4 - q, n) ^ load4(src, cand - 4 - q, n);
        if (q + 4 > room)  // bytes with k >= room differ
          diff |= q >= room ? 0xffffffffu : 0xffffffffu >> (8 * (room - q));
        const unsigned mask = __ballot_sync(kAllLanes, diff != 0);
        const int f = __ffs(mask) - 1;
        const uint32_t fd = __shfl_sync(kAllLanes, diff, f);
        back = 4 * f + 3 - ((31 - __clz(fd)) >> 3);
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
    if (steps_out != nullptr) steps_out[chunk] = steps;
  }
}

}  // namespace

// Launches the matcher on `stream` and returns cudaGetLastError() (or the
// error of the shared-memory opt-in). The caller allocates every buffer: ll,
// ml, of (batch, 16384) int32, nseq and last_lit (batch,) int32, ok (batch,)
// bool, steps (batch,) int32 or null.
extern "C" int acx_zstd_dfast(const void* data, const void* lengths, int batch,
                              int cap, void* ll, void* ml, void* of, void* nseq,
                              void* last_lit, void* ok, void* steps, void* stream) {
  if (batch > 0) {
    static const cudaError_t opt_in = cudaFuncSetAttribute(
        zstd_dfast_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
    zstd_dfast_kernel<<<batch, 32, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(data), static_cast<const int32_t*>(lengths), cap,
        static_cast<int32_t*>(ll), static_cast<int32_t*>(ml), static_cast<int32_t*>(of),
        static_cast<int32_t*>(nseq), static_cast<int32_t*>(last_lit),
        static_cast<uint8_t*>(ok), static_cast<int32_t*>(steps));
  }
  return static_cast<int>(cudaGetLastError());
}
