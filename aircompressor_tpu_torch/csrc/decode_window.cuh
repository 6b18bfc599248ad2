// Shared-memory staging for the decode kernels that keep a chunk's input and
// its recent output in shared memory: cp.async wrappers, an input ring, an
// output window that drains to device memory in 16-byte stores, and a
// reciprocal table for k mod d, and a backward ring for bit streams read
// from their end. Used by csrc/lzo_decode.cu, csrc/lz4_decode.cu,
// csrc/snappy_decode_r2.cu and csrc/zstd_execute.cu (the input ring and
// the output window: one warp runs each) and csrc/zstd_fse.cu (the
// backward ring: a warp, or a group of lanes of one).
//
// Input ring (kRingBytes, slices of 512 B: 2 KB beside a small window, 4 KB
// beside a 32 KB one). A byte stream of a device buffer is addressed by ring
// coordinates P = index - origin, where origin puts coordinate 0 on a
// 16-byte boundary of the buffer's address, so a 16-byte unit of device
// memory is a 16-byte unit of the ring. Slices arrive by cp.async, 16 B a
// lane, all but two slices of the ring ahead of the one being read: a slice
// is issued only once the one a ring back is consumed, so after need(end)
// the bytes of the two slices below the ready line are readable and the
// caller reads nothing older. Bytes outside [lo, hi) are never loaded; the
// caller reads them as 0.
//
// Output window (kWindow bytes, a power of two) holding the most recent
// output, addressed by (position + so) mod kWindow, so being the row's
// address mod 16. It drains to device memory in 16-byte stores (bytes only
// where a row's edge cuts a unit) whenever kWindow / 2 bytes are waiting,
// then __syncwarp(): at any step start fewer than kWindow / 2 bytes wait, so
// a step may add up to the kernel's own limit without overwriting a byte not
// yet drained. Nothing is stored at or past out_cap.

#pragma once

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kAllLanes = 0xffffffffu;
constexpr int kSlice = 512;  // input ring bytes of one cp.async a lane

// The input ring beside an output window of this size.
__host__ __device__ constexpr int ring_bytes(int window) { return window >= 32768 ? 4096 : 2048; }

// ceil(65536 / d) for d in [1, 64): (k * kRecip[d]) >> 16 == k / d for every
// k < 64, which gives an overlapping copy's k mod d without a division.
__constant__ uint32_t kRecip[64] = {
    0, 65536, 32768, 21846, 16384, 13108, 10923, 9363, 8192, 7282, 6554, 5958,
    5462, 5042, 4682, 4370, 4096, 3856, 3641, 3450, 3277, 3121, 2979, 2850,
    2731, 2622, 2521, 2428, 2341, 2260, 2185, 2115, 2048, 1986, 1928, 1873,
    1821, 1772, 1725, 1681, 1639, 1599, 1561, 1525, 1490, 1457, 1425, 1395,
    1366, 1338, 1311, 1286, 1261, 1237, 1214, 1192, 1171, 1150, 1130, 1111,
    1093, 1075, 1058, 1041};

// Shared memory by 32-bit shared addresses. The ring and window accesses go
// through these so that each is one LDS or STS: addressed from a generic
// pointer inside branches, the compiler recomputes the shared base for every
// access. Loads read any slot (their value is dropped where unused); a store
// takes a predicate.
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// v, kept in a register: the compiler may not rebuild it (a shared base it
// would otherwise recompute from SR_CgaCtaId at each use inside a loop).
__device__ __forceinline__ uint32_t opaque(uint32_t v) {
  asm volatile("" : "+r"(v));
  return v;
}

__device__ __forceinline__ uint32_t lds_u8(uint32_t a) {
  uint32_t v;
  asm volatile("ld.shared.u8 %0, [%1];" : "=r"(v) : "r"(a));
  return v;
}

__device__ __forceinline__ uint64_t lds_u64(uint32_t a) {
  uint64_t v;
  asm volatile("ld.shared.u64 %0, [%1];" : "=l"(v) : "r"(a));
  return v;
}

__device__ __forceinline__ uint4 lds_u128(uint32_t a) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "r"(a));
  return v;
}

__device__ __forceinline__ void sts_u8_if(bool pred, uint32_t a, uint32_t v) {
  asm volatile("{\n .reg .pred q;\n setp.ne.b32 q, %0, 0;\n @q st.shared.u8 [%1], %2;\n}"
               ::"r"(static_cast<int>(pred)), "r"(a), "r"(v) : "memory");
}

__device__ __forceinline__ void cp_async16(uint32_t s, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait_pending() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The start and step of k mod d for k = lane, lane + 32, lane + 64, ...: a
// copy at distance d of more than d bytes repeats its first d. Add step to
// the residue after each 32 bytes and subtract d once where it reaches d.
__device__ __forceinline__ void mod_walk(int d, int lane, int& r, int& step) {
  r = lane;
  step = 32;
  if (d <= 32) {
    const uint32_t m = kRecip[d];
    r -= d * static_cast<int>((static_cast<uint32_t>(lane) * m) >> 16);
    step -= d * static_cast<int>((32u * m) >> 16);
  }
}

template <int kRingBytes>
struct InputRing {
  static constexpr int kAhead = kRingBytes / kSlice - 2;  // slices in flight
  uint32_t ring;          // shared address of kRingBytes, 16-byte aligned
  const uint8_t* base16;  // device address of ring coordinate 0
  int lo, hi;             // ring coordinates of the bytes to load
  int alo, ahi;           // coordinates a 16-byte cp.async may cover
  int n_slices, issued, ready, lane;
  long long origin;       // the buffer index at ring coordinate 0

  // Streams buf[from, to) of a buffer whose readable indices are [0, len);
  // the coordinate of index from is its address mod 16. Issues the first
  // kAhead slices. Any cp.async still in flight into the ring must be waited
  // for first (wait_all) when the ring is reused.
  __device__ __forceinline__ void start(uint32_t ring_, const uint8_t* buf, long long len,
                                        long long from, long long to, int lane_) {
    ring = ring_;
    lane = lane_;
    origin = from - static_cast<long long>(reinterpret_cast<uintptr_t>(buf + from) & 15);
    base16 = buf + origin;
    const long long a = max(-origin, 0LL), b = min(len - origin, static_cast<long long>(INT_MAX));
    alo = static_cast<int>(min(a, static_cast<long long>(INT_MAX)));
    ahi = static_cast<int>(max(b, 0LL));
    lo = max(alo, static_cast<int>(from - origin));
    hi = min(ahi, static_cast<int>(min(max(to - origin, 0LL), static_cast<long long>(INT_MAX))));
    n_slices = hi > lo ? (hi + kSlice - 1) / kSlice : 0;
    issued = ready = hi > lo ? lo / kSlice : 0;
#pragma unroll
    for (int k = 0; k < kAhead; ++k) issue();
  }

  // Slice `issued`: the 16-byte units of [q * kSlice, (q + 1) * kSlice)
  // that hold bytes of [lo, hi), one a lane; units that reach outside
  // [alo, ahi) by bytes.
  __device__ __forceinline__ void issue() {
    if (issued < n_slices) {
      const int u = issued * kSlice + 16 * lane;
      if (u < hi && u + 16 > lo) {
        const uint32_t to = ring + (u & (kRingBytes - 1));
        if (u >= alo && u + 16 <= ahi) {
          cp_async16(to, base16 + u);
        } else {
          for (int p = max(u, lo); p < min(u + 16, hi); ++p) sts_u8_if(true, to + (p - u), base16[p]);
        }
      }
    }
    cp_async_commit();  // one group per slice, empty or not
    ++issued;
  }

  // Ring bytes below coordinate `end` have arrived and are visible to the
  // warp.
  __device__ __forceinline__ void need(int end) {
    while (ready < n_slices && ready * kSlice < end) {
      cp_async_wait_pending<kAhead - 1>();
      __syncwarp();
      ++ready;
      issue();
    }
  }

  // The coordinate below which every byte is readable now (all of them
  // once the last slice with bytes has arrived).
  __device__ __forceinline__ int ready_end() const {
    return ready >= n_slices ? INT_MAX : ready * kSlice;
  }

  // The lowest coordinate still readable after need(end): need() may issue
  // slices into the places of older ones.
  __device__ __forceinline__ int kept_from(int end) const {
    const int r = max(ready, min(n_slices, (end + kSlice - 1) / kSlice));
    return (r - 2) * kSlice;
  }

  __device__ __forceinline__ uint32_t at(int p) const {
    return lds_u8(ring + (p & (kRingBytes - 1)));
  }

  // The 8 ring bytes from coordinate p, a multiple of 8.
  __device__ __forceinline__ uint64_t at8(int p) const {
    return lds_u64(ring + (p & (kRingBytes - 1)));
  }
};

// Backward ring (kRingBytes in slices of kBackSlice bytes) for a byte
// stream read from its end toward its start, as a backward bit stream is.
// Coordinates as the input ring's: P = index - origin, with coordinate 0 on
// a 16-byte boundary of the buffer's address. Slices arrive by cp.async
// from the top down, 16 B a lane of the kLanes lanes that run the ring
// (under `mask`: a warp, or a group of lanes of one), all but two slices of
// the ring ahead of the one being read: a slice is issued only once the
// one a ring above is consumed, so after need(c) the bytes from c to the
// top of the slice above the one holding c are readable (at least
// kBackSlice bytes from c). Bytes outside [lo, hi) are never loaded; the
// caller reads them as 0.
constexpr int kBackSlice = 256;

template <int kRingBytes, int kLanes>
struct BackRing {
  static constexpr int kAhead = kRingBytes / kBackSlice - 2;  // slices in flight
  static_assert(kAhead >= 1, "a backward ring holds at least three slices");
  uint32_t ring;          // shared address of kRingBytes, 16-byte aligned
  const uint8_t* base16;  // device address of ring coordinate 0
  int lo, hi;             // ring coordinates of the bytes to load
  int alo, ahi;           // coordinates a 16-byte cp.async may cover
  int next;               // the next slice to issue (counting down; < 0: none)
  int ready;              // the lowest slice that has arrived
  int lane;               // this lane's place among the kLanes
  unsigned mask;

  // Streams buf[from, to) of a buffer whose readable indices are [0, len),
  // from its top down; the coordinate of index from is its address mod 16,
  // so slice 0 is the last. Issues the first kAhead slices. Any cp.async still in flight into
  // the ring must be waited for first (wait_all) when the ring is reused.
  __device__ __forceinline__ void start(uint32_t ring_, const uint8_t* buf, long long len,
                                        long long from, long long to, int lane_,
                                        unsigned mask_) {
    ring = ring_;
    lane = lane_;
    mask = mask_;
    const long long origin =
        from - static_cast<long long>(reinterpret_cast<uintptr_t>(buf + from) & 15);
    base16 = buf + origin;
    alo = static_cast<int>(max(-origin, static_cast<long long>(INT_MIN)));
    ahi = static_cast<int>(min(max(len - origin, 0LL), static_cast<long long>(INT_MAX)));
    lo = static_cast<int>(from - origin);
    hi = static_cast<int>(min(max(min(to, len) - origin, static_cast<long long>(lo)),
                              static_cast<long long>(INT_MAX)));
    next = hi > lo ? (hi - 1) / kBackSlice : -1;
    ready = next + 1;
#pragma unroll
    for (int k = 0; k < kAhead; ++k) issue();
  }

  // Slice `next`: its 16-byte units that hold bytes of [lo, hi), kLanes at
  // a time; units that reach outside [alo, ahi) by bytes.
  __device__ __forceinline__ void issue() {
    if (next >= 0) {
      for (int u = next * kBackSlice + 16 * lane; u < (next + 1) * kBackSlice; u += 16 * kLanes) {
        if (u < hi && u + 16 > lo) {
          const uint32_t to = ring + (u & (kRingBytes - 1));
          if (u >= alo && u + 16 <= ahi) {
            cp_async16(to, base16 + u);
          } else {
            for (int p = max(u, lo); p < min(u + 16, hi); ++p) sts_u8_if(true, to + (p - u), base16[p]);
          }
        }
      }
    }
    cp_async_commit();  // one group per slice, empty or not
    --next;
  }

  // Ring bytes from coordinate c upward (to the top of the slice above c's)
  // have arrived and are visible to the lanes of `mask`.
  __device__ __forceinline__ void need(int c) {
    while (__builtin_expect(ready > 0 && ready * kBackSlice > c, 0)) {
      cp_async_wait_pending<kAhead - 1>();
      __syncwarp(mask);
      --ready;
      issue();
    }
  }

  // The 8 ring bytes from coordinate p, a multiple of 8.
  __device__ __forceinline__ uint64_t at8(int p) const {
    return lds_u64(ring + (p & (kRingBytes - 1)));
  }
};

template <int kWindow>
struct OutWindow {
  static constexpr int kFlushAt = kWindow / 2;  // bytes waiting that start a drain
  uint32_t win;    // shared address of the window
  uint8_t* dst16;  // the row's address rounded down to 16 bytes
  const uint8_t* dst;
  int so, out_cap, lane;
  int flushed;   // output bytes below this are in device memory (or >= out_cap)
  int drain_at;  // op that starts the next drain; none once out_cap is stored

  __device__ __forceinline__ void init(uint4* win4, uint8_t* row, int out_cap_, int lane_) {
    win = smem_addr(win4);
    so = static_cast<int>(reinterpret_cast<uintptr_t>(row) & 15);
    dst16 = row - so;
    dst = row;
    out_cap = out_cap_;
    lane = lane_;
    flushed = 0;
    drain_at = kFlushAt;
  }

  __device__ __forceinline__ int slot(int pos) const { return (pos + so) & (kWindow - 1); }

  // The byte the window holds for output position pos.
  __device__ __forceinline__ uint32_t get(int pos) const { return lds_u8(win + slot(pos)); }

  // Output byte v at position pos, where pred.
  __device__ __forceinline__ void put_if(bool pred, int pos, uint32_t v) const {
    sts_u8_if(pred, win + slot(pos), v);
  }

  // Device-memory stores of window bytes [a, b) (b <= out_cap), or zeros.
  __device__ __forceinline__ void store(int a, int b, bool zeros) {
    const int ap = a + so, bp = b + so;
    for (int u = (ap >> 4) + lane; u < ((bp + 15) >> 4); u += 32) {
      const int ulo = max(u << 4, ap), uhi = min((u << 4) + 16, bp);
      if (uhi - ulo == 16) {
        reinterpret_cast<uint4*>(dst16)[u] =
            zeros ? make_uint4(0, 0, 0, 0) : lds_u128(win + ((u << 4) & (kWindow - 1)));
      } else {
        for (int p = ulo; p < uhi; ++p)
          dst16[p] = zeros ? 0 : static_cast<uint8_t>(lds_u8(win + (p & (kWindow - 1))));
      }
    }
  }

  // After a __syncwarp(): drains up to the last 16-byte unit below op once
  // kFlushAt bytes wait (all of the row once op passes out_cap).
  __device__ __forceinline__ void drain(int op) {
    if (op >= drain_at) {
      const int lim = op >= out_cap ? out_cap : ((op + so) & ~15) - so;
      store(flushed, lim, false);
      flushed = lim;
      drain_at = flushed < out_cap ? flushed + kFlushAt : INT_MAX;
      __syncwarp();
    }
  }

  // The rest of the row after output op: what the window still holds, then
  // the zero tail.
  __device__ __forceinline__ void finish(int op) {
    if (op < out_cap) {
      const int unit_end = min(((op + so + 15) & ~15) - so, out_cap);
      for (int p = op + lane; p < unit_end; p += 32) put_if(true, p, 0);
      __syncwarp();
      store(flushed, unit_end, false);
      store(unit_end, out_cap, true);
    } else if (flushed < out_cap) {
      store(flushed, out_cap, false);
    }
  }
};

}  // namespace
