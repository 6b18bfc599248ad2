// Raw-deflate (RFC 1951) decode for a batch of chunks of at most 64 KB out,
// one warp per chunk, from the host planner's block descriptors and tables.
//
// Replaces the TPU kernel
// aircompressor_tpu/ops/deflate_pallas_w.py::_decode_kernel and keeps its
// rules. The planner (aircompressor_tpu_torch/host/deflate/inflate_plan.cc)
// gives each chunk its blocks, 8 int32 fields each (type 0 stored or 1
// Huffman, data bit position, literal/length and distance root bases, stored
// byte offset and length, final flag), and its tables of entries
// (op << 28) | (nbits << 22) | val with 9-bit roots; a root entry of op 5
// (subtable) sends the lookup to entry val + the next nbits bits after the
// root's 9. The kernel takes the blocks in order:
//   stored: its bytes are copied; bad where the extent leaves the chunk;
//   Huffman: from its bit position, each literal/length symbol is looked up
//   in 15 bits (bits past the chunk read as 0): a literal is written, a
//   length adds its extra bits and is followed by a distance symbol and its
//   extra bits, then a copy of that length from that distance back; the
//   end-of-block symbol ends the block.
// The final flag of a block ends the chunk. An entry of op 0 or with no bits,
// a literal/length symbol that is a distance or a subtable, a distance
// symbol that is not a distance, a symbol whose bits (extra bits included)
// end past the chunk, a distance of 0 or before the output's start, a block
// past the plan's, or output past 64 KB fails the chunk; it stops there, and
// its output length counts the bytes produced before. ok = the final block
// ended with no error. Bytes at or past the output length are zero. (A
// subtable index is at most 6 bits and an extra-bit count 4 bits: the
// planner makes no larger ones, and the cut keeps a shift defined.)
//
// With a non-null `steps`, lane 0 also writes the iterations of the symbol
// loop for each chunk, summed over its Huffman blocks: one for each
// literal/length symbol looked up (a length with its distance is one), the
// end-of-block symbol and the failing one included; stored blocks add none.
// A null `steps` writes nothing more.
//
// Design. One warp decodes one chunk; the lanes walk the symbol chain
// together with the same bit buffer, so control flow never diverges. Each
// warp keeps three things in shared memory:
// - Table slot (kSlot = 1280 entries). At each Huffman block the warp copies
//   entries [lo, lo + kSlot) of the chunk's tables, lo the lower of the two
//   roots, entries outside the chunk's as 0, so root lookups read shared
//   memory with no bounds check (a fixed block's two roots take 1024; a
//   dynamic block's two roots and the literal/length subtables up to 256
//   more). A subtable entry outside the slot reads device memory, bounds
//   checked. A block whose roots do not both fit reads all its tables from
//   device memory, bounds checked, in a second instantiation of the loop.
// - Input ring (kRing bytes, four quarters). Quarters arrive by cp.async,
//   two ahead of the one being read, from the block's first byte on (the
//   ring restarts at each Huffman block); bytes at or past the chunk's
//   length arrive as 0. The 64-bit bit buffer refills with one unaligned
//   64-bit read from the ring, branch-free, beside the root lookup of the
//   same symbol, whenever fewer than 32 bits are left (the lookup needs 15,
//   a literal takes at most 15). Bit positions are 32-bit counts from the
//   block's first bit.
// - Output window (kWindow bytes) holding the most recent output. Literals
//   and copies write into it; a copy with dist <= kWindow - 258 reads its
//   source there, byte k of it from k mod dist; a farther one reads device
//   memory. The window drains with 16-byte stores (bytes where a row's edge
//   cuts a unit) once kFlush bytes wait, so at every step fewer than kFlush
//   wait and a step adds at most 258 (a longer copy or stored block goes in
//   pieces): kFlush + 258 <= kWindow keeps every undrained byte, and
//   kFlush <= kWindow - 514 puts a far copy's source in device memory. The
//   zero tail is stored the same way; bytes at or past out_cap never are.
// A literal whose bits end inside the chunk and whose byte lies below
// out_cap with no drain due goes around a tight loop: the root lookup (the
// slot's entries were validated when it was filled), the refill when due,
// the byte stored by every lane (the same byte to the same address, so no
// lane branches off), with the slot's and the window's shared-memory bases
// held in registers. Every other symbol takes the general step.
// Two instantiations, picked by the batch: up to 660 chunks (5 an SM),
// 1-warp blocks with a 32 KB window (all but the farthest 258 distances);
// above, 4-warp blocks with a 1 KB window and a 512-byte ring, 6.5 KB a
// warp, so 4096 chunks run in one wave.
//
// What bounds it on this card: each symbol's lookup depends on the bit
// position the one before left, so one chunk is a serial chain; a literal
// now costs one shared-memory read, a refill every few literals, a couple
// of dozen dependent instructions and no device-memory trip. A one-wave
// batch takes as long as its longest chain; at 32 warps an SM the
// instructions they issue bound it. Issuing the next literal's lookup
// before the store of this one measured slower. Left for later: several
// literals a step (a lookup at each of 32 bit offsets and a
// pointer-doubling walk by shuffles).

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxOut = 65536;
constexpr int kRootBits = 9;
constexpr int kRootSize = 1 << kRootBits;
constexpr int kSlot = 1280;      // table entries a warp keeps in shared memory
constexpr int kMaxPiece = 258;   // output bytes a copy step adds
constexpr int kSmallBatchChunks = 660;  // 5 chunks an SM on 132 SMs
constexpr int OP_LIT = 1, OP_LEN = 2, OP_DIST = 3, OP_EOB = 4, OP_SUB = 5;

template <bool B>
struct Flag {
  static constexpr bool value = B;
};

// A table entry as a lookup may use it: 0 for op 0, no bits or more than 15.
__device__ __forceinline__ int32_t valid_entry(int32_t e) {
  const int nbits = (e >> 22) & 63;
  return (e >> 28) == 0 || nbits == 0 || nbits > 15 ? 0 : e;
}

// Shared-memory accesses at a 32-bit address held in a register: the hot
// loop keeps its bases there instead of rebuilding them each symbol.
__device__ __forceinline__ unsigned opaque_smem_addr(const void* p) {
  unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("" : "+r"(a));
  return a;
}

__device__ __forceinline__ int32_t lds32(unsigned a) {
  int32_t v;
  asm volatile("ld.shared.b32 %0, [%1];" : "=r"(v) : "r"(a));
  return v;
}

__device__ __forceinline__ void sts8(unsigned a, int32_t v) {
  asm volatile("st.shared.u8 [%0], %1;" ::"r"(a), "r"(v) : "memory");
}

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

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <int kWindow, int kRing, int kWarps, int kMinBlocks>
__global__ void __launch_bounds__(kWarps * 32, kMinBlocks)
deflate_decode_kernel(const uint8_t* __restrict__ comp,
                      const int32_t* __restrict__ comp_lens, int batch, int cap,
                      const int32_t* __restrict__ desc,
                      const int32_t* __restrict__ tabs,
                      const int32_t* __restrict__ index, uint8_t* out,
                      int32_t* __restrict__ out_lens, uint8_t* __restrict__ ok,
                      int out_cap, int32_t* __restrict__ steps) {
  constexpr int kQuarter = kRing / 4;
  constexpr int kReach = kWindow - kMaxPiece;  // farthest dist read from the window
  constexpr int kFlush = kWindow >= 4096 ? kWindow / 2 : kWindow / 4;
  static_assert(kFlush + kMaxPiece <= kWindow && kFlush <= kWindow - 2 * kMaxPiece + 2,
                "window rules");
  static_assert(kQuarter % 16 == 0 && kQuarter / 16 <= 32, "a quarter is one unit a lane");
  // Indexed as arrays, not through pointers, so that every access is a
  // plain shared-memory load or store at a fixed base.
  __shared__ int32_t slots[kWarps][kSlot];
  __shared__ __align__(16) uint8_t rings[kWarps][kRing];
  __shared__ __align__(16) uint8_t wins[kWarps][kWindow];

  const int warp = kWarps == 1 ? 0 : static_cast<int>(threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  const int chunk = blockIdx.x * kWarps + warp;
  if (chunk >= batch) return;  // the same for every lane of the warp
  int32_t(&slot)[kSlot] = slots[warp];
  uint8_t(&ring)[kRing] = rings[warp];
  uint8_t(&win)[kWindow] = wins[warp];
  const uint8_t* src = comp + static_cast<size_t>(chunk) * cap;
  uint8_t* dst = out + static_cast<size_t>(chunk) * out_cap;
  const int clen = comp_lens[chunk];
  const int32_t* blocks = desc + static_cast<size_t>(index[4 * chunk]) * 8;
  const int n_blocks = index[4 * chunk + 1];
  const int32_t* tab = tabs + index[4 * chunk + 2];
  const int n_tab = index[4 * chunk + 3];
  const long long end_bit = 8LL * clen;

  // Ring coordinates: P = byte + sr, so P % 16 == 0 is a 16-byte boundary
  // of device memory; window coordinates likewise with so.
  const int sr = static_cast<int>(reinterpret_cast<uintptr_t>(src) & 15);
  const int so = static_cast<int>(reinterpret_cast<uintptr_t>(dst) & 15);
  const uint8_t* src16 = src - sr;
  uint8_t* dst16 = dst - so;
  const int in_end = sr + max(0, min(clen, cap));  // ring coordinate of the input's end
  auto wslot = [&](int pos) -> int { return (pos + so) & (kWindow - 1); };

  // Quarter q of the ring: lane u fills the 16-byte unit u of it, by
  // cp.async where the unit lies inside the input, else by bytes (0 past it).
  int issued = 0, ready = 0;
  auto issue = [&]() {
    if (lane < kQuarter / 16) {
      const int lo = issued * kQuarter + 16 * lane;
      uint8_t* to = &ring[lo & (kRing - 1)];
      if (lo >= sr && lo + 16 <= in_end) {
        cp_async16(to, src16 + lo);
      } else {
        for (int i = 0; i < 16; ++i) {
          const int p = lo + i;
          to[i] = p >= sr && p < in_end ? src16[p] : 0;
        }
      }
    }
    cp_async_commit();  // one group per quarter
    ++issued;
  };
  auto need = [&](int end) {  // ring bytes below coordinate `end` are ready
    while (ready * kQuarter < end) {
      cp_async_wait_all_but_one();
      __syncwarp();
      ++ready;
      issue();
    }
  };
  auto ring64 = [&](int p) -> uint64_t {  // ring bytes p..p+7
    const int a = p & ~7;
    const uint64_t lo = *reinterpret_cast<const uint64_t*>(&ring[a & (kRing - 1)]);
    const uint64_t hi = *reinterpret_cast<const uint64_t*>(&ring[(a + 8) & (kRing - 1)]);
    const int sh = 8 * (p & 7);
    return sh ? (lo >> sh) | (hi << (64 - sh)) : lo;
  };

  // Device-memory stores of window bytes [a, b) (b <= out_cap), or zeros.
  auto store = [&](int a, int b, bool zeros) {
    const int ap = a + so, bp = b + so;
    for (int u = (ap >> 4) + lane; u < ((bp + 15) >> 4); u += 32) {
      const int lo = max(u << 4, ap), hi = min((u << 4) + 16, bp);
      if (hi - lo == 16) {
        reinterpret_cast<uint4*>(dst16)[u] =
            zeros ? make_uint4(0, 0, 0, 0)
                  : *reinterpret_cast<const uint4*>(&win[(u << 4) & (kWindow - 1)]);
      } else {
        for (int p = lo; p < hi; ++p) dst16[p] = zeros ? 0 : win[p & (kWindow - 1)];
      }
    }
  };
  int op = 0;
  int flushed = 0;  // output bytes below this are in device memory (or >= out_cap)
  int drain_at = kFlush;  // op that starts the next drain; none once out_cap is stored
  int fast_end = min(drain_at, out_cap);  // a literal at op + 1 < fast_end needs no check
  auto drain = [&]() {  // after a __syncwarp()
    if (op >= drain_at) {
      const int lim = op >= out_cap ? out_cap : ((op + so) & ~15) - so;
      store(flushed, lim, false);
      flushed = lim;
      drain_at = flushed < out_cap ? flushed + kFlush : INT_MAX;
      fast_end = min(drain_at, out_cap);
      __syncwarp();
    }
  };
  // A copy of len bytes from dist back, in pieces of at most kMaxPiece.
  auto copy = [&](int len, int dist) {
    __syncwarp();  // the literals stored before are visible to every lane
    const int r0 = dist < kMaxPiece ? lane % dist : lane;
    const int step = dist < kMaxPiece ? 32 % dist : 32;
    while (len > 0) {
      const int piece = min(len, kMaxPiece);
      if (dist <= kReach) {  // from the window: reads only bytes before op
        int r = r0;
        for (int k = lane; k < piece; k += 32) {
          win[wslot(op + k)] = win[wslot(op - dist + (dist >= piece ? k : r))];
          r += step;
          if (r >= dist) r -= dist;
        }
      } else {  // from device memory: dist > piece, drained bytes
        for (int k = lane; k < piece; k += 32)
          if (op + k < out_cap) win[wslot(op + k)] = dst[op - dist + k];
      }
      op += piece;
      len -= piece;
      __syncwarp();
      drain();
    }
  };

  long long slot_lo = LLONG_MIN;  // the table index slot[0] holds; none yet
  bool err = clen <= 0 || clen > cap;
  bool done = false;
  int count = 0;

  // One Huffman block from bit d1 (0 <= d1 < end_bit), roots read from the
  // slot (kInSlot) or from device memory.
  auto huffman = [&](auto in_slot, int d1, int ll_root, int d_root, bool last) {
    constexpr bool kInSlot = decltype(in_slot)::value;
    auto entry = [&](unsigned i) -> int32_t {  // device memory, bounds checked
      return i < static_cast<unsigned>(n_tab) ? __ldg(tab + i) : 0;
    };
    // A root's entries: slot offsets, or table indices (root + bits as the
    // plan's int64 sum: negative or past n_tab reads 0).
    const int ll_base = kInSlot ? static_cast<int>(ll_root - slot_lo) : ll_root;
    const int d_base = kInSlot ? static_cast<int>(d_root - slot_lo) : d_root;
    auto root_entry = [&](int base, int bits) -> int32_t {
      if constexpr (kInSlot) {
        return slot[base + bits];  // the slot's entries are valid_entry()'s already
      } else {
        return valid_entry(entry(static_cast<unsigned>(base) + static_cast<unsigned>(bits)));
      }
    };
    // The entry of the symbol at the buffer's low 15 bits, through its
    // subtable where the root sends it there. Consumes nothing.
    auto resolve = [&](int32_t e, uint64_t bits) -> int32_t {
      if ((e >> 28) == OP_SUB) {
        const int sbits = min((e >> 22) & 63, 15 - kRootBits);
        const int i = (e & 0x3FFFFF) + static_cast<int>((bits >> kRootBits) & ((1u << sbits) - 1));
        if constexpr (kInSlot) {
          const long long off = i - slot_lo;
          e = off >= 0 && off < kSlot ? slot[off] : entry(i);
        } else {
          e = entry(i);
        }
        e = valid_entry(e);
      }
      return e;
    };

    // The bit buffer: nbuf valid bits of buf, then the ring from bytepos.
    cp_async_wait_all();
    __syncwarp();
    int bytepos = (d1 >> 3) + sr;
    issued = ready = bytepos / kQuarter;
    issue();
    issue();
    uint64_t buf = 0;
    int nbuf = 0;
    auto refill = [&]() {  // at least 56 valid bits after it
      need(bytepos + 8);
      buf |= ring64(bytepos) << nbuf;
      bytepos += (63 - nbuf) >> 3;
      nbuf |= 56;
    };
    auto consume = [&](int k) {
      buf >>= k;
      nbuf -= k;
    };
    refill();
    consume(d1 & 7);
    // Bits left before the chunk's end; a symbol that takes it below 0 ends past it.
    int avail = static_cast<int>(min(end_bit - d1, static_cast<long long>(INT_MAX)));
    const unsigned ll_at = kInSlot ? opaque_smem_addr(&slot[ll_base]) : 0;
    const unsigned win_at = opaque_smem_addr(&win[0]);
    // At the loop's top at least 15 bits are in the buffer: the lookup's.
    while (true) {
      // Literals whose bits stay inside the chunk and whose byte needs no
      // check (below out_cap and 64 KB, no drain due) go around this loop;
      // every lane stores the same byte, so no lane branches off.
      int32_t e0;
      while (true) {
        const int bits = static_cast<int>(buf) & (kRootSize - 1);
        e0 = kInSlot ? lds32(ll_at + 4 * bits) : root_entry(ll_base, bits);
        if (nbuf < 32) refill();  // beside the lookup; >= 17 bits are left after a literal
        const int nb = (e0 >> 22) & 63;
        if ((e0 >> 28) != OP_LIT || avail < nb || op + 1 >= fast_end) break;
        ++count;
        consume(nb);
        avail -= nb;
        sts8(win_at + wslot(op), e0);
        ++op;
      }
      ++count;
      const int32_t e = resolve(e0, buf);
      const int sym_op = e >> 28;
      const int val = e & 0x3FFFFF;
      const int nb = (e >> 22) & 63;
      consume(nb);
      avail -= nb;
      if (sym_op == OP_LIT) {
        err = avail < 0 || op + 1 > kMaxOut;
        if (err) break;
        if (op < out_cap) win[wslot(op)] = static_cast<uint8_t>(val);
        ++op;
        if (op >= drain_at) {
          __syncwarp();
          drain();
        }
        continue;
      }
      if (sym_op == OP_EOB) {
        err = avail < 0;
        done = last;
        break;
      }
      err = sym_op != OP_LEN;  // op 0, a distance or a subtable
      if (err) break;
      const int lx = (val >> 9) & 15;
      const int len = (val & 511) + static_cast<int>(buf & ((1u << lx) - 1));
      consume(lx);
      avail -= lx;
      err = avail < 0;
      if (err) break;
      refill();
      const int32_t de = resolve(root_entry(d_base, static_cast<int>(buf) & (kRootSize - 1)), buf);
      err = (de >> 28) != OP_DIST;
      if (err) break;
      const int dval = de & 0x3FFFFF;
      const int dnb = (de >> 22) & 63;
      const int dx = (dval >> 16) & 15;
      consume(dnb);
      const int dist = (dval & 0xFFFF) + static_cast<int>(buf & ((1u << dx) - 1));
      consume(dx);
      avail -= dnb + dx;
      err = avail < 0 || dist <= 0 || dist > op || op + len > kMaxOut;
      if (err) break;
      refill();
      copy(len, dist);
    }
    __syncwarp();
  };

  for (int blk = 0; !err && !done; ++blk) {
    if (blk >= n_blocks) {
      err = true;
      break;
    }
    const int32_t* d = blocks + 8 * blk;
    const bool last = d[6] != 0;
    if (d[0] == 0) {  // stored: in pieces, through the window
      const int from = d[4], n = d[5];
      err = from < 0 || n < 0 || from > clen - n || op + n > kMaxOut;
      if (err) break;
      __syncwarp();
      for (int at = 0; at < n; at += kWindow - kFlush) {
        const int piece = min(n - at, kWindow - kFlush);
        for (int k = lane; k < piece; k += 32)
          if (op + k < out_cap) win[wslot(op + k)] = src[from + at + k];
        op += piece;
        __syncwarp();
        drain();
      }
      done = last;
      continue;
    }
    const int d1 = d[1];
    err = d1 < 0;
    if (err) break;
    if (d1 >= end_bit) {  // its first symbol ends past the chunk
      ++count;
      err = true;
      break;
    }
    const long long r1 = d[2], r2 = d[3];
    const long long lo = min(r1, r2);
    if (max(r1, r2) + kRootSize <= lo + kSlot) {
      if (lo != slot_lo) {  // fill the slot: entries outside the chunk's read as 0
        __syncwarp();
#pragma unroll 8
        for (int i = lane; i < kSlot; i += 32) {
          const long long t = lo + i;
          const int32_t e = t >= 0 && t < n_tab ? __ldg(tab + t) : 0;
          slot[i] = (e >> 28) == OP_SUB ? e : valid_entry(e);
        }
        slot_lo = lo;
        __syncwarp();
      }
      huffman(Flag<true>{}, d1, d[2], d[3], last);
    } else {
      huffman(Flag<false>{}, d1, d[2], d[3], last);
    }
  }

  // The rest of the row: what the window still holds, then the zero tail.
  __syncwarp();
  if (op < out_cap) {
    const int unit_end = min(((op + so + 15) & ~15) - so, out_cap);
    for (int p = op + lane; p < unit_end; p += 32) win[wslot(p)] = 0;
    __syncwarp();
    store(flushed, unit_end, false);
    store(unit_end, out_cap, true);
  } else if (flushed < out_cap) {
    store(flushed, out_cap, false);
  }
  cp_async_wait_all();
  if (lane == 0) {
    out_lens[chunk] = op;
    ok[chunk] = !err && done;
    if (steps != nullptr) steps[chunk] = count;
  }
}

template <int kWindow, int kRing, int kWarps, int kMinBlocks>
cudaError_t launch(const uint8_t* comp, const int32_t* comp_lens, int batch, int cap,
                   const int32_t* desc, const int32_t* tabs, const int32_t* index,
                   uint8_t* out, int32_t* out_lens, uint8_t* ok, int out_cap,
                   int32_t* steps, cudaStream_t stream) {
  auto kernel = deflate_decode_kernel<kWindow, kRing, kWarps, kMinBlocks>;
  static const cudaError_t carveout = cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      static_cast<int>(cudaSharedmemCarveoutMaxShared));
  if (carveout != cudaSuccess) return carveout;
  kernel<<<(batch + kWarps - 1) / kWarps, kWarps * 32, 0, stream>>>(
      comp, comp_lens, batch, cap, desc, tabs, index, out, out_lens, ok, out_cap, steps);
  return cudaGetLastError();
}

}  // namespace

// Launches the decode on `stream` and returns cudaGetLastError(). The caller
// allocates every buffer: out (batch, out_cap) uint8, out_lens (batch,)
// int32, ok (batch,) bool, steps (batch,) int32 or null; desc holds 8 int32
// fields a block and index 4 int32 a chunk: first block, blocks, first table
// entry, entries.
extern "C" int acx_deflate_decode(const void* comp, const void* comp_lens,
                                  int batch, int cap, const void* desc,
                                  const void* tabs, const void* index,
                                  void* out, void* out_lens, void* ok,
                                  int out_cap, void* steps, void* stream) {
  if (batch <= 0) return static_cast<int>(cudaGetLastError());
  const auto* c = static_cast<const uint8_t*>(comp);
  const auto* cl = static_cast<const int32_t*>(comp_lens);
  const auto* de = static_cast<const int32_t*>(desc);
  const auto* t = static_cast<const int32_t*>(tabs);
  const auto* ix = static_cast<const int32_t*>(index);
  auto* o = static_cast<uint8_t*>(out);
  auto* ol = static_cast<int32_t*>(out_lens);
  auto* k = static_cast<uint8_t*>(ok);
  auto* st = static_cast<int32_t*>(steps);
  auto* s = static_cast<cudaStream_t>(stream);
  if (batch <= kSmallBatchChunks)
    return static_cast<int>(
        launch<32768, 2048, 1, 5>(c, cl, batch, cap, de, t, ix, o, ol, k, out_cap, st, s));
  return static_cast<int>(
      launch<1024, 512, 4, 8>(c, cl, batch, cap, de, t, ix, o, ol, k, out_cap, st, s));
}
