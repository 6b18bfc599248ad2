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
// Design: the lanes of a warp walk the symbol chain together, each keeping
// the same 64-bit bit buffer (every lane loads the same byte or entry, one
// transaction), so control flow never diverges. Lane 0 writes a literal at
// once. A copy is shared by the 32 lanes as out[op+k] = out[op-dist + k %
// dist], exact for overlapping copies and reading only bytes before op; a
// stored block is copied by the 32 lanes. __syncwarp() before and after a
// copy makes the bytes written before it visible. Stores at or past out_cap
// are dropped; every byte below out_cap is still exact.
//
// What bounds it on this card: each symbol's lookup depends on the bit
// position the one before left, so one chunk is a serial chain of dependent
// table loads (L1-resident: a block's root tables are 4 KB); the card is
// filled only by the chunks in flight (one warp each). Left for later:
// staging the tables and the output in shared memory, and decoding several
// literals a step.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kMaxOut = 65536;
constexpr int kRootBits = 9;
constexpr int OP_LIT = 1, OP_LEN = 2, OP_DIST = 3, OP_EOB = 4, OP_SUB = 5;

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
deflate_decode_kernel(const uint8_t* __restrict__ comp,
                      const int32_t* __restrict__ comp_lens, int batch, int cap,
                      const int32_t* __restrict__ desc,
                      const int32_t* __restrict__ tabs,
                      const int32_t* __restrict__ index, uint8_t* out,
                      int32_t* __restrict__ out_lens, uint8_t* __restrict__ ok,
                      int out_cap, int32_t* __restrict__ steps) {
  const int lane = threadIdx.x & 31;
  const int chunk = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (chunk >= batch) return;  // the same for every lane of the warp
  const uint8_t* src = comp + static_cast<size_t>(chunk) * cap;
  uint8_t* dst = out + static_cast<size_t>(chunk) * out_cap;
  const int clen = comp_lens[chunk];
  const int32_t* blocks = desc + static_cast<size_t>(index[4 * chunk]) * 8;
  const int n_blocks = index[4 * chunk + 1];
  const int32_t* tab = tabs + index[4 * chunk + 2];
  const int n_tab = index[4 * chunk + 3];
  const long long end_bit = 8LL * clen;

  // The bit buffer: bits at or past byte clen read as 0.
  unsigned long long buf = 0;
  int nbuf = 0;
  long long next_byte = 0;
  auto refill = [&]() {
    while (nbuf <= 56) {
      const int b = next_byte < clen ? src[next_byte] : 0;
      buf |= static_cast<unsigned long long>(b) << nbuf;
      ++next_byte;
      nbuf += 8;
    }
  };
  auto take = [&](int k) -> int {
    const int v = static_cast<int>(buf & ((1ull << k) - 1));
    buf >>= k;
    nbuf -= k;
    return v;
  };
  auto bit_pos = [&]() -> long long { return 8 * next_byte - nbuf; };
  auto entry = [&](int i) -> int32_t { return i >= 0 && i < n_tab ? tab[i] : 0; };
  // One symbol's entry at the bit position, and its code consumed; 0 for
  // an entry of op 0, with no bits or with more than 15 (no code is longer).
  auto lookup = [&](int root) -> int32_t {
    refill();
    const int peek = static_cast<int>(buf & 0x7FFF);
    int32_t e = entry(root + (peek & ((1 << kRootBits) - 1)));
    if ((e >> 28) == OP_SUB) {
      const int sbits = min((e >> 22) & 63, 15 - kRootBits);
      e = entry((e & 0x3FFFFF) + ((peek >> kRootBits) & ((1 << sbits) - 1)));
    }
    const int nbits = (e >> 22) & 63;
    if ((e >> 28) == 0 || nbits == 0 || nbits > 15) return 0;
    take(nbits);
    return e;
  };

  bool err = clen <= 0 || clen > cap;
  bool done = false;
  int op = 0;
  int count = 0;
  for (int blk = 0; !err && !done; ++blk) {
    if (blk >= n_blocks) {
      err = true;
      break;
    }
    const int32_t* d = blocks + 8 * blk;
    const bool last = d[6] != 0;
    if (d[0] == 0) {  // stored
      const int from = d[4], n = d[5];
      err = from < 0 || n < 0 || from > clen - n || op + n > kMaxOut;
      if (err) break;
      const int n_store = min(n, out_cap - op);
      for (int k = lane; k < n_store; k += 32) dst[op + k] = src[from + k];
      op += n;
      __syncwarp();
      done = last;
      continue;
    }
    const int ll_root = d[2], d_root = d[3];
    err = d[1] < 0;
    if (err) break;
    next_byte = d[1] >> 3;
    buf = 0;
    nbuf = 0;
    refill();
    take(d[1] & 7);
    while (true) {
      ++count;
      const int32_t e = lookup(ll_root);
      const int sym_op = e >> 28;
      const int val = e & 0x3FFFFF;
      if (sym_op == OP_LIT) {
        err = bit_pos() > end_bit || op + 1 > kMaxOut;
        if (err) break;
        if (lane == 0 && op < out_cap) dst[op] = static_cast<uint8_t>(val);
        ++op;
        continue;
      }
      if (sym_op == OP_EOB) {
        err = bit_pos() > end_bit;
        done = last;
        break;
      }
      err = sym_op != OP_LEN;  // op 0, a distance or a subtable
      if (err) break;
      refill();
      const int len = (val & 511) + take((val >> 9) & 15);
      err = bit_pos() > end_bit;
      if (err) break;
      const int32_t de = lookup(d_root);
      err = (de >> 28) != OP_DIST;
      if (err) break;
      const int dval = de & 0x3FFFFF;
      refill();
      const int dist = (dval & 0xFFFF) + take((dval >> 16) & 15);
      err = bit_pos() > end_bit || dist <= 0 || dist > op || op + len > kMaxOut;
      if (err) break;
      __syncwarp();  // lane 0's literals are visible to the copy
      const int n_store = min(len, out_cap - op);
      const uint8_t* from = dst + (op - dist);
      for (int k = lane; k < n_store; k += 32)
        dst[op + k] = from[dist >= n_store ? k : k % dist];
      op += len;
      __syncwarp();
    }
    __syncwarp();
  }

  for (int j = max(0, min(op, out_cap)) + lane; j < out_cap; j += 32) dst[j] = 0;
  if (lane == 0) {
    out_lens[chunk] = op;
    ok[chunk] = !err && done;
    if (steps != nullptr) steps[chunk] = count;
  }
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
  if (batch > 0) {
    const int blocks = (batch + kWarpsPerBlock - 1) / kWarpsPerBlock;
    deflate_decode_kernel<<<blocks, kWarpsPerBlock * 32, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(comp),
        static_cast<const int32_t*>(comp_lens), batch, cap,
        static_cast<const int32_t*>(desc), static_cast<const int32_t*>(tabs),
        static_cast<const int32_t*>(index), static_cast<uint8_t*>(out),
        static_cast<int32_t*>(out_lens), static_cast<uint8_t*>(ok), out_cap,
        static_cast<int32_t*>(steps));
  }
  return static_cast<int>(cudaGetLastError());
}
