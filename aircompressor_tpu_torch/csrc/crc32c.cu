// Batched CRC32-C (Castagnoli), one warp a row.
//
// Replaces aircompressor_tpu/ops/checksum_jax.py::crc32c, which is XLA there,
// not Pallas: in tensor ops every byte's table term is carried through
// log2(L) rounds of gathers, (B, L) int32 values a round. Row i of a (B, L)
// uint8 batch is checksummed over its first lengths[i] bytes, clamped to
// [0, L] so that no read leaves the row: zlib-style initial value and final
// XOR, no Snappy mask. The 32 CRC bits are written to an int64 slot. Any B
// and L are accepted.
//
// Design. The CRC register is linear over GF(2): processing bytes from a
// register c gives M^m(c) XOR raw(bytes), where raw(bytes) is the register
// after those bytes from 0 and M^m advances a register across m zero bytes.
// So a row of n bytes splits into 32 contiguous segments, one a lane, each
// ceil(n / 32) bytes rounded up to 32 (the last lanes may get fewer bytes or
// none). Lane k computes raw_k over its segment from 0, slicing by 8 with the
// 8 x 256 u32 tables in shared memory (built by the block at its start, 8 KB),
// then shifts it across the bytes after its segment:
//
//   crc = ~( M^n(0xFFFFFFFF) XOR  XOR_k M^(n - end_k)(raw_k) )
//
// M^m(c) is the GF(2) product c * x^(8m) mod P; x^(8m) is the product of the
// constants x^(8 * 2^j) mod P (kX8Pow, constant memory, read by all lanes at
// the same j) over the set bits j of m. Lane 0 adds the initial value's term,
// and the 32 terms are XOR-reduced by __shfl_xor_sync. A block holds 4 rows.
//
// Aligned variant (data 16-byte aligned and L % 16 == 0, so every row and
// every segment starts 16-byte aligned): a lane reads its segment 32 bytes
// an iteration as two 16-byte loads, a whole 32-byte sector, four
// slicing-by-8 steps. Other rows read the same bytes one at a time; it is
// exact, only slower. Each lane ends its segment byte by byte where fewer
// than 32 bytes are left.
//
// What bounds it on this card: the bytes read, 16.7 MB at 256 rows of 64 KB
// (0.0050 ms at 3.35 TB/s) and 268 MB at 4096 (0.080 ms). A lane's chain is
// 64 dependent steps of 32 bytes at 64 KB, each four rounds of eight
// shared-memory lookups; the combine is up to 17 products of 32 shift-and-XOR
// steps a lane. Left for later: a cheaper combine (a shared shift constant
// for equal segments), and fusing the CRC into the decode that wrote the rows.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kPoly = 0x82F63B78u;  // reflected CRC32-C polynomial
constexpr unsigned kAllLanes = 0xffffffffu;
constexpr int kRowsPerBlock = 4;  // one warp a row
constexpr int kSegAlign = 32;     // a lane's segment: a multiple of 32 bytes

// x^(8 * 2^j) mod P in the reflected bit order (bit 31 is x^0): M^(2^j).
__constant__ uint32_t kX8Pow[32] = {
    0x00800000u, 0x00008000u, 0x82F63B78u, 0x6EA2D55Cu,
    0x18B8EA18u, 0x510AC59Au, 0xB82BE955u, 0xB8FDB1E7u,
    0x88E56F72u, 0x74C360A4u, 0xE4172B16u, 0x0D65762Au,
    0x35D73A62u, 0x28461564u, 0xBF455269u, 0xE2EA32DCu,
    0xFE7740E6u, 0xF946610Bu, 0x3C204F8Fu, 0x538586E3u,
    0x59726915u, 0x734D5309u, 0xBC1AC763u, 0x7D0722CCu,
    0xD289CABEu, 0xE94CA9BCu, 0x05B74F3Fu, 0xA51E1F42u,
    0x40000000u, 0x20000000u, 0x08000000u, 0x00800000u,
};

// a * b mod P, reflected: b is multiplied by x once for each bit of a, from
// x^0 (bit 31) down.
__device__ __forceinline__ uint32_t mul_mod_p(uint32_t a, uint32_t b) {
  uint32_t p = 0;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    p ^= b & (0u - (a >> 31));
    a <<= 1;
    b = (b >> 1) ^ (kPoly & (0u - (b & 1u)));
  }
  return p;
}

// M^m(c): the register c advanced across m zero bytes.
__device__ __forceinline__ uint32_t shift_bytes(uint32_t c, uint32_t m) {
  uint32_t x = 0x80000000u;  // x^0
  for (int j = 0; m; ++j, m >>= 1)
    if (m & 1u) x = mul_mod_p(kX8Pow[j], x);
  return mul_mod_p(x, c);
}

// Eight bytes (lo: bytes 0-3, hi: 4-7, little-endian) into the register.
__device__ __forceinline__ uint32_t step8(const uint32_t (*t)[256], uint32_t c,
                                          uint32_t lo, uint32_t hi) {
  lo ^= c;
  return t[7][lo & 0xFF] ^ t[6][(lo >> 8) & 0xFF] ^ t[5][(lo >> 16) & 0xFF] ^
         t[4][lo >> 24] ^ t[3][hi & 0xFF] ^ t[2][(hi >> 8) & 0xFF] ^
         t[1][(hi >> 16) & 0xFF] ^ t[0][hi >> 24];
}

__device__ __forceinline__ uint32_t le32(const uint8_t* p) {
  return p[0] | (p[1] << 8) | (p[2] << 16) | (static_cast<uint32_t>(p[3]) << 24);
}

template <bool kAligned>
__global__ void __launch_bounds__(32 * kRowsPerBlock)
    crc32c_kernel(const uint8_t* __restrict__ data, const int32_t* __restrict__ lengths,
                  int batch, int row_len, int64_t* __restrict__ out) {
  // t[k][b]: the register after byte b and then k zero bytes, from 0.
  __shared__ uint32_t t[8][256];
  for (int i = threadIdx.x; i < 256; i += blockDim.x) {
    uint32_t c = i;
    for (int k = 0; k < 8; ++k) c = (c >> 1) ^ (kPoly & (0u - (c & 1u)));
    t[0][i] = c;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 256; i += blockDim.x) {
    uint32_t c = t[0][i];
    for (int k = 1; k < 8; ++k) {
      c = (c >> 8) ^ t[0][c & 0xFF];
      t[k][i] = c;
    }
  }
  __syncthreads();

  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= batch) return;  // whole warps: the shuffles below see all lanes
  const uint32_t n = static_cast<uint32_t>(min(max(lengths[row], 0), row_len));
  const uint32_t per = n / 32 + (n % 32 != 0);
  const uint32_t seg = (per + kSegAlign - 1) / kSegAlign * kSegAlign;
  // no wrap: lane * seg < n + 1024 and begin + seg < 2^31 + 2^27 for n < 2^31
  const uint32_t begin = min(lane * seg, n);
  const uint32_t end = min(begin + seg, n);
  const uint8_t* p = data + static_cast<size_t>(row) * row_len;

  uint32_t c = 0;
  uint32_t pos = begin;
  for (; end - pos >= 32; pos += 32) {
    if constexpr (kAligned) {
      const uint4 a = __ldg(reinterpret_cast<const uint4*>(p + pos));
      const uint4 b = __ldg(reinterpret_cast<const uint4*>(p + pos + 16));
      c = step8(t, c, a.x, a.y);
      c = step8(t, c, a.z, a.w);
      c = step8(t, c, b.x, b.y);
      c = step8(t, c, b.z, b.w);
    } else {
#pragma unroll
      for (int k = 0; k < 32; k += 8) c = step8(t, c, le32(p + pos + k), le32(p + pos + k + 4));
    }
  }
  for (; pos < end; ++pos) c = t[0][(c ^ p[pos]) & 0xFF] ^ (c >> 8);

  uint32_t v = c ? shift_bytes(c, n - end) : 0u;
  if (lane == 0) v ^= shift_bytes(0xFFFFFFFFu, n);
#pragma unroll
  for (int o = 16; o; o >>= 1) v ^= __shfl_xor_sync(kAllLanes, v, o);
  if (lane == 0) out[row] = static_cast<int64_t>(~v);
}

}  // namespace

extern "C" int acx_crc32c(const void* data, const void* lengths, int batch, int row_len,
                          void* out, void* stream) {
  if (batch > 0) {
    const int blocks = (batch + kRowsPerBlock - 1) / kRowsPerBlock;
    const bool aligned = reinterpret_cast<uintptr_t>(data) % 16 == 0 && row_len % 16 == 0;
    auto* s = static_cast<cudaStream_t>(stream);
    const auto* d = static_cast<const uint8_t*>(data);
    const auto* l = static_cast<const int32_t*>(lengths);
    auto* o = static_cast<int64_t*>(out);
    if (aligned)
      crc32c_kernel<true><<<blocks, 32 * kRowsPerBlock, 0, s>>>(d, l, batch, row_len, o);
    else
      crc32c_kernel<false><<<blocks, 32 * kRowsPerBlock, 0, s>>>(d, l, batch, row_len, o);
  }
  return static_cast<int>(cudaGetLastError());
}
