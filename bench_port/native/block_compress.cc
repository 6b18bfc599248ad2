// The benchmark's own input compressors: Snappy and LZ4 block compress, one
// call for a batch of equal chunks. A frozen copy of the greedy hash-table
// matchers of the port's host tier (aircompressor_tpu_torch/host/native/
// snappy.cc and lz4.cc, themselves copies of aircompressor's
// SnappyRawCompressor and Lz4RawCompressor algorithms), kept here so that a
// change to the program moves neither the benchmark's inputs nor the bytes
// its rooflines count. Chunks are at most 64 KB, so Snappy's one block.
#include <cstddef>
#include <cstdint>
#include <cstring>

namespace {
inline uint16_t load16(const uint8_t* p) { uint16_t v; std::memcpy(&v, p, 2); return v; }
inline uint32_t load32(const uint8_t* p) { uint32_t v; std::memcpy(&v, p, 4); return v; }
inline uint64_t load64(const uint8_t* p) { uint64_t v; std::memcpy(&v, p, 8); return v; }
inline void store16(uint8_t* p, uint16_t v) { std::memcpy(p, &v, 2); }

inline size_t count_match(const uint8_t* a, const uint8_t* b, const uint8_t* limit) {
  const uint8_t* start = b;
  while (b + 8 <= limit) {
    uint64_t diff = load64(a) ^ load64(b);
    if (diff) return (b - start) + (__builtin_ctzll(diff) >> 3);
    a += 8; b += 8;
  }
  while (b < limit && *a == *b) { a++; b++; }
  return b - start;
}

// ------------------------------------------------------------------ Snappy
constexpr int kSnappyInputMargin = 15;
constexpr int kSnappyMaxTableBits = 14;

inline uint32_t snappy_hash(uint32_t v, int shift) { return (v * 0x1E35A7BDu) >> shift; }

inline uint8_t* snappy_literal(uint8_t* op, const uint8_t* s, size_t n) {
  if (n == 0) return op;
  size_t m = n - 1;
  if (m < 60) {
    *op++ = static_cast<uint8_t>(m << 2);
  } else {
    int extra = m < (1u << 8) ? 1 : m < (1u << 16) ? 2 : m < (1u << 24) ? 3 : 4;
    *op++ = static_cast<uint8_t>((59 + extra) << 2);
    for (int k = 0; k < extra; k++) *op++ = (m >> (8 * k)) & 0xFF;
  }
  std::memcpy(op, s, n);
  return op + n;
}

inline uint8_t* snappy_copy(uint8_t* op, size_t offset, size_t len) {
  while (len >= 68) {
    *op++ = 0b10 | (63 << 2); store16(op, static_cast<uint16_t>(offset)); op += 2;
    len -= 64;
  }
  if (len > 64) {
    *op++ = 0b10 | (59 << 2); store16(op, static_cast<uint16_t>(offset)); op += 2;
    len -= 60;
  }
  if (len >= 4 && len <= 11 && offset < 2048) {
    *op++ = static_cast<uint8_t>(0b01 | ((len - 4) << 2) | ((offset >> 8) << 5));
    *op++ = offset & 0xFF;
  } else {
    *op++ = static_cast<uint8_t>(0b10 | ((len - 1) << 2));
    store16(op, static_cast<uint16_t>(offset)); op += 2;
  }
  return op;
}

size_t snappy_compress(const uint8_t* base, size_t n, uint8_t* dst, bool unchecked) {
  uint8_t* op = dst;
  for (size_t v = n; ; v >>= 7) {
    if (v < 0x80) { *op++ = static_cast<uint8_t>(v); break; }
    *op++ = (v & 0x7F) | 0x80;
  }
  if (n < kSnappyInputMargin + 1) return snappy_literal(op, base, n) - dst;
  static thread_local int32_t table[1 << kSnappyMaxTableBits];
  int bits = 8;
  while ((1u << bits) < n && bits < kSnappyMaxTableBits) bits++;
  int shift = 32 - bits;
  for (int i = 0; i < (1 << bits); i++) table[i] = -1;
  const uint8_t* end = base + n;
  const uint8_t* limit = end - kSnappyInputMargin;
  const uint8_t* anchor = base;
  const uint8_t* ip = base;
  for (;;) {
    const uint8_t* p = ip;
    uint32_t skip = 32;
    const uint8_t* match = nullptr;
    for (;;) {
      if (p >= limit) return snappy_literal(op, anchor, end - anchor) - dst;
      uint32_t h = snappy_hash(load32(p), shift);
      int32_t cand = table[h];
      table[h] = static_cast<int32_t>(p - base);
      if (cand >= 0 && (unchecked || load32(base + cand) == load32(p))) {
        match = base + cand;
        break;
      }
      p += (skip++ >> 5);
    }
    ip = p;
    op = snappy_literal(op, anchor, ip - anchor);
    size_t mlen = 4 + count_match(match + 4, ip + 4, end);
    op = snappy_copy(op, ip - match, mlen);
    ip += mlen;
    anchor = ip;
    if (ip >= limit) return snappy_literal(op, anchor, end - anchor) - dst;
    table[snappy_hash(load32(ip - 1), shift)] = static_cast<int32_t>(ip - 1 - base);
  }
}

// --------------------------------------------------------------------- LZ4
constexpr int kLz4LastLiterals = 5;
constexpr int kLz4MfLimit = 12;
constexpr int kLz4MaxDistance = 65535;
constexpr int kLz4HashLog = 15;
constexpr int kLz4SkipTrigger = 6;

inline uint32_t lz4_hash(uint64_t v) {
  return static_cast<uint32_t>(((v << 24) * 0x9E3779B185EBCA87ull) >> (64 - kLz4HashLog));
}

inline uint8_t* lz4_length(uint8_t* op, size_t len) {
  while (len >= 255) { *op++ = 255; len -= 255; }
  *op++ = static_cast<uint8_t>(len);
  return op;
}

size_t lz4_compress(const uint8_t* src, size_t n, uint8_t* dst, bool unchecked) {
  uint8_t* op = dst;
  const uint8_t* end = src + n;
  const uint8_t* anchor = src;
  auto emit_last = [&]() {
    size_t lit = end - anchor;
    if (lit >= 15) { *op++ = 0xF0; op = lz4_length(op, lit - 15); }
    else { *op++ = static_cast<uint8_t>(lit << 4); }
    std::memcpy(op, anchor, lit);
    op += lit;
    return static_cast<size_t>(op - dst);
  };
  if (n < kLz4MfLimit + 1) return emit_last();
  static thread_local int32_t table[1 << kLz4HashLog];
  for (int i = 0; i < (1 << kLz4HashLog); i++) table[i] = -1;
  const uint8_t* mf_limit = end - kLz4MfLimit;
  const uint8_t* match_limit = end - kLz4LastLiterals;
  const uint8_t* ip = src;
  for (;;) {
    const uint8_t* p = ip;
    uint32_t step_counter = 1u << kLz4SkipTrigger;
    const uint8_t* match = nullptr;
    for (;;) {
      if (p > mf_limit) return emit_last();
      uint32_t h = lz4_hash(load64(p));
      int32_t cand = table[h];
      table[h] = static_cast<int32_t>(p - src);
      if (cand >= 0 && (p - src) - cand <= kLz4MaxDistance &&
          (unchecked || load32(src + cand) == load32(p))) {
        match = src + cand;
        break;
      }
      p += step_counter++ >> kLz4SkipTrigger;
    }
    ip = p;
    while (ip > anchor && match > src && ip[-1] == match[-1]) { ip--; match--; }
    size_t mlen = 4 + count_match(match + 4, ip + 4, match_limit);
    size_t lit = ip - anchor;
    uint8_t* token = op++;
    if (lit >= 15) { *token = 0xF0; op = lz4_length(op, lit - 15); }
    else { *token = static_cast<uint8_t>(lit << 4); }
    std::memcpy(op, anchor, lit);
    op += lit;
    store16(op, static_cast<uint16_t>(ip - match));
    op += 2;
    size_t ml4 = mlen - 4;
    if (ml4 >= 15) { *token |= 0x0F; op = lz4_length(op, ml4 - 15); }
    else { *token |= static_cast<uint8_t>(ml4); }
    ip += mlen;
    anchor = ip;
    if (ip > mf_limit) return emit_last();
    const uint8_t* lo = ip - mlen + 1;
    size_t stride = mlen > 64 ? 4 : 1;
    for (const uint8_t* q = lo; q + 8 <= end && q < ip; q += stride)
      table[lz4_hash(load64(q))] = static_cast<int32_t>(q - src);
  }
}
}  // namespace

// Compress `count` chunks of `chunk` bytes each, row i of `src`, into row i
// of `dst` (`stride` bytes a row, at least chunk + chunk / 6 + 32); writes
// each block's length to `lens`. codec 0 is Snappy, 1 is LZ4. `unchecked`
// makes the control: a hash-table hit is taken as a match without comparing
// its first four bytes, so the blocks no longer decode to their chunks.
// Returns 0, or -1 where the stride is too small or the codec unknown.
extern "C" int bench_compress_batch(int codec, const uint8_t* src, int64_t count,
                                    int64_t chunk, uint8_t* dst, int64_t stride,
                                    int64_t* lens, int unchecked) {
  if (stride < chunk + chunk / 6 + 32 || (codec != 0 && codec != 1)) return -1;
  for (int64_t i = 0; i < count; i++) {
    const uint8_t* s = src + i * chunk;
    uint8_t* d = dst + i * stride;
    lens[i] = static_cast<int64_t>(codec == 0 ? snappy_compress(s, chunk, d, unchecked)
                                              : lz4_compress(s, chunk, d, unchecked));
  }
  return 0;
}
