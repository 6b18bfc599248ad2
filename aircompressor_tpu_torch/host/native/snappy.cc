// Snappy block codec — native tier. Own design from the public format
// description (64KB restart blocks, per-block hash table, skip heuristic).
// A copy of aircompressor_tpu/native/src/snappy.cc. Parity targets:
// host/snappy.py and the reference's
// snappy/SnappyRawCompressor.java / SnappyRawDecompressor.java behavior.
#include "common.h"

namespace {
constexpr int BLOCK_LOG = 16;
constexpr size_t BLOCK_SIZE = 1u << BLOCK_LOG;
constexpr int MIN_MATCH = 4;
constexpr int INPUT_MARGIN = 15;
constexpr int MAX_TABLE_BITS = 14;

inline uint32_t hash4(uint32_t v, int shift) { return (v * 0x1E35A7BDu) >> shift; }

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

inline uint8_t* emit_literal(uint8_t* op, const uint8_t* s, size_t n) {
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

inline uint8_t* emit_copy(uint8_t* op, size_t offset, size_t len) {
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
}  // namespace

extern "C" int64_t actpu_snappy_compress(const uint8_t* src, size_t n, uint8_t* dst,
                                         size_t dst_cap, int /*unused*/) {
  if (dst_cap < 32 + n + n / 6) return -1;
  uint8_t* op = dst;
  // varint uncompressed length
  {
    size_t v = n;
    while (v >= 0x80) { *op++ = (v & 0x7F) | 0x80; v >>= 7; }
    *op++ = static_cast<uint8_t>(v);
  }
  static thread_local int32_t table[1 << MAX_TABLE_BITS];
  for (size_t block_lo = 0; block_lo < n || block_lo == 0; block_lo += BLOCK_SIZE) {
    size_t block_n = n - block_lo < BLOCK_SIZE ? n - block_lo : BLOCK_SIZE;
    const uint8_t* base = src + block_lo;
    if (block_n < INPUT_MARGIN + 1) {
      op = emit_literal(op, base, block_n);
      if (block_lo + BLOCK_SIZE >= n) break;
      continue;
    }
    int bits = 8;
    while ((1u << bits) < block_n && bits < MAX_TABLE_BITS) bits++;
    int shift = 32 - bits;
    for (int i = 0; i < (1 << bits); i++) table[i] = -1;
    const uint8_t* end = base + block_n;
    const uint8_t* limit = end - INPUT_MARGIN;
    const uint8_t* anchor = base;
    const uint8_t* ip = base;
    for (;;) {
      const uint8_t* p = ip;
      uint32_t skip = 32;
      const uint8_t* match = nullptr;
      for (;;) {
        if (p >= limit) { op = emit_literal(op, anchor, end - anchor); goto next_block; }
        uint32_t h = hash4(load32(p), shift);
        int32_t cand = table[h];
        table[h] = static_cast<int32_t>(p - base);
        if (cand >= 0 && load32(base + cand) == load32(p)) { match = base + cand; break; }
        p += (skip++ >> 5);
      }
      ip = p;
      op = emit_literal(op, anchor, ip - anchor);
      size_t mlen = MIN_MATCH + count_match(match + MIN_MATCH, ip + MIN_MATCH, end);
      op = emit_copy(op, ip - match, mlen);
      ip += mlen;
      anchor = ip;
      if (ip >= limit) { op = emit_literal(op, anchor, end - anchor); goto next_block; }
      table[hash4(load32(ip - 1), shift)] = static_cast<int32_t>(ip - 1 - base);
    }
  next_block:
    if (block_lo + BLOCK_SIZE >= n) break;
  }
  return op - dst;
}

extern "C" int64_t actpu_snappy_decompress(const uint8_t* src, size_t n, uint8_t* dst,
                                           size_t dst_cap) {
  const uint8_t* ip = src;
  const uint8_t* end = src + n;
  // varint
  uint64_t declared = 0;
  int shift = 0;
  for (;;) {
    if (ip >= end || shift > 32) return malformed(ip - src);
    uint8_t b = *ip++;
    declared |= static_cast<uint64_t>(b & 0x7F) << shift;
    if (b < 0x80) break;
    shift += 7;
  }
  if (declared > dst_cap) return malformed(0);
  uint8_t* op = dst;
  uint8_t* oend = dst + dst_cap;
  while (ip < end) {
    uint32_t tag = *ip++;
    uint32_t kind = tag & 0b11;
    if (kind == 0) {  // literal
      size_t len = (tag >> 2) + 1;
      if (len > 60) {
        int extra = static_cast<int>(len - 60);
        if (end - ip < extra) return malformed(ip - src);
        len = 0;
        for (int k = 0; k < extra; k++) len |= static_cast<size_t>(*ip++) << (8 * k);
        len += 1;
      }
      if (static_cast<size_t>(end - ip) < len) return malformed(ip - src);
      if (static_cast<size_t>(oend - op) < len) return malformed(ip - src);
      std::memcpy(op, ip, len);
      ip += len; op += len;
      continue;
    }
    size_t len, offset;
    if (kind == 1) {
      len = 4 + ((tag >> 2) & 0x7);
      if (ip >= end) return malformed(ip - src);
      offset = ((tag >> 5) << 8) | *ip++;
    } else if (kind == 2) {
      len = (tag >> 2) + 1;
      if (end - ip < 2) return malformed(ip - src);
      offset = load16(ip); ip += 2;
    } else {
      len = (tag >> 2) + 1;
      if (end - ip < 4) return malformed(ip - src);
      offset = load32(ip); ip += 4;
    }
    if (offset == 0 || offset > static_cast<size_t>(op - dst)) return malformed(ip - src);
    if (static_cast<size_t>(oend - op) < len) return malformed(ip - src);
    const uint8_t* m = op - offset;
    if (offset >= 16 && oend - op >= static_cast<ptrdiff_t>(len + 16)) {
      for (size_t k = 0; k < len; k += 16) std::memcpy(op + k, m + k, 16);
      op += len;
    } else {
      while (len--) *op++ = *m++;
    }
  }
  if (static_cast<uint64_t>(op - dst) != declared) return malformed(ip - src);
  return op - dst;
}
