// LZ4 block codec — native tier. Own design from the public LZ4 block format
// (greedy hash-table matcher, 5-byte hash, skip-trigger acceleration).
// A copy of aircompressor_tpu/native/src/lz4.cc. Parity targets: host/lz4.py
// and the reference's
// lz4/Lz4RawCompressor.java / Lz4RawDecompressor.java behavior.
#include "common.h"

namespace {
constexpr int MIN_MATCH = 4;
constexpr int LAST_LITERALS = 5;
constexpr int MF_LIMIT = 12;
constexpr int MAX_DISTANCE = 65535;
constexpr int HASH_LOG = 15;
constexpr int SKIP_TRIGGER = 6;

inline uint32_t hash5(uint64_t v) {
  return static_cast<uint32_t>(((v << 24) * 0x9E3779B185EBCA87ull) >> (64 - HASH_LOG));
}

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

inline uint8_t* emit_length(uint8_t* op, size_t len) {
  while (len >= 255) { *op++ = 255; len -= 255; }
  *op++ = static_cast<uint8_t>(len);
  return op;
}
}  // namespace

extern "C" int64_t actpu_lz4_compress(const uint8_t* src, size_t n, uint8_t* dst,
                                      size_t dst_cap, int acceleration) {
  if (dst_cap < n + n / 255 + 16) return -1;
  if (acceleration < 1) acceleration = 1;
  uint8_t* op = dst;
  const uint8_t* ip = src;
  const uint8_t* end = src + n;
  const uint8_t* anchor = src;

  auto emit_last = [&]() {
    size_t lit = end - anchor;
    if (lit >= 15) { *op++ = 0xF0; op = emit_length(op, lit - 15); }
    else { *op++ = static_cast<uint8_t>(lit << 4); }
    std::memcpy(op, anchor, lit);
    op += lit;
    return static_cast<int64_t>(op - dst);
  };

  if (n < MF_LIMIT + 1) return emit_last();

  static thread_local int32_t table[1 << HASH_LOG];
  for (int i = 0; i < (1 << HASH_LOG); i++) table[i] = -1;

  const uint8_t* mf_limit = end - MF_LIMIT;
  const uint8_t* match_limit = end - LAST_LITERALS;

  for (;;) {
    // find match with skip acceleration
    const uint8_t* p = ip;
    uint32_t step_counter = static_cast<uint32_t>(acceleration) << SKIP_TRIGGER;
    const uint8_t* match = nullptr;
    for (;;) {
      if (p > mf_limit) return emit_last();
      uint32_t h = hash5(load64(p));
      int32_t cand = table[h];
      table[h] = static_cast<int32_t>(p - src);
      if (cand >= 0 && (p - src) - cand <= MAX_DISTANCE &&
          load32(src + cand) == load32(p)) {
        match = src + cand;
        break;
      }
      size_t step = step_counter++ >> SKIP_TRIGGER;
      p += step;
    }
    ip = p;
    // backward extension
    while (ip > anchor && match > src && ip[-1] == match[-1]) { ip--; match--; }
    size_t mlen = MIN_MATCH + count_match(match + MIN_MATCH, ip + MIN_MATCH, match_limit);
    size_t lit = ip - anchor;
    uint8_t* token = op++;
    if (lit >= 15) { *token = 0xF0; op = emit_length(op, lit - 15); }
    else { *token = static_cast<uint8_t>(lit << 4); }
    std::memcpy(op, anchor, lit);
    op += lit;
    store16(op, static_cast<uint16_t>(ip - match));
    op += 2;
    size_t ml4 = mlen - MIN_MATCH;
    if (ml4 >= 15) { *token |= 0x0F; op = emit_length(op, ml4 - 15); }
    else { *token |= static_cast<uint8_t>(ml4); }
    ip += mlen;
    anchor = ip;
    if (ip > mf_limit) return emit_last();
    // index interior positions of the match (stride for long matches)
    {
      const uint8_t* lo = ip - mlen + 1;
      size_t stride = mlen > 64 ? 4 : 1;
      for (const uint8_t* q = lo; q + 8 <= end && q < ip; q += stride)
        table[hash5(load64(q))] = static_cast<int32_t>(q - src);
    }
  }
}

extern "C" int64_t actpu_lz4_decompress(const uint8_t* src, size_t n, uint8_t* dst,
                                        size_t dst_cap) {
  if (n == 0) return malformed(0);
  const uint8_t* ip = src;
  const uint8_t* end = src + n;
  uint8_t* op = dst;
  uint8_t* oend = dst + dst_cap;

  for (;;) {
    if (ip >= end) return malformed(ip - src);
    uint32_t token = *ip++;
    size_t lit = token >> 4;
    if (lit == 15) {
      uint32_t b;
      do {
        if (ip >= end) return malformed(ip - src);
        b = *ip++;
        lit += b;
      } while (b == 255);
    }
    if (static_cast<size_t>(end - ip) < lit) return malformed(ip - src);
    if (static_cast<size_t>(oend - op) < lit) return malformed(ip - src);
    // literal copy (wild 16B when safe)
    if (lit && end - ip >= static_cast<ptrdiff_t>(lit + 16) &&
        oend - op >= static_cast<ptrdiff_t>(lit + 16)) {
      const uint8_t* s = ip; uint8_t* d = op;
      for (size_t k = 0; k < lit; k += 16) { std::memcpy(d + k, s + k, 16); }
    } else if (lit) {
      std::memcpy(op, ip, lit);
    }
    ip += lit; op += lit;
    if (ip == end) return op - dst;  // final literals-only sequence
    if (end - ip < 2) return malformed(ip - src);
    size_t offset = load16(ip);
    ip += 2;
    if (offset == 0 || offset > static_cast<size_t>(op - dst)) return malformed(ip - src);
    size_t mlen = token & 0x0F;
    if (mlen == 15) {
      uint32_t b;
      do {
        if (ip >= end) return malformed(ip - src);
        b = *ip++;
        mlen += b;
      } while (b == 255);
    }
    mlen += MIN_MATCH;
    if (static_cast<size_t>(oend - op) < mlen) return malformed(ip - src);
    const uint8_t* m = op - offset;
    if (offset >= 16 && oend - op >= static_cast<ptrdiff_t>(mlen + 16)) {
      for (size_t k = 0; k < mlen; k += 16) std::memcpy(op + k, m + k, 16);
      op += mlen;
    } else {
      while (mlen--) *op++ = *m++;
    }
  }
}
