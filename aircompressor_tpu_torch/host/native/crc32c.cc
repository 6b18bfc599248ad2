// CRC32-C — native host tier; a copy of aircompressor_tpu/native/src/crc32c.cc.
// Uses the x86 SSE4.2 CRC32 instruction when the compiler targets it, software
// slicing otherwise. _build compiles without -march, so this library takes the
// slicing branch; the values are the same. Parity with host/crc32c.py.
#include "common.h"

#if defined(__SSE4_2__)
#include <nmmintrin.h>
#endif

namespace {
uint32_t kTable[8][256];
bool table_init = [] {
  for (uint32_t i = 0; i < 256; i++) {
    uint32_t c = i;
    for (int k = 0; k < 8; k++) c = (c >> 1) ^ ((c & 1) ? 0x82F63B78u : 0);
    kTable[0][i] = c;
  }
  for (uint32_t i = 0; i < 256; i++)
    for (int t = 1; t < 8; t++)
      kTable[t][i] = (kTable[t - 1][i] >> 8) ^ kTable[0][kTable[t - 1][i] & 0xFF];
  return true;
}();
}  // namespace

extern "C" uint32_t actpu_crc32c(const uint8_t* p, size_t n, uint32_t crc) {
  uint32_t c = crc ^ 0xFFFFFFFFu;
#if defined(__SSE4_2__)
  uint64_t c64 = c;
  while (n >= 8) { c64 = _mm_crc32_u64(c64, load64(p)); p += 8; n -= 8; }
  c = static_cast<uint32_t>(c64);
  while (n--) c = _mm_crc32_u8(c, *p++);
#else
  while (n >= 8) {
    uint64_t v = load64(p) ^ c;
    c = kTable[7][v & 0xFF] ^ kTable[6][(v >> 8) & 0xFF] ^ kTable[5][(v >> 16) & 0xFF] ^
        kTable[4][(v >> 24) & 0xFF] ^ kTable[3][(v >> 32) & 0xFF] ^ kTable[2][(v >> 40) & 0xFF] ^
        kTable[1][(v >> 48) & 0xFF] ^ kTable[0][(v >> 56) & 0xFF];
    p += 8; n -= 8;
  }
  while (n--) c = (c >> 8) ^ kTable[0][(c ^ *p++) & 0xFF];
#endif
  return c ^ 0xFFFFFFFFu;
}
