// xxHash32 / xxHash64 one-shot — native tier.
// Own implementation of the public xxHash spec (xxhash_spec.md); a copy of
// aircompressor_tpu/native/src/xxhash.cc, parity with host/xxhash.py.
#include "common.h"

namespace {
constexpr uint32_t P32_1 = 2654435761u, P32_2 = 2246822519u, P32_3 = 3266489917u,
                   P32_4 = 668265263u, P32_5 = 374761393u;
constexpr uint64_t P64_1 = 0x9E3779B185EBCA87ull, P64_2 = 0xC2B2AE3D27D4EB4Full,
                   P64_3 = 0x165667B19E3779F9ull, P64_4 = 0x85EBCA77C2B2AE63ull,
                   P64_5 = 0x27D4EB2F165667C5ull;

inline uint32_t round32(uint32_t acc, uint32_t lane) { return rotl32(acc + lane * P32_2, 13) * P32_1; }
inline uint64_t round64(uint64_t acc, uint64_t lane) { return rotl64(acc + lane * P64_2, 31) * P64_1; }
inline uint64_t merge64(uint64_t h, uint64_t acc) { return (h ^ round64(0, acc)) * P64_1 + P64_4; }
}  // namespace

extern "C" uint32_t actpu_xxh32(const uint8_t* p, size_t n, uint32_t seed) {
  const uint8_t* end = p + n;
  uint32_t h;
  if (n >= 16) {
    uint32_t v1 = seed + P32_1 + P32_2, v2 = seed + P32_2, v3 = seed, v4 = seed - P32_1;
    const uint8_t* limit = end - 16;
    do {
      v1 = round32(v1, load32(p));
      v2 = round32(v2, load32(p + 4));
      v3 = round32(v3, load32(p + 8));
      v4 = round32(v4, load32(p + 12));
      p += 16;
    } while (p <= limit);
    h = rotl32(v1, 1) + rotl32(v2, 7) + rotl32(v3, 12) + rotl32(v4, 18);
  } else {
    h = seed + P32_5;
  }
  h += static_cast<uint32_t>(n);
  while (p + 4 <= end) { h = rotl32(h + load32(p) * P32_3, 17) * P32_4; p += 4; }
  while (p < end) { h = rotl32(h + (*p++) * P32_5, 11) * P32_1; }
  h ^= h >> 15; h *= P32_2; h ^= h >> 13; h *= P32_3; h ^= h >> 16;
  return h;
}

extern "C" uint64_t actpu_xxh64(const uint8_t* p, size_t n, uint64_t seed) {
  const uint8_t* end = p + n;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = seed + P64_1 + P64_2, v2 = seed + P64_2, v3 = seed, v4 = seed - P64_1;
    const uint8_t* limit = end - 32;
    do {
      v1 = round64(v1, load64(p));
      v2 = round64(v2, load64(p + 8));
      v3 = round64(v3, load64(p + 16));
      v4 = round64(v4, load64(p + 24));
      p += 32;
    } while (p <= limit);
    h = rotl64(v1, 1) + rotl64(v2, 7) + rotl64(v3, 12) + rotl64(v4, 18);
    h = merge64(h, v1); h = merge64(h, v2); h = merge64(h, v3); h = merge64(h, v4);
  } else {
    h = seed + P64_5;
  }
  h += n;
  while (p + 8 <= end) { h = rotl64(h ^ round64(0, load64(p)), 27) * P64_1 + P64_4; p += 8; }
  if (p + 4 <= end) { h = rotl64(h ^ (load32(p) * P64_1), 23) * P64_2 + P64_3; p += 4; }
  while (p < end) { h = rotl64(h ^ ((*p++) * P64_5), 11) * P64_1; }
  h ^= h >> 33; h *= P64_2; h ^= h >> 29; h *= P64_3; h ^= h >> 32;
  return h;
}
