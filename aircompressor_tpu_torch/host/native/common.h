// Shared helpers of the native host tier: a copy of
// aircompressor_tpu/native/src/common.h.
#pragma once
#include <cstdint>
#include <cstring>
#include <cstddef>

static inline uint16_t load16(const uint8_t* p) { uint16_t v; std::memcpy(&v, p, 2); return v; }
static inline uint32_t load32(const uint8_t* p) { uint32_t v; std::memcpy(&v, p, 4); return v; }
static inline uint64_t load64(const uint8_t* p) { uint64_t v; std::memcpy(&v, p, 8); return v; }
static inline void store16(uint8_t* p, uint16_t v) { std::memcpy(p, &v, 2); }
static inline void store32(uint8_t* p, uint32_t v) { std::memcpy(p, &v, 4); }
static inline void store64(uint8_t* p, uint64_t v) { std::memcpy(p, &v, 8); }

static inline uint32_t rotl32(uint32_t x, int r) { return (x << r) | (x >> (32 - r)); }
static inline uint64_t rotl64(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }

// error convention for decoders: return -(offset+1) on malformed input
static inline int64_t malformed(size_t offset) { return -static_cast<int64_t>(offset) - 1; }
