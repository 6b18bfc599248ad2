// The benchmark's own Snappy and LZ4 block decoders, one call for a batch of
// blocks: a line-for-line transcription of the plain Python decoders in
// bench_port/reference/blocks.py (without their control window), so that
// the check can decode every block a write batch produced. Each block is
// parsed with every bound checked; a block that breaks its format gets a
// status of -1 and no output.
#include <cstddef>
#include <cstdint>
#include <cstring>

namespace {
// Appends a copy of `length` bytes from `offset` back; false where the
// offset is 0, reaches before the output, or the copy passes the cap.
inline bool copy_back(uint8_t* out, size_t& op, size_t cap, size_t offset, size_t length) {
  if (offset == 0 || offset > op || length > cap - op) return false;
  const uint8_t* s = out + op - offset;
  uint8_t* d = out + op;
  for (size_t k = 0; k < length; k++) d[k] = s[k];  // byte by byte: copies may overlap
  op += length;
  return true;
}

// Returns the decoded length, or -1.
int64_t snappy_decode(const uint8_t* in, size_t n, uint8_t* out, size_t cap) {
  size_t ip = 0, declared = 0;
  for (int shift = 0;; shift += 7) {
    if (ip >= n || shift > 28) return -1;
    uint8_t b = in[ip++];
    declared |= static_cast<size_t>(b & 0x7F) << shift;
    if (b < 0x80) break;
  }
  if (declared > cap) return -1;
  size_t op = 0;
  while (ip < n) {
    uint8_t tag = in[ip++];
    int kind = tag & 3;
    if (kind == 0) {
      size_t length = (tag >> 2) + 1;
      if (length > 60) {
        size_t extra = length - 60;
        if (ip + extra > n) return -1;
        length = 0;
        for (size_t k = 0; k < extra; k++) length |= static_cast<size_t>(in[ip + k]) << (8 * k);
        length += 1;
        ip += extra;
      }
      if (length > n - ip || length > declared - op) return -1;
      std::memcpy(out + op, in + ip, length);
      op += length;
      ip += length;
    } else {
      size_t length, offset;
      if (kind == 1) {
        if (ip + 1 > n) return -1;
        length = 4 + ((tag >> 2) & 7);
        offset = (static_cast<size_t>(tag >> 5) << 8) | in[ip];
        ip += 1;
      } else {
        size_t width = kind == 2 ? 2 : 4;
        if (ip + width > n) return -1;
        length = (tag >> 2) + 1;
        offset = 0;
        for (size_t k = 0; k < width; k++) offset |= static_cast<size_t>(in[ip + k]) << (8 * k);
        ip += width;
      }
      if (!copy_back(out, op, declared, offset, length)) return -1;
    }
  }
  return op == declared ? static_cast<int64_t>(op) : -1;
}

// Returns the decoded length, or -1.
int64_t lz4_decode(const uint8_t* in, size_t n, uint8_t* out, size_t cap) {
  if (n == 0) return -1;
  size_t ip = 0, op = 0;
  for (;;) {
    if (ip >= n) return -1;
    uint8_t token = in[ip++];
    size_t lit = token >> 4;
    if (lit == 15) {
      for (;;) {
        if (ip >= n) return -1;
        uint8_t b = in[ip++];
        lit += b;
        if (b != 255) break;
      }
    }
    if (lit > n - ip || lit > cap - op) return -1;
    std::memcpy(out + op, in + ip, lit);
    op += lit;
    ip += lit;
    if (ip == n) return static_cast<int64_t>(op);
    if (ip + 2 > n) return -1;
    size_t offset = in[ip] | (static_cast<size_t>(in[ip + 1]) << 8);
    ip += 2;
    size_t length = token & 15;
    if (length == 15) {
      for (;;) {
        if (ip >= n) return -1;
        uint8_t b = in[ip++];
        length += b;
        if (b != 255) break;
      }
    }
    if (!copy_back(out, op, cap, offset, length + 4)) return -1;
  }
}
}  // namespace

// Decode `count` blocks, row i of `src` (`stride` bytes a row) of `lens[i]`
// bytes, into row i of `dst` (`cap` bytes a row); writes each decoded
// length, or -1 for a block that breaks its format, to `out_lens`. codec 0
// is Snappy, 1 is LZ4. Returns 0, or -1 where a length passes the stride or
// the codec is unknown.
extern "C" int bench_decompress_batch(int codec, const uint8_t* src, int64_t count,
                                      int64_t stride, const int64_t* lens, uint8_t* dst,
                                      int64_t cap, int64_t* out_lens) {
  if (codec != 0 && codec != 1) return -1;
  for (int64_t i = 0; i < count; i++) {
    if (lens[i] < 0 || lens[i] > stride) return -1;
    const uint8_t* s = src + i * stride;
    uint8_t* d = dst + i * cap;
    size_t n = static_cast<size_t>(lens[i]);
    out_lens[i] = codec == 0 ? snappy_decode(s, n, d, cap) : lz4_decode(s, n, d, cap);
  }
  return 0;
}
