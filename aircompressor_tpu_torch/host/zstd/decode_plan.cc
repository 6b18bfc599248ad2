// zstd decode planner for the card's three zstd kernels.
//
// The C++ counterpart of device_prep.py's plan_batch followed by
// ops/zstd_decode.py's pack: it parses the frame, block, literals and
// sequences headers of a batch of single-frame items, reads the Huffman
// and FSE table descriptions, and lays the plan out in pack's arrays. The
// Python planner stays as the reference; this one gives the same arrays,
// element for element, and the same error (the first malformed item's
// index and the Python planner's reason text).
//
// One call plans the batch into buffers of its own (acx_zstd_decode_plan,
// which reports the array sizes); a second writes them into the caller's
// arrays (acx_zstd_decode_plan_write). Tables are kept once each: a
// sequences section refers to its FSE tables, a Huffman stream to its
// table's walk parameters, and the write expands them into each row.
//
// Python ints do not overflow, so positions, bit counts and content sizes
// are 64-bit here; the 8-byte content size is unsigned.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <new>
#include <string>
#include <vector>

namespace {

constexpr int64_t LANES = 128;
constexpr uint32_t MAGIC = 0xFD2FB528u;
constexpr int64_t MAX_BLOCK_SIZE = 128 * 1024;
constexpr int RAW_BLOCK = 0, RLE_BLOCK = 1, COMPRESSED_BLOCK = 2;
constexpr int RAW_LITERALS = 0, RLE_LITERALS = 1, COMPRESSED_LITERALS = 2;
constexpr int SEQ_PREDEFINED = 0, SEQ_RLE = 1, SEQ_FSE = 2;
constexpr int MAX_LL_SYMBOL = 35, MAX_ML_SYMBOL = 52, MAX_OF_SYMBOL = 31;
constexpr int LL_TABLE_LOG_MAX = 9, ML_TABLE_LOG_MAX = 9, OF_TABLE_LOG_MAX = 8;
constexpr int HUF_MAX_SYMBOL = 255, HUF_MAX_TABLE_LOG = 12, WEIGHT_FSE_LOG_MAX = 6;
constexpr int PIECE_HUFF = 0, PIECE_RAW = 1, PIECE_RLE = 2;

// pack's layout (ops/zstd_decode.py)
constexpr int H_WORDS = 32, H_RANK_START = 8, H_CUM_SYMS = 20;
constexpr int S_WORDS = 8, S_TABLE = 1280, B_WORDS = 16;

constexpr int LL_DEFAULT_NORM[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2,
                                     2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2,
                                     2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
constexpr int ML_DEFAULT_NORM[53] = {
    1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1,  1,  1,  1,  1,  1,  1,  1,  1,  1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
constexpr int OF_DEFAULT_NORM[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                                     1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

struct Malformed {
  int64_t pos;
  std::string reason;
};

[[noreturn]] void fail(int64_t pos, std::string reason) {
  throw Malformed{pos, std::move(reason)};
}

int64_t align(int64_t n) { return (n + LANES - 1) / LANES * LANES; }

int bit_length(uint64_t v) { return v ? 64 - __builtin_clzll(v) : 0; }

// The flat input: the batch's items one after another, zero-padded to a
// multiple of 128 bytes (plan_batch's src).
struct Src {
  const uint8_t* p;
  int64_t n;
  int at(int64_t i) const { return p[i]; }
  uint32_t u24(int64_t i) const { return p[i] | (p[i + 1] << 8) | (uint32_t(p[i + 2]) << 16); }
  uint32_t u32(int64_t i) const { return u24(i) | (uint32_t(p[i + 3]) << 24); }
  // little-endian value of bytes [lo, hi) that lie inside the buffer
  uint64_t word(int64_t lo, int64_t hi) const {
    uint64_t w = 0;
    for (int64_t i = lo; i < hi; i++)
      if (i >= 0 && i < n) w |= uint64_t(p[i]) << (8 * (i - lo));
    return w;
  }
};

uint64_t mask(int n) { return n >= 64 ? ~uint64_t(0) : (uint64_t(1) << n) - 1; }

// bits.ForwardBitReader: reads past the end of its range into the rest of
// the flat buffer, and reads zeros past the buffer.
struct ForwardBitReader {
  const Src& s;
  int64_t base, bit_pos = 0, limit_bits;
  ForwardBitReader(const Src& src, int64_t start, int64_t end)
      : s(src), base(start), limit_bits((end - start) * 8) {}
  uint64_t peek(int n) const {
    int64_t lo = base + (bit_pos >> 3);
    int64_t hi = std::min(base + ((bit_pos + n + 7) >> 3), s.n);
    return (s.word(lo, hi) >> (bit_pos & 7)) & mask(n);
  }
  uint64_t read(int n) {
    uint64_t v = peek(n);
    bit_pos += n;
    return v;
  }
  void skip(int n) { bit_pos += n; }
  int64_t bytes_consumed() const { return (bit_pos + 7) >> 3; }
  bool overflowed() const { return bit_pos > limit_bits; }
};

// bits.BackwardBitReader
struct BackwardBitReader {
  const Src& s;
  int64_t start, remaining;
  BackwardBitReader(const Src& src, int64_t lo, int64_t end) : s(src), start(lo) {
    if (end <= lo || end > s.n) fail(lo, "empty or invalid bitstream");
    int last = s.at(end - 1);
    if (last == 0) fail(end - 1, "bitstream end mark missing");
    remaining = (end - lo - 1) * 8 + (bit_length(last) - 1);
  }
  uint64_t extract(int64_t lo_bit, int n) const {
    int64_t lo = start + (lo_bit >> 3), hi = start + ((lo_bit + n + 7) >> 3);
    return (s.word(lo, hi) >> (lo_bit & 7)) & mask(n);
  }
  uint64_t peek(int n) const {
    if (n == 0 || remaining <= 0) return 0;
    if (remaining < n) return extract(0, int(remaining)) << (n - remaining);
    return extract(remaining - n, n);
  }
  uint64_t read(int n) {
    uint64_t v = peek(n);
    remaining -= n;
    return v;
  }
  bool overflowed() const { return remaining < 0; }
};

// fse.FseTable
struct FseTable {
  int log = 0;
  std::vector<int64_t> symbol, num_bits, new_state;
};

// fse.read_normalized_counts: the counts (-1 for "less than one"), the
// table log and the bytes consumed.
std::vector<int64_t> read_normalized_counts(const Src& s, int64_t start, int64_t end,
                                            int max_symbol, int max_table_log, int* table_log,
                                            int64_t* consumed) {
  ForwardBitReader br(s, start, end);
  int log = int(br.read(4)) + 5;
  if (log > max_table_log) fail(start, "FSE table log " + std::to_string(log) + " too large");
  int64_t table_size = int64_t(1) << log;
  int64_t remaining = table_size + 1, threshold = table_size;
  int nb_bits = log + 1;
  std::vector<int64_t> counts(max_symbol + 1, 0);
  int64_t symbol = 0;
  bool previous_zero = false;
  while (remaining > 1) {
    if (symbol > max_symbol) fail(start, "too many FSE symbols");
    if (previous_zero) {
      int64_t n = symbol;
      while (br.peek(16) == 0xFFFF) {
        br.skip(16);
        n += 24;
      }
      while (br.peek(2) == 3) {
        br.skip(2);
        n += 3;
      }
      n += int64_t(br.read(2));
      if (n > max_symbol + 1) fail(start, "zero-repeat overruns symbol range");
      symbol = n;
      if (br.overflowed()) fail(start, "FSE description overruns input");
      previous_zero = false;
      continue;
    }
    int64_t maxv = 2 * threshold - 1 - remaining;
    int64_t value = int64_t(br.peek(nb_bits));
    int64_t low = value & (threshold - 1), count;
    if (low < maxv) {
      count = low;
      br.skip(nb_bits - 1);
    } else {
      count = value & (2 * threshold - 1);
      if (count >= threshold) count -= maxv;
      br.skip(nb_bits);
    }
    count -= 1;
    remaining -= count < 0 ? -count : count;
    counts[symbol] = count;
    symbol += 1;
    previous_zero = count == 0;
    while (remaining < threshold) {
      nb_bits -= 1;
      threshold >>= 1;
    }
    if (br.overflowed()) fail(start, "FSE description overruns input");
  }
  if (remaining != 1) fail(start, "FSE normalized counts do not sum to table size");
  counts.resize(symbol > 0 ? symbol : 1);
  *table_log = log;
  *consumed = br.bytes_consumed();
  return counts;
}

// fse.build_decode_table, as its vectorised form computes it: the cells
// the spread step visits at or below the low-probability cells take the
// symbols in order, and each symbol's states count up from its count in
// state order. Every table here has a log of 5 or more, where the step is
// odd, so the scalar form it keeps for tables under 8 cells never runs.
FseTable build_decode_table(const std::vector<int64_t>& counts, int log) {
  int64_t size = int64_t(1) << log;
  int64_t n_symbols = int64_t(counts.size());
  FseTable t;
  t.log = log;
  t.symbol.assign(size, 0);
  int64_t n_low = 0;
  for (int64_t s = 0; s < n_symbols; s++)
    if (counts[s] == -1) t.symbol[size - 1 - n_low++] = s;
  int64_t high = size - 1 - n_low;
  int64_t step = (size >> 1) + (size >> 3) + 3, msk = size - 1;
  std::vector<int64_t> kept;
  kept.reserve(size);
  for (int64_t i = 0; i < size; i++) {
    int64_t w = (i * step) & msk;
    if (w <= high) kept.push_back(w);
  }
  int64_t total = 0;
  for (int64_t c : counts) total += c > 0 ? c : 0;
  if (total != int64_t(kept.size())) fail(0, "FSE spread did not return to zero");
  int64_t j = 0;
  for (int64_t s = 0; s < n_symbols; s++)
    for (int64_t k = 0; k < counts[s]; k++) t.symbol[kept[j++]] = s;
  std::vector<int64_t> next(n_symbols);
  for (int64_t s = 0; s < n_symbols; s++) next[s] = counts[s] == -1 ? 1 : counts[s];
  t.num_bits.resize(size);
  t.new_state.resize(size);
  for (int64_t u = 0; u < size; u++) {
    int64_t nxt = next[t.symbol[u]]++;
    int64_t nb = log - (bit_length(uint64_t(nxt)) - 1);
    t.num_bits[u] = nb;
    t.new_state[u] = (nxt << nb) - size;
  }
  return t;
}

FseTable build_rle_table(int64_t symbol) {
  FseTable t;
  t.symbol = {symbol};
  t.num_bits = {0};
  t.new_state = {0};
  return t;
}

// fse.decompress_interleaved2 (the Huffman weights)
std::vector<int64_t> decompress_interleaved2(const FseTable& t, BackwardBitReader& r,
                                             int64_t max_output) {
  std::vector<int64_t> out;
  int64_t s1 = int64_t(r.read(t.log)), s2 = int64_t(r.read(t.log));
  if (r.overflowed()) fail(0, "FSE stream too short for initial states");
  auto put = [&](int64_t st) {
    if (int64_t(out.size()) >= max_output) fail(0, "FSE output exceeds limit");
    out.push_back(t.symbol[st]);
  };
  for (;;) {
    put(s1);
    s1 = t.new_state[s1] + int64_t(r.read(int(t.num_bits[s1])));
    if (r.overflowed()) {
      put(s2);
      break;
    }
    put(s2);
    s2 = t.new_state[s2] + int64_t(r.read(int(t.num_bits[s2])));
    if (r.overflowed()) {
      put(s1);
      break;
    }
  }
  return out;
}

// A Huffman table as the kernel walks it (device_prep._walk_params).
struct HuffParams {
  int table_log;
  int32_t rank_start[13];
  int32_t cum[12];
  uint8_t perm[256];
};

// huffman.build_table and device_prep._walk_params.
HuffParams huffman_params(const std::vector<int64_t>& weights) {
  if (weights.empty() || int64_t(weights.size()) > HUF_MAX_SYMBOL)
    fail(0, "invalid Huffman weight count");
  for (int64_t w : weights)
    if (w > HUF_MAX_TABLE_LOG) fail(0, "Huffman weight too large");
  int64_t total = 0;
  for (int64_t w : weights)
    if (w > 0) total += int64_t(1) << (w - 1);
  if (total == 0) fail(0, "all Huffman weights zero");
  int log = bit_length(uint64_t(total));
  if (log > HUF_MAX_TABLE_LOG) fail(0, "Huffman table log too large");
  int64_t rest = (int64_t(1) << log) - total;
  if (rest & (rest - 1)) fail(0, "Huffman weights must leave a power-of-2 remainder");
  std::vector<int64_t> all(weights);
  all.push_back(bit_length(uint64_t(rest)));
  int64_t size = int64_t(1) << log;
  int64_t rank_count[HUF_MAX_TABLE_LOG + 2] = {0};
  for (int64_t w : all) rank_count[w]++;
  int64_t rank_start[HUF_MAX_TABLE_LOG + 2] = {0}, next_start = 0;
  for (int w = 1; w < HUF_MAX_TABLE_LOG + 2; w++) {
    rank_start[w] = next_start;
    next_start += rank_count[w] << (w - 1);
  }
  if (next_start != size) fail(0, "Huffman weights do not fill the table");
  std::vector<int64_t> syms(size, 0), bits(size, 0);
  for (int64_t s = 0; s < int64_t(all.size()); s++) {
    int64_t w = all[s];
    if (w == 0) continue;
    int64_t length = int64_t(1) << (w - 1), pos = rank_start[w];
    for (int64_t k = 0; k < length; k++) {
      syms[pos + k] = s;
      bits[pos + k] = log + 1 - w;
    }
    rank_start[w] += length;
  }
  // runs of one symbol, in table order, give the canonical permutation
  HuffParams hp{};
  hp.table_log = log;
  std::vector<int64_t> run_w;
  for (int64_t i = 0; i < size; i++) {
    if (i == 0 || syms[i] != syms[i - 1]) {
      hp.perm[run_w.size()] = uint8_t(syms[i]);
      run_w.push_back(log + 1 - bits[i]);
    }
  }
  int64_t pos = 0;
  size_t run_i = 0;
  for (int w = 1; w < 13; w++) {
    hp.rank_start[w] = int32_t(pos);
    hp.cum[w - 1] = int32_t(run_i);
    while (run_i < run_w.size() && run_w[run_i] == w) {
      pos += int64_t(1) << (w - 1);
      run_i++;
    }
  }
  if (pos != size) fail(0, "huffman table runs inconsistent");
  return hp;
}

// huffman.read_table: the table's walk parameters and the bytes consumed.
HuffParams read_huffman_table(const Src& s, int64_t start, int64_t end, int64_t* consumed) {
  if (start >= end) fail(start, "truncated Huffman table");
  int header = s.at(start);
  int64_t ip = start + 1;
  std::vector<int64_t> weights;
  if (header >= 128) {
    int64_t n_weights = header - 127, n_bytes = (n_weights + 1) / 2;
    if (ip + n_bytes > end) fail(ip, "truncated Huffman weights");
    for (int64_t i = 0; i < n_weights; i++) {
      int b = s.at(ip + i / 2);
      weights.push_back(i % 2 == 0 ? b >> 4 : b & 0xF);
    }
    *consumed = 1 + n_bytes;
  } else {
    if (ip + header > end) fail(ip, "truncated compressed Huffman weights");
    int log;
    int64_t desc_len;
    std::vector<int64_t> counts =
        read_normalized_counts(s, ip, ip + header, HUF_MAX_SYMBOL, WEIGHT_FSE_LOG_MAX, &log,
                               &desc_len);
    FseTable table = build_decode_table(counts, log);
    BackwardBitReader reader(s, ip + desc_len, ip + header);
    weights = decompress_interleaved2(table, reader, 255);
    *consumed = 1 + header;
  }
  return huffman_params(weights);
}

// device_prep._pack_fse, at its row's width
std::vector<int32_t> pack_fse(const FseTable& t, int cap) {
  std::vector<int32_t> out(cap, 0);
  for (size_t i = 0; i < t.symbol.size(); i++)
    out[i] = int32_t(t.symbol[i] | (t.num_bits[i] << 6) | (t.new_state[i] << 10));
  return out;
}

// device_prep._bits_read
int64_t bits_read(const Src& s, int64_t lo, int64_t rem, int n) {
  if (n == 0 || rem <= 0) return 0;
  int64_t take = rem < n ? rem : n;
  int64_t b0 = lo * 8 + (rem - take);
  int64_t first = b0 >> 3, nbytes = (take + (b0 & 7) + 7) / 8 + 1;
  uint64_t v = (s.word(first, first + nbytes) >> (b0 & 7)) & mask(int(take));
  return int64_t(v << (n - take));
}

// device_prep._backward_init
int64_t backward_init(const Src& s, int64_t lo, int64_t hi) {
  if (hi <= lo || hi > s.n) fail(lo, "empty or invalid bitstream");
  int last = s.at(hi - 1);
  if (last == 0) fail(hi - 1, "bitstream end mark missing");
  return (hi - lo - 1) * 8 + (bit_length(last) - 1);
}

struct SeqTable {  // a table in pack's entry form, with its log
  int log;
  std::vector<int32_t> entries;
};

struct HStream {
  int64_t byte_lo, rem, nsym, out_base;
  int64_t params;  // index into Plan::huff
};

struct SStream {
  int64_t byte_lo, rem, nseq, out_base, ll_state, of_state, ml_state;
  int64_t ll, of, ml;  // indices into Plan::tables
};

struct FrameRec {
  int64_t content_size, checksum;
  int64_t first_block, n_blocks, first_h, n_h, first_s, n_s;
};

struct Plan {
  std::vector<HuffParams> huff;
  std::vector<SeqTable> tables;  // 0, 1, 2: the predefined LL, OF and ML tables
  std::vector<HStream> hs;
  std::vector<SStream> ss;
  std::vector<int32_t> blocks;  // B_WORDS a block
  std::vector<FrameRec> frames;
  int64_t lit_cursor = 0, seq_cursor = 0;
};

SeqTable seq_table(const FseTable& t, int cap) { return SeqTable{t.log, pack_fse(t, cap)}; }

FseTable predefined(const int* norm, int n, int log) {
  return build_decode_table(std::vector<int64_t>(norm, norm + n), log);
}

class Planner {
 public:
  Planner(const Src& s, int64_t out_cap, Plan& plan) : s_(s), out_cap_(out_cap), p_(plan) {
    p_.tables.push_back(seq_table(predefined(LL_DEFAULT_NORM, 36, 6), 512));
    p_.tables.push_back(seq_table(predefined(OF_DEFAULT_NORM, 29, 5), 256));
    p_.tables.push_back(seq_table(predefined(ML_DEFAULT_NORM, 53, 6), 512));
  }

  void add_frame(int64_t lo, int64_t hi) {
    if (hi - lo < 4 || s_.u32(lo) != MAGIC) fail(lo, "invalid magic");
    int64_t ip = lo + 4;
    bool has_checksum, known;
    uint64_t content_size;
    int64_t header_size = read_frame_header(ip, &has_checksum, &known, &content_size);
    if (known && content_size > uint64_t(out_cap_)) fail(ip, "frame exceeds batch out_cap");
    ip += header_size;
    FrameRec f{known ? int64_t(content_size) : -1, -1,
               int64_t(p_.blocks.size() / B_WORDS), 0, int64_t(p_.hs.size()), 0,
               int64_t(p_.ss.size()), 0};
    ctx_huff_ = -1;
    ctx_ll_ = ctx_of_ = ctx_ml_ = -1;
    for (;;) {
      if (ip + 3 > hi) fail(ip, "truncated block header");
      uint32_t bh = s_.u24(ip);
      ip += 3;
      int last = bh & 1, btype = (bh >> 1) & 3;
      int64_t bsize = bh >> 3;
      if (btype == RAW_BLOCK) {
        if (ip + bsize > hi) fail(ip, "truncated raw block");
        block(0, -1, bsize, {PIECE_RAW}, {ip}, {bsize});
        ip += bsize;
      } else if (btype == RLE_BLOCK) {
        if (ip >= hi || bsize > MAX_BLOCK_SIZE) fail(ip, "bad RLE block");
        block(0, -1, bsize, {PIECE_RLE}, {s_.at(ip)}, {bsize});
        ip += 1;
      } else if (btype == COMPRESSED_BLOCK) {
        if (bsize > MAX_BLOCK_SIZE || ip + bsize > hi) fail(ip, "bad compressed block");
        compressed_block(ip, ip + bsize);
        ip += bsize;
      } else {
        fail(ip, "reserved block type");
      }
      if (last) break;
    }
    if (has_checksum) {
      if (ip + 4 > hi) fail(ip, "truncated frame checksum");
      f.checksum = s_.u32(ip);
      ip += 4;
    }
    if (ip != hi) fail(ip, "trailing bytes after frame");
    f.n_blocks = int64_t(p_.blocks.size() / B_WORDS) - f.first_block;
    f.n_h = int64_t(p_.hs.size()) - f.first_h;
    f.n_s = int64_t(p_.ss.size()) - f.first_s;
    p_.frames.push_back(f);
  }

 private:
  // device_prep.read_frame_header (bounded by the whole flat buffer, as
  // there); returns the header's size.
  int64_t read_frame_header(int64_t ip, bool* has_checksum, bool* known, uint64_t* content) {
    int64_t n = s_.n;
    if (ip >= n) fail(ip, "truncated frame header");
    int fhd = s_.at(ip);
    int64_t pos = ip + 1;
    int fcs_flag = fhd >> 6;
    bool single_segment = fhd & 0x20;
    if (fhd & 0x08) fail(ip, "reserved frame header bit set");
    *has_checksum = fhd & 0x04;
    int dict_flag = fhd & 0x03;
    if (!single_segment) {
      if (pos >= n) fail(pos, "truncated window descriptor");
      pos += 1;  // the window size is not needed for a plan
    }
    static constexpr int DICT_BYTES[4] = {0, 1, 2, 4};
    int dict_bytes = DICT_BYTES[dict_flag];
    uint64_t dictionary_id = 0;
    if (dict_bytes) {
      if (pos + dict_bytes > n) fail(pos, "truncated dictionary id");
      for (int k = 0; k < dict_bytes; k++) dictionary_id |= uint64_t(s_.at(pos + k)) << (8 * k);
      pos += dict_bytes;
    }
    int fcs_bytes = fcs_flag == 0 ? (single_segment ? 1 : 0) : fcs_flag == 1 ? 2
                    : fcs_flag == 2 ? 4 : 8;
    *known = false;
    *content = 0;
    if (fcs_bytes) {
      if (pos + fcs_bytes > n) fail(pos, "truncated content size");
      for (int k = 0; k < fcs_bytes; k++) *content |= uint64_t(s_.at(pos + k)) << (8 * k);
      if (fcs_bytes == 2) *content += 256;
      *known = true;
      pos += fcs_bytes;
    }
    if (dictionary_id) fail(ip, "dictionaries are not supported");
    return pos - ip;
  }

  void block(int64_t n_seq, int64_t seq_base, int64_t lit_total, std::vector<int64_t> kind,
             std::vector<int64_t> src, std::vector<int64_t> end) {
    int32_t row[B_WORDS] = {0};
    row[0] = int32_t(n_seq);
    row[1] = int32_t(seq_base);
    row[2] = int32_t(lit_total);
    for (size_t k = 0; k < kind.size(); k++) {
      row[4 + k] = int32_t(kind[k]);
      row[8 + k] = int32_t(src[k]);
      row[12 + k] = int32_t(end[k]);
    }
    p_.blocks.insert(p_.blocks.end(), row, row + B_WORDS);
  }

  void compressed_block(int64_t lo, int64_t hi) {
    std::vector<int64_t> kind, src, end;
    int64_t seq_lo;
    int64_t lit_total = literals(lo, hi, kind, src, end, &seq_lo);
    int64_t seq_base;
    int64_t n_seq = sequences(seq_lo, hi, &seq_base);
    block(n_seq, seq_base, lit_total, kind, src, end);
  }

  // device_prep._Planner._plan_literals: the literal count; *next is where
  // the sequences section starts.
  int64_t literals(int64_t lo, int64_t hi, std::vector<int64_t>& pk, std::vector<int64_t>& ps,
                   std::vector<int64_t>& pe, int64_t* next) {
    if (lo >= hi) fail(lo, "empty compressed block");
    int b0 = s_.at(lo);
    int lit_type = b0 & 3, size_format = (b0 >> 2) & 3;
    if (lit_type == RAW_LITERALS || lit_type == RLE_LITERALS) {
      int64_t regen, header;
      if (size_format == 0 || size_format == 2) {
        regen = b0 >> 3;
        header = 1;
      } else if (size_format == 1) {
        if (lo + 2 > hi) fail(lo, "truncated literals header");
        regen = (b0 >> 4) | (s_.at(lo + 1) << 4);
        header = 2;
      } else {
        if (lo + 3 > hi) fail(lo, "truncated literals header");
        regen = (b0 >> 4) | (s_.at(lo + 1) << 4) | (int64_t(s_.at(lo + 2)) << 12);
        header = 3;
      }
      if (lit_type == RAW_LITERALS) {
        if (lo + header + regen > hi) fail(lo, "raw literals exceed block");
        pk.push_back(PIECE_RAW);
        ps.push_back(lo + header);
        pe.push_back(regen);
        *next = lo + header + regen;
        return regen;
      }
      if (lo + header >= hi) fail(lo, "truncated RLE literal");
      pk.push_back(PIECE_RLE);
      ps.push_back(s_.at(lo + header));
      pe.push_back(regen);
      *next = lo + header + 1;
      return regen;
    }
    int streams = size_format == 0 ? 1 : 4;
    int64_t regen, comp, header;
    if (size_format == 0 || size_format == 1) {
      if (lo + 3 > hi) fail(lo, "truncated literals header");
      int64_t b1 = s_.at(lo + 1), b2 = s_.at(lo + 2);
      regen = (b0 >> 4) | ((b1 & 0x3F) << 4);
      comp = (b1 >> 6) | (b2 << 2);
      header = 3;
    } else if (size_format == 2) {
      if (lo + 4 > hi) fail(lo, "truncated literals header");
      int64_t b1 = s_.at(lo + 1), b2 = s_.at(lo + 2), b3 = s_.at(lo + 3);
      regen = (b0 >> 4) | (b1 << 4) | ((b2 & 3) << 12);
      comp = (b2 >> 2) | (b3 << 6);
      header = 4;
    } else {
      if (lo + 5 > hi) fail(lo, "truncated literals header");
      int64_t b1 = s_.at(lo + 1), b2 = s_.at(lo + 2), b3 = s_.at(lo + 3), b4 = s_.at(lo + 4);
      regen = (b0 >> 4) | (b1 << 4) | ((b2 & 0x3F) << 12);
      comp = (b2 >> 6) | (b3 << 2) | (b4 << 10);
      header = 5;
    }
    int64_t payload_lo = lo + header, payload_hi = payload_lo + comp;
    if (payload_hi > hi) fail(lo, "compressed literals exceed block");
    int64_t stream_lo;
    if (lit_type == COMPRESSED_LITERALS) {
      int64_t consumed;
      HuffParams hp = read_huffman_table(s_, payload_lo, payload_hi, &consumed);
      p_.huff.push_back(hp);
      ctx_huff_ = int64_t(p_.huff.size()) - 1;
      stream_lo = payload_lo + consumed;
    } else {
      if (ctx_huff_ < 0) fail(lo, "treeless literals without a previous Huffman table");
      stream_lo = payload_lo;
    }
    int64_t bounds[5], sizes[4];
    if (streams == 1) {
      bounds[0] = stream_lo;
      bounds[1] = payload_hi;
      sizes[0] = regen;
    } else {
      if (payload_hi - stream_lo < 6 + 4) fail(stream_lo, "4-stream literals too short");
      int64_t s1 = s_.at(stream_lo) | (s_.at(stream_lo + 1) << 8);
      int64_t s2 = s_.at(stream_lo + 2) | (s_.at(stream_lo + 3) << 8);
      int64_t s3 = s_.at(stream_lo + 4) | (s_.at(stream_lo + 5) << 8);
      int64_t p = stream_lo + 6;
      bounds[0] = p;
      bounds[1] = p + s1;
      bounds[2] = p + s1 + s2;
      bounds[3] = p + s1 + s2 + s3;
      bounds[4] = payload_hi;
      if (bounds[3] > payload_hi) fail(stream_lo, "jump table exceeds input");
      int64_t seg = (regen + 3) / 4;
      sizes[0] = sizes[1] = sizes[2] = seg;
      sizes[3] = regen - 3 * seg;
      if (sizes[3] < 0) fail(stream_lo, "regenerated size too small");
    }
    int64_t lit_pos = 0;
    for (int k = 0; k < streams; k++) {
      int64_t nsym = sizes[k], out_base = p_.lit_cursor;
      p_.lit_cursor += align(nsym > 1 ? nsym : 1);
      int64_t rem = backward_init(s_, bounds[k], bounds[k + 1]);
      p_.hs.push_back(HStream{bounds[k], rem, nsym, out_base, ctx_huff_});
      lit_pos += nsym;
      pk.push_back(PIECE_HUFF);
      ps.push_back(out_base);
      pe.push_back(lit_pos);
    }
    *next = payload_hi;
    return regen;
  }

  // device_prep._read_seq_table: the table's index in the plan
  int64_t seq_table_at(int64_t* ip, int64_t hi, int mode, int64_t predef, int max_symbol,
                       int max_log, int64_t prev, int cap) {
    if (mode == SEQ_PREDEFINED) return predef;
    if (mode == SEQ_RLE) {
      if (*ip >= hi) fail(*ip, "truncated RLE sequence table");
      int symbol = s_.at(*ip);
      if (symbol > max_symbol) fail(*ip, "RLE sequence symbol out of range");
      *ip += 1;
      p_.tables.push_back(seq_table(build_rle_table(symbol), cap));
      return int64_t(p_.tables.size()) - 1;
    }
    if (mode == SEQ_FSE) {
      int log;
      int64_t consumed;
      std::vector<int64_t> counts =
          read_normalized_counts(s_, *ip, hi, max_symbol, max_log, &log, &consumed);
      FseTable t = build_decode_table(counts, log);
      *ip += consumed;
      p_.tables.push_back(seq_table(t, cap));
      return int64_t(p_.tables.size()) - 1;
    }
    if (prev < 0) fail(*ip, "repeat sequence table without a previous table");
    return prev;
  }

  // device_prep._Planner._plan_sequences: the sequence count
  int64_t sequences(int64_t lo, int64_t hi, int64_t* seq_base) {
    *seq_base = -1;
    if (lo >= hi) fail(lo, "missing sequences section");
    int b0 = s_.at(lo);
    int64_t ip = lo + 1, n_seq;
    if (b0 < 128) {
      n_seq = b0;
    } else if (b0 < 255) {
      if (ip >= hi) fail(ip, "truncated sequence count");
      n_seq = (int64_t(b0 - 128) << 8) + s_.at(ip);
      ip += 1;
    } else {
      if (ip + 2 > hi) fail(ip, "truncated sequence count");
      n_seq = s_.at(ip) + (int64_t(s_.at(ip + 1)) << 8) + 0x7F00;
      ip += 2;
    }
    if (n_seq == 0) return 0;
    if (ip >= hi) fail(ip, "missing sequence compression modes");
    int modes = s_.at(ip);
    ip += 1;
    if (modes & 3) fail(ip - 1, "reserved sequence mode bits set");
    int64_t ll = seq_table_at(&ip, hi, (modes >> 6) & 3, 0, MAX_LL_SYMBOL, LL_TABLE_LOG_MAX,
                              ctx_ll_, 512);
    int64_t of = seq_table_at(&ip, hi, (modes >> 4) & 3, 1, MAX_OF_SYMBOL, OF_TABLE_LOG_MAX,
                              ctx_of_, 256);
    int64_t ml = seq_table_at(&ip, hi, (modes >> 2) & 3, 2, MAX_ML_SYMBOL, ML_TABLE_LOG_MAX,
                              ctx_ml_, 512);
    ctx_ll_ = ll;
    ctx_of_ = of;
    ctx_ml_ = ml;
    int ll_log = p_.tables[ll].log, of_log = p_.tables[of].log, ml_log = p_.tables[ml].log;
    int64_t rem = backward_init(s_, ip, hi);
    int64_t ll_state = bits_read(s_, ip, rem, ll_log);
    rem -= ll_log;
    int64_t of_state = bits_read(s_, ip, rem, of_log);
    rem -= of_log;
    int64_t ml_state = bits_read(s_, ip, rem, ml_log);
    rem -= ml_log;
    if (rem < 0) fail(ip, "sequence bitstream too short");
    int64_t out_base = p_.seq_cursor;
    p_.seq_cursor += align(n_seq);
    p_.ss.push_back(SStream{ip, rem, n_seq, out_base, ll_state, of_state, ml_state, ll, of, ml});
    *seq_base = out_base;
    return n_seq;
  }

  const Src& s_;
  int64_t out_cap_;
  Plan& p_;
  int64_t ctx_huff_ = -1, ctx_ll_ = -1, ctx_of_ = -1, ctx_ml_ = -1;
};

void put_reason(const std::string& reason, char* buf, int64_t cap) {
  if (cap <= 0) return;
  size_t n = std::min(reason.size(), size_t(cap - 1));
  std::memcpy(buf, reason.data(), n);
  buf[n] = 0;
}

}  // namespace

extern "C" {

// Plan the batch: src holds n_items frames one after another (item i is
// [bounds[i], bounds[i + 1])), padded with zeros to n_src bytes. Returns a
// handle for acx_zstd_decode_plan_write and writes sizes = {Huffman streams,
// sequences sections, blocks, frames, literal slots, sequence slots}; or
// returns null with *err_item the first malformed item's index and
// err_reason its reason (*err_item -1: the planner could not allocate).
void* acx_zstd_decode_plan(const uint8_t* src, int64_t n_src, const int64_t* bounds,
                           int64_t n_items, int64_t out_cap, int64_t* sizes, int64_t* err_item,
                           char* err_reason, int64_t reason_cap) {
  Plan* plan = nullptr;
  int64_t item = -1;
  try {
    plan = new Plan();
    Src s{src, n_src};
    Planner planner(s, out_cap, *plan);
    for (item = 0; item < n_items; item++)
      planner.add_frame(bounds[item], bounds[item + 1]);
  } catch (const Malformed& e) {
    delete plan;
    *err_item = item;
    put_reason(e.reason, err_reason, reason_cap);
    return nullptr;
  } catch (const std::bad_alloc&) {
    delete plan;
    *err_item = -1;
    put_reason("out of memory", err_reason, reason_cap);
    return nullptr;
  }
  sizes[0] = int64_t(plan->hs.size());
  sizes[1] = int64_t(plan->ss.size());
  sizes[2] = int64_t(plan->blocks.size() / B_WORDS);
  sizes[3] = int64_t(plan->frames.size());
  sizes[4] = align(std::max<int64_t>(plan->lit_cursor, LANES));
  sizes[5] = align(std::max<int64_t>(plan->seq_cursor, LANES));
  return plan;
}

// Write a plan into pack's arrays, zero-filled by the caller and sized by
// acx_zstd_decode_plan: h_params (H, 32), h_perm (H, 256), s_params (S, 8),
// s_tabs (S, 1280), s_frames (F, 2), blocks (NB, 16), b_frames (F, 2),
// h_frame (H,), s_frame (S,), content_size (F,) and checksum (F,).
void acx_zstd_decode_plan_write(void* handle, int32_t* h_params, uint8_t* h_perm,
                                int32_t* s_params, int32_t* s_tabs, int32_t* s_frames,
                                int32_t* blocks, int32_t* b_frames, int64_t* h_frame,
                                int64_t* s_frame, int64_t* content_size, int64_t* checksum) {
  const Plan& p = *static_cast<Plan*>(handle);
  for (size_t i = 0; i < p.hs.size(); i++) {
    const HStream& h = p.hs[i];
    const HuffParams& hp = p.huff[h.params];
    int32_t* row = h_params + i * H_WORDS;
    row[0] = int32_t(h.byte_lo);
    row[1] = int32_t(h.rem);
    row[2] = int32_t(h.nsym);
    row[3] = int32_t(h.out_base);
    row[4] = hp.table_log;
    std::memcpy(row + H_RANK_START, hp.rank_start + 1, 12 * sizeof(int32_t));
    std::memcpy(row + H_CUM_SYMS, hp.cum, 12 * sizeof(int32_t));
    std::memcpy(h_perm + i * 256, hp.perm, 256);
  }
  for (size_t i = 0; i < p.ss.size(); i++) {
    const SStream& s = p.ss[i];
    const SeqTable &ll = p.tables[s.ll], &of = p.tables[s.of], &ml = p.tables[s.ml];
    int32_t* row = s_params + i * S_WORDS;
    int64_t v[S_WORDS] = {s.byte_lo, s.rem, s.nseq, s.out_base, s.ll_state, s.of_state,
                          s.ml_state, ll.log | (of.log << 8) | (ml.log << 16)};
    for (int k = 0; k < S_WORDS; k++) row[k] = int32_t(v[k]);
    int32_t* tab = s_tabs + i * S_TABLE;
    std::memcpy(tab, ll.entries.data(), 512 * sizeof(int32_t));
    std::memcpy(tab + 512, of.entries.data(), 256 * sizeof(int32_t));
    std::memcpy(tab + 768, ml.entries.data(), 512 * sizeof(int32_t));
  }
  std::memcpy(blocks, p.blocks.data(), p.blocks.size() * sizeof(int32_t));
  for (size_t f = 0; f < p.frames.size(); f++) {
    const FrameRec& fr = p.frames[f];
    s_frames[2 * f] = int32_t(fr.first_s);
    s_frames[2 * f + 1] = int32_t(fr.n_s);
    b_frames[2 * f] = int32_t(fr.first_block);
    b_frames[2 * f + 1] = int32_t(fr.n_blocks);
    for (int64_t k = 0; k < fr.n_h; k++) h_frame[fr.first_h + k] = int64_t(f);
    for (int64_t k = 0; k < fr.n_s; k++) s_frame[fr.first_s + k] = int64_t(f);
    content_size[f] = fr.content_size;
    checksum[f] = fr.checksum;
  }
}

void acx_zstd_decode_plan_free(void* handle) { delete static_cast<Plan*>(handle); }

}  // extern "C"
