// zstd compress planner for the card's emission kernel.
//
// The C++ counterpart of device_enc.py over a whole batch: the check of the
// matcher's proposals (_verify_proposals), the plan of each chunk from its
// proposals (_extract_literals, _plan_chunk: the repeat-offset codes, the
// Huffman code of the literals and the three sequence fields' modes and
// FSE tables), the emission kernel's input rows (pack_plans) and the frames
// from the kernel's streams (_assemble). It ports what those call:
// frame_enc._apply_repcodes, _write_frame_header and _block_header; the
// seq_enc codes, count header, field costs and mode choice; fse_enc's
// table log, normalisation, encode table, table description and
// two-state stream; huff_enc's package-merge code lengths, canonical codes,
// size estimate and table description. The Python functions stay as the
// reference, and every plan, row and frame here equals theirs.
//
// Two things the Python planner takes from numpy come from the caller:
// - log2 of the normalised counts in the field costs (numpy's log2 may
//   differ from the C library's in the last bit), as a table;
// - the order of fse_enc.normalize_counts' correction, np.argsort(-norm),
//   whose default sort does not keep equal keys in order, and orders them
//   by the numpy build and the CPU's vector units. Where equal counts meet
//   at the symbol the correction stops on, the planner asks the caller for
//   numpy's order; elsewhere every order gives the same counts.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <new>
#include <string>
#include <vector>

namespace {

constexpr int64_t LIT_CAP = 65536, S_CAP = 8192, NS_CAP = 512, SYM_CAP = 64;
constexpr int64_t LSTREAM_CAP = 24576, SSTREAM_CAP = 98304;
constexpr int MAX_CODE_LENGTH = 11;
constexpr uint32_t MAGIC = 0xFD2FB528u;
constexpr int COMPRESSED_BLOCK = 2, COMPRESSED_LITERALS = 2;
constexpr int SEQ_PREDEFINED = 0, SEQ_RLE = 1, SEQ_FSE = 2;

// reasons a chunk is not planned for the card, as device_enc._Plan.reason
enum Reason { DEVICE = 0, SIZE, NSEQ, SMALL_LITERALS, LITERAL_SHAPE, INCOMPRESSIBLE };

constexpr int64_t LL_BASE[36] = {0,    1,    2,    3,    4,    5,     6,     7,     8,
                                 9,    10,   11,   12,   13,   14,    15,    16,    18,
                                 20,   22,   24,   28,   32,   40,    48,    64,    128,
                                 256,  512,  1024, 2048, 4096, 8192,  16384, 32768, 65536};
constexpr int64_t LL_BITS[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,  0,  0,  0,  1,  1,
                                 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
constexpr int64_t ML_BASE[53] = {3,   4,   5,    6,    7,    8,    9,     10,    11,   12,  13,
                                 14,  15,  16,   17,   18,   19,   20,    21,    22,   23,  24,
                                 25,  26,  27,   28,   29,   30,   31,    32,    33,   34,  35,
                                 37,  39,  41,   43,   47,   51,   59,    67,    83,   99,  131,
                                 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
constexpr int64_t ML_BITS[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,  0,
                                 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1,  1,  1,  1,
                                 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
constexpr int64_t LL_DEFAULT_NORM[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2,
                                         2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2,
                                         2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
constexpr int64_t ML_DEFAULT_NORM[53] = {
    1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1,  1,  1,  1,  1,  1,  1,  1,  1,  1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
constexpr int64_t OF_DEFAULT_NORM[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                                         1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

// A ValueError, RuntimeError or AssertionError of the Python planner, with
// its text.
struct PlanError {
  int kind;  // 1 ValueError, 2 RuntimeError, 3 AssertionError
  std::string msg;
};
constexpr int VALUE_ERROR = 1, RUNTIME_ERROR = 2, ASSERTION_ERROR = 3;

[[noreturn]] void fail(int kind, std::string msg) { throw PlanError{kind, std::move(msg)}; }

int bit_length(uint64_t v) { return v ? 64 - __builtin_clzll(v) : 0; }

typedef int (*order_fn)(const int64_t* keys, int64_t n, int64_t* order);

// What the planner takes from numpy (see the head of the file).
struct Numpy {
  const double* log2;  // log2 of 0.5, 1e-9, 1, 2, ..., 512: [norm + 1] for norm -1..512
  order_fn argsort;
};

// ---------------------------------------------------------------- bit writers
struct ForwardBitWriter {  // fse_enc._ForwardBitWriter
  uint64_t acc = 0;
  int nbits = 0;
  std::vector<uint8_t> out;
  void add(uint64_t value, int n) {
    acc |= (value & ((uint64_t(1) << n) - 1)) << nbits;
    nbits += n;
    while (nbits >= 8) {
      out.push_back(uint8_t(acc));
      acc >>= 8;
      nbits -= 8;
    }
  }
  std::vector<uint8_t> close() {
    if (nbits) out.push_back(uint8_t(acc));
    return out;
  }
};

struct BackwardBitWriter {  // bits.BackwardBitWriter
  uint64_t acc = 0;
  int nbits = 0;
  std::vector<uint8_t> out;
  void add(uint64_t value, int n) {
    if (!n) return;
    acc |= (value & ((uint64_t(1) << n) - 1)) << nbits;
    nbits += n;
    while (nbits >= 8) {
      out.push_back(uint8_t(acc));
      acc >>= 8;
      nbits -= 8;
    }
  }
  std::vector<uint8_t> close() {
    acc |= uint64_t(1) << nbits;
    nbits += 1;
    while (nbits > 0) {
      out.push_back(uint8_t(acc));
      acc >>= 8;
      nbits -= 8;
    }
    return out;
  }
};

// --------------------------------------------------------------------- FSE
struct CTable {  // fse_enc.FseCTable
  int log = 0;
  std::vector<int64_t> next_state, delta_nb_bits, delta_find_state;
};

// fse_enc.optimal_table_log
int optimal_table_log(int max_log, int64_t total, int64_t max_symbol) {
  int log = total > 1 ? bit_length(uint64_t(total - 1)) - 2 : 5;
  int min_bits = max_symbol > 0 ? bit_length(uint64_t(max_symbol)) + 1 : 5;
  log = std::max(log, min_bits - 1);
  return std::max(5, std::min(max_log, log));
}

// fse_enc.normalize_counts
std::vector<int64_t> normalize_counts(const std::vector<int64_t>& counts, int log, int64_t total,
                                      const Numpy& np) {
  int64_t size = int64_t(1) << log;
  int64_t n = int64_t(counts.size());
  if (total <= 0) fail(VALUE_ERROR, "empty input");
  std::vector<int64_t> norm(n, 0);
  for (int64_t s = 0; s < n; s++) {
    int64_t c = counts[s];
    if (c > 0 && c * size < total) norm[s] = -1;
    if (c * size >= total) {
      // numpy: (count as float64 * size / total).round(), halves to even
      double v = std::nearbyint(double(c) * double(size) / double(total));
      norm[s] = std::max<int64_t>(int64_t(v), 1);
    }
  }
  int64_t used = 0;
  for (int64_t v : norm) used += v == -1 ? 1 : v;
  int64_t delta = size - used;
  if (delta == 0) return norm;

  // np.argsort(-norm): its order among equal counts matters only where
  // the correction stops inside a run of them
  std::vector<int64_t> order(n);
  for (int64_t i = 0; i < n; i++) order[i] = i;
  std::stable_sort(order.begin(), order.end(),
                   [&](int64_t a, int64_t b) { return norm[a] > norm[b]; });
  int64_t stop = -1;  // the position the correction stops at
  if (delta > 0) {
    if (norm[order[0]] >= 1) stop = 0;
  } else {
    int64_t d = delta;
    for (int64_t i = 0; i < n && d != 0; i++) {
      int64_t take = std::min(-d, norm[order[i]] - 1);
      if (take > 0) d += take;
      if (d == 0) stop = i;
    }
  }
  if (stop >= 0) {
    int64_t v = norm[order[stop]], equal = 0;
    for (int64_t x : norm) equal += x == v;
    if (equal > 1) {
      std::vector<int64_t> keys(n);
      for (int64_t i = 0; i < n; i++) keys[i] = -norm[i];
      if (np.argsort(keys.data(), n, order.data()) != 0)
        fail(RUNTIME_ERROR, "the numpy order callback failed");
    }
  }
  int64_t i = 0;
  while (delta != 0) {
    int64_t s = order[i % n];
    if (norm[s] < 1) {
      i += 1;
      if (i > 4 * n) fail(VALUE_ERROR, "cannot normalize counts");
      continue;
    }
    if (delta > 0) {
      norm[s] += delta;
      delta = 0;
    } else {
      int64_t take = std::min(-delta, norm[s] - 1);
      norm[s] -= take;
      delta += take;
      i += 1;
      if (take == 0 && i > 4 * n) fail(VALUE_ERROR, "cannot normalize counts");
    }
  }
  return norm;
}

// fse_enc.build_ctable
CTable build_ctable(const std::vector<int64_t>& norm, int log) {
  int64_t size = int64_t(1) << log;
  int64_t n = int64_t(norm.size());
  std::vector<int64_t> spread(size, 0);
  int64_t high = size - 1;
  for (int64_t s = 0; s < n; s++)
    if (norm[s] == -1) spread[high--] = s;
  int64_t step = (size >> 1) + (size >> 3) + 3, msk = size - 1, pos = 0;
  for (int64_t s = 0; s < n; s++)
    for (int64_t k = 0; k < norm[s]; k++) {
      spread[pos] = s;
      pos = (pos + step) & msk;
      while (pos > high) pos = (pos + step) & msk;
    }
  if (pos != 0) fail(ASSERTION_ERROR, "FSE spread did not return to zero");
  std::vector<int64_t> fill(n + 1, 0);
  for (int64_t s = 0; s < n; s++)
    fill[s + 1] = fill[s] + (norm[s] == -1 ? 1 : std::max<int64_t>(norm[s], 0));
  CTable ct;
  ct.log = log;
  ct.next_state.assign(size, 0);
  for (int64_t u = 0; u < size; u++) ct.next_state[fill[spread[u]]++] = size + u;
  ct.delta_nb_bits.assign(n, 0);
  ct.delta_find_state.assign(n, 0);
  int64_t total = 0;
  for (int64_t s = 0; s < n; s++) {
    int64_t c = norm[s];
    if (c == 0) {
      ct.delta_nb_bits[s] = ((int64_t(log) + 1) << 16) - size;
      ct.delta_find_state[s] = total;
    } else if (c == -1 || c == 1) {
      ct.delta_nb_bits[s] = (int64_t(log) << 16) - size;
      ct.delta_find_state[s] = total - 1;
      total += 1;
    } else {
      int64_t max_bits_out = log - (bit_length(uint64_t(c - 1)) - 1);
      ct.delta_nb_bits[s] = (max_bits_out << 16) - (c << max_bits_out);
      ct.delta_find_state[s] = total - c;
      total += c;
    }
  }
  return ct;
}

// fse_enc.write_normalized_counts
std::vector<uint8_t> write_normalized_counts(const std::vector<int64_t>& norm, int log) {
  int64_t size = int64_t(1) << log;
  ForwardBitWriter out;
  out.add(log - 5, 4);
  int64_t remaining = size + 1, threshold = size, s = 0, n = int64_t(norm.size());
  int nb_bits = log + 1;
  bool previous_zero = false;
  while (remaining > 1 && s < n) {
    if (previous_zero) {
      int64_t start = s;
      while (s < n && norm[s] == 0) s++;
      int64_t run = s - start;
      for (; run >= 24; run -= 24) out.add(0xFFFF, 16);
      for (; run >= 3; run -= 3) out.add(3, 2);
      out.add(uint64_t(run), 2);
      previous_zero = false;
      continue;
    }
    int64_t c = norm[s++];
    int64_t max_v = 2 * threshold - 1 - remaining;
    remaining -= c < 0 ? 1 : c;
    int64_t v = c + 1;
    if (v >= threshold) v += max_v;
    out.add(uint64_t(v), v < max_v ? nb_bits - 1 : nb_bits);
    previous_zero = c == 0;
    while (remaining < threshold) {
      if (threshold == 0) fail(VALUE_ERROR, "normalized counts do not sum to table size");
      nb_bits -= 1;
      threshold >>= 1;
    }
  }
  if (remaining != 1) fail(VALUE_ERROR, "normalized counts do not sum to table size");
  return out.close();
}

// fse_enc.FseEncoder
struct FseEncoder {
  const CTable& ct;
  int64_t state = 0;
  void init_state(int64_t sym) {
    int64_t dnb = ct.delta_nb_bits[sym];
    int64_t nb = (dnb + (1 << 15)) >> 16;
    int64_t sub = ((nb << 16) - dnb) >> nb;
    state = ct.next_state[sub + ct.delta_find_state[sym]];
  }
  void encode(BackwardBitWriter& w, int64_t sym) {
    int64_t nb = (state + ct.delta_nb_bits[sym]) >> 16;
    w.add(uint64_t(state), int(nb));
    state = ct.next_state[(state >> nb) + ct.delta_find_state[sym]];
  }
  void flush(BackwardBitWriter& w) { w.add(uint64_t(state), ct.log); }
};

// fse_enc.compress_interleaved2
std::vector<uint8_t> compress_interleaved2(const std::vector<int64_t>& symbols,
                                           const CTable& ct) {
  int64_t n = int64_t(symbols.size());
  BackwardBitWriter w;
  FseEncoder a{ct}, b{ct};
  if (n % 2 == 0) {
    b.init_state(symbols[n - 1]);
    a.init_state(symbols[n - 2]);
  } else {
    a.init_state(symbols[n - 1]);
    b.init_state(symbols[n - 2]);
  }
  for (int64_t i = n - 3; i >= 0; i--) (i % 2 == 0 ? a : b).encode(w, symbols[i]);
  b.flush(w);
  a.flush(w);
  return w.close();
}

// ----------------------------------------------------------------- Huffman
struct HuffCTable {  // huff_enc.HuffmanCTable
  int log = 0;
  int64_t nbits[256] = {0}, codes[256] = {0};
};

// huff_enc.package_merge_lengths. The merged list of each level is the
// leaves, sorted by (count, symbol), followed by the previous level's
// packages, stably sorted by weight; the lengths count how often each leaf
// lies in the first 2(k - 1) items of the last list, packages unfolded.
void package_merge_lengths(const int64_t* counts, int max_len, int64_t* lengths) {
  struct Item {
    int64_t weight;
    int64_t leaf;     // symbol, or -1 for a package
    int64_t package;  // its index among the previous level's packages
  };
  std::vector<std::pair<int64_t, int64_t>> leaves;
  for (int s = 0; s < 256; s++)
    if (counts[s]) leaves.emplace_back(counts[s], s);
  int64_t k = int64_t(leaves.size());
  if (k > (int64_t(1) << max_len)) fail(VALUE_ERROR, "too many symbols for depth limit");
  std::sort(leaves.begin(), leaves.end());
  std::vector<std::vector<Item>> levels;  // the merged list of each level, the last one too
  std::vector<int64_t> packages;          // the weights of the previous level's packages
  for (int level = 0; level <= max_len; level++) {
    std::vector<Item> items;
    for (auto& l : leaves) items.push_back(Item{l.first, l.second, -1});
    for (size_t j = 0; j < packages.size(); j++)
      items.push_back(Item{packages[j], -1, int64_t(j)});
    std::stable_sort(items.begin(), items.end(),
                     [](const Item& a, const Item& b) { return a.weight < b.weight; });
    packages.clear();
    for (size_t i = 0; i + 1 < items.size(); i += 2)
      packages.push_back(items[i].weight + items[i + 1].weight);
    levels.push_back(std::move(items));
  }
  std::fill(lengths, lengths + 256, 0);
  std::vector<int64_t> take(levels.back().size(), 0);
  for (int64_t i = 0; i < std::min<int64_t>(2 * (k - 1), int64_t(take.size())); i++) take[i] = 1;
  for (int level = max_len; level >= 0; level--) {
    const std::vector<Item>& items = levels[level];
    std::vector<int64_t> below(level > 0 ? levels[level - 1].size() : 0, 0);
    for (size_t i = 0; i < items.size(); i++) {
      if (!take[i]) continue;
      if (items[i].leaf >= 0) {
        lengths[items[i].leaf] += take[i];
      } else {
        below[2 * items[i].package] += take[i];
        below[2 * items[i].package + 1] += take[i];
      }
    }
    take = std::move(below);
  }
}

// huff_enc.build_ctable
HuffCTable build_huffman(const int64_t* counts) {
  HuffCTable ct;
  package_merge_lengths(counts, MAX_CODE_LENGTH, ct.nbits);
  for (int s = 0; s < 256; s++) ct.log = std::max<int>(ct.log, int(ct.nbits[s]));
  int64_t pos = 0;
  for (int w = 1; w <= ct.log; w++)
    for (int s = 0; s < 256; s++)
      if (ct.nbits[s] > 0 && ct.log + 1 - ct.nbits[s] == w) {
        ct.codes[s] = pos >> (w - 1);
        pos += int64_t(1) << (w - 1);
      }
  if (pos != int64_t(1) << ct.log) fail(ASSERTION_ERROR, "Huffman code lengths not complete");
  return ct;
}

// huff_enc.write_table. A ValueError that write_table raises is kept in
// *error (raised by the frame assembly, where write_table runs in Python).
std::vector<uint8_t> write_huffman_table(const HuffCTable& ct, const Numpy& np,
                                         std::string* error) {
  int last = 255;
  while (ct.nbits[last] == 0) last--;
  std::vector<int64_t> w(last);  // the last present symbol's weight is implicit
  int64_t max_w = 0;
  for (int s = 0; s < last; s++) {
    w[s] = ct.nbits[s] > 0 ? ct.log + 1 - ct.nbits[s] : 0;
    max_w = std::max(max_w, w[s]);
  }
  int64_t n = int64_t(w.size()), raw_size = (n + 1) / 2;
  std::vector<int64_t> counts(std::max<int64_t>(max_w + 1, 2), 0);
  for (int64_t v : w) counts[v]++;
  int64_t distinct = 0;
  for (int64_t c : counts) distinct += c > 0;
  counts.resize(max_w + 1);
  if (n >= 2 && distinct >= 2) {
    int log = optimal_table_log(6, n, int64_t(counts.size()) - 1);
    try {
      std::vector<int64_t> norm = normalize_counts(counts, log, n, np);
      CTable fct = build_ctable(norm, log);
      std::vector<uint8_t> desc = write_normalized_counts(norm, log);
      std::vector<uint8_t> payload = compress_interleaved2(w, fct);
      if (int64_t(desc.size() + payload.size()) < std::min<int64_t>(raw_size, 128)) {
        std::vector<uint8_t> out{uint8_t(desc.size() + payload.size())};
        out.insert(out.end(), desc.begin(), desc.end());
        out.insert(out.end(), payload.begin(), payload.end());
        return out;
      }
    } catch (const PlanError& e) {
      if (e.kind != VALUE_ERROR) throw;
    }
  }
  if (n > 128) {
    *error = "cannot serialize >128 weights raw";
    return {};
  }
  std::vector<uint8_t> out{uint8_t(127 + n)};
  for (int64_t i = 0; i + 1 < n; i += 2) out.push_back(uint8_t((w[i] << 4) | w[i + 1]));
  if (n % 2) out.push_back(uint8_t(w[n - 1] << 4));
  return out;
}

// --------------------------------------------------------------- sequences
int64_t ll_code(int64_t v) { return std::upper_bound(LL_BASE, LL_BASE + 36, v) - LL_BASE - 1; }
int64_t ml_code(int64_t v) { return std::upper_bound(ML_BASE, ML_BASE + 53, v) - ML_BASE - 1; }
int64_t of_code(int64_t v) { return bit_length(uint64_t(v)) - 1; }

// seq_enc._field_cost_bits: numpy's np.sum, pairwise with 8 accumulators
// (every array here has fewer than 128 terms).
double pairwise_sum(const std::vector<double>& a) {
  size_t n = a.size();
  if (n < 8) {
    double res = -0.0;
    for (double x : a) res += x;
    return res;
  }
  double r[8];
  for (int j = 0; j < 8; j++) r[j] = a[j];
  size_t i = 8;
  for (; i < n - (n % 8); i += 8)
    for (int j = 0; j < 8; j++) r[j] += a[i + j];
  double res = ((r[0] + r[1]) + (r[2] + r[3])) + ((r[4] + r[5]) + (r[6] + r[7]));
  for (; i < n; i++) res += a[i];
  return res;
}

double field_cost_bits(const std::vector<int64_t>& counts, const std::vector<int64_t>& norm,
                       int log, const Numpy& np) {
  std::vector<double> terms;
  for (size_t s = 0; s < std::min(norm.size(), counts.size()); s++)
    if (counts[s] > 0) {
      int64_t v = std::max<int64_t>(norm[s], -1);
      if (v > 512) fail(RUNTIME_ERROR, "normalized count beyond the log2 table");
      terms.push_back(double(counts[s]) * (double(log) - np.log2[v + 1]));
    }
  return pairwise_sum(terms);
}

struct Field {  // seq_enc._Field
  int mode = SEQ_PREDEFINED;
  CTable ct;
  std::vector<uint8_t> desc;
};

std::vector<int64_t> rle_norm(int64_t symbol) {
  std::vector<int64_t> n(symbol + 1, 0);
  n[symbol] = 1;
  return n;
}

// seq_enc._select_field for the one block of a fresh frame (no table to
// repeat)
Field select_field(const std::vector<int64_t>& codes, int max_symbol, int max_log,
                   const int64_t* default_norm, int default_size, int default_log,
                   const Numpy& np) {
  int64_t top = max_symbol;
  for (int64_t c : codes) top = std::max(top, c);
  std::vector<int64_t> counts(top + 1, 0);
  for (int64_t c : codes) counts[c]++;
  int64_t n_present = 0, last = -1, total = 0;
  for (int64_t s = 0; s <= top; s++)
    if (counts[s]) {
      n_present++;
      last = s;
      total += counts[s];
    }
  Field f;
  if (n_present == 1) {
    f.mode = SEQ_RLE;
    f.ct = build_ctable(rle_norm(last), 0);
    f.desc = {uint8_t(last)};
    return f;
  }
  bool predefined = last < default_size;
  double pre_cost = 0;
  std::vector<int64_t> pre_norm(default_norm, default_norm + default_size);
  if (predefined) pre_cost = field_cost_bits(counts, pre_norm, default_log, np);
  int log = optimal_table_log(max_log, total, last);
  std::vector<int64_t> head(counts.begin(), counts.begin() + last + 1);
  std::vector<int64_t> norm = normalize_counts(head, log, total, np);
  std::vector<uint8_t> desc = write_normalized_counts(norm, log);
  double fse_cost = field_cost_bits(counts, norm, log, np) + double(8 * int64_t(desc.size()));
  if (predefined && !(fse_cost < pre_cost)) {
    f.mode = SEQ_PREDEFINED;
    f.ct = build_ctable(pre_norm, default_log);
  } else {
    f.mode = SEQ_FSE;
    f.ct = build_ctable(norm, log);
    f.desc = std::move(desc);
  }
  return f;
}

// frame_enc._apply_repcodes for a fresh frame: wire offsets from the
// offsets + 3
std::vector<int64_t> apply_repcodes(const int64_t* ll, const int64_t* offsets, int64_t m) {
  int64_t rep[3] = {1, 4, 8};
  std::vector<int64_t> out(m);
  for (int64_t i = 0; i < m; i++) {
    int64_t o = offsets[i];
    out[i] = o + 3;
    if (ll[i] > 0) {
      if (o == rep[0]) {
        out[i] = 1;
        continue;
      }
      if (o == rep[1]) {
        out[i] = 2;
        std::swap(rep[0], rep[1]);
        continue;
      }
      if (o == rep[2]) {
        out[i] = 3;
        int64_t r2 = rep[2];
        rep[2] = rep[1];
        rep[1] = rep[0];
        rep[0] = r2;
        continue;
      }
    } else {
      if (o == rep[1]) {
        out[i] = 1;
        std::swap(rep[0], rep[1]);
        continue;
      }
      if (o == rep[2]) {
        out[i] = 2;
        int64_t r2 = rep[2];
        rep[2] = rep[1];
        rep[1] = rep[0];
        rep[0] = r2;
        continue;
      }
      if (o == rep[0] - 1 && o > 0) {
        out[i] = 3;
        rep[2] = rep[1];
        rep[1] = rep[0];
        rep[0] = o;
        continue;
      }
    }
    rep[2] = rep[1];
    rep[1] = rep[0];
    rep[0] = o;
  }
  return out;
}

// ------------------------------------------------------------- the plans
struct ChunkPlan {
  int reason = SIZE;
  int64_t n = 0;
  std::vector<uint8_t> literals;
  std::vector<int64_t> ll, ofw, ml;
  HuffCTable huff;
  Field fields[3];  // LL, OF, ML
  std::vector<uint8_t> table;  // huff_enc.write_table's bytes
  std::string table_error;     // or the ValueError it raises
};

struct Plans {
  std::vector<ChunkPlan> chunks;
  std::vector<int64_t> rows;  // the chunks planned for the card, in order
};

// device_enc._plan_chunk from the chunk's proposals
void plan_chunk(ChunkPlan& p, const uint8_t* data, int64_t n, const int64_t* ll,
                const int64_t* offsets, const int64_t* ml, int64_t m, const Numpy& np) {
  p.n = n;
  if (n == 0 || n > LIT_CAP) {
    p.reason = SIZE;
    return;
  }
  if (m == 0 || m > S_CAP) {
    p.reason = NSEQ;
    return;
  }
  // device_enc._extract_literals: the bytes no match covers
  int64_t pos = 0;
  for (int64_t i = 0; i < m; i++) {
    if (ll[i] < 0 || ml[i] < 0 || pos + ll[i] + ml[i] > n)
      fail(VALUE_ERROR, "the proposals do not cover the chunk");
    p.literals.insert(p.literals.end(), data + pos, data + pos + ll[i]);
    pos += ll[i] + ml[i];
  }
  p.literals.insert(p.literals.end(), data + pos, data + n);
  int64_t n_lit = int64_t(p.literals.size());
  if (n_lit < 256) {
    p.reason = SMALL_LITERALS;
    return;
  }
  int64_t counts[256] = {0};
  for (uint8_t b : p.literals) counts[b]++;
  int present = 0;
  for (int s = 0; s < 256; s++) present += counts[s] > 0;
  if (present < 2) {
    p.reason = LITERAL_SHAPE;
    return;
  }
  p.huff = build_huffman(counts);
  int64_t est = 0;
  for (int s = 0; s < 256; s++) est += counts[s] * p.huff.nbits[s];
  if (est / 8 + 16 >= n_lit) {
    p.reason = INCOMPRESSIBLE;
    return;
  }
  p.ll.assign(ll, ll + m);
  p.ml.assign(ml, ml + m);
  p.ofw = apply_repcodes(ll, offsets, m);
  std::vector<int64_t> llc(m), mlc(m), ofc(m);
  for (int64_t i = 0; i < m; i++) {
    llc[i] = ll_code(ll[i]);
    mlc[i] = ml_code(ml[i]);
    ofc[i] = of_code(p.ofw[i]);
  }
  p.fields[0] = select_field(llc, 35, 9, LL_DEFAULT_NORM, 36, 6, np);
  p.fields[1] = select_field(ofc, 31, 8, OF_DEFAULT_NORM, 29, 5, np);
  p.fields[2] = select_field(mlc, 52, 9, ML_DEFAULT_NORM, 53, 6, np);
  p.table = write_huffman_table(p.huff, np, &p.table_error);
  p.reason = DEVICE;
}

// device_enc._pack_field into one row of fse_sym (2, SYM_CAP) and fse_ns
void pack_field(const CTable& ct, int32_t* sym, int32_t* ns) {
  int64_t k = std::min<int64_t>(int64_t(ct.delta_nb_bits.size()), SYM_CAP);
  for (int64_t i = 0; i < k; i++) {
    sym[i] = int32_t(ct.delta_nb_bits[i]);
    sym[SYM_CAP + i] = int32_t(ct.delta_find_state[i]);
  }
  k = std::min<int64_t>(int64_t(ct.next_state.size()), NS_CAP);
  for (int64_t i = 0; i < k; i++) ns[i] = int32_t(ct.next_state[i]);
}

// seq_enc._write_count_header
void write_count_header(std::vector<uint8_t>& out, int64_t n) {
  if (n < 128) {
    out.push_back(uint8_t(n));
  } else if (n < 0x7F00) {
    out.push_back(uint8_t(128 + (n >> 8)));
    out.push_back(uint8_t(n & 0xFF));
  } else {
    int64_t rest = n - 0x7F00;
    out.push_back(255);
    out.push_back(uint8_t(rest & 0xFF));
    out.push_back(uint8_t((rest >> 8) & 0xFF));
  }
}

void put_le(std::vector<uint8_t>& out, uint64_t v, int n) {
  for (int k = 0; k < n; k++) out.push_back(uint8_t(v >> (8 * k)));
}

// frame_enc._write_frame_header
void write_frame_header(std::vector<uint8_t>& out, int64_t content_size) {
  if (content_size < 256) {
    out.push_back(0x20 | 0x04);
    out.push_back(uint8_t(content_size));
  } else if (content_size < 65536 + 256) {
    out.push_back((1 << 6) | 0x20 | 0x04);
    put_le(out, uint64_t(content_size - 256), 2);
  } else if (content_size < (int64_t(1) << 32)) {
    out.push_back((2 << 6) | 0x20 | 0x04);
    put_le(out, uint64_t(content_size), 4);
  } else {
    out.push_back((3 << 6) | 0x20 | 0x04);
    put_le(out, uint64_t(content_size), 8);
  }
}

// device_enc._assemble: the frame, or nothing where the block would not
// gain
std::vector<uint8_t> assemble(const ChunkPlan& p, const uint8_t* lit_by, const int32_t* lit_tot,
                              const uint8_t* seq_by, int64_t seq_tot, int64_t checksum) {
  int64_t lens[4];
  std::vector<uint8_t> payload;
  for (int s = 0; s < 4; s++) lens[s] = (int64_t(lit_tot[s]) + 1 + 7) >> 3;
  for (int s = 0; s < 3; s++) put_le(payload, uint64_t(lens[s]), 2);
  for (int s = 0; s < 4; s++)  // numpy's slice stops at the row's end
    payload.insert(payload.end(), lit_by + s * LSTREAM_CAP,
                   lit_by + s * LSTREAM_CAP + std::min(lens[s], LSTREAM_CAP));
  int64_t comp = int64_t(p.table.size() + payload.size());
  int64_t regen = int64_t(p.literals.size());
  for (int s = 0; s < 3; s++)
    if (lens[s] > 0xFFFF) return {};
  int header_len, size_format;
  if (regen < (1 << 10) && comp < (1 << 10)) {
    header_len = 3;
    size_format = 1;
  } else if (regen < (1 << 14) && comp < (1 << 14)) {
    header_len = 4;
    size_format = 2;
  } else if (regen < (1 << 18) && comp < (1 << 18)) {
    header_len = 5;
    size_format = 3;
  } else {
    return {};
  }
  int64_t raw_len = regen + (regen <= 31 ? 1 : regen <= 4095 ? 2 : 3);
  if (header_len + comp >= raw_len) return {};
  std::vector<uint8_t> body;
  uint8_t b0 = uint8_t(COMPRESSED_LITERALS | (size_format << 2) | ((regen & 0xF) << 4));
  if (header_len == 3) {
    body = {b0, uint8_t(((regen >> 4) & 0x3F) | ((comp & 3) << 6)), uint8_t(comp >> 2)};
  } else if (header_len == 4) {
    body = {b0, uint8_t((regen >> 4) & 0xFF), uint8_t(((regen >> 12) & 3) | ((comp & 0x3F) << 2)),
            uint8_t(comp >> 6)};
  } else {
    body = {b0, uint8_t((regen >> 4) & 0xFF), uint8_t(((regen >> 12) & 0x3F) | ((comp & 3) << 6)),
            uint8_t((comp >> 2) & 0xFF), uint8_t(comp >> 10)};
  }
  body.insert(body.end(), p.table.begin(), p.table.end());
  body.insert(body.end(), payload.begin(), payload.end());
  write_count_header(body, int64_t(p.ll.size()));
  body.push_back(uint8_t((p.fields[0].mode << 6) | (p.fields[1].mode << 4) |
                         (p.fields[2].mode << 2)));
  for (const Field& f : p.fields) body.insert(body.end(), f.desc.begin(), f.desc.end());
  int64_t nbytes = std::min<int64_t>((seq_tot + 1 + 7) >> 3, SSTREAM_CAP);
  body.insert(body.end(), seq_by, seq_by + nbytes);
  if (int64_t(body.size()) >= p.n) return {};
  std::vector<uint8_t> out;
  put_le(out, MAGIC, 4);
  write_frame_header(out, p.n);
  put_le(out, uint64_t(1 | (COMPRESSED_BLOCK << 1) | (int64_t(body.size()) << 3)), 3);
  out.insert(out.end(), body.begin(), body.end());
  put_le(out, uint64_t(checksum) & 0xFFFFFFFFu, 4);
  return out;
}

void put_msg(const std::string& msg, char* buf, int64_t cap) {
  if (cap <= 0) return;
  size_t n = std::min(msg.size(), size_t(cap - 1));
  std::memcpy(buf, msg.data(), n);
  buf[n] = 0;
}

}  // namespace

extern "C" {

// device_enc._verify_proposals over a batch: chunk i is data[data_off[i],
// data_off[i + 1]) with proposals [seq_off[i], seq_off[i + 1]) of ll, ml
// and of and last[i] trailing literals; check[i] says whether to check it.
// Returns the first checked chunk whose proposals are unsound, or -1.
int64_t acx_zstd_verify_proposals(const uint8_t* data, const int64_t* data_off,
                                  const int64_t* ll, const int64_t* ml, const int64_t* of,
                                  const int64_t* seq_off, const int64_t* last,
                                  const uint8_t* check, int64_t n_chunks, int64_t min_match) {
  for (int64_t c = 0; c < n_chunks; c++) {
    if (!check[c]) continue;
    const uint8_t* d = data + data_off[c];
    int64_t n = data_off[c + 1] - data_off[c], lo = seq_off[c], hi = seq_off[c + 1];
    bool ok = true;
    int64_t covered = last[c];
    for (int64_t i = lo; i < hi && ok; i++) {
      ok = ll[i] >= 0 && ml[i] >= min_match && of[i] > 0;
      covered += ll[i] + ml[i];
    }
    ok = ok && covered == n;
    int64_t pos = 0;
    for (int64_t i = lo; i < hi && ok; i++) {
      int64_t at = pos + ll[i];
      ok = of[i] <= at && at + ml[i] <= n;
      for (int64_t j = at; ok && j < at + ml[i]; j++) ok = d[j] == d[j - of[i]];
      pos = at + ml[i];
    }
    if (!ok) return c;
  }
  return -1;
}

// Plan a batch: chunk i is data[data_off[i], data_off[i + 1]) with the
// proposals (lit lens, offsets, match lens) [seq_off[i], seq_off[i + 1]).
// log2 and argsort are what the planner takes from numpy (see the head of
// the file). Writes each chunk's reason (0: planned for the card) and
// returns a handle, or null with *err_kind (1 ValueError, 2 RuntimeError,
// 3 AssertionError), *err_chunk and msg.
void* acx_zstd_encode_plan(const uint8_t* data, const int64_t* data_off, const int64_t* ll,
                           const int64_t* of, const int64_t* ml, const int64_t* seq_off,
                           int64_t n_chunks, const double* log2, order_fn argsort,
                           int32_t* reason, int64_t* err_kind, int64_t* err_chunk, char* msg,
                           int64_t msg_cap) {
  Plans* plans = nullptr;
  int64_t c = -1;
  try {
    plans = new Plans();
    plans->chunks.resize(n_chunks);
    Numpy np{log2, argsort};
    for (c = 0; c < n_chunks; c++) {
      int64_t lo = seq_off[c];
      plan_chunk(plans->chunks[c], data + data_off[c], data_off[c + 1] - data_off[c], ll + lo,
                 of + lo, ml + lo, seq_off[c + 1] - lo, np);
      reason[c] = plans->chunks[c].reason;
      if (reason[c] == DEVICE) plans->rows.push_back(c);
    }
  } catch (const PlanError& e) {
    delete plans;
    *err_kind = e.kind;
    *err_chunk = c;
    put_msg(e.msg, msg, msg_cap);
    return nullptr;
  } catch (const std::bad_alloc&) {
    delete plans;
    *err_kind = RUNTIME_ERROR;
    *err_chunk = c;
    put_msg("out of memory", msg, msg_cap);
    return nullptr;
  }
  return plans;
}

// pack_plans: the emission kernel's input rows for the planned chunks, in
// order, into zero-filled arrays of that many rows (their shapes are in
// device_enc.pack_plans).
void acx_zstd_encode_pack(void* handle, uint8_t* lit, int32_t* lit_seg, int32_t* huff,
                          int32_t* seq, int32_t* nseq, int32_t* fse_sym, int32_t* fse_ns,
                          int32_t* flush_bits) {
  const Plans& plans = *static_cast<Plans*>(handle);
  for (size_t r = 0; r < plans.rows.size(); r++) {
    const ChunkPlan& p = plans.chunks[plans.rows[r]];
    int64_t n_lit = int64_t(p.literals.size()), seg = (n_lit + 3) / 4;
    std::memcpy(lit + r * LIT_CAP, p.literals.data(), n_lit);
    for (int s = 0; s < 4; s++) {
      int64_t st = s * seg;
      lit_seg[r * 8 + 2 * s] = int32_t(st);
      lit_seg[r * 8 + 2 * s + 1] = int32_t(std::max<int64_t>(0, std::min(seg, n_lit - st)));
    }
    for (int s = 0; s < 256; s++) {
      huff[r * 512 + s] = int32_t(p.huff.codes[s]);
      huff[r * 512 + 256 + s] = int32_t(p.huff.nbits[s]);
    }
    int64_t m = int64_t(p.ll.size());
    nseq[r] = int32_t(m);
    int32_t* q = seq + r * 9 * S_CAP;
    for (int64_t i = 0; i < m; i++) {
      int64_t llc = ll_code(p.ll[i]), mlc = ml_code(p.ml[i]), ofc = of_code(p.ofw[i]);
      int64_t v[9] = {llc,          mlc,          ofc, p.ll[i] - LL_BASE[llc],
                      p.ml[i] - ML_BASE[mlc], p.ofw[i] - (int64_t(1) << ofc), LL_BITS[llc],
                      ML_BITS[mlc], ofc};
      for (int k = 0; k < 9; k++) q[k * S_CAP + i] = int32_t(v[k]);
    }
    const Field* order[3] = {&p.fields[0], &p.fields[2], &p.fields[1]};  // LL, ML, OF
    for (int k = 0; k < 3; k++)
      pack_field(order[k]->ct, fse_sym + (r * 3 + k) * 2 * SYM_CAP, fse_ns + (r * 3 + k) * NS_CAP);
    flush_bits[r * 3] = p.fields[2].ct.log;
    flush_bits[r * 3 + 1] = p.fields[1].ct.log;
    flush_bits[r * 3 + 2] = p.fields[0].ct.log;
  }
}

// _assemble for every planned chunk, in order, from the emission's outputs
// (lit_bytes (R, 4, LSTREAM_CAP), lit_tot (R, 4), seq_bytes (R,
// SSTREAM_CAP), seq_tot (R,)) and each chunk's XXH64: row r's frame is
// out[out_off[r], out_off[r + 1]), empty where the block would not gain.
// out holds the chunks' sizes plus 32 bytes a row. Returns -1, or the first
// row whose Huffman table write_table cannot write (a ValueError, in msg).
int64_t acx_zstd_encode_assemble(void* handle, const uint8_t* lit_bytes, const int32_t* lit_tot,
                                 const uint8_t* seq_bytes, const int32_t* seq_tot,
                                 const int64_t* digest, uint8_t* out, int64_t* out_off, char* msg,
                                 int64_t msg_cap) {
  const Plans& plans = *static_cast<Plans*>(handle);
  out_off[0] = 0;
  for (size_t r = 0; r < plans.rows.size(); r++) {
    const ChunkPlan& p = plans.chunks[plans.rows[r]];
    if (!p.table_error.empty()) {
      put_msg(p.table_error, msg, msg_cap);
      return int64_t(r);
    }
    std::vector<uint8_t> frame =
        assemble(p, lit_bytes + r * 4 * LSTREAM_CAP, lit_tot + r * 4,
                 seq_bytes + r * SSTREAM_CAP, seq_tot[r], digest[r]);
    std::memcpy(out + out_off[r], frame.data(), frame.size());
    out_off[r + 1] = out_off[r] + int64_t(frame.size());
  }
  return -1;
}

// A chunk's Huffman table bytes and its fields' modes and descriptions,
// for tests: writes modes[3] and lens = {table, LL, OF, ML description}
// and the bytes one after another into buf (at least 512 bytes). Returns
// the chunk's reason.
int32_t acx_zstd_encode_detail(void* handle, int64_t chunk, int32_t* modes, int64_t* lens,
                               uint8_t* buf) {
  const ChunkPlan& p = static_cast<Plans*>(handle)->chunks[chunk];
  std::vector<uint8_t> all(p.table);
  lens[0] = int64_t(p.table.size());
  for (int k = 0; k < 3; k++) {
    modes[k] = p.fields[k].mode;
    lens[k + 1] = int64_t(p.fields[k].desc.size());
    all.insert(all.end(), p.fields[k].desc.begin(), p.fields[k].desc.end());
  }
  std::memcpy(buf, all.data(), all.size());
  return p.reason;
}

// seq_enc._field_cost_bits, for tests
double acx_zstd_field_cost(const int64_t* counts, int64_t n_counts, const int64_t* norm,
                           int64_t n_norm, int64_t log, const double* log2) {
  Numpy np{log2, nullptr};
  return field_cost_bits(std::vector<int64_t>(counts, counts + n_counts),
                         std::vector<int64_t>(norm, norm + n_norm), int(log), np);
}

void acx_zstd_encode_plan_free(void* handle) { delete static_cast<Plans*>(handle); }

}  // extern "C"
