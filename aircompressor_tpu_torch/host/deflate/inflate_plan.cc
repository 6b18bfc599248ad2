// Raw-deflate (RFC 1951) planner for the card's decode kernel.
//
// A copy of the planner of aircompressor_tpu/native/src/inflate.cc
// (build_table, plan_chunk, the batch entry, the bit reader and the RFC 1951
// tables). Deflate block boundaries are not length-prefixed: the end of a
// block is a Huffman-coded symbol, so finding block 2's header means decoding
// block 1's symbols. The planner walks each chunk's blocks, builds the
// two-level canonical Huffman tables in the kernel's entry encoding, records
// (type, data bit position, table bases, stored extent, final flag) for each
// block, and validates the stream; csrc/deflate_decode.cu then derives every
// output byte from the bitstream again.
//
// Entry encoding (int32, never negative):
//   e = (op << 28) | (nbits << 22) | val
//   op 0 INVALID, 1 LITERAL (val = byte), 2 LENGTH (val = extra << 9 | base),
//   3 DIST (val = extra << 16 | base), 4 END-OF-BLOCK,
//   5 SUBTABLE (val = entry index of the subtable, nbits = its index width).
// Root tables are 9-bit (512 entries); a longer code takes one subtable
// lookup, whose entries carry the code's whole length.
//
// What differs from the copied planner:
// - Incomplete code sets are rejected as zlib's inflate_table rejects them
//   (ROADMAP F3): a literal/length or distance code may be incomplete only
//   where it is a single code of length 1 (or has no codes at all), and the
//   code-length code must be complete. zlib raises on such a stream.
// - count[0] is zeroed before the first-code loops (ROADMAP F4); the tables
//   do not change, since bitrev() keeps only a code's own bits.
// - The caps are arguments: a chunk's descriptors (max_blocks x 8 fields)
//   and tables (tab_cap entries) are separate outputs, and the tables start
//   at entry 0 (the copied planner kept the descriptor row in entries
//   0..127 of the page). The planner builds into buffers of its own that
//   grow as needed, so a chunk that does not fit its caps is still walked to
//   its end; it is then reported as ST_ROOM with the blocks and entries it
//   needs, and the caller plans it again with caps that fit.
// - An output past out_cap is ST_TOO_LONG, not a fallback.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int ROOTB = 9;
constexpr int ROOTSZ = 1 << ROOTB;
constexpr int DESC_FIELDS = 8;
constexpr int OP_INVALID = 0, OP_LIT = 1, OP_LEN = 2, OP_DIST = 3,
              OP_EOB = 4, OP_SUB = 5;

constexpr uint16_t LBASE[29] = {3,  4,  5,  6,  7,  8,  9,  10, 11,  13,
                                15, 17, 19, 23, 27, 31, 35, 43, 51,  59,
                                67, 83, 99, 115, 131, 163, 195, 227, 258};
constexpr uint8_t LEXT[29] = {0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2,
                              2, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 0};
constexpr uint16_t DBASE[30] = {1,    2,    3,    4,    5,    7,    9,
                                13,   17,   25,   33,   49,   65,   97,
                                129,  193,  257,  385,  513,  769,  1025,
                                1537, 2049, 3073, 4097, 6145, 8193, 12289,
                                16385, 24577};
constexpr uint8_t DEXT[30] = {0, 0, 0,  0,  1,  1,  2,  2,  3,  3,
                              4, 4, 5,  5,  6,  6,  7,  7,  8,  8,
                              9, 9, 10, 10, 11, 11, 12, 12, 13, 13};
constexpr uint8_t CLPERM[19] = {16, 17, 18, 0, 8,  7, 9,  6, 10, 5,
                                11, 4,  12, 3, 13, 2, 14, 1, 15};

inline int32_t mk(int op, int nbits, int val) {
  return (op << 28) | (nbits << 22) | val;
}

inline uint32_t bitrev(uint32_t v, int n) {
  uint32_t r = 0;
  for (int i = 0; i < n; i++) { r = (r << 1) | (v & 1); v >>= 1; }
  return r;
}

struct BitReader {
  const uint8_t* p;
  size_t n;       // bytes
  size_t bitpos = 0;
  bool overrun = false;

  uint32_t peek(int k, size_t at) const {
    // LSB-first; zero-padded past the end (overrun is flagged on consume)
    size_t byte = at >> 3;
    uint64_t w = 0;
    for (int i = 0; i < 5; i++)
      w |= uint64_t(byte + i < n ? p[byte + i] : 0) << (8 * i);
    return uint32_t((w >> (at & 7)) & ((1u << k) - 1));
  }
  uint32_t bits(int k) {
    uint32_t v = peek(k, bitpos);
    bitpos += k;
    if (bitpos > n * 8) overrun = true;
    return v;
  }
};

// Map a decoded symbol to its entry (litlen or dist alphabet).
inline int32_t sym_entry(int sym, int len, bool litlen) {
  if (litlen) {
    if (sym < 256) return mk(OP_LIT, len, sym);
    if (sym == 256) return mk(OP_EOB, len, 0);
    if (sym <= 285)
      return mk(OP_LEN, len, (LEXT[sym - 257] << 9) | LBASE[sym - 257]);
    return mk(OP_INVALID, len, 0);  // 286/287: never valid in data
  }
  if (sym < 30) return mk(OP_DIST, len, (DEXT[sym] << 16) | DBASE[sym]);
  return mk(OP_INVALID, len, 0);  // 30/31: participate in the code only
}

// Build a two-level canonical table at the end of tab; returns the root
// base entry index, or -1 on an over-subscribed or incomplete code (zlib's
// rule: incomplete only as a single code of length 1, or no code at all).
// Missing patterns of an allowed incomplete code stay OP_INVALID and fail
// only if the stream uses them.
int build_table(const uint8_t* lens, int n, bool litlen,
                std::vector<int32_t>& tab) {
  int count[16] = {0};
  for (int s = 0; s < n; s++) count[lens[s]]++;
  count[0] = 0;  // F4: zero-length symbols have no code
  int left = 1, max_len = 0;
  for (int l = 1; l <= 15; l++) {
    left <<= 1;
    left -= count[l];
    if (left < 0) return -1;
    if (count[l]) max_len = l;
  }
  if (left > 0 && max_len > 1) return -1;  // F3: incomplete code set
  int base = int(tab.size());
  tab.resize(base + ROOTSZ, 0);
  if (max_len == 0) return base;  // no codes at all: all-invalid root

  // canonical first-codes
  uint32_t code = 0, first[16];
  for (int l = 1; l <= 15; l++) {
    code = (code + count[l - 1]) << 1;
    first[l] = code;
  }
  uint32_t next[16];
  for (int l = 1; l <= 15; l++) next[l] = first[l];

  // pass 1: per-root-prefix max length for long codes -> subtable sizes
  int sub_max[ROOTSZ];
  for (int i = 0; i < ROOTSZ; i++) sub_max[i] = 0;
  {
    uint32_t nx[16];
    for (int l = 1; l <= 15; l++) nx[l] = first[l];
    for (int s = 0; s < n; s++) {
      int l = lens[s];
      if (l == 0) continue;
      uint32_t c = nx[l]++;
      if (l > ROOTB) {
        uint32_t rev = bitrev(c, l);
        int prefix = rev & (ROOTSZ - 1);
        if (l > sub_max[prefix]) sub_max[prefix] = l;
      }
    }
  }
  int sub_base[ROOTSZ];
  for (int prefix = 0; prefix < ROOTSZ; prefix++) {
    if (!sub_max[prefix]) continue;
    int sbits = sub_max[prefix] - ROOTB;
    int used = int(tab.size());
    sub_base[prefix] = used;
    tab.resize(used + (1 << sbits), 0);
    tab[base + prefix] = mk(OP_SUB, sbits, used);
  }

  // pass 2: fill
  for (int s = 0; s < n; s++) {
    int l = lens[s];
    if (l == 0) continue;
    uint32_t c = next[l]++;
    uint32_t rev = bitrev(c, l);
    int32_t e = sym_entry(s, l, litlen);
    if (l <= ROOTB) {
      for (uint32_t i = rev; i < uint32_t(ROOTSZ); i += 1u << l)
        tab[base + i] = e;
    } else {
      int prefix = rev & (ROOTSZ - 1);
      int sbits = sub_max[prefix] - ROOTB;
      int sb = sub_base[prefix];
      for (uint32_t i = rev >> ROOTB; i < (1u << sbits);
           i += 1u << (l - ROOTB))
        tab[sb + i] = e;
    }
  }
  return base;
}

// Decode one symbol with the tables just built (the planner uses the lookup
// discipline of the kernel).
inline int32_t lookup(const int32_t* tab, int base, BitReader& br) {
  uint32_t peek = br.peek(15, br.bitpos);
  int32_t e = tab[base + (peek & (ROOTSZ - 1))];
  if ((e >> 28) == OP_SUB) {
    int sbits = (e >> 22) & 63;
    e = tab[(e & 0x3FFFFF) + ((peek >> ROOTB) & ((1u << sbits) - 1))];
  }
  int nbits = (e >> 22) & 63;
  if ((e >> 28) == OP_INVALID || nbits == 0) return 0;
  br.bitpos += nbits;
  if (br.bitpos > br.n * 8) br.overrun = true;
  return e;
}

constexpr int ST_OK = 0, ST_ROOM = 1, ST_MALFORMED = 2, ST_TOO_LONG = 3;

// Walk one chunk into desc (its blocks' descriptors) and tab (its tables);
// both grow as needed.
int plan_chunk(const uint8_t* src, int32_t src_len, int32_t out_cap,
               std::vector<int32_t>& desc, std::vector<int32_t>& tab,
               int32_t* out_len) {
  desc.clear();
  tab.clear();
  BitReader br{src, size_t(src_len)};
  int64_t out = 0;
  int fixed_ll = -1, fixed_d = -1;
  uint8_t lens[320];

  for (;;) {
    uint32_t bfinal = br.bits(1);
    uint32_t btype = br.bits(2);
    if (br.overrun) return ST_MALFORMED;
    desc.resize(desc.size() + DESC_FIELDS, 0);
    int32_t* d = desc.data() + desc.size() - DESC_FIELDS;
    d[6] = int32_t(bfinal);

    if (btype == 0) {  // stored
      br.bitpos = (br.bitpos + 7) & ~size_t(7);
      uint32_t len = br.bits(16), nlen = br.bits(16);
      if (br.overrun || ((len ^ nlen) & 0xFFFF) != 0xFFFF)
        return ST_MALFORMED;
      d[0] = 0;
      d[4] = int32_t(br.bitpos >> 3);
      d[5] = int32_t(len);
      br.bitpos += size_t(len) * 8;
      if (br.bitpos > br.n * 8) return ST_MALFORMED;
      out += len;
    } else if (btype == 1 || btype == 2) {
      int llbase, dbase;
      if (btype == 1) {  // fixed
        if (fixed_ll < 0) {
          for (int s = 0; s < 144; s++) lens[s] = 8;
          for (int s = 144; s < 256; s++) lens[s] = 9;
          for (int s = 256; s < 280; s++) lens[s] = 7;
          for (int s = 280; s < 288; s++) lens[s] = 8;
          fixed_ll = build_table(lens, 288, true, tab);
          for (int s = 0; s < 32; s++) lens[s] = 5;
          fixed_d = build_table(lens, 32, false, tab);
        }
        llbase = fixed_ll;
        dbase = fixed_d;
      } else {  // dynamic
        uint32_t hlit = br.bits(5) + 257;
        uint32_t hdist = br.bits(5) + 1;
        uint32_t hclen = br.bits(4) + 4;
        if (br.overrun || hlit > 286 || hdist > 30) return ST_MALFORMED;
        uint8_t cl[19] = {0};
        for (uint32_t i = 0; i < hclen; i++) cl[CLPERM[i]] = uint8_t(br.bits(3));
        if (br.overrun) return ST_MALFORMED;
        // tiny flat 7-bit code-length decode table (local)
        int16_t clt[128];
        for (int i = 0; i < 128; i++) clt[i] = -1;
        {
          int ccount[8] = {0};
          for (int s = 0; s < 19; s++) ccount[cl[s]]++;
          ccount[0] = 0;  // F4
          int cleft = 1;
          for (int l = 1; l <= 7; l++) {
            cleft <<= 1;
            cleft -= ccount[l];
            if (cleft < 0) return ST_MALFORMED;
          }
          if (cleft > 0) return ST_MALFORMED;  // F3: incomplete code set
          uint32_t ccode = 0, cnext[8];
          for (int l = 1; l <= 7; l++) {
            ccode = (ccode + ccount[l - 1]) << 1;
            cnext[l] = ccode;
          }
          for (int s = 0; s < 19; s++) {
            int l = cl[s];
            if (!l) continue;
            uint32_t rev = bitrev(cnext[l]++, l);
            for (uint32_t i = rev; i < 128; i += 1u << l)
              clt[i] = int16_t((l << 8) | s);
          }
        }
        uint32_t total = hlit + hdist;
        uint32_t got = 0;
        while (got < total) {
          int16_t e = clt[br.peek(7, br.bitpos)];
          if (e < 0) return ST_MALFORMED;
          br.bitpos += e >> 8;
          if (br.bitpos > br.n * 8) return ST_MALFORMED;
          int sym = e & 0xFF;
          if (sym < 16) {
            lens[got++] = uint8_t(sym);
          } else if (sym == 16) {
            if (got == 0) return ST_MALFORMED;
            uint32_t rep = 3 + br.bits(2);
            uint8_t v = lens[got - 1];
            if (br.overrun || got + rep > total) return ST_MALFORMED;
            while (rep--) lens[got++] = v;
          } else {
            uint32_t rep = sym == 17 ? 3 + br.bits(3) : 11 + br.bits(7);
            if (br.overrun || got + rep > total) return ST_MALFORMED;
            while (rep--) lens[got++] = 0;
          }
        }
        if (lens[256] == 0) return ST_MALFORMED;  // no end-of-block code
        llbase = build_table(lens, int(hlit), true, tab);
        uint8_t dlens[32];
        for (uint32_t i = 0; i < hdist; i++) dlens[i] = lens[hlit + i];
        dbase = llbase < 0 ? -1 : build_table(dlens, int(hdist), false, tab);
      }
      if (llbase < 0 || dbase < 0) return ST_MALFORMED;
      d[0] = 1;
      d[1] = int32_t(br.bitpos);
      d[2] = llbase;
      d[3] = dbase;

      // boundary scan: decode this block's symbols to find its EOB
      const int32_t* t = tab.data();
      for (;;) {
        int32_t e = lookup(t, llbase, br);
        if (!e || br.overrun) return ST_MALFORMED;
        int op = e >> 28;
        if (op == OP_LIT) {
          out++;
        } else if (op == OP_EOB) {
          break;
        } else if (op == OP_LEN) {
          int val = e & 0x3FFFFF;
          int extra = val >> 9;
          int mlen = (val & 511) + int(br.bits(extra));
          int32_t de = lookup(t, dbase, br);
          if (!de || br.overrun || (de >> 28) != OP_DIST)
            return ST_MALFORMED;
          int dval = de & 0x3FFFFF;
          int dist = (dval & 0xFFFF) + int(br.bits(dval >> 16));
          if (br.overrun || dist > out || dist > 32768) return ST_MALFORMED;
          out += mlen;
        } else {
          return ST_MALFORMED;
        }
        if (out > out_cap) return ST_TOO_LONG;
      }
    } else {
      return ST_MALFORMED;  // btype 3 reserved
    }
    if (out > out_cap) return ST_TOO_LONG;
    if (bfinal) break;
  }
  *out_len = int32_t(out);
  return ST_OK;
}

}  // namespace

extern "C" {

// Batch planner: src is (B, cap) row-major. For chunk i it writes up to
// max_blocks descriptors of 8 fields at desc + i * max_blocks * 8, up to
// tab_cap table entries at tabs + i * tab_cap, and info[i * 4] = {out_len,
// nblocks, tab_used, status}: status 0 ok, 1 the caps are too small (nblocks
// and tab_used are then what the chunk needs, and nothing is written), 2
// malformed, 3 output past out_cap.
void acx_inflate_plan_batch(const uint8_t* src, int64_t B, int64_t cap,
                            const int32_t* lens, int32_t max_blocks,
                            int32_t tab_cap, int32_t out_cap, int32_t* desc,
                            int32_t* tabs, int32_t* info) {
  std::vector<int32_t> d, t;
  for (int64_t i = 0; i < B; i++) {
    int32_t out_len = 0;
    int st = plan_chunk(src + i * cap, lens[i], out_cap, d, t, &out_len);
    int32_t nblocks = int32_t(d.size() / DESC_FIELDS);
    int32_t used = int32_t(t.size());
    if (st == ST_OK && (nblocks > max_blocks || used > tab_cap)) st = ST_ROOM;
    if (st == ST_OK) {
      std::memcpy(desc + i * int64_t(max_blocks) * DESC_FIELDS, d.data(),
                  d.size() * sizeof(int32_t));
      std::memcpy(tabs + i * int64_t(tab_cap), t.data(),
                  t.size() * sizeof(int32_t));
    }
    info[i * 4 + 0] = st == ST_OK || st == ST_ROOM ? out_len : 0;
    info[i * 4 + 1] = st == ST_OK || st == ST_ROOM ? nblocks : 0;
    info[i * 4 + 2] = st == ST_OK || st == ST_ROOM ? used : 0;
    info[i * 4 + 3] = st;
  }
}

}  // extern "C"
