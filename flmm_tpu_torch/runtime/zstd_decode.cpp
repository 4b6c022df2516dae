// Zstandard decompression (RFC 8878) and the checksums of the formats that
// carry it, for the host side: reading Orbax / OCDBT checkpoints without the
// zstd, tensorstore or orbax packages.
//
// Decompression only.  Frames with and without the content size, the window
// descriptor and the content checksum (XXH64, verified when its flag is
// set); raw, RLE and compressed blocks; Huffman-coded literals in one or
// four streams, tree descriptions direct or FSE-compressed, and treeless
// literals that repeat the previous table; the literal-length, offset and
// match-length FSE tables in all four modes (predefined, RLE, compressed,
// repeat) with the three repeat offsets; skippable frames and several frames
// in one buffer.  A frame that needs a dictionary is refused.  Anything
// malformed raises, with a message naming what failed.
//
// Also CRC-32C (Castagnoli, as absl::ComputeCrc32c), which OCDBT manifests
// and B-tree nodes end with, and XXH64.
//
// Every entry point returns 0, or a non-zero code with a message in err.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct ZError {
  std::string msg;
};

[[noreturn]] void zfail(const std::string& msg) { throw ZError{msg}; }

inline uint64_t rotl64(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }

inline uint64_t le64(const uint8_t* p) {
  uint64_t v = 0;
  for (int i = 7; i >= 0; --i) v = (v << 8) | p[i];
  return v;
}

inline uint32_t le32(const uint8_t* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
         ((uint32_t)p[3] << 24);
}

const uint64_t P1 = 11400714785074694791ULL, P2 = 14029467366897019727ULL,
               P3 = 1609587929392839161ULL, P4 = 9650029242287828579ULL,
               P5 = 2870177450012600261ULL;

inline uint64_t xxh_round(uint64_t acc, uint64_t in) {
  acc += in * P2;
  return rotl64(acc, 31) * P1;
}

inline uint64_t xxh_merge(uint64_t acc, uint64_t v) {
  acc ^= xxh_round(0, v);
  return acc * P1 + P4;
}

uint64_t xxh64(const uint8_t* p, size_t len, uint64_t seed) {
  const uint8_t* end = p + len;
  uint64_t h;
  if (len >= 32) {
    uint64_t v1 = seed + P1 + P2, v2 = seed + P2, v3 = seed, v4 = seed - P1;
    const uint8_t* limit = end - 32;
    do {
      v1 = xxh_round(v1, le64(p));
      v2 = xxh_round(v2, le64(p + 8));
      v3 = xxh_round(v3, le64(p + 16));
      v4 = xxh_round(v4, le64(p + 24));
      p += 32;
    } while (p <= limit);
    h = rotl64(v1, 1) + rotl64(v2, 7) + rotl64(v3, 12) + rotl64(v4, 18);
    h = xxh_merge(h, v1);
    h = xxh_merge(h, v2);
    h = xxh_merge(h, v3);
    h = xxh_merge(h, v4);
  } else {
    h = seed + P5;
  }
  h += (uint64_t)len;
  while (p + 8 <= end) {
    h ^= xxh_round(0, le64(p));
    h = rotl64(h, 27) * P1 + P4;
    p += 8;
  }
  if (p + 4 <= end) {
    h ^= (uint64_t)le32(p) * P1;
    h = rotl64(h, 23) * P2 + P3;
    p += 4;
  }
  while (p < end) {
    h ^= (uint64_t)(*p++) * P5;
    h = rotl64(h, 11) * P1;
  }
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

uint32_t crc32c(const uint8_t* p, size_t len) {
  static uint32_t table[256];
  static bool ready = false;
  if (!ready) {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = (c >> 1) ^ (0x82F63B78u & (0u - (c & 1)));
      table[i] = c;
    }
    ready = true;
  }
  uint32_t c = 0xFFFFFFFFu;
  for (size_t i = 0; i < len; ++i) c = table[(c ^ p[i]) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

inline int highbit(uint32_t v) {  // index of the highest set bit, v > 0
  int n = 0;
  while (v >>= 1) ++n;
  return n;
}

// A stream read backwards (Huffman and FSE payloads): the bytes as one
// little-endian integer whose highest set bit ends the padding; bits are
// taken from the top down.  Bits below the start read as zeros and leave
// pos negative, which the callers treat as an overrun.
class BackBits {
 public:
  BackBits(const uint8_t* src, size_t len, const char* what)
      : src_(src), len_(len) {
    if (len == 0 || src[len - 1] == 0)
      zfail(std::string("corrupt data: ") + what + " stream has no end mark");
    pos_ = (int64_t)(len - 1) * 8 + highbit(src[len - 1]);
  }

  int64_t pos() const { return pos_; }

  uint64_t peek(int n) const {  // n <= 56
    if (n == 0) return 0;
    int64_t lo = pos_ - n;
    if (lo < 0) {
      if (pos_ <= 0) return 0;
      return window(0, (int)pos_) << (-lo);
    }
    return window(lo, n);
  }

  uint64_t read(int n) {
    uint64_t v = peek(n);
    pos_ -= n;
    return v;
  }

  void skip(int n) { pos_ -= n; }

 private:
  uint64_t window(int64_t lo, int n) const {
    size_t byte = (size_t)(lo >> 3);
    int shift = (int)(lo & 7);
    uint64_t w = 0;
    for (int i = 0; i < 8 && byte + i < len_; ++i)
      w |= (uint64_t)src_[byte + i] << (8 * i);
    return (w >> shift) & ((n == 64) ? ~0ULL : ((1ULL << n) - 1));
  }

  const uint8_t* src_;
  size_t len_;
  int64_t pos_;
};

// A stream read forwards, least significant bit first (FSE table headers).
class FwdBits {
 public:
  FwdBits(const uint8_t* src, size_t len) : src_(src), len_(len) {}
  uint32_t peek(int n) const {
    uint64_t w = 0;
    size_t byte = (size_t)(pos_ >> 3);
    for (int i = 0; i < 8 && byte + i < len_; ++i)
      w |= (uint64_t)src_[byte + i] << (8 * i);
    return (uint32_t)((w >> (pos_ & 7)) & ((1ULL << n) - 1));
  }
  void skip(int n) { pos_ += n; }
  uint32_t read(int n) {
    uint32_t v = peek(n);
    skip(n);
    return v;
  }
  size_t bytes_used() const { return (size_t)((pos_ + 7) >> 3); }
  bool overran() const { return (size_t)((pos_ + 7) >> 3) > len_; }

 private:
  const uint8_t* src_;
  size_t len_;
  int64_t pos_ = 0;
};

struct FseEntry {
  uint16_t new_state;
  uint8_t symbol;
  uint8_t nbits;
};

struct FseTable {
  int log = -1;  // -1: no table yet
  std::vector<FseEntry> t;
};

// FSE_buildDTable: spread the symbols over the states, then each state's
// bit count and baseline
void fse_build(FseTable& ft, const int16_t* norm, int max_symbol, int log) {
  const int size = 1 << log;
  ft.log = log;
  ft.t.assign((size_t)size, FseEntry{0, 0, 0});
  std::vector<uint32_t> next((size_t)max_symbol + 1);
  int high = size - 1;
  for (int s = 0; s <= max_symbol; ++s) {
    if (norm[s] == -1) {
      ft.t[(size_t)high--].symbol = (uint8_t)s;
      next[s] = 1;
    } else {
      next[s] = (uint32_t)norm[s];
    }
  }
  const int step = (size >> 1) + (size >> 3) + 3, mask = size - 1;
  int pos = 0;
  for (int s = 0; s <= max_symbol; ++s) {
    for (int i = 0; i < norm[s]; ++i) {
      ft.t[(size_t)pos].symbol = (uint8_t)s;
      do {
        pos = (pos + step) & mask;
      } while (pos > high);
    }
  }
  if (pos != 0) zfail("corrupt data: FSE table does not spread");
  for (int u = 0; u < size; ++u) {
    int s = ft.t[(size_t)u].symbol;
    uint32_t ns = next[s]++;
    int nb = log - highbit(ns);
    ft.t[(size_t)u].nbits = (uint8_t)nb;
    ft.t[(size_t)u].new_state = (uint16_t)((ns << nb) - (uint32_t)size);
  }
}

void fse_rle(FseTable& ft, int symbol) {
  ft.log = 0;
  ft.t.assign(1, FseEntry{0, (uint8_t)symbol, 0});
}

// FSE_readNCount: a table description; returns the bytes it took
size_t fse_read_table(FseTable& ft, const uint8_t* src, size_t len,
                      int max_log, int max_symbol, const char* what) {
  if (len < 1) zfail(std::string("corrupt data: empty ") + what + " table");
  FwdBits br(src, len);
  const int log = (int)br.read(4) + 5;
  if (log > max_log)
    zfail(std::string("corrupt data: ") + what + " accuracy log " +
          std::to_string(log) + " above " + std::to_string(max_log));
  std::vector<int16_t> norm((size_t)max_symbol + 1, 0);
  int remaining = (1 << log) + 1, threshold = 1 << log, nbits = log + 1;
  int s = 0;
  bool prev0 = false;
  while (remaining > 1 && s <= max_symbol) {
    if (prev0) {
      int n0 = s;
      uint32_t flag;
      while ((flag = br.read(2)) == 3) n0 += 3;
      n0 += (int)flag;
      if (n0 > max_symbol + 1)
        zfail(std::string("corrupt data: ") + what + " table repeats past "
              "its last symbol");
      while (s < n0) norm[(size_t)s++] = 0;
      if (s > max_symbol) break;
    }
    const int max = (2 * threshold - 1) - remaining;
    int count;
    uint32_t v = br.peek(nbits);
    if ((int)(v & (uint32_t)(threshold - 1)) < max) {
      count = (int)(v & (uint32_t)(threshold - 1));
      br.skip(nbits - 1);
    } else {
      count = (int)(v & (uint32_t)(2 * threshold - 1));
      if (count >= threshold) count -= max;
      br.skip(nbits);
    }
    --count;  // -1: a probability below one
    remaining -= count < 0 ? -count : count;
    norm[(size_t)s++] = (int16_t)count;
    prev0 = count == 0;
    while (remaining < threshold) {
      --nbits;
      threshold >>= 1;
    }
  }
  if (remaining != 1 || br.overran())
    zfail(std::string("corrupt data: ") + what + " table description");
  fse_build(ft, norm.data(), s - 1, log);
  return br.bytes_used();
}

struct HufEntry {
  uint8_t symbol;
  uint8_t nbits;
};

struct HufTable {
  int max_bits = 0;  // 0: no table yet
  std::vector<HufEntry> t;
};

// a Huffman tree description (RFC 8878 4.2.1); returns the bytes it took
size_t huf_read_table(HufTable& ht, const uint8_t* src, size_t len) {
  if (len < 1) zfail("corrupt data: empty Huffman tree description");
  uint8_t weights[256];
  int nweights = 0;
  size_t used;
  const int header = src[0];
  if (header < 128) {
    // FSE-compressed weights: a table (accuracy at most 6), then two
    // interleaved states over a backward stream
    if ((size_t)header + 1 > len)
      zfail("corrupt data: Huffman weights past the block");
    FseTable ft;
    size_t tsize = fse_read_table(ft, src + 1, (size_t)header, 6, 255,
                                  "Huffman weight");
    if (tsize >= (size_t)header)
      zfail("corrupt data: Huffman weight stream empty");
    BackBits bb(src + 1 + tsize, (size_t)header - tsize, "Huffman weight");
    uint32_t s1 = (uint32_t)bb.read(ft.log), s2 = (uint32_t)bb.read(ft.log);
    auto decode = [&](uint32_t& st) {
      const FseEntry& e = ft.t[st];
      st = e.new_state + (uint32_t)bb.read(e.nbits);
      return e.symbol;
    };
    while (true) {
      if (nweights >= 255) zfail("corrupt data: too many Huffman weights");
      weights[nweights++] = decode(s1);
      if (bb.pos() < 0) {
        if (nweights >= 255) zfail("corrupt data: too many Huffman weights");
        weights[nweights++] = ft.t[s2].symbol;
        break;
      }
      if (nweights >= 255) zfail("corrupt data: too many Huffman weights");
      weights[nweights++] = decode(s2);
      if (bb.pos() < 0) {
        if (nweights >= 255) zfail("corrupt data: too many Huffman weights");
        weights[nweights++] = ft.t[s1].symbol;
        break;
      }
    }
    used = 1 + (size_t)header;
  } else {
    nweights = header - 127;
    size_t nbytes = ((size_t)nweights + 1) / 2;
    if (1 + nbytes > len) zfail("corrupt data: Huffman weights past the block");
    for (int i = 0; i < nweights; ++i) {
      uint8_t b = src[1 + i / 2];
      weights[i] = (i & 1) ? (b & 15) : (b >> 4);
    }
    used = 1 + nbytes;
  }
  // the last symbol's weight completes the sum to a power of two
  uint32_t total = 0;
  for (int i = 0; i < nweights; ++i) {
    if (weights[i] > 11) zfail("corrupt data: Huffman weight above 11");
    if (weights[i]) total += 1u << (weights[i] - 1);
  }
  if (total == 0) zfail("corrupt data: Huffman weights all zero");
  const int max_bits = highbit(total) + 1;
  if (max_bits > 11) zfail("corrupt data: Huffman code longer than 11 bits");
  const uint32_t rest = (1u << max_bits) - total;
  if (rest & (rest - 1)) zfail("corrupt data: Huffman weights do not close");
  weights[nweights++] = (uint8_t)(highbit(rest) + 1);
  // HUF_readDTableX1: the lowest weights (longest codes) take the lowest
  // indices of the max_bits-bit lookup
  uint32_t rank_count[13] = {0}, rank_start[13] = {0};
  for (int i = 0; i < nweights; ++i) rank_count[weights[i]]++;
  uint32_t next = 0;
  for (int w = 1; w <= max_bits; ++w) {
    rank_start[w] = next;
    next += rank_count[w] << (w - 1);
  }
  ht.max_bits = max_bits;
  ht.t.assign((size_t)1 << max_bits, HufEntry{0, 0});
  for (int i = 0; i < nweights; ++i) {
    int w = weights[i];
    if (!w) continue;
    uint32_t n = 1u << (w - 1);
    for (uint32_t u = rank_start[w]; u < rank_start[w] + n; ++u)
      ht.t[u] = HufEntry{(uint8_t)i, (uint8_t)(max_bits + 1 - w)};
    rank_start[w] += n;
  }
  return used;
}

void huf_decode_stream(const HufTable& ht, const uint8_t* src, size_t len,
                       uint8_t* out, size_t n) {
  BackBits bb(src, len, "Huffman literal");
  for (size_t i = 0; i < n; ++i) {
    const HufEntry& e = ht.t[(size_t)bb.peek(ht.max_bits)];
    out[i] = e.symbol;
    bb.skip(e.nbits);
  }
  if (bb.pos() != 0) zfail("corrupt data: Huffman literal stream size");
}

const int16_t kLLDefault[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2,
                                2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2,
                                2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t kMLDefault[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t kOFDefault[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, -1, -1, -1, -1, -1};
const uint32_t kLLBase[36] = {
    0,  1,  2,   3,   4,   5,   6,    7,    8,    9,     10,    11,
    12, 13, 14,  15,  16,  18,  20,   22,   24,   28,    32,    40,
    48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3,
                             4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t kMLBase[53] = {
    3,  4,  5,  6,  7,  8,  9,  10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20,
    21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 37, 39, 41,
    43, 47, 51, 59, 67, 83, 99, 131, 259, 515, 1027, 2051, 4099, 8195,
    16387, 32771, 65539};
const uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 4, 4,
                             5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};

// the state one frame carries from block to block
struct FrameState {
  HufTable huf;
  FseTable ll, of, ml;
  uint64_t rep[3] = {1, 4, 8};
};

const uint32_t kMaxBlock = 128 * 1024;

void decode_literals(FrameState& fs, const uint8_t* src, size_t len,
                     std::vector<uint8_t>& lit, size_t& used) {
  if (len < 1) zfail("corrupt data: block without a literals section");
  const int type = src[0] & 3, sf = (src[0] >> 2) & 3;
  size_t regen, comp = 0, hsize;
  if (type < 2) {  // raw or RLE
    if ((sf & 1) == 0) {
      hsize = 1;
      regen = src[0] >> 3;
    } else if (sf == 1) {
      hsize = 2;
      if (len < 2) zfail("corrupt data: short literals header");
      regen = (src[0] >> 4) | ((size_t)src[1] << 4);
    } else {
      hsize = 3;
      if (len < 3) zfail("corrupt data: short literals header");
      regen = (src[0] >> 4) | ((size_t)src[1] << 4) | ((size_t)src[2] << 12);
    }
    if (regen > kMaxBlock) zfail("corrupt data: literals above 128 KiB");
    lit.resize(regen);
    if (type == 0) {
      if (hsize + regen > len) zfail("corrupt data: raw literals past the block");
      if (regen) std::memcpy(lit.data(), src + hsize, regen);
      used = hsize + regen;
    } else {
      if (hsize + 1 > len) zfail("corrupt data: RLE literals past the block");
      std::memset(lit.data(), src[hsize], regen);
      used = hsize + 1;
    }
    return;
  }
  int streams = sf == 0 ? 1 : 4;
  hsize = sf < 2 ? 3 : (sf == 2 ? 4 : 5);
  if (len < hsize) zfail("corrupt data: short literals header");
  uint64_t h = 0;
  for (size_t i = 0; i < hsize; ++i) h |= (uint64_t)src[i] << (8 * i);
  const int field = sf < 2 ? 10 : (sf == 2 ? 14 : 18);
  regen = (size_t)((h >> 4) & ((1u << field) - 1));
  comp = (size_t)((h >> (4 + field)) & ((1u << field) - 1));
  if (regen > kMaxBlock) zfail("corrupt data: literals above 128 KiB");
  if (hsize + comp > len) zfail("corrupt data: literals past the block");
  const uint8_t* p = src + hsize;
  size_t rest = comp;
  if (type == 2) {
    size_t t = huf_read_table(fs.huf, p, rest);
    p += t;
    rest -= t;
  } else if (fs.huf.max_bits == 0) {
    zfail("corrupt data: treeless literals without a previous Huffman table");
  }
  lit.resize(regen);
  if (streams == 1) {
    huf_decode_stream(fs.huf, p, rest, lit.data(), regen);
  } else {
    if (rest < 6) zfail("corrupt data: short literal jump table");
    size_t s1 = p[0] | (p[1] << 8), s2 = p[2] | (p[3] << 8),
           s3 = p[4] | (p[5] << 8);
    if (6 + s1 + s2 + s3 > rest) zfail("corrupt data: literal jump table");
    size_t s4 = rest - 6 - s1 - s2 - s3;
    size_t seg = (regen + 3) / 4;
    if (3 * seg > regen) zfail("corrupt data: too few literals for 4 streams");
    const uint8_t* q = p + 6;
    huf_decode_stream(fs.huf, q, s1, lit.data(), seg);
    huf_decode_stream(fs.huf, q + s1, s2, lit.data() + seg, seg);
    huf_decode_stream(fs.huf, q + s1 + s2, s3, lit.data() + 2 * seg, seg);
    huf_decode_stream(fs.huf, q + s1 + s2 + s3, s4, lit.data() + 3 * seg,
                      regen - 3 * seg);
  }
  used = hsize + comp;
}

size_t read_seq_table(FseTable& ft, int mode, const uint8_t* src, size_t len,
                      const int16_t* deflt, int deflt_max, int deflt_log,
                      int max_log, int max_symbol, const char* what) {
  switch (mode) {
    case 0:
      fse_build(ft, deflt, deflt_max, deflt_log);
      return 0;
    case 1:
      if (len < 1) zfail(std::string("corrupt data: short ") + what + " RLE");
      if (src[0] > max_symbol)
        zfail(std::string("corrupt data: ") + what + " RLE symbol");
      fse_rle(ft, src[0]);
      return 1;
    case 2:
      return fse_read_table(ft, src, len, max_log, max_symbol, what);
    default:
      if (ft.log < 0)
        zfail(std::string("corrupt data: repeated ") + what +
              " table without a previous one");
      return 0;
  }
}

void decode_block(FrameState& fs, const uint8_t* src, size_t len,
                  std::vector<uint8_t>& out, size_t frame_start) {
  std::vector<uint8_t> lit;
  size_t used = 0;
  decode_literals(fs, src, len, lit, used);
  const uint8_t* p = src + used;
  size_t rest = len - used;
  if (rest < 1) zfail("corrupt data: block without a sequences section");
  size_t nseq;
  if (p[0] < 128) {
    nseq = p[0];
    p += 1;
    rest -= 1;
  } else if (p[0] < 255) {
    if (rest < 2) zfail("corrupt data: short sequences header");
    nseq = ((size_t)(p[0] - 128) << 8) + p[1];
    p += 2;
    rest -= 2;
  } else {
    if (rest < 3) zfail("corrupt data: short sequences header");
    nseq = (size_t)p[1] + ((size_t)p[2] << 8) + 0x7F00;
    p += 3;
    rest -= 3;
  }
  if (nseq == 0) {
    if (rest) zfail("corrupt data: bytes after a block without sequences");
    out.insert(out.end(), lit.begin(), lit.end());
    return;
  }
  if (rest < 1) zfail("corrupt data: no compression modes");
  const int modes = p[0];
  if (modes & 3) zfail("corrupt data: reserved compression-mode bits set");
  p += 1;
  rest -= 1;
  size_t t = read_seq_table(fs.ll, modes >> 6, p, rest, kLLDefault, 35, 6, 9,
                            35, "literal-length");
  p += t;
  rest -= t;
  t = read_seq_table(fs.of, (modes >> 4) & 3, p, rest, kOFDefault, 28, 5, 8,
                     31, "offset");
  p += t;
  rest -= t;
  t = read_seq_table(fs.ml, (modes >> 2) & 3, p, rest, kMLDefault, 52, 6, 9,
                     52, "match-length");
  p += t;
  rest -= t;
  BackBits bb(p, rest, "sequence");
  uint32_t sll = (uint32_t)bb.read(fs.ll.log);
  uint32_t sof = (uint32_t)bb.read(fs.of.log);
  uint32_t sml = (uint32_t)bb.read(fs.ml.log);
  size_t lpos = 0;
  for (size_t i = 0; i < nseq; ++i) {
    const FseEntry& ell = fs.ll.t[sll];
    const FseEntry& eof = fs.of.t[sof];
    const FseEntry& eml = fs.ml.t[sml];
    const int ofc = eof.symbol, mlc = eml.symbol, llc = ell.symbol;
    if (llc > 35 || mlc > 52 || ofc > 31)
      zfail("corrupt data: sequence code out of range");
    uint64_t ofv = (1ULL << ofc) + bb.read(ofc);
    uint64_t ml = kMLBase[mlc] + bb.read(kMLBits[mlc]);
    uint64_t ll = kLLBase[llc] + bb.read(kLLBits[llc]);
    uint64_t off;
    if (ofv > 3) {
      off = ofv - 3;
      fs.rep[2] = fs.rep[1];
      fs.rep[1] = fs.rep[0];
      fs.rep[0] = off;
    } else {
      int idx = (int)ofv - 1 + (ll == 0 ? 1 : 0);
      if (idx == 0) {
        off = fs.rep[0];
      } else {
        off = idx == 3 ? fs.rep[0] - 1 : fs.rep[idx];
        if (off == 0) zfail("corrupt data: repeat offset 0");
        if (idx != 1) fs.rep[2] = fs.rep[1];
        fs.rep[1] = fs.rep[0];
        fs.rep[0] = off;
      }
    }
    if (i + 1 < nseq) {
      sll = ell.new_state + (uint32_t)bb.read(ell.nbits);
      sml = eml.new_state + (uint32_t)bb.read(eml.nbits);
      sof = eof.new_state + (uint32_t)bb.read(eof.nbits);
    }
    if (bb.pos() < 0) zfail("corrupt data: sequence stream overrun");
    if (lpos + ll > lit.size()) zfail("corrupt data: literals overrun");
    out.insert(out.end(), lit.begin() + (int64_t)lpos,
               lit.begin() + (int64_t)(lpos + ll));
    lpos += ll;
    if (off > out.size() - frame_start)
      zfail("corrupt data: match offset before the frame start");
    size_t from = out.size() - (size_t)off;
    for (uint64_t k = 0; k < ml; ++k) out.push_back(out[from + k]);
  }
  if (bb.pos() != 0) zfail("corrupt data: sequence stream size");
  out.insert(out.end(), lit.begin() + (int64_t)lpos, lit.end());
}

// one frame at src[pos]; returns the position after it
size_t decode_frame(const uint8_t* src, size_t n, size_t pos,
                    std::vector<uint8_t>& out) {
  const size_t start = out.size();
  if (pos + 5 > n) zfail("corrupt data: truncated frame header");
  const int fhd = src[pos + 4];
  pos += 5;
  const int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1,
            checksum = (fhd >> 2) & 1, dict_flag = fhd & 3;
  if (fhd & 8) zfail("corrupt data: reserved frame-header bit set");
  if (!single) {
    if (pos + 1 > n) zfail("corrupt data: truncated frame header");
    ++pos;  // the window descriptor: offsets are checked against the frame
  }
  const int dict_bytes[4] = {0, 1, 2, 4};
  uint64_t dict_id = 0;
  if (pos + dict_bytes[dict_flag] > n) zfail("corrupt data: truncated frame header");
  for (int i = 0; i < dict_bytes[dict_flag]; ++i)
    dict_id |= (uint64_t)src[pos + i] << (8 * i);
  pos += dict_bytes[dict_flag];
  if (dict_id)
    zfail("zstd frame needs dictionary " + std::to_string(dict_id) +
          ", which is not supported");
  const int fcs_bytes_tab[4] = {0, 2, 4, 8};
  int fcs_bytes = fcs_bytes_tab[fcs_flag];
  if (fcs_flag == 0 && single) fcs_bytes = 1;
  bool have_size = fcs_bytes > 0;
  uint64_t content = 0;
  if (pos + fcs_bytes > n) zfail("corrupt data: truncated frame header");
  for (int i = 0; i < fcs_bytes; ++i)
    content |= (uint64_t)src[pos + i] << (8 * i);
  if (fcs_bytes == 2) content += 256;
  pos += fcs_bytes;
  FrameState fs;
  while (true) {
    if (pos + 3 > n) zfail("corrupt data: truncated block header");
    uint32_t bh = src[pos] | (src[pos + 1] << 8) | (src[pos + 2] << 16);
    pos += 3;
    const bool last = bh & 1;
    const int type = (bh >> 1) & 3;
    const size_t size = bh >> 3;
    if (type == 3) zfail("corrupt data: reserved block type");
    if (size > kMaxBlock) zfail("corrupt data: block above 128 KiB");
    if (type == 1) {
      if (pos + 1 > n) zfail("corrupt data: truncated RLE block");
      out.insert(out.end(), size, src[pos]);
      pos += 1;
    } else {
      if (pos + size > n) zfail("corrupt data: truncated block");
      if (type == 0)
        out.insert(out.end(), src + pos, src + pos + size);
      else
        decode_block(fs, src + pos, size, out, start);
      pos += size;
    }
    if (last) break;
  }
  if (have_size && out.size() - start != content)
    zfail("corrupt data: frame content size " + std::to_string(content) +
          " but " + std::to_string(out.size() - start) + " bytes decoded");
  if (checksum) {
    if (pos + 4 > n) zfail("corrupt data: truncated content checksum");
    uint32_t want = le32(src + pos);
    uint32_t got = (uint32_t)xxh64(out.data() + start, out.size() - start, 0);
    if (want != got) zfail("content checksum mismatch");
    pos += 4;
  }
  return pos;
}

void set_err(char* err, int errlen, const std::string& msg) {
  if (errlen > 0) std::snprintf(err, (size_t)errlen, "%s", msg.c_str());
}

}  // namespace

extern "C" {

// every frame of src[0:n] decoded into a malloc'd buffer (*out, *out_n);
// the caller frees it with flmm_zstd_free
int flmm_zstd_decompress(const uint8_t* src, int64_t n, uint8_t** out,
                         int64_t* out_n, char* err, int errlen) {
  *out = nullptr;
  *out_n = 0;
  try {
    std::vector<uint8_t> buf;
    size_t pos = 0;
    if (n <= 0) zfail("not zstd data: empty input");
    while (pos < (size_t)n) {
      if (pos + 4 > (size_t)n) zfail("corrupt data: truncated frame magic");
      uint32_t magic = le32(src + pos);
      if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {  // skippable frame
        if (pos + 8 > (size_t)n) zfail("corrupt data: truncated skippable frame");
        pos += 8 + (size_t)le32(src + pos + 4);
        if (pos > (size_t)n) zfail("corrupt data: truncated skippable frame");
        continue;
      }
      if (magic != 0xFD2FB528u)
        zfail(pos ? "corrupt data: bytes after the last frame"
                  : "not zstd data: bad magic number");
      pos = decode_frame(src, (size_t)n, pos, buf);
    }
    uint8_t* o = (uint8_t*)std::malloc(buf.size() ? buf.size() : 1);
    if (!o) zfail("out of memory");
    if (!buf.empty()) std::memcpy(o, buf.data(), buf.size());
    *out = o;
    *out_n = (int64_t)buf.size();
    return 0;
  } catch (const ZError& e) {
    set_err(err, errlen, e.msg);
    return 1;
  } catch (const std::bad_alloc&) {
    set_err(err, errlen, "out of memory");
    return 2;
  }
}

void flmm_zstd_free(uint8_t* p) { std::free(p); }

uint32_t flmm_crc32c(const uint8_t* p, int64_t n) {
  return crc32c(p, (size_t)n);
}

uint64_t flmm_xxh64(const uint8_t* p, int64_t n, uint64_t seed) {
  return xxh64(p, (size_t)n, seed);
}

}  // extern "C"
