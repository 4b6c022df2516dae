// Image decoding for the host data pipeline, without PIL: a JPEG decoder
// that gives libjpeg-turbo's default pixels (the ones PIL returns) and the
// PNG row filters.
//
// JPEG: sequential (SOF0 / SOF1) and progressive (SOF2) Huffman coding,
// 8-bit samples, 1, 3 or 4 components, every integral sampling ratio
// libjpeg-turbo takes (factors 1 to 4, at most 10 blocks an MCU),
// interleaved or single-component scans, restart markers.  Progressive
// scans: DC first and refinement, AC first and refinement with end-of-band
// runs, as jdphuff.c decodes them, into one coefficient buffer that is
// dequantized (with each component's table as latched at its first scan)
// and transformed once the file ends.  The arithmetic is libjpeg-turbo's
// default decode:
//   * the ISLOW inverse DCT (jidctint.c, 13-bit constants, 2 pass-1 bits),
//     its result clamped to 0..255 as the SIMD build clamps it;
//   * "fancy" triangular upsampling (jdsample.c h2v1 / h1v2 / h2v2 with
//     their rounding biases and edge columns; the rows above the first and
//     below the last real row repeat that row, as jdmainct.c's context
//     pointers do), and plain replication where jdsample.c takes it (h2v1
//     and h2v2 for a component at most 2 samples wide, and int_upsample
//     for every other integral ratio, e.g. 4:1:1, 3 x 1 or 4 x 2);
//   * the fixed-point YCbCr -> RGB tables of jdcolor.c (16 fraction bits).
// The colour space follows jdapimin.c: three components are YCbCr after a
// JFIF marker, RGB after an Adobe marker with transform flag 0, else RGB
// when the component ids are 'R' 'G' 'B', else YCbCr; four components are
// YCCK after an Adobe marker with a transform flag other than 0 (converted
// to CMYK by jdcolor.c's ycck_cmyk_convert), else CMYK.  Four-component
// pixels then take PIL's path: its "CMYK;I" raw mode (every sample
// inverted, the Adobe convention PIL always assumes) and Convert.c's
// cmyk2rgb.  Lossless, hierarchical, arithmetic-coded and 12-bit files are
// refused with an error that names the kind, and so is a progressive file
// whose scans leave any of the coefficients 1-9 of a component short of
// full precision, for which libjpeg would smooth the blocks (jdcoefct.c
// decompress_smooth_data).  When the entropy-coded data ends early the
// missing bits read as zeros, as libjpeg reads them.
//
// PNG: the five row filters of the PNG specification (None, Sub, Up,
// Average, Paeth) undone in place; inflating is left to zlib in Python.
//
// Every entry point returns 0, or a non-zero code with a message in err.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <string>
#include <vector>
#include <algorithm>

namespace {

struct Error {
  std::string msg;
};

[[noreturn]] void fail(const std::string& msg) { throw Error{msg}; }

const int kZigzag[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    // a corrupt run past the end of a block lands on the last entry
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct Huffman {
  bool present = false;
  // codes that do not fit their lengths: refused when a scan uses the
  // table, as libjpeg builds and checks a table only then
  bool bad = false;
  // canonical decoding: maxcode[l] is the largest code of length l (-1 if
  // none), valptr[l] the index in vals of the first code of length l
  int32_t maxcode[18];
  int32_t mincode[17];
  int32_t valptr[17];
  uint8_t vals[256];
  // 9-bit lookahead: (length << 8) | symbol, length 0 when longer
  uint16_t look[512];
};

void build_huffman(Huffman& h, const uint8_t* counts, const uint8_t* vals,
                   int nvals) {
  std::memcpy(h.vals, vals, nvals);
  int code = 0, k = 0;
  std::fill(h.look, h.look + 512, 0);
  h.present = true;
  h.bad = false;
  for (int l = 1; l <= 16; ++l) {
    h.valptr[l] = k;
    h.mincode[l] = code;
    if (counts[l - 1]) {
      for (int i = 0; i < counts[l - 1]; ++i) {
        // a code of length l fits in l bits and is not all ones, as
        // libjpeg's jpeg_make_d_derived_tbl requires; checked before the
        // lookahead fill, whose base + j then stays below 512
        if (code >= (1 << l) - 1) {
          h.bad = true;
          return;
        }
        if (l <= 9) {
          int shift = 9 - l;
          int base = code << shift;
          for (int j = 0; j < (1 << shift); ++j)
            h.look[base + j] = (uint16_t)((l << 8) | vals[k]);
        }
        ++code;
        ++k;
      }
      h.maxcode[l] = code - 1;
    } else {
      h.maxcode[l] = -1;
    }
    code <<= 1;
  }
  h.maxcode[17] = 0x7fffffff;
}

struct Component {
  int id, h, v, tq;
  int td = 0, ta = 0;
  int bw = 0, bh = 0;  // blocks a row and block rows of the plane
  int dc_pred = 0;
  std::vector<uint8_t> plane;  // bw*8 x bh*8 samples
  // progressive: the coefficients of every block (natural order), the
  // quantization table latched at the component's first scan, and the
  // successive-approximation bit of each coefficient (-1: not yet sent)
  std::vector<int16_t> coef;
  bool latched = false;
  int32_t qlatch[64];
  int coef_bits[64];
};

class BitReader {
 public:
  BitReader(const uint8_t* d, int64_t n, int64_t pos) : d_(d), n_(n), p_(pos) {}

  int64_t pos() const { return p_; }

  void fill() {
    while (nbits_ <= 56) {
      uint32_t byte = 0;
      if (!hit_marker_ && p_ < n_) {
        byte = d_[p_];
        if (byte == 0xFF) {
          // a stuffed zero byte, fill bytes, or a marker
          int64_t q = p_ + 1;
          while (q < n_ && d_[q] == 0xFF) ++q;
          if (q < n_ && d_[q] == 0x00) {
            p_ = q + 1;
          } else {
            hit_marker_ = true;  // leave p_ at the marker's first 0xFF
            byte = 0;
          }
        } else {
          ++p_;
        }
      } else {
        hit_marker_ = true;
      }
      buf_ |= (uint64_t)byte << (56 - nbits_);
      nbits_ += 8;
    }
  }

  int peek(int n) {
    if (nbits_ < n) fill();
    return (int)(buf_ >> (64 - n));
  }

  void skip(int n) {
    buf_ <<= n;
    nbits_ -= n;
  }

  int bits(int n) {
    if (n == 0) return 0;
    int v = peek(n);
    skip(n);
    return v;
  }

  int decode(const Huffman& h) {
    int look = h.look[peek(9)];
    if (look >> 8) {
      skip(look >> 8);
      return look & 0xFF;
    }
    int code = peek(16);
    for (int l = 10; l <= 16; ++l) {
      int c = code >> (16 - l);
      if (h.maxcode[l] >= 0 && c <= h.maxcode[l]) {
        skip(l);
        return h.vals[h.valptr[l] + c - h.mincode[l]];
      }
    }
    // a bad code: libjpeg warns and yields symbol 0
    skip(16);
    return 0;
  }

  // the restart marker RSTn after an interval: drop the partial byte and
  // step over the marker
  void restart(int expect) {
    buf_ = 0;
    nbits_ = 0;
    hit_marker_ = false;
    int64_t q = p_;
    while (q < n_ && d_[q] == 0xFF) ++q;
    if (q < n_ && d_[q] == 0xD0 + expect) {
      p_ = q + 1;
    } else {
      fail("corrupt data: restart marker RST" + std::to_string(expect) +
           " missing");
    }
  }

  // after a scan: the position of the next marker
  int64_t end_of_scan() {
    int64_t q = p_;
    while (q + 1 < n_) {
      if (d_[q] == 0xFF && d_[q + 1] != 0x00 &&
          !(d_[q + 1] >= 0xD0 && d_[q + 1] <= 0xD7) && d_[q + 1] != 0xFF)
        return q;
      ++q;
    }
    return n_;
  }

 private:
  const uint8_t* d_;
  int64_t n_, p_;
  uint64_t buf_ = 0;
  int nbits_ = 0;
  bool hit_marker_ = false;
};

inline int extend(int v, int s) {
  return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

// jidctint.c jpeg_idct_islow, output clamped to 0..255
const int32_t FIX_0_298631336 = 2446, FIX_0_390180644 = 3196,
              FIX_0_541196100 = 4433, FIX_0_765366865 = 6270,
              FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
              FIX_1_501321110 = 12299, FIX_1_847759065 = 15137,
              FIX_1_961570560 = 16069, FIX_2_053119869 = 16819,
              FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;
const int CONST_BITS = 13, PASS1_BITS = 2;

inline int64_t descale(int64_t x, int n) {
  return (x + ((int64_t)1 << (n - 1))) >> n;
}

inline uint8_t clamp_sample(int64_t v) {
  v += 128;
  return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v));
}

void idct_islow(const int32_t* coef /* natural order, dequantized */,
                uint8_t* out, int stride) {
  int32_t ws[64];
  for (int c = 0; c < 8; ++c) {
    const int32_t* in = coef + c;
    int32_t* w = ws + c;
    if (!in[8] && !in[16] && !in[24] && !in[32] && !in[40] && !in[48] &&
        !in[56]) {
      int32_t dc = in[0] * (1 << PASS1_BITS);
      for (int r = 0; r < 8; ++r) w[8 * r] = dc;
      continue;
    }
    int64_t z2 = in[16], z3 = in[48];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = in[0];
    z3 = in[32];
    int64_t tmp0 = (z2 + z3) * (1 << CONST_BITS);
    int64_t tmp1 = (z2 - z3) * (1 << CONST_BITS);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = in[56];
    tmp1 = in[40];
    tmp2 = in[24];
    tmp3 = in[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int sh = CONST_BITS - PASS1_BITS;
    w[0] = (int32_t)descale(tmp10 + tmp3, sh);
    w[56] = (int32_t)descale(tmp10 - tmp3, sh);
    w[8] = (int32_t)descale(tmp11 + tmp2, sh);
    w[48] = (int32_t)descale(tmp11 - tmp2, sh);
    w[16] = (int32_t)descale(tmp12 + tmp1, sh);
    w[40] = (int32_t)descale(tmp12 - tmp1, sh);
    w[24] = (int32_t)descale(tmp13 + tmp0, sh);
    w[32] = (int32_t)descale(tmp13 - tmp0, sh);
  }
  for (int r = 0; r < 8; ++r) {
    const int32_t* w = ws + 8 * r;
    uint8_t* o = out + (int64_t)r * stride;
    const int sh = CONST_BITS + PASS1_BITS + 3;
    if (!w[1] && !w[2] && !w[3] && !w[4] && !w[5] && !w[6] && !w[7]) {
      uint8_t v = clamp_sample(descale(w[0], PASS1_BITS + 3));
      for (int i = 0; i < 8; ++i) o[i] = v;
      continue;
    }
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    int64_t tmp0 = ((int64_t)w[0] + w[4]) * (1 << CONST_BITS);
    int64_t tmp1 = ((int64_t)w[0] - w[4]) * (1 << CONST_BITS);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    o[0] = clamp_sample(descale(tmp10 + tmp3, sh));
    o[7] = clamp_sample(descale(tmp10 - tmp3, sh));
    o[1] = clamp_sample(descale(tmp11 + tmp2, sh));
    o[6] = clamp_sample(descale(tmp11 - tmp2, sh));
    o[2] = clamp_sample(descale(tmp12 + tmp1, sh));
    o[5] = clamp_sample(descale(tmp12 - tmp1, sh));
    o[3] = clamp_sample(descale(tmp13 + tmp0, sh));
    o[4] = clamp_sample(descale(tmp13 - tmp0, sh));
  }
}

struct Jpeg {
  const uint8_t* d;
  int64_t n;
  int width = 0, height = 0, ncomp = 0, hmax = 1, vmax = 1;
  int restart_interval = 0;
  bool jfif = false, adobe = false, progressive = false;
  int adobe_transform = -1;
  bool have_frame = false;
  Component comp[4];
  int32_t qt[4][64];  // natural order
  bool qt_present[4] = {false, false, false, false};
  Huffman dc[4], ac[4];

  Jpeg(const uint8_t* data, int64_t len) : d(data), n(len) {}

  int u16(int64_t p) const {
    if (p + 1 >= n) fail("corrupt data: truncated marker segment");
    return (d[p] << 8) | d[p + 1];
  }

  void parse(bool headers_only);
  void frame(int64_t p, int len, int marker);
  void tables_dqt(int64_t p, int len);
  void tables_dht(int64_t p, int len);
  int64_t scan(int64_t p, int len);
  void decode_block(BitReader& br, Component& c, int bx, int by);
  void prog_block(BitReader& br, Component& c, int bx, int by, int ss,
                  int se, int ah, int al, int& eobrun);
  void finish_progressive();
  void cmyk_to_rgb(const std::vector<std::vector<uint8_t>>& full,
                   uint8_t* out, int64_t npix) const;
  void to_rgb(uint8_t* out);
};

void Jpeg::frame(int64_t p, int len, int marker) {
  if (have_frame) fail("corrupt data: a second frame header");
  switch (marker) {
    case 0xC0: case 0xC1: break;
    case 0xC2: progressive = true; break;
    case 0xC3: fail("lossless JPEG is not supported");
    case 0xC5: case 0xC6: case 0xC7:
      fail("hierarchical (differential) JPEG is not supported");
    default: fail("arithmetic-coded JPEG is not supported");
  }
  if (len < 8) fail("corrupt data: short frame header");
  int precision = d[p];
  if (precision != 8)
    fail(std::to_string(precision) + "-bit JPEG is not supported");
  height = u16(p + 1);
  width = u16(p + 3);
  ncomp = d[p + 5];
  if (height == 0) fail("JPEG with a DNL-defined height is not supported");
  if (width == 0) fail("corrupt data: image width 0");
  if (ncomp != 1 && ncomp != 3 && ncomp != 4)
    fail(std::to_string(ncomp) + "-component JPEG is not supported");
  if (len < 6 + 3 * ncomp) fail("corrupt data: short frame header");
  for (int i = 0; i < ncomp; ++i) {
    Component& c = comp[i];
    c.id = d[p + 6 + 3 * i];
    c.h = d[p + 7 + 3 * i] >> 4;
    c.v = d[p + 7 + 3 * i] & 15;
    c.tq = d[p + 8 + 3 * i];
    if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
      fail("corrupt data: bad sampling factors or table index");
    hmax = std::max(hmax, c.h);
    vmax = std::max(vmax, c.v);
  }
  int mcux = (width + 8 * hmax - 1) / (8 * hmax);
  int mcuy = (height + 8 * vmax - 1) / (8 * vmax);
  int blocks = 0;
  for (int i = 0; i < ncomp; ++i) {
    Component& c = comp[i];
    // jdsample.c takes integral ratios only (JERR_FRACT_SAMPLE_NOTIMPL)
    if (hmax % c.h || vmax % c.v)
      fail("JPEG sampling factors " + std::to_string(c.h) + "x" +
           std::to_string(c.v) + " of " + std::to_string(hmax) + "x" +
           std::to_string(vmax) + " are not supported");
    c.bw = mcux * c.h;
    c.bh = mcuy * c.v;
    blocks += c.h * c.v;
    for (int k = 0; k < 64; ++k) c.coef_bits[k] = -1;
  }
  // jdinput.c per_scan_setup: at most 10 blocks in an interleaved MCU
  if (ncomp > 1 && blocks > 10)
    fail("corrupt data: " + std::to_string(blocks) +
         " blocks in an MCU (JPEG allows 10)");
  have_frame = true;
}

void Jpeg::tables_dqt(int64_t p, int len) {
  int64_t end = p + len;
  while (p < end) {
    int pq = d[p] >> 4, tq = d[p] & 15;
    if (tq > 3 || pq > 1) fail("corrupt data: bad quantization table");
    ++p;
    if (p + (pq ? 128 : 64) > end) fail("corrupt data: short DQT");
    for (int k = 0; k < 64; ++k) {
      int v = pq ? ((d[p + 2 * k] << 8) | d[p + 2 * k + 1]) : d[p + k];
      qt[tq][kZigzag[k]] = v;
    }
    qt_present[tq] = true;
    p += pq ? 128 : 64;
  }
}

void Jpeg::tables_dht(int64_t p, int len) {
  int64_t end = p + len;
  while (p < end) {
    if (p + 17 > end) fail("corrupt data: short DHT");
    int tc = d[p] >> 4, th = d[p] & 15;
    if (tc > 1 || th > 3) fail("corrupt data: bad Huffman table index");
    const uint8_t* counts = d + p + 1;
    int total = 0;
    for (int i = 0; i < 16; ++i) total += counts[i];
    if (total > 256 || p + 17 + total > end)
      fail("corrupt data: bad Huffman table");
    build_huffman(tc ? ac[th] : dc[th], counts, d + p + 17, total);
    p += 17 + total;
  }
}

void Jpeg::decode_block(BitReader& br, Component& c, int bx, int by) {
  int32_t coef[64];
  std::memset(coef, 0, sizeof(coef));
  const Huffman& hd = dc[c.td];
  const Huffman& ha = ac[c.ta];
  const int32_t* q = qt[c.tq];
  int s = br.decode(hd);
  if (s > 11) fail("corrupt data: bad DC coefficient size");
  int diff = s ? extend(br.bits(s), s) : 0;
  c.dc_pred += diff;
  coef[0] = c.dc_pred * q[0];
  for (int k = 1; k < 64; ++k) {
    int rs = br.decode(ha);
    int r = rs >> 4;
    s = rs & 15;
    if (s) {
      k += r;
      int pos = kZigzag[k];
      coef[pos] = extend(br.bits(s), s) * q[pos];
    } else {
      if (r != 15) break;
      k += 15;
    }
  }
  int stride = c.bw * 8;
  idct_islow(coef, c.plane.data() + (int64_t)by * 8 * stride + bx * 8, stride);
}

int64_t Jpeg::scan(int64_t p, int len) {
  if (!have_frame) fail("corrupt data: scan before the frame header");
  int ns = d[p];
  if (ns < 1 || ns > ncomp || len < 4 + 2 * ns)
    fail("corrupt data: bad scan header");
  int ss = d[p + 1 + 2 * ns], se = d[p + 2 + 2 * ns];
  int ah = d[p + 3 + 2 * ns] >> 4, al = d[p + 3 + 2 * ns] & 15;
  if (progressive) {
    // jdphuff.c start_pass_phuff_decoder's JERR_BAD_PROGRESSION checks
    bool bad = ss == 0 ? se != 0 : (ss > se || se > 63 || ns != 1);
    if ((ah != 0 && al != ah - 1) || al > 13) bad = true;
    if (bad) fail("corrupt data: bad progressive scan parameters");
  } else if (ss != 0 || se != 63 || ah != 0 || al != 0) {
    fail("corrupt data: spectral selection in a sequential scan");
  }
  Component* sc[4];
  for (int i = 0; i < ns; ++i) {
    int cid = d[p + 1 + 2 * i];
    int tables = d[p + 2 + 2 * i];
    sc[i] = nullptr;
    for (int j = 0; j < ncomp; ++j)
      if (comp[j].id == cid) sc[i] = &comp[j];
    if (!sc[i]) fail("corrupt data: scan names an unknown component");
    sc[i]->td = tables >> 4;
    sc[i]->ta = tables & 15;
    // the tables the scan decodes with: both in a sequential scan, the DC
    // table in a first DC scan, the AC table in an AC scan
    const bool need_dc = !progressive || (ss == 0 && ah == 0);
    const bool need_ac = !progressive || ss != 0;
    if (sc[i]->td > 3 || sc[i]->ta > 3 ||
        (need_dc && !dc[sc[i]->td].present) ||
        (need_ac && !ac[sc[i]->ta].present))
      fail("corrupt data: scan uses a missing Huffman table");
    if ((need_dc && dc[sc[i]->td].bad) || (need_ac && ac[sc[i]->ta].bad))
      fail("corrupt data: bad Huffman table");
    if (!qt_present[sc[i]->tq])
      fail("corrupt data: component uses a missing quantization table");
    sc[i]->dc_pred = 0;
    if (sc[i]->plane.empty())
      sc[i]->plane.assign((size_t)sc[i]->bw * 8 * sc[i]->bh * 8, 0);
    if (!sc[i]->latched) {  // jdinput.c latch_quant_tables
      std::memcpy(sc[i]->qlatch, qt[sc[i]->tq], sizeof(sc[i]->qlatch));
      sc[i]->latched = true;
    }
    if (progressive) {
      if (sc[i]->coef.empty())
        sc[i]->coef.assign((size_t)sc[i]->bw * sc[i]->bh * 64, 0);
      for (int k = ss; k <= se; ++k) sc[i]->coef_bits[k] = al;
    }
  }
  BitReader br(d, n, p + len);
  // MCUs of the scan: interleaved, or one block each in a single-component
  // scan over that component's own blocks
  int mcux, mcuy;
  if (ns == 1) {
    Component& c = *sc[0];
    int cw = (width * c.h + hmax - 1) / hmax;
    int ch = (height * c.v + vmax - 1) / vmax;
    mcux = (cw + 7) / 8;
    mcuy = (ch + 7) / 8;
  } else {
    mcux = (width + 8 * hmax - 1) / (8 * hmax);
    mcuy = (height + 8 * vmax - 1) / (8 * vmax);
  }
  int64_t total = (int64_t)mcux * mcuy;
  int next_rst = 0, eobrun = 0;
  auto block = [&](Component& c, int bx, int by) {
    if (progressive)
      prog_block(br, c, bx, by, ss, se, ah, al, eobrun);
    else
      decode_block(br, c, bx, by);
  };
  for (int64_t m = 0; m < total; ++m) {
    if (restart_interval && m > 0 && m % restart_interval == 0) {
      br.restart(next_rst);
      next_rst = (next_rst + 1) & 7;
      for (int i = 0; i < ns; ++i) sc[i]->dc_pred = 0;
      eobrun = 0;
    }
    int mx = (int)(m % mcux), my = (int)(m / mcux);
    if (ns == 1) {
      block(*sc[0], mx, my);
    } else {
      for (int i = 0; i < ns; ++i) {
        Component& c = *sc[i];
        for (int v = 0; v < c.v; ++v)
          for (int h = 0; h < c.h; ++h) block(c, mx * c.h + h, my * c.v + v);
      }
    }
  }
  return br.end_of_scan();
}

// one block of a progressive scan (jdphuff.c decode_mcu_DC_first,
// decode_mcu_DC_refine, decode_mcu_AC_first, decode_mcu_AC_refine)
void Jpeg::prog_block(BitReader& br, Component& c, int bx, int by, int ss,
                      int se, int ah, int al, int& eobrun) {
  int16_t* blk = c.coef.data() + ((size_t)by * c.bw + bx) * 64;
  if (ss == 0) {
    if (ah == 0) {
      int s = br.decode(dc[c.td]);
      if (s > 11) fail("corrupt data: bad DC coefficient size");
      int diff = s ? extend(br.bits(s), s) : 0;
      c.dc_pred += diff;
      blk[0] = (int16_t)(c.dc_pred * (1 << al));
    } else if (br.bits(1)) {
      blk[0] = (int16_t)(blk[0] | (1 << al));
    }
    return;
  }
  const Huffman& ha = ac[c.ta];
  if (ah == 0) {
    if (eobrun > 0) {
      --eobrun;
      return;
    }
    for (int k = ss; k <= se; ++k) {
      int rs = br.decode(ha);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        blk[kZigzag[k]] = (int16_t)(extend(br.bits(s), s) * (1 << al));
      } else if (r == 15) {
        k += 15;
      } else {
        eobrun = 1 << r;
        if (r) eobrun += br.bits(r);
        --eobrun;
        break;
      }
    }
    return;
  }
  const int p1 = 1 << al, m1 = -(1 << al);
  int k = ss;
  auto refine = [&](int16_t& coef) {
    if (br.bits(1) && (coef & p1) == 0)
      coef = (int16_t)(coef + (coef >= 0 ? p1 : m1));
  };
  if (eobrun == 0) {
    for (; k <= se; ++k) {
      int rs = br.decode(ha);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        // a newly nonzero coefficient is +-1 at this bit (libjpeg warns
        // on another size and goes on)
        s = br.bits(1) ? p1 : m1;
      } else if (r != 15) {
        eobrun = 1 << r;
        if (r) eobrun += br.bits(r);
        break;
      }
      // step over r zero coefficients, refining the nonzero ones passed
      do {
        int16_t& coef = blk[kZigzag[k]];
        if (coef != 0) {
          refine(coef);
        } else if (--r < 0) {
          break;
        }
        ++k;
      } while (k <= se);
      if (s) blk[kZigzag[k]] = (int16_t)s;
    }
  }
  if (eobrun > 0) {
    for (; k <= se; ++k) {
      int16_t& coef = blk[kZigzag[k]];
      if (coef != 0) refine(coef);
    }
    --eobrun;
  }
}

// after the last scan of a progressive file: each block dequantized with
// its component's latched table and transformed
void Jpeg::finish_progressive() {
  for (int i = 0; i < ncomp; ++i) {
    Component& c = comp[i];
    if (c.coef.empty()) continue;
    // jdcoefct.c smoothing_ok: coefficients 1-9 not all at full precision
    // switch on block smoothing, which is not ported
    for (int k = 1; k <= 9; ++k)
      if (c.coef_bits[0] >= 0 && c.coef_bits[k] != 0)
        fail("progressive JPEG whose scans leave coefficients incomplete "
             "(libjpeg's block smoothing) is not supported");
    const int stride = c.bw * 8;
    int32_t deq[64];
    for (int by = 0; by < c.bh; ++by)
      for (int bx = 0; bx < c.bw; ++bx) {
        const int16_t* blk = c.coef.data() + ((size_t)by * c.bw + bx) * 64;
        for (int k = 0; k < 64; ++k) deq[k] = blk[k] * c.qlatch[k];
        idct_islow(deq, c.plane.data() + (int64_t)by * 8 * stride + bx * 8,
                   stride);
      }
  }
}

void Jpeg::parse(bool headers_only) {
  if (n < 4 || d[0] != 0xFF || d[1] != 0xD8) fail("not a JPEG file");
  int64_t p = 2;
  bool scanned = false;
  while (true) {
    // next marker, skipping fill bytes
    while (p < n && d[p] != 0xFF) ++p;
    while (p < n && d[p] == 0xFF) ++p;
    if (p >= n) {
      if (scanned) {  // a missing EOI: what was decoded stands
        if (progressive) finish_progressive();
        return;
      }
      fail("corrupt data: no image data");
    }
    int marker = d[p++];
    if (marker == 0xD9) {
      if (!scanned) fail("corrupt data: no image data");
      if (progressive) finish_progressive();
      return;
    }
    if (marker >= 0xD0 && marker <= 0xD7) continue;  // a stray RST
    if (marker == 0x01) continue;
    int len = u16(p);
    if (len < 2 || p + len > n) fail("corrupt data: bad marker length");
    int64_t body = p + 2;
    int blen = len - 2;
    if ((marker >= 0xC0 && marker <= 0xCF) && marker != 0xC4 &&
        marker != 0xC8 && marker != 0xCC) {
      frame(body, blen, marker);
      if (headers_only) return;
    } else if (marker == 0xC4) {
      tables_dht(body, blen);
    } else if (marker == 0xCC) {
      fail("arithmetic-coded JPEG is not supported");
    } else if (marker == 0xDB) {
      tables_dqt(body, blen);
    } else if (marker == 0xDD) {
      if (blen < 2) fail("corrupt data: short DRI");
      restart_interval = u16(body);
    } else if (marker == 0xDC) {
      fail("JPEG with a DNL marker is not supported");
    } else if (marker == 0xE0) {
      if (blen >= 14 && !std::memcmp(d + body, "JFIF\0", 5)) jfif = true;
    } else if (marker == 0xEE) {
      if (blen >= 12 && !std::memcmp(d + body, "Adobe", 5)) {
        adobe = true;
        adobe_transform = d[body + 11];
      }
    } else if (marker == 0xDA) {
      p = scan(body, blen);
      scanned = true;
      continue;
    }
    p += len;
  }
}

// jdcolor.c build_ycc_rgb_table: Cr_r, Cb_b, Cr_g and Cb_g (the last with
// the rounding half folded in)
struct YccTables {
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  YccTables() {
    const int SCALEBITS = 16;
    const int64_t ONE_HALF = (int64_t)1 << (SCALEBITS - 1);
    auto fix = [](double x) { return (int64_t)(x * (1L << 16) + 0.5); };
    for (int i = 0; i < 256; ++i) {
      int64_t x = i - 128;
      cr_r[i] = (int)((fix(1.40200) * x + ONE_HALF) >> SCALEBITS);
      cb_b[i] = (int)((fix(1.77200) * x + ONE_HALF) >> SCALEBITS);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + ONE_HALF;
    }
  }
};

inline uint8_t lim8(int v) {
  return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v));
}

// four components: YCCK -> CMYK (jdcolor.c ycck_cmyk_convert) where the
// Adobe marker says so, then PIL's "CMYK;I" raw mode (inverted) and its
// Convert.c cmyk2rgb, MULDIV255 included
void Jpeg::cmyk_to_rgb(const std::vector<std::vector<uint8_t>>& full,
                       uint8_t* out, int64_t npix) const {
  const bool ycck = adobe && adobe_transform != 0;
  static const YccTables t;
  const uint8_t* c0 = full[0].data();
  const uint8_t* c1 = full[1].data();
  const uint8_t* c2 = full[2].data();
  const uint8_t* c3 = full[3].data();
  auto muldiv255 = [](int a, int b) {
    int tmp = a * b + 128;
    return ((tmp >> 8) + tmp) >> 8;
  };
  for (int64_t i = 0; i < npix; ++i) {
    int c = c0[i], m = c1[i], y = c2[i];
    if (ycck) {
      int yy = c0[i], cb = c1[i], cr = c2[i];
      c = lim8(255 - (yy + t.cr_r[cr]));
      m = lim8(255 - (yy + (int)((t.cb_g[cb] + t.cr_g[cr]) >> 16)));
      y = lim8(255 - (yy + t.cb_b[cb]));
    }
    // inverted on the way in ("CMYK;I"), then cmyk2rgb
    const int ci = 255 - c, mi = 255 - m, yi = 255 - y, ki = 255 - c3[i];
    const int nk = 255 - ki;
    out[3 * i] = lim8(nk - muldiv255(ci, nk));
    out[3 * i + 1] = lim8(nk - muldiv255(mi, nk));
    out[3 * i + 2] = lim8(nk - muldiv255(yi, nk));
  }
}

void Jpeg::to_rgb(uint8_t* out) {
  const int W = width, H = height;
  // each component upsampled to W x H
  std::vector<std::vector<uint8_t>> full(ncomp);
  for (int i = 0; i < ncomp; ++i) {
    Component& c = comp[i];
    if (c.plane.empty()) fail("corrupt data: a component has no scan");
    const int stride = c.bw * 8;
    const int rh = hmax / c.h, rv = vmax / c.v;
    const int cw = (W * c.h + hmax - 1) / hmax;  // downsampled_width
    const int ch = (H * c.v + vmax - 1) / vmax;  // downsampled_height
    std::vector<uint8_t>& f = full[i];
    f.assign((size_t)W * H, 0);
    auto row = [&](int r) {
      r = std::max(0, std::min(r, ch - 1));
      return c.plane.data() + (int64_t)r * stride;
    };
    std::vector<uint8_t> line((size_t)rh * stride + 2);
    std::vector<int> colsum((size_t)stride + 1);
    // jdsample.c's choice: the fancy h2v1 / h2v2 methods for components
    // wider than 2 samples, h1v2 always, plain replication for every
    // other ratio (h2v1 / h2v2 at most 2 wide, and int_upsample)
    const bool fancy = (rh == 1 && rv == 1) || (rh == 1 && rv == 2) ||
                       ((rh == 2 && rv <= 2) && cw > 2);
    for (int y = 0; y < H; ++y) {
      uint8_t* o = line.data();
      if (!fancy) {
        const uint8_t* in = row(y / rv);
        for (int x = 0; x < cw; ++x)
          for (int k = 0; k < rh; ++k) o[rh * x + k] = in[x];
      } else if (rv == 1) {
        const uint8_t* in = row(y);
        if (rh == 1) {
          std::memcpy(o, in, W);
        } else {  // h2v1
          int v = in[0];
          o[0] = (uint8_t)v;
          o[1] = (uint8_t)((v * 3 + in[1] + 2) >> 2);
          int x = 1;
          for (; x < cw - 1; ++x) {
            v = in[x] * 3;
            o[2 * x] = (uint8_t)((v + in[x - 1] + 1) >> 2);
            o[2 * x + 1] = (uint8_t)((v + in[x + 1] + 2) >> 2);
          }
          x = std::max(cw - 1, 1);
          v = in[x];
          o[2 * x] = (uint8_t)((v * 3 + in[x - 1] + 1) >> 2);
          o[2 * x + 1] = (uint8_t)v;
        }
      } else {
        const int iy = y >> 1, vv = y & 1;
        const uint8_t* in0 = row(iy);
        const uint8_t* in1 = row(vv ? iy + 1 : iy - 1);
        if (rh == 1) {  // h1v2
          const int bias = vv ? 2 : 1;
          for (int x = 0; x < cw; ++x)
            o[x] = (uint8_t)((in0[x] * 3 + in1[x] + bias) >> 2);
        } else {  // h2v2
          const int ncols = std::max(cw, 2);
          for (int x = 0; x < ncols; ++x) colsum[x] = in0[x] * 3 + in1[x];
          int t = colsum[0], nx = colsum[1], last;
          o[0] = (uint8_t)((t * 4 + 8) >> 4);
          o[1] = (uint8_t)((t * 3 + nx + 7) >> 4);
          last = t;
          t = nx;
          int x = 1;
          for (int k = cw - 2; k > 0; --k, ++x) {
            nx = colsum[x + 1];
            o[2 * x] = (uint8_t)((t * 3 + last + 8) >> 4);
            o[2 * x + 1] = (uint8_t)((t * 3 + nx + 7) >> 4);
            last = t;
            t = nx;
          }
          o[2 * x] = (uint8_t)((t * 3 + last + 8) >> 4);
          o[2 * x + 1] = (uint8_t)((t * 4 + 7) >> 4);
        }
      }
      std::memcpy(f.data() + (int64_t)y * W, o, W);
    }
  }
  const int64_t npix = (int64_t)W * H;
  if (ncomp == 4) {
    cmyk_to_rgb(full, out, npix);
    return;
  }
  if (ncomp == 1) {
    const uint8_t* g = full[0].data();
    for (int64_t i = 0; i < npix; ++i)
      out[3 * i] = out[3 * i + 1] = out[3 * i + 2] = g[i];
    return;
  }
  bool rgb;
  if (jfif) {
    rgb = false;
  } else if (adobe) {
    rgb = adobe_transform == 0;
  } else {
    rgb = comp[0].id == 82 && comp[1].id == 71 && comp[2].id == 66;
  }
  const uint8_t* c0 = full[0].data();
  const uint8_t* c1 = full[1].data();
  const uint8_t* c2 = full[2].data();
  if (rgb) {
    for (int64_t i = 0; i < npix; ++i) {
      out[3 * i] = c0[i];
      out[3 * i + 1] = c1[i];
      out[3 * i + 2] = c2[i];
    }
    return;
  }
  static const YccTables t;
  for (int64_t i = 0; i < npix; ++i) {
    int y = c0[i], cb = c1[i], cr = c2[i];
    out[3 * i] = lim8(y + t.cr_r[cr]);
    out[3 * i + 1] = lim8(y + (int)((t.cb_g[cb] + t.cr_g[cr]) >> 16));
    out[3 * i + 2] = lim8(y + t.cb_b[cb]);
  }
}

void set_err(char* err, int errlen, const std::string& msg) {
  if (errlen > 0) {
    std::snprintf(err, (size_t)errlen, "%s", msg.c_str());
  }
}

inline int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  if (pb <= pc) return b;
  return c;
}

}  // namespace

extern "C" {

// (height, width, components) of a JPEG from its frame header
int flmm_jpeg_info(const uint8_t* data, int64_t n, int* hwc, char* err,
                   int errlen) {
  try {
    Jpeg j(data, n);
    j.parse(true);
    if (!j.have_frame) fail("corrupt data: no frame header");
    hwc[0] = j.height;
    hwc[1] = j.width;
    hwc[2] = j.ncomp;
    return 0;
  } catch (const Error& e) {
    set_err(err, errlen, e.msg);
    return 1;
  }
}

// the whole image as (height, width, 3) uint8 RGB; grey is replicated
int flmm_jpeg_decode(const uint8_t* data, int64_t n, uint8_t* out,
                     char* err, int errlen) {
  try {
    Jpeg j(data, n);
    j.parse(false);
    j.to_rgb(out);
    return 0;
  } catch (const Error& e) {
    set_err(err, errlen, e.msg);
    return 1;
  } catch (const std::bad_alloc&) {
    set_err(err, errlen, "out of memory");
    return 2;
  }
}

// PNG: undo the row filters of `rows` rows of `rowbytes` bytes, each led
// by its filter-type byte in `data`, into `out` (rows x rowbytes); `bpp` is
// the bytes a pixel (at least 1)
int flmm_png_unfilter(const uint8_t* data, int rows, int rowbytes, int bpp,
                      uint8_t* out, char* err, int errlen) {
  for (int y = 0; y < rows; ++y) {
    const uint8_t* in = data + (int64_t)y * (rowbytes + 1);
    int ft = in[0];
    ++in;
    uint8_t* o = out + (int64_t)y * rowbytes;
    const uint8_t* up = y ? o - rowbytes : nullptr;
    switch (ft) {
      case 0:
        std::memcpy(o, in, rowbytes);
        break;
      case 1:
        for (int x = 0; x < rowbytes; ++x)
          o[x] = (uint8_t)(in[x] + (x >= bpp ? o[x - bpp] : 0));
        break;
      case 2:
        for (int x = 0; x < rowbytes; ++x)
          o[x] = (uint8_t)(in[x] + (up ? up[x] : 0));
        break;
      case 3:
        for (int x = 0; x < rowbytes; ++x) {
          int a = x >= bpp ? o[x - bpp] : 0, b = up ? up[x] : 0;
          o[x] = (uint8_t)(in[x] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (int x = 0; x < rowbytes; ++x) {
          int a = x >= bpp ? o[x - bpp] : 0, b = up ? up[x] : 0;
          int c = (x >= bpp && up) ? up[x - bpp] : 0;
          o[x] = (uint8_t)(in[x] + paeth(a, b, c));
        }
        break;
      default:
        set_err(err, errlen, "corrupt data: PNG filter type " +
                                 std::to_string(ft) + " in row " +
                                 std::to_string(y));
        return 1;
    }
  }
  return 0;
}

}  // extern "C"
