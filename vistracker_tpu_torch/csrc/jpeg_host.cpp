// Baseline JPEG decoder and encoder for the host CPU, loaded through ctypes
// by data/imageio.py. This is host code standing in for libjpeg, not a
// device kernel: the entropy coder is serial.
//
// The arithmetic is libjpeg's (as libjpeg-turbo runs it by default, which
// is what PIL decodes and encodes with), so that the port reads and writes
// the same pixels and bytes without PIL:
//   decode  Huffman baseline (SOF0), 1 component or 3 YCbCr ones, luma
//           sampling 1x1, 2x1 or 2x2 with 1x1 chroma, restart intervals;
//           the integer "islow" IDCT (jidctint.c) with its range-limit
//           table, "fancy" triangular chroma upsampling (jdsample.c) and
//           the fixed-point YCbCr->RGB tables (jdcolor.c). Progressive,
//           arithmetic-coded, lossless, hierarchical, extended, 12-bit,
//           CMYK, RGB-coded and multi-scan files are refused by name.
//   encode  8-bit L (one component) or RGB (YCbCr 4:2:0), the IJG
//           quantization tables scaled as jpeg_set_quality scales them, the
//           islow FDCT (jfdctint.c) with libjpeg-turbo's reciprocal
//           quantization, h2v2 downsampling with its alternating bias
//           (jcsample.c), edge replication and dummy blocks as jcprepct.c
//           and jccoefct.c make them, the standard Huffman tables, and a
//           JFIF 1.01 APP0 header.
//
// Interface (plain C; 0 or a size on success, negative on error with a
// message in `err`):
//   vt_jpeg_info(data, n, &w, &h, &comps, err, errlen)
//   vt_jpeg_decode(data, n, out, err, errlen)     out: h*w*comps bytes
//   vt_jpeg_encode(pix, w, h, comps, quality, &out, &size, err, errlen)
//   vt_jpeg_free(out)
#include <algorithm>
#include <cstdarg>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct JpegError : std::runtime_error {
  using std::runtime_error::runtime_error;
};

[[noreturn]] void fail(const char* fmt, ...) {
  char buf[256];
  va_list ap;
  va_start(ap, fmt);
  vsnprintf(buf, sizeof buf, fmt, ap);
  va_end(ap);
  throw JpegError(buf);
}

int report(const JpegError& e, char* err, int errlen) {
  if (err && errlen > 0) snprintf(err, (size_t)errlen, "%s", e.what());
  return -1;
}

// zigzag index -> natural (row-major) index
struct ZigZag {
  int nat[64 + 16];
  ZigZag() {
    int i = 0, r = 0, c = 0;
    for (int s = 0; s < 15; ++s) {
      if (s % 2 == 0) {  // up-right
        for (r = std::min(s, 7); r >= 0 && s - r <= 7; --r) nat[i++] = r * 8 + (s - r);
      } else {           // down-left
        for (c = std::min(s, 7); c >= 0 && s - c <= 7; --c) nat[i++] = (s - c) * 8 + c;
      }
    }
    for (; i < 64 + 16; ++i) nat[i] = 63;  // overrun guard, as libjpeg's
  }
};
const ZigZag kZig;

// ---------------------------------------------------------------------------
// fixed-point constants of jidctint.c / jfdctint.c
// ---------------------------------------------------------------------------
constexpr int CONST_BITS = 13;
constexpr int PASS1_BITS = 2;
constexpr int64_t FIX_0_298631336 = 2446;
constexpr int64_t FIX_0_390180644 = 3196;
constexpr int64_t FIX_0_541196100 = 4433;
constexpr int64_t FIX_0_765366865 = 6270;
constexpr int64_t FIX_0_899976223 = 7373;
constexpr int64_t FIX_1_175875602 = 9633;
constexpr int64_t FIX_1_501321110 = 12299;
constexpr int64_t FIX_1_847759065 = 15137;
constexpr int64_t FIX_1_961570560 = 16069;
constexpr int64_t FIX_2_053119869 = 16819;
constexpr int64_t FIX_2_562915447 = 20995;
constexpr int64_t FIX_3_072711026 = 25172;

inline int64_t descale(int64_t x, int n) { return (x + ((int64_t)1 << (n - 1))) >> n; }

// post-IDCT range limit: index (x & 1023) for an IDCT value x centered at 0
struct RangeLimit {
  uint8_t idct[1024];
  RangeLimit() {
    for (int i = 0; i < 1024; ++i) {
      if (i < 128) idct[i] = (uint8_t)(i + 128);
      else if (i < 512) idct[i] = 255;
      else if (i < 896) idct[i] = 0;
      else idct[i] = (uint8_t)(i - 896);
    }
  }
};
const RangeLimit kRange;

// jidctint.c jpeg_idct_islow: coef (natural order) * quant -> 8x8 samples
void idct_islow(const int16_t* coef, const uint16_t* q, uint8_t* out, int stride) {
  int ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* in = coef + c;
    const uint16_t* qq = q + c;
    auto dq = [&](int k) { return (int64_t)in[8 * k] * qq[8 * k]; };
    if (!in[8] && !in[16] && !in[24] && !in[32] && !in[40] && !in[48] && !in[56]) {
      int dc = (int)(dq(0) * (1 << PASS1_BITS));
      for (int k = 0; k < 8; ++k) ws[8 * k + c] = dc;
      continue;
    }
    int64_t z2 = dq(2), z3 = dq(6);
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * (-FIX_1_847759065);
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = dq(0);
    z3 = dq(4);
    int64_t tmp0 = (z2 + z3) * (1 << CONST_BITS);
    int64_t tmp1 = (z2 - z3) * (1 << CONST_BITS);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = dq(7);
    tmp1 = dq(5);
    tmp2 = dq(3);
    tmp3 = dq(1);
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
    const int s = CONST_BITS - PASS1_BITS;
    ws[8 * 0 + c] = (int)descale(tmp10 + tmp3, s);
    ws[8 * 7 + c] = (int)descale(tmp10 - tmp3, s);
    ws[8 * 1 + c] = (int)descale(tmp11 + tmp2, s);
    ws[8 * 6 + c] = (int)descale(tmp11 - tmp2, s);
    ws[8 * 2 + c] = (int)descale(tmp12 + tmp1, s);
    ws[8 * 5 + c] = (int)descale(tmp12 - tmp1, s);
    ws[8 * 3 + c] = (int)descale(tmp13 + tmp0, s);
    ws[8 * 4 + c] = (int)descale(tmp13 - tmp0, s);
  }
  for (int r = 0; r < 8; ++r) {
    const int* w = ws + 8 * r;
    uint8_t* o = out + (size_t)r * stride;
    const int s = CONST_BITS + PASS1_BITS + 3;
    if (!w[1] && !w[2] && !w[3] && !w[4] && !w[5] && !w[6] && !w[7]) {
      uint8_t v = kRange.idct[descale(w[0], PASS1_BITS + 3) & 1023];
      for (int k = 0; k < 8; ++k) o[k] = v;
      continue;
    }
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * (-FIX_1_847759065);
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
    o[0] = kRange.idct[descale(tmp10 + tmp3, s) & 1023];
    o[7] = kRange.idct[descale(tmp10 - tmp3, s) & 1023];
    o[1] = kRange.idct[descale(tmp11 + tmp2, s) & 1023];
    o[6] = kRange.idct[descale(tmp11 - tmp2, s) & 1023];
    o[2] = kRange.idct[descale(tmp12 + tmp1, s) & 1023];
    o[5] = kRange.idct[descale(tmp12 - tmp1, s) & 1023];
    o[3] = kRange.idct[descale(tmp13 + tmp0, s) & 1023];
    o[4] = kRange.idct[descale(tmp13 - tmp0, s) & 1023];
  }
}

// jdcolor.c build_ycc_rgb_table
struct YccTables {
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  YccTables() {
    const int SB = 16;
    const int64_t HALF = (int64_t)1 << (SB - 1);
    auto fix = [](double x) { return (int64_t)(x * 65536.0 + 0.5); };
    for (int i = 0; i < 256; ++i) {
      int64_t x = i - 128;
      cr_r[i] = (int)((fix(1.40200) * x + HALF) >> SB);
      cb_b[i] = (int)((fix(1.77200) * x + HALF) >> SB);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + HALF;
    }
  }
};
const YccTables kYcc;

inline uint8_t clamp255(int v) { return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v)); }

// ---------------------------------------------------------------------------
// decoder
// ---------------------------------------------------------------------------
struct HuffDec {
  bool present = false;
  uint8_t bits[17] = {0};
  uint8_t vals[256] = {0};
  int maxcode[18];
  int valptr[17];
  int mincode[17];
  uint16_t look[1 << 9];  // (nbits << 8) | symbol for codes of <= 9 bits, 0 if longer

  void build() {
    int code = 0, k = 0;
    for (int l = 1; l <= 16; ++l) {
      valptr[l] = k;
      mincode[l] = code;
      code += bits[l];
      k += bits[l];
      maxcode[l] = bits[l] ? code - 1 : -1;
      code <<= 1;
    }
    maxcode[17] = 0x7fffffff;
    std::memset(look, 0, sizeof look);
    code = 0;
    k = 0;
    for (int l = 1; l <= 9; ++l) {
      for (int i = 0; i < bits[l]; ++i, ++k, ++code) {
        int shift = 9 - l;
        for (int f = 0; f < (1 << shift); ++f)
          look[(code << shift) | f] = (uint16_t)((l << 8) | vals[k]);
      }
      code <<= 1;
    }
  }
};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;
  int bw = 0, bh = 0;  // blocks across/down in the component plane
  int dw = 0, dh = 0;  // downsampled width/height (real samples)
  int pred = 0;
  std::vector<uint8_t> plane;
};

struct Decoder {
  const uint8_t* d;
  size_t n, pos = 0;
  int width = 0, height = 0, ncomp = 0, precision = 8;
  bool sof_seen = false, jfif = false, adobe = false;
  int adobe_transform = -1;
  int restart_interval = 0;
  uint16_t qt[4][64];
  bool qt_present[4] = {false, false, false, false};
  HuffDec dc[4], ac[4];
  Component comp[3];
  int hmax = 1, vmax = 1;
  bool scanned = false;

  // bit reader
  uint64_t acc = 0;
  int nacc = 0;
  bool hit_marker = false;

  Decoder(const uint8_t* data, size_t size) : d(data), n(size) {}

  int u8() {
    if (pos >= n) fail("truncated JPEG");
    return d[pos++];
  }
  int u16() {
    int a = u8();
    return (a << 8) | u8();
  }

  void read_header_until_sos(bool stop_at_sof);

  void fill() {
    while (nacc <= 56) {
      int b = 0;
      if (!hit_marker && pos < n) {
        b = d[pos];
        if (b == 0xFF) {
          int nx = pos + 1 < n ? d[pos + 1] : 0xD9;
          if (nx == 0x00) {
            pos += 2;
          } else {
            hit_marker = true;  // a marker: feed zeros, as libjpeg does
            b = 0;
          }
        } else {
          ++pos;
        }
      }
      acc |= (uint64_t)b << (56 - nacc);
      nacc += 8;
    }
  }
  int get_bits(int k) {
    if (k == 0) return 0;
    if (nacc < k) fill();
    int v = (int)(acc >> (64 - k));
    acc <<= k;
    nacc -= k;
    return v;
  }
  int get_bit() { return get_bits(1); }
  int decode(const HuffDec& t) {
    if (nacc < 16) fill();
    int peek = (int)(acc >> (64 - 9));
    uint16_t e = t.look[peek];
    if (e) {
      int l = e >> 8;
      acc <<= l;
      nacc -= l;
      return e & 0xFF;
    }
    int code = get_bits(10);
    int l = 10;
    while (l <= 16 && code > t.maxcode[l]) {
      code = (code << 1) | get_bit();
      ++l;
    }
    if (l > 16) fail("corrupt JPEG data: bad Huffman code");
    return t.vals[t.valptr[l] + code - t.mincode[l]];
  }
  static int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

  void reset_bits() {
    acc = 0;
    nacc = 0;
    hit_marker = false;
  }

  void process_restart(int expected) {
    // drop the partial byte, then expect RSTn
    reset_bits();
    while (pos + 1 < n && !(d[pos] == 0xFF && d[pos + 1] != 0x00 && d[pos + 1] != 0xFF)) ++pos;
    if (pos + 1 >= n) fail("corrupt JPEG data: missing restart marker");
    int m = d[pos + 1];
    if (m != 0xD0 + expected) fail("corrupt JPEG data: restart marker 0x%02X, expected 0x%02X", m, 0xD0 + expected);
    pos += 2;
    for (int c = 0; c < ncomp; ++c) comp[c].pred = 0;
  }

  void decode_block(Component& c, int16_t* blk) {
    std::memset(blk, 0, 64 * sizeof(int16_t));
    int t = decode(dc[c.td]);
    int diff = t ? extend(get_bits(t), t) : 0;
    c.pred += diff;
    blk[0] = (int16_t)c.pred;
    const HuffDec& A = ac[c.ta];
    for (int k = 1; k < 64;) {
      int rs = decode(A);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        blk[kZig.nat[k]] = (int16_t)extend(get_bits(s), s);
        ++k;
      } else {
        if (r != 15) break;
        k += 16;
      }
    }
  }

  void scan(const std::vector<int>& order) {
    for (int i : order) {
      Component& c = comp[i];
      if (!dc[c.td].present || !ac[c.ta].present) fail("corrupt JPEG data: scan uses an undefined Huffman table");
      if (!qt_present[c.tq]) fail("corrupt JPEG data: undefined quantization table %d", c.tq);
    }
    int16_t blk[64];
    int mcux, mcuy;
    bool single = order.size() == 1;
    if (single) {
      Component& c = comp[order[0]];
      mcux = (c.dw + 7) / 8;
      mcuy = (c.dh + 7) / 8;
    } else {
      mcux = (width + 8 * hmax - 1) / (8 * hmax);
      mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    }
    int mcu = 0, rst = 0;
    for (int c = 0; c < ncomp; ++c) comp[c].pred = 0;
    reset_bits();
    for (int my = 0; my < mcuy; ++my) {
      for (int mx = 0; mx < mcux; ++mx) {
        if (restart_interval && mcu && mcu % restart_interval == 0) {
          process_restart(rst);
          rst = (rst + 1) & 7;
        }
        ++mcu;
        for (int i : order) {
          Component& c = comp[i];
          int hs = single ? 1 : c.h, vs = single ? 1 : c.v;
          for (int by = 0; by < vs; ++by) {
            for (int bx = 0; bx < hs; ++bx) {
              decode_block(c, blk);
              int row = (my * vs + by) * 8, col = (mx * hs + bx) * 8;
              int stride = c.bw * 8;
              idct_islow(blk, qt[c.tq], c.plane.data() + (size_t)row * stride + col, stride);
            }
          }
        }
      }
    }
    // step past the entropy data to the next marker
    reset_bits();
    while (pos + 1 < n && !(d[pos] == 0xFF && d[pos + 1] != 0x00 && !(d[pos + 1] >= 0xD0 && d[pos + 1] <= 0xD7) && d[pos + 1] != 0xFF)) ++pos;
  }

  void run(bool header_only);
};

void Decoder::run(bool header_only) {
  if (n < 4 || d[0] != 0xFF || d[1] != 0xD8) fail("not a JPEG file (no SOI marker)");
  pos = 2;
  for (;;) {
    // find the next marker
    while (pos < n && d[pos] != 0xFF) ++pos;
    while (pos < n && d[pos] == 0xFF) ++pos;
    if (pos >= n) {
      if (scanned) return;
      fail("truncated JPEG: no image data");
    }
    int m = d[pos++];
    if (m == 0xD9) {
      if (!scanned) fail("corrupt JPEG: EOI before image data");
      return;
    }
    if (m >= 0xD0 && m <= 0xD7) continue;
    int len = u16();
    if (len < 2 || pos + (size_t)len - 2 > n) fail("truncated JPEG segment");
    size_t end = pos + len - 2;
    switch (m) {
      case 0xC0: {
        if (sof_seen) fail("corrupt JPEG: two SOF markers");
        sof_seen = true;
        precision = u8();
        if (precision != 8) fail("%d-bit JPEG is not supported (8-bit only)", precision);
        height = u16();
        width = u16();
        ncomp = u8();
        if (ncomp == 4) fail("CMYK (4-component) JPEG is not supported");
        if (ncomp != 1 && ncomp != 3) fail("%d-component JPEG is not supported", ncomp);
        if (width <= 0 || height <= 0) fail("JPEG without a size (DNL) is not supported");
        for (int c = 0; c < ncomp; ++c) {
          comp[c].id = u8();
          int hv = u8();
          comp[c].h = hv >> 4;
          comp[c].v = hv & 15;
          comp[c].tq = u8();
          if (comp[c].tq > 3) fail("corrupt JPEG: quantization table %d", comp[c].tq);
        }
        if (ncomp == 1) {
          comp[0].h = comp[0].v = 1;
        } else {
          for (int c = 1; c < 3; ++c)
            if (comp[c].h != 1 || comp[c].v != 1) fail("chroma sampling %dx%d is not supported", comp[c].h, comp[c].v);
          int h = comp[0].h, v = comp[0].v;
          if (!((h == 1 && v == 1) || (h == 2 && v == 1) || (h == 2 && v == 2)))
            fail("luma sampling %dx%d is not supported (1x1, 2x1 or 2x2)", h, v);
        }
        hmax = vmax = 1;
        for (int c = 0; c < ncomp; ++c) {
          hmax = std::max(hmax, comp[c].h);
          vmax = std::max(vmax, comp[c].v);
        }
        int mcux = (width + 8 * hmax - 1) / (8 * hmax);
        int mcuy = (height + 8 * vmax - 1) / (8 * vmax);
        for (int c = 0; c < ncomp; ++c) {
          Component& k = comp[c];
          k.dw = (width * k.h + hmax - 1) / hmax;
          k.dh = (height * k.v + vmax - 1) / vmax;
          k.bw = mcux * k.h;
          k.bh = mcuy * k.v;
        }
        if (header_only) return;
        for (int c = 0; c < ncomp; ++c) comp[c].plane.assign((size_t)comp[c].bw * 8 * comp[c].bh * 8, 0);
        break;
      }
      case 0xC1:
        fail("extended-sequential (SOF1) JPEG is not supported (baseline only)");
      case 0xC2:
      case 0xC6:
      case 0xCA:
      case 0xCE:
        fail("progressive JPEG is not supported (baseline only)");
      case 0xC3:
      case 0xC7:
      case 0xCB:
      case 0xCF:
        fail("lossless JPEG is not supported (baseline only)");
      case 0xC5:
        fail("hierarchical JPEG is not supported (baseline only)");
      case 0xC9:
      case 0xCD:
        fail("arithmetic-coded JPEG is not supported (Huffman baseline only)");
      case 0xC4: {
        while (pos < end) {
          int tc = u8();
          int cls = tc >> 4, id = tc & 15;
          if (cls > 1 || id > 3) fail("corrupt JPEG: Huffman table class %d id %d", cls, id);
          HuffDec& t = cls ? ac[id] : dc[id];
          int total = 0;
          t.bits[0] = 0;
          for (int l = 1; l <= 16; ++l) total += (t.bits[l] = (uint8_t)u8());
          if (total > 256) fail("corrupt JPEG: Huffman table too long");
          for (int i = 0; i < total; ++i) t.vals[i] = (uint8_t)u8();
          t.present = true;
          t.build();
        }
        break;
      }
      case 0xDB: {
        while (pos < end) {
          int pq = u8();
          int p = pq >> 4, id = pq & 15;
          if (id > 3) fail("corrupt JPEG: quantization table id %d", id);
          for (int i = 0; i < 64; ++i) qt[id][kZig.nat[i]] = (uint16_t)(p ? u16() : u8());
          qt_present[id] = true;
        }
        break;
      }
      case 0xDD:
        restart_interval = u16();
        break;
      case 0xDA: {
        if (!sof_seen) fail("corrupt JPEG: SOS before SOF");
        if (scanned) fail("multi-scan JPEG is not supported (one interleaved baseline scan only)");
        int ns = u8();
        std::vector<int> order;
        for (int i = 0; i < ns; ++i) {
          int cid = u8(), tt = u8();
          int idx = -1;
          for (int c = 0; c < ncomp; ++c)
            if (comp[c].id == cid) idx = c;
          if (idx < 0) fail("corrupt JPEG: scan names an unknown component");
          comp[idx].td = tt >> 4;
          comp[idx].ta = tt & 15;
          if (comp[idx].td > 3 || comp[idx].ta > 3) fail("corrupt JPEG: Huffman table id");
          order.push_back(idx);
        }
        int ss = u8(), se = u8(), a = u8();
        if (ss != 0 || se != 63 || a != 0) fail("progressive JPEG is not supported (baseline only)");
        if (ns != ncomp) fail("multi-scan JPEG is not supported (one interleaved baseline scan only)");
        pos = end;
        scan(order);
        scanned = true;
        continue;
      }
      case 0xE0:
        if (len >= 7 && !std::memcmp(d + pos, "JFIF\0", 5)) jfif = true;
        break;
      case 0xEE:
        if (len >= 14 && !std::memcmp(d + pos, "Adobe", 5)) {
          adobe = true;
          adobe_transform = d[pos + 11];
        }
        break;
      default:
        break;  // APPn, COM and others: skipped
    }
    pos = end;
  }
}

bool is_rgb_coded(const Decoder& dec) {
  // jdapimin.c default_decompress_parms for 3 components
  if (dec.jfif) return false;
  if (dec.adobe) return dec.adobe_transform == 0;
  const Component* c = dec.comp;
  return c[0].id == 'R' && c[1].id == 'G' && c[2].id == 'B';
}

// jdsample.c: upsample one chroma plane to (vmax*dh rows, hmax*dw cols)
std::vector<uint8_t> upsample(const Component& c, int hmax, int vmax) {
  const int dw = c.dw, dh = c.dh, stride = c.bw * 8;
  const int ow = dw * hmax, oh = dh * vmax;
  std::vector<uint8_t> out((size_t)ow * oh);
  auto in = [&](int r, int x) -> int {
    r = std::max(0, std::min(r, dh - 1));  // context rows: edge rows repeat
    return c.plane[(size_t)r * stride + x];
  };
  if (hmax == 1 && vmax == 1) {
    for (int r = 0; r < dh; ++r) std::memcpy(&out[(size_t)r * ow], &c.plane[(size_t)r * stride], dw);
  } else if (hmax == 2 && vmax == 1) {
    for (int r = 0; r < dh; ++r) {
      uint8_t* o = &out[(size_t)r * ow];
      if (dw > 2) {  // h2v1_fancy_upsample
        int v = in(r, 0);
        o[0] = (uint8_t)v;
        o[1] = (uint8_t)((v * 3 + in(r, 1) + 2) >> 2);
        for (int x = 1; x < dw - 1; ++x) {
          int t = in(r, x) * 3;
          o[2 * x] = (uint8_t)((t + in(r, x - 1) + 1) >> 2);
          o[2 * x + 1] = (uint8_t)((t + in(r, x + 1) + 2) >> 2);
        }
        v = in(r, dw - 1);
        o[2 * dw - 2] = (uint8_t)((v * 3 + in(r, dw - 2) + 1) >> 2);
        o[2 * dw - 1] = (uint8_t)v;
      } else {
        for (int x = 0; x < dw; ++x) o[2 * x] = o[2 * x + 1] = (uint8_t)in(r, x);
      }
    }
  } else {  // 2x2
    for (int r = 0; r < dh; ++r) {
      for (int v = 0; v < 2; ++v) {
        uint8_t* o = &out[(size_t)(2 * r + v) * ow];
        int other = v == 0 ? r - 1 : r + 1;
        if (dw > 2) {  // h2v2_fancy_upsample
          auto colsum = [&](int x) { return in(r, x) * 3 + in(other, x); };
          int thiss = colsum(0), nexts = colsum(1), lasts;
          o[0] = (uint8_t)((thiss * 4 + 8) >> 4);
          o[1] = (uint8_t)((thiss * 3 + nexts + 7) >> 4);
          lasts = thiss;
          thiss = nexts;
          for (int x = 1; x < dw - 1; ++x) {
            nexts = colsum(x + 1);
            o[2 * x] = (uint8_t)((thiss * 3 + lasts + 8) >> 4);
            o[2 * x + 1] = (uint8_t)((thiss * 3 + nexts + 7) >> 4);
            lasts = thiss;
            thiss = nexts;
          }
          o[2 * dw - 2] = (uint8_t)((thiss * 3 + lasts + 8) >> 4);
          o[2 * dw - 1] = (uint8_t)((thiss * 4 + 7) >> 4);
        } else {
          for (int x = 0; x < dw; ++x) o[2 * x] = o[2 * x + 1] = (uint8_t)in(r, x);
        }
      }
    }
  }
  return out;
}

// ---------------------------------------------------------------------------
// encoder
// ---------------------------------------------------------------------------
const uint8_t kStdLumQ[64] = {16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
                              14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
                              18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
                              49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const uint8_t kStdChrQ[64] = {17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
                              24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
                              99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
                              99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

// jstdhuff.c
const uint8_t kDcLumBits[17] = {0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChrBits[17] = {0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumBits[17] = {0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61, 0x07, 0x22, 0x71,
    0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37,
    0x38, 0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x83,
    0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3,
    0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChrBits[17] = {0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChrVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61, 0x71, 0x13, 0x22,
    0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
    0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36,
    0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a,
    0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
    0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba,
    0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

struct HuffEnc {
  const uint8_t* bits;
  const uint8_t* vals;
  int nvals;
  uint16_t code[256];
  uint8_t size[256];
  HuffEnc(const uint8_t* b, const uint8_t* v) : bits(b), vals(v) {
    std::memset(size, 0, sizeof size);
    int c = 0, k = 0;
    for (int l = 1; l <= 16; ++l) {
      for (int i = 0; i < b[l]; ++i, ++k) {
        code[v[k]] = (uint16_t)c++;
        size[v[k]] = (uint8_t)l;
      }
      c <<= 1;
    }
    nvals = k;
  }
};

struct BitWriter {
  std::vector<uint8_t>& out;
  uint64_t acc = 0;
  int nacc = 0;
  explicit BitWriter(std::vector<uint8_t>& o) : out(o) {}
  void put(uint32_t v, int k) {  // k <= 16
    acc = (acc << k) | (v & ((1u << k) - 1));
    nacc += k;
    while (nacc >= 8) {
      nacc -= 8;
      uint8_t b = (uint8_t)(acc >> nacc);
      out.push_back(b);
      if (b == 0xFF) out.push_back(0);  // byte stuffing
    }
  }
  void flush() {  // pad with ones
    if (nacc) put(0x7F, 8 - nacc);
  }
};

// jfdctint.c jpeg_fdct_islow, in place on centered samples
void fdct_islow(int32_t* data) {
  for (int r = 0; r < 8; ++r) {
    int32_t* p = data + 8 * r;
    int64_t tmp0 = p[0] + p[7], tmp7 = p[0] - p[7];
    int64_t tmp1 = p[1] + p[6], tmp6 = p[1] - p[6];
    int64_t tmp2 = p[2] + p[5], tmp5 = p[2] - p[5];
    int64_t tmp3 = p[3] + p[4], tmp4 = p[3] - p[4];
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    p[0] = (int32_t)((tmp10 + tmp11) * (1 << PASS1_BITS));
    p[4] = (int32_t)((tmp10 - tmp11) * (1 << PASS1_BITS));
    int64_t z1 = (tmp12 + tmp13) * FIX_0_541196100;
    p[2] = (int32_t)descale(z1 + tmp13 * FIX_0_765366865, CONST_BITS - PASS1_BITS);
    p[6] = (int32_t)descale(z1 + tmp12 * (-FIX_1_847759065), CONST_BITS - PASS1_BITS);
    z1 = tmp4 + tmp7;
    int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp4 *= FIX_0_298631336;
    tmp5 *= FIX_2_053119869;
    tmp6 *= FIX_3_072711026;
    tmp7 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    p[7] = (int32_t)descale(tmp4 + z1 + z3, CONST_BITS - PASS1_BITS);
    p[5] = (int32_t)descale(tmp5 + z2 + z4, CONST_BITS - PASS1_BITS);
    p[3] = (int32_t)descale(tmp6 + z2 + z3, CONST_BITS - PASS1_BITS);
    p[1] = (int32_t)descale(tmp7 + z1 + z4, CONST_BITS - PASS1_BITS);
  }
  for (int c = 0; c < 8; ++c) {
    int32_t* p = data + c;
    int64_t tmp0 = p[0] + p[56], tmp7 = p[0] - p[56];
    int64_t tmp1 = p[8] + p[48], tmp6 = p[8] - p[48];
    int64_t tmp2 = p[16] + p[40], tmp5 = p[16] - p[40];
    int64_t tmp3 = p[24] + p[32], tmp4 = p[24] - p[32];
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    p[0] = (int32_t)descale(tmp10 + tmp11, PASS1_BITS);
    p[32] = (int32_t)descale(tmp10 - tmp11, PASS1_BITS);
    int64_t z1 = (tmp12 + tmp13) * FIX_0_541196100;
    p[16] = (int32_t)descale(z1 + tmp13 * FIX_0_765366865, CONST_BITS + PASS1_BITS);
    p[48] = (int32_t)descale(z1 + tmp12 * (-FIX_1_847759065), CONST_BITS + PASS1_BITS);
    z1 = tmp4 + tmp7;
    int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp4 *= FIX_0_298631336;
    tmp5 *= FIX_2_053119869;
    tmp6 *= FIX_3_072711026;
    tmp7 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    p[56] = (int32_t)descale(tmp4 + z1 + z3, CONST_BITS + PASS1_BITS);
    p[40] = (int32_t)descale(tmp5 + z2 + z4, CONST_BITS + PASS1_BITS);
    p[24] = (int32_t)descale(tmp6 + z2 + z3, CONST_BITS + PASS1_BITS);
    p[8] = (int32_t)descale(tmp7 + z1 + z4, CONST_BITS + PASS1_BITS);
  }
}

// jcdctmgr.c compute_reciprocal / quantize (16-bit DCTELEM, as libjpeg-turbo
// builds it with SIMD)
struct Divisor {
  uint32_t recip, corr;
  int shift;
};
Divisor reciprocal(uint32_t divisor) {
  int b = 0;
  while ((divisor >> (b + 1)) != 0) ++b;  // flss(divisor) - 1
  int r = 16 + b;
  uint64_t fq = ((uint64_t)1 << r) / divisor;
  uint64_t fr = ((uint64_t)1 << r) % divisor;
  uint32_t c = divisor / 2;
  if (fr == 0) {
    fq >>= 1;
    --r;
  } else if (fr <= divisor / 2u) {
    ++c;
  } else {
    ++fq;
  }
  return {(uint32_t)(uint16_t)fq, (uint32_t)(uint16_t)c, r - 16};
}
inline int quantize(int32_t v, const Divisor& q) {
  uint32_t t = (uint32_t)(v < 0 ? -v : v);
  uint32_t prod = (uint32_t)(uint16_t)(t + q.corr) * q.recip;
  int out = (int)(uint16_t)(prod >> (q.shift + 16));
  return v < 0 ? -out : out;
}

void scale_table(const uint8_t* basic, int quality, uint16_t* out) {
  if (quality <= 0) quality = 1;
  if (quality > 100) quality = 100;
  int scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
  for (int i = 0; i < 64; ++i) {
    long t = ((long)basic[i] * scale + 50L) / 100L;
    if (t <= 0) t = 1;
    if (t > 255) t = 255;  // force_baseline
    out[i] = (uint16_t)t;
  }
}

struct Encoder {
  std::vector<uint8_t> out;
  void marker(int m) {
    out.push_back(0xFF);
    out.push_back((uint8_t)m);
  }
  void u16(int v) {
    out.push_back((uint8_t)(v >> 8));
    out.push_back((uint8_t)v);
  }
  void dqt(int id, const uint16_t* q) {
    marker(0xDB);
    u16(64 + 1 + 2);
    out.push_back((uint8_t)id);
    for (int i = 0; i < 64; ++i) out.push_back((uint8_t)q[kZig.nat[i]]);
  }
  void dht(int index, const HuffEnc& t) {
    marker(0xC4);
    u16(t.nvals + 2 + 1 + 16);
    out.push_back((uint8_t)index);
    for (int l = 1; l <= 16; ++l) out.push_back(t.bits[l]);
    for (int i = 0; i < t.nvals; ++i) out.push_back(t.vals[i]);
  }
};

void encode_block(BitWriter& bw, const int* qblk, int& last_dc, const HuffEnc& dct, const HuffEnc& act) {
  int temp = qblk[0] - last_dc, temp2 = temp;
  last_dc = qblk[0];
  if (temp < 0) {
    temp = -temp;
    --temp2;
  }
  int nbits = 0;
  while (temp) {
    ++nbits;
    temp >>= 1;
  }
  bw.put(dct.code[nbits], dct.size[nbits]);
  if (nbits) bw.put((uint32_t)temp2 & ((1u << nbits) - 1), nbits);
  int r = 0;
  for (int k = 1; k < 64; ++k) {
    temp = qblk[kZig.nat[k]];
    if (temp == 0) {
      ++r;
      continue;
    }
    while (r > 15) {
      bw.put(act.code[0xF0], act.size[0xF0]);
      r -= 16;
    }
    temp2 = temp;
    if (temp < 0) {
      temp = -temp;
      --temp2;
    }
    nbits = 1;
    while ((temp >>= 1)) ++nbits;
    int i = (r << 4) + nbits;
    bw.put(act.code[i], act.size[i]);
    bw.put((uint32_t)temp2 & ((1u << nbits) - 1), nbits);
    r = 0;
  }
  if (r > 0) bw.put(act.code[0], act.size[0]);
}

// one component plane, already padded to (bh*8 rows, bw*8 cols)
struct Plane {
  std::vector<uint8_t> px;
  int bw, bh;  // blocks of real data (width_in_blocks, height_in_blocks)
  int stride;
};

void fdct_quant(const Plane& p, int brow, int bcol, const Divisor* div, int* qblk) {
  int32_t data[64];
  for (int r = 0; r < 8; ++r)
    for (int c = 0; c < 8; ++c) data[8 * r + c] = (int32_t)p.px[(size_t)(brow * 8 + r) * p.stride + bcol * 8 + c] - 128;
  fdct_islow(data);
  for (int i = 0; i < 64; ++i) qblk[i] = quantize(data[i], div[i]);
}

std::vector<uint8_t> encode(const uint8_t* pix, int w, int h, int comps, int quality) {
  if (w <= 0 || h <= 0 || w > 65535 || h > 65535) fail("JPEG size %dx%d is out of range", w, h);
  if (comps != 1 && comps != 3) fail("JPEG encode takes L or RGB (1 or 3 channels), got %d", comps);
  const int hmax = comps == 3 ? 2 : 1, vmax = hmax;
  uint16_t qlum[64], qchr[64];
  scale_table(kStdLumQ, quality, qlum);
  scale_table(kStdChrQ, quality, qchr);
  Divisor dlum[64], dchr[64];
  for (int i = 0; i < 64; ++i) {
    dlum[i] = reciprocal((uint32_t)qlum[i] * 8);
    dchr[i] = reciprocal((uint32_t)qchr[i] * 8);
  }
  const int mcux = (w + 8 * hmax - 1) / (8 * hmax), mcuy = (h + 8 * vmax - 1) / (8 * vmax);

  // planes: Y at full size, Cb and Cr downsampled h2v2 (jcsample.c)
  std::vector<Plane> planes(comps);
  {
    Plane& y = planes[0];
    y.bw = (w + 7) / 8;
    y.bh = (h + 7) / 8;
    int pw = mcux * hmax * 8, ph = mcuy * vmax * 8;
    y.stride = pw;
    y.px.assign((size_t)pw * ph, 0);
    std::vector<uint8_t> cbf, crf;
    int cw = 0, ch = 0;  // chroma-source size: even rows, 2 x chroma blocks x 8 cols
    if (comps == 3) {
      cw = ((w + 15) / 16) * 16;
      ch = (h + 1) / 2 * 2;
      cbf.assign((size_t)cw * ch, 0);
      crf.assign((size_t)cw * ch, 0);
    }
    // jccolor.c rgb_ycc_convert tables
    const int SB = 16;
    const int64_t HALF = (int64_t)1 << (SB - 1), CBCR_OFF = (int64_t)128 << SB;
    auto fix = [](double x) { return (int64_t)(x * 65536.0 + 0.5); };
    for (int r = 0; r < ph; ++r) {
      int sr = std::min(r, h - 1);
      for (int c = 0; c < pw; ++c) {
        int sc = std::min(c, w - 1);
        const uint8_t* s = pix + ((size_t)sr * w + sc) * comps;
        if (comps == 1) {
          y.px[(size_t)r * pw + c] = s[0];
          continue;
        }
        int64_t R = s[0], G = s[1], B = s[2];
        y.px[(size_t)r * pw + c] = (uint8_t)((fix(0.29900) * R + fix(0.58700) * G + fix(0.11400) * B + HALF) >> SB);
        if (r < ch && c < cw) {
          cbf[(size_t)r * cw + c] =
              (uint8_t)((-fix(0.16874) * R - fix(0.33126) * G + fix(0.5) * B + CBCR_OFF + HALF - 1) >> SB);
          crf[(size_t)r * cw + c] =
              (uint8_t)((fix(0.5) * R - fix(0.41869) * G - fix(0.08131) * B + CBCR_OFF + HALF - 1) >> SB);
        }
      }
    }
    if (comps == 3) {
      for (int k = 1; k < 3; ++k) {
        const std::vector<uint8_t>& f = k == 1 ? cbf : crf;
        Plane& p = planes[k];
        p.bw = mcux;
        p.bh = mcuy;
        p.stride = mcux * 8;
        p.px.assign((size_t)p.stride * mcuy * 8, 0);
        int rows = ch / 2;  // real downsampled rows
        for (int r = 0; r < mcuy * 8; ++r) {
          int rr = std::min(r, rows - 1);  // jcprepct.c pads with the last row
          const uint8_t* a = &f[(size_t)(2 * rr) * cw];
          const uint8_t* b = &f[(size_t)(2 * rr + 1) * cw];
          int bias = 1;
          for (int c = 0; c < p.stride; ++c) {
            p.px[(size_t)r * p.stride + c] = (uint8_t)((a[2 * c] + a[2 * c + 1] + b[2 * c] + b[2 * c + 1] + bias) >> 2);
            bias ^= 3;
          }
        }
      }
    }
  }

  Encoder e;
  e.marker(0xD8);
  // JFIF 1.01 APP0, density 1:1, no thumbnail
  e.marker(0xE0);
  e.u16(16);
  const uint8_t jfif[14] = {'J', 'F', 'I', 'F', 0, 1, 1, 0, 0, 1, 0, 1, 0, 0};
  e.out.insert(e.out.end(), jfif, jfif + 14);
  e.dqt(0, qlum);
  if (comps == 3) e.dqt(1, qchr);
  e.marker(0xC0);
  e.u16(3 * comps + 8);
  e.out.push_back(8);
  e.u16(h);
  e.u16(w);
  e.out.push_back((uint8_t)comps);
  for (int c = 0; c < comps; ++c) {
    e.out.push_back((uint8_t)(c + 1));
    e.out.push_back(c == 0 ? (uint8_t)((hmax << 4) | vmax) : 0x11);
    e.out.push_back(c == 0 ? 0 : 1);
  }
  const HuffEnc dcl(kDcLumBits, kDcVals), acl(kAcLumBits, kAcLumVals);
  const HuffEnc dcc(kDcChrBits, kDcVals), acc(kAcChrBits, kAcChrVals);
  e.dht(0x00, dcl);
  e.dht(0x10, acl);
  if (comps == 3) {
    e.dht(0x01, dcc);
    e.dht(0x11, acc);
  }
  e.marker(0xDA);
  e.u16(2 * comps + 6);
  e.out.push_back((uint8_t)comps);
  for (int c = 0; c < comps; ++c) {
    e.out.push_back((uint8_t)(c + 1));
    e.out.push_back(c == 0 ? 0x00 : 0x11);
  }
  e.out.push_back(0);
  e.out.push_back(63);
  e.out.push_back(0);

  BitWriter bw(e.out);
  int last_dc[3] = {0, 0, 0};
  int qblk[64];
  int dummy[64];
  for (int my = 0; my < mcuy; ++my) {
    for (int mx = 0; mx < mcux; ++mx) {
      for (int c = 0; c < comps; ++c) {
        const Plane& p = planes[c];
        const int hs = c == 0 ? hmax : 1, vs = c == 0 ? vmax : 1;
        const Divisor* div = c == 0 ? dlum : dchr;
        const HuffEnc& dct = c == 0 ? dcl : dcc;
        const HuffEnc& act = c == 0 ? acl : acc;
        // jccoefct.c compress_data: blocks past the component's real
        // blocks are dummies, zero AC and the DC of the block before
        int prev_dc = 0;
        for (int by = 0; by < vs; ++by) {
          for (int bx = 0; bx < hs; ++bx) {
            int brow = my * vs + by, bcol = mx * hs + bx;
            const int* blk;
            if (brow < p.bh && bcol < p.bw) {
              fdct_quant(p, brow, bcol, div, qblk);
              blk = qblk;
            } else {
              std::memset(dummy, 0, sizeof dummy);
              dummy[0] = prev_dc;
              blk = dummy;
            }
            prev_dc = blk[0];
            encode_block(bw, blk, last_dc[c], dct, act);
          }
        }
      }
    }
  }
  bw.flush();
  e.marker(0xD9);
  return std::move(e.out);
}

}  // namespace

extern "C" {

int vt_jpeg_info(const uint8_t* data, size_t n, int* w, int* h, int* comps, char* err, int errlen) {
  try {
    Decoder dec(data, n);
    dec.run(true);
    if (!dec.sof_seen) fail("corrupt JPEG: no SOF marker");
    *w = dec.width;
    *h = dec.height;
    *comps = dec.ncomp;
    return 0;
  } catch (const JpegError& e) {
    return report(e, err, errlen);
  }
}

int vt_jpeg_decode(const uint8_t* data, size_t n, uint8_t* out, char* err, int errlen) {
  try {
    Decoder dec(data, n);
    dec.run(false);
    const int W = dec.width, H = dec.height;
    if (dec.ncomp == 3 && is_rgb_coded(dec)) fail("RGB-coded (not YCbCr) JPEG is not supported");
    if (dec.ncomp == 1) {
      const Component& c = dec.comp[0];
      for (int r = 0; r < H; ++r) std::memcpy(out + (size_t)r * W, &c.plane[(size_t)r * c.bw * 8], W);
      return 0;
    }
    const Component& y = dec.comp[0];
    std::vector<uint8_t> cb = upsample(dec.comp[1], dec.hmax, dec.vmax);
    std::vector<uint8_t> cr = upsample(dec.comp[2], dec.hmax, dec.vmax);
    const int cstride = dec.comp[1].dw * dec.hmax;
    for (int r = 0; r < H; ++r) {
      const uint8_t* yr = &y.plane[(size_t)r * y.bw * 8];
      const uint8_t* br = &cb[(size_t)r * cstride];
      const uint8_t* rr = &cr[(size_t)r * cstride];
      uint8_t* o = out + (size_t)r * W * 3;
      for (int x = 0; x < W; ++x) {
        int Y = yr[x], b = br[x], c = rr[x];
        o[3 * x] = clamp255(Y + kYcc.cr_r[c]);
        o[3 * x + 1] = clamp255(Y + (int)((kYcc.cb_g[b] + kYcc.cr_g[c]) >> 16));
        o[3 * x + 2] = clamp255(Y + kYcc.cb_b[b]);
      }
    }
    return 0;
  } catch (const JpegError& e) {
    return report(e, err, errlen);
  }
}

int vt_jpeg_encode(const uint8_t* pix, int w, int h, int comps, int quality, uint8_t** out, size_t* size, char* err,
                   int errlen) {
  try {
    std::vector<uint8_t> bytes = encode(pix, w, h, comps, quality);
    *out = (uint8_t*)std::malloc(bytes.size());
    if (!*out) fail("out of memory");
    std::memcpy(*out, bytes.data(), bytes.size());
    *size = bytes.size();
    return 0;
  } catch (const JpegError& e) {
    return report(e, err, errlen);
  }
}

void vt_jpeg_free(uint8_t* p) { std::free(p); }

}  // extern "C"
