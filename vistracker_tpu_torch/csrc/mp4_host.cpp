// An .mp4 writer in host C++: MPEG-4 Part 2 Visual (Simple Profile),
// intra-only, in an ISO base media file.
//
// The video track is what cv2.VideoWriter_fourcc(*"mp4v") writes: an
// `mp4v` sample entry whose esds carries object type 0x20 (ISO/IEC
// 14496-2) and, as its DecoderSpecificInfo, the visual object sequence,
// visual object and video object layer headers. Each sample is one
// I-VOP:
//   - colour: RGB to BT.601 limited-range Y'CbCr, chroma 4:2:0 as the
//     mean of each 2 x 2 block;
//   - frame size: padded to whole 16 x 16 macroblocks by repeating the
//     last row and column; the VOL carries the true width and height;
//   - coding: a float 8 x 8 DCT, the H.263 quantizer (quant_type 0) at
//     one fixed qscale, no AC prediction; the DC through the intra DC
//     VLC with the standard's adaptive DC prediction (intra_dc_vlc_thr
//     0), every AC coefficient through TCOEF escape mode 3 (legal for any
//     (last, run, level), and it needs no VLC table).
// Boxes: ftyp, moov (mvhd, trak: tkhd, mdia: mdhd, hdlr, minf: vmhd,
// dinf, stbl: stsd, stts, stss, stsc, stsz, stco), then mdat. One chunk
// a sample; the media and movie timescales are fps, every sample lasts
// 1 tick, so the rate is exactly fps.
//
// C interface (ctypes, vistracker_tpu_torch/data/mp4.py):
//   int vt_mp4_write(const uint8_t* rgb, int64_t frames, int32_t height,
//                    int32_t width, int32_t fps, int32_t qscale,
//                    int64_t max_bytes, const char* path)
// rgb is (frames, height, width, 3) uint8, C order. Returns 0, or one of
// the VT_MP4_* codes below without writing anything.
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <vector>

enum {
  VT_MP4_OK = 0,
  VT_MP4_NO_FRAMES = 1,
  VT_MP4_BAD_SIZE = 2,     // width or height outside 1..8191
  VT_MP4_BAD_FPS = 3,      // outside 1..65535
  VT_MP4_BAD_QSCALE = 4,   // outside 1..31
  VT_MP4_TOO_LARGE = 5,    // the file would reach max_bytes
  VT_MP4_OPEN = 6,
  VT_MP4_WRITE = 7,
};

namespace {

class BitWriter {
 public:
  std::vector<uint8_t> bytes;

  void put(uint32_t value, int nbits) {  // nbits in 1..32
    uint64_t mask = (nbits == 32) ? 0xFFFFFFFFull : ((1ull << nbits) - 1);
    acc_ = (acc_ << nbits) | (value & mask);
    nacc_ += nbits;
    while (nacc_ >= 8) {
      nacc_ -= 8;
      bytes.push_back(uint8_t(acc_ >> nacc_));
    }
  }

  // next_start_code(): a 0 bit, then 1 bits up to the byte boundary (a
  // whole 0x7F when already aligned).
  void stuffing() {
    int len = 8 - nacc_;
    put((1u << (len - 1)) - 1, len);
  }

  void start_code(uint32_t code) { put(code, 32); }

 private:
  uint64_t acc_ = 0;
  int nacc_ = 0;
};

const int kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// intra MCBPC (I-VOP, mb_type 3) by cbpc = Cb << 1 | Cr: {code, length}
const int kMcbpc[4][2] = {{1, 1}, {1, 3}, {2, 3}, {3, 3}};
// CBPY by the four luma coded bits (block 0 in bit 3): {code, length}
const int kCbpy[16][2] = {{3, 4}, {5, 5}, {4, 5}, {9, 4}, {3, 5}, {7, 4},
                          {2, 6}, {11, 4}, {2, 5}, {3, 6}, {5, 4}, {10, 4},
                          {4, 4}, {8, 4}, {6, 4}, {3, 2}};
// dct_dc_size VLCs by size 0..12: {code, length}
const int kDcLum[13][2] = {{3, 3}, {3, 2}, {2, 2}, {2, 3}, {1, 3},
                           {1, 4}, {1, 5}, {1, 6}, {1, 7}, {1, 8},
                           {1, 9}, {1, 10}, {1, 11}};
const int kDcChrom[13][2] = {{3, 2}, {2, 2}, {1, 2}, {1, 3}, {1, 4},
                             {1, 5}, {1, 6}, {1, 7}, {1, 8}, {1, 9},
                             {1, 10}, {1, 11}, {1, 12}};

int dc_scaler(int qp, bool luma) {  // ISO/IEC 14496-2 Table 7-1
  if (qp <= 4) return 8;
  if (luma) return qp <= 8 ? 2 * qp : (qp <= 24 ? qp + 8 : 2 * qp - 16);
  return qp <= 24 ? (qp + 13) / 2 : qp - 6;
}

int time_increment_bits(int resolution) {
  int bits = 1;
  while ((1 << bits) < resolution) ++bits;
  return bits;
}

// the DCT basis: c[u][x] = C(u) / 2 * cos((2x + 1) u pi / 16)
struct Dct {
  double c[8][8];
  Dct() {
    for (int u = 0; u < 8; ++u)
      for (int x = 0; x < 8; ++x)
        c[u][x] = (u == 0 ? std::sqrt(0.5) : 1.0) * 0.5 *
                  std::cos((2 * x + 1) * u * M_PI / 16.0);
  }
  // in: 8 x 8 samples (row-major), out: F[v * 8 + u], v the vertical
  // frequency
  void forward(const double* in, double* out) const {
    double tmp[64];
    for (int y = 0; y < 8; ++y)
      for (int u = 0; u < 8; ++u) {
        double s = 0;
        for (int x = 0; x < 8; ++x) s += c[u][x] * in[y * 8 + x];
        tmp[y * 8 + u] = s;
      }
    for (int v = 0; v < 8; ++v)
      for (int u = 0; u < 8; ++u) {
        double s = 0;
        for (int y = 0; y < 8; ++y) s += c[v][y] * tmp[y * 8 + u];
        out[v * 8 + u] = s;
      }
  }
};

// The H.263 intra AC level whose reconstruction, |F''| = qp (2|L| + 1)
// (minus 1 for an even qp), lies nearest |coef|; 0 where 0 is nearer.
int ac_level(double coef, int qp) {
  double a = std::fabs(coef);
  int even = (qp % 2 == 0) ? 1 : 0;
  long l = std::lround((a + even - qp) / (2.0 * qp));
  if (l < 1) l = 1;
  if (l > 2047) l = 2047;
  double rec = double(qp * (2 * l + 1) - even);
  if (a <= std::fabs(rec - a)) return 0;
  return coef < 0 ? -int(l) : int(l);
}

struct Picture {  // padded Y'CbCr planes
  int mbw, mbh;
  std::vector<double> y, cb, cr;  // (16 mbh) x (16 mbw), (8 mbh) x (8 mbw)
};

void to_yuv420(const uint8_t* rgb, int h, int w, Picture* p) {
  int ph = p->mbh * 16, pw = p->mbw * 16;
  p->y.assign(size_t(ph) * pw, 0.0);
  std::vector<double> cb(size_t(ph) * pw), cr(size_t(ph) * pw);
  for (int r = 0; r < ph; ++r) {
    const uint8_t* row = rgb + size_t(r < h ? r : h - 1) * w * 3;
    for (int c = 0; c < pw; ++c) {
      const uint8_t* px = row + size_t(c < w ? c : w - 1) * 3;
      double R = px[0] / 255.0, G = px[1] / 255.0, B = px[2] / 255.0;
      size_t i = size_t(r) * pw + c;
      double yv = 16.0 + 65.481 * R + 128.553 * G + 24.966 * B;
      p->y[i] = std::floor(yv + 0.5);
      cb[i] = 128.0 - 37.797 * R - 74.203 * G + 112.0 * B;
      cr[i] = 128.0 + 112.0 * R - 93.786 * G - 18.214 * B;
    }
  }
  int ch = ph / 2, cw = pw / 2;
  p->cb.assign(size_t(ch) * cw, 0.0);
  p->cr.assign(size_t(ch) * cw, 0.0);
  for (int r = 0; r < ch; ++r)
    for (int c = 0; c < cw; ++c) {
      size_t a = size_t(2 * r) * pw + 2 * c, b = a + pw;
      size_t o = size_t(r) * cw + c;
      p->cb[o] = std::floor((cb[a] + cb[a + 1] + cb[b] + cb[b + 1]) / 4 + 0.5);
      p->cr[o] = std::floor((cr[a] + cr[a + 1] + cr[b] + cr[b + 1]) / 4 + 0.5);
    }
}

// The dequantized DC (QF x dc_scaler) of every 8 x 8 block of one plane,
// for the DC prediction; 1024 stands for a block outside the VOP.
struct DcGrid {
  int bw, bh;
  std::vector<int> v;
  DcGrid(int bw_, int bh_) : bw(bw_), bh(bh_), v(size_t(bw_) * bh_, 0) {}
  int at(int bx, int by) const {
    if (bx < 0 || by < 0) return 1024;
    return v[size_t(by) * bw + bx];
  }
};

struct Block {
  int dc_diff;
  int level[64];  // by zigzag position, 1..63 used
  bool coded;     // any AC level
};

void code_block(const Dct& dct, const std::vector<double>& plane, int stride,
                int bx, int by, int qp, bool luma, DcGrid* grid, Block* out) {
  double in[64], f[64];
  for (int y = 0; y < 8; ++y)
    for (int x = 0; x < 8; ++x)
      in[y * 8 + x] = plane[size_t(by * 8 + y) * stride + bx * 8 + x];
  dct.forward(in, f);
  int scale = dc_scaler(qp, luma);
  int qf = int(std::floor(f[0] / scale + 0.5));
  int qmax = 2047 / scale;
  qf = qf < 1 ? 1 : (qf > qmax ? qmax : qf);
  // adaptive DC prediction from the left (A), upper-left (B) and upper
  // (C) blocks' dequantized DCs
  int a = grid->at(bx - 1, by), b = grid->at(bx - 1, by - 1),
      c = grid->at(bx, by - 1);
  int pred = std::abs(a - b) < std::abs(b - c) ? c : a;
  pred = (pred + scale / 2) / scale;
  grid->v[size_t(by) * grid->bw + bx] = qf * scale;
  out->dc_diff = qf - pred;
  out->coded = false;
  out->level[0] = 0;
  for (int k = 1; k < 64; ++k) {
    out->level[k] = ac_level(f[kZigzag[k]], qp);
    out->coded |= out->level[k] != 0;
  }
}

void put_dc(BitWriter* bw, int diff, bool luma) {
  int size = 0;
  for (int v = std::abs(diff); v; v >>= 1) ++size;
  const int* vlc = luma ? kDcLum[size] : kDcChrom[size];
  bw->put(uint32_t(vlc[0]), vlc[1]);
  if (size) {
    int v = diff < 0 ? diff + (1 << size) - 1 : diff;
    bw->put(uint32_t(v), size);
    if (size > 8) bw->put(1, 1);  // marker
  }
}

void put_ac(BitWriter* bw, const Block& blk) {
  int last_nz = 0;
  for (int k = 1; k < 64; ++k)
    if (blk.level[k]) last_nz = k;
  int run = 0;
  for (int k = 1; k <= last_nz; ++k) {
    if (!blk.level[k]) {
      ++run;
      continue;
    }
    // escape mode 3: ESC 0000011, 11, last, run (6), marker,
    // level (12, two's complement), marker
    bw->put(0x3, 7);
    bw->put(0x3, 2);
    bw->put(k == last_nz ? 1 : 0, 1);
    bw->put(uint32_t(run), 6);
    bw->put(1, 1);
    bw->put(uint32_t(blk.level[k]) & 0xFFF, 12);
    bw->put(1, 1);
    run = 0;
  }
}

// VOS, VO and VOL headers: the DecoderSpecificInfo
std::vector<uint8_t> stream_headers(int w, int h, int fps) {
  BitWriter bw;
  bw.start_code(0x000001B0);  // visual_object_sequence_start_code
  bw.put(0x01, 8);            // Simple Profile, level 1 (as cv2 writes)
  bw.start_code(0x000001B5);  // visual_object_start_code
  bw.put(1, 1);               // is_visual_object_identifier
  bw.put(1, 4);               // visual_object_verid
  bw.put(1, 3);               // visual_object_priority
  bw.put(1, 4);               // visual_object_type: video
  bw.put(0, 1);               // video_signal_type
  bw.stuffing();
  bw.start_code(0x00000100);  // video_object_start_code
  bw.start_code(0x00000120);  // video_object_layer_start_code
  bw.put(0, 1);               // random_accessible_vol
  bw.put(1, 8);               // video_object_type_indication: Simple
  bw.put(1, 1);               // is_object_layer_identifier
  bw.put(1, 4);               // video_object_layer_verid
  bw.put(1, 3);               // video_object_layer_priority
  bw.put(1, 4);               // aspect_ratio_info: square pixels
  bw.put(1, 1);               // vol_control_parameters
  bw.put(1, 2);               // chroma_format 4:2:0
  bw.put(1, 1);               // low_delay
  bw.put(0, 1);               // vbv_parameters
  bw.put(0, 2);               // video_object_layer_shape: rectangular
  bw.put(1, 1);               // marker
  bw.put(uint32_t(fps), 16);  // vop_time_increment_resolution
  bw.put(1, 1);               // marker
  bw.put(0, 1);               // fixed_vop_rate
  bw.put(1, 1);               // marker
  bw.put(uint32_t(w), 13);    // video_object_layer_width
  bw.put(1, 1);               // marker
  bw.put(uint32_t(h), 13);    // video_object_layer_height
  bw.put(1, 1);               // marker
  bw.put(0, 1);               // interlaced
  bw.put(1, 1);               // obmc_disable
  bw.put(0, 1);               // sprite_enable
  bw.put(0, 1);               // not_8_bit
  bw.put(0, 1);               // quant_type: H.263
  bw.put(1, 1);               // complexity_estimation_disable
  bw.put(1, 1);               // resync_marker_disable
  bw.put(0, 1);               // data_partitioned
  bw.put(0, 1);               // scalability
  bw.stuffing();
  return bw.bytes;
}

std::vector<uint8_t> encode_vop(const Dct& dct, const uint8_t* rgb, int h,
                                int w, int index, int fps, int qp) {
  Picture p;
  p.mbw = (w + 15) / 16;
  p.mbh = (h + 15) / 16;
  to_yuv420(rgb, h, w, &p);
  BitWriter bw;
  bw.start_code(0x000001B6);  // vop_start_code
  bw.put(0, 2);               // vop_coding_type: I
  // modulo_time_base: a 1 for each second boundary since the last VOP
  int seconds = index / fps;
  int prev = index > 0 ? (index - 1) / fps : 0;
  for (int s = prev; s < seconds; ++s) bw.put(1, 1);
  bw.put(0, 1);
  bw.put(1, 1);  // marker
  bw.put(uint32_t(index % fps), time_increment_bits(fps));
  bw.put(1, 1);  // marker
  bw.put(1, 1);  // vop_coded
  bw.put(0, 3);  // intra_dc_vlc_thr: the DC VLC throughout
  bw.put(uint32_t(qp), 5);
  DcGrid gy(2 * p.mbw, 2 * p.mbh), gcb(p.mbw, p.mbh), gcr(p.mbw, p.mbh);
  Block blk[6];
  for (int my = 0; my < p.mbh; ++my)
    for (int mx = 0; mx < p.mbw; ++mx) {
      for (int i = 0; i < 4; ++i)
        code_block(dct, p.y, 16 * p.mbw, 2 * mx + (i & 1), 2 * my + (i >> 1),
                   qp, true, &gy, &blk[i]);
      code_block(dct, p.cb, 8 * p.mbw, mx, my, qp, false, &gcb, &blk[4]);
      code_block(dct, p.cr, 8 * p.mbw, mx, my, qp, false, &gcr, &blk[5]);
      int cbpc = (blk[4].coded ? 2 : 0) | (blk[5].coded ? 1 : 0);
      int cbpy = (blk[0].coded ? 8 : 0) | (blk[1].coded ? 4 : 0) |
                 (blk[2].coded ? 2 : 0) | (blk[3].coded ? 1 : 0);
      bw.put(uint32_t(kMcbpc[cbpc][0]), kMcbpc[cbpc][1]);
      bw.put(0, 1);  // ac_pred_flag
      bw.put(uint32_t(kCbpy[cbpy][0]), kCbpy[cbpy][1]);
      for (int i = 0; i < 6; ++i) {
        put_dc(&bw, blk[i].dc_diff, i < 4);
        if (blk[i].coded) put_ac(&bw, blk[i]);
      }
    }
  bw.stuffing();
  return bw.bytes;
}

// ---------------------------------------------------------------- boxes

class Bytes {
 public:
  std::vector<uint8_t> b;
  void u8(uint32_t v) { b.push_back(uint8_t(v)); }
  void u16(uint32_t v) { u8(v >> 8); u8(v); }
  void u24(uint32_t v) { u8(v >> 16); u16(v); }
  void u32(uint32_t v) { u16(v >> 16); u16(v); }
  void zeros(size_t n) { b.insert(b.end(), n, 0); }
  void tag(const char* s) { b.insert(b.end(), s, s + 4); }
  void raw(const std::vector<uint8_t>& v) { b.insert(b.end(), v.begin(), v.end()); }
  // open a box: its size is filled in by close()
  size_t open(const char* type) {
    size_t at = b.size();
    u32(0);
    tag(type);
    return at;
  }
  size_t open_full(const char* type, uint32_t version_flags) {
    size_t at = open(type);
    u32(version_flags);
    return at;
  }
  void close(size_t at) {
    uint32_t size = uint32_t(b.size() - at);
    b[at] = uint8_t(size >> 24);
    b[at + 1] = uint8_t(size >> 16);
    b[at + 2] = uint8_t(size >> 8);
    b[at + 3] = uint8_t(size);
  }
  void matrix() {
    const uint32_t m[9] = {0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000};
    for (uint32_t v : m) u32(v);
  }
  // an MPEG-4 descriptor header with the 4-byte length form
  void descriptor(uint8_t tag_, uint32_t len) {
    u8(tag_);
    u8(0x80 | ((len >> 21) & 0x7F));
    u8(0x80 | ((len >> 14) & 0x7F));
    u8(0x80 | ((len >> 7) & 0x7F));
    u8(len & 0x7F);
  }
};

std::vector<uint8_t> movie_box(int w, int h, int fps,
                               const std::vector<uint8_t>& dsi,
                               const std::vector<uint32_t>& sizes,
                               uint32_t first_offset) {
  uint32_t n = uint32_t(sizes.size());
  uint64_t total = 0;
  uint32_t largest = 0;
  for (uint32_t s : sizes) {
    total += s;
    if (s > largest) largest = s;
  }
  Bytes m;
  size_t moov = m.open("moov");
  size_t mvhd = m.open_full("mvhd", 0);
  m.u32(0);          // creation_time
  m.u32(0);          // modification_time
  m.u32(uint32_t(fps));  // timescale
  m.u32(n);          // duration: n ticks of 1 / fps s
  m.u32(0x10000);    // rate 1.0
  m.u16(0x100);      // volume 1.0
  m.zeros(10);
  m.matrix();
  m.zeros(24);       // pre_defined
  m.u32(2);          // next_track_ID
  m.close(mvhd);
  size_t trak = m.open("trak");
  size_t tkhd = m.open_full("tkhd", 3);  // enabled, in movie
  m.u32(0);
  m.u32(0);
  m.u32(1);          // track_ID
  m.u32(0);
  m.u32(n);          // duration (movie timescale)
  m.zeros(8);
  m.u16(0);          // layer
  m.u16(0);          // alternate_group
  m.u16(0);          // volume
  m.u16(0);
  m.matrix();
  m.u32(uint32_t(w) << 16);
  m.u32(uint32_t(h) << 16);
  m.close(tkhd);
  size_t mdia = m.open("mdia");
  size_t mdhd = m.open_full("mdhd", 0);
  m.u32(0);
  m.u32(0);
  m.u32(uint32_t(fps));
  m.u32(n);
  m.u16(0x55C4);     // language "und"
  m.u16(0);
  m.close(mdhd);
  size_t hdlr = m.open_full("hdlr", 0);
  m.u32(0);
  m.tag("vide");
  m.zeros(12);
  const char name[] = "VideoHandler";
  m.b.insert(m.b.end(), name, name + sizeof(name));  // with its NUL
  m.close(hdlr);
  size_t minf = m.open("minf");
  size_t vmhd = m.open_full("vmhd", 1);
  m.zeros(8);        // graphicsmode, opcolor
  m.close(vmhd);
  size_t dinf = m.open("dinf");
  size_t dref = m.open_full("dref", 0);
  m.u32(1);
  size_t url = m.open_full("url ", 1);  // media in this file
  m.close(url);
  m.close(dref);
  m.close(dinf);
  size_t stbl = m.open("stbl");
  size_t stsd = m.open_full("stsd", 0);
  m.u32(1);
  size_t mp4v = m.open("mp4v");
  m.zeros(6);
  m.u16(1);          // data_reference_index
  m.zeros(16);       // pre_defined, reserved
  m.u16(uint32_t(w));
  m.u16(uint32_t(h));
  m.u32(0x480000);   // 72 dpi
  m.u32(0x480000);
  m.u32(0);
  m.u16(1);          // frame_count
  m.zeros(32);       // compressorname
  m.u16(0x18);       // depth
  m.u16(0xFFFF);     // pre_defined -1
  size_t esds = m.open_full("esds", 0);
  uint32_t dsi_len = uint32_t(dsi.size());
  uint32_t dcd_len = 13 + 5 + dsi_len;
  m.descriptor(0x03, 3 + 5 + dcd_len + 5 + 1);  // ES_Descriptor
  m.u16(1);          // ES_ID
  m.u8(0);           // no dependence, URL or OCR stream
  m.descriptor(0x04, dcd_len);  // DecoderConfigDescriptor
  m.u8(0x20);        // objectTypeIndication: ISO/IEC 14496-2 visual
  m.u8(0x11);        // streamType 4 (visual) << 2 | reserved 1
  m.u24(largest);    // bufferSizeDB
  double secs = double(n) / fps;
  m.u32(uint32_t(std::min(4294967295.0, 8.0 * largest * fps)));  // max
  m.u32(uint32_t(std::min(4294967295.0, 8.0 * total / secs)));    // avg
  m.descriptor(0x05, dsi_len);  // DecoderSpecificInfo
  m.raw(dsi);
  m.descriptor(0x06, 1);        // SLConfigDescriptor
  m.u8(0x02);                   // predefined: MP4
  m.close(esds);
  m.close(mp4v);
  m.close(stsd);
  size_t stts = m.open_full("stts", 0);
  m.u32(1);
  m.u32(n);          // sample_count
  m.u32(1);          // sample_delta
  m.close(stts);
  size_t stss = m.open_full("stss", 0);  // every sample is a sync sample
  m.u32(n);
  for (uint32_t i = 1; i <= n; ++i) m.u32(i);
  m.close(stss);
  size_t stsc = m.open_full("stsc", 0);  // one sample a chunk
  m.u32(1);
  m.u32(1);
  m.u32(1);
  m.u32(1);
  m.close(stsc);
  size_t stsz = m.open_full("stsz", 0);
  m.u32(0);          // sizes differ
  m.u32(n);
  for (uint32_t s : sizes) m.u32(s);
  m.close(stsz);
  size_t stco = m.open_full("stco", 0);
  m.u32(n);
  uint64_t off = first_offset;
  for (uint32_t s : sizes) {
    m.u32(uint32_t(off));
    off += s;
  }
  m.close(stco);
  m.close(stbl);
  m.close(minf);
  m.close(mdia);
  m.close(trak);
  m.close(moov);
  return m.b;
}

std::vector<uint8_t> file_type_box() {
  Bytes f;
  size_t ftyp = f.open("ftyp");
  f.tag("isom");
  f.u32(0x200);
  f.tag("isom");
  f.tag("iso2");
  f.tag("mp41");
  f.close(ftyp);
  return f.b;
}

}  // namespace

extern "C" int vt_mp4_write(const uint8_t* rgb, int64_t frames, int32_t height,
                            int32_t width, int32_t fps, int32_t qscale,
                            int64_t max_bytes, const char* path) {
  if (frames <= 0) return VT_MP4_NO_FRAMES;
  if (width < 1 || width > 8191 || height < 1 || height > 8191)
    return VT_MP4_BAD_SIZE;
  if (fps < 1 || fps > 65535) return VT_MP4_BAD_FPS;
  if (qscale < 1 || qscale > 31) return VT_MP4_BAD_QSCALE;
  Dct dct;
  std::vector<uint8_t> dsi = stream_headers(width, height, fps);
  std::vector<std::vector<uint8_t>> vops;
  std::vector<uint32_t> sizes;
  vops.reserve(size_t(frames));
  size_t frame_bytes = size_t(height) * width * 3;
  uint64_t payload = 0;
  for (int64_t t = 0; t < frames; ++t) {
    vops.push_back(encode_vop(dct, rgb + size_t(t) * frame_bytes, height,
                              width, int(t), fps, qscale));
    sizes.push_back(uint32_t(vops.back().size()));
    payload += vops.back().size();
    if (int64_t(payload) >= max_bytes) return VT_MP4_TOO_LARGE;
  }
  std::vector<uint8_t> ftyp = file_type_box();
  // the moov's size does not depend on the offsets it holds
  size_t moov_size = movie_box(width, height, fps, dsi, sizes, 0).size();
  uint64_t mdat_at = ftyp.size() + moov_size;
  uint64_t total = mdat_at + 8 + payload;
  if (int64_t(total) >= max_bytes) return VT_MP4_TOO_LARGE;
  std::vector<uint8_t> moov =
      movie_box(width, height, fps, dsi, sizes, uint32_t(mdat_at + 8));
  FILE* fh = std::fopen(path, "wb");
  if (!fh) return VT_MP4_OPEN;
  uint8_t mdat[8] = {uint8_t((8 + payload) >> 24), uint8_t((8 + payload) >> 16),
                     uint8_t((8 + payload) >> 8), uint8_t(8 + payload),
                     'm', 'd', 'a', 't'};
  bool ok = std::fwrite(ftyp.data(), 1, ftyp.size(), fh) == ftyp.size() &&
            std::fwrite(moov.data(), 1, moov.size(), fh) == moov.size() &&
            std::fwrite(mdat, 1, 8, fh) == 8;
  for (size_t i = 0; ok && i < vops.size(); ++i)
    ok = std::fwrite(vops[i].data(), 1, vops[i].size(), fh) == vops[i].size();
  ok = (std::fclose(fh) == 0) && ok;
  return ok ? VT_MP4_OK : VT_MP4_WRITE;
}
