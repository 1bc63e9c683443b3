// Baseline JPEG decoder of the PyTorch port's host library, written to
// give the samples libjpeg-turbo gives at its defaults (what PIL reads), bit
// for bit, without linking an image library:
//
//   * sequential Huffman (SOF0 / SOF1), 8-bit samples, 1 or 3 components,
//     one or more scans, restart intervals;
//   * the accurate integer inverse DCT (jidctint.c, jpeg_idct_islow);
//   * "fancy" triangle upsampling of 4:2:2 and 4:2:0 chroma (jdsample.c,
//     h2v1_fancy_upsample / h2v2_fancy_upsample, with their alternating
//     rounding biases and edge replication);
//   * the fixed-point YCbCr -> RGB tables of jdcolor.c.
//
// Progressive, arithmetic-coded, lossless and hierarchical files, 12-bit
// samples, 4-component (CMYK / YCCK) files, RGB-coded files and other
// sampling layouts are refused with a message, never decoded
// approximately.
//
// Entry points (extern "C"): jpeg_header() reads the frame header,
// jpeg_decode() the samples into a caller-owned (H, W, C) uint8 buffer.
// Both return 0, or 1 with a message in err.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    // k past 63 in a corrupt block lands on 63, as in libjpeg
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct JpegError {
  std::string msg;
};

[[noreturn]] void fail(const std::string& msg) { throw JpegError{msg}; }

struct Huffman {
  bool defined = false;
  // canonical code tables (jdhuff.c jpeg_make_d_derived_tbl)
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t huffval[256];
};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;             // Huffman tables of the current scan
  int bw = 0, bh = 0;             // blocks allocated (MCU-padded)
  int dw = 0, dh = 0;             // downsampled width and height
  bool quant_latched = false;
  uint16_t quant[64];             // natural order
  std::vector<int16_t> coef;      // bw * bh blocks of 64, natural order
  int pred = 0;
};

struct Decoder {
  const uint8_t* data;
  size_t n;
  size_t pos = 0;
  uint16_t qt[4][64];
  bool qt_defined[4] = {false, false, false, false};
  Huffman dc[4], ac[4];
  int restart_interval = 0;
  bool frame = false;
  int width = 0, height = 0, ncomp = 0;
  int hmax = 1, vmax = 1;
  Component comp[3];
  bool adobe = false;
  int adobe_transform = -1;
  bool jfif = false;
  // entropy-coded segment reader
  uint32_t bitbuf = 0;
  int bits = 0;
  bool hit_marker = false;

  uint8_t byte() {
    if (pos >= n) fail("unexpected end of data");
    return data[pos++];
  }
  int u16() {
    int hi = byte();
    return (hi << 8) | byte();
  }

  void read_dqt(size_t end) {
    while (pos < end) {
      const int pq_tq = byte();
      const int pq = pq_tq >> 4, tq = pq_tq & 15;
      if (tq > 3 || pq > 1) fail("bad DQT table");
      for (int i = 0; i < 64; ++i)
        qt[tq][kNatural[i]] = (uint16_t)(pq ? u16() : byte());
      qt_defined[tq] = true;
    }
  }

  void read_dht(size_t end) {
    while (pos < end) {
      const int tc_th = byte();
      const int tc = tc_th >> 4, th = tc_th & 15;
      if (tc > 1 || th > 3) fail("bad DHT table");
      uint8_t counts[17];
      int total = 0;
      for (int i = 1; i <= 16; ++i) total += counts[i] = byte();
      if (total > 256) fail("bad DHT table");
      Huffman& t = tc ? ac[th] : dc[th];
      for (int i = 0; i < total; ++i) t.huffval[i] = byte();
      // canonical codes, length by length
      int code = 0, p = 0;
      for (int l = 1; l <= 16; ++l) {
        if (counts[l]) {
          t.valoffset[l] = p - code;
          code += counts[l];
          p += counts[l];
          t.maxcode[l] = code - 1;
        } else {
          t.maxcode[l] = -1;
        }
        code <<= 1;
      }
      t.maxcode[17] = 0x7fffffff;
      t.defined = true;
    }
  }

  void read_sof(int marker) {
    if (frame) fail("more than one frame");
    const int precision = byte();
    if (precision != 8)
      fail("JPEG with " + std::to_string(precision) +
           "-bit samples is not supported (8-bit only)");
    height = u16();
    width = u16();
    ncomp = byte();
    if (height == 0) fail("JPEG height 0 (DNL-defined height) is not supported");
    if (width == 0) fail("JPEG width 0");
    if (ncomp == 4) fail("4-component (CMYK/YCCK) JPEG is not supported");
    if (ncomp != 1 && ncomp != 3)
      fail("JPEG with " + std::to_string(ncomp) + " components is not supported");
    (void)marker;
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[i];
      c.id = byte();
      const int hv = byte();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = byte();
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
        fail("bad component in SOF");
    }
    if (ncomp == 1) {
      // a single component is decoded unsubsampled whatever it declares
      comp[0].h = comp[0].v = 1;
    } else {
      const bool chroma11 = comp[1].h == 1 && comp[1].v == 1 &&
                            comp[2].h == 1 && comp[2].v == 1;
      const int h0 = comp[0].h, v0 = comp[0].v;
      if (!chroma11 || !((h0 == 1 && v0 == 1) || (h0 == 2 && v0 == 1) ||
                         (h0 == 2 && v0 == 2)))
        fail("JPEG sampling other than 4:4:4, 4:2:2 and 4:2:0 is not "
             "supported");
    }
    hmax = vmax = 1;
    for (int i = 0; i < ncomp; ++i) {
      hmax = std::max(hmax, comp[i].h);
      vmax = std::max(vmax, comp[i].v);
    }
    const int mcux = (width + 8 * hmax - 1) / (8 * hmax);
    const int mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[i];
      c.dw = (int)(((int64_t)width * c.h + hmax - 1) / hmax);
      c.dh = (int)(((int64_t)height * c.v + vmax - 1) / vmax);
      c.bw = mcux * c.h;
      c.bh = mcuy * c.v;
    }
    frame = true;
  }

  // --- entropy decoding (jdhuff.c semantics) ---
  void fill() {
    while (bits <= 24) {
      uint32_t b = 0;
      if (!hit_marker && pos < n) {
        b = data[pos];
        if (b == 0xFF) {
          // skip fill bytes; FF 00 is a data FF, FF xx a marker
          size_t q = pos + 1;
          while (q < n && data[q] == 0xFF) ++q;
          if (q < n && data[q] == 0x00) {
            pos = q + 1;
          } else {
            hit_marker = true;  // leave pos on the marker
            b = 0;
          }
        } else {
          ++pos;
        }
      }
      // past a marker (or the end), libjpeg feeds zero bits
      bitbuf |= b << (24 - bits);
      bits += 8;
    }
  }
  int getbits(int k) {
    if (k == 0) return 0;
    if (bits < k) fill();
    const int v = (int)(bitbuf >> (32 - k));
    bitbuf <<= k;
    bits -= k;
    return v;
  }
  int decode(const Huffman& t) {
    if (bits < 16) fill();
    int code = 0;
    for (int l = 1; l <= 16; ++l) {
      code = (code << 1) | (int)(bitbuf >> 31);
      bitbuf <<= 1;
      --bits;
      if (code <= t.maxcode[l]) return t.huffval[(t.valoffset[l] + code) & 0xFF];
    }
    // a corrupt code: libjpeg warns and returns 0
    return 0;
  }
  static int extend(int v, int s) {
    return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
  }

  void decode_block(Component& c, int16_t* blk) {
    const Huffman& d = dc[c.td];
    const Huffman& a = ac[c.ta];
    int s = decode(d);
    if (s) {
      if (s > 16) fail("corrupt JPEG data (DC magnitude)");
      s = extend(getbits(s), s);
    }
    c.pred += s;
    blk[0] = (int16_t)c.pred;
    for (int k = 1; k < 64; ++k) {
      const int rs = decode(a);
      const int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        blk[kNatural[k]] = (int16_t)extend(getbits(s), s);
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
  }

  void restart() {
    bitbuf = 0;
    bits = 0;
    hit_marker = false;
    // find the RSTn marker (libjpeg resyncs on whatever marker comes)
    while (pos + 1 < n && !(data[pos] == 0xFF && data[pos + 1] >= 0xD0 &&
                            data[pos + 1] <= 0xD7)) {
      if (data[pos] == 0xFF && data[pos + 1] != 0x00 && data[pos + 1] != 0xFF)
        break;  // another marker: leave it for the segment parser
      ++pos;
    }
    if (pos + 1 < n && data[pos] == 0xFF && data[pos + 1] >= 0xD0 &&
        data[pos + 1] <= 0xD7)
      pos += 2;
    for (int i = 0; i < ncomp; ++i) comp[i].pred = 0;
  }

  void read_sos() {
    if (!frame) fail("SOS before SOF");
    const int ns = byte();
    if (ns < 1 || ns > ncomp) fail("bad SOS");
    Component* sc[3];
    for (int i = 0; i < ns; ++i) {
      const int cid = byte();
      const int tdta = byte();
      Component* c = nullptr;
      for (int j = 0; j < ncomp; ++j)
        if (comp[j].id == cid) c = &comp[j];
      if (c == nullptr) fail("SOS names an unknown component");
      c->td = tdta >> 4;
      c->ta = tdta & 15;
      if (c->td > 3 || c->ta > 3 || !dc[c->td].defined || !ac[c->ta].defined)
        fail("SOS uses an undefined Huffman table");
      if (!c->quant_latched) {
        if (!qt_defined[c->tq]) fail("component uses an undefined DQT table");
        std::memcpy(c->quant, qt[c->tq], sizeof(c->quant));
        c->quant_latched = true;
      }
      if (c->coef.empty()) c->coef.assign((size_t)c->bw * c->bh * 64, 0);
      sc[i] = c;
    }
    const int ss = byte(), se = byte(), ahal = byte();
    if (ss != 0 || se != 63 || ahal != 0) fail("bad sequential SOS");
    for (int i = 0; i < ncomp; ++i) comp[i].pred = 0;
    bitbuf = 0;
    bits = 0;
    hit_marker = false;

    int mcus_x, mcus_y;
    if (ns == 1) {
      // non-interleaved: one block per MCU over the component's own blocks
      mcus_x = (sc[0]->dw + 7) / 8;
      mcus_y = (sc[0]->dh + 7) / 8;
    } else {
      mcus_x = (width + 8 * hmax - 1) / (8 * hmax);
      mcus_y = (height + 8 * vmax - 1) / (8 * vmax);
    }
    int64_t mcu = 0, todo = restart_interval;
    for (int my = 0; my < mcus_y; ++my) {
      for (int mx = 0; mx < mcus_x; ++mx, ++mcu) {
        if (restart_interval && todo == 0) {
          restart();
          todo = restart_interval;
        }
        if (ns == 1) {
          Component& c = *sc[0];
          decode_block(c, &c.coef[((size_t)my * c.bw + mx) * 64]);
        } else {
          for (int i = 0; i < ns; ++i) {
            Component& c = *sc[i];
            for (int by = 0; by < c.v; ++by)
              for (int bx = 0; bx < c.h; ++bx) {
                const size_t row = (size_t)my * c.v + by;
                const size_t col = (size_t)mx * c.h + bx;
                decode_block(c, &c.coef[(row * c.bw + col) * 64]);
              }
          }
        }
        if (restart_interval) --todo;
      }
    }
    (void)mcu;
    // back to the marker after the entropy-coded data
    bitbuf = 0;
    bits = 0;
    hit_marker = false;
    while (pos + 1 < n && !(data[pos] == 0xFF && data[pos + 1] != 0x00 &&
                            !(data[pos + 1] >= 0xD0 && data[pos + 1] <= 0xD7) &&
                            data[pos + 1] != 0xFF))
      ++pos;
  }

  // Parses markers up to the end of the image (decode_scans) or up to the
  // frame header (header only).
  void parse(bool decode_scans) {
    if (n < 4 || data[0] != 0xFF || data[1] != 0xD8) fail("not a JPEG file");
    pos = 2;
    for (;;) {
      // next marker, skipping fill bytes
      while (pos < n && data[pos] != 0xFF) ++pos;
      while (pos < n && data[pos] == 0xFF) ++pos;
      if (pos >= n) {
        if (decode_scans && frame) return;  // a truncated file ends the image
        fail("no frame header in JPEG file");
      }
      const int m = data[pos++];
      if (m == 0xD9) {
        if (!frame) fail("no frame header in JPEG file");
        return;
      }
      if (m == 0x01 || (m >= 0xD0 && m <= 0xD7)) continue;
      const size_t start = pos;
      const int len = u16();
      const size_t end = start + len;
      if (len < 2 || end > n) fail("truncated JPEG segment");
      if (m == 0xC0 || m == 0xC1) {
        read_sof(m);
        if (!decode_scans) return;
      } else if (m == 0xC2 || m == 0xC6 || m == 0xCA || m == 0xCE) {
        fail("progressive JPEG is not supported (baseline sequential only)");
      } else if (m == 0xC3 || m == 0xC7 || m == 0xCB || m == 0xCF) {
        fail("lossless JPEG is not supported (baseline sequential only)");
      } else if (m == 0xC5) {
        fail("hierarchical JPEG is not supported (baseline sequential only)");
      } else if (m == 0xC9) {
        fail("arithmetic-coded JPEG is not supported (Huffman only)");
      } else if (m == 0xCC) {
        fail("arithmetic-coded JPEG is not supported (Huffman only)");
      } else if (m == 0xC4) {
        read_dht(end);
      } else if (m == 0xDB) {
        read_dqt(end);
      } else if (m == 0xDD) {
        restart_interval = u16();
      } else if (m == 0xDA) {
        pos = start + 2;
        if (!decode_scans) fail("SOS before SOF");
        read_sos();
        continue;  // pos is on the next marker
      } else if (m == 0xE0) {
        if (len >= 7 && std::memcmp(data + start + 2, "JFIF\0", 5) == 0)
          jfif = true;
      } else if (m == 0xEE) {
        if (len >= 14 && std::memcmp(data + start + 2, "Adobe", 5) == 0) {
          adobe = true;
          adobe_transform = data[start + 13];
        }
      }
      pos = end;
    }
  }

  void check_colorspace() {
    if (ncomp != 3) return;
    // jdapimin.c default_decompress_parms
    bool rgb = false;
    if (jfif) {
      rgb = false;
    } else if (adobe) {
      rgb = adobe_transform == 0;
    } else if (comp[0].id == 82 && comp[1].id == 71 && comp[2].id == 66) {
      rgb = true;
    }
    if (rgb) fail("RGB-coded JPEG (no YCbCr transform) is not supported");
  }
};

// --- jidctint.c: jpeg_idct_islow ---
constexpr int kConstBits = 13, kPass1Bits = 2;
constexpr int32_t F0_298 = 2446, F0_390 = 3196, F0_541 = 4433, F0_765 = 6270,
                  F0_899 = 7373, F1_175 = 9633, F1_501 = 12299,
                  F1_847 = 15137, F1_961 = 16069, F2_053 = 16819,
                  F2_562 = 20995, F3_072 = 25172;

inline int32_t descale(int64_t x, int n) {
  return (int32_t)((x + ((int64_t)1 << (n - 1))) >> n);
}

// The post-IDCT range limit of jdmaster.c prepare_range_limit_table:
// index (x & 1023) for a centred result x.
struct IdctLimit {
  uint8_t t[1024];
  IdctLimit() {
    for (int i = 0; i < 1024; ++i) {
      int v;
      if (i < 128) v = i + 128;
      else if (i < 512) v = 255;
      else if (i < 896) v = 0;
      else v = i - 896;
      t[i] = (uint8_t)v;
    }
  }
};
const IdctLimit kLimit;

void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out,
                int64_t stride) {
  int32_t ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* ip = in + c;
    const uint16_t* qp = q + c;
    int64_t z1, z2, z3, z4, z5, tmp0, tmp1, tmp2, tmp3, tmp10, tmp11, tmp12,
        tmp13;
    z2 = (int64_t)ip[16] * qp[16];
    z3 = (int64_t)ip[48] * qp[48];
    z1 = (z2 + z3) * F0_541;
    tmp2 = z1 + z3 * (-F1_847);
    tmp3 = z1 + z2 * F0_765;
    z2 = (int64_t)ip[0] * qp[0];
    z3 = (int64_t)ip[32] * qp[32];
    tmp0 = (z2 + z3) * (1 << kConstBits);
    tmp1 = (z2 - z3) * (1 << kConstBits);
    tmp10 = tmp0 + tmp3;
    tmp13 = tmp0 - tmp3;
    tmp11 = tmp1 + tmp2;
    tmp12 = tmp1 - tmp2;
    tmp0 = (int64_t)ip[56] * qp[56];
    tmp1 = (int64_t)ip[40] * qp[40];
    tmp2 = (int64_t)ip[24] * qp[24];
    tmp3 = (int64_t)ip[8] * qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    z4 = tmp1 + tmp3;
    z5 = (z3 + z4) * F1_175;
    tmp0 = tmp0 * F0_298;
    tmp1 = tmp1 * F2_053;
    tmp2 = tmp2 * F3_072;
    tmp3 = tmp3 * F1_501;
    z1 = z1 * (-F0_899);
    z2 = z2 * (-F2_562);
    z3 = z3 * (-F1_961);
    z4 = z4 * (-F0_390);
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int n1 = kConstBits - kPass1Bits;
    ws[c + 0] = descale(tmp10 + tmp3, n1);
    ws[c + 56] = descale(tmp10 - tmp3, n1);
    ws[c + 8] = descale(tmp11 + tmp2, n1);
    ws[c + 48] = descale(tmp11 - tmp2, n1);
    ws[c + 16] = descale(tmp12 + tmp1, n1);
    ws[c + 40] = descale(tmp12 - tmp1, n1);
    ws[c + 24] = descale(tmp13 + tmp0, n1);
    ws[c + 32] = descale(tmp13 - tmp0, n1);
  }
  for (int r = 0; r < 8; ++r) {
    const int32_t* w = ws + r * 8;
    uint8_t* o = out + r * stride;
    int64_t z1, z2, z3, z4, z5, tmp0, tmp1, tmp2, tmp3, tmp10, tmp11, tmp12,
        tmp13;
    z2 = w[2];
    z3 = w[6];
    z1 = (z2 + z3) * F0_541;
    tmp2 = z1 + z3 * (-F1_847);
    tmp3 = z1 + z2 * F0_765;
    tmp0 = ((int64_t)w[0] + w[4]) * (1 << kConstBits);
    tmp1 = ((int64_t)w[0] - w[4]) * (1 << kConstBits);
    tmp10 = tmp0 + tmp3;
    tmp13 = tmp0 - tmp3;
    tmp11 = tmp1 + tmp2;
    tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    z4 = tmp1 + tmp3;
    z5 = (z3 + z4) * F1_175;
    tmp0 = tmp0 * F0_298;
    tmp1 = tmp1 * F2_053;
    tmp2 = tmp2 * F3_072;
    tmp3 = tmp3 * F1_501;
    z1 = z1 * (-F0_899);
    z2 = z2 * (-F2_562);
    z3 = z3 * (-F1_961);
    z4 = z4 * (-F0_390);
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int n2 = kConstBits + kPass1Bits + 3;
    o[0] = kLimit.t[descale(tmp10 + tmp3, n2) & 1023];
    o[7] = kLimit.t[descale(tmp10 - tmp3, n2) & 1023];
    o[1] = kLimit.t[descale(tmp11 + tmp2, n2) & 1023];
    o[6] = kLimit.t[descale(tmp11 - tmp2, n2) & 1023];
    o[2] = kLimit.t[descale(tmp12 + tmp1, n2) & 1023];
    o[5] = kLimit.t[descale(tmp12 - tmp1, n2) & 1023];
    o[3] = kLimit.t[descale(tmp13 + tmp0, n2) & 1023];
    o[4] = kLimit.t[descale(tmp13 - tmp0, n2) & 1023];
  }
}

// A component's samples: (bh*8, bw*8) with stride bw*8.
std::vector<uint8_t> component_plane(const Component& c) {
  const int64_t stride = (int64_t)c.bw * 8;
  std::vector<uint8_t> plane((size_t)stride * c.bh * 8);
  if (c.coef.empty()) fail("a component has no scan");
  for (int by = 0; by < c.bh; ++by)
    for (int bx = 0; bx < c.bw; ++bx)
      idct_islow(&c.coef[((size_t)by * c.bw + bx) * 64], c.quant,
                 &plane[(size_t)by * 8 * stride + (size_t)bx * 8], stride);
  return plane;
}

// Chroma upsampled to (height, width) by jdsample.c's rules, from the
// component's dw x dh samples (the rows and columns past them are the
// blocks' padding, never read: edges are replicated instead).
std::vector<uint8_t> upsample(const Component& c, const std::vector<uint8_t>& p,
                              int hmax, int vmax, int width, int height) {
  const int64_t stride = (int64_t)c.bw * 8;
  const int hf = hmax / c.h, vf = vmax / c.v;
  const int64_t ow = (int64_t)c.dw * hf;  // upsampled row, >= width
  std::vector<uint8_t> out((size_t)width * height);
  std::vector<uint8_t> row(ow);
  auto src = [&](int64_t y) { return &p[(size_t)y * stride]; };
  const bool fancy = c.dw > 2;
  for (int y = 0; y < height; ++y) {
    if (hf == 1 && vf == 1) {
      std::memcpy(row.data(), src(y), (size_t)width);
    } else if (hf == 2 && vf == 1) {
      const uint8_t* in = src(y);
      if (!fancy) {
        for (int64_t x = 0; x < c.dw; ++x) row[2 * x] = row[2 * x + 1] = in[x];
      } else {
        // h2v1_fancy_upsample
        int v0 = in[0];
        row[0] = (uint8_t)v0;
        row[1] = (uint8_t)((v0 * 3 + in[1] + 2) >> 2);
        for (int64_t x = 1; x < c.dw - 1; ++x) {
          const int v = in[x] * 3;
          row[2 * x] = (uint8_t)((v + in[x - 1] + 1) >> 2);
          row[2 * x + 1] = (uint8_t)((v + in[x + 1] + 2) >> 2);
        }
        const int64_t x = c.dw - 1;
        row[2 * x] = (uint8_t)((in[x] * 3 + in[x - 1] + 1) >> 2);
        row[2 * x + 1] = in[x];
      }
    } else {  // 2 x 2
      const int64_t iy = y / 2;
      const uint8_t* in0 = src(iy);
      if (!fancy) {
        for (int64_t x = 0; x < c.dw; ++x)
          row[2 * x] = row[2 * x + 1] = in0[x];
      } else {
        // h2v2_fancy_upsample: the nearer row x3 plus the further one (the
        // row above for an even output row, below for an odd one; the
        // first and last rows stand in for rows past the image's edge)
        const int64_t other = (y % 2 == 0) ? std::max<int64_t>(iy - 1, 0)
                                           : std::min<int64_t>(iy + 1, c.dh - 1);
        const uint8_t* in1 = src(other);
        int this_sum = in0[0] * 3 + in1[0];
        int next_sum = in0[1] * 3 + in1[1];
        row[0] = (uint8_t)((this_sum * 4 + 8) >> 4);
        row[1] = (uint8_t)((this_sum * 3 + next_sum + 7) >> 4);
        int last_sum = this_sum;
        this_sum = next_sum;
        for (int64_t x = 1; x < c.dw - 1; ++x) {
          next_sum = in0[x + 1] * 3 + in1[x + 1];
          row[2 * x] = (uint8_t)((this_sum * 3 + last_sum + 8) >> 4);
          row[2 * x + 1] = (uint8_t)((this_sum * 3 + next_sum + 7) >> 4);
          last_sum = this_sum;
          this_sum = next_sum;
        }
        const int64_t x = c.dw - 1;
        row[2 * x] = (uint8_t)((this_sum * 3 + last_sum + 8) >> 4);
        row[2 * x + 1] = (uint8_t)((this_sum * 4 + 7) >> 4);
      }
    }
    std::memcpy(&out[(size_t)y * width], row.data(), (size_t)width);
  }
  return out;
}

void write_err(const std::string& msg, char* err, int64_t errlen) {
  if (errlen > 0) std::snprintf(err, (size_t)errlen, "%s", msg.c_str());
}

}  // namespace

extern "C" {

// Frame header: height, width and the output channels (1 or 3).
int jpeg_header(const uint8_t* data, int64_t n, int64_t* hwc, char* err,
                int64_t errlen) {
  try {
    Decoder d;
    d.data = data;
    d.n = (size_t)n;
    d.parse(false);
    hwc[0] = d.height;
    hwc[1] = d.width;
    hwc[2] = d.ncomp;
    return 0;
  } catch (const JpegError& e) {
    write_err(e.msg, err, errlen);
    return 1;
  }
}

// Decodes into out: (H, W) for one component, (H, W, 3) RGB for three.
int jpeg_decode(const uint8_t* data, int64_t n, uint8_t* out, int64_t h,
                int64_t w, int64_t c, char* err, int64_t errlen) {
  try {
    Decoder d;
    d.data = data;
    d.n = (size_t)n;
    d.parse(true);
    if (d.height != h || d.width != w || d.ncomp != c)
      fail("output buffer does not match the frame header");
    d.check_colorspace();
    const int W = d.width, H = d.height;
    if (d.ncomp == 1) {
      const std::vector<uint8_t> y = component_plane(d.comp[0]);
      const int64_t stride = (int64_t)d.comp[0].bw * 8;
      for (int r = 0; r < H; ++r)
        std::memcpy(out + (size_t)r * W, &y[(size_t)r * stride], (size_t)W);
      return 0;
    }
    std::vector<uint8_t> planes[3];
    for (int i = 0; i < 3; ++i) {
      const std::vector<uint8_t> p = component_plane(d.comp[i]);
      planes[i] = upsample(d.comp[i], p, d.hmax, d.vmax, W, H);
    }
    // jdcolor.c build_ycc_rgb_table / ycc_rgb_convert
    constexpr int kScale = 16;
    constexpr int64_t kHalf = (int64_t)1 << (kScale - 1);
    auto fix = [](double x) { return (int64_t)(x * (1L << kScale) + 0.5); };
    int cr_r[256], cb_b[256];
    int64_t cr_g[256], cb_g[256];
    for (int i = 0, x = -128; i < 256; ++i, ++x) {
      cr_r[i] = (int)((fix(1.40200) * x + kHalf) >> kScale);
      cb_b[i] = (int)((fix(1.77200) * x + kHalf) >> kScale);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + kHalf;
    }
    auto clamp = [](int v) { return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v)); };
    const size_t npx = (size_t)W * H;
    for (size_t i = 0; i < npx; ++i) {
      const int y = planes[0][i], cb = planes[1][i], cr = planes[2][i];
      out[i * 3 + 0] = clamp(y + cr_r[cr]);
      out[i * 3 + 1] = clamp(y + (int)((cb_g[cb] + cr_g[cr]) >> kScale));
      out[i * 3 + 2] = clamp(y + cb_b[cb]);
    }
    return 0;
  } catch (const JpegError& e) {
    write_err(e.msg, err, errlen);
    return 1;
  } catch (const std::bad_alloc&) {
    write_err("out of memory decoding JPEG", err, errlen);
    return 1;
  }
}

}  // extern "C"
