// Baseline JPEG encoder of the PyTorch port: the stream libjpeg-turbo
// writes at its defaults, which is what cv2.imencode(".jpg", ...) and
// PIL's Image.save(..., "JPEG") produce.
//
//   JFIF 1.01 header, 8-bit samples, the quality-scaled standard tables
//   with force_baseline (every entry clamped to 1..255), the standard
//   Huffman tables (no optimisation), no restart markers.
//   The fixed-point RGB -> YCbCr conversion (16 fraction bits, Cb/Cr
//   rounded with 0.5 - epsilon), 4:2:0 sampling by h2v2 averaging with
//   the alternating 1, 2 bias, edges replicated to whole MCUs as
//   jcprepct.c and jcsample.c do, and dummy blocks at the right and bottom
//   that repeat their left neighbour's DC.
//   islow forward DCT (jfdctint.c), quantisation by libjpeg-turbo's
//   reciprocal multiply (jcdctmgr.c compute_reciprocal).
//
// Built into the same library as ufr_native.cpp (see native/__init__.py).

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

const uint8_t kStdLuma[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const uint8_t kStdChroma[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};
// natural index of the k-th coefficient in zigzag order
const int kNatural[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

const uint8_t kDcLumaBits[16] = {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChromaBits[16] = {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumaBits[16] = {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumaVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
    0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
    0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChromaBits[16] = {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChromaVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
    0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
    0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
    0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
    0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

struct Huff {
  uint16_t code[256];
  uint8_t size[256];
  const uint8_t* bits;
  const uint8_t* vals;
  int nvals;
};

// jchuff.c jpeg_make_c_derived_tbl: canonical codes by length
void make_huff(Huff* h, const uint8_t* bits, const uint8_t* vals, int nvals) {
  h->bits = bits;
  h->vals = vals;
  h->nvals = nvals;
  std::memset(h->code, 0, sizeof h->code);
  std::memset(h->size, 0, sizeof h->size);
  int k = 0;
  uint32_t code = 0;
  for (int len = 1; len <= 16; ++len) {
    for (int i = 0; i < bits[len - 1]; ++i, ++k) {
      h->code[vals[k]] = (uint16_t)code;
      h->size[vals[k]] = (uint8_t)len;
      ++code;
    }
    code <<= 1;
  }
}

// jcparam.c jpeg_quality_scaling + jpeg_add_quant_table(force_baseline)
void make_quant(const uint8_t* basic, int quality, uint16_t* out) {
  if (quality <= 0) quality = 1;
  if (quality > 100) quality = 100;
  const long scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
  for (int i = 0; i < 64; ++i) {
    long t = ((long)basic[i] * scale + 50L) / 100L;
    if (t <= 0L) t = 1L;
    if (t > 32767L) t = 32767L;
    if (t > 255L) t = 255L;
    out[i] = (uint16_t)t;
  }
}

// jcdctmgr.c compute_reciprocal for 16-bit DCTELEMs: q = ((|x| + corr) *
// recip) >> shift, sign restored; divisor = 8 * a quantisation step >= 8
struct Recip {
  uint32_t recip, corr;
  int shift;
};

Recip compute_reciprocal(uint16_t divisor) {
  Recip r;
  int b = 0;
  while ((1u << (b + 1)) <= divisor) ++b;  // floor(log2(divisor))
  int sh = 16 + b;
  uint32_t fq = (uint32_t)((1ull << sh) / divisor);
  const uint32_t fr = (uint32_t)((1ull << sh) % divisor);
  uint32_t c = divisor / 2;
  if (fr == 0) {
    fq >>= 1;
    --sh;
  } else if (fr <= divisor / 2u) {
    ++c;
  } else {
    ++fq;
  }
  r.recip = fq & 0xffff;
  r.corr = c & 0xffff;
  r.shift = sh;
  return r;
}

// jfdctint.c (libjpeg 6b islow, as libjpeg-turbo keeps it): output scaled
// up by 8
constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;
inline int32_t descale(int64_t x, int n) {
  return (int32_t)((x + ((int64_t)1 << (n - 1))) >> n);
}

void fdct_islow(int32_t* data) {
  const int32_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270,
                F0899 = 7373, F1175 = 9633, F1501 = 12299, F1847 = 15137,
                F1961 = 16069, F2053 = 16819, F2562 = 20995, F3072 = 25172;
  for (int r = 0; r < 8; ++r) {
    int32_t* d = data + r * 8;
    const int32_t tmp0 = d[0] + d[7], tmp7 = d[0] - d[7];
    const int32_t tmp1 = d[1] + d[6], tmp6 = d[1] - d[6];
    const int32_t tmp2 = d[2] + d[5], tmp5 = d[2] - d[5];
    const int32_t tmp3 = d[3] + d[4], tmp4 = d[3] - d[4];
    const int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    const int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    d[0] = (tmp10 + tmp11) * (1 << kPass1Bits);
    d[4] = (tmp10 - tmp11) * (1 << kPass1Bits);
    int64_t z1 = (int64_t)(tmp12 + tmp13) * F0541;
    d[2] = descale(z1 + (int64_t)tmp13 * F0765, kConstBits - kPass1Bits);
    d[6] = descale(z1 - (int64_t)tmp12 * F1847, kConstBits - kPass1Bits);
    z1 = tmp4 + tmp7;
    int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    const int64_t z5 = (z3 + z4) * F1175;
    const int64_t t4 = (int64_t)tmp4 * F0298, t5 = (int64_t)tmp5 * F2053,
                  t6 = (int64_t)tmp6 * F3072, t7 = (int64_t)tmp7 * F1501;
    z1 *= -F0899;
    z2 *= -F2562;
    z3 *= -F1961;
    z4 *= -F0390;
    z3 += z5;
    z4 += z5;
    d[7] = descale(t4 + z1 + z3, kConstBits - kPass1Bits);
    d[5] = descale(t5 + z2 + z4, kConstBits - kPass1Bits);
    d[3] = descale(t6 + z2 + z3, kConstBits - kPass1Bits);
    d[1] = descale(t7 + z1 + z4, kConstBits - kPass1Bits);
  }
  for (int c = 0; c < 8; ++c) {
    int32_t* d = data + c;
    const int32_t tmp0 = d[0] + d[56], tmp7 = d[0] - d[56];
    const int32_t tmp1 = d[8] + d[48], tmp6 = d[8] - d[48];
    const int32_t tmp2 = d[16] + d[40], tmp5 = d[16] - d[40];
    const int32_t tmp3 = d[24] + d[32], tmp4 = d[24] - d[32];
    const int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    const int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    d[0] = descale(tmp10 + tmp11, kPass1Bits);
    d[32] = descale(tmp10 - tmp11, kPass1Bits);
    int64_t z1 = (int64_t)(tmp12 + tmp13) * F0541;
    d[16] = descale(z1 + (int64_t)tmp13 * F0765, kConstBits + kPass1Bits);
    d[48] = descale(z1 - (int64_t)tmp12 * F1847, kConstBits + kPass1Bits);
    z1 = tmp4 + tmp7;
    int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    const int64_t z5 = (z3 + z4) * F1175;
    const int64_t t4 = (int64_t)tmp4 * F0298, t5 = (int64_t)tmp5 * F2053,
                  t6 = (int64_t)tmp6 * F3072, t7 = (int64_t)tmp7 * F1501;
    z1 *= -F0899;
    z2 *= -F2562;
    z3 *= -F1961;
    z4 *= -F0390;
    z3 += z5;
    z4 += z5;
    d[56] = descale(t4 + z1 + z3, kConstBits + kPass1Bits);
    d[40] = descale(t5 + z2 + z4, kConstBits + kPass1Bits);
    d[24] = descale(t6 + z2 + z3, kConstBits + kPass1Bits);
    d[8] = descale(t7 + z1 + z4, kConstBits + kPass1Bits);
  }
}

struct Writer {
  std::vector<uint8_t> buf;
  uint32_t acc = 0;
  int nbits = 0;
  void byte(uint8_t b) { buf.push_back(b); }
  void word(int v) {
    byte((uint8_t)(v >> 8));
    byte((uint8_t)v);
  }
  void bits(uint32_t v, int n) {  // MSB first, 0xFF stuffed
    if (n == 0) return;
    acc = (acc << n) | (v & ((1u << n) - 1));
    nbits += n;
    while (nbits >= 8) {
      const uint8_t b = (uint8_t)(acc >> (nbits - 8));
      byte(b);
      if (b == 0xFF) byte(0);
      nbits -= 8;
    }
    acc &= (1u << nbits) - 1;
  }
  void flush() {  // pad with 1 bits
    if (nbits > 0) bits(0x7F, 8 - nbits);
  }
};

inline int bitcount(int v) {
  int n = 0;
  while (v) {
    ++n;
    v >>= 1;
  }
  return n;
}

void encode_block(Writer* w, const int16_t* blk, int* last_dc, const Huff& dc,
                  const Huff& ac) {
  int temp = blk[0] - *last_dc, temp2 = temp;
  *last_dc = blk[0];
  if (temp < 0) {
    temp = -temp;
    --temp2;
  }
  int nb = bitcount(temp);
  w->bits(dc.code[nb], dc.size[nb]);
  w->bits((uint32_t)temp2, nb);
  int r = 0;
  for (int k = 1; k < 64; ++k) {
    temp = blk[kNatural[k]];
    if (temp == 0) {
      ++r;
      continue;
    }
    while (r > 15) {
      w->bits(ac.code[0xF0], ac.size[0xF0]);
      r -= 16;
    }
    temp2 = temp;
    if (temp < 0) {
      temp = -temp;
      --temp2;
    }
    nb = bitcount(temp);
    const int i = (r << 4) + nb;
    w->bits(ac.code[i], ac.size[i]);
    w->bits((uint32_t)temp2, nb);
    r = 0;
  }
  if (r > 0) w->bits(ac.code[0], ac.size[0]);
}

// One 8x8 block of a plane (already edge-extended to cover it): level
// shift, DCT, quantise.
void code_block(const uint8_t* plane, int64_t stride, int64_t y0, int64_t x0,
                const Recip* q, int16_t* out) {
  int32_t d[64];
  for (int r = 0; r < 8; ++r)
    for (int c = 0; c < 8; ++c)
      d[r * 8 + c] = (int32_t)plane[(y0 + r) * stride + x0 + c] - 128;
  fdct_islow(d);
  for (int i = 0; i < 64; ++i) {
    int32_t t = d[i];
    const bool neg = t < 0;
    if (neg) t = -t;
    uint32_t p = (uint32_t)(((uint64_t)((uint32_t)t + q[i].corr) * q[i].recip)
                            >> q[i].shift);
    out[i] = (int16_t)(neg ? -(int32_t)p : (int32_t)p);
  }
}

void write_dqt(Writer* w, int idx, const uint16_t* q) {
  w->word(0xFFDB);
  w->word(2 + 1 + 64);
  w->byte((uint8_t)idx);
  for (int k = 0; k < 64; ++k) w->byte((uint8_t)q[kNatural[k]]);
}

void write_dht(Writer* w, int idx, const Huff& h) {
  w->word(0xFFC4);
  w->word(2 + 1 + 16 + h.nvals);
  w->byte((uint8_t)idx);
  for (int i = 0; i < 16; ++i) w->byte(h.bits[i]);
  for (int i = 0; i < h.nvals; ++i) w->byte(h.vals[i]);
}

}  // namespace

extern "C" {

// Encode a u8 (h, w, 3) RGB image at `quality` (1-100).  Writes at most `cap` bytes into `out` and returns the size of
// the file; when that exceeds `cap` nothing useful is written and the
// caller retries with a buffer of the returned size.  Returns -1 for an
// unsupported shape.
int64_t jpeg_encode(const uint8_t* img, int64_t h, int64_t w, int quality,
                    uint8_t* out, int64_t cap) {
  if (h <= 0 || w <= 0 || h > 65535 || w > 65535) return -1;
  uint16_t ql[64], qc[64];
  make_quant(kStdLuma, quality, ql);
  make_quant(kStdChroma, quality, qc);
  Recip rl[64], rc[64];
  for (int i = 0; i < 64; ++i) {
    rl[i] = compute_reciprocal((uint16_t)(ql[i] << 3));
    rc[i] = compute_reciprocal((uint16_t)(qc[i] << 3));
  }
  Huff dcl, acl, dcc, acc;
  make_huff(&dcl, kDcLumaBits, kDcVals, 12);
  make_huff(&acl, kAcLumaBits, kAcLumaVals, 162);
  make_huff(&dcc, kDcChromaBits, kDcVals, 12);
  make_huff(&acc, kAcChromaBits, kAcChromaVals, 162);

  Writer wr;
  wr.buf.reserve((size_t)(h * w * 3 / 4 + 1024));
  wr.word(0xFFD8);
  // APP0 JFIF 1.01, no units, 1:1 density, no thumbnail
  wr.word(0xFFE0);
  wr.word(16);
  const uint8_t jfif[5] = {'J', 'F', 'I', 'F', 0};
  for (uint8_t b : jfif) wr.byte(b);
  wr.byte(1);
  wr.byte(1);
  wr.byte(0);
  wr.word(1);
  wr.word(1);
  wr.byte(0);
  wr.byte(0);
  write_dqt(&wr, 0, ql);
  write_dqt(&wr, 1, qc);
  // SOF0: Y 2x2 on table 0, Cb and Cr 1x1 on table 1
  wr.word(0xFFC0);
  wr.word(8 + 3 * 3);
  wr.byte(8);
  wr.word((int)h);
  wr.word((int)w);
  wr.byte(3);
  for (int k = 0; k < 3; ++k) {
    wr.byte((uint8_t)(k + 1));
    wr.byte(k == 0 ? 0x22 : 0x11);
    wr.byte(k == 0 ? 0 : 1);
  }
  write_dht(&wr, 0x00, dcl);
  write_dht(&wr, 0x10, acl);
  write_dht(&wr, 0x01, dcc);
  write_dht(&wr, 0x11, acc);
  wr.word(0xFFDA);
  wr.word(6 + 2 * 3);
  wr.byte(3);
  for (int k = 0; k < 3; ++k) {
    wr.byte((uint8_t)(k + 1));
    wr.byte(k == 0 ? 0x00 : 0x11);
  }
  wr.byte(0);
  wr.byte(63);
  wr.byte(0);

  const int vs = 2;  // luma blocks per MCU side
  const int64_t mcu = 8 * vs;
  const int64_t mcu_rows = (h + mcu - 1) / mcu, mcu_cols = (w + mcu - 1) / mcu;
  const int64_t ybw = (w + 7) / 8, ybh = (h + 7) / 8;  // real luma blocks
  // luma plane, edge-replicated to whole MCUs
  const int64_t ph = mcu_rows * mcu, pw = mcu_cols * mcu;
  std::vector<uint8_t> Y((size_t)(ph * pw));
  std::vector<uint8_t> Cb, Cr;
  const int64_t ch = mcu_rows * 8, cw = mcu_cols * 8;
  {
    // jccolor.c rgb_ycc_convert: 16 fraction bits
    const int32_t SB = 16, HALF = 1 << 15, OFF = 128 << 16;
    auto fix = [](double x) { return (int32_t)(x * 65536.0 + 0.5); };
    const int32_t ry = fix(0.29900), gy = fix(0.58700), by = fix(0.11400);
    const int32_t rcb = fix(0.16874), gcb = fix(0.33126), bcb = fix(0.5);
    const int32_t gcr = fix(0.41869), bcr = fix(0.08131);
    // full-resolution planes of the even-height, 16-aligned-width image
    const int64_t fh = (h + 1) / 2 * 2, fw = pw;
    std::vector<uint8_t> fy((size_t)(fh * fw)), fcb(fy.size()), fcr(fy.size());
    for (int64_t y = 0; y < fh; ++y) {
      const uint8_t* row = img + (y < h ? y : h - 1) * w * 3;
      for (int64_t x = 0; x < fw; ++x) {
        const uint8_t* p = row + (x < w ? x : w - 1) * 3;
        const int32_t r = p[0], g = p[1], b = p[2];
        fy[y * fw + x] = (uint8_t)((ry * r + gy * g + by * b + HALF) >> SB);
        fcb[y * fw + x] =
            (uint8_t)((-rcb * r - gcb * g + bcb * b + OFF + HALF - 1) >> SB);
        fcr[y * fw + x] =
            (uint8_t)((bcb * r - gcr * g - bcr * b + OFF + HALF - 1) >> SB);
      }
    }
    for (int64_t y = 0; y < ph; ++y) {
      const int64_t sy = y < fh ? y : fh - 1;
      std::memcpy(&Y[y * pw], &fy[sy * fw], (size_t)pw);
    }
    // jcsample.c h2v2_downsample, then the last chroma row repeated down
    Cb.resize((size_t)(ch * cw));
    Cr.resize(Cb.size());
    const int64_t crows = fh / 2;
    for (int64_t y = 0; y < ch; ++y) {
      const int64_t sy = y < crows ? y : crows - 1;
      const uint8_t* a0 = &fcb[2 * sy * fw];
      const uint8_t* a1 = a0 + fw;
      const uint8_t* b0 = &fcr[2 * sy * fw];
      const uint8_t* b1 = b0 + fw;
      int bias = 1;
      for (int64_t x = 0; x < cw; ++x) {
        Cb[y * cw + x] = (uint8_t)((a0[2 * x] + a0[2 * x + 1] + a1[2 * x] +
                                    a1[2 * x + 1] + bias) >> 2);
        Cr[y * cw + x] = (uint8_t)((b0[2 * x] + b0[2 * x + 1] + b1[2 * x] +
                                    b1[2 * x + 1] + bias) >> 2);
        bias ^= 3;
      }
    }
  }

  int dc[3] = {0, 0, 0};
  int16_t blk[4][64];
  int16_t cblk[64];
  for (int64_t my = 0; my < mcu_rows; ++my) {
    for (int64_t mx = 0; mx < mcu_cols; ++mx) {
      // luma blocks of this MCU in raster order; those past the image's
      // blocks repeat the DC of the block before them (jccoefct.c)
      int n = 0;
      for (int by = 0; by < vs; ++by) {
        for (int bx = 0; bx < vs; ++bx, ++n) {
          const int64_t gy = my * vs + by, gx = mx * vs + bx;
          if (gy < ybh && gx < ybw) {
            code_block(Y.data(), pw, gy * 8, gx * 8, rl, blk[n]);
          } else {
            std::memset(blk[n], 0, sizeof blk[n]);
            blk[n][0] = gy < ybh ? blk[n - 1][0] : blk[by * vs - 1][0];
          }
        }
      }
      for (int k = 0; k < n; ++k) encode_block(&wr, blk[k], &dc[0], dcl, acl);
      code_block(Cb.data(), cw, my * 8, mx * 8, rc, cblk);
      encode_block(&wr, cblk, &dc[1], dcc, acc);
      code_block(Cr.data(), cw, my * 8, mx * 8, rc, cblk);
      encode_block(&wr, cblk, &dc[2], dcc, acc);
    }
  }
  wr.flush();
  wr.word(0xFFD9);
  const int64_t size = (int64_t)wr.buf.size();
  if (size <= cap) std::memcpy(out, wr.buf.data(), (size_t)size);
  return size;
}

}  // extern "C"
