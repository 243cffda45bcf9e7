// Baseline JPEG decoder of the port's host library, in libjpeg-turbo's
// arithmetic, so that its pixels are `cv2.imread(path, IMREAD_COLOR)`'s.
//
// Decodes Huffman-coded baseline and extended 8-bit sequential JPEG
// (SOF0, SOF1) of 1 or 3 components, the luma sampled 1x1, 2x1 or 2x2
// over 1x1 chroma, interleaved and non-interleaved scans, restart
// intervals.  Each block is dequantised and inverse transformed by
// libjpeg's ISLOW IDCT (jidctint.c: 13-bit constants, 2 extra bits in
// pass 1, the result clamped to [0, 255] as its SIMD versions pack it),
// chroma upsampled by libjpeg's "fancy" triangle filters (jdsample.c:
// h2v1 and h2v2 with their alternating rounding biases, edges
// replicated; plain replication where the chroma is 2 samples wide or
// less), and YCbCr turned into BGR by jdcolor.c's 16-bit fixed-point
// tables.  Progressive, lossless, hierarchical and arithmetic-coded
// files, other sample precisions, 2 or 4 components and other sampling
// factors are refused, as is data that is truncated or corrupt: an
// error message, never a partial image.
//
// The EXIF orientation tag (APP1, IFD0 tag 0x0112) is reported to the
// caller, which applies it as cv2.imread does.
//
// C interface (ctypes, which releases the GIL during the call):
//   aidet_jpeg_info(data, n, &h, &w, &orientation, err, errlen)
//   aidet_jpeg_decode(data, n, out, h, w, err, errlen)   out: h*w*3 BGR
// Both return 0, or -1 with a message in err.

#include <stdarg.h>
#include <stdint.h>
#include <stdio.h>
#include <string.h>

#include <new>
#include <vector>

namespace {

struct Failure {
  char msg[256];
};

[[noreturn]] void fail(const char* fmt, ...) {
  Failure f;
  va_list ap;
  va_start(ap, fmt);
  vsnprintf(f.msg, sizeof f.msg, fmt, ap);
  va_end(ap);
  throw f;
}

// zigzag position -> natural (row-major) position
const uint8_t kNatural[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

constexpr int kLookBits = 9;

struct Huffman {
  bool defined = false;
  int maxcode[18];
  int valoffset[18];
  uint8_t values[256];
  uint16_t look[1 << kLookBits];  // (length << 8) | value; 0: longer code
};

void build_huffman(Huffman& t, const uint8_t* counts, const uint8_t* values,
                   int nvalues) {
  uint8_t size[257];
  unsigned code_of[257];
  int p = 0;
  for (int len = 1; len <= 16; ++len)
    for (int i = 0; i < counts[len - 1]; ++i) size[p++] = (uint8_t)len;
  size[p] = 0;
  unsigned code = 0;
  int si = size[0];
  p = 0;
  while (size[p]) {
    while (size[p] == si) code_of[p++] = code++;
    if (code >= (1u << si)) fail("corrupt JPEG: bad Huffman table");
    code <<= 1;
    ++si;
  }
  p = 0;
  for (int len = 1; len <= 16; ++len) {
    if (counts[len - 1]) {
      t.valoffset[len] = p - (int)code_of[p];
      p += counts[len - 1];
      t.maxcode[len] = (int)code_of[p - 1];
    } else {
      t.maxcode[len] = -1;
    }
  }
  t.maxcode[17] = 0xFFFFF;
  memcpy(t.values, values, nvalues);
  memset(t.look, 0, sizeof t.look);
  p = 0;
  for (int len = 1; len <= kLookBits; ++len) {
    for (int i = 0; i < counts[len - 1]; ++i, ++p) {
      unsigned bits = code_of[p] << (kLookBits - len);
      for (int c = 1 << (kLookBits - len); c > 0; --c)
        t.look[bits++] = (uint16_t)((len << 8) | values[p]);
    }
  }
  t.defined = true;
}

// The entropy-coded segment's bits.  Past a marker or the end of the data
// it reads zeros, as libjpeg does, but consuming one of those is an error.
struct Bits {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t acc = 0;
  int n = 0;      // bits in acc (the low n bits; the next bit is bit n-1)
  int fake = 0;   // of which the last `fake` are zeros past the segment
  bool stopped = false;

  void fill() {
    while (n <= 56) {
      int byte = 0;
      if (!stopped) {
        if (p >= end) {
          stopped = true;
        } else if (*p != 0xFF) {
          byte = *p++;
        } else {
          const uint8_t* q = p + 1;
          while (q < end && *q == 0xFF) ++q;   // fill bytes
          if (q < end && *q == 0x00) {
            byte = 0xFF;
            p = q + 1;
          } else {
            stopped = true;                    // a marker (p stays on it)
          }
        }
      }
      acc = (acc << 8) | (uint64_t)byte;
      n += 8;
      if (stopped) fake += 8;
    }
  }
  void consume(int k) {
    if (k > n - fake)
      fail("truncated or corrupt JPEG: the entropy-coded data ends early");
    n -= k;
  }
  unsigned peek(int k) {
    if (n < k) fill();
    return (unsigned)(acc >> (n - k)) & ((1u << k) - 1);
  }
  int get(int k) {
    if (k == 0) return 0;
    unsigned v = peek(k);
    consume(k);
    return (int)v;
  }
  int decode(const Huffman& t) {
    if (n < 16) fill();
    unsigned look = t.look[peek(kLookBits)];
    if (look) {
      consume(look >> 8);
      return look & 0xFF;
    }
    int len = kLookBits + 1;
    int code = (int)peek(len);
    while (code > t.maxcode[len]) {
      ++len;
      if (len > 16) fail("corrupt JPEG: bad Huffman code");
      code = (int)peek(len);
    }
    consume(len);
    return t.values[(code + t.valoffset[len]) & 0xFF];
  }
  // drop the bits left in the segment (a restart's byte alignment)
  void reset() {
    acc = 0;
    n = fake = 0;
    stopped = false;
  }
};

inline int extend(int v, int s) {
  return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

struct Component {
  int id, h, v, tq;
  int dw, dh;          // samples of the component (downsampled size)
  int bw, bh;          // blocks allocated (whole MCUs)
  int dc_table = 0, ac_table = 0;
  int pred = 0;
  std::vector<uint8_t> plane;  // bw*8 x bh*8
};

struct Decoder {
  const uint8_t* data;
  const uint8_t* end;
  const uint8_t* p;
  bool decode_pixels;

  int width = 0, height = 0, ncomp = 0, hmax = 1, vmax = 1;
  bool have_frame = false, jfif = false, adobe = false;
  int adobe_transform = -1;
  int orientation = 1;
  int restart_interval = 0;
  int quant[4][64];
  bool quant_defined[4] = {false, false, false, false};
  Huffman dc[4], ac[4];
  Component comp[3];

  int u8() {
    if (p >= end) fail("truncated JPEG: the data ends inside a marker");
    return *p++;
  }
  int u16() {
    int hi = u8();
    return (hi << 8) | u8();
  }

  void parse_exif(const uint8_t* s, int len) {
    if (len < 14 || memcmp(s, "Exif\0\0", 6) != 0) return;
    const uint8_t* t = s + 6;
    int tl = len - 6;
    bool little;
    if (t[0] == 'I' && t[1] == 'I') little = true;
    else if (t[0] == 'M' && t[1] == 'M') little = false;
    else return;
    auto rd16 = [&](int o) -> int {
      if (o < 0 || o + 2 > tl) return -1;
      return little ? t[o] | (t[o + 1] << 8) : (t[o] << 8) | t[o + 1];
    };
    auto rd32 = [&](int o) -> long {
      if (o < 0 || o + 4 > tl) return -1;
      return little ? (long)t[o] | ((long)t[o + 1] << 8) |
                          ((long)t[o + 2] << 16) | ((long)t[o + 3] << 24)
                    : ((long)t[o] << 24) | ((long)t[o + 1] << 16) |
                          ((long)t[o + 2] << 8) | (long)t[o + 3];
    };
    if (rd16(2) != 42) return;
    long ifd = rd32(4);
    if (ifd < 8 || ifd >= tl) return;
    int count = rd16((int)ifd);
    for (int i = 0; i < count; ++i) {
      int e = (int)ifd + 2 + 12 * i;
      if (e + 12 > tl) return;
      if (rd16(e) == 0x0112 && rd16(e + 2) == 3) {
        int o = rd16(e + 8);
        if (o >= 1 && o <= 8) orientation = o;
        return;
      }
    }
  }

  void parse_app(int marker, int len) {
    const uint8_t* s = p;
    if (marker == 0xE0 && len >= 5 && memcmp(s, "JFIF\0", 5) == 0)
      jfif = true;
    else if (marker == 0xE1 && orientation == 1)
      parse_exif(s, len);
    else if (marker == 0xEE && len >= 12 && memcmp(s, "Adobe", 5) == 0) {
      adobe = true;
      adobe_transform = s[11];
    }
  }

  void parse_dqt(int len) {
    const uint8_t* stop = p + len;
    while (p < stop) {
      int pq_tq = u8();
      int pq = pq_tq >> 4, tq = pq_tq & 15;
      if (pq > 1 || tq > 3) fail("corrupt JPEG: bad quantisation table");
      for (int i = 0; i < 64; ++i)
        quant[tq][kNatural[i]] = pq ? u16() : u8();
      quant_defined[tq] = true;
    }
    if (p != stop) fail("corrupt JPEG: bad DQT length");
  }

  void parse_dht(int len) {
    const uint8_t* stop = p + len;
    while (p < stop) {
      int tc_th = u8();
      int tc = tc_th >> 4, th = tc_th & 15;
      if (tc > 1 || th > 3) fail("corrupt JPEG: bad Huffman table class");
      uint8_t counts[16], values[256];
      int total = 0;
      for (int i = 0; i < 16; ++i) total += counts[i] = (uint8_t)u8();
      if (total > 256) fail("corrupt JPEG: bad Huffman table");
      for (int i = 0; i < total; ++i) values[i] = (uint8_t)u8();
      build_huffman(tc ? ac[th] : dc[th], counts, values, total);
    }
    if (p != stop) fail("corrupt JPEG: bad DHT length");
  }

  void parse_sof(int marker, int len) {
    if (have_frame) fail("corrupt JPEG: a second frame header");
    if (marker == 0xC2 || marker == 0xC6 || marker == 0xCA ||
        marker == 0xCE)
      fail("progressive JPEG is not read (only baseline and extended "
           "sequential)");
    if (marker == 0xC3 || marker == 0xC7 || marker == 0xCB ||
        marker == 0xCF)
      fail("lossless JPEG is not read (only baseline and extended "
           "sequential)");
    if (marker == 0xC5) fail("hierarchical JPEG is not read");
    if (marker >= 0xC9)
      fail("arithmetic-coded JPEG is not read (only Huffman coding)");
    int precision = u8();
    height = u16();
    width = u16();
    ncomp = u8();
    if (precision != 8)
      fail("%d-bit JPEG is not read (only 8-bit samples)", precision);
    if (height == 0 || width == 0)
      fail("JPEG of size %dx%d (a DNL marker) is not read", width, height);
    if (ncomp == 4) fail("CMYK or YCCK JPEG (4 components) is not read");
    if (ncomp != 1 && ncomp != 3)
      fail("JPEG of %d components is not read (only 1 or 3)", ncomp);
    if (len != 6 + 3 * ncomp) fail("corrupt JPEG: bad SOF length");
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[i];
      c.id = u8();
      int hv = u8();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = u8();
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
        fail("corrupt JPEG: bad component parameters");
      hmax = c.h > hmax ? c.h : hmax;
      vmax = c.v > vmax ? c.v : vmax;
    }
    if (ncomp == 3) {
      bool ok = comp[1].h == 1 && comp[1].v == 1 && comp[2].h == 1 &&
                comp[2].v == 1 &&
                ((comp[0].h == 1 && comp[0].v == 1) ||
                 (comp[0].h == 2 && comp[0].v == 1) ||
                 (comp[0].h == 2 && comp[0].v == 2));
      if (!ok)
        fail("JPEG sampling %dx%d,%dx%d,%dx%d is not read (only luma "
             "1x1, 2x1 or 2x2 over 1x1 chroma)",
             comp[0].h, comp[0].v, comp[1].h, comp[1].v, comp[2].h,
             comp[2].v);
    }
    int mcux = (width + 8 * hmax - 1) / (8 * hmax);
    int mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[i];
      c.dw = (width * c.h + hmax - 1) / hmax;
      c.dh = (height * c.v + vmax - 1) / vmax;
      c.bw = mcux * c.h;
      c.bh = mcuy * c.v;
      if (decode_pixels) c.plane.assign((size_t)c.bw * 8 * c.bh * 8, 0);
    }
    have_frame = true;
  }

  void idct_block(const int16_t* coef, const int* q, uint8_t* out,
                  int stride);

  void decode_scan(int len) {
    if (!have_frame) fail("corrupt JPEG: a scan before the frame header");
    const uint8_t* stop = p + len;
    int ns = u8();
    if (ns < 1 || ns > ncomp || len != 4 + 2 * ns)
      fail("corrupt JPEG: bad SOS length");
    Component* sc[3];
    for (int i = 0; i < ns; ++i) {
      int id = u8(), tables = u8();
      sc[i] = nullptr;
      for (int j = 0; j < ncomp; ++j)
        if (comp[j].id == id) sc[i] = &comp[j];
      if (!sc[i]) fail("corrupt JPEG: a scan names component %d", id);
      sc[i]->dc_table = tables >> 4;
      sc[i]->ac_table = tables & 15;
      if (sc[i]->dc_table > 3 || sc[i]->ac_table > 3)
        fail("corrupt JPEG: bad Huffman table selector");
    }
    int ss = u8(), se = u8(), ahal = u8();
    if (ss != 0 || se != 63 || ahal != 0)
      fail("corrupt JPEG: a sequential scan with spectral selection "
           "%d-%d", ss, se);
    if (p != stop) fail("corrupt JPEG: bad SOS length");
    for (int i = 0; i < ns; ++i) {
      if (!dc[sc[i]->dc_table].defined || !ac[sc[i]->ac_table].defined)
        fail("corrupt JPEG: a scan uses an undefined Huffman table");
      if (!quant_defined[sc[i]->tq])
        fail("corrupt JPEG: a component uses an undefined quantisation "
             "table");
      sc[i]->pred = 0;
    }
    Bits br{p, end};
    int mcus_x, mcus_y;
    if (ns == 1) {
      mcus_x = (sc[0]->dw + 7) / 8;
      mcus_y = (sc[0]->dh + 7) / 8;
    } else {
      mcus_x = (width + 8 * hmax - 1) / (8 * hmax);
      mcus_y = (height + 8 * vmax - 1) / (8 * vmax);
    }
    int16_t coef[64];
    long total = (long)mcus_x * mcus_y;
    int next_rst = 0;
    for (long m = 0; m < total; ++m) {
      if (restart_interval && m > 0 && m % restart_interval == 0) {
        br.fill();
        if (!br.stopped || br.p + 1 >= end || br.p[0] != 0xFF ||
            br.p[1] != 0xD0 + next_rst)
          fail("corrupt JPEG: restart marker %d missing", next_rst);
        br.p += 2;
        br.reset();
        next_rst = (next_rst + 1) & 7;
        for (int i = 0; i < ns; ++i) sc[i]->pred = 0;
      }
      int mx = (int)(m % mcus_x), my = (int)(m / mcus_x);
      for (int i = 0; i < ns; ++i) {
        Component& c = *sc[i];
        int bh = ns == 1 ? 1 : c.v, bwn = ns == 1 ? 1 : c.h;
        for (int by = 0; by < bh; ++by) {
          for (int bx = 0; bx < bwn; ++bx) {
            decode_block(br, c, coef);
            int x = (ns == 1 ? mx : mx * c.h + bx) * 8;
            int y = (ns == 1 ? my : my * c.v + by) * 8;
            int stride = c.bw * 8;
            idct_block(coef, quant[c.tq], &c.plane[(size_t)y * stride + x],
                       stride);
          }
        }
      }
    }
    br.fill();
    p = br.p;
  }

  void decode_block(Bits& br, Component& c, int16_t* coef) {
    memset(coef, 0, 64 * sizeof(int16_t));
    int s = br.decode(dc[c.dc_table]);
    if (s > 15) fail("corrupt JPEG: bad DC difference");
    if (s) c.pred += extend(br.get(s), s);
    coef[0] = (int16_t)c.pred;
    const Huffman& t = ac[c.ac_table];
    for (int k = 1; k < 64; ++k) {
      int rs = br.decode(t);
      int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        if (k > 63) fail("corrupt JPEG: coefficient index past 63");
        coef[kNatural[k]] = (int16_t)extend(br.get(s), s);
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
  }

  void run() {
    p = data;
    if (end - data < 2 || data[0] != 0xFF || data[1] != 0xD8)
      fail("not a JPEG file");
    p += 2;
    bool scanned = false;
    for (;;) {
      if (p >= end) fail("truncated JPEG: no end-of-image marker");
      if (*p != 0xFF) fail("corrupt JPEG: expected a marker");
      while (p < end && *p == 0xFF) ++p;
      int marker = u8();
      if (marker == 0xD9) {
        if (!scanned) fail("corrupt JPEG: no scan before end of image");
        return;
      }
      if (marker == 0xD8 || (marker >= 0xD0 && marker <= 0xD7) ||
          marker == 0x01)
        continue;   // no segment
      int len = u16() - 2;
      if (len < 0 || len > end - p)
        fail("truncated JPEG: a marker segment runs past the data");
      const uint8_t* next = p + len;
      if (marker >= 0xC0 && marker <= 0xCF && marker != 0xC4 &&
          marker != 0xC8 && marker != 0xCC) {
        parse_sof(marker, len);
        if (!decode_pixels) return;   // the header is all that was asked
      } else if (marker == 0xC4) {
        parse_dht(len);
      } else if (marker == 0xCC) {
        fail("arithmetic-coded JPEG is not read (only Huffman coding)");
      } else if (marker == 0xDB) {
        parse_dqt(len);
      } else if (marker == 0xDD) {
        if (len != 2) fail("corrupt JPEG: bad DRI length");
        restart_interval = u16();
      } else if (marker == 0xDA) {
        decode_scan(len);
        scanned = true;
        continue;
      } else if (marker == 0xDC) {
        fail("JPEG with a DNL marker is not read");
      } else if (marker >= 0xE0 && marker <= 0xEF) {
        parse_app(marker, len);
      }
      p = next;
    }
  }

  void output(uint8_t* out);
};

// ---------------------------------------------------------------------
// jidctint.c: jpeg_idct_islow
// ---------------------------------------------------------------------

constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;
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

inline int64_t descale(int64_t x, int n) {
  return (x + ((int64_t)1 << (n - 1))) >> n;
}

inline uint8_t clamp_centered(int64_t v) {
  v += 128;
  return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v);
}

void Decoder::idct_block(const int16_t* coef, const int* q, uint8_t* out,
                         int stride) {
  int ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* in = coef + c;
    const int* qc = q + c;
    int* w = ws + c;
    if (!in[8] && !in[16] && !in[24] && !in[32] && !in[40] && !in[48] &&
        !in[56]) {
      int dcval = (in[0] * qc[0]) * (1 << kPass1Bits);
      for (int r = 0; r < 8; ++r) w[8 * r] = dcval;
      continue;
    }
    int64_t z2 = in[16] * qc[16], z3 = in[48] * qc[48];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = in[0] * qc[0];
    z3 = in[32] * qc[32];
    int64_t tmp0 = (z2 + z3) * (1 << kConstBits);
    int64_t tmp1 = (z2 - z3) * (1 << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = in[56] * qc[56];
    tmp1 = in[40] * qc[40];
    tmp2 = in[24] * qc[24];
    tmp3 = in[8] * qc[8];
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
    const int n = kConstBits - kPass1Bits;
    w[0] = (int)descale(tmp10 + tmp3, n);
    w[56] = (int)descale(tmp10 - tmp3, n);
    w[8] = (int)descale(tmp11 + tmp2, n);
    w[48] = (int)descale(tmp11 - tmp2, n);
    w[16] = (int)descale(tmp12 + tmp1, n);
    w[40] = (int)descale(tmp12 - tmp1, n);
    w[24] = (int)descale(tmp13 + tmp0, n);
    w[32] = (int)descale(tmp13 - tmp0, n);
  }
  for (int r = 0; r < 8; ++r) {
    const int* w = ws + 8 * r;
    uint8_t* o = out + (size_t)r * stride;
    const int n = kConstBits + kPass1Bits + 3;
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    int64_t tmp0 = ((int64_t)w[0] + w[4]) * (1 << kConstBits);
    int64_t tmp1 = ((int64_t)w[0] - w[4]) * (1 << kConstBits);
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
    o[0] = clamp_centered(descale(tmp10 + tmp3, n));
    o[7] = clamp_centered(descale(tmp10 - tmp3, n));
    o[1] = clamp_centered(descale(tmp11 + tmp2, n));
    o[6] = clamp_centered(descale(tmp11 - tmp2, n));
    o[2] = clamp_centered(descale(tmp12 + tmp1, n));
    o[5] = clamp_centered(descale(tmp12 - tmp1, n));
    o[3] = clamp_centered(descale(tmp13 + tmp0, n));
    o[4] = clamp_centered(descale(tmp13 - tmp0, n));
  }
}

// ---------------------------------------------------------------------
// jdsample.c: chroma upsampling to the full width x height
// ---------------------------------------------------------------------

// one chroma row (dw samples) -> 2*dw samples, h2v1_fancy_upsample
void fancy_h2v1(const uint8_t* in, int dw, uint8_t* out) {
  out[0] = in[0];
  out[1] = (uint8_t)((in[0] * 3 + in[1] + 2) >> 2);
  for (int i = 1; i < dw - 1; ++i) {
    int v = in[i] * 3;
    out[2 * i] = (uint8_t)((v + in[i - 1] + 1) >> 2);
    out[2 * i + 1] = (uint8_t)((v + in[i + 1] + 2) >> 2);
  }
  int v = in[dw - 1];
  out[2 * dw - 2] = (uint8_t)((v * 3 + in[dw - 2] + 1) >> 2);
  out[2 * dw - 1] = (uint8_t)v;
}

// one output row of h2v2_fancy_upsample: `near` the nearest chroma row,
// `far` the one above (even output rows) or below (odd ones)
void fancy_h2v2(const uint8_t* near, const uint8_t* far, int dw,
                uint8_t* out) {
  int this_sum = near[0] * 3 + far[0];
  int next_sum = near[1] * 3 + far[1];
  out[0] = (uint8_t)((this_sum * 4 + 8) >> 4);
  out[1] = (uint8_t)((this_sum * 3 + next_sum + 7) >> 4);
  int last_sum = this_sum;
  this_sum = next_sum;
  for (int i = 2; i < dw; ++i) {
    next_sum = near[i] * 3 + far[i];
    out[2 * i - 2] = (uint8_t)((this_sum * 3 + last_sum + 8) >> 4);
    out[2 * i - 1] = (uint8_t)((this_sum * 3 + next_sum + 7) >> 4);
    last_sum = this_sum;
    this_sum = next_sum;
  }
  out[2 * dw - 2] = (uint8_t)((this_sum * 3 + last_sum + 8) >> 4);
  out[2 * dw - 1] = (uint8_t)((this_sum * 4 + 7) >> 4);
}

// the component's samples at full size, row y (0 <= y < height), into
// `row` (at least width + 1 samples)
void full_row(const Component& c, int hmax, int vmax, int y, uint8_t* row) {
  int stride = c.bw * 8;
  const uint8_t* plane = c.plane.data();
  int rx = hmax / c.h, ry = vmax / c.v;
  if (rx == 1 && ry == 1) {
    memcpy(row, plane + (size_t)y * stride, c.dw);
    return;
  }
  bool fancy = c.dw > 2;
  if (ry == 1) {                          // h2v1
    const uint8_t* in = plane + (size_t)y * stride;
    if (fancy) {
      fancy_h2v1(in, c.dw, row);
    } else {
      for (int i = 0; i < c.dw; ++i) row[2 * i] = row[2 * i + 1] = in[i];
    }
    return;
  }
  int cy = y / 2;                          // h2v2
  const uint8_t* near = plane + (size_t)cy * stride;
  if (!fancy) {
    for (int i = 0; i < c.dw; ++i) row[2 * i] = row[2 * i + 1] = near[i];
    return;
  }
  int fy = (y & 1) ? (cy + 1 < c.dh ? cy + 1 : cy) : (cy > 0 ? cy - 1 : 0);
  fancy_h2v2(near, plane + (size_t)fy * stride, c.dw, row);
}

// jdcolor.c's tables
constexpr int kScaleBits = 16;
constexpr int64_t kOneHalf = (int64_t)1 << (kScaleBits - 1);
inline int64_t fix(double x) {
  return (int64_t)(x * (double)(1L << kScaleBits) + 0.5);
}

struct ColorTables {
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  ColorTables() {
    for (int i = 0, x = -128; i < 256; ++i, ++x) {
      cr_r[i] = (int)((fix(1.40200) * x + kOneHalf) >> kScaleBits);
      cb_b[i] = (int)((fix(1.77200) * x + kOneHalf) >> kScaleBits);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + kOneHalf;
    }
  }
};

const ColorTables& color_tables() {
  static const ColorTables t;
  return t;
}

inline uint8_t clamp255(int v) {
  return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v);
}

void Decoder::output(uint8_t* out) {
  const int w = width;
  if (ncomp == 1) {
    const Component& c = comp[0];
    for (int y = 0; y < height; ++y) {
      const uint8_t* in = c.plane.data() + (size_t)y * c.bw * 8;
      uint8_t* o = out + (size_t)y * w * 3;
      for (int x = 0; x < w; ++x) o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = in[x];
    }
    return;
  }
  bool rgb;
  if (jfif) rgb = false;
  else if (adobe) rgb = adobe_transform == 0;
  else rgb = comp[0].id == 82 && comp[1].id == 71 && comp[2].id == 66;
  std::vector<uint8_t> rows(3 * (size_t)(2 * w + 16));
  uint8_t* r0 = rows.data();
  uint8_t* r1 = r0 + 2 * w + 16;
  uint8_t* r2 = r1 + 2 * w + 16;
  const ColorTables& t = color_tables();
  for (int y = 0; y < height; ++y) {
    full_row(comp[0], hmax, vmax, y, r0);
    full_row(comp[1], hmax, vmax, y, r1);
    full_row(comp[2], hmax, vmax, y, r2);
    uint8_t* o = out + (size_t)y * w * 3;
    if (rgb) {
      for (int x = 0; x < w; ++x) {
        o[3 * x] = r2[x];
        o[3 * x + 1] = r1[x];
        o[3 * x + 2] = r0[x];
      }
      continue;
    }
    for (int x = 0; x < w; ++x) {
      int yy = r0[x], cb = r1[x], cr = r2[x];
      o[3 * x + 2] = clamp255(yy + t.cr_r[cr]);
      o[3 * x + 1] = clamp255(
          yy + (int)((t.cb_g[cb] + t.cr_g[cr]) >> kScaleBits));
      o[3 * x] = clamp255(yy + t.cb_b[cb]);
    }
  }
}

int report(const Failure& f, char* err, int errlen) {
  if (err && errlen > 0) snprintf(err, (size_t)errlen, "%s", f.msg);
  return -1;
}

}  // namespace

extern "C" int aidet_jpeg_info(const uint8_t* data, long n, int* height,
                               int* width, int* orientation, char* err,
                               int errlen) {
  try {
    Decoder d{data, data + n, data, false};
    d.run();
    if (!d.have_frame) fail("corrupt JPEG: no frame header");
    *height = d.height;
    *width = d.width;
    *orientation = d.orientation;
    return 0;
  } catch (const Failure& f) {
    return report(f, err, errlen);
  }
}

extern "C" int aidet_jpeg_decode(const uint8_t* data, long n, uint8_t* out,
                                 int height, int width, char* err,
                                 int errlen) {
  try {
    Decoder d{data, data + n, data, true};
    d.run();
    if (d.height != height || d.width != width)
      fail("JPEG of %dx%d, not the %dx%d asked for", d.width, d.height,
           width, height);
    d.output(out);
    return 0;
  } catch (const Failure& f) {
    return report(f, err, errlen);
  } catch (const std::bad_alloc&) {
    if (err && errlen > 0) snprintf(err, (size_t)errlen, "out of memory");
    return -1;
  }
}
