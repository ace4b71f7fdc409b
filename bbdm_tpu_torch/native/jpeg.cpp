// jpeg: a JPEG decoder that computes what libjpeg-turbo computes with its
// default settings (and so what Pillow's Image.open(...).convert("RGB") and
// cv2.imread read), for ordinary files: baseline and extended-sequential or
// progressive Huffman coding, 8-bit samples, 1 or 3 components, any sampling
// factors, restart intervals, any width and height.
//
// It follows libjpeg-turbo's defaults step by step:
//   * the accurate integer inverse DCT, jpeg_idct_islow (jidctint.c), with its
//     range-limit table (jdmaster.c:prepare_range_limit_table);
//   * "fancy" chroma upsampling (jdsample.c): h2v1 and h2v2 triangle filters
//     where the component is wider than 2 samples, h1v2 always, box
//     replication otherwise; the rows above the first and below the last are
//     copies of them (jdmainct.c);
//   * the fixed-point YCbCr -> RGB tables of jdcolor.c:build_ycc_rgb_table.
// The colour space is chosen as jdapimin.c:default_decompress_parms chooses it
// (JFIF, then the Adobe marker's transform, then the component ids).
// Arithmetic coding, 12-bit samples, lossless and hierarchical files and 4
// components (CMYK, YCCK) are refused with a message naming the feature.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <new>
#include <cstring>
#include <string>
#include <vector>

namespace {

const int kZigzag[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,  12, 19, 26, 33,
    40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36,
    29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54,
    47, 55, 62, 63,
    // extra entries so that a corrupt run past 63 lands harmlessly, as in jutils.c
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct Error {
  std::string msg;
};

// the frame kinds that are refused, by marker
const char* unsupported(int m) {
  switch (m) {
    case 0xC3: case 0xC7: case 0xCB: case 0xCF:
      return "lossless JPEG is not supported";
    case 0xC5: case 0xC6: case 0xCD: case 0xCE:
      return "hierarchical JPEG is not supported";
    case 0xC9: case 0xCA: case 0xCC:
      return "arithmetic coding is not supported";
    default:
      return nullptr;
  }
}

struct Huffman {
  bool defined = false;
  int count = 0;  // symbols
  // canonical codes: for each length l in 1..16, the first code, the index of
  // its first symbol and the largest code of that length (-1 if none)
  int32_t mincode[17], maxcode[18], valptr[17];
  uint8_t values[256];
  // 9-bit lookahead: (length << 8) | symbol, or 0 when the code is longer
  uint16_t fast[512];
};

// false if the code lengths oversubscribe the code space (a corrupt table)
bool build_huffman(Huffman& h, const uint8_t counts[16], const uint8_t* vals, int nvals) {
  std::memcpy(h.values, vals, nvals);
  std::memset(h.fast, 0, sizeof(h.fast));
  h.count = nvals;
  int code = 0, k = 0;
  for (int l = 1; l <= 16; ++l) {
    h.valptr[l] = k;
    h.mincode[l] = code;
    if (code + counts[l - 1] > (1 << l)) return false;
    for (int i = 0; i < counts[l - 1]; ++i, ++k, ++code) {
      if (l <= 9) {
        const int shift = 9 - l;
        for (int j = 0; j < (1 << shift); ++j)
          h.fast[(code << shift) | j] = static_cast<uint16_t>((l << 8) | h.values[k]);
      }
    }
    h.maxcode[l] = counts[l - 1] ? code - 1 : -1;
    code <<= 1;
  }
  h.maxcode[17] = 0x7fffffff;
  h.defined = true;
  return true;
}

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;      // Huffman tables of the current scan
  int bw = 0, bh = 0;      // blocks per row and column, padded to whole MCUs
  int cw = 0, ch = 0;      // downsampled width and height in samples
  int dc_pred = 0;
  bool latched = false;    // the quantisation table is taken at the first scan
  uint16_t quant[64];
  std::vector<int16_t> coef;  // [bh, bw, 64] in natural order
};

struct Decoder {
  const uint8_t* data;
  size_t size, pos = 0;
  uint16_t qt[4][64];
  bool qt_defined[4] = {false, false, false, false};
  Huffman dc[4], ac[4];
  int width = 0, height = 0, ncomp = 0, hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  bool progressive = false, frame = false;
  bool jfif = false, adobe = false;
  int adobe_transform = -1, restart_interval = 0;
  Component comp[3];
  // the entropy-coded segment's bit reader
  uint32_t bits = 0;
  int nbits = 0;
  bool hit_marker = false;
  int eobrun = 0;

  [[noreturn]] void fail(const std::string& m) { throw Error{m}; }

  uint8_t byte() {
    if (pos >= size) fail("unexpected end of file");
    return data[pos++];
  }
  int u16() {
    const int hi = byte();
    return (hi << 8) | byte();
  }

  // ---------------------------------------------------------------- bits
  void reset_bits() {
    bits = 0;
    nbits = 0;
    hit_marker = false;
  }
  void fill() {
    while (nbits <= 24) {
      int b = 0;
      if (!hit_marker && pos < size) {
        b = data[pos];
        if (b == 0xFF) {
          size_t p = pos + 1;
          while (p < size && data[p] == 0xFF) ++p;  // fill bytes
          if (p < size && data[p] == 0x00) {
            pos = p + 1;
          } else {  // a marker: stop here and feed zeros, as libjpeg does
            hit_marker = true;
            b = 0;
          }
        } else {
          ++pos;
        }
      }
      bits |= static_cast<uint32_t>(b) << (24 - nbits);
      nbits += 8;
    }
  }
  int get_bits(int n) {
    if (n == 0) return 0;
    if (nbits < n) fill();
    const int v = static_cast<int>(bits >> (32 - n));
    bits <<= n;
    nbits -= n;
    return v;
  }
  int get_bit() { return get_bits(1); }
  static int extend(int v, int t) { return v < (1 << (t - 1)) ? v - (1 << t) + 1 : v; }
  int receive_extend(int s) { return s ? extend(get_bits(s), s) : 0; }

  int decode(const Huffman& h) {
    if (nbits < 16) fill();
    const uint16_t f = h.fast[bits >> 23];
    if (f) {
      const int l = f >> 8;
      bits <<= l;
      nbits -= l;
      return f & 0xFF;
    }
    int l = 10;
    int32_t code = static_cast<int32_t>(bits >> (32 - l));
    while (l <= 16 && code > h.maxcode[l]) {
      ++l;
      code = static_cast<int32_t>(bits >> (32 - l));
    }
    if (l > 16) fail("corrupt Huffman code");
    const int idx = h.valptr[l] + code - h.mincode[l];
    if (idx < 0 || idx >= h.count) fail("corrupt Huffman code");
    bits <<= l;
    nbits -= l;
    return h.values[idx];
  }

  // ---------------------------------------------------------------- markers
  void read_dqt() {
    int len = u16() - 2;
    while (len > 0) {
      const int b = byte(), wide = b >> 4, t = b & 15;
      if (t > 3) fail("quantisation table id > 3");
      for (int i = 0; i < 64; ++i) qt[t][kZigzag[i]] = static_cast<uint16_t>(wide ? u16() : byte());
      qt_defined[t] = true;
      len -= 1 + 64 * (wide ? 2 : 1);
    }
  }
  void read_dht() {
    int len = u16() - 2;
    while (len > 0) {
      const int tc = byte();
      uint8_t counts[16], vals[256];
      int n = 0;
      for (int i = 0; i < 16; ++i) n += counts[i] = byte();
      if (n > 256) fail("Huffman table with more than 256 codes");
      for (int i = 0; i < n; ++i) vals[i] = byte();
      const int cls = tc >> 4, id = tc & 15;
      if (id > 3 || cls > 1) fail("Huffman table id out of range");
      if (!build_huffman(cls ? ac[id] : dc[id], counts, vals, n))
        fail("corrupt Huffman table");
      len -= 17 + n;
    }
  }
  void read_sof(int marker) {
    if (frame) fail("more than one frame");
    const int len = u16();
    const int precision = byte();
    height = u16();
    width = u16();
    ncomp = byte();
    if (precision != 8) fail(std::to_string(precision) + "-bit samples are not supported");
    if (ncomp == 4) fail("4 components (CMYK or YCCK) are not supported");
    if (ncomp != 1 && ncomp != 3) fail(std::to_string(ncomp) + " components are not supported");
    if (len != 8 + 3 * ncomp) fail("bad SOF length");
    if (width <= 0) fail("zero width");
    if (height <= 0) fail("a height of 0 (set by a DNL marker) is not supported");
    progressive = marker == 0xC2;
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[i];
      c.id = byte();
      const int hv = byte();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = byte();
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3) fail("bad component parameters");
      hmax = std::max(hmax, c.h);
      vmax = std::max(vmax, c.v);
    }
    mcux = (width + 8 * hmax - 1) / (8 * hmax);
    mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[i];
      if (hmax % c.h || vmax % c.v) fail("sampling factors that do not divide the largest");
      c.bw = mcux * c.h;
      c.bh = mcuy * c.v;
      c.cw = static_cast<int>((static_cast<int64_t>(width) * c.h + hmax - 1) / hmax);
      c.ch = static_cast<int>((static_cast<int64_t>(height) * c.v + vmax - 1) / vmax);
      c.coef.assign(static_cast<size_t>(c.bw) * c.bh * 64, 0);
    }
    frame = true;
  }
  void skip_segment() {
    const int len = u16();
    if (len < 2 || pos + len - 2 > size) fail("bad segment length");
    pos += len - 2;
  }
  void read_app(int marker) {
    const int len = u16();
    if (len < 2 || pos + len - 2 > size) fail("bad segment length");
    const uint8_t* p = data + pos;
    if (marker == 0xE0 && len >= 7 && !std::memcmp(p, "JFIF\0", 5)) jfif = true;
    if (marker == 0xEE && len >= 14 && !std::memcmp(p, "Adobe", 5)) {
      adobe = true;
      adobe_transform = p[11];
    }
    pos += len - 2;
  }

  // ---------------------------------------------------------------- scans
  void decode_block_baseline(Component& c, int16_t* blk) {
    const int t = decode(dc[c.td]);
    if (t > 16) fail("corrupt DC difference");
    c.dc_pred += receive_extend(t);
    blk[0] = static_cast<int16_t>(c.dc_pred);
    for (int k = 1; k < 64; ++k) {
      const int rs = decode(ac[c.ta]);
      const int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        blk[kZigzag[k]] = static_cast<int16_t>(receive_extend(s));
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
  }
  void decode_block_dc_first(Component& c, int16_t* blk, int al) {
    const int t = decode(dc[c.td]);
    if (t > 16) fail("corrupt DC difference");
    c.dc_pred += receive_extend(t);
    blk[0] = static_cast<int16_t>(static_cast<int>(static_cast<unsigned>(c.dc_pred) << al));
  }
  void decode_block_dc_refine(int16_t* blk, int al) {
    if (get_bit()) blk[0] = static_cast<int16_t>(blk[0] | (1 << al));
  }
  void decode_block_ac_first(Component& c, int16_t* blk, int ss, int se, int al) {
    if (eobrun > 0) {
      --eobrun;
      return;
    }
    for (int k = ss; k <= se; ++k) {
      const int rs = decode(ac[c.ta]);
      const int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        blk[kZigzag[k]] = static_cast<int16_t>(static_cast<int>(static_cast<unsigned>(receive_extend(s)) << al));
      } else if (r == 15) {
        k += 15;
      } else {
        eobrun = 1 << r;
        if (r) eobrun += get_bits(r);
        --eobrun;
        break;
      }
    }
  }
  void decode_block_ac_refine(Component& c, int16_t* blk, int ss, int se, int al) {
    const int p1 = 1 << al, m1 = -1 * (1 << al);
    int k = ss;
    if (eobrun == 0) {
      for (; k <= se; ++k) {
        const int rs = decode(ac[c.ta]);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          s = get_bit() ? p1 : m1;  // the new coefficient's size is always 1
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) eobrun += get_bits(r);
          break;
        }
        do {
          int16_t* coef = blk + kZigzag[k];
          if (*coef != 0) {
            if (get_bit() && (*coef & p1) == 0)
              *coef = static_cast<int16_t>(*coef >= 0 ? *coef + p1 : *coef + m1);
          } else {
            if (--r < 0) break;
          }
          ++k;
        } while (k <= se);
        if (s) blk[kZigzag[k]] = static_cast<int16_t>(s);
      }
    }
    if (eobrun > 0) {
      for (; k <= se; ++k) {
        int16_t* coef = blk + kZigzag[k];
        if (*coef != 0 && get_bit() && (*coef & p1) == 0)
          *coef = static_cast<int16_t>(*coef >= 0 ? *coef + p1 : *coef + m1);
      }
      --eobrun;
    }
  }

  // after a restart interval: the RSTn marker, then fresh predictors
  void restart() {
    reset_bits();
    while (pos + 1 < size && !(data[pos] == 0xFF && data[pos + 1] != 0x00 && data[pos + 1] != 0xFF))
      ++pos;
    if (pos + 1 < size && data[pos + 1] >= 0xD0 && data[pos + 1] <= 0xD7) pos += 2;
    for (int i = 0; i < ncomp; ++i) comp[i].dc_pred = 0;
    eobrun = 0;
  }

  void read_sos() {
    if (!frame) fail("scan before frame header");
    const int len = u16();
    const int ns = byte();
    if (ns < 1 || ns > ncomp || len != 6 + 2 * ns) fail("bad SOS header");
    Component* sc[4];
    for (int i = 0; i < ns; ++i) {
      const int id = byte(), t = byte();
      Component* c = nullptr;
      for (int j = 0; j < ncomp; ++j)
        if (comp[j].id == id) c = &comp[j];
      if (!c) fail("scan names an unknown component");
      c->td = t >> 4;
      c->ta = t & 15;
      if (c->td > 3 || c->ta > 3) fail("Huffman table id out of range");
      sc[i] = c;
    }
    const int ss = byte(), se = byte(), a = byte();
    const int ah = a >> 4, al = a & 15;
    if (!progressive && (ss != 0 || se != 63 || a != 0)) fail("bad sequential scan parameters");
    if (progressive) {
      if (ss > se || se > 63 || al > 13 || (ss == 0 && se != 0) || (ss > 0 && ns != 1))
        fail("bad progressive scan parameters");
    }
    for (int i = 0; i < ns; ++i) {
      Component& c = *sc[i];
      if (!c.latched) {
        if (!qt_defined[c.tq]) fail("component uses an undefined quantisation table");
        std::memcpy(c.quant, qt[c.tq], sizeof(c.quant));
        c.latched = true;
      }
      const bool need_dc = !progressive || (ss == 0 && ah == 0);
      const bool need_ac = !progressive ? true : ss > 0;
      if (need_dc && !dc[c.td].defined) fail("scan uses an undefined DC Huffman table");
      if (need_ac && !ac[c.ta].defined) fail("scan uses an undefined AC Huffman table");
      c.dc_pred = 0;
    }
    reset_bits();
    eobrun = 0;

    auto block = [&](Component& c, int by, int bx) {
      int16_t* blk = c.coef.data() + (static_cast<size_t>(by) * c.bw + bx) * 64;
      if (!progressive)
        decode_block_baseline(c, blk);
      else if (ss == 0 && ah == 0)
        decode_block_dc_first(c, blk, al);
      else if (ss == 0)
        decode_block_dc_refine(blk, al);
      else if (ah == 0)
        decode_block_ac_first(c, blk, ss, se, al);
      else
        decode_block_ac_refine(c, blk, ss, se, al);
    };

    int todo = restart_interval;
    auto next_unit = [&](bool last) {
      if (restart_interval && --todo == 0 && !last) {
        restart();
        todo = restart_interval;
      }
    };
    if (ns == 1) {  // non-interleaved: the component's own block grid
      Component& c = *sc[0];
      const int nbx = (c.cw + 7) / 8, nby = (c.ch + 7) / 8;
      for (int by = 0; by < nby; ++by)
        for (int bx = 0; bx < nbx; ++bx) {
          block(c, by, bx);
          next_unit(by == nby - 1 && bx == nbx - 1);
        }
    } else {
      for (int my = 0; my < mcuy; ++my)
        for (int mx = 0; mx < mcux; ++mx) {
          for (int i = 0; i < ns; ++i) {
            Component& c = *sc[i];
            for (int y = 0; y < c.v; ++y)
              for (int x = 0; x < c.h; ++x) block(c, my * c.v + y, mx * c.h + x);
          }
          next_unit(my == mcuy - 1 && mx == mcux - 1);
        }
    }
  }

  void parse() {
    if (size < 2 || data[0] != 0xFF || data[1] != 0xD8) fail("not a JPEG file");
    pos = 2;
    bool scanned = false;
    while (true) {
      // find the next marker (skipping fill bytes)
      while (pos < size && data[pos] != 0xFF) ++pos;
      while (pos < size && data[pos] == 0xFF) ++pos;
      if (pos >= size) {
        if (scanned) return;  // EOI missing: libjpeg warns and decodes what it has
        fail("no image data");
      }
      const int m = data[pos++];
      if (m == 0x00) continue;  // a stuffed byte left over from a scan
      if (m == 0xD9) {
        if (!scanned) fail("no image data");
        return;
      }
      if (m >= 0xD0 && m <= 0xD7) continue;
      switch (m) {
        case 0xC0: case 0xC1: case 0xC2:
          read_sof(m);
          break;
        case 0xC4:
          read_dht();
          break;
        case 0xDB:
          read_dqt();
          break;
        case 0xDD:
          if (u16() != 4) fail("bad DRI length");
          restart_interval = u16();
          break;
        case 0xDA:
          read_sos();
          scanned = true;
          break;
        case 0xDC:
          fail("DNL markers are not supported");
        default:
          if (const char* what = unsupported(m)) fail(what);
          if (m >= 0xE0 && m <= 0xEF)
            read_app(m);
          else
            skip_segment();
      }
    }
  }

  // ---------------------------------------------------------------- output
  // jpeg_idct_islow (jidctint.c), 8-bit samples
  static void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out, int stride,
                         const uint8_t* range_limit) {
    constexpr int CONST_BITS = 13, PASS1_BITS = 2;
    constexpr int64_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270, F0899 = 7373,
                      F1175 = 9633, F1501 = 12299, F1847 = 15137, F1961 = 16069,
                      F2053 = 16819, F2562 = 20995, F3072 = 25172;
    auto descale = [](int64_t x, int n) { return (x + (int64_t{1} << (n - 1))) >> n; };
    int ws[64];
    for (int c = 0; c < 8; ++c) {
      const int16_t* ip = in + c;
      const uint16_t* qp = q + c;
      int* wp = ws + c;
      if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] && !ip[48] && !ip[56]) {
        const int dc = static_cast<int>(static_cast<unsigned>(ip[0] * qp[0]) << PASS1_BITS);
        for (int r = 0; r < 8; ++r) wp[8 * r] = dc;
        continue;
      }
      int64_t z2 = ip[16] * qp[16], z3 = ip[48] * qp[48];
      int64_t z1 = (z2 + z3) * F0541;
      int64_t tmp2 = z1 + z3 * -F1847;
      int64_t tmp3 = z1 + z2 * F0765;
      z2 = ip[0] * qp[0];
      z3 = ip[32] * qp[32];
      int64_t tmp0 = (z2 + z3) * (int64_t{1} << CONST_BITS);
      int64_t tmp1 = (z2 - z3) * (int64_t{1} << CONST_BITS);
      const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2,
                    tmp12 = tmp1 - tmp2;
      tmp0 = ip[56] * qp[56];
      tmp1 = ip[40] * qp[40];
      tmp2 = ip[24] * qp[24];
      tmp3 = ip[8] * qp[8];
      z1 = tmp0 + tmp3;
      z2 = tmp1 + tmp2;
      z3 = tmp0 + tmp2;
      int64_t z4 = tmp1 + tmp3;
      const int64_t z5 = (z3 + z4) * F1175;
      tmp0 *= F0298;
      tmp1 *= F2053;
      tmp2 *= F3072;
      tmp3 *= F1501;
      z1 *= -F0899;
      z2 *= -F2562;
      z3 *= -F1961;
      z4 *= -F0390;
      z3 += z5;
      z4 += z5;
      tmp0 += z1 + z3;
      tmp1 += z2 + z4;
      tmp2 += z2 + z3;
      tmp3 += z1 + z4;
      constexpr int S = CONST_BITS - PASS1_BITS;
      wp[0] = static_cast<int>(descale(tmp10 + tmp3, S));
      wp[56] = static_cast<int>(descale(tmp10 - tmp3, S));
      wp[8] = static_cast<int>(descale(tmp11 + tmp2, S));
      wp[48] = static_cast<int>(descale(tmp11 - tmp2, S));
      wp[16] = static_cast<int>(descale(tmp12 + tmp1, S));
      wp[40] = static_cast<int>(descale(tmp12 - tmp1, S));
      wp[24] = static_cast<int>(descale(tmp13 + tmp0, S));
      wp[32] = static_cast<int>(descale(tmp13 - tmp0, S));
    }
    constexpr int S2 = CONST_BITS + PASS1_BITS + 3;
    for (int r = 0; r < 8; ++r) {
      const int* wp = ws + 8 * r;
      uint8_t* op = out + static_cast<size_t>(r) * stride;
      if (!wp[1] && !wp[2] && !wp[3] && !wp[4] && !wp[5] && !wp[6] && !wp[7]) {
        const uint8_t dc = range_limit[static_cast<int>(descale(wp[0], PASS1_BITS + 3)) & 1023];
        for (int i = 0; i < 8; ++i) op[i] = dc;
        continue;
      }
      int64_t z2 = wp[2], z3 = wp[6];
      int64_t z1 = (z2 + z3) * F0541;
      int64_t tmp2 = z1 + z3 * -F1847;
      int64_t tmp3 = z1 + z2 * F0765;
      int64_t tmp0 = (static_cast<int64_t>(wp[0]) + wp[4]) * (int64_t{1} << CONST_BITS);
      int64_t tmp1 = (static_cast<int64_t>(wp[0]) - wp[4]) * (int64_t{1} << CONST_BITS);
      const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2,
                    tmp12 = tmp1 - tmp2;
      tmp0 = wp[7];
      tmp1 = wp[5];
      tmp2 = wp[3];
      tmp3 = wp[1];
      z1 = tmp0 + tmp3;
      z2 = tmp1 + tmp2;
      z3 = tmp0 + tmp2;
      int64_t z4 = tmp1 + tmp3;
      const int64_t z5 = (z3 + z4) * F1175;
      tmp0 *= F0298;
      tmp1 *= F2053;
      tmp2 *= F3072;
      tmp3 *= F1501;
      z1 *= -F0899;
      z2 *= -F2562;
      z3 *= -F1961;
      z4 *= -F0390;
      z3 += z5;
      z4 += z5;
      tmp0 += z1 + z3;
      tmp1 += z2 + z4;
      tmp2 += z2 + z3;
      tmp3 += z1 + z4;
      auto put = [&](int i, int64_t v) { op[i] = range_limit[static_cast<int>(descale(v, S2)) & 1023]; };
      put(0, tmp10 + tmp3);
      put(7, tmp10 - tmp3);
      put(1, tmp11 + tmp2);
      put(6, tmp11 - tmp2);
      put(2, tmp12 + tmp1);
      put(5, tmp12 - tmp1);
      put(3, tmp13 + tmp0);
      put(4, tmp13 - tmp0);
    }
  }

  // the component's samples [bh * 8, bw * 8]
  std::vector<uint8_t> samples(const Component& c, const uint8_t* range_limit) const {
    const int stride = c.bw * 8;
    std::vector<uint8_t> out(static_cast<size_t>(stride) * c.bh * 8);
    for (int by = 0; by < c.bh; ++by)
      for (int bx = 0; bx < c.bw; ++bx)
        idct_islow(c.coef.data() + (static_cast<size_t>(by) * c.bw + bx) * 64, c.quant,
                   out.data() + static_cast<size_t>(by) * 8 * stride + bx * 8, stride,
                   range_limit);
    return out;
  }

  // a component upsampled to [height, width] as jdsample.c does it by default
  std::vector<uint8_t> upsample(const Component& c, const std::vector<uint8_t>& s) const {
    const int stride = c.bw * 8, fx = hmax / c.h, fy = vmax / c.v;
    const int W = width, H = height;
    std::vector<uint8_t> out(static_cast<size_t>(W) * H);
    auto at = [&](int y, int x) -> int { return s[static_cast<size_t>(y) * stride + x]; };
    if (fx == 1 && fy == 1) {
      for (int y = 0; y < H; ++y) std::memcpy(&out[static_cast<size_t>(y) * W], &s[static_cast<size_t>(y) * stride], W);
      return out;
    }
    const int cw = c.cw, last = c.ch - 1;
    std::vector<uint8_t> row(static_cast<size_t>(2 * cw));
    for (int y = 0; y < H; ++y) {
      uint8_t* o = &out[static_cast<size_t>(y) * W];
      if (fx == 2 && fy == 1 && cw > 2) {  // h2v1_fancy_upsample
        const uint8_t* in = &s[static_cast<size_t>(y) * stride];
        uint8_t* r = row.data();
        int v = in[0];
        *r++ = static_cast<uint8_t>(v);
        *r++ = static_cast<uint8_t>((v * 3 + in[1] + 2) >> 2);
        for (int i = 1; i < cw - 1; ++i) {
          v = in[i] * 3;
          *r++ = static_cast<uint8_t>((v + in[i - 1] + 1) >> 2);
          *r++ = static_cast<uint8_t>((v + in[i + 1] + 2) >> 2);
        }
        v = in[cw - 1];
        *r++ = static_cast<uint8_t>((v * 3 + in[cw - 2] + 1) >> 2);
        *r++ = static_cast<uint8_t>(v);
        std::memcpy(o, row.data(), W);
      } else if (fx == 1 && fy == 2) {  // h1v2_fancy_upsample
        const int in_row = y >> 1, other = (y & 1) ? std::min(in_row + 1, last) : std::max(in_row - 1, 0);
        const int bias = (y & 1) ? 2 : 1;
        for (int x = 0; x < W; ++x) o[x] = static_cast<uint8_t>((at(in_row, x) * 3 + at(other, x) + bias) >> 2);
      } else if (fx == 2 && fy == 2 && cw > 2) {  // h2v2_fancy_upsample
        const int in_row = y >> 1, other = (y & 1) ? std::min(in_row + 1, last) : std::max(in_row - 1, 0);
        auto colsum = [&](int x) { return at(in_row, x) * 3 + at(other, x); };
        uint8_t* r = row.data();
        int thiscol = colsum(0), nextcol = colsum(1), lastcol;
        *r++ = static_cast<uint8_t>((thiscol * 4 + 8) >> 4);
        *r++ = static_cast<uint8_t>((thiscol * 3 + nextcol + 7) >> 4);
        lastcol = thiscol;
        thiscol = nextcol;
        for (int i = 2; i < cw; ++i) {
          nextcol = colsum(i);
          *r++ = static_cast<uint8_t>((thiscol * 3 + lastcol + 8) >> 4);
          *r++ = static_cast<uint8_t>((thiscol * 3 + nextcol + 7) >> 4);
          lastcol = thiscol;
          thiscol = nextcol;
        }
        *r++ = static_cast<uint8_t>((thiscol * 3 + lastcol + 8) >> 4);
        *r++ = static_cast<uint8_t>((thiscol * 4 + 7) >> 4);
        std::memcpy(o, row.data(), W);
      } else {  // int_upsample / h2v1_upsample / h2v2_upsample: box replication
        const int in_row = y / fy;
        for (int x = 0; x < W; ++x) o[x] = static_cast<uint8_t>(at(in_row, x / fx));
      }
    }
    return out;
  }

  void output(uint8_t* rgb) const {
    // jdmaster.c:prepare_range_limit_table, as the IDCT indexes it
    uint8_t limit[1024];
    for (int i = 0; i < 1024; ++i) {
      const int v = i < 512 ? i + 128 : i - 1024 + 128;
      limit[i] = static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
    }
    const size_t n = static_cast<size_t>(width) * height;
    std::vector<std::vector<uint8_t>> planes;
    for (int i = 0; i < ncomp; ++i) planes.push_back(upsample(comp[i], samples(comp[i], limit)));
    if (ncomp == 1) {
      for (size_t i = 0; i < n; ++i) rgb[3 * i] = rgb[3 * i + 1] = rgb[3 * i + 2] = planes[0][i];
      return;
    }
    bool is_rgb;
    if (jfif)
      is_rgb = false;
    else if (adobe)
      is_rgb = adobe_transform == 0;
    else
      is_rgb = comp[0].id == 82 && comp[1].id == 71 && comp[2].id == 66;  // 'R', 'G', 'B'
    if (is_rgb) {
      for (size_t i = 0; i < n; ++i)
        for (int k = 0; k < 3; ++k) rgb[3 * i + k] = planes[k][i];
      return;
    }
    // jdcolor.c:build_ycc_rgb_table and ycc_rgb_convert
    constexpr int SCALEBITS = 16;
    constexpr int64_t ONE_HALF = int64_t{1} << (SCALEBITS - 1);
    auto fix = [](double x) { return static_cast<int64_t>(x * (1L << SCALEBITS) + 0.5); };
    int cr_r[256], cb_b[256];
    int64_t cr_g[256], cb_g[256];
    for (int i = 0, x = -128; i < 256; ++i, ++x) {
      cr_r[i] = static_cast<int>((fix(1.40200) * x + ONE_HALF) >> SCALEBITS);
      cb_b[i] = static_cast<int>((fix(1.77200) * x + ONE_HALF) >> SCALEBITS);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + ONE_HALF;
    }
    auto clamp = [](int v) { return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v)); };
    for (size_t i = 0; i < n; ++i) {
      const int y = planes[0][i], cb = planes[1][i], cr = planes[2][i];
      rgb[3 * i] = clamp(y + cr_r[cr]);
      rgb[3 * i + 1] = clamp(y + static_cast<int>((cb_g[cb] + cr_g[cr]) >> SCALEBITS));
      rgb[3 * i + 2] = clamp(y + cb_b[cb]);
    }
  }
};

void set_error(char* err, int errlen, const std::string& msg) {
  if (err && errlen > 0) std::snprintf(err, static_cast<size_t>(errlen), "%s", msg.c_str());
}

// the frame header alone: height, width, components
void read_header(Decoder& d) {
  if (d.size < 2 || d.data[0] != 0xFF || d.data[1] != 0xD8) d.fail("not a JPEG file");
  d.pos = 2;
  while (true) {
    while (d.pos < d.size && d.data[d.pos] != 0xFF) ++d.pos;
    while (d.pos < d.size && d.data[d.pos] == 0xFF) ++d.pos;
    if (d.pos >= d.size) d.fail("no frame header");
    const int m = d.data[d.pos++];
    if (m == 0xC0 || m == 0xC1 || m == 0xC2) {
      d.read_sof(m);
      return;
    }
    if (const char* what = unsupported(m)) d.fail(what);
    if (m == 0xD9 || m == 0xDA) d.fail("no frame header");
    if (m == 0x00 || (m >= 0xD0 && m <= 0xD7)) continue;
    d.skip_segment();
  }
}

}  // namespace

extern "C" {

int jpeg_info(const uint8_t* data, int64_t size, int* out, char* err, int errlen) {
  Decoder d;
  d.data = data;
  d.size = static_cast<size_t>(size);
  try {
    read_header(d);
  } catch (const Error& e) {
    set_error(err, errlen, e.msg);
    return 1;
  }
  out[0] = d.height;
  out[1] = d.width;
  out[2] = d.ncomp;
  return 0;
}

// out: uint8 [height, width, 3] as jpeg_info gives them
int jpeg_decode(const uint8_t* data, int64_t size, uint8_t* out, char* err, int errlen) {
  Decoder d;
  d.data = data;
  d.size = static_cast<size_t>(size);
  try {
    d.parse();
    d.output(out);
  } catch (const Error& e) {
    set_error(err, errlen, e.msg);
    return 1;
  } catch (const std::bad_alloc&) {
    set_error(err, errlen, "out of memory");
    return 1;
  }
  return 0;
}

}  // extern "C"
