// webp: a WebP decoder that computes what libwebp computes with its default
// decoding options (and so what Pillow's Image.open(...).convert("RGB") and
// cv2.imread read): the RGB of a still image, or of an animation's first frame
// on its canvas.
//
//   * The RIFF container: a bare "VP8 " or "VP8L" chunk, or "VP8X" and its
//     chunks. ICCP, EXIF, XMP, ALPH and unknown chunks are skipped: libwebp's
//     RGBA is not premultiplied, so alpha never changes RGB. Of an animation
//     the first ANMF frame is decoded into its rectangle (offsets 2x, 2y) and
//     the rest of the canvas is 0.
//   * VP8 key frames (RFC 6386) as libwebp decodes them (src/dec/vp8_dec.c,
//     tree_dec.c, quant_dec.c, frame_dec.c, src/dsp/dec.c): the boolean
//     decoder, segments, 1-8 token partitions, the intra predictors with
//     libwebp's edge samples (127 above the frame, 129 left of it, the
//     above-right samples of a macroblock's lower 4x4 rows taken from its
//     first), the inverse WHT and DCT, the simple and normal loop filters;
//     then the "fancy" chroma upsampler (src/dsp/upsampling.c) and the 14-bit
//     fixed-point YUV -> RGB of src/dsp/yuv.h. Dithering is off, as by default.
//   * VP8L, the lossless bitstream (src/dec/vp8l_dec.c, src/dsp/lossless.c):
//     prefix codes, LZ77 with the 120-entry distance map, the colour cache,
//     the meta prefix codes and the four transforms with libwebp's
//     per-channel predictor arithmetic.
//
// The reader of each bitstream stops at the end of its buffer (reads past it
// give zeros, and the decode then fails). Chunk, partition and image sizes are
// checked against the data, and the canvas against Pillow's decompression-bomb
// limit, before anything is allocated.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <new>
#include <string>
#include <vector>

namespace {

struct Error {
  std::string msg;
};

[[noreturn]] void fail(const std::string& m) { throw Error{m}; }

// Pillow refuses an image of more than 2 * Image.MAX_IMAGE_PIXELS pixels
// (DecompressionBombError); so does this decoder, before it allocates
constexpr int64_t kMaxPixels = 2 * 89478485LL;

inline uint32_t le16(const uint8_t* p) { return p[0] | (p[1] << 8); }
inline uint32_t le24(const uint8_t* p) { return p[0] | (p[1] << 8) | (p[2] << 16); }
inline uint32_t le32(const uint8_t* p) { return le24(p) | (static_cast<uint32_t>(p[3]) << 24); }
inline int clip255(int v) { return v < 0 ? 0 : v > 255 ? 255 : v; }

// ================================================================== VP8

// RFC 6386's tables: the quantizer steps (14.1), the coefficient probabilities
// and their update probabilities (13.4, 13.5), and the key-frame sub-block
// mode probabilities (11.5) indexed [above][left] in the mode order below
const uint8_t kDcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17,
    18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28,
    29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43,
    44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
    59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74,
    75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89,
    91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
    122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157,
};

const uint16_t kAcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
    20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35,
    36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
    52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76,
    78, 80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108,
    110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
    155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209,
    213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284,
};

const uint8_t kCoeffsUpdateProba[4][8][3][11] = {
  {
    {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255}, {249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255}, {234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255}, {250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255}, {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
  },
  {
    {{217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255}, {234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255}},
    {{255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255}, {250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
  },
  {
    {{186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255}, {234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255}, {251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255}},
    {{255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255}},
    {{255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
  },
  {
    {{248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255}, {248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255}, {246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255}, {252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255}},
    {{255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255}, {248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255}, {253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255}, {252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255}, {250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
  },
};

const uint8_t kCoeffsProba0[4][8][3][11] = {
  {
    {{128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}, {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}, {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}},
    {{253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128}, {189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128}, {106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128}},
    {{1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128}, {181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128}, {78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128}},
    {{1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128}, {184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128}, {77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128}},
    {{1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128}, {170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128}, {37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128}},
    {{1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128}, {207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128}, {102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128}},
    {{1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128}, {177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128}, {80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128}},
    {{1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128}, {246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128}, {255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}},
  },
  {
    {{198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62}, {131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1}, {68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128}},
    {{1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128}, {184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128}, {81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128}},
    {{1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128}, {99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128}, {23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128}},
    {{1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128}, {109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128}, {44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128}},
    {{1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128}, {94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128}, {22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128}},
    {{1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128}, {124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128}, {35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128}},
    {{1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128}, {121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128}, {45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128}},
    {{1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128}, {203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128}, {137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128}},
  },
  {
    {{253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128}, {175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128}, {73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128}},
    {{1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128}, {239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128}, {155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128}},
    {{1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128}, {201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128}, {69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128}},
    {{1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128}, {223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128}, {141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128}},
    {{1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128}, {190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128}, {149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128}},
    {{1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128}, {247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128}, {240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128}},
    {{1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128}, {213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128}, {55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128}},
    {{128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}, {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}, {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}},
  },
  {
    {{202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255}, {126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128}, {61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128}},
    {{1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128}, {166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128}, {39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128}},
    {{1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128}, {124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128}, {24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128}},
    {{1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128}, {149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128}, {28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128}},
    {{1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128}, {123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128}, {20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128}},
    {{1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128}, {168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128}, {47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128}},
    {{1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128}, {141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128}, {42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128}},
    {{1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128}, {244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128}, {238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128}},
  },
};

const uint8_t kBModesProba[10][10][9] = {
  {
    {231, 120, 48, 89, 115, 113, 120, 152, 112},
    {152, 179, 64, 126, 170, 118, 46, 70, 95},
    {175, 69, 143, 80, 85, 82, 72, 155, 103},
    {56, 58, 10, 171, 218, 189, 17, 13, 152},
    {114, 26, 17, 163, 44, 195, 21, 10, 173},
    {121, 24, 80, 195, 26, 62, 44, 64, 85},
    {144, 71, 10, 38, 171, 213, 144, 34, 26},
    {170, 46, 55, 19, 136, 160, 33, 206, 71},
    {63, 20, 8, 114, 114, 208, 12, 9, 226},
    {81, 40, 11, 96, 182, 84, 29, 16, 36},
  },
  {
    {134, 183, 89, 137, 98, 101, 106, 165, 148},
    {72, 187, 100, 130, 157, 111, 32, 75, 80},
    {66, 102, 167, 99, 74, 62, 40, 234, 128},
    {41, 53, 9, 178, 241, 141, 26, 8, 107},
    {74, 43, 26, 146, 73, 166, 49, 23, 157},
    {65, 38, 105, 160, 51, 52, 31, 115, 128},
    {104, 79, 12, 27, 217, 255, 87, 17, 7},
    {87, 68, 71, 44, 114, 51, 15, 186, 23},
    {47, 41, 14, 110, 182, 183, 21, 17, 194},
    {66, 45, 25, 102, 197, 189, 23, 18, 22},
  },
  {
    {88, 88, 147, 150, 42, 46, 45, 196, 205},
    {43, 97, 183, 117, 85, 38, 35, 179, 61},
    {39, 53, 200, 87, 26, 21, 43, 232, 171},
    {56, 34, 51, 104, 114, 102, 29, 93, 77},
    {39, 28, 85, 171, 58, 165, 90, 98, 64},
    {34, 22, 116, 206, 23, 34, 43, 166, 73},
    {107, 54, 32, 26, 51, 1, 81, 43, 31},
    {68, 25, 106, 22, 64, 171, 36, 225, 114},
    {34, 19, 21, 102, 132, 188, 16, 76, 124},
    {62, 18, 78, 95, 85, 57, 50, 48, 51},
  },
  {
    {193, 101, 35, 159, 215, 111, 89, 46, 111},
    {60, 148, 31, 172, 219, 228, 21, 18, 111},
    {112, 113, 77, 85, 179, 255, 38, 120, 114},
    {40, 42, 1, 196, 245, 209, 10, 25, 109},
    {88, 43, 29, 140, 166, 213, 37, 43, 154},
    {61, 63, 30, 155, 67, 45, 68, 1, 209},
    {100, 80, 8, 43, 154, 1, 51, 26, 71},
    {142, 78, 78, 16, 255, 128, 34, 197, 171},
    {41, 40, 5, 102, 211, 183, 4, 1, 221},
    {51, 50, 17, 168, 209, 192, 23, 25, 82},
  },
  {
    {138, 31, 36, 171, 27, 166, 38, 44, 229},
    {67, 87, 58, 169, 82, 115, 26, 59, 179},
    {63, 59, 90, 180, 59, 166, 93, 73, 154},
    {40, 40, 21, 116, 143, 209, 34, 39, 175},
    {47, 15, 16, 183, 34, 223, 49, 45, 183},
    {46, 17, 33, 183, 6, 98, 15, 32, 183},
    {57, 46, 22, 24, 128, 1, 54, 17, 37},
    {65, 32, 73, 115, 28, 128, 23, 128, 205},
    {40, 3, 9, 115, 51, 192, 18, 6, 223},
    {87, 37, 9, 115, 59, 77, 64, 21, 47},
  },
  {
    {104, 55, 44, 218, 9, 54, 53, 130, 226},
    {64, 90, 70, 205, 40, 41, 23, 26, 57},
    {54, 57, 112, 184, 5, 41, 38, 166, 213},
    {30, 34, 26, 133, 152, 116, 10, 32, 134},
    {39, 19, 53, 221, 26, 114, 32, 73, 255},
    {31, 9, 65, 234, 2, 15, 1, 118, 73},
    {75, 32, 12, 51, 192, 255, 160, 43, 51},
    {88, 31, 35, 67, 102, 85, 55, 186, 85},
    {56, 21, 23, 111, 59, 205, 45, 37, 192},
    {55, 38, 70, 124, 73, 102, 1, 34, 98},
  },
  {
    {125, 98, 42, 88, 104, 85, 117, 175, 82},
    {95, 84, 53, 89, 128, 100, 113, 101, 45},
    {75, 79, 123, 47, 51, 128, 81, 171, 1},
    {57, 17, 5, 71, 102, 57, 53, 41, 49},
    {38, 33, 13, 121, 57, 73, 26, 1, 85},
    {41, 10, 67, 138, 77, 110, 90, 47, 114},
    {115, 21, 2, 10, 102, 255, 166, 23, 6},
    {101, 29, 16, 10, 85, 128, 101, 196, 26},
    {57, 18, 10, 102, 102, 213, 34, 20, 43},
    {117, 20, 15, 36, 163, 128, 68, 1, 26},
  },
  {
    {102, 61, 71, 37, 34, 53, 31, 243, 192},
    {69, 60, 71, 38, 73, 119, 28, 222, 37},
    {68, 45, 128, 34, 1, 47, 11, 245, 171},
    {62, 17, 19, 70, 146, 85, 55, 62, 70},
    {37, 43, 37, 154, 100, 163, 85, 160, 1},
    {63, 9, 92, 136, 28, 64, 32, 201, 85},
    {75, 15, 9, 9, 64, 255, 184, 119, 16},
    {86, 6, 28, 5, 64, 255, 25, 248, 1},
    {56, 8, 17, 132, 137, 255, 55, 116, 128},
    {58, 15, 20, 82, 135, 57, 26, 121, 40},
  },
  {
    {164, 50, 31, 137, 154, 133, 25, 35, 218},
    {51, 103, 44, 131, 131, 123, 31, 6, 158},
    {86, 40, 64, 135, 148, 224, 45, 183, 128},
    {22, 26, 17, 131, 240, 154, 14, 1, 209},
    {45, 16, 21, 91, 64, 222, 7, 1, 197},
    {56, 21, 39, 155, 60, 138, 23, 102, 213},
    {83, 12, 13, 54, 192, 255, 68, 47, 28},
    {85, 26, 85, 85, 128, 128, 32, 146, 171},
    {18, 11, 7, 63, 144, 171, 4, 4, 246},
    {35, 27, 10, 146, 174, 171, 12, 26, 128},
  },
  {
    {190, 80, 35, 99, 180, 80, 126, 54, 45},
    {85, 126, 47, 87, 176, 51, 41, 20, 32},
    {101, 75, 128, 139, 118, 146, 116, 128, 85},
    {56, 41, 15, 176, 236, 85, 37, 9, 62},
    {71, 30, 17, 119, 118, 255, 17, 18, 138},
    {101, 38, 60, 138, 55, 70, 43, 26, 142},
    {146, 36, 19, 30, 171, 255, 97, 27, 20},
    {138, 45, 61, 62, 219, 1, 81, 188, 64},
    {32, 41, 20, 117, 151, 142, 20, 21, 163},
    {112, 19, 12, 61, 195, 128, 48, 4, 24},
  },
};

// the sub-block modes in libwebp's order; the 16x16 and chroma modes are the
// first four
enum { B_DC_PRED = 0, B_TM_PRED, B_VE_PRED, B_HE_PRED, B_RD_PRED, B_VR_PRED, B_LD_PRED,
       B_VL_PRED, B_HD_PRED, B_HU_PRED };
enum { DC_PRED = B_DC_PRED, TM_PRED = B_TM_PRED, V_PRED = B_VE_PRED, H_PRED = B_HE_PRED };
// DC prediction where the top row, the left column or both lie outside the frame
constexpr int DC_NOTOP = 10, DC_NOLEFT = 11, DC_NOTOPLEFT = 12;

// the sub-block mode tree: a leaf is -mode
const int8_t kYModesIntra4[18] = {-B_DC_PRED, 1, -B_TM_PRED, 2, -B_VE_PRED, 3, 4, 6,
                                  -B_HE_PRED, 5, -B_RD_PRED, -B_VR_PRED, -B_LD_PRED, 7,
                                  -B_VL_PRED, 8, -B_HD_PRED, -B_HU_PRED};
const uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
// the band of each coefficient position; the 17th entry is read past the last
const uint8_t kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
const uint8_t kCat3[] = {173, 148, 140, 0};
const uint8_t kCat4[] = {176, 155, 140, 135, 0};
const uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
const uint8_t kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0};
const uint8_t* const kCat3456[] = {kCat3, kCat4, kCat5, kCat6};

// The boolean decoder as libwebp keeps it (bit_reader_utils.h): range_ is the
// range minus 1, and bits_ counts the bits below the 8-bit window of value_.
class BoolDecoder {
 public:
  void init(const uint8_t* p, size_t n) {
    p_ = p;
    end_ = p + n;
    value_ = 0;
    bits_ = -8;
    range_ = 255 - 1;
    eof_ = false;
    load();
  }
  bool eof() const { return eof_; }

  __attribute__((always_inline)) int bit(int prob) {
    uint32_t range = range_;
    if (bits_ < 0) load();
    const int pos = bits_;
    const uint32_t split = (range * static_cast<uint32_t>(prob)) >> 8;
    const uint32_t value = static_cast<uint32_t>(value_ >> pos);
    int b;
    if (value > split) {
      range -= split;
      value_ -= static_cast<uint64_t>(split + 1) << pos;
      b = 1;
    } else {
      range = split + 1;
      b = 0;
    }
    const int shift = 7 ^ (31 - __builtin_clz(range));
    range <<= shift;
    bits_ -= shift;
    range_ = range - 1;
    return b;
  }
  // n bits, the first the most significant
  int value(int n) {
    int v = 0;
    while (n-- > 0) v |= bit(0x80) << n;
    return v;
  }
  int get() { return value(1); }
  int signed_value(int n) {
    const int v = value(n);
    return get() ? -v : v;
  }

 private:
  // more bytes below the window (seven at once while they last); past the end
  // a zero byte once (eof), then nothing
  void load() {
    if (end_ - p_ >= 7) {
      uint64_t bytes = 0;
      for (int i = 0; i < 7; ++i) bytes = (bytes << 8) | p_[i];
      p_ += 7;
      value_ = (value_ << 56) | bytes;
      bits_ += 56;
    } else if (p_ < end_) {
      value_ = (value_ << 8) | *p_++;
      bits_ += 8;
    } else if (!eof_) {
      value_ <<= 8;
      bits_ += 8;
      eof_ = true;
    } else {
      bits_ = 0;
    }
  }

  const uint8_t* p_ = nullptr;
  const uint8_t* end_ = nullptr;
  uint64_t value_ = 0;
  int bits_ = 0;
  uint32_t range_ = 0;
  bool eof_ = false;
};

struct QuantMatrix {
  int y1[2], y2[2], uv[2];  // DC and AC steps
};

struct FilterInfo {
  uint8_t limit = 0, ilevel = 0, inner = 0, hev_thresh = 0;
};

// the work area of one macroblock with its top row and left columns, laid out
// as libwebp's yuv_b_ (frame_dec.c): Y 16x16, then U and V 8x8 side by side
constexpr int BPS = 32;
constexpr int Y_OFF = BPS * 1 + 8;
constexpr int U_OFF = Y_OFF + BPS * 16 + BPS;
constexpr int V_OFF = U_OFF + 16;
constexpr int YUV_SIZE = BPS * 17 + BPS * 9;
const int kScan[16] = {0 + 0 * BPS,  4 + 0 * BPS, 8 + 0 * BPS,  12 + 0 * BPS,
                       0 + 4 * BPS,  4 + 4 * BPS, 8 + 4 * BPS,  12 + 4 * BPS,
                       0 + 8 * BPS,  4 + 8 * BPS, 8 + 8 * BPS,  12 + 8 * BPS,
                       0 + 12 * BPS, 4 + 12 * BPS, 8 + 12 * BPS, 12 + 12 * BPS};

// ------------------------------------------------------------ transforms

inline int mul1(int a) { return static_cast<int>((static_cast<int64_t>(a) * 20091) >> 16) + a; }
inline int mul2(int a) { return static_cast<int>((static_cast<int64_t>(a) * 35468) >> 16); }

// the inverse DCT of one 4x4 block, added to dst (dsp/dec.c:TransformOne_C);
// libwebp's sparse variants (DC only, 3 coefficients) compute the same
void transform_add(const int16_t* in, uint8_t* dst) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {  // vertical pass
    const int a = in[i] + in[8 + i];
    const int b = in[i] - in[8 + i];
    const int c = mul2(in[4 + i]) - mul1(in[12 + i]);
    const int d = mul1(in[4 + i]) + mul2(in[12 + i]);
    tmp[4 * i + 0] = a + d;
    tmp[4 * i + 1] = b + c;
    tmp[4 * i + 2] = b - c;
    tmp[4 * i + 3] = a - d;
  }
  for (int i = 0; i < 4; ++i) {  // horizontal pass, row i
    const int dc = tmp[i] + 4;
    const int a = dc + tmp[8 + i];
    const int b = dc - tmp[8 + i];
    const int c = mul2(tmp[4 + i]) - mul1(tmp[12 + i]);
    const int d = mul1(tmp[4 + i]) + mul2(tmp[12 + i]);
    uint8_t* row = dst + i * BPS;
    row[0] = static_cast<uint8_t>(clip255(row[0] + ((a + d) >> 3)));
    row[1] = static_cast<uint8_t>(clip255(row[1] + ((b + c) >> 3)));
    row[2] = static_cast<uint8_t>(clip255(row[2] + ((b - c) >> 3)));
    row[3] = static_cast<uint8_t>(clip255(row[3] + ((a - d) >> 3)));
  }
}

// the inverse WHT of the Y2 block into the DC of the 16 luma blocks
void transform_wht(const int16_t* in, int16_t* out) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int a0 = in[0 + i] + in[12 + i];
    const int a1 = in[4 + i] + in[8 + i];
    const int a2 = in[4 + i] - in[8 + i];
    const int a3 = in[0 + i] - in[12 + i];
    tmp[0 + i] = a0 + a1;
    tmp[8 + i] = a0 - a1;
    tmp[4 + i] = a3 + a2;
    tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; ++i) {
    const int dc = tmp[0 + i * 4] + 3;
    const int a0 = dc + tmp[3 + i * 4];
    const int a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
    const int a2 = tmp[1 + i * 4] - tmp[2 + i * 4];
    const int a3 = dc - tmp[3 + i * 4];
    out[0] = static_cast<int16_t>((a0 + a1) >> 3);
    out[16] = static_cast<int16_t>((a3 + a2) >> 3);
    out[32] = static_cast<int16_t>((a0 - a1) >> 3);
    out[48] = static_cast<int16_t>((a3 - a2) >> 3);
    out += 64;
  }
}

// ------------------------------------------------------------ predictors

inline uint8_t avg3(int a, int b, int c) { return static_cast<uint8_t>((a + 2 * b + c + 2) >> 2); }
inline uint8_t avg2(int a, int b) { return static_cast<uint8_t>((a + b + 1) >> 1); }

void fill(uint8_t* dst, int size, int v) {
  for (int j = 0; j < size; ++j) std::memset(dst + j * BPS, v, size);
}

void true_motion(uint8_t* dst, int size) {
  const uint8_t* top = dst - BPS;
  const int tl = top[-1];
  for (int y = 0; y < size; ++y) {
    const int left = dst[-1] - tl;
    for (int x = 0; x < size; ++x) dst[x] = static_cast<uint8_t>(clip255(top[x] + left));
    dst += BPS;
  }
}

// 16x16 luma (size 16) or 8x8 chroma (size 8) prediction
void predict_block(uint8_t* dst, int size, int mode) {
  const int log2 = size == 16 ? 4 : 3;
  switch (mode) {
    case DC_PRED: {
      int dc = size;
      for (int j = 0; j < size; ++j) dc += dst[-1 + j * BPS] + dst[j - BPS];
      fill(dst, size, dc >> (log2 + 1));
      break;
    }
    case DC_NOTOP: {
      int dc = size >> 1;
      for (int j = 0; j < size; ++j) dc += dst[-1 + j * BPS];
      fill(dst, size, dc >> log2);
      break;
    }
    case DC_NOLEFT: {
      int dc = size >> 1;
      for (int j = 0; j < size; ++j) dc += dst[j - BPS];
      fill(dst, size, dc >> log2);
      break;
    }
    case DC_NOTOPLEFT:
      fill(dst, size, 0x80);
      break;
    case TM_PRED:
      true_motion(dst, size);
      break;
    case V_PRED:
      for (int j = 0; j < size; ++j) std::memcpy(dst + j * BPS, dst - BPS, size);
      break;
    case H_PRED:
      for (int j = 0; j < size; ++j) std::memset(dst + j * BPS, dst[j * BPS - 1], size);
      break;
  }
}

#define DST(x, y) dst[(x) + (y) * BPS]

void predict4(uint8_t* dst, int mode) {
  const uint8_t* top = dst - BPS;
  const int X = top[-1], A = top[0], B = top[1], C = top[2], D = top[3];
  const int E = top[4], F = top[5], G = top[6], H = top[7];
  const int I = dst[-1], J = dst[-1 + BPS], K = dst[-1 + 2 * BPS], L = dst[-1 + 3 * BPS];
  switch (mode) {
    case B_DC_PRED: {
      int dc = 4;
      for (int i = 0; i < 4; ++i) dc += dst[i - BPS] + dst[-1 + i * BPS];
      for (int i = 0; i < 4; ++i) std::memset(dst + i * BPS, dc >> 3, 4);
      break;
    }
    case B_TM_PRED:
      true_motion(dst, 4);
      break;
    case B_VE_PRED: {
      const uint8_t vals[4] = {avg3(X, A, B), avg3(A, B, C), avg3(B, C, D), avg3(C, D, E)};
      for (int i = 0; i < 4; ++i) std::memcpy(dst + i * BPS, vals, 4);
      break;
    }
    case B_HE_PRED:
      std::memset(dst + 0 * BPS, avg3(X, I, J), 4);
      std::memset(dst + 1 * BPS, avg3(I, J, K), 4);
      std::memset(dst + 2 * BPS, avg3(J, K, L), 4);
      std::memset(dst + 3 * BPS, avg3(K, L, L), 4);
      break;
    case B_RD_PRED:
      DST(0, 3) = avg3(J, K, L);
      DST(1, 3) = DST(0, 2) = avg3(I, J, K);
      DST(2, 3) = DST(1, 2) = DST(0, 1) = avg3(X, I, J);
      DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = avg3(A, X, I);
      DST(3, 2) = DST(2, 1) = DST(1, 0) = avg3(B, A, X);
      DST(3, 1) = DST(2, 0) = avg3(C, B, A);
      DST(3, 0) = avg3(D, C, B);
      break;
    case B_LD_PRED:
      DST(0, 0) = avg3(A, B, C);
      DST(1, 0) = DST(0, 1) = avg3(B, C, D);
      DST(2, 0) = DST(1, 1) = DST(0, 2) = avg3(C, D, E);
      DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = avg3(D, E, F);
      DST(3, 1) = DST(2, 2) = DST(1, 3) = avg3(E, F, G);
      DST(3, 2) = DST(2, 3) = avg3(F, G, H);
      DST(3, 3) = avg3(G, H, H);
      break;
    case B_VR_PRED:
      DST(0, 0) = DST(1, 2) = avg2(X, A);
      DST(1, 0) = DST(2, 2) = avg2(A, B);
      DST(2, 0) = DST(3, 2) = avg2(B, C);
      DST(3, 0) = avg2(C, D);
      DST(0, 3) = avg3(K, J, I);
      DST(0, 2) = avg3(J, I, X);
      DST(0, 1) = DST(1, 3) = avg3(I, X, A);
      DST(1, 1) = DST(2, 3) = avg3(X, A, B);
      DST(2, 1) = DST(3, 3) = avg3(A, B, C);
      DST(3, 1) = avg3(B, C, D);
      break;
    case B_VL_PRED:
      DST(0, 0) = avg2(A, B);
      DST(1, 0) = DST(0, 2) = avg2(B, C);
      DST(2, 0) = DST(1, 2) = avg2(C, D);
      DST(3, 0) = DST(2, 2) = avg2(D, E);
      DST(0, 1) = avg3(A, B, C);
      DST(1, 1) = DST(0, 3) = avg3(B, C, D);
      DST(2, 1) = DST(1, 3) = avg3(C, D, E);
      DST(3, 1) = DST(2, 3) = avg3(D, E, F);
      DST(3, 2) = avg3(E, F, G);
      DST(3, 3) = avg3(F, G, H);
      break;
    case B_HD_PRED:
      DST(0, 0) = DST(2, 1) = avg2(I, X);
      DST(0, 1) = DST(2, 2) = avg2(J, I);
      DST(0, 2) = DST(2, 3) = avg2(K, J);
      DST(0, 3) = avg2(L, K);
      DST(3, 0) = avg3(A, B, C);
      DST(2, 0) = avg3(X, A, B);
      DST(1, 0) = DST(3, 1) = avg3(I, X, A);
      DST(1, 1) = DST(3, 2) = avg3(J, I, X);
      DST(1, 2) = DST(3, 3) = avg3(K, J, I);
      DST(1, 3) = avg3(L, K, J);
      break;
    case B_HU_PRED:
      DST(0, 0) = avg2(I, J);
      DST(2, 0) = DST(0, 1) = avg2(J, K);
      DST(2, 1) = DST(0, 2) = avg2(K, L);
      DST(1, 0) = avg3(I, J, K);
      DST(3, 0) = DST(1, 1) = avg3(J, K, L);
      DST(3, 1) = DST(1, 2) = avg3(K, L, L);
      DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) = DST(3, 3) = static_cast<uint8_t>(L);
      break;
  }
}

#undef DST

// DC prediction of a macroblock on the frame's top or left edge
int check_mode(int mb_x, int mb_y, int mode) {
  if (mode == B_DC_PRED) {
    if (mb_x == 0) return mb_y == 0 ? DC_NOTOPLEFT : DC_NOLEFT;
    return mb_y == 0 ? DC_NOTOP : DC_PRED;
  }
  return mode;
}

// ------------------------------------------------------------ loop filter

inline int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }
inline int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }
inline uint8_t uclip(int v) { return static_cast<uint8_t>(clip255(v)); }

// 4 pixels in, 2 out
inline void do_filter2(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  p[-step] = uclip(p0 + a2);
  p[0] = uclip(q0 - a1);
}

// 4 pixels in, 4 out
inline void do_filter4(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  const int a3 = (a1 + 1) >> 1;
  p[-2 * step] = uclip(p1 + a3);
  p[-step] = uclip(p0 + a2);
  p[0] = uclip(q0 - a1);
  p[step] = uclip(q1 - a3);
}

// 6 pixels in, 6 out
inline void do_filter6(uint8_t* p, int step) {
  const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step];
  const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
  const int a1 = (27 * a + 63) >> 7;
  const int a2 = (18 * a + 63) >> 7;
  const int a3 = (9 * a + 63) >> 7;
  p[-3 * step] = uclip(p2 + a3);
  p[-2 * step] = uclip(p1 + a2);
  p[-step] = uclip(p0 + a1);
  p[0] = uclip(q0 - a1);
  p[step] = uclip(q1 - a2);
  p[2 * step] = uclip(q2 - a3);
}

inline bool hev(const uint8_t* p, int step, int thresh) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return std::abs(p1 - p0) > thresh || std::abs(q1 - q0) > thresh;
}

inline bool needs_filter(const uint8_t* p, int step, int t) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return 4 * std::abs(p0 - q0) + std::abs(p1 - q1) <= t;
}

inline bool needs_filter2(const uint8_t* p, int step, int t, int it) {
  const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step];
  const int p0 = p[-step], q0 = p[0];
  const int q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
  if (4 * std::abs(p0 - q0) + std::abs(p1 - q1) > t) return false;
  return std::abs(p3 - p2) <= it && std::abs(p2 - p1) <= it && std::abs(p1 - p0) <= it &&
         std::abs(q3 - q2) <= it && std::abs(q2 - q1) <= it && std::abs(q1 - q0) <= it;
}

// the simple filter across one edge of 16 pixels: hstride crosses the edge,
// vstride runs along it
void simple_filter(uint8_t* p, int hstride, int vstride, int thresh) {
  const int thresh2 = 2 * thresh + 1;
  for (int i = 0; i < 16; ++i, p += vstride)
    if (needs_filter(p, hstride, thresh2)) do_filter2(p, hstride);
}

// the normal filter across one edge: 6 taps on a macroblock edge, 4 inside
void filter_loop(uint8_t* p, int hstride, int vstride, int size, int thresh, int ithresh,
                 int hev_thresh, bool mb_edge) {
  const int thresh2 = 2 * thresh + 1;
  for (; size > 0; --size, p += vstride) {
    if (!needs_filter2(p, hstride, thresh2, ithresh)) continue;
    if (hev(p, hstride, hev_thresh)) {
      do_filter2(p, hstride);
    } else if (mb_edge) {
      do_filter6(p, hstride);
    } else {
      do_filter4(p, hstride);
    }
  }
}

// ------------------------------------------------------------ YUV -> RGB

// src/dsp/yuv.h: 14-bit fixed point, >> 6 and a clip
inline int mult_hi(int v, int coeff) { return (v * coeff) >> 8; }
inline int clip8(int v) { return (v & ~16383) == 0 ? (v >> 6) : (v < 0) ? 0 : 255; }
inline void yuv_to_rgb(int y, int u, int v, uint8_t* rgb) {
  rgb[0] = static_cast<uint8_t>(clip8(mult_hi(y, 19077) + mult_hi(v, 26149) - 14234));
  rgb[1] = static_cast<uint8_t>(
      clip8(mult_hi(y, 19077) - mult_hi(u, 6419) - mult_hi(v, 13320) + 8708));
  rgb[2] = static_cast<uint8_t>(clip8(mult_hi(y, 19077) + mult_hi(u, 33050) - 17685));
}

// The fancy upsampler (src/dsp/upsampling.c:UPSAMPLE_FUNC) on one pair of
// output rows: top_y lies nearer the chroma row top_u/top_v, bottom_y
// (optional) nearer cur_u/cur_v. Each output sample weighs its four chroma
// neighbours 9/3/3/1 in two rounded steps, as libwebp does (its u and v lanes
// share a 32-bit word without carrying into each other).
void upsample_pair(const uint8_t* top_y, const uint8_t* bottom_y, const uint8_t* top_u,
                   const uint8_t* top_v, const uint8_t* cur_u, const uint8_t* cur_v,
                   uint8_t* top_dst, uint8_t* bottom_dst, int len) {
  const int last_pair = (len - 1) >> 1;
  int tl_u = top_u[0], tl_v = top_v[0];  // top-left
  int l_u = cur_u[0], l_v = cur_v[0];    // left
  yuv_to_rgb(top_y[0], (3 * tl_u + l_u + 2) >> 2, (3 * tl_v + l_v + 2) >> 2, top_dst);
  if (bottom_y)
    yuv_to_rgb(bottom_y[0], (3 * l_u + tl_u + 2) >> 2, (3 * l_v + tl_v + 2) >> 2, bottom_dst);
  for (int x = 1; x <= last_pair; ++x) {
    const int t_u = top_u[x], t_v = top_v[x];
    const int c_u = cur_u[x], c_v = cur_v[x];
    const int avg_u = tl_u + t_u + l_u + c_u + 8, avg_v = tl_v + t_v + l_v + c_v + 8;
    const int d12_u = (avg_u + 2 * (t_u + l_u)) >> 3, d12_v = (avg_v + 2 * (t_v + l_v)) >> 3;
    const int d03_u = (avg_u + 2 * (tl_u + c_u)) >> 3, d03_v = (avg_v + 2 * (tl_v + c_v)) >> 3;
    yuv_to_rgb(top_y[2 * x - 1], (d12_u + tl_u) >> 1, (d12_v + tl_v) >> 1,
               top_dst + 3 * (2 * x - 1));
    yuv_to_rgb(top_y[2 * x], (d03_u + t_u) >> 1, (d03_v + t_v) >> 1, top_dst + 3 * (2 * x));
    if (bottom_y) {
      yuv_to_rgb(bottom_y[2 * x - 1], (d03_u + l_u) >> 1, (d03_v + l_v) >> 1,
                 bottom_dst + 3 * (2 * x - 1));
      yuv_to_rgb(bottom_y[2 * x], (d12_u + c_u) >> 1, (d12_v + c_v) >> 1,
                 bottom_dst + 3 * (2 * x));
    }
    tl_u = t_u;
    tl_v = t_v;
    l_u = c_u;
    l_v = c_v;
  }
  if (!(len & 1)) {
    yuv_to_rgb(top_y[len - 1], (3 * tl_u + l_u + 2) >> 2, (3 * tl_v + l_v + 2) >> 2,
               top_dst + 3 * (len - 1));
    if (bottom_y)
      yuv_to_rgb(bottom_y[len - 1], (3 * l_u + tl_u + 2) >> 2, (3 * l_v + tl_v + 2) >> 2,
                 bottom_dst + 3 * (len - 1));
  }
}

// ------------------------------------------------------------ the decoder

class VP8Decoder {
 public:
  // data: the VP8 chunk's payload (frame tag first)
  VP8Decoder(const uint8_t* data, size_t size) : data_(data), size_(size) {}

  void decode();
  // RGB of the width x height picture, rows `stride` bytes apart
  void to_rgb(uint8_t* out, size_t stride) const;

  int width = 0, height = 0;
  // the decoded planes, whole macroblocks (the picture is their top-left corner)
  std::vector<uint8_t> y, u, v;
  int y_stride = 0, uv_stride = 0;

 private:
  struct MB {  // a macroblock column's top context, and the left context
    uint8_t nz = 0, nz_dc = 0;
  };
  struct Block {  // what partition 0 says of one macroblock
    uint8_t segment = 0, skip = 0, is_i4x4 = 0, uvmode = 0;
    uint8_t imodes[16];
  };

  void parse_headers(const uint8_t* buf, size_t size);
  void parse_intra_mode(Block& b, int mb_x);
  int get_coeffs(BoolDecoder& br, int type, int ctx, const int* dq, int n, int16_t* out);
  bool parse_residuals(const Block& b, MB& top, MB& left, BoolDecoder& br);
  void reconstruct(const Block& b, int mb_x, int mb_y);
  void filter(int mb_x, int mb_y);

  const uint8_t* data_;
  size_t size_;
  int mb_w_ = 0, mb_h_ = 0;
  BoolDecoder br_;
  BoolDecoder parts_[8];
  int num_parts_ = 1;

  // segment header
  bool use_segment_ = false, update_map_ = false, absolute_delta_ = true;
  int quantizer_[4] = {0, 0, 0, 0}, filter_strength_[4] = {0, 0, 0, 0};
  int segment_proba_[3] = {255, 255, 255};
  // filter header
  int simple_ = 0, level_ = 0, sharpness_ = 0, use_lf_delta_ = 0;
  int ref_lf_delta_[4] = {0, 0, 0, 0}, mode_lf_delta_[4] = {0, 0, 0, 0};
  int filter_type_ = 0;  // 0 off, 1 simple, 2 normal

  QuantMatrix dqm_[4];
  uint8_t proba_[4][8][3][11];
  bool use_skip_proba_ = false;
  int skip_p_ = 0;
  FilterInfo fstrengths_[4][2];

  std::vector<uint8_t> intra_t_;  // 4 sub-block modes above each macroblock column
  uint8_t intra_l_[4];
  int16_t coeffs_[384];
  uint8_t nz_codes_[24];  // per block: 0 none, 1 DC only, 2 or 3 more
  std::vector<FilterInfo> finfo_;
  uint8_t ws_[YUV_SIZE];                 // the macroblock work area
  std::vector<uint8_t> top_y_, top_u_, top_v_;  // unfiltered bottom rows of the row above
};

void VP8Decoder::parse_headers(const uint8_t* buf, size_t size) {
  if (size < 10) fail("VP8: truncated frame header");
  const uint32_t tag = le24(buf);
  if (tag & 1) fail("VP8: not a key frame");
  if (((tag >> 1) & 7) > 3) fail("VP8: unknown profile");
  if (!((tag >> 4) & 1)) fail("VP8: the frame is not shown");
  const size_t part0 = tag >> 5;
  if (buf[3] != 0x9d || buf[4] != 0x01 || buf[5] != 0x2a) fail("VP8: bad start code");
  width = le16(buf + 6) & 0x3fff;  // the two scale bits are ignored, as libwebp ignores them
  height = le16(buf + 8) & 0x3fff;
  if (width == 0 || height == 0) fail("VP8: zero width or height");
  buf += 10;
  size -= 10;
  if (part0 > size) fail("VP8: the first partition's size exceeds the data");
  br_.init(buf, part0);
  buf += part0;
  size -= part0;

  BoolDecoder& br = br_;
  br.get();  // colour space
  br.get();  // clamping type
  // segment header
  use_segment_ = br.get();
  if (use_segment_) {
    update_map_ = br.get();
    if (br.get()) {  // update the segment data
      absolute_delta_ = br.get();
      for (int s = 0; s < 4; ++s) quantizer_[s] = br.get() ? br.signed_value(7) : 0;
      for (int s = 0; s < 4; ++s) filter_strength_[s] = br.get() ? br.signed_value(6) : 0;
    }
    if (update_map_)
      for (int s = 0; s < 3; ++s) segment_proba_[s] = br.get() ? br.value(8) : 255;
  } else {
    update_map_ = false;
  }
  if (br.eof()) fail("VP8: cannot parse the segment header");
  // filter header
  simple_ = br.get();
  level_ = br.value(6);
  sharpness_ = br.value(3);
  use_lf_delta_ = br.get();
  if (use_lf_delta_ && br.get()) {  // update the deltas
    for (int i = 0; i < 4; ++i)
      if (br.get()) ref_lf_delta_[i] = br.signed_value(6);
    for (int i = 0; i < 4; ++i)
      if (br.get()) mode_lf_delta_[i] = br.signed_value(6);
  }
  filter_type_ = level_ == 0 ? 0 : simple_ ? 1 : 2;
  if (br.eof()) fail("VP8: cannot parse the filter header");
  // token partitions: their sizes (3 bytes each but the last's), then the data
  num_parts_ = 1 << br.value(2);
  const size_t last = num_parts_ - 1;
  if (size < 3 * last) fail("VP8: truncated partition sizes");
  const uint8_t* sz = buf;
  const uint8_t* part = buf + 3 * last;
  size_t left = size - 3 * last;
  for (size_t p = 0; p < last; ++p, sz += 3) {
    const size_t psize = std::min<size_t>(le24(sz), left);
    parts_[p].init(part, psize);
    part += psize;
    left -= psize;
  }
  parts_[last].init(part, left);
  if (left == 0) fail("VP8: the last token partition is empty");
  // quantizers
  const int base_q0 = br.value(7);
  const int dqy1_dc = br.get() ? br.signed_value(4) : 0;
  const int dqy2_dc = br.get() ? br.signed_value(4) : 0;
  const int dqy2_ac = br.get() ? br.signed_value(4) : 0;
  const int dquv_dc = br.get() ? br.signed_value(4) : 0;
  const int dquv_ac = br.get() ? br.signed_value(4) : 0;
  auto clip = [](int v, int m) { return v < 0 ? 0 : v > m ? m : v; };
  for (int i = 0; i < 4; ++i) {
    int q;
    if (use_segment_) {
      q = quantizer_[i] + (absolute_delta_ ? 0 : base_q0);
    } else if (i > 0) {
      dqm_[i] = dqm_[0];
      continue;
    } else {
      q = base_q0;
    }
    QuantMatrix& m = dqm_[i];
    m.y1[0] = kDcTable[clip(q + dqy1_dc, 127)];
    m.y1[1] = kAcTable[clip(q, 127)];
    m.y2[0] = kDcTable[clip(q + dqy2_dc, 127)] * 2;
    // x * 155 / 100 is (x * 101581) >> 16 for every x of the table
    m.y2[1] = (kAcTable[clip(q + dqy2_ac, 127)] * 101581) >> 16;
    if (m.y2[1] < 8) m.y2[1] = 8;
    m.uv[0] = kDcTable[clip(q + dquv_dc, 117)];
    m.uv[1] = kAcTable[clip(q + dquv_ac, 127)];
  }
  br.get();  // update_proba: ignored for a key frame
  for (int t = 0; t < 4; ++t)
    for (int b = 0; b < 8; ++b)
      for (int c = 0; c < 3; ++c)
        for (int p = 0; p < 11; ++p)
          proba_[t][b][c][p] = static_cast<uint8_t>(
              br.bit(kCoeffsUpdateProba[t][b][c][p]) ? br.value(8) : kCoeffsProba0[t][b][c][p]);
  use_skip_proba_ = br.get();
  if (use_skip_proba_) skip_p_ = br.value(8);
  if (br.eof()) fail("VP8: truncated frame header");

  // the filter strength of each segment, without and with B_PRED
  if (filter_type_ > 0) {
    for (int s = 0; s < 4; ++s) {
      int base_level = level_;
      if (use_segment_) base_level = filter_strength_[s] + (absolute_delta_ ? 0 : level_);
      for (int i4x4 = 0; i4x4 <= 1; ++i4x4) {
        FilterInfo& info = fstrengths_[s][i4x4];
        int level = base_level;
        if (use_lf_delta_) {
          level += ref_lf_delta_[0];
          if (i4x4) level += mode_lf_delta_[0];
        }
        level = level < 0 ? 0 : level > 63 ? 63 : level;
        if (level > 0) {
          int ilevel = level;
          if (sharpness_ > 0) {
            ilevel >>= sharpness_ > 4 ? 2 : 1;
            if (ilevel > 9 - sharpness_) ilevel = 9 - sharpness_;
          }
          if (ilevel < 1) ilevel = 1;
          info.ilevel = static_cast<uint8_t>(ilevel);
          info.limit = static_cast<uint8_t>(2 * level + ilevel);
          info.hev_thresh = level >= 40 ? 2 : level >= 15 ? 1 : 0;
        } else {
          info.limit = 0;
        }
        info.inner = static_cast<uint8_t>(i4x4);
      }
    }
  }
}

void VP8Decoder::parse_intra_mode(Block& b, int mb_x) {
  BoolDecoder& br = br_;
  uint8_t* top = intra_t_.data() + 4 * mb_x;
  uint8_t* left = intra_l_;
  if (update_map_) {
    b.segment = static_cast<uint8_t>(!br.bit(segment_proba_[0]) ? br.bit(segment_proba_[1])
                                                                 : br.bit(segment_proba_[2]) + 2);
  } else {
    b.segment = 0;
  }
  b.skip = use_skip_proba_ ? static_cast<uint8_t>(br.bit(skip_p_)) : 0;
  b.is_i4x4 = !br.bit(145);
  if (!b.is_i4x4) {
    const int ymode = br.bit(156) ? (br.bit(128) ? TM_PRED : H_PRED)
                                  : (br.bit(163) ? V_PRED : DC_PRED);
    b.imodes[0] = static_cast<uint8_t>(ymode);
    std::memset(top, ymode, 4);
    std::memset(left, ymode, 4);
  } else {
    uint8_t* modes = b.imodes;
    for (int y = 0; y < 4; ++y) {
      int ymode = left[y];
      for (int x = 0; x < 4; ++x) {
        const uint8_t* prob = kBModesProba[top[x]][ymode];
        int i = kYModesIntra4[br.bit(prob[0])];
        while (i > 0) i = kYModesIntra4[2 * i + br.bit(prob[i])];
        ymode = -i;
        top[x] = static_cast<uint8_t>(ymode);
      }
      std::memcpy(modes, top, 4);
      modes += 4;
      left[y] = static_cast<uint8_t>(ymode);
    }
  }
  b.uvmode = !br.bit(142) ? DC_PRED : !br.bit(114) ? V_PRED : br.bit(183) ? TM_PRED : H_PRED;
}

int large_value(BoolDecoder& br, const uint8_t* p) {
  int v;
  if (!br.bit(p[3])) {
    v = !br.bit(p[4]) ? 2 : 3 + br.bit(p[5]);
  } else if (!br.bit(p[6])) {
    if (!br.bit(p[7])) {
      v = 5 + br.bit(159);
    } else {
      v = 7 + 2 * br.bit(165);
      v += br.bit(145);
    }
  } else {
    const int bit1 = br.bit(p[8]);
    const int bit0 = br.bit(p[9 + bit1]);
    const int cat = 2 * bit1 + bit0;
    v = 0;
    for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab) v += v + br.bit(*tab);
    v += 3 + (8 << cat);
  }
  return v;
}

// The tokens of one 4x4 block from position n on, dequantized into out in
// natural order; returns the position after the last non-zero one (or n)
int VP8Decoder::get_coeffs(BoolDecoder& br, int type, int ctx, const int* dq, int n,
                           int16_t* out) {
  const uint8_t* p = proba_[type][kBands[n]][ctx];
  for (; n < 16; ++n) {
    if (!br.bit(p[0])) return n;  // end of block
    while (!br.bit(p[1])) {       // a zero
      p = proba_[type][kBands[++n]][0];
      if (n == 16) return 16;
    }
    int v;
    const int band = kBands[n + 1];
    if (!br.bit(p[2])) {
      v = 1;
      p = proba_[type][band][1];
    } else {
      v = large_value(br, p);
      p = proba_[type][band][2];
    }
    const int s = br.bit(0x80) ? -v : v;
    out[kZigzag[n]] = static_cast<int16_t>(s * dq[n > 0]);
  }
  return 16;
}

inline uint8_t nz_code(int nz, int dc_nz) { return nz > 3 ? 3 : nz > 1 ? 2 : dc_nz; }

// returns true when the macroblock has no non-zero coefficient
bool VP8Decoder::parse_residuals(const Block& b, MB& mb, MB& left, BoolDecoder& br) {
  const QuantMatrix& q = dqm_[b.segment];
  int16_t* dst = coeffs_;
  std::memset(coeffs_, 0, sizeof(coeffs_));
  bool any = false;
  int first, ac_type;
  if (!b.is_i4x4) {  // the Y2 block: the luma DCs
    int16_t dc[16] = {0};
    const int ctx = mb.nz_dc + left.nz_dc;
    const int nz = get_coeffs(br, 1, ctx, q.y2, 0, dc);
    mb.nz_dc = left.nz_dc = nz > 0;
    if (nz > 1) {
      transform_wht(dc, dst);
    } else {
      const int dc0 = (dc[0] + 3) >> 3;
      for (int i = 0; i < 16 * 16; i += 16) dst[i] = static_cast<int16_t>(dc0);
    }
    first = 1;
    ac_type = 0;
  } else {
    first = 0;
    ac_type = 3;
  }
  uint32_t tnz = mb.nz & 0x0f;
  uint32_t lnz = left.nz & 0x0f;
  for (int y = 0; y < 4; ++y) {
    int l = lnz & 1;
    for (int x = 0; x < 4; ++x) {
      const int ctx = l + (tnz & 1);
      const int nz = get_coeffs(br, ac_type, ctx, q.y1, first, dst);
      l = nz > first;
      tnz = (tnz >> 1) | (l << 7);
      nz_codes_[4 * y + x] = nz_code(nz, dst[0] != 0);
      any |= nz_codes_[4 * y + x] != 0;
      dst += 16;
    }
    tnz >>= 4;
    lnz = (lnz >> 1) | (l << 7);
  }
  uint32_t out_t_nz = tnz;
  uint32_t out_l_nz = lnz >> 4;
  for (int ch = 0; ch < 4; ch += 2) {
    tnz = mb.nz >> (4 + ch);
    lnz = left.nz >> (4 + ch);
    for (int y = 0; y < 2; ++y) {
      int l = lnz & 1;
      for (int x = 0; x < 2; ++x) {
        const int ctx = l + (tnz & 1);
        const int nz = get_coeffs(br, 2, ctx, q.uv, 0, dst);
        l = nz > 0;
        tnz = (tnz >> 1) | (l << 3);
        const int k = 16 + 2 * ch + 2 * y + x;
        nz_codes_[k] = nz_code(nz, dst[0] != 0);
        any |= nz_codes_[k] != 0;
        dst += 16;
      }
      tnz >>= 2;
      lnz = (lnz >> 1) | (l << 5);
    }
    out_t_nz |= (tnz << 4) << ch;
    out_l_nz |= (lnz & 0xf0) << ch;
  }
  mb.nz = static_cast<uint8_t>(out_t_nz);
  left.nz = static_cast<uint8_t>(out_l_nz);
  return !any;
}

// prediction plus residuals of one macroblock in the work area, then into the
// planes (frame_dec.c:ReconstructRow)
void VP8Decoder::reconstruct(const Block& b, int mb_x, int mb_y) {
  uint8_t* const y_dst = ws_ + Y_OFF;
  uint8_t* const u_dst = ws_ + U_OFF;
  uint8_t* const v_dst = ws_ + V_OFF;
  if (mb_x == 0) {  // the left columns of the first macroblock of a row
    for (int j = 0; j < 16; ++j) y_dst[j * BPS - 1] = 129;
    for (int j = 0; j < 8; ++j) u_dst[j * BPS - 1] = v_dst[j * BPS - 1] = 129;
    if (mb_y > 0) {
      y_dst[-1 - BPS] = u_dst[-1 - BPS] = v_dst[-1 - BPS] = 129;
    } else {
      std::memset(y_dst - BPS - 1, 127, 16 + 4 + 1);
      std::memset(u_dst - BPS - 1, 127, 8 + 1);
      std::memset(v_dst - BPS - 1, 127, 8 + 1);
    }
  } else {  // the previous macroblock's right columns become the left ones
    for (int j = -1; j < 16; ++j) std::memcpy(y_dst + j * BPS - 4, y_dst + j * BPS + 12, 4);
    for (int j = -1; j < 8; ++j) {
      std::memcpy(u_dst + j * BPS - 4, u_dst + j * BPS + 4, 4);
      std::memcpy(v_dst + j * BPS - 4, v_dst + j * BPS + 4, 4);
    }
  }
  if (mb_y > 0) {
    std::memcpy(y_dst - BPS, &top_y_[16 * mb_x], 16);
    std::memcpy(u_dst - BPS, &top_u_[8 * mb_x], 8);
    std::memcpy(v_dst - BPS, &top_v_[8 * mb_x], 8);
  }
  const int16_t* coeffs = coeffs_;
  if (b.is_i4x4) {
    uint8_t* top_right = y_dst - BPS + 16;
    if (mb_y > 0) {
      if (mb_x >= mb_w_ - 1) {  // the frame's right edge
        std::memset(top_right, top_y_[16 * mb_x + 15], 4);
      } else {
        std::memcpy(top_right, &top_y_[16 * (mb_x + 1)], 4);
      }
    }
    // the sub-blocks on the right of rows 1-3 see the macroblock's top-right
    for (int r = 1; r <= 3; ++r) std::memcpy(top_right + 4 * r * BPS, top_right, 4);
    for (int n = 0; n < 16; ++n) {
      uint8_t* dst = y_dst + kScan[n];
      predict4(dst, b.imodes[n]);
      if (nz_codes_[n]) transform_add(coeffs + 16 * n, dst);
    }
  } else {
    predict_block(y_dst, 16, check_mode(mb_x, mb_y, b.imodes[0]));
    for (int n = 0; n < 16; ++n)
      if (nz_codes_[n]) transform_add(coeffs + 16 * n, y_dst + kScan[n]);
  }
  const int uvmode = check_mode(mb_x, mb_y, b.uvmode);
  predict_block(u_dst, 8, uvmode);
  predict_block(v_dst, 8, uvmode);
  for (int n = 0; n < 4; ++n) {
    const int x = (n & 1) * 4, y = (n >> 1) * 4;
    if (nz_codes_[16 + n]) transform_add(coeffs + 16 * (16 + n), u_dst + x + y * BPS);
    if (nz_codes_[20 + n]) transform_add(coeffs + 16 * (20 + n), v_dst + x + y * BPS);
  }
  // the unfiltered bottom rows predict the next row of macroblocks
  if (mb_y < mb_h_ - 1) {
    std::memcpy(&top_y_[16 * mb_x], y_dst + 15 * BPS, 16);
    std::memcpy(&top_u_[8 * mb_x], u_dst + 7 * BPS, 8);
    std::memcpy(&top_v_[8 * mb_x], v_dst + 7 * BPS, 8);
  }
  for (int j = 0; j < 16; ++j)
    std::memcpy(&y[(16 * mb_y + j) * static_cast<size_t>(y_stride) + 16 * mb_x],
                y_dst + j * BPS, 16);
  for (int j = 0; j < 8; ++j) {
    const size_t at = (8 * mb_y + j) * static_cast<size_t>(uv_stride) + 8 * mb_x;
    std::memcpy(&u[at], u_dst + j * BPS, 8);
    std::memcpy(&v[at], v_dst + j * BPS, 8);
  }
}

// the loop filter of one macroblock, its left and top edges then its inner
// ones (frame_dec.c:DoFilter)
void VP8Decoder::filter(int mb_x, int mb_y) {
  const FilterInfo& f = finfo_[static_cast<size_t>(mb_y) * mb_w_ + mb_x];
  const int limit = f.limit;
  if (limit == 0) return;
  const int ys = y_stride, uvs = uv_stride;
  uint8_t* y_dst = &y[static_cast<size_t>(16 * mb_y) * ys + 16 * mb_x];
  if (filter_type_ == 1) {  // simple: luma only
    if (mb_x > 0) simple_filter(y_dst, 1, ys, limit + 4);
    if (f.inner)
      for (int k = 1; k <= 3; ++k) simple_filter(y_dst + 4 * k, 1, ys, limit);
    if (mb_y > 0) simple_filter(y_dst, ys, 1, limit + 4);
    if (f.inner)
      for (int k = 1; k <= 3; ++k) simple_filter(y_dst + 4 * k * ys, ys, 1, limit);
    return;
  }
  uint8_t* u_dst = &u[static_cast<size_t>(8 * mb_y) * uvs + 8 * mb_x];
  uint8_t* v_dst = &v[static_cast<size_t>(8 * mb_y) * uvs + 8 * mb_x];
  const int il = f.ilevel, hev_t = f.hev_thresh;
  if (mb_x > 0) {
    filter_loop(y_dst, 1, ys, 16, limit + 4, il, hev_t, true);
    filter_loop(u_dst, 1, uvs, 8, limit + 4, il, hev_t, true);
    filter_loop(v_dst, 1, uvs, 8, limit + 4, il, hev_t, true);
  }
  if (f.inner) {
    for (int k = 1; k <= 3; ++k) filter_loop(y_dst + 4 * k, 1, ys, 16, limit, il, hev_t, false);
    filter_loop(u_dst + 4, 1, uvs, 8, limit, il, hev_t, false);
    filter_loop(v_dst + 4, 1, uvs, 8, limit, il, hev_t, false);
  }
  if (mb_y > 0) {
    filter_loop(y_dst, ys, 1, 16, limit + 4, il, hev_t, true);
    filter_loop(u_dst, uvs, 1, 8, limit + 4, il, hev_t, true);
    filter_loop(v_dst, uvs, 1, 8, limit + 4, il, hev_t, true);
  }
  if (f.inner) {
    for (int k = 1; k <= 3; ++k)
      filter_loop(y_dst + 4 * k * ys, ys, 1, 16, limit, il, hev_t, false);
    filter_loop(u_dst + 4 * uvs, uvs, 1, 8, limit, il, hev_t, false);
    filter_loop(v_dst + 4 * uvs, uvs, 1, 8, limit, il, hev_t, false);
  }
}

void VP8Decoder::decode() {
  parse_headers(data_, size_);
  mb_w_ = (width + 15) >> 4;
  mb_h_ = (height + 15) >> 4;
  y_stride = 16 * mb_w_;
  uv_stride = 8 * mb_w_;
  y.assign(static_cast<size_t>(y_stride) * 16 * mb_h_, 0);
  u.assign(static_cast<size_t>(uv_stride) * 8 * mb_h_, 0);
  v.assign(u.size(), 0);
  top_y_.assign(16 * mb_w_, 0);
  top_u_.assign(8 * mb_w_, 0);
  top_v_.assign(8 * mb_w_, 0);
  intra_t_.assign(4 * mb_w_, B_DC_PRED);
  finfo_.assign(static_cast<size_t>(mb_w_) * mb_h_, FilterInfo());
  std::memset(ws_, 0, sizeof(ws_));
  std::vector<MB> mb_info(mb_w_);
  std::vector<Block> blocks(mb_w_);
  for (int mb_y = 0; mb_y < mb_h_; ++mb_y) {
    std::memset(intra_l_, B_DC_PRED, 4);
    MB left;
    for (int mb_x = 0; mb_x < mb_w_; ++mb_x) parse_intra_mode(blocks[mb_x], mb_x);
    if (br_.eof()) fail("VP8: premature end of the first partition");
    BoolDecoder& token_br = parts_[mb_y & (num_parts_ - 1)];
    for (int mb_x = 0; mb_x < mb_w_; ++mb_x) {
      const Block& b = blocks[mb_x];
      MB& mb = mb_info[mb_x];
      bool skip = use_skip_proba_ && b.skip;
      if (!skip) {
        skip = parse_residuals(b, mb, left, token_br);
      } else {
        left.nz = mb.nz = 0;
        if (!b.is_i4x4) left.nz_dc = mb.nz_dc = 0;
        std::memset(nz_codes_, 0, sizeof(nz_codes_));
      }
      if (filter_type_ > 0) {
        FilterInfo& f = finfo_[static_cast<size_t>(mb_y) * mb_w_ + mb_x];
        f = fstrengths_[b.segment][b.is_i4x4];
        f.inner |= !skip;
      }
      if (token_br.eof()) fail("VP8: premature end of a token partition");
      reconstruct(b, mb_x, mb_y);
    }
  }
  if (filter_type_ > 0)
    for (int mb_y = 0; mb_y < mb_h_; ++mb_y)
      for (int mb_x = 0; mb_x < mb_w_; ++mb_x) filter(mb_x, mb_y);
}

// io_dec.c:EmitFancyRGB over the whole picture: the first row alone, then
// pairs of rows between two chroma rows, then an even height's last row alone
void VP8Decoder::to_rgb(uint8_t* out, size_t stride) const {
  const int w = width, h = height;
  const uint8_t* cur_y = y.data();
  const uint8_t* cur_u = u.data();
  const uint8_t* cur_v = v.data();
  upsample_pair(cur_y, nullptr, cur_u, cur_v, cur_u, cur_v, out, nullptr, w);
  int row = 0;
  for (; row + 2 < h; row += 2) {
    const uint8_t* top_u = cur_u;
    const uint8_t* top_v = cur_v;
    cur_u += uv_stride;
    cur_v += uv_stride;
    cur_y += 2 * static_cast<size_t>(y_stride);
    upsample_pair(cur_y - y_stride, cur_y, top_u, top_v, cur_u, cur_v,
                  out + (row + 1) * stride, out + (row + 2) * stride, w);
  }
  if (!(h & 1)) {
    cur_y += y_stride;
    upsample_pair(cur_y, nullptr, cur_u, cur_v, cur_u, cur_v, out + (h - 1) * stride, nullptr, w);
  }
}

// ================================================================== VP8L

static_assert(__BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__, "LBitReader loads 8 bytes at once");

// the least-significant-bit-first reader; reads past the end give zeros and
// mark the stream as ended
class LBitReader {
 public:
  LBitReader(const uint8_t* data, size_t size) : data_(data), size_(size) {}
  uint32_t peek(int n) const {  // n <= 24
    const size_t byte = pos_ >> 3;
    uint64_t w = 0;
    if (byte + 8 <= size_) {
      std::memcpy(&w, data_ + byte, 8);
    } else {
      for (size_t i = std::min<size_t>(size_, byte + 8); i-- > byte;) w = (w << 8) | data_[i];
    }
    return static_cast<uint32_t>(w >> (pos_ & 7)) & ((1u << n) - 1);
  }
  uint32_t read(int n) {
    const uint32_t v = peek(n);
    skip(n);
    return v;
  }
  void skip(int n) {
    if (pos_ <= 8 * static_cast<uint64_t>(size_)) pos_ += n;
  }
  bool eos() const { return pos_ > 8 * static_cast<uint64_t>(size_); }

 private:
  const uint8_t* data_;
  size_t size_;
  uint64_t pos_ = 0;
};

// A canonical prefix code (codes assigned by length, then by symbol, the first
// bit read the code's most significant): a table of the codes of up to 8 bits
// by their first 8 bits, the rest by a walk over the lengths.
class PrefixCode {
 public:
  // false when the lengths give no code, or one that is not complete
  bool build(const int* lengths, int n) {
    int count[16] = {0};
    int symbols = 0, last = 0;
    for (int s = 0; s < n; ++s) {
      if (lengths[s] > 15) return false;
      if (lengths[s]) {
        ++count[lengths[s]];
        ++symbols;
        last = s;
      }
    }
    if (symbols == 0) return false;
    if (symbols == 1) {  // a code of one symbol takes no bits
      single_ = last;
      return true;
    }
    int64_t kraft = 0;
    for (int l = 1; l <= 15; ++l) kraft += static_cast<int64_t>(count[l]) << (15 - l);
    if (kraft != (1 << 15)) return false;
    single_ = -1;
    std::memcpy(count_, count, sizeof(count_));
    int offset[16];
    offset[1] = 0;
    for (int l = 1; l < 15; ++l) offset[l + 1] = offset[l] + count[l];
    sorted_.assign(symbols, 0);
    for (int s = 0; s < n; ++s)
      if (lengths[s]) sorted_[offset[lengths[s]]++] = static_cast<uint16_t>(s);
    fast_.assign(256, 0);
    int code = 0, k = 0;
    for (int l = 1; l <= 8; ++l, code <<= 1) {
      for (int i = 0; i < count[l]; ++i, ++code, ++k) {
        int rev = 0;
        for (int b = 0; b < l; ++b) rev |= ((code >> b) & 1) << (l - 1 - b);
        for (int j = rev; j < 256; j += 1 << l)
          fast_[j] = (static_cast<uint32_t>(l) << 16) | sorted_[k];
      }
    }
    return true;
  }

  int read(LBitReader& br) const {
    if (single_ >= 0) return single_;
    const uint32_t e = fast_[br.peek(8)];
    if (e) {
      br.skip(e >> 16);
      return e & 0xffff;
    }
    int code = 0, first = 0, index = 0;
    for (int l = 1; l <= 15; ++l) {
      code |= br.read(1);
      const int c = count_[l];
      if (code - c < first) return sorted_[index + (code - first)];
      index += c;
      first = (first + c) << 1;
      code <<= 1;
    }
    return 0;  // not reached for a complete code
  }

 private:
  int single_ = -1;
  int count_[16] = {0};
  std::vector<uint16_t> sorted_;
  std::vector<uint32_t> fast_;
};

constexpr int kNumLiteralCodes = 256;
constexpr int kNumLengthCodes = 24;
constexpr int kAlphabetSize[5] = {kNumLiteralCodes + kNumLengthCodes, 256, 256, 256, 40};
const uint8_t kCodeLengthCodeOrder[19] = {17, 18, 0, 1, 2, 3, 4, 5, 16, 6,
                                          7,  8,  9, 10, 11, 12, 13, 14, 15};
// the 120 short distance codes as (dy << 4) | (8 - dx)
const uint8_t kCodeToPlane[120] = {
    0x18, 0x07, 0x17, 0x19, 0x28, 0x06, 0x27, 0x29, 0x16, 0x1a, 0x26, 0x2a, 0x38, 0x05, 0x37,
    0x39, 0x15, 0x1b, 0x36, 0x3a, 0x25, 0x2b, 0x48, 0x04, 0x47, 0x49, 0x14, 0x1c, 0x35, 0x3b,
    0x46, 0x4a, 0x24, 0x2c, 0x58, 0x45, 0x4b, 0x34, 0x3c, 0x03, 0x57, 0x59, 0x13, 0x1d, 0x56,
    0x5a, 0x23, 0x2d, 0x44, 0x4c, 0x55, 0x5b, 0x33, 0x3d, 0x68, 0x02, 0x67, 0x69, 0x12, 0x1e,
    0x66, 0x6a, 0x22, 0x2e, 0x54, 0x5c, 0x43, 0x4d, 0x65, 0x6b, 0x32, 0x3e, 0x78, 0x01, 0x77,
    0x79, 0x53, 0x5d, 0x11, 0x1f, 0x64, 0x6c, 0x42, 0x4e, 0x76, 0x7a, 0x21, 0x2f, 0x75, 0x7b,
    0x31, 0x3f, 0x63, 0x6d, 0x52, 0x5e, 0x00, 0x74, 0x7c, 0x41, 0x4f, 0x10, 0x20, 0x62, 0x6e,
    0x30, 0x73, 0x7d, 0x51, 0x5f, 0x40, 0x72, 0x7e, 0x61, 0x6f, 0x50, 0x71, 0x7f, 0x60, 0x70,};

inline int subsample(int size, int bits) { return (size + (1 << bits) - 1) >> bits; }

// per-channel arithmetic of the lossless predictors (dsp/lossless.c)
inline uint32_t add_pixels(uint32_t a, uint32_t b) {
  const uint32_t ag = (a & 0xff00ff00u) + (b & 0xff00ff00u);
  const uint32_t rb = (a & 0x00ff00ffu) + (b & 0x00ff00ffu);
  return (ag & 0xff00ff00u) | (rb & 0x00ff00ffu);
}
inline uint32_t average2(uint32_t a, uint32_t b) {
  return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b);
}
inline int sub3(int a, int b, int c) { return std::abs(b - c) - std::abs(a - c); }
inline uint32_t select(uint32_t a, uint32_t b, uint32_t c) {
  const int pa_minus_pb = sub3(a >> 24, b >> 24, c >> 24) +
                          sub3((a >> 16) & 0xff, (b >> 16) & 0xff, (c >> 16) & 0xff) +
                          sub3((a >> 8) & 0xff, (b >> 8) & 0xff, (c >> 8) & 0xff) +
                          sub3(a & 0xff, b & 0xff, c & 0xff);
  return pa_minus_pb <= 0 ? a : b;
}
inline uint32_t clamped_add_subtract_full(uint32_t c0, uint32_t c1, uint32_t c2) {
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8)
    out |= static_cast<uint32_t>(clip255(static_cast<int>((c0 >> s) & 0xff) +
                                         static_cast<int>((c1 >> s) & 0xff) -
                                         static_cast<int>((c2 >> s) & 0xff)))
           << s;
  return out;
}
inline uint32_t clamped_add_subtract_half(uint32_t c0, uint32_t c1, uint32_t c2) {
  const uint32_t ave = average2(c0, c1);
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8) {
    const int a = (ave >> s) & 0xff, b = (c2 >> s) & 0xff;
    out |= static_cast<uint32_t>(clip255(a + (a - b) / 2)) << s;  // C division: toward zero
  }
  return out;
}

// predictor `mode` of the pixel whose left neighbour is left and whose row
// above, at its column, starts at top (top[-1] is above-left, top[1] above-right)
inline uint32_t predict(int mode, uint32_t left, const uint32_t* top) {
  switch (mode) {
    case 1: return left;
    case 2: return top[0];
    case 3: return top[1];
    case 4: return top[-1];
    case 5: return average2(average2(left, top[1]), top[0]);
    case 6: return average2(left, top[-1]);
    case 7: return average2(left, top[0]);
    case 8: return average2(top[-1], top[0]);
    case 9: return average2(top[0], top[1]);
    case 10: return average2(average2(left, top[-1]), average2(top[0], top[1]));
    case 11: return select(top[0], left, top[-1]);
    case 12: return clamped_add_subtract_full(left, top[0], top[-1]);
    case 13: return clamped_add_subtract_half(left, top[0], top[-1]);
    default: return 0xff000000u;  // 0, and 14 and 15 as libwebp reads them
  }
}

class VP8LDecoder {
 public:
  VP8LDecoder(const uint8_t* data, size_t size) : br_(data, size) {}

  // ARGB of the image, width x height as its header gives them
  std::vector<uint32_t> decode() {
    if (br_.read(8) != 0x2f) fail("VP8L: bad signature");
    width = static_cast<int>(br_.read(14)) + 1;
    height = static_cast<int>(br_.read(14)) + 1;
    br_.read(1);  // alpha is used: a hint
    if (br_.read(3) != 0) fail("VP8L: unknown version");
    return decode_stream(width, height, true);
  }

  int width = 0, height = 0;

 private:
  struct Group {
    PrefixCode codes[5];  // green + lengths + cache, red, blue, alpha, distance
  };
  struct Meta {
    int bits = 0, xsize = 0;  // the entropy image's tile size (0: one group) and width
    std::vector<uint32_t> image;  // group index of each tile
    std::vector<Group> groups;
  };
  struct Transform {
    int type = 0, bits = 0, xsize = 0;  // xsize: the width the inverse transform makes
    std::vector<uint32_t> data;
  };

  void check() const {
    if (br_.eos()) fail("VP8L: truncated bitstream");
  }

  // an image: transforms (the main image only), the colour cache, the prefix
  // codes, then its pixels; the main image comes back with its transforms undone
  std::vector<uint32_t> decode_stream(int xsize, int ysize, bool level0) {
    if (level0)
      while (br_.read(1)) read_transform(&xsize, ysize);
    int cache_bits = 0;
    if (br_.read(1)) {
      cache_bits = static_cast<int>(br_.read(4));
      if (cache_bits < 1 || cache_bits > 11) fail("VP8L: bad colour cache size");
    }
    Meta meta = read_codes(xsize, ysize, cache_bits, level0);
    check();
    std::vector<uint32_t> data(static_cast<size_t>(xsize) * ysize);
    decode_pixels(data, xsize, meta, cache_bits);
    if (level0) {
      for (size_t i = transforms_.size(); i-- > 0;) data = inverse(transforms_[i], data, ysize);
    }
    return data;
  }

  void read_transform(int* xsize, int ysize) {
    const int type = static_cast<int>(br_.read(2));
    if (seen_ & (1u << type)) fail("VP8L: a transform repeats");
    seen_ |= 1u << type;
    Transform t;
    t.type = type;
    t.xsize = *xsize;
    if (type == 0 || type == 1) {  // predictor, cross colour
      t.bits = static_cast<int>(br_.read(3)) + 2;
      t.data = decode_stream(subsample(*xsize, t.bits), subsample(ysize, t.bits), false);
    } else if (type == 3) {  // colour indexing
      const int num_colors = static_cast<int>(br_.read(8)) + 1;
      t.bits = num_colors > 16 ? 0 : num_colors > 4 ? 1 : num_colors > 2 ? 2 : 3;
      *xsize = subsample(t.xsize, t.bits);
      std::vector<uint32_t> colors = decode_stream(num_colors, 1, false);
      // the palette is coded as differences; indices past it read transparent black
      t.data.assign(static_cast<size_t>(1) << (8 >> t.bits), 0);
      t.data[0] = colors[0];
      for (int i = 1; i < num_colors; ++i) t.data[i] = add_pixels(colors[i], t.data[i - 1]);
    }
    check();
    transforms_.push_back(std::move(t));
  }

  // one prefix code of `alphabet` symbols; into `code`, or (unused groups)
  // only checked
  void read_code(int alphabet, PrefixCode* code) {
    std::vector<int> lengths(alphabet, 0);
    if (br_.read(1)) {  // simple: one or two symbols
      const int two = br_.read(1);
      const int first = static_cast<int>(br_.read(br_.read(1) ? 8 : 1));
      if (first < alphabet) lengths[first] = 1;
      if (two) {
        const int second = static_cast<int>(br_.read(8));
        if (second < alphabet) lengths[second] = 1;
      }
    } else {  // the code lengths, themselves prefix coded
      int cl_lengths[19] = {0};
      const int num_codes = static_cast<int>(br_.read(4)) + 4;
      for (int i = 0; i < num_codes; ++i) cl_lengths[kCodeLengthCodeOrder[i]] = br_.read(3);
      PrefixCode cl;
      if (!cl.build(cl_lengths, 19)) fail("VP8L: bad code length code");
      int max_symbol = alphabet;
      if (br_.read(1)) {
        const int nbits = 2 + 2 * static_cast<int>(br_.read(3));
        max_symbol = 2 + static_cast<int>(br_.read(nbits));
        if (max_symbol > alphabet) fail("VP8L: bad code length count");
      }
      int prev = 8;
      for (int s = 0; s < alphabet;) {
        if (max_symbol-- == 0) break;
        const int len = cl.read(br_);
        if (len < 16) {
          lengths[s++] = len;
          if (len) prev = len;
        } else {
          static const int kExtraBits[3] = {2, 3, 7}, kOffset[3] = {3, 3, 11};
          const int repeat = static_cast<int>(br_.read(kExtraBits[len - 16])) + kOffset[len - 16];
          if (s + repeat > alphabet) fail("VP8L: code lengths overrun the alphabet");
          const int value = len == 16 ? prev : 0;
          for (int i = 0; i < repeat; ++i) lengths[s++] = value;
        }
        check();
      }
    }
    check();
    PrefixCode scratch;
    if (!(code ? code : &scratch)->build(lengths.data(), alphabet)) fail("VP8L: bad prefix code");
  }

  Meta read_codes(int xsize, int ysize, int cache_bits, bool allow_meta) {
    Meta meta;
    int num_groups = 1;
    std::vector<int> mapping;  // group index -> its place in meta.groups, -1 unused
    if (allow_meta && br_.read(1)) {
      meta.bits = static_cast<int>(br_.read(3)) + 2;
      meta.xsize = subsample(xsize, meta.bits);
      meta.image = decode_stream(meta.xsize, subsample(ysize, meta.bits), false);
      for (uint32_t& p : meta.image) {
        p = (p >> 8) & 0xffff;
        num_groups = std::max<int>(num_groups, p + 1);
      }
      // the groups the image uses, numbered in order (the codes come in that order)
      mapping.assign(num_groups, -1);
      for (const uint32_t p : meta.image) mapping[p] = 0;
      int used = 0;
      for (int& m : mapping)
        if (m == 0) m = used++;
      for (uint32_t& p : meta.image) p = static_cast<uint32_t>(mapping[p]);
    }
    check();
    for (int g = 0; g < num_groups; ++g) {
      const bool used = mapping.empty() || mapping[g] >= 0;
      if (used) meta.groups.emplace_back();
      for (int j = 0; j < 5; ++j) {
        const int alphabet = kAlphabetSize[j] + (j == 0 && cache_bits ? 1 << cache_bits : 0);
        read_code(alphabet, used ? &meta.groups.back().codes[j] : nullptr);
      }
    }
    return meta;
  }

  void decode_pixels(std::vector<uint32_t>& data, int width, const Meta& meta,
                     int cache_bits) {
    const int len_limit = kNumLiteralCodes + kNumLengthCodes;
    const int cache_limit = len_limit + (cache_bits ? 1 << cache_bits : 0);
    std::vector<uint32_t> cache(cache_bits ? size_t(1) << cache_bits : 0);
    const int shift = 32 - cache_bits;
    const size_t total = data.size();
    size_t pos = 0, cached = 0;
    int x = 0, y = 0;
    auto catch_up = [&]() {  // the colour cache sees every pixel decoded so far
      if (cache_bits)
        for (; cached < pos; ++cached) cache[(0x1e35a7bdu * data[cached]) >> shift] = data[cached];
    };
    while (pos < total) {
      const Group& g =
          meta.bits ? meta.groups[meta.image[static_cast<size_t>(y >> meta.bits) * meta.xsize +
                                             (x >> meta.bits)]]
                    : meta.groups[0];
      const int code = g.codes[0].read(br_);
      if (code < kNumLiteralCodes) {
        const uint32_t red = g.codes[1].read(br_);
        const uint32_t blue = g.codes[2].read(br_);
        const uint32_t alpha = g.codes[3].read(br_);
        check();
        data[pos] = (alpha << 24) | (red << 16) | (static_cast<uint32_t>(code) << 8) | blue;
        ++pos;
        if (++x >= width) {
          x = 0;
          ++y;
        }
      } else if (code < len_limit) {  // a backward reference
        const int length = copy_value(code - kNumLiteralCodes);
        const int dist_code = copy_value(g.codes[4].read(br_));
        check();
        size_t dist;
        if (dist_code > 120) {
          dist = dist_code - 120;
        } else {
          const int c = kCodeToPlane[dist_code - 1];
          const int64_t d = static_cast<int64_t>(c >> 4) * width + (8 - (c & 0xf));
          dist = d >= 1 ? static_cast<size_t>(d) : 1;
        }
        if (pos < dist || total - pos < static_cast<size_t>(length))
          fail("VP8L: a backward reference outside the image");
        for (int i = 0; i < length; ++i, ++pos) data[pos] = data[pos - dist];
        x += length;
        while (x >= width) {
          x -= width;
          ++y;
        }
      } else if (code < cache_limit) {
        catch_up();
        data[pos] = cache[code - len_limit];
        ++pos;
        if (++x >= width) {
          x = 0;
          ++y;
        }
      } else {
        fail("VP8L: bad symbol");
      }
      check();
      catch_up();
    }
  }

  // a length or distance from its prefix symbol and extra bits
  int copy_value(int symbol) {
    if (symbol < 4) return symbol + 1;
    const int extra = (symbol - 2) >> 1;
    const int offset = (2 + (symbol & 1)) << extra;
    return offset + static_cast<int>(br_.read(extra)) + 1;
  }

  // the inverse of one transform over the whole image
  std::vector<uint32_t> inverse(const Transform& t, std::vector<uint32_t>& in, int ysize) {
    const int w = t.xsize;
    switch (t.type) {
      case 0: {  // predictor: the first row from the left, the first column from above
        uint32_t* d = in.data();
        const int tiles = subsample(w, t.bits);
        d[0] = add_pixels(d[0], 0xff000000u);
        for (int x = 1; x < w; ++x) d[x] = add_pixels(d[x], d[x - 1]);
        for (int y = 1; y < ysize; ++y) {
          uint32_t* row = d + static_cast<size_t>(y) * w;
          const uint32_t* modes = t.data.data() + static_cast<size_t>(y >> t.bits) * tiles;
          row[0] = add_pixels(row[0], row[-w]);
          for (int x = 1; x < w; ++x) {
            const int mode = (modes[x >> t.bits] >> 8) & 0xf;
            row[x] = add_pixels(row[x], predict(mode, row[x - 1], row + x - w));
          }
        }
        return std::move(in);
      }
      case 1: {  // cross colour
        const int tiles = subsample(w, t.bits);
        for (int y = 0; y < ysize; ++y) {
          uint32_t* row = in.data() + static_cast<size_t>(y) * w;
          const uint32_t* codes = t.data.data() + static_cast<size_t>(y >> t.bits) * tiles;
          for (int x = 0; x < w; ++x) {
            const uint32_t m = codes[x >> t.bits];
            const int8_t g2r = static_cast<int8_t>(m & 0xff);
            const int8_t g2b = static_cast<int8_t>((m >> 8) & 0xff);
            const int8_t r2b = static_cast<int8_t>((m >> 16) & 0xff);
            const uint32_t argb = row[x];
            const int8_t green = static_cast<int8_t>(argb >> 8);
            int red = (argb >> 16) & 0xff;
            int blue = argb & 0xff;
            red = (red + ((g2r * green) >> 5)) & 0xff;
            blue += (g2b * green) >> 5;
            blue += (r2b * static_cast<int8_t>(red)) >> 5;
            blue &= 0xff;
            row[x] = (argb & 0xff00ff00u) | (static_cast<uint32_t>(red) << 16) |
                     static_cast<uint32_t>(blue);
          }
        }
        return std::move(in);
      }
      case 2:  // subtract green
        for (uint32_t& p : in) {
          const uint32_t green = (p >> 8) & 0xff;
          const uint32_t rb = ((p & 0x00ff00ffu) + ((green << 16) | green)) & 0x00ff00ffu;
          p = (p & 0xff00ff00u) | rb;
        }
        return std::move(in);
      default: {  // colour indexing: 1, 2, 4 or 8 indices a pixel
        const int packed_w = subsample(w, t.bits);
        const int bits_per_pixel = 8 >> t.bits;
        const int count_mask = (1 << t.bits) - 1;
        const uint32_t bit_mask = (1u << bits_per_pixel) - 1;
        std::vector<uint32_t> out(static_cast<size_t>(w) * ysize);
        for (int y = 0; y < ysize; ++y) {
          const uint32_t* src = in.data() + static_cast<size_t>(y) * packed_w;
          uint32_t* dst = out.data() + static_cast<size_t>(y) * w;
          uint32_t packed = 0;
          for (int x = 0; x < w; ++x) {
            if ((x & count_mask) == 0) packed = (*src++ >> 8) & 0xff;
            dst[x] = t.data[packed & bit_mask];
            packed >>= bits_per_pixel;
          }
        }
        return out;
      }
    }
  }

  LBitReader br_;
  unsigned seen_ = 0;
  std::vector<Transform> transforms_;
};

// ================================================================== container

struct Picture {
  int canvas_w = 0, canvas_h = 0;
  int x = 0, y = 0, w = 0, h = 0;  // the frame's rectangle on the canvas
  const uint8_t* bits = nullptr;   // its bitstream: a VP8 or VP8L chunk's payload
  size_t size = 0;
  bool lossless = false;
};

// the width and height a bitstream's header gives
void bitstream_size(const uint8_t* p, size_t n, bool lossless, int* w, int* h) {
  if (lossless) {
    if (n < 5) fail("VP8L: truncated header");
    if (p[0] != 0x2f) fail("VP8L: bad signature");
    const uint32_t v = le32(p + 1);
    if (v >> 29) fail("VP8L: unknown version");
    *w = static_cast<int>(v & 0x3fff) + 1;
    *h = static_cast<int>((v >> 14) & 0x3fff) + 1;
  } else {
    if (n < 10) fail("VP8: truncated frame header");
    if (p[3] != 0x9d || p[4] != 0x01 || p[5] != 0x2a) fail("VP8: bad start code");
    *w = static_cast<int>(le16(p + 6) & 0x3fff);
    *h = static_cast<int>(le16(p + 8) & 0x3fff);
    if (*w == 0 || *h == 0) fail("VP8: zero width or height");
  }
}

// The chunks between p and end: each a fourcc, a 32-bit size and the payload,
// padded to an even size (the last one's pad byte may be missing).
class Chunks {
 public:
  Chunks(const uint8_t* p, const uint8_t* end) : p_(p), end_(end) {}
  bool next(uint32_t* tag, const uint8_t** body, size_t* size) {
    if (end_ - p_ < 8) {
      if (p_ != end_) fail("truncated chunk header");
      return false;
    }
    *tag = le32(p_);
    *size = le32(p_ + 4);
    if (*size > static_cast<size_t>(end_ - p_ - 8)) fail("truncated chunk");
    *body = p_ + 8;
    p_ = *body + std::min<size_t>(*size + (*size & 1), static_cast<size_t>(end_ - *body));
    return true;
  }

 private:
  const uint8_t* p_;
  const uint8_t* end_;
};

constexpr uint32_t fourcc(const char* s) {
  return static_cast<uint32_t>(static_cast<uint8_t>(s[0])) |
         static_cast<uint32_t>(static_cast<uint8_t>(s[1])) << 8 |
         static_cast<uint32_t>(static_cast<uint8_t>(s[2])) << 16 |
         static_cast<uint32_t>(static_cast<uint8_t>(s[3])) << 24;
}
constexpr uint32_t kVP8 = fourcc("VP8 "), kVP8L = fourcc("VP8L"), kVP8X = fourcc("VP8X");
constexpr uint32_t kANMF = fourcc("ANMF");

void check_area(int w, int h) {
  if (static_cast<int64_t>(w) * h > kMaxPixels)
    fail("image of " + std::to_string(w) + "x" + std::to_string(h) +
         " pixels exceeds the decompression-bomb limit");
}

Picture parse(const uint8_t* data, size_t size) {
  if (size < 12 || std::memcmp(data, "RIFF", 4) || std::memcmp(data + 8, "WEBP", 4))
    fail("not a WebP file");
  const uint64_t riff = le32(data + 4);
  if (riff < 12) fail("bad RIFF size");
  if (riff + 8 > size) fail("truncated file (RIFF size " + std::to_string(riff) + ")");
  Chunks chunks(data + 12, data + 8 + riff);
  Picture pic;
  uint32_t tag;
  const uint8_t* body;
  size_t n;
  if (!chunks.next(&tag, &body, &n)) fail("no image data");
  if (tag == kVP8 || tag == kVP8L) {
    pic.bits = body;
    pic.size = n;
    pic.lossless = tag == kVP8L;
    bitstream_size(body, n, pic.lossless, &pic.w, &pic.h);
    pic.canvas_w = pic.w;
    pic.canvas_h = pic.h;
    check_area(pic.w, pic.h);
    return pic;
  }
  if (tag != kVP8X) fail("unknown first chunk");
  if (n < 10) fail("truncated VP8X chunk");
  pic.canvas_w = static_cast<int>(le24(body + 4)) + 1;
  pic.canvas_h = static_cast<int>(le24(body + 7)) + 1;
  check_area(pic.canvas_w, pic.canvas_h);
  while (chunks.next(&tag, &body, &n)) {
    if (tag == kVP8 || tag == kVP8L) {  // a still image: the canvas's size
      pic.bits = body;
      pic.size = n;
      pic.lossless = tag == kVP8L;
      bitstream_size(body, n, pic.lossless, &pic.w, &pic.h);
      if (pic.w != pic.canvas_w || pic.h != pic.canvas_h)
        fail("image size differs from the canvas");
      return pic;
    }
    if (tag == kANMF) {  // the first frame: its rectangle, then its chunks
      if (n < 16) fail("truncated ANMF chunk");
      pic.x = 2 * static_cast<int>(le24(body));
      pic.y = 2 * static_cast<int>(le24(body + 3));
      pic.w = static_cast<int>(le24(body + 6)) + 1;
      pic.h = static_cast<int>(le24(body + 9)) + 1;
      if (static_cast<int64_t>(pic.x) + pic.w > pic.canvas_w ||
          static_cast<int64_t>(pic.y) + pic.h > pic.canvas_h)
        fail("animation frame outside the canvas");
      Chunks sub(body + 16, body + n);
      while (sub.next(&tag, &body, &n)) {
        if (tag != kVP8 && tag != kVP8L) continue;  // ALPH, unknown
        pic.bits = body;
        pic.size = n;
        pic.lossless = tag == kVP8L;
        int w, h;
        bitstream_size(body, n, pic.lossless, &w, &h);
        if (w != pic.w || h != pic.h) fail("frame size differs from its ANMF chunk");
        return pic;
      }
      fail("animation frame without image data");
    }
    // ICCP, ANIM, EXIF, XMP, ALPH and unknown chunks: skipped
  }
  fail("no image data");
}

void set_error(char* err, int errlen, const std::string& msg) {
  if (err && errlen > 0) std::snprintf(err, static_cast<size_t>(errlen), "%s", msg.c_str());
}

}  // namespace

extern "C" {

// out: canvas height, width
int webp_info(const uint8_t* data, int64_t size, int* out, char* err, int errlen) {
  try {
    const Picture pic = parse(data, static_cast<size_t>(size));
    out[0] = pic.canvas_h;
    out[1] = pic.canvas_w;
  } catch (const Error& e) {
    set_error(err, errlen, e.msg);
    return 1;
  }
  return 0;
}

// out: uint8 [height, width, 3] as webp_info gives them
int webp_decode(const uint8_t* data, int64_t size, uint8_t* out, char* err, int errlen) {
  try {
    const Picture pic = parse(data, static_cast<size_t>(size));
    const size_t stride = 3 * static_cast<size_t>(pic.canvas_w);
    if (pic.w != pic.canvas_w || pic.h != pic.canvas_h)
      std::memset(out, 0, stride * pic.canvas_h);
    uint8_t* dst = out + pic.y * stride + 3 * static_cast<size_t>(pic.x);
    if (pic.lossless) {
      VP8LDecoder d(pic.bits, pic.size);
      const std::vector<uint32_t> argb = d.decode();
      for (int y = 0; y < pic.h; ++y) {
        const uint32_t* src = argb.data() + static_cast<size_t>(y) * pic.w;
        uint8_t* row = dst + y * stride;
        for (int x = 0; x < pic.w; ++x) {
          row[3 * x] = static_cast<uint8_t>(src[x] >> 16);
          row[3 * x + 1] = static_cast<uint8_t>(src[x] >> 8);
          row[3 * x + 2] = static_cast<uint8_t>(src[x]);
        }
      }
    } else {
      VP8Decoder d(pic.bits, pic.size);
      d.decode();
      d.to_rgb(dst, stride);
    }
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
