// The pixel-observation painter: one launch paints every view (one per car)
// of E envs into (E, N, 96, 96, 3) uint8, channels last.
//
// Replaces the TPU kernel multi_car_racing_tpu/render/pallas_raster.py ::
// _make_kernel / _paint_view (pallas_call :638, from render_pixels :587).
// The arithmetic follows the plain PyTorch version,
// multi_car_racing_tpu_torch/render/pixels.py :: paint_views_plain, operation
// by operation, over the same inputs: the per-view slot tables of
// view_inputs and, for a view in the first-second zoom-out ("warm"), its
// env's own track tables.
//
// Per pixel, in paint order (later slots overwrite earlier ones, so a pixel
// needs nothing from any other pixel): the background (inverse camera to
// world, grass and checker inside the playfield, white outside); the road --
// in steady state the compacted windowed tile/curb slots, for a warm view the
// env's whole track in world space, tile i then its curb, vertex form with
// both signs; per car its 4 (wheel, marker) quads then its 4 hull polygons;
// the 8 HUD rects; the 4 score glyphs; the backwards-flag triangle last (the
// reference paints it after the HUD, mcr:668-674). The palette index stays in
// a register and is expanded to RGB at the store.
//
// What bounds it (render/pixels.py :: paint_work, at the H100's 3.35 TB/s
// and 67 fp32 TFLOP/s). The output is 27,648 B per view (226 MB at
// E = 4096, N = 2) and the slot tables ~7.5 KB per view at N = 2: ~0.086 ms
// of bytes for a steady frame; a frame of warm views also reads each env's
// track once, ~0.118 ms. The operations a painter needs -- the background's
// 12 per pixel and one edge test (4 operations) per pixel inside each
// polygon's bounding box -- are ~1e9 a frame, ~0.015 ms: bytes bound both.
// A painter that tests every slot at every pixel does far more: a warm view
// has 768 world quads (tile and curb of each of MT = 384 padded tiles), a
// steady one up to 80 road slots and 12 car slots per car, and any one pixel
// lies in a handful of them.
//
// What the design does about it. One block of 384 threads (12 warps) per
// view; the view's slot tables (and, for a warm view, the edge coefficients
// of its env's track, computed once per tile) sit in shared memory and are
// read as broadcasts. Two passes, split by one __syncthreads:
//  1. Bin. The view is cut into 36 patches of 16 x 16 pixels, each binned by
//     one warp (patch w, w + 12, w + 24): lane i tests slot 32c + i against
//     the patch and __ballot_sync gives one candidate word per 32 slots,
//     stored in shared memory -- words for the road (steady: the nq compacted
//     slots; warm: 2 MT interleaved tile and curb quads, bit 2t tile t, bit
//     2t + 1 its curb), words for the cars (bit 12c + i: car c's quad slot
//     8c + i for i < 8, its hull slot 4c + i - 8 after) and a flag word.
//  2. Paint. Each patch's four 8 x 8 quadrants ("cells", 144 per view) go to
//     four different warps (cell 4p + i to warp (4p + i) mod 12), a lane
//     holding one column and 2 rows of a cell. Per word of its patch's
//     candidates the warp tests the set bits against the cell (one more
//     ballot), then runs the exact per-pixel test only on the bits left,
//     taken in ascending order with __ffs: paint order holds by
//     construction, with no sort and no atomics, and the candidate loop is
//     warp-uniform.
// Binning at 16 x 16 keeps a warm view's 768-quad pass to 36 per view;
// painting at 8 x 8 quarters the per-pixel tests near the track, spreads a
// patch that crosses the whole track over four warps, and gives each warp
// two of the bottom band's HUD cells. The HUD rects and score glyphs are
// culled per cell by their own comparisons at the cell's extreme rows and
// columns (exact: the pixel centre is monotone in the row and column).
// Warm and steady views branch per view inside the one launch (a template per
// branch, so each keeps only its own registers): no partition, no cap, no
// host read. The TPU's 32-row bands, its 128-lane padding and its 8 views
// per program are not carried over.
//
// The reject is conservative, derived from the edge functions. An edge value
// f = c2*y - c1*x + k0 is affine, so over a box of centre (cx, cy) and
// half-extents (hx, hy) it lies within f(cx, cy) +- (|c1| hx + |c2| hy).
// A square's (a patch's or a cell's) pixel centres lie in such a box: in
// window coordinates the box of its extreme pixel centres (computed by the
// same code as every pixel centre; rounding is monotone, so every pixel
// centre lies between them); in a warm view's world coordinates the box
// spanned by the four corners' computed (gx, gy), up to 2 delta: each
// pixel's computed (gx, gy) lies within delta <= 4u D of the exact affine
// image of its window centre, where u = 2^-24 and D = max over the corners
// of (|dx| + |dy|) / zoom; that image lies in the parallelogram of the
// corners' exact images, each within delta of its computed corner. With A =
// |c1| + |c2|, G = max(|x|, |y|) over the corners and T = |c2 y| + |c1 x| +
// |k0| <= A G + |k0|: the box's centre and half-extents, f at the centre and
// the extent term, each rounded per operation, bound f over the box to
// within 4u T + 5u A G; the per-pixel test itself is within 3u T of its
// exact value; the 2 delta displacement adds 8u A D. So the value the
// painter computes at any pixel of the square is within
// 16u (A (G + D) + |k0|) of the range the computed bound gives. The margin
//   m = 2^-16 (A S + |k0|),
// S = G (window coordinates: the slots, car slots of a warm view included)
// or G + D (a warm view's world quads), covers that by a factor of 16
// (2^-16 = 256u): an edge whose bound lies below -m is negative at every
// pixel of the square. A sign-folded slot (every edge >= 0 paints) is
// rejected when one edge is; a world quad of either winding (all >= 0 or all
// <= 0 paints) only when one edge lies below -m and another above +m. A slot
// that is inactive, or whose band start lies below the square's last row,
// is rejected too. A degenerate edge (the flag triangle repeats a vertex:
// c1 = c2 = k0 = 0) has m = 0 and a bound of 0, and is never rejected; a NaN
// fails every comparison and rejects nothing. m is itself computed with one
// rounding per operation, as render/pixels.py :: paint_candidates computes
// it (the tests hold that plain predicate against the plain painter's
// coverage). The decision for a pixel stays with the unchanged per-pixel
// test, so no output byte can move.
//
// Exact pixels. Every product, sum and quotient that decides a pixel -- the
// pixel centres, the inverse camera, the checker's floor(g / k), the edge
// tests, the warm branch's coefficients and tests, the glyph cells -- is
// written with __fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn in the plain
// version's order: nvcc -O3 would otherwise contract c2*y - c1*x + k0 into
// FMAs, which eager PyTorch never does, and a pixel centre within an ulp of
// an edge could flip.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC (multi_car_racing_tpu_torch/_cuda.py); plain C interface
// loaded with ctypes. Bool tensors cross as their uint8 bytes.

#include <cuda_runtime.h>

namespace {

constexpr int kH = 96, kW = 96;
constexpr int kThreads = 384;
constexpr int kWarps = kThreads / 32;
constexpr int kPatch = 16;                       // binned square, pixels
constexpr int kPatchCols = kW / kPatch;
constexpr int kPatches = kPatchCols * (kH / kPatch);
constexpr int kCell = kPatch / 2;                // painted square: a patch's quadrant
constexpr int kCells = 4 * kPatches;
constexpr int kPix = kCell * kCell / 32;         // pixels per lane per cell
constexpr int kRowStep = 32 / kCell;             // rows between a lane's pixels
constexpr float kCullRel = 1.52587890625e-05f;   // 2^-16
constexpr int kQW = 16, kPW = 28;        // slot row widths: 4 and 8 edges
constexpr int kRects = 8, kRectW = 8;
constexpr int kGlyphs = 4, kGlyphW = 8;
constexpr int kWarmW = 26;               // staged warm tile: 2 x 12 coefficients, 2 palettes
constexpr int kMaxSmem = 227 * 1024;
constexpr unsigned kFull = 0xffffffffu;
// Palette indices (render/raster.py PAL_*).
constexpr int kWhite = 0, kGrassDark = 1, kGrassLight = 2, kRoad0 = 3, kRed = 6;
// Score glyphs (render/geometry.py SCORE_*): cells of 20 x 36 window units
// at x = 20 + 24 i, top at SCORE_Y + SCORE_DIGIT_H / 2 = 68; 5 x 7 bits.
constexpr float kScoreX = 20.0f, kScoreSpacing = 24.0f, kScoreTop = 68.0f;
constexpr float kDigitW = 20.0f, kDigitH = 36.0f;
constexpr int kScoreRow0 = kH - 16;

// c2*y - c1*x + k0 with each operation rounded on its own.
__device__ __forceinline__ float edge(const float* c, float x, float y) {
  return __fadd_rn(__fsub_rn(__fmul_rn(c[1], y), __fmul_rn(c[0], x)), c[2]);
}

// A slot row [c1, c2, k0] x NE, palette, active, band start, 0: paints idx
// where the slot is active, the row is at or below its band start and every
// (sign-folded) edge test holds.
template <int NE>
__device__ __forceinline__ void paint_slot(const float* s, float wx, float wy, float row,
                                           int& idx) {
  if (!(s[3 * NE + 1] > 0.0f) || row < s[3 * NE + 2]) return;
#pragma unroll
  for (int e = 0; e < NE; ++e)
    if (!(edge(s + 3 * e, wx, wy) >= 0.0f)) return;
  idx = static_cast<int>(s[3 * NE]);
}

// A world-space quad of either winding (the JAX warm branch): covered when
// every edge value is >= 0 or every one is <= 0.
__device__ __forceinline__ bool world_cover(const float* c, float gx, float gy) {
  bool pos = true, neg = true;
#pragma unroll
  for (int v = 0; v < 4; ++v) {
    const float cr = edge(c + 3 * v, gx, gy);
    pos = pos && cr >= 0.0f;
    neg = neg && cr <= 0.0f;
    if (!pos && !neg) return false;
  }
  return true;
}

// [c1, c2, k0] per edge of a world quad (4 vertices, x y interleaved), in
// the plain version's order: c1 = by - ay, c2 = bx - ax, k0 = c1*ax - c2*ay.
__device__ __forceinline__ void world_coefs(const float* q, float* c) {
#pragma unroll
  for (int v = 0; v < 4; ++v) {
    const int w = (v + 1) & 3;
    const float ax = q[2 * v], ay = q[2 * v + 1], bx = q[2 * w], by = q[2 * w + 1];
    const float c1 = __fsub_rn(by, ay), c2 = __fsub_rn(bx, ax);
    c[3 * v] = c1;
    c[3 * v + 1] = c2;
    c[3 * v + 2] = __fsub_rn(__fmul_rn(c1, ax), __fmul_rn(c2, ay));
  }
}

struct Camera {
  float ca, sa, tx, ty, inv_zoom;
};

__device__ __forceinline__ float pixel_wx(int col, float wx_scale) {
  return __fmul_rn(__fadd_rn(static_cast<float>(col), 0.5f), wx_scale);
}

__device__ __forceinline__ float pixel_wy(int row, float wy_scale) {
  return __fmul_rn(__fsub_rn(static_cast<float>(kH) - 0.5f, static_cast<float>(row)),
                   wy_scale);
}

// Inverse camera: window (wx, wy) -> world (gx, gy), and (|dx| + |dy|) / zoom.
__device__ __forceinline__ void to_world(const Camera& c, float wx, float wy, float& gx,
                                         float& gy, float& d) {
  const float dx = __fsub_rn(wx, c.tx), dy = __fsub_rn(wy, c.ty);
  gx = __fmul_rn(__fadd_rn(__fmul_rn(c.ca, dx), __fmul_rn(c.sa, dy)), c.inv_zoom);
  gy = __fmul_rn(__fadd_rn(__fmul_rn(-c.sa, dx), __fmul_rn(c.ca, dy)), c.inv_zoom);
  d = __fmul_rn(__fadd_rn(fabsf(dx), fabsf(dy)), c.inv_zoom);
}

// A square of pixels (a patch or a cell, first row r0, first column c0):
// the extreme pixel centres in window coordinates (wx rises with the column,
// wy falls with the row: wx0 <= wx3, wy3 <= wy0), the box they span (centre,
// half-extents) with the margin's scale sw = max(|wx|, |wy|) over the
// corners, for the slots; the box the road is tested in (the window box in a
// steady view; in a warm one the box spanned by the corners' world (gx, gy),
// with s = max(|gx|, |gy|) + D over the corners); and the last row.
struct Square {
  float wx0, wx3, wy0, wy3;
  float wcx, wcy, whx, why, sw;
  float cx, cy, hx, hy, s;
  float last_row;
};

__device__ __forceinline__ float mid(float lo, float hi) {
  return __fmul_rn(__fadd_rn(lo, hi), 0.5f);
}

__device__ __forceinline__ float half(float lo, float hi) {
  return __fmul_rn(__fsub_rn(hi, lo), 0.5f);
}

__device__ __forceinline__ Square square_box(int r0, int c0, int size, bool warm,
                                             const Camera& cam, float wx_scale,
                                             float wy_scale) {
  Square k;
  k.wx0 = pixel_wx(c0, wx_scale);
  k.wx3 = pixel_wx(c0 + size - 1, wx_scale);
  k.wy0 = pixel_wy(r0, wy_scale);
  k.wy3 = pixel_wy(r0 + size - 1, wy_scale);
  k.wcx = mid(k.wx0, k.wx3);
  k.whx = half(k.wx0, k.wx3);
  k.wcy = mid(k.wy3, k.wy0);
  k.why = half(k.wy3, k.wy0);
  k.sw = fmaxf(fmaxf(fabsf(k.wx0), fabsf(k.wx3)), fmaxf(fabsf(k.wy0), fabsf(k.wy3)));
  k.last_row = static_cast<float>(r0 + size - 1);
  if (!warm) {
    k.cx = k.wcx, k.cy = k.wcy, k.hx = k.whx, k.hy = k.why, k.s = k.sw;
    return k;
  }
  float xlo = 0.0f, xhi = 0.0f, ylo = 0.0f, yhi = 0.0f, g = 0.0f, d = 0.0f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float gx, gy, di;
    to_world(cam, (i & 1) ? k.wx3 : k.wx0, (i >> 1) ? k.wy3 : k.wy0, gx, gy, di);
    xlo = i ? fminf(xlo, gx) : gx;
    xhi = i ? fmaxf(xhi, gx) : gx;
    ylo = i ? fminf(ylo, gy) : gy;
    yhi = i ? fmaxf(yhi, gy) : gy;
    g = fmaxf(g, fmaxf(fabsf(gx), fabsf(gy)));
    d = fmaxf(d, di);
  }
  k.cx = mid(xlo, xhi);
  k.hx = half(xlo, xhi);
  k.cy = mid(ylo, yhi);
  k.hy = half(ylo, yhi);
  k.s = __fadd_rn(g, d);
  return k;
}

// Whether the edge's value lies below -m (below) or above +m (above) over
// the whole box (centre cx, cy, half-extents hx, hy):
// f(cx, cy) + |c1| hx + |c2| hy < -m, or f(cx, cy) - |c1| hx - |c2| hy > m,
// with m = 2^-16 ((|c1| + |c2|) s + |k0|).
__device__ __forceinline__ void edge_sides(const float* c, float cx, float cy, float hx,
                                           float hy, float s, bool& below, bool& above) {
  const float a1 = fabsf(c[0]), a2 = fabsf(c[1]);
  const float m = __fmul_rn(__fadd_rn(__fmul_rn(__fadd_rn(a1, a2), s), fabsf(c[2])), kCullRel);
  const float v = edge(c, cx, cy);
  const float e = __fadd_rn(__fmul_rn(a1, hx), __fmul_rn(a2, hy));
  below = __fadd_rn(v, e) < -m;
  above = __fsub_rn(v, e) > m;
}

// Whether a sign-folded slot may paint a pixel of the square: active, the
// square's last row at or below its band start, no edge below -m over the
// window box.
template <int NE>
__device__ __forceinline__ bool slot_candidate(const float* s, const Square& k) {
  if (!(s[3 * NE + 1] > 0.0f) || !(k.last_row >= s[3 * NE + 2])) return false;
#pragma unroll
  for (int e = 0; e < NE; ++e) {
    bool below, above;
    edge_sides(s + 3 * e, k.wcx, k.wcy, k.whx, k.why, k.sw, below, above);
    if (below) return false;
  }
  return true;
}

// Whether a world quad of either winding may cover a pixel of the square: not
// both an edge below -m and an edge above +m over the road box.
__device__ __forceinline__ bool world_candidate(const float* c, const Square& k) {
  bool any_below = false, any_above = false;
#pragma unroll
  for (int v = 0; v < 4; ++v) {
    bool below, above;
    edge_sides(c + 3 * v, k.cx, k.cy, k.hx, k.hy, k.s, below, above);
    any_below = any_below || below;
    any_above = any_above || above;
  }
  return !(any_below && any_above);
}

// The view's tables in shared memory.
struct View {
  const float* quad_s;   // sq x kQW: steady road slots
  const float* q4_s;     // 8 n_cars x kQW
  const float* p8_s;     // s8 x kPW
  const float* rect_s;   // kRects x kRectW
  const int* score_s;    // kGlyphs x kGlyphW
  const int* pal_s;      // npal packed RGB
  const float* warm_s;   // mt x kWarmW: a warm view's world quads
  unsigned* mask_s;      // kPatches x (road_words + car_words + 1): candidate bits
  int n_cars, nq, mt, npal, road_words, car_words;
  bool flag;
};

// Road bit q: a steady view's slot q, a warm view's tile q / 2 (q even) or
// its curb; the world quad's palette is -1 where it is not painted.
template <bool kWarm>
__device__ __forceinline__ bool road_candidate(const View& V, int q, const Square& k) {
  if (kWarm) {
    const float* t = V.warm_s + (q >> 1) * kWarmW;
    return reinterpret_cast<const int*>(t)[24 + (q & 1)] >= 0 &&
           world_candidate(t + 12 * (q & 1), k);
  }
  return slot_candidate<4>(V.quad_s + q * kQW, k);
}

// Car bit b = 12 car + i: (wheel, marker) slot 8 car + i for i < 8, then
// hull slot 4 car + i - 8.
__device__ __forceinline__ bool car_candidate(const View& V, int b, const Square& k) {
  const int car = b / 12, i = b - 12 * car;
  return i < 8 ? slot_candidate<4>(V.q4_s + (8 * car + i) * kQW, k)
               : slot_candidate<8>(V.p8_s + (4 * car + i - 8) * kPW, k);
}

// Bins a patch: lane i tests bit 32 w + i, one __ballot_sync per word, lane 0
// stores the word.
template <bool kWarm>
__device__ __forceinline__ void bin_patch(const View& V, int p, int lane, const Camera& cam,
                                          float wx_scale, float wy_scale) {
  const Square k = square_box((p / kPatchCols) * kPatch, (p % kPatchCols) * kPatch, kPatch,
                                  kWarm, cam, wx_scale, wy_scale);
  unsigned* m = V.mask_s + p * (V.road_words + V.car_words + 1);
  const int nroad = kWarm ? 2 * V.mt : V.nq, ncar = 12 * V.n_cars;
  for (int w = 0; w * 32 < nroad; ++w) {
    const int q = 32 * w + lane;
    const unsigned bits = __ballot_sync(kFull, q < nroad && road_candidate<kWarm>(V, q, k));
    if (lane == 0) m[w] = bits;
  }
  for (int w = 0; w * 32 < ncar; ++w) {
    const int b = 32 * w + lane;
    const unsigned bits = __ballot_sync(kFull, b < ncar && car_candidate(V, b, k));
    if (lane == 0) m[V.road_words + w] = bits;
  }
  if (lane == 0)
    m[V.road_words + V.car_words] = V.flag && slot_candidate<8>(V.p8_s + 4 * V.n_cars * kPW, k);
}

// Paints a cell: the background per pixel; the road and the cars over the
// patch's candidate bits that also pass the cell's own test, word by word in
// ascending order; the HUD rects and glyphs that may reach the cell; the flag.
template <bool kWarm>
__device__ __forceinline__ void paint_cell(const View& V, const unsigned* m, int r0, int c0,
                                           int lane, const Camera& cam, float wx_scale,
                                           float wy_scale, float playfield, float checker_k,
                                           unsigned char* dst) {
  const Square k = square_box(r0, c0, kCell, kWarm, cam, wx_scale, wy_scale);
  const int col = c0 + lane % kCell;
  const int rlane = r0 + lane / kCell;         // this lane's rows: rlane + kRowStep j
  const float wx = pixel_wx(col, wx_scale);

  // Background: inverse camera to world; grass, lighter checker, white.
  int idx[kPix];
  float gxs[kPix], gys[kPix];
#pragma unroll
  for (int j = 0; j < kPix; ++j) {
    const float wy = pixel_wy(rlane + kRowStep * j, wy_scale);
    float gx, gy, d;
    to_world(cam, wx, wy, gx, gy, d);
    const float ix = floorf(__fdiv_rn(gx, checker_k));
    const float iy = floorf(__fdiv_rn(gy, checker_k));
    const bool infield = fabsf(gx) <= playfield && fabsf(gy) <= playfield;
    // floor(g/k) is integral: within [-20, 20) the int's low bit is its parity.
    const bool lighter = ix >= -20.0f && ix < 20.0f && iy >= -20.0f && iy < 20.0f &&
                         (static_cast<int>(ix) & 1) == 0 && (static_cast<int>(iy) & 1) == 0;
    idx[j] = infield ? (lighter ? kGrassLight : kGrassDark) : kWhite;
    gxs[j] = gx;
    gys[j] = gy;
  }

  // Road and curbs, then the cars in id order.
  const int nroad = kWarm ? 2 * V.mt : V.nq, ncar = 12 * V.n_cars;
  for (int w = 0; w * 32 < nroad; ++w) {
    const unsigned patch_bits = m[w];
    if (!patch_bits) continue;
    const int q = 32 * w + lane;
    unsigned bits = __ballot_sync(kFull, ((patch_bits >> lane) & 1) &&
                                             road_candidate<kWarm>(V, q, k));
    for (; bits; bits &= bits - 1) {
      const int t = 32 * w + __ffs(bits) - 1;
      if (kWarm) {
        const float* tile = V.warm_s + (t >> 1) * kWarmW;
        const int pal = reinterpret_cast<const int*>(tile)[24 + (t & 1)];
        const float* c = tile + 12 * (t & 1);
#pragma unroll
        for (int j = 0; j < kPix; ++j)
          if (world_cover(c, gxs[j], gys[j])) idx[j] = pal;
      } else {
        const float* s = V.quad_s + t * kQW;
#pragma unroll
        for (int j = 0; j < kPix; ++j) {
          const int r = rlane + kRowStep * j;
          paint_slot<4>(s, wx, pixel_wy(r, wy_scale), static_cast<float>(r), idx[j]);
        }
      }
    }
  }
  for (int w = 0; w * 32 < ncar; ++w) {
    const unsigned patch_bits = m[V.road_words + w];
    if (!patch_bits) continue;
    unsigned bits = __ballot_sync(kFull, ((patch_bits >> lane) & 1) &&
                                             car_candidate(V, 32 * w + lane, k));
    for (; bits; bits &= bits - 1) {
      const int b = 32 * w + __ffs(bits) - 1;
      const int car = b / 12, i = b - 12 * car;
#pragma unroll
      for (int j = 0; j < kPix; ++j) {
        const int r = rlane + kRowStep * j;
        const float wy = pixel_wy(r, wy_scale), row = static_cast<float>(r);
        if (i < 8)
          paint_slot<4>(V.q4_s + (8 * car + i) * kQW, wx, wy, row, idx[j]);
        else
          paint_slot<8>(V.p8_s + (4 * car + i - 8) * kPW, wx, wy, row, idx[j]);
      }
    }
  }

  // HUD rects and score glyphs that may hold a pixel of the cell: the pixel
  // tests' own comparisons at the cell's extreme rows and columns (wx rises
  // with the column, wy falls with the row, and the glyph cell's row and
  // column are monotone in them), so these rejects are exact.
  unsigned rects = 0, glyphs = 0;
#pragma unroll
  for (int t = 0; t < kRects; ++t) {
    const float* q = V.rect_s + t * kRectW;
    if (k.last_row >= q[6] && k.wx3 >= q[0] && k.wx0 <= q[1] && k.wy0 >= q[2] &&
        k.wy3 <= q[3])
      rects |= 1u << t;
  }
  if (r0 + kCell - 1 >= kScoreRow0) {
#pragma unroll
    for (int i = 0; i < kGlyphs; ++i) {
      const float x0 = kScoreX + static_cast<float>(i) * kScoreSpacing;
      const float lo = floorf(__fmul_rn(__fdiv_rn(__fsub_rn(k.wx0, x0), kDigitW), 5.0f));
      const float hi = floorf(__fmul_rn(__fdiv_rn(__fsub_rn(k.wx3, x0), kDigitW), 5.0f));
      if (hi >= 0.0f && lo < 5.0f) glyphs |= 1u << i;
    }
  }
  const float* flag_s = V.p8_s + 4 * V.n_cars * kPW;
  const bool flag = m[V.road_words + V.car_words] && slot_candidate<8>(flag_s, k);

#pragma unroll
  for (int j = 0; j < kPix; ++j) {
    const int r = rlane + kRowStep * j;
    const float row = static_cast<float>(r);
    const float wy = pixel_wy(r, wy_scale);

    // HUD rects: xa, xb, ya, yb, palette, 1, band start.
    for (unsigned bits = rects; bits; bits &= bits - 1) {
      const float* q = V.rect_s + (__ffs(bits) - 1) * kRectW;
      if (row >= q[6] && wx >= q[0] && wx <= q[1] && wy >= q[2] && wy <= q[3])
        idx[j] = static_cast<int>(q[4]);
    }

    // Score glyphs ("%04i", 5 x 7 bits per row).
    if (glyphs && r >= kScoreRow0) {
      const float grow = floorf(__fmul_rn(__fdiv_rn(__fsub_rn(kScoreTop, wy), kDigitH), 7.0f));
      if (grow >= 0.0f && grow < 7.0f) {
        for (unsigned bits = glyphs; bits; bits &= bits - 1) {
          const int i = __ffs(bits) - 1;
          const float x0 = kScoreX + static_cast<float>(i) * kScoreSpacing;
          const float gcol = floorf(__fmul_rn(__fdiv_rn(__fsub_rn(wx, x0), kDigitW), 5.0f));
          if (gcol >= 0.0f && gcol < 5.0f) {
            const int gbits = V.score_s[i * kGlyphW + static_cast<int>(grow)];
            if ((gbits >> (4 - static_cast<int>(gcol))) & 1) idx[j] = kWhite;
          }
        }
      }
    }

    // The backwards flag, last.
    if (flag) paint_slot<8>(flag_s, wx, wy, row, idx[j]);

    const int p = idx[j];
    const int rgb = V.pal_s[static_cast<unsigned>(p) < static_cast<unsigned>(V.npal) ? p : 0];
    unsigned char* o = dst + (r * kW + col) * 3;
    o[0] = static_cast<unsigned char>(rgb & 0xff);
    o[1] = static_cast<unsigned char>((rgb >> 8) & 0xff);
    o[2] = static_cast<unsigned char>((rgb >> 16) & 0xff);
  }
}

// Candidate words per patch: road, cars, flag.
__host__ __device__ inline int road_words(int sq, int mt) {
  return ((sq > 2 * mt ? sq : 2 * mt) + 31) / 32;
}
__host__ __device__ inline int car_words(int s4) { return (12 * (s4 / 8) + 31) / 32; }

struct Layout {            // word offsets into the dynamic shared memory
  int quads, q4, p8, rects, score, pal, masks, warm, words;
};

__host__ __device__ inline Layout layout(int sq, int s4, int s8, int npal, int mt) {
  Layout L;
  L.quads = 8;
  L.q4 = L.quads + sq * kQW;
  L.p8 = L.q4 + s4 * kQW;
  L.rects = L.p8 + s8 * kPW;
  L.score = L.rects + kRects * kRectW;
  L.pal = L.score + kGlyphs * kGlyphW;
  L.masks = L.pal + npal;
  L.warm = L.masks + kPatches * (road_words(sq, mt) + car_words(s4) + 1);
  L.words = L.warm + mt * kWarmW;
  return L;
}

template <bool kWarm>
__device__ __forceinline__ void paint_view(const View& V, const Camera& cam, int tid,
                                           float wx_scale, float wy_scale, float playfield,
                                           float checker_k, unsigned char* dst) {
  const int warp = tid >> 5, lane = tid & 31;
  for (int p = warp; p < kPatches; p += kWarps)
    bin_patch<kWarm>(V, p, lane, cam, wx_scale, wy_scale);
  __syncthreads();
  // Cell 4 p + i is quadrant i of patch p: a patch's four cells go to four
  // warps, and the bottom band's 24 cells (HUD and glyphs) two to each warp.
  const int mw = V.road_words + V.car_words + 1;
  for (int cell = warp; cell < kCells; cell += kWarps) {
    const int p = cell >> 2, i = cell & 3;
    paint_cell<kWarm>(V, V.mask_s + p * mw, (p / kPatchCols) * kPatch + (i >> 1) * kCell,
                      (p % kPatchCols) * kPatch + (i & 1) * kCell, lane, cam, wx_scale,
                      wy_scale, playfield, checker_k, dst);
  }
}

__global__ void __launch_bounds__(kThreads, 3)
paint_view_kernel(const float* __restrict__ cam, const float* __restrict__ quads,
                  const float* __restrict__ q4, const float* __restrict__ p8,
                  const float* __restrict__ rects, const int* __restrict__ score,
                  const float* __restrict__ quad, const float* __restrict__ curb_quad,
                  const unsigned char* __restrict__ touched,
                  const unsigned char* __restrict__ curb_red,
                  const unsigned char* __restrict__ valid,
                  const unsigned char* __restrict__ has_curb,
                  const unsigned char* __restrict__ palette, unsigned char* __restrict__ out,
                  int n_cars, int sq, int s4, int s8, int mt, int npal, float wx_scale,
                  float wy_scale, float playfield, float checker_k) {
  extern __shared__ float smem[];
  const Layout L = layout(sq, s4, s8, npal, mt);
  const int v = blockIdx.x;
  const int e = v / n_cars;
  const int tid = threadIdx.x;
  const size_t vs = static_cast<size_t>(v);

  // The view's tables into shared memory.
  for (int i = tid; i < 8; i += kThreads) smem[i] = cam[vs * 8 + i];
  for (int i = tid; i < sq * kQW; i += kThreads) smem[L.quads + i] = quads[vs * sq * kQW + i];
  for (int i = tid; i < s4 * kQW; i += kThreads) smem[L.q4 + i] = q4[vs * s4 * kQW + i];
  for (int i = tid; i < s8 * kPW; i += kThreads) smem[L.p8 + i] = p8[vs * s8 * kPW + i];
  for (int i = tid; i < kRects * kRectW; i += kThreads)
    smem[L.rects + i] = rects[vs * kRects * kRectW + i];
  int* score_s = reinterpret_cast<int*>(smem + L.score);
  for (int i = tid; i < kGlyphs * kGlyphW; i += kThreads)
    score_s[i] = score[vs * kGlyphs * kGlyphW + i];
  int* pal_s = reinterpret_cast<int*>(smem + L.pal);
  for (int i = tid; i < npal; i += kThreads)
    pal_s[i] = palette[3 * i] | (palette[3 * i + 1] << 8) | (palette[3 * i + 2] << 16);
  __syncthreads();

  const Camera c{smem[0], smem[1], smem[2], smem[3], smem[4]};
  const bool warm = smem[5] > 0.0f;

  // A warm view stages its env's track: per tile the edge coefficients of
  // the road and curb quads and their palettes (-1: not painted).
  float* warm_s = smem + L.warm;
  if (warm) {
    const size_t et = static_cast<size_t>(e) * mt;
    for (int t = tid; t < mt; t += kThreads) {
      float* w = warm_s + t * kWarmW;
      world_coefs(quad + (et + t) * 8, w);
      world_coefs(curb_quad + (et + t) * 8, w + 12);
      const int tile_pal = touched[et + t] ? kRoad0 : kRoad0 + t % 3;
      reinterpret_cast<int*>(w)[24] = valid[et + t] ? tile_pal : -1;
      reinterpret_cast<int*>(w)[25] = has_curb[et + t] ? (curb_red[et + t] ? kRed : kWhite) : -1;
    }
    __syncthreads();
  }

  const View view{smem + L.quads, smem + L.q4, smem + L.p8, smem + L.rects, score_s, pal_s,
                  warm_s, reinterpret_cast<unsigned*>(smem + L.masks), n_cars,
                  static_cast<int>(smem[6]), mt, npal, road_words(sq, mt), car_words(s4),
                  s8 > 4 * n_cars};
  unsigned char* dst = out + vs * (kH * kW * 3);
  if (warm)
    paint_view<true>(view, c, tid, wx_scale, wy_scale, playfield, checker_k, dst);
  else
    paint_view<false>(view, c, tid, wx_scale, wy_scale, playfield, checker_k, dst);
}

}  // namespace

extern "C" {

// Launches the painter on `stream` for E envs of n_cars views each: sq
// windowed quad slots, s8 (4 n_cars, or 4 n_cars + 1 with the flag) 8-edge
// slots, mt padded tiles, npal palette colours. Any n_cars whose view tables
// fit a block's shared memory (layout: ~1 KB a car; at sq = 80, mt = 384
// and 21 colours up to 180 cars, render/pixels.py :: max_paint_cars).
// Returns cudaGetLastError() after the launch (0 on success,
// cudaErrorInvalidValue for shapes it does not take or tables that do not
// fit its shared memory); does not synchronise.
int paint_view_launch(const float* cam, const float* quads, const float* q4, const float* p8,
                      const float* rects, const int* score, const float* quad,
                      const float* curb_quad, const unsigned char* touched,
                      const unsigned char* curb_red, const unsigned char* valid,
                      const unsigned char* has_curb, const unsigned char* palette,
                      unsigned char* out, int num_envs, int n_cars, int sq, int s8, int mt,
                      int npal, float wx_scale, float wy_scale, float playfield,
                      float checker_k, void* stream) {
  if (n_cars < 1 || sq < 0 || mt < 0 || npal < 1 ||
      (s8 != 4 * n_cars && s8 != 4 * n_cars + 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int s4 = 8 * n_cars;
  const size_t bytes = sizeof(float) * static_cast<size_t>(layout(sq, s4, s8, npal, mt).words);
  if (bytes > static_cast<size_t>(kMaxSmem)) return static_cast<int>(cudaErrorInvalidValue);
  if (num_envs <= 0) return 0;
  if (bytes > 48 * 1024) {    // above 48 KB only by opting in (per device)
    const cudaError_t err = cudaFuncSetAttribute(
        paint_view_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  paint_view_kernel<<<num_envs * n_cars, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      cam, quads, q4, p8, rects, score, quad, curb_quad, touched, curb_red, valid, has_curb,
      palette, out, n_cars, sq, s4, s8, mt, npal, wx_scale, wy_scale, playfield, checker_k);
  return static_cast<int>(cudaGetLastError());
}

const char* paint_view_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
