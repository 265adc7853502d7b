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
// This kernel does far more: it tests every slot on every row from its band
// start down, and a warm view every world quad of its env at every pixel.
//
// What the design does about it. One block of 384 threads per view; the
// view's slot tables (and, for a warm view, the edge coefficients of its
// env's track, computed once per tile) sit in shared memory and are read as
// broadcasts. A thread paints pixels p = tid + 384 k: each warp holds 32
// pixels of one row, so the per-slot row test (a slot paints nothing above
// its band start) is warp-uniform, and an edge test that fails ends the
// slot for that pixel. Warm and steady views branch per view inside the one
// launch: no partition, no cap, no host read. The TPU's 32-row bands, its
// 128-lane padding and its 8 views per program are not carried over. This
// first version is right, not tuned: no bounding-box culling per warp.
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
constexpr int kThreads = 384;            // 4 rows of 96 pixels per pass
constexpr int kMaxCars = 32;
constexpr int kQW = 16, kPW = 28;        // slot row widths: 4 and 8 edges
constexpr int kRects = 8, kRectW = 8;
constexpr int kGlyphs = 4, kGlyphW = 8;
constexpr int kWarmW = 26;               // staged warm tile: 2 x 12 coefficients, 2 palettes
constexpr int kMaxSmem = 227 * 1024;
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

struct Layout {            // word offsets into the dynamic shared memory
  int quads, q4, p8, rects, score, pal, warm, words;
};

__host__ __device__ inline Layout layout(int sq, int s4, int s8, int npal, int mt) {
  Layout L;
  L.quads = 8;
  L.q4 = L.quads + sq * kQW;
  L.p8 = L.q4 + s4 * kQW;
  L.rects = L.p8 + s8 * kPW;
  L.score = L.rects + kRects * kRectW;
  L.pal = L.score + kGlyphs * kGlyphW;
  L.warm = L.pal + npal;
  L.words = L.warm + mt * kWarmW;
  return L;
}

__global__ void __launch_bounds__(kThreads, 2)
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

  const float ca = smem[0], sa = smem[1], tx = smem[2], ty = smem[3], inv_zoom = smem[4];
  const bool warm = smem[5] > 0.0f;
  const int nq = static_cast<int>(smem[6]);

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

  const float* quad_s = smem + L.quads;
  const float* q4_s = smem + L.q4;
  const float* p8_s = smem + L.p8;
  const float* rect_s = smem + L.rects;
  const bool flag = s8 > 4 * n_cars;
  unsigned char* dst = out + vs * (kH * kW * 3);

  for (int p = tid; p < kH * kW; p += kThreads) {
    const int r = p / kW, col = p - r * kW;
    const float row = static_cast<float>(r);
    const float wx = __fmul_rn(__fadd_rn(static_cast<float>(col), 0.5f), wx_scale);
    const float wy = __fmul_rn(__fsub_rn(static_cast<float>(kH) - 0.5f, row), wy_scale);

    // Background: inverse camera to world; grass, lighter checker, white.
    const float dx = __fsub_rn(wx, tx), dy = __fsub_rn(wy, ty);
    const float gx = __fmul_rn(__fadd_rn(__fmul_rn(ca, dx), __fmul_rn(sa, dy)), inv_zoom);
    const float gy = __fmul_rn(__fadd_rn(__fmul_rn(-sa, dx), __fmul_rn(ca, dy)), inv_zoom);
    const float ix = floorf(__fdiv_rn(gx, checker_k));
    const float iy = floorf(__fdiv_rn(gy, checker_k));
    const bool infield = fabsf(gx) <= playfield && fabsf(gy) <= playfield;
    // floor(g/k) is integral: within [-20, 20) the int's low bit is its parity.
    const bool lighter = ix >= -20.0f && ix < 20.0f && iy >= -20.0f && iy < 20.0f &&
                         (static_cast<int>(ix) & 1) == 0 && (static_cast<int>(iy) & 1) == 0;
    int idx = infield ? (lighter ? kGrassLight : kGrassDark) : kWhite;

    // Road and curbs.
    if (warm) {
      for (int t = 0; t < mt; ++t) {
        const float* w = warm_s + t * kWarmW;
        const int tp = reinterpret_cast<const int*>(w)[24];
        const int cp = reinterpret_cast<const int*>(w)[25];
        if (tp >= 0 && world_cover(w, gx, gy)) idx = tp;
        if (cp >= 0 && world_cover(w + 12, gx, gy)) idx = cp;
      }
    } else {
      for (int t = 0; t < nq; ++t) paint_slot<4>(quad_s + t * kQW, wx, wy, row, idx);
    }

    // Cars in id order: 4 x (wheel, marker), then 4 hull polygons.
    for (int car = 0; car < n_cars; ++car) {
      for (int t = 8 * car; t < 8 * car + 8; ++t) paint_slot<4>(q4_s + t * kQW, wx, wy, row, idx);
      for (int t = 4 * car; t < 4 * car + 4; ++t) paint_slot<8>(p8_s + t * kPW, wx, wy, row, idx);
    }

    // HUD rects: xa, xb, ya, yb, palette, 1, band start.
#pragma unroll
    for (int t = 0; t < kRects; ++t) {
      const float* q = rect_s + t * kRectW;
      if (row >= q[6] && wx >= q[0] && wx <= q[1] && wy >= q[2] && wy <= q[3])
        idx = static_cast<int>(q[4]);
    }

    // Score glyphs ("%04i", 5 x 7 bits per row).
    if (r >= kScoreRow0) {
      const float grow = floorf(__fmul_rn(__fdiv_rn(__fsub_rn(kScoreTop, wy), kDigitH), 7.0f));
      if (grow >= 0.0f && grow < 7.0f) {
#pragma unroll
        for (int i = 0; i < kGlyphs; ++i) {
          const float x0 = kScoreX + static_cast<float>(i) * kScoreSpacing;
          const float gcol = floorf(__fmul_rn(__fdiv_rn(__fsub_rn(wx, x0), kDigitW), 5.0f));
          if (gcol >= 0.0f && gcol < 5.0f) {
            const int bits = score_s[i * kGlyphW + static_cast<int>(grow)];
            if ((bits >> (4 - static_cast<int>(gcol))) & 1) idx = kWhite;
          }
        }
      }
    }

    // The backwards flag, last.
    if (flag) paint_slot<8>(p8_s + 4 * n_cars * kPW, wx, wy, row, idx);

    const int rgb = pal_s[static_cast<unsigned>(idx) < static_cast<unsigned>(npal) ? idx : 0];
    unsigned char* o = dst + p * 3;
    o[0] = static_cast<unsigned char>(rgb & 0xff);
    o[1] = static_cast<unsigned char>((rgb >> 8) & 0xff);
    o[2] = static_cast<unsigned char>((rgb >> 16) & 0xff);
  }
}

}  // namespace

extern "C" {

// Launches the painter on `stream` for E envs of n_cars views each: sq
// windowed quad slots, s8 (4 n_cars, or 4 n_cars + 1 with the flag) 8-edge
// slots, mt padded tiles, npal palette colours. Returns cudaGetLastError()
// after the launch (0 on success, cudaErrorInvalidValue for shapes it does
// not take or tables that do not fit its shared memory); does not
// synchronise.
int paint_view_launch(const float* cam, const float* quads, const float* q4, const float* p8,
                      const float* rects, const int* score, const float* quad,
                      const float* curb_quad, const unsigned char* touched,
                      const unsigned char* curb_red, const unsigned char* valid,
                      const unsigned char* has_curb, const unsigned char* palette,
                      unsigned char* out, int num_envs, int n_cars, int sq, int s8, int mt,
                      int npal, float wx_scale, float wy_scale, float playfield,
                      float checker_k, void* stream) {
  if (n_cars < 1 || n_cars > kMaxCars || sq < 0 || mt < 0 || npal < 1 ||
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
