// The per-step track stage of E envs in one launch: wheel-rect vs tile SAT
// (the lagged friction mask), tile-visit bookkeeping and rewards, the render
// "touched" flattening on the pre-solve pose, and the nearest-tile heading
// and on-grass flag on the post-solve hull origin.
//
// Replaces both TPU kernels of multi_car_racing_tpu/physics/track_engine.py:
// _make_kernel -> track_pass_batched (v1, pallas_call :252) and
// _make_kernel_v2 -> track_pass_batched_v2 (v2, pallas_call :498), which
// compute the same outputs. The arithmetic follows the plain PyTorch version,
// multi_car_racing_tpu_torch/physics/track_engine.py :: track_pass_plain
// (overlap.wheel_tile_overlap, overlap.point_in_quads_T, the visit rewards,
// d^2 and argmin), operation by operation.
//
// What bounds it. The nearest-tile argmin needs every tile's centreline
// point, and the masks are copied whole; the rest of the tables (road
// quads, edge normals, own-axis intervals, curb quads: 32 floats a tile)
// matter only on the few tiles a car can touch. So the bytes are xy, valid,
// the visited and touched masks over all MT tiles (~12 B a tile at N = 2),
// plus the tables of the candidate tiles (~7 per car on the road) and the
// masks written back: ~7 KB per env, ~30 MB at E = 4096, ~9 us at
// 3.35 TB/s (track_engine.track_pass_work with `candidates`). The un-culled
// kernel read all ~35 floats of all 384 tiles, ~0.22 GB. In the tiles-last
// layout a candidate's 32 floats lie in 32 rows, so its bytes come in 32
// scattered sectors: the candidates cost DRAM transactions, not bandwidth.
//
// What the design does about it. One warp per env, four envs per block
// (eight blocks an SM: E = 4096 in one wave), no __syncthreads and no
// atomics. For each car in car order:
//  - pass A, over all tiles (lane-strided, coalesced): d^2 of the post-solve
//    origin and its first-index argmin, exactly as before; and the cull,
//    track_engine.track_candidates' formula in float32: tile t is a
//    candidate when a wheel centre lies within reach_t + wheel_extra of
//    xy_t or a hull origin within reach_t + origin_extra, where reach_t =
//    |xy_t - xy_{t-1}| + TRACK_WIDTH + BORDER (0 for padding tiles) bounds
//    every road and curb vertex of the tile. A coarser test about the
//    pre-solve origin skips the six exact ones on far tiles. Candidates are
//    compacted in tile order into a list in shared memory (__ballot_sync /
//    __popc).
//  - pass B, over the car's list only, eight candidates a round: lane
//    4g + k runs the SAT of wheel k against candidate g (the plain
//    version's arithmetic), the group's lanes then split the point-in-quad
//    tests and the fresh-tile, visitor-count and bonus bookkeeping, and
//    ballots gather the wheel and on-grass bits. A tile off the list cannot
//    overlap a wheel or hold an origin, so it keeps the masks copied before
//    the first car. The visitor counts `past` (the car-id tie-break; 16
//    bits, so up to 65,535 cars) and `touched` live in shared memory and
//    advance in car order.
//  - the bonus and the argmin reduce by shuffles in a fixed order, so two
//    launches on one input give the same bits.
// Masks, counts, nearest_beta and on_grass equal the plain version's; the
// bonus sums the same terms in another order (within 2e-5).
//
// Exact masks. Every product and sum that decides a mask (the SAT
// separations against the margin, the point-in-quad cross products, d^2, the
// cull's distances) is written with __fmul_rn / __fadd_rn / __fsub_rn /
// __fsqrt_rn in the plain version's order: nvcc -O3 would otherwise
// contract a*b + c*d into an FMA, which eager PyTorch never does, and a
// separation within an ulp of the margin could then flip. The visitor factor
// 1 - past/N is a true division.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC (multi_car_racing_tpu_torch/_cuda.py); plain C interface
// loaded with ctypes. Bool tensors cross as their uint8 bytes.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kEnvsPerBlock = 4;            // one warp per env
constexpr int kThreads = 32 * kEnvsPerBlock;
constexpr int kMinBlocks = 8;               // 32 warps an SM: E = 4096 in one wave
constexpr int kSmemPerTile = 10;            // reach (4), past (2), list entry (2), touched, flag
constexpr int kMaxCars = 65535;             // `past` counts a tile's visitors in 16 bits
constexpr unsigned kFull = 0xffffffffu;

// a0*b0 + a1*b1, each operation rounded on its own.
__device__ __forceinline__ float dot2(float a0, float a1, float b0, float b1) {
  return __fadd_rn(__fmul_rn(a0, b0), __fmul_rn(a1, b1));
}

// max(lo - (cp + r), (cp - r) - hi): the separation on one axis.
__device__ __forceinline__ float gap(float lo, float hi, float cp, float r) {
  return fmaxf(__fsub_rn(lo, __fadd_rn(cp, r)), __fsub_rn(__fsub_rn(cp, r), hi));
}

// |(px, py) - (x, y)|^2, as track_engine._within and nearest_tile evaluate it.
__device__ __forceinline__ float sq_dist(float px, float py, float x, float y) {
  const float dx = __fsub_rn(px, x), dy = __fsub_rn(py, y);
  return dot2(dx, dy, dx, dy);
}

// Strictly inside a quad of either winding (overlap.point_in_quads_T).
__device__ __forceinline__ bool point_in_quad(float px, float py, const float* x,
                                              const float* y) {
  bool pos = true, neg = true;
#pragma unroll
  for (int v = 0; v < 4; ++v) {
    const int w = (v + 1) & 3;
    const float cr = __fsub_rn(__fmul_rn(__fsub_rn(x[w], x[v]), __fsub_rn(py, y[v])),
                               __fmul_rn(__fsub_rn(y[w], y[v]), __fsub_rn(px, x[v])));
    pos = pos && cr > 0.0f;
    neg = neg && cr < 0.0f;
  }
  return pos || neg;
}

// (d, i) < (best_d, best_i) lexicographically: the first index of the minimum.
__device__ __forceinline__ void argmin_merge(float& best_d, int& best_i, float d, int i) {
  if (d < best_d || (d == best_d && i < best_i)) {
    best_d = d;
    best_i = i;
  }
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
track_pass_kernel(const float* __restrict__ quad_T, const float* __restrict__ ax_T,
                  const float* __restrict__ quad_lo, const float* __restrict__ quad_hi,
                  const float* __restrict__ curb_T, const float* __restrict__ xy,
                  const float* __restrict__ beta, const unsigned char* __restrict__ valid,
                  const int* __restrict__ n_tiles, const float* __restrict__ wheels,
                  const float* __restrict__ origins,
                  const unsigned char* __restrict__ vis_in,
                  const unsigned char* __restrict__ tt_in,
                  unsigned char* __restrict__ won_out, unsigned char* __restrict__ vis_out,
                  float* __restrict__ bonus_out, int* __restrict__ cnt_out,
                  unsigned char* __restrict__ tt_out, float* __restrict__ nbeta_out,
                  unsigned char* __restrict__ grass_out, int num_envs, int n_cars, int mt,
                  float hx, float hy, float margin, float reach_base, float wheel_extra,
                  float origin_extra) {
  extern __shared__ float smem[];
  const int stride = (kSmemPerTile * mt + 3) & ~3;        // bytes per warp
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int e = blockIdx.x * kEnvsPerBlock + warp;
  if (e >= num_envs) return;            // the whole warp: nothing below waits on it
  float* reach = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(smem) + warp * stride);
  unsigned short* past = reinterpret_cast<unsigned short*>(reach + mt);   // (mt)
  unsigned short* list = reinterpret_cast<unsigned short*>(past + mt);    // (mt)
  unsigned char* touched = reinterpret_cast<unsigned char*>(list + mt);   // (mt)
  unsigned char* near_post = touched + mt;                                // (mt) per list entry

  const size_t m = static_cast<size_t>(mt);
  const size_t em = static_cast<size_t>(e) * m;
  const float* Q = quad_T + 8 * em;        // (4 verts, 2 coords, mt)
  const float* AX = ax_T + 8 * em;         // (4 axes, 2 coords, mt)
  const float* LO = quad_lo + 4 * em;      // (4, mt)
  const float* HI = quad_hi + 4 * em;
  const float* CQ = curb_T + 8 * em;
  const float* XY = xy + 2 * em;           // (mt, 2)
  const unsigned char* V = valid + em;
  const unsigned char* VIS = vis_in + em * n_cars;   // (n_cars, mt)
  unsigned char* VOUT = vis_out + em * n_cars;
  const float fn = static_cast<float>(n_cars);
  const int nt = n_tiles[e];
  // 1000 / n_tiles as the plain version evaluates it: torch's scalar / tensor
  // is reciprocal(tensor) * scalar, two roundings.
  const float tile_bonus = __fmul_rn(__fdiv_rn(1.0f, static_cast<float>(nt)), 1000.0f);

  // Each tile's reach, visitors so far and touched flag; visited' starts as
  // visited (pass B sets the fresh tiles).
#pragma unroll 4
  for (int t = lane; t < mt; t += 32) {
    float r = 0.0f;
    if (V[t] != 0) {
      const int p = t == 0 ? nt - 1 : t - 1;
      const float dx = __fsub_rn(XY[2 * t], XY[2 * p]);
      const float dy = __fsub_rn(XY[2 * t + 1], XY[2 * p + 1]);
      r = __fadd_rn(__fsqrt_rn(dot2(dx, dy, dx, dy)), reach_base);
    }
    reach[t] = r;
    int c = 0;
    for (int n = 0; n < n_cars; ++n) {
      const unsigned char v = VIS[n * m + t];
      VOUT[n * m + t] = v;
      c += v;
    }
    past[t] = static_cast<unsigned short>(c);
    touched[t] = tt_in[em + t];
  }
  __syncwarp();

  const int grp = lane >> 2, wk = lane & 3;    // pass B: candidate slot, wheel
  for (int n = 0; n < n_cars; ++n) {
    const size_t car = static_cast<size_t>(e) * n_cars + n;
    // The wheel centres (pass A); this lane's wheel wk (pass B): centre,
    // forward and side unit vectors, own-axis projections of the centre.
    float cx[4], cy[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      cx[k] = wheels[(car * 4 + k) * 6 + 0];
      cy[k] = wheels[(car * 4 + k) * 6 + 1];
    }
    const float* w = wheels + (car * 4 + wk) * 6;
    const float wx = w[0], wy = w[1], fx = w[2], fy = w[3], sx = w[4], sy = w[5];
    const float cps = dot2(wx, wy, sx, sy), cpf = dot2(wx, wy, fx, fy);
    const float pre_x = origins[car * 4 + 0], pre_y = origins[car * 4 + 1];
    const float post_x = origins[car * 4 + 2], post_y = origins[car * 4 + 3];

    // Pass A: the argmin over every tile, and the car's candidates in tile
    // order. Every wheel centre and the post-solve origin lie within car_r of
    // the pre-solve origin, so a tile whose xy lies farther than reach_t +
    // wheel_extra + car_r from it fails every test of the cull (origin_extra
    // < wheel_extra); the metre added covers rounding.
    float car_r2 = sq_dist(post_x, post_y, pre_x, pre_y);
#pragma unroll
    for (int k = 0; k < 4; ++k) car_r2 = fmaxf(car_r2, sq_dist(cx[k], cy[k], pre_x, pre_y));
    const float near_extra = wheel_extra + sqrtf(car_r2) + 1.0f;
    float best_d = CUDART_INF_F;
    int best_i = mt;
    int count = 0;
#pragma unroll 4
    for (int base = 0; base < mt; base += 32) {
      const int t = base + lane;
      bool cand = false, post_in = false;
      if (t < mt) {
        const float x = XY[2 * t], y = XY[2 * t + 1], r = reach[t];
        const float d2 = sq_dist(post_x, post_y, x, y);
        argmin_merge(best_d, best_i, V[t] != 0 ? d2 : CUDART_INF_F, t);
        const float dp2 = sq_dist(pre_x, pre_y, x, y);
        const float rn = r + near_extra;
        if (dp2 <= rn * rn) {
          const float rw = __fadd_rn(r, wheel_extra), ro = __fadd_rn(r, origin_extra);
          const float rw2 = __fmul_rn(rw, rw), ro2 = __fmul_rn(ro, ro);
          post_in = d2 <= ro2;
          cand = post_in || dp2 <= ro2;
#pragma unroll
          for (int k = 0; k < 4; ++k) cand = cand || sq_dist(cx[k], cy[k], x, y) <= rw2;
        }
      }
      const unsigned ballot = __ballot_sync(kFull, cand);
      if (cand) {
        const int slot = count + __popc(ballot & ((1u << lane) - 1u));
        list[slot] = static_cast<unsigned short>(t);
        near_post[slot] = post_in;
      }
      count += __popc(ballot);
    }
    __syncwarp();

    // Pass B: the candidates, eight a round. Lane 4g + k tests wheel k
    // against candidate g of the round; then lane 4g + 1 tests the pre-solve
    // origin in the road quad (touched), 4g + 2 and 4g + 3 the post-solve
    // origin in the road and the curb quad (on grass), and 4g the visit.
    unsigned won = 0;           // wheel overlaps, bits 0-3
    bool on_track = false;      // the post-solve origin inside a road or curb quad
    float sum = 0.0f;           // sum of the visitor factors of new tiles
    int cnt = 0;
    for (int base = 0; base < count; base += 8) {
      const int i = base + grp;
      const bool act = i < count;
      const int t = act ? list[i] : 0;
      const bool post_near = act && near_post[i];
      bool ov = false, in_quad = false;
      if (act) {
        float qx[4], qy[4], ax[4], ay[4], lo[4], hi[4], px[4], py[4];
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          qx[v] = Q[(2 * v) * m + t];
          qy[v] = Q[(2 * v + 1) * m + t];
          ax[v] = AX[(2 * v) * m + t];
          ay[v] = AX[(2 * v + 1) * m + t];
          lo[v] = LO[v * m + t];
          hi[v] = HI[v * m + t];
          px[v] = wk == 3 && post_near ? CQ[(2 * v) * m + t] : qx[v];
          py[v] = wk == 3 && post_near ? CQ[(2 * v + 1) * m + t] : qy[v];
        }
        // The wheel's own axes: side (half-extent hx), forward (hy).
        float sep;
        {
          float lo_b = dot2(sx, sy, qx[0], qy[0]), hi_b = lo_b;
#pragma unroll
          for (int v = 1; v < 4; ++v) {
            const float p = dot2(sx, sy, qx[v], qy[v]);
            lo_b = fminf(lo_b, p);
            hi_b = fmaxf(hi_b, p);
          }
          sep = gap(lo_b, hi_b, cps, hx);
        }
        {
          float lo_b = dot2(fx, fy, qx[0], qy[0]), hi_b = lo_b;
#pragma unroll
          for (int v = 1; v < 4; ++v) {
            const float p = dot2(fx, fy, qx[v], qy[v]);
            lo_b = fminf(lo_b, p);
            hi_b = fmaxf(hi_b, p);
          }
          sep = fmaxf(sep, gap(lo_b, hi_b, cpf, hy));
        }
        // The tile's 4 edge normals, with the wheel's support radius.
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const float cp = dot2(wx, wy, ax[a], ay[a]);
          const float sp = dot2(sx, sy, ax[a], ay[a]);
          const float fp = dot2(fx, fy, ax[a], ay[a]);
          const float r = __fadd_rn(__fmul_rn(hx, fabsf(sp)), __fmul_rn(hy, fabsf(fp)));
          sep = fmaxf(sep, gap(lo[a], hi[a], cp, r));
        }
        ov = sep < margin;
        in_quad = wk != 0 && (wk == 1 || post_near) && point_in_quad(wk == 1 ? pre_x : post_x,
                                           wk == 1 ? pre_y : post_y, px, py);
      }
      const unsigned ov_bits = __ballot_sync(kFull, ov);
      const unsigned quad_bits = __ballot_sync(kFull, in_quad);
      const bool car_tile = ((ov_bits >> (4 * grp)) & 0xfu) != 0;
      unsigned any = ov_bits | (ov_bits >> 16);       // OR of the 8 candidates' nibbles
      any |= any >> 8;
      any |= any >> 4;
      won |= any & 0xfu;
      on_track = on_track || (quad_bits & 0xccccccccu) != 0;      // lanes 4g + 2, 4g + 3
      if (act && wk == 1 && (car_tile || in_quad)) touched[t] = 1;
      const bool fresh = act && wk == 0 && car_tile && VIS[n * m + t] == 0 && V[t] != 0;
      if (fresh) {
        VOUT[n * m + t] = 1;
        const float p = static_cast<float>(past[t]);
        sum = __fadd_rn(sum, __fsub_rn(1.0f, __fdiv_rn(p, fn)));
        past[t] = static_cast<unsigned short>(past[t] + 1);
      }
      cnt += __popc(__ballot_sync(kFull, fresh));
    }

#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      sum = __fadd_rn(sum, __shfl_down_sync(kFull, sum, off));
      const float od = __shfl_down_sync(kFull, best_d, off);
      const int oi = __shfl_down_sync(kFull, best_i, off);
      argmin_merge(best_d, best_i, od, oi);
    }
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        won_out[car * 4 + k] = static_cast<unsigned char>((won >> k) & 1u);
      bonus_out[car] = __fmul_rn(sum, tile_bonus);
      cnt_out[car] = cnt;
      // Every tile is in the argmin (invalid ones at +inf), so best_i < mt
      // unless every d^2 is NaN.
      nbeta_out[car] = best_i < mt ? beta[em + best_i] : CUDART_NAN_F;
      grass_out[car] = static_cast<unsigned char>(!on_track);
    }
    __syncwarp();               // past, touched and the list, for the next car
  }

  for (int t = lane; t < mt; t += 32) tt_out[em + t] = touched[t];
}

}  // namespace

extern "C" {

// Launches the track pass on `stream` for E envs of 1 <= n_cars <= kMaxCars
// cars and mt padded tiles, whose per-tile arrays must fit 48 KB a block
// (kSmemPerTile bytes a tile, four envs a block: mt <= 1228;
// track_engine.track_smem_bytes). Returns
// cudaGetLastError() after the launch (0 on success, cudaErrorInvalidValue
// for a car count or tile count it does not take); does not synchronise.
int track_pass_launch(const float* quad_T, const float* ax_T, const float* quad_lo,
                      const float* quad_hi, const float* curb_T, const float* xy,
                      const float* beta, const unsigned char* valid, const int* n_tiles,
                      const float* wheels, const float* origins,
                      const unsigned char* vis_in, const unsigned char* tt_in,
                      unsigned char* won_out, unsigned char* vis_out, float* bonus_out,
                      int* cnt_out, unsigned char* tt_out, float* nbeta_out,
                      unsigned char* grass_out, int num_envs, int n_cars, int mt,
                      float hx, float hy, float margin, float reach_base, float wheel_extra,
                      float origin_extra, void* stream) {
  const size_t smem = static_cast<size_t>(kEnvsPerBlock) * ((kSmemPerTile * mt + 3) & ~3);
  if (n_cars < 1 || n_cars > kMaxCars || mt < 1 || smem > 48 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  if (num_envs <= 0) return 0;
  const int blocks = (num_envs + kEnvsPerBlock - 1) / kEnvsPerBlock;
  track_pass_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      quad_T, ax_T, quad_lo, quad_hi, curb_T, xy, beta, valid, n_tiles, wheels, origins,
      vis_in, tt_in, won_out, vis_out, bonus_out, cnt_out, tt_out, nbeta_out, grass_out,
      num_envs, n_cars, mt, hx, hy, margin, reach_base, wheel_extra, origin_extra);
  return static_cast<int>(cudaGetLastError());
}

const char* track_pass_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
