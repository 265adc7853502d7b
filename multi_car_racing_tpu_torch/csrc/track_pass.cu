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
// What bounds it. Per env it reads the tiles-last track tables once -- road
// quads, edge normals, own-axis intervals, curb quads, centreline and
// heading, ~35 floats per tile, ~54 KB at MT = 384, ~0.22 GB at E = 4096 --
// plus the visited masks, and writes the new masks. The arithmetic is ~630
// fp32 operations per (car, valid tile) (track_engine.track_pass_work),
// ~7.5e8 at E = 4096, N = 1: 0.011 ms at 67 TFLOP/s against 0.068 ms for
// the bytes at 3.35 TB/s. So the bound is bytes up to N ~ 6 cars per env.
//
// What the design does about it. One block per env; its threads stride over
// the tiles, so neighbouring threads read neighbouring floats of each
// (E, ., MT) table (coalesced). The cars are the outer loop: each car's pass
// re-reads the env's tables, which the first pass left in L1/L2. A tile is
// owned by one thread for the whole launch, so its cross-car state (visitors
// so far: the car-id tie-break; touched) lives in shared memory without a
// barrier. Per car, the block reduces the per-wheel OR, the bonus sum, the
// count, the first-index argmin of d^2 and the on-grass OR by warp shuffles
// and then over the warps in a fixed order: no atomics, so two launches on
// one input give the same bits. This first version is right, not tuned:
// TMA and wgmma have nothing to do here.
//
// Exact masks. Every product and sum that decides a mask (the SAT
// separations against the margin, the point-in-quad cross products, d^2) is
// written with __fmul_rn / __fadd_rn / __fsub_rn in the plain version's
// order: nvcc -O3 would otherwise contract a*b + c*d into an FMA, which
// eager PyTorch never does, and a separation within an ulp of the margin
// could then flip. The visitor factor 1 - past/N is a true division.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC (multi_car_racing_tpu_torch/_cuda.py); plain C interface
// loaded with ctypes. Bool tensors cross as their uint8 bytes.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCars = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kGrassBit = 1u << 4;     // bits 0-3: the car's wheels

// a0*b0 + a1*b1, each operation rounded on its own.
__device__ __forceinline__ float dot2(float a0, float a1, float b0, float b1) {
  return __fadd_rn(__fmul_rn(a0, b0), __fmul_rn(a1, b1));
}

// max(lo - (cp + r), (cp - r) - hi): the separation on one axis.
__device__ __forceinline__ float gap(float lo, float hi, float cp, float r) {
  return fmaxf(__fsub_rn(lo, __fadd_rn(cp, r)), __fsub_rn(__fsub_rn(cp, r), hi));
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

struct Scratch {
  unsigned bits[kWarps];
  float sum[kWarps];
  int cnt[kWarps];
  float d2[kWarps];
  int idx[kWarps];
};

// (d, i) < (best_d, best_i) lexicographically: the first index of the minimum.
__device__ __forceinline__ void argmin_merge(float& best_d, int& best_i, float d, int i) {
  if (d < best_d || (d == best_d && i < best_i)) {
    best_d = d;
    best_i = i;
  }
}

// Reduces the block's per-thread values into thread 0's, in a fixed order.
__device__ void block_reduce(unsigned& bits, float& sum, int& cnt, float& d2, int& idx,
                             Scratch& s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    bits |= __shfl_down_sync(kFull, bits, off);
    sum = __fadd_rn(sum, __shfl_down_sync(kFull, sum, off));
    cnt += __shfl_down_sync(kFull, cnt, off);
    const float od = __shfl_down_sync(kFull, d2, off);
    const int oi = __shfl_down_sync(kFull, idx, off);
    argmin_merge(d2, idx, od, oi);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    s.bits[warp] = bits;
    s.sum[warp] = sum;
    s.cnt[warp] = cnt;
    s.d2[warp] = d2;
    s.idx[warp] = idx;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kWarps; ++w) {
      bits |= s.bits[w];
      sum = __fadd_rn(sum, s.sum[w]);
      cnt += s.cnt[w];
      argmin_merge(d2, idx, s.d2[w], s.idx[w]);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
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
                  unsigned char* __restrict__ grass_out, int n_cars, int mt, float hx,
                  float hy, float margin) {
  extern __shared__ unsigned char smem[];
  unsigned char* past = smem;          // (mt) visitors of each tile so far
  unsigned char* touched = smem + mt;  // (mt)
  __shared__ Scratch scratch;

  const int e = blockIdx.x;
  const int tid = threadIdx.x;
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
  // 1000 / n_tiles as the plain version evaluates it: torch's scalar / tensor
  // is reciprocal(tensor) * scalar, two roundings.
  const float tile_bonus =
      __fmul_rn(__fdiv_rn(1.0f, static_cast<float>(n_tiles[e])), 1000.0f);

  for (int t = tid; t < mt; t += kThreads) {
    int c = 0;
    for (int n = 0; n < n_cars; ++n) c += VIS[n * m + t];
    past[t] = static_cast<unsigned char>(c);
    touched[t] = tt_in[em + t];
  }

  for (int n = 0; n < n_cars; ++n) {
    const size_t car = static_cast<size_t>(e) * n_cars + n;
    // Wheel k: centre, forward and side unit vectors; own-axis projections
    // of the centre.
    float cx[4], cy[4], fx[4], fy[4], sx[4], sy[4], cps[4], cpf[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float* w = wheels + (car * 4 + k) * 6;
      cx[k] = w[0]; cy[k] = w[1]; fx[k] = w[2]; fy[k] = w[3]; sx[k] = w[4]; sy[k] = w[5];
      cps[k] = dot2(cx[k], cy[k], sx[k], sy[k]);
      cpf[k] = dot2(cx[k], cy[k], fx[k], fy[k]);
    }
    const float pre_x = origins[car * 4 + 0], pre_y = origins[car * 4 + 1];
    const float post_x = origins[car * 4 + 2], post_y = origins[car * 4 + 3];

    unsigned bits = 0;          // wheel overlaps (bits 0-3), inside road or curb (bit 4)
    float sum = 0.0f;           // sum of the visitor factors of new tiles
    int cnt = 0;
    float best_d = CUDART_INF_F;
    int best_i = mt;

    for (int t = tid; t < mt; t += kThreads) {
      float qx[4], qy[4];
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        qx[v] = Q[(2 * v) * m + t];
        qy[v] = Q[(2 * v + 1) * m + t];
      }
      float ax[4], ay[4], lo[4], hi[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        ax[a] = AX[(2 * a) * m + t];
        ay[a] = AX[(2 * a + 1) * m + t];
        lo[a] = LO[a * m + t];
        hi[a] = HI[a * m + t];
      }

      bool car_tile = false;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        // The wheel's own axes: side (half-extent hx), forward (hy).
        float sep;
        {
          float lo_b = dot2(sx[k], sy[k], qx[0], qy[0]), hi_b = lo_b;
#pragma unroll
          for (int v = 1; v < 4; ++v) {
            const float p = dot2(sx[k], sy[k], qx[v], qy[v]);
            lo_b = fminf(lo_b, p);
            hi_b = fmaxf(hi_b, p);
          }
          sep = gap(lo_b, hi_b, cps[k], hx);
        }
        {
          float lo_b = dot2(fx[k], fy[k], qx[0], qy[0]), hi_b = lo_b;
#pragma unroll
          for (int v = 1; v < 4; ++v) {
            const float p = dot2(fx[k], fy[k], qx[v], qy[v]);
            lo_b = fminf(lo_b, p);
            hi_b = fmaxf(hi_b, p);
          }
          sep = fmaxf(sep, gap(lo_b, hi_b, cpf[k], hy));
        }
        // The tile's 4 edge normals, with the wheel's support radius.
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const float cp = dot2(cx[k], cy[k], ax[a], ay[a]);
          const float sp = dot2(sx[k], sy[k], ax[a], ay[a]);
          const float fp = dot2(fx[k], fy[k], ax[a], ay[a]);
          const float r = __fadd_rn(__fmul_rn(hx, fabsf(sp)), __fmul_rn(hy, fabsf(fp)));
          sep = fmaxf(sep, gap(lo[a], hi[a], cp, r));
        }
        const bool ov = sep < margin;
        bits |= static_cast<unsigned>(ov) << k;
        car_tile = car_tile || ov;
      }

      if (car_tile || point_in_quad(pre_x, pre_y, qx, qy)) touched[t] = 1;

      const bool was = VIS[n * m + t] != 0;
      const bool fresh = car_tile && !was && V[t] != 0;
      VOUT[n * m + t] = static_cast<unsigned char>(was || fresh);
      if (fresh) {
        const float p = static_cast<float>(past[t]);
        sum = __fadd_rn(sum, __fsub_rn(1.0f, __fdiv_rn(p, fn)));
        ++cnt;
        past[t] = static_cast<unsigned char>(past[t] + 1);
      }

      if (V[t] != 0) {
        const float dx = __fsub_rn(post_x, XY[2 * t]);
        const float dy = __fsub_rn(post_y, XY[2 * t + 1]);
        argmin_merge(best_d, best_i, dot2(dx, dy, dx, dy), t);
      } else {
        argmin_merge(best_d, best_i, CUDART_INF_F, t);
      }

      if (!(bits & kGrassBit)) {
        float cqx[4], cqy[4];
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          cqx[v] = CQ[(2 * v) * m + t];
          cqy[v] = CQ[(2 * v + 1) * m + t];
        }
        if (point_in_quad(post_x, post_y, qx, qy) ||
            point_in_quad(post_x, post_y, cqx, cqy))
          bits |= kGrassBit;
      }
    }

    block_reduce(bits, sum, cnt, best_d, best_i, scratch);
    if (tid == 0) {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        won_out[car * 4 + k] = static_cast<unsigned char>((bits >> k) & 1u);
      bonus_out[car] = __fmul_rn(sum, tile_bonus);
      cnt_out[car] = cnt;
      // Every tile is a candidate (invalid ones at +inf), so best_i < mt
      // unless every d^2 is NaN.
      nbeta_out[car] = best_i < mt ? beta[em + best_i] : CUDART_NAN_F;
      grass_out[car] = static_cast<unsigned char>((bits & kGrassBit) == 0);
    }
    __syncthreads();            // the scratch is reused by the next car
  }

  for (int t = tid; t < mt; t += kThreads) tt_out[em + t] = touched[t];
}

}  // namespace

extern "C" {

// Launches the track pass on `stream` for E envs of n_cars cars and mt
// padded tiles. Returns cudaGetLastError() after the launch (0 on success,
// cudaErrorInvalidValue for a car count or tile count it does not take);
// does not synchronise.
int track_pass_launch(const float* quad_T, const float* ax_T, const float* quad_lo,
                      const float* quad_hi, const float* curb_T, const float* xy,
                      const float* beta, const unsigned char* valid, const int* n_tiles,
                      const float* wheels, const float* origins,
                      const unsigned char* vis_in, const unsigned char* tt_in,
                      unsigned char* won_out, unsigned char* vis_out, float* bonus_out,
                      int* cnt_out, unsigned char* tt_out, float* nbeta_out,
                      unsigned char* grass_out, int num_envs, int n_cars, int mt,
                      float hx, float hy, float margin, void* stream) {
  if (n_cars < 1 || n_cars > kMaxCars || mt < 1 || 2 * mt > 48 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  if (num_envs <= 0) return 0;
  track_pass_kernel<<<num_envs, kThreads, 2 * mt, static_cast<cudaStream_t>(stream)>>>(
      quad_T, ax_T, quad_lo, quad_hi, curb_T, xy, beta, valid, n_tiles, wheels, origins,
      vis_in, tt_in, won_out, vis_out, bonus_out, cnt_out, tt_out, nbeta_out, grass_out,
      n_cars, mt, hx, hy, margin);
  return static_cast<int>(cudaGetLastError());
}

const char* track_pass_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
