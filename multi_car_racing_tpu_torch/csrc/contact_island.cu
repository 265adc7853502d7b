// Full-contact physics island, one warp per env: tire model, force
// integration, revolute-joint limit init, the car-car Collide pass
// (b2CollidePolygons over every fixture pair of every car pair, feature-id
// warm-start match) and the Gauss-Seidel island solve of Box2D 2.3.5's
// world.Step with the contact sub-passes interleaved: warm start (contacts,
// then joints), velocity iterations (joints, then contacts), clamped
// integration, position iterations (contacts, then joints).
//
// Replaces the TPU kernel multi_car_racing_tpu/physics/pallas_world.py ::
// _make_mega_kernel (full-contact variant, pallas_call at :1623 through
// _call_packed). The arithmetic follows the plain PyTorch version,
// multi_car_racing_tpu_torch/physics/fused_world.py :: island_step_plain
// (tire_step -> collide -> make_bundle -> world_step -> extract_state); the
// per-car chain is car_chain.cuh's, shared with csrc/joints_island.cu.
//
// Layout. One warp per env, as contact_rows.cuh sets out: lanes 0..N-1
// carry the cars' chains in registers, the MM = N(N-1)/2 * 48 manifold rows
// are spread over the 32 lanes, bodies and row constants sit in shared
// memory, and every contact sub-pass is Jacobi across rows with per-body
// sums in the routing table's fixed order (bit-identical launches).
//
// Branch. Each env first computes its broadphase flag from the pre-solve
// poses (fattened AABBs per fixture-body pair, as fused_world.near_flags).
// A far env's Collide pass would cull every pair and each contact sub-pass
// would add exact zeros, so a far warp runs the joints-only chain instead
// and writes zero impulses and ids -1. The branch is warp-uniform.
//
// What bounds it. The joints chain is K1's (~5.4e4 fp32 ops per car). A near
// env adds the SAT of every row (~580 ops), the clipping of each live row
// (~310), and per live contact point ~66 ops per contact velocity iteration
// and ~30 per position iteration (fused_world.contact_island_flops counts
// only the work the data needs; this kernel does more, see there). The bound
// is operations, but the solve is a chain of 240 dependent iterations per
// env with 8 warp barriers per velocity iteration, so latency sets the time.
//
// Arithmetic: fp32 throughout; precise sinf/cosf/sqrtf and division (no fast
// math); sign(0) == 0; 1/det through a select.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC (multi_car_racing_tpu_torch/_cuda.py); plain C interface
// loaded with ctypes. The per-car chain, the row layout and the car
// parameters are car_chain.cuh's; the shared arrays, make_bundle's row
// constants and the contact sub-passes are contact_rows.cuh's, shared with
// csrc/solve_island.cu.

#include "contact_rows.cuh"

namespace {

constexpr int kWarpsPerBlock = 4;

// ---------------------------------------------------------------------------
// Contacts.
// ---------------------------------------------------------------------------

__device__ __forceinline__ bool aabb_overlap(float ax, float ay, float ahx, float ahy,
                                             float bx, float by, float bhx, float bhy,
                                             float slack) {
  return fabsf(ax - bx) <= ahx + bhx + slack && fabsf(ay - by) <= ahy + bhy + slack;
}

// Element idx (0..7) of an 8-array held in registers.
__device__ __forceinline__ float sel8(const float* a, int idx) {
  float out = a[0];
#pragma unroll
  for (int v = 1; v < 8; ++v) out = idx == v ? a[v] : out;
  return out;
}

// b2FindMaxSeparation, brute force: the faces of poly (vx, vy; nx, ny)
// against the vertices of (ux, uy). Returns the separation; edge = the first
// face with the largest one.
__device__ __forceinline__ float max_separation(const float* nx, const float* ny,
                                                const float* vx, const float* vy,
                                                const float* ux, const float* uy,
                                                int& edge) {
  float best = 0.f;
  edge = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float d = nx[i] * ux[0] + ny[i] * uy[0];
#pragma unroll
    for (int j = 1; j < 8; ++j) d = fminf(d, nx[i] * ux[j] + ny[i] * uy[j]);
    const float s = d - (nx[i] * vx[i] + ny[i] * vy[i]);
    if (i == 0 || s > best) {
      best = s;
      edge = i;
    }
  }
  return best;
}

// One Sutherland-Hodgman clip of segment (p1, p2) against the half-plane
// n . x <= offset; returns whether two points survive.
__device__ __forceinline__ bool clip_segment(float& p1x, float& p1y, float& p2x,
                                             float& p2y, float nx, float ny,
                                             float offset) {
  const float d1 = nx * p1x + ny * p1y - offset;
  const float d2 = nx * p2x + ny * p2y - offset;
  const float den = fabsf(d1 - d2) > 1e-12f ? d1 - d2 : 1.f;
  const float tc = clampf(d1 / den, 0.f, 1.f);
  const float ix = p1x + tc * (p2x - p1x);
  const float iy = p1y + tc * (p2y - p1y);
  const bool keep1 = d1 <= 0.f, keep2 = d2 <= 0.f, crossed = d1 * d2 < 0.f;
  const float o1x = keep1 ? p1x : (crossed ? ix : p2x);
  const float o1y = keep1 ? p1y : (crossed ? iy : p2y);
  const float o2x = keep2 ? p2x : (crossed ? ix : p1x);
  const float o2y = keep2 ? p2y : (crossed ? iy : p1y);
  p1x = o1x; p1y = o1y; p2x = o2x; p2y = o2y;
  return static_cast<int>(keep1) + static_cast<int>(keep2) + static_cast<int>(crossed) >= 2;
}

// World vertices and normals of fixture f (0..7 within its car) on body b.
__device__ __forceinline__ void fixture_world(int f, int b, const Shared& sh,
                                              const float* __restrict__ ctab,
                                              float* vx, float* vy, float* nx, float* ny) {
  const float c = sh.b(B_COS)[b], s = sh.b(B_SIN)[b], ox = sh.b(B_OX)[b], oy = sh.b(B_OY)[b];
#pragma unroll
  for (int v = 0; v < 8; ++v) {
    const float lx = ctab[kVertsAt + (f * 8 + v) * 2], ly = ctab[kVertsAt + (f * 8 + v) * 2 + 1];
    const float mx = ctab[kNormalsAt + (f * 8 + v) * 2], my = ctab[kNormalsAt + (f * 8 + v) * 2 + 1];
    vx[v] = (c * lx - s * ly) + ox;
    vy[v] = (s * lx + c * ly) + oy;
    nx[v] = c * mx - s * my;
    ny[v] = s * mx + c * my;
  }
}

// b2CollidePolygons for row r, the warm-start keep mask, and the row's
// solver constants into the shared row arrays. Returns the manifold id.
__device__ __forceinline__ int collide_row(int r, int MM, const int* __restrict__ itab,
                                          const Shared& sh, const float* __restrict__ ctab,
                           int prev_id, float pni0, float pni1, float pti0, float pti1) {
  const float total_radius = ctab[C_TOTAL_RADIUS];
  const int fa = itab[r], fb = itab[MM + r];
  const int ba = itab[2 * MM + r], bb = itab[3 * MM + r];
  float vax[8], vay[8], nax[8], nay[8], vbx[8], vby[8], nbx[8], nby[8];
  fixture_world(fa & 7, ba, sh, ctab, vax, vay, nax, nay);
  fixture_world(fb & 7, bb, sh, ctab, vbx, vby, nbx, nby);

  int edge_a, edge_b;
  const float sep_a = max_separation(nax, nay, vax, vay, vbx, vby, edge_a);
  const float sep_b = max_separation(nbx, nby, vbx, vby, vax, vay, edge_b);
  const bool no_contact = sep_a > total_radius || sep_b > total_radius;
  const bool flip = sep_b > sep_a + ctab[C_FLIP_BIAS];
  const int ref_edge = flip ? edge_b : edge_a;

  float rvx[8], rvy[8], ivx[8], ivy[8], inx[8], iny[8], rnx8[8], rny8[8];
#pragma unroll
  for (int v = 0; v < 8; ++v) {
    rvx[v] = flip ? vbx[v] : vax[v];
    rvy[v] = flip ? vby[v] : vay[v];
    rnx8[v] = flip ? nbx[v] : nax[v];
    rny8[v] = flip ? nby[v] : nay[v];
    ivx[v] = flip ? vax[v] : vbx[v];
    ivy[v] = flip ? vay[v] : vby[v];
    inx[v] = flip ? nax[v] : nbx[v];
    iny[v] = flip ? nay[v] : nby[v];
  }
  const float rnx = sel8(rnx8, ref_edge), rny = sel8(rny8, ref_edge);
  int inc_edge = 0;
  float best = rnx * inx[0] + rny * iny[0];
#pragma unroll
  for (int j = 1; j < 8; ++j) {
    const float d = rnx * inx[j] + rny * iny[j];
    if (d < best) {
      best = d;
      inc_edge = j;
    }
  }
  float p1x = sel8(ivx, inc_edge), p1y = sel8(ivy, inc_edge);
  float p2x = sel8(ivx, (inc_edge + 1) & 7), p2y = sel8(ivy, (inc_edge + 1) & 7);
  const float v1x = sel8(rvx, ref_edge), v1y = sel8(rvy, ref_edge);
  const float v2x = sel8(rvx, (ref_edge + 1) & 7), v2y = sel8(rvy, (ref_edge + 1) & 7);

  float tx = v2x - v1x, ty = v2y - v1y;
  const float tlen = fmaxf(sqrtf(tx * tx + ty * ty), 1e-12f);
  tx = tx / tlen;
  ty = ty / tlen;
  const bool ok1 = clip_segment(p1x, p1y, p2x, p2y, -tx, -ty,
                                -(tx * v1x + ty * v1y) + total_radius);
  const bool ok2 = clip_segment(p1x, p1y, p2x, p2y, tx, ty,
                                (tx * v2x + ty * v2y) + total_radius);
  const float front = rnx * v1x + rny * v1y;
  const float s1 = rnx * p1x + rny * p1y - front - total_radius;
  const float s2 = rnx * p2x + rny * p2y - front - total_radius;
  const bool ok = ok1 && ok2 && !no_contact;
  const bool ok_0 = ok && s1 <= total_radius;
  const bool ok_1 = ok && s2 <= total_radius;
  const int cid = (ok_0 || ok_1)
                      ? static_cast<int>(flip) * 1024 + ref_edge * 64 + inc_edge : -1;
  sh.live()[r] = static_cast<int>(ok_0) | (static_cast<int>(ok_1) << 1);

  // make_bundle: the warm-start carry where the feature id persists.
  const bool keep = prev_id == cid && cid >= 0;
  put_row(sh, r, ba, bb, ctab, flip ? -rnx : rnx, flip ? -rny : rny, p1x, p1y, p2x, p2y, s1,
          s2, keep && ok_0 ? pni0 : 0.f, keep && ok_1 ? pni1 : 0.f, keep && ok_0 ? pti0 : 0.f,
          keep && ok_1 ? pti1 : 0.f);
  return cid;
}

__global__ void __launch_bounds__(32 * kWarpsPerBlock)
contact_island_kernel(const float* __restrict__ fin, const int* __restrict__ lsin,
                      const float* __restrict__ pni, const float* __restrict__ pti,
                      const int* __restrict__ pids, float* __restrict__ fout,
                      int* __restrict__ lsout, float* __restrict__ nio,
                      float* __restrict__ tio, int* __restrict__ idso,
                      const float* __restrict__ prm, const float* __restrict__ ctab,
                      const int* __restrict__ itab, int E, int N, int MM,
                      int vel_iters, int pos_iters, int k_vel, int k_pos,
                      int warps_per_block) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int e = blockIdx.x * warps_per_block + warp;
  if (e >= E) return;                       // whole warps only
  const int NB = 5 * N;
  const int P = N * (N - 1) / 2;
  const size_t sn = static_cast<size_t>(E) * N;
  const size_t ci = static_cast<size_t>(e) * N + lane;   // this lane's car
  const bool has_car = lane < N;
  const int b0 = lane * 5;                 // the car's hull slot

  float* S = smem + static_cast<size_t>(warp) * warp_smem_floats(N, MM);
  const Shared sh{S, NB, MM};
  const int* offsets = itab + 4 * MM;
  const int* entries = offsets + NB + 1;

  float p[N_PARAMS];
#pragma unroll
  for (int q = 0; q < N_PARAMS; ++q) p[q] = prm[q];

  Car car;
  if (has_car) car_begin(car, fin, lsin, ci, sn, p);

  // ---- broadphase on the pre-solve poses: each body's fattened-AABB box
  // (center, half extents) in the B_OX/B_OY/B_COS/B_SIN arrays for now.
  if (has_car) {
    const float s = sinf(car.ha), c = cosf(car.ha);
    const float ac = fabsf(c), as = fabsf(s);
    sh.b(B_OX)[b0] = car.hcx + c * ctab[C_HULL_MID_X] - s * ctab[C_HULL_MID_Y];
    sh.b(B_OY)[b0] = car.hcy + s * ctab[C_HULL_MID_X] + c * ctab[C_HULL_MID_Y];
    sh.b(B_COS)[b0] = ac * ctab[C_HULL_HALF_X] + as * ctab[C_HULL_HALF_Y];
    sh.b(B_SIN)[b0] = as * ctab[C_HULL_HALF_X] + ac * ctab[C_HULL_HALF_Y];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float ws = fabsf(sinf(car.wa[k])), wc = fabsf(cosf(car.wa[k]));
      sh.b(B_OX)[b0 + 1 + k] = car.wcx[k];
      sh.b(B_OY)[b0 + 1 + k] = car.wcy[k];
      sh.b(B_COS)[b0 + 1 + k] = wc * ctab[C_WHEEL_HALF_X] + ws * ctab[C_WHEEL_HALF_Y];
      sh.b(B_SIN)[b0 + 1 + k] = ws * ctab[C_WHEEL_HALF_X] + wc * ctab[C_WHEEL_HALF_Y];
    }
  }
  __syncwarp();
  bool my_near = false;
  const float slack = ctab[C_BP_SLACK];
  for (int q = lane; q < P; q += 32) {
    // Pair q's rows start at q * 48; their body slots name the two cars.
    const int ha = itab[2 * MM + q * 48] / 5 * 5, hb = itab[3 * MM + q * 48] / 5 * 5;
    bool hit = aabb_overlap(sh.b(B_OX)[ha], sh.b(B_OY)[ha], sh.b(B_COS)[ha], sh.b(B_SIN)[ha],
                            sh.b(B_OX)[hb], sh.b(B_OY)[hb], sh.b(B_COS)[hb], sh.b(B_SIN)[hb], slack);
    for (int k = 1; k <= 4; ++k) {
      hit = hit || aabb_overlap(sh.b(B_OX)[ha], sh.b(B_OY)[ha], sh.b(B_COS)[ha], sh.b(B_SIN)[ha],
                                sh.b(B_OX)[hb + k], sh.b(B_OY)[hb + k], sh.b(B_COS)[hb + k],
                                sh.b(B_SIN)[hb + k], slack)
                || aabb_overlap(sh.b(B_OX)[ha + k], sh.b(B_OY)[ha + k], sh.b(B_COS)[ha + k],
                                sh.b(B_SIN)[ha + k], sh.b(B_OX)[hb], sh.b(B_OY)[hb], sh.b(B_COS)[hb],
                                sh.b(B_SIN)[hb], slack);
    }
    my_near = my_near || hit;
  }
  const bool near = __any_sync(kFull, my_near);

  const size_t row0 = static_cast<size_t>(e) * MM;
  if (!near) {
    // Collide would cull every pair and every contact sub-pass would add
    // exact zeros: the joints-only chain, with the same iteration counts.
    if (has_car) {
      joints_chain(car, p, vel_iters, pos_iters);
      car_store(car, fout, lsout, ci, sn);
    }
    store_zero_impulses(nio, tio, row0, MM, lane);
    for (int r = lane; r < MM; r += 32) idso[row0 + r] = -1;
    return;
  }

  // ---- near env. Pre-solve poses and the force-integrated velocities.
  __syncwarp();                             // done reading the broadphase boxes
  if (has_car) {
    put_velocities(car, sh, b0);
    put_positions(car, sh, b0);
  }
  __syncwarp();
  for (int b = lane; b < NB; b += 32) {
    const float a = sh.b(B_A)[b];
    const float s = sinf(a), c = cosf(a);
    const bool hull = b % 5 == 0;
    const float lcx = hull ? ctab[C_LC_X] : 0.f, lcy = hull ? ctab[C_LC_Y] : 0.f;
    sh.b(B_COS)[b] = c;
    sh.b(B_SIN)[b] = s;
    // Fixtures hang off the body origin: the hull's is its COM minus the
    // rotated local center; a wheel's is its COM.
    sh.b(B_OX)[b] = hull ? sh.b(B_CX)[b] - (c * lcx - s * lcy) : sh.b(B_CX)[b];
    sh.b(B_OY)[b] = hull ? sh.b(B_CY)[b] - (s * lcx + c * lcy) : sh.b(B_CY)[b];
    sh.b(B_C0X)[b] = sh.b(B_CX)[b];
    sh.b(B_C0Y)[b] = sh.b(B_CY)[b];
  }
  __syncwarp();

  // ---- Collide pass + make_bundle.
  for (int r = lane; r < MM; r += 32) {
    const size_t g = row0 + r;
    idso[g] = collide_row(r, MM, itab, sh, ctab, pids[g], pni[g * 2],
                          pni[g * 2 + 1], pti[g * 2], pti[g * 2 + 1]);
  }
  __syncwarp();

  solve_contact_island(car, has_car, b0, sh, itab, offsets, entries, ctab, p, NB, MM, lane,
                       vel_iters, pos_iters, k_vel, k_pos);
  if (has_car) car_store(car, fout, lsout, ci, sn);
  store_impulses(sh, nio, tio, row0, MM, lane);
}

}  // namespace

extern "C" {

// Launches the island on `stream` for E envs of N >= 2 cars (MM manifold rows
// each). Returns the CUDA error after the launch (0 on success); does not
// synchronise.
int contact_island_launch(const float* fin, const int* lsin, const float* pni,
                          const float* pti, const int* pids, float* fout, int* lsout,
                          float* nio, float* tio, int* idso, const float* prm,
                          const float* ctab, const int* itab, int E, int N, int MM,
                          int vel_iters, int pos_iters, int k_vel, int k_pos,
                          void* stream) {
  if (E <= 0) return 0;
  if (N < 2 || N > 32 || MM != N * (N - 1) / 2 * 48) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t per_warp = warp_smem_floats(N, MM) * sizeof(float);
  const int warps = fit_warps_per_block(per_warp, kWarpsPerBlock);
  const size_t smem = warps * per_warp;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        contact_island_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (E + warps - 1) / warps;
  contact_island_kernel<<<blocks, 32 * warps, smem, static_cast<cudaStream_t>(stream)>>>(
      fin, lsin, pni, pti, pids, fout, lsout, nio, tio, idso, prm, ctab, itab, E, N,
      MM, vel_iters, pos_iters, k_vel, k_pos, warps);
  return static_cast<int>(cudaGetLastError());
}

const char* contact_island_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
