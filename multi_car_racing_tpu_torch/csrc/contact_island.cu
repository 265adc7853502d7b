// Full-contact physics island: tire model, force integration,
// revolute-joint limit init, the car-car Collide pass (b2CollidePolygons
// over every fixture pair of every car pair, feature-id warm-start match)
// and the Gauss-Seidel island solve of Box2D 2.3.5's world.Step with the
// contact sub-passes interleaved: warm start (contacts, then joints),
// velocity iterations (joints, then contacts), clamped integration, position
// iterations (contacts, then joints).
//
// Replaces the TPU kernel multi_car_racing_tpu/physics/pallas_world.py ::
// _make_mega_kernel (full-contact variant, pallas_call at :1623 through
// _call_packed). The arithmetic follows the plain PyTorch version,
// multi_car_racing_tpu_torch/physics/fused_world.py :: island_step_plain
// (tire_step -> collide -> make_bundle -> world_step -> extract_state); the
// per-car chain is car_chain.cuh's, shared with csrc/joints_island.cu.
//
// Two launches, both made by contact_island_launch (one K2 call per step):
//
// 1. The far pass, one thread per car as in joints_island.cu. Each thread
//    computes its env's broadphase flag from the pre-solve poses (fattened
//    AABBs per fixture-body pair, as fused_world.near_flags). A far env's
//    Collide pass would cull every pair and each contact sub-pass would add
//    exact zeros, so its cars are independent single-car islands: each
//    thread runs car_chain.cuh's chain on its car, exactly as K1 does, and
//    writes its share of the env's zero impulses and ids -1. A near env's
//    car 0 appends the env to a device-side list (a warp-aggregated
//    atomicAdd on the list's count; the list's order is not deterministic,
//    but each env's outputs depend only on that env).
// 2. The near pass, one warp per listed env, as contact_rows.cuh sets out:
//    lanes 0..N-1 carry the cars' chains in registers, the MM = N(N-1)/2 *
//    48 manifold rows are spread over the 32 lanes for Collide, and the
//    solve walks only the live rows and each body's live routing entries,
//    with per-body sums in the routing table's fixed order (bit-identical
//    launches). Up to N = 9 each warp's arrays sit in shared memory and
//    the grid covers E warps; a warp past the list's count returns at once.
//    Above N = 9 they do not fit a block's shared memory: the same arrays
//    sit in a global scratch slot per resident warp (contact_rows.cuh), one
//    warp a block, each warp looping over the list with the grid's stride.
//    Above N = 32 (kLaneCars) a lane carries cars lane, lane + 32, ..., each
//    car's chain state in the warp's slot (the kWide instance). The count is
//    never read on the host.
//
// What bounds it. The joints chain is K1's (~5.4e4 fp32 ops per car). A near
// env adds the SAT of every row (~580 ops), the clipping of each live row
// (~310), and per live contact point ~66 ops per contact velocity iteration
// and ~30 per position iteration (fused_world.contact_island_flops counts
// only the work the data needs; this kernel does more, see there). The bound
// is operations, but each env's solve is a chain of 240 dependent
// iterations, and a near env's has 8 warp barriers per velocity iteration,
// so latency sets the time: the far pass at K1's, the near pass at the
// chain of one near warp.
//
// Arithmetic: fp32 throughout; precise sinf/cosf/sqrtf and division (no fast
// math); sign(0) == 0; 1/det through a select.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC (multi_car_racing_tpu_torch/_cuda.py); plain C interface
// loaded with ctypes. The per-car chain, the row layout and the car
// parameters are car_chain.cuh's; the shared arrays, make_bundle's row
// constants, the compact lists and the contact sub-passes are
// contact_rows.cuh's, shared with csrc/solve_island.cu.

#include "contact_rows.cuh"

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kFarThreads = 64;

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

// ---------------------------------------------------------------------------
// Broadphase.
// ---------------------------------------------------------------------------

// One body's fattened-AABB box: centre and half extents.
struct Box {
  float ox, oy, hx, hy;
};

// The five boxes (hull, then wheels) of car column `col` of the packed
// (rows, E*N) input, from its pre-solve pose.
__device__ __forceinline__ void car_boxes(const float* __restrict__ fin, size_t col, size_t sn,
                                          const float* __restrict__ ctab, Box* bx) {
#define IN(r) fin[static_cast<size_t>(r) * sn + col]
  const float hcx = IN(IN_HULL + 3), hcy = IN(IN_HULL + 4), ha = IN(IN_HULL + 5);
  const float s = sinf(ha), c = cosf(ha);
  const float ac = fabsf(c), as = fabsf(s);
  bx[0].ox = hcx + c * ctab[C_HULL_MID_X] - s * ctab[C_HULL_MID_Y];
  bx[0].oy = hcy + s * ctab[C_HULL_MID_X] + c * ctab[C_HULL_MID_Y];
  bx[0].hx = ac * ctab[C_HULL_HALF_X] + as * ctab[C_HULL_HALF_Y];
  bx[0].hy = as * ctab[C_HULL_HALF_X] + ac * ctab[C_HULL_HALF_Y];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float wa = IN(IN_WHEEL + 20 + k);
    const float ws = fabsf(sinf(wa)), wc = fabsf(cosf(wa));
    bx[1 + k].ox = IN(IN_WHEEL + 12 + k);
    bx[1 + k].oy = IN(IN_WHEEL + 16 + k);
    bx[1 + k].hx = wc * ctab[C_WHEEL_HALF_X] + ws * ctab[C_WHEEL_HALF_Y];
    bx[1 + k].hy = ws * ctab[C_WHEEL_HALF_X] + wc * ctab[C_WHEEL_HALF_Y];
  }
#undef IN
}

__device__ __forceinline__ bool box_overlap(const Box& a, const Box& b, float slack) {
  return aabb_overlap(a.ox, a.oy, a.hx, a.hy, b.ox, b.oy, b.hx, b.hy, slack);
}

// The broadphase flag of env e (cars e*N .. e*N + N-1): could any car pair
// produce a contact? Hull-hull and hull-wheel both ways, per pair.
__device__ __forceinline__ bool env_near(const float* __restrict__ fin, size_t sn, int e, int N,
                                         const float* __restrict__ ctab) {
  const float slack = ctab[C_BP_SLACK];
  const size_t c0 = static_cast<size_t>(e) * N;
  for (int a = 0; a < N; ++a) {
    Box A[5];
    car_boxes(fin, c0 + a, sn, ctab, A);
    for (int b = a + 1; b < N; ++b) {
      Box B[5];
      car_boxes(fin, c0 + b, sn, ctab, B);
      bool hit = box_overlap(A[0], B[0], slack);
#pragma unroll
      for (int k = 1; k <= 4; ++k) {
        hit = hit || box_overlap(A[0], B[k], slack) || box_overlap(A[k], B[0], slack);
      }
      if (hit) return true;
    }
  }
  return false;
}

// ---------------------------------------------------------------------------
// The far pass: one thread per car.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kFarThreads)
far_pass_kernel(const float* __restrict__ fin, const int* __restrict__ lsin,
                float* __restrict__ fout, int* __restrict__ lsout, float* __restrict__ nio,
                float* __restrict__ tio, int* __restrict__ idso, const float* __restrict__ prm,
                const float* __restrict__ ctab, int* __restrict__ near_list,
                int* __restrict__ near_count, int E, int N, int MM, int vel_iters,
                int pos_iters) {
  const int n_cars = E * N;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = i < n_cars;
  const int e = active ? i / N : 0;
  const int n = i - e * N;
  const size_t sn = static_cast<size_t>(n_cars);
  const bool near = active && env_near(fin, sn, e, N, ctab);

  // Car 0 of each near env appends the env to the near list: one atomicAdd
  // per warp, each env at the warp's base plus its rank among the warp's.
  const bool head = near && n == 0;
  const unsigned m = __ballot_sync(kFull, head);
  if (m != 0u) {
    const int lane = threadIdx.x & 31;
    const int leader = __ffs(m) - 1;
    int base = 0;
    if (lane == leader) base = atomicAdd(near_count, __popc(m));
    base = __shfl_sync(kFull, base, leader);
    if (head) near_list[base + __popc(m & ((1u << lane) - 1u))] = e;
  }
  if (!active || near) return;

  // A far env: K1's chain on this car, then its share of the env's carry.
  float p[N_PARAMS];
#pragma unroll
  for (int q = 0; q < N_PARAMS; ++q) p[q] = prm[q];
  Car car;
  car_begin(car, fin, lsin, i, sn, p);
  joints_chain(car, p, vel_iters, pos_iters);
  car_store(car, fout, lsout, i, sn);
  const size_t row0 = static_cast<size_t>(e) * MM;
  for (int r = n; r < MM; r += N) {
    const size_t g = row0 + r;
    nio[g * 2] = 0.f;
    nio[g * 2 + 1] = 0.f;
    tio[g * 2] = 0.f;
    tio[g * 2 + 1] = 0.f;
    idso[g] = -1;
  }
}

// ---------------------------------------------------------------------------
// The near pass: one warp per env of the near list.
// ---------------------------------------------------------------------------

// Near env e on this warp, whose arrays are at S. kWide (N > kLaneCars):
// the lane's cars in their slots (contact_rows.cuh).
template <bool kWide>
__device__ __forceinline__ void near_env(
    int e, int lane, float* S, const float* __restrict__ fin, const int* __restrict__ lsin,
    const float* __restrict__ pni, const float* __restrict__ pti,
    const int* __restrict__ pids, float* __restrict__ fout, int* __restrict__ lsout,
    float* __restrict__ nio, float* __restrict__ tio, int* __restrict__ idso,
    const float* __restrict__ prm, const float* __restrict__ ctab,
    const int* __restrict__ itab, int E, int N, int MM, int vel_iters, int pos_iters,
    int k_vel, int k_pos) {
  const int NB = 5 * N;
  const size_t sn = static_cast<size_t>(E) * N;
  const size_t ci = static_cast<size_t>(e) * N + lane;   // this lane's car
  const bool has_car = lane < N;
  const int b0 = lane * 5;                 // the car's hull slot
  const Shared sh{S, NB, MM};

  float p[N_PARAMS];
#pragma unroll
  for (int q = 0; q < N_PARAMS; ++q) p[q] = prm[q];

  Car car;
  // ---- the tire model, the pre-solve poses and the force-integrated
  // velocities.
  if constexpr (kWide) {
    each_car(sh, N, lane, [&](Car& c, JointK&, int n) {
      car_begin(c, fin, lsin, static_cast<size_t>(e) * N + n, sn, p);
      put_velocities(c, sh, 5 * n);
      put_positions(c, sh, 5 * n);
    });
  } else {
    if (has_car) car_begin(car, fin, lsin, ci, sn, p);
    if (has_car) {
      put_velocities(car, sh, b0);
      put_positions(car, sh, b0);
    }
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
  const size_t row0 = static_cast<size_t>(e) * MM;
  for (int r = lane; r < MM; r += 32) {
    const size_t g = row0 + r;
    idso[g] = collide_row(r, MM, itab, sh, ctab, pids[g], pni[g * 2],
                          pni[g * 2 + 1], pti[g * 2], pti[g * 2 + 1]);
  }
  __syncwarp();

  if constexpr (kWide) {
    solve_contact_island_wide(sh, itab, ctab, p, N, MM, lane, vel_iters, pos_iters, k_vel,
                              k_pos);
    each_car(sh, N, lane, [&](Car& c, JointK&, int n) {
      car_store(c, fout, lsout, static_cast<size_t>(e) * N + n, sn);
    });
  } else {
    solve_contact_island<true>(car, has_car, b0, sh, itab, ctab, p, NB, MM, lane, vel_iters,
                               pos_iters, k_vel, k_pos);
    if (has_car) car_store(car, fout, lsout, ci, sn);
  }
  store_impulses(sh, nio, tio, row0, MM, lane);
}

// kScratch false: warp w of the grid takes list entry w, its arrays in the
// block's dynamic shared memory. kScratch true (one warp a block, for N whose
// arrays do not fit a block's shared memory): warp w's arrays are slot w of
// `scratch`, and it takes entries w, w + the grid's warps, ... kWide (with
// kScratch, N > kLaneCars): a lane carries several cars.
template <bool kScratch, bool kWide>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
near_pass_kernel(const float* __restrict__ fin, const int* __restrict__ lsin,
                 const float* __restrict__ pni, const float* __restrict__ pti,
                 const int* __restrict__ pids, float* __restrict__ fout,
                 int* __restrict__ lsout, float* __restrict__ nio,
                 float* __restrict__ tio, int* __restrict__ idso,
                 const float* __restrict__ prm, const float* __restrict__ ctab,
                 const int* __restrict__ itab, const int* __restrict__ near_list,
                 const int* __restrict__ near_count, int E, int N, int MM,
                 int vel_iters, int pos_iters, int k_vel, int k_pos,
                 int warps_per_block, float* scratch) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int w = blockIdx.x * warps_per_block + warp;
  if constexpr (!kScratch) {
    if (w >= *near_count) return;           // whole warps only
    near_env<false>(near_list[w], lane,
                    smem + static_cast<size_t>(warp) * warp_smem_floats(N, MM), fin, lsin, pni,
                    pti, pids, fout, lsout, nio, tio, idso, prm, ctab, itab, E, N, MM, vel_iters,
                    pos_iters, k_vel, k_pos);
  } else {
    float* S = scratch + static_cast<size_t>(w) * warp_floats(N, MM);
    const int count = *near_count, stride = gridDim.x * warps_per_block;
    for (int i = w; i < count; i += stride) {  // the same count on every lane
      near_env<kWide>(near_list[i], lane, S, fin, lsin, pni, pti, pids, fout, lsout, nio,
                      tio, idso, prm, ctab, itab, E, N, MM, vel_iters, pos_iters, k_vel, k_pos);
      __syncwarp();                         // the slot's last reads before the next env
    }
  }
}

}  // namespace

extern "C" {

// The scratch the launch needs for E envs of N cars (MM rows each): 0 when
// one warp's arrays fit a block's shared memory on the current device (the
// launch takes no scratch); else the slots, the near pass's resident warps
// (at most E), each of contact_island_warp_floats(N, MM) floats (the
// wrapper may take fewer: fused_world.scratch_slots). Negative: a CUDA error
// code.
int contact_island_scratch_warps(int E, int N, int MM) {
  if (warp_fits_shared(N, MM)) return 0;
  return N > kLaneCars ? resident_warps(near_pass_kernel<true, true>, E)
                       : resident_warps(near_pass_kernel<true, false>, E);
}

long long contact_island_warp_floats(int N, int MM) {
  return static_cast<long long>(warp_floats(N, MM));
}

// Launches the island on `stream` for E envs of N >= 2 cars (MM manifold rows
// each): the far pass, then the near pass over the envs it listed.
// near_list (E ints) and near_count (1 int) are device buffers; the count is
// zeroed here and holds the number of near envs after the launch. With
// scratch_warps = 0 the near pass keeps each warp's arrays in shared memory
// (refused when they do not fit a block's); with scratch_warps > 0, in
// `scratch`, scratch_warps slots of contact_island_warp_floats(N, MM) floats,
// whose offsets within a slot are ints (refused past INT_MAX floats a slot).
// Returns the CUDA error after the launches (0 on success); does not
// synchronise.
int contact_island_launch(const float* fin, const int* lsin, const float* pni,
                          const float* pti, const int* pids, float* fout, int* lsout,
                          float* nio, float* tio, int* idso, const float* prm,
                          const float* ctab, const int* itab, int* near_list,
                          int* near_count, int E, int N, int MM, int vel_iters,
                          int pos_iters, int k_vel, int k_pos, float* scratch,
                          int scratch_warps, void* stream) {
  if (E <= 0) return 0;
  if (N < 2 || MM != N * (N - 1) / 2 * 48 || warp_floats(N, MM) > kMaxSlotFloats
      || scratch_warps < 0 || (scratch_warps > 0) != (scratch != nullptr)
      || (scratch_warps == 0 && !warp_fits_shared(N, MM))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(near_count, 0, sizeof(int), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_cars = E * N;
  far_pass_kernel<<<(n_cars + kFarThreads - 1) / kFarThreads, kFarThreads, 0, st>>>(
      fin, lsin, fout, lsout, nio, tio, idso, prm, ctab, near_list, near_count, E, N, MM,
      vel_iters, pos_iters);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  if (scratch_warps > 0) {
    if (N > kLaneCars) {
      near_pass_kernel<true, true><<<scratch_warps, 32, 0, st>>>(
          fin, lsin, pni, pti, pids, fout, lsout, nio, tio, idso, prm, ctab, itab, near_list,
          near_count, E, N, MM, vel_iters, pos_iters, k_vel, k_pos, 1, scratch);
    } else {
      near_pass_kernel<true, false><<<scratch_warps, 32, 0, st>>>(
          fin, lsin, pni, pti, pids, fout, lsout, nio, tio, idso, prm, ctab, itab, near_list,
          near_count, E, N, MM, vel_iters, pos_iters, k_vel, k_pos, 1, scratch);
    }
    return static_cast<int>(cudaGetLastError());
  }
  const size_t per_warp = warp_smem_floats(N, MM) * sizeof(float);
  const int warps = fit_warps_per_block(per_warp, kWarpsPerBlock);
  const size_t smem = warps * per_warp;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(near_pass_kernel<false, false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (E + warps - 1) / warps;
  near_pass_kernel<false, false><<<blocks, 32 * warps, smem, st>>>(
      fin, lsin, pni, pti, pids, fout, lsout, nio, tio, idso, prm, ctab, itab, near_list,
      near_count, E, N, MM, vel_iters, pos_iters, k_vel, k_pos, warps, nullptr);
  return static_cast<int>(cudaGetLastError());
}

const char* contact_island_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
