// The contact half of the island solve, shared by the port's two contact
// kernels: contact_island.cu (K2), whose rows come from its own Collide pass,
// and solve_island.cu (K3), whose rows are read from a ContactBundle made
// outside. Everything here is independent of where a row comes from: the
// warp's shared body and row arrays, make_bundle's row constants (lever arms
// from the centres of mass at init, normal and tangent masses), the contact
// warm start, the four velocity sub-passes of one velocity iteration, the
// position sub-passes, and the island solve that interleaves them with the
// car lanes' joint iterations (b2Island order).
//
// One warp per env. Lanes 0..N-1 each carry one car (car_chain.cuh); the
// env's MM = N(N-1)/2 * 48 manifold rows are spread over the 32 lanes (row r
// on lane r % 32). Body velocities and positions (5N slots, car*5 + j, j = 0
// hull, 1..4 wheels) and the rows' solver constants live in shared memory;
// the car lanes write their bodies there before each contact sub-pass and
// read them back after. Each contact sub-pass is Jacobi across rows: every
// lane computes its rows' impulse deltas from the same body state, then each
// body sums the deltas of its rows in the fixed order of the routing table
// (rows ascending, no atomics), so two launches on the same input give the
// same bits. The arithmetic follows the plain PyTorch version,
// multi_car_racing_tpu_torch/physics/collide.py (make_bundle, warm_start,
// velocity_pass, position_pass).

#pragma once

#include "car_chain.cuh"

namespace {

// Contact scalars, in the order of fused_world.CPARAM_NAMES; the fixtures'
// local vertices (8 x 8 x 2) and outward normals (8 x 8 x 2) follow them.
enum CParam {
  C_FRICTION, C_TOTAL_RADIUS, C_FLIP_BIAS, C_LINEAR_SLOP, C_BAUMGARTE,
  C_MAX_LIN_CORR, C_LC_X, C_LC_Y, C_HULL_MID_X, C_HULL_MID_Y,
  C_HULL_HALF_X, C_HULL_HALF_Y, C_WHEEL_HALF_X, C_WHEEL_HALF_Y, C_BP_SLACK,
  C_INV_M_HULL, C_INV_M_WHEEL, C_INV_I_HULL, C_INV_I_WHEEL,
  N_CPARAMS
};
constexpr int kVertsAt = N_CPARAMS;
constexpr int kNormalsAt = N_CPARAMS + 128;

// Shared memory per warp: body arrays (each 5N floats), then row arrays
// (each MM floats), then one int array of per-row live-point bits.
enum BodyArr { B_VX, B_VY, B_W, B_CX, B_CY, B_A, B_C0X, B_C0Y, B_OX, B_OY,
               B_COS, B_SIN, N_BODY_ARRS };
enum RowArr { R_NX, R_NY, R_RAX0, R_RAY0, R_RAX1, R_RAY1, R_RBX0, R_RBY0,
              R_RBX1, R_RBY1, R_NM0, R_NM1, R_TM0, R_TM1, R_SEP0, R_SEP1,
              R_NI0, R_NI1, R_TI0, R_TI1, R_DPX, R_DPY, R_DLA, R_DLB,
              N_ROW_ARRS };

// Floats of one warp's shared arrays at N cars and MM rows.
__host__ __device__ constexpr size_t warp_smem_floats(int N, int MM) {
  return static_cast<size_t>(N_BODY_ARRS) * 5 * N + static_cast<size_t>(N_ROW_ARRS) * MM + MM;
}

// One warp's shared arrays, addressed by index so that a subscript known
// only at run time is arithmetic, not a local-memory pointer table.
struct Shared {
  float* s;
  int NB, MM;
  __device__ __forceinline__ float* b(int q) const { return s + q * NB; }
  __device__ __forceinline__ float* r(int q) const { return s + N_BODY_ARRS * NB + q * MM; }
  __device__ __forceinline__ int* live() const {
    return reinterpret_cast<int*>(s + N_BODY_ARRS * NB + N_ROW_ARRS * MM);
  }
};

constexpr unsigned kFull = 0xffffffffu;

// The car's five bodies to / from the warp's shared body arrays.
__device__ __forceinline__ void put_velocities(const Car& c, const Shared& sh, int b0) {
  sh.b(B_VX)[b0] = c.hvx; sh.b(B_VY)[b0] = c.hvy; sh.b(B_W)[b0] = c.hw;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    sh.b(B_VX)[b0 + 1 + k] = c.wvx[k]; sh.b(B_VY)[b0 + 1 + k] = c.wvy[k];
    sh.b(B_W)[b0 + 1 + k] = c.ww[k];
  }
}

__device__ __forceinline__ void get_velocities(Car& c, const Shared& sh, int b0) {
  c.hvx = sh.b(B_VX)[b0]; c.hvy = sh.b(B_VY)[b0]; c.hw = sh.b(B_W)[b0];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    c.wvx[k] = sh.b(B_VX)[b0 + 1 + k]; c.wvy[k] = sh.b(B_VY)[b0 + 1 + k];
    c.ww[k] = sh.b(B_W)[b0 + 1 + k];
  }
}

__device__ __forceinline__ void put_positions(const Car& c, const Shared& sh, int b0) {
  sh.b(B_CX)[b0] = c.hcx; sh.b(B_CY)[b0] = c.hcy; sh.b(B_A)[b0] = c.ha;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    sh.b(B_CX)[b0 + 1 + k] = c.wcx[k]; sh.b(B_CY)[b0 + 1 + k] = c.wcy[k];
    sh.b(B_A)[b0 + 1 + k] = c.wa[k];
  }
}

__device__ __forceinline__ void get_positions(Car& c, const Shared& sh, int b0) {
  c.hcx = sh.b(B_CX)[b0]; c.hcy = sh.b(B_CY)[b0]; c.ha = sh.b(B_A)[b0];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    c.wcx[k] = sh.b(B_CX)[b0 + 1 + k]; c.wcy[k] = sh.b(B_CY)[b0 + 1 + k];
    c.wa[k] = sh.b(B_A)[b0 + 1 + k];
  }
}

// make_bundle for row r between bodies ba (side A) and bb (side B): the
// manifold (normal, contact points p1 and p2, separations) and its warm
// impulses into the shared row arrays, with the lever arms from the
// centres of mass at init (B_CX, B_CY, which hold the pre-solve poses) and
// the effective normal and tangent masses.
__device__ __forceinline__ void put_row(const Shared& sh, int r, int ba, int bb,
                                        const float* __restrict__ ctab, float nx, float ny,
                                        float p1x, float p1y, float p2x, float p2y, float s1,
                                        float s2, float ni0, float ni1, float ti0, float ti1) {
  const float ma = (ba % 5 == 0) ? ctab[C_INV_M_HULL] : ctab[C_INV_M_WHEEL];
  const float mb = (bb % 5 == 0) ? ctab[C_INV_M_HULL] : ctab[C_INV_M_WHEEL];
  const float ia = (ba % 5 == 0) ? ctab[C_INV_I_HULL] : ctab[C_INV_I_WHEEL];
  const float ib = (bb % 5 == 0) ? ctab[C_INV_I_HULL] : ctab[C_INV_I_WHEEL];
  const float cax = sh.b(B_CX)[ba], cay = sh.b(B_CY)[ba], cbx = sh.b(B_CX)[bb], cby = sh.b(B_CY)[bb];
  sh.r(R_NX)[r] = nx;
  sh.r(R_NY)[r] = ny;
  sh.r(R_SEP0)[r] = s1;
  sh.r(R_SEP1)[r] = s2;
  sh.r(R_NI0)[r] = ni0;
  sh.r(R_NI1)[r] = ni1;
  sh.r(R_TI0)[r] = ti0;
  sh.r(R_TI1)[r] = ti1;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const float qx = k == 0 ? p1x : p2x, qy = k == 0 ? p1y : p2y;
    const float rax = qx - cax, ray = qy - cay, rbx = qx - cbx, rby = qy - cby;
    sh.r(R_RAX0 + 2 * k)[r] = rax;
    sh.r(R_RAY0 + 2 * k)[r] = ray;
    sh.r(R_RBX0 + 2 * k)[r] = rbx;
    sh.r(R_RBY0 + 2 * k)[r] = rby;
    // normal axis (nx, ny), tangent axis (ny, -nx)
    const float cna = rax * ny - ray * nx, cnb = rbx * ny - rby * nx;
    const float kn = ma + mb + ia * (cna * cna) + ib * (cnb * cnb);
    const float cta = rax * -nx - ray * ny, ctb = rbx * -nx - rby * ny;
    const float kt = ma + mb + ia * (cta * cta) + ib * (ctb * ctb);
    sh.r(R_NM0 + k)[r] = kn > 0.f ? 1.f / fmaxf(kn, 1e-12f) : 0.f;
    sh.r(R_TM0 + k)[r] = kt > 0.f ? 1.f / fmaxf(kt, 1e-12f) : 0.f;
  }
}

// Every body b (lane-strided) adds the deltas of its live rows, in the
// routing table's fixed order: x += (sum_B dp - sum_A dp) * inv_m,
// a += (sum_B dlb - sum_A dla) * inv_i.
__device__ __forceinline__ void apply_to_bodies(float* bx, float* by, float* ba,
                                                const Shared& sh,
                                                const int* __restrict__ offsets,
                                                const int* __restrict__ entries,
                                                const float* __restrict__ ctab,
                                                int NB, int lane) {
  for (int b = lane; b < NB; b += 32) {
    float sbx = 0.f, sby = 0.f, sbw = 0.f, sax = 0.f, say = 0.f, saw = 0.f;
    for (int q = offsets[b]; q < offsets[b + 1]; ++q) {
      const int ent = entries[q];
      const int r = ent >> 1;
      if (sh.live()[r] == 0) continue;
      if (ent & 1) {
        sbx += sh.r(R_DPX)[r];
        sby += sh.r(R_DPY)[r];
        sbw += sh.r(R_DLB)[r];
      } else {
        sax += sh.r(R_DPX)[r];
        say += sh.r(R_DPY)[r];
        saw += sh.r(R_DLA)[r];
      }
    }
    const bool hull = b % 5 == 0;
    const float im = hull ? ctab[C_INV_M_HULL] : ctab[C_INV_M_WHEEL];
    const float ii = hull ? ctab[C_INV_I_HULL] : ctab[C_INV_I_WHEEL];
    bx[b] = bx[b] + (sbx - sax) * im;
    by[b] = by[b] + (sby - say) * im;
    ba[b] = ba[b] + (sbw - saw) * ii;
  }
}

// The row's impulse (px, py) at point k as its routed deltas.
__device__ __forceinline__ void put_delta(const Shared& sh, int r, int k, float px, float py) {
  sh.r(R_DPX)[r] = px;
  sh.r(R_DPY)[r] = py;
  sh.r(R_DLA)[r] = sh.r(R_RAX0 + 2 * k)[r] * py - sh.r(R_RAY0 + 2 * k)[r] * px;
  sh.r(R_DLB)[r] = sh.r(R_RBX0 + 2 * k)[r] * py - sh.r(R_RBY0 + 2 * k)[r] * px;
}

// The contact warm start (point 0, then point 1) on the shared velocities.
__device__ __forceinline__ void contact_warm_start(const Shared& sh,
                                                   const int* __restrict__ offsets,
                                                   const int* __restrict__ entries,
                                                   const float* __restrict__ ctab, int NB,
                                                   int MM, int lane) {
  for (int k = 0; k < 2; ++k) {
    for (int r = lane; r < MM; r += 32) {
      if (sh.live()[r] == 0) continue;
      const float nx = sh.r(R_NX)[r], ny = sh.r(R_NY)[r];
      const float ni = sh.r(R_NI0 + k)[r], ti = sh.r(R_TI0 + k)[r];
      put_delta(sh, r, k, ni * nx + ti * ny, ni * ny + ti * -nx);
    }
    __syncwarp();
    apply_to_bodies(sh.b(B_VX), sh.b(B_VY), sh.b(B_W), sh, offsets, entries, ctab, NB, lane);
    __syncwarp();
  }
}

// One velocity iteration's contact sub-passes on the shared velocities:
// friction at points 0 and 1, then normal at points 0 and 1.
__device__ __forceinline__ void contact_velocity_subpasses(const Shared& sh,
                                                           const int* __restrict__ itab,
                                                           const int* __restrict__ offsets,
                                                           const int* __restrict__ entries,
                                                           const float* __restrict__ ctab,
                                                           int NB, int MM, int lane) {
  const float friction = ctab[C_FRICTION];
#pragma unroll
  for (int sub = 0; sub < 4; ++sub) {
    const int k = sub & 1;
    const bool normal = sub >= 2;
    for (int r = lane; r < MM; r += 32) {
      if (sh.live()[r] == 0) continue;
      const int ba = itab[2 * MM + r], bb = itab[3 * MM + r];
      const float rax = sh.r(R_RAX0 + 2 * k)[r], ray = sh.r(R_RAY0 + 2 * k)[r];
      const float rbx = sh.r(R_RBX0 + 2 * k)[r], rby = sh.r(R_RBY0 + 2 * k)[r];
      const float wa = sh.b(B_W)[ba], wb = sh.b(B_W)[bb];
      const float dvx = (sh.b(B_VX)[bb] + -wb * rby) - (sh.b(B_VX)[ba] + -wa * ray);
      const float dvy = (sh.b(B_VY)[bb] + wb * rbx) - (sh.b(B_VY)[ba] + wa * rax);
      const float nx = sh.r(R_NX)[r], ny = sh.r(R_NY)[r];
      const bool ok = (sh.live()[r] >> k) & 1;
      float lam, ax, ay;
      if (normal) {
        const float old = sh.r(R_NI0 + k)[r];
        const float vn = dvx * nx + dvy * ny;
        const float nw = ok ? fmaxf(old + -sh.r(R_NM0 + k)[r] * vn, 0.f) : 0.f;
        lam = nw - old;
        sh.r(R_NI0 + k)[r] = nw;
        ax = nx;
        ay = ny;
      } else {
        const float old = sh.r(R_TI0 + k)[r];
        const float vt = dvx * ny + dvy * -nx;
        const float max_f = friction * sh.r(R_NI0 + k)[r];
        const float nw = ok ? fminf(fmaxf(old + -sh.r(R_TM0 + k)[r] * vt, -max_f), max_f) : 0.f;
        lam = nw - old;
        sh.r(R_TI0 + k)[r] = nw;
        ax = ny;
        ay = -nx;
      }
      put_delta(sh, r, k, lam * ax, lam * ay);
    }
    __syncwarp();
    apply_to_bodies(sh.b(B_VX), sh.b(B_VY), sh.b(B_W), sh, offsets, entries, ctab, NB, lane);
    __syncwarp();
  }
}

// One position iteration's contact sub-passes (points 0 and 1) on the shared
// positions: Baumgarte push-out along the manifold normal, the separation
// tracked by the rigid shift of the two centres of mass since init.
__device__ __forceinline__ void contact_position_subpasses(const Shared& sh,
                                                           const int* __restrict__ itab,
                                                           const int* __restrict__ offsets,
                                                           const int* __restrict__ entries,
                                                           const float* __restrict__ ctab,
                                                           int NB, int MM, int lane) {
  const float baumgarte = ctab[C_BAUMGARTE], slop = ctab[C_LINEAR_SLOP];
  const float max_corr = ctab[C_MAX_LIN_CORR];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    for (int r = lane; r < MM; r += 32) {
      if (sh.live()[r] == 0) continue;
      const int ba = itab[2 * MM + r], bb = itab[3 * MM + r];
      const float nx = sh.r(R_NX)[r], ny = sh.r(R_NY)[r];
      // Separation tracked by the rigid shift of the two centers of mass.
      const float shift = ((sh.b(B_CX)[bb] - sh.b(B_C0X)[bb]) - (sh.b(B_CX)[ba] - sh.b(B_C0X)[ba])) * nx
                          + ((sh.b(B_CY)[bb] - sh.b(B_C0Y)[bb]) - (sh.b(B_CY)[ba] - sh.b(B_C0Y)[ba])) * ny;
      const float sep = sh.r(R_SEP0 + k)[r] + shift;
      const float cc = clampf(baumgarte * (sep + slop), -max_corr, 0.f);
      const float imp = ((sh.live()[r] >> k) & 1) ? -cc * sh.r(R_NM0 + k)[r] : 0.f;
      put_delta(sh, r, k, imp * nx, imp * ny);
    }
    __syncwarp();
    apply_to_bodies(sh.b(B_CX), sh.b(B_CY), sh.b(B_A), sh, offsets, entries, ctab, NB, lane);
    __syncwarp();
  }
}

// The island solve of an env whose rows (put_row, live bits) and pre-solve
// centres of mass (B_C0X, B_C0Y) are in shared memory, and whose car lanes
// hold their cars after force integration and limit init, with the
// force-integrated velocities and pre-solve poses in the shared body arrays:
// contact warm start, then the joints'; velocity iterations (joints, then in
// the first k_vel the contact sub-passes); clamped integration; position
// iterations (in the first k_pos the contact sub-passes, then joints).
__device__ __forceinline__ void solve_contact_island(Car& car, bool has_car, int b0,
                                                     const Shared& sh,
                                                     const int* __restrict__ itab,
                                                     const int* __restrict__ offsets,
                                                     const int* __restrict__ entries,
                                                     const float* __restrict__ ctab,
                                                     const float* p, int NB, int MM, int lane,
                                                     int vel_iters, int pos_iters, int k_vel,
                                                     int k_pos) {
  contact_warm_start(sh, offsets, entries, ctab, NB, MM, lane);
  JointK jk;
  if (has_car) {
    get_velocities(car, sh, b0);
    joints_warm_start(car, jk, p);
  }
#pragma unroll 1
  for (int it = 0; it < vel_iters; ++it) {
    if (has_car) joints_velocity(car, jk, p);
    if (it >= k_vel) continue;
    if (has_car) put_velocities(car, sh, b0);
    __syncwarp();
    contact_velocity_subpasses(sh, itab, offsets, entries, ctab, NB, MM, lane);
    if (has_car) get_velocities(car, sh, b0);
  }
  if (has_car) integrate(car, p);
#pragma unroll 1
  for (int it = 0; it < pos_iters; ++it) {
    if (it < k_pos) {
      if (has_car) put_positions(car, sh, b0);
      __syncwarp();
      contact_position_subpasses(sh, itab, offsets, entries, ctab, NB, MM, lane);
      if (has_car) get_positions(car, sh, b0);
    }
    if (has_car) joints_position(car, p);
  }
}

// The env's solved impulses, rows (row0 + r) of the (E, MM, 2) outputs.
__device__ __forceinline__ void store_impulses(const Shared& sh, float* __restrict__ nio,
                                               float* __restrict__ tio, size_t row0, int MM,
                                               int lane) {
  for (int r = lane; r < MM; r += 32) {
    const size_t g = row0 + r;
    nio[g * 2] = sh.r(R_NI0)[r];
    nio[g * 2 + 1] = sh.r(R_NI1)[r];
    tio[g * 2] = sh.r(R_TI0)[r];
    tio[g * 2 + 1] = sh.r(R_TI1)[r];
  }
}

// The impulses of an env with no live contact: zeros.
__device__ __forceinline__ void store_zero_impulses(float* __restrict__ nio,
                                                    float* __restrict__ tio, size_t row0,
                                                    int MM, int lane) {
  for (int r = lane; r < MM; r += 32) {
    nio[(row0 + r) * 2] = 0.f;
    nio[(row0 + r) * 2 + 1] = 0.f;
    tio[(row0 + r) * 2] = 0.f;
    tio[(row0 + r) * 2 + 1] = 0.f;
  }
}

// The largest number of warps (at most `most`) per block whose shared arrays
// fit the 48 KB a block gets without opting in; at least 1.
inline int fit_warps_per_block(size_t per_warp_bytes, int most) {
  int warps = most;
  while (warps > 1 && warps * per_warp_bytes > 48 * 1024) --warps;
  return warps;
}

}  // namespace
