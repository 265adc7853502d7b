// The contact half of the island solve, shared by the port's two contact
// kernels: contact_island.cu (K2), whose rows come from its own Collide pass,
// and solve_island.cu (K3), whose rows are read from a ContactBundle made
// outside. Everything here is independent of where a row comes from: the
// warp's shared body and row arrays, make_bundle's row constants (lever arms
// from the centres of mass at init, normal and tangent masses), the compact
// lists of live rows and live routing entries, the contact warm start, the
// four velocity sub-passes of one velocity iteration, the position
// sub-passes, and the island solve that interleaves them with the car lanes'
// joint iterations (b2Island order).
//
// One warp per env. Lanes 0..N-1 each carry one car (car_chain.cuh). Body
// velocities and positions (5N slots, car*5 + j, j = 0 hull, 1..4 wheels)
// and the rows' solver constants (row r of the env's MM = N(N-1)/2 * 48
// manifold rows at index r) live in shared memory; the car lanes write their
// bodies there before each contact sub-pass and read them back after.
//
// Live-row compaction. A row's live bits are fixed for the whole solve, so
// once per step (build_live_lists) the warp lists its live rows in ascending
// order (a __ballot_sync and a __popc prefix per 32-row chunk), each packed
// with its two body slots, and, for each body, its live routing entries in
// the routing table's order with their count. Every contact sub-pass then
// walks only these: lanes i < L take live row i (looping when L > 32), and
// each body lane adds only its live entries. Each sub-pass is Jacobi across
// rows: every lane computes its rows' impulse deltas from the same body
// state, then each body sums the deltas of its live rows in the fixed order
// of the routing table (rows ascending, no atomics). A dead row adds nothing
// to any sum, so every sum adds the same terms in the same order as a walk
// over all rows would, and two launches on the same input give the same
// bits. Inside the solve's 240 iterations nothing is read from global
// memory: the lists, the bodies' inverse masses and inertias and the contact
// scalars are staged in shared memory once.
//
// What sits in registers. In K2's near pass (kResident), when L <= 32,
// 5N <= 32 and no body has more than kBodyEntries live entries (the usual
// near env has 1-6 live rows), lane i holds live row i's constants and
// impulses (a Row) and lane b holds body b's live entries and inverse mass
// and inertia (a BodyList) for the whole solve, so a sub-pass reads from
// shared memory only the bodies' state and the rows' deltas, and a body adds
// its entries through selects rather than branches. Otherwise each sub-pass
// reads what it needs from shared memory. K3 (kResident false) always does:
// the registers (218 against 168) make a lone live warp ~8% faster but cost
// the occupancy that a batch of live envs needs (all-near 15% slower). Each
// choice was timed against the others on the card.
//
// The arithmetic follows the plain PyTorch version,
// multi_car_racing_tpu_torch/physics/collide.py (make_bundle, warm_start,
// velocity_pass, position_pass); the lists are fused_world.live_routing's.

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
// (each MM floats), then the int arrays: per-row live-point bits (MM), the
// live rows (MM, packed row | body_a << 16 | body_b << 24), the live routing
// entries (2 MM, each body's at its routing-table offset), each body's span
// of them (5N, offset | count << 16); then the contact scalars of the solve.
enum BodyArr { B_VX, B_VY, B_W, B_CX, B_CY, B_A, B_C0X, B_C0Y, B_OX, B_OY,
               B_COS, B_SIN, B_IM, B_II, N_BODY_ARRS };
enum RowArr { R_NX, R_NY, R_RAX0, R_RAY0, R_RAX1, R_RAY1, R_RBX0, R_RBY0,
              R_RBX1, R_RBY1, R_NM0, R_NM1, R_TM0, R_TM1, R_SEP0, R_SEP1,
              R_NI0, R_NI1, R_TI0, R_TI1, R_DPX, R_DPY, R_DLA, R_DLB,
              N_ROW_ARRS };
enum SolveScalar { S_FRICTION, S_BAUMGARTE, S_SLOP, S_MAX_CORR, N_SOLVE_SCALARS };

// Floats of one warp's shared arrays at N cars and MM rows.
__host__ __device__ constexpr size_t warp_smem_floats(int N, int MM) {
  return static_cast<size_t>(N_BODY_ARRS + 1) * 5 * N + static_cast<size_t>(N_ROW_ARRS + 4) * MM
         + N_SOLVE_SCALARS;
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
  __device__ __forceinline__ unsigned* lrow() const {
    return reinterpret_cast<unsigned*>(live() + MM);
  }
  __device__ __forceinline__ int* lent() const { return live() + 2 * MM; }
  __device__ __forceinline__ int* lspan() const { return live() + 4 * MM; }
  __device__ __forceinline__ float* scalars() const {
    return reinterpret_cast<float*>(lspan() + NB);
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
                                                const Shared& sh, int NB, int lane) {
  for (int b = lane; b < NB; b += 32) {
    const int span = sh.lspan()[b];
    const int* ent = sh.lent() + (span & 0xffff);
    const int cnt = span >> 16;
    float sbx = 0.f, sby = 0.f, sbw = 0.f, sax = 0.f, say = 0.f, saw = 0.f;
    for (int q = 0; q < cnt; ++q) {
      const int e = ent[q];
      const int r = e >> 1;
      if (e & 1) {
        sbx += sh.r(R_DPX)[r];
        sby += sh.r(R_DPY)[r];
        sbw += sh.r(R_DLB)[r];
      } else {
        sax += sh.r(R_DPX)[r];
        say += sh.r(R_DPY)[r];
        saw += sh.r(R_DLA)[r];
      }
    }
    const float im = sh.b(B_IM)[b], ii = sh.b(B_II)[b];
    bx[b] = bx[b] + (sbx - sax) * im;
    by[b] = by[b] + (sby - say) * im;
    ba[b] = ba[b] + (sbw - saw) * ii;
  }
}

// A body's live routing entries (up to kBodyEntries) and its inverse mass
// and inertia, held in registers by the body's lane.
constexpr int kBodyEntries = 4;
struct BodyList {
  int cnt;
  int e[kBodyEntries];
  float im, ii;
};

__device__ __forceinline__ void load_body_list(BodyList& bl, const Shared& sh, int b) {
  const int span = sh.lspan()[b];
  bl.cnt = span >> 16;
#pragma unroll
  for (int q = 0; q < kBodyEntries; ++q) {
    bl.e[q] = q < bl.cnt ? sh.lent()[(span & 0xffff) + q] : 0;
  }
  bl.im = sh.b(B_IM)[b];
  bl.ii = sh.b(B_II)[b];
}

// apply_to_bodies for a warp whose body b is lane b's and whose bodies have
// at most kBodyEntries live entries each, from the lanes' BodyLists: the
// same sums in the same order.
__device__ __forceinline__ void apply_resident(float* bx, float* by, float* ba,
                                               const Shared& sh, const BodyList& bl, int NB,
                                               int lane) {
  if (lane >= NB) return;
  float sbx = 0.f, sby = 0.f, sbw = 0.f, sax = 0.f, say = 0.f, saw = 0.f;
#pragma unroll
  for (int q = 0; q < kBodyEntries; ++q) {
    if (q < bl.cnt) {
      // A sum that starts at +0 never holds -0, so adding +0 to it is exact:
      // the selects add the same terms in the same order as the branches.
      const int e = bl.e[q];
      const int r = e >> 1, side = e & 1;
      const float px = sh.r(R_DPX)[r], py = sh.r(R_DPY)[r], pw = sh.r(R_DLA + side)[r];
      sbx += side ? px : 0.f;
      sby += side ? py : 0.f;
      sbw += side ? pw : 0.f;
      sax += side ? 0.f : px;
      say += side ? 0.f : py;
      saw += side ? 0.f : pw;
    }
  }
  bx[lane] = bx[lane] + (sbx - sax) * bl.im;
  by[lane] = by[lane] + (sby - say) * bl.im;
  ba[lane] = ba[lane] + (sbw - saw) * bl.ii;
}

// The compact lists of the solve, from the live bits in sh.live() and the
// routing table itab (fused_world.contact_index_table): the live rows in
// ascending order, each packed with its two body slots; each body's live
// entries, in the table's order, at the body's own table offset, and their
// count; the bodies' inverse masses and inertias; the contact scalars.
// Returns L, the number of live rows (the same on every lane). Ends with a
// __syncwarp.
__device__ __forceinline__ int build_live_lists(const Shared& sh, const int* __restrict__ itab,
                                                const float* __restrict__ ctab, int NB,
                                                int MM, int lane) {
  const int* body_a = itab + 2 * MM;
  const int* body_b = itab + 3 * MM;
  const int* offsets = itab + 4 * MM;
  const int* entries = offsets + NB + 1;
  int L = 0;
  for (int r0 = 0; r0 < MM; r0 += 32) {
    const int r = r0 + lane;
    const bool live = r < MM && sh.live()[r] != 0;
    const unsigned m = __ballot_sync(kFull, live);
    if (live) {
      sh.lrow()[L + __popc(m & ((1u << lane) - 1u))] =
          static_cast<unsigned>(r) | (static_cast<unsigned>(body_a[r]) << 16)
          | (static_cast<unsigned>(body_b[r]) << 24);
    }
    L += __popc(m);
  }
  for (int b = lane; b < NB; b += 32) {
    const int beg = offsets[b], end = offsets[b + 1];
    int cnt = 0;
    for (int q = beg; q < end; ++q) {
      const int e = entries[q];
      if (sh.live()[e >> 1] != 0) sh.lent()[beg + cnt++] = e;
    }
    sh.lspan()[b] = beg | (cnt << 16);
    const bool hull = b % 5 == 0;
    sh.b(B_IM)[b] = hull ? ctab[C_INV_M_HULL] : ctab[C_INV_M_WHEEL];
    sh.b(B_II)[b] = hull ? ctab[C_INV_I_HULL] : ctab[C_INV_I_WHEEL];
  }
  if (lane == 0) {
    sh.scalars()[S_FRICTION] = ctab[C_FRICTION];
    sh.scalars()[S_BAUMGARTE] = ctab[C_BAUMGARTE];
    sh.scalars()[S_SLOP] = ctab[C_LINEAR_SLOP];
    sh.scalars()[S_MAX_CORR] = ctab[C_MAX_LIN_CORR];
  }
  __syncwarp();
  return L;
}

// Row r, body_a and body_b of a packed live row.
__device__ __forceinline__ int live_row(unsigned pk) { return static_cast<int>(pk & 0xffffu); }
__device__ __forceinline__ int live_body_a(unsigned pk) {
  return static_cast<int>((pk >> 16) & 0xffu);
}
__device__ __forceinline__ int live_body_b(unsigned pk) { return static_cast<int>(pk >> 24); }

// A live row's solver constants and impulses (the shared row arrays at
// index r), held in registers by the lane that owns the row.
struct Row {
  int r, ba, bb, live;
  float nx, ny, rax[2], ray[2], rbx[2], rby[2], nm[2], tm[2], sep[2], ni[2], ti[2];
};

__device__ __forceinline__ void load_row(Row& w, const Shared& sh, unsigned pk) {
  w.r = live_row(pk);
  w.ba = live_body_a(pk);
  w.bb = live_body_b(pk);
  const int r = w.r;
  w.live = sh.live()[r];
  w.nx = sh.r(R_NX)[r];
  w.ny = sh.r(R_NY)[r];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    w.rax[k] = sh.r(R_RAX0 + 2 * k)[r];
    w.ray[k] = sh.r(R_RAY0 + 2 * k)[r];
    w.rbx[k] = sh.r(R_RBX0 + 2 * k)[r];
    w.rby[k] = sh.r(R_RBY0 + 2 * k)[r];
    w.nm[k] = sh.r(R_NM0 + k)[r];
    w.tm[k] = sh.r(R_TM0 + k)[r];
    w.sep[k] = sh.r(R_SEP0 + k)[r];
    w.ni[k] = sh.r(R_NI0 + k)[r];
    w.ti[k] = sh.r(R_TI0 + k)[r];
  }
}

__device__ __forceinline__ void store_row_impulses(const Row& w, const Shared& sh) {
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    sh.r(R_NI0 + k)[w.r] = w.ni[k];
    sh.r(R_TI0 + k)[w.r] = w.ti[k];
  }
}

// The row's impulse (px, py) at point k as its routed deltas.
__device__ __forceinline__ void row_delta(const Row& w, const Shared& sh, int k, float px,
                                          float py) {
  sh.r(R_DPX)[w.r] = px;
  sh.r(R_DPY)[w.r] = py;
  sh.r(R_DLA)[w.r] = w.rax[k] * py - w.ray[k] * px;
  sh.r(R_DLB)[w.r] = w.rbx[k] * py - w.rby[k] * px;
}

// Point k's warm-start impulse of one row.
__device__ __forceinline__ void row_warm(const Row& w, const Shared& sh, int k) {
  const float ni = w.ni[k], ti = w.ti[k];
  row_delta(w, sh, k, ni * w.nx + ti * w.ny, ni * w.ny + ti * -w.nx);
}

// One row's friction (normal == false) or normal step at point k.
__device__ __forceinline__ void row_velocity(Row& w, const Shared& sh, int k, bool normal,
                                             float friction) {
  const int ba = w.ba, bb = w.bb;
  const float nx = w.nx, ny = w.ny;
  const float wa = sh.b(B_W)[ba], wb = sh.b(B_W)[bb];
  const float dvx = (sh.b(B_VX)[bb] + -wb * w.rby[k]) - (sh.b(B_VX)[ba] + -wa * w.ray[k]);
  const float dvy = (sh.b(B_VY)[bb] + wb * w.rbx[k]) - (sh.b(B_VY)[ba] + wa * w.rax[k]);
  const bool ok = (w.live >> k) & 1;
  float lam, ax, ay;
  if (normal) {
    const float old = w.ni[k];
    const float vn = dvx * nx + dvy * ny;
    const float nw = ok ? fmaxf(old + -w.nm[k] * vn, 0.f) : 0.f;
    lam = nw - old;
    w.ni[k] = nw;
    ax = nx;
    ay = ny;
  } else {
    const float old = w.ti[k];
    const float vt = dvx * ny + dvy * -nx;
    const float max_f = friction * w.ni[k];
    const float nw = ok ? fminf(fmaxf(old + -w.tm[k] * vt, -max_f), max_f) : 0.f;
    lam = nw - old;
    w.ti[k] = nw;
    ax = ny;
    ay = -nx;
  }
  row_delta(w, sh, k, lam * ax, lam * ay);
}

// One row's Baumgarte push-out at point k, the separation tracked by the
// rigid shift of the two centres of mass since init.
__device__ __forceinline__ void row_position(const Row& w, const Shared& sh, int k,
                                             float baumgarte, float slop, float max_corr) {
  const int ba = w.ba, bb = w.bb;
  const float nx = w.nx, ny = w.ny;
  const float shift = ((sh.b(B_CX)[bb] - sh.b(B_C0X)[bb]) - (sh.b(B_CX)[ba] - sh.b(B_C0X)[ba])) * nx
                      + ((sh.b(B_CY)[bb] - sh.b(B_C0Y)[bb]) - (sh.b(B_CY)[ba] - sh.b(B_C0Y)[ba])) * ny;
  const float sep = w.sep[k] + shift;
  const float cc = clampf(baumgarte * (sep + slop), -max_corr, 0.f);
  const float imp = ((w.live >> k) & 1) ? -cc * w.nm[k] : 0.f;
  row_delta(w, sh, k, imp * nx, imp * ny);
}

// The contact warm start (point 0, then point 1) on the shared velocities.
__device__ __forceinline__ void contact_warm_start(const Shared& sh, int L, int NB, int lane,
                                                   bool resident, const Row& mine,
                                                   const BodyList& bl) {
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    if (resident) {
      if (lane < L) row_warm(mine, sh, k);
    } else {
      for (int i = lane; i < L; i += 32) {
        Row w;
        load_row(w, sh, sh.lrow()[i]);
        row_warm(w, sh, k);
      }
    }
    __syncwarp();
    if (resident) {
      apply_resident(sh.b(B_VX), sh.b(B_VY), sh.b(B_W), sh, bl, NB, lane);
    } else {
      apply_to_bodies(sh.b(B_VX), sh.b(B_VY), sh.b(B_W), sh, NB, lane);
    }
    __syncwarp();
  }
}

// One velocity iteration's contact sub-passes on the shared velocities:
// friction at points 0 and 1, then normal at points 0 and 1.
__device__ __forceinline__ void contact_velocity_subpasses(const Shared& sh, int L, int NB,
                                                           int lane, bool resident, Row& mine,
                                                           const BodyList& bl) {
  const float friction = sh.scalars()[S_FRICTION];
#pragma unroll
  for (int sub = 0; sub < 4; ++sub) {
    const int k = sub & 1;
    const bool normal = sub >= 2;
    if (resident) {
      if (lane < L) row_velocity(mine, sh, k, normal, friction);
    } else {
      for (int i = lane; i < L; i += 32) {
        Row w;
        load_row(w, sh, sh.lrow()[i]);
        row_velocity(w, sh, k, normal, friction);
        if (normal) {
          sh.r(R_NI0 + k)[w.r] = w.ni[k];
        } else {
          sh.r(R_TI0 + k)[w.r] = w.ti[k];
        }
      }
    }
    __syncwarp();
    if (resident) {
      apply_resident(sh.b(B_VX), sh.b(B_VY), sh.b(B_W), sh, bl, NB, lane);
    } else {
      apply_to_bodies(sh.b(B_VX), sh.b(B_VY), sh.b(B_W), sh, NB, lane);
    }
    __syncwarp();
  }
}

// One position iteration's contact sub-passes (points 0 and 1) on the shared
// positions.
__device__ __forceinline__ void contact_position_subpasses(const Shared& sh, int L, int NB,
                                                           int lane, bool resident,
                                                           const Row& mine, const BodyList& bl) {
  const float baumgarte = sh.scalars()[S_BAUMGARTE], slop = sh.scalars()[S_SLOP];
  const float max_corr = sh.scalars()[S_MAX_CORR];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    if (resident) {
      if (lane < L) row_position(mine, sh, k, baumgarte, slop, max_corr);
    } else {
      for (int i = lane; i < L; i += 32) {
        Row w;
        load_row(w, sh, sh.lrow()[i]);
        row_position(w, sh, k, baumgarte, slop, max_corr);
      }
    }
    __syncwarp();
    if (resident) {
      apply_resident(sh.b(B_CX), sh.b(B_CY), sh.b(B_A), sh, bl, NB, lane);
    } else {
      apply_to_bodies(sh.b(B_CX), sh.b(B_CY), sh.b(B_A), sh, NB, lane);
    }
    __syncwarp();
  }
}

// The island solve of an env whose rows (put_row, live bits) and pre-solve
// centres of mass (B_C0X, B_C0Y) are in shared memory, and whose car lanes
// hold their cars after force integration and limit init, with the
// force-integrated velocities and pre-solve poses in the shared body arrays:
// the compact lists, then the contact warm start and the joints'; velocity
// iterations (joints, then in the first k_vel the contact sub-passes);
// clamped integration; position iterations (in the first k_pos the contact
// sub-passes, then joints). The solved impulses end in the shared row arrays.
// kResident: hold the rows and the bodies' entry lists in registers where
// they fit (K2's near pass; see the note at the top).
template <bool kResident>
__device__ __forceinline__ void solve_contact_island(Car& car, bool has_car, int b0,
                                                     const Shared& sh,
                                                     const int* __restrict__ itab,
                                                     const float* __restrict__ ctab,
                                                     const float* p, int NB, int MM, int lane,
                                                     int vel_iters, int pos_iters, int k_vel,
                                                     int k_pos) {
  const int L = build_live_lists(sh, itab, ctab, NB, MM, lane);
  BodyList bl;
  if (kResident && lane < NB) load_body_list(bl, sh, lane);
  const bool resident = kResident && L <= 32 && NB <= 32
                        && !__any_sync(kFull, lane < NB && bl.cnt > kBodyEntries);
  Row mine;
  if (resident && lane < L) load_row(mine, sh, sh.lrow()[lane]);
  contact_warm_start(sh, L, NB, lane, resident, mine, bl);
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
    contact_velocity_subpasses(sh, L, NB, lane, resident, mine, bl);
    if (has_car) get_velocities(car, sh, b0);
  }
  if (has_car) integrate(car, p);
#pragma unroll 1
  for (int it = 0; it < pos_iters; ++it) {
    if (it < k_pos) {
      if (has_car) put_positions(car, sh, b0);
      __syncwarp();
      contact_position_subpasses(sh, L, NB, lane, resident, mine, bl);
      if (has_car) get_positions(car, sh, b0);
    }
    if (has_car) joints_position(car, p);
  }
  if (resident && lane < L) store_row_impulses(mine, sh);
  __syncwarp();
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

// The largest number of warps (at most `most`) per block whose shared arrays
// fit the 48 KB a block gets without opting in; at least 1.
inline int fit_warps_per_block(size_t per_warp_bytes, int most) {
  int warps = most;
  while (warps > 1 && warps * per_warp_bytes > 48 * 1024) --warps;
  return warps;
}

}  // namespace
