// The per-car chain of the physics island, shared by the port's island
// kernels (one car per thread in joints_island.cu, contact_island.cu's far
// pass and solve_island.cu's dead cars; one car per lane of an env's warp in
// contact_island.cu's near pass and solve_island.cu's live envs): the tire
// model with force integration (cd:172-266) -- or, for solve_island.cu, the
// force integration of a car the tire model has already run on -- the
// revolute-joint limit init, the joints' warm start and velocity iterations,
// Box2D's clamped position integration and the joints' position iterations,
// on one car held in registers. The arithmetic follows the plain PyTorch
// version, multi_car_racing_tpu_torch/physics/fused_world.py ::
// island_step_plain: fp32 throughout; precise sinf/cosf/sqrtf and division
// (no fast math); sign(0) == 0; 1/det through a select, never a division that
// is masked later.
//
// The chain is latency-bound: one car per thread, 240 dependent iterations,
// one warp per scheduler (joints_island.cu). Two things keep it short and
// keep every output bit of the branchy form it replaced (compare_parent.py
// holds K1, K2 and K3 byte-equal to their parents'):
// - joints_velocity and joints_position compute every limit-state path with
//   its own arithmetic unchanged and select the result, so the paths run
//   side by side on the chain and a warp whose cars differ in limit state
//   (the steered front joints, in most warps) does not run them in turn;
// - the hull angle's sine and cosine come from one sincosf, whose bits equal
//   sinf's and cosf's on every finite float with |x| <= 2^10 (checked
//   exhaustively on the card by compare_parent.py).

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

// Row offsets of the packed (rows, E*N) car buffers, car index e*N + n. Kept
// equal to fused_world.IN_ROWS / OUT_ROWS (checked by tests/test_torch_physics.py).
constexpr int IN_HULL = 0;      // vx, vy, w, cx, cy, a
constexpr int IN_WHEEL = 6;     // (vx, vy, w, cx, cy, a) x 4 wheels
constexpr int IN_TIRE = 30;     // (gas, brake, steer, spin, phase) x 4
constexpr int IN_FUEL = 50;
constexpr int IN_ONROAD = 51;   // 4 wheels, 1.0 on road
constexpr int IN_JNT = 55;      // (jix, jiy, jiz, motor) x 4
constexpr int N_IN = 71;
constexpr int OUT_HULL = 0;
constexpr int OUT_WHEEL = 6;
constexpr int OUT_JNT = 30;
constexpr int OUT_TIRE = 46;    // (spin, phase, skid) x 4
constexpr int OUT_FUEL = 58;
constexpr int N_OUT = 59;
// solve_island.cu's rows: a car after the tire model, with its wheel forces
// and servo speeds (fused_world.SOLVE_IN_ROWS); its output is the first
// N_SOLVE_OUT rows of the layout above (hull, wheels, joints).
constexpr int SIN_HULL = 0;     // vx, vy, w, cx, cy, a
constexpr int SIN_WHEEL = 6;    // (vx, vy, w, cx, cy, a) x 4 wheels
constexpr int SIN_FORCE = 30;   // (fx, fy) x 4
constexpr int SIN_MSPEED = 38;  // 4 wheels
constexpr int SIN_JNT = 42;     // (jix, jiy, jiz, motor) x 4
constexpr int N_SIN = 58;
constexpr int N_SOLVE_OUT = OUT_TIRE;

// Scalar parameters of the car chain, in the order of fused_world.PARAM_NAMES.
enum Param {
  P_DT, P_MA, P_IA, P_MB, P_IB, P_MOTOR_MASS, P_MA_MB, P_IA_IB,
  P_ARM_X0, P_ARM_X1, P_ARM_X2, P_ARM_X3,
  P_ARM_Y0, P_ARM_Y1, P_ARM_Y2, P_ARM_Y3,
  P_WHEEL_RAD, P_MAX_MOTOR, P_SERVO_GAIN, P_SERVO_MAX,
  P_FRICTION, P_FRICTION_GRASS, P_DT_ENGINE, P_WHEEL_I, P_BRAKE_FORCE,
  P_TIRE_STIFFNESS, P_LOWER, P_UPPER, P_ANG_SLOP, P_MAX_ANG_CORR,
  P_MAX_TRANS, P_MAX_TRANS2, P_MAX_ROT, P_MAX_ROT2, P_DT_MB,
  N_PARAMS
};

// jnp.sign: sign(0) == 0 (copysignf would give +-1 at a zero steering error).
__device__ __forceinline__ float sgnf(float x) {
  return x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f);
}

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// where(det != 0, 1/det, 0): a select, never a division that is masked later.
__device__ __forceinline__ float inv_or_zero(float det) {
  return det != 0.f ? 1.f / det : 0.f;
}

// Box2D's per-step translation and rotation clamps.
__device__ __forceinline__ void clamp_velocity(float& vx, float& vy, float& w,
                                               const float* p) {
  const float dt = p[P_DT];
  const float tx = dt * vx, ty = dt * vy;
  const float tr2 = tx * tx + ty * ty;
  const float s_t = tr2 > p[P_MAX_TRANS2]
                        ? p[P_MAX_TRANS] / sqrtf(fmaxf(tr2, 1e-30f)) : 1.f;
  const float rot = dt * w;
  const float s_r = rot * rot > p[P_MAX_ROT2]
                        ? p[P_MAX_ROT] / fmaxf(fabsf(rot), 1e-30f) : 1.f;
  vx *= s_t;
  vy *= s_t;
  w *= s_r;
}

// ---------------------------------------------------------------------------
// One car.
// ---------------------------------------------------------------------------

struct Car {
  float hvx, hvy, hw, hcx, hcy, ha;
  float wvx[4], wvy[4], ww[4], wcx[4], wcy[4], wa[4];
  float spin[4], phase[4], skid[4], mspeed[4];
  float jix[4], jiy[4], jiz[4], mimp[4];
  float fuel;
  int ls[4];
};

// The anchor arms and the joints' K-matrix terms, fixed over the velocity phase.
struct JointK {
  float rax[4], ray[4], k11[4], k12[4], k22[4], ezx[4], ezy[4], inv_det[4];
  float inv22[4], cx[4], cy[4], cz[4], cy2x[4], cy2y[4], cy2z[4];
  float cz3x[4], cz3y[4], cz3z[4];
};

// The joint limit-state init (b2RevoluteJoint::InitVelocityConstraints): a
// limit that is newly active, or was released, drops its accumulated
// impulse.
__device__ __forceinline__ void limit_init(Car& c, const float* p) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float ja = c.wa[k] - c.ha;
    const int nls = ja <= p[P_LOWER] ? 1 : (ja >= p[P_UPPER] ? 2 : 0);
    if (!(nls == c.ls[k] && nls != 0)) c.jiz[k] = 0.f;
    c.ls[k] = nls;
  }
}

// Loads car i, runs the tire model with force integration (cd:172-266) and
// the joint limit-state init.
__device__ __forceinline__ void car_begin(Car& c, const float* __restrict__ fin,
                                          const int* __restrict__ lsin, size_t i,
                                          size_t sn, const float* p) {
#define IN(r) fin[static_cast<size_t>(r) * sn + i]
  const float dt = p[P_DT];
  c.hvx = IN(IN_HULL + 0); c.hvy = IN(IN_HULL + 1); c.hw = IN(IN_HULL + 2);
  c.hcx = IN(IN_HULL + 3); c.hcy = IN(IN_HULL + 4); c.ha = IN(IN_HULL + 5);
  c.fuel = IN(IN_FUEL);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    c.wvx[k] = IN(IN_WHEEL + 0 + k);
    c.wvy[k] = IN(IN_WHEEL + 4 + k);
    c.ww[k] = IN(IN_WHEEL + 8 + k);
    c.wcx[k] = IN(IN_WHEEL + 12 + k);
    c.wcy[k] = IN(IN_WHEEL + 16 + k);
    c.wa[k] = IN(IN_WHEEL + 20 + k);
    c.jix[k] = IN(IN_JNT + 0 + k);
    c.jiy[k] = IN(IN_JNT + 4 + k);
    c.jiz[k] = IN(IN_JNT + 8 + k);
    c.mimp[k] = IN(IN_JNT + 12 + k);
    c.ls[k] = lsin[static_cast<size_t>(k) * sn + i];

    const float gas = IN(IN_TIRE + 0 + k), brake = IN(IN_TIRE + 4 + k);
    const float steer = IN(IN_TIRE + 8 + k), spin = IN(IN_TIRE + 12 + k);
    const float onroad = IN(IN_ONROAD + k);
    const float err = steer - (c.wa[k] - c.ha);
    c.mspeed[k] = sgnf(err) * fminf(p[P_SERVO_GAIN] * fabsf(err), p[P_SERVO_MAX]);
    const float fl = onroad > 0.f ? p[P_FRICTION] : p[P_FRICTION_GRASS];
    const float sw = sinf(c.wa[k]), cw = cosf(c.wa[k]);
    const float vf = -sw * c.wvx[k] + cw * c.wvy[k];
    const float vs = cw * c.wvx[k] + sw * c.wvy[k];
    float sp = spin + p[P_DT_ENGINE] * gas / (p[P_WHEEL_I] * (fabsf(spin) + 5.f));
    c.fuel = c.fuel + p[P_DT_ENGINE] * gas;
    const float bleed = sgnf(sp) * fminf(p[P_BRAKE_FORCE] * brake, fabsf(sp));
    sp = brake >= 0.9f ? 0.f : (brake > 0.f ? sp - bleed : sp);
    c.phase[k] = IN(IN_TIRE + 16 + k) + sp * dt;
    const float vr = sp * p[P_WHEEL_RAD];
    float f_f = (-vf + vr) * p[P_TIRE_STIFFNESS];
    float p_f = -vs * p[P_TIRE_STIFFNESS];
    const float force = sqrtf(f_f * f_f + p_f * p_f);
    c.skid[k] = fabsf(force) > 2.f * fl ? 1.f : 0.f;
    const float scale = fabsf(force) > fl ? fl / fmaxf(force, 1e-30f) : 1.f;
    f_f *= scale;
    p_f *= scale;
    c.spin[k] = sp - dt * f_f * p[P_WHEEL_RAD] / p[P_WHEEL_I];
    const float fx = p_f * cw + f_f * -sw;
    const float fy = p_f * sw + f_f * cw;
    c.wvx[k] = c.wvx[k] + p[P_DT_MB] * fx;
    c.wvy[k] = c.wvy[k] + p[P_DT_MB] * fy;
  }
#undef IN
  limit_init(c, p);
}

// Loads car i of solve_island.cu's rows (after the tire model), integrates
// its wheel forces as the plain world_step does, wv + (dt * MB) * force with
// each operation rounded on its own, and runs the joint limit-state init.
__device__ __forceinline__ void car_begin_solved(Car& c, const float* __restrict__ fin,
                                                 const int* __restrict__ lsin, size_t i,
                                                 size_t sn, const float* p) {
#define IN(r) fin[static_cast<size_t>(r) * sn + i]
  c.hvx = IN(SIN_HULL + 0); c.hvy = IN(SIN_HULL + 1); c.hw = IN(SIN_HULL + 2);
  c.hcx = IN(SIN_HULL + 3); c.hcy = IN(SIN_HULL + 4); c.ha = IN(SIN_HULL + 5);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    c.wvx[k] = __fadd_rn(IN(SIN_WHEEL + 0 + k), __fmul_rn(p[P_DT_MB], IN(SIN_FORCE + k)));
    c.wvy[k] = __fadd_rn(IN(SIN_WHEEL + 4 + k), __fmul_rn(p[P_DT_MB], IN(SIN_FORCE + 4 + k)));
    c.ww[k] = IN(SIN_WHEEL + 8 + k);
    c.wcx[k] = IN(SIN_WHEEL + 12 + k);
    c.wcy[k] = IN(SIN_WHEEL + 16 + k);
    c.wa[k] = IN(SIN_WHEEL + 20 + k);
    c.mspeed[k] = IN(SIN_MSPEED + k);
    c.jix[k] = IN(SIN_JNT + 0 + k);
    c.jiy[k] = IN(SIN_JNT + 4 + k);
    c.jiz[k] = IN(SIN_JNT + 8 + k);
    c.mimp[k] = IN(SIN_JNT + 12 + k);
    c.ls[k] = lsin[static_cast<size_t>(k) * sn + i];
  }
#undef IN
  limit_init(c, p);
}

// Anchor arms, joint warm start, and the K-matrix terms of the velocity phase.
__device__ __forceinline__ void joints_warm_start(Car& c, JointK& j, const float* p) {
  const float MA = p[P_MA], IA = p[P_IA], MB = p[P_MB], IB = p[P_IB];
  const float arm_x[4] = {p[P_ARM_X0], p[P_ARM_X1], p[P_ARM_X2], p[P_ARM_X3]};
  const float arm_y[4] = {p[P_ARM_Y0], p[P_ARM_Y1], p[P_ARM_Y2], p[P_ARM_Y3]};
  float sa, ca;
  sincosf(c.ha, &sa, &ca);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    j.rax[k] = ca * arm_x[k] - sa * arm_y[k];
    j.ray[k] = sa * arm_x[k] + ca * arm_y[k];
    const float ang = c.mimp[k] + c.jiz[k];
    c.hvx = c.hvx - MA * c.jix[k];
    c.hvy = c.hvy - MA * c.jiy[k];
    c.hw = c.hw - IA * (j.rax[k] * c.jiy[k] - j.ray[k] * c.jix[k] + ang);
    c.wvx[k] = c.wvx[k] + MB * c.jix[k];
    c.wvy[k] = c.wvy[k] + MB * c.jiy[k];
    c.ww[k] = c.ww[k] + IB * ang;
  }
  const float ezz = p[P_IA_IB];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    j.k11[k] = p[P_MA_MB] + IA * j.ray[k] * j.ray[k];
    j.k12[k] = -IA * j.rax[k] * j.ray[k];
    j.k22[k] = p[P_MA_MB] + IA * j.rax[k] * j.rax[k];
    j.ezx[k] = -IA * j.ray[k];
    j.ezy[k] = IA * j.rax[k];
    j.cx[k] = j.k22[k] * ezz - j.ezy[k] * j.ezy[k];
    j.cy[k] = j.ezy[k] * j.ezx[k] - j.k12[k] * ezz;
    j.cz[k] = j.k12[k] * j.ezy[k] - j.k22[k] * j.ezx[k];
    j.inv_det[k] = inv_or_zero(j.k11[k] * j.cx[k] + j.k12[k] * j.cy[k] + j.ezx[k] * j.cz[k]);
    j.cy2x[k] = j.ezx[k] * j.ezy[k] - j.k12[k] * ezz;
    j.cy2y[k] = j.k11[k] * ezz - j.ezx[k] * j.ezx[k];
    j.cy2z[k] = j.k12[k] * j.ezx[k] - j.k11[k] * j.ezy[k];
    j.cz3x[k] = j.k12[k] * j.ezy[k] - j.k22[k] * j.ezx[k];
    j.cz3y[k] = j.k12[k] * j.ezx[k] - j.k11[k] * j.ezy[k];
    j.cz3z[k] = j.k11[k] * j.k22[k] - j.k12[k] * j.k12[k];
    j.inv22[k] = inv_or_zero(j.k11[k] * j.k22[k] - j.k12[k] * j.k12[k]);
  }
}

// One velocity iteration of the car's four joints: motor, then point (+ limit).
__device__ __forceinline__ void joints_velocity(Car& c, const JointK& j, const float* p) {
  const float MA = p[P_MA], IA = p[P_IA], MB = p[P_MB], IB = p[P_IB];
  const float max_motor = p[P_MAX_MOTOR];
  const float motor_mass = p[P_MOTOR_MASS];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float cdot = c.ww[k] - c.hw - c.mspeed[k];
    const float m_new = clampf(c.mimp[k] - motor_mass * cdot, -max_motor, max_motor);
    const float m_imp = m_new - c.mimp[k];
    c.mimp[k] = m_new;
    c.hw = c.hw - IA * m_imp;
    c.ww[k] = c.ww[k] + IB * m_imp;

    const float bx = c.wvx[k] - c.hvx + c.hw * j.ray[k];
    const float by = c.wvy[k] - c.hvy - c.hw * j.rax[k];
    // Each limit-state path with its own arithmetic, then selects (above).
    const bool lim = c.ls[k] != 0;
    const float bz = c.ww[k] - c.hw;
    const float iz = -j.inv_det[k] * (bx * j.cz3x[k] + by * j.cz3y[k] + bz * j.cz3z[k]);
    const float new_z = c.jiz[k] + iz;
    const bool clampdown = (c.ls[k] == 1 && new_z < 0.f) || (c.ls[k] == 2 && new_z > 0.f);
    const float rhs_x = -bx + c.jiz[k] * j.ezx[k];
    const float rhs_y = -by + c.jiz[k] * j.ezy[k];
    const float cd_x = j.inv22[k] * (j.k22[k] * rhs_x - j.k12[k] * rhs_y);
    const float cd_y = j.inv22[k] * (j.k11[k] * rhs_y - j.k12[k] * rhs_x);
    const float fr_x = -j.inv_det[k] * (bx * j.cx[k] + by * j.cy[k] + bz * j.cz[k]);
    const float fr_y = -j.inv_det[k] * (bx * j.cy2x[k] + by * j.cy2y[k] + bz * j.cy2z[k]);
    const float pt_x = j.inv22[k] * (j.k22[k] * -bx - j.k12[k] * -by);
    const float pt_y = j.inv22[k] * (j.k11[k] * -by - j.k12[k] * -bx);
    const float imp_x = lim ? (clampdown ? cd_x : fr_x) : pt_x;
    const float imp_y = lim ? (clampdown ? cd_y : fr_y) : pt_y;
    const float imp_z = lim ? (clampdown ? -c.jiz[k] : iz) : 0.f;
    c.jiz[k] = lim ? (clampdown ? 0.f : new_z) : c.jiz[k];
    c.jix[k] = c.jix[k] + imp_x;
    c.jiy[k] = c.jiy[k] + imp_y;
    c.hvx = c.hvx - MA * imp_x;
    c.hvy = c.hvy - MA * imp_y;
    c.hw = c.hw - IA * (j.rax[k] * imp_y - j.ray[k] * imp_x + imp_z);
    c.wvx[k] = c.wvx[k] + MB * imp_x;
    c.wvy[k] = c.wvy[k] + MB * imp_y;
    c.ww[k] = c.ww[k] + IB * imp_z;
  }
}

// Position integration with Box2D's translation/rotation clamps.
__device__ __forceinline__ void integrate(Car& c, const float* p) {
  const float dt = p[P_DT];
  clamp_velocity(c.hvx, c.hvy, c.hw, p);
  c.hcx = c.hcx + dt * c.hvx;
  c.hcy = c.hcy + dt * c.hvy;
  c.ha = c.ha + dt * c.hw;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    clamp_velocity(c.wvx[k], c.wvy[k], c.ww[k], p);
    c.wcx[k] = c.wcx[k] + dt * c.wvx[k];
    c.wcy[k] = c.wcy[k] + dt * c.wvy[k];
    c.wa[k] = c.wa[k] + dt * c.ww[k];
  }
}

// One position iteration of the car's four joints (SolvePositionConstraints).
__device__ __forceinline__ void joints_position(Car& c, const float* p) {
  const float MA = p[P_MA], IA = p[P_IA], MB = p[P_MB], IB = p[P_IB];
  const float arm_x[4] = {p[P_ARM_X0], p[P_ARM_X1], p[P_ARM_X2], p[P_ARM_X3]};
  const float arm_y[4] = {p[P_ARM_Y0], p[P_ARM_Y1], p[P_ARM_Y2], p[P_ARM_Y3]};
  const float motor_mass = p[P_MOTOR_MASS];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float angle = c.wa[k] - c.ha;
    const float lo_lim = clampf(angle - p[P_LOWER] + p[P_ANG_SLOP], -p[P_MAX_ANG_CORR], 0.f);
    const float hi_lim = clampf(angle - p[P_UPPER] - p[P_ANG_SLOP], 0.f, p[P_MAX_ANG_CORR]);
    const float c_lim = c.ls[k] == 1 ? lo_lim : (c.ls[k] == 2 ? hi_lim : 0.f);
    const float li = -motor_mass * c_lim;
    c.ha = c.ha - IA * li;
    c.wa[k] = c.wa[k] + IB * li;

    float sp, cp;
    sincosf(c.ha, &sp, &cp);
    const float rx = cp * arm_x[k] - sp * arm_y[k];
    const float ry = sp * arm_x[k] + cp * arm_y[k];
    const float cvx = c.wcx[k] - c.hcx - rx;
    const float cvy = c.wcy[k] - c.hcy - ry;
    const float q11 = p[P_MA_MB] + IA * ry * ry;
    const float q12 = -IA * rx * ry;
    const float q22 = p[P_MA_MB] + IA * rx * rx;
    const float inv = inv_or_zero(q11 * q22 - q12 * q12);
    const float px = inv * (q22 * -cvx - q12 * -cvy);
    const float py = inv * (q11 * -cvy - q12 * -cvx);
    c.hcx = c.hcx - MA * px;
    c.hcy = c.hcy - MA * py;
    c.ha = c.ha - IA * (rx * py - ry * px);
    c.wcx[k] = c.wcx[k] + MB * px;
    c.wcy[k] = c.wcy[k] + MB * py;
  }
}

// The joints-only island of a car after its limit init: warm start,
// velocity iterations, clamped integration, position iterations.
__device__ __forceinline__ void joints_chain(Car& c, const float* p, int vel_iters,
                                             int pos_iters) {
  JointK jk;
  joints_warm_start(c, jk, p);
#pragma unroll 1
  for (int it = 0; it < vel_iters; ++it) joints_velocity(c, jk, p);
  integrate(c, p);
#pragma unroll 1
  for (int it = 0; it < pos_iters; ++it) joints_position(c, p);
}

// Stores the solved car: rows OUT_HULL..OUT_JNT and the limit states.
__device__ __forceinline__ void car_store_solved(const Car& c, float* __restrict__ fout,
                                                 int* __restrict__ lsout, size_t i,
                                                 size_t sn) {
#define OUT(r) fout[static_cast<size_t>(r) * sn + i]
  OUT(OUT_HULL + 0) = c.hvx;
  OUT(OUT_HULL + 1) = c.hvy;
  OUT(OUT_HULL + 2) = c.hw;
  OUT(OUT_HULL + 3) = c.hcx;
  OUT(OUT_HULL + 4) = c.hcy;
  OUT(OUT_HULL + 5) = c.ha;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    OUT(OUT_WHEEL + 0 + k) = c.wvx[k];
    OUT(OUT_WHEEL + 4 + k) = c.wvy[k];
    OUT(OUT_WHEEL + 8 + k) = c.ww[k];
    OUT(OUT_WHEEL + 12 + k) = c.wcx[k];
    OUT(OUT_WHEEL + 16 + k) = c.wcy[k];
    OUT(OUT_WHEEL + 20 + k) = c.wa[k];
    OUT(OUT_JNT + 0 + k) = c.jix[k];
    OUT(OUT_JNT + 4 + k) = c.jiy[k];
    OUT(OUT_JNT + 8 + k) = c.jiz[k];
    OUT(OUT_JNT + 12 + k) = c.mimp[k];
    lsout[static_cast<size_t>(k) * sn + i] = c.ls[k];
  }
#undef OUT
}

// Stores the car after the whole island: the solved rows, then the tire
// model's (spin, phase, skid) and the fuel.
__device__ __forceinline__ void car_store(const Car& c, float* __restrict__ fout,
                                          int* __restrict__ lsout, size_t i, size_t sn) {
  car_store_solved(c, fout, lsout, i, sn);
#define OUT(r) fout[static_cast<size_t>(r) * sn + i]
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    OUT(OUT_TIRE + 0 + k) = c.spin[k];
    OUT(OUT_TIRE + 4 + k) = c.phase[k];
    OUT(OUT_TIRE + 8 + k) = c.skid[k];
  }
  OUT(OUT_FUEL) = c.fuel;
#undef OUT
}


}  // namespace
