// Joints-only physics island for one car per thread: tire model, force
// integration, revolute-joint limit init, and the Gauss-Seidel island solve
// (warm start, velocity iterations, clamped integration, position
// iterations) of Box2D 2.3.5's world.Step for a hull and four wheels.
//
// Replaces the TPU kernel multi_car_racing_tpu/physics/pallas_world.py ::
// _make_mega_kernel(force_no_contacts=True) (the whole N=1 solver, and the
// joints-only base of every partitioned N>=2 step). The arithmetic follows
// the plain PyTorch version, multi_car_racing_tpu_torch/physics/fused_world.py
// :: island_step_plain (tire_step -> init_constraints -> world_step).
//
// What bounds it. Per car-step the work is about 5.4e4 fp32 operations
// (counted in fused_world.py: ~48 per joint per velocity iteration x 4 joints
// x 180, ~77 per joint per position iteration x 4 x 60, with sin/cos and
// division counted as 8), so ~2.2e8 at E=4096 -- about 3.3 us at the card's
// 67 TFLOP/s fp32 rate. The state read and written is ~550 bytes per car
// (~2.3 MB at E=4096, under 1 us at 3.35 TB/s). So the bound is operations;
// but each car's solve is a chain of 240 dependent iterations, and with one
// car per thread 4096 threads cannot fill 132 SMs' issue slots, so the
// latency of that chain, not throughput, sets the time: expect far above the
// bound.
//
// What the design does about it. Gauss-Seidel runs the four joints of a car
// in order through the shared hull velocity, so one car is one thread: the
// whole state (hull, 4 wheels, 16 impulse accumulators, limit states) stays
// in registers for all 240 iterations, and the K-matrix terms that are fixed
// over the velocity phase are computed once per step. Inputs and outputs are
// struct-of-arrays rows of E*N floats, so neighbouring threads read
// neighbouring cars (coalesced). Blocks of 64 threads give 64 blocks at
// E=4096, fewer than the 132 SMs: the first thing a later tuning pass looks
// at. fp32 throughout; precise sinf/cosf/sqrtf and division (no fast math).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC (multi_car_racing_tpu_torch/_cuda.py); plain C interface
// loaded with ctypes.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

// Row offsets of the packed (rows, E*N) input and output buffers. Kept equal
// to fused_world.IN_ROWS / OUT_ROWS (checked by tests/test_torch_physics.py).
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

// Scalar parameters, in the order of fused_world.PARAM_NAMES.
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

constexpr int kThreads = 64;

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

__global__ void __launch_bounds__(kThreads)
joints_island_kernel(const float* __restrict__ fin, const int* __restrict__ lsin,
                     float* __restrict__ fout, int* __restrict__ lsout,
                     const float* __restrict__ prm, int n, int vel_iters,
                     int pos_iters) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const size_t sn = static_cast<size_t>(n);
#define IN(r) fin[static_cast<size_t>(r) * sn + i]
#define OUT(r) fout[static_cast<size_t>(r) * sn + i]

  float p[N_PARAMS];
#pragma unroll
  for (int q = 0; q < N_PARAMS; ++q) p[q] = prm[q];
  const float dt = p[P_DT];
  const float MA = p[P_MA], IA = p[P_IA], MB = p[P_MB], IB = p[P_IB];
  const float arm_x[4] = {p[P_ARM_X0], p[P_ARM_X1], p[P_ARM_X2], p[P_ARM_X3]};
  const float arm_y[4] = {p[P_ARM_Y0], p[P_ARM_Y1], p[P_ARM_Y2], p[P_ARM_Y3]};

  // ---- load the car.
  float hvx = IN(IN_HULL + 0), hvy = IN(IN_HULL + 1), hw = IN(IN_HULL + 2);
  float hcx = IN(IN_HULL + 3), hcy = IN(IN_HULL + 4), ha = IN(IN_HULL + 5);
  float wvx[4], wvy[4], ww[4], wcx[4], wcy[4], wa[4];
  float gas[4], brake[4], steer[4], spin[4], phase[4], onroad[4];
  float jix[4], jiy[4], jiz[4], mimp[4];
  int ls[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    wvx[k] = IN(IN_WHEEL + 0 + k);
    wvy[k] = IN(IN_WHEEL + 4 + k);
    ww[k] = IN(IN_WHEEL + 8 + k);
    wcx[k] = IN(IN_WHEEL + 12 + k);
    wcy[k] = IN(IN_WHEEL + 16 + k);
    wa[k] = IN(IN_WHEEL + 20 + k);
    gas[k] = IN(IN_TIRE + 0 + k);
    brake[k] = IN(IN_TIRE + 4 + k);
    steer[k] = IN(IN_TIRE + 8 + k);
    spin[k] = IN(IN_TIRE + 12 + k);
    phase[k] = IN(IN_TIRE + 16 + k);
    onroad[k] = IN(IN_ONROAD + k);
    jix[k] = IN(IN_JNT + 0 + k);
    jiy[k] = IN(IN_JNT + 4 + k);
    jiz[k] = IN(IN_JNT + 8 + k);
    mimp[k] = IN(IN_JNT + 12 + k);
    ls[k] = lsin[static_cast<size_t>(k) * sn + i];
  }
  float fuel = IN(IN_FUEL);

  // ---- 1. tire model (cd:172-266) and force integration.
  float mspeed[4], skid[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float err = steer[k] - (wa[k] - ha);
    mspeed[k] = sgnf(err) * fminf(p[P_SERVO_GAIN] * fabsf(err), p[P_SERVO_MAX]);
    const float fl = onroad[k] > 0.f ? p[P_FRICTION] : p[P_FRICTION_GRASS];
    const float sw = sinf(wa[k]), cw = cosf(wa[k]);
    const float vf = -sw * wvx[k] + cw * wvy[k];   // forward = (-sin, cos)
    const float vs = cw * wvx[k] + sw * wvy[k];    // side = (cos, sin)
    float sp = spin[k] + p[P_DT_ENGINE] * gas[k] /
                             (p[P_WHEEL_I] * (fabsf(spin[k]) + 5.f));
    fuel = fuel + p[P_DT_ENGINE] * gas[k];
    const float bleed = sgnf(sp) * fminf(p[P_BRAKE_FORCE] * brake[k], fabsf(sp));
    sp = brake[k] >= 0.9f ? 0.f : (brake[k] > 0.f ? sp - bleed : sp);
    phase[k] = phase[k] + sp * dt;
    const float vr = sp * p[P_WHEEL_RAD];
    float f_f = (-vf + vr) * p[P_TIRE_STIFFNESS];
    float p_f = -vs * p[P_TIRE_STIFFNESS];
    const float force = sqrtf(f_f * f_f + p_f * p_f);
    skid[k] = fabsf(force) > 2.f * fl ? 1.f : 0.f;
    const float scale = fabsf(force) > fl ? fl / fmaxf(force, 1e-30f) : 1.f;
    f_f *= scale;
    p_f *= scale;
    spin[k] = sp - dt * f_f * p[P_WHEEL_RAD] / p[P_WHEEL_I];
    const float fx = p_f * cw + f_f * -sw;
    const float fy = p_f * sw + f_f * cw;
    wvx[k] = wvx[k] + p[P_DT_MB] * fx;
    wvy[k] = wvy[k] + p[P_DT_MB] * fy;
  }

  // ---- 2. joint limit states (b2RevoluteJoint::InitVelocityConstraints):
  // the accumulated limit impulse survives only in the same active state.
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float ja = wa[k] - ha;
    const int nls = ja <= p[P_LOWER] ? 1 : (ja >= p[P_UPPER] ? 2 : 0);
    if (!(nls == ls[k] && nls != 0)) jiz[k] = 0.f;
    ls[k] = nls;
  }

  // ---- 3. anchor arms, warm start.
  const float sa = sinf(ha), ca = cosf(ha);
  float rax[4], ray[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    rax[k] = ca * arm_x[k] - sa * arm_y[k];
    ray[k] = sa * arm_x[k] + ca * arm_y[k];
    const float ang = mimp[k] + jiz[k];
    hvx = hvx - MA * jix[k];
    hvy = hvy - MA * jiy[k];
    hw = hw - IA * (rax[k] * jiy[k] - ray[k] * jix[k] + ang);
    wvx[k] = wvx[k] + MB * jix[k];
    wvy[k] = wvy[k] + MB * jiy[k];
    ww[k] = ww[k] + IB * ang;
  }

  // The 3x3 point+limit K matrix, its cofactors and both inverse scales are
  // fixed over the velocity phase: compute them once.
  const float ezz = p[P_IA_IB];
  float k11[4], k12[4], k22[4], ezx[4], ezy[4], inv_det[4], inv22[4];
  float cx[4], cy[4], cz[4], cy2x[4], cy2y[4], cy2z[4], cz3x[4], cz3y[4], cz3z[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    k11[k] = p[P_MA_MB] + IA * ray[k] * ray[k];
    k12[k] = -IA * rax[k] * ray[k];
    k22[k] = p[P_MA_MB] + IA * rax[k] * rax[k];
    ezx[k] = -IA * ray[k];
    ezy[k] = IA * rax[k];
    cx[k] = k22[k] * ezz - ezy[k] * ezy[k];
    cy[k] = ezy[k] * ezx[k] - k12[k] * ezz;
    cz[k] = k12[k] * ezy[k] - k22[k] * ezx[k];
    inv_det[k] = inv_or_zero(k11[k] * cx[k] + k12[k] * cy[k] + ezx[k] * cz[k]);
    cy2x[k] = ezx[k] * ezy[k] - k12[k] * ezz;
    cy2y[k] = k11[k] * ezz - ezx[k] * ezx[k];
    cy2z[k] = k12[k] * ezx[k] - k11[k] * ezy[k];
    cz3x[k] = k12[k] * ezy[k] - k22[k] * ezx[k];
    cz3y[k] = k12[k] * ezx[k] - k11[k] * ezy[k];
    cz3z[k] = k11[k] * k22[k] - k12[k] * k12[k];
    inv22[k] = inv_or_zero(k11[k] * k22[k] - k12[k] * k12[k]);
  }

  // ---- 4. velocity iterations: motor, then point (+ limit), joint by joint.
  const float max_motor = p[P_MAX_MOTOR];
  const float motor_mass = p[P_MOTOR_MASS];
#pragma unroll 1
  for (int it = 0; it < vel_iters; ++it) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float cdot = ww[k] - hw - mspeed[k];
      const float m_new = clampf(mimp[k] - motor_mass * cdot, -max_motor, max_motor);
      const float m_imp = m_new - mimp[k];
      mimp[k] = m_new;
      hw = hw - IA * m_imp;
      ww[k] = ww[k] + IB * m_imp;

      const float bx = wvx[k] - hvx + hw * ray[k];
      const float by = wvy[k] - hvy - hw * rax[k];
      float imp_x, imp_y, imp_z;
      if (ls[k] != 0) {
        const float bz = ww[k] - hw;
        const float iz = -inv_det[k] * (bx * cz3x[k] + by * cz3y[k] + bz * cz3z[k]);
        const float new_z = jiz[k] + iz;
        const bool clampdown = (ls[k] == 1 && new_z < 0.f) || (ls[k] == 2 && new_z > 0.f);
        if (clampdown) {
          // Reduced 2x2 solve when the limit impulse unwinds to zero.
          const float rhs_x = -bx + jiz[k] * ezx[k];
          const float rhs_y = -by + jiz[k] * ezy[k];
          imp_x = inv22[k] * (k22[k] * rhs_x - k12[k] * rhs_y);
          imp_y = inv22[k] * (k11[k] * rhs_y - k12[k] * rhs_x);
          imp_z = -jiz[k];
          jiz[k] = 0.f;
        } else {
          imp_x = -inv_det[k] * (bx * cx[k] + by * cy[k] + bz * cz[k]);
          imp_y = -inv_det[k] * (bx * cy2x[k] + by * cy2y[k] + bz * cy2z[k]);
          imp_z = iz;
          jiz[k] = new_z;
        }
      } else {
        imp_x = inv22[k] * (k22[k] * -bx - k12[k] * -by);
        imp_y = inv22[k] * (k11[k] * -by - k12[k] * -bx);
        imp_z = 0.f;
      }
      jix[k] = jix[k] + imp_x;
      jiy[k] = jiy[k] + imp_y;
      hvx = hvx - MA * imp_x;
      hvy = hvy - MA * imp_y;
      hw = hw - IA * (rax[k] * imp_y - ray[k] * imp_x + imp_z);
      wvx[k] = wvx[k] + MB * imp_x;
      wvy[k] = wvy[k] + MB * imp_y;
      ww[k] = ww[k] + IB * imp_z;
    }
  }

  // ---- 5. integrate positions with the translation/rotation clamps.
  clamp_velocity(hvx, hvy, hw, p);
  hcx = hcx + dt * hvx;
  hcy = hcy + dt * hvy;
  ha = ha + dt * hw;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    clamp_velocity(wvx[k], wvy[k], ww[k], p);
    wcx[k] = wcx[k] + dt * wvx[k];
    wcy[k] = wcy[k] + dt * wvy[k];
    wa[k] = wa[k] + dt * ww[k];
  }

  // ---- 6. position iterations (b2RevoluteJoint::SolvePositionConstraints).
#pragma unroll 1
  for (int it = 0; it < pos_iters; ++it) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float angle = wa[k] - ha;
      float c_lim = 0.f;
      if (ls[k] == 1) {
        c_lim = clampf(angle - p[P_LOWER] + p[P_ANG_SLOP], -p[P_MAX_ANG_CORR], 0.f);
      } else if (ls[k] == 2) {
        c_lim = clampf(angle - p[P_UPPER] - p[P_ANG_SLOP], 0.f, p[P_MAX_ANG_CORR]);
      }
      const float li = -motor_mass * c_lim;
      ha = ha - IA * li;
      wa[k] = wa[k] + IB * li;

      const float sp = sinf(ha), cp = cosf(ha);
      const float rx = cp * arm_x[k] - sp * arm_y[k];
      const float ry = sp * arm_x[k] + cp * arm_y[k];
      const float cvx = wcx[k] - hcx - rx;
      const float cvy = wcy[k] - hcy - ry;
      const float q11 = p[P_MA_MB] + IA * ry * ry;
      const float q12 = -IA * rx * ry;
      const float q22 = p[P_MA_MB] + IA * rx * rx;
      const float inv = inv_or_zero(q11 * q22 - q12 * q12);
      const float px = inv * (q22 * -cvx - q12 * -cvy);
      const float py = inv * (q11 * -cvy - q12 * -cvx);
      hcx = hcx - MA * px;
      hcy = hcy - MA * py;
      ha = ha - IA * (rx * py - ry * px);
      wcx[k] = wcx[k] + MB * px;
      wcy[k] = wcy[k] + MB * py;
    }
  }

  // ---- write the car back.
  OUT(OUT_HULL + 0) = hvx;
  OUT(OUT_HULL + 1) = hvy;
  OUT(OUT_HULL + 2) = hw;
  OUT(OUT_HULL + 3) = hcx;
  OUT(OUT_HULL + 4) = hcy;
  OUT(OUT_HULL + 5) = ha;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    OUT(OUT_WHEEL + 0 + k) = wvx[k];
    OUT(OUT_WHEEL + 4 + k) = wvy[k];
    OUT(OUT_WHEEL + 8 + k) = ww[k];
    OUT(OUT_WHEEL + 12 + k) = wcx[k];
    OUT(OUT_WHEEL + 16 + k) = wcy[k];
    OUT(OUT_WHEEL + 20 + k) = wa[k];
    OUT(OUT_JNT + 0 + k) = jix[k];
    OUT(OUT_JNT + 4 + k) = jiy[k];
    OUT(OUT_JNT + 8 + k) = jiz[k];
    OUT(OUT_JNT + 12 + k) = mimp[k];
    OUT(OUT_TIRE + 0 + k) = spin[k];
    OUT(OUT_TIRE + 4 + k) = phase[k];
    OUT(OUT_TIRE + 8 + k) = skid[k];
    lsout[static_cast<size_t>(k) * sn + i] = ls[k];
  }
  OUT(OUT_FUEL) = fuel;
#undef IN
#undef OUT
}

}  // namespace

extern "C" {

// Launches the island on `stream` for n = E*N cars. Returns cudaGetLastError()
// after the launch (0 on success); does not synchronise.
int joints_island_launch(const float* fin, const int* lsin, float* fout,
                         int* lsout, const float* prm, int n, int vel_iters,
                         int pos_iters, void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + kThreads - 1) / kThreads;
  joints_island_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      fin, lsin, fout, lsout, prm, n, vel_iters, pos_iters);
  return static_cast<int>(cudaGetLastError());
}

const char* joints_island_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
