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
// loaded with ctypes. The chain itself, the row layout and the parameters
// are car_chain.cuh's, shared with contact_island.cu and solve_island.cu.

#include "car_chain.cuh"

namespace {

constexpr int kThreads = 64;

__global__ void __launch_bounds__(kThreads)
joints_island_kernel(const float* __restrict__ fin, const int* __restrict__ lsin,
                     float* __restrict__ fout, int* __restrict__ lsout,
                     const float* __restrict__ prm, int n, int vel_iters,
                     int pos_iters) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const size_t sn = static_cast<size_t>(n);
  float p[N_PARAMS];
#pragma unroll
  for (int q = 0; q < N_PARAMS; ++q) p[q] = prm[q];

  Car car;
  car_begin(car, fin, lsin, i, sn, p);        // tire model, limit states
  joints_chain(car, p, vel_iters, pos_iters);
  car_store(car, fout, lsout, i, sn);
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
