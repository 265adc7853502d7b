// Solve-only physics island, one warp per env: force integration, the
// revolute-joint limit init and the Gauss-Seidel island solve of Box2D
// 2.3.5's world.Step (warm start, velocity iterations, clamped integration,
// position iterations) with the car-car contact sub-passes interleaved, from
// manifolds and warm impulses computed outside the kernel. No tire model and
// no Collide pass: the input cars are the tire model's output, and the rows
// are a ContactBundle's (the plain collide.collide and make_bundle, or the
// JAX package's carried over by convert.bundle_from_numpy).
//
// Replaces the TPU kernel multi_car_racing_tpu/physics/pallas_world.py ::
// _make_solve_kernel (pallas_call at :1237 through world_step_batched
// :1181). The arithmetic follows the plain PyTorch version,
// multi_car_racing_tpu_torch/physics/world.py :: world_step with the same
// bundle. It is the harness that holds K2 (contact_island.cu) apart: K2
// against the plain Collide pass followed by this kernel separates K2's
// in-kernel Collide from its solve, and gives the solve's own time.
//
// Layout. As contact_island.cu (contact_rows.cuh): one warp per env, lanes
// 0..N-1 carry the cars' chains in registers (car_chain.cuh's
// car_begin_solved loads a car after the tire model), the MM rows are spread
// over the lanes, bodies and row constants sit in shared memory, and every
// per-body impulse sum runs in the routing table's fixed order, so two
// launches give the same bits. Each row is read once from global memory,
// from the bundle's contiguous (E, MM, ...) tensors: normal, points,
// separations, point_ok (bytes) and warm impulses. A row's live bits are its
// point_ok; warm impulses on points that are not ok are taken as zero, so
// their solved impulses are zero too. The lever arms and masses are
// make_bundle's, from the input poses (the centres of mass at init).
//
// Branch. An env with no bundle (MM = 0), or none of whose rows has a live
// point, runs the joints-only chain: every contact sub-pass would add exact
// zeros. The branch is warp-uniform.
//
// What the TPU kernel did that this one does not: the env-minor (..., E)
// lane layout, the 0/1 incidence matmuls that route rows to bodies
// (_contact_tbls) and the VMEM block specs (_grid_eb, _specs) answer the
// TPU's vector lanes and matrix unit; here a body walks its own row list.
//
// What bounds it. K1's joints chain less the tire model (~5.3e4 fp32 ops
// per car), plus per live contact point ~66 ops per contact velocity
// iteration and ~30 per position iteration (fused_world.solve_island_flops
// counts what the data needs). The bytes are the cars' rows and the
// bundle's rows (~66 bytes per row). The bound is operations, but as in K2
// the solve is a chain of 240 dependent iterations per env with 8 warp
// barriers per contact velocity iteration, so latency sets the time.
//
// Arithmetic: fp32 throughout; precise sinf/cosf/sqrtf and division (no fast
// math); sign(0) == 0; 1/det through a select.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC (multi_car_racing_tpu_torch/_cuda.py); plain C interface
// loaded with ctypes.

#include "contact_rows.cuh"

namespace {

constexpr int kWarpsPerBlock = 4;

__global__ void __launch_bounds__(32 * kWarpsPerBlock)
solve_island_kernel(const float* __restrict__ fin, const int* __restrict__ lsin,
                    const float* __restrict__ normal, const float* __restrict__ point,
                    const float* __restrict__ sep, const unsigned char* __restrict__ ok,
                    const float* __restrict__ ni_in, const float* __restrict__ ti_in,
                    float* __restrict__ fout, int* __restrict__ lsout,
                    float* __restrict__ nio, float* __restrict__ tio,
                    const float* __restrict__ prm, const float* __restrict__ ctab,
                    const int* __restrict__ itab, int E, int N, int MM, int vel_iters,
                    int pos_iters, int k_vel, int k_pos, int warps_per_block) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int e = blockIdx.x * warps_per_block + warp;
  if (e >= E) return;                       // whole warps only
  const int NB = 5 * N;
  const size_t sn = static_cast<size_t>(E) * N;
  const size_t ci = static_cast<size_t>(e) * N + lane;   // this lane's car
  const bool has_car = lane < N;
  const int b0 = lane * 5;                 // the car's hull slot

  float p[N_PARAMS];
#pragma unroll
  for (int q = 0; q < N_PARAMS; ++q) p[q] = prm[q];

  Car car;
  if (has_car) car_begin_solved(car, fin, lsin, ci, sn, p);

  float* S = smem + static_cast<size_t>(warp) * warp_smem_floats(N, MM);
  const Shared sh{S, NB, MM};
  const size_t row0 = static_cast<size_t>(e) * MM;
  bool my_live = false;
  for (int r = lane; r < MM; r += 32) {
    const size_t g = row0 + r;
    const int live = static_cast<int>(ok[g * 2] != 0) | (static_cast<int>(ok[g * 2 + 1] != 0) << 1);
    sh.live()[r] = live;
    my_live = my_live || live != 0;
  }
  if (!__any_sync(kFull, my_live)) {
    // No bundle, or no live point: the joints-only chain.
    if (has_car) {
      joints_chain(car, p, vel_iters, pos_iters);
      car_store_solved(car, fout, lsout, ci, sn);
    }
    store_zero_impulses(nio, tio, row0, MM, lane);
    return;
  }

  // ---- pre-solve poses (the centres of mass at init) and the
  // force-integrated velocities.
  if (has_car) {
    put_velocities(car, sh, b0);
    put_positions(car, sh, b0);
  }
  __syncwarp();
  for (int b = lane; b < NB; b += 32) {
    sh.b(B_C0X)[b] = sh.b(B_CX)[b];
    sh.b(B_C0Y)[b] = sh.b(B_CY)[b];
  }

  // ---- the bundle's rows into the shared row arrays.
  for (int r = lane; r < MM; r += 32) {
    const size_t g = row0 + r;
    const int live = sh.live()[r];
    const bool ok0 = live & 1, ok1 = (live >> 1) & 1;
    put_row(sh, r, itab[2 * MM + r], itab[3 * MM + r], ctab, normal[g * 2], normal[g * 2 + 1],
            point[g * 4], point[g * 4 + 1], point[g * 4 + 2], point[g * 4 + 3], sep[g * 2],
            sep[g * 2 + 1], ok0 ? ni_in[g * 2] : 0.f, ok1 ? ni_in[g * 2 + 1] : 0.f,
            ok0 ? ti_in[g * 2] : 0.f, ok1 ? ti_in[g * 2 + 1] : 0.f);
  }
  __syncwarp();

  const int* offsets = itab + 4 * MM;
  const int* entries = offsets + NB + 1;
  solve_contact_island(car, has_car, b0, sh, itab, offsets, entries, ctab, p, NB, MM, lane,
                       vel_iters, pos_iters, k_vel, k_pos);
  if (has_car) car_store_solved(car, fout, lsout, ci, sn);
  store_impulses(sh, nio, tio, row0, MM, lane);
}

}  // namespace

extern "C" {

// Launches the solve on `stream` for E envs of N cars, with MM = N(N-1)/2 *
// 48 bundle rows each (N >= 2), or MM = 0 and null row pointers for the
// joints-only island (any N). Returns the CUDA error after the launch (0 on
// success); does not synchronise.
int solve_island_launch(const float* fin, const int* lsin, const float* normal,
                        const float* point, const float* sep, const unsigned char* ok,
                        const float* ni_in, const float* ti_in, float* fout, int* lsout,
                        float* nio, float* tio, const float* prm, const float* ctab,
                        const int* itab, int E, int N, int MM, int vel_iters, int pos_iters,
                        int k_vel, int k_pos, void* stream) {
  if (E <= 0) return 0;
  if (N < 1 || N > 32 || (MM != 0 && (N < 2 || MM != N * (N - 1) / 2 * 48))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t per_warp = warp_smem_floats(N, MM) * sizeof(float);
  const int warps = fit_warps_per_block(per_warp, kWarpsPerBlock);
  const size_t smem = warps * per_warp;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        solve_island_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (E + warps - 1) / warps;
  solve_island_kernel<<<blocks, 32 * warps, smem, static_cast<cudaStream_t>(stream)>>>(
      fin, lsin, normal, point, sep, ok, ni_in, ti_in, fout, lsout, nio, tio, prm, ctab, itab,
      E, N, MM, vel_iters, pos_iters, k_vel, k_pos, warps);
  return static_cast<int>(cudaGetLastError());
}

const char* solve_island_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
