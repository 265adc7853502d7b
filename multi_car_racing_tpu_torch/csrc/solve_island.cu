// Solve-only physics island: force integration, the revolute-joint limit
// init and the Gauss-Seidel island solve of Box2D 2.3.5's world.Step (warm
// start, velocity iterations, clamped integration, position iterations)
// with the car-car contact sub-passes interleaved, from manifolds and warm
// impulses computed outside the kernel. No tire model and no Collide pass:
// the input cars are the tire model's output, and the rows are a
// ContactBundle's (the plain collide.collide and make_bundle, or the JAX
// package's carried over by convert.bundle_from_numpy).
//
// Replaces the TPU kernel multi_car_racing_tpu/physics/pallas_world.py ::
// _make_solve_kernel (pallas_call at :1237 through world_step_batched
// :1181). The arithmetic follows the plain PyTorch version,
// multi_car_racing_tpu_torch/physics/world.py :: world_step with the same
// bundle. It is the harness that holds K2 (contact_island.cu) apart: K2
// against the plain Collide pass followed by this kernel separates K2's
// in-kernel Collide from its solve, and gives the solve's own time.
//
// Two launches, both made by solve_island_launch (one K3 call):
//
// 1. The list pass (made only with a bundle), one thread per env: the env
//    is live if any point_ok byte of its MM rows is set (2 MM bytes, a
//    multiple of 96, read as 16-byte words from a tensor that starts on a
//    16-byte boundary); a live env appends itself to a
//    device-side list (a warp-aggregated atomicAdd on the list's int count;
//    the list's order is not deterministic, but each env's outputs depend
//    only on that env). The count is never read on the host.
// 2. The solve pass, one warp a block. Its first ceil(E N / 32) blocks take
//    one car a thread (the dead cars): a car whose env has no live point
//    (or every car, without a bundle: MM = 0 and no list pass) would add
//    exact zeros in every contact sub-pass, so it is a single-car island:
//    car_chain.cuh's car_begin_solved -> joints_chain -> car_store_solved,
//    then the car's share of the env's zero impulses (rows n, n + N, ...);
//    a car of a live env returns. The E blocks after those take the list's
//    entries, block w entry w, and return at once past the count: one warp
//    per live env, as contact_rows.cuh sets out. Above N = 9, where a
//    warp's arrays do not fit a block's shared memory, as many blocks as
//    the solve pass keeps resident follow the dead ones instead, each with
//    a slot of a global scratch buffer, looping over the list. Lanes
//    0..N-1 carry the cars' chains in registers (above N = 32, kLaneCars,
//    lane l carries cars l, l + 32, ..., each car's chain state in the
//    warp's slot: the kWide instance), the MM rows are spread
//    over the lanes, bodies and row constants sit in the warp's arrays
//    (shared memory, or the scratch slot), the solve walks only
//    the live rows and each body's live routing entries, and every
//    per-body impulse sum runs in the routing table's fixed order, so two
//    launches give the same bits. Each row is read once from the bundle's
//    contiguous (E, MM, ...) tensors: normal, points, separations, point_ok
//    (bytes) and warm impulses. A row's live bits are its point_ok; warm
//    impulses on points that are not ok are taken as zero, so their solved
//    impulses are zero too. The lever arms and masses are make_bundle's,
//    from the input poses (the centres of mass at init).
//
// Why one launch for both: the dead cars' chain (~0.09 ms at E = 4096, K1's
// less the tire model) then runs beside the live warps' (~0.5 ms) instead of
// before it; as a launch of its own ahead of the live warps it made the
// N = 4 input 10% slower than one warp for every env. One warp a block lets
// a live warp start as soon as a warp's registers are free, wherever its
// neighbours in the list are (four-warp blocks were slower). The dead
// blocks come first: the live blocks that find no entry then return while
// dead cars run (15% off the all-dead inputs, within 0.5% elsewhere). Each
// layout was timed against the others on the card (PERF.md, K3's design steps).
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
// bundle's rows (~66 bytes per row). The bound is operations, but every
// car's chain is 240 dependent iterations and a live env's has 8 warp
// barriers per contact velocity iteration, so latency sets the time: the
// chain of one live warp, with only live envs on warps and the dead cars a
// thread each beside them.
//
// Arithmetic: fp32 throughout; precise sinf/cosf/sqrtf and division (no fast
// math); sign(0) == 0; 1/det through a select.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC (multi_car_racing_tpu_torch/_cuda.py); plain C interface
// loaded with ctypes.

#include "contact_rows.cuh"

namespace {

constexpr int kListThreads = 128;

// Whether env e's MM rows hold a live contact point: any of its 2 MM
// point_ok bytes set. 2 MM is a multiple of 96 and the tensor starts on a
// 16-byte boundary (solve_island_launch refuses it otherwise), so the rows
// are read as 16-byte words. False for MM = 0.
__device__ __forceinline__ bool env_live(const unsigned char* __restrict__ ok, int e, int MM) {
  const uint4* w = reinterpret_cast<const uint4*>(ok + static_cast<size_t>(e) * 2 * MM);
  for (int q = 0; q < MM / 8; ++q) {
    const uint4 v = w[q];
    if ((v.x | v.y | v.z | v.w) != 0u) return true;
  }
  return false;
}

// ---------------------------------------------------------------------------
// The list pass: one thread per env.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kListThreads)
list_pass_kernel(const unsigned char* __restrict__ ok, int* __restrict__ live_list,
                 int* __restrict__ live_count, int E, int MM) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = e < E && env_live(ok, e, MM);
  // One atomicAdd per warp, each env at the warp's base plus its rank among
  // the warp's live envs.
  const unsigned m = __ballot_sync(kFull, live);
  if (m != 0u) {
    const int lane = threadIdx.x & 31;
    const int leader = __ffs(m) - 1;
    int base = 0;
    if (lane == leader) base = atomicAdd(live_count, __popc(m));
    base = __shfl_sync(kFull, base, leader);
    if (live) live_list[base + __popc(m & ((1u << lane) - 1u))] = e;
  }
}

// ---------------------------------------------------------------------------
// The solve pass: a live env a warp, then a dead car a thread.
// ---------------------------------------------------------------------------

// Car i (env e, car n of it) of an env with no live point: the joints-only
// chain, then the car's share of the env's zero impulses.
__device__ __forceinline__ void solve_dead_car(int i, int e, int n, size_t sn, int MM,
                                               const float* __restrict__ fin,
                                               const int* __restrict__ lsin,
                                               float* __restrict__ fout,
                                               int* __restrict__ lsout,
                                               float* __restrict__ nio,
                                               float* __restrict__ tio,
                                               const float* __restrict__ prm, int N,
                                               int vel_iters, int pos_iters) {
  float p[N_PARAMS];
#pragma unroll
  for (int q = 0; q < N_PARAMS; ++q) p[q] = prm[q];
  Car car;
  car_begin_solved(car, fin, lsin, i, sn, p);
  joints_chain(car, p, vel_iters, pos_iters);
  car_store_solved(car, fout, lsout, i, sn);
  const size_t row0 = static_cast<size_t>(e) * MM;
  for (int r = n; r < MM; r += N) {
    const size_t g = row0 + r;
    nio[g * 2] = 0.f;
    nio[g * 2 + 1] = 0.f;
    tio[g * 2] = 0.f;
    tio[g * 2 + 1] = 0.f;
  }
}

// Env e, which has a live point, on this warp (its shared arrays at S).
// kWide (N > kLaneCars): the lane's cars in their slots (contact_rows.cuh).
template <bool kWide>
__device__ __forceinline__ void solve_live_env(
    int e, int lane, float* S, size_t sn, const float* __restrict__ fin,
    const int* __restrict__ lsin, const float* __restrict__ normal,
    const float* __restrict__ point, const float* __restrict__ sep,
    const unsigned char* __restrict__ ok, const float* __restrict__ ni_in,
    const float* __restrict__ ti_in, float* __restrict__ fout, int* __restrict__ lsout,
    float* __restrict__ nio, float* __restrict__ tio, const float* __restrict__ prm,
    const float* __restrict__ ctab, const int* __restrict__ itab, int N, int MM,
    int vel_iters, int pos_iters, int k_vel, int k_pos) {
  const int NB = 5 * N;
  const size_t ci = static_cast<size_t>(e) * N + lane;   // this lane's car
  const bool has_car = lane < N;
  const int b0 = lane * 5;                 // the car's hull slot

  float p[N_PARAMS];
#pragma unroll
  for (int q = 0; q < N_PARAMS; ++q) p[q] = prm[q];

  Car car;
  const Shared sh{S, NB, MM};
  if constexpr (!kWide) {
    if (has_car) car_begin_solved(car, fin, lsin, ci, sn, p);
  }

  const size_t row0 = static_cast<size_t>(e) * MM;
  for (int r = lane; r < MM; r += 32) {
    const size_t g = row0 + r;
    sh.live()[r] = static_cast<int>(ok[g * 2] != 0) | (static_cast<int>(ok[g * 2 + 1] != 0) << 1);
  }

  // ---- pre-solve poses (the centres of mass at init) and the
  // force-integrated velocities.
  if constexpr (kWide) {
    each_car(sh, N, lane, [&](Car& c, JointK&, int n) {
      car_begin_solved(c, fin, lsin, static_cast<size_t>(e) * N + n, sn, p);
      put_velocities(c, sh, 5 * n);
      put_positions(c, sh, 5 * n);
    });
  } else {
    if (has_car) {
      put_velocities(car, sh, b0);
      put_positions(car, sh, b0);
    }
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

  if constexpr (kWide) {
    solve_contact_island_wide(sh, itab, ctab, p, N, MM, lane, vel_iters, pos_iters, k_vel,
                              k_pos);
    each_car(sh, N, lane, [&](Car& c, JointK&, int n) {
      car_store_solved(c, fout, lsout, static_cast<size_t>(e) * N + n, sn);
    });
  } else {
    solve_contact_island<false>(car, has_car, b0, sh, itab, ctab, p, NB, MM, lane, vel_iters,
                               pos_iters, k_vel, k_pos);
    if (has_car) car_store_solved(car, fout, lsout, ci, sn);
  }
  store_impulses(sh, nio, tio, row0, MM, lane);
}

// Blocks 0..dead_blocks-1: car blockIdx.x * 32 + lane, if its env is dead;
// the blocks after: list entry blockIdx.x - dead_blocks (a live env) on the
// warp, or nothing past the count. kScratch (for N whose arrays do not fit a
// block's shared memory): live block w's arrays are slot w of `scratch`, and
// it takes entries w, w + live_blocks, ... kWide (with kScratch, N >
// kLaneCars): a lane carries several cars.
template <bool kScratch, bool kWide>
__global__ void __launch_bounds__(32)
solve_pass_kernel(const float* __restrict__ fin, const int* __restrict__ lsin,
                  const float* __restrict__ normal, const float* __restrict__ point,
                  const float* __restrict__ sep, const unsigned char* __restrict__ ok,
                  const float* __restrict__ ni_in, const float* __restrict__ ti_in,
                  float* __restrict__ fout, int* __restrict__ lsout,
                  float* __restrict__ nio, float* __restrict__ tio,
                  const float* __restrict__ prm, const float* __restrict__ ctab,
                  const int* __restrict__ itab, const int* __restrict__ live_list,
                  const int* __restrict__ live_count, int E, int N, int MM,
                  int vel_iters, int pos_iters, int k_vel, int k_pos, int dead_blocks,
                  float* scratch) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x;
  const size_t sn = static_cast<size_t>(E) * N;
  const int w = static_cast<int>(blockIdx.x) - dead_blocks;
  if (w >= 0) {
    if constexpr (!kScratch) {
      if (w >= *live_count) return;           // whole warps only
      solve_live_env<false>(live_list[w], lane, smem, sn, fin, lsin, normal, point, sep, ok,
                            ni_in, ti_in, fout, lsout, nio, tio, prm, ctab, itab, N, MM,
                            vel_iters, pos_iters, k_vel, k_pos);
    } else {
      float* S = scratch + static_cast<size_t>(w) * warp_floats(N, MM);
      const int count = *live_count, stride = static_cast<int>(gridDim.x) - dead_blocks;
      for (int i = w; i < count; i += stride) {  // the same count on every lane
        solve_live_env<kWide>(live_list[i], lane, S, sn, fin, lsin, normal, point, sep, ok,
                              ni_in, ti_in, fout, lsout, nio, tio, prm, ctab, itab, N, MM,
                              vel_iters, pos_iters, k_vel, k_pos);
        __syncwarp();                       // the slot's last reads before the next env
      }
    }
    return;
  }
  const int i = blockIdx.x * 32 + lane;
  if (i >= E * N) return;
  const int e = i / N;
  if (env_live(ok, e, MM)) return;
  solve_dead_car(i, e, i - e * N, sn, MM, fin, lsin, fout, lsout, nio, tio, prm, N, vel_iters,
                 pos_iters);
}

}  // namespace

extern "C" {

// The scratch the launch needs for E envs of N cars with MM bundle rows each:
// 0 when one warp's arrays fit a block's shared memory on the current device
// (or MM = 0: no bundle); else the slots, the solve pass's resident warps (at
// most E), each of solve_island_warp_floats(N, MM) floats (the wrapper may
// take fewer: fused_world.scratch_slots). Negative: a CUDA error code.
int solve_island_scratch_warps(int E, int N, int MM) {
  if (MM == 0 || warp_fits_shared(N, MM)) return 0;
  return N > kLaneCars ? resident_warps(solve_pass_kernel<true, true>, E)
                       : resident_warps(solve_pass_kernel<true, false>, E);
}

long long solve_island_warp_floats(int N, int MM) {
  return static_cast<long long>(warp_floats(N, MM));
}

// Launches the solve on `stream` for E envs of N cars, with MM = N(N-1)/2 *
// 48 bundle rows each (N >= 2), or MM = 0 and null row pointers for the
// joints-only island (any N): the list pass (with a bundle), then the solve
// pass. point_ok must start on a 16-byte boundary. live_list (E ints) and
// live_count (1 int) are device buffers; the count is zeroed here and holds
// the number of live envs after the launch. With scratch_warps = 0 a live
// warp keeps its arrays in shared memory (refused when they do not fit a
// block's); with scratch_warps > 0 (a bundle only), in `scratch`,
// scratch_warps slots of solve_island_warp_floats(N, MM) floats, whose
// offsets within a slot are ints (refused past INT_MAX floats a slot).
// Returns the CUDA error after the launches (0 on success); does not
// synchronise.
int solve_island_launch(const float* fin, const int* lsin, const float* normal,
                        const float* point, const float* sep, const unsigned char* ok,
                        const float* ni_in, const float* ti_in, float* fout, int* lsout,
                        float* nio, float* tio, const float* prm, const float* ctab,
                        const int* itab, int* live_list, int* live_count, int E, int N,
                        int MM, int vel_iters, int pos_iters, int k_vel, int k_pos,
                        float* scratch, int scratch_warps, void* stream) {
  if (E < 0 || N < 1 || (MM != 0 && (N < 2 || MM != N * (N - 1) / 2 * 48))
      || (MM != 0 && warp_floats(N, MM) > kMaxSlotFloats)
      || scratch_warps < 0 || (scratch_warps > 0) != (scratch != nullptr)
      || (scratch_warps > 0 && MM == 0)
      || (MM != 0 && scratch_warps == 0 && !warp_fits_shared(N, MM))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (MM != 0 && (reinterpret_cast<size_t>(ok) & 15u) != 0u) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(live_count, 0, sizeof(int), st);
  if (err != cudaSuccess || E == 0) return static_cast<int>(err);
  const int dead_blocks = (E * N + 31) / 32;
  const size_t smem = warp_smem_floats(N, MM) * sizeof(float);
  if (MM != 0) {
    list_pass_kernel<<<(E + kListThreads - 1) / kListThreads, kListThreads, 0, st>>>(
        ok, live_list, live_count, E, MM);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (scratch_warps > 0) {
    if (N > kLaneCars) {
      solve_pass_kernel<true, true><<<dead_blocks + scratch_warps, 32, 0, st>>>(
          fin, lsin, normal, point, sep, ok, ni_in, ti_in, fout, lsout, nio, tio, prm, ctab,
          itab, live_list, live_count, E, N, MM, vel_iters, pos_iters, k_vel, k_pos,
          dead_blocks, scratch);
    } else {
      solve_pass_kernel<true, false><<<dead_blocks + scratch_warps, 32, 0, st>>>(
          fin, lsin, normal, point, sep, ok, ni_in, ti_in, fout, lsout, nio, tio, prm, ctab,
          itab, live_list, live_count, E, N, MM, vel_iters, pos_iters, k_vel, k_pos,
          dead_blocks, scratch);
    }
    return static_cast<int>(cudaGetLastError());
  }
  if (MM != 0 && smem > 48 * 1024) {
    err = cudaFuncSetAttribute(solve_pass_kernel<false, false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = dead_blocks + (MM != 0 ? E : 0);
  solve_pass_kernel<false, false><<<blocks, 32, MM != 0 ? smem : 0, st>>>(
      fin, lsin, normal, point, sep, ok, ni_in, ti_in, fout, lsout, nio, tio, prm, ctab, itab,
      live_list, live_count, E, N, MM, vel_iters, pos_iters, k_vel, k_pos, dead_blocks,
      nullptr);
  return static_cast<int>(cudaGetLastError());
}

const char* solve_island_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
