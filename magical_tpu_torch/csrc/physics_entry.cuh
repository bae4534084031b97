// The launch of the control-step kernel (physics_step.cu has its note)
// and its C entry point, as a macro that a source instantiates for one
// block count: PHYSICS_CONTROL_STEP(MB) defines physics_control_step_mb<MB>,
// which launches control_step_kernel<MB> on every env of the batch, a warp
// an env.  One source per block count, so that _build.py compiles the
// instantiations side by side.

#pragma once

#include <cuda_runtime.h>

#include "physics_step.cuh"

namespace magical {

// Envs (warps) a block: of the counts up to 4 whose WarpEnv states fit the
// 48 KB of shared memory a block takes without opting in, the one with
// which an SM's 228 KB (1 KB of it reserved a block) holds the most envs,
// the larger count on a tie (MB = 1: 4, MB = 8 and 10: 1); an SM then
// holds several blocks.
template <int MB>
constexpr int envs_per_block() {
  constexpr size_t env = sizeof(WarpEnv<MB>);
  int best = 1, most = 0;
  for (int n = 1; n <= 4 && (n == 1 || n * env <= 48 * 1024); ++n) {
    const int held = n * (int)(228 * 1024 / (n * env + 1024));
    if (held >= most) {
      best = n;
      most = held;
    }
  }
  return best;
}

template <int MB>
__global__ void control_step_kernel(Args a) {
  extern __shared__ unsigned char smem[];
  const int warp = threadIdx.x / LANES, lane = threadIdx.x % LANES;
  const int b = blockIdx.x * (blockDim.x / LANES) + warp;
  if (b >= a.B) return;                  // ragged edge: whole warps
  WarpEnv<MB>* envs = reinterpret_cast<WarpEnv<MB>*>(smem);
  control_step_warp<MB>(a, b, envs[warp], lane);
}

template <int MB>
int launch_control_step(
    void* pos, void* angle, void* vel, void* omega, void* v_bias,
    void* w_bias, void* target_speed, void* rel_turn_angle,
    void* target_finger_angle, const void* block_shape,
    const void* block_active, const void* phys, void* con_id, void* con_jn,
    void* con_jt, void* joint_acc, void* t, const void* action,
    const void* ftab, const void* itab, int B, int mb, int phys_steps,
    int iterations, void* phase_clock, void* item_count, void* stream) {
  if (mb != MB) return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.pos = static_cast<float*>(pos);
  a.angle = static_cast<float*>(angle);
  a.vel = static_cast<float*>(vel);
  a.omega = static_cast<float*>(omega);
  a.v_bias = static_cast<float*>(v_bias);
  a.w_bias = static_cast<float*>(w_bias);
  a.target_speed = static_cast<float*>(target_speed);
  a.rel_turn_angle = static_cast<float*>(rel_turn_angle);
  a.target_finger_angle = static_cast<float*>(target_finger_angle);
  a.block_shape = static_cast<const int*>(block_shape);
  a.block_active = static_cast<const unsigned char*>(block_active);
  a.phys = static_cast<const float*>(phys);
  a.con_id = static_cast<int*>(con_id);
  a.con_jn = static_cast<float*>(con_jn);
  a.con_jt = static_cast<float*>(con_jt);
  a.joint_acc = static_cast<float*>(joint_acc);
  a.t = static_cast<int*>(t);
  a.action = static_cast<const int*>(action);
  a.tab.f = static_cast<const float*>(ftab);
  a.tab.i = static_cast<const int*>(itab);
  a.B = B;
  a.phys_steps = phys_steps;
  a.iterations = iterations;
  a.phase_clock = static_cast<long long*>(phase_clock);
  a.item_count = static_cast<long long*>(item_count);
  if (B <= 0) return 0;
  constexpr int envs = envs_per_block<MB>();
  constexpr size_t smem = envs * sizeof(WarpEnv<MB>);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        control_step_kernel<MB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid((B + envs - 1) / envs);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  control_step_kernel<MB><<<grid, envs * LANES, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace magical

#define PHYSICS_ARGS                                                         \
  void *pos, void *angle, void *vel, void *omega, void *v_bias,             \
      void *w_bias, void *target_speed, void *rel_turn_angle,               \
      void *target_finger_angle, const void *block_shape,                   \
      const void *block_active, const void *phys, void *con_id,             \
      void *con_jn, void *con_jt, void *joint_acc, void *t,                 \
      const void *action, const void *ftab, const void *itab, int B,        \
      int mb, int phys_steps, int iterations, void *phase_clock,           \
      void *item_count, void *stream
#define PHYSICS_PASS                                                         \
  pos, angle, vel, omega, v_bias, w_bias, target_speed, rel_turn_angle,     \
      target_finger_angle, block_shape, block_active, phys, con_id, con_jn, \
      con_jt, joint_acc, t, action, ftab, itab, B, mb, phys_steps,          \
      iterations, phase_clock, item_count, stream

// The C entry point physics_control_step_mb<MB>; `mb` must equal MB.
#define PHYSICS_CONTROL_STEP(MB)                                      \
  extern "C" int physics_control_step_mb##MB(PHYSICS_ARGS) {          \
    return magical::launch_control_step<MB>(PHYSICS_PASS);            \
  }
