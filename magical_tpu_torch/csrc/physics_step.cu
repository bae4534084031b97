// One MAGICAL control step (10 substeps x 10 solver iterations) for every
// env of a batch: the Hopper kernel behind core/physics_kernel.py.
//
// Replaces: the Pallas physics kernel built by _make_kernel and launched
// through pl.pallas_call at magical_tpu/core/physics_pallas.py:1262
// (control_step_pallas, :1320).  It computes what the XLA reference
// magical_tpu/core/physics.py control_step computes (:677, over
// physics_substep :526), not what the Pallas kernel computes: one
// candidate per shape-pair point (no 2-deepest compression), closest-point
// circle-vs-poly, NV = 8 vertices, and the contact / joint warm-start
// caches (con_id, con_jn, con_jt, joint_acc) carried in and out.
//
// What bounds it on the H100: latency of dependent scalar float math.  A
// step is ~100 sequential solver sweeps over a few dozen contacts per env,
// and every env is independent; the state is a few hundred bytes per env,
// so device memory traffic is negligible.  The design: one thread per env,
// all of its bodies, contacts and accumulators in registers and local
// memory (L1-resident), no shared memory, no synchronisation.  At 4096
// envs that is 32 blocks of 128 threads on 132 SMs, so most of the card
// idles; whether a warp per env, with contacts spread across lanes, pays
// is left to a later change.
//
// The kernel updates the state tensors in place.  The per-env arithmetic
// lives in __host__ __device__ functions that follow core/physics.py
// operation for operation, so that the two agree to rounding.

#include <cuda_runtime.h>

#include "physics_step.cuh"

using namespace magical;

namespace {

template <int MB>
__global__ void control_step_kernel(Args a) {
  int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= a.B) return;                  // ragged edge
  control_step_env<MB>(a, b);
}

}  // namespace

// Offsets of the table layout, for the Python side to check against its
// own: {FT_CAND_FRICTION, N_SCALARS, IT_SLOT_BODY}.
extern "C" int physics_table_layout(int* out) {
  out[0] = FT_CAND_FRICTION;
  out[1] = N_SCALARS;
  out[2] = IT_SLOT_BODY;
  return 0;
}

extern "C" int physics_control_step(
    void* pos, void* angle, void* vel, void* omega, void* v_bias,
    void* w_bias, void* target_speed, void* rel_turn_angle,
    void* target_finger_angle, const void* block_shape,
    const void* block_active, const void* phys, void* con_id, void* con_jn,
    void* con_jt, void* joint_acc, void* t, const void* action,
    const void* ftab, const void* itab, int B, int mb, int phys_steps,
    int iterations, void* stream) {
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
  if (B <= 0) return 0;
  const int threads = 128;
  dim3 grid((B + threads - 1) / threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mb) {
    case 1:
      control_step_kernel<1><<<grid, threads, 0, s>>>(a);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
