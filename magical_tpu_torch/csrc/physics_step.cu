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
// memory, no shared memory, no synchronisation.  At 4096 envs that is 32
// blocks of 128 threads on 132 SMs, so most of the card idles; whether a
// warp per env, with contacts spread across lanes, pays is left to a later
// change.
//
// The kernel is instantiated for every block count of the task families:
// MB = 1 here, MB = 3, 4, 7, 8 and 10 in physics_step_mb<MB>.cu, one
// source each so that nvcc builds them side by side; the launch and the C
// entry point are in physics_entry.cuh.  The per-env state grows with MB:
// at MB = 10 a thread holds 65 sub-shape slots and 24 arrays of 192
// contacts in a 30 KB stack frame (7 KB at MB = 1), with 255 registers and
// spills from MB = 3 on (ptxas -v, which the build's verbose mode writes to
// build.log), and walks 1920 sub-shape pairs per substep against 30.  On
// the H100 at 4096 envs that costs ~13 ms a step at MB = 10 on Demo
// states and ~90 ms on ClusterColour-TestAll states, whose many contacts
// and mixed shapes lengthen each thread's loops (PERF.md): still one
// thread per env, latency-bound, far from the card's limits.
//
// The kernel updates the state tensors in place.  The per-env arithmetic
// lives in __host__ __device__ functions that follow core/physics.py
// operation for operation, so that the two agree to rounding.

#include "physics_entry.cuh"

using namespace magical;

// Offsets of the table layout, for the Python side to check against its
// own: {FT_CAND_FRICTION, N_SCALARS, IT_SLOT_BODY}.
extern "C" int physics_table_layout(int* out) {
  out[0] = FT_CAND_FRICTION;
  out[1] = N_SCALARS;
  out[2] = IT_SLOT_BODY;
  return 0;
}

// MoveToCorner and MoveToRegion; the other block counts have a source each
// (physics_step_mb<MB>.cu).
PHYSICS_CONTROL_STEP(1)
