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
// and every env is independent; the state is a few hundred bytes per env
// in device memory, so its traffic is negligible.  One thread per env
// would leave most of the card idle (32 blocks of 128 threads at 4096 envs
// on 132 SMs) and, from MB = 3 on, spill its 12-30 KB of per-env state to
// local memory.
//
// The design: one warp per env, its state in shared memory (WarpEnv in
// physics_step.cuh: bodies, sub-shape slots, contacts, caches; ~30 KB at
// MB = 10, ~8 KB at MB = 1), 1 to 4 envs a block within 48 KB, so 4096
// envs are 1,024 to 4,096 blocks.  The lanes share each phase
// (control_step_warp): the slots; the narrowphase over the candidates of
// active slots only (a ClusterColour-Demo env has 213 of its 1920
// sub-shape pairs), listed once per control step; where that list is
// longer than a warp, a cull by bounding circles, 32 items a round, packs
// the few that can touch (~2% on ClusterColour) into one list a warp wide
// for the full contact tests; each lane's contacts placed after those of
// the lanes before it by a prefix count, never an atomic, so the contact
// list, its MAXC cut and the warm start are the sequential ones; the contact prestep, warm start and Jacobi sweep, a
// contact a lane; the per-body impulse sums, a lane per (side, body), each
// summing in contact order as the plain version does; the block dampers,
// a block a lane.  The robot's Gauss-Seidel joints stay on lane 0, in
// their order.  So the kernel gives the bits of the sequential control
// step, run after run; the host build of the tests runs each phase lane
// by lane.
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
