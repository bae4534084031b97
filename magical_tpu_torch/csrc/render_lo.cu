// Lo-fidelity (analytic AA) compositing of MAGICAL frames: the Hopper
// kernels behind core/render_kernel.py, with three entry points.
//
// Replaces the lo Pallas kernels of magical_tpu/core/render_pallas.py:
//   render_lo_into_slot  the slot-writing render of every step,
//                        render_into_slots_pallas (:815), pl.pallas_call
//                        at render_pallas.py:918 (K2);
//   render_lo_frame      the fresh-frame render (reset frames),
//                        render_batch_pallas (:608), lo branch,
//                        pl.pallas_call at render_pallas.py:766 (K3);
//   render_lo_tiles2d    the fresh-frame render over 2-D pixel tiles,
//                        render_batch_pallas(tiles2d=...) (:674),
//                        _render_kernel_2d (:474), pl.pallas_call at
//                        render_pallas.py:692 (K5).
// They compute what the XLA reference magical_tpu/core/render.py
// render_frame(aa=True) + to_uint8 computes (:320-386), in world space,
// not the Pallas kernels' re-associated screen-space maths (no static
// ego overlay, no finger-group union blends, no trivial-slab fills).
//
// What bounds them on the H100: arithmetic.  Each pixel evaluates every
// prim's SDF (up to 8 faces) and blend, ~20 prims for MoveToCorner and up
// to 138 for ClusterColour's Test variants, so a 96x96 frame is 4-30 MFLOP
// against 27 KB of uint8 output and the state's few hundred bytes an env.
// Yet a pixel lies in the screen boxes of fewer than two prims on average
// (PERF.md), so the design culls: all three are render_tiles_kernel
// (render_tiles.cuh), which builds each env's prims in shared memory from
// the state and the scene's display program (a small table cached on the
// card per scene, core/render_kernel.py display_program), keeps those whose
// screen box meets the block's tile and composites each pixel over them.
// Nothing is built on the host, nothing copied from it, and no display
// list passes through device memory.  K2/K3's tiles are 32 x 32
// (core/render_kernel.py LO_TILE; PERF.md has the other tilings' times);
// K5's are the caller's, each of which must divide the frame.  Each writes
// uint8 (B, res, res, 3) straight into its destination: a slot of the
// frame ring (K2) or a fresh frame (K3, K5).

#include <cuda_runtime.h>

#include "render_tiles.cuh"

using namespace magical_render;

// The display program's layout, for the Python side to check against its
// own: {PROG_I, PROG_F, TF_SIZE, TI_SIZE}.
extern "C" int render_program_layout(int* out) {
  out[0] = PROG_I;
  out[1] = PROG_F;
  out[2] = TF_SIZE;
  out[3] = TI_SIZE;
  return 0;
}

// K2: the step frame into the ring slot `out` points at.
extern "C" int render_lo_into_slot(SCENE_ARGS, void* stream) {
  return launch_tiles<false>(SCENE_PASS(res), row_tile, col_tile, stream);
}

// K3: a fresh frame.
extern "C" int render_lo_frame(SCENE_ARGS, void* stream) {
  return launch_tiles<false>(SCENE_PASS(res), row_tile, col_tile, stream);
}

// K5: a fresh frame over tiles each of which divides res.
extern "C" int render_lo_tiles2d(SCENE_ARGS, void* stream) {
  if (row_tile <= 0 || col_tile <= 0 || res % row_tile != 0 ||
      res % col_tile != 0)
    return (int)cudaErrorInvalidValue;
  return launch_tiles<false>(SCENE_PASS(res), row_tile, col_tile, stream);
}
