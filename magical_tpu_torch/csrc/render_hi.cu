// Hi-fidelity compositing of MAGICAL frames (K4): the Hopper kernel behind
// core/render_kernel.py's render_views_hi and render_hi_into_slots, with
// two entry points.
//
// Replaces the Pallas kernel _render_kernel_hi
// (magical_tpu/core/render_pallas.py:517), which render_batch_pallas
// (:608) launches for fidelity='hi' through pl.pallas_call at :766:
//   render_hi_frame      a fresh frame (reset frames, raw observations,
//                        the Gym adapter's render());
//   render_hi_into_slot  the frame of every step, written into slot
//                        t mod depth of the view's frame ring; with
//                        K4's counters (render_tiles.cuh HiCounts) where
//                        the caller passes them, nulls otherwise.
// It computes what the XLA reference magical_tpu/core/render.py
// render_views(fidelity='hi') computes (:411-417): hard-edge coverage at
// 4x the output resolution, each subpixel quantised to a uint8 level, then
// the exact 4x4 box mean (cv2.INTER_AREA at ratio 4), in world space and
// in the XLA order of operations, not the Pallas kernel's re-associated
// screen-space edge coefficients.
//
// What bounds it on the H100: arithmetic.  Each output pixel composites
// 16 subpixels, and each subpixel evaluates the SDF (up to 8 faces) and
// blend of the prims that can cover it: about 16x the work of the lo
// render per output pixel, against the same uint8 output and the same
// state.  Yet a subpixel lies in the cull boxes of about two prims, of up
// to 138, and in most pixels all 16 subpixels get the same answer: the
// arena's fill covers the whole pixel, the border's band misses it.  The
// design is the lo kernels' (render_tiles.cuh) on the 4x grid: one block
// per (env, tile of HI_TILE output pixels, core/render_kernel.py), which
// builds the env's prims from its state and the display program in shared
// memory and keeps those whose screen box meets the tile's subpixels.  It
// then classes each pixel's kept prims from one SDF at the pixel's centre
// (none, full or partial over its 16 subpixels, exactly, with a margin
// for rounding: render_lo.cuh HI_CLASS_MARGIN), writes the pixels that no
// partial prim crosses at once, and packs the rest (~5% in MoveToCorner)
// into a list in shared memory, whose rows of subpixels four lanes a pixel
// composite from the topmost full prim up, summing the 16 levels by
// shuffles: no display list is built on the host and no 4x intermediate
// reaches device memory.  The cull and the classes are exact: a fill's
// hard coverage is 1 only where its SDF < 0, and an outline's band is the
// lo band on the 4x grid, so prim_screen_bbox's radius + 1 subpixel + half
// the line width bounds every subpixel a prim colours, and every tiling
// gives the same bytes.  Hard fill edges make byte-equality with the plain
// version a matter of rounding every operation as it does (render_lo.cuh,
// shared with the host build of the tests).

#include <cuda_runtime.h>

#include "render_tiles.cuh"

using namespace magical_render;

// K4, the step frame, into the ring slot `out` points at; `res` is the
// output resolution, the camera floats describe the 4x grid.  `cycles`,
// `items` and `pixels`, int64 (B, 2) each or all null, get each env's
// counts added.
extern "C" int render_hi_into_slot(SCENE_ARGS, void* cycles, void* items,
                                   void* pixels, void* stream) {
  return launch_tiles<true>(
      SCENE_PASS(4 * res), row_tile, col_tile, stream,
      {static_cast<long long*>(cycles), static_cast<long long*>(items),
       static_cast<long long*>(pixels)});
}

// K4, a fresh frame.
extern "C" int render_hi_frame(SCENE_ARGS, void* stream) {
  return launch_tiles<true>(SCENE_PASS(4 * res), row_tile, col_tile, stream);
}
