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
//                        t mod depth of the view's frame ring.
// It computes what the XLA reference magical_tpu/core/render.py
// render_views(fidelity='hi') computes (:411-417): hard-edge coverage at
// 4x the output resolution, each subpixel quantised to a uint8 level, then
// the exact 4x4 box mean (cv2.INTER_AREA at ratio 4), in world space and
// in the XLA order of operations, not the Pallas kernel's re-associated
// screen-space edge coefficients.
//
// What bounds it on the H100: arithmetic.  Each output pixel composites
// 16 subpixels, and each subpixel evaluates every active prim's SDF (up to
// 8 faces) and blend: about 16x the work of the lo render per output
// pixel, against the same uint8 output and display list.  The design: one
// block per (env, tile of 256 output pixels), one thread per output pixel
// walking its 4x4 subpixels in registers; the env's display list, with
// face normals and offsets precomputed once per block, is staged in
// dynamic shared memory (200 bytes a prim, sized from the list's length:
// up to 138 prims for ClusterColour's Test variants) and read by every
// thread as a broadcast.  No 4x intermediate
// reaches device memory.  The camera (at the 4x grid) is computed in the
// kernel from the robot pose.  Hard fill edges make byte-equality with
// the plain version a matter of rounding every operation as it does: the
// per-subpixel arithmetic is shade_pixel_hi in render_lo.cuh, shared with
// the lo kernel and with the host build of the tests.

#include <cuda_runtime.h>

#include "render_lo.cuh"

using namespace magical_render;

namespace {

constexpr int THREADS = 256;

// `a.res` is the output resolution; `a.cam` describes the 4x grid.
__global__ void render_hi_kernel(RenderArgs a) {
  extern __shared__ Prim prims[];
  const int b = blockIdx.y;
  for (int i = threadIdx.x; i < a.P; i += blockDim.x)
    load_prim(a, b, i, prims[i]);
  __syncthreads();
  const Camera cam = env_camera(a, b);
  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= a.res * a.res) return;      // ragged edge of the last tile
  shade_pixel_hi(prims, a.P, cam, pix / a.res, pix % a.res,
                 a.out + ((size_t)b * a.res * a.res + pix) * 3);
}

int launch(const RenderArgs& a, void* stream) {
  if (a.P > MAX_PRIMS || a.B > 65535) return (int)cudaErrorInvalidValue;
  if (a.B <= 0) return 0;
  dim3 grid((a.res * a.res + THREADS - 1) / THREADS, a.B);
  render_hi_kernel<<<grid, THREADS, a.P * sizeof(Prim),
                     static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// `res` is the output resolution; the camera floats describe the 4x grid.
#define RENDER_ARGS                                                        \
  const void *verts, const void *nv, const void *radius, const void *color, \
      const void *active, const void *kind, const void *lw,                \
      const void *pos, const void *angle, void *out, int B, int P,         \
      int res, int nb, int ego, float scale, float half, float npx,        \
      float npy, float lw_scale, float two_scale, float bg0, float bg1,    \
      float bg2, void *stream
#define RENDER_PASS                                                        \
  make_render_args(verts, nv, radius, color, active, kind, lw, pos, angle, \
                   out, B, P, res, nb, 4 * res, ego, scale, half, npx,     \
                   npy, lw_scale, two_scale, bg0, bg1, bg2),               \
      stream

// K4, the step frame, into the ring slot `out` points at.
extern "C" int render_hi_into_slot(RENDER_ARGS) {
  return launch(RENDER_PASS);
}

// K4, a fresh frame.
extern "C" int render_hi_frame(RENDER_ARGS) { return launch(RENDER_PASS); }
