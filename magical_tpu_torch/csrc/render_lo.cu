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
// against 27 KB of uint8 output and a few KB of display list.
//
// K2/K3: one block per (env, tile of 256 pixels), one thread per pixel;
// the env's display list, with its face normals and offsets precomputed
// once per block, is staged in dynamic shared memory (200 bytes a prim,
// sized from the list's length) and read by every thread as a broadcast.
//
// K5 cuts the arithmetic by culling: one block per (env, row band, column
// band), the env x tile index on gridDim.x.  The block's threads stage the
// display list a prim per thread, compute each prim's screen box
// (prim_screen_bbox, render_lo.cuh) and keep the prims whose box meets the
// tile, compacted into shared memory in display order by a warp ballot
// and a prefix count over the warps (no atomics, which would reorder
// them); slots 0 and 1, the arena fill and border, are always kept.  Then
// each thread composites its pixels over the kept prims alone.  A culled
// prim has alpha exactly 0 on the tile, and out * (1 - 0) + c * 0 == out,
// so the frame is byte-equal to K3's.
//
// All three compute the camera transform in the kernel from the robot pose
// and write uint8 (B, res, res, 3) straight into its destination: a slot of
// the frame ring (K2) or a fresh frame (K3, K5).

#include <cuda_runtime.h>

#include "render_lo.cuh"

using namespace magical_render;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

__global__ void render_lo_kernel(RenderArgs a) {
  extern __shared__ Prim prims[];
  const int b = blockIdx.y;
  for (int i = threadIdx.x; i < a.P; i += blockDim.x)
    load_prim(a, b, i, prims[i]);
  __syncthreads();
  const Camera cam = env_camera(a, b);
  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= a.res * a.res) return;      // ragged edge of the last tile
  shade_pixel(prims, a.P, cam, pix / a.res, pix % a.res,
              a.out + ((size_t)b * a.res * a.res + pix) * 3);
}

// K5: blockIdx.x = env * (row bands x column bands) + tile.
__global__ void render_lo_tiles2d_kernel(RenderArgs a, int row_tile,
                                         int col_tile) {
  extern __shared__ Prim kept[];
  __shared__ int warp_kept[WARPS];
  const int n_cols = a.res / col_tile;
  const int tiles = (a.res / row_tile) * n_cols;
  const int b = blockIdx.x / tiles;
  const int tile = blockIdx.x % tiles;
  const int r0 = (tile / n_cols) * row_tile;
  const int c0 = (tile % n_cols) * col_tile;
  const Camera cam = env_camera(a, b);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;

  int n_kept = 0;
  for (int base = 0; base < a.P; base += THREADS) {
    const int i = base + threadIdx.x;
    Prim p;
    bool keep = false;
    if (i < a.P) {
      load_prim(a, b, i, p);
      keep = i < 2 || prim_meets_tile(p, cam, r0, row_tile, c0, col_tile);
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) warp_kept[warp] = __popc(ballot);
    __syncthreads();
    int at = n_kept, total = n_kept;
    for (int w = 0; w < WARPS; ++w) {
      if (w < warp) at += warp_kept[w];
      total += warp_kept[w];
    }
    if (keep) kept[at + __popc(ballot & ((1u << lane) - 1u))] = p;
    n_kept = total;
    __syncthreads();                     // kept[] written, warp_kept free
  }

  for (int q = threadIdx.x; q < row_tile * col_tile; q += THREADS) {
    const int row = r0 + q / col_tile, col = c0 + q % col_tile;
    shade_pixel(kept, n_kept, cam, row, col,
                a.out + ((size_t)b * a.res * a.res + row * a.res + col) * 3);
  }
}

bool takes(int B, int P) { return P <= MAX_PRIMS && B <= 65535; }

}  // namespace

#define RENDER_ARGS                                                        \
  const void *verts, const void *nv, const void *radius, const void *color, \
      const void *active, const void *kind, const void *lw,                \
      const void *pos, const void *angle, void *out, int B, int P,         \
      int res, int nb, int ego, float scale, float half, float npx,        \
      float npy, float lw_scale, float two_scale, float bg0, float bg1,    \
      float bg2
#define RENDER_PASS(cam_res)                                               \
  make_render_args(verts, nv, radius, color, active, kind, lw, pos, angle, \
                   out, B, P, res, nb, cam_res, ego, scale, half, npx,     \
                   npy, lw_scale, two_scale, bg0, bg1, bg2)

namespace {

int launch(const RenderArgs& a, void* stream) {
  if (!takes(a.B, a.P)) return (int)cudaErrorInvalidValue;
  if (a.B <= 0) return 0;
  dim3 grid((a.res * a.res + THREADS - 1) / THREADS, a.B);
  render_lo_kernel<<<grid, THREADS, a.P * sizeof(Prim),
                     static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// K2: the step frame, into the ring slot `out` points at.
extern "C" int render_lo_into_slot(RENDER_ARGS, void* stream) {
  return launch(RENDER_PASS(res), stream);
}

// K3: a fresh frame.
extern "C" int render_lo_frame(RENDER_ARGS, void* stream) {
  return launch(RENDER_PASS(res), stream);
}

// K5: a fresh frame over (row_tile x col_tile) pixel tiles, each of which
// divides res.
extern "C" int render_lo_tiles2d(RENDER_ARGS, int row_tile, int col_tile,
                                 void* stream) {
  const RenderArgs a = RENDER_PASS(res);
  if (!takes(B, P) || row_tile <= 0 || col_tile <= 0 ||
      res % row_tile != 0 || res % col_tile != 0)
    return (int)cudaErrorInvalidValue;
  if (B <= 0) return 0;
  const long long blocks =
      (long long)B * (res / row_tile) * (res / col_tile);
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  render_lo_tiles2d_kernel<<<(unsigned)blocks, THREADS, P * sizeof(Prim),
                             static_cast<cudaStream_t>(stream)>>>(
      a, row_tile, col_tile);
  return (int)cudaGetLastError();
}
