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
// against 27 KB of uint8 output and a few KB of display list.  Yet a pixel
// lies in the screen boxes of fewer than two prims on average (PERF.md),
// so the design culls, and all three entry points share one kernel:
//
// one block per (env, tile of row_tile x col_tile pixels), the env x tile
// index on gridDim.x, ragged at the frame's edge.  The block's threads
// stage the display list a prim per thread, compute each prim's screen box
// (prim_screen_bbox, render_lo.cuh) and keep the prims whose box meets the
// tile, compacted into shared memory in display order by a warp ballot and
// a prefix count over the warps (no atomics, which would reorder them);
// slots 0 and 1, the arena fill and border, are always kept.  Then each
// thread composites its pixels over the kept prims alone.  A culled prim
// has alpha exactly 0 on the tile, and out * (1 - 0) + c * 0 == out, so
// every tiling gives the same bytes.
//
// K2/K3 stage a prim by building it from the env's state (build_prim:
// pose, block shapes, colours and activity, goal boxes) and the scene's
// display program, a small table cached on the card per scene
// (core/render_kernel.py display_program): nothing is built on the host,
// nothing copied from it, and no display list passes through device
// memory.  Their tiles are 32 x 32 (core/render_kernel.py LO_TILE; PERF.md
// has the other tilings' times).  K5 stages the batched list the host's
// plain build_display_list made (load_prim), over the tiles its caller
// names, each of which must divide the frame.
//
// All three compute the camera transform in the kernel from the robot pose
// and write uint8 (B, res, res, 3) straight into its destination: a slot of
// the frame ring (K2) or a fresh frame (K3, K5).  Up to MAX_PRIMS prims of
// 200 bytes stay within the 48 KB of shared memory a block takes without
// opting in.

#include <cuda_runtime.h>

#include "render_lo.cuh"

using namespace magical_render;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

// One block per (env, tile of row_tile x col_tile pixels), ragged at the
// frame's right and bottom edges; blockIdx.x = env * tiles + tile.  The
// block stages the prims that meet its tile, a prim per thread (from the
// batched list, K5, or built from the state, K2/K3), in display order,
// then each thread composites its pixels over them.
template <class A>
__global__ void render_lo_tiles_kernel(A a, int row_tile, int col_tile) {
  extern __shared__ Prim kept[];
  __shared__ int warp_kept[WARPS];
  const int n_cols = (a.res + col_tile - 1) / col_tile;
  const int tiles = ((a.res + row_tile - 1) / row_tile) * n_cols;
  const int b = blockIdx.x / tiles;
  const int tile = blockIdx.x % tiles;
  const int r0 = (tile / n_cols) * row_tile;
  const int c0 = (tile % n_cols) * col_tile;
  const int rows = min(row_tile, a.res - r0), cols = min(col_tile, a.res - c0);
  const Camera cam = env_camera(a, b);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;

  int n_kept = 0;
  for (int base = 0; base < a.P; base += THREADS) {
    const int i = base + threadIdx.x;
    Prim p;
    bool keep = false;
    if (i < a.P) {
      stage_prim(a, b, i, p);
      keep = i < 2 || prim_meets_tile(p, cam, r0, rows, c0, cols);
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

  for (int q = threadIdx.x; q < rows * cols; q += THREADS) {
    const int row = r0 + q / cols, col = c0 + q % cols;
    shade_pixel(kept, n_kept, cam, row, col,
                a.out + ((size_t)b * a.res * a.res + row * a.res + col) * 3);
  }
}

template <class A>
int launch_tiles(const A& a, int row_tile, int col_tile, void* stream) {
  if (a.P > MAX_PRIMS || row_tile <= 0 || col_tile <= 0)
    return (int)cudaErrorInvalidValue;
  if (a.B <= 0) return 0;
  const long long blocks = (long long)a.B *
                           ((a.res + row_tile - 1) / row_tile) *
                           ((a.res + col_tile - 1) / col_tile);
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  render_lo_tiles_kernel<A><<<(unsigned)blocks, THREADS,
                              a.P * sizeof(Prim),
                              static_cast<cudaStream_t>(stream)>>>(
      a, row_tile, col_tile);
  return (int)cudaGetLastError();
}

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
#define SCENE_ARGS                                                          \
  const void *pos, const void *angle, const void *block_shape,             \
      const void *block_colour, const void *block_active,                  \
      const void *goal_xyhw, const void *goal_colour,                      \
      const void *goal_active, const void *prog_i, const void *prog_f,     \
      const void *tab_f, const void *tab_i, void *out, int B, int P,       \
      int res, int nb, int mb, int mg, int ego, float scale, float half,   \
      float npx, float npy, float lw_scale, float two_scale, float bg0,    \
      float bg1, float bg2, int row_tile, int col_tile
#define SCENE_PASS                                                          \
  make_scene_args(pos, angle, block_shape, block_colour, block_active,     \
                  goal_xyhw, goal_colour, goal_active, prog_i, prog_f,     \
                  tab_f, tab_i, out, B, P, res, nb, mb, mg, ego, scale,    \
                  half, npx, npy, lw_scale, two_scale, bg0, bg1, bg2)

// The display program's layout, for the Python side to check against its
// own: {PROG_I, PROG_F, TF_SIZE, TI_SIZE}.
extern "C" int render_program_layout(int* out) {
  out[0] = PROG_I;
  out[1] = PROG_F;
  out[2] = TF_SIZE;
  out[3] = TI_SIZE;
  return 0;
}

// K2: the step frame, built from the state, into the ring slot `out`
// points at.
extern "C" int render_lo_into_slot(SCENE_ARGS, void* stream) {
  return launch_tiles(SCENE_PASS, row_tile, col_tile, stream);
}

// K3: a fresh frame, built from the state.
extern "C" int render_lo_frame(SCENE_ARGS, void* stream) {
  return launch_tiles(SCENE_PASS, row_tile, col_tile, stream);
}

// K5: a fresh frame over (row_tile x col_tile) pixel tiles, each of which
// divides res.
extern "C" int render_lo_tiles2d(RENDER_ARGS, int row_tile, int col_tile,
                                 void* stream) {
  if (row_tile <= 0 || col_tile <= 0 || res % row_tile != 0 ||
      res % col_tile != 0)
    return (int)cudaErrorInvalidValue;
  return launch_tiles(RENDER_PASS(res), row_tile, col_tile, stream);
}
