// Host build of the per-env / per-pixel arithmetic of the CUDA kernels in
// magical_tpu_torch/csrc, for tests/test_torch_kernel_host.py: the same
// __host__ __device__ functions the kernels run, looped over the batch on
// the CPU.  Built with contraction off, so that it rounds every operation
// as the plain PyTorch versions do.
#define __host__
#define __device__
#include <stddef.h>

#include "physics_step.cuh"
#include "render_lo.cuh"

extern "C" int physics_table_layout(int* out) {
  out[0] = magical::FT_CAND_FRICTION;
  out[1] = magical::N_SCALARS;
  out[2] = magical::IT_SLOT_BODY;
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
  magical::Args a;
  a.pos = (float*)pos;
  a.angle = (float*)angle;
  a.vel = (float*)vel;
  a.omega = (float*)omega;
  a.v_bias = (float*)v_bias;
  a.w_bias = (float*)w_bias;
  a.target_speed = (float*)target_speed;
  a.rel_turn_angle = (float*)rel_turn_angle;
  a.target_finger_angle = (float*)target_finger_angle;
  a.block_shape = (const int*)block_shape;
  a.block_active = (const unsigned char*)block_active;
  a.phys = (const float*)phys;
  a.con_id = (int*)con_id;
  a.con_jn = (float*)con_jn;
  a.con_jt = (float*)con_jt;
  a.joint_acc = (float*)joint_acc;
  a.t = (int*)t;
  a.action = (const int*)action;
  a.tab.f = (const float*)ftab;
  a.tab.i = (const int*)itab;
  a.B = B;
  a.phys_steps = phys_steps;
  a.iterations = iterations;
  switch (mb) {
#define MB_CASE(n)                                                   \
  case n:                                                            \
    for (int b = 0; b < B; ++b) magical::control_step_env<n>(a, b); \
    return 0;
    MB_CASE(1)
    MB_CASE(3)
    MB_CASE(4)
    MB_CASE(7)
    MB_CASE(8)
    MB_CASE(10)
#undef MB_CASE
    default:
      return 1;
  }
}

namespace {

using namespace magical_render;

// The host loop of render_lo.cu / render_hi.cu: stage each env's display
// list as the kernels stage it in shared memory, then shade every output
// pixel (lo: shade_pixel; hi: shade_pixel_hi, the camera on the 4x grid).
template <bool HI>
int render_frame(const RenderArgs& a) {
  if (a.P > MAX_PRIMS) return 1;
  static Prim prims[MAX_PRIMS];
  for (int b = 0; b < a.B; ++b) {
    for (int i = 0; i < a.P; ++i) load_prim(a, b, i, prims[i]);
    const Camera cam = env_camera(a, b);
    for (int pix = 0; pix < a.res * a.res; ++pix) {
      unsigned char* rgb = a.out + ((size_t)b * a.res * a.res + pix) * 3;
      if (HI)
        shade_pixel_hi(prims, a.P, cam, pix / a.res, pix % a.res, rgb);
      else
        shade_pixel(prims, a.P, cam, pix / a.res, pix % a.res, rgb);
    }
  }
  return 0;
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

extern "C" int render_lo_frame(RENDER_ARGS, void* stream) {
  return render_frame<false>(RENDER_PASS(res));
}

extern "C" int render_hi_frame(RENDER_ARGS, void* stream) {
  return render_frame<true>(RENDER_PASS(4 * res));
}

// K5's loop: per env and tile, the prims that meet the tile (slots 0 and 1
// always), in display order, then the tile's pixels over them alone.
extern "C" int render_lo_tiles2d(RENDER_ARGS, int row_tile, int col_tile,
                                 void* stream) {
  const RenderArgs a = RENDER_PASS(res);
  if (P > MAX_PRIMS || res % row_tile != 0 || res % col_tile != 0) return 1;
  static Prim kept[MAX_PRIMS];
  for (int b = 0; b < B; ++b) {
    const Camera cam = env_camera(a, b);
    for (int r0 = 0; r0 < res; r0 += row_tile) {
      for (int c0 = 0; c0 < res; c0 += col_tile) {
        int n = 0;
        for (int i = 0; i < P; ++i) {
          Prim p;
          load_prim(a, b, i, p);
          if (i < 2 || prim_meets_tile(p, cam, r0, row_tile, c0, col_tile))
            kept[n++] = p;
        }
        for (int q = 0; q < row_tile * col_tile; ++q) {
          const int row = r0 + q / col_tile, col = c0 + q % col_tile;
          shade_pixel(kept, n, cam, row, col,
                      a.out + ((size_t)b * res * res + row * res + col) * 3);
        }
      }
    }
  }
  return 0;
}

// Each prim's screen box (B, P, 4) and whether it could be bounded (B, P),
// as K5 computes them; `out` is unused.
extern "C" int render_prim_bboxes(RENDER_ARGS, void* bboxes, void* bounded) {
  const RenderArgs a = RENDER_PASS(res);
  for (int b = 0; b < B; ++b) {
    const Camera cam = env_camera(a, b);
    for (int i = 0; i < P; ++i) {
      Prim p;
      load_prim(a, b, i, p);
      float* bb = (float*)bboxes + ((size_t)b * P + i) * 4;
      ((int*)bounded)[b * P + i] = prim_screen_bbox(p, cam, bb) ? 1 : 0;
    }
  }
  return 0;
}
