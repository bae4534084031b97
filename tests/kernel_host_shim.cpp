// Host build of the per-env / per-pixel arithmetic of the CUDA kernels in
// magical_tpu_torch/csrc, for tests/test_torch_kernel_host.py: the same
// __host__ __device__ functions the kernels run, looped over the batch on
// the CPU.  Built with contraction off, so that it rounds every operation
// as the plain PyTorch versions do.
#define __host__
#define __device__
#include <math.h>
#include <stddef.h>
#include <string.h>

#include <unordered_map>

// The lo render's cosines and sines: the host's libm rounds cosf and
// sinf one ulp apart from PyTorch's CPU cos and sin on ~5% of angles, where
// CUDA's cosf and PyTorch's CUDA cos are one function.  So a test hands in
// PyTorch's values for the angles it renders (render_set_trig); an angle
// it did not hand in takes libm's and is counted (render_trig_misses).
namespace {
std::unordered_map<unsigned, float> g_cos, g_sin;
long g_trig_misses = 0;

unsigned float_bits(float x) {
  unsigned u;
  memcpy(&u, &x, sizeof u);
  return u;
}

float shim_trig(const std::unordered_map<unsigned, float>& t, float x,
                float (*libm)(float)) {
  auto it = t.find(float_bits(x));
  if (it != t.end()) return it->second;
  ++g_trig_misses;
  return libm(x);
}
float shim_cosf(float x) { return shim_trig(g_cos, x, cosf); }
float shim_sinf(float x) { return shim_trig(g_sin, x, sinf); }
}  // namespace

#define MAGICAL_RENDER_COSF shim_cosf
#define MAGICAL_RENDER_SINF shim_sinf

// The order in which the control step's phases run their lanes
// (physics_set_lane_order): on the card the lanes of a phase run at once,
// so its result may depend on no order.
namespace {
int g_lane_order[32] = {0,  1,  2,  3,  4,  5,  6,  7,  8,  9,  10,
                        11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21,
                        22, 23, 24, 25, 26, 27, 28, 29, 30, 31};
}  // namespace
#define MAGICAL_HOST_LANE(i) (g_lane_order[i])

#include "physics_step.cuh"
#include "render_lo.cuh"

// Take PyTorch's cos[i] and sin[i] for angle x[i] (replacing any earlier
// table), and reset the miss count.
extern "C" int render_set_trig(const float* x, const float* c,
                               const float* s, int n) {
  g_cos.clear();
  g_sin.clear();
  for (int i = 0; i < n; ++i) {
    g_cos[float_bits(x[i])] = c[i];
    g_sin[float_bits(x[i])] = s[i];
  }
  g_trig_misses = 0;
  return 0;
}

extern "C" long render_trig_misses() { return g_trig_misses; }

// Run the lanes of every phase in the order order[0..31], a permutation of
// 0..31; anything else is refused (1) and leaves the order as it was.
extern "C" int physics_set_lane_order(const int* order) {
  static_assert(sizeof g_lane_order / sizeof *g_lane_order == magical::LANES,
                "an order entry a lane");
  bool seen[magical::LANES] = {};
  for (int i = 0; i < magical::LANES; ++i) {
    if (order[i] < 0 || order[i] >= magical::LANES || seen[order[i]])
      return 1;
    seen[order[i]] = true;
  }
  memcpy(g_lane_order, order, sizeof g_lane_order);
  return 0;
}

extern "C" int physics_table_layout(int* out) {
  out[0] = magical::FT_CAND_FRICTION;
  out[1] = magical::N_SCALARS;
  out[2] = magical::IT_SLOT_BODY;
  return 0;
}

#define PHYSICS_ARGS                                                      \
  void *pos, void *angle, void *vel, void *omega, void *v_bias,          \
      void *w_bias, void *target_speed, void *rel_turn_angle,            \
      void *target_finger_angle, const void *block_shape,                \
      const void *block_active, const void *phys, void *con_id,          \
      void *con_jn, void *con_jt, void *joint_acc, void *t,              \
      const void *action, const void *ftab, const void *itab, int B,     \
      int mb, int phys_steps, int iterations, void *phase_clock,        \
      void *item_count, void *stream

namespace {

magical::Args physics_args(PHYSICS_ARGS) {
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
  a.phase_clock = nullptr;
  a.item_count = (long long*)item_count;
  return a;
}

// Each env's item list at its state's pose: for every candidate item c
// (first candidate id 2 c), near[b][c] whether the cull keeps it and
// valid[b][c] whether its full test makes a valid contact; -1 for an item
// of an inactive slot.
template <int MB>
void item_tests(const magical::Args& a, int* near, int* valid) {
  using E = magical::WarpEnv<MB>;
  E* e = new E;
  for (int b = 0; b < a.B; ++b) {
    magical::load_env<MB>(a, b, *e, 0);
    for (int s = 0; s < E::NS; ++s) e->build_slot(a.tab, s);
    for (int c = 0; c < E::NITEM; ++c)
      near[(size_t)b * E::NITEM + c] = valid[(size_t)b * E::NITEM + c] = -1;
    for (int j = 0; j < e->n_items; ++j) {
      const int k0 = e->items[j];
      e->narrow(a.tab, k0, 0);
      const size_t q = (size_t)b * E::NITEM + k0 / 2;
      near[q] = e->near_item(a.tab, k0) ? 1 : 0;
      valid[q] = e->stage[0].valid[0] || e->stage[0].valid[1] ? 1 : 0;
    }
  }
  delete e;
}

// One narrowphase of each env at its state's pose, as the control step runs
// it (dense = 0) or as a full test of every item in candidate order (dense =
// 1); its contact list: nc (B,), ids (B, MAXC, 3: candidate, body a, body
// b; -1 past nc), floats (B, MAXC, 8: normal, both lever arms, bias,
// friction) and counts (B, 2: items, items tested in full).
template <int MB>
void narrowphase_lists(const magical::Args& a, int dense, int* nc, int* ids,
                       float* floats, long long* counts) {
  using E = magical::WarpEnv<MB>;
  using magical::LANES;
  E* e = new E;
  for (int b = 0; b < a.B; ++b) {
    magical::load_env<MB>(a, b, *e, 0);
    int tested = e->n_items;
    if (dense) {
      WARP_PHASE({
        for (int s = lane; s < E::NS; s += LANES) e->build_slot(a.tab, s);
        if (lane == 0) e->nc = e->nc_next = 0;
      });
      for (int base = 0; base < e->n_items; base += LANES)
        magical::full_tests<MB>(a.tab, *e, 0, e->items + base, 0,
                                e->n_items - base);
      WARP_PHASE(if (lane == 0) e->nc = e->nc_next);
    } else {
      tested = magical::narrowphase<MB>(a.tab, *e, 0);
    }
    nc[b] = e->nc;
    counts[2 * b] = e->n_items;
    counts[2 * b + 1] = tested;
    for (int m = 0; m < E::MAXC; ++m) {
      const bool on = m < e->nc;
      int* id = ids + ((size_t)b * E::MAXC + m) * 3;
      id[0] = on ? e->cid[m] : -1;
      id[1] = on ? e->ia[m] : -1;
      id[2] = on ? e->ib[m] : -1;
      const float f[8] = {e->cnx[m], e->cny[m], e->r1x[m], e->r1y[m],
                          e->r2x[m], e->r2y[m], e->bias[m], e->cu[m]};
      for (int q = 0; q < 8; ++q)
        floats[((size_t)b * E::MAXC + m) * 8 + q] = on ? f[q] : 0.0f;
    }
  }
  delete e;
}

}  // namespace

#define PHYSICS_PASS                                                       \
  pos, angle, vel, omega, v_bias, w_bias, target_speed, rel_turn_angle,   \
      target_finger_angle, block_shape, block_active, phys, con_id,       \
      con_jn, con_jt, joint_acc, t, action, ftab, itab, B, mb,            \
      phys_steps, iterations, phase_clock, item_count, stream

// The block counts the kernel is built for, each running `body` with MB.
#define MB_SWITCH(body) \
  switch (mb) {         \
    MB_CASE(1, body)    \
    MB_CASE(3, body)    \
    MB_CASE(4, body)    \
    MB_CASE(7, body)    \
    MB_CASE(8, body)    \
    MB_CASE(10, body)   \
    default:            \
      return 1;         \
  }
#define MB_CASE(n, body) \
  case n: {              \
    constexpr int MB = n; \
    body;                \
    return 0;            \
  }

extern "C" float physics_cull_margin() { return magical::CULL_MARGIN; }

extern "C" int physics_control_step(PHYSICS_ARGS) {
  const magical::Args a = physics_args(PHYSICS_PASS);
  // the kernel's warps, one env after another, each phase lane by lane
  MB_SWITCH({
    magical::WarpEnv<MB>* e = new magical::WarpEnv<MB>;
    for (int b = 0; b < B; ++b) magical::control_step_warp<MB>(a, b, *e, 0);
    delete e;
  })
}

extern "C" int physics_item_tests(PHYSICS_ARGS, void* near, void* valid) {
  const magical::Args a = physics_args(PHYSICS_PASS);
  MB_SWITCH(item_tests<MB>(a, (int*)near, (int*)valid))
}

extern "C" int physics_narrowphase(PHYSICS_ARGS, int dense, void* nc,
                                   void* ids, void* floats, void* counts) {
  const magical::Args a = physics_args(PHYSICS_PASS);
  MB_SWITCH(narrowphase_lists<MB>(a, dense, (int*)nc, (int*)ids,
                                  (float*)floats, (long long*)counts))
}

namespace {

using namespace magical_render;

// The loop of render_tiles_kernel (render_tiles.cuh): per env and tile of
// output pixels (ragged at the frame's edge), the prims built from the
// state whose box meets the tile's samples (slots 0 and 1 always), in
// display order, with their boxes; then the tile's pixels over them (at
// hi, the camera on the 4x grid, each pixel classed, then written whole or
// shaded row by row from its start, as shade_tile_hi does).  Where `items`
// and `pixels` (int64 (B, 2) each) are given, each tile adds to its env's
// rows K4's counts: the active prims from slot 2 up, and those of them it
// kept; its pixels, and those of them left undecided.
template <bool HI>
int render_tiles(const SceneArgs& a, int row_tile, int col_tile,
                 long long* items = nullptr, long long* pixels = nullptr) {
  if (a.P > MAX_PRIMS || row_tile <= 0 || col_tile <= 0) return 1;
  static Prim kept[MAX_PRIMS];
  static Box boxes[MAX_PRIMS];
  const int sub = HI ? 4 : 1;
  for (int b = 0; b < a.B; ++b) {
    const Camera cam = env_camera(a, b);
    for (int r0 = 0; r0 < a.res; r0 += row_tile) {
      for (int c0 = 0; c0 < a.res; c0 += col_tile) {
        const int rows = row_tile < a.res - r0 ? row_tile : a.res - r0;
        const int cols = col_tile < a.res - c0 ? col_tile : a.res - c0;
        int n = 0;
        for (int i = 0; i < a.P; ++i) {
          Prim p;
          Box box;
          build_prim(a, b, i, p);
          prim_box(p, cam, box);
          const bool meets = p.active && box_meets(box, sub * r0, sub * rows,
                                                   sub * c0, sub * cols);
          if (items && i >= 2) {
            items[2 * b] += p.active;
            items[2 * b + 1] += meets;
          }
          if (i < 2 || meets) {
            kept[n] = p;
            boxes[n++] = box;
          }
        }
        for (int q = 0; q < rows * cols; ++q) {
          const int row = r0 + q / cols, col = c0 + q % cols;
          unsigned char* rgb =
              a.out + ((size_t)b * a.res * a.res + row * a.res + col) * 3;
          if (!HI) {
            shade_pixel(kept, n, cam, row, col, rgb);
            continue;
          }
          const bool undecided = shade_pixel_hi_classed(
              kept, boxes, n, cam, row, col, hi_class_reach(cam), rgb);
          if (pixels) {
            pixels[2 * b] += 1;
            pixels[2 * b + 1] += undecided;
          }
        }
      }
    }
  }
  return 0;
}

}  // namespace

extern "C" int render_program_layout(int* out) {
  out[0] = PROG_I;
  out[1] = PROG_F;
  out[2] = TF_SIZE;
  out[3] = TI_SIZE;
  return 0;
}

// K2/K3: a lo frame over (row_tile x col_tile) tiles.
extern "C" int render_lo_frame(SCENE_ARGS, void* stream) {
  return render_tiles<false>(SCENE_PASS(res), row_tile, col_tile);
}

// K5: the same over tiles each of which divides res.
extern "C" int render_lo_tiles2d(SCENE_ARGS, void* stream) {
  if (row_tile <= 0 || col_tile <= 0 || res % row_tile != 0 ||
      res % col_tile != 0)
    return 1;
  return render_tiles<false>(SCENE_PASS(res), row_tile, col_tile);
}

// K4: a hi frame over (row_tile x col_tile) output tiles, the camera floats
// describing the 4x grid.
extern "C" int render_hi_frame(SCENE_ARGS, void* stream) {
  return render_tiles<true>(SCENE_PASS(4 * res), row_tile, col_tile);
}

// K4's step entry: the same frame, with its prim and pixel counts added to
// `items` and `pixels` where given.  The host has no clock64(): `cycles`
// is left as it is.
extern "C" int render_hi_into_slot(SCENE_ARGS, void* cycles, void* items,
                                   void* pixels, void* stream) {
  return render_tiles<true>(SCENE_PASS(4 * res), row_tile, col_tile,
                            static_cast<long long*>(items),
                            static_cast<long long*>(pixels));
}

// K4's classes: {HI_REACH, HI_CLASS_MARGIN}.
extern "C" int render_hi_class_constants(float* out) {
  out[0] = HI_REACH;
  out[1] = HI_CLASS_MARGIN;
  return 0;
}

// K4's classes probed on prims given as they are, in `n_cases` cases of
// `n_prims` prims and one output pixel each.  A prim is PROBE_F floats
// (verts NV x 2, nv, radius, colour 3, kind, line width, active; its faces
// and box made here); the camera of the 4x grid is `cam_f` (scale, half,
// npx, npy, c, s, rx, ry, lw_scale, two_scale, bg 3) with `ego` and the
// grid's `res`; case q's pixel is (row, col) = pixels[2 q], pixels[2 q +
// 1].  Out, for each case: each prim's class at the pixel's centre within
// `reach` (prim_class; hi_class_reach where `reach` <= 0) into `classes`
// (n_cases, n_prims), its hard coverage at the 16 subpixel centres, row by
// row, into `alphas` (n_cases, n_prims, 16); the pixel's bytes over the
// case's prims in order, classed within `reach`
// (shade_pixel_hi_classed) into `classed` and subpixel by subpixel
// (shade_pixel_hi) into `plain` (n_cases, 3 each), and whether it was left
// undecided into `undecided` (n_cases).
constexpr int PROBE_F = 2 * NV + 8;
extern "C" int render_hi_probe(const float* prims, int n_cases, int n_prims,
                               const float* cam_f, int ego, int res,
                               const int* pixels, float reach, int* classes,
                               float* alphas, unsigned char* classed,
                               unsigned char* plain, int* undecided) {
  if (n_prims > MAX_PRIMS) return 1;
  static Prim ps[MAX_PRIMS];
  static Box boxes[MAX_PRIMS];
  const Camera cam{res,      ego,      cam_f[0], cam_f[1], cam_f[2],
                   cam_f[3], cam_f[4], cam_f[5], cam_f[6], cam_f[7],
                   cam_f[8], cam_f[9], {cam_f[10], cam_f[11], cam_f[12]}};
  if (reach <= 0.0f) reach = hi_class_reach(cam);
  for (int q = 0; q < n_cases; ++q) {
    for (int k = 0; k < n_prims; ++k) {
      const float* f = prims + ((size_t)q * n_prims + k) * PROBE_F;
      Prim& p = ps[k];
      memcpy(p.v, f, sizeof p.v);
      p.nv = (int)f[2 * NV];
      p.rad = f[2 * NV + 1];
      memcpy(p.col, f + 2 * NV + 2, sizeof p.col);
      p.kind = (int)f[2 * NV + 5];
      p.lw = f[2 * NV + 6];
      p.active = f[2 * NV + 7] != 0.0f;
      prim_faces(p);
      prim_box(p, cam, boxes[k]);
    }
    const int row = pixels[2 * q], col = pixels[2 * q + 1];
    float xc, yc;
    pixel_centre_hi(cam, row, col, &xc, &yc);
    for (int k = 0; k < n_prims; ++k) {
      const size_t qk = (size_t)q * n_prims + k;
      classes[qk] = prim_class(ps[k], cam, xc, yc, reach);
      for (int s = 0; s < 16; ++s) {
        float x, y;
        pixel_world(cam, 4 * row + s / 4, 4 * col + s % 4, &x, &y);
        alphas[qk * 16 + s] = prim_alpha(ps[k], cam, x, y, true);
      }
    }
    undecided[q] = shade_pixel_hi_classed(ps, boxes, n_prims, cam, row, col,
                                          reach, classed + 3 * q);
    shade_pixel_hi(ps, boxes, n_prims, cam, row, col, plain + 3 * q);
  }
  return 0;
}

// build_prim's display list of every env, field by field: verts (B, P, NV,
// 2), nv (B, P), radius (B, P), colour (B, P, 3), active (B, P) as 0 / 1;
// `out`, the camera and the tile are unused.
extern "C" int render_build_display(SCENE_ARGS, void* verts, void* nv,
                                    void* radius, void* color,
                                    void* active) {
  const SceneArgs a = SCENE_PASS(res);
  for (int b = 0; b < B; ++b) {
    for (int i = 0; i < P; ++i) {
      Prim p;
      build_prim(a, b, i, p);
      const size_t q = (size_t)b * P + i;
      memcpy((float*)verts + q * NV * 2, p.v, sizeof p.v);
      ((int*)nv)[q] = p.nv;
      ((float*)radius)[q] = p.rad;
      memcpy((float*)color + q * 3, p.col, sizeof p.col);
      ((int*)active)[q] = p.active ? 1 : 0;
    }
  }
  return 0;
}

// Each prim's screen box (B, P, 4) on the grid the camera floats describe
// and whether it could be bounded (B, P), from the prims build_prim makes,
// as the kernels compute them; `out` and the tile are unused.
extern "C" int render_prim_bboxes(SCENE_ARGS, void* bboxes, void* bounded) {
  const SceneArgs a = SCENE_PASS(res);
  for (int b = 0; b < B; ++b) {
    const Camera cam = env_camera(a, b);
    for (int i = 0; i < P; ++i) {
      Prim p;
      build_prim(a, b, i, p);
      float* bb = (float*)bboxes + ((size_t)b * P + i) * 4;
      ((int*)bounded)[b * P + i] = prim_screen_bbox(p, cam, bb) ? 1 : 0;
    }
  }
  return 0;
}
