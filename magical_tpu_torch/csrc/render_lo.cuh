// Per-pixel arithmetic of the render kernels (render_tiles.cuh): camera
// transform, prim SDFs, coverage, painter's-order blends and the uint8
// quantise of core/render.py (render_frame, then to_uint8; at hi fidelity
// also the 4x4 box mean of downsample4); the display-list build, which
// makes an env's prims from its state and the scene's display program
// (build_prim, the arithmetic of core/render.py build_display_list); and
// the screen boxes by which the kernels cull prims.  Plain C++ in
// __host__ __device__ functions, so that it also builds for the host.

#pragma once

#include <math.h>

// The cosine and sine of body angles.  On the card these are CUDA's
// cosf / sinf, the functions PyTorch's CUDA cos and sin call; a host build
// may name PyTorch's CPU values instead (tests/kernel_host_shim.cpp).
#ifndef MAGICAL_RENDER_COSF
#define MAGICAL_RENDER_COSF cosf
#define MAGICAL_RENDER_SINF sinf
#endif

namespace magical_render {

constexpr int NV = 8;
constexpr int KIND_FILL = 0;
constexpr int KIND_LINE = 1;
constexpr int KIND_LINE_STIPPLE = 2;

// The most display prims an env's list may hold: the kernels keep the
// prims that meet a block's tile in shared memory, sizeof(Prim) = 200
// bytes a prim (the lo kernels within the 48 KB a block may take without
// opting in to more; the hi kernel, which keeps a 16-byte box beside each,
// opts in past 227 prims).  ClusterColour's Test variants draw 138.
constexpr int MAX_PRIMS = 240;

// One env's display list, staged (in shared memory on the device).
struct Prim {
  float v[NV][2];     // world verts
  float n[NV][2];     // outward face normals
  float offs[NV];     // n . v0 per face
  bool valid[NV];     // face exists
  int nv;
  float rad;
  float col[3];
  int kind;
  float lw;
  bool active;
};
static_assert(MAX_PRIMS * sizeof(Prim) <= 48 * 1024,
              "the staged display list must fit 48 KB of shared memory");


struct Camera {
  int res;
  int ego;            // 0: allocentric, 1: egocentric
  float scale;        // pixels per world unit
  float half;         // allo: world half-width shown
  float npx, npy;     // ego: robot anchor in screen world units
  float c, s;         // ego: cos / sin of the robot angle
  float rx, ry;       // ego: robot position
  float lw_scale;     // res / 384
  float two_scale;    // 2 * scale
  float bg[3];        // background colour
};

// core/render.py _poly_edges + the per-face offsets of _prim_sdf.
__host__ __device__ inline void prim_faces(Prim& p) {
  for (int i = 0; i < NV; ++i) {
    int j = (i + 1 < p.nv) ? i + 1 : 0;
    float ex = p.v[j][0] - p.v[i][0];
    float ey = p.v[j][1] - p.v[i][1];
    float elen = sqrtf(ex * ex + ey * ey);
    float den = fmaxf(elen, 1e-9f);
    p.n[i][0] = ey / den;
    p.n[i][1] = -ex / den;
    p.valid[i] = (i < p.nv) && (elen > 1e-9f);
    p.offs[i] = p.v[i][0] * p.n[i][0] + p.v[i][1] * p.n[i][1];
  }
}

// ---------------------------------------------------------------------------
// The display list built from the state
// ---------------------------------------------------------------------------

// The display program (core/render_kernel.py program_arrays): per display
// slot, in draw order, PROG_I ints and PROG_F floats saying what it draws.
enum { PI_OP, PI_IDX, PI_TABLE, PI_K, PI_SHAPE, PI_NV, PI_COLTAB, PI_KIND,
       PROG_I };
enum { PF_V = 0, PF_RAD = 2 * NV, PF_LW, PF_COL, PROG_F = PF_COL + 3 };
// What a slot draws (PI_OP), from what (PI_IDX):
//   OP_STATIC       the local verts PF_V as they are (the arena);
//   OP_GOAL         goal PI_IDX's box;
//   OP_BODY_POLY    the local verts PF_V on body PI_IDX (a finger part);
//   OP_BODY_CIRCLE  a circle at the robot's centre;
//   OP_EYE          eye PI_IDX: a circle at local offset PF_V[0..1];
//   OP_PUPIL        pupil PI_IDX: the eye offset plus PF_V[2..3], turned
//                   by the eye body's angle relative to the robot's;
//   OP_BLOCK        block PI_IDX's sub-shape PI_K of table PI_TABLE (0 dark
//                   outer parts, 1 bright inner parts), of static shape
//                   PI_SHAPE, or of the env's block_shape where it is -1.
// Colour: PF_COL, or where PI_COLTAB >= 0 colour table PI_COLTAB (0 goal
// light, 1 block, 2 block dark) at the goal's or the block's colour.
enum { OP_STATIC, OP_GOAL, OP_BODY_POLY, OP_BODY_CIRCLE, OP_EYE, OP_PUPIL,
       OP_BLOCK };
constexpr int NSHAPE = 7;    // block shape types
constexpr int KSUB = 6;      // sub-shapes a block
constexpr int NCOLOUR = 4;
// Shared tables: block sub-shapes [table][shape][k] (geometry.BLOCK_VERTS*,
// BLOCK_SUB_*) and colours (constants.GOAL_COLOURS_LIGHT, BLOCK_COLOURS,
// BLOCK_COLOURS_DARK).
constexpr int TF_VERTS = 0;
constexpr int TF_RAD = TF_VERTS + 2 * NSHAPE * KSUB * NV * 2;
constexpr int TF_COLOURS = TF_RAD + 2 * NSHAPE * KSUB;
constexpr int TF_SIZE = TF_COLOURS + 3 * NCOLOUR * 3;
constexpr int TI_NV = 0;
constexpr int TI_ACTIVE = TI_NV + 2 * NSHAPE * KSUB;
constexpr int TI_SIZE = TI_ACTIVE + 2 * NSHAPE * KSUB;

// What a render kernel reads: the EnvState tensors the display list depends
// on, the display program, where the uint8 frame goes, and the camera of
// the grid the kernel samples (the output's, or 4x it at hi fidelity).
struct SceneArgs {
  const float* pos;                   // (B, NB, 2)
  const float* angle;                 // (B, NB)
  const int* block_shape;             // (B, MB)
  const int* block_colour;            // (B, MB)
  const unsigned char* block_active;  // (B, MB) bool
  const float* goal_xyhw;             // (B, MG, 4): centre x, y, h, w
  const int* goal_colour;             // (B, MG)
  const unsigned char* goal_active;   // (B, MG) bool
  const int* prog_i;                  // (P, PROG_I)
  const float* prog_f;                // (P, PROG_F)
  const float* tab_f;                 // (TF_SIZE,)
  const int* tab_i;                   // (TI_SIZE,)
  unsigned char* out;                 // (B, res, res, 3)
  int B, P, res, nb, mb, mg;          // res: the output's resolution
  Camera cam;                         // cam.res: the sampled grid's
};

inline SceneArgs make_scene_args(
    const void* pos, const void* angle, const void* block_shape,
    const void* block_colour, const void* block_active,
    const void* goal_xyhw, const void* goal_colour, const void* goal_active,
    const void* prog_i, const void* prog_f, const void* tab_f,
    const void* tab_i, void* out, int B, int P, int res, int nb, int mb,
    int mg, int cam_res, int ego, float scale, float half, float npx,
    float npy, float lw_scale, float two_scale, float bg0, float bg1,
    float bg2) {
  SceneArgs a;
  a.pos = static_cast<const float*>(pos);
  a.angle = static_cast<const float*>(angle);
  a.block_shape = static_cast<const int*>(block_shape);
  a.block_colour = static_cast<const int*>(block_colour);
  a.block_active = static_cast<const unsigned char*>(block_active);
  a.goal_xyhw = static_cast<const float*>(goal_xyhw);
  a.goal_colour = static_cast<const int*>(goal_colour);
  a.goal_active = static_cast<const unsigned char*>(goal_active);
  a.prog_i = static_cast<const int*>(prog_i);
  a.prog_f = static_cast<const float*>(prog_f);
  a.tab_f = static_cast<const float*>(tab_f);
  a.tab_i = static_cast<const int*>(tab_i);
  a.out = static_cast<unsigned char*>(out);
  a.B = B;
  a.P = P;
  a.res = res;
  a.nb = nb;
  a.mb = mb;
  a.mg = mg;
  a.cam = Camera{cam_res, ego, scale, half, npx, npy, 1.0f, 0.0f, 0.0f,
                 0.0f, lw_scale, two_scale, {bg0, bg1, bg2}};
  return a;
}

// The C entry points' arguments (render_lo.cu, render_hi.cu): the
// pointers and sizes of SceneArgs, the camera floats of the sampled grid
// (core/render_kernel.py camera_args) and the output tile in pixels.
#define SCENE_ARGS                                                          \
  const void *pos, const void *angle, const void *block_shape,             \
      const void *block_colour, const void *block_active,                  \
      const void *goal_xyhw, const void *goal_colour,                      \
      const void *goal_active, const void *prog_i, const void *prog_f,     \
      const void *tab_f, const void *tab_i, void *out, int B, int P,       \
      int res, int nb, int mb, int mg, int ego, float scale, float half,   \
      float npx, float npy, float lw_scale, float two_scale, float bg0,    \
      float bg1, float bg2, int row_tile, int col_tile
// SceneArgs from SCENE_ARGS, the camera's grid at `cam_res`.
#define SCENE_PASS(cam_res)                                                 \
  make_scene_args(pos, angle, block_shape, block_colour, block_active,     \
                  goal_xyhw, goal_colour, goal_active, prog_i, prog_f,     \
                  tab_f, tab_i, out, B, P, res, nb, mb, mg, cam_res, ego,  \
                  scale, half, npx, npy, lw_scale, two_scale, bg0, bg1,    \
                  bg2)

// The camera of env b: the ego view follows the robot's pose.
__host__ __device__ inline Camera env_camera(const SceneArgs& a, int b) {
  Camera cam = a.cam;
  if (cam.ego) {
    const float ang = a.angle[b * a.nb];
    cam.c = MAGICAL_RENDER_COSF(ang);
    cam.s = MAGICAL_RENDER_SINF(ang);
    cam.rx = a.pos[b * a.nb * 2];
    cam.ry = a.pos[b * a.nb * 2 + 1];
  }
  return cam;
}

// Local verts `lv` on a body at (px, py) turned by `ang`, into p.v:
// collision.transform_verts, c x - s y + px in that order.
__host__ __device__ inline void place_verts(const float* lv, float px,
                                            float py, float ang, Prim& p) {
  const float c = MAGICAL_RENDER_COSF(ang), s = MAGICAL_RENDER_SINF(ang);
  for (int v = 0; v < NV; ++v) {
    p.v[v][0] = c * lv[2 * v] - s * lv[2 * v + 1] + px;
    p.v[v][1] = s * lv[2 * v] + c * lv[2 * v + 1] + py;
  }
}

// Slot i of env b's display list, from the state and the display program,
// with its faces: what build_display_list gives slot i (verts, nv, radius,
// colour, active) and static_prim_meta (kind, line width), in the same
// operations.
__host__ __device__ inline void build_prim(const SceneArgs& a, int b, int i,
                                           Prim& p) {
  const int* pi = a.prog_i + i * PROG_I;
  const float* pf = a.prog_f + i * PROG_F;
  const int idx = pi[PI_IDX];
  const float* pos = a.pos + (size_t)b * a.nb * 2;
  const float* ang = a.angle + (size_t)b * a.nb;
  p.nv = pi[PI_NV];
  p.rad = pf[PF_RAD];
  p.kind = pi[PI_KIND];
  p.lw = pf[PF_LW];
  p.active = true;
  int colour = 0;                      // row of the colour table
  switch (pi[PI_OP]) {
    case OP_STATIC:
      for (int v = 0; v < NV; ++v) {
        p.v[v][0] = pf[PF_V + 2 * v];
        p.v[v][1] = pf[PF_V + 2 * v + 1];
      }
      break;
    case OP_GOAL: {
      // render.py build_display_list: the box TR, TL, BL, BR, padded
      // with BR
      const size_t g = (size_t)b * a.mg + idx;
      const float* x = a.goal_xyhw + g * 4;
      const float cx = x[0], cy = x[1], h = x[2], w = x[3];
      const float xr = cx + w / 2.0f, xl = cx - w / 2.0f;
      const float yt = cy + h / 2.0f, yb = cy - h / 2.0f;
      p.v[0][0] = xr;
      p.v[0][1] = yt;
      p.v[1][0] = xl;
      p.v[1][1] = yt;
      p.v[2][0] = xl;
      p.v[2][1] = yb;
      for (int v = 3; v < NV; ++v) {
        p.v[v][0] = xr;
        p.v[v][1] = yb;
      }
      p.active = a.goal_active[g] != 0;
      colour = a.goal_colour[g];
      break;
    }
    case OP_BODY_POLY:
      place_verts(pf + PF_V, pos[2 * idx], pos[2 * idx + 1], ang[idx], p);
      break;
    case OP_BODY_CIRCLE:
      for (int v = 0; v < NV; ++v) {
        p.v[v][0] = pos[0];
        p.v[v][1] = pos[1];
      }
      break;
    case OP_EYE:
    case OP_PUPIL: {
      // c0 + _mat_vec(ca, sa, eye_local [+ off]), off the pupil offset
      // turned by the eye body's angle relative to the robot's
      const float ca = MAGICAL_RENDER_COSF(ang[0]);
      const float sa = MAGICAL_RENDER_SINF(ang[0]);
      float ex = pf[PF_V], ey = pf[PF_V + 1];
      if (pi[PI_OP] == OP_PUPIL) {
        const float rot = ang[3 + idx] - ang[0];
        const float cp = MAGICAL_RENDER_COSF(rot);
        const float sp = MAGICAL_RENDER_SINF(rot);
        const float ox = pf[PF_V + 2], oy = pf[PF_V + 3];
        const float offx = cp * ox - sp * oy, offy = sp * ox + cp * oy;
        ex = ex + offx;
        ey = ey + offy;
      }
      const float x = pos[0] + (ca * ex - sa * ey);
      const float y = pos[1] + (sa * ex + ca * ey);
      for (int v = 0; v < NV; ++v) {
        p.v[v][0] = x;
        p.v[v][1] = y;
      }
      break;
    }
    default: {                         // OP_BLOCK
      const size_t bi = (size_t)b * a.mb + idx;
      const int shape = pi[PI_SHAPE] >= 0 ? pi[PI_SHAPE] : a.block_shape[bi];
      const int tk = (pi[PI_TABLE] * NSHAPE + shape) * KSUB + pi[PI_K];
      const int body = 5 + idx;
      place_verts(a.tab_f + TF_VERTS + tk * NV * 2, pos[2 * body],
                  pos[2 * body + 1], ang[body], p);
      p.nv = a.tab_i[TI_NV + tk];
      p.rad = a.tab_f[TF_RAD + tk];
      p.active = a.block_active[bi] != 0 && a.tab_i[TI_ACTIVE + tk] != 0;
      colour = a.block_colour[bi];
      break;
    }
  }
  const int tab = pi[PI_COLTAB];
  for (int c = 0; c < 3; ++c)
    p.col[c] = tab < 0 ? pf[PF_COL + c]
                       : a.tab_f[TF_COLOURS + (tab * NCOLOUR + colour) * 3 + c];
  prim_faces(p);
}

// World coordinates of the centre of pixel (row, col).
__host__ __device__ inline void pixel_world(const Camera& cam, int row,
                                            int col, float* x, float* y) {
  float cx = ((float)col + 0.5f) / cam.scale;
  if (!cam.ego) {
    float cy = ((float)row + 0.5f) / cam.scale;
    *x = cx - cam.half;
    *y = cam.half - cy;
    return;
  }
  float cy = ((float)cam.res - (float)row - 0.5f) / cam.scale;
  float spx = cx - cam.npx, spy = cy - cam.npy;
  *x = cam.c * spx - cam.s * spy + cam.rx;
  *y = cam.s * spx + cam.c * spy + cam.ry;
}

__host__ __device__ inline float prim_sdf(const Prim& p, float x, float y) {
  if (p.nv == 1) {
    float dx = x - p.v[0][0], dy = y - p.v[0][1];
    return sqrtf(dx * dx + dy * dy) - p.rad;
  }
  float d = -1e9f;
  for (int f = 0; f < NV; ++f) {
    float df = p.valid[f] ? x * p.n[f][0] + y * p.n[f][1] - p.offs[f]
                          : -1e9f;
    d = fmaxf(d, df);
  }
  return d - p.rad;
}

// Perimeter arc length of the nearest point on the box outline (verts
// 0..3), CCW from vertex 0: the stipple phase.
__host__ __device__ inline float box_arclen(const Prim& p, float x,
                                            float y) {
  float best_d = 1e9f, best_s = 0.0f, s_acc = 0.0f;
  for (int k = 0; k < 4; ++k) {
    float ax = p.v[k][0], ay = p.v[k][1];
    float abx = p.v[(k + 1) % 4][0] - ax, aby = p.v[(k + 1) % 4][1] - ay;
    float ablen = fmaxf(sqrtf(abx * abx + aby * aby), 1e-9f);
    float rx = x - ax, ry = y - ay;
    float t = (rx * abx + ry * aby) / (ablen * ablen);
    t = fminf(fmaxf(t, 0.0f), 1.0f);
    float qx = x - (ax + t * abx), qy = y - (ay + t * aby);
    float d = sqrtf(qx * qx + qy * qy);
    float s_here = s_acc + t * ablen;
    if (d < best_d) {
      best_d = d;
      best_s = s_here;
    }
    s_acc = s_acc + ablen;
  }
  return best_s;
}

__host__ __device__ inline float clamp01(float x) {
  return fminf(fmaxf(x, 0.0f), 1.0f);
}

// Coverage of prim p at world point (x, y): its alpha in the blend.
// `hard`: a fill gets hard (non-antialiased) coverage, the sign of the SDF,
// as render_frame(aa=False) gives it; outlines keep their smoothed band
// either way.
__host__ __device__ inline float prim_alpha(const Prim& p, const Camera& cam,
                                            float x, float y, bool hard) {
  float d = prim_sdf(p, x, y);
  float alpha = hard ? (d < 0.0f ? 1.0f : 0.0f)
                     : clamp01(0.5f - d * cam.scale);
  if (p.kind != KIND_FILL) {
    // outlines: smoothed band (GL_LINE_SMOOTH in the reference)
    float half_lw_w = fmaxf(p.lw * cam.lw_scale, 1.0f) / cam.two_scale;
    alpha = clamp01((half_lw_w - fabsf(d)) * cam.scale + 0.5f);
    if (p.kind == KIND_LINE_STIPPLE) {
      // 8 px on / off along the perimeter (pattern 0x00FF)
      float s = box_arclen(p, x, y) * cam.scale;
      bool on = fmodf(floorf(s), 16.0f) < 8.0f;
      alpha = alpha * (on ? 1.0f : 0.0f);
    }
  }
  return alpha;
}

// A channel's uint8 level (as a float): to_uint8.
__host__ __device__ inline float level_of(float x) {
  return floorf(clamp01(x) * 255.0f + 0.5f);
}

// ---------------------------------------------------------------------------
// Culling by screen box
// ---------------------------------------------------------------------------

// Screen position of world point (x, y) in pixel-centre units: pixel
// (row, col) has its centre at u = col + 0.5, w = row + 0.5.  The inverse
// of pixel_world.
__host__ __device__ inline void world_screen(const Camera& cam, float x,
                                             float y, float* u, float* w) {
  if (!cam.ego) {
    *u = (x + cam.half) * cam.scale;
    *w = (cam.half - y) * cam.scale;
    return;
  }
  float dx = x - cam.rx, dy = y - cam.ry;
  float spx = cam.c * dx + cam.s * dy, spy = -cam.s * dx + cam.c * dy;
  *u = (spx + cam.npx) * cam.scale;
  *w = (float)cam.res - (spy + cam.npy) * cam.scale;
}

// The screen box {u_min, u_max, w_min, w_max} outside which prim p has
// alpha exactly 0, so that a pixel of it composites as if the prim were
// absent.  Returns false where it cannot bound the prim (a degenerate
// face); such a prim is never culled.
//
// A pixel gets alpha > 0 only where the SDF is below R = 0.5 px (a fill)
// or the line's half width + 0.5 px (an outline).  Taken with the margin
// of render_batch_pallas (1 px + the line's half width), R also covers
// rounding by 0.5 px.  A circle's SDF is its centre distance, so its box
// is the centre +- (radius + R).  A polygon's SDF is the largest of its
// face distances, which near a sharp vertex stays under R well beyond
// radius + R on the axis (a star tip of 45 degrees keeps alpha up to 0.12
// at 1 px past that): its box is that of the polygon with every face
// pushed out by radius + R, whose vertex between faces of normals n0 and
// n1 is v + (radius + R) (n0 + n1) / (1 + n0 . n1).
__host__ __device__ inline bool prim_screen_bbox(const Prim& p,
                                                 const Camera& cam,
                                                 float* bb) {
  float margin = 1.0f;
  if (p.kind != KIND_FILL) margin += fmaxf(p.lw * cam.lw_scale, 1.0f) * 0.5f;
  const float r = p.rad + margin / cam.scale;          // world units
  if (p.nv == 1) {
    float u, w;
    world_screen(cam, p.v[0][0], p.v[0][1], &u, &w);
    const float rp = r * cam.scale;
    bb[0] = u - rp;
    bb[1] = u + rp;
    bb[2] = w - rp;
    bb[3] = w + rp;
    return true;
  }
  bb[0] = bb[2] = 1e30f;
  bb[1] = bb[3] = -1e30f;
  for (int i = 0; i < p.nv; ++i) {
    const int h = i == 0 ? p.nv - 1 : i - 1;         // the face before
    if (!p.valid[h] || !p.valid[i]) return false;
    const float den =
        1.0f + (p.n[h][0] * p.n[i][0] + p.n[h][1] * p.n[i][1]);
    if (den < 1e-3f) return false;                   // a needle vertex
    const float k = r / den;
    float u, w;
    world_screen(cam, p.v[i][0] + k * (p.n[h][0] + p.n[i][0]),
                 p.v[i][1] + k * (p.n[h][1] + p.n[i][1]), &u, &w);
    bb[0] = fminf(bb[0], u);
    bb[1] = fmaxf(bb[1], u);
    bb[2] = fminf(bb[2], w);
    bb[3] = fmaxf(bb[3], w);
  }
  return true;
}

// A prim's screen box as the kernels keep it: prim_screen_bbox's, or the
// whole plane where that cannot bound the prim.
struct Box {
  float bb[4];                         // u_min, u_max, w_min, w_max
};

__host__ __device__ inline void prim_box(const Prim& p, const Camera& cam,
                                         Box& box) {
  if (!prim_screen_bbox(p, cam, box.bb)) {
    box.bb[0] = box.bb[2] = -1e30f;
    box.bb[1] = box.bb[3] = 1e30f;
  }
}

// Whether `box` meets the sample centres of the tile of rows [r0, r0 +
// rows) and columns [c0, c0 + cols) of the camera's grid on both axes.
__host__ __device__ inline bool box_meets(const Box& box, int r0, int rows,
                                          int c0, int cols) {
  const float* bb = box.bb;
  return !(bb[1] < (float)c0 + 0.5f || bb[0] > (float)(c0 + cols) - 0.5f ||
           bb[3] < (float)r0 + 0.5f || bb[2] > (float)(r0 + rows) - 0.5f);
}

// Lo fidelity: prims `prims` composited in order over the centre of pixel
// (row, col) with antialiased coverage, each channel quantised.
__host__ __device__ inline void shade_pixel(const Prim* prims, int n_prims,
                                            const Camera& cam, int row,
                                            int col, unsigned char* rgb) {
  float x, y;
  pixel_world(cam, row, col, &x, &y);
  float img[3] = {cam.bg[0], cam.bg[1], cam.bg[2]};
  for (int i = 0; i < n_prims; ++i) {
    const Prim& p = prims[i];
    if (!p.active) continue;           // alpha 0: the blend is the identity
    const float alpha = prim_alpha(p, cam, x, y, false);
    for (int c = 0; c < 3; ++c)
      img[c] = img[c] * (1.0f - alpha) + p.col[c] * alpha;
  }
  for (int c = 0; c < 3; ++c) rgb[c] = (unsigned char)level_of(img[c]);
}

// Hi fidelity, subpixel by subpixel: output pixel (row, col) is the
// rounded mean of the uint8 levels of its 4x4 subpixels, each composited
// with hard fills on the camera's 4x grid (`cam` describes that grid: res,
// scale and line scale at 4x).  A row of four subpixels goes through the
// prims together, over those whose box (`boxes`, prim_box on the 4x grid)
// meets the row: a prim has coverage exactly 0 outside its box, and
// out * (1 - 0) + c * 0 == out, so the others change nothing.  The levels
// are integers and their sum is at most 16 * 255, so the float sum is
// exact in any order, as is the division by 16.  K4 runs the classed path
// below, which the host build of the tests holds to this byte for byte.
__host__ __device__ inline void shade_pixel_hi(const Prim* prims,
                                               const Box* boxes, int n_prims,
                                               const Camera& cam, int row,
                                               int col, unsigned char* rgb) {
  float sum[3] = {0.0f, 0.0f, 0.0f};
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * row + i;
    float x[4], y[4], img[4][3];
    for (int j = 0; j < 4; ++j) {
      pixel_world(cam, r, 4 * col + j, &x[j], &y[j]);
      for (int c = 0; c < 3; ++c) img[j][c] = cam.bg[c];
    }
    for (int k = 0; k < n_prims; ++k) {
      const Prim& p = prims[k];
      if (!p.active || !box_meets(boxes[k], r, 1, 4 * col, 4)) continue;
      for (int j = 0; j < 4; ++j) {
        const float alpha = prim_alpha(p, cam, x[j], y[j], true);
        for (int c = 0; c < 3; ++c)
          img[j][c] = img[j][c] * (1.0f - alpha) + p.col[c] * alpha;
      }
    }
    for (int j = 0; j < 4; ++j)
      for (int c = 0; c < 3; ++c) sum[c] += level_of(img[j][c]);
  }
  for (int c = 0; c < 3; ++c)
    rgb[c] = (unsigned char)floorf(sum[c] / 16.0f + 0.5f);
}

// ---------------------------------------------------------------------------
// Hi fidelity by coverage class: what K4 runs (render_tiles.cuh)
// ---------------------------------------------------------------------------

// A prim's coverage over the 4x4 subpixels of one output pixel, decided
// from its SDF at their centre: exactly 0 at all 16 (none), exactly 1 at
// all 16 (full: a fill only), or anything else (partial).
constexpr int COVER_NONE = 0;
constexpr int COVER_FULL = 1;
constexpr int COVER_PARTIAL = 2;

// Subpixels from a pixel's centre to its farthest subpixel centre,
// 1.5 sqrt 2 = 2.12132034..., rounded up.
constexpr float HI_REACH = 2.1213204f;

// The classes' rounding margin, in world units.  The SDF (prim_sdf) is
// 1-Lipschitz in exact arithmetic: a circle's is its centre distance less
// the radius, a polygon's the largest of its face distances along unit
// normals (|n| within 1e-7 of 1 after rounding) less the radius.  So
// between the centre and a subpixel centre, at most HI_REACH / scale apart
// in the world (the ego view turns the grid, it does not stretch it), the
// exact SDF moves by at most that.  What the margin must cover is the
// float rounding of the two SDFs the classes compare, each computed from a
// computed point:
// - the points (pixel_world, pixel_centre_hi): world coordinates below ~4
//   in magnitude (the ego view's farthest corner from the arena's centre),
//   a division, a subtraction and, ego, a rotation and a translation:
//   below 1.5e-6 a coordinate, 2.2e-6 in distance;
// - prim_sdf: two products, a sum and a difference of terms below ~8
//   (circle: differences, squares, a root), a few 1e-7 each: below 1.5e-6;
//   the normals' length, 1e-7 relative on distances below ~6: 6e-7;
// - an outline's band, (half width - |d|) * scale + 0.5, rounds by 1e-7
//   relative: below 4e-7 in the world.
// So the two SDFs are off by at most ~1e-5 in all; 1e-4 (0.019 subpixels
// at 96², 0.075 at 384²) covers that 10 times over and leaves a prim's
// class partial only within ~2.2 subpixels of its edge.
constexpr float HI_CLASS_MARGIN = 1e-4f;

// How far from a pixel's centre, in world units, the classes must hold:
// HI_REACH subpixels of the camera's 4x grid and the margin.
__host__ __device__ inline float hi_class_reach(const Camera& cam) {
  return HI_REACH / cam.scale + HI_CLASS_MARGIN;
}

// World coordinates of the centre of output pixel (row, col)'s 4x4
// subpixels, the grid point (4 row + 2, 4 col + 2) of the camera's 4x grid:
// pixel_world's arithmetic with 2 in place of 0.5.
__host__ __device__ inline void pixel_centre_hi(const Camera& cam, int row,
                                                int col, float* x, float* y) {
  float cx = (float)(4 * col + 2) / cam.scale;
  if (!cam.ego) {
    float cy = (float)(4 * row + 2) / cam.scale;
    *x = cx - cam.half;
    *y = cam.half - cy;
    return;
  }
  float cy = ((float)cam.res - (float)(4 * row + 2)) / cam.scale;
  float spx = cx - cam.npx, spy = cy - cam.npy;
  *x = cam.c * spx - cam.s * spy + cam.rx;
  *y = cam.s * spx + cam.c * spy + cam.ry;
}

// The class of prim p over the subpixels within `reach` (hi_class_reach)
// of world point (x, y), a pixel's centre.  A fill's hard coverage is
// d < 0 at a subpixel: 0 at all where d > reach at the centre, 1 where
// d < -reach.  An outline's band alpha is 0 where |d| >= its half width +
// 0.5 / scale: at all where |d| - reach passes that at the centre; the
// stipple only multiplies by 0 or 1.  An outline is never full.
__host__ __device__ inline int prim_class(const Prim& p, const Camera& cam,
                                          float x, float y, float reach) {
  const float d = prim_sdf(p, x, y);
  if (p.kind == KIND_FILL)
    return d > reach ? COVER_NONE : d < -reach ? COVER_FULL : COVER_PARTIAL;
  const float band = fmaxf(p.lw * cam.lw_scale, 1.0f) / cam.two_scale +
                     0.5f / cam.scale;
  return fabsf(d) - reach >= band ? COVER_NONE : COVER_PARTIAL;
}

// Output pixel (row, col) of the kept prims (their boxes `boxes` on the 4x
// grid, n_prims of them in display order), classed at its centre from the
// top down: returns the index after its topmost full prim (0 where none
// is full), with `partial` set where a partial prim lies above it.  A
// prim whose box misses the pixel's subpixels, or that is inactive, is
// none without an SDF.  A full prim gives img * (1 - 1) + c * 1 == c at
// every subpixel, so the blend restarts at its colour and the prims below
// it change nothing; a none prim gives out * (1 - 0) + c * 0 == out.
__host__ __device__ inline int class_pixel_hi(const Prim* prims,
                                              const Box* boxes, int n_prims,
                                              const Camera& cam, int row,
                                              int col, float reach,
                                              bool* partial) {
  float x, y;
  pixel_centre_hi(cam, row, col, &x, &y);
  *partial = false;
  for (int k = n_prims - 1; k >= 0; --k) {
    const Prim& p = prims[k];
    if (!p.active || !box_meets(boxes[k], 4 * row, 4, 4 * col, 4)) continue;
    const int cls = prim_class(p, cam, x, y, reach);
    if (cls == COVER_FULL) return k + 1;
    if (cls == COVER_PARTIAL) *partial = true;
  }
  return 0;
}

// The colour a pixel's blend starts from at index `start`: the full prim
// below it, or the background.
__host__ __device__ inline const float* start_colour_hi(const Prim* prims,
                                                        int start,
                                                        const Camera& cam) {
  return start > 0 ? prims[start - 1].col : cam.bg;
}

// A pixel with no partial prim above `start`: its 16 subpixels are that
// colour, each of level L, and floorf(16 L / 16 + 0.5) == L.
__host__ __device__ inline void write_decided_hi(const Prim* prims, int start,
                                                 const Camera& cam,
                                                 unsigned char* rgb) {
  const float* col = start_colour_hi(prims, start, cam);
  for (int c = 0; c < 3; ++c) rgb[c] = (unsigned char)level_of(col[c]);
}

// Row i of output pixel (row, col)'s subpixels, from `start`
// (class_pixel_hi): each of its 4 subpixels starts at the start colour and
// blends, in display order, the prims above `start` whose box meets the
// row, with shade_pixel_hi's arithmetic; their uint8 levels are added to
// `sum`.  Those are the pixel's partial prims and any it classed none
// there, whose blend is the identity: skipping those by their class again
// made K4 9-17% slower on the card (PERF.md §6), since few are none.
__host__ __device__ inline void shade_row_hi(const Prim* prims,
                                             const Box* boxes, int n_prims,
                                             int start, const Camera& cam,
                                             int row, int col, int i,
                                             float* sum) {
  const float* c0 = start_colour_hi(prims, start, cam);
  const int r = 4 * row + i;
  float x[4], y[4], img[4][3];
  for (int j = 0; j < 4; ++j) {
    pixel_world(cam, r, 4 * col + j, &x[j], &y[j]);
    for (int c = 0; c < 3; ++c) img[j][c] = c0[c];
  }
  for (int k = start; k < n_prims; ++k) {
    const Prim& p = prims[k];
    if (!p.active || !box_meets(boxes[k], r, 1, 4 * col, 4)) continue;
    for (int j = 0; j < 4; ++j) {
      const float alpha = prim_alpha(p, cam, x[j], y[j], true);
      for (int c = 0; c < 3; ++c)
        img[j][c] = img[j][c] * (1.0f - alpha) + p.col[c] * alpha;
    }
  }
  for (int j = 0; j < 4; ++j)
    for (int c = 0; c < 3; ++c) sum[c] += level_of(img[j][c]);
}

// The byte of a pixel whose 16 subpixel levels add up to `sum`: the
// rounded mean.  The levels are integers, their sum at most 16 * 255, so
// the float sum is exact in any order, as is the division by 16.
__host__ __device__ inline unsigned char mean_level_hi(float sum) {
  return (unsigned char)floorf(sum / 16.0f + 0.5f);
}

// Hi fidelity by class: output pixel (row, col) equal, byte for byte, to
// shade_pixel_hi's, decided whole where class_pixel_hi leaves no partial
// prim, else shaded row by row from its start.  The host's loop; the
// kernel spreads the undecided pixels' rows over lanes.
__host__ __device__ inline bool shade_pixel_hi_classed(
    const Prim* prims, const Box* boxes, int n_prims, const Camera& cam,
    int row, int col, float reach, unsigned char* rgb) {
  bool partial;
  const int start =
      class_pixel_hi(prims, boxes, n_prims, cam, row, col, reach, &partial);
  if (!partial) {
    write_decided_hi(prims, start, cam, rgb);
    return false;
  }
  float sum[3] = {0.0f, 0.0f, 0.0f};
  for (int i = 0; i < 4; ++i)
    shade_row_hi(prims, boxes, n_prims, start, cam, row, col, i, sum);
  for (int c = 0; c < 3; ++c) rgb[c] = mean_level_hi(sum[c]);
  return true;
}

}  // namespace magical_render
