// Per-pixel arithmetic of the lo-fidelity compositing kernel
// (render_lo.cu): camera transform, prim SDFs, AA coverage, painter's-order
// blends and the uint8 quantise of core/render.py (render_frame with
// aa=True, then to_uint8).  Plain C++ in __host__ __device__ functions, so
// that it also builds for the host.

#pragma once

#include <math.h>

namespace magical_render {

constexpr int NV = 8;
constexpr int KIND_FILL = 0;
constexpr int KIND_LINE = 1;
constexpr int KIND_LINE_STIPPLE = 2;

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

// Composite every prim over pixel (row, col) and quantise to uint8.
__host__ __device__ inline void shade_pixel(const Prim* prims, int n_prims,
                                            const Camera& cam, int row,
                                            int col, unsigned char* rgb) {
  float x, y;
  pixel_world(cam, row, col, &x, &y);
  float img[3] = {cam.bg[0], cam.bg[1], cam.bg[2]};
  for (int i = 0; i < n_prims; ++i) {
    const Prim& p = prims[i];
    if (!p.active) continue;           // alpha 0: the blend is the identity
    float d = prim_sdf(p, x, y);
    float alpha = clamp01(0.5f - d * cam.scale);
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
    for (int c = 0; c < 3; ++c)
      img[c] = img[c] * (1.0f - alpha) + p.col[c] * alpha;
  }
  for (int c = 0; c < 3; ++c)
    rgb[c] = (unsigned char)floorf(clamp01(img[c]) * 255.0f + 0.5f);
}

}  // namespace magical_render
