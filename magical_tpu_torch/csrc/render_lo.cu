// Lo-fidelity (analytic AA) compositing of MAGICAL frames: the Hopper
// kernel behind core/render_kernel.py, with two entry points.
//
// Replaces two Pallas kernels that share one body (_render_kernel_body,
// magical_tpu/core/render_pallas.py:430):
//   render_lo_into_slot  the slot-writing render of every step,
//                        render_into_slots_pallas (:815), pl.pallas_call
//                        at render_pallas.py:918 (K2);
//   render_lo_frame      the fresh-frame render (reset frames),
//                        render_batch_pallas (:608), lo branch,
//                        pl.pallas_call at render_pallas.py:766 (K3).
// It computes what the XLA reference magical_tpu/core/render.py
// render_frame(aa=True) + to_uint8 computes (:320-386), in world space,
// not the Pallas kernel's re-associated screen-space maths (no static
// ego overlay, no finger-group union blends, no trivial-slab fills).
//
// What bounds it on the H100: arithmetic.  Each pixel evaluates every
// prim's SDF (up to 8 faces) and blend, ~20 prims for MoveToCorner, so a
// 96x96 frame is ~4 MFLOP against 27 KB of uint8 output and a few KB of
// display list.  The design: one block per (env, tile of 256 pixels), one
// thread per pixel; the env's display list, with its face normals and
// offsets precomputed once per block, is staged in shared memory and read
// by every thread as a broadcast.  The camera transform is computed in
// the kernel from the robot pose.  The frame is written as uint8 (B, res,
// res, 3) straight into its destination: a slot of the frame ring (K2) or
// a fresh frame (K3).

#include <cuda_runtime.h>

#include "render_lo.cuh"

using namespace magical_render;

namespace {

constexpr int MAX_PRIMS = 64;
constexpr int THREADS = 256;

struct RenderArgs {
  const float* verts;           // (B, P, NV, 2)
  const int* nv;                // (B, P)
  const float* radius;          // (B, P)
  const float* color;           // (B, P, 3)
  const unsigned char* active;  // (B, P) bool
  const int* kind;              // (P,)
  const float* lw;              // (P,)
  const float* pos;             // (B, NB, 2) robot pose source
  const float* angle;           // (B, NB)
  unsigned char* out;           // (B, res, res, 3)
  int B, P, res, nb;
  Camera cam;
};

__global__ void render_lo_kernel(RenderArgs a) {
  __shared__ Prim prims[MAX_PRIMS];
  const int b = blockIdx.y;
  for (int i = threadIdx.x; i < a.P; i += blockDim.x) {
    Prim& p = prims[i];
    const int q = b * a.P + i;
    for (int v = 0; v < NV; ++v) {
      p.v[v][0] = a.verts[(q * NV + v) * 2];
      p.v[v][1] = a.verts[(q * NV + v) * 2 + 1];
    }
    p.nv = a.nv[q];
    p.rad = a.radius[q];
    for (int c = 0; c < 3; ++c) p.col[c] = a.color[q * 3 + c];
    p.active = a.active[q] != 0;
    p.kind = a.kind[i];
    p.lw = a.lw[i];
    prim_faces(p);
  }
  __syncthreads();
  Camera cam = a.cam;
  if (cam.ego) {
    const float ang = a.angle[b * a.nb];
    cam.c = cosf(ang);
    cam.s = sinf(ang);
    cam.rx = a.pos[b * a.nb * 2];
    cam.ry = a.pos[b * a.nb * 2 + 1];
  }
  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= a.res * a.res) return;      // ragged edge of the last tile
  shade_pixel(prims, a.P, cam, pix / a.res, pix % a.res,
              a.out + ((size_t)b * a.res * a.res + pix) * 3);
}

int launch(const void* verts, const void* nv, const void* radius,
           const void* color, const void* active, const void* kind,
           const void* lw, const void* pos, const void* angle, void* out,
           int B, int P, int res, int nb, int ego, float scale, float half,
           float npx, float npy, float lw_scale, float two_scale,
           float bg0, float bg1, float bg2, void* stream) {
  if (P > MAX_PRIMS || B > 65535) return (int)cudaErrorInvalidValue;
  if (B <= 0) return 0;
  RenderArgs a;
  a.verts = static_cast<const float*>(verts);
  a.nv = static_cast<const int*>(nv);
  a.radius = static_cast<const float*>(radius);
  a.color = static_cast<const float*>(color);
  a.active = static_cast<const unsigned char*>(active);
  a.kind = static_cast<const int*>(kind);
  a.lw = static_cast<const float*>(lw);
  a.pos = static_cast<const float*>(pos);
  a.angle = static_cast<const float*>(angle);
  a.out = static_cast<unsigned char*>(out);
  a.B = B;
  a.P = P;
  a.res = res;
  a.nb = nb;
  a.cam.res = res;
  a.cam.ego = ego;
  a.cam.scale = scale;
  a.cam.half = half;
  a.cam.npx = npx;
  a.cam.npy = npy;
  a.cam.c = 1.0f;
  a.cam.s = 0.0f;
  a.cam.rx = 0.0f;
  a.cam.ry = 0.0f;
  a.cam.lw_scale = lw_scale;
  a.cam.two_scale = two_scale;
  a.cam.bg[0] = bg0;
  a.cam.bg[1] = bg1;
  a.cam.bg[2] = bg2;
  dim3 grid((res * res + THREADS - 1) / THREADS, B);
  render_lo_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      a);
  return (int)cudaGetLastError();
}

}  // namespace

#define RENDER_ARGS                                                        \
  const void *verts, const void *nv, const void *radius, const void *color, \
      const void *active, const void *kind, const void *lw,                \
      const void *pos, const void *angle, void *out, int B, int P,         \
      int res, int nb, int ego, float scale, float half, float npx,        \
      float npy, float lw_scale, float two_scale, float bg0, float bg1,    \
      float bg2, void *stream
#define RENDER_PASS                                                       \
  verts, nv, radius, color, active, kind, lw, pos, angle, out, B, P, res, \
      nb, ego, scale, half, npx, npy, lw_scale, two_scale, bg0, bg1, bg2,  \
      stream

// K2: the step frame, into the ring slot `out` points at.
extern "C" int render_lo_into_slot(RENDER_ARGS) {
  return launch(RENDER_PASS);
}

// K3: a fresh frame.
extern "C" int render_lo_frame(RENDER_ARGS) { return launch(RENDER_PASS); }
