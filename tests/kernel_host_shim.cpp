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
  if (mb != 1) return 1;
  for (int b = 0; b < B; ++b) magical::control_step_env<1>(a, b);
  return 0;
}

extern "C" int render_lo_frame(
    const void* verts, const void* nv, const void* radius, const void* color,
    const void* active, const void* kind, const void* lw, const void* pos,
    const void* angle, void* out, int B, int P, int res, int nb, int ego,
    float scale, float half, float npx, float npy, float lw_scale,
    float two_scale, float bg0, float bg1, float bg2, void* stream) {
  using namespace magical_render;
  if (P > 64) return 1;
  Prim prims[64];
  for (int b = 0; b < B; ++b) {
    for (int i = 0; i < P; ++i) {
      Prim& p = prims[i];
      const int q = b * P + i;
      for (int v = 0; v < NV; ++v) {
        p.v[v][0] = ((const float*)verts)[(q * NV + v) * 2];
        p.v[v][1] = ((const float*)verts)[(q * NV + v) * 2 + 1];
      }
      p.nv = ((const int*)nv)[q];
      p.rad = ((const float*)radius)[q];
      for (int c = 0; c < 3; ++c) p.col[c] = ((const float*)color)[q * 3 + c];
      p.active = ((const unsigned char*)active)[q] != 0;
      p.kind = ((const int*)kind)[i];
      p.lw = ((const float*)lw)[i];
      prim_faces(p);
    }
    Camera cam = {res, ego, scale, half, npx, npy, 1.0f, 0.0f, 0.0f, 0.0f,
                  lw_scale, two_scale, {bg0, bg1, bg2}};
    if (ego) {
      const float a = ((const float*)angle)[b * nb];
      cam.c = cosf(a);
      cam.s = sinf(a);
      cam.rx = ((const float*)pos)[b * nb * 2];
      cam.ry = ((const float*)pos)[b * nb * 2 + 1];
    }
    for (int pix = 0; pix < res * res; ++pix)
      shade_pixel(prims, P, cam, pix / res, pix % res,
                  (unsigned char*)out + ((size_t)b * res * res + pix) * 3);
  }
  return 0;
}
