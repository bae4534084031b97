// Host build of the reset's placement (magical_tpu_torch/csrc/place.cu),
// for tests/test_torch_kernel_host.py: the kernel's per-proposal test,
// place.cuh's __host__ __device__ code, and its rounds of LANES proposals,
// looped over the envs on the CPU.  Built with contraction off, so that it
// rounds every operation as the plain PyTorch version does.  It stands
// apart from kernel_host_shim.cpp, so that a test can build a variant of
// the placement's comparison (MAGICAL_PLACE_LT) in a second or two.
#define __host__
#define __device__
#include <math.h>
#include <stddef.h>
#include <string.h>

#include <unordered_map>

// The placement's square roots: PyTorch's CPU sqrt is one ulp off the
// correctly rounded root on rare inputs, where CUDA's sqrtf and PyTorch's
// CUDA sqrt are one function.  So a test hands in PyTorch's values
// (place_add_sqrt); an input it did not hand in takes libm's and is kept
// (place_sqrt_misses), for the test to hand in and run again.
namespace {
unsigned float_bits(float x) {
  unsigned u;
  memcpy(&u, &x, sizeof u);
  return u;
}

std::unordered_map<unsigned, float> g_sqrt;
std::unordered_map<unsigned, float> g_sqrt_missed;

float shim_sqrtf(float x) {
  auto it = g_sqrt.find(float_bits(x));
  if (it != g_sqrt.end()) return it->second;
  g_sqrt_missed[float_bits(x)] = x;
  return sqrtf(x);
}
}  // namespace

#define MAGICAL_PLACE_SQRTF shim_sqrtf

#include "place.cuh"

#define PLACE_ARGS                                                          \
  const void *pos, const void *cos_a, const void *sin_a,                   \
      const void *ent_v, const void *ent_rad, const void *ent_nv,          \
      const void *ent_act, const void *pl_v, const void *pl_rad,           \
      const void *pl_nv, const void *pl_act, const void *mask, void *pick, \
      void *ok, void *counts, int B, int T, int E

namespace mp = magical_place;

namespace {

mp::Args place_args(PLACE_ARGS) {
  mp::Args a;
  a.pos = (const float*)pos;
  a.cos_a = (const float*)cos_a;
  a.sin_a = (const float*)sin_a;
  a.ent_v = (const float*)ent_v;
  a.ent_rad = (const float*)ent_rad;
  a.ent_nv = (const int*)ent_nv;
  a.ent_act = (const unsigned char*)ent_act;
  a.pl_v = (const float*)pl_v;
  a.pl_rad = (const float*)pl_rad;
  a.pl_nv = (const int*)pl_nv;
  a.pl_act = (const unsigned char*)pl_act;
  a.mask = (const unsigned char*)mask;
  a.pick = (long long*)pick;
  a.ok = (unsigned char*)ok;
  a.counts = (long long*)counts;
  a.B = B;
  a.T = T;
  a.E = E;
  return a;
}

// Env b's entity and its placed sub-shapes, packed in item order as the
// kernel's ballot packs them; returns their number.
int place_stage(const mp::Args& a, int b,
                mp::Local& ent, mp::Shape* placed) {
  for (int i = 0; i < mp::NLOCAL; ++i) mp::load_local(a, b, i, ent);
  int n = 0;
  for (int i = 0; i < a.E * mp::KSUB; ++i)
    if (mp::placed_on(a, b, i)) mp::load_placed(a, b, i, placed[n++]);
  return n;
}

}  // namespace

// The kernel's placement, env by env: its rounds of LANES proposals, each
// lane's test in turn, the round's lowest fitting lane the pick.
extern "C" int place_first_fit(PLACE_ARGS, void* stream) {
  const mp::Args a = place_args(pos, cos_a, sin_a, ent_v, ent_rad, ent_nv,
                            ent_act, pl_v, pl_rad, pl_nv, pl_act, mask, pick,
                            ok, counts, B, T, E);
  if (T <= 0 || E < 0) return 1;
  static mp::Local ent;
  mp::Shape* placed = new mp::Shape[E * mp::KSUB + 1];
  for (int b = 0; b < B; ++b) {
    const int n = place_stage(a, b, ent, placed);
    int pk = T - 1, tested = 0;
    bool fit = false;
    for (int base = 0; base < T && !fit; base += mp::LANES) {
      unsigned m = 0u;
      for (int lane = 0; lane < mp::LANES; ++lane) {
        const int t = base + lane;
        if (t < T &&
            mp::proposal_fits(ent, placed, n, a.pos[2 * ((size_t)b * T + t)],
                          a.pos[2 * ((size_t)b * T + t) + 1],
                          a.cos_a[(size_t)b * T + t],
                          a.sin_a[(size_t)b * T + t]))
          m |= 1u << lane;
      }
      tested += T - base < mp::LANES ? T - base : mp::LANES;
      if (m) {
        pk = base + __builtin_ctz(m);
        fit = true;
      }
    }
    a.pick[b] = pk;
    a.ok[b] = fit;
    if (a.counts) {
      a.counts[2 * (size_t)b] += T;
      a.counts[2 * (size_t)b + 1] += tested;
    }
  }
  delete[] placed;
  return 0;
}

// The kernel's test of every proposal: fits (B, T) as 0 / 1; `pick`, `ok`
// and `counts` are unused.
extern "C" int place_fits(PLACE_ARGS, void* fits) {
  const mp::Args a = place_args(pos, cos_a, sin_a, ent_v, ent_rad, ent_nv,
                            ent_act, pl_v, pl_rad, pl_nv, pl_act, mask, pick,
                            ok, counts, B, T, E);
  if (T <= 0 || E < 0) return 1;
  static mp::Local ent;
  mp::Shape* placed = new mp::Shape[E * mp::KSUB + 1];
  for (int b = 0; b < B; ++b) {
    const int n = place_stage(a, b, ent, placed);
    for (int t = 0; t < T; ++t) {
      const size_t at = (size_t)b * T + t;
      ((int*)fits)[at] = mp::proposal_fits(ent, placed, n, a.pos[2 * at],
                                       a.pos[2 * at + 1], a.cos_a[at],
                                       a.sin_a[at])
                             ? 1
                             : 0;
    }
  }
  delete[] placed;
  return 0;
}

// Take PyTorch's root y[i] of x[i], beside those taken before, and forget
// the inputs missed so far.
extern "C" int place_add_sqrt(const float* x, const float* y, int n) {
  for (int i = 0; i < n; ++i) g_sqrt[float_bits(x[i])] = y[i];
  g_sqrt_missed.clear();
  return 0;
}

// The inputs whose roots were not handed in since the last place_add_sqrt,
// up to `cap` of them into `out`; returns their number.
extern "C" long place_sqrt_misses(float* out, long cap) {
  long n = 0;
  for (const auto& kv : g_sqrt_missed)
    if (n < cap) out[n++] = kv.second;
  return (long)g_sqrt_missed.size();
}
