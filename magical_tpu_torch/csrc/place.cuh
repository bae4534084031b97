// The per-proposal test of the reset's placement (tasks/randomize.py
// place_from_proposals): whether a proposed pose of an entity keeps every
// active sub-shape inside the arena (_inside_arena) and off every active
// sub-shape of the placed entities the mask keeps (_entity_overlap, through
// _sat_overlap's four cases).  Plain C++ in __host__ __device__ functions,
// so that the host build of the tests (tests/place_host_shim.cpp) runs the
// kernel's own decision; the warp's rounds are in place.cu.
//
// Every float the decision reads is computed as the plain version computes
// it, operation by operation: collision.transform_verts, _poly_edges
// (normals divided by max(length, EPS)), sep_of's dot products and their
// min, circle_poly's distances, the walls' separations.  Built without FMA
// contraction, these round as PyTorch's elementwise ops do, so the kernel
// and the plain version make the same decision on every proposal, ties
// included.  _entity_overlap's pruning (sub-shape kinds that no env has,
// vertex rows past the largest count) changes no result and has no
// counterpart: each pair takes the case its vertex counts select.

#pragma once

#include <math.h>

// The comparison that decides an overlap (distance < 0, separation < the
// radii's sum).  A host build may name another, to show that the tests
// catch it (tests/place_host_shim.cpp).
#ifndef MAGICAL_PLACE_LT
#define MAGICAL_PLACE_LT(a, b) ((a) < (b))
#endif

// The square root.  On the card this is CUDA's sqrtf, correctly rounded,
// as PyTorch's CUDA sqrt is; PyTorch's CPU sqrt is not always (one ulp
// off, rarely), so a host build may name the CPU's values instead
// (tests/place_host_shim.cpp).
#ifndef MAGICAL_PLACE_SQRTF
#define MAGICAL_PLACE_SQRTF sqrtf
#endif

namespace magical_place {

constexpr int NV = 8;          // geometry.NV
constexpr int KSUB = 6;        // geometry.KSUB
constexpr int LANES = 32;
constexpr float EPS = 1e-9f;   // core/collision.py _EPS
constexpr float BIG = 1e9f;    // _BIG of collision.py and randomize.py

// The arena walls as inward half-planes {x : dot(n, x) - o > 0}
// (collision.WALL_NORMALS, WALL_OFFSETS).
__host__ __device__ inline float wall_sep(int w, float x, float y,
                                          float rad) {
  const float n[4][2] = {{1.f, 0.f}, {-1.f, 0.f}, {0.f, 1.f}, {0.f, -1.f}};
  return x * n[w][0] + y * n[w][1] - (-1.0f) - rad;
}

// A convex sub-shape in the world frame: up to NV vertices (a circle: one,
// its centre) with an outset radius, and, for a polygon, its edges as
// collision._poly_edges makes them.
struct Shape {
  float x[NV], y[NV];     // vertices; rows past nv unused
  float nx[NV], ny[NV];   // edge i's outward normal (v_i -> v_i+1)
  float d[NV];            // dot(n_i, v_i)
  float rad;
  int nv;
  unsigned valid;         // bit i: edge i exists (i < nv, length > EPS)
};

// One env's entity as placed at the origin: its KSUB sub-shapes in its own
// frame (randomize.*_placement_geom).
struct Local {
  float v[KSUB][NV][2];
  float rad[KSUB];
  int nv[KSUB];
  int act[KSUB];
};

// The edges of polygon `s` from its vertices (_poly_edges).
__host__ __device__ inline void shape_edges(Shape& s) {
  s.valid = 0u;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    if (i < s.nv) {
      const bool wrap = i + 1 >= s.nv;
      const float ex = (wrap ? s.x[0] : s.x[(i + 1) % NV]) - s.x[i];
      const float ey = (wrap ? s.y[0] : s.y[(i + 1) % NV]) - s.y[i];
      const float elen = MAGICAL_PLACE_SQRTF(ex * ex + ey * ey);
      const float l = elen > EPS ? elen : EPS;
      s.nx[i] = ey / l;
      s.ny[i] = -ex / l;
      s.d[i] = s.nx[i] * s.x[i] + s.ny[i] * s.y[i];
      if (elen > EPS) s.valid |= 1u << i;
    }
  }
}

// Sub-shape k of `ent` at the pose (px, py) whose angle has cosine c and
// sine s (collision.transform_verts), with its edges if it is a polygon.
__host__ __device__ inline void place_shape(const Local& ent, int k, float px,
                                            float py, float c, float s,
                                            Shape& w) {
  w.nv = ent.nv[k];
  w.rad = ent.rad[k];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    if (i < w.nv) {
      const float lx = ent.v[k][i][0], ly = ent.v[k][i][1];
      w.x[i] = c * lx - s * ly + px;
      w.y[i] = s * lx + c * ly + py;
    }
  }
  if (w.nv > 1) shape_edges(w);
}

// Whether every vertex of `w` clears every wall by its radius
// (_inside_arena, one sub-shape).
__host__ __device__ inline bool inside_arena(const Shape& w) {
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    if (i < w.nv) {
      for (int k = 0; k < 4; ++k)
        if (!(wall_sep(k, w.x[i], w.y[i], w.rad) > 0.0f)) return false;
    }
  }
  return true;
}

// collision.circle_poly's distance between the circle (cx, cy, rc) and
// polygon `p`: the deepest face's separation when the centre is inside,
// else the distance to the closest boundary point, less p's radius, less
// rc.
__host__ __device__ inline float circle_poly_dist(float cx, float cy,
                                                  float rc, const Shape& p) {
  float smax = -BIG, dmin = BIG;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    if (i < p.nv && (p.valid >> i & 1u)) {
      const bool wrap = i + 1 >= p.nv;
      const float relx = cx - p.x[i], rely = cy - p.y[i];
      const float sep = p.nx[i] * relx + p.ny[i] * rely;
      smax = sep > smax ? sep : smax;
      const float ex = (wrap ? p.x[0] : p.x[(i + 1) % NV]) - p.x[i];
      const float ey = (wrap ? p.y[0] : p.y[(i + 1) % NV]) - p.y[i];
      const float ee2 = ex * ex + ey * ey;
      const float ee = ee2 > EPS ? ee2 : EPS;
      float t = (relx * ex + rely * ey) / ee;
      t = t < 0.0f ? 0.0f : (t > 1.0f ? 1.0f : t);
      const float qx = p.x[i] + t * ex, qy = p.y[i] + t * ey;
      const float dx = cx - qx, dy = cy - qy;
      const float dq = MAGICAL_PLACE_SQRTF(dx * dx + dy * dy);
      dmin = dq < dmin ? dq : dmin;
    }
  }
  return (smax <= 0.0f ? smax : dmin) - p.rad - rc;
}

// The largest over a's valid edges of the separation of b's vertices from
// it (sep_of: min over b's vertices of dot(n, v), less dot(n, v0)).
__host__ __device__ inline float edge_sep(const Shape& a, const Shape& b) {
  float best = -BIG;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    if (i < a.nv && (a.valid >> i & 1u)) {
      float m = a.nx[i] * b.x[0] + a.ny[i] * b.y[0];
#pragma unroll
      for (int j = 1; j < NV; ++j) {
        if (j < b.nv) {
          const float dot = a.nx[i] * b.x[j] + a.ny[i] * b.y[j];
          m = dot < m ? dot : m;
        }
      }
      const float s = m - a.d[i];
      best = s > best ? s : best;
    }
  }
  return best;
}

// Whether the proposal's sub-shape `a` overlaps a placed sub-shape `b`
// (_sat_overlap): circle-circle, circle-poly either way, or SAT.
__host__ __device__ inline bool overlap(const Shape& a, const Shape& b) {
  const float rsum = a.rad + b.rad;
  if (a.nv == 1 && b.nv == 1) {
    const float dx = b.x[0] - a.x[0], dy = b.y[0] - a.y[0];
    return MAGICAL_PLACE_LT(MAGICAL_PLACE_SQRTF(dx * dx + dy * dy), rsum);
  }
  if (a.nv == 1) return MAGICAL_PLACE_LT(circle_poly_dist(a.x[0], a.y[0],
                                                          a.rad, b), 0.0f);
  if (b.nv == 1) return MAGICAL_PLACE_LT(circle_poly_dist(b.x[0], b.y[0],
                                                          b.rad, a), 0.0f);
  const float sa = edge_sep(a, b), sb = edge_sep(b, a);
  return MAGICAL_PLACE_LT(sa > sb ? sa : sb, rsum);
}

// Whether entity `ent` fits at the pose (px, py, cos c, sin s): each of
// its active sub-shapes, one at a time, inside the arena and off each of
// the n placed sub-shapes of `placed`.
__host__ __device__ inline bool proposal_fits(const Local& ent,
                                              const Shape* placed, int n,
                                              float px, float py, float c,
                                              float s) {
  for (int k = 0; k < KSUB; ++k) {
    if (!ent.act[k]) continue;
    Shape w;      // in registers: every index into it is a constant
    place_shape(ent, k, px, py, c, s, w);
    if (!inside_arena(w)) return false;
    for (int q = 0; q < n; ++q)
      if (overlap(w, placed[q])) return false;
  }
  return true;
}

// The placement's inputs, every array contiguous with the env axis first:
// T proposals (pos (B, T, 2); the cosine and sine of each one's angle,
// (B, T)), the entity's local geometry (verts (B, KSUB, NV, 2), rad, nv,
// act (B, KSUB)), the placed rows' world geometry (verts (B, E, KSUB, NV,
// 2), rad, nv, act (B, E, KSUB)) and which rows to test against (mask (B,
// E)); out, each env's pick (int64) and whether it fits (bool), and, where
// not null, its count of proposals drawn and tested (int64 (B, 2)), added
// to.
struct Args {
  const float* pos;
  const float* cos_a;
  const float* sin_a;
  const float* ent_v;
  const float* ent_rad;
  const int* ent_nv;
  const unsigned char* ent_act;
  const float* pl_v;
  const float* pl_rad;
  const int* pl_nv;
  const unsigned char* pl_act;
  const unsigned char* mask;
  long long* pick;
  unsigned char* ok;
  long long* counts;
  int B, T, E;
};

// The values of an env's entity: its vertices, radii, counts and flags.
constexpr int NLOCAL = KSUB * NV * 2 + 3 * KSUB;

// Env b's entity (its `i`-th value, i < NLOCAL, so that the lanes of a
// warp can load it together).
__host__ __device__ inline void load_local(const Args& a, int b, int i,
                                           Local& ent) {
  constexpr int NVERT = KSUB * NV * 2;
  if (i < NVERT) {
    (&ent.v[0][0][0])[i] = a.ent_v[(size_t)b * NVERT + i];
  } else if (i < NVERT + KSUB) {
    ent.rad[i - NVERT] = a.ent_rad[(size_t)b * KSUB + i - NVERT];
  } else if (i < NVERT + 2 * KSUB) {
    ent.nv[i - NVERT - KSUB] = a.ent_nv[(size_t)b * KSUB + i - NVERT - KSUB];
  } else if (i < NVERT + 3 * KSUB) {
    const int k = i - NVERT - 2 * KSUB;
    ent.act[k] = a.ent_act[(size_t)b * KSUB + k] != 0;
  }
}

// Whether placed item i = row * KSUB + sub-shape of env b takes part: its
// row is in the mask and the sub-shape is active.
__host__ __device__ inline bool placed_on(const Args& a, int b, int i) {
  return a.mask[(size_t)b * a.E + i / KSUB] != 0 &&
         a.pl_act[(size_t)b * a.E * KSUB + i] != 0;
}

// Placed item i of env b, with its edges if it is a polygon.
__host__ __device__ inline void load_placed(const Args& a, int b, int i,
                                            Shape& p) {
  const size_t at = (size_t)b * a.E * KSUB + i;
  p.nv = a.pl_nv[at];
  p.rad = a.pl_rad[at];
  const float* v = a.pl_v + at * NV * 2;
  for (int j = 0; j < NV; ++j) {
    p.x[j] = v[2 * j];
    p.y[j] = v[2 * j + 1];
  }
  if (p.nv > 1) shape_edges(p);
}

}  // namespace magical_place
