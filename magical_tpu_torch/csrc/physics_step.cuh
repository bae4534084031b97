// Per-env arithmetic of the MAGICAL control-step kernel
// (physics_step.cu): narrowphase, compaction, contact and joint solve,
// and the phases in which one warp's lanes share an env's control step.
// Plain C++ in __host__ __device__ functions, so that it also builds
// for the host.

#pragma once

#include <math.h>

namespace magical {

constexpr int NV = 8;       // max vertices per convex sub-shape
constexpr int KSUB = 6;     // max convex sub-shapes per block
constexpr int NROBOT = 5;   // robot bodies: main, 2 fingers, 2 eyes
constexpr int NACT = 18;    // discrete actions
constexpr int NSHAPE = 7;   // block shape types
constexpr float EPS = 1e-9f;
constexpr float BIG = 1e9f;

// Float table layout (built by core/physics_kernel.py:_tables).
constexpr int FT_ACT_SPEED = 0;
constexpr int FT_ACT_TURN = FT_ACT_SPEED + NACT;
constexpr int FT_ACT_FINGER = FT_ACT_TURN + NACT;
constexpr int FT_BLOCK_VERTS = FT_ACT_FINGER + NACT;
constexpr int FT_BLOCK_RAD = FT_BLOCK_VERTS + NSHAPE * KSUB * NV * 2;
constexpr int FT_BLOCK_MOMENT = FT_BLOCK_RAD + NSHAPE * KSUB;
constexpr int FT_ROBOT_VERTS = FT_BLOCK_MOMENT + NSHAPE;
constexpr int FT_ROBOT_RAD = FT_ROBOT_VERTS + NROBOT * NV * 2;
constexpr int FT_INV_M_ROBOT = FT_ROBOT_RAD + NROBOT;
constexpr int FT_INV_I_ROBOT = FT_INV_M_ROBOT + NROBOT;
constexpr int FT_FINGER_REL = FT_INV_I_ROBOT + NROBOT;
constexpr int FT_FINGER_LIM = FT_FINGER_REL + 4;
constexpr int FT_BLOCK_BOUND = FT_FINGER_LIM + 4;  // (cx, cy, r) a sub-shape
constexpr int FT_ROBOT_BOUND = FT_BLOCK_BOUND + NSHAPE * KSUB * 3;
constexpr int FT_SCALARS = FT_ROBOT_BOUND + NROBOT * 3;
enum {
  SC_DT, SC_BIAS_COEF, SC_SLOP, SC_GEAR_MAX_BIAS, SC_EYE_STIFF,
  SC_EYE_DAMP_DT, SC_SHAPE_MASS, N_SCALARS
};
constexpr int FT_CAND_FRICTION = FT_SCALARS + N_SCALARS;  // then KC floats

// Int table layout.
constexpr int IT_BLOCK_NV = 0;
constexpr int IT_BLOCK_ACTIVE = IT_BLOCK_NV + NSHAPE * KSUB;
constexpr int IT_ROBOT_NV = IT_BLOCK_ACTIVE + NSHAPE * KSUB;
constexpr int IT_SLOT_BODY = IT_ROBOT_NV + NROBOT;  // then NS, NP, NP, KC, KC

struct Tables {
  const float* f;
  const int* i;
};

struct Args {
  float* pos;            // (B, NB, 2)
  float* angle;          // (B, NB)
  float* vel;            // (B, NB, 2)
  float* omega;          // (B, NB)
  float* v_bias;         // (B, NB, 2)
  float* w_bias;         // (B, NB)
  float* target_speed;   // (B,)
  float* rel_turn_angle; // (B,)
  float* target_finger_angle;  // (B,)
  const int* block_shape;      // (B, MB)
  const unsigned char* block_active;  // (B, MB) bool
  const float* phys;     // (B, 5)
  int* con_id;           // (B, MAXC)
  float* con_jn;         // (B, MAXC)
  float* con_jt;         // (B, MAXC)
  float* joint_acc;      // (B, 9 + 3 MB)
  int* t;                // (B,)
  const int* action;     // (B,)
  Tables tab;
  int B;
  int phys_steps;
  int iterations;
  long long* phase_clock;  // (B, N_PHASES) cycles a phase, or null
  long long* item_count;   // (B, 2) items, items tested in full; or null
};

__host__ __device__ inline float cross2(float ax, float ay, float bx,
                                        float by) {
  return ax * by - ay * bx;
}

__host__ __device__ inline float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// ---------------------------------------------------------------------------
// Narrowphase (core/collision.py)
// ---------------------------------------------------------------------------

struct Poly {
  float v[NV][2];
  int nv;
  float rad;
  float cx, cy, bound;  // a circle around every vertex, widened by rad
};

struct Edges {
  float n[NV][2];
  bool valid[NV];
};

__host__ __device__ inline int next_vert(int i, int nv) {
  return (i + 1 < nv) ? i + 1 : 0;
}

__host__ __device__ void poly_edges(const Poly& p, Edges& e) {
  for (int i = 0; i < NV; ++i) {
    int j = next_vert(i, p.nv);
    float ex = p.v[j][0] - p.v[i][0];
    float ey = p.v[j][1] - p.v[i][1];
    float elen = sqrtf(ex * ex + ey * ey);
    float den = fmaxf(elen, EPS);
    e.n[i][0] = ey / den;
    e.n[i][1] = -ex / den;
    e.valid[i] = (i < p.nv) && (elen > EPS);
  }
}

struct Contact2 {
  float pt[2][2];
  float n[2];
  float d[2];
  bool valid[2];
};

__host__ __device__ void circle_circle(float cax, float cay, float ra,
                                       float cbx, float cby, float rb,
                                       float* pt, float* n, float* dist) {
  float dx = cbx - cax, dy = cby - cay;
  float dc = sqrtf(dx * dx + dy * dy);
  float den = fmaxf(dc, EPS);
  n[0] = dx / den;
  n[1] = dy / den;
  *dist = dc - (ra + rb);
  float k = ra + 0.5f * *dist;
  pt[0] = cax + n[0] * k;
  pt[1] = cay + n[1] * k;
}

// Normal points from the POLY towards the CIRCLE.
__host__ __device__ void circle_poly(float cx, float cy, float rc,
                                     const Poly& p, float* pt, float* n,
                                     float* dist) {
  Edges e;
  poly_edges(p, e);
  float sep[NV];
  for (int f = 0; f < NV; ++f) {
    float rx = cx - p.v[f][0], ry = cy - p.v[f][1];
    sep[f] = e.valid[f] ? e.n[f][0] * rx + e.n[f][1] * ry : -BIG;
  }
  int fi = 0;
  for (int f = 1; f < NV; ++f)
    if (sep[f] > sep[fi]) fi = f;
  bool inside = sep[fi] <= 0.0f;
  float dist_in = sep[fi] - p.rad - rc;

  float dq[NV], qx[NV], qy[NV];
  for (int f = 0; f < NV; ++f) {
    int j = next_vert(f, p.nv);
    float ex = p.v[j][0] - p.v[f][0], ey = p.v[j][1] - p.v[f][1];
    float rx = cx - p.v[f][0], ry = cy - p.v[f][1];
    float ee = fmaxf(ex * ex + ey * ey, EPS);
    float tp = clampf((rx * ex + ry * ey) / ee, 0.0f, 1.0f);
    qx[f] = p.v[f][0] + tp * ex;
    qy[f] = p.v[f][1] + tp * ey;
    float ddx = cx - qx[f], ddy = cy - qy[f];
    dq[f] = e.valid[f] ? sqrtf(ddx * ddx + ddy * ddy) : BIG;
  }
  int j = 0;
  for (int f = 1; f < NV; ++f)
    if (dq[f] < dq[j]) j = f;
  float den = fmaxf(dq[j], EPS);
  float dist_out = dq[j] - p.rad - rc;
  if (inside) {
    n[0] = e.n[fi][0];
    n[1] = e.n[fi][1];
    *dist = dist_in;
  } else {
    n[0] = (cx - qx[j]) / den;
    n[1] = (cy - qy[j]) / den;
    *dist = dist_out;
  }
  float k = rc + 0.5f * *dist;
  pt[0] = cx - n[0] * k;
  pt[1] = cy - n[1] * k;
}

__host__ __device__ void poly_poly(const Poly& a, const Poly& b,
                                   Contact2& c) {
  Edges ea, eb;
  poly_edges(a, ea);
  poly_edges(b, eb);

  // SAT over A's faces: support of B along -an; then over B's faces.
  int iA = 0, iB = 0;
  float sepA[NV], sepB[NV];
  for (int f = 0; f < NV; ++f) {
    float mn = ea.n[f][0] * b.v[0][0] + ea.n[f][1] * b.v[0][1];
    for (int v = 1; v < NV; ++v)
      mn = fminf(mn, ea.n[f][0] * b.v[v][0] + ea.n[f][1] * b.v[v][1]);
    sepA[f] = ea.valid[f]
        ? mn - (ea.n[f][0] * a.v[f][0] + ea.n[f][1] * a.v[f][1]) : -BIG;
    mn = eb.n[f][0] * a.v[0][0] + eb.n[f][1] * a.v[0][1];
    for (int v = 1; v < NV; ++v)
      mn = fminf(mn, eb.n[f][0] * a.v[v][0] + eb.n[f][1] * a.v[v][1]);
    sepB[f] = eb.valid[f]
        ? mn - (eb.n[f][0] * b.v[f][0] + eb.n[f][1] * b.v[f][1]) : -BIG;
  }
  for (int f = 1; f < NV; ++f) {
    if (sepA[f] > sepA[iA]) iA = f;
    if (sepB[f] > sepB[iB]) iB = f;
  }
  float sA = sepA[iA], sB = sepB[iB];
  bool use_a = sA >= sB;
  float sep = use_a ? sA : sB;

  const Poly& ref = use_a ? a : b;
  const Poly& inc = use_a ? b : a;
  const Edges& eref = use_a ? ea : eb;
  const Edges& einc = use_a ? eb : ea;
  int ir = use_a ? iA : iB;
  float r0x = ref.v[ir][0], r0y = ref.v[ir][1];
  int ir1 = next_vert(ir, ref.nv);
  float r1x = ref.v[ir1][0], r1y = ref.v[ir1][1];
  float mx = eref.n[ir][0], my = eref.n[ir][1];
  // contact normal always points A -> B
  float nx = use_a ? mx : -mx, ny = use_a ? my : -my;

  // incident face: on the other poly, face most anti-parallel to refm
  int ji = 0;
  float best = BIG;
  for (int f = 0; f < NV; ++f) {
    float s = einc.valid[f] ? einc.n[f][0] * mx + einc.n[f][1] * my : BIG;
    if (f == 0 || s < best) {
      best = s;
      ji = f;
    }
  }
  float p1x = inc.v[ji][0], p1y = inc.v[ji][1];
  int ji1 = next_vert(ji, inc.nv);
  float p2x = inc.v[ji1][0], p2y = inc.v[ji1][1];

  // clip incident segment to the reference face's side planes
  float tx = r1x - r0x, ty = r1y - r0y;
  float tlen = fmaxf(sqrtf(tx * tx + ty * ty), EPS);
  tx = tx / tlen;
  ty = ty / tlen;
  float x1 = tx * (p1x - r0x) + ty * (p1y - r0y);
  float x2 = tx * (p2x - r0x) + ty * (p2y - r0y);
  float dx = x2 - x1;
  float sdx = fabsf(dx) > EPS ? dx : EPS;
  float s0 = (0.0f - x1) / sdx;
  float sL = (tlen - x1) / sdx;
  float s_lo = clampf(fminf(s0, sL), 0.0f, 1.0f);
  float s_hi = clampf(fmaxf(s0, sL), 0.0f, 1.0f);
  float ex = p2x - p1x, ey = p2y - p1y;
  float c1x = p1x + s_lo * ex, c1y = p1y + s_lo * ey;
  float c2x = p1x + s_hi * ex, c2y = p1y + s_hi * ey;

  float rsum = a.rad + b.rad;
  float d1 = (mx * (c1x - r0x) + my * (c1y - r0y)) - rsum;
  float d2 = (mx * (c2x - r0x) + my * (c2y - r0y)) - rsum;
  bool overlap = sep - rsum < 0.0f;
  c.pt[0][0] = c1x; c.pt[0][1] = c1y;
  c.pt[1][0] = c2x; c.pt[1][1] = c2y;
  c.n[0] = nx; c.n[1] = ny;
  c.d[0] = d1; c.d[1] = d2;
  c.valid[0] = overlap && (d1 < 0.0f);
  c.valid[1] = overlap && (d2 < 0.0f);
}

__host__ __device__ void pair_contacts(const Poly& a, const Poly& b,
                                       Contact2& c) {
  bool ac = a.nv == 1, bc = b.nv == 1;
  if (!ac && !bc) {
    poly_poly(a, b, c);
    return;
  }
  float pt[2], n[2], d;
  if (ac && bc) {
    circle_circle(a.v[0][0], a.v[0][1], a.rad, b.v[0][0], b.v[0][1], b.rad,
                  pt, n, &d);
  } else if (ac) {
    // circle_poly's normal points poly->circle = B->A: flip it.
    circle_poly(a.v[0][0], a.v[0][1], a.rad, b, pt, n, &d);
    n[0] = -n[0];
    n[1] = -n[1];
  } else {
    circle_poly(b.v[0][0], b.v[0][1], b.rad, a, pt, n, &d);
  }
  for (int k = 0; k < 2; ++k) {
    c.pt[k][0] = pt[0];
    c.pt[k][1] = pt[1];
    c.d[k] = d;
  }
  c.n[0] = n[0];
  c.n[1] = n[1];
  c.valid[0] = d < 0.0f;
  c.valid[1] = false;
}

// Wall half-plane {x : dot(n, x) >= o}: up to two contacts per slot.
__host__ __device__ void wall_contacts(const Poly& p, float wnx, float wny,
                                       float wo, Contact2& c) {
  float seps[NV];
  for (int v = 0; v < NV; ++v)
    seps[v] = v < p.nv
        ? (p.v[v][0] * wnx + p.v[v][1] * wny) - wo - p.rad : BIG;
  int i1 = 0;
  for (int v = 1; v < NV; ++v)
    if (seps[v] < seps[i1]) i1 = v;
  float s1 = seps[i1];
  seps[i1] = BIG;
  int i2 = 0;
  for (int v = 1; v < NV; ++v)
    if (seps[v] < seps[i2]) i2 = v;
  float s2 = seps[i2];
  c.pt[0][0] = p.v[i1][0] - wnx * p.rad;
  c.pt[0][1] = p.v[i1][1] - wny * p.rad;
  c.pt[1][0] = p.v[i2][0] - wnx * p.rad;
  c.pt[1][1] = p.v[i2][1] - wny * p.rad;
  c.n[0] = wnx;
  c.n[1] = wny;
  c.d[0] = s1;
  c.d[1] = s2;
  c.valid[0] = s1 < 0.0f;
  c.valid[1] = s2 < 0.0f;
}

// The broadphase cull's margin: an item is tested in full only where its
// two slots' bounding circles (Poly::cx, cy, bound) come within CULL_MARGIN
// of each other, or a slot's circle within CULL_MARGIN of its wall.  Culled
// items must be ones the tests above would make invalid, in their own
// arithmetic:
// - wall_contacts, circle_circle and circle_poly are valid only where the
//   rounded shapes overlap (a vertex past the wall by less than rad, or a
//   circle's centre closer than the radii to the other shape), so only
//   where the circles overlap: any margin >= 0 holds them.
// - poly_poly is valid only where its separation `sep` (the largest over
//   both polygons' face normals) is below rA + rB.  Let g be the distance
//   between the two vertex hulls (the padding repeats a vertex), at closest
//   points p, q.  If p or q lies inside an edge, that edge's normal gives
//   sep = g.  At two vertices, the separating direction lies in A's normal
//   cone at p and in B's negated one at q; the overlap of the two cones is
//   bounded by face normals, each inside the other polygon's cone, so the
//   nearer is within theta / 2 of the direction, theta the smaller exterior
//   angle there, and sep >= g cos(theta / 2).  The circles' gap is at most
//   g - rA - rB.  So sep < rA + rB needs a gap below
//   (rA + rB) (1 / cos(theta / 2) - 1): zero where both rad are 0 (every
//   polygon but the square), and for the square (rad 0.00213, exterior
//   angle 90 degrees) at most 2 x 0.00213 x 0.414 = 0.0018.
// - rounding: coordinates below ~2 in float32, a few 1e-7.
// 0.03 covers that 16 times over and still culls ~98% of ClusterColour's
// items.
constexpr float CULL_MARGIN = 0.03f;

// ---------------------------------------------------------------------------
// One env's control step (core/physics.py), on one warp
// ---------------------------------------------------------------------------

// One env's control step runs on the LANES threads of one warp, its state
// in shared memory (WarpEnv).  WARP_PHASE(...) runs a phase: on the card
// every lane runs the statement with its own `lane`, then the warp syncs;
// in a host build one thread runs it for each lane in turn, which is the
// same thing, since within a phase no lane reads what another lane writes.
// The host build runs the lanes in the order MAGICAL_HOST_LANE(i) gives
// (lane i unless the includer defines it), so that a test can run them in
// other orders: a phase that broke the rule would give other bits.
constexpr int LANES = 32;
#ifdef __CUDA_ARCH__
#define WARP_PHASE(...) \
  do {                  \
    __VA_ARGS__;        \
    __syncwarp();       \
  } while (0)
#else
#ifndef MAGICAL_HOST_LANE
#define MAGICAL_HOST_LANE(i) (i)
#endif
#define WARP_PHASE(...)                                  \
  do {                                                   \
    for (int lane_i = 0; lane_i < LANES; ++lane_i) {     \
      const int lane = MAGICAL_HOST_LANE(lane_i);        \
      __VA_ARGS__;                                       \
    }                                                    \
  } while (0)
#endif

// Phases whose clock64() cycles the kernel can count per env
// (Args::phase_clock): where a control step's time goes.
enum {
  PH_NARROW,    // slots and narrowphase (build_slots, collide)
  PH_PRESTEP,   // contact and joint prestep, warm start
  PH_SWEEP,     // the Jacobi contact sweep of each solver iteration
  PH_APPLY,     // the per-body impulse sums of each sweep
  PH_JOINTS,    // the robot's Gauss-Seidel joints and the block dampers
  PH_OTHER,     // load, store, integration, cache clearing
  N_PHASES
};

template <int MB>
struct WarpEnv {
  static constexpr int NB = NROBOT + MB;
  static constexpr int NBP = NB + 1;           // + the static wall body
  static constexpr int NS = 5 + KSUB * MB;
  static constexpr int NP = 5 * KSUB * MB + KSUB * KSUB * MB * (MB - 1) / 2;
  static constexpr int KC = 8 * NS + 2 * NP;
  static constexpr int MAXC = 32 + 16 * MB;
  static constexpr int NJ = 9 + 3 * MB;
  static constexpr int NITEM = 4 * NS + NP;    // wall candidates + pairs
  static_assert(NBP <= LANES / 2, "apply takes a lane per (side, body)");
  static_assert(KC < 65536, "candidate ids are stored in 16 bits");

  // bodies (index NB is the static wall body: zero pose, zero inverse mass)
  float px[NBP], py[NBP], ang[NBP];
  float vx[NBP], vy[NBP], w[NBP];
  float vbx[NBP], vby[NBP], wb[NBP];
  float inv_m[NBP], inv_i[NBP];
  float deg[NBP];                  // contacts a body takes part in, >= 1
  float part[2][LANES / 2][6];     // apply's sums: [side][body][6]
  int shape[MB];
  bool bactive[MB];

  // the robot's control, lane 0's (Robot.update, the joint prestep)
  float ts, tt, tf;                // action targets
  float phys[5];
  float control_angle, cvx, cvy, motor_rate[2];
  float gear_bias, eye_wcoef;
  float pin_nx[2], pin_ny[2], pin_r1x[2], pin_r1y[2], pin_nmass[2];
  float pin_bias[2], limit_bias[2];
  float pivot_jmax, gear_jmax, motor_jmax, bp_jmax, bg_jmax;
  float jacc[NJ];

  // compacted contacts of the current substep, and the caches
  int nc, nc_next;
  int cid[MAXC];
  unsigned char ia[MAXC], ib[MAXC];  // the two bodies, < NBP
  float cnx[MAXC], cny[MAXC], cu[MAXC], bias[MAXC];
  float r1x[MAXC], r1y[MAXC], r2x[MAXC], r2y[MAXC];
  float nmass[MAXC], tmass[MAXC];
  float jn[MAXC], jt[MAXC], jb[MAXC];
  float djx[MAXC], djy[MAXC], dbx[MAXC], dby[MAXC];
  int old_id[MAXC];
  float old_jn[MAXC], old_jt[MAXC];

  // narrowphase: world geometry, the candidates of active slots (the
  // first candidate id of each, in candidate order), the ring of those
  // near enough to test in full, a lane's results
  Poly slots[NS];
  bool sact[NS];                   // slot active (for the whole step)
  int n_items, n_items_next;
  unsigned short items[NITEM];
  int item_on[LANES];
  unsigned short near[2 * LANES];
  Contact2 stage[LANES];
  int stage_k[LANES];

  // ---- per-lane pieces of the phases -------------------------------------

  __host__ __device__ void load_body(const Args& a, int b, int k) {
    px[k] = a.pos[(b * NB + k) * 2];
    py[k] = a.pos[(b * NB + k) * 2 + 1];
    ang[k] = a.angle[b * NB + k];
    vx[k] = a.vel[(b * NB + k) * 2];
    vy[k] = a.vel[(b * NB + k) * 2 + 1];
    w[k] = a.omega[b * NB + k];
    vbx[k] = a.v_bias[(b * NB + k) * 2];
    vby[k] = a.v_bias[(b * NB + k) * 2 + 1];
    wb[k] = a.w_bias[b * NB + k];
  }

  __host__ __device__ void store_body(const Args& a, int b, int k) const {
    a.pos[(b * NB + k) * 2] = px[k];
    a.pos[(b * NB + k) * 2 + 1] = py[k];
    a.angle[b * NB + k] = ang[k];
    a.vel[(b * NB + k) * 2] = vx[k];
    a.vel[(b * NB + k) * 2 + 1] = vy[k];
    a.omega[b * NB + k] = w[k];
    a.v_bias[(b * NB + k) * 2] = vbx[k];
    a.v_bias[(b * NB + k) * 2 + 1] = vby[k];
    a.w_bias[b * NB + k] = wb[k];
  }

  // Inverse masses (core/state.py inv_mass_arrays) of body k.
  __host__ __device__ void masses(const Tables& tab, int k) {
    const float* ft = tab.f;
    if (k < NROBOT) {
      inv_m[k] = ft[FT_INV_M_ROBOT + k];
      inv_i[k] = ft[FT_INV_I_ROBOT + k];
    } else if (k < NB) {
      float act = bactive[k - NROBOT] ? 1.0f : 0.0f;
      inv_m[k] = act / ft[FT_SCALARS + SC_SHAPE_MASS];
      inv_i[k] = act / ft[FT_BLOCK_MOMENT + shape[k - NROBOT]];
    } else {
      inv_m[k] = inv_i[k] = 0.0f;
    }
  }

  // Action targets (Robot.set_action), lane 0.
  __host__ __device__ void targets(const Args& a, int b) {
    const float* ft = a.tab.f;
    int act = a.action[b];
    ts = ft[FT_ACT_SPEED + act];
    tt = ft[FT_ACT_TURN + act];
    tf = ft[FT_ACT_FINGER + act];
    a.target_speed[b] = ts;
    a.rel_turn_angle[b] = tt;
    a.target_finger_angle[b] = tf;
    for (int k = 0; k < 5; ++k) phys[k] = a.phys[b * 5 + k];
  }

  __host__ __device__ bool slot_active(const Tables& tab, int s) const {
    if (s < 5) return true;
    int bi = (s - 5) / KSUB, k = (s - 5) % KSUB;
    return tab.i[IT_BLOCK_ACTIVE + shape[bi] * KSUB + k] != 0 && bactive[bi];
  }

  // The narrowphase's items: the candidates whose slots are active, in
  // candidate order.  A ClusterColour-Demo env has 213 of its 1920
  // sub-shape pairs, so the lanes walk this list, not all pairs.  Slot
  // activity holds for the whole control step, so the list is made once
  // per step, 32 candidates at a time: item c is the walls' candidate
  // (c / NS, c % NS) for c < 4 NS, else pair c - 4 NS, and its first
  // contact's candidate id is 2 c either way.
  __host__ __device__ void flag_item(const Tables& tab, int c, int l) {
    bool on = false;
    if (c < 4 * NS) {
      on = sact[c % NS];
    } else if (c < NITEM) {
      const int i = c - 4 * NS;
      on = sact[tab.i[IT_SLOT_BODY + NS + i]] &&
           sact[tab.i[IT_SLOT_BODY + NS + NP + i]];
    }
    item_on[l] = on;
  }

  // Lane l's item of the chunk from candidate `base`, after the items of
  // lanes < l; lane 0 also counts the chunk's.
  __host__ __device__ void place_item(int base, int l) {
    int at = n_items, total = 0;
    for (int o = 0; o < LANES; ++o) {
      if (o < l) at += item_on[o];
      total += item_on[o];
    }
    if (item_on[l]) items[at] = (unsigned short)(2 * (base + l));
    if (l == 0) n_items_next = n_items + total;
  }

  // Robot.update, BEFORE integration, lane 0.
  __host__ __device__ void robot_update() {
    float a0 = ang[0];
    control_angle = a0 + tt;
    cvx = ts * -sinf(a0);
    cvy = ts * cosf(a0);
    for (int side = 0; side < 2; ++side) {
      float rel = ang[1 + side] - a0;
      float err = rel + (side == 0 ? -tf : tf);
      float r = clampf(err * 10.0f, -1.0f, 1.0f);
      motor_rate[side] = fabsf(r) < 1e-4f ? 0.0f : r;
    }
  }

  // cpBodyUpdatePosition of body k.
  __host__ __device__ void integrate(float dt, int k) {
    px[k] = px[k] + (vx[k] + vbx[k]) * dt;
    py[k] = py[k] + (vy[k] + vby[k]) * dt;
    ang[k] = ang[k] + (w[k] + wb[k]) * dt;
  }

  // World geometry of slot s (physics.py slot_geometry + transform_verts),
  // and its bounding circle.
  __host__ __device__ void build_slot(const Tables& tab, int s) {
    const float* ft = tab.f;
    const int* it = tab.i;
    Poly& p = slots[s];
    float lv[NV][2];
    const float* bound;              // local centre and radius
    if (s < 5) {
      for (int v = 0; v < NV; ++v) {
        lv[v][0] = ft[FT_ROBOT_VERTS + (s * NV + v) * 2];
        lv[v][1] = ft[FT_ROBOT_VERTS + (s * NV + v) * 2 + 1];
      }
      p.nv = it[IT_ROBOT_NV + s];
      p.rad = ft[FT_ROBOT_RAD + s];
      bound = ft + FT_ROBOT_BOUND + s * 3;
    } else {
      int bi = (s - 5) / KSUB, k = (s - 5) % KSUB;
      int tk = shape[bi] * KSUB + k;
      for (int v = 0; v < NV; ++v) {
        lv[v][0] = ft[FT_BLOCK_VERTS + (tk * NV + v) * 2];
        lv[v][1] = ft[FT_BLOCK_VERTS + (tk * NV + v) * 2 + 1];
      }
      p.nv = it[IT_BLOCK_NV + tk];
      p.rad = ft[FT_BLOCK_RAD + tk];
      bound = ft + FT_BLOCK_BOUND + tk * 3;
    }
    int body = it[IT_SLOT_BODY + s];
    float c = cosf(ang[body]), sn = sinf(ang[body]);
    for (int v = 0; v < NV; ++v) {
      p.v[v][0] = c * lv[v][0] - sn * lv[v][1] + px[body];
      p.v[v][1] = sn * lv[v][0] + c * lv[v][1] + py[body];
    }
    p.cx = c * bound[0] - sn * bound[1] + px[body];
    p.cy = sn * bound[0] + c * bound[1] + py[body];
    p.bound = bound[2];
  }

  // Whether item k0 (its first candidate id) can touch (CULL_MARGIN): a
  // slot's circle against the wall half-plane {x : dot(n, x) >= -1}, or
  // the circles of a sub-shape pair.
  __host__ __device__ bool near_item(const Tables& tab, int k0) const {
    if (k0 < 8 * NS) {
      const int wi = k0 / 2 / NS;
      const Poly& p = slots[k0 / 2 % NS];
      const float nc = wi == 0 ? p.cx : wi == 1 ? -p.cx : wi == 2 ? p.cy
                                                                  : -p.cy;
      return nc + 1.0f < p.bound + CULL_MARGIN;
    }
    const int i = (k0 - 8 * NS) / 2;
    const Poly& pa = slots[tab.i[IT_SLOT_BODY + NS + i]];
    const Poly& pb = slots[tab.i[IT_SLOT_BODY + NS + NP + i]];
    const float dx = pb.cx - pa.cx, dy = pb.cy - pa.cy;
    const float r = pa.bound + pb.bound + CULL_MARGIN;
    return dx * dx + dy * dy < r * r;
  }

  // The host build's ballot: lane l's item of the chunk from item `base`,
  // if item_on flags it near, into the ring at `at` after the near items of
  // lanes < l (place_item's prefix count); returns the chunk's count.
  __host__ __device__ int place_near(int base, int at, int l) {
    int total = 0;
    for (int o = 0; o < LANES; ++o) {
      if (o < l) at += item_on[o];
      total += item_on[o];
    }
    if (item_on[l]) near[at % (2 * LANES)] = items[base + l];
    return total;
  }

  // Narrowphase of item k0 (its first candidate id; none if < 0) into
  // stage[l]: a slot against a wall half-plane {x : dot(n, x) >= -1}, or a
  // sub-shape pair.
  __host__ __device__ void narrow(const Tables& tab, int k0, int l) {
    Contact2& c = stage[l];
    if (k0 < 0) {
      c.valid[0] = c.valid[1] = false;
      return;
    }
    stage_k[l] = k0;
    if (k0 < 8 * NS) {
      const float wn[4][2] = {{1.f, 0.f}, {-1.f, 0.f}, {0.f, 1.f},
                              {0.f, -1.f}};
      const int wi = k0 / 2 / NS, s = k0 / 2 % NS;
      wall_contacts(slots[s], wn[wi][0], wn[wi][1], -1.0f, c);
    } else {
      const int i = (k0 - 8 * NS) / 2;
      pair_contacts(slots[tab.i[IT_SLOT_BODY + NS + i]],
                    slots[tab.i[IT_SLOT_BODY + NS + NP + i]], c);
    }
  }

  // Contact m from candidate k, point p of c; the lever arms and the bias
  // of the prestep, which need nothing but the contact and the pose.
  __host__ __device__ void push(const Tables& tab, int m, int k,
                                const Contact2& c, int p) {
    const int* it = tab.i;
    const float* ft = tab.f;
    const int cand_a = IT_SLOT_BODY + NS + 2 * NP;
    const int a = it[cand_a + k], b = it[cand_a + KC + k];
    cid[m] = k;
    ia[m] = a;
    ib[m] = b;
    cu[m] = ft[FT_CAND_FRICTION + k];
    cnx[m] = c.n[0];
    cny[m] = c.n[1];
    r1x[m] = c.pt[p][0] - px[a];
    r1y[m] = c.pt[p][1] - py[a];
    r2x[m] = c.pt[p][0] - px[b];
    r2y[m] = c.pt[p][1] - py[b];
    bias[m] = -ft[FT_SCALARS + SC_BIAS_COEF] *
              fminf(c.d[p] + ft[FT_SCALARS + SC_SLOP], 0.0f) /
              ft[FT_SCALARS + SC_DT];
  }

  // Lane l's contacts of the chunk, at their place in candidate order:
  // after the valid contacts of lanes < l (a prefix count, never an
  // atomic), so the list is the sequential one, later valid ones past
  // MAXC dropped.  Lane 0 also counts the chunk's contacts.
  __host__ __device__ void compact(const Tables& tab, int l) {
    int at = nc, total = 0;
    for (int o = 0; o < LANES; ++o) {
      const int n = (stage[o].valid[0] ? 1 : 0) + (stage[o].valid[1] ? 1 : 0);
      if (o < l) at += n;
      total += n;
    }
    for (int p = 0; p < 2; ++p) {
      if (!stage[l].valid[p]) continue;
      if (at < MAXC) push(tab, at, stage_k[l] + p, stage[l], p);
      ++at;
    }
    if (l == 0) nc_next = nc + total < MAXC ? nc + total : MAXC;
  }

  // The contacts body k takes part in (exact integer counts), >= 1.
  __host__ __device__ void degree(int k) {
    int n = 0;
    for (int m = 0; m < nc; ++m) n += (ia[m] == k) + (ib[m] == k);
    deg[k] = fmaxf((float)n, 1.0f);
  }

  // cpArbiterPreStep with mass-splitting stiffness (_contact_prestep),
  // contact m.
  __host__ __device__ void contact_prestep(int m) {
    int a = ia[m], b = ib[m];
    float sma = inv_m[a] * deg[a], smb = inv_m[b] * deg[b];
    float sia = inv_i[a] * deg[a], sib = inv_i[b] * deg[b];
    float nx = cnx[m], ny = cny[m];
    float rn1 = cross2(r1x[m], r1y[m], nx, ny);
    float rn2 = cross2(r2x[m], r2y[m], nx, ny);
    float kn = sma + smb + sia * (rn1 * rn1) + sib * (rn2 * rn2);
    float rt1 = cross2(r1x[m], r1y[m], -ny, nx);
    float rt2 = cross2(r2x[m], r2y[m], -ny, nx);
    float kt = sma + smb + sia * (rt1 * rt1) + sib * (rt2 * rt2);
    nmass[m] = 1.0f / fmaxf(kn, 1e-12f);
    tmass[m] = 1.0f / fmaxf(kt, 1e-12f);
  }

  // The joints' prestep and the eye springs' stiff part, lane 0.
  __host__ __device__ void joint_prestep(const Tables& tab) {
    const float* ft = tab.f;
    const float dt = ft[FT_SCALARS + SC_DT];
    float gear_err = ang[0] - control_angle;
    float gmb = ft[FT_SCALARS + SC_GEAR_MAX_BIAS];
    gear_bias = clampf(-gear_err / dt, -gmb, gmb);
    float c0 = cosf(ang[0]), s0 = sinf(ang[0]);
    for (int side = 0; side < 2; ++side) {
      float rx = ft[FT_FINGER_REL + side * 2];
      float ry = ft[FT_FINGER_REL + side * 2 + 1];
      float anx = px[0] + (c0 * rx + (-s0) * ry);
      float any = py[0] + (s0 * rx + c0 * ry);
      float dx = px[1 + side] - anx, dy = py[1 + side] - any;
      float dist = sqrtf(dx * dx + dy * dy);
      float den = fmaxf(dist, 1e-9f);
      bool ok = dist > 1e-9f;
      pin_nx[side] = ok ? dx / den : 0.0f;
      pin_ny[side] = ok ? dy / den : 0.0f;
      pin_r1x[side] = anx - px[0];
      pin_r1y[side] = any - py[0];
      float rcn = cross2(pin_r1x[side], pin_r1y[side], pin_nx[side],
                         pin_ny[side]);
      float k = inv_m[0] + inv_m[1 + side] + inv_i[0] * (rcn * rcn);
      pin_nmass[side] = 1.0f / fmaxf(k, 1e-12f);
      pin_bias[side] = -dist / dt;      // error_bias = 0
      float lo = ft[FT_FINGER_LIM + side * 2];
      float hi = ft[FT_FINGER_LIM + side * 2 + 1];
      float ld = ang[1 + side] - ang[0];
      float pd = ld > hi ? hi - ld : (ld < lo ? lo - ld : 0.0f);
      limit_bias[side] = -pd / dt;
    }
    for (int side = 0; side < 2; ++side) {
      int eb = 3 + side;
      float rel_angle = ang[0] - ang[eb];
      float j_spring = rel_angle * ft[FT_SCALARS + SC_EYE_STIFF] * dt;
      w[0] = w[0] + -j_spring * inv_i[0];
      w[eb] = w[eb] + j_spring * inv_i[eb];
    }
    float eye_isum_inv = inv_i[0] + inv_i[3];
    eye_wcoef = 1.0f - expf(ft[FT_SCALARS + SC_EYE_DAMP_DT] * eye_isum_inv);
    pivot_jmax = phys[0] * dt;
    gear_jmax = phys[1] * dt;
    motor_jmax = phys[2] * dt;
    bp_jmax = phys[3] * dt;
    bg_jmax = phys[4] * dt;
  }

  // cpArbiterApplyCachedImpulse of contact m: its impulses of the last
  // substep, found by candidate id among the old contacts.
  __host__ __device__ void warm_start(int m) {
    float jw_n = 0.0f, jw_t = 0.0f;
    for (int o = 0; o < MAXC; ++o) {
      if (old_id[o] >= 0 && old_id[o] == cid[m]) {
        jw_n = old_jn[o];
        jw_t = old_jt[o];
        break;
      }
    }
    jn[m] = jw_n;
    jt[m] = jw_t;
    jb[m] = 0.0f;
    djx[m] = jw_n * cnx[m] + jw_t * (-cny[m]);
    djy[m] = jw_n * cny[m] + jw_t * cnx[m];
  }

  // Lane l of apply's first half: per-body sums of the contact impulses
  // (djx, djy) and, with BIAS, of the bias impulses (dbx, dby), on one
  // side of each contact, -dj on A (lanes 0-15), +dj on B (lanes 16-31),
  // body l mod 16, in contact order: the order of the plain version's
  // sums, A side then B side, so every run gives the same bits.
  template <bool BIAS>
  __host__ __device__ void apply_sums(int l) {
    const int side = l / (LANES / 2), k = l % (LANES / 2);
    if (k >= NBP) return;
    const unsigned char* on = side == 0 ? ia : ib;
    const float* rx = side == 0 ? r1x : r2x;
    const float* ry = side == 0 ? r1y : r2y;
    const float im = inv_m[k], ii = inv_i[k];
    float s[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    for (int m = 0; m < nc; ++m) {
      if (on[m] != k) continue;
      if (side == 0) {
        s[0] += -djx[m] * im;
        s[1] += -djy[m] * im;
        s[2] += -ii * cross2(rx[m], ry[m], djx[m], djy[m]);
        if (BIAS) {
          s[3] += -dbx[m] * im;
          s[4] += -dby[m] * im;
          s[5] += -ii * cross2(rx[m], ry[m], dbx[m], dby[m]);
        }
      } else {
        s[0] += djx[m] * im;
        s[1] += djy[m] * im;
        s[2] += ii * cross2(rx[m], ry[m], djx[m], djy[m]);
        if (BIAS) {
          s[3] += dbx[m] * im;
          s[4] += dby[m] * im;
          s[5] += ii * cross2(rx[m], ry[m], dbx[m], dby[m]);
        }
      }
    }
    for (int q = 0; q < 6; ++q) part[side][k][q] = s[q];
  }

  // apply's second half, body k: u = u + (A side) + (B side).
  template <bool BIAS>
  __host__ __device__ void apply_add(int k) {
    const float* pa = part[0][k];
    const float* pb = part[1][k];
    vx[k] = vx[k] + pa[0] + pb[0];
    vy[k] = vy[k] + pa[1] + pb[1];
    w[k] = w[k] + pa[2] + pb[2];
    if (BIAS) {
      vbx[k] = vbx[k] + pa[3] + pb[3];
      vby[k] = vby[k] + pa[4] + pb[4];
      wb[k] = wb[k] + pa[5] + pb[5];
    }
  }

  // _apply_joint_cached, lane 0.
  __host__ __device__ void apply_joint_cached() {
    float* pivot = jacc;          // 2
    float& gear = jacc[2];
    float* pin = jacc + 3;        // 2
    float* limit = jacc + 5;      // 2
    float* motor = jacc + 7;      // 2
    float* bpivot = jacc + 9;     // 2 MB
    float* bgear = jacc + 9 + 2 * MB;
    vx[0] = vx[0] + pivot[0] * inv_m[0];
    vy[0] = vy[0] + pivot[1] * inv_m[0];
    w[0] = w[0] + gear * inv_i[0];
    for (int side = 0; side < 2; ++side)
      if (limit_bias[side] == 0.0f) limit[side] = 0.0f;
    for (int side = 0; side < 2; ++side) {
      int fb = 1 + side;
      float dx = pin[side] * pin_nx[side], dy = pin[side] * pin_ny[side];
      vx[0] = vx[0] + -dx * inv_m[0];
      vy[0] = vy[0] + -dy * inv_m[0];
      w[0] = w[0] + -inv_i[0] * cross2(pin_r1x[side], pin_r1y[side], dx, dy);
      vx[fb] = vx[fb] + dx * inv_m[fb];
      vy[fb] = vy[fb] + dy * inv_m[fb];
      float dw = limit[side] + motor[side];
      w[0] = w[0] + -dw * inv_i[0];
      w[fb] = w[fb] + dw * inv_i[fb];
    }
    for (int k = 0; k < MB; ++k) {
      int bb = NROBOT + k;
      vx[bb] = vx[bb] + bpivot[2 * k] * inv_m[bb];
      vy[bb] = vy[bb] + bpivot[2 * k + 1] * inv_m[bb];
      w[bb] = w[bb] + bgear[k] * inv_i[bb];
    }
  }

  // One contact of the mass-splitting Jacobi sweep (_contact_iteration):
  // every contact reads the same pre-sweep velocities.
  __host__ __device__ void contact_sweep(int m) {
    int a = ia[m], b = ib[m];
    float nx = cnx[m], ny = cny[m];
    float vb1x = vbx[a] + (-r1y[m]) * wb[a];
    float vb1y = vby[a] + r1x[m] * wb[a];
    float vb2x = vbx[b] + (-r2y[m]) * wb[b];
    float vb2y = vby[b] + r2x[m] * wb[b];
    float vbn = (vb2x - vb1x) * nx + (vb2y - vb1y) * ny;
    float jbn = (bias[m] - vbn) * nmass[m];
    float jb_new = fmaxf(jb[m] + jbn, 0.0f);
    float djb = jb_new - jb[m];
    dbx[m] = djb * nx;
    dby[m] = djb * ny;
    jb[m] = jb_new;

    float vr1x = vx[a] + (-r1y[m]) * w[a];
    float vr1y = vy[a] + r1x[m] * w[a];
    float vr2x = vx[b] + (-r2y[m]) * w[b];
    float vr2y = vy[b] + r2x[m] * w[b];
    float vrx = vr2x - vr1x, vry = vr2y - vr1y;
    float vrn = vrx * nx + vry * ny;
    float jnv = -vrn * nmass[m];          // bounce = 0 (elasticity 0)
    float jn_new = fmaxf(jn[m] + jnv, 0.0f);
    float jt_max = cu[m] * jn_new;
    float vrt = vrx * (-ny) + vry * nx;
    float jtv = -vrt * tmass[m];
    float jt_new = fminf(fmaxf(jt[m] + jtv, -jt_max), jt_max);
    float dn = jn_new - jn[m], dtg = jt_new - jt[m];
    djx[m] = dn * nx + dtg * (-ny);
    djy[m] = dn * ny + dtg * nx;
    jn[m] = jn_new;
    jt[m] = jt_new;
  }

  // _joint_sweep over the robot's joints, Gauss-Seidel in canonical
  // order, lane 0; eye_target is the eye dampers' state of the substep.
  __host__ __device__ void robot_joints(float* eye_target) {
    float* pivot = jacc;
    float& gear = jacc[2];
    float* pin = jacc + 3;
    float* limit = jacc + 5;
    float* motor = jacc + 7;
    // 1. robot pivot velocity servo
    {
      float vrx = vx[0] - cvx, vry = vy[0] - cvy;
      float jx = -vrx / inv_m[0], jy = -vry / inv_m[0];
      float nx = pivot[0] + jx, ny = pivot[1] + jy;
      float norm = sqrtf(nx * nx + ny * ny);
      float sc = norm > pivot_jmax ? pivot_jmax / fmaxf(norm, 1e-12f)
                                   : 1.0f;
      nx = nx * sc;
      ny = ny * sc;
      vx[0] = vx[0] + (nx - pivot[0]) * inv_m[0];
      vy[0] = vy[0] + (ny - pivot[1]) * inv_m[0];
      pivot[0] = nx;
      pivot[1] = ny;
    }
    // 2. robot gear heading servo
    {
      float j = (gear_bias - w[0]) / inv_i[0];
      float nw = fminf(fmaxf(gear + j, -gear_jmax), gear_jmax);
      w[0] = w[0] + (nw - gear) * inv_i[0];
      gear = nw;
    }
    // 3. fingers: pin joint, rotary limit, simple motor per side
    for (int side = 0; side < 2; ++side) {
      int fb = 1 + side;
      float nx = pin_nx[side], ny = pin_ny[side];
      float rx = pin_r1x[side], ry = pin_r1y[side];
      float vr1x = vx[0] + (-ry) * w[0], vr1y = vy[0] + rx * w[0];
      float vrn = (vx[fb] - vr1x) * nx + (vy[fb] - vr1y) * ny;
      float j = (pin_bias[side] - vrn) * pin_nmass[side];
      float acc_new = pin[side] + j;
      float d = acc_new - pin[side];
      float dx = d * nx, dy = d * ny;
      vx[0] = vx[0] + -dx * inv_m[0];
      vy[0] = vy[0] + -dy * inv_m[0];
      w[0] = w[0] + -inv_i[0] * cross2(rx, ry, dx, dy);
      vx[fb] = vx[fb] + dx * inv_m[fb];
      vy[fb] = vy[fb] + dy * inv_m[fb];
      pin[side] = acc_new;

      float lb = limit_bias[side];
      float i_sum = 1.0f / (inv_i[0] + inv_i[fb]);
      float wr = w[fb] - w[0];
      j = -(lb + wr) * i_sum;
      acc_new = lb < 0.0f ? fmaxf(limit[side] + j, 0.0f)
                          : fminf(limit[side] + j, 0.0f);
      float dj = acc_new - limit[side];
      if (lb == 0.0f) {
        acc_new = 0.0f;
        dj = 0.0f;
      }
      w[0] = w[0] + -dj * inv_i[0];
      w[fb] = w[fb] + dj * inv_i[fb];
      limit[side] = acc_new;

      wr = w[fb] - w[0] + motor_rate[side];
      j = -wr * i_sum;
      acc_new = fminf(fmaxf(motor[side] + j, -motor_jmax), motor_jmax);
      dj = acc_new - motor[side];
      w[0] = w[0] + -dj * inv_i[0];
      w[fb] = w[fb] + dj * inv_i[fb];
      motor[side] = acc_new;
    }
    // 4. eye damped rotary springs (damping part)
    for (int side = 0; side < 2; ++side) {
      int eb = 3 + side;
      float i_sum = 1.0f / (inv_i[0] + inv_i[eb]);
      float wrn = w[0] - w[eb];
      float w_damp = (eye_target[side] - wrn) * eye_wcoef;
      float new_target = wrn + w_damp;
      float j_damp = w_damp * i_sum;
      w[0] = w[0] + j_damp * inv_i[0];
      w[eb] = w[eb] + -j_damp * inv_i[eb];
      eye_target[side] = new_target;
    }
  }

  // 5. the top-down friction damper of block k: its own body and
  // accumulators only, so the blocks go across lanes.
  __host__ __device__ void block_damper(int k) {
    float* bpivot = jacc + 9;
    float* bgear = jacc + 9 + 2 * MB;
    int bb = NROBOT + k;
    float imb = inv_m[bb], iib = inv_i[bb];
    float safe_m = imb > 0.0f ? imb : 1.0f;
    float jx = imb > 0.0f ? -vx[bb] / safe_m : 0.0f;
    float jy = imb > 0.0f ? -vy[bb] / safe_m : 0.0f;
    float nx = bpivot[2 * k] + jx, ny = bpivot[2 * k + 1] + jy;
    float norm = sqrtf(nx * nx + ny * ny);
    float sc = norm > bp_jmax ? bp_jmax / fmaxf(norm, 1e-12f) : 1.0f;
    nx = nx * sc;
    ny = ny * sc;
    vx[bb] = vx[bb] + (nx - bpivot[2 * k]) * imb;
    vy[bb] = vy[bb] + (ny - bpivot[2 * k + 1]) * imb;
    bpivot[2 * k] = nx;
    bpivot[2 * k + 1] = ny;

    float safe_i = iib > 0.0f ? iib : 1.0f;
    float j = iib > 0.0f ? -w[bb] / safe_i : 0.0f;
    float nw = fminf(fmaxf(bgear[k] + j, -bg_jmax), bg_jmax);
    w[bb] = w[bb] + (nw - bgear[k]) * iib;
    bgear[k] = nw;
  }
};

// Cycles of the phase just ended, added to the step's count of phase `ph`
// in registers (only on the card, and only where the caller asked for
// them); lane 0 adds the counts to the env's row once, at the step's end.
#ifdef __CUDA_ARCH__
#define PHASE_CLOCK(ph)                                         \
  do {                                                          \
    if (clk) {                                                  \
      const long long now = clock64();                          \
      cyc[ph] += now - t_last;                                  \
      t_last = now;                                             \
    }                                                           \
  } while (0)
#else
#define PHASE_CLOCK(ph) \
  do {                  \
  } while (0)
#endif

// Env b's state into `e` (bodies, blocks, caches, the robot's targets,
// inverse masses, slot activity) and the narrowphase's item list.
template <int MB>
__host__ __device__ void load_env(const Args& a, int b, WarpEnv<MB>& e,
                                  int lane) {
  using E = WarpEnv<MB>;
  const Tables& tab = a.tab;
  WARP_PHASE({
    for (int k = lane; k < E::NB; k += LANES) e.load_body(a, b, k);
    for (int k = lane; k < MB; k += LANES) {
      e.shape[k] = a.block_shape[b * MB + k];
      e.bactive[k] = a.block_active[b * MB + k] != 0;
    }
    for (int m = lane; m < E::MAXC; m += LANES) {
      e.cid[m] = a.con_id[b * E::MAXC + m];
      e.jn[m] = a.con_jn[b * E::MAXC + m];
      e.jt[m] = a.con_jt[b * E::MAXC + m];
    }
    for (int k = lane; k < E::NJ; k += LANES)
      e.jacc[k] = a.joint_acc[b * E::NJ + k];
    if (lane == 0) {
      e.px[E::NB] = e.py[E::NB] = e.ang[E::NB] = 0.0f;
      e.vx[E::NB] = e.vy[E::NB] = e.w[E::NB] = 0.0f;
      e.vbx[E::NB] = e.vby[E::NB] = e.wb[E::NB] = 0.0f;
      e.targets(a, b);
    }
  });
  WARP_PHASE({
    for (int k = lane; k < E::NBP; k += LANES) e.masses(tab, k);
    for (int s = lane; s < E::NS; s += LANES)
      e.sact[s] = e.slot_active(tab, s);
    if (lane == 0) e.n_items = e.n_items_next = 0;
  });
  for (int base = 0; base < E::NITEM; base += LANES) {
    WARP_PHASE({
      e.flag_item(tab, base + lane, lane);
      if (lane == 0) e.n_items = e.n_items_next;
    });
    WARP_PHASE(e.place_item(base, lane));
  }
  WARP_PHASE(if (lane == 0) e.n_items = e.n_items_next);
}

// One round of full contact tests: lane l tests the item at (at + l) of
// `list` (a ring of 2 LANES, or the item list from its start) if l < n,
// then the round's contacts join the list after those before them.
template <int MB>
__host__ __device__ void full_tests(const Tables& tab, WarpEnv<MB>& e,
                                    int lane, const unsigned short* list,
                                    int at, int n) {
  WARP_PHASE({
    e.narrow(tab, lane < n ? list[(at + lane) % (2 * LANES)] : -1, lane);
    if (lane == 0) e.nc = e.nc_next;
  });
  WARP_PHASE(e.compact(tab, lane));
}

// A substep's narrowphase, after integration: the slots and their circles,
// the caches moved to old_*, then the full tests of the items that can
// touch, compacted in candidate order.  An item list that fits one round
// is tested as it is; a longer one is culled 32 items a round (near_item)
// into the ring `near`, in candidate order, and a round of full tests runs
// whenever 32 wait, then on the rest.  The contact list is the one a full
// test of every item gives (no culled item makes a valid contact, see
// CULL_MARGIN), bit for bit.  Returns the number of items tested in full,
// the same in every lane.
template <int MB>
__host__ __device__ int narrowphase(const Tables& tab, WarpEnv<MB>& e,
                                   int lane) {
  using E = WarpEnv<MB>;
  WARP_PHASE({
    for (int s = lane; s < E::NS; s += LANES) e.build_slot(tab, s);
    for (int m = lane; m < E::MAXC; m += LANES) {
      e.old_id[m] = e.cid[m];
      e.old_jn[m] = e.jn[m];
      e.old_jt[m] = e.jt[m];
    }
    if (lane == 0) e.nc = e.nc_next = 0;
  });
  const int n = e.n_items;
  int tested = n;
  if (n <= LANES) {
    full_tests(tab, e, lane, e.items, 0, n);
  } else {
    int head = 0, waiting = 0;        // the ring's untested near items
    tested = 0;
    for (int base = 0; base < n; base += LANES) {
      int found = 0;
#ifdef __CUDA_ARCH__
      WARP_PHASE({
        const int k0 = base + lane < n ? e.items[base + lane] : -1;
        const bool on = k0 >= 0 && e.near_item(tab, k0);
        const unsigned m = __ballot_sync(0xffffffffu, on);
        if (on)
          e.near[(head + waiting + __popc(m & ((1u << lane) - 1u))) %
                 (2 * LANES)] = (unsigned short)k0;
        found = __popc(m);
      });
#else
      WARP_PHASE(e.item_on[lane] = base + lane < n &&
                                   e.near_item(tab, e.items[base + lane]));
      WARP_PHASE(found = e.place_near(base, head + waiting, lane));
#endif
      waiting += found;
      tested += found;
      if (waiting >= LANES) {
        full_tests(tab, e, lane, e.near, head, LANES);
        head = (head + LANES) % (2 * LANES);
        waiting -= LANES;
      }
    }
    if (waiting > 0) full_tests(tab, e, lane, e.near, head, waiting);
  }
  WARP_PHASE(if (lane == 0) e.nc = e.nc_next);
  return tested;
}

// Env b's whole control step (10 substeps x 10 solver iterations) on the
// lanes of one warp, `e` its state in shared memory, `lane` this thread's
// lane (a host build runs every lane of each phase in turn).  Wherever two
// lanes' results meet (the contact list, the per-body sums) it keeps the
// sequential order of operations of core/physics.py.
template <int MB>
__host__ __device__ void control_step_warp(const Args& a, int b,
                                           WarpEnv<MB>& e, int lane) {
  using E = WarpEnv<MB>;
  const Tables& tab = a.tab;
  const float dt = tab.f[FT_SCALARS + SC_DT];
  long long* clk = a.phase_clock ? a.phase_clock + (size_t)b * N_PHASES
                                 : nullptr;
#ifdef __CUDA_ARCH__
  long long t_last = clock64();
  long long cyc[N_PHASES] = {};
#endif
  (void)clk;
  // the step's items and items tested in full, where the caller counts
  long long* counts = a.item_count ? a.item_count + (size_t)b * 2 : nullptr;
  int n_items = 0, n_tested = 0;

  load_env(a, b, e, lane);
  PHASE_CLOCK(PH_OTHER);

  for (int sub = 0; sub < a.phys_steps; ++sub) {
    WARP_PHASE(if (lane == 0) e.robot_update());
    WARP_PHASE(for (int k = lane; k < E::NB; k += LANES) e.integrate(dt, k));
    PHASE_CLOCK(PH_OTHER);

    const int tested = narrowphase(tab, e, lane);
    if (counts) {
      n_items += e.n_items;
      n_tested += tested;
    }
    PHASE_CLOCK(PH_NARROW);

    // contact and joint prestep, warm start
    const int nc = e.nc;
    WARP_PHASE(for (int k = lane; k < E::NBP; k += LANES) e.degree(k));
    WARP_PHASE({
      for (int m = lane; m < nc; m += LANES) e.contact_prestep(m);
      if (lane == 0) e.joint_prestep(tab);
    });
    WARP_PHASE({
      for (int k = lane; k < E::NB; k += LANES)
        e.vbx[k] = e.vby[k] = e.wb[k] = 0.0f;
      for (int m = lane; m < nc; m += LANES) e.warm_start(m);
    });
    WARP_PHASE(e.template apply_sums<false>(lane));
    WARP_PHASE(for (int k = lane; k < E::NBP; k += LANES)
                   e.template apply_add<false>(k));
    WARP_PHASE(if (lane == 0) e.apply_joint_cached());
    PHASE_CLOCK(PH_PRESTEP);

    // solver iterations
    float eye_target[2] = {0.0f, 0.0f};     // lane 0's
    for (int iter = 0; iter < a.iterations; ++iter) {
      WARP_PHASE(for (int m = lane; m < nc; m += LANES) e.contact_sweep(m));
      PHASE_CLOCK(PH_SWEEP);
      WARP_PHASE(e.template apply_sums<true>(lane));
      WARP_PHASE(for (int k = lane; k < E::NBP; k += LANES)
                     e.template apply_add<true>(k));
      PHASE_CLOCK(PH_APPLY);
      WARP_PHASE({
        if (lane == 0) e.robot_joints(eye_target);
        for (int k = lane; k < MB; k += LANES) e.block_damper(k);
      });
      PHASE_CLOCK(PH_JOINTS);
    }

    // contacts past the valid count leave the cache empty
    WARP_PHASE(for (int m = nc + lane; m < E::MAXC; m += LANES) {
      e.cid[m] = -1;
      e.jn[m] = 0.0f;
      e.jt[m] = 0.0f;
    });
    PHASE_CLOCK(PH_OTHER);
  }

  WARP_PHASE({
    for (int k = lane; k < E::NB; k += LANES) e.store_body(a, b, k);
    for (int m = lane; m < E::MAXC; m += LANES) {
      a.con_id[b * E::MAXC + m] = e.cid[m];
      a.con_jn[b * E::MAXC + m] = e.jn[m];
      a.con_jt[b * E::MAXC + m] = e.jt[m];
    }
    for (int k = lane; k < E::NJ; k += LANES)
      a.joint_acc[b * E::NJ + k] = e.jacc[k];
    if (lane == 0) a.t[b] = a.t[b] + 1;
  });
  PHASE_CLOCK(PH_OTHER);
#ifdef __CUDA_ARCH__
  if (clk && lane == 0) {
#pragma unroll
    for (int p = 0; p < N_PHASES; ++p) clk[p] += cyc[p];
  }
#endif
  if (counts && lane == 0) {
    counts[0] += n_items;
    counts[1] += n_tested;
  }
}

}  // namespace magical
