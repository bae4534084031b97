// Per-env arithmetic of the MAGICAL control-step kernel
// (physics_step.cu): narrowphase, compaction, contact and joint solve.
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
constexpr int FT_SCALARS = FT_FINGER_LIM + 4;
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
  bool active;
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

// ---------------------------------------------------------------------------
// One env's control step (core/physics.py)
// ---------------------------------------------------------------------------

template <int MB>
struct Env {
  static constexpr int NB = NROBOT + MB;
  static constexpr int NBP = NB + 1;           // + the static wall body
  static constexpr int NS = 5 + KSUB * MB;
  static constexpr int NP = 5 * KSUB * MB + KSUB * KSUB * MB * (MB - 1) / 2;
  static constexpr int KC = 8 * NS + 2 * NP;
  static constexpr int MAXC = 32 + 16 * MB;
  static constexpr int NJ = 9 + 3 * MB;

  // bodies (index NB is the static wall body: zero pose, zero inverse mass)
  float px[NBP], py[NBP], ang[NB];
  float vx[NBP], vy[NBP], w[NBP];
  float vbx[NBP], vby[NBP], wb[NBP];
  float inv_m[NBP], inv_i[NBP];
  float ts, tt, tf;          // action targets
  float phys[5];
  int shape[MB];
  bool bactive[MB];

  // warm-start caches
  int nc;
  int cid[MAXC];
  float jn[MAXC], jt[MAXC];
  float jacc[NJ];

  // compacted contacts of the current substep
  int ia[MAXC], ib[MAXC];
  float ptx[MAXC], pty[MAXC], cnx[MAXC], cny[MAXC], cd[MAXC], cu[MAXC];
  float r1x[MAXC], r1y[MAXC], r2x[MAXC], r2y[MAXC];
  float nmass[MAXC], tmass[MAXC], bias[MAXC];
  float ima[MAXC], imb[MAXC], iia[MAXC], iib[MAXC];
  float jb[MAXC];

  Poly slots[NS];

  __host__ __device__ void load(const Args& a, int b) {
    const float* ft = a.tab.f;
    for (int k = 0; k < NB; ++k) {
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
    px[NB] = py[NB] = vx[NB] = vy[NB] = w[NB] = 0.0f;
    vbx[NB] = vby[NB] = wb[NB] = 0.0f;
    for (int k = 0; k < MB; ++k) {
      shape[k] = a.block_shape[b * MB + k];
      bactive[k] = a.block_active[b * MB + k] != 0;
    }
    for (int k = 0; k < 5; ++k) phys[k] = a.phys[b * 5 + k];
    // inverse masses (core/state.py inv_mass_arrays)
    for (int k = 0; k < NROBOT; ++k) {
      inv_m[k] = ft[FT_INV_M_ROBOT + k];
      inv_i[k] = ft[FT_INV_I_ROBOT + k];
    }
    for (int k = 0; k < MB; ++k) {
      float act = bactive[k] ? 1.0f : 0.0f;
      inv_m[NROBOT + k] = act / ft[FT_SCALARS + SC_SHAPE_MASS];
      inv_i[NROBOT + k] = act / ft[FT_BLOCK_MOMENT + shape[k]];
    }
    inv_m[NB] = inv_i[NB] = 0.0f;
    // action targets (Robot.set_action)
    int act = a.action[b];
    ts = ft[FT_ACT_SPEED + act];
    tt = ft[FT_ACT_TURN + act];
    tf = ft[FT_ACT_FINGER + act];
    a.target_speed[b] = ts;
    a.rel_turn_angle[b] = tt;
    a.target_finger_angle[b] = tf;
    // caches
    nc = 0;
    for (int m = 0; m < MAXC; ++m) {
      cid[m] = a.con_id[b * MAXC + m];
      jn[m] = a.con_jn[b * MAXC + m];
      jt[m] = a.con_jt[b * MAXC + m];
    }
    for (int k = 0; k < NJ; ++k) jacc[k] = a.joint_acc[b * NJ + k];
  }

  __host__ __device__ void store(const Args& a, int b) const {
    for (int k = 0; k < NB; ++k) {
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
    for (int m = 0; m < MAXC; ++m) {
      a.con_id[b * MAXC + m] = cid[m];
      a.con_jn[b * MAXC + m] = jn[m];
      a.con_jt[b * MAXC + m] = jt[m];
    }
    for (int k = 0; k < NJ; ++k) a.joint_acc[b * NJ + k] = jacc[k];
    a.t[b] = a.t[b] + 1;
  }

  // Per-slot world geometry (physics.py slot_geometry + transform_verts).
  __host__ __device__ void build_slots(const Tables& tab) {
    const float* ft = tab.f;
    const int* it = tab.i;
    for (int s = 0; s < NS; ++s) {
      Poly& p = slots[s];
      float lv[NV][2];
      if (s < 5) {
        for (int v = 0; v < NV; ++v) {
          lv[v][0] = ft[FT_ROBOT_VERTS + (s * NV + v) * 2];
          lv[v][1] = ft[FT_ROBOT_VERTS + (s * NV + v) * 2 + 1];
        }
        p.nv = it[IT_ROBOT_NV + s];
        p.rad = ft[FT_ROBOT_RAD + s];
        p.active = true;
      } else {
        int bi = (s - 5) / KSUB, k = (s - 5) % KSUB;
        int tk = shape[bi] * KSUB + k;
        for (int v = 0; v < NV; ++v) {
          lv[v][0] = ft[FT_BLOCK_VERTS + (tk * NV + v) * 2];
          lv[v][1] = ft[FT_BLOCK_VERTS + (tk * NV + v) * 2 + 1];
        }
        p.nv = it[IT_BLOCK_NV + tk];
        p.rad = ft[FT_BLOCK_RAD + tk];
        p.active = it[IT_BLOCK_ACTIVE + tk] != 0 && bactive[bi];
      }
      int body = it[IT_SLOT_BODY + s];
      float c = cosf(ang[body]), sn = sinf(ang[body]);
      for (int v = 0; v < NV; ++v) {
        p.v[v][0] = c * lv[v][0] - sn * lv[v][1] + px[body];
        p.v[v][1] = sn * lv[v][0] + c * lv[v][1] + py[body];
      }
    }
  }

  __host__ __device__ void push(int k, const Contact2& c, int p,
                                const Tables& tab) {
    if (!c.valid[p] || nc >= MAXC) return;   // later valid ones dropped
    const int* it = tab.i;
    const int cand_a = IT_SLOT_BODY + NS + 2 * NP;
    int m = nc++;
    cid[m] = k;
    ia[m] = it[cand_a + k];
    ib[m] = it[cand_a + KC + k];
    cu[m] = tab.f[FT_CAND_FRICTION + k];
    ptx[m] = c.pt[p][0];
    pty[m] = c.pt[p][1];
    cnx[m] = c.n[0];
    cny[m] = c.n[1];
    cd[m] = c.d[p];
  }

  // Narrowphase over the flat candidate list + stable compaction.  The
  // previous caches move to (old_*) for the warm-start match.
  __host__ __device__ void collide(const Tables& tab, int* old_id,
                                   float* old_jn, float* old_jt) {
    const int* it = tab.i;
    for (int m = 0; m < MAXC; ++m) {
      old_id[m] = cid[m];
      old_jn[m] = jn[m];
      old_jt[m] = jt[m];
    }
    nc = 0;
    const float wn[4][2] = {{1.f, 0.f}, {-1.f, 0.f}, {0.f, 1.f}, {0.f, -1.f}};
    Contact2 c;
    for (int wi = 0; wi < 4; ++wi) {
      for (int s = 0; s < NS; ++s) {
        if (!slots[s].active) continue;
        wall_contacts(slots[s], wn[wi][0], wn[wi][1], -1.0f, c);
        for (int p = 0; p < 2; ++p) push((wi * NS + s) * 2 + p, c, p, tab);
      }
    }
    for (int i = 0; i < NP; ++i) {
      int sa = it[IT_SLOT_BODY + NS + i];
      int sb = it[IT_SLOT_BODY + NS + NP + i];
      if (!(slots[sa].active && slots[sb].active)) continue;
      pair_contacts(slots[sa], slots[sb], c);
      for (int p = 0; p < 2; ++p) push(8 * NS + 2 * i + p, c, p, tab);
    }
  }

  // cpArbiterPreStep with mass-splitting stiffness (_contact_prestep).
  __host__ __device__ void contact_prestep(const Tables& tab) {
    const float* ft = tab.f;
    float deg[NBP];
    for (int k = 0; k < NBP; ++k) deg[k] = 0.0f;
    for (int m = 0; m < nc; ++m) deg[ia[m]] += 1.0f;
    for (int m = 0; m < nc; ++m) deg[ib[m]] += 1.0f;
    for (int k = 0; k < NBP; ++k) deg[k] = fmaxf(deg[k], 1.0f);
    float coef = ft[FT_SCALARS + SC_BIAS_COEF];
    float slop = ft[FT_SCALARS + SC_SLOP];
    float dt = ft[FT_SCALARS + SC_DT];
    for (int m = 0; m < nc; ++m) {
      int a = ia[m], b = ib[m];
      r1x[m] = ptx[m] - px[a];
      r1y[m] = pty[m] - py[a];
      r2x[m] = ptx[m] - px[b];
      r2y[m] = pty[m] - py[b];
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
      bias[m] = -coef * fminf(cd[m] + slop, 0.0f) / dt;
      // impulses use the TRUE inverse masses
      ima[m] = inv_m[a];
      imb[m] = inv_m[b];
      iia[m] = inv_i[a];
      iib[m] = inv_i[b];
    }
  }

  // Add per-contact impulses (dx, dy) to (ux, uy, uw): -dj on A, +dj on B,
  // per-body sums taken in contact order, A side then B side.
  __host__ __device__ void apply(const float* djx, const float* djy,
                                 float* ux, float* uy, float* uw) const {
    float ax[NBP], ay[NBP], aw[NBP], bx[NBP], by[NBP], bw[NBP];
    for (int k = 0; k < NBP; ++k)
      ax[k] = ay[k] = aw[k] = bx[k] = by[k] = bw[k] = 0.0f;
    for (int m = 0; m < nc; ++m) {
      ax[ia[m]] += -djx[m] * ima[m];
      ay[ia[m]] += -djy[m] * ima[m];
      bx[ib[m]] += djx[m] * imb[m];
      by[ib[m]] += djy[m] * imb[m];
      aw[ia[m]] += -iia[m] * cross2(r1x[m], r1y[m], djx[m], djy[m]);
      bw[ib[m]] += iib[m] * cross2(r2x[m], r2y[m], djx[m], djy[m]);
    }
    for (int k = 0; k < NBP; ++k) {
      ux[k] = ux[k] + ax[k] + bx[k];
      uy[k] = uy[k] + ay[k] + by[k];
      uw[k] = uw[k] + aw[k] + bw[k];
    }
  }

  // One mass-splitting Jacobi sweep (_contact_iteration): every contact
  // reads the same pre-sweep velocities.
  __host__ __device__ void contact_iteration() {
    float djx[MAXC], djy[MAXC], dbx[MAXC], dby[MAXC];
    for (int m = 0; m < nc; ++m) {
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
    apply(djx, djy, vx, vy, w);
    apply(dbx, dby, vbx, vby, wb);
  }

  __host__ __device__ void substep(const Tables& tab, int iterations) {
    const float* ft = tab.f;
    const float dt = ft[FT_SCALARS + SC_DT];

    // ---- Robot.update, BEFORE integration --------------------------------
    float a0 = ang[0];
    float control_angle = a0 + tt;
    float cvx = ts * -sinf(a0), cvy = ts * cosf(a0);
    float motor_rate[2];
    for (int side = 0; side < 2; ++side) {
      float rel = ang[1 + side] - a0;
      float err = rel + (side == 0 ? -tf : tf);
      float r = clampf(err * 10.0f, -1.0f, 1.0f);
      motor_rate[side] = fabsf(r) < 1e-4f ? 0.0f : r;
    }

    // ---- integrate positions (cpBodyUpdatePosition) ----------------------
    for (int k = 0; k < NB; ++k) {
      px[k] = px[k] + (vx[k] + vbx[k]) * dt;
      py[k] = py[k] + (vy[k] + vby[k]) * dt;
      ang[k] = ang[k] + (w[k] + wb[k]) * dt;
    }

    // ---- narrowphase + contact prestep ------------------------------------
    int old_id[MAXC];
    float old_jn[MAXC], old_jt[MAXC];
    build_slots(tab);
    collide(tab, old_id, old_jn, old_jt);
    contact_prestep(tab);

    // ---- joint prestep ----------------------------------------------------
    float gear_err = ang[0] - control_angle;
    float gmb = ft[FT_SCALARS + SC_GEAR_MAX_BIAS];
    float gear_bias = clampf(-gear_err / dt, -gmb, gmb);
    float c0 = cosf(ang[0]), s0 = sinf(ang[0]);
    float pin_nx[2], pin_ny[2], pin_r1x[2], pin_r1y[2], pin_nmass[2];
    float pin_bias[2], limit_bias[2];
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
    float eye_wcoef =
        1.0f - expf(ft[FT_SCALARS + SC_EYE_DAMP_DT] * eye_isum_inv);
    float pivot_jmax = phys[0] * dt, gear_jmax = phys[1] * dt;
    float motor_jmax = phys[2] * dt;
    float bp_jmax = phys[3] * dt, bg_jmax = phys[4] * dt;

    // ---- warm start (cpArbiterApplyCachedImpulse + constraint jAcc) -------
    for (int k = 0; k < NB; ++k) vbx[k] = vby[k] = wb[k] = 0.0f;
    float djx[MAXC], djy[MAXC];
    for (int m = 0; m < nc; ++m) {
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
    apply(djx, djy, vx, vy, w);

    float* pivot = jacc;          // 2
    float& gear = jacc[2];
    float* pin = jacc + 3;        // 2
    float* limit = jacc + 5;      // 2
    float* motor = jacc + 7;      // 2
    float* bpivot = jacc + 9;     // 2 MB
    float* bgear = jacc + 9 + 2 * MB;
    float eye_target[2] = {0.0f, 0.0f};

    // _apply_joint_cached
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

    // ---- solver iterations ------------------------------------------------
    for (int iter = 0; iter < iterations; ++iter) {
      contact_iteration();

      // _joint_sweep: Gauss-Seidel over the joints, in canonical order.
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
      // 5. block top-down friction dampers
      for (int k = 0; k < MB; ++k) {
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
    }

    // contacts past the valid count leave the cache empty
    for (int m = nc; m < MAXC; ++m) {
      cid[m] = -1;
      jn[m] = 0.0f;
      jt[m] = 0.0f;
    }
  }
};

template <int MB>
__host__ __device__ void control_step_env(const Args& a, int b) {
  Env<MB> env;
  env.load(a, b);
  for (int s = 0; s < a.phys_steps; ++s) env.substep(a.tab, a.iterations);
  env.store(a, b);
}

}  // namespace magical
