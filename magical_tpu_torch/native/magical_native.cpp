// Native host-side support library for magical_tpu_torch, a copy of
// magical_tpu's (the port imports nothing of the JAX package).
//
// The reference's native substrate was Chipmunk2D (physics), OpenGL
// (render) and OpenCV (resize).  The first two became device kernels;
// this library supplies the host-side native pieces that remain:
//
//   * INTER_AREA image downscaling with cv2-exact integer-ratio
//     semantics (benchmarks/__init__.py:162-169) for the demo-data
//     pipeline (batch preprocessing of 384x384 demo frames), threaded.
//   * A numpy-compatible MT19937 stream (RandomState.uniform / randint /
//     choice / shuffle) used by the reference-parity reset sampler
//     (base_env.py:133-140 seeds np.random.RandomState; every variant
//     draw flows through it).
//
// Build: on first use, by magical_tpu_torch/native/__init__.py with the
// host c++, into build/magical_tpu_torch/ (ctypes binding, same file).

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// INTER_AREA resize (exact for integer downscale ratios: box mean with
// round-half-away-from-zero, matching cv2's fixed-point rounding)
// ---------------------------------------------------------------------------

static void resize_area_rows(const uint8_t* src, uint8_t* dst, int h,
                             int w, int c, int fh, int fw, int row0,
                             int row1) {
  const int out_w = w / fw;
  const double inv = 1.0 / (fh * fw);
  for (int oy = row0; oy < row1; ++oy) {
    for (int ox = 0; ox < out_w; ++ox) {
      for (int ch = 0; ch < c; ++ch) {
        uint32_t acc = 0;
        for (int dy = 0; dy < fh; ++dy) {
          const uint8_t* row = src + (((oy * fh + dy) * w) + ox * fw) * c;
          for (int dx = 0; dx < fw; ++dx) acc += row[dx * c + ch];
        }
        dst[(oy * out_w + ox) * c + ch] =
            (uint8_t)(acc * inv + 0.5);
      }
    }
  }
}

// Downscale a batch of HxWxC uint8 images by integer factors (fh, fw).
void resize_area_batch(const uint8_t* src, uint8_t* dst, int n, int h,
                       int w, int c, int fh, int fw, int n_threads) {
  const int out_h = h / fh, out_w = w / fw;
  const size_t in_sz = (size_t)h * w * c;
  const size_t out_sz = (size_t)out_h * out_w * c;
  if (n_threads <= 1 || n == 1) {
    for (int i = 0; i < n; ++i)
      resize_area_rows(src + i * in_sz, dst + i * out_sz, h, w, c, fh, fw,
                       0, out_h);
    return;
  }
  std::vector<std::thread> threads;
  int per = (n + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    int lo = t * per, hi = lo + per > n ? n : lo + per;
    if (lo >= hi) break;
    threads.emplace_back([=]() {
      for (int i = lo; i < hi; ++i)
        resize_area_rows(src + i * in_sz, dst + i * out_sz, h, w, c, fh,
                         fw, 0, out_h);
    });
  }
  for (auto& th : threads) th.join();
}

// ---------------------------------------------------------------------------
// numpy-compatible MT19937 (RandomState legacy generator)
// ---------------------------------------------------------------------------

struct MT19937 {
  uint32_t mt[624];
  int mti;
  double gauss_next;   // unused, kept for layout clarity
  int has_gauss;
};

static void mt_init_genrand(MT19937* st, uint32_t s) {
  st->mt[0] = s;
  for (int i = 1; i < 624; ++i)
    st->mt[i] = 1812433253u * (st->mt[i - 1] ^ (st->mt[i - 1] >> 30)) + i;
  st->mti = 624;
}

// numpy's init_by_array seeding (RandomState(seed) for integer seeds uses
// init_by_array with the seed's 32-bit words)
static void mt_init_by_array(MT19937* st, const uint32_t* key,
                             int key_len) {
  mt_init_genrand(st, 19650218u);
  int i = 1, j = 0;
  int k = 624 > key_len ? 624 : key_len;
  for (; k; --k) {
    st->mt[i] = (st->mt[i] ^ ((st->mt[i - 1] ^ (st->mt[i - 1] >> 30)) *
                              1664525u)) + key[j] + j;
    ++i; ++j;
    if (i >= 624) { st->mt[0] = st->mt[623]; i = 1; }
    if (j >= key_len) j = 0;
  }
  for (k = 623; k; --k) {
    st->mt[i] = (st->mt[i] ^ ((st->mt[i - 1] ^ (st->mt[i - 1] >> 30)) *
                              1566083941u)) - i;
    ++i;
    if (i >= 624) { st->mt[0] = st->mt[623]; i = 1; }
  }
  st->mt[0] = 0x80000000u;
  st->mti = 624;
}

static uint32_t mt_next32(MT19937* st) {
  const uint32_t UPPER = 0x80000000u, LOWER = 0x7fffffffu;
  if (st->mti >= 624) {
    static const uint32_t mag[2] = {0u, 0x9908b0dfu};
    int kk;
    for (kk = 0; kk < 624 - 397; ++kk) {
      uint32_t y = (st->mt[kk] & UPPER) | (st->mt[kk + 1] & LOWER);
      st->mt[kk] = st->mt[kk + 397] ^ (y >> 1) ^ mag[y & 1];
    }
    for (; kk < 623; ++kk) {
      uint32_t y = (st->mt[kk] & UPPER) | (st->mt[kk + 1] & LOWER);
      st->mt[kk] = st->mt[kk + (397 - 624)] ^ (y >> 1) ^ mag[y & 1];
    }
    uint32_t y = (st->mt[623] & UPPER) | (st->mt[0] & LOWER);
    st->mt[623] = st->mt[396] ^ (y >> 1) ^ mag[y & 1];
    st->mti = 0;
  }
  uint32_t y = st->mt[st->mti++];
  y ^= (y >> 11);
  y ^= (y << 7) & 0x9d2c5680u;
  y ^= (y << 15) & 0xefc60000u;
  y ^= (y >> 18);
  return y;
}

// random_double in [0, 1): numpy's legacy rk_double (53-bit)
static double mt_double(MT19937* st) {
  uint32_t a = mt_next32(st) >> 5, b = mt_next32(st) >> 6;
  return (a * 67108864.0 + b) / 9007199254740992.0;
}

void* mt_new(uint32_t seed) {
  // numpy's legacy RandomState seeds 32-bit integer seeds with plain
  // init_genrand (randomkit rk_seed), NOT init_by_array (which numpy uses
  // only for array/large seeds and python's random.Random uses always).
  MT19937* st = new MT19937();
  mt_init_genrand(st, seed);
  return st;
}

void* mt_new_by_array(const uint32_t* key, int key_len) {
  MT19937* st = new MT19937();
  mt_init_by_array(st, key, key_len);
  return st;
}

void mt_free(void* h) { delete (MT19937*)h; }

void mt_uniform(void* h, double lo, double hi, double* out, int n) {
  MT19937* st = (MT19937*)h;
  for (int i = 0; i < n; ++i) out[i] = lo + (hi - lo) * mt_double(st);
}

// numpy legacy randint(lo, hi): Lemire-free masked rejection (rk_interval)
void mt_randint(void* h, int64_t lo, int64_t hi, int64_t* out, int n) {
  MT19937* st = (MT19937*)h;
  uint64_t rng_ = (uint64_t)(hi - lo - 1);   // max inclusive offset
  if (rng_ == 0) {
    for (int i = 0; i < n; ++i) out[i] = lo;
    return;
  }
  uint64_t mask = rng_;
  mask |= mask >> 1; mask |= mask >> 2; mask |= mask >> 4;
  mask |= mask >> 8; mask |= mask >> 16; mask |= mask >> 32;
  for (int i = 0; i < n; ++i) {
    uint64_t v;
    if (rng_ <= 0xffffffffull) {
      // numpy draws 32-bit words via rk_random when the range fits
      do { v = (uint64_t)(mt_next32(st)) & mask; } while (v > rng_);
    } else {
      do {
        uint64_t a = mt_next32(st), b = mt_next32(st);
        v = ((a << 32) | b) & mask;
      } while (v > rng_);
    }
    out[i] = lo + (int64_t)v;
  }
}

// Fisher-Yates shuffle matching numpy's RandomState.shuffle draw order
void mt_shuffle_indices(void* h, int64_t* idx, int n) {
  MT19937* st = (MT19937*)h;
  // numpy: for i in reversed(range(1, n)): j = rk_interval(i+1); swap
  for (int64_t i = n - 1; i > 0; --i) {
    uint64_t rng_ = (uint64_t)i;   // max inclusive
    uint64_t mask = rng_;
    mask |= mask >> 1; mask |= mask >> 2; mask |= mask >> 4;
    mask |= mask >> 8; mask |= mask >> 16; mask |= mask >> 32;
    uint64_t j;
    do { j = (uint64_t)(mt_next32(st)) & mask; } while (j > rng_);
    int64_t tmp = idx[i]; idx[i] = idx[j]; idx[j] = tmp;
  }
}

}  // extern "C"
