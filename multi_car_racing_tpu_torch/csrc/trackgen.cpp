// Native track generator — bit-exact with the host Python oracle.
//
// Reimplements track/host.py (= the reference's _create_track, mcr:183-338)
// in C++ for fast host-side resets: the Mersenne Twister is numpy
// RandomState-compatible (init_by_array seeding, 53-bit random_sample), the
// walk runs in IEEE doubles through the same libm calls, and the caller
// passes the MT19937 state in/out so the stream continues exactly like a
// shared numpy RandomState across episodes (the reference never reseeds
// between resets).
//
// Interface (ctypes, see multi_car_racing_tpu_torch/native.py):
//   void mcr_seed(const uint32_t* key, int key_len, uint32_t* state, int* pos);
//   int  mcr_generate_track(uint32_t* state, int* pos, int max_retries,
//                           double* out_track /* capacity 2500*4 */,
//                           uint8_t* out_border /* capacity 2500 */,
//                           int* out_retries);
//   returns tile count T (track rows are (alpha, beta, x, y)), or -1 on
//   failure after max_retries.

#include <cmath>
#include <cstdint>
#include <cstring>

namespace {

constexpr int N = 624;
constexpr int M = 397;
constexpr uint32_t MATRIX_A = 0x9908b0dfU;
constexpr uint32_t UPPER_MASK = 0x80000000U;
constexpr uint32_t LOWER_MASK = 0x7fffffffU;

struct MT {
  uint32_t mt[N];
  int mti;

  void init_genrand(uint32_t s) {
    mt[0] = s;
    for (mti = 1; mti < N; mti++) {
      mt[mti] = 1812433253U * (mt[mti - 1] ^ (mt[mti - 1] >> 30)) + mti;
    }
  }

  void init_by_array(const uint32_t* key, int key_length) {
    init_genrand(19650218U);
    int i = 1, j = 0;
    int k = (N > key_length ? N : key_length);
    for (; k; k--) {
      mt[i] = (mt[i] ^ ((mt[i - 1] ^ (mt[i - 1] >> 30)) * 1664525U)) + key[j] + j;
      i++; j++;
      if (i >= N) { mt[0] = mt[N - 1]; i = 1; }
      if (j >= key_length) j = 0;
    }
    for (k = N - 1; k; k--) {
      mt[i] = (mt[i] ^ ((mt[i - 1] ^ (mt[i - 1] >> 30)) * 1566083941U)) - i;
      i++;
      if (i >= N) { mt[0] = mt[N - 1]; i = 1; }
    }
    mt[0] = 0x80000000U;
  }

  uint32_t next32() {
    uint32_t y;
    static const uint32_t mag01[2] = {0x0U, MATRIX_A};
    if (mti >= N) {
      int kk;
      for (kk = 0; kk < N - M; kk++) {
        y = (mt[kk] & UPPER_MASK) | (mt[kk + 1] & LOWER_MASK);
        mt[kk] = mt[kk + M] ^ (y >> 1) ^ mag01[y & 0x1U];
      }
      for (; kk < N - 1; kk++) {
        y = (mt[kk] & UPPER_MASK) | (mt[kk + 1] & LOWER_MASK);
        mt[kk] = mt[kk + (M - N)] ^ (y >> 1) ^ mag01[y & 0x1U];
      }
      y = (mt[N - 1] & UPPER_MASK) | (mt[0] & LOWER_MASK);
      mt[N - 1] = mt[M - 1] ^ (y >> 1) ^ mag01[y & 0x1U];
      mti = 0;
    }
    y = mt[mti++];
    y ^= (y >> 11);
    y ^= (y << 7) & 0x9d2c5680U;
    y ^= (y << 15) & 0xefc60000U;
    y ^= (y >> 18);
    return y;
  }

  // numpy rk_double: 53-bit uniform in [0, 1).
  double next_double() {
    uint32_t a = next32() >> 5;
    uint32_t b = next32() >> 6;
    return (a * 67108864.0 + b) / 9007199254740992.0;
  }

  double uniform(double lo, double hi) { return lo + (hi - lo) * next_double(); }
};

// --- reference constants (config.py mirrors, mcr:43-78) ---
constexpr double SCALE = 6.0;
constexpr double TRACK_RAD = 900.0 / SCALE;
constexpr double TRACK_DETAIL_STEP = 21.0 / SCALE;
constexpr double TRACK_TURN_RATE = 0.31;
constexpr int CHECKPOINTS = 12;
constexpr int BORDER_MIN_COUNT = 4;
constexpr int MAX_POINTS = 2500;
constexpr double TWO_PI = 6.283185307179586476925286766559;

int attempt(MT& rng, double* out_track, uint8_t* out_border) {
  // Checkpoints (mcr:186-198); both uniforms drawn for every checkpoint.
  double cp_alpha[CHECKPOINTS], cp_x[CHECKPOINTS], cp_y[CHECKPOINTS];
  const double start_alpha = TWO_PI * (-0.5) / CHECKPOINTS;
  for (int c = 0; c < CHECKPOINTS; c++) {
    double alpha = TWO_PI * c / CHECKPOINTS + rng.uniform(0.0, TWO_PI / CHECKPOINTS);
    double rad = rng.uniform(TRACK_RAD / 3.0, TRACK_RAD);
    if (c == 0) { alpha = 0.0; rad = 1.5 * TRACK_RAD; }
    if (c == CHECKPOINTS - 1) { alpha = TWO_PI * c / CHECKPOINTS; rad = 1.5 * TRACK_RAD; }
    cp_alpha[c] = alpha;
    cp_x[c] = rad * std::cos(alpha);
    cp_y[c] = rad * std::sin(alpha);
  }

  // Integrator walk (mcr:206-259).
  static thread_local double walk[MAX_POINTS][4];
  double x = 1.5 * TRACK_RAD, y = 0.0, beta = 0.0;
  int dest_i = 0, laps = 0, n = 0;
  bool visited_other_side = false;
  int no_freeze = MAX_POINTS;
  while (true) {
    double alpha = std::atan2(y, x);
    if (visited_other_side && alpha > 0) { laps++; visited_other_side = false; }
    if (alpha < 0) { visited_other_side = true; alpha += TWO_PI; }
    while (true) {
      bool failed = true;
      while (true) {
        double dest_alpha = cp_alpha[dest_i % CHECKPOINTS];
        if (alpha <= dest_alpha) { failed = false; break; }
        dest_i++;
        if (dest_i % CHECKPOINTS == 0) break;
      }
      if (!failed) break;
      alpha -= TWO_PI;
    }
    double dest_x = cp_x[dest_i % CHECKPOINTS];
    double dest_y = cp_y[dest_i % CHECKPOINTS];
    double r1x = std::cos(beta), r1y = std::sin(beta);
    double p1x = -r1y, p1y = r1x;
    double proj = r1x * (dest_x - x) + r1y * (dest_y - y);
    while (beta - alpha > 1.5 * M_PI) beta -= TWO_PI;
    while (beta - alpha < -1.5 * M_PI) beta += TWO_PI;
    double prev_beta = beta;
    proj *= SCALE;
    if (proj > 0.3) beta -= std::min(TRACK_TURN_RATE, std::abs(0.001 * proj));
    if (proj < -0.3) beta += std::min(TRACK_TURN_RATE, std::abs(0.001 * proj));
    x += p1x * TRACK_DETAIL_STEP;
    y += p1y * TRACK_DETAIL_STEP;
    walk[n][0] = alpha;
    walk[n][1] = prev_beta * 0.5 + beta * 0.5;
    walk[n][2] = x;
    walk[n][3] = y;
    n++;
    if (laps > 4) break;
    no_freeze--;
    if (no_freeze == 0) break;
  }

  // Closed-loop extraction (mcr:263-281).
  int i1 = -1, i2 = -1;
  for (int i = n; ;) {
    i--;
    if (i == 0) return -1;
    bool pass = walk[i][0] > start_alpha && walk[i - 1][0] <= start_alpha;
    if (pass && i2 == -1) i2 = i;
    else if (pass && i1 == -1) { i1 = i; break; }
  }
  int T = i2 - 1 - i1;
  if (T <= 0) return -1;

  // Glue check (mcr:283-291).
  double first_beta = walk[i1][1];
  double fpx = std::cos(first_beta), fpy = std::sin(first_beta);
  double dxg = fpx * (walk[i1][2] - walk[i1 + T - 1][2]);
  double dyg = fpy * (walk[i1][3] - walk[i1 + T - 1][3]);
  if (std::sqrt(dxg * dxg + dyg * dyg) > TRACK_DETAIL_STEP) return -1;

  // Copy slice; curb marking with the reference's smear quirk (mcr:294-307).
  for (int i = 0; i < T; i++) {
    for (int k = 0; k < 4; k++) out_track[i * 4 + k] = walk[i1 + i][k];
  }
  auto betaAt = [&](int i) {
    int m = i % T;
    if (m < 0) m += T;
    return out_track[m * 4 + 1];
  };
  static thread_local uint8_t border[MAX_POINTS];
  for (int i = 0; i < T; i++) {
    bool good = true;
    double oneside = 0.0;
    for (int neg = 0; neg < BORDER_MIN_COUNT; neg++) {
      double b1 = betaAt(i - neg);
      double b2 = betaAt(i - neg - 1);
      good = good && std::abs(b1 - b2) > TRACK_TURN_RATE * 0.2;
      double d = b1 - b2;
      oneside += (d > 0) - (d < 0);
    }
    good = good && std::abs(oneside) == BORDER_MIN_COUNT;
    border[i] = good;
  }
  for (int i = 0; i < T; i++) {
    for (int neg = 0; neg < BORDER_MIN_COUNT; neg++) {
      int j = i - neg;
      if (j < 0) j += T;  // Python negative-index wrap
      border[j] |= border[i];
    }
  }
  std::memcpy(out_border, border, T);
  return T;
}

}  // namespace

extern "C" {

void mcr_seed(const uint32_t* key, int key_len, uint32_t* state, int* pos) {
  MT rng;
  rng.init_by_array(key, key_len);
  std::memcpy(state, rng.mt, sizeof(rng.mt));
  *pos = rng.mti;
}

int mcr_generate_track(uint32_t* state, int* pos, int max_retries,
                       double* out_track, uint8_t* out_border,
                       int* out_retries) {
  MT rng;
  std::memcpy(rng.mt, state, sizeof(rng.mt));
  rng.mti = *pos;
  int T = -1;
  int r = 0;
  for (; r < max_retries; r++) {
    T = attempt(rng, out_track, out_border);
    if (T > 0) break;
  }
  std::memcpy(state, rng.mt, sizeof(rng.mt));
  *pos = rng.mti;
  *out_retries = r;
  return T;
}

}  // extern "C"
