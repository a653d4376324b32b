// Linearisation of the mapping's two-pose scan-to-map problem for NVIDIA
// Hopper (sm_90a): H = JᵀJ [12, 12], g = Jᵀr [12] and the robust cost
// 0.5·Σρ at the LM's tangent x, or the cost alone at a trial x.
//
// Replaces no TPU kernel.  The JAX package (and the port's autodiff route,
// models/mapping.py) forms J by forward-mode AD over 12 tangent directions
// (jax.jacfwd; torch.func vmap of jvp), which on the card dispatches some
// 5,000 small kernels an LM iteration over ~7,200 residual rows.  This
// kernel evaluates the same function in one pass over the query points.
//
// The function (models/mapping.py, the names there):
// - the tangent x [12] moves the current pose by x[0:6] and the last
//   frame's by x[6:12], as _unpack does: q' = normalize(quat_exp(x[0:3]) ⊗ q),
//   t' = t + x[3:6];
// - _lidar_residuals: edge rows (3 a corner point) cross(lp - pa, lp - pb) /
//   max(|pa - pb|, 1e-9) · w and plane rows (1 a surf point) (n·pw + d) · w,
//   each point's block times _huber_weight of its squared norm (held
//   constant for "huber", differentiated for "l1");
// - _other_residuals: the 13 NULL-loss rows (IMU relative rotation 3, pitch
//   and roll of both poses 2 + 2, the goable ground factor of both poses
//   3 + 3), times w_imu or w_ground and rep_scale;
// - _map_cost: 0.5·(Σ huber_rho (or the l1 form) of the lidar blocks'
//   squared norms + Σ of the NULL-loss rows squared).
//
// Derivatives come from Jets (a value and N tangent components carried
// through every operation, forward-mode AD in registers, the chain rule
// jvp runs; Ceres differentiates the C++ reference's templated
// lidarFactor.hpp functors the same way).  The residuals are written once,
// templated on the scalar (float for the trial cost, Jet<6> for a lidar
// point, Jet<1> in the NULL-loss warp), following utils/math3d's formulas
// and branches: quat_exp's small-angle branch, quat_to_ypr's clamp, the
// clamp and abs derivatives torch takes.
//
// What bounds it.  An evaluation reads the four query clouds and their
// correspondences (5,120 points at the benchmark's capacities, 40-52 bytes
// each, ~0.2 MB: 0.06 us at 3.35 TB/s) and does ~1-2 kFLOP a point in
// float32 (~10 MFLOP, 0.15 us at 67 TFLOP/s).  Neither binds: the work is
// a few microseconds of latency, two launches and a serial chain of
// Jet operations a thread, so the design keeps everything in registers
// and the launch count at two.
//
// Design.
// - map_lm_points: one thread a query point, blocks of kBlock threads, each
//   block within one cloud (corner, last corner, surf, last surf, in that
//   order).  A thread sums its point's 21 upper JᵀJ entries, 6 Jᵀr entries
//   and ρ (6x6: a lidar row moves only its own pose), a fixed shuffle tree
//   and a fixed sum over the block's warps give the block's partial.
// - map_lm_finish (one block): sums the partials of each pose's blocks in
//   block order, while one warp evaluates the 13 NULL-loss rows, lane l
//   carrying the tangent direction l (Jet<1>), and forms their 12x12 JᵀJ by
//   shuffles; it writes H, g and the cost.  No float atomics: a launch
//   repeats bit for bit, and a replayed graph gives the eager launch's bits.
// - Lanes: a launch evaluates a batch of independent problems of the same
//   sizes (the fleet's robots under vmap, ops/cuda/map_lm's vmap rule), the
//   lane in blockIdx.y of map_lm_points and blockIdx.x of the finish; every
//   operand is [lanes, ...] and contiguous.  One problem is one lane.
// - float32 throughout (FMA contraction allowed, no fast math).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBlock = 64;
constexpr int kWarps = kBlock / 32;
constexpr int kH = 21;                 // upper triangle of a 6x6 block
constexpr int kPart = kH + 6 + 1;      // JᵀJ, Jᵀr, ρ
constexpr int kFinishThreads = 128;
constexpr int kParams = 73;            // the packed constants a lane
constexpr int kOut = 144 + 12 + 1;     // H, g, cost a lane
constexpr int kOtherRows = 13;
constexpr unsigned kFull = 0xffffffffu;

// the packed constants (ops/cuda/map_lm.py, PARAMS)
constexpr int P_Q = 0, P_T = 4, P_QL = 7, P_TL = 11, P_DQ = 14, P_IMU_COV = 18, P_W_IMU = 19,
              P_REP = 20, P_YPR = 21, P_YPR_L = 24, P_G_LAST = 27, P_G_CUR = 37,
              P_G_LAST2 = 47, P_Q_L2 = 57, P_T_L2 = 61, P_QF = 64, P_QF2 = 68, P_W_GROUND = 72;
// a ground plane's fields from its offset: normal 3, v1 3, v2 3, distance 1
constexpr int G_N = 0, G_V1 = 3, G_V2 = 6, G_D = 9;

#define HD __host__ __device__ __forceinline__

// ---- Jets ----

template <int N>
struct Jet {
  float v;
  float d[N];
};

template <typename T>
struct Lift;
template <>
struct Lift<float> {
  static HD float c(float x) { return x; }
};
template <int N>
struct Lift<Jet<N>> {
  static HD Jet<N> c(float x) {
    Jet<N> r;
    r.v = x;
    for (int i = 0; i < N; ++i) r.d[i] = 0.f;
    return r;
  }
};

HD float val(float x) { return x; }
template <int N>
HD float val(const Jet<N>& a) { return a.v; }

template <int N>
HD Jet<N> operator+(const Jet<N>& a, const Jet<N>& b) {
  Jet<N> r;
  r.v = a.v + b.v;
  for (int i = 0; i < N; ++i) r.d[i] = a.d[i] + b.d[i];
  return r;
}
template <int N>
HD Jet<N> operator-(const Jet<N>& a, const Jet<N>& b) {
  Jet<N> r;
  r.v = a.v - b.v;
  for (int i = 0; i < N; ++i) r.d[i] = a.d[i] - b.d[i];
  return r;
}
template <int N>
HD Jet<N> operator-(const Jet<N>& a) {
  Jet<N> r;
  r.v = -a.v;
  for (int i = 0; i < N; ++i) r.d[i] = -a.d[i];
  return r;
}
template <int N>
HD Jet<N> operator*(const Jet<N>& a, const Jet<N>& b) {
  Jet<N> r;
  r.v = a.v * b.v;
  for (int i = 0; i < N; ++i) r.d[i] = a.d[i] * b.v + a.v * b.d[i];
  return r;
}
template <int N>
HD Jet<N> operator/(const Jet<N>& a, const Jet<N>& b) {
  Jet<N> r;
  r.v = a.v / b.v;
  for (int i = 0; i < N; ++i) r.d[i] = (a.d[i] - r.v * b.d[i]) / b.v;
  return r;
}
template <int N>
HD Jet<N> operator+(const Jet<N>& a, float b) {
  Jet<N> r = a;
  r.v = a.v + b;
  return r;
}
template <int N>
HD Jet<N> operator+(float a, const Jet<N>& b) {
  Jet<N> r = b;
  r.v = a + b.v;
  return r;
}
template <int N>
HD Jet<N> operator-(const Jet<N>& a, float b) {
  Jet<N> r = a;
  r.v = a.v - b;
  return r;
}
template <int N>
HD Jet<N> operator-(float a, const Jet<N>& b) {
  Jet<N> r;
  r.v = a - b.v;
  for (int i = 0; i < N; ++i) r.d[i] = -b.d[i];
  return r;
}
template <int N>
HD Jet<N> operator*(const Jet<N>& a, float b) {
  Jet<N> r;
  r.v = a.v * b;
  for (int i = 0; i < N; ++i) r.d[i] = a.d[i] * b;
  return r;
}
template <int N>
HD Jet<N> operator*(float a, const Jet<N>& b) {
  return b * a;
}
template <int N>
HD Jet<N> operator/(const Jet<N>& a, float b) {
  Jet<N> r;
  r.v = a.v / b;
  for (int i = 0; i < N; ++i) r.d[i] = a.d[i] / b;
  return r;
}
template <int N>
HD Jet<N> operator/(float a, const Jet<N>& b) {
  Jet<N> r;
  r.v = a / b.v;
  for (int i = 0; i < N; ++i) r.d[i] = -r.v * b.d[i] / b.v;
  return r;
}

HD float jsqrt(float a) { return sqrtf(a); }
template <int N>
HD Jet<N> jsqrt(const Jet<N>& a) {
  Jet<N> r;
  r.v = sqrtf(a.v);
  for (int i = 0; i < N; ++i) r.d[i] = a.d[i] / (2.f * r.v);
  return r;
}
HD float jsin(float a) { return sinf(a); }
template <int N>
HD Jet<N> jsin(const Jet<N>& a) {
  Jet<N> r;
  r.v = sinf(a.v);
  const float c = cosf(a.v);
  for (int i = 0; i < N; ++i) r.d[i] = c * a.d[i];
  return r;
}
HD float jcos(float a) { return cosf(a); }
template <int N>
HD Jet<N> jcos(const Jet<N>& a) {
  Jet<N> r;
  r.v = cosf(a.v);
  const float s = -sinf(a.v);
  for (int i = 0; i < N; ++i) r.d[i] = s * a.d[i];
  return r;
}
HD float jatan2(float y, float x) { return atan2f(y, x); }
template <int N>
HD Jet<N> jatan2(const Jet<N>& y, const Jet<N>& x) {
  Jet<N> r;
  r.v = atan2f(y.v, x.v);
  const float den = x.v * x.v + y.v * y.v;
  for (int i = 0; i < N; ++i) r.d[i] = (x.v * y.d[i] - y.v * x.d[i]) / den;
  return r;
}
HD float jasin(float a) { return asinf(a); }
template <int N>
HD Jet<N> jasin(const Jet<N>& a) {
  Jet<N> r;
  r.v = asinf(a.v);
  const float s = sqrtf(1.f - a.v * a.v);
  for (int i = 0; i < N; ++i) r.d[i] = a.d[i] / s;
  return r;
}
HD float jabs(float a) { return fabsf(a); }
template <int N>
HD Jet<N> jabs(const Jet<N>& a) {   // torch's abs: sgn(x)·t, sgn(0) = 0
  const float s = a.v > 0.f ? 1.f : (a.v < 0.f ? -1.f : 0.f);
  Jet<N> r;
  r.v = fabsf(a.v);
  for (int i = 0; i < N; ++i) r.d[i] = s * a.d[i];
  return r;
}
// torch.clamp(x, min=lo): the tangent passes where x >= lo
template <typename T>
HD T clamp_min(const T& x, float lo) {
  return val(x) >= lo ? x : Lift<T>::c(lo);
}
// torch.clamp(x, lo, hi): the tangent passes where lo <= x <= hi
template <typename T>
HD T clamp(const T& x, float lo, float hi) {
  return val(x) < lo ? Lift<T>::c(lo) : (val(x) > hi ? Lift<T>::c(hi) : x);
}

// ---- vectors and quaternions [w, x, y, z] (utils/math3d) ----

template <typename T>
struct V3 {
  T x, y, z;
};
template <typename T>
struct Q4 {
  T w, x, y, z;
};

HD V3<float> load3(const float* p) { return {p[0], p[1], p[2]}; }
HD Q4<float> load4(const float* p) { return {p[0], p[1], p[2], p[3]}; }

template <typename A, typename B>
HD auto operator+(const V3<A>& a, const V3<B>& b) -> V3<decltype(a.x + b.x)> {
  return {a.x + b.x, a.y + b.y, a.z + b.z};
}
template <typename A, typename B>
HD auto operator-(const V3<A>& a, const V3<B>& b) -> V3<decltype(a.x - b.x)> {
  return {a.x - b.x, a.y - b.y, a.z - b.z};
}
template <typename A, typename B>
HD auto cross(const V3<A>& a, const V3<B>& b) -> V3<decltype(a.x * b.x)> {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
template <typename A, typename B>
HD auto dot(const V3<A>& a, const V3<B>& b) -> decltype(a.x * b.x) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}

template <typename T>
HD Q4<T> conj(const Q4<T>& q) {
  return {q.w, -q.x, -q.y, -q.z};
}
template <typename A, typename B>
HD auto quat_mul(const Q4<A>& a, const Q4<B>& b) -> Q4<decltype(a.w * b.w)> {
  return {a.w * b.w - a.x * b.x - a.y * b.y - a.z * b.z,
          a.w * b.x + a.x * b.w + a.y * b.z - a.z * b.y,
          a.w * b.y - a.x * b.z + a.y * b.w + a.z * b.x,
          a.w * b.z + a.x * b.y - a.y * b.x + a.z * b.w};
}
template <typename T>
HD Q4<T> quat_normalize(const Q4<T>& q) {
  const T n = jsqrt(q.w * q.w + q.x * q.x + q.y * q.y + q.z * q.z);
  return {q.w / n, q.x / n, q.y / n, q.z / n};
}
// v + 2 (w (u x v) + u x (u x v))
template <typename A, typename B>
HD auto quat_rotate(const Q4<A>& q, const V3<B>& v) -> V3<decltype(q.w * v.x)> {
  const V3<A> u{q.x, q.y, q.z};
  const auto uv = cross(u, v);
  const auto uuv = cross(u, uv);
  return {v.x + 2.f * (q.w * uv.x + uuv.x), v.y + 2.f * (q.w * uv.y + uuv.y),
          v.z + 2.f * (q.w * uv.z + uuv.z)};
}
template <typename T>
HD Q4<T> quat_exp(const T& w0, const T& w1, const T& w2) {
  const T th2 = w0 * w0 + w1 * w1 + w2 * w2;
  T k, cw;
  if (val(th2) < 1e-10f) {
    k = 0.5f - th2 / 48.f;
    cw = 1.f - th2 / 8.f;
  } else {
    const T th = jsqrt(clamp_min(th2, 1e-24f));
    k = jsin(th / 2.f) / th;
    cw = jcos(th / 2.f);
  }
  return quat_normalize(Q4<T>{cw, k * w0, k * w1, k * w2});
}

// _unpack: the pose moved by the tangent xs [6]
template <typename T>
HD void moved_pose(const T* xs, const float* q0, const float* t0, Q4<T>& q, V3<T>& t) {
  q = quat_normalize(quat_mul(quat_exp(xs[0], xs[1], xs[2]), load4(q0)));
  t = V3<T>{t0[0] + xs[3], t0[1] + xs[4], t0[2] + xs[5]};
}

// ---- the NULL-loss rows (models/mapping._other_residuals) ----

// 2 (pitch - p, roll - r) / var (quat_to_ypr's formulas)
template <typename T>
HD void pitchroll(const Q4<T>& q, float pitch_meas, float roll_meas, float var, float wgt,
                  T* out) {
  const T roll = jatan2(2.f * (q.w * q.x + q.y * q.z), 1.f - 2.f * (q.x * q.x + q.y * q.y));
  const T pitch = jasin(clamp(2.f * (q.w * q.y - q.x * q.z), -1.f, 1.f));
  out[0] = 2.f * (pitch - pitch_meas) / var * wgt;
  out[1] = 2.f * (roll - roll_meas) / var * wgt;
}

// factors.ground_goable_residual with _ground_rows at var 0.2: the rows
// divide by var / 1000 and var * 10
template <typename T>
HD void ground_goable(const Q4<T>& q, const V3<T>& t, const Q4<float>& q_last,
                      const V3<float>& t_last, const float* g_last, const float* g_cur,
                      const Q4<float>& q_hist, float wgt, T* out) {
  const Q4<float> qi = conj(q_last);
  const Q4<T> q_lc = quat_mul(qi, q);
  const V3<T> t_lc = quat_rotate(qi, t - t_last);
  const V3<T> norm_cur = quat_rotate(q_lc, load3(g_cur + G_N));
  const V3<T> delta_t = quat_rotate(q_hist, t_lc);
  const T dist_cur = g_cur[G_D] + delta_t.z;
  out[0] = (g_last[G_D] - dist_cur) / 0.0002f * wgt;
  out[1] = jabs(dot(load3(g_last + G_V1), norm_cur)) / 2.f * wgt;
  out[2] = jabs(dot(load3(g_last + G_V2), norm_cur)) / 2.f * wgt;
}

template <typename T>
HD void other_rows(const T* x, const float* p, T* r) {
  Q4<T> qc, qlc;
  V3<T> tc, tlc;
  moved_pose(x, p + P_Q, p + P_T, qc, tc);
  moved_pose(x + 6, p + P_QL, p + P_TL, qlc, tlc);
  const float w_imu = p[P_W_IMU] * p[P_REP], w_ground = p[P_W_GROUND] * p[P_REP];
  // relative_r_residual(qlc, qc, dq, imu_cov)
  const Q4<T> err = quat_mul(conj(load4(p + P_DQ)), quat_mul(conj(qlc), qc));
  r[0] = 2.f * err.x / p[P_IMU_COV] * w_imu;
  r[1] = 2.f * err.y / p[P_IMU_COV] * w_imu;
  r[2] = 2.f * err.z / p[P_IMU_COV] * w_imu;
  pitchroll(qc, p[P_YPR + 1], p[P_YPR + 2], 0.02f, w_imu, r + 3);
  pitchroll(qlc, p[P_YPR_L + 1], p[P_YPR_L + 2], 0.02f, w_imu, r + 5);
  ground_goable(qc, tc, load4(p + P_QL), load3(p + P_TL), p + P_G_LAST, p + P_G_CUR,
                load4(p + P_QF), w_ground, r + 7);
  ground_goable(qlc, tlc, load4(p + P_Q_L2), load3(p + P_T_L2), p + P_G_LAST2, p + P_G_LAST,
                load4(p + P_QF2), w_ground, r + 10);
}

// ---- the lidar rows (models/mapping._edge_r, _plane_r, _huber_weight) ----

// sqrt of Ceres HuberLoss(0.1)'s rho'(s)
template <typename T>
HD T huber_weight(const T& s) {
  const T r = jsqrt(clamp_min(s, 1e-12f));
  return jsqrt(val(r) <= 0.1f ? Lift<T>::c(1.f) : 0.1f / r);
}

// HuberLoss(0.1)'s rho, or the l1 objective (_map_cost)
template <bool L1>
HD float rho(float s) {
  if (s <= 0.01f) return s;
  const float root = sqrtf(fmaxf(s, 1e-30f));
  return L1 ? 0.1f * root : 0.2f * root - 0.01f;
}

struct Cloud {
  const float* pts;   // [n, 3]
  const float* a;     // edge: pa [n, 3]; plane: unit normal [n, 3]
  const float* b;     // edge: pb [n, 3]; plane: offset [n]
  const float* w;     // [n] confidence, 0 where the correspondence failed
  int n;
  int first_block;
};

// the NR rows of point i of cloud c at the moved pose (q, t): an edge's 3
// or a plane's 1
template <int NR, typename T>
HD void lidar_rows(const Cloud& c, int i, const Q4<T>& q, const V3<T>& t, T* r) {
  const V3<T> lp = quat_rotate(q, load3(c.pts + 3 * i)) + t;
  const float w = c.w[i];
  if constexpr (NR == 3) {
    const V3<float> pa = load3(c.a + 3 * i), pb = load3(c.b + 3 * i);
    const V3<float> ab = pa - pb;
    const float de = fmaxf(sqrtf(ab.x * ab.x + ab.y * ab.y + ab.z * ab.z), 1e-9f);
    const V3<T> nu = cross(lp - pa, lp - pb);
    r[0] = nu.x / de * w;
    r[1] = nu.y / de * w;
    r[2] = nu.z / de * w;
  } else {
    r[0] = (dot(lp, load3(c.a + 3 * i)) + c.b[i]) * w;
  }
}

// point i's terms added into acc: with DERIV its 21 upper JᵀJ entries, 6
// Jᵀr entries and ρ (acc [kPart]), else ρ alone (acc [1]); xg [6] is the
// tangent of the point's pose
template <int NR, bool DERIV, bool L1>
__device__ __forceinline__ void point_terms(const Cloud& c, int i, const float* xg,
                                            const float* q0, const float* t0, float* acc) {
  if constexpr (DERIV) {
    using J = Jet<6>;
    J xs[6];
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      xs[j] = Lift<J>::c(xg[j]);
      xs[j].d[j] = 1.f;
    }
    Q4<J> q;
    V3<J> t;
    moved_pose(xs, q0, t0, q, t);
    J r[NR];
    lidar_rows<NR>(c, i, q, t, r);
    J s = r[0] * r[0];
#pragma unroll
    for (int k = 1; k < NR; ++k) s = s + r[k] * r[k];
    J hw;
    if constexpr (L1) {
      hw = huber_weight(s);
    } else {
      hw = Lift<J>::c(huber_weight(s.v));
    }
#pragma unroll
    for (int k = 0; k < NR; ++k) {
      const J rt = r[k] * hw;
      int h = 0;
#pragma unroll
      for (int a = 0; a < 6; ++a) {
#pragma unroll
        for (int b = a; b < 6; ++b) acc[h++] += rt.d[a] * rt.d[b];
      }
#pragma unroll
      for (int a = 0; a < 6; ++a) acc[kH + a] += rt.d[a] * rt.v;
    }
    acc[kPart - 1] = rho<L1>(s.v);
  } else {
    Q4<float> q;
    V3<float> t;
    moved_pose(xg, q0, t0, q, t);
    float r[NR];
    lidar_rows<NR>(c, i, q, t, r);
    float s = r[0] * r[0];
#pragma unroll
    for (int k = 1; k < NR; ++k) s = s + r[k] * r[k];
    acc[0] = rho<L1>(s);
  }
}

struct Problem {
  Cloud cloud[4];        // corner, last corner, surf, last surf: lane 0's operands
  const float* x;        // [lanes, 12]
  const float* params;   // [lanes, kParams]
  float* partials;       // [lanes, blocks, kPart] (derivatives) or [lanes, blocks]
  int blocks;            // a lane's
};

// cloud ci's operands in lane `lane`: [n, 3] / [n] slices of [lanes, n, ...]
HD Cloud lane_cloud(const Cloud& c, int ci, int lane) {
  const long n = c.n, o3 = 3L * n * lane, o1 = n * lane;
  return Cloud{c.pts + o3, c.a + o3, c.b + (ci < 2 ? o3 : o1), c.w + o1, c.n, c.first_block};
}

template <int NV>
__device__ __forceinline__ void block_sum(const float* acc, float* partial) {
  __shared__ float warp_sums[kWarps][NV];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    float v = acc[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(kFull, v, off);
    if (lane == 0) warp_sums[warp][k] = v;
  }
  __syncthreads();
  if (threadIdx.x < NV) {
    float v = warp_sums[0][threadIdx.x];
    for (int w = 1; w < kWarps; ++w) v += warp_sums[w][threadIdx.x];
    partial[threadIdx.x] = v;
  }
}

template <bool DERIV, bool L1>
__global__ void __launch_bounds__(kBlock) map_lm_points(Problem p) {
  int ci = 3;
  while (ci > 0 && static_cast<int>(blockIdx.x) < p.cloud[ci].first_block) --ci;
  const int lane = blockIdx.y;
  const Cloud c = lane_cloud(p.cloud[ci], ci, lane);
  const int grp = ci & 1;   // 0: the current pose, 1: the last frame's
  const int i = (static_cast<int>(blockIdx.x) - c.first_block) * kBlock + threadIdx.x;
  const float* params = p.params + kParams * lane;
  const float* q0 = params + (grp ? P_QL : P_Q);
  const float* t0 = params + (grp ? P_TL : P_T);
  constexpr int NV = DERIV ? kPart : 1;
  float acc[NV];
#pragma unroll
  for (int k = 0; k < NV; ++k) acc[k] = 0.f;
  if (i < c.n) {
    float xg[6];
#pragma unroll
    for (int j = 0; j < 6; ++j) xg[j] = p.x[12 * lane + 6 * grp + j];
    if (ci < 2) {
      point_terms<3, DERIV, L1>(c, i, xg, q0, t0, acc);
    } else {
      point_terms<1, DERIV, L1>(c, i, xg, q0, t0, acc);
    }
  }
  block_sum<NV>(acc, p.partials + (static_cast<long>(lane) * p.blocks + blockIdx.x) * NV);
}

// the sum of column k of a lane's partials over the blocks of the clouds
// whose pose group is grp (-1: all), in block order
__device__ float group_sum(const Problem& p, const float* partials, int nv, int k, int grp) {
  float v = 0.f;
  for (int ci = 0; ci < 4; ++ci) {
    if (grp >= 0 && (ci & 1) != grp) continue;
    const int end = ci < 3 ? p.cloud[ci + 1].first_block : p.blocks;
    for (int b = p.cloud[ci].first_block; b < end; ++b) v += partials[b * nv + k];
  }
  return v;
}

// a lane (blockIdx.x) of H [12, 12], g [12], cost: out[0:144], out[144:156],
// out[156] of the lane's kOut
__global__ void __launch_bounds__(kFinishThreads) map_lm_finish(Problem p, float* out) {
  __shared__ float lidar[2][kPart];
  __shared__ float h_other[12][12];
  __shared__ float g_other[12];
  __shared__ float cost_other;
  const int tid = threadIdx.x, ln = blockIdx.x;
  const float* partials = p.partials + static_cast<long>(ln) * p.blocks * kPart;
  const float* x = p.x + 12 * ln;
  const float* params = p.params + kParams * ln;
  out += kOut * ln;
  if (tid < 2 * kPart) {
    lidar[tid / kPart][tid % kPart] = group_sum(p, partials, kPart, tid % kPart, tid / kPart);
  } else if (tid >= 64 && tid < 96) {
    // lane l carries the tangent direction l (none for l >= 12)
    const int lane = tid - 64;
    using J = Jet<1>;
    J xs[12];
    for (int j = 0; j < 12; ++j) {
      xs[j] = Lift<J>::c(x[j]);
      xs[j].d[0] = j == lane ? 1.f : 0.f;
    }
    J r[kOtherRows];
    other_rows(xs, params, r);
    for (int m = 0; m < 12; ++m) {
      float h = 0.f;
      for (int k = 0; k < kOtherRows; ++k) h += r[k].d[0] * __shfl_sync(kFull, r[k].d[0], m);
      if (lane < 12) h_other[lane][m] = h;
    }
    float g = 0.f, c = 0.f;
    for (int k = 0; k < kOtherRows; ++k) {
      g += r[k].d[0] * r[k].v;
      c += r[k].v * r[k].v;
    }
    if (lane < 12) g_other[lane] = g;
    if (lane == 0) cost_other = c;
  }
  __syncthreads();
  for (int e = tid; e < 144; e += kFinishThreads) {
    const int i = e / 12, j = e % 12;
    float h = h_other[i][j];
    if (i / 6 == j / 6) {
      const int a = min(i % 6, j % 6), b = max(i % 6, j % 6);
      h = lidar[i / 6][a * 6 - a * (a - 1) / 2 + (b - a)] + h;
    }
    out[e] = h;
  }
  if (tid < 12) out[144 + tid] = lidar[tid / 6][kH + tid % 6] + g_other[tid];
  if (tid == 0) out[156] = 0.5f * ((lidar[0][kPart - 1] + lidar[1][kPart - 1]) + cost_other);
}

// a lane's (blockIdx.x) cost alone: out[lane]
__global__ void __launch_bounds__(64) map_lm_finish_cost(Problem p, float* out) {
  __shared__ float part[2];
  __shared__ float cost_other;
  const int ln = blockIdx.x;
  if (threadIdx.x < 2) {
    part[threadIdx.x] = group_sum(p, p.partials + static_cast<long>(ln) * p.blocks, 1, 0,
                                  threadIdx.x);
  } else if (threadIdx.x == 32) {
    float r[kOtherRows];
    other_rows(p.x + 12 * ln, p.params + kParams * ln, r);
    float c = 0.f;
    for (int k = 0; k < kOtherRows; ++k) c += r[k] * r[k];
    cost_other = c;
  }
  __syncthreads();
  if (threadIdx.x == 0) out[ln] = 0.5f * ((part[0] + part[1]) + cost_other);
}

template <bool DERIV, bool L1>
cudaError_t launch(const Problem& p, int lanes, float* out, cudaStream_t stream) {
  if (p.blocks > 0) map_lm_points<DERIV, L1><<<dim3(p.blocks, lanes), kBlock, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if constexpr (DERIV) {
    map_lm_finish<<<lanes, kFinishThreads, 0, stream>>>(p, out);
  } else {
    map_lm_finish_cost<<<lanes, 64, 0, stream>>>(p, out);
  }
  return cudaGetLastError();
}

}  // namespace

// One evaluation of `lanes` problems.  x [lanes, 12] and params [lanes,
// 73] float32 on the device (the packing of ops/cuda/map_lm.py); clouds: 16
// device pointers, per cloud (corner, last corner, surf, last surf) points
// [lanes, n, 3], then pa [lanes, n, 3] and pb [lanes, n, 3] (edges) or the
// normal [lanes, n, 3] and offset [lanes, n] (planes), then the weight
// [lanes, n], all float32 and contiguous; sizes: the 4 n.  partials holds
// lanes x sum(ceil(n / 64)) x 28 floats (x 1 for the cost alone).  With
// derivatives, out [lanes, 157] receives H (row-major), g and the cost;
// without, out [lanes] the cost.  Launches on `stream` and returns
// cudaGetLastError() (cudaErrorInvalidValue for a negative size or a lane
// count outside 1..65535).
extern "C" int rgc_map_lm_launch(const void* x, const void* params, const void* const* clouds,
                                 const int* sizes, int lanes, int l1, int derivatives,
                                 void* partials, void* out, void* stream) {
  if (lanes < 1 || lanes > 65535) return cudaErrorInvalidValue;
  Problem p;
  int blocks = 0;
  for (int c = 0; c < 4; ++c) {
    if (sizes[c] < 0) return cudaErrorInvalidValue;
    p.cloud[c] = Cloud{static_cast<const float*>(clouds[4 * c]),
                       static_cast<const float*>(clouds[4 * c + 1]),
                       static_cast<const float*>(clouds[4 * c + 2]),
                       static_cast<const float*>(clouds[4 * c + 3]), sizes[c], blocks};
    blocks += (sizes[c] + kBlock - 1) / kBlock;
  }
  p.x = static_cast<const float*>(x);
  p.params = static_cast<const float*>(params);
  p.partials = static_cast<float*>(partials);
  p.blocks = blocks;
  float* o = static_cast<float*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (derivatives) {
    return l1 ? launch<true, true>(p, lanes, o, s) : launch<true, false>(p, lanes, o, s);
  }
  return l1 ? launch<false, true>(p, lanes, o, s) : launch<false, false>(p, lanes, o, s);
}
