// Second-order forward-mode numbers for the sweep kernels.
//
// A Dual2<T, NZ> carries a value v, the NZ first-order tangents d[i] =
// dv/dz_i and the packed upper triangle of the second-order tangents
// h[p(i, j)] = d2v/dz_i dz_j, i <= j, p running row by row.  Instantiating
// a generated model function with Dual2 arguments carries, in one pass,
// what the TPU kernels (mpc_code_tpu/ops/sweep_pallas.py::
// rk4_quad_stage_hess_pallas, mpc_code_tpu/solver/sweep_kernel.py::
// make_stage_sweep) compute with nested jax.jvp or jax.hessian.
//
// Dual2<T, NZ, H0, HN> keeps only the entries p in [H0, H0 + HN) of the
// triangle, in h[p - H0], with the value and every first-order tangent: the
// second-order rules of every operation below need, for entry p(i, j), only
// entry p of the operands and their values and first-order tangents, so
// threads holding disjoint slices of one lane's triangle compute the same
// lane without exchanging anything.
//
// A quotient forms one reciprocal of the denominator and multiplies every
// component by it.
//
// max/min/where blend the two arguments' tangents with the weights of the
// first-order rule (JAX's half-and-half at an exact tie, dual.cuh); the
// weights are piecewise constant, so their own derivative is 0, as nested
// jvp of jnp.maximum gives.
#pragma once

#include <cmath>

#include "dual.cuh"

template <class T, int NZ, int H0 = 0, int HN = NZ * (NZ + 1) / 2>
struct Dual2 {
  static constexpr int NT = NZ;                   // first-order tangents
  static constexpr int NP = NZ * (NZ + 1) / 2;   // the whole triangle
  static constexpr int NH = HN;                   // the entries kept
  static_assert(H0 >= 0 && HN >= 1 && H0 + HN <= NP, "slice outside the triangle");
  T v;
  T d[NZ];
  T h[HN];
  __device__ __forceinline__ Dual2() {}
  __device__ __forceinline__ Dual2(T value) : v(value) {
#pragma unroll
    for (int i = 0; i < NZ; ++i) d[i] = T(0);
#pragma unroll
    for (int p = 0; p < HN; ++p) h[p] = T(0);
  }
};

// Loop over the slice's triangle entries: body(q, i, j) for the kept entry
// q = p(i, j) - H0.  The loops unroll completely, so the test on p is
// resolved at compile time.
#define MPC_TRI_FOR(NZ_, H0_, HN_, body)                            \
  {                                                                 \
    int p_ = 0;                                                     \
    _Pragma("unroll") for (int i = 0; i < NZ_; ++i) {               \
      _Pragma("unroll") for (int j = i; j < NZ_; ++j, ++p_) {       \
        if (p_ >= H0_ && p_ < H0_ + HN_) {                          \
          const int q = p_ - H0_;                                   \
          body;                                                     \
        }                                                           \
      }                                                             \
    }                                                               \
  }

#define MPC_D2 template <class T, int NZ, int H0, int HN>
#define MPC_V2 Dual2<T, NZ, H0, HN>

MPC_D2 __device__ __forceinline__ T mpc_val(const MPC_V2& a) { return a.v; }

// ----- linear combinations -------------------------------------------------
// r = wa * a + wb * b on every component (value excluded): the tangent rule
// of +, - and of a select.
MPC_D2 __device__ __forceinline__ void mpc_lin2(MPC_V2& r, T wa, const MPC_V2& a,
                                                T wb, const MPC_V2& b) {
#pragma unroll
  for (int i = 0; i < NZ; ++i) r.d[i] = wa * a.d[i] + wb * b.d[i];
#pragma unroll
  for (int p = 0; p < HN; ++p) r.h[p] = wa * a.h[p] + wb * b.h[p];
}

MPC_D2 __device__ __forceinline__ MPC_V2 operator+(const MPC_V2& a, const MPC_V2& b) {
  MPC_V2 r; r.v = a.v + b.v;
#pragma unroll
  for (int i = 0; i < NZ; ++i) r.d[i] = a.d[i] + b.d[i];
#pragma unroll
  for (int p = 0; p < HN; ++p) r.h[p] = a.h[p] + b.h[p];
  return r;
}
MPC_D2 __device__ __forceinline__ MPC_V2 operator+(const MPC_V2& a, T b) {
  MPC_V2 r = a; r.v = a.v + b; return r;
}
MPC_D2 __device__ __forceinline__ MPC_V2 operator+(T a, const MPC_V2& b) {
  MPC_V2 r = b; r.v = a + b.v; return r;
}
MPC_D2 __device__ __forceinline__ MPC_V2 operator-(const MPC_V2& a) {
  MPC_V2 r; r.v = -a.v;
#pragma unroll
  for (int i = 0; i < NZ; ++i) r.d[i] = -a.d[i];
#pragma unroll
  for (int p = 0; p < HN; ++p) r.h[p] = -a.h[p];
  return r;
}
MPC_D2 __device__ __forceinline__ MPC_V2 operator-(const MPC_V2& a, const MPC_V2& b) {
  MPC_V2 r; r.v = a.v - b.v;
#pragma unroll
  for (int i = 0; i < NZ; ++i) r.d[i] = a.d[i] - b.d[i];
#pragma unroll
  for (int p = 0; p < HN; ++p) r.h[p] = a.h[p] - b.h[p];
  return r;
}
MPC_D2 __device__ __forceinline__ MPC_V2 operator-(const MPC_V2& a, T b) {
  MPC_V2 r = a; r.v = a.v - b; return r;
}
MPC_D2 __device__ __forceinline__ MPC_V2 operator-(T a, const MPC_V2& b) {
  MPC_V2 r = -b; r.v = a - b.v; return r;
}

// ----- products and quotients -------------------------------------------
MPC_D2 __device__ __forceinline__ MPC_V2 operator*(const MPC_V2& a, const MPC_V2& b) {
  MPC_V2 r; r.v = a.v * b.v;
#pragma unroll
  for (int i = 0; i < NZ; ++i) r.d[i] = a.d[i] * b.v + a.v * b.d[i];
  MPC_TRI_FOR(NZ, H0, HN,
              r.h[q] = a.h[q] * b.v + a.v * b.h[q] + a.d[i] * b.d[j] + a.d[j] * b.d[i]);
  return r;
}
MPC_D2 __device__ __forceinline__ MPC_V2 operator*(const MPC_V2& a, T b) {
  MPC_V2 r; r.v = a.v * b;
#pragma unroll
  for (int i = 0; i < NZ; ++i) r.d[i] = a.d[i] * b;
#pragma unroll
  for (int p = 0; p < HN; ++p) r.h[p] = a.h[p] * b;
  return r;
}
MPC_D2 __device__ __forceinline__ MPC_V2 operator*(T a, const MPC_V2& b) {
  MPC_V2 r; r.v = a * b.v;
#pragma unroll
  for (int i = 0; i < NZ; ++i) r.d[i] = a * b.d[i];
#pragma unroll
  for (int p = 0; p < HN; ++p) r.h[p] = a * b.h[p];
  return r;
}
// c = a / b with w = 1 / b:  c = a w,  c' = (a' - c b') w,
// c'' = (a'' - c b'' - c'_i b'_j - c'_j b'_i) w
MPC_D2 __device__ __forceinline__ MPC_V2 operator/(const MPC_V2& a, const MPC_V2& b) {
  const T w = T(1) / b.v;
  MPC_V2 r; r.v = a.v * w;
#pragma unroll
  for (int i = 0; i < NZ; ++i) r.d[i] = (a.d[i] - r.v * b.d[i]) * w;
  MPC_TRI_FOR(NZ, H0, HN,
              r.h[q] = (a.h[q] - r.v * b.h[q] - r.d[i] * b.d[j] - r.d[j] * b.d[i]) * w);
  return r;
}
MPC_D2 __device__ __forceinline__ MPC_V2 operator/(const MPC_V2& a, T b) {
  return a * (T(1) / b);
}
MPC_D2 __device__ __forceinline__ MPC_V2 operator/(T a, const MPC_V2& b) {
  const T w = T(1) / b.v;
  MPC_V2 r; r.v = a * w;
#pragma unroll
  for (int i = 0; i < NZ; ++i) r.d[i] = -r.v * b.d[i] * w;
  MPC_TRI_FOR(NZ, H0, HN,
              r.h[q] = (-r.v * b.h[q] - r.d[i] * b.d[j] - r.d[j] * b.d[i]) * w);
  return r;
}

// ----- elementary functions: c = f(a) with f0, f1 = f', f2 = f'' ----------
MPC_D2 __device__ __forceinline__ MPC_V2 mpc_chain2(const MPC_V2& a, T f0, T f1, T f2) {
  MPC_V2 r; r.v = f0;
#pragma unroll
  for (int i = 0; i < NZ; ++i) r.d[i] = f1 * a.d[i];
  MPC_TRI_FOR(NZ, H0, HN, r.h[q] = f1 * a.h[q] + f2 * a.d[i] * a.d[j]);
  return r;
}
MPC_D2 __device__ __forceinline__ MPC_V2 mpc_exp(const MPC_V2& a) {
  const T e = mpc_exp(a.v);
  return mpc_chain2(a, e, e, e);
}
MPC_D2 __device__ __forceinline__ MPC_V2 mpc_log(const MPC_V2& a) {
  const T inv = T(1) / a.v;
  return mpc_chain2(a, mpc_log(a.v), inv, -inv * inv);
}
MPC_D2 __device__ __forceinline__ MPC_V2 mpc_sqrt(const MPC_V2& a) {
  const T s = mpc_sqrt(a.v);
  const T f1 = T(1) / (T(2) * s);
  return mpc_chain2(a, s, f1, -f1 / (T(2) * a.v));
}
// pow by an exponent without tangents: by its value (on numbers whose
// components are Dual, c's own tangent is zero, and pow's rule in the
// exponent, log(a) a^c, is not taken: it is nan for a < 0)
MPC_D2 __device__ __forceinline__ MPC_V2 mpc_pow(const MPC_V2& a, T c) {
  const auto e = mpc_val(c);
  return mpc_chain2(a, T(mpc_pow(a.v, e)), T(e * mpc_pow(a.v, e - 1)),
                    T(e * (e - 1) * mpc_pow(a.v, e - 2)));
}

// the other elementary functions (dual.cuh): f'' by JAX's rules, nested
MPC_D2 __device__ __forceinline__ MPC_V2 mpc_tanh(const MPC_V2& a) {
  const T t = mpc_tanh(a.v);
  const T f1 = T(1) - t * t;
  return mpc_chain2(a, t, f1, T(-2) * t * f1);
}
MPC_D2 __device__ __forceinline__ MPC_V2 mpc_sigmoid(const MPC_V2& a) {
  const T s = mpc_sigmoid(a.v);
  const T f1 = s * (T(1) - s);
  return mpc_chain2(a, s, f1, f1 * (T(1) - T(2) * s));
}
MPC_D2 __device__ __forceinline__ MPC_V2 mpc_sin(const MPC_V2& a) {
  const T s = mpc_sin(a.v);
  return mpc_chain2(a, s, mpc_cos(a.v), -s);
}
MPC_D2 __device__ __forceinline__ MPC_V2 mpc_cos(const MPC_V2& a) {
  const T c = mpc_cos(a.v);
  return mpc_chain2(a, c, -mpc_sin(a.v), -c);
}
MPC_D2 __device__ __forceinline__ MPC_V2 mpc_tan(const MPC_V2& a) {
  const T t = mpc_tan(a.v);
  const T f1 = T(1) + t * t;
  return mpc_chain2(a, t, f1, T(2) * t * f1);
}
// asin: f' = (1 - a^2)^-1/2, f'' = a f'^3; acos: f' = -(1 - a^2)^-1/2, f'' = a f'^3
MPC_D2 __device__ __forceinline__ MPC_V2 mpc_asin(const MPC_V2& a) {
  const T g = mpc_rsqrt(T(1) - a.v * a.v);
  return mpc_chain2(a, mpc_asin(a.v), g, a.v * (g * g * g));
}
MPC_D2 __device__ __forceinline__ MPC_V2 mpc_acos(const MPC_V2& a) {
  const T g = -mpc_rsqrt(T(1) - a.v * a.v);
  return mpc_chain2(a, mpc_acos(a.v), g, a.v * (g * g * g));
}
MPC_D2 __device__ __forceinline__ MPC_V2 mpc_atan(const MPC_V2& a) {
  const T g = T(1) / (T(1) + a.v * a.v);
  return mpc_chain2(a, mpc_atan(a.v), g, T(-2) * a.v * (g * g));
}
MPC_D2 __device__ __forceinline__ MPC_V2 mpc_sinh(const MPC_V2& a) {
  const T s = mpc_sinh(a.v);
  return mpc_chain2(a, s, mpc_cosh(a.v), s);
}
MPC_D2 __device__ __forceinline__ MPC_V2 mpc_cosh(const MPC_V2& a) {
  const T c = mpc_cosh(a.v);
  return mpc_chain2(a, c, mpc_sinh(a.v), c);
}
MPC_D2 __device__ __forceinline__ MPC_V2 mpc_log1p(const MPC_V2& a) {
  const T g = T(1) / (a.v + T(1));
  return mpc_chain2(a, mpc_log1p(a.v), g, -(g * g));
}
MPC_D2 __device__ __forceinline__ MPC_V2 mpc_expm1(const MPC_V2& a) {
  const T e = mpc_expm1(a.v);
  const T f1 = e + T(1);
  return mpc_chain2(a, e, f1, f1);
}
// rsqrt: f' = -f / 2a, f'' = -3 f' / 2a
MPC_D2 __device__ __forceinline__ MPC_V2 mpc_rsqrt(const MPC_V2& a) {
  const T r = mpc_rsqrt(a.v);
  const T f1 = T(-0.5) * (r / a.v);
  return mpc_chain2(a, r, f1, T(-1.5) * (f1 / a.v));
}
MPC_D2 __device__ __forceinline__ MPC_V2 mpc_erf(const MPC_V2& a) {
  const T g = T(1.1283791670955126) * mpc_exp(-(a.v * a.v));
  return mpc_chain2(a, mpc_erf(a.v), g, T(-2) * a.v * g);
}
MPC_D2 __device__ __forceinline__ T mpc_sign(const MPC_V2& a) { return mpc_sign(a.v); }

// ----- functions of two numbers that both carry tangents ----------------
// c = f(a, b) with f0, the partials fa, fb and the second partials faa,
// fab, fbb: c'' = fa a'' + fb b'' + faa a'_i a'_j + fbb b'_i b'_j
// + fab (a'_i b'_j + a'_j b'_i)
MPC_D2 __device__ __forceinline__ MPC_V2 mpc_chain2b(const MPC_V2& a, const MPC_V2& b, T f0,
                                                     T fa, T fb, T faa, T fab, T fbb) {
  MPC_V2 r; r.v = f0;
#pragma unroll
  for (int i = 0; i < NZ; ++i) r.d[i] = fa * a.d[i] + fb * b.d[i];
  MPC_TRI_FOR(NZ, H0, HN,
              r.h[q] = fa * a.h[q] + fb * b.h[q] + faa * (a.d[i] * a.d[j]) +
                       fbb * (b.d[i] * b.d[j]) + fab * (a.d[i] * b.d[j] + a.d[j] * b.d[i]));
  return r;
}
// atan2(y, x), w = 1 / (x^2 + y^2): f_y = x w, f_x = -y w, f_yy = 2 f_y f_x
// = -f_xx, f_xy = f_x^2 - f_y^2 (nan at the origin, as JAX's)
MPC_D2 __device__ __forceinline__ MPC_V2 mpc_atan2(const MPC_V2& y, const MPC_V2& x) {
  const T w = T(1) / (x.v * x.v + y.v * y.v);
  const T fy = x.v * w, fx = -y.v * w;
  const T fyy = T(2) * fy * fx;
  return mpc_chain2b(y, x, mpc_atan2(y.v, x.v), fy, fx, fyy, fx * fx - fy * fy, -fyy);
}
MPC_D2 __device__ __forceinline__ MPC_V2 mpc_atan2(const MPC_V2& y, T x) {
  const T w = T(1) / (x * x + y.v * y.v);
  const T fy = x * w;
  return mpc_chain2(y, mpc_atan2(y.v, x), fy, T(2) * fy * (-y.v * w));
}
MPC_D2 __device__ __forceinline__ MPC_V2 mpc_atan2(T y, const MPC_V2& x) {
  const T w = T(1) / (x.v * x.v + y * y);
  const T fx = -y * w;
  return mpc_chain2(x, mpc_atan2(y, x.v), fx, T(-2) * (x.v * w) * fx);
}
// a ** b, the exponent carrying tangents: f_a = b a^(b-1), f_b = L a^b with
// L = log(a) (0 at a = 0), f_aa = b (b-1) a^(b-2), f_ab = a^(b-1) (1 + b L),
// f_bb = L f_b
MPC_D2 __device__ __forceinline__ MPC_V2 mpc_pow(const MPC_V2& a, const MPC_V2& b) {
  const T p = mpc_pow(a.v, b.v), pm1 = mpc_pow(a.v, b.v - T(1));
  const T L = mpc_log0(a.v), fb = L * p;
  return mpc_chain2b(a, b, p, b.v * pm1, fb, b.v * ((b.v - T(1)) * mpc_pow(a.v, b.v - T(2))),
                     pm1 + b.v * (L * pm1), L * fb);
}
MPC_D2 __device__ __forceinline__ MPC_V2 mpc_pow(T a, const MPC_V2& b) {
  const T p = mpc_pow(a, b.v);
  const T L = mpc_log0(a), fb = L * p;
  return mpc_chain2(b, p, fb, L * fb);
}

// ----- max / min / where ---------------------------------------------------
MPC_D2 __device__ __forceinline__ MPC_V2 mpc_max(const MPC_V2& a, const MPC_V2& b) {
  MPC_V2 r; r.v = mpc_max(a.v, b.v);
  const T wa = a.v > b.v ? T(1) : (a.v < b.v ? T(0) : T(0.5));
  mpc_lin2(r, wa, a, T(1) - wa, b);
  return r;
}
MPC_D2 __device__ __forceinline__ MPC_V2 mpc_max(const MPC_V2& a, T b) {
  return mpc_max(a, MPC_V2(b));
}
MPC_D2 __device__ __forceinline__ MPC_V2 mpc_max(T a, const MPC_V2& b) {
  return mpc_max(MPC_V2(a), b);
}
MPC_D2 __device__ __forceinline__ MPC_V2 mpc_min(const MPC_V2& a, const MPC_V2& b) {
  MPC_V2 r; r.v = mpc_min(a.v, b.v);
  const T wa = a.v < b.v ? T(1) : (a.v > b.v ? T(0) : T(0.5));
  mpc_lin2(r, wa, a, T(1) - wa, b);
  return r;
}
MPC_D2 __device__ __forceinline__ MPC_V2 mpc_min(const MPC_V2& a, T b) {
  return mpc_min(a, MPC_V2(b));
}
MPC_D2 __device__ __forceinline__ MPC_V2 mpc_min(T a, const MPC_V2& b) {
  return mpc_min(MPC_V2(a), b);
}
MPC_D2 __device__ __forceinline__ MPC_V2 mpc_where(bool c, const MPC_V2& a, T b) {
  return c ? a : MPC_V2(b);
}
MPC_D2 __device__ __forceinline__ MPC_V2 mpc_where(bool c, T a, const MPC_V2& b) {
  return c ? MPC_V2(a) : b;
}

#undef MPC_D2
#undef MPC_V2
