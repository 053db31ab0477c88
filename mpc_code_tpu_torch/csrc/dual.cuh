// Forward-mode dual numbers and the scalar helpers that generated model code
// calls (mpc_exp, mpc_max, mpc_where, ...).
//
// Every elementary function takes JAX's derivative, also where torch's
// differs: atan2 is nan at the origin, pow's derivative in its exponent is 0
// at a zero base, sign's, floor's and round's are 0, fmod's in its divisor
// is -trunc(a / b) (mpc_code_tpu_torch/ops/jax_rules.py).
//
// A Dual<T, NZ> carries a value and NZ tangents.  Instantiating a generated
// model function with Dual arguments propagates NZ forward directions in
// one pass, the arithmetic that jax.linearize replays in the TPU sweep
// kernel (mpc_code_tpu/ops/sweep_pallas.py).  The helpers are overloaded
// for plain float/double too, so the same generated function compiles for
// values that carry no tangents (parameters, time, disturbances).
//
// A quotient, log and sqrt form one reciprocal of the denominator and
// multiply the value and every tangent by it: one IEEE division (without
// fast-math a reciprocal, a Newton step and a slow-path check, about a
// dozen FMA issue slots in f32 and ~30 DFMA-class instructions in f64) in
// place of NZ + 1.  A quotient by a literal becomes a product by its
// reciprocal, which nvcc forms at compile time.  So a / b rounds twice
// where an IEEE division rounds once; the tangents round as they did.
//
// max/min follow JAX at an exact tie: the derivative takes half of each
// argument's tangent (jnp.maximum's balanced jvp), and NaN propagates.
// Against a constant only the Dual's tangents are weighted: the constant's
// term, a zero tangent times a finite weight, added nothing but the sign of
// a zero, so inf and nan tangents come out where they did.
#pragma once

#include <cmath>

template <class T, int NZ>
struct Dual {
  T v;
  T d[NZ];
  __device__ __forceinline__ Dual() {}
  __device__ __forceinline__ Dual(T value) : v(value) {
#pragma unroll
    for (int i = 0; i < NZ; ++i) d[i] = T(0);
  }
};

// ----- value access ------------------------------------------------------
template <class T> __device__ __forceinline__ T mpc_val(T a) { return a; }
template <class T, int NZ>
__device__ __forceinline__ T mpc_val(const Dual<T, NZ>& a) { return a.v; }

// ----- comparisons, on the values ----------------------------------------
// (numbers whose components are themselves Dual, as collocation's third
// derivatives use, compare and select by these)
#define MPC_DUAL_CMP(OP)                                                           \
  template <class T, int NZ>                                                       \
  __device__ __forceinline__ bool operator OP(const Dual<T, NZ>& a, const Dual<T, NZ>& b) { \
    return a.v OP b.v;                                                             \
  }                                                                                \
  template <class T, int NZ>                                                       \
  __device__ __forceinline__ bool operator OP(const Dual<T, NZ>& a, T b) {         \
    return a.v OP b;                                                               \
  }                                                                                \
  template <class T, int NZ>                                                       \
  __device__ __forceinline__ bool operator OP(T a, const Dual<T, NZ>& b) {         \
    return a OP b.v;                                                               \
  }
MPC_DUAL_CMP(<)
MPC_DUAL_CMP(<=)
MPC_DUAL_CMP(>)
MPC_DUAL_CMP(>=)
MPC_DUAL_CMP(==)
MPC_DUAL_CMP(!=)
#undef MPC_DUAL_CMP

// ----- arithmetic --------------------------------------------------------
template <class T, int NZ>
__device__ __forceinline__ Dual<T, NZ> operator+(const Dual<T, NZ>& a, const Dual<T, NZ>& b) {
  Dual<T, NZ> r; r.v = a.v + b.v;
#pragma unroll
  for (int i = 0; i < NZ; ++i) r.d[i] = a.d[i] + b.d[i];
  return r;
}
template <class T, int NZ>
__device__ __forceinline__ Dual<T, NZ> operator+(const Dual<T, NZ>& a, T b) {
  Dual<T, NZ> r; r.v = a.v + b;
#pragma unroll
  for (int i = 0; i < NZ; ++i) r.d[i] = a.d[i];
  return r;
}
template <class T, int NZ>
__device__ __forceinline__ Dual<T, NZ> operator+(T a, const Dual<T, NZ>& b) {
  Dual<T, NZ> r; r.v = a + b.v;
#pragma unroll
  for (int i = 0; i < NZ; ++i) r.d[i] = b.d[i];
  return r;
}
template <class T, int NZ>
__device__ __forceinline__ Dual<T, NZ> operator-(const Dual<T, NZ>& a, const Dual<T, NZ>& b) {
  Dual<T, NZ> r; r.v = a.v - b.v;
#pragma unroll
  for (int i = 0; i < NZ; ++i) r.d[i] = a.d[i] - b.d[i];
  return r;
}
template <class T, int NZ>
__device__ __forceinline__ Dual<T, NZ> operator-(const Dual<T, NZ>& a, T b) {
  Dual<T, NZ> r; r.v = a.v - b;
#pragma unroll
  for (int i = 0; i < NZ; ++i) r.d[i] = a.d[i];
  return r;
}
template <class T, int NZ>
__device__ __forceinline__ Dual<T, NZ> operator-(T a, const Dual<T, NZ>& b) {
  Dual<T, NZ> r; r.v = a - b.v;
#pragma unroll
  for (int i = 0; i < NZ; ++i) r.d[i] = -b.d[i];
  return r;
}
template <class T, int NZ>
__device__ __forceinline__ Dual<T, NZ> operator-(const Dual<T, NZ>& a) {
  Dual<T, NZ> r; r.v = -a.v;
#pragma unroll
  for (int i = 0; i < NZ; ++i) r.d[i] = -a.d[i];
  return r;
}
template <class T, int NZ>
__device__ __forceinline__ Dual<T, NZ> operator*(const Dual<T, NZ>& a, const Dual<T, NZ>& b) {
  Dual<T, NZ> r; r.v = a.v * b.v;
#pragma unroll
  for (int i = 0; i < NZ; ++i) r.d[i] = a.d[i] * b.v + a.v * b.d[i];
  return r;
}
template <class T, int NZ>
__device__ __forceinline__ Dual<T, NZ> operator*(const Dual<T, NZ>& a, T b) {
  Dual<T, NZ> r; r.v = a.v * b;
#pragma unroll
  for (int i = 0; i < NZ; ++i) r.d[i] = a.d[i] * b;
  return r;
}
template <class T, int NZ>
__device__ __forceinline__ Dual<T, NZ> operator*(T a, const Dual<T, NZ>& b) {
  Dual<T, NZ> r; r.v = a * b.v;
#pragma unroll
  for (int i = 0; i < NZ; ++i) r.d[i] = a * b.d[i];
  return r;
}
// c = a / b with w = 1 / b:  c = a w,  c' = (a' - c b') w
template <class T, int NZ>
__device__ __forceinline__ Dual<T, NZ> operator/(const Dual<T, NZ>& a, const Dual<T, NZ>& b) {
  const T w = T(1) / b.v;
  Dual<T, NZ> r; r.v = a.v * w;
#pragma unroll
  for (int i = 0; i < NZ; ++i) r.d[i] = (a.d[i] - r.v * b.d[i]) * w;
  return r;
}
template <class T, int NZ>
__device__ __forceinline__ Dual<T, NZ> operator/(const Dual<T, NZ>& a, T b) {
  return a * (T(1) / b);
}
// c = a / b:  c = a w,  c' = -c w b'
template <class T, int NZ>
__device__ __forceinline__ Dual<T, NZ> operator/(T a, const Dual<T, NZ>& b) {
  const T w = T(1) / b.v;
  Dual<T, NZ> r; r.v = a * w;
  const T g = -r.v * w;
#pragma unroll
  for (int i = 0; i < NZ; ++i) r.d[i] = g * b.d[i];
  return r;
}

// ----- elementary functions ----------------------------------------------
__device__ __forceinline__ float mpc_exp(float a) { return expf(a); }
__device__ __forceinline__ double mpc_exp(double a) { return exp(a); }
__device__ __forceinline__ float mpc_log(float a) { return logf(a); }
__device__ __forceinline__ double mpc_log(double a) { return log(a); }
__device__ __forceinline__ float mpc_sqrt(float a) { return sqrtf(a); }
__device__ __forceinline__ double mpc_sqrt(double a) { return sqrt(a); }
__device__ __forceinline__ float mpc_pow(float a, float c) { return powf(a, c); }
__device__ __forceinline__ double mpc_pow(double a, double c) { return pow(a, c); }

template <class T, int NZ>
__device__ __forceinline__ Dual<T, NZ> mpc_exp(const Dual<T, NZ>& a) {
  Dual<T, NZ> r; r.v = mpc_exp(a.v);
#pragma unroll
  for (int i = 0; i < NZ; ++i) r.d[i] = r.v * a.d[i];
  return r;
}
template <class T, int NZ>
__device__ __forceinline__ Dual<T, NZ> mpc_log(const Dual<T, NZ>& a) {
  Dual<T, NZ> r; r.v = mpc_log(a.v);
  const T w = T(1) / a.v;
#pragma unroll
  for (int i = 0; i < NZ; ++i) r.d[i] = a.d[i] * w;
  return r;
}
// the value by IEEE sqrt, the tangents times 1 / (2 sqrt(a))
template <class T, int NZ>
__device__ __forceinline__ Dual<T, NZ> mpc_sqrt(const Dual<T, NZ>& a) {
  Dual<T, NZ> r; r.v = mpc_sqrt(a.v);
  const T w = T(0.5) / r.v;
#pragma unroll
  for (int i = 0; i < NZ; ++i) r.d[i] = a.d[i] * w;
  return r;
}
template <class T, int NZ>
__device__ __forceinline__ Dual<T, NZ> mpc_pow(const Dual<T, NZ>& a, T c) {
  Dual<T, NZ> r; r.v = mpc_pow(a.v, c);
  const T g = c * mpc_pow(a.v, c - T(1));
#pragma unroll
  for (int i = 0; i < NZ; ++i) r.d[i] = g * a.d[i];
  return r;
}

// ----- the other elementary functions --------------------------------------
// The values are the full-accuracy libm routines (no __sinf-style
// intrinsics; the build adds no fast math).  Each first-order rule is
// JAX's jvp rule, c' = f'(a) a' (jax/_src/lax/lax.py), with f' written in
// this header's own operations, so that the rules also run on numbers whose
// components are themselves Dual (collocation's third derivatives).
#define MPC_LIBM(NAME, F32, F64)                                      \
  __device__ __forceinline__ float NAME(float a) { return F32(a); }   \
  __device__ __forceinline__ double NAME(double a) { return F64(a); }
MPC_LIBM(mpc_tanh, tanhf, tanh)
MPC_LIBM(mpc_sin, sinf, sin)
MPC_LIBM(mpc_cos, cosf, cos)
MPC_LIBM(mpc_tan, tanf, tan)
MPC_LIBM(mpc_asin, asinf, asin)
MPC_LIBM(mpc_acos, acosf, acos)
MPC_LIBM(mpc_atan, atanf, atan)
MPC_LIBM(mpc_sinh, sinhf, sinh)
MPC_LIBM(mpc_cosh, coshf, cosh)
MPC_LIBM(mpc_log1p, log1pf, log1p)
MPC_LIBM(mpc_expm1, expm1f, expm1)
MPC_LIBM(mpc_erf, erff, erf)
MPC_LIBM(mpc_asinh, asinhf, asinh)
MPC_LIBM(mpc_acosh, acoshf, acosh)
MPC_LIBM(mpc_atanh, atanhf, atanh)
MPC_LIBM(mpc_log2, log2f, log2)
MPC_LIBM(mpc_log10, log10f, log10)
MPC_LIBM(mpc_exp2, exp2f, exp2)
MPC_LIBM(mpc_erfc, erfcf, erfc)
MPC_LIBM(mpc_floor, floorf, floor)
MPC_LIBM(mpc_round, rintf, rint)     // half to even, as jnp.round and torch.round
MPC_LIBM(mpc_trunc, truncf, trunc)
#ifdef __CUDACC__
MPC_LIBM(mpc_erfinv, erfinvf, erfinv)
#else
// The host (a g++ build of these headers) has no erfinv in <cmath>: Giles'
// single-precision approximation ("Approximating the erfinv function", GPU
// Computing Gems, 2010), then Newton's steps on erf in double precision.
inline double mpc_erfinv(double y) {
  if (!(y > -1.0 && y < 1.0)) return y == 1.0 ? INFINITY : (y == -1.0 ? -INFINITY : NAN);
  double w = -std::log((1.0 - y) * (1.0 + y)), p;
  if (w < 5.0) {
    w -= 2.5;
    p = 2.81022636e-08;
    p = 3.43273939e-07 + p * w; p = -3.5233877e-06 + p * w; p = -4.39150654e-06 + p * w;
    p = 0.00021858087 + p * w; p = -0.00125372503 + p * w; p = -0.00417768164 + p * w;
    p = 0.246640727 + p * w; p = 1.50140941 + p * w;
  } else {
    w = std::sqrt(w) - 3.0;
    p = -0.000200214257;
    p = 0.000100950558 + p * w; p = 0.00134934322 + p * w; p = -0.00367342844 + p * w;
    p = 0.00573950773 + p * w; p = -0.0076224613 + p * w; p = 0.00943887047 + p * w;
    p = 1.00167406 + p * w; p = 2.83297682 + p * w;
  }
  double x = p * y;
  for (int i = 0; i < 3; ++i) x -= (std::erf(x) - y) / (1.1283791670955126 * std::exp(-x * x));
  return x;
}
inline float mpc_erfinv(float y) { return float(mpc_erfinv(double(y))); }
#endif
#undef MPC_LIBM
__device__ __forceinline__ float mpc_fmod(float a, float b) { return fmodf(a, b); }
__device__ __forceinline__ double mpc_fmod(double a, double b) { return fmod(a, b); }
// 1 / sqrt(a): an IEEE square root and division (as XLA's rsqrt on the CPU)
__device__ __forceinline__ float mpc_rsqrt(float a) { return 1.0f / sqrtf(a); }
__device__ __forceinline__ double mpc_rsqrt(double a) { return 1.0 / sqrt(a); }
__device__ __forceinline__ float mpc_sigmoid(float a) { return 1.0f / (1.0f + expf(-a)); }
__device__ __forceinline__ double mpc_sigmoid(double a) { return 1.0 / (1.0 + exp(-a)); }
__device__ __forceinline__ float mpc_atan2(float y, float x) { return atan2f(y, x); }
__device__ __forceinline__ double mpc_atan2(double y, double x) { return atan2(y, x); }
// JAX's sign: 0 at +-0 (its sign kept), nan at nan
__device__ __forceinline__ float mpc_sign(float a) { return a > 0.0f ? 1.0f : (a < 0.0f ? -1.0f : a); }
__device__ __forceinline__ double mpc_sign(double a) { return a > 0.0 ? 1.0 : (a < 0.0 ? -1.0 : a); }
// log(a), 0 at a = 0: the factor of pow's derivative in the exponent
template <class T> __device__ __forceinline__ T mpc_log0(T a) {
  return mpc_log(a == T(0) ? T(1) : a);
}

// c = f(a) with f0 = f(a.v), f1 = f'(a.v)
template <class T, int NZ>
__device__ __forceinline__ Dual<T, NZ> mpc_chain(const Dual<T, NZ>& a, T f0, T f1) {
  Dual<T, NZ> r; r.v = f0;
#pragma unroll
  for (int i = 0; i < NZ; ++i) r.d[i] = f1 * a.d[i];
  return r;
}

#define MPC_D1 template <class T, int NZ> __device__ __forceinline__ Dual<T, NZ>
MPC_D1 mpc_tanh(const Dual<T, NZ>& a) {
  const T t = mpc_tanh(a.v);
  return mpc_chain(a, t, T(1) - t * t);
}
MPC_D1 mpc_sigmoid(const Dual<T, NZ>& a) {
  const T s = mpc_sigmoid(a.v);
  return mpc_chain(a, s, s * (T(1) - s));
}
MPC_D1 mpc_sin(const Dual<T, NZ>& a) { return mpc_chain(a, mpc_sin(a.v), mpc_cos(a.v)); }
MPC_D1 mpc_cos(const Dual<T, NZ>& a) { return mpc_chain(a, mpc_cos(a.v), -mpc_sin(a.v)); }
MPC_D1 mpc_tan(const Dual<T, NZ>& a) {
  const T t = mpc_tan(a.v);
  return mpc_chain(a, t, T(1) + t * t);
}
MPC_D1 mpc_asin(const Dual<T, NZ>& a) {
  return mpc_chain(a, mpc_asin(a.v), mpc_rsqrt(T(1) - a.v * a.v));
}
MPC_D1 mpc_acos(const Dual<T, NZ>& a) {
  return mpc_chain(a, mpc_acos(a.v), -mpc_rsqrt(T(1) - a.v * a.v));
}
MPC_D1 mpc_atan(const Dual<T, NZ>& a) {
  return mpc_chain(a, mpc_atan(a.v), T(1) / (T(1) + a.v * a.v));
}
MPC_D1 mpc_sinh(const Dual<T, NZ>& a) { return mpc_chain(a, mpc_sinh(a.v), mpc_cosh(a.v)); }
MPC_D1 mpc_cosh(const Dual<T, NZ>& a) { return mpc_chain(a, mpc_cosh(a.v), mpc_sinh(a.v)); }
MPC_D1 mpc_log1p(const Dual<T, NZ>& a) {
  return mpc_chain(a, mpc_log1p(a.v), T(1) / (a.v + T(1)));
}
MPC_D1 mpc_expm1(const Dual<T, NZ>& a) {
  const T e = mpc_expm1(a.v);
  return mpc_chain(a, e, e + T(1));
}
MPC_D1 mpc_rsqrt(const Dual<T, NZ>& a) {
  const T r = mpc_rsqrt(a.v);
  return mpc_chain(a, r, T(-0.5) * (r / a.v));
}
MPC_D1 mpc_erf(const Dual<T, NZ>& a) {       // 2 / sqrt(pi) exp(-a^2)
  return mpc_chain(a, mpc_erf(a.v), T(1.1283791670955126) * mpc_exp(-(a.v * a.v)));
}
// asinh: f' = (a^2 + 1)^-1/2; acosh: f' = (a^2 - 1)^-1/2 (JAX's a^2 - 1);
// atanh: f' = 1 / (1 + a) / (1 - a)
MPC_D1 mpc_asinh(const Dual<T, NZ>& a) {
  return mpc_chain(a, mpc_asinh(a.v), mpc_rsqrt(a.v * a.v + T(1)));
}
MPC_D1 mpc_acosh(const Dual<T, NZ>& a) {
  return mpc_chain(a, mpc_acosh(a.v), mpc_rsqrt(a.v * a.v - T(1)));
}
MPC_D1 mpc_atanh(const Dual<T, NZ>& a) {
  return mpc_chain(a, mpc_atanh(a.v), (T(1) / (T(1) + a.v)) * (T(1) / (T(1) - a.v)));
}
// log2 and log10 as JAX's log(a) / log(2) and log(a) * (1 / log(10)): f' =
// c / a; exp2: f' = log(2) f
MPC_D1 mpc_log2(const Dual<T, NZ>& a) {
  return mpc_chain(a, mpc_log2(a.v), T(1.4426950408889634) * (T(1) / a.v));
}
MPC_D1 mpc_log10(const Dual<T, NZ>& a) {
  return mpc_chain(a, mpc_log10(a.v), T(0.4342944819032518) * (T(1) / a.v));
}
MPC_D1 mpc_exp2(const Dual<T, NZ>& a) {
  const T e = mpc_exp2(a.v);
  return mpc_chain(a, e, T(0.6931471805599453) * e);
}
MPC_D1 mpc_erfc(const Dual<T, NZ>& a) {      // -2 / sqrt(pi) exp(-a^2)
  return mpc_chain(a, mpc_erfc(a.v), T(-1.1283791670955126) * mpc_exp(-(a.v * a.v)));
}
MPC_D1 mpc_erfinv(const Dual<T, NZ>& a) {    // sqrt(pi) / 2 exp(f^2)
  const T f = mpc_erfinv(a.v);
  return mpc_chain(a, f, T(0.88622692545275801) * mpc_exp(f * f));
}
// sign's, floor's and round's derivatives are 0: their values carry no
// tangents
template <class T, int NZ>
__device__ __forceinline__ T mpc_sign(const Dual<T, NZ>& a) { return mpc_sign(a.v); }
template <class T, int NZ>
__device__ __forceinline__ T mpc_floor(const Dual<T, NZ>& a) { return mpc_floor(a.v); }
template <class T, int NZ>
__device__ __forceinline__ T mpc_round(const Dual<T, NZ>& a) { return mpc_round(a.v); }
template <class T, int NZ>
__device__ __forceinline__ T mpc_trunc(const Dual<T, NZ>& a) { return mpc_trunc(a.v); }

// fmod(a, b), C's (JAX's rem): f_a = 1, f_b = -trunc(a / b), a piecewise
// constant factor
MPC_D1 mpc_fmod(const Dual<T, NZ>& a, const Dual<T, NZ>& b) {
  const T q = mpc_trunc(a.v / b.v);
  Dual<T, NZ> r; r.v = mpc_fmod(a.v, b.v);
#pragma unroll
  for (int i = 0; i < NZ; ++i) r.d[i] = a.d[i] - q * b.d[i];
  return r;
}
MPC_D1 mpc_fmod(const Dual<T, NZ>& a, T b) {
  Dual<T, NZ> r = a; r.v = mpc_fmod(a.v, b);
  return r;
}
MPC_D1 mpc_fmod(T a, const Dual<T, NZ>& b) {
  return mpc_chain(b, mpc_fmod(a, b.v), -T(mpc_trunc(a / b.v)));
}

// a number with v's value and a's tangents: the max/min reductions take
// their value on the values and their tangents from a linear rule.  On
// numbers whose components are themselves Dual, v's value keeps a's inner
// tangents, so that the split of a tie holds at every order.
template <class T> __device__ __forceinline__ T mpc_setv(T a, T v) { return v; }
MPC_D1 mpc_setv(Dual<T, NZ> a, T v) { a.v = mpc_setv(a.v, v); return a; }
MPC_D1 mpc_setv(Dual<T, NZ> a, Dual<T, NZ> v) { a.v = mpc_setv(a.v, v.v); return a; }
// |a| of the value alone: the LU's pivot search
template <class V> __device__ __forceinline__ auto mpc_absv(const V& a) {
  using R = decltype(mpc_val(a));
  const R v = mpc_val(a);
  return v < R(0) ? R(-v) : v;
}

// atan2(y, x): f_y = x w, f_x = -y w with w = 1 / (x^2 + y^2), nan at the
// origin, as JAX's
MPC_D1 mpc_atan2(const Dual<T, NZ>& y, const Dual<T, NZ>& x) {
  const T w = T(1) / (x.v * x.v + y.v * y.v);
  const T fy = x.v * w, fx = -y.v * w;
  Dual<T, NZ> r; r.v = mpc_atan2(y.v, x.v);
#pragma unroll
  for (int i = 0; i < NZ; ++i) r.d[i] = fy * y.d[i] + fx * x.d[i];
  return r;
}
MPC_D1 mpc_atan2(const Dual<T, NZ>& y, T x) {
  return mpc_chain(y, mpc_atan2(y.v, x), x * (T(1) / (x * x + y.v * y.v)));
}
MPC_D1 mpc_atan2(T y, const Dual<T, NZ>& x) {
  return mpc_chain(x, mpc_atan2(y, x.v), -y * (T(1) / (x.v * x.v + y * y)));
}

// a ** b with the exponent carrying tangents (JAX's rules): f_a = b a^(b-1),
// f_b = log(a) a^b with log(0) taken as 0
MPC_D1 mpc_pow(T a, const Dual<T, NZ>& b) {
  const T p = mpc_pow(a, b.v);
  return mpc_chain(b, p, mpc_log0(a) * p);
}
MPC_D1 mpc_pow(const Dual<T, NZ>& a, const Dual<T, NZ>& b) {
  const T p = mpc_pow(a.v, b.v);
  const T fa = b.v * mpc_pow(a.v, b.v - T(1)), fb = mpc_log0(a.v) * p;
  Dual<T, NZ> r; r.v = p;
#pragma unroll
  for (int i = 0; i < NZ; ++i) r.d[i] = fa * a.d[i] + fb * b.d[i];
  return r;
}
#undef MPC_D1

// ----- max / min with JAX's tie rule and NaN propagation -----------------
template <class T> __device__ __forceinline__ T mpc_max(T a, T b) {
  return (a > b || a != a) ? a : b;
}
template <class T> __device__ __forceinline__ T mpc_min(T a, T b) {
  return (a < b || a != a) ? a : b;
}
// the weight of a's tangent in max(a, b) and min(a, b): 1, 0, or 1/2 at a
// tie and when either is NaN
template <class T> __device__ __forceinline__ T mpc_wmax(T a, T b) {
  return a > b ? T(1) : (a < b ? T(0) : T(0.5));
}
template <class T> __device__ __forceinline__ T mpc_wmin(T a, T b) {
  return a < b ? T(1) : (a > b ? T(0) : T(0.5));
}
// r = max/min(a, b) with the tangents w a' + (1 - w) b'
template <class T, int NZ>
__device__ __forceinline__ Dual<T, NZ> mpc_blend(T v, T w, const Dual<T, NZ>& a,
                                                 const Dual<T, NZ>& b) {
  Dual<T, NZ> r; r.v = v;
#pragma unroll
  for (int i = 0; i < NZ; ++i) r.d[i] = w * a.d[i] + (T(1) - w) * b.d[i];
  return r;
}
// r = max/min(a, c) for a constant c, with the tangents w a'
template <class T, int NZ>
__device__ __forceinline__ Dual<T, NZ> mpc_scale(T v, T w, const Dual<T, NZ>& a) {
  Dual<T, NZ> r; r.v = v;
#pragma unroll
  for (int i = 0; i < NZ; ++i) r.d[i] = w * a.d[i];
  return r;
}
template <class T, int NZ>
__device__ __forceinline__ Dual<T, NZ> mpc_max(const Dual<T, NZ>& a, const Dual<T, NZ>& b) {
  return mpc_blend(mpc_max(a.v, b.v), mpc_wmax(a.v, b.v), a, b);
}
template <class T, int NZ>
__device__ __forceinline__ Dual<T, NZ> mpc_max(const Dual<T, NZ>& a, T b) {
  return mpc_scale(mpc_max(a.v, b), mpc_wmax(a.v, b), a);
}
template <class T, int NZ>
__device__ __forceinline__ Dual<T, NZ> mpc_max(T a, const Dual<T, NZ>& b) {
  return mpc_scale(mpc_max(a, b.v), mpc_wmax(b.v, a), b);
}
template <class T, int NZ>
__device__ __forceinline__ Dual<T, NZ> mpc_min(const Dual<T, NZ>& a, const Dual<T, NZ>& b) {
  return mpc_blend(mpc_min(a.v, b.v), mpc_wmin(a.v, b.v), a, b);
}
template <class T, int NZ>
__device__ __forceinline__ Dual<T, NZ> mpc_min(const Dual<T, NZ>& a, T b) {
  return mpc_scale(mpc_min(a.v, b), mpc_wmin(a.v, b), a);
}
template <class T, int NZ>
__device__ __forceinline__ Dual<T, NZ> mpc_min(T a, const Dual<T, NZ>& b) {
  return mpc_scale(mpc_min(a, b.v), mpc_wmin(b.v, a), b);
}

// ----- select --------------------------------------------------------------
template <class T> __device__ __forceinline__ T mpc_where(bool c, T a, T b) {
  return c ? a : b;
}
template <class T, int NZ>
__device__ __forceinline__ Dual<T, NZ> mpc_where(bool c, const Dual<T, NZ>& a, T b) {
  return c ? a : Dual<T, NZ>(b);
}
template <class T, int NZ>
__device__ __forceinline__ Dual<T, NZ> mpc_where(bool c, T a, const Dual<T, NZ>& b) {
  return c ? Dual<T, NZ>(a) : b;
}
