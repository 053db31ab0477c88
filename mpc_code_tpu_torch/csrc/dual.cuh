// Forward-mode dual numbers and the scalar helpers that generated model code
// calls (mpc_exp, mpc_max, mpc_where, ...).
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
// the exponent is a literal (the code generator lowers pow by a constant):
// its tangents are zero
template <class T, int NZ>
__device__ __forceinline__ Dual<T, NZ> mpc_pow(const Dual<T, NZ>& a, const Dual<T, NZ>& c) {
  return mpc_pow(a, c.v);
}

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
