// Second-order forward-mode numbers for the ContForm sweep kernel.
//
// A Dual2<T, NZ> carries a value v, the NZ first-order tangents d[i] =
// dv/dz_i and the packed upper triangle of the second-order tangents
// h[p(i, j)] = d2v/dz_i dz_j, i <= j, p running row by row.  Instantiating
// a generated model function with Dual2 arguments carries, in one pass,
// what the TPU kernel (mpc_code_tpu/ops/sweep_pallas.py::
// rk4_quad_stage_hess_pallas) computes with one nested jax.jvp per
// direction pair.
//
// max/min/where blend the two arguments' tangents with the weights of the
// first-order rule (JAX's half-and-half at an exact tie, dual.cuh); the
// weights are piecewise constant, so their own derivative is 0, as nested
// jvp of jnp.maximum gives.
#pragma once

#include <cmath>

#include "dual.cuh"

template <class T, int NZ>
struct Dual2 {
  static constexpr int NP = NZ * (NZ + 1) / 2;
  T v;
  T d[NZ];
  T h[NP];
  __device__ __forceinline__ Dual2() {}
  __device__ __forceinline__ Dual2(T value) : v(value) {
#pragma unroll
    for (int i = 0; i < NZ; ++i) d[i] = T(0);
#pragma unroll
    for (int p = 0; p < NP; ++p) h[p] = T(0);
  }
};

template <class T, int NZ>
__device__ __forceinline__ T mpc_val(const Dual2<T, NZ>& a) { return a.v; }

// ----- linear combinations -------------------------------------------------
// r = wa * a + wb * b on every component (value excluded): the tangent rule
// of +, - and of a select.
template <class T, int NZ>
__device__ __forceinline__ void mpc_lin2(Dual2<T, NZ>& r, T wa, const Dual2<T, NZ>& a,
                                         T wb, const Dual2<T, NZ>& b) {
#pragma unroll
  for (int i = 0; i < NZ; ++i) r.d[i] = wa * a.d[i] + wb * b.d[i];
#pragma unroll
  for (int p = 0; p < Dual2<T, NZ>::NP; ++p) r.h[p] = wa * a.h[p] + wb * b.h[p];
}

template <class T, int NZ>
__device__ __forceinline__ Dual2<T, NZ> operator+(const Dual2<T, NZ>& a, const Dual2<T, NZ>& b) {
  Dual2<T, NZ> r; r.v = a.v + b.v;
#pragma unroll
  for (int i = 0; i < NZ; ++i) r.d[i] = a.d[i] + b.d[i];
#pragma unroll
  for (int p = 0; p < Dual2<T, NZ>::NP; ++p) r.h[p] = a.h[p] + b.h[p];
  return r;
}
template <class T, int NZ>
__device__ __forceinline__ Dual2<T, NZ> operator+(const Dual2<T, NZ>& a, T b) {
  Dual2<T, NZ> r = a; r.v = a.v + b; return r;
}
template <class T, int NZ>
__device__ __forceinline__ Dual2<T, NZ> operator+(T a, const Dual2<T, NZ>& b) {
  Dual2<T, NZ> r = b; r.v = a + b.v; return r;
}
template <class T, int NZ>
__device__ __forceinline__ Dual2<T, NZ> operator-(const Dual2<T, NZ>& a) {
  Dual2<T, NZ> r; r.v = -a.v;
#pragma unroll
  for (int i = 0; i < NZ; ++i) r.d[i] = -a.d[i];
#pragma unroll
  for (int p = 0; p < Dual2<T, NZ>::NP; ++p) r.h[p] = -a.h[p];
  return r;
}
template <class T, int NZ>
__device__ __forceinline__ Dual2<T, NZ> operator-(const Dual2<T, NZ>& a, const Dual2<T, NZ>& b) {
  Dual2<T, NZ> r; r.v = a.v - b.v;
#pragma unroll
  for (int i = 0; i < NZ; ++i) r.d[i] = a.d[i] - b.d[i];
#pragma unroll
  for (int p = 0; p < Dual2<T, NZ>::NP; ++p) r.h[p] = a.h[p] - b.h[p];
  return r;
}
template <class T, int NZ>
__device__ __forceinline__ Dual2<T, NZ> operator-(const Dual2<T, NZ>& a, T b) {
  Dual2<T, NZ> r = a; r.v = a.v - b; return r;
}
template <class T, int NZ>
__device__ __forceinline__ Dual2<T, NZ> operator-(T a, const Dual2<T, NZ>& b) {
  Dual2<T, NZ> r = -b; r.v = a - b.v; return r;
}

// ----- products and quotients -------------------------------------------
template <class T, int NZ>
__device__ __forceinline__ Dual2<T, NZ> operator*(const Dual2<T, NZ>& a, const Dual2<T, NZ>& b) {
  Dual2<T, NZ> r; r.v = a.v * b.v;
#pragma unroll
  for (int i = 0; i < NZ; ++i) r.d[i] = a.d[i] * b.v + a.v * b.d[i];
  int p = 0;
#pragma unroll
  for (int i = 0; i < NZ; ++i) {
#pragma unroll
    for (int j = i; j < NZ; ++j, ++p)
      r.h[p] = a.h[p] * b.v + a.v * b.h[p] + a.d[i] * b.d[j] + a.d[j] * b.d[i];
  }
  return r;
}
template <class T, int NZ>
__device__ __forceinline__ Dual2<T, NZ> operator*(const Dual2<T, NZ>& a, T b) {
  Dual2<T, NZ> r; r.v = a.v * b;
#pragma unroll
  for (int i = 0; i < NZ; ++i) r.d[i] = a.d[i] * b;
#pragma unroll
  for (int p = 0; p < Dual2<T, NZ>::NP; ++p) r.h[p] = a.h[p] * b;
  return r;
}
template <class T, int NZ>
__device__ __forceinline__ Dual2<T, NZ> operator*(T a, const Dual2<T, NZ>& b) {
  Dual2<T, NZ> r; r.v = a * b.v;
#pragma unroll
  for (int i = 0; i < NZ; ++i) r.d[i] = a * b.d[i];
#pragma unroll
  for (int p = 0; p < Dual2<T, NZ>::NP; ++p) r.h[p] = a * b.h[p];
  return r;
}
// c = a / b:  c' = (a' - c b') / b,  c'' = (a'' - c b'' - c'_i b'_j - c'_j b'_i) / b
template <class T, int NZ>
__device__ __forceinline__ Dual2<T, NZ> operator/(const Dual2<T, NZ>& a, const Dual2<T, NZ>& b) {
  Dual2<T, NZ> r; r.v = a.v / b.v;
#pragma unroll
  for (int i = 0; i < NZ; ++i) r.d[i] = (a.d[i] - r.v * b.d[i]) / b.v;
  int p = 0;
#pragma unroll
  for (int i = 0; i < NZ; ++i) {
#pragma unroll
    for (int j = i; j < NZ; ++j, ++p)
      r.h[p] = (a.h[p] - r.v * b.h[p] - r.d[i] * b.d[j] - r.d[j] * b.d[i]) / b.v;
  }
  return r;
}
template <class T, int NZ>
__device__ __forceinline__ Dual2<T, NZ> operator/(const Dual2<T, NZ>& a, T b) {
  Dual2<T, NZ> r; r.v = a.v / b;
#pragma unroll
  for (int i = 0; i < NZ; ++i) r.d[i] = a.d[i] / b;
#pragma unroll
  for (int p = 0; p < Dual2<T, NZ>::NP; ++p) r.h[p] = a.h[p] / b;
  return r;
}
template <class T, int NZ>
__device__ __forceinline__ Dual2<T, NZ> operator/(T a, const Dual2<T, NZ>& b) {
  Dual2<T, NZ> r; r.v = a / b.v;
#pragma unroll
  for (int i = 0; i < NZ; ++i) r.d[i] = -r.v * b.d[i] / b.v;
  int p = 0;
#pragma unroll
  for (int i = 0; i < NZ; ++i) {
#pragma unroll
    for (int j = i; j < NZ; ++j, ++p)
      r.h[p] = (-r.v * b.h[p] - r.d[i] * b.d[j] - r.d[j] * b.d[i]) / b.v;
  }
  return r;
}

// ----- elementary functions: c = f(a) with f0, f1 = f', f2 = f'' ----------
template <class T, int NZ>
__device__ __forceinline__ Dual2<T, NZ> mpc_chain2(const Dual2<T, NZ>& a, T f0, T f1, T f2) {
  Dual2<T, NZ> r; r.v = f0;
#pragma unroll
  for (int i = 0; i < NZ; ++i) r.d[i] = f1 * a.d[i];
  int p = 0;
#pragma unroll
  for (int i = 0; i < NZ; ++i) {
#pragma unroll
    for (int j = i; j < NZ; ++j, ++p) r.h[p] = f1 * a.h[p] + f2 * a.d[i] * a.d[j];
  }
  return r;
}
template <class T, int NZ>
__device__ __forceinline__ Dual2<T, NZ> mpc_exp(const Dual2<T, NZ>& a) {
  const T e = mpc_exp(a.v);
  return mpc_chain2(a, e, e, e);
}
template <class T, int NZ>
__device__ __forceinline__ Dual2<T, NZ> mpc_log(const Dual2<T, NZ>& a) {
  const T inv = T(1) / a.v;
  return mpc_chain2(a, mpc_log(a.v), inv, -inv * inv);
}
template <class T, int NZ>
__device__ __forceinline__ Dual2<T, NZ> mpc_sqrt(const Dual2<T, NZ>& a) {
  const T s = mpc_sqrt(a.v);
  const T f1 = T(1) / (T(2) * s);
  return mpc_chain2(a, s, f1, -f1 / (T(2) * a.v));
}
template <class T, int NZ>
__device__ __forceinline__ Dual2<T, NZ> mpc_pow(const Dual2<T, NZ>& a, T c) {
  return mpc_chain2(a, mpc_pow(a.v, c), c * mpc_pow(a.v, c - T(1)),
                    c * (c - T(1)) * mpc_pow(a.v, c - T(2)));
}

// ----- max / min / where ---------------------------------------------------
template <class T, int NZ>
__device__ __forceinline__ Dual2<T, NZ> mpc_max(const Dual2<T, NZ>& a, const Dual2<T, NZ>& b) {
  Dual2<T, NZ> r; r.v = mpc_max(a.v, b.v);
  const T wa = a.v > b.v ? T(1) : (a.v < b.v ? T(0) : T(0.5));
  mpc_lin2(r, wa, a, T(1) - wa, b);
  return r;
}
template <class T, int NZ>
__device__ __forceinline__ Dual2<T, NZ> mpc_max(const Dual2<T, NZ>& a, T b) {
  return mpc_max(a, Dual2<T, NZ>(b));
}
template <class T, int NZ>
__device__ __forceinline__ Dual2<T, NZ> mpc_max(T a, const Dual2<T, NZ>& b) {
  return mpc_max(Dual2<T, NZ>(a), b);
}
template <class T, int NZ>
__device__ __forceinline__ Dual2<T, NZ> mpc_min(const Dual2<T, NZ>& a, const Dual2<T, NZ>& b) {
  Dual2<T, NZ> r; r.v = mpc_min(a.v, b.v);
  const T wa = a.v < b.v ? T(1) : (a.v > b.v ? T(0) : T(0.5));
  mpc_lin2(r, wa, a, T(1) - wa, b);
  return r;
}
template <class T, int NZ>
__device__ __forceinline__ Dual2<T, NZ> mpc_min(const Dual2<T, NZ>& a, T b) {
  return mpc_min(a, Dual2<T, NZ>(b));
}
template <class T, int NZ>
__device__ __forceinline__ Dual2<T, NZ> mpc_min(T a, const Dual2<T, NZ>& b) {
  return mpc_min(Dual2<T, NZ>(a), b);
}
template <class T, int NZ>
__device__ __forceinline__ Dual2<T, NZ> mpc_where(bool c, const Dual2<T, NZ>& a, T b) {
  return c ? a : Dual2<T, NZ>(b);
}
template <class T, int NZ>
__device__ __forceinline__ Dual2<T, NZ> mpc_where(bool c, T a, const Dual2<T, NZ>& b) {
  return c ? Dual2<T, NZ>(a) : b;
}
