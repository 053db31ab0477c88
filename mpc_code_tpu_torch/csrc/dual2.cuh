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
MPC_D2 __device__ __forceinline__ MPC_V2 mpc_pow(const MPC_V2& a, T c) {
  return mpc_chain2(a, mpc_pow(a.v, c), c * mpc_pow(a.v, c - T(1)),
                    c * (c - T(1)) * mpc_pow(a.v, c - T(2)));
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
