// Fused generic stage-derivative sweep for Hopper (sm_90a).
//
// Replaces mpc_code_tpu/solver/sweep_kernel.py::make_stage_sweep (kernel
// body from _get_kernel_impl), the TPU kernel that runs every output of
// make_stage_derivs for all N stages of a batch: the structured IPM's
// derivative sweep on every iteration of an exact-Hessian solve.  For each
// (scenario, stage) lane, at z = (xa, u) in scaled units, it computes
//   H    = sf * d2c + sum_i lam_i * d2dyn_i + sum_j nus_j * d2ineq_j
//          (MPC_EXACT; the first term alone under Gauss-Newton),
//   gc   = sf * dc,
//   A, B = d dyn / d (xa, u), dval = dyn,
//   E    = d ineq / dz, ival = ineq,
// where dyn is MPC_MX RK4 sub-steps of the guarded ODE over the interval,
// plus Bd d and px, over the state scales, c the stage cost and ineq the
// output rows over their scales.  H is written symmetric from the upper
// triangle.  Output planes, lanes innermost: H (NZ*NZ, row i*NZ+j), gc
// (NZ), A (NXA*NXA), B (NXA*NU), E (NI*NZ), ival (NI), dval (NXA).
//
// The OCP is not fixed here: mpc_code_tpu_torch/solver/sweep_kernel.py
// lowers the user ODE, stage cost and rows to scalar statements and writes
// mpc_stage_gen.cuh (mpc_rhs, mpc_clip, mpc_terms, mpc_cost, mpc_ineq, the
// MPC_* dimensions, steps and scales as literals) into the build
// directory, the role that the per-stage Pallas traces play for the TPU
// kernel.
//
// What bounds it on the H100: arithmetic.  A lane reads 2*NXA+NU+NI+NPX+NPY
// values (~15 for the CSTR) and writes NZ*NZ+NZ+NXA*(NXA+NU)+NI*(NZ+1)+NXA
// (~60), while it runs 4*MPC_MX right-hand sides on numbers of
// 1 + NZ + NZ(NZ+1)/2 components (21 for the CSTR: ~40 kFLOP a lane at
// MPC_MX = 10).  The design: one thread per lane on second-order
// forward-mode numbers (Dual2), which carry in one pass what the TPU
// kernel's jax.hessian, jacfwd and grad traces compute; the cost and the
// rows are evaluated first and folded into H, so only the rolled-out state
// and H's accumulator stay live across the sub-steps; nothing touches
// device memory between loading the inputs and writing the outputs; the
// planes put lanes innermost so a warp's loads and stores are coalesced.

#include <cuda_runtime.h>

#include "dual.cuh"
#include "dual2.cuh"
#include "mpc_stage_gen.cuh"

namespace {

constexpr int NX = MPC_NX;
constexpr int NXA = MPC_NXA;
constexpr int NU = MPC_NU;
constexpr int NZ = MPC_NXA + MPC_NU;
constexpr int NI = MPC_NI;
constexpr int NP = NZ * (NZ + 1) / 2;
constexpr int NPX_A = MPC_NPX > 0 ? MPC_NPX : 1;
constexpr int NPY_A = MPC_NPY > 0 ? MPC_NPY : 1;
constexpr int ND_A = MPC_ND > 0 ? MPC_ND : 1;
constexpr int NLAM_A = MPC_NLAM > 0 ? MPC_NLAM : 1;
static_assert(NX == NXA, "the augmented state is not lowered by this kernel");

template <class V, class T>
__device__ __forceinline__ void eval_rhs(const V* x, T t, const V* u,
                                         const T* d, const T* px, V* out) {
  V xc[NX];
  mpc_clip<V, T>(x, xc);
  mpc_rhs<V, T>(xc, t, u, d, px, out);
}

// Stage planes X (NXA, L), U (NU, L), lam (NXA, L), nus (NI, L), px (NPX, L),
// py (NPY, L): lane l = b * N + n; stage 0's py (lane b * N) is py0.
// Per scenario: ts, sfs (B,), xs (NX, B), us (NU, B), ds (ND, B),
// um1 (NU, B), lamy (NLAM, B).
template <class T>
__global__ void stage_sweep_kernel(
    const T* __restrict__ Xp, const T* __restrict__ Up,
    const T* __restrict__ lamp, const T* __restrict__ nusp,
    const T* __restrict__ pxp, const T* __restrict__ pyp,
    const T* __restrict__ ts, const T* __restrict__ sfs,
    const T* __restrict__ xsp, const T* __restrict__ usp,
    const T* __restrict__ dp, const T* __restrict__ um1p,
    const T* __restrict__ lamyp, T* __restrict__ Hp, T* __restrict__ gcp,
    T* __restrict__ Ap, T* __restrict__ Bp, T* __restrict__ Ep,
    T* __restrict__ ivalp, T* __restrict__ dvalp, long long L, int N,
    int Bsz) {
  using V = Dual2<T, NZ>;
  const long long l = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (l >= L) return;
  const int b = (int)(l / N);
  const long long l0 = (long long)b * N;
  const double sxa[NXA] = MPC_SXA;
  const double su[NU] = MPC_SU;

  // z in user units, its tangents with respect to the scaled z
  V x[NX], u[NU];
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    x[i] = V(Xp[i * L + l] * T(sxa[i]));
    x[i].d[i] = T(sxa[i]);
  }
#pragma unroll
  for (int i = 0; i < NU; ++i) {
    u[i] = V(Up[i * L + l] * T(su[i]));
    u[i].d[NX + i] = T(su[i]);
  }
  T px[NPX_A], py[NPY_A], py0[NPY_A], d[ND_A], xs[NX], us[NU], um1[NU],
      lamy[NLAM_A];
#pragma unroll
  for (int i = 0; i < MPC_NPX; ++i) px[i] = pxp[i * L + l];
#pragma unroll
  for (int i = 0; i < MPC_NPY; ++i) {
    py[i] = pyp[i * L + l];
    py0[i] = pyp[i * L + l0];
  }
#pragma unroll
  for (int i = 0; i < MPC_ND; ++i) d[i] = dp[(long long)i * Bsz + b];
#pragma unroll
  for (int i = 0; i < NX; ++i) xs[i] = xsp[(long long)i * Bsz + b];
#pragma unroll
  for (int i = 0; i < NU; ++i) {
    us[i] = usp[(long long)i * Bsz + b];
    um1[i] = um1p[(long long)i * Bsz + b];
  }
#pragma unroll
  for (int i = 0; i < MPC_NLAM; ++i) lamy[i] = lamyp[(long long)i * Bsz + b];
  const T t = ts[b];
  const T sf = sfs[b];

  // the stage cost: gc, and the first term of H
  T hacc[NP];
  {
    V c[1];
    mpc_cost<V, T>(x, u, t, xs, us, d, um1, lamy, py, py0, c);
#pragma unroll
    for (int i = 0; i < NZ; ++i) gcp[(long long)i * L + l] = sf * c[0].d[i];
#pragma unroll
    for (int p = 0; p < NP; ++p) hacc[p] = sf * c[0].h[p];
  }

#if MPC_NI > 0
  // the inequality rows over their scales: ival, E and their H term
  {
    const double si[NI] = MPC_SI;
    V g[NI];
    mpc_ineq<V, T>(x, u, t, xs, us, d, um1, lamy, py, py0, g);
#pragma unroll
    for (int k = 0; k < NI; ++k) {
      const T s = T(si[k]);
      ivalp[(long long)k * L + l] = g[k].v / s;
#pragma unroll
      for (int j = 0; j < NZ; ++j) Ep[(long long)(k * NZ + j) * L + l] = g[k].d[j] / s;
#if MPC_EXACT
      const T nu_k = nusp[(long long)k * L + l];
#pragma unroll
      for (int p = 0; p < NP; ++p) hacc[p] = hacc[p] + nu_k * (g[k].h[p] / s);
#endif
    }
  }
#endif

  // the one-interval map: RK4 sub-steps on the guarded state, the terms
  T tv = t;
  const T dt = T(MPC_DT), dt2 = T(MPC_DT2), dt6 = T(MPC_DT6);
  for (int s = 0; s < MPC_MX; ++s) {
    // k the slopes of one RK4 stage, ks their running weighted sum
    // ((k1 + 2 k2) + 2 k3) + k4, the association of the plain version
    V k[NX], ks[NX], xt[NX];
    eval_rhs<V, T>(x, tv, u, d, px, k);
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      ks[i] = k[i];
      xt[i] = x[i] + dt2 * k[i];
    }
    eval_rhs<V, T>(xt, tv + dt2, u, d, px, k);
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      ks[i] = ks[i] + T(2) * k[i];
      xt[i] = x[i] + dt2 * k[i];
    }
    eval_rhs<V, T>(xt, tv + dt2, u, d, px, k);
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      ks[i] = ks[i] + T(2) * k[i];
      xt[i] = x[i] + dt * k[i];
    }
    eval_rhs<V, T>(xt, tv + dt, u, d, px, k);
#pragma unroll
    for (int i = 0; i < NX; ++i) x[i] = x[i] + dt6 * (ks[i] + k[i]);
    tv = tv + dt;
  }
  mpc_terms<V, T>(x, d, px);

#pragma unroll
  for (int i = 0; i < NXA; ++i) {
    const T s = T(sxa[i]);
    dvalp[(long long)i * L + l] = x[i].v / s;
#pragma unroll
    for (int j = 0; j < NXA; ++j) Ap[(long long)(i * NXA + j) * L + l] = x[i].d[j] / s;
#pragma unroll
    for (int j = 0; j < NU; ++j) Bp[(long long)(i * NU + j) * L + l] = x[i].d[NXA + j] / s;
#if MPC_EXACT
    const T lam_i = lamp[(long long)i * L + l];
#pragma unroll
    for (int p = 0; p < NP; ++p) hacc[p] = hacc[p] + lam_i * (x[i].h[p] / s);
#endif
  }

  int p = 0;
#pragma unroll
  for (int i = 0; i < NZ; ++i) {
#pragma unroll
    for (int j = i; j < NZ; ++j, ++p) {
      Hp[(long long)(i * NZ + j) * L + l] = hacc[p];
      Hp[(long long)(j * NZ + i) * L + l] = hacc[p];
    }
  }
}

template <class T>
int launch(const void* X, const void* U, const void* lam, const void* nus,
           const void* px, const void* py, const void* ts, const void* sfs,
           const void* xs, const void* us, const void* ds, const void* um1,
           const void* lamy, void* H, void* gc, void* A, void* B, void* E,
           void* ival, void* dval, long long L, int N, int Bsz, void* stream) {
  if (L <= 0) return 0;
  const int threads = 128;
  const long long blocks = (L + threads - 1) / threads;
  stage_sweep_kernel<T><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const T*)X, (const T*)U, (const T*)lam, (const T*)nus, (const T*)px,
      (const T*)py, (const T*)ts, (const T*)sfs, (const T*)xs, (const T*)us,
      (const T*)ds, (const T*)um1, (const T*)lamy, (T*)H, (T*)gc, (T*)A,
      (T*)B, (T*)E, (T*)ival, (T*)dval, L, N, Bsz);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int stage_sweep_f32(
    const void* X, const void* U, const void* lam, const void* nus,
    const void* px, const void* py, const void* ts, const void* sfs,
    const void* xs, const void* us, const void* ds, const void* um1,
    const void* lamy, void* H, void* gc, void* A, void* B, void* E,
    void* ival, void* dval, long long L, int N, int Bsz, void* stream) {
  return launch<float>(X, U, lam, nus, px, py, ts, sfs, xs, us, ds, um1, lamy,
                       H, gc, A, B, E, ival, dval, L, N, Bsz, stream);
}

extern "C" int stage_sweep_f64(
    const void* X, const void* U, const void* lam, const void* nus,
    const void* px, const void* py, const void* ts, const void* sfs,
    const void* xs, const void* us, const void* ds, const void* um1,
    const void* lamy, void* H, void* gc, void* A, void* B, void* E,
    void* ival, void* dval, long long L, int N, int Bsz, void* stream) {
  return launch<double>(X, U, lam, nus, px, py, ts, sfs, xs, us, ds, um1, lamy,
                        H, gc, A, B, E, ival, dval, L, N, Bsz, stream);
}
