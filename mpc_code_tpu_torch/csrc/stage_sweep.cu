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
// triangle.  Inputs are planes with lanes innermost; outputs are the
// solver's contiguous (B, N, ...) tensors, lane l = b * N + n: H (L, NZ,
// NZ), gc (L, NZ), A (L, NXA, NXA), B (L, NXA, NU), E (L, NI, NZ), ival
// (L, NI), dval (L, NXA), which the Riccati kernel reads as they are.
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
// 1 + NZ + NZ(NZ+1)/2 components (21 for the CSTR: ~45 kFLOP a lane at
// MPC_MX = 10).  The design:
// - second-order forward-mode numbers (Dual2) carry in one pass what the
//   TPU kernel's jax.hessian, jacfwd and grad traces compute; a quotient
//   takes one reciprocal, and the output scalings multiply by reciprocals
//   of the literal scales, so a lane runs a handful of divisions per
//   right-hand side instead of one per component;
// - the cost and the rows are evaluated first and folded into H's
//   accumulator; across an RK4 sub-step only the state, the running sum of
//   the slopes and the current stage point (clipped in place, then
//   replaced by its slope) are live;
// - in f64 a lane is split over SPLIT = 2 threads, in two warps of one
//   block so that no warp diverges: each keeps the value and every
//   first-order tangent, and one half of the second-order triangle and of
//   H's accumulator (dual2.cuh); the running sum and H's accumulator, live
//   across the sub-steps but touched a few times each, sit in shared
//   memory (51 KB a 128-thread block).
//   So the f64 build holds its live set in registers; f32 runs one thread
//   per lane, all in registers;
// - nothing touches device memory between loading the inputs and writing
//   the outputs; a warp's stores of one output row hit NZ*NZ-strided
//   addresses, which the L2 merges: the kernel moves ~60 values a lane
//   against ~45 kFLOP.
// Tensor cores stay out: the work is a per-lane scalar recurrence with
// 5-wide outer products, and TF32 would break the f32 tolerance.

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
constexpr int THREADS = 128;
static_assert(NX == NXA, "the augmented state is not lowered by this kernel");

// threads per lane, and whether the running RK4 sum and H's accumulator
// live in shared memory
template <class T> struct Layout { static constexpr int SPLIT = 1; static constexpr bool SMEM = false; };
template <> struct Layout<double> { static constexpr int SPLIT = 2; static constexpr bool SMEM = true; };
static_assert(THREADS % (32 * Layout<double>::SPLIT) == 0, "a lane's parts share a block");

// the slice [H0, H0 + HN) of the triangle that part PART of S keeps
template <int S, int PART> struct Slice {
  static constexpr int LEN = (NP + S - 1) / S;
  static constexpr int H0 = PART * LEN;
  static constexpr int HN = NP - H0 < LEN ? NP - H0 : LEN;
};

// Shared memory of a block: the running RK4 sums and H's accumulators of
// its threads, where Layout<T>::SMEM keeps them there.  Addressed by
// element offsets into this array, so every access is a shared-memory
// access with 32-bit addressing.
extern __shared__ __align__(16) unsigned char smem_raw[];

// N values of one thread: registers, or a column of shared memory starting
// at element `at` (value q of thread t at at + q * THREADS + t, conflict-free)
template <class T, int N, bool SMEM> struct Vals {
  T v[N];
  __device__ __forceinline__ explicit Vals(int) {}
  __device__ __forceinline__ T& operator[](int q) { return v[q]; }
};
template <class T, int N> struct Vals<T, N, true> {
  int at;
  __device__ __forceinline__ explicit Vals(int first) : at(first + threadIdx.x) {}
  __device__ __forceinline__ T& operator[](int q) {
    return reinterpret_cast<T*>(smem_raw)[at + q * THREADS];
  }
};

// The running RK4 sum of NX numbers, component by component in Vals.
template <class T, class V, bool SMEM> struct Sum {
  static constexpr int W = 1 + NZ + V::NH;   // components of one number
  Vals<T, NX * W, SMEM> c;
  __device__ __forceinline__ explicit Sum(int first) : c(first) {}
  __device__ __forceinline__ void set(int i, const V& a) {
    c[i * W] = a.v;
#pragma unroll
    for (int j = 0; j < NZ; ++j) c[i * W + 1 + j] = a.d[j];
#pragma unroll
    for (int j = 0; j < V::NH; ++j) c[i * W + 1 + NZ + j] = a.h[j];
  }
  __device__ __forceinline__ V get(int i) {
    V a;
    a.v = c[i * W];
#pragma unroll
    for (int j = 0; j < NZ; ++j) a.d[j] = c[i * W + 1 + j];
#pragma unroll
    for (int j = 0; j < V::NH; ++j) a.h[j] = c[i * W + 1 + NZ + j];
    return a;
  }
  __device__ __forceinline__ void add(int i, const V& a) { set(i, get(i) + a); }
};

// One lane's work, for the triangle slice [H0, H0 + HN).  The part that
// holds entry 0 (H0 == 0) also writes the first-order outputs.
// Stage planes X (NXA, L), U (NU, L), lam (NXA, L), nus (NI, L), px (NPX, L),
// py (NPY, L); stage 0's py (lane b * N) is py0.  Per scenario: ts, sfs
// (B,), xs (NX, B), us (NU, B), ds (ND, B), um1 (NU, B), lamy (NLAM, B).
template <class T, int H0, int HN, bool SMEM>
__device__ __forceinline__ void lane_sweep(
    long long l, long long L, int N, int Bsz,
    const T* __restrict__ Xp, const T* __restrict__ Up,
    const T* __restrict__ lamp, const T* __restrict__ nusp,
    const T* __restrict__ pxp, const T* __restrict__ pyp,
    const T* __restrict__ ts, const T* __restrict__ sfs,
    const T* __restrict__ xsp, const T* __restrict__ usp,
    const T* __restrict__ dp, const T* __restrict__ um1p,
    const T* __restrict__ lamyp, T* __restrict__ Hp, T* __restrict__ gcp,
    T* __restrict__ Ap, T* __restrict__ Bp, T* __restrict__ Ep,
    T* __restrict__ ivalp, T* __restrict__ dvalp) {
  using V = Dual2<T, NZ, H0, HN>;
  constexpr bool FIRST = H0 == 0;
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
  using S = Sum<T, V, SMEM>;
  S ks(0);
  Vals<T, HN, SMEM> hacc(NX * S::W * THREADS);
  {
    V c[1];
    mpc_cost<V, T>(x, u, t, xs, us, d, um1, lamy, py, py0, c);
    if (FIRST) {
#pragma unroll
      for (int i = 0; i < NZ; ++i) gcp[l * NZ + i] = sf * c[0].d[i];
    }
#pragma unroll
    for (int q = 0; q < HN; ++q) hacc[q] = sf * c[0].h[q];
  }

#if MPC_NI > 0
  // the inequality rows over their scales: ival, E and their H term
  {
    const double si[NI] = MPC_SI;
    V g[NI];
    mpc_ineq<V, T>(x, u, t, xs, us, d, um1, lamy, py, py0, g);
#pragma unroll
    for (int k = 0; k < NI; ++k) {
      const T w = T(1.0 / si[k]);
      if (FIRST) {
        ivalp[l * NI + k] = g[k].v * w;
#pragma unroll
        for (int j = 0; j < NZ; ++j) Ep[(l * NI + k) * NZ + j] = g[k].d[j] * w;
      }
#if MPC_EXACT
      const T nu_k = nusp[(long long)k * L + l];
#pragma unroll
      for (int q = 0; q < HN; ++q) hacc[q] = hacc[q] + nu_k * (g[k].h[q] * w);
#endif
    }
  }
#endif

  // the one-interval map: RK4 sub-steps on the guarded state, the terms.
  // xt is the stage point, clipped in place, then its slope; ks the running
  // weighted sum ((k1 + 2 k2) + 2 k3) + k4, the association of the plain
  // version.
  T tv = t;
  const T dt = T(MPC_DT), dt2 = T(MPC_DT2), dt6 = T(MPC_DT6);
  for (int s = 0; s < MPC_MX; ++s) {
    V xt[NX], k[NX];
#pragma unroll
    for (int i = 0; i < NX; ++i) xt[i] = x[i];
    mpc_clip<V, T>(xt, xt);
    mpc_rhs<V, T>(xt, tv, u, d, px, k);
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      ks.set(i, k[i]);
      xt[i] = x[i] + dt2 * k[i];
    }
    mpc_clip<V, T>(xt, xt);
    mpc_rhs<V, T>(xt, tv + dt2, u, d, px, k);
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      ks.add(i, T(2) * k[i]);
      xt[i] = x[i] + dt2 * k[i];
    }
    mpc_clip<V, T>(xt, xt);
    mpc_rhs<V, T>(xt, tv + dt2, u, d, px, k);
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      ks.add(i, T(2) * k[i]);
      xt[i] = x[i] + dt * k[i];
    }
    mpc_clip<V, T>(xt, xt);
    mpc_rhs<V, T>(xt, tv + dt, u, d, px, k);
#pragma unroll
    for (int i = 0; i < NX; ++i) x[i] = x[i] + dt6 * (ks.get(i) + k[i]);
    tv = tv + dt;
  }
  // px again for the terms, loaded here so that it is not live across the
  // sub-steps when the ODE does not read it
  T pxe[NPX_A];
#pragma unroll
  for (int i = 0; i < MPC_NPX; ++i) pxe[i] = pxp[i * L + l];
  mpc_terms<V, T>(x, d, pxe);

#pragma unroll
  for (int i = 0; i < NXA; ++i) {
    const T w = T(1.0 / sxa[i]);
    if (FIRST) {
      dvalp[l * NXA + i] = x[i].v * w;
#pragma unroll
      for (int j = 0; j < NXA; ++j) Ap[(l * NXA + i) * NXA + j] = x[i].d[j] * w;
#pragma unroll
      for (int j = 0; j < NU; ++j) Bp[(l * NXA + i) * NU + j] = x[i].d[NXA + j] * w;
    }
#if MPC_EXACT
    const T lam_i = lamp[(long long)i * L + l];
#pragma unroll
    for (int q = 0; q < HN; ++q) hacc[q] = hacc[q] + lam_i * (x[i].h[q] * w);
#endif
  }

  T* Hl = Hp + l * NZ * NZ;
  MPC_TRI_FOR(NZ, H0, HN, {
    Hl[i * NZ + j] = hacc[q];
    Hl[j * NZ + i] = hacc[q];
  });
}

// Thread t of a block: warp w = t / 32 works on lanes 32 * (w / SPLIT) + t % 32
// of the block's THREADS / SPLIT lanes, as part w % SPLIT of each.
template <class T>
__global__ void __launch_bounds__(THREADS) stage_sweep_kernel(
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
  constexpr int S = Layout<T>::SPLIT;
  constexpr bool SM = Layout<T>::SMEM;
  const int warp = threadIdx.x / 32, part = warp % S;
  const long long l = blockIdx.x * (long long)(THREADS / S) + (warp / S) * 32 +
                      threadIdx.x % 32;
  if (l >= L) return;
#define MPC_SWEEP_ARGS                                                          \
  l, L, N, Bsz, Xp, Up, lamp, nusp, pxp, pyp, ts, sfs, xsp, usp, dp, um1p, \
      lamyp, Hp, gcp, Ap, Bp, Ep, ivalp, dvalp
  if (part == 0) {
    lane_sweep<T, Slice<S, 0>::H0, Slice<S, 0>::HN, SM>(MPC_SWEEP_ARGS);
  } else {
    if constexpr (S > 1)
      lane_sweep<T, Slice<S, 1>::H0, Slice<S, 1>::HN, SM>(MPC_SWEEP_ARGS);
  }
#undef MPC_SWEEP_ARGS
}

// shared memory of a block: its threads' running sums and H accumulators,
// if kept there
template <class T>
constexpr int smem_bytes() {
  constexpr int LEN = Slice<Layout<T>::SPLIT, 0>::LEN;
  return Layout<T>::SMEM ? THREADS * (NX * (1 + NZ + LEN) + LEN) * (int)sizeof(T) : 0;
}

template <class T>
int launch(const void* X, const void* U, const void* lam, const void* nus,
           const void* px, const void* py, const void* ts, const void* sfs,
           const void* xs, const void* us, const void* ds, const void* um1,
           const void* lamy, void* H, void* gc, void* A, void* B, void* E,
           void* ival, void* dval, long long L, int N, int Bsz, void* stream) {
  static_assert(Layout<T>::SPLIT <= 2, "the kernel dispatches two parts at most");
  if (L <= 0) return 0;
  constexpr int smem = smem_bytes<T>();
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        stage_sweep_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long lanes = THREADS / Layout<T>::SPLIT;
  const long long blocks = (L + lanes - 1) / lanes;
  stage_sweep_kernel<T><<<(unsigned)blocks, THREADS, smem, (cudaStream_t)stream>>>(
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
