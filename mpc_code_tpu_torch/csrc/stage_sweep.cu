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
// where dyn is the one-interval step of the state over the state scales,
// then the u_prev slots, c the stage cost and ineq the output rows over
// their scales.  The step is one of three kinds (MPC_KIND):
// - MPC_KIND_RK4: MPC_MX RK4 sub-steps of the guarded ODE, plus Bd d and px;
// - MPC_KIND_MAP: the user's discrete map, plus Bd d and px;
// - MPC_KIND_CF: ContForm, MPC_MX RK4 sub-steps of the ODE together with
//   the quadrature of the stage cost, which is c.
// With the u_prev augmentation (MPC_NUP = nu slots after the state) the
// step copies u into those slots: dval's tail is u, A's u_prev columns and
// rows are zero, B's tail an identity block scaled by su / sxa, and the
// slots add nothing to H beyond the cost's and the rows' terms.  H is
// written symmetric from the upper triangle.  Inputs are planes with lanes
// innermost; outputs are the solver's contiguous (B, N, ...) tensors, lane
// l = b * N + n: H (L, NZ, NZ), gc (L, NZ), A (L, NXA, NXA), B (L, NXA,
// NU), E (L, NI, NZ), ival (L, NI), dval (L, NXA), which the Riccati
// kernel reads as they are.
//
// The OCP is not fixed here: mpc_code_tpu_torch/solver/sweep_kernel.py
// lowers the user's step functions, stage cost and rows to scalar
// statements and writes mpc_stage_gen.cuh (mpc_rhs and mpc_clip, mpc_map,
// or mpc_ode and mpc_quad; mpc_terms, mpc_cost, mpc_ineq; the MPC_*
// dimensions, steps and scales as literals) into the build directory, the
// role that the per-stage Pallas traces play for the TPU kernel.
//
// What bounds it on the H100: arithmetic.  A lane reads 2*NXA+NU+NI+NPX+NPY
// values (~15 for the CSTR) and writes NZ*NZ+NZ+NXA*(NXA+NU)+NI*(NZ+1)+NXA
// (~60), while it runs its step on numbers of 1 + NZM + NZM(NZM+1)/2
// components, NZM = NX + NU (21 for the CSTR: ~45 kFLOP a lane at
// MPC_MX = 10).  The design:
// - second-order forward-mode numbers (Dual2) carry in one pass what the
//   TPU kernel's jax.hessian, jacfwd and grad traces compute; a quotient
//   takes one reciprocal, and the output scalings multiply by reciprocals
//   of the literal scales, so a lane runs a handful of divisions per
//   right-hand side instead of one per component;
// - the tangents are ordered (u_prev, x, u) inside the kernel, so the
//   step, which reads x and u alone, runs on numbers with NZM tangents
//   whose second-order block is the tail of the packed triangle
//   (dual2.cuh's rows); the outputs are written in the solver's order
//   (x, u_prev, u);
// - the cost and the rows are evaluated first and folded into H's
//   accumulator; across an RK4 sub-step only the state, the running sum of
//   the slopes and the current stage point (clipped in place, then
//   replaced by its slope) are live;
// - in f64 a lane is split over SPLIT = 2 threads, in two warps of one
//   block so that no warp diverges: each keeps the value and every
//   first-order tangent, and one half of the second-order triangle and of
//   H's accumulator (dual2.cuh); the running sum and H's accumulator,
//   live across the sub-steps but touched a few times each, sit in shared
//   memory (51 KB a 128-thread block for the CSTR).  f32 runs one thread
//   per lane.  At the quadruple tank's width (nz = 10, a map of 20
//   straight-line right-hand sides) both spill;
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
constexpr int NUP = MPC_NUP;
constexpr int NXA = MPC_NXA;
constexpr int NU = MPC_NU;
constexpr int NZ = MPC_NXA + MPC_NU;
constexpr int NZM = MPC_NX + MPC_NU;        // the step's tangents: x and u
constexpr int NI = MPC_NI;
constexpr int NP = NZ * (NZ + 1) / 2;
constexpr int NPM = NZM * (NZM + 1) / 2;
constexpr int OFF = NP - NPM;                // the step's block: the triangle's tail
constexpr bool CF = MPC_KIND == MPC_KIND_CF;
// the step needs second-order tangents: for lam's terms, or for ContForm's
// quadrature, which is the cost
constexpr bool STEP2 = MPC_EXACT || CF;
// running RK4 sums: the state's, and the quadrature's under ContForm
constexpr int NR = MPC_KIND == MPC_KIND_MAP ? 0 : NX + (CF ? 1 : 0);
constexpr int NPX_A = MPC_NPX > 0 ? MPC_NPX : 1;
constexpr int NPY_A = MPC_NPY > 0 ? MPC_NPY : 1;
constexpr int ND_A = MPC_ND > 0 ? MPC_ND : 1;
constexpr int NLAM_A = MPC_NLAM > 0 ? MPC_NLAM : 1;
constexpr int THREADS = 128;
static_assert(NXA == NX + NUP, "the augmented state is the state and u_prev");
static_assert(!CF || NUP == 0, "ContForm carries no u_prev");

// The solver's index of the kernel's tangent q: the kernel orders z as
// (u_prev, x, u), the solver as (x, u_prev, u).
__host__ __device__ constexpr int ext(int q) {
  return q < NUP ? NX + q : (q < NXA ? q - NUP : q);
}

// threads per lane, and whether the running RK4 sums and H's accumulator
// live in shared memory.  Each part is a copy of the lane's code that nvcc
// compiles: at the quadruple tank's width a split over 4 threads took 310 s
// to build and still spilled (chip_variants.py k5build).
template <class T> struct Layout { static constexpr int SPLIT = 1; static constexpr bool SMEM = false; };
template <> struct Layout<double> { static constexpr int SPLIT = 2; static constexpr bool SMEM = true; };
static_assert(THREADS % (32 * Layout<double>::SPLIT) == 0, "a lane's parts share a block");

// the slice [H0, H0 + HN) of the triangle that part PART of S keeps
template <int S, int PART> struct Slice {
  static constexpr int LEN = (NP + S - 1) / S;
  static constexpr int H0 = PART * LEN;
  static constexpr int HN = NP - H0 < LEN ? NP - H0 : LEN;
};

// The step's share of the slice [H0, H0 + HN): the entries [A, A + N) of
// the whole triangle, the entries [H0M, H0M + N) of the step's own.  A
// part with no share (or a build without the step's second order) keeps
// one entry of the step's triangle that it does not fold into H.
template <int H0, int HN> struct StepSlice {
  static constexpr int A = H0 > OFF ? H0 : OFF;
  static constexpr int N = STEP2 && H0 + HN > A ? H0 + HN - A : 0;
  static constexpr int H0M = N ? A - OFF : 0;
  static constexpr int HNM = N ? N : 1;
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

// R running RK4 sums, component by component in Vals.
template <class T, class V, int R, bool SMEM> struct Sum {
  static constexpr int W = 1 + V::NT + V::NH;   // components of one number
  Vals<T, (R > 0 ? R : 1) * W, SMEM> c;
  __device__ __forceinline__ explicit Sum(int first) : c(first) {}
  __device__ __forceinline__ void set(int i, const V& a) {
    c[i * W] = a.v;
#pragma unroll
    for (int j = 0; j < V::NT; ++j) c[i * W + 1 + j] = a.d[j];
#pragma unroll
    for (int j = 0; j < V::NH; ++j) c[i * W + 1 + V::NT + j] = a.h[j];
  }
  __device__ __forceinline__ V get(int i) {
    V a;
    a.v = c[i * W];
#pragma unroll
    for (int j = 0; j < V::NT; ++j) a.d[j] = c[i * W + 1 + j];
#pragma unroll
    for (int j = 0; j < V::NH; ++j) a.h[j] = c[i * W + 1 + V::NT + j];
    return a;
  }
  __device__ __forceinline__ void add(int i, const V& a) { set(i, get(i) + a); }
};

// The kernel's operands.  Stage planes X (NXA, L), U (NU, L), lam (NXA, L),
// nus (NI, L), px (NPX, L), py (NPY, L); stage 0's py (lane b * N) is py0.
// Per scenario: ts, sfs (B,), xs (NX, B), us (NU, B), ds (ND, B), um1
// (NU, B), lamy (NLAM, B).
template <class T> struct Operands {
  const T *X, *U, *lam, *nus, *px, *py, *ts, *sfs, *xs, *us, *ds, *um1, *lamy;
  T *H, *gc, *A, *B, *E, *ival, *dval;
  long long L;
  int N, Bsz;
};

// The step from (x, u), in place on x: RK4 sub-steps of the guarded ODE,
// the map, or ContForm's joint rollout with the quadrature in acc (the
// terms come after it).  ks holds the running weighted sums ((k1 + 2 k2) + 2 k3) + k4,
// the association of the plain version; xt the stage point, clipped in
// place, then its slope.
template <class T, class VM, bool SMEM>
__device__ __forceinline__ void step(VM* x, const VM* u, VM& acc, T t, const T* d,
                                     const T* px, const T* xs, const T* us,
                                     const T* py) {
#if MPC_KIND == MPC_KIND_MAP
  VM xn[NX];
  mpc_map<VM, T>(x, u, d, t, px, xn);
#pragma unroll
  for (int i = 0; i < NX; ++i) x[i] = xn[i];
#else
  Sum<T, VM, NR, SMEM> ks(0);
  T tv = t;
  const T dt = T(MPC_DT), dt2 = T(MPC_DT2), dt6 = T(MPC_DT6);
  for (int s = 0; s < MPC_MX; ++s) {
    VM xt[NX], k[NX];
#pragma unroll
    for (int i = 0; i < NX; ++i) xt[i] = x[i];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const T tr = r == 0 ? tv : (r == 3 ? tv + dt : tv + dt2);
#if MPC_KIND == MPC_KIND_CF
      VM q[1];
      mpc_ode<VM, T>(xt, tr, u, d, px, xs, us, py, k);
      mpc_quad<VM, T>(xt, tr, u, d, px, xs, us, py, q);
      if (r == 0) ks.set(NX, q[0]);
      else if (r < 3) ks.add(NX, T(2) * q[0]);
      else acc = acc + dt6 * (ks.get(NX) + q[0]);
#else
      mpc_clip<VM, T>(xt, xt);
      mpc_rhs<VM, T>(xt, tr, u, d, px, k);
#endif
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        if (r == 0) ks.set(i, k[i]);
        else if (r < 3) ks.add(i, T(2) * k[i]);
        if (r < 3) xt[i] = x[i] + (r < 2 ? dt2 : dt) * k[i];
        else x[i] = x[i] + dt6 * (ks.get(i) + k[i]);
      }
    }
    tv = tv + dt;
  }
#endif
}

// One lane's work, for the triangle slice [H0, H0 + HN).  The part that
// holds entry 0 (H0 == 0) also writes the first-order outputs.
template <class T, int H0, int HN, bool SMEM>
__device__ __forceinline__ void lane_sweep(const Operands<T>& o, long long l) {
  using V = Dual2<T, NZ, H0, HN>;
  using SS = StepSlice<H0, HN>;
  using VM = Dual2<T, NZM, SS::H0M, SS::HNM>;
  constexpr bool FIRST = H0 == 0;
  const long long L = o.L;
  const int b = (int)(l / o.N);
  const long long l0 = (long long)b * o.N;
  const bool k0 = l == l0;
  const int Bsz = o.Bsz;
  const double sxa[NXA] = MPC_SXA;
  const double su[NU] = MPC_SU;

  // z in user units
  T xv[NXA], uv[NU];
#pragma unroll
  for (int i = 0; i < NXA; ++i) xv[i] = o.X[i * L + l] * T(sxa[i]);
#pragma unroll
  for (int i = 0; i < NU; ++i) uv[i] = o.U[i * L + l] * T(su[i]);
  T px[NPX_A], py[NPY_A], py0[NPY_A], d[ND_A], xs[NX], us[NU], um1[NU],
      lamy[NLAM_A];
#pragma unroll
  for (int i = 0; i < MPC_NPX; ++i) px[i] = o.px[i * L + l];
#pragma unroll
  for (int i = 0; i < MPC_NPY; ++i) {
    py[i] = o.py[i * L + l];
    py0[i] = o.py[i * L + l0];
  }
#pragma unroll
  for (int i = 0; i < MPC_ND; ++i) d[i] = o.ds[(long long)i * Bsz + b];
#pragma unroll
  for (int i = 0; i < NX; ++i) xs[i] = o.xs[(long long)i * Bsz + b];
#pragma unroll
  for (int i = 0; i < NU; ++i) {
    us[i] = o.us[(long long)i * Bsz + b];
    um1[i] = o.um1[(long long)i * Bsz + b];
  }
#pragma unroll
  for (int i = 0; i < MPC_NLAM; ++i) lamy[i] = o.lamy[(long long)i * Bsz + b];
  const T t = o.ts[b];
  const T sf = o.sfs[b];

  // H's accumulator, after the running sums in shared memory
  Vals<T, HN, SMEM> hacc(NR * Sum<T, VM, NR, SMEM>::W * THREADS);
  {
    // the cost and the rows on z with all NZ tangents, with respect to
    // the scaled z, in the kernel's order (u_prev, x, u)
    V xa[NXA], u[NU];
#pragma unroll
    for (int i = 0; i < NXA; ++i) {
      xa[i] = V(xv[i]);
      xa[i].d[i < NX ? NUP + i : i - NX] = T(sxa[i]);
    }
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      u[i] = V(uv[i]);
      u[i].d[NXA + i] = T(su[i]);
    }
#if MPC_KIND == MPC_KIND_CF
#pragma unroll
    for (int q = 0; q < HN; ++q) hacc[q] = T(0);
#else
    // the stage cost: gc, and the first term of H
    V c[1];
    mpc_cost<V, T>(xa, u, t, xs, us, d, um1, lamy, py, py0, k0, c);
    if (FIRST) {
#pragma unroll
      for (int q = 0; q < NZ; ++q) o.gc[l * NZ + ext(q)] = sf * c[0].d[q];
    }
#pragma unroll
    for (int q = 0; q < HN; ++q) hacc[q] = sf * c[0].h[q];
#endif
#if MPC_NI > 0
    // the inequality rows over their scales: ival, E and their H term
    const double si[NI] = MPC_SI;
    V g[NI];
    mpc_ineq<V, T>(xa, u, t, xs, us, d, um1, lamy, py, py0, k0, g);
#pragma unroll
    for (int k = 0; k < NI; ++k) {
      const T w = T(1.0 / si[k]);
      if (FIRST) {
        o.ival[l * NI + k] = g[k].v * w;
#pragma unroll
        for (int q = 0; q < NZ; ++q) o.E[(l * NI + k) * NZ + ext(q)] = g[k].d[q] * w;
      }
#if MPC_EXACT
      const T nu_k = o.nus[(long long)k * L + l];
#pragma unroll
      for (int q = 0; q < HN; ++q) hacc[q] = hacc[q] + nu_k * (g[k].h[q] * w);
#endif
    }
#endif
  }

  // the step on (x, u) with NZM tangents
  VM x[NX], u[NU], acc(T(0));
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    x[i] = VM(xv[i]);
    x[i].d[i] = T(sxa[i]);
  }
#pragma unroll
  for (int i = 0; i < NU; ++i) {
    u[i] = VM(uv[i]);
    u[i].d[NX + i] = T(su[i]);
  }
  step<T, VM, SMEM>(x, u, acc, t, d, px, xs, us, py);
#if MPC_KIND != MPC_KIND_CF
  {
    // px again for the terms, loaded here so that it is not live across
    // the sub-steps when the ODE does not read it
    T pxe[NPX_A];
#pragma unroll
    for (int i = 0; i < MPC_NPX; ++i) pxe[i] = o.px[i * L + l];
    mpc_terms<VM, T>(x, d, pxe);
  }
#endif

#if MPC_KIND == MPC_KIND_CF
  // the quadrature is the cost: gc, and its term of H
  if (FIRST) {
#pragma unroll
    for (int q = 0; q < NZ; ++q) o.gc[l * NZ + ext(q)] = sf * acc.d[q];
  }
#pragma unroll
  for (int q = 0; q < SS::N; ++q)
    hacc[SS::A - H0 + q] = hacc[SS::A - H0 + q] + sf * acc.h[q];
#endif

  // the state's rows: dval, A (zero in the u_prev columns), B, lam's term
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    const T w = T(1.0 / sxa[i]);
    if (FIRST) {
      o.dval[l * NXA + i] = x[i].v * w;
#pragma unroll
      for (int j = 0; j < NX; ++j) o.A[(l * NXA + i) * NXA + j] = x[i].d[j] * w;
#pragma unroll
      for (int j = NX; j < NXA; ++j) o.A[(l * NXA + i) * NXA + j] = T(0);
#pragma unroll
      for (int j = 0; j < NU; ++j) o.B[(l * NXA + i) * NU + j] = x[i].d[NX + j] * w;
    }
#if MPC_EXACT
    const T lam_i = o.lam[(long long)i * L + l];
#pragma unroll
    for (int q = 0; q < SS::N; ++q)
      hacc[SS::A - H0 + q] = hacc[SS::A - H0 + q] + lam_i * (x[i].h[q] * w);
#endif
  }
  // the u_prev rows: u over the slots' scales, an identity block of B
  if (FIRST) {
#pragma unroll
    for (int k = 0; k < NUP; ++k) {
      const T w = T(1.0 / sxa[NX + k]);
      o.dval[l * NXA + NX + k] = uv[k] * w;
#pragma unroll
      for (int j = 0; j < NXA; ++j) o.A[(l * NXA + NX + k) * NXA + j] = T(0);
#pragma unroll
      for (int j = 0; j < NU; ++j)
        o.B[(l * NXA + NX + k) * NU + j] = j == k ? T(su[k]) * w : T(0);
    }
  }

  T* Hl = o.H + l * NZ * NZ;
  MPC_TRI_FOR(NZ, H0, HN, {
    Hl[ext(i) * NZ + ext(j)] = hacc[q];
    Hl[ext(j) * NZ + ext(i)] = hacc[q];
  });
}

// part PART of S, or the next
template <class T, int S, int PART>
__device__ __forceinline__ void dispatch(int part, const Operands<T>& o, long long l) {
  if constexpr (PART < S) {
    if (part == PART) {
      lane_sweep<T, Slice<S, PART>::H0, Slice<S, PART>::HN, Layout<T>::SMEM>(o, l);
    } else {
      dispatch<T, S, PART + 1>(part, o, l);
    }
  }
}

// Thread t of a block: warp w = t / 32 works on lanes 32 * (w / SPLIT) + t % 32
// of the block's THREADS / SPLIT lanes, as part w % SPLIT of each.
template <class T>
__global__ void __launch_bounds__(THREADS) stage_sweep_kernel(const Operands<T> o) {
  constexpr int S = Layout<T>::SPLIT;
  const int warp = threadIdx.x / 32, part = warp % S;
  const long long l = blockIdx.x * (long long)(THREADS / S) + (warp / S) * 32 +
                      threadIdx.x % 32;
  if (l >= o.L) return;
  dispatch<T, S, 0>(part, o, l);
}

// shared memory of a block: its threads' running sums and H accumulators,
// if kept there
template <class T>
constexpr int smem_bytes() {
  constexpr int LEN = Slice<Layout<T>::SPLIT, 0>::LEN;
  return Layout<T>::SMEM ? THREADS * (NR * (1 + NZM + LEN) + LEN) * (int)sizeof(T) : 0;
}

template <class T>
int launch(const void* X, const void* U, const void* lam, const void* nus,
           const void* px, const void* py, const void* ts, const void* sfs,
           const void* xs, const void* us, const void* ds, const void* um1,
           const void* lamy, void* H, void* gc, void* A, void* B, void* E,
           void* ival, void* dval, long long L, int N, int Bsz, void* stream) {
  if (L <= 0) return 0;
  constexpr int smem = smem_bytes<T>();
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        stage_sweep_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  const Operands<T> o{(const T*)X, (const T*)U, (const T*)lam, (const T*)nus,
                      (const T*)px, (const T*)py, (const T*)ts, (const T*)sfs,
                      (const T*)xs, (const T*)us, (const T*)ds, (const T*)um1,
                      (const T*)lamy, (T*)H, (T*)gc, (T*)A, (T*)B, (T*)E,
                      (T*)ival, (T*)dval, L, N, Bsz};
  const long long lanes = THREADS / Layout<T>::SPLIT;
  const long long blocks = (L + lanes - 1) / lanes;
  stage_sweep_kernel<T><<<(unsigned)blocks, THREADS, smem, (cudaStream_t)stream>>>(o);
  return (int)cudaGetLastError();
}

}  // namespace

// MPC_DTYPE_BITS (a -D of the build), 32 or 64: that dtype's launcher
// alone, so that the two compile in nvcc runs of their own; both without.
#if !defined(MPC_DTYPE_BITS) || MPC_DTYPE_BITS == 32
extern "C" int stage_sweep_f32(
    const void* X, const void* U, const void* lam, const void* nus,
    const void* px, const void* py, const void* ts, const void* sfs,
    const void* xs, const void* us, const void* ds, const void* um1,
    const void* lamy, void* H, void* gc, void* A, void* B, void* E,
    void* ival, void* dval, long long L, int N, int Bsz, void* stream) {
  return launch<float>(X, U, lam, nus, px, py, ts, sfs, xs, us, ds, um1, lamy,
                       H, gc, A, B, E, ival, dval, L, N, Bsz, stream);
}
#endif

#if !defined(MPC_DTYPE_BITS) || MPC_DTYPE_BITS == 64
extern "C" int stage_sweep_f64(
    const void* X, const void* U, const void* lam, const void* nus,
    const void* px, const void* py, const void* ts, const void* sfs,
    const void* xs, const void* us, const void* ds, const void* um1,
    const void* lamy, void* H, void* gc, void* A, void* B, void* E,
    void* ival, void* dval, long long L, int N, int Bsz, void* stream) {
  return launch<double>(X, U, lam, nus, px, py, ts, sfs, xs, us, ds, um1, lamy,
                        H, gc, A, B, E, ival, dval, L, N, Bsz, stream);
}
#endif
