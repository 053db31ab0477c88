// Fused generic stage-derivative sweep for Hopper (sm_90a).
//
// Replaces mpc_code_tpu/solver/sweep_kernel.py::make_stage_sweep (kernel
// body from _get_kernel_impl), the TPU kernel that runs every output of
// make_stage_derivs for all N stages of a batch: the structured IPM's
// derivative sweep on every iteration of a solve without a split dynamics
// sweep.  For each (scenario, stage) lane, at z = (xa, u) in scaled units,
// it computes
//   H    = sf * d2c + sum_i lam_i * d2dyn_i + sum_j nus_j * d2ineq_j
//          + sum_k muh_k * d2eq_k
//          (MPC_EXACT; the first term alone under Gauss-Newton),
//   gc   = sf * dc,
//   A, B = d dyn / d (xa, u), dval = dyn,
//   E    = d ineq / dz, ival = ineq,
//   Cz   = d eq / dz, hval = eq,
// where dyn is the one-interval step of the state over the state scales,
// then the u_prev and slack slots, c the stage cost, ineq the inequality
// rows over their scales and eq the equality rows.  The step is one of
// four kinds (MPC_KIND):
// - MPC_KIND_RK4: MPC_MX RK4 sub-steps of the guarded ODE, plus Bd d and px;
// - MPC_KIND_MAP: a discrete map (the user's, or a linear model's affine
//   step), plus Bd d and px where the map does not add them itself;
// - MPC_KIND_CF: ContForm, MPC_MX RK4 sub-steps of the ODE together with
//   the quadrature of the stage cost, which is c (with the slack penalty,
//   if any, beside it);
// - MPC_KIND_COLL: 2-point Gauss-Legendre collocation: MPC_NEWTON Newton
//   steps on the stage states S = (s1, s2) on values, then one
//   differentiable step around that root, then x + b~'(S - x).  S reaches
//   the cost and the rows, so for this kind the step runs first;
// - MPC_KIND_MHE: the moving-horizon estimator's window, over the
//   augmented state csi = [x; d] and the noise w as the input.  Structured
//   stage n of a scenario reads window stage clip(n - 1, 0, N - 2) of the
//   window planes (measured input, output, time, px, py, mask) and the
//   scenario's x_bar, P_inv and smoothing-correction matrices, row-major,
//   where it stands.  Stage 0 (the arrival stage) maps csi to its input; a
//   pad stage (mask 0) carries csi; every other stage runs the MHE model:
//   MPC_MX RK4 sub-steps of the model state's ODE (or its map, MPC_MHE_MAP)
//   with d and w held, then Bd d, px, d carried and G w (mpc_terms).  The
//   cost and the rows select between the arrival and the stage's terms
//   themselves, both sides evaluated, as the plain version does.
// With the u_prev augmentation (MPC_NUP = nu slots after the state) the
// step copies u into those slots: dval's tail is u, A's u_prev columns and
// rows are zero, B's tail an identity block scaled by su / sxa.  MPC_NS
// shared slacks follow in the state and in the input: the map writes the
// input slots at stage 0 (an identity block of B) and carries the state's
// after it (of A).  Neither adds to H beyond the cost's and the rows'
// terms.  H is written symmetric from the upper triangle.  Inputs are
// planes with lanes innermost; outputs are the solver's contiguous
// (B, N, ...) tensors, lane l = b * N + n: H (L, NZ, NZ), gc (L, NZ), A (L,
// NXA, NXA), B (L, NXA, NU), E (L, NI, NZ), ival (L, NI), dval (L, NXA), Cz
// (L, NEQ, NZ), hval (L, NEQ), which the Riccati kernel reads as they are.
//
// The OCP is not fixed here: mpc_code_tpu_torch/solver/sweep_kernel.py
// lowers the user's step functions, stage cost and rows to scalar
// statements and writes mpc_stage_gen.cuh (mpc_rhs and mpc_clip, mpc_map,
// or mpc_ode and mpc_quad; mpc_terms, mpc_cost, mpc_ineq, mpc_eq; the MPC_*
// dimensions, steps, scales and the collocation tableau as literals) into
// the build directory, the role that the per-stage Pallas traces play for
// the TPU kernel.
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
// - the tangents are ordered (u_prev, slack, slack input, x, u) inside the
//   kernel, so the step, which reads x and u alone, runs on numbers with
//   NZM tangents whose second-order block is the tail of the packed
//   triangle (dual2.cuh's rows); the outputs are written in the solver's
//   order (x, u_prev, slack, u, slack input);
// - the cost and the rows are evaluated first and folded into H's
//   accumulator (after the step for collocation, whose S they read);
//   across an RK4 sub-step only the state, the running sum of the slopes
//   and the current stage point (clipped in place, then replaced by its
//   slope) are live;
// - in f64 a lane is split over SPLIT = 2 threads, in two warps of one
//   block so that no warp diverges: each keeps the value and every
//   first-order tangent, and one half of the second-order triangle and of
//   H's accumulator (dual2.cuh); the running sum and H's accumulator,
//   live across the sub-steps but touched a few times each, sit in shared
//   memory (51 KB a 128-thread block for the CSTR).  f32 runs one thread
//   per lane, and so does collocation in f64 (its implicit step needs the
//   step's whole triangle).  At the quadruple tank's width (nz = 10, a map
//   of 20 straight-line right-hand sides) both spill;
// - collocation's implicit step: the Newton steps run on first-order
//   numbers over S's own tangents (the residual's Jacobian) with an LU
//   solve pivoted on the values; the differentiable step evaluates the ODE
//   at the root on Dual2 numbers over (s, u), which give the Jacobian's
//   values, the residual's derivatives in z and the Jacobian's first
//   derivatives in u, and solves J G = r component by component with the
//   same LU (the second-order rule of a solve); the Jacobian's second
//   derivatives in u times G, a third derivative of the ODE, come from one
//   more evaluation per block at s + eps G on Dual2 numbers over u whose
//   components carry eps's tangent (Dual<T, 1>), so that the step is the
//   exact derivative of S* - J^-1 r however far the Newton steps left the
//   root, as the plain version's;
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
constexpr int NS = MPC_NS;
constexpr int NXA = MPC_NXA;
constexpr int NU = MPC_NU;
constexpr int NUC = MPC_NU - MPC_NS;         // the model's inputs, before the slack slots
constexpr int NZ = MPC_NXA + MPC_NU;
constexpr int NPRE = NUP + 2 * NS;           // tangents the step does not read
constexpr int NZM = NX + NUC;                // the step's tangents: x and u
constexpr int NI = MPC_NI;
constexpr int NEQ = MPC_NEQ;
constexpr int NP = NZ * (NZ + 1) / 2;
constexpr int NPM = NZM * (NZM + 1) / 2;
constexpr int OFF = NP - NPM;                // the step's block: the triangle's tail
constexpr bool CF = MPC_KIND == MPC_KIND_CF;
constexpr bool COLL = MPC_KIND == MPC_KIND_COLL;
#if MPC_KIND == MPC_KIND_MHE
constexpr int NXM = MPC_NXM;                 // the model's state; d follows it, held
constexpr int NUM_A = MPC_NUM > 0 ? MPC_NUM : 1;
constexpr int NYW_A = MPC_NYW > 0 ? MPC_NYW : 1;
constexpr int NCORR_A = MPC_NCORR > 0 ? MPC_NCORR : 1;
static_assert(NX == NUC && NPRE == 0, "the arrival stage maps the input onto the state");
#endif
// the step needs second-order tangents: for lam's terms, for ContForm's
// quadrature, which is the cost, or for the collocation states the cost reads
constexpr bool STEP2 = MPC_EXACT || CF || COLL;
// running RK4 sums: the state's, and the quadrature's under ContForm
#if MPC_KIND == MPC_KIND_MHE
constexpr int NR = MPC_MHE_MAP ? 0 : NXM;
#else
constexpr int NR = (MPC_KIND == MPC_KIND_MAP || COLL) ? 0 : NX + (CF ? 1 : 0);
#endif
constexpr int NPX_A = MPC_NPX > 0 ? MPC_NPX : 1;
constexpr int NPY_A = MPC_NPY > 0 ? MPC_NPY : 1;
constexpr int ND_A = MPC_ND > 0 ? MPC_ND : 1;
constexpr int NLAM_A = MPC_NLAM > 0 ? MPC_NLAM : 1;
constexpr int NUC_A = NUC > 0 ? NUC : 1;
constexpr int THREADS = 128;
static_assert(NXA == NX + NUP + NS, "the augmented state is the state, u_prev and the slacks");
static_assert(!CF || NUP == 0, "ContForm carries no u_prev");

// The solver's index of the kernel's tangent q: the kernel orders z as
// (u_prev, slack, slack input, x, u), the solver as (x, u_prev, slack, u,
// slack input).
__host__ __device__ constexpr int ext(int q) {
  return q < NUP + NS ? NX + q
         : (q < NPRE ? NXA + NUC + (q - NUP - NS)
                     : (q < NPRE + NX ? q - NPRE : NXA + (q - NPRE - NX)));
}
// the kernel's tangent of the solver's state slot i and input slot c
__host__ __device__ constexpr int kx(int i) { return i < NX ? NPRE + i : i - NX; }
__host__ __device__ constexpr int ku(int c) {
  return c < NUC ? NPRE + NX + c : NUP + NS + (c - NUC);
}

// threads per lane, and whether the running RK4 sums and H's accumulator
// live in shared memory.  Each part is a copy of the lane's code that nvcc
// compiles: at the quadruple tank's width a split over 4 threads took 310 s
// to build and still spilled (chip_variants.py k5build).  Collocation's
// implicit step reads the step's whole triangle: one thread a lane.
template <class T> struct Layout { static constexpr int SPLIT = 1; static constexpr bool SMEM = false; };
template <> struct Layout<double> {
  static constexpr int SPLIT = COLL ? 1 : 2;
  static constexpr bool SMEM = !COLL;
};
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
// nus (NI, L), px (NPX, L), py (NPY, L), muh (NEQ, L); stage 0's py (lane
// b * N) is py0.  Per scenario: ts, sfs (B,), xs (NX, B), us (NUC, B), ds
// (ND, B), um1 (NUC, B), lamy (NLAM, B).  An MHE window has X, U, lam, nus
// and sfs of these, and window planes over Lw = B * (N - 1) lanes: um (NUM,
// Lw), yw (NYW, Lw), tw (Lw), pxw (NPX, Lw), pyw (NPY, Lw), mask (Lw); per
// scenario, row-major: xbar (B, NXA), pinv (B, NXA * NXA), obig (B, NCORR *
// NXA), hbig (B, NCORR), pyc (B, NCORR * NCORR).
template <class T> struct Operands {
  const T *X, *U, *lam, *nus, *px, *py, *muh, *ts, *sfs, *xs, *us, *ds, *um1, *lamy;
  T *H, *gc, *A, *B, *E, *ival, *dval, *Cz, *hval;
  long long L;
  int N, Bsz;
  const T *um, *yw, *tw, *pxw, *pyw, *mask, *xbar, *pinv, *obig, *hbig, *pyc;
};

// One lane's point: z in user units and the parameters the stage
// functions read.
template <class T> struct Point {
  T xv[NXA], uv[NU], px[NPX_A], pxs[NPX_A], py[NPY_A], py0[NPY_A], d[ND_A], xs[NX],
      us[NUC_A], um1[NUC_A], lamy[NLAM_A];
  T t, sf;
  bool k0;
#if MPC_KIND == MPC_KIND_MHE
  // the window stage's measured input and output (t, px and py above are
  // its time and parameters), its mask, the smoothing correction's first
  // measurements, and the scenario's rows of the per-lane matrices
  T um[NUM_A], yw[NYW_A], yc[NCORR_A];
  bool mask;
  const T *xbar, *pinv, *obig, *hbig, *pyc;
#endif
};

// The point's arguments of the generated stage cost and rows after (xa, u).
#if MPC_KIND == MPC_KIND_MHE
#define MPC_POINT(S)                                                                      \
  pt.um, pt.yw, pt.t, pt.py, pt.mask, pt.k0, pt.xbar, pt.pinv, pt.yc, pt.obig, pt.hbig, \
      pt.pyc
#else
#define MPC_POINT(S) \
  S, pt.t, pt.xs, pt.us, pt.d, pt.um1, pt.lamy, pt.py, pt.py0, pt.px, pt.k0
#endif

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
#elif MPC_KIND == MPC_KIND_RK4 || MPC_KIND == MPC_KIND_CF
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

#if MPC_KIND == MPC_KIND_MHE
// The MHE model's step from csi = [x; d] and the noise w, in place on csi:
// RK4 sub-steps of the model state's guarded ODE with d and w held (ks the
// running weighted sums ((k1 + 2 k2) + 2 k3) + k4, the association of the
// plain version; xt the stage point, clipped in place, then its slope), or
// the map; then the terms.
template <class T, class VM, bool SMEM>
__device__ __forceinline__ void mhe_step(VM* x, const VM* w, T t, const T* um, const T* px) {
  const VM* d = x + NXM;
#if MPC_MHE_MAP
  VM xn[NXM];
  mpc_map<VM, T>(x, t, w, d, um, px, xn);
#pragma unroll
  for (int i = 0; i < NXM; ++i) x[i] = xn[i];
#else
  Sum<T, VM, NXM, SMEM> ks(0);
  T tv = t;
  const T dt = T(MPC_DT), dt2 = T(MPC_DT2), dt6 = T(MPC_DT6);
  for (int s = 0; s < MPC_MX; ++s) {
    VM xt[NXM], k[NXM];
#pragma unroll
    for (int i = 0; i < NXM; ++i) xt[i] = x[i];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const T tr = r == 0 ? tv : (r == 3 ? tv + dt : tv + dt2);
      mpc_clip<VM, T>(xt, xt);
      mpc_rhs<VM, T>(xt, tr, w, d, um, px, k);
#pragma unroll
      for (int i = 0; i < NXM; ++i) {
        if (r == 0) ks.set(i, k[i]);
        else if (r < 3) ks.add(i, T(2) * k[i]);
        if (r < 3) xt[i] = x[i] + (r < 2 ? dt2 : dt) * k[i];
        else x[i] = x[i] + dt6 * (ks.get(i) + k[i]);
      }
    }
    tv = tv + dt;
  }
#endif
  VM xa[NX];
  mpc_terms<VM, T>(x, d, w, px, xa);
#pragma unroll
  for (int i = 0; i < NX; ++i) x[i] = xa[i];
}
#endif

#if MPC_KIND == MPC_KIND_COLL
constexpr int NC = 2 * NX;                   // the stage states S = (s1, s2)

template <class T> __device__ __forceinline__ T mpc_absv(T a) { return a < T(0) ? -a : a; }

// LU with partial pivoting of a (NC, NC), in place: in each column the row
// of the largest |entry|, the first of equals, as LAPACK's getrf takes it;
// the multipliers are products by the pivot's reciprocal.  The swaps are
// selects over unrolled loops, so that a stays in registers.
template <class T>
__device__ __forceinline__ void lu_factor(T (&a)[NC][NC], int (&piv)[NC]) {
#pragma unroll
  for (int k = 0; k < NC; ++k) {
    int p = k;
    T best = mpc_absv(a[k][k]);
#pragma unroll
    for (int i = k + 1; i < NC; ++i) {
      const T v = mpc_absv(a[i][k]);
      if (v > best) { best = v; p = i; }
    }
    piv[k] = p;
#pragma unroll
    for (int i = k + 1; i < NC; ++i) {
      if (i == p) {
#pragma unroll
        for (int j = 0; j < NC; ++j) { const T w = a[k][j]; a[k][j] = a[i][j]; a[i][j] = w; }
      }
    }
    const T w = T(1) / a[k][k];
#pragma unroll
    for (int i = k + 1; i < NC; ++i) {
      a[i][k] = a[i][k] * w;
#pragma unroll
      for (int j = k + 1; j < NC; ++j) a[i][j] = a[i][j] - a[i][k] * a[k][j];
    }
  }
}

// b <- a^-1 b from lu_factor's factors: the row swaps in order, then the
// unit lower and the upper triangle
template <class T>
__device__ __forceinline__ void lu_solve(const T (&a)[NC][NC], const int (&piv)[NC], T (&b)[NC]) {
#pragma unroll
  for (int k = 0; k < NC; ++k) {
#pragma unroll
    for (int i = k + 1; i < NC; ++i) {
      if (i == piv[k]) { const T w = b[k]; b[k] = b[i]; b[i] = w; }
    }
  }
#pragma unroll
  for (int i = 1; i < NC; ++i) {
#pragma unroll
    for (int j = 0; j < i; ++j) b[i] = b[i] - a[i][j] * b[j];
  }
#pragma unroll
  for (int i = NC - 1; i >= 0; --i) {
#pragma unroll
    for (int j = i + 1; j < NC; ++j) b[i] = b[i] - a[i][j] * b[j];
    b[i] = b[i] / a[i][i];
  }
}

// The collocation step: S (Dual2 over the step's tangents, x with sxa and
// u with su) and x replaced by x + b~'(S - x).  The ODE is the raw model's,
// without a guard, at stage 0's px unless the parameters are stagewise.
// entry (i, j), i <= j, of the step's packed triangle
__host__ __device__ constexpr int tri(int i, int j) { return i * NZM - i * (i - 1) / 2 + (j - i); }

template <class T, class VM>
__device__ __forceinline__ void coll_step(VM* x, const VM* u, VM* S, const Point<T>& pt) {
  static_assert(VM::NH == NPM, "the implicit step keeps the step's whole triangle");
  const T ad[2][2] = MPC_AD;
  const T bt[2] = MPC_BT;
  const T hinv = T(1.0 / MPC_H);
  T Sv[NC], xv[NX], uv[NUC_A];
#pragma unroll
  for (int i = 0; i < NX; ++i) xv[i] = pt.xv[i];
#pragma unroll
  for (int c = 0; c < NUC; ++c) uv[c] = pt.uv[c];
#pragma unroll
  for (int i = 0; i < NX; ++i) Sv[i] = Sv[NX + i] = xv[i];
  T J[NC][NC];
  int piv[NC];
  // the root: Newton steps on values, the Jacobian over S by first-order
  // numbers with S's own tangents
  using D = Dual<T, NX>;
  for (int it = 0; it < MPC_NEWTON; ++it) {
    T r[NC];
#pragma unroll
    for (int blk = 0; blk < 2; ++blk) {
      D s[NX], uu[NUC_A], f[NX];
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        s[i] = D(Sv[blk * NX + i]);
        s[i].d[i] = T(1);
      }
#pragma unroll
      for (int c = 0; c < NUC; ++c) uu[c] = D(uv[c]);
      mpc_rhs<D, T>(s, pt.t, uu, pt.d, pt.pxs, f);
#pragma unroll
      for (int a = 0; a < NX; ++a) {
        r[blk * NX + a] = (ad[blk][0] * (Sv[a] - xv[a]) + ad[blk][1] * (Sv[NX + a] - xv[a])) *
                              hinv - f[a].v;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
#pragma unroll
          for (int b = 0; b < NX; ++b) {
            J[blk * NX + a][j * NX + b] =
                (a == b ? ad[blk][j] * hinv : T(0)) - (j == blk ? f[a].d[b] : T(0));
          }
        }
      }
    }
    lu_factor<T>(J, piv);
    lu_solve<T>(J, piv, r);
#pragma unroll
    for (int i = 0; i < NC; ++i) Sv[i] = Sv[i] - r[i];
  }

  // the differentiable step at the root S*: S = S* - G, J(z) G = r(S*, z).
  // F the ODE at s_blk with tangents (s, u): its first-order tangents in s
  // are the Jacobian's block, in u the residual's; its second-order
  // tangents in (s, u) the Jacobian's derivatives in u, in (u, u) the
  // residual's.
  VM F[2][NX];
#pragma unroll
  for (int blk = 0; blk < 2; ++blk) {
    VM s[NX];
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      s[i] = VM(Sv[blk * NX + i]);
      s[i].d[i] = T(1);
    }
    mpc_rhs<VM, T>(s, pt.t, u, pt.d, pt.pxs, F[blk]);
  }
  VM G[NC];
#pragma unroll
  for (int blk = 0; blk < 2; ++blk) {
#pragma unroll
    for (int a = 0; a < NX; ++a) {
      // f as a function of z at S*: its s tangents dropped
      VM fz = F[blk][a];
#pragma unroll
      for (int i = 0; i < NX; ++i) fz.d[i] = T(0);
#pragma unroll
      for (int q = 0; q < tri(NX, NX); ++q) fz.h[q] = T(0);   // the rows of s
      G[blk * NX + a] = (ad[blk][0] * (Sv[a] - x[a]) + ad[blk][1] * (Sv[NX + a] - x[a])) *
                            hinv - fz;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int b = 0; b < NX; ++b) {
          J[blk * NX + a][j * NX + b] =
              (a == b ? ad[blk][j] * hinv : T(0)) - (j == blk ? F[blk][a].d[b] : T(0));
        }
      }
    }
  }
  lu_factor<T>(J, piv);
  // the value, then each first-order tangent q: J G_q = r_q - J_q G with
  // J_q = -d2f/ds du_q on the diagonal blocks (u tangents only)
  {
    T b[NC];
#pragma unroll
    for (int i = 0; i < NC; ++i) b[i] = G[i].v;
    lu_solve<T>(J, piv, b);
#pragma unroll
    for (int i = 0; i < NC; ++i) G[i].v = b[i];
  }
  // JG[m][p] = -(J_kl G)_m for the u tangents' pair p = (k, l), k <= l:
  // sum_c d3f_a / ds_c du_k du_l G_c on the diagonal blocks, the ODE at
  // s_blk + eps G_blk on numbers over u with eps's tangent in every
  // component (u's tangents scaled as in u)
  constexpr int NPU = NUC * (NUC + 1) / 2;
  T JG[NC][NPU > 0 ? NPU : 1];
  if constexpr (NUC > 0) {
    using E = Dual<T, 1>;
    using VU = Dual2<E, NUC>;
    E de[ND_A], pxe[NPX_A];
#pragma unroll
    for (int i = 0; i < MPC_ND; ++i) de[i] = E(pt.d[i]);
#pragma unroll
    for (int i = 0; i < MPC_NPX; ++i) pxe[i] = E(pt.pxs[i]);
    VU uu[NUC];
#pragma unroll
    for (int c = 0; c < NUC; ++c) {
      uu[c] = VU(E(uv[c]));
      uu[c].d[c] = E(u[c].d[NX + c]);
    }
#pragma unroll
    for (int blk = 0; blk < 2; ++blk) {
      VU s[NX], f[NX];
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        E e(Sv[blk * NX + i]);
        e.d[0] = G[blk * NX + i].v;
        s[i] = VU(e);
      }
      mpc_rhs<VU, E>(s, E(pt.t), uu, de, pxe, f);
#pragma unroll
      for (int a = 0; a < NX; ++a) {
#pragma unroll
        for (int p = 0; p < NPU; ++p) JG[blk * NX + a][p] = f[a].h[p].d[0];
      }
    }
  }
#pragma unroll
  for (int q = 0; q < NZM; ++q) {
    T b[NC];
#pragma unroll
    for (int blk = 0; blk < 2; ++blk) {
#pragma unroll
      for (int a = 0; a < NX; ++a) {
        T v = G[blk * NX + a].d[q];
        if (q >= NX) {
#pragma unroll
          for (int c = 0; c < NX; ++c) v = v + F[blk][a].h[tri(c, q)] * G[blk * NX + c].v;
        }
        b[blk * NX + a] = v;
      }
    }
    lu_solve<T>(J, piv, b);
#pragma unroll
    for (int i = 0; i < NC; ++i) G[i].d[q] = b[i];
  }
  // each second-order entry (i, j): J G_ij = r_ij - J_i G_j - J_j G_i
  // - J_ij G
#pragma unroll
  for (int i = 0; i < NZM; ++i) {
#pragma unroll
    for (int j = i; j < NZM; ++j) {
      const int q = tri(i, j);
      T b[NC];
#pragma unroll
      for (int blk = 0; blk < 2; ++blk) {
#pragma unroll
        for (int a = 0; a < NX; ++a) {
          T v = G[blk * NX + a].h[q];
          if (i >= NX) {
            const int k = i - NX, m = j - NX;
            v = v + JG[blk * NX + a][k * NUC - k * (k - 1) / 2 + (m - k)];
          }
#pragma unroll
          for (int c = 0; c < NX; ++c) {
            if (i >= NX) v = v + F[blk][a].h[tri(c, i)] * G[blk * NX + c].d[j];
            if (j >= NX) v = v + F[blk][a].h[tri(c, j)] * G[blk * NX + c].d[i];
          }
          b[blk * NX + a] = v;
        }
      }
      lu_solve<T>(J, piv, b);
#pragma unroll
      for (int m = 0; m < NC; ++m) G[m].h[q] = b[m];
    }
  }
#pragma unroll
  for (int i = 0; i < NC; ++i) S[i] = Sv[i] - G[i];
#pragma unroll
  for (int i = 0; i < NX; ++i) x[i] = x[i] + bt[0] * (S[i] - x[i]) + bt[1] * (S[NX + i] - x[i]);
}
#endif

// The stage cost and the rows on z with all NZ tangents, in the kernel's
// order (u_prev, slack, slack input, x, u): gc, ival and E, hval and Cz
// (by the part that holds entry 0), and their terms of H's accumulator.
// S: the collocation stage states, or null.
template <class T, class V, class HA, int HN>
__device__ __forceinline__ void cost_rows(const Operands<T>& o, long long l, const Point<T>& pt,
                                          const V* S, HA& hacc, bool first) {
  const double sxa[NXA] = MPC_SXA;
  const double su[NU] = MPC_SU;
  const long long L = o.L;
  V xa[NXA], u[NU];
#pragma unroll
  for (int i = 0; i < NXA; ++i) {
    xa[i] = V(pt.xv[i]);
    xa[i].d[kx(i)] = T(sxa[i]);
  }
#pragma unroll
  for (int c = 0; c < NU; ++c) {
    u[c] = V(pt.uv[c]);
    u[c].d[ku(c)] = T(su[c]);
  }
#if MPC_HAS_COST
  // the stage cost: gc, and the first term of H
  V c[1];
  mpc_cost<V, T>(xa, u, MPC_POINT(S), c);
  if (first) {
#pragma unroll
    for (int q = 0; q < NZ; ++q) o.gc[l * NZ + ext(q)] = pt.sf * c[0].d[q];
  }
#pragma unroll
  for (int q = 0; q < HN; ++q) hacc[q] = pt.sf * c[0].h[q];
#else
#pragma unroll
  for (int q = 0; q < HN; ++q) hacc[q] = T(0);
#endif
#if MPC_NI > 0
  {
    // the inequality rows over their scales: ival, E and their H term
    const double si[NI] = MPC_SI;
    V g[NI];
    mpc_ineq<V, T>(xa, u, MPC_POINT(S), g);
#pragma unroll
    for (int k = 0; k < NI; ++k) {
      const T w = T(1.0 / si[k]);
      if (first) {
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
  }
#endif
#if MPC_NEQ > 0
  {
    // the equality rows: hval, Cz and their H term
    V e[NEQ];
    mpc_eq<V, T>(xa, u, MPC_POINT(S), e);
#pragma unroll
    for (int k = 0; k < NEQ; ++k) {
      if (first) {
        o.hval[l * NEQ + k] = e[k].v;
#pragma unroll
        for (int q = 0; q < NZ; ++q) o.Cz[(l * NEQ + k) * NZ + ext(q)] = e[k].d[q];
      }
#if MPC_EXACT
      const T mu_k = o.muh[(long long)k * L + l];
#pragma unroll
      for (int q = 0; q < HN; ++q) hacc[q] = hacc[q] + mu_k * e[k].h[q];
#endif
    }
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
  const int Bsz = o.Bsz;
  const double sxa[NXA] = MPC_SXA;
  const double su[NU] = MPC_SU;

  Point<T> pt;
  pt.k0 = l == l0;
#pragma unroll
  for (int i = 0; i < NXA; ++i) pt.xv[i] = o.X[i * L + l] * T(sxa[i]);
#pragma unroll
  for (int i = 0; i < NU; ++i) pt.uv[i] = o.U[i * L + l] * T(su[i]);
#if MPC_KIND == MPC_KIND_MHE
  {
    // window stage clip(n - 1, 0, N - 2) of the scenario's N - 1
    const int nw = o.N - 1, n = (int)(l - l0);
    const long long Lw = (long long)Bsz * nw, b0 = (long long)b * nw;
    const long long lw = b0 + (n < 1 ? 0 : (n - 1 < nw - 1 ? n - 1 : nw - 1));
#pragma unroll
    for (int i = 0; i < MPC_NUM; ++i) pt.um[i] = o.um[i * Lw + lw];
#pragma unroll
    for (int i = 0; i < MPC_NYW; ++i) pt.yw[i] = o.yw[i * Lw + lw];
#pragma unroll
    for (int i = 0; i < MPC_NPX; ++i) pt.px[i] = o.pxw[i * Lw + lw];
#pragma unroll
    for (int i = 0; i < MPC_NPY; ++i) pt.py[i] = o.pyw[i * Lw + lw];
    pt.t = o.tw[lw];
    pt.mask = o.mask[lw] != T(0);
    // the correction's measurements: the first NCORR / NYW window stages'
#pragma unroll
    for (int k = 0; k < MPC_NCORR; ++k) pt.yc[k] = o.yw[(k % NYW_A) * Lw + b0 + k / NYW_A];
    pt.xbar = o.xbar + (long long)b * NXA;
    pt.pinv = o.pinv + (long long)b * NXA * NXA;
    pt.obig = o.obig + (long long)b * MPC_NCORR * NXA;
    pt.hbig = o.hbig + (long long)b * MPC_NCORR;
    pt.pyc = o.pyc + (long long)b * MPC_NCORR * MPC_NCORR;
  }
#else
#pragma unroll
  for (int i = 0; i < MPC_NPX; ++i) {
    pt.px[i] = o.px[i * L + l];
    pt.pxs[i] = o.px[i * L + (MPC_PX0 ? l0 : l)];
  }
#pragma unroll
  for (int i = 0; i < MPC_NPY; ++i) {
    pt.py[i] = o.py[i * L + l];
    pt.py0[i] = o.py[i * L + l0];
  }
#pragma unroll
  for (int i = 0; i < MPC_ND; ++i) pt.d[i] = o.ds[(long long)i * Bsz + b];
#pragma unroll
  for (int i = 0; i < NX; ++i) pt.xs[i] = o.xs[(long long)i * Bsz + b];
#pragma unroll
  for (int i = 0; i < NUC; ++i) {
    pt.us[i] = o.us[(long long)i * Bsz + b];
    pt.um1[i] = o.um1[(long long)i * Bsz + b];
  }
#pragma unroll
  for (int i = 0; i < MPC_NLAM; ++i) pt.lamy[i] = o.lamy[(long long)i * Bsz + b];
  pt.t = o.ts[b];
#endif
  pt.sf = o.sfs[b];

  // H's accumulator, after the running sums in shared memory
  Vals<T, HN, SMEM> hacc(NR * Sum<T, VM, NR, SMEM>::W * THREADS);
#if MPC_KIND != MPC_KIND_COLL
  cost_rows<T, V, Vals<T, HN, SMEM>, HN>(o, l, pt, (const V*)nullptr, hacc, FIRST);
#endif

  // the step on (x, u) with NZM tangents
  VM x[NX], u[NUC_A], acc(T(0));
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    x[i] = VM(pt.xv[i]);
    x[i].d[i] = T(sxa[i]);
  }
#pragma unroll
  for (int i = 0; i < NUC; ++i) {
    u[i] = VM(pt.uv[i]);
    u[i].d[NX + i] = T(su[i]);
  }
#if MPC_KIND == MPC_KIND_COLL
  {
    // S first: the cost and the rows read it, on all NZ tangents
    VM S[NC];
    coll_step<T, VM>(x, u, S, pt);
    V Sz[NC];
#pragma unroll
    for (int m = 0; m < NC; ++m) {
      Sz[m] = V(S[m].v);
#pragma unroll
      for (int q = 0; q < NZM; ++q) Sz[m].d[NPRE + q] = S[m].d[q];
#pragma unroll
      for (int q = 0; q < SS::N; ++q) Sz[m].h[SS::A - H0 + q] = S[m].h[q];
    }
    cost_rows<T, V, Vals<T, HN, SMEM>, HN>(o, l, pt, Sz, hacc, FIRST);
  }
#elif MPC_KIND == MPC_KIND_MHE
  // the arrival stage's map is its input; a pad stage carries the state
  if (pt.k0) {
#pragma unroll
    for (int i = 0; i < NX; ++i) x[i] = u[i];
  } else if (pt.mask) {
    mhe_step<T, VM, SMEM>(x, u, pt.t, pt.um, pt.px);
  }
#else
  step<T, VM, SMEM>(x, u, acc, pt.t, pt.d, pt.px, pt.xs, pt.us, pt.py);
#endif
#if MPC_KIND == MPC_KIND_RK4 || MPC_KIND == MPC_KIND_MAP
  {
    // px again for the terms, loaded here so that it is not live across
    // the sub-steps when the ODE does not read it
    T pxe[NPX_A];
#pragma unroll
    for (int i = 0; i < MPC_NPX; ++i) pxe[i] = o.px[i * L + l];
    mpc_terms<VM, T>(x, pt.d, pxe);
  }
#endif

#if MPC_KIND == MPC_KIND_CF
  // the quadrature is the cost (with the slack penalty's terms already
  // in): gc, and its term of H
  if (FIRST) {
#pragma unroll
    for (int q = 0; q < NZM; ++q) {
      const long long at = l * NZ + ext(NPRE + q);
      o.gc[at] = (MPC_HAS_COST ? o.gc[at] : T(0)) + pt.sf * acc.d[q];
    }
    if (!MPC_HAS_COST) {
#pragma unroll
      for (int q = 0; q < NPRE; ++q) o.gc[l * NZ + ext(q)] = T(0);
    }
  }
#pragma unroll
  for (int q = 0; q < SS::N; ++q)
    hacc[SS::A - H0 + q] = hacc[SS::A - H0 + q] + pt.sf * acc.h[q];
#endif

  // the state's rows: dval, A (zero in the u_prev and slack columns), B
  // (zero in the slack inputs' columns), lam's term
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
      for (int j = 0; j < NUC; ++j) o.B[(l * NXA + i) * NU + j] = x[i].d[NX + j] * w;
#pragma unroll
      for (int j = NUC; j < NU; ++j) o.B[(l * NXA + i) * NU + j] = T(0);
    }
#if MPC_EXACT
    const T lam_i = o.lam[(long long)i * L + l];
#pragma unroll
    for (int q = 0; q < SS::N; ++q)
      hacc[SS::A - H0 + q] = hacc[SS::A - H0 + q] + lam_i * (x[i].h[q] * w);
#endif
  }
  if (FIRST) {
    // the u_prev rows: u over the slots' scales, an identity block of B
#pragma unroll
    for (int k = 0; k < NUP; ++k) {
      const T w = T(1.0 / sxa[NX + k]);
      o.dval[l * NXA + NX + k] = pt.uv[k] * w;
#pragma unroll
      for (int j = 0; j < NXA; ++j) o.A[(l * NXA + NX + k) * NXA + j] = T(0);
#pragma unroll
      for (int j = 0; j < NU; ++j)
        o.B[(l * NXA + NX + k) * NU + j] = j == k ? T(su[k]) * w : T(0);
    }
    // the slack rows: the input slots at stage 0 (of B), the carried state
    // slots after it (of A)
#pragma unroll
    for (int m = 0; m < NS; ++m) {
      constexpr int R0 = NX + NUP;
      const T w = T(1.0 / sxa[R0 + m]);
      o.dval[l * NXA + R0 + m] = (pt.k0 ? pt.uv[NUC + m] : pt.xv[R0 + m]) * w;
#pragma unroll
      for (int j = 0; j < NXA; ++j)
        o.A[(l * NXA + R0 + m) * NXA + j] = (j == R0 + m && !pt.k0) ? T(sxa[R0 + m]) * w : T(0);
#pragma unroll
      for (int j = 0; j < NU; ++j)
        o.B[(l * NXA + R0 + m) * NU + j] = (j == NUC + m && pt.k0) ? T(su[NUC + m]) * w : T(0);
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
int launch(const Operands<T>& o, void* stream) {
  if (o.L <= 0) return 0;
  constexpr int smem = smem_bytes<T>();
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        stage_sweep_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long lanes = THREADS / Layout<T>::SPLIT;
  const long long blocks = (o.L + lanes - 1) / lanes;
  stage_sweep_kernel<T><<<(unsigned)blocks, THREADS, smem, (cudaStream_t)stream>>>(o);
  return (int)cudaGetLastError();
}

}  // namespace

// MPC_DTYPE_BITS (a -D of the build), 32 or 64: that dtype's launcher
// alone, so that the two compile in nvcc runs of their own; both without.
#if MPC_KIND == MPC_KIND_MHE
#define MPC_LAUNCHER(NAME, T)                                                              \
  extern "C" int NAME(const void* X, const void* U, const void* lam, const void* nus,     \
                      const void* um, const void* yw, const void* tw, const void* pxw,    \
                      const void* pyw, const void* mask, const void* sfs,                 \
                      const void* xbar, const void* pinv, const void* obig,               \
                      const void* hbig, const void* pyc, void* H, void* gc, void* A,      \
                      void* B, void* E, void* ival, void* dval, void* Cz, void* hval,     \
                      long long L, int N, int Bsz, void* stream) {                        \
    Operands<T> o{};                                                                      \
    o.X = (const T*)X; o.U = (const T*)U; o.lam = (const T*)lam; o.nus = (const T*)nus;   \
    o.sfs = (const T*)sfs;                                                                \
    o.H = (T*)H; o.gc = (T*)gc; o.A = (T*)A; o.B = (T*)B; o.E = (T*)E;                    \
    o.ival = (T*)ival; o.dval = (T*)dval; o.Cz = (T*)Cz; o.hval = (T*)hval;               \
    o.L = L; o.N = N; o.Bsz = Bsz;                                                        \
    o.um = (const T*)um; o.yw = (const T*)yw; o.tw = (const T*)tw;                        \
    o.pxw = (const T*)pxw; o.pyw = (const T*)pyw; o.mask = (const T*)mask;                \
    o.xbar = (const T*)xbar; o.pinv = (const T*)pinv; o.obig = (const T*)obig;            \
    o.hbig = (const T*)hbig; o.pyc = (const T*)pyc;                                       \
    return N < 2 ? (int)cudaErrorInvalidValue : launch<T>(o, stream);                     \
  }
#else
#define MPC_LAUNCHER(NAME, T)                                                              \
  extern "C" int NAME(const void* X, const void* U, const void* lam, const void* nus,     \
                      const void* px, const void* py, const void* muh, const void* ts,    \
                      const void* sfs, const void* xs, const void* us, const void* ds,    \
                      const void* um1, const void* lamy, void* H, void* gc, void* A,      \
                      void* B, void* E, void* ival, void* dval, void* Cz, void* hval,     \
                      long long L, int N, int Bsz, void* stream) {                        \
    const Operands<T> o{(const T*)X, (const T*)U, (const T*)lam, (const T*)nus,           \
                        (const T*)px, (const T*)py, (const T*)muh, (const T*)ts,          \
                        (const T*)sfs, (const T*)xs, (const T*)us, (const T*)ds,          \
                        (const T*)um1, (const T*)lamy, (T*)H, (T*)gc, (T*)A, (T*)B,       \
                        (T*)E, (T*)ival, (T*)dval, (T*)Cz, (T*)hval, L, N, Bsz};          \
    return launch<T>(o, stream);                                                          \
  }
#endif
#if !defined(MPC_DTYPE_BITS) || MPC_DTYPE_BITS == 32
MPC_LAUNCHER(stage_sweep_f32, float)
#endif
#if !defined(MPC_DTYPE_BITS) || MPC_DTYPE_BITS == 64
MPC_LAUNCHER(stage_sweep_f64, double)
#endif
