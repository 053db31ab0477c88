// RK4 stage-Jacobian sweep for Hopper (sm_90a).
//
// Replaces mpc_code_tpu/ops/sweep_pallas.py::rk4_stage_jac_pallas, the TPU
// kernel that the batched IPM reaches through integrators.rk4_stage_jac on
// every iteration.  For each (scenario, stage) lane it integrates
// x' = f(x, t, u, d, px) over one sampling interval with MPC_MX RK4
// sub-steps, applies the saturation guard to the ODE input state at every
// right-hand-side evaluation, and carries the nx + nu forward tangents
// through the sub-steps.  Outputs: xf, Jx = d xf / d x and Ju = d xf / d u.
//
// The model is not fixed here: mpc_code_tpu_torch/ops/sweep_cuda.py traces
// the user's torch ODE with torch.fx and writes mpc_rhs_gen.cuh (mpc_rhs,
// mpc_clip and the MPC_* dimensions) into the build directory, the role
// that the Pallas trace plays for the TPU kernel.
//
// What bounds it on the H100: arithmetic.  A lane reads ~(nx+nu+npx) values
// and writes nx*(1+nz), while it runs 4*Mx right-hand sides on a value
// plus nz tangents (~10 kFLOP for the CSTR at Mx=10).  The design: one
// thread per lane; the state and its nx*nz tangents live in registers
// across all sub-steps (no device-memory traffic between sub-steps), the
// sub-step loop kept rolled (its body is four right-hand sides); a
// quotient costs one reciprocal (dual.cuh).  It reads the solver's
// (B, N, .) tensors in place and writes xf (B, N, nx), Jx (B, N, nx, nx)
// and Ju (B, N, nx, nu), each lane's rows staged through shared memory so
// that a block stores one contiguous run (lane_rows.cuh).

#include <cuda_runtime.h>

#include "dual.cuh"
#include "lane_rows.cuh"
#include "mpc_rhs_gen.cuh"

namespace {

constexpr int NX = MPC_NX;
constexpr int NU = MPC_NU;
constexpr int NZ = MPC_NX + MPC_NU;
constexpr int NPX_A = MPC_NPX > 0 ? MPC_NPX : 1;
constexpr int ND_A = MPC_ND > 0 ? MPC_ND : 1;
constexpr int THREADS = 128;

template <class V, class T>
__device__ __forceinline__ void eval_rhs(const V* x, T t, const V* u,
                                         const T* d, const T* px, V* out) {
  V xc[NX];
  mpc_clip<V, T>(x, xc);
  mpc_rhs<V, T>(xc, t, u, d, px, out);
}

// xs (B, N, NX), us (B, N, NU), pxs (B, N, NPX), ts, hs (B,), ds (B, ND),
// read at the strides st: xs, us, pxs two each (along B, N), then ts, hs,
// ds one each.  xf (B, N, NX), jx (B, N, NX, NX), ju (B, N, NX, NU)
// contiguous.
template <class T>
__global__ void __launch_bounds__(THREADS)
rk4_stage_jac_kernel(const T* __restrict__ xs, const T* __restrict__ us,
                     const T* __restrict__ pxs, const T* __restrict__ ts,
                     const T* __restrict__ hs, const T* __restrict__ ds,
                     T* __restrict__ xf, T* __restrict__ jx, T* __restrict__ ju,
                     InStrides st, long long L, int N) {
  using V = Dual<T, NZ>;
  const long long l0 = (long long)blockIdx.x * THREADS;
  const int nl = (int)(L - l0 < THREADS ? L - l0 : THREADS);
  // a thread past the last lane computes the last lane again, unstored;
  // L < 2^31 (the wrapper checks it)
  const int l = (int)l0 + (threadIdx.x < nl ? (int)threadIdx.x : nl - 1);
  const long long b = l / N, n = l - b * N;
  const long long* s = st.s;

  V x[NX], u[NU];
  T px[NPX_A], d[ND_A];
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    x[i] = V(xs[b * s[0] + n * s[1] + i]);
    x[i].d[i] = T(1);
  }
#pragma unroll
  for (int i = 0; i < NU; ++i) {
    u[i] = V(us[b * s[2] + n * s[3] + i]);
    u[i].d[NX + i] = T(1);
  }
#pragma unroll
  for (int i = 0; i < MPC_NPX; ++i) px[i] = pxs[b * s[4] + n * s[5] + i];
#pragma unroll
  for (int i = 0; i < MPC_ND; ++i) d[i] = ds[b * s[8] + i];

  T tv = ts[b * s[6]];
  const T dt = hs[b * s[7]] / T(MPC_MX);
  const T dt2 = dt / T(2);
  const T dt6 = dt / T(6);

#pragma unroll 1
  for (int k = 0; k < MPC_MX; ++k) {
    V k1[NX], k2[NX], k3[NX], k4[NX], xt[NX];
    eval_rhs<V, T>(x, tv, u, d, px, k1);
#pragma unroll
    for (int i = 0; i < NX; ++i) xt[i] = x[i] + dt2 * k1[i];
    eval_rhs<V, T>(xt, tv + dt2, u, d, px, k2);
#pragma unroll
    for (int i = 0; i < NX; ++i) xt[i] = x[i] + dt2 * k2[i];
    eval_rhs<V, T>(xt, tv + dt2, u, d, px, k3);
#pragma unroll
    for (int i = 0; i < NX; ++i) xt[i] = x[i] + dt * k3[i];
    eval_rhs<V, T>(xt, tv + dt, u, d, px, k4);
#pragma unroll
    for (int i = 0; i < NX; ++i)
      x[i] = x[i] + dt6 * (((k1[i] + T(2) * k2[i]) + T(2) * k3[i]) + k4[i]);
    tv = tv + dt;
  }

  store_outputs<T, NX, NU, THREADS>(x, xf, jx, ju, l0, nl);
}

template <class T>
int launch(const void* xs, const void* us, const void* pxs, const void* ts,
           const void* hs, const void* ds, void* xf, void* jx, void* ju,
           const long long* strides, long long L, int N, void* stream) {
  if (L <= 0) return 0;
  const long long blocks = (L + THREADS - 1) / THREADS;
  rk4_stage_jac_kernel<T><<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const T*)xs, (const T*)us, (const T*)pxs, (const T*)ts, (const T*)hs,
      (const T*)ds, (T*)xf, (T*)jx, (T*)ju, in_strides(strides, 9), L, N);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int rk4_stage_jac_f32(const void* xs, const void* us, const void* pxs,
                                 const void* ts, const void* hs, const void* ds,
                                 void* xf, void* jx, void* ju, const long long* strides,
                                 long long L, int N, void* stream) {
  return launch<float>(xs, us, pxs, ts, hs, ds, xf, jx, ju, strides, L, N, stream);
}

extern "C" int rk4_stage_jac_f64(const void* xs, const void* us, const void* pxs,
                                 const void* ts, const void* hs, const void* ds,
                                 void* xf, void* jx, void* ju, const long long* strides,
                                 long long L, int N, void* stream) {
  return launch<double>(xs, us, pxs, ts, hs, ds, xf, jx, ju, strides, L, N, stream);
}
