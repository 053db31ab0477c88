// RK4 stage-Jacobian sweep for Hopper (sm_90a).
//
// Replaces mpc_code_tpu/ops/sweep_pallas.py::rk4_stage_jac_pallas, the TPU
// kernel that the batched IPM reaches through integrators.rk4_stage_jac on
// every iteration.  For each (scenario, stage) lane it integrates
// x' = f(x, t, u, d, px) over one sampling interval with MPC_MX RK4
// sub-steps, applies the saturation guard to the ODE input state at every
// right-hand-side evaluation, and carries the nx + nu forward tangents
// through the sub-steps.  Outputs: xf (nx planes) and the Jacobian
// [Jx | Ju] as nx * nz planes, row i * nz + j = d xf_i / d z_j.
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
// across all sub-steps (no device-memory traffic between sub-steps); the
// planes put lanes innermost so a warp's loads and stores are coalesced.

#include <cuda_runtime.h>

#include "dual.cuh"
#include "mpc_rhs_gen.cuh"

namespace {

constexpr int NX = MPC_NX;
constexpr int NU = MPC_NU;
constexpr int NZ = MPC_NX + MPC_NU;
constexpr int NPX_A = MPC_NPX > 0 ? MPC_NPX : 1;
constexpr int ND_A = MPC_ND > 0 ? MPC_ND : 1;

template <class V, class T>
__device__ __forceinline__ void eval_rhs(const V* x, T t, const V* u,
                                         const T* d, const T* px, V* out) {
  V xc[NX];
  mpc_clip<V, T>(x, xc);
  mpc_rhs<V, T>(xc, t, u, d, px, out);
}

// xs (NX, L), us (NU, L), pxs (NPX, L): lane l = b * N + n.
// ts, hs (B,), ds (ND, B): per scenario.
template <class T>
__global__ void rk4_stage_jac_kernel(const T* __restrict__ xs,
                                     const T* __restrict__ us,
                                     const T* __restrict__ pxs,
                                     const T* __restrict__ ts,
                                     const T* __restrict__ hs,
                                     const T* __restrict__ ds,
                                     T* __restrict__ xf,
                                     T* __restrict__ jac,
                                     long long L, int N, int Bsz) {
  using V = Dual<T, NZ>;
  const long long l = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (l >= L) return;
  const int b = (int)(l / N);

  V x[NX], u[NU];
  T px[NPX_A], d[ND_A];
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    x[i] = V(xs[i * L + l]);
    x[i].d[i] = T(1);
  }
#pragma unroll
  for (int i = 0; i < NU; ++i) {
    u[i] = V(us[i * L + l]);
    u[i].d[NX + i] = T(1);
  }
#pragma unroll
  for (int i = 0; i < MPC_NPX; ++i) px[i] = pxs[i * L + l];
#pragma unroll
  for (int i = 0; i < MPC_ND; ++i) d[i] = ds[(long long)i * Bsz + b];

  T tv = ts[b];
  const T dt = hs[b] / T(MPC_MX);
  const T dt2 = dt / T(2);
  const T dt6 = dt / T(6);

  for (int s = 0; s < MPC_MX; ++s) {
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

#pragma unroll
  for (int i = 0; i < NX; ++i) {
    xf[i * L + l] = x[i].v;
#pragma unroll
    for (int j = 0; j < NZ; ++j) jac[(long long)(i * NZ + j) * L + l] = x[i].d[j];
  }
}

template <class T>
int launch(const void* xs, const void* us, const void* pxs, const void* ts,
           const void* hs, const void* ds, void* xf, void* jac, long long L,
           int N, int Bsz, void* stream) {
  if (L <= 0) return 0;
  const int threads = 128;
  const long long blocks = (L + threads - 1) / threads;
  rk4_stage_jac_kernel<T><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const T*)xs, (const T*)us, (const T*)pxs, (const T*)ts, (const T*)hs,
      (const T*)ds, (T*)xf, (T*)jac, L, N, Bsz);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int rk4_stage_jac_f32(const void* xs, const void* us, const void* pxs,
                                 const void* ts, const void* hs, const void* ds,
                                 void* xf, void* jac, long long L, int N, int Bsz,
                                 void* stream) {
  return launch<float>(xs, us, pxs, ts, hs, ds, xf, jac, L, N, Bsz, stream);
}

extern "C" int rk4_stage_jac_f64(const void* xs, const void* us, const void* pxs,
                                 const void* ts, const void* hs, const void* ds,
                                 void* xf, void* jac, long long L, int N, int Bsz,
                                 void* stream) {
  return launch<double>(xs, us, pxs, ts, hs, ds, xf, jac, L, N, Bsz, stream);
}
