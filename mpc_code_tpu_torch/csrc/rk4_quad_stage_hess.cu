// ContForm joint sweep for Hopper (sm_90a).
//
// Replaces mpc_code_tpu/ops/sweep_pallas.py::rk4_quad_stage_hess_pallas,
// the TPU kernel that the batched IPM reaches through
// integrators.rk4_quad_stage_hess on every iteration of a ContForm
// (economic) OCP.  For each (scenario, stage) lane it integrates
// x' = f(x, t, u, d, px, xs, us, py) and the quadrature acc' = q(...) over
// one sampling interval with MPC_MX RK4 sub-steps, and carries through the
// sub-steps the nz = nx + nu first-order tangents and the nz(nz+1)/2
// second-order tangents of (x, acc) with respect to z = (x0, u).
// Outputs: xf (nx planes), the Jacobian [Jx | Ju] as nx * nz planes
// (row i * nz + j = d xf_i / d z_j), the quadrature qv (1 plane), its
// gradient gq (nz planes) and its Hessian hq (nz * nz planes, written
// symmetric from the upper triangle).
//
// The model is not fixed here: mpc_code_tpu_torch/ops/sweep_cf_cuda.py
// lowers the user's torch functions to scalar statements and writes
// mpc_cf_gen.cuh (mpc_ode, mpc_quad and the MPC_* dimensions) into the
// build directory, the role the Pallas trace plays for the TPU kernel.
//
// What bounds it on the H100: arithmetic.  A lane reads nx+nu+npx+npy
// values and writes nx*(1+nz) + 1 + nz + nz*nz, while it runs 8*Mx user
// function evaluations on numbers of 1 + nz + nz(nz+1)/2 components
// (~20 kFLOP for Ex_ENMPC at Mx=10).  The design: one thread per lane;
// the state, the accumulator and all their tangents live in registers
// across the sub-steps (the RK4 stage sums are accumulated as they come,
// so only one stage's slopes are live), nothing touches device memory
// between loading the inputs and writing the outputs; the planes put
// lanes innermost so a warp's loads and stores are coalesced.

#include <cuda_runtime.h>

#include "dual.cuh"
#include "dual2.cuh"
#include "mpc_cf_gen.cuh"

namespace {

constexpr int NX = MPC_NX;
constexpr int NU = MPC_NU;
constexpr int NZ = MPC_NX + MPC_NU;
constexpr int NPX_A = MPC_NPX > 0 ? MPC_NPX : 1;
constexpr int NPY_A = MPC_NPY > 0 ? MPC_NPY : 1;
constexpr int ND_A = MPC_ND > 0 ? MPC_ND : 1;

// Per-stage planes xs (NX, L), us (NU, L), pxs (NPX, L), pys (NPY, L):
// lane l = b * N + n.  Per-scenario ts, hs (B,), ds (ND, B), xss (NX, B),
// uss (NU, B).
template <class T>
__global__ void rk4_quad_stage_hess_kernel(
    const T* __restrict__ xs, const T* __restrict__ us,
    const T* __restrict__ pxs, const T* __restrict__ pys,
    const T* __restrict__ ts, const T* __restrict__ hs,
    const T* __restrict__ ds, const T* __restrict__ xss,
    const T* __restrict__ uss, T* __restrict__ xf, T* __restrict__ jac,
    T* __restrict__ qv, T* __restrict__ gq, T* __restrict__ hq, long long L,
    int N, int Bsz) {
  using V = Dual2<T, NZ>;
  const long long l = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (l >= L) return;
  const int b = (int)(l / N);

  V x[NX], u[NU];
  T px[NPX_A], py[NPY_A], d[ND_A], xsv[NX], usv[NU];
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    x[i] = V(xs[i * L + l]);
    x[i].d[i] = T(1);
    xsv[i] = xss[(long long)i * Bsz + b];
  }
#pragma unroll
  for (int i = 0; i < NU; ++i) {
    u[i] = V(us[i * L + l]);
    u[i].d[NX + i] = T(1);
    usv[i] = uss[(long long)i * Bsz + b];
  }
#pragma unroll
  for (int i = 0; i < MPC_NPX; ++i) px[i] = pxs[i * L + l];
#pragma unroll
  for (int i = 0; i < MPC_NPY; ++i) py[i] = pys[i * L + l];
#pragma unroll
  for (int i = 0; i < MPC_ND; ++i) d[i] = ds[(long long)i * Bsz + b];

  T tv = ts[b];
  const T dt = hs[b] / T(MPC_MX);
  const T dt2 = dt / T(2);
  const T dt6 = dt / T(6);
  V acc(T(0));

  for (int s = 0; s < MPC_MX; ++s) {
    // slopes k and q of one RK4 stage; ks, qs their running weighted sums
    // ((k1 + 2 k2) + 2 k3) + k4, the association of the plain version
    V k[NX], ks[NX], xt[NX], q[1], qs;
    mpc_ode<V, T>(x, tv, u, d, px, xsv, usv, py, k);
    mpc_quad<V, T>(x, tv, u, d, px, xsv, usv, py, q);
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      ks[i] = k[i];
      xt[i] = x[i] + dt2 * k[i];
    }
    qs = q[0];
    mpc_ode<V, T>(xt, tv + dt2, u, d, px, xsv, usv, py, k);
    mpc_quad<V, T>(xt, tv + dt2, u, d, px, xsv, usv, py, q);
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      ks[i] = ks[i] + T(2) * k[i];
      xt[i] = x[i] + dt2 * k[i];
    }
    qs = qs + T(2) * q[0];
    mpc_ode<V, T>(xt, tv + dt2, u, d, px, xsv, usv, py, k);
    mpc_quad<V, T>(xt, tv + dt2, u, d, px, xsv, usv, py, q);
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      ks[i] = ks[i] + T(2) * k[i];
      xt[i] = x[i] + dt * k[i];
    }
    qs = qs + T(2) * q[0];
    mpc_ode<V, T>(xt, tv + dt, u, d, px, xsv, usv, py, k);
    mpc_quad<V, T>(xt, tv + dt, u, d, px, xsv, usv, py, q);
#pragma unroll
    for (int i = 0; i < NX; ++i) x[i] = x[i] + dt6 * (ks[i] + k[i]);
    acc = acc + dt6 * (qs + q[0]);
    tv = tv + dt;
  }

#pragma unroll
  for (int i = 0; i < NX; ++i) {
    xf[i * L + l] = x[i].v;
#pragma unroll
    for (int j = 0; j < NZ; ++j) jac[(long long)(i * NZ + j) * L + l] = x[i].d[j];
  }
  qv[l] = acc.v;
  int p = 0;
#pragma unroll
  for (int i = 0; i < NZ; ++i) {
    gq[(long long)i * L + l] = acc.d[i];
#pragma unroll
    for (int j = i; j < NZ; ++j, ++p) {
      hq[(long long)(i * NZ + j) * L + l] = acc.h[p];
      hq[(long long)(j * NZ + i) * L + l] = acc.h[p];
    }
  }
}

template <class T>
int launch(const void* xs, const void* us, const void* pxs, const void* pys,
           const void* ts, const void* hs, const void* ds, const void* xss,
           const void* uss, void* xf, void* jac, void* qv, void* gq, void* hq,
           long long L, int N, int Bsz, void* stream) {
  if (L <= 0) return 0;
  const int threads = 128;
  const long long blocks = (L + threads - 1) / threads;
  rk4_quad_stage_hess_kernel<T><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const T*)xs, (const T*)us, (const T*)pxs, (const T*)pys, (const T*)ts,
      (const T*)hs, (const T*)ds, (const T*)xss, (const T*)uss, (T*)xf,
      (T*)jac, (T*)qv, (T*)gq, (T*)hq, L, N, Bsz);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int rk4_quad_stage_hess_f32(
    const void* xs, const void* us, const void* pxs, const void* pys,
    const void* ts, const void* hs, const void* ds, const void* xss,
    const void* uss, void* xf, void* jac, void* qv, void* gq, void* hq,
    long long L, int N, int Bsz, void* stream) {
  return launch<float>(xs, us, pxs, pys, ts, hs, ds, xss, uss, xf, jac, qv,
                       gq, hq, L, N, Bsz, stream);
}

extern "C" int rk4_quad_stage_hess_f64(
    const void* xs, const void* us, const void* pxs, const void* pys,
    const void* ts, const void* hs, const void* ds, const void* xss,
    const void* uss, void* xf, void* jac, void* qv, void* gq, void* hq,
    long long L, int N, int Bsz, void* stream) {
  return launch<double>(xs, us, pxs, pys, ts, hs, ds, xss, uss, xf, jac, qv,
                        gq, hq, L, N, Bsz, stream);
}
