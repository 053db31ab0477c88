// Discrete-map stage-Jacobian sweep for Hopper (sm_90a).
//
// Replaces mpc_code_tpu/ops/sweep_pallas.py::map_stage_jac_pallas, the TPU
// kernel that the batched IPM reaches through integrators.map_stage_jac on
// every iteration of an OCP whose model is a discrete map (the NL-discrete
// form, Utilities.py:186-198).  For each (scenario, stage) lane it
// evaluates x_next = f(x, u, d, t, px) once, carrying the nx + nu forward
// tangents.  Outputs: xf (nx planes) and the Jacobian [Jx | Ju] as
// nx * nz planes, row i * nz + j = d xf_i / d z_j.  The TPU kernel's
// jax.linearize plus nz tangent applications compute the same numbers.
//
// The map is not fixed here: mpc_code_tpu_torch/ops/sweep_map_cuda.py
// traces the user's torch map with torch.fx and writes mpc_map_gen.cuh
// (mpc_map and the MPC_* dimensions) into the build directory, the role
// that the Pallas trace plays for the TPU kernel.
//
// What bounds it on the H100: arithmetic.  A lane reads nx + nu + npx
// values and writes nx * (1 + nz), while the map runs several hundred
// dependent statements on a value plus nz tangents (~7 kFLOP for the
// quadruple tank, whose map unrolls 20 right-hand sides).  The design: one
// thread per lane; the map's intermediates and their tangents live in
// registers; the planes put lanes innermost so a warp's loads and stores
// are coalesced.

#include <cuda_runtime.h>

#include "dual.cuh"
#include "mpc_map_gen.cuh"

namespace {

constexpr int NX = MPC_NX;
constexpr int NU = MPC_NU;
constexpr int NZ = MPC_NX + MPC_NU;
constexpr int NPX_A = MPC_NPX > 0 ? MPC_NPX : 1;
constexpr int ND_A = MPC_ND > 0 ? MPC_ND : 1;

// xs (NX, L), us (NU, L), pxs (NPX, L): lane l = b * N + n.
// ts (B,), ds (ND, B): per scenario.
template <class T>
__global__ void map_stage_jac_kernel(const T* __restrict__ xs,
                                     const T* __restrict__ us,
                                     const T* __restrict__ pxs,
                                     const T* __restrict__ ts,
                                     const T* __restrict__ ds,
                                     T* __restrict__ xf,
                                     T* __restrict__ jac,
                                     long long L, int N, int Bsz) {
  using V = Dual<T, NZ>;
  const long long l = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (l >= L) return;
  const int b = (int)(l / N);

  V x[NX], u[NU], out[NX];
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

  mpc_map<V, T>(x, u, d, ts[b], px, out);

#pragma unroll
  for (int i = 0; i < NX; ++i) {
    xf[i * L + l] = out[i].v;
#pragma unroll
    for (int j = 0; j < NZ; ++j) jac[(long long)(i * NZ + j) * L + l] = out[i].d[j];
  }
}

template <class T>
int launch(const void* xs, const void* us, const void* pxs, const void* ts,
           const void* ds, void* xf, void* jac, long long L, int N, int Bsz,
           void* stream) {
  if (L <= 0) return 0;
  const int threads = 128;
  const long long blocks = (L + threads - 1) / threads;
  map_stage_jac_kernel<T><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const T*)xs, (const T*)us, (const T*)pxs, (const T*)ts, (const T*)ds,
      (T*)xf, (T*)jac, L, N, Bsz);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int map_stage_jac_f32(const void* xs, const void* us, const void* pxs,
                                 const void* ts, const void* ds, void* xf,
                                 void* jac, long long L, int N, int Bsz,
                                 void* stream) {
  return launch<float>(xs, us, pxs, ts, ds, xf, jac, L, N, Bsz, stream);
}

extern "C" int map_stage_jac_f64(const void* xs, const void* us, const void* pxs,
                                 const void* ts, const void* ds, void* xf,
                                 void* jac, long long L, int N, int Bsz,
                                 void* stream) {
  return launch<double>(xs, us, pxs, ts, ds, xf, jac, L, N, Bsz, stream);
}
