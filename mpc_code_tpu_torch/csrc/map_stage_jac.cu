// Discrete-map stage-Jacobian sweep for Hopper (sm_90a).
//
// Replaces mpc_code_tpu/ops/sweep_pallas.py::map_stage_jac_pallas, the TPU
// kernel that the batched IPM reaches through integrators.map_stage_jac on
// every iteration of an OCP whose model is a discrete map (the NL-discrete
// form, Utilities.py:186-198).  For each (scenario, stage) lane it
// evaluates x_next = f(x, u, d, t, px) once, carrying the nx + nu forward
// tangents.  Outputs: xf, Jx = d xf / d x and Ju = d xf / d u.  The TPU
// kernel's jax.linearize plus nz tangent applications compute the same
// numbers.
//
// The map is not fixed here: mpc_code_tpu_torch/ops/sweep_map_cuda.py
// traces the user's torch map with torch.fx and writes mpc_map_gen.cuh
// (mpc_map and the MPC_* dimensions) into the build directory, the role
// that the Pallas trace plays for the TPU kernel.
//
// What bounds it on the H100: arithmetic.  A lane reads nx + nu + npx
// values and writes nx * (1 + nz), while the map runs several hundred
// dependent statements on a value plus nz tangents (~7 kFLOP for the
// quadruple tank, whose map unrolls 20 right-hand sides, each with four
// square roots).  The design: one thread per lane; the map's intermediates
// and their tangents live in registers; a quotient or square root costs
// one reciprocal (dual.cuh).  It reads the solver's (B, N, .) tensors in
// place and writes xf (B, N, nx), Jx (B, N, nx, nx) and Ju (B, N, nx, nu),
// each lane's rows staged through shared memory so that a block stores one
// contiguous run (lane_rows.cuh).

#include <cuda_runtime.h>

#include "dual.cuh"
#include "lane_rows.cuh"
#include "mpc_map_gen.cuh"

namespace {

constexpr int NX = MPC_NX;
constexpr int NU = MPC_NU;
constexpr int NZ = MPC_NX + MPC_NU;
constexpr int NPX_A = MPC_NPX > 0 ? MPC_NPX : 1;
constexpr int ND_A = MPC_ND > 0 ? MPC_ND : 1;
constexpr int THREADS = 128;

// xs (B, N, NX), us (B, N, NU), pxs (B, N, NPX), ts (B,), ds (B, ND), read
// at the strides st: xs, us, pxs two each (along B, N), then ts, ds one
// each.  xf (B, N, NX), jx (B, N, NX, NX), ju (B, N, NX, NU) contiguous.
template <class T>
__global__ void __launch_bounds__(THREADS)
map_stage_jac_kernel(const T* __restrict__ xs, const T* __restrict__ us,
                     const T* __restrict__ pxs, const T* __restrict__ ts,
                     const T* __restrict__ ds, T* __restrict__ xf,
                     T* __restrict__ jx, T* __restrict__ ju, InStrides st,
                     long long L, int N) {
  using V = Dual<T, NZ>;
  const long long l0 = (long long)blockIdx.x * THREADS;
  const int nl = (int)(L - l0 < THREADS ? L - l0 : THREADS);
  // a thread past the last lane computes the last lane again, unstored;
  // L < 2^31 (the wrapper checks it)
  const int l = (int)l0 + (threadIdx.x < nl ? (int)threadIdx.x : nl - 1);
  const long long b = l / N, n = l - b * N;
  const long long* s = st.s;

  V x[NX], u[NU], out[NX];
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
  for (int i = 0; i < MPC_ND; ++i) d[i] = ds[b * s[7] + i];

  mpc_map<V, T>(x, u, d, ts[b * s[6]], px, out);

  store_outputs<T, NX, NU, THREADS>(out, xf, jx, ju, l0, nl);
}

template <class T>
int launch(const void* xs, const void* us, const void* pxs, const void* ts,
           const void* ds, void* xf, void* jx, void* ju, const long long* strides,
           long long L, int N, void* stream) {
  if (L <= 0) return 0;
  const long long blocks = (L + THREADS - 1) / THREADS;
  map_stage_jac_kernel<T><<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const T*)xs, (const T*)us, (const T*)pxs, (const T*)ts, (const T*)ds,
      (T*)xf, (T*)jx, (T*)ju, in_strides(strides, 8), L, N);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int map_stage_jac_f32(const void* xs, const void* us, const void* pxs,
                                 const void* ts, const void* ds, void* xf, void* jx,
                                 void* ju, const long long* strides, long long L,
                                 int N, void* stream) {
  return launch<float>(xs, us, pxs, ts, ds, xf, jx, ju, strides, L, N, stream);
}

extern "C" int map_stage_jac_f64(const void* xs, const void* us, const void* pxs,
                                 const void* ts, const void* ds, void* xf, void* jx,
                                 void* ju, const long long* strides, long long L,
                                 int N, void* stream) {
  return launch<double>(xs, us, pxs, ts, ds, xf, jx, ju, strides, L, N, stream);
}
