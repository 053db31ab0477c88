// Riccati KKT solve for Hopper (sm_90a).
//
// Replaces mpc_code_tpu/solver/riccati_kernel.py::_make_kernel, the Pallas
// kernel that make_riccati_kkt builds and the structured IPM calls as
// kkt_fused once per iteration.  Per lane (one scenario) it runs the
// backward Riccati pass over N stages -- Quu, Qxu, Qxx, an unrolled
// Cholesky of Quu with the TPU kernel's validity rule (d > 1e-30, then
// clamp), the gains K, k and the symmetrised value function P, p -- and
// then the forward rollout of dX, dU.
//
// Layout: every input and output is a stack of planes with the lane
// (scenario) index innermost, plane index = stage * dim + element, so a
// warp's loads and stores are coalesced.  Dimensions NXA, NU are compile
// time constants (-D flags) and every small-matrix loop is unrolled.
//
// What bounds it on the H100: bytes (~2.4k values in, ~1.3k out per lane
// at nxa=3, nu=2, N=50; about 70 us of HBM time at B=16384 in f32).  One
// thread per lane keeps P and p in registers across the whole backward
// pass; the forward pass reads back the gains this thread just wrote.
// At B=16384 and 128 threads per block this is 128 blocks on 132 SMs, so
// memory latency, not bandwidth, decides the time: a later change can
// split lanes finer or prefetch a stage ahead.

#include <cuda_runtime.h>

#ifndef NXA
#error "NXA must be defined"
#endif
#ifndef NU
#error "NU must be defined"
#endif

namespace {

constexpr int NZ = NXA + NU;

template <class T> __device__ __forceinline__ T fmax_nan(T a, T b) {
  return (a > b || a != a) ? a : b;
}
__device__ __forceinline__ float dsqrt(float a) { return sqrtf(a); }
__device__ __forceinline__ double dsqrt(double a) { return sqrt(a); }

template <class T>
__global__ void riccati_kkt_kernel(
    const T* __restrict__ Hs, const T* __restrict__ q, const T* __restrict__ A,
    const T* __restrict__ Bm, const T* __restrict__ rd, const T* __restrict__ PN,
    const T* __restrict__ pN, const T* __restrict__ delta, T* __restrict__ ok_out,
    T* __restrict__ Ks, T* __restrict__ kf, T* __restrict__ Pseq,
    T* __restrict__ pseq, T* __restrict__ dX, T* __restrict__ dU, int N, int Bsz) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= Bsz) return;
  const long long S = Bsz;
#define AT(arr, k, dim, i) arr[((long long)(k) * (dim) + (i)) * S + b]

  T P[NXA][NXA], p[NXA];
#pragma unroll
  for (int i = 0; i < NXA; ++i) {
#pragma unroll
    for (int j = 0; j < NXA; ++j) P[i][j] = AT(PN, 0, NXA * NXA, i * NXA + j);
    p[i] = AT(pN, 0, NXA, i);
  }
  T okv = T(1);
  const T dl = delta[b];
  const T tiny = T(1e-30);

  for (int k = N - 1; k >= 0; --k) {
    // P_{k+1}, p_{k+1} before the update (multiplier recovery)
#pragma unroll
    for (int i = 0; i < NXA; ++i) {
#pragma unroll
      for (int j = 0; j < NXA; ++j) AT(Pseq, k, NXA * NXA, i * NXA + j) = P[i][j];
      AT(pseq, k, NXA, i) = p[i];
    }
    T H[NZ][NZ], qk[NZ], Ak[NXA][NXA], Bk[NXA][NU], rk[NXA];
#pragma unroll
    for (int i = 0; i < NZ; ++i) {
#pragma unroll
      for (int j = 0; j < NZ; ++j) H[i][j] = AT(Hs, k, NZ * NZ, i * NZ + j);
      qk[i] = AT(q, k, NZ, i);
    }
#pragma unroll
    for (int i = 0; i < NXA; ++i) {
#pragma unroll
      for (int j = 0; j < NXA; ++j) Ak[i][j] = AT(A, k, NXA * NXA, i * NXA + j);
#pragma unroll
      for (int j = 0; j < NU; ++j) Bk[i][j] = AT(Bm, k, NXA * NU, i * NU + j);
      rk[i] = AT(rd, k, NXA, i);
    }

    T PB[NXA][NU], PA[NXA][NXA];
#pragma unroll
    for (int a = 0; a < NXA; ++a) {
#pragma unroll
      for (int j = 0; j < NU; ++j) {
        T s = T(0);
#pragma unroll
        for (int c = 0; c < NXA; ++c) s += P[a][c] * Bk[c][j];
        PB[a][j] = s;
      }
#pragma unroll
      for (int j = 0; j < NXA; ++j) {
        T s = T(0);
#pragma unroll
        for (int c = 0; c < NXA; ++c) s += P[a][c] * Ak[c][j];
        PA[a][j] = s;
      }
    }
    T Quu[NU][NU], Qxu[NXA][NU], Qxx[NXA][NXA], Pr[NXA], qx[NXA], qu[NU];
#pragma unroll
    for (int i = 0; i < NU; ++i) {
#pragma unroll
      for (int j = 0; j < NU; ++j) {
        T s = T(0);
#pragma unroll
        for (int a = 0; a < NXA; ++a) s += Bk[a][i] * PB[a][j];
        Quu[i][j] = H[NXA + i][NXA + j] + s + (i == j ? dl : T(0));
      }
    }
#pragma unroll
    for (int i = 0; i < NXA; ++i) {
#pragma unroll
      for (int j = 0; j < NU; ++j) {
        T s = T(0);
#pragma unroll
        for (int a = 0; a < NXA; ++a) s += Ak[a][i] * PB[a][j];
        Qxu[i][j] = H[i][NXA + j] + s;
      }
#pragma unroll
      for (int j = 0; j < NXA; ++j) {
        T s = T(0);
#pragma unroll
        for (int a = 0; a < NXA; ++a) s += Ak[a][i] * PA[a][j];
        Qxx[i][j] = H[i][j] + s;
      }
    }
#pragma unroll
    for (int a = 0; a < NXA; ++a) {
      T s = T(0);
#pragma unroll
      for (int c = 0; c < NXA; ++c) s += P[a][c] * rk[c];
      Pr[a] = p[a] + s;
    }
#pragma unroll
    for (int i = 0; i < NXA; ++i) {
      T s = T(0);
#pragma unroll
      for (int a = 0; a < NXA; ++a) s += Ak[a][i] * Pr[a];
      qx[i] = qk[i] + s;
    }
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      T s = T(0);
#pragma unroll
      for (int a = 0; a < NXA; ++a) s += Bk[a][i] * Pr[a];
      qu[i] = qk[NXA + i] + s;
    }

    // Cholesky of Quu with per-lane validity
    T L[NU][NU];
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      T s = T(0);
#pragma unroll
      for (int m = 0; m < i; ++m) s += L[i][m] * L[i][m];
      T dd = Quu[i][i] - s;
      okv = okv * (dd > tiny ? T(1) : T(0));
      dd = fmax_nan(dd, tiny);
      L[i][i] = dsqrt(dd);
#pragma unroll
      for (int j = i + 1; j < NU; ++j) {
        T s2 = T(0);
#pragma unroll
        for (int m = 0; m < i; ++m) s2 += L[j][m] * L[i][m];
        L[j][i] = (Quu[j][i] - s2) / L[i][i];
      }
    }

    // K = -Quu^{-1} Qxu', kk = -Quu^{-1} qu: NXA + 1 right-hand sides
    T Kc[NXA + 1][NU];
#pragma unroll
    for (int c = 0; c <= NXA; ++c) {
      T y[NU], xx[NU];
#pragma unroll
      for (int i = 0; i < NU; ++i) {
        T s = T(0);
#pragma unroll
        for (int m = 0; m < i; ++m) s += L[i][m] * y[m];
        const T rhs = c < NXA ? Qxu[c][i] : qu[i];
        y[i] = (rhs - s) / L[i][i];
      }
#pragma unroll
      for (int i = NU - 1; i >= 0; --i) {
        T s = T(0);
#pragma unroll
        for (int j = i + 1; j < NU; ++j) s += L[j][i] * xx[j];
        xx[i] = (y[i] - s) / L[i][i];
      }
#pragma unroll
      for (int i = 0; i < NU; ++i) Kc[c][i] = -xx[i];
    }
#pragma unroll
    for (int i = 0; i < NU; ++i) {
#pragma unroll
      for (int j = 0; j < NXA; ++j) AT(Ks, k, NU * NXA, i * NXA + j) = Kc[j][i];
      AT(kf, k, NU, i) = Kc[NXA][i];
    }

    // P_new = Qxx + Qxu K (symmetrised), p_new = qx + Qxu kk
    T Pn[NXA][NXA];
#pragma unroll
    for (int i = 0; i < NXA; ++i) {
#pragma unroll
      for (int j = 0; j < NXA; ++j) {
        T s = T(0);
#pragma unroll
        for (int a = 0; a < NU; ++a) s += Qxu[i][a] * Kc[j][a];
        Pn[i][j] = Qxx[i][j] + s;
      }
    }
#pragma unroll
    for (int i = 0; i < NXA; ++i) {
#pragma unroll
      for (int j = 0; j < NXA; ++j) P[i][j] = T(0.5) * (Pn[i][j] + Pn[j][i]);
      T s = T(0);
#pragma unroll
      for (int a = 0; a < NU; ++a) s += Qxu[i][a] * Kc[NXA][a];
      p[i] = qx[i] + s;
    }
  }
  ok_out[b] = okv;

  // forward rollout
  T dx[NXA];
#pragma unroll
  for (int i = 0; i < NXA; ++i) {
    dx[i] = T(0);
    AT(dX, 0, NXA, i) = T(0);
  }
  for (int k = 0; k < N; ++k) {
    T du[NU], dn[NXA];
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      T s = T(0);
#pragma unroll
      for (int j = 0; j < NXA; ++j) s += AT(Ks, k, NU * NXA, i * NXA + j) * dx[j];
      du[i] = AT(kf, k, NU, i) + s;
    }
#pragma unroll
    for (int i = 0; i < NXA; ++i) {
      T sa = T(0), sb = T(0);
#pragma unroll
      for (int j = 0; j < NXA; ++j) sa += AT(A, k, NXA * NXA, i * NXA + j) * dx[j];
#pragma unroll
      for (int j = 0; j < NU; ++j) sb += AT(Bm, k, NXA * NU, i * NU + j) * du[j];
      dn[i] = sa + sb + AT(rd, k, NXA, i);
    }
#pragma unroll
    for (int i = 0; i < NU; ++i) AT(dU, k, NU, i) = du[i];
#pragma unroll
    for (int i = 0; i < NXA; ++i) {
      AT(dX, k + 1, NXA, i) = dn[i];
      dx[i] = dn[i];
    }
  }
#undef AT
}

template <class T>
int launch(const void* Hs, const void* q, const void* A, const void* Bm,
           const void* rd, const void* PN, const void* pN, const void* delta,
           void* ok, void* Ks, void* kf, void* Pseq, void* pseq, void* dX,
           void* dU, int N, int Bsz, void* stream) {
  if (Bsz <= 0) return 0;
  const int threads = 128;
  const int blocks = (Bsz + threads - 1) / threads;
  riccati_kkt_kernel<T><<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const T*)Hs, (const T*)q, (const T*)A, (const T*)Bm, (const T*)rd,
      (const T*)PN, (const T*)pN, (const T*)delta, (T*)ok, (T*)Ks, (T*)kf,
      (T*)Pseq, (T*)pseq, (T*)dX, (T*)dU, N, Bsz);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int riccati_kkt_f32(const void* Hs, const void* q, const void* A,
                               const void* Bm, const void* rd, const void* PN,
                               const void* pN, const void* delta, void* ok,
                               void* Ks, void* kf, void* Pseq, void* pseq,
                               void* dX, void* dU, int N, int Bsz, void* stream) {
  return launch<float>(Hs, q, A, Bm, rd, PN, pN, delta, ok, Ks, kf, Pseq, pseq,
                       dX, dU, N, Bsz, stream);
}

extern "C" int riccati_kkt_f64(const void* Hs, const void* q, const void* A,
                               const void* Bm, const void* rd, const void* PN,
                               const void* pN, const void* delta, void* ok,
                               void* Ks, void* kf, void* Pseq, void* pseq,
                               void* dX, void* dU, int N, int Bsz, void* stream) {
  return launch<double>(Hs, q, A, Bm, rd, PN, pN, delta, ok, Ks, kf, Pseq, pseq,
                        dX, dU, N, Bsz, stream);
}
