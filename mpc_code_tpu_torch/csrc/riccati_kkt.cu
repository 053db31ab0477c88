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
// Layout: the solver's own.  Every input and output is a contiguous
// (B, N, ...) tensor (PN (B, nxa, nxa), pN (B, nxa), delta and ok (B,),
// dX (B, N+1, nxa)), so one lane's stage is one contiguous chunk of each.
// Dimensions NXA, NU are compile-time constants (-D flags) and every
// small-matrix loop is unrolled.
//
// What bounds it on the H100: bytes (48 values in and 25 out per lane and
// stage at nxa=3, nu=2; 198 in and 98 out at nxa=8, nu=2), and the latency
// of the serial chain of small matrix products per stage.  One thread per
// lane gives B/32 warps (4 an SM at B=16384), each a long dependent chain.
// The design:
// - a lane (scenario) is worked by a group of G = 2^ceil(log2 NXA) threads
//   of one warp; thread r < NXA owns row r of P and p, computes row r of
//   P A, P B, Qxx, Qxu and column r of K, and the group exchanges rows
//   through a per-lane scratch in shared memory; the small nu x nu
//   Cholesky and k are computed by every thread of the group.  So a warp
//   holds 32 / G lanes: 4 to 16 times the warps of one thread per lane,
//   and short chains in few registers ((8, 2) builds without spills);
// - a block is one warp and runs its own ring of `depth` slots in dynamic
//   shared memory, filled by cp.async depth-1 stages ahead of the stage
//   being computed, in the backward pass (H, q, A, B, rd) and again in the
//   forward rollout (A, B, rd and the gains K, k the backward pass wrote).
//   Consecutive threads copy consecutive elements of the lanes' chunks
//   laid end to end, so a warp's copy is coalesced although lanes are not
//   innermost.  Host code (riccati_kernel.py::launch_geometry) picks depth
//   so that a warp keeps about 4 KB in flight, ~30-120 KB an SM at
//   B=16384;
// - H's blocks, q, A, B and rd are read from the slot where they are used,
//   not copied into register arrays;
// - outputs are buffered in shared memory for S stages (a P_seq run of at
//   least 128 bytes) and written as each lane's contiguous run, consecutive
//   threads on consecutive elements: written stage by stage, a lane's
//   chunk of 12-36 bytes costs the L1 a wavefront per lane.
// Each lane's rows are padded to an odd number of elements, so a warp
// reading one element of every lane hits distinct banks.  The symmetrised
// P is formed from the scratch by the same instructions in both threads
// that own an entry pair, so it stays exactly symmetric.
// Tensor cores stay out: the matrices are per lane, at most 10x10, with no
// reuse across lanes.

#include <cuda_runtime.h>

#ifndef NXA
#error "NXA must be defined"
#endif
#ifndef NU
#error "NU must be defined"
#endif

namespace {

__host__ __device__ constexpr int pow2_at_least(int n) {
  return n <= 1 ? 1 : 2 * pow2_at_least((n + 1) / 2);
}
constexpr int G = pow2_at_least(NXA);    // threads per lane
static_assert(G <= 32, "a lane's threads must fit one warp");
constexpr int LANES = 32 / G;            // lanes per block (one warp)
constexpr int MAX_DEPTH = 8;
constexpr int NZ = NXA + NU;
__host__ __device__ constexpr int odd(int n) { return n | 1; }

// per-lane chunk sizes of one stage, in elements
constexpr int SH = NZ * NZ, SQ = NZ, SA = NXA * NXA, SB = NXA * NU, SR = NXA;
constexpr int SK = NU * NXA, SKF = NU;
// backward slot: H, q, A, B, rd; forward slot: A, B, rd, K, kf
constexpr int BQ = SH, BA = BQ + SQ, BB = BA + SA, BR = BB + SB, S_BW = BR + SR;
constexpr int FB = SA, FR = FB + SB, FK = FR + SR, FKF = FK + SK, S_FW = FKF + SKF;
constexpr int SP = odd(S_BW > S_FW ? S_BW : S_FW);   // slot row per lane
// scratch per lane: P A, P B, P rd + p, Qxx, Qxu, K, dx
constexpr int XM = 0, XPB = XM + SA, XPR = XPB + SB, XQXX = XPR + SR,
              XQXU = XQXX + SA, XK = XQXU + SB, XDX = XK + SK;
constexpr int XP = odd(XDX + SR);
// Outputs are buffered for S stages per lane, so that a lane's run of each
// output tensor is written as one contiguous piece of at least 128 bytes
// of P_seq: S = ceil(128 / (NXA^2 * itemsize)), 1 to 8.  Buffer regions per
// lane (elements): P_seq, p_seq, K, kf (backward); dX, dU (forward).
template <class T> struct Out {
  static constexpr int S0 = (128 + SA * (int)sizeof(T) - 1) / (SA * (int)sizeof(T));
  static constexpr int S = S0 < 1 ? 1 : (S0 > 8 ? 8 : S0);
  static constexpr int P = 0, PP = P + S * SA, K = PP + S * SR, KF = K + S * SK;
  static constexpr int DX = 0, DU = DX + S * NXA;
  static constexpr int PAD = odd(KF + S * SKF);     // row per lane
};

template <class T> __device__ __forceinline__ T fmax_nan(T a, T b) {
  return (a > b || a != a) ? a : b;
}
__device__ __forceinline__ float dsqrt(float a) { return sqrtf(a); }
__device__ __forceinline__ double dsqrt(double a) { return sqrt(a); }

template <int BYTES>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(gmem),
               "n"(BYTES));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// wait until at most `pending` groups are still in flight (an immediate)
__device__ __forceinline__ void cp_wait(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::); break;
    case 6: asm volatile("cp.async.wait_group 6;\n" ::); break;
    default: asm volatile("cp.async.wait_group 7;\n" ::); break;
  }
}

// Copy the chunk of stage k of `src` ((B, N, C) contiguous) for the block's
// lanes into column `col` of the slot rows: lane i's chunk lands at
// dst[i * SP + col ...].  Thread t takes elements t, t + 32, ... of the
// lanes' chunks laid end to end, so a warp's copy is one coalesced run
// wherever lanes' chunks meet; the loop unrolls.
template <class T, int C>
__device__ __forceinline__ void stage_in(T* dst, int col, const T* __restrict__ src,
                                         int b0, int nlanes, int k, int N) {
  const T* base = src + ((long long)b0 * N + k) * C;
#pragma unroll
  for (int m = 0; m < (LANES * C + 31) / 32; ++m) {
    const int e = threadIdx.x + 32 * m;
    const int i = e / C, off = e - i * C;
    if (e < nlanes * C)
      cp_async<sizeof(T)>(dst + i * SP + col + off, base + (long long)i * N * C + off);
  }
}

// Write the buffered runs of `cnt` stages from stage k of the block's lanes
// to `dst` ((B, NS, C) contiguous): lane i's run of cnt * C elements is
// contiguous there.  Thread t takes elements t, t + 32, ... of the runs laid
// end to end, so a warp's store is coalesced wherever runs meet.  A full
// group (cnt = S) has a compile-time run length and an unrolled loop.
template <class T, int C>
__device__ __forceinline__ void flush(T* __restrict__ dst, const T* buf, int col, int b0,
                                      int nlanes, int k, int cnt, int NS) {
  constexpr int R = Out<T>::S * C;
  T* base = dst + ((long long)b0 * NS + k) * C;
  if (cnt == Out<T>::S) {
#pragma unroll
    for (int m = 0; m < (LANES * R + 31) / 32; ++m) {
      const int e = threadIdx.x + 32 * m;
      const int i = e / R, off = e - i * R;
      if (e < nlanes * R) base[(long long)i * NS * C + off] = buf[i * Out<T>::PAD + col + off];
    }
  } else {
    const int run = cnt * C;
    for (int e = threadIdx.x; e < nlanes * run; e += 32) {
      const int i = e / run, off = e - i * run;
      base[(long long)i * NS * C + off] = buf[i * Out<T>::PAD + col + off];
    }
  }
}

// entry (i, j) of Qxx + Qxu K from the lane's scratch: the same
// instructions in whichever thread forms it
template <class T>
__device__ __forceinline__ T p_new(const T* X, int i, int j) {
  T s = T(0);
#pragma unroll
  for (int a = 0; a < NU; ++a) s += X[XQXU + i * NU + a] * X[XK + a * NXA + j];
  return X[XQXX + i * NXA + j] + s;
}

// Thread t works row r = t % G of lane b0 + t / G.
template <class T>
__global__ void __launch_bounds__(32) riccati_kkt_kernel(
    const T* __restrict__ Hs, const T* __restrict__ q, const T* __restrict__ A,
    const T* __restrict__ Bm, const T* __restrict__ rd, const T* __restrict__ PN,
    const T* __restrict__ pN, const T* __restrict__ delta, T* __restrict__ ok_out,
    T* __restrict__ Ks, T* __restrict__ kf, T* __restrict__ Pseq,
    T* __restrict__ pseq, T* __restrict__ dX, T* __restrict__ dU, int N, int Bsz,
    int depth) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);
  T* scratch = ring + depth * LANES * SP;
  T* buf = scratch + LANES * XP;
  const int g = threadIdx.x / G, r = threadIdx.x % G;
  const int b0 = blockIdx.x * LANES;
  const int nl = min(LANES, Bsz - b0);
  const bool live = g < nl;
  const bool row = live && r < NXA;
  const int b = b0 + g;
  T* X = scratch + g * XP;
  T* ob = buf + g * Out<T>::PAD;

  // the ring slot that the next issue fills and the one that the next stage
  // reads, advanced in turn
  int fill = 0, use = 0;
  auto next = [&](int& slot) { slot = slot + 1 == depth ? 0 : slot + 1; };
  auto issue_bw = [&](int i) {        // i-th stage of the backward order
    if (i < N) {
      T* slot = ring + fill * LANES * SP;
      const int k = N - 1 - i;
      stage_in<T, SH>(slot, 0, Hs, b0, nl, k, N);
      stage_in<T, SQ>(slot, BQ, q, b0, nl, k, N);
      stage_in<T, SA>(slot, BA, A, b0, nl, k, N);
      stage_in<T, SB>(slot, BB, Bm, b0, nl, k, N);
      stage_in<T, SR>(slot, BR, rd, b0, nl, k, N);
    }
    cp_commit();                      // an empty group past the end keeps the count
    next(fill);
  };
  auto issue_fw = [&](int k) {
    if (k < N) {
      T* slot = ring + fill * LANES * SP;
      stage_in<T, SA>(slot, 0, A, b0, nl, k, N);
      stage_in<T, SB>(slot, FB, Bm, b0, nl, k, N);
      stage_in<T, SR>(slot, FR, rd, b0, nl, k, N);
      stage_in<T, SK>(slot, FK, Ks, b0, nl, k, N);
      stage_in<T, SKF>(slot, FKF, kf, b0, nl, k, N);
    }
    cp_commit();
    next(fill);
  };
  using O = Out<T>;
  constexpr int S = O::S;

  T P[NXA], pv = T(0);                // row r of P, p[r]
  T okv = T(1), dl = T(0);
  if (row) {
#pragma unroll
    for (int c = 0; c < NXA; ++c) P[c] = PN[(long long)b * SA + r * NXA + c];
    pv = pN[(long long)b * NXA + r];
  }
  if (live) dl = delta[b];
  const T tiny = T(1e-30);

  for (int i = 0; i < depth - 1; ++i) issue_bw(i);
  for (int i = 0; i < N; ++i) {
    const int k = N - 1 - i;
    // the buffered group of stages [k_lo, k_hi] holding stage k
    const int k_hi = N - 1 - (i / S) * S, k_lo = max(0, k_hi - S + 1), t = k - k_lo;
    issue_bw(i + depth - 1);
    cp_wait(depth - 1);
    __syncwarp();
    const T* s = ring + use * LANES * SP + g * SP;
    next(use);
#define HH(rr, cc) s[(rr) * NZ + (cc)]
#define AA(rr, cc) s[BA + (rr) * NXA + (cc)]
#define BM(rr, cc) s[BB + (rr) * NU + (cc)]
    if (row) {
      // P_{k+1}, p_{k+1} before the update (multiplier recovery)
#pragma unroll
      for (int c = 0; c < NXA; ++c) ob[O::P + t * SA + r * NXA + c] = P[c];
      ob[O::PP + t * SR + r] = pv;
      // row r of P rd + p, P B, P A
      T sr = T(0);
#pragma unroll
      for (int c = 0; c < NXA; ++c) sr += P[c] * s[BR + c];
      X[XPR + r] = pv + sr;
#pragma unroll
      for (int u = 0; u < NU; ++u) {
        T sb = T(0);
#pragma unroll
        for (int c = 0; c < NXA; ++c) sb += P[c] * BM(c, u);
        X[XPB + r * NU + u] = sb;
      }
#pragma unroll
      for (int j = 0; j < NXA; ++j) {
        T sm = T(0);
#pragma unroll
        for (int c = 0; c < NXA; ++c) sm += P[c] * AA(c, j);
        X[XM + r * NXA + j] = sm;
      }
    }
    __syncwarp();
    // row r of Qxx = Hxx + A' P A and of Qxu = Hxu + A' P B, qx[r] = q_x[r] + A_r' Pr
    T Qxu_r[NU], qx_r = T(0);
    if (row) {
#pragma unroll
      for (int j = 0; j < NXA; ++j) {
        T sw = T(0);
#pragma unroll
        for (int a = 0; a < NXA; ++a) sw += AA(a, r) * X[XM + a * NXA + j];
        X[XQXX + r * NXA + j] = HH(r, j) + sw;
      }
#pragma unroll
      for (int u = 0; u < NU; ++u) {
        T sx = T(0);
#pragma unroll
        for (int a = 0; a < NXA; ++a) sx += AA(a, r) * X[XPB + a * NU + u];
        Qxu_r[u] = HH(r, NXA + u) + sx;
        X[XQXU + r * NU + u] = Qxu_r[u];
      }
      T sg = T(0);
#pragma unroll
      for (int a = 0; a < NXA; ++a) sg += AA(a, r) * X[XPR + a];
      qx_r = s[BQ + r] + sg;
    }
    T kk[NU];
    if (live) {
      // Quu = Huu + B' P B + delta I, qu = q_u + B' Pr, in every thread
      T Quu[NU][NU], qu[NU];
#pragma unroll
      for (int u = 0; u < NU; ++u) {
#pragma unroll
        for (int v = 0; v < NU; ++v) {
          T sq = T(0);
#pragma unroll
          for (int a = 0; a < NXA; ++a) sq += BM(a, u) * X[XPB + a * NU + v];
          Quu[u][v] = HH(NXA + u, NXA + v) + sq + (u == v ? dl : T(0));
        }
        T sg = T(0);
#pragma unroll
        for (int a = 0; a < NXA; ++a) sg += BM(a, u) * X[XPR + a];
        qu[u] = s[BQ + NXA + u] + sg;
      }
      // Cholesky of Quu with per-lane validity; w[a] = 1 / L[a][a], so the
      // factor and the solves multiply
      T L[NU][NU], w[NU];
#pragma unroll
      for (int a = 0; a < NU; ++a) {
        T sd = T(0);
#pragma unroll
        for (int m = 0; m < a; ++m) sd += L[a][m] * L[a][m];
        T dd = Quu[a][a] - sd;
        okv = okv * (dd > tiny ? T(1) : T(0));
        dd = fmax_nan(dd, tiny);
        L[a][a] = dsqrt(dd);
        w[a] = T(1) / L[a][a];
#pragma unroll
        for (int c = a + 1; c < NU; ++c) {
          T s2 = T(0);
#pragma unroll
          for (int m = 0; m < a; ++m) s2 += L[c][m] * L[a][m];
          L[c][a] = (Quu[c][a] - s2) * w[a];
        }
      }
      // column r of K = -Quu^{-1} Qxu' (rows of the lane's threads) and
      // kk = -Quu^{-1} qu (every thread)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        if (c == 0 && !row) continue;
        T y[NU], xx[NU];
#pragma unroll
        for (int a = 0; a < NU; ++a) {
          T sy = T(0);
#pragma unroll
          for (int m = 0; m < a; ++m) sy += L[a][m] * y[m];
          const T rhs = c == 0 ? Qxu_r[a] : qu[a];
          y[a] = (rhs - sy) * w[a];
        }
#pragma unroll
        for (int a = NU - 1; a >= 0; --a) {
          T sx = T(0);
#pragma unroll
          for (int m = a + 1; m < NU; ++m) sx += L[m][a] * xx[m];
          xx[a] = (y[a] - sx) * w[a];
        }
#pragma unroll
        for (int a = 0; a < NU; ++a) {
          if (c == 0) {
            X[XK + a * NXA + r] = -xx[a];
            ob[O::K + t * SK + a * NXA + r] = -xx[a];
          } else {
            kk[a] = -xx[a];
          }
        }
      }
      if (r == 0) {
#pragma unroll
        for (int a = 0; a < NU; ++a) ob[O::KF + t * SKF + a] = kk[a];
      }
    }
#undef HH
#undef AA
#undef BM
    __syncwarp();
    // row r of P = sym(Qxx + Qxu K), p[r] = qx[r] + Qxu_r kk
    if (row) {
#pragma unroll
      for (int c = 0; c < NXA; ++c) {
        const T prc = p_new(X, r, c), pcr = p_new(X, c, r);
        P[c] = T(0.5) * (prc + pcr);
      }
      T sp = T(0);
#pragma unroll
      for (int a = 0; a < NU; ++a) sp += Qxu_r[a] * kk[a];
      pv = qx_r + sp;
    }
    __syncwarp();
    if (k == k_lo) {
      const int cnt = k_hi - k_lo + 1;
      flush<T, SA>(Pseq, buf, O::P, b0, nl, k_lo, cnt, N);
      flush<T, SR>(pseq, buf, O::PP, b0, nl, k_lo, cnt, N);
      flush<T, SK>(Ks, buf, O::K, b0, nl, k_lo, cnt, N);
      flush<T, SKF>(kf, buf, O::KF, b0, nl, k_lo, cnt, N);
      __syncwarp();
    }
  }
  if (live && r == 0) ok_out[b] = okv;

  // forward rollout; the gains the warp just wrote are read back through
  // the ring
  __threadfence_block();
  __syncwarp();
  T dx = T(0);                        // dx[r]
  if (row) dX[(long long)b * (N + 1) * NXA + r] = T(0);
  fill = use = 0;                     // every copy of the backward pass has landed
  for (int k = 0; k < depth - 1; ++k) issue_fw(k);
  for (int k = 0; k < N; ++k) {
    const int k_lo = (k / S) * S, t = k - k_lo;
    issue_fw(k + depth - 1);
    cp_wait(depth - 1);
    if (row) X[XDX + r] = dx;
    __syncwarp();
    const T* s = ring + use * LANES * SP + g * SP;
    next(use);
    if (live) {
      T du[NU];
#pragma unroll
      for (int a = 0; a < NU; ++a) {
        T sk = T(0);
#pragma unroll
        for (int c = 0; c < NXA; ++c) sk += s[FK + a * NXA + c] * X[XDX + c];
        du[a] = s[FKF + a] + sk;
      }
      if (row) {
        T sa = T(0), sb = T(0);
#pragma unroll
        for (int c = 0; c < NXA; ++c) sa += s[r * NXA + c] * X[XDX + c];
#pragma unroll
        for (int c = 0; c < NU; ++c) sb += s[FB + r * NU + c] * du[c];
        dx = sa + sb + s[FR + r];
        ob[O::DX + t * NXA + r] = dx;
      }
      if (r == 0) {
#pragma unroll
        for (int a = 0; a < NU; ++a) ob[O::DU + t * NU + a] = du[a];
      }
    }
    __syncwarp();
    if (t == S - 1 || k == N - 1) {
      flush<T, NXA>(dX, buf, O::DX, b0, nl, k_lo + 1, t + 1, N + 1);
      flush<T, NU>(dU, buf, O::DU, b0, nl, k_lo, t + 1, N);
      __syncwarp();
    }
  }
}

}  // namespace

// Dynamic shared memory of a block for a ring of `depth` slots, in bytes
// (riccati_kernel.py::launch_geometry computes the same).
extern "C" long long riccati_kkt_smem(int depth, int itemsize) {
  const int pad = itemsize == 8 ? Out<double>::PAD : Out<float>::PAD;
  return (long long)itemsize * LANES * ((long long)depth * SP + XP + pad);
}

namespace {

template <class T>
int launch(const void* Hs, const void* q, const void* A, const void* Bm,
           const void* rd, const void* PN, const void* pN, const void* delta,
           void* ok, void* Ks, void* kf, void* Pseq, void* pseq, void* dX,
           void* dU, int N, int Bsz, int depth, void* stream) {
  if (Bsz <= 0 || N <= 0) return 0;
  if (depth < 2 || depth > MAX_DEPTH) return (int)cudaErrorInvalidValue;
  const long long smem = riccati_kkt_smem(depth, (int)sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(
      riccati_kkt_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (Bsz + LANES - 1) / LANES;
  riccati_kkt_kernel<T><<<blocks, 32, (size_t)smem, (cudaStream_t)stream>>>(
      (const T*)Hs, (const T*)q, (const T*)A, (const T*)Bm, (const T*)rd,
      (const T*)PN, (const T*)pN, (const T*)delta, (T*)ok, (T*)Ks, (T*)kf,
      (T*)Pseq, (T*)pseq, (T*)dX, (T*)dU, N, Bsz, depth);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int riccati_kkt_f32(const void* Hs, const void* q, const void* A,
                               const void* Bm, const void* rd, const void* PN,
                               const void* pN, const void* delta, void* ok,
                               void* Ks, void* kf, void* Pseq, void* pseq,
                               void* dX, void* dU, int N, int Bsz, int depth,
                               void* stream) {
  return launch<float>(Hs, q, A, Bm, rd, PN, pN, delta, ok, Ks, kf, Pseq, pseq,
                       dX, dU, N, Bsz, depth, stream);
}

extern "C" int riccati_kkt_f64(const void* Hs, const void* q, const void* A,
                               const void* Bm, const void* rd, const void* PN,
                               const void* pN, const void* delta, void* ok,
                               void* Ks, void* kf, void* Pseq, void* pseq,
                               void* dX, void* dU, int N, int Bsz, int depth,
                               void* stream) {
  return launch<double>(Hs, q, A, Bm, rd, PN, pN, delta, ok, Ks, kf, Pseq, pseq,
                        dX, dU, N, Bsz, depth, stream);
}
