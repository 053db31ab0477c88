// Reading and writing the solver's (B, N, ...) tensors in place, for the
// sweep kernels that run one thread per (scenario, stage) lane, lane
// l = b * N + n (csrc/rk4_stage_jac.cu, csrc/map_stage_jac.cu).
//
// Inputs are read where the solver keeps them: a (B, N, k) stage input at
// element b * sb + n * sn + i, a (B, k) or (B,) per-scenario input at
// b * sb + i, with the strides sb, sn of the caller's tensor (0 where it
// expanded one value over the batch) and the last dimension unit-stride.
// A warp's lanes read neighbouring records, so the first load of a record
// brings its neighbours into L1 for the next.
//
// Outputs are contiguous (B, N, ...) tensors, a row of R values a lane.
// Stored lane by lane, a warp's store would touch 32 rows R values apart
// and send ~R partial sectors to L2 per instruction (kernel 3 then takes
// three times as long on the H100); staged through shared memory, the
// block writes its rows as one contiguous run, consecutive threads at
// consecutive addresses.
#pragma once

// Element strides of the inputs, in the launcher's order (two for a stage
// input, one for a per-scenario input); passed by value.
struct InStrides {
  static constexpr int MAX = 12;
  long long s[MAX];
};

// The block's rows of R values, left by thread t at sm[t * R, (t + 1) * R),
// written to out[l0 * R, (l0 + nl) * R); every thread of the block calls
// it.  Thread t writes entries t, t + THREADS, ...: R stores, unrolled.
template <class T, int R, int THREADS>
__device__ __forceinline__ void store_rows(T* __restrict__ out, const T* sm,
                                           long long l0, int nl) {
  __syncthreads();
  T* o = out + l0 * R;
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const int k = q * THREADS + threadIdx.x;
    if (k < nl * R) o[k] = sm[k];
  }
  __syncthreads();
}

// A block's lanes [l0, l0 + nl) write their NX values y (Dual numbers with
// NX + NU tangents) as xf (B, N, NX), Jx (B, N, NX, NX) and Ju (B, N, NX, NU),
// one output at a time through shared memory.  Every thread of the block
// calls it, those past the last lane too.
template <class T, int NX, int NU, int THREADS, class V>
__device__ __forceinline__ void store_outputs(const V* y, T* __restrict__ xf,
                                              T* __restrict__ jx, T* __restrict__ ju,
                                              long long l0, int nl) {
  constexpr int ROW = NX * NX > NX * NU ? NX * NX : NX * NU;
  __shared__ T sm[THREADS * ROW];
  const int t = threadIdx.x;
#pragma unroll
  for (int i = 0; i < NX; ++i) sm[t * NX + i] = y[i].v;
  store_rows<T, NX, THREADS>(xf, sm, l0, nl);
#pragma unroll
  for (int i = 0; i < NX; ++i)
#pragma unroll
    for (int j = 0; j < NX; ++j) sm[(t * NX + i) * NX + j] = y[i].d[j];
  store_rows<T, NX * NX, THREADS>(jx, sm, l0, nl);
#pragma unroll
  for (int i = 0; i < NX; ++i)
#pragma unroll
    for (int j = 0; j < NU; ++j) sm[(t * NX + i) * NU + j] = y[i].d[NX + j];
  store_rows<T, NX * NU, THREADS>(ju, sm, l0, nl);
}

// The C launchers take the strides as a host array of n entries.
inline InStrides in_strides(const long long* s, int n) {
  InStrides r;
  for (int i = 0; i < InStrides::MAX; ++i) r.s[i] = i < n ? s[i] : 0;
  return r;
}
