// The dense exact engine's f64 finish on the card (sm_90a).
//
// Replaces no TPU kernel: the JAX package downloads its (P, n) counts and
// finishes on the host (parfastaai_tpu/engine.py `jaccard_finish`, the
// native `jaccard_finish_f64`).  It was added so that the port's dense
// exact path (engine.compute) stops downloading the (P, n) counts and
// gathering two (P, n) T arrays on the host: the counts stay where
// ops/fused.py `pair_counts_device` left them, and only S and N cross the
// bus.  For each genome pair i, over the proteins p in ascending order,
//
//     c = counts[p, i]
//     if c > 0:  S += c / (T[p, a_i] + T[p, b_i] - c)   (f64)
//                N += 1                                  (int32)
//
// with a_i = denom_a[i], b_i = denom_b[i].  The denominator is formed in
// 64-bit integers and the divide and add are the explicit round-to-nearest
// intrinsics, so nvcc can neither contract nor reorder them: the operation
// order of the host's `jaccard_finish_f64` (native/pfaai_native.cpp), whose
// SSE2 divsd / addsd round the same way, so S and N are bit-equal to it.
//
// Bound: memory.  A qsub-q512-g4096 call reads 80 x 1,965,824 int16 counts
// (315 MB), the two id vectors (16 MB) and writes S and N (24 MB): ~355 MB,
// ~0.1 ms at 3.35 TB/s.  Its 157M f64 divides are well below the card's
// FP64 rate.
//
// Design: one thread a pair, neighbouring threads on neighbouring pairs, so
// each protein row of the counts is read coalesced; a grid-stride loop
// covers any n.  T is (P, G_t) int32, 1.3 MB at G_t = 4096: its columns
// are gathered per pair and read through L2 (__ldg), where the whole of it
// stays.  No shared memory, no atomics: each pair's sum is one thread's, in
// the host's order, so the result is deterministic.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 1 << 16;

template <typename C>
__global__ void __launch_bounds__(kThreads)
    finish_f64_kernel(const C* __restrict__ counts,
                      const int32_t* __restrict__ t,
                      const int32_t* __restrict__ denom_a,
                      const int32_t* __restrict__ denom_b, int64_t P,
                      int64_t n, int64_t g_t, double* __restrict__ s,
                      int32_t* __restrict__ nshared) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride) {
    const int32_t* ta = t + __ldg(denom_a + i);
    const int32_t* tb = t + __ldg(denom_b + i);
    double acc = 0.0;
    int32_t cnt_shared = 0;
#pragma unroll 4
    for (int64_t p = 0; p < P; ++p) {
      const int32_t c = static_cast<int32_t>(__ldg(counts + p * n + i));
      if (c > 0) {
        const int64_t denom = static_cast<int64_t>(__ldg(ta + p * g_t)) +
                              __ldg(tb + p * g_t) - c;
        acc = __dadd_rn(acc, __ddiv_rn(static_cast<double>(c),
                                       static_cast<double>(denom)));
        ++cnt_shared;
      }
    }
    s[i] = acc;
    nshared[i] = cnt_shared;
  }
}

template <typename C>
cudaError_t launch(const void* counts, const int32_t* t, const int32_t* da,
                   const int32_t* db, int64_t P, int64_t n, int64_t g_t,
                   double* s, int32_t* nshared, cudaStream_t stream) {
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  finish_f64_kernel<C><<<static_cast<unsigned>(
                             blocks < kMaxBlocks ? blocks : kMaxBlocks),
                         kThreads, 0, stream>>>(
      static_cast<const C*>(counts), t, da, db, P, n, g_t, s, nshared);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches on `stream` and returns the first CUDA error (0 on success).
// counts (P, n) int16 (itemsize 2) or int32 (itemsize 4), t (P, g_t) int32,
// denom_a / denom_b (n) int32 ids in [0, g_t); s (n) f64 and nshared (n)
// int32 are written in full.  n >= 1, P >= 0.
int finish_f64_launch(const void* counts, int itemsize, const void* t,
                      const void* denom_a, const void* denom_b, long long P,
                      long long n, long long g_t, void* s, void* nshared,
                      void* stream) {
  if (n <= 0 || P < 0 || g_t <= 0 || (itemsize != 2 && itemsize != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t* ti = static_cast<const int32_t*>(t);
  const int32_t* da = static_cast<const int32_t*>(denom_a);
  const int32_t* db = static_cast<const int32_t*>(denom_b);
  double* so = static_cast<double*>(s);
  int32_t* no = static_cast<int32_t*>(nshared);
  if (itemsize == 2)
    return static_cast<int>(
        launch<int16_t>(counts, ti, da, db, P, n, g_t, so, no, st));
  return static_cast<int>(
      launch<int32_t>(counts, ti, da, db, P, n, g_t, so, no, st));
}

const char* finish_f64_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
