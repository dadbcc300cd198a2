// Square all-vs-all fused (S, N) with the counts from the tensor cores as
// f32, for Hopper (sm_90a).
//
// Replaces the `f32gram` body of `_pallas_sn_sym_2p` in
// parfastaai_tpu/ops/pallas_intersect.py: `_sym_kernel_2p` with
// `_gram(f32=True)`, whose matrix unit was to emit each protein's counts
// directly as f32 (exact: every count is <= K < 2^24), so that the Jaccard
// transform needs no int -> float convert.  Per protein p in ascending
// order, two proteins per step,
//
//     cf = M_p . M_p^T                       (f32 counts, tensor cores)
//     S += cf / (t_p[i] + t_p[j] - cf)       (f32, T pre-clamped >= 1)
//     N += min(cf, 1)                        (int32)
//
// over the upper-triangle tiles, with the same contract as sn_square.cu's
// two-proteins-per-step `lean` launch: an int32 (n_tiles, 2) tile list and
// a 1-D grid, each off-diagonal tile's mirror written in the epilogue,
// ragged G masked (rows past G load zeros and are never stored), an odd P
// run with a zero second protein, K a multiple of 64 (the wrapper pads it),
// and the same three divide modes with explicit round-to-nearest
// intrinsics.  The counts are exact and the transform's op order is
// `lean`'s, so the result is bit-identical to the `lean` kernel in every
// mode.
//
// Design (simple and right first):
//   * One thread block per 64 x 64 output tile, 256 threads = 8 warps; warp
//     w owns rows 16 (w / 2) .. +15 and columns 32 (w % 2) .. +31 as four
//     m16n8 accumulator fragments per protein: 16 f32 counts a thread per
//     protein, and its S and N in the same layout.
//   * Counts by mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32.  Each
//     64-byte K slice of the 0/1 presence bytes is converted once, while it
//     is staged, to f16 in shared memory (1.0 is 0x3C00: __byte_perm puts
//     two bytes into the two 16-bit halves of a word and a multiply by
//     0x3C00 makes them halves, with no carry across them).  f16 and f32
//     accumulation are exact for 0/1 inputs and counts < 2^24; fp8 is not
//     used, since its accumulation width on Hopper is not known to be f32's.
//   * The contraction is a sum over k, so the fragment's k order is free as
//     long as A and B share it: lane (g, tig) takes the four consecutive
//     halves 4 tig .. 4 tig + 3 of each k16 chunk, the fragment's k pairs
//     (2 tig, 2 tig + 1) and (2 tig + 8, 2 tig + 9), with one 8-byte load per
//     row.  Staged rows are 80 halves apart, so those loads are free of bank
//     conflicts.
//   * No ldmatrix, cp.async, TMA or wgmma yet, and no atomics.
//
// What bounds it on the H100: the per-warp mma.sync issue and the shared-
// memory loads that feed it, behind synchronous global loads with one
// slice in flight; the f16 conversion runs once per staged byte.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;         // output tile edge (rows and columns)
constexpr int kThreads = 256;     // 8 warps
constexpr int kPP = 2;            // proteins per step
constexpr int kSliceBytes = 64;   // K bytes staged per shared-memory slice
constexpr int kLd = kSliceBytes + 16;  // staged row stride in halves
constexpr int kFrags = 4;         // n8 accumulator fragments per warp
constexpr unsigned int kHalfOne = 0x3C00u;

__device__ __forceinline__ float rcp_approx(float x) {
  float r;
  asm("rcp.approx.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// One Jaccard term of the f32 count cf, as sn_square.cu's jaccard() after
// its int -> float convert.  mode: 0 = Newton-refined reciprocal, 1 = raw
// approximate reciprocal, 2 = IEEE divide.
template <int kMode>
__device__ __forceinline__ float jaccard(float cf, float ta, float tb) {
  const float outer = __fadd_rn(ta, tb);
  const float d = __fsub_rn(outer, cf);  // >= 1; cf == 0 gives j == 0
  if (kMode == 2) return __fdiv_rn(cf, d);
  if (kMode == 1) return __fmul_rn(cf, rcp_approx(d));
  float r = rcp_approx(d);
  r = __fmul_rn(r, __fsub_rn(2.0f, __fmul_rn(d, r)));
  return __fmul_rn(cf, r);
}

// Four 0/1 bytes -> four f16 (two f16x2 words) in the same order.
__device__ __forceinline__ uint2 bytes_to_f16(uint32_t x) {
  return make_uint2(__byte_perm(x, 0u, 0x4140) * kHalfOne,
                    __byte_perm(x, 0u, 0x4342) * kHalfOne);
}

// 16 presence bytes -> 16 halves at dst (16-byte aligned).
__device__ __forceinline__ void stage(uint16_t* dst, const uint4& v) {
  const uint2 h0 = bytes_to_f16(v.x), h1 = bytes_to_f16(v.y);
  const uint2 h2 = bytes_to_f16(v.z), h3 = bytes_to_f16(v.w);
  reinterpret_cast<uint4*>(dst)[0] = make_uint4(h0.x, h0.y, h1.x, h1.y);
  reinterpret_cast<uint4*>(dst)[1] = make_uint4(h2.x, h2.y, h3.x, h3.y);
}

__device__ __forceinline__ void mma_f16(float (&d)[4], const uint32_t (&a)[4],
                                        uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int kMode>
__global__ void __launch_bounds__(kThreads)
sn_square_mma_kernel(const uint8_t* __restrict__ m,
                     const float* __restrict__ t,
                     const int32_t* __restrict__ tiles,
                     float* __restrict__ s_out, int32_t* __restrict__ n_out,
                     int P, int G, int K, int mirror) {
  // a_s[k][r][c]: presence column k0 + c of tile row r of the step's k-th
  // protein as an f16 0.0 or 1.0; b_s the same for the tile's columns.
  __shared__ __align__(16) uint16_t a_s[kPP][kTile][kLd];
  __shared__ __align__(16) uint16_t b_s[kPP][kTile][kLd];

  const int q = blockIdx.x;
  const int rt = tiles[2 * q];
  const int ct = tiles[2 * q + 1];
  const bool mirror_tile = mirror && rt != ct;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int g = tid % 32 / 4;  // mma group: fragment rows g, g + 8
  const int tig = tid % 4;     // thread in group: columns 2 tig, 2 tig + 1
  const int wr = warp / 2 * 16;
  const int wc = warp % 2 * 32;
  const int row0 = rt * kTile;
  const int col0 = ct * kTile;
  // Loader: each thread copies one 16-byte chunk of one tile row per side
  // and per protein of the step.
  const int lrow = tid / 4;
  const int lchunk = tid % 4;
  const bool a_live = row0 + lrow < G;
  const bool b_live = col0 + lrow < G;

  // Cell e of fragment f: row wr + g + 8 (e / 2), column
  // wc + 8 f + 2 tig + e % 2 (the m16n8 accumulator layout).
  float s[kFrags][4];
  int n[kFrags][4];
#pragma unroll
  for (int f = 0; f < kFrags; ++f) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[f][e] = 0.0f;
      n[f][e] = 0;
    }
  }

  for (int p0 = 0; p0 < P; p0 += kPP) {
    const uint8_t* a_row[kPP];
    const uint8_t* b_row[kPP];
    bool live[kPP];
#pragma unroll
    for (int k = 0; k < kPP; ++k) {
      live[k] = p0 + k < P;
      const size_t base = (size_t)(live[k] ? p0 + k : 0) * G;
      a_row[k] = m + (base + (a_live ? row0 + lrow : 0)) * (size_t)K;
      b_row[k] = m + (base + (b_live ? col0 + lrow : 0)) * (size_t)K;
    }
    float acc[kPP][kFrags][4];
#pragma unroll
    for (int k = 0; k < kPP; ++k) {
#pragma unroll
      for (int f = 0; f < kFrags; ++f) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[k][f][e] = 0.0f;
      }
    }

    for (int k0 = 0; k0 < K; k0 += kSliceBytes) {
#pragma unroll
      for (int k = 0; k < kPP; ++k) {
        uint4 va = make_uint4(0u, 0u, 0u, 0u);
        uint4 vb = make_uint4(0u, 0u, 0u, 0u);
        if (a_live && live[k])
          va = *reinterpret_cast<const uint4*>(a_row[k] + k0 + lchunk * 16);
        if (b_live && live[k])
          vb = *reinterpret_cast<const uint4*>(b_row[k] + k0 + lchunk * 16);
        stage(&a_s[k][lrow][lchunk * 16], va);
        stage(&b_s[k][lrow][lchunk * 16], vb);
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kPP; ++k) {
#pragma unroll
        for (int kk = 0; kk < kSliceBytes; kk += 16) {
          const int c = kk + 4 * tig;
          const uint2 lo = *reinterpret_cast<const uint2*>(&a_s[k][wr + g][c]);
          const uint2 hi =
              *reinterpret_cast<const uint2*>(&a_s[k][wr + g + 8][c]);
          // A fragment: (row g, k pair 0), (row g + 8, pair 0),
          // (row g, pair 1), (row g + 8, pair 1).
          const uint32_t a[4] = {lo.x, hi.x, lo.y, hi.y};
#pragma unroll
          for (int f = 0; f < kFrags; ++f) {
            const uint2 b =
                *reinterpret_cast<const uint2*>(&b_s[k][wc + 8 * f + g][c]);
            mma_f16(acc[k][f], a, b.x, b.y);
          }
        }
      }
      __syncthreads();
    }

    // Epilogue: `lean`'s transform of each protein's f32 counts into the
    // resident S/N cells, in ascending protein order.
#pragma unroll
    for (int k = 0; k < kPP; ++k) {
      const size_t base = (size_t)(p0 + k) * G;
      float tav[2], tbv[kFrags][2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row0 + wr + g + 8 * h;
        tav[h] = live[k] && r < G ? t[base + r] : 1.0f;
      }
#pragma unroll
      for (int f = 0; f < kFrags; ++f) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = col0 + wc + 8 * f + 2 * tig + h;
          tbv[f][h] = live[k] && c < G ? t[base + c] : 1.0f;
        }
      }
#pragma unroll
      for (int f = 0; f < kFrags; ++f) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float cf = acc[k][f][e];
          s[f][e] = __fadd_rn(s[f][e],
                              jaccard<kMode>(cf, tav[e / 2], tbv[f][e % 2]));
          n[f][e] += cf > 0.0f;  // min(cnt, 1) of an integer count
        }
      }
    }
  }

#pragma unroll
  for (int f = 0; f < kFrags; ++f) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = row0 + wr + g + 8 * (e / 2);
      const int c = col0 + wc + 8 * f + 2 * tig + e % 2;
      if (r < G && c < G) {
        s_out[(size_t)r * G + c] = s[f][e];
        n_out[(size_t)r * G + c] = n[f][e];
        if (mirror_tile) {
          s_out[(size_t)c * G + r] = s[f][e];
          n_out[(size_t)c * G + r] = n[f][e];
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// m (P, G, K) holds 0/1 bytes, K a multiple of 64 and m 16-byte aligned;
// t (P, G) is f32 T clamped to >= 1; tiles is the int32 (n_blocks, 2) tile
// list.  The launch writes s (G, G) f32 and n (G, G) int32 at every cell of
// the listed tiles and, with mirror, of their transposes.  mode: 0 Newton,
// 1 approximate reciprocal, 2 IEEE divide.
int sn_square_mma_launch(const void* m, const void* t, const void* tiles,
                         void* s, void* n, int P, int G, int K, int n_blocks,
                         int mirror, int mode, void* stream) {
  if (n_blocks <= 0 || K % kSliceBytes || mode < 0 || mode > 2)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(n_blocks);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* mp = static_cast<const uint8_t*>(m);
  const float* tp = static_cast<const float*>(t);
  const int32_t* tl = static_cast<const int32_t*>(tiles);
  float* so = static_cast<float*>(s);
  int32_t* no = static_cast<int32_t*>(n);
  if (mode == 0)
    sn_square_mma_kernel<0><<<grid, kThreads, 0, st>>>(mp, tp, tl, so, no, P,
                                                       G, K, mirror);
  else if (mode == 1)
    sn_square_mma_kernel<1><<<grid, kThreads, 0, st>>>(mp, tp, tl, so, no, P,
                                                       G, K, mirror);
  else
    sn_square_mma_kernel<2><<<grid, kThreads, 0, st>>>(mp, tp, tl, so, no, P,
                                                       G, K, mirror);
  return (int)cudaGetLastError();
}

const char* sn_square_mma_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
