// Rectangular fused (S, N) block for Hopper (sm_90a).
//
// Replaces the TPU kernels parfastaai_tpu/ops/pallas_intersect.py
// `_pallas_sn_rect` (body `_kernel` -> `_accumulate` -> `_gram`,
// `_jaccard_terms`) and its K-blocked twin `_pallas_sn_rect_kb`
// (`_kernel_kblocked`).  For a genome band A x genome band B it computes,
// per protein p in ascending order,
//
//     cnt = Ma_p . Mb_p^T                       (0/1 bytes, int32 counts)
//     S  += cnt / (ta_p[i] + tb_p[j] - cnt)     (f32, T pre-clamped >= 1)
//     N  += min(cnt, 1)                         (int32)
//
// and writes S and N once.  Counts never leave registers.
//
// Design (simple and right first):
//   * One thread block per 64 x 64 output tile, 256 threads, each thread
//     owning a 4 x 4 register tile of counts, S and N.  The ragged edge is
//     masked in the kernel (rows and columns past A / B load zeros and are
//     never stored), so the caller pads nothing.
//   * The protein loop runs inside the block.  The TPU kernel carried S/N
//     across a sequential protein grid axis; blocks on the GPU run in no
//     order, so the loop takes that axis' place and S/N stay in registers.
//   * Per protein, a K loop over 64-byte slices staged in shared memory
//     (stored word-transposed, so each thread reads its 4 rows and 4
//     columns as one 16-byte load each) with counts from __dp4a.  The loop
//     has no VMEM-style limit, so the same kernel covers K > 32768, the
//     regime `_pallas_sn_rect_kb` exists for on the TPU.
//   * The Jaccard transform is an epilogue on CUDA cores, written with
//     explicit round-to-nearest intrinsics so nvcc cannot contract it into
//     FMAs: mode 2 (precise) is bit-identical to the IEEE f32 plain version.
//   * No atomics and no split over K or P across blocks: S sums in the
//     plain version's order and the result is deterministic.
//
// What bounds it on the H100: the integer dot-product issue rate.  __dp4a
// gives 4 MACs per instruction on the CUDA cores, about a sixteenth of the
// 1,979 TOPS int8 tensor-core peak, and each 16 __dp4a need two 16-byte
// shared-memory loads.  The design keeps the inputs in shared memory and
// the outputs in registers so that the issue rate, not memory, is the limit;
// moving the count product onto the tensor cores (wgmma int8 with the
// epilogue on the accumulator registers) is the next step.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;            // output tile edge (rows and columns)
constexpr int kThreads = 256;        // 16 x 16 threads
constexpr int kReg = 4;              // register tile edge per thread
constexpr int kSliceBytes = 64;      // K bytes staged per shared-memory slice
constexpr int kSliceWords = kSliceBytes / 4;

__device__ __forceinline__ float rcp_approx(float x) {
  float r;
  asm("rcp.approx.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// mode: 0 = Newton-refined reciprocal, 1 = raw approximate reciprocal,
// 2 = IEEE divide (same op order as the plain version).
template <int kMode>
__global__ void __launch_bounds__(kThreads)
sn_rect_kernel(const uint8_t* __restrict__ ma, const uint8_t* __restrict__ mb,
               const float* __restrict__ ta, const float* __restrict__ tb,
               float* __restrict__ s_out, int32_t* __restrict__ n_out,
               int P, int A, int B, int K) {
  // Word-transposed slices: a_s[w][r] holds bytes 4w..4w+3 of tile row r.
  __shared__ __align__(16) uint32_t a_s[kSliceWords][kTile];
  __shared__ __align__(16) uint32_t b_s[kSliceWords][kTile];

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // column group: columns 4tx .. 4tx+3
  const int ty = tid / 16;  // row group: rows 4ty .. 4ty+3
  const int row0 = blockIdx.y * kTile;
  const int col0 = blockIdx.x * kTile;
  // Loader: each thread copies one 16-byte chunk of one tile row per side.
  const int lrow = tid / 4;
  const int lchunk = tid % 4;
  const bool a_live = row0 + lrow < A;
  const bool b_live = col0 + lrow < B;

  float s[kReg][kReg];
  int n[kReg][kReg];
#pragma unroll
  for (int i = 0; i < kReg; ++i) {
#pragma unroll
    for (int j = 0; j < kReg; ++j) {
      s[i][j] = 0.0f;
      n[i][j] = 0;
    }
  }

  for (int p = 0; p < P; ++p) {
    const uint8_t* a_row =
        ma + ((size_t)p * A + (a_live ? row0 + lrow : 0)) * (size_t)K;
    const uint8_t* b_row =
        mb + ((size_t)p * B + (b_live ? col0 + lrow : 0)) * (size_t)K;
    int cnt[kReg][kReg];
#pragma unroll
    for (int i = 0; i < kReg; ++i) {
#pragma unroll
      for (int j = 0; j < kReg; ++j) cnt[i][j] = 0;
    }

    for (int k0 = 0; k0 < K; k0 += kSliceBytes) {
      uint4 va = make_uint4(0u, 0u, 0u, 0u);
      uint4 vb = make_uint4(0u, 0u, 0u, 0u);
      if (a_live)
        va = *reinterpret_cast<const uint4*>(a_row + k0 + lchunk * 16);
      if (b_live)
        vb = *reinterpret_cast<const uint4*>(b_row + k0 + lchunk * 16);
      const int w0 = lchunk * 4;
      a_s[w0 + 0][lrow] = va.x;
      a_s[w0 + 1][lrow] = va.y;
      a_s[w0 + 2][lrow] = va.z;
      a_s[w0 + 3][lrow] = va.w;
      b_s[w0 + 0][lrow] = vb.x;
      b_s[w0 + 1][lrow] = vb.y;
      b_s[w0 + 2][lrow] = vb.z;
      b_s[w0 + 3][lrow] = vb.w;
      __syncthreads();
#pragma unroll
      for (int w = 0; w < kSliceWords; ++w) {
        const uint4 a4 = *reinterpret_cast<const uint4*>(&a_s[w][ty * kReg]);
        const uint4 b4 = *reinterpret_cast<const uint4*>(&b_s[w][tx * kReg]);
        const unsigned int av[kReg] = {a4.x, a4.y, a4.z, a4.w};
        const unsigned int bv[kReg] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int i = 0; i < kReg; ++i) {
#pragma unroll
          for (int j = 0; j < kReg; ++j) {
            cnt[i][j] = (int)__dp4a(av[i], bv[j], (unsigned int)cnt[i][j]);
          }
        }
      }
      __syncthreads();
    }

    // Epilogue: one protein's Jaccard terms into the resident S/N tile.
    float tav[kReg], tbv[kReg];
#pragma unroll
    for (int i = 0; i < kReg; ++i) {
      const int r = row0 + ty * kReg + i;
      tav[i] = r < A ? ta[(size_t)p * A + r] : 1.0f;
    }
#pragma unroll
    for (int j = 0; j < kReg; ++j) {
      const int c = col0 + tx * kReg + j;
      tbv[j] = c < B ? tb[(size_t)p * B + c] : 1.0f;
    }
#pragma unroll
    for (int i = 0; i < kReg; ++i) {
#pragma unroll
      for (int j = 0; j < kReg; ++j) {
        const float cf = __int2float_rn(cnt[i][j]);
        const float outer = __fadd_rn(tav[i], tbv[j]);
        const float d = __fsub_rn(outer, cf);  // >= 1; cnt == 0 gives j == 0
        float jv;
        if (kMode == 2) {
          jv = __fdiv_rn(cf, d);
        } else if (kMode == 1) {
          jv = __fmul_rn(cf, rcp_approx(d));
        } else {
          float r = rcp_approx(d);
          r = __fmul_rn(r, __fsub_rn(2.0f, __fmul_rn(d, r)));
          jv = __fmul_rn(cf, r);
        }
        s[i][j] = __fadd_rn(s[i][j], jv);
        n[i][j] += min(cnt[i][j], 1);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kReg; ++i) {
    const int r = row0 + ty * kReg + i;
    if (r >= A) continue;
#pragma unroll
    for (int j = 0; j < kReg; ++j) {
      const int c = col0 + tx * kReg + j;
      if (c < B) {
        s_out[(size_t)r * B + c] = s[i][j];
        n_out[(size_t)r * B + c] = n[i][j];
      }
    }
  }
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// ma (P, A, K) and mb (P, B, K) hold 0/1 bytes, K a multiple of 64 and both
// 16-byte aligned; ta (P, A) and tb (P, B) are f32 T clamped to >= 1;
// s (A, B) f32 and n (A, B) int32 are written in full.
int sn_rect_launch(const void* ma, const void* mb, const void* ta,
                   const void* tb, void* s, void* n, int P, int A, int B,
                   int K, int mode, void* stream) {
  const dim3 grid((B + kTile - 1) / kTile, (A + kTile - 1) / kTile);
  const dim3 block(kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* a = static_cast<const uint8_t*>(ma);
  const uint8_t* b = static_cast<const uint8_t*>(mb);
  const float* fa = static_cast<const float*>(ta);
  const float* fb = static_cast<const float*>(tb);
  float* so = static_cast<float*>(s);
  int32_t* no = static_cast<int32_t*>(n);
  switch (mode) {
    case 0:
      sn_rect_kernel<0><<<grid, block, 0, st>>>(a, b, fa, fb, so, no, P, A, B, K);
      break;
    case 1:
      sn_rect_kernel<1><<<grid, block, 0, st>>>(a, b, fa, fb, so, no, P, A, B, K);
      break;
    case 2:
      sn_rect_kernel<2><<<grid, block, 0, st>>>(a, b, fa, fb, so, no, P, A, B, K);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* sn_rect_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
