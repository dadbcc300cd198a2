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
// Design (the body of a block, from the ring to the accumulator registers,
// is sn_wgmma_tile of csrc/sn_wgmma.cuh, which csrc/sn_square_wgmma.cu runs
// too; this file names where the staged rows come from and stores the tile):
//   * Counts on the int8 tensor cores through the warpgroup instruction
//     wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8, both operands read
//     from shared memory.  The 0/1 presence bytes are valid s8 operands as
//     they lie in memory, so nothing is converted while staging.  A block
//     of two warpgroups owns a 128 x 128 output tile, each warpgroup 64 rows
//     of it: 64 s32 counts a thread, with its S and N in the same layout
//     (element 4 j + e of a thread is row 16 warp + g + 8 (e / 2), column
//     8 j + 2 tig + e % 2 of the warpgroup's 64 x 128 piece; g = lane / 4,
//     tig = lane % 4).  The Jaccard transform is an epilogue on those
//     registers, written with explicit round-to-nearest intrinsics so nvcc
//     cannot contract it into FMAs: mode 2 (precise) is bit-identical to
//     the IEEE f32 plain version.  A protein's first wgmma overwrites the
//     counts (scale-d 0), so they are never cleared.
//   * The staged tile is K-major in the 128-byte swizzle that wgmma's
//     matrix descriptor names: a slice is 128 bytes of K, row r of it lies
//     at byte 128 r, and its 16-byte chunk c at chunk c ^ (r % 8) of that
//     row.  Each tile starts on a 1024-byte boundary (the swizzle is a
//     function of the address bits), 8-row groups are 1024 bytes apart, and
//     a k32 step advances the descriptor's start address by 32 bytes.  The
//     loader writes that layout itself, 16 bytes a thread; eight
//     neighbouring threads copy one row's 128 contiguous bytes.
//   * An asynchronous ring of kStages K slices in dynamic shared memory,
//     filled by cp.async.cg (zero-fill form: rows and columns past A / B
//     read as zeros and are never stored, so the caller pads nothing).  One
//     __syncthreads() per slice: after it the slice is visible to all
//     (after a proxy fence, since cp.async writes through the generic proxy
//     and wgmma reads through the async one), and both warpgroups have
//     waited for their wgmma of slice i - 2, so its stage takes the load of
//     slice i + kStages - 2 while slices i - 1 and i are multiplied.  The
//     ring runs over the flat sequence of (protein, slice) pairs, so the
//     next protein's first slices load during this protein's epilogue.
//     Each protein's T values ride in the same ring (4-byte cp.async, slot
//     p % kStages), so the epilogue reads T from shared memory.
//   * The protein loop runs inside the block.  The TPU kernel carried S/N
//     across a sequential protein grid axis; blocks on the GPU run in no
//     order, so the loop takes that axis' place and S/N stay in registers:
//     192 of a thread's 255, which is what fixes the tile at 128 x 128 and
//     one block per SM.  The K loop has no VMEM-style limit, so the same
//     kernel covers K > 32768, the regime `_pallas_sn_rect_kb` exists for
//     on the TPU.  The grid is 1-D with the column tiles fastest, so that
//     blocks that run together share rows of A in L2.
//   * No atomics and no split over K or P across blocks: S sums in the
//     plain version's order and the result is deterministic.
//
// What bounds it on the H100 (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py's
// K sweep and tools/sn_rect_ablation.py): the feed from L2 and the epilogue,
// not the tensor cores.  Its time is linear in K.  A 128 x 128 tile loads
// 256 bytes per k for 16,384 MACs (64 MACs a byte); with the products cut
// out, the loads alone take two thirds of the --fast block's time, at
// almost 8 TB/s out of L2, while the products and the epilogue alone (no
// loads) take about as long, the products running at about half of the
// int8 peak.  The two overlap only in part, and the epilogue costs more in
// place than alone: with one block per SM, nothing is multiplied and no
// load is issued while both warpgroups transform their counts.  What would
// lift it: fewer bytes per MAC (a cluster of blocks sharing B through TMA
// multicast), and a producer warp with mbarriers so that one warpgroup's
// epilogue runs under the other's products.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sn_wgmma.cuh"

namespace {

// Where a block's staged rows come from: rows row0 .. of band A, rows col0 ..
// of band B.
struct RectSrc {
  const uint8_t* ma;
  const uint8_t* mb;
  const float* ta;
  const float* tb;
  int A, B, K, row0, col0;

  __device__ __forceinline__ void stage_rows(int p, size_t k_off,
                                             uint32_t dst0, int lrow) const {
#pragma unroll
    for (int i = 0; i < kTile / 32; ++i) {
      const int r = lrow + 32 * i;
      const bool live = row0 + r < A;
      const uint8_t* src =
          ma + ((size_t)p * A + (live ? row0 + r : 0)) * (size_t)K + k_off;
      cp_async16(dst0 + 32 * i * kSliceBytes, src, live ? 16 : 0);
    }
#pragma unroll
    for (int i = 0; i < kTile / 32; ++i) {
      const int r = lrow + 32 * i;
      const bool live = col0 + r < B;
      const uint8_t* src =
          mb + ((size_t)p * B + (live ? col0 + r : 0)) * (size_t)K + k_off;
      cp_async16(dst0 + (kTile + 32 * i) * kSliceBytes, src, live ? 16 : 0);
    }
  }
  __device__ __forceinline__ const float* t_row(int p, int i,
                                                bool& live) const {
    const bool is_a = i < kTile;
    const int idx = is_a ? row0 + i : col0 + i - kTile;
    live = idx < (is_a ? A : B);
    return is_a ? ta + (size_t)p * A + (live ? idx : 0)
                : tb + (size_t)p * B + (live ? idx : 0);
  }
};

template <int kMode>
__global__ void __launch_bounds__(kThreads, 1)
sn_rect_kernel(const uint8_t* __restrict__ ma, const uint8_t* __restrict__ mb,
               const float* __restrict__ ta, const float* __restrict__ tb,
               float* __restrict__ s_out, int32_t* __restrict__ n_out, int P,
               int A, int B, int K, int tiles_b) {
  const int row0 = (int)(blockIdx.x / (unsigned)tiles_b) * kTile;
  const int col0 = (int)(blockIdx.x % (unsigned)tiles_b) * kTile;
  float s[4 * kNT];
  int n[4 * kNT];
  sn_wgmma_tile<kMode>(RectSrc{ma, mb, ta, tb, A, B, K, row0, col0}, P, K, s,
                       n);

  const int tid = threadIdx.x;
  const int r0 = row0 + tid / 128 * 64 + tid % 128 / 32 * 16 + tid % 32 / 4;
  const int c0 = col0 + 2 * (tid % 4);
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + 8 * (e / 2);
      const int c = c0 + 8 * j + e % 2;
      if (r < A && c < B) {
        s_out[(size_t)r * B + c] = s[4 * j + e];
        n_out[(size_t)r * B + c] = n[4 * j + e];
      }
    }
  }
}

// ---- host launch ---------------------------------------------------------

template <int kMode>
cudaError_t launch(const uint8_t* a, const uint8_t* b, const float* fa,
                   const float* fb, float* so, int32_t* no, int P, int A,
                   int B, int K, cudaStream_t st) {
  const long long tiles_a = (A + kTile - 1) / kTile;
  const long long tiles_b = (B + kTile - 1) / kTile;
  if (tiles_a * tiles_b > 0x7fffffffLL) return cudaErrorInvalidValue;
  static bool allowed[64] = {};
  const cudaError_t err = allow_ring(sn_rect_kernel<kMode>, allowed);
  if (err != cudaSuccess) return err;
  sn_rect_kernel<kMode>
      <<<(unsigned)(tiles_a * tiles_b), kThreads, kSmemBytes, st>>>(
          a, b, fa, fb, so, no, P, A, B, K, (int)tiles_b);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches on `stream` and returns the first CUDA error (0 on success).
// ma (P, A, K) and mb (P, B, K) hold 0/1 bytes, K a multiple of 128 and both
// 16-byte aligned; ta (P, A) and tb (P, B) are f32 T clamped to >= 1;
// s (A, B) f32 and n (A, B) int32 are written in full.  mode: 0 Newton,
// 1 approximate reciprocal, 2 IEEE divide.
int sn_rect_launch(const void* ma, const void* mb, const void* ta,
                   const void* tb, void* s, void* n, int P, int A, int B,
                   int K, int mode, void* stream) {
  if (P <= 0 || A <= 0 || B <= 0 || K <= 0 || K % kSliceBytes ||
      (long long)P * (K / kSliceBytes) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* a = static_cast<const uint8_t*>(ma);
  const uint8_t* b = static_cast<const uint8_t*>(mb);
  const float* fa = static_cast<const float*>(ta);
  const float* fb = static_cast<const float*>(tb);
  float* so = static_cast<float*>(s);
  int32_t* no = static_cast<int32_t*>(n);
  switch (mode) {
    case 0:
      return (int)launch<0>(a, b, fa, fb, so, no, P, A, B, K, st);
    case 1:
      return (int)launch<1>(a, b, fa, fb, so, no, P, A, B, K, st);
    case 2:
      return (int)launch<2>(a, b, fa, fb, so, no, P, A, B, K, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* sn_rect_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
