// Square all-vs-all fused (S, N) on the int8 tensor cores of Hopper (sm_90a).
//
// Replaces, for unpacked presence, the square TPU kernels of
// parfastaai_tpu/ops/pallas_intersect.py: `_pallas_sn_sym_2p` with its
// `lean` / `base` (`_sym_kernel_2p_lean`, `_sym_kernel_2p`), `counts`
// (`_sym_kernel_2p_lean` with counts_only), `pipe` (`_sym_kernel_2p_pipe`),
// `fused` and `mxu_outer` (`_sym_kernel_2p_fused`) bodies, `_pallas_sn_sym`,
// `_pallas_sn` and their K-blocked twins `_pallas_sn_sym_kb` and
// `_pallas_sn_kb`.  For one presence tensor M (P, G, K) against itself it
// computes, per protein p in ascending order,
//
//     cnt = M_p . M_p^T                       (0/1 bytes, int32 counts)
//     S  += cnt / (t_p[i] + t_p[j] - cnt)     (f32, T pre-clamped >= 1)
//     N  += min(cnt, 1)                       (int32)
//
// over the 128 x 128 output tiles of a list, and writes S and N once.
// Nibble-packed input and the diagonal and band walks stay on the __dp4a
// body of csrc/sn_square.cu.
//
// Design: the block body that csrc/sn_rect.cu runs (sn_wgmma_tile of
// csrc/sn_wgmma.cuh) with both operands taken from M.
//   * A block of two warpgroups owns one 128 x 128 tile, each warpgroup 64
//     rows of it as 64 s32 counts a thread from
//     wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8, with its S and N in
//     the same registers' layout (element 4 j + e of a thread is row
//     16 warp + g + 8 (e / 2), column 8 j + 2 tig + e % 2 of the warpgroup's
//     64 x 128 piece; g = lane / 4, tig = lane % 4).  192 of a thread's 255
//     registers are state, which fixes the tile and one block per SM.
//   * A block reads its (row tile, column tile) from an int32 list that the
//     wrapper builds: the upper triangle in row-major order, or every tile of
//     the square (the counterpart of the TPU's scalar-prefetched `rows, cols`
//     index maps).  Blocks that run together share a row tile and walk the
//     proteins together, so a protein's slab is read from L2.
//   * Each K slice stages the tile's 128 rows of M (the A operand) and its 128
//     columns' rows of M (the B operand) in the 128-byte swizzle of
//     csrc/sn_wgmma.cuh, through a ring of kStages slices filled by cp.async
//     over the flat (protein, slice) sequence, T riding in slot p % kStages.
//     A diagonal tile stages the same rows twice.  Rows past G are zero-filled
//     and never stored, so a ragged G pads nothing.  One __syncthreads() a
//     slice, as in sn_rect.cu: after it the slice is visible to all, and both
//     warpgroups have waited for their wgmma of slice i - 2, whose stage then
//     takes the load of slice i + kStages - 2.
//   * The Jaccard transform is an epilogue on the accumulator registers, in
//     round-to-nearest intrinsics: mode 2 (precise) is bit-identical to the
//     IEEE f32 plain version.
//   * The update (kUpdate, csrc/sn_wgmma.cuh) says when it runs.  `lean`
//     (kLean) transforms each protein in place after its last products; the
//     protein loop runs inside the block over one flat ring, so two proteins
//     per step is the same launch.  `pipe` (kPipe) keeps a second count set
//     and transforms protein p under protein p + 1's products: the TPU
//     carried the counts through a 2 MB VMEM scratch each step and lost 21%;
//     here the carry is registers and wgmma is asynchronous.  Each cell adds
//     its terms in ascending protein order, so `pipe` is bit-equal to `lean`.
//     `fused` and `mxu_outer` (kPair) count two proteins into the two sets
//     and add j0 + j1 in one epilogue.  The TPU bodies of the two differ
//     only in how they form the outer sums ta[i] + tb[j]: `mxu_outer` built
//     them on the MXU to spare VPU broadcasts, and measured 1.7x slower even
//     there (pallas_intersect.py's _pallas_sn_sym_2p notes); here ta + tb is
//     the one __fadd_rn a cell that the Jaccard term already issues, and a
//     tensor-core outer sum (the TF32 rank-4 product of an earlier version)
//     would need a third 64-register set, so both are one launch.  The
//     two-set updates hold N in 16-bit halves, so they take P < kMaxPackedP
//     (the header's "Registers" note says why).  `counts` (kCounts) keeps
//     one count set over each pair and adds the pair's f32 count sum: the
//     products and the loop without the transform.
//   * The mirror is written in the last epilogue: with `mirror`, an
//     off-diagonal tile (r, c) also stores its transpose at (c, r).  Counts
//     are symmetric and ta + tb commutes, so that is bit-equal to computing
//     (c, r).  A quad of lanes writes 32 consecutive bytes of a row directly;
//     the eight lanes of equal tig write 32 consecutive bytes of a mirrored
//     row: whole sectors both ways.
//   * No atomics and no split over K or P across blocks: S sums in the plain
//     version's order and the result is deterministic.
//
// What bounds it on the H100: see PERF.md (chip_smoke.py's K sweep,
// tools/sn_square_ablation.py); as for sn_rect.cu, the feed from L2 and the
// epilogue, not the tensor cores.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sn_wgmma.cuh"

namespace {

// Where a block's staged rows come from: rows row0 .. of M as the A side,
// rows col0 .. of M as the B side.
struct SquareSrc {
  const uint8_t* m;
  const float* t;
  int G, K, row0, col0;

  __device__ __forceinline__ void stage_rows(int p, size_t k_off,
                                             uint32_t dst0, int lrow) const {
    const uint8_t* mp = m + (size_t)p * G * (size_t)K + k_off;
#pragma unroll
    for (int i = 0; i < kTile / 32; ++i) {
      const int r = lrow + 32 * i;
      const bool a_live = row0 + r < G;
      cp_async16(dst0 + 32 * i * kSliceBytes,
                 mp + (size_t)(a_live ? row0 + r : 0) * K, a_live ? 16 : 0);
      const bool b_live = col0 + r < G;
      cp_async16(dst0 + (kTile + 32 * i) * kSliceBytes,
                 mp + (size_t)(b_live ? col0 + r : 0) * K, b_live ? 16 : 0);
    }
  }
  __device__ __forceinline__ const float* t_row(int p, int i,
                                                bool& live) const {
    const int idx = i < kTile ? row0 + i : col0 + i - kTile;
    live = idx < G;
    return t + (size_t)p * G + (live ? idx : 0);
  }
};

template <int kMode, int kUpdate>
__global__ void __launch_bounds__(kThreads, 1)
sn_square_wgmma_kernel(const uint8_t* __restrict__ m,
                       const float* __restrict__ t,
                       const int32_t* __restrict__ tiles,
                       float* __restrict__ s_out, int32_t* __restrict__ n_out,
                       int P, int G, int K, int mirror) {
  const int rt = tiles[2 * blockIdx.x];
  const int ct = tiles[2 * blockIdx.x + 1];
  const int row0 = rt * kTile;
  const int col0 = ct * kTile;
  float s[4 * kNT];
  int n[4 * kNT];
  sn_wgmma_tile<kMode, kUpdate>(SquareSrc{m, t, G, K, row0, col0}, P, K, s,
                                n);

  const int tid = threadIdx.x;
  const int r0 = row0 + tid / 128 * 64 + tid % 128 / 32 * 16 + tid % 32 / 4;
  const int c0 = col0 + 2 * (tid % 4);
  const bool mirror_tile = mirror && rt != ct;
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + 8 * (e / 2);
      const int c = c0 + 8 * j + e % 2;
      if (r < G && c < G) {
        s_out[(size_t)r * G + c] = s[4 * j + e];
        n_out[(size_t)r * G + c] = n[4 * j + e];
        if (mirror_tile) {
          s_out[(size_t)c * G + r] = s[4 * j + e];
          n_out[(size_t)c * G + r] = n[4 * j + e];
        }
      }
    }
  }
}

// ---- host launch ---------------------------------------------------------

template <int kMode, int kUpdate>
cudaError_t launch(const uint8_t* m, const float* t, const int32_t* tiles,
                   float* so, int32_t* no, int P, int G, int K, int n_blocks,
                   int mirror, cudaStream_t st) {
  static bool allowed[64] = {};
  const cudaError_t err = allow_ring(sn_square_wgmma_kernel<kMode, kUpdate>,
                                     allowed, smem_bytes(kUpdate));
  if (err != cudaSuccess) return err;
  sn_square_wgmma_kernel<kMode, kUpdate>
      <<<(unsigned)n_blocks, kThreads, smem_bytes(kUpdate), st>>>(
          m, t, tiles, so, no, P, G, K, mirror);
  return cudaGetLastError();
}

template <int kUpdate>
cudaError_t launch_update(int mode, const uint8_t* m, const float* t,
                          const int32_t* tiles, float* so, int32_t* no, int P,
                          int G, int K, int n_blocks, int mirror,
                          cudaStream_t st) {
  switch (mode) {
    case 0:
      return launch<0, kUpdate>(m, t, tiles, so, no, P, G, K, n_blocks,
                                mirror, st);
    case 1:
      return launch<1, kUpdate>(m, t, tiles, so, no, P, G, K, n_blocks,
                                mirror, st);
    case 2:
      return launch<2, kUpdate>(m, t, tiles, so, no, P, G, K, n_blocks,
                                mirror, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Launches on `stream` and returns the first CUDA error (0 on success).
// m (P, G, K) holds 0/1 bytes, K a multiple of 128 and m 16-byte aligned;
// t (P, G) is f32 T clamped to >= 1; tiles is the int32 (n_blocks, 2) list
// of (row tile, column tile) in units of 128 rows.  The launch writes
// s (G, G) f32 and n (G, G) int32 at every cell of the tiles it walks and,
// with mirror, of the transposes of the off-diagonal ones.  mode: 0 Newton,
// 1 approximate reciprocal, 2 IEEE divide.  update: 0 lean, 1 pipe, 2 pair
// (the `fused` and `mxu_outer` values), 3 counts (S the f32 sum of the
// counts, N 0; any mode); 1 and 2 need P < 32768.
int sn_square_wgmma_launch(const void* m, const void* t, const void* tiles,
                           void* s, void* n, int P, int G, int K,
                           int n_blocks, int mirror, int mode, int update,
                           void* stream) {
  if (P <= 0 || G <= 0 || K <= 0 || n_blocks <= 0 || K % kSliceBytes ||
      (long long)P * (K / kSliceBytes) > 0x7fffffffLL || mode < 0 ||
      mode > 2 || ((update == kPipe || update == kPair) && P >= kMaxPackedP))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* mp = static_cast<const uint8_t*>(m);
  const float* tp = static_cast<const float*>(t);
  const int32_t* tl = static_cast<const int32_t*>(tiles);
  float* so = static_cast<float*>(s);
  int32_t* no = static_cast<int32_t*>(n);
  switch (update) {
    case kLean:
      return (int)launch_update<kLean>(mode, mp, tp, tl, so, no, P, G, K,
                                       n_blocks, mirror, st);
    case kPipe:
      return (int)launch_update<kPipe>(mode, mp, tp, tl, so, no, P, G, K,
                                       n_blocks, mirror, st);
    case kPair:
      return (int)launch_update<kPair>(mode, mp, tp, tl, so, no, P, G, K,
                                       n_blocks, mirror, st);
    case kCounts:
      // counts never divides: one instantiation serves every mode
      return (int)launch<0, kCounts>(mp, tp, tl, so, no, P, G, K, n_blocks,
                                     mirror, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* sn_square_wgmma_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
