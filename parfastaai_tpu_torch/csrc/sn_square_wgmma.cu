// Square all-vs-all fused (S, N) on the int8 tensor cores of Hopper (sm_90a).
//
// Replaces the square TPU kernels of parfastaai_tpu/ops/pallas_intersect.py:
// `_pallas_sn_sym_2p` with its `lean` / `base` (`_sym_kernel_2p_lean`,
// `_sym_kernel_2p`), `f32gram` (`_sym_kernel_2p` with `_gram(f32=True)`,
// whose exact f32 counts are lean's values), `counts` (`_sym_kernel_2p_lean`
// with counts_only), `pipe` (`_sym_kernel_2p_pipe`), `fused` and
// `mxu_outer` (`_sym_kernel_2p_fused`) bodies, `_pallas_sn_sym` and
// `_pallas_sn` (with nibble-packed input too), their K-blocked twins
// `_pallas_sn_sym_kb` and `_pallas_sn_kb`, and the walks
// `_pallas_sn_sym_diag`, `_pallas_sn_sym_bands` and
// `_pallas_sn_sym_bands_2p`.  For one presence tensor M (P, G, K) against
// itself it computes, per protein p in ascending order,
//
//     cnt = M_p . M_p^T                       (0/1 bytes, int32 counts)
//     S  += cnt / (t_p[i] + t_p[j] - cnt)     (f32, T pre-clamped >= 1)
//     N  += min(cnt, 1)                       (int32)
//
// over 128 x 128 output tiles, and writes S and N once.
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
//   * A block finds its (row tile, column tile) in one of three walks
//     (kWalk).  The list: an int32 list that the wrapper builds, the upper
//     triangle in row-major order or every tile of the square (the
//     counterpart of the TPU's scalar-prefetched `rows, cols` index maps).
//     The wrapped diagonals: block (i, d) of a 2-D grid is tile
//     (i, (i + d) mod nt), d = 0 .. nt / 2, decoded in closed form (the
//     TPU's affine-mod index maps; blockIdx.x runs fastest, so the blocks
//     of one diagonal run together).  The two grid indices are special
//     registers: nothing of the decode stays live through the body (a 1-D
//     grid's q / nt did, and ptxas spilled).  A band: block q of the launch for row
//     tile r is tile (r, r + q); one launch per band row, as the TPU ran it.
//     Blocks that run together walk the proteins together, so a protein's
//     slab is read from L2.
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
//   * Nibble-packed rows (kPacked, with kLean) hold two presence columns a
//     byte: each thread splits its own chunks of a landed slice into low
//     and high nibbles, each a slice of 0/1 bytes, and the slice takes
//     eight products (csrc/sn_wgmma.cuh).  Half the bytes come out of L2
//     per product; the split adds shared-memory traffic and a barrier.
//   * The mirror is written in the last epilogue: with `mirror`, an
//     off-diagonal tile (r, c) of the list or of a band also stores its
//     transpose at (c, r).  On the wrapped diagonals a tile at 0 < d mirrors
//     unless 2 d == nt, whose two orientations are both walked (the TPU
//     wrapper's `covered = dist <= nt // 2`): no cell is stored twice.
//     Counts are symmetric and ta + tb commutes, so that is bit-equal to
//     computing (c, r).  A quad of lanes writes 32 consecutive bytes of a
//     row directly; the eight lanes of equal tig write 32 consecutive bytes
//     of a mirrored row: whole sectors both ways.
//   * No atomics and no split over K or P across blocks: S sums in the plain
//     version's order and the result is deterministic.
//
// What bounds it on the H100: see PERF.md (chip_smoke.py's K sweeps,
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

// Walks: how a block finds its output tile.
constexpr int kWalkList = 0;  // tiles[2 q], tiles[2 q + 1]
constexpr int kWalkDiag = 1;  // (i, (i + d) mod nt), i, d = blockIdx.x, .y;
                              // walk_arg nt
constexpr int kWalkBand = 2;  // (r, r + q); walk_arg r

template <int kMode, int kUpdate, int kPacked, int kWalk>
__global__ void __launch_bounds__(kThreads, 1)
sn_square_wgmma_kernel(const uint8_t* __restrict__ m,
                       const float* __restrict__ t,
                       const int32_t* __restrict__ tiles,
                       float* __restrict__ s_out, int32_t* __restrict__ n_out,
                       int P, int G, int K, int mirror, int walk_arg) {
  int rt, ct;
  if constexpr (kWalk == kWalkList) {
    rt = tiles[2 * blockIdx.x];
    ct = tiles[2 * blockIdx.x + 1];
  } else if constexpr (kWalk == kWalkDiag) {
    const int d = blockIdx.y;
    rt = blockIdx.x;
    ct = rt + d < walk_arg ? rt + d : rt + d - walk_arg;
  } else {
    static_assert(kWalk == kWalkBand, "unknown walk");
    rt = walk_arg;
    ct = walk_arg + blockIdx.x;
  }
  const int row0 = rt * kTile;
  const int col0 = ct * kTile;
  float s[4 * kNT];
  int n[4 * kNT];
  sn_wgmma_tile<kMode, kUpdate, kPacked != 0>(
      SquareSrc{m, t, G, K, row0, col0}, P, K, s, n);

  const int tid = threadIdx.x;
  const int r0 = row0 + tid / 128 * 64 + tid % 128 / 32 * 16 + tid % 32 / 4;
  const int c0 = col0 + 2 * (tid % 4);
  bool mirror_tile = mirror && rt != ct;
  if constexpr (kWalk == kWalkDiag) {
    // forward distance d: both orientations of 2 d == nt are walked
    const int d = blockIdx.y;
    mirror_tile = d != 0 && 2 * d != walk_arg;
  }
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

struct Args {
  const uint8_t* m;
  const float* t;
  const int32_t* tiles;
  float* s;
  int32_t* n;
  int P, G, K, n_blocks, mirror, walk_arg;
  cudaStream_t st;
};

template <int kMode, int kUpdate, int kPacked, int kWalk>
cudaError_t launch(const Args& a) {
  static bool allowed[64] = {};
  constexpr int kBytes = smem_bytes(kUpdate, kPacked);
  const cudaError_t err = allow_ring(
      sn_square_wgmma_kernel<kMode, kUpdate, kPacked, kWalk>, allowed, kBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid = kWalk == kWalkDiag
                        ? dim3(a.walk_arg, a.n_blocks / a.walk_arg)
                        : dim3(a.n_blocks);
  sn_square_wgmma_kernel<kMode, kUpdate, kPacked, kWalk>
      <<<grid, kThreads, kBytes, a.st>>>(
          a.m, a.t, a.tiles, a.s, a.n, a.P, a.G, a.K, a.mirror, a.walk_arg);
  return cudaGetLastError();
}

template <int kUpdate, int kPacked = 0, int kWalk = kWalkList>
cudaError_t launch_mode(int mode, const Args& a) {
  switch (mode) {
    case 0:
      return launch<0, kUpdate, kPacked, kWalk>(a);
    case 1:
      return launch<1, kUpdate, kPacked, kWalk>(a);
    case 2:
      return launch<2, kUpdate, kPacked, kWalk>(a);
    default:
      return cudaErrorInvalidValue;
  }
}

// kLean on packed or unpacked rows over any walk.
template <int kPacked>
cudaError_t launch_walk(int walk, int mode, const Args& a) {
  switch (walk) {
    case kWalkList:
      return launch_mode<kLean, kPacked, kWalkList>(mode, a);
    case kWalkDiag:
      return launch_mode<kLean, kPacked, kWalkDiag>(mode, a);
    case kWalkBand:
      return launch_mode<kLean, kPacked, kWalkBand>(mode, a);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Launches on `stream` and returns the first CUDA error (0 on success).
// m (P, G, K) holds 0/1 bytes or, with packed, two nibble columns a byte
// (column 2j low, 2j + 1 high), K bytes a multiple of 128 and m 16-byte
// aligned; t (P, G) is f32 T clamped to >= 1.  walk 0 reads the int32
// (n_blocks, 2) list `tiles` of (row tile, column tile) in units of 128
// rows; walk 1 (the wrapped diagonals, walk_arg = nt = ceil(G / 128),
// n_blocks = (nt / 2 + 1) nt, on an nt x (nt / 2 + 1) grid) and walk 2
// (band row walk_arg, n_blocks = nt - walk_arg) decode their tiles and
// read no list.  The launch writes
// s (G, G) f32 and n (G, G) int32 at every cell of the tiles it walks and
// of the transposes of those it mirrors.  mode: 0 Newton, 1 approximate
// reciprocal, 2 IEEE divide.  update: 0 lean, 1 pipe, 2 pair (the `fused`
// and `mxu_outer` values), 3 counts (S the f32 sum of the counts, N 0; any
// mode); 1 and 2 need P < 32768; packed and walks 1 and 2 run lean.
int sn_square_wgmma_launch(const void* m, const void* t, const void* tiles,
                           void* s, void* n, int P, int G, int K,
                           int n_blocks, int mirror, int mode, int update,
                           int packed, int walk, int walk_arg, void* stream) {
  if (P <= 0 || G <= 0 || K <= 0 || n_blocks <= 0 || K % kSliceBytes ||
      (long long)P * (K / kSliceBytes) > 0x7fffffffLL || mode < 0 ||
      mode > 2 || ((update == kPipe || update == kPair) && P >= kMaxPackedP) ||
      packed < 0 || packed > 1 || walk < kWalkList || walk > kWalkBand ||
      (walk == kWalkList) != (tiles != nullptr) || walk_arg < 0 ||
      (walk == kWalkDiag && (walk_arg == 0 || n_blocks % walk_arg)) ||
      ((packed || walk != kWalkList) && update != kLean))
    return (int)cudaErrorInvalidValue;
  const Args a{static_cast<const uint8_t*>(m),
               static_cast<const float*>(t),
               static_cast<const int32_t*>(tiles),
               static_cast<float*>(s),
               static_cast<int32_t*>(n),
               P, G, K, n_blocks, mirror, walk_arg,
               static_cast<cudaStream_t>(stream)};
  if (packed) return (int)launch_walk<1>(walk, mode, a);
  switch (update) {
    case kLean:
      return (int)launch_walk<0>(walk, mode, a);
    case kPipe:
      return (int)launch_mode<kPipe>(mode, a);
    case kPair:
      return (int)launch_mode<kPair>(mode, a);
    case kCounts:
      // counts never divides: one instantiation serves every mode
      return (int)launch<0, kCounts, 0, kWalkList>(a);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* sn_square_wgmma_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
