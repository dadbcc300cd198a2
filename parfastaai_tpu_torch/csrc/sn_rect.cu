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
// Design:
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

namespace {

constexpr int kSliceBytes = 128;  // K bytes per staged slice: one swizzled row
constexpr int kStages = 5;        // ring depth: 3 slices in flight, 2 in use
constexpr int kBM = 128;          // two warpgroups x 64 rows
constexpr int kBN = 128;          // the wgmma's N
constexpr int kThreads = 256;
constexpr int kRows = kBM + kBN;  // staged rows: A's, then B's
constexpr int kTileBytes = kRows * kSliceBytes;
// ring of slices, ring of T rows, slack to align the ring to 1024 bytes
constexpr int kSmemBytes = kStages * (kTileBytes + kRows * 4) + 1024;
constexpr int kNT = kBN / 8;      // n8 column groups of the accumulator
static_assert(kRows == kThreads, "one T value a thread");

// ---- PTX primitives ------------------------------------------------------

__device__ __forceinline__ float rcp_approx(float x) {
  float r;
  asm("rcp.approx.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; src_bytes 0 fills with zeros
// (src must still be a valid address).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(kPending) : "memory");
}

// Writes made through the generic proxy (cp.async) become visible to the
// async proxy (wgmma's reads of shared memory).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(kPending) : "memory");
}

// d (64 x 128 s32, this warpgroup's accumulator) = or += a (64 x 32 s8,
// K-major in shared memory) . b (128 x 32 s8, K-major in shared memory).
__device__ __forceinline__ void wgmma_m64n128k32(int (&d)[64], uint64_t desc_a,
                                                 uint64_t desc_b,
                                                 int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}
// ---- end of PTX primitives -----------------------------------------------

// Shared-memory matrix descriptor of a K-major tile of 128-byte rows in the
// 128-byte swizzle: start address, 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// One Jaccard term of the integer count c.  mode: 0 = Newton-refined
// reciprocal, 1 = raw approximate reciprocal, 2 = IEEE divide (same op
// order as the plain version).
template <int kMode>
__device__ __forceinline__ float jaccard(int c, float ta, float tb) {
  const float cf = __int2float_rn(c);
  const float outer = __fadd_rn(ta, tb);
  const float d = __fsub_rn(outer, cf);  // >= 1; c == 0 gives j == 0
  if (kMode == 2) return __fdiv_rn(cf, d);
  if (kMode == 1) return __fmul_rn(cf, rcp_approx(d));
  float r = rcp_approx(d);
  r = __fmul_rn(r, __fsub_rn(2.0f, __fmul_rn(d, r)));
  return __fmul_rn(cf, r);
}

template <int kMode>
__global__ void __launch_bounds__(kThreads, 1)
sn_rect_kernel(const uint8_t* __restrict__ ma, const uint8_t* __restrict__ mb,
               const float* __restrict__ ta, const float* __restrict__ tb,
               float* __restrict__ s_out, int32_t* __restrict__ n_out, int P,
               int A, int B, int K, int tiles_b) {
  extern __shared__ uint4 smem_u4[];
  // 1024-byte aligned: the swizzle is a function of the address bits.
  const uint32_t raw_sa = shared_addr(smem_u4);
  const uint32_t smem_sa = (raw_sa + 1023u) & ~1023u;
  uint8_t* const smem =
      reinterpret_cast<uint8_t*>(smem_u4) + (smem_sa - raw_sa);
  float* const t_s = reinterpret_cast<float*>(smem + kStages * kTileBytes);
  const uint32_t t_sa = smem_sa + kStages * kTileBytes;

  const int tid = threadIdx.x;
  const int wg = tid / 128;          // warpgroup: rows 64 wg .. + 63
  const int warp = tid % 128 / 32;   // warp of the warpgroup: rows 16 warp
  const int g = tid % 32 / 4;
  const int tig = tid % 4;
  const int row0 = (int)(blockIdx.x / (unsigned)tiles_b) * kBM;
  const int col0 = (int)(blockIdx.x % (unsigned)tiles_b) * kBN;
  const int ks_per_p = K / kSliceBytes;
  const int total = P * ks_per_p;

  // Loader: 16-byte chunk tid % 8 of staged row tid / 8 + 32 i, stored at
  // chunk ^ (row % 8) of its 128-byte row (the 128-byte swizzle).
  const int lrow = tid / 8;
  const int lchunk = tid % 8;
  const uint32_t lphys = lrow * kSliceBytes + ((lchunk ^ (lrow & 7)) << 4);
  int lp = 0, lks = 0;

  auto load_slice = [&](int stage) {
    const size_t k_off = (size_t)lks * kSliceBytes + lchunk * 16;
    const uint32_t dst0 = smem_sa + stage * kTileBytes + lphys;
#pragma unroll
    for (int i = 0; i < kBM / 32; ++i) {
      const int r = lrow + 32 * i;  // (r & 7) == (lrow & 7)
      const bool live = row0 + r < A;
      const uint8_t* src =
          ma + ((size_t)lp * A + (live ? row0 + r : 0)) * (size_t)K + k_off;
      cp_async16(dst0 + 32 * i * kSliceBytes, src, live ? 16 : 0);
    }
#pragma unroll
    for (int i = 0; i < kBN / 32; ++i) {
      const int r = lrow + 32 * i;
      const bool live = col0 + r < B;
      const uint8_t* src =
          mb + ((size_t)lp * B + (live ? col0 + r : 0)) * (size_t)K + k_off;
      cp_async16(dst0 + (kBM + 32 * i) * kSliceBytes, src, live ? 16 : 0);
    }
    if (lks == 0) {
      // This protein's T: rows of A, then columns of B (zeros past the
      // edge: those cells are never stored).
      const bool is_a = tid < kBM;
      const int idx = is_a ? row0 + tid : col0 + tid - kBM;
      const bool live = idx < (is_a ? A : B);
      const float* src = is_a ? ta + (size_t)lp * A + (live ? idx : 0)
                              : tb + (size_t)lp * B + (live ? idx : 0);
      cp_async4(t_sa + ((lp % kStages) * kRows + tid) * 4, src, live ? 4 : 0);
    }
    if (++lks == ks_per_p) {
      lks = 0;
      ++lp;
    }
  };

  int cnt[4 * kNT];
  float s[4 * kNT];
  int n[4 * kNT];
#pragma unroll
  for (int i = 0; i < 4 * kNT; ++i) {
    cnt[i] = 0;
    s[i] = 0.0f;
    n[i] = 0;
  }

  // Slices it .. it + kStages - 3 are loaded or in flight while slice it is
  // multiplied; the stage of slice it - 1 may still be read by wgmma.
#pragma unroll
  for (int st = 0; st < kStages - 2; ++st) {
    if (lp < P) load_slice(st);
    cp_async_commit();
  }

  int p = 0, ks = 0, stage = 0;
  for (int it = 0; it < total; ++it) {
    cp_async_wait<kStages - 3>();
    fence_proxy_async();
    // Past the barrier slice `it` is visible to all, and both warpgroups
    // have waited for their wgmma of slice it - 2: its stage is free.
    __syncthreads();
    if (lp < P) load_slice((stage + kStages - 2) % kStages);
    cp_async_commit();

    const uint32_t a_sa = smem_sa + stage * kTileBytes + wg * 64 * kSliceBytes;
    const uint32_t b_sa = smem_sa + stage * kTileBytes + kBM * kSliceBytes;
    const uint64_t da = smem_desc(a_sa), db = smem_desc(b_sa);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kSliceBytes / 32; ++j) {
      // 32 bytes further along K inside the swizzled row: + 2 in the
      // descriptor's 16-byte address units.
      wgmma_m64n128k32(cnt, da + 2 * j, db + 2 * j, (ks | j) != 0);
    }
    wgmma_commit();
    stage = (stage + 1) % kStages;

    if (++ks == ks_per_p) {
      // Epilogue: protein p's Jaccard terms into the resident S/N cells.
      wgmma_wait<0>();
      const float* tp = t_s + (p % kStages) * kRows;
      const float ta0 = tp[64 * wg + 16 * warp + g];
      const float ta1 = tp[64 * wg + 16 * warp + g + 8];
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const float2 tbv =
            *reinterpret_cast<const float2*>(tp + kBM + 8 * j + 2 * tig);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = cnt[4 * j + e];
          s[4 * j + e] = __fadd_rn(
              s[4 * j + e],
              jaccard<kMode>(c, e / 2 ? ta1 : ta0, e % 2 ? tbv.y : tbv.x));
          n[4 * j + e] += min(c, 1);
        }
      }
      ks = 0;
      ++p;
    } else {
      wgmma_wait<1>();
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int j = 0; j < kNT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = row0 + 64 * wg + 16 * warp + g + 8 * (e / 2);
      const int c = col0 + 8 * j + 2 * tig + e % 2;
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
  const long long tiles_a = (A + kBM - 1) / kBM, tiles_b = (B + kBN - 1) / kBN;
  if (tiles_a * tiles_b > 0x7fffffffLL) return cudaErrorInvalidValue;
  // Above 48 KB a block's dynamic shared memory must be allowed, once per
  // kernel and device; a launch that omits it is refused.
  static bool allowed[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64 || !allowed[dev]) {
    err = cudaFuncSetAttribute(sn_rect_kernel<kMode>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemBytes);
    if (err != cudaSuccess) return err;
    if (dev >= 0 && dev < 64) allowed[dev] = true;
  }
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
