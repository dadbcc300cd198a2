// Square all-vs-all fused (S, N) for Hopper (sm_90a).
//
// Replaces the square TPU kernels of parfastaai_tpu/ops/pallas_intersect.py,
// all of which compute, for one presence tensor M (P, G, K) against itself,
// per protein p in ascending order,
//
//     cnt = M_p . M_p^T                       (0/1 bytes, int32 counts)
//     S  += cnt / (t_p[i] + t_p[j] - cnt)     (f32, T pre-clamped >= 1)
//     N  += min(cnt, 1)                       (int32)
//
// and differ only in which output tiles they walk and how.  The tile-list
// walks of unpacked presence, with every update of the two-proteins-per-step
// body but `f32gram`, run csrc/sn_square_wgmma.cu on the int8 tensor cores,
// and `f32gram` runs csrc/sn_square_mma.cu.  This kernel keeps nibble-packed
// input and the diagonal and band walks, all with the `lean` update:
//   `_pallas_sn_sym`         triu tiles, one protein per step, with
//                            nibble-packed input (kPacked);
//   `_pallas_sn`             every tile of the square, packed;
//   `_pallas_sn_sym_diag`    tiles (i, (i + d) mod nt), d = 0..nt/2, decoded
//                            in closed form from the block index;
//   `_pallas_sn_sym_bands`,  one launch per band row r over tiles
//   `_pallas_sn_sym_bands_2p`  (r, r..nt-1), kPP = 1 or 2.
//
// Design (simple and right first), from csrc/sn_rect.cu's body:
//   * One thread block per 64 x 64 output tile, 256 threads, each thread
//     owning a 4 x 4 register tile of counts, S and N; the protein loop runs
//     inside the block and S/N stay in registers until the one store.
//   * The grid is 1-D.  A block finds its tile in one of three walks: an
//     int32 (n_tiles, 2) list of (row tile, col tile) built by the wrapper
//     (the counterpart of the TPU's scalar-prefetched `rows, cols` maps),
//     the wrapped diagonals, or one band row.
//   * Symmetric walks write the mirror in the epilogue: an off-diagonal tile
//     (r, c) also stores its transpose at (c, r).  cnt is symmetric and
//     ta + tb commutes, so the mirror is bit-equal to computing (c, r); no
//     G x G `where(upper, s, s.T)` pass follows.
//   * Ragged G and an odd P are masked, not padded: rows past G load zeros
//     and are never stored, and the missing second protein of the last pair
//     is a zero protein (cnt == 0 adds exactly 0 to S and N).
//   * kPP = 2 finishes both proteins' count tiles before either epilogue
//     runs; the epilogues then accumulate in ascending protein order, so the
//     output is bit-identical to kPP = 1.
//   * kPacked: each input byte holds two presence columns as nibbles (column
//     2j low, 2j+1 high); two __dp4a over the masked nibbles count exactly.
//   * The Jaccard transform uses explicit round-to-nearest intrinsics, so
//     nvcc cannot contract it into FMAs: mode 2 (precise) is bit-identical
//     to the IEEE f32 plain version.
//   * No atomics and no split over K or P across blocks.
//
// What bounds it on the H100: the integer dot-product instruction rate, as
// in sn_rect.cu (__dp4a on the CUDA cores, 4 MACs per instruction, about a
// sixteenth of the int8 tensor-core peak), and the shared-memory loads that
// feed it: on an H100 80GB HBM3 at 700 W the packed input, with half the
// loads and more integer work, ran 13% faster than the unpacked one.  The
// triu walk halves the work of the full square.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;            // output tile edge (rows and columns)
constexpr int kThreads = 256;        // 16 x 16 threads
constexpr int kReg = 4;              // register tile edge per thread
constexpr int kSliceBytes = 64;      // K bytes staged per shared-memory slice
constexpr int kSliceWords = kSliceBytes / 4;
constexpr unsigned int kNibbles = 0x0F0F0F0Fu;

// Walks: how a block finds its output tile.
constexpr int kWalkList = 0;  // tiles[2q], tiles[2q + 1]
constexpr int kWalkDiag = 1;  // (i, (i + d) mod nt), q = d * nt + i
constexpr int kWalkBand = 2;  // (r, r + q)

__device__ __forceinline__ float rcp_approx(float x) {
  float r;
  asm("rcp.approx.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// One Jaccard term of count c.  mode: 0 = Newton-refined reciprocal, 1 =
// raw approximate reciprocal, 2 = IEEE divide (the plain version's op
// order).
template <int kMode>
__device__ __forceinline__ float jaccard(int c, float ta, float tb) {
  const float cf = __int2float_rn(c);
  const float d = __fsub_rn(__fadd_rn(ta, tb), cf);  // >= 1; cnt == 0 gives 0
  if (kMode == 2) return __fdiv_rn(cf, d);
  if (kMode == 1) return __fmul_rn(cf, rcp_approx(d));
  float r = rcp_approx(d);
  r = __fmul_rn(r, __fsub_rn(2.0f, __fmul_rn(d, r)));
  return __fmul_rn(cf, r);
}

// T of the step's proteins at the thread's rows and columns; 1 where the
// protein or the genome lies past the end.
template <int kPP>
__device__ __forceinline__ void load_t(float (&tav)[kPP][kReg],
                                       float (&tbv)[kPP][kReg],
                                       const float* __restrict__ t, int p0,
                                       int P, int G, int row0, int col0) {
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
#pragma unroll
  for (int k = 0; k < kPP; ++k) {
    const bool live = p0 + k < P;
    const size_t base = (size_t)(p0 + k) * G;
#pragma unroll
    for (int i = 0; i < kReg; ++i) {
      const int r = row0 + ty * kReg + i;
      tav[k][i] = live && r < G ? t[base + r] : 1.0f;
      const int c = col0 + tx * kReg + i;
      tbv[k][i] = live && c < G ? t[base + c] : 1.0f;
    }
  }
}

// The epilogue of the step starting at protein p0: each protein's Jaccard
// terms into the resident S/N tile, in ascending protein order.
template <int kMode, int kPP>
__device__ __forceinline__ void lean_update(const int (&cnt)[kPP][kReg][kReg],
                                            float (&s)[kReg][kReg],
                                            int (&n)[kReg][kReg],
                                            const float* __restrict__ t,
                                            int p0, int P, int G, int row0,
                                            int col0) {
  float tav[kPP][kReg], tbv[kPP][kReg];
  load_t<kPP>(tav, tbv, t, p0, P, G, row0, col0);
#pragma unroll
  for (int i = 0; i < kReg; ++i) {
#pragma unroll
    for (int j = 0; j < kReg; ++j) {
#pragma unroll
      for (int k = 0; k < kPP; ++k) {
        s[i][j] = __fadd_rn(
            s[i][j], jaccard<kMode>(cnt[k][i][j], tav[k][i], tbv[k][j]));
        n[i][j] += min(cnt[k][i][j], 1);
      }
    }
  }
}

template <int kMode, int kPP, bool kPacked>
__global__ void __launch_bounds__(kThreads)
sn_square_kernel(const uint8_t* __restrict__ m, const float* __restrict__ t,
                 const int32_t* __restrict__ tiles, float* __restrict__ s_out,
                 int32_t* __restrict__ n_out, int P, int G, int K, int walk,
                 int walk_arg, int mirror) {
  // Word-transposed slices: a_s[k][w][r] holds bytes 4w..4w+3 of tile row
  // r of the step's k-th protein.
  __shared__ __align__(16) uint32_t a_s[kPP][kSliceWords][kTile];
  __shared__ __align__(16) uint32_t b_s[kPP][kSliceWords][kTile];

  const int q = blockIdx.x;
  int rt, ct;
  bool mirror_tile;
  if (walk == kWalkList) {
    rt = tiles[2 * q];
    ct = tiles[2 * q + 1];
    mirror_tile = mirror && rt != ct;
  } else if (walk == kWalkDiag) {
    // walk_arg = nt.  Forward distance d covers both orientations when
    // 2d == nt, so only 0 < d and 2d != nt mirror (the TPU wrapper's
    // `covered = dist <= nt // 2` rule).
    const int nt = walk_arg;
    const int d = q / nt;
    rt = q - d * nt;
    ct = rt + d;
    if (ct >= nt) ct -= nt;
    mirror_tile = d != 0 && 2 * d != nt;
  } else {  // kWalkBand: walk_arg = the band's row tile
    rt = walk_arg;
    ct = walk_arg + q;
    mirror_tile = mirror && rt != ct;
  }

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // column group: columns 4tx .. 4tx+3
  const int ty = tid / 16;  // row group: rows 4ty .. 4ty+3
  const int row0 = rt * kTile;
  const int col0 = ct * kTile;
  // Loader: each thread copies one 16-byte chunk of one tile row per side
  // and per protein of the step.
  const int lrow = tid / 4;
  const int lchunk = tid % 4;
  const bool a_live = row0 + lrow < G;
  const bool b_live = col0 + lrow < G;

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
    int cnt[kPP][kReg][kReg];
#pragma unroll
    for (int k = 0; k < kPP; ++k) {
#pragma unroll
      for (int i = 0; i < kReg; ++i) {
#pragma unroll
        for (int j = 0; j < kReg; ++j) cnt[k][i][j] = 0;
      }
    }

    for (int k0 = 0; k0 < K; k0 += kSliceBytes) {
      const int w0 = lchunk * 4;
#pragma unroll
      for (int k = 0; k < kPP; ++k) {
        uint4 va = make_uint4(0u, 0u, 0u, 0u);
        uint4 vb = make_uint4(0u, 0u, 0u, 0u);
        if (a_live && live[k])
          va = *reinterpret_cast<const uint4*>(a_row[k] + k0 + lchunk * 16);
        if (b_live && live[k])
          vb = *reinterpret_cast<const uint4*>(b_row[k] + k0 + lchunk * 16);
        a_s[k][w0 + 0][lrow] = va.x;
        a_s[k][w0 + 1][lrow] = va.y;
        a_s[k][w0 + 2][lrow] = va.z;
        a_s[k][w0 + 3][lrow] = va.w;
        b_s[k][w0 + 0][lrow] = vb.x;
        b_s[k][w0 + 1][lrow] = vb.y;
        b_s[k][w0 + 2][lrow] = vb.z;
        b_s[k][w0 + 3][lrow] = vb.w;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kPP; ++k) {
#pragma unroll
        for (int w = 0; w < kSliceWords; ++w) {
          const uint4 a4 =
              *reinterpret_cast<const uint4*>(&a_s[k][w][ty * kReg]);
          const uint4 b4 =
              *reinterpret_cast<const uint4*>(&b_s[k][w][tx * kReg]);
          const unsigned int av[kReg] = {a4.x, a4.y, a4.z, a4.w};
          const unsigned int bv[kReg] = {b4.x, b4.y, b4.z, b4.w};
          if (kPacked) {
            unsigned int alo[kReg], ahi[kReg], blo[kReg], bhi[kReg];
#pragma unroll
            for (int i = 0; i < kReg; ++i) {
              alo[i] = av[i] & kNibbles;
              ahi[i] = (av[i] >> 4) & kNibbles;
              blo[i] = bv[i] & kNibbles;
              bhi[i] = (bv[i] >> 4) & kNibbles;
            }
#pragma unroll
            for (int i = 0; i < kReg; ++i) {
#pragma unroll
              for (int j = 0; j < kReg; ++j) {
                const unsigned int c =
                    __dp4a(alo[i], blo[j], (unsigned int)cnt[k][i][j]);
                cnt[k][i][j] = (int)__dp4a(ahi[i], bhi[j], c);
              }
            }
          } else {
#pragma unroll
            for (int i = 0; i < kReg; ++i) {
#pragma unroll
              for (int j = 0; j < kReg; ++j) {
                cnt[k][i][j] =
                    (int)__dp4a(av[i], bv[j], (unsigned int)cnt[k][i][j]);
              }
            }
          }
        }
      }
      __syncthreads();
    }

    lean_update<kMode, kPP>(cnt, s, n, t, p0, P, G, row0, col0);
  }

#pragma unroll
  for (int i = 0; i < kReg; ++i) {
    const int r = row0 + ty * kReg + i;
    if (r >= G) continue;
#pragma unroll
    for (int j = 0; j < kReg; ++j) {
      const int c = col0 + tx * kReg + j;
      if (c < G) {
        s_out[(size_t)r * G + c] = s[i][j];
        n_out[(size_t)r * G + c] = n[i][j];
        if (mirror_tile) {
          s_out[(size_t)c * G + r] = s[i][j];
          n_out[(size_t)c * G + r] = n[i][j];
        }
      }
    }
  }
}

// One launch; kMode 0/1/2 picked at run time.
template <int kPP, bool kPacked>
void launch(int mode, const dim3& grid, cudaStream_t st, const uint8_t* m,
            const float* t, const int32_t* tiles, float* s, int32_t* n,
            int P, int G, int K, int walk, int walk_arg, int mirror) {
  if (mode == 0)
    sn_square_kernel<0, kPP, kPacked><<<grid, kThreads, 0, st>>>(
        m, t, tiles, s, n, P, G, K, walk, walk_arg, mirror);
  else if (mode == 1)
    sn_square_kernel<1, kPP, kPacked><<<grid, kThreads, 0, st>>>(
        m, t, tiles, s, n, P, G, K, walk, walk_arg, mirror);
  else
    sn_square_kernel<2, kPP, kPacked><<<grid, kThreads, 0, st>>>(
        m, t, tiles, s, n, P, G, K, walk, walk_arg, mirror);
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// m (P, G, K) holds 0/1 bytes (packed: two nibble columns per byte), K a
// multiple of 64 and m 16-byte aligned; t (P, G) is f32 T clamped to >= 1;
// tiles is the int32 (n_blocks, 2) tile list of walk 0 (unused otherwise).
// The launch writes s (G, G) f32 and n (G, G) int32 at every cell of the
// tiles it walks and, where it mirrors, of their transposes.
// pp is 1 or 2; packed needs pp == 1.
int sn_square_launch(const void* m, const void* t, const void* tiles,
                     void* s, void* n, int P, int G, int K, int n_blocks,
                     int walk, int walk_arg, int mirror, int mode, int pp,
                     int packed, void* stream) {
  if (n_blocks <= 0 || walk < kWalkList || walk > kWalkBand || mode < 0 ||
      mode > 2)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(n_blocks);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* mp = static_cast<const uint8_t*>(m);
  const float* tp = static_cast<const float*>(t);
  const int32_t* tl = static_cast<const int32_t*>(tiles);
  float* so = static_cast<float*>(s);
  int32_t* no = static_cast<int32_t*>(n);
  if (pp == 1 && packed) {
    launch<1, true>(mode, grid, st, mp, tp, tl, so, no, P, G, K, walk,
                    walk_arg, mirror);
  } else if (pp == 1) {
    launch<1, false>(mode, grid, st, mp, tp, tl, so, no, P, G, K, walk,
                     walk_arg, mirror);
  } else if (pp == 2 && !packed) {
    launch<2, false>(mode, grid, st, mp, tp, tl, so, no, P, G, K, walk,
                     walk_arg, mirror);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* sn_square_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
