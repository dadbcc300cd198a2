// What the wgmma kernels share (csrc/sn_rect.cu, csrc/sn_square_wgmma.cu):
// the PTX wrappers of the asynchronous copies and of the int8 warpgroup
// product, the shared-memory matrix descriptor of the staged layout, the
// Jaccard term, and the body of a block: S and N of one 128 x 128 output
// tile, from a ring of staged K slices to the accumulator registers, with
// one of four updates (kLean, kPipe, kPair, kCounts: when and in what
// order the counts become S and N), on 0/1 bytes or, with kPacked, on
// nibble-packed rows.  The kernels differ in where the staged rows come
// from and in how the tile is stored.  All in an unnamed namespace.
//
// The staged layout: a tile is K-major, a slice of 128 bytes of K a row; row
// r lies at byte 128 r and its 16-byte chunk c at chunk c ^ (r % 8) of that
// row (the 128-byte swizzle that the descriptor names).  A tile starts on a
// 1024-byte boundary (the swizzle is a function of the address bits), 8-row
// groups are 1024 bytes apart, and a k32 step advances the descriptor's
// start address by 32 bytes.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

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

// ---- the body of a block -------------------------------------------------

constexpr int kSliceBytes = 128;  // K bytes per staged slice: one swizzled row
constexpr int kStages = 5;        // ring depth: 3 slices in flight, 2 in use
constexpr int kTile = 128;        // output tile edge: two warpgroups x 64 rows
                                  // by the wgmma's N
constexpr int kThreads = 256;
constexpr int kRows = 2 * kTile;  // staged rows: the A side's, then the B side's
constexpr int kTileBytes = kRows * kSliceBytes;
// ring of slices, ring of T rows, slack to align the ring to 1024 bytes
constexpr int kSmemBytes = kStages * (kTileBytes + kRows * 4) + 1024;
// kPacked: a staged byte holds presence columns 2j (low nibble) and 2j + 1
// (high nibble).  The loader stages the packed bytes as it stages 0/1
// bytes; each thread then turns its own chunks of a slice that has landed
// into two slices of 0/1 bytes, the low nibbles in place and the high ones
// at the same offsets of a buffer beside the ring, and the slice takes
// eight k32 products instead of four.  Both sides keep one order of the
// columns (a packed chunk's low nibbles, then its high ones), so the sum
// over K is the count.  The second slice does not fit beside five stages
// (227 KB a block): the packed ring has four, two slices in flight (512
// presence columns, against 384 of the unpacked ring's three), and two
// high-nibble buffers, slice i's at i % 2.  A thread writes that buffer
// before the barrier that makes slice i visible, while the other
// warpgroup's products of slice i - 2 may still read it, so one more
// barrier a slice comes first: two a packed slice, one per 128 columns as
// unpacked.
constexpr int kPackedStages = 4;
constexpr unsigned kNibbles = 0x0F0F0F0Fu;
static_assert(kPackedStages % 2 == 0, "slice i's high nibbles at stage % 2");
constexpr int kNT = kTile / 8;    // n8 column groups of the accumulator
static_assert(kRows == kThreads, "one T value a thread");
// The two-set updates keep N beside the ring, two 16-bit halves a word.
constexpr int kNWordBytes = kTile * kTile * 2;

// Updates of the body: how each protein's counts reach S and N.
//   kLean  one count set: a protein's terms are added in place, after a wait
//          for its last products (the TPU's `lean` / `base` bodies).
//   kPipe  two count sets, the proteins alternating between them: protein
//          p's terms are added under protein p + 1's products, one piece of
//          the columns between the issue and the wait of each of p + 1's
//          first kPipePieces slices, the pieces left with its last slice
//          when it has fewer; the last protein's after the loop
//          (`_sym_kernel_2p_pipe`).  Each cell still adds its terms in
//          ascending protein order, so kPipe is bit-equal to kLean.
//   kPair  two count sets, proteins 2k and 2k + 1, the first one's last
//          products in flight under the second's; then one epilogue adds
//          s += j0 + j1 and n += min(c0, 1) + min(c1, 1), the order of the
//          plain `fused` update (`_sym_kernel_2p_fused`).  An odd last
//          protein's partner is a zero protein, whose term adds exactly 0,
//          so it takes kLean's s += j0.
//   kCounts one count set a pair of proteins 2k, 2k + 1: 2k's first slice
//          overwrites it, every later slice of the pair adds to it, and one
//          epilogue a pair adds s += f32(c0 + c1); N stays 0 and no T is
//          read (`_sym_kernel_2p_lean` with counts_only, the machinery
//          without the transform).  c0, c1 <= K < 2^24 are exact in f32, so
//          the rounded f32(c0) + f32(c1) of the plain version is f32(c0 + c1).
//
// Registers.  A thread owns 64 cells of its warpgroup's 64 x 128 piece: 64
// s32 counts, 64 f32 S and 64 s32 N are 192 of the 255 registers it may
// have (sn_rect compiles to 248-255).  A second count set would make 256 of
// state.  The two-set updates hold N as two 16-bit halves a word (N <= P <
// kMaxPackedP), and keep those 32 words a thread in shared memory beside the
// ring (kNWordBytes, 32 KB: 202 KB of the 227 KB a block may have), so their
// register state is 192, as kLean's.  In registers the halves made 224 of
// state, and ptxas spilled in most of the two-set instantiations.  The
// words cost one shared load and store per two cells and protein, a
// thread's own words, 4 bytes apart across a warp (no bank conflict), no
// barrier.  The other ways out cost more here.  A producer warpgroup that
// gives up registers with setmaxnreg leaves the two consumer warpgroups 240
// each at most (65,536 a SM over three warpgroups): with 256 of state it
// needs the halves as well.  A ping-pong of the two warpgroups (one count set each,
// one's epilogue under the other's products) needs the ring to hold the
// slices of the lag between them; the epilogue lasts 3-4 slices of products
// at K = 1280, and two more stages already pass the 227 KB.
//
// Waits.  ptxas lets an instruction read a count set only where every path
// from the set's last wgmma passes a wgmma.wait_group 0: a wait_group 1
// after the other set's next products does not satisfy it, and it then
// serializes every wgmma of the kernel (advisory C7514).  So a protein whose
// counts are read next ends with wait_group 0, and kPipe's pieces of protein
// p run after each of p + 1's slices is issued and before its wait_group 1.
constexpr int kLean = 0;
constexpr int kPipe = 1;
constexpr int kPair = 2;
constexpr int kCounts = 3;
constexpr int kPipePieces = 4;       // kPipe: kNT / kPipePieces groups a piece
constexpr int kMaxPackedP = 32768;   // kPipe, kPair: P below this
static_assert(kNT % kPipePieces == 0, "whole column groups a piece");

// The two-set updates' epilogue: adds the terms of column groups kJ0 ..
// kJ1 - 1 of count set c (one protein, its T at tp, the ring slot) to s
// and N; with kPair, those of set c1 (the next protein, T at tp1) too, as
// s += j0 + j1 and n += min(c0, 1) + min(c1, 1).  N is 16-bit halves in
// shared memory: element i in half i % 2 of word nw[(i / 2) kThreads].
// ta_row is the thread's first row in the tile, tig its column pair in a
// group.
template <int kMode, int kJ0, int kJ1, bool kPair>
__device__ __forceinline__ void add_terms(const int (&c)[4 * kNT],
                                          const int (&c1)[4 * kNT],
                                          const float* tp, const float* tp1,
                                          int ta_row, int tig,
                                          float (&s)[4 * kNT], uint32_t* nw) {
  const float ta0 = tp[ta_row];
  const float ta1 = tp[ta_row + 8];
  float ua0 = 0.0f, ua1 = 0.0f;
  if constexpr (kPair) {
    ua0 = tp1[ta_row];
    ua1 = tp1[ta_row + 8];
  }
#pragma unroll
  for (int j = kJ0; j < kJ1; ++j) {
    const float2 tbv =
        *reinterpret_cast<const float2*>(tp + kTile + 8 * j + 2 * tig);
    float2 ubv = tbv;
    if constexpr (kPair)
      ubv = *reinterpret_cast<const float2*>(tp1 + kTile + 8 * j + 2 * tig);
    int hits[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int ci = c[4 * j + e];
      float term =
          jaccard<kMode>(ci, e / 2 ? ta1 : ta0, e % 2 ? tbv.y : tbv.x);
      hits[e] = min(ci, 1);
      if constexpr (kPair) {
        const int ci1 = c1[4 * j + e];
        term = __fadd_rn(
            term, jaccard<kMode>(ci1, e / 2 ? ua1 : ua0, e % 2 ? ubv.y : ubv.x));
        hits[e] += min(ci1, 1);
      }
      s[4 * j + e] = __fadd_rn(s[4 * j + e], term);
    }
    nw[(2 * j) * kThreads] += hits[0] + (hits[1] << 16);
    nw[(2 * j + 1) * kThreads] += hits[2] + (hits[3] << 16);
  }
}

// kPipe: the pieces kI .. of count set c's epilogue that follow slice ks of
// the next protein: piece i (column groups i kNT / kPipePieces ..) after
// slice i, and every piece not yet added after the next protein's last
// slice (`last`).
template <int kMode, int kI = 0>
__device__ __forceinline__ void pipe_pieces(const int (&c)[4 * kNT],
                                            const float* tp, int ta_row,
                                            int tig, int ks, bool last,
                                            float (&s)[4 * kNT],
                                            uint32_t* nw) {
  if constexpr (kI < kPipePieces) {
    constexpr int kW = kNT / kPipePieces;
    if (ks == kI || (last && ks < kI))
      add_terms<kMode, kI * kW, (kI + 1) * kW, false>(c, c, tp, tp, ta_row,
                                                      tig, s, nw);
    pipe_pieces<kMode, kI + 1>(c, tp, ta_row, tig, ks, last, s, nw);
  }
}

// kPacked: the thread's own eight 16-byte chunks of a packed slice (at p,
// its first; 32 rows apart) after its own copies have landed: the low
// nibbles in place, the high ones hi_offset bytes on.
__device__ __forceinline__ void unpack_chunks(uint8_t* p, int hi_offset) {
#pragma unroll
  for (int i = 0; i < kRows / 32; ++i) {
    uint4* const c = reinterpret_cast<uint4*>(p + i * 32 * kSliceBytes);
    const uint4 v = *c;
    *reinterpret_cast<uint4*>(reinterpret_cast<uint8_t*>(c) + hi_offset) =
        make_uint4((v.x >> 4) & kNibbles, (v.y >> 4) & kNibbles,
                   (v.z >> 4) & kNibbles, (v.w >> 4) & kNibbles);
    *c = make_uint4(v.x & kNibbles, v.y & kNibbles, v.z & kNibbles,
                    v.w & kNibbles);
  }
}

// S and N of one 128 x 128 tile over proteins 0 .. P - 1 in ascending order,
// left in this thread's accumulator layout: element 4 j + e is row
// 64 wg + 16 warp + g + 8 (e / 2), column 8 j + 2 tig + e % 2 of the tile
// (wg = tid / 128, warp = tid % 128 / 32, g = lane / 4, tig = lane % 4).
// Called by all kThreads threads of a block that was launched with
// smem_bytes(kUpdate, kPacked) of dynamic shared memory; K is a multiple
// of kSliceBytes (packed: bytes of two columns each), and P < kMaxPackedP
// for kPipe and kPair; kCounts leaves N at 0 and its S is the sum of the
// counts (no transform).  kPacked runs kLean.
//
// `src` names the global memory behind the staged rows:
//   src.stage_rows(p, k_off, dst0, lrow): this thread's part of one slice of
//     protein p, 16 bytes at byte k_off of each presence row that is staged
//     as row lrow + 32 i of the A side (i = 0 .. 3; cp_async16 to dst0 +
//     32 i kSliceBytes) and of the B side (kTile rows further on); a row
//     past the edge is filled with zeros (src_bytes 0).  The order of these
//     eight copies is the kernel's own: it moves the loop's schedule, and
//     with it the kernel's time, by up to a tenth.
//   src.t_row(p, i, live): the T value of staged row i (A's 128, then B's);
//     past the edge `live` is false and the address any valid one.
template <int kMode, int kUpdate = kLean, bool kPacked = false, class Src>
__device__ __forceinline__ void sn_wgmma_tile(const Src& src, int P, int K,
                                              float (&s)[4 * kNT],
                                              int (&n)[4 * kNT]) {
  static_assert(!kPacked || kUpdate == kLean, "packed rows run kLean");
  constexpr int kSt = kPacked ? kPackedStages : kStages;
  // k32 products a slice: packed, four of the low nibbles, four of the high
  constexpr int kSteps = (kPacked ? 2 : 1) * kSliceBytes / 32;
  extern __shared__ uint4 smem_u4[];
  // 1024-byte aligned: the swizzle is a function of the address bits.
  const uint32_t raw_sa = shared_addr(smem_u4);
  const uint32_t smem_sa = (raw_sa + 1023u) & ~1023u;
  uint8_t* const smem =
      reinterpret_cast<uint8_t*>(smem_u4) + (smem_sa - raw_sa);
  float* const t_s = reinterpret_cast<float*>(smem + kSt * kTileBytes);
  const uint32_t t_sa = smem_sa + kSt * kTileBytes;
  // Behind the ring and its T rows: kPacked's two high-nibble buffers, the
  // two-set updates' N words.
  const int ring_end = kSt * (kTileBytes + kRows * 4);

  const int tid = threadIdx.x;
  const int wg = tid / 128;          // warpgroup: rows 64 wg .. + 63
  const int warp = tid % 128 / 32;   // warp of the warpgroup: rows 16 warp
  const int g = tid % 32 / 4;
  const int tig = tid % 4;
  const int ks_per_p = K / kSliceBytes;

  // Loader: 16-byte chunk tid % 8 of staged row tid / 8 + 32 i, stored at
  // chunk ^ (row % 8) of its 128-byte row (the 128-byte swizzle).
  const int lrow = tid / 8;
  const int lchunk = tid % 8;
  const uint32_t lphys = lrow * kSliceBytes + ((lchunk ^ (lrow & 7)) << 4);
  int lp = 0, lks = 0;

  auto load_slice = [&](int stage) {
    const size_t k_off = (size_t)lks * kSliceBytes + lchunk * 16;
    const uint32_t dst0 = smem_sa + stage * kTileBytes + lphys;
    // staged rows lrow + 32 i: (row & 7) == (lrow & 7)
    src.stage_rows(lp, k_off, dst0, lrow);
    if (lks == 0) {
      bool live;
      // This protein's T (zeros past the edge: those cells are never
      // stored).
      const float* t = src.t_row(lp, tid, live);
      cp_async4(t_sa + ((lp % kSt) * kRows + tid) * 4, t, live ? 4 : 0);
    }
    if (++lks == ks_per_p) {
      lks = 0;
      ++lp;
    }
  };

  // Slices 0 .. kSt - 3 of the flat (protein, slice) sequence in flight.
  auto fill_ring = [&] {
#pragma unroll
    for (int st = 0; st < kSt - 2; ++st) {
      if (lp < P) load_slice(st);
      cp_async_commit();
    }
  };

  // The next slice of the sequence, slice ks of its protein: its products
  // into count set d (a protein's first overwrites it), one commit group.
  // Slices it .. it + kSt - 3 are loaded or in flight while slice it is
  // multiplied; the stage of slice it - 1 may still be read by wgmma.
  int stage = 0;
  auto mma_slice = [&](int (&d)[4 * kNT], int ks) {
    cp_async_wait<kSt - 3>();
    // kPacked: past this barrier both warpgroups have waited for their
    // wgmma of slice it - 2, which read the high-nibble buffer of slice it.
    if constexpr (kPacked) {
      __syncthreads();
      unpack_chunks(smem + stage * kTileBytes + lphys,
                    ring_end + (stage % 2 - stage) * kTileBytes);
    }
    fence_proxy_async();
    // Past the barrier slice `it` is visible to all, and both warpgroups
    // have waited for their wgmma of slice it - 2: its stage is free.
    __syncthreads();
    if (lp < P) load_slice((stage + kSt - 2) % kSt);
    cp_async_commit();

    const uint32_t a_sa = smem_sa + stage * kTileBytes + wg * 64 * kSliceBytes;
    const uint32_t b_sa = smem_sa + stage * kTileBytes + kTile * kSliceBytes;
    uint64_t da = smem_desc(a_sa), db = smem_desc(b_sa);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kSteps; ++j) {
      if (kPacked && j == kSliceBytes / 32) {
        // the high nibbles: the same offsets in this slice's buffer
        const uint32_t h_sa = smem_sa + ring_end + stage % 2 * kTileBytes;
        da = smem_desc(h_sa + wg * 64 * kSliceBytes);
        db = smem_desc(h_sa + kTile * kSliceBytes);
      }
      // 32 bytes further along K inside the swizzled row: + 2 in the
      // descriptor's 16-byte address units.
      const int k32 = j % (kSliceBytes / 32);
      wgmma_m64n128k32(d, da + 2 * k32, db + 2 * k32, (ks | j) != 0);
    }
    wgmma_commit();
    stage = (stage + 1) % kSt;
  };
  // Protein p's T: its ring slot, which the loader refills kSt proteins
  // later (at least kSt slices on, while it runs kSt - 2 ahead).
  auto t_of = [&](int p) { return t_s + (p % kSt) * kRows; };

  if constexpr (kUpdate == kLean) {
    int cnt[4 * kNT];
#pragma unroll
    for (int i = 0; i < 4 * kNT; ++i) {
      cnt[i] = 0;
      s[i] = 0.0f;
      n[i] = 0;
    }
    fill_ring();
    const int total = P * ks_per_p;
    int p = 0, ks = 0;
    for (int it = 0; it < total; ++it) {
      mma_slice(cnt, ks);
      if (++ks == ks_per_p) {
        // Epilogue: protein p's Jaccard terms into the resident S/N cells
        // (written out: through add_terms this update compiles to other
        // SASS, and sn_rect's --fast block and the default plans run it).
        wgmma_wait<0>();
        const float* tp = t_s + (p % kSt) * kRows;
        const float ta0 = tp[64 * wg + 16 * warp + g];
        const float ta1 = tp[64 * wg + 16 * warp + g + 8];
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          const float2 tbv =
              *reinterpret_cast<const float2*>(tp + kTile + 8 * j + 2 * tig);
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
  } else if constexpr (kUpdate == kCounts) {
    // kLean's loop over runs of two proteins' slices, in a branch of its
    // own so that kLean's code stays as it is.  The pair's products run
    // back to back (wait_group 1 between its slices), the pair's last
    // slice (or an odd last protein's) drains them before the conversion.
    int cnt[4 * kNT];
#pragma unroll
    for (int i = 0; i < 4 * kNT; ++i) {
      cnt[i] = 0;
      s[i] = 0.0f;
      n[i] = 0;
    }
    fill_ring();
    const int total = P * ks_per_p;
    const int per_pair = 2 * ks_per_p;
    int ks = 0;  // slice of the pair: mma_slice overwrites the set at 0
    for (int it = 0; it < total; ++it) {
      mma_slice(cnt, ks);
      if (++ks == per_pair || it + 1 == total) {
        wgmma_wait<0>();
#pragma unroll
        for (int i = 0; i < 4 * kNT; ++i)
          s[i] = __fadd_rn(s[i], __int2float_rn(cnt[i]));
        ks = 0;
      } else {
        wgmma_wait<1>();
      }
    }
    // Retires nothing (the last slice drained), but ptxas cannot see that
    // the loop leaves only after a wait_group 0, and injects one (C7517).
    wgmma_wait<0>();
  } else {
    static_assert(kUpdate == kPipe || kUpdate == kPair, "unknown update");
    const int ta_row = 64 * wg + 16 * warp + g;
    // Counts of the even and the odd proteins; N's words in shared memory.
    int ca[4 * kNT], cb[4 * kNT];
    uint32_t* const nw = reinterpret_cast<uint32_t*>(smem + ring_end) + tid;
#pragma unroll
    for (int i = 0; i < 4 * kNT; ++i) {
      ca[i] = 0;
      cb[i] = 0;
      s[i] = 0.0f;
    }
#pragma unroll
    for (int i = 0; i < 2 * kNT; ++i) nw[i * kThreads] = 0;
    fill_ring();
    // Protein p's slices into count set d; with `pieces`, protein p - 1's
    // epilogue (set prev, retired) in pieces beside them; with `drain`, the
    // last slice's wait retires every product (wait_group 0), so that the
    // protein's counts may be read.  Both flags are std::bool_constant.
    auto protein = [&](int (&d)[4 * kNT], const int (&prev)[4 * kNT], int p,
                       auto pieces, auto drain) {
      for (int ks = 0; ks + 1 < ks_per_p; ++ks) {
        mma_slice(d, ks);
        if constexpr (decltype(pieces)::value)
          pipe_pieces<kMode>(prev, t_of(p - 1), ta_row, tig, ks, false, s,
                             nw);
        wgmma_wait<1>();
      }
      mma_slice(d, ks_per_p - 1);
      if constexpr (decltype(pieces)::value)
        pipe_pieces<kMode>(prev, t_of(p - 1), ta_row, tig, ks_per_p - 1, true,
                           s, nw);
      if constexpr (decltype(drain)::value)
        wgmma_wait<0>();
      else
        wgmma_wait<1>();
    };
    constexpr std::bool_constant<kUpdate == kPipe> kPieces{}, kDrainFirst{};
    constexpr std::false_type kNo{};
    constexpr std::true_type kYes{};
    // Protein 0, which has no predecessor, then pairs (p, p + 1), p odd.
    // kPipe drains every protein; kPair only the second of a pair, leaving
    // the first one's last products in flight under the second's.  The loop
    // starts with a protein that takes pieces on every pass: when its first
    // pass skipped them, ptxas made its pieces wait for its own products
    // (C7517).
    protein(ca, cb, 0, kNo, kDrainFirst);
    for (int p = 1; p < P; p += 2) {
      protein(cb, ca, p, kPieces, kYes);
      if constexpr (kUpdate == kPair)
        add_terms<kMode, 0, kNT, true>(ca, cb, t_of(p - 1), t_of(p), ta_row,
                                       tig, s, nw);
      if (p + 1 == P) break;
      protein(ca, cb, p + 1, kPieces, kDrainFirst);
    }
    wgmma_wait<0>();
    // The last protein's terms: kPipe's always, kPair's for an odd P.
    if (P % 2)
      add_terms<kMode, 0, kNT, false>(ca, ca, t_of(P - 1), t_of(P - 1),
                                      ta_row, tig, s, nw);
    else if constexpr (kUpdate == kPipe)
      add_terms<kMode, 0, kNT, false>(cb, cb, t_of(P - 1), t_of(P - 1),
                                      ta_row, tig, s, nw);
#pragma unroll
    for (int i = 0; i < 2 * kNT; ++i) {
      const uint32_t w = nw[i * kThreads];
      n[2 * i] = (int)(w & 0xFFFFu);
      n[2 * i + 1] = (int)(w >> 16);
    }
  }
  cp_async_wait<0>();
}

// Dynamic shared memory of a block of the update: the ring, and for the
// two-set updates N's words; packed, the ring of four and the two
// high-nibble buffers (197 KB).
constexpr int smem_bytes(int update, bool packed = false) {
  return packed ? kPackedStages * (kTileBytes + kRows * 4) + 2 * kTileBytes +
                      1024
                : kSmemBytes +
                      (update == kPipe || update == kPair ? kNWordBytes : 0);
}

// Allows kernel `bytes` of dynamic shared memory: above 48 KB it must be
// allowed once per kernel and device, or the launch is refused.  `allowed`
// is the kernel's own record of the devices done (64 entries).
template <class Kernel>
cudaError_t allow_ring(Kernel kernel, bool* allowed, int bytes = kSmemBytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64 || !allowed[dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    if (dev >= 0 && dev < 64) allowed[dev] = true;
  }
  return cudaSuccess;
}

}  // namespace
