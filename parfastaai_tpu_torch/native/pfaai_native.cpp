// Native host runtime for parfastaai_tpu_torch: the C++/OpenMP pieces of the
// pipeline that stay on the host CPU next to the TPU compute path.
//
// The reference implements its entire hot path in C++/OpenMP
// (include/pfaai/ds_helper.hpp, algorithm_impl.hpp); in this framework the
// O(G^2) work lives on the TPU and only two host loops remain hot:
//
//   * jaccard_finish_f64 — the exact-parity f64 finish: for each genome pair,
//     accumulate S += cnt / (T_A + T_B - cnt) and N += [cnt > 0] over
//     proteins in ascending index order — the reference's E-block walk order
//     (E sorted by (G_A, G_B, proteinIndex), interface.hpp:103-111;
//     accumulation loop algorithm_impl.hpp:240-271).  Sequential-in-p per
//     pair => bit-for-bit f64 parity; OpenMP across pairs (pairs are
//     independent, matching the reference's pair distribution,
//     algorithm_impl.hpp:100-120).
//
//   * unpack_presence — ETL scatter of the SQLite '{SCP}_tetras' genome-id
//     blobs into the dense genome x tetramer presence matrix (the TPU-native
//     replacement for constructF, ds_helper.hpp:126-162).
//
//   * format_f64_row — CSV row formatting with shortest-round-trip doubles
//     (std::to_chars), the native counterpart of the reference's
//     fmt::print("{}") writer (src/main.cpp:160-174).  At production genome
//     counts the CSV itself is O(G^2) values, so per-value Python formatting
//     would dominate the streamed path.
//
// Exposed with C linkage for ctypes (no pybind11 in this environment).

#include <charconv>
#include <cmath>
#include <cstdint>
#include <cstring>

extern "C" {

// counts: (P, n) row-major with element size 2 (int16) or 4 (int32) — the
// device ships int16 whenever max(T) < 2^15, and accepting it here avoids a
// (P, n) int32 conversion copy on the host; ta/tb:
// (P, n) int32 — T[p, denom_a/b[i]] already gathered per pair.  Outputs
// s (n) f64 and nshared (n) int32.
void jaccard_finish_f64(const void* counts, int32_t itemsize,
                        const int32_t* ta, const int32_t* tb, int64_t P,
                        int64_t n, double* s, int32_t* nshared) {
  const int16_t* c16 = static_cast<const int16_t*>(counts);
  const int32_t* c32 = static_cast<const int32_t*>(counts);
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    double acc = 0.0;
    int32_t cnt_shared = 0;
    for (int64_t p = 0; p < P; ++p) {
      const int64_t idx = p * n + i;
      const int32_t c = itemsize == 2 ? static_cast<int32_t>(c16[idx])
                                      : c32[idx];
      if (c > 0) {
        acc += static_cast<double>(c) /
               static_cast<double>(static_cast<int64_t>(ta[idx]) + tb[idx] - c);
        ++cnt_shared;
      }
    }
    s[i] = acc;
    nshared[i] = cnt_shared;
  }
}

// Banded-block variant of jaccard_finish_f64 for the streamed exact engine
// (engine.compute_streamed_exact): counts is a (P, A, B) block in row-major
// order with element size 2 (int16) or 4 (int32) — the device ships int16
// whenever max(T) < 2^15 to halve the transfer — and the denominator T
// columns arrive factored per axis (ta: (P, A), tb: (P, B)) so no (P, A*B)
// gather is ever materialized.  Identical f64 semantics and operation order
// to jaccard_finish_f64 (ascending protein index per cell,
// algorithm_impl.hpp:240-271), hence bit-for-bit equal results.
void jaccard_finish_block_f64(const void* counts, int32_t itemsize,
                              const int32_t* ta, const int32_t* tb, int64_t P,
                              int64_t A, int64_t B, double* s,
                              int32_t* nshared) {
  const int16_t* c16 = static_cast<const int16_t*>(counts);
  const int32_t* c32 = static_cast<const int32_t*>(counts);
#pragma omp parallel for schedule(static) collapse(2)
  for (int64_t a = 0; a < A; ++a) {
    for (int64_t b = 0; b < B; ++b) {
      double acc = 0.0;
      int32_t cnt_shared = 0;
      for (int64_t p = 0; p < P; ++p) {
        const int64_t idx = (p * A + a) * B + b;
        const int32_t c = itemsize == 2 ? static_cast<int32_t>(c16[idx])
                                        : c32[idx];
        if (c > 0) {
          acc += static_cast<double>(c) /
                 static_cast<double>(static_cast<int64_t>(ta[p * A + a]) +
                                     tb[p * B + b] - c);
          ++cnt_shared;
        }
      }
      s[a * B + b] = acc;
      nshared[a * B + b] = cnt_shared;
    }
  }
}

// gids: concatenated int32 genome-id blobs of one protein's '_tetras' rows
// (column-major concatenation: column j owns gids[col_offsets[j] ..
// col_offsets[j+1])).  Writes m[(row0 + g) * K + c] = 1 for each id g in
// column j, where c = colmap[j] (an injective map into [0, K)) or, with a
// null colmap, j.
void unpack_presence(const int32_t* gids, const int64_t* col_offsets,
                     int64_t ncols, uint8_t* m, int64_t K,
                     const int32_t* colmap, int64_t row0) {
  uint8_t* rows = m + row0 * K;
#pragma omp parallel for schedule(static)
  for (int64_t j = 0; j < ncols; ++j) {
    const int64_t c = colmap ? colmap[j] : j;
    for (int64_t k = col_offsets[j]; k < col_offsets[j + 1]; ++k) {
      rows[static_cast<int64_t>(gids[k]) * K + c] = 1;
    }
  }
}

// Formats one value byte-identically to io/fmtfloat.py's format_double
// (Python repr with a trailing ".0" stripped): shortest round-trip digits,
// fixed notation for decimal exponent in [-4, 16), otherwise scientific
// with signed two-digit-minimum exponent ("1e-05", "1e+16").  Built from
// to_chars' shortest *scientific* form, because plain to_chars switches to
// scientific whenever it is shorter (e.g. "1e-04"), which repr does not.
// Returns bytes written.
static int64_t format_one(double v, char* out) {
  if (std::isnan(v)) {
    std::memcpy(out, "nan", 3);
    return 3;
  }
  if (std::isinf(v)) {
    if (v > 0) {
      std::memcpy(out, "inf", 3);
      return 3;
    }
    std::memcpy(out, "-inf", 4);
    return 4;
  }
  char* p = out;
  if (std::signbit(v)) {
    *p++ = '-';
    v = -v;
  }
  if (v == 0.0) {
    *p++ = '0';
    return p - out;
  }
  char sci[48];
  auto res = std::to_chars(sci, sci + sizeof(sci), v, std::chars_format::scientific);
  // Parse "d[.ddd]e±k" into the digit string and decimal exponent.
  char digs[24];
  int64_t ndigs = 0;
  int64_t i = 0;
  for (; sci + i < res.ptr && sci[i] != 'e'; ++i) {
    if (sci[i] != '.') digs[ndigs++] = sci[i];
  }
  int exp10 = 0;
  {
    bool neg = sci[++i] == '-';
    if (sci[i] == '-' || sci[i] == '+') ++i;
    for (; sci + i < res.ptr; ++i) exp10 = exp10 * 10 + (sci[i] - '0');
    if (neg) exp10 = -exp10;
  }
  if (exp10 >= -4 && exp10 < 16) {  // repr's fixed-notation window
    if (exp10 >= ndigs - 1) {       // integral: digits then zeros, no ".0"
      std::memcpy(p, digs, ndigs);
      p += ndigs;
      for (int64_t z = 0; z < exp10 - (ndigs - 1); ++z) *p++ = '0';
    } else if (exp10 >= 0) {  // dd.ddd
      std::memcpy(p, digs, exp10 + 1);
      p += exp10 + 1;
      *p++ = '.';
      std::memcpy(p, digs + exp10 + 1, ndigs - exp10 - 1);
      p += ndigs - exp10 - 1;
    } else {  // 0.00ddd
      *p++ = '0';
      *p++ = '.';
      for (int64_t z = 0; z < -exp10 - 1; ++z) *p++ = '0';
      std::memcpy(p, digs, ndigs);
      p += ndigs;
    }
  } else {  // scientific: d[.ddd]e±EE
    *p++ = digs[0];
    if (ndigs > 1) {
      *p++ = '.';
      std::memcpy(p, digs + 1, ndigs - 1);
      p += ndigs - 1;
    }
    *p++ = 'e';
    int e = exp10;
    *p++ = e < 0 ? '-' : '+';
    if (e < 0) e = -e;
    char ebuf[8];
    int en = 0;
    do {
      ebuf[en++] = '0' + (e % 10);
      e /= 10;
    } while (e);
    while (en < 2) ebuf[en++] = '0';
    while (en) *p++ = ebuf[--en];
  }
  return p - out;
}

// Formats n doubles joined by `sep` into buf (caller guarantees capacity:
// 25 bytes per value is ample).  Returns total bytes written.
int64_t format_f64_row(const double* vals, int64_t n, char sep, char* buf) {
  char* p = buf;
  for (int64_t i = 0; i < n; ++i) {
    if (i) *p++ = sep;
    p += format_one(vals[i], p);
  }
  return p - buf;
}

// Formats a whole (rows x cols) matrix, one CSV row per matrix row, rows in
// parallel.  Row r is written at buf + r * stride (caller sizes stride >=
// 26 * cols); row_lens[r] receives its byte length.
void format_f64_matrix(const double* vals, int64_t rows, int64_t cols,
                       char sep, char* buf, int64_t stride,
                       int64_t* row_lens) {
#pragma omp parallel for schedule(static)
  for (int64_t r = 0; r < rows; ++r) {
    row_lens[r] =
        format_f64_row(vals + r * cols, cols, sep, buf + r * stride);
  }
}

}  // extern "C"
