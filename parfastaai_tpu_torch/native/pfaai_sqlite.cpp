// Native SQLite ETL: FastAAI database -> dense presence tensor, in C++.
//
// The reference's data loader is native C++ streaming SQLite rows on OpenMP
// threads (include/pfaai/scp_db.hpp:121-262, ds_helper.hpp:126-162).  This is
// its TPU-framework equivalent: one pass per protein reads the
// '{SCP}_tetras' rows and scatters the genome-id blobs straight into the
// (P, G, K) uint8 presence tensor (no intermediate Python objects; with a
// column map and a row offset, into two databases' shared one), then
// fills the T matrix from '{SCP}_genomes' (T[p,g] = blob bytes / 4,
// scp_db.hpp:253-256).  Proteins run in parallel, one read-only connection
// per protein (SQLite supports concurrent readers).
//
// The system ships libsqlite3.so.0 but no development header, so the tiny
// slice of the (stable) SQLite C ABI used here is declared locally and the
// library is dlopen'd at first use; if it cannot be loaded the Python
// caller falls back to the stdlib-sqlite3 ETL (etl/database.py) — the same
// C library through Python bindings, so behavior is identical, only slower.
//
// Exposed with C linkage for ctypes (no pybind11 in this environment).

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>

#include <dlfcn.h>
#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

int clamp_threads(int64_t req) {
#ifdef _OPENMP
  return req > 0 ? static_cast<int>(req) : omp_get_max_threads();
#else
  (void)req;
  return 1;
#endif
}

// ---- minimal SQLite C ABI (stable since 3.x; see sqlite.org/c3ref) --------
typedef struct sqlite3 sqlite3;
typedef struct sqlite3_stmt sqlite3_stmt;
typedef int64_t sqlite3_int64;

constexpr int kSqliteOk = 0;
constexpr int kSqliteRow = 100;
constexpr int kSqliteDone = 101;
constexpr int kOpenReadonly = 0x00000001;
constexpr int kOpenNoMutex = 0x00008000;

struct SqliteApi {
  int (*open_v2)(const char*, sqlite3**, int, const char*);
  int (*close)(sqlite3*);
  int (*prepare_v2)(sqlite3*, const char*, int, sqlite3_stmt**, const char**);
  int (*step)(sqlite3_stmt*);
  int (*finalize)(sqlite3_stmt*);
  sqlite3_int64 (*column_int64)(sqlite3_stmt*, int);
  const void* (*column_blob)(sqlite3_stmt*, int);
  int (*column_bytes)(sqlite3_stmt*, int);
  const char* (*errmsg)(sqlite3*);
  bool ok = false;
};

const SqliteApi& api() {
  static SqliteApi a = [] {
    SqliteApi s{};
    void* h = nullptr;
    for (const char* name :
         {"libsqlite3.so.0", "libsqlite3.so", "libsqlite3.so.3"}) {
      h = dlopen(name, RTLD_NOW | RTLD_GLOBAL);
      if (h) break;
    }
    if (!h) return s;
    auto sym = [&](const char* n) { return dlsym(h, n); };
    s.open_v2 = reinterpret_cast<decltype(s.open_v2)>(sym("sqlite3_open_v2"));
    s.close = reinterpret_cast<decltype(s.close)>(sym("sqlite3_close"));
    s.prepare_v2 =
        reinterpret_cast<decltype(s.prepare_v2)>(sym("sqlite3_prepare_v2"));
    s.step = reinterpret_cast<decltype(s.step)>(sym("sqlite3_step"));
    s.finalize =
        reinterpret_cast<decltype(s.finalize)>(sym("sqlite3_finalize"));
    s.column_int64 = reinterpret_cast<decltype(s.column_int64)>(
        sym("sqlite3_column_int64"));
    s.column_blob =
        reinterpret_cast<decltype(s.column_blob)>(sym("sqlite3_column_blob"));
    s.column_bytes = reinterpret_cast<decltype(s.column_bytes)>(
        sym("sqlite3_column_bytes"));
    s.errmsg = reinterpret_cast<decltype(s.errmsg)>(sym("sqlite3_errmsg"));
    s.ok = s.open_v2 && s.close && s.prepare_v2 && s.step && s.finalize &&
           s.column_int64 && s.column_blob && s.column_bytes && s.errmsg;
    return s;
  }();
  return a;
}

// SQLite identifier quoting: "name" with embedded quotes doubled (the Python
// ETL single-quotes table names, which SQLite accepts in legacy mode; the
// double-quoted identifier form is the strict spelling of the same name).
std::string quote_ident(const char* name) {
  std::string out = "\"";
  for (const char* p = name; *p; ++p) {
    out += *p;
    if (*p == '"') out += '"';
  }
  out += '"';
  return out;
}

struct ErrSink {
  char* buf;
  int64_t len;
  std::atomic<int> flag{0};
  void set(const char* msg) {
    int expected = 0;
    if (flag.compare_exchange_strong(expected, 1)) {
      std::snprintf(buf, static_cast<size_t>(len), "%s", msg);
    }
  }
  bool failed() const { return flag.load(std::memory_order_relaxed) != 0; }
};

sqlite3* open_ro(const char* path, ErrSink& err) {
  sqlite3* db = nullptr;
  if (api().open_v2(path, &db, kOpenReadonly | kOpenNoMutex, nullptr) !=
      kSqliteOk) {
    err.set(db ? api().errmsg(db) : "sqlite3_open_v2 failed");
    if (db) api().close(db);
    return nullptr;
  }
  return db;
}

// Streams one protein's '{prot}_tetras' rows into its (G_out, K_out) slice
// mp, the database's genome g on row g (mp starts at the database's first
// row).  Unmapped: row j is column j and its tetramer id goes to tetp[j].
// Mapped: row j is column mapp[j], and its tetramer id must equal tetp[j]
// (the ids the map was built from).  Returns false with err set.
template <bool kMapped>
bool fill_tetras(sqlite3* db, sqlite3_stmt* st, int64_t width, int64_t G,
                 int64_t K_out, const int32_t* mapp, int32_t* tetp,
                 uint8_t* mp, ErrSink& err) {
  int64_t j = 0;
  int rc;
  while ((rc = api().step(st)) == kSqliteRow) {
    if (j >= width) {
      err.set("etl_load: more '_tetras' rows than etl_widths counted");
      return false;
    }
    const int32_t tet = static_cast<int32_t>(api().column_int64(st, 0));
    int64_t col = j;
    if constexpr (kMapped) {
      if (tet != tetp[j]) {
        err.set("etl_load: a '_tetras' row differs from the ids pass");
        return false;
      }
      col = mapp[j];
    } else {
      tetp[j] = tet;
    }
    const void* blob = api().column_blob(st, 1);
    const int nbytes = api().column_bytes(st, 1);
    if (nbytes % 4 != 0) {
      err.set("etl_load: genomes blob length not a multiple of 4");
      return false;
    }
    const int64_t nids = nbytes / 4;
    for (int64_t i = 0; i < nids; ++i) {
      int32_t gid;
      std::memcpy(&gid, static_cast<const char*>(blob) + 4 * i, 4);
      if (gid < 0 || gid >= G) {
        err.set(
            "Corrupt database: genome id outside [0, G) in a "
            "tetramer blob");
        return false;
      }
      mp[static_cast<int64_t>(gid) * K_out + col] = 1;
    }
    ++j;
  }
  if (rc != kSqliteDone) {
    err.set(api().errmsg(db));
    return false;
  }
  if (j != width) {
    err.set("etl_load: fewer '_tetras' rows than etl_widths counted");
    return false;
  }
  return true;
}

}  // namespace

extern "C" {

// True when the SQLite shared library was found and all symbols resolved.
int32_t sqlite_available(void) { return api().ok ? 1 : 0; }

// Per-protein row counts of the '{prot}_tetras' tables (the compacted
// presence widths; COUNT(*) walks the table b-tree without decoding blobs).
// Returns 0 on success; on failure returns 1 with a message in err.
int32_t etl_widths(const char* db_path, const char* const* prots, int64_t P,
                   int32_t* widths, int64_t nthreads, char* errbuf,
                   int64_t errlen) {
  ErrSink err{errbuf, errlen};
  if (!api().ok) {
    err.set("libsqlite3 unavailable");
    return 1;
  }
#pragma omp parallel num_threads(clamp_threads(nthreads))
  {
    sqlite3* db = nullptr;
#pragma omp for schedule(dynamic)
    for (int64_t p = 0; p < P; ++p) {
      if (err.failed()) continue;
      if (!db) {
        db = open_ro(db_path, err);
        if (!db) continue;
      }
      // The table name is '{prot}_tetras' as one identifier.
      std::string sql = "SELECT COUNT(*) FROM " +
                        quote_ident((std::string(prots[p]) + "_tetras").c_str());
      sqlite3_stmt* st = nullptr;
      if (api().prepare_v2(db, sql.c_str(), -1, &st, nullptr) != kSqliteOk) {
        err.set(api().errmsg(db));
        continue;
      }
      if (api().step(st) == kSqliteRow) {
        widths[p] = static_cast<int32_t>(api().column_int64(st, 0));
      } else {
        err.set(api().errmsg(db));
      }
      api().finalize(st);
    }
    if (db) api().close(db);
  }
  return err.failed() ? 1 : 0;
}

// Per-protein tetramer ids of the '{prot}_tetras' tables, ascending: row j
// of protein p writes tets[p*K + j].  Reads the INTEGER PRIMARY KEY alone,
// so no blob is decoded.  Each protein's row count must equal widths[p]
// (the etl_widths result; widths[p] <= K).  Returns 0 on success; on
// failure returns 1 with a message in err.
int32_t etl_ids(const char* db_path, const char* const* prots, int64_t P,
                int64_t K, const int32_t* widths, int32_t* tets,
                int64_t nthreads, char* errbuf, int64_t errlen) {
  ErrSink err{errbuf, errlen};
  if (!api().ok) {
    err.set("libsqlite3 unavailable");
    return 1;
  }
#pragma omp parallel num_threads(clamp_threads(nthreads))
  {
    sqlite3* db = nullptr;
#pragma omp for schedule(dynamic)
    for (int64_t p = 0; p < P; ++p) {
      if (err.failed()) continue;
      if (!db) {
        db = open_ro(db_path, err);
        if (!db) continue;
      }
      std::string sql = "SELECT tetramer FROM " +
                        quote_ident((std::string(prots[p]) + "_tetras").c_str()) +
                        " ORDER BY tetramer";
      sqlite3_stmt* st = nullptr;
      if (api().prepare_v2(db, sql.c_str(), -1, &st, nullptr) != kSqliteOk) {
        err.set(api().errmsg(db));
        continue;
      }
      int32_t* tetp = tets + p * K;
      int64_t j = 0;
      int rc;
      while ((rc = api().step(st)) == kSqliteRow) {
        if (j >= widths[p]) {
          err.set("etl_ids: more '_tetras' rows than etl_widths counted");
          break;
        }
        tetp[j++] = static_cast<int32_t>(api().column_int64(st, 0));
      }
      if (rc != kSqliteDone && !err.failed()) err.set(api().errmsg(db));
      if (!err.failed() && j != widths[p]) {
        err.set("etl_ids: fewer '_tetras' rows than etl_widths counted");
      }
      api().finalize(st);
    }
    if (db) api().close(db);
  }
  return err.failed() ? 1 : 0;
}

// One-pass ETL of one database into a presence m (P, G_out, K_out) and a T
// t (P, G_out), its genome g on row row0 + g: for each protein p (OpenMP,
// own connection) stream '{prot}_tetras' ORDER BY tetramer and set a 1 at
// every genome id of row j's blob, then fill T[p, row0 + g] from
// '{prot}_genomes' blob lengths.  m and t must be zeroed.
//
// colmap null (one database): row j is column j and writes its tetramer id
// to tets[p*K + j] (unused tail columns are left untouched); the caller
// passes G_out = G, K_out = K, row0 = 0.  colmap (P, K) given (two
// databases in one presence): row j is column colmap[p*K + j] < K_out, and
// tets holds the ids the map was built from (etl_ids): a row whose tetramer
// differs fails.
//
// Genome ids are checked against this database's own G, and each protein's
// row count must equal widths[p] (the etl_widths result the caller sized
// the tensors with) — a database mutated between the passes, or a corrupt
// one, returns 1 with a message instead of silently wrong tensors.
int32_t etl_load(const char* db_path, const char* const* prots, int64_t P,
                 int64_t G, int64_t K, const int32_t* widths, uint8_t* m,
                 int32_t* tets, int32_t* t, int64_t nthreads,
                 const int32_t* colmap, int64_t row0, int64_t G_out,
                 int64_t K_out, char* errbuf, int64_t errlen) {
  ErrSink err{errbuf, errlen};
  if (!api().ok) {
    err.set("libsqlite3 unavailable");
    return 1;
  }
#pragma omp parallel num_threads(clamp_threads(nthreads))
  {
    sqlite3* db = nullptr;
#pragma omp for schedule(dynamic)
    for (int64_t p = 0; p < P; ++p) {
      if (err.failed()) continue;
      if (!db) {
        db = open_ro(db_path, err);
        if (!db) continue;
      }
      const std::string tname = std::string(prots[p]);
      uint8_t* mp = m + (p * G_out + row0) * K_out;
      int32_t* tetp = tets + p * K;
      {
        std::string sql = "SELECT tetramer, genomes FROM " +
                          quote_ident((tname + "_tetras").c_str()) +
                          " ORDER BY tetramer";
        sqlite3_stmt* st = nullptr;
        if (api().prepare_v2(db, sql.c_str(), -1, &st, nullptr) !=
            kSqliteOk) {
          err.set(api().errmsg(db));
          continue;
        }
        const bool ok =
            colmap ? fill_tetras<true>(db, st, widths[p], G, K_out,
                                       colmap + p * K, tetp, mp, err)
                   : fill_tetras<false>(db, st, widths[p], G, K_out, nullptr,
                                        tetp, mp, err);
        api().finalize(st);
        if (!ok) continue;
      }
      {
        std::string sql = "SELECT genome_id, length(tetramers) FROM " +
                          quote_ident((tname + "_genomes").c_str());
        sqlite3_stmt* st = nullptr;
        if (api().prepare_v2(db, sql.c_str(), -1, &st, nullptr) !=
            kSqliteOk) {
          err.set(api().errmsg(db));
          continue;
        }
        int32_t* tp = t + p * G_out + row0;
        int rc;
        while ((rc = api().step(st)) == kSqliteRow) {
          const sqlite3_int64 gid = api().column_int64(st, 0);
          if (gid < 0 || gid >= G) {
            err.set(
                "Corrupt database: genome id outside [0, G) in a "
                "'_genomes' row");
            break;
          }
          tp[gid] = static_cast<int32_t>(api().column_int64(st, 1) / 4);
        }
        if (rc != kSqliteDone && !err.failed()) err.set(api().errmsg(db));
        api().finalize(st);
      }
    }
    if (db) api().close(db);
  }
  return err.failed() ? 1 : 0;
}

}  // extern "C"
