// Native runtime components: CSV frame ingest and decision-log writing.
//
// The reference's host runtime does both in C++ (frame parse loop
// main.cpp:310-330, a per-sample std::stoi loop; decision-log writer
// reportAffineResultsMaster_new, main_aux_functions.h:387-525).  These are
// the host-side hot loops — a 1080p 2-frame pair is ~8.3M samples of CSV —
// so the port keeps them native as well: mmap + branch-light integer
// scanning for ingest, bulk in-memory formatting for the logs.  The C ABI
// is the JAX package's (vvc_affine_tpu/native/vvc_native.cpp).
//
// Exposed as a plain C ABI consumed via ctypes (vvc_affine_tpu_torch.native).

#include <cstdint>
#include <cstdio>
#include <cstring>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

extern "C" {

// Parse `rows` CSV lines of at least `cols` comma-separated unsigned ints
// into out[rows*cols] (row-major), ignoring any extra columns.  Returns 0,
// or -1 (open/map failure) / -(2+row) (file ended early, a field with no
// digits, or a value exceeding uint16 range at `row` — malformed input
// fails loudly instead of silently producing corrupted frames).
int64_t vvc_parse_luma_csv(const char* path, uint16_t* out, int64_t rows,
                           int64_t cols) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return -1;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    close(fd);
    return -1;
  }
  size_t len = static_cast<size_t>(st.st_size);
  const char* base =
      static_cast<const char*>(mmap(nullptr, len, PROT_READ, MAP_PRIVATE, fd, 0));
  close(fd);
  if (base == MAP_FAILED) return -1;
  const char* p = base;
  const char* end = base + len;

  for (int64_t r = 0; r < rows; ++r) {
    uint16_t* dst = out + r * cols;
    int64_t c = 0;
    while (c < cols) {
      if (p >= end) {
        munmap(const_cast<char*>(base), len);
        return -(2 + r);
      }
      uint32_t v = 0;
      const char* field_start = p;
      while (p < end) {
        unsigned d = static_cast<unsigned>(*p) - '0';
        if (d > 9u) break;
        v = v * 10u + d;
        // per-digit bound: rejects oversized values before uint32 wrap
        // (65535*10+9 < 2^32, so the check itself cannot be defeated)
        if (v > 65535u) {
          munmap(const_cast<char*>(base), len);
          return -(2 + r);
        }
        ++p;
      }
      if (p == field_start) {
        munmap(const_cast<char*>(base), len);
        return -(2 + r);
      }
      dst[c++] = static_cast<uint16_t>(v);
      // skip one separator (',' normally; tolerate stray whitespace)
      while (p < end && (*p == ',' || *p == ' ' || *p == '\r')) ++p;
      if (p < end && *p == '\n') break;
    }
    if (c < cols) {
      munmap(const_cast<char*>(base), len);
      return -(2 + r);
    }
    // skip to end of line (extra columns are legal in the format)
    while (p < end && *p != '\n') ++p;
    if (p < end) ++p;
  }
  munmap(const_cast<char*>(base), len);
  return 0;
}

static char* put_i64(char* q, int64_t v) {
  if (v < 0) {
    *q++ = '-';
    v = -v;
  }
  char tmp[24];
  int n = 0;
  do {
    tmp[n++] = static_cast<char>('0' + (v % 10));
    v /= 10;
  } while (v);
  while (n) *q++ = tmp[--n];
  return q;
}

// Append n_rows decision-log rows to `path`:
//   POC,List,Ref,CTU,idx,X,Y,Cost,LT_X,LT_Y,RT_X,RT_Y,LB_X,LB_Y
// meta: int32 [n_rows, 7] = (POC, List, Ref, CTU, idx, X, Y);
// cost: int64 [n_rows]; cpmv: int32 [n_rows, 6].
// write_header truncates the file and emits the header first.
// Returns 0 on success, -1 on IO failure.
int64_t vvc_append_decision_rows(const char* path, int32_t write_header,
                                 int64_t n_rows, const int32_t* meta,
                                 const int64_t* cost, const int32_t* cpmv) {
  FILE* f = fopen(path, write_header ? "w" : "a");
  if (!f) return -1;
  // Transactional append: remember the pre-write size and truncate back on
  // any failure, so a failed call leaves NO partial rows behind (the Python
  // caller raises on rc != 0).
  off_t start = 0;
  if (!write_header) {
    if (fseeko(f, 0, SEEK_END) != 0 || (start = ftello(f)) < 0) {
      fclose(f);
      return -1;
    }
  }
  bool ok = true;
  if (write_header) {
    static const char kHeader[] =
        "POC,List,Ref,CTU,idx,X,Y,Cost,LT_X,LT_Y,RT_X,RT_Y,LB_X,LB_Y\n";
    ok = fwrite(kHeader, 1, sizeof(kHeader) - 1, f) == sizeof(kHeader) - 1;
  }
  // 14 fields, worst ~21 chars each
  const size_t kMaxRow = 14 * 22 + 2;
  char* buf = new char[kMaxRow * 4096];
  char* q = buf;
  for (int64_t i = 0; ok && i < n_rows; ++i) {
    const int32_t* m = meta + i * 7;
    const int32_t* v = cpmv + i * 6;
    for (int k = 0; k < 7; ++k) {
      q = put_i64(q, m[k]);
      *q++ = ',';
    }
    q = put_i64(q, cost[i]);
    for (int k = 0; k < 6; ++k) {
      *q++ = ',';
      q = put_i64(q, v[k]);
    }
    *q++ = '\n';
    if (static_cast<size_t>(q - buf) > kMaxRow * 4095) {
      ok = fwrite(buf, 1, q - buf, f) == static_cast<size_t>(q - buf);
      q = buf;
    }
  }
  if (ok && q != buf)
    ok = fwrite(buf, 1, q - buf, f) == static_cast<size_t>(q - buf);
  delete[] buf;
  if (ok) ok = fflush(f) == 0;
  if (!ok) {
    // roll the file back to its pre-call size (best effort)
    if (ftruncate(fileno(f), start) != 0) { /* nothing more we can do */ }
  }
  fclose(f);  // data already flushed; close failure past this point is moot
  return ok ? 0 : -1;
}

}  // extern "C"
