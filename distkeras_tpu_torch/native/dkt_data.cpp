// Native data-path kernels for distkeras_tpu_torch (a copy of
// distkeras_tpu/native/dkt_data.cpp: the PyTorch port builds and loads its
// own library, never the JAX package's).
//
// The reference's data plane is Spark's JVM (DataFrames, executors'
// row iterators — reference: distkeras/workers.py minibatch assembly from
// partition iterators); this library is its native host-side equivalent
// for the input pipeline: a single-pass numeric CSV parser feeding float32
// buffers directly (the examples' `spark.read.csv` load path), an order of
// magnitude faster than Python's csv module row loop, plus a row-gather
// primitive backing Dataset shuffling.
//
// Built as a shared library by data/native.py on first use (g++ -O3); the
// ctypes ABI below is the full surface. Fields may be double-quoted
// ("1.5"); a malformed / empty / ragged field is an error (-2), matching
// the strictness of the Python fallback.

#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

char *read_file(const char *path, long *size_out) {
  FILE *f = std::fopen(path, "rb");
  if (!f) return nullptr;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  char *buf = static_cast<char *>(std::malloc(size + 1));
  if (!buf) {
    std::fclose(f);
    return nullptr;
  }
  long got = static_cast<long>(std::fread(buf, 1, size, f));
  std::fclose(f);
  if (got != size) {
    std::free(buf);
    return nullptr;
  }
  buf[size] = '\0';
  *size_out = size;
  return buf;
}

inline const char *line_end(const char *p, const char *end) {
  while (p < end && *p != '\n') ++p;
  return p;
}

inline bool line_is_blank(const char *p, const char *eol) {
  for (; p < eol; ++p)
    if (!std::isspace(static_cast<unsigned char>(*p))) return false;
  return true;
}

// Count columns on [p, eol), respecting double quotes.
int64_t count_cols(const char *p, const char *eol) {
  int64_t cols = 1;
  bool quoted = false;
  for (; p < eol; ++p) {
    if (*p == '"') quoted = !quoted;
    else if (*p == ',' && !quoted) ++cols;
  }
  return cols;
}

bool parse_line(const char *p, const char *eol, float *out, int64_t cols);

// Does [p, eol) look like a header line? A line is a header iff it does
// NOT parse as a full row of `cols` floats. strtof accepts nan/inf/-inf
// tokens, so a headerless file whose first data row contains them is
// correctly treated as data (the old alphabetic-character scan misdetected
// such rows as headers and silently dropped them).
bool looks_like_header(const char *p, const char *eol, int64_t cols) {
  std::vector<float> scratch(static_cast<size_t>(cols > 0 ? cols : 1));
  return !parse_line(p, eol, scratch.data(), cols);
}

// Parse one line of `cols` comma-separated floats into out. Returns true
// on success; false on empty/malformed/ragged fields. Accepts optional
// double quotes around a field. Never reads past eol, so a trailing empty
// field cannot pull values from the next line.
bool parse_line(const char *p, const char *eol, float *out, int64_t cols) {
  const char *q = p;
  for (int64_t c = 0; c < cols; ++c) {
    while (q < eol && (*q == ' ' || *q == '\t' || *q == '\r')) ++q;
    bool quoted = q < eol && *q == '"';
    if (quoted) ++q;
    if (q >= eol || *q == ',') return false;  // empty field
    char *after = nullptr;
    float v = std::strtof(q, &after);
    if (after == q || after > eol) return false;
    out[c] = v;
    q = after;
    if (quoted) {
      if (q >= eol || *q != '"') return false;
      ++q;
    }
    while (q < eol && (*q == ' ' || *q == '\t' || *q == '\r')) ++q;
    if (c + 1 < cols) {
      if (q >= eol || *q != ',') return false;  // ragged: too few fields
      ++q;
    }
  }
  while (q < eol && (*q == ' ' || *q == '\t' || *q == '\r')) ++q;
  return q == eol;  // ragged: extra fields
}

}  // namespace

extern "C" {

// Inspect a CSV: data-line count, column count of the first line, header
// flag. One full read; intended for introspection (the loader itself uses
// dkt_csv_load below, which parses in a single pass).
int dkt_csv_dims(const char *path, int64_t *rows, int64_t *cols,
                 int *has_header) {
  long size = 0;
  char *buf = read_file(path, &size);
  if (!buf) return -1;
  const char *end = buf + size;

  int64_t nrows = 0;
  int64_t ncols = 0;
  int header = 0;
  bool first = true;
  for (const char *p = buf; p < end;) {
    const char *eol = line_end(p, end);
    if (!line_is_blank(p, eol)) {
      ++nrows;
      if (first) {
        first = false;
        ncols = count_cols(p, eol);
        header = looks_like_header(p, eol, ncols) ? 1 : 0;
      }
    }
    p = eol < end ? eol + 1 : end;
  }
  std::free(buf);
  *rows = header ? nrows - 1 : nrows;
  *cols = ncols;
  *has_header = header;
  return 0;
}

// Single-pass load: read the file once, parse every data line into a
// malloc'd float32 buffer (*out_data, ownership passes to the caller —
// free with dkt_free). Returns 0 on success, -1 on IO error, -2 on a
// malformed/ragged line. rows/cols/has_header are outputs.
int dkt_csv_load(const char *path, float **out_data, int64_t *rows,
                 int64_t *cols, int *has_header) {
  long size = 0;
  char *buf = read_file(path, &size);
  if (!buf) return -1;
  const char *end = buf + size;

  float *data = nullptr;
  int64_t cap_rows = 0;
  int64_t nrows = 0;
  int64_t ncols = 0;
  int header = 0;
  bool first = true;
  int rc = 0;

  for (const char *p = buf; p < end;) {
    const char *eol = line_end(p, end);
    if (!line_is_blank(p, eol)) {
      if (first) {
        first = false;
        ncols = count_cols(p, eol);
        header = looks_like_header(p, eol, ncols) ? 1 : 0;
        if (header) {
          p = eol < end ? eol + 1 : end;
          continue;
        }
      }
      if (nrows == cap_rows) {
        cap_rows = cap_rows ? cap_rows * 2 : 1024;
        float *grown = static_cast<float *>(
            std::realloc(data, sizeof(float) * cap_rows * ncols));
        if (!grown) {
          rc = -1;
          break;
        }
        data = grown;
      }
      if (!parse_line(p, eol, data + nrows * ncols, ncols)) {
        rc = -2;
        break;
      }
      ++nrows;
    }
    p = eol < end ? eol + 1 : end;
  }
  std::free(buf);
  if (rc != 0) {
    std::free(data);
    return rc;
  }
  *out_data = data;
  *rows = nrows;
  *cols = ncols;
  *has_header = header;
  return 0;
}

void dkt_free(float *ptr) { std::free(ptr); }

// Row gather: dst[i] = src[idx[i]] for float32 matrices — the shuffle /
// partition materialization primitive behind Dataset.__getitem__
// (reference: distkeras/utils.py -> shuffle over DataFrames).
void dkt_gather_rows_f32(const float *src, const int64_t *idx, float *dst,
                         int64_t n_idx, int64_t row_elems) {
  for (int64_t i = 0; i < n_idx; ++i) {
    std::memcpy(dst + i * row_elems, src + idx[i] * row_elems,
                sizeof(float) * row_elems);
  }
}

}  // extern "C"
