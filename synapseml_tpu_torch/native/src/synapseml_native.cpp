// synapseml_tpu_torch native host helpers (the port's copy of the JAX
// package's native/src/synapseml_native.cpp).
//
// The reference ships its hot host-side primitives as C++ (LightGBM/VW/OpenCV
// via JNI; .so bootstrap in core/.../core/env/NativeLoader.java). The port
// keeps device compute in its CUDA kernels and PyTorch, but the host-side
// feature-hashing path (VW-compatible murmur3 over millions of strings —
// vw/.../VowpalWabbitMurmurWithPrefix.scala is the reference's JVM copy of
// it) is pure string churn, so it lives here. Exposed as a plain C ABI for
// ctypes.
//
// Build: g++ -O3 -std=c++17 -fPIC -shared, at first use, into the checkout's
// build/synapseml_tpu_torch/ by native/__init__.py, which keeps a transparent
// Python fallback for every binding.

#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <cstdio>
#include <cmath>

namespace {

constexpr uint32_t C1 = 0xCC9E2D51u;
constexpr uint32_t C2 = 0x1B873593u;

inline uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

inline uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

uint32_t murmur3_32(const uint8_t* data, size_t len, uint32_t seed) {
  uint32_t h = seed;
  const size_t nblocks = len / 4;
  for (size_t i = 0; i < nblocks; ++i) {
    uint32_t k;
    std::memcpy(&k, data + i * 4, 4);  // little-endian hosts only (x86/ARM)
    k *= C1;
    k = rotl32(k, 15);
    k *= C2;
    h ^= k;
    h = rotl32(h, 13);
    h = h * 5 + 0xE6546B64u;
  }
  const uint8_t* tail = data + nblocks * 4;
  uint32_t k = 0;
  switch (len & 3) {
    case 3: k ^= static_cast<uint32_t>(tail[2]) << 16; [[fallthrough]];
    case 2: k ^= static_cast<uint32_t>(tail[1]) << 8;  [[fallthrough]];
    case 1:
      k ^= tail[0];
      k *= C1;
      k = rotl32(k, 15);
      k *= C2;
      h ^= k;
  }
  h ^= static_cast<uint32_t>(len);
  return fmix32(h);
}

// VW semantics: names that parse as (optionally negative) integers index
// directly as int(name) + seed instead of being hashed.
bool parse_int_name(const uint8_t* s, size_t len, int64_t* out) {
  if (len == 0) return false;
  size_t i = 0;
  bool neg = false;
  if (s[0] == '-') {
    if (len == 1) return false;
    neg = true;
    i = 1;
  }
  int64_t v = 0;
  for (; i < len; ++i) {
    if (s[i] < '0' || s[i] > '9') return false;
    v = v * 10 + (s[i] - '0');
    // cap mirrored in python _int_name — keep the two in lockstep
    if (v > (int64_t{1} << 40)) return false;
  }
  *out = neg ? -v : v;
  return true;
}

}  // namespace

extern "C" {

// Single-string hash (murmur3 x86_32).
uint32_t sml_murmur3_32(const uint8_t* data, uint64_t len, uint32_t seed) {
  return murmur3_32(data, static_cast<size_t>(len), seed);
}

// Batch feature hashing over a packed string buffer.
//   buf:     concatenated utf-8 bytes of all names
//   offsets: n+1 int64 offsets into buf (name i = buf[offsets[i]:offsets[i+1]])
//   vw_numeric_names: when nonzero, integer-looking names index directly
//                     (int(name) + seed) — VW's default string-hash behavior
//   mask:    applied as index & mask when nonzero
// Writes n uint32 hashes to out.
void sml_hash_batch(const uint8_t* buf, const int64_t* offsets, int64_t n,
                    uint32_t seed, int vw_numeric_names, uint32_t mask,
                    uint32_t* out) {
  for (int64_t i = 0; i < n; ++i) {
    const uint8_t* s = buf + offsets[i];
    const size_t len = static_cast<size_t>(offsets[i + 1] - offsets[i]);
    uint32_t h;
    int64_t as_int;
    if (vw_numeric_names && parse_int_name(s, len, &as_int)) {
      h = static_cast<uint32_t>((as_int + static_cast<int64_t>(seed)));
    } else {
      h = murmur3_32(s, len, seed);
    }
    out[i] = mask ? (h & mask) : h;
  }
}

// Batch hashing with a per-string seed array (namespace seeds).
void sml_hash_batch_seeded(const uint8_t* buf, const int64_t* offsets,
                           int64_t n, const uint32_t* seeds,
                           int vw_numeric_names, uint32_t mask,
                           uint32_t* out) {
  for (int64_t i = 0; i < n; ++i) {
    const uint8_t* s = buf + offsets[i];
    const size_t len = static_cast<size_t>(offsets[i + 1] - offsets[i]);
    uint32_t h;
    int64_t as_int;
    if (vw_numeric_names && parse_int_name(s, len, &as_int)) {
      h = static_cast<uint32_t>((as_int + static_cast<int64_t>(seeds[i])));
    } else {
      h = murmur3_32(s, len, seeds[i]);
    }
    out[i] = mask ? (h & mask) : h;
  }
}

// Tokenize-and-hash: split each document on non-alphanumeric bytes,
// lowercase ASCII, hash each token of length >= min_len into [0, mask],
// accumulating term counts into out[doc * (mask+1) + idx]. The TextFeaturizer
// hashing-TF hot path (featurize/text.py) without per-token Python objects.
void sml_hash_tf(const uint8_t* buf, const int64_t* doc_offsets, int64_t n_docs,
                 uint32_t seed, uint32_t mask, int64_t min_len, int binary,
                 float* out) {
  const int64_t dim = static_cast<int64_t>(mask) + 1;
  uint8_t token[4096];
  for (int64_t d = 0; d < n_docs; ++d) {
    const uint8_t* s = buf + doc_offsets[d];
    const int64_t len = doc_offsets[d + 1] - doc_offsets[d];
    float* row = out + d * dim;
    int64_t tlen = 0;
    for (int64_t i = 0; i <= len; ++i) {
      uint8_t c = (i < len) ? s[i] : 0;
      bool alnum = (c >= '0' && c <= '9') || (c >= 'a' && c <= 'z') ||
                   (c >= 'A' && c <= 'Z') || c >= 0x80;
      if (alnum) {
        if (c >= 'A' && c <= 'Z') c += 32;  // ascii lowercase
        if (tlen < static_cast<int64_t>(sizeof(token))) token[tlen++] = c;
      } else if (tlen > 0) {
        if (tlen >= min_len) {
          uint32_t idx = murmur3_32(token, static_cast<size_t>(tlen), seed)
                         & mask;
          if (binary) {
            row[idx] = 1.0f;
          } else {
            row[idx] += 1.0f;
          }
        }
        tlen = 0;
      }
    }
  }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Fast numeric-CSV reader — the data-plane native path (the reference's
// dataset marshaling layer, dataset/DatasetAggregator.scala:117-589, is C++
// chunked-array aggregation behind SWIG; here the hot ingest loop is native
// and the Python Table wraps the filled float32 buffer zero-copy).
// Parses comma/tab-separated floats with optional header; empty fields and
// unparseable tokens become NaN (LightGBM's missing convention).
extern "C" {

// First pass: count rows (excluding header) and columns. Returns 0 on
// success, nonzero on IO error.
int csv_dims(const char* path, int has_header, int64_t* out_rows,
             int64_t* out_cols) {
  FILE* f = fopen(path, "rb");
  if (!f) return 1;
  int64_t rows = 0, cols = 0;
  int64_t line_cols = 1;
  int c, prev = '\n';
  int first_line = 1;
  while ((c = fgetc(f)) != EOF) {
    if (c == ',' || c == '\t') {
      if (first_line) line_cols++;
    } else if (c == '\n') {
      if (prev != '\n') {  // skip blank lines
        if (first_line) { cols = line_cols; first_line = 0; }
        rows++;
      }
      line_cols = 1;
    }
    prev = c;
  }
  if (prev != '\n' && prev != EOF) rows++;  // trailing line without newline
  if (first_line && rows > 0) cols = line_cols;
  fclose(f);
  if (has_header && rows > 0) rows--;
  *out_rows = rows;
  *out_cols = cols;
  return 0;
}

// Second pass: fill the caller-allocated row-major float32 buffer.
// Returns number of rows actually parsed (or -1 on IO error).
int64_t csv_read_f32(const char* path, int has_header, int64_t rows,
                     int64_t cols, float* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  // buffered line reader
  const size_t BUF = 1 << 20;
  char* buf = static_cast<char*>(malloc(BUF));
  if (!buf) { fclose(f); return -1; }
  int64_t r = 0;
  int skipped_header = has_header ? 0 : 1;
  while (r < rows && fgets(buf, BUF, f)) {
    size_t len = strlen(buf);
    if (len + 1 >= BUF && buf[len - 1] != '\n') {
      // physical line exceeds the buffer: refuse to mis-parse — signal error
      free(buf);
      fclose(f);
      return -2;
    }
    // skip blank lines
    char* p = buf;
    while (*p == ' ' || *p == '\r') p++;
    if (*p == '\n' || *p == '\0') continue;
    if (!skipped_header) { skipped_header = 1; continue; }
    for (int64_t j = 0; j < cols; j++) {
      while (*p == ' ') p++;
      char* end = p;
      if (*p == '\0' || *p == '\n' || *p == '\r' || *p == ',' || *p == '\t') {
        out[r * cols + j] = NAN;  // empty field
      } else {
        float v = strtof(p, &end);
        out[r * cols + j] = (end == p) ? NAN : v;
        p = end;
      }
      // advance past the delimiter (or to line end)
      while (*p != '\0' && *p != ',' && *p != '\t' && *p != '\n') p++;
      if (*p == ',' || *p == '\t') p++;
    }
    r++;
  }
  free(buf);
  fclose(f);
  return r;
}

}  // extern "C"
