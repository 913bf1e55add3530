// GBDT histogram kernels for Hopper (sm_90a), bound to PyTorch with ctypes.
//
// Three entry points, one translation unit, two kernels sharing one
// accumulate routine (`warp_accumulate`):
//
//   child_histogram  replaces synapseml_tpu/ops/hist_kernel.py `_kernel` +
//                    `_packed_accumulate` (pl.pallas_call in `_hist_pallas`).
//   range_histogram  replaces synapseml_tpu/ops/hist_kernel.py `_range_kernel`
//                    (pl.pallas_call in `_hist_pallas_range`).
//   level_histogram  replaces synapseml_tpu/ops/hist_kernel.py `_level_kernel`
//                    (pl.pallas_call in `_hist_pallas_level`).
//
// What they compute (the same function as the TPU kernels, not their design):
//   out[f, b, :] = sum over rows r with bT[f, r] == b of
//                  [bf16(g[r]), bf16(h[r]), bf16(m[r])]            (f32 sums)
// bT is (FP, n) int32 row-major, g/h/m are (n,) f32, out is (FP, B, 3) f32 and
// must be zeroed by the caller (the wrapper allocates it with torch.zeros).
// g, h and m are rounded to bf16 (round to nearest even) before the f32 sum,
// as the TPU kernel does on its MXU path; without that rounding near-tie
// splits differ from the reference. Bins outside [0, B) are dropped (the
// mode="drop" scatter of the reference's XLA path); unmasked they would
// index outside shared memory. range_histogram sums only rows
// [start, start+length), read from the device int32 pair `info`, so the
// caller needs no host sync to launch it.
//
// level_histogram computes one such histogram per slot (leaf) in one pass
// over slot-partitioned rows: rows come in chunks of `chunk` rows, and chunk
// c belongs to the slot s = #{i >= 1 : starts[i] <= c}, read from the device
// table `starts` (slots,) int32, non-decreasing (a slot whose start is the
// total chunk count owns none). out is (slots, FP, B, 3), zeroed by the
// caller, so a slot that owns no rows reads zero. Padding rows carry
// g = h = m = 0 and add nothing.
//
// Bound on the H100 (3.35 TB/s, 80 GB HBM3): memory. One pass must read bT
// (FP*n*4 bytes as int32) and g/h/m (12*n bytes); the output is written
// once. At FP = 32, n = 2,000,000 that is 280 MB, 0.084 ms; a range of
// n/2 rows, 0.042 ms.
//
// Design: the shared-memory privatised histogram of arXiv:1706.08359. Each
// block owns FB = 8 features and keeps an (FB, B, 3) f32 histogram in
// shared memory (24 KB at B = 256, about eight blocks per SM); a warp takes
// 32 rows (one per lane) at a time, rounds their g/h/m once for its FB
// features, and adds each feature's bins with shared atomicAdd; the block
// then adds its non-zero slots into `out` with global atomicAdd (native
// float reductions in L2). Both kernels share the accumulate routine
// `warp_accumulate`. On this card a shared float atomicAdd compiles to a
// compare-and-swap loop (ATOMS.CAST.SPIN in the SASS), so lanes of a warp
// that add to one address retry one after another; in a fit,
// `transpose_bins` leaves the padded features with every row in bin 0, and
// the first version of the leaf-wise kernels serialised 32 adds there. The
// routine:
// * skips rows whose three rounded values are all zero (out of bag,
//   padding): they add nothing to a sum that starts at +0;
// * where every adding lane of the warp falls in one bin (a padded feature,
//   a constant column), sums the warp's values with shuffles and lets one
//   lane add them.
// Variants measured slower on the H100 and not kept: PERF.md §6.
// range_histogram: the grid depends on the card and n only; each block reads
// `info` and takes a contiguous span of max(length / blocks, 2048) rows, so
// a block whose span is empty returns before it zeroes or flushes anything,
// and a small child costs a few blocks, not the whole grid.
// level_histogram: each block owns a fixed run of chunks, keeps the slot
// table in shared memory, and flushes its histogram to out[slot] whenever
// the owning slot changes and at its end; the TPU kernel walks chunks in
// order and zero-initialises a slot's block on its first chunk, which
// blocks that run in any order cannot do. Its bound is one full
// histogram's plus the (slots, FP, B, 3) output written once.
// Bins stay int32 (shared with the grower); uint8 bins would cut the bytes
// read by 4x and are a later step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMinRows = 2048;  // least rows per block of a range
constexpr int kFeatureBlock = 8;  // features per block
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ void add3(float* p, float g, float h, float m) {
  atomicAdd(p, g);
  atomicAdd(p + 1, h);
  atomicAdd(p + 2, m);
}

// The accumulate routine of both kernels. One warp adds its 32 rows (one
// per lane; `in` false for a lane without a row) of features f0 .. f0+FB-1
// into the shared (FB, B, 3) histogram `hist`; `col` is bT's row of
// feature f0. Every lane of the warp must call it.
__device__ __forceinline__ void warp_accumulate(
    float* hist, const int32_t* __restrict__ col, int64_t n, int64_t row,
    bool in, float gv, float hv, float mv, int FB, int B) {
  // a row of zeros (out of bag, padding) adds nothing to a sum that starts
  // at +0
  const bool live = in && (gv != 0.f || hv != 0.f || mv != 0.f);
  if (!__any_sync(kFull, live)) return;
  const int lane = threadIdx.x & 31;
  for (int j = 0; j < FB; ++j) {
    const int b = live ? col[(int64_t)j * n + row] : -1;
    const bool ok = live && (unsigned)b < (unsigned)B;
    const unsigned adds = __ballot_sync(kFull, ok);
    if (adds == 0) continue;  // the same for every lane
    float* hj = hist + j * B * 3;
    const int first = __ffs(adds) - 1;
    const int b0 = __shfl_sync(kFull, b, first);
    if (__all_sync(kFull, !ok || b == b0)) {
      // every adding lane in one bin (a padded feature, a constant
      // column): one lane adds the warp's sums
      const float sg = warp_sum(ok ? gv : 0.f);
      const float sh = warp_sum(ok ? hv : 0.f);
      const float sm = warp_sum(ok ? mv : 0.f);
      if (lane == first) add3(hj + b0 * 3, sg, sh, sm);
      continue;
    }
    if (ok) add3(hj + b * 3, gv, hv, mv);
  }
}

// Adds the block's shared histogram of `size` floats into dst and zeroes
// it. Every thread of the block must call it (it synchronises).
__device__ void flush_shared(float* sh, float* dst, int size) {
  __syncthreads();
  for (int i = threadIdx.x; i < size; i += blockDim.x) {
    const float v = sh[i];
    sh[i] = 0.f;
    if (v != 0.f) atomicAdd(dst + i, v);
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
hist_kernel(const int32_t* __restrict__ bT, const float* __restrict__ g,
            const float* __restrict__ h, const float* __restrict__ m,
            const int32_t* __restrict__ info, float* __restrict__ out,
            int64_t n, int B, int FB) {
  extern __shared__ __align__(16) float sh[];
  int64_t start = 0, length = n;
  if (info != nullptr) {
    start = info[0];
    length = info[1];
    if (start < 0) start = 0;
    if (start > n) start = n;
    if (length < 0) length = 0;
    if (length > n - start) length = n - start;
  }
  // this block's span of the range; an empty one returns before any work
  int64_t span = (length + gridDim.x - 1) / gridDim.x;
  if (span < kMinRows) span = kMinRows;
  const int64_t s0 = (int64_t)blockIdx.x * span;
  if (s0 >= length) return;  // the same for every thread of the block
  const int64_t s1 = (s0 + span < length ? s0 + span : length) + start;

  const int size = FB * B * 3;
  for (int i = threadIdx.x; i < size; i += blockDim.x) sh[i] = 0.f;
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const int f0 = blockIdx.y * FB;
  const int32_t* col = bT + (int64_t)f0 * n;
  // warps walk whole 32-row groups, so every lane reaches the warp votes
  for (int64_t base = start + s0 + 32 * warp; base < s1; base += kThreads) {
    const int64_t row = base + (threadIdx.x & 31);
    const bool in = row < s1;
    float gv = 0.f, hv = 0.f, mv = 0.f;
    if (in) {
      gv = bf16_round(g[row]);
      hv = bf16_round(h[row]);
      mv = bf16_round(m[row]);
    }
    warp_accumulate(sh, col, n, row, in, gv, hv, mv, FB, B);
  }
  flush_shared(sh, out + (int64_t)f0 * B * 3, size);
}

__global__ void __launch_bounds__(kThreads)
level_hist_kernel(const int32_t* __restrict__ bT, const float* __restrict__ g,
                  const float* __restrict__ h, const float* __restrict__ m,
                  const int32_t* __restrict__ starts, float* __restrict__ out,
                  int64_t n, int FP, int B, int FB, int slots, int chunk,
                  int64_t chunks_per_block) {
  extern __shared__ __align__(16) float sh[];
  const int size = FB * B * 3;
  int* st = reinterpret_cast<int*>(sh + size);
  const int64_t total = (n + chunk - 1) / chunk;
  const int64_t c0 = (int64_t)blockIdx.x * chunks_per_block;
  int64_t c1 = c0 + chunks_per_block;
  if (c1 > total) c1 = total;
  if (c0 >= c1) return;  // the same for every thread of the block
  for (int i = threadIdx.x; i < size; i += blockDim.x) sh[i] = 0.f;
  for (int i = threadIdx.x; i < slots; i += blockDim.x) st[i] = starts[i];
  __syncthreads();

  const int f0 = blockIdx.y * FB;
  const int32_t* col = bT + (int64_t)f0 * n;
  const int64_t slot_stride = (int64_t)FP * B * 3;
  float* dst = out + (int64_t)f0 * B * 3;
  const int warp = threadIdx.x >> 5;
  int slot = 0;
  while (slot + 1 < slots && st[slot + 1] <= c0) ++slot;
  for (int64_t c = c0; c < c1; ++c) {
    int s = slot;  // every thread computes the same s from shared memory
    while (s + 1 < slots && st[s + 1] <= c) ++s;
    if (s != slot) {
      flush_shared(sh, dst + slot * slot_stride, size);
      slot = s;
    }
    int64_t r1 = (c + 1) * chunk;
    if (r1 > n) r1 = n;
    for (int64_t base = c * chunk + 32 * warp; base < r1; base += kThreads) {
      const int64_t row = base + (threadIdx.x & 31);
      const bool in = row < r1;
      float gv = 0.f, hv = 0.f, mv = 0.f;
      if (in) {
        gv = bf16_round(g[row]);
        hv = bf16_round(h[row]);
        mv = bf16_round(m[row]);
      }
      warp_accumulate(sh, col, n, row, in, gv, hv, mv, FB, B);
    }
  }
  flush_shared(sh, dst + slot * slot_stride, size);
}

// Features per block: the largest of kFeatureBlock, ..., 2, 1 that divides
// FP and keeps the shared histogram (plus `extra` bytes) within the 48 KB a
// block gets without opting in.
int feature_block(int FP, int B, int64_t extra) {
  for (int fb = kFeatureBlock; fb > 1; fb /= 2) {
    if (FP % fb == 0 && (int64_t)fb * B * 12 + extra <= 48 * 1024)
      return fb;
  }
  return 1;
}

cudaError_t sm_count(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
}

int launch(const int32_t* bT, const float* g, const float* h, const float* m,
           const int32_t* info, float* out, int64_t n, int FP, int B,
           cudaStream_t stream) {
  if (n <= 0 || FP <= 0) return 0;
  const int FB = feature_block(FP, B, 0);
  const size_t smem = (size_t)FB * B * 3 * sizeof(float);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return (int)err;
  const int fblocks = FP / FB;
  // about eight resident blocks per SM in all, shared among feature
  // blocks, and no more than n rows need
  int64_t want = ((int64_t)sms * 8 + fblocks - 1) / fblocks;
  int64_t need = (n + kMinRows - 1) / kMinRows;
  int gx = (int)(need < want ? need : want);
  if (gx < 1) gx = 1;
  dim3 grid(gx, fblocks);
  hist_kernel<<<grid, kThreads, smem, stream>>>(bT, g, h, m, info, out, n, B,
                                                FB);
  return (int)cudaGetLastError();
}

int launch_level(const int32_t* bT, const float* g, const float* h,
                 const float* m, const int32_t* starts, float* out, int64_t n,
                 int FP, int B, int slots, int chunk, cudaStream_t stream) {
  if (n <= 0 || FP <= 0) return 0;
  if (slots <= 0 || chunk <= 0) return (int)cudaErrorInvalidValue;
  const int64_t table = (int64_t)slots * sizeof(int32_t);
  const int FB = feature_block(FP, B, table);
  const size_t smem = (size_t)FB * B * 3 * sizeof(float) + table;
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return (int)err;
  const int fblocks = FP / FB;
  // as launch(): about eight resident blocks per SM, each a run of chunks
  const int64_t total = (n + chunk - 1) / chunk;
  int64_t want = ((int64_t)sms * 8 + fblocks - 1) / fblocks;
  if (want > total) want = total;
  const int64_t per_block = (total + want - 1) / want;
  const int gx = (int)((total + per_block - 1) / per_block);
  dim3 grid(gx, fblocks);
  level_hist_kernel<<<grid, kThreads, smem, stream>>>(
      bT, g, h, m, starts, out, n, FP, B, FB, slots, chunk, per_block);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Histogram of all n rows. Returns a cudaError_t as int (0 = launched).
int child_histogram(const void* bT, const void* g, const void* h,
                    const void* m, void* out, int64_t n, int FP, int B,
                    void* stream) {
  return launch((const int32_t*)bT, (const float*)g, (const float*)h,
                (const float*)m, nullptr, (float*)out, n, FP, B,
                (cudaStream_t)stream);
}

// Histogram of rows [info[0], info[0] + info[1]) of the full (FP, n) arrays;
// `info` is a device int32 pair. Returns a cudaError_t as int.
int range_histogram(const void* bT, const void* g, const void* h,
                    const void* m, const void* info, void* out, int64_t n,
                    int FP, int B, void* stream) {
  return launch((const int32_t*)bT, (const float*)g, (const float*)h,
                (const float*)m, (const int32_t*)info, (float*)out, n, FP, B,
                (cudaStream_t)stream);
}

// Histograms of every slot of slot-partitioned rows in one pass; `starts` is
// the device int32 table of each slot's first chunk, `out` (slots, FP, B, 3)
// is zeroed by the caller. Returns a cudaError_t as int.
int level_histogram(const void* bT, const void* g, const void* h,
                    const void* m, const void* starts, void* out, int64_t n,
                    int FP, int B, int slots, int chunk, void* stream) {
  return launch_level((const int32_t*)bT, (const float*)g, (const float*)h,
                      (const float*)m, (const int32_t*)starts, (float*)out, n,
                      FP, B, slots, chunk, (cudaStream_t)stream);
}

}  // extern "C"
