// GBDT histogram kernels for Hopper (sm_90a), bound to PyTorch with ctypes.
//
// Three entry points, one translation unit:
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
// Design: the shared-memory privatised histogram of arXiv:1706.08359. Each
// block owns FB features; it keeps an (FB, B, 3) f32 histogram in shared
// memory (FB = 8, B = 256: 24 KB), strides over rows adding with shared
// atomicAdd, then flushes its non-zero slots into `out` with global
// atomicAdd. Blocks along x split the rows, blocks along y split the features.
// The grid is a fixed function of the card and the array size, never of the
// range length, so the range kernel needs nothing from the host.
//
// Bound on the H100 (3.35 TB/s, 80 GB HBM3): memory. One pass must read bT
// (FP*n*4 bytes as int32) and g/h/m (12*n bytes); the (FP, B, 3) output is
// negligible. At FP = 32, n = 2,000,000 that is 280 MB, 0.084 ms.
//
// level_histogram computes one such histogram per slot (leaf) in one pass
// over slot-partitioned rows: rows come in chunks of `chunk` rows, and chunk
// c belongs to the slot s = #{i >= 1 : starts[i] <= c}, read from the device
// table `starts` (slots,) int32, non-decreasing (a slot whose start is the
// total chunk count owns none). out is (slots, FP, B, 3), zeroed by the
// caller, so a slot that owns no rows reads zero. Padding rows carry
// g = h = m = 0 and add nothing. Design: the same privatised histogram. The
// TPU kernel walks chunks in order and zero-initialises a slot's block on its
// first chunk; here blocks run in any order, so each block owns a fixed span
// of consecutive chunks, keeps the slot table in shared memory, and flushes
// its shared histogram to out[slot] with global atomicAdd whenever the owning
// slot changes and at its end. Two cases would make a warp's 32 shared
// atomics on one address run one after another: padding rows (all in bin 0)
// and padded features (every row in bin 0). Rows whose three rounded values
// are all zero add nothing to a sum that starts at +0 and are skipped, and
// where every lane of a warp that adds falls in one bin, one lane adds the
// warp's sums. The grid depends on the card and the row count only, never on
// the slot layout, so a launch needs no host sync. Its bound is the same as
// one full histogram's: bT and g/h/m read once, plus the (slots, FP, B, 3)
// output written once.
//
// This first version is plain and correct, not yet designed for speed: each
// feature block re-reads g/h/m, all threads of a block contend on one shared
// copy of the histogram, and bins are read as int32. Warp-private
// sub-histograms, uint8 vectorised bin loads and one pass over g/h/m for all
// features are the known next steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

constexpr unsigned kFullWarp = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFullWarp, v, o);
  return v;
}

__global__ void hist_kernel(const int32_t* __restrict__ bT,
                            const float* __restrict__ g,
                            const float* __restrict__ h,
                            const float* __restrict__ m,
                            const int32_t* __restrict__ info,
                            float* __restrict__ out,
                            int64_t n, int B, int FB) {
  extern __shared__ float sh[];
  const int slots = FB * B * 3;
  for (int i = threadIdx.x; i < slots; i += blockDim.x) sh[i] = 0.f;
  __syncthreads();

  int64_t start = 0, length = n;
  if (info != nullptr) {
    start = info[0];
    length = info[1];
    if (start < 0) start = 0;
    if (start > n) start = n;
    if (length < 0) length = 0;
    if (length > n - start) length = n - start;
  }
  const int f0 = blockIdx.y * FB;
  const int32_t* rows = bT + (int64_t)f0 * n;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; r < length;
       r += stride) {
    const int64_t row = start + r;
    const float gv = bf16_round(g[row]);
    const float hv = bf16_round(h[row]);
    const float mv = bf16_round(m[row]);
    for (int j = 0; j < FB; ++j) {
      const int b = rows[(int64_t)j * n + row];
      if ((unsigned)b < (unsigned)B) {
        float* s = sh + (j * B + b) * 3;
        atomicAdd(s, gv);
        atomicAdd(s + 1, hv);
        atomicAdd(s + 2, mv);
      }
    }
  }
  __syncthreads();

  float* dst = out + (int64_t)f0 * B * 3;
  for (int i = threadIdx.x; i < slots; i += blockDim.x) {
    const float v = sh[i];
    if (v != 0.f) atomicAdd(dst + i, v);
  }
}

// Adds the block's shared histogram into dst and zeroes it. Every thread of
// the block must call it (it synchronises the block).
__device__ void flush_shared(float* sh, float* dst, int size) {
  __syncthreads();
  for (int i = threadIdx.x; i < size; i += blockDim.x) {
    const float v = sh[i];
    if (v != 0.f) {
      atomicAdd(dst + i, v);
      sh[i] = 0.f;
    }
  }
  __syncthreads();
}

__global__ void level_hist_kernel(const int32_t* __restrict__ bT,
                                  const float* __restrict__ g,
                                  const float* __restrict__ h,
                                  const float* __restrict__ m,
                                  const int32_t* __restrict__ starts,
                                  float* __restrict__ out, int64_t n, int FP,
                                  int B, int FB, int slots, int chunk,
                                  int64_t chunks_per_block) {
  extern __shared__ float sh[];
  const int hsize = FB * B * 3;
  int* st = reinterpret_cast<int*>(sh + hsize);
  for (int i = threadIdx.x; i < hsize; i += blockDim.x) sh[i] = 0.f;
  for (int i = threadIdx.x; i < slots; i += blockDim.x) st[i] = starts[i];
  __syncthreads();

  const int64_t total = (n + chunk - 1) / chunk;
  const int64_t c0 = (int64_t)blockIdx.x * chunks_per_block;
  int64_t c1 = c0 + chunks_per_block;
  if (c1 > total) c1 = total;
  if (c0 >= c1) return;  // the same for every thread of the block
  const int f0 = blockIdx.y * FB;
  const int32_t* rows = bT + (int64_t)f0 * n;
  const int64_t slot_stride = (int64_t)FP * B * 3;
  float* dst = out + (int64_t)f0 * B * 3;

  const int lane = threadIdx.x & 31;
  int slot = 0;
  while (slot + 1 < slots && st[slot + 1] <= c0) ++slot;
  for (int64_t c = c0; c < c1; ++c) {
    int s = slot;  // every thread computes the same s from shared memory
    while (s + 1 < slots && st[s + 1] <= c) ++s;
    if (s != slot) {
      flush_shared(sh, dst + slot * slot_stride, hsize);
      slot = s;
    }
    int64_t r1 = (c + 1) * chunk;
    if (r1 > n) r1 = n;
    // warps walk whole 32-row groups, so every lane reaches the warp votes
    for (int64_t base = c * chunk + (threadIdx.x & ~31); base < r1;
         base += blockDim.x) {
      const int64_t row = base + lane;
      const bool in = row < r1;
      float gv = 0.f, hv = 0.f, mv = 0.f;
      if (in) {
        gv = bf16_round(g[row]);
        hv = bf16_round(h[row]);
        mv = bf16_round(m[row]);
      }
      // a row of zeros (padding) adds nothing to a sum that starts at +0
      const bool live = gv != 0.f || hv != 0.f || mv != 0.f;
      for (int j = 0; j < FB; ++j) {
        const int b = live ? rows[(int64_t)j * n + row] : -1;
        const bool ok = live && (unsigned)b < (unsigned)B;
        const unsigned adds = __ballot_sync(kFullWarp, ok);
        if (adds == 0) continue;  // the same for every lane
        const int first = __ffs(adds) - 1;
        const int b0 = __shfl_sync(kFullWarp, b, first);
        if (__all_sync(kFullWarp, !ok || b == b0)) {
          // every adding lane in one bin (a padded feature, a constant
          // column): one lane adds the warp's sums, not each lane in turn
          const float sg = warp_sum(ok ? gv : 0.f);
          const float shv = warp_sum(ok ? hv : 0.f);
          const float sm = warp_sum(ok ? mv : 0.f);
          if (lane == first) {
            float* p = sh + (j * B + b0) * 3;
            atomicAdd(p, sg);
            atomicAdd(p + 1, shv);
            atomicAdd(p + 2, sm);
          }
        } else if (ok) {
          float* p = sh + (j * B + b) * 3;
          atomicAdd(p, gv);
          atomicAdd(p + 1, hv);
          atomicAdd(p + 2, mv);
        }
      }
    }
  }
  flush_shared(sh, dst + slot * slot_stride, hsize);
}

// Features per block: the largest of 8, 4, 2, 1 that divides FP and keeps
// the shared histogram (plus `extra` bytes) within the 48 KB a block gets
// without opting in.
int feature_block(int FP, int B, int64_t extra = 0) {
  for (int fb = 8; fb > 1; fb /= 2) {
    if (FP % fb == 0 && (int64_t)fb * B * 3 * 4 + extra <= 48 * 1024)
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
  const int FB = feature_block(FP, B);
  const size_t smem = (size_t)FB * B * 3 * sizeof(float);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return (int)err;
  const int fblocks = FP / FB;
  // about eight resident blocks per SM in all, shared among feature blocks
  int64_t want = ((int64_t)sms * 8 + fblocks - 1) / fblocks;
  int64_t need = (n + kThreads - 1) / kThreads;
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
