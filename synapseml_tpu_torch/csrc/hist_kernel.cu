// GBDT histogram kernels for Hopper (sm_90a), bound to PyTorch with ctypes.
//
// Two entry points, one translation unit:
//
//   child_histogram  replaces synapseml_tpu/ops/hist_kernel.py `_kernel` +
//                    `_packed_accumulate` (pl.pallas_call in `_hist_pallas`).
//   range_histogram  replaces synapseml_tpu/ops/hist_kernel.py `_range_kernel`
//                    (pl.pallas_call in `_hist_pallas_range`).
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

// Features per block: the largest of 8, 4, 2, 1 that divides FP and keeps
// the shared histogram within the 48 KB a block gets without opting in.
int feature_block(int FP, int B) {
  for (int fb = 8; fb > 1; fb /= 2) {
    if (FP % fb == 0 && (int64_t)fb * B * 3 * 4 <= 48 * 1024) return fb;
  }
  return 1;
}

int launch(const int32_t* bT, const float* g, const float* h, const float* m,
           const int32_t* info, float* out, int64_t n, int FP, int B,
           cudaStream_t stream) {
  if (n <= 0 || FP <= 0) return 0;
  const int FB = feature_block(FP, B);
  const size_t smem = (size_t)FB * B * 3 * sizeof(float);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
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

}  // extern "C"
