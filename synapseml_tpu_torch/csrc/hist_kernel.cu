// GBDT histogram kernels for Hopper (sm_90a), bound to PyTorch with ctypes.
//
// Three entry points, one translation unit:
//
//   child_histogram  replaces synapseml_tpu/ops/hist_kernel.py `_kernel` +
//                    `_packed_accumulate` (pl.pallas_call in `_hist_pallas`).
//   range_histogram  replaces synapseml_tpu/ops/hist_kernel.py `_range_kernel`
//                    (pl.pallas_call in `_hist_pallas_range`).
//   level_histogram  replaces synapseml_tpu/ops/hist_kernel.py:294
//                    `_level_kernel` (pl.pallas_call in `_hist_pallas_level`).
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
// child_histogram and range_histogram: the shared-memory privatised
// histogram of arXiv:1706.08359. Each block owns FB = 8 features and keeps
// an (FB, B, 3) f32 histogram in shared memory (24 KB at B = 256, about
// eight blocks per SM); a warp takes 32 rows (one per lane) at a time,
// rounds their g/h/m once for its FB features, and adds each feature's bins
// with shared atomicAdd; the block then adds its non-zero slots into `out`
// with global atomicAdd (native float reductions in L2). Both share the
// accumulate routine `warp_accumulate`. On this card a shared float
// atomicAdd compiles to a compare-and-swap loop (ATOMS.CAST.SPIN in the
// SASS), so lanes of a warp that add to one address retry one after
// another; in a fit, `transpose_bins` leaves the padded features with every
// row in bin 0, and the first version of these kernels serialised 32 adds
// there. The routine:
// * skips rows whose three rounded values are all zero (out of bag,
//   padding): they add nothing to a sum that starts at +0;
// * where every adding lane of the warp falls in one bin (a padded feature,
//   a constant column), sums the warp's values with shuffles and lets one
//   lane add them.
// Variants measured slower on the H100 and not kept: PERF.md §6.
// Large bin spaces: a block keeps fewer features when FB * B * 12 bytes would
// pass the 48 KB a block gets without opting in, down to one feature, whose
// (B, 3) histogram takes the opt-in above 48 KB: 192 KB at B = 16384
// (kWindowBins; the H100 gives a block up to 227 KB). A larger B runs as
// B / 16384 bin windows on the grid's z axis, one launch: window w keeps its
// own (16384, 3) shared histogram of bins [16384 w, 16384 (w + 1)), skips
// the rows whose bin falls outside it, and adds its sums at offset 16384 w
// of out's (B, 3) rows. Every bin is counted in exactly one window, with
// the same sums as one pass; each window reads the rows again (B / 16384
// times the bytes).
// range_histogram: the grid depends on the card and n only; each block reads
// `info` and takes a contiguous span of max(length / blocks, 2048) rows, so
// a block whose span is empty returns before it zeroes or flushes anything,
// and a small child costs a few blocks, not the whole grid.
//
// level_histogram: one-hot products on the tensor cores, no shared-memory
// float atomics. Every chunk belongs to one slot, so a warp sums a whole run
// of rows in registers and writes once per slot change; the TPU kernel does
// the same sum on its MXU as a one-hot matrix product. Per feature and 16
// rows (the K of one mma.sync.m16n8k16, bf16 in, float32 out):
//   C[hi, (q, lo)] += A[hi, k] * Bop[k, (q, lo)],   hi = b >> 3, lo = b & 7,
//   A = one-hot(hi) (exactly 0 or 1),  Bop[k, (q, lo)] = v_q(k) [lo(k) == lo]
// with v_q the row's bf16 g, h or m: every product is exact, only the sums
// round. M = B / 8 (two m16 tiles per 256 bins) and N = 24 (one n8 tile per
// quantity): 6 mma per 16 rows per 256 bins. Its floors at FP = 32,
// CAP = 2,064,384 rows, B = 256, 31 slots: 0.087 ms of bytes (int32 bins and
// g/h/m read once, the output written once) and 0.103 ms of tensor work
// (CAP * FP * B * 6 flops at 989 TFLOP/s of bf16), which mma.sync, the
// pre-Hopper instruction, does not reach (PERF.md §6).
// * K order: within 16 rows the order of the k slots does not change a sum,
//   so lane t = lane & 3's slots {2t, 2t+1, 2t+8, 2t+9} are rows 4t .. 4t+3:
//   one 16-byte shared load gives a lane the codes of its four rows, one more
//   its g and h pairs, one 8-byte load its m pair, and no shuffle is needed.
//   A and the column masks are compares (set.eq.bf16x2) of the codes against
//   the lane's row and column; Bop is the value pairs times the 0/1 mask
//   (exact for finite values).
// * Non-finite values: 0 * NaN and 0 * Inf are NaN, so in the products a
//   non-finite g, h or m (or one that overflows bf16) would reach every bin
//   of its feature and slot. The staging pass flags such a stage, and the
//   block adds that stage's rows into their own bins with global atomics,
//   which keeps the plain version's function.
// * Staging: a block owns a run of 256-row stages and 16 features (8 warps,
//   each two units of (feature, 256 bins)); each stage's bins and g/h/m come
//   in by cp.async, kStages deep, and the block turns them once into codes
//   (a bin clamped to B, then lo and hi under the bf16 exponent bit 0x4000:
//   finite values, equal exactly where the bits are; B's hi matches no row
//   of A, so a bin outside [0, B) adds nothing) and bf16 pairs. A stage
//   whose values are all zero (padding) is skipped.
// * Precision, the T reset: the tensor core aligns the addends of a sum to
//   the largest and truncates, so a long sum kept in its accumulator drifts
//   toward zero (PERF.md §6, flash). Each run of at most kLevelT = 128
//   k-groups (one 2048-row chunk) starts from a zeroed accumulator and is
//   then added into float32 sums in shared memory, rounding to nearest.
//   With T = 128 chip_smoke.py's fit-shaped level check reads about 5 units
//   of 2^-24 sum |x| on an H100 (it allows 100); shorter runs read no
//   closer on the card and fold more often. Counts stay exact (integers
//   below 2^24 add exactly).
// * Output: on a change of slot, and at its end, a warp adds its sums into
//   out[slot] with global float atomics (float2 where two are adjacent).
// * One wave: about two resident blocks per SM, each a run of stages; a
//   block's first stage and its flushes are not hidden, so more and shorter
//   blocks measured slower.
// * Bin windows: the codes hold hi below 512, so one pass takes up to
//   kMaxLevelBins = 2048 bins. A larger B (any power of two whose B / 2048
//   windows fit the grid's z limit) runs as B / 2048 windows on the grid's
//   z axis, one launch: window w stages bin - 2048 w,
//   which the clamp sends to "outside" unless it falls in [0, 2048), and
//   writes its bins at offset 2048 w of out's (B, 3) rows. Every bin is
//   counted in exactly one window, with the same sums as one pass; each
//   window reads the rows again (B / 2048 times the bytes).
// Bins stay int32 (shared with the grower); uint8 bins would cut the bytes
// read by 4x and are a later step, and wgmma (the masked values staged in
// shared memory) the step toward the full tensor rate.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMinRows = 2048;  // least rows per block of a range
constexpr int kFeatureBlock = 8;  // features per block
constexpr int kWindowBins = 16384;  // bins per window of hist_kernel
constexpr int kMaxGridZ = 65535;    // the card's limit on gridDim.z
constexpr int kSmemDefault = 48 * 1024;  // shared bytes without the opt-in
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
// into the shared (FB, B, 3) histogram `hist` of bins [off, off + B); `col`
// is bT's row of feature f0. Every lane of the warp must call it.
__device__ __forceinline__ void warp_accumulate(
    float* hist, const int32_t* __restrict__ col, int64_t n, int64_t row,
    bool in, float gv, float hv, float mv, int FB, int B, int off) {
  // a row of zeros (out of bag, padding) adds nothing to a sum that starts
  // at +0
  const bool live = in && (gv != 0.f || hv != 0.f || mv != 0.f);
  if (!__any_sync(kFull, live)) return;
  const int lane = threadIdx.x & 31;
  for (int j = 0; j < FB; ++j) {
    // a bin outside the window wraps to a large unsigned value
    const int b = live ? col[(int64_t)j * n + row] - off : -1;
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

// Adds the block's shared (FB, B, 3) histogram into dst, whose features are
// OB * 3 floats apart, and zeroes it. Every thread of the block must call it
// (it synchronises).
__device__ void flush_shared(float* sh, float* dst, int FB, int B, int OB) {
  __syncthreads();
  const int size = FB * B * 3;
  for (int i = threadIdx.x; i < size; i += blockDim.x) {
    const float v = sh[i];
    sh[i] = 0.f;
    const int j = i / (B * 3);
    if (v != 0.f) atomicAdd(dst + (int64_t)j * OB * 3 + (i - j * B * 3), v);
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
hist_kernel(const int32_t* __restrict__ bT, const float* __restrict__ g,
            const float* __restrict__ h, const float* __restrict__ m,
            const int32_t* __restrict__ info, float* __restrict__ out,
            int64_t n, int B, int OB, int FB) {
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
  const int off = blockIdx.z * B;  // the window's first bin
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
    warp_accumulate(sh, col, n, row, in, gv, hv, mv, FB, B, off);
  }
  flush_shared(sh, out + ((int64_t)f0 * OB + off) * 3, FB, B, OB);
}

// Features per block: the largest of kFeatureBlock, ..., 2, 1 that divides
// FP and keeps the shared histogram within the 48 KB a block gets without
// opting in; 1 (opted in above 48 KB) where none does.
int feature_block(int FP, int B) {
  for (int fb = kFeatureBlock; fb > 1; fb /= 2) {
    if (FP % fb == 0 && (int64_t)fb * B * 12 <= kSmemDefault) return fb;
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
  // bin windows of at most kWindowBins (a larger B is a multiple of it)
  const int wb = B < kWindowBins ? B : kWindowBins;
  const int windows = B / wb;
  if (B < 1 || windows * wb != B || windows > kMaxGridZ)
    return (int)cudaErrorInvalidValue;
  const int FB = feature_block(FP, wb);
  const size_t smem = (size_t)FB * wb * 3 * sizeof(float);
  cudaError_t err = cudaSuccess;
  if (smem > (size_t)kSmemDefault) {
    err = cudaFuncSetAttribute(
        hist_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  int sms = 0;
  err = sm_count(&sms);
  if (err != cudaSuccess) return (int)err;
  const int fblocks = FP / FB;
  // about eight resident blocks per SM in all, shared among feature
  // blocks and windows, and no more than n rows need
  const int64_t yz = (int64_t)fblocks * windows;
  int64_t want = ((int64_t)sms * 8 + yz - 1) / yz;
  int64_t need = (n + kMinRows - 1) / kMinRows;
  int gx = (int)(need < want ? need : want);
  if (gx < 1) gx = 1;
  dim3 grid(gx, fblocks, windows);
  hist_kernel<<<grid, kThreads, smem, stream>>>(bT, g, h, m, info, out, n, wb,
                                                B, FB);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// level_histogram: one-hot products on the tensor cores (see the note above)
// ---------------------------------------------------------------------------

constexpr int kLevelT = 128;                  // k-groups per accumulator run
constexpr int kStageGroups = 16;              // k-groups of one staged tile
constexpr int kStageRows = 16 * kStageGroups;
constexpr int kStages = 3;                    // tiles in flight per block
constexpr int kUnits = 2;                     // (feature, 256 bins) per warp
constexpr int kBlockUnits = kWarps * kUnits;  // per block
constexpr int kMaxLevelBins = 2048;           // per window: hi below 512
constexpr int kLevelBlocksPerSM = 2;          // resident, by registers
constexpr uint32_t kTwo = 0x40004000u;        // bf16x2 (2, 2)
constexpr uint32_t kPair = 0x00010001u;       // one in each 16-bit half

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copies `Bytes` (16 or 4) from src to shared dst, or zero-fills dst when
// `in` is false (src is then not read).
template <int Bytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool in) {
  if constexpr (Bytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 ::"r"(smem_addr(dst)), "l"(src), "r"(in ? 16 : 0));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 ::"r"(smem_addr(dst)), "l"(src), "r"(in ? 4 : 0));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// true where a half of w is a bf16 infinity or NaN
__device__ __forceinline__ bool non_finite(uint32_t w) {
  constexpr uint32_t e = 0x7f807f80u;  // exponent bits of each half
  return __vcmpeq2(w & e, e) != 0u;
}

// the float value of the bf16 in bits [sh, sh + 16) of w
__device__ __forceinline__ float bf16_at(uint32_t w, int sh) {
  return __uint_as_float(((w >> sh) & 0xffffu) << 16);
}

// bf16 1.0 in each half of a that equals the same half of b, else 0
__device__ __forceinline__ uint32_t eq_one(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("set.eq.bf16x2.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// v * one, half by half (one is bf16 1.0 or 0): exact, on the FMA pipe, which
// the loop's integer work leaves idle
__device__ __forceinline__ uint32_t bmul(uint32_t v, uint32_t one) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;"
      : "=r"(d)
      : "r"(v), "r"(one), "r"(0x80008000u));
  return d;
}

// (bf16(x), bf16(y)) rounded to nearest even, x in the low half
__device__ __forceinline__ uint32_t pack_bf16(float x, float y) {
  __nv_bfloat162 v = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<uint32_t*>(&v);
}

// c += a (16 x 16, bf16) * [b0; b1] (16 x 8, bf16), float32 accumulator
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Grid (runs of stages, unit blocks, bin windows). A unit is (feature,
// 256-bin block of the window); block y owns units [kBlockUnits * y,
// kBlockUnits * (y + 1)), that is FBf = kBlockUnits / MT features; warp w
// owns units kUnits * w + u. B is the window's bins, OB out's (B * windows);
// window z takes bins [z * B, (z + 1) * B). kVec is 4 where bT's rows and
// g/h/m allow 16-byte copies, else 1.
template <int kVec>
__global__ void __launch_bounds__(kThreads, kLevelBlocksPerSM)
level_mma_kernel(const int32_t* __restrict__ bT, const float* __restrict__ g,
                 const float* __restrict__ h, const float* __restrict__ m,
                 const int32_t* __restrict__ starts, float* __restrict__ out,
                 int64_t n, int FP, int B, int OB, int slots, int chunk,
                 int64_t stages_per_block) {
  extern __shared__ __align__(16) int32_t lsh[];
  const int MT = B >> 8;
  const uint32_t off = (uint32_t)blockIdx.z * (uint32_t)B;  // window's bin 0
  const int FBf = kBlockUnits / MT;
  const int lines = FBf + 3;  // FBf bin rows, then g, h, m
  // then each warp's float32 sums, kUnits * 6 float4 per lane, the slots
  // and a flag per parity of stage: the stage holds a non-finite value
  float4* sums = reinterpret_cast<float4*>(lsh + kStages * lines * kStageRows);
  int32_t* st = reinterpret_cast<int32_t*>(sums + kBlockUnits * 6 * 32);
  int32_t* bad = st + slots;

  const int64_t total = (n + kStageRows - 1) / kStageRows;
  const int64_t s0 = (int64_t)blockIdx.x * stages_per_block;
  const int64_t s1 = s0 + stages_per_block < total ? s0 + stages_per_block
                                                   : total;
  if (s0 >= s1) return;  // the same for every thread of the block
  const int64_t r0 = s0 * kStageRows;
  const int nstages = (int)(s1 - s0);
  const int f_base = blockIdx.y * FBf;
  for (int i = threadIdx.x; i < slots; i += kThreads) st[i] = starts[i];
  if (threadIdx.x < 2) bad[threadIdx.x] = 0;

  // stage s holds rows r0 + s * kStageRows ...; it never crosses a chunk
  // (chunk % kStageRows == 0), and rows at or past n are zero-filled
  auto load_stage = [&](int s) {
    int32_t* buf = lsh + (s % kStages) * lines * kStageRows;
    const int64_t row0 = r0 + (int64_t)s * kStageRows;
    constexpr int pieces = kStageRows / kVec;
    for (int p = threadIdx.x; p < lines * pieces; p += kThreads) {
      const int line = p / pieces, r = (p % pieces) * kVec;
      const int64_t row = row0 + r;
      bool in = row < n;
      const void* src;
      if (line < FBf) {
        const int f = f_base + line;
        in = in && f < FP;
        src = bT + (in ? (int64_t)f * n + row : 0);
      } else {
        const float* v = line == FBf ? g : line == FBf + 1 ? h : m;
        src = v + (in ? row : 0);
      }
      cp_async<4 * kVec>(buf + line * kStageRows + r, src, in);
    }
  };
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nstages) load_stage(s);
    cp_async_commit();
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  int fl[kUnits], blk[kUnits];
  bool live[kUnits];
#pragma unroll
  for (int u = 0; u < kUnits; ++u) {
    const int unit = warp * kUnits + u;
    fl[u] = unit / MT;
    blk[u] = unit % MT;
    live[u] = f_base + fl[u] < FP;
  }
  const uint32_t lo0 = (0x4000u | gq) * kPair;  // B column gq is lo = gq
  // this lane's sums of unit u, n-tile j: tot[(u * 6 + j) * 32]
  float4* tot = sums + warp * kUnits * 6 * 32 + lane;
#pragma unroll
  for (int i = 0; i < kUnits * 6; ++i) tot[i * 32] = make_float4(0, 0, 0, 0);

  // adds the warp's sums into out[slot] (global float atomics: reductions
  // in L2) and zeroes them
  auto flush = [&](int slot) {
#pragma unroll
    for (int u = 0; u < kUnits; ++u) {
      float* dst =
          out + (((int64_t)slot * FP + f_base + fl[u]) * OB + off) * 3;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float v[3][4];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float4 t = tot[(u * 6 + 3 * i + c) * 32];
          tot[(u * 6 + 3 * i + c) * 32] = make_float4(0, 0, 0, 0);
          v[c][0] = t.x;
          v[c][1] = t.y;
          v[c][2] = t.z;
          v[c][3] = t.w;
        }
        if (!live[u]) continue;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int hi = 32 * blk[u] + 16 * i + gq + ((k & 2) ? 8 : 0);
          float* p = dst + (hi * 8 + 2 * tq + (k & 1)) * 3;
          if (k & 1) {
            if (v[0][k] != 0.f) atomicAdd(p, v[0][k]);
            if (v[1][k] != 0.f || v[2][k] != 0.f)
              atomicAdd(reinterpret_cast<float2*>(p + 1),
                        make_float2(v[1][k], v[2][k]));
          } else {
            if (v[0][k] != 0.f || v[1][k] != 0.f)
              atomicAdd(reinterpret_cast<float2*>(p),
                        make_float2(v[0][k], v[1][k]));
            if (v[2][k] != 0.f) atomicAdd(p + 2, v[2][k]);
          }
        }
      }
    }
  };

  // the tensor core's sums of the current run of at most kLevelT k-groups
  float acc[kUnits][6][4];
  int run = 0;
  // adds them into tot, rounding to nearest, and zeroes them
  auto fold = [&]() {
#pragma unroll
    for (int u = 0; u < kUnits; ++u)
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        float4 t = tot[(u * 6 + j) * 32];
        t.x += acc[u][j][0];
        t.y += acc[u][j][1];
        t.z += acc[u][j][2];
        t.w += acc[u][j][3];
        tot[(u * 6 + j) * 32] = t;
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[u][j][k] = 0.f;
      }
    run = 0;
  };
#pragma unroll
  for (int u = 0; u < kUnits; ++u)
#pragma unroll
    for (int j = 0; j < 6; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[u][j][k] = 0.f;

  int slot = -1;
  for (int s = 0; s < nstages; ++s) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage s is in; every warp is done with stage s - 1
    if (s + kStages - 1 < nstages) load_stage(s + kStages - 1);
    cp_async_commit();
    // clear stage s + 1's flag: stage s - 1, which shared it, read it before
    // this barrier, and stage s + 1 sets it after the next one
    if (threadIdx.x == 0) bad[(s + 1) & 1] = 0;

    // Stage s in place, once for the block: each 16 bytes of bins
    // (rows r .. r+3) become the codes (lo01, hi01, lo23, hi23): the bins
    // less the window's first (wrapping below it) clamped to B, lo = bits
    // 0-2 and hi = bits 3-11 under the exponent bit 0x4000, as bf16 pairs.
    // g, h and m become bf16 pairs (g01, g23, h01, h23) in g's line and
    // (m01, m23) in h's.
    uint32_t* buf =
        reinterpret_cast<uint32_t*>(lsh + (s % kStages) * lines * kStageRows);
    uint32_t* vals = buf + FBf * kStageRows;
    bool nz = false;
    for (int p = threadIdx.x; p < (FBf + 1) * kStageRows / 4; p += kThreads) {
      const int line = p / (kStageRows / 4), r = p % (kStageRows / 4) * 4;
      if (line < FBf) {
        uint4* q = reinterpret_cast<uint4*>(buf + line * kStageRows + r);
        const uint4 b = *q;
        const uint32_t ub = (uint32_t)B;
        const uint32_t x01 =
            __byte_perm(min(b.x - off, ub), min(b.y - off, ub), 0x5410);
        const uint32_t x23 =
            __byte_perm(min(b.z - off, ub), min(b.w - off, ub), 0x5410);
        *q = make_uint4((x01 & 0x00070007u) | kTwo, (x01 & 0x0ff80ff8u) | kTwo,
                        (x23 & 0x00070007u) | kTwo, (x23 & 0x0ff80ff8u) | kTwo);
      } else {
        const float* v = reinterpret_cast<const float*>(vals) + r;
        const float4 G = *reinterpret_cast<const float4*>(v);
        const float4 H = *reinterpret_cast<const float4*>(v + kStageRows);
        const float4 M = *reinterpret_cast<const float4*>(v + 2 * kStageRows);
        const uint4 gh = make_uint4(pack_bf16(G.x, G.y), pack_bf16(G.z, G.w),
                                    pack_bf16(H.x, H.y), pack_bf16(H.z, H.w));
        const uint2 mm = make_uint2(pack_bf16(M.x, M.y), pack_bf16(M.z, M.w));
        nz |= (gh.x | gh.y | gh.z | gh.w | mm.x | mm.y) != 0u;
        if (non_finite(gh.x) || non_finite(gh.y) || non_finite(gh.z) ||
            non_finite(gh.w) || non_finite(mm.x) || non_finite(mm.y))
          bad[s & 1] = 1;
        *reinterpret_cast<uint4*>(vals + r) = gh;
        *reinterpret_cast<uint2*>(vals + kStageRows + r) = mm;
      }
    }
    // a stage of zeros (padding, out of bag) adds nothing
    if (!__syncthreads_or(nz)) continue;  // the same for every thread

    // the slot of this stage's chunk (every thread finds the same one)
    const int64_t ci = (r0 + (int64_t)s * kStageRows) / chunk;
    int sl = slot < 0 ? 0 : slot;
    while (sl + 1 < slots && st[sl + 1] <= ci) ++sl;
    if (sl != slot) {
      if (slot >= 0) {
        if (run) fold();
        flush(slot);
      }
      slot = sl;
    }

    // A non-finite value times the zeros of A would reach every bin of its
    // feature, slot and quantity: such a stage (rare) adds each row into its
    // own bin with global atomics instead, as the plain version does.
    if (bad[s & 1]) {  // the same for every thread
      for (int p = threadIdx.x; p < FBf * kStageRows; p += kThreads) {
        const int fi = p / kStageRows, r = p % kStageRows, sh = (r & 1) * 16;
        if (f_base + fi >= FP) continue;
        const uint32_t* c = buf + fi * kStageRows + (r & ~1);  // lo, hi
        const uint32_t b = ((c[0] >> sh) & 7u) | ((c[1] >> sh) & 0x0ff8u);
        if (b >= (uint32_t)B) continue;  // clamped: outside [0, B)
        const uint32_t* v = vals + (r & ~3) + ((r >> 1) & 1);  // g; h, m
        float* dst =
            out + (((int64_t)slot * FP + f_base + fi) * OB + off + b) * 3;
        atomicAdd(dst, bf16_at(v[0], sh));
        atomicAdd(dst + 1, bf16_at(v[2], sh));
        atomicAdd(dst + 2, bf16_at(v[kStageRows], sh));
      }
      continue;
    }

    // units of features >= FP read zero-filled bins and are never flushed
#pragma unroll
    for (int grp = 0; grp < kStageGroups; ++grp) {
      // this lane's k slots 2tq, 2tq+1, 2tq+8, 2tq+9 are rows 4tq .. 4tq+3
      const int r = 16 * grp + 4 * tq;
      const uint4 gh = *reinterpret_cast<const uint4*>(vals + r);
      const uint2 mm = *reinterpret_cast<const uint2*>(vals + kStageRows + r);
      const uint32_t P[3][2] = {{gh.x, gh.y}, {gh.z, gh.w}, {mm.x, mm.y}};
#pragma unroll
      for (int u = 0; u < kUnits; ++u) {
        const uint4 x =
            *reinterpret_cast<const uint4*>(buf + fl[u] * kStageRows + r);
        const uint32_t lo01 = x.x, hi01 = x.y, lo23 = x.z, hi23 = x.w;
        const uint32_t m01 = eq_one(lo01, lo0), m23 = eq_one(lo23, lo0);
        const uint32_t b[3][2] = {{bmul(P[0][0], m01), bmul(P[0][1], m23)},
                                  {bmul(P[1][0], m01), bmul(P[1][1], m23)},
                                  {bmul(P[2][0], m01), bmul(P[2][1], m23)}};
#pragma unroll
        for (int i = 0; i < 2; ++i) {  // hi 32 * blk + 16 * i + (0 .. 15)
          const uint32_t h0 =
              (0x4000u | (32 * blk[u] + 16 * i + gq) << 3) * kPair;
          const uint32_t h8 = h0 + (8 << 3) * kPair;
          const uint32_t a[4] = {eq_one(hi01, h0), eq_one(hi01, h8),
                                 eq_one(hi23, h0), eq_one(hi23, h8)};
#pragma unroll
          for (int c = 0; c < 3; ++c)  // quantity c
            mma_bf16(acc[u][3 * i + c], a, b[c][0], b[c][1]);
        }
      }
    }
    run += kStageGroups;
    if (run == kLevelT) fold();
  }
  cp_async_wait<0>();
  if (slot >= 0) {
    if (run) fold();
    flush(slot);
  }
}

template <int kVec>
int launch_level_mma(const int32_t* bT, const float* g, const float* h,
                     const float* m, const int32_t* starts, float* out,
                     int64_t n, int FP, int B, int windows, int slots,
                     int chunk, cudaStream_t stream) {
  const int FBf = kBlockUnits / (B >> 8);
  const size_t smem =
      ((size_t)kStages * (FBf + 3) * kStageRows + slots + 2) *
          sizeof(int32_t) +
      (size_t)kBlockUnits * 6 * 32 * sizeof(float4);
  auto kernel = level_mma_kernel<kVec>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int sms = 0;
  err = sm_count(&sms);
  if (err != cudaSuccess) return (int)err;
  const int fblocks = (FP + FBf - 1) / FBf;
  // one wave of resident blocks, each a run of stages (a block's first
  // stage and its flushes are not hidden: fewer, longer blocks win)
  const int64_t total = (n + kStageRows - 1) / kStageRows;
  const int64_t yz = (int64_t)fblocks * windows;
  int64_t want = ((int64_t)sms * kLevelBlocksPerSM + yz - 1) / yz;
  if (want > total) want = total;
  const int64_t per_block = (total + want - 1) / want;
  const int gx = (int)((total + per_block - 1) / per_block);
  dim3 grid(gx, fblocks, windows);
  kernel<<<grid, kThreads, smem, stream>>>(bT, g, h, m, starts, out, n, FP, B,
                                           B * windows, slots, chunk,
                                           per_block);
  return (int)cudaGetLastError();
}

int launch_level(const int32_t* bT, const float* g, const float* h,
                 const float* m, const int32_t* starts, float* out, int64_t n,
                 int FP, int B, int slots, int chunk, cudaStream_t stream) {
  if (n <= 0 || FP <= 0) return 0;
  if (slots <= 0 || chunk <= 0 || chunk % kStageRows != 0 || B < 256 ||
      (B & (B - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  // bin windows of at most kMaxLevelBins (B is a power of two)
  const int wb = B < kMaxLevelBins ? B : kMaxLevelBins;
  const int windows = B / wb;
  if (windows > kMaxGridZ) return (int)cudaErrorInvalidValue;
  const uintptr_t addr =
      (uintptr_t)bT | (uintptr_t)g | (uintptr_t)h | (uintptr_t)m;
  if (n % 4 == 0 && addr % 16 == 0)
    return launch_level_mma<4>(bT, g, h, m, starts, out, n, FP, wb, windows,
                               slots, chunk, stream);
  return launch_level_mma<1>(bT, g, h, m, starts, out, n, FP, wb, windows,
                             slots, chunk, stream);
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
