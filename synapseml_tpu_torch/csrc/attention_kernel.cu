// Flash-attention forward kernels for Hopper (sm_90a), bound to PyTorch with
// ctypes.
//
// Two entry points, one translation unit, one kernel template:
//
//   flash_attention_fwd  replaces synapseml_tpu/ops/attention_kernel.py
//                        `_flash_kernel` (pl.pallas_call in `_flash_forward`).
//   flash_block_fwd      replaces synapseml_tpu/ops/attention_kernel.py
//                        `_flash_block_kernel` (pl.pallas_call in
//                        `flash_attention_block`), the ring's step.
//
// What they compute (the function of the TPU kernels, not their design).
// q is (B, Sq, H, D), k and v are (B, Sk, H, D), float32 or bfloat16, read
// with arbitrary element strides (no copy to (B*H, S, D), no padding to block
// multiples). For each (b, h) and query row r, over keys c:
//   s = (q[r] . k[c]) * scale                         (float32 product, then
//                                                       the scale)
//   valid = c < Sk and (not causal or q_offset + r >= k_offset + c)
//   s = valid ? s : -1e30
// folded into a running state (m, l, acc) by the online softmax:
//   m_new = max(m, max s); alpha = exp(m - m_new); p = valid ? exp(s - m_new) : 0
//   l = l * alpha + sum p; acc = acc * alpha + sum round_v(p) * v[c]
// where round_v rounds p to v's type (bf16 inputs: bf16, as the TPU kernel
// casts p before its PV product; l sums the unrounded p). The state starts
// at (-1e30, 0, 0) so that alpha stays finite. flash_attention_fwd starts
// from that state with zero offsets and writes acc / (l > 0 ? l : 1) in q's
// type. flash_block_fwd starts from the carried state (m_in mapped from -inf
// to -1e30, l_in, o_in; (B, H, Sq) and (B, Sq, H, D) float32, strided) and
// writes the raw m, l and the unnormalised acc (float32, contiguous), so a
// step whose keys are all masked leaves l and o unchanged.
//
// Design. One thread block per (b*h, tile of kRows query rows), one thread
// per query row: the row of q and its accumulator live in registers (D
// padded with zeros to DP = 32 or 64), K and V come through shared
// memory in tiles of kTile keys converted to float32, and each thread folds
// kChunk keys at a time into its state. Every thread of a warp reads the
// same key of a tile, so the shared-memory reads are broadcasts, 16 bytes at
// a time, each feeding four FMAs. Products are true float32 FMAs (no tensor
// cores, no TF32). Causal masking skips, per block, every tile that starts
// after the block's last query row (every later tile is in the future too),
// and per thread every chunk that starts after its own row: both are exact,
// a fully masked update leaves the state as it was. Key columns >= Sk are
// masked and rows >= Sq are not written.
//
// Bound on the H100 SXM: operations. 4*B*H*Sq*Sk*D float32 flops (QK^T and
// PV, two per FMA; about half under a causal mask) over 67 TFLOP/s, against
// q/k/v read once and the output written once over 3.35 TB/s: at the
// encoder's Ulysses shape (B=4, S=8192, H=4, D=32) 137 GFLOP, 2.05 ms,
// against 17 MB, 5 us.
//
// This first version is simple, not fast: no tensor cores (wgmma), no TMA,
// no double buffering of the K/V tiles, the q rows are read and the output
// written one row per thread (uncoalesced). Head dims above 64 are refused:
// a thread's row and accumulator would not fit in registers (at D = 128,
// 255 registers and spills), and each (type, DP, state) instance adds to the
// build time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // finite -inf stand-in: exp() stays NaN-free
constexpr int kRows = 128;         // query rows (threads) per block
constexpr int kTile = 32;          // keys per shared-memory tile
constexpr int kChunk = 16;         // keys per online-softmax update

// Shapes, offsets and element strides, filled from the host's int64 array
// (see kGeomLen and the order in ops/attention_kernel.py `_geom`).
struct Geom {
  int64_t B, H, Sq, Sk, D, q_offset, k_offset;
  int64_t q[4], k[4], v[4], o[4];  // (b, s, h, d) strides of q, k, v, o_in
  int64_t m[3], l[3];              // (b, h, s) strides of m_in, l_in
};
constexpr int kGeomLen = 7 + 4 * 4 + 2 * 3;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f32(float x, float* out) { *out = x; }
__device__ __forceinline__ void from_f32(float x, __nv_bfloat16* out) {
  *out = __float2bfloat16_rn(x);
}
// p rounded to v's type T before the PV product
template <typename T>
__device__ __forceinline__ float round_like(float p);
template <>
__device__ __forceinline__ float round_like<float>(float p) { return p; }
template <>
__device__ __forceinline__ float round_like<__nv_bfloat16>(float p) {
  return __bfloat162float(__float2bfloat16_rn(p));
}

template <typename T, int DP, bool kState>
__global__ void __launch_bounds__(kRows)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const float* __restrict__ m_in,
             const float* __restrict__ l_in, const float* __restrict__ o_in,
             T* __restrict__ out, float* __restrict__ m_out,
             float* __restrict__ l_out, float* __restrict__ o_out, Geom g,
             float scale, int causal) {
  __shared__ __align__(16) float ks[kTile][DP];
  __shared__ __align__(16) float vs[kTile][DP];

  const int64_t n_qt = (g.Sq + kRows - 1) / kRows;
  const int64_t bh = blockIdx.x / n_qt;
  const int64_t b = bh / g.H, h = bh % g.H;
  const int64_t row0 = (blockIdx.x % n_qt) * kRows;
  const int64_t row = row0 + threadIdx.x;
  const bool live = row < g.Sq;
  const int D = (int)g.D;

  float qr[DP], acc[DP];
  float m = kNegInf, l = 0.f;
  const T* qp = q + b * g.q[0] + row * g.q[1] + h * g.q[2];
#pragma unroll
  for (int d = 0; d < DP; ++d) {
    qr[d] = (live && d < D) ? to_f32(qp[d * g.q[3]]) : 0.f;
    acc[d] = 0.f;
  }
  if (kState && live) {
    m = fmaxf(m_in[b * g.m[0] + h * g.m[1] + row * g.m[2]], kNegInf);
    l = l_in[b * g.l[0] + h * g.l[1] + row * g.l[2]];
    const float* op = o_in + b * g.o[0] + row * g.o[1] + h * g.o[2];
#pragma unroll
    for (int d = 0; d < DP; ++d) acc[d] = d < D ? op[d * g.o[3]] : 0.f;
  }

  const int64_t grow = g.q_offset + row;  // this thread's global row
  const int64_t row_end = row0 + kRows < g.Sq ? row0 + kRows : g.Sq;
  const int64_t last_row = g.q_offset + row_end - 1;
  const T* kb = k + b * g.k[0] + h * g.k[2];
  const T* vb = v + b * g.v[0] + h * g.v[2];

  for (int64_t t0 = 0; t0 < g.Sk; t0 += kTile) {
    // block-uniform: every thread takes the same number of iterations, so
    // the barriers below are reached by all of them
    if (causal && g.k_offset + t0 > last_row) break;
    __syncthreads();  // the previous tile is consumed
    for (int i = threadIdx.x; i < kTile * DP; i += kRows) {
      const int j = i / DP, d = i % DP;
      const int64_t key = t0 + j;
      float kv = 0.f, vv = 0.f;
      if (key < g.Sk && d < D) {
        kv = to_f32(kb[key * g.k[1] + d * g.k[3]]);
        vv = to_f32(vb[key * g.v[1] + d * g.v[3]]);
      }
      ks[j][d] = kv;
      vs[j][d] = vv;
    }
    __syncthreads();
    if (!live) continue;

#pragma unroll
    for (int c0 = 0; c0 < kTile; c0 += kChunk) {
      const int64_t col0 = g.k_offset + t0 + c0;  // global column of key c0
      if (t0 + c0 >= g.Sk || (causal && col0 > grow)) continue;
      float s[kChunk];
      unsigned valid = 0u;
      float cmax = kNegInf;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const float4* kr = reinterpret_cast<const float4*>(&ks[c0 + jj][0]);
        float dot = 0.f;
#pragma unroll
        for (int d4 = 0; d4 < DP / 4; ++d4) {
          const float4 kk = kr[d4];
          dot = fmaf(qr[4 * d4 + 0], kk.x, dot);
          dot = fmaf(qr[4 * d4 + 1], kk.y, dot);
          dot = fmaf(qr[4 * d4 + 2], kk.z, dot);
          dot = fmaf(qr[4 * d4 + 3], kk.w, dot);
        }
        const bool ok = (t0 + c0 + jj < g.Sk) && (!causal || grow >= col0 + jj);
        s[jj] = ok ? dot * scale : kNegInf;
        valid |= (ok ? 1u : 0u) << jj;
        cmax = fmaxf(cmax, s[jj]);
      }
      const float m_new = fmaxf(m, cmax);
      const float alpha = expf(m - m_new);
      float psum = 0.f;
#pragma unroll
      for (int d = 0; d < DP; ++d) acc[d] *= alpha;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const float p = ((valid >> jj) & 1u) ? expf(s[jj] - m_new) : 0.f;
        psum += p;
        const float pv = round_like<T>(p);
        const float4* vr = reinterpret_cast<const float4*>(&vs[c0 + jj][0]);
#pragma unroll
        for (int d4 = 0; d4 < DP / 4; ++d4) {
          const float4 vv = vr[d4];
          acc[4 * d4 + 0] = fmaf(pv, vv.x, acc[4 * d4 + 0]);
          acc[4 * d4 + 1] = fmaf(pv, vv.y, acc[4 * d4 + 1]);
          acc[4 * d4 + 2] = fmaf(pv, vv.z, acc[4 * d4 + 2]);
          acc[4 * d4 + 3] = fmaf(pv, vv.w, acc[4 * d4 + 3]);
        }
      }
      l = l * alpha + psum;
      m = m_new;
    }
  }

  if (!live) return;
  if (kState) {
    const int64_t ms = (b * g.H + h) * g.Sq + row;
    m_out[ms] = m;
    l_out[ms] = l;
    float* op = o_out + ((b * g.Sq + row) * g.H + h) * g.D;
#pragma unroll
    for (int d = 0; d < DP; ++d)
      if (d < D) op[d] = acc[d];
  } else {
    const float denom = l > 0.f ? l : 1.f;
    T* op = out + ((b * g.Sq + row) * g.H + h) * g.D;
#pragma unroll
    for (int d = 0; d < DP; ++d)
      if (d < D) from_f32(acc[d] / denom, op + d);
  }
}

Geom read_geom(const int64_t* a) {
  Geom g;
  g.B = a[0]; g.H = a[1]; g.Sq = a[2]; g.Sk = a[3]; g.D = a[4];
  g.q_offset = a[5]; g.k_offset = a[6];
  for (int i = 0; i < 4; ++i) {
    g.q[i] = a[7 + i]; g.k[i] = a[11 + i]; g.v[i] = a[15 + i];
    g.o[i] = a[19 + i];
  }
  for (int i = 0; i < 3; ++i) { g.m[i] = a[23 + i]; g.l[i] = a[26 + i]; }
  return g;
}

template <typename T, int DP, bool kState>
int launch(const void* q, const void* k, const void* v, const void* m_in,
           const void* l_in, const void* o_in, void* out, void* m_out,
           void* l_out, void* o_out, const Geom& g, float scale, int causal,
           cudaStream_t stream) {
  const int64_t blocks = g.B * g.H * ((g.Sq + kRows - 1) / kRows);
  if (blocks <= 0) return 0;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  flash_kernel<T, DP, kState><<<(unsigned)blocks, kRows, 0, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const float*)m_in,
      (const float*)l_in, (const float*)o_in, (T*)out, (float*)m_out,
      (float*)l_out, (float*)o_out, g, scale, causal);
  return (int)cudaGetLastError();
}

template <bool kState>
int dispatch(const void* q, const void* k, const void* v, const void* m_in,
             const void* l_in, const void* o_in, void* out, void* m_out,
             void* l_out, void* o_out, const int64_t* geom, float scale,
             int causal, int bf16, cudaStream_t stream) {
  const Geom g = read_geom(geom);
#define FLASH_LAUNCH(T, DP)                                                 \
  return launch<T, DP, kState>(q, k, v, m_in, l_in, o_in, out, m_out, l_out, \
                               o_out, g, scale, causal, stream)
#define FLASH_BY_DIM(T)                  \
  if (g.D <= 32) FLASH_LAUNCH(T, 32);    \
  if (g.D <= 64) FLASH_LAUNCH(T, 64);
  if (bf16) {
    FLASH_BY_DIM(__nv_bfloat16)
  } else {
    FLASH_BY_DIM(float)
  }
#undef FLASH_BY_DIM
#undef FLASH_LAUNCH
  return (int)cudaErrorInvalidValue;  // head dim above 64
}

}  // namespace

extern "C" {

// Number of int64 entries `geom` must hold.
int flash_geom_len() { return kGeomLen; }

// Attention of q over k/v into `out` ((B, Sq, H, D) contiguous, q's type).
// Returns a cudaError_t as int (0 = launched).
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        void* out, const int64_t* geom, float scale,
                        int causal, int bf16, void* stream) {
  return dispatch<false>(q, k, v, nullptr, nullptr, nullptr, out, nullptr,
                         nullptr, nullptr, geom, scale, causal, bf16,
                         (cudaStream_t)stream);
}

// One carried-state update: (m_in, l_in, o_in) -> (m_out, l_out, o_out),
// float32, outputs contiguous. Returns a cudaError_t as int.
int flash_block_fwd(const void* q, const void* k, const void* v,
                    const void* m_in, const void* l_in, const void* o_in,
                    void* m_out, void* l_out, void* o_out,
                    const int64_t* geom, float scale, int causal, int bf16,
                    void* stream) {
  return dispatch<true>(q, k, v, m_in, l_in, o_in, nullptr, m_out, l_out,
                        o_out, geom, scale, causal, bf16,
                        (cudaStream_t)stream);
}

}  // extern "C"
