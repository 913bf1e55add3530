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
//   s = (q[r] . k[c]) * scale                         (float32-accurate
//                                                       product, then the
//                                                       scale)
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
// step whose keys are all masked leaves l and o unchanged. m stays in the
// natural-log units of scale * q.k in and out; inside, exp(x) is computed as
// exp2(x * log2(e)) with the factor folded into one FMA.
//
// Bound on the H100 SXM: operations, on the tensor cores. 4*B*H*Sq*Sk*D
// flops (QK^T and PV; about half under a causal mask); float32 inputs take
// three TF32 products per float32 product (3xTF32, below) over 495 TFLOP/s,
// bf16 inputs one over 989 TFLOP/s; q/k/v read once and the output written
// once over 3.35 TB/s is far below. At the encoder's Ulysses shape (B=4,
// S=8192, H=4, D=32, float32): 3 x 137.4 GFLOP, 0.833 ms; the ring step
// (4, 4096, 8, 32): 0.416 ms. The exponentials (1.07 G at the Ulysses
// shape, about 0.26 ms on the SFUs) sit below that.
//
// Design. One block of 8 warps per (b*h, tile of query rows); each warp
// owns 32 rows at D <= 32 (two 16-row tiles, so every K/V fragment read
// from shared memory feeds two products) and 16 at D <= 64 and D <= 128
// (where two tiles spill registers), as in FlashAttention-2. Products run
// on the tensor cores as `mma.sync.m16n8k8` TF32, chosen over `wgmma`: at
// D = 32 the tensor work is a small part of a tile next to the softmax, and
// `mma.sync` takes its operands from registers in any layout, where TF32
// `wgmma` needs K-major shared-memory operands (V transposed) and its
// descriptors; `wgmma` is a follow-up (ROADMAP Queue 2).
// * Precision, 3xTF32: every float32 operand x is split once into
//   hi = tf32(x) (x with its low 13 mantissa bits cleared) and
//   lo = x - hi (exact in float32; the tensor core reads its top 19 bits),
//   and each product accumulates lo*hi + hi*lo + hi*hi in float32. The
//   dropped lo*lo term and lo's own truncation are about 2^-21 of the
//   product, so the result keeps float32 accuracy where plain TF32 keeps
//   about three decimal digits. The tensor core aligns the addends of each
//   product to the largest and truncates, so a long sum kept in its
//   accumulator drifts toward zero: each tile's P V sum starts from zero in
//   registers and is added to the running output in float32 (accumulated
//   in place across 256 tiles, the ring's and Ulysses' logits came 1.9e-5
//   apart on an H100 80GB HBM3 at 700 W, above their 1e-5 check).
// * bf16 inputs: bf16 values are exact in TF32, so they take one TF32
//   product per product, with no lo parts: exactly the bf16 products with
//   float32 accumulation (P rounded to bf16 for PV, round_v above), on the
//   same code path.
// * Q (split) stays in registers as A fragments. K and V tiles of
//   32 keys are loaded one tile ahead into registers with the caller's
//   strides (scalar loads, eight lanes on 32 consecutive bytes of a row
//   where D is contiguous: any layout takes the same path, no copy), split
//   to hi/lo once per tile on arrival by the whole block, and stored into
//   one of two shared-memory buffers (40 KB at D = 32, 76 KB at D = 64,
//   82 KB at D = 128, dynamic, opted in above 48 KB), so one barrier per
//   tile suffices and the next tile's loads are in flight during this
//   one's products.
//   (`cp.async` would land the raw tile in shared memory and still need a
//   register round trip for the split.)
// * Shared layouts are the fragments': K as [key][d] with each (d, d+4)
//   pair's hi and lo in one 16-byte word, V transposed as [d][key] with the
//   same packing, so every B fragment is one conflict-free 16-byte load
//   (row strides of 16 mod 32 words).
// * Score to P: the score accumulator's layout (row g, keys 2t and 2t+1) is
//   not the TF32 A layout (row g, k = t and t + 4), unlike the k = 16 bf16
//   layout that FlashAttention exploits. Instead of a shuffle, the
//   PV product runs over a permuted key order, k = t <-> key 2t and
//   k = t + 4 <-> key 2t + 1, and V is stored in that order, so P feeds the
//   second product straight from the score registers.
// * The online softmax runs in registers: row max and the rescale factor
//   with two quad `__shfl_xor_sync`s per tile; l is kept per lane and summed
//   over the quad once at the end (a lane that saw no key adds exact zeros).
// * Causal masking skips, per block, every tile after the block's last row
//   and, per warp, every tile after the warp's last row; masks are applied
//   only on tiles that straddle the diagonal or the key edge. A skipped or
//   fully masked update leaves l and o bit-identical. Rows >= Sq are not
//   written.
// * D = 128 (DP = 128, any D in 65..128 padded with zeros): the register
//   budget, not the arithmetic, sets the design. Q's hi/lo fragments alone
//   would take 128 words per lane next to 64 of output, so Q stays unsplit
//   in registers (64 words) and each (row tile, 8-wide d slice) is split
//   when its products use it; the K tile shrinks to 16 keys (fewer load,
//   score and P registers); and the P V loop runs d slice by d slice, so one
//   slice's tile sum (4 words) is live at a time instead of all 64. Each
//   element's sums keep their order, so the result is the same function.
// Variants measured slower on the H100 and not kept: PERF.md §6.
//
// Head dims up to 128 are padded with zeros to DP = 32, 64 or 128 and take
// the design above. Any wider head takes `flash_wide_kernel`, a plain design
// of the same function on the CUDA cores in float32: one block per 16 query
// rows, scores summed over d in chunks of 128, the online softmax in
// registers, and O rescaled and accumulated in shared memory (in a float32
// scratch buffer in device memory beyond kWideAccMaxD). It is bound by its
// shared-memory reads, well below the card's float32 rate; the tensor-core
// (wgmma) design of wide heads is a later step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // finite -inf stand-in: exp() stays NaN-free
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;

// Shapes, offsets and element strides, filled from the host's int64 array
// (see kGeomLen and the order in ops/attention_kernel.py `_geom`).
struct Geom {
  int64_t B, H, Sq, Sk, D, q_offset, k_offset;
  int64_t q[4], k[4], v[4], o[4];  // (b, s, h, d) strides of q, k, v, o_in
  int64_t m[3], l[3];              // (b, h, s) strides of m_in, l_in
};
constexpr int kGeomLen = 7 + 4 * 4 + 2 * 3;

// Tile geometry of head dim DP: 16-row tiles per warp, keys per tile, the
// shared row strides (floats) of K [key][2*DP] and of V^T [d][2*kKeys],
// each 16 mod 32 words, and one buffer's floats.
template <int DP>
struct Tile {
  static constexpr int kMT = DP >= 64 ? 1 : 2;
  static constexpr int kWarpRows = 16 * kMT;
  static constexpr int kRows = kWarpRows * kWarps;  // query rows per block
  static constexpr int kKeys = DP > 64 ? 16 : 32;
  // D = 128: Q kept unsplit and P V summed d slice by d slice (see above)
  static constexpr bool kNarrow = DP > 64;
  static constexpr int kKStride = 2 * DP + 16;
  static constexpr int kVStride = 2 * kKeys + 16;
  static constexpr int kVOffset = kKeys * kKStride;  // V^T after K
  static constexpr int kBuf = kVOffset + DP * kVStride;
  static constexpr int kPer = kKeys * DP / kThreads;  // K (and V) per thread
  static constexpr size_t kSmem = 2 * kBuf * sizeof(float);
};

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

// x = hi + lo exactly: hi is x with its low 13 mantissa bits cleared (a
// TF32 value), lo the rest, of which the tensor core reads the top 19 bits
// (so hi + lo reaches x to about 2^-21). With kSplit false (bf16 values,
// exact in TF32) lo is 0.
template <bool kSplit>
__device__ __forceinline__ void split(float x, float& hi, float& lo) {
  if (kSplit) {
    hi = __uint_as_float(__float_as_uint(x) & 0xffffe000u);
    lo = x - hi;
  } else {
    hi = x;
    lo = 0.f;
  }
}

// c += a * b, one m16n8k8 TF32 tensor-core product (float32 accumulate)
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a * b in 3xTF32 (small terms first) or, for bf16 values, one TF32
// product. w holds the B fragment as {b0 hi, b1 hi, b0 lo, b1 lo}.
template <bool kSplit>
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ahi)[4],
                                     const uint32_t (&alo)[4], float4 w) {
  const uint32_t b0h = __float_as_uint(w.x), b1h = __float_as_uint(w.y);
  if (kSplit) {
    mma_tf32(c, alo, b0h, b1h);
    mma_tf32(c, ahi, __float_as_uint(w.z), __float_as_uint(w.w));
  }
  mma_tf32(c, ahi, b0h, b1h);
}

template <typename T, int DP, bool kState>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const float* __restrict__ m_in,
             const float* __restrict__ l_in, const float* __restrict__ o_in,
             T* __restrict__ out, float* __restrict__ m_out,
             float* __restrict__ l_out, float* __restrict__ o_out, Geom g,
             float scale, int causal) {
  constexpr bool kSplit = sizeof(T) == 4;  // float32: 3xTF32
  using Tl = Tile<DP>;
  constexpr int kKeys = Tl::kKeys, NT = kKeys / 8, KD = DP / 8;
  constexpr int MT = Tl::kMT, kWarpRows = Tl::kWarpRows, kRows = Tl::kRows;
  constexpr bool kNarrow = Tl::kNarrow;
  extern __shared__ __align__(16) float smem[];

  const int64_t n_qt = (g.Sq + kRows - 1) / kRows;
  const int64_t bh = blockIdx.x / n_qt;
  const int64_t b = bh / g.H, h = bh % g.H;
  const int64_t row0 = (blockIdx.x % n_qt) * kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;  // fragment row group, quad lane
  const int64_t wrow0 = row0 + kWarpRows * warp;  // this warp's first row
  // the rows of this lane: (row tile mt, half j) -> wrow0 + 16mt + 8j + gq
  auto row_of = [&](int mt, int j) -> int64_t {
    return wrow0 + 16 * mt + 8 * j + gq;
  };
  const int D = (int)g.D;

  // Q as split A fragments: (row gq, d 8kk+tq), (gq+8, ..), (gq, ..+4),
  // (gq+8, ..+4); unsplit in qx when kNarrow
  constexpr int KS = kNarrow ? 1 : KD, KX = kNarrow ? KD : 1;
  uint32_t qh[MT][KS][4], ql[MT][KS][4];
  float qx[MT][KX][4];
  {
    const T* qb = q + b * g.q[0] + h * g.q[2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int kk = 0; kk < KD; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int64_t r = row_of(mt, i & 1);
          const int d = 8 * kk + tq + 4 * (i >> 1);
          const float x = (r < g.Sq && d < D)
                              ? to_f32(qb[r * g.q[1] + d * g.q[3]]) : 0.f;
          if constexpr (kNarrow) {
            qx[mt][kk][i] = x;
          } else {
            float hi, lo;
            split<kSplit>(x, hi, lo);
            qh[mt][kk][i] = __float_as_uint(hi);
            ql[mt][kk][i] = __float_as_uint(lo);
          }
        }
  }

  // state of this lane's rows; l is this lane's share, summed over the
  // quad at the end. O fragment (row, d 8nd + 2tq + {0, 1}).
  float m[MT][2], lp[MT][2], acc[MT][KD][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      m[mt][j] = kNegInf;
      lp[mt][j] = 0.f;
    }
#pragma unroll
    for (int nd = 0; nd < KD; ++nd)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nd][i] = 0.f;
  }
  if (kState) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int64_t r = row_of(mt, j);
        if (r >= g.Sq) continue;
        m[mt][j] = fmaxf(m_in[b * g.m[0] + h * g.m[1] + r * g.m[2]],
                         kNegInf);
        if (tq == 0) lp[mt][j] = l_in[b * g.l[0] + h * g.l[1] + r * g.l[2]];
        const float* op = o_in + b * g.o[0] + r * g.o[1] + h * g.o[2];
#pragma unroll
        for (int nd = 0; nd < KD; ++nd)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int d = 8 * nd + 2 * tq + c;
            acc[mt][nd][2 * j + c] = d < D ? op[d * g.o[3]] : 0.f;
          }
      }
  }

  // tiles this block needs (block-uniform): a causal mask ends them after
  // the block's last row
  const int64_t row_end = row0 + kRows < g.Sq ? row0 + kRows : g.Sq;
  int64_t kend = g.Sk;
  if (causal) {
    const int64_t lim = g.q_offset + row_end - g.k_offset;  // keys <= last row
    kend = lim < 0 ? 0 : (lim < kend ? lim : kend);
  }
  const int64_t n_tiles = (kend + kKeys - 1) / kKeys;
  const int64_t wend = wrow0 + kWarpRows < g.Sq ? wrow0 + kWarpRows : g.Sq;
  const int64_t wlast = g.q_offset + wend - 1;  // this warp's last row
  const bool warp_live = wrow0 < g.Sq;
  const T* kb = k + b * g.k[0] + h * g.k[2];
  const T* vb = v + b * g.v[0] + h * g.v[2];

  // tile loads: element e = i * kThreads + tid holds (key (e / 8) % kKeys,
  // d 8 * (e / (8 * kKeys)) + e % 8): eight lanes per 32 bytes of a row
  float kr[Tl::kPer], vr[Tl::kPer];
  auto load = [&](int64_t t0) {
#pragma unroll
    for (int i = 0; i < Tl::kPer; ++i) {
      const int e = i * kThreads + threadIdx.x;
      const int key = (e >> 3) % kKeys, d = 8 * (e / (8 * kKeys)) + (e & 7);
      const int64_t c = t0 + key;
      const bool ok = c < g.Sk && d < D;
      kr[i] = ok ? to_f32(kb[c * g.k[1] + d * g.k[3]]) : 0.f;
      vr[i] = ok ? to_f32(vb[c * g.v[1] + d * g.v[3]]) : 0.f;
    }
  };
  auto store = [&](float* buf) {
#pragma unroll
    for (int i = 0; i < Tl::kPer; ++i) {
      const int e = i * kThreads + threadIdx.x;
      const int key = (e >> 3) % kKeys, d = 8 * (e / (8 * kKeys)) + (e & 7);
      float hi, lo;
      // K [key][d]: (d, d + 4) of a group of 8 as {hi, hi, lo, lo}
      split<kSplit>(kr[i], hi, lo);
      float* kp = buf + key * Tl::kKStride + 16 * (d >> 3) + 4 * (d & 3) +
                  ((d >> 2) & 1);
      kp[0] = hi;
      kp[2] = lo;
      // V^T [d][key]: keys (2t, 2t + 1) of a group of 8 as {hi, hi, lo, lo}
      split<kSplit>(vr[i], hi, lo);
      float* vp = buf + Tl::kVOffset + d * Tl::kVStride + 16 * (key >> 3) +
                  4 * ((key & 7) >> 1) + (key & 1);
      vp[0] = hi;
      vp[2] = lo;
    }
  };

  if (n_tiles > 0) {
    load(0);
    store(smem);
  }
  __syncthreads();
  for (int64_t t = 0; t < n_tiles; ++t) {
    const int64_t t0 = t * kKeys;
    const bool more = t + 1 < n_tiles;
    if (more) load(t0 + kKeys);
    const float* buf = smem + (t & 1) * Tl::kBuf;
    // warp-uniform: skip a tile wholly in this warp's causal future
    if (warp_live && !(causal && g.k_offset + t0 > wlast)) {
      // S = Q K^T for the warp's rows x kKeys keys; each K fragment feeds
      // every row tile
      float s[MT][NT][4];
      if constexpr (kNarrow) {
        // d slice outer: one slice of Q is split at a time
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int i = 0; i < 4; ++i) s[mt][nt][i] = 0.f;
#pragma unroll
        for (int kk = 0; kk < KD; ++kk) {
          uint32_t ah[MT][4], al[MT][4];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              float hi, lo;
              split<kSplit>(qx[mt][kk][i], hi, lo);
              ah[mt][i] = __float_as_uint(hi);
              al[mt][i] = __float_as_uint(lo);
            }
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const float4 w = *reinterpret_cast<const float4*>(
                buf + (8 * nt + gq) * Tl::kKStride + 16 * kk + 4 * tq);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
              mma3<kSplit>(s[mt][nt], ah[mt], al[mt], w);
          }
        }
      } else {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int i = 0; i < 4; ++i) s[mt][nt][i] = 0.f;
#pragma unroll
          for (int kk = 0; kk < KD; ++kk) {
            const float4 w = *reinterpret_cast<const float4*>(
                buf + (8 * nt + gq) * Tl::kKStride + 16 * kk + 4 * tq);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
              mma3<kSplit>(s[mt][nt], qh[mt][kk], ql[mt][kk], w);
          }
        }
      }
      // scale and mask: s[mt][nt][i] is (row_of(mt, i >> 1),
      // key 8nt + 2tq + (i & 1))
      const bool need_mask =
          t0 + kKeys > g.Sk ||
          (causal && g.k_offset + t0 + kKeys - 1 > g.q_offset + wrow0);
      uint32_t valid[MT];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        valid[mt] = kFull;
        float mx[2] = {kNegInf, kNegInf};
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            float x = s[mt][nt][i] * scale;
            if (need_mask) {
              const int64_t c = t0 + 8 * nt + 2 * tq + (i & 1);
              const bool ok = c < g.Sk &&
                              (!causal || g.q_offset + row_of(mt, i >> 1) >=
                                              g.k_offset + c);
              if (!ok) {
                x = kNegInf;
                valid[mt] &= ~(1u << (4 * nt + i));
              }
            }
            s[mt][nt][i] = x;
            mx[i >> 1] = fmaxf(mx[i >> 1], x);
          }
        float alpha[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          mx[j] = fmaxf(mx[j], __shfl_xor_sync(kFull, mx[j], 1));
          mx[j] = fmaxf(mx[j], __shfl_xor_sync(kFull, mx[j], 2));
          const float m_new = fmaxf(m[mt][j], mx[j]);
          alpha[j] = exp2f((m[mt][j] - m_new) * kLog2e);
          m[mt][j] = m_new;
          lp[mt][j] *= alpha[j];
        }
#pragma unroll
        for (int nd = 0; nd < KD; ++nd)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[mt][nd][i] *= alpha[i >> 1];
      }
      // p in place of the scores; l sums the unrounded p, the product takes
      // p rounded to v's type
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int kt = 0; kt < NT; ++kt)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const bool ok = (valid[mt] >> (4 * kt + i)) & 1u;
            const float p = ok ? exp2f(fmaf(s[mt][kt][i], kLog2e,
                                            -m[mt][i >> 1] * kLog2e))
                               : 0.f;
            lp[mt][i >> 1] += p;
            s[mt][kt][i] = round_like<T>(p);
          }
      // P V. The tile's sum starts from zero and is added to acc in float32
      // after it: the tensor core aligns and truncates its addends to the
      // largest, so accumulating every tile into the running acc would lose
      // the small products' low bits, and always toward zero.
      // keys in the permuted order k = tq <-> key 2tq, k = tq + 4 <->
      // key 2tq + 1: the A fragment of P is the score registers
      // {s0, s2, s1, s3}
      const float* vs = buf + Tl::kVOffset;
      if constexpr (kNarrow) {
        // d slice outer: one slice's tile sum is live at a time; each
        // element still sums its keys in the same order
        uint32_t ph[NT][MT][4], pl[NT][MT][4];
#pragma unroll
        for (int kt = 0; kt < NT; ++kt)
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            const int perm[4] = {0, 2, 1, 3};
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              float hi, lo;
              split<kSplit>(s[mt][kt][perm[i]], hi, lo);
              ph[kt][mt][i] = __float_as_uint(hi);
              pl[kt][mt][i] = __float_as_uint(lo);
            }
          }
#pragma unroll
        for (int nd = 0; nd < KD; ++nd) {
          float pv[MT][4];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int i = 0; i < 4; ++i) pv[mt][i] = 0.f;
#pragma unroll
          for (int kt = 0; kt < NT; ++kt) {
            const float4 w = *reinterpret_cast<const float4*>(
                vs + (8 * nd + gq) * Tl::kVStride + 16 * kt + 4 * tq);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
              mma3<kSplit>(pv[mt], ph[kt][mt], pl[kt][mt], w);
          }
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[mt][nd][i] += pv[mt][i];
        }
      } else {
        float pv[MT][KD][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nd = 0; nd < KD; ++nd)
#pragma unroll
            for (int i = 0; i < 4; ++i) pv[mt][nd][i] = 0.f;
#pragma unroll
        for (int kt = 0; kt < NT; ++kt) {
          uint32_t ph[MT][4], pl[MT][4];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            const int perm[4] = {0, 2, 1, 3};
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              float hi, lo;
              split<kSplit>(s[mt][kt][perm[i]], hi, lo);
              ph[mt][i] = __float_as_uint(hi);
              pl[mt][i] = __float_as_uint(lo);
            }
          }
#pragma unroll
          for (int nd = 0; nd < KD; ++nd) {
            const float4 w = *reinterpret_cast<const float4*>(
                vs + (8 * nd + gq) * Tl::kVStride + 16 * kt + 4 * tq);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
              mma3<kSplit>(pv[mt][nd], ph[mt], pl[mt], w);
          }
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nd = 0; nd < KD; ++nd)
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[mt][nd][i] += pv[mt][nd][i];
      }
    }
    if (more) store(smem + ((t + 1) & 1) * Tl::kBuf);
    __syncthreads();
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      // l over the quad: a lane that added nothing holds exact zeros
      float l = lp[mt][j] + __shfl_xor_sync(kFull, lp[mt][j], 1);
      l += __shfl_xor_sync(kFull, l, 2);
      const int64_t r = row_of(mt, j);
      if (r >= g.Sq) continue;
      if (kState) {
        const int64_t ms = (b * g.H + h) * g.Sq + r;
        if (tq == 0) {
          m_out[ms] = m[mt][j];
          l_out[ms] = l;
        }
        float* op = o_out + ((b * g.Sq + r) * g.H + h) * g.D;
#pragma unroll
        for (int nd = 0; nd < KD; ++nd)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int d = 8 * nd + 2 * tq + c;
            if (d < D) op[d] = acc[mt][nd][2 * j + c];
          }
      } else {
        const float denom = l > 0.f ? l : 1.f;
        T* op = out + ((b * g.Sq + r) * g.H + h) * g.D;
#pragma unroll
        for (int nd = 0; nd < KD; ++nd)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int d = 8 * nd + 2 * tq + c;
            if (d < D) from_f32(acc[mt][nd][2 * j + c] / denom, op + d);
          }
      }
    }
}

// ---------------------------------------------------------------------------
// Head dims above 128: a plain design on the CUDA cores (see the note above)
// ---------------------------------------------------------------------------

constexpr int kWideRows = 16;                // query rows per block
constexpr int kWideKeys = 64;                // keys per tile
constexpr int kWideChunk = 128;              // d per staged chunk
constexpr int kWideStride = kWideChunk + 1;  // shared row stride (floats)
constexpr int kWideAccMaxD = 2048;           // O in shared memory up to here
// shared floats besides O: the Q chunk, the K (or V) chunk, P, a row scalar
constexpr int kWideFixed = kWideRows * kWideStride + kWideKeys * kWideStride +
                           kWideRows * kWideKeys + kWideRows;

// One block of 256 threads per (b*h, 16 query rows), any D. Scores: thread
// t holds row t / 16 and keys t % 16 + 16 j (j < 4), summed over d in
// chunks of 128 staged in shared memory (float32 FMAs); the row's max and
// sum take four shuffles within its half warp. P (rounded to v's type) and
// each row's rescale factor go to shared memory; then, V chunk by V chunk,
// thread t owns d = t % 128 of rows 8 (t / 128) .. + 7 of O:
// O = O * alpha + P V. O lives in shared memory (16 D floats) while D <=
// kWideAccMaxD, else in the caller's float32 scratch `acc_g`, one 16 x D
// slab per block; either way each element has one owner, so no atomics.
template <typename T, bool kState>
__global__ void __launch_bounds__(kThreads)
flash_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const float* __restrict__ m_in,
                  const float* __restrict__ l_in,
                  const float* __restrict__ o_in, T* __restrict__ out,
                  float* __restrict__ m_out, float* __restrict__ l_out,
                  float* __restrict__ o_out, float* __restrict__ acc_g, Geom g,
                  float scale, int causal) {
  extern __shared__ __align__(16) float wsm[];
  float* sQ = wsm;
  float* sK = sQ + kWideRows * kWideStride;  // K chunk, then V chunk
  float* sP = sK + kWideKeys * kWideStride;
  float* sRow = sP + kWideRows * kWideKeys;  // alpha per row, at the end l
  const int D = (int)g.D;
  const int64_t n_qt = (g.Sq + kWideRows - 1) / kWideRows;
  const int64_t bh = blockIdx.x / n_qt;
  const int64_t b = bh / g.H, h = bh % g.H;
  const int64_t row0 = (blockIdx.x % n_qt) * kWideRows;
  float* acc = acc_g != nullptr
                   ? acc_g + (int64_t)blockIdx.x * kWideRows * D
                   : sRow + kWideRows;
  const int tid = threadIdx.x;
  const int r = tid >> 4, kk = tid & 15;  // score layout
  const int64_t row = row0 + r;
  const bool row_in = row < g.Sq;

  float m = kNegInf, l = 0.f;
  if (kState && row_in) {
    m = fmaxf(m_in[b * g.m[0] + h * g.m[1] + row * g.m[2]], kNegInf);
    l = l_in[b * g.l[0] + h * g.l[1] + row * g.l[2]];
  }
  for (int i = tid; i < kWideRows * D; i += kThreads) {
    const int64_t rw = row0 + i / D;
    const int d = i % D;
    acc[i] = kState && rw < g.Sq
                 ? o_in[b * g.o[0] + rw * g.o[1] + h * g.o[2] + d * g.o[3]]
                 : 0.f;
  }

  // keys this block needs: a causal mask ends them after its last row
  const int64_t row_end = row0 + kWideRows < g.Sq ? row0 + kWideRows : g.Sq;
  int64_t kend = g.Sk;
  if (causal) {
    const int64_t lim = g.q_offset + row_end - g.k_offset;
    kend = lim < 0 ? 0 : (lim < kend ? lim : kend);
  }
  const T* qb = q + b * g.q[0] + h * g.q[2];
  const T* kb = k + b * g.k[0] + h * g.k[2];
  const T* vb = v + b * g.v[0] + h * g.v[2];
  const int dl = tid & (kWideChunk - 1), pr0 = (tid >> 7) * 8;  // PV layout

  for (int64_t t0 = 0; t0 < kend; t0 += kWideKeys) {
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    for (int d0 = 0; d0 < D; d0 += kWideChunk) {
      __syncthreads();  // every thread is done with the last chunk
      for (int i = tid; i < kWideRows * kWideChunk; i += kThreads) {
        const int rr = i / kWideChunk, d = d0 + i % kWideChunk;
        const int64_t rw = row0 + rr;
        sQ[rr * kWideStride + i % kWideChunk] =
            rw < g.Sq && d < D ? to_f32(qb[rw * g.q[1] + d * g.q[3]]) : 0.f;
      }
      for (int i = tid; i < kWideKeys * kWideChunk; i += kThreads) {
        const int c = i / kWideChunk, d = d0 + i % kWideChunk;
        const int64_t key = t0 + c;
        sK[c * kWideStride + i % kWideChunk] =
            key < g.Sk && d < D ? to_f32(kb[key * g.k[1] + d * g.k[3]]) : 0.f;
      }
      __syncthreads();
      const float* qr = sQ + r * kWideStride;
      const float* kr = sK + kk * kWideStride;
#pragma unroll 8
      for (int d = 0; d < kWideChunk; ++d) {
        const float x = qr[d];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          s[j] = fmaf(x, kr[16 * j * kWideStride + d], s[j]);
      }
    }

    // mask, online softmax; the 16 lanes of a row are one half warp
    bool valid[4];
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t c = t0 + kk + 16 * j;
      valid[j] = c < g.Sk && (!causal || g.q_offset + row >= g.k_offset + c);
      s[j] = valid[j] ? s[j] * scale : kNegInf;
      mx = fmaxf(mx, s[j]);
    }
    for (int o = 8; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
    const float m_new = fmaxf(m, mx);
    const float alpha = exp2f((m - m_new) * kLog2e);
    float ps = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float p = valid[j] ? exp2f((s[j] - m_new) * kLog2e) : 0.f;
      ps += p;
      sP[r * kWideKeys + kk + 16 * j] = round_like<T>(p);
    }
    for (int o = 8; o > 0; o >>= 1) ps += __shfl_xor_sync(kFull, ps, o);
    l = l * alpha + ps;
    m = m_new;
    if (kk == 0) sRow[r] = alpha;

    for (int d0 = 0; d0 < D; d0 += kWideChunk) {
      __syncthreads();  // P and alpha are in; the last chunk is read
      for (int i = tid; i < kWideKeys * kWideChunk; i += kThreads) {
        const int c = i / kWideChunk, d = d0 + i % kWideChunk;
        const int64_t key = t0 + c;
        sK[c * kWideStride + i % kWideChunk] =
            key < g.Sk && d < D ? to_f32(vb[key * g.v[1] + d * g.v[3]]) : 0.f;
      }
      __syncthreads();
      const int d = d0 + dl;
      if (d < D) {
        float pv[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) pv[i] = 0.f;
#pragma unroll 4
        for (int c = 0; c < kWideKeys; ++c) {
          const float x = sK[c * kWideStride + dl];
#pragma unroll
          for (int i = 0; i < 8; ++i)
            pv[i] = fmaf(sP[(pr0 + i) * kWideKeys + c], x, pv[i]);
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          float* a = acc + (pr0 + i) * D + d;
          *a = *a * sRow[pr0 + i] + pv[i];
        }
      }
    }
  }

  __syncthreads();  // O is complete; sRow is free
  if (kk == 0) sRow[r] = l;
  if (kState && kk == 0 && row_in) {
    const int64_t ms = (b * g.H + h) * g.Sq + row;
    m_out[ms] = m;
    l_out[ms] = l;
  }
  __syncthreads();
  for (int i = tid; i < kWideRows * D; i += kThreads) {
    const int rr = i / D, d = i % D;
    const int64_t rw = row0 + rr;
    if (rw >= g.Sq) continue;
    const int64_t o = ((b * g.Sq + rw) * g.H + h) * D + d;
    if (kState) {
      o_out[o] = acc[i];
    } else {
      const float lr = sRow[rr];
      from_f32(acc[i] / (lr > 0.f ? lr : 1.f), out + o);
    }
  }
}

template <typename T, bool kState>
int launch_wide(const void* q, const void* k, const void* v,
                const void* m_in, const void* l_in, const void* o_in,
                void* out, void* m_out, void* l_out, void* o_out,
                void* scratch, const Geom& g, float scale, int causal,
                cudaStream_t stream) {
  const int64_t blocks = g.B * g.H * ((g.Sq + kWideRows - 1) / kWideRows);
  if (blocks <= 0) return 0;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const bool in_smem = g.D <= kWideAccMaxD;
  if (!in_smem && scratch == nullptr) return (int)cudaErrorInvalidValue;
  const size_t smem =
      ((size_t)kWideFixed + (in_smem ? (size_t)kWideRows * g.D : 0)) *
      sizeof(float);
  auto kernel = flash_wide_kernel<T, kState>;
  const cudaError_t opt_in = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (opt_in != cudaSuccess) return (int)opt_in;
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const float*)m_in,
      (const float*)l_in, (const float*)o_in, (T*)out, (float*)m_out,
      (float*)l_out, (float*)o_out, in_smem ? nullptr : (float*)scratch, g,
      scale, causal);
  return (int)cudaGetLastError();
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
  constexpr int kRows = Tile<DP>::kRows;
  const int64_t blocks = g.B * g.H * ((g.Sq + kRows - 1) / kRows);
  if (blocks <= 0) return 0;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  // above 48 KB (D = 64: 76 KB, D = 128: 82 KB) dynamic shared memory
  // needs the opt-in, set for the current device
  constexpr size_t smem = Tile<DP>::kSmem;
  const cudaError_t opt_in = cudaFuncSetAttribute(
      flash_kernel<T, DP, kState>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (opt_in != cudaSuccess) return (int)opt_in;
  flash_kernel<T, DP, kState><<<(unsigned)blocks, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const float*)m_in,
      (const float*)l_in, (const float*)o_in, (T*)out, (float*)m_out,
      (float*)l_out, (float*)o_out, g, scale, causal);
  return (int)cudaGetLastError();
}

template <bool kState>
int dispatch(const void* q, const void* k, const void* v, const void* m_in,
             const void* l_in, const void* o_in, void* out, void* m_out,
             void* l_out, void* o_out, void* scratch, const int64_t* geom,
             float scale, int causal, int bf16, cudaStream_t stream) {
  const Geom g = read_geom(geom);
#define FLASH_LAUNCH(T, DP)                                                 \
  return launch<T, DP, kState>(q, k, v, m_in, l_in, o_in, out, m_out, l_out, \
                               o_out, g, scale, causal, stream)
#define FLASH_BY_DIM(T)                                                     \
  if (g.D <= 32) FLASH_LAUNCH(T, 32);                                       \
  if (g.D <= 64) FLASH_LAUNCH(T, 64);                                       \
  if (g.D <= 128) FLASH_LAUNCH(T, 128);                                     \
  return launch_wide<T, kState>(q, k, v, m_in, l_in, o_in, out, m_out,      \
                                l_out, o_out, scratch, g, scale, causal,    \
                                stream);
  if (bf16) {
    FLASH_BY_DIM(__nv_bfloat16)
  } else {
    FLASH_BY_DIM(float)
  }
#undef FLASH_BY_DIM
#undef FLASH_LAUNCH
}

}  // namespace

extern "C" {

// Number of int64 entries `geom` must hold.
int flash_geom_len() { return kGeomLen; }

// The widest head whose wide-kernel output stays in shared memory; above it
// `scratch` must hold B * H * ceil(Sq / 16) * 16 * D floats.
int flash_wide_acc_max_d() { return kWideAccMaxD; }

// Attention of q over k/v into `out` ((B, Sq, H, D) contiguous, q's type).
// Returns a cudaError_t as int (0 = launched).
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        void* out, void* scratch, const int64_t* geom,
                        float scale, int causal, int bf16, void* stream) {
  return dispatch<false>(q, k, v, nullptr, nullptr, nullptr, out, nullptr,
                         nullptr, nullptr, scratch, geom, scale, causal, bf16,
                         (cudaStream_t)stream);
}

// One carried-state update: (m_in, l_in, o_in) -> (m_out, l_out, o_out),
// float32, outputs contiguous. Returns a cudaError_t as int.
int flash_block_fwd(const void* q, const void* k, const void* v,
                    const void* m_in, const void* l_in, const void* o_in,
                    void* m_out, void* l_out, void* o_out, void* scratch,
                    const int64_t* geom, float scale, int causal, int bf16,
                    void* stream) {
  return dispatch<true>(q, k, v, m_in, l_in, o_in, nullptr, m_out, l_out,
                        o_out, scratch, geom, scale, causal, bf16,
                        (cudaStream_t)stream);
}

}  // extern "C"
