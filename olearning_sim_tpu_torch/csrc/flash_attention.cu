// Masked self-attention forward (flash-style) for NVIDIA Hopper (sm_90a),
// with and without the per-row softmax statistics.
//
// Replaces two Pallas TPU kernels of the JAX package's ops/flash_attention.py:
//
//   _attn_kernel (flash_attention_fwd below), behind
//   TransformerBlock(attention_impl="flash"):
//     o = softmax(scale * q k^T + (1 - kv_mask) * NEG_INF) v,   NEG_INF = -1e30
//
//   _attn_stats_kernel (flash_attention_stats_fwd below), ring attention's
//   per-step primitive: the same o plus, per query row, the f32 max
//   m = max_j s_j and normaliser l = sum_j exp(s_j - m) of the scores s,
//   so that a caller can merge several K/V blocks (acc_blk = o * l).
//
// Both take f32 scores, softmax and accumulation whatever the input type,
// round the probabilities to the input type before the P.V product (the TPU
// kernels' p.astype(v.dtype)), and sum l from the unrounded f32 p. A row
// whose keys are all masked is written as o = 0 and, with stats, m = l = 0
// (the TPU kernels pin its max to 0 and floor l at 1e-20).
//
// Design. The TPU kernels hold a whole K/V chunk in VMEM; a Hopper block has
// at most 227 KB of shared memory, so here one CTA owns one (batch*head,
// 64-row query tile) and streams K/V through shared memory in tiles of 64
// keys with an online softmax (running max m, normaliser l, f32 accumulator
// in registers), which works for any Lk. Four threads share a query row:
// in the score phase each takes 16 of the tile's 64 keys, in the P.V phase
// each takes every fourth output column; row max and sum are two
// butterfly shuffles. Tiles are stored as f32 in shared memory with an odd
// row stride so that the rows a warp reads fall in different banks. Ragged
// Lq, Lk and D (D <= 128) are masked here, not padded by the caller. The
// statistics are a template switch on the epilogue (WITH_STATS), so the two
// entries share one loop.
//
// The masking rule needs no special case inside the loop: a tile whose keys
// are all masked sets m to about -1e30 and fills the accumulator and l with
// garbage (l counts the masked keys, since exp(-1e30 - (-1e30)) = 1), and
// the first tile with a real key rescales both by exp(-1e30 - m_real) = 0.
// A row with no real key never gets that rescale: after the last tile
// m <= NEG_INF / 2 marks it, and its o (and m and l) are written as 0
// instead of the garbage.
//
// Bound. K1 at its slice's shape (B=1024, H=12, Lq=Lk=D=64, bf16) must move
// q, k, v and o, about 403 MB, or 0.12 ms at 3.35 TB/s; its 12.9 GFLOP take
// about 13 us at the bf16 tensor-core peak, so it is memory-bound. The
// stats kernel at the long-context shape (B=8, H=12, Lq=Lk=2048, D=64,
// bf16) moves about 102 MB (0.03 ms) but does 103 GFLOP (0.10 ms at the
// bf16 peak), so it is bound by operations. This first version computes
// with f32 FMAs from shared memory (no tensor cores, no TMA); mma/wgmma and
// TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;               // query rows per CTA
constexpr int BK = 64;               // keys per K/V tile
constexpr int TPR = 4;               // threads per query row
constexpr int THREADS = BQ * TPR;    // 256
constexpr int KPT = BK / TPR;        // keys per thread in the score phase
constexpr int MAX_D = 128;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Copy `rows` rows of D contiguous elements into a BQ-row f32 tile with row
// stride ld, zero-filling the rows past `rows`.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* __restrict__ src,
                                          int rows, int D) {
  for (int e = threadIdx.x; e < BQ * D; e += THREADS) {
    const int r = e / D;
    const int d = e - r * D;
    dst[r * ld + d] = r < rows ? to_float(src[e]) : 0.f;
  }
}

// NI: output columns per thread, ceil(max D / TPR). WITH_STATS: also write
// each row's m and l (m_out, l_out [B*H*Lq] f32; unused otherwise).
template <typename T, int NI, bool WITH_STATS>
__global__ void __launch_bounds__(THREADS)
attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const float* __restrict__ kv_mask, T* __restrict__ o,
                float* __restrict__ m_out, float* __restrict__ l_out,
                int H, int Lq, int Lk, int D, int ld, float scale) {
  extern __shared__ float smem[];
  float* sQ = smem;                   // [BQ][ld]
  float* sK = sQ + BQ * ld;           // [BK][ld]
  float* sV = sK + BK * ld;           // [BK][ld]
  float* sP = sV + BK * ld;           // [BQ][BK + 1]
  float* sBias = sP + BQ * (BK + 1);  // [BK]

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int q0 = blockIdx.y * BQ;
  const int tid = threadIdx.x;
  const int r = tid / TPR;
  const int t = tid % TPR;

  const size_t kv_base = (size_t)bh * Lk * D;
  load_tile(sQ, ld, q + ((size_t)bh * Lq + q0) * D, min(BQ, Lq - q0), D);

  float m = -INFINITY;
  float l = 0.f;
  float acc[NI];
#pragma unroll
  for (int i = 0; i < NI; ++i) acc[i] = 0.f;

  for (int k0 = 0; k0 < Lk; k0 += BK) {
    const int kv = min(BK, Lk - k0);
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile(sK, ld, k + kv_base + (size_t)k0 * D, kv, D);
    load_tile(sV, ld, v + kv_base + (size_t)k0 * D, kv, D);
    if (tid < BK) {
      // Keys past Lk take the masked bias, like the TPU kernel's padding.
      sBias[tid] = tid < kv ? (1.f - kv_mask[(size_t)b * Lk + k0 + tid]) * NEG_INF : NEG_INF;
    }
    __syncthreads();

    // Scores of this row against keys t, t + 4, ..., t + 60 of the tile.
    float s[KPT];
#pragma unroll
    for (int i = 0; i < KPT; ++i) s[i] = 0.f;
    const float* qr = sQ + r * ld;
    for (int d = 0; d < D; ++d) {
      const float qd = qr[d];
#pragma unroll
      for (int i = 0; i < KPT; ++i) s[i] = fmaf(qd, sK[(t + TPR * i) * ld + d], s[i]);
    }
    float mt = -INFINITY;
#pragma unroll
    for (int i = 0; i < KPT; ++i) {
      s[i] = s[i] * scale + sBias[t + TPR * i];
      mt = fmaxf(mt, s[i]);
    }
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
    const float m_new = fmaxf(m, mt);
    const float alpha = expf(m - m_new);  // 0 on the first tile (m = -inf)

    float ls = 0.f;
    float* pr = sP + r * (BK + 1);
#pragma unroll
    for (int i = 0; i < KPT; ++i) {
      const float p = expf(s[i] - m_new);
      ls += p;
      pr[t + TPR * i] = to_float(from_float<T>(p));  // p.astype(v.dtype)
    }
    ls += __shfl_xor_sync(0xffffffffu, ls, 1);
    ls += __shfl_xor_sync(0xffffffffu, ls, 2);
    l = l * alpha + ls;
    m = m_new;
#pragma unroll
    for (int i = 0; i < NI; ++i) acc[i] *= alpha;
    __syncwarp();  // the row's four threads wrote its P

    for (int j = 0; j < kv; ++j) {
      const float pj = pr[j];
      const float* vr = sV + j * ld;
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        const int d = t + TPR * i;
        if (d < D) acc[i] = fmaf(pj, vr[d], acc[i]);
      }
    }
  }

  const int row = q0 + r;
  if (row < Lq) {
    const bool no_real_key = m <= NEG_INF * 0.5f;
    const float denom = fmaxf(l, 1e-20f);
    T* orow = o + ((size_t)bh * Lq + row) * D;
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int d = t + TPR * i;
      if (d < D) orow[d] = from_float<T>(no_real_key ? 0.f : acc[i] / denom);
    }
    if (WITH_STATS && t == 0) {
      const size_t idx = (size_t)bh * Lq + row;
      m_out[idx] = no_real_key ? 0.f : m;
      l_out[idx] = no_real_key ? 0.f : l;
    }
  }
}

template <typename T, int NI, bool WITH_STATS>
cudaError_t launch(const void* q, const void* k, const void* v, const void* kv_mask, void* o,
                   void* m_out, void* l_out, int B, int H, int Lq, int Lk, int D,
                   float scale, cudaStream_t stream) {
  const int ld = (D % 2 == 0) ? D + 1 : D;  // odd stride: conflict-free row reads
  const size_t smem = sizeof(float) * ((size_t)BQ * ld + 2 * (size_t)BK * ld +
                                       (size_t)BQ * (BK + 1) + BK);
  // Above 48 KB a kernel's dynamic shared memory must be opted into; set
  // on every launch, since the attribute belongs to the current device.
  cudaError_t err = cudaFuncSetAttribute(attn_fwd_kernel<T, NI, WITH_STATS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)(B * H), (unsigned)((Lq + BQ - 1) / BQ));
  attn_fwd_kernel<T, NI, WITH_STATS><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(kv_mask), static_cast<T*>(o), static_cast<float*>(m_out),
      static_cast<float*>(l_out), H, Lq, Lk, D, ld, scale);
  return cudaGetLastError();
}

template <bool WITH_STATS>
int dispatch(const void* q, const void* k, const void* v, const void* kv_mask, void* o,
             void* m_out, void* l_out, int B, int H, int Lq, int Lk, int D, float scale,
             int is_bf16, void* stream) {
  if (B < 1 || H < 1 || Lq < 1 || Lk < 1 || D < 1 || D > MAX_D) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (is_bf16) {
    err = D <= 64 ? launch<__nv_bfloat16, 16, WITH_STATS>(q, k, v, kv_mask, o, m_out, l_out,
                                                          B, H, Lq, Lk, D, scale, s)
                  : launch<__nv_bfloat16, 32, WITH_STATS>(q, k, v, kv_mask, o, m_out, l_out,
                                                          B, H, Lq, Lk, D, scale, s);
  } else {
    err = D <= 64 ? launch<float, 16, WITH_STATS>(q, k, v, kv_mask, o, m_out, l_out,
                                                  B, H, Lq, Lk, D, scale, s)
                  : launch<float, 32, WITH_STATS>(q, k, v, kv_mask, o, m_out, l_out,
                                                  B, H, Lq, Lk, D, scale, s);
  }
  return (int)err;
}

}  // namespace

// q [B,H,Lq,D], k and v [B,H,Lk,D] contiguous, in f32 (is_bf16 = 0) or bf16
// (is_bf16 = 1); kv_mask [B,Lk] contiguous f32 (1 = real key); o like q.
// Launches on `stream` without synchronising; returns the launch's
// cudaError_t (0 on success).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   const void* kv_mask, void* o, int B, int H, int Lq,
                                   int Lk, int D, float scale, int is_bf16, void* stream) {
  return dispatch<false>(q, k, v, kv_mask, o, nullptr, nullptr, B, H, Lq, Lk, D, scale,
                         is_bf16, stream);
}

// As flash_attention_fwd, and also writes m and l, [B,H,Lq] contiguous f32:
// each row's score max and softmax normaliser, both 0 on a row with no real key.
extern "C" int flash_attention_stats_fwd(const void* q, const void* k, const void* v,
                                         const void* kv_mask, void* o, void* m, void* l,
                                         int B, int H, int Lq, int Lk, int D, float scale,
                                         int is_bf16, void* stream) {
  return dispatch<true>(q, k, v, kv_mask, o, m, l, B, H, Lq, Lk, D, scale, is_bf16, stream);
}
