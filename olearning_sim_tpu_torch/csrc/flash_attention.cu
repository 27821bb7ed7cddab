// Masked self-attention forward (flash-style) for NVIDIA Hopper (sm_90a),
// with and without the per-row softmax statistics.
//
// Replaces the two Pallas TPU kernels of the JAX package's
// ops/flash_attention.py:
//
//   K1 _attn_kernel (flash_attention_fwd below), behind
//   TransformerBlock(attention_impl="flash"):
//     o = softmax(scale * q k^T + (1 - kv_mask) * NEG_INF) v,   NEG_INF = -1e30
//
//   K2 _attn_stats_kernel (flash_attention_stats_fwd below), ring attention's
//   per-step primitive: the same o plus, per query row, the f32 max
//   m = max_j s_j and normaliser l = sum_j exp(s_j - m) of the scores s, in
//   natural-log units, so that a caller can merge several K/V blocks
//   (acc_blk = o * l; parallel/ring_attention.py's combine_flash).
//
// Both take f32 scores, softmax and accumulation whatever the input type,
// round the probabilities to the input type before the P.V product (the TPU
// kernels' p.astype(v.dtype)), and sum l from the unrounded f32 p. A row
// whose keys are all masked is written as o = 0 and, with stats, m = l = 0
// (the TPU kernels pin its max to 0 and floor l at 1e-20).
//
// Bound. K1 at its path's shape (B 1024, H 12, Lq = Lk = D = 64, bf16) must
// move q, k, v, the mask and o, about 403 MB: 0.12 ms at 3.35 TB/s, while its
// 12.9 GFLOP take 13 us at the 989 TFLOP/s bf16 tensor-core peak, so it is
// bound by bytes. K2 at the long-context shape (B 8, H 12, Lq = Lk = 2048,
// D 64, bf16) moves about 102 MB (0.03 ms) but does 103 GFLOP (0.10 ms at the
// peak), so it is bound by operations.
//
// Design of the bf16 instances (attn_wgmma_kernel), one template for both:
//
// - Tensor cores. Each consumer warpgroup (128 threads) owns 64 query rows
//   of a 128-row Q tile and computes S = Q K^T with
//   wgmma.m64n128k16.f32.bf16.bf16, A (Q) and B (a 128-key K tile) from
//   shared memory, both K-major (head dim contiguous), then O += P V with P
//   as the register A operand: the f32 S fragment converts to bf16 in place,
//   since wgmma's accumulator layout and its A-fragment layout line up. V
//   [keys, head dim] is the B operand in MN-major form (the transpose bit).
// - Asynchronous copies. One producer thread issues TMA loads
//   (cp.async.bulk.tensor.3d) of bf16 Q, K and V tiles, 128-byte swizzled as
//   the wgmma descriptors read them, into two Q buffers and a ring of K/V
//   stages (4 at head dim 64, 2 at 128), each signalled by an mbarrier that
//   counts the bytes; the mask tile comes with its K/V stage as a 1-D bulk
//   copy. Consumers release a stage after its P.V wgmma retired, and a Q
//   buffer after the item's last Q K^T. setmaxnreg moves registers from
//   the producer warpgroup to the two consumer warpgroups.
// - Tensor maps are 3-D [B*H, L, Dp], so a ragged L tile is zero-filled by
//   TMA inside its own head and never reads the next head's rows. With the
//   128-byte swizzle a box is at most 64 bf16 wide, so a head-dim-128 tile is
//   two boxes. The host encodes the maps per call with cuTensorMapEncodeTiled,
//   reached through cudaGetDriverEntryPoint, so the library needs no -lcuda;
//   they reach the kernel as __grid_constant__ CUtensorMap parameters.
// - Persistent CTAs, one per SM, walk the work items (batch*head, 128-row
//   q tile) in order; the producer streams the next item's Q and K/V while
//   the consumers compute the current one. That is what K1 needs (one K/V
//   tile per item at L 64, so its time is its loads); K2 has 16 K/V tiles
//   per item. A warpgroup whose 64 rows all lie past Lq (K1's second
//   warpgroup at L 64) takes and releases the tiles without computing.
// - Online softmax in registers. Each thread holds two rows of S; the row
//   max and sum are two quad shuffles. Scores are kept in log2 units (log2(e)
//   folded into the scale and the bias, p = ex2(s - m)); m is written back
//   in natural-log units (m * ln 2).
//
// Masking. Every K/V tile adds the (1 - mask) * NEG_INF bias per key; the
// wrapper pads the mask with zeros to a multiple of the 128-key tile, so keys
// past Lk are masked. No tile is skipped: a tile whose keys are all masked
// sets m to about NEG_INF and fills the accumulator and l with garbage (l
// counts the masked keys, since exp(-1e30 - (-1e30)) = 1), and the first
// tile with a real key rescales both by exp(-1e30 - m_real) = 0. A row with
// no real key never gets that rescale: after the last tile m <= NEG_INF / 2
// marks it, and its o (and m and l) are written as 0 instead of the garbage.
//
// Ragged D. TMA needs each row's byte stride to be a multiple of 16, so the
// wrapper (ops/flash_attention.py) zero-pads bf16 D up to a multiple of 8
// and slices o after, as the JAX entry pads D to 128; zero columns add
// nothing to q k^T, and the scale stays 1/sqrt(D) of the unpadded D. The
// kernel is compiled for padded head dims of 64 and 128; a box's columns
// past the padded D are zero-filled by TMA.
//
// f32 (attn_simt_kernel) stays on SIMT f32 FMAs from shared memory: tensor
// cores have no product of f32 accuracy (TF32 keeps about 3 digits, the f32
// tolerance is 1e-4). The C entries choose the instance by dtype; a bf16
// input of any shape goes to the wgmma kernel, never to the SIMT one.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr int MAX_D = 128;

// ---------------------------------------------------------------------------
// f32: the SIMT kernel. One CTA owns one (batch*head, 64-row query tile) and
// streams K/V through shared memory in 64-key tiles with an online softmax;
// four threads share a query row (16 of a tile's keys each in the score
// phase, every fourth output column in the P.V phase), and tiles are stored
// with an odd row stride so that the rows a warp reads fall in different
// banks.

constexpr int SIMT_BQ = 64;
constexpr int SIMT_BK = 64;
constexpr int SIMT_TPR = 4;
constexpr int SIMT_THREADS = SIMT_BQ * SIMT_TPR;  // 256
constexpr int SIMT_KPT = SIMT_BK / SIMT_TPR;

__device__ __forceinline__ void load_tile_f32(float* dst, int ld, const float* __restrict__ src,
                                              int rows, int D) {
  for (int e = threadIdx.x; e < SIMT_BQ * D; e += SIMT_THREADS) {
    const int r = e / D;
    const int d = e - r * D;
    dst[r * ld + d] = r < rows ? src[e] : 0.f;
  }
}

// NI: output columns per thread, ceil(max D / 4). WITH_STATS: also write
// each row's m and l (m_out, l_out [B*H*Lq] f32; unused otherwise).
template <int NI, bool WITH_STATS>
__global__ void __launch_bounds__(SIMT_THREADS)
attn_simt_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ kv_mask,
                 float* __restrict__ o, float* __restrict__ m_out, float* __restrict__ l_out,
                 int H, int Lq, int Lk, int D, int mask_ld, int ld, float scale) {
  extern __shared__ float smem[];
  float* sQ = smem;                             // [BQ][ld]
  float* sK = sQ + SIMT_BQ * ld;                // [BK][ld]
  float* sV = sK + SIMT_BK * ld;                // [BK][ld]
  float* sP = sV + SIMT_BK * ld;                // [BQ][BK + 1]
  float* sBias = sP + SIMT_BQ * (SIMT_BK + 1);  // [BK]

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int q0 = blockIdx.y * SIMT_BQ;
  const int tid = threadIdx.x;
  const int r = tid / SIMT_TPR;
  const int t = tid % SIMT_TPR;

  const size_t kv_base = (size_t)bh * Lk * D;
  load_tile_f32(sQ, ld, q + ((size_t)bh * Lq + q0) * D, min(SIMT_BQ, Lq - q0), D);

  float m = -INFINITY;
  float l = 0.f;
  float acc[NI];
#pragma unroll
  for (int i = 0; i < NI; ++i) acc[i] = 0.f;

  for (int k0 = 0; k0 < Lk; k0 += SIMT_BK) {
    const int kv = min(SIMT_BK, Lk - k0);
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile_f32(sK, ld, k + kv_base + (size_t)k0 * D, kv, D);
    load_tile_f32(sV, ld, v + kv_base + (size_t)k0 * D, kv, D);
    if (tid < SIMT_BK) {
      // Keys past Lk take the masked bias, like the TPU kernel's padding.
      sBias[tid] = tid < kv ? (1.f - kv_mask[(size_t)b * mask_ld + k0 + tid]) * NEG_INF
                            : NEG_INF;
    }
    __syncthreads();

    // Scores of this row against keys t, t + 4, ..., t + 60 of the tile.
    float s[SIMT_KPT];
#pragma unroll
    for (int i = 0; i < SIMT_KPT; ++i) s[i] = 0.f;
    const float* qr = sQ + r * ld;
    for (int d = 0; d < D; ++d) {
      const float qd = qr[d];
#pragma unroll
      for (int i = 0; i < SIMT_KPT; ++i) s[i] = fmaf(qd, sK[(t + SIMT_TPR * i) * ld + d], s[i]);
    }
    float mt = -INFINITY;
#pragma unroll
    for (int i = 0; i < SIMT_KPT; ++i) {
      s[i] = s[i] * scale + sBias[t + SIMT_TPR * i];
      mt = fmaxf(mt, s[i]);
    }
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
    const float m_new = fmaxf(m, mt);
    const float alpha = expf(m - m_new);  // 0 on the first tile (m = -inf)

    float ls = 0.f;
    float* pr = sP + r * (SIMT_BK + 1);
#pragma unroll
    for (int i = 0; i < SIMT_KPT; ++i) {
      const float p = expf(s[i] - m_new);
      ls += p;
      pr[t + SIMT_TPR * i] = p;
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
        const int d = t + SIMT_TPR * i;
        if (d < D) acc[i] = fmaf(pj, vr[d], acc[i]);
      }
    }
  }

  const int row = q0 + r;
  if (row < Lq) {
    const bool no_real_key = m <= NEG_INF * 0.5f;
    const float denom = fmaxf(l, 1e-20f);
    float* orow = o + ((size_t)bh * Lq + row) * D;
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int d = t + SIMT_TPR * i;
      if (d < D) orow[d] = no_real_key ? 0.f : acc[i] / denom;
    }
    if (WITH_STATS && t == 0) {
      const size_t idx = (size_t)bh * Lq + row;
      m_out[idx] = no_real_key ? 0.f : m;
      l_out[idx] = no_real_key ? 0.f : l;
    }
  }
}

template <int NI, bool WITH_STATS>
cudaError_t launch_simt(const void* q, const void* k, const void* v, const void* kv_mask,
                        void* o, void* m_out, void* l_out, int B, int H, int Lq, int Lk, int D,
                        int mask_ld, float scale, cudaStream_t stream) {
  const int ld = (D % 2 == 0) ? D + 1 : D;  // odd stride: conflict-free row reads
  const size_t smem = sizeof(float) * ((size_t)SIMT_BQ * ld + 2 * (size_t)SIMT_BK * ld +
                                       (size_t)SIMT_BQ * (SIMT_BK + 1) + SIMT_BK);
  // Above 48 KB a kernel's dynamic shared memory must be opted into; set
  // on every launch, since the attribute belongs to the current device.
  cudaError_t err = cudaFuncSetAttribute(attn_simt_kernel<NI, WITH_STATS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)(B * H), (unsigned)((Lq + SIMT_BQ - 1) / SIMT_BQ));
  attn_simt_kernel<NI, WITH_STATS><<<grid, SIMT_THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(kv_mask), static_cast<float*>(o), static_cast<float*>(m_out),
      static_cast<float*>(l_out), H, Lq, Lk, D, mask_ld, ld, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: PTX wrappers for mbarriers, TMA and wgmma.

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// One arrival that also announces `bytes` of TMA traffic to wait for.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Spin until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// Box (c0 = column, c1 = row, c2 = batch*head) of a 3-D tensor map into
// shared memory; completion is counted in bytes on `bar`.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Contiguous bytes (a multiple of 16, 16-byte aligned) into shared memory.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma that owns it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory matrix descriptor of a 128-byte-swizzled tile whose
// 1024-byte swizzle atoms (8 rows of 128 bytes) start at a 1024-byte
// aligned address: lbo and sbo in bytes, layout type 1 (128B swizzle).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((saddr >> 4) & 0x3FFF) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

#define WG_F8(i)                                                                          \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])
#define WG_REGS32                                                                         \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define WG_REGS64_HI                                                                       \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, " \
  "%49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"

// d[64] (+)= A B: A 64x16 and B 128x16, both K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                              int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" WG_REGS32 ", " WG_REGS64_HI
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : WG_F8(0), WG_F8(8), WG_F8(16), WG_F8(24), WG_F8(32), WG_F8(40), WG_F8(48), WG_F8(56)
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[N/2] += A B with A 64x16 bf16 in registers (a0..a3) and B 16xN from
// shared memory in MN-major form (transpose bit set).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" WG_REGS32
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_F8(0), WG_F8(8), WG_F8(16), WG_F8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" WG_REGS32 ", " WG_REGS64_HI
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : WG_F8(0), WG_F8(8), WG_F8(16), WG_F8(24), WG_F8(32), WG_F8(40), WG_F8(48), WG_F8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// ---------------------------------------------------------------------------
// bf16: the wgmma + TMA kernel.

// Tiles and the shared-memory layout (bytes from a 1024-aligned base) of the
// instance for padded head dim DH (64 or 128). A tile of R rows is DH / 64
// column chunks of R rows x 128 bytes, each as TMA's 128-byte swizzle writes
// it; K, V and the mask tile of one stage share one mbarrier.
template <int DH>
struct WgCfg {
  static constexpr int BQ = 128;  // query rows per work item, 64 per consumer warpgroup
  static constexpr int BK = 128;  // keys per K/V tile
  static constexpr int CHUNKS = DH / 64;
  static constexpr int STAGES = DH == 64 ? 4 : 2;
  static constexpr int THREADS = 384;  // producer warpgroup + 2 consumer warpgroups
  static constexpr uint32_t Q_CHUNK = BQ * 128;
  static constexpr uint32_t KV_CHUNK = BK * 128;
  static constexpr uint32_t Q_BYTES = CHUNKS * Q_CHUNK;
  static constexpr uint32_t KV_BYTES = CHUNKS * KV_CHUNK;  // one K (or V) tile
  static constexpr uint32_t MASK_BYTES = BK * 4;
  static constexpr uint32_t OFF_Q = 0;  // 2 Q buffers
  static constexpr uint32_t OFF_K = OFF_Q + 2 * Q_BYTES;
  static constexpr uint32_t OFF_V = OFF_K + STAGES * KV_BYTES;
  static constexpr uint32_t OFF_MASK = OFF_V + STAGES * KV_BYTES;
  static constexpr uint32_t OFF_BAR = OFF_MASK + STAGES * MASK_BYTES;
  // q_full[2], q_empty[2], kv_full[STAGES], kv_empty[STAGES]; + alignment slack
  static constexpr uint32_t SMEM = OFF_BAR + 8 * (4 + 2 * STAGES) + 1024;
};

// One persistent CTA per SM walks work items (batch*head bh, q tile); see
// the note at the top. Maps: 3-D [B*H, L, Dg] bf16, box 64 x 128 rows.
// mask [B, mask_ld] f32, mask_ld a multiple of BK, zero past Lk.
// o [B*H, Lq, Dg] bf16; m_out, l_out [B*H, Lq] f32 (WITH_STATS only).
template <int DH, bool WITH_STATS>
__global__ void __launch_bounds__(WgCfg<DH>::THREADS, 1)
attn_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv, const float* __restrict__ mask,
                  __nv_bfloat16* __restrict__ o, float* __restrict__ m_out,
                  float* __restrict__ l_out, int H, int Lq, int Lk, int Dg, int mask_ld,
                  int n_qt, int n_items, float scale_log2) {
  using C = WgCfg<DH>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzle atoms need 1024-byte alignment
  const uint8_t* gbase = smem_raw + (base - raw);
  const uint32_t bars = base + C::OFF_BAR;
  auto q_full = [&](int i) { return bars + 8u * i; };
  auto q_empty = [&](int i) { return bars + 16u + 8u * i; };
  auto kv_full = [&](int s) { return bars + 32u + 8u * s; };
  auto kv_empty = [&](int s) { return bars + 32u + 8u * (C::STAGES + s); };
  constexpr uint32_t CONSUMER_WARPS = 8;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(q_full(i), 1);
      mbar_init(q_empty(i), CONSUMER_WARPS);
    }
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(kv_full(s), 1);
      mbar_init(kv_empty(s), CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int n_kv = (Lk + C::BK - 1) / C::BK;
  const int wg = threadIdx.x / 128;

  if (wg == 0) {
    // Producer warpgroup: one thread issues every load.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      int kv_count = 0;
      int it = 0;
      for (int item = blockIdx.x; item < n_items; item += gridDim.x, ++it) {
        const int bh = item / n_qt;
        const int q0 = (item - bh * n_qt) * C::BQ;
        const int b = bh / H;
        const int qb = it & 1;
        mbar_wait(q_empty(qb), ((it >> 1) & 1) ^ 1);
        mbar_expect_tx(q_full(qb), C::Q_BYTES);
#pragma unroll
        for (int c = 0; c < C::CHUNKS; ++c) {
          tma_load_3d(base + C::OFF_Q + qb * C::Q_BYTES + c * C::Q_CHUNK, &tq, q_full(qb), 64 * c,
                      q0, bh);
        }
        for (int j = 0; j < n_kv; ++j, ++kv_count) {
          const int st = kv_count % C::STAGES;
          mbar_wait(kv_empty(st), ((kv_count / C::STAGES) & 1) ^ 1);
          mbar_expect_tx(kv_full(st), 2 * C::KV_BYTES + C::MASK_BYTES);
#pragma unroll
          for (int c = 0; c < C::CHUNKS; ++c) {
            tma_load_3d(base + C::OFF_K + st * C::KV_BYTES + c * C::KV_CHUNK, &tk, kv_full(st),
                        64 * c, j * C::BK, bh);
            tma_load_3d(base + C::OFF_V + st * C::KV_BYTES + c * C::KV_CHUNK, &tv, kv_full(st),
                        64 * c, j * C::BK, bh);
          }
          bulk_load(base + C::OFF_MASK + st * C::MASK_BYTES,
                    mask + (size_t)b * mask_ld + (size_t)j * C::BK, C::MASK_BYTES, kv_full(st));
        }
      }
    }
  } else {
    // Consumer warpgroups: w owns rows 64w .. 64w + 63 of each Q tile. Each
    // thread holds two of them (r and r + 8) and, of each 8-column group of
    // an accumulator, the columns cq and cq + 1.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int w = wg - 1;
    const int t = threadIdx.x % 128;
    const int lane = t % 32;
    const int r = 16 * (t / 32) + lane / 4;
    const int cq = 2 * (lane % 4);
    constexpr float BIAS_LOG2 = NEG_INF * LOG2E;
    int kv_count = 0;
    int it = 0;
    for (int item = blockIdx.x; item < n_items; item += gridDim.x, ++it) {
      const int bh = item / n_qt;
      const int q0 = (item - bh * n_qt) * C::BQ;
      const int qb = it & 1;
      // Warpgroup-uniform: a warpgroup with no row inside Lq only passes
      // the tiles on.
      const bool active = q0 + 64 * w < Lq;
      const uint32_t q_tile = base + C::OFF_Q + qb * C::Q_BYTES + w * 64 * 128;
      mbar_wait(q_full(qb), (it >> 1) & 1);

      float acc[DH / 2];
#pragma unroll
      for (int i = 0; i < DH / 2; ++i) acc[i] = 0.f;
      float m2[2] = {-INFINITY, -INFINITY};  // running max, log2 units
      float l[2] = {0.f, 0.f};

      for (int j = 0; j < n_kv; ++j, ++kv_count) {
        const int st = kv_count % C::STAGES;
        mbar_wait(kv_full(st), (kv_count / C::STAGES) & 1);
        float s[64];
        if (active) {
          // S = Q K^T, head dim in steps of 16 (32 bytes inside a chunk's row).
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < DH / 16; ++kk) {
            const uint32_t off = (kk / 4) * C::Q_CHUNK + (kk % 4) * 32;
            const uint32_t koff = (kk / 4) * C::KV_CHUNK + (kk % 4) * 32;
            wgmma_ss_n128(s, sw128_desc(q_tile + off, 16, 1024),
                          sw128_desc(base + C::OFF_K + st * C::KV_BYTES + koff, 16, 1024),
                          kk > 0);
          }
          wgmma_commit();
          wgmma_wait_all();
          fence_regs(s);
        }
        if (j == n_kv - 1) {  // the item's Q buffer is read for the last time
          __syncwarp();
          if (lane == 0) mbar_arrive(q_empty(qb));
        }
        if (active) {
          // Online softmax in log2 units: s = acc * scale * log2(e) + bias * log2(e).
          const float* mk = reinterpret_cast<const float*>(gbase + C::OFF_MASK +
                                                           st * C::MASK_BYTES);
          float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
          for (int g = 0; g < 16; ++g) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float bias = (1.f - mk[8 * g + cq + e]) * BIAS_LOG2;
              s[4 * g + e] = fmaf(s[4 * g + e], scale_log2, bias);
              s[4 * g + 2 + e] = fmaf(s[4 * g + 2 + e], scale_log2, bias);
              mt[0] = fmaxf(mt[0], s[4 * g + e]);
              mt[1] = fmaxf(mt[1], s[4 * g + 2 + e]);
            }
          }
          float alpha[2], ls[2] = {0.f, 0.f};
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            mt[h] = fmaxf(mt[h], __shfl_xor_sync(0xffffffffu, mt[h], 1));
            mt[h] = fmaxf(mt[h], __shfl_xor_sync(0xffffffffu, mt[h], 2));
            const float m_new = fmaxf(m2[h], mt[h]);
            alpha[h] = ex2(m2[h] - m_new);  // 0 on the first tile (m2 = -inf)
            m2[h] = m_new;
          }
          // p = 2^(s - m): l sums the f32 p, P.V takes p rounded to bf16,
          // packed as wgmma's A fragment (registers of k-step kk: columns
          // 16kk + cq (+1) and 16kk + 8 + cq (+1) of rows r and r + 8).
          uint32_t pa[32];
#pragma unroll
          for (int g = 0; g < 16; ++g) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const float p0 = ex2(s[4 * g + 2 * h] - m2[h]);
              const float p1 = ex2(s[4 * g + 2 * h + 1] - m2[h]);
              ls[h] += p0 + p1;
              __nv_bfloat162 pb = __floats2bfloat162_rn(p0, p1);
              pa[2 * g + h] = *reinterpret_cast<uint32_t*>(&pb);
            }
          }
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            ls[h] += __shfl_xor_sync(0xffffffffu, ls[h], 1);
            ls[h] += __shfl_xor_sync(0xffffffffu, ls[h], 2);
            l[h] = l[h] * alpha[h] + ls[h];
          }
#pragma unroll
          for (int i = 0; i < DH / 2; ++i) acc[i] *= alpha[(i % 4) / 2];

          // O += P V, keys in steps of 16 (two 8-row swizzle atoms, 2048
          // bytes); the head-dim chunks of V are KV_CHUNK bytes apart.
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < C::BK / 16; ++kk) {
            wgmma_rs(acc, &pa[4 * kk],
                     sw128_desc(base + C::OFF_V + st * C::KV_BYTES + kk * 2048, C::KV_CHUNK,
                                1024));
          }
          wgmma_commit();
          wgmma_wait_all();
          fence_regs(acc);
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(kv_empty(st));
      }

      if (active) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = q0 + 64 * w + r + 8 * h;
          if (row >= Lq) continue;
          const bool no_real_key = m2[h] <= BIAS_LOG2 * 0.5f;
          const float inv = 1.f / fmaxf(l[h], 1e-20f);
          __nv_bfloat16* orow = o + ((size_t)bh * Lq + row) * Dg;
#pragma unroll
          for (int g = 0; g < DH / 8; ++g) {
            const int col = 8 * g + cq;
            if (col < Dg) {
              const float o0 = no_real_key ? 0.f : acc[4 * g + 2 * h] * inv;
              const float o1 = no_real_key ? 0.f : acc[4 * g + 2 * h + 1] * inv;
              *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(o0, o1);
            }
          }
          if (WITH_STATS && cq == 0) {
            const size_t idx = (size_t)bh * Lq + row;
            m_out[idx] = no_real_key ? 0.f : m2[h] * LN2;
            l_out[idx] = no_real_key ? 0.f : l[h];
          }
        }
      }
    }
  }
}

// cuTensorMapEncodeTiled, a driver function, through the runtime's
// driver entry point so that the library links no libcuda.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiledFn>(p);
    }
  }
  return fn;
}

// 3-D map of a contiguous bf16 [BH, L, Dg] tensor: boxes of 64 columns x
// 128 rows x 1 head, 128-byte swizzle, zero fill past every edge.
cudaError_t encode_map(EncodeTiledFn enc, CUtensorMap* map, const void* ptr, int BH, int L,
                       int Dg) {
  const cuuint64_t dims[3] = {(cuuint64_t)Dg, (cuuint64_t)L, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)Dg * 2, (cuuint64_t)L * Dg * 2};
  const cuuint32_t box[3] = {64, 128, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
                         strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int DH, bool WITH_STATS>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, const void* kv_mask,
                         void* o, void* m_out, void* l_out, int B, int H, int Lq, int Lk, int Dg,
                         int mask_ld, float scale, cudaStream_t stream) {
  using C = WgCfg<DH>;
  // TMA and the bulk copy need 16-byte aligned bases; rows are 16-byte
  // multiples (Dg % 8 == 0) and each mask tile lies inside its row.
  if (Dg % 8 != 0 || mask_ld % C::BK != 0 || mask_ld < Lk ||
      ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
        reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(kv_mask)) & 15) != 0) {
    return cudaErrorInvalidValue;
  }
  EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  CUtensorMap tq, tk, tv;
  cudaError_t err = encode_map(enc, &tq, q, B * H, Lq, Dg);
  if (err == cudaSuccess) err = encode_map(enc, &tk, k, B * H, Lk, Dg);
  if (err == cudaSuccess) err = encode_map(enc, &tv, v, B * H, Lk, Dg);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(attn_wgmma_kernel<DH, WITH_STATS>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int n_qt = (Lq + C::BQ - 1) / C::BQ;
  const int n_items = B * H * n_qt;
  const int grid = n_items < sms ? n_items : sms;
  attn_wgmma_kernel<DH, WITH_STATS><<<grid, C::THREADS, C::SMEM, stream>>>(
      tq, tk, tv, static_cast<const float*>(kv_mask), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(m_out), static_cast<float*>(l_out), H, Lq, Lk, Dg, mask_ld, n_qt,
      n_items, scale * LOG2E);
  return cudaGetLastError();
}

// The instance by dtype: bf16 always takes the wgmma kernel (D padded by
// the wrapper to a multiple of 8; compiled head dim 64 or 128), f32 the
// SIMT kernel. A launch error is returned, never answered by the other path.
template <bool WITH_STATS>
int dispatch(const void* q, const void* k, const void* v, const void* kv_mask, void* o,
             void* m_out, void* l_out, int B, int H, int Lq, int Lk, int D, int mask_ld,
             float scale, int is_bf16, void* stream) {
  if (B < 1 || H < 1 || Lq < 1 || Lk < 1 || D < 1 || D > MAX_D || mask_ld < Lk) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (is_bf16) {
    err = D <= 64 ? launch_wgmma<64, WITH_STATS>(q, k, v, kv_mask, o, m_out, l_out, B, H, Lq, Lk,
                                                 D, mask_ld, scale, s)
                  : launch_wgmma<128, WITH_STATS>(q, k, v, kv_mask, o, m_out, l_out, B, H, Lq,
                                                  Lk, D, mask_ld, scale, s);
  } else {
    err = D <= 64 ? launch_simt<16, WITH_STATS>(q, k, v, kv_mask, o, m_out, l_out, B, H, Lq, Lk,
                                                D, mask_ld, scale, s)
                  : launch_simt<32, WITH_STATS>(q, k, v, kv_mask, o, m_out, l_out, B, H, Lq, Lk,
                                                D, mask_ld, scale, s);
  }
  return (int)err;
}

}  // namespace

// q [B,H,Lq,D], k and v [B,H,Lk,D] contiguous, in f32 (is_bf16 = 0) or bf16
// (is_bf16 = 1; D a multiple of 8, 16-byte aligned bases); kv_mask [B,mask_ld]
// contiguous f32 (1 = real key), mask_ld >= Lk, and for bf16 a multiple of
// 128 with zeros past Lk; o like q. Launches on `stream` without
// synchronising; returns the launch's cudaError_t (0 on success).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   const void* kv_mask, void* o, int B, int H, int Lq,
                                   int Lk, int D, int mask_ld, float scale, int is_bf16,
                                   void* stream) {
  return dispatch<false>(q, k, v, kv_mask, o, nullptr, nullptr, B, H, Lq, Lk, D, mask_ld, scale,
                         is_bf16, stream);
}

// As flash_attention_fwd, and also writes m and l, [B,H,Lq] contiguous f32:
// each row's score max and softmax normaliser, both 0 on a row with no real key.
extern "C" int flash_attention_stats_fwd(const void* q, const void* k, const void* v,
                                         const void* kv_mask, void* o, void* m, void* l,
                                         int B, int H, int Lq, int Lk, int D, int mask_ld,
                                         float scale, int is_bf16, void* stream) {
  return dispatch<true>(q, k, v, kv_mask, o, m, l, B, H, Lq, Lk, D, mask_ld, scale, is_bf16,
                        stream);
}
