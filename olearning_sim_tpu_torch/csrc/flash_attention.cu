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
// peak), so it is bound by operations. In f32 the bytes double (K1: 806 MB,
// 0.24 ms) and every product is three TF32 products (below) at the 495
// TFLOP/s dense TF32 peak: K1's 38.7 GFLOP take 0.08 ms, so it stays bound
// by bytes; K2's 309 GFLOP take 0.62 ms, so it stays bound by operations.
//
// One kernel template, attn_wgmma_kernel<T, DH, WITH_STATS>, serves both
// types (T = __nv_bfloat16 or float) at padded head dims DH = 64 and 128:
//
// - Tensor cores. Each consumer warpgroup (128 threads) owns 64 query rows
//   of a 128-row Q tile and computes S = Q K^T with wgmma, A (Q) and B (a
//   K tile) from shared memory, both K-major (head dim contiguous), then
//   O += P V with P as the register A operand.
// - Asynchronous copies. One producer thread issues TMA loads
//   (cp.async.bulk.tensor.3d) of Q, K and V tiles, 128-byte swizzled as the
//   wgmma descriptors read them, into Q buffers and a ring of K/V stages,
//   each signalled by an mbarrier that counts the bytes; the mask tile comes
//   with its K/V stage as a 1-D bulk copy. Consumers release a stage after
//   its P.V wgmma retired, and a Q buffer after the item's last Q K^T.
//   setmaxnreg moves registers from the producer warpgroup to the two
//   consumer warpgroups.
// - Tensor maps are 3-D [B*H, L, Dp], so a ragged L tile is zero-filled by
//   TMA inside its own head and never reads the next head's rows. With the
//   128-byte swizzle a box row is 128 bytes (64 bf16 or 32 f32 values), so
//   a tile is Dp / 64 (bf16) or Dp / 32 (f32) column chunks. The host
//   encodes the maps per call with cuTensorMapEncodeTiled, reached through
//   cudaGetDriverEntryPoint, so the library needs no -lcuda; they reach the
//   kernel as __grid_constant__ CUtensorMap parameters.
// - Persistent CTAs, one per SM, walk the work items (batch*head, 128-row
//   q tile) in order; the producer streams the next item's Q and K/V while
//   the consumers compute the current one. That is what K1 needs (one K/V
//   tile per item at L 64, so its time is its loads); K2 has many K/V tiles
//   per item. A warpgroup whose 64 rows all lie past Lq (K1's second
//   warpgroup at L 64) takes and releases the tiles without computing.
// - Online softmax in registers. Each thread holds two rows of S; the row
//   max and sum are two quad shuffles. Scores are kept in log2 units (log2(e)
//   folded into the scale and the bias, p = ex2(s - m)); m is written back
//   in natural-log units (m * ln 2).
//
// bf16 (128-key tiles; 4 stages at head dim 64, 2 at 128; two Q buffers):
// S = Q K^T is wgmma.m64n128k16.f32.bf16.bf16; P converts to bf16 in place,
// since the f32 accumulator's layout and the bf16 A fragment's line up; V
// [keys, head dim] is the B operand in MN-major form (the transpose bit).
//
// f32 ("3xTF32", 64-key tiles and 2 stages at head dim 64, 32-key tiles and
// 1 stage at 128; one Q buffer). The tensor cores multiply f32 only as TF32
// (10 mantissa bits, about 3 digits), which the f32 tolerance of 1e-4
// refuses. So each operand x is split into big = tf32(x), rounded to
// nearest (cvt.rna), and small = tf32(x - big) (x - big is exact in f32),
// and each product is small*big + big*small + big*big, issued in that order
// into one f32 accumulator (wgmma.m64nNk8.f32.tf32.tf32, three per k-step
// of 8). What is dropped, small*small and the rounding of small, is about
// 2^-22 of each product, so the result keeps about f32 accuracy; a single
// TF32 product keeps 2^-11. Both halves are written as exact TF32 values,
// so the result does not depend on how the tensor cores read an f32 word's
// low 13 bits. The split costs a pass over every tile in shared memory,
// which the producer warpgroup's three other warps make (96 threads): Q and
// K are split in place (big over the TMA tile, small into a buffer at the
// same offsets, so the swizzle is kept), V is split and transposed. The
// consumers wait for a tile's split (a second mbarrier per buffer) as well
// as its TMA bytes. Why V is transposed, and permuted:
// - TF32 wgmma takes both operands K-major only (no transpose bit), so the
//   P.V product needs V^T [head dim, keys] with keys contiguous. The split
//   pass writes V^T big and small tiles, 32 keys per 128-byte row, in the
//   128-byte swizzle, as the wgmma descriptor reads a K-major B operand.
// - P comes from registers. A thread holds S columns 2t and 2t + 1 of each
//   8-key group (t = lane % 4), while the k8 A fragment wants columns t and
//   t + 4. Rather than shuffle P, the split pass stores key 2t + h of each
//   group at V^T column t + 4h, the same permutation of keys on both sides
//   of the product, so a thread's S registers are its A fragment as they
//   are; P's big and small halves are split in registers.
// The shared-memory budget sets the tile sizes: at head dim 64 the Q tile
// with its small half is 64 KB and one 64-key stage (K with its small half,
// the V tile, V^T big and small) is 80 KB, 224 KB in all of the 227 KB.
//
// Masking. Every K/V tile adds the (1 - mask) * NEG_INF bias per key; the
// wrapper pads the mask with zeros to a multiple of the key tile (128 in
// bf16, 64 in f32), so keys past Lk are masked. No tile is skipped: a tile
// whose keys are all masked sets m to about NEG_INF and fills the
// accumulator and l with garbage (l counts the masked keys, since
// exp(-1e30 - (-1e30)) = 1), and the first tile with a real key rescales
// both by exp(-1e30 - m_real) = 0. A row with no real key never gets that
// rescale: after the last tile m <= NEG_INF / 2 marks it, and its o (and m
// and l) are written as 0 instead of the garbage.
//
// Ragged D. TMA needs each row's byte stride to be a multiple of 16, so the
// wrapper (ops/flash_attention.py) zero-pads D up to a multiple of 8 (bf16)
// or 4 (f32) and slices o after, as the JAX entry pads D to 128; zero
// columns add nothing to q k^T, and the scale stays 1/sqrt(D) of the
// unpadded D. The kernel is compiled for padded head dims of 64 and 128; a
// box's columns past the padded D are zero-filled by TMA.

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
// PTX wrappers for mbarriers, TMA and wgmma.

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

// Order this thread's generic-proxy writes to shared memory before later
// async-proxy accesses (wgmma reads, TMA writes) of the same bytes.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// x rounded to TF32 (nearest, ties away from zero), as an f32 whose low 13
// mantissa bits are zero.
__device__ __forceinline__ float tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return __uint_as_float(r & 0xffffe000u);
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

// Byte offset of (row, byte column) in a tile of 128-byte rows written by
// TMA's 128-byte swizzle: the 16-byte unit index is XORed with row % 8.
__device__ __forceinline__ uint32_t sw128_offset(int row, int col_bytes) {
  return (uint32_t)(row * 128 + ((((col_bytes >> 4) ^ row) & 7) << 4) + (col_bytes & 15));
}

#define WG_F8(i)                                                                          \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])
#define WG_REGS16 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
#define WG_REGS32                                                                         \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define WG_REGS64_HI                                                                       \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, " \
  "%49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"

// bf16: d[64] (+)= A B: A 64x16 and B 128x16, both K-major in shared memory.
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" WG_REGS32 ", " WG_REGS64_HI
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : WG_F8(0), WG_F8(8), WG_F8(16), WG_F8(24), WG_F8(32), WG_F8(40), WG_F8(48), WG_F8(56)
      : "l"(da), "l"(db), "r"(scale_d));
}

// bf16: d[N/2] += A B with A 64x16 bf16 in registers (a0..a3) and B 16xN
// from shared memory in MN-major form (transpose bit set).
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

// TF32: d[N/2] (+)= A B, A 64x8 and B Nx8, both K-major in shared memory
// (TF32 has no transpose bit). N = 64 (head dim 64's key tile) or 32.
__device__ __forceinline__ void wgmma_ss_tf32(float (&d)[32], uint64_t da, uint64_t db,
                                              int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {" WG_REGS32
      "}, %32, %33, p, 1, 1;\n}\n"
      : WG_F8(0), WG_F8(8), WG_F8(16), WG_F8(24)
      : "l"(da), "l"(db), "r"(scale_d));
}
__device__ __forceinline__ void wgmma_ss_tf32(float (&d)[16], uint64_t da, uint64_t db,
                                              int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {" WG_REGS16
      "}, %16, %17, p, 1, 1;\n}\n"
      : WG_F8(0), WG_F8(8)
      : "l"(da), "l"(db), "r"(scale_d));
}

// TF32: d[N/2] += A B with A 64x8 in registers (a0..a3: rows r and r + 8,
// columns t and t + 4) and B Nx8 K-major in shared memory; N = head dim.
__device__ __forceinline__ void wgmma_rs_tf32(float (&d)[32], const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {" WG_REGS32
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : WG_F8(0), WG_F8(8), WG_F8(16), WG_F8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_rs_tf32(float (&d)[64], const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {" WG_REGS32 ", " WG_REGS64_HI
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : WG_F8(0), WG_F8(8), WG_F8(16), WG_F8(24), WG_F8(32), WG_F8(40), WG_F8(48), WG_F8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// ---------------------------------------------------------------------------
// The kernel.

// Tiles and the shared-memory layout (bytes from a 1024-aligned base) of the
// instance for element type T and padded head dim DH (64 or 128). A tile of
// R rows is CHUNKS column chunks of R rows x 128 bytes, each as TMA's
// 128-byte swizzle writes it; K, V and the mask tile of one stage share one
// mbarrier. f32 adds each tile's small half (Q and K at the same offsets as
// the tile), the V^T big and small tiles (BK / 32 chunks of DH rows x 32
// keys) and a "split done" mbarrier per Q buffer and per stage.
template <typename T, int DH>
struct WgCfg {
  static constexpr bool F32 = sizeof(T) == 4;
  static constexpr int BQ = 128;  // query rows per work item, 64 per consumer warpgroup
  static constexpr int BK = !F32 ? 128 : (DH == 64 ? 64 : 32);  // keys per K/V tile
  static constexpr int COLS = 128 / (int)sizeof(T);  // elements per swizzled row
  static constexpr int CHUNKS = DH / COLS;
  static constexpr int K_STEPS = DH * (int)sizeof(T) / 32;  // wgmma k-steps over the head dim
  static constexpr int STAGES = !F32 ? (DH == 64 ? 4 : 2) : (DH == 64 ? 2 : 1);
  static constexpr int QBUF = F32 ? 1 : 2;
  static constexpr int THREADS = 384;  // producer warpgroup + 2 consumer warpgroups
  // setmaxnreg: 128 x PRODUCER_REGS + 256 x CONSUMER_REGS <= 65536. The f32
  // producer warpgroup also splits tiles.
  static constexpr int PRODUCER_REGS = F32 ? 56 : 40;
  static constexpr int CONSUMER_REGS = F32 ? 224 : 232;
  static constexpr uint32_t Q_CHUNK = BQ * 128;
  static constexpr uint32_t KV_CHUNK = BK * 128;
  static constexpr uint32_t VT_CHUNK = DH * 128;  // f32: DH rows x 32 keys
  static constexpr uint32_t Q_BYTES = CHUNKS * Q_CHUNK;
  static constexpr uint32_t KV_BYTES = CHUNKS * KV_CHUNK;  // one K (or V) tile
  static constexpr uint32_t VT_BYTES = F32 ? (BK / 32) * VT_CHUNK : 0;
  static constexpr uint32_t MASK_BYTES = BK * 4;
  static constexpr uint32_t OFF_Q = 0;
  static constexpr uint32_t OFF_QS = OFF_Q + QBUF * Q_BYTES;
  static constexpr uint32_t OFF_K = OFF_QS + (F32 ? QBUF * Q_BYTES : 0);
  static constexpr uint32_t OFF_KS = OFF_K + STAGES * KV_BYTES;
  static constexpr uint32_t OFF_V = OFF_KS + (F32 ? STAGES * KV_BYTES : 0);
  static constexpr uint32_t OFF_VT = OFF_V + STAGES * KV_BYTES;  // big, then small
  static constexpr uint32_t OFF_MASK = OFF_VT + 2 * STAGES * VT_BYTES;
  static constexpr uint32_t OFF_BAR = OFF_MASK + STAGES * MASK_BYTES;
  // q_full, q_empty, q_ready [QBUF]; kv_full, kv_empty, kv_ready [STAGES];
  // + alignment slack
  static constexpr uint32_t SMEM = OFF_BAR + 8 * (3 * QBUF + 3 * STAGES) + 1024;
  static_assert(SMEM <= 232448, "over the 227 KB a block can use");
};

// f32: the 96 splitting threads' pass over a Q or K tile, in place: each
// 16-byte unit of `big` (n_units of them, in runs of `run` units that start
// `stride` bytes apart) becomes its TF32 big half, and its small half goes
// to the same offset of `small`.
__device__ __forceinline__ void split_in_place(uint8_t* big, uint8_t* small, int n_units, int run,
                                               uint32_t stride, int tt) {
  for (int u = tt; u < n_units; u += 96) {
    const uint32_t off = (uint32_t)(u / run) * stride + (uint32_t)(u % run) * 16;
    const float4 x = *reinterpret_cast<const float4*>(big + off);
    float4 b, s;
    b.x = tf32_rna(x.x);
    b.y = tf32_rna(x.y);
    b.z = tf32_rna(x.z);
    b.w = tf32_rna(x.w);
    s.x = tf32_rna(x.x - b.x);
    s.y = tf32_rna(x.y - b.y);
    s.z = tf32_rna(x.z - b.z);
    s.w = tf32_rna(x.w - b.w);
    *reinterpret_cast<float4*>(big + off) = b;
    *reinterpret_cast<float4*>(small + off) = s;
  }
}

// f32: V [BK keys, DH] (CHUNKS chunks of 32 columns) into V^T big and small
// [DH, BK] (BK / 32 chunks of 32 keys), key 8g + 2t + h of a tile at V^T
// column 8g + t + 4h (see the note at the top). A thread reads 4 head-dim
// columns of one key; a warp covers the 8 keys of a group at 4 column quads.
template <class C>
__device__ __forceinline__ void split_transpose_v(const uint8_t* v, uint8_t* vt_big,
                                                  uint8_t* vt_small, int tt) {
  constexpr int QUADS = C::CHUNKS * 8;  // 4-column quads of the padded head dim
  for (int u = tt; u < C::BK * QUADS; u += 96) {
    const int e = u % 8;
    const int dq = (u / 8) % QUADS;
    const int g = u / (8 * QUADS);
    const int key = 8 * g + e;
    const float4 x = *reinterpret_cast<const float4*>(
        v + (dq / 8) * C::KV_CHUNK + sw128_offset(key, 16 * (dq % 8)));
    const int col = 8 * g + (e >> 1) + 4 * (e & 1);
    const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int d = 4 * dq + i;
      const uint32_t off = (col / 32) * C::VT_CHUNK + sw128_offset(d, 4 * (col % 32));
      const float b = tf32_rna(xs[i]);
      *reinterpret_cast<float*>(vt_big + off) = b;
      *reinterpret_cast<float*>(vt_small + off) = tf32_rna(xs[i] - b);
    }
  }
}

// One persistent CTA per SM walks work items (batch*head bh, q tile); see
// the note at the top. Maps: 3-D [B*H, L, Dg] of T, boxes of one chunk's
// columns x BQ (Q) or BK (K, V) rows. mask [B, mask_ld] f32, mask_ld a
// multiple of BK, zero past Lk. o [B*H, Lq, Dg] of T; m_out, l_out [B*H, Lq]
// f32 (WITH_STATS only).
template <typename T, int DH, bool WITH_STATS>
__global__ void __launch_bounds__(WgCfg<T, DH>::THREADS, 1)
attn_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv, const float* __restrict__ mask,
                  T* __restrict__ o, float* __restrict__ m_out, float* __restrict__ l_out, int H,
                  int Lq, int Lk, int Dg, int mask_ld, int n_qt, int n_items, float scale_log2) {
  using C = WgCfg<T, DH>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzle atoms need 1024-byte alignment
  uint8_t* gbase = smem_raw + (base - raw);
  const uint32_t bars = base + C::OFF_BAR;
  auto q_full = [&](int i) { return bars + 8u * i; };
  auto q_empty = [&](int i) { return bars + 8u * (C::QBUF + i); };
  auto q_ready = [&](int i) { return bars + 8u * (2 * C::QBUF + i); };
  auto kv_full = [&](int s) { return bars + 8u * (3 * C::QBUF + s); };
  auto kv_empty = [&](int s) { return bars + 8u * (3 * C::QBUF + C::STAGES + s); };
  auto kv_ready = [&](int s) { return bars + 8u * (3 * C::QBUF + 2 * C::STAGES + s); };
  constexpr uint32_t CONSUMER_WARPS = 8;
  constexpr uint32_t SPLITTERS = 96;  // f32: warps 1-3 of the producer warpgroup

  if (threadIdx.x == 0) {
    for (int i = 0; i < C::QBUF; ++i) {
      mbar_init(q_full(i), 1);
      mbar_init(q_empty(i), CONSUMER_WARPS);
      mbar_init(q_ready(i), SPLITTERS);
    }
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(kv_full(s), 1);
      mbar_init(kv_empty(s), CONSUMER_WARPS);
      mbar_init(kv_ready(s), SPLITTERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int n_kv = (Lk + C::BK - 1) / C::BK;
  const int wg = threadIdx.x / 128;

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(C::PRODUCER_REGS));
    if (threadIdx.x == 0) {
      // Producer thread: issues every load.
      int kv_count = 0;
      int it = 0;
      for (int item = blockIdx.x; item < n_items; item += gridDim.x, ++it) {
        const int bh = item / n_qt;
        const int q0 = (item - bh * n_qt) * C::BQ;
        const int b = bh / H;
        const int qb = it % C::QBUF;
        mbar_wait(q_empty(qb), ((it / C::QBUF) & 1) ^ 1);
        mbar_expect_tx(q_full(qb), C::Q_BYTES);
#pragma unroll
        for (int c = 0; c < C::CHUNKS; ++c) {
          tma_load_3d(base + C::OFF_Q + qb * C::Q_BYTES + c * C::Q_CHUNK, &tq, q_full(qb),
                      C::COLS * c, q0, bh);
        }
        for (int j = 0; j < n_kv; ++j, ++kv_count) {
          const int st = kv_count % C::STAGES;
          mbar_wait(kv_empty(st), ((kv_count / C::STAGES) & 1) ^ 1);
          mbar_expect_tx(kv_full(st), 2 * C::KV_BYTES + C::MASK_BYTES);
#pragma unroll
          for (int c = 0; c < C::CHUNKS; ++c) {
            tma_load_3d(base + C::OFF_K + st * C::KV_BYTES + c * C::KV_CHUNK, &tk, kv_full(st),
                        C::COLS * c, j * C::BK, bh);
            tma_load_3d(base + C::OFF_V + st * C::KV_BYTES + c * C::KV_CHUNK, &tv, kv_full(st),
                        C::COLS * c, j * C::BK, bh);
          }
          bulk_load(base + C::OFF_MASK + st * C::MASK_BYTES,
                    mask + (size_t)b * mask_ld + (size_t)j * C::BK, C::MASK_BYTES, kv_full(st));
        }
      }
    } else if constexpr (C::F32) {
      if (threadIdx.x >= 32) {
        // Splitting threads: each landed Q and K/V tile into its TF32 halves
        // (Q only in the rows of warpgroups that compute).
        const int tt = threadIdx.x - 32;
        int kv_count = 0;
        int it = 0;
        for (int item = blockIdx.x; item < n_items; item += gridDim.x, ++it) {
          const int bh = item / n_qt;
          const int q0 = (item - bh * n_qt) * C::BQ;
          const int qb = it % C::QBUF;
          const int q_rows = q0 + 64 < Lq ? C::BQ : 64;
          mbar_wait(q_full(qb), (it / C::QBUF) & 1);
          split_in_place(gbase + C::OFF_Q + qb * C::Q_BYTES, gbase + C::OFF_QS + qb * C::Q_BYTES,
                         C::CHUNKS * q_rows * 8, q_rows * 8, C::Q_CHUNK, tt);
          fence_proxy_async();
          mbar_arrive(q_ready(qb));
          for (int j = 0; j < n_kv; ++j, ++kv_count) {
            const int st = kv_count % C::STAGES;
            mbar_wait(kv_full(st), (kv_count / C::STAGES) & 1);
            split_in_place(gbase + C::OFF_K + st * C::KV_BYTES,
                           gbase + C::OFF_KS + st * C::KV_BYTES, C::KV_BYTES / 16,
                           C::KV_BYTES / 16, 0, tt);
            split_transpose_v<C>(gbase + C::OFF_V + st * C::KV_BYTES,
                                 gbase + C::OFF_VT + st * C::VT_BYTES,
                                 gbase + C::OFF_VT + (C::STAGES + st) * C::VT_BYTES, tt);
            fence_proxy_async();
            mbar_arrive(kv_ready(st));
          }
        }
      }
    }
  } else {
    // Consumer warpgroups: w owns rows 64w .. 64w + 63 of each Q tile. Each
    // thread holds two of them (r and r + 8) and, of each 8-column group of
    // an accumulator, the columns cq and cq + 1.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(C::CONSUMER_REGS));
    const int w = wg - 1;
    const int t = threadIdx.x % 128;
    const int lane = t % 32;
    const int r = 16 * (t / 32) + lane / 4;
    const int cq = 2 * (lane % 4);
    constexpr float BIAS_LOG2 = NEG_INF * LOG2E;
    constexpr int NG = C::BK / 8;  // 8-key groups of a K/V tile
    int kv_count = 0;
    int it = 0;
    for (int item = blockIdx.x; item < n_items; item += gridDim.x, ++it) {
      const int bh = item / n_qt;
      const int q0 = (item - bh * n_qt) * C::BQ;
      const int qb = it % C::QBUF;
      // Warpgroup-uniform: a warpgroup with no row inside Lq only passes
      // the tiles on.
      const bool active = q0 + 64 * w < Lq;
      const uint32_t q_tile = base + C::OFF_Q + qb * C::Q_BYTES + w * 64 * 128;
      const uint32_t q_small = base + C::OFF_QS + qb * C::Q_BYTES + w * 64 * 128;
      mbar_wait(q_full(qb), (it / C::QBUF) & 1);
      if constexpr (C::F32) mbar_wait(q_ready(qb), (it / C::QBUF) & 1);

      float acc[DH / 2];
#pragma unroll
      for (int i = 0; i < DH / 2; ++i) acc[i] = 0.f;
      float m2[2] = {-INFINITY, -INFINITY};  // running max, log2 units
      float l[2] = {0.f, 0.f};

      for (int j = 0; j < n_kv; ++j, ++kv_count) {
        const int st = kv_count % C::STAGES;
        mbar_wait(kv_full(st), (kv_count / C::STAGES) & 1);
        if constexpr (C::F32) mbar_wait(kv_ready(st), (kv_count / C::STAGES) & 1);
        const uint32_t k_tile = base + C::OFF_K + st * C::KV_BYTES;
        float s[C::BK / 2];
        if (active) {
          // S = Q K^T, head dim in k-steps of 32 bytes inside a chunk's row.
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < C::K_STEPS; ++kk) {
            const uint32_t off = (kk / 4) * C::Q_CHUNK + (kk % 4) * 32;
            const uint32_t koff = (kk / 4) * C::KV_CHUNK + (kk % 4) * 32;
            const uint64_t qd = sw128_desc(q_tile + off, 16, 1024);
            const uint64_t kd = sw128_desc(k_tile + koff, 16, 1024);
            if constexpr (C::F32) {
              const uint32_t k_small = base + C::OFF_KS + st * C::KV_BYTES;
              wgmma_ss_tf32(s, sw128_desc(q_small + off, 16, 1024), kd, kk > 0);
              wgmma_ss_tf32(s, qd, sw128_desc(k_small + koff, 16, 1024), 1);
              wgmma_ss_tf32(s, qd, kd, 1);
            } else {
              wgmma_ss(s, qd, kd, kk > 0);
            }
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
          for (int g = 0; g < NG; ++g) {
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
          // p = 2^(s - m): l sums the f32 p; P.V takes p in the input type.
          // bf16: packed as wgmma's A fragment (registers of k-step kk:
          // columns 16kk + cq (+1) and 16kk + 8 + cq (+1) of rows r and r + 8).
          // f32: the k8 A fragment of group g is (row r, key cq), (r + 8, cq),
          // (r, cq + 1), (r + 8, cq + 1), which V^T's column permutation makes
          // fragment columns t and t + 4; big and small halves.
          constexpr int PA = C::F32 ? C::BK / 2 : C::BK / 4;
          uint32_t pa[PA];
          uint32_t pa_small[C::F32 ? PA : 1];
#pragma unroll
          for (int g = 0; g < NG; ++g) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const float p0 = ex2(s[4 * g + 2 * h] - m2[h]);
              const float p1 = ex2(s[4 * g + 2 * h + 1] - m2[h]);
              ls[h] += p0 + p1;
              if constexpr (C::F32) {
                const float b0 = tf32_rna(p0), b1 = tf32_rna(p1);
                pa[4 * g + h] = __float_as_uint(b0);
                pa[4 * g + 2 + h] = __float_as_uint(b1);
                pa_small[4 * g + h] = __float_as_uint(tf32_rna(p0 - b0));
                pa_small[4 * g + 2 + h] = __float_as_uint(tf32_rna(p1 - b1));
              } else {
                __nv_bfloat162 pb = __floats2bfloat162_rn(p0, p1);
                pa[2 * g + h] = *reinterpret_cast<uint32_t*>(&pb);
              }
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

          wgmma_fence();
          if constexpr (C::F32) {
            // O += P V^T's k-steps of 8 keys (32 bytes inside a chunk's row).
            const uint32_t vt_big = base + C::OFF_VT + st * C::VT_BYTES;
            const uint32_t vt_small = base + C::OFF_VT + (C::STAGES + st) * C::VT_BYTES;
#pragma unroll
            for (int kk = 0; kk < NG; ++kk) {
              const uint32_t off = (kk / 4) * C::VT_CHUNK + (kk % 4) * 32;
              const uint64_t vb = sw128_desc(vt_big + off, 16, 1024);
              wgmma_rs_tf32(acc, &pa_small[4 * kk], vb);
              wgmma_rs_tf32(acc, &pa[4 * kk], sw128_desc(vt_small + off, 16, 1024));
              wgmma_rs_tf32(acc, &pa[4 * kk], vb);
            }
          } else {
            // O += P V, keys in steps of 16 (two 8-row swizzle atoms, 2048
            // bytes); the head-dim chunks of V are KV_CHUNK bytes apart.
#pragma unroll
            for (int kk = 0; kk < C::BK / 16; ++kk) {
              wgmma_rs(acc, &pa[4 * kk],
                       sw128_desc(base + C::OFF_V + st * C::KV_BYTES + kk * 2048, C::KV_CHUNK,
                                  1024));
            }
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
          T* orow = o + ((size_t)bh * Lq + row) * Dg;
#pragma unroll
          for (int g = 0; g < DH / 8; ++g) {
            const int col = 8 * g + cq;
            if (col < Dg) {
              const float o0 = no_real_key ? 0.f : acc[4 * g + 2 * h] * inv;
              const float o1 = no_real_key ? 0.f : acc[4 * g + 2 * h + 1] * inv;
              if constexpr (C::F32) {
                *reinterpret_cast<float2*>(orow + col) = make_float2(o0, o1);
              } else {
                *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(o0, o1);
              }
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

// 3-D map of a contiguous [BH, L, Dg] tensor of T: boxes of one 128-byte
// chunk's columns x box_rows rows x 1 head, 128-byte swizzle, zero fill
// past every edge.
template <typename T>
cudaError_t encode_map(EncodeTiledFn enc, CUtensorMap* map, const void* ptr, int BH, int L,
                       int Dg, int box_rows) {
  constexpr cuuint64_t ES = sizeof(T);
  const cuuint64_t dims[3] = {(cuuint64_t)Dg, (cuuint64_t)L, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)Dg * ES, (cuuint64_t)L * Dg * ES};
  const cuuint32_t box[3] = {(cuuint32_t)(128 / ES), (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUtensorMapDataType type =
      ES == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const CUresult r = enc(map, type, 3, const_cast<void*>(ptr), dims, strides, box, elem,
                         CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename T, int DH, bool WITH_STATS>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, const void* kv_mask,
                         void* o, void* m_out, void* l_out, int B, int H, int Lq, int Lk, int Dg,
                         int mask_ld, float scale, cudaStream_t stream) {
  using C = WgCfg<T, DH>;
  // TMA and the bulk copy need 16-byte aligned bases; rows are 16-byte
  // multiples and each mask tile lies inside its row.
  if ((Dg * (int)sizeof(T)) % 16 != 0 || mask_ld % C::BK != 0 || mask_ld < Lk ||
      ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
        reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(kv_mask)) & 15) != 0) {
    return cudaErrorInvalidValue;
  }
  EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  CUtensorMap tq, tk, tv;
  cudaError_t err = encode_map<T>(enc, &tq, q, B * H, Lq, Dg, C::BQ);
  if (err == cudaSuccess) err = encode_map<T>(enc, &tk, k, B * H, Lk, Dg, C::BK);
  if (err == cudaSuccess) err = encode_map<T>(enc, &tv, v, B * H, Lk, Dg, C::BK);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(attn_wgmma_kernel<T, DH, WITH_STATS>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int n_qt = (Lq + C::BQ - 1) / C::BQ;
  const int n_items = B * H * n_qt;
  const int grid = n_items < sms ? n_items : sms;
  attn_wgmma_kernel<T, DH, WITH_STATS><<<grid, C::THREADS, C::SMEM, stream>>>(
      tq, tk, tv, static_cast<const float*>(kv_mask), static_cast<T*>(o),
      static_cast<float*>(m_out), static_cast<float*>(l_out), H, Lq, Lk, Dg, mask_ld, n_qt,
      n_items, scale * LOG2E);
  return cudaGetLastError();
}

// The instance by dtype and padded head dim (compiled: 64 and 128). A
// launch error is returned, never answered by another path.
template <typename T, bool WITH_STATS>
cudaError_t launch_by_dim(const void* q, const void* k, const void* v, const void* kv_mask,
                          void* o, void* m_out, void* l_out, int B, int H, int Lq, int Lk, int D,
                          int mask_ld, float scale, cudaStream_t s) {
  return D <= 64 ? launch_wgmma<T, 64, WITH_STATS>(q, k, v, kv_mask, o, m_out, l_out, B, H, Lq,
                                                   Lk, D, mask_ld, scale, s)
                 : launch_wgmma<T, 128, WITH_STATS>(q, k, v, kv_mask, o, m_out, l_out, B, H, Lq,
                                                    Lk, D, mask_ld, scale, s);
}

template <bool WITH_STATS>
int dispatch(const void* q, const void* k, const void* v, const void* kv_mask, void* o,
             void* m_out, void* l_out, int B, int H, int Lq, int Lk, int D, int mask_ld,
             float scale, int is_bf16, void* stream) {
  if (B < 1 || H < 1 || Lq < 1 || Lk < 1 || D < 1 || D > MAX_D || mask_ld < Lk) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch_by_dim<__nv_bfloat16, WITH_STATS>(q, k, v, kv_mask, o, m_out, l_out, B, H,
                                                         Lq, Lk, D, mask_ld, scale, s)
              : launch_by_dim<float, WITH_STATS>(q, k, v, kv_mask, o, m_out, l_out, B, H, Lq, Lk,
                                                 D, mask_ld, scale, s);
  return (int)err;
}

}  // namespace

// q [B,H,Lq,D], k and v [B,H,Lk,D] contiguous on 16-byte aligned bases, in
// f32 (is_bf16 = 0; D a multiple of 4) or bf16 (is_bf16 = 1; D a multiple of
// 8); kv_mask [B,mask_ld] contiguous f32 (1 = real key), mask_ld >= Lk and a
// multiple of the key tile (128 in bf16, 64 in f32) with zeros past Lk; o
// like q. Launches on `stream` without synchronising; returns the launch's
// cudaError_t (0 on success).
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
