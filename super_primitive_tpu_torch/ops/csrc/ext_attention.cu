// K4: extended-head attention, softmax(q_ext @ k_ext^T) @ v, without the
// (L, L) scores in memory.
//
// Replaces the Pallas TPU kernel that super_primitive_tpu/nets/sam/
// image_encoder.py `Attention.__call__` reaches with impl="flash":
// jax.experimental.pallas.ops.tpu.flash_attention.flash_attention with
// sm_scale=1 over the extended heads of `extended_qk` (SAM's global
// attention with the decomposed rel-pos folded into the QK contraction).
// q_ext, k_ext are (BH, L, D_qk), v (BH, L, D_v), bf16 or float32; out is
// (BH, L, D_v) in v's dtype.  At ViT-H's global blocks BH = 16, L = 4096,
// D_qk = 80 + 64 + 64 = 208, D_v = 80.
//
// Bound: operations.  2 * BH * L^2 * (D_qk + D_v) flops (154.6 GFLOP a ViT-H
// global block) against about 76 MB of inputs and output in bf16: the work
// is compute-bound by some 7x even at the bf16 tensor-core rate.  Both
// dtypes run on the tensor cores, each body built around its arithmetic:
//
// bf16: tensor cores (`ext_attention_tc`, namespace tc).
//  * One CTA per (bh, 128 queries): two consumer warpgroups of 64 query
//    rows each and a producer warpgroup, 384 threads; grid (ceil(L/128),
//    BH), 512 CTAs at ViT-H.  setmaxnreg moves registers from the producer
//    (24 a thread; one of its lanes starts every copy) to the consumers
//    (240), which hold Q, a 64 x 128 score tile, its P and the output
//    accumulators.  One CTA an SM: the register file holds one such CTA
//    (and the 2-stage ring takes 193 KB of shared memory at ViT-H).
//  * Q is read once, straight from global memory into the register
//    fragments of wgmma's A operand (ceil(D_qk/16) k-steps of 4 registers a
//    thread); it never touches shared memory.
//  * K and V tiles of 128 keys go through a ring of kStages stages in bf16.
//    The producer's lane 0 copies them with TMA
//    (cp.async.bulk.tensor.3d over (D, L, BH), 128-byte swizzle, boxes of
//    64 columns x 128 keys) onto a `full` mbarrier; each consumer warp
//    arrives on the stage's `empty` mbarrier when its products are done.
//    D_qk = 208 takes four boxes (columns past D are zero-filled by TMA,
//    as are keys past L), but the k-loop runs ceil(D_qk/16) = 13 steps:
//    the padding costs shared memory and no products.
//  * S = Q K^T: wgmma m64n128k16, A = Q from registers, B = the K tile
//    (K-major) from shared memory, float32 accumulators in registers.
//  * Online softmax in float32 on the accumulator fragment: a thread holds
//    32 scores of each of two rows; the row max is reduced over the row's
//    four threads with shuffles, the sum kept per thread and reduced once
//    at the end.  exp is the SFU's ex2 of log2(e)-prescaled scores (one
//    fmaf rounding of s * log2(e) - m, then ex2.approx: a few float32
//    ulp).  Keys past L get -inf.  The score tile never goes to shared
//    memory.
//  * O += P V: wgmma m64nNk16 with N = D_v rounded up to 16 (80 at ViT-H),
//    A = P converted to bf16 from the S fragment in registers (the
//    accumulator and A layouts coincide), B = the V tile from shared
//    memory as a transposed (MN-major) operand; O is rescaled by
//    exp(m_old - m_new) first.  P is rounded to bf16 for this product: up
//    to 2^-9 relative a weight.
//  * One correctly rounded division by l an output, then the rounding to
//    bf16 (nearest even).
//  Widths: D_qk and D_v multiples of 8 (TMA's 16-byte strides; the wrapper
//  pads other widths with zero lanes, which add nothing) and 16-byte
//  aligned pointers.
//
// float32: 3xTF32 on the tensor cores (`ext_attention_x3`, namespace x3).
// A TF32 operand keeps 10 mantissa bits (about 1e-3 relative), two orders
// above the float32 check, so every operand x is split as x = hi + lo with
// hi = cvt.rna.tf32(x), lo = cvt.rna.tf32(x - hi) (x to 2^-22 relative), and
// each product is a_hi b_lo + a_lo b_hi + a_hi b_hi in float32 accumulators
// (the lo lo term, 2^-22 relative, is dropped): three TF32 products at a
// third of the TF32 rate, 495 / 3 = 165 TFLOP/s against the CUDA cores' 67.
//  * A pre-pass (split_k, split_v) writes K's hi and lo as column blocks of
//    16 (k2: (BH, 2 nb, L, 16), nb = ceil(D_qk / 16)) and V^T's hi and lo
//    (v2: (BH, 2, 16 NV, L8)): for 32-bit types wgmma takes B only K-major
//    (no transpose bit), and P V's B is V^T.  Within each group of 8 keys
//    v2 holds the keys in the order P's A fragments need (below).  At
//    ViT-H 76 MB read and 151 MB written: 0.07 ms at the HBM rate
//    (chip_smoke.py phase 13's float32 rows time it with the main kernel).
//  * One CTA per (bh, 128 queries): two consumer warpgroups of 64 query
//    rows and a producer warpgroup, 384 threads, setmaxnreg 24 / 240, one
//    CTA an SM; grid (ceil(L/128), BH), 512 CTAs at ViT-H.
//  * Registers: Q_hi as wgmma A fragments, 4 a k-step of 8 columns: 128 a
//    thread at D_qk 256 (104 used at 208).  Beside them O and the tile's
//    P V (8 NV each: 40 at D_v 80), the S tile in two accumulators of 8
//    (16 keys) and P's hi and lo fragments (16).  Q_lo cannot join Q_hi
//    there, nor can 64-key tiles (32 + 64 more): hence 16-key tiles.
//    ptxas allocates 168 registers a thread (384 threads) and spills past
//    them: none up to D_v 80, a few hundred bytes at D_v 96 to 128.
//  * Shared memory, 64-byte swizzle everywhere (rows of 16 float32, so
//    D_qk 208 is 13 column blocks with no padding): the Q tile (128 rows,
//    8 KB a column block: 104 KB at 208) is loaded raw by TMA once and
//    split in place to Q_lo by its warpgroup, which reads it as wgmma's A
//    from shared memory; a K/V stage of 16 keys holds K hi and lo (2 nb
//    KB) and V^T hi and lo (2 KB a 16 value columns): 36 KB at ViT-H, so
//    the ring takes 3 stages (4 at most, 2 at D_qk 256 / D_v 128) in the
//    227 KB.  The producer's lane 0 fills a stage with two TMA copies (a
//    4-d box of all 2 nb K column blocks, one box of V^T's 2 x 16 NV rows)
//    onto its `full` mbarrier; each consumer warp arrives on `empty`.
//  * S = Q K^T: wgmma m64n16k8 per k-step: Q_hi K_lo (A from registers)
//    and Q_lo K_hi (A from shared memory) into one accumulator, Q_hi K_hi
//    into another, the two added once: the small terms are not rounded
//    against the large one 2 ceil(D_qk/8) times.  The k-steps run as one
//    unbroken chain of wgmmas, last column block first, which a
//    fall-through switch enters at the tile's count (a condition on each
//    wgmma breaks the chain; one chain a count, as bf16 has, is 816
//    wgmmas an instantiation against 96, and ran slower).
//  * Online softmax in float32 on the accumulator fragment, as bf16 does
//    (rows reduced over four lanes, the sum kept per thread), with expf of
//    s - m (accurate to a few ulp; no fast math); keys past L get -inf.
//  * P V: m64nNk8, N = 16 NV, A = P's hi / lo fragments from registers,
//    B = V^T hi / lo from the stage.  A .tf32 A fragment holds columns t
//    and t + 4 of the k-step where the S accumulator holds 2 t and 2 t + 1;
//    rather than shuffle P, split_v stores key 2 t at v2's position t and
//    key 2 t + 1 at t + 4 of each group of 8 (the sum over keys runs in
//    any order).  The tensor cores accumulate by truncation (toward zero,
//    measured on an H100), a bias that grows with the length of a chain:
//    each tile's P V goes to a fresh accumulator (6 wgmmas) and joins O in
//    one correctly rounded fmaf(O, exp(m_old - m_new), PV).
//  * One correctly rounded division by l an output.
//  Widths: D_qk a multiple of 4 (TMA's 16-byte strides, split_k's vectors;
//  the wrapper pads other widths with zero lanes) and q, k 16-byte aligned;
//  any D_v.
#include <cuda.h>  // CUtensorMap and its enums; the encoder is found at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kMaxDqk = 256;
constexpr int kMaxDv = 128;

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// ---------------------------------------------------------------------------
// bf16: the tensor-core body

namespace tc {

constexpr int kBQ = 128;             // queries a CTA: two warpgroups of 64
constexpr int kBN = 128;             // keys a tile
constexpr int kStages = 2;           // K/V ring depth: 2 x 96 KB at D_qk > 192
constexpr int kConsumerWarps = 8;    // warps 0-7: warpgroups 0 and 1
constexpr int kThreads = 32 * (kConsumerWarps + 4);  // + the producer warpgroup
// registers a thread after setmaxnreg: the consumers take what the producer
// warpgroup gives up (ptxas allocates 168 a thread to 384 threads)
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
static_assert(2 * 128 * kConsumerRegs + 128 * kProducerRegs <= 65536, "register file");
constexpr int kBoxCols = 64;         // bf16 columns of one 128-byte swizzled box
constexpr int kBoxBytes = kBN * 128; // one box of kBN rows
constexpr int kMaxKSteps = kMaxDqk / 16;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// spin until the phase of parity `parity` of the barrier has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// one box of a (D, L, BH) tensor map at (column c0, row c1, head c2) into
// shared memory at dst, completing on bar
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle: start address,
// leading and stride byte offsets (16-byte units in the fields)
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16 |
         static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keep the compiler from moving reads or writes of wgmma's registers across
// the fence, commit and wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// 2^x by the SFU's ex2.approx.ftz: relative error below 2^-22 (two float32
// ulp); results below 2^-126 flush to zero, far under the resolution of a
// row sum that is at least 1
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// wgmma.mma_async m64nNk16, float32 += bf16 x bf16, A (64 x 16) from
// registers, B (16 x N) from shared memory through a descriptor; TB = 1
// reads B transposed (N-major).  d holds N/2 floats a thread.
template <int N>
struct WgmmaRS;

template <>
struct WgmmaRS<16> {
  template <int TB>
  static __device__ __forceinline__ void run(float (&d)[8], const uint32_t (&a)[4], uint64_t b,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %14, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1, %13;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "n"(TB), "r"(scale_d));
  }
};

template <>
struct WgmmaRS<32> {
  template <int TB>
  static __device__ __forceinline__ void run(float (&d)[16], const uint32_t (&a)[4], uint64_t b,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %22, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, %21;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
          "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "n"(TB), "r"(scale_d));
  }
};

template <>
struct WgmmaRS<48> {
  template <int TB>
  static __device__ __forceinline__ void run(float (&d)[24], const uint32_t (&a)[4], uint64_t b,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %30, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23}, "
        "{%24, %25, %26, %27}, %28, p, 1, 1, %29;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
          "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
          "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "n"(TB), "r"(scale_d));
  }
};

template <>
struct WgmmaRS<64> {
  template <int TB>
  static __device__ __forceinline__ void run(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %38, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, %37;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
          "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
          "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "n"(TB), "r"(scale_d));
  }
};

template <>
struct WgmmaRS<80> {
  template <int TB>
  static __device__ __forceinline__ void run(float (&d)[40], const uint32_t (&a)[4], uint64_t b,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %46, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39}, "
        "{%40, %41, %42, %43}, %44, p, 1, 1, %45;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
          "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
          "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "n"(TB), "r"(scale_d));
  }
};

template <>
struct WgmmaRS<96> {
  template <int TB>
  static __device__ __forceinline__ void run(float (&d)[48], const uint32_t (&a)[4], uint64_t b,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %54, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
        "{%48, %49, %50, %51}, %52, p, 1, 1, %53;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
          "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
          "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "n"(TB), "r"(scale_d));
  }
};

template <>
struct WgmmaRS<112> {
  template <int TB>
  static __device__ __forceinline__ void run(float (&d)[56], const uint32_t (&a)[4], uint64_t b,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %62, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55}, "
        "{%56, %57, %58, %59}, %60, p, 1, 1, %61;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
          "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
          "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
          "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "n"(TB), "r"(scale_d));
  }
};

template <>
struct WgmmaRS<128> {
  template <int TB>
  static __device__ __forceinline__ void run(float (&d)[64], const uint32_t (&a)[4], uint64_t b,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %70, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, %69;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
          "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
          "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
          "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
          "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "n"(TB), "r"(scale_d));
  }
};

// S = Q K^T over N k-steps of 16 columns; the K stage at kst holds boxes of
// kBN rows x 64 columns: k-step kk is 32 bytes into box kk / 4
template <int N>
__device__ __forceinline__ void qk_steps(float (&sc)[kBN / 2],
                                         const uint32_t (&qa)[kMaxKSteps][4], uint32_t kst) {
#pragma unroll
  for (int kk = 0; kk < N; ++kk)
    WgmmaRS<kBN>::run<0>(sc, qa[kk],
                         desc_sw128(kst + (kk / 4) * kBoxBytes + (kk % 4) * 32, 16, 1024),
                         kk > 0);
}

// Shared memory of one CTA: kStages K stages of nbk boxes, kStages V
// stages of nbv boxes (each 1024-byte aligned, as the 128-byte swizzle
// needs), then the full and empty barriers; plus the slack to align the
// dynamic base.
constexpr size_t smem_bytes(int nbk, int nbv) {
  return 1024 + static_cast<size_t>(kStages) * (nbk + nbv) * kBoxBytes + 2 * kStages * 8;
}

// grid (ceil(L / kBQ), BH), kThreads threads, smem_bytes(nbk, nbv).
// kmap / vmap: (D_qk | D_v, L, BH) bf16 tensor maps of k_ext / v with boxes
// of kBoxCols x kBN x 1 and 128-byte swizzle.  NV = ceil(D_v / 16).
template <int NV>
__global__ void __launch_bounds__(kThreads, 1)
    ext_attention_tc(const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap,
                     const __nv_bfloat16* __restrict__ q, __nv_bfloat16* __restrict__ out, int L,
                     int d_qk, int d_v) {
  constexpr int kNbv = (16 * NV + kBoxCols - 1) / kBoxCols;
  extern __shared__ uint8_t smem_raw[];
  const int nbk = (d_qk + kBoxCols - 1) / kBoxCols;
  const int nks = (d_qk + 15) / 16;  // k-steps of S = Q K^T
  const uint32_t k_stage = nbk * kBoxBytes, v_stage = kNbv * kBoxBytes;
  const uint32_t kbuf = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t vbuf = kbuf + kStages * k_stage;
  const uint32_t bars = vbuf + kStages * v_stage;  // full[kStages], empty[kStages]
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kStages + s); };

  const int bh = blockIdx.y, q0 = blockIdx.x * kBQ;
  const int n_tiles = (L + kBN - 1) / kBN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {
    // producer warpgroup: its registers go to the consumers, and lane 0 of
    // its first warp keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs) : "memory");
    if (warp == kConsumerWarps && lane == 0) {
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages, round = j / kStages;
        if (round > 0) mbar_wait(empty(s), (round - 1) & 1);
        mbar_expect_tx(full(s), k_stage + v_stage);
        for (int b = 0; b < nbk; ++b)
          tma_load(kbuf + s * k_stage + b * kBoxBytes, &kmap, full(s), b * kBoxCols, j * kBN, bh);
        for (int b = 0; b < kNbv; ++b)
          tma_load(vbuf + s * v_stage + b * kBoxBytes, &vmap, full(s), b * kBoxCols, j * kBN, bh);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs) : "memory");
  // consumers: warpgroup wg owns query rows q0 + 64 wg .. + 63; in it, warp
  // w owns rows 16 w .. 16 w + 15, and lane (g, t) = (lane / 4, lane % 4)
  // rows g and g + 8 of those, columns 2 t, 2 t + 1 of every 8
  const int g = lane / 4, t = lane % 4;
  const int row0 = q0 + 64 * (warp / 4) + 16 * (warp % 4) + g;
  const int rows[2] = {row0, row0 + 8};

  // Q as wgmma A fragments: k-step kk, registers {(g, 2t), (g+8, 2t),
  // (g, 2t+8), (g+8, 2t+8)} of its 16 columns, each two bf16
  uint32_t qa[kMaxKSteps][4];
  const __nv_bfloat16* qb = q + static_cast<size_t>(bh) * L * d_qk;
#pragma unroll
  for (int kk = 0; kk < kMaxKSteps; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = rows[e & 1], c = 16 * kk + 2 * t + 8 * (e >> 1);
      const uint32_t* src =
          reinterpret_cast<const uint32_t*>(qb + static_cast<size_t>(r) * d_qk + c);
      qa[kk][e] = (kk < nks && r < L && c < d_qk) ? __ldg(src) : 0u;
    }

  float o[8 * NV];
#pragma unroll
  for (int i = 0; i < 8 * NV; ++i) o[i] = 0.0f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};  // running max, times log2(e)
  float l[2] = {0.0f, 0.0f};                    // this thread's share of the running sum

  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % kStages;
    mbar_wait(full(s), (j / kStages) & 1);

    // S = Q K^T over nks k-steps, one straight run of wgmmas for each count:
    // ptxas breaks a chain of wgmmas that each sit under a condition
    float sc[kBN / 2];
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) sc[i] = 0.0f;
    const uint32_t kst = kbuf + s * k_stage;
    fence_regs(sc);
    wg_fence();
    switch (nks) {
      case 1: qk_steps<1>(sc, qa, kst); break;
      case 2: qk_steps<2>(sc, qa, kst); break;
      case 3: qk_steps<3>(sc, qa, kst); break;
      case 4: qk_steps<4>(sc, qa, kst); break;
      case 5: qk_steps<5>(sc, qa, kst); break;
      case 6: qk_steps<6>(sc, qa, kst); break;
      case 7: qk_steps<7>(sc, qa, kst); break;
      case 8: qk_steps<8>(sc, qa, kst); break;
      case 9: qk_steps<9>(sc, qa, kst); break;
      case 10: qk_steps<10>(sc, qa, kst); break;
      case 11: qk_steps<11>(sc, qa, kst); break;
      case 12: qk_steps<12>(sc, qa, kst); break;
      case 13: qk_steps<13>(sc, qa, kst); break;
      case 14: qk_steps<14>(sc, qa, kst); break;
      case 15: qk_steps<15>(sc, qa, kst); break;
      default: qk_steps<16>(sc, qa, kst); break;
    }
    wg_commit();
    wg_wait_all();
    fence_regs(sc);

    // sc[4 i + e]: row rows[e >> 1], key j kBN + 8 i + 2 t + (e & 1)
    if ((j + 1) * kBN > L) {
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i)
        if (j * kBN + 8 * (i / 4) + 2 * t + (i & 1) >= L) sc[i] = -CUDART_INF_F;
    }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int i = 0; i < kBN / 8; ++i)
        mx = fmaxf(mx, fmaxf(sc[4 * i + 2 * h], sc[4 * i + 2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[h], mx * kLog2e);
      alpha[h] = ex2(m[h] - m_new);  // 0 on the first tile (m = -inf)
      m[h] = m_new;
      float sum = 0.0f;
#pragma unroll
      for (int i = 0; i < kBN / 8; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = sc[4 * i + 2 * h + e];
          x = ex2(fmaf(x, kLog2e, -m_new));
          sum += x;
        }
      l[h] = l[h] * alpha[h] + sum;
    }
#pragma unroll
    for (int i = 0; i < 8 * NV; ++i) o[i] *= alpha[(i >> 1) & 1];

    // P as wgmma A fragments, straight from the accumulator layout: key
    // k-step kk is score columns 16 kk .. 16 kk + 15
    uint32_t pa[kBN / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) pa[kk][e] = pack_bf16(sc[8 * kk + 2 * e], sc[8 * kk + 2 * e + 1]);

    // O += P V; the V stage holds kNbv boxes of kBN keys x 64 columns, read
    // N-major: 8-key groups 1024 bytes apart, 64-column boxes kBoxBytes
    const uint32_t vst = vbuf + s * v_stage;
    fence_regs(o);
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) fence_regs(pa[kk]);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk)
      WgmmaRS<16 * NV>::template run<1>(o, pa[kk],
                                        desc_sw128(vst + kk * 16 * 128, kBoxBytes, 1024), 1);
    wg_commit();
    wg_wait_all();
    fence_regs(o);
    if (lane == 0) mbar_arrive(empty(s));
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  // o[4 i + e]: row rows[e >> 1], value column 8 i + 2 t + (e & 1)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (rows[h] >= L) continue;
    __nv_bfloat16* orow = out + (static_cast<size_t>(bh) * L + rows[h]) * d_v;
#pragma unroll
    for (int i = 0; i < 2 * NV; ++i) {
      const int c = 8 * i + 2 * t;
      if (c < d_v)
        *reinterpret_cast<__nv_bfloat162*>(orow + c) =
            __floats2bfloat162_rn(o[4 * i + 2 * h] / l[h], o[4 * i + 2 * h + 1] / l[h]);
    }
  }
}

// cuTensorMapEncodeTiled, from libcuda through the runtime (no -lcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// (D, L, BH) bf16 tensor map of a contiguous (BH, L, D) tensor, boxes of
// kBoxCols x kBN x 1, 128-byte swizzle, zeros past every edge
bool tensor_map(CUtensorMap* map, EncodeTiled encode, const void* ptr, int D, int L, int BH) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(L),
                              static_cast<cuuint64_t>(BH)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(L) * D * 2};
  const cuuint32_t box[3] = {kBoxCols, kBN, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// error codes of the bf16 launch besides CUDA's own
constexpr int kNoEncoder = -1;  // libcuda has no cuTensorMapEncodeTiled
constexpr int kBadMap = -2;     // libcuda refused a tensor map

template <int NV>
int launch_nv(const void* q, const void* k, const void* v, void* out, int BH, int L, int d_qk,
              int d_v, cudaStream_t st) {
  EncodeTiled encode = encoder();
  if (encode == nullptr) return kNoEncoder;
  CUtensorMap kmap, vmap;
  if (!tensor_map(&kmap, encode, k, d_qk, L, BH) || !tensor_map(&vmap, encode, v, d_v, L, BH))
    return kBadMap;
  auto kernel = ext_attention_tc<NV>;
  const size_t smem =
      smem_bytes((d_qk + kBoxCols - 1) / kBoxCols, (16 * NV + kBoxCols - 1) / kBoxCols);
  static size_t smem_set = 0;  // the opt-in this instantiation holds
  if (smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = smem;
  }
  const dim3 grid((L + kBQ - 1) / kBQ, BH);
  kernel<<<grid, kThreads, smem, st>>>(kmap, vmap, static_cast<const __nv_bfloat16*>(q),
                                       static_cast<__nv_bfloat16*>(out), L, d_qk, d_v);
  return static_cast<int>(cudaGetLastError());
}

int launch_bf16(const void* q, const void* k, const void* v, void* out, int BH, int L, int d_qk,
                int d_v, cudaStream_t st) {
  switch ((d_v + 15) / 16) {
    case 1: return launch_nv<1>(q, k, v, out, BH, L, d_qk, d_v, st);
    case 2: return launch_nv<2>(q, k, v, out, BH, L, d_qk, d_v, st);
    case 3: return launch_nv<3>(q, k, v, out, BH, L, d_qk, d_v, st);
    case 4: return launch_nv<4>(q, k, v, out, BH, L, d_qk, d_v, st);
    case 5: return launch_nv<5>(q, k, v, out, BH, L, d_qk, d_v, st);
    case 6: return launch_nv<6>(q, k, v, out, BH, L, d_qk, d_v, st);
    case 7: return launch_nv<7>(q, k, v, out, BH, L, d_qk, d_v, st);
    default: return launch_nv<8>(q, k, v, out, BH, L, d_qk, d_v, st);
  }
}

}  // namespace tc

// ---------------------------------------------------------------------------
// float32: 3xTF32 on the tensor cores

namespace x3 {

using tc::encoder;
using tc::EncodeTiled;
using tc::fence_regs;
using tc::mbar_arrive;
using tc::mbar_expect_tx;
using tc::mbar_init;
using tc::mbar_wait;
using tc::smem_u32;
using tc::tma_load;
using tc::wg_commit;
using tc::wg_fence;
using tc::wg_wait_all;

constexpr int kBQ = 128;             // queries a CTA: two warpgroups of 64
constexpr int kBN = 16;              // keys a tile
constexpr int kMaxStages = 4;        // K/V ring depth, as shared memory allows
constexpr int kConsumerWarps = 8;    // warps 0-7: warpgroups 0 and 1
constexpr int kThreads = 32 * (kConsumerWarps + 4);  // + the producer warpgroup
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
static_assert(2 * 128 * kConsumerRegs + 128 * kProducerRegs <= 65536, "register file");
constexpr int kCols = 16;            // float32 columns of one 64-byte swizzled row
constexpr int kQBlock = kBQ * 64;    // one column block of the Q tile: 128 rows x 64 bytes
constexpr int kKBlock = kBN * 64;    // one column block of a K tile: 16 keys x 64 bytes
constexpr int kMaxKSteps = kMaxDqk / 8;
constexpr size_t kSmemLimit = 232448;  // dynamic shared memory a CTA may opt into

// x rounded to TF32 (10 mantissa bits, to nearest, ties away), as its bits
__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo to 2^-22 relative, both TF32
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// wgmma shared-memory matrix descriptor, K-major, 64-byte swizzle: rows of
// 64 bytes, 8-row groups 512 bytes apart
__device__ __forceinline__ uint64_t desc_sw64(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | 1ull << 16 |
         static_cast<uint64_t>(512 >> 4) << 32 | 2ull << 62;
}

// one box of a 4-d tensor map at (c0, c1, c2, c3) into shared memory at dst,
// completing on bar
__device__ __forceinline__ void tma_load4(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                          int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma.mma_async m64nNk8, float32 += tf32 x tf32: rs with A (64 x 8) from
// registers, ss (N = 16 only) with A from shared memory; B (8 x N) from
// shared memory through a descriptor.  d holds N/2 floats a thread.
template <int N>
struct Wgmma;

template <>
struct Wgmma<16> {
  static __device__ __forceinline__ void rs(float (&d)[8], const uint32_t (&a)[4], uint64_t b,
                                            int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
  static __device__ __forceinline__ void ss(float (&d)[8], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, %8, %9, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void rs(float (&d)[16], const uint32_t (&a)[4], uint64_t b,
                                            int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
          "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<48> {
  static __device__ __forceinline__ void rs(float (&d)[24], const uint32_t (&a)[4], uint64_t b,
                                            int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23"
        "}, {%24, %25, %26, %27}, %28, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
          "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
          "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                            int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
          "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
          "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<80> {
  static __device__ __forceinline__ void rs(float (&d)[40], const uint32_t (&a)[4], uint64_t b,
                                            int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n80k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39"
        "}, {%40, %41, %42, %43}, %44, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
          "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
          "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<96> {
  static __device__ __forceinline__ void rs(float (&d)[48], const uint32_t (&a)[4], uint64_t b,
                                            int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
        "}, {%48, %49, %50, %51}, %52, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
          "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
          "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<112> {
  static __device__ __forceinline__ void rs(float (&d)[56], const uint32_t (&a)[4], uint64_t b,
                                            int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n112k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55"
        "}, {%56, %57, %58, %59}, %60, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
          "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
          "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
          "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b,
                                            int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
          "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
          "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
          "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
          "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

// S = Q K^T, column block B of the tile (k-steps 2 B, 2 B + 1), 3xTF32:
// Q_hi K_lo and Q_lo K_hi into `small`, Q_hi K_hi into `big`.  Q_hi is in
// registers, Q_lo in the Q tile at qlo (this warpgroup's 64 rows), K_hi and
// K_lo in the stage's column blocks at khi and klo.
template <int B>
__device__ __forceinline__ void s_block(float (&big)[8], float (&small)[8],
                                        const uint32_t (&qa)[kMaxKSteps][4], uint32_t qlo,
                                        uint32_t khi, uint32_t klo) {
#pragma unroll
  for (int kk = 2 * B; kk < 2 * B + 2; ++kk) {
    const uint32_t k_off = (kk / 2) * kKBlock + (kk % 2) * 32;
    Wgmma<kBN>::rs(small, qa[kk], desc_sw64(klo + k_off), 1);
    Wgmma<kBN>::ss(small, desc_sw64(qlo + (kk / 2) * kQBlock + (kk % 2) * 32),
                   desc_sw64(khi + k_off), 1);
    Wgmma<kBN>::rs(big, qa[kk], desc_sw64(khi + k_off), 1);
  }
}

// Shared memory of one CTA: the Q tile (nb column blocks), `stages` K/V
// stages (2 nb K column blocks, then V^T hi and lo as 2 x 16 NV rows of 16
// keys), the barriers; plus the slack to align the dynamic base.
__host__ __device__ constexpr size_t q_bytes(int nb) { return static_cast<size_t>(nb) * kQBlock; }
__host__ __device__ constexpr size_t stage_bytes(int nb, int nv) {
  return static_cast<size_t>(2 * nb) * kKBlock + static_cast<size_t>(2 * 16 * nv) * 64;
}
constexpr size_t smem_bytes(int nb, int nv, int stages) {
  return 1024 + q_bytes(nb) + stages * stage_bytes(nb, nv) + (2 * kMaxStages + 1) * 8;
}

// The pre-pass.  k2 (BH, 2 nb, L, 16): column block c < nb of key l is
// K_hi[l, 16 c .. 16 c + 15], block nb + c is K_lo there (zeros past d_q).
// grid (ceil(L 4 nb / 256), BH) x 256: one thread a 16-byte vector of k.
__global__ void split_k(const float* __restrict__ k, float* __restrict__ k2, int L, int d_q,
                        int nb) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= L * 4 * nb) return;
  const size_t bh = blockIdx.y;
  const int l = i / (4 * nb), c4 = i % (4 * nb);  // 4 columns from 4 c4
  float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (4 * c4 < d_q) x = *reinterpret_cast<const float4*>(k + (bh * L + l) * d_q + 4 * c4);
  uint4 hi, lo;
  split(x.x, hi.x, lo.x);
  split(x.y, hi.y, lo.y);
  split(x.z, hi.z, lo.z);
  split(x.w, hi.w, lo.w);
  const int cb = c4 / 4;
  float* dst = k2 + ((bh * 2 * nb + cb) * L + l) * kCols + 4 * (c4 % 4);
  *reinterpret_cast<uint4*>(dst) = hi;
  *reinterpret_cast<uint4*>(dst + static_cast<size_t>(nb) * L * kCols) = lo;
}

// v2 (BH, 2, dvp, lp): V^T, its hi rows then its lo rows, zeros past d_v and
// L, with the keys of each group of 8 in the order P's A fragments hold
// them: position p of a group holds key 2p (p < 4) or 2(p - 4) + 1.  Each
// block transposes 32 keys x dvp values of one head through shared memory.
constexpr int kVKeys = 32;
__global__ void split_v(const float* __restrict__ v, float* __restrict__ v2, int L, int d_v,
                        int dvp, int lp) {
  __shared__ float tile[kVKeys][kMaxDv + 1];
  const size_t bh = blockIdx.y;
  const int key0 = blockIdx.x * kVKeys;
  for (int i = threadIdx.x; i < kVKeys * dvp; i += blockDim.x) {
    const int kr = i / dvp, d = i % dvp;
    tile[kr][d] = (key0 + kr < L && d < d_v) ? v[(bh * L + key0 + kr) * d_v + d] : 0.0f;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kVKeys * dvp; i += blockDim.x) {
    const int p = i % kVKeys, d = i / kVKeys;
    if (key0 + p >= lp) continue;
    const int q = p % 8;
    uint32_t hi, lo;
    split(tile[(p & ~7) + (q < 4 ? 2 * q : 2 * q - 7)][d], hi, lo);
    float* dst = v2 + (bh * 2 * dvp + d) * lp + key0 + p;
    dst[0] = __uint_as_float(hi);
    dst[static_cast<size_t>(dvp) * lp] = __uint_as_float(lo);
  }
}

// grid (ceil(L / kBQ), BH), kThreads threads, smem_bytes(nb, NV, stages).
// qmap: raw q (d_q, L, BH), boxes of 16 x 128 x 1; kmap: k2 (16, L, 2 nb,
// BH), boxes of 16 x 16 x 2 nb x 1; vmap: v2 (lp, 32 NV, BH), boxes of
// 16 x 32 NV x 1; all 64-byte swizzle.  NV = ceil(D_v / 16).
template <int NV>
__global__ void __launch_bounds__(kThreads, 1)
    ext_attention_x3(const __grid_constant__ CUtensorMap qmap,
                     const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap, const float* __restrict__ q,
                     float* __restrict__ out, int L, int d_q, int d_v, int stages) {
  extern __shared__ uint8_t smem_raw[];
  const int nb = (d_q + kCols - 1) / kCols;
  const uint32_t st_bytes = static_cast<uint32_t>(stage_bytes(nb, NV));
  const uint32_t qbuf = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sbuf = qbuf + static_cast<uint32_t>(q_bytes(nb));
  const uint32_t bars = sbuf + stages * st_bytes;  // full[], empty[], q
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kMaxStages + s); };
  const uint32_t qbar = bars + 8 * 2 * kMaxStages;

  const int bh = blockIdx.y, q0 = blockIdx.x * kBQ;
  const int n_tiles = (L + kBN - 1) / kBN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kMaxStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumerWarps);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {
    // producer warpgroup: lane 0 of its first warp loads the Q tile once,
    // then keeps the K/V ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs) : "memory");
    if (warp == kConsumerWarps && lane == 0) {
      mbar_expect_tx(qbar, static_cast<uint32_t>(q_bytes(nb)));
      for (int b = 0; b < nb; ++b) tma_load(qbuf + b * kQBlock, &qmap, qbar, b * kCols, q0, bh);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % stages, round = j / stages;
        if (round > 0) mbar_wait(empty(s), (round - 1) & 1);
        const uint32_t st = sbuf + s * st_bytes;
        mbar_expect_tx(full(s), st_bytes);
        tma_load4(st, &kmap, full(s), 0, j * kBN, 0, bh);
        tma_load(st + 2 * nb * kKBlock, &vmap, full(s), j * kBN, 0, bh);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs) : "memory");
  // consumers: warpgroup wg owns query rows q0 + 64 wg .. + 63; in it, warp
  // w owns rows 16 w .. 16 w + 15, and lane (g, t) = (lane / 4, lane % 4)
  // rows g and g + 8 of those
  const int wg = warp / 4;
  const int g = lane / 4, t = lane % 4;
  const int row0 = q0 + 64 * wg + 16 * (warp % 4) + g;
  const int rows[2] = {row0, row0 + 8};
  const int nks = 2 * nb;  // k-steps of S = Q K^T (columns past d_q are zeros)

  // Q_hi as wgmma A fragments: k-step kk, registers (g, t), (g+8, t),
  // (g, t+4), (g+8, t+4) of its 8 columns
  uint32_t qa[kMaxKSteps][4];
  const float* qb = q + static_cast<size_t>(bh) * L * d_q;
#pragma unroll
  for (int kk = 0; kk < kMaxKSteps; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = rows[e & 1], c = 8 * kk + t + 4 * (e >> 1);
      qa[kk][e] = (kk < nks && r < L && c < d_q)
                      ? tf32(__ldg(qb + static_cast<size_t>(r) * d_q + c)) : 0u;
    }

  // Q_lo: the warpgroup's rows of the raw Q tile, split in place (the
  // swizzle moves 16-byte chunks within a row group, so the rows of one
  // warpgroup stay in its half of each column block)
  mbar_wait(qbar, 0);
  {
    float* qs = reinterpret_cast<float*>(smem_raw + (qbuf - smem_u32(smem_raw)));
    const int tid = threadIdx.x % 128;
    for (int i = tid; i < nb * 1024; i += 128) {
      float& x = qs[(i / 1024) * (kQBlock / 4) + wg * 1024 + i % 1024];
      uint32_t hi, lo;
      split(x, hi, lo);
      x = __uint_as_float(lo);
    }
    // the writes above, seen by the wgmmas' (async proxy) reads
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
  }
  const uint32_t qlo = qbuf + wg * (kQBlock / 2);

  float o[8 * NV];
#pragma unroll
  for (int i = 0; i < 8 * NV; ++i) o[i] = 0.0f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};  // running max
  float l[2] = {0.0f, 0.0f};                    // this thread's share of the running sum

  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % stages;
    mbar_wait(full(s), (j / stages) & 1);
    const uint32_t khi = sbuf + s * st_bytes, klo = khi + nb * kKBlock;
    const uint32_t vhi = khi + 2 * nb * kKBlock, vlo = vhi + 16 * NV * 64;

    // Q_lo's base, opaque to the compiler: hoisted out of the loop, its
    // 2 nb k-step descriptors would hold 4 nb registers throughout
    uint32_t qlo_t = qlo;
    asm volatile("" : "+r"(qlo_t));
    float big[8], small[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) big[i] = small[i] = 0.0f;
    fence_regs(big);
    fence_regs(small);
    wg_fence();
    // one chain of wgmmas entered at the tile's last column block
    switch (nb) {
      default: s_block<15>(big, small, qa, qlo_t, khi, klo); [[fallthrough]];
      case 15: s_block<14>(big, small, qa, qlo_t, khi, klo); [[fallthrough]];
      case 14: s_block<13>(big, small, qa, qlo_t, khi, klo); [[fallthrough]];
      case 13: s_block<12>(big, small, qa, qlo_t, khi, klo); [[fallthrough]];
      case 12: s_block<11>(big, small, qa, qlo_t, khi, klo); [[fallthrough]];
      case 11: s_block<10>(big, small, qa, qlo_t, khi, klo); [[fallthrough]];
      case 10: s_block<9>(big, small, qa, qlo_t, khi, klo); [[fallthrough]];
      case 9: s_block<8>(big, small, qa, qlo_t, khi, klo); [[fallthrough]];
      case 8: s_block<7>(big, small, qa, qlo_t, khi, klo); [[fallthrough]];
      case 7: s_block<6>(big, small, qa, qlo_t, khi, klo); [[fallthrough]];
      case 6: s_block<5>(big, small, qa, qlo_t, khi, klo); [[fallthrough]];
      case 5: s_block<4>(big, small, qa, qlo_t, khi, klo); [[fallthrough]];
      case 4: s_block<3>(big, small, qa, qlo_t, khi, klo); [[fallthrough]];
      case 3: s_block<2>(big, small, qa, qlo_t, khi, klo); [[fallthrough]];
      case 2: s_block<1>(big, small, qa, qlo_t, khi, klo); [[fallthrough]];
      case 1: s_block<0>(big, small, qa, qlo_t, khi, klo);
    }
    wg_commit();
    wg_wait_all();
    fence_regs(big);
    fence_regs(small);

    // sc[4 i + e]: row rows[e >> 1], key j kBN + 8 i + 2 t + (e & 1)
    float sc[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) sc[i] = big[i] + small[i];
    if ((j + 1) * kBN > L) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (j * kBN + 8 * (i / 4) + 2 * t + (i & 1) >= L) sc[i] = -CUDART_INF_F;
    }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = fmaxf(fmaxf(sc[2 * h], sc[2 * h + 1]), fmaxf(sc[4 + 2 * h], sc[5 + 2 * h]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[h], mx);
      alpha[h] = expf(m[h] - m_new);  // 0 on the first tile (m = -inf), 1 while m holds
      m[h] = m_new;
      float sum = 0.0f;
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = sc[4 * i + 2 * h + e];
          x = expf(x - m_new);
          sum += x;
        }
      l[h] = l[h] * alpha[h] + sum;
    }

    // P as TF32 A fragments of P V's two k-steps of 8 keys.  The fragment
    // wants columns t and t + 4 of a row where the accumulator holds 2 t and
    // 2 t + 1: V^T's keys were permuted to match (split_v), so fragment
    // column t is key 2 t and column t + 4 is key 2 t + 1.
    uint32_t ph[2][4], pl[2][4];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      split(sc[4 * kk + 0], ph[kk][0], pl[kk][0]);
      split(sc[4 * kk + 2], ph[kk][1], pl[kk][1]);
      split(sc[4 * kk + 1], ph[kk][2], pl[kk][2]);
      split(sc[4 * kk + 3], ph[kk][3], pl[kk][3]);
    }

    // The tile's P V into a fresh accumulator, the cross terms first: A from
    // registers, B = V^T hi / lo (K-major, 16 keys a row), k-step kk 32
    // bytes into the row.  The tensor cores truncate as they accumulate:
    // over a chain of L / 16 tiles that bias took the kernel outside the
    // float64 check at L = 4096, so each tile's sum joins O in one
    // correctly rounded fmaf, O rescaled by exp(m_old - m_new) in it.
    float ot[8 * NV];
#pragma unroll
    for (int i = 0; i < 8 * NV; ++i) ot[i] = 0.0f;
    fence_regs(ot);
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      fence_regs(ph[kk]);
      fence_regs(pl[kk]);
    }
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) Wgmma<16 * NV>::rs(ot, pl[kk], desc_sw64(vhi + 32 * kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) Wgmma<16 * NV>::rs(ot, ph[kk], desc_sw64(vlo + 32 * kk), 1);
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) Wgmma<16 * NV>::rs(ot, ph[kk], desc_sw64(vhi + 32 * kk), 1);
    wg_commit();
    wg_wait_all();
    fence_regs(ot);
#pragma unroll
    for (int i = 0; i < 8 * NV; ++i) o[i] = fmaf(o[i], alpha[(i >> 1) & 1], ot[i]);
    if (lane == 0) mbar_arrive(empty(s));
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  // o[4 i + e]: row rows[e >> 1], value column 8 i + 2 t + (e & 1)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (rows[h] >= L) continue;
    float* orow = out + (static_cast<size_t>(bh) * L + rows[h]) * d_v;
#pragma unroll
    for (int i = 0; i < 2 * NV; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * i + 2 * t + e;
        if (c < d_v) orow[c] = o[4 * i + 2 * h + e] / l[h];
      }
  }
}

// the pre-pass's scratch: k2 then v2, in floats
size_t scratch_floats(int BH, int L, int d_q, int d_v) {
  const size_t nb = (d_q + kCols - 1) / kCols, nv = (d_v + 15) / 16;
  const size_t lp = (static_cast<size_t>(L) + 7) / 8 * 8;
  return static_cast<size_t>(BH) * (2 * nb * L * kCols + 2 * 16 * nv * lp);
}

// a float32 tensor map of `rank` dims (innermost first), byte strides of
// dims 1.., boxes `box`, 64-byte swizzle, zeros past every edge
bool tensor_map(CUtensorMap* map, EncodeTiled encode, const void* ptr, int rank,
                const cuuint64_t* dims, const cuuint64_t* strides, const cuuint32_t* box) {
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, rank, const_cast<void*>(ptr), dims,
                strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int NV>
int launch_nv(const void* q, const void* k, const void* v, void* out, void* scratch, int BH,
              int L, int d_q, int d_v, cudaStream_t st) {
  EncodeTiled encode = encoder();
  if (encode == nullptr) return tc::kNoEncoder;
  const int nb = (d_q + kCols - 1) / kCols, dvp = 16 * NV;
  const int lp = (L + 7) / 8 * 8;
  float* k2 = static_cast<float*>(scratch);
  float* v2 = k2 + static_cast<size_t>(BH) * 2 * nb * L * kCols;

  const cuuint64_t qd[3] = {static_cast<cuuint64_t>(d_q), static_cast<cuuint64_t>(L),
                            static_cast<cuuint64_t>(BH)};
  const cuuint64_t qs[2] = {static_cast<cuuint64_t>(d_q) * 4,
                            static_cast<cuuint64_t>(d_q) * 4 * L};
  const cuuint32_t qbox[3] = {kCols, kBQ, 1};
  const cuuint64_t kd[4] = {kCols, static_cast<cuuint64_t>(L), static_cast<cuuint64_t>(2 * nb),
                            static_cast<cuuint64_t>(BH)};
  const cuuint64_t ks[3] = {kCols * 4, static_cast<cuuint64_t>(L) * kCols * 4,
                            static_cast<cuuint64_t>(L) * kCols * 4 * 2 * nb};
  const cuuint32_t kbox[4] = {kCols, kBN, static_cast<cuuint32_t>(2 * nb), 1};
  const cuuint64_t vd[3] = {static_cast<cuuint64_t>(lp), static_cast<cuuint64_t>(2 * dvp),
                            static_cast<cuuint64_t>(BH)};
  const cuuint64_t vs[2] = {static_cast<cuuint64_t>(lp) * 4,
                            static_cast<cuuint64_t>(lp) * 4 * 2 * dvp};
  const cuuint32_t vbox[3] = {kBN, static_cast<cuuint32_t>(2 * dvp), 1};
  CUtensorMap qmap, kmap, vmap;
  if (!tensor_map(&qmap, encode, q, 3, qd, qs, qbox) ||
      !tensor_map(&kmap, encode, k2, 4, kd, ks, kbox) ||
      !tensor_map(&vmap, encode, v2, 3, vd, vs, vbox))
    return tc::kBadMap;

  split_k<<<dim3((L * 4 * nb + 255) / 256, BH), 256, 0, st>>>(static_cast<const float*>(k), k2,
                                                              L, d_q, nb);
  split_v<<<dim3((lp + kVKeys - 1) / kVKeys, BH), 256, 0, st>>>(static_cast<const float*>(v), v2,
                                                                  L, d_v, dvp, lp);

  const size_t room = kSmemLimit - smem_bytes(nb, NV, 0);
  const int stages = static_cast<int>(std::min<size_t>(kMaxStages, room / stage_bytes(nb, NV)));
  if (stages < 2) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = ext_attention_x3<NV>;
  const size_t smem = smem_bytes(nb, NV, stages);
  static size_t smem_set = 0;  // the opt-in this instantiation holds
  if (smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = smem;
  }
  const dim3 grid((L + kBQ - 1) / kBQ, BH);
  kernel<<<grid, kThreads, smem, st>>>(qmap, kmap, vmap, static_cast<const float*>(q),
                                       static_cast<float*>(out), L, d_q, d_v, stages);
  return static_cast<int>(cudaGetLastError());
}

int launch_f32(const void* q, const void* k, const void* v, void* out, void* scratch, int BH,
               int L, int d_q, int d_v, cudaStream_t st) {
  switch ((d_v + 15) / 16) {
    case 1: return launch_nv<1>(q, k, v, out, scratch, BH, L, d_q, d_v, st);
    case 2: return launch_nv<2>(q, k, v, out, scratch, BH, L, d_q, d_v, st);
    case 3: return launch_nv<3>(q, k, v, out, scratch, BH, L, d_q, d_v, st);
    case 4: return launch_nv<4>(q, k, v, out, scratch, BH, L, d_q, d_v, st);
    case 5: return launch_nv<5>(q, k, v, out, scratch, BH, L, d_q, d_v, st);
    case 6: return launch_nv<6>(q, k, v, out, scratch, BH, L, d_q, d_v, st);
    case 7: return launch_nv<7>(q, k, v, out, scratch, BH, L, d_q, d_v, st);
    default: return launch_nv<8>(q, k, v, out, scratch, BH, L, d_q, d_v, st);
  }
}

}  // namespace x3

}  // namespace

extern "C" {

// q_ext, k_ext: contiguous (BH, L, d_qk); v and out: contiguous (BH, L,
// d_v); all of one dtype: 0 float32, 1 bfloat16.  1 <= d_qk <= 256,
// 1 <= d_v <= 128, 1 <= BH <= 65535; for float32 d_qk a multiple of 4, q, k
// 16-byte aligned and `scratch` the float32 buffer of
// ext_attention_scratch_floats (16-byte aligned); for bfloat16 d_qk and d_v
// multiples of 8, q, k, v, out 16-byte aligned and no scratch.  Returns the
// CUDA error of the launch (0 on success), or -1 (no cuTensorMapEncodeTiled
// in libcuda) or -2 (a tensor map refused).
int ext_attention_launch(const void* q, const void* k, const void* v, void* out, int BH, int L,
                         int d_qk, int d_v, int dtype, void* scratch, void* stream) {
  if (BH < 1 || BH > 65535 || L < 1 || d_qk < 1 || d_qk > kMaxDqk || d_v < 1 ||
      d_v > kMaxDv || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (!aligned16(q) || !aligned16(k) || !aligned16(scratch) || d_qk % 4 != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    return x3::launch_f32(q, k, v, out, scratch, BH, L, d_qk, d_v, st);
  }
  const bool ptrs = aligned16(q) && aligned16(k) && aligned16(v);
  if (!ptrs || !aligned16(out) || d_qk % 8 != 0 || d_v % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return tc::launch_bf16(q, k, v, out, BH, L, d_qk, d_v, st);
}

// floats of the scratch buffer a launch of this dtype needs (0 for bfloat16)
size_t ext_attention_scratch_floats(int BH, int L, int d_qk, int d_v, int dtype) {
  return dtype == 0 ? x3::scratch_floats(BH, L, d_qk, d_v) : 0;
}

}  // extern "C"
