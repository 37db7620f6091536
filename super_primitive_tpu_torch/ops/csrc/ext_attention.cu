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
// is compute-bound by some 7x even at the bf16 tensor-core rate.  So each
// dtype has one body built around its arithmetic:
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
// float32: CUDA cores (`ext_attention_kernel`), float32 fmaf throughout:
// TF32 tensor cores would round the inputs to 10 mantissa bits, about 1e-3
// relative, two orders above the float32 check.
//  * One CTA of 256 threads per (bh, tile of 64 queries).  The CTA stages
//    its Q tile once, transposed (d-major), in shared memory, then walks
//    the keys in tiles of 64: the K tile transposed, the V tile row-major.
//    Rows past L are zeros; scores of keys past L are -inf, so a ragged
//    last tile adds nothing.
//  * Staging: each thread copies 16-byte vectors of a row (4 float32)
//    where the widths and pointers allow it, one element otherwise;
//    neighbouring threads take neighbouring rows, so the transposed
//    shared-memory stores do not conflict.
//  * Scores: thread (ty, tx) of a 16 x 16 grid computes rows ty*4 + i and
//    keys tx + 16*j (i, j < 4) of the 64 x 64 tile, one float4 of Q and
//    four K values a depth step, fmaf each.
//  * Online softmax in float32: a row's running max m and sum l live in
//    the 16 threads of the row (shuffle reductions over tx); each tile's
//    scores become p = exp(s - m_new), and p goes through shared memory to
//    the tile's P @ V product, in which the thread owns rows ty*4 + i and
//    value columns tx + 16*jj (jj < NJ = ceil(D_v / 16)); the row's
//    accumulators are scaled by exp(m_old - m_new) first and the tile's
//    products added on in key order.  At ViT-H's float32 shape the plain
//    version's own summation noise is of the order of the 1e-5 check:
//    summing the keys in the order its matmul does (one run, in order)
//    keeps the two within it, where a sum per tile does not.
//  * One correctly rounded division by l at the end.
//  No fast math: expf and the division are the accurate ones; the products
//  and sums are explicit fmaf, so -fmad=false changes nothing here.
#include <cuda.h>  // CUtensorMap and its enums; the encoder is found at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

namespace {

constexpr int kMaxDqk = 256;
constexpr int kMaxDv = 128;

// ---------------------------------------------------------------------------
// float32: the CUDA-core body

constexpr int kBQ = 64;        // queries a CTA
constexpr int kBK = 64;        // keys a tile
constexpr int kThreads = 256;  // 16 x 16
constexpr int kQS = kBQ + 4;   // Q tile row stride (floats): float4 reads stay aligned
constexpr int kKS = kBK;       // K tile row stride
constexpr int kPS = kBQ + 1;   // P tile row stride: the transposed stores spread over banks

// N consecutive elements (a 16-byte vector for N > 1).
template <int N>
__device__ __forceinline__ void load_vec(const float* src, float* dst) {
  if constexpr (N == 4) {
    const float4 a = *reinterpret_cast<const float4*>(src);
    dst[0] = a.x, dst[1] = a.y, dst[2] = a.z, dst[3] = a.w;
  } else {
    static_assert(N == 1, "float32 rows are staged by 4 or 1");
    dst[0] = src[0];
  }
}

// Rows [row0, row0 + kBK|kBQ) of a row-major (L, D) matrix into shared
// memory transposed, dst[d * stride + r]; rows r >= n_valid as zeros.
template <int VEC, int ROWS>
__device__ __forceinline__ void stage_transposed(float* dst, int stride, const float* src, int D,
                                                 int row0, int n_valid) {
  const int chunks = D / VEC;
  for (int idx = threadIdx.x; idx < chunks * ROWS; idx += kThreads) {
    const int r = idx % ROWS, c = idx / ROWS;
    float vals[VEC];
    if (r < n_valid) {
      load_vec<VEC>(src + static_cast<size_t>(row0 + r) * D + c * VEC, vals);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) vals[e] = 0.0f;
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) dst[(c * VEC + e) * stride + r] = vals[e];
  }
}

// Rows [row0, row0 + kBK) of a row-major (L, D) matrix into shared memory
// row-major with row stride `stride` >= D, dst[r * stride + d]; rows
// r >= n_valid as zeros.  Columns D..stride-1 are left as they are.
template <int VEC>
__device__ __forceinline__ void stage_rows(float* dst, int stride, const float* src, int D,
                                           int row0, int n_valid) {
  const int chunks = D / VEC;
  for (int idx = threadIdx.x; idx < chunks * kBK; idx += kThreads) {
    const int c = idx % chunks, r = idx / chunks;
    float vals[VEC];
    if (r < n_valid) {
      load_vec<VEC>(src + static_cast<size_t>(row0 + r) * D + c * VEC, vals);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) vals[e] = 0.0f;
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) dst[r * stride + c * VEC + e] = vals[e];
  }
}

template <int NJ>
constexpr size_t smem_bytes_for(int d_qk) {
  return (static_cast<size_t>(d_qk) * (kQS + kKS) + kBK * 16 * NJ + kBK * kPS) * sizeof(float);
}

// grid (ceil(L / kBQ), BH), kThreads threads, smem_bytes_for<NJ>(D_qk).
template <int VEC, int NJ>
__global__ void __launch_bounds__(kThreads)
    ext_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ out, int L, int d_qk,
                         int d_v) {
  constexpr int VS = 16 * NJ;  // V tile row stride: the value columns the threads own
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                 // d_qk x kQS, transposed
  float* Ks = Qs + d_qk * kQS;      // d_qk x kKS, transposed
  float* Vs = Ks + d_qk * kKS;      // kBK x VS
  float* Ps = Vs + kBK * VS;        // kBK x kPS, transposed (key-major)

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const float* qb = q + static_cast<size_t>(bh) * L * d_qk;
  const float* kb = k + static_cast<size_t>(bh) * L * d_qk;
  const float* vb = v + static_cast<size_t>(bh) * L * d_v;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  stage_transposed<VEC, kBQ>(Qs, kQS, qb, d_qk, q0, min(kBQ, L - q0));
  for (int idx = threadIdx.x; idx < kBK * (VS - d_v); idx += kThreads)
    Vs[(idx / (VS - d_v)) * VS + d_v + idx % (VS - d_v)] = 0.0f;

  float m[4], l[4], o[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -CUDART_INF_F;
    l[i] = 0.0f;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) o[i][jj] = 0.0f;
  }

  for (int k0 = 0; k0 < L; k0 += kBK) {
    const int nk = min(kBK, L - k0);
    __syncthreads();  // the last tile's reads of Ks, Vs and Ps are done
    stage_transposed<VEC, kBK>(Ks, kKS, kb, d_qk, k0, nk);
    stage_rows<VEC>(Vs, VS, vb, d_v, k0, nk);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < d_qk; ++d) {
      const float4 qa = *reinterpret_cast<const float4*>(Qs + d * kQS + ty * 4);
      const float* kr = Ks + d * kKS + tx;
      const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
      const float kv[4] = {kr[0], kr[16], kr[32], kr[48]};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (tx + 16 * j >= nk)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[i][j] = -CUDART_INF_F;

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);  // 0 on the first tile (m = -inf)
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) o[i][jj] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) Ps[(tx + 16 * j) * kPS + ty * 4 + i] = s[i][j];
    __syncthreads();

    // the tile's P @ V on top of the rescaled accumulators: one run of fmaf
    // over the keys in order, as the plain version's product sums them
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      const float* pr = Ps + kk * kPS + ty * 4;
      const float pv[4] = {pr[0], pr[1], pr[2], pr[3]};
      const float* vr = Vs + kk * VS + tx;
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        const float x = vr[16 * jj];
#pragma unroll
        for (int i = 0; i < 4; ++i) o[i][jj] = fmaf(pv[i], x, o[i][jj]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= L) continue;
    float* orow = out + (static_cast<size_t>(bh) * L + r) * d_v;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      const int c = tx + 16 * jj;
      if (c < d_v) orow[c] = o[i][jj] / l[i];
    }
  }
}

template <int VEC, int NJ>
int launch_nj(const void* q, const void* k, const void* v, void* out, int BH, int L, int d_qk,
              int d_v, cudaStream_t st) {
  auto kernel = ext_attention_kernel<VEC, NJ>;
  const size_t smem = smem_bytes_for<NJ>(d_qk);
  static size_t smem_set = 0;  // the opt-in this instantiation holds
  if (smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = smem;
  }
  const dim3 grid((L + kBQ - 1) / kBQ, BH);
  kernel<<<grid, kThreads, smem, st>>>(static_cast<const float*>(q), static_cast<const float*>(k),
                                       static_cast<const float*>(v), static_cast<float*>(out), L,
                                       d_qk, d_v);
  return static_cast<int>(cudaGetLastError());
}

template <int VEC>
int launch_f32(const void* q, const void* k, const void* v, void* out, int BH, int L, int d_qk,
               int d_v, cudaStream_t st) {
  switch ((d_v + 15) / 16) {
    case 1: return launch_nj<VEC, 1>(q, k, v, out, BH, L, d_qk, d_v, st);
    case 2: return launch_nj<VEC, 2>(q, k, v, out, BH, L, d_qk, d_v, st);
    case 3: return launch_nj<VEC, 3>(q, k, v, out, BH, L, d_qk, d_v, st);
    case 4: return launch_nj<VEC, 4>(q, k, v, out, BH, L, d_qk, d_v, st);
    case 5: return launch_nj<VEC, 5>(q, k, v, out, BH, L, d_qk, d_v, st);
    case 6: return launch_nj<VEC, 6>(q, k, v, out, BH, L, d_qk, d_v, st);
    case 7: return launch_nj<VEC, 7>(q, k, v, out, BH, L, d_qk, d_v, st);
    default: return launch_nj<VEC, 8>(q, k, v, out, BH, L, d_qk, d_v, st);
  }
}

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

}  // namespace

extern "C" {

// q_ext, k_ext: contiguous (BH, L, d_qk); v and out: contiguous (BH, L,
// d_v); all of one dtype: 0 float32, 1 bfloat16.  1 <= d_qk <= 256,
// 1 <= d_v <= 128, 1 <= BH <= 65535; for bfloat16 also d_qk and d_v
// multiples of 8 and q, k, v, out 16-byte aligned.  Returns the CUDA error
// of the launch (0 on success), or -1 (no cuTensorMapEncodeTiled in
// libcuda) or -2 (a tensor map refused).
int ext_attention_launch(const void* q, const void* k, const void* v, void* out, int BH, int L,
                         int d_qk, int d_v, int dtype, void* stream) {
  if (BH < 1 || BH > 65535 || L < 1 || d_qk < 1 || d_qk > kMaxDqk || d_v < 1 ||
      d_v > kMaxDv || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool ptrs = aligned16(q) && aligned16(k) && aligned16(v);
  if (dtype == 0) {
    if (ptrs && d_qk % 4 == 0 && d_v % 4 == 0)
      return launch_f32<4>(q, k, v, out, BH, L, d_qk, d_v, st);
    return launch_f32<1>(q, k, v, out, BH, L, d_qk, d_v, st);
  }
  if (!ptrs || !aligned16(out) || d_qk % 8 != 0 || d_v % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return tc::launch_bf16(q, k, v, out, BH, L, d_qk, d_v, st);
}

}  // extern "C"
