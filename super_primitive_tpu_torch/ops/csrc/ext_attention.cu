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
// is compute-bound by some 7x even at the bf16 tensor-core rate.
//
// Design (a plain first kernel: CUDA cores, float32 arithmetic; tensor
// cores, wgmma and TMA are later work):
//  * One CTA of 256 threads per (bh, tile of 64 queries).  The CTA stages
//    its Q tile once, transposed (d-major), in shared memory as float32,
//    then walks the keys in tiles of 64: the K tile transposed, the V tile
//    row-major, each converted to float32 as it is staged.  Rows past L are
//    zeros; scores of keys past L are -inf, so a ragged last tile adds
//    nothing.
//  * Staging: each thread copies 16-byte vectors of a row (8 bf16 or 4
//    float32) where the widths and pointers allow it, one element
//    otherwise; neighbouring threads take neighbouring rows, so the
//    transposed shared-memory stores do not conflict.
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
//  * One correctly rounded division by l at the end, then the rounding to
//    v's dtype (round to nearest even for bf16).
// No fast math: expf and the division are the accurate ones; the products
// and sums are explicit fmaf, so -fmad=false changes nothing here.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

namespace {

constexpr int kBQ = 64;        // queries a CTA
constexpr int kBK = 64;        // keys a tile
constexpr int kThreads = 256;  // 16 x 16
constexpr int kQS = kBQ + 4;   // Q tile row stride (floats): float4 reads stay aligned
constexpr int kKS = kBK;       // K tile row stride
constexpr int kPS = kBQ + 1;   // P tile row stride: the transposed stores spread over banks
constexpr int kMaxDqk = 256;
constexpr int kMaxDv = 128;

// N consecutive elements (a 16-byte vector for N > 1) as float32.
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

template <int N>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* src, float* dst) {
  if constexpr (N == 8) {
    const uint4 a = *reinterpret_cast<const uint4*>(src);
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&a);
#pragma unroll
    for (int e = 0; e < 8; ++e) dst[e] = __bfloat162float(h[e]);
  } else {
    static_assert(N == 1, "bf16 rows are staged by 8 or 1");
    dst[0] = __bfloat162float(src[0]);
  }
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// Rows [row0, row0 + kBK|kBQ) of a row-major (L, D) matrix into shared
// memory transposed, dst[d * stride + r]; rows r >= n_valid as zeros.
template <typename T, int VEC, int ROWS>
__device__ __forceinline__ void stage_transposed(float* dst, int stride, const T* src, int D,
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
template <typename T, int VEC>
__device__ __forceinline__ void stage_rows(float* dst, int stride, const T* src, int D, int row0,
                                           int n_valid) {
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
template <typename T, int VEC, int NJ>
__global__ void __launch_bounds__(kThreads)
    ext_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, T* __restrict__ out, int L, int d_qk, int d_v) {
  constexpr int VS = 16 * NJ;  // V tile row stride: the value columns the threads own
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                 // d_qk x kQS, transposed
  float* Ks = Qs + d_qk * kQS;      // d_qk x kKS, transposed
  float* Vs = Ks + d_qk * kKS;      // kBK x VS
  float* Ps = Vs + kBK * VS;        // kBK x kPS, transposed (key-major)

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const T* qb = q + static_cast<size_t>(bh) * L * d_qk;
  const T* kb = k + static_cast<size_t>(bh) * L * d_qk;
  const T* vb = v + static_cast<size_t>(bh) * L * d_v;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  stage_transposed<T, VEC, kBQ>(Qs, kQS, qb, d_qk, q0, min(kBQ, L - q0));
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
    stage_transposed<T, VEC, kBK>(Ks, kKS, kb, d_qk, k0, nk);
    stage_rows<T, VEC>(Vs, VS, vb, d_v, k0, nk);
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
    T* orow = out + (static_cast<size_t>(bh) * L + r) * d_v;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      const int c = tx + 16 * jj;
      if (c < d_v) store(orow + c, o[i][jj] / l[i]);
    }
  }
}

template <typename T, int VEC, int NJ>
int launch_nj(const void* q, const void* k, const void* v, void* out, int BH, int L, int d_qk,
              int d_v, cudaStream_t st) {
  auto kernel = ext_attention_kernel<T, VEC, NJ>;
  const size_t smem = smem_bytes_for<NJ>(d_qk);
  static size_t smem_set = 0;  // the opt-in this instantiation holds
  if (smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = smem;
  }
  const dim3 grid((L + kBQ - 1) / kBQ, BH);
  kernel<<<grid, kThreads, smem, st>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                       static_cast<const T*>(v), static_cast<T*>(out), L, d_qk,
                                       d_v);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int VEC>
int launch(const void* q, const void* k, const void* v, void* out, int BH, int L, int d_qk,
           int d_v, cudaStream_t st) {
  switch ((d_v + 15) / 16) {
    case 1: return launch_nj<T, VEC, 1>(q, k, v, out, BH, L, d_qk, d_v, st);
    case 2: return launch_nj<T, VEC, 2>(q, k, v, out, BH, L, d_qk, d_v, st);
    case 3: return launch_nj<T, VEC, 3>(q, k, v, out, BH, L, d_qk, d_v, st);
    case 4: return launch_nj<T, VEC, 4>(q, k, v, out, BH, L, d_qk, d_v, st);
    case 5: return launch_nj<T, VEC, 5>(q, k, v, out, BH, L, d_qk, d_v, st);
    case 6: return launch_nj<T, VEC, 6>(q, k, v, out, BH, L, d_qk, d_v, st);
    case 7: return launch_nj<T, VEC, 7>(q, k, v, out, BH, L, d_qk, d_v, st);
    default: return launch_nj<T, VEC, 8>(q, k, v, out, BH, L, d_qk, d_v, st);
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

extern "C" {

// q_ext, k_ext: contiguous (BH, L, d_qk); v and out: contiguous (BH, L,
// d_v); all of one dtype: 0 float32, 1 bfloat16.  1 <= d_qk <= 256,
// 1 <= d_v <= 128, 1 <= BH <= 65535.  Returns the CUDA error of the launch
// (0 on success).
int ext_attention_launch(const void* q, const void* k, const void* v, void* out, int BH, int L,
                         int d_qk, int d_v, int dtype, void* stream) {
  if (BH < 1 || BH > 65535 || L < 1 || d_qk < 1 || d_qk > kMaxDqk || d_v < 1 ||
      d_v > kMaxDv || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool ptrs = aligned16(q) && aligned16(k) && aligned16(v);
  if (dtype == 0) {
    if (ptrs && d_qk % 4 == 0 && d_v % 4 == 0)
      return launch<float, 4>(q, k, v, out, BH, L, d_qk, d_v, st);
    return launch<float, 1>(q, k, v, out, BH, L, d_qk, d_v, st);
  }
  if (ptrs && d_qk % 8 == 0 && d_v % 8 == 0)
    return launch<__nv_bfloat16, 8>(q, k, v, out, BH, L, d_qk, d_v, st);
  return launch<__nv_bfloat16, 1>(q, k, v, out, BH, L, d_qk, d_v, st);
}

}  // extern "C"
