// K3: SAM mask statistics by phase decomposition of the bilinear s-upsample.
//
// Replaces the Pallas TPU kernel
// super_primitive_tpu/ops/pallas_phase_counts.py `phase_counts_pallas`
// (body `_kernel`; math of nets/sam/predictor.py `_phase_upsample_counts`).
// For each (S, S) low-res logit slab it counts, over the s*s phases of the
// half-pixel bilinear upsample and without building the upsampled grid, the
// pixels above +1, -1 and 0 inside the unpadded region s*i+k < input_hw:
// (hi, lo, area).  Stability is hi / max(lo, 1) (computed by the caller).
//
// Bound: operations.  Each low-res pixel is read once (plus its 3x3
// neighbours, which hit L1) and feeds s*s = 16 interpolants, each a few
// products and three comparisons.  Design: one block per slab, threads
// striding over its pixels with neighbouring threads on neighbouring pixels;
// counts in int32 registers, a warp-shuffle and shared-memory reduction per
// block, one write per count.  Integer sums do not depend on order.
//
// Exactness: every interpolant is formed in the plain version's order,
// (1+f)*x - f*xm for f < 0 and (1-f)*x + f*xp otherwise, with the clamped
// edge shifts of the reference; the build uses -fmad=false so no product and
// sum contract into one rounding.  With s = 4 every phase weight is exact in
// float32.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxS = 16;

__device__ __forceinline__ int warp_sum(int v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// Interpolate along one axis at phase weight (a, f): a = fp32(1 + f) for
// f < 0, else fp32(1 - f); `prev` / `next` are the clamped neighbours.
__device__ __forceinline__ float lerp_phase(float a, float f, bool neg, float x,
                                            float prev, float next) {
  return neg ? a * x - f * prev : a * x + f * next;
}

__global__ void __launch_bounds__(kThreads) phase_counts_kernel(
    const float* __restrict__ x, int S, int s, int h_in, int w_in,
    int* __restrict__ hi_out, int* __restrict__ lo_out,
    int* __restrict__ area_out) {
  __shared__ float wa[kMaxS];
  __shared__ float wf[kMaxS];
  __shared__ int red[3][kThreads / 32];
  if (threadIdx.x < s) {
    // the reference forms the weights in double and rounds them once
    const double f = (threadIdx.x + 0.5) / s - 0.5;
    wf[threadIdx.x] = static_cast<float>(f);
    wa[threadIdx.x] = static_cast<float>(f < 0.0 ? 1.0 + f : 1.0 - f);
  }
  __syncthreads();

  const float* xn = x + static_cast<size_t>(blockIdx.x) * S * S;
  int hi = 0, lo = 0, area = 0;
  for (int p = threadIdx.x; p < S * S; p += kThreads) {
    const int i = p / S;
    const int j = p - i * S;
    const int im = i > 0 ? i - 1 : 0, ip = i < S - 1 ? i + 1 : S - 1;
    const int jm = j > 0 ? j - 1 : 0, jp = j < S - 1 ? j + 1 : S - 1;
    const int cols[3] = {jm, j, jp};
    float xc[3], xu[3], xd[3];  // rows i, i-1, i+1 at columns j-1, j, j+1
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      xc[c] = xn[i * S + cols[c]];
      xu[c] = xn[im * S + cols[c]];
      xd[c] = xn[ip * S + cols[c]];
    }
    for (int ky = 0; ky < s; ++ky) {
      if (s * i + ky >= h_in) break;
      const float fy = wf[ky], ay = wa[ky];
      const bool ny = fy < 0.0f;
      float ry[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) ry[c] = lerp_phase(ay, fy, ny, xc[c], xu[c], xd[c]);
      for (int kx = 0; kx < s; ++kx) {
        if (s * j + kx >= w_in) break;
        const float fx = wf[kx], ax = wa[kx];
        const float v = lerp_phase(ax, fx, fx < 0.0f, ry[1], ry[0], ry[2]);
        hi += v > 1.0f;
        lo += v > -1.0f;
        area += v > 0.0f;
      }
    }
  }
  hi = warp_sum(hi);
  lo = warp_sum(lo);
  area = warp_sum(area);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    red[0][warp] = hi;
    red[1][warp] = lo;
    red[2][warp] = area;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int t0 = 0, t1 = 0, t2 = 0;
    for (int w = 0; w < kThreads / 32; ++w) {
      t0 += red[0][w];
      t1 += red[1][w];
      t2 += red[2][w];
    }
    hi_out[blockIdx.x] = t0;
    lo_out[blockIdx.x] = t1;
    area_out[blockIdx.x] = t2;
  }
}

}  // namespace

extern "C" {

// x: contiguous (N, S, S) float32 on the device; hi, lo, area: (N,) int32.
// Returns the CUDA error of the launch (0 on success).
int phase_counts_launch(const float* x, int N, int S, int s, int h_in, int w_in,
                        int* hi, int* lo, int* area, void* stream) {
  if (s < 1 || s > kMaxS) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  phase_counts_kernel<<<N, kThreads, 0, st>>>(x, S, s, h_in, w_in, hi, lo, area);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
