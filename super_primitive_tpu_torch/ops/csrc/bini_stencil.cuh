// The BiNI normal-equation stencil shared by the two BiNI kernels.
//
// A p = sum_d D_d^T (q_d * D_d p) over the four one-sided differences
// (forward/backward in u and v).  Neighbours wrap around the field, exactly
// like the roll-based reference (super_primitive_tpu/ops/pallas_stencil.py
// `_apply_math`), so the result equals it for any q, not only for BiNI's
// zero-border q.  The terms are combined in the reference's order.  Built
// with -fmad=false, every product and sum rounds on its own, as in the
// plain PyTorch version.
#pragma once

#include <cuda_runtime.h>

// A p at one pixel from its value p0, its four neighbours (left pl, right
// pr, up pu, down pd, already wrapped) and the eight q values the stencil
// reads there: q_d at the pixel (`_c`, `_r`) and at the neighbour the
// adjoint reads (`_cm`: column c-1, `_cp`: c+1, `_rm`: row r-1, `_rp`: r+1).
__device__ __forceinline__ float bini_stencil(
    float p0, float pl, float pr, float pu, float pd, float qup_c,
    float qup_cm, float qum_c, float qum_cp, float qvp_r, float qvp_rm,
    float qvm_r, float qvm_rp) {
  const float d_right = pr - p0;  // p[r, c+1] - p[r, c]
  const float d_left = p0 - pl;   // p[r, c] - p[r, c-1]
  const float d_down = pd - p0;   // p[r+1, c] - p[r, c]
  const float d_up = p0 - pu;     // p[r, c] - p[r-1, c]
  // y_d = q_d * D_d p at this pixel and at the neighbour the adjoint reads
  const float y_up_c = qup_c * d_right;
  const float y_up_cm = qup_cm * d_left;
  const float y_um_c = qum_c * d_left;
  const float y_um_cp = qum_cp * d_right;
  const float y_vp_r = qvp_r * d_down;
  const float y_vp_rm = qvp_rm * d_up;
  const float y_vm_r = qvm_r * d_up;
  const float y_vm_rp = qvm_rp * d_down;
  return (((y_up_cm - y_up_c) + (y_um_c - y_um_cp)) + (y_vp_rm - y_vp_r)) +
         (y_vm_r - y_vm_rp);
}

// A p at pixel (r, c) of one (H, W) field in device memory.
__device__ __forceinline__ float bini_apply_at(
    const float* __restrict__ p, const float* __restrict__ q_up,
    const float* __restrict__ q_um, const float* __restrict__ q_vp,
    const float* __restrict__ q_vm, int r, int c, int H, int W) {
  const int cm = c == 0 ? W - 1 : c - 1;
  const int cp = c == W - 1 ? 0 : c + 1;
  const int rm = r == 0 ? H - 1 : r - 1;
  const int rp = r == H - 1 ? 0 : r + 1;
  const int i = r * W + c;
  return bini_stencil(p[i], p[r * W + cm], p[r * W + cp], p[rm * W + c],
                      p[rp * W + c], q_up[i], q_up[r * W + cm], q_um[i],
                      q_um[r * W + cp], q_vp[i], q_vp[rm * W + c], q_vm[i],
                      q_vm[rp * W + c]);
}

// Sum of one value per thread over the block, in a fixed tree order.
// `sh` holds blockDim.x values; blockDim.x is a power of two.  Starts and
// ends with a barrier, so it also orders the block's global writes.
template <typename T>
__device__ __forceinline__ T block_sum(T v, T* sh) {
  sh[threadIdx.x] = v;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) sh[threadIdx.x] += sh[threadIdx.x + s];
    __syncthreads();
  }
  const T total = sh[0];
  __syncthreads();
  return total;
}
