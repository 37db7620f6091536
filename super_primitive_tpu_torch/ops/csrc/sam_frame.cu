// SAM's input frame: two cv2 INTER_LINEAR uint8 resizes, composed.
//
// Replaces no Pallas kernel.  The JAX package makes SAM's input frame on the
// host with two cv2.resize calls (frontend/process_frame.py: the keyframe's
// image to the mask generation's infer_resolution; nets/sam/predictor.py:
// that frame's longest side to the encoder's input).  The port did the same
// in numpy (image/resize.linear_resize) at every keyframe, with the card idle;
// this kernel makes the frame on the card from the uploaded image, with the
// same bytes (ops/sam_frame.py holds the plain version).
//
// Bound: bytes.  It must read the H x W x 3 image and write the h2 x w2 x 3
// frame (and read its tap tables); 0.92 + 2.36 MB at 480x640 -> 960x1280 ->
// 768x1024, about 1 us at 3.35 TB/s.
//
// Design: one thread an output pixel, all three channels.  Its stage-2 taps
// need the intermediate (h1 x w1) frame at 2 x 2 pixels; the thread forms each
// of them in registers from 2 x 2 image pixels with the stage-1 taps, so the
// intermediate frame is never written.  Neighbouring threads read the same
// image pixels, from L1.  Both stages are linear_resize's uint8 arithmetic:
// the horizontal sums hor = p0 * a + p1 * (2048 - a), then
// ((((hor0 >> 4) * b) >> 16) + (((hor1 >> 4) * (2048 - b)) >> 16) + 2) >> 2,
// clipped to 0..255.  int32 is exact: hor <= 255 * 2048 = 522,240, so
// (hor >> 4) * b < 2^27.  The host gives each stage's taps as tables
// (image/resize.linear_taps_u8), which write the copy and the exact 2x
// reduction as taps too, so one kernel serves every pair of shapes.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kOne = 2048;  // OpenCV's INTER_RESIZE_COEF_SCALE
constexpr int kBlockX = 32;
constexpr int kBlockY = 8;

// One stage's taps along one axis: the first and second source index and
// the first tap's weight (the second's is kOne less it), each n long.
struct Axis {
  const int* s0;
  const int* s1;
  const int* a0;
};

__device__ __forceinline__ Axis axis_at(const int* t, int n) { return {t, t + n, t + 2 * n}; }

__device__ __forceinline__ int vertical(int hor0, int hor1, int b) {
  const int v = ((((hor0 >> 4) * b) >> 16) + (((hor1 >> 4) * (kOne - b)) >> 16) + 2) >> 2;
  return min(max(v, 0), 255);
}

// tables: sy0, sy1, ay0 (h1 each), sx0, sx1, ax0 (w1 each) of stage 1, then
// the same of stage 2 (h2, then w2 each), int32.
__global__ void __launch_bounds__(kBlockX * kBlockY)
    sam_frame_kernel(const uint8_t* __restrict__ src, int W, const int* __restrict__ tables,
                     int h1, int w1, int h2, int w2, uint8_t* __restrict__ out) {
  const int j = blockIdx.x * kBlockX + threadIdx.x;
  const int i = blockIdx.y * kBlockY + threadIdx.y;
  if (i >= h2 || j >= w2) return;
  const Axis y1 = axis_at(tables, h1);
  const Axis x1 = axis_at(tables + 3 * h1, w1);
  const Axis y2 = axis_at(tables + 3 * (h1 + w1), h2);
  const Axis x2 = axis_at(tables + 3 * (h1 + w1 + h2), w2);

  const int rows[2] = {__ldg(y2.s0 + i), __ldg(y2.s1 + i)};
  const int cols[2] = {__ldg(x2.s0 + j), __ldg(x2.s1 + j)};
  int cx0[2], cx1[2], ca[2];
#pragma unroll
  for (int l = 0; l < 2; ++l) {
    cx0[l] = 3 * __ldg(x1.s0 + cols[l]);
    cx1[l] = 3 * __ldg(x1.s1 + cols[l]);
    ca[l] = __ldg(x1.a0 + cols[l]);
  }
  // mid[k][l][c]: the intermediate frame's pixel (rows[k], cols[l])
  int mid[2][2][3];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const uint8_t* r0 = src + static_cast<size_t>(__ldg(y1.s0 + rows[k])) * W * 3;
    const uint8_t* r1 = src + static_cast<size_t>(__ldg(y1.s1 + rows[k])) * W * 3;
    const int b = __ldg(y1.a0 + rows[k]);
#pragma unroll
    for (int l = 0; l < 2; ++l) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const int hor0 = __ldg(r0 + cx0[l] + c) * ca[l] + __ldg(r0 + cx1[l] + c) * (kOne - ca[l]);
        const int hor1 = __ldg(r1 + cx0[l] + c) * ca[l] + __ldg(r1 + cx1[l] + c) * (kOne - ca[l]);
        mid[k][l][c] = vertical(hor0, hor1, b);
      }
    }
  }
  const int a = __ldg(x2.a0 + j);
  const int b = __ldg(y2.a0 + i);
  uint8_t* o = out + (static_cast<size_t>(i) * w2 + j) * 3;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const int hor0 = mid[0][0][c] * a + mid[0][1][c] * (kOne - a);
    const int hor1 = mid[1][0][c] * a + mid[1][1][c] * (kOne - a);
    o[c] = static_cast<uint8_t>(vertical(hor0, hor1, b));
  }
}

}  // namespace

extern "C" {

// src: contiguous (H, W, 3) uint8 on the device; out: contiguous (h2, w2, 3)
// uint8; tables: 3 * (h1 + w1 + h2 + w2) int32 on the device, every index in
// range (ops/sam_frame.py builds and checks them).  Returns the CUDA error of
// the launch (0 on success).
int sam_frame_launch(const uint8_t* src, int H, int W, const int* tables, int h1, int w1, int h2,
                     int w2, uint8_t* out, void* stream) {
  if (H < 1 || W < 1 || h1 < 1 || w1 < 1 || h2 < 1 || w2 < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((w2 + kBlockX - 1) / kBlockX, (h2 + kBlockY - 1) / kBlockY);
  sam_frame_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(src, W, tables, h1, w1,
                                                                         h2, w2, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
