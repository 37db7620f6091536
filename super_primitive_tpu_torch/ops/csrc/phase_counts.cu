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
// Bound: bytes.  An exact kernel must read the region's R = ceil(h_in / s)
// low-res rows and the clamped neighbour row below them, and write three
// counts a slab.  The reference's 16 interpolants a pixel are no floor: most
// pixels of a SAM logit slab lie far from every threshold, and their counts
// follow from their neighbourhood's range alone (below).
//
// Design:
//  * Work items are (slab, band of `band` low-res rows) over the region's
//    rows only, one CTA each, so 96 slabs give thousands of CTAs and fill
//    every SM.  A CTA copies its band and the two clamped halo rows (a
//    contiguous run of the slab) into shared memory with cp.async; rows past
//    the region's halo are never read.
//  * Groups: each thread takes four adjacent columns down a strip of the
//    band, one 16-byte row load and two neighbours a step, and keeps the
//    min and max of the 3x6 block around the four pixels (NaN-propagating),
//    rolling.  A block at or above c_+1 counts every phase of its pixels for
//    all three thresholds, one at or below d_-1 none; no interpolant is
//    formed.  Every other group goes to a shared-memory queue (one warp-
//    aggregated atomic per warp and step).
//  * Queued groups, one a thread: each pixel's own 3x3 window settles it at
//    its level (above 0-3 thresholds, see "Settling") or queues it; if the
//    pixel queue is full (logits that settle nowhere), the thread forms that
//    pixel's phases in place.
//  * Queued pixels, one a thread: all s*s interpolants as the reference
//    forms them (row interpolants at columns j-1, j, j+1 once per row phase,
//    reused by every column phase).  On SAM logits about 1% of the region's
//    pixels get here, densely packed rather than one in a warp.
//  * Counts: warp shuffle, then one atomicAdd per count and CTA into the
//    (3, N) output, which the launch zeroes on the stream first.  Integer
//    sums do not depend on order.
//
// Settling (exact, not approximate).  Pixel (i, j)'s interpolant at phase
// k = (ky, kx) is a composition of three kinds of rounding step, each
// nondecreasing in each of its inputs: a product with a non-negative weight
// (a = fp32(1 -+ f) > 0, |f|), rounded; the f < 0 form a*x - f*xm, which is
// a*x + |f|*xm because round(f*xm) = -round(|f|*xm) under round-to-nearest-
// even; and a sum, rounded.  So each interpolant V_k(x_1..x_9) is
// nondecreasing in each of the pixel's nine clamped neighbours, and
//     min <= x_n <= max for all n  =>  V_k(min,..,min) <= V_k(x) <= V_k(max,..,max).
// The host computes, per s and in float32 with the same weights and the same
// operation order as below (ops/phase_counts.py `phase_cutoffs`, found by
// bisection over the ordered floats and checked by a scan in the tests):
//     c_t = the least float m with V_k(m,..,m) > t for every phase k,
//     d_t = the greatest float m with V_k(m,..,m) <= t for every phase k,
// for t = -1, 0, +1 in that order.  Then min >= c_t means every phase of the
// pixel counts for t, and max <= d_t means none does.  A window with a NaN or
// an infinity never settles (it would break the monotone argument: inf - inf,
// 0 * inf): the min and max propagate NaN, and both must be finite.
//
// Exactness of the drained pixels: every interpolant is formed in the plain
// version's order, (1+f)*x - f*xm for f < 0 and (1-f)*x + f*xp otherwise,
// with the clamped edge shifts of the reference; the build uses -fmad=false
// so no product and sum contract into one rounding, and keeps subnormals.
#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>

namespace {

constexpr int kMaxS = 16;
constexpr int kMaxThreads = 512;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kGroup = 4;  // columns a thread takes in the group pass

// thresholds -1, 0, +1 in that (ascending) order: the lo, area, hi counts
struct Cutoffs {
  float c[3];  // least float whose constant window puts every phase above t
  float d[3];  // greatest float whose constant window puts no phase above t
};

__device__ __forceinline__ float min_nan(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__device__ __forceinline__ int warp_sum(int v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

// Interpolate along one axis at phase weight (a, f): a = fp32(1 + f) for
// f < 0, else fp32(1 - f); `prev` / `next` are the clamped neighbours.
__device__ __forceinline__ float lerp_phase(float a, float f, float x, float prev,
                                            float next) {
  return f < 0.0f ? a * x - f * prev : a * x + f * next;
}

// the reference forms the weights in double and rounds them once
__host__ __device__ constexpr double phase_f(int k, int s) { return (k + 0.5) / s - 0.5; }

// Phase weights: compile-time for KS > 0, from shared memory for KS == 0.
template <int KS>
struct Weights {
  __device__ float f(int k) const { return static_cast<float>(phase_f(k, KS)); }
  __device__ float a(int k) const {
    const double f = phase_f(k, KS);
    return static_cast<float>(f < 0.0 ? 1.0 + f : 1.0 - f);
  }
};

template <>
struct Weights<0> {
  const float* wf;
  const float* wa;
  __device__ float f(int k) const { return wf[k]; }
  __device__ float a(int k) const { return wa[k]; }
};

// The s*s phases of one pixel, counted inside the region (ny row phases,
// nx column phases), as the reference forms them.  xu, xc, xd: rows i-1, i,
// i+1 (clamped) at columns j-1, j, j+1 (clamped).
template <int KS>
__device__ __forceinline__ void full_pixel(const Weights<KS>& w, int s, int ny, int nx,
                                           const float (&xu)[3], const float (&xc)[3],
                                           const float (&xd)[3], int& hi, int& lo,
                                           int& area) {
  if constexpr (KS > 0) {
    // unrolled, with the region as a predicate rather than a break
#pragma unroll
    for (int ky = 0; ky < KS; ++ky) {
      const float fy = w.f(ky), ay = w.a(ky);
      float ry[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) ry[c] = lerp_phase(ay, fy, xc[c], xu[c], xd[c]);
#pragma unroll
      for (int kx = 0; kx < KS; ++kx) {
        const bool in = ky < ny && kx < nx;
        const float v = lerp_phase(w.a(kx), w.f(kx), ry[1], ry[0], ry[2]);
        hi += in && v > 1.0f;
        lo += in && v > -1.0f;
        area += in && v > 0.0f;
      }
    }
  } else {
    for (int ky = 0; ky < ny; ++ky) {
      const float fy = w.f(ky), ay = w.a(ky);
      float ry[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) ry[c] = lerp_phase(ay, fy, xc[c], xu[c], xd[c]);
      for (int kx = 0; kx < nx; ++kx) {
        const float v = lerp_phase(w.a(kx), w.f(kx), ry[1], ry[0], ry[2]);
        hi += v > 1.0f;
        lo += v > -1.0f;
        area += v > 0.0f;
      }
    }
  }
}

// Columns j0-1 .. j0+4 (clamped) of one staged row: a group's four columns
// and their two neighbours.
template <bool VEC>
__device__ __forceinline__ void load6(const float* row, int j0, int S, float (&v)[6]) {
  if constexpr (VEC) {
    const float4 q = *reinterpret_cast<const float4*>(row + j0);
    v[1] = q.x, v[2] = q.y, v[3] = q.z, v[4] = q.w;
  } else {
#pragma unroll
    for (int k = 0; k < kGroup; ++k) v[1 + k] = row[min(j0 + k, S - 1)];
  }
  v[0] = row[max(j0 - 1, 0)];
  v[5] = row[min(j0 + kGroup, S - 1)];
}

__device__ __forceinline__ float min6(const float (&v)[6]) {
  return min_nan(min_nan(min_nan(v[0], v[1]), min_nan(v[2], v[3])), min_nan(v[4], v[5]));
}

__device__ __forceinline__ float max6(const float (&v)[6]) {
  return max_nan(max_nan(max_nan(v[0], v[1]), max_nan(v[2], v[3])), max_nan(v[4], v[5]));
}

// Reserve `count` consecutive slots of a shared-memory queue for each lane
// of a (full) warp with one atomic: returns this lane's first slot.
__device__ __forceinline__ int warp_reserve(int* counter, int count, int lane) {
  int incl = count;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  int base = 0;
  if (lane == 31 && incl) base = atomicAdd(counter, incl);
  return __shfl_sync(0xffffffffu, base, 31) + incl - count;
}

struct Args {
  const float* x;
  int* counts;  // (3, N): hi, lo, area
  int N, S, s, h_in, w_in;
  int R, C;            // the region's low-res rows and columns
  int band, n_bands;   // low-res rows a CTA owns; bands a slab
  int cap_p;           // the pixel queue's capacity
  Cutoffs cut;
};

// One CTA per (slab n, band b): owned rows [i0, i1) of the region, staged
// rows [r0, r1] (the owned rows and their clamped neighbours).
//   1. stage the rows (cp.async);
//   2. groups: each thread takes a column group (four columns) down a strip
//      of rows and keeps the min and max of the three rows' six columns
//      around it, rolling (one row of six loads a step).  A block whose min
//      is >= c_+1 counts every phase of its four pixels for all three
//      thresholds; one whose max is <= d_-1 counts none; every other group
//      is queued (warp-aggregated ballot);
//   3. queued groups, one a thread: each pixel's own 3x3 window settles it
//      at its level (0-3 thresholds) or queues it (or, if the pixel queue
//      is full, forms its phases in place);
//   4. queued pixels, one a thread: all s*s phases.
template <int KS, bool VEC>
__global__ void __launch_bounds__(kMaxThreads) phase_counts_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int red[3][kMaxWarps];
  __shared__ int n_groups, n_pixels;
  __shared__ float wf_s[kMaxS], wa_s[kMaxS];

  const int tid = threadIdx.x, T = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int S = a.S, s = a.s, C = a.C;
  const int Cg = (C + kGroup - 1) / kGroup;
  const int n = blockIdx.x / a.n_bands;
  const int i0 = (blockIdx.x - n * a.n_bands) * a.band;
  const int i1 = min(i0 + a.band, a.R);
  const int r0 = max(i0 - 1, 0), r1 = min(i1, S - 1);
  const int cap = a.cap_p;  // the pixel queue's
  float* rows = smem;                                              // staged rows x S
  int* gq = reinterpret_cast<int*>(smem + (a.band + 2) * S);       // queued groups
  int* pq = gq + a.band * Cg;                                      // queued pixels
  auto row = [&](int r) { return rows + (min(max(r, r0), r1) - r0) * S; };

  {  // 1. stage rows r0..r1: one contiguous run of the slab
    const float* src = a.x + (static_cast<size_t>(n) * S + r0) * S;
    const int count = (r1 - r0 + 1) * S;
    if constexpr (VEC) {
      for (int k = 4 * tid; k < count; k += 4 * T) cp_async16(rows + k, src + k);
    } else {
      for (int k = tid; k < count; k += T) cp_async4(rows + k, src + k);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  }
  if (KS == 0 && tid < s) {
    const double f = phase_f(tid, s);
    wf_s[tid] = static_cast<float>(f);
    wa_s[tid] = static_cast<float>(f < 0.0 ? 1.0 + f : 1.0 - f);
  }
  if (tid == 0) n_groups = 0, n_pixels = 0;
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();

  const Cutoffs cut = a.cut;
  int hi = 0, lo = 0, area = 0, full = 0;

  // 2. Groups down strips of rows: G strips of L rows share the band when
  // the CTA has more threads than the region has groups.  Loop bounds are
  // CTA-uniform, so every warp votes with all its lanes.
  {
    const int G = max(1, T / Cg);
    const int L = (i1 - i0 + G - 1) / G;
    for (int u0 = 0; u0 < G * Cg; u0 += T) {
      const int u = u0 + tid;
      const bool in = u < G * Cg;
      const int g = in ? u % Cg : 0;
      const int j0 = kGroup * g;
      const int ra = i0 + (in ? u / Cg : 0) * L;
      const int rb = in ? min(ra + L, i1) : ra;
      int nx = 0;
#pragma unroll
      for (int k = 0; k < kGroup; ++k) nx += min(max(a.w_in - s * (j0 + k), 0), s);
      float v[6];
      load6<VEC>(row(ra - 1), j0, S, v);
      float mn_u = min6(v), mx_u = max6(v);  // row above
      load6<VEC>(row(ra), j0, S, v);
      float mn_c = min6(v), mx_c = max6(v);  // this row
      for (int t = 0; t < L; ++t) {
        const int i = ra + t;
        load6<VEC>(row(min(i + 1, S - 1)), j0, S, v);
        const float mn_d = min6(v), mx_d = max6(v);  // row below
        const float mn = min_nan(min_nan(mn_u, mn_c), mn_d);
        const float mx = max_nan(max_nan(mx_u, mx_c), mx_d);
        mn_u = mn_c, mx_u = mx_c, mn_c = mn_d, mx_c = mx_d;
        bool queue = false;
        if (i < rb) {
          if (mn >= cut.c[2] && mx <= FLT_MAX)
            full += min(a.h_in - s * i, s) * nx;  // every phase above +1
          else
            queue = !(mx <= cut.d[0] && mn >= -FLT_MAX);  // else: none above -1
        }
        const unsigned ballot = __ballot_sync(0xffffffffu, queue);
        if (ballot) {
          int base = 0;
          if (lane == 0) base = atomicAdd(&n_groups, __popc(ballot));
          base = __shfl_sync(0xffffffffu, base, 0);
          if (queue) gq[base + __popc(ballot & ((1u << lane) - 1u))] = (i << 16) | g;
        }
      }
    }
  }
  __syncthreads();

  Weights<KS> w;
  if constexpr (KS == 0) w = Weights<0>{wf_s, wa_s};

  // 3. Queued groups: each pixel by its own window.
  const int ng = n_groups;
  for (int q0 = 0; q0 < ng; q0 += T) {
    const int q = q0 + tid;
    int pending = 0;  // bit k: pixel k of the group is undecided
    int i = 0, j0 = 0;
    float xu[6], xc[6], xd[6];
    if (q < ng) {
      const int e = gq[q];
      i = e >> 16, j0 = kGroup * (e & 0xffff);
      load6<VEC>(row(i - 1), j0, S, xu);
      load6<VEC>(row(i), j0, S, xc);
      load6<VEC>(row(min(i + 1, S - 1)), j0, S, xd);
      float cmn[6], cmx[6];
#pragma unroll
      for (int c = 0; c < 6; ++c) {
        cmn[c] = min_nan(min_nan(xu[c], xc[c]), xd[c]);
        cmx[c] = max_nan(max_nan(xu[c], xc[c]), xd[c]);
      }
      const int ny = min(a.h_in - s * i, s);
#pragma unroll
      for (int k = 0; k < kGroup; ++k) {
        const int nx = min(max(a.w_in - s * (j0 + k), 0), s);
        const float mn = min_nan(min_nan(cmn[k], cmn[k + 1]), cmn[k + 2]);
        const float mx = max_nan(max_nan(cmx[k], cmx[k + 1]), cmx[k + 2]);
        // `up`: thresholds every phase is above; `nb`: thresholds some
        // phase may be above.  The cutoffs ascend, so the pixel is settled
        // iff the two agree (and the window is finite).
        const int up = (mn >= cut.c[0]) + (mn >= cut.c[1]) + (mn >= cut.c[2]);
        const int nb = !(mx <= cut.d[0]) + !(mx <= cut.d[1]) + !(mx <= cut.d[2]);
        if (nx == 0) continue;  // outside the region
        if (up == nb && mn >= -FLT_MAX && mx <= FLT_MAX) {
          const int cnt = ny * nx;
          lo += up >= 1 ? cnt : 0;
          area += up >= 2 ? cnt : 0;
          hi += up >= 3 ? cnt : 0;
        } else {
          pending |= 1 << k;
        }
      }
    }
    int slot = warp_reserve(&n_pixels, __popc(pending), lane);
#pragma unroll
    for (int k = 0; k < kGroup; ++k) {
      if (!(pending >> k & 1)) continue;
      const int j = j0 + k;
      if (slot < cap) {
        pq[slot++] = (i << 16) | j;
      } else {  // the queue is full: form this pixel's phases here
        ++slot;
        const float u3[3] = {xu[k], xu[k + 1], xu[k + 2]};
        const float c3[3] = {xc[k], xc[k + 1], xc[k + 2]};
        const float d3[3] = {xd[k], xd[k + 1], xd[k + 2]};
        full_pixel<KS>(w, s, min(a.h_in - s * i, s), min(a.w_in - s * j, s), u3, c3, d3, hi,
                       lo, area);
      }
    }
  }
  __syncthreads();

  // 4. Queued pixels: all s*s phases.
  const int np = min(n_pixels, cap);
  for (int q = tid; q < np; q += T) {
    const int e = pq[q];
    const int i = e >> 16, j = e & 0xffff;
    const int jm = max(j - 1, 0), jp = min(j + 1, S - 1);
    const float* ru = row(i - 1);
    const float* rc = row(i);
    const float* rd = row(min(i + 1, S - 1));
    const float xu[3] = {ru[jm], ru[j], ru[jp]};
    const float xc[3] = {rc[jm], rc[j], rc[jp]};
    const float xd[3] = {rd[jm], rd[j], rd[jp]};
    full_pixel<KS>(w, s, min(a.h_in - s * i, s), min(a.w_in - s * j, s), xu, xc, xd, hi, lo,
                   area);
  }

  hi = warp_sum(hi + full);
  lo = warp_sum(lo + full);
  area = warp_sum(area + full);
  if (lane == 0) {
    red[0][warp] = hi;
    red[1][warp] = lo;
    red[2][warp] = area;
  }
  __syncthreads();
  if (tid < 3) {
    int total = 0;
    for (int k = 0; k < T / 32; ++k) total += red[tid][k];
    if (total) atomicAdd(a.counts + tid * a.N + n, total);
  }
}

template <int KS, bool VEC>
int launch(const Args& a, int threads, int smem, cudaStream_t st) {
  static int smem_set = 48 * 1024;
  if (smem > smem_set) {  // refused beyond the card's limit
    const cudaError_t e = cudaFuncSetAttribute(
        phase_counts_kernel<KS, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = smem;
  }
  phase_counts_kernel<KS, VEC><<<a.N * a.n_bands, threads, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x: contiguous (N, S, S) float32 on the device; counts: (3, N) int32 (hi,
// lo, area), zeroed here on the stream before the kernel adds to it.
// (band, threads, smem) is the plan (ops/phase_counts.py `launch_plan` and
// `smem_bytes`, which own the shared-memory size): a CTA's shared memory
// holds its band + 2 staged rows, then the group queue (band x column
// groups), then the pixel queue, which takes the rest (pixels that do not
// fit are formed in place).  cutoffs points to six host floats c_-1, c_0,
// c_+1, d_-1, d_0, d_+1.  Returns the CUDA error of the launch (0 on
// success); refuses a plan whose smem does not hold the rows and the group
// queue.
int phase_counts_launch(const float* x, int N, int S, int s, int h_in, int w_in, int band,
                        int threads, int smem, const float* cutoffs, int* counts,
                        void* stream) {
  if (s < 1 || s > kMaxS || N < 1 || S < 1 || S > 0xffff || band < 1 || threads < 32 ||
      threads > kMaxThreads || threads % 32 != 0 || h_in < 1 || w_in < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.x = x, a.counts = counts, a.N = N, a.S = S, a.s = s, a.h_in = h_in, a.w_in = w_in;
  a.R = min((h_in + s - 1) / s, S);
  a.C = min((w_in + s - 1) / s, S);
  a.band = band;
  a.n_bands = (a.R + band - 1) / band;
  const long long fixed = static_cast<long long>(band + 2) * S +
                          static_cast<long long>(band) * ((a.C + kGroup - 1) / kGroup);
  a.cap_p = static_cast<int>(smem / 4 - fixed);
  if (smem / 4 < fixed || static_cast<long long>(N) * a.n_bands > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int k = 0; k < 3; ++k) {
    a.cut.c[k] = cutoffs[k];
    a.cut.d[k] = cutoffs[3 + k];
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e = cudaMemsetAsync(counts, 0, sizeof(int) * 3 * static_cast<size_t>(N), st);
  if (e != cudaSuccess) return static_cast<int>(e);
  // 16-byte row copies and loads where every row is 16-byte aligned; the
  // s = 4 of SAM's x4 upsample has its weights and phase loops at compile
  // time.  Each is measured against the generic route in PERF.md.
  const bool vec = S % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  if (s == 4)
    return vec ? launch<4, true>(a, threads, smem, st) : launch<4, false>(a, threads, smem, st);
  return vec ? launch<0, true>(a, threads, smem, st) : launch<0, false>(a, threads, smem, st);
}

}  // extern "C"
