// K2: the whole Jacobi-preconditioned CG of one BiNI segment, held on chip
// by one thread-block cluster.
//
// Replaces the Pallas TPU kernel super_primitive_tpu/ops/pallas_stencil.py
// `bini_cg_pallas` (body `_cg_kernel_body`), with the same math: masked b
// and x0, inverse-diagonal preconditioner, tolerance floor
// max(tol, 5e-7) * |b|, best-iterate tracking, a stop when |r| exceeds
// 10x the best, and the `max_iter` cap.  Each segment stops on its own.
//
// Bound: latency.  An iteration does ~33 flops a pixel, nanoseconds of the
// card's rate at these sizes; what it waits on is its chain of a stencil,
// two reductions and the barriers between them.  Design:
// - One segment per cluster of C CTAs (C = 1 for small fields).  The
//   field's rows are cut into C contiguous bands, one per CTA.  Thread t of
//   a CTA owns the band's pixels t, t + T, ... (up to PPT of them) for the
//   whole solve.
// - The solve lives on chip: p, q_up, q_um, q_vp (with the row above the
//   band), q_vm (with the row below), 1/diag, the mask and the best iterate
//   of the band in shared memory; x, r and Ap of the owned pixels in
//   registers.  The inputs are read from device memory once and the result
//   written once; there is no scratch.
// - Two reductions an iteration: <p, Ap>, then <r, z> and <r, r> fused.
//   Each sums float32 products in float64 (a thread over its pixels, then a
//   shuffle butterfly in the warp, then the warps' partials through shared
//   memory), then every CTA reads all C CTA totals over distributed shared
//   memory (DSMEM) and sums them with the same butterfly.  Every CTA thus
//   holds bit-identical totals, as the plain version's float64 sums rounded
//   once give, and takes the same stop decision.  It must: a CTA that left
//   the loop alone would leave the others waiting at the next cluster
//   barrier for ever.
// - The rows of p just outside a band (the halo) need no barrier of their
//   own.  Before the second reduction's cluster barrier each CTA posts its
//   edge rows' p and z in a mailbox; after it, each CTA reads its
//   neighbours' mailboxes over DSMEM and forms the halo of the next p as
//   z + beta p, the same floats its neighbours compute for those rows.  The
//   stencil then reads shared memory only.  Row 0's upper neighbour is row
//   H-1 (held by the last CTA) and row H-1's lower neighbour row 0, as in
//   the roll-based reference, so the result equals the plain version for
//   any q.
// Divisions and sqrt round to nearest (no fast math, -fmad=false).
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "bini_stencil.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kWarp = 32;
constexpr int kMaxCluster = 16;
constexpr int kSmemMax = 232448;  // the shared memory a CTA can opt into
// shared doubles: the warps' partials of the three- and the one-value
// reductions, and two slots of CTA totals that the cluster reads
constexpr int kReduceDoubles = 3 * kWarp + kWarp + 4 + 4;
// shared floats a band pixel: p, q_up, q_um, 1/diag, mask, best x, q_vp,
// q_vm
constexpr int kBandFields = 8;
// shared floats a column: q_vp's and q_vm's halo rows, p's two halo rows
// and the mailbox (p and z of the band's first and last rows)
constexpr int kColumnFields = 8;

// The largest CTA for PPT owned pixels a thread: 1024 threads leave 64
// registers a thread, enough for up to 4 pixels' x, r and Ap; 8 pixels
// take 640 threads (up to 96 registers).
template <int PPT>
constexpr int kMaxThreads = PPT <= 4 ? 1024 : 640;

struct CgArgs {
  const float* b;
  const float* x0;
  const float* mask;
  const float* diag;
  const float* q_up;
  const float* q_um;
  const float* q_vp;
  const float* q_vm;
  float* out;
  int* iters;
  int H, W, cluster, rows_max, max_iter;
  float tol;
};

long smem_bytes_for(int rows_max, int W) {
  return 8L * kReduceDoubles +
         4L * (kBandFields * static_cast<long>(rows_max) * W + kColumnFields * static_cast<long>(W));
}

// Pixels a thread owns when `cluster` CTAs of `threads` threads hold an
// (H, W) field, or 0 when they do not hold it.  The same rule as
// `stencil.cg_pixels_per_thread`, which plans the launch.
int plan_pixels_per_thread(int H, int W, int cluster, int threads) {
  if (H < 1 || W < 1 || cluster < 1 || cluster > kMaxCluster || cluster > H) return 0;
  if (threads < kWarp || threads > 1024 || threads % kWarp != 0) return 0;
  const int rows_max = (H + cluster - 1) / cluster;
  if (smem_bytes_for(rows_max, W) > kSmemMax) return 0;
  const long band = static_cast<long>(rows_max) * W;
  if (band <= 2L * threads && threads <= kMaxThreads<2>) return 2;
  if (band <= 4L * threads && threads <= kMaxThreads<4>) return 4;
  if (band <= 8L * threads && threads <= kMaxThreads<8>) return 8;
  return 0;
}

__device__ __forceinline__ float inv_diag_at(float d) {
  return d > 1e-12f ? 1.0f / d : 0.0f;
}

// The cluster barrier, split.  Not `.aligned`: a warp may reach it
// straight after a branch on the thread index.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// Butterfly sum over the warp.  Each level adds a pair in both lanes, and
// a + b == b + a, so every lane ends with the same bits.
__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sums NV values over the CTA; every thread gets the totals.  `wp` holds
// NV * 32 doubles and must not be written again before the next CTA barrier.
template <int NV>
__device__ __forceinline__ void cta_sum(double (&v)[NV], double* wp) {
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    v[k] = warp_sum(v[k]);
    if (lane == 0) wp[k * kWarp + warp] = v[k];
  }
  __syncthreads();
  const int nwarps = blockDim.x / kWarp;
#pragma unroll
  for (int k = 0; k < NV; ++k) v[k] = warp_sum(lane < nwarps ? wp[k * kWarp + lane] : 0.0);
}

// The cluster half of a reduction, split so that work can run between the
// arrive and the wait: `publish` puts this CTA's totals in `slot` and
// arrives; `gather` waits, then sums every CTA's slot (lane k reads rank
// k's) with the warp butterfly, in every warp of every CTA alike.
template <int NV>
__device__ __forceinline__ void publish(const double (&v)[NV], double* slot) {
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < NV; ++k) slot[k] = v[k];
  }
  cluster_arrive();
}

template <int NV>
__device__ __forceinline__ void gather(double (&v)[NV], double* slot,
                                       cg::cluster_group& cl, int C) {
  cluster_wait();
  const int lane = threadIdx.x % kWarp;
  const double* remote = cl.map_shared_rank(slot, lane < C ? lane : 0);
#pragma unroll
  for (int k = 0; k < NV; ++k) v[k] = warp_sum(lane < C ? remote[k] : 0.0);
}

// Flags of an owned pixel, 4 bits each: column 0, column W-1, the band's
// first row, its last row.
constexpr unsigned kCol0 = 1, kColLast = 2, kRow0 = 4, kRowLast = 8;

// One CTA's band in shared memory.  `p_up` / `p_dn` are the rows of p just
// above and below it: the halo rows, or this band's own last and first
// rows when one CTA holds the whole field.
struct Band {
  float* p;
  float* qup;
  float* qum;
  float* invd;
  float* m;
  float* xb;   // the best iterate
  float* qvp;  // the row above the band, then the band
  float* qvm;  // the band, then the row below
  const float* p_up;
  const float* p_dn;
  int W, size;

  // A p at band pixel j (band-linear index) with flags f
  __device__ __forceinline__ float apply(int j, unsigned f) const {
    const int jm = (f & kCol0) ? j + W - 1 : j - 1;
    const int jp = (f & kColLast) ? j - (W - 1) : j + 1;
    const float pu = (f & kRow0) ? p_up[j] : p[j - W];
    const float pd = (f & kRowLast) ? p_dn[j - (size - W)] : p[j + W];
    return bini_stencil(p[j], p[jm], p[jp], pu, pd, qup[j], qup[jm], qum[j],
                        qum[jp], qvp[j + W], qvp[j], qvm[j], qvm[j + W]);
  }
};

// The halo rows of a cluster's CTA and where they come from: `mail` is
// this CTA's mailbox, p and z of its first row then p and z of its last;
// `from_up` and `from_dn` are the mailboxes (DSMEM) of the CTAs above and
// below, whose last and first rows are this band's halo.
struct Halo {
  float* up;
  float* dn;
  float* mail;
  const float* from_up;
  const float* from_dn;
  int W;

  // post p and z of an owned pixel of the first or last row
  __device__ __forceinline__ void post(int j, unsigned f, int size, float p, float z) const {
    if (f & kRow0) {
      mail[j] = p;
      mail[W + j] = z;
    }
    if (f & kRowLast) {
      const int c = j - (size - W);
      mail[2 * W + c] = p;
      mail[3 * W + c] = z;
    }
  }

  // the halo of the next p, z + beta p, after the cluster barrier that
  // follows the posts; the first p is z itself
  __device__ __forceinline__ void fill(float beta, bool first) const {
    for (int c = threadIdx.x; c < W; c += blockDim.x) {
      up[c] = first ? from_up[3 * W + c] : from_up[3 * W + c] + beta * from_up[2 * W + c];
      dn[c] = first ? from_dn[W + c] : from_dn[W + c] + beta * from_dn[c];
    }
  }
};

// ap[k] = (A p)[j] * m at the owned pixels, and the sum of p * ap * m over
// them.  Starts with the barrier that orders this CTA's p and halo writes
// before the reads.
template <int PPT>
__device__ __forceinline__ double stencil(const Band& s, float (&ap)[PPT], unsigned flags) {
  __syncthreads();
  double acc = 0.0;
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int j = threadIdx.x + k * blockDim.x;
    if (j < s.size) {
      const float mk = s.m[j];
      ap[k] = s.apply(j, flags >> (4 * k)) * mk;
      acc += s.p[j] * ap[k] * mk;
    }
  }
  return acc;
}

template <int PPT>
__global__ void __launch_bounds__(kMaxThreads<PPT>, 1) bini_cg_kernel(CgArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* wp3 = reinterpret_cast<double*>(smem_raw);
  double* wp1 = wp3 + 3 * kWarp;
  double* slot3 = wp1 + kWarp;
  double* slot1 = slot3 + 4;
  const int H = a.H, W = a.W, C = a.cluster;
  const bool halo = C > 1;  // some neighbour rows live in other CTAs

  cg::cluster_group cl = cg::this_cluster();
  const int rank = halo ? static_cast<int>(cl.block_rank()) : 0;
  const int seg = blockIdx.x / C;
  const int row0 = rank * H / C;
  const int rows = (rank + 1) * H / C - row0;
  const size_t field = static_cast<size_t>(seg) * H * W;
  const size_t off = field + static_cast<size_t>(row0) * W;

  // every CTA lays its band out alike, sized for the largest band
  const int band_max = a.rows_max * W;
  Band s;
  s.p = reinterpret_cast<float*>(slot1 + 4);
  s.qup = s.p + band_max;
  s.qum = s.qup + band_max;
  s.invd = s.qum + band_max;
  s.m = s.invd + band_max;
  s.xb = s.m + band_max;
  s.qvp = s.xb + band_max;
  s.qvm = s.qvp + band_max + W;
  s.W = W;
  s.size = rows * W;
  Halo h;
  h.up = s.qvm + band_max + W;
  h.dn = h.up + W;
  h.mail = h.dn + W;
  h.W = W;
  if (!halo) {
    s.p_up = s.p + (H - 1) * W;
    s.p_dn = s.p;
  } else {
    s.p_up = h.up;
    s.p_dn = h.dn;
    const int prev = rank == 0 ? C - 1 : rank - 1;
    const int next = rank == C - 1 ? 0 : rank + 1;
    h.from_up = cl.map_shared_rank(h.mail, prev);
    h.from_dn = cl.map_shared_rank(h.mail, next);
  }

  const int tid = threadIdx.x;
  const int T = blockDim.x;
  float x[PPT], r[PPT], ap[PPT];
  unsigned flags = 0;

  // Read the inputs once: x = x0 * m (also the first best iterate, and the
  // first field the stencil reads), r = b * m for now, |b|^2.
  double v3[3] = {0.0, 0.0, 0.0};
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int j = tid + k * T;
    x[k] = r[k] = ap[k] = 0.0f;
    if (j < s.size) {
      const int lr = j / W;
      const int c = j - lr * W;
      flags |= ((c == 0 ? kCol0 : 0u) | (c == W - 1 ? kColLast : 0u) |
                (lr == 0 ? kRow0 : 0u) | (lr == rows - 1 ? kRowLast : 0u)) << (4 * k);
      const float mk = a.mask[off + j];
      const float xk = a.x0[off + j] * mk;
      const float bm = a.b[off + j] * mk;
      x[k] = xk;
      r[k] = bm;
      v3[0] += bm * bm * mk;
      s.p[j] = xk;
      s.xb[j] = xk;
      s.m[j] = mk;
      s.invd[j] = inv_diag_at(a.diag[off + j]);
      s.qup[j] = a.q_up[off + j];
      s.qum[j] = a.q_um[off + j];
      s.qvp[j + W] = a.q_vp[off + j];
      s.qvm[j] = a.q_vm[off + j];
    }
  }
  const size_t row_up = field + static_cast<size_t>((row0 + H - 1) % H) * W;
  const size_t row_dn = field + static_cast<size_t>((row0 + rows) % H) * W;
  for (int c = tid; c < W; c += T) {
    s.qvp[c] = a.q_vp[row_up + c];
    s.qvm[s.size + c] = a.q_vm[row_dn + c];
    if (halo) {  // x's halo rows come from the inputs too
      h.up[c] = a.x0[row_up + c] * a.mask[row_up + c];
      h.dn[c] = a.x0[row_dn + c] * a.mask[row_dn + c];
    }
  }

  // r = (b m - A x m) m, z = r / diag, and <r, z>, <r, r> beside |b|^2;
  // the edge rows post z, the first p
  stencil<PPT>(s, ap, flags);
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int j = tid + k * T;
    if (j < s.size) {
      const float mk = s.m[j];
      const float ri = (r[k] - ap[k]) * mk;
      const float zi = ri * s.invd[j] * mk;
      r[k] = ri;
      if (halo) h.post(j, flags >> (4 * k), s.size, 0.0f, zi);
      v3[1] += ri * zi * mk;
      v3[2] += ri * ri * mk;
    }
  }
  cta_sum<3>(v3, wp3);
  if (halo) {
    publish<3>(v3, slot3);
    gather<3>(v3, slot3, cl, C);
    h.fill(0.0f, true);
  }
  // every stencil read of x came before the barriers above: p = z
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int j = tid + k * T;
    if (j < s.size) s.p[j] = r[k] * s.invd[j] * s.m[j];
  }

  const float b_norm = sqrtf(static_cast<float>(v3[0]));
  const float thresh = fmaxf(a.tol, 5e-7f) * fmaxf(b_norm, 1e-30f);
  float rz = static_cast<float>(v3[1]);
  float r_norm = sqrtf(static_cast<float>(v3[2]));
  float best = r_norm;
  int it = 0;
  // Every CTA of the cluster holds the same r_norm, best and thresh, so all
  // leave this loop at the same iteration.
  while (it < a.max_iter && !(r_norm <= thresh || r_norm > 10.0f * best + 1e-30f)) {
    const bool improved = r_norm < best;
    best = fminf(best, r_norm);

    // Ap = A p * m and <p, Ap>; the best iterate (x before this step) is
    // kept while the cluster gathers the sum
    double v1[1] = {stencil<PPT>(s, ap, flags)};
    cta_sum<1>(v1, wp1);
    if (halo) publish<1>(v1, slot1);
    if (improved) {
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        const int j = tid + k * T;
        if (j < s.size) s.xb[j] = x[k];
      }
    }
    if (halo) gather<1>(v1, slot1, cl, C);
    const float pap = static_cast<float>(v1[0]);
    const float alpha = pap > 1e-30f ? rz / pap : 0.0f;

    // r -= alpha Ap, z = r / diag, <r, z> and <r, r>, the edge rows' posts;
    // x += alpha p while the cluster gathers the sums
    double v2[2] = {0.0, 0.0};
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      const int j = tid + k * T;
      if (j < s.size) {
        const float mk = s.m[j];
        const float ri = r[k] - alpha * ap[k];
        const float zi = ri * s.invd[j] * mk;
        r[k] = ri;
        if (halo) h.post(j, flags >> (4 * k), s.size, s.p[j], zi);
        v2[0] += ri * zi * mk;
        v2[1] += ri * ri * mk;
      }
    }
    cta_sum<2>(v2, wp3);
    if (halo) publish<2>(v2, slot3);
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      const int j = tid + k * T;
      if (j < s.size) x[k] = x[k] + alpha * s.p[j];
    }
    if (halo) gather<2>(v2, slot3, cl, C);
    const float rz_new = static_cast<float>(v2[0]);
    const float beta = rz > 1e-30f ? rz_new / rz : 0.0f;

    // p = z + beta p on the owned pixels and the halo; every stencil read
    // of the old p came before the barriers above
    if (halo) h.fill(beta, false);
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      const int j = tid + k * T;
      if (j < s.size) {
        const float zi = r[k] * s.invd[j] * s.m[j];
        s.p[j] = zi + beta * s.p[j];
      }
    }
    rz = rz_new;
    r_norm = sqrtf(static_cast<float>(v2[1]));
    ++it;
  }

  // the final iterate may beat the recorded best
  const bool last = r_norm < best;
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int j = tid + k * T;
    if (j < s.size) a.out[off + j] = last ? x[k] : s.xb[j];
  }
  if (rank == 0 && tid == 0) a.iters[seg] = it;
  // no CTA may leave while another can still read its shared memory
  if (halo) {
    cluster_arrive();
    cluster_wait();
  }
}

template <int PPT>
cudaLaunchConfig_t launch_config(int grid, int cluster, int threads, int smem_bytes,
                                 cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaFuncSetAttribute(bini_cg_kernel<PPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       kSmemMax);
  cudaFuncSetAttribute(bini_cg_kernel<PPT>,
                       cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int PPT>
int max_clusters(int cluster, int threads, int smem_bytes) {
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      launch_config<PPT>(cluster, cluster, threads, smem_bytes, nullptr, attr);
  int n = 0;
  const cudaError_t err = cudaOccupancyMaxActiveClusters(
      &n, reinterpret_cast<const void*>(bini_cg_kernel<PPT>), &cfg);
  return err != cudaSuccess ? -static_cast<int>(err) : n;
}

template <int PPT>
int launch(const CgArgs& args, int N, int threads, cudaStream_t stream) {
  cudaLaunchAttribute attr[1];
  const int smem_bytes = static_cast<int>(smem_bytes_for(args.rows_max, args.W));
  const cudaLaunchConfig_t cfg =
      launch_config<PPT>(N * args.cluster, args.cluster, threads, smem_bytes, stream, attr);
  const cudaError_t err = cudaLaunchKernelEx(&cfg, bini_cg_kernel<PPT>, args);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// How many clusters of the plan (cluster, threads) for an (H, W) field the
// card can hold at once (0: it cannot schedule the plan), or minus the CUDA
// error.
int bini_cg_max_clusters(int H, int W, int cluster, int threads) {
  const int ppt = plan_pixels_per_thread(H, W, cluster, threads);
  if (ppt == 0) return -static_cast<int>(cudaErrorInvalidValue);
  const int smem_bytes = static_cast<int>(smem_bytes_for((H + cluster - 1) / cluster, W));
  switch (ppt) {
    case 2: return max_clusters<2>(cluster, threads, smem_bytes);
    case 4: return max_clusters<4>(cluster, threads, smem_bytes);
    case 8: return max_clusters<8>(cluster, threads, smem_bytes);
    default: return -static_cast<int>(cudaErrorInvalidValue);
  }
}

// Fields are contiguous (N, H, W) float32 on the device, `iters` is N
// int32.  The plan (cluster, threads) comes from `stencil.cg_plan`; one
// that does not hold the field is refused.  The shared memory a CTA is
// worked out here from the band.  Returns the CUDA error of the launch (0
// on success).
int bini_cg_launch(const float* b, const float* x0, const float* mask,
                   const float* diag, const float* q_up, const float* q_um,
                   const float* q_vp, const float* q_vm, float* out, int* iters,
                   int N, int H, int W, int max_iter, float tol, int cluster,
                   int threads, void* stream) {
  const int ppt = plan_pixels_per_thread(H, W, cluster, threads);
  if (ppt == 0) return static_cast<int>(cudaErrorInvalidValue);
  const CgArgs args{b, x0, mask, diag, q_up, q_um, q_vp, q_vm, out, iters, H, W,
                    cluster, (H + cluster - 1) / cluster, max_iter, tol};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (ppt) {
    case 2: return launch<2>(args, N, threads, s);
    case 4: return launch<4>(args, N, threads, s);
    case 8: return launch<8>(args, N, threads, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
