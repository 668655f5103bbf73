// PointNet++ sampling and grouping indices (kernel K7) for Hopper, sm_90a.
//
// Replaces no Pallas kernel: the JAX package has no PointNet++. The port's
// plain version (pointnetgpd_tpu_torch/ops/pointnet2_sample.py fps_plain,
// ball_query_plain) runs farthest-point sampling as a Python loop of
// batched torch ops, several launches per iteration (about 2,500 launches a
// train step at 512 + 128 iterations), and the ball query as a (B, S, N)
// distance block with a sort of each row. K7 is one launch for each.
//
// Distances: every squared distance is ((dx * dx) + (dy * dy)) + (dz * dz)
// with d = point - centroid, each operation rounded once to float32 (the
// file is built with -fmad=false and spells every operation as an
// intrinsic), as the plain version's separate torch ops round it. The
// indices therefore equal the plain version's exactly, ties included.
//
// 1. pn2_fps_kernel: one block per cloud. The cloud (as three coordinate
//    rows) and each point's running minimum squared distance to the chosen
//    set live in shared memory (16 bytes a point, so up to FPS_MAX_POINTS
//    points). The first index is 0. Each of the npoint - 1 iterations
//    lowers every point's minimum by its distance to the last chosen point,
//    then a block-wide argmax picks the point with the largest minimum,
//    the lowest index winning a tie (torch.argmax's first maximum): each
//    thread scans its points in index order with a strict compare, warps
//    reduce by shuffles, warp 0 reduces the warps.
// 2. pn2_ball_query_kernel: one warp per centroid, BQ_WARPS centroids a
//    block. The warp tests 32 points at a time in index order against
//    d^2 < r^2, writes the points found at their rank (a ballot and a
//    popc), and stops once nsample are found. The slots left are filled
//    with the first index found (0 where none was).
//
// What bounds it on the H100: FPS is a chain of dependent iterations, each
// a pass of 9 float32 instructions a point and two block barriers: at
// 1,024 points and 512 centroids its least time by instructions
// (33.5e12 a second over the card) is microseconds, while the chain's
// barriers and shuffles take about a microsecond an iteration. One block a
// cloud keeps B blocks on 132 SMs; the iterations cannot overlap. The ball
// query is bound by bytes: the cloud and the centroids read, the indices
// (int64, as torch indexes with them) written once.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define FPS_THREADS 512
#define FPS_MAX_POINTS 12800   // 16 bytes of shared memory a point
                               // (ops/pointnet2_sample.py FPS_MAX_POINTS)
#define BQ_WARPS 8
#define FULL 0xffffffffu

__device__ __forceinline__ float sqdist(float px, float py, float pz,
                                        float cx, float cy, float cz) {
  float dx = __fsub_rn(px, cx);
  float dy = __fsub_rn(py, cy);
  float dz = __fsub_rn(pz, cz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// (v, i) beats (bv, bi): a larger value, or an equal one at a lower index
__device__ __forceinline__ void take_best(float& bv, int& bi, float v, int i) {
  if (v > bv || (v == bv && i < bi)) {
    bv = v;
    bi = i;
  }
}

__global__ void __launch_bounds__(FPS_THREADS)
pn2_fps_kernel(const float* __restrict__ xyz, int n, int npoint,
               int64_t* __restrict__ out) {
  extern __shared__ float smem[];
  float* px = smem;
  float* py = px + n;
  float* pz = py + n;
  float* mind = pz + n;
  __shared__ float warp_v[FPS_THREADS / 32];
  __shared__ int warp_i[FPS_THREADS / 32];
  __shared__ int chosen;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* cloud = xyz + (size_t)blockIdx.x * n * 3;
  int64_t* o = out + (size_t)blockIdx.x * npoint;
  for (int i = tid; i < n; i += FPS_THREADS) {
    px[i] = cloud[3 * i];
    py[i] = cloud[3 * i + 1];
    pz[i] = cloud[3 * i + 2];
    mind[i] = INFINITY;
  }
  if (tid == 0) o[0] = 0;
  __syncthreads();

  int last = 0;
  for (int it = 1; it < npoint; ++it) {
    const float lx = px[last], ly = py[last], lz = pz[last];
    float bv = -1.0f;   // every minimum is >= 0
    int bi = n;
    for (int i = tid; i < n; i += FPS_THREADS) {
      float m = fminf(mind[i], sqdist(px[i], py[i], pz[i], lx, ly, lz));
      mind[i] = m;
      if (m > bv) {     // index order within the thread: the first wins
        bv = m;
        bi = i;
      }
    }
    for (int off = 16; off > 0; off >>= 1)
      take_best(bv, bi, __shfl_down_sync(FULL, bv, off),
                __shfl_down_sync(FULL, bi, off));
    if (lane == 0) {
      warp_v[warp] = bv;
      warp_i[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      bv = lane < FPS_THREADS / 32 ? warp_v[lane] : -1.0f;
      bi = lane < FPS_THREADS / 32 ? warp_i[lane] : n;
      for (int off = 16; off > 0; off >>= 1)
        take_best(bv, bi, __shfl_down_sync(FULL, bv, off),
                  __shfl_down_sync(FULL, bi, off));
      if (lane == 0) {
        chosen = bi;
        o[it] = bi;
      }
    }
    __syncthreads();
    last = chosen;
  }
}

__global__ void __launch_bounds__(BQ_WARPS * 32)
pn2_ball_query_kernel(const float* __restrict__ xyz, int n,
                      const float* __restrict__ centroids, int s, float r2,
                      int nsample, int64_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int q = blockIdx.x * BQ_WARPS + (threadIdx.x >> 5);
  if (q >= s) return;   // a whole warp at once
  const size_t row = (size_t)blockIdx.y * s + q;
  const float* cloud = xyz + (size_t)blockIdx.y * n * 3;
  const float cx = centroids[3 * row], cy = centroids[3 * row + 1],
              cz = centroids[3 * row + 2];
  int64_t* o = out + row * nsample;
  int count = 0, first = -1;
  for (int base = 0; base < n && count < nsample; base += 32) {
    const int j = base + lane;
    bool in = false;
    if (j < n)
      in = sqdist(cloud[3 * j], cloud[3 * j + 1], cloud[3 * j + 2], cx, cy,
                  cz) < r2;
    const unsigned hit = __ballot_sync(FULL, in);
    if (hit) {
      if (first < 0) first = base + __ffs(hit) - 1;
      const int rank = count + __popc(hit & ((1u << lane) - 1u));
      if (in && rank < nsample) o[rank] = j;
      count += __popc(hit);
    }
  }
  const int64_t fill = first < 0 ? 0 : first;
  for (int k = min(count, nsample) + lane; k < nsample; k += 32) o[k] = fill;
}

// xyz (B, N, 3) float32, out (B, npoint) int64
extern "C" int pn2_fps_launch(const float* xyz, int b, int n, int npoint,
                              int64_t* out, cudaStream_t stream) {
  if (b <= 0 || npoint <= 0) return 0;
  if (n <= 0 || n > FPS_MAX_POINTS) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)16 * n;
  cudaError_t err = cudaFuncSetAttribute(
      pn2_fps_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  pn2_fps_kernel<<<b, FPS_THREADS, smem, stream>>>(xyz, n, npoint, out);
  return (int)cudaGetLastError();
}

// xyz (B, N, 3), centroids (B, S, 3) float32, out (B, S, nsample) int64
extern "C" int pn2_ball_query_launch(const float* xyz, int b, int n,
                                     const float* centroids, int s, float r2,
                                     int nsample, int64_t* out,
                                     cudaStream_t stream) {
  if (b <= 0 || s <= 0 || nsample <= 0) return 0;
  dim3 grid((s + BQ_WARPS - 1) / BQ_WARPS, b);
  pn2_ball_query_kernel<<<grid, BQ_WARPS * 32, 0, stream>>>(
      xyz, n, centroids, s, r2, nsample, out);
  return (int)cudaGetLastError();
}
