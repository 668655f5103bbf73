// GPG shifted-box panel counts (kernel K1) for Hopper, sm_90a.
//
// Replaces the TPU kernel pointnetgpd_tpu/ops/gpg_counts_pallas.py
// (_kernel via _counts_pallas, called from GpgScanContext.counts). For every
// (frame, shift) pair it counts the cloud points strictly inside each of the
// 4 gripper panel boxes [open, bottom, left, right]; a scan shifts one
// in-frame axis (y for the dy scan, x for the approach and final scans).
//
// What bounds it on the H100: very little work. Only the (active frame,
// point) pairs inside both fixed-axis slabs of the boxes (the minor axis
// and the non-scanned in-plane axis) can count, a few hundred thousand per
// frame of the detector, and the bytes are a 20k-point cloud (240 KB) and
// the frames. So the card's rates are far away; what limits the kernel is
// latency: how few serial steps a frame takes, and launch overhead.
//
// Design (the TPU kernel put 128 frames on the lane axis, rotated a point
// tile with one MXU matmul per frame block and walked every shift with a
// vector compare, summing over point tiles in a revisited output block):
// - one block per frame, one block of NT = 1024 threads per SM, each
//   walking frames blockIdx.x, + gridDim.x, ... A frame outside `active`
//   gets zeros (the JAX contract, gpg_counts_pallas.py:182-191, allows 0
//   there). The block writes the frame's whole (Ns, 4) row with plain
//   stores: no zeroing of the output, no global atomics;
// - the cloud arrives Morton-sorted, in tiles of TILE points with a
//   bounding box each (GpgScanContext). A tile is visited only if its box,
//   projected onto the frame's minor-axis row and its fixed in-plane row,
//   can reach the union of the 4 boxes on those axes (axis_reaches: the test
//   is conservative, see its margin). The visited tiles' points are then
//   spread evenly over the block's threads, each loading its next point
//   before it counts the current one;
// - ranges instead of a shift walk. For a point inside a box's two fixed
//   slabs, d_n = fl(scanned - s_n) is non-increasing in s_n, so the shifts
//   that count it (lo < d_n < hi) are one contiguous run of the frame's
//   shifts in sorted order. The block sorts its <= 32 shifts once (stable,
//   ties kept in index order), finds the run's two ends by binary search on
//   exactly the predicates d > lo and d < hi, and adds +1 / -1 at the ends
//   into a per-box difference array in shared memory with shared atomics.
//   (Aggregating equal ends within a warp first, with __match_any_sync,
//   was slower on the H100.) A prefix sum at the end gives the counts in
//   sorted order, scattered back to the shift order;
// - numerics: frame coordinates are r_a0*x + r_a1*y + r_a2*z - off_a with
//   the fused multiply-adds spelled out as the plain version rounds them
//   (ops/fp.py lin3 and dot3), and this file is built with -fmad=false so
//   the compiler adds no others. Counts equal the plain version's exactly.
//   No tensor cores, so no TF32.

#include <cuda_runtime.h>
#include <stdint.h>

#define NT 1024
#define BLOCKS_PER_SM 1
#define TILE 64        // points per Morton tile (ops/gpg_counts.py TILE_POINTS)
#define NS_MAX 32      // shifts per scan (ops/gpg_counts.py MAX_SHIFTS)
#define LIST_MAX 1024  // tiles tested per pass of the tile loop

struct Boxes {
  float v[24];  // (4, 2, 3): box k, lo/hi, axis
};

__device__ __forceinline__ float lo_(const Boxes& b, int k, int a) { return b.v[k * 6 + a]; }
__device__ __forceinline__ float hi_(const Boxes& b, int k, int a) { return b.v[k * 6 + 3 + a]; }

// May the tile with box (L, H) hold a point whose frame coordinate on axis a
// (row ra, offset off) lies strictly inside (ulo, uhi)? The exact range of
// r_a . p - off over the box is [emin, emax]. The point's coordinate as the
// kernel computes it (three roundings and a subtraction) and emin, emax as
// computed here (three products, two adds, a subtraction) each differ from
// exact by at most a few units of 2^-24 * mag, where mag bounds every
// partial sum: sum_i |r_ai| max(|L_i|, |H_i|) + |off|. Ten such units are
// below 2^-20 * mag; the margin is 2^-16 * mag, 16 times that, so a skipped
// tile holds no point that the plain version counts. ops/gpg_counts.py
// tile_slab_mask is the same test in plain PyTorch.
__device__ __forceinline__ bool axis_reaches(const float* tb, float r0, float r1,
                                             float r2, float off, float ulo,
                                             float uhi) {
  const float ra[3] = {r0, r1, r2};
  float emin = 0.f, emax = 0.f, mag = fabsf(off);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float l = tb[i], h = tb[3 + i], r = ra[i];
    emin = emin + (r >= 0.f ? r * l : r * h);
    emax = emax + (r >= 0.f ? r * h : r * l);
    mag = mag + fabsf(r) * fmaxf(fabsf(l), fabsf(h));
  }
  emin = emin - off;
  emax = emax - off;
  const float margin = mag * 0x1p-16f + 1e-30f;
  return emax + margin > ulo && emin - margin < uhi;
}

// The point of item i of the visited tiles' points, if there is one.
__device__ __forceinline__ bool load_point(const float* __restrict__ pts, int P,
                                           const int* list, int i, int total,
                                           float& x, float& y, float& z) {
  if (i >= total) return false;
  const int p = list[i / TILE] * TILE + i % TILE;
  if (p >= P) return false;
  x = pts[p * 3 + 0];
  y = pts[p * 3 + 1];
  z = pts[p * 3 + 2];
  return true;
}

// A block walks frames blockIdx.x, + gridDim.x, ... (a grid of
// BLOCKS_PER_SM blocks per SM); the active frames, which the sampler packs
// first, each get a block of their own while they are no more than the
// blocks (132 on the H100; the detector's frame has about 100).
template <bool SCAN_Y>
__global__ void __launch_bounds__(NT, BLOCKS_PER_SM)
gpg_counts_kernel(const float* __restrict__ pts, int P,
                  const float* __restrict__ tile_box, int T,
                  const float* __restrict__ seeds, const float* __restrict__ rot,
                  const float* __restrict__ fixed, const float* __restrict__ scan,
                  int scan_stride, int F, int ns,
                  const uint8_t* __restrict__ active, Boxes bx,
                  int* __restrict__ out) {
  constexpr int OA = SCAN_Y ? 0 : 1;  // the fixed in-plane axis
  constexpr int SA = SCAN_Y ? 1 : 0;  // the scanned axis
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  __shared__ float s_sorted[NS_MAX];
  __shared__ int s_index[NS_MAX];
  __shared__ int diff[4][NS_MAX + 1];
  __shared__ int list[LIST_MAX];
  __shared__ int n_list;

  // union of the 4 boxes on the two fixed axes
  float ulo2 = lo_(bx, 0, 2), uhi2 = hi_(bx, 0, 2);
  float uloo = lo_(bx, 0, OA), uhio = hi_(bx, 0, OA);
#pragma unroll
  for (int k = 1; k < 4; ++k) {
    ulo2 = fminf(ulo2, lo_(bx, k, 2));
    uhi2 = fmaxf(uhi2, hi_(bx, k, 2));
    uloo = fminf(uloo, lo_(bx, k, OA));
    uhio = fmaxf(uhio, hi_(bx, k, OA));
  }

  for (int f = blockIdx.x; f < F; f += gridDim.x) {
    int* out_f = out + (size_t)f * ns * 4;
    if (!active[f]) {  // uniform across the block; no shared memory used
      for (int i = tid; i < ns * 4; i += NT) out_f[i] = 0;
      continue;
    }

    // the frame: rotation rows and offsets, as the plain version rounds them
    float r[9];
#pragma unroll
    for (int i = 0; i < 9; ++i) r[i] = rot[f * 9 + i];
    const float s0 = seeds[f * 3 + 0], s1 = seeds[f * 3 + 1], s2 = seeds[f * 3 + 2];
    float off[3];
#pragma unroll
    for (int a = 0; a < 3; ++a)  // dot3: fma(r2, s2, fma(r1, s1, r0 * s0))
      off[a] = __fmaf_rn(r[a * 3 + 2], s2,
                         __fmaf_rn(r[a * 3 + 1], s1, __fmul_rn(r[a * 3 + 0], s0)));
    off[OA] = __fadd_rn(off[OA], fixed[f]);

    // sort the frame's shifts: stable rank by value, ties in index order
    if (warp == 0) {
      const float s = lane < ns ? scan[(size_t)f * scan_stride + lane] : 0.f;
      int rank = 0;
      for (int m = 0; m < ns; ++m) {
        const float sm = __shfl_sync(0xffffffffu, s, m);
        rank += (sm < s) || (sm == s && m < lane);
      }
      if (lane < ns) {
        s_sorted[rank] = s;
        s_index[rank] = lane;
      }
    }
    for (int i = tid; i < 4 * (NS_MAX + 1); i += NT) (&diff[0][0])[i] = 0;

    for (int t0 = 0; t0 < T; t0 += LIST_MAX) {
      if (tid == 0) n_list = 0;
      __syncthreads();
      const int t1 = min(T, t0 + LIST_MAX);
      for (int t = t0 + tid; t < t1; t += NT) {
        const float* tb = tile_box + (size_t)t * 6;
        if (tb[0] <= tb[3] &&  // not a tile of padding only
            axis_reaches(tb, r[6], r[7], r[8], off[2], ulo2, uhi2) &&
            axis_reaches(tb, r[3 * OA], r[3 * OA + 1], r[3 * OA + 2], off[OA],
                         uloo, uhio))
          list[atomicAdd(&n_list, 1)] = t;
      }
      __syncthreads();
      const int total = n_list * TILE;
      // the next item's point is loaded before this one is counted
      float x = 0.f, y = 0.f, z = 0.f;
      bool live = load_point(pts, P, list, warp * 32 + lane, total, x, y, z);
      for (int base = warp * 32; base < total; base += NT) {
        const bool here = live;
        float c[3];
#pragma unroll
        for (int a = 0; a < 3; ++a)  // lin3: fma(r2, z, fma(r0, x, r1 * y)) - off
          c[a] = __fsub_rn(__fmaf_rn(r[a * 3 + 2], z,
                                     __fmaf_rn(r[a * 3 + 0], x, __fmul_rn(r[a * 3 + 1], y))),
                           off[a]);
        live = load_point(pts, P, list, base + NT + lane, total, x, y, z);
        const float scanned = c[SA], other = c[OA];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const bool in = here && c[2] > lo_(bx, k, 2) && c[2] < hi_(bx, k, 2) &&
                          other > lo_(bx, k, OA) && other < hi_(bx, k, OA);
          if (in) {
            const float lo_s = lo_(bx, k, SA), hi_s = hi_(bx, k, SA);
            // first sorted shift with d < hi (d falls as the shift grows)
            int a = 0, b = ns;
            while (a < b) {
              const int m = (a + b) >> 1;
              if (__fsub_rn(scanned, s_sorted[m]) < hi_s) b = m; else a = m + 1;
            }
            const int first = a;
            // first sorted shift with !(d > lo)
            b = ns;
            while (a < b) {
              const int m = (a + b) >> 1;
              if (!(__fsub_rn(scanned, s_sorted[m]) > lo_s)) b = m; else a = m + 1;
            }
            const int last = a;
            if (first < last) {
              atomicAdd(&diff[k][first], 1);
              atomicAdd(&diff[k][last], -1);
            }
          }
        }
      }
      __syncthreads();
    }
    __syncthreads();  // the sort and the zeroed diff, also when T == 0

    // prefix sums in sorted order, scattered back to the shift order
    for (int i = tid; i < 4 * ns; i += NT) {
      const int k = i / ns, j = i % ns;
      int acc = 0;
      for (int m = 0; m <= j; ++m) acc += diff[k][m];
      out_f[s_index[j] * 4 + k] = acc;
    }
    __syncthreads();  // before the next frame reuses shared memory
  }
}

__global__ void empty_kernel() {}

extern "C" int gpg_counts_launch(const float* pts, int P, const float* tile_box,
                                 int T, const float* seeds, const float* rot,
                                 const float* fixed, const float* scan,
                                 int scan_stride, int F, int ns,
                                 const uint8_t* active, const float* boxes_host,
                                 int scan_is_y, int* out, void* stream) {
  if (ns < 1 || ns > NS_MAX || F < 1 || T < 0) return (int)cudaErrorInvalidValue;
  static int n_sm = 0;
  if (n_sm == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  Boxes bx;
  for (int i = 0; i < 24; ++i) bx.v[i] = boxes_host[i];
  const int grid = F < BLOCKS_PER_SM * n_sm ? F : BLOCKS_PER_SM * n_sm;
  if (scan_is_y)
    gpg_counts_kernel<true><<<grid, NT, 0, (cudaStream_t)stream>>>(
        pts, P, tile_box, T, seeds, rot, fixed, scan, scan_stride, F, ns,
        active, bx, out);
  else
    gpg_counts_kernel<false><<<grid, NT, 0, (cudaStream_t)stream>>>(
        pts, P, tile_box, T, seeds, rot, fixed, scan, scan_stride, F, ns,
        active, bx, out);
  return (int)cudaGetLastError();
}

// An empty kernel on the same stream: the launch-latency floor that K1's
// times are read against (chip_smoke.py).
extern "C" int empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
