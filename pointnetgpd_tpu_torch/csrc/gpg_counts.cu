// GPG shifted-box panel counts (kernel K1) for Hopper, sm_90a.
//
// Replaces the TPU kernel pointnetgpd_tpu/ops/gpg_counts_pallas.py
// (_kernel via _counts_pallas, called from GpgScanContext.counts). For every
// (frame, shift) pair it counts the cloud points strictly inside each of the
// 4 gripper panel boxes [open, bottom, left, right]; a scan shifts one
// in-frame axis (y for the dy scan, x for the approach and final scans).
//
// What bounds it on the H100: arithmetic on the CUDA cores. Each (active
// frame, point) pair costs three 3-term coordinate chains and up to eight
// compares, and the data is small (a 20k-point cloud is 240 KB, the frames
// a few hundred KB), so the inputs stay in L2 and shared memory and the
// bytes moved are far below the bound set by the operations.
//
// Design, and how it differs from the TPU layout (frames on the 128-lane
// axis, one MXU matmul per point tile, counts summed across tiles in a
// revisited output block that relies on the grid running in order):
// - grid = (frame blocks of FB frames) x (point tiles of TILE points). Each
//   block stages its tile in shared memory and skips it when the tile's
//   bounding box misses the frame block's reach sphere (seed sphere + the
//   scan's reach, radius -1 for a block with no active frame);
// - thread t owns frame t % FB and walks points t / FB, + NT / FB, ... of
//   the tile. A point is tested against a box's two fixed axes first; only
//   points inside that slab walk the shifts, so the shift loop is rare;
// - counts are integers: each block sums into shared memory, then adds its
//   nonzero counts to the zeroed int32 (F, Ns, 4) output with atomicAdd,
//   exact and independent of block order;
// - numerics: frame coordinates are r_a0*x + r_a1*y + r_a2*z - off_a with the
//   fused multiply-adds spelled out as the plain version rounds them
//   (ops/fp.py lin3 and dot3), and this file is built with -fmad=false so
//   the compiler adds no others. Counts equal the plain version's exactly.
//   No tensor cores, so no TF32.

#include <cuda_runtime.h>
#include <stdint.h>

#define FB 16
#define TILE 1024
#define NT 256
#define NS_MAX 32

struct Boxes {
  float v[24];  // (4, 2, 3): box k, lo/hi, axis
};

__device__ __forceinline__ float lo_(const Boxes& b, int k, int a) { return b.v[k * 6 + a]; }
__device__ __forceinline__ float hi_(const Boxes& b, int k, int a) { return b.v[k * 6 + 3 + a]; }

__global__ void __launch_bounds__(NT)
gpg_counts_kernel(const float* __restrict__ pts, int P,
                  const float* __restrict__ seeds, const float* __restrict__ rot,
                  const float* __restrict__ fixed, const float* __restrict__ scan,
                  int F, int ns, const uint8_t* __restrict__ active,
                  const float* __restrict__ spheres,
                  const float* __restrict__ tile_box, Boxes bx, int scan_is_y,
                  int* __restrict__ out) {
  const int fb = blockIdx.x;
  const int tile = blockIdx.y;

  // block-level pruning: uniform across the block, before any barrier
  const float cx = spheres[fb * 4 + 0], cy = spheres[fb * 4 + 1];
  const float cz = spheres[fb * 4 + 2], rad = spheres[fb * 4 + 3];
  if (rad < 0.f) return;
  const float* tb = tile_box + tile * 6;
  if (tb[0] > tb[3]) return;  // tile holds only padding
  const float dx = fmaxf(fmaxf(tb[0] - cx, cx - tb[3]), 0.f);
  const float dy = fmaxf(fmaxf(tb[1] - cy, cy - tb[4]), 0.f);
  const float dz = fmaxf(fmaxf(tb[2] - cz, cz - tb[5]), 0.f);
  if (dx * dx + dy * dy + dz * dz > rad * rad) return;

  __shared__ float sx[TILE], sy[TILE], sz[TILE];
  __shared__ float ssc[FB][NS_MAX];
  __shared__ int cnt[FB][NS_MAX][4];

  const int p0 = tile * TILE;
  const int n_tile = min(TILE, P - p0);
  for (int i = threadIdx.x; i < n_tile; i += NT) {
    sx[i] = pts[(p0 + i) * 3 + 0];
    sy[i] = pts[(p0 + i) * 3 + 1];
    sz[i] = pts[(p0 + i) * 3 + 2];
  }
  for (int i = threadIdx.x; i < FB * NS_MAX * 4; i += NT) (&cnt[0][0][0])[i] = 0;
  for (int i = threadIdx.x; i < FB * NS_MAX; i += NT) {
    const int fl = i / NS_MAX, n = i % NS_MAX;
    const int f = fb * FB + fl;
    ssc[fl][n] = (f < F && n < ns) ? scan[f * ns + n] : 0.f;
  }
  __syncthreads();

  const int fl = threadIdx.x % FB;
  const int lane = threadIdx.x / FB;
  const int f = fb * FB + fl;
  if (f < F && active[f]) {
    float r[9];
#pragma unroll
    for (int i = 0; i < 9; ++i) r[i] = rot[f * 9 + i];
    const float s0 = seeds[f * 3 + 0], s1 = seeds[f * 3 + 1], s2 = seeds[f * 3 + 2];
    float off[3];
#pragma unroll
    for (int a = 0; a < 3; ++a)  // dot3: fma(r2, s2, fma(r1, s1, r0 * s0))
      off[a] = __fmaf_rn(r[a * 3 + 2], s2,
                         __fmaf_rn(r[a * 3 + 1], s1, __fmul_rn(r[a * 3 + 0], s0)));
    const int fixed_axis = scan_is_y ? 0 : 1;
    off[fixed_axis] = __fadd_rn(off[fixed_axis], fixed[f]);

    for (int p = lane; p < n_tile; p += NT / FB) {
      const float x = sx[p], y = sy[p], z = sz[p];
      float c[3];
#pragma unroll
      for (int a = 0; a < 3; ++a)  // lin3: fma(r2, z, fma(r0, x, r1 * y)) - off
        c[a] = __fsub_rn(__fmaf_rn(r[a * 3 + 2], z,
                                   __fmaf_rn(r[a * 3 + 0], x, __fmul_rn(r[a * 3 + 1], y))),
                         off[a]);
      const float scanned = scan_is_y ? c[1] : c[0];
      const float other = scan_is_y ? c[0] : c[1];
      const int oa = scan_is_y ? 0 : 1, sa = scan_is_y ? 1 : 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (c[2] > lo_(bx, k, 2) && c[2] < hi_(bx, k, 2) &&
            other > lo_(bx, k, oa) && other < hi_(bx, k, oa)) {
          const float lo_s = lo_(bx, k, sa), hi_s = hi_(bx, k, sa);
          for (int n = 0; n < ns; ++n) {
            const float d = __fsub_rn(scanned, ssc[fl][n]);
            if (d > lo_s && d < hi_s) atomicAdd(&cnt[fl][n][k], 1);
          }
        }
      }
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < FB * ns * 4; i += NT) {
    const int fli = i / (ns * 4), rem = i % (ns * 4);
    const int n = rem / 4, k = rem % 4;
    const int fi = fb * FB + fli;
    const int v = cnt[fli][n][k];
    if (v != 0 && fi < F) atomicAdd(&out[(fi * ns + n) * 4 + k], v);
  }
}

extern "C" int gpg_counts_launch(const float* pts, int P, const float* seeds,
                                 const float* rot, const float* fixed,
                                 const float* scan, int F, int ns,
                                 const uint8_t* active, const float* spheres,
                                 const float* tile_box, const float* boxes_host,
                                 int scan_is_y, int* out, void* stream) {
  if (ns < 1 || ns > NS_MAX) return (int)cudaErrorInvalidValue;
  Boxes bx;
  for (int i = 0; i < 24; ++i) bx.v[i] = boxes_host[i];
  dim3 grid((F + FB - 1) / FB, (P + TILE - 1) / TILE);
  gpg_counts_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(
      pts, P, seeds, rot, fixed, scan, F, ns, active, spheres, tile_box, bx,
      scan_is_y, out);
  return (int)cudaGetLastError();
}
