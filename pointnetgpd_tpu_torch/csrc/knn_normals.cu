// Exact k-nearest-neighbour plane normals (kernel K5) for Hopper, sm_90a.
//
// Replaces no Pallas kernel: the JAX package computes these normals with
// XLA ops (pointnetgpd_tpu/ops/cloud.py estimate_normals_knn: pairwise_d2,
// min_k, _plane_normals, _orient). The port's plain version
// (pointnetgpd_tpu_torch/ops/cloud.py _normals_plain) builds (B, chunk, P)
// distance blocks in the float64 form of ops/fp.py (about 1 GB a pass at
// 128 crops of 1,000 points), stable-sorts whole rows to keep k of them and
// runs a batched eigensolver of dozens of launches. K5 is one launch.
//
// B clouds of P points (B = 1 for a (P, 3) cloud); one thread per query
// point, NQ queries a block on a grid of ceil(P / NQ) x B blocks:
// 1. Distances. Candidates stream through shared memory in tiles of TILE
//    points, with their sums of squares. The squared distance of query q to
//    candidate p is formed as ops/cloud.py pairwise_d2 and ops/fp.py round
//    it: (sumsq3(q) - 2 * dot3(q, p)) + sumsq3(p), where dot3 is
//    fma(qz, pz, fma(qy, py, qx * px)), each fma a float64 product and a
//    float64 add of float32 operands rounded once to float32 (as K4 does).
//    The file is built with -fmad=false and every operation is spelled as
//    an intrinsic, so the distances equal the plain version's bit for bit.
// 2. Selection. Each thread keeps its k smallest (distance, index) pairs
//    sorted in shared memory (a column of s_key / s_idx) and the k-th key
//    in a register. Candidates come in index order and enter only when
//    strictly below the k-th, so a tie keeps the lower index, as min_k's
//    stable sort does; most candidates are rejected by that one compare.
//    Distances are compared through an order-preserving integer key that
//    puts NaN after +inf, as torch.sort does. The neighbour sets therefore
//    equal the plain version's, exactly.
// 3. Plane and orientation, in float64 registers: the neighbours' mean and
//    centred 3x3 covariance, the closed-form least eigenvector of
//    ops/cloud.py smallest_eigvec_sym3x3 / _eigvec_for (Eberly, with its
//    [0, 0, 1] fallback), flipped toward the camera and normalised as
//    _orient does, rounded once to float32. The plain version does this in
//    float32, so the two agree within float32 rounding where the least
//    eigenvalue is well separated, and K5 is the closer to float64 normals.
// The camera comes by value (cam == nullptr) or as three float32 values in
// device memory, so a host camera costs no copy and no wait.
//
// What bounds it on the H100 (132 SMs at 1.98 GHz): per (query, candidate)
// pair two float64 products, two float64 adds (17e12 a second at 64 a clock
// per SM) and four conversions between float32 and float64 (4.2e12 a second
// at 16 a clock per SM). The conversions bound it: at 128 crops of 1,000
// points (1.28e8 pairs) 0.12 ms. Each accepted candidate costs an insertion
// into its thread's column; in a random order about k (1 + ln(P / k)) of P
// candidates enter, and a warp runs an insertion whenever one of its lanes
// does. A float32 pre-filter with a proven slack, and per-thread queues
// drained by the warp, halve the kernel's time but move no end-to-end
// number of the GPD train step, which is host-bound (PERF.md, K5's row):
// they are left out.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#define NQ 128     // queries per block, one a thread
#define KMAX 32    // the largest k (ops/knn_normals.py KMAX)
#define TILE 512   // candidates per shared-memory tile
#define GROUP 4    // candidates whose distances are formed before they are selected
#define TWO_PI_3 2.0943951023931953   // 2 pi / 3 in float64, as ops/cloud.py's 2.0 * torch.pi / 3.0

// float32 fma(a, b, c) as ops/fp.py computes it: float64 product and add of
// the float32 operands, one rounding to float32
__device__ __forceinline__ float fma64(float a, float b, float c) {
  return __double2float_rn(__dadd_rn(__dmul_rn((double)a, (double)b), (double)c));
}

// ops/fp.py sumsq3: fma(z, z, fma(y, y, x * x))
__device__ __forceinline__ float sumsq3(float x, float y, float z) {
  return fma64(z, z, fma64(y, y, __fmul_rn(x, x)));
}

// a < b as torch.sort orders float32 (NaN after +inf, all NaN equal) iff
// order_key(a) < order_key(b)
__device__ __forceinline__ uint32_t order_key(float d) {
  const uint32_t u = __float_as_uint(d);
  const uint32_t key = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return d != d ? 0xffffffffu : key;
}

// unit eigenvector of the least eigenvalue of the symmetric matrix
// [[a00, a01, a02], [a01, a11, a12], [a02, a12, a22]]: ops/cloud.py
// _eberly_shifted and _eigvec_for, in float64
__device__ void least_eigvec(double a00, double a01, double a02, double a11, double a12,
                             double a22, double v[3]) {
  const double tiny = 1e-30;
  const double q = __ddiv_rn(__dadd_rn(__dadd_rn(a00, a11), a22), 3.0);
  double b00 = __dsub_rn(a00, q), b11 = __dsub_rn(a11, q), b22 = __dsub_rn(a22, q);
  double b01 = a01, b02 = a02, b12 = a12;
  const double scale = fmax(fmax(fmax(fabs(b00), fabs(b11)), fmax(fabs(b22), fabs(b01))),
                            fmax(fabs(b02), fabs(b12)));
  const double s = fmax(scale, tiny);
  b00 = __ddiv_rn(b00, s);
  b11 = __ddiv_rn(b11, s);
  b22 = __ddiv_rn(b22, s);
  b01 = __ddiv_rn(b01, s);
  b02 = __ddiv_rn(b02, s);
  b12 = __ddiv_rn(b12, s);
  const double diag = __dadd_rn(__dadd_rn(__dmul_rn(b00, b00), __dmul_rn(b11, b11)),
                                __dmul_rn(b22, b22));
  const double off = __dadd_rn(__dadd_rn(__dmul_rn(b01, b01), __dmul_rn(b02, b02)),
                               __dmul_rn(b12, b12));
  const double p = __dsqrt_rn(__ddiv_rn(__dadd_rn(diag, __dmul_rn(2.0, off)), 6.0));
  const double pt = fmax(p, tiny);
  const double c00 = __ddiv_rn(b00, pt), c11 = __ddiv_rn(b11, pt), c22 = __ddiv_rn(b22, pt);
  const double c01 = __ddiv_rn(b01, pt), c02 = __ddiv_rn(b02, pt), c12 = __ddiv_rn(b12, pt);
  const double det = __dadd_rn(
      __dsub_rn(__dmul_rn(c00, __dsub_rn(__dmul_rn(c11, c22), __dmul_rn(c12, c12))),
                __dmul_rn(c01, __dsub_rn(__dmul_rn(c01, c22), __dmul_rn(c12, c02)))),
      __dmul_rn(c02, __dsub_rn(__dmul_rn(c01, c12), __dmul_rn(c11, c02))));
  const double r = fmin(fmax(__ddiv_rn(det, 2.0), -1.0), 1.0);
  const double phi = __ddiv_rn(acos(r), 3.0);
  const double lam = __dmul_rn(__dmul_rn(2.0, p), cos(__dadd_rn(phi, TWO_PI_3)));
  const double m00 = __dsub_rn(b00, lam), m11 = __dsub_rn(b11, lam), m22 = __dsub_rn(b22, lam);
  // rows r0 = (m00, b01, b02), r1 = (b01, m11, b12), r2 = (b02, b12, m22);
  // the largest of cross(r0, r1), cross(r0, r2), cross(r1, r2), the first
  // on a tie (torch.argmax)
  double cr[3][3];
  cr[0][0] = __dsub_rn(__dmul_rn(b01, b12), __dmul_rn(b02, m11));
  cr[0][1] = __dsub_rn(__dmul_rn(b02, b01), __dmul_rn(m00, b12));
  cr[0][2] = __dsub_rn(__dmul_rn(m00, m11), __dmul_rn(b01, b01));
  cr[1][0] = __dsub_rn(__dmul_rn(b01, m22), __dmul_rn(b02, b12));
  cr[1][1] = __dsub_rn(__dmul_rn(b02, b02), __dmul_rn(m00, m22));
  cr[1][2] = __dsub_rn(__dmul_rn(m00, b12), __dmul_rn(b01, b02));
  cr[2][0] = __dsub_rn(__dmul_rn(m11, m22), __dmul_rn(b12, b12));
  cr[2][1] = __dsub_rn(__dmul_rn(b12, b02), __dmul_rn(b01, m22));
  cr[2][2] = __dsub_rn(__dmul_rn(b01, b12), __dmul_rn(m11, b02));
  int best = 0;
  double bn = -1.0;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const double n = __dsqrt_rn(__dadd_rn(
        __dadd_rn(__dmul_rn(cr[i][0], cr[i][0]), __dmul_rn(cr[i][1], cr[i][1])),
        __dmul_rn(cr[i][2], cr[i][2])));
    if (n > bn) {
      bn = n;
      best = i;
    }
  }
  if (bn < 1e-12 || scale < tiny) {
    v[0] = 0.0;
    v[1] = 0.0;
    v[2] = 1.0;
  } else {
    const double d = fmax(bn, tiny);
#pragma unroll
    for (int i = 0; i < 3; ++i)
      v[i] = __ddiv_rn(best == 0 ? cr[0][i] : best == 1 ? cr[1][i] : cr[2][i], d);
  }
}

__global__ void __launch_bounds__(NQ) knn_normals_kernel(
    const float* __restrict__ pts, int P, int k, int n_qblocks, const float* __restrict__ cam,
    float cam_x, float cam_y, float cam_z, float* __restrict__ out,
    long long* __restrict__ idx_out) {
  __shared__ float s_x[TILE];
  __shared__ double s_y[TILE], s_z[TILE];
  __shared__ float s_sq[TILE];
  __shared__ uint32_t s_key[KMAX * NQ];   // slot s of thread t at s * NQ + t
  __shared__ int s_idx[KMAX * NQ];

  const int t = threadIdx.x;
  const int b = blockIdx.x / n_qblocks;
  const int q = (blockIdx.x % n_qblocks) * NQ + t;
  const bool active = q < P;
  const float* cloud = pts + (size_t)b * P * 3;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (active) {
    qx = cloud[3 * (size_t)q];
    qy = cloud[3 * (size_t)q + 1];
    qz = cloud[3 * (size_t)q + 2];
  }
  const double qyd = qy, qzd = qz;
  const float q_sq = sumsq3(qx, qy, qz);
  int n_in = 0;            // keys held, up to k
  uint32_t thr = 0u;       // the k-th key once k are held

  for (int base = 0; base < P; base += TILE) {
    const int n = min(TILE, P - base);
    __syncthreads();       // the previous tile is no longer read
    for (int i = t; i < n; i += NQ) {
      const float* p = cloud + 3 * (size_t)(base + i);
      const float x = p[0], y = p[1], z = p[2];
      s_x[i] = x;
      s_y[i] = y;
      s_z[i] = z;
      s_sq[i] = sumsq3(x, y, z);
    }
    __syncthreads();
    if (!active) continue;
    for (int i0 = 0; i0 < n; i0 += GROUP) {
      uint32_t key[GROUP];
#pragma unroll
      for (int u = 0; u < GROUP; ++u) {
        const int i = min(i0 + u, n - 1);
        const float xx = __fmul_rn(qx, s_x[i]);
        const float inner = __double2float_rn(__dadd_rn(__dmul_rn(qyd, s_y[i]), (double)xx));
        const float cross = __double2float_rn(__dadd_rn(__dmul_rn(qzd, s_z[i]), (double)inner));
        key[u] = order_key(__fadd_rn(__fsub_rn(q_sq, __fmul_rn(2.0f, cross)), s_sq[i]));
      }
#pragma unroll
      for (int u = 0; u < GROUP; ++u) {
        if (i0 + u < n && (n_in < k || key[u] < thr)) {
          // shift the larger keys up one slot (the k-th falls out when k are
          // held); an equal key stays in front: its index is lower
          int s = n_in < k ? n_in : k - 1;
          while (s > 0) {
            const uint32_t prev = s_key[(s - 1) * NQ + t];
            if (prev <= key[u]) break;
            s_key[s * NQ + t] = prev;
            s_idx[s * NQ + t] = s_idx[(s - 1) * NQ + t];
            --s;
          }
          s_key[s * NQ + t] = key[u];
          s_idx[s * NQ + t] = base + i0 + u;
          if (n_in < k) ++n_in;
          if (n_in == k) thr = s_key[(k - 1) * NQ + t];
        }
      }
    }
  }
  if (!active) return;

  // the neighbours' mean and centred covariance, in float64, in the order
  // of the selection (nearest first)
  double mx = 0.0, my = 0.0, mz = 0.0;
  for (int s = 0; s < k; ++s) {
    const float* p = cloud + 3 * (size_t)s_idx[s * NQ + t];
    mx = __dadd_rn(mx, (double)p[0]);
    my = __dadd_rn(my, (double)p[1]);
    mz = __dadd_rn(mz, (double)p[2]);
  }
  mx = __ddiv_rn(mx, (double)k);
  my = __ddiv_rn(my, (double)k);
  mz = __ddiv_rn(mz, (double)k);
  double a00 = 0.0, a01 = 0.0, a02 = 0.0, a11 = 0.0, a12 = 0.0, a22 = 0.0;
  for (int s = 0; s < k; ++s) {
    const int j = s_idx[s * NQ + t];
    const float* p = cloud + 3 * (size_t)j;
    const double dx = __dsub_rn((double)p[0], mx);
    const double dy = __dsub_rn((double)p[1], my);
    const double dz = __dsub_rn((double)p[2], mz);
    a00 = __dadd_rn(a00, __dmul_rn(dx, dx));
    a01 = __dadd_rn(a01, __dmul_rn(dx, dy));
    a02 = __dadd_rn(a02, __dmul_rn(dx, dz));
    a11 = __dadd_rn(a11, __dmul_rn(dy, dy));
    a12 = __dadd_rn(a12, __dmul_rn(dy, dz));
    a22 = __dadd_rn(a22, __dmul_rn(dz, dz));
    if (idx_out) idx_out[((size_t)b * P + q) * k + s] = j;
  }
  double v[3];
  least_eigvec(a00, a01, a02, a11, a12, a22, v);

  // turned toward the camera and normalised (ops/cloud.py _orient)
  const double cx = cam ? cam[0] : cam_x, cy = cam ? cam[1] : cam_y, cz = cam ? cam[2] : cam_z;
  const double facing = __dadd_rn(
      __dadd_rn(__dmul_rn(__dsub_rn(cx, (double)qx), v[0]),
                __dmul_rn(__dsub_rn(cy, (double)qy), v[1])),
      __dmul_rn(__dsub_rn(cz, (double)qz), v[2]));
  const double sign = facing < 0.0 ? -1.0 : 1.0;
  const double norm = fmax(__dsqrt_rn(__dadd_rn(
                               __dadd_rn(__dmul_rn(v[0], v[0]), __dmul_rn(v[1], v[1])),
                               __dmul_rn(v[2], v[2]))),
                           1e-12);
  float* o = out + ((size_t)b * P + q) * 3;
#pragma unroll
  for (int i = 0; i < 3; ++i) o[i] = __double2float_rn(__ddiv_rn(__dmul_rn(sign, v[i]), norm));
}

// pts (B, P, 3) float32; the camera as three float32 values at cam in device
// memory, or by value (cam_x, cam_y, cam_z) where cam is null; out (B, P, 3)
// float32 and, where idx_out is not null, the neighbours (B, P, k) int64,
// nearest first, are written. 1 <= k <= min(P, KMAX).
extern "C" int knn_normals_launch(const float* pts, int B, int P, int k, const float* cam,
                                  float cam_x, float cam_y, float cam_z, float* out,
                                  long long* idx_out, void* stream) {
  if (B < 1 || P < 1 || k < 1 || k > KMAX || k > P) return (int)cudaErrorInvalidValue;
  const int n_qblocks = (P + NQ - 1) / NQ;
  const long long blocks = (long long)n_qblocks * B;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  knn_normals_kernel<<<(unsigned)blocks, NQ, 0, (cudaStream_t)stream>>>(
      pts, P, k, n_qblocks, cam, cam_x, cam_y, cam_z, out, idx_out);
  return (int)cudaGetLastError();
}
