// Min point-triangle squared distance (kernel K3) for Hopper, sm_90a.
//
// Replaces the TPU kernel pointnetgpd_tpu/ops/point_triangle_pallas.py
// (_ptd_kernel via min_point_triangle_dist2), the distance pass of the
// mesh -> SDF voxelizer (ops/mesh_to_sdf.py). For every grid point it
// returns the minimum squared distance to a triangle set.
//
// What bounds it on the H100: fp32 arithmetic on the CUDA cores. Each
// (point, triangle) pair costs a branchless closest-point evaluation of
// about 140 operations (Ericson, Real-Time Collision Detection §5.1.5), and
// the inputs are small (60k triangles are 3.84 MB, the 1M grid points 12 MB)
// next to the 1e10 pairs that a 100^3 grid needs even after pruning. So the
// design spends its effort on doing fewer pairs and on keeping each pair's
// operands in registers and in broadcast shared-memory reads.
//
// Design, and how it differs from the TPU layout (all triangles resident in
// VMEM, (1, 128) lane vectors of points, (8, 16) group loads):
// - one block of 128 threads per spatially compact block of 128 grid points
//   (4x4x8 cells), one point per thread; the running min d^2 stays in a
//   register;
// - the triangles stay in global memory (L2-resident, 50 MB); a block
//   stages one supertile of 128 triangles at a time into shared memory (the
//   16-float rows read as float4, the edge vectors computed once per
//   triangle), and every thread then reads the same triangle at once, a
//   broadcast without bank conflicts;
// - pruning as on the TPU: the block's bounding box gives a centre and a
//   half-diagonal; each supertile's lower bound dist(centre, sphere) - r -
//   half-diagonal goes to shared memory; the nearest supertile (first
//   minimum in index order) goes first, then every supertile whose bound is
//   below cur = sqrt(max over the block of the current min d^2), tightened by
//   a block-wide max after each processed supertile. The skip test is
//   uniform across the block, so it costs no divergence; skipping is
//   conservative, so the result is the exact minimum whatever is skipped;
// - padding: padded triangles sit at 1e8 (d^2 ~ 3e16, finite), padded
//   supertiles have their sphere there and are never taken;
// - numerics: the Pallas body's Ericson variant (edge priority bc < ac < ab,
//   then c < b < a; denominators max(den, 1e-30), no clip), IEEE division
//   and sqrt (never built with fast math: the 1e-30 guards rely on it); the
//   compiler may contract a*b + c into FMAs, which moves results by an ulp.

#include <cuda_runtime.h>
#include <math.h>

#define BP 128          // points per block = threads per block
#define SUPER 128       // triangles per supertile
#define NW (BP / 32)    // warps per block
#define TRI_F4 5        // float4 per staged triangle
#define EPS 1e-30f

// a block-wide min and max of three values each (the block's bounding box);
// every thread gets the result
__device__ __forceinline__ void block_bbox(float v[6], float (*red)[6]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      v[i] = fminf(v[i], __shfl_xor_sync(0xffffffffu, v[i], o));
      v[3 + i] = fmaxf(v[3 + i], __shfl_xor_sync(0xffffffffu, v[3 + i], o));
    }
  }
  if ((threadIdx.x & 31) == 0)
    for (int i = 0; i < 6; ++i) red[threadIdx.x >> 5][i] = v[i];
  __syncthreads();
  for (int i = 0; i < 6; ++i) v[i] = red[0][i];
  for (int w = 1; w < NW; ++w)
    for (int i = 0; i < 3; ++i) {
      v[i] = fminf(v[i], red[w][i]);
      v[3 + i] = fmaxf(v[3 + i], red[w][3 + i]);
    }
}

// block-wide max; the leading barrier keeps an earlier read of red safe
__device__ __forceinline__ float block_max(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float m = red[0];
#pragma unroll
  for (int w = 1; w < NW; ++w) m = fmaxf(m, red[w]);
  return m;
}

// block-wide first minimum in index order: smaller d, ties to smaller s
__device__ __forceinline__ int block_argmin(float d, int s, float* redf, int* redi) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float od = __shfl_xor_sync(0xffffffffu, d, o);
    const int os = __shfl_xor_sync(0xffffffffu, s, o);
    if (od < d || (od == d && os < s)) { d = od; s = os; }
  }
  if ((threadIdx.x & 31) == 0) { redf[threadIdx.x >> 5] = d; redi[threadIdx.x >> 5] = s; }
  __syncthreads();
  d = redf[0];
  s = redi[0];
  for (int w = 1; w < NW; ++w)
    if (redf[w] < d || (redf[w] == d && redi[w] < s)) { d = redf[w]; s = redi[w]; }
  return s;
}

// one coordinate of the closest point: face, then edges bc, ac, ab, then
// vertices c, b, a (later wins), as the Pallas body's where-chain
__device__ __forceinline__ float closest_coord(float a0, float b0, float c0, float ab0,
                                               float ac0, float cb0, float v, float w,
                                               float t_ab, float t_ac, float t_bc,
                                               bool m_a, bool m_b, bool m_c, bool m_ab,
                                               bool m_ac, bool m_bc) {
  float q = a0 + ab0 * v + ac0 * w;
  q = m_bc ? b0 + cb0 * t_bc : q;
  q = m_ac ? a0 + ac0 * t_ac : q;
  q = m_ab ? a0 + ab0 * t_ab : q;
  q = m_c ? c0 : q;
  q = m_b ? b0 : q;
  return m_a ? a0 : q;
}

__global__ void __launch_bounds__(BP)
point_triangle_kernel(const float* __restrict__ pts, const float4* __restrict__ tri,
                      const float* __restrict__ sup, int n_sup, float* __restrict__ out) {
  extern __shared__ float db[];                  // per-supertile lower bounds
  __shared__ float4 tri_s[SUPER * TRI_F4];       // the staged supertile
  __shared__ float red6[NW][6];
  __shared__ float redf[NW];
  __shared__ int redi[NW];

  const int t = threadIdx.x;
  const long long p = (long long)blockIdx.x * BP + t;
  const float px = pts[p * 3 + 0], py = pts[p * 3 + 1], pz = pts[p * 3 + 2];

  // block geometry: centre + half-diagonal of this 128-point block
  float bb[6] = {px, py, pz, px, py, pz};
  block_bbox(bb, red6);
  const float bxc = (bb[0] + bb[3]) * 0.5f, byc = (bb[1] + bb[4]) * 0.5f;
  const float bzc = (bb[2] + bb[5]) * 0.5f;
  const float ex = bb[3] - bb[0], ey = bb[4] - bb[1], ez = bb[5] - bb[2];
  const float bhd = 0.5f * sqrtf(ex * ex + ey * ey + ez * ez);

  // supertile lower bounds, and the nearest supertile
  float best_d = INFINITY;
  int best_s = 0;
  for (int s = t; s < n_sup; s += BP) {
    const float4 sp = *reinterpret_cast<const float4*>(sup + (long long)s * 8);
    const float dx = sp.x - bxc, dy = sp.y - byc, dz = sp.z - bzc;
    const float d = sqrtf(dx * dx + dy * dy + dz * dz) - sp.w - bhd;
    db[s] = d;
    if (d < best_d) { best_d = d; best_s = s; }
  }
  best_s = block_argmin(best_d, best_s, redf, redi);   // its barrier publishes db

  float m = INFINITY;
  int s = best_s;
  float cur = 0.f;
  for (int next = -1;;) {
    // stage supertile s: thread t loads triangle row t (floats 0..8 used)
    __syncthreads();                                   // earlier readers done
    {
      const float4* row = tri + ((long long)s * SUPER + t) * 4;
      const float4 r0 = row[0], r1 = row[1], r2 = row[2];
      const float ax = r0.x, ay = r0.y, az = r0.z, bx = r0.w, by = r1.x, bz = r1.y;
      const float cx = r1.z, cy = r1.w, cz = r2.x;
      float4* dst = tri_s + t * TRI_F4;
      dst[0] = make_float4(ax, ay, az, bx);
      dst[1] = make_float4(by, bz, cx, cy);
      dst[2] = make_float4(cz, bx - ax, by - ay, bz - az);
      dst[3] = make_float4(cx - ax, cy - ay, cz - az, cx - bx);
      dst[4] = make_float4(cy - by, cz - bz, 0.f, 0.f);
    }
    __syncthreads();
#pragma unroll 2
    for (int j = 0; j < SUPER; ++j) {
      const float4 q0 = tri_s[j * TRI_F4 + 0], q1 = tri_s[j * TRI_F4 + 1];
      const float4 q2 = tri_s[j * TRI_F4 + 2], q3 = tri_s[j * TRI_F4 + 3];
      const float4 q4 = tri_s[j * TRI_F4 + 4];
      const float ax = q0.x, ay = q0.y, az = q0.z, bx = q0.w, by = q1.x, bz = q1.y;
      const float cx = q1.z, cy = q1.w, cz = q2.x;
      const float abx = q2.y, aby = q2.z, abz = q2.w;
      const float acx = q3.x, acy = q3.y, acz = q3.z;
      const float cbx = q3.w, cby = q4.x, cbz = q4.y;

      const float apx = px - ax, apy = py - ay, apz = pz - az;
      const float d1 = abx * apx + aby * apy + abz * apz;
      const float d2 = acx * apx + acy * apy + acz * apz;
      const float bpx = px - bx, bpy = py - by, bpz = pz - bz;
      const float d3 = abx * bpx + aby * bpy + abz * bpz;
      const float d4 = acx * bpx + acy * bpy + acz * bpz;
      const float cpx = px - cx, cpy = py - cy, cpz = pz - cz;
      const float d5 = abx * cpx + aby * cpy + abz * cpz;
      const float d6 = acx * cpx + acy * cpy + acz * cpz;
      const float va = d3 * d6 - d5 * d4;
      const float vb = d5 * d2 - d1 * d6;
      const float vc = d1 * d4 - d3 * d2;

      const bool m_a = (d1 <= 0.f) & (d2 <= 0.f);
      const bool m_b = (d3 >= 0.f) & (d4 <= d3);
      const bool m_c = (d6 >= 0.f) & (d5 <= d6);
      const bool m_ab = (vc <= 0.f) & (d1 >= 0.f) & (d3 <= 0.f);
      const bool m_ac = (vb <= 0.f) & (d2 >= 0.f) & (d6 <= 0.f);
      const float e43 = d4 - d3, e56 = d5 - d6;
      const bool m_bc = (va <= 0.f) & (e43 >= 0.f) & (e56 >= 0.f);

      const float t_ab = d1 / fmaxf(d1 - d3, EPS);
      const float t_ac = d2 / fmaxf(d2 - d6, EPS);
      const float t_bc = e43 / fmaxf(e43 + e56, EPS);
      const float den = fmaxf(va + vb + vc, EPS);
      const float v = vb / den, w = vc / den;

      const float qx = closest_coord(ax, bx, cx, abx, acx, cbx, v, w, t_ab, t_ac, t_bc,
                                     m_a, m_b, m_c, m_ab, m_ac, m_bc);
      const float qy = closest_coord(ay, by, cy, aby, acy, cby, v, w, t_ab, t_ac, t_bc,
                                     m_a, m_b, m_c, m_ab, m_ac, m_bc);
      const float qz = closest_coord(az, bz, cz, abz, acz, cbz, v, w, t_ab, t_ac, t_bc,
                                     m_a, m_b, m_c, m_ab, m_ac, m_bc);
      const float rx = px - qx, ry = py - qy, rz = pz - qz;
      m = fminf(m, rx * rx + ry * ry + rz * rz);
    }
    cur = sqrtf(block_max(m, redf));

    // next supertile: the first after `next` whose bound beats cur
    for (++next; next < n_sup; ++next)
      if (next != best_s && db[next] < cur) break;
    if (next >= n_sup) break;
    s = next;
  }
  out[p] = m;
}

extern "C" int point_triangle_launch(const float* pts, int n_blocks, const float* tri,
                                     const float* sup, int n_sup, float* out,
                                     void* stream) {
  if (n_blocks < 1 || n_sup < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)n_sup * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        point_triangle_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  point_triangle_kernel<<<n_blocks, BP, smem, (cudaStream_t)stream>>>(
      pts, reinterpret_cast<const float4*>(tri), sup, n_sup, out);
  return (int)cudaGetLastError();
}
