// Min point-triangle squared distance (kernel K3) for Hopper, sm_90a.
//
// Replaces the TPU kernel pointnetgpd_tpu/ops/point_triangle_pallas.py
// (_ptd_kernel via min_point_triangle_dist2), the distance pass of the
// mesh -> SDF voxelizer (ops/mesh_to_sdf.py). For every grid point it
// returns the minimum squared distance to a triangle set.
//
// What bounds it on the H100: fp32 instruction slots on the CUDA cores. The
// inputs are small (60k triangles are 3.84 MB, 1M grid points 12 MB) next to
// the 1e10 (point, triangle) pairs that a 100^3 grid needs even after
// supertile pruning.
// So the design does fewer pairs and fewer instructions per pair:
// - one block per spatially compact group of 128 grid points (4x4x8 cells),
//   one point per thread; each warp holds a compact 2x4x4 slab of them, and
//   the running min d^2 stays in a register;
// - the triangles stay in global memory (L2-resident); a block stages one
//   supertile of 128 triangles at a time into shared memory, together with
//   what each triangle's pair body needs that does not depend on the point:
//   the edge vectors, |ab|^2, |ac|^2, kb = ab.ac - |ab|^2, kc = |ac|^2 -
//   ab.ac, |n|^2 for n = ab x ac, the vectors u_v = (ac x n) / |n|^2 and
//   u_w = (n x ab) / |n|^2, the reciprocals of |ab|^2, |ac|^2 and |bc|^2
//   (each of max(., 1e-30), as the Pallas body guards its denominators) and
//   -kb / |bc|^2, and a bounding sphere. Each triangle is staged with its
//   vertices rotated so that bc is its shortest edge;
// - a division-free pair body: with those constants the Ericson region
//   tests need two dot products, d1 = ab.ap and d2 = ac.ap, and their
//   difference (the Pallas body computes six), the face weights are
//   v = u_v . ap and w = u_w . ap (well conditioned on slivers, where the
//   Pallas body's vb / (va + vb + vc) cancels), vb, vc = |n|^2 (v, w),
//   va <= 0 is vb + vc >= |n|^2, and the edge parameters t_ab, t_ac, t_bc
//   are products. The region tests and their priority are the Pallas
//   body's (edges bc < ac < ab, then vertices c < b < a); the closest point
//   is a + s ab + t ac with (s, t) selected per region, and the edge
//   parameters are clamped to [0, 1] (a free .SAT);
// - a bound-ordered walk: the block's lower bound to every supertile
//   (dist(block centre, sphere) - r - half-diagonal) is sorted in shared
//   memory with the supertile index as tie break (a bitonic sort), and the
//   block takes supertiles in that order until the first bound >= cur =
//   sqrt(max over the block of the running min d^2). The head of the order
//   is the TPU kernel's "nearest supertile first". Above SORT_CHUNK
//   supertiles the keys do not fit: the block walks them in chunks of
//   SORT_CHUNK, the chunk holding its nearest supertile first and then the
//   others in index order, each sorted in the same buffer and walked until
//   its first bound >= cur (a chunk whose least bound is >= cur is not
//   sorted at all). At most SORT_CHUNK supertiles there is one chunk and
//   the walk is the single sorted one;
// - a per-warp triangle reject: before a staged supertile is evaluated, each
//   lane tests four triangles: the distance from a triangle's sphere centre
//   to its warp's slab box, less the radius, against the warp's own running
//   max distance; a ballot gives the warp a uniform mask of the triangles
//   that can still lower one of its points;
// - two barriers per supertile: the block max travels through shared memory
//   between them.
// Skipping is conservative (the sphere radius carries a 2^-16 margin for
// rounding), so the result is the exact minimum over the triangles up to
// the rounding of the pair body.
//
// Padding: padded triangles sit at 1e8 (a point triangle, d^2 ~ 3e16,
// finite, and rejected by every warp once it has a bound); padded supertiles
// have their sphere there and are never taken after the first.
// Numerics: the kernel holds no division; the four reciprocals per staged
// triangle are the SFU's approximation refined by one Newton step (within an
// ulp), of max(., 1e-30), a normal number. sqrt is IEEE; never fast math.
// The compiler contracts a*b + c into FMAs.

#include <cuda_runtime.h>
#include <math.h>

#define BP 128               // grid points per block = threads per block
#define NW (BP / 32)         // warps per block
#define SUPER 128            // triangles per supertile: one per thread
#define TRI_F4 6             // float4 per staged triangle
#define SORT_CHUNK 16384     // supertiles sorted at a time (128 KB of keys)
#define EPS 1e-30f
#define FULL 0xffffffffu

typedef unsigned long long u64;
static_assert(SUPER == BP, "each thread stages one triangle of a supertile");

// the bits of a float as an unsigned key with the float's order
__device__ __forceinline__ unsigned ordered_bits(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_bound(u64 key) {
  const unsigned u = (unsigned)(key >> 32);
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

// 1/x for a normal x without a division: the SFU's approximation and one
// Newton step, within an ulp of the IEEE quotient
__device__ __forceinline__ float recip(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return fmaf(r, fmaf(-x, r, 1.f), r);
}

// min and max of three values each across the warp
__device__ __forceinline__ void warp_bbox(float v[6]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      v[i] = fminf(v[i], __shfl_xor_sync(FULL, v[i], o));
      v[3 + i] = fmaxf(v[3 + i], __shfl_xor_sync(FULL, v[3 + i], o));
    }
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

// centre and half-diagonal of a box given as (min xyz, max xyz)
__device__ __forceinline__ float4 box_sphere(const float v[6]) {
  const float ex = v[3] - v[0], ey = v[4] - v[1], ez = v[5] - v[2];
  return make_float4((v[0] + v[3]) * 0.5f, (v[1] + v[4]) * 0.5f,
                     (v[2] + v[5]) * 0.5f,
                     0.5f * sqrtf(ex * ex + ey * ey + ez * ez));
}

__device__ __forceinline__ float sq3(float x, float y, float z) {
  return x * x + y * y + z * z;
}

__device__ __forceinline__ void rotate3(float& a, float& b, float& c, bool rot_ab,
                                        bool rot_ca) {
  const float a0 = a, b0 = b, c0 = c;
  a = rot_ab ? c0 : (rot_ca ? b0 : a0);
  b = rot_ab ? a0 : (rot_ca ? c0 : b0);
  c = rot_ab ? b0 : (rot_ca ? a0 : c0);
}

// stage triangle row `row` of tri as the pair body's constants and sphere
__device__ __forceinline__ void stage_triangle(const float4* __restrict__ tri,
                                               long long row, float4* dst,
                                               float4* sph) {
  const float4* r = tri + row * 4;
  const float4 r0 = r[0], r1 = r[1], r2 = r[2];
  float ax = r0.x, ay = r0.y, az = r0.z, bx = r0.w, by = r1.x, bz = r1.y;
  float cx = r1.z, cy = r1.w, cz = r2.x;
  // rotate the vertices so that bc is the shortest edge: where an edge is
  // (nearly) zero, only edge bc's region test is exclusive, and ab's or
  // ac's would claim the whole triangle for one vertex
  {
    const float l_ab = sq3(bx - ax, by - ay, bz - az);
    const float l_bc = sq3(cx - bx, cy - by, cz - bz);
    const float l_ca = sq3(ax - cx, ay - cy, az - cz);
    const bool rot_ab = (l_ab < l_bc) & (l_ab <= l_ca);   // (a, b, c) <- (c, a, b)
    const bool rot_ca = !rot_ab & (l_ca < l_bc);          // (a, b, c) <- (b, c, a)
    rotate3(ax, bx, cx, rot_ab, rot_ca);
    rotate3(ay, by, cy, rot_ab, rot_ca);
    rotate3(az, bz, cz, rot_ab, rot_ca);
  }
  const float abx = bx - ax, aby = by - ay, abz = bz - az;
  const float acx = cx - ax, acy = cy - ay, acz = cz - az;
  const float bcx = cx - bx, bcy = cy - by, bcz = cz - bz;
  const float lab = sq3(abx, aby, abz), lac = sq3(acx, acy, acz);
  const float lbc = sq3(bcx, bcy, bcz);
  const float dd = abx * acx + aby * acy + abz * acz;
  // n = ab x ac, products rounded apart so that a segment (b == c) has
  // n = 0 exactly; then u_v = (ac x n) / |n|^2 and u_w = (n x ab) / |n|^2
  // give the face weights as v = u_v . ap, w = u_w . ap
  const float nx = __fmul_rn(aby, acz) - __fmul_rn(abz, acy);
  const float ny = __fmul_rn(abz, acx) - __fmul_rn(abx, acz);
  const float nz = __fmul_rn(abx, acy) - __fmul_rn(aby, acx);
  const float nn = sq3(nx, ny, nz), rn = recip(fmaxf(nn, EPS));
  const float kb = dd - lab, kc = lac - dd, rbc = recip(fmaxf(lbc, EPS));
  dst[0] = make_float4(ax, ay, az, lab);
  dst[1] = make_float4(abx, aby, abz, lac);
  dst[2] = make_float4(acx, acy, acz, kb);
  dst[3] = make_float4((acy * nz - acz * ny) * rn, (acz * nx - acx * nz) * rn,
                       (acx * ny - acy * nx) * rn, nn);
  dst[4] = make_float4((ny * abz - nz * aby) * rn, (nz * abx - nx * abz) * rn,
                       (nx * aby - ny * abx) * rn, recip(fmaxf(lab, EPS)));
  dst[5] = make_float4(recip(fmaxf(lac, EPS)), rbc, -kb * rbc, kc);
  // bounding sphere: the box centre, the farthest vertex, a 2^-16 margin
  const float sx = 0.5f * (fminf(ax, fminf(bx, cx)) + fmaxf(ax, fmaxf(bx, cx)));
  const float sy = 0.5f * (fminf(ay, fminf(by, cy)) + fmaxf(ay, fmaxf(by, cy)));
  const float sz = 0.5f * (fminf(az, fminf(bz, cz)) + fmaxf(az, fmaxf(bz, cz)));
  float r2max = 0.f;
  const float vx[3] = {ax, bx, cx}, vy[3] = {ay, by, cy}, vz[3] = {az, bz, cz};
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float dx = vx[i] - sx, dy = vy[i] - sy, dz = vz[i] - sz;
    r2max = fmaxf(r2max, dx * dx + dy * dy + dz * dz);
  }
  *sph = make_float4(sx, sy, sz, sqrtf(r2max) * (1.f + 1.52587890625e-5f));
}

// squared distance from p to one staged triangle: no division, no branch.
// With x = d2 - d1, the Pallas body's d3 = d1 - |ab|^2, d4 = d2 - ab.ac,
// d5 = d1 - ab.ac, d6 = d2 - |ac|^2 enter its tests as d3 >= 0 <=> d1 >=
// |ab|^2, d4 <= d3 <=> x <= ab.ac - |ab|^2 = kb, d5 <= d6 <=> x >= |ac|^2 -
// ab.ac = kc, and e43 = d4 - d3 = x - kb, e56 = d5 - d6 = kc - x
__device__ __forceinline__ float pair_d2(float px, float py, float pz,
                                         const float4* q) {
  const float4 q0 = q[0], q1 = q[1], q2 = q[2], q3 = q[3], q4 = q[4], q5 = q[5];
  const float apx = px - q0.x, apy = py - q0.y, apz = pz - q0.z;
  const float lab = q0.w, lac = q1.w, kb = q2.w, nn = q3.w, kc = q5.w;
  const float d1 = q1.x * apx + q1.y * apy + q1.z * apz;
  const float d2 = q2.x * apx + q2.y * apy + q2.z * apz;
  const float v = q3.x * apx + q3.y * apy + q3.z * apz;
  const float w = q4.x * apx + q4.y * apy + q4.z * apz;
  const float x = d2 - d1, vb = v * nn, vc = w * nn;

  const bool m_a = (d1 <= 0.f) & (d2 <= 0.f);
  const bool m_b = (d1 >= lab) & (x <= kb);
  const bool m_c = (d2 >= lac) & (x >= kc);
  const bool m_ab = (vc <= 0.f) & (d1 >= 0.f) & (d1 <= lab);
  const bool m_ac = (vb <= 0.f) & (d2 >= 0.f) & (d2 <= lac);
  const bool m_bc = (vb + vc >= nn) & (x >= kb) & (x <= kc);   // va <= 0

  const float t_ab = __saturatef(d1 * q4.w);
  const float t_ac = __saturatef(d2 * q5.x);
  const float t_bc = __saturatef(x * q5.y + q5.z);
  // closest point a + s ab + t ac: face, then bc, ac, ab, c, b, a (later wins)
  float s = v, t = w;
  s = m_bc ? 1.f - t_bc : s;
  t = m_bc ? t_bc : t;
  s = m_ac ? 0.f : s;
  t = m_ac ? t_ac : t;
  s = m_ab ? t_ab : s;
  t = m_ab ? 0.f : t;
  s = m_c ? 0.f : s;
  t = m_c ? 1.f : t;
  s = m_b ? 1.f : s;
  t = m_b ? 0.f : t;
  s = m_a ? 0.f : s;
  t = m_a ? 0.f : t;
  const float rx = s * q1.x + (t * q2.x - apx);
  const float ry = s * q1.y + (t * q2.y - apy);
  const float rz = s * q1.z + (t * q2.z - apz);
  return rx * rx + ry * ry + rz * rz;
}

// the block's keys (bound, index) of supertiles s0 .. s0 + len - 1 in
// keys[0 .. pad), padded with ~0, and their least key in *kmin
__device__ __forceinline__ void fill_keys(u64* keys, u64* kmin, const float* __restrict__ sup,
                                          float4 blk, int s0, int len, int pad, int t) {
  u64 lo = ~0ull;
  for (int i = t; i < pad; i += BP) {
    u64 key = ~0ull;
    if (i < len) {
      const int s = s0 + i;
      const float4 sp = *reinterpret_cast<const float4*>(sup + (long long)s * 8);
      const float dx = sp.x - blk.x, dy = sp.y - blk.y, dz = sp.z - blk.z;
      const float d = sqrtf(dx * dx + dy * dy + dz * dz) - sp.w - blk.w;
      key = ((u64)ordered_bits(d) << 32) | (unsigned)s;
    }
    keys[i] = key;
    lo = key < lo ? key : lo;
  }
  if (kmin != nullptr) atomicMin(kmin, lo);
  __syncthreads();
}

// bitonic sort of keys[0 .. pad), ascending; pad a power of two
__device__ __forceinline__ void sort_keys(u64* keys, int pad, int t) {
  for (int k = 2; k <= pad; k <<= 1)
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = t; i < pad; i += BP) {
        const int l = i ^ j;
        if (l > i) {
          const u64 a = keys[i], b = keys[l];
          if ((a > b) == ((i & k) == 0)) { keys[i] = b; keys[l] = a; }
        }
      }
      __syncthreads();
    }
}

// walk a sorted chunk keys[0 .. len): take supertiles until the first
// bound >= cur (the first of the first chunk unconditionally), each staged
// in shared memory and evaluated by the per-warp reject and pair body
__device__ __forceinline__ void walk(const u64* keys, int len, bool first,
                                     const float4* __restrict__ tri, float4* tri_s,
                                     float4* sph_s, float* red, int t, float px, float py,
                                     float pz, float4 slab, float hx, float hy, float hz,
                                     float& m, float& cur, float& wmax, int& visited,
                                     int& pairs) {
  const int lane = t & 31, wid = t >> 5;
  for (int k = 0;; ++k) {
    __syncthreads();                   // tri_s readers done, red published
    if (k > 0) {
      float mx = red[0];
#pragma unroll
      for (int w = 1; w < NW; ++w) mx = fmaxf(mx, red[w]);
      cur = sqrtf(mx);
    }
    if (k >= len) break;
    const u64 key = keys[k];
    if ((k > 0 || !first) && key_bound(key) >= cur) break;
    const int s = (int)(unsigned)key;
    stage_triangle(tri, (long long)s * SUPER + t, tri_s + t * TRI_F4, sph_s + t);
    __syncthreads();
    ++visited;

    // lane tests triangles lane + 32 q, the distance from its sphere to the
    // warp's slab against the warp's running max; the warp evaluates the
    // kept ones
    const float cur_w = sqrtf(wmax);
    unsigned mask[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float4 sp = sph_s[q * 32 + lane];
      const float dx = fmaxf(fabsf(sp.x - slab.x) - hx, 0.f);
      const float dy = fmaxf(fabsf(sp.y - slab.y) - hy, 0.f);
      const float dz = fmaxf(fabsf(sp.z - slab.z) - hz, 0.f);
      const float rr = sp.w + cur_w;
      mask[q] = __ballot_sync(FULL, dx * dx + dy * dy + dz * dz < rr * rr);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      pairs += __popc(mask[q]);
      for (unsigned mm = mask[q]; mm; mm &= mm - 1)
        m = fminf(m, pair_d2(px, py, pz, tri_s + (q * 32 + __ffs(mm) - 1) * TRI_F4));
    }
    wmax = warp_max(m);
    if (lane == 0) red[wid] = wmax;
  }
}

// CHUNKED: more than SORT_CHUNK supertiles. The single-chunk instance
// carries none of the chunk bookkeeping, so it keeps the registers of the
// single sorted walk
template <bool CHUNKED>
__global__ void __launch_bounds__(BP)
point_triangle_kernel(const float* __restrict__ pts, const float4* __restrict__ tri,
                      const float* __restrict__ sup, int n_sup, int n_pad,
                      float* __restrict__ out, int* __restrict__ stats) {
  extern __shared__ u64 keys[];                  // (bound, index) of a chunk
  __shared__ float4 tri_s[SUPER * TRI_F4];       // the staged supertile
  __shared__ float4 sph_s[SUPER];                // its triangles' spheres
  __shared__ float red6[NW][6];
  __shared__ float red[NW];
  __shared__ u64 kmin;                           // least key of a chunk

  const int t = threadIdx.x, lane = t & 31, wid = t >> 5;
  // a block's point (ix, iy, iz) of its 4x4x8 cells sits at ix*32 + iy*8 +
  // iz; warp wid holds a compact 2x4x4 slab of them
  const int ix = 2 * (wid >> 1) + (lane >> 4), iz = 4 * (wid & 1) + (lane & 3);
  const long long p = (long long)blockIdx.x * BP + ix * 32 + ((lane >> 2) & 3) * 8 + iz;
  const float px = pts[p * 3 + 0], py = pts[p * 3 + 1], pz = pts[p * 3 + 2];
  float m = INFINITY;

  // the warp's slab (centre, half-extents) and the block's box (centre,
  // half-diagonal)
  float bb[6] = {px, py, pz, px, py, pz};
  warp_bbox(bb);
  const float4 slab = box_sphere(bb);
  const float hx = 0.5f * (bb[3] - bb[0]), hy = 0.5f * (bb[4] - bb[1]);
  const float hz = 0.5f * (bb[5] - bb[2]);
  if (lane == 0)
    for (int i = 0; i < 6; ++i) red6[wid][i] = bb[i];
  if (CHUNKED && t == 0) kmin = ~0ull;
  __syncthreads();
  for (int w = 0; w < NW; ++w)
    for (int i = 0; i < 3; ++i) {
      bb[i] = fminf(bb[i], red6[w][i]);
      bb[3 + i] = fmaxf(bb[3 + i], red6[w][3 + i]);
    }
  const float4 blk = box_sphere(bb);

  float cur = INFINITY;      // block: sqrt(max of the running min d^2)
  float wmax = INFINITY;     // warp: max of its points' running min d^2
  int visited = 0, pairs = 0;
  if (!CHUNKED) {            // the block's lower bound to each supertile
    fill_keys(keys, nullptr, sup, blk, 0, n_sup, n_pad, t);
    sort_keys(keys, n_pad, t);
    walk(keys, n_sup, true, tri, tri_s, sph_s, red, t, px, py, pz, slab, hx, hy, hz, m,
         cur, wmax, visited, pairs);
  } else {
    // chunks of SORT_CHUNK supertiles: the one holding the nearest
    // supertile first (its key is the least over all of them), then index
    // order
    const int n_chunks = (n_sup + SORT_CHUNK - 1) / SORT_CHUNK;
    for (int c = 0; c < n_chunks; ++c)
      fill_keys(keys, &kmin, sup, blk, c * SORT_CHUNK, min(SORT_CHUNK, n_sup - c * SORT_CHUNK),
                SORT_CHUNK, t);
    const int c_first = (int)(unsigned)kmin / SORT_CHUNK;
    for (int ci = 0; ci < n_chunks; ++ci) {
      const int c = ci == 0 ? c_first : (ci <= c_first ? ci - 1 : ci);
      const int s0 = c * SORT_CHUNK, len = min(SORT_CHUNK, n_sup - s0);
      int pad = 1;
      while (pad < len) pad <<= 1;
      __syncthreads();               // the last chunk's keys and kmin are read
      if (t == 0) kmin = ~0ull;
      __syncthreads();
      fill_keys(keys, &kmin, sup, blk, s0, len, pad, t);
      if (ci > 0 && key_bound(kmin) >= cur) continue;   // no supertile can win
      sort_keys(keys, pad, t);
      walk(keys, len, ci == 0, tri, tri_s, sph_s, red, t, px, py, pz, slab, hx, hy, hz, m,
           cur, wmax, visited, pairs);
    }
  }
  out[p] = m;
  if (stats != nullptr) {
    // supertiles visited; (point, triangle) pairs evaluated
    if (t == 0) stats[2 * blockIdx.x] = visited;
    if (lane == 0) atomicAdd(stats + 2 * blockIdx.x + 1, pairs * 32);
  }
}

template <bool CHUNKED>
static int launch(const float* pts, int n_blocks, const float* tri, const float* sup,
                  int n_sup, float* out, int* stats, cudaStream_t stream) {
  int n_pad = 1;
  while (n_pad < n_sup && n_pad < SORT_CHUNK) n_pad <<= 1;
  const size_t smem = (size_t)n_pad * sizeof(u64);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        point_triangle_kernel<CHUNKED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  point_triangle_kernel<CHUNKED><<<n_blocks, BP, smem, stream>>>(
      pts, reinterpret_cast<const float4*>(tri), sup, n_sup, n_pad, out, stats);
  return (int)cudaGetLastError();
}

// stats: null, or (n_blocks, 2) int32 zeros that receive per block the
// supertiles visited and the (point, triangle) pairs evaluated
extern "C" int point_triangle_launch(const float* pts, int n_blocks, const float* tri,
                                     const float* sup, int n_sup, float* out,
                                     int* stats, void* stream) {
  if (n_blocks < 1 || n_sup < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  return n_sup > SORT_CHUNK ? launch<true>(pts, n_blocks, tri, sup, n_sup, out, stats, s)
                            : launch<false>(pts, n_blocks, tri, sup, n_sup, out, stats, s);
}
