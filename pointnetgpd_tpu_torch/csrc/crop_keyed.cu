// Keyed top-k crop (kernel K6) for Hopper, sm_90a.
//
// Replaces no Pallas kernel: the JAX package computes this crop with XLA
// ops (pointnetgpd_tpu/ops/crop.py _crop_batch, its two-stage and direct
// top-k). The port's plain version (pointnetgpd_tpu_torch/ops/crop.py
// _keyed_plain) gathers the cloud into the keyed layout, rounds every
// point's frame coordinates in float64 planes, masks the keys, sorts every
// key of every grasp (stable, descending) to keep num_out a row, and
// gathers and rounds again: about 150 PyTorch launches a call. K6 is the
// same selection in two launches, with the count-dependent draw
// (draws.crop_ranks) between them on the host, so every draws source sees
// the calls it saw before, in the same order (crop_keys, then crop_ranks).
//
// G grasps crop a cloud of P points; grasp g draws one key per position of
// the keyed layout (keys, G x p_len float32):
// - direct (seg_len 0, P <= 4096): position j is point j, p_len = P;
// - strided interleave (seg_len = ceil(P / 16)): position j = s * seg_len
//   + i is point s + 16 i, p_len = 16 seg_len; a position past the cloud is
//   a padding slot, never in the box (the plain version gathers point P - 1
//   there).
// The plain version's order is torch.sort(where(in box, key, -inf),
// descending=True, stable=True): keys high to low, ties to the lower
// position, every position outside the box at -inf.
//
// 1. crop_keyed_select_kernel, one block per grasp.
//    a. The in-box bits of the row in shared memory (p_len / 8 bytes: 6.25
//       KB at 50,000 points), set point by point (coalesced reads of the
//       cloud, a shared atomicOr at the point's position), and the count.
//    b. m = min(count, kk) positions are needed (kk = min(num_out, P)), one
//       where the count is 0: a radix select over the keys' order bits, 8
//       bits a pass, histograms in shared memory, the in-box keys re-read
//       from L2 each pass and the positions outside the box added to the
//       -inf bin by their number, finds the m-th largest key T and how
//       many lie above it.
//    c. The positions above T (in-box, in any order), then the first
//       positions at T in position order (a block-wide ordered scan, needed
//       only where T is tied beyond what is taken: planted keys, or -inf
//       when the count is below m), go into a shared buffer as
//       (order bits << 32 | ~position), sorted descending (bitonic): the
//       first m entries of the plain version's sort, written to perm.
// 2. crop_keyed_gather_kernel, one block per grasp: output k takes perm[k]
//    where count > num_out, else perm[min(r[k], kk - 1)] (the plain
//    version's with-replacement ranks), gathers that position's point and
//    writes its frame coordinates.
//
// Rows too long for shared memory (past SMEM_BYTES) keep the bits and the
// buffer in a global scratch the caller passes: the same code through
// generic pointers.
//
// Numerics: the frame coordinate i of point p is, as ops/crop.py _to_frames
// and ops/fp.py lin3 round it, with d = p - c in float32:
//   fma(d.z, R[i][2], fma(d.x, R[i][0], d.y * R[i][1]))
// where d.y * R[i][1] is a float32 product and each fma a float64 product
// and a float64 add of float32 operands, rounded once to float32. The box
// test is strict, in float32. The file is built with -fmad=false and every
// operation is spelled as an intrinsic, so K6's bits equal the plain
// version's: the same points, counts and coordinates. Keys are ordered as
// torch's sort orders float32: -0 ties +0, NaN above everything.
//
// What bounds it on the H100: at the GPD cell's 128 grasps x 50,000
// points, the clouds (76.8 MB) and the keys (25.6 MB) read once from DRAM,
// 0.031 ms at 3.35 TB/s; 12 float64 instructions a point (77M, 4.5 us at
// 17e12 a second). The radix passes re-read the in-box keys from L2.

#include <cuda_runtime.h>
#include <stdint.h>

#define NT 1024          // threads per block, select launch
#define NWARPS (NT / 32)
#define NT_GATHER 256    // threads per block, gather launch
#define SEG 16           // segments of the strided interleave (ops/crop_keyed.py SEG)
#define BINS 256         // radix digit of 8 bits
#define OUT_ORDER 0x007fffffu   // order bits of -inf: every position outside the box
#define SMEM_BYTES (200 * 1024) // row storage kept in shared memory up to this (ops/crop_keyed.py)

struct Frame {
  float cx, cy, cz;
  float r[9];  // rows [approach, binormal, minor]
};

__device__ __forceinline__ Frame load_frame(const float* centers, const float* rot, int g) {
  Frame f;
  f.cx = centers[3 * g];
  f.cy = centers[3 * g + 1];
  f.cz = centers[3 * g + 2];
#pragma unroll
  for (int i = 0; i < 9; ++i) f.r[i] = rot[9 * g + i];
  return f;
}

// float32 fma(a, b, c) as ops/fp.py computes it: float64 product and add of
// the float32 operands, one rounding to float32
__device__ __forceinline__ float fma64(float a, float b, float c) {
  return __double2float_rn(__dadd_rn(__dmul_rn((double)a, (double)b), (double)c));
}

__device__ __forceinline__ void to_frame(const Frame& f, float px, float py, float pz,
                                         float out[3]) {
  const float dx = __fsub_rn(px, f.cx);
  const float dy = __fsub_rn(py, f.cy);
  const float dz = __fsub_rn(pz, f.cz);
#pragma unroll
  for (int i = 0; i < 3; ++i)
    out[i] = fma64(dz, f.r[3 * i + 2], fma64(dx, f.r[3 * i], __fmul_rn(dy, f.r[3 * i + 1])));
}

// unsigned bits that order as torch's sort orders float32 keys
__device__ __forceinline__ uint32_t key_order(float z) {
  const uint32_t u = __float_as_uint(z);
  const uint32_t mag = u & 0x7fffffffu;
  if (mag > 0x7f800000u) return 0xffffffffu;  // NaN
  if (mag == 0u) return 0x80000000u;          // -0 ties +0
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// position of point q in the keyed layout, and the point at position j
// (P or more: a padding slot)
__device__ __forceinline__ int position_of(int q, int seg_len) {
  return seg_len ? (q % SEG) * seg_len + q / SEG : q;
}

__device__ __forceinline__ int point_at(int j, int seg_len) {
  if (!seg_len) return j;
  const int s = j / seg_len;
  return s + SEG * (j - s * seg_len);
}

__device__ __forceinline__ unsigned long long entry(uint32_t order, int j) {
  return ((unsigned long long)order << 32) | (uint32_t)~(uint32_t)j;
}

__host__ __device__ __forceinline__ int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// 32-bit words of one grasp's row storage: the bits (rounded to an even
// count, so the buffer is 8-byte aligned) and the sort buffer
__host__ __device__ __forceinline__ int row_words(int p_len, int kk) {
  const int n_words = (p_len + 31) / 32;
  return n_words + (n_words & 1) + 2 * pow2_at_least(kk > 1 ? kk : 1);
}

// exclusive prefix of v over the block (in thread order); *total gets the
// sum. Every thread calls it.
__device__ int block_exclusive(int v, int* warp_sum, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int n = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += n;
  }
  if (lane == 31) warp_sum[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = lane < NWARPS ? warp_sum[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int n = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += n;
    }
    if (lane < NWARPS) warp_sum[lane] = s;
  }
  __syncthreads();
  const int out = x - v + (warp > 0 ? warp_sum[warp - 1] : 0);
  *total = warp_sum[NWARPS - 1];
  __syncthreads();  // warp_sum is reused by the next call
  return out;
}

__global__ void __launch_bounds__(NT, 1) crop_keyed_select_kernel(
    const float* __restrict__ pc, int cloud_stride, int P, int seg_len, int p_len,
    const float* __restrict__ centers, const float* __restrict__ rot,
    const float* __restrict__ box_lo, const float* __restrict__ box_hi,
    const float* __restrict__ keys, int kk, uint32_t* scratch, int* __restrict__ perm,
    long long* __restrict__ count) {
  extern __shared__ uint32_t smem[];
  __shared__ int hist[BINS];
  __shared__ int warp_sum[NWARPS];
  __shared__ int s_count, s_bin, s_above, s_nsel;
  const int g = blockIdx.x, tid = threadIdx.x, lane = tid & 31;
  const int n_words = (p_len + 31) / 32;
  uint32_t* row = scratch ? scratch + (size_t)g * row_words(p_len, kk) : smem;
  unsigned long long* buf = (unsigned long long*)(row + n_words + (n_words & 1));

  // a. the in-box bits and the count
  for (int w = tid; w < n_words; w += NT) row[w] = 0u;
  if (tid == 0) {
    s_count = 0;
    s_nsel = 0;
  }
  __syncthreads();
  const Frame f = load_frame(centers, rot, g);
  float lo[3], hi[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    lo[i] = box_lo[3 * g + i];
    hi[i] = box_hi[3 * g + i];
  }
  const float* cloud = pc + (size_t)g * cloud_stride;
  int mine = 0;
  for (int q = tid; q < P; q += NT) {
    float fr[3];
    to_frame(f, cloud[3 * q], cloud[3 * q + 1], cloud[3 * q + 2], fr);
    if ((fr[0] > lo[0]) & (fr[0] < hi[0]) & (fr[1] > lo[1]) & (fr[1] < hi[1]) &
        (fr[2] > lo[2]) & (fr[2] < hi[2])) {
      const int j = position_of(q, seg_len);
      atomicOr(row + (j >> 5), 1u << (j & 31));
      ++mine;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) mine += __shfl_xor_sync(0xffffffffu, mine, o);
  if (lane == 0 && mine) atomicAdd(&s_count, mine);
  __syncthreads();
  const int cnt = s_count;
  if (tid == 0) count[g] = cnt;
  const int m = min(kk, max(cnt, 1));
  if (kk == 0) return;  // num_out 0: only the count

  // b. radix select of the m-th largest order bits T over the row
  const float* z = keys + (size_t)g * p_len;
  const int n_out = p_len - cnt;
  uint32_t prefix = 0u, pmask = 0u;
  int k = m, above_total = 0, at_t = 0;
  for (int shift = 24; shift >= 0; shift -= 8) {
    if (tid < BINS) hist[tid] = 0;
    __syncthreads();
    for (int j0 = 0; j0 < p_len; j0 += NT) {
      const int j = j0 + tid;
      bool take = false;
      uint32_t bin = 0u;
      if (j < p_len && ((row[j >> 5] >> (j & 31)) & 1u)) {
        const uint32_t u = key_order(z[j]);
        take = (u & pmask) == prefix;
        bin = (u >> shift) & (BINS - 1);
      }
      const unsigned voters = __ballot_sync(0xffffffffu, take);
      if (take) {
        const unsigned peers = __match_any_sync(voters, bin);
        if (lane == __ffs(peers) - 1) atomicAdd(&hist[bin], __popc(peers));
      }
    }
    if (tid == 0 && n_out > 0 && (OUT_ORDER & pmask) == prefix)
      atomicAdd(&hist[(OUT_ORDER >> shift) & (BINS - 1)], n_out);
    __syncthreads();
    if (tid < 32) {
      // lane l holds bins 255 - 8 l down to 248 - 8 l
      int c[8], sum = 0;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        c[i] = hist[BINS - 1 - 8 * lane - i];
        sum += c[i];
      }
      int incl = sum;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int n = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += n;
      }
      int above = incl - sum;
      if (above < k && k <= incl) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          if (k <= above + c[i]) {
            s_bin = BINS - 1 - 8 * lane - i;
            s_above = above;
            break;
          }
          above += c[i];
        }
      }
    }
    __syncthreads();
    prefix |= (uint32_t)s_bin << shift;
    pmask |= (uint32_t)(BINS - 1) << shift;
    k -= s_above;
    above_total += s_above;
    at_t = hist[s_bin];
    __syncthreads();
  }
  const uint32_t T = prefix;
  const int need = k;  // positions at T to take; above_total + need == m

  // c. the positions above T, then the first `need` at T in position order
  // (all of them, in any order, where every position at T is taken)
  const bool all_at_t = need == at_t && T != OUT_ORDER;
  for (int j0 = 0; j0 < p_len; j0 += NT) {
    const int j = j0 + tid;
    bool take = false;
    uint32_t u = 0u;
    if (j < p_len && ((row[j >> 5] >> (j & 31)) & 1u)) {
      u = key_order(z[j]);
      take = u > T || (all_at_t && u == T);
    }
    const unsigned voters = __ballot_sync(0xffffffffu, take);
    int base = 0;
    if (lane == 0 && voters) base = atomicAdd(&s_nsel, __popc(voters));
    base = __shfl_sync(0xffffffffu, base, 0);
    if (take) buf[base + __popc(voters & ((1u << lane) - 1u))] = entry(u, j);
  }
  if (!all_at_t) {
    int found = 0;
    for (int j0 = 0; j0 < p_len && found < need; j0 += NT) {
      const int j = j0 + tid;
      bool eq = false;
      if (j < p_len) {
        if ((row[j >> 5] >> (j & 31)) & 1u) eq = key_order(z[j]) == T;
        else eq = T == OUT_ORDER;
      }
      int total;
      const int rank = found + block_exclusive(eq ? 1 : 0, warp_sum, &total);
      if (eq && rank < need) buf[above_total + rank] = entry(T, j);
      found += total;
    }
  }
  const int n_sort = pow2_at_least(m);
  for (int i = m + tid; i < n_sort; i += NT) buf[i] = 0ull;  // below every entry
  __syncthreads();
  // bitonic sort, descending
  for (int size = 2; size <= n_sort; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = tid; i < n_sort; i += NT) {
        const int p = i ^ stride;
        if (p > i) {
          const unsigned long long a = buf[i], b = buf[p];
          if (((i & size) == 0) ? (a < b) : (a > b)) {
            buf[i] = b;
            buf[p] = a;
          }
        }
      }
      __syncthreads();
    }
  }
  int* out = perm + (size_t)g * kk;
  for (int t = tid; t < m; t += NT) out[t] = (int)~(uint32_t)buf[t];
}

__global__ void __launch_bounds__(NT_GATHER) crop_keyed_gather_kernel(
    const float* __restrict__ pc, int cloud_stride, int P, int seg_len,
    const float* __restrict__ centers, const float* __restrict__ rot,
    const int* __restrict__ perm, int kk, const long long* __restrict__ count,
    const long long* __restrict__ r, int num_out, float* __restrict__ out) {
  const int g = blockIdx.x;
  const long long cnt = count[g];
  // the entries the select launch wrote; a rank in [0, max(count, 1)), as
  // the draws give it, is clamped as the plain version clamps it, and one
  // outside that range never reaches an unwritten entry
  const long long written = min((long long)kk, cnt > 1 ? cnt : 1);
  const Frame f = load_frame(centers, rot, g);
  const float* cloud = pc + (size_t)g * cloud_stride;
  const int* row = perm + (size_t)g * kk;
  for (int k = threadIdx.x; k < num_out; k += NT_GATHER) {
    long long t = k;
    if (cnt <= num_out) {
      t = r[(size_t)g * num_out + k];
      t = t < 0 ? 0 : (t > written - 1 ? written - 1 : t);
    }
    int q = point_at(row[t], seg_len);
    if (q > P - 1) q = P - 1;
    float fr[3];
    to_frame(f, cloud[3 * q], cloud[3 * q + 1], cloud[3 * q + 2], fr);
    float* o = out + ((size_t)g * num_out + k) * 3;
    o[0] = fr[0];
    o[1] = fr[1];
    o[2] = fr[2];
  }
}

static int keyed_len(int P, int seg_len) { return seg_len ? SEG * seg_len : P; }

static bool valid_sizes(int P, int seg_len, int G, int kk) {
  return G >= 1 && P >= 1 && kk >= 0 && kk <= P && seg_len >= 0 &&
         (seg_len == 0 || SEG * seg_len >= P);
}

// pc: the cloud(s), float32, (P, 3) or (G, P, 3) with cloud_stride 0 or 3 P;
// centers (G, 3), rot (G, 3, 3), box_lo, box_hi (G, 3), keys (G, p_len)
// float32 (p_len = 16 seg_len, or P where seg_len is 0); kk = min(num_out,
// P); scratch: null, or G x row_words(p_len, kk) int32 where the row storage
// passes SMEM_BYTES; perm (G, kk) int32 (its first min(count, kk) entries,
// one where the count is 0) and count (G,) int64 are written
extern "C" int crop_keyed_select_launch(const float* pc, int cloud_stride, int P, int seg_len,
                                        int G, const float* centers, const float* rot,
                                        const float* box_lo, const float* box_hi,
                                        const float* keys, int kk, uint32_t* scratch,
                                        int* perm, long long* count, void* stream) {
  if (!valid_sizes(P, seg_len, G, kk)) return (int)cudaErrorInvalidValue;
  const int p_len = keyed_len(P, seg_len);
  const size_t bytes = (size_t)4 * row_words(p_len, kk);
  size_t dyn = 0;
  if (!scratch) {
    if (bytes > SMEM_BYTES) return (int)cudaErrorInvalidValue;
    dyn = bytes;
    if (dyn > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          crop_keyed_select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
      if (e != cudaSuccess) return (int)e;
    }
  }
  crop_keyed_select_kernel<<<G, NT, dyn, (cudaStream_t)stream>>>(
      pc, cloud_stride, P, seg_len, p_len, centers, rot, box_lo, box_hi, keys, kk, scratch, perm,
      count);
  return (int)cudaGetLastError();
}

// perm and count from crop_keyed_select_launch; r (G, num_out) int64 from
// draws.crop_ranks; out (G, num_out, 3) float32 is written
extern "C" int crop_keyed_gather_launch(const float* pc, int cloud_stride, int P, int seg_len,
                                        int G, const float* centers, const float* rot,
                                        const int* perm, int kk, const long long* count,
                                        const long long* r, int num_out, float* out,
                                        void* stream) {
  if (!valid_sizes(P, seg_len, G, kk) || num_out < 0 || (num_out > 0 && kk < 1))
    return (int)cudaErrorInvalidValue;
  crop_keyed_gather_kernel<<<G, NT_GATHER, 0, (cudaStream_t)stream>>>(
      pc, cloud_stride, P, seg_len, centers, rot, perm, kk, count, r, num_out, out);
  return (int)cudaGetLastError();
}
