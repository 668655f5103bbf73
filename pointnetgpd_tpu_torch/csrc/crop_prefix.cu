// Prefix rank-select crop (kernel K4) for Hopper, sm_90a.
//
// Replaces no Pallas kernel: the JAX package computes this crop with XLA
// ops (pointnetgpd_tpu/ops/crop.py _crop_batch_prefix :250,
// _crop_batch_prefix_percloud :277, _rank_select_indices :204). The port's
// plain version (pointnetgpd_tpu_torch/ops/crop.py _prefix_plain) spends
// about 110 PyTorch launches a call on (G, P) float64 planes, a stack, a
// (G, P) cumsum and a (G, num_out, 128) gather. K4 is the same selection in
// two launches, with the count-dependent draw (draws.crop_windows) between
// them on the host, so every draws source sees the calls it saw before, in
// the same order (crop_perm, then crop_windows).
//
// G grasps crop a cloud of P points taken in the shuffled order perm (P,),
// padded to p_pad (P rounded up to 128) with points at 1e9 (PAD below, the
// plain version's padding rows):
// 1. crop_count_kernel, one block per grasp. Position j is the point
//    pc[g * cloud_stride + 3 * perm[j]] (cloud_stride 0: one shared cloud;
//    3 P: grasp g's own cloud), so nothing is gathered or padded in device
//    memory. Each warp takes 32 positions at a time and writes their in-box
//    bits as one word (__ballot_sync). The block then writes the inclusive
//    prefix of the popcounts of the row's 128-position blocks (incl, G x
//    p_pad / 128 int32) and the grasp's count, the prefix's last entry.
// 2. crop_select_kernel, one block per grasp, reading the bit row and its
//    block prefix from global memory (2.5 KB and 628 bytes a grasp at
//    20,096 positions, in L1 after the first reads). Output k takes the
//    rank t of the plain version (the cyclic window when count > num_out,
//    else r + 1), the block by a binary search of the prefix, the offset as
//    the position of the remaining rank's set bit in that block, the plain
//    version's clamps, index 0 where the count is 0; then it gathers the
//    point and writes its frame coordinates again.
//
// Neither launch keeps a row in shared memory, so any cloud the card holds
// fits.
//
// Numerics: the frame coordinate i of point p is, as ops/crop.py _to_frames
// and ops/fp.py lin3 round it, with d = p - c in float32:
//   fma(d.z, R[i][2], fma(d.x, R[i][0], d.y * R[i][1]))
// where d.y * R[i][1] is a float32 product and each fma a float64 product
// and a float64 add of float32 operands, rounded once to float32. The box
// test is strict, in float32. The file is built with -fmad=false and every
// operation is spelled as an intrinsic, so K4's bits equal the plain
// version's: the same points, counts and coordinates.
//
// What bounds it on the H100: at the scorer's 512 grasps x 20,096
// positions, 10.3M (grasp, point) pairs of 12 float64 instructions (four
// for each coordinate: 123M, 7.4 us at 64 a clock on 132 SMs), the
// gathers from a 240 KB cloud and a 160 KB perm that stay in L2, and about
// 10 MB that must cross DRAM (the bits written and read back, the block
// prefix, the draws, the output: 3 us at 3.35 TB/s). Latency, not either rate, is what remains: each warp
// loads UNROLL words' perm entries, then their points, before it computes.

#include <cuda_runtime.h>
#include <stdint.h>

#define NT 256           // threads per block, both launches
#define NWARPS (NT / 32)
#define UNROLL 4         // words in flight per warp in the count launch
#define BLK 128          // positions per prefix block (ops/crop_prefix.py BLK)
#define WORDS_PER_BLK (BLK / 32)
#define PAD 1e9f         // the padding rows' coordinates

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

// point at shuffled position j of grasp g's cloud; the padding rows past P
__device__ __forceinline__ void load_point(const float* cloud, const long long* perm, int P,
                                           int j, float& x, float& y, float& z) {
  if (j < P) {
    const float* q = cloud + 3 * perm[j];
    x = q[0];
    y = q[1];
    z = q[2];
  } else {
    x = y = z = PAD;
  }
}

// popcount of 128-position block b of a bit row
__device__ __forceinline__ int block_popc(const uint32_t* row, int b) {
  int c = 0;
#pragma unroll
  for (int q = 0; q < WORDS_PER_BLK; ++q) c += __popc(row[b * WORDS_PER_BLK + q]);
  return c;
}

// inclusive prefix of the popcounts of row's nb blocks into incl: each
// thread a run of blocks, a block-wide scan of the runs' totals, then each
// run again from its offset. Returns the row's total to every thread.
__device__ int block_prefix(const uint32_t* row, int* incl, int nb, int* warp_sum) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int per = (nb + NT - 1) / NT;
  const int b0 = min(nb, (int)threadIdx.x * per), b1 = min(nb, b0 + per);
  int run = 0;
  for (int b = b0; b < b1; ++b) run += block_popc(row, b);
  int v = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int n = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += n;
  }
  if (lane == 31) warp_sum[warp] = v;
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
  int acc = v - run + (warp > 0 ? warp_sum[warp - 1] : 0);
  for (int b = b0; b < b1; ++b) {
    acc += block_popc(row, b);
    incl[b] = acc;
  }
  return warp_sum[NWARPS - 1];
}

__global__ void __launch_bounds__(NT) crop_count_kernel(
    const float* __restrict__ pc, int cloud_stride, const long long* __restrict__ perm, int P,
    int p_pad, const float* __restrict__ centers, const float* __restrict__ rot,
    const float* __restrict__ box_lo, const float* __restrict__ box_hi,
    uint32_t* __restrict__ bits, int* __restrict__ incl, long long* __restrict__ count) {
  __shared__ int warp_sum[NWARPS];
  const int g = blockIdx.x, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const Frame f = load_frame(centers, rot, g);
  float lo[3], hi[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    lo[i] = box_lo[3 * g + i];
    hi[i] = box_hi[3 * g + i];
  }
  const float* cloud = pc + (size_t)g * cloud_stride;
  uint32_t* row = bits + (size_t)g * (p_pad / 32);
  const int n_words = p_pad / 32;
  for (int w0 = warp; w0 < n_words; w0 += NWARPS * UNROLL) {
    // UNROLL independent words: their loads overlap
    long long q[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int j = (w0 + u * NWARPS) * 32 + lane;
      q[u] = (j < P) ? perm[j] : -1;
    }
    float x[UNROLL], y[UNROLL], z[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (q[u] >= 0) {
        const float* p = cloud + 3 * q[u];
        x[u] = p[0];
        y[u] = p[1];
        z[u] = p[2];
      } else {
        x[u] = y[u] = z[u] = PAD;
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int w = w0 + u * NWARPS;
      if (w < n_words) {    // uniform across the warp
        float fr[3];
        to_frame(f, x[u], y[u], z[u], fr);
        const bool in = (fr[0] > lo[0]) & (fr[0] < hi[0]) & (fr[1] > lo[1]) &
                        (fr[1] < hi[1]) & (fr[2] > lo[2]) & (fr[2] < hi[2]);
        const uint32_t word = __ballot_sync(0xffffffffu, in);
        if (lane == 0) row[w] = word;
      }
    }
  }
  __syncthreads();    // the row's words, visible to the whole block
  const int total = block_prefix(row, incl + (size_t)g * (p_pad / BLK), p_pad / BLK, warp_sum);
  if (threadIdx.x == 0) count[g] = total;
}

// position (0..31) of the n-th set bit of w, n in [1, popc(w)]
__device__ __forceinline__ int nth_set_bit(uint32_t w, int n) {
  int pos = 0;
#pragma unroll
  for (int half = 16; half > 0; half >>= 1) {
    const uint32_t low = (1u << half) - 1u;
    const int c = __popc(w & low);
    if (n > c) {
      n -= c;
      w >>= half;
      pos += half;
    } else {
      w &= low;
    }
  }
  return pos;
}

__global__ void __launch_bounds__(NT) crop_select_kernel(
    const float* __restrict__ pc, int cloud_stride, const long long* __restrict__ perm, int P,
    int p_pad, const float* __restrict__ centers, const float* __restrict__ rot,
    const uint32_t* __restrict__ bits, const int* __restrict__ incl,
    const long long* __restrict__ count, const long long* __restrict__ r,
    const long long* __restrict__ start, int num_out, float* __restrict__ out) {
  const int g = blockIdx.x;
  const int n_words = p_pad / 32, nb = p_pad / BLK;
  const uint32_t* row = bits + (size_t)g * n_words;
  const int* pre = incl + (size_t)g * nb;
  const long long cnt = count[g];
  const long long cmax = cnt > 1 ? cnt : 1;
  const long long s0 = start[g];
  const Frame f = load_frame(centers, rot, g);
  const float* cloud = pc + (size_t)g * cloud_stride;
  for (int k = threadIdx.x; k < num_out; k += NT) {
    long long idx = 0;
    if (cnt > 0) {
      long long t;
      if (cnt > num_out) {
        long long m = (s0 + k) % cmax;   // floor modulo, as torch's %
        if (m < 0) m += cmax;
        t = m + 1;
      } else {
        t = r[(size_t)g * num_out + k] + 1;
      }
      // blk: the blocks whose inclusive prefix is below t
      int a = 0, b = nb;
      while (a < b) {
        const int mid = (a + b) >> 1;
        if ((long long)pre[mid] < t) a = mid + 1;
        else b = mid;
      }
      const int blk = min(a, nb - 1);
      // off: the positions of the block whose running prefix is below t
      long long need = t - (blk > 0 ? pre[blk - 1] : 0);
      int off = 0;
      if (need > 0) {
        off = BLK;
#pragma unroll
        for (int q = 0; q < WORDS_PER_BLK; ++q) {
          const uint32_t w = row[blk * WORDS_PER_BLK + q];
          const int c = __popc(w);
          if (need <= c) {
            off = q * 32 + nth_set_bit(w, (int)need);
            break;
          }
          need -= c;
        }
      }
      const long long at = (long long)blk * BLK + off;
      idx = at < p_pad ? at : p_pad - 1;
    }
    float x, y, z, fr[3];
    load_point(cloud, perm, P, (int)idx, x, y, z);
    to_frame(f, x, y, z, fr);
    float* o = out + ((size_t)g * num_out + k) * 3;
    o[0] = fr[0];
    o[1] = fr[1];
    o[2] = fr[2];
  }
}

static bool valid_sizes(int P, int p_pad, int G) {
  return G >= 1 && P >= 1 && p_pad >= P && p_pad % BLK == 0;
}

// pc: the cloud(s), float32, (P, 3) or (G, P, 3) with cloud_stride 0 or 3 P;
// perm (P,) int64; centers (G, 3), rot (G, 3, 3), box_lo, box_hi (G, 3)
// float32; bits (G, p_pad / 32), incl (G, p_pad / 128) int32 and count (G,)
// int64 are written
extern "C" int crop_count_launch(const float* pc, int cloud_stride, const long long* perm,
                                 int P, int p_pad, int G, const float* centers,
                                 const float* rot, const float* box_lo, const float* box_hi,
                                 uint32_t* bits, int* incl, long long* count, void* stream) {
  if (!valid_sizes(P, p_pad, G)) return (int)cudaErrorInvalidValue;
  crop_count_kernel<<<G, NT, 0, (cudaStream_t)stream>>>(pc, cloud_stride, perm, P, p_pad,
                                                        centers, rot, box_lo, box_hi, bits,
                                                        incl, count);
  return (int)cudaGetLastError();
}

// bits, incl, count from crop_count_launch; r (G, num_out) and start (G,)
// int64 from draws.crop_windows; out (G, num_out, 3) float32 is written
extern "C" int crop_select_launch(const float* pc, int cloud_stride, const long long* perm,
                                  int P, int p_pad, int G, const float* centers,
                                  const float* rot, const uint32_t* bits, const int* incl,
                                  const long long* count, const long long* r,
                                  const long long* start, int num_out, float* out,
                                  void* stream) {
  if (!valid_sizes(P, p_pad, G) || num_out < 0) return (int)cudaErrorInvalidValue;
  crop_select_kernel<<<G, NT, 0, (cudaStream_t)stream>>>(pc, cloud_stride, perm, P, p_pad,
                                                         centers, rot, bits, incl, count, r,
                                                         start, num_out, out);
  return (int)cudaGetLastError();
}
