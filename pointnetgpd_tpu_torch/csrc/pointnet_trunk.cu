// Fused, BN-folded PointNet trunk (kernel K2) for Hopper, sm_90a.
//
// Replaces the TPU kernel pointnetgpd_tpu/ops/pointnet_trunk_pallas.py
// (_trunk_kernel via fused_trunk): the eval-mode shared MLP 3 -> 64 -> 128
// -> 1024 with BatchNorm folded into W and b, ReLU after layers 1 and 2,
// none after layer 3, then the max over the points. The (B, N, 1024)
// activation is never stored.
//
// What bounds it on the H100: fp32 operations on the CUDA cores. Per point
// the MLP is 3*64 + 64*128 + 128*1024 = 139,456 multiply-adds against 12
// bytes of input, so bytes are no limit; the rate is the card's fp32 FMA
// rate (no tensor cores: TF32 would lose the fp32 parity the JAX package
// keeps on the CPU). The next limit is shared-memory bandwidth: an FMA
// whose operands both come from shared memory runs at a quarter of the FMA
// rate, so the layers are register-tiled.
//
// Design: the TPU kernel keeps all weights resident in VMEM, one sample per
// program. w3 alone is 512 KB in fp32, more than an SM's 227 KB of shared
// memory, so here
// - grid = (B, 1024 / TILE_C): a block owns one sample and one tile of
//   TILE_C = 256 output channels, so its max needs no atomics;
// - the block keeps w1, w2 and its 128 x 256 column slice of w3 in dynamic
//   shared memory (213 KB with the per-chunk activations) and walks the
//   sample's points in chunks of NP = 64: h1 and h2 of the chunk go to
//   shared memory, recomputed by each of the 4 channel tiles (25% extra
//   FMAs);
// - layer 3: each thread owns 4 channels x 16 points (64 accumulators in
//   registers); per step of 4 input channels it reads 4 float4 weight rows
//   and 16 float4 activation broadcasts for 256 FMAs. Layer 2 is tiled the
//   same way (4 channels x 8 points). Each thread keeps a running max of
//   its 4 channels; the 4 point groups are reduced through shared memory
//   at the end.

#include <cuda_runtime.h>

#define C_MAX 8
#define H1 64
#define H2 128
#define H3 1024
#define TILE_C 256
#define NP 64
#define NT 256

static constexpr size_t kSmemFloats =
    H2 * TILE_C +                 // w3 column slice
    H1 * H2 +                     // w2
    NP * H2 + NP * H1 +           // h2, h1 of one chunk
    C_MAX * H1 + H1 + H2 +        // w1, b1, b2
    NP * C_MAX;                   // x of one chunk

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void fma4(float (&acc)[4], float h, const float4& w) {
  acc[0] = fmaf(h, w.x, acc[0]);
  acc[1] = fmaf(h, w.y, acc[1]);
  acc[2] = fmaf(h, w.z, acc[2]);
  acc[3] = fmaf(h, w.w, acc[3]);
}

__global__ void __launch_bounds__(NT)
pointnet_trunk_kernel(const float* __restrict__ x, int N, int C,
                      const float* __restrict__ w1, const float* __restrict__ b1,
                      const float* __restrict__ w2, const float* __restrict__ b2,
                      const float* __restrict__ w3, const float* __restrict__ b3,
                      float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  float* w3s = smem;                    // [H2][TILE_C]
  float* w2s = w3s + H2 * TILE_C;       // [H1][H2]
  float* h2s = w2s + H1 * H2;           // [NP][H2]
  float* h1s = h2s + NP * H2;           // [NP][H1]
  float* w1s = h1s + NP * H1;           // [C_MAX][H1]
  float* b1s = w1s + C_MAX * H1;        // [H1]
  float* b2s = b1s + H1;                // [H2]
  float* xs = b2s + H2;                 // [NP][C_MAX]

  const int b = blockIdx.x;
  const int c0 = blockIdx.y * TILE_C;
  const int t = threadIdx.x;

  for (int i = t; i < C * H1; i += NT) w1s[i] = w1[i];
  for (int i = t; i < H1; i += NT) b1s[i] = b1[i];
  for (int i = t; i < H2; i += NT) b2s[i] = b2[i];
  for (int i = t; i < H1 * H2 / 4; i += NT)
    reinterpret_cast<float4*>(w2s)[i] = ld4(w2 + 4 * i);
  for (int i = t; i < H2 * TILE_C / 4; i += NT) {
    const int k = i / (TILE_C / 4), c4 = i % (TILE_C / 4);
    reinterpret_cast<float4*>(w3s)[i] = ld4(w3 + (size_t)k * H3 + c0 + 4 * c4);
  }

  // layer-3 tile: channels 4*cg .. 4*cg+3 of the tile, points 16*pg3 ..
  const int cg = t % (TILE_C / 4), pg3 = t / (TILE_C / 4);
  // layer-2 tile: channels 4*j4 .. 4*j4+3, points 8*pg2 ..
  const int j4 = t % (H2 / 4), pg2 = t / (H2 / 4);
  const float4 bias3 = ld4(b3 + c0 + 4 * cg);
  const float neg_inf = __int_as_float(0xff800000);
  float best[4] = {neg_inf, neg_inf, neg_inf, neg_inf};
  const float* xb = x + (size_t)b * N * C;

  for (int p0 = 0; p0 < N; p0 += NP) {
    const int np = min(NP, N - p0);
    __syncthreads();  // previous chunk done with xs / h1s / h2s
    for (int i = t; i < NP * C; i += NT) {
      const int p = i / C, c = i % C;
      xs[p * C_MAX + c] = p < np ? xb[(size_t)(p0 + p) * C + c] : 0.f;
    }
    __syncthreads();
    for (int i = t; i < NP * H1; i += NT) {
      const int p = i / H1, j = i % H1;
      float v = b1s[j];
      for (int c = 0; c < C; ++c) v = fmaf(xs[p * C_MAX + c], w1s[c * H1 + j], v);
      h1s[i] = fmaxf(v, 0.f);
    }
    __syncthreads();
    {
      float acc[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][q] = b2s[4 * j4 + q];
#pragma unroll 2
      for (int k = 0; k < H1; k += 4) {
        const float4 wa = ld4(w2s + (k + 0) * H2 + 4 * j4);
        const float4 wb = ld4(w2s + (k + 1) * H2 + 4 * j4);
        const float4 wc = ld4(w2s + (k + 2) * H2 + 4 * j4);
        const float4 wd = ld4(w2s + (k + 3) * H2 + 4 * j4);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float4 h = ld4(h1s + (pg2 * 8 + i) * H1 + k);
          fma4(acc[i], h.x, wa);
          fma4(acc[i], h.y, wb);
          fma4(acc[i], h.z, wc);
          fma4(acc[i], h.w, wd);
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
        *reinterpret_cast<float4*>(h2s + (pg2 * 8 + i) * H2 + 4 * j4) =
            make_float4(fmaxf(acc[i][0], 0.f), fmaxf(acc[i][1], 0.f),
                        fmaxf(acc[i][2], 0.f), fmaxf(acc[i][3], 0.f));
    }
    __syncthreads();
    {
      float acc[16][4];
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        acc[i][0] = bias3.x; acc[i][1] = bias3.y;
        acc[i][2] = bias3.z; acc[i][3] = bias3.w;
      }
#pragma unroll 1
      for (int k = 0; k < H2; k += 4) {
        const float4 wa = ld4(w3s + (k + 0) * TILE_C + 4 * cg);
        const float4 wb = ld4(w3s + (k + 1) * TILE_C + 4 * cg);
        const float4 wc = ld4(w3s + (k + 2) * TILE_C + 4 * cg);
        const float4 wd = ld4(w3s + (k + 3) * TILE_C + 4 * cg);
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const float4 h = ld4(h2s + (pg3 * 16 + i) * H2 + k);
          fma4(acc[i], h.x, wa);
          fma4(acc[i], h.y, wb);
          fma4(acc[i], h.z, wc);
          fma4(acc[i], h.w, wd);
        }
      }
#pragma unroll
      for (int i = 0; i < 16; ++i)
        if (pg3 * 16 + i < np)
#pragma unroll
          for (int q = 0; q < 4; ++q) best[q] = fmaxf(best[q], acc[i][q]);
    }
  }
  __syncthreads();
  float* red = h2s;  // [4 point groups][TILE_C]
#pragma unroll
  for (int q = 0; q < 4; ++q) red[pg3 * TILE_C + 4 * cg + q] = best[q];
  __syncthreads();
  const float m = fmaxf(fmaxf(red[t], red[TILE_C + t]),
                        fmaxf(red[2 * TILE_C + t], red[3 * TILE_C + t]));
  out[(size_t)b * H3 + c0 + t] = m;
}

extern "C" int pointnet_trunk_launch(const float* x, int B, int N, int C,
                                     const float* w1, const float* b1,
                                     const float* w2, const float* b2,
                                     const float* w3, const float* b3,
                                     float* out, void* stream) {
  if (C < 1 || C > C_MAX || N < 1 || B < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = kSmemFloats * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      pointnet_trunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B, H3 / TILE_C);
  pointnet_trunk_kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(
      x, N, C, w1, b1, w2, b2, w3, b3, out);
  return (int)cudaGetLastError();
}
