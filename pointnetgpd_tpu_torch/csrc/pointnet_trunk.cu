// Fused, BN-folded PointNet trunk (kernel K2) for Hopper, sm_90a, on the
// tensor cores in 3xTF32.
//
// Replaces the TPU kernel pointnetgpd_tpu/ops/pointnet_trunk_pallas.py
// (_trunk_kernel via fused_trunk): the eval-mode shared MLP 3 -> 64 -> 128
// -> 1024 with BatchNorm folded into W and b, ReLU after layers 1 and 2,
// none after layer 3, then the max over the points. The (B, N, 1024)
// activation is never stored.
//
// What bounds it on the H100: tensor-core operations. Layers 2 and 3 are
// 64*128 + 128*1024 = 139,264 multiply-adds per point against 12 bytes of
// input. They run as wgmma TF32 products (m64n64k8, fp32 accumulate) in the
// 3xTF32 split: each operand v = big + small, big = tf32(v) and small =
// tf32(v - big), and the product is big*big + big*small + small*big, three
// passes at the card's TF32 rate. The error is about 2^-21 of each product,
// far inside the kernel's 1e-4 * (1 + |ref|) against fp32 (a single TF32
// pass would not be). Layer 1 (K = 3) runs on the CUDA cores in fp32.
//
// Design (the TPU kernel kept every weight resident in VMEM and ran one
// sample per program):
// - a block owns TILE_P = 128 points of one sample, two warpgroups of 64
//   rows; grid = (ceil(N / 128), B), so B = 64 samples of 500 points give
//   256 blocks for 132 SMs. A sample whose points span blocks meets in the
//   output through an atomic max on the float's order-preserving integer
//   form (atomic_max_float), exact and independent of block order; the
//   output is first set to -inf;
// - layers 1-2 run once per block. Each thread computes layer 1 directly
//   into its A fragments of layer 2 (split in registers with
//   cvt.rna.tf32.f32); layer 2's accumulator, after ReLU, is layer 3's A
//   fragment in registers: a thread holds channels 2q, 2q+1 of each group
//   of 8 where the A fragment wants q, q+4, so the host stores w3 with its
//   K axis permuted within each group of 8 as [0, 2, 4, 6, 1, 3, 5, 7]
//   (ops/pointnet_trunk.py tensor_core_weights);
// - the weights' big and small parts are split once on the host, K-major
//   (the conv weight's own (out, in) orientation) and already in the
//   shared-memory layout below, so each part of a block of rows is one
//   contiguous TMA bulk copy (cp.async.bulk, completion counted on an
//   mbarrier). w2 (64 KB as two parts) sits in shared memory; w3 (1 MB as
//   two parts) cannot, so it streams from L2 in 16 chunks of 64 output
//   channels through a 2-stage ring (64 KB a stage): one thread refills a
//   stage with chunk c + 2 as soon as both warpgroups are done with chunk
//   c. (Per-thread 16-byte cp.async copies of the same bytes cannot keep
//   up: with them the kernel took 0.176 ms at B, N = 64, 500 on an H100
//   80GB HBM3 at 700 W, against 0.085 ms with the bulk copies);
// - layer 3, per chunk: 16 k-steps x 3 passes of m64n64k8 per warpgroup;
//   the max over the block's points is taken in the accumulator's
//   registers (over a thread's two rows, then shuffles across the 8 row
//   groups of a warp, then the 8 warps through shared memory); the bias is
//   added after the max (max(x) + b = max(x + b) under rounding).
// - the output width H3 is a template parameter: 1024 for a whole trunk,
//   512 for one shard of a trunk whose conv3 rows are split over two
//   devices (tensor parallelism; the max over points is per channel, so a
//   shard's trunk is exactly this kernel on its rows). The 512 instance
//   streams its 8 chunks of w3 by the same ring; everything else is
//   shared.
// Shared memory uses the wgmma no-swizzle layout: 8-row x 16-byte core
// matrices, K-adjacent core matrices 128 bytes apart (the descriptor's
// leading byte offset), 8-row groups K/4 * 128 bytes apart (its stride byte
// offset).

#include <cuda_runtime.h>
#include <stdint.h>

#define C_MAX 8
#define H1 64
#define H2 128
#define NC 64                  // layer-3 output channels per chunk
#define TILE_P 128             // points per block: two warpgroups of 64
#define NT 256
#define N_WARPS (NT / 32)

#define W2_BYTES (H2 * H1 * 4)     // one tf32 part of w2
#define W3C_BYTES (NC * H2 * 4)    // one tf32 part of a w3 chunk
#define OFF_W2B 0
#define OFF_W2S (OFF_W2B + W2_BYTES)
#define OFF_W3 (OFF_W2S + W2_BYTES)            // 2 stages x (big, small)
#define OFF_RED (OFF_W3 + 4 * W3C_BYTES)          // 2 x [N_WARPS][NC]
#define OFF_W1 (OFF_RED + 2 * N_WARPS * NC * 4)
#define OFF_B1 (OFF_W1 + C_MAX * H1 * 4)
#define OFF_B2 (OFF_B1 + H1 * 4)
#define OFF_BAR (OFF_B2 + H2 * 4)                // mbarriers: stage 0, 1, w2
#define SMEM_BYTES (OFF_BAR + 3 * 8)

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
// the barrier's phase completes when `bytes` have landed
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
// TMA bulk copy of `bytes` contiguous bytes into shared memory, counted on `bar`
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
// one thread: w3 chunk c (big and small parts, each W3C_BYTES in core-matrix
// order) into the stage at `stage`
__device__ __forceinline__ void load_chunk(uint32_t stage, uint32_t bar, const float* w3b,
                                           const float* w3s, int c) {
  mbar_expect(bar, 2 * W3C_BYTES);
  bulk_copy(stage, w3b + (size_t)c * NC * H2, W3C_BYTES, bar);
  bulk_copy(stage + W3C_BYTES, w3s + (size_t)c * NC * H2, W3C_BYTES, bar);
}

// wgmma shared-memory matrix descriptor, no swizzle: start address, leading
// byte offset 128 (the next core matrix along K), stride byte offset `sbo`
// (the next 8-row group).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32);
}

__device__ __forceinline__ void split_tf32(float v, uint32_t& big, uint32_t& small) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(big) : "f"(v));
  const float rest = v - __uint_as_float(big);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(small) : "f"(rest));
}

// d (64 x 64, fp32) += a (64 x 8, tf32, registers) * b (8 x 64, tf32,
// shared memory, K-major), for the 128 threads of a warpgroup.
__device__ __forceinline__ void wgmma_m64n64k8(float (&d)[32], const uint32_t (&a)[4],
                                               uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait_all() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }

// Pin registers that an in-flight wgmma reads or writes to this point of
// the program, so the compiler neither reads an accumulator before the wait
// nor reuses an A fragment's register while the product may still read it.
__device__ __forceinline__ void pin(float (&r)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int S>
__device__ __forceinline__ void pin(uint32_t (&r)[S][4]) {
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[s][e])::"memory");
}

// max into *addr, exact for any order of callers: non-negative floats
// order as signed ints, negative ones in reverse as unsigned ints
__device__ __forceinline__ void atomic_max_float(float* addr, float v) {
  if (__float_as_int(v) >= 0)
    atomicMax(reinterpret_cast<int*>(addr), __float_as_int(v));
  else
    atomicMin(reinterpret_cast<unsigned*>(addr), __float_as_uint(v));
}

__global__ void fill_neg_inf(float* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = __uint_as_float(0xff800000u);
}

template <int H3>
__global__ void __launch_bounds__(NT, 1)
pointnet_trunk_kernel(const float* __restrict__ x, int N, int C,
                      const float* __restrict__ w1, const float* __restrict__ b1,
                      const float* __restrict__ w2b, const float* __restrict__ w2s,
                      const float* __restrict__ b2,
                      const float* __restrict__ w3b, const float* __restrict__ w3s,
                      const float* __restrict__ b3, float* __restrict__ out) {
  constexpr int N_CHUNKS = H3 / NC;
  static_assert(N_CHUNKS >= 2, "the ring preloads two chunks");
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sbase = (uint32_t)__cvta_generic_to_shared(smem);
  float* red = reinterpret_cast<float*>(smem + OFF_RED);  // [2][N_WARPS][NC]
  float* w1s = reinterpret_cast<float*>(smem + OFF_W1);   // [C][H1]
  float* b1s = reinterpret_cast<float*>(smem + OFF_B1);
  float* b2s = reinterpret_cast<float*>(smem + OFF_B2);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int b = blockIdx.y;
  // a warpgroup's 64 rows: warp w of the block holds rows 16w + g, + 8
  const int row0 = blockIdx.x * TILE_P + 16 * warp + g, row1 = row0 + 8;

  const uint32_t bar_w2 = sbase + OFF_BAR + 16;
  if (tid == 0) {
    mbar_init(sbase + OFF_BAR, 1);
    mbar_init(sbase + OFF_BAR + 8, 1);
    mbar_init(bar_w2, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // w2 and w3's first two chunks start copying; w1, b1, b2 are small
  if (tid == 0) {
    mbar_expect(bar_w2, 2 * W2_BYTES);
    bulk_copy(sbase + OFF_W2B, w2b, W2_BYTES, bar_w2);
    bulk_copy(sbase + OFF_W2S, w2s, W2_BYTES, bar_w2);
    load_chunk(sbase + OFF_W3, sbase + OFF_BAR, w3b, w3s, 0);
    load_chunk(sbase + OFF_W3 + 2 * W3C_BYTES, sbase + OFF_BAR + 8, w3b, w3s, 1);
  }
  for (int i = tid; i < C * H1; i += NT) w1s[i] = w1[i];
  for (int i = tid; i < H1; i += NT) b1s[i] = b1[i];
  for (int i = tid; i < H2; i += NT) b2s[i] = b2[i];
  __syncthreads();

  // layer 1 (fp32, CUDA cores) straight into layer 2's A fragments:
  // a[s] = rows (g, g + 8) x columns (8s + q, 8s + q + 4) as a0..a3 =
  // (g, q), (g + 8, q), (g, q + 4), (g + 8, q + 4)
  float xr0[C_MAX], xr1[C_MAX];
  const float* xb = x + (size_t)b * N * C;
#pragma unroll
  for (int c = 0; c < C_MAX; ++c) {
    xr0[c] = (c < C && row0 < N) ? xb[(size_t)row0 * C + c] : 0.f;
    xr1[c] = (c < C && row1 < N) ? xb[(size_t)row1 * C + c] : 0.f;
  }
  uint32_t a2b[H1 / 8][4], a2s[H1 / 8][4];
#pragma unroll
  for (int s = 0; s < H1 / 8; ++s) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = 8 * s + q + 4 * j;
      float h0 = b1s[col], h1 = b1s[col];
#pragma unroll
      for (int c = 0; c < C_MAX; ++c) {
        if (c < C) {
          const float w = w1s[c * H1 + col];
          h0 = fmaf(xr0[c], w, h0);
          h1 = fmaf(xr1[c], w, h1);
        }
      }
      split_tf32(fmaxf(h0, 0.f), a2b[s][2 * j], a2s[s][2 * j]);
      split_tf32(fmaxf(h1, 0.f), a2b[s][2 * j + 1], a2s[s][2 * j + 1]);
    }
  }

  mbar_wait(bar_w2, 0);

  // layer 2: two n64 halves of the 128 channels, accumulators start at b2
  float acc2[2][32];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float c0 = b2s[64 * h + 8 * i + 2 * q], c1 = b2s[64 * h + 8 * i + 2 * q + 1];
      acc2[h][4 * i + 0] = c0;
      acc2[h][4 * i + 1] = c1;
      acc2[h][4 * i + 2] = c0;
      acc2[h][4 * i + 3] = c1;
    }
  pin(acc2[0]);
  pin(acc2[1]);
  wgmma_fence();
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int s = 0; s < H1 / 8; ++s) {
      const uint32_t wb = sbase + OFF_W2B + h * 8 * (H1 / 4) * 128 + s * 256;
      const uint64_t big = smem_desc(wb, (H1 / 4) * 128);
      const uint64_t small = smem_desc(wb + W2_BYTES, (H1 / 4) * 128);
      wgmma_m64n64k8(acc2[h], a2s[s], big);
      wgmma_m64n64k8(acc2[h], a2b[s], small);
      wgmma_m64n64k8(acc2[h], a2b[s], big);
    }
  wgmma_commit();
  wgmma_wait_all();
  pin(acc2[0]);
  pin(acc2[1]);
  pin(a2b);
  pin(a2s);

  // ReLU(layer 2) as layer 3's A fragments. The accumulator holds rows
  // (g, g + 8) x channels (64h + 8i + 2q, + 1) in d[4i .. 4i + 3]; k-step
  // kk = 8h + i takes channel 2q as its column q and 2q + 1 as q + 4.
  uint32_t a3b[H2 / 8][4], a3s[H2 / 8][4];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int kk = 8 * h + i;
      split_tf32(fmaxf(acc2[h][4 * i + 0], 0.f), a3b[kk][0], a3s[kk][0]);
      split_tf32(fmaxf(acc2[h][4 * i + 2], 0.f), a3b[kk][1], a3s[kk][1]);
      split_tf32(fmaxf(acc2[h][4 * i + 1], 0.f), a3b[kk][2], a3s[kk][2]);
      split_tf32(fmaxf(acc2[h][4 * i + 3], 0.f), a3b[kk][3], a3s[kk][3]);
    }
  const bool v0 = row0 < N, v1 = row1 < N;
  const float neg_inf = __uint_as_float(0xff800000u);
  float* out_b = out + (size_t)b * H3;

#pragma unroll 1
  for (int c = 0; c < N_CHUNKS; ++c) {
    const int st = c & 1;
    const uint32_t wb = sbase + OFF_W3 + st * 2 * W3C_BYTES;
    mbar_wait(sbase + OFF_BAR + 8 * st, (c >> 1) & 1);  // chunk c has landed
    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    pin(acc);
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < H2 / 8; ++s) {
      const uint64_t big = smem_desc(wb + s * 256, (H2 / 4) * 128);
      const uint64_t small = smem_desc(wb + W3C_BYTES + s * 256, (H2 / 4) * 128);
      wgmma_m64n64k8(acc, a3s[s], big);
      wgmma_m64n64k8(acc, a3b[s], small);
      wgmma_m64n64k8(acc, a3b[s], big);
    }
    wgmma_commit();
    wgmma_wait_all();
    pin(acc);
    pin(a3b);
    pin(a3s);

    // max over the block's valid rows: a thread's two rows, the warp's 8
    // row groups (lanes 4 apart), then the 8 warps
    float m[16];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      m[2 * i] = fmaxf(v0 ? acc[4 * i] : neg_inf, v1 ? acc[4 * i + 2] : neg_inf);
      m[2 * i + 1] = fmaxf(v0 ? acc[4 * i + 1] : neg_inf, v1 ? acc[4 * i + 3] : neg_inf);
    }
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int o = 4; o < 32; o <<= 1)
        m[j] = fmaxf(m[j], __shfl_xor_sync(0xffffffffu, m[j], o));
    float* red_c = red + st * N_WARPS * NC;
    if (g == 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        red_c[warp * NC + 8 * i + 2 * q] = m[2 * i];
        red_c[warp * NC + 8 * i + 2 * q + 1] = m[2 * i + 1];
      }
    }
    // every warp's maxima are written and every warpgroup is done reading
    // the stage: it takes chunk c + 2
    __syncthreads();
    if (tid == 0 && c + 2 < N_CHUNKS)
      load_chunk(wb, sbase + OFF_BAR + 8 * st, w3b, w3s, c + 2);
    if (tid < NC) {
      float v = red_c[tid];
#pragma unroll
      for (int w = 1; w < N_WARPS; ++w) v = fmaxf(v, red_c[w * NC + tid]);
      atomic_max_float(out_b + c * NC + tid, v + b3[c * NC + tid]);
    }
  }
}

template <int H3>
static int launch(const float* x, int B, int N, int C, const float* w1, const float* b1,
                  const float* w2b, const float* w2s, const float* b2, const float* w3b,
                  const float* w3s, const float* b3, float* out, cudaStream_t st) {
  // the dynamic shared-memory opt-in is a property of the function on each
  // device
  static bool smem_set[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!smem_set[dev]) {
    err = cudaFuncSetAttribute(pointnet_trunk_kernel<H3>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    smem_set[dev] = true;
  }
  fill_neg_inf<<<(B * H3 + 255) / 256, 256, 0, st>>>(out, B * H3);
  dim3 grid((N + TILE_P - 1) / TILE_P, B);
  pointnet_trunk_kernel<H3><<<grid, NT, SMEM_BYTES, st>>>(x, N, C, w1, b1, w2b, w2s, b2,
                                                          w3b, w3s, b3, out);
  return (int)cudaGetLastError();
}

// H3: the output width, 1024 or 512
extern "C" int pointnet_trunk_launch(const float* x, int B, int N, int C,
                                     const float* w1, const float* b1,
                                     const float* w2b, const float* w2s,
                                     const float* b2, const float* w3b,
                                     const float* w3s, const float* b3,
                                     float* out, int H3, void* stream) {
  if (C < 1 || C > C_MAX || N < 1 || B < 1 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (H3 == 1024) return launch<1024>(x, B, N, C, w1, b1, w2b, w2s, b2, w3b, w3s, b3, out, st);
  if (H3 == 512) return launch<512>(x, B, N, C, w1, b1, w2b, w2s, b2, w3b, w3s, b3, out, st);
  return (int)cudaErrorInvalidValue;
}
