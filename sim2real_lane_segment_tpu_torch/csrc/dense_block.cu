// FC-DenseNet inference dense block for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel K4 of the JAX package:
//   sim2real_lane_segment_tpu/models/tiramisu_pallas.py
//   _packed_block_kernel / _dense_block_kernel, launched by
//   fused_dense_block_cm (pallas_call at :701 and :739).
//
// What it computes, per dense layer j of a block (feature buffer F of
// c_total channels, NCHW per image):
//   a = relu(F[:c_j] * scale + shift) rounded to the compute type,
//       zero outside the image (the conv's zero padding applies to a,
//       not to F);
//   F[c_j:c_j+g] = T(conv3x3(a, W) + bias), summed in f32.
// The TransitionDown epilogue is the same product with one tap and
// N = c_total outputs, rounded as T(T(sum) + T(bias)).  The classifier
// epilogue takes the per-pixel L2 norm of F in f32, rounds F/norm to T,
// and writes (Wc . F/norm + b) * (1/T_softmax) as f32 logits, 8 rows.
//
// The bf16 dense layers with growth 12 or 16 (every FCDenseNet57, 67 and
// 103 site) run on the tensor cores: dense3x3_mma_kernel<G>, the
// shared 3x3 forward body of dense3x3_mma.cuh (mma.sync m16n8k16 over
// [halo pixel][channel] tiles, a 12 x 16 pixel tile and 32-channel chunks,
// the channel loop split across a thread-block cluster at small planes)
// with serving's epilogue T(D + bias); its note is in that header.  The
// bf16 TransitionDown (td_fwd_tma_kernel, td_fwd_kernel) runs on the tensor cores too; the
// kernel and its note are in td_fwd_mma.cuh, which the training forward
// shares.
//
// The classifier tail (classifier_kernel) does 18 operations per feature
// it reads (the square, the scale and 8 multiply-adds), 9 per bf16 byte, so
// it is bound by bytes: at FCDenseNet67, B=64, it must read the last
// block's 708 MB once.  It reads each feature from device memory once (a
// pixel tile's channels staged in shared memory for the norm and the
// product); the bf16 product runs on the tensor cores (mma.sync), float32
// on the CUDA cores.  Its note is above the kernel.
//
// The CUDA-core conv kernel below (conv_bnrelu_kernel) serves float32, the
// parity control (TF32 would not hold the TransitionDown to 1e-5), and
// other growth rates (the test-only tiny net's 4).
// What bounds it: at FCDenseNet67, 120x160, the 55 dense layers are 13.7
// GFLOP per frame; one layer launch reads c_j channels and writes 16, 144
// operations per bf16 byte moved, below the H100's ~295 bf16 tensor-core
// operations per byte: a tensor-core layer launch is bound by bytes.  This
// kernel computes on the CUDA cores in f32 (67 TFLOP/s peak, not 989), so
// it is bound by its FMA issue rate.  Its design is the simple,
// correct first kernel: each block owns a 16x16 pixel tile and 16 output
// channels of one image; it stages 16 input channels at a time (with a
// one-pixel halo) into shared memory, applying BN, ReLU, rounding and the
// image mask once per staged value, so the nine taps and sixteen outputs
// reuse each staged value 144 times from shared memory.  Each thread keeps
// its pixel's 16 f32 sums in registers.  The feature buffer stays in
// device memory between layers (a layer reads channels [0, c_j) and writes
// the disjoint range [c_j, c_j+g) of the same buffer).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>

#include "bnrelu_mma.cuh"
#include "dense3x3_mma.cuh"
#include "td_fwd_mma.cuh"

namespace {

constexpr int TH = 16;       // output tile rows
constexpr int TW = 16;       // output tile columns
constexpr int KC = 16;       // input channels staged per step
constexpr int NB = 16;       // output channels per block
constexpr int THREADS = TH * TW;

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f<T>(from_f<T>(v));
}

// One dense layer (TAPS == 9, 3x3 conv, padding 1) or the TransitionDown
// 1x1 conv (TAPS == 1).
//   in:   [B, *, H, W], image b at in + b * in_bstride; channels [0, K) read
//   wt:   [K][TAPS][N] in T (tap = ky * 3 + kx)
//   out:  [B, *, H, W], image b at out + b * out_bstride; channels [0, N)
// round_first = 0: out = T(sum + bias)        (dense layer)
// round_first = 1: out = T(T(sum) + T(bias))  (TransitionDown)
template <typename T, int TAPS>
__global__ void __launch_bounds__(THREADS)
conv_bnrelu_kernel(const T* in, long long in_bstride, int K, int H, int W,
                   const float* __restrict__ scale,
                   const float* __restrict__ shift,
                   const T* __restrict__ wt, const float* __restrict__ bias,
                   int N, T* out, long long out_bstride, int round_first) {
  constexpr int R = TAPS == 9 ? 1 : 0;
  constexpr int SH = TH + 2 * R;
  constexpr int SW = TW + 2 * R;
  __shared__ float s_in[KC][SH][SW];
  __shared__ __align__(16) float s_w[KC][TAPS][NB];

  const int tiles_x = (W + TW - 1) / TW;
  const int ty0 = (blockIdx.x / tiles_x) * TH;
  const int tx0 = (blockIdx.x % tiles_x) * TW;
  const int n0 = blockIdx.y * NB;
  const long long hw = (long long)H * W;
  const T* inb = in + blockIdx.z * in_bstride;
  const int tid = threadIdx.x;
  const int py = tid / TW;
  const int px = tid % TW;

  float acc[NB];
#pragma unroll
  for (int o = 0; o < NB; ++o) acc[o] = 0.f;

  for (int k0 = 0; k0 < K; k0 += KC) {
    const int kc = min(KC, K - k0);
    for (int i = tid; i < KC * SH * SW; i += THREADS) {
      const int c = i / (SH * SW);
      const int r = i - c * (SH * SW);
      const int y = r / SW;
      const int x = r - y * SW;
      const int gy = ty0 + y - R;
      const int gx = tx0 + x - R;
      float v = 0.f;
      if (c < kc && gy >= 0 && gy < H && gx >= 0 && gx < W) {
        const int k = k0 + c;
        const float f = to_f<T>(inb[k * hw + (long long)gy * W + gx]);
        // separate multiply and add (no fma contraction), as the plain
        // PyTorch version computes it
        v = round_to<T>(fmaxf(__fadd_rn(__fmul_rn(f, scale[k]), shift[k]), 0.f));
      }
      s_in[c][y][x] = v;
    }
    for (int i = tid; i < KC * TAPS * NB; i += THREADS) {
      const int c = i / (TAPS * NB);
      const int r = i - c * (TAPS * NB);
      const int t = r / NB;
      const int o = r - t * NB;
      float v = 0.f;
      if (c < kc && n0 + o < N)
        v = to_f<T>(wt[((long long)(k0 + c) * TAPS + t) * N + n0 + o]);
      s_w[c][t][o] = v;
    }
    __syncthreads();
    for (int c = 0; c < kc; ++c) {
#pragma unroll
      for (int t = 0; t < TAPS; ++t) {
        const int dy = TAPS == 9 ? t / 3 : 0;
        const int dx = TAPS == 9 ? t % 3 : 0;
        const float a = s_in[c][py + dy][px + dx];
#pragma unroll
        for (int o = 0; o < NB; ++o) acc[o] = fmaf(a, s_w[c][t][o], acc[o]);
      }
    }
    __syncthreads();
  }

  const int gy = ty0 + py;
  const int gx = tx0 + px;
  if (gy >= H || gx >= W) return;
  T* outb = out + blockIdx.z * out_bstride + (long long)gy * W + gx;
#pragma unroll
  for (int o = 0; o < NB; ++o) {
    const int n = n0 + o;
    if (n < N) {
      const float y = round_first
          ? __fadd_rn(round_to<T>(acc[o]), round_to<T>(bias[n]))
          : __fadd_rn(acc[o], bias[n]);
      outb[n * hw] = from_f<T>(y);
    }
  }
}

// Classifier tail: one pass over the features.
//   in:  [B, C, hw] features in T, image b at in + b * in_bstride
//   wc:  [8][C] in T;  cb: [8] f32;  out: [B, 8, hw] f32
// A block owns CLS_PX = 64 consecutive pixels of one image and stages all
// their channels once into its shared-memory tile [Cp][64] (Cp = C rounded
// up to 16, the rows past C zero): 16-byte cp.async where every channel row
// starts on 16 bytes, so one warp instruction copies four whole 128-byte
// rows (bf16), element loads otherwise, pixels past hw zero, in CLS_GROUPS
// groups of rows.  Warp w takes pixels 16w .. 16w + 15:
//   1. the f32 squares of each group as it lands (a block barrier a
//      group), summed per pixel, and inv = 1 / max(sqrt(n2), 1e-12);
//   2. the 8-row product of T(f * inv) with the weights:
//      bfloat16 on the tensor cores, mma.sync m16n8k16 with the warp's 16
//        pixels as M, the 8 rows as N and 16 channels a step as K, f32
//        sums.  A comes from the tile by ldmatrix.trans (the 16-byte chunk
//        c of row k stored at c ^ (k % 8), so the eight rows of a matrix
//        fall in distinct banks), is scaled and rounded in registers (one
//        cvt a pair), and the norm reads the same fragments; B is read
//        from the 4.6 KB of weights in device memory (L1 hits), the next
//        step's in flight during this one;
//      float32 (the parity control) on the CUDA cores: lane l takes pixel
//        l % 16 and every other channel from l / 16, the two halves added
//        by one shuffle, the weights staged once per block as [Cp][8];
//   3. (u + b) * (1 / T_softmax) for the warp's pixels.
// The sums are taken in a fixed order, so a run repeats its bits.  Whole
// 128-byte rows matter: a tile per warp, read in 32-byte rows, ran slower
// on an H100, and so did 128-pixel blocks of eight warps.
constexpr int CLS_WPX = 16;                   // pixels a warp
constexpr int CLS_WARPS = 4;
constexpr int CLS_PX = CLS_WPX * CLS_WARPS;   // pixels a block
constexpr int CLS_THREADS = 32 * CLS_WARPS;
constexpr int CLS_GROUPS = 4;
constexpr int CLS_SMEM_MAX = 232448;  // 227 KB, the most a block may use

__host__ __device__ __forceinline__ int cls_rows(int C) { return (C + 15) / 16 * 16; }

// dynamic shared memory of one block: the tile, and the float32 weights
// (kernels/dense_block.classifier_smem states it)
__host__ __device__ __forceinline__ long long classifier_smem(int C, int itemsize) {
  const long long cp = cls_rows(C);
  return cp * CLS_PX * itemsize + (itemsize == 2 ? 0 : cp * 8 * 4);
}

// element (channel k, pixel m) of the block's tile [Cp][CLS_PX]: bf16 rows
// hold 8 chunks of 16 bytes, chunk c at c ^ (k % 8); float32 rows swap
// neighbouring 16-element quarters on odd k (so each access pattern below
// hits distinct banks)
template <bool BF>
__device__ __forceinline__ int cls_off(int k, int m) {
  return BF ? k * CLS_PX + (((m >> 3) ^ (k & 7)) << 3) + (m & 7)
            : k * CLS_PX + (m ^ ((k & 1) << 4));
}

// cp.async.wait_group with a run-time count below CLS_GROUPS
__device__ __forceinline__ void cls_wait(int pending) {
  switch (pending) {
    case 0: s2r_mma::cp_async_wait<0>(); break;
    case 1: s2r_mma::cp_async_wait<1>(); break;
    case 2: s2r_mma::cp_async_wait<2>(); break;
    default: s2r_mma::cp_async_wait<3>(); break;
  }
}
static_assert(CLS_GROUPS == 4, "cls_wait covers 4 groups");

// weights k, k + 1 of a bf16 row of C as one word (lo: k), zero past C;
// even: C is even, so the pair is one aligned word
__device__ __forceinline__ uint32_t cls_wpair(const unsigned short* row, int k, int C,
                                              bool even) {
  if (k + 1 < C)
    return even ? __ldg(reinterpret_cast<const unsigned int*>(row + k))
                : (uint32_t)__ldg(row + k) | ((uint32_t)__ldg(row + k + 1) << 16);
  return k < C ? (uint32_t)__ldg(row + k) : 0u;
}

__device__ __forceinline__ float cls_logit(float u, float b, float inv_temp) {
  return __fmul_rn(__fadd_rn(u, b), inv_temp);
}

template <typename T>
__global__ void __launch_bounds__(CLS_THREADS)
classifier_kernel(const T* __restrict__ in, long long in_bstride, int C,
                  long long hw, const T* __restrict__ wc,
                  const float* __restrict__ cb, float inv_temp,
                  float* __restrict__ out, int vec) {
  constexpr bool BF = sizeof(T) == 2;
  constexpr int EPC = 16 / sizeof(T);     // elements per 16-byte piece
  constexpr int PPR = CLS_PX / EPC;       // pieces per tile row
  extern __shared__ __align__(16) unsigned char cls_smem[];
  const int Cp = cls_rows(C);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  T* tile = reinterpret_cast<T*>(cls_smem);
  unsigned char* wsm = cls_smem + (size_t)Cp * CLS_PX * sizeof(T);
  const long long pb = (long long)blockIdx.x * CLS_PX;   // the block's pixels
  const int mw = warp * CLS_WPX;                         // the warp's, in the tile
  const bool active = pb + mw < hw;
  const T* img = in + (long long)blockIdx.y * in_bstride + pb;
  const int gk = (Cp / 16 + CLS_GROUPS - 1) / CLS_GROUPS * 16;  // rows a group

  // the block's tile, in CLS_GROUPS groups of rows; a warp instruction
  // copies whole 128-byte (bf16) rows
  for (int g = 0; g < CLS_GROUPS; ++g) {
    const int k0 = min(Cp, g * gk), k1 = min(Cp, k0 + gk);
    if (vec) {
      for (int q = threadIdx.x; q < (k1 - k0) * PPR; q += CLS_THREADS) {
        const int k = k0 + q / PPR;
        const int e = (q % PPR) * EPC;
        const bool ok = k < C && pb + e < hw;
        s2r_mma::cp_async16(tile + cls_off<BF>(k, e), ok ? img + k * hw + e : in,
                            ok ? 16 : 0);
      }
    } else {
      for (int q = threadIdx.x; q < (k1 - k0) * CLS_PX; q += CLS_THREADS) {
        const int k = k0 + q / CLS_PX;
        const int m = q % CLS_PX;
        tile[cls_off<BF>(k, m)] = k < C && pb + m < hw ? img[k * hw + m] : from_f<T>(0.f);
      }
    }
    s2r_mma::cp_async_commit();
  }
  // float32: the weights, zero past C, while the tile lands
  if constexpr (!BF) {
    float* w = reinterpret_cast<float*>(wsm);
    for (int i = threadIdx.x; i < 8 * Cp; i += CLS_THREADS) {
      const int n = i / Cp, k = i % Cp;
      w[k * 8 + n] = k < C ? to_f<T>(wc[n * C + k]) : 0.f;
    }
  }

  float* ob = out + (long long)blockIdx.y * 8 * hw + pb + mw;
  if constexpr (BF) {
    // lane (g, t): pixels g and g + 8, channels 2t, 2t + 1 (+ 8) of a step
    const int g = lane >> 2, t = lane & 3;
    // the row this lane addresses for ldmatrix: matrix j = lane / 8 holds
    // channels +8 (j / 2) and pixels 8 (j % 2) of a step
    const int kl = 8 * (lane >> 4) + (lane & 7), ml = mw + 8 * ((lane >> 3) & 1);
    float n0 = 0.f, n1 = 0.f;
    for (int grp = 0; grp < CLS_GROUPS; ++grp) {
      cls_wait(CLS_GROUPS - 1 - grp);
      __syncthreads();
      if (!active) continue;
      const int k1 = min(Cp, (grp + 1) * gk);
      for (int k0 = min(Cp, grp * gk); k0 < k1; k0 += 16) {
        uint32_t a[4];
        s2r_mma::ldsm_x4_t(a, s2r_mma::smem_u32(tile + cls_off<true>(k0 + kl, ml)));
        // a0, a2: pixel g; a1, a3: pixel g + 8
#pragma unroll
        for (int r = 0; r < 4; r += 2) {
          n0 = fmaf(s2r_mma::lo_f(a[r]), s2r_mma::lo_f(a[r]), n0);
          n0 = fmaf(s2r_mma::hi_f(a[r]), s2r_mma::hi_f(a[r]), n0);
          n1 = fmaf(s2r_mma::lo_f(a[r + 1]), s2r_mma::lo_f(a[r + 1]), n1);
          n1 = fmaf(s2r_mma::hi_f(a[r + 1]), s2r_mma::hi_f(a[r + 1]), n1);
        }
      }
    }
    if (!active) return;
    // the quad's four partial sums (the same bits in all four lanes)
    n0 = __fadd_rn(n0, __shfl_xor_sync(0xffffffffu, n0, 1));
    n1 = __fadd_rn(n1, __shfl_xor_sync(0xffffffffu, n1, 1));
    n0 = __fadd_rn(n0, __shfl_xor_sync(0xffffffffu, n0, 2));
    n1 = __fadd_rn(n1, __shfl_xor_sync(0xffffffffu, n1, 2));
    const float inv0 = 1.f / fmaxf(sqrtf(n0), 1e-12f);
    const float inv1 = 1.f / fmaxf(sqrtf(n1), 1e-12f);
    const unsigned short* w = reinterpret_cast<const unsigned short*>(wc) + g * C;
    const bool even = (C & 1) == 0 && (reinterpret_cast<uintptr_t>(wc) & 3) == 0;
    float d[4] = {0.f, 0.f, 0.f, 0.f};
    uint32_t b0 = cls_wpair(w, 2 * t, C, even), b1 = cls_wpair(w, 8 + 2 * t, C, even);
    for (int k0 = 0; k0 < Cp; k0 += 16) {
      uint32_t a[4];
      s2r_mma::ldsm_x4_t(a, s2r_mma::smem_u32(tile + cls_off<true>(k0 + kl, ml)));
      // the next step's weights, in flight during this step
      const uint32_t nb0 = cls_wpair(w, k0 + 16 + 2 * t, C, even);
      const uint32_t nb1 = cls_wpair(w, k0 + 24 + 2 * t, C, even);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float inv = (r & 1) ? inv1 : inv0;
        a[r] = s2r_mma::pack_bf16x2(__fmul_rn(s2r_mma::lo_f(a[r]), inv),
                                    __fmul_rn(s2r_mma::hi_f(a[r]), inv));
      }
      s2r_mma::mma_16816(d, a, b0, b1);
      b0 = nb0;
      b1 = nb1;
    }
    // d0, d1: pixel g, rows 2t, 2t + 1; d2, d3: pixel g + 8
    const float c0 = cb[2 * t], c1 = cb[2 * t + 1];
    if (pb + mw + g < hw) {
      ob[2 * t * hw + g] = cls_logit(d[0], c0, inv_temp);
      ob[(2 * t + 1) * hw + g] = cls_logit(d[1], c1, inv_temp);
    }
    if (pb + mw + g + 8 < hw) {
      ob[2 * t * hw + g + 8] = cls_logit(d[2], c0, inv_temp);
      ob[(2 * t + 1) * hw + g + 8] = cls_logit(d[3], c1, inv_temp);
    }
  } else {
    // lane (m, h): pixel m, channels h, h + 2, ...
    const int m = mw + (lane & 15), h = lane >> 4;
    float n2 = 0.f;
    for (int grp = 0; grp < CLS_GROUPS; ++grp) {
      cls_wait(CLS_GROUPS - 1 - grp);
      __syncthreads();  // the first also orders the weights
      if (!active) continue;
      const int k1 = min(Cp, (grp + 1) * gk);
      for (int k = min(Cp, grp * gk) + h; k < k1; k += 2) {
        const float v = to_f<T>(tile[cls_off<false>(k, m)]);
        n2 = fmaf(v, v, n2);
      }
    }
    if (!active) return;
    n2 = __fadd_rn(n2, __shfl_xor_sync(0xffffffffu, n2, 16));
    const float inv = 1.f / fmaxf(sqrtf(n2), 1e-12f);
    const float* w = reinterpret_cast<const float*>(wsm);
    float u[8];
#pragma unroll
    for (int o = 0; o < 8; ++o) u[o] = 0.f;
    for (int k = h; k < Cp; k += 2) {
      const float fn = round_to<T>(__fmul_rn(to_f<T>(tile[cls_off<false>(k, m)]), inv));
      const float4 wa = *reinterpret_cast<const float4*>(w + 8 * k);
      const float4 wb = *reinterpret_cast<const float4*>(w + 8 * k + 4);
      const float w8[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
      for (int o = 0; o < 8; ++o) u[o] = fmaf(w8[o], fn, u[o]);
    }
#pragma unroll
    for (int o = 0; o < 8; ++o) u[o] = __fadd_rn(u[o], __shfl_xor_sync(0xffffffffu, u[o], 16));
    const int px = lane & 15;
    if (pb + mw + px < hw) {
#pragma unroll
      for (int o = 4 * h; o < 4 * h + 4; ++o) ob[o * hw + px] = cls_logit(u[o], cb[o], inv_temp);
    }
  }
}

template <typename T, int TAPS>
cudaError_t launch_conv(const void* in, long long in_bstride, int B, int K,
                        int H, int W, const float* scale, const float* shift,
                        const void* wt, const float* bias, int N, void* out,
                        long long out_bstride, int round_first,
                        cudaStream_t stream) {
  const int tiles = ((H + TH - 1) / TH) * ((W + TW - 1) / TW);
  const dim3 grid(tiles, (N + NB - 1) / NB, B);
  conv_bnrelu_kernel<T, TAPS><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(in), in_bstride, K, H, W, scale, shift,
      static_cast<const T*>(wt), bias, N, static_cast<T*>(out), out_bstride,
      round_first);
  return cudaGetLastError();
}

// The bf16 dense layer with growth G (12 or 16): the shared body, serving's
// epilogue
template <int G>
__global__ void __launch_bounds__(s2r_mma::C3_THREADS, 3)
dense3x3_mma_kernel(const s2r_mma::u16* X, long long x_bstride, int K, int H, int W,
                    const float* __restrict__ scale, const float* __restrict__ shift,
                    const s2r_mma::u16* __restrict__ wt, const float* __restrict__ bias,
                    const float* __restrict__ mask, s2r_mma::u16* out,
                    long long out_bstride, int pair) {
  s2r_d3::fwd3x3_body<G, false>(X, x_bstride, K, H, W, scale, shift, wt, bias, mask, out,
                                out_bstride, pair);
}

// Its two diagnostic variants (s2r_d3::NO_TAPS, NO_PREP): the same launch,
// one cost removed.
template <int G>
__global__ void __launch_bounds__(s2r_mma::C3_THREADS, 3)
dense3x3_no_taps_kernel(const s2r_mma::u16* X, long long x_bstride, int K, int H, int W,
                        const float* __restrict__ scale, const float* __restrict__ shift,
                        const s2r_mma::u16* __restrict__ wt, const float* __restrict__ bias,
                        const float* __restrict__ mask, s2r_mma::u16* out,
                        long long out_bstride, int pair) {
  s2r_d3::fwd3x3_body<G, false, s2r_d3::NO_TAPS>(X, x_bstride, K, H, W, scale, shift, wt,
                                                 bias, mask, out, out_bstride, pair);
}

template <int G>
__global__ void __launch_bounds__(s2r_mma::C3_THREADS, 3)
dense3x3_no_prep_kernel(const s2r_mma::u16* X, long long x_bstride, int K, int H, int W,
                        const float* __restrict__ scale, const float* __restrict__ shift,
                        const s2r_mma::u16* __restrict__ wt, const float* __restrict__ bias,
                        const float* __restrict__ mask, s2r_mma::u16* out,
                        long long out_bstride, int pair) {
  s2r_d3::fwd3x3_body<G, false, s2r_d3::NO_PREP>(X, x_bstride, K, H, W, scale, shift, wt,
                                                 bias, mask, out, out_bstride, pair);
}

// g: the growth, 12 or 16 (else cudaErrorInvalidValue).  mode:
// s2r_d3::ABLATE_NONE (the dense layer), NO_TAPS or NO_PREP.
cudaError_t launch_dense_mma(int g, int mode, const void* in, long long in_bstride, int B,
                             int K, int H, int W, const float* scale, const float* shift,
                             const void* wt, const float* bias, void* out,
                             long long out_bstride, int* splits, cudaStream_t stream) {
  static decltype(&dense3x3_mma_kernel<16>) const kernels[2][3] = {
      {dense3x3_mma_kernel<12>, dense3x3_no_taps_kernel<12>, dense3x3_no_prep_kernel<12>},
      {dense3x3_mma_kernel<16>, dense3x3_no_taps_kernel<16>, dense3x3_no_prep_kernel<16>}};
  static bool ready[2][3] = {};  // the shared-memory limits, set once
  if (mode < s2r_d3::ABLATE_NONE || mode > s2r_d3::NO_PREP || (g != 12 && g != 16))
    return cudaErrorInvalidValue;
  const int gi = g == 16;
  if (!ready[gi][mode]) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernels[gi][mode], cudaFuncAttributeMaxDynamicSharedMemorySize, s2r_d3::SMEM);
    if (e != cudaSuccess) return e;
    ready[gi][mode] = true;
  }
  return s2r_d3::launch_fwd3x3(kernels[gi][mode], in, in_bstride, B, K, H, W, scale, shift,
                               wt, bias, nullptr, out, out_bstride, stream, splits);
}

template <typename T>
cudaError_t launch_classifier(const void* in, long long in_bstride, int B,
                              int C, long long hw, const void* wc,
                              const float* cb, float inv_temp, float* out,
                              cudaStream_t stream) {
  const long long smem = classifier_smem(C, sizeof(T));
  if (B <= 0 || C <= 0 || hw <= 0 || smem > CLS_SMEM_MAX) return cudaErrorInvalidValue;
  static bool ready = false;  // the shared-memory limit, set once
  if (!ready) {
    const cudaError_t e = cudaFuncSetAttribute(
        classifier_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, CLS_SMEM_MAX);
    if (e != cudaSuccess) return e;
    ready = true;
  }
  // 16-byte pieces when every channel row of every image starts on 16 bytes
  constexpr int EPC = 16 / sizeof(T);
  const int vec = hw % EPC == 0 && in_bstride % EPC == 0 && s2r_mma::aligned16(in);
  const dim3 grid((unsigned)((hw + CLS_PX - 1) / CLS_PX), B);
  classifier_kernel<T><<<grid, CLS_THREADS, smem, stream>>>(
      static_cast<const T*>(in), in_bstride, C, hw, static_cast<const T*>(wc), cb,
      inv_temp, out, vec);
  return cudaGetLastError();
}

}  // namespace

// Plain C interface, bound with ctypes.  dtype: 0 = float32, 1 = bfloat16.
// taps: 9 (dense layer) or 1 (TransitionDown).  Each returns the
// cudaError_t of its launch (0 on success); an unknown dtype or tap count
// returns cudaErrorInvalidValue.  Dispatch (takes_mma_dense in
// kernels/dense_block.py states it for the CPU tests): a bfloat16 dense
// layer with 12 or 16 outputs runs on the tensor cores
// (dense3x3_mma_kernel<N>; its weight is [K][9][16], rows 288 bytes apart
// and columns N-15 zero, and must be 16-byte aligned, else
// cudaErrorMisalignedAddress), a
// bfloat16 TransitionDown too (launch_td_mma) with C <= 768 inputs (every
// FCDenseNet57/67/103 site; K1's one-tap rule, takes_mma_fwd); float32, other
// growth rates and a wider TransitionDown on the CUDA cores.  *route
// receives the route taken: 0 for the CUDA cores, 1 for the tensor-core
// TransitionDown, and for the tensor-core dense layer the blocks S >= 1
// that split its channel loop.  mode (the tensor-core dense layer only,
// else 0 or cudaErrorInvalidValue): 0 the layer, 1 and 2 its diagnostic
// variants, wrong math at the same launch (s2r_d3::NO_TAPS: the centre tap
// alone; NO_PREP: x staged without BN + ReLU).
extern "C" int s2r_conv_bnrelu(int dtype, int taps, const void* in,
                               long long in_bstride, int B, int K, int H,
                               int W, const float* scale, const float* shift,
                               const void* wt, const float* bias, int N,
                               void* out, long long out_bstride,
                               int round_first, int mode, int* route,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  *route = 0;
  const bool dense_mma = dtype == 1 && taps == 9 && (N == 12 || N == s2r_mma::C3_N);
  if (mode != 0 && !dense_mma) return cudaErrorInvalidValue;
  if (dtype == 0 && taps == 9)
    return launch_conv<float, 9>(in, in_bstride, B, K, H, W, scale, shift, wt,
                                 bias, N, out, out_bstride, round_first, s);
  if (dtype == 0 && taps == 1)
    return launch_conv<float, 1>(in, in_bstride, B, K, H, W, scale, shift, wt,
                                 bias, N, out, out_bstride, round_first, s);
  if (dense_mma)
    return launch_dense_mma(N, mode, in, in_bstride, B, K, H, W, scale, shift, wt, bias,
                            out, out_bstride, route, s);
  if (dtype == 1 && taps == 9)
    return launch_conv<__nv_bfloat16, 9>(in, in_bstride, B, K, H, W, scale,
                                         shift, wt, bias, N, out, out_bstride,
                                         round_first, s);
  if (dtype == 1 && taps == 1 && K <= s2r_td::TD_MAX_K) {
    *route = 1;
    return s2r_td::launch_td_mma(in, in_bstride, B, K, H, W, scale, shift, wt,
                                 bias, N, out, out_bstride, round_first, nullptr,
                                 s);
  }
  if (dtype == 1 && taps == 1)
    return launch_conv<__nv_bfloat16, 1>(in, in_bstride, B, K, H, W, scale,
                                         shift, wt, bias, N, out, out_bstride,
                                         round_first, s);
  return cudaErrorInvalidValue;
}

// The classifier's shared memory per block for C channels of this dtype
// (kernels/dense_block.classifier_smem states it for the CPU tests); C
// above the 227 KB a block may hold returns cudaErrorInvalidValue from
// s2r_classifier.
extern "C" long long s2r_classifier_smem(int dtype, int C) {
  return classifier_smem(C, dtype == 0 ? 4 : 2);
}

extern "C" int s2r_classifier(int dtype, const void* in, long long in_bstride,
                              int B, int C, long long hw, const void* wc,
                              const float* cb, float inv_temp, float* out,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_classifier<float>(in, in_bstride, B, C, hw, wc, cb,
                                    inv_temp, out, s);
  if (dtype == 1)
    return launch_classifier<__nv_bfloat16>(in, in_bstride, B, C, hw, wc, cb,
                                            inv_temp, out, s);
  return cudaErrorInvalidValue;
}

// The tensor-core dense layer's split of its channel loop at this shape
// on the current device (kernels/dense_block.dense_splits states the rule
// for the CPU tests); -1 if the device cannot be read.
extern "C" int s2r_dense_splits(int B, int H, int W, int K) {
  int sms = 0;
  if (s2r_d3::device_sms(&sms) != cudaSuccess) return -1;
  return s2r_d3::dense_splits(B, H, W, K, sms);
}

extern "C" const char* s2r_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
