// FC-DenseNet train-mode consumer layers for NVIDIA Hopper (sm_90a):
// forward, per-consumer backward and the fused dense-block reverse sweep.
//
// Replaces the TPU kernels of the JAX package's
// sim2real_lane_segment_tpu/models/tiramisu_train_pallas.py:
//   K1  _fwd_kernel    (pallas_call at :187, launched by _consumer_fwd)
//   K2  _bwd_kernel    (pallas_call at :328, _consumer_bwd_call)
//   K3a _stage_kernel  (pallas_call at :759, _stage_call)
//   K3b _final_kernel  (pallas_call at :854, _final_call)
//
// Layout: NCHW per image, the consumer's input X is channels [0, K) of a
// buffer with batch stride x_bstride.  The conv is a zero-padded 3x3 (TAPS
// 9) or 1x1 (TAPS 1) correlation, and the zero padding applies to the
// activation a = T(relu(X*scale + shift)), not to X.  Weights are
// [K][TAPS][N] in the compute type T (tap = ky*3 + kx).  With g_pre the
// cotangent at the conv output (times the dropout mask) and G = T(g_pre):
//   K1:  y  = T((conv(a, W) + bias) * mask)
//   dW[k,t,o] = sum_{b,q} G[o,q] * a[k, q + off_t]        (contract pixels)
//   dA[k,q]   = sum_{o,t} W[k,t,o] * G[o, q - off_t]      (contract TAPS*N)
//   dz = dA * relu'(z), relu'(z) = (z > 0) + 0.5 (z == 0)
//   dscale = sum dz*X,  dshift = sum dz,  dbias = sum g_pre,  dseg = T(dz*scale)
//   K3a: dy_j = ext + sum_l dA_l * relu'(z_l) * scale_l over the later
//        layers l (their stored G_l against the y_j rows of W_l), then
//        g_pre = dy_j * mask and the K2 sums on G = T(g_pre);
//   K3b: dseg = T(sum_l dA_l * relu'(z_l) * scale_l) over a block's layers.
//
// Reductions over the batch: the TPU grid walks the batch in order and
// accumulates into a resident block.  Here blocks run at once, so every
// kernel writes f32 partial sums per (image, pixel tile) or per split of
// the work, and a second pass (reduce_rows_kernel) adds them in a fixed
// order: results do not depend on scheduling, and no atomics are used.
//
// What bounds the CUDA-core kernels (float32, K2 with 3x3): the dense
// layers of FCDenseNet67 at 120x160 are 13.7 GFLOP per frame forward and
// twice that backward.  A layer launch moves c_j + 16 channels for 144
// operations per input value, so with the f32 CUDA cores (67 TFLOP/s)
// these kernels are bound by FMA issue, not bytes.
//
// What their design does about it: this is the simple, correct first
// kernel.  Each block stages 16 channels of a 16x16 pixel tile (plus a
// one-pixel halo) in shared memory with BN, ReLU and rounding applied once
// per staged value, and reuses each staged value for 16 outputs and 9 taps
// from shared memory; sums stay in registers.  wgmma, TMA and keeping the
// block's buffer on chip are later work.  The float32 1x1 backward stays
// on this code as the parity control (TF32 would not hold it to 1e-4).
//
// K2 in bfloat16 with one tap (the TransitionDown backward, the only K2 of
// the fused train step) runs on the tensor cores instead:
// bwd1x1_dgrad_mma_kernel and bwd1x1_wgrad_mma_kernel, noted below.  So do
// K1, K3a and K3b in bfloat16 with 12 or 16 outputs (every dense layer of
// FCDenseNet57, 67 and 103): fwd3x3_mma_kernel, sum_dgrad_mma_kernel and
// stage_own_mma_kernel, templates on the growth G, noted below, and K1 with one tap, through the
// TransitionDown product of td_fwd_mma.cuh.  The kernels above them stay
// for float32 and for the shapes the tensor-core kernels do not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>

#include "bnrelu_mma.cuh"
#include "dense3x3_mma.cuh"
#include "td_fwd_mma.cuh"

namespace {

constexpr int TH = 16;       // pixel tile rows
constexpr int TW = 16;       // pixel tile columns
constexpr int KC = 16;       // input channels per block / stage
constexpr int NB = 16;       // output channels per stage
constexpr int THREADS = TH * TW;
constexpr int WARPS = THREADS / 32;
constexpr int MAXL = 16;     // layers a reverse-sweep launch may read

typedef long long ll;

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

// BN affine without fma contraction, as the plain PyTorch version computes it
__device__ __forceinline__ float affine(float x, float s, float h) {
  return __fadd_rn(__fmul_rn(x, s), h);
}

// the subgradient of max(z, 0) that splits the tie at z == 0
__device__ __forceinline__ float relu_d(float z) {
  return z > 0.f ? 1.f : (z == 0.f ? 0.5f : 0.f);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Sums v[0..n) over the block's threads; thread i < n writes dst[i].
// red: shared [WARPS][n].  Fixed order, so deterministic.
template <int M>
__device__ __forceinline__ void block_sum(float (&v)[M], float* red, float* dst,
                                          int n) {
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
#pragma unroll
  for (int i = 0; i < M; ++i) {
    const float s = warp_sum(v[i]);
    if (lane == 0) red[warp * M + i] = s;
  }
  __syncthreads();
  if (threadIdx.x < n) {
    float s = 0.f;
    for (int w = 0; w < WARPS; ++w) s += red[w * M + threadIdx.x];
    dst[threadIdx.x] = s;
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// K1: y = T((conv(a, W) + bias) * mask), written to out[:, 0:N]
// ---------------------------------------------------------------------------
template <typename T, int TAPS>
__global__ void __launch_bounds__(THREADS)
fwd_kernel(const T* X, ll x_bstride, int K, int H, int W,
           const float* __restrict__ scale, const float* __restrict__ shift,
           const T* __restrict__ wt, const float* __restrict__ bias,
           const float* __restrict__ mask, int N, T* out, ll out_bstride) {
  constexpr int R = TAPS == 9 ? 1 : 0;
  constexpr int SH = TH + 2 * R;
  constexpr int SW = TW + 2 * R;
  __shared__ float s_in[KC][SH][SW];
  __shared__ __align__(16) float s_w[KC][TAPS][NB];

  const int tiles_x = (W + TW - 1) / TW;
  const int ty0 = (blockIdx.x / tiles_x) * TH;
  const int tx0 = (blockIdx.x % tiles_x) * TW;
  const int n0 = blockIdx.y * NB;
  const int b = blockIdx.z;
  const ll hw = (ll)H * W;
  const T* xb = X + b * x_bstride;
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
        const float f = to_f<T>(xb[k * hw + (ll)gy * W + gx]);
        v = round_to<T>(fmaxf(affine(f, scale[k], shift[k]), 0.f));
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
        v = to_f<T>(wt[((ll)(k0 + c) * TAPS + t) * N + n0 + o]);
      s_w[c][t][o] = v;
    }
    __syncthreads();
    for (int c = 0; c < kc; ++c) {
#pragma unroll
      for (int t = 0; t < TAPS; ++t) {
        const float a = s_in[c][py + (TAPS == 9 ? t / 3 : 0)][px + (TAPS == 9 ? t % 3 : 0)];
#pragma unroll
        for (int o = 0; o < NB; ++o) acc[o] = fmaf(a, s_w[c][t][o], acc[o]);
      }
    }
    __syncthreads();
  }

  const int gy = ty0 + py;
  const int gx = tx0 + px;
  if (gy >= H || gx >= W) return;
  T* ob = out + b * out_bstride + (ll)gy * W + gx;
#pragma unroll
  for (int o = 0; o < NB; ++o) {
    const int n = n0 + o;
    if (n < N)
      ob[n * hw] = from_f<T>(__fmul_rn(__fadd_rn(acc[o], bias[n]), mask[b * N + n]));
  }
}

// ---------------------------------------------------------------------------
// K2 step 1: G = T(dy * mask), with per-(image, channel) sums of dy * mask
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(THREADS)
gpre_kernel(const T* __restrict__ dy, const float* __restrict__ mask, int N,
            ll hw, T* __restrict__ g, float* __restrict__ part) {
  __shared__ float red[WARPS];
  const int n = blockIdx.x;
  const int b = blockIdx.y;
  const float m = mask[b * N + n];
  const ll base = ((ll)b * N + n) * hw;
  float s[1] = {0.f};
  for (ll p = threadIdx.x; p < hw; p += THREADS) {
    const float v = __fmul_rn(to_f<T>(dy[base + p]), m);
    g[base + p] = from_f<T>(v);
    s[0] += v;
  }
  block_sum<1>(s, red, part + (ll)b * N + n, 1);
}

// ---------------------------------------------------------------------------
// Input cotangents.  A block owns a 16x16 pixel tile of one image and 16
// channels k of X; a thread owns one pixel and keeps 16 sums dA[k].
// SUM = false (K2, K3a's own layer): one layer; dz = dA * relu'(z);
//   writes dseg = T(dz * scale) when dseg is given, and per-tile partial
//   sums of dz*X (part_a) and dz (part_b).
// SUM = true (K3a's later layers, K3b): tot = ext + sum_l dA_l * relu'(z_l)
//   * scale_l over nl layers; with a mask, out = T(tot * mask) and per-tile
//   partial sums of tot * mask (part_a); without, out = T(tot).
// ---------------------------------------------------------------------------
struct Layers {
  const void* g[MAXL];     // [B, N, H, W] in T: the layer's stored G
  const void* w[MAXL];     // rows of this launch's channels, [C][TAPS][N] in T
  const float* sc[MAXL];   // [C] f32: the layer's BN scale on these channels
  const float* sh[MAXL];   // [C] f32: its shift
};

template <typename T, int TAPS, bool SUM>
__global__ void __launch_bounds__(THREADS)
dgrad_kernel(const T* X, ll x_bstride, int C, int H, int W, int N, int nl,
             Layers L, const float* __restrict__ ext,
             const float* __restrict__ mask, T* out,
             float* __restrict__ part_a, float* __restrict__ part_b) {
  constexpr int R = TAPS == 9 ? 1 : 0;
  constexpr int SH = TH + 2 * R;
  constexpr int SW = TW + 2 * R;
  __shared__ float s_g[NB][SH][SW];
  __shared__ float s_w[KC][TAPS][NB];
  __shared__ float red[WARPS * 2 * KC];

  const int tiles_x = (W + TW - 1) / TW;
  const int tiles = ((H + TH - 1) / TH) * tiles_x;
  const int tile = blockIdx.x;
  const int ty0 = (tile / tiles_x) * TH;
  const int tx0 = (tile % tiles_x) * TW;
  const int c0 = blockIdx.y * KC;
  const int kc = min(KC, C - c0);
  const int b = blockIdx.z;
  const ll hw = (ll)H * W;
  const int tid = threadIdx.x;
  const int py = tid / TW;
  const int px = tid % TW;
  const int gy = ty0 + py;
  const int gx = tx0 + px;
  const bool inside = gy < H && gx < W;
  const ll pix = (ll)gy * W + gx;

  float xv[KC];
  float tot[KC];
#pragma unroll
  for (int k = 0; k < KC; ++k) {
    xv[k] = (inside && k < kc) ? to_f<T>(X[b * x_bstride + (c0 + k) * hw + pix]) : 0.f;
    tot[k] = (SUM && ext != nullptr && inside && k < kc)
                 ? ext[((ll)b * C + c0 + k) * hw + pix] : 0.f;
  }

  for (int l = 0; l < nl; ++l) {
    const T* G = static_cast<const T*>(L.g[l]);
    const T* Wl = static_cast<const T*>(L.w[l]);
    float acc[KC];
#pragma unroll
    for (int k = 0; k < KC; ++k) acc[k] = 0.f;
    for (int o0 = 0; o0 < N; o0 += NB) {
      const int oc = min(NB, N - o0);
      for (int i = tid; i < NB * SH * SW; i += THREADS) {
        const int o = i / (SH * SW);
        const int r = i - o * (SH * SW);
        const int y = r / SW;
        const int x = r - y * SW;
        const int sy = ty0 + y - R;
        const int sx = tx0 + x - R;
        float v = 0.f;
        if (o < oc && sy >= 0 && sy < H && sx >= 0 && sx < W)
          v = to_f<T>(G[((ll)b * N + o0 + o) * hw + (ll)sy * W + sx]);
        s_g[o][y][x] = v;
      }
      for (int i = tid; i < KC * TAPS * NB; i += THREADS) {
        const int k = i / (TAPS * NB);
        const int r = i - k * (TAPS * NB);
        const int t = r / NB;
        const int o = r - t * NB;
        float v = 0.f;
        if (k < kc && o < oc) v = to_f<T>(Wl[((ll)(c0 + k) * TAPS + t) * N + o0 + o]);
        s_w[k][t][o] = v;
      }
      __syncthreads();
      for (int o = 0; o < oc; ++o) {
#pragma unroll
        for (int t = 0; t < TAPS; ++t) {
          // G at q - off_t: local (py + 2R - ky, px + 2R - kx)
          const float g = s_g[o][py + 2 * R - (TAPS == 9 ? t / 3 : 0)]
                             [px + 2 * R - (TAPS == 9 ? t % 3 : 0)];
#pragma unroll
          for (int k = 0; k < KC; ++k) acc[k] = fmaf(g, s_w[k][t][o], acc[k]);
        }
      }
      __syncthreads();
    }
    if (SUM) {
      const float* sc = L.sc[l];
      const float* sh = L.sh[l];
#pragma unroll
      for (int k = 0; k < KC; ++k) {
        if (k < kc) {
          const float z = affine(xv[k], sc[c0 + k], sh[c0 + k]);
          tot[k] = __fadd_rn(tot[k], __fmul_rn(__fmul_rn(acc[k], relu_d(z)), sc[c0 + k]));
        }
      }
    } else {
      // one layer: tot <- dz
      const float* sc = L.sc[0];
      const float* sh = L.sh[0];
#pragma unroll
      for (int k = 0; k < KC; ++k) {
        if (k < kc) tot[k] = __fmul_rn(acc[k], relu_d(affine(xv[k], sc[c0 + k], sh[c0 + k])));
      }
    }
  }

  const ll prow = ((ll)b * tiles + tile) * C + c0;
  if (SUM) {
    if (mask != nullptr) {
      float gp[KC];
#pragma unroll
      for (int k = 0; k < KC; ++k) {
        gp[k] = 0.f;
        if (inside && k < kc) {
          gp[k] = __fmul_rn(tot[k], mask[b * C + c0 + k]);
          out[((ll)b * C + c0 + k) * hw + pix] = from_f<T>(gp[k]);
        }
      }
      block_sum<KC>(gp, red, part_a + prow, kc);
    } else if (inside) {
#pragma unroll
      for (int k = 0; k < KC; ++k)
        if (k < kc) out[((ll)b * C + c0 + k) * hw + pix] = from_f<T>(tot[k]);
    }
  } else {
    const float* sc = L.sc[0];
    float sums[2 * KC];
#pragma unroll
    for (int k = 0; k < KC; ++k) {
      const bool on = inside && k < kc;
      sums[k] = on ? __fmul_rn(tot[k], xv[k]) : 0.f;
      sums[KC + k] = on ? tot[k] : 0.f;
      if (on && out != nullptr)
        out[((ll)b * C + c0 + k) * hw + pix] = from_f<T>(__fmul_rn(tot[k], sc[c0 + k]));
    }
    // one pass over both sums: red holds [WARPS][2*KC]
    const int lane = tid % 32;
    const int warp = tid / 32;
#pragma unroll
    for (int i = 0; i < 2 * KC; ++i) {
      const float s = warp_sum(sums[i]);
      if (lane == 0) red[warp * 2 * KC + i] = s;
    }
    __syncthreads();
    if (tid < 2 * KC && (tid % KC) < kc) {
      float s = 0.f;
      for (int w = 0; w < WARPS; ++w) s += red[w * 2 * KC + tid];
      if (tid < KC) part_a[prow + tid] = s;
      else part_b[prow + tid - KC] = s;
    }
  }
}

// ---------------------------------------------------------------------------
// Weight cotangent partials: part[s][k][t][o] = sum over the (image, tile)
// items i = s, s + S, ... of sum_q G[o,q] * a[k, q + off_t].  A block owns
// 16 channels k and 16 outputs o; a thread owns one (k, o) and its TAPS sums.
// ---------------------------------------------------------------------------
template <typename T, int TAPS>
__global__ void __launch_bounds__(THREADS)
wgrad_kernel(const T* X, ll x_bstride, int C, int B, int H, int W,
             const float* __restrict__ scale, const float* __restrict__ shift,
             const T* __restrict__ G, int N, int S, float* __restrict__ part) {
  constexpr int R = TAPS == 9 ? 1 : 0;
  constexpr int SH = TH + 2 * R;
  constexpr int SW = TW + 2 * R;
  __shared__ float s_a[KC][SH][SW];
  __shared__ float s_g[TH * TW][NB + 1];

  const int tiles_x = (W + TW - 1) / TW;
  const int tiles = ((H + TH - 1) / TH) * tiles_x;
  const int c0 = blockIdx.x * KC;
  const int kc = min(KC, C - c0);
  const int o0 = blockIdx.y * NB;
  const int oc = min(NB, N - o0);
  const ll hw = (ll)H * W;
  const int tid = threadIdx.x;
  const int kk = tid / NB;
  const int oo = tid % NB;

  float acc[TAPS];
#pragma unroll
  for (int t = 0; t < TAPS; ++t) acc[t] = 0.f;

  for (int item = blockIdx.z; item < B * tiles; item += S) {
    const int b = item / tiles;
    const int tile = item - b * tiles;
    const int ty0 = (tile / tiles_x) * TH;
    const int tx0 = (tile % tiles_x) * TW;
    const T* xb = X + b * x_bstride;
    for (int i = tid; i < KC * SH * SW; i += THREADS) {
      const int c = i / (SH * SW);
      const int r = i - c * (SH * SW);
      const int y = r / SW;
      const int x = r - y * SW;
      const int gy = ty0 + y - R;
      const int gx = tx0 + x - R;
      float v = 0.f;
      if (c < kc && gy >= 0 && gy < H && gx >= 0 && gx < W) {
        const int k = c0 + c;
        const float f = to_f<T>(xb[k * hw + (ll)gy * W + gx]);
        v = round_to<T>(fmaxf(affine(f, scale[k], shift[k]), 0.f));
      }
      s_a[c][y][x] = v;
    }
    for (int i = tid; i < TH * TW * NB; i += THREADS) {
      const int o = i / (TH * TW);
      const int p = i - o * (TH * TW);
      const int gy = ty0 + p / TW;
      const int gx = tx0 + p % TW;
      float v = 0.f;
      if (o < oc && gy < H && gx < W)
        v = to_f<T>(G[((ll)b * N + o0 + o) * hw + (ll)gy * W + gx]);
      s_g[p][o] = v;
    }
    __syncthreads();
    for (int p = 0; p < TH * TW; ++p) {
      const int y = p / TW;
      const int x = p % TW;
      const float g = s_g[p][oo];
#pragma unroll
      for (int t = 0; t < TAPS; ++t)
        acc[t] = fmaf(g, s_a[kk][y + (TAPS == 9 ? t / 3 : 0)][x + (TAPS == 9 ? t % 3 : 0)],
                      acc[t]);
    }
    __syncthreads();
  }
  if (kk < kc && oo < oc) {
    float* dst = part + (((ll)blockIdx.z * C + c0 + kk) * TAPS) * N + o0 + oo;
#pragma unroll
    for (int t = 0; t < TAPS; ++t) dst[(ll)t * N] = acc[t];
  }
}

// out[m] = sum_r part[r][m] over P rows, in a fixed order.  A block owns 32
// columns; its 8 warps take every 8th row and are then added in order.
__device__ __forceinline__ void reduce_rows_body(const float* __restrict__ part, int P,
                                                 ll M, float* __restrict__ out,
                                                 int block) {
  __shared__ float red[WARPS][32];
  const int lane = threadIdx.x % 32;
  const int rg = threadIdx.x / 32;
  const ll col = (ll)block * 32 + lane;
  float s = 0.f;
  if (col < M)
    for (int r = rg; r < P; r += WARPS) s += part[(ll)r * M + col];
  red[rg][lane] = s;
  __syncthreads();
  if (rg == 0 && col < M) {
    float t = 0.f;
    for (int w = 0; w < WARPS; ++w) t += red[w][lane];
    out[col] = t;
  }
}

__global__ void __launch_bounds__(THREADS)
reduce_rows_kernel(const float* __restrict__ part, int P, ll M,
                   float* __restrict__ out) {
  reduce_rows_body(part, P, M, out, blockIdx.x);
}

// out[m] = sum_r part[m * P + r]: one warp per column, lanes over strided
// rows and then a fixed-order tree (deterministic); for tall partial sums
// (thousands of tiles, few columns)
__device__ __forceinline__ void reduce_cols_body(const float* __restrict__ part, int P,
                                                 int M, float* __restrict__ out,
                                                 int block) {
  const int m = block * WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (m >= M) return;
  const float* src = part + (ll)m * P;
  float s[4] = {0.f, 0.f, 0.f, 0.f};
  int r = lane;
  for (; r + 96 < P; r += 128) {
#pragma unroll
    for (int u = 0; u < 4; ++u) s[u] += src[r + 32 * u];
  }
  for (; r < P; r += 32) s[0] += src[r];
  const float v = warp_sum((s[0] + s[1]) + (s[2] + s[3]));
  if (lane == 0) out[m] = v;
}

__global__ void __launch_bounds__(THREADS)
reduce_cols_kernel(const float* __restrict__ part, int P, int M,
                   float* __restrict__ out) {
  reduce_cols_body(part, P, M, out, blockIdx.x);
}

int n_tiles(int H, int W) { return ((H + TH - 1) / TH) * ((W + TW - 1) / TW); }

cudaError_t reduce_cols(const float* part, int P, int M, float* out, cudaStream_t s) {
  reduce_cols_kernel<<<(M + WARPS - 1) / WARPS, THREADS, 0, s>>>(part, P, M, out);
  return cudaGetLastError();
}

cudaError_t reduce_rows(const float* part, int P, ll M, float* out, cudaStream_t s) {
  const unsigned blocks = (unsigned)((M + 31) / 32);
  reduce_rows_kernel<<<blocks, THREADS, 0, s>>>(part, P, M, out);
  return cudaGetLastError();
}

template <typename T, int TAPS, bool SUM>
cudaError_t launch_dgrad(const void* X, ll x_bstride, int B, int C, int H, int W,
                         int N, int nl, const Layers& L, const float* ext,
                         const float* mask, void* out, float* part_a,
                         float* part_b, cudaStream_t s) {
  const dim3 grid(n_tiles(H, W), (C + KC - 1) / KC, B);
  dgrad_kernel<T, TAPS, SUM><<<grid, THREADS, 0, s>>>(
      static_cast<const T*>(X), x_bstride, C, H, W, N, nl, L, ext, mask,
      static_cast<T*>(out), part_a, part_b);
  return cudaGetLastError();
}

template <typename T, int TAPS>
cudaError_t launch_wgrad(const void* X, ll x_bstride, int B, int C, int H, int W,
                         const float* scale, const float* shift, const void* G,
                         int N, int S, float* part, cudaStream_t s) {
  const dim3 grid((C + KC - 1) / KC, (N + NB - 1) / NB, S);
  wgrad_kernel<T, TAPS><<<grid, THREADS, 0, s>>>(
      static_cast<const T*>(X), x_bstride, C, B, H, W, scale, shift,
      static_cast<const T*>(G), N, S, part);
  return cudaGetLastError();
}

#define S2R_TRY(expr)                    \
  do {                                   \
    const cudaError_t e_ = (expr);       \
    if (e_ != cudaSuccess) return e_;    \
  } while (0)

template <typename T, int TAPS>
cudaError_t fwd(const void* X, ll x_bstride, int B, int K, int H, int W,
                const float* scale, const float* shift, const void* wt,
                const float* bias, const float* mask, int N, void* out,
                ll out_bstride, cudaStream_t s) {
  const dim3 grid(n_tiles(H, W), (N + NB - 1) / NB, B);
  fwd_kernel<T, TAPS><<<grid, THREADS, 0, s>>>(
      static_cast<const T*>(X), x_bstride, K, H, W, scale, shift,
      static_cast<const T*>(wt), bias, mask, N, static_cast<T*>(out), out_bstride);
  return cudaGetLastError();
}

// the weight, scale and shift sums of one layer from its X and stored G
template <typename T, int TAPS>
cudaError_t own_layer(const void* X, ll x_bstride, int B, int K, int H, int W,
                      const float* scale, const float* shift, const void* wt,
                      int N, const void* G, void* dseg, float* dscale,
                      float* dshift, float* dw, float* part_ss, float* part_w,
                      int S, cudaStream_t s) {
  Layers L = {};
  L.g[0] = G;
  L.w[0] = wt;
  L.sc[0] = scale;
  L.sh[0] = shift;
  const int P = B * n_tiles(H, W);
  float* part_ds = part_ss;
  float* part_dh = part_ss + (ll)P * K;
  S2R_TRY((launch_dgrad<T, TAPS, false>(X, x_bstride, B, K, H, W, N, 1, L,
                                        nullptr, nullptr, dseg, part_ds,
                                        part_dh, s)));
  S2R_TRY((launch_wgrad<T, TAPS>(X, x_bstride, B, K, H, W, scale, shift, G, N,
                                 S, part_w, s)));
  S2R_TRY(reduce_rows(part_ds, P, K, dscale, s));
  S2R_TRY(reduce_rows(part_dh, P, K, dshift, s));
  return reduce_rows(part_w, S, (ll)K * TAPS * N, dw, s);
}

template <typename T, int TAPS>
cudaError_t bwd(const void* X, ll x_bstride, int B, int K, int H, int W,
                const float* scale, const float* shift, const void* wt,
                const float* mask, int N, const void* dy, void* dseg,
                float* dscale, float* dshift, float* dw, float* dbias,
                void* gbuf, float* part_gp, float* part_ss, float* part_w,
                int S, cudaStream_t s) {
  gpre_kernel<T><<<dim3(N, B), THREADS, 0, s>>>(
      static_cast<const T*>(dy), mask, N, (ll)H * W, static_cast<T*>(gbuf), part_gp);
  S2R_TRY(cudaGetLastError());
  S2R_TRY(reduce_rows(part_gp, B, N, dbias, s));
  return own_layer<T, TAPS>(X, x_bstride, B, K, H, W, scale, shift, wt, N, gbuf,
                            dseg, dscale, dshift, dw, part_ss, part_w, S, s);
}

// ---------------------------------------------------------------------------
// K2, bfloat16, one tap, on the tensor cores.
//
// Replaces, for the TransitionDown's bf16 backward, the TPU kernel K2
// (sim2real_lane_segment_tpu/models/tiramisu_train_pallas.py _bwd_kernel,
// pallas_call at :328).  Per image, with G = T(dy * mask) [N x pixels]:
//   dA = W . G                   [C x N] . [N x pixels]  (dgrad)
//   dW = sum over images of a . G^T, a = T(relu(x*scale + shift))  (wgrad)
// What bounds it on an H100: bytes.  It does about C operations per bf16
// byte moved, below the ~295 at which the bf16 tensor cores become the
// limit: per B=32 FCDenseNet67 step its five launches must move 0.76 GB
// (0.23 ms at 3.35 TB/s) for 87 GFLOP (0.09 ms at 989 TFLOP/s).
//
// What the design does about it:
// - bwd1x1_dgrad_mma_kernel: a block owns 128 consecutive pixels of one
//   image and one 128-channel chunk of x (the chunks of a tile are
//   neighbouring blocks).  It stages G = T(dy * mask) for all N outputs
//   as a 128-byte-swizzled tile (the first chunk's block also writes G to
//   gbuf for the wgrad pass and per-tile sums of dy * mask for dbias),
//   streams 64-column slices of W through a two-deep cp.async ring and
//   multiplies with wgmma (m64n128k16, bf16 in, f32 sums; two warpgroups
//   of 64 channels): D[k, p] = W[k, n] G[n, p], W K-major, G MN-major.
//   The epilogue reads the x tile into shared memory with coalesced
//   loads, writes dseg = T(dz * scale) back the same way, and per-tile
//   sums of dz * x and dz.
// - bwd1x1_wgrad_mma_kernel: a block owns a 128 x 128 tile of dW and a
//   contiguous range of 128-pixel slices (split S ways to fill the 132
//   SMs); it stages a (BN + ReLU applied while staging) and G for each
//   slice and contracts over pixels: D[k, n] = a[k, p] G[n, p]^T.
// - Every batch sum is a per-tile or per-split partial added by
//   reduce_rows in a fixed order: deterministic, no atomics.
// x is read twice and G makes one round trip through device memory:
// about twice the bound's bytes when C = N.
// ---------------------------------------------------------------------------
namespace mma = s2r_mma;

constexpr int B1_TP = 128;               // pixels per dgrad block
constexpr int B1_KM = 128;               // x channels per dgrad chunk
constexpr int B1_NS = 64;                // outputs per weight slice
constexpr int B1_SLICE = B1_KM * B1_NS;
constexpr int B1_PS = 128;               // pixels per wgrad slice
constexpr int B1_LDP = B1_PS + 8;
constexpr int B1_STAGES = 2;             // weight slices in flight
constexpr int B1_THREADS = 256;          // two warpgroups
constexpr int B1_LOADS = 8;              // dy chunks a thread has in flight
constexpr int B1_MAX_N = 624;            // G's tile fits in shared memory
constexpr int B1_SMEM_MAX = 232448;      // an H100 block's shared-memory limit

size_t b1_dgrad_smem(int N) {  // with room to align G's tile to 1024 bytes
  const size_t np = (size_t)(N + 15) / 16 * 16;
  return 2 * (np * B1_TP + B1_STAGES * B1_SLICE) + 4 * (B1_KM * 2) + 1024;
}

__global__ void __launch_bounds__(B1_THREADS, 2)
bwd1x1_dgrad_mma_kernel(const mma::u16* X, ll x_bstride, int C, int hw,
                        const float* __restrict__ scale,
                        const float* __restrict__ shift,
                        const mma::u16* __restrict__ wt,
                        const float* __restrict__ mask, int N,
                        const mma::u16* __restrict__ dy, mma::u16* gbuf,
                        mma::u16* dseg, float* __restrict__ part_gp,
                        float* __restrict__ part_ds, float* __restrict__ part_dh,
                        int vec_dy, int vec_w, int vec_x, int vec_dseg) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int np = (N + 15) / 16 * 16;
  mma::u16* sG = reinterpret_cast<mma::u16*>(           // G: [np][128], sw128
      smem + ((1024 - (mma::smem_u32(smem) & 1023)) & 1023));
  mma::u16* sW = sG + np * B1_TP;                      // [STAGES][KM][64], core order
  float* red = reinterpret_cast<float*>(sW + B1_STAGES * B1_SLICE);  // [KM][2]

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int wg = tid / 128;                            // x channels 64 wg .. +63
  const int nch = (C + B1_KM - 1) / B1_KM;
  const int tile = blockIdx.x / nch;
  const int k0 = (blockIdx.x % nch) * B1_KM;           // this block's x channels
  const bool first = k0 == 0;                          // writes G and dbias sums
  const int b = blockIdx.y;
  const ll row = (ll)b * (gridDim.x / nch) + tile;  // this tile's partial sums
  const ll P = (ll)(gridDim.x / nch) * gridDim.y;      // at part[m * P + row]
  const int p0 = tile * B1_TP;
  const int nks = (np + B1_NS - 1) / B1_NS;

  auto load_slice = [&](int ks) {
    if (ks < nks)
      mma::load_tile_core<B1_KM, B1_NS / 8, B1_THREADS>(
          sW + (ks % B1_STAGES) * B1_SLICE, wt, C, N, k0, ks * B1_NS, vec_w);
    mma::cp_async_commit();  // an empty group past the last slice
  };
  load_slice(0);

  // G = T(dy * mask) for all N outputs of the tile into sG (a warp reads
  // two whole 256-byte rows); the first chunk's block also writes G to
  // gbuf and the tile's sums of dy * mask (unrounded) for dbias
  {
    const mma::u16* dyb = dy + (ll)b * N * hw;
    mma::u16* gb = gbuf + (ll)b * N * hw;
    const int total = np * 16;  // a multiple of the block size
    for (int i0 = tid; i0 < total; i0 += B1_LOADS * B1_THREADS) {
      uint4 raw[B1_LOADS];
      mma::load_chunks<B1_THREADS, B1_LOADS>(raw, i0, total, dyb, hw, N, p0, vec_dy);
#pragma unroll
      for (int u = 0; u < B1_LOADS; ++u) {
        const int i = i0 + u * B1_THREADS;
        if (i >= total) break;  // uniform across the block
        const int n = i / 16;
        const int c = (i % 16) * 8;
        const float m = n < N ? mask[b * N + n] : 0.f;
        const uint32_t w[4] = {raw[u].x, raw[u].y, raw[u].z, raw[u].w};
        uint32_t o[4];
        float sum = 0.f;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int p = p0 + c + 2 * q;
          const float f0 = p < hw ? __fmul_rn(mma::lo_f(w[q]), m) : 0.f;
          const float f1 = p + 1 < hw ? __fmul_rn(mma::hi_f(w[q]), m) : 0.f;
          o[q] = mma::pack_bf16x2(f0, f1);
          sum += f0;
          sum += f1;
        }
        const uint4 v = make_uint4(o[0], o[1], o[2], o[3]);
        *reinterpret_cast<uint4*>(sG + mma::sw128_off(n, c)) = v;
        if (first && n < N) {
          mma::u16* dst = gb + (ll)n * hw + p0 + c;
          if (vec_dy && p0 + c + 8 <= hw) {
            *reinterpret_cast<uint4*>(dst) = v;
          } else {
            const mma::u16* e8 = reinterpret_cast<const mma::u16*>(&v);
            for (int e = 0; e < 8 && p0 + c + e < hw; ++e) dst[e] = e8[e];
          }
        }
        // the 16 lanes of one output row: fixed-order tree
#pragma unroll
        for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
        if (first && lane % 16 == 0 && n < N) part_gp[n * P + row] = sum;
      }
    }
  }

  // D[k, p] = W[k, n] G[n, p]: W K-major (rows k), G MN-major (pixels)
  const bool live = k0 + 64 * wg < C;                  // warpgroup-uniform
  float d[64];
  for (int ks = 0; ks < nks; ++ks) {
    load_slice(ks + 1);
    mma::cp_async_wait<1>();
    mma::fence_async_smem();
    __syncthreads();
    if (live) {
      const mma::u16* ws = sW + (ks % B1_STAGES) * B1_SLICE;
      const int kk_end = min(B1_NS, np - ks * B1_NS);
      mma::wgmma_fence();
      for (int kk = 0; kk < kk_end; kk += 16) {
        const uint64_t da = mma::gmma_desc(
            ws + mma::core_off(64 * wg, kk / 8, B1_NS / 8), 128, B1_NS / 8 * 128);
        const uint64_t db = mma::gmma_desc(sG + mma::sw128_off(ks * B1_NS + kk, 0),
                                           1024, 2048, 1);
        mma::wgmma_m64n128k16<0, 1>(d, da, db, ks > 0 || kk > 0);
      }
      mma::wgmma_commit();
      mma::wgmma_wait0();
    }
    __syncthreads();  // a later load overwrites this slice's buffer
  }

  // epilogue, through a [KM][128] swizzled tile in the weight ring's
  // space: x in with coalesced loads, dseg = T(dz * scale) out in its
  // place, dz = dA * relu'(z); per-tile sums of dz * x and dz
  mma::u16* sX = sW;
  const int total = B1_KM * 16;
  const mma::u16* xb = X + b * x_bstride + (ll)k0 * hw;
  for (int i0 = tid; i0 < total; i0 += B1_LOADS * B1_THREADS) {
    uint4 raw[B1_LOADS];
    mma::load_chunks<B1_THREADS, B1_LOADS>(raw, i0, total, xb, hw, C - k0, p0, vec_x);
#pragma unroll
    for (int u = 0; u < B1_LOADS; ++u) {
      const int i = i0 + u * B1_THREADS;
      if (i < total)
        *reinterpret_cast<uint4*>(sX + mma::swz_off(i / 16, (i % 16) * 8)) = raw[u];
    }
  }
  __syncthreads();
  const int g = lane / 4;
  const int t = lane % 4;
  if (live) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int kl = 64 * wg + 16 * ((tid / 32) % 4) + g + 8 * h;
      const int k = min(k0 + kl, C - 1);  // rows past C are not stored
      const float sc = scale[k];
      const float sf = shift[k];
      float sd = 0.f, sh = 0.f;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int pl = 8 * i + 2 * t;
        uint32_t* cell = reinterpret_cast<uint32_t*>(sX + mma::swz_off(kl, pl));
        const uint32_t x2 = *cell;
        const float xf[2] = {mma::lo_f(x2), mma::hi_f(x2)};
        float o[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float dz = (p0 + pl + e < hw)
              ? __fmul_rn(d[4 * i + 2 * h + e], relu_d(affine(xf[e], sc, sf)))
              : 0.f;
          o[e] = __fmul_rn(dz, sc);
          sd += __fmul_rn(dz, xf[e]);
          sh += dz;
        }
        *cell = mma::pack_bf16x2(o[0], o[1]);
      }
      sd += __shfl_xor_sync(0xffffffffu, sd, 1);
      sh += __shfl_xor_sync(0xffffffffu, sh, 1);
      sd += __shfl_xor_sync(0xffffffffu, sd, 2);
      sh += __shfl_xor_sync(0xffffffffu, sh, 2);
      if (t == 0) {  // one warp owns the whole row
        red[kl * 2] = sd;
        red[kl * 2 + 1] = sh;
      }
    }
  }
  __syncthreads();
  if (tid < B1_KM && k0 + tid < C) {
    part_ds[(k0 + tid) * P + row] = red[tid * 2];
    part_dh[(k0 + tid) * P + row] = red[tid * 2 + 1];
  }
  const int rows = min(B1_KM, C - k0);
  mma::u16* db = dseg + ((ll)b * C + k0) * hw;
  for (int i = tid; i < rows * 16; i += B1_THREADS) {
    const int r = i / 16;
    const int c = (i % 16) * 8;
    const int p = p0 + c;
    const mma::u16* src = sX + mma::swz_off(r, c);
    mma::u16* dst = db + (ll)r * hw + p;
    if (vec_dseg && p + 8 <= hw) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int e = 0; e < 8 && p + e < hw; ++e) dst[e] = src[e];
    }
  }
}

__global__ void __launch_bounds__(B1_THREADS, 2)
bwd1x1_wgrad_mma_kernel(const mma::u16* X, ll x_bstride, int C, int B, int hw,
                        const float* __restrict__ scale,
                        const float* __restrict__ shift,
                        const mma::u16* __restrict__ G, int N, int S,
                        float* __restrict__ part, int vec_x, int vec_g) {
  extern __shared__ __align__(128) unsigned char smem[];
  mma::u16* sA = reinterpret_cast<mma::u16*>(smem);   // [KM][LDP]
  mma::u16* sG = sA + B1_KM * B1_LDP;                  // [KM][LDP]
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int k0 = blockIdx.x * B1_KM;
  const int n0 = blockIdx.y * B1_KM;
  const int split = blockIdx.z;
  const int ptiles = (hw + B1_PS - 1) / B1_PS;
  const int items = B * ptiles;
  const int per = (items + S - 1) / S;
  const int i_begin = min(items, split * per);
  const int i_end = min(items, i_begin + per);
  const int am0 = (warp / 4) * 64;   // x channels
  const int bn0 = (warp % 4) * 32;   // outputs
  const bool live = k0 + am0 < C && n0 + bn0 < N;
  const uint32_t a_sm = mma::smem_u32(sA);
  const uint32_t g_sm = mma::smem_u32(sG);
  float acc[4][4][4];
  mma::zero_acc(acc);
  for (int it = i_begin; it < i_end; ++it) {
    const int b = it / ptiles;
    const int pp = (it % ptiles) * B1_PS;
    mma::stage_rows<true, B1_PS, B1_THREADS>(sA, B1_LDP, B1_KM,
                                             X + b * x_bstride + (ll)k0 * hw, hw,
                                             C - k0, pp, scale + k0, shift + k0,
                                             vec_x);
    mma::stage_rows<false, B1_PS, B1_THREADS>(sG, B1_LDP, B1_KM,
                                              G + ((ll)b * N + n0) * hw, hw,
                                              N - n0, pp, nullptr, nullptr, vec_g);
    __syncthreads();
    if (live) {
#pragma unroll
      for (int kk = 0; kk < B1_PS; kk += 16)
        mma::warp_mma_k16<false, false>(acc, a_sm, B1_LDP, am0, kk, g_sm, B1_LDP,
                                        bn0, kk);
    }
    __syncthreads();
  }
  if (!live) return;
  const int g = lane / 4;
  const int t = lane % 4;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = k0 + am0 + 16 * mt + g + 8 * h;
      if (k >= C) continue;
      float* dst = part + ((ll)split * C + k) * N;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int n = n0 + bn0 + 8 * nt + 2 * t;
        if (n < N) dst[n] = acc[mt][nt][2 * h];
        if (n + 1 < N) dst[n + 1] = acc[mt][nt][2 * h + 1];
      }
    }
}

// K2 for bf16 and one tap.  Scratch: part_gp [N][P], part_ss [2][C][P]
// (column-major: reduce_cols), part_w [S][C * N], with P = B * ceil(H*W /
// 128); gbuf [B, N, H, W].
cudaError_t bwd1x1_mma(const void* X, ll x_bstride, int B, int C, int H, int W,
                       const float* scale, const float* shift, const void* wt,
                       const float* mask, int N, const void* dy, void* dseg,
                       float* dscale, float* dshift, float* dw, float* dbias,
                       void* gbuf, float* part_gp, float* part_ss, float* part_w,
                       int S, cudaStream_t s) {
  const int hw = H * W;
  const int tiles = (hw + B1_TP - 1) / B1_TP;
  const int P = B * tiles;
  const size_t smem = b1_dgrad_smem(N);
  const int vec_dy = hw % 8 == 0 && mma::aligned16(dy) && mma::aligned16(gbuf);
  const int vec_w = N % 8 == 0 && mma::aligned16(wt);
  const int vec_x = hw % 8 == 0 && x_bstride % 8 == 0 && mma::aligned16(X);
  const int vec_dseg = hw % 8 == 0 && mma::aligned16(dseg);
  float* part_ds = part_ss;
  float* part_dh = part_ss + (ll)P * C;
  const int nch = (C + B1_KM - 1) / B1_KM;
  bwd1x1_dgrad_mma_kernel<<<dim3(tiles * nch, B), B1_THREADS, smem, s>>>(
      static_cast<const mma::u16*>(X), x_bstride, C, hw, scale, shift,
      static_cast<const mma::u16*>(wt), mask, N, static_cast<const mma::u16*>(dy),
      static_cast<mma::u16*>(gbuf), static_cast<mma::u16*>(dseg), part_gp, part_ds,
      part_dh, vec_dy, vec_w, vec_x, vec_dseg);
  S2R_TRY(cudaGetLastError());
  const int vec_g = hw % 8 == 0 && mma::aligned16(gbuf);
  const dim3 grid((C + B1_KM - 1) / B1_KM, (N + B1_KM - 1) / B1_KM, S);
  const int wsmem = 2 * 2 * B1_KM * B1_LDP;
  bwd1x1_wgrad_mma_kernel<<<grid, B1_THREADS, wsmem, s>>>(
      static_cast<const mma::u16*>(X), x_bstride, C, B, hw, scale, shift,
      static_cast<const mma::u16*>(gbuf), N, S, part_w, vec_x, vec_g);
  S2R_TRY(cudaGetLastError());
  S2R_TRY(reduce_cols(part_gp, P, N, dbias, s));
  S2R_TRY(reduce_cols(part_ds, P, C, dscale, s));
  S2R_TRY(reduce_cols(part_dh, P, C, dshift, s));
  return reduce_rows(part_w, S, (ll)C * N, dw, s);
}

// ---------------------------------------------------------------------------
// K1 (3x3), K3a and K3b, bfloat16, growth G = 12 or 16, on the tensor cores.
//
// Replace, for the bf16 dense layers (growth 12 and 16), the TPU kernels K1
// (tiramisu_train_pallas.py _fwd_kernel, pallas_call at :187), K3a
// (_stage_kernel, pallas_call at :759) and K3b (_final_kernel, :854).
//
// What bounds them on an H100: a layer launch does 144 multiply-adds per
// input value against 16 outputs, so per byte it is below the ~295
// operations at which the tensor cores become the limit: by the roofline
// they are bound by bytes (the B=32 step's 55 forwards must move 3.8 GB,
// 1.1 ms at 3.35 TB/s, for 438 GFLOP).  The CUDA-core kernels they replace
// were far from that: bound by f32 FMA issue and shared-memory loads.
// With 16 outputs no tensor-core instruction reaches the card's peak (a
// wgmma of 64 x 16 leaves most of its width idle), so the design aims at
// the cuDNN call, not the bound.
//
// Which instruction and why: mma.sync m16n8k16 (bf16 in, f32 sums) fed by
// ldmatrix.  The nine taps shift the activation by whole pixels; with the
// operands staged as [pixel][channel] tiles (bnrelu_mma.cuh) a shift is a
// row offset, every ldmatrix row stays 16-byte aligned, and one staged
// tile (one-pixel halo) serves all nine taps.  wgmma would need the same
// layout through descriptors and gains nothing at N = 16.
//
// - fwd3x3_mma_kernel (K1): the 3x3 forward body of dense3x3_mma.cuh,
//   which serving's dense3x3_mma_kernel shares: a 12 x 16 pixel tile of
//   one image and all 16 outputs, 32-channel chunks through two buffers,
//   the channel loop split across a thread-block cluster at small planes;
//   it writes T((D + bias) * mask) in place.
// - sum_dgrad_mma_kernel (K3a's rebuild of dy_j, and K3b): per layer l,
//   dA_l[q, k] = sum_{t,o} G_l[q - off_t, o] W_l[k, t, o] on 16 channels k
//   at a time (the G tiles are staged as stored, no conversion, once per
//   block and up to five layers at once), then in f32 tot += dA_l relu'(z_l)
//   scale_l.  K3a: the 16 channels of y_j; g_pre = (ext + tot) * mask is
//   stored rounded, with its per-tile sums for dbias.  K3b: the block's
//   c_in input channels in groups of 16 inside the block (weight rows
//   stream through two cp.async buffers), T(tot) stored.
// - stage_own_mma_kernel (K3a, own layer): a block owns a chunk of up to 64
//   input channels and a range of (image, tile) items; the chunk's weights
//   stay in shared memory.  Per item it stages x once with its halo (raw
//   and as a = T(relu(BN(x)))) and the G tile, and computes both products
//   from them: the input cotangent dA[q, k] (same product as above; its
//   epilogue takes relu'(z) and sums dz x and dz, nothing is stored) and
//   the weight cotangent dW[k, t, o] += a[q + off_t, k] G[q, o] (pixels
//   contracted, 16 pixels a step), whose sums stay in registers across
//   the block's items.  g_pre must be complete before this kernel reads
//   its halo: that is the launch boundary between the two kernels.
// - Sums over the batch are per-block partials (one row per split, in item
//   order) and per-tile partials for dbias, added by stage_reduce_kernel
//   in a fixed order: deterministic, no atomics; one reduce launch a stage.
// Growth 12 (FCDenseNet57) runs the same code with G = 12: the products
// keep 16 columns (mma.sync has no n4; the weights come padded to
// [K][9][16] with zero columns, kernels/train_block.py), so the forward's
// and the weight cotangent's columns 12-15 are dead and neither stored nor
// reduced; on the k side of the input cotangent a layer's 12 cotangent
// channels fill a 16-row k slot whose rows 12-15 are staged as zeros
// (stage_px_tile with nvalid = G), one k16 step a tap as at 16.  Stored
// cotangents, masks and dW are [.][G]: a layer's G channels, unpadded.
// The 3x5 bottleneck and the other small planes leave most of a 12 x 16
// tile idle (one image a tile, no packing): they hold 2% of the work.  Of
// these kernels only the forward splits its channel loop there.
// ---------------------------------------------------------------------------
constexpr int TD_MAX_K = 768;  // K1 with one tap: the x tile of td_fwd_mma.cuh fits
using mma::C3_MT;
constexpr int GP_L = 5;                               // layers staged at once
constexpr int GP_LD = mma::C3_N + 8;
constexpr int GP_SG = mma::C3_HPX * GP_LD;
constexpr int GP_SW = mma::C3_N * mma::C3_WLD;
constexpr int GP_SMEM = 2 * GP_L * (GP_SG + 2 * GP_SW) + 4 * mma::C3_WARPS * mma::C3_N;

int gp_smem(int ns) {  // for ns layers staged at once
  return 2 * ns * (GP_SG + 2 * GP_SW) + 4 * mma::C3_WARPS * mma::C3_N;
}
constexpr int OW_KC = 64;                             // channels per own-layer chunk
constexpr int OW_LD = OW_KC + 8;
constexpr int OW_SX = mma::C3_HPX * OW_LD;
constexpr int OW_SW = OW_KC * mma::C3_WLD;
constexpr int OW_UPW = (OW_KC / 16) * 3 / mma::C3_WARPS;  // (16 channels, ky) units per warp
constexpr int OW_SMEM = 2 * (2 * OW_SX + GP_SG + OW_SW) + 4 * mma::C3_WARPS * OW_KC * 2;

// the own-layer kernel's channel chunks: 16-channel units per chunk
int ow_units(int C) {
  const int n16 = (C + 15) / 16;
  const int chunks = (n16 + OW_KC / 16 - 1) / (OW_KC / 16);
  return (n16 + chunks - 1) / chunks;
}

// K1's 3x3 forward: the shared body of dense3x3_mma.cuh with the mask
template <int G>
__global__ void __launch_bounds__(mma::C3_THREADS, 3)
fwd3x3_mma_kernel(const mma::u16* X, ll x_bstride, int K, int H, int W,
                  const float* __restrict__ scale, const float* __restrict__ shift,
                  const mma::u16* __restrict__ wt, const float* __restrict__ bias,
                  const float* __restrict__ mask, mma::u16* out, ll out_bstride,
                  int pair) {
  s2r_d3::fwd3x3_body<G, true>(X, x_bstride, K, H, W, scale, shift, wt, bias, mask, out,
                               out_bstride, pair);
}

// K3a's rebuild of dy_j (C = G, ext and mask given, groups = 1) and K3b
// (C = c_in, neither): out = T((ext + sum_l dA_l relu'(z_l) scale_l) * mask)
// over channels [0, C) of X.  A block owns a pixel tile of one image and
// `groups` consecutive 16-channel groups from blockIdx.z * groups on.  The
// layers' G tiles ([B][G] planes each) are staged once per block, ns =
// min(nl, GP_L) at a time; each group's weight rows stream through two
// buffers.  More layers than GP_L need groups = 1 (the sums then stay in
// registers across the rounds).
template <int G>
__global__ void __launch_bounds__(mma::C3_THREADS, 2)
sum_dgrad_mma_kernel(const mma::u16* X, ll x_bstride, int C, int H, int W,
                     const float* __restrict__ ext, int nl, Layers L,
                     const float* __restrict__ mask, mma::u16* out,
                     float* __restrict__ part_gp, int groups, int ns, int pair) {
  extern __shared__ __align__(128) unsigned char smem[];
  mma::u16* sG = reinterpret_cast<mma::u16*>(smem);   // [ns][halo px][GP_LD]
  mma::u16* sW = sG + ns * GP_SG;                      // [2][ns][16][C3_WLD]
  float* red = reinterpret_cast<float*>(sW + 2 * ns * GP_SW);  // [warps][16]
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const mma::C3Lane ln(tid % 32);
  const int tiles_x = mma::c3_tiles_x(W);
  const int ty0 = (blockIdx.x / tiles_x) * mma::C3_TH;
  const int tx0 = (blockIdx.x % tiles_x) * mma::C3_TW;
  const int b = blockIdx.y;
  const int hw = H * W;
  const ll P = (ll)gridDim.x * gridDim.y;
  const ll row = (ll)b * gridDim.x + blockIdx.x;
  const int ncg = (C + mma::C3_N - 1) / mma::C3_N;
  const int cg_begin = blockIdx.z * groups;
  const int cg_end = min(ncg, cg_begin + groups);

  // this lane's accumulator positions: pixel (row y of warp, g + 8 (e / 2)),
  // channel 16 cg + 8 nt + 2 t + e % 2
  float tot[C3_MT][2][4];
  float xv[C3_MT][2][4];

  for (int l0 = 0; l0 < nl || l0 == 0; l0 += GP_L) {
    const int n_here = min(GP_L, nl - l0);
    auto load_w = [&](int cg, int buf) {
      for (int i = 0; i < n_here; ++i)
        mma::load_w3_rows<mma::C3_THREADS>(sW + (buf * ns + i) * GP_SW,
                                           static_cast<const mma::u16*>(L.w[l0 + i]), C,
                                           cg * mma::C3_N, mma::C3_N);
      mma::cp_async_commit();
    };
    load_w(cg_begin, 0);
    for (int i = 0; i < n_here; ++i)
      mma::stage_px_tile<false, false, 2, mma::C3_THREADS>(
          sG + i * GP_SG, nullptr, GP_LD, mma::C3_N / 8,
          static_cast<const mma::u16*>(L.g[l0 + i]) + (ll)b * G * hw, hw, H, W, ty0, tx0,
          G, nullptr, nullptr, pair);
    for (int cg = cg_begin; cg < cg_end; ++cg) {
      const int buf = (cg - cg_begin) & 1;
      const int c0 = cg * mma::C3_N;
      if (l0 == 0) {
#pragma unroll
        for (int m = 0; m < C3_MT; ++m) {
          const int gy = ty0 + warp + m * mma::C3_WARPS;
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int gx = tx0 + ln.g + 8 * (e / 2);
              const int n = c0 + 8 * nt + 2 * ln.t + (e & 1);
              const bool in = gy < H && gx < W && n < C;
              const ll pix = (ll)n * hw + gy * W + gx;
              xv[m][nt][e] = in ? mma::bf(X[b * x_bstride + pix]) : 0.f;
              tot[m][nt][e] = (in && ext != nullptr) ? ext[(ll)b * C * hw + pix] : 0.f;
            }
        }
      }
      mma::cp_async_wait<0>();
      __syncthreads();  // this group's weights (and the G tiles) are staged
      if (cg + 1 < cg_end) load_w(cg + 1, buf ^ 1);
      for (int i = 0; i < n_here; ++i) {
        const uint32_t g_sm = mma::smem_u32(sG + i * GP_SG);
        const uint32_t w_sm = mma::smem_u32(sW + (buf * ns + i) * GP_SW);
        float acc[C3_MT][2][4];
#pragma unroll
        for (int m = 0; m < C3_MT; ++m)
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[m][nt][e] = 0.f;
#pragma unroll
        for (int t = 0; t < 9; ++t) {
          uint32_t bq[4];  // W_l[k, t, o]: stored [k][o], o is the depth
          mma::ldsm_x4(bq, w_sm + 2u * (uint32_t)((ln.r8 + 8 * ln.j1) * mma::C3_WLD +
                                                  t * mma::C3_N + 8 * ln.j0));
#pragma unroll
          for (int m = 0; m < C3_MT; ++m) {
            const int y = warp + m * mma::C3_WARPS;
            uint32_t af[4];  // G_l[q - off_t, o]: stored [pixel][o]
            mma::ldsm_x4(af, g_sm + 2u * (uint32_t)(mma::c3_tap_t(y, ln.r8 + 8 * ln.j0, t / 3,
                                                                  t % 3) * GP_LD + 8 * ln.j1));
            mma::mma_16816(acc[m][0], af, bq[0], bq[1]);
            mma::mma_16816(acc[m][1], af, bq[2], bq[3]);
          }
        }
        const float* sc = L.sc[l0 + i];
        const float* sh = L.sh[l0 + i];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int n = min(c0 + 8 * nt + 2 * ln.t + j, C - 1);
            const float scv = sc[n];
            const float shv = sh[n];
#pragma unroll
            for (int m = 0; m < C3_MT; ++m)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int e = 2 * h + j;
                const float z = affine(xv[m][nt][e], scv, shv);
                tot[m][nt][e] = __fadd_rn(
                    tot[m][nt][e], __fmul_rn(__fmul_rn(acc[m][nt][e], relu_d(z)), scv));
              }
          }
      }
      if (l0 + GP_L < nl) continue;  // more layers to come (groups == 1)

      // out = T(tot * mask); per-tile sums of the unrounded product
      float s[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
      for (int m = 0; m < C3_MT; ++m) {
        const int gy = ty0 + warp + m * mma::C3_WARPS;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int gx = tx0 + ln.g + 8 * (e / 2);
            const int n = c0 + 8 * nt + 2 * ln.t + (e & 1);
            if (gy < H && gx < W && n < C) {
              const float v = mask != nullptr ? __fmul_rn(tot[m][nt][e], mask[b * C + n])
                                              : tot[m][nt][e];
              out[((ll)b * C + n) * hw + gy * W + gx] = mma::to_bf(v);
              s[nt][e & 1] += v;
            }
          }
      }
      if (part_gp != nullptr) {  // block-uniform
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            float v = s[nt][j];
            v += __shfl_xor_sync(0xffffffffu, v, 4);
            v += __shfl_xor_sync(0xffffffffu, v, 8);
            v += __shfl_xor_sync(0xffffffffu, v, 16);
            if (ln.g == 0) red[warp * mma::C3_N + 8 * nt + 2 * ln.t + j] = v;
          }
        __syncthreads();
        if (tid < mma::C3_N && c0 + tid < C) {
          float v = 0.f;
          for (int w = 0; w < mma::C3_WARPS; ++w) v += red[w * mma::C3_N + tid];
          part_gp[(c0 + tid) * P + row] = v;
        }
      }
    }
    __syncthreads();  // the next round overwrites the tiles
  }
}

template <int G>
__global__ void __launch_bounds__(mma::C3_THREADS, 2)
stage_own_mma_kernel(const mma::u16* X, ll x_bstride, int C, int B, int H, int W,
                     const float* __restrict__ scale, const float* __restrict__ shift,
                     const mma::u16* __restrict__ wt, const mma::u16* __restrict__ gp,
                     int nu, int S, float* __restrict__ part, int pair_x, int pair_g) {
  extern __shared__ __align__(128) unsigned char smem[];
  mma::u16* sX = reinterpret_cast<mma::u16*>(smem);   // x:  [halo px][OW_LD]
  mma::u16* sA = sX + OW_SX;                           // a:  [halo px][OW_LD]
  mma::u16* sG = sA + OW_SX;                           // G:  [halo px][GP_LD]
  mma::u16* sW = sG + GP_SG;                           // W:  [OW_KC][C3_WLD]
  float* red = reinterpret_cast<float*>(sW + OW_SW);   // [warps][OW_KC][2]
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const mma::C3Lane ln(tid % 32);
  const int k0 = blockIdx.x * nu * 16;
  const int split = blockIdx.y;
  const int hw = H * W;
  const int tiles_x = mma::c3_tiles_x(W);
  const int tiles = mma::c3_tiles(H, W);
  const int items = B * tiles;
  const int per = (items + S - 1) / S;
  const int i_begin = min(items, split * per);
  const int i_end = min(items, i_begin + per);
  const ll MW = (ll)C * (9 * G + 2);                   // a partial row: dW, dscale, dshift

  mma::load_w3_rows<mma::C3_THREADS>(sW, wt, C, k0, nu * 16);
  mma::cp_async_commit();
  for (int i = tid; i < mma::C3_WARPS * OW_KC * 2; i += mma::C3_THREADS) red[i] = 0.f;

  float accw[OW_UPW][3][2][4];  // dW of this warp's (16 channels, ky) units
#pragma unroll
  for (int q = 0; q < OW_UPW; ++q)
#pragma unroll
    for (int kx = 0; kx < 3; ++kx)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) accw[q][kx][nt][e] = 0.f;

  const uint32_t a_sm = mma::smem_u32(sA);
  const uint32_t g_sm = mma::smem_u32(sG);
  const uint32_t w_sm = mma::smem_u32(sW);
  for (int item = i_begin; item < i_end; ++item) {
    const int b = item / tiles;
    const int tile = item - b * tiles;
    const int ty0 = (tile / tiles_x) * mma::C3_TH;
    const int tx0 = (tile % tiles_x) * mma::C3_TW;
    mma::stage_px_tile<true, true, 3, mma::C3_THREADS>(
        sA, sX, OW_LD, 2 * nu, X + b * x_bstride + (ll)k0 * hw, hw, H, W, ty0, tx0,
        C - k0, scale + k0, shift + k0, pair_x);
    mma::stage_px_tile<false, false, 2, mma::C3_THREADS>(
        sG, nullptr, GP_LD, mma::C3_N / 8, gp + (ll)b * G * hw, hw, H, W, ty0, tx0, G,
        nullptr, nullptr, pair_g);
    mma::cp_async_wait<0>();
    __syncthreads();

    // input cotangent: dA[q, k] = sum_{t,o} G[q - off_t, o] W[k, t, o];
    // dz = dA relu'(z); sums of dz x and dz per channel
    for (int u = 0; u < nu; ++u) {
      float scv[2][2], shv[2][2];
      bool live[2][2];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int k = k0 + 16 * u + 8 * nt + 2 * ln.t + j;
          live[nt][j] = k < C;
          scv[nt][j] = scale[min(k, C - 1)];
          shv[nt][j] = shift[min(k, C - 1)];
        }
      float sd[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
      float sz[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
      for (int m = 0; m < C3_MT; ++m) {
        const int y = warp + m * mma::C3_WARPS;
        float acc[2][4];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
#pragma unroll
        for (int t = 0; t < 9; ++t) {
          uint32_t bq[4], af[4];
          mma::ldsm_x4(bq, w_sm + 2u * (uint32_t)((16 * u + ln.r8 + 8 * ln.j1) * mma::C3_WLD +
                                                  t * mma::C3_N + 8 * ln.j0));
          mma::ldsm_x4(af, g_sm + 2u * (uint32_t)(mma::c3_tap_t(y, ln.r8 + 8 * ln.j0, t / 3, t % 3) *
                                                      GP_LD + 8 * ln.j1));
          mma::mma_16816(acc[0], af, bq[0], bq[1]);
          mma::mma_16816(acc[1], af, bq[2], bq[3]);
        }
        const int gy = ty0 + y;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int px = ln.g + 8 * (e / 2);
            const int j = e & 1;
            const int ch = 16 * u + 8 * nt + 2 * ln.t + j;
            const float xf = mma::bf(sX[((y + 1) * mma::C3_HW + px + 1) * OW_LD + ch]);
            const bool in = gy < H && tx0 + px < W && live[nt][j];
            const float dz =
                in ? __fmul_rn(acc[nt][e], relu_d(affine(xf, scv[nt][j], shv[nt][j]))) : 0.f;
            sd[nt][j] += __fmul_rn(dz, xf);
            sz[nt][j] += dz;
          }
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float v = sd[nt][j];
          float z = sz[nt][j];
#pragma unroll
          for (int off = 4; off < 32; off <<= 1) {
            v += __shfl_xor_sync(0xffffffffu, v, off);
            z += __shfl_xor_sync(0xffffffffu, z, off);
          }
          if (ln.g == 0) {  // this lane's own slots: a running sum over the items
            float* r = red + (warp * OW_KC + 16 * u + 8 * nt + 2 * ln.t + j) * 2;
            r[0] += v;
            r[1] += z;
          }
        }
    }

    // weight cotangent: dW[k, t, o] += sum_q a[q + off_t, k] G[q, o], one
    // row of 16 pixels a step
#pragma unroll
    for (int q = 0; q < OW_UPW; ++q) {
      const int idx = warp + q * mma::C3_WARPS;  // (16-channel unit, ky)
      if (idx < 3 * nu) {                        // warp-uniform
        const int mt = idx / 3;
        const int ky = idx % 3;
        for (int y = 0; y < mma::C3_TH; ++y) {
          uint32_t bq[4];  // G[q, o]: stored [pixel][o], pixels are the depth
          mma::ldsm_x4_t(bq, g_sm + 2u * (uint32_t)(mma::c3_tap(y, ln.r8 + 8 * ln.j0, 1, 1) *
                                                        GP_LD + 8 * ln.j1));
#pragma unroll
          for (int kx = 0; kx < 3; ++kx) {
            uint32_t af[4];  // a[q + off_t, k]: stored [pixel][k]
            mma::ldsm_x4_t(af, a_sm + 2u * (uint32_t)(mma::c3_tap(y, ln.r8 + 8 * ln.j1, ky, kx) *
                                                          OW_LD + 16 * mt + 8 * ln.j0));
            mma::mma_16816(accw[q][kx][0], af, bq[0], bq[1]);
            mma::mma_16816(accw[q][kx][1], af, bq[2], bq[3]);
          }
        }
      }
    }
    __syncthreads();  // the next item overwrites the tiles
  }

  float* prow = part + (ll)split * MW;
#pragma unroll
  for (int q = 0; q < OW_UPW; ++q) {
    const int idx = warp + q * mma::C3_WARPS;
    if (idx >= 3 * nu) continue;
    const int mt = idx / 3;
    const int ky = idx % 3;
#pragma unroll
    for (int kx = 0; kx < 3; ++kx)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int k = k0 + 16 * mt + ln.g + 8 * (e / 2);
          const int o = 8 * nt + 2 * ln.t + (e & 1);
          if (k < C && (G == mma::C3_N || o < G))
            prow[((ll)k * 9 + ky * 3 + kx) * G + o] = accw[q][kx][nt][e];
        }
  }
  __syncthreads();  // red is complete (and zeroed, for a block without items)
  if (tid < nu * 16 && k0 + tid < C) {
    float v = 0.f, z = 0.f;
    for (int w = 0; w < mma::C3_WARPS; ++w) {
      v += red[(w * OW_KC + tid) * 2];
      z += red[(w * OW_KC + tid) * 2 + 1];
    }
    prow[(ll)C * 9 * G + k0 + tid] = v;
    prow[(ll)C * 9 * G + C + k0 + tid] = z;
  }
}

// One launch for a stage's sums: out[m] = sum_s part[s][m] for m < M (dW,
// dscale, dshift), and out[M + n] = sum_r part_gp[n * P + r] for n < G
// (dbias).
__global__ void __launch_bounds__(THREADS)
stage_reduce_kernel(const float* __restrict__ part, int S, ll M,
                    const float* __restrict__ part_gp, int P, int G, int row_blocks,
                    float* __restrict__ out) {
  if ((int)blockIdx.x < row_blocks)
    reduce_rows_body(part, S, M, out, blockIdx.x);
  else
    reduce_cols_body(part_gp, P, G, out + M, blockIdx.x - row_blocks);
}

template <int G>
cudaError_t setup_growth() {
  S2R_TRY(cudaFuncSetAttribute(fwd3x3_mma_kernel<G>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, s2r_d3::SMEM));
  S2R_TRY(cudaFuncSetAttribute(sum_dgrad_mma_kernel<G>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, GP_SMEM));
  return cudaFuncSetAttribute(stage_own_mma_kernel<G>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, OW_SMEM);
}

// The shared-memory limits of every tensor-core kernel, set once when the
// library loads (s2r_train_init): no launch calls cudaFuncSetAttribute, so
// a launch inside a CUDA-graph capture records kernels only.
cudaError_t setup_all() {
  S2R_TRY(setup_growth<12>());
  S2R_TRY(setup_growth<16>());
  S2R_TRY(cudaFuncSetAttribute(bwd1x1_dgrad_mma_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, B1_SMEM_MAX));
  S2R_TRY(cudaFuncSetAttribute(bwd1x1_wgrad_mma_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, B1_SMEM_MAX));
  int sms = 0;
  return s2r_td::td_setup(&sms);
}

// K1, bf16, 3x3, G outputs
template <int G>
cudaError_t fwd3x3_mma(const void* X, ll x_bstride, int B, int K, int H, int W,
                       const float* scale, const float* shift, const void* wt,
                       const float* bias, const float* mask, void* out,
                       ll out_bstride, cudaStream_t s) {
  return s2r_d3::launch_fwd3x3(fwd3x3_mma_kernel<G>, X, x_bstride, B, K, H, W, scale, shift,
                               wt, bias, mask, out, out_bstride, s);
}

// the summed input cotangent over channels [0, C) of X (K3a's rebuild, K3b)
template <int G>
cudaError_t sum_dgrad_mma(const void* X, ll x_bstride, int B, int C, int H, int W,
                          const float* ext, int nl, const Layers& L,
                          const float* mask, void* out, float* part_gp,
                          cudaStream_t s) {
  for (int l = 0; l < nl; ++l)
    if (!mma::aligned16(L.w[l])) return cudaErrorMisalignedAddress;
  const int tiles = mma::c3_tiles(H, W);
  const int ncg = (C + mma::C3_N - 1) / mma::C3_N;
  // enough blocks for two per SM of an H100 (264), as few as that allows:
  // every block stages the G tiles again
  int zb = 1;
  if (nl > GP_L) zb = ncg;
  else if (B * tiles < 264) zb = std::min(ncg, (264 + B * tiles - 1) / (B * tiles));
  const int groups = (ncg + zb - 1) / zb;
  zb = (ncg + groups - 1) / groups;
  const int ns = std::max(1, std::min(nl, GP_L));
  bool pair = true;  // every layer's G is a contiguous [B, G, H, W]
  for (int l = 0; l < nl; ++l) pair = pair && mma::c3_pair_loads(W, 0, L.g[l]);
  sum_dgrad_mma_kernel<G><<<dim3(tiles, B, zb), mma::C3_THREADS, gp_smem(ns), s>>>(
      static_cast<const mma::u16*>(X), x_bstride, C, H, W, ext, nl, L, mask,
      static_cast<mma::u16*>(out), part_gp, groups, ns, pair);
  return cudaGetLastError();
}

// K3a, bf16, G outputs.  res: [K * 9G dW | K dscale | K dshift | G dbias];
// scratch part_gp [G][B * tiles] (tiles of 12 x 16 pixels), part_w
// [S][K * (9G + 2)].
template <int G>
cudaError_t stage_mma(const void* X, ll x_bstride, int B, int K, int H, int W,
                      const void* Y, ll y_bstride, const float* ext, int nl,
                      const Layers& L, const void* wt, const float* scale,
                      const float* shift, const float* mask, void* gp_out,
                      float* res, float* part_gp, float* part_w, int S,
                      cudaStream_t s) {
  if (!mma::aligned16(wt) || S < 1) return cudaErrorMisalignedAddress;
  const int tiles = mma::c3_tiles(H, W);
  S2R_TRY(sum_dgrad_mma<G>(Y, y_bstride, B, G, H, W, ext, nl, L, mask, gp_out, part_gp,
                           s));
  const int nu = ow_units(K);
  const int chunks = (K + 16 * nu - 1) / (16 * nu);
  stage_own_mma_kernel<G><<<dim3(chunks, S), mma::C3_THREADS, OW_SMEM, s>>>(
      static_cast<const mma::u16*>(X), x_bstride, K, B, H, W, scale, shift,
      static_cast<const mma::u16*>(wt), static_cast<const mma::u16*>(gp_out), nu, S,
      part_w, mma::c3_pair_loads(W, x_bstride, X), mma::c3_pair_loads(W, 0, gp_out));
  S2R_TRY(cudaGetLastError());
  const ll M = (ll)K * (9 * G + 2);
  const int row_blocks = (int)((M + 31) / 32);
  const int col_blocks = (G + WARPS - 1) / WARPS;
  stage_reduce_kernel<<<row_blocks + col_blocks, THREADS, 0, s>>>(
      part_w, S, M, part_gp, B * tiles, G, row_blocks, res);
  return cudaGetLastError();
}

// the growths the tensor-core dense-layer kernels are built for
bool mma_growth(int g) { return g == 12 || g == mma::C3_N; }

Layers make_layers(int n, const void* const* gps, const void* const* ws,
                   const float* const* scs, const float* const* shs) {
  Layers L = {};
  for (int l = 0; l < n; ++l) {
    L.g[l] = gps[l];
    L.w[l] = ws[l];
    L.sc[l] = scs[l];
    L.sh[l] = shs[l];
  }
  return L;
}

template <typename T>
cudaError_t stage(const void* X, ll x_bstride, int B, int K, int H, int W,
                  const void* Y, ll y_bstride, int G, const float* ext, int nl,
                  const Layers& L, const void* wt, const float* scale,
                  const float* shift, const float* mask, void* gp_out,
                  float* dw, float* dscale, float* dshift, float* dbias,
                  float* part_gp, float* part_ss, float* part_w, int S,
                  cudaStream_t s) {
  S2R_TRY((launch_dgrad<T, 9, true>(Y, y_bstride, B, G, H, W, G, nl, L, ext,
                                    mask, gp_out, part_gp, nullptr, s)));
  S2R_TRY(reduce_rows(part_gp, B * n_tiles(H, W), G, dbias, s));
  return own_layer<T, 9>(X, x_bstride, B, K, H, W, scale, shift, wt, G, gp_out,
                         nullptr, dscale, dshift, dw, part_ss, part_w, S, s);
}

}  // namespace

// Plain C interface, bound with ctypes.  dtype: 0 = float32, 1 = bfloat16.
// Each returns the cudaError_t of its launches (0 on success); an unknown
// dtype, tap count or layer count returns cudaErrorInvalidValue.  *route
// receives the route taken: 1 for the tensor cores, 0 for the CUDA cores.
// Scratch (gbuf, part_*) is allocated by the caller:
//   part_gp  [B * N] floats (bwd) or [B * tiles * G] (stage)
//   part_ss  [2 * B * tiles * K]   part_w [S * K * taps * N]
// Dispatch (mirrored by takes_mma_fwd, takes_mma_bwd and takes_mma_stage in
// kernels/train_block.py): bfloat16 fwd with 9 taps and N = 12 or 16, or
// one tap and K <= 768, and bfloat16 stage and final with G = 12 or 16 run
// on the tensor cores.  Their 3x3 weights (wt, w_slices) are [.][9][16],
// rows 288 bytes apart, columns N-15 (G-15) zero.
// That stage wants dw [K * 9 * G], dscale, dshift, dbias contiguous in this
// order, part_gp [G * B * t3] and part_w [S * K * (9G + 2)] with t3 =
// ceil(H/12) * ceil(W/16), and leaves part_ss unused.  Everything else runs the
// CUDA-core kernels,
// with tiles = ceil(H/16) * ceil(W/16), except for bfloat16 bwd with one
// tap and N <= 624 (bwd1x1_mma): part_gp [B * t1 * N], part_ss
// [2 * B * t1 * K], part_w [S * K * N] with t1 = ceil(H*W / 128).

extern "C" int s2r_train_fwd(int dtype, int taps, const void* X, ll x_bstride,
                             int B, int K, int H, int W, const float* scale,
                             const float* shift, const void* wt,
                             const float* bias, const float* mask, int N,
                             void* out, ll out_bstride, int* route,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  *route = 0;
  if (dtype == 0 && taps == 9)
    return fwd<float, 9>(X, x_bstride, B, K, H, W, scale, shift, wt, bias, mask, N,
                         out, out_bstride, s);
  if (dtype == 0 && taps == 1)
    return fwd<float, 1>(X, x_bstride, B, K, H, W, scale, shift, wt, bias, mask, N,
                         out, out_bstride, s);
  if (dtype == 1 && taps == 9 && mma_growth(N)) {
    *route = 1;
    return (N == 12 ? fwd3x3_mma<12> : fwd3x3_mma<16>)(X, x_bstride, B, K, H, W, scale,
                                                      shift, wt, bias, mask, out,
                                                      out_bstride, s);
  }
  if (dtype == 1 && taps == 9)
    return fwd<__nv_bfloat16, 9>(X, x_bstride, B, K, H, W, scale, shift, wt, bias,
                                 mask, N, out, out_bstride, s);
  if (dtype == 1 && taps == 1 && K <= TD_MAX_K) {
    *route = 1;
    return s2r_td::launch_td_mma(X, x_bstride, B, K, H, W, scale, shift, wt, bias, N,
                                 out, out_bstride, 0, mask, s);
  }
  if (dtype == 1 && taps == 1)
    return fwd<__nv_bfloat16, 1>(X, x_bstride, B, K, H, W, scale, shift, wt, bias,
                                 mask, N, out, out_bstride, s);
  return cudaErrorInvalidValue;
}

extern "C" int s2r_train_bwd(int dtype, int taps, const void* X, ll x_bstride,
                             int B, int K, int H, int W, const float* scale,
                             const float* shift, const void* wt,
                             const float* mask, int N, const void* dy,
                             void* dseg, float* dscale, float* dshift,
                             float* dw, float* dbias, void* gbuf,
                             float* part_gp, float* part_ss, float* part_w,
                             int S, int* route, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  *route = 0;
#define S2R_BWD(T, TAPS)                                                      \
  bwd<T, TAPS>(X, x_bstride, B, K, H, W, scale, shift, wt, mask, N, dy, dseg, \
               dscale, dshift, dw, dbias, gbuf, part_gp, part_ss, part_w, S, s)
  if (dtype == 0 && taps == 9) return S2R_BWD(float, 9);
  if (dtype == 0 && taps == 1) return S2R_BWD(float, 1);
  if (dtype == 1 && taps == 9) return S2R_BWD(__nv_bfloat16, 9);
  if (dtype == 1 && taps == 1 && N <= B1_MAX_N) {
    *route = 1;
    return bwd1x1_mma(X, x_bstride, B, K, H, W, scale, shift, wt, mask, N, dy,
                      dseg, dscale, dshift, dw, dbias, gbuf, part_gp, part_ss,
                      part_w, S, s);
  }
  if (dtype == 1 && taps == 1) return S2R_BWD(__nv_bfloat16, 1);
#undef S2R_BWD
  return cudaErrorInvalidValue;
}

extern "C" int s2r_train_stage(int dtype, const void* X, ll x_bstride, int B,
                               int K, int H, int W, const void* Y,
                               ll y_bstride, int G, const float* ext, int nl,
                               const void* const* gps,
                               const void* const* w_slices,
                               const float* const* scs,
                               const float* const* shs, const void* wt,
                               const float* scale, const float* shift,
                               const float* mask, void* gp_out, float* dw,
                               float* dscale, float* dshift, float* dbias,
                               float* part_gp, float* part_ss, float* part_w,
                               int S, int* route, void* stream) {
  *route = 0;
  if (nl < 0 || nl > MAXL) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Layers L = make_layers(nl, gps, w_slices, scs, shs);
  if (dtype == 0)
    return stage<float>(X, x_bstride, B, K, H, W, Y, y_bstride, G, ext, nl, L, wt,
                        scale, shift, mask, gp_out, dw, dscale, dshift, dbias,
                        part_gp, part_ss, part_w, S, s);
  if (dtype == 1 && mma_growth(G)) {
    // one result buffer: dW, dscale, dshift, dbias in this order
    if (dscale != dw + (ll)K * 9 * G || dshift != dscale + K || dbias != dshift + K)
      return cudaErrorInvalidValue;
    *route = 1;
    return (G == 12 ? stage_mma<12> : stage_mma<16>)(X, x_bstride, B, K, H, W, Y,
                                                    y_bstride, ext, nl, L, wt, scale,
                                                    shift, mask, gp_out, dw, part_gp,
                                                    part_w, S, s);
  }
  if (dtype == 1)
    return stage<__nv_bfloat16>(X, x_bstride, B, K, H, W, Y, y_bstride, G, ext, nl,
                                L, wt, scale, shift, mask, gp_out, dw, dscale,
                                dshift, dbias, part_gp, part_ss, part_w, S, s);
  return cudaErrorInvalidValue;
}

extern "C" int s2r_train_final(int dtype, const void* X, ll x_bstride, int B,
                               int K, int H, int W, int G, int nl,
                               const void* const* gps,
                               const void* const* w_slices,
                               const float* const* scs,
                               const float* const* shs, void* dseg,
                               int* route, void* stream) {
  *route = 0;
  if (nl < 1 || nl > MAXL) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Layers L = make_layers(nl, gps, w_slices, scs, shs);
  if (dtype == 0)
    return launch_dgrad<float, 9, true>(X, x_bstride, B, K, H, W, G, nl, L,
                                        nullptr, nullptr, dseg, nullptr, nullptr, s);
  if (dtype == 1 && mma_growth(G)) {
    *route = 1;
    return (G == 12 ? sum_dgrad_mma<12> : sum_dgrad_mma<16>)(
        X, x_bstride, B, K, H, W, nullptr, nl, L, nullptr, dseg, nullptr, s);
  }
  if (dtype == 1)
    return launch_dgrad<__nv_bfloat16, 9, true>(X, x_bstride, B, K, H, W, G, nl, L,
                                                nullptr, nullptr, dseg, nullptr,
                                                nullptr, s);
  return cudaErrorInvalidValue;
}

// Sets the shared-memory limits of the tensor-core kernels on the current
// device; called once when the library is loaded, before any launch.
extern "C" int s2r_train_init() { return setup_all(); }

extern "C" const char* s2r_train_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
