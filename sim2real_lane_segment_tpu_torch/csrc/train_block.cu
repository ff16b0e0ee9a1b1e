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
//        g_pre = dy_j * mask and the K2 sums on G = T(g_pre), where
//        ext = dy + T(c0 + c1 * y_j) is formed as it loads: the cotangent
//        of y_j from outside the block with its BatchNorm statistics'
//        cotangent folded in, per channel an affine map of y_j (Outer);
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
// the fused train step, any width) runs on the tensor cores instead:
// bwd1x1_dgrad_mma_kernel and bwd1x1_wgrad_mma_kernel (wgmma) and one
// bwd1x1_reduce_kernel, noted below.  So do
// K1, K3a and K3b in bfloat16 with 12 or 16 outputs (every dense layer of
// FCDenseNet57, 67 and 103): fwd3x3_mma_kernel, sum_dgrad_mma_kernel and
// stage_own_ring_kernel, templates on the growth G, noted below, and K1 with one tap, through the
// TransitionDown product of td_fwd_mma.cuh.  The kernels above them stay
// for float32 and for the shapes the tensor-core kernels do not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstring>

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

// K3a's cotangent of y from outside the block, ext = dy + T(c0 + c1 * y):
// dy is [B, C, H, W] in T with batch stride bstride (a channel slice of
// the block's cotangent buffer), and c0, c1 [C] f32 the cotangent of y's
// BatchNorm statistics pulled back onto y.  dy == nullptr (K2, K3b): no
// outside cotangent, the sums start at 0.
struct Outer {
  const void* dy;
  ll bstride;
  const float* c0;
  const float* c1;
};

// ext at channel n, in-plane position p of image b, for y's value yv there;
// the statistics' term is rounded to T before the add, as the cotangent
// autograd hands back in y's dtype would be
template <typename T>
__device__ __forceinline__ float outer_ext(const Outer& o, int b, int n, ll hw, ll p,
                                           float yv) {
  const float v = to_f<T>(static_cast<const T*>(o.dy)[b * o.bstride + n * hw + p]);
  return __fadd_rn(v, round_to<T>(affine(yv, o.c1[n], o.c0[n])));
}

template <typename T, int TAPS, bool SUM>
__global__ void __launch_bounds__(THREADS)
dgrad_kernel(const T* X, ll x_bstride, int C, int H, int W, int N, int nl,
             Layers L, Outer ext,
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
    tot[k] = (SUM && ext.dy != nullptr && inside && k < kc)
                 ? outer_ext<T>(ext, b, c0 + k, hw, pix, xv[k]) : 0.f;
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

int n_tiles(int H, int W) { return ((H + TH - 1) / TH) * ((W + TW - 1) / TW); }

cudaError_t reduce_rows(const float* part, int P, ll M, float* out, cudaStream_t s) {
  const unsigned blocks = (unsigned)((M + 31) / 32);
  reduce_rows_kernel<<<blocks, THREADS, 0, s>>>(part, P, M, out);
  return cudaGetLastError();
}

template <typename T, int TAPS, bool SUM>
cudaError_t launch_dgrad(const void* X, ll x_bstride, int B, int C, int H, int W,
                         int N, int nl, const Layers& L, const Outer& ext,
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
                                        Outer{}, nullptr, dseg, part_ds,
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
// What the design does about it: three launches, the two products as
// persistent pipelined wgmma kernels, G rebuilt from dy and the mask
// wherever it is staged (no round trip through device memory), and one
// launch for every sum.  On the planes TMA can address (hw % 8 == 0, C and
// N <= TD_MAX_K, N % 8 == 0: 120x160, 60x80, 30x40) the products are the
// warp-specialized bwd1x1_dgrad_tma_kernel and bwd1x1_wgrad_tma_kernel
// (noted below with them); elsewhere (15x20, 7x10 and odd shapes) the two
// cp.async kernels here, over flat pixels (all images as one axis, as
// td_fwd_mma.cuh tiles them), two blocks per SM with a three-stage ring of
// 32 KB stages two ahead across item boundaries, each stage converted in
// place (BN + ReLU, or dy * mask and rounding) and multiplied while the
// next one is converted:
// - bwd1x1_dgrad_mma_kernel: a block walks (128-position tile, 128-channel
//   chunk of x) items, the chunks of a tile on neighbouring blocks.  An
//   item streams G in 64-output slices (dy 128-byte swizzled, the weight's
//   128 x 64 slice from L2 in core order), so N has no cap: D[k, p] = W[k,
//   n] G[n, p], W K-major, G MN-major (m64n128k16; two warpgroups of 64
//   channels).  Its last stage brings the x tile, on which the epilogue
//   writes dseg = T(dz * scale) in place, dz = dA * relu'(z), and adds
//   the tile's sums of dz * x and dz to the block's per-channel sums.
// - bwd1x1_wgrad_mma_kernel: a block owns a 128 x 128 tile of dW and a
//   contiguous range of 64-position slices (split S ways to fill the
//   card); per slice it stages x as a and dy as G, both K-major (pixels
//   contiguous) in the 128-byte swizzled layout, and contracts over
//   pixels: D[k, n] = a[k, p] G[n, p]^T.  The blocks of the first channel
//   tile also sum dy * mask (unrounded) per output for dbias.
// - bwd1x1_reduce_kernel adds the partial sums (dW per split, dscale and
//   dshift per dgrad block, dbias per split) in a fixed order: two runs
//   give the same bits, no atomics.
// On either route x and dy are each read twice (once per product kernel):
// 1.6 times the bound's bytes when C = N.
// ---------------------------------------------------------------------------
namespace mma = s2r_mma;

constexpr int B1_TP = 128;               // positions per dgrad tile
constexpr int B1_KM = 128;               // x channels per dgrad item, dW tile side
constexpr int B1_NS = 64;                // outputs per G slice
constexpr int B1_WP = 64;                // positions per wgrad slice
constexpr int B1_HALF = 8192;            // elements in half a stage (16 KB)
constexpr int B1_STAGE = 2 * B1_HALF;    // 32 KB
constexpr int B1_STAGES = 3;             // ring stages: two in flight
constexpr int B1_THREADS = 256;          // two warpgroups
constexpr int B1_BLOCKS = 264;           // dgrad blocks: two per SM of an H100
constexpr size_t B1_SMEM = (size_t)B1_STAGES * B1_STAGE * 2 + 1024;  // 1024-byte alignment
constexpr int B1_SMEM_MAX = 232448 - B1_KM * 2 * 4;  // an H100 block's, less the
                                                     // dgrad's static sums

__device__ __forceinline__ mma::u16* ring_base(unsigned char* smem) {
  return reinterpret_cast<mma::u16*>(smem + ((1024 - (mma::smem_u32(smem) & 1023)) & 1023));
}

// Per block: part_ss[blockIdx.x] [2][C] = the sums of dz * x and of dz
// over its items' pixels (zeros for channels it did not see).  Dynamic
// shared memory: B1_SMEM + 8 C bytes.
__global__ void __launch_bounds__(B1_THREADS, 2)
bwd1x1_dgrad_mma_kernel(const mma::u16* X, ll x_bstride, int C, int hw, int B,
                        const float* __restrict__ scale,
                        const float* __restrict__ shift,
                        const mma::u16* __restrict__ wt,
                        const float* __restrict__ mask, int N,
                        const mma::u16* __restrict__ dy, mma::u16* dseg,
                        float* __restrict__ part_ss, int x_mode, int dy_mode, int vec_w,
                        int vec_dseg) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float red[B1_KM][2];
  mma::u16* ring = ring_base(smem);
  float* acc = reinterpret_cast<float*>(ring + B1_STAGES * B1_STAGE);  // [2][C]
  const int tid = threadIdx.x;
  const int wg = tid / 128;                            // x channels 64 wg .. +63
  const int total = B * hw;
  const int nch = (C + B1_KM - 1) / B1_KM;
  const int items = (total + B1_TP - 1) / B1_TP * nch;
  const int np = (N + 15) / 16 * 16;
  const int nks = (np + B1_NS - 1) / B1_NS;
  const int per = nks + 1;                             // G slices, then the x tile
  const int mine = items > (int)blockIdx.x ? (items - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int stages = mine * per;
  const ll dy_bstride = (ll)N * hw;
  for (int i = tid; i < 2 * C; i += B1_THREADS) acc[i] = 0.f;

  auto issue = [&](int s) {
    if (s < stages) {
      const int item = blockIdx.x + (s / per) * gridDim.x;
      const int q = s % per;
      const int k0 = item % nch * B1_KM;
      mma::u16* st = ring + (s % B1_STAGES) * B1_STAGE;
      const int f0 = item / nch * B1_TP;
      if (q < nks) {
        // dy rows q*64 .. +63 (sw128, MN-major) and W[k0 .. +127][q*64 .. +63]
        mma::flat_tile_async<B1_NS, B1_TP, B1_THREADS>(
            st, [](int r, int c) { return mma::sw128_off(r, c); }, dy, dy_bstride, hw,
            q * B1_NS, N, f0, total, dy_mode);
        mma::load_tile_core<B1_KM, B1_NS / 8, B1_THREADS>(st + B1_HALF, wt, C, N, k0,
                                                         q * B1_NS, vec_w);
      } else {
        // the x tile [128][128] (swz_off), the whole stage
        mma::flat_tile_async<B1_KM, B1_TP, B1_THREADS>(
            st, [](int r, int c) { return mma::swz_off(r, c); }, X, x_bstride, hw, k0, C,
            f0, total, x_mode);
      }
    }
    mma::cp_async_commit();  // an empty group past the last stage
  };
  for (int s = 0; s < B1_STAGES - 1; ++s) issue(s);

  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  float d[64];
  for (int s = 0; s < stages; ++s) {
    const int item = blockIdx.x + (s / per) * gridDim.x;
    const int q = s % per;
    const int p0 = item / nch * B1_TP;
    const int k0 = item % nch * B1_KM;
    const bool live = k0 + 64 * wg < C;                // warpgroup-uniform
    mma::u16* st = ring + (s % B1_STAGES) * B1_STAGE;
    mma::cp_async_wait<B1_STAGES - 2>();
    __syncthreads();
    if (q < nks) {
      // G = T(dy * mask) in place; rows past N are zero, as their W columns
      for (int i = tid; i < B1_NS * 16; i += B1_THREADS) {
        const int r = i / 16;
        const int c = (i % 16) * 8;
        const int n = q * B1_NS + r;
        uint4* cell = reinterpret_cast<uint4*>(st + mma::sw128_off(r, c));
        float unused;
        *cell = n < N ? mma::mask8(*cell, mask, N, n, p0 + c, hw, total, &unused)
                      : make_uint4(0, 0, 0, 0);
      }
      mma::fence_async_smem();
      mma::wgmma_wait0();  // the previous slice's products
      __syncthreads();
      issue(s + B1_STAGES - 1);  // into the previous stage
      if (live) {
        // D[k, p] = W[k, n] G[n, p]: W K-major (rows k), G MN-major (pixels)
        const int kk_end = min(B1_NS, np - q * B1_NS);
        mma::wgmma_fence();
        for (int kk = 0; kk < kk_end; kk += 16) {
          const uint64_t da = mma::gmma_desc(
              st + B1_HALF + mma::core_off(64 * wg, kk / 8, B1_NS / 8), 128,
              B1_NS / 8 * 128);
          const uint64_t db = mma::gmma_desc(st + mma::sw128_off(kk, 0), 1024, 2048, 1);
          mma::wgmma_m64n128k16<0, 1>(d, da, db, q > 0 || kk > 0);
        }
        mma::wgmma_commit();
      }
      continue;
    }
    // the x stage: dz = dA * relu'(z), dseg = T(dz * scale) in place of x,
    // the tile's sums of dz * x and dz per channel
    mma::wgmma_wait0();
    __syncthreads();
    issue(s + B1_STAGES - 1);
    mma::u16* sX = st;
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
            const float dz = (p0 + pl + e < total)
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
          red[kl][0] = sd;
          red[kl][1] = sh;
        }
      }
    }
    __syncthreads();
    if (tid < B1_KM && k0 + tid < C) {  // items in a fixed order per block
      acc[k0 + tid] += red[tid][0];
      acc[C + k0 + tid] += red[tid][1];
    }
    const int rows = min(B1_KM, C - k0);
    for (int i = tid; i < rows * 16; i += B1_THREADS) {
      const int r = i / 16;
      const int c = (i % 16) * 8;
      mma::flat_chunk_store(dseg, (ll)C * hw, hw, k0 + r, p0 + c, total,
                            sX + mma::swz_off(r, c), vec_dseg);
    }
  }
  __syncthreads();
  for (int i = tid; i < 2 * C; i += B1_THREADS)
    part_ss[(ll)blockIdx.x * 2 * C + i] = acc[i];
}

// Block (x, y, z): dW[128 x, .. +127][128 y, .. +127] over the z-th of S
// ranges of 64-position slices into part_w[z] [C][N]; the blocks with x
// = 0 also write part_gb[z] [N], the range's sums of dy * mask.
__global__ void __launch_bounds__(B1_THREADS, 2)
bwd1x1_wgrad_mma_kernel(const mma::u16* X, ll x_bstride, int C, int hw, int B,
                        const float* __restrict__ scale,
                        const float* __restrict__ shift,
                        const float* __restrict__ mask, int N,
                        const mma::u16* __restrict__ dy, int S,
                        float* __restrict__ part_w, float* __restrict__ part_gb,
                        int x_mode, int dy_mode) {
  extern __shared__ __align__(128) unsigned char smem[];
  mma::u16* ring = ring_base(smem);
  const int tid = threadIdx.x;
  const int wg = tid / 128;                            // x channels 64 wg .. +63
  const int k0 = blockIdx.x * B1_KM;
  const int n0 = blockIdx.y * B1_KM;
  const int total = B * hw;
  const int slices = (total + B1_WP - 1) / B1_WP;
  const int per = (slices + S - 1) / S;
  const int first = min(slices, (int)blockIdx.z * per);
  const int stages = min(slices, first + per) - first;
  const ll dy_bstride = (ll)N * hw;
  const int j = tid % 8;  // this thread's 8 positions of each of its rows
  const int r_0 = tid / 8;  // its rows r_0 + 32 u, u < 4

  auto issue = [&](int s) {
    if (s < stages) {
      mma::u16* st = ring + (s % B1_STAGES) * B1_STAGE;
      const int f0 = (first + s) * B1_WP;
      const auto off = [](int r, int c) { return mma::kmaj_off(r, c / 8) + c % 8; };
      mma::flat_tile_async<B1_KM, B1_WP, B1_THREADS>(st, off, X, x_bstride, hw, k0, C,
                                                     f0, total, x_mode);
      mma::flat_tile_async<B1_KM, B1_WP, B1_THREADS>(st + B1_HALF, off, dy, dy_bstride,
                                                     hw, n0, N, f0, total, dy_mode);
    }
    mma::cp_async_commit();
  };
  for (int s = 0; s < B1_STAGES - 1; ++s) issue(s);

  const bool live = k0 + 64 * wg < C;                 // warpgroup-uniform
  float gsum[4] = {0.f, 0.f, 0.f, 0.f};                // dbias over this thread's chunks
  float d[64];
  for (int s = 0; s < stages; ++s) {
    mma::u16* st = ring + (s % B1_STAGES) * B1_STAGE;
    mma::cp_async_wait<B1_STAGES - 2>();
    __syncthreads();
    // a = T(relu(x * scale + shift)) and G = T(dy * mask) in place; rows
    // past C or N are zero
    const int f = (first + s) * B1_WP + 8 * j;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int r = r_0 + 32 * u;
      uint4* ca = reinterpret_cast<uint4*>(st + mma::kmaj_off(r, j));
      uint4* cg = reinterpret_cast<uint4*>(st + B1_HALF + mma::kmaj_off(r, j));
      const int k = k0 + r;
      const int n = n0 + r;
      *ca = k < C ? mma::bn_relu8(*ca, scale[k], shift[k]) : make_uint4(0, 0, 0, 0);
      float sum = 0.f;
      *cg = n < N ? mma::mask8(*cg, mask, N, n, f, hw, total, &sum) : make_uint4(0, 0, 0, 0);
      gsum[u] += sum;
    }
    mma::fence_async_smem();
    mma::wgmma_wait0();  // the previous slice's products
    __syncthreads();
    issue(s + B1_STAGES - 1);
    if (live) {
      // D[k, n] = a[k, p] G[n, p]^T: both K-major (pixels contiguous)
      mma::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < B1_WP; kk += 16) {
        const uint64_t da = mma::gmma_desc(st + mma::kmaj_off(64 * wg, 0) + kk, 16, 1024, 1);
        const uint64_t db = mma::gmma_desc(st + B1_HALF + kk, 16, 1024, 1);
        mma::wgmma_m64n128k16<0, 0>(d, da, db, s > 0 || kk > 0);
      }
      mma::wgmma_commit();
    }
  }
  mma::wgmma_wait0();
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  if (live && stages > 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = k0 + 64 * wg + 16 * ((tid / 32) % 4) + g + 8 * h;
      if (k >= C) continue;
      float* dst = part_w + ((ll)blockIdx.z * C + k) * N;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int n = n0 + 8 * i + 2 * t;
        if (n < N) dst[n] = d[4 * i + 2 * h];
        if (n + 1 < N) dst[n + 1] = d[4 * i + 2 * h + 1];
      }
    }
  } else if (live) {  // an empty range: its partial sums are zero
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = k0 + 64 * wg + 16 * ((tid / 32) % 4) + g + 8 * h;
      if (k >= C) continue;
      float* dst = part_w + ((ll)blockIdx.z * C + k) * N;
      for (int i = 0; i < 16; ++i) {
        const int n = n0 + 8 * i + 2 * t;
        if (n < N) dst[n] = 0.f;
        if (n + 1 < N) dst[n + 1] = 0.f;
      }
    }
  }
  if (blockIdx.x == 0) {
    // the 8 lanes of one row: a fixed-order tree
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      float v = gsum[u];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      const int n = n0 + r_0 + 32 * u;
      if (j == 0 && n < N) part_gb[(ll)blockIdx.z * N + n] = v;
    }
  }
}

// ---------------------------------------------------------------------------
// K2 on the aligned sites (hw % 8 == 0, every operand 16-byte aligned, C
// and N <= TD_MAX_K: 120x160, 60x80, 30x40): the two products as
// warp-specialized TMA pipelines, as td_fwd_tma_kernel (td_fwd_mma.cuh).
// One thread of the first warpgroup loads 32 KB stages (four 64 x 64
// boxes, 128-byte swizzle) into a four-stage ring, counted on "full"
// mbarriers; two consumer warpgroups multiply and release each stage on
// its "empty" mbarrier.
// - bwd1x1_dgrad_tma_kernel: items (image, 128-pixel tile, 128-channel
//   chunk); per 64-output slice a stage holds dy (two pixel halves) and
//   W[k0 .. +127][n .. +63] (K-major); the consumers read G^T = T(dy *
//   mask)^T as A fragments (ldmatrix transposed, the mask and the rounding
//   in registers) and multiply D[p, k] = G^T[p, n] W^T[n, k] (wgmma, A
//   from registers).  The item's last stage brings the x tile; the
//   epilogue forms dz = D relu'(z), stores dseg = T(dz scale) through two
//   output tiles that TMA stores take in turns, and adds the tile's sums
//   of dz x and dz (a fixed tree over the pixels) to the block's
//   per-channel sums.
// - bwd1x1_wgrad_tma_kernel: a block owns a 128 x 128 tile of dW and a
//   range of (image, 64-pixel slice) items; per slice a stage holds x and
//   dy (two 64-row halves each).  The consumers turn dy into G = T(dy *
//   mask) in place (with the dbias sums), fence and meet, then multiply
//   D[k, n] = a[k, p] G[n, p]^T with a = T(relu(x scale + shift)) as A
//   fragments (ldmatrix, BN in registers) and G K-major from the stage.
// ---------------------------------------------------------------------------
constexpr int KT_STAGES = 4;
constexpr int KT_THREADS = 384;
constexpr int KT_BOX = 64 * 64;
constexpr int KT_STAGE = 4 * KT_BOX;
constexpr int KT_RING = KT_STAGES * KT_STAGE;
constexpr int KT_OUT = 128 * 128;
constexpr int KT_PAD = s2r_td::TD_MAX_K + 128;       // per-channel arrays, zero past C
constexpr size_t KT_DGRAD_SMEM = 2 * ((size_t)KT_RING + 2 * KT_OUT) +
                                 4 * (4 * KT_PAD + 8 * 128 * 2) + 16 * KT_STAGES + 1024;
constexpr size_t KT_WGRAD_SMEM = 2 * (size_t)KT_RING + 4 * 2 * KT_PAD +
                                 16 * KT_STAGES + 1024;

__device__ __forceinline__ void kt_barriers(uint64_t* full, uint64_t* empty) {
  for (int i = 0; i < KT_STAGES; ++i) {
    mma::mbar_init(full + i, 1);
    mma::mbar_init(empty + i, 2);
  }
  mma::mbar_fence_init();
}

// Per block: part_ss[blockIdx.x] [2][C], the sums of dz * x and of dz over
// its items' pixels (zeros for channels it did not see).
__global__ void __launch_bounds__(KT_THREADS, 1)
bwd1x1_dgrad_tma_kernel(const __grid_constant__ CUtensorMap map_dy,
                        const __grid_constant__ CUtensorMap map_w,
                        const __grid_constant__ CUtensorMap map_x,
                        const __grid_constant__ CUtensorMap map_dseg, int C, int hw, int B,
                        const float* __restrict__ scale, const float* __restrict__ shift,
                        const float* __restrict__ mask, int N,
                        float* __restrict__ part_ss) {
  extern __shared__ __align__(128) unsigned char smem[];
  mma::u16* ring = ring_base(smem);
  mma::u16* sO = ring + KT_RING;                       // two dseg tiles
  float* ssc = reinterpret_cast<float*>(sO + 2 * KT_OUT);
  float* ssh = ssc + KT_PAD;
  float* acc = ssh + KT_PAD;                           // [2][KT_PAD]: sums of dz x, dz
  float* red = acc + 2 * KT_PAD;                       // [8 warps][128][2]
  uint64_t* full = reinterpret_cast<uint64_t*>(red + 8 * 128 * 2);
  uint64_t* empty = full + KT_STAGES;
  const int tid = threadIdx.x;
  const int tiles = (hw + 127) / 128;
  const int nch = (C + 127) / 128;
  const int items = B * tiles * nch;
  const int nks = (N + 63) / 64;
  const int per = nks + 1;                             // G slices, then the x tile
  const int mine = items > (int)blockIdx.x ? (items - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int stages = mine * per;
  for (int i = tid; i < KT_PAD; i += KT_THREADS) {
    ssc[i] = i < C ? scale[i] : 0.f;
    ssh[i] = i < C ? shift[i] : 0.f;
    acc[i] = 0.f;
    acc[KT_PAD + i] = 0.f;
  }
  if (tid == 0) kt_barriers(full, empty);
  __syncthreads();

  if (tid < 128) {
    if (tid == 0) {
      for (int s = 0; s < stages; ++s) {
        const int st = s % KT_STAGES;
        if (s >= KT_STAGES) mma::mbar_wait(empty + st, (s / KT_STAGES - 1) & 1);
        const int item = blockIdx.x + (s / per) * gridDim.x;
        const int q = s % per;
        const int k0 = item % nch * 128;
        const int tile = item / nch;
        const int b = tile / tiles;
        const int p0 = tile % tiles * 128;
        mma::u16* sx = ring + st * KT_STAGE;
        mma::mbar_expect_tx(full + st, 2 * KT_STAGE);
        if (q < nks) {
          mma::tma_load_3d(sx, &map_dy, full + st, p0, 64 * q, b);
          mma::tma_load_3d(sx + KT_BOX, &map_dy, full + st, p0 + 64, 64 * q, b);
          mma::tma_load_2d(sx + 2 * KT_BOX, &map_w, full + st, 64 * q, k0);
          mma::tma_load_2d(sx + 3 * KT_BOX, &map_w, full + st, 64 * q, k0 + 64);
        } else {  // box (kh, ph) at (2 kh + ph) boxes
          for (int j = 0; j < 4; ++j)
            mma::tma_load_3d(sx + j * KT_BOX, &map_x, full + st, p0 + 64 * (j % 2),
                             k0 + 64 * (j / 2), b);
        }
      }
    }
    return;
  }

  const int ct = tid - 128;
  const int cw = ct / 128;                             // pixels 64 cw .. +63 of a tile
  const int wq = (ct / 32) % 4;
  const int lane = ct % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int lrow = (lane % 8) + 8 * (lane >> 4);
  const int lchunk = 2 * wq + ((lane >> 3) & 1);
  float d[64];
  for (int s = 0; s < stages; ++s) {
    const int st = s % KT_STAGES;
    const int item = blockIdx.x + (s / per) * gridDim.x;
    const int q = s % per;
    const int k0 = item % nch * 128;
    const int tile = item / nch;
    const int b = tile / tiles;
    const int p0 = tile % tiles * 128;
    mma::mbar_wait(full + st, (s / KT_STAGES) & 1);
    const mma::u16* sx = ring + st * KT_STAGE;
    if (q < nks) {
      // G^T[p, n] for n = 64 q + 16 u ..: the dy box read transposed, times
      // the mask of (b, n), rounded
      uint32_t a[4][4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int r = 16 * u + lrow;
        mma::ldsm_x4_t(a[u], mma::smem_u32(sx + cw * KT_BOX) + r * 128 +
                                 ((lchunk ^ (r & 7)) << 4));
        const int n = 64 * q + 16 * u + 2 * t;
        const float* mb = mask + (ll)b * N;
        const float m0 = n < N ? __ldg(mb + n) : 0.f;
        const float m1 = n + 1 < N ? __ldg(mb + n + 1) : 0.f;
        const float m8 = n + 8 < N ? __ldg(mb + n + 8) : 0.f;
        const float m9 = n + 9 < N ? __ldg(mb + n + 9) : 0.f;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          a[u][e] = mma::pack_bf16x2(__fmul_rn(mma::lo_f(a[u][e]), e < 2 ? m0 : m8),
                                     __fmul_rn(mma::hi_f(a[u][e]), e < 2 ? m1 : m9));
      }
      mma::wgmma_fence();
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        // W[k, n], rows k0 .. k0 + 127 of both boxes, K-major (n contiguous)
        const uint64_t db = mma::gmma_desc(sx + 2 * KT_BOX + 16 * u, 16, 1024, 1);
        mma::wgmma_m64n128k16_rs<0>(d, a[u], db, q > 0 || u > 0);
      }
      mma::wgmma_commit();
      mma::wgmma_wait0();
      mma::fence_regs(a);
      mma::fence_acc(d);
      if (ct % 128 == 0) mma::mbar_arrive(empty + st);
      continue;
    }
    // the x stage: dz = D relu'(z), dseg = T(dz scale) into an output tile
    // (two take turns under the TMA stores), the tile's sums of dz x and dz
    // per channel: over a warp's 16 pixels by a fixed shuffle tree, over
    // the 8 warps in order
    mma::u16* so = sO + (s / per % 2) * KT_OUT;
    if (ct == 0) mma::bulk_wait_read<1>();  // the store two items back has read it
    mma::named_sync(1, 256);                // so and red are free
    const int w8 = ct / 32;
    const int pst = 64 * cw + 16 * wq + 8 * ((lane >> 3) & 1);
#pragma unroll
    for (int i = 0; i < 16; i += 2) {
      // x at this lane's D positions of channel blocks i and i + 1: the x
      // box [64 k][64 p] read transposed, as the G fragments are
      uint32_t xr[4];
      const int xrow = 8 * i % 64 + lrow;
      mma::ldsm_x4_t(xr, mma::smem_u32(sx + (2 * (8 * i / 64) + cw) * KT_BOX) + xrow * 128 +
                             ((lchunk ^ (xrow & 7)) << 4));
      uint32_t r[4];  // matrix j: channels 8 (i + j / 2) .., pixels 8 (j & 1) ..
#pragma unroll
      for (int ii = 0; ii < 2; ++ii) {
        float o[4], sd[2] = {0.f, 0.f}, sh[2] = {0.f, 0.f};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int k = 8 * (i + ii) + 2 * t + (e & 1);
          const int p = 64 * cw + 16 * wq + g + 8 * (e >> 1);
          const uint32_t w2 = xr[2 * ii + (e >> 1)];
          const float xf = (e & 1) ? mma::hi_f(w2) : mma::lo_f(w2);
          const float sc = ssc[k0 + k];
          const float dz = p0 + p < hw
              ? __fmul_rn(d[4 * (i + ii) + e], relu_d(affine(xf, sc, ssh[k0 + k]))) : 0.f;
          o[e] = __fmul_rn(dz, sc);
          sd[e & 1] += __fmul_rn(dz, xf);
          sh[e & 1] += dz;
        }
        r[2 * ii] = mma::pack_bf16x2(o[0], o[1]);
        r[2 * ii + 1] = mma::pack_bf16x2(o[2], o[3]);
#pragma unroll
        for (int c = 0; c < 2; ++c) {
#pragma unroll
          for (int off = 4; off < 32; off <<= 1) {
            sd[c] += __shfl_xor_sync(0xffffffffu, sd[c], off);
            sh[c] += __shfl_xor_sync(0xffffffffu, sh[c], off);
          }
          if (g == 0) {
            const int k = 8 * (i + ii) + 2 * t + c;
            red[(w8 * 128 + k) * 2] = sd[c];
            red[(w8 * 128 + k) * 2 + 1] = sh[c];
          }
        }
      }
      const int krow = 8 * (i + (lane >> 4)) + (lane & 7);
      const int row = krow % 64;
      mma::stsm_x4_t(mma::smem_u32(so + (krow / 64 * 2 + pst / 64) * KT_BOX + row * 64 +
                                   ((((pst % 64) >> 3) ^ (row & 7)) << 3)),
                     r[0], r[1], r[2], r[3]);
    }
    mma::fence_async_smem();
    mma::named_sync(1, 256);  // x read, the tile and red written
    if (ct % 128 == 0) mma::mbar_arrive(empty + st);
    if (ct == 0) {
      for (int j = 0; j < 4; ++j)
        mma::tma_store_3d(&map_dseg, so + j * KT_BOX, p0 + 64 * (j % 2), k0 + 64 * (j / 2), b);
      mma::bulk_commit();
    }
    if (ct < 128 && k0 + ct < C) {  // the 8 warps in order, items in order
      float v = 0.f, z = 0.f;
      for (int w = 0; w < 8; ++w) {
        v += red[(w * 128 + ct) * 2];
        z += red[(w * 128 + ct) * 2 + 1];
      }
      acc[k0 + ct] += v;
      acc[KT_PAD + k0 + ct] += z;
    }
  }
  if (ct == 0) mma::bulk_wait_all();
  mma::named_sync(1, 256);
  for (int i = ct; i < C; i += 256) {
    part_ss[(ll)blockIdx.x * 2 * C + i] = acc[i];
    part_ss[(ll)blockIdx.x * 2 * C + C + i] = acc[KT_PAD + i];
  }
}

// Block (x, y, z): dW[128 x .. +127][128 y .. +127] over the z-th of S
// ranges of (image, 64-pixel slice) items into part_w[z] [C][N]; the
// blocks with x = 0 also write part_gb[z] [N], the range's sums of dy *
// mask.
__global__ void __launch_bounds__(KT_THREADS, 1)
bwd1x1_wgrad_tma_kernel(const __grid_constant__ CUtensorMap map_x,
                        const __grid_constant__ CUtensorMap map_dy, int C, int hw, int B,
                        const float* __restrict__ scale, const float* __restrict__ shift,
                        const float* __restrict__ mask, int N, int S,
                        float* __restrict__ part_w, float* __restrict__ part_gb) {
  extern __shared__ __align__(128) unsigned char smem[];
  mma::u16* ring = ring_base(smem);
  float* ssc = reinterpret_cast<float*>(ring + KT_RING);
  float* ssh = ssc + KT_PAD;
  uint64_t* full = reinterpret_cast<uint64_t*>(ssh + KT_PAD);
  uint64_t* empty = full + KT_STAGES;
  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * 128;
  const int n0 = blockIdx.y * 128;
  const int slices = (hw + 63) / 64;                   // per image
  const int items = B * slices;
  const int per = (items + S - 1) / S;
  const int first = min(items, (int)blockIdx.z * per);
  const int stages = min(items, first + per) - first;
  for (int i = tid; i < KT_PAD; i += KT_THREADS) {
    ssc[i] = i < C ? scale[i] : 0.f;
    ssh[i] = i < C ? shift[i] : 0.f;
  }
  if (tid == 0) kt_barriers(full, empty);
  __syncthreads();

  if (tid < 128) {
    if (tid == 0) {
      for (int s = 0; s < stages; ++s) {
        const int st = s % KT_STAGES;
        if (s >= KT_STAGES) mma::mbar_wait(empty + st, (s / KT_STAGES - 1) & 1);
        const int b = (first + s) / slices;
        const int p0 = (first + s) % slices * 64;
        mma::u16* sx = ring + st * KT_STAGE;
        mma::mbar_expect_tx(full + st, 2 * KT_STAGE);
        mma::tma_load_3d(sx, &map_x, full + st, p0, k0, b);
        mma::tma_load_3d(sx + KT_BOX, &map_x, full + st, p0, k0 + 64, b);
        mma::tma_load_3d(sx + 2 * KT_BOX, &map_dy, full + st, p0, n0, b);
        mma::tma_load_3d(sx + 3 * KT_BOX, &map_dy, full + st, p0, n0 + 64, b);
      }
    }
    return;
  }

  const int ct = tid - 128;
  const int cw = ct / 128;                             // channels 64 cw .. +63
  const int wq = (ct / 32) % 4;
  const int lane = ct % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  // ldmatrix (not transposed) of a[k][p]: this lane's row (a channel) and
  // the half of the 16-pixel step it addresses
  const int lrow = 16 * wq + (lane % 8) + 8 * ((lane >> 3) & 1);
  const int lhalf = lane >> 4;
  const int ka = k0 + 64 * cw + 16 * wq + g;           // this lane's two channels
  const float sa = ssc[ka], sb = ssc[ka + 8], ha = ssh[ka], hb = ssh[ka + 8];
  // the in-place G: this thread's rows (outputs) cj + 32 u of the two
  // boxes, 8-pixel chunk jj
  const int jj = ct % 8;
  const int cj = ct / 8;
  float gsum[4] = {0.f, 0.f, 0.f, 0.f};
  float d[64];
  for (int s = 0; s < stages; ++s) {
    const int st = s % KT_STAGES;
    const int b = (first + s) / slices;
    const int p0 = (first + s) % slices * 64;
    mma::mbar_wait(full + st, (s / KT_STAGES) & 1);
    mma::u16* sx = ring + st * KT_STAGE;
    mma::u16* sg = sx + 2 * KT_BOX;                    // [128 n][64 p], K-major
    const int valid = min(8, hw - (p0 + 8 * jj));  // pixels of this chunk in the image
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int row = cj + 32 * u;
      const int n = n0 + row;
      uint4* cell = reinterpret_cast<uint4*>(sg + row * 64 + ((jj ^ (row & 7)) << 3));
      const float m = n < N ? __ldg(mask + (ll)b * N + n) : 0.f;
      const uint4 v = *cell;
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
      uint32_t o[4];
      float sum = 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float g0 = 2 * q < valid ? __fmul_rn(mma::lo_f(w[q]), m) : 0.f;
        const float g1 = 2 * q + 1 < valid ? __fmul_rn(mma::hi_f(w[q]), m) : 0.f;
        o[q] = mma::pack_bf16x2(g0, g1);
        sum += g0;
        sum += g1;
      }
      *cell = make_uint4(o[0], o[1], o[2], o[3]);
      gsum[u] += sum;
    }
    mma::fence_async_smem();
    mma::named_sync(1, 256);
    uint32_t a[4][4];
    const mma::u16* sa_box = sx + cw * KT_BOX;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int chunk = 2 * u + lhalf;
      mma::ldsm_x4(a[u], mma::smem_u32(sa_box) + lrow * 128 + ((chunk ^ (lrow & 7)) << 4));
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float sl = (e & 1) ? sb : sa, hl = (e & 1) ? hb : ha;
        a[u][e] = mma::pack_bf16x2_relu(__fadd_rn(__fmul_rn(mma::lo_f(a[u][e]), sl), hl),
                                        __fadd_rn(__fmul_rn(mma::hi_f(a[u][e]), sl), hl));
      }
    }
    mma::wgmma_fence();
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const uint64_t db = mma::gmma_desc(sg + 16 * u, 16, 1024, 1);
      mma::wgmma_m64n128k16_rs<0>(d, a[u], db, s > 0 || u > 0);
    }
    mma::wgmma_commit();
    mma::wgmma_wait0();
    mma::fence_regs(a);
    mma::fence_acc(d);
    if (ct % 128 == 0) mma::mbar_arrive(empty + st);  // the producer waits for both
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int k = k0 + 64 * cw + 16 * wq + g + 8 * h;
    if (k >= C) continue;
    float* dst = part_w + ((ll)blockIdx.z * C + k) * N;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int n = n0 + 8 * i + 2 * t;
      const float v0 = stages > 0 ? d[4 * i + 2 * h] : 0.f;
      const float v1 = stages > 0 ? d[4 * i + 2 * h + 1] : 0.f;
      if (n < N) dst[n] = v0;
      if (n + 1 < N) dst[n + 1] = v1;
    }
  }
  if (blockIdx.x == 0) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      float v = gsum[u];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      const int n = n0 + cj + 32 * u;
      if (jj == 0 && n < N) part_gb[(ll)blockIdx.z * N + n] = v;
    }
  }
}

// One launch for K2's sums, each over its partial rows in a fixed order:
// dw[m] = sum_s part_w[s][m] (S rows, C*N columns), dss = [dscale | dshift]
// over part_ss's R rows of 2C, dbias over part_gb's S rows of N.
__global__ void __launch_bounds__(THREADS)
bwd1x1_reduce_kernel(const float* __restrict__ part_w, int S, ll CN,
                     const float* __restrict__ part_ss, int R, int C2,
                     const float* __restrict__ part_gb, int N, float* __restrict__ dw,
                     float* __restrict__ dss, float* __restrict__ dbias, int wb, int sb) {
  const int blk = blockIdx.x;
  if (blk < wb)
    reduce_rows_body(part_w, S, CN, dw, blk);
  else if (blk < wb + sb)
    reduce_rows_body(part_ss, R, C2, dss, blk - wb);
  else
    reduce_rows_body(part_gb, S, N, dbias, blk - wb - sb);
}

// K2 for bf16 and one tap.  dshift must follow dscale (one [2C] block).
// Scratch: part_gb [S][N], part_ss [R][2C] with R = min(ceil(B H W / 128)
// ceil(C / 128), B1_BLOCKS), part_w [S][C * N].
cudaError_t bwd1x1_mma(const void* X, ll x_bstride, int B, int C, int H, int W,
                       const float* scale, const float* shift, const void* wt,
                       const float* mask, int N, const void* dy, void* dseg,
                       float* dscale, float* dshift, float* dw, float* dbias,
                       float* part_gb, float* part_ss, float* part_w, int S,
                       cudaStream_t s) {
  if (dshift != dscale + C || S < 1 || B1_SMEM + 8 * (size_t)C > (size_t)B1_SMEM_MAX)
    return cudaErrorInvalidValue;
  const int hw = H * W;
  const int total = B * hw;
  const int items = (total + B1_TP - 1) / B1_TP * ((C + B1_KM - 1) / B1_KM);
  const int R = std::min(items, B1_BLOCKS);
  int sms = 0;
  S2R_TRY(s2r_td::td_setup(&sms));
  int rows = R;       // part_ss rows written
  int splits = S;     // part_w and part_gb rows written
  if (hw % 8 == 0 && x_bstride % 8 == 0 && C <= s2r_td::TD_MAX_K &&
      N <= s2r_td::TD_MAX_K && N % 8 == 0 && mma::aligned16(X) && mma::aligned16(dy) &&
      mma::aligned16(wt) && mma::aligned16(dseg)) {
    CUtensorMap mdy, mw, mx, mds;
    const cuuint64_t yd[3] = {(cuuint64_t)hw, (cuuint64_t)N, (cuuint64_t)B};
    const cuuint64_t ys[2] = {(cuuint64_t)hw * 2, (cuuint64_t)N * hw * 2};
    const cuuint64_t wd[2] = {(cuuint64_t)N, (cuuint64_t)C};
    const cuuint64_t ws[1] = {(cuuint64_t)N * 2};
    const cuuint64_t xd[3] = {(cuuint64_t)hw, (cuuint64_t)C, (cuuint64_t)B};
    const cuuint64_t xs[2] = {(cuuint64_t)hw * 2, (cuuint64_t)x_bstride * 2};
    const cuuint64_t ds[2] = {(cuuint64_t)hw * 2, (cuuint64_t)C * hw * 2};
    if (!s2r_td::td_map(&mdy, dy, 3, yd, ys) || !s2r_td::td_map(&mw, wt, 2, wd, ws) ||
        !s2r_td::td_map(&mx, X, 3, xd, xs) || !s2r_td::td_map(&mds, dseg, 3, xd, ds))
      return cudaErrorInvalidValue;
    const int titems = B * ((hw + 127) / 128) * ((C + 127) / 128);
    rows = std::min(std::min(titems, sms), R);
    bwd1x1_dgrad_tma_kernel<<<rows, KT_THREADS, KT_DGRAD_SMEM, s>>>(
        mdy, mw, mx, mds, C, hw, B, scale, shift, mask, N, part_ss);
    S2R_TRY(cudaGetLastError());
    // one block per SM: one wave of splits (the rows of part_w the reduce adds)
    const int ctiles = (C + 127) / 128 * ((N + 127) / 128);
    splits = std::max(1, std::min(S, (sms + ctiles - 1) / ctiles));
    const dim3 grid((C + 127) / 128, (N + 127) / 128, splits);
    bwd1x1_wgrad_tma_kernel<<<grid, KT_THREADS, KT_WGRAD_SMEM, s>>>(
        mx, mdy, C, hw, B, scale, shift, mask, N, splits, part_w, part_gb);
    S2R_TRY(cudaGetLastError());
  } else {
    const int x_mode = mma::row_copy_mode(hw, x_bstride, X);
    const int dy_mode = mma::row_copy_mode(hw, (ll)N * hw, dy);
    const int vec_w = N % 8 == 0 && mma::aligned16(wt);
    const int vec_dseg = hw % 8 == 0 && mma::aligned16(dseg);
    bwd1x1_dgrad_mma_kernel<<<R, B1_THREADS, B1_SMEM + 8 * (size_t)C, s>>>(
        static_cast<const mma::u16*>(X), x_bstride, C, hw, B, scale, shift,
        static_cast<const mma::u16*>(wt), mask, N, static_cast<const mma::u16*>(dy),
        static_cast<mma::u16*>(dseg), part_ss, x_mode, dy_mode, vec_w, vec_dseg);
    S2R_TRY(cudaGetLastError());
    const dim3 grid((C + B1_KM - 1) / B1_KM, (N + B1_KM - 1) / B1_KM, S);
    bwd1x1_wgrad_mma_kernel<<<grid, B1_THREADS, B1_SMEM, s>>>(
        static_cast<const mma::u16*>(X), x_bstride, C, hw, B, scale, shift, mask, N,
        static_cast<const mma::u16*>(dy), S, part_w, part_gb, x_mode, dy_mode);
    S2R_TRY(cudaGetLastError());
  }
  const ll CN = (ll)C * N;
  const int wb = (int)((CN + 31) / 32);
  const int sb = (2 * C + 31) / 32;
  const int nb = (N + 31) / 32;
  bwd1x1_reduce_kernel<<<wb + sb + nb, THREADS, 0, s>>>(part_w, splits, CN, part_ss, rows,
                                                        2 * C, part_gb, N, dw, dscale,
                                                        dbias, wb, sb);
  return cudaGetLastError();
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
//   stored rounded, with its per-tile sums for dbias; ext is formed from
//   dy, c0, c1 and the y_j value already in registers (Outer).  K3b: the block's
//   c_in input channels in groups of 16 inside the block (weight rows
//   stream through two cp.async buffers), T(tot) stored.
// - stage_own_ring_kernel (K3a, own layer): a block owns a chunk of up to
//   64 input channels and a range of (image, tile) items, and computes per
//   item the input cotangent dA[q, k] (same product as above; its epilogue
//   takes relu'(z) and sums dz x and dz, nothing is stored) and the weight
//   cotangent dW[k, t, o] += a[q + off_t, k] G[q, o] (pixels contracted,
//   16 pixels a step), whose sums stay in registers across the block's
//   items; the next item's x and G boxes load while the current item's
//   products run (noted in full with its code below).  g_pre must be
//   complete before this kernel reads its halo: that is the launch
//   boundary between the two kernels.
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
constexpr int OR_STAGES = 2;                          // the own-layer kernel's ring
constexpr int OR_BW = 32;                             // box columns: 64-byte rows
constexpr int OR_X0 = 8;                              // the box column of image column tx0
constexpr int OR_BH = mma::C3_TH + 2;                 // box rows: the halo tile's
constexpr int OR_PLANE = OR_BH * OR_BW;               // one channel of a box
constexpr int OR_X = OW_KC * OR_PLANE;                // a stage: the x box,
constexpr int OR_STAGE = OR_X + mma::C3_N * OR_PLANE; // then the G box
constexpr int OR_WARPS = 8;
constexpr int OR_THREADS = 32 * OR_WARPS;
constexpr int OR_ROWS = mma::C3_TH / 2;               // a warp's output rows
constexpr int OR_SXI = mma::C3_TH * mma::C3_TW * OW_LD;  // x raw, the tile's own pixels
constexpr int OR_SMEM = 2 * (OR_STAGES * OR_STAGE + OW_SX + GP_SG + OR_SXI) +
                        4 * (OR_WARPS * 32 + 2 * OW_KC) + 8 * OR_STAGES + 1024;
static_assert(4 * (OW_KC / 16) * 72 * 32 <= 2 * OR_STAGES * OR_STAGE,
              "the row halves' dW sums fit the ring");
static_assert(OR_SMEM <= 232448, "an H100 block's shared memory");
// how a stage is filled: TMA boxes, 4-byte cp.async of pixel
// pairs, or plain loads and stores
enum RingLoad { kRingTma = 0, kRingPairs = 1, kRingPlain = 2 };

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

// K3a's rebuild of dy_j (C = G, ext.dy and mask given, groups = 1) and K3b
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
                     Outer ext, int nl, Layers L,
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
              const ll p = gy * W + gx;
              xv[m][nt][e] = in ? mma::bf(X[b * x_bstride + (ll)n * hw + p]) : 0.f;
              tot[m][nt][e] = (in && ext.dy != nullptr)
                                  ? outer_ext<__nv_bfloat16>(ext, b, n, hw, p, xv[m][nt][e])
                                  : 0.f;
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

// stage_own_ring_kernel: K3a's own layer, bf16, G outputs.
//
// What bounds it on an H100: an item (a 12 x 16 tile of one image and a
// chunk of 64 channels) is 1,728 mma.sync m16n8k16 (dA and dW, 4 x 9 x 16
// multiply-adds a channel and pixel) on 64 channels of the 14 x 18 halo
// tile and its 16 G channels.  The halo columns straddle 32-byte sectors,
// so an item reads three sectors a tile row and channel from L2 (3.5 times
// its own pixels): at the B=32 120x160 sites the loads alone take about
// half of the kernel's time, and the conversion of x into the a operand
// and the products with their epilogue each about as much again.  Loads
// that a block waits for before its products would add the first to the
// others.
//
// What the design does about it:
// - A ring of OR_STAGES stages in shared memory, each the raw x box
//   [channel][14][32] and G box [16][14][32] of one item (box column c at
//   image column tx0 - 8 + c, row r at ty0 - 1 + r), its arrival tracked by
//   a "full" mbarrier.  An item's loads are issued while the products of
//   the item two before it run, once that item's conversion has released
//   the stage, so they are in flight through the next item's conversion
//   and products.  The load engine follows the plane: where a plane row is
//   a multiple of 16 bytes (120x160, 60x80, 30x40) one thread issues two
//   TMA loads through tensor maps over the NCHW planes, (W, H, C, B) with
//   x's batch stride (x is a channel slice), elements past the tensor's
//   ends (the halo outside the image, channels past C or G) zero-filled;
//   a TMA box must start on a 16-byte column, hence 32 columns from
//   tx0 - 8.  Elsewhere the block's threads copy the in-image pixel pairs
//   with 4-byte cp.async (W even: 15x20, 7x10), or with plain loads and
//   stores (W odd: 3x5), each thread arriving on the stage's barrier.
// - The block builds the operands from the stage, shared memory to shared
//   memory: a = T(relu(x scale + shift)) as [halo pixel][channel] (zero
//   outside the image: the conv pads a, not x), G as [halo pixel][o], and x
//   itself over the tile's own pixels as [pixel][channel] for the dA
//   epilogue (conflict-free 4-byte reads of a lane's channel pair, where
//   the box's 896-byte channel planes put a lane's channels in one bank);
//   the conversion masks what lies outside the image or past the
//   channels, so a stage needs no zeros written.
// - Warp w takes the chunk's channels 16 (w / 2) .. + 15 and output rows 6
//   (w % 2) .. + 5 of every item.  It holds its weight fragments in
//   registers for the whole kernel, and reads each G fragment (halo row,
//   column shift) of the dA product and each a fragment of the dW product
//   once for up to three taps: 432 ldmatrix.x4 an item for its 1,728
//   products (1,440 with a read a tap).
// - Blocks (one an SM, 256 threads, so that a thread may hold 255
//   registers) walk their item range with the chunk's weights resident.
//   Its sums are deterministic: per-split partial rows over
//   the items in order, each channel's dz sums and each dW sum carried in
//   one lane's registers across the items, the two row halves added in a
//   fixed order at the end, the splits by stage_reduce_kernel; no atomics,
//   the same bits on every run.

// Fills a stage without TMA, by the block's threads: channel planes
// [0, nux) of x (from xsrc, plane stride hw) into the x box and [0, 16) of
// G (gsrc) into the G box, at the pixel pairs from image column tx0 - 2
// and the halo rows that lie in the image; a thread keeps one (row, pair)
// position and walks the channels.  Positions outside the image and
// channels past nvalid (x) or G are not written: the conversion masks
// them.  kRingPairs: 4-byte cp.async (W even, pair loads aligned); else
// plain loads and stores, pixel by pixel.
__device__ __forceinline__ void ring_fill(mma::u16* box, const mma::u16* xsrc,
                                          const mma::u16* gsrc, int nux, int nvalid, int G,
                                          int hw, int H, int W, int ty0, int tx0, int mode) {
  const int hy0 = max(0, 1 - ty0);
  const int nh = min(OR_BH, H - ty0 + 1) - hy0;
  const int p0 = tx0 == 0 ? 1 : 0;  // pair p holds image columns tx0 - 2 + 2p and + 1
  const int np = min(mma::C3_PAIRS, (W - tx0 + 3) / 2) - p0;
  const int P = nh * np;
  const int groups = OR_THREADS / P;
  if ((int)threadIdx.x >= groups * P) return;
  const int hy = hy0 + (int)threadIdx.x % P / np;
  const int p = p0 + (int)threadIdx.x % P % np;
  const int gx = tx0 - 2 + 2 * p;
  const ll off = (ll)(ty0 - 1 + hy) * W + gx;
  mma::u16* d0 = box + hy * OR_BW + OR_X0 - 2 + 2 * p;
  for (int r = threadIdx.x / P; r < nux + mma::C3_N; r += groups) {
    const bool isx = r < nux;
    const int ch = isx ? r : r - nux;
    if (ch >= (isx ? nvalid : G)) continue;
    const mma::u16* sp = (isx ? xsrc : gsrc) + (ll)ch * hw + off;
    mma::u16* d = d0 + (isx ? r : OW_KC + ch) * OR_PLANE;
    if (mode == kRingPairs) {
      mma::cp_async4(d, sp, 4);
    } else {
      const uint32_t b = gx + 1 < W ? sp[1] : 0u;
      *reinterpret_cast<uint32_t*>(d) = sp[0] | (b << 16);
    }
  }
}

// Warp w's share of turning a stage's x box into operands: its
// eight channels 8w .. 8w + 7 of the chunk (w < 2 nu) over the halo tile,
// two halo rows a round, a lane a pixel pair (image columns tx0 - 2 + 2j
// and the next: halo columns 2j - 1, 2j; j < C3_PAIRS of 16 slots, so that
// a round's 4-byte reads of one channel fall in distinct banks).  It
// writes a = T(relu(x * scale + shift)) to sA ([halo pixel][channel], zero
// outside the image and for channels >= nvalid) and, for the tile's own
// pixels, x as it is (zero there too) to sX ([pixel][channel]).
__device__ __forceinline__ void ring_x_to_px(mma::u16* sA, mma::u16* sX, const mma::u16* box,
                                             int H, int W, int ty0, int tx0, int nvalid,
                                             const float* ssc, const float* ssh) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int j = lane % 16;
  const int c8 = 8 * warp;
  float sc[8], sh[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    sc[e] = ssc[c8 + e];
    sh[e] = ssh[c8 + e];
  }
  if (j >= mma::C3_PAIRS) return;
  const int gx = tx0 - 2 + 2 * j;
  const bool inA = gx >= 0 && gx < W;
  const bool inB = gx + 1 >= 0 && gx + 1 < W;
  const mma::u16* col = box + c8 * OR_PLANE + OR_X0 - 2 + 2 * j;
#pragma unroll
  for (int r = 0; r < OR_BH / 2; ++r) {
    const int hy = 2 * r + lane / 16;
    const int gy = ty0 - 1 + hy;
    const bool row = gy >= 0 && gy < H;
    const uint32_t keep = (row && inA ? 0x0000ffffu : 0u) | (row && inB ? 0xffff0000u : 0u);
    uint32_t v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e)
      v[e] = *reinterpret_cast<const uint32_t*>(col + e * OR_PLANE + hy * OR_BW) &
             (c8 + e < nvalid ? keep : 0u);
    if (hy >= 1 && hy <= mma::C3_TH && j >= 1 && j <= mma::C3_TW / 2) {
      const int px = ((hy - 1) * mma::C3_TW + 2 * j - 2) * OW_LD + c8;
      *reinterpret_cast<uint4*>(sX + px) = mma::c3_gather<0x5410>(v);
      *reinterpret_cast<uint4*>(sX + px + OW_LD) = mma::c3_gather<0x7632>(v);
    }
#pragma unroll
    for (int e = 0; e < 8; ++e)
      v[e] = mma::pack_bf16x2_relu(affine(mma::lo_f(v[e]), sc[e], sh[e]),
                                   affine(mma::hi_f(v[e]), sc[e], sh[e])) &
             (c8 + e < nvalid ? keep : 0u);
    const int pa = (hy * mma::C3_HW + 2 * j - 1) * OW_LD + c8;
    if (j >= 1) *reinterpret_cast<uint4*>(sA + pa) = mma::c3_gather<0x5410>(v);
    if (j < mma::C3_PAIRS - 1)
      *reinterpret_cast<uint4*>(sA + pa + OW_LD) = mma::c3_gather<0x7632>(v);
  }
}

// A stage's G box into sG ([halo pixel][o]) by the block's warps: warp w
// takes channel group w % 2 over halo row pairs w / 2 and w / 2 + 4 (the
// seven pairs of the 14 rows), a lane a pixel pair as in ring_x_to_px,
// zero outside the image and past G.
__device__ __forceinline__ void ring_g_to_px(mma::u16* sG, const mma::u16* box, int G,
                                             int H, int W, int ty0, int tx0) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int j = lane % 16;
  if (j >= mma::C3_PAIRS) return;
  const int c8 = 8 * (warp % 2);
  const int gx = tx0 - 2 + 2 * j;
  const bool inA = gx >= 0 && gx < W;
  const bool inB = gx + 1 >= 0 && gx + 1 < W;
  const mma::u16* col = box + c8 * OR_PLANE + OR_X0 - 2 + 2 * j;
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int hy = 2 * (warp / 2 + 4 * q) + lane / 16;
    if (hy >= OR_BH) break;
    const int gy = ty0 - 1 + hy;
    const bool row = gy >= 0 && gy < H;
    const uint32_t keep = (row && inA ? 0x0000ffffu : 0u) | (row && inB ? 0xffff0000u : 0u);
    uint32_t v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e)
      v[e] = *reinterpret_cast<const uint32_t*>(col + e * OR_PLANE + hy * OR_BW) &
             (c8 + e < G ? keep : 0u);
    const int pa = (hy * mma::C3_HW + 2 * j - 1) * GP_LD + c8;
    if (j >= 1) *reinterpret_cast<uint4*>(sG + pa) = mma::c3_gather<0x5410>(v);
    if (j < mma::C3_PAIRS - 1)
      *reinterpret_cast<uint4*>(sG + pa + GP_LD) = mma::c3_gather<0x7632>(v);
  }
}

template <int G>
__global__ void __launch_bounds__(OR_THREADS, 1)
stage_own_ring_kernel(const __grid_constant__ CUtensorMap map_x,
                      const __grid_constant__ CUtensorMap map_g, const mma::u16* X,
                      ll x_bstride, int C, int B, int H, int W,
                      const float* __restrict__ scale, const float* __restrict__ shift,
                      const mma::u16* __restrict__ wt, const mma::u16* gp, int nu, int S,
                      float* __restrict__ part, int mode) {
  extern __shared__ __align__(128) unsigned char smem[];
  mma::u16* ring = reinterpret_cast<mma::u16*>(
      smem + ((1024 - (mma::smem_u32(smem) & 1023)) & 1023));  // [stage][x box | G box]
  mma::u16* sA = ring + OR_STAGES * OR_STAGE;                  // a: [halo px][OW_LD]
  mma::u16* sG = sA + OW_SX;                                   // G: [halo px][GP_LD]
  mma::u16* sX = sG + GP_SG;                                   // x: [tile px][OW_LD]
  float* red = reinterpret_cast<float*>(sX + OR_SXI);          // [warp][16][2]
  float* ssc = red + OR_WARPS * 32;                            // the chunk's BN scale
  float* ssh = ssc + OW_KC;                                    // and shift
  uint64_t* full = reinterpret_cast<uint64_t*>(ssh + OW_KC);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int k0 = blockIdx.x * nu * 16;
  const int split = blockIdx.y;
  const int hw = H * W;
  const int tiles_x = mma::c3_tiles_x(W);
  const int tiles = mma::c3_tiles(H, W);
  const int items = B * tiles;
  const int per = (items + S - 1) / S;
  const int i_begin = min(items, split * per);
  const int n_items = min(items, i_begin + per) - i_begin;
  const ll MW = (ll)C * (9 * G + 2);                           // a partial row: dW, dscale, dshift

  if (tid == 0) {
    for (int i = 0; i < OR_STAGES; ++i)
      mma::mbar_init(full + i, mode == kRingTma ? 1 : OR_THREADS);  // else each copier
    mma::mbar_fence_init();
  }
  for (int i = tid; i < OW_KC; i += OR_THREADS) {
    ssc[i] = k0 + i < C ? scale[k0 + i] : 0.f;
    ssh[i] = k0 + i < C ? shift[k0 + i] : 0.f;
  }
  __syncthreads();

  // item k of this block: its image and tile origin
  auto item_at = [&](int k, int& b, int& ty0, int& tx0) {
    const int item = i_begin + k;
    b = item / tiles;
    const int tile = item - b * tiles;
    ty0 = (tile / tiles_x) * mma::C3_TH;
    tx0 = (tile % tiles_x) * mma::C3_TW;
  };

  // Loads item k into its stage: two TMA boxes issued by thread 0, or the
  // block's copies, each thread arriving on the stage's barrier once its
  // copies have landed.  The stage's last reader is the conversion of item
  // k - OR_STAGES, which every warp has finished at the barrier before
  // that item's products.
  auto load = [&](int k) {
    if (k >= n_items) return;
    const int st = k % OR_STAGES;
    int b, ty0, tx0;
    item_at(k, b, ty0, tx0);
    mma::u16* box = ring + st * OR_STAGE;
    if (mode == kRingTma) {
      if (tid == 0) {
        mma::fence_async_smem();  // the conversion's reads before the TMA's writes
        mma::mbar_expect_tx(full + st, (nu + 1) * 16 * OR_PLANE * 2);
        mma::tma_load_4d(box, &map_x, full + st, tx0 - OR_X0, ty0 - 1, k0, b);
        mma::tma_load_4d(box + OR_X, &map_g, full + st, tx0 - OR_X0, ty0 - 1, 0, b);
      }
      return;
    }
    ring_fill(box, X + b * x_bstride + (ll)k0 * hw, gp + (ll)b * G * hw, 16 * nu, C - k0, G,
              hw, H, W, ty0, tx0, mode);
    if (mode == kRingPairs) mma::cp_async_arrive(full + st);
    else mma::mbar_arrive(full + st);
  };
  for (int k = 0; k < OR_STAGES; ++k) load(k);

  // warp (u, h): channels 16 u .. 16 u + 15 of the chunk, output rows
  // OR_ROWS h .. of every item
  const int u = warp / 2;
  const int h = warp % 2;
  const bool busy = u < nu;  // warp-uniform
  const mma::C3Lane ln(lane);
  // W[k, t, o] as the dA product's B fragments (o the depth), per tap
  uint32_t wf[9][4];
#pragma unroll
  for (int t = 0; t < 9; ++t)
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int k = k0 + 16 * u + 8 * (m / 2) + ln.g;
      wf[t][m] = busy && k < C
                     ? __ldg(reinterpret_cast<const uint32_t*>(
                           wt + (ll)k * mma::C3_WROW + t * mma::C3_N + 8 * (m % 2) + 2 * ln.t))
                     : 0u;
    }
  // this lane's accumulator channels 16 u + 8 nt + 2 t + j
  float scv[2][2], shv[2][2];
  bool live[2][2];
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int k = k0 + 16 * u + 8 * nt + 2 * ln.t + j;
      live[nt][j] = busy && k < C;
      scv[nt][j] = scale[min(k, C - 1)];
      shv[nt][j] = shift[min(k, C - 1)];
    }
  float sd[2][2] = {{0.f, 0.f}, {0.f, 0.f}};  // sums of dz x and dz over the items
  float sz[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
  float accw[3][3][2][4];                     // dW[k, (ky, kx), o] of this warp's rows
#pragma unroll
  for (int ky = 0; ky < 3; ++ky)
#pragma unroll
    for (int kx = 0; kx < 3; ++kx)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) accw[ky][kx][nt][e] = 0.f;

  const uint32_t a_sm = mma::smem_u32(sA);
  const uint32_t g_sm = mma::smem_u32(sG);
  const int y0 = OR_ROWS * h;
  for (int k = 0; k < n_items; ++k) {
    const int st = k % OR_STAGES;
    int b, ty0, tx0;
    item_at(k, b, ty0, tx0);
    const mma::u16* box = ring + st * OR_STAGE;
    mma::mbar_wait(full + st, (k / OR_STAGES) & 1);
    __syncthreads();  // the last item's products are done with sA, sG, sX
    if (warp < 2 * nu) ring_x_to_px(sA, sX, box, H, W, ty0, tx0, C - k0, ssc, ssh);
    ring_g_to_px(sG, box + OR_X, G, H, W, ty0, tx0);
    __syncthreads();  // the operands are complete, and the stage is read

    if (busy) {
      // input cotangent: dA[q, k] = sum_{t,o} G[q - off_t, o] W[k, t, o];
      // the G fragment of halo row y0 + hl, column shift s serves output
      // row y = hl - 2 + ky of the warp through tap (ky, 2 - s)
      float acc[OR_ROWS][2][4];
#pragma unroll
      for (int y = 0; y < OR_ROWS; ++y)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[y][nt][e] = 0.f;
#pragma unroll
      for (int hl = 0; hl < OR_ROWS + 2; ++hl)
#pragma unroll
        for (int s = 0; s < 3; ++s) {
          uint32_t af[4];  // G[q - off_t, o]: stored [pixel][o]
          mma::ldsm_x4(af, g_sm + 2u * (uint32_t)(((y0 + hl) * mma::C3_HW + ln.r8 +
                                                   8 * ln.j0 + s) * GP_LD + 8 * ln.j1));
#pragma unroll
          for (int ky = 0; ky < 3; ++ky) {
            const int y = hl - 2 + ky;
            if (y < 0 || y >= OR_ROWS) continue;
            const int t = ky * 3 + 2 - s;
            mma::mma_16816(acc[y][0], af, wf[t][0], wf[t][1]);
            mma::mma_16816(acc[y][1], af, wf[t][2], wf[t][3]);
          }
        }
      // dz = dA relu'(z), z from x raw (sX: a 4-byte read holds both of a
      // lane's channels); sums of dz x and dz
#pragma unroll
      for (int y = 0; y < OR_ROWS; ++y) {
        const int gy = ty0 + y0 + y;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int eh = 0; eh < 2; ++eh) {
            const int px = ln.g + 8 * eh;
            const uint32_t xw2 = *reinterpret_cast<const uint32_t*>(
                sX + ((y0 + y) * mma::C3_TW + px) * OW_LD + 16 * u + 8 * nt + 2 * ln.t);
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const int e = 2 * eh + j;
              const float xf = j ? mma::hi_f(xw2) : mma::lo_f(xw2);
              const bool in = gy < H && tx0 + px < W && live[nt][j];
              const float dz = in ? __fmul_rn(acc[y][nt][e],
                                              relu_d(affine(xf, scv[nt][j], shv[nt][j])))
                                  : 0.f;
              sd[nt][j] += __fmul_rn(dz, xf);
              sz[nt][j] += dz;
            }
          }
      }
    }
    // the item after next into the stage this item was converted from,
    // while this item's products run
    load(k + OR_STAGES);

    if (busy) {
      // weight cotangent: dW[k, t, o] += sum_q a[q + off_t, k] G[q, o], one
      // row of 16 pixels a step; the a fragment of halo row y0 + hl,
      // column kx serves output row y = y0 + hl - ky, whose G fragments
      // stay in a window of three
      uint32_t gq[3][4];
#pragma unroll
      for (int hl = 0; hl < OR_ROWS + 2; ++hl) {
        if (hl < OR_ROWS)  // G[q, o]: stored [pixel][o], pixels are the depth
          mma::ldsm_x4_t(gq[hl % 3], g_sm + 2u * (uint32_t)(((y0 + hl + 1) * mma::C3_HW +
                                                             ln.r8 + 8 * ln.j0 + 1) * GP_LD +
                                                            8 * ln.j1));
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          uint32_t af[4];  // a[q + off_t, k]: stored [pixel][k]
          mma::ldsm_x4_t(af, a_sm + 2u * (uint32_t)(((y0 + hl) * mma::C3_HW + ln.r8 +
                                                     8 * ln.j1 + kx) * OW_LD + 16 * u +
                                                    8 * ln.j0));
#pragma unroll
          for (int ky = 0; ky < 3; ++ky) {
            const int y = hl - ky;
            if (y < 0 || y >= OR_ROWS) continue;
            mma::mma_16816(accw[ky][kx][0], af, gq[y % 3][0], gq[y % 3][1]);
            mma::mma_16816(accw[ky][kx][1], af, gq[y % 3][2], gq[y % 3][3]);
          }
        }
      }
    }
  }

  // the partial row: dW of each unit as half 0's sum plus half 1's (passed
  // through the ring, free now), dscale and dshift over both halves
  __syncthreads();  // every item is done: no load is in flight
  float* xw = reinterpret_cast<float*>(ring);  // [unit][72][32 lanes]
  if (busy && h == 1) {
#pragma unroll
    for (int ky = 0; ky < 3; ++ky)
#pragma unroll
      for (int kx = 0; kx < 3; ++kx)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            xw[(u * 72 + ((ky * 3 + kx) * 2 + nt) * 4 + e) * 32 + lane] = accw[ky][kx][nt][e];
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
      if (ln.g == 0) {
        float* r = red + (warp * 16 + 8 * nt + 2 * ln.t + j) * 2;
        r[0] = v;
        r[1] = z;
      }
    }
  __syncthreads();
  float* prow = part + (ll)split * MW;
  if (busy && h == 0) {
#pragma unroll
    for (int ky = 0; ky < 3; ++ky)
#pragma unroll
      for (int kx = 0; kx < 3; ++kx)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int k = k0 + 16 * u + ln.g + 8 * (e / 2);
            const int o = 8 * nt + 2 * ln.t + (e & 1);
            const float v = accw[ky][kx][nt][e] +
                            xw[(u * 72 + ((ky * 3 + kx) * 2 + nt) * 4 + e) * 32 + lane];
            if (k < C && (G == mma::C3_N || o < G))
              prow[((ll)k * 9 + ky * 3 + kx) * G + o] = v;
          }
  }
  if (tid < nu * 16 && k0 + tid < C) {
    const float* r0 = red + ((tid / 16) * 32 + tid % 16) * 2;  // warps 2u, 2u + 1
    prow[(ll)C * 9 * G + k0 + tid] = r0[0] + r0[32];
    prow[(ll)C * 9 * G + C + k0 + tid] = r0[1] + r0[33];
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
  return cudaFuncSetAttribute(stage_own_ring_kernel<G>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, OR_SMEM);
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
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)B1_SMEM));
  S2R_TRY(cudaFuncSetAttribute(bwd1x1_dgrad_tma_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)KT_DGRAD_SMEM));
  S2R_TRY(cudaFuncSetAttribute(bwd1x1_wgrad_tma_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)KT_WGRAD_SMEM));
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
                          const Outer& ext, int nl, const Layers& L,
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

// A bf16 tensor map over NCHW planes, dims (W, H, C, B) with a batch
// stride of bstride elements, and boxes of OR_BW x OR_BH pixels and box_c
// channels without swizzle: a box lands as [channel][row][column], zeros
// for its elements past the tensor's ends.
static bool ring_map(CUtensorMap* m, const void* base, int W, int H, int C, int B,
                     ll bstride, int box_c) {
  const s2r_td::EncodeTiled enc = s2r_td::td_encoder();
  const cuuint64_t dims[4] = {(cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)C, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)W * 2, (cuuint64_t)H * W * 2,
                                 (cuuint64_t)bstride * 2};
  const cuuint32_t box[4] = {OR_BW, OR_BH, (cuuint32_t)box_c, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return enc != nullptr &&
         enc(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides,
             box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// K3a, bf16, G outputs.  res: [K * 9G dW | K dscale | K dshift | G dbias];
// scratch part_gp [G][B * tiles] (tiles of 12 x 16 pixels), part_w
// [S][K * (9G + 2)].
template <int G>
cudaError_t stage_mma(const void* X, ll x_bstride, int B, int K, int H, int W,
                      const void* Y, ll y_bstride, const Outer& ext, int nl,
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
  // the ring's load engine, by what the planes allow
  CUtensorMap mx, mg;
  memset(&mx, 0, sizeof mx);
  mg = mx;
  int mode = mma::c3_pair_loads(W, x_bstride, X) && mma::c3_pair_loads(W, 0, gp_out)
                 ? kRingPairs : kRingPlain;
  if (W % 8 == 0 && x_bstride % 8 == 0 && mma::aligned16(X) && mma::aligned16(gp_out)) {
    if (!ring_map(&mx, X, W, H, K, B, x_bstride, 16 * nu) ||
        !ring_map(&mg, gp_out, W, H, G, B, (ll)G * H * W, mma::C3_N))
      return cudaErrorInvalidValue;
    mode = kRingTma;
  }
  stage_own_ring_kernel<G><<<dim3(chunks, S), OR_THREADS, OR_SMEM, s>>>(
      mx, mg, static_cast<const mma::u16*>(X), x_bstride, K, B, H, W, scale, shift,
      static_cast<const mma::u16*>(wt), static_cast<const mma::u16*>(gp_out), nu, S,
      part_w, mode);
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
                  const void* Y, ll y_bstride, int G, const Outer& ext, int nl,
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
// tap (bwd1x1_mma, any N), which leaves gbuf unused and wants dscale and
// dshift contiguous: part_gp [S * N], part_ss [R * 2K], part_w [S * K * N]
// with R = min(ceil(B*H*W / 128) * ceil(K / 128), 264).
// stage's outside cotangent of Y is dy + T(c0 + c1 * Y) (Outer): dy in the
// dtype with batch stride dy_bstride, c0 and c1 [G] f32.

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
  if (dtype == 1 && taps == 1 && K <= s2r_td::TD_MAX_K) {
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
#undef S2R_BWD
  if (dtype == 1 && taps == 1) {
    *route = 1;
    return bwd1x1_mma(X, x_bstride, B, K, H, W, scale, shift, wt, mask, N, dy,
                      dseg, dscale, dshift, dw, dbias, part_gp, part_ss, part_w, S, s);
  }
  return cudaErrorInvalidValue;
}

extern "C" int s2r_train_stage(int dtype, const void* X, ll x_bstride, int B,
                               int K, int H, int W, const void* Y,
                               ll y_bstride, int G, const void* dy,
                               ll dy_bstride, const float* c0,
                               const float* c1, int nl,
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
  if (nl < 0 || nl > MAXL || dy == nullptr || c0 == nullptr || c1 == nullptr)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Layers L = make_layers(nl, gps, w_slices, scs, shs);
  const Outer ext = {dy, dy_bstride, c0, c1};
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
                                        Outer{}, nullptr, dseg, nullptr, nullptr, s);
  if (dtype == 1 && mma_growth(G)) {
    *route = 1;
    return (G == 12 ? sum_dgrad_mma<12> : sum_dgrad_mma<16>)(
        X, x_bstride, B, K, H, W, Outer{}, nl, L, nullptr, dseg, nullptr, s);
  }
  if (dtype == 1)
    return launch_dgrad<__nv_bfloat16, 9, true>(X, x_bstride, B, K, H, W, G, nl, L,
                                                Outer{}, nullptr, dseg, nullptr,
                                                nullptr, s);
  return cudaErrorInvalidValue;
}

// Sets the shared-memory limits of the tensor-core kernels on the current
// device; called once when the library is loaded, before any launch.
extern "C" int s2r_train_init() { return setup_all(); }

extern "C" const char* s2r_train_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
