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
// What bounds it: the dense layers of FCDenseNet67 at 120x160 are 13.7
// GFLOP per frame forward and twice that backward.  A layer launch moves
// c_j + 16 channels for 144 operations per input value, so with the f32
// CUDA cores (67 TFLOP/s) these kernels are bound by FMA issue, not bytes.
//
// What the design does about it: this is the simple, correct first kernel.
// Each block stages 16 channels of a 16x16 pixel tile (plus a one-pixel
// halo) in shared memory with BN, ReLU and rounding applied once per staged
// value, and reuses each staged value for 16 outputs and 9 taps from
// shared memory; sums stay in registers.  wgmma, TMA and keeping the
// block's buffer on chip are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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
__global__ void __launch_bounds__(THREADS)
reduce_rows_kernel(const float* __restrict__ part, int P, ll M,
                   float* __restrict__ out) {
  __shared__ float red[WARPS][32];
  const int lane = threadIdx.x % 32;
  const int rg = threadIdx.x / 32;
  const ll col = (ll)blockIdx.x * 32 + lane;
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

int n_tiles(int H, int W) { return ((H + TH - 1) / TH) * ((W + TW - 1) / TW); }

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
// dtype, tap count or layer count returns cudaErrorInvalidValue.  Scratch
// (gbuf, part_*) is allocated by the caller:
//   part_gp  [B * N] floats (bwd) or [B * tiles * G] (stage)
//   part_ss  [2 * B * tiles * K]   part_w [S * K * taps * N]
// with tiles = ceil(H/16) * ceil(W/16).

extern "C" int s2r_train_fwd(int dtype, int taps, const void* X, ll x_bstride,
                             int B, int K, int H, int W, const float* scale,
                             const float* shift, const void* wt,
                             const float* bias, const float* mask, int N,
                             void* out, ll out_bstride, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && taps == 9)
    return fwd<float, 9>(X, x_bstride, B, K, H, W, scale, shift, wt, bias, mask, N,
                         out, out_bstride, s);
  if (dtype == 0 && taps == 1)
    return fwd<float, 1>(X, x_bstride, B, K, H, W, scale, shift, wt, bias, mask, N,
                         out, out_bstride, s);
  if (dtype == 1 && taps == 9)
    return fwd<__nv_bfloat16, 9>(X, x_bstride, B, K, H, W, scale, shift, wt, bias,
                                 mask, N, out, out_bstride, s);
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
                             int S, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define S2R_BWD(T, TAPS)                                                      \
  bwd<T, TAPS>(X, x_bstride, B, K, H, W, scale, shift, wt, mask, N, dy, dseg, \
               dscale, dshift, dw, dbias, gbuf, part_gp, part_ss, part_w, S, s)
  if (dtype == 0 && taps == 9) return S2R_BWD(float, 9);
  if (dtype == 0 && taps == 1) return S2R_BWD(float, 1);
  if (dtype == 1 && taps == 9) return S2R_BWD(__nv_bfloat16, 9);
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
                               int S, void* stream) {
  if (nl < 0 || nl > MAXL) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Layers L = make_layers(nl, gps, w_slices, scs, shs);
  if (dtype == 0)
    return stage<float>(X, x_bstride, B, K, H, W, Y, y_bstride, G, ext, nl, L, wt,
                        scale, shift, mask, gp_out, dw, dscale, dshift, dbias,
                        part_gp, part_ss, part_w, S, s);
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
                               void* stream) {
  if (nl < 1 || nl > MAXL) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Layers L = make_layers(nl, gps, w_slices, scs, shs);
  if (dtype == 0)
    return launch_dgrad<float, 9, true>(X, x_bstride, B, K, H, W, G, nl, L,
                                        nullptr, nullptr, dseg, nullptr, nullptr, s);
  if (dtype == 1)
    return launch_dgrad<__nv_bfloat16, 9, true>(X, x_bstride, B, K, H, W, G, nl, L,
                                                nullptr, nullptr, dseg, nullptr,
                                                nullptr, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* s2r_train_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
