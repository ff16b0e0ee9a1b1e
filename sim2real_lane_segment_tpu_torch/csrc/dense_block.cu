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
// The bf16 dense layers with growth 16 (every FCDenseNet67 and
// FCDenseNet103 site) run on the tensor cores: dense3x3_mma_kernel, the
// shared 3x3 forward body of dense3x3_mma.cuh (mma.sync m16n8k16 over
// [halo pixel][channel] tiles, a 12 x 16 pixel tile and 32-channel chunks,
// the channel loop split across a thread-block cluster at small planes)
// with serving's epilogue T(D + bias); its note is in that header.  The
// bf16 TransitionDown (td_fwd_small_kernel, td_fwd_mma_kernel) runs on the
// tensor cores too; the kernels and their note are in td_fwd_mma.cuh,
// which the training forward shares.
//
// The CUDA-core kernels below (conv_bnrelu_kernel, classifier_kernel)
// serve float32, the parity control (TF32 would not hold the TransitionDown
// to 1e-5), other growth rates (FCDenseNet57's 12) and the classifier.
// What bounds them: at FCDenseNet67, 120x160, the 55 dense layers are 13.7
// GFLOP per frame; one layer launch reads c_j channels and writes 16, 144
// operations per bf16 byte moved, below the H100's ~295 bf16 tensor-core
// operations per byte: a tensor-core layer launch is bound by bytes.  These
// kernels compute on the CUDA cores in f32 (67 TFLOP/s peak, not 989), so
// they are bound by their FMA issue rate.  Their design is the simple,
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

// Classifier tail: one thread per pixel.
//   in:  [B, C, H*W] features in T;  wc: [8][C] in T;  cb: [8] f32
//   out: [B, 8, H*W] f32
template <typename T>
__global__ void __launch_bounds__(256)
classifier_kernel(const T* __restrict__ in, long long in_bstride, int C,
                  long long hw, int B, const T* __restrict__ wc,
                  const float* __restrict__ cb, float inv_temp,
                  float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)B * hw) return;
  const long long b = i / hw;
  const long long p = i - b * hw;
  const T* f = in + b * in_bstride + p;
  float n2 = 0.f;
  for (int c = 0; c < C; ++c) {
    const float v = to_f<T>(f[c * hw]);
    n2 = fmaf(v, v, n2);
  }
  const float inv = 1.f / fmaxf(sqrtf(n2), 1e-12f);
  float u[8];
#pragma unroll
  for (int o = 0; o < 8; ++o) u[o] = 0.f;
  for (int c = 0; c < C; ++c) {
    const float fn = round_to<T>(__fmul_rn(to_f<T>(f[c * hw]), inv));
#pragma unroll
    for (int o = 0; o < 8; ++o) u[o] = fmaf(to_f<T>(wc[o * C + c]), fn, u[o]);
  }
  float* ob = out + b * 8 * hw + p;
#pragma unroll
  for (int o = 0; o < 8; ++o) ob[o * hw] = __fmul_rn(__fadd_rn(u[o], cb[o]), inv_temp);
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

// The bf16 dense layer with growth 16: the shared body, serving's epilogue
__global__ void __launch_bounds__(s2r_mma::C3_THREADS, 3)
dense3x3_mma_kernel(const s2r_mma::u16* X, long long x_bstride, int K, int H, int W,
                    const float* __restrict__ scale, const float* __restrict__ shift,
                    const s2r_mma::u16* __restrict__ wt, const float* __restrict__ bias,
                    const float* __restrict__ mask, s2r_mma::u16* out,
                    long long out_bstride, int pair) {
  s2r_d3::fwd3x3_body<false>(X, x_bstride, K, H, W, scale, shift, wt, bias, mask, out,
                             out_bstride, pair);
}

cudaError_t launch_dense_mma(const void* in, long long in_bstride, int B, int K, int H,
                             int W, const float* scale, const float* shift,
                             const void* wt, const float* bias, void* out,
                             long long out_bstride, int* splits, cudaStream_t stream) {
  static bool ready = false;  // the shared-memory limit, set once
  if (!ready) {
    const cudaError_t e = cudaFuncSetAttribute(
        dense3x3_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, s2r_d3::SMEM);
    if (e != cudaSuccess) return e;
    ready = true;
  }
  return s2r_d3::launch_fwd3x3(dense3x3_mma_kernel, in, in_bstride, B, K, H, W, scale,
                               shift, wt, bias, nullptr, out, out_bstride, stream, splits);
}

template <typename T>
cudaError_t launch_classifier(const void* in, long long in_bstride, int B,
                              int C, long long hw, const void* wc,
                              const float* cb, float inv_temp, float* out,
                              cudaStream_t stream) {
  const long long n = (long long)B * hw;
  const int threads = 256;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  classifier_kernel<T><<<blocks, threads, 0, stream>>>(
      static_cast<const T*>(in), in_bstride, C, hw, B,
      static_cast<const T*>(wc), cb, inv_temp, out);
  return cudaGetLastError();
}

}  // namespace

// Plain C interface, bound with ctypes.  dtype: 0 = float32, 1 = bfloat16.
// taps: 9 (dense layer) or 1 (TransitionDown).  Each returns the
// cudaError_t of its launch (0 on success); an unknown dtype or tap count
// returns cudaErrorInvalidValue.  Dispatch (takes_mma_dense in
// kernels/dense_block.py states it for the CPU tests): a bfloat16 dense
// layer with 16 outputs runs on the tensor cores (dense3x3_mma_kernel; its
// weight must be 16-byte aligned, else cudaErrorMisalignedAddress), a
// bfloat16 TransitionDown too (td_fwd_mma_kernel) when its x tile fits in
// shared memory (C <= 768: every FCDenseNet57/67/103 site); float32, other
// growth rates and a wider TransitionDown on the CUDA cores.  *route
// receives the route taken: 0 for the CUDA cores, 1 for the tensor-core
// TransitionDown, and for the tensor-core dense layer the blocks S >= 1
// that split its channel loop.
extern "C" int s2r_conv_bnrelu(int dtype, int taps, const void* in,
                               long long in_bstride, int B, int K, int H,
                               int W, const float* scale, const float* shift,
                               const void* wt, const float* bias, int N,
                               void* out, long long out_bstride,
                               int round_first, int* route, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  *route = 0;
  if (dtype == 0 && taps == 9)
    return launch_conv<float, 9>(in, in_bstride, B, K, H, W, scale, shift, wt,
                                 bias, N, out, out_bstride, round_first, s);
  if (dtype == 0 && taps == 1)
    return launch_conv<float, 1>(in, in_bstride, B, K, H, W, scale, shift, wt,
                                 bias, N, out, out_bstride, round_first, s);
  if (dtype == 1 && taps == 9 && N == s2r_mma::C3_N)
    return launch_dense_mma(in, in_bstride, B, K, H, W, scale, shift, wt, bias, out,
                            out_bstride, route, s);
  if (dtype == 1 && taps == 9)
    return launch_conv<__nv_bfloat16, 9>(in, in_bstride, B, K, H, W, scale,
                                         shift, wt, bias, N, out, out_bstride,
                                         round_first, s);
  if (dtype == 1 && taps == 1 && s2r_td::td_smem(K, N) <= s2r_td::TD_SMEM_MAX) {
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
