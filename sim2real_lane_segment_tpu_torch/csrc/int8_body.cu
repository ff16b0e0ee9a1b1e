// LaneNetLite int8 residual body plus the 1x1 head, for NVIDIA Hopper
// (sm_90a).
//
// Replaces the TPU kernel K6 of the JAX package:
//   sim2real_lane_segment_tpu/models/lanenet_pallas.py
//   _body_kernel, launched by _run_body (pallas_call at :260).
//
// What it computes.  Activations are rows of pixels, [B, P = h*w, C], and
// every activation code is an int8 q standing for act_scale * (q + zp).
// A conv site (3x3 with dilation 1, 2 or 4, or a 1x1 shortcut) is an int8
// x int8 -> int32 sum over its taps, the border filled with the code -zp;
// its epilogue is
//   y = (float(acc) + zp*colsum) * (act_scale*w_scale) + bias [, ReLU],
// and then, as the site's role asks:
//   conv1:    requant with conv2's scale,        q = clip(rint(y/s) - zp);
//   shortcut: y in f32;
//   conv2:    h = max(y + short, 0) in f32 (the residual carry), and its
//             requant with the next block's conv1 scale.
// The quantize entry turns the f32 stem output into the first codes; the
// head entry computes the f32 logits h @ W + b.  Each step uses the
// operations of the JAX path in its order, with __fadd_rn/__fmul_rn/
// __fdiv_rn so that nvcc cannot contract or reassociate them: all but the
// head are bit-exact against lanenet_int8._conv_i8/_quant.
//
// What bounds it: the body is 1.75 G int8 operations per 120x160 frame
// (728,064 multiply-adds per pixel at 30x40) against ~0.33 MB of f32
// stem output in and 19 KB of logits out, so on the dense int8 tensor
// cores (1,979 TOP/s) it is bound by operations, not bytes.  This kernel
// uses __dp4a on the CUDA cores instead (4 multiply-adds per instruction),
// which sets its rate.
//
// What the design does about it: it is the simple, correct first kernel,
// one launch per conv with the epilogue fused.  A block owns 64 pixels
// and 64 output channels of one image.  For each tap it stages the 64
// tap-shifted pixels' codes (32 words of 4 channels, the -zp fill for
// pixels outside the image) and the tap's weights in shared memory; each
// thread keeps a 4x4 tile of int32 sums in registers, 16 __dp4a for 8
// shared-memory loads.  The activations live in device memory between
// launches.  IMMA/wgmma and one resident launch per frame are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TP = 64;       // pixels per block
constexpr int TO = 64;       // output channels per block
constexpr int KW = 32;       // words (4 channels each) staged per step
constexpr int THREADS = 256;

__device__ __forceinline__ int8_t requant(float y, float act, float zp) {
  float q = __fsub_rn(rintf(__fdiv_rn(y, act)), zp);  // rint: half to even
  q = fminf(fmaxf(q, -128.f), 127.f);
  return static_cast<int8_t>(__float2int_rn(q));
}

// One conv site.  q: codes [B, P, cin] (cin % 4 == 0); wq: [TAPS*cin/4]
// [cout] words, word r holding weight rows 4r..4r+3 (row = tap*cin + ci);
// res: f32 [B, P, cout] or null; out_f: f32 [B, P, cout] or null; out_q:
// codes [B, P, cout] for the next site (scale next_act, zero point
// next_zp) or null.
template <int TAPS>
__global__ void __launch_bounds__(THREADS)
conv_i8_kernel(const int8_t* __restrict__ q, int H, int W, int cin, int dil,
               int fill, const int* __restrict__ wq, int cout,
               const float* __restrict__ zpsum, const float* __restrict__ deq,
               const float* __restrict__ bias, int relu,
               const float* __restrict__ res, float* __restrict__ out_f,
               int8_t* __restrict__ out_q, float next_act, float next_zp) {
  __shared__ int s_a[KW][TP + 1];               // +1: no bank conflicts
  __shared__ __align__(16) int s_w[KW][TO];

  const int P = H * W;
  const int p0 = blockIdx.x * TP;
  const int o0 = blockIdx.y * TO;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int tp = tid & 15;    // this thread's pixels: p0 + tp + 16 i
  const int to = tid >> 4;    // this thread's outputs: o0 + 4 to + j
  const int cw = cin / 4;
  const int* qb = reinterpret_cast<const int*>(q) + (long long)b * P * cw;

  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int t = 0; t < TAPS; ++t) {
    const int dy = TAPS == 9 ? (t / 3 - 1) * dil : 0;
    const int dx = TAPS == 9 ? (t % 3 - 1) * dil : 0;
    for (int k0 = 0; k0 < cw; k0 += KW) {
      const int kn = min(KW, cw - k0);
      // consecutive threads read consecutive words of one pixel
      for (int i = tid; i < KW * TP; i += THREADS) {
        const int p = i / KW;
        const int k = i - p * KW;
        const int gp = p0 + p;
        int v = fill;
        if (k < kn && gp < P) {
          const int y = gp / W + dy;
          const int x = gp - (gp / W) * W + dx;
          if (y >= 0 && y < H && x >= 0 && x < W)
            v = qb[(long long)(y * W + x) * cw + k0 + k];
        }
        s_a[k][p] = v;
      }
      for (int i = tid; i < KW * TO; i += THREADS) {
        const int k = i / TO;
        const int o = i - k * TO;
        int v = 0;
        if (k < kn && o0 + o < cout)
          v = wq[(long long)(t * cw + k0 + k) * cout + o0 + o];
        s_w[k][o] = v;
      }
      __syncthreads();
      for (int k = 0; k < kn; ++k) {
        int a[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = s_a[k][tp + 16 * i];
        const int4 w4 = *reinterpret_cast<const int4*>(&s_w[k][4 * to]);
        const int wv[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(a[i], wv[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = p0 + tp + 16 * i;
    if (p >= P) continue;
    const long long base = ((long long)b * P + p) * cout;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int o = o0 + 4 * to + j;
      if (o >= cout) continue;
      float y = __fadd_rn(
          __fmul_rn(__fadd_rn(__int2float_rn(acc[i][j]), zpsum[o]), deq[o]),
          bias[o]);
      if (relu) y = fmaxf(y, 0.f);
      if (res != nullptr) y = fmaxf(__fadd_rn(y, res[base + o]), 0.f);
      if (out_f != nullptr) out_f[base + o] = y;
      if (out_q != nullptr) out_q[base + o] = requant(y, next_act, next_zp);
    }
  }
}

__global__ void __launch_bounds__(256)
quant_kernel(const float* __restrict__ x, long long n, float act, float zp,
             int8_t* __restrict__ q) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) q[i] = requant(x[i], act, zp);
}

// One thread per pixel: logits[o] = sum_c h[c] * W[c][o] + b[o], n <= 8.
__global__ void __launch_bounds__(256)
head_kernel(const float* __restrict__ h, long long npx, int C,
            const float* __restrict__ w, const float* __restrict__ bias, int n,
            float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= npx) return;
  const float* hp = h + i * C;
  float acc[8];
#pragma unroll
  for (int o = 0; o < 8; ++o) acc[o] = 0.f;
  for (int c = 0; c < C; ++c) {
    const float v = hp[c];
#pragma unroll
    for (int o = 0; o < 8; ++o)
      if (o < n) acc[o] = fmaf(v, w[c * n + o], acc[o]);
  }
#pragma unroll
  for (int o = 0; o < 8; ++o)
    if (o < n) out[i * n + o] = __fadd_rn(acc[o], bias[o]);
}

}  // namespace

// Plain C interface, bound with ctypes.  Each returns the cudaError_t of
// its launch (0 on success); bad arguments return cudaErrorInvalidValue.
extern "C" int s2r_i8_quant(const float* x, long long n, float act, float zp,
                            int8_t* q, void* stream) {
  if (n <= 0) return cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((n + 255) / 256);
  quant_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      x, n, act, zp, q);
  return cudaGetLastError();
}

// taps: 9 (3x3, padding dil) or 1 (1x1); zp_in: the input codes' zero
// point, whose code -zp_in fills the border.
extern "C" int s2r_i8_conv(int taps, const int8_t* q, int B, int H, int W,
                           int cin, int dil, int zp_in, const int* wq,
                           int cout, const float* zpsum, const float* deq,
                           const float* bias, int relu, const float* res,
                           float* out_f, int8_t* out_q, float next_act,
                           float next_zp, void* stream) {
  if (cin % 4 != 0 || B <= 0 || H <= 0 || W <= 0 || cout <= 0)
    return cudaErrorInvalidValue;
  const int fill = (int)(0x01010101u * (uint8_t)(int8_t)(-zp_in));
  const dim3 grid((H * W + TP - 1) / TP, (cout + TO - 1) / TO, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (taps == 9)
    conv_i8_kernel<9><<<grid, THREADS, 0, s>>>(
        q, H, W, cin, dil, fill, wq, cout, zpsum, deq, bias, relu, res, out_f,
        out_q, next_act, next_zp);
  else if (taps == 1)
    conv_i8_kernel<1><<<grid, THREADS, 0, s>>>(
        q, H, W, cin, dil, fill, wq, cout, zpsum, deq, bias, relu, res, out_f,
        out_q, next_act, next_zp);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

extern "C" int s2r_i8_head(const float* h, long long npx, int C,
                           const float* w, const float* bias, int n,
                           float* out, void* stream) {
  if (n <= 0 || n > 8 || npx <= 0) return cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((npx + 255) / 256);
  head_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      h, npx, C, w, bias, n, out);
  return cudaGetLastError();
}

extern "C" const char* s2r_i8_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
