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
// Dense layers, the classifier and the float32 TransitionDown
// (conv_bnrelu_kernel, classifier_kernel).  What bounds them: at
// FCDenseNet67, 120x160, the 55 dense layers are 13.7 GFLOP per frame.
// One layer launch reads c_j channels and writes 16, so it does 144
// operations per bf16 byte moved, below the H100's ~295 bf16 tensor-core
// operations per byte of device memory: launched per layer, a tensor-core
// version would be bound by bytes, and a whole block with its buffer kept
// on chip by operations.  These kernels compute on the CUDA cores in f32
// (67 TFLOP/s peak, not 989), so they are bound by their FMA issue rate.
// The float32 TransitionDown stays here as the parity control: TF32 would
// not hold it to 1e-5.
//
// What their design does about it: it is the simple, correct first kernel.
// Each block owns a 16x16 pixel tile and 16 output channels of one image;
// it stages 16 input channels at a time (with a one-pixel halo) into
// shared memory, applying BN, ReLU, rounding and the image mask once per
// staged value, so the nine taps and sixteen outputs reuse each staged
// value 144 times from shared memory.  Each thread keeps its pixel's 16
// f32 sums in registers.  The feature buffer stays in device memory
// between layers (a layer reads channels [0, c_j) and writes the disjoint
// range [c_j, c_j+g) of the same buffer).  wgmma, TMA and keeping the
// buffer on chip across layers are later work.
//
// The bf16 TransitionDown (td_fwd_mma_kernel) runs on the tensor cores;
// its note is above the kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>

#include "bnrelu_mma.cuh"

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

// ---------------------------------------------------------------------------
// bf16 TransitionDown on the tensor cores.
//
// Replaces, for bfloat16, the TransitionDown epilogue of the TPU kernel K4
// (sim2real_lane_segment_tpu/models/tiramisu_pallas.py, the epilogue of
// _packed_block_kernel / _dense_block_kernel at :366-389 and :590-611).
//
// It computes out[b, n, p] = T(T(sum_k W[k, n] a[b, k, p]) + T(bias[n]))
// with a = T(relu(x * scale + shift)): a GEMM [N x C] . [C x pixels] per
// image.  What bounds it on an H100: bytes.  It does about C/2 operations
// per bf16 byte moved (64 at C = 128, 224 at C = 448), below the ~295 at
// which bf16 tensor cores become the limit: per B=64 FCDenseNet67 forward
// its five launches move 1.0 GB (0.30 ms at 3.35 TB/s) for 87 GFLOP
// (0.09 ms at 989 TFLOP/s).
//
// What the design does about it: both kernels read x from device memory
// once per 128-pixel tile with 16-byte loads (a warp reads two whole
// 256-byte channel rows), apply BN + ReLU + rounding once per value while
// staging it as a 128-byte-swizzled shared-memory tile, and multiply on
// the tensor cores with wgmma (m64n128k16, bf16 in, f32 sums), D[n, p] =
// W^T[n, k] a[k, p] with both operands MN-major, so the pixel dimension is
// the product's n and the epilogue stores whole output rows: the rounded
// outputs go through a swizzled shared-memory tile and out 16 bytes a
// thread.  Two warpgroups split the 128 outputs of a chunk.
// - td_fwd_small_kernel (K, N <= 128: the first site, which moves 63% of
//   the bytes): the weight stays in shared memory, and a persistent block
//   (two per SM) copies the next tile's raw x with cp.async while it
//   stages, multiplies and stores the current one: without that overlap
//   a block spent most of each tile waiting on its loads.
// - td_fwd_mma_kernel (the rest): a block owns one tile and every output
//   chunk of it; 64-row slices of the weight (from L2, core order) stream
//   through a two-deep cp.async ring.
// ---------------------------------------------------------------------------
namespace mma = s2r_mma;

constexpr int TD_TP = 128;             // pixels per block
constexpr int TD_MN = 128;             // outputs per chunk
constexpr int TD_KS = 64;              // weight rows per slice
constexpr int TD_STAGES = 2;           // weight slices in flight
constexpr int TD_SLICE = TD_KS * TD_MN;
constexpr int TD_THREADS = 256;        // two warpgroups
constexpr int TD_LOADS = 8;            // x chunks a thread has in flight
constexpr size_t TD_SMEM_MAX = 232448;  // an H100 block's shared-memory limit

// a small TransitionDown (K, N <= 128) takes the pipelined kernel below
bool td_small(int K, int N) { return N <= TD_MN && K <= TD_STAGES * TD_KS; }

size_t td_smem(int K, int N) {  // with room to align the x tile to 1024 bytes
  const size_t kp = (size_t)(K + 15) / 16 * 16;
  return td_small(K, N) ? 3 * 2 * TD_MN * TD_TP + 1024
                        : 2 * (kp * TD_TP + TD_STAGES * TD_SLICE) + 1024;
}

__global__ void __launch_bounds__(TD_THREADS, 2)
td_fwd_mma_kernel(const mma::u16* in, long long in_bstride, int K, int hw,
                  const float* __restrict__ scale, const float* __restrict__ shift,
                  const mma::u16* __restrict__ wt, const float* __restrict__ bias,
                  int N, mma::u16* out, long long out_bstride, int round_first,
                  int vec_x, int vec_w, int vec_out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int kp = (K + 15) / 16 * 16;
  mma::u16* sA = reinterpret_cast<mma::u16*>(           // x: [kp][128], sw128
      smem + ((1024 - (mma::smem_u32(smem) & 1023)) & 1023));
  mma::u16* sW = sA + kp * TD_TP;                      // [STAGES][KS][128], core order
  const int wg = threadIdx.x / 128;                    // outputs 64 wg .. 64 wg + 63
  const int nks = (kp + TD_KS - 1) / TD_KS;
  const int tiles = (hw + TD_TP - 1) / TD_TP;
  const int b = blockIdx.x / tiles;
  const int p0 = (blockIdx.x % tiles) * TD_TP;

  auto load_slice = [&](int n0, int ks) {
    if (ks < nks)
      mma::load_tile_core<TD_KS, TD_MN / 8, TD_THREADS>(
          sW + (ks % TD_STAGES) * TD_SLICE, wt, K, N, ks * TD_KS, n0, vec_w);
    mma::cp_async_commit();  // an empty group past the last slice
  };
  // a chunk's output tile [TD_MN][128] (swizzled) reuses the weight ring
  mma::u16* sO = sW;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int r0 = 64 * wg + 16 * ((threadIdx.x / 32) % 4) + g;  // this lane's rows
  const int total = kp * 16;
  load_slice(0, 0);
  // a = T(relu(x * scale + shift)) into sA, TD_LOADS chunks a thread in
  // flight at a time; rows past K are zero, as their weight rows
  const mma::u16* xb = in + b * in_bstride;
  for (int i0 = threadIdx.x; i0 < total; i0 += TD_LOADS * TD_THREADS) {
    uint4 raw[TD_LOADS];
    mma::load_chunks<TD_THREADS, TD_LOADS>(raw, i0, total, xb, hw, K, p0, vec_x);
    mma::store_chunks_bn<TD_THREADS, TD_LOADS>(raw, i0, total, sA, K, scale, shift);
  }
  for (int n0 = 0; n0 < N; n0 += TD_MN) {
    if (n0 > 0) load_slice(n0, 0);
    const bool live = n0 + 64 * wg < N;                // warpgroup-uniform
    float d[64];
    for (int ks = 0; ks < nks; ++ks) {
      load_slice(n0, ks + 1);
      mma::cp_async_wait<1>();
      mma::fence_async_smem();
      __syncthreads();
      if (live) {
        // D[n, p] = W^T[n, k] a[k, p]: both operands MN-major
        const mma::u16* ws = sW + (ks % TD_STAGES) * TD_SLICE;
        const int kk_end = min(TD_KS, kp - ks * TD_KS);
        mma::wgmma_fence();
        for (int kk = 0; kk < kk_end; kk += 16) {
          const uint64_t da = mma::gmma_desc(ws + mma::core_off(kk, 8 * wg, 16),
                                             16 * 128, 128);
          const uint64_t db = mma::gmma_desc(sA + mma::sw128_off(ks * TD_KS + kk, 0),
                                             1024, 2048, 1);
          mma::wgmma_m64n128k16<1, 1>(d, da, db, ks > 0 || kk > 0);
        }
        mma::wgmma_commit();
        mma::wgmma_wait0();
      }
      __syncthreads();  // a later load overwrites this slice's buffer
    }
    // epilogue: T(T(sum) + T(bias)) (or T(sum + bias)) into the tile
    if (live) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 8 * h;
        const int n = min(n0 + r, N - 1);  // rows past N are not stored
        const float bn = round_first ? mma::bf(mma::to_bf(bias[n])) : bias[n];
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          float a0 = d[4 * i + 2 * h];
          float a1 = d[4 * i + 2 * h + 1];
          if (round_first) {
            const uint32_t s2 = mma::pack_bf16x2(a0, a1);
            a0 = mma::lo_f(s2);
            a1 = mma::hi_f(s2);
          }
          *reinterpret_cast<uint32_t*>(sO + mma::swz_off(r, 8 * i + 2 * t)) =
              mma::pack_bf16x2(__fadd_rn(a0, bn), __fadd_rn(a1, bn));
        }
      }
    }
    __syncthreads();
    // coalesced stores: 16 bytes a thread along each output row
    const int rows = min(TD_MN, N - n0);
    mma::u16* ob = out + b * out_bstride + (long long)n0 * hw;
    for (int i = threadIdx.x; i < rows * 16; i += TD_THREADS) {
      const int r = i / 16;
      const int c = (i % 16) * 8;
      const int p = p0 + c;
      const mma::u16* src = sO + mma::swz_off(r, c);
      mma::u16* dst = ob + (long long)r * hw + p;
      if (vec_out && p + 8 <= hw) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
        for (int e = 0; e < 8 && p + e < hw; ++e) dst[e] = src[e];
      }
    }
    __syncthreads();  // the next chunk's first load overwrites the tile
  }
}

// K, N <= 128 (the first TransitionDown of FCDenseNet67: C = N = 128 at
// 120x160): the whole weight stays in shared memory and a persistent
// block walks its pixel tiles with the next tile's raw x already in flight
// (cp.async into a linear buffer) while it stages, multiplies and stores
// the current one.  Shared memory: the x tile (128-byte swizzled, reused
// as the output tile), the weight (core order), the raw x buffer; 32 KB
// each.
__global__ void __launch_bounds__(TD_THREADS, 2)
td_fwd_small_kernel(const mma::u16* in, long long in_bstride, int K, int hw,
                    const float* __restrict__ scale, const float* __restrict__ shift,
                    const mma::u16* __restrict__ wt, const float* __restrict__ bias,
                    int N, mma::u16* out, long long out_bstride, int round_first,
                    int B, int x_mode, int vec_w, int vec_out) {
  extern __shared__ __align__(128) unsigned char smem[];
  mma::u16* sA = reinterpret_cast<mma::u16*>(           // x: [128][128], sw128
      smem + ((1024 - (mma::smem_u32(smem) & 1023)) & 1023));
  mma::u16* sW = sA + TD_MN * TD_TP;                   // [2][KS][128], core order
  mma::u16* sRaw = sW + 2 * TD_SLICE;                  // [128][128], linear
  const int kp = (K + 15) / 16 * 16;
  const int tiles = (hw + TD_TP - 1) / TD_TP;
  const int items = B * tiles;
  const int wg = threadIdx.x / 128;
  const bool live = 64 * wg < N;                       // warpgroup-uniform
  for (int ks = 0; ks * TD_KS < kp; ++ks)
    mma::load_tile_core<TD_KS, TD_MN / 8, TD_THREADS>(sW + ks * TD_SLICE, wt, K, N,
                                                     ks * TD_KS, 0, vec_w);
  auto issue_x = [&](int item) {
    if (item < items)
      mma::copy_rows_async<TD_TP, TD_THREADS>(
          sRaw, TD_TP, kp, in + (item / tiles) * in_bstride, hw, K,
          (item % tiles) * TD_TP, x_mode);
    mma::cp_async_commit();
  };
  issue_x(blockIdx.x);
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int r0 = 64 * wg + 16 * ((threadIdx.x / 32) % 4) + g;  // this lane's rows
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int b = item / tiles;
    const int p0 = (item % tiles) * TD_TP;
    mma::cp_async_wait<0>();
    __syncthreads();
    // a = T(relu(x * scale + shift)); rows past K are zero, as their
    // weight rows
    for (int i = threadIdx.x; i < kp * 16; i += TD_THREADS) {
      const int r = i / 16;
      const int c = (i % 16) * 8;
      const uint4 v = *reinterpret_cast<const uint4*>(sRaw + r * TD_TP + c);
      *reinterpret_cast<uint4*>(sA + mma::sw128_off(r, c)) =
          r < K ? mma::bn_relu8(v, scale[r], shift[r]) : make_uint4(0, 0, 0, 0);
    }
    mma::fence_async_smem();
    __syncthreads();
    issue_x(item + gridDim.x);  // in flight while this tile is multiplied
    float d[64];
    if (live) {
      // D[n, p] = W^T[n, k] a[k, p]: both operands MN-major
      mma::wgmma_fence();
      for (int k = 0; k < kp; k += 16) {
        const uint64_t da = mma::gmma_desc(
            sW + (k / TD_KS) * TD_SLICE + mma::core_off(k % TD_KS, 8 * wg, 16),
            16 * 128, 128);
        const uint64_t db = mma::gmma_desc(sA + mma::sw128_off(k, 0), 1024, 2048, 1);
        mma::wgmma_m64n128k16<1, 1>(d, da, db, k > 0);
      }
      mma::wgmma_commit();
      mma::wgmma_wait0();
    }
    __syncthreads();  // the output tile overwrites the x tile
    mma::u16* sO = sA;
    if (live) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 8 * h;
        const int n = min(r, N - 1);  // rows past N are not stored
        const float bn = round_first ? mma::bf(mma::to_bf(bias[n])) : bias[n];
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          float a0 = d[4 * i + 2 * h];
          float a1 = d[4 * i + 2 * h + 1];
          if (round_first) {
            const uint32_t s2 = mma::pack_bf16x2(a0, a1);
            a0 = mma::lo_f(s2);
            a1 = mma::hi_f(s2);
          }
          *reinterpret_cast<uint32_t*>(sO + mma::swz_off(r, 8 * i + 2 * t)) =
              mma::pack_bf16x2(__fadd_rn(a0, bn), __fadd_rn(a1, bn));
        }
      }
    }
    __syncthreads();
    mma::u16* ob = out + b * out_bstride;
    for (int i = threadIdx.x; i < N * 16; i += TD_THREADS) {
      const int r = i / 16;
      const int c = (i % 16) * 8;
      const int p = p0 + c;
      const mma::u16* src = sO + mma::swz_off(r, c);
      mma::u16* dst = ob + (long long)r * hw + p;
      if (vec_out && p + 8 <= hw) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
        for (int e = 0; e < 8 && p + e < hw; ++e) dst[e] = src[e];
      }
    }
  }
}

cudaError_t launch_td_mma(const void* in, long long in_bstride, int B, int K,
                          int H, int W, const float* scale, const float* shift,
                          const void* wt, const float* bias, int N, void* out,
                          long long out_bstride, int round_first,
                          cudaStream_t stream) {
  static int sms = 0;  // the SM count, with the shared-memory limits set once
  if (sms == 0) {
    int dev = 0;
    cudaError_t e = cudaFuncSetAttribute(
        td_fwd_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)TD_SMEM_MAX);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(td_fwd_small_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)TD_SMEM_MAX);
    if (e == cudaSuccess) e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
  }
  const int hw = H * W;
  const int items = ((hw + TD_TP - 1) / TD_TP) * B;
  const int vec_w = N % 8 == 0 && mma::aligned16(wt);
  const int vec_out = hw % 8 == 0 && out_bstride % 8 == 0 && mma::aligned16(out);
  if (td_small(K, N)) {  // two persistent blocks per SM
    td_fwd_small_kernel<<<std::min(items, 2 * sms), TD_THREADS, td_smem(K, N),
                          stream>>>(
        static_cast<const mma::u16*>(in), in_bstride, K, hw, scale, shift,
        static_cast<const mma::u16*>(wt), bias, N, static_cast<mma::u16*>(out),
        out_bstride, round_first, B, mma::row_copy_mode(hw, in_bstride, in), vec_w,
        vec_out);
    return cudaGetLastError();
  }
  const int vec_x = hw % 8 == 0 && in_bstride % 8 == 0 && mma::aligned16(in);
  td_fwd_mma_kernel<<<items, TD_THREADS, td_smem(K, N), stream>>>(
      static_cast<const mma::u16*>(in), in_bstride, K, hw, scale, shift,
      static_cast<const mma::u16*>(wt), bias, N, static_cast<mma::u16*>(out),
      out_bstride, round_first, vec_x, vec_w, vec_out);
  return cudaGetLastError();
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
// returns cudaErrorInvalidValue.  A bfloat16 TransitionDown runs on the
// tensor cores (td_fwd_mma_kernel) when its x tile fits in shared memory
// (C <= 768: every FCDenseNet57/67/103 site), a float32 one and a wider
// bfloat16 one on the CUDA cores.
extern "C" int s2r_conv_bnrelu(int dtype, int taps, const void* in,
                               long long in_bstride, int B, int K, int H,
                               int W, const float* scale, const float* shift,
                               const void* wt, const float* bias, int N,
                               void* out, long long out_bstride,
                               int round_first, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && taps == 9)
    return launch_conv<float, 9>(in, in_bstride, B, K, H, W, scale, shift, wt,
                                 bias, N, out, out_bstride, round_first, s);
  if (dtype == 0 && taps == 1)
    return launch_conv<float, 1>(in, in_bstride, B, K, H, W, scale, shift, wt,
                                 bias, N, out, out_bstride, round_first, s);
  if (dtype == 1 && taps == 9)
    return launch_conv<__nv_bfloat16, 9>(in, in_bstride, B, K, H, W, scale,
                                         shift, wt, bias, N, out, out_bstride,
                                         round_first, s);
  if (dtype == 1 && taps == 1 && td_smem(K, N) <= TD_SMEM_MAX)
    return launch_td_mma(in, in_bstride, B, K, H, W, scale, shift, wt, bias, N,
                         out, out_bstride, round_first, s);
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

extern "C" const char* s2r_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
