// The bf16 1x1 product of FC-DenseNet's TransitionDown on Hopper tensor
// cores (wgmma), shared by the serving forward (csrc/dense_block.cu,
// s2r_conv_bnrelu) and the training forward K1 with one tap
// (csrc/train_block.cu, s2r_train_fwd).  The epilogue is a parameter:
//   round_first = 1, mask = null: out = T(T(sum) + T(bias))     (serving)
//   round_first = 0, mask [B, N]: out = T((sum + bias) * mask)  (K1: bias
//     in f32, the per-(image, channel) dropout mask, one rounding)
// A null mask multiplies by 1, which changes no bit.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>

#include "bnrelu_mma.cuh"

namespace s2r_td {

namespace mma = s2r_mma;

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

constexpr int TD_TP = 128;             // pixels per block
constexpr int TD_MN = 128;             // outputs per chunk
constexpr int TD_KS = 64;              // weight rows per slice
constexpr int TD_STAGES = 2;           // weight slices in flight
constexpr int TD_SLICE = TD_KS * TD_MN;
constexpr int TD_THREADS = 256;        // two warpgroups
constexpr int TD_LOADS = 8;            // x chunks a thread has in flight
constexpr size_t TD_SMEM_MAX = 232448;  // an H100 block's shared-memory limit

// a small TransitionDown (K, N <= 128) takes the pipelined kernel below
static bool td_small(int K, int N) { return N <= TD_MN && K <= TD_STAGES * TD_KS; }

static size_t td_smem(int K, int N) {  // with room to align the x tile to 1024 bytes
  const size_t kp = (size_t)(K + 15) / 16 * 16;
  return td_small(K, N) ? 3 * 2 * TD_MN * TD_TP + 1024
                        : 2 * (kp * TD_TP + TD_STAGES * TD_SLICE) + 1024;
}

__global__ void __launch_bounds__(TD_THREADS, 2)
td_fwd_mma_kernel(const mma::u16* in, long long in_bstride, int K, int hw,
                  const float* __restrict__ scale, const float* __restrict__ shift,
                  const mma::u16* __restrict__ wt, const float* __restrict__ bias,
                  int N, mma::u16* out, long long out_bstride, int round_first,
                  const float* __restrict__ mask, int vec_x, int vec_w,
                  int vec_out) {
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
        const float mk = mask ? mask[b * N + n] : 1.f;
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
              mma::pack_bf16x2(__fmul_rn(__fadd_rn(a0, bn), mk),
                               __fmul_rn(__fadd_rn(a1, bn), mk));
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
                    const float* __restrict__ mask, int B, int x_mode, int vec_w,
                    int vec_out) {
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
        const float mk = mask ? mask[b * N + n] : 1.f;
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
              mma::pack_bf16x2(__fmul_rn(__fadd_rn(a0, bn), mk),
                               __fmul_rn(__fadd_rn(a1, bn), mk));
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

// The SM count, with the shared-memory limits set at the first call (a
// library may call it when it loads, so that no launch, and no stream
// capture, meets the attribute calls).
static cudaError_t td_setup(int* sms_out) {
  static int sms = 0;
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
  *sms_out = sms;
  return cudaSuccess;
}

static cudaError_t launch_td_mma(const void* in, long long in_bstride, int B, int K,
                          int H, int W, const float* scale, const float* shift,
                          const void* wt, const float* bias, int N, void* out,
                          long long out_bstride, int round_first,
                          const float* mask, cudaStream_t stream) {
  int sms = 0;
  const cudaError_t se = td_setup(&sms);
  if (se != cudaSuccess) return se;
  const int hw = H * W;
  const int items = ((hw + TD_TP - 1) / TD_TP) * B;
  const int vec_w = N % 8 == 0 && mma::aligned16(wt);
  const int vec_out = hw % 8 == 0 && out_bstride % 8 == 0 && mma::aligned16(out);
  if (td_small(K, N)) {  // two persistent blocks per SM
    td_fwd_small_kernel<<<std::min(items, 2 * sms), TD_THREADS, td_smem(K, N),
                          stream>>>(
        static_cast<const mma::u16*>(in), in_bstride, K, hw, scale, shift,
        static_cast<const mma::u16*>(wt), bias, N, static_cast<mma::u16*>(out),
        out_bstride, round_first, mask, B, mma::row_copy_mode(hw, in_bstride, in),
        vec_w, vec_out);
    return cudaGetLastError();
  }
  const int vec_x = hw % 8 == 0 && in_bstride % 8 == 0 && mma::aligned16(in);
  td_fwd_mma_kernel<<<items, TD_THREADS, td_smem(K, N), stream>>>(
      static_cast<const mma::u16*>(in), in_bstride, K, hw, scale, shift,
      static_cast<const mma::u16*>(wt), bias, N, static_cast<mma::u16*>(out),
      out_bstride, round_first, mask, vec_x, vec_w, vec_out);
  return cudaGetLastError();
}

}  // namespace s2r_td
