// The bf16 3x3 dense-layer forward of FC-DenseNet (growth G, 12 or 16) on
// Hopper tensor cores, shared by the serving forward (csrc/dense_block.cu,
// dense3x3_mma_kernel) and the training forward K1 (csrc/train_block.cu,
// fwd3x3_mma_kernel).  The epilogue is a template parameter:
//   MASK = false: out = T(D + bias)           (serving, K4)
//   MASK = true:  out = T((D + bias) * mask)  (K1: the per-(image, channel)
//                                              dropout mask, one rounding)
// with D[pixel, o] = sum_{k, tap} a[pixel + tap, k] W[k, tap, o] in f32 and
// a = T(relu(x * scale + shift)), zero outside the image.
//
// Replaces, for bfloat16 with 12 or 16 outputs, the dense layers of the TPU
// kernels K4 (sim2real_lane_segment_tpu/models/tiramisu_pallas.py,
// _packed_block_kernel / _dense_block_kernel, pallas_call at :701 and
// :739) and K1 (models/tiramisu_train_pallas.py, _fwd_kernel, :187).
//
// What bounds it on an H100: a layer launch does 144 multiply-adds per
// input value against 16 outputs, below the ~295 operations per byte at
// which the bf16 tensor cores become the limit: by the roofline it is bound
// by bytes (a B=64 FCDenseNet67 serving forward's 55 layers move 6.6 GB,
// 2.0 ms at 3.35 TB/s, for 878 GFLOP).  With 16 outputs no tensor-core
// instruction reaches the card's peak (a 64 x 16 wgmma leaves most of its
// width idle), so the design aims at the cuDNN call, not the bound.
//
// What the design does about it: mma.sync m16n8k16 (bf16 in, f32 sums)
// fed by ldmatrix over [halo pixel][channel] shared-memory tiles
// (bnrelu_mma.cuh): a tap is a whole-row offset, so one staged tile with
// its one-pixel halo serves all nine taps.  A block owns a 12 x 16 pixel
// tile of one image and all G outputs; it walks its input channels in
// chunks of 32 through two buffers (BN + ReLU + rounding once per staged
// value; the next chunk's x in flight in registers while this one is
// multiplied; weights by cp.async as they lie in memory).
//
// Growth 12 (FCDenseNet57): mma.sync has no n4 shape, so the product keeps
// its two n8 tiles and columns 12-15 of the second are dead (16/12 of the
// tensor-core work; the products are a tenth of a level's time).  The
// weights come padded to [K][9][16] with zero columns (kernels/
// dense_block.pad_growth, made where the layout copy is made), so a row
// stays 288 bytes for 16-byte cp.async; the epilogue stores, masks and
// parks outputs n < G only.  A layer's input then has 48 + 12 j channels,
// rarely a multiple of 16 or of 8: px_load and px_store zero the channels
// past K inside a partial 8-channel group, load_w3_rows the rows past K.
//
// Small planes: at 15x20 and below a B=64 forward has 64-256 tiles, fewer
// blocks than two per SM, each walking up to 19 chunks in turn.  There the
// channel loop is split across a thread-block cluster of S blocks (gridDim.z,
// S <= 8, dense_splits, from the device's SM count): block s sums a
// contiguous range of chunks, parks its f32 sums in its own shared
// memory, and after a cluster barrier every
// block adds one slice of the outputs over the S ranks in rank order,
// reading the others' shared memory (distributed shared memory), and runs
// the epilogue.  The order of the sums is fixed, so the result does not
// depend on scheduling; no atomics and no scratch in device memory.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>

#include "bnrelu_mma.cuh"

namespace s2r_d3 {

namespace mma = s2r_mma;
typedef long long ll;

constexpr int KC = 32;                        // channels per chunk
constexpr int LD = KC + 8;
constexpr int SA = mma::C3_HPX * LD;          // one a buffer, elements
constexpr int SW = KC * mma::C3_WLD;          // one weight buffer, elements
constexpr int SMEM = 2 * 2 * (SA + SW);       // bytes
constexpr int TILE_PX = mma::C3_TH * mma::C3_TW;
constexpr int MAX_SPLITS = 8;                 // a portable cluster
constexpr int BLOCKS_PER_SM = 2;              // the blocks a split aims at
static_assert(mma::C3_N * TILE_PX * 4 <= SMEM, "the parked sums fit");

// The split of the channel loop on a card of `sms` SMs: the least S that
// gives BLOCKS_PER_SM blocks per SM, at most MAX_SPLITS and at least one
// chunk a block (kernels/dense_block.dense_splits states the same rule for
// the CPU tests; the launch reports the S it took).
inline int dense_splits(int B, int H, int W, int K, int sms) {
  const int blocks = B * mma::c3_tiles(H, W);
  const int chunks = (K + KC - 1) / KC;
  const int s = (BLOCKS_PER_SM * sms + blocks - 1) / blocks;
  return std::max(1, std::min(std::min(s, MAX_SPLITS), chunks));
}

// The current device's SM count.
inline cudaError_t device_sms(int* sms) {
  int dev = 0;
  const cudaError_t e = cudaGetDevice(&dev);
  return e != cudaSuccess ? e
                          : cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
}

// Thread-block clusters (sm_90): a barrier over every thread of the
// cluster (release / acquire: shared-memory writes before it are visible to
// the cluster's reads after it), this block's rank, and a load from
// another block's shared memory at the address `addr` has in this block.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return (int)r;
}

__device__ __forceinline__ float ld_cluster(uint32_t addr, int rank) {
  uint32_t remote;
  float v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote) : "r"(addr), "r"(rank));
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(remote) : "memory");
  return v;
}

// Diagnostic variants of the body (cli/serve_breakdown --ablate), wrong
// math at the same shapes and launch, so that the time each removes can be
// read off: NO_TAPS multiplies the centre tap alone instead of all nine;
// NO_PREP stages x as it is, without BN + ReLU.  ABLATE_NONE is the body.
constexpr int ABLATE_NONE = 0;
constexpr int NO_TAPS = 1;
constexpr int NO_PREP = 2;

// The body of both kernels.  X: channels [0, K) of image b at X + b *
// x_bstride; wt [K][9][16] (16-byte aligned; columns G-15 zero); out:
// channels [0, G) of image b at out + b * out_bstride (in place: the
// caller's buffer past channel K); mask [B][G] (MASK only); pair:
// mma::c3_pair_loads.  Grid: (tiles, B, S), clusters of (1, 1, S) when
// S > 1.  G = 16 compiles to the code it had before G was a parameter:
// every `G == mma::C3_N ||` below folds to true.
template <int G, bool MASK, int ABLATE = ABLATE_NONE>
__device__ __forceinline__ void fwd3x3_body(const mma::u16* X, ll x_bstride, int K, int H,
                                            int W, const float* __restrict__ scale,
                                            const float* __restrict__ shift,
                                            const mma::u16* __restrict__ wt,
                                            const float* __restrict__ bias,
                                            const float* __restrict__ mask, mma::u16* out,
                                            ll out_bstride, int pair) {
  static_assert(G == 12 || G == mma::C3_N, "growth 12 or 16");
  extern __shared__ __align__(128) unsigned char smem[];
  mma::u16* sA = reinterpret_cast<mma::u16*>(smem);   // [2][halo px][LD]
  mma::u16* sW = sA + 2 * SA;                          // [2][KC][C3_WLD]
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const mma::C3Lane ln(tid % 32);
  const int tiles_x = mma::c3_tiles_x(W);
  const int ty0 = (blockIdx.x / tiles_x) * mma::C3_TH;
  const int tx0 = (blockIdx.x % tiles_x) * mma::C3_TW;
  const int b = blockIdx.y;
  const int splits = gridDim.z;
  const int hw = H * W;
  const mma::u16* xb = X + b * x_bstride;
  const int nchunks = (K + KC - 1) / KC;
  const int c_begin = (int)blockIdx.z * nchunks / splits;
  const int c_end = ((int)blockIdx.z + 1) * nchunks / splits;

  // a chunk's x is loaded into registers while the chunk before it is
  // multiplied, and stored (BN + ReLU + rounding applied) after
  constexpr int TOTAL = KC / 8 * mma::C3_ITEMS;
  constexpr int ROUNDS = (TOTAL + mma::C3_THREADS - 1) / mma::C3_THREADS;
  uint32_t raw[ROUNDS][8];
  auto load = [&](int c) {
    const int k0 = c * KC;
    mma::load_w3_rows<mma::C3_THREADS>(sW + (c & 1) * SW, wt, K, k0, KC);
    mma::cp_async_commit();
    mma::px_load<ROUNDS, mma::C3_THREADS>(raw, 0, TOTAL, xb + (ll)k0 * hw, hw, H, W, ty0,
                                          tx0, K - k0, pair);
  };
  auto store = [&](int c) {
    const int k0 = c * KC;
    mma::px_store<ABLATE != NO_PREP, false, ROUNDS, mma::C3_THREADS>(
        raw, 0, TOTAL, sA + (c & 1) * SA, nullptr, LD, H, W, ty0, tx0, K - k0,
        scale + k0, shift + k0);
  };

  float acc[mma::C3_MT][2][4];
#pragma unroll
  for (int m = 0; m < mma::C3_MT; ++m)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][nt][e] = 0.f;

  if (c_begin < c_end) load(c_begin);
  for (int c = c_begin; c < c_end; ++c) {
    store(c);
    mma::cp_async_wait<0>();
    __syncthreads();  // chunk c is staged; the other buffers are free
    if (c + 1 < c_end) load(c + 1);
    const uint32_t a_sm = mma::smem_u32(sA + (c & 1) * SA);
    const uint32_t w_sm = mma::smem_u32(sW + (c & 1) * SW);
#pragma unroll
    for (int kk = 0; kk < KC; kk += 16) {
#pragma unroll
      for (int t = ABLATE == NO_TAPS ? 4 : 0; t < (ABLATE == NO_TAPS ? 5 : 9); ++t) {
        uint32_t bq[4];  // W[k, t, o]: stored [k][o]
        mma::ldsm_x4_t(bq, w_sm + 2u * (uint32_t)((kk + ln.r8 + 8 * ln.j0) * mma::C3_WLD +
                                                  t * mma::C3_N + 8 * ln.j1));
#pragma unroll
        for (int m = 0; m < mma::C3_MT; ++m) {
          const int y = warp + m * mma::C3_WARPS;
          uint32_t af[4];  // a[pixel + tap, k]: stored [pixel][k]
          mma::ldsm_x4(af, a_sm + 2u * (uint32_t)(mma::c3_tap(y, ln.r8 + 8 * ln.j0, t / 3, t % 3) *
                                                      LD + kk + 8 * ln.j1));
          mma::mma_16816(acc[m][0], af, bq[0], bq[1]);
          mma::mma_16816(acc[m][1], af, bq[2], bq[3]);
        }
      }
    }
  }

  mma::u16* ob = out + b * out_bstride;
  auto epilogue = [&](float d, int n) {
    const float y = __fadd_rn(d, bias[n]);
    return mma::to_bf(MASK ? __fmul_rn(y, mask[b * G + n]) : y);
  };
  if (splits == 1) {
#pragma unroll
    for (int m = 0; m < mma::C3_MT; ++m) {
      const int gy = ty0 + warp + m * mma::C3_WARPS;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int gx = tx0 + ln.g + 8 * (e / 2);
          const int n = 8 * nt + 2 * ln.t + (e & 1);
          if ((G == mma::C3_N || n < G) && gy < H && gx < W)
            ob[(ll)n * hw + gy * W + gx] = epilogue(acc[m][nt][e], n);
        }
    }
    return;
  }

  // split: park the sums as red[o][tile pixel], then add the ranks in order
  __syncthreads();  // every warp is done with the a and weight buffers
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int m = 0; m < mma::C3_MT; ++m) {
    const int y = warp + m * mma::C3_WARPS;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = 8 * nt + 2 * ln.t + (e & 1);
        if (G == mma::C3_N || n < G)
          red[n * TILE_PX + y * mma::C3_TW + ln.g + 8 * (e / 2)] = acc[m][nt][e];
      }
  }
  cluster_sync();  // every rank's sums are parked
  const uint32_t red_sm = mma::smem_u32(red);
  for (int i = cluster_rank() * mma::C3_THREADS + tid; i < G * TILE_PX;
       i += splits * mma::C3_THREADS) {
    float d = ld_cluster(red_sm + 4u * i, 0);
    for (int r = 1; r < splits; ++r) d = __fadd_rn(d, ld_cluster(red_sm + 4u * i, r));
    const int n = i / TILE_PX;
    const int p = i - n * TILE_PX;
    const int gy = ty0 + p / mma::C3_TW;
    const int gx = tx0 + p % mma::C3_TW;
    if (gy < H && gx < W) ob[(ll)n * hw + gy * W + gx] = epilogue(d, n);
  }
  cluster_sync();  // no block leaves while another reads its shared memory
}

// Launches `kernel` (a __global__ wrapper of fwd3x3_body with the same
// parameters) over (tiles, B, S) blocks, as clusters of S when S > 1, and
// stores S in *splits_out when given.  The caller has raised the kernel's
// dynamic shared-memory limit to SMEM.
template <typename Kernel>
cudaError_t launch_fwd3x3(Kernel kernel, const void* X, ll x_bstride, int B, int K, int H,
                          int W, const float* scale, const float* shift, const void* wt,
                          const float* bias, const float* mask, void* out, ll out_bstride,
                          cudaStream_t s, int* splits_out = nullptr) {
  if (!mma::aligned16(wt)) return cudaErrorMisalignedAddress;
  int sms = 0;
  const cudaError_t se = device_sms(&sms);
  if (se != cudaSuccess) return se;
  const int splits = dense_splits(B, H, W, K, sms);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(mma::c3_tiles(H, W), B, splits);
  cfg.blockDim = dim3(mma::C3_THREADS);
  cfg.dynamicSmemBytes = SMEM;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = splits;
  cfg.attrs = attr;
  cfg.numAttrs = splits > 1 ? 1 : 0;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const mma::u16*>(X), x_bstride, K, H, W, scale, shift,
      static_cast<const mma::u16*>(wt), bias, mask, static_cast<mma::u16*>(out),
      out_bstride, (int)mma::c3_pair_loads(W, x_bstride, X));
  if (splits_out != nullptr) *splits_out = splits;
  return e != cudaSuccess ? e : cudaGetLastError();
}

}  // namespace s2r_d3
