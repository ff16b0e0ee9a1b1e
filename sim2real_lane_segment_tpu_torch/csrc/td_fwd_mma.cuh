// The bf16 1x1 product of FC-DenseNet's TransitionDown on Hopper tensor
// cores (wgmma), shared by the serving forward (csrc/dense_block.cu,
// s2r_conv_bnrelu) and the training forward K1 with one tap
// (csrc/train_block.cu, s2r_train_fwd).  The epilogue is a parameter:
//   round_first = 1, mask = null: out = T(T(sum) + T(bias))     (serving)
//   round_first = 0, mask [B, N]: out = T((sum + bias) * mask)  (K1: bias
//     in f32, the per-(image, channel) dropout mask, one rounding)
// A null mask multiplies by 1, which changes no bit.

#pragma once

#include <cuda.h>
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
// _packed_block_kernel / _dense_block_kernel at :366-389 and :590-611) and
// the one-tap forward K1 (tiramisu_train_pallas.py _fwd_kernel, :187).
//
// It computes out[b, n, p] = T(T(sum_k W[k, n] a[b, k, p]) + T(bias[n]))
// with a = T(relu(x * scale + shift)): a GEMM [N x C] . [C x pixels] per
// image.  What bounds it on an H100: bytes.  It does about C/2 operations
// per bf16 byte moved (64 at C = 128, 224 at C = 448), below the ~295 at
// which bf16 tensor cores become the limit: per B=64 FCDenseNet67 forward
// its five launches move 1.0 GB (0.30 ms at 3.35 TB/s) for 87 GFLOP
// (0.09 ms at 989 TFLOP/s).
//
// What the design does about it: every FCDenseNet57, 67 and 103 site
// takes td_fwd_tma_kernel (noted below with it), a warp-specialized TMA
// pipeline.  td_fwd_kernel, here, takes the shapes whose weight TMA cannot
// load (N % 8 != 0, or K or N above TD_MAX_K) and planes under 64 pixels
// whose H*W is no multiple of 8 (the tests' odd shapes): one persistent
// kernel, two blocks per SM.  The pixels of all images form one axis of B
// * hw positions cut into 128-position tiles (a small plane fills a tile
// from several images), and a block walks (tile, 128-output chunk) items.
// An item streams its input channels in 64-row slices: the x slice (raw,
// 128-byte swizzled) and the weight slice (from L2, core order) arrive in
// one 32 KB stage of a three-stage cp.async ring, two slices ahead, across
// item boundaries.  A slice is turned into a = T(relu(x * scale + shift))
// in place, then multiplied with wgmma (m64n128k16, bf16 in, f32 sums; two
// warpgroups of 64 outputs each): D[n, p] = W^T[n, k] a[k, p], both
// operands MN-major, and the epilogue writes whole output rows through a
// swizzled tile in the last slice's stage.
// ---------------------------------------------------------------------------

constexpr int TD_TP = 128;              // positions (pixels) per tile
constexpr int TD_MN = 128;              // outputs per item
constexpr int TD_KS = 64;               // input channels per slice
constexpr int TD_STAGES = 3;            // ring stages: two slices in flight
constexpr int TD_X = TD_KS * TD_TP;     // a stage's x slice, then its weight slice
constexpr int TD_STAGE = 2 * TD_X;      // 32 KB, also an item's output tile
constexpr int TD_THREADS = 256;         // two warpgroups
constexpr int TD_PER_SM = 2;            // persistent blocks per SM
constexpr int TD_MAX_K = 768;           // the tensor-core route's input channels
constexpr size_t TD_SMEM = (size_t)TD_STAGES * TD_STAGE * 2 + 1024;  // and 1024-byte alignment

__global__ void __launch_bounds__(TD_THREADS, TD_PER_SM)
td_fwd_kernel(const mma::u16* in, long long in_bstride, int K, int hw, int B,
              const float* __restrict__ scale, const float* __restrict__ shift,
              const mma::u16* __restrict__ wt, const float* __restrict__ bias, int N,
              mma::u16* out, long long out_bstride, int round_first,
              const float* __restrict__ mask, int x_mode, int vec_w, int vec_out) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int s_img[TD_TP];  // each column's image (K1's mask)
  mma::u16* ring = reinterpret_cast<mma::u16*>(
      smem + ((1024 - (mma::smem_u32(smem) & 1023)) & 1023));
  const int tid = threadIdx.x;
  const int wg = tid / 128;                            // outputs 64 wg .. 64 wg + 63
  const int total = B * hw;
  const int chunks = (N + TD_MN - 1) / TD_MN;
  const int items = (total + TD_TP - 1) / TD_TP * chunks;
  const int kp = (K + 15) / 16 * 16;
  const int nks = (kp + TD_KS - 1) / TD_KS;
  const int mine = items > (int)blockIdx.x ? (items - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int stages = mine * nks;  // this block's slices, item by item

  // slice s of this block: stage (s % TD_STAGES); its item, tile, chunk
  auto issue = [&](int s) {
    if (s < stages) {
      const int item = blockIdx.x + (s / nks) * gridDim.x;
      const int k0 = (s % nks) * TD_KS;
      mma::u16* st = ring + (s % TD_STAGES) * TD_STAGE;
      mma::flat_tile_async<TD_KS, TD_TP, TD_THREADS>(
          st, [](int r, int c) { return mma::sw128_off(r, c); }, in, in_bstride, hw, k0, K,
          item / chunks * TD_TP, total, x_mode);
      mma::load_tile_core<TD_KS, TD_MN / 8, TD_THREADS>(st + TD_X, wt, K, N, k0,
                                                       item % chunks * TD_MN, vec_w);
    }
    mma::cp_async_commit();  // an empty group past the last slice
  };
  for (int s = 0; s < TD_STAGES - 1; ++s) issue(s);

  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int r0 = 64 * wg + 16 * ((tid / 32) % 4) + g;  // this lane's rows
  float d[64];
  for (int s = 0; s < stages; ++s) {
    const int item = blockIdx.x + (s / nks) * gridDim.x;
    const int ks = s % nks;
    const int p0 = item / chunks * TD_TP;              // the tile's first position
    const int n0 = item % chunks * TD_MN;
    const bool live = n0 + 64 * wg < N;                // warpgroup-uniform
    mma::u16* st = ring + (s % TD_STAGES) * TD_STAGE;
    mma::cp_async_wait<TD_STAGES - 2>();
    __syncthreads();
    // a = T(relu(x * scale + shift)) in place; rows past K are zero, as
    // their weight rows
    for (int i = tid; i < TD_KS * 16; i += TD_THREADS) {
      const int r = i / 16;
      const int k = ks * TD_KS + r;
      uint4* cell = reinterpret_cast<uint4*>(st + mma::sw128_off(r, (i % 16) * 8));
      *cell = k < K ? mma::bn_relu8(*cell, scale[k], shift[k]) : make_uint4(0, 0, 0, 0);
    }
    mma::fence_async_smem();
    mma::wgmma_wait0();  // the previous slice's products
    __syncthreads();
    issue(s + TD_STAGES - 1);  // into the previous slice's stage
    if (live) {
      // D[n, p] = W^T[n, k] a[k, p]: both operands MN-major
      const int kk_end = min(TD_KS, kp - ks * TD_KS);
      mma::wgmma_fence();
      for (int kk = 0; kk < kk_end; kk += 16) {
        const uint64_t da = mma::gmma_desc(st + TD_X + mma::core_off(kk, 8 * wg, 16),
                                           16 * 128, 128);
        const uint64_t db = mma::gmma_desc(st + mma::sw128_off(kk, 0), 1024, 2048, 1);
        mma::wgmma_m64n128k16<1, 1>(d, da, db, ks > 0 || kk > 0);
      }
      mma::wgmma_commit();
    }
    if (ks < nks - 1) continue;
    // the item's epilogue: T(T(sum) + T(bias)) (or T((sum + bias) * mask))
    // into an output tile [TD_MN][128] (swizzled) in this slice's stage
    mma::wgmma_wait0();
    if (mask != nullptr && tid < TD_TP) s_img[tid] = min(p0 + tid, total - 1) / hw;
    __syncthreads();  // every product of the stage is done
    mma::u16* sO = st;
    if (live) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 8 * h;
        const int n = min(n0 + r, N - 1);  // rows past N are not stored
        const float bn = round_first ? mma::bf(mma::to_bf(bias[n])) : bias[n];
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const int c = 8 * i + 2 * t;
          float a0 = d[4 * i + 2 * h];
          float a1 = d[4 * i + 2 * h + 1];
          if (round_first) {
            const uint32_t s2 = mma::pack_bf16x2(a0, a1);
            a0 = mma::lo_f(s2);
            a1 = mma::hi_f(s2);
          }
          const float m0 = mask ? mask[s_img[c] * N + n] : 1.f;
          const float m1 = mask ? mask[s_img[c + 1] * N + n] : 1.f;
          *reinterpret_cast<uint32_t*>(sO + mma::swz_off(r, c)) =
              mma::pack_bf16x2(__fmul_rn(__fadd_rn(a0, bn), m0),
                               __fmul_rn(__fadd_rn(a1, bn), m1));
        }
      }
    }
    __syncthreads();
    // whole output rows, 16 bytes a thread where the rows allow it
    const int rows = min(TD_MN, N - n0);
    for (int i = tid; i < rows * 16; i += TD_THREADS) {
      const int r = i / 16;
      const int c = (i % 16) * 8;
      mma::flat_chunk_store(out, out_bstride, hw, n0 + r, p0 + c, total,
                            sO + mma::swz_off(r, c), vec_out);
    }
  }
}

// ---------------------------------------------------------------------------
// td_fwd_tma_kernel: the warp-specialized pipeline.  A block per SM keeps
// one 128-output chunk and walks 128-pixel tiles (with the weight chunk
// resident in shared memory while K <= 256, else streamed with each
// slice):
// - one thread of the first warpgroup (the producer) loads each 64-channel
//   slice into a four-stage ring with TMA: the x slice as two 64-pixel
//   boxes and the weight slice as two 64-output boxes (128-byte swizzle,
//   zeros past the tensors' ends), completion counted on the stage's
//   "full" mbarrier.  FLAT (H*W no multiple of 8: 15x20, 7x10; tiles over
//   the positions of all images): the producer warpgroup copies x into
//   padded rows with cp.async, neighbouring lanes on neighbouring
//   positions, each lane's arrival counted on the same barrier;
// - two consumer warpgroups, 64 pixels each, read their x fragments with
//   ldmatrix (transposed), apply BN + ReLU + rounding in registers and
//   multiply with wgmma taking A from registers: D[p, n] = a^T[p, k] W[k,
//   n], W MN-major from shared memory.  After the products one thread of
//   each releases the stage on its "empty" mbarrier, for which the
//   producer waits before reloading it.
// Nothing is written to shared memory between a load and the product that
// reads it, so no proxy fence and no block-wide barrier sits in the loop;
// the consumers wait on their products at once (an A register or an
// accumulator moved by the compiler while a product runs would be read or
// written stale).  The epilogue adds the bias (and the mask), rounds,
// transposes D into an output tile with stmatrix, and one thread stores
// the tile with TMA while the consumers go on (two tiles take turns);
// FLAT: the consumers store it position by position.  Ragged edges
// (pixels past hw, outputs past N, channels past K) are the TMA's: zeros
// loaded, nothing stored.
// ---------------------------------------------------------------------------

constexpr int TT_STAGES = 4;
constexpr int TT_THREADS = 384;                  // producer + two consumer warpgroups
constexpr int TT_BOX = 64 * 64;                  // elements in a 64 x 64 box (8 KB)
constexpr int TT_WRES = 4;                       // the most weight slices kept resident
constexpr int TT_XLD = TD_TP + 8;                // FLAT: x rows of 128 positions, padded
constexpr int TT_XF = 9 * 1024;                  // FLAT: a stage's x slice (1024-aligned)
constexpr int TT_REGION = TT_WRES * 2 * TT_BOX + TT_STAGES * TT_XF;  // ring, resident weight
constexpr int TT_KPAD = TD_MAX_K + TD_KS;        // BN scale and shift, zero past K
constexpr int TT_OUT = TD_MN * TD_TP;            // an output tile: four 64 x 64 boxes
constexpr int TT_NPAD = TD_MAX_K + TD_MN;        // the bias, zero past N
constexpr size_t TT_SMEM = 2 * ((size_t)TT_REGION + 2 * TT_OUT) +
                           4 * (2 * TT_KPAD + TT_NPAD + 3 * TD_MN) + 16 * (TT_STAGES + 1) + 1024;
static_assert(TT_STAGES * 4 * TT_BOX <= TT_REGION && TT_STAGES * (TT_XF + 2 * TT_BOX) <=
              TT_REGION && TD_MN * TT_XLD <= 2 * TT_OUT && TT_XLD * TD_KS <= TT_XF,
              "each layout fits the region and the output tiles");

template <bool FLAT>
__global__ void __launch_bounds__(TT_THREADS, 1)
td_fwd_tma_kernel(const __grid_constant__ CUtensorMap map_x,
                  const __grid_constant__ CUtensorMap map_w,
                  const __grid_constant__ CUtensorMap map_out, int K, int hw, int B,
                  const float* __restrict__ scale, const float* __restrict__ shift,
                  const float* __restrict__ bias, int N, int round_first,
                  const float* __restrict__ mask, const mma::u16* in, long long in_bstride,
                  mma::u16* out, long long out_bstride, int x_mode) {
  extern __shared__ __align__(128) unsigned char smem[];
  mma::u16* region = reinterpret_cast<mma::u16*>(
      smem + ((1024 - (mma::smem_u32(smem) & 1023)) & 1023));
  mma::u16* sO = region + TT_REGION;                   // two output tiles
  float* ssc = reinterpret_cast<float*>(sO + 2 * TT_OUT);
  float* ssh = ssc + TT_KPAD;
  float* sbias = ssh + TT_KPAD;
  float* smask = sbias + TT_NPAD;                      // the item's mask rows
  uint64_t* full = reinterpret_cast<uint64_t*>(smask + 3 * TD_MN);
  uint64_t* empty = full + TT_STAGES;
  uint64_t* wfull = empty + TT_STAGES;                 // the resident weight
  const int tid = threadIdx.x;
  // 128-pixel tiles: of each image (TMA), or of all images' positions
  // in a row (FLAT: a tile spans up to three images, hw >= 64)
  const int total = B * hw;
  const int tiles_img = (hw + TD_TP - 1) / TD_TP;
  const int tiles = FLAT ? (total + TD_TP - 1) / TD_TP : B * tiles_img;
  const int chunks = (N + TD_MN - 1) / TD_MN;
  const int nks = (K + TD_KS - 1) / TD_KS;
  // a block keeps one 128-output chunk and walks tiles: with the weight
  // chunk resident (K <= 320) a stage holds the x slice alone
  const bool wres = nks <= TT_WRES;
  const int x_el = FLAT ? TT_XF : 2 * TT_BOX;
  const int stage_el = x_el + (wres ? 0 : 2 * TT_BOX);
  mma::u16* ring = region + (wres ? TT_WRES * 2 * TT_BOX : 0);
  const int chunk = blockIdx.x % chunks;
  const int n0 = chunk * TD_MN;
  const int stride = gridDim.x / chunks;
  const int first = blockIdx.x / chunks;
  const int mine = tiles > first ? (tiles - 1 - first) / stride + 1 : 0;
  const int stages = mine * nks;
  for (int i = tid; i < TT_KPAD; i += TT_THREADS) {
    ssc[i] = i < K ? scale[i] : 0.f;  // x past K reads as 0: a = relu(0 * 0 + 0)
    ssh[i] = i < K ? shift[i] : 0.f;
  }
  for (int i = tid; i < TT_NPAD; i += TT_THREADS)
    sbias[i] = i >= N ? 0.f : round_first ? mma::bf(mma::to_bf(bias[i])) : bias[i];
  if (tid == 0) {
    for (int i = 0; i < TT_STAGES; ++i) {
      mma::mbar_init(full + i, FLAT ? 129 : 1);  // FLAT: and the producers' copies
      mma::mbar_init(empty + i, 2);  // one arrival per consumer warpgroup
    }
    mma::mbar_init(wfull, 1);
    mma::mbar_fence_init();
  }
  __syncthreads();

  if (tid < 128) {  // the producer warpgroup: one thread issues the TMA loads
    if (!FLAT && tid != 0) return;
    if (tid == 0 && wres && stages > 0) {
      mma::mbar_expect_tx(wfull, nks * 2 * TT_BOX * 2);
      for (int ks = 0; ks < nks; ++ks) {
        mma::tma_load_2d(region + ks * 2 * TT_BOX, &map_w, wfull, n0, ks * TD_KS);
        mma::tma_load_2d(region + ks * 2 * TT_BOX + TT_BOX, &map_w, wfull, n0 + 64,
                         ks * TD_KS);
      }
    }
    for (int s = 0; s < stages; ++s) {
      const int st = s % TT_STAGES;
      if (s >= TT_STAGES) mma::mbar_wait(empty + st, (s / TT_STAGES - 1) & 1);
      const int tile = first + (s / nks) * stride;
      const int k0 = (s % nks) * TD_KS;
      mma::u16* sx = ring + st * stage_el;
      if (tid == 0) {
        mma::mbar_expect_tx(full + st, (stage_el - (FLAT ? x_el : 0)) * 2);
        if (!FLAT) {
          const int b = tile / tiles_img;
          const int p0 = tile % tiles_img * TD_TP;
          mma::tma_load_3d(sx, &map_x, full + st, p0, k0, b);
          mma::tma_load_3d(sx + TT_BOX, &map_x, full + st, p0 + 64, k0, b);
        }
        if (!wres) {
          mma::tma_load_2d(sx + x_el, &map_w, full + st, n0, k0);
          mma::tma_load_2d(sx + x_el + TT_BOX, &map_w, full + st, n0 + 64, k0);
        }
      }
      if (FLAT) {  // the x slice [64 k][128 positions] by the whole warpgroup
        mma::flat_tile_async<TD_KS, TD_TP, 128>(
            sx, [](int r, int c) { return r * TT_XLD + c; }, in, in_bstride, hw, k0, K,
            tile * TD_TP, total, x_mode);
        if (x_mode == mma::kCopySync) mma::mbar_arrive(full + st);
        else mma::cp_async_arrive(full + st);
      }
    }
    return;
  }

  // consumers: warpgroup cw takes pixels 64 cw .. 64 cw + 63 of each tile
  const int ct = tid - 128;
  const int cw = ct / 128;
  const int wq = (ct / 32) % 4;
  const int lane = ct % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  // this lane's ldmatrix row (a channel) and 8-pixel chunk of the box
  const int lrow = (lane % 8) + 8 * (lane >> 4);
  const int lchunk = 2 * wq + ((lane >> 3) & 1);
  if (wres && stages > 0) mma::mbar_wait(wfull, 0);
  float d[64];
  for (int s = 0; s < stages; ++s) {
    const int st = s % TT_STAGES;
    const int ks = s % nks;
    mma::mbar_wait(full + st, (s / TT_STAGES) & 1);
    const uint32_t sx = mma::smem_u32(ring + st * stage_el) +
                        (FLAT ? 16 * 8 * cw : 2 * cw * TT_BOX);
    const mma::u16* sw = wres ? region + ks * 2 * TT_BOX : ring + st * stage_el + x_el;
    // a^T[p, k] for k = 64 ks + 16 q ..: four 8x8 matrices each, read
    // transposed, then T(relu(x * scale + shift))
    uint32_t a[4][4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int r = 16 * q + lrow;
      mma::ldsm_x4_t(a[q], FLAT ? sx + r * (2 * TT_XLD) + (lchunk << 4)
                                : sx + r * 128 + ((lchunk ^ (r & 7)) << 4));
      const int k = ks * TD_KS + 16 * q + 2 * t;
      const float s0 = ssc[k], s1 = ssc[k + 1], s8 = ssc[k + 8], s9 = ssc[k + 9];
      const float h0 = ssh[k], h1 = ssh[k + 1], h8 = ssh[k + 8], h9 = ssh[k + 9];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float sl = e < 2 ? s0 : s8, sh_ = e < 2 ? s1 : s9;
        const float hl = e < 2 ? h0 : h8, hh = e < 2 ? h1 : h9;
        a[q][e] = mma::pack_bf16x2_relu(__fadd_rn(__fmul_rn(mma::lo_f(a[q][e]), sl), hl),
                                        __fadd_rn(__fmul_rn(mma::hi_f(a[q][e]), sh_), hh));
      }
    }
    mma::fence_acc(d);
    mma::wgmma_fence();
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      // W[k, n]: rows 16q .. of both 64-output boxes, MN-major
      const uint64_t db = mma::gmma_desc(sw + 16 * q * 64, 8192, 1024, 1);
      mma::wgmma_m64n128k16_rs<1>(d, a[q], db, ks > 0 || q > 0);
    }
    mma::wgmma_commit();
    // nothing between the products and their wait: the compiler must not
    // move an A register or an accumulator while they run
    mma::wgmma_wait0();
    mma::fence_regs(a);
    mma::fence_acc(d);
    if (ct % 128 == 0) mma::mbar_arrive(empty + st);  // this warpgroup is done with it
    if (ks < nks - 1) continue;
    // the item's epilogue: T(T(sum) + T(bias)) (or T((sum + bias) * mask)),
    // transposed into an output tile of four [64 outputs][64 pixels] boxes
    // (the TMA store's 128-byte swizzle), two tiles taking turns so that an
    // item's store overlaps the next item's products
    const int tile = first + (s / nks) * stride;
    const int b = FLAT ? tile * TD_TP / hw : tile / tiles_img;  // FLAT: the first image
    const int p0 = FLAT ? tile * TD_TP : tile % tiles_img * TD_TP;
    mma::u16* so = FLAT ? sO : sO + (s / nks % 2) * TT_OUT;
    for (int i = ct; i < (FLAT ? 3 : 1) * TD_MN; i += 256)
      smask[i] = mask ? mask[min(b + i / TD_MN, B - 1) * N + min(n0 + i % TD_MN, N - 1)] : 1.f;
    if (!FLAT && ct == 0) mma::bulk_wait_read<1>();  // the store two items back has read it
    mma::named_sync(1, 256);
    // a lane's 8-output blocks i and i + 1, pixels 16 wq + 64 cw + 8 (j & 1)
    const int pst = 64 * cw + 16 * wq + 8 * ((lane >> 3) & 1);
    // FLAT: the mask rows of this lane's two pixels' images
    const int f_lo = p0 + 64 * cw + 16 * wq + g;
    const float* m_lo = smask + (FLAT ? (min(f_lo, total - 1) / hw - b) * TD_MN : 0);
    const float* m_hi = smask + (FLAT ? (min(f_lo + 8, total - 1) / hw - b) * TD_MN : 0);
#pragma unroll
    for (int i = 0; i < 16; i += 2) {
      uint32_t r[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {  // matrix j: outputs 8 (i + j / 2) .., pixel rows 8 (j & 1) ..
        const int n = 8 * (i + j / 2) + 2 * t;  // outputs past N are not stored
        const float* mrow = (j & 1) ? m_hi : m_lo;
        float va = d[4 * (i + j / 2) + 2 * (j & 1)];
        float vb = d[4 * (i + j / 2) + 2 * (j & 1) + 1];
        if (round_first) {
          const uint32_t s2 = mma::pack_bf16x2(va, vb);
          va = mma::lo_f(s2);
          vb = mma::hi_f(s2);
        }
        r[j] = mma::pack_bf16x2(__fmul_rn(__fadd_rn(va, sbias[n0 + n]), mrow[n]),
                                __fmul_rn(__fadd_rn(vb, sbias[n0 + n + 1]), mrow[n + 1]));
      }
      const int nrow = 8 * (i + (lane >> 4)) + (lane & 7);
      const int row = nrow % 64;
      mma::stsm_x4_t(mma::smem_u32(FLAT ? so + nrow * TT_XLD + pst
                                        : so + (nrow / 64 * 2 + pst / 64) * TT_BOX +
                                              row * 64 + ((((pst % 64) >> 3) ^ (row & 7)) << 3)),
                     r[0], r[1], r[2], r[3]);
    }
    if (!FLAT) {
      mma::fence_async_smem();
      mma::named_sync(1, 256);
      if (ct == 0) {
        for (int q = 0; q < 4; ++q)
          mma::tma_store_3d(&map_out, so + q * TT_BOX, p0 + 64 * (q % 2), n0 + 64 * (q / 2), b);
        mma::bulk_commit();
      }
      continue;
    }
    mma::named_sync(1, 256);
    // FLAT: output rows position by position (pairs where hw is even)
    const int rows = min(TD_MN, N - n0);
    if (hw % 2 == 0 && out_bstride % 2 == 0 && (reinterpret_cast<uintptr_t>(out) & 3) == 0) {
      for (int i = ct; i < rows * 64; i += 256) {
        const int r = i / 64;
        const int c = 2 * (i % 64);
        const int f = p0 + c;
        if (f >= total) continue;
        const int fb = f / hw;
        mma::u16* dst = out + fb * out_bstride + (long long)(n0 + r) * hw + f - fb * hw;
        *reinterpret_cast<uint32_t*>(dst) = *reinterpret_cast<const uint32_t*>(so + r * TT_XLD + c);
      }
    } else {
      for (int i = ct; i < rows * TD_TP; i += 256) {
        const int r = i / TD_TP;
        const int c = i % TD_TP;
        const int f = p0 + c;
        if (f >= total) continue;
        const int fb = f / hw;
        out[fb * out_bstride + (long long)(n0 + r) * hw + f - fb * hw] = so[r * TT_XLD + c];
      }
    }
    mma::named_sync(1, 256);  // the next epilogue overwrites the tile
  }
  if (ct == 0) mma::bulk_wait_all();
}

// cuTensorMapEncodeTiled, reached through the runtime (no link to libcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

static EncodeTiled td_encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    cudaDriverEntryPointQueryResult q;
    void* p = nullptr;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
            cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A bf16 tensor map of `rank` dimensions (innermost first) with 64 x 64
// boxes (the third dimension's box 1) and the 128-byte swizzle.
static bool td_map(CUtensorMap* m, const void* base, int rank, const cuuint64_t* dims,
                   const cuuint64_t* strides_bytes) {
  const EncodeTiled enc = td_encoder();
  const cuuint32_t box[3] = {64, 64, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return enc != nullptr &&
         enc(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base), dims,
             strides_bytes, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The SM count, with the dynamic shared-memory limit set at the first call (a
// library may call it when it loads, so that no launch, and no stream
// capture, meets the attribute call).
static cudaError_t td_setup(int* sms_out) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t e = cudaFuncSetAttribute(
        td_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)TD_SMEM);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(td_fwd_tma_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)TT_SMEM);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(td_fwd_tma_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)TT_SMEM);
    if (e == cudaSuccess && td_encoder() == nullptr) e = cudaErrorNotSupported;
    if (e == cudaSuccess) e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
  }
  *sms_out = sms;
  return cudaSuccess;
}

// The warp-specialized kernel takes every site whose weight TMA can load
// (N % 8 == 0, 16-byte aligned, K and N <= TD_MAX_K): with x and out by
// TMA where hw % 8 == 0 and the images are 16-byte aligned, else (FLAT,
// hw >= 64) x by the producer warpgroup's cp.async over flat positions.
// td_fwd_kernel takes the rest (odd widths and tiny planes in the tests).
static cudaError_t launch_td_mma(const void* in, long long in_bstride, int B, int K,
                                 int H, int W, const float* scale, const float* shift,
                                 const void* wt, const float* bias, int N, void* out,
                                 long long out_bstride, int round_first,
                                 const float* mask, cudaStream_t stream) {
  int sms = 0;
  const cudaError_t se = td_setup(&sms);
  if (se != cudaSuccess) return se;
  const int hw = H * W;
  const bool tma_w = N % 8 == 0 && K <= TD_MAX_K && N <= TD_MAX_K && mma::aligned16(wt);
  const bool tma_x = hw % 8 == 0 && in_bstride % 8 == 0 && out_bstride % 8 == 0 &&
                     mma::aligned16(in) && mma::aligned16(out);
  if (tma_w && (tma_x || hw >= 64)) {
    CUtensorMap mx, mw, mo;
    const cuuint64_t wd[2] = {(cuuint64_t)N, (cuuint64_t)K};
    const cuuint64_t ws[1] = {(cuuint64_t)N * 2};
    if (!td_map(&mw, wt, 2, wd, ws)) return cudaErrorInvalidValue;
    mx = mo = mw;
    if (tma_x) {
      const cuuint64_t xd[3] = {(cuuint64_t)hw, (cuuint64_t)K, (cuuint64_t)B};
      const cuuint64_t xs[2] = {(cuuint64_t)hw * 2, (cuuint64_t)in_bstride * 2};
      const cuuint64_t od[3] = {(cuuint64_t)hw, (cuuint64_t)N, (cuuint64_t)B};
      const cuuint64_t os[2] = {(cuuint64_t)hw * 2, (cuuint64_t)out_bstride * 2};
      if (!td_map(&mx, in, 3, xd, xs) || !td_map(&mo, out, 3, od, os))
        return cudaErrorInvalidValue;
    }
    // a block per SM, each keeping one 128-output chunk
    const int chunks = (N + TD_MN - 1) / TD_MN;
    const int tiles = tma_x ? B * ((hw + TD_TP - 1) / TD_TP) : (B * hw + TD_TP - 1) / TD_TP;
    const int grid = std::max(chunks, std::min(tiles * chunks, sms) / chunks * chunks);
    (tma_x ? td_fwd_tma_kernel<false> : td_fwd_tma_kernel<true>)
        <<<grid, TT_THREADS, TT_SMEM, stream>>>(
            mx, mw, mo, K, hw, B, scale, shift, bias, N, round_first, mask,
            static_cast<const mma::u16*>(in), in_bstride, static_cast<mma::u16*>(out),
            out_bstride, mma::row_copy_mode(hw, in_bstride, in));
    return cudaGetLastError();
  }
  const int items = (B * hw + TD_TP - 1) / TD_TP * ((N + TD_MN - 1) / TD_MN);
  const int vec_w = N % 8 == 0 && mma::aligned16(wt);
  const int vec_out = hw % 8 == 0 && out_bstride % 8 == 0 && mma::aligned16(out);
  td_fwd_kernel<<<std::min(items, TD_PER_SM * sms), TD_THREADS, TD_SMEM, stream>>>(
      static_cast<const mma::u16*>(in), in_bstride, K, hw, B, scale, shift,
      static_cast<const mma::u16*>(wt), bias, N, static_cast<mma::u16*>(out),
      out_bstride, round_first, mask, mma::row_copy_mode(hw, in_bstride, in), vec_w,
      vec_out);
  return cudaGetLastError();
}

}  // namespace s2r_td
