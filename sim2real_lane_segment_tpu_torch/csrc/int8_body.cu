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
// cores (1,979 TOP/s) it is bound by operations, not bytes.
//
// What the design does about it: one launch per conv with the epilogue
// fused; the activations live in device memory between launches.
// - conv_i8_mma_kernel (cin % 32 == 0, cout % 8 == 0, and the weights plus
//   one halo tile fit in shared memory: every site of the full-width
//   student) multiplies on the int8 tensor cores, mma.sync m16n8k32 s8 x
//   s8 -> s32 (IMMA) fed by ldmatrix, sums exact in int32.  A block keeps
//   every tap's weights for up to 128 outputs in shared memory, stored
//   [tap][cout][cin] (k contiguous, as mma's col operand wants; 166 KB at
//   the widest site), loaded once, and walks (image, 16 x 8 output-pixel
//   tile) items as a persistent block.  Per item it stages the tile's codes
//   once with a halo of dil, [halo pixel][channel] rows of cin + 16 bytes
//   (16-byte aligned, eight rows in eight bank slots; the border holds the
//   code -zp, written by plain stores since cp.async would zero it), so
//   every tap is a whole-row offset and all nine taps read the one staged
//   tile; the codes are pixel-major already, so nothing is transposed.
//   The next item's tile is in flight while this one is multiplied (two
//   buffers where they fit beside the weights, else during the epilogue).
//   Sixteen warps: eight own one 16-pixel m tile (two output rows) each,
//   two split the outputs (8-output tiles taken in turn).  The epilogue
//   moves output pairs, with a row's residual loads in flight before any
//   store; it costs more than the products (f32 in and out, a division per
//   code), and sixteen warps hide more of its latency than eight did.
//   Resident weights measured faster than weights streamed per tap and
//   tile (PERF.md, PR 6).
// - conv_i8_kernel (the rest, such as narrow test nets) uses __dp4a on the
//   CUDA cores (4 multiply-adds per instruction): a block owns 64 pixels
//   and 64 outputs, stages each tap's shifted codes and weights in shared
//   memory, and each thread keeps a 4x4 tile of int32 sums.
// Both end in site_y and site_res, the same operations in the same order.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "bnrelu_mma.cuh"

namespace {

constexpr int TP = 64;       // pixels per block
constexpr int TO = 64;       // output channels per block
constexpr int KW = 32;       // words (4 channels each) staged per step
constexpr int THREADS = 256;

// clip(rint(y / act) - zp) as an int8 code.  A zero y (every ReLU zero)
// skips the division, whose result, 0, is known: a zero dividend takes the
// IEEE division off its fast path, and a warp then waits for its slowest
// lane (measured: the code-only sites ran markedly faster with the skip).
__device__ __forceinline__ int8_t requant(float y, float act, float zp) {
  const float d = __fdiv_rn(y == 0.f ? 1.f : y, act);
  float q = __fsub_rn(rintf(y == 0.f ? 0.f : d), zp);  // rint: half to even
  q = fminf(fmaxf(q, -128.f), 127.f);
  return static_cast<int8_t>(__float2int_rn(q));
}

// A site's epilogue, in this order for both kernels: for output o,
// y = (float(acc) + zp*colsum) * (act*w_scale) + bias [, ReLU] (site_y),
// then, where there is a residual, h = max(y + res, 0) (site_res); y is
// stored in f32 and/or requantized for the next site.
__device__ __forceinline__ float site_y(int acc, int o, const float* __restrict__ zpsum,
                                        const float* __restrict__ deq,
                                        const float* __restrict__ bias, int relu) {
  const float y =
      __fadd_rn(__fmul_rn(__fadd_rn(__int2float_rn(acc), zpsum[o]), deq[o]), bias[o]);
  return relu ? fmaxf(y, 0.f) : y;
}

__device__ __forceinline__ float site_res(float y, float r) {
  return fmaxf(__fadd_rn(y, r), 0.f);
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
      float y = site_y(acc[i][j], o, zpsum, deq, bias, relu);
      if (res != nullptr) y = site_res(y, res[base + o]);
      if (out_f != nullptr) out_f[base + o] = y;
      if (out_q != nullptr) out_q[base + o] = requant(y, next_act, next_zp);
    }
  }
}

// ---------------------------------------------------------------------------
// The int8 tensor-core conv (IMMA).
// ---------------------------------------------------------------------------
constexpr int IM_TH = 16;          // output tile rows
constexpr int IM_TW = 8;           // output tile columns
constexpr int IM_NB = 128;         // outputs per block
constexpr int IM_THREADS = 512;    // 8 (pixel-row pairs) x 2 (outputs) warps
constexpr int IM_SMEM_MAX = 232448;  // a block's shared memory on sm_90 (227 KB opt-in)

__host__ __device__ __forceinline__ int im_lda(int cin) { return cin + 16; }  // bytes a row

// weight rows a tap keeps for nb outputs: the ldmatrix pairs of 8-output
// tiles (t, t + 2) read up to the next multiple of 32
__host__ __device__ __forceinline__ int im_rows(int nb) { return 32 * ((nb + 31) / 32); }

__host__ __device__ __forceinline__ int im_halo_bytes(int taps, int dil, int cin) {
  const int h = taps == 9 ? dil : 0;
  return (IM_TH + 2 * h) * (IM_TW + 2 * h) * im_lda(cin);
}

// every tap's weights for a block's outputs, then its outputs' zp*colsum,
// act*w_scale and bias (f32)
__host__ __device__ __forceinline__ int im_w_bytes(int taps, int cin, int cout) {
  return taps * im_rows(cout < IM_NB ? cout : IM_NB) * im_lda(cin) + 3 * 4 * IM_NB;
}

// halo tiles a block double-buffers (2), or 1 where two do not fit beside
// the weights, or 0 where one does not (the site then takes conv_i8_kernel;
// kernels/int8_body.imma_tiles states the rule for the CPU tests)
static int im_tiles(int taps, int dil, int cin, int cout) {
  const int w = im_w_bytes(taps, cin, cout);
  const int h = im_halo_bytes(taps, dil, cin);
  return w + 2 * h <= IM_SMEM_MAX ? 2 : w + h <= IM_SMEM_MAX ? 1 : 0;
}

__device__ __forceinline__ void imma_16832(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                           uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One conv site on the tensor cores.  q: codes [B, P, cin]; wc: int8
// [TAPS][cout][cin]; fill: the code -zp in all four bytes; nbuf: halo
// tiles in shared memory (im_tiles); the rest as conv_i8_kernel.  Grid:
// (persistent blocks, ceil(cout / IM_NB)); block x walks the (image, tile)
// items x, x + gridDim.x, ... of its output slice.
template <int TAPS>
__global__ void __launch_bounds__(IM_THREADS, 1)
conv_i8_mma_kernel(const int8_t* __restrict__ q, int B, int H, int W, int cin, int dil,
                   uint32_t fill, const int8_t* __restrict__ wc, int cout,
                   const float* __restrict__ zpsum, const float* __restrict__ deq,
                   const float* __restrict__ bias, int relu,
                   const float* __restrict__ res, float* __restrict__ out_f,
                   int8_t* __restrict__ out_q, float next_act, float next_zp, int nbuf) {
  namespace mma = s2r_mma;
  extern __shared__ __align__(128) unsigned char smem[];
  const int halo = TAPS == 9 ? dil : 0;
  const int hwid = IM_TW + 2 * halo;  // halo tile width
  const int lda = im_lda(cin);
  const int o0 = blockIdx.y * IM_NB;
  const int nb = min(IM_NB, cout - o0);
  const int ntiles = nb / 8;          // this block's 8-output tiles
  const int rows = im_rows(nb);
  unsigned char* sW = smem;                                    // [TAPS][rows][lda]
  float* sC = reinterpret_cast<float*>(smem + TAPS * rows * lda);  // [3][IM_NB]
  unsigned char* sH = smem + im_w_bytes(TAPS, cin, cout);      // [nbuf][halo px][lda]
  const int hbytes = im_halo_bytes(TAPS, dil, cin);
  const int tiles_x = (W + IM_TW - 1) / IM_TW;
  const int tiles = tiles_x * ((H + IM_TH - 1) / IM_TH);
  const int items = B * tiles;
  const int P = H * W;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp >> 1;  // output rows 2 wm, 2 wm + 1 (one m16 tile)
  const int wn = warp & 1;   // 8-output tiles wn, wn + 2, ...
  const mma::C3Lane ln(tid % 32);
  const int pieces = cin / 16;  // 16-byte pieces a pixel row

  // every tap's weight rows [o0, o0 + nb), once
  for (int i = tid; i < TAPS * nb * pieces; i += IM_THREADS) {
    const int r = i / pieces;  // tap * nb + row
    const int j = i - r * pieces;
    const int t = r / nb;
    const int o = r - t * nb;
    mma::cp_async16(sW + (t * rows + o) * lda + 16 * j,
                    wc + ((long long)t * cout + o0 + o) * cin + 16 * j, 16);
  }
  // the epilogue's per-output constants, read from shared memory there:
  // global loads between the epilogue's stores would wait on each other
  for (int i = tid; i < nb; i += IM_THREADS) {
    sC[i] = zpsum[o0 + i];
    sC[IM_NB + i] = deq[o0 + i];
    sC[2 * IM_NB + i] = bias[o0 + i];
  }
  // an item's halo tile into buffer `buf`: in-image pixels by cp.async, the
  // border as the fill code (cp.async would write zeros)
  auto stage = [&](int item, int buf) {
    const int b = item / tiles;
    const int tile = item - b * tiles;
    const int ty0 = (tile / tiles_x) * IM_TH - halo;
    const int tx0 = (tile % tiles_x) * IM_TW - halo;
    const int8_t* qb = q + (long long)b * P * cin;
    unsigned char* sA = sH + buf * hbytes;
    const int npx = (IM_TH + 2 * halo) * hwid;
    for (int i = tid; i < npx * pieces; i += IM_THREADS) {
      const int px = i / pieces;
      const int j = i - px * pieces;
      const int hy = px / hwid;
      const int gy = ty0 + hy;
      const int gx = tx0 + px - hy * hwid;
      unsigned char* d = sA + px * lda + 16 * j;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W)
        mma::cp_async16(d, qb + ((long long)gy * W + gx) * cin + 16 * j, 16);
      else
        *reinterpret_cast<uint4*>(d) = make_uint4(fill, fill, fill, fill);
    }
    mma::cp_async_commit();
  };

  if ((int)blockIdx.x < items) stage(blockIdx.x, 0);  // with the weights' copies
  int k = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x, ++k) {
    const int buf = nbuf == 2 ? (k & 1) : 0;
    const int next = item + gridDim.x;
    mma::cp_async_wait<0>();
    __syncthreads();  // this item's tile (and the weights) are in
    if (nbuf == 2 && next < items) stage(next, buf ^ 1);  // the other buffer is free

    int acc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0;
    const unsigned char* sA = sH + buf * hbytes;
    for (int t = 0; t < TAPS; ++t) {
      const int ky = TAPS == 9 ? t / 3 : 0;
      const int kx = TAPS == 9 ? t % 3 : 0;
      // lane's A row: output pixel (2 wm + j0, r8) read through tap t
      const uint32_t a_sm = mma::smem_u32(
          sA + ((2 * wm + ln.j0 + ky * dil) * hwid + ln.r8 + kx * dil) * lda + 16 * ln.j1);
      // lane's B row: output 8 (wn + 4 jp + 2 j1) + r8 of tap t, k half j0
      const uint32_t w_sm = mma::smem_u32(sW + (t * rows + 8 * (wn + 2 * ln.j1) + ln.r8) * lda +
                                          16 * ln.j0);
      for (int kk = 0; kk < cin; kk += 32) {
        uint32_t af[4];
        mma::ldsm_x4(af, a_sm + kk);
#pragma unroll
        for (int jp = 0; jp < 4; ++jp) {
          if (wn + 4 * jp >= ntiles) break;
          uint32_t bq[4];  // b0, b1 of tiles wn + 4 jp and wn + 4 jp + 2
          mma::ldsm_x4(bq, w_sm + 32 * jp * lda + kk);
          imma_16832(acc[2 * jp], af, bq[0], bq[1]);
          if (wn + 4 * jp + 2 < ntiles) imma_16832(acc[2 * jp + 1], af, bq[2], bq[3]);
        }
      }
    }
    if (nbuf == 1) {
      __syncthreads();  // every warp is done with the tile
      if (next < items) stage(next, 0);
    }

    // epilogue: each lane owns output pairs (o, o + 1) of two pixel rows
    const int b = item / tiles;
    const int tile = item - b * tiles;
    const int ty0 = (tile / tiles_x) * IM_TH;
    const int tx0 = (tile % tiles_x) * IM_TW;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int gy = ty0 + 2 * wm + half;
      const int gx = tx0 + ln.g;
      if (gy >= H || gx >= W) continue;
      const long long base = ((long long)b * P + gy * W + gx) * cout + o0 + 2 * ln.t;
      float2 rv[8];  // the residual's pairs, all loads in flight first
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (res != nullptr && wn + 2 * j < ntiles)
          rv[j] = __ldg(reinterpret_cast<const float2*>(res + base + 8 * (wn + 2 * j)));
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int nt = wn + 2 * j;
        if (nt >= ntiles) break;
        const int o = 8 * nt + 2 * ln.t;  // in the block's slice
        const long long at = base + 8 * nt;
        float y0 = site_y(acc[j][2 * half], o, sC, sC + IM_NB, sC + 2 * IM_NB, relu);
        float y1 = site_y(acc[j][2 * half + 1], o + 1, sC, sC + IM_NB, sC + 2 * IM_NB, relu);
        if (res != nullptr) {
          y0 = site_res(y0, rv[j].x);
          y1 = site_res(y1, rv[j].y);
        }
        if (out_f != nullptr) *reinterpret_cast<float2*>(out_f + at) = make_float2(y0, y1);
        if (out_q != nullptr)
          *reinterpret_cast<uint16_t*>(out_q + at) =
              (uint16_t)((uint8_t)requant(y0, next_act, next_zp) |
                         ((uint8_t)requant(y1, next_act, next_zp) << 8));
      }
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
// point, whose code -zp_in fills the border.  wq: the weights as dp4a words
// [taps * cin / 4][cout]; wc: as int8 [taps][cout][cin].  Dispatch
// (takes_imma in kernels/int8_body.py states it for the CPU tests): cin %
// 32 == 0, cout % 8 == 0 and im_tiles > 0 run on the int8 tensor cores
// (conv_i8_mma_kernel, q and wc 16-byte aligned), the rest on the CUDA
// cores (conv_i8_kernel).  *route receives the route taken: the halo tiles
// the tensor-core kernel keeps (1 or 2), or 0 for the CUDA cores.
extern "C" int s2r_i8_conv(int taps, const int8_t* q, int B, int H, int W,
                           int cin, int dil, int zp_in, const int* wq,
                           const int8_t* wc, int cout, const float* zpsum,
                           const float* deq, const float* bias, int relu,
                           const float* res, float* out_f, int8_t* out_q,
                           float next_act, float next_zp, int* route, void* stream) {
  *route = 0;
  if (cin % 4 != 0 || B <= 0 || H <= 0 || W <= 0 || cout <= 0 || (taps != 9 && taps != 1))
    return cudaErrorInvalidValue;
  const uint32_t fill = 0x01010101u * (uint8_t)(int8_t)(-zp_in);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nbuf = cin % 32 == 0 && cout % 8 == 0 ? im_tiles(taps, dil, cin, cout) : 0;
  if (nbuf > 0) {
    if (!s2r_mma::aligned16(q) || !s2r_mma::aligned16(wc)) return cudaErrorMisalignedAddress;
    static int sms = 0;  // the SM count, with the shared-memory limits set once
    if (sms == 0) {
      int dev = 0;
      cudaError_t e = cudaFuncSetAttribute(
          conv_i8_mma_kernel<9>, cudaFuncAttributeMaxDynamicSharedMemorySize, IM_SMEM_MAX);
      if (e == cudaSuccess)
        e = cudaFuncSetAttribute(conv_i8_mma_kernel<1>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, IM_SMEM_MAX);
      if (e == cudaSuccess) e = cudaGetDevice(&dev);
      if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      if (e != cudaSuccess) return e;
    }
    const auto kernel = taps == 9 ? conv_i8_mma_kernel<9> : conv_i8_mma_kernel<1>;
    const int smem = im_w_bytes(taps, cin, cout) + nbuf * im_halo_bytes(taps, dil, cin);
    int per_sm = 0;
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                                        IM_THREADS, smem);
    if (e != cudaSuccess) return e;
    const int items = B * ((H + IM_TH - 1) / IM_TH) * ((W + IM_TW - 1) / IM_TW);
    const int slices = (cout + IM_NB - 1) / IM_NB;
    const int blocks = std::max(1, std::min(items, std::max(1, per_sm * sms / slices)));
    kernel<<<dim3(blocks, slices), IM_THREADS, smem, s>>>(
        q, B, H, W, cin, dil, fill, wc, cout, zpsum, deq, bias, relu, res, out_f, out_q,
        next_act, next_zp, nbuf);
    *route = nbuf;
    return cudaGetLastError();
  }
  const dim3 grid((H * W + TP - 1) / TP, (cout + TO - 1) / TO, B);
  if (taps == 9)
    conv_i8_kernel<9><<<grid, THREADS, 0, s>>>(
        q, H, W, cin, dil, (int)fill, wq, cout, zpsum, deq, bias, relu, res, out_f,
        out_q, next_act, next_zp);
  else
    conv_i8_kernel<1><<<grid, THREADS, 0, s>>>(
        q, H, W, cin, dil, (int)fill, wq, cout, zpsum, deq, bias, relu, res, out_f,
        out_q, next_act, next_zp);
  return cudaGetLastError();
}

// The halo tiles conv_i8_mma_kernel keeps at this shape, 0 where it does
// not fit (kernels/int8_body.imma_tiles states the rule for the CPU tests).
extern "C" int s2r_i8_imma_tiles(int taps, int dil, int cin, int cout) {
  return im_tiles(taps, dil, cin, cout);
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
