// Label extraction from (original, annotated) frame pairs, for NVIDIA
// Hopper (sm_90a).
//
// Replaces the TPU kernel K5 of the JAX package:
//   sim2real_lane_segment_tpu/ops/labelgen_pallas.py
//   _kernel, launched by process_classes_fused (pallas_call at :107).
//
// What it computes, the whole of ops/labelgen.process_classes per pixel of
// a uint8 (N, H, W, 3) pair:
//   1. the difference annot - orig per channel (only its sign matters);
//   2. the channel-sign rules on (b, g, r) in BGR or RGB order:
//      right = g > 0, left = b > 0,
//      obstacle = r > 0 or (r >= 0 and (b < 0 or g < 0));
//   3. per class, a 5x5 OPEN then CLOSE: erode, dilate, dilate, erode,
//      each with cv2's border (erosion pads 1, dilation pads 0);
//   4. priority: right = 1, then left = 2, then obstacle = 3 wins.
// The output is bit-exact against the plain version.
//
// What bounds it: it must read 6 bytes and write 1 per pixel, 68.8 MB for
// 32 pairs at 480x640, 20.5 us at 3.35 TB/s.  The work per pixel is a few
// dozen integer operations, so it is bound by bytes.
//
// What the design does about it: each class is a bit plane, 32 pixels a
// 32-bit word (pixel x at bit x % 32), and a block owns a strip of
// LG_STRIP rows of one image across a column tile of up to 32 words, one
// word per lane of a warp.  It reads its strip with the LG_HALO = 8-row
// halo (4 passes x radius 2) once from device memory, every thread taking
// 16-pixel groups of any staged row (16 pixels = 48 bytes = 3 uint4 per
// frame, two groups' loads in flight): byte permutes gather each channel
// of four pixels into a word, the frames are compared four bytes at a time
// (carry-free SWAR), and the sign rules are a few bitwise operations on
// the comparisons.  A rect window is separable, so each pass is a row pass
// then a column pass:
//   row pass: AND (erode) or OR (dilate) of the word shifted by 1 and 2
//     pixels each way, the bits crossing words taken from the neighbouring
//     lanes (__shfl, __funnelshift), in registers;
//   column pass: AND or OR of five row words in shared memory (two buffers,
//     3 planes x (LG_STRIP + 16) rows x 32 words each).
// The last pass writes the priority code 16 bytes at a time.  In the
// passes a warp owns every eighth row, so a pass is one __syncthreads.
//
// Borders, as cv2 treats them: a neighbour outside the image is the pass's
// identity (1s for erosion, 0s for dilation), so bits past W in the last
// word are set to it before each row pass, the word before the first and
// after the last word of a row is the identity, and rows outside the image
// are skipped.  Neighbours outside what the block loaded (past its halo
// rows, or past the halo word of an inner column tile) are skipped too:
// their effect reaches 2 pixels per pass, 8 in all, which the 8-row halo
// and the 32-pixel halo word absorb.
//
// Frames wider than 32 words (1024 pixels) take column tiles of at most
// LG_LANES - 2 core words with one halo word on each inner side, in the
// same launch.  Rows that are not 16-byte aligned (W % 16 != 0) take byte
// loads and stores in the same kernel.  kernels/labelgen.geometry states
// the launch geometry for the CPU tests.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LG_STRIP = 32;                    // output rows per block
constexpr int LG_HALO = 8;                      // 4 passes x radius 2
constexpr int LG_ROWS = LG_STRIP + 2 * LG_HALO;  // rows staged per block
constexpr int LG_LANES = 32;                    // words per row: one per lane
constexpr int LG_WARPS = 8;
constexpr int LG_THREADS = 32 * LG_WARPS;
constexpr unsigned FULL = 0xffffffffu;

struct Geometry {
  int words;  // 32-pixel words per row
  int tiles;  // column tiles
  int core;   // words a column tile writes
};

__host__ __device__ __forceinline__ Geometry geometry(int W) {
  Geometry g;
  g.words = (W + 31) / 32;
  g.tiles = g.words <= LG_LANES ? 1 : (g.words + LG_LANES - 3) / (LG_LANES - 2);
  g.core = (g.words + g.tiles - 1) / g.tiles;
  return g;
}

// the top bit of each byte of x, as 4 bits
__device__ __forceinline__ uint32_t movmask4(uint32_t x) {
  return ((x & 0x80808080u) * 0x00204081u) >> 28;
}

// per byte, a > b (unsigned) in the byte's top bit; the other bits are
// not defined.  (a | 0x80) - (b & 0x7f) - 1 borrows from no other byte, and
// its top bit says a % 128 > b % 128
__device__ __forceinline__ uint32_t gt4(uint32_t a, uint32_t b) {
  const uint32_t low = (a | 0x80808080u) - (b & 0x7f7f7f7fu) - 0x01010101u;
  return (a & ~b) | (~(a ^ b) & low);
}

// channel c of the 4 pixels in w0..w2 (12 bytes, 3 per pixel), one a byte
template <int C>
__device__ __forceinline__ uint32_t channel4(uint32_t w0, uint32_t w1, uint32_t w2) {
  if (C == 0) return __byte_perm(__byte_perm(w0, w1, 0x0630), w2, 0x5210);
  if (C == 1) return __byte_perm(__byte_perm(w0, w1, 0x0741), w2, 0x6210);
  return __byte_perm(__byte_perm(w0, w1, 0x0052), w2, 0x7410);
}

// the class bits of 16 pixels (48 bytes of each frame as 12 words) into
// bits 0-15 of m[0..2] (right, left, obstacle), four pixels at a time
template <bool BGR>
__device__ __forceinline__ void decode16(const uint32_t (&o)[12], const uint32_t (&a)[12],
                                         uint32_t (&m)[3]) {
  m[0] = m[1] = m[2] = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t *oj = o + 3 * j, *aj = a + 3 * j;
    const uint32_t ob = BGR ? channel4<0>(oj[0], oj[1], oj[2]) : channel4<2>(oj[0], oj[1], oj[2]);
    const uint32_t og = channel4<1>(oj[0], oj[1], oj[2]);
    const uint32_t orr = BGR ? channel4<2>(oj[0], oj[1], oj[2]) : channel4<0>(oj[0], oj[1], oj[2]);
    const uint32_t ab = BGR ? channel4<0>(aj[0], aj[1], aj[2]) : channel4<2>(aj[0], aj[1], aj[2]);
    const uint32_t ag = channel4<1>(aj[0], aj[1], aj[2]);
    const uint32_t ar = BGR ? channel4<2>(aj[0], aj[1], aj[2]) : channel4<0>(aj[0], aj[1], aj[2]);
    // right = g > 0, left = b > 0, obstacle = r > 0 or (r >= 0 and (b < 0 or g < 0))
    const uint32_t obst = gt4(ar, orr) | (~gt4(orr, ar) & (gt4(ob, ab) | gt4(og, ag)));
    m[0] |= movmask4(gt4(ag, og)) << (4 * j);
    m[1] |= movmask4(gt4(ab, ob)) << (4 * j);
    m[2] |= movmask4(obst) << (4 * j);
  }
}

// 48 bytes of a row from pixel x: 3 uint4 (vec) or bytes, 0 past pixel W
__device__ __forceinline__ void load48(const uint8_t* row, int x, int W, bool vec,
                                       uint32_t (&w)[12]) {
  if (vec) {
    const uint4* p = reinterpret_cast<const uint4*>(row + 3 * x);
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const uint4 v = __ldg(p + j);
      w[4 * j] = v.x;
      w[4 * j + 1] = v.y;
      w[4 * j + 2] = v.z;
      w[4 * j + 3] = v.w;
    }
    return;
  }
#pragma unroll
  for (int k = 0; k < 12; ++k) w[k] = 0;
  for (int k = 0; k < 48; ++k)
    if (x + k / 3 < W) w[k >> 2] |= (uint32_t)row[3 * x + k] << (8 * (k & 3));
}

// row pass over one word per lane: AND (erode) or OR (dilate) of pixels
// x-2 .. x+2.  valid: the bits of this lane's word inside the image;
// first, last: no staged word precedes, follows this lane's (the row's
// ends, or a column tile's edges)
template <bool ERODE>
__device__ __forceinline__ uint32_t row_pass(uint32_t v, uint32_t valid, bool first,
                                             bool last) {
  const uint32_t id = ERODE ? FULL : 0u;
  v = ERODE ? (v | ~valid) : (v & valid);
  uint32_t prev = __shfl_up_sync(FULL, v, 1);
  uint32_t next = __shfl_down_sync(FULL, v, 1);
  if (first) prev = id;
  if (last) next = id;
  const uint32_t e1 = __funnelshift_r(v, next, 1), e2 = __funnelshift_r(v, next, 2);
  const uint32_t w1 = __funnelshift_l(prev, v, 1), w2 = __funnelshift_l(prev, v, 2);
  return ERODE ? (v & e1 & e2 & w1 & w2) : (v | e1 | e2 | w1 | w2);
}

typedef uint32_t Planes[3][LG_ROWS][LG_LANES];

// column pass of row r from src (rows outside the image or the block's
// staged rows skipped)
template <bool ERODE>
__device__ __forceinline__ void col_pass(const Planes& src, int r, int y, int H, int lane,
                                         uint32_t (&m)[3]) {
#pragma unroll
  for (int p = 0; p < 3; ++p) m[p] = ERODE ? FULL : 0u;
#pragma unroll
  for (int d = -2; d <= 2; ++d) {
    const int rr = r + d, yy = y + d;
    if (rr < 0 || rr >= LG_ROWS || yy < 0 || yy >= H) continue;
#pragma unroll
    for (int p = 0; p < 3; ++p)
      m[p] = ERODE ? (m[p] & src[p][rr][lane]) : (m[p] | src[p][rr][lane]);
  }
}

// four pixels' codes (bits q..q+3 of hi, lo) as four bytes
__device__ __forceinline__ uint32_t codes4(uint32_t hi, uint32_t lo, int q) {
  const uint32_t l = (((lo >> q) & 0xfu) * 0x00204081u) & 0x01010101u;
  const uint32_t h = (((hi >> q) & 0xfu) * 0x00204081u) & 0x01010101u;
  return l | (h << 1);
}

template <bool BGR>
__global__ void __launch_bounds__(LG_THREADS)
labelgen_kernel(const uint8_t* __restrict__ orig, const uint8_t* __restrict__ annot,
                int H, int W, int vec, uint8_t* __restrict__ out) {
  __shared__ Planes buf[2];
  const Geometry geo = geometry(W);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int cw0 = blockIdx.x * geo.core;             // core words [cw0, cw1)
  const int cw1 = min(geo.words, cw0 + geo.core);
  const int lw0 = max(0, cw0 - 1);                   // lane 0's word
  const int lw1 = min(geo.words, cw1 + 1);           // past the last staged
  const int gw = lw0 + lane;
  const bool live = gw < lw1;
  const bool first = gw == 0 || lane == 0;
  const bool last = gw >= geo.words - 1 || lane == LG_LANES - 1;
  const uint32_t valid = !live                                  ? 0u
                         : (gw == geo.words - 1 && (W & 31)) ? (1u << (W & 31)) - 1u
                                                                : FULL;
  const int x0 = 32 * gw;
  const int y0 = blockIdx.y * LG_STRIP - LG_HALO;    // image row of staged row 0
  const long long img = (long long)blockIdx.z * H;

  // the class planes: every thread decodes 16-pixel groups (item i: staged
  // row i / G, group i % G), two at a time with both groups' loads first
  const int G = 2 * (lw1 - lw0);                     // groups a staged row
  const int items = LG_ROWS * G;
  int ir = threadIdx.x / G, ig = threadIdx.x % G;    // item threadIdx.x
  const int dr = LG_THREADS / G, dg = LG_THREADS % G;  // a step of LG_THREADS
  for (int i = threadIdx.x; i < items; i += 2 * LG_THREADS) {
    int rs[2], gs[2];
    bool ok[2];
    uint32_t o[2][12], a[2][12];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      rs[u] = ir;
      gs[u] = ig;
      const int y = y0 + ir, x = 32 * lw0 + 16 * ig;
      ok[u] = i + u * LG_THREADS < items && y >= 0 && y < H && x < W;
      if (ok[u]) {
        const long long row = (img + y) * W * 3;
        load48(orig + row, x, W, vec, o[u]);
        load48(annot + row, x, W, vec, a[u]);
      }
      ir += dr;
      ig += dg;
      if (ig >= G) {
        ig -= G;
        ++ir;
      }
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      if (!ok[u]) continue;
      uint32_t m[3];
      decode16<BGR>(o[u], a[u], m);
#pragma unroll
      for (int p = 0; p < 3; ++p)
        reinterpret_cast<uint16_t*>(buf[0][p][rs[u]])[gs[u]] = (uint16_t)m[p];
    }
  }
  __syncthreads();

  // the first row pass (OPEN's erode), in place: a warp owns its rows
  for (int rr = warp; rr < LG_ROWS; rr += LG_WARPS) {
    const int y = y0 + rr;
    if (y < 0 || y >= H) continue;
#pragma unroll
    for (int p = 0; p < 3; ++p)
      buf[0][p][rr][lane] = row_pass<true>(buf[0][p][rr][lane], valid, first, last);
  }
  __syncthreads();

  // OPEN's column erode, row dilate; then CLOSE's dilates; then CLOSE's row
  // erode
#pragma unroll
  for (int pass = 0; pass < 3; ++pass) {
    const Planes& src = buf[pass & 1];
    Planes& dst = buf[(pass & 1) ^ 1];
    for (int r = warp; r < LG_ROWS; r += LG_WARPS) {
      const int y = y0 + r;
      if (y < 0 || y >= H) continue;
      uint32_t m[3];
      if (pass == 0) col_pass<true>(src, r, y, H, lane, m);
      else col_pass<false>(src, r, y, H, lane, m);
#pragma unroll
      for (int p = 0; p < 3; ++p)
        dst[p][r][lane] = pass == 2 ? row_pass<true>(m[p], valid, first, last)
                                    : row_pass<false>(m[p], valid, first, last);
    }
    __syncthreads();
  }

  // CLOSE's column erode on the strip's own rows, and the priority codes
  if (gw < cw0 || gw >= cw1) return;
  for (int r = LG_HALO + warp; r < LG_HALO + LG_STRIP; r += LG_WARPS) {
    const int y = y0 + r;
    if (y >= H) break;
    uint32_t m[3];
    col_pass<true>(buf[1], r, y, H, lane, m);
    // code = obstacle ? 3 : left ? 2 : right ? 1 : 0, as two bits
    const uint32_t hi = m[2] | m[1];
    const uint32_t lo = m[2] | (m[0] & ~m[1]);
    uint8_t* o = out + (img + y) * W + x0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (x0 + 16 * h >= W) break;
      const uint4 v = make_uint4(codes4(hi, lo, 16 * h), codes4(hi, lo, 16 * h + 4),
                                 codes4(hi, lo, 16 * h + 8), codes4(hi, lo, 16 * h + 12));
      if (vec) {
        reinterpret_cast<uint4*>(o)[h] = v;
      } else {
        const uint32_t w4[4] = {v.x, v.y, v.z, v.w};
        for (int k = 0; k < 16 && x0 + 16 * h + k < W; ++k)
          o[16 * h + k] = (uint8_t)(w4[k >> 2] >> (8 * (k & 3)));
      }
    }
  }
}

}  // namespace

// The launch geometry at H x W (kernels/labelgen.geometry states it for
// the CPU tests): g[0] strip rows, g[1] strips, g[2] words per row, g[3]
// column tiles, g[4] core words per tile, g[5] shared memory bytes a block.
extern "C" void s2r_labelgen_geometry(int H, int W, int* g) {
  const Geometry geo = geometry(W);
  g[0] = LG_STRIP;
  g[1] = (H + LG_STRIP - 1) / LG_STRIP;
  g[2] = geo.words;
  g[3] = geo.tiles;
  g[4] = geo.core;
  g[5] = (int)(2 * sizeof(Planes));
}

// Plain C interface, bound with ctypes.  orig, annot: uint8 (N, H, W, 3);
// out: uint8 (N, H, W); bgr: 1 for BGR channel order, 0 for RGB.  Returns
// the cudaError_t of the launch (0 on success).
extern "C" int s2r_labelgen(const uint8_t* orig, const uint8_t* annot, int N,
                            int H, int W, int bgr, uint8_t* out,
                            void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || N > 65535) return cudaErrorInvalidValue;
  const Geometry geo = geometry(W);
  const auto a16 = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  const int vec = W % 16 == 0 && a16(orig) && a16(annot) && a16(out);
  const dim3 grid(geo.tiles, (H + LG_STRIP - 1) / LG_STRIP, N);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bgr)
    labelgen_kernel<true><<<grid, LG_THREADS, 0, s>>>(orig, annot, H, W, vec, out);
  else
    labelgen_kernel<false><<<grid, LG_THREADS, 0, s>>>(orig, annot, H, W, vec, out);
  return cudaGetLastError();
}

extern "C" const char* s2r_labelgen_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
