// Shared device code for the bf16 tensor-core kernels on Hopper: BN + ReLU
// staging of NCHW channel rows into bf16 shared-memory tiles, wgmma
// (m64n128k16) on tiles in shared memory, a 64x32 warp tile of mma.sync
// m16n8k16 products fed by ldmatrix (bf16 in, f32 sums), and, at the end,
// the [pixel][channel] staging and tap addressing of the 3x3 dense layers.
//
// Used by td_fwd_small_kernel and td_fwd_mma_kernel (csrc/td_fwd_mma.cuh),
// by the 3x3 dense-layer forward of csrc/dense3x3_mma.cuh (serving's
// dense3x3_mma_kernel and K1's fwd3x3_mma_kernel), by
// bwd1x1_dgrad_mma_kernel (wgmma) and bwd1x1_wgrad_mma_kernel (mma.sync)
// and by sum_dgrad_mma_kernel and stage_own_mma_kernel (mma.sync) in
// csrc/train_block.cu.
//
// Row-major shared-memory tiles for ldmatrix have a row stride (ld) of a
// multiple of 64 elements plus 8: a row then starts 16 bytes further along
// the 128-byte bank window than the previous one, so the eight 16-byte rows
// of one ldmatrix 8x8 matrix fall in different banks.
//
// mma.sync.m16n8k16 fragments (g = lane / 4, t = lane % 4):
//   A (16 x 16, m x k): a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..),
//                       a3 (g+8, 2t+8..)
//   B (16 x 8,  k x n): b0 (2t..2t+1, g), b1 (2t+8.., g)
//   D (16 x 8,  m x n): d0, d1 (g, 2t..2t+1), d2, d3 (g+8, 2t..2t+1)
// ldmatrix.x4 gives each lane row g, columns 2t..2t+1 of four 8x8 matrices
// whose rows lanes 8j..8j+7 address; .trans gives the transposed matrix.
// An operand stored with its k dimension contiguous is read without .trans,
// one stored with m (A) or n (B) contiguous is read with .trans.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace s2r_mma {

typedef unsigned short u16;  // bf16 bits
typedef long long ll;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ float bf(u16 v) {
  return __bfloat162float(__ushort_as_bfloat16(v));
}

__device__ __forceinline__ u16 to_bf(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// two f32 values rounded to bf16 (nearest even) in one word, lo in the low
// half; the relu form clamps negative results to 0 (the same values as
// rounding relu's output)
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}
__device__ __forceinline__ uint32_t pack_bf16x2_relu(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.relu.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}
__device__ __forceinline__ float lo_f(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi_f(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// T(relu(x * scale + shift)) on 8 packed bf16 values: separate multiply
// and add (no fma contraction), as the plain PyTorch versions compute it
__device__ __forceinline__ uint4 bn_relu8(uint4 x, float s, float h) {
  uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int q = 0; q < 4; ++q)
    w[q] = pack_bf16x2_relu(__fadd_rn(__fmul_rn(lo_f(w[q]), s), h),
                            __fadd_rn(__fmul_rn(hi_f(w[q]), s), h));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16-byte global -> shared copy; src_bytes 0 fills the destination with zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// 4-byte global -> shared copy; src_bytes 0 fills the destination with zeros
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes) : "memory");
}

__host__ __device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// acc[mt][nt][.] += A[am0 + 16 mt .., ak0 .. ak0+16) x B[bk0 .. +16, bn0 + 8 nt ..]
// for one warp: a 64 (m) x 32 (n) tile, one k step of 16.
//   A_T = false: A stored [m][k] (k contiguous); true: stored [k][m].
//   B_T = false: B stored [n][k] (k contiguous); true: stored [k][n].
// a, b: shared-memory byte addresses of the tiles; lda, ldb: row strides
// in elements.  acc[mt][nt][e] is D at m = am0 + 16 mt + g + 8 (e / 2),
// n = bn0 + 8 nt + 2t + e % 2.
template <bool A_T, bool B_T>
__device__ __forceinline__ void warp_mma_k16(float (&acc)[4][4][4], uint32_t a, int lda,
                                             int am0, int ak0, uint32_t b, int ldb,
                                             int bn0, int bk0) {
  const int lane = threadIdx.x % 32;
  const int r8 = lane % 8;
  const int j0 = (lane >> 3) & 1;
  const int j1 = lane >> 4;
  uint32_t af[4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
    if (A_T) {
      const int row = ak0 + r8 + 8 * j1;
      const int col = am0 + 16 * mt + 8 * j0;
      ldsm_x4_t(af[mt], a + 2u * (uint32_t)(row * lda + col));
    } else {
      const int row = am0 + 16 * mt + r8 + 8 * j0;
      const int col = ak0 + 8 * j1;
      ldsm_x4(af[mt], a + 2u * (uint32_t)(row * lda + col));
    }
  }
  uint32_t bfr[2][4];
#pragma unroll
  for (int np = 0; np < 2; ++np) {
    if (B_T) {
      const int row = bk0 + r8 + 8 * j0;
      const int col = bn0 + 16 * np + 8 * j1;
      ldsm_x4_t(bfr[np], b + 2u * (uint32_t)(row * ldb + col));
    } else {
      const int row = bn0 + 16 * np + r8 + 8 * j1;
      const int col = bk0 + 8 * j0;
      ldsm_x4(bfr[np], b + 2u * (uint32_t)(row * ldb + col));
    }
  }
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
      mma_16816(acc[mt][nt], af[mt], bfr[nt / 2][2 * (nt % 2)],
                bfr[nt / 2][2 * (nt % 2) + 1]);
}

template <int M>
__device__ __forceinline__ void zero_acc(float (&acc)[4][4][M]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < M; ++e) acc[i][j][e] = 0.f;
}

// A [rows][128] bf16 tile whose 16-byte chunks are XOR-swizzled by row
// (chunk j of row r at r * 128 + ((j ^ (r & 7)) * 8)): an epilogue's pair
// writes (eight rows, four lanes) and a row's 16-byte reads are both free
// of bank conflicts.
__device__ __forceinline__ int swz_off(int row, int col) {
  return row * 128 + ((((col >> 3) ^ (row & 7)) << 3) | (col & 7));
}

// How copy_rows_async moves a channel row: 16-byte cp.async (hw % 8 == 0
// and the rows 16-byte aligned), 4-byte cp.async (hw even, rows 4-byte
// aligned) or plain loads and stores (odd hw).
enum RowCopy { kCopy16 = 0, kCopy4 = 1, kCopySync = 2 };

__host__ __forceinline__ int row_copy_mode(int hw, ll bstride, const void* base) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(base);
  if (hw % 8 == 0 && bstride % 8 == 0 && (a & 15) == 0) return kCopy16;
  if (hw % 2 == 0 && bstride % 2 == 0 && (a & 3) == 0) return kCopy4;
  return kCopySync;
}

// Copies channel rows [0, rows) of x (row r at x + r * hw; rows >= nvalid
// are zero) over pixels [p0, p0 + COLS) into dst[r][c] (row stride ld),
// zeros past hw, by `mode` (RowCopy).  The caller commits and waits.
template <int COLS, int THREADS>
__device__ __forceinline__ void copy_rows_async(u16* dst, int ld, int rows, const u16* x,
                                                int hw, int nvalid, int p0, int mode) {
  constexpr int VPR = COLS / 8;
  for (int i = threadIdx.x; i < rows * VPR; i += THREADS) {
    const int r = i / VPR;
    const int c = (i % VPR) * 8;
    const int p = p0 + c;
    u16* d = dst + r * ld + c;
    const u16* src = x + (ll)r * hw + p;
    const bool row_ok = r < nvalid;
    if (mode == kCopy16) {
      const bool ok = row_ok && p < hw;
      cp_async16(d, ok ? src : x, ok ? 16 : 0);
    } else if (mode == kCopy4) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const bool ok = row_ok && p + 2 * q < hw;
        cp_async4(d + 2 * q, ok ? src + 2 * q : x, ok ? 4 : 0);
      }
    } else {
      __align__(16) u16 v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = (row_ok && p + e < hw) ? src[e] : (u16)0;
      *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(v);
    }
  }
}

// Raw bf16 bits of pixels p .. p+7 of one channel row (zeros past hw).
// vec: the row and p are 16-byte aligned.
__device__ __forceinline__ uint4 load_px8(const u16* row, int p, int hw, bool vec) {
  if (vec && p + 8 <= hw) return __ldg(reinterpret_cast<const uint4*>(row + p));
  __align__(16) u16 v[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = p + e < hw ? row[p + e] : (u16)0;
  return *reinterpret_cast<const uint4*>(v);
}

// Stages channel rows [0, rows) of x (row r at x + r * hw; rows >= nvalid
// are zero) over pixels [p0, p0 + COLS) into dst[r][c] (row stride ld):
// BN = true: T(relu(x * scale[r] + shift[r])); false: x as it is.  Pixels
// at or past hw read as zero (with BN, as T(relu(shift))).  Eight 16-byte
// loads per thread are in flight before any is used.  vec: hw % 8 == 0
// and x 16-byte aligned.
template <bool BN, int COLS, int THREADS>
__device__ __forceinline__ void stage_rows(u16* dst, int ld, int rows, const u16* x,
                                           int hw, int nvalid, int p0,
                                           const float* scale, const float* shift,
                                           bool vec) {
  constexpr int VPR = COLS / 8;
  const int total = rows * VPR;
  constexpr int LOADS = 8;
  for (int i0 = threadIdx.x; i0 < total; i0 += LOADS * THREADS) {
    uint4 raw[LOADS];
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
      const int i = i0 + u * THREADS;
      const int r = i / VPR;
      raw[u] = make_uint4(0, 0, 0, 0);
      if (i < total && r < nvalid)
        raw[u] = load_px8(x + (ll)r * hw, p0 + (i % VPR) * 8, hw, vec);
    }
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
      const int i = i0 + u * THREADS;
      if (i >= total) break;
      const int r = i / VPR;
      const int c = (i % VPR) * 8;
      *reinterpret_cast<uint4*>(dst + r * ld + c) =
          BN && r < nvalid ? bn_relu8(raw[u], scale[r], shift[r]) : raw[u];
    }
  }
}

// ---------------------------------------------------------------------------
// wgmma (sm_90a) on operands in shared memory, no swizzle.
//
// Tiles live in "core" order: a tile of R rows whose contiguous dimension
// is cut into c8 chunks of 8 elements (16 bytes) keeps chunk (row, j) at
// byte ((row / 8) * c8 + j) * 128 + (row % 8) * 16, so each 8 x 8 core
// matrix is 128 contiguous bytes.  With the rows along K (an MN-major
// operand: its M or N dimension is the contiguous one) the descriptor's
// stride byte offset (between cores along M/N) is 128 and its leading
// byte offset (between cores along K) is c8 * 128; with the rows along M
// or N (K-major) they swap.  Writers map eight neighbouring threads to the
// eight rows of one core, so their 16-byte stores hit distinct banks.
// ---------------------------------------------------------------------------

__device__ __forceinline__ int core_off(int row, int j, int c8) {
  return ((row >> 3) * c8 + j) * 64 + (row & 7) * 8;  // in elements
}

// the i-th 16-byte chunk of a ROWS x (8 * C8) tile in writer order
template <int C8>
__device__ __forceinline__ void core_chunk(int i, int& row, int& j) {
  row = (i / (8 * C8)) * 8 + (i & 7);
  j = (i >> 3) % C8;
}

// layout: 0 = no swizzle (core order), 1 = 128-byte swizzle (sw128_off)
__device__ __forceinline__ uint64_t gmma_desc(const void* smem, uint32_t lbo_bytes,
                                              uint32_t sbo_bytes, int layout = 0) {
  const uint64_t addr = smem_u32(smem);
  return ((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo_bytes >> 4) << 16) |
         ((uint64_t)(sbo_bytes >> 4) << 32) | ((uint64_t)layout << 62);
}

// An MN-major operand of 128 columns (pixels) in the 128-byte swizzled
// layout: 1024-byte atoms of 8 K-rows x 64 columns, atom (row / 8, col /
// 64) at ((row / 8) * 2 + col / 64) * 1024 bytes, 16-byte chunk c of an
// atom row at (c ^ row % 8) * 16.  Descriptor: leading byte offset 1024
// (the next 64 columns), stride byte offset 2048 (the next 8 rows); the
// tile must start 1024-byte aligned.  Sixteen threads writing one row's
// chunks hit distinct banks.
__device__ __forceinline__ int sw128_off(int row, int col) {  // in elements
  return ((row >> 3) * 2 + (col >> 6)) * 512 + (row & 7) * 64 +
         ((((col >> 3) & 7) ^ (row & 7)) << 3) + (col & 7);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// generic-proxy writes to shared memory (st.shared, cp.async) made visible
// to the async proxy that wgmma reads through; then a barrier
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// D[64 x 128] (+)= A[64 x 16] . B[16 x 128], bf16 in, f32 sums, both operands
// in shared memory; TA / TB = 1: the operand is MN-major.  scale_d = 0
// overwrites D.  For lane (g = lane / 4, t = lane % 4) of warp w of the
// warpgroup, d[4i + e] is row 16w + g + 8 (e / 2), column 8i + 2t + e % 2.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t desc_a,
                                                 uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TA), "n"(TB));
}

// The ROWS x (8 * C8) tile at (r0, c0) of a row-major [R][Cg] bf16 matrix
// into a core-order tile, zeros outside; cp.async when vec (Cg % 8 == 0,
// g 16-byte aligned), else plain loads and stores.
template <int ROWS, int C8, int THREADS>
__device__ __forceinline__ void load_tile_core(u16* s, const u16* g, int R, int Cg,
                                               int r0, int c0, bool vec) {
  for (int i = threadIdx.x; i < ROWS * C8; i += THREADS) {
    int r, j;
    core_chunk<C8>(i, r, j);
    const int gr = r0 + r;
    const int gc = c0 + 8 * j;
    u16* d = s + core_off(r, j, C8);
    if (vec) {
      const bool ok = gr < R && gc < Cg;
      cp_async16(d, ok ? g + (ll)gr * Cg + gc : g, ok ? 16 : 0);
    } else {
      __align__(16) u16 v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        v[e] = (gr < R && gc + e < Cg) ? g[(ll)gr * Cg + gc + e] : (u16)0;
      *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(v);
    }
  }
}

// Register staging of an x tile of 128 pixels into a 128-byte swizzled
// tile (sw128_off).  Chunk i is row i / 16, pixels 8 (i % 16) .. +7: a
// warp reads two whole 256-byte rows.  load_chunks fetches a thread's
// chunks i0, i0 + THREADS, ... (LOADS of them, all in flight);
// store_chunks_bn writes them as T(relu(x * scale[row] + shift[row])),
// zeros for rows >= nvalid.
template <int THREADS, int LOADS>
__device__ __forceinline__ void load_chunks(uint4 (&raw)[LOADS], int i0, int total,
                                            const u16* x, int hw, int nvalid, int p0,
                                            bool vec) {
#pragma unroll
  for (int u = 0; u < LOADS; ++u) {
    const int i = i0 + u * THREADS;
    const int r = i / 16;
    raw[u] = make_uint4(0, 0, 0, 0);
    if (i < total && r < nvalid)
      raw[u] = load_px8(x + (ll)r * hw, p0 + 8 * (i % 16), hw, vec);
  }
}

template <int THREADS, int LOADS>
__device__ __forceinline__ void store_chunks_bn(const uint4 (&raw)[LOADS], int i0,
                                                int total, u16* dst, int nvalid,
                                                const float* scale, const float* shift) {
#pragma unroll
  for (int u = 0; u < LOADS; ++u) {
    const int i = i0 + u * THREADS;
    if (i >= total) break;
    const int r = i / 16;
    *reinterpret_cast<uint4*>(dst + sw128_off(r, 8 * (i % 16))) =
        r < nvalid ? bn_relu8(raw[u], scale[r], shift[r]) : make_uint4(0, 0, 0, 0);
  }
}


// ---------------------------------------------------------------------------
// 3x3 dense layers on mma.sync: shared staging and tap addressing.
//
// A block owns a C3_TH x C3_TW tile of output pixels of one image and
// keeps its operands in shared memory as [halo pixel][channel] tiles: the
// (C3_TH + 2) x (C3_TW + 2) pixels around the tile, row-major, each pixel
// one row of channels (ld elements apart; ld = channels + 8, so a row is a
// multiple of 16 bytes and eight consecutive rows start in distinct
// 16-byte bank slots).  A tap is then a shift by whole rows: every
// ldmatrix row address stays 16-byte aligned whatever the tap, which a
// pixel-contiguous tile cannot give (one pixel is 2 bytes).  The tile is
// staged once with its halo (px_load, px_store below: the NCHW planes are
// transposed in registers) and read by all nine taps.
//
// Warp w of C3_WARPS owns the tile's pixel rows w, w + C3_WARPS, ...: one
// row of 16 pixels is one m16 (or, in the weight cotangent, one k16) step.
// Weights [rows][9][16] (tap = ky * 3 + kx, 16 outputs; growth 12 padded
// with four zero columns) are copied as they lie in device memory, one
// 288-byte row per channel, into rows C3_WLD elements apart (304 bytes:
// conflict-free for ldmatrix).
// ---------------------------------------------------------------------------

constexpr int C3_TH = 12;
constexpr int C3_TW = 16;
constexpr int C3_HW = C3_TW + 2;           // halo tile width
constexpr int C3_HPX = (C3_TH + 2) * C3_HW;  // halo pixels: 252
constexpr int C3_WARPS = 6;
constexpr int C3_THREADS = 32 * C3_WARPS;
constexpr int C3_MT = C3_TH / C3_WARPS;    // pixel rows per warp
constexpr int C3_N = 16;                   // a dense layer's outputs, padded
constexpr int C3_WROW = 9 * C3_N;          // one channel's weights
constexpr int C3_WLD = C3_WROW + 8;

__host__ __device__ __forceinline__ int c3_tiles_x(int W) {
  return (W + C3_TW - 1) / C3_TW;
}
__host__ __device__ __forceinline__ int c3_tiles(int H, int W) {
  return ((H + C3_TH - 1) / C3_TH) * c3_tiles_x(W);
}

// halo index of output pixel (y, x) of the tile read through tap (ky, kx)
// of a correlation (the forward and the weight cotangent) ...
__device__ __forceinline__ int c3_tap(int y, int x, int ky, int kx) {
  return (y + ky) * C3_HW + x + kx;
}
// ... and of the transposed correlation (the input cotangent)
__device__ __forceinline__ int c3_tap_t(int y, int x, int ky, int kx) {
  return (y + 2 - ky) * C3_HW + x + 2 - kx;
}

// Staging of channels [0, 8 * groups) of an image's plane stack x (channel
// c at x + c * hw) over the halo tile at (ty0, tx0) into dst[halo pixel]
// [channel] (ld elements a row).  An item is one aligned pixel pair of a
// halo row (C3_PAIRS of them cover the 18 pixels, from tx0 - 2 on) and
// eight channels: one 4-byte load per channel where the planes allow it
// (`pair`: W even and x 4-byte aligned), two 2-byte loads otherwise, and
// one 16-byte shared-memory store per pixel.  Lanes run along a row's
// pairs.  px_load puts a thread's items first + threadIdx.x + r * THREADS
// (r < ROUNDS) in flight; px_store writes them: BN = true as T(relu(x *
// scale[c] + shift[c])), else x as it is; RAW = true also keeps x itself in
// raw (same layout).  Pixels outside the image and channels >= nvalid are
// zero in both: the conv's zero padding applies to the activation, not to
// x.  Between the two calls a kernel can do other work.
constexpr int C3_PAIRS = C3_HW / 2 + 1;
constexpr int C3_ITEMS = (C3_TH + 2) * C3_PAIRS;  // per 8-channel group

__host__ __forceinline__ bool c3_pair_loads(int W, ll bstride, const void* base) {
  return W % 2 == 0 && bstride % 2 == 0 && (reinterpret_cast<uintptr_t>(base) & 3) == 0;
}

struct C3Item {
  int cg, hy, j;
  bool okA, okB;  // the pair's pixels lie in the image
  __device__ __forceinline__ C3Item(int i, int total, int H, int W, int ty0, int tx0) {
    cg = i / C3_ITEMS;
    const int p = i - cg * C3_ITEMS;
    hy = p / C3_PAIRS;
    j = p - hy * C3_PAIRS;
    const int gy = ty0 - 1 + hy;
    const int gx = tx0 - 2 + 2 * j;
    const bool row = i < total && gy >= 0 && gy < H;
    okA = row && gx >= 0 && gx < W;
    okB = row && gx + 1 >= 0 && gx + 1 < W;
  }
};

template <int ROUNDS, int THREADS>
__device__ __forceinline__ void px_load(uint32_t (&raw)[ROUNDS][8], int first, int total,
                                        const u16* x, int hw, int H, int W, int ty0,
                                        int tx0, int nvalid, bool pair) {
#pragma unroll
  for (int r = 0; r < ROUNDS; ++r) {
    const C3Item it(first + threadIdx.x + r * THREADS, total, H, W, ty0, tx0);
    const u16* src = x + (ll)(8 * it.cg) * hw + (ty0 - 1 + it.hy) * W + tx0 - 2 + 2 * it.j;
    if (pair) {  // okA and okB agree: W is even and the pair starts on an even column
#pragma unroll
      for (int e = 0; e < 8; ++e)
        raw[r][e] = (it.okA && 8 * it.cg + e < nvalid)
                        ? __ldg(reinterpret_cast<const uint32_t*>(src + (ll)e * hw)) : 0u;
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const bool ch = 8 * it.cg + e < nvalid;
        const uint32_t a = (it.okA && ch) ? __ldg(src + (ll)e * hw) : 0u;
        const uint32_t b = (it.okB && ch) ? __ldg(src + (ll)e * hw + 1) : 0u;
        raw[r][e] = a | (b << 16);
      }
    }
  }
}

// one pixel's eight channels from eight channel pairs: SEL 0x5410 takes the
// low halves (the pair's first pixel), 0x7632 the high halves
template <uint32_t SEL>
__device__ __forceinline__ uint4 c3_gather(const uint32_t (&v)[8]) {
  return make_uint4(__byte_perm(v[0], v[1], SEL), __byte_perm(v[2], v[3], SEL),
                    __byte_perm(v[4], v[5], SEL), __byte_perm(v[6], v[7], SEL));
}

template <bool BN, bool RAW, int ROUNDS, int THREADS>
__device__ __forceinline__ void px_store(const uint32_t (&raw)[ROUNDS][8], int first,
                                         int total, u16* dst, u16* rawdst, int ld, int H,
                                         int W, int ty0, int tx0, int nvalid,
                                         const float* scale, const float* shift) {
#pragma unroll
  for (int r = 0; r < ROUNDS; ++r) {
    const int i = first + threadIdx.x + r * THREADS;
    if (i >= total) break;
    const C3Item it(i, total, H, W, ty0, tx0);
    const int pa = (it.hy * C3_HW + 2 * it.j - 1) * ld + 8 * it.cg;  // first pixel
    const bool stA = it.j >= 1;             // halo columns 2j - 1 and 2j: the
    const bool stB = it.j < C3_PAIRS - 1;   // outermost two are not the halo's
    uint32_t v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = raw[r][e];
    if (RAW) {
      if (stA) *reinterpret_cast<uint4*>(rawdst + pa) = c3_gather<0x5410>(v);
      if (stB) *reinterpret_cast<uint4*>(rawdst + pa + ld) = c3_gather<0x7632>(v);
    }
    if (BN) {
      // a is 0 outside the image and past the last channel, not relu(shift)
      const uint32_t keep = (it.okA ? 0x0000ffffu : 0u) | (it.okB ? 0xffff0000u : 0u);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int c = min(8 * it.cg + e, nvalid - 1);
        const float sc = __ldg(scale + c);
        const float sh = __ldg(shift + c);
        v[e] = pack_bf16x2_relu(__fadd_rn(__fmul_rn(lo_f(v[e]), sc), sh),
                                __fadd_rn(__fmul_rn(hi_f(v[e]), sc), sh)) &
               (8 * it.cg + e < nvalid ? keep : 0u);
      }
    }
    if (stA) *reinterpret_cast<uint4*>(dst + pa) = c3_gather<0x5410>(v);
    if (stB) *reinterpret_cast<uint4*>(dst + pa + ld) = c3_gather<0x7632>(v);
  }
}

// px_load and px_store back to back over all of the tile's items, ROUNDS
// rounds (16 or 24 loads a thread) in flight at a time
template <bool BN, bool RAW, int ROUNDS, int THREADS>
__device__ __forceinline__ void stage_px_tile(u16* dst, u16* rawdst, int ld, int groups,
                                              const u16* x, int hw, int H, int W,
                                              int ty0, int tx0, int nvalid,
                                              const float* scale, const float* shift,
                                              bool pair) {
  const int total = groups * C3_ITEMS;
  for (int first = 0; first < total; first += ROUNDS * THREADS) {
    uint32_t raw[ROUNDS][8];
    px_load<ROUNDS, THREADS>(raw, first, total, x, hw, H, W, ty0, tx0, nvalid, pair);
    px_store<BN, RAW, ROUNDS, THREADS>(raw, first, total, dst, rawdst, ld, H, W, ty0, tx0,
                                       nvalid, scale, shift);
  }
}

// Copies weight rows [r0, r0 + rows) of a [R][9][16] bf16 matrix (16-byte
// aligned; a growth-12 layer's with zero columns 12-15) into dst rows
// C3_WLD apart with cp.async; rows >= R are zero.
// The caller commits and waits.
template <int THREADS>
__device__ __forceinline__ void load_w3_rows(u16* dst, const u16* wt, int R, int r0,
                                             int rows) {
  constexpr int PIECES = C3_WROW / 8;  // 18 16-byte pieces a row
  for (int i = threadIdx.x; i < rows * PIECES; i += THREADS) {
    const int r = i / PIECES;
    const int j = i - r * PIECES;
    const bool ok = r0 + r < R;
    cp_async16(dst + r * C3_WLD + 8 * j, ok ? wt + (ll)(r0 + r) * C3_WROW + 8 * j : wt,
               ok ? 16 : 0);
  }
}

// A lane's ldmatrix.x4 coordinates: it addresses row r8 of matrix j0 + 2 j1
// (j0, j1: the matrix's two bits), and holds row g, columns 2t and 2t + 1
// of every matrix.  Following the layouts at the head of this file, an
// operand with k contiguous puts (j0, j1) on (row, column) blocks of 8 for
// A and on (column, row) for B; read with .trans, the other way round.
struct C3Lane {
  int r8, j0, j1, g, t;
  __device__ __forceinline__ explicit C3Lane(int lane)
      : r8(lane % 8), j0((lane >> 3) & 1), j1(lane >> 4), g(lane / 4), t(lane % 4) {}
};

}  // namespace s2r_mma
