// Label extraction from (original, annotated) frame pairs, for NVIDIA
// Hopper (sm_90a).
//
// Replaces the TPU kernel K5 of the JAX package:
//   sim2real_lane_segment_tpu/ops/labelgen_pallas.py
//   _kernel, launched by process_classes_fused (pallas_call at :107).
//
// What it computes, the whole of ops/labelgen.process_classes per pixel of
// a uint8 (N, H, W, 3) pair:
//   1. the difference annot - orig per channel (in int, as the int16 diff);
//   2. the channel-sign rules on (b, g, r) in BGR or RGB order:
//      right = g > 0, left = b > 0,
//      obstacle = r > 0 or (r >= 0 and (b < 0 or g < 0));
//   3. per class, a 5x5 OPEN then CLOSE: erode, dilate, dilate, erode,
//      each with cv2's border (erosion pads 1, dilation pads 0);
//   4. priority: right = 1, then left = 2, then obstacle = 3 wins.
// The output is bit-exact against the plain version.
//
// What bounds it: it must read 6 bytes and write 1 per pixel; the
// morphology is a few hundred byte operations per pixel in shared memory,
// so at 480x640 it is bound by bytes (7 per pixel at 3.35 TB/s), and at
// small frames by launch latency.
//
// What the design does about it: one launch for the whole batch, one
// block per 32x32 output tile of one image.  The block reads its tile
// with an 8-pixel halo (4 passes of radius 2) once from device memory,
// packs the three class masks into three bits of one byte, and runs all
// four passes in shared memory, each as a row pass then a column pass
// (a rect window is separable), AND for erosion and OR for dilation.
// Border semantics: a neighbour outside the image is the pass's pad value
// at every pass (1 for erosion, 0 for dilation), which is the identity of
// AND and OR, so each pass skips it; values computed in the halo outside
// the image are never read.  Each pass shrinks the valid margin by 2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int T = 32;              // output tile
constexpr int HALO = 8;            // 4 passes x radius 2
constexpr int R = T + 2 * HALO;    // staged region
constexpr int THREADS = 256;

template <bool ERODE>
__device__ __forceinline__ void morph_pass(uint8_t (*a)[R], uint8_t (*tmp)[R],
                                           int m_in, int gy0, int gx0, int H,
                                           int W) {
  const int m_out = m_in - 2;
  const uint8_t ident = ERODE ? 7 : 0;
  // rows over the input's valid margin, columns over the output's
  const int r_lo = HALO - m_in, r_n = T + 2 * m_in;
  const int c_lo = HALO - m_out, c_n = T + 2 * m_out;
  for (int i = threadIdx.x; i < r_n * c_n; i += THREADS) {
    const int ry = r_lo + i / c_n;
    const int rx = c_lo + i % c_n;
    uint8_t v = ident;
#pragma unroll
    for (int d = -2; d <= 2; ++d) {
      const int gx = gx0 + rx + d;
      if (gx >= 0 && gx < W) v = ERODE ? (v & a[ry][rx + d]) : (v | a[ry][rx + d]);
    }
    tmp[ry][rx] = v;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < c_n * c_n; i += THREADS) {
    const int ry = c_lo + i / c_n;
    const int rx = c_lo + i % c_n;
    uint8_t v = ident;
#pragma unroll
    for (int d = -2; d <= 2; ++d) {
      const int gy = gy0 + ry + d;
      if (gy >= 0 && gy < H) v = ERODE ? (v & tmp[ry + d][rx]) : (v | tmp[ry + d][rx]);
    }
    a[ry][rx] = v;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(THREADS)
labelgen_kernel(const uint8_t* __restrict__ orig,
                const uint8_t* __restrict__ annot, int H, int W, int bgr,
                uint8_t* __restrict__ out) {
  __shared__ uint8_t s_a[R][R];
  __shared__ uint8_t s_t[R][R];
  const int gy0 = blockIdx.y * T - HALO;   // image row of region row 0
  const int gx0 = blockIdx.x * T - HALO;
  const long long img = (long long)blockIdx.z * H * W;

  for (int i = threadIdx.x; i < R * R; i += THREADS) {
    const int ry = i / R;
    const int rx = i - ry * R;
    const int gy = gy0 + ry;
    const int gx = gx0 + rx;
    uint8_t v = 0;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
      const long long px = (img + (long long)gy * W + gx) * 3;
      const int d0 = (int)annot[px] - (int)orig[px];
      const int d1 = (int)annot[px + 1] - (int)orig[px + 1];
      const int d2 = (int)annot[px + 2] - (int)orig[px + 2];
      const int b = bgr ? d0 : d2;
      const int g = d1;
      const int r = bgr ? d2 : d0;
      const bool right = g > 0;
      const bool left = b > 0;
      const bool obstacle = r > 0 || (r >= 0 && (b < 0 || g < 0));
      v = (uint8_t)(right | (left << 1) | (obstacle << 2));
    }
    s_a[ry][rx] = v;
  }
  __syncthreads();

  morph_pass<true>(s_a, s_t, 8, gy0, gx0, H, W);    // OPEN: erode,
  morph_pass<false>(s_a, s_t, 6, gy0, gx0, H, W);   //       dilate
  morph_pass<false>(s_a, s_t, 4, gy0, gx0, H, W);   // CLOSE: dilate,
  morph_pass<true>(s_a, s_t, 2, gy0, gx0, H, W);    //        erode

  for (int i = threadIdx.x; i < T * T; i += THREADS) {
    const int ty = i / T;
    const int tx = i - ty * T;
    const int gy = gy0 + HALO + ty;
    const int gx = gx0 + HALO + tx;
    if (gy >= H || gx >= W) continue;
    const uint8_t v = s_a[HALO + ty][HALO + tx];
    out[img + (long long)gy * W + gx] =
        (v & 4) ? 3 : (v & 2) ? 2 : (v & 1) ? 1 : 0;
  }
}

}  // namespace

// Plain C interface, bound with ctypes.  orig, annot: uint8 (N, H, W, 3);
// out: uint8 (N, H, W); bgr: 1 for BGR channel order, 0 for RGB.  Returns
// the cudaError_t of the launch (0 on success).
extern "C" int s2r_labelgen(const uint8_t* orig, const uint8_t* annot, int N,
                            int H, int W, int bgr, uint8_t* out,
                            void* stream) {
  if (N <= 0 || H <= 0 || W <= 0) return cudaErrorInvalidValue;
  const dim3 grid((W + T - 1) / T, (H + T - 1) / T, N);
  labelgen_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      orig, annot, H, W, bgr, out);
  return cudaGetLastError();
}

extern "C" const char* s2r_labelgen_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
