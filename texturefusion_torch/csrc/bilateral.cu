// (2r+1)^2 edge-preserving depth bilateral filter for Hopper (sm_90a).
//
// Replaces the TPU kernel texturefusion_tpu/ops/pallas_kernels.py
// `bilateral_filter_pallas` (body `_bilateral_kernel`), and follows its
// semantics exactly: out = sum(w*d) / sum(w) over the (2r+1)^2 window,
// w = w_space(dy, dx) * exp(-(d - d_c)^2 / (2 sigma_range^2)); invalid (0)
// taps and taps outside the image weigh 0; an invalid centre, or a window
// whose weights sum to <= 1e-12, gives 0. Taps are accumulated dy-major,
// dx-minor, as the Pallas kernel accumulates them.
//
// What bounds it on the H100: arithmetic. A 480x640 frame at r = 4 is
// 24.9 M taps of ~10 operations (subtract, square, scale, exp, spatial
// product, validity test and select, multiply-add counted as 2, add):
// ~0.25 GFLOP, 3.7 us at the 67 TFLOP/s fp32 peak, against 2.5 MB of
// device memory (0.7 us at 3.35 TB/s); H100 SXM data-sheet rates, 700 W
// power limit. What binds in practice is the exp unit, not the FP32 pipe:
// one exp a tap, and MUFU.EX2 completes 16 a clock per SM against the FP32
// pipe's 128, so 24.9 M exps take 24.9 M / (132 SMs * 16 * 1.98 GHz) =
// 6.0 us, while the tap's 5 FP32 instructions take 3.7 us to dispatch.
//
// Design:
//  - The radius is a template parameter (instantiated for 0..8), so the
//    taps unroll and each spatial weight is an immediate operand from the
//    kernel's parameter block (constant bank); the weights are computed
//    in float64 on the host and rounded once, as the TPU kernel does.
//  - The range weight is the exp unit's ex2.approx of a pre-scaled
//    difference: exp(-diff^2 / (2 sr^2)) = exp2(-(s*diff)^2) with
//    s = sqrt(log2(e) / (2 sr^2)), so depths are staged times s, a tap is
//    subtract, square, exp2, spatial product, multiply-add, add, and the
//    sum is divided by s once at the end. Fused multiply-adds are allowed
//    (this file is compiled without -fmad=false). Error against the plain
//    version: ~2e-6 m.
//  - A block of 32x8 threads computes a 32x16 tile: each thread owns 2
//    vertically adjacent pixels of one column. The tile plus its radius
//    halo is staged in shared memory, and each thread walks the 2 + 2r
//    tile rows its pixels touch, loading each row's 2r+1 taps into
//    registers once and applying them to each of its pixels whose window
//    holds that row. Each pixel still sees its rows in order, so the sum
//    stays dy-major, dx-minor. Two pixels a thread rather than 4 or 8:
//    the kernel is short of warps to hide the exp's latency, not of
//    shared-memory bandwidth, so more threads beat more reuse.
//  - Taps that weigh 0 (invalid depth, outside the image) are staged as
//    kVoid = 1e18: exp2(-(kVoid - s*d)^2) is exactly 0, and the tap adds
//    exactly 0 to both sums, so the loop has no branch and no select.
//    Depths that are not > 0 (NaN included) or that reach 1e18/s are
//    invalid; the plain version would carry a NaN into its sums.
//  - 32x16 tiles give 600 blocks at VGA, 4.5 per SM, all resident at once.

#include <cuda_runtime.h>

namespace {

constexpr int kBlockX = 32;            // threads across = tile width
constexpr int kBlockY = 8;             // threads down
constexpr int kPix = 2;                // vertically adjacent pixels a thread
constexpr int kTileH = kBlockY * kPix;
constexpr int kMaxRadius = 8;
constexpr float kVoid = 1e18f;

template <int R>
struct SpatialWeights {
  float w[(2 * R + 1) * (2 * R + 1)];
};

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int R>
__global__ void __launch_bounds__(kBlockX * kBlockY)
bilateral_kernel(const float* __restrict__ depth, float* __restrict__ out, int height,
                 int width, float scale, const SpatialWeights<R> ws) {
  constexpr int kTaps = 2 * R + 1;
  constexpr int kTileW = kBlockX + 2 * R;
  constexpr int kRows = kTileH + 2 * R;
  __shared__ float tile[kRows][kTileW];

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int x0 = blockIdx.x * kBlockX, y0 = blockIdx.y * kTileH;
  for (int i = ty * kBlockX + tx; i < kRows * kTileW; i += kBlockX * kBlockY) {
    const int ly = i / kTileW, lx = i % kTileW;
    const int gy = y0 + ly - R, gx = x0 + lx - R;
    float v = kVoid;
    if (gy >= 0 && gy < height && gx >= 0 && gx < width) {
      const float d = depth[gy * width + gx];
      v = d > 0.0f ? d * scale : kVoid;
    }
    tile[ly][lx] = v;
  }
  __syncthreads();

  const int py = ty * kPix;            // this thread's first pixel row in the tile
  float c[kPix], acc[kPix], wacc[kPix];
#pragma unroll
  for (int p = 0; p < kPix; ++p) {
    c[p] = tile[py + p + R][tx + R];
    acc[p] = 0.0f;
    wacc[p] = 0.0f;
  }
  // tile row py + r is window row dy = r - p (0..2R) of pixel p
#pragma unroll
  for (int r = 0; r < kPix + 2 * R; ++r) {
    float nb[kTaps];
#pragma unroll
    for (int dx = 0; dx < kTaps; ++dx) nb[dx] = tile[py + r][tx + dx];
#pragma unroll
    for (int p = 0; p < kPix; ++p) {
      const int dy = r - p;
      if (dy < 0 || dy >= kTaps) continue;   // resolved at compile time
#pragma unroll
      for (int dx = 0; dx < kTaps; ++dx) {
        const float diff = nb[dx] - c[p];
        const float wgt = ws.w[dy * kTaps + dx] * ex2_approx(-(diff * diff));
        acc[p] = fmaf(wgt, nb[dx], acc[p]);
        wacc[p] += wgt;
      }
    }
  }

  const int x = x0 + tx;
  if (x >= width) return;
#pragma unroll
  for (int p = 0; p < kPix; ++p) {
    const int y = y0 + py + p;
    if (y < height) {
      const bool ok = c[p] < kVoid && wacc[p] > 1e-12f;
      out[y * width + x] = ok ? acc[p] / (fmaxf(wacc[p], 1e-12f) * scale) : 0.0f;
    }
  }
}

template <int R>
cudaError_t launch(const float* depth, float* out, const float* w_space, int height,
                   int width, float scale, cudaStream_t stream) {
  SpatialWeights<R> ws;
  for (int i = 0; i < (2 * R + 1) * (2 * R + 1); ++i) ws.w[i] = w_space[i];
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((width + kBlockX - 1) / kBlockX, (height + kTileH - 1) / kTileH);
  bilateral_kernel<R><<<grid, block, 0, stream>>>(depth, out, height, width, scale, ws);
  return cudaGetLastError();
}

}  // namespace

// w_space: host pointer to the (2r+1)^2 spatial weights, dy-major.
extern "C" int tf_bilateral_launch(const float* depth, float* out, const float* w_space,
                                   int height, int width, int radius, float scale,
                                   void* stream) {
  if (height <= 0 || width <= 0) return (int)cudaSuccess;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (radius) {
    case 0: return (int)launch<0>(depth, out, w_space, height, width, scale, s);
    case 1: return (int)launch<1>(depth, out, w_space, height, width, scale, s);
    case 2: return (int)launch<2>(depth, out, w_space, height, width, scale, s);
    case 3: return (int)launch<3>(depth, out, w_space, height, width, scale, s);
    case 4: return (int)launch<4>(depth, out, w_space, height, width, scale, s);
    case 5: return (int)launch<5>(depth, out, w_space, height, width, scale, s);
    case 6: return (int)launch<6>(depth, out, w_space, height, width, scale, s);
    case 7: return (int)launch<7>(depth, out, w_space, height, width, scale, s);
    case 8: return (int)launch<8>(depth, out, w_space, height, width, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
  static_assert(kMaxRadius == 8, "instantiate every radius up to kMaxRadius");
}
