// 9x9 edge-preserving depth bilateral filter for Hopper (sm_90a).
//
// Replaces the TPU kernel texturefusion_tpu/ops/pallas_kernels.py
// `bilateral_filter_pallas` (body `_bilateral_kernel`), and follows its
// semantics exactly: out = sum(w*d) / sum(w) over the (2r+1)^2 window,
// w = w_space(dy, dx) * exp(-(d - d_c)^2 / (2 sigma_range^2)); invalid (0)
// taps and taps outside the image weigh 0; an invalid centre, or a window
// whose weights sum to <= 1e-12, gives 0. Taps are accumulated dy-major,
// dx-minor, as the Pallas kernel accumulates them.
//
// What bounds it on the H100: arithmetic. Every pixel does 81 expf and
// ~10 other flops per tap (~1,000 flops a pixel) against 8 bytes of
// device memory traffic (a 480x640 frame is 1.2 MB in, 1.2 MB out), so
// the image reads are not the limit once each tap comes from shared
// memory. Design: one thread per output pixel; a 32x16 block stages its
// tile plus a radius halo in shared memory (zeros outside the image, so
// the "outside weighs 0" rule costs no branch), and the (2r+1)^2 spatial
// weights, computed once in float64 on the host as the TPU kernel does,
// sit in shared memory too. expf is the accurate libm version (no
// -use_fast_math), so the result stays within 1e-5 of the plain PyTorch
// version (texturefusion_torch/ops/preprocess.py bilateral_filter_plain).

#include <cuda_runtime.h>

namespace {

constexpr int kBlockX = 32;
constexpr int kBlockY = 16;
constexpr int kMaxRadius = 8;

__global__ void bilateral_kernel(const float* __restrict__ depth,
                                 float* __restrict__ out,
                                 const float* __restrict__ w_space,
                                 int height, int width, int radius,
                                 float inv_2sr) {
  constexpr int kTileX = kBlockX + 2 * kMaxRadius;
  constexpr int kTileY = kBlockY + 2 * kMaxRadius;
  __shared__ float tile[kTileY][kTileX];
  __shared__ float ws[(2 * kMaxRadius + 1) * (2 * kMaxRadius + 1)];

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int x0 = blockIdx.x * kBlockX, y0 = blockIdx.y * kBlockY;
  const int tile_w = kBlockX + 2 * radius, tile_h = kBlockY + 2 * radius;
  const int n_taps = (2 * radius + 1) * (2 * radius + 1);
  const int tid = ty * kBlockX + tx;

  for (int i = tid; i < n_taps; i += kBlockX * kBlockY) ws[i] = w_space[i];
  for (int i = tid; i < tile_w * tile_h; i += kBlockX * kBlockY) {
    const int ly = i / tile_w, lx = i % tile_w;
    const int gy = y0 + ly - radius, gx = x0 + lx - radius;
    tile[ly][lx] = (gy >= 0 && gy < height && gx >= 0 && gx < width)
                       ? depth[gy * width + gx] : 0.0f;
  }
  __syncthreads();

  const int x = x0 + tx, y = y0 + ty;
  if (x >= width || y >= height) return;
  const float center = tile[ty + radius][tx + radius];
  float acc = 0.0f, wacc = 0.0f;
  int k = 0;
  for (int dy = -radius; dy <= radius; ++dy) {
    for (int dx = -radius; dx <= radius; ++dx, ++k) {
      const float nb = tile[ty + radius + dy][tx + radius + dx];
      const float diff = nb - center;
      const float wgt = nb > 0.0f ? ws[k] * expf(-(diff * diff) * inv_2sr) : 0.0f;
      acc = acc + wgt * nb;
      wacc = wacc + wgt;
    }
  }
  const float res = acc / fmaxf(wacc, 1e-12f);
  out[y * width + x] = (center > 0.0f && wacc > 1e-12f) ? res : 0.0f;
}

}  // namespace

extern "C" int tf_bilateral_launch(const float* depth, float* out,
                                   const float* w_space, int height, int width,
                                   int radius, float inv_2sr, void* stream) {
  if (radius < 0 || radius > kMaxRadius) return (int)cudaErrorInvalidValue;
  dim3 block(kBlockX, kBlockY);
  dim3 grid((width + kBlockX - 1) / kBlockX, (height + kBlockY - 1) / kBlockY);
  bilateral_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      depth, out, w_space, height, width, radius, inv_2sr);
  return (int)cudaGetLastError();
}
