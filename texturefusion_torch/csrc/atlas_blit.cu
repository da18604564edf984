// Atlas patch blits, batched, for Hopper (sm_90a): kernel K4.
//
// K4 has no Pallas counterpart: the JAX package blits each texture patch on
// the host (texturefusion_tpu/texture/atlas.py `add_or_update_patch`, a
// resize of the keyframe's bbox region into the patch's atlas slot), one
// call a chunk. The port's texture consume did the same with
// texturefusion_torch/texture/atlas.py `resize_bilinear`, about fifteen
// numpy calls a patch, for up to `patch_project_budget` patches a cycle
// (8,192 at 5 mm voxels), all on the fusion thread and under the
// interpreter lock. This kernel resizes every patch of a cycle in one
// launch into a staging buffer out [n, P, P, 3] uint8, which the host
// fetches in one copy and scatters into the atlas image.
//
// The arithmetic is resize_bilinear's, bit for bit (the file is built with
// -fmad=false, so no product is fused into a sum). Along each axis, for
// output index j of n_out and an ROI side of n_in pixels:
//   src = (j + 0.5) * (n_in / n_out) - 0.5         in float64,
//   src = min(max(src, 0), n_in - 1), i0 = floor(src), i1 = min(i0 + 1, n_in - 1),
//   w = (float)(src - i0);
// then in float32, with a..d the four taps' channel values:
//   top = a (1 - wx) + b wx, bot = c (1 - wx) + d wx,
//   v = floor(top (1 - wy) + bot wy + 0.5) clipped to [0, 255].
//
// The table, int64 [n, 5] a patch: the device address of its source image
// ([H, W, 3] uint8, contiguous; every source of a launch has the image
// width W) and its ROI x0, y0, x1, y1 (ends exclusive, 0 <= x0 < x1 <= W,
// 0 <= y0 < y1 <= H; the wrapper checks).
//
// Design: one thread an output pixel (its three channels), the threads of
// a patch consecutive, so a warp stores 96 contiguous bytes. Each thread
// recomputes its row's and column's taps (a few float64 operations) rather
// than staging them: the launch is small. What bounds it on the H100:
// bytes, the patches written (8,192 of 24 px: 14.2 MB, 4.2 us at
// 3.35 TB/s) and the source pixels the taps read; neither the float64 taps
// nor the float32 blend come near the card's rates. In the consume, the
// copy of the patches to the host and their scatter into the atlas cost
// more than the kernel.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct Taps {
  int i0, i1;
  float w;
};

__device__ inline Taps axis_taps(int j, int n_in, int n_out) {
  double src = ((double)j + 0.5) * ((double)n_in / (double)n_out) - 0.5;
  src = fmin(fmax(src, 0.0), (double)(n_in - 1));
  const double f = floor(src);
  Taps t;
  t.i0 = (int)f;
  t.i1 = min(t.i0 + 1, n_in - 1);
  t.w = (float)(src - f);
  return t;
}

__global__ void atlas_blit_kernel(const int64_t* __restrict__ table,
                                  uint8_t* __restrict__ out, int n, int size, int width) {
  const int64_t px = (int64_t)size * size;
  const int64_t gid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= (int64_t)n * px) return;
  const int patch = (int)(gid / px);
  const int pix = (int)(gid - (int64_t)patch * px);
  const int oy = pix / size, ox = pix - (pix / size) * size;

  const long long* e = reinterpret_cast<const long long*>(table) + (int64_t)patch * 5;
  const uint8_t* src = reinterpret_cast<const uint8_t*>((uintptr_t)__ldg(e));
  const int x0 = (int)__ldg(e + 1), y0 = (int)__ldg(e + 2);
  const int x1 = (int)__ldg(e + 3), y1 = (int)__ldg(e + 4);
  const Taps tx = axis_taps(ox, x1 - x0, size);
  const Taps ty = axis_taps(oy, y1 - y0, size);

  const int64_t row = (int64_t)width * 3;
  const uint8_t* r0 = src + (int64_t)(y0 + ty.i0) * row;
  const uint8_t* r1 = src + (int64_t)(y0 + ty.i1) * row;
  const int c0 = (x0 + tx.i0) * 3, c1 = (x0 + tx.i1) * 3;
  const float ux = 1.0f - tx.w, uy = 1.0f - ty.w;
  uint8_t* o = out + gid * 3;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float a = (float)__ldg(r0 + c0 + c), b = (float)__ldg(r0 + c1 + c);
    const float d0 = (float)__ldg(r1 + c0 + c), d1 = (float)__ldg(r1 + c1 + c);
    const float top = a * ux + b * tx.w;
    const float bot = d0 * ux + d1 * tx.w;
    const float v = floorf(top * uy + bot * ty.w + 0.5f);
    o[c] = (uint8_t)fminf(fmaxf(v, 0.0f), 255.0f);
  }
}

}  // namespace

extern "C" int tf_atlas_blit_launch(const int64_t* table, uint8_t* out, int n, int size,
                                    int width, void* stream) {
  if (n < 0 || size <= 0 || width <= 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const int64_t total = (int64_t)n * size * size;
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  atlas_blit_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(table, out, n,
                                                                             size, width);
  return (int)cudaGetLastError();
}
