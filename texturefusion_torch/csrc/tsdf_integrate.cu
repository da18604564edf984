// In-place TSDF voxel update over a list of chunk slots, for Hopper (sm_90a).
//
// Replaces the TPU kernel examples/pallas_voxel_kernel.py
// `integrate_rows_pallas` (body `_voxel_kernel`, sampling `_sample_planes`)
// and computes what texturefusion_tpu/ops/tsdf.py `integrate_chunks`
// computes (ref: open_chisel ProjectionIntegrator.cpp:67-426
// voxelUpdateSIMD): each of the 512 voxel centroids of a listed 8^3 chunk
// is projected into the frame; depth, rgb*255 and quality are read at the
// rounded pixel (strict interior only); the signed-weight running average
// updates inside the band (-0.03, trunc + res*sqrt3), where trunc is the
// quadratic truncation at the chunk origin's camera depth; a voxel whose
// weight falls to <= min_weight resets to (999, 0). In the colour band
// |dist| < res*sqrt3/2 + pad the colour accumulators and count update, and
// on integrate (sign > 0) they are divided by 4 once any channel passes the
// saturation level. Per chunk it returns the summed quality of the
// colour-updated voxels (replaced by -1e11 when the chunk projects
// partially outside the image or lies partly behind the camera) and
// whether any voxel updated. with_color = 0 is the depth-only variant.
//
// What bounds it on the H100: device memory and the image gather. A chunk
// row is 512 x 6 floats = 12 KB read and written once per integrate; the
// per-voxel image read is data dependent. The TPU kernel had no wide
// gather (Mosaic's gather is vreg-local) and sampled through one-hot MXU
// products over a 32-256-row window, clamping chunks nearer than the
// window covers. Here the gather is direct: the 5-channel [H, W, 5] frame
// (6 MB at VGA) stays in the 50 MB L2 while the chunk rows stream through,
// and there is no window and no near-chunk clamp. Design: one block of 512
// threads per listed slot, one thread per voxel, so every row access is
// coalesced; the per-chunk quality sum is a warp-shuffle + shared-memory
// reduction and the partial / behind / updated flags are
// __syncthreads_or. Blocks of inactive (padding) lanes return before
// touching any row: all padding lanes name the same trash row.
//
// Arithmetic follows the plain PyTorch version
// (texturefusion_torch/ops/tsdf.py integrate_chunks) operation for
// operation, and the library is built with -fmad=false, so no product is
// fused into an add: a rounding difference in the projection would move a
// voxel across a pixel boundary and sample another depth.

#include <cstdint>
#include <cuda_runtime.h>

// Scalars of one launch; mirrored by TsdfParams in ops/cuda_kernels.py.
struct TsdfParams {
  float fx, fy, cx, cy;
  int width, height;
  float near_plane, far_plane;
  float trunc_quad, trunc_linear, trunc_const, trunc_scale;
  float res_diag;    // voxel_resolution * sqrt(3)
  float color_band;  // res_diag / 2 + color_band_pad
  float integration_weight, min_weight, color_saturation;
  float sign;        // +1 integrate, -1 de-integrate
  int with_color;
  int n_rows;        // capacity + 1 (trash row included)
};

namespace {

constexpr int kVoxels = 512;  // 8^3, x-fastest
constexpr float kResetSdf = 999.0f;


__global__ void __launch_bounds__(kVoxels)
tsdf_integrate_kernel(float* __restrict__ sdf, float* __restrict__ weight,
                      float* __restrict__ color, float* __restrict__ ccnt,
                      const int64_t* __restrict__ idx,
                      const uint8_t* __restrict__ active,
                      const float* __restrict__ origins,
                      const float* __restrict__ image,
                      const float* __restrict__ centroids,
                      const float* __restrict__ w2c,
                      float* __restrict__ quality_out,
                      uint8_t* __restrict__ updated_out, TsdfParams p) {
  const int lane = blockIdx.x;
  const int v = threadIdx.x;
  const int64_t slot = idx[lane];
  if (!active[lane] || slot < 0 || slot >= p.n_rows) {
    if (v == 0) {
      quality_out[lane] = 0.0f;
      updated_out[lane] = 0;
    }
    return;  // block-uniform: no __syncthreads below is skipped by a subset
  }

  const float ox = origins[lane * 3 + 0];
  const float oy = origins[lane * 3 + 1];
  const float oz = origins[lane * 3 + 2];
  const float wx = ox + centroids[v * 3 + 0];
  const float wy = oy + centroids[v * 3 + 1];
  const float wz = oz + centroids[v * 3 + 2];
  // world -> camera: (r0*x + r1*y + r2*z) + t, in this order
  const float cx_ = w2c[0] * wx + w2c[1] * wy + w2c[2] * wz + w2c[3];
  const float cy_ = w2c[4] * wx + w2c[5] * wy + w2c[6] * wz + w2c[7];
  const float z = w2c[8] * wx + w2c[9] * wy + w2c[10] * wz + w2c[11];

  const float safe_z = fabsf(z) > 1e-9f ? z : 1e-9f;
  const float ur = rintf(p.fx * cx_ / safe_z + p.cx);  // half to even
  const float vr = rintf(p.fy * cy_ / safe_z + p.cy);
  const bool in_img = ur > 0.0f && ur < (float)(p.width - 1) && vr > 0.0f &&
                      vr < (float)(p.height - 1) && z > 0.0f;

  float g[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (in_img) {
    const float* px = image + ((int64_t)vr * p.width + (int64_t)ur) * 5;
    g[0] = px[0];
    if (p.with_color) {
      g[1] = px[1];
      g[2] = px[2];
      g[3] = px[3];
      g[4] = px[4];
    }
  }
  const float d = g[0];
  const float surface_dist = d - z;

  const float oz_cam = w2c[8] * ox + w2c[9] * oy + w2c[10] * oz + w2c[11];
  const float trunc =
      fabsf(p.trunc_quad * oz_cam * oz_cam + p.trunc_linear * oz_cam +
            p.trunc_const) * p.trunc_scale;

  const bool depth_ok = d > p.near_plane && d < p.far_plane;
  const bool band = surface_dist > -0.03f && surface_dist < trunc + p.res_diag;
  const bool upd = in_img && depth_ok && band;

  const int64_t row = slot * kVoxels + v;
  if (upd) {
    const float w_old = weight[row];
    const float s_old = sdf[row];
    const float w_in = p.integration_weight * p.sign;
    float new_w = w_old + w_in;
    float new_sdf = (s_old * w_old + surface_dist * w_in) / (new_w + 1e-4f);
    if (new_w <= p.min_weight) {
      new_sdf = kResetSdf;
      new_w = 0.0f;
    }
    sdf[row] = new_sdf;
    weight[row] = new_w;
  }

  float qv = 0.0f;
  if (p.with_color) {
    const bool cupd = in_img && depth_ok && fabsf(surface_dist) < p.color_band;
    if (cupd) {
      float r = color[row * 3 + 0] + g[1] * p.sign;
      float gg = color[row * 3 + 1] + g[2] * p.sign;
      float b = color[row * 3 + 2] + g[3] * p.sign;
      float cnt = ccnt[row] + p.sign;
      if (fmaxf(r, fmaxf(gg, b)) > p.color_saturation && p.sign > 0.0f) {
        r *= 0.25f;
        gg *= 0.25f;
        b *= 0.25f;
        cnt *= 0.25f;
      }
      color[row * 3 + 0] = r;
      color[row * 3 + 1] = gg;
      color[row * 3 + 2] = b;
      ccnt[row] = cnt;
      qv = g[4];
    }
  }

  // per-chunk reductions: flags through __syncthreads_or, the quality sum
  // through warp shuffles and one shared-memory pass
  const int any_upd = __syncthreads_or(upd);
  const int partial = __syncthreads_or(!in_img && z > 0.0f);
  const int behind = __syncthreads_or(z <= 0.0f);
  __shared__ float warp_sums[kVoxels / 32];
  for (int off = 16; off > 0; off >>= 1) qv += __shfl_down_sync(0xffffffffu, qv, off);
  if ((v & 31) == 0) warp_sums[v >> 5] = qv;
  __syncthreads();
  if (v < 32) {
    float s = v < kVoxels / 32 ? warp_sums[v] : 0.0f;
    for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
    if (v == 0) {
      float q = 0.0f;
      if (p.with_color) q = (partial || behind) ? -1e11f : s;
      quality_out[lane] = q;
      updated_out[lane] = any_upd ? 1 : 0;
    }
  }
}

}  // namespace

extern "C" int tf_tsdf_integrate_launch(
    float* sdf, float* weight, float* color, float* ccnt, const int64_t* idx,
    const uint8_t* active, const float* origins, const float* image,
    const float* centroids, const float* w2c, float* quality_out,
    uint8_t* updated_out, const TsdfParams* params, int n_lanes, void* stream) {
  if (n_lanes <= 0) return (int)cudaSuccess;
  tsdf_integrate_kernel<<<n_lanes, kVoxels, 0, (cudaStream_t)stream>>>(
      sdf, weight, color, ccnt, idx, active, origins, image, centroids, w2c,
      quality_out, updated_out, *params);
  return (int)cudaGetLastError();
}
