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
// The TPU kernel's near-chunk clamp is not carried: there is no window.
//
// A second entry point, the F-frame mode (tf_tsdf_integrate_frames_launch),
// takes F depth-only frames, each with its pose and sign, and writes each
// chunk's sdf and weight rows once: the voxel sums the frames' signed
// weights and weighted distances in registers, counts as updated where any
// frame updated it, and resets after the last frame. A keyframe's local
// frames integrate in one launch, and drift reintegration of them in one
// more (-1 at the old poses, +1 at the new). F sequential depth-only
// launches would instead reset a voxel between frames and walk the rows F
// times. On the bench loop's pipeline its launches are F = 3 (local
// frames) and F = 6 (reintegration) over 133-491 chunks.
//
// What bounds the F-frame mode on the H100 at those shapes: instruction
// issue and one wave's balance, then the launch. Each voxel and frame
// runs ~80 instructions (two IEEE divisions among them), so at 1008
// chunks a frame costs about what the SMs can issue; at ~270 chunks one
// block a chunk puts 2 or 3 chunks on an SM, and the SMs with 3 set the
// time; a launch whose blocks all leave at once takes ~2 us. So its
// design (below, at tsdf_integrate_frames_kernel) takes the per-frame
// pose load and inverse out of the voxel loop and splits each chunk over
// two 128-thread blocks; issuing several frames' gathers before summing
// them bought nothing.
//
// What bounds it on the H100: latency. Counted at full rows (read and
// write sdf, weight, 3 colour floats and the count, 24 B a voxel, plus the
// 6.1 MB of depth, rgb and quality at VGA), 1008 chunks move ~31 MB, 9.2 us
// at 3.35 TB/s (H100 SXM data-sheet rate, 700 W power limit), and the
// ~240 chunks of a frame on the fusion path ~3.6 us. But only voxels
// inside the truncation band change, and only they need their rows: what
// a frame's data needs is a few MB (chip_smoke.py [k2] counts it), ~1 us.
// Each chunk instead waits on a chain of dependent loads: its slot, its
// origin, the depth at each voxel's pixel, then rgb and quality for the
// colour band; with ~60 flops a voxel, the arithmetic is small.
//
// Design:
//  - One launch per integrate takes the frame as the plain version does:
//    separate depth / rgb (0..1, scaled by 255 here) / quality planes,
//    the full origins table read by slot, and cam_to_world, inverted in
//    every thread with se3.inverse's arithmetic. The caller dispatches no
//    other device op (no packing, gather or inverse).
//  - One 128-thread block per listed lane, 4 voxels (x-adjacent) a
//    thread. The grid is the list's length: the caller lists the real
//    lanes only (the active flags, when given, still mark lanes to skip).
//    A frame's ~240 lanes fill the card's 132 SMs in one wave, and up to
//    16 blocks sit on an SM at once.
//  - Each thread issues its float4 sdf and weight loads as soon as it has
//    the slot, before the projection, so the rows are in flight while the
//    pose is inverted, the voxels projected and the depth gathered.
//  - The colour and count rows (8 KB a chunk) are read, as float4, only
//    by threads with a voxel inside the colour band, and the sdf and
//    weight rows are written back (coalesced float4) only where one of the
//    thread's 4 voxels changed.
//  - The voxel centroids' 8 distinct offsets sit in a shared table: an
//    index into the parameter block that is not a constant makes the
//    compiler copy the whole block to local memory.
//  - Flags and the quality sum are reduced by warp votes and shuffles and
//    one shared-memory pass.
//
// Arithmetic follows the plain PyTorch version
// (texturefusion_torch/ops/tsdf.py integrate_chunks) operation for
// operation, and this file is compiled with -fmad=false, so no product is
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
  float centroid[8]; // (k + 0.5) * voxel_resolution, rounded once from float64
};

constexpr int kMaxFrames = 64;             // frames of one F-frame launch

// Per-frame signs of the F-frame mode; mirrored by FrameSigns in
// ops/cuda_kernels.py.
struct FrameSigns {
  int n_frames;
  float sign[kMaxFrames];
};

namespace {

constexpr int kVoxels = 512;               // 8^3, x-fastest
constexpr int kThreads = 128;              // 4 voxels a thread
// F-frame mode: 2 voxels a thread, 2 blocks a chunk
constexpr int kFrameVoxels = 2;
constexpr int kFrameParts = 2;
constexpr int kFrameThreads = kVoxels / (kFrameVoxels * kFrameParts);
constexpr float kResetSdf = 999.0f;

__global__ void __launch_bounds__(kThreads)
tsdf_integrate_kernel(float* __restrict__ sdf, float* __restrict__ weight,
                      float* __restrict__ color, float* __restrict__ ccnt,
                      const int64_t* __restrict__ idx,
                      const uint8_t* __restrict__ active,   // may be null: all live
                      const float* __restrict__ origins,
                      const float* __restrict__ depth,
                      const float* __restrict__ rgb,
                      const float* __restrict__ qmap,
                      const float* __restrict__ c2w,
                      float* __restrict__ quality_out,
                      uint8_t* __restrict__ updated_out, const TsdfParams p) {
  __shared__ float warp_q[kThreads / 32];
  __shared__ int warp_flags[kThreads / 32];
  __shared__ float cent[8];   // indexed by voxel coordinate: a constant index of p only

  const int lane = blockIdx.x;
  const int t = threadIdx.x;
  const int64_t slot = idx[lane];
  const bool live = (active == nullptr || active[lane]) && slot >= 0 && slot < p.n_rows;
  if (!live) {                                   // block-uniform
    if (t == 0) {
      quality_out[lane] = 0.0f;
      updated_out[lane] = 0;
    }
    return;
  }
  const bool with_color = p.with_color != 0;

  // the rows first: nothing below decides whether they are needed
  const int64_t row4 = slot * (kVoxels / 4) + t;   // float4 index of voxel 4t
  const float4 s4 = reinterpret_cast<const float4*>(sdf)[row4];
  const float4 w4 = reinterpret_cast<const float4*>(weight)[row4];

  if (t == 0) {
#pragma unroll
    for (int i = 0; i < 8; ++i) cent[i] = p.centroid[i];
  }

  // world -> camera: se3.inverse(cam_to_world), Rt then -(Rt t) summed
  // x + y + z, each product rounded (no fused multiply-add in this file)
  float w2c[12];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    w2c[i * 4 + 0] = c2w[0 * 4 + i];
    w2c[i * 4 + 1] = c2w[1 * 4 + i];
    w2c[i * 4 + 2] = c2w[2 * 4 + i];
    w2c[i * 4 + 3] = -(c2w[0 * 4 + i] * c2w[3] + c2w[1 * 4 + i] * c2w[7] +
                       c2w[2 * 4 + i] * c2w[11]);
  }
  const float w_in = p.integration_weight * p.sign;
  const int v0 = 4 * t;                          // this thread's 4 voxels
  const float ox = origins[slot * 3 + 0];
  const float oy = origins[slot * 3 + 1];
  const float oz = origins[slot * 3 + 2];
  const float oz_cam = w2c[8] * ox + w2c[9] * oy + w2c[10] * oz + w2c[11];
  const float trunc = fabsf(p.trunc_quad * oz_cam * oz_cam + p.trunc_linear * oz_cam +
                            p.trunc_const) * p.trunc_scale;
  __syncthreads();                               // cent is filled
  const float wy = oy + cent[(v0 >> 3) & 7];
  const float wz = oz + cent[v0 >> 6];

  // project and gather depth for the 4 voxels
  float z[4], d[4];
  int pix[4];
  bool in_img[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float wx = ox + cent[(v0 + j) & 7];
    // (r0*x + r1*y + r2*z) + t, in this order
    const float xc = w2c[0] * wx + w2c[1] * wy + w2c[2] * wz + w2c[3];
    const float yc = w2c[4] * wx + w2c[5] * wy + w2c[6] * wz + w2c[7];
    z[j] = w2c[8] * wx + w2c[9] * wy + w2c[10] * wz + w2c[11];
    const float safe_z = fabsf(z[j]) > 1e-9f ? z[j] : 1e-9f;
    const float ur = rintf(p.fx * xc / safe_z + p.cx);  // half to even
    const float vr = rintf(p.fy * yc / safe_z + p.cy);
    in_img[j] = ur > 0.0f && ur < (float)(p.width - 1) && vr > 0.0f &&
                vr < (float)(p.height - 1) && z[j] > 0.0f;
    pix[j] = in_img[j] ? (int)vr * p.width + (int)ur : 0;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) d[j] = in_img[j] ? depth[pix[j]] : 0.0f;

  float dist[4];
  bool upd[4], cupd[4];
  bool any_upd = false, partial = false, behind = false;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    dist[j] = d[j] - z[j];
    const bool depth_ok = d[j] > p.near_plane && d[j] < p.far_plane;
    upd[j] = in_img[j] && depth_ok && dist[j] > -0.03f && dist[j] < trunc + p.res_diag;
    cupd[j] = with_color && in_img[j] && depth_ok && fabsf(dist[j]) < p.color_band;
    partial |= !in_img[j] && z[j] > 0.0f;
    behind |= z[j] <= 0.0f;
    any_upd |= upd[j];
  }

  float s_old[4] = {s4.x, s4.y, s4.z, s4.w};
  float w_old[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (upd[j]) {
      float new_w = w_old[j] + w_in;
      float new_sdf = (s_old[j] * w_old[j] + dist[j] * w_in) / (new_w + 1e-4f);
      if (new_w <= p.min_weight) {
        new_sdf = kResetSdf;
        new_w = 0.0f;
      }
      s_old[j] = new_sdf;
      w_old[j] = new_w;
    }
  }
  if (upd[0] || upd[1] || upd[2] || upd[3]) {
    reinterpret_cast<float4*>(sdf)[row4] = make_float4(s_old[0], s_old[1], s_old[2], s_old[3]);
    reinterpret_cast<float4*>(weight)[row4] = make_float4(w_old[0], w_old[1], w_old[2], w_old[3]);
  }

  float qsum = 0.0f;
  if (cupd[0] || cupd[1] || cupd[2] || cupd[3]) {
    // rgb*255 and quality at the pixels, beside the colour rows of these
    // 4 voxels
    float g[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      g[j][0] = g[j][1] = g[j][2] = g[j][3] = 0.0f;
      if (cupd[j]) {
        g[j][0] = rgb[pix[j] * 3 + 0] * 255.0f;
        g[j][1] = rgb[pix[j] * 3 + 1] * 255.0f;
        g[j][2] = rgb[pix[j] * 3 + 2] * 255.0f;
        g[j][3] = qmap[pix[j]];
      }
    }
    float4* c4 = reinterpret_cast<float4*>(color) + 3 * row4;
    float4* n4p = reinterpret_cast<float4*>(ccnt) + row4;
    const float4 ca = c4[0], cb = c4[1], cc = c4[2], n4 = *n4p;
    float c[12] = {ca.x, ca.y, ca.z, ca.w, cb.x, cb.y, cb.z, cb.w, cc.x, cc.y, cc.z, cc.w};
    float cnt[4] = {n4.x, n4.y, n4.z, n4.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (cupd[j]) {
        float r = c[3 * j + 0] + g[j][0] * p.sign;
        float gg = c[3 * j + 1] + g[j][1] * p.sign;
        float b = c[3 * j + 2] + g[j][2] * p.sign;
        float n = cnt[j] + p.sign;
        if (fmaxf(r, fmaxf(gg, b)) > p.color_saturation && p.sign > 0.0f) {
          r *= 0.25f;
          gg *= 0.25f;
          b *= 0.25f;
          n *= 0.25f;
        }
        c[3 * j + 0] = r;
        c[3 * j + 1] = gg;
        c[3 * j + 2] = b;
        cnt[j] = n;
        qsum += g[j][3];
      }
    }
    c4[0] = make_float4(c[0], c[1], c[2], c[3]);
    c4[1] = make_float4(c[4], c[5], c[6], c[7]);
    c4[2] = make_float4(c[8], c[9], c[10], c[11]);
    *n4p = make_float4(cnt[0], cnt[1], cnt[2], cnt[3]);
  }

  // per-chunk reductions: warp votes and shuffles, then one shared pass
  const int warp = t >> 5;
  const int flags = (__any_sync(0xffffffffu, any_upd) ? 1 : 0) |
                    (__any_sync(0xffffffffu, partial) ? 2 : 0) |
                    (__any_sync(0xffffffffu, behind) ? 4 : 0);
  for (int off = 16; off > 0; off >>= 1) qsum += __shfl_down_sync(0xffffffffu, qsum, off);
  if ((t & 31) == 0) {
    warp_q[warp] = qsum;
    warp_flags[warp] = flags;
  }
  __syncthreads();
  if (t == 0) {
    float q = 0.0f;
    int f = 0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) {
      q += warp_q[w];
      f |= warp_flags[w];
    }
    quality_out[lane] = with_color ? ((f & 6) ? -1e11f : q) : 0.0f;
    updated_out[lane] = (f & 1) ? 1 : 0;
  }
}

// F-frame mode: depth-only frames [F, H, W] at poses [F, 4, 4] with one
// sign each, into the sdf and weight rows of the listed chunks, in one
// read-modify-write (texturefusion_torch/ops/tsdf.py
// integrate_depths_batched_plain). Each frame adds a_f = w * sign_f and
// a_f * dist_f where the voxel passes its band test; after the last frame
// a voxel that any frame updated takes w + sum(a), (sdf * w + sum(a*dist)) /
// (w + sum(a) + 1e-4), then the reset. Colour rows are not touched.
//
// kFrameParts blocks per listed chunk, each of kFrameThreads threads over
// 256 of its voxels, 2 x-adjacent voxels a thread (timed at the pipeline's
// shapes against 1 or 4 voxels a thread, 1 or 4 blocks a chunk, and
// groups of frames whose gathers are issued together: PERF.md). Before the
// frames, thread f < F of each block inverts frame f's pose and computes
// its w * sign and its band limit (truncation at the chunk origin +
// res_diag) into shared memory, with K2's arithmetic, so no pose load or
// inverse sits in the frame loop. Then each frame projects the thread's
// voxels, gathers their depth through the read-only path and sums, in
// frame order as the plain version does.
__global__ void __launch_bounds__(kFrameThreads)
tsdf_integrate_frames_kernel(float* __restrict__ sdf, float* __restrict__ weight,
                             const int64_t* __restrict__ idx,
                             const uint8_t* __restrict__ active,   // may be null
                             const float* __restrict__ origins,
                             const float* __restrict__ depths,     // [F, H, W]
                             const float* __restrict__ c2w_all,    // [F, 4, 4]
                             const TsdfParams p, const FrameSigns fs) {
  constexpr int V = kFrameVoxels;
  static_assert(kFrameThreads >= kMaxFrames, "one thread a frame stages the poses");
  __shared__ float4 frame_rows[kMaxFrames][4];   // w2c rows 0-2; (w * sign, band, -, -)
  __shared__ float cent[8];

  const int lane = blockIdx.x;
  const int t = threadIdx.x;
  const int64_t slot = idx[lane];
  const bool live = (active == nullptr || active[lane]) && slot >= 0 && slot < p.n_rows;
  if (!live) return;                             // block-uniform
  const int n_frames = fs.n_frames;

  // the rows first: nothing below decides whether they are needed
  const int v0 = blockIdx.y * (kVoxels / kFrameParts) + V * t;   // this thread's V voxels
  float2* const sdf2 = reinterpret_cast<float2*>(sdf + slot * kVoxels + v0);
  float2* const w2 = reinterpret_cast<float2*>(weight + slot * kVoxels + v0);
  const float2 s_row = *sdf2, w_row = *w2;
  float s_old[V] = {s_row.x, s_row.y}, w_old[V] = {w_row.x, w_row.y};

  const float ox = origins[slot * 3 + 0];
  const float oy = origins[slot * 3 + 1];
  const float oz = origins[slot * 3 + 2];
  if (t == 0) {
#pragma unroll
    for (int i = 0; i < 8; ++i) cent[i] = p.centroid[i];
  }
  if (t < n_frames) {
    // world -> camera of frame t, as K2: Rt then -(Rt t) summed x + y + z
    const float* c2w = c2w_all + 16 * t;
    float w2c[12];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      w2c[i * 4 + 0] = c2w[0 * 4 + i];
      w2c[i * 4 + 1] = c2w[1 * 4 + i];
      w2c[i * 4 + 2] = c2w[2 * 4 + i];
      w2c[i * 4 + 3] = -(c2w[0 * 4 + i] * c2w[3] + c2w[1 * 4 + i] * c2w[7] +
                         c2w[2 * 4 + i] * c2w[11]);
    }
    float sign = 0.0f;                           // fs.sign[t], by constant indices only
#pragma unroll
    for (int i = 0; i < kMaxFrames; ++i) sign = i == t ? fs.sign[i] : sign;
    const float oz_cam = w2c[8] * ox + w2c[9] * oy + w2c[10] * oz + w2c[11];
    const float trunc = fabsf(p.trunc_quad * oz_cam * oz_cam + p.trunc_linear * oz_cam +
                              p.trunc_const) * p.trunc_scale;
#pragma unroll
    for (int i = 0; i < 3; ++i)
      frame_rows[t][i] = make_float4(w2c[i * 4], w2c[i * 4 + 1], w2c[i * 4 + 2], w2c[i * 4 + 3]);
    frame_rows[t][3] = make_float4(p.integration_weight * sign, trunc + p.res_diag, 0.0f, 0.0f);
  }
  __syncthreads();                               // cent and frame_rows are filled

  const float wy = oy + cent[(v0 >> 3) & 7];
  const float wz = oz + cent[v0 >> 6];
  float wx[V];
#pragma unroll
  for (int j = 0; j < V; ++j) wx[j] = ox + cent[(v0 + j) & 7];
  const float u_max = (float)(p.width - 1), v_max = (float)(p.height - 1);
  const float width = (float)p.width;
  const int64_t plane = (int64_t)p.width * p.height;

  float a[V], ad[V];
  bool touched[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    a[j] = 0.0f;
    ad[j] = 0.0f;
    touched[j] = false;
  }
  for (int f = 0; f < n_frames; ++f) {
    const float4 r0 = frame_rows[f][0], r1 = frame_rows[f][1], r2 = frame_rows[f][2];
    const float* depth = depths + plane * f;
    float z[V], d[V];
    bool in_img[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      // (r0*x + r1*y + r2*z) + t, in this order
      const float xc = r0.x * wx[j] + r0.y * wy + r0.z * wz + r0.w;
      const float yc = r1.x * wx[j] + r1.y * wy + r1.z * wz + r1.w;
      z[j] = r2.x * wx[j] + r2.y * wy + r2.z * wz + r2.w;
      const float safe_z = fabsf(z[j]) > 1e-9f ? z[j] : 1e-9f;
      const float ur = rintf(p.fx * xc / safe_z + p.cx);   // half to even
      const float vr = rintf(p.fy * yc / safe_z + p.cy);
      in_img[j] = ur > 0.0f && ur < u_max && vr > 0.0f && vr < v_max && z[j] > 0.0f;
      // vr * width + ur is exact in float: the plain version's flat index
      d[j] = in_img[j] ? __ldg(depth + (int)(vr * width + ur)) : 0.0f;
    }
    const float4 wb = frame_rows[f][3];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float dist = d[j] - z[j];
      if (in_img[j] && d[j] > p.near_plane && d[j] < p.far_plane && dist > -0.03f &&
          dist < wb.y) {
        a[j] = a[j] + wb.x;
        ad[j] = ad[j] + wb.x * dist;
        touched[j] = true;
      }
    }
  }

  bool any = false;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    if (touched[j]) {
      float new_w = w_old[j] + a[j];
      float new_sdf = (s_old[j] * w_old[j] + ad[j]) / (new_w + 1e-4f);
      if (new_w <= p.min_weight) {
        new_sdf = kResetSdf;
        new_w = 0.0f;
      }
      s_old[j] = new_sdf;
      w_old[j] = new_w;
      any = true;
    }
  }
  if (any) {
    *sdf2 = make_float2(s_old[0], s_old[1]);
    *w2 = make_float2(w_old[0], w_old[1]);
  }
}

}  // namespace

// F-frame mode: kFrameParts blocks of kFrameThreads threads per lane of idx
// [n_lanes]; active may be null; depths [n_frames, H, W], cam_to_worlds
// [n_frames, 4, 4], with 1 <= n_frames <= kMaxFrames (the signs travel in
// `signs`).
extern "C" int tf_tsdf_integrate_frames_launch(
    float* sdf, float* weight, const int64_t* idx, const uint8_t* active, const float* origins,
    const float* depths, const float* cam_to_worlds, const TsdfParams* params,
    const FrameSigns* signs, int n_lanes, void* stream) {
  if (n_lanes < 0 || signs->n_frames < 1 || signs->n_frames > kMaxFrames)
    return (int)cudaErrorInvalidValue;
  if (n_lanes == 0) return (int)cudaSuccess;
  tsdf_integrate_frames_kernel<<<dim3(n_lanes, kFrameParts), kFrameThreads, 0,
                                 (cudaStream_t)stream>>>(
      sdf, weight, idx, active, origins, depths, cam_to_worlds, *params, *signs);
  return (int)cudaGetLastError();
}

// One block per lane of idx [n_lanes]; active [n_lanes] may be null.
extern "C" int tf_tsdf_integrate_launch(
    float* sdf, float* weight, float* color, float* ccnt, const int64_t* idx,
    const uint8_t* active, const float* origins, const float* depth, const float* rgb,
    const float* quality, const float* cam_to_world, float* quality_out,
    uint8_t* updated_out, const TsdfParams* params, int n_lanes, void* stream) {
  if (n_lanes < 0) return (int)cudaErrorInvalidValue;
  if (n_lanes == 0) return (int)cudaSuccess;
  tsdf_integrate_kernel<<<n_lanes, kThreads, 0, (cudaStream_t)stream>>>(
      sdf, weight, color, ccnt, idx, active, origins, depth, rgb, quality, cam_to_world,
      quality_out, updated_out, *params);
  return (int)cudaGetLastError();
}
