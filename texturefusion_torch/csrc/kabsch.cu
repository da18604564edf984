// Weighted rigid fit (Kabsch), batched, for Hopper (sm_90a): kernel K3.
//
// K3 has no Pallas counterpart: the JAX package computes this fit with
// jnp.linalg.svd inside its jitted programs (texturefusion_tpu/slam/
// matching.py `kabsch`, called by every RANSAC hypothesis of
// `register_frames`). On the card torch.linalg.svd synchronises with the
// host (cuSOLVER's convergence check), which forbids capturing the frame
// step and the promotion probe as CUDA graphs; this kernel computes the same
// fit without leaving the device. It follows texturefusion_torch/slam/
// matching.py `kabsch_plain`: for each fit, p, q [N, 3] and weights w [N]
// give T [4, 4] with p ~ R q + t:
//   wsum = max(sum w, 1e-9), pc = sum w p / wsum, qc = sum w q / wsum,
//   H = sum_n (q_n - qc) (w_n (p_n - pc))^T           (3 x 3),
//   H = U S V^T, R = V diag(1, 1, sign det(V U^T)) U^T, t = pc - R qc.
//
// Design: one warp a fit. Its lanes stride over the N points and sum the
// centroids, then the cross-covariance, in float64, reduced by shuffles.
// Lane 0 then takes the SVD of H by one-sided (Hestenes) Jacobi in float64:
// plane rotations J on the right orthogonalise H's columns, A = H V with
// V = J1 J2 ..., a fixed count of cyclic sweeps (kSweeps; a pair already
// orthogonal to 1e-15 is skipped), then sigma_k = |a_k| and u_k = a_k /
// sigma_k, sorted by sigma descending. V is a product of rotations, so
// det V = +1 before the sort; the sort's swaps give its sign. With U' = U
// diag(1, 1, d), d = det V det U, det U' = det V, so its last column is
// det V (u1 x u2): R = v1 u1^T + v2 u2^T + det V v3 (u1 x u2)^T. That needs
// only the two largest singular vectors, so a planar set (sigma3 = 0) has
// a well-defined fit; where sigma2 vanishes too (collinear points, zero
// weights) u2 is completed to any unit vector orthogonal to u1, and a zero
// H gives R = I, as LAPACK's SVD of a zero matrix does. R and t are
// rounded to float32 once.
//
// What bounds it on the H100: neither bytes nor operations. A RANSAC call
// is 400 fits of 4 points (28 floats in, 16 out each: 70 KB, 0.02 us at
// 3.35 TB/s) and ~2,500 float64 operations a fit (1 MFLOP, 0.03 us at the
// data sheet's 34 TFLOP/s fp64); what the kernel takes is the latency of
// lane 0's chain of dependent float64 operations and the launch. Making it
// fast (a fit a thread, the rotations' square roots in single precision
// with a refinement) is later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;        // fits a block
constexpr int kSweeps = 10;      // cyclic Jacobi sweeps (3 x 3 converges in ~5)

__device__ inline double warp_sum(double v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ inline void cross3(const double* a, const double* b, double* c) {
  c[0] = a[1] * b[2] - a[2] * b[1];
  c[1] = a[2] * b[0] - a[0] * b[2];
  c[2] = a[0] * b[1] - a[1] * b[0];
}

// R and t of one fit from H (row-major, H[i][j] = sum qq_i pp_j) and the
// centroids; writes the 4 x 4 pose row-major.
__device__ void fit_pose(const double* h, const double* pc, const double* qc, float* out) {
  double a[3][3], v[3][3];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      a[i][j] = h[3 * i + j];
      v[i][j] = i == j ? 1.0 : 0.0;
    }
  for (int sweep = 0; sweep < kSweeps; ++sweep) {
    for (int pair = 0; pair < 3; ++pair) {      // (0, 1), (0, 2), (1, 2)
      const int i = pair == 2 ? 1 : 0;
      const int j = pair == 0 ? 1 : 2;
      double alpha = 0.0, beta = 0.0, gamma = 0.0;
      for (int r = 0; r < 3; ++r) {
        alpha += a[r][i] * a[r][i];
        beta += a[r][j] * a[r][j];
        gamma += a[r][i] * a[r][j];
      }
      if (gamma == 0.0 || fabs(gamma) <= 1e-15 * sqrt(alpha * beta)) continue;
      const double zeta = (beta - alpha) / (2.0 * gamma);
      const double t = copysign(1.0, zeta) / (fabs(zeta) + sqrt(1.0 + zeta * zeta));
      const double c = 1.0 / sqrt(1.0 + t * t);
      const double s = c * t;
      for (int r = 0; r < 3; ++r) {
        const double x = a[r][i], y = a[r][j];
        a[r][i] = c * x - s * y;
        a[r][j] = s * x + c * y;
        const double vx = v[r][i], vy = v[r][j];
        v[r][i] = c * vx - s * vy;
        v[r][j] = s * vx + c * vy;
      }
    }
  }
  double sig[3];
  int ord[3] = {0, 1, 2};
  for (int k = 0; k < 3; ++k)
    sig[k] = sqrt(a[0][k] * a[0][k] + a[1][k] * a[1][k] + a[2][k] * a[2][k]);
  double det_v = 1.0;
  // three compare-exchanges sort ord by sigma descending (stable on ties)
  const int ce[3][2] = {{0, 1}, {1, 2}, {0, 1}};
  for (int e = 0; e < 3; ++e) {
    const int x = ce[e][0], y = ce[e][1];
    if (sig[ord[y]] > sig[ord[x]]) {
      const int tmp = ord[x];
      ord[x] = ord[y];
      ord[y] = tmp;
      det_v = -det_v;
    }
  }
  const double s0 = sig[ord[0]], s1 = sig[ord[1]];
  double u1[3], u2[3], u3[3];
  if (s0 > 1e-300) {
    for (int r = 0; r < 3; ++r) u1[r] = a[r][ord[0]] / s0;
  } else {
    u1[0] = 1.0; u1[1] = 0.0; u1[2] = 0.0;
  }
  if (s1 > 1e-300 && s1 > 1e-13 * s0) {
    for (int r = 0; r < 3; ++r) u2[r] = a[r][ord[1]] / s1;
  } else {
    // any unit vector orthogonal to u1: the axis least aligned with it
    int k = 0;
    for (int r = 1; r < 3; ++r)
      if (fabs(u1[r]) < fabs(u1[k])) k = r;
    for (int r = 0; r < 3; ++r) u2[r] = r == k ? 1.0 : 0.0;
  }
  // one Gram-Schmidt step keeps u2 orthonormal to u1
  const double d12 = u1[0] * u2[0] + u1[1] * u2[1] + u1[2] * u2[2];
  for (int r = 0; r < 3; ++r) u2[r] -= d12 * u1[r];
  const double n2 = sqrt(u2[0] * u2[0] + u2[1] * u2[1] + u2[2] * u2[2]);
  for (int r = 0; r < 3; ++r) u2[r] /= n2;
  cross3(u1, u2, u3);
  double rot[3][3];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      rot[i][j] = v[i][ord[0]] * u1[j] + v[i][ord[1]] * u2[j] + det_v * v[i][ord[2]] * u3[j];
  for (int i = 0; i < 3; ++i) {
    const double t = pc[i] - (rot[i][0] * qc[0] + rot[i][1] * qc[1] + rot[i][2] * qc[2]);
    for (int j = 0; j < 3; ++j) out[4 * i + j] = (float)rot[i][j];
    out[4 * i + 3] = (float)t;
  }
  out[12] = 0.0f;
  out[13] = 0.0f;
  out[14] = 0.0f;
  out[15] = 1.0f;
}

__global__ void __launch_bounds__(kWarps * 32)
kabsch_kernel(const float* __restrict__ p, const float* __restrict__ q,
              const float* __restrict__ w, float* __restrict__ out, int n_fits, int n) {
  const int lane = threadIdx.x & 31;
  const int fit = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (fit >= n_fits) return;                   // the whole warp leaves together
  const float* pf = p + (size_t)fit * n * 3;
  const float* qf = q + (size_t)fit * n * 3;
  const float* wf = w + (size_t)fit * n;
  double sw = 0.0, sp[3] = {0.0, 0.0, 0.0}, sq[3] = {0.0, 0.0, 0.0};
  for (int i = lane; i < n; i += 32) {
    const double wi = wf[i];
    sw += wi;
    for (int k = 0; k < 3; ++k) {
      sp[k] += wi * (double)pf[3 * i + k];
      sq[k] += wi * (double)qf[3 * i + k];
    }
  }
  sw = warp_sum(sw);
  for (int k = 0; k < 3; ++k) {
    sp[k] = warp_sum(sp[k]);
    sq[k] = warp_sum(sq[k]);
  }
  const double wsum = fmax(sw, (double)1e-9f);  // the plain version's float32 clamp
  double pc[3], qc[3];
  for (int k = 0; k < 3; ++k) {
    pc[k] = sp[k] / wsum;
    qc[k] = sq[k] / wsum;
  }
  double h[9] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
  for (int i = lane; i < n; i += 32) {
    const double wi = wf[i];
    double dp[3], dq[3];
    for (int k = 0; k < 3; ++k) {
      dp[k] = ((double)pf[3 * i + k] - pc[k]) * wi;
      dq[k] = (double)qf[3 * i + k] - qc[k];
    }
    for (int r = 0; r < 3; ++r)
      for (int c = 0; c < 3; ++c) h[3 * r + c] += dq[r] * dp[c];
  }
  for (int k = 0; k < 9; ++k) h[k] = warp_sum(h[k]);
  if (lane == 0) fit_pose(h, pc, qc, out + (size_t)fit * 16);
}

}  // namespace

// p, q [n_fits, n, 3], w [n_fits, n] float32, out [n_fits, 4, 4]; one warp
// a fit, kWarps fits a block.
extern "C" int tf_kabsch_launch(const float* p, const float* q, const float* w, float* out,
                                int n_fits, int n, void* stream) {
  if (n_fits < 0 || n < 0) return (int)cudaErrorInvalidValue;
  if (n_fits == 0) return (int)cudaSuccess;
  const int blocks = (n_fits + kWarps - 1) / kWarps;
  kabsch_kernel<<<blocks, kWarps * 32, 0, (cudaStream_t)stream>>>(p, q, w, out, n_fits, n);
  return (int)cudaGetLastError();
}
