"""Global colour compensation: covariance-matched linear colour transfer.

Port of texturefusion_tpu/texture/color.py (ref: Structure/Chisel.cpp:198-286
— patches clustered by keyframe, mean and covariance of the sampled
texture colours against the fused voxel colours, the eigendecomposition
transfer T :250-268, per-vertex corrected colours :270-284).

For each keyframe cluster the linear map T aligns the texture colours'
distribution with the (globally consistent) voxel colours':
  T = U_v Λ_v^{1/2} U_vᵀ · U_t Λ_t^{-1/2} U_tᵀ,   corrected = T (c − μ_t) + μ_v
batched over the clusters with 3×3 `torch.linalg.eigh`. T is a matrix
function of each covariance, so eigenvector signs and the order of equal
eigenvalues do not change it. On CUDA `eigh` goes through cuSOLVER, which
reads its error flag back to the host: one synchronisation per call.
"""

from __future__ import annotations

from typing import Tuple

import torch


def cluster_stats(colors: torch.Tensor, weights: torch.Tensor, cluster: torch.Tensor,
                  n_clusters: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weighted per-cluster mean [C, 3] and covariance [C, 3, 3] of colours
    [N, 3]; `cluster` [N] ids; weight 0 drops a sample."""
    dev, w = colors.device, weights.to(torch.float32)
    cluster = cluster.to(torch.int64)
    wsum = torch.zeros(n_clusters, device=dev).index_add_(0, cluster, w) + 1e-9
    mean = torch.zeros(n_clusters, 3, device=dev).index_add_(0, cluster, w[:, None] * colors)
    mean = mean / wsum[:, None]
    diff = colors - mean[cluster]
    outer = diff[:, :, None] * diff[:, None, :] * w[:, None, None]
    cov = torch.zeros(n_clusters, 3, 3, device=dev).index_add_(0, cluster, outer)
    return mean, cov / wsum[:, None, None]


def transfer_matrices(mean_tex: torch.Tensor, cov_tex: torch.Tensor,
                      mean_vox: torch.Tensor, cov_vox: torch.Tensor) -> torch.Tensor:
    """Per-cluster 3×3 transfer T matching the texture distribution to the
    voxel distribution (ref: Chisel.cpp:250-268). `mean_*` are unused: the
    means enter apply_transfer."""
    eps = 1e-6
    eye = eps * torch.eye(3, device=cov_tex.device, dtype=cov_tex.dtype)
    lt, ut = torch.linalg.eigh(cov_tex + eye)
    lv, uv = torch.linalg.eigh(cov_vox + eye)
    sqrt_v = (uv * torch.sqrt(torch.clamp(lv, min=eps))[:, None, :]) @ uv.transpose(-1, -2)
    inv_sqrt_t = (ut * (1.0 / torch.sqrt(torch.clamp(lt, min=eps)))[:, None, :]) \
        @ ut.transpose(-1, -2)
    return sqrt_v @ inv_sqrt_t


def apply_transfer(colors_tex: torch.Tensor, cluster: torch.Tensor, t: torch.Tensor,
                   mean_tex: torch.Tensor, mean_vox: torch.Tensor) -> torch.Tensor:
    """Corrected colours [N, 3]: T_c (c − μ_tex,c) + μ_vox,c, clipped to 0..1."""
    cluster = cluster.to(torch.int64)
    corrected = torch.einsum("nij,nj->ni", t[cluster], colors_tex - mean_tex[cluster]) \
        + mean_vox[cluster]
    return torch.clamp(corrected, 0.0, 1.0)


def compensate(colors_tex: torch.Tensor, colors_vox: torch.Tensor, weights: torch.Tensor,
               cluster: torch.Tensor, n_clusters: int) -> torch.Tensor:
    """Per-cluster stats → transfer → corrected colours. Returns the
    per-sample colour-adjust deltas (corrected − tex), the quantity the
    reference packs per vertex for its shader (ref: Chisel.cpp:270-284)."""
    mean_t, cov_t = cluster_stats(colors_tex, weights, cluster, n_clusters)
    mean_v, cov_v = cluster_stats(colors_vox, weights, cluster, n_clusters)
    t = transfer_matrices(mean_t, cov_t, mean_v, cov_v)
    return apply_transfer(colors_tex, cluster, t, mean_t, mean_v) - colors_tex
