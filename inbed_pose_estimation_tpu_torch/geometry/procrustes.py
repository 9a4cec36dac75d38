"""Batched similarity (Procrustes) alignment and PA-MPJPE."""

from __future__ import annotations

import torch


def compute_similarity_transform(S1: torch.Tensor, S2: torch.Tensor) -> torch.Tensor:
    """Align S1 to S2 with scale, rotation and translation.

    S1, S2: [B, N, 3].  Returns the aligned S1, [B, N, 3].  One batched SVD
    for the whole batch.
    """
    X1 = S1.transpose(-1, -2)
    X2 = S2.transpose(-1, -2)
    mu1 = X1.mean(dim=-1, keepdim=True)
    mu2 = X2.mean(dim=-1, keepdim=True)
    X1c = X1 - mu1
    X2c = X2 - mu2

    var1 = torch.sum(X1c ** 2, dim=(-1, -2))

    K = X1c @ X2c.transpose(-1, -2)  # [B, 3, 3]
    U, _, Vh = torch.linalg.svd(K)
    V = Vh.transpose(-1, -2)

    # Fix the reflection so that det(R) = +1.
    det = torch.linalg.det(U @ V.transpose(-1, -2))
    Z = torch.eye(3, dtype=S1.dtype, device=S1.device).repeat(K.shape[0], 1, 1)
    Z[:, -1, -1] = torch.sign(det)
    R = V @ (Z @ U.transpose(-1, -2))

    scale = torch.diagonal(R @ K, dim1=-2, dim2=-1).sum(-1) / var1
    t = mu2 - scale[:, None, None] * (R @ mu1)
    X1_hat = scale[:, None, None] * (R @ X1) + t
    return X1_hat.transpose(-1, -2)


def reconstruction_error(S1: torch.Tensor, S2: torch.Tensor, reduction: str | None = "mean") -> torch.Tensor:
    """Procrustes-aligned mean per-joint error (PA-MPJPE), batched."""
    S1_hat = compute_similarity_transform(S1, S2)
    re = torch.sqrt(torch.sum((S1_hat - S2) ** 2, dim=-1)).mean(dim=-1)
    if reduction == "mean":
        return re.mean()
    if reduction == "sum":
        return re.sum()
    return re
