"""Synthetic SMPL assets made from the seed, at the published model's shapes.

The SMPL model files are licensed and not in the repository, so each run
draws a body of SMPL's sizes on the device: 6,890 vertices, 24 joints in
SMPL's kinematic tree, 10 shape and 207 pose blend shapes, 13,776 faces,
the 17 x 6,890 H36M regressor and the 9 extra regressed joints.  The
template is a vertical body 2 m tall around the origin; each joint
averages a band of vertices, and each vertex is skinned to the joint bands
near its height.  Sizes come from the configuration's `smpl` group.
"""

from __future__ import annotations

import torch

from .weights import generator

# SMPL's kinematic tree: the parent of each of the 24 joints.
SMPL_PARENTS = (-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17, 18, 19, 20, 21)


def _bands(rows, V, half_width, device, gen):
    """[rows, V]: row r averages a band of vertices, with seeded positive
    weights, centred along the body."""
    out = torch.zeros(rows, V, device=device)
    for r in range(rows):
        mid = int((0.03 + 0.94 * r / (rows - 1)) * V)
        lo, hi = max(0, mid - half_width), min(V, mid + half_width)
        w = torch.rand(hi - lo, device=device, generator=gen) + 0.5
        out[r, lo:hi] = w / w.sum()
    return out


def make_assets(smpl_config, seed: int, device) -> dict:
    V = smpl_config["num_vertices"]
    J = smpl_config["num_joints"]
    K = smpl_config["num_betas"]
    P = smpl_config["num_pose_blend"]
    F = smpl_config["num_faces"]
    gen = generator(seed, "smpl", device)
    v_template = torch.randn(V, 3, device=device, generator=gen) * 0.12
    v_template[:, 1] = torch.linspace(-1.0, 1.0, V, device=device) + torch.randn(V, device=device, generator=gen) * 0.02
    joint_y = torch.linspace(-1.0, 1.0, J, device=device)
    w = torch.exp(-((v_template[:, 1:2] - joint_y[None]) ** 2) / 0.02)
    return {
        "v_template": v_template,
        "shapedirs": torch.randn(V, 3, K, device=device, generator=gen) * 0.01,
        "posedirs": torch.randn(P, V * 3, device=device, generator=gen) * 0.001,
        "J_regressor": _bands(J, V, 20, device, gen),
        "lbs_weights": w / w.sum(dim=1, keepdim=True),
        "J_regressor_extra": _bands(9, V, 20, device, gen),
        "j_regressor_h36m": _bands(17, V, 30, device, gen),
        "faces": torch.randint(0, V, (F, 3), device=device, generator=gen),
        "parents": SMPL_PARENTS[:J],
    }
