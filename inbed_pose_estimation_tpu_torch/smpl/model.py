"""SMPL body model on tensors: linear blend skinning and the 49-joint forward.

  1. shaped template  v = v_template + shapedirs . betas
  2. joints           J = J_regressor . v
  3. pose blendshapes v += posedirs . vec(R_1..R_23 - I)
  4. kinematic chain  world transforms along the 24-joint tree
  5. skinning         v' = sum_j w_vj (G_j v)   (ops/skinning.py)
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from ..device import constant
from ..geometry import batch_rodrigues
from ..ops.skinning import skinning
from ..utils.profiling import span

# The 21 face/hand/foot "vertex joints" (rows 24..44 of the extended joint
# set), standard SMPL vertex ids in smplx's VERTEX_IDS order.
SMPLX_VERTEX_JOINT_IDS = np.array(
    [
        332, 6260, 2800, 4071, 583,       # nose, right eye, left eye, right ear, left ear
        3216, 3226, 3387,                 # left big toe, small toe, heel
        6617, 6624, 6787,                 # right big toe, small toe, heel
        2746, 2319, 2445, 2556, 2673,     # left thumb, index, middle, ring, pinky
        6191, 5782, 5905, 6016, 6133,     # right thumb, index, middle, ring, pinky
    ],
    dtype=np.int64,
)


class SMPLOutput(NamedTuple):
    vertices: torch.Tensor     # [B, V, 3]
    joints: torch.Tensor       # [B, 49, 3]
    smpl_joints: torch.Tensor  # [B, 24, 3] raw kinematic joints


class SMPLModel(nn.Module):
    """SMPL template assets as buffers; `.to(device)` moves them.

    `parents` (the static kinematic tree, parents[0] = -1) stays a host
    tuple, so the chain is unrolled in Python with no device reads.
    """

    def __init__(self, v_template, shapedirs, posedirs, J_regressor, lbs_weights,
                 parents, J_regressor_extra, joint_map, faces):
        super().__init__()

        def f32(a):
            return torch.as_tensor(np.asarray(a), dtype=torch.float32)

        def i64(a):
            return torch.as_tensor(np.asarray(a, dtype=np.int64))

        self.register_buffer("v_template", f32(v_template))                # [V, 3]
        self.register_buffer("shapedirs", f32(shapedirs))                  # [V, 3, 10]
        self.register_buffer("posedirs", f32(posedirs))                    # [207, V*3]
        self.register_buffer("J_regressor", f32(J_regressor))              # [24, V]
        self.register_buffer("lbs_weights", f32(lbs_weights))              # [V, 24]
        self.register_buffer("J_regressor_extra", f32(J_regressor_extra))  # [9, V]
        self.register_buffer("joint_map", i64(joint_map))                  # [49]
        self.register_buffer("faces", i64(faces))                          # [F, 3]
        self.register_buffer("vertex_joint_ids", i64(SMPLX_VERTEX_JOINT_IDS))
        self.parents = tuple(int(p) for p in parents)
        self.register_buffer("parent_index", i64(self.parents[1:]))


def _kinematic_chain(rot_mats, joints, model: SMPLModel):
    """World transforms [B, 24, 4, 4] from local rotations [B, 24, 3, 3]
    and rest joints [B, 24, 3]: 23 batched 4x4 products down the tree."""
    B = rot_mats.shape[0]
    rel_joints = torch.cat([joints[:, :1], joints[:, 1:] - joints[:, model.parent_index]], dim=1)
    top = torch.cat([rot_mats, rel_joints[..., None]], dim=-1)                    # [B, 24, 3, 4]
    bottom = constant((0.0, 0.0, 0.0, 1.0), rot_mats.dtype, rot_mats.device)
    local = torch.cat([top, bottom.expand(B, rot_mats.shape[1], 1, 4)], dim=-2)  # [B, 24, 4, 4]
    world = [local[:, 0]]
    for j in range(1, rot_mats.shape[1]):
        world.append(world[model.parents[j]] @ local[:, j])
    return torch.stack(world, dim=1)


def lbs(model: SMPLModel, betas, rot_mats, skin=skinning):
    """Linear blend skinning.

    betas [B, 10], rot_mats [B, 24, 3, 3] (global orientation at index 0).
    `skin` is the skinning function; the default launches the CUDA kernel
    for tensors on the card.  Returns (vertices [B, V, 3], joints24 [B, 24, 3]).
    """
    with span("smpl.lbs"):
        B = betas.shape[0]
        V = model.v_template.shape[0]

        v_shaped = model.v_template[None] + torch.einsum("vck,bk->bvc", model.shapedirs, betas)
        J = torch.einsum("jv,bvc->bjc", model.J_regressor, v_shaped)

        ident = torch.eye(3, dtype=betas.dtype, device=betas.device)
        pose_feature = (rot_mats[:, 1:] - ident).reshape(B, -1)
        v_posed = v_shaped + (pose_feature @ model.posedirs).reshape(B, V, 3)

        world = _kinematic_chain(rot_mats, J, model)
        joints24 = world[:, :, :3, 3]
        # Remove the rest-pose joint locations: G_j <- G_j . [I | -J_j].
        A_rot = world[:, :, :3, :3]
        A_t = world[:, :, :3, 3] - torch.einsum("bjmn,bjn->bjm", A_rot, J)

        verts = skin(v_posed, model.lbs_weights, A_rot, A_t)
        return verts, joints24


def smpl_forward(model: SMPLModel, betas, rot_mats=None, pose_aa=None, skin=skinning) -> SMPLOutput:
    """SMPL forward with the 49-joint superset: 24 kinematic + 21 vertex
    joints + 9 extra regressed joints, gathered through `joint_map`.

    Give exactly one of `rot_mats` [B, 24, 3, 3] or `pose_aa` [B, 72].
    `skin` is passed on to `lbs`.
    """
    if (rot_mats is None) == (pose_aa is None):
        raise ValueError("smpl_forward: give exactly one of rot_mats or pose_aa")
    if rot_mats is None:
        rot_mats = batch_rodrigues(pose_aa.reshape(-1, 24, 3))
    verts, joints24 = lbs(model, betas, rot_mats, skin=skin)
    vertex_joints = verts[:, model.vertex_joint_ids]                               # [B, 21, 3]
    extra = torch.einsum("jv,bvc->bjc", model.J_regressor_extra, verts)            # [B, 9, 3]
    joints54 = torch.cat([joints24, vertex_joints, extra], dim=1)
    return SMPLOutput(vertices=verts, joints=joints54[:, model.joint_map], smpl_joints=joints24)
