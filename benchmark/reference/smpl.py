"""Plain SMPL linear blend skinning, the H36M joints and the body mask.

  v_shaped = v_template + shapedirs . betas
  J        = J_regressor . v_shaped
  v_posed  = v_shaped + posedirs . vec(R_1..R_23 - I)
  G        = the 24 world transforms down the kinematic tree, each with its
             rest joint removed
  v'       = sum_j w_vj (G_j v_posed)

`assets` is the dict that `benchmark.smpl_assets` makes (tensors on one
device, `parents` a tuple).  The body mask projects the vertices through
the weak-perspective camera at half resolution, sets each vertex's pixel
(coordinates truncated toward zero, a 2-pixel margin so that points just
outside still dilate in), dilates 5x5, and upsamples bilinearly.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

FOCAL_LENGTH = 5000.0
# H36M's 17 joints in the J17 order, from the 17 rows of the regressor.
H36M_TO_J17 = (6, 5, 4, 1, 2, 3, 16, 15, 14, 11, 12, 13, 8, 10, 0, 7, 9)


def kinematic_chain(rot_mats, joints, parents):
    B, J = rot_mats.shape[0], rot_mats.shape[1]
    parent_index = torch.tensor(parents[1:], device=joints.device)
    rel = torch.cat([joints[:, :1], joints[:, 1:] - joints[:, parent_index]], dim=1)
    top = torch.cat([rot_mats, rel[..., None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=rot_mats.dtype, device=rot_mats.device)
    local = torch.cat([top, bottom.expand(B, J, 1, 4)], dim=-2)
    world = [local[:, 0]]
    for j in range(1, J):
        world.append(world[parents[j]] @ local[:, j])
    return torch.stack(world, dim=1)


def lbs(assets, betas, rot_mats):
    """(vertices [B, V, 3], joints [B, 24, 3])."""
    B = betas.shape[0]
    V = assets["v_template"].shape[0]
    v_shaped = assets["v_template"][None] + torch.einsum("vck,bk->bvc", assets["shapedirs"], betas)
    J = torch.einsum("jv,bvc->bjc", assets["J_regressor"], v_shaped)
    ident = torch.eye(3, dtype=betas.dtype, device=betas.device)
    pose_feature = (rot_mats[:, 1:] - ident).reshape(B, -1)
    v_posed = v_shaped + (pose_feature @ assets["posedirs"]).reshape(B, V, 3)
    world = kinematic_chain(rot_mats, J, assets["parents"])
    A_rot = world[:, :, :3, :3]
    A_t = world[:, :, :3, 3] - torch.einsum("bjmn,bjn->bjm", A_rot, J)
    W = assets["lbs_weights"]
    R_blend = torch.einsum("vj,bjmn->bvmn", W, A_rot)
    t_blend = torch.einsum("vj,bjm->bvm", W, A_t)
    verts = torch.einsum("bvmn,bvn->bvm", R_blend, v_posed) + t_blend
    return verts, world[:, :, :3, 3]


def regress_j17(assets, verts):
    k3d = torch.einsum("jv,bvc->bjc", assets["j_regressor_h36m"], verts)
    return k3d[:, list(H36M_TO_J17)] - k3d[:, 0:1]


def project(verts, cam, img_res):
    """Pixel coordinates [B, V, 2] of the vertices under the weak-perspective
    camera (s, tx, ty) read as a pinhole one with tz = 2 f / (res s)."""
    B = verts.shape[0]
    s, tx, ty = cam.unbind(-1)
    tz = 2.0 * FOCAL_LENGTH / (img_res * s + 1e-9)
    cam_t = torch.stack([tx, ty, tz], dim=-1)
    eye = torch.eye(3, dtype=verts.dtype, device=verts.device).expand(B, 3, 3)
    p = torch.einsum("bij,bkj->bki", eye, verts) + cam_t[:, None, :]
    p = p / p[..., 2:3]
    return p[..., :2] * FOCAL_LENGTH + torch.zeros_like(cam_t[:, :2])[:, None, :]


def splat(xy, height, width, dilation=5):
    B = xy.shape[0]
    m = dilation // 2
    h2, w2 = height + 2 * m, width + 2 * m
    ij = xy.clamp(-1.0e6, 1.0e6).to(torch.int32).to(torch.int64) + m
    xi, yi = ij[..., 0], ij[..., 1]
    inside = (xi >= 0) & (xi < w2) & (yi >= 0) & (yi < h2)
    flat = torch.where(inside, yi * w2 + xi, h2 * w2)
    canvas = torch.zeros(B, h2 * w2 + 1, dtype=xy.dtype, device=xy.device)
    canvas.scatter_(1, flat, 1.0)
    mask = F.max_pool2d(canvas[:, :-1].reshape(B, 1, h2, w2), dilation, stride=1, padding=m)
    return mask[:, :, m:-m, m:-m]


def _mask(uv, res, img_res):
    return F.interpolate(splat(uv, res, res), size=(img_res, img_res), mode="bilinear", align_corners=False)


def mask_uv(verts, cam, img_res, mask_scale=2):
    return (project(verts, cam, img_res) + 0.5 * img_res) / mask_scale


def render_body_mask(verts, cam, img_res, mask_scale=2):
    return _mask(mask_uv(verts, cam, img_res, mask_scale), img_res // mask_scale, img_res)


def body_mask_band(verts, cam, img_res, edge_px, mask_scale=2):
    """(lo, hi): the least and the most mask that vertices moved by up to
    `edge_px` pixels (at the splat's resolution) can give.  A vertex whose
    truncated pixel would change within that distance sets its pixel in
    `lo` only if every choice agrees, and every candidate pixel in `hi`;
    the dilation and the upsample are monotone, so any such mask lies
    between the two, pixel by pixel."""
    uv = mask_uv(verts, cam, img_res, mask_scale)
    res = img_res // mask_scale
    far = torch.full_like(uv, -1.0e6)
    t_lo = (uv - edge_px).clamp(-1.0e6, 1.0e6).to(torch.int32).to(uv.dtype)
    t_hi = (uv + edge_px).clamp(-1.0e6, 1.0e6).to(torch.int32).to(uv.dtype)
    certain = (t_lo == t_hi).all(dim=-1, keepdim=True)
    lo = _mask(torch.where(certain, t_lo, far), res, img_res)
    corners = torch.cat([t_lo, t_hi, torch.stack([t_lo[..., 0], t_hi[..., 1]], -1),
                         torch.stack([t_hi[..., 0], t_lo[..., 1]], -1)], dim=1)
    hi = _mask(corners, res, img_res)
    return lo.clamp(0.0, 1.0), hi.clamp(0.0, 1.0)
