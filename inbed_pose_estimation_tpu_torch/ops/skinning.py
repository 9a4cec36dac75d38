"""SMPL skinning: CUDA kernel wrapper, plain version and gradient.

    verts[b, v] = sum_j W[v, j] (A_rot[b, j] @ v_posed[b, v] + A_t[b, j])

`skinning` is what `smpl.model.lbs` calls.  For CUDA tensors it launches
`csrc/skinning.cu` (the port of the TPU kernel `_skin_kernel` in the JAX
package's `ops/pallas_lbs.py`) once, reading A_rot and A_t in place through
their strides, or raises; it takes the plain version `skinning_reference`
only for tensors on the CPU.  Its gradient is the closed-form products of
the JAX op's custom VJP, as plain tensor code.

`launches` counts kernel launches; it is raised only where the kernel is
launched, so a run can show that it went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .build import library

NUM_JOINTS = 24

launches = 0


def skinning_reference(v_posed, lbs_weights, A_rot, A_t):
    """The plain einsum form (the JAX `lbs` einsum path)."""
    R_blend = torch.einsum("vj,bjmn->bvmn", lbs_weights, A_rot)
    t_blend = torch.einsum("vj,bjm->bvm", lbs_weights, A_t)
    return torch.einsum("bvmn,bvn->bvm", R_blend, v_posed) + t_blend


def _check(v_posed, lbs_weights, A_rot, A_t):
    B, V = v_posed.shape[0], v_posed.shape[1]
    if v_posed.dtype != torch.float32 and not (v_posed.dtype == torch.float64 and v_posed.device.type == "cpu"):
        raise TypeError(f"skinning: v_posed is {v_posed.dtype}, expected torch.float32 (or float64 on the CPU)")
    shapes = {
        "v_posed": (v_posed, (B, V, 3)),
        "lbs_weights": (lbs_weights, (V, NUM_JOINTS)),
        "A_rot": (A_rot, (B, NUM_JOINTS, 3, 3)),
        "A_t": (A_t, (B, NUM_JOINTS, 3)),
    }
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"skinning: {name} has shape {tuple(t.shape)}, expected {shape}")
        if t.dtype != v_posed.dtype:
            raise TypeError(f"skinning: {name} is {t.dtype}, v_posed {v_posed.dtype}")
        if t.device != v_posed.device:
            raise ValueError(f"skinning: {name} is on {t.device}, v_posed on {v_posed.device}")
    if B == 0 or V == 0:
        raise ValueError(f"skinning: empty input (B={B}, V={V})")


# Launch geometry of csrc/skinning.cu: a block blends a tile of TILE_VERTICES
# vertices for a chunk of at most MAX_CHUNK batch elements, and two blocks
# fit on each of the card's NUM_SMS SMs.
TILE_VERTICES = 448
MAX_CHUNK = 4
NUM_SMS = 132  # H100 SXM


def batch_chunk(B, V):
    """Batch elements per block: the smallest power of two up to MAX_CHUNK
    whose grid fits in one wave of two blocks per SM (a larger chunk reads
    W fewer times, a smaller one gives more blocks; past one wave the last
    blocks run alone)."""
    tiles = -(-V // TILE_VERTICES)
    chunk = 1
    while chunk < MAX_CHUNK and tiles * -(-B // chunk) > 2 * NUM_SMS:
        chunk *= 2
    return chunk


def affine_strides(A_rot, A_t):
    """Element strides the kernel reads the affines in place with:
    A_rot's (b, j, m, n), then A_t's (b, j, m)."""
    return (*A_rot.stride(), *A_t.stride())


@functools.cache
def _kernel():
    """The C entry points of csrc/skinning.cu, built and typed once per process."""
    lib = library("skinning")
    lib.skinning_forward.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 7 + [ctypes.c_void_p] * 3
                                     + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    lib.skinning_forward.restype = ctypes.c_int
    lib.skinning_error_string.argtypes = [ctypes.c_int]
    lib.skinning_error_string.restype = ctypes.c_char_p
    return lib.skinning_forward, lib.skinning_error_string


def _launch(v_posed, lbs_weights, A_rot, A_t, chunk=None):
    """One kernel launch; A_rot and A_t are read in place, whatever their strides.

    `chunk` overrides `batch_chunk(B, V)`; chip_smoke.py times each chunk
    with it.
    """
    global launches
    if not (v_posed.is_contiguous() and lbs_weights.is_contiguous()):
        raise ValueError("skinning: v_posed and lbs_weights must be contiguous")
    if lbs_weights.data_ptr() % 16:
        raise ValueError("skinning: lbs_weights must start on a 16-byte boundary")
    B, V = v_posed.shape[0], v_posed.shape[1]
    chunk = batch_chunk(B, V) if chunk is None else chunk
    out = torch.empty_like(v_posed)
    forward, error_string = _kernel()
    with torch.cuda.device(v_posed.device):  # launch under the tensors' device, on its current stream
        stream = torch.cuda.current_stream().cuda_stream
        err = forward(A_rot.data_ptr(), A_t.data_ptr(), *affine_strides(A_rot, A_t), v_posed.data_ptr(),
                      lbs_weights.data_ptr(), out.data_ptr(), B, V, chunk, stream)
    if err != 0:
        raise RuntimeError(f"skinning kernel launch failed: {error_string(err).decode()}")
    launches += 1
    return out


def skinning_forward(v_posed, lbs_weights, A_rot, A_t):
    """Forward only: the kernel for CUDA tensors, the plain version on the CPU."""
    _check(v_posed, lbs_weights, A_rot, A_t)
    if v_posed.device.type == "cuda":
        return _launch(v_posed, lbs_weights, A_rot, A_t)
    if v_posed.device.type == "cpu":
        return skinning_reference(v_posed, lbs_weights, A_rot, A_t)
    raise ValueError(f"skinning: unsupported device {v_posed.device}")


def skinning_backward(v_posed, lbs_weights, A_rot, A_t, g, needs=(True, True, True, True)):
    """Closed-form cotangents of the bilinear op (the JAX `_skinning_bwd`).

    `needs` says which of (d_v, d_W, d_rot, d_t) to compute; the others are
    None.  SMPL's lbs_weights is a buffer, so autograd never asks for d_W,
    the costliest of the four.
    """
    W = lbs_weights
    d_v = d_W = d_rot = d_t = None
    if needs[0]:
        # d v_posed[b,v,n] = sum_j W[v,j] A_rot[b,j,m,n] g[b,v,m]
        R_blend = torch.einsum("vj,bjmn->bvmn", W, A_rot)
        d_v = torch.einsum("bvmn,bvm->bvn", R_blend, g)
    if needs[1]:
        # d W[v,j] = sum_{b,m} g[b,v,m] (A_rot[b,j] @ v_posed[b,v] + A_t[b,j])[m]
        d_W = torch.einsum("bvm,bjmn,bvn->vj", g, A_rot, v_posed) + torch.einsum("bvm,bjm->vj", g, A_t)
    if needs[2]:
        # d A_rot[b,j,m,n] = sum_v W[v,j] g[b,v,m] v_posed[b,v,n]
        d_rot = torch.einsum("vj,bvm,bvn->bjmn", W, g, v_posed)
    if needs[3]:
        # d A_t[b,j,m] = sum_v W[v,j] g[b,v,m]
        d_t = torch.einsum("vj,bvm->bjm", W, g)
    return d_v, d_W, d_rot, d_t


class _Skinning(torch.autograd.Function):
    @staticmethod
    def forward(ctx, v_posed, lbs_weights, A_rot, A_t):
        ctx.save_for_backward(v_posed, lbs_weights, A_rot, A_t)
        return skinning_forward(v_posed, lbs_weights, A_rot, A_t)

    @staticmethod
    def backward(ctx, g):
        return skinning_backward(*ctx.saved_tensors, g.contiguous(), needs=ctx.needs_input_grad)


def skinning(v_posed, lbs_weights, A_rot, A_t):
    """Blend-skin posed vertices, differentiably.

    v_posed [B, V, 3], lbs_weights [V, 24], A_rot [B, 24, 3, 3] (rest-pose
    corrected joint rotations), A_t [B, 24, 3]; all float32 on one device
    (the kernel's type; the plain version on the CPU also takes float64).
    Returns [B, V, 3].
    """
    return _Skinning.apply(v_posed, lbs_weights, A_rot, A_t)
