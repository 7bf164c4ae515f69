"""SMPL / SMPL-H body model: batched linear blend skinning in torch.

Port of vistracker_tpu/core/smpl.py: shape blendshapes, pose-corrective
blendshapes and translation; returns (verts, joints, v_posed, naked). The
kinematic chain is composed by pointer doubling over the tree (O(log
depth) batched 4x4 products), the same schedule as the JAX package.
"""
from __future__ import annotations

import dataclasses
import pickle

import numpy as np
import torch

from .rotations import axis_angle_to_rotmat

SMPLH_NUM_JOINTS = 52

SMPL_PARENTS = (0, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9,
                12, 13, 14, 16, 17, 18, 19, 20, 21)
SMPLH_PARENTS = SMPL_PARENTS[:22] + (
    20, 22, 23, 20, 25, 26, 20, 28, 29, 20, 31, 32, 20, 34, 35,
    21, 37, 38, 21, 40, 41, 21, 43, 44, 21, 46, 47, 21, 49, 50)


@dataclasses.dataclass(frozen=True)
class SMPLModel:
    """SMPL(-H) template constants; tensors share one device."""

    v_template: torch.Tensor   # (V, 3)
    shapedirs: torch.Tensor    # (V, 3, S)
    posedirs: torch.Tensor     # (V, 3, 9*(J-1))
    j_regressor: torch.Tensor  # (J, V)
    weights: torch.Tensor      # (V, J)
    parents: tuple
    faces: np.ndarray          # (F, 3) int32
    gender: str = "neutral"

    @property
    def num_joints(self) -> int:
        return len(self.parents)


def _tree_depth(parents) -> int:
    depth = 0
    for j in range(len(parents)):
        d, k = 0, j
        while k != 0:
            k = parents[k]
            d += 1
        depth = max(depth, d)
    return depth


def _chain_transforms(rel: torch.Tensor, parents) -> torch.Tensor:
    """Compose relative joint transforms (B, J, 4, 4) into global ones,
    G_j = G_parent(j) @ rel_j, by pointer doubling: a virtual identity
    node J absorbs chains that reached the root."""
    J = rel.shape[1]
    eye = torch.eye(4, dtype=rel.dtype, device=rel.device).expand(
        rel.shape[0], 1, 4, 4)
    g = torch.cat([rel, eye], dim=1)
    ptr = np.asarray([J if p < 0 or j == 0 else p
                      for j, p in enumerate(parents)] + [J], np.int64)
    rounds = max(1, int(np.ceil(np.log2(max(_tree_depth(parents), 1) + 1))))
    for _ in range(rounds):
        g = g[:, torch.from_numpy(ptr).to(rel.device)] @ g
        ptr = ptr[ptr]
    return g[:, :J]


def lbs_forward(model: SMPLModel, pose: torch.Tensor, betas: torch.Tensor,
                trans: torch.Tensor):
    """Batched SMPL(-H) forward: pose (B, 3J) axis-angle, betas (B, S')
    with S' <= S, trans (B, 3) -> verts (B, V, 3), joints (B, J, 3),
    v_posed (B, V, 3), naked (B, V, 3)."""
    B = pose.shape[0]
    J = model.num_joints
    rotmats = axis_angle_to_rotmat(pose.reshape(B, J, 3))
    nb = betas.shape[-1]
    v_shaped = model.v_template + torch.einsum(
        "vks,bs->bvk", model.shapedirs[:, :, :nb], betas)
    joints0 = torch.einsum("jv,bvk->bjk", model.j_regressor, v_shaped)

    eye3 = torch.eye(3, dtype=rotmats.dtype, device=rotmats.device)
    pose_map = (rotmats[:, 1:] - eye3).reshape(B, 9 * (J - 1))
    naked = v_shaped + torch.einsum("vkp,bp->bvk", model.posedirs, pose_map)

    parent_idx = torch.as_tensor(model.parents, device=pose.device)
    rel_t = joints0 - joints0[:, parent_idx]
    rel_t = torch.cat([joints0[:, :1], rel_t[:, 1:]], dim=1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=rotmats.dtype,
                          device=rotmats.device).expand(B, J, 1, 4)
    rel = torch.cat([torch.cat([rotmats, rel_t[..., None]], dim=-1), bottom],
                    dim=-2)

    g = _chain_transforms(rel, model.parents)
    joints_global = g[:, :, :3, 3]
    rot_g = g[:, :, :3, :3]
    t_skin = joints_global - torch.einsum("bjik,bjk->bji", rot_g, joints0)
    g_skin = torch.cat([rot_g, t_skin[..., None]], dim=-1)   # (B, J, 3, 4)
    t_vert = torch.einsum("vj,bjrc->bvrc", model.weights, g_skin)
    verts = (torch.einsum("bvrc,bvc->bvr", t_vert[..., :3], naked)
             + t_vert[..., 3])
    # without per-vertex offsets v_posed is the naked posed template
    return (verts + trans[:, None, :], joints_global + trans[:, None, :],
            naked, naked)


class _ChumpyUnpickler(pickle.Unpickler):
    """Unpickles SMPL pkl files without chumpy: chumpy.Ch objects become
    stubs whose .r is the wrapped ndarray."""

    class _ChStub:
        def __setstate__(self, state):
            self.__dict__.update(state)

        @property
        def r(self):
            return np.asarray(self.__dict__.get("x"))

    def find_class(self, module, name):
        if module.startswith("chumpy"):
            return _ChumpyUnpickler._ChStub
        return super().find_class(module, name)


def _to_np(x) -> np.ndarray:
    if hasattr(x, "r"):
        x = x.r
    if hasattr(x, "toarray"):
        x = x.toarray()
    return np.asarray(x)


def load_smpl_pkl(path: str, device="cpu") -> SMPLModel:
    """Load a SMPL/SMPL-H (chumpy) pkl into an SMPLModel on `device`."""
    with open(path, "rb") as f:
        data = _ChumpyUnpickler(f, encoding="latin1").load()
    parents = tuple(int(p) for p in
                    np.asarray(data["kintree_table"])[0].tolist())
    parents = (0,) + parents[1:] if parents[0] != 0 else parents
    # released models mark the root with 2**32 - 1
    parents = tuple(0 if (p >= len(parents) or p < 0) else p for p in parents)
    posedirs = _to_np(data["posedirs"]).astype(np.float32)
    if posedirs.ndim == 3:
        posedirs = posedirs.reshape(posedirs.shape[0], 3, -1)

    def t(name):
        return torch.as_tensor(_to_np(data[name]).astype(np.float32),
                               device=device)

    return SMPLModel(
        v_template=t("v_template"), shapedirs=t("shapedirs"),
        posedirs=torch.as_tensor(posedirs, device=device),
        j_regressor=t("J_regressor"), weights=t("weights"),
        parents=parents, faces=_to_np(data["f"]).astype(np.int32),
        gender=str(data.get("gender", "neutral")))


def random_smpl_model(rng=0, num_joints: int = SMPLH_NUM_JOINTS,
                      num_verts: int = 256, num_betas: int = 10,
                      device="cpu") -> SMPLModel:
    """Small synthetic model with valid structure (same draws as the JAX
    package's random_smpl_model for the same seed)."""
    rs = np.random.RandomState(rng) if isinstance(rng, int) else rng
    parents = SMPLH_PARENTS if num_joints == SMPLH_NUM_JOINTS \
        else SMPL_PARENTS
    f32 = np.float32
    v_template = rs.randn(num_verts, 3).astype(f32) * 0.3
    shapedirs = rs.randn(num_verts, 3, num_betas).astype(f32) * 0.01
    posedirs = rs.randn(num_verts, 3, 9 * (num_joints - 1)).astype(f32) \
        * 0.001
    j_reg = rs.rand(num_joints, num_verts).astype(f32)
    j_reg /= j_reg.sum(1, keepdims=True)
    w = rs.rand(num_verts, num_joints).astype(f32) ** 4
    w /= w.sum(1, keepdims=True)
    faces = rs.randint(0, num_verts, (2 * num_verts, 3)).astype(np.int32)

    def t(a):
        return torch.as_tensor(a, device=device)

    return SMPLModel(v_template=t(v_template), shapedirs=t(shapedirs),
                     posedirs=t(posedirs), j_regressor=t(j_reg),
                     weights=t(w), parents=parents, faces=faces)
