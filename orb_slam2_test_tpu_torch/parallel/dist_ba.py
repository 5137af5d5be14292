"""Distributed bundle adjustment: a point-sharded Schur complement with
preconditioned CG, its reductions through `torch.distributed`.

Port of orb_slam2_test_tpu/parallel/dist_ba.py (the reference has no
distributed anything: its concurrency is 4 pthreads over one map).
The camera-point graph is partitioned by point: each shard owns a
contiguous block of points and every observation of them; the cameras
are replicated. One LM iteration:

    local:  linearize the shard's observations; the point blocks Hpp,
            bp, Hpp^-1 and the per-observation cross blocks Wcp
            [O, 6, 3], never scattered to [Q, C];
    psum:   one fused [C, 48] reduction of Hcc (36) | bc (6) | the
            Schur rhs correction W Hpp^-1 bp (6); then one [C, 6]
            reduction per Schur matvec, S v = Hcc v - W Hpp^-1 W^T v
            through local index adds; then the scalar cost;
    replicated: the CG state ([C, 6] vectors and scalars) is the same
            on every shard, so control flow needs no other collective.
            The preconditioner is block-Jacobi on the damped Hcc
            blocks, inverted in closed form (`inv6x6_spd`).

At cg_iters CG iterations that is 1 + (cg_iters + 1) + 1 collectives
per LM iteration (15 at the default 12: the matvec at x = 0 counts; the
JAX module's docstring says 14). The carried cost starts at inf, so the
first LM step is always accepted, as in the JAX program.

A mesh (`BAMesh`) has two forms. With `torch.distributed` initialized
it spans the process group, one shard per rank, and `_psum` is an
all-reduce. Otherwise it is one process holding every shard on its one
device: the local work runs shard by shard with the arithmetic a rank
would do, and `_psum` adds the shards in rank order (the counterpart of
the JAX tests' 8-device virtual CPU mesh). Nothing falls back: a card
asked for without one raises, and a distributed psum never becomes a
local sum. Every accept is a select on a 0-d tensor; nothing is read
back to the host.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from orb_slam2_test_tpu_torch.geometry.camera import PinholeCamera
from orb_slam2_test_tpu_torch.geometry.linalg import inv3x3, inv6x6_spd
from orb_slam2_test_tpu_torch.geometry.robust import (
    HUBER_MONO,
    HUBER_STEREO,
    huber_loss,
    huber_weight,
)
from orb_slam2_test_tpu_torch.geometry.se3 import se3_exp
from orb_slam2_test_tpu_torch.solvers.ba_core import BAProblem
from orb_slam2_test_tpu_torch.solvers.reprojection import project_residual
from orb_slam2_test_tpu_torch.utils.scatter import segment_sum

@dataclass(frozen=True)
class BAMesh:
    """A one-axis mesh of `size` shards on `device`: distributed, one
    shard per rank of the default process group (this process holds
    shard `rank`), or one process holding all of them."""

    size: int
    device: torch.device
    distributed: bool = False
    rank: int = 0

    @property
    def local_shards(self) -> int:
        return 1 if self.distributed else self.size


class CallCounter:
    """Counts the calls of one function; a caller may reset it to 0."""

    def __init__(self):
        self.calls = 0


PSUM = CallCounter()


def _checked_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "a BA mesh on device 'cuda' needs a CUDA card and none is available; "
                "pass device='cpu' to run on the CPU")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


def distributed() -> bool:
    """Whether `torch.distributed` is initialized in this process."""
    return dist.is_available() and dist.is_initialized()


def make_ba_mesh(n_devices: int | None = None, device: torch.device | str = "cuda") -> BAMesh:
    """The mesh of the distributed BA. With `torch.distributed`
    initialized: one shard per rank of the default group (n_devices
    None or the world size). Otherwise one process holding n_devices
    shards (default 1) on `device`."""
    device = _checked_device(device)
    if distributed():
        world = dist.get_world_size()
        if n_devices is not None and n_devices != world:
            raise ValueError(
                f"torch.distributed spans {world} ranks; a mesh of {n_devices} shards "
                "cannot be made in a distributed run")
        return BAMesh(world, device, True, dist.get_rank())
    return BAMesh(1 if n_devices is None else int(n_devices), device)


def _psum(parts: list[torch.Tensor], mesh: BAMesh) -> torch.Tensor:
    """The one collective: the sum over the mesh's shards. Distributed:
    `parts` is this rank's one tensor, all-reduced in place over the
    group; one process: the shards' tensors added in rank order."""
    PSUM.calls += 1
    if mesh.distributed:
        if len(parts) != 1:
            raise ValueError(f"a rank holds one shard, got {len(parts)}")
        dist.all_reduce(parts[0])
        return parts[0]
    out = parts[0]
    for x in parts[1:]:
        out = out + x
    return out


def _cam_for_obs(cam: PinholeCamera, obs_cam: torch.Tensor) -> PinholeCamera:
    """Per-observation intrinsics: fields that are [C] tensors (a joint
    BA over sequences with their own calibrations) are gathered by the
    observation's camera; scalar fields pass through."""

    def g(f):
        return f[obs_cam.long()] if torch.is_tensor(f) and f.dim() >= 1 else f

    return cam._replace(fx=g(cam.fx), fy=g(cam.fy), cx=g(cam.cx), cy=g(cam.cy), bf=g(cam.bf))


def shard_problem(prob: BAProblem, n_shards: int) -> BAProblem:
    """Repartition a problem so points and their observations are
    blocked by shard (a numpy copy on the host): point q belongs to
    shard q // qs with qs = ceil(Q / n); the valid observations are
    grouped by owning shard and padded to the largest shard's count.

    Returns a BAProblem with n * qs point rows and n * os observation
    rows, obs_pt local to its shard (% qs); padded observations have
    obs_pt 0 and are invalid. The cameras pass through."""
    Q = prob.pt_xyz.shape[0]
    qs = -(-Q // n_shards)  # points per shard
    Qp = qs * n_shards

    def host(x):
        return x.detach().cpu().numpy()

    pt_xyz = np.zeros((Qp, 3), np.float32)
    pt_xyz[:Q] = host(prob.pt_xyz)
    pt_valid = np.zeros((Qp,), bool)
    pt_valid[:Q] = host(prob.pt_valid)

    obs_pt = host(prob.obs_pt)
    obs_valid = host(prob.obs_valid)
    obs_shard = obs_pt // qs
    order = np.argsort(obs_shard, kind="stable")
    counts = np.bincount(obs_shard[obs_valid], minlength=n_shards)
    os_ = int(max(counts.max(), 1))
    Op = os_ * n_shards

    def pad_gather(a, fill=0):
        a = host(a)
        out = np.full((Op,) + a.shape[1:], fill, a.dtype)
        for s in range(n_shards):
            sel = order[obs_shard[order] == s]
            sel = sel[obs_valid[sel]]
            n = min(len(sel), os_)
            out[s * os_ : s * os_ + n] = a[sel[:n]]
        return out

    dev = prob.pt_xyz.device

    def t(a):
        return torch.from_numpy(a).to(dev)

    return BAProblem(
        cam_Tcw=prob.cam_Tcw,
        cam_fixed=prob.cam_fixed,
        pt_xyz=t(pt_xyz),
        pt_valid=t(pt_valid),
        obs_cam=t(pad_gather(prob.obs_cam)),
        obs_pt=t(pad_gather(prob.obs_pt) % qs),
        obs_uvr=t(pad_gather(prob.obs_uvr)),
        obs_isig2=t(pad_gather(prob.obs_isig2)),
        obs_valid=t(pad_gather(prob.obs_valid, fill=False)),
    )


class _Shard(NamedTuple):
    """One shard's points and observations (obs_pt local), with its
    per-observation intrinsics and Huber thresholds."""

    pt_valid: torch.Tensor
    oc: torch.Tensor  # [Os] int64 camera
    op: torch.Tensor  # [Os] int64 local point
    obs_uvr: torch.Tensor
    obs_isig2: torch.Tensor
    obs_valid: torch.Tensor
    cam: PinholeCamera  # fields scalar or [Os]
    delta: torch.Tensor  # [Os] Huber threshold, stereo or mono


class _Local(NamedTuple):
    """One shard's linearization: the point system and the cross blocks."""

    Wcp: torch.Tensor  # [Os, 6, 3]
    Hpp_inv: torch.Tensor  # [Qs, 3, 3]
    bp: torch.Tensor  # [Qs, 3]
    seen: torch.Tensor  # [Qs] bool
    packed: torch.Tensor  # [C, 48]: Hcc | bc | W Hpp^-1 bp


def _shards(prob: BAProblem, cam: PinholeCamera, n: int) -> tuple[list, list]:
    """Split the rows of a sharded problem into n shards: (shards, pt_xyz
    blocks)."""
    qs = prob.pt_xyz.shape[0] // n
    os_ = prob.obs_cam.shape[0] // n
    shards, pts = [], []
    for s in range(n):
        q, o = slice(s * qs, (s + 1) * qs), slice(s * os_, (s + 1) * os_)
        oc = prob.obs_cam[o].long()
        uvr = prob.obs_uvr[o]
        shards.append(_Shard(
            pt_valid=prob.pt_valid[q], oc=oc, op=prob.obs_pt[o].long(), obs_uvr=uvr,
            obs_isig2=prob.obs_isig2[o], obs_valid=prob.obs_valid[o],
            cam=_cam_for_obs(cam, oc),
            delta=torch.where(uvr[..., 2] >= 0.0, HUBER_STEREO, HUBER_MONO)))
        pts.append(prob.pt_xyz[q])
    return shards, pts


def _local_system(sh: _Shard, cam_Tcw, cam_fixed, pt_xyz, lam) -> _Local:
    """The shard's point system first, owned locally with no
    communication, so the camera quantities that depend on it ride in
    the one fused [C, 48] reduction with Hcc and bc."""
    C, Qs = cam_Tcw.shape[0], pt_xyz.shape[0]
    res = project_residual(sh.cam, cam_Tcw[sh.oc], pt_xyz[sh.op], sh.obs_uvr, sh.obs_isig2)
    w_huber = huber_weight(res.chi2, sh.delta)
    w = torch.where(sh.obs_valid & res.depth_ok, w_huber * sh.obs_isig2, 0.0)
    Jc = torch.where(cam_fixed[sh.oc, None, None], 0.0, res.Jc)
    Jp = torch.where(sh.pt_valid[sh.op, None, None], res.Jp, 0.0)
    wJc = Jc * w[:, None, None]
    wJp = Jp * w[:, None, None]
    wr = w[:, None] * res.r

    Hpp = segment_sum(Qs, sh.op, torch.einsum("oki,okj->oij", Jp, wJp))
    bp = segment_sum(Qs, sh.op, -torch.einsum("oki,ok->oi", Jp, wr))
    dHp = lam * torch.clamp(torch.diagonal(Hpp, dim1=-2, dim2=-1), min=1e-6)
    Hpp_d = Hpp + torch.diag_embed(dHp)
    seen = segment_sum(Qs, sh.op, w) > 0.0
    eye3 = torch.eye(3, dtype=Hpp.dtype, device=Hpp.device)
    Hpp_inv = inv3x3(torch.where(seen[:, None, None], Hpp_d, eye3))
    Wcp = torch.einsum("oki,okj->oij", Jc, wJp)  # [O, 6, 3], never [Q, C]

    yb = torch.einsum("qij,qj->qi", Hpp_inv, bp)
    Hcc = segment_sum(C, sh.oc, torch.einsum("oki,okj->oij", Jc, wJc))
    bc = segment_sum(C, sh.oc, -torch.einsum("oki,ok->oi", Jc, wr))
    rcor = segment_sum(C, sh.oc, torch.einsum("oij,oj->oi", Wcp, yb[sh.op]))
    packed = torch.cat([Hcc.reshape(C, 36), bc, rcor], dim=1)
    return _Local(Wcp, Hpp_inv, bp, seen, packed)


def _local_wtw(sh: _Shard, loc: _Local, v: torch.Tensor) -> torch.Tensor:
    """The shard's W Hpp^-1 W^T v through index adds: [C, 6]."""
    u = segment_sum(loc.bp.shape[0], sh.op, torch.einsum("oji,oj->oi", loc.Wcp, v[sh.oc]))
    y = torch.einsum("qij,qj->qi", loc.Hpp_inv, u)
    return segment_sum(v.shape[0], sh.oc, torch.einsum("oij,oj->oi", loc.Wcp, y[sh.op]))


def _local_dxp(sh: _Shard, loc: _Local, dxc: torch.Tensor) -> torch.Tensor:
    """The shard's point back-substitution Hpp^-1 (bp - W^T dxc)."""
    u = segment_sum(loc.bp.shape[0], sh.op, torch.einsum("oji,oj->oi", loc.Wcp, dxc[sh.oc]))
    dxp = torch.einsum("qij,qj->qi", loc.Hpp_inv, loc.bp - u)
    dxp = torch.where((loc.seen & sh.pt_valid)[:, None], dxp, 0.0)
    return torch.where(torch.isfinite(dxp).all(), dxp, 0.0)


def _local_cost(sh: _Shard, cam_Tcw, pt_xyz) -> torch.Tensor:
    res = project_residual(sh.cam, cam_Tcw[sh.oc], pt_xyz[sh.op], sh.obs_uvr, sh.obs_isig2)
    c = huber_loss(res.chi2, sh.delta)
    return torch.where(sh.obs_valid & res.depth_ok, c, 0.0).sum()


def _lm_iter(shards, mesh, cam_Tcw, cam_fixed, pts, lam, cost, cg_iters):
    """One LM iteration: the local systems, the fused reduction, PCG on
    the reduced camera system, the back-substitution and the cost, and
    the accept select (the damping halves on accept, quadruples on
    reject, within [1e-9, 1e6])."""
    C = cam_Tcw.shape[0]
    fix = cam_fixed
    locs = [_local_system(sh, cam_Tcw, fix, x, lam) for sh, x in zip(shards, pts)]
    packed = _psum([loc.packed for loc in locs], mesh)
    Hcc = packed[:, :36].reshape(C, 6, 6)
    bc = packed[:, 36:42]
    rhs_cor = packed[:, 42:48]
    dHc = lam * torch.clamp(torch.diagonal(Hcc, dim1=-2, dim2=-1), min=1e-6)
    Hcc_d = Hcc + torch.diag_embed(dHc)

    def schur_matvec(v):  # v [C, 6], replicated
        v = torch.where(fix[:, None], 0.0, v)
        hv = torch.einsum("cij,cj->ci", Hcc_d, v)
        wv = _psum([_local_wtw(sh, loc, v) for sh, loc in zip(shards, locs)], mesh)
        return torch.where(fix[:, None], v, hv - wv)

    rhs = torch.where(fix[:, None], 0.0, bc - rhs_cor)
    eye6 = torch.eye(6, dtype=Hcc.dtype, device=Hcc.device)
    Minv = torch.where(fix[:, None, None], eye6, inv6x6_spd(Hcc_d + 1e-6 * eye6))

    x = torch.zeros_like(rhs)
    r = rhs - schur_matvec(x)
    z = torch.einsum("cij,cj->ci", Minv, r)
    p = z
    rz = (r * z).sum()
    for _ in range(cg_iters):
        Ap = schur_matvec(p)
        denom = (p * Ap).sum()
        alpha = rz / torch.where(denom.abs() > 1e-20, denom, 1e-20)
        x = x + alpha * p
        r = r - alpha * Ap
        z = torch.einsum("cij,cj->ci", Minv, r)
        rz_new = (r * z).sum()
        beta = rz_new / torch.where(rz.abs() > 1e-20, rz, 1e-20)
        p = z + beta * p
        rz = rz_new
    dxc = torch.where(torch.isfinite(x).all(), x, 0.0)
    dxc = torch.where(fix[:, None], 0.0, dxc)

    new_pts = [x_ + _local_dxp(sh, loc, dxc) for sh, loc, x_ in zip(shards, locs, pts)]
    new_Tcw = torch.where(fix[:, None, None], cam_Tcw, se3_exp(dxc) @ cam_Tcw)
    new_cost = _psum([_local_cost(sh, new_Tcw, x_) for sh, x_ in zip(shards, new_pts)], mesh)
    accept = new_cost < cost
    cam_Tcw = torch.where(accept, new_Tcw, cam_Tcw)
    pts = [torch.where(accept, a, b) for a, b in zip(new_pts, pts)]
    lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0), 1e-9, 1e6)
    return cam_Tcw, pts, lam, torch.where(accept, new_cost, cost)


def dist_bundle_adjust(
    prob: BAProblem,
    cam: PinholeCamera,
    mesh: BAMesh,
    iters: int = 10,
    lam0: float = 1e-4,
    cg_iters: int = 12,
):
    """LM bundle adjustment with point-sharded implicit-Schur PCG.

    `prob` comes from shard_problem(mesh.size): in the one-process form
    all of it, in the distributed form this rank's block
    (`multihost.make_global_problem`). `cam`'s fields are numbers or [C]
    tensors. Returns (cam_Tcw, pt_xyz, cost): pt_xyz sharded, this
    rank's block or, in the one-process form, [size * qs, 3]."""
    shards, pts = _shards(prob, cam, mesh.local_shards)
    cam_Tcw = prob.cam_Tcw
    lam = torch.full((), lam0, dtype=cam_Tcw.dtype, device=cam_Tcw.device)
    cost = torch.full((), float("inf"), dtype=cam_Tcw.dtype, device=cam_Tcw.device)
    for _ in range(iters):
        cam_Tcw, pts, lam, cost = _lm_iter(shards, mesh, cam_Tcw, prob.cam_fixed, pts, lam,
                                           cost, cg_iters)
    return cam_Tcw, (torch.cat(pts) if len(pts) > 1 else pts[0]), cost
