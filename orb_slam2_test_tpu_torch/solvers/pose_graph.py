"""Essential-graph Sim(3) pose-graph optimization.

Port of orb_slam2_test_tpu/solvers/pose_graph.py (reference:
Optimizer::OptimizeEssentialGraph): after a loop closure, every
keyframe pose is a Sim3 node over the essential graph (spanning tree,
loop edges, strong covisibility edges), optimized by Levenberg-Marquardt
with a chi2-gated accept, then recovered as SE3.

The per-edge residual is r = log(S_ji S_iw S_jw^-1), its [E, 7, 14]
Jacobian one batched forward-mode pass over the 14 tangent directions
(`geometry.sim3.tangent_jacobian`), as the JAX package's vmapped
`jax.jacfwd`. Up to K = 512 keyframes the normal
equations are assembled dense, [7K, 7K], and solved by LU; above that a
block-Jacobi preconditioned CG of 100 iterations with an edge-wise
matvec takes over, the JAX package's switch (it changes results).
Every accept is a select: no value is read back to the host.
"""

from __future__ import annotations

import torch

from orb_slam2_test_tpu_torch.geometry.sim3 import (
    sim3_exp,
    sim3_inverse,
    sim3_log,
    tangent_jacobian,
)

DENSE_MAX_K = 512  # dense [7K, 7K] solve up to here, CG above
CG_ITERS = 100


def _edge_residual(xi: torch.Tensor, Siw, Sjw, Sji) -> torch.Tensor:
    """xi [..., E, 14] = (xi_i, xi_j) per edge -> [..., E, 7]."""
    Si = sim3_exp(xi[..., :7]) @ Siw
    Sj = sim3_exp(xi[..., 7:]) @ Sjw
    return sim3_log(Sji @ Si @ sim3_inverse(Sj))


def _residuals(Siw, Sjw, Sji) -> torch.Tensor:
    """[E, 7] residuals at the current nodes."""
    return sim3_log(Sji @ Siw @ sim3_inverse(Sjw))


def _index_add(n: int, idx: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """zeros(n, ...) with v added at idx; idx == n is dropped.

    On CUDA through index_put_'s accumulate, which sorts the indices
    and sums each row's terms in that order: index_add_'s atomics sum
    them in another order on every call, and 40 LM steps of an
    ill-conditioned graph spread that rounding to 1.6e-3 between two
    runs on the same inputs. On the CPU index_add_, a sequential sum."""
    out = v.new_zeros((n + 1,) + v.shape[1:])
    idx = idx.to(torch.int64)
    if v.is_cuda:
        return out.index_put_((idx,), v, accumulate=True)[:n]
    return out.index_add_(0, idx, v)[:n]


def optimize_essential_graph(
    Scw: torch.Tensor,  # [K, 4, 4] Sim3 world -> camera per keyframe
    node_valid: torch.Tensor,  # [K]
    node_fixed: torch.Tensor,  # [K] (the loop keyframe is held fixed)
    edge_i: torch.Tensor,  # [E] int
    edge_j: torch.Tensor,  # [E] int
    edge_Sji: torch.Tensor,  # [E, 4, 4] measured S_jw S_iw^-1
    edge_valid: torch.Tensor,  # [E]
    edge_weight: torch.Tensor,  # [E] information scale
    iters: int = 40,
    fix_scale: bool = False,
    lambda_init: float = 1e-4,
) -> torch.Tensor:
    """Returns the optimized Scw [K, 4, 4]. A rejected step keeps the
    poses and raises lambda (x4), an accepted one lowers it (x0.5), so
    the iteration never makes the graph worse."""
    K = Scw.shape[0]
    dev, dt = Scw.device, Scw.dtype
    ei = edge_i.to(torch.int64)
    ej = edge_j.to(torch.int64)
    locked = node_fixed | ~node_valid
    w_edge = (edge_valid & node_valid[ei] & node_valid[ej]).to(dt) * edge_weight
    eye7 = torch.eye(7, dtype=dt, device=dev)
    xi0 = torch.zeros((ei.shape[0], 14), dtype=dt, device=dev)

    def total_chi2(S):
        r = _residuals(S[ei], S[ej], edge_Sji)
        r = torch.where(torch.isfinite(r), r, 1e6)
        return (w_edge * (r * r).sum(-1)).sum()

    li, lj = locked[ei], locked[ej]
    off = ~(li | lj)
    # 1e12 on the scale coordinate freezes every node's scale; made by a
    # select, since writing one element from the host synchronizes
    scale_fix = torch.diag_embed(torch.where(
        torch.arange(7, device=dev) == 6, 1e12 if fix_scale else 0.0, 0.0)).to(dt)

    lam = torch.full((), lambda_init, dtype=dt, device=dev)
    chi2 = total_chi2(Scw)
    for _ in range(iters):
        Siw, Sjw = Scw[ei], Scw[ej]
        r = _residuals(Siw, Sjw, edge_Sji)
        J = tangent_jacobian(lambda xi: _edge_residual(xi, Siw, Sjw, edge_Sji), xi0)
        Ji, Jj = J[..., :7], J[..., 7:]
        w = w_edge
        wJi = Ji * w[:, None, None]
        wJj = Jj * w[:, None, None]
        Hii = torch.einsum("eki,ekj->eij", Ji, wJi)
        Hjj = torch.einsum("eki,ekj->eij", Jj, wJj)
        Hij = torch.einsum("eki,ekj->eij", Ji, wJj)
        bi = -torch.einsum("eki,ek->ei", Ji, w[:, None] * r)
        bj = -torch.einsum("eki,ek->ei", Jj, w[:, None] * r)
        b = _index_add(K, torch.cat([ei, ej]), torch.cat([bi, bj]))
        b = torch.where(locked[:, None], 0.0, b)

        # diagonal blocks: damping and the block-Jacobi preconditioner
        Hdiag = _index_add(K, torch.cat([ei, ej]), torch.cat([Hii, Hjj]))
        dd = torch.diagonal(Hdiag, dim1=-2, dim2=-1)
        damp = lam * torch.clamp(dd, min=1e-8) + 1e-9
        Hdiag_d = Hdiag + torch.diag_embed(damp) + scale_fix
        Hdiag_d = torch.where(locked[:, None, None], eye7, Hdiag_d)
        Hij_m = torch.where(off[:, None, None], Hij, 0.0)

        if K <= DENSE_MAX_K:
            # the off-diagonal blocks of unlocked pairs scattered into
            # [K * K] (a locked end drops the write), then the damped
            # diagonal in place of the diagonal's sums
            cell_ij = torch.where(off, ei * K + ej, K * K)
            cell_ji = torch.where(off, ej * K + ei, K * K)
            H = _index_add(K * K, torch.cat([cell_ij, cell_ji]),
                           torch.cat([Hij_m, Hij_m.transpose(-1, -2)])).view(K, K, 7, 7)
            diag = torch.eye(K, dtype=torch.bool, device=dev)[:, :, None, None]
            H = torch.where(diag, Hdiag_d[:, None], H)
            Hd = H.permute(0, 2, 1, 3).reshape(K * 7, K * 7)
            dx = torch.linalg.solve_ex(Hd, b.reshape(K * 7, 1)).result.reshape(K, 7)
        else:
            Hdiag_mv = Hdiag_d - torch.where(locked[:, None, None], eye7, 0.0)

            def matvec(v):
                v = torch.where(locked[:, None], 0.0, v)
                out = torch.einsum("kij,kj->ki", Hdiag_mv, v)
                out = out + _index_add(K, torch.cat([ei, ej]), torch.cat([
                    torch.einsum("eij,ej->ei", Hij_m, v[ej]),
                    torch.einsum("eji,ej->ei", Hij_m, v[ei])]))
                return torch.where(locked[:, None], v, out)

            Minv = torch.linalg.inv_ex(Hdiag_d).inverse

            def precond(rr):
                return torch.einsum("kij,kj->ki", Minv, rr)

            x = torch.zeros((K, 7), dtype=dt, device=dev)
            rr = b - matvec(x)
            z = precond(rr)
            p = z
            rz = (rr * z).sum()
            for _ in range(CG_ITERS):
                Ap = matvec(p)
                den = (p * Ap).sum()
                alpha = rz / torch.where(den.abs() > 1e-20, den, 1e-20)
                x = x + alpha * p
                rr = rr - alpha * Ap
                z = precond(rr)
                rz2 = (rr * z).sum()
                beta = rz2 / torch.where(rz.abs() > 1e-20, rz, 1e-20)
                p = z + beta * p
                rz = rz2
            dx = x
        dx = torch.where(torch.isfinite(dx).all(), dx, 0.0)
        cand = sim3_exp(dx) @ Scw
        cand = torch.where(locked[:, None, None], Scw, cand)

        chi2_new = total_chi2(cand)
        accept = torch.isfinite(chi2_new) & (chi2_new <= chi2)
        Scw = torch.where(accept, cand, Scw)
        lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0), 1e-9, 1e6)
        chi2 = torch.where(accept, chi2_new, chi2)
    return Scw
