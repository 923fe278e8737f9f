"""Baseline registration: NDT and voxelized GICP — port of
``mulls_tpu/ops/baseline_reg.py``.

The reference program's vendored OpenMP baselines (`include/baseline_reg/`:
`ndt_omp.h:51-72` NDT with DIRECT1/DIRECT7 neighbour search,
`fast_vgicp.h:19-25` voxelized GICP, `voxel_grid_covariance_omp.h` per-voxel
Gaussians), selected with ``--baseline_reg_method=ndt|gicp``
(`mulls_slam.cpp:195-198,634-639`).

As in the JAX package, the kd-tree / sparse voxel map is a hashed voxel
table built by segment sums in one pass over the target cloud (order-fixed,
:func:`mulls_tpu_torch.ops.segment.segment_sum`, so a table repeats its
bits); a point's voxel lookup is a gather; each Gauss-Newton / Newton
iteration is a batched einsum that gives one 6x6 system, solved on the
device (``solve_ex``: no host sync).  The reference's ``lax.while_loop``
runs all ``max_iter`` iterations here under a done mask that freezes the
state and the iteration count once its condition is false, which equals
the early exit.

Hash collisions merge distinct voxels' statistics in both packages alike
(the same hash, :func:`mulls_tpu_torch.ops.voxel.hash_ijk`).  The source
covariances of GICP (:func:`point_covariances`) come from the query-centred
sums of ``kernels.pca_moments``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mulls_tpu_torch.core import se3
from mulls_tpu_torch.ops import kernels
from mulls_tpu_torch.ops import neighbors as nbr
from mulls_tpu_torch.ops.pca import eigh_sym3x3, morton_order
from mulls_tpu_torch.ops.segment import segment_sum
from mulls_tpu_torch.ops.voxel import hash_ijk

f32 = torch.float32


class VoxelTable(NamedTuple):
    """Per-slot Gaussian statistics of a point cloud on a voxel grid."""
    count: torch.Tensor    # [T]
    mean: torch.Tensor     # [T, 3]
    inv_cov: torch.Tensor  # [T, 3, 3] regularized inverse covariance
    cov: torch.Tensor      # [T, 3, 3]
    resolution: float


def _inv3x3(A: torch.Tensor) -> torch.Tensor:
    """Batched closed-form 3x3 inverse (adjugate / det)."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    co = torch.stack([
        e * i - f * h, c * h - b * i, b * f - c * e,
        f * g - d * i, a * i - c * g, c * d - a * f,
        d * h - e * g, b * g - a * h, a * e - b * d,
    ], dim=-1).reshape(A.shape)
    det = a * co[..., 0, 0] + b * co[..., 1, 0] + c * co[..., 2, 0]
    return co / torch.clamp(torch.abs(det), min=1e-12)[..., None, None] \
        * torch.sign(det)[..., None, None]


def _eye3(dev) -> torch.Tensor:
    return torch.eye(3, dtype=f32, device=dev)


def build_voxel_table(xyz: torch.Tensor, mask: torch.Tensor,
                      resolution: float, table_size: int = 1 << 17,
                      min_points: int = 6, mode: str = "ndt") -> VoxelTable:
    """One pass -> per-voxel (count, mean, covariance, inverse).

    ``mode='ndt'``: covariance eigenvalues floored at 1e-2 of the largest
    (`voxel_grid_covariance_omp` regularization).  ``mode='gicp'``:
    plane-regularized covariance C <- R diag(1,1,eps) R^T (fast_vgicp).
    The covariance is the reference's uncentred ``s2/n - mean mean^T`` per
    slot (colliding voxels merge as they do there)."""
    w = mask.to(f32)
    slot = hash_ijk(torch.floor(xyz / resolution).to(torch.int32),
                    table_size)
    count = segment_sum(w, slot, table_size)
    s1 = segment_sum(w[:, None] * xyz, slot, table_size)
    outer = xyz[:, :, None] * xyz[:, None, :]
    s2 = segment_sum(w[:, None, None] * outer, slot, table_size)
    n = torch.clamp(count, min=1.0)
    mean = s1 / n[:, None]
    cov = s2 / n[:, None, None] - mean[:, :, None] * mean[:, None, :]

    lam, V = eigh_sym3x3(cov)  # descending
    lam0 = torch.clamp(lam[:, :1], min=1e-6)
    if mode == "gicp":
        lam_r = torch.cat([torch.ones_like(lam[:, :2]),
                           torch.full_like(lam[:, 2:], 1e-3)], dim=-1)
    else:
        # NDT: floor eigenvalues at 1e-2 of the largest, keeping the
        # absolute scale (`voxel_grid_covariance_omp` semantics)
        lam_r = torch.maximum(lam, 1e-2 * lam0)
    cov_r = torch.einsum("tik,tk,tjk->tij", V, lam_r, V)
    inv = _inv3x3(cov_r + 1e-6 * _eye3(xyz.device))
    valid = count >= min_points
    inv = torch.where(valid[:, None, None], inv, 0.0)
    # under-populated voxels are unusable: a zero count excludes them from
    # every consumer's `count > 0` gate
    count = torch.where(valid, count, 0.0)
    return VoxelTable(count=count, mean=mean, inv_cov=inv, cov=cov_r,
                      resolution=float(resolution))


class BaselineResult(NamedTuple):
    transform: torch.Tensor   # [4,4]
    fitness: torch.Tensor     # mean per-point score / residual
    matched: torch.Tensor     # points in valid voxels (last iteration)
    iterations: torch.Tensor  # int32


_NEIGHBOR_OFFSETS = ((0, 0, 0), (1, 0, 0), (-1, 0, 0), (0, 1, 0),
                     (0, -1, 0), (0, 0, 1), (0, 0, -1))


def _offsets(direct7: bool, dev) -> torch.Tensor:
    offs = _NEIGHBOR_OFFSETS if direct7 else _NEIGHBOR_OFFSETS[:1]
    return torch.tensor(offs, dtype=torch.int32, device=dev)


def _jacobian(p_t: torch.Tensor) -> torch.Tensor:
    """[N, 3, 6]: d r / d x with r = p_t - mu, x = (t, omega) small-angle:
    dr/dt = I, dr/domega = -skew(p_t)."""
    sk = se3.skew(p_t)
    return torch.cat([_eye3(p_t.device).expand(sk.shape), -sk], dim=-1)


def _voxel_lookup(p_t, s_mask, table: VoxelTable, table_size: int,
                  offset: torch.Tensor):
    """(d = p_t - mu, inverse covariance, valid) of each point's voxel
    shifted by ``offset``."""
    ijk = torch.floor(p_t / table.resolution).to(torch.int32) + offset
    slot = hash_ijk(ijk, table_size)
    icov = table.inv_cov[slot]
    valid = s_mask & (table.count[slot] > 0) \
        & (torch.abs(icov).sum((-1, -2)) > 0)
    return p_t - table.mean[slot], icov, valid


def _gn_iteration(p_t: torch.Tensor, s_mask: torch.Tensor,
                  table: VoxelTable, table_size: int, offsets: torch.Tensor,
                  point_weight: torch.Tensor):
    """One Gauss-Newton accumulation against the voxel Gaussians.
    Returns (H [6,6], g [6], score, matched)."""
    dev = p_t.device
    H = torch.zeros((6, 6), dtype=f32, device=dev)
    g = torch.zeros((6,), dtype=f32, device=dev)
    score = torch.zeros((), dtype=f32, device=dev)
    matched = torch.zeros((), dtype=f32, device=dev)
    J = _jacobian(p_t)
    for k in range(offsets.shape[0]):
        d, icov, valid = _voxel_lookup(p_t, s_mask, table, table_size,
                                       offsets[k])
        icd = torch.einsum("nij,nj->ni", icov, d)
        md = torch.sum(d * icd, -1)
        # Gaussian score weight (IRLS): suppresses the pull of far
        # neighbour-voxel Gaussians (the role of Magnusson's d1/d2 mixture
        # in `ndt_omp_impl.hpp`)
        wg = torch.exp(-0.5 * torch.clamp(md, 0.0, 50.0))
        w = valid.to(f32) * point_weight * wg
        H = H + torch.einsum("n,nij,nik,nkl->jl", w, J, icov, J)
        g = g + torch.einsum("n,nij,ni->j", w, J, icd)
        score = score + torch.sum(w * md)
        matched = matched + torch.sum(valid)
    return H, g, score, matched


def _ndt_score(p_t: torch.Tensor, s_mask: torch.Tensor, table: VoxelTable,
               table_size: int, offsets: torch.Tensor) -> torch.Tensor:
    """Score-only pass (negative Gaussian mixture likelihood proxy): lower
    is better.  The step-size control guards this objective against
    over-stepping (the role of the reference's More-Thuente line search,
    `ndt_omp_impl.hpp`)."""
    score = torch.zeros((), dtype=f32, device=p_t.device)
    for k in range(offsets.shape[0]):
        d, icov, valid = _voxel_lookup(p_t, s_mask, table, table_size,
                                       offsets[k])
        md = torch.einsum("ni,nij,nj->n", d, icov, d)
        # negative Gaussian: bounded, so outliers cannot dominate
        score = score - torch.sum(
            valid * torch.exp(-0.5 * torch.clamp(md, 0.0, 50.0)))
    return score


def _iterate(body, init_guess: torch.Tensor, max_iter: int
             ) -> BaselineResult:
    """The reference's ``while_loop`` with ``cond = (it < max_iter) &
    ((it < 2) | (dn > 1e-4))``: ``max_iter`` iterations of ``body(T) ->
    (T_new, fitness, matched, dn)``, each kept only while the condition
    holds, so the state and the count freeze where the loop would exit."""
    dev = init_guess.device
    it = torch.zeros((), dtype=torch.int32, device=dev)
    T = init_guess.to(f32)
    fit = torch.zeros((), dtype=f32, device=dev)
    matched = torch.zeros((), dtype=f32, device=dev)
    dn = torch.ones((), dtype=f32, device=dev)
    for _ in range(max_iter):
        live = (it < 2) | (dn > 1e-4)
        T_n, fit_n, matched_n, dn_n = body(T)
        T = torch.where(live, T_n, T)
        fit = torch.where(live, fit_n, fit)
        matched = torch.where(live, matched_n, matched)
        dn = torch.where(live, dn_n, dn)
        it = it + live.to(torch.int32)
    T = torch.cat([torch.cat([se3.orthonormalize(T[:3, :3]), T[:3, 3:]],
                             dim=1), T[3:]], dim=0)
    return BaselineResult(transform=T, fitness=fit, matched=matched,
                          iterations=it)


def _solve6(H: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """delta = -H^-1 g on the device (``solve_ex`` checks nothing on the
    host)."""
    return torch.linalg.solve_ex(H, -g[:, None])[0][:, 0]


def ndt_register(s_xyz: torch.Tensor, s_mask: torch.Tensor,
                 table: VoxelTable, init_guess: torch.Tensor,
                 max_iter: int = 30, table_size: int = 1 << 17,
                 direct7: bool = True,
                 step_control: bool = True) -> BaselineResult:
    """NDT: Newton iterations on the sum of per-voxel Mahalanobis scores
    (`ndt_omp_impl.hpp` simplified to the quadratic model).

    ``step_control`` stands in for More-Thuente: each iteration evaluates
    the mixture score at step fractions {1, 1/2, 1/4} and takes the best,
    so a step that would regress the score is halved."""
    dev = s_xyz.device
    offs = _offsets(direct7, dev)
    ones = torch.ones_like(s_mask, dtype=f32)
    eye6 = torch.eye(6, dtype=f32, device=dev)
    alphas = torch.tensor([1.0, 0.5, 0.25], dtype=f32, device=dev)

    def body(T):
        p_t = se3.transform_points(T, s_xyz)
        H, g, score, matched = _gn_iteration(p_t, s_mask, table, table_size,
                                             offs, ones)
        delta = _solve6(H + 1e-3 * eye6, g)
        if step_control:
            # halving only: the mixture score is flat far from alignment,
            # so a zero step could stall a cold start that the Newton
            # direction would fix
            scores = torch.stack([
                _ndt_score(se3.transform_points(
                    se3.se3_boxplus(T, a * delta), s_xyz), s_mask, table,
                    table_size, offs) for a in alphas])
            alpha = alphas[torch.argmin(scores)]
            T_new = se3.se3_boxplus(T, alpha * delta)
            dn = torch.linalg.norm(delta) * alpha
        else:
            T_new = se3.se3_boxplus(T, delta)
            dn = torch.linalg.norm(delta)
        return T_new, score / torch.clamp(matched, min=1.0), matched, dn

    return _iterate(body, init_guess, max_iter)


def vgicp_register(s_xyz: torch.Tensor, s_mask: torch.Tensor,
                   s_cov: torch.Tensor, table: VoxelTable,
                   init_guess: torch.Tensor, max_iter: int = 30,
                   table_size: int = 1 << 17) -> BaselineResult:
    """Voxelized GICP (`fast_vgicp_impl.hpp` behaviour): distribution-to-
    distribution residual r = mu_b - T p_a with weight
    M = (C_b + R C_a R^T)^-1, Gauss-Newton on SE(3)."""
    dev = s_xyz.device
    eye6 = torch.eye(6, dtype=f32, device=dev)

    def body(T):
        R = T[:3, :3]
        p_t = se3.transform_points(T, s_xyz)
        slot = hash_ijk(torch.floor(p_t / table.resolution).to(torch.int32),
                        table_size)
        mu = table.mean[slot]
        Cb = table.cov[slot]
        w = (s_mask & (table.count[slot] > 0)).to(f32)
        Ca_rot = torch.einsum("ij,njk,lk->nil", R, s_cov, R)
        M = _inv3x3(Cb + Ca_rot + 1e-6 * _eye3(dev))
        d = p_t - mu
        # robust (Geman-McClure-style) reweighting: hash-collision voxels
        # and boundary mismatches otherwise pull with unbounded leverage
        md_w = torch.einsum("ni,nij,nj->n", d, M, d)
        w = w * 9.0 / (9.0 + md_w)
        J = _jacobian(p_t)
        H = torch.einsum("n,nij,nik,nkl->jl", w, J, M, J) + 1e-3 * eye6
        Md = torch.einsum("nij,nj->ni", M, d)
        g = torch.einsum("n,nij,ni->j", w, J, Md)
        delta = _solve6(H, g)
        fit = torch.sum(w * torch.sum(d * Md, -1)) \
            / torch.clamp(torch.sum(w), min=1.0)
        return (se3.se3_boxplus(T, delta), fit, torch.sum(w),
                torch.linalg.norm(delta))

    return _iterate(body, init_guess, max_iter)


def point_covariances(xyz: torch.Tensor, mask: torch.Tensor, radius: float
                      ) -> torch.Tensor:
    """[N, 3, 3] neighbourhood covariances for the GICP source side,
    plane-regularized like fast_vgicp (eigenvalues -> (1, 1, 1e-3)).

    The sums are ``kernels.pca_moments``' count, sum(p - q) and
    sum((p - q)(p - q)^T), centred at each query, with the queries in
    Morton order (the kernel's tiles want neighbouring queries) and the
    order undone after; the covariance S2/n - (S1/n)(S1/n)^T equals the
    reference's from uncentred sums in exact arithmetic, without their
    cancellation at tens of metres.  As in ``ops.pca.pca_features``, the
    closed-form eigh runs in float64."""
    order = morton_order(xyz)
    q = xyz[order].contiguous()
    r2 = torch.full((xyz.shape[0],), radius * radius, dtype=f32,
                    device=xyz.device)
    cnt, s1, s2 = kernels.pca_moments(q, xyz.contiguous(),
                                      mask.contiguous(), r2)
    qf = mask[order].to(f32)
    cov_sorted = nbr.cov_from_moments(cnt * qf, s1 * qf[:, None],
                                      s2 * qf[:, None])
    cov = torch.empty_like(cov_sorted)
    cov[order] = cov_sorted
    lam, V = eigh_sym3x3(cov.double())  # descending
    lam_r = torch.cat([torch.ones_like(lam[:, :2]),
                       torch.full_like(lam[:, 2:], 1e-3)], dim=-1)
    return torch.einsum("nik,nk,njk->nij", V, lam_r, V).to(f32)
