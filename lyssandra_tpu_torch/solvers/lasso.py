"""Batched convex sparse solvers: feature-sign search (lasso) and FISTA
(``lyssandra_tpu.solvers.lasso`` counterpart: ``feature_sign``/``lasso``
and ``fista``).

Feature-sign search (Lee, Battle, Raina, Ng, NIPS 2006) solves

    min_g ||x - D g||^2 + lam * ||g||_1

for thousands of signals at once.  The active set lives in a fixed
capacity of ``max_active`` slots per lane; activation and deactivation
toggle slot masks; the minimizer over the active set is a warm-started
masked CG on the active Gram; the discrete line search over sign flips
scores every candidate crossing of a lane at once.  Lanes freeze through a
``done`` mask when their KKT conditions hold.

Every ``lax.while_loop`` of the reference is a Python loop here with the
same exit rule, so the trip counts are the reference's; each exit check
that reads a device value is one host sync (``host_syncs`` counts them).

The first ``cold_unroll`` activations run as the unrolled growing-width
cold start (``_fs_unrolled_state``); on a GPU the fused CUDA kernel
``ops/cuda_fs.py`` computes the same state (``cold_backend``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from lyssandra_tpu_torch._device import resolve_device
from lyssandra_tpu_torch.solvers.greedy import _argmax_first, _as_f32


class FeatureSignResult(NamedTuple):
    Gamma: torch.Tensor      # (K, N) dense codes
    n_iter: int              # outer iterations executed
    done: torch.Tensor       # (N,) per-lane convergence flag
    overflow: torch.Tensor   # (N,) lane wanted > max_active active atoms


def _host(t: torch.Tensor) -> np.ndarray:
    """t on the host: a device-to-host sync when t lies on a GPU.  Every
    data-dependent decision of the solvers reads its value through here,
    so ``host_syncs()`` counts them."""
    _host.count += 1
    return t.cpu().numpy()


_host.count = 0


def _host_bool(t: torch.Tensor) -> bool:
    return bool(_host(t))


def host_syncs() -> int:
    """Device values the solvers have read on the host so far in this
    process (each one a sync on a GPU)."""
    return _host.count


def _active_mask(idx: torch.Tensor, mask: torch.Tensor, K: int):
    """(N, K) active-atom membership mask from per-lane slots.

    The reference picks between a scatter (CPU) and an (N, A, K)
    compare-reduce (TPU) that give the same mask.  The port keeps the
    scatter on every device: the compare-reduce materializes N*A*K
    booleans (134 MB at 2048 x 64 x 1024).  Integer scatter-add makes
    repeated slot ids (inactive slots hold id 0) an exact OR."""
    counts = torch.zeros(idx.shape[0], K, dtype=torch.int32,
                         device=idx.device)
    counts.scatter_add_(1, idx.long(), mask.to(torch.int32))
    return counts > 0


def _top_k_first(A: torch.Tensor, k: int):
    """``lax.top_k`` along dim 1: the k largest values in descending
    order, the lower index first among equal values."""
    if k == 1:
        i = _argmax_first(A).long()[:, None]
        return A.gather(1, i), i
    vals, ids = torch.sort(A, dim=1, descending=True, stable=True)
    return vals[:, :k], ids[:, :k]


def _dense(idx, mask, gact, K):
    """(N, K) dense codes from per-lane slots."""
    z = torch.zeros(idx.shape[0], K, dtype=gact.dtype, device=gact.device)
    return z.scatter_add_(1, idx.long(), torch.where(mask, gact, 0.0))


def _fs_loop(Dt, Xt, A0, lam, state, *, max_active, max_iter, max_inner,
             max_cg=32, n_activate=1):
    """Up to ``max_iter`` outer feature-sign iterations from ``state``: one
    segment of ``feature_sign`` (the reference's ``_feature_sign_impl``,
    which only jit-compiles this function).

    Dt = D^T (K, p); Xt = X^T (N, p); A0 = X^T D (N, K).  ``state`` is
    (idx, mask, theta, gact, gr, done, overflow, it) with gr the gradient
    at the current point, zero at active slots (every function that makes a
    state upholds that invariant; it doubles as the activation score).
    Returns (state, result, all_done): all_done says the loop ended because
    every lane was done, so a following segment would run no iteration."""
    N, K = A0.shape
    A = max_active
    dt = A0.dtype
    thr = lam * (1.0 + 1e-4) + 1e-7

    def outer_step(st):
        idx, mask, theta, gact, gr, done, overflow, it = st
        # activation: the top n_activate KKT violators (active slots carry
        # 0 in gr and never clear the positive threshold), each into the
        # first free slot; a lane with no free slot still refines
        vals, kstars = _top_k_first(gr.abs(), n_activate)
        idx2, mask2, theta2, gact2 = idx, mask, theta, gact
        for j in range(n_activate):
            kj = kstars[:, j]
            has_cand = vals[:, j] > thr
            free = (~mask2).to(torch.uint8).argmax(dim=1)   # first free
            no_free = mask2.all(dim=1)
            activate = has_cand & ~done & ~no_free
            slot_hot = (torch.nn.functional.one_hot(free, A).bool()
                        & activate[:, None])
            idx2 = torch.where(slot_hot, kj[:, None].to(torch.int32), idx2)
            mask2 = mask2 | slot_hot
            gr_at = gr.gather(1, kj[:, None])[:, 0]
            theta2 = torch.where(slot_hot, -torch.sign(gr_at)[:, None],
                                 theta2)
            gact2 = torch.where(slot_hot, 0.0, gact2)

        # idx is constant through the refinement loop: the active-set
        # geometry is built once per outer iteration
        Dact = Dt[idx2.long()]                              # (N, A, p)
        M = Dact @ Dact.transpose(1, 2)                     # (N, A, A)
        a0all = (Dact @ Xt[:, :, None])[:, :, 0]            # (N, A)

        def active_mv(g):
            return (M @ g[:, :, None])[:, :, 0]

        def kkt_from_H(mask, theta, Hg, tol=5e-6):
            # active-set KKT residual from the cached matvec Hg = M g
            maskf = mask.to(dt)
            viol = ((2.0 * (Hg - a0all) * maskf + lam * theta).abs()
                    * maskf)
            return (viol > tol).any(dim=1) & mask.any(dim=1)

        def masked_solve(maskf, rhs, gwarm):
            """Solve (mask M mask + (1-mask) I + 1e-6 I) g = rhs by CG,
            warm-started."""

            def op(v):
                return (maskf * active_mv(v * maskf) + (1.0 - maskf) * v
                        + 1e-6 * v)

            x = gwarm * maskf
            r = rhs - op(x)
            pv = r
            rs = (r * r).sum(dim=1)
            i = 0
            while i < max_cg and _host_bool((rs > 1e-12).any()):
                Mp = op(pv)
                al = rs / ((pv * Mp).sum(dim=1) + 1e-30)
                x = x + al[:, None] * pv
                r = r - al[:, None] * Mp
                rs2 = (r * r).sum(dim=1)
                pv = r + (rs2 / (rs + 1e-30))[:, None] * pv
                rs = rs2
                i += 1
            return x * maskf

        def inner_step(mask, theta, gact, Hg):
            """One feature-sign refinement over the active set."""
            maskf = mask.to(dt)
            a0sel = a0all * maskf
            rhs = (a0sel - lam * theta / 2.0) * maskf
            gnew = masked_solve(maskf, rhs, gact)
            Hnew = active_mv(gnew)

            # discrete line search over the zero crossings of
            # g + t (gnew - g), with the smooth part as the quadratic
            # q(t) = t (2 diff.Hg - 2 diff.a0) + t^2 diff.Hd
            diff = gnew - gact
            Hd = Hnew - Hg
            big = diff.abs() > 1e-15
            tcross = torch.where(
                big, -gact / torch.where(big, diff, 1.0), -1.0)
            valid_t = (tcross > 0.0) & (tcross < 1.0) & mask
            ts = torch.cat([torch.ones(N, 1, dtype=dt, device=diff.device),
                            torch.where(valid_t, tcross, 1.0)], dim=1)
            b = 2.0 * ((diff * Hg).sum(dim=1) - (diff * a0sel).sum(dim=1))
            c = (diff * Hd).sum(dim=1)
            l1 = ((gact[:, None, :] + ts[..., None] * diff[:, None, :]).abs()
                  * maskf[:, None, :]).sum(dim=2)
            obj = ts * b[:, None] + ts * ts * c[:, None] + lam * l1
            best = _argmax_first(-obj).long()      # first minimum wins
            tbest = ts.gather(1, best[:, None])[:, 0]
            gbest = gact + tbest[:, None] * diff
            Hbest = Hg + tbest[:, None] * Hd

            # deactivate zeroed coefficients
            mask2 = mask & (gbest.abs() >= 1e-12)
            gact2 = torch.where(mask2, gbest, 0.0)
            theta2 = torch.where(mask2, torch.sign(gbest), 0.0)
            return (mask2, theta2, gact2, Hbest,
                    kkt_from_H(mask2, theta2, Hbest))

        Hg3 = active_mv(gact2)
        mask3, theta3, gact3 = mask2, theta2, gact2
        not_opt = kkt_from_H(mask3, theta3, Hg3)
        iref = 0
        while iref < max_inner and _host_bool(not_opt.any()):
            mask3, theta3, gact3, Hg3, not_opt = inner_step(
                mask3, theta3, gact3, Hg3)
            iref += 1

        # full KKT check: the zero-coefficient condition and active-set
        # stationarity at the done tolerance 1e-4; the gradient comes from
        # the gathered active atoms, D g = Dact^T gact
        R3 = (torch.where(mask3, gact3, 0.0)[:, None, :] @ Dact)[:, 0] - Xt
        gr3 = 2.0 * (R3 @ Dt.T)
        grm3 = torch.where(_active_mask(idx2, mask3, K), 0.0, gr3)
        inact_viol3 = grm3.abs() > thr
        opt = ~inact_viol3.any(dim=1) & ~kkt_from_H(mask3, theta3, Hg3,
                                                    tol=1e-4)
        # terminal overflow: after refinement the lane still wants a new
        # atom and has no slot for it
        ovf = overflow | (inact_viol3.any(dim=1) & mask3.all(dim=1) & ~done)
        done2 = done | opt | ovf

        # frozen lanes keep their previous state
        def fz(new, old):
            return torch.where(done[:, None], old, new)

        return (fz(idx2, idx), fz(mask3, mask), fz(theta3, theta),
                fz(gact3, gact), fz(grm3, gr), done2, ovf, it + 1)

    st = state
    it0 = st[-1]
    all_done = False
    while st[-1] - it0 < max_iter:
        if _host_bool(st[5].all()):
            all_done = True
            break
        st = outer_step(st)
    idx, mask, theta, gact, gr, done, overflow, it = st
    gfull = _dense(idx, mask, gact, K)
    return st, FeatureSignResult(gfull.T, it, done, overflow), all_done


def _fs_init(A0, lam, A):
    """Cold state: empty active set; lanes where g = 0 already satisfies
    the KKT conditions (|2 D^T x| <= lam everywhere) are done."""
    N = A0.shape[0]
    dev, dt = A0.device, A0.dtype
    done0 = (2.0 * A0.abs() <= lam + 1e-12).all(dim=1)
    return (
        torch.zeros(N, A, dtype=torch.int32, device=dev),
        torch.zeros(N, A, dtype=torch.bool, device=dev),
        torch.zeros(N, A, dtype=dt, device=dev),
        torch.zeros(N, A, dtype=dt, device=dev),
        -2.0 * A0,          # gradient at g = 0
        done0,
        torch.zeros(N, dtype=torch.bool, device=dev),
        0,
    )


def _fs_fista_iterate(D, Xt, A0, lam, *, n_warm):
    """The warm-start FISTA iterate G0^T (N, K)."""
    N, K = A0.shape
    G0 = _fista_body(D, Xt.T, A0.T, lam,
                     torch.zeros(K, N, dtype=A0.dtype, device=A0.device),
                     n_warm)
    return G0.T


def _fs_sig_nnz(G0t):
    """Per-lane count of significant warm coefficients, |g| above 1e-3 of
    the lane's max, and that cut."""
    mx = G0t.abs().amax(dim=1, keepdim=True)
    tau = torch.clamp_min(1e-3 * mx, 1e-12)
    return (G0t.abs() > tau).sum(dim=1), tau


def _fs_omp_seed_iterate(D, Xt, n_atoms: int):
    """OMP-seeded warm iterate G0^T (N, K): ``batch_omp`` at T=n_atoms
    (the fused kernel on a GPU)."""
    from lyssandra_tpu_torch.solvers.greedy import batch_omp

    return batch_omp(D, Xt.T, int(n_atoms)).T


def _fs_warm_state(G0t, Dt, Xt, A0, lam, *, max_active, gate=True):
    """Feature-sign state seeded from a warm iterate G0t (N, K): its top
    significant coefficients take the first slots.  ``gate``: only lanes
    whose iterate has a small support are seeded (the rest start cold);
    otherwise every lane seeds its top few atoms and keeps join
    headroom."""
    N, K = A0.shape
    A = max_active
    dev = A0.device
    kk = min(A, K)                     # capacity can exceed tiny K
    vals, idx = _top_k_first(G0t.abs(), kk)
    if kk < A:
        vals = torch.nn.functional.pad(vals, (0, A - kk))
        idx = torch.nn.functional.pad(idx, (0, A - kk))
    idx = idx.to(torch.int32)
    nnz_lane, tau = _fs_sig_nnz(G0t)
    mask = vals > tau
    if gate:
        lane_ok = nnz_lane <= A - max(1, A // 8)
        mask = mask & lane_ok[:, None]
    else:
        slot_cap = torch.arange(A, device=dev)[None, :] < (A - max(2, A // 8))
        mask = mask & slot_cap
    gact = torch.where(mask, G0t.gather(1, idx.long()), 0.0)
    theta = torch.where(mask, torch.sign(gact), 0.0)
    # gradient at the representable warm point, zero at active slots
    R = _dense(idx, mask, gact, K) @ Dt - Xt
    gr = 2.0 * (R @ Dt.T)
    gr = torch.where(_active_mask(idx, mask, K), 0.0, gr)
    # a lane where g = 0 is optimal is done at once only if its warm state
    # is zero (a done lane keeps its state)
    done0 = (2.0 * A0.abs() <= lam + 1e-12).all(dim=1) & ~mask.any(dim=1)
    return (idx, mask, theta, gact, gr, done0,
            torch.zeros(N, dtype=torch.bool, device=dev), 0)


def _fs_unrolled_state(Dt, Xt, A0, lam, *, t_unroll, n_refine,
                       max_active):
    """Unrolled growing-width cold start: the first ``t_unroll``
    activations, each step sized to the true active width c = t + 1 (a
    (c+1)-iteration masked CG on (N, c, c) systems, closed form at c = 1;
    a line search over c+1 candidates), with ``n_refine`` fixed
    refinements per step.  Lanes whose full KKT conditions hold are done
    and freeze at their post-activation, pre-refinement state.

    Returns the ``_fs_loop`` state padded to ``max_active`` slots, so the
    optimum and every exit criterion are those of the cold path.  This is
    the plain version of the fused kernel (``ops/cuda_fs.py``)."""
    N, K = A0.shape
    dev, dt = A0.device, A0.dtype
    thr = lam * (1.0 + 1e-4) + 1e-7

    done = (2.0 * A0.abs() <= lam + 1e-12).all(dim=1)
    gr = -2.0 * A0                      # gradient at g = 0

    def zeros(*shape, dtype=dt):
        return torch.zeros(*shape, dtype=dtype, device=dev)

    idx = zeros(N, 0, dtype=torch.int32)
    mask = zeros(N, 0, dtype=torch.bool)
    theta = zeros(N, 0)
    gact = zeros(N, 0)
    a0sel = zeros(N, 0)
    Dstack = zeros(N, 0, Dt.shape[1])
    Gsel = zeros(N, 0, 0)

    def masked_cg(M, maskf, rhs, x0, iters):
        # the fixed point of _fs_loop's masked_solve, at a fixed trip count
        def op(v):
            Mv = (M @ (v * maskf)[:, :, None])[:, :, 0]
            return maskf * Mv + (1.0 - maskf) * v + 1e-6 * v

        x = x0 * maskf
        r = rhs - op(x)
        pv = r
        rs = (r * r).sum(dim=1)
        for _ in range(iters):
            Mp = op(pv)
            al = rs / ((pv * Mp).sum(dim=1) + 1e-30)
            x = x + al[:, None] * pv
            r = r - al[:, None] * Mp
            rs2 = (r * r).sum(dim=1)
            pv = r + (rs2 / (rs + 1e-30))[:, None] * pv
            rs = rs2
        return x * maskf

    for t in range(t_unroll):
        # --- activation: the single largest inactive KKT violator (gr is
        # zero at active slots) ---
        cand = gr.abs()
        k = _argmax_first(cand)
        mx = cand.gather(1, k.long()[:, None])[:, 0]
        activate = (mx > thr) & ~done
        livef = activate.to(dt)
        dk = Dt[k.long()] * livef[:, None]                  # (N, p)
        a0k = (dk * Xt).sum(dim=1)              # inert slot: all-zero
        gr_at = gr.gather(1, k.long()[:, None])[:, 0]
        thk = -torch.sign(gr_at) * livef

        # --- grow the compact active geometry by one slot ---
        dkk = (dk * dk).sum(dim=1)
        if t == 0:
            Gsel = dkk[:, None, None]
        else:
            cross = (Dstack @ dk[:, :, None])[:, :, 0]      # (N, t)
            Gsel = torch.cat([
                torch.cat([Gsel, cross[:, :, None]], dim=2),
                torch.cat([cross[:, None, :], dkk[:, None, None]], dim=2),
            ], dim=1)
        Dstack = torch.cat([Dstack, dk[:, None, :]], dim=1)
        idx = torch.cat(
            [idx, torch.where(activate, k, 0)[:, None].to(torch.int32)],
            dim=1)
        mask0 = torch.cat([mask, activate[:, None]], dim=1)
        theta0 = torch.cat([theta, thk[:, None]], dim=1)
        gact0 = torch.cat([gact, zeros(N, 1)], dim=1)
        a0sel = torch.cat([a0sel, a0k[:, None]], dim=1)
        c = t + 1

        # --- n_refine fixed feature-sign refinements at width c ---
        mask2, theta2, gact2 = mask0, theta0, gact0
        Hg = (Gsel @ gact2[:, :, None])[:, :, 0]
        for _ in range(n_refine):
            maskf = mask2.to(dt)
            a0m = a0sel * maskf
            rhs = (a0m - lam * theta2 / 2.0) * maskf
            if c == 1:
                gnew = rhs / (Gsel[:, :, 0] + 1e-6) * maskf
            else:
                gnew = masked_cg(Gsel, maskf, rhs, gact2, c + 1)
            Hnew = (Gsel @ gnew[:, :, None])[:, :, 0]

            # discrete line search over zero crossings (_fs_loop's, at
            # compact width)
            diff = gnew - gact2
            Hd = Hnew - Hg
            big = diff.abs() > 1e-15
            tcross = torch.where(
                big, -gact2 / torch.where(big, diff, 1.0), -1.0)
            valid_t = (tcross > 0.0) & (tcross < 1.0) & mask2
            ts = torch.cat([zeros(N, 1) + 1.0,
                            torch.where(valid_t, tcross, 1.0)], dim=1)
            b = 2.0 * ((diff * Hg).sum(dim=1) - (diff * a0m).sum(dim=1))
            cq = (diff * Hd).sum(dim=1)
            l1 = ((gact2[:, None, :] + ts[..., None] * diff[:, None, :])
                  .abs() * maskf[:, None, :]).sum(dim=2)
            obj = ts * b[:, None] + ts * ts * cq[:, None] + lam * l1
            best = _argmax_first(-obj).long()      # first minimum wins
            tbest = ts.gather(1, best[:, None])[:, 0]
            gbest = gact2 + tbest[:, None] * diff
            Hg = Hg + tbest[:, None] * Hd

            mask2 = mask2 & (gbest.abs() >= 1e-12)
            gact2 = torch.where(mask2, gbest, 0.0)
            theta2 = torch.where(mask2, torch.sign(gbest), 0.0)

        # --- full gradient (compact residual form) + full KKT check ---
        maskf = mask2.to(dt)
        R = ((gact2 * maskf)[:, None, :] @ Dstack)[:, 0] - Xt
        gr_new = 2.0 * (R @ Dt.T)                           # (N, K)
        grm = torch.where(_active_mask(idx, mask2, K), 0.0, gr_new)
        inact_viol = (grm.abs() > thr).any(dim=1)
        act_viol = ((2.0 * (Hg - a0sel * maskf) * maskf + lam * theta2)
                    .abs() * maskf > 1e-4).any(dim=1)
        opt = ~inact_viol & ~act_viol

        # --- freeze done lanes at their pre-refinement state ---
        def fz(new, old):
            return torch.where(done[:, None], old, new)

        mask = fz(mask2, mask0)
        theta = fz(theta2, theta0)
        gact = fz(gact2, gact0)
        gr = fz(grm, gr)
        done = done | opt

    return _pad_handoff(idx, mask, theta, gact, gr, done,
                        max_active=max_active)


def _pad_handoff(idx, mask, theta, gact, gr, done, *, max_active):
    """The compact cold-start state (N, Tun) padded to ``max_active``
    slots, as an ``_fs_loop`` state after Tun iterations."""
    pad = (0, max_active - idx.shape[1])
    F = torch.nn.functional
    return (F.pad(idx, pad), F.pad(mask, pad), F.pad(theta, pad),
            F.pad(gact, pad), gr, done,
            torch.zeros_like(done), idx.shape[1])


def _fs_unrolled_state_fused(Dt, Xt, A0, lam, *, t_unroll, n_refine,
                             max_active):
    """``_fs_unrolled_state`` computed by the fused kernel
    (``ops/cuda_fs.fs_cold_fused``; its plain version for CPU tensors).
    The kernel computes A0 itself; the argument keeps the two cold starts'
    common signature."""
    from lyssandra_tpu_torch.ops.cuda_fs import fs_cold_fused

    idx, mask, theta, gact, gr, done = fs_cold_fused(
        Dt.T, Xt.T, lam=float(lam), t_unroll=int(t_unroll),
        n_refine=int(n_refine))
    return _pad_handoff(idx, mask, theta, gact, gr, done,
                        max_active=max_active)


def _fs_cold_supported(D: torch.Tensor, X: torch.Tensor,
                       t_unroll: int) -> bool:
    """The fused cold-start kernel takes the call: CUDA tensors, float32
    and a shape inside its envelope (decided before launch)."""
    from lyssandra_tpu_torch.ops.cuda_fs import kernel_supports

    return (
        X.is_cuda and D.is_cuda
        and D.dtype == torch.float32 and X.dtype == torch.float32
        and kernel_supports(D.shape[0], D.shape[1], t_unroll)
    )


def _gather_lanes(state, sel, pad_done):
    """The lanes ``sel`` of a loop state; padding lanes marked done."""
    st = tuple(s[sel] if isinstance(s, torch.Tensor) else s for s in state)
    return st[:5] + (st[5] | pad_done,) + st[6:]


def feature_sign(
    D, X, lam: float,
    *, max_active: int = 64, max_iter: int = 100, max_inner: int = 6,
    full_result: bool = False, polish: bool = True,
    compact_stragglers: bool = False, warm_start: int = 4,
    warm_seed: str = "omp",
    auto_capacity: bool = False, max_cg: int = 32, n_activate: int = 1,
    cold_unroll: int | None = None, n_refine: int = 2,
    cold_backend: str | None = None, device=None,
):
    """Batched feature-sign search (oracle.feature_sign / oracle.lasso).

    Solves min_g ||x - D g||^2 + lam ||g||_1 per column of X (p, N) over D
    (p, K).  Returns the dense codes Gamma (K, N), or a FeatureSignResult
    with convergence and overflow flags when full_result=True.  Inputs go
    to ``device`` (default: where the first tensor input lies, else the
    GPU; see ``_device.resolve_device``).

    Options, each the reference's with the same optimum at every setting
    (only the iteration count changes):

    - ``polish``: lanes not done (limit cycles on dense solutions) or
      overflowed are re-solved by FISTA-500 and the better objective wins.
    - ``compact_stragglers``: after each segment, lanes still running are
      gathered into a narrow power-of-two batch (at least 256) when they
      are at most half of it.
    - ``warm_start`` / ``warm_seed``: "omp" seeds the active set from
      ``batch_omp`` at T=warm_start; "fista" from warm_start FISTA
      iterations; 0 is the plain cold start.
    - ``cold_unroll`` / ``n_refine``: the first cold_unroll activations run
      as the unrolled growing-width cold start, ``n_refine`` refinements
      per step; it takes precedence over warm seeding.  None: 28 on a GPU,
      0 on the CPU (the reference's 28 on a TPU, 0 elsewhere).
    - ``cold_backend``: what computes that cold start.  "pallas" (the
      reference's name) is the fused kernel, ``ops/cuda_fs.py``, where it
      takes the shape on a GPU, and its plain version on the CPU; "xla"
      is ``_fs_unrolled_state``.  None: the kernel on a GPU (the kernel
      builds in seconds here, so the reference's compile-cost reason for
      "xla" does not apply), "xla" on the CPU.
    - ``auto_capacity``: run at 16 slots and re-solve lanes that overflow
      them exactly at ``max_active``.
    - ``n_activate`` / ``max_cg`` / ``max_inner``: activations per outer
      iteration, CG iterations per solve, refinements per outer iteration.

    The outer iterations run in segments of 16, 32, then 64 at most
    (``max_iter`` in all).
    """
    if max_iter < 1:
        raise ValueError(f"max_iter must be >= 1, got {max_iter}")
    if cold_backend not in (None, "xla", "pallas"):
        raise ValueError(
            f"cold_backend must be None, 'xla' or 'pallas': {cold_backend!r}")
    if warm_seed not in ("omp", "fista"):
        raise ValueError(f"warm_seed must be 'omp' or 'fista': {warm_seed!r}")
    device = resolve_device(device, D, X)
    D = _as_f32(D, device)
    X = _as_f32(X, device)
    lam = float(lam)
    Dt, Xt = D.T, X.T
    A0 = X.T @ D
    N = A0.shape[0]
    on_gpu = D.is_cuda
    if cold_unroll is None:
        cold_unroll = 28 if on_gpu else 0
    if cold_backend is None:
        cold_backend = "pallas" if on_gpu else "xla"
    seg_plan = []
    left, s = max_iter, min(16, max_iter)
    while left > 0:
        take = min(s, left)
        seg_plan.append(take)
        left -= take
        s = min(2 * s, 64)
    A_run = 16 if (auto_capacity and max_active > 16) else max_active
    if cold_unroll and cold_unroll > 0:
        t_unroll = min(int(cold_unroll), A_run)
        fused = cold_backend == "pallas" and (
            not on_gpu or _fs_cold_supported(D, X, t_unroll))
        cold_start = (_fs_unrolled_state_fused if fused
                      else _fs_unrolled_state)
        state = cold_start(Dt, Xt, A0, lam, t_unroll=t_unroll,
                        n_refine=int(n_refine), max_active=A_run)
    elif warm_start and warm_start > 0:
        if warm_seed == "omp":
            G0t = _fs_omp_seed_iterate(D, Xt, warm_start)
        else:
            G0t = _fs_fista_iterate(D, Xt, A0, lam, n_warm=int(warm_start))
        state = _fs_warm_state(G0t, Dt, Xt, A0, lam, max_active=A_run,
                               gate=(A_run == max_active))
    else:
        state = _fs_init(A0, lam, A_run)
    seg = dict(max_active=A_run, max_inner=max_inner, max_cg=max_cg,
               n_activate=n_activate)
    state, res, all_done = _fs_loop(Dt, Xt, A0, lam, state,
                                    max_iter=seg_plan[0], **seg)
    lanes = None            # narrow-batch lane ids (None = full width)
    Xt_n, A0_n = Xt, A0
    for seg_i in seg_plan[1:]:
        if all_done:        # every later segment would run no iteration
            break
        if compact_stragglers:
            bad = _host(~state[5])      # still running
            nbad = int(bad.sum())
            if nbad == 0:
                break
            cur = state[0].shape[0]
            if nbad <= cur // 2:
                cols = np.where(bad)[0]
                width = 256
                while width < nbad:
                    width *= 2
                sel = np.zeros(width, np.int64)
                sel[:nbad] = cols
                selt = torch.from_numpy(sel).to(D.device)
                pad_done = torch.from_numpy(
                    np.arange(width) >= nbad).to(D.device)
                state = _gather_lanes(state, selt, pad_done)
                Xt_n = Xt_n[selt]
                A0_n = A0_n[selt]
                lanes = cols if lanes is None else lanes[cols]
        state, res_n, all_done = _fs_loop(Dt, Xt_n, A0_n, lam, state,
                                          max_iter=seg_i, **seg)
        if lanes is None:
            res = res_n
        else:
            nb = len(lanes)
            lt = torch.from_numpy(lanes).to(D.device)
            Gamma = res.Gamma.clone()
            Gamma[:, lt] = res_n.Gamma[:, :nb]
            done = res.done.clone()
            done[lt] = res_n.done[:nb]
            overflow = res.overflow.clone()
            overflow[lt] = res_n.overflow[:nb]
            res = FeatureSignResult(Gamma, res_n.n_iter, done, overflow)
    if A_run < max_active and _host_bool(res.overflow.any()):
        # reduced-capacity overflow is this run's artifact: re-solve those
        # lanes exactly at the full capacity (a power-of-two width)
        cols = np.where(_host(res.overflow))[0]
        nb = len(cols)
        width = 256
        while width < nb:
            width *= 2
        width = min(width, N)
        sel = np.zeros(width, np.int64)
        sel[:nb] = cols
        sub = feature_sign(
            D, X[:, torch.from_numpy(sel).to(D.device)], lam,
            max_active=max_active, max_iter=max_iter, max_inner=max_inner,
            full_result=True, polish=False, warm_start=warm_start,
            warm_seed=warm_seed, auto_capacity=False, max_cg=max_cg,
            n_activate=n_activate, cold_unroll=cold_unroll,
            n_refine=n_refine, cold_backend=cold_backend)
        ct = torch.from_numpy(cols).to(D.device)
        Gamma = res.Gamma.clone()
        Gamma[:, ct] = sub.Gamma[:, :nb]
        done = res.done.clone()
        done[ct] = sub.done[:nb]
        overflow = res.overflow.clone()
        overflow[ct] = sub.overflow[:nb]
        res = FeatureSignResult(Gamma, res.n_iter, done, overflow)
    if polish:
        res = _fs_polish(D, X, lam, res)
    return res if full_result else res.Gamma


lasso = feature_sign


def feature_sign_scan(
    D, X, lam: float,
    *, max_active: int = 64, max_iter: int = 60, max_inner: int = 6,
    warm_start: int = 0, warm_seed: str = "omp", max_cg: int = 32,
    n_activate: int = 1, cold_unroll: int = 0, n_refine: int = 2,
    device=None,
):
    """Feature-sign in one loop of up to ``max_iter`` outer iterations,
    then a FISTA-100 polish from the current codes, kept lane by lane where
    its objective is lower, for lanes not done or overflowed.  Returns
    Gamma (K, N).  The online learner codes every minibatch with it.

    The seeds: ``cold_unroll > 0`` the plain unrolled cold start
    (``_fs_unrolled_state``, never the kernel); else ``warm_start > 0``
    with ``warm_seed`` "omp" (the plain residual-form OMP at T=warm_start)
    or "fista" (the FISTA iterate); else the empty active set.  The
    reference's loop decides on the device; here each exit check is a host
    sync (``host_syncs``), and one more decides whether to polish."""
    if max_iter < 1:
        raise ValueError(f"max_iter must be >= 1, got {max_iter}")
    if warm_seed not in ("omp", "fista"):
        raise ValueError(f"warm_seed must be 'omp' or 'fista': {warm_seed!r}")
    device = resolve_device(device, D, X)
    D = _as_f32(D, device)
    X = _as_f32(X, device)
    lam = float(lam)
    Dt, Xt = D.T, X.T
    A0 = X.T @ D
    if cold_unroll and cold_unroll > 0:
        state = _fs_unrolled_state(
            Dt, Xt, A0, lam, t_unroll=min(int(cold_unroll), max_active),
            n_refine=int(n_refine), max_active=max_active)
    elif warm_start and warm_start > 0:
        if warm_seed == "omp":
            from lyssandra_tpu_torch.solvers.greedy import _omp_impl

            G0t = _omp_impl(D, X, 0.0, T=int(warm_start),
                            eps_mode=False).dense(D.shape[1]).T
        else:
            G0t = _fs_fista_iterate(D, Xt, A0, lam, n_warm=int(warm_start))
        state = _fs_warm_state(G0t, Dt, Xt, A0, lam, max_active=max_active)
    else:
        state = _fs_init(A0, lam, max_active)
    _, res, _ = _fs_loop(Dt, Xt, A0, lam, state, max_active=max_active,
                         max_iter=max_iter, max_inner=max_inner,
                         max_cg=max_cg, n_activate=n_activate)
    bad = ~res.done | res.overflow
    G = res.Gamma
    if not _host_bool(bad.any()):
        return G
    Gf = _fista_body(D, X, A0.T, lam, G, n_iter=100)

    def obj(Gm):
        R = X - D @ Gm
        return (R * R).sum(dim=0) + lam * Gm.abs().sum(dim=0)

    take_f = bad & (obj(Gf) < obj(G))
    return torch.where(take_f[None, :], Gf, G)


def _fs_polish(D, X, lam, res: FeatureSignResult) -> FeatureSignResult:
    """FISTA-500 polish of lanes that are not done or overflowed, kept
    where its objective is lower.  The reference decides on the device
    (``lax.cond``); here it is one host sync per call."""
    bad = ~res.done | res.overflow
    if not _host_bool(bad.any()):
        return res
    Gf = fista(D, X, lam, n_iter=500)

    def obj(Gm):
        R = X - D @ Gm
        return (R * R).sum(dim=0) + lam * Gm.abs().sum(dim=0)

    take_f = bad & (obj(Gf) < obj(res.Gamma))
    return FeatureSignResult(
        torch.where(take_f[None, :], Gf, res.Gamma), res.n_iter,
        res.done | take_f, res.overflow & ~take_f)


def _fista_body(D, X, A0, lam, g0, n_iter: int):
    """FISTA from g0 with a power-iterated step bound; A0 = D^T X (K, N).
    Gradients use the residual form 2 D^T (D y - x)."""
    K = D.shape[1]

    def gram_mv(v):
        return D.T @ (D @ v)

    v = torch.ones(K, dtype=D.dtype, device=D.device) / np.sqrt(K)
    for _ in range(16):
        w = gram_mv(v)
        v = w / torch.clamp_min(torch.linalg.norm(w), 1e-12)
    lmax = torch.dot(v, gram_mv(v))
    # power iteration underestimates lmax; the 1.1 margin keeps L an
    # upper bound
    L = 2.2 * lmax + 1e-6

    def shrink(v, t):
        return torch.sign(v) * torch.clamp_min(v.abs() - t, 0.0)

    # the momentum scalar in float32, as the reference carries it
    g, y, t = g0, g0, np.float32(1.0)
    one, half, four = np.float32(1.0), np.float32(0.5), np.float32(4.0)
    for _ in range(n_iter):
        grad = 2.0 * (gram_mv(y) - A0)
        gnew = shrink(y - grad / L, lam / L)
        tnew = half * (one + np.sqrt(one + four * t * t))
        y = gnew + ((t - 1.0) / tnew) * (gnew - g)
        g, t = gnew, tnew
    return g


def fista(D, X, lam: float, n_iter: int = 200, *, device=None):
    """FISTA (Beck & Teboulle 2009) for ||x - Dg||^2 + lam ||g||_1, all
    lanes at once.  Returns Gamma (K, N)."""
    device = resolve_device(device, D, X)
    D = _as_f32(D, device)
    X = _as_f32(X, device)
    A0 = D.T @ X
    g0 = torch.zeros(D.shape[1], X.shape[1], dtype=D.dtype, device=D.device)
    return _fista_body(D, X, A0, float(lam), g0, n_iter)
