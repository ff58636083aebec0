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
``ops/cuda_fs.py`` computes the same state (``cold_backend``).  On a GPU
the loop after it runs as one launch of the search kernel,
``ops/cuda_fs_scan.py``, from that state, and ``feature_sign_scan`` from
the empty active set runs its whole loop as another, with no host read
inside either.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from lyssandra_tpu_torch._device import resolve_device
from lyssandra_tpu_torch.solvers.greedy import _argmax_first, _as_f32
from lyssandra_tpu_torch.utils.profiling import span


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


def _fs_scan_supported(D, X, *, max_active: int, n_activate: int,
                       warm_start: int, cold_unroll: int) -> bool:
    """The search kernel (``ops/cuda_fs_scan.py``) takes
    ``feature_sign_scan``'s call: the empty active set as the start (no
    warm or unrolled seed), one activation an iteration, and a call its
    wrapper launches for (``cuda_fs_scan.takes``)."""
    from lyssandra_tpu_torch.ops import cuda_fs_scan

    return (
        not (cold_unroll and cold_unroll > 0)
        and not (warm_start and warm_start > 0)
        and n_activate == 1
        and cuda_fs_scan.takes(D, X, max_active)
    )


def _fs_seeded_supported(D, X, *, max_active: int, n_activate: int,
                         max_iter: int, max_inner: int, max_cg: int) -> bool:
    """The search kernel's seeded entry (``ops/cuda_fs_scan.py``) runs
    ``feature_sign``'s loop after its seed: one activation an iteration,
    and a call its wrapper launches for (``cuda_fs_scan.takes``: the state
    on a GPU, ``max_active`` slots it holds)."""
    from lyssandra_tpu_torch.ops import cuda_fs_scan

    return n_activate == 1 and cuda_fs_scan.takes(
        D, X, max_active, max_iter=max_iter, max_inner=max_inner,
        max_cg=max_cg)


def _fs_read_gates(res: FeatureSignResult, iters):
    """One host read after the search kernel: whether any lane is not done
    or overflowed (the polish gate), whether any overflowed, and n_iter,
    the seed's iterations (``res.n_iter``) plus the lanes' largest count
    ``iters``.  Returns (res with that n_iter, bad, overflowed)."""
    flags = _host(torch.stack([
        (~res.done | res.overflow).any().to(torch.int32),
        res.overflow.any().to(torch.int32),
        torch.nn.functional.pad(iters, (0, 1)).max()]))
    return (res._replace(n_iter=res.n_iter + int(flags[2])), bool(flags[0]),
            bool(flags[1]))


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

    Up to ``max_iter`` outer iterations follow the seed.  On a GPU, at one
    activation an iteration and where the search kernel takes the call
    (``_fs_seeded_supported``), they run as one launch of its seeded entry
    (``ops/cuda_fs_scan.fs_scan_seeded``), each lane to its own exit; K6
    and it read one pair of products, and the polish gate's read brings
    ``n_iter`` along.  Elsewhere they run as the plain loop in segments of
    16, 32, then 64 at most, every exit a host read (``_fs_segments``).
    The cold start, the loop and the polish are the spans
    ``lyssa.fs.cold``, ``lyssa.fs.loop`` (attribute ``fused``: 1 where the
    kernel ran the loop) and ``lyssa.fs.polish`` (``utils.profiling``);
    the overflow re-solve, a call of its own, opens its own.
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
    on_gpu = D.is_cuda
    if cold_unroll is None:
        cold_unroll = 28 if on_gpu else 0
    if cold_backend is None:
        cold_backend = "pallas" if on_gpu else "xla"
    A_run = 16 if (auto_capacity and max_active > 16) else max_active
    scan = _fs_seeded_supported(D, X, max_active=A_run,
                                n_activate=n_activate, max_iter=max_iter,
                                max_inner=max_inner, max_cg=max_cg)
    t_unroll = (min(int(cold_unroll), A_run)
                if cold_unroll and cold_unroll > 0 else 0)
    from lyssandra_tpu_torch.ops import cuda_fs, cuda_fs_scan

    k6 = t_unroll > 0 and cold_backend == "pallas" and (
        not on_gpu or cuda_fs.takes(D, X, t_unroll))
    # K6 and the search kernel read one alpha0 and G; the plain loop and
    # the plain seeds read A0 = X^T D
    products = cuda_fs.gram_inputs(D, X) if scan and k6 else None
    A0 = None if products is not None else X.T @ D
    if t_unroll:
        with span("lyssa.fs.cold"):
            if k6:
                cold = cuda_fs.fs_cold_fused(
                    D, X, lam=lam, t_unroll=t_unroll, n_refine=int(n_refine),
                    products=products)
                # the search kernel reads the Tun-wide handoff as it is
                # (its overflow is all false); the plain loop pads it
                state = (cold + (None, t_unroll) if scan
                         else _pad_handoff(*cold, max_active=A_run))
            else:
                state = _fs_unrolled_state(
                    Dt, Xt, A0, lam, t_unroll=t_unroll,
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
    with span("lyssa.fs.loop") as attrs:
        s0 = None if attrs is None else _host.count
        if scan:
            Gamma, done, overflow, iters = cuda_fs_scan.fs_scan_seeded(
                D, X, state[:6], lam=lam, max_active=A_run,
                max_iter=max_iter, max_inner=max_inner, max_cg=max_cg,
                products=products)
            res = FeatureSignResult(Gamma, state[-1], done, overflow)
            segments = 1
        else:
            res, segments = _fs_segments(
                Dt, Xt, A0, lam, state, max_iter=max_iter,
                compact_stragglers=compact_stragglers, max_active=A_run,
                max_inner=max_inner, max_cg=max_cg, n_activate=n_activate)
        if attrs is not None:
            attrs["syncs"] = _host.count - s0
            attrs["segments"] = segments
            attrs["fused"] = int(scan)
    # after the search kernel, one host read brings the polish gate, the
    # overflow flag and n_iter; the plain loop's polish reads its own gate
    bad = None
    if scan:
        res, bad, overflowed = _fs_read_gates(res, iters)
    else:
        overflowed = A_run < max_active and _host_bool(res.overflow.any())
    if A_run < max_active and overflowed:
        # reduced-capacity overflow is this run's artifact: re-solve those
        # lanes exactly at the full capacity (a power-of-two width)
        cols = np.where(_host(res.overflow))[0]
        nb = len(cols)
        width = 256
        while width < nb:
            width *= 2
        width = min(width, X.shape[1])
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
        bad = None          # the re-solved lanes: the polish reads again
    if polish:
        with span("lyssa.fs.polish"):
            # a gate read shut skips it; else _fs_polish reads its own
            if bad is None or bad:
                res = _fs_polish(D, X, lam, res)
    return res if full_result else res.Gamma


def _fs_segments(Dt, Xt, A0, lam, state, *, max_iter, compact_stragglers,
                 **seg):
    """``feature_sign``'s plain loop from ``state``: ``_fs_loop`` in
    segments of 16, 32, then 64 outer iterations at most (``max_iter`` in
    all), every exit a host read; with ``compact_stragglers`` the lanes
    still running after a segment are gathered into a narrow power-of-two
    batch (at least 256) when they are at most half of it.  ``seg``:
    ``_fs_loop``'s options.  Returns (result, segments run)."""
    seg_plan = []
    left, s = max_iter, min(16, max_iter)
    while left > 0:
        take = min(s, left)
        seg_plan.append(take)
        left -= take
        s = min(2 * s, 64)
    dev = A0.device
    state, res, all_done = _fs_loop(Dt, Xt, A0, lam, state,
                                    max_iter=seg_plan[0], **seg)
    segments = 1
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
                selt = torch.from_numpy(sel).to(dev)
                pad_done = torch.from_numpy(
                    np.arange(width) >= nbad).to(dev)
                state = _gather_lanes(state, selt, pad_done)
                Xt_n = Xt_n[selt]
                A0_n = A0_n[selt]
                lanes = cols if lanes is None else lanes[cols]
        state, res_n, all_done = _fs_loop(Dt, Xt_n, A0_n, lam, state,
                                          max_iter=seg_i, **seg)
        segments += 1
        if lanes is None:
            res = res_n
        else:
            nb = len(lanes)
            lt = torch.from_numpy(lanes).to(dev)
            Gamma = res.Gamma.clone()
            Gamma[:, lt] = res_n.Gamma[:, :nb]
            done = res.done.clone()
            done[lt] = res_n.done[:nb]
            overflow = res.overflow.clone()
            overflow[lt] = res_n.overflow[:nb]
            res = FeatureSignResult(Gamma, res_n.n_iter, done, overflow)
    return res, segments


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
    or "fista" (the FISTA iterate); else the empty active set.  From the
    empty set on a GPU, the search kernel (``ops/cuda_fs_scan.py``) runs
    the loop, each lane to its own exit, where it takes the shape
    (``_fs_scan_supported``); the reference's loop decides on the device
    too.  Elsewhere each exit check is a host sync (``host_syncs``).  One
    more decides whether to polish."""
    if max_iter < 1:
        raise ValueError(f"max_iter must be >= 1, got {max_iter}")
    if warm_seed not in ("omp", "fista"):
        raise ValueError(f"warm_seed must be 'omp' or 'fista': {warm_seed!r}")
    device = resolve_device(device, D, X)
    D = _as_f32(D, device)
    X = _as_f32(X, device)
    lam = float(lam)
    if _fs_scan_supported(D, X, max_active=max_active, n_activate=n_activate,
                          warm_start=warm_start, cold_unroll=cold_unroll):
        from lyssandra_tpu_torch.ops.cuda_fs_scan import fs_scan_fused

        G, done, overflow, A0 = fs_scan_fused(
            D, X, lam=lam, max_active=max_active, max_iter=max_iter,
            max_inner=max_inner, max_cg=max_cg)
        return _fs_scan_polish(D, X, lam, A0, G, ~done | overflow)
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
    return _fs_scan_polish(D, X, lam, A0, res.Gamma,
                           ~res.done | res.overflow)


def _fs_scan_polish(D, X, lam, A0, G, bad):
    """``feature_sign_scan``'s ending: where any lane is ``bad`` (not done
    or overflowed; one host sync to know), FISTA-100 from the codes G,
    kept lane by lane where its objective is lower.  A0 = X^T D (N, K)."""
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


# ---- LARS-lasso homotopy -------------------------------------------------

_BIG = 3.4e38
# the homotopy's direction CG reads its device flag on the host every
# _READ_EVERY iterations (see _masked_cg); every value gives the same codes
_READ_EVERY = 8


def _first_min_index(vals: torch.Tensor, target: torch.Tensor, K: int):
    """Per row, the lowest column where ``vals`` equals ``target`` (the
    reference's iota-min construction).  A row with no match (NaN values)
    gives K - 1, a valid index, where the reference gathers out of
    range."""
    iota = torch.arange(K, dtype=torch.int32, device=vals.device)
    return torch.where(vals == target[:, None], iota[None, :],
                       K).amin(dim=1).clamp_max(K - 1).to(torch.int32)


def _masked_cg(mv, rhs, x0, *, iters: int, done):
    """The reference's two-rhs CG ``while (i < iters) & any(rs > 1e-12)``
    inside a homotopy step whose lanes are marked ``done``.

    Every iteration runs under a device-side flag, ``any(rs > 1e-12)``
    before it: once the flag falls, x, r, p and rs stay as they are, so an
    iteration past the reference's exit changes nothing.  The host reads
    the flag before every ``_READ_EVERY``-th iteration only (one sync each)
    and stops there when it has fallen; every reading interval gives the
    same result.  The first read also carries ``all(done)``, the homotopy
    loop's own exit test: when every lane is done the step is a no-op, and
    None is returned instead of a solution."""
    x = x0
    r = rhs - mv(x0)
    pv = r
    rs = (r * r).sum(dim=1)                                  # (N, 2)
    first = True
    every = _READ_EVERY
    for i in range(iters):
        run = (rs > 1e-12).any()
        if i % every == every - 1:
            if first:
                run_h, all_done = _host(torch.stack([run, done.all()]))
                if all_done:
                    return None
                first = False
            else:
                run_h = _host_bool(run)
            if not run_h:
                break
        Mpv = mv(pv)
        al = rs / ((pv * Mpv).sum(dim=1) + 1e-30)
        xn = x + al[:, None, :] * pv
        rn = r - al[:, None, :] * Mpv
        rs2 = (rn * rn).sum(dim=1)
        pn = rn + (rs2 / (rs + 1e-30))[:, None, :] * pv
        x = torch.where(run, xn, x)
        r = torch.where(run, rn, r)
        pv = torch.where(run, pn, pv)
        rs = torch.where(run, rs2, rs)
    return x


def _lars_events(u, v, cA, wA, idx, mask, gact, lt, lam, t_stop):
    """One homotopy segment's events, shared by the wide step and the
    unrolled cold start: the next knot lt_next, the lanes that finish, the
    join (atom k_join at corr_at, preferred over a leave) and the leaving
    slot s_leave."""
    K = u.shape[1]
    is_act = _active_mask(idx, mask, K)
    ltc = lt[:, None]
    # join events: u + lt*v = +-lt  =>  lt = u / (+-1 - v)
    ltp = u / torch.clamp_min(1.0 - v, 1e-12)
    ltm = u / torch.clamp_max(-1.0 - v, -1e-12)
    cand = torch.where(is_act, -_BIG, torch.maximum(
        torch.where((ltp < ltc - 1e-6) & (ltp > 0), ltp, -_BIG),
        torch.where((ltm < ltc - 1e-6) & (ltm > 0), ltm, -_BIG)))
    lt_join = cand.amax(dim=1)
    k_join = _first_min_index(cand, lt_join, K)

    # self-healing overdue joins: an atom whose crossing lies in the past
    # (|corr(lt)| > lt, skipped by two events within the 1e-6 margin)
    # joins at once at the current lt
    c_now = torch.where(is_act, 0.0, u + ltc * v)
    over = c_now.abs() - ltc * (1.0 + 1e-5)
    mx_over = over.amax(dim=1)
    k_over = _first_min_index(over, mx_over, K)
    has_over = mx_over > 1e-5
    lt_join = torch.where(has_over, lt, lt_join)
    k_join = torch.where(has_over, k_over, k_join)

    # leave events: cA - lt*wA = 0 => lt = cA/wA; a just-joined slot (gact
    # == 0) is excluded, its only zero is the join knot itself
    wok = wA.abs() > 1e-12
    ltz = torch.where(mask & (gact != 0) & wok,
                      cA / torch.where(wok, wA, 1.0), -_BIG)
    ltz = torch.where((ltz < ltc - 1e-6) & (ltz > 0), ltz, -_BIG)
    lt_leave = ltz.amax(dim=1)
    s_leave = (ltz == lt_leave[:, None]).to(torch.uint8).argmax(dim=1)

    lt_next = torch.clamp_min(torch.maximum(lt_join, lt_leave), lam)
    finished = lt_next <= float(np.float32(lam) + np.float32(1e-9))
    prefer_join = lt_join >= lt_leave
    if t_stop:
        # the join that would exceed t_stop active atoms finishes the lane
        # at that join knot
        finished = finished | ((~finished) & prefer_join
                               & (mask.sum(dim=1) >= t_stop))
    corr_at = (u.gather(1, k_join.long()[:, None])[:, 0]
               + lt_next * v.gather(1, k_join.long()[:, None])[:, 0])
    return lt_next, finished, prefer_join, k_join, corr_at, s_leave


def _lars_make_step(Dt, Xt, A0, lam, max_active, t_stop):
    """One homotopy event step, shared by ``lars``'s loop and the path
    recording (the reference's ``_lars_make_step``).

    Along the path the active coefficients are linear in the falling
    penalty lt, g_A(lt) = c_A - lt w_A, with c_A and w_A the two solutions
    of one masked two-rhs CG on the gathered atoms' Gram; the inactive
    correlations 2 d_j^T (x - D_A g_A) = u + lt v are linear too, so each
    segment ends at a closed-form event time (a join or a leave).  Lanes
    marked done keep their state.  Returns the next state, or None when
    every lane was done (the state is final; see ``_masked_cg``)."""
    N, K = A0.shape
    A = max_active
    dev, dt = A0.device, A0.dtype
    eyeA = torch.eye(A, dtype=dt, device=dev)
    D = Dt.T

    def step(st):
        idx, mask, theta, gact, cgw, lt, done, it = st
        maskf = mask.to(dt)
        Dact = Dt[idx.long()]                                # (N, A, p)
        pair = maskf[:, :, None] * maskf[:, None, :]
        M = (Dact @ Dact.transpose(1, 2)) * pair
        Mp = torch.where(pair > 0, M, eyeA) + 1e-6 * eyeA
        a0sel = A0.gather(1, idx.long()) * maskf
        rhs = torch.stack([a0sel, theta / 2.0], dim=-1)     # (N, A, 2)
        # warm start from the previous knot's solution: the active set
        # changes by one atom per event
        sol = _masked_cg(lambda v: Mp @ v, rhs, cgw * maskf[:, :, None],
                         iters=A + 16, done=done)
        if sol is None:
            return None
        cA = sol[..., 0] * maskf            # g at lt = 0
        wA = sol[..., 1] * maskf            # dg/dlt (negated)

        # inactive correlation lines in the residual form, both in one
        # product: u = 2 D^T (x - D_A c), v = 2 D^T (D_A w)
        zz = torch.stack([cA, wA], dim=1) @ Dact             # (N, 2, p)
        rz = torch.stack([Xt - zz[:, 0], zz[:, 1]], dim=1)
        uv = 2.0 * (rz.reshape(2 * N, -1) @ D).reshape(N, 2, K)
        u, v = uv[:, 0], uv[:, 1]

        lt_next, finished, prefer_join, k_join, corr_at, s_leave = \
            _lars_events(u, v, cA, wA, idx, mask, gact, lt, lam, t_stop)
        gact_new = (cA - lt_next[:, None] * wA) * maskf
        do_join = (~finished) & prefer_join
        do_leave = (~finished) & ~prefer_join

        # join: k_join into the first free slot
        free = (~mask).to(torch.uint8).argmax(dim=1)
        no_free = mask.all(dim=1)
        slot_hot = (torch.nn.functional.one_hot(free, A).bool()
                    & (do_join & ~no_free)[:, None])
        idx2 = torch.where(slot_hot, k_join[:, None], idx)
        mask2 = mask | slot_hot
        theta2 = torch.where(slot_hot, torch.sign(corr_at)[:, None], theta)
        gact2 = torch.where(slot_hot, 0.0, gact_new)

        # leave: clear the crossing slot
        leave_hot = (torch.nn.functional.one_hot(s_leave, A).bool()
                     & do_leave[:, None])
        mask3 = mask2 & ~leave_hot
        theta3 = torch.where(leave_hot, 0.0, theta2)
        gact3 = torch.where(leave_hot, 0.0, gact2)

        newly_done = finished | (do_join & no_free)

        def fz(new, old):
            return torch.where(done[:, None], old, new)

        return (fz(idx2, idx), fz(mask3, mask), fz(theta3, theta),
                fz(gact3, gact), torch.where(done[:, None, None], cgw, sol),
                torch.where(done, lt, lt_next), done | newly_done, it + 1)

    return step


def _lars_init(A0, lam, A):
    """lt = lambda_max = max 2|a0|; the argmax atom (the lowest index among
    equals) active in slot 0."""
    N, K = A0.shape
    dev, dt = A0.device, A0.dtype
    c0 = 2.0 * A0.abs()
    lt0 = c0.amax(dim=1)
    k0 = _first_min_index(c0, lt0, K)
    idx = torch.zeros(N, A, dtype=torch.int32, device=dev)
    idx[:, 0] = k0
    mask = torch.zeros(N, A, dtype=torch.bool, device=dev)
    mask[:, 0] = True
    theta = torch.zeros(N, A, dtype=dt, device=dev)
    theta[:, 0] = torch.sign(A0.gather(1, k0.long()[:, None])[:, 0])
    gact = torch.zeros(N, A, dtype=dt, device=dev)
    cgw = torch.zeros(N, A, 2, dtype=dt, device=dev)   # CG warm start
    done0 = lt0 <= lam          # target penalty at/above lambda_max: g = 0
    return (idx, mask, theta, gact, cgw, lt0, done0, 0)


def _lars_unrolled_state(Dt, Xt, A0, lam, *, t_unroll, max_active,
                         t_stop=0):
    """Growing-width homotopy cold start: the first ``t_unroll`` events at
    the true active width, event c's direction a (c+1)-iteration CG on
    (N, c, c) systems, the compact geometry (stacked atoms, their Gram,
    a0) grown by one slot an event (a leave masks its slot; slots are not
    reused).  The events are ``_lars_make_step``'s.  Returns a ``lars``
    loop state padded to ``max_active`` slots.  A Python loop of static
    widths: nothing is compiled and nothing is read on the host."""
    N, K = A0.shape
    dev, dt = A0.device, A0.dtype
    D = Dt.T

    c0 = 2.0 * A0.abs()
    lt = c0.amax(dim=1)
    k0 = _first_min_index(c0, lt, K)
    done = lt <= lam
    idx = k0[:, None]
    mask = torch.ones(N, 1, dtype=torch.bool, device=dev)
    theta = torch.sign(A0.gather(1, k0.long()[:, None]))
    gact = torch.zeros(N, 1, dtype=dt, device=dev)
    dk = Dt[k0.long()]                                       # (N, p)
    Dstack = dk[:, None, :]
    Gsel = (dk * dk).sum(dim=1)[:, None, None]
    a0sel = A0.gather(1, idx.long())
    cgw = torch.zeros(N, 1, 2, dtype=dt, device=dev)

    for _ in range(t_unroll):
        c = idx.shape[1]
        maskf = mask.to(dt)
        eyec = torch.eye(c, dtype=dt, device=dev)
        pair = maskf[:, :, None] * maskf[:, None, :]
        Mp = torch.where(pair > 0, Gsel * pair, eyec) + 1e-6 * eyec
        rhs = torch.stack([a0sel * maskf, theta / 2.0], dim=-1)

        # two-rhs CG, c + 1 iterations, warm from the previous knot
        x = cgw * maskf[:, :, None]
        r = rhs - Mp @ x
        pv = r
        rs = (r * r).sum(dim=1)
        for _ in range(c + 1):
            Mpv = Mp @ pv
            al = rs / ((pv * Mpv).sum(dim=1) + 1e-30)
            x = x + al[:, None, :] * pv
            r = r - al[:, None, :] * Mpv
            rs2 = (r * r).sum(dim=1)
            pv = r + (rs2 / (rs + 1e-30))[:, None, :] * pv
            rs = rs2
        sol = x * maskf[:, :, None]
        cA, wA = sol[..., 0], sol[..., 1]

        zz = torch.stack([cA, wA], dim=1) @ Dstack           # (N, 2, p)
        rz = torch.stack([Xt - zz[:, 0], zz[:, 1]], dim=1)
        uv = 2.0 * (rz.reshape(2 * N, -1) @ D).reshape(N, 2, K)
        u, v = uv[:, 0], uv[:, 1]

        lt_next, finished, prefer_join, k_join, corr_at, s_leave = \
            _lars_events(u, v, cA, wA, idx, mask, gact, lt, lam, t_stop)
        gact_new = (cA - lt_next[:, None] * wA) * maskf
        do_join = (~finished) & prefer_join
        do_leave = (~finished) & ~prefer_join

        # leave: clear the crossing slot at compact width
        leave_hot = (torch.nn.functional.one_hot(s_leave, c).bool()
                     & do_leave[:, None])
        mask_upd = mask & ~leave_hot
        theta_upd = torch.where(leave_hot, 0.0, theta)
        gact_upd = torch.where(leave_hot, 0.0, gact_new)

        # join: always append one fresh slot, inert unless the join fires
        # on a live lane
        live = do_join & ~done
        livef = live.to(dt)
        dkj = Dt[k_join.long()] * livef[:, None]
        cross = (Dstack @ dkj[:, :, None])[:, :, 0]          # (N, c)
        dkk = (dkj * dkj).sum(dim=1)
        Gsel = torch.cat([
            torch.cat([Gsel, cross[:, :, None]], dim=2),
            torch.cat([cross[:, None, :], dkk[:, None, None]], dim=2),
        ], dim=1)
        Dstack = torch.cat([Dstack, dkj[:, None, :]], dim=1)
        a0k = (dkj * Xt).sum(dim=1)

        def fz(new, old):
            return torch.where(done[:, None], old, new)

        idx = torch.cat([idx, torch.where(live, k_join, 0)[:, None]], dim=1)
        mask = torch.cat([fz(mask_upd, mask), live[:, None]], dim=1)
        theta = torch.cat([fz(theta_upd, theta),
                           (torch.sign(corr_at) * livef)[:, None]], dim=1)
        gact = torch.cat([fz(gact_upd, gact),
                          torch.zeros(N, 1, dtype=dt, device=dev)], dim=1)
        a0sel = torch.cat([a0sel, a0k[:, None]], dim=1)
        cgw = torch.cat([torch.where(done[:, None, None], cgw, sol),
                         torch.zeros(N, 1, 2, dtype=dt, device=dev)], dim=1)
        lt = torch.where(done, lt, lt_next)
        done = done | finished

    pad = (0, max_active - idx.shape[1])
    F = torch.nn.functional
    return (F.pad(idx, pad), F.pad(mask, pad), F.pad(theta, pad),
            F.pad(gact, pad), F.pad(cgw, (0, 0) + pad), lt, done, t_unroll)


def _lars_polish(D, X, G, A0, lam, Gamma, done):
    """Lanes that are not done or whose KKT residual exceeds 1e-2 max(lam,
    1) are solved again by FISTA-500; the better objective wins.  The
    reference decides on the device (``lax.cond``); here it is one host
    sync a call."""
    gr = 2.0 * (G @ Gamma - A0.T)
    act = Gamma.abs() > 1e-8
    viol = torch.where(act, (gr + lam * torch.sign(Gamma)).abs(),
                       torch.clamp_min(gr.abs() - lam, 0.0)).amax(dim=0)
    bad = ~done | (viol > 1e-2 * max(lam, 1.0))
    if not _host_bool(bad.any()):
        return Gamma, done
    Gf = fista(D, X, lam, n_iter=500)

    def obj(Gm):
        R = X - D @ Gm
        return (R * R).sum(dim=0) + lam * Gm.abs().sum(dim=0)

    take = bad & (obj(Gf) < obj(Gamma))
    return torch.where(take[None, :], Gf, Gamma), done | take


def _lars_prepare(D, X, n_nonzero_coefs, max_active, device):
    device = resolve_device(device, D, X)
    D = _as_f32(D, device)
    X = _as_f32(X, device)
    t_stop = 0 if n_nonzero_coefs is None else int(n_nonzero_coefs)
    if t_stop:
        max_active = max(max_active, t_stop + 1)
    return D, X, t_stop, max_active


def lars(
    D, X, lam: float = 0.0,
    *, n_nonzero_coefs: int | None = None,
    max_active: int = 64, max_steps: int = 256,
    full_result: bool = False, polish: bool = True,
    cold_unroll: int | None = None, device=None,
):
    """Batched LARS-lasso homotopy for ||x - D g||^2 + lam ||g||_1: the
    feature-sign optimum, reached by tracing the regularization path from
    lambda_max down to lam for all columns of X (p, N) at once.  Returns
    Gamma (K, N), or (Gamma, done) with ``full_result``.

    - ``n_nonzero_coefs=T``: a lane stops at the first join that would grow
      its active set past T atoms and returns the knot solution there (<= T
      nonzeros); lam (default 0) is the floor.  No polish in this mode.
    - ``polish``: lanes whose final KKT residual violates lam are solved
      again with FISTA-500 and the better objective wins (the float32 path
      is sensitive to the order of nearby events).
    - ``cold_unroll``: the first t events run at their true active width
      (``_lars_unrolled_state``), with the same events.  None: 12 on a GPU,
      0 on the CPU (the reference's 12 on a TPU, 0 elsewhere).
    The reference decides its loops on the device.  Here the direction CG
    of each step runs under a device-side "still running" flag that makes
    an iteration past the reference's exit a no-op, and the host reads it
    every 8 CG iterations (one sync each; the first read of a step also
    carries the loop's exit test, every lane done): the codes are those of
    a read at every iteration.  ``host_syncs`` counts the reads.

    The steps run in the reference's segments of min(32, max_steps), so a
    lane takes at most ceil(max_steps / seg) * seg steps after the cold
    start.
    """
    D, X, t_stop, max_active = _lars_prepare(D, X, n_nonzero_coefs,
                                             max_active, device)
    if t_stop:
        polish = False
    lam = float(lam)
    Dt, Xt = D.T, X.T
    A0 = X.T @ D
    seg = min(32, max_steps)
    if cold_unroll is None:
        cold_unroll = 12 if D.is_cuda else 0
    if cold_unroll and cold_unroll > 0:
        state = _lars_unrolled_state(
            Dt, Xt, A0, lam, t_unroll=min(int(cold_unroll), max_active - 1),
            max_active=max_active, t_stop=t_stop)
    else:
        state = _lars_init(A0, lam, max_active)
    step = _lars_make_step(Dt, Xt, A0, lam, max_active, t_stop)
    for _ in range(-(-max_steps // seg) * seg):
        nxt = step(state)
        if nxt is None:
            break
        state = nxt
    idx, mask, _, gact, _, _, done, _ = state
    Gamma = _dense(idx, mask, gact, D.shape[1]).T
    if polish:
        Gamma, done = _lars_polish(D, X, D.T @ D, A0, lam, Gamma, done)
    return (Gamma, done) if full_result else Gamma


lasso_lars = lars


class LarsPath(NamedTuple):
    """Batched regularization-path knots from :func:`lars_path`.

    lambdas: (S+1, N) knot penalties (knot 0 = lambda_max, zero coefs);
    coefs:   (S+1, N, A) compact active-coefficient values per knot;
    idx:     (S+1, N, A) atom ids of the compact slots;
    mask:    (S+1, N, A) slot validity;
    keep:    (S+1, N) True at each lane's last row per distinct lambda,
             except knots a self-healing join superseded or made (off the
             path); read kept rows only;
    n_knots: (N,) number of kept knots per lane (= keep.sum(0)).
    """

    lambdas: torch.Tensor
    coefs: torch.Tensor
    idx: torch.Tensor
    mask: torch.Tensor
    keep: torch.Tensor
    n_knots: torch.Tensor

    def dense(self, K: int) -> torch.Tensor:
        """(S+1, K, N) dense coefficient path (small problems only)."""
        S, N, A = self.coefs.shape
        out = torch.zeros(S, N, K, dtype=self.coefs.dtype,
                          device=self.coefs.device)
        out.scatter_add_(2, self.idx.long(),
                         torch.where(self.mask, self.coefs, 0.0))
        return out.transpose(1, 2)


def lars_path(
    D, X, lam: float = 0.0,
    *, n_nonzero_coefs: int | None = None,
    max_active: int = 64, max_steps: int = 64, device=None,
) -> LarsPath:
    """Batched regularization path (sklearn ``lars_path``, method='lasso'):
    every homotopy knot from lambda_max down to ``lam`` (or until
    ``n_nonzero_coefs`` atoms are active), for all N signals at once.
    Knot 0 is (lambda_max, all-zero); see :class:`LarsPath`.  A fixed
    ``max_steps`` events (no early exit); lanes that finish early repeat
    their last knot.  The CG's flag reads are :func:`lars`'s."""
    D, X, t_stop, max_active = _lars_prepare(D, X, n_nonzero_coefs,
                                             max_active, device)
    lam = float(lam)
    A0 = X.T @ D
    state = _lars_init(A0, lam, max_active)
    step = _lars_make_step(D.T, X.T, A0, lam, max_active, t_stop)
    lts, gacts, idxs, masks, heals = ([state[5]], [state[3]], [state[0]],
                                      [state[1]], [])
    for _ in range(max_steps):
        mask0, lt0, done0 = state[1], state[5], state[6]
        nxt = step(state)
        # every lane done: the rest of the path repeats the last knot
        state = state if nxt is None else nxt
        idx, mask, _, gact, _, lt, _, _ = state
        # an overdue-join heal joins at an unchanged lambda: it and the
        # knots it supersedes are off the path
        heals.append((lt == lt0) & ~done0 & (mask.sum(1) > mask0.sum(1)))
        lts.append(lt)
        gacts.append(gact)
        idxs.append(idx)
        masks.append(mask)
    lambdas = torch.stack(lts)
    healed = torch.stack([torch.zeros_like(heals[0])] + heals)
    off_path = healed | torch.cat([healed[1:], torch.zeros_like(healed[:1])])
    keep = torch.cat([lambdas[:-1] != lambdas[1:],
                      torch.ones_like(healed[:1])]) & ~off_path
    return LarsPath(lambdas, torch.stack(gacts), torch.stack(idxs),
                    torch.stack(masks), keep,
                    keep.sum(dim=0).to(torch.int32))
