"""The comparisons that decide ``correct``: the program's answers against
the plain reference's, as numbers that each cell holds to limits of its
own (``workloads/<cell>.json``)."""

import torch


def _supports(idx, nsel):
    """Each lane's atoms, sorted, slots past nsel set to -1 and last; and
    the order that sorts them."""
    T = idx.shape[1]
    idx = idx.long()
    valid = torch.arange(T, device=idx.device)[None, :] < nsel[:, None]
    key = torch.where(valid, idx, torch.iinfo(torch.long).max)
    key, order = torch.sort(key, dim=1)
    return torch.where(key == torch.iinfo(torch.long).max, -1, key), order


def codes(prog, ref, X):
    """Sparse codes (idx, gamma, err, nsel), lane by lane, program against
    reference, on the signals X (p, n):

    - support_mismatch: the share of lanes whose set of atoms (or count)
      differs;
    - coef_gap: over the lanes with equal supports, the widest
      ||gamma - gamma_ref|| / ||gamma_ref||;
    - err_gap: over the same lanes, the widest |err - err_ref| / ||x||^2.
    """
    pi, pg, pe, pn = (t.to(X.device) for t in prog)
    ri, rg, re, rn = ref
    ps, po = _supports(pi, pn.long())
    rs, ro = _supports(ri, rn.long())
    same = (ps == rs).all(dim=1) & (pn.long() == rn.long())
    n = same.numel()
    gp = torch.gather(pg.to(X.dtype), 1, po)
    gr = torch.gather(rg.to(X.dtype), 1, ro)
    gp = torch.where(ps >= 0, gp, 0.0)
    gr = torch.where(rs >= 0, gr, 0.0)
    cgap = (torch.linalg.vector_norm(gp - gr, dim=1)
            / torch.linalg.vector_norm(gr, dim=1).clamp_min(1e-30))
    xn = (X * X).sum(dim=0).clamp_min(1e-30)
    egap = (pe.to(X.dtype) - re).abs() / xn
    zero = torch.zeros((), dtype=X.dtype, device=X.device)
    return {
        "support_mismatch": float(1.0 - same.sum().item() / n),
        "coef_gap": float(torch.where(same, cgap, zero).max()),
        "err_gap": float(torch.where(same, egap, zero).max()),
    }


def images(prog, ref):
    """Restored images (H, W), program against reference: the RMS of
    their difference in grey levels."""
    d = prog.to(ref.dtype).to(ref.device) - ref
    return float(torch.sqrt((d * d).mean()))


def atoms(prog, ref):
    """Per-atom distances ||d - d_ref|| of two (p, K) dictionaries."""
    return torch.linalg.vector_norm(prog.to(ref.dtype).to(ref.device) - ref,
                                    dim=0)


def max_abs(prog, ref):
    """The largest |prog - ref| with ref rounded to prog's dtype: 0 where
    the program computes the same values and rounds them once."""
    return float((prog - ref.to(prog.dtype).to(prog.device)).abs().max())
