"""Row-by-row limits for holding the port's point covariances against JAX's.

Every row is held to its own limit, the largest of:

- the gate of tests/test_features_sp.py, rtol 1e-4 / atol 1e-5;
- twice the largest move of that row of JAX's own result when its input is
  perturbed by 1e-7 relative (``own``): this covers the rows whose result
  is ill-defined in float32, such as an rbf weight that flips at the 3 m
  cutoff or a plane normal of two near-equal eigenvalues;
- for rbf covariances, the float32 rounding of the moments
  (``rbf_rounding``).

A near-degenerate row therefore loosens no other row.
"""
import numpy as np

EPS32 = 2.0 ** -24


def rows_max(a):
    return np.abs(a).reshape(len(a), -1).max(1)


def file_gate(ref):
    return 1e-5 + 1e-4 * rows_max(ref)


def rbf_rounding(xyz, mask, method, kernel_width=0.25, max_dist=3.0):
    """Per query row, how far two float32 summation orders may round
    ``rbf_covariances(xyz, mask, method=method)`` apart.

    The row's moments E = Σw·xxᵀ/Σw are sums of a few hundred terms of size
    S = Σw·|x|²/Σw (x about the cloud centroid, up to ~20 m), and the
    one-pass E − mmᵀ keeps their rounding in full: about √k·eps32·S for k
    terms, so 16·eps32·S (√256).  The plane regularizer keeps only the
    normal, which turns by that over the gap of the two smallest
    eigenvalues, and its outer product moves by twice that.  The moments
    are taken here in float64.  Masked rows get 0: both packages return
    the regularized identity there."""
    m = mask.astype(np.float64)
    x = (xyz.astype(np.float64) - (xyz * m[:, None]).sum(0) / max(m.sum(), 1.0)) * m[:, None]
    sq = (x * x).sum(-1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * (x @ x.T)
    w = np.where((d2 <= max_dist * max_dist) & mask[None, :], np.exp(-kernel_width * d2), 0.0)
    sw = np.maximum(w.sum(1), 1e-12)
    scale = (w @ sq) / sw
    mean = (w @ x) / sw[:, None]
    e = (w @ np.einsum("ni,nj->nij", x, x).reshape(-1, 9)).reshape(-1, 3, 3) / sw[:, None, None]
    ev = np.linalg.eigvalsh(e - np.einsum("ni,nj->nij", mean, mean))
    raw = 16 * EPS32 * scale
    if method == "plane":
        raw = 2 * raw / np.maximum(ev[:, 1] - ev[:, 0], 1e-30)
    elif method != "none":
        raise ValueError(method)
    return np.where(mask, raw, 0.0)


def assert_rows_track(got, ref, own, floor=0.0):
    """Every row of ``got`` within its limit of ``ref`` (module docstring);
    ``own`` is JAX's largest move of each row under the perturbations.  The
    median limit stays at the scale of the file's gate."""
    limit = np.maximum(np.maximum(file_gate(ref), 2 * own), floor)
    dev = rows_max(got - ref)
    bad = np.flatnonzero(dev > limit)
    assert bad.size == 0, [(int(i), float(dev[i]), float(limit[i])) for i in bad[:10]]
    assert np.median(limit) < 1e-3, np.median(limit)
