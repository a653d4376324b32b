"""SO(3)/SE(3) math on tensors: the port of ``rgc_slam_tpu/utils/math3d.py``.

Quaternions are ``[w, x, y, z]`` (Hamilton), Euler angles yaw-pitch-roll
(ZYX) in radians.  Every function broadcasts over leading axes, so the
JAX package's ``vmap`` over quaternions becomes a leading batch axis.
Norms are written as ``sqrt(sum(x*x))``, the formula XLA uses, so the two
packages round alike.
"""
from __future__ import annotations

import math

import torch

PI = math.pi

_CONSTS: dict = {}


def const(values, dtype=torch.float32, device=None) -> torch.Tensor:
    """The tensor of Python ``values`` (a number or a tuple) on ``device``,
    made once per (values, dtype, device) and shared after.  Building a
    tensor from Python values copies it from host memory and waits for
    that copy, which a captured CUDA graph cannot hold
    (``utils/graph``): the first call, eager, fills the cache, and every
    later call, captured or not, reads it.  Callers never write into the
    result."""
    key = (values, dtype, None if device is None else torch.device(device))
    t = _CONSTS.get(key)
    if t is None:
        t = _CONSTS[key] = torch.tensor(values, dtype=dtype, device=device)
    return t


def take(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``x[i]`` along the first axis for a 0-dim index tensor ``i``, as a
    gather on the device: indexing by a 0-dim device tensor reads it back
    to the host first (what ``torch.func.vmap`` makes of ``x[i]`` with a
    batched ``i``, and what ``jnp``'s ``x[i]`` compiles to)."""
    return x.index_select(0, i.reshape(1).long()).squeeze(0)


def norm(x: torch.Tensor, dim: int = -1, keepdim: bool = False) -> torch.Tensor:
    return torch.sqrt((x * x).sum(dim, keepdim=keepdim))


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Broadcasting 3-vector cross product (``jnp.cross``'s formula)."""
    a, b = torch.broadcast_tensors(a, b)
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], -1)


def skew(v: torch.Tensor) -> torch.Tensor:
    """3-vector -> 3x3 skew-symmetric matrix."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], -1),
            torch.stack([z, zero, -x], -1),
            torch.stack([-y, x, zero], -1),
        ],
        -2,
    )


# ---------------------------------------------------------------------------
# quaternions [w, x, y, z]
# ---------------------------------------------------------------------------


def quat_identity(device=None, dtype=torch.float32) -> torch.Tensor:
    return const((1.0, 0.0, 0.0, 0.0), dtype, device)


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    return q / norm(q, keepdim=True)


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([q[..., :1], -q[..., 1:]], -1)


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        -1,
    )


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vector(s) v by quaternion q (broadcasting)."""
    w = q[..., 0:1]
    u = q[..., 1:4]
    uv = cross(u, v)
    return v + 2.0 * (w * uv + cross(u, uv))


def quat_to_mat(q: torch.Tensor) -> torch.Tensor:
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r00 = 1 - 2 * (y * y + z * z)
    r01 = 2 * (x * y - z * w)
    r02 = 2 * (x * z + y * w)
    r10 = 2 * (x * y + z * w)
    r11 = 1 - 2 * (x * x + z * z)
    r12 = 2 * (y * z - x * w)
    r20 = 2 * (x * z - y * w)
    r21 = 2 * (y * z + x * w)
    r22 = 1 - 2 * (x * x + y * y)
    return torch.stack(
        [
            torch.stack([r00, r01, r02], -1),
            torch.stack([r10, r11, r12], -1),
            torch.stack([r20, r21, r22], -1),
        ],
        -2,
    )


def mat_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> quaternion, branch-free (Shepperd)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    qw0 = torch.sqrt(torch.clamp(1.0 + tr, min=1e-12)) / 2.0
    q0 = torch.stack(
        [qw0, (m21 - m12) / (4 * qw0), (m02 - m20) / (4 * qw0), (m10 - m01) / (4 * qw0)], -1
    )
    qx1 = torch.sqrt(torch.clamp(1.0 + m00 - m11 - m22, min=1e-12)) / 2.0
    q1 = torch.stack(
        [(m21 - m12) / (4 * qx1), qx1, (m01 + m10) / (4 * qx1), (m02 + m20) / (4 * qx1)], -1
    )
    qy2 = torch.sqrt(torch.clamp(1.0 - m00 + m11 - m22, min=1e-12)) / 2.0
    q2 = torch.stack(
        [(m02 - m20) / (4 * qy2), (m01 + m10) / (4 * qy2), qy2, (m12 + m21) / (4 * qy2)], -1
    )
    qz3 = torch.sqrt(torch.clamp(1.0 - m00 - m11 + m22, min=1e-12)) / 2.0
    q3 = torch.stack(
        [(m10 - m01) / (4 * qz3), (m02 + m20) / (4 * qz3), (m12 + m21) / (4 * qz3), qz3], -1
    )

    cond0 = tr > 0.0
    cond1 = (m00 > m11) & (m00 > m22)
    cond2 = m11 > m22
    q = torch.where(
        cond0[..., None],
        q0,
        torch.where(cond1[..., None], q1, torch.where(cond2[..., None], q2, q3)),
    )
    return quat_normalize(q)


def quat_from_axis_angle(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    half = angle / 2.0
    return torch.cat([torch.cos(half)[..., None], axis * torch.sin(half)[..., None]], -1)


def quat_slerp(q0: torch.Tensor, q1: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Spherical interpolation, stable for nearly identical quaternions."""
    dot = (q0 * q1).sum(-1)
    q1 = torch.where(dot[..., None] < 0, -q1, q1)
    dot = torch.clamp(torch.abs(dot), -1.0, 1.0)
    theta = torch.arccos(dot)
    sin_theta = torch.sin(theta)
    use_lerp = sin_theta < 1e-5
    safe = torch.where(use_lerp, torch.ones_like(sin_theta), sin_theta)
    w0 = torch.where(use_lerp, 1.0 - t, torch.sin((1.0 - t) * theta) / safe)
    w1 = torch.where(use_lerp, t, torch.sin(t * theta) / safe)
    return quat_normalize(w0[..., None] * q0 + w1[..., None] * q1)


def quat_exp(w: torch.Tensor) -> torch.Tensor:
    """so(3) vector -> quaternion, exact with a small-angle Taylor branch."""
    theta_sq = (w * w).sum(-1)
    theta = torch.sqrt(torch.clamp(theta_sq, min=1e-24))
    small = theta_sq < 1e-10
    k_small = 0.5 - theta_sq / 48.0
    k_big = torch.sin(theta / 2.0) / theta
    k = torch.where(small, k_small, k_big)
    cw = torch.where(small, 1.0 - theta_sq / 8.0, torch.cos(theta / 2.0))
    return quat_normalize(torch.cat([cw[..., None], k[..., None] * w], -1))


def quat_log(q: torch.Tensor) -> torch.Tensor:
    """Quaternion -> so(3) vector (inverse of quat_exp)."""
    q = torch.where(q[..., 0:1] < 0, -q, q)
    w = torch.clamp(q[..., 0], -1.0, 1.0)
    vnorm = norm(q[..., 1:4])
    angle = 2.0 * torch.atan2(vnorm, w)
    scale = torch.where(vnorm < 1e-8, torch.full_like(vnorm, 2.0),
                        angle / torch.clamp(vnorm, min=1e-12))
    return scale[..., None] * q[..., 1:4]


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    return quat_to_mat(quat_exp(w))


def so3_log(R: torch.Tensor) -> torch.Tensor:
    return quat_log(mat_to_quat(R))


# ---------------------------------------------------------------------------
# Euler (yaw-pitch-roll, ZYX, radians)
# ---------------------------------------------------------------------------


def ypr_to_mat(ypr: torch.Tensor) -> torch.Tensor:
    """[yaw, pitch, roll] -> R = Rz(y) Ry(p) Rx(r)."""
    y, p, r = ypr[..., 0], ypr[..., 1], ypr[..., 2]
    cy, sy = torch.cos(y), torch.sin(y)
    cp, sp = torch.cos(p), torch.sin(p)
    cr, sr = torch.cos(r), torch.sin(r)
    return torch.stack(
        [
            torch.stack([cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr], -1),
            torch.stack([sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr], -1),
            torch.stack([-sp, cp * sr, cp * cr], -1),
        ],
        -2,
    )


def mat_to_ypr(R: torch.Tensor) -> torch.Tensor:
    yaw = torch.atan2(R[..., 1, 0], R[..., 0, 0])
    pitch = torch.atan2(-R[..., 2, 0], torch.sqrt(R[..., 2, 1] ** 2 + R[..., 2, 2] ** 2))
    roll = torch.atan2(R[..., 2, 1], R[..., 2, 2])
    return torch.stack([yaw, pitch, roll], -1)


def quat_to_ypr(q: torch.Tensor) -> torch.Tensor:
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    roll = torch.atan2(2.0 * (w * x + y * z), 1.0 - 2.0 * (x * x + y * y))
    pitch = torch.arcsin(torch.clamp(2.0 * (w * y - x * z), -1.0, 1.0))
    yaw = torch.atan2(2.0 * (w * z + x * y), 1.0 - 2.0 * (y * y + z * z))
    return torch.stack([yaw, pitch, roll], -1)


def ypr_to_quat(ypr: torch.Tensor) -> torch.Tensor:
    return mat_to_quat(ypr_to_mat(ypr))


def wrap_angle(a: torch.Tensor) -> torch.Tensor:
    """Wrap angle(s) to (-pi, pi]."""
    return a - 2.0 * PI * torch.floor((a + PI) / (2.0 * PI))


def wrap_rollpitch(a: torch.Tensor) -> torch.Tensor:
    """Half-wrap to [-pi/2, pi/2] by a single ±pi shift."""
    return torch.where(a > PI / 2, a - PI, torch.where(a < -PI / 2, a + PI, a))


# ---------------------------------------------------------------------------
# SE(3) as (q, t) pairs
# ---------------------------------------------------------------------------


def se3_apply(q: torch.Tensor, t: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    return quat_rotate(q, pts) + t


def se3_inverse(q: torch.Tensor, t: torch.Tensor):
    qi = quat_conj(q)
    return qi, -quat_rotate(qi, t)


def se3_compose(qa, ta, qb, tb):
    """(qa, ta) ∘ (qb, tb): apply b first, then a."""
    return quat_mul(qa, qb), quat_rotate(qa, tb) + ta


def se3_mat(q: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    R = quat_to_mat(q)
    top = torch.cat([R, t[..., :, None]], -1)
    bottom = const((0.0, 0.0, 0.0, 1.0), q.dtype, q.device).expand(top.shape[:-2] + (1, 4))
    return torch.cat([top, bottom], -2)


JACOBI_SWEEPS = 6


def _jacobi_rounds(n: int, dtype, device):
    """The parallel (round-robin) ordering of one Jacobi sweep over an n x n
    matrix, n even: n - 1 rounds of n/2 disjoint index pairs (p, q) that
    cover every index.  Per round: p and q [n/2], the flat index p * n + q,
    and the one-hot matrices that place the rotations' cosines (at (p, p)
    and (q, q)) and sines (+ at (p, q), - at (q, p)) into one n x n
    rotation [n/2, n, n] each.  Cached by ``const``."""
    others = list(range(1, n))
    rounds = []
    for _ in range(n - 1):
        order = [0] + others
        rounds.append([(min(order[i], order[n - 1 - i]), max(order[i], order[n - 1 - i]))
                       for i in range(n // 2)])
        others = others[-1:] + others[:-1]
    p = tuple(tuple(a for a, _ in r) for r in rounds)
    q = tuple(tuple(b for _, b in r) for r in rounds)
    pq = tuple(tuple(a * n + b for a, b in r) for r in rounds)
    cos = tuple(tuple(tuple(tuple(float(i == j and i in (a, b)) for j in range(n))
                            for i in range(n)) for a, b in r) for r in rounds)
    sin = tuple(tuple(tuple(tuple(float(i == a and j == b) - float(i == b and j == a)
                                  for j in range(n)) for i in range(n)) for a, b in r)
                for r in rounds)
    return (const(p, torch.long, device), const(q, torch.long, device),
            const(pq, torch.long, device), const(cos, dtype, device), const(sin, dtype, device))


def eigh_jacobi(A: torch.Tensor, sweeps: int = JACOBI_SWEEPS):
    """Eigendecomposition (ascending) of symmetric matrices [..., n, n], n
    even, by ``sweeps`` sweeps of parallel cyclic Jacobi: each round
    rotates n/2 disjoint pairs (p, q) at once, A <- Rᵀ A R and V <- V R,
    with each pair's rotation the one that zeroes a_pq (Golub & Van Loan,
    sym.schur2).  A fixed count and no host read, so a CUDA graph can hold
    it (``torch.linalg.eigh`` cannot: ``eigh_or_nan``).  Four sweeps took
    seeded 12 x 12 normal matrices of eigenvalues 1e-5..1e7 to float64's
    last bits; the default is 6 (``tests/test_torch_capture.py``).  A matrix
    holding NaN gives NaN throughout, as ``jnp.linalg.eigh`` does."""
    n = A.shape[-1]
    p, q, pq, cos, sin = _jacobi_rounds(n, A.dtype, A.device)
    V = torch.eye(n, dtype=A.dtype, device=A.device).expand(A.shape).clone()
    one = torch.ones((), dtype=A.dtype, device=A.device)
    for _ in range(sweeps):
        for r in range(n - 1):
            diag = A.diagonal(dim1=-2, dim2=-1)
            app, aqq = diag.index_select(-1, p[r]), diag.index_select(-1, q[r])
            apq = A.flatten(-2).index_select(-1, pq[r])
            zero = apq == 0
            tau = (aqq - app) / (2 * torch.where(zero, one, apq))
            t = torch.where(tau >= 0, one, -one) / (torch.abs(tau) + torch.sqrt(1 + tau * tau))
            t = torch.where(zero, torch.zeros_like(t), t)
            c = 1 / torch.sqrt(1 + t * t)
            R = (torch.einsum("...k,kij->...ij", c, cos[r])
                 + torch.einsum("...k,kij->...ij", t * c, sin[r]))
            A = R.transpose(-1, -2) @ A @ R
            V = V @ R
    w, order = torch.sort(A.diagonal(dim1=-2, dim2=-1), -1)
    return w, torch.gather(V, -1, order[..., None, :].expand(V.shape))


def _finite_or_eye(A: torch.Tensor):
    """(per-matrix finiteness [...], A with each non-finite matrix replaced
    by the identity): the input torch's decompositions accept."""
    ok = torch.isfinite(A).flatten(-2).all(-1)
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    return ok, torch.where(ok[..., None, None], A, eye)


def eigh_or_nan(A: torch.Tensor):
    """``torch.linalg.eigh`` (ascending) where a matrix holding NaN or inf
    gives NaN eigenvalues and eigenvectors, as ``jnp.linalg.eigh`` does on
    such input, instead of raising.  On a CUDA tensor the call makes the
    host wait for the device, one matrix or a batch alike: its error check
    reads the solver's status back (one sync a call under torch's sync
    debug mode; queued behind a 50.5 ms kernel the call returned only after
    it: ``chip_smoke.py`` phase 4, NVIDIA H100 80GB HBM3 at 700 W), so a
    CUDA graph cannot hold it (``chip_smoke.py`` phase 12's probe).  The
    step calls it on the CPU only, in the ground fit
    (``ops/features._ground_eigh``; the card's is ``ops/covariance.eigh3x3``);
    the degeneracy projection's 12 x 12 goes through ``eigh_jacobi``."""
    ok, A = _finite_or_eye(A)
    w, V = torch.linalg.eigh(A)
    nan = torch.full((), torch.nan, dtype=A.dtype, device=A.device)
    return torch.where(ok[..., None], w, nan), torch.where(ok[..., None, None], V, nan)


def svd_or_nan(A: torch.Tensor):
    """``torch.linalg.svd`` of square matrices, NaN for a matrix holding
    NaN or inf (``jnp.linalg.svd``'s result on such input) instead of
    raising.  On a CUDA tensor the call makes the host wait for the device,
    one matrix or a batch alike (two syncs a call under torch's sync debug
    mode; queued behind a 50.5 ms kernel the call returned only after it:
    ``chip_smoke.py`` phase 4, NVIDIA H100 80GB HBM3 at 700 W)."""
    ok, A = _finite_or_eye(A)
    U, S, Vh = torch.linalg.svd(A)
    nan = torch.full((), torch.nan, dtype=A.dtype, device=A.device)
    m = ok[..., None, None]
    return torch.where(m, U, nan), torch.where(ok[..., None], S, nan), torch.where(m, Vh, nan)
