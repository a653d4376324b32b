"""Wrapper of the mapping LM's linearisation kernel (``csrc/map_lm.cu``).

Replaces no TPU kernel: the JAX package forms the 12-dim scan-to-map
problem's Jacobian by ``jax.jacfwd``, and the port's autodiff route by
``ops/factors.jacobian`` (``vmap`` of ``jvp``), some 5,000 small kernels
an LM iteration on the card.  One evaluation here is two launches: a
kernel over the four query clouds' points that differentiates each point's
rows with Jets and sums its JᵀJ, Jᵀr and ρ into per-block partials, and a
kernel that sums the partials in block order and adds the 13 NULL-loss
rows.  It returns H [12, 12], g [12] and the robust cost (the
linearisation), or the cost alone (a trial step): what ``factors.ceres_lm``
reads of ``residual_fn`` and ``cost_fn``.

``linearizer(consts, loss)`` gives the kernel's evaluation of one frozen
set of correspondences (``models/mapping.scan_to_map_solve``'s
``consts``) on the card; it raises for tensors elsewhere (the CPU takes
the autodiff route, chosen in ``scan_to_map_solve``) and on what the
kernel does not take.  ``plain_linearizer`` is the same function in plain
PyTorch, J from ``factors.jacobian``.  The launch is the custom operator
``rgc_slam::map_lm`` over a leading batch of problems of one size; under
``torch.func.vmap`` (the fleet, ``parallel/fleet.py``) its vmap rule folds
the vmapped dimension into that batch, so every robot rides one launch.
The library is built with ``nvcc`` at first use, like ``knn``'s.

``launches`` counts the evaluations the wrapper launched (one an operator
call, whatever the batch).  An evaluation recorded into a CUDA graph being
captured launches nothing: it must be made inside ``capture_counts()``,
which collects what the graph holds (elsewhere it raises), and
``utils.graph`` adds a replayed graph's evaluations to ``replayed``;
``evaluations()`` is the sum of the two.
"""
from __future__ import annotations

import contextlib
import ctypes
import os
import threading
from collections import Counter
from typing import Callable, List, Optional

import torch

from . import BUILD_DIR, CSRC, build_library, register_counts
from .. import factors as fac

SOURCE = os.path.join(CSRC, "map_lm.cu")
LIBRARY = os.path.join(BUILD_DIR, "libmap_lm.so")
BLOCK = 64           # the points kernel's threads a block (kBlock)
PART = 28            # a block's partial with derivatives: 21 JᵀJ, 6 Jᵀr, ρ
OUT = 157            # a lane's result with derivatives: H, g, cost (kOut)
MAX_LANES = 65535    # the points kernel's grid y extent
# the order of the packed constants: csrc/map_lm.cu's P_* offsets
PARAMS = ("q", "t", "ql", "tl", "delta_q_imu", "imu_cov", "w_imu", "rep_scale", "imu_ypr",
          "imu_ypr_last", "g_last", "g_cur", "g_last2", "q_w_last2", "t_w_last2", "q_w_curr_f",
          "q_w_curr_f2", "w_ground")
N_PARAMS = 73        # kParams
# the query clouds in the kernel's order, with their correspondences' fields
CLOUDS = (("corner", "ec", ("pa", "pb")), ("cornl", "ecl", ("pa", "pb")),
          ("surf", "pc", ("n", "d")), ("surfl", "pcl", ("n", "d")))

# rgc_map_lm_launch(x, params, clouds, sizes, lanes, l1, derivatives, partials, out, stream)
ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3

launches = 0
replayed = 0
_captured: Optional[Counter] = None      # lanes -> evaluations recorded into a graph
_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def reset_counts():
    """Set ``launches`` and ``replayed`` to zero."""
    global launches, replayed
    launches = replayed = 0


def evaluations() -> int:
    """The evaluations launched and replayed so far."""
    return launches + replayed


@contextlib.contextmanager
def capture_counts():
    """Around a CUDA graph's capture: yields a Counter (by lanes) of the
    evaluations recorded into the graph, which ``launches`` does not count.
    An evaluation made while capturing outside this block raises."""
    global _captured
    outer, _captured = _captured, Counter()
    try:
        yield _captured
    finally:
        _captured = outer


def _add_replayed(counter: Counter):
    global replayed
    replayed += sum(counter.values())


register_counts("map_lm", capture_counts, _add_replayed)


def build(verbose: bool = False) -> str:
    """Compile ``csrc/map_lm.cu`` unless the library is newer than it."""
    return build_library(SOURCE, LIBRARY, verbose)


def _get_lib() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            fn = lib.rgc_map_lm_launch
            fn.restype = ctypes.c_int
            fn.argtypes = ARGTYPES
            _lib = lib
    return _lib


def plain_linearizer(residual_fn: Callable, cost_fn: Callable, consts) -> Callable:
    """The plain version: ``lin(x)`` -> (H, g, cost) with J from
    ``factors.jacobian`` of ``residual_fn(x, consts)``, and ``lin(x,
    derivatives=False)`` -> ``cost_fn(x, consts)``."""

    def lin(x, derivatives: bool = True):
        if not derivatives:
            return cost_fn(x, consts)
        r = residual_fn(x, consts)
        J = fac.jacobian(residual_fn, x, consts)
        return J.T @ J, J.T @ r, cost_fn(x, consts)

    return lin


def pack_params(c) -> torch.Tensor:
    """The problem's poses, IMU and ground constants as one float32 vector
    [N_PARAMS] in ``PARAMS`` order (a ground plane as normal, v1, v2,
    distance)."""
    parts = []
    for name in PARAMS:
        v = c[name]
        fields = (v.normal, v.v1, v.v2, v.distance) if isinstance(v, fac.PlaneParams) else (v,)
        parts.extend(f.reshape(-1) for f in fields)
    out = torch.cat(parts)
    if out.shape != (N_PARAMS,) or out.dtype != torch.float32:
        raise ValueError(f"map_lm kernel: the constants pack to {tuple(out.shape)} "
                         f"{out.dtype} values, not {N_PARAMS} float32")
    return out


def cloud_tensors(c):
    """The kernel's 16 cloud operands (per cloud: points, the two
    correspondence fields, the weight) and the 4 sizes, checked: float32,
    shapes [n, 3] / [n] as the cloud."""
    tensors, sizes = [], []
    for pts_key, corr_key, fields in CLOUDS:
        pts, corr = c[pts_key], c[corr_key]
        n = pts.shape[0]
        ops = (pts, getattr(corr, fields[0]), getattr(corr, fields[1]), corr.w)
        shapes = ((n, 3), (n, 3), (n, 3) if fields[1] == "pb" else (n,), (n,))
        for x, shape in zip(ops, shapes):
            if x.dtype != torch.float32 or tuple(x.shape) != shape:
                raise ValueError(f"map_lm kernel: {pts_key} needs float32 operands of shapes "
                                 f"{shapes}")
        tensors.extend(ops)
        sizes.append(n)
    return tensors, sizes


def _launch(x, params, clouds, l1: bool, derivatives: bool) -> torch.Tensor:
    """One launch over B lanes: x [B, 12], params [B, N_PARAMS] and the 16
    cloud operands [B, n, ...], contiguous float32 on one CUDA device."""
    global launches
    lanes, dev = x.shape[0], x.device
    if any(t.device != dev or t.dtype != torch.float32 or not t.is_contiguous()
           or t.shape[0] != lanes for t in (x, params, *clouds)):
        raise ValueError("map_lm kernel: every operand must be contiguous float32 [lanes, ...] "
                         "on one device")
    if x.shape != (lanes, 12) or params.shape != (lanes, N_PARAMS) or len(clouds) != 16:
        raise ValueError("map_lm kernel: x must be [lanes, 12], params [lanes, "
                         f"{N_PARAMS}], and there must be 16 cloud operands")
    if not 1 <= lanes <= MAX_LANES:
        raise ValueError(f"map_lm kernel: {lanes} lanes, not 1..{MAX_LANES}")
    if dev.type != "cuda":
        raise ValueError(f"map_lm kernel: tensors on {dev}; the kernel runs on CUDA only")
    sizes = [clouds[4 * c].shape[1] for c in range(4)]
    for c, n in enumerate(sizes):
        edge = c < 2
        want = ((lanes, n, 3), (lanes, n, 3), (lanes, n, 3) if edge else (lanes, n), (lanes, n))
        if tuple(tuple(t.shape) for t in clouds[4 * c:4 * c + 4]) != want:
            raise ValueError(f"map_lm kernel: cloud {c}'s operands must be of shapes {want}")
    capturing = torch.cuda.is_current_stream_capturing()
    if capturing and _captured is None:
        raise RuntimeError("map_lm kernel: an evaluation recorded into a CUDA graph "
                           "outside capture_counts(); its replays would go uncounted")
    blocks = sum(-(-n // BLOCK) for n in sizes)
    part = PART if derivatives else 1
    partials = torch.empty((lanes, max(blocks, 1), part), dtype=torch.float32, device=dev)
    out = torch.empty((lanes, OUT if derivatives else 1), dtype=torch.float32, device=dev)
    ptrs = (ctypes.c_void_p * 16)(*(t.data_ptr() for t in clouds))
    lib = _get_lib()
    with torch.cuda.device(dev):
        err = lib.rgc_map_lm_launch(
            x.data_ptr(), params.data_ptr(), ptrs, (ctypes.c_int * 4)(*sizes), lanes, int(l1),
            int(derivatives), partials.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"map_lm kernel launch failed: cudaError {err}")
    if capturing:
        _captured[lanes] += 1
    else:
        launches += 1
    return out


@torch.library.custom_op("rgc_slam::map_lm", mutates_args=())
def map_lm_batched(x: torch.Tensor, params: torch.Tensor, clouds: List[torch.Tensor], l1: bool,
                   derivatives: bool) -> torch.Tensor:
    """B evaluations at once: x [B, 12], params [B, N_PARAMS], the 16 cloud
    operands [B, n, 3] / [B, n] -> [B, OUT] (H row-major, g, cost) with
    ``derivatives``, else [B, 1] (the cost).  CUDA tensors only."""
    return _launch(x, params, clouds, l1, derivatives)


@map_lm_batched.register_fake
def _map_lm_fake(x, params, clouds, l1, derivatives):
    return x.new_empty((x.shape[0], OUT if derivatives else 1))


def fold_lanes(lanes: int, in_dims, tensors):
    """The vmap rule's operands: each tensor's vmapped dimension moved to the
    front and folded into the batch ([V, B, ...] -> [V * B, ...]), an
    unbatched one (dim None) repeated over the V lanes; all contiguous."""
    def fold(t, dim):
        t = t.movedim(dim, 0) if dim is not None else t.expand(lanes, *t.shape)
        return t.flatten(0, 1).contiguous()

    return [fold(t, d) for t, d in zip(tensors, in_dims)]


def _map_lm_vmap(info, in_dims, x, params, clouds, l1, derivatives):
    lanes = info.batch_size
    x, params = fold_lanes(lanes, in_dims[:2], (x, params))
    out = map_lm_batched(x, params, fold_lanes(lanes, in_dims[2], clouds), l1, derivatives)
    return out.unflatten(0, (lanes, -1)), 0


map_lm_batched.register_vmap(_map_lm_vmap)


class _KernelLinearizer:
    """One frozen problem on the card: its packed constants and cloud
    operands, evaluated by ``__call__`` as ``plain_linearizer``'s ``lin``
    (one lane of ``map_lm_batched``; under vmap, every lane at once)."""

    def __init__(self, consts, loss: str):
        if loss not in ("huber", "l1"):
            raise ValueError(f"map_lm kernel: loss {loss!r} is neither 'huber' nor 'l1'")
        self.l1 = loss == "l1"
        self.params = pack_params(consts)[None]
        tensors, _ = cloud_tensors(consts)
        self.clouds = [t[None] for t in tensors]

    def __call__(self, x: torch.Tensor, derivatives: bool = True):
        if x.dtype != torch.float32 or x.shape != (12,):
            raise ValueError("map_lm kernel: x must be float32 [12]")
        out = map_lm_batched(x[None], self.params, self.clouds, self.l1, derivatives)[0]
        if not derivatives:
            return out[0]
        return out[:144].view(12, 12), out[144:156], out[156]


def linearizer(consts, loss: str) -> Callable:
    """The kernel's evaluation of the frozen problem ``consts`` (CUDA
    tensors): ``lin(x)`` -> (H, g, cost), ``lin(x, derivatives=False)`` ->
    cost, as ``plain_linearizer``'s."""
    dev = consts["corner"].device
    if dev.type != "cuda":
        raise ValueError(f"map_lm: the kernel takes CUDA tensors, not tensors on {dev}")
    return _KernelLinearizer(consts, loss)
