"""The mapping LM's linearizer entry (``ops/factors.ceres_lm_linearized``),
its plain linearizer (``ops/cuda/map_lm.plain_linearizer``) and the choice
of route in ``models/mapping.scan_to_map_solve``, on the CPU.

- The linearizer entry, driven by the plain linearizer, against
  ``ceres_lm`` on seeded mapping problems (both losses, IMU and ground
  factors on and off).  The two differ only in how the model cost change is
  rounded (-(sᵀg + ½ sᵀHs) against -(Js·(r + Js/2))), which enters only the
  accept test and the radius update: the tangents agree to 1e-6 of their
  scale (on these problems they are bit-equal).
- ``ceres_lm`` itself gives the bits it gave before the linearizer entry
  shared its trust-region loop: a frozen copy of the earlier function, on
  mapping problems, a curved problem with rejected steps (plain and under
  ``vmap``) and the odometry's fusion solve.
- Under ``psum_axis`` (the sp-sharded solve, 2 gloo ranks) the linearizer
  entry sums H, g and the costs and agrees with ``ceres_lm``'s sums.
- The route: the kernel for every CUDA tensor (the single stream, the
  fleet's ``vmap``, the sp solve), the autodiff route on the CPU, where
  ``scan_to_map_solve``'s consts pack as the kernel takes them.  The
  kernel's operator under ``vmap`` (a fake launch in its place) folds the
  lanes into one batch, nested and with unbatched operands, and gives each
  lane its own problem's result; the launch refuses CPU tensors and
  operands it cannot take.  The graph registry (``ops/cuda``) holds both
  kernels' counts.  The tracer's ``map_lm_evals`` reads 0 a call on the
  CPU.

Imports no jax.  The kernel itself is tested on the card
(``tests/test_torch_map_lm_cuda.py``).
"""
import ctypes
import dataclasses
import os
import re

import numpy as np
import pytest
import torch

import torch_sp_ranks as ranks
from rgc_slam_tpu_torch.config import TEST_CONFIG
from rgc_slam_tpu_torch.io import synthetic
from rgc_slam_tpu_torch.io.convert import cloud_from_scan_dict, imu_from_interval
from rgc_slam_tpu_torch.models import mapping as mp
from rgc_slam_tpu_torch.models import odometry as odo
from rgc_slam_tpu_torch.models.slam import SlamSystem
from rgc_slam_tpu_torch.ops import cuda as cuda_ops
from rgc_slam_tpu_torch.ops import factors as fac
from rgc_slam_tpu_torch.ops.cuda import knn as knn_cuda
from rgc_slam_tpu_torch.ops.cuda import map_lm
from rgc_slam_tpu_torch.parallel.distributed import run_ranks
from rgc_slam_tpu_torch.tools import map_lm_bench as problems
from rgc_slam_tpu_torch.types import GroundPlane, tree_stack
from rgc_slam_tpu_torch.utils import parity_gates, profiling
from rgc_slam_tpu_torch.utils import math3d as m3

torch.set_num_threads(1)

SMALL = (40, 30, 120, 90)
CASES = [  # (seed, loss, w_imu, w_ground, sizes)
    (0, "huber", 1.0, 1.0, SMALL), (1, "l1", 1.0, 1.0, SMALL), (2, "huber", 0.0, 1.0, SMALL),
    (3, "huber", 1.0, 0.0, SMALL), (4, "l1", 0.0, 0.0, SMALL),
    (5, "huber", 1.0, 1.0, (7, 1, 3, 64)),
]


def _ceres_lm_before(residual_fn, cost_fn, dim, iterations, consts, project=None,
                     radius0=1e4, min_relative_decrease=1e-3):
    """``factors.ceres_lm`` as it was before it shared ``_trust_region``
    (without ``psum_axis``), frozen."""
    probe = next(iter(fac._leaves(consts)))
    dtype, dev = torch.float32, probe.device
    x = torch.zeros(dim, dtype=dtype, device=dev)
    radius = torch.full((), radius0, dtype=dtype, device=dev)
    dec = torch.full((), 2.0, dtype=dtype, device=dev)
    for _ in range(iterations):
        r = residual_fn(x, consts)
        J = fac.jacobian(residual_fn, x, consts)
        H = J.T @ J
        g = J.T @ r
        cost = cost_fn(x, consts)
        D = torch.clamp(torch.diagonal(H), 1e-6, 1e32) / radius
        step = fac._scaled_solve(H + torch.diag(D), g, 1e-6)
        if project is not None:
            step = project @ step
        model_res = J @ step
        mcc = -(model_res * (r + model_res / 2.0)).sum()
        new_cost = cost_fn(x + step, consts)
        rel_decrease = (cost - new_cost) / torch.where(mcc == 0, torch.full_like(mcc, 1e-30), mcc)
        accept = (mcc > 0) & (rel_decrease > min_relative_decrease) & torch.isfinite(step).all()
        x = torch.where(accept, x + step, x)
        grow = torch.clamp(1.0 - (2.0 * rel_decrease - 1.0) ** 3, min=1.0 / 3.0)
        radius = torch.clamp(torch.where(accept, radius / grow, radius / dec), 1e-32, 1e16)
        dec = torch.where(accept, torch.full_like(dec, 2.0), dec * 2.0)
    return x


@pytest.mark.parametrize("seed,loss,w_imu,w_ground,sizes", CASES)
def test_linearizer_entry_matches_ceres_lm(seed, loss, w_imu, w_ground, sizes):
    c = problems.problem(sizes, seed, w_imu=w_imu, w_ground=w_ground)
    res, cost = problems.functions(loss)
    want = fac.ceres_lm(res, cost, 12, iterations=6, consts=c)
    lin = map_lm.plain_linearizer(res, cost, c)
    got = fac.ceres_lm_linearized(lin, 12, iterations=6, device="cpu")
    assert float(want.abs().max()) > 1e-3          # the solve moved
    assert float((got - want).abs().max()) <= 1e-6 * max(1.0, float(want.abs().max()))


@pytest.mark.parametrize("seed,loss", [(0, "huber"), (1, "l1")])
def test_plain_linearizer_is_the_autodiff_route(seed, loss):
    """The plain linearizer's H, g and costs are those ``ceres_lm`` forms:
    J from ``factors.jacobian``; at x = 0 and at an accepted step."""
    c = problems.problem(SMALL, seed)
    res, cost = problems.functions(loss)
    lin = map_lm.plain_linearizer(res, cost, c)
    for x in (torch.zeros(12), problems.tangent(seed)):
        H, g, k = lin(x)
        J = fac.jacobian(res, x, c)
        assert torch.equal(H, J.T @ J) and torch.equal(g, J.T @ res(x, c))
        assert torch.equal(k, cost(x, c)) and torch.equal(lin(x, derivatives=False), cost(x, c))


def _curved(x, c):
    return torch.cat([10.0 * (x[1:] - x[:-1] ** 2 - 0.1), 1.0 - x - c["a"]])


def _curved_cost(x, c):
    return 0.5 * (_curved(x, c) ** 2).sum()


@pytest.mark.parametrize("case", ["mapping huber", "mapping l1", "curved", "curved vmap",
                                  "odometry fusion"])
def test_ceres_lm_unchanged_bit_for_bit(case, monkeypatch):
    if case.startswith("mapping"):
        loss = case.split()[1]
        c = problems.problem(SMALL, 7, w_imu=1.0, w_ground=1.0)
        res, cost = problems.functions(loss)
        P = torch.eye(12) - 0.01 * torch.ones(12, 12)      # a projection-shaped map
        for project in (None, P):
            assert torch.equal(fac.ceres_lm(res, cost, 12, 6, c, project=project),
                               _ceres_lm_before(res, cost, 12, 6, c, project=project))
    elif case == "curved":
        c = dict(a=torch.tensor([0.7, 1.3, 0.9, 1.1]))
        assert torch.equal(fac.ceres_lm(_curved, _curved_cost, 4, 8, c),
                           _ceres_lm_before(_curved, _curved_cost, 4, 8, c))
    elif case == "curved vmap":
        a = torch.tensor([[0.7, 1.3, 0.9, 1.1], [1.4, 0.6, 1.0, 0.8]])
        got = torch.func.vmap(lambda a: fac.ceres_lm(_curved, _curved_cost, 4, 8, dict(a=a)))(a)
        want = torch.func.vmap(
            lambda a: _ceres_lm_before(_curved, _curved_cost, 4, 8, dict(a=a)))(a)
        assert torch.equal(got, want)
    else:
        rs = np.random.RandomState(3)
        f = lambda v: torch.tensor(v, dtype=torch.float32)          # noqa: E731
        gp = lambda d: GroundPlane(normal=f([0.01, 0.02, 1.0]) / np.sqrt(1.0005),  # noqa: E731
                                   v1=f([1.0, 0.0, 0.0]), v2=f([0.0, 1.0, 0.0]), distance=f(d),
                                   source=f(0.0), valid=torch.tensor(True))
        args = (m3.quat_exp(f(rs.normal(0, 0.05, 3))), f(rs.normal(0, 0.3, 3)), f(0.07),
                gp(1.6), gp(1.58), m3.quat_exp(f([0.0, 0.0, 0.2])),
                m3.quat_exp(f(rs.normal(0, 0.05, 3))), f(0.4), f(1.0), f(1.0))
        got = odo.fusion_solve(*args)
        monkeypatch.setattr(fac, "ceres_lm", _ceres_lm_before)
        want = odo.fusion_solve(*args)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_kernel_route_choice():
    """The kernel for CUDA tensors, under a functorch transform (the
    fleet's ``vmap``) too; the CPU takes the autodiff route, under ``vmap``
    too.  A CUDA graph's capture plays no part."""
    assert mp.kernel_route("cuda") and mp.kernel_route(torch.device("cuda:0"))
    assert not mp.kernel_route("cpu")
    inside = torch.func.vmap(lambda x: x + float(mp.kernel_route("cuda")))(torch.zeros(2))
    assert torch.equal(inside, torch.ones(2))
    cpu_inside = torch.func.vmap(lambda x: x + float(mp.kernel_route(x.device)))(torch.zeros(2))
    assert torch.equal(cpu_inside, torch.zeros(2))
    with pytest.raises(ValueError, match="CUDA tensors"):
        map_lm.linearizer(problems.problem((3, 2, 5, 4), 0), "huber")


@pytest.mark.parametrize("loss", ["huber", "l1"])
def test_sp_linearized_sums_over_the_axis(loss):
    """Two gloo ranks, each with half of every query cloud: the linearizer
    entry's summed H, g and costs give ``ceres_lm``'s summed solve (within
    1e-6 of its scale, as the one-process entry), the same on both ranks."""
    outs = run_ranks(ranks.mapping_lm_sp, 2, "cpu", (SMALL, 12, loss), timeout_s=240)
    (want, got), (want1, got1) = outs
    assert np.array_equal(want, want1) and np.array_equal(got, got1)
    assert np.abs(want).max() > 1e-3
    assert np.abs(got - want).max() <= 1e-6 * max(1.0, np.abs(want).max())


def _fake_launch(x, params, clouds, l1, derivatives):
    """A launch's stand-in on the CPU: each lane's result a function of
    that lane's operands alone."""
    lanes = x.shape[0]
    feats = torch.cat([x, params] + [c.reshape(lanes, -1).sum(1, keepdim=True) for c in clouds], 1)
    out = torch.cat([feats, feats[:, :map_lm.OUT - feats.shape[1]]], 1) * (2.0 if l1 else 1.0)
    return out if derivatives else out[:, :1]


def test_vmap_rule_folds_the_lanes(monkeypatch):
    """Under ``vmap`` (and ``vmap`` of ``vmap``) the operator's rule folds the
    lanes into one launch's batch, an unbatched operand repeated over them,
    and each lane reads its own problem's result."""
    calls = []

    def launch(*args):
        calls.append(args[0].shape[0])
        return _fake_launch(*args)

    monkeypatch.setattr(map_lm, "_launch", launch)
    cs = [problems.problem((7, 5, 9, 4), s) for s in range(6)]
    xs = torch.stack([problems.tangent(s) for s in range(6)])

    def evaluate(c, x):
        lin = map_lm._KernelLinearizer(c, "l1")
        return (*lin(x), lin(x, derivatives=False))

    def want(c, x):
        return evaluate(c, x)

    got = torch.func.vmap(evaluate)(tree_stack(cs), xs)
    assert calls[-2:] == [6, 6]
    for b in range(6):
        assert all(torch.equal(a[b], w) for a, w in zip(got, want(cs[b], xs[b])))
    nested = torch.func.vmap(torch.func.vmap(evaluate))(
        tree_stack([tree_stack(cs[:3]), tree_stack(cs[3:])]), xs.reshape(2, 3, 12))
    assert calls[-2:] == [6, 6]
    for b in range(6):
        assert all(torch.equal(a[b // 3, b % 3], w) for a, w in zip(nested, want(cs[b], xs[b])))
    shared = torch.func.vmap(evaluate, in_dims=(None, 0))(cs[0], xs)   # the consts unbatched
    for b in range(6):
        assert all(torch.equal(a[b], w) for a, w in zip(shared, want(cs[0], xs[b])))


def test_launch_refuses_what_it_cannot_take():
    """CPU tensors, a non-contiguous operand or wrong shapes raise before
    any launch: nothing falls back."""
    c = problems.problem((3, 2, 5, 4), 11)
    params = map_lm.pack_params(c)[None]
    clouds = [t[None] for t in map_lm.cloud_tensors(c)[0]]
    x = torch.zeros(1, 12)
    with pytest.raises(ValueError, match="CUDA only"):
        map_lm.map_lm_batched(x, params, clouds, False, True)
    bent = list(clouds)
    bent[0] = clouds[0].transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous float32"):
        map_lm.map_lm_batched(x, params, bent, False, True)
    with pytest.raises(ValueError, match="16 cloud operands"):
        map_lm.map_lm_batched(x, params, clouds[:12], False, True)
    with pytest.raises(ValueError, match="x must be"):
        map_lm._KernelLinearizer(c, "huber")(torch.zeros(12, dtype=torch.float64))
    with pytest.raises(ValueError, match="neither"):
        map_lm._KernelLinearizer(c, "cauchy")


def test_graph_registry_counts_both_kernels():
    """``ops/cuda.capture_counts`` yields every counting wrapper's capture
    Counter and ``add_replayed`` adds a replay to each."""
    knn_cuda.reset_counts()
    map_lm.reset_counts()
    with cuda_ops.capture_counts() as counted:
        assert {"knn", "map_lm"} <= set(counted)
        counted["knn"][(1, 512, 8192, 5)] += 2
        counted["map_lm"][1] += 24
    frozen = {name: c.copy() for name, c in counted.items()}
    cuda_ops.add_replayed(frozen)
    cuda_ops.add_replayed(frozen)
    assert map_lm.replayed == 48 and map_lm.launches == 0 and map_lm.evaluations() == 48
    assert knn_cuda.replayed == {(1, 512, 8192, 5): 4} and knn_cuda.launches == 0
    knn_cuda.reset_counts()
    map_lm.reset_counts()
    assert map_lm.evaluations() == 0 and not knn_cuda.replayed


def test_cpu_solve_takes_the_autodiff_route(monkeypatch):
    """``utils/parity_gates``' mapping-solve oracle on the CPU: both outer
    iterations call ``ceres_lm`` (never the linearizer entry) and pass the
    gates; the consts they build pack as the kernel takes them."""
    seen = []
    lm = fac.ceres_lm

    def spy(residual_fn, cost_fn, dim, *args, **kwargs):
        seen.append(kwargs["consts"])
        return lm(residual_fn, cost_fn, dim, *args, **kwargs)

    def refuse(*args, **kwargs):
        raise AssertionError("the CPU took the kernel route")

    monkeypatch.setattr(fac, "ceres_lm", spy)
    monkeypatch.setattr(fac, "ceres_lm_linearized", refuse)
    record = parity_gates.mapping_solve(torch.device("cpu"))       # raises past a gate
    assert all(v["value"] < v["limit"] for v in record.values()), record
    assert len(seen) == 2
    for c in seen:
        tensors, sizes = map_lm.cloud_tensors(c)
        assert len(tensors) == 16 and sizes == [40, 40, 80, 80]
        params = map_lm.pack_params(c)
        assert torch.equal(params[0:4], c["q"]) and torch.equal(params[72], c["w_ground"])
        assert torch.equal(params[27:30], c["g_last"].normal)


def test_packing_matches_the_kernels_offsets():
    """``PARAMS`` packs in the order and at the offsets of the kernel's
    ``P_*`` constants, the sizes agree with its own, and a cloud operand of
    another type or shape raises."""
    src = open(os.path.join(map_lm.CSRC, "map_lm.cu")).read()
    offsets = {k: int(v) for k, v in re.findall(r"\b(P_[A-Z0-9_]+) = (\d+)", src)}
    sizes = dict(re.findall(r"constexpr int (k[A-Za-z]+) = (\d+);", src))
    assert int(sizes["kParams"]) == map_lm.N_PARAMS and int(sizes["kBlock"]) == map_lm.BLOCK
    assert "kOut = 144 + 12 + 1;" in src and map_lm.OUT == 157
    entry = re.search(r'extern "C" int rgc_map_lm_launch\(([^)]*)\)', src).group(1)
    args = [a.strip() for a in entry.split(",")]
    ints = [a.startswith("int ") for a in args]
    assert ints == [t is ctypes.c_int for t in map_lm.ARGTYPES], args
    c = problems.problem((3, 2, 5, 4), 11)
    at, layout = 0, {}
    for name in map_lm.PARAMS:
        layout[name] = at
        v = c[name]
        at += 10 if isinstance(v, fac.PlaneParams) else v.numel()
    assert at == map_lm.N_PARAMS
    names = {"P_Q": "q", "P_T": "t", "P_QL": "ql", "P_TL": "tl", "P_DQ": "delta_q_imu",
             "P_IMU_COV": "imu_cov", "P_W_IMU": "w_imu", "P_REP": "rep_scale",
             "P_YPR": "imu_ypr", "P_YPR_L": "imu_ypr_last", "P_G_LAST": "g_last",
             "P_G_CUR": "g_cur", "P_G_LAST2": "g_last2", "P_Q_L2": "q_w_last2",
             "P_T_L2": "t_w_last2", "P_QF": "q_w_curr_f", "P_QF2": "q_w_curr_f2",
             "P_W_GROUND": "w_ground"}
    assert offsets == {k: layout[v] for k, v in names.items()}
    params = map_lm.pack_params(c)
    assert torch.equal(params[layout["g_cur"] + 9], c["g_cur"].distance)
    with pytest.raises(ValueError, match="float32 operands"):
        map_lm.cloud_tensors(dict(c, surf=c["surf"][:, :2]))
    with pytest.raises(ValueError, match="float32 operands"):
        map_lm.cloud_tensors(dict(c, pc=c["pc"]._replace(w=c["pc"].w.double())))


def test_map_lm_evals_counter_reads_zero_on_the_cpu(monkeypatch):
    """``SlamSystem`` records ``map_lm_evals`` in each call's counters and
    the tracer's summary: 0 on the CPU's autodiff route."""
    tracer = profiling.Tracer()
    monkeypatch.setattr(profiling, "tracer", tracer)
    cfg = dataclasses.replace(TEST_CONFIG, loop_closure_enable=False)
    seq = synthetic.generate_sequence(n_scans=3, n_azimuth=120, seed=9, extent=15.0, radius=6.0,
                                      noise=0.004, closes_loop=False, speed=1.5)
    system = SlamSystem(cfg, device="cpu")
    for k in range(2):
        t_imu, acc, gyr = seq["imu"][k]
        system.process(cloud_from_scan_dict(seq["scans"][k], cfg, "cpu"),
                       imu_from_interval(t_imu, acc, gyr, cfg.max_imu, "cpu"), seq["stamps"][k])
    assert [r.counters["map_lm_evals"] for r in tracer.records] == [0, 0]
    summary = tracer.summary()["counter.map_lm_evals"]
    assert summary["count"] == 2 and summary["max"] == 0
