"""The mapping LM's linearisation kernel (csrc/map_lm.cu) on the card.

Needs a CUDA device and nvcc; every test is marked ``gpu`` and skips
without a device (decided in a fixture, at run time).  This file imports
neither jax nor the repository's conftest fixtures:

    python -m pytest --noconftest -q tests/test_torch_map_lm_cuda.py

- H, g, the cost and the trial cost against the plain version (J from
  ``factors.jacobian``) at the benchmark's capacities (512 / 512 / 2048 /
  2048 query points) and at ragged sizes, both losses, the IMU and ground
  weights at 0 and 1, an sp rank's ``rep_scale``, rows at weight 0, at x =
  0 and after a step.  Each part is compared on its own: H's two diagonal
  6x6 blocks and its cross block (filled by the IMU's relative-rotation
  rows alone, some 1e-6 of H's norm), g's two halves, the cost and the
  trial cost.  The tolerance: the float32 autodiff route is itself some
  distance from the float64 autodiff values (rounding of ~7,200 rows
  summed in float32); the kernel must be within 2x that distance, or 1e-6
  relative (Frobenius, against the part's own float64 norm), whichever is
  larger.  For the ``l1`` loss, whose weight's derivative jumps at Huber's
  edge, points within 1e-4 of the edge at x are left out (weight 0) in all
  three, as a float32 block norm may fall on either side of it
  (``tools/map_lm_bench.off_the_l1_edge``).
- Two launches give the same bits (no float atomics); a launch over lanes
  (the fleet's ``vmap``) gives each lane the bits of its problem alone.
- ``scan_to_map_solve`` captured into a CUDA graph and replayed gives the
  eager kernel route's bits, and the graph holds 24 evaluations.
- ``utils/parity_gates``' mapping-solve oracle passes its gates through the
  kernel; ``SlamSystem`` counts 24 evaluations a call, eager and replayed;
  a fleet step launches 24, each over all its robots.
"""
import dataclasses

import pytest
import torch

from rgc_slam_tpu_torch.config import TEST_CONFIG
from rgc_slam_tpu_torch.io import synthetic
from rgc_slam_tpu_torch.io.convert import cloud_from_scan_dict, imu_from_interval
from rgc_slam_tpu_torch.models import mapping as mp
from rgc_slam_tpu_torch.models.slam import SlamState, SlamSystem
from rgc_slam_tpu_torch.ops import cuda as cuda_ops
from rgc_slam_tpu_torch.ops.cuda import map_lm
from rgc_slam_tpu_torch.parallel import fleet
from rgc_slam_tpu_torch.tools import map_lm_bench as problems
from rgc_slam_tpu_torch.types import tree_stack
from rgc_slam_tpu_torch.utils import parity_gates, profiling


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda:0")


def _rel(a, b) -> float:
    a, b = a.double().cpu().reshape(-1), b.double().cpu().reshape(-1)
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b).clamp(min=1e-300))


def _to(consts, device):
    def move(v):
        return type(v)(*(move(x) for x in v)) if isinstance(v, tuple) else v.to(device)

    return {k: move(v) for k, v in consts.items()}


CASES = [  # (sizes, seed, loss, w_imu, w_ground, rep_scale, x scale)
    (problems.CELL_SIZES, 0, "huber", 1.0, 1.0, 1.0, 0.0),
    (problems.CELL_SIZES, 1, "huber", 1.0, 1.0, 1.0, 0.01),
    (problems.CELL_SIZES, 2, "l1", 1.0, 1.0, 1.0, 0.01),
    (problems.CELL_SIZES, 3, "huber", 0.0, 0.0, 1.0, 0.01),
    (problems.CELL_SIZES, 9, "huber", 1.0, 0.0, 1.0, 0.01),
    (problems.CELL_SIZES, 10, "l1", 1.0, 1.0, 0.5 ** 0.5, 0.01),
    ((37, 70, 129, 1), 4, "l1", 0.0, 1.0, 1.0, 0.0),
    ((100, 3, 200, 65), 5, "huber", 1.0, 0.0, 1.0, 0.02),
    ((0, 5, 63, 64), 6, "l1", 1.0, 1.0, 1.0, 0.01),
]


def _parts(H, g, cost, trial):
    """The parts compared one by one: H's diagonal blocks and its cross
    block, g's halves, the costs."""
    return {"H current": H[:6, :6], "H last": H[6:, 6:], "H cross": H[:6, 6:],
            "g current": g[:6], "g last": g[6:], "cost": cost, "trial cost": trial}


@pytest.mark.gpu
@pytest.mark.parametrize("sizes,seed,loss,w_imu,w_ground,rep_scale,scale", CASES)
def test_kernel_matches_plain(cuda, sizes, seed, loss, w_imu, w_ground, rep_scale, scale):
    c64 = problems.problem(sizes, seed, w_imu=w_imu, w_ground=w_ground, rep_scale=rep_scale,
                           dtype=torch.float64)
    x = problems.tangent(seed, scale, device=cuda)
    if loss == "l1":
        c64, _ = problems.off_the_l1_edge(c64, x)
    c32 = _to(problems.to(c64, torch.float32), cuda)
    fns = problems.functions(loss)
    plain64 = map_lm.plain_linearizer(*fns, c64)
    plain32 = map_lm.plain_linearizer(*fns, c32)
    kernel = map_lm.linearizer(c32, loss)
    x64, trial = x.double().cpu(), x + 0.003
    want = _parts(*plain64(x64), plain64(trial.double().cpu(), derivatives=False))
    f32 = _parts(*plain32(x), plain32(trial, derivatives=False))
    got = _parts(*kernel(x), kernel(trial, derivatives=False))
    torch.cuda.synchronize()
    assert float(torch.linalg.norm(want["H cross"])) > 0 or w_imu == 0
    for name in want:
        k, p, w = got[name], f32[name], want[name]
        assert k.dtype == torch.float32 and k.shape == p.shape, name
        err, ref = _rel(k, w), _rel(p, w)
        assert err <= max(2.0 * ref, 1e-6), (name, err, ref)


@pytest.mark.gpu
def test_two_launches_are_bit_equal(cuda):
    c = _to(problems.problem(problems.CELL_SIZES, 8), cuda)
    kernel = map_lm.linearizer(c, "huber")
    x = problems.tangent(8, device=cuda)
    a, b = kernel(x), kernel(x)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    assert torch.equal(kernel(x, derivatives=False), kernel(x, derivatives=False))
    assert torch.equal(a[0], a[0].T)


@pytest.mark.gpu
@pytest.mark.parametrize("loss", ["huber", "l1"])
def test_lanes_give_each_problem_its_own_bits(cuda, loss):
    """``vmap`` over three problems of one size (the fleet's route): one
    launch an evaluation, each lane bit-equal to its problem alone."""
    cs = [_to(problems.problem(problems.CELL_SIZES, s, w_ground=float(s % 2)), cuda)
          for s in range(3)]
    xs = torch.stack([problems.tangent(s, device=cuda) for s in range(3)])

    def evaluate(c, x):
        lin = map_lm.linearizer(c, loss)
        return (*lin(x), lin(x, derivatives=False))

    map_lm.reset_counts()
    got = torch.func.vmap(evaluate)(tree_stack(cs), xs)
    assert map_lm.launches == 2
    for b in range(3):
        alone = evaluate(cs[b], xs[b])
        assert all(torch.equal(a[b], w) for a, w in zip(got, alone)), b


def _solve_args(cuda, monkeypatch):
    """The arguments ``parity_gates.mapping_solve`` hands ``scan_to_map_solve``
    on the card."""
    seen = []
    solve = mp.scan_to_map_solve

    def spy(*args, **kwargs):
        seen.append((args, kwargs))
        return solve(*args, **kwargs)

    monkeypatch.setattr(parity_gates, "scan_to_map_solve", spy)
    parity_gates.mapping_solve(cuda)
    return seen[0]


@pytest.mark.gpu
def test_captured_solve_replays_the_eager_bits(cuda, monkeypatch):
    args, kwargs = _solve_args(cuda, monkeypatch)
    kwargs = dict(kwargs, debug=False)
    eager = mp.scan_to_map_solve(*args, **kwargs)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with cuda_ops.capture_counts() as held:
        with torch.cuda.graph(graph):
            captured = mp.scan_to_map_solve(*args, **kwargs)
    assert dict(held["map_lm"]) == {1: 24}
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        for a, b in zip(eager[0] + eager[1], captured[0] + captured[1]):
            assert torch.equal(a, b)


@pytest.mark.gpu
def test_parity_gate_through_the_kernel(cuda):
    """The numpy oracle's gates, unchanged, on the kernel route: 2 outer
    iterations x 6 LM iterations, one linearisation and one trial cost
    each."""
    map_lm.reset_counts()
    record = parity_gates.mapping_solve(cuda)          # raises past a gate
    assert all(v["value"] < v["limit"] for v in record.values()), record
    assert map_lm.launches == 24


def _seq(n_scans):
    return synthetic.generate_sequence(n_scans=n_scans, n_azimuth=120, seed=9, extent=15.0,
                                       radius=6.0, noise=0.004, closes_loop=False, speed=1.5)


def _inputs(seq, k, cfg, dev):
    t_imu, acc, gyr = seq["imu"][k]
    return (cloud_from_scan_dict(seq["scans"][k], cfg, dev),
            imu_from_interval(t_imu, acc, gyr, cfg.max_imu, dev), seq["stamps"][k])


@pytest.mark.gpu
def test_slam_system_counts_the_evaluations(cuda, monkeypatch):
    """``map_lm_evals`` a call: 2 x 6 x 2 = 24 at two outer iterations, the
    eager first call and the replays alike."""
    tracer = profiling.Tracer()
    monkeypatch.setattr(profiling, "tracer", tracer)
    cfg = dataclasses.replace(TEST_CONFIG, loop_closure_enable=False)
    seq = _seq(4)
    system = SlamSystem(cfg, device=cuda)
    for k in range(3):
        system.process(*_inputs(seq, k, cfg, cuda))
    per_call = 2 * 6 * cfg.map_opt_iterations
    assert [r.counters["map_lm_evals"] for r in tracer.records] == [per_call] * 3
    assert tracer.summary()["counter.map_lm_evals"]["max"] == per_call


@pytest.mark.gpu
def test_fleet_step_launches_the_kernel_over_its_robots(cuda):
    """Under the fleet's ``vmap`` the mapping LM runs the kernel: 2 x 6 x 2 =
    24 evaluations a fleet step, each one launch over every robot."""
    cfg = dataclasses.replace(TEST_CONFIG, inline_compaction=False)
    seq = _seq(2)
    lanes = [_inputs(seq, 0, cfg, cuda) for _ in range(3)]
    states = tree_stack([SlamState.init(cfg, cuda) for _ in range(3)])
    clouds, imus = tree_stack([x[0] for x in lanes]), tree_stack([x[1] for x in lanes])
    stamps = torch.tensor([x[2] for x in lanes], dtype=torch.float32, device=cuda)
    map_lm.reset_counts()
    state, out = fleet.fleet_step(states, clouds, imus, stamps, cfg)
    torch.cuda.synchronize()
    assert map_lm.launches == 2 * 6 * cfg.map_opt_iterations
    assert bool(torch.isfinite(out.t_map).all())
