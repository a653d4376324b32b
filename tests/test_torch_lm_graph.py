"""``ops/registration.lm_drive``'s two loops give the same bits.

The masked loop runs every body of the LM's static counts and merges by
``torch.where``; inside a CUDA graph capture the conditional loop
captures the bodies under IF nodes (``ops/cuda/graph_if``), so a replay
skips a stopped lane's bodies.  Three seeded scan pairs (three textured
planes, tests/test_torch_registration.py's scene, the voxel map built by
the port): one that converges in a few outer iterations, one whose last
inner loop reaches its cap of ``lm_max_inner`` rejects (its lane stops with
``trying`` still set, which only the reset of ``trying`` at the top of the
next slot clears), and one that runs all 25 outer slots.

* On the CPU, the conditional loop with a stand-in IF node that reads its
  predicate on the host and skips the body: bit-equal to the masked loop
  and to the early exit (the masked loop at the counts the pair needed),
  with 2 x outer + inner bodies run against the masked 2 x 25 + 250.
* On the card (marked ``gpu``): ``lm_register`` captured with its IF nodes
  and replayed, bit-equal to the eager masked loop on the same inputs, with
  2 x outer + inner bodies run; a replay with another pair's inputs copied
  into the captured buffers follows that pair.

The file imports no jax, so it also runs where only the port's
dependencies are:

    python -m pytest --noconftest -q tests/test_torch_lm_graph.py
"""
import dataclasses

import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

from rgc_slam_tpu_torch.config import TEST_CONFIG
from rgc_slam_tpu_torch.ops import registration
from rgc_slam_tpu_torch.ops import voxelhash as vh
from rgc_slam_tpu_torch.utils import math3d as m3

torch.set_num_threads(1)

CFG = dataclasses.replace(TEST_CONFIG, vgicp_max_iterations=25)
# (scene seed, start rotation and translation offsets, config)
CASES = {
    "converges": (0, 0.0, 0.0, CFG),
    # convergence tests off: the LM stops when an inner loop rejects
    # lm_max_inner steps in a row
    "inner cap": (4, 0.0, 0.0, dataclasses.replace(CFG, rotation_epsilon=0.0,
                                                   translation_epsilon=0.0)),
    # a far start and a large first λ: small accepted steps in every slot
    "all 25 slots": (2, 0.2, 2.0, dataclasses.replace(CFG, rotation_epsilon=0.0,
                                                      translation_epsilon=0.0,
                                                      lm_init_lambda_factor=1e6)),
}
FIELDS = ("q", "t", "fitness", "n_corr", "iterations", "H", "inner")


def _scene(seed):
    """Floor + two walls with bumps, plane-regularized covariances."""
    g = np.random.default_rng(seed)
    n = 1500
    u, v = g.uniform(-8, 8, n), g.uniform(0, 3, n)
    floor = np.stack([g.uniform(-8, 8, n), g.uniform(-8, 8, n), 0.1 * np.sin(u)], 1)
    wall_x = np.stack([np.full(n, 6.0) + 0.1 * np.sin(2 * v), u, v], 1)
    wall_y = np.stack([u, np.full(n, -5.0) + 0.1 * np.cos(u), v], 1)
    pts = np.concatenate([floor, wall_x, wall_y]) + g.normal(0, 0.01, (3 * n, 3))
    normals = np.concatenate([np.tile([0, 0, 1.0], (n, 1)), np.tile([1.0, 0, 0], (n, 1)),
                              np.tile([0, 1.0, 0], (n, 1))])
    covs = np.eye(3)[None] - (1 - 1e-3) * normals[:, :, None] * normals[:, None, :]
    return pts.astype(np.float32), covs.astype(np.float32)


def _pair(case, device="cpu", n_src=1024):
    """``lm_register``'s inputs for ``case`` (the source moved by a known
    motion against the scene's voxel map, the start offset from identity)
    and its config."""
    seed, rot, trans, cfg = CASES[case]
    pts, covs = _scene(seed)
    T = lambda x: torch.from_numpy(np.asarray(x)).to(device)
    vm = vh.build_gaussian_voxelmap(T(pts), T(covs), torch.ones(len(pts), dtype=torch.bool,
                                                                device=device),
                                    1.0, cfg.max_voxels)
    g = np.random.default_rng(seed + 100)
    sel = g.choice(len(pts), n_src, replace=False)
    R = m3.quat_to_mat(m3.quat_exp(torch.tensor([0.01, -0.02, 0.03]))).double().numpy()
    t_true = np.array([0.12, -0.08, 0.03])
    src = ((pts[sel] - t_true) @ R).astype(np.float32)       # src = T^-1 pts
    src_cov = np.einsum("ji,njk,kl->nil", R, covs[sel], R).astype(np.float32)
    src_mask = g.random(n_src) > 0.05
    q0 = m3.quat_exp(torch.tensor([rot, -rot, rot]))
    t0 = np.array([trans, -trans, 0.3 * trans], np.float32)
    return (T(src), T(src_cov), T(src_mask), vm, q0.to(device), T(t0)), cfg


def _host_if(pred, body):
    """A stand-in for the card's IF node: the body runs where ``pred``,
    read on the host, holds."""
    if bool(pred):
        body()


def _static_bodies(cfg):
    return cfg.vgicp_max_iterations * (2 + cfg.lm_max_inner)


def _assert_same(a, b):
    for name in FIELDS:
        assert torch.equal(getattr(a, name), getattr(b, name)), name


@pytest.mark.parametrize("case", list(CASES))
def test_conditional_loop_is_the_masked_one(monkeypatch, case):
    args, cfg = _pair(case)
    masked, trace = registration.lm_register(*args, cfg, with_trace=True)
    n = int(masked.iterations)
    early = registration.lm_register(*args, dataclasses.replace(cfg, vgicp_max_iterations=n))
    monkeypatch.setattr(registration, "_conditional", lambda *a: _host_if)
    cond = registration.lm_register(*args, cfg)
    _assert_same(cond, masked)
    _assert_same(cond, early)
    assert int(masked.bodies) == _static_bodies(cfg)
    assert int(cond.bodies) == 2 * n + int(cond.inner)
    rejects = trace["n_rejects"][:n].tolist()
    if case == "converges":
        assert 2 <= n < 10 and bool(trace["accepted"][:n].all())
    elif case == "inner cap":
        assert rejects[-1] == cfg.lm_max_inner and n < cfg.vgicp_max_iterations
    else:
        assert n == cfg.vgicp_max_iterations and bool(trace["accepted"].all())


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs and their IF nodes have no CPU mode)")
    return torch.device("cuda:0")


def _captured(args, cfg):
    """``lm_register`` on ``args`` captured into a CUDA graph (after an
    eager warm-up on the capture's stream): the graph, its result buffers
    and its input buffers."""
    static = pytree.tree_map(torch.clone, args)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        registration.lm_register(*static, cfg)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = registration.lm_register(*static, cfg)
    return graph, out, static


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(CASES))
def test_captured_lm_skips_the_stopped_bodies(cuda, case):
    args, cfg = _pair(case, cuda)
    eager = registration.lm_register(*args, cfg)
    graph, out, static = _captured(args, cfg)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        _assert_same(out, eager)
        assert int(out.bodies) == 2 * int(out.iterations) + int(out.inner)
    assert int(eager.bodies) == _static_bodies(cfg)
    if case == "converges":
        # another pair's inputs in the captured buffers: the replay follows it
        other, _ = _pair("inner cap", cuda)
        for dst, src in zip(pytree.tree_leaves(static), pytree.tree_leaves(other)):
            dst.copy_(src)
        graph.replay()
        torch.cuda.synchronize()
        _assert_same(out, registration.lm_register(*other, cfg))
        assert int(out.bodies) == 2 * int(out.iterations) + int(out.inner)
