"""The BA's entry points run the LM in f64 (``ops/ba.solve_ba``,
``solve_ba_two_stage``) and return the problem's dtype. A point that one
keyframe observes gives a rank-2 3x3 block; damped by the LM's lambda it is
near-singular, and an f32 LM steps from rounding noise that depends on the
device (``tools/trace_euroc_ba.py --replay-kf K`` replays one local BA of
the EuRoC-class room both ways on the card and the CPU). An f32 problem
therefore solves to exactly the f64 problem's solution rounded to f32;
``two_stage_lm``, the schedule itself, keeps its caller's dtype."""
import numpy as np
import torch

from slam_tpu_torch.ops import ba
from slam_tpu_torch.utils.synthetic import ba_problem


def _problem():
    p = ba_problem(8, 96, 2, seed=3)
    # a third of the points seen once: their damped blocks are near-singular
    valid = p.obs_valid.clone()
    once = torch.arange(0, 96, 3)
    second = torch.zeros_like(valid)
    for m in once.tolist():
        hits = torch.nonzero((p.obs_mp[0] == m) & valid[0])[:, 0]
        second[0, hits[1:]] = True
    p = p._replace(obs_valid=valid & ~second)
    counts = torch.bincount(p.obs_mp[0][p.obs_valid[0]], minlength=96)
    assert int((counts == 1).sum()) >= 30
    return p


def _f64(p):
    return type(p)(*(t.double() if t.is_floating_point() else t for t in p))


def _same(a, b):
    assert a.poses.dtype == torch.float32
    for x, y in zip(a, b):
        if x.is_floating_point():
            assert torch.equal(x, y.float())
        else:
            assert torch.equal(x, y)


def test_solve_ba_runs_in_f64():
    p = _problem()
    got = ba.solve_ba(p, 6, 0)
    _same(got, ba.solve_ba(_f64(p), 6, 0))
    cost0 = float(ba._total_cost(p.poses, p.points, p, ba.HUBER_DELTA)[0][0])
    assert float(got.cost[0]) < 0.5 * cost0
    # PCG takes the same route
    _same(ba.solve_ba(p, 3, 24), ba.solve_ba(_f64(p), 3, 24))


def test_two_stage_runs_in_f64():
    p = _problem()
    K = p.poses.shape[1]
    fixed = torch.zeros((1, K), dtype=torch.bool)
    fixed[0, 0] = True
    p = p._replace(pose_fixed=~torch.nn.functional.one_hot(
        torch.tensor([K - 1]), K).bool())
    slot = torch.tensor([K - 1], dtype=torch.int32)
    info = torch.from_numpy(np.diag([100.0] * 3 + [10.0] * 3)[None]
                            .astype(np.float32))
    got = ba.solve_ba_two_stage(p, fixed, slot, info, 4, 0)
    want = ba.solve_ba_two_stage(_f64(p), fixed, slot, info.double(), 4, 0)
    _same(got, want)
    core = ba.two_stage_lm(_f64(p), fixed, slot, info.double(), 4, 0)
    assert core.poses.dtype == torch.float64
    for x, y in zip(core, want):
        assert torch.equal(x, y)
    assert ba.two_stage_lm(p, fixed, slot, info, 4, 0).poses.dtype \
        == torch.float32
