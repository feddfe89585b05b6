"""The comparison that decides ``correct`` catches a broken timed path:
the harness runs a small cell on the CPU (its look for a card skipped)
with a fault planted underneath, and ``correct`` comes out false. The
faults a cell can have: a step that returns its state unchanged, half of
the batch left out (the fleet), an answer altered where it is produced;
and the two the solvers can have: the fleet's pose LM and window BA doing
nothing, the live BAs' solutions never written back to the map. One chip
holds each cell, so none has an exchange between chips to leave out."""
import pytest

from test_bench_run import run_small


def _caught(out, names):
    """Some number of ``names`` came out, finite, above its limit."""
    import math

    return any(n in out["checks"] and out["checks"][n][0] is not None
               and math.isfinite(out["checks"][n][0])
               and out["checks"][n][0] > out["checks"][n][1] for n in names)


# each fault, and the numbers of which one has to read it
FLEET = {"fleet_state_unchanged": ["ate_ratio"],
         "fleet_half_batch": ["ate_ratio"],
         "fleet_pose_altered": ["ate_ratio"],
         "fleet_solvers_idle": ["pose_lm_gap_m"]}
LIVE = {"live_ba_unchanged": ["map_pose_gap_m", "map_point_gap_m"],
        "live_ba_altered": ["map_pose_gap_m"],
        "live_words_altered": ["word_mismatches"],
        "live_ba_not_applied": ["map_pose_gap_m", "map_point_gap_m"]}


@pytest.mark.parametrize("fault", sorted(FLEET))
def test_fleet_fault_is_not_correct(checkout, fault):
    out, err = run_small(checkout, "small-room.fleet", 5, 12, False, fault)
    assert out["correct"] is False, err[-2000:]
    assert _caught(out, FLEET[fault]), out["checks"]


@pytest.mark.parametrize("fault", sorted(LIVE))
def test_live_fault_is_not_correct(checkout, fault):
    out, err = run_small(checkout, "small-room.live", 6, 30, False, fault)
    assert out["correct"] is False, err[-2000:]
    assert _caught(out, LIVE[fault]), out["checks"]


def test_reference_f32_control_fails_the_map_limits():
    """The live cell's control at a size a test run holds: the reference's
    two-stage LM in float32 in the map's place reads gaps above the cell's
    limits; the program's own float64 solve, kept as the map would keep
    it, reads gaps below them."""
    import json
    import os

    import numpy as np
    import torch

    from conftest import BENCH
    from harness import reference
    from harness.live import applied_gaps
    from slam_tpu_torch.ops import ba
    from test_bench_reference import _problem

    with open(os.path.join(BENCH, "cells", "euroc-mav.live.json")) as f:
        limits = json.load(f)["limits"]
    p = _problem(0)
    fixed2 = torch.zeros(1, 8, dtype=torch.bool)
    fixed2[0, 0] = True
    slot, info = torch.tensor([7]), torch.eye(6)[None] * 100
    static = dict(iterations=5, cg_iters=0, huber_delta=ba.HUBER_DELTA,
                  init_lambda=1e-4)
    res = ba.solve_ba_two_stage_eager(p, fixed2, slot, info, 5, 0)
    kf, mp = list(range(8)), list(range(p.points.shape[1]))
    r = dict(entry="solve_ba_two_stage", problem=list(p),
             extra=[fixed2, slot, info], static=static, kf_slots=kf,
             kf_poses=res.poses[0].double().numpy(), mp_slots=mp,
             mp_points=res.points[0].double().numpy())
    pose, point = applied_gaps(r, "cpu")
    assert pose < limits["map_pose_gap_m"]
    assert point < limits["map_point_gap_m"]
    pose, point = applied_gaps(r, "cpu", torch.float32)
    assert pose > limits["map_pose_gap_m"] or \
        point > limits["map_point_gap_m"]
    # the map left as it came: far past both
    r.update(kf_poses=p.poses[0].double().numpy(),
             mp_points=p.points[0].double().numpy())
    pose, point = applied_gaps(r, "cpu")
    assert pose > limits["map_pose_gap_m"]
    assert point > limits["map_point_gap_m"]
    assert np.isfinite(reference.camera_centers(r["kf_poses"])).all()
