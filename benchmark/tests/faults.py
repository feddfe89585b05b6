"""Faults planted in the timed path for ``test_bench_faults.py``: each
patches the program in the process that then runs a cell, so that the
comparison that decides ``correct`` has to catch it."""
import numpy as np
import torch


def _wrap_step(edit):
    """Every BatchedDeviceVO built from now on runs ``edit(state, new_state,
    out)`` on each frame step's result."""
    from slam_tpu_torch.pipeline import device_vo

    make = device_vo.make_vo_step

    def patched(*a, **k):
        step, spec = make(*a, **k)

        def faulty(state, image, odom):
            new, out = step(state, image, odom)
            return edit(state, new, out)

        return faulty, spec

    device_vo.make_vo_step = patched


def fleet_state_unchanged():
    """The step returns the state it was given."""
    _wrap_step(lambda state, new, out: (state, out._replace(
        pose_cw=state.pose_cw)))


def fleet_half_batch():
    """The second half of the sequences is left out: their state and
    poses stay where they were."""
    def edit(state, new, out):
        S = state.pose_cw.shape[0]
        # made on the device: a captured step may copy nothing from the host
        keep = torch.arange(S, device=state.pose_cw.device) < S // 2
        merged = type(new)(*(torch.where(
            keep.reshape((-1,) + (1,) * (n.dim() - 1)), n, o)
            for n, o in zip(new, state)))
        return merged, out._replace(pose_cw=merged.pose_cw)
    _wrap_step(edit)


def fleet_pose_altered():
    """Every third frame's pose comes out 0.5 m off where it is made."""
    count = [0]

    def edit(state, new, out):
        count[0] += 1
        if count[0] % 3:
            return new, out
        p = out.pose_cw.clone()
        p[:, 0, 3] += 0.5
        return new, out._replace(pose_cw=p)
    _wrap_step(edit)


def fleet_solvers_idle():
    """The pose LM returns the predicted pose it was given and the window
    BA the state it was given: tracking and mapping run on odometry."""
    from slam_tpu_torch.pipeline import device_vo

    device_vo._pose_ba = lambda state, pose_pred, *a, **k: pose_pred
    device_vo._window_ba = lambda state, *a, **k: state


def _wrap_ba(edit):
    from slam_tpu_torch.ops import ba

    for name in ("solve_ba_eager", "solve_ba_two_stage_eager"):
        fn = getattr(ba, name)

        def faulty(p, *a, _fn=fn, **k):
            return edit(p, _fn(p, *a, **k))
        setattr(ba, name, faulty)


def live_ba_unchanged():
    """The local BA returns the poses and points it was given."""
    _wrap_ba(lambda p, res: res._replace(poses=p.poses.clone(),
                                         points=p.points.clone()))


def live_ba_altered():
    """The BA's solved poses come out 5 cm off where they are made."""
    def edit(p, res):
        poses = res.poses.clone()
        poses[..., 0, 3] += 0.05
        return res._replace(poses=poses)
    _wrap_ba(edit)


def live_ba_not_applied():
    """The BAs solve, but their poses and points are never written back
    to the map."""
    from slam_tpu_torch.pipeline import bundle_adjustment

    builder = bundle_adjustment._ProblemBuilder
    builder.apply_poses = lambda self, *a, **k: None
    builder.apply_points = lambda self, *a, **k: None


def live_words_altered():
    """One word in every extraction is off by one where it is made."""
    from slam_tpu_torch.ops import frontend

    det = frontend.OrbExtractor.detect_and_extract

    def faulty(self, *a, **k):
        res = det(self, *a, **k)
        w = res.words.copy()
        v = np.nonzero(res.valid)[0]
        if len(v):
            w[v[0]] = (w[v[0]] + 1) % 65536
        res.words = w
        return res
    frontend.OrbExtractor.detect_and_extract = faulty
