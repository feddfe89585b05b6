"""The covering bucket of ``ops/ba._dispatch``: the first call of a
padded bucket is solved in the smallest held bucket of its entry, device,
stream, dtypes and static arguments, with the same S, E and P and at least
its K, M and O; its tensors fill the leading slices of that bucket's
buffers, the rest is padded by ``ops/ba.fill_padding`` (the rule
``_ProblemBuilder.build`` pads by), and the result is cut back to the
call's sizes. The call still makes its own bucket, which its next call
takes, so the cover stands in for a shape's first call only.

On the CPU, with problems of ``utils/synthetic.ba_problem`` built and padded
by ``pipeline/bundle_adjustment._ProblemBuilder``: a cover in M, in O, in K
and in all three, for both entries, equals the op-by-op twin on the call's
own padded problem bit for bit (the padded slots add exact zeros to the
float64 LM, and the CPU's sums and solves round the leading block the same
way at either size; on the card they need not, ``tests/test_torch_ba_card.py``),
and the twin on the problem padded to the bucket's sizes, and agrees with
the benchmark's float64 reference (``benchmark/harness/reference.py``) as
``benchmark/tests`` hold the program to it, camera centres within 1e-6 m;
the covering bucket's buffers hold what the builder makes at the larger
quanta; a list of buckets called twice each ends with every bucket's own
buffers in either order; a bucket whose static arguments or E differ is not
taken; a call that nothing covers runs as before (eager at first sight, its
own buffers at the second call); an exact bucket wins over a cover; and the
``ba.cover`` counter, the ``ba.cover_pad`` span and ``counters()["covers"]``
count the covered calls. The card's case is in
``tests/test_torch_ba_card.py``.
"""
import os
import sys

import numpy as np
import pytest
import torch

from slam_tpu_torch.ops import ba
from slam_tpu_torch.pipeline import bundle_adjustment as bundle
from slam_tpu_torch.utils import timer
from slam_tpu_torch.utils.synthetic import ba_problem

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (poses, points, observations a point): the call, and a larger problem
# whose padded bucket covers it along the named axes
SMALL = (10, 200, 4)                  # K 16, M 256, O 1024
LARGER = {"M": (10, 400, 2),          # K 16, M 512, O 1024
          "O": (10, 200, 8),          # K 16, M 256, O 2048
          "K": (20, 200, 4),          # K 32, M 256, O 1024
          "KMO": (20, 400, 4)}        # K 32, M 512, O 2048
ITERS = 5


def built(n_poses, n_points, per_point, seed):
    """A ``ba_problem`` handed to a ``_ProblemBuilder`` row by row, as the
    Mapper's calls leave it (one observation chunk a keyframe), and
    ``build``'s padded problem with the batch axis, on the host."""
    q = [t[0].numpy() for t in ba_problem(n_poses, n_points, per_point,
                                          seed=seed)]
    b = bundle._ProblemBuilder(None, "cpu")
    for k in range(n_poses):
        b.kf_ids.append(k)
        b.kf_slot[k] = k
    b.poses, b.pose_fixed = list(q[0].astype(np.float64)), list(q[1])
    b.mp_ids = list(range(n_points))
    b.points, b.points_fixed = list(q[2].astype(np.float64)), list(q[3])
    for k in range(n_poses):
        sel = np.flatnonzero((q[4] == k) & q[8])
        if len(sel):
            b.obs_chunks.append((k, q[5][sel].astype(np.int32), q[6][sel],
                                 q[7][sel]))
            b.n_obs += len(sel)
    b.pe = [(q[9][i], q[10][i], q[11][i], q[12][i])
            for i in np.flatnonzero(q[13])]
    b.priors = [(q[14][i], q[15][i], q[16][i]) for i in np.flatnonzero(q[17])]
    return b, ba.BAProblem(*bundle._staged(b.build(), torch.device("cpu")))


def two_stage_args(p, n_poses):
    """Stage 1 frees the newest camera; stage 2 all but camera 0 (padded
    poses stay fixed); the newest camera's orientation anchored."""
    K = p.poses.shape[1]
    stage1 = p._replace(pose_fixed=p.pose_fixed
                        | (torch.arange(K) != n_poses - 1)[None])
    stage2 = torch.zeros(1, K, dtype=torch.bool)
    stage2[0, 0] = True
    ba.fill_padding(stage2, "stage2_pose_fixed", n_poses)
    info = torch.diag(torch.tensor([100.0] * 3 + [1.0] * 3))[None]
    return stage1, stage2, torch.tensor([n_poses - 1]), info


def call(entry, args, eager=False, **static):
    static = dict(dict(iterations=ITERS, cg_iters=0), **static)
    if entry == "solve_ba":
        fn = ba.solve_ba_eager if eager else ba.solve_ba
    else:
        fn = ba.solve_ba_two_stage_eager if eager else ba.solve_ba_two_stage
    return fn(*args, **static)


def problem(entry, sizes, seed):
    b, p = built(*sizes, seed)
    return (p,) if entry == "solve_ba" else two_stage_args(p, sizes[0])


def grown(entry, args, sizes):
    """``args`` padded by ``ops/ba.fill_padding`` to the padded ``sizes``
    (K, M, O): the problem a covering bucket of those sizes solves."""
    out = []
    for f, t in zip(ba.ENTRY_FIELDS[entry], (*args[0], *args[1:])):
        n = dict(zip("KMO", sizes)).get(ba.PADDING.get(f, (None,))[0])
        if n is None or n == t.shape[1]:
            out.append(t)
            continue
        big = t.new_empty((t.shape[0], n) + t.shape[2:])
        big[:, :t.shape[1]] = t
        ba.fill_padding(big, f, t.shape[1])
        out.append(big)
    n = len(ba.BAProblem._fields)
    return (ba.BAProblem(*out[:n]), *out[n:])


def cut(res, like):
    """``res`` cut back to the sizes of the result ``like``."""
    return ba.BAResult(*(t[:, :w.shape[1]] if t.dim() > 1 else t
                         for t, w in zip(res, like)))


def equal(got, want, what):
    bad = [f for f, a, b in zip(ba.BAResult._fields, got, want)
           if a.shape != b.shape or not torch.equal(a.cpu(), b.cpu())]
    assert not bad, f"{what}: {bad} differ"


def hold(entry, sizes, seed=100, **static):
    """A bucket of ``sizes`` made and given its buffers (two calls)."""
    for s in (seed, seed + 1):
        call(entry, problem(entry, sizes, s), **static)


@pytest.fixture
def cache():
    ba.BA_GRAPHS.clear()
    yield ba.BA_GRAPHS
    ba.BA_GRAPHS.clear()


def reference_gap(entry, args, got):
    """Largest camera-centre gap between ``got`` and the benchmark's
    float64 reference solve of the call's own problem."""
    bench = os.path.join(ROOT, "benchmark")
    if bench not in sys.path:
        sys.path.append(bench)
    from harness import reference as R

    p = R.problem(list(args[0]), 0, torch.float64, "cpu")
    if entry == "solve_ba":
        ref, _, _ = R.lm_run(p, ITERS, 0, ba.HUBER_DELTA, 1e-4)
    else:
        ref, _, _ = R.two_stage_lm(p, args[1][0], int(args[2][0]),
                                   args[3][0], ITERS, 0, ba.HUBER_DELTA, 1e-4)
    return np.abs(R.camera_centers(got.poses[0].double().numpy())
                  - R.camera_centers(ref.numpy())).max()


@pytest.mark.parametrize("axes", sorted(LARGER))
@pytest.mark.parametrize("entry", ["solve_ba", "solve_ba_two_stage"])
def test_covered_solve_equals_the_exact_bucket(cache, entry, axes):
    """The call's first sight is solved in the larger bucket and equals its
    own bucket's twin bit for bit and the float64 reference within 1e-6 m;
    it makes its own bucket all the same, which its next call takes."""
    hold(entry, LARGER[axes])
    args = problem(entry, SMALL, 1)
    got = call(entry, args)
    c = cache.counters()
    assert (c["buckets"], c["covers"], c["eager_runs"]) == (2, 1, 2), c
    big, own = cache.buckets()
    assert (big["calls"], big["covers"], own["calls"]) == (2, 1, 1)
    assert (own["K"], own["M"], own["O"]) == (16, 256, 1024)
    assert (big["K"], big["M"], big["O"]) != (16, 256, 1024)
    served = ba.last_served()
    assert served["covered"] and all(served[d] == big[d] for d in "KMO")
    equal(got, call(entry, args, eager=True), f"cover in {axes}")
    held = list(cache._entries.values())[0]
    sizes = (big["K"], big["M"], big["O"])
    equal(got, cut(call(entry, grown(entry, args, sizes), eager=True), got),
          f"cover in {axes} against the twin at the bucket's sizes")
    assert held.inputs[0].shape[1] == big["K"]
    assert reference_gap(entry, args, got) < 1e-6
    equal(call(entry, args), got, "second call, own bucket")
    assert not ba.last_served()["covered"]
    c = cache.counters()
    assert (c["covers"], c["eager_runs"]) == (1, 3), c
    assert cache.buckets()[1]["calls"] == 2


@pytest.mark.parametrize("entry", ["solve_ba", "solve_ba_two_stage"])
def test_cover_pads_as_the_builder_pads(cache, entry, monkeypatch):
    """After a covered call the covering bucket's buffers hold what the
    builder makes of the call's rows at the bucket's sizes."""
    hold(entry, LARGER["KMO"])
    b, p = built(*SMALL, 1)
    args = (p,) if entry == "solve_ba" else two_stage_args(p, SMALL[0])
    call(entry, args)
    held = list(cache._entries.values())[0]
    quanta = {16: 32, 256: 512, 1024: 2048}
    pad = bundle._pad
    monkeypatch.setattr(bundle, "_pad",
                        lambda n, q: pad(n, q) * quanta.get(q, q) // q)
    wide = ba.BAProblem(*bundle._staged(b.build(), torch.device("cpu")))
    if entry != "solve_ba":
        p2, *extra = two_stage_args(wide, SMALL[0])
        wide = (*p2, *extra)
    assert len(held.inputs) == len(wide) == len(ba.ENTRY_FIELDS[entry])
    for f, got, want in zip(ba.ENTRY_FIELDS[entry], held.inputs, wide):
        assert got.shape == want.shape and torch.equal(got, want), f


@pytest.mark.parametrize("order", ["growing", "shrinking"])
def test_prewarm_order_does_not_matter(cache, order):
    """A list of buckets, each called twice as a prewarm calls it, leaves
    every bucket with its own buffers whatever the order; a bucket met
    after a larger one is covered at its first call only."""
    sizes = [SMALL, LARGER["M"], LARGER["KMO"]]
    if order == "shrinking":
        sizes.reverse()
    for s in sizes:
        hold("solve_ba_two_stage", s)
    got = sorted((b["K"], b["M"], b["O"], b["calls"])
                 for b in cache.buckets())
    assert got == [(16, 256, 1024, 2), (16, 512, 1024, 2),
                   (32, 512, 2048, 2)]
    assert all(b.inputs is not None for b in cache._entries.values())
    c = cache.counters()
    covers = 0 if order == "growing" else 2
    assert (c["covers"], c["eager_runs"]) == (covers, 6 - covers), c


STATIC = {"iterations": dict(iterations=ITERS + 1),
          "init_lambda": dict(init_lambda=1e-3),
          "huber_delta": dict(huber_delta=2.0)}


@pytest.mark.parametrize("change", sorted(STATIC) + ["E"])
def test_larger_bucket_of_other_statics_is_not_taken(cache, change):
    """A larger bucket whose static arguments or edge count differ leaves
    the call to its own bucket: eager at first sight."""
    if change == "E":
        hold("solve_ba", (40, 400, 4))        # 39 edges: E 64
    else:
        hold("solve_ba", LARGER["KMO"], **STATIC[change])
    args = problem("solve_ba", SMALL, 1)
    equal(call("solve_ba", args), call("solve_ba", args, eager=True),
          "own bucket")
    c = cache.counters()
    assert (c["buckets"], c["covers"], c["eager_runs"]) == (2, 0, 3), c


def test_nothing_covers_then_eager_and_own_buffers(cache):
    """A larger call after a smaller bucket, and a smaller one after a
    larger bucket seen once (no buffers yet), each run eagerly at first
    sight and through their own buffers at the second call."""
    hold("solve_ba", SMALL)
    big = problem("solve_ba", LARGER["KMO"], 5)
    call("solve_ba", big)
    c = cache.counters()
    assert (c["buckets"], c["covers"], c["eager_runs"]) == (2, 0, 3), c
    small = problem("solve_ba", SMALL, 6)
    ba.BA_GRAPHS.clear()
    call("solve_ba", big)                      # one sighting: no buffers
    equal(call("solve_ba", small), call("solve_ba", small, eager=True),
          "first sight")
    equal(call("solve_ba", small), call("solve_ba", small, eager=True),
          "second call")
    c = cache.counters()
    assert (c["buckets"], c["covers"], c["eager_runs"]) == (2, 0, 3), c
    assert [b["calls"] for b in cache.buckets()] == [1, 2]


def test_exact_bucket_wins_over_a_cover(cache):
    """With its own bucket held, a call takes it even when a larger one
    could cover it."""
    hold("solve_ba_two_stage", SMALL)
    hold("solve_ba_two_stage", LARGER["KMO"])
    args = problem("solve_ba_two_stage", SMALL, 7)
    equal(call("solve_ba_two_stage", args),
          call("solve_ba_two_stage", args, eager=True), "own bucket")
    assert cache.counters()["covers"] == 0
    assert [b["calls"] for b in cache.buckets()] == [3, 2]


def test_cover_counter_span_and_counters(cache):
    """A covered call adds one to ``ba.cover`` and to ``covers`` and is a
    ``ba.cover_pad`` span; the later calls of its shape are not covered;
    ``reset_counts`` zeroes the covers."""
    hold("solve_ba", LARGER["KMO"])
    stats = timer.enable_timing()
    try:
        for seed in (1, 2, 3):
            call("solve_ba", problem("solve_ba", SMALL, seed))
        call("solve_ba", problem("solve_ba", LARGER["M"], 4))
    finally:
        timer.disable_timing()
    assert stats.counts["ba.cover"] == 2
    assert stats.counts["ba.cover_pad"] == 2
    assert stats.counts["ba.eager"] == 2 and "ba.replay" not in stats.counts
    assert cache.counters()["covers"] == 2
    assert [b["covers"] for b in cache.buckets()] == [2, 0, 0]
    cache.reset_counts()
    assert cache.counters()["covers"] == 0
    assert cache.buckets()[0]["covers"] == 0
