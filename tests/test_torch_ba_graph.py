"""The BA's one-program dispatch (``ops/ba._dispatch`` over ``BA_GRAPHS``):
``solve_ba`` and ``solve_ba_two_stage`` run one program per padded bucket, as the JAX
package's jitted entry points do, and ``solve_ba_eager`` and
``solve_ba_two_stage_eager`` are their op-by-op twins. On the CPU a bucket's
later calls run the twin eagerly through the bucket's fixed buffers; on a
card they replay its CUDA graph.

On the CPU, at the local BA's quanta (K 16, M 256, O 1024, E 32, P 1) with
numpy-seeded problems: the twins trace under fake tensors with no tensor
made from host data (a host read raises there), so what a capture refuses
fails here first; the dispatch equals its twin bit for bit and its result
outlives the bucket's next call; problems of the same padded shapes and
static arguments share one bucket and a change to any of them makes a new
one; the dispatched two-stage solve agrees with the JAX package's at
``tests/test_torch_ba_interactive.py``'s sizes and tolerance; and a short
``Mapper`` session sends its local and pose BAs through the dispatch and
its global BA past it.

The ``cuda`` tests import no JAX and run on the card:

    python -m pytest tests/test_torch_ba_graph.py --noconftest -m cuda

They hold replays bit-equal to the eager twin over three buckets replayed
out of capture order, run two threads through the same and different
buckets at once, capture while another thread extracts ORB features, read
a BA result only after another thread has enqueued an extraction replay on
the same stream, and hold a copy made inside the chunk's capture to the
eager twin's after each replay (the outputs' lifetimes that
``ops/graphs``' separate pools and locks keep).
"""
import threading

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.fx.experimental.proxy_tensor import make_fx

from slam_tpu_torch.ops import ba
from slam_tpu_torch.utils.synthetic import ba_problem

torch.set_num_threads(1)
K, M, J, E = 16, 256, 4, 32        # O = M * J = 1024


def _problem(seed, k=K, m=M, j=J, e=E, p=1, dtype=torch.float32):
    """``utils/synthetic.ba_problem`` (one fixed camera, K - 1 odometry
    edges, one prior) with its edges padded to ``e`` and its priors to
    ``p`` by invalid entries, as the BA driver pads them."""
    q = ba_problem(k, m, j, seed=seed)

    def pad(t, n):
        extra = n - t.shape[1]
        fill = t[:, :1].expand((1, extra) + t.shape[2:]).clone()
        if t.dtype == torch.bool:
            fill[:] = False
        return torch.cat([t, fill], dim=1)

    q = q._replace(**{f: pad(getattr(q, f), e) for f in
                      ("pe_a", "pe_b", "pe_meas", "pe_sqrt_info", "pe_valid")},
                   **{f: pad(getattr(q, f), p) for f in
                      ("pr_idx", "pr_meas", "pr_sqrt_info", "pr_valid")})
    return ba.BAProblem(*(t.to(dtype) if t.is_floating_point() else t
                          for t in q))


def _stages(q):
    """Two-stage arguments: stage 1 frees the newest camera, stage 2 all
    but camera 0, with the newest camera's orientation anchored."""
    k = q.poses.shape[1]
    info = torch.diag(torch.tensor([100.0] * 3 + [1.0] * 3))[None]
    return (q._replace(pose_fixed=(torch.arange(k) != k - 1)[None]),
            (torch.arange(k) == 0)[None], torch.tensor([k - 1]), info)


def _call(entry, q, iterations, cg, eager=False):
    if entry == "solve_ba":
        fn = ba.solve_ba_eager if eager else ba.solve_ba
        return fn(q, iterations, cg)
    fn = ba.solve_ba_two_stage_eager if eager else ba.solve_ba_two_stage
    return fn(*_stages(q), iterations, cg)


def _equal(got, want, what):
    bad = [f for f, a, b in zip(ba.BAResult._fields, got, want)
           if not torch.equal(a.cpu(), b.cpu())]
    assert not bad, f"{what}: {bad} differ"


@pytest.fixture
def cache():
    ba.BA_GRAPHS.clear()
    yield ba.BA_GRAPHS
    ba.BA_GRAPHS.clear()


def _host_made(gm):
    return [n.format_node() for n in gm.graph.nodes
            if n.op == "call_function" and "lift_fresh" in str(n.target)]


@pytest.mark.parametrize("entry,cg", [("solve_ba", 0), ("solve_ba", 3),
                                      ("two_stage", 0), ("two_stage", 3)],
                         ids=["lm-dense", "lm-pcg", "two-stage-dense",
                              "two-stage-pcg"])
def test_eager_twin_traces_under_fake_tensors(entry, cg):
    """What a bucket's graph captures: the twin (the f64 casts, ``lm_run``
    or both stages with the anchor, the cast back) traced with fake
    tensors, so it reads nothing back to the host, and no tensor in it is
    built from host data."""
    q, *stage = _stages(_problem(0))
    n = len(q)

    def fn(*t):
        if entry == "solve_ba":
            return ba.solve_ba_eager(ba.BAProblem(*t[:n]), 2, cg)
        return ba.solve_ba_two_stage_eager(ba.BAProblem(*t[:n]), *t[n:], 2,
                                           cg)

    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        gm = make_fx(fn)(*(mode.from_tensor(t) for t in (*q, *stage)))
    assert _host_made(gm) == []
    ops = {str(node.target) for node in gm.graph.nodes
           if node.op == "call_function"}
    assert "aten.linalg_inv_ex.default" in ops
    assert ("aten._linalg_solve_ex.default" in ops) == (cg == 0)
    assert "aten.index_add_.default" in ops    # the CPU's segment sums


@pytest.mark.parametrize("entry", ["solve_ba", "two_stage"])
def test_dispatch_equals_twin_and_outlives_next_call(cache, entry):
    """First sighting, then two calls through the bucket's buffers, each
    bit-equal to the twin on the same inputs; the first buffered result
    is unchanged by the second call."""
    q0, q1, q2 = (_problem(s) for s in (0, 1, 2))
    _equal(_call(entry, q0, 2, 0), _call(entry, q0, 2, 0, eager=True),
           "first sighting")
    got1 = _call(entry, q1, 2, 0)
    kept = ba.BAResult(*(t.clone() for t in got1))
    _equal(got1, _call(entry, q1, 2, 0, eager=True), "second call")
    _equal(_call(entry, q2, 2, 0), _call(entry, q2, 2, 0, eager=True),
           "third call")
    _equal(got1, kept, "the second call's result after the third")
    assert not torch.equal(got1.poses, _call(entry, q2, 2, 0).poses)
    (b,) = cache.buckets()
    assert b["calls"] == 4 and (b["K"], b["M"], b["O"], b["E"], b["P"]) \
        == (K, M, M * J, E, 1)
    c = cache.counters()
    assert (c["buckets"], c["eager_runs"], c["captures"]) == (1, 4, 0)


CHANGES = {"iterations": {"iterations": 2}, "cg_iters": {"cg": 2},
           "K": {"k": 32}, "M": {"m": 512}, "O": {"j": 8}, "E": {"e": 64},
           "P": {"p": 2}}


@pytest.mark.parametrize("change", sorted(CHANGES))
def test_bucket_key_follows_static_arguments_and_padded_shapes(cache,
                                                               change):
    """Two problems of one padded shape, iterations and cg_iters share a
    bucket; a change to any of them makes a new one (the JAX package's
    ``static_argnames`` and its padded shapes)."""
    over = dict(CHANGES[change])
    its, cg = over.pop("iterations", 1), over.pop("cg", 0)
    ba.solve_ba(_problem(0), 1, 0)
    ba.solve_ba(_problem(1), 1, 0)
    assert [b["calls"] for b in cache.buckets()] == [2]
    ba.solve_ba(_problem(2, **over), its, cg)
    got = cache.buckets()
    assert [b["calls"] for b in got] == [2, 1]
    key = {"iterations": "iterations", "cg_iters": "cg_iters"}.get(
        change, change)
    assert got[0][key] != got[1][key]


@pytest.mark.parametrize("cg", [0, 96], ids=["dense", "pcg"])
def test_dispatched_two_stage_matches_jax(cache, cg):
    """The dispatch's buffered call (after the bucket's first sighting)
    against the JAX package's ``solve_ba_two_stage``, as
    ``test_torch_ba_interactive.test_two_stage_matches_jax`` runs both."""
    import jax.numpy as jnp
    import test_torch_ba_interactive as ref

    from slam_tpu.ops import ba as jba

    prob = ref._bench_problem(edges=True)
    prob["pose_fixed"] = np.arange(ref.K) != ref.K - 1
    stage2 = np.arange(ref.K) == 0
    info = np.zeros((6, 6), np.float32)
    info[:3, :3] = np.eye(3) * 100.0
    info[3:, 3:] = np.eye(3) * 1.0
    want = jba.solve_ba_two_stage(ref._jax(prob), jnp.asarray(stage2),
                                  jnp.asarray(ref.K - 1, jnp.int32),
                                  jnp.asarray(info), iterations=ref.ITERS,
                                  cg_iters=cg)
    args = (ref._torch(prob), torch.from_numpy(stage2)[None],
            torch.tensor([ref.K - 1]), torch.from_numpy(info)[None])
    first = ba.solve_ba_two_stage(*args, iterations=ref.ITERS, cg_iters=cg)
    got = ba.solve_ba_two_stage(*args, iterations=ref.ITERS, cg_iters=cg)
    _equal(got, first, "buffered call against the first sighting")
    assert cache.buckets()[0]["calls"] == 2
    ref._close(got, want)
    np.testing.assert_allclose(got.cost.numpy()[0], float(want.cost),
                               rtol=1e-3)


@pytest.fixture(scope="module")
def session():
    """A 14-frame backend-only ``Mapper`` session on the CPU (the synthetic
    world of ``tests/torch_synthetic_world.py``), its BA calls counted."""
    from slam_tpu_torch.params import Parameters, ParametersSlam
    from slam_tpu_torch.pipeline.mapper import Mapper
    from torch_synthetic_world import (FakeOrbExtractor, TrackSimulator,
                                       make_mapper_input, make_world)

    ba.BA_GRAPHS.clear()
    world = make_world(n_frames=14, n_landmarks=300, seed=3)
    tracker = TrackSimulator(world)
    params = Parameters(slam=ParametersSlam(
        keyframeDecisionMinIntervalSeconds=0.0,
        minVisibleMapPointsInCurrentFrameBA=8, localBAProblemSize=12,
        adjacentSpaceSize=8, useFrontendSlam=False))
    mapper = Mapper(params, orb_extractor=FakeOrbExtractor(world, tracker),
                    device="cpu")
    for i in range(14):
        mapper.advance(make_mapper_input(world, i, tracker))
    yield mapper, ba.BA_GRAPHS.buckets()
    ba.BA_GRAPHS.clear()


def test_session_local_and_pose_ba_go_through_the_dispatch(session):
    """Every local BA of the session is a call of a ``solve_ba_two_stage``
    bucket (or, stage 1 alone, of ``solve_ba``), padded to the quanta; a
    pose BA is a ``solve_ba`` call at ``poseBAIterations``."""
    from slam_tpu_torch.pipeline.bundle_adjustment import pose_bundle_adjust
    from slam_tpu_torch.utils.stats import Ba

    mapper, buckets = session
    stats = mapper.workspace_ba.ba_stats
    two = sum(b["calls"] for b in buckets
              if b["entry"] == "solve_ba_two_stage")
    assert two == stats.totals[Ba.LOCAL] > 0, (buckets, stats.totals)
    for b in buckets:
        assert b["K"] % 16 == 0 and b["M"] % 256 == 0 and b["O"] % 1024 == 0
        assert b["E"] % 32 == 0 and b["P"] >= 1
    db = mapper.map_db
    its = mapper.settings.parameters.slam.poseBAIterations

    def pose_calls():
        return sum(b["calls"] for b in ba.BA_GRAPHS.buckets()
                   if b["entry"] == "solve_ba" and b["iterations"] == its)
    before = pose_calls()
    assert pose_bundle_adjust(db.latest_keyframe(), db, mapper.settings,
                              device="cpu")
    assert pose_calls() == before + 1


def test_global_ba_runs_on_the_eager_twin(session, monkeypatch):
    """``global_bundle_adjust`` solves through ``solve_ba_eager`` and
    leaves the dispatch's buckets and counters as they were."""
    from slam_tpu_torch.pipeline.bundle_adjustment import global_bundle_adjust

    mapper, _ = session
    db = mapper.map_db
    calls = []
    eager = ba.solve_ba_eager

    def spy(*a, **k):
        calls.append(k["cg_iters"])
        return eager(*a, **k)

    monkeypatch.setattr(ba, "solve_ba_eager", spy)
    before = (ba.BA_GRAPHS.buckets(), ba.BA_GRAPHS.counters())
    global_bundle_adjust(db.latest_keyframe().id, db, mapper.settings,
                         device="cpu")
    assert calls == [0]
    assert (ba.BA_GRAPHS.buckets(), ba.BA_GRAPHS.counters()) == before


# ---------------------------------------------------------------------------
# on the card


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _on(args, device):
    return tuple(type(a)(*(t.to(device) for t in a))
                 if isinstance(a, ba.BAProblem) else a.to(device)
                 for a in args)


BUCKETS = [dict(k=16, m=512, j=4), dict(k=32, m=768, j=4),
           dict(k=16, m=256, j=4)]


def _card_problem(seed, bucket):
    return _on(_stages(_problem(seed, **bucket)), "cuda")


@pytest.mark.cuda
def test_replay_bit_equal_over_buckets_out_of_order_on_card(cache):
    """Three local-BA buckets (5 iterations a stage, dense Schur): each
    sighted, then captured, then replayed in another order on new
    problems; every replay bit-equal to the eager twin in poses, points,
    chi2 and cost. The third bucket's first sight is covered by the first
    bucket's graph (``_dispatch``'s cover), and equals the twin on its
    problem padded to that bucket's sizes."""
    _need_card()
    import test_torch_ba_cover as cover

    for i, bucket in enumerate(BUCKETS):
        for seed in (10 * i, 10 * i + 1):
            args = _card_problem(seed, bucket)
            got = ba.solve_ba_two_stage(*args, 5, 0)
            by = ba.last_served()
            assert by["covered"] == (i == 2 and seed == 20), (i, seed, by)
            want = ba.solve_ba_two_stage_eager(*cover.grown(
                "solve_ba_two_stage", args, (by["K"], by["M"], by["O"])),
                5, 0)
            _equal(got, cover.cut(want, got), f"bucket {i} seed {seed}")
    c = cache.counters()
    assert (c["buckets"], c["eager_runs"], c["captures"], c["replays"],
            c["covers"]) == (3, 2, 3, 3, 1), c
    assert c["pool_bytes"] > 0
    for i in (2, 0, 1, 0):
        args = _card_problem(100 + i, BUCKETS[i])
        _equal(ba.solve_ba_two_stage(*args, 5, 0),
               ba.solve_ba_two_stage_eager(*args, 5, 0), f"replay {i}")
    assert cache.counters()["replays"] == 7


@pytest.mark.cuda
def test_two_threads_share_buckets_on_card(cache):
    """Two threads dispatch at once: one the same bucket again and again,
    the other that bucket and a second one in turn; every result equals
    the eager twin's on its inputs."""
    _need_card()
    a, b = BUCKETS[0], BUCKETS[2]
    for bucket in (a, b):
        for seed in (0, 1):                      # sighting, capture
            ba.solve_ba_two_stage(*_card_problem(seed, bucket), 5, 0)
    jobs = {0: [(a, s) for s in range(20, 26)],
            1: [(a if s % 2 else b, s) for s in range(30, 36)]}
    want = {s: ba.solve_ba_two_stage_eager(*_card_problem(s, bk), 5, 0)
            for job in jobs.values() for bk, s in job}
    torch.cuda.synchronize()
    got, errors = {}, []

    def work(job):
        try:
            for bk, s in job:
                got[s] = ba.solve_ba_two_stage(*_card_problem(s, bk), 5, 0)
            torch.cuda.synchronize()
        except Exception as e:      # re-raised below, in the test's thread
            errors.append(e)

    threads = [threading.Thread(target=work, args=(j,)) for j in
               jobs.values()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    for s, w in want.items():
        _equal(got[s], w, f"seed {s}")
    assert cache.counters()["captures"] == 2


@pytest.mark.cuda
def test_capture_while_another_thread_extracts_on_card(cache):
    """A bucket is sighted and captured while another thread runs
    ``OrbExtractor.detect_and_extract`` (which waits on its own CUDA
    events); the capture succeeds, the replay equals the eager twin, and
    the extractor's results equal those of a run alone."""
    _need_card()
    from slam_tpu_torch.ops.frontend import OrbExtractor
    from slam_tpu_torch.params import (Parameters, ParametersSlam,
                                       StaticSettings)
    from slam_tpu_torch.utils.synthetic import (default_camera, make_world,
                                                render_frame)

    w, h = 640, 480
    world = make_world(n_frames=4, n_landmarks=500, seed=31,
                       trajectory="loop", lap_frames=64,
                       camera=default_camera(w, h))
    patches = np.random.default_rng(31).integers(
        40, 255, (500, 11, 11)).astype(np.uint8)
    frame = render_frame(world, patches, 0, w, h)
    settings = StaticSettings(Parameters(slam=ParametersSlam(
        maxKeypoints=600)))
    ext = OrbExtractor(settings, w, h, device="cuda")
    alone = ext.detect_and_extract(frame)
    stop, runs, errors = threading.Event(), [], []

    def extract():
        try:
            while not stop.is_set():
                r = ext.detect_and_extract(frame)
                runs.append(np.array_equal(r.descriptors, alone.descriptors)
                            and np.array_equal(r.words, alone.words))
        except Exception as e:      # re-raised below, in the test's thread
            errors.append(e)

    t = threading.Thread(target=extract)
    t.start()
    try:
        while not runs and t.is_alive():
            stop.wait(0.01)
        n0 = len(runs)
        args = _card_problem(0, BUCKETS[1])
        ba.solve_ba_two_stage(*_card_problem(1, BUCKETS[1]), 5, 0)
        got = ba.solve_ba_two_stage(*args, 5, 0)          # the capture
        torch.cuda.synchronize()
        during = len(runs) - n0
    finally:
        stop.set()
        t.join()
    assert not errors, errors
    assert cache.counters()["captures"] == 1
    _equal(got, ba.solve_ba_two_stage_eager(*args, 5, 0), "captured bucket")
    assert all(runs) and during > 0, (runs, during)


@pytest.mark.cuda
def test_ba_result_read_after_an_extraction_replay_on_card(cache):
    """Two threads on the card's default stream, in turn: one replays a BA
    bucket and reads its result only once the other has enqueued an
    extraction replay (with its words and copy out) behind it; each BA
    result and each extraction equal their eager twins. The BA's outputs
    are cloned under its lock and the two programs' pools are apart, so
    the extraction's replay cannot rewrite what the BA returned."""
    _need_card()
    from slam_tpu_torch.ops import frontend as F
    from test_torch_extract_graph import (_assert_equal, _direct, _frames,
                                          _settings)

    F.EXTRACT_GRAPHS.clear()
    ex = F.OrbExtractor(_settings(keypoints=1000), 752, 480,
                        max_tracked=256, device="cuda")
    frames = _frames(2, 752, 480)
    problems = [_card_problem(s, BUCKETS[1]) for s in (40, 41)]
    for frame, args in zip(frames, problems):      # sighting, capture
        ex.detect_and_extract(frame)
        ba.solve_ba_two_stage(*args, 5, 0)
    want_ba = [ba.solve_ba_two_stage_eager(*a, 5, 0) for a in problems]
    want_ex = [_direct(ex, f, None, "cuda") for f in frames]
    torch.cuda.synchronize()
    rounds = 8
    solved, enqueued = threading.Event(), threading.Event()
    got_ba, got_ex, errors = [], [], []

    def solver():
        try:
            for r in range(rounds):
                out = ba.solve_ba_two_stage(*problems[r % 2], 5, 0)
                solved.set()
                assert enqueued.wait(timeout=60), r
                enqueued.clear()
                got_ba.append(ba.BAResult(*(t.cpu() for t in out)))
        except Exception as e:      # re-raised below, in the test's thread
            errors.append(e)
            solved.set()

    def extractor():
        try:
            for r in range(rounds):
                assert solved.wait(timeout=60), r
                solved.clear()
                ex.prefetch(r, frames[r % 2])
                enqueued.set()
                got_ex.append(ex.detect_and_extract(None, key=r))
        except Exception as e:      # re-raised below, in the test's thread
            errors.append(e)
            enqueued.set()

    threads = [threading.Thread(target=f) for f in (solver, extractor)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        F.EXTRACT_GRAPHS.clear()
    assert not errors, errors
    assert not any(t.is_alive() for t in threads)
    assert len(got_ba) == len(got_ex) == rounds
    for r in range(rounds):
        _equal(got_ba[r], want_ba[r % 2], f"BA round {r}")
        _assert_equal(got_ex[r], want_ex[r % 2], f"extraction round {r}")
    assert cache.counters()["replays"] == rounds + 1


@pytest.mark.cuda
def test_copy_inside_the_chunk_capture_follows_each_replay_on_card(
        monkeypatch):
    """A copy of the pose LM's output made while the chunk is captured
    (as ``benchmark/harness/fleet.ChunkRecords`` makes it) lives in the
    shard's own pool and is rewritten by each replay: after every replayed
    chunk it equals the copy the eager twin makes of the same chunk."""
    _need_card()
    from slam_tpu_torch.pipeline import device_vo as tvo
    from test_torch_chunk_graph import CHUNKS, _chunk, _vo, make_scene

    copies = {True: [], False: []}        # made under a capture or not
    pose_ba = tvo._pose_ba

    def recorded(*a, **k):
        out = pose_ba(*a, **k)
        copies[torch.cuda.is_current_stream_capturing()].append(out.clone())
        return out

    monkeypatch.setattr(tvo, "_pose_ba", recorded)
    scene = make_scene()
    vo, twin = _vo(scene, "cuda"), _vo(scene, "cuda")
    before = None
    for c in range(CHUNKS):
        vo.advance(*_chunk(scene, c))
        copies[False].clear()                 # the graph's eager chunk
        twin._advance_eager(*_chunk(scene, c))
        torch.cuda.synchronize()
        if c == 0:
            continue
        captured, eager = copies[True], copies[False]
        assert len(captured) == len(eager) > 0, (len(captured), len(eager))
        for i, (a, b) in enumerate(zip(captured, eager)):
            assert torch.equal(a, b), f"chunk {c}, pose LM call {i}"
        now = [t.clone() for t in captured]
        if before is not None:
            assert any(not torch.equal(a, b) for a, b in zip(before, now))
        before = now
    assert len(vo._chunks[0].graphs.buckets()) == 1
