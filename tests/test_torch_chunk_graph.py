"""The serving path's chunk program (``pipeline/device_vo._ChunkGraph``) on
the CPU, where it runs eagerly through the same fixed buffers that a card
replays as one CUDA graph: ``BatchedDeviceVO.advance`` equals its eager
twin over three chunks; what ``advance``, ``last_snaps`` and ``state``
return outlives the next chunk; a state set between chunks (a rebase),
``reset`` and ``load_state`` take effect in the next chunk; a short
``DeviceSlam`` session repeats the chunk loop that threads the state as
values; and the chunk traces under fake tensors with no tensor made from
host data, so that a data-dependent host read or a host-to-device copy
added to the step or the window BA fails here and not first in a capture
on the card, with its stage stamps in it. A chunk's stamps come in stage
order and the consumer of a ``DeviceSlam`` session turns them into device
time by stage while timing is on. Sizes: S = 2 sequences of 160x120,
chunks of T = 4, window 4 (the card's stamp test runs the main path's
640x480).

The ``cuda`` tests replay the graph on a card, bit-equal to the eager twin
with the K1 launches counted, and hold a replay's stamps to its profiled
device time; they import no JAX:

    python -m pytest tests/test_torch_chunk_graph.py --noconftest -m cuda
"""
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import (DataDependentOutputException,
                                           FakeTensorMode)
from torch.fx.experimental.proxy_tensor import make_fx

from slam_tpu_torch.kernels import launches
from slam_tpu_torch.pipeline import device_vo as tvo
from slam_tpu_torch.pipeline.device_slam import DeviceSlam, DeviceSlamParams
from slam_tpu_torch.utils import timer
from slam_tpu_torch.utils.synthetic import (default_camera, exact_odometry,
                                            make_world, render_frame)

torch.set_num_threads(1)
W, H, S, T, CHUNKS = 160, 120, 2, 4, 3
CFG = tvo.DeviceVOConfig(width=W, height=H, lm_capacity=128,
                         max_keypoints=150, window=4, window_ba_every=4,
                         loop_every=2, loop_slots=8, loop_words=64,
                         loop_min_gap=2, loop_points=16)


def make_scene(chunks=CHUNKS):
    """Square loops of rendered landmark patches (seeds 30, 31) for
    ``chunks`` chunks, exact odometry, start poses."""
    cam = default_camera(W, H)
    n = T * chunks
    worlds = [make_world(n_frames=n, n_landmarks=500, seed=30 + s,
                         trajectory="loop", lap_frames=32, camera=cam)
              for s in range(S)]
    patches = np.random.default_rng(1).integers(
        40, 255, (500, 11, 11)).astype(np.uint8)
    images = np.stack([np.stack([render_frame(w, patches, i, W, H)
                                 for i in range(n)]) for w in worlds])
    deltas = np.stack([exact_odometry(w, n) for w in worlds])
    p0 = np.stack([w.poses_cw[0] for w in worlds]).astype(np.float32)
    return dict(cam=cam, images=images, deltas=deltas, p0=p0)


@pytest.fixture(scope="module")
def scene():
    return make_scene()


def _chunk(scene, c):
    sl = slice(c * T, (c + 1) * T)
    return scene["images"][:, sl], scene["deltas"][:, sl]


def _vo(scene, device="cpu"):
    vo = tvo.BatchedDeviceVO(CFG, batch=S, camera=scene["cam"],
                             device=device)
    vo.reset(scene["p0"])
    return vo


def _assert_equal(a, b, what):
    bad = [f for f, x, y in zip(a._fields, a, b)
           if not torch.equal(x.cpu(), y.cpu())]
    assert not bad, f"{what}: fields differ: {bad}"


def _copy(nt):
    return type(nt)(*(t.clone() for t in nt))


def test_advance_equals_eager_twin(scene):
    """Outputs, snapshot rows and state of ``advance`` and
    ``_advance_eager`` bit for bit over three chunks; tracking and
    retrieval engage, so the comparison is not of empty maps."""
    vo, twin = _vo(scene), _vo(scene)
    for c in range(CHUNKS):
        out = vo.advance(*_chunk(scene, c))
        want = twin._advance_eager(*_chunk(scene, c))
        _assert_equal(out, want, f"chunk {c} outputs")
        _assert_equal(vo.last_snaps, twin.last_snaps, f"chunk {c} snaps")
        _assert_equal(vo.state, twin.state, f"chunk {c} state")
    assert int(out.n_matched.max()) >= 20, out.n_matched
    assert bool((out.loop_frame >= 0).any()), out.loop_frame


def test_results_outlive_the_next_chunk(scene):
    """What chunk n returned (outputs, ``last_snaps``, ``state``) keeps its
    values while chunk n+1 rewrites the buffers."""
    vo = _vo(scene)
    out0 = vo.advance(*_chunk(scene, 0))
    snaps0, state0 = vo.last_snaps, vo.state
    kept = [_copy(out0), _copy(snaps0), _copy(state0)]
    out1 = vo.advance(*_chunk(scene, 1))
    for got, want, what in zip((out0, snaps0, state0), kept,
                               ("outputs", "snaps", "state")):
        _assert_equal(got, want, what)
    assert not torch.equal(out1.pose_cw, out0.pose_cw)
    assert not torch.equal(vo.state.frame_idx, state0.frame_idx)


def _rebased(state):
    """The state after a closure correction of sequence 0 (a small yaw and
    a 5 cm shift), through the rebase ``DeviceSlam`` applies."""
    c, s = np.cos(0.02), np.sin(0.02)
    Ts = np.tile(np.eye(4, dtype=np.float32), (S, 1, 1))
    Ts[0, :3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
    Ts[0, :3, 3] = [0.05, 0.0, -0.02]
    return tvo._rebase_states(state, torch.from_numpy(Ts),
                              torch.tensor([True, False]),
                              torch.zeros(S, dtype=torch.int32))


def test_state_set_between_chunks_takes_effect(scene):
    """A rebased state set between chunks is what the next chunk starts
    from: the same chunk from the same state on a fresh instance agrees bit
    for bit, and differs from the chunk without the rebase. A state of the
    wrong shape raises and leaves the buffers as they were."""
    vo, plain, fresh = _vo(scene), _vo(scene), _vo(scene)
    vo.advance(*_chunk(scene, 0))
    plain.advance(*_chunk(scene, 0))
    new = _rebased(vo.state)
    vo.state = new
    _assert_equal(vo.state, new, "state after the setter")
    fresh.state = new
    out = vo.advance(*_chunk(scene, 1))
    _assert_equal(out, fresh.advance(*_chunk(scene, 1)), "next chunk")
    _assert_equal(vo.state, fresh.state, "state after the next chunk")
    assert not torch.equal(out.pose_cw[0],
                           plain.advance(*_chunk(scene, 1)).pose_cw[0])
    before = vo.state
    with pytest.raises(ValueError):
        vo.state = before._replace(lm_valid=before.lm_valid[:, :-1])
    _assert_equal(vo.state, before, "state after a refused set")


def test_reset_and_load_state_take_effect(scene, tmp_path):
    """``reset(p0)`` after two chunks repeats a fresh instance's first
    chunk; ``load_state`` of a checkpoint taken after chunk 0 repeats the
    saving instance's chunk 1."""
    vo, ref = _vo(scene), _vo(scene)
    first = ref.advance(*_chunk(scene, 0))
    path = str(tmp_path / "state.npz")
    ref.save_state(path)
    second = ref.advance(*_chunk(scene, 1))
    vo.advance(*_chunk(scene, 0))
    vo.advance(*_chunk(scene, 1))
    vo.reset(scene["p0"])
    assert vo.last_snaps is None
    _assert_equal(vo.advance(*_chunk(scene, 0)), first, "chunk 0 after reset")
    vo.advance(*_chunk(scene, 2))
    vo.load_state(path)
    _assert_equal(vo.advance(*_chunk(scene, 1)), second,
                  "chunk 1 after load_state")


def _functional_advance(vo):
    """``advance`` as the chunk loop ran before the fixed buffers: the state
    threaded through the frames as values and set back whole."""
    def advance(images, odom_deltas):
        st, out, snaps = vo._chunks[0].chunk(
            vo.state, torch.as_tensor(images),
            torch.as_tensor(np.asarray(odom_deltas, np.float32)))
        vo.state, vo.last_snaps = st, snaps
        return out
    return advance


def test_device_slam_session_repeats_the_functional_loop():
    """A ``DeviceSlam`` session (320x240 square loop, lap 32, 64 frames in
    chunks of 8, 2 mm a frame of vertical odometry bias) through the
    buffers gives the closures and the trajectory of the same session
    through the functional chunk loop, bit for bit, with a rebase applied
    between chunks."""
    w, h, lap, frames, chunk = 320, 240, 32, 64, 8
    cam = default_camera(w, h)
    world = make_world(n_frames=frames, n_landmarks=700, seed=6,
                       trajectory="loop", lap_frames=lap, camera=cam)
    patches = np.random.default_rng(2).integers(
        40, 255, (700, 11, 11)).astype(np.uint8)
    images = np.stack([render_frame(world, patches, i, w, h)
                       for i in range(frames)])[None]
    deltas = exact_odometry(world, frames)
    bias = np.eye(4, dtype=np.float32)
    bias[1, 3] = 2e-3
    deltas[1:] = np.einsum("ij,tjk->tik", bias, deltas[1:])
    cfg = tvo.DeviceVOConfig(width=w, height=h, lm_capacity=256,
                             max_keypoints=200, ba_iterations=2,
                             loop_every=2, loop_slots=32, loop_words=256,
                             loop_min_gap=16, loop_points=128)
    params = DeviceSlamParams(frame_dt=0.1, min_closure_gap_s=2.0,
                              calib_frames=16)

    def session(functional):
        slam = DeviceSlam(cfg, batch=1, camera=cam, params=params,
                          device="cpu")
        slam.vo.reset(np.stack(world.poses_cw[:1]).astype(np.float32))
        if functional:
            slam.vo.advance = _functional_advance(slam.vo)
        for c in range(frames // chunk):
            sl = slice(c * chunk, (c + 1) * chunk)
            slam.advance(images[:, sl], deltas[None, sl])
        slam.finish()
        return slam

    got, want = session(False), session(True)
    closures = [(e.query_frame, e.cand_frame, e.accepted, e.reason)
                for e in got.closures]
    assert closures == [(e.query_frame, e.cand_frame, e.accepted, e.reason)
                        for e in want.closures]
    assert any(e.accepted for e in got.closures), closures
    assert np.array_equal(got.trajectory(0), want.trajectory(0))
    _assert_equal(got.vo.state, want.vo.state, "final state")


def _trace(vo, images, odom):
    """make_fx of one shard's chunk function, with its stage stamps, under
    fake tensors."""
    prog = vo._chunks[0]
    state = prog.state
    n = len(state)
    stamps = torch.zeros(len(tvo.stamp_stages(prog.cfg, images.shape[1]))
                         + 1, dtype=torch.int64)
    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        args = [mode.from_tensor(t) for t in (*state, torch.as_tensor(images),
                                              torch.as_tensor(odom), stamps)]
        return make_fx(lambda *a: prog.chunk(
            tvo.VOState(*a[:n]), a[n], a[n + 1], stamps=a[n + 2]))(*args)


def _host_made(gm):
    """Nodes that lift a tensor built from host data into the program."""
    return [n.format_node() for n in gm.graph.nodes
            if n.op == "call_function" and "lift_fresh" in str(n.target)]


def test_chunk_traces_under_fake_tensors(scene):
    """The whole chunk (4 frame steps, a window BA, the snapshot gather)
    traces with fake tensors, so it reads no value back to the host, and no
    tensor in it is built from host data. The caches of device constants
    fill in an eager chunk first, as the card's warm-up chunk fills them."""
    vo = _vo(scene)
    vo.advance(*_chunk(scene, 0))
    gm = _trace(vo, *_chunk(scene, 1))
    assert _host_made(gm) == []
    ops = {str(n.target) for n in gm.graph.nodes if n.op == "call_function"}
    assert {"aten._linalg_solve_ex.default", "aten.index_put_.default",
            "aten.linalg_inv_ex.default"} <= ops
    # one stamp node a slot, in slot order: T x 4 step stages, T / 4
    # window BAs, the snapshot rows and the chunk's start
    slots = [n.args[1] for n in gm.graph.nodes
             if str(n.target) == "slam_tpu_torch.stamp.default"]
    assert slots == list(range(T * 4 + T // 4 + 2))


@pytest.mark.parametrize("fault", ["host read", "host tensor"])
def test_fake_trace_catches_what_a_capture_refuses(scene, monkeypatch,
                                                   fault):
    """A ``.item()`` or a tensor built from a host value inside the pose
    LM makes the trace fail, or shows up in it (a two-frame chunk without
    the window BA keeps the trace short)."""
    vo = tvo.BatchedDeviceVO(CFG._replace(window=0), batch=S,
                             camera=scene["cam"], device="cpu")
    vo.reset(scene["p0"])
    images, odom = (x[:, :2] for x in _chunk(scene, 0))
    vo.advance(images, odom)
    pose_ba = tvo._pose_ba

    def faulty(state, pose_pred, *a):
        if fault == "host read":
            pose_pred = pose_pred * float(pose_pred.sum().item())
        else:
            pose_pred = pose_pred * torch.tensor(1.0)
        return pose_ba(state, pose_pred, *a)

    monkeypatch.setattr(tvo, "_pose_ba", faulty)
    if fault == "host read":
        with pytest.raises(DataDependentOutputException):
            _trace(vo, images, odom)
    else:
        assert _host_made(_trace(vo, images, odom))


def test_chunk_stamps_come_in_stage_order(scene):
    """One eager chunk on the CPU: a stamp at its start, then one at the
    end of each of the step's four stages a frame, of each window BA and of
    the snapshot rows, non-decreasing (host ``perf_counter_ns``); the
    stages' seconds add up to the first-to-last stamp."""
    from slam_tpu_torch.ops.stamp import durations

    stages = tvo.stamp_stages(CFG, T)
    assert stages == (tvo.STEP_STAGES * 4 + ("window_ba",)) * (T // 4) \
        + ("snaps",)
    vo = _vo(scene)
    assert vo.last_stamps is None
    vo.advance(*_chunk(scene, 0))
    st = vo.last_stamps
    assert st.dtype == torch.int64 and st.shape == (1, len(stages) + 1)
    st = st[0].numpy()
    assert (st > 0).all() and (np.diff(st) >= 0).all()
    d = durations(st, stages)
    assert set(d) == set(tvo.STEP_STAGES) | {"window_ba", "snaps"}
    assert sum(d.values()) == pytest.approx((st[-1] - st[0]) * 1e-9,
                                            rel=1e-9)
    # the copy does not change with the next chunk; the next chunk's
    # stamps start after this chunk's last
    vo.advance(*_chunk(scene, 1))
    assert vo.last_stamps[0, 0] >= st[-1]


def test_device_slam_adds_stage_device_time():
    """While timing is on, each consumed chunk of a ``DeviceSlam`` session
    on the CPU adds its stages' time (``vo.device.<stage>``) and the
    consumer's spans to ``TIME_STATS.totals`` and ``counts``: what the
    benchmark's readers are handed."""
    w, h, frames, chunk = 160, 120, 16, 4
    cam = default_camera(w, h)
    world = make_world(n_frames=frames, n_landmarks=400, seed=6,
                       trajectory="loop", lap_frames=32, camera=cam)
    patches = np.random.default_rng(2).integers(
        40, 255, (400, 11, 11)).astype(np.uint8)
    images = np.stack([render_frame(world, patches, i, w, h)
                       for i in range(frames)])[None]
    deltas = exact_odometry(world, frames)[None]
    slam = DeviceSlam(CFG, batch=1, camera=cam, device="cpu")
    slam.vo.reset(np.stack(world.poses_cw[:1]).astype(np.float32))
    stats = timer.enable_timing()
    try:
        for c in range(frames // chunk):
            sl = slice(c * chunk, (c + 1) * chunk)
            slam.advance(images[:, sl], deltas[:, sl])
        slam.finish()
    finally:
        timer.disable_timing()
    rec = {k: [stats.totals[k], stats.counts[k]] for k in stats.totals}
    n = frames // chunk
    for stage in tvo.STEP_STAGES + ("window_ba", "snaps"):
        total, count = rec[f"vo.device.{stage}"]
        assert count == n and total > 0, stage
    for name in ("slam.advance", "vo.advance", "vo.copy_in", "vo.eager",
                 "slam.to_host", "slam.consume", "slam.mirror",
                 "slam.gates"):
        assert rec[name][1] == n, name
    spans = {s.id: s for s in stats.spans}
    for s in stats.spans:
        if s.name in ("slam.mirror", "slam.gates"):
            assert spans[s.parent].name == "slam.consume"
        if s.name == "vo.copy_in":
            assert spans[s.parent].name == "vo.advance"
    # the stages cover the eager chunks' own work
    device = sum(rec[f"vo.device.{s}"][0]
                 for s in tvo.STEP_STAGES + ("window_ba", "snaps"))
    assert 0.9 * rec["vo.eager"][0] <= device <= rec["vo.eager"][0]


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
def test_replay_bit_equal_to_eager_on_card(scene):
    """On the card: chunk 0 runs eagerly, chunk 1 captures the graph, every
    later chunk replays it; outputs, snapshots and state bit-equal to the
    eager twin, and K1's count says one launch a frame in both."""
    _need_card()
    vo, twin = _vo(scene, "cuda"), _vo(scene, "cuda")
    for c in range(CHUNKS):
        before = launches.K1.total
        out = vo.advance(*_chunk(scene, c))
        torch.cuda.synchronize()
        assert launches.K1.total - before == T
        before = launches.K1.total
        want = twin._advance_eager(*_chunk(scene, c))
        assert launches.K1.total - before == T
        _assert_equal(out, want, f"chunk {c} outputs")
        _assert_equal(vo.last_snaps, twin.last_snaps, f"chunk {c} snaps")
        _assert_equal(vo.state, twin.state, f"chunk {c} state")
    (shape,) = vo._chunks[0].graphs.buckets()
    assert shape["graph"] and shape["launches"]["k1.launch"] == T
    assert twin._chunks[0].graphs.buckets() and not any(
        b["graph"] for b in twin._chunks[0].graphs.buckets())


@pytest.mark.cuda
def test_set_state_under_replay_on_card(scene):
    """On the card, after the capture: a rebased state set between two
    replays is what the next replay starts from (equal to the eager twin
    given the same state)."""
    _need_card()
    vo, twin = _vo(scene, "cuda"), _vo(scene, "cuda")
    for c in range(2):
        vo.advance(*_chunk(scene, c))
        twin._advance_eager(*_chunk(scene, c))
    new = _rebased(vo.state.__class__(*(t.cpu() for t in vo.state)))
    vo.state, twin.state = new, new
    _assert_equal(vo.advance(*_chunk(scene, 2)),
                  twin._advance_eager(*_chunk(scene, 2)), "replay after set")
    _assert_equal(vo.state, twin.state, "state")


@pytest.mark.cuda
def test_replay_stamps_match_profiled_busy_time_on_card():
    """On the card, at the main path's size (S = 4 sequences of 640x480,
    chunks of 8, ``chip_smoke.py``'s configuration): a replayed chunk's
    stamps never go back, and its stages' device time (first to last
    stamp) is within 10 % of the busy time of the same replay under
    ``torch.profiler`` (the union of its kernels' intervals; the copies in
    and out lie outside the stamps). The stamped replay runs unprofiled and
    the profiled one again from the same state: under the profiler the
    graph's kernels spread apart (its device span grows by about half), and
    the stamps read that span."""
    _need_card()
    w, h, seqs, t, chunks = 640, 480, 4, 8, 3
    cam = default_camera(w, h)
    worlds = [make_world(n_frames=t * chunks, n_landmarks=500, seed=30 + i,
                         trajectory="loop", lap_frames=64, camera=cam)
              for i in range(seqs)]
    patches = np.random.default_rng(31).integers(
        40, 255, (500, 11, 11)).astype(np.uint8)
    images = np.stack([np.stack([render_frame(wd, patches, i, w, h)
                                 for i in range(t * chunks)])
                       for wd in worlds])
    deltas = np.stack([exact_odometry(wd, t * chunks) for wd in worlds])
    cfg = tvo.DeviceVOConfig(width=w, height=h, lm_capacity=512,
                             max_keypoints=600, window=8, window_ba_every=4,
                             loop_every=4, loop_slots=32, loop_words=512,
                             loop_min_gap=16, loop_points=192)
    vo = tvo.BatchedDeviceVO(cfg, batch=seqs, camera=cam, device="cuda")
    vo.reset(np.stack([wd.poses_cw[0] for wd in worlds]).astype(np.float32))

    def chunk(c):
        return images[:, c * t:(c + 1) * t], deltas[:, c * t:(c + 1) * t]

    for c in range(2):                     # the eager chunk, the capture
        vo.advance(*chunk(c))
    before = vo.state
    out = vo.advance(*chunk(2))
    st = vo.last_stamps[0].cpu().numpy()
    assert st.shape == (len(tvo.stamp_stages(cfg, t)) + 1,)
    assert (np.diff(st) >= 0).all()
    stamped = (st[-1] - st[0]) * 1e-9
    vo.state = before
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        again = vo.advance(*chunk(2))
        torch.cuda.synchronize()
    _assert_equal(again, out, "the same replay again")
    dev = sorted((e.time_range.start, e.time_range.end)
                 for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and not e.name.startswith(("Memcpy", "Memset")))
    busy, end = 0.0, float("-inf")
    for s, e in dev:
        if s > end:
            busy, end = busy + e - s, e
        elif e > end:
            busy, end = busy + e - end, e
    busy *= 1e-6                                        # us -> s
    assert abs(stamped - busy) <= 0.1 * busy, (stamped, busy)
