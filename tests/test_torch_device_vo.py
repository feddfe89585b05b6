"""Parity of the torch port's device-resident VO with the JAX package on
CPU: each step function, the state carry-over in both directions, and the
slice as a whole (8 frames of 2 sequences stepped from one JAX-produced
state, window BA and in-scan loop retrieval on), plus an end-to-end run of
the port alone through ``BatchedDeviceVO``.

The world is the device-SLAM bench's kind: a square loop of rendered
landmark patches at 320x240. Inputs are made once from numpy seeds."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_tpu.geometry.camera import default_camera as jax_default_camera
from slam_tpu.pipeline import device_vo as jvo
from slam_tpu_torch.pipeline import device_vo as tvo
from slam_tpu_torch.utils.synthetic import (default_camera, exact_odometry,
                                            make_world, render_frame)

torch.set_num_threads(1)
W, H, S, WARM, T = 320, 240, 2, 4, 8
CFG = dict(width=W, height=H, lm_capacity=256, max_keypoints=300, window=8,
           window_ba_every=4, loop_every=2, loop_slots=32, loop_words=512,
           loop_min_gap=2, loop_points=96)


def _center(T):
    return -np.einsum("...ji,...j->...i", T[..., :3, :3], T[..., :3, 3])


@pytest.fixture(scope="module")
def scene():
    """Rendered frames, exact odometry, the JAX state after WARM frames and
    the JAX run of the next T frames from it. Each package gets its own
    camera object, built from the same numbers."""
    cam = jax_default_camera(W, H)
    tcam = default_camera(W, H)
    imgs, dels, p0 = [], [], []
    for s in range(S):
        world = make_world(n_frames=WARM + T, n_landmarks=500, seed=30 + s,
                           trajectory="loop", lap_frames=32, camera=tcam)
        patches = np.random.default_rng(31 + s).integers(
            40, 255, (500, 11, 11)).astype(np.uint8)
        imgs.append(np.stack([render_frame(world, patches, i, W, H)
                              for i in range(WARM + T)]))
        dels.append(exact_odometry(world, WARM + T))
        p0.append(world.poses_cw[0].astype(np.float32))
    imgs, dels, p0 = np.stack(imgs), np.stack(dels), np.stack(p0)

    vo = jvo.BatchedDeviceVO(jvo.DeviceVOConfig(**CFG), batch=S, camera=cam)
    vo.reset(p0)
    vo.advance(imgs[:, :WARM], dels[:, :WARM])
    state0 = jax.device_get(vo.state)
    outs = [vo.advance(imgs[:, a:a + 4], dels[:, a:a + 4])
            for a in range(WARM, WARM + T, 4)]
    out = {k: np.concatenate([np.asarray(getattr(o, k)) for o in outs], 1)
           for k in jvo.VOStepOut._fields}
    return dict(cam=cam, tcam=tcam, imgs=imgs, dels=dels, p0=p0, jax_vo=vo,
                state0=state0, jax_out=out,
                jax_final=jax.device_get(vo.state))


def test_slice_matches_jax(scene):
    """Both packages step the same 8 frames from one JAX-produced state:
    per frame n_matched, n_new and loop_frame equal, camera centres within
    1e-3 m, and the integer map state equal at the end."""
    vo = tvo.BatchedDeviceVO(tvo.DeviceVOConfig(**CFG), batch=S,
                             camera=scene["tcam"], device="cpu")
    vo.state = tvo.state_from_numpy(scene["state0"]._asdict(), device="cpu")
    outs = [vo.advance(scene["imgs"][:, a:a + 4], scene["dels"][:, a:a + 4])
            for a in range(WARM, WARM + T, 4)]
    got = {k: np.concatenate([getattr(o, k).numpy() for o in outs], 1)
           for k in tvo.VOStepOut._fields}
    want = scene["jax_out"]
    for k in ("n_matched", "n_new", "loop_frame"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert want["n_matched"][:, :4].min() >= 20       # tracking engaged
    assert (want["loop_frame"] >= 0).any()            # retrieval engaged
    np.testing.assert_allclose(got["loop_score"], want["loop_score"],
                               atol=1e-5)
    err = np.linalg.norm(_center(got["pose_cw"]) - _center(want["pose_cw"]),
                         axis=-1)
    assert err.max() < 1e-3, err
    final = tvo.state_to_numpy(vo.state)
    for f in ("lm_valid", "lm_desc", "lm_n_obs", "lm_created", "prev_free",
              "wobs_valid", "win_valid", "sig_frame", "sig_pvalid",
              "frame_idx"):
        np.testing.assert_array_equal(final[f],
                                      getattr(scene["jax_final"], f),
                                      err_msg=f)


def _jax_seq(state, s):
    return jax.tree.map(lambda x: jnp.asarray(x[s]), state)


def _features(scene, frame):
    """The JAX front-end's features for ``frame`` of both sequences (fed to
    both packages' step functions so that they see the same inputs)."""
    from slam_tpu.ops.frontend import _extract_impl
    spec = jvo._frontend_spec(jvo._resolve_settings(
        jvo.DeviceVOConfig(**CFG), None), W, H)
    feats = [[np.asarray(x) for x in _extract_impl(
        jnp.asarray(scene["imgs"][s, frame], jnp.float32),
        jnp.zeros((8, 2), jnp.float32), jnp.zeros(8, bool), spec)]
        for s in range(S)]
    pts, _, _, desc, valid, _ = (np.stack(x) for x in zip(*feats))
    return pts, desc, valid


def test_step_functions_match_jax(scene):
    cfg_j = jvo.DeviceVOConfig(**CFG)
    cfg_t = tvo.DeviceVOConfig(**CFG)
    kind, params = jvo.camera_jax.pack_camera(scene["cam"])
    params_t = torch.from_numpy(params)
    st_t = tvo.state_from_numpy(scene["state0"]._asdict(), device="cpu")
    pts, desc, valid = _features(scene, WARM)
    pose_pred = np.einsum("sij,sjk->sik", scene["dels"][:, WARM],
                          scene["state0"].pose_cw).astype(np.float32)
    t = torch.from_numpy
    desc_t = t(desc.view(np.int32))

    # map matching: integer outputs, bit-equal
    nn_t, ok_t = tvo._match_map(st_t, t(pts), desc_t, t(valid), t(pose_pred),
                                kind, params_t, cfg_t)
    match = jax.jit(jvo._match_map, static_argnums=(5, 7))
    j = [match(_jax_seq(scene["state0"], s), pts[s], desc[s], valid[s],
               pose_pred[s], kind, jnp.asarray(params), cfg_j)
         for s in range(S)]
    np.testing.assert_array_equal(nn_t.numpy(), np.stack([x[0] for x in j]))
    np.testing.assert_array_equal(ok_t.numpy(), np.stack([x[1] for x in j]))
    matched = ok_t.numpy()
    assert matched.sum(axis=1).min() >= 20

    from slam_tpu.ops import camera_jax
    mb = np.asarray(camera_jax.unproject(kind, jnp.asarray(params),
                                         jnp.asarray(np.take_along_axis(
                                             pts, nn_t.numpy()[..., None], 1))))
    meas = (mb[..., :2] / np.maximum(mb[..., 2:3], 1e-6)).astype(np.float32)
    mat = np.clip((scene["state0"].lm_n_obs.astype(np.float32) - 1.0) / 8.0,
                  0.125, 1.0)
    obs_w = (458.0 * mat).astype(np.float32)

    # pose-only LM: 4 iterations of a 6x6 f32 solve
    pose_t = tvo._pose_ba(st_t, t(pose_pred), t(meas), t(matched), cfg_t,
                          t(obs_w)).numpy()
    pose_ba = jax.jit(jvo._pose_ba, static_argnums=(4,))
    pose_j = np.stack([np.asarray(pose_ba(_jax_seq(scene["state0"], s),
                                          pose_pred[s], meas[s], matched[s],
                                          cfg_j, obs_w[s])) for s in range(S)])
    np.testing.assert_allclose(pose_t, pose_j, atol=1e-5)

    # anchored-depth refinement
    pos_t, depth_t, nobs_t = tvo._refine_depths(st_t, t(pose_j), t(meas),
                                                t(matched), cfg_t)
    refine = jax.jit(jvo._refine_depths, static_argnums=(4,))
    j = [refine(_jax_seq(scene["state0"], s), pose_j[s], meas[s], matched[s],
                cfg_j) for s in range(S)]
    np.testing.assert_allclose(pos_t.numpy(), np.stack([x[0] for x in j]),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(depth_t.numpy(), np.stack([x[1] for x in j]),
                               rtol=1e-5)
    np.testing.assert_array_equal(nobs_t.numpy(), np.stack([x[2] for x in j]))

    # landmark creation: slots, masks and descriptors bit-equal, geometry f32
    free = valid
    got = tvo._create_landmarks(st_t, t(pose_j), t(pts), desc_t, t(free),
                                kind, params_t, cfg_t)
    create = jax.jit(jvo._create_landmarks, static_argnums=(5, 7))
    want = [create(_jax_seq(scene["state0"], s), pose_j[s], pts[s], desc[s],
                   free[s], kind, jnp.asarray(params), cfg_j)
            for s in range(S)]
    names = ("lm_pos", "lm_desc", "lm_valid", "lm_last_seen",
             "lm_anchor_origin", "lm_anchor_ray", "lm_depth", "lm_n_obs",
             "assign", "slot", "meas_cur", "meas_prev")
    for i, name in enumerate(names):
        w = np.stack([np.asarray(x[i]) for x in want])
        g = got[i].numpy()
        if name == "lm_desc":
            g = g.view(np.uint32)
        if w.dtype.kind in "biu":
            np.testing.assert_array_equal(g, w, err_msg=name)
        elif name in ("lm_pos", "lm_depth"):
            # fresh two-view points: one frame of baseline (0.2-2 degrees of
            # parallax) amplifies f32 rounding in the 3x3 triangulation
            # solve by 1/sin(parallax), so depths agree to 1%
            np.testing.assert_allclose(g, w, rtol=1e-2, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5,
                                       err_msg=name)
    assert got[8].numpy().sum() > 0                  # landmarks were created

    # window BA from the warm state (4 poses in the ring)
    st_w = tvo._window_ba(st_t, cfg_t, 458.0)
    wba = jax.jit(functools.partial(jvo._window_ba, cfg=cfg_j, focal=458.0))
    want = [jax.device_get(wba(_jax_seq(scene["state0"], s)))
            for s in range(S)]
    for f in ("pose_cw", "win_pose_cw", "lm_pos", "lm_depth"):
        np.testing.assert_allclose(getattr(st_w, f).numpy(),
                                   np.stack([getattr(w, f) for w in want]),
                                   rtol=1e-4, atol=1e-4, err_msg=f)
    np.testing.assert_array_equal(
        st_w.wobs_valid.numpy(), np.stack([w.wobs_valid for w in want]))


def test_state_carry_over_round_trips(scene, tmp_path):
    """A JAX checkpoint loads into the port with its descriptor words
    intact, and the port's checkpoint loads back into the JAX session."""
    path = str(tmp_path / "jax_state.npz")
    scene["jax_vo"].save_state(path)
    vo = tvo.BatchedDeviceVO(tvo.DeviceVOConfig(**CFG), batch=S,
                             camera=scene["tcam"], device="cpu")
    vo.load_state(path)
    assert vo.state.lm_desc.dtype == torch.int32
    back = tvo.state_to_numpy(vo.state)
    with np.load(path) as z:
        for f in tvo.VOState._fields:
            assert back[f].dtype == z[f].dtype, f
            np.testing.assert_array_equal(back[f], z[f], err_msg=f)
        assert z["lm_desc"].dtype == np.uint32 and back["lm_desc"].any()

    path2 = str(tmp_path / "port_state.npz")
    vo.save_state(path2)
    jv = jvo.BatchedDeviceVO(jvo.DeviceVOConfig(**CFG), batch=S,
                             camera=scene["cam"])
    jv.load_state(path2)
    for f in tvo.VOState._fields:
        np.testing.assert_array_equal(np.asarray(getattr(jv.state, f)),
                                      back[f], err_msg=f)
    # capacity mismatch is rejected
    small = tvo.BatchedDeviceVO(tvo.DeviceVOConfig(**{**CFG,
                                                      "lm_capacity": 128}),
                                batch=S, camera=scene["tcam"], device="cpu")
    with pytest.raises(AssertionError):
        small.load_state(path)


def test_batched_device_vo_end_to_end():
    """The port alone, from reset, through BatchedDeviceVO at a small size:
    it tracks a rendered trajectory, fills the snapshot mirror and reports
    candidates through loop_candidates."""
    cam = default_camera(W, H)
    n = 8
    world = make_world(n_frames=n, n_landmarks=500, seed=2,
                       trajectory="line", camera=cam)
    patches = np.random.default_rng(3).integers(
        40, 255, (500, 11, 11)).astype(np.uint8)
    frames = np.stack([render_frame(world, patches, i, W, H)
                       for i in range(n)])
    deltas = exact_odometry(world, n)
    cfg = tvo.DeviceVOConfig(**{**CFG, "loop_min_gap": 4})
    vo = tvo.BatchedDeviceVO(cfg, batch=2, camera=cam, device="cpu")
    p0 = np.stack([world.poses_cw[0]] * 2).astype(np.float32)
    vo.reset(p0)
    np.testing.assert_array_equal(vo.state.pose_cw.numpy(), p0)
    outs = [vo.advance(np.stack([frames[a:a + 4]] * 2),
                       np.stack([deltas[a:a + 4]] * 2)) for a in (0, 4)]
    poses = torch.cat([o.pose_cw for o in outs], 1).numpy()
    n_matched = torch.cat([o.n_matched for o in outs], 1).numpy()
    assert poses.shape == (2, n, 4, 4) and np.isfinite(poses).all()
    np.testing.assert_array_equal(poses[0], poses[1])  # identical sequences
    assert n_matched[:, 3:].min() >= 20, n_matched
    err = np.linalg.norm(_center(poses[0]) - _center(np.stack(
        world.poses_cw)), axis=-1)
    assert err.max() < 0.05, err
    snaps = vo.last_snaps
    assert snaps.pc.shape == (2, 2, cfg.loop_points, 3)
    np.testing.assert_array_equal(snaps.frame.numpy(), [[4, 6], [4, 6]])
    assert snaps.pvalid.numpy().any()
    rows = tvo.loop_candidates(outs[1], frame_offset=4)
    lf = outs[1].loop_frame.numpy()
    assert len(rows) == int((lf >= 0).sum()) > 0
    assert set(rows[:, 1].astype(int)) <= set(range(4, 8))

    with pytest.raises(AssertionError):
        tvo.init_state(cfg._replace(loop_points=cfg.lm_capacity + 1), 10,
                       device="cpu")
