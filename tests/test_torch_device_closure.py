"""The port's device-path correctLoop (``device_vo._rebase_states`` with
``_merge_duplicates``): the six unit tests of the JAX package's
``tests/test_device_closure_unit.py`` on hand-built states where every
expected value is known, parity with the JAX package's rebase on a random
two-sequence state (merge on and off), and a mixed ``apply`` mask at S=2
where the sequence left out comes out bit-identical."""
import jax
import numpy as np
import pytest
import torch

from slam_tpu.pipeline import device_vo as jvo
from slam_tpu_torch.pipeline import device_vo as tvo
from slam_tpu_torch.pipeline.device_slam import DeviceSlam, DeviceSlamParams

torch.set_num_threads(1)

CFG = tvo.DeviceVOConfig(width=160, height=120, lm_capacity=8,
                         max_keypoints=32, window=2, loop_every=1,
                         loop_slots=4, loop_points=4)


def _np_state(cfg, batch=1, num_slots=16):
    """Writable NumPy fields (descriptors as uint32) of an empty state."""
    st = tvo.state_to_numpy(tvo.init_state(cfg, num_slots, batch,
                                           device="cpu"))
    return {k: np.array(v) for k, v in st.items()}


def _desc(seed):
    return np.random.default_rng(seed).integers(
        0, 2 ** 32, 8, dtype=np.uint32)


def _setup_state():
    """One sequence, correction T = translate y by -0.1 (so world entities
    move by T^-1 = +0.1 in y), candidate frame 30 (as the JAX unit test)."""
    st = _np_state(CFG)
    T = np.eye(4, dtype=np.float32)
    T[1, 3] = -0.1
    Tinv = np.linalg.inv(T)

    D0, D2, D3 = _desc(0), _desc(2), _desc(3)
    # lm 0: OLD (created before candidate) — must not move
    st["lm_valid"][0, 0] = True
    st["lm_created"][0, 0] = 2
    st["lm_pos"][0, 0] = [0.0, 0.0, 5.0]
    st["lm_desc"][0, 0] = D0
    st["lm_n_obs"][0, 0] = 5
    st["lm_last_seen"][0, 0] = 41
    # lm 1: NEW duplicate of lm 0 (post-rebase it lands 0.04 m away)
    st["lm_valid"][0, 1] = True
    st["lm_created"][0, 1] = 40
    st["lm_pos"][0, 1] = [0.0, -0.06, 5.0]
    st["lm_desc"][0, 1] = D0 ^ np.uint32(0b111)       # 3 bits apart
    st["lm_n_obs"][0, 1] = 3
    st["lm_last_seen"][0, 1] = 44
    # lm 2: NEW, no duplicate anywhere — must move by T^-1, stay valid
    st["lm_valid"][0, 2] = True
    st["lm_created"][0, 2] = 41
    st["lm_pos"][0, 2] = [2.0, 0.0, 7.0]
    st["lm_desc"][0, 2] = D2
    # lm 3: NEW duplicate of a SNAPSHOT point whose live landmark was
    # culled — must snap onto the snapshot's world position
    st["lm_valid"][0, 3] = True
    st["lm_created"][0, 3] = 42
    st["lm_pos"][0, 3] = [-1.0, -0.08, 4.0]
    st["lm_desc"][0, 3] = D3
    st["lm_anchor_origin"][0, 3] = [0.0, 0.0, 0.0]

    # window observation stores: lm1 observed in col 0, lm0 in col 1
    st["wobs_valid"][0, 1, 0] = True
    st["wobs_meas"][0, 1, 0] = [0.25, -0.125]
    st["wobs_valid"][0, 0, 1] = True
    st["wobs_meas"][0, 0, 1] = [0.5, 0.25]

    # candidate snapshot in ring slot 2 (frame 30): one valid row holding
    # the world point lm 3 should land on, expressed in the snapshot camera
    W3 = np.array([-1.0, 0.0, 4.0])
    pose_c = np.eye(4, dtype=np.float32)
    pose_c[:3, 3] = [0.3, -0.2, 0.5]
    st["sig_pose"][0, 2] = pose_c
    st["sig_frame"][0, 2] = 30
    st["sig_pc"][0, 2, 0] = W3 @ pose_c[:3, :3].T + pose_c[:3, 3]
    st["sig_desc"][0, 2, 0] = D3 ^ np.uint32(0b11)
    st["sig_pvalid"][0, 2, 0] = True
    # other ring rows: frames 10 (old), 44 (corrected region)
    st["sig_frame"][0, 0] = 10
    st["sig_frame"][0, 1] = 44
    st["sig_pose"][0, 1] = np.eye(4, dtype=np.float32)

    st["pose_cw"][0] = np.eye(4, dtype=np.float32)
    st["pose_cw"][0][:3, 3] = [0.1, 0.2, 0.3]
    return st, T, Tinv, W3


def _run(st, T, merge, slot_T=None, slot_frame=None, cand_slot=2,
         apply=True):
    t = torch.from_numpy
    out = tvo._rebase_states(
        tvo.state_from_numpy(st, device="cpu"), t(T[None].astype(np.float32)),
        torch.tensor([apply]), torch.tensor([30], dtype=torch.int32),
        torch.tensor([cand_slot]),
        None if slot_T is None else t(slot_T),
        None if slot_frame is None else t(slot_frame),
        merge_radius=0.3, merge=merge)
    return tvo.state_to_numpy(out)


class TestGatedRebase:
    def test_only_corrected_region_landmarks_move(self):
        st, T, Tinv, _ = _setup_state()
        out = _run(st, T, merge=False)
        # poses move by T (right-multiplied)
        np.testing.assert_allclose(out["pose_cw"][0], st["pose_cw"][0] @ T,
                                   atol=1e-6)
        # old landmark (created 2 <= 30) stays
        np.testing.assert_allclose(out["lm_pos"][0, 0], st["lm_pos"][0, 0],
                                   atol=1e-7)
        # new landmarks (created > 30) move by T^-1
        want = st["lm_pos"][0, 2] @ Tinv[:3, :3].T + Tinv[:3, 3]
        np.testing.assert_allclose(out["lm_pos"][0, 2], want, atol=1e-6)
        # nothing merged without the merge flag
        assert out["lm_valid"][0, :4].all()

    def test_apply_false_is_identity(self):
        st, T, _, _ = _setup_state()
        out = _run(st, T, merge=True, apply=False)
        for f in tvo.VOState._fields:
            np.testing.assert_array_equal(out[f], st[f], err_msg=f)

    def test_slot_pose_smear(self):
        """Ring slots use the host's interpolated matrices when the stored
        frame matches; rows the host did not know (overwritten in flight)
        fall back to the rigid frame>candidate predicate."""
        st, T, _, _ = _setup_state()
        half = np.eye(4, dtype=np.float32)
        half[1, 3] = -0.05                           # half the correction
        slot_T = np.broadcast_to(np.eye(4, dtype=np.float32),
                                 (1, 4, 4, 4)).copy()
        slot_frame = np.full((1, 4), -2, np.int32)
        slot_T[0, 1] = half
        slot_frame[0, 1] = 44                        # matches -> custom
        slot_T[0, 2] = np.eye(4)
        slot_frame[0, 2] = 29                        # MISMATCH (ring has 30)
        out = _run(st, T, merge=False, slot_T=slot_T, slot_frame=slot_frame)
        np.testing.assert_allclose(out["sig_pose"][0, 1],
                                   st["sig_pose"][0, 1] @ half, atol=1e-6)
        # mismatched row: rigid predicate — frame 30 > cf? no (30 == cf)
        # -> identity
        np.testing.assert_allclose(out["sig_pose"][0, 2],
                                   st["sig_pose"][0, 2], atol=1e-6)
        # unknown row with frame 10 <= cf: identity
        np.testing.assert_allclose(out["sig_pose"][0, 0],
                                   st["sig_pose"][0, 0], atol=1e-6)


class TestPostClosureMerge:
    def test_duplicate_merges_into_older_landmark(self):
        st, T, Tinv, _ = _setup_state()
        out = _run(st, T, merge=True)
        # the corrected-region duplicate is freed; the old slot survives
        assert not out["lm_valid"][0, 1]
        assert out["lm_valid"][0, 0]
        # observation counts combine, last_seen advances
        assert out["lm_n_obs"][0, 0] == 5 + 3
        assert out["lm_last_seen"][0, 0] == 44
        # kept position is the OLD landmark's (authoritative geometry)
        np.testing.assert_allclose(out["lm_pos"][0, 0], st["lm_pos"][0, 0],
                                   atol=1e-7)
        # window observations transfer into the kept slot
        assert out["wobs_valid"][0, 0, 0] and out["wobs_valid"][0, 0, 1]
        np.testing.assert_allclose(out["wobs_meas"][0, 0, 0],
                                   st["wobs_meas"][0, 1, 0], atol=1e-7)
        np.testing.assert_allclose(out["wobs_meas"][0, 0, 1],
                                   st["wobs_meas"][0, 0, 1], atol=1e-7)
        # the freed slot's observation rows are cleared
        assert not out["wobs_valid"][0, 1].any()

    def test_snapshot_snap_for_culled_geometry(self):
        st, T, Tinv, W3 = _setup_state()
        out = _run(st, T, merge=True)
        # lm 3 has no live old twin; it snaps onto the candidate
        # snapshot's world point
        assert out["lm_valid"][0, 3]
        np.testing.assert_allclose(out["lm_pos"][0, 3], W3, atol=1e-5)
        # anchored parametrization re-derived around the snapped position
        ray = out["lm_pos"][0, 3] - out["lm_anchor_origin"][0, 3]
        np.testing.assert_allclose(out["lm_depth"][0, 3],
                                   np.linalg.norm(ray), rtol=1e-5)
        # the unrelated landmark is untouched beyond the rigid move
        want2 = st["lm_pos"][0, 2] @ Tinv[:3, :3].T + Tinv[:3, 3]
        np.testing.assert_allclose(out["lm_pos"][0, 2], want2, atol=1e-6)
        assert out["lm_valid"][0, 2]

    def test_merge_respects_radius_and_descriptor_gates(self):
        st, T, _, _ = _setup_state()
        # push the duplicate out of the 3D radius -> no merge
        st["lm_pos"][0, 1] = [0.0, -0.06, 6.0]
        out = _run(st, T, merge=True)
        assert out["lm_valid"][0, 1]
        assert out["lm_n_obs"][0, 0] == 5
        # restore position but break the descriptor -> no merge
        st2, T2, _, _ = _setup_state()
        st2["lm_desc"][0, 1] = _desc(99)
        out2 = _run(st2, T2, merge=True)
        assert out2["lm_valid"][0, 1]


class TestRingOverwrittenRecovery:
    def test_try_close_rejects_stale_mirror_row(self):
        """A flagged candidate whose ring slot was overwritten between the
        in-scan retrieval and host consumption must be rejected cleanly
        (reason=ring_overwritten), not crash the consumer."""
        cfg = tvo.DeviceVOConfig(width=160, height=120, lm_capacity=64,
                                 max_keypoints=60, loop_every=2, loop_slots=4,
                                 loop_words=64, loop_min_gap=4,
                                 loop_points=16)
        slam = DeviceSlam(cfg, batch=1,
                          params=DeviceSlamParams(min_loop_score=0.5),
                          device="cpu")
        # mirror says slot holds frame 16, but the flagged candidate is the
        # overwritten frame 8 that mapped to the same slot
        slot = (8 // cfg.loop_every) % cfg.loop_slots
        slam._ring_frame[0, slot] = 16
        q = 22
        q_slot = (q // cfg.loop_every) % cfg.loop_slots
        slam._ring_frame[0, q_slot] = q
        ev = slam._try_close(0, q, 8, 0.95)
        assert not ev.accepted
        assert ev.reason == "ring_overwritten"


PCFG = tvo.DeviceVOConfig(width=160, height=120, lm_capacity=64,
                          max_keypoints=32, window=3, loop_every=1,
                          loop_slots=4, loop_points=24)
CF = 30


def _rigid(rng, rot, trans):
    from slam_tpu_torch.geometry import se3
    return se3.se3_exp(np.concatenate([rng.normal(0, rot, 3),
                                       rng.normal(0, trans, 3)])
                       ).astype(np.float32)


def _random_state(S=2, seed=0):
    """S sequences of random map state around candidate frame CF, each with
    planted duplicates: corrected-region landmarks (created > CF) near an
    old landmark with its descriptor 3 bits apart, others near a point of
    the candidate snapshot (ring slot 2), and stale window bits on culled
    rows."""
    rng = np.random.default_rng(seed)
    st = _np_state(PCFG, batch=S)
    M, K, P = PCFG.lm_capacity, PCFG.window, PCFG.loop_points
    for s in range(S):
        st["lm_valid"][s] = rng.random(M) < 0.85
        st["lm_created"][s] = rng.integers(0, 60, M)
        st["lm_created"][s, :16] = rng.integers(0, CF + 1, 16)    # old
        st["lm_created"][s, 16:40] = rng.integers(CF + 1, 60, 24)  # new
        st["lm_pos"][s] = rng.uniform([-1, -1, 3], [1, 1, 5], (M, 3))
        st["lm_desc"][s] = rng.integers(0, 2 ** 32, (M, 8), dtype=np.uint32)
        st["lm_n_obs"][s] = rng.integers(1, 12, M)
        st["lm_last_seen"][s] = rng.integers(20, 60, M)
        st["lm_anchor_origin"][s] = rng.normal(0, 0.3, (M, 3))
        ray = st["lm_pos"][s] - st["lm_anchor_origin"][s]
        st["lm_depth"][s] = np.linalg.norm(ray, axis=-1)
        st["lm_anchor_ray"][s] = ray / st["lm_depth"][s][:, None]
        st["wobs_valid"][s] = rng.random((M, K)) < 0.5
        st["wobs_meas"][s] = rng.normal(0, 0.3, (M, K, 2))
        # corrected-region duplicates of old landmarks (rows 16-25 of 0-9)
        st["lm_valid"][s, :26] = True
        st["lm_pos"][s, 16:26] = (st["lm_pos"][s, :10]
                                  + rng.normal(0, 0.04, (10, 3)))
        st["lm_desc"][s, 16:26] = st["lm_desc"][s, :10] ^ np.uint32(0b10101)
        # stale window bits on culled rows
        st["lm_valid"][s, 50:54] = False
        st["wobs_valid"][s, 50:54] = True
        # ring: frames 10, 44, CF (the candidate, slot 2), 20
        st["sig_frame"][s] = [10, 44, CF, 20]
        for r in range(4):
            st["sig_pose"][s, r] = _rigid(rng, 0.05, 0.2)
        pose_c = st["sig_pose"][s, 2]
        world = rng.uniform([-1, -1, 3], [1, 1, 5], (P, 3))
        # snapshot twins of corrected-region rows 30-37 (no live old twin)
        world[:8] = st["lm_pos"][s, 30:38] + rng.normal(0, 0.03, (8, 3))
        st["lm_valid"][s, 30:38] = True
        st["sig_pc"][s, 2] = world @ pose_c[:3, :3].T + pose_c[:3, 3]
        st["sig_desc"][s, 2] = rng.integers(0, 2 ** 32, (P, 8),
                                            dtype=np.uint32)
        st["sig_desc"][s, 2, :8] = st["lm_desc"][s, 30:38] ^ np.uint32(0b11)
        st["sig_pvalid"][s, 2] = rng.random(P) < 0.9
        st["sig_pvalid"][s, 2, :8] = True
        st["pose_cw"][s] = _rigid(rng, 0.1, 0.5)
        st["prev_pose_cw"][s] = _rigid(rng, 0.1, 0.5)
        for k in range(K):
            st["win_pose_cw"][s, k] = _rigid(rng, 0.1, 0.5)
    T = np.stack([_rigid(rng, 0.02, 0.05) for _ in range(S)])
    slot_T = np.stack([np.stack([_rigid(rng, 0.01, 0.02) for _ in range(4)])
                       for _ in range(S)])
    slot_frame = np.tile(np.array([10, 44, 29, -2], np.int32), (S, 1))
    return st, T, slot_T, slot_frame


def _rebase_port(st, T, apply, slot_T, slot_frame, merge):
    t = torch.from_numpy
    S = len(T)
    out = tvo._rebase_states(
        tvo.state_from_numpy(st, device="cpu"), t(T), t(apply),
        torch.full((S,), CF, dtype=torch.int32),
        torch.full((S,), 2, dtype=torch.int64), t(slot_T), t(slot_frame),
        merge_radius=0.3, merge=merge)
    return tvo.state_to_numpy(out)


def _rebase_jax(st, T, apply, slot_T, slot_frame, merge):
    S = len(T)
    out = jvo._rebase_states(
        jvo.VOState(**st), T, apply, np.full(S, CF, np.int32),
        np.full(S, 2, np.int32), slot_T, slot_frame, merge_radius=0.3,
        merge=merge)
    return {f: np.asarray(v) for f, v in zip(jvo.VOState._fields,
                                            jax.device_get(out))}


@pytest.mark.parametrize("merge", [True, False], ids=["merge", "no_merge"])
def test_rebase_matches_jax(merge):
    """Both packages rebase the same random two-sequence state: integer and
    boolean fields equal, float fields within 1e-6 (f32 4x4 products
    summed in another order)."""
    st, T, slot_T, slot_frame = _random_state()
    apply = np.array([True, True])
    got = _rebase_port(st, T, apply, slot_T, slot_frame, merge)
    want = _rebase_jax(st, T, apply, slot_T, slot_frame, merge)
    for f in tvo.VOState._fields:
        assert got[f].dtype == want[f].dtype, f
        if want[f].dtype.kind in "biu":
            np.testing.assert_array_equal(got[f], want[f], err_msg=f)
        else:
            np.testing.assert_allclose(got[f], want[f], rtol=0, atol=1e-6,
                                       err_msg=f)
    if merge:
        # the planted duplicates were merged and snapped, in both sequences
        freed = st["lm_valid"] & ~got["lm_valid"]
        assert freed[:, 16:26].sum(axis=1).min() >= 5, freed[:, 16:26]
        moved = np.linalg.norm(got["lm_pos"][:, 30:38]
                               - st["lm_pos"][:, 30:38], axis=-1)
        assert (moved > 1e-3).sum(axis=1).min() >= 4
    else:
        np.testing.assert_array_equal(got["lm_valid"], st["lm_valid"])


def test_mixed_apply_leaves_the_other_sequence_bit_identical():
    """S=2, one sequence closes and the other does not (merge on): the
    sequence left out comes out bit-identical, the closing one as it does
    alone. The JAX package's rebase also clears, in the sequence left out,
    the stale window bits of culled landmarks; nothing reads those bits
    (the window BA masks by lm_valid, and slot reuse clears the row)."""
    st, T, slot_T, slot_frame = _random_state(seed=1)
    apply = np.array([True, False])
    got = _rebase_port(st, T, apply, slot_T, slot_frame, merge=True)
    alone = _rebase_port({f: v[:1] for f, v in st.items()}, T[:1], apply[:1],
                         slot_T[:1], slot_frame[:1], merge=True)
    for f in tvo.VOState._fields:
        np.testing.assert_array_equal(got[f][1], st[f][1], err_msg=f)
        if st[f].dtype.kind in "biu":
            np.testing.assert_array_equal(got[f][0], alone[f][0], err_msg=f)
        else:
            np.testing.assert_allclose(got[f][0], alone[f][0], rtol=0,
                                       atol=1e-6, err_msg=f)
    assert (got["lm_valid"][0] != st["lm_valid"][0]).any()   # it merged
    want = _rebase_jax(st, T, apply, slot_T, slot_frame, merge=True)
    stale = st["wobs_valid"][1] & ~st["lm_valid"][1][:, None]
    assert stale.any()
    np.testing.assert_array_equal(want["wobs_valid"][1],
                                  st["wobs_valid"][1] & ~stale)
    for f in tvo.VOState._fields:
        if f != "wobs_valid":
            np.testing.assert_array_equal(want[f][1], st[f][1], err_msg=f)
