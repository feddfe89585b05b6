"""Fleet traffic: S sequences at once through ``DeviceSlam``, in chunks.

Every frame of every sequence is rendered on the card from the seed during
set-up and kept on the host, as uploads would arrive. Set-up warms one
``DeviceSlam`` over the first chunks (the chunk's first run eager, its
second captured as a CUDA graph, then a replay) and the rebase once, then
resets that instance's ``BatchedDeviceVO`` (the captured graph stays) and
hands it to the session the window drives. The window advances chunk after
chunk until ``seconds`` have passed, then drains (``finish``) and
synchronises; if a batch runs out first, the same sequences start again on
a fresh session that keeps the graph.
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch

from harness import reference, scenes
from harness.sampling import Reservoir

# the benchmark's own host spans around calls into the program
SPANS = ("fleet.advance", "fleet.consume")
# a stored frame missing from the ring reads as the widest possible gap
# between two cosine scores
MISSING = 2.0


class ChunkRecords:
    """Copies, taken inside the chunk, of the inputs and outputs of the
    program's pose LM (``device_vo._pose_ba``) and retrieval quantisation
    (K1, ``device_vo.hamming_argmin``). Installed once a process around
    whatever those functions are at that moment; a copy made while the
    chunk is captured lives in the graph's pool and is rewritten by each
    replay."""

    def __init__(self):
        from slam_tpu_torch.pipeline import device_vo as dv

        self.cur = None
        self.latest = None       # the last chunk run op by op
        self.captured = None     # the chunk held by the captured graph
        self.runs = 0
        self.seen = 0
        pose_ba, argmin = dv._pose_ba, dv.hamming_argmin
        chunk = dv._ChunkGraph.chunk
        rec = self

        def pose_rec(state, pose_pred, meas_xy, matched, *a, **k):
            out = pose_ba(state, pose_pred, meas_xy, matched, *a, **k)
            if rec.cur is not None:
                rec.cur["pose"].append([t.clone() for t in (
                    state.lm_pos, state.lm_n_obs, pose_pred, meas_xy,
                    matched, out)])
            return out

        def words_rec(desc, codebook):
            dist, words = argmin(desc, codebook)
            if rec.cur is not None:
                rec.cur["words"].append([desc.clone(), words.clone()])
            return dist, words

        def chunk_rec(graph, *a, **k):
            rec.cur = dict(pose=[], words=[])
            try:
                return chunk(graph, *a, **k)
            finally:
                cur, rec.cur = rec.cur, None
                if torch.cuda.is_available() and \
                        torch.cuda.is_current_stream_capturing():
                    rec.captured = cur
                else:
                    rec.latest = cur
                rec.runs += 1

        dv._pose_ba, dv.hamming_argmin = pose_rec, words_rec
        dv._ChunkGraph.chunk = chunk_rec

    def take(self) -> dict:
        """The records of the chunk that ran last: its own where it ran op
        by op, else copies of the replayed graph's."""
        if self.runs != self.seen:
            self.seen = self.runs
            return self.latest
        return {k: [[t.clone() for t in r] for r in v]
                for k, v in self.captured.items()}


RECORDS = None


def records() -> ChunkRecords:
    global RECORDS
    if RECORDS is None:
        RECORDS = ChunkRecords()
    return RECORDS


class Fleet:
    def __init__(self, cfg, mix, cell, seed, device, spans):
        from slam_tpu_torch.geometry.camera import PinholeCamera
        from slam_tpu_torch.pipeline.device_slam import DeviceSlamParams
        from slam_tpu_torch.pipeline.device_vo import DeviceVOConfig

        self.device = torch.device(device)
        self.spans = spans
        self.cell = cell
        self.S, self.T = int(mix["sequences"]), int(mix["chunk"])
        n = int(cell["frames"]) // self.T * self.T
        self.n = n
        self.cam = scenes.Camera(cfg["camera"])
        self.camera = PinholeCamera(**cfg["camera"])
        self.fps = float(cfg["trajectory"]["fps"])
        _, self.truth = scenes.trajectory(cfg["trajectory"], n)
        images = np.empty((n // self.T, self.S, self.T, self.cam.height,
                           self.cam.width), np.uint8)
        odo, deltas = [], []
        for s in range(self.S):
            scene = scenes.make_scene(cfg["scene"], seed * 1000 + s,
                                      self.device)
            fr = scenes.render_frames(scene, self.truth, self.cam,
                                      self.device)
            images[:, s] = fr.reshape(n // self.T, self.T, *fr.shape[1:])
            rng = np.random.default_rng([seed, 2, s])
            o = scenes.drifted_odometry(self.truth, float(cell["drift"]),
                                        float(cell.get("drift_yaw", 0.0)),
                                        rng)
            odo.append(o)
            deltas.append(scenes.odometry_deltas(o))
        self.images = images
        self.odo = np.stack(odo)
        d = np.stack(deltas)                                   # (S, n, 4, 4)
        self.deltas = np.ascontiguousarray(
            d.reshape(self.S, n // self.T, self.T, 4, 4).transpose(1, 0, 2,
                                                                   3, 4))
        self.p0 = np.repeat(self.truth[:1], self.S, 0).astype(np.float32)
        kw = dict(cfg["device_vo"], width=self.cam.width,
                  height=self.cam.height)
        if kw.pop("stale_age_frames", False):
            kw["stale_age"] = n
        self.vo_cfg = DeviceVOConfig(**kw)
        self.solver_cfg = reference.SolverSettings.of(cfg)
        self.params = DeviceSlamParams(frame_dt=1.0 / self.fps,
                                       **cfg.get("device_slam", {}))
        self.sessions = []         # (DeviceSlam, frames advanced)
        self.trace_span = tuple(mix["trace_span"])
        self.attempts = Reservoir(int(cell["sample"]["closure_attempts"]),
                                  np.random.default_rng([seed, 3]))
        # chunks whose retrieval is checked: drawn from the seed among the
        # first chunks, which every window reaches
        lo, hi = cell["sample"]["chunk_range"]
        self.checked_chunks = set(np.random.default_rng([seed, 7]).choice(
            np.arange(lo, hi), int(cell["sample"]["chunks"]),
            replace=False).tolist())
        self.retrievals = []
        self.records = records()
        self.solves = []
        # set by benchmark/control.py only: TF32-rounded reference scores
        # stand in the program's place
        self.control_tf32 = False

    def _session(self, vo=None):
        from slam_tpu_torch.pipeline.device_slam import DeviceSlam

        ds = DeviceSlam(self.vo_cfg, batch=self.S, camera=self.camera,
                        params=self.params, device=self.device)
        if vo is not None:
            ds.vo = vo
        ds.vo.reset(self.p0)
        try_close = ds._try_close
        attempts = self.attempts

        def recorded(seq, q, c, score):
            (_, _, dq, _, vq, _, _), (_, _, dc, _, vc, _, _) = \
                ds._snapshots(seq, q, c)
            ev = try_close(seq, q, c, score)
            attempts.offer(lambda: (ev, dq.copy(), vq.copy(), dc.copy(),
                                    vc.copy()))
            return ev

        ds._try_close = recorded
        ds._consume = self.spans.wrap("fleet.consume", ds._consume)
        return ds

    def warm(self, chunks: int = 3):
        """The chunk eager, captured and replayed; the rebase once."""
        from slam_tpu_torch.pipeline.device_vo import _rebase_states

        ds = self._session()
        for c in range(chunks):
            ds.advance(self.images[c], self.deltas[c])
        ds.finish()
        S, R = self.S, self.vo_cfg.loop_slots
        dev = self.device
        eye = torch.eye(4, device=dev)
        ds.vo.state = _rebase_states(
            ds.vo.state, eye.expand(S, 4, 4).clone(),
            torch.zeros(S, dtype=torch.bool, device=dev),
            torch.full((S,), -1, dtype=torch.int32, device=dev),
            torch.zeros(S, dtype=torch.int64, device=dev),
            eye.expand(S, R, 4, 4).clone(),
            torch.full((S, R), -2, dtype=torch.int32, device=dev),
            merge_radius=float(self.params.merge_radius_m),
            merge=bool(self.params.merge_landmarks))
        self._sync()
        self.vo = ds.vo

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def window(self, seconds: float, trace=None):
        """Advance until ``seconds`` have passed; returns the records.
        With ``trace``, the device is traced over the mix's ``trace_span``
        of chunks."""
        trace_chunks = self.trace_span
        ds = self._session(self.vo)
        done = 0
        chunks = 0
        self.records.seen = self.records.runs
        self._sync()
        t0 = time.perf_counter()
        while True:
            c = done // self.T
            if c == self.n // self.T:              # batch used up
                ds.finish()
                self.sessions.append((ds, done))
                ds, done = self._session(self.vo), 0
                c = 0
            if trace is not None and chunks == trace_chunks[0]:
                trace.start()
            with self.spans.span("fleet.advance"):
                out = ds.advance(self.images[c], self.deltas[c])
            if chunks in self.checked_chunks:
                st = ds.vo.state
                self.retrievals.append((done, out.loop_frame, out.loop_score,
                                        st.sig_ring, st.sig_frame))
                self.solves.append(self.records.take())
            done += self.T
            chunks += 1
            if trace is not None and chunks == trace_chunks[1]:
                trace.stop()
            if time.perf_counter() - t0 >= seconds:
                if trace is not None and trace.t0 is not None \
                        and trace.t1 is None:
                    trace.stop()
                break
        ds.finish()
        self._sync()
        window_s = time.perf_counter() - t0
        self.sessions.append((ds, done))
        keyframes = self.S * (sum(d for _, d in self.sessions))
        return dict(kind="fleet", window_s=window_s, keyframes=keyframes,
                    chunks=chunks,
                    traced_chunks=trace_chunks[1] - trace_chunks[0])

    # ------------------------------------------------------------ checks

    def judge(self, seed) -> tuple:
        """(numbers, attempted, failed) of the finished window: every
        frame of every sequence is attempted, and one whose pose is
        missing or not finite failed. The program's device state is freed
        before the reference runs."""
        attempted = failed = 0
        for ds, done in self.sessions:
            for s in range(self.S):
                traj = ds.trajectory(s)[:done]
                attempted += done
                failed += int((~np.isfinite(traj).all(axis=(1, 2))).sum()
                              + done - len(traj))
        for ds, _ in self.sessions:
            ds.vo = None
        self.vo = None
        return self.numbers(seed), attempted, failed

    def numbers(self, seed) -> dict:
        """The compared numbers (see ``cells/<cell>.json`` ``limits``)."""
        ratios, false_closures = [], 0
        max_m = float(self.cell["closure_max_m"])
        truth_c = reference.camera_centers(self.truth)
        for ds, done in self.sessions:
            for s in range(self.S):
                traj = ds.trajectory(s)[:done]
                est = reference.camera_centers(traj)
                odo = reference.camera_centers(self.odo[s, :done])
                ratios.append(reference.ate(est, truth_c[:done])
                              / max(reference.ate(odo, truth_c[:done]),
                                    1e-12))
            for ev in ds.closures:
                if ev.accepted and np.linalg.norm(
                        truth_c[ev.query_frame] - truth_c[ev.cand_frame]) \
                        > max_m:
                    false_closures += 1
        gap = 0
        lowe = float(self.params.lowe_ratio)
        thr = int(self.cell["hamming_thr_low"])
        for ev, dq, vq, dc, vc in self.attempts.items():
            if ev.reason == "ring_overwritten":
                continue
            ref = reference.mutual_nn_lowe_count(dq, dc, vq, vc, lowe, thr)
            gap = max(gap, abs(ref - ev.n_matches))
        out = dict(ate_ratio=float(max(ratios)),
                   false_closures=false_closures,
                   closure_match_gap=gap,
                   retrieval_score_gap=self._retrieval_gap())
        out.update(self._solver_gaps())
        return out

    def _solver_gaps(self) -> dict:
        """The sampled chunks' pose LMs set up again by the reference from
        the inputs the program handed them and solved in float64 (the
        largest camera-centre gap), and K1's words against the plain
        nearest codeword over the retrieval codebook. The window BA is not
        compared: its float32 solve lands up to centimetres from the
        float64 one along directions its cost barely sees (``PERF.md``)."""
        dev = self.device
        sc = self.solver_cfg
        book = reference.loop_codebook(
            os.path.join(os.getcwd(), self.cell["vocabulary"]),
            self.vo_cfg.loop_words)
        gap, n, mism = 0.0, 0, 0
        for rec in self.solves:
            for lm_pos, n_obs, pred, meas, matched, out in rec["pose"]:
                for s in range(out.shape[0]):
                    ref = reference.pose_lm(lm_pos[s], n_obs[s], pred[s],
                                            meas[s], matched[s], sc,
                                            torch.float64, dev)
                    gap = max(gap, _centre_gap(out[s], ref))
                    n += 1
            for desc, words in rec["words"]:
                _, idx = reference.hamming_argmin(
                    desc.cpu().numpy().view(np.uint32), book, dev)
                mism += int((idx != words.cpu().numpy()).sum())
        # a window with no pose LM to check reads as the widest gap
        return dict(pose_lm_gap_m=gap if n else float("inf"),
                    word_mismatches=mism)

    def _retrieval_gap(self) -> float:
        """Largest gap between a stored frame's reported retrieval score
        and the best score over the ring entries eligible at its query,
        worked out in float64 from the ring's signatures; a stored frame
        that the ring does not hold reads ``MISSING``."""
        cfg = self.vo_cfg
        E, R = cfg.loop_every, cfg.loop_slots
        span = R * E
        gap = 0.0
        for offset, lf, ls, ring, frames in self.retrievals:
            ls = ls.cpu().numpy()
            ring = ring.cpu().double().numpy()
            frames = frames.cpu().numpy()
            for s in range(ls.shape[0]):
                for t in range(ls.shape[1]):
                    q = offset + t
                    slot = (q // E) % R
                    if q % E:
                        continue
                    if frames[s, slot] != q:
                        gap = max(gap, MISSING)
                        continue
                    f = frames[s]
                    ok = (f >= 0) & (q - f >= cfg.loop_min_gap)
                    if span > cfg.loop_stale_guard:
                        ok &= f > q - (span - cfg.loop_stale_guard)
                    ref = reference.best_score(ring[s][ok], ring[s, slot])
                    got = (reference.best_score(ring[s][ok], ring[s, slot],
                                                tf32=True)
                           if self.control_tf32 else float(ls[s, t]))
                    gap = max(gap, abs(got - ref))
        return gap

def _centre_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """Largest distance between the camera centres of two pose stacks."""
    if not a.numel():
        return 0.0
    ca = reference.camera_centers(a.double().cpu().numpy())
    cb = reference.camera_centers(b.double().cpu().numpy())
    return float(np.linalg.norm(ca - cb, axis=-1).max())


make = Fleet
