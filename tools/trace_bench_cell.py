#!/usr/bin/env python
"""One traced run of a benchmark cell, with everything the program's timer
recorded, on one CUDA card.

    python3 tools/trace_bench_cell.py --workload euroc-mav.live --seed 7 \
        [--seconds 51] [--no-profiler] [--out build/trace_bench_cell.json]

Runs ``benchmark/run.py``'s cell as a ``--trace 1`` run does (the
program's ``utils/timer`` on over the window, ``torch.profiler`` over the
mix's stretch) and keeps what the result line leaves out: the window's rate
(keyframes/s or frames/s, as the cell's end-to-end metric reads it), every
timer entry with its total, count and self time, the stage stamps' sum
against the stretch's device busy time a chunk, the profiled device time
of the stamp kernels, and the top-level spans' share of the window's wall,
also with the profiler's own start and stop (its set-up and the reading of
its buffers, inside the window but in no span) left out.
With ``--no-profiler`` the timer runs alone, so the rate shows what the
spans themselves cost. Prints a summary and writes JSON to ``--out``.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "benchmark"))
sys.path.insert(0, ROOT)

import run as bench  # noqa: E402  (benchmark/run.py: its clock starts here)

STAMP_KERNEL = "stamp_kernel"
STAGES = ("frontend", "track", "landmarks", "retrieval", "window_ba", "snaps")
# the driving thread's top-level program spans of the live cell
LIVE_TOP = ("tracker.process", "mapper.prefetch", "session.add_frame")


def _timed(fn, kept, name):
    """``fn`` with its host seconds added to ``kept["profiler_s"]``."""
    def wrapped(*a, **k):
        t0 = time.perf_counter()
        try:
            return fn(*a, **k)
        finally:
            kept.setdefault("profiler_s", {})[name] = \
                time.perf_counter() - t0
    return wrapped


class _NoProfiler:
    """Stands in for ``harness/trace.DeviceTrace``: no profiler at all."""

    def __init__(self, *a, **k):
        self.t0 = self.t1 = None

    def start(self):
        self.t0 = 0.0

    def stop(self):
        self.t1 = 1.0

    def read(self):
        return dict(busy_s=0.0, traced_s=1.0, flush_idle_s=0.0,
                    device_ops=[], idle_gaps=[], k1_seconds=[],
                    k1_shapes_traced=[])


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=51)
    ap.add_argument("--no-profiler", action="store_true")
    ap.add_argument("--out", default="build/trace_bench_cell.json")
    args = ap.parse_args()
    bench._cache_dirs(ROOT)
    os.environ.setdefault("USE_FLAX", "0")
    import torch

    from harness import spec
    from harness import trace as tr
    from slam_tpu_torch.utils import timer

    if not torch.cuda.is_available():
        sys.exit("trace_bench_cell: no CUDA device")
    kept = {}
    disable = timer.disable_timing

    def keep_and_disable():
        kept["stats"] = timer.TIME_STATS
        disable()

    timer.disable_timing = keep_and_disable
    read = tr.DeviceTrace.read

    def read_with_stamps(self):
        out = read(self)
        out["stamp_s"] = sum(e.time_range.end - e.time_range.start
                             for e in self.prof.events()
                             if STAMP_KERNEL in e.name) * 1e-6
        return out

    if args.no_profiler:
        tr.DeviceTrace = _NoProfiler
    else:
        tr.DeviceTrace.read = read_with_stamps
        for name in ("start", "stop"):
            setattr(tr.DeviceTrace, name, _timed(getattr(tr.DeviceTrace, name),
                                                 kept, name))
    reader = spec.reader

    def keep_rec(name, *a, **k):
        fn = reader(name, *a, **k)

        def wrapped(rec):
            kept["rec"] = rec
            return fn(rec)
        return wrapped

    spec.reader = keep_rec
    out = bench.run_cell(os.getcwd(), args.workload, args.seed, args.seconds,
                         True)
    rec, st = kept["rec"], kept["stats"]
    timer_rows = {k: dict(total_s=st.totals[k], count=st.counts[k],
                          self_s=st.self_totals.get(k),
                          device=k in st.device) for k in st.totals}
    res = dict(workload=args.workload, seed=args.seed,
               profiler=not args.no_profiler, correct=out["correct"],
               device=out["device"], metrics=out["metrics"],
               breakdown=out.get("breakdown"), window_s=rec["window_s"],
               timer=timer_rows, spans=len(st.spans),
               profiler_s=kept.get("profiler_s", {}))
    outside = rec["window_s"] - sum(res["profiler_s"].values())
    if rec["kind"] == "fleet":
        n = rec["chunks"]
        res["keyframes_per_s"] = rec["keyframes"] / rec["window_s"]
        res["chunks"] = n
        stages = {s: 1e3 * st.totals.get(f"vo.device.{s}", 0.0) / n
                  for s in STAGES}
        res["stage_ms_per_chunk"] = stages
        res["stages_sum_ms"] = sum(stages.values())
        t = rec["trace"]
        if not args.no_profiler and rec["traced_chunks"]:
            res["chunk_device_ms"] = 1e3 * t["busy_s"] / rec["traced_chunks"]
            res["stamp_kernel_ms_per_chunk"] = \
                1e3 * t["stamp_s"] / rec["traced_chunks"]
    else:
        res["frames_per_s"] = rec["frames"] / rec["window_s"]
        res["frames"] = rec["frames"]
        top = sum(st.totals.get(k, 0.0) for k in LIVE_TOP)
        res["top_level_ms_per_frame"] = {
            k: 1e3 * st.totals.get(k, 0.0) / rec["frames"] for k in LIVE_TOP}
        res["window_ms_per_frame"] = 1e3 * rec["window_s"] / rec["frames"]
        res["top_level_share"] = top / rec["window_s"]
        res["top_level_share_less_profiler"] = top / outside
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps({k: v for k, v in res.items()
                      if k not in ("timer", "breakdown")}))
    print(st.table())
    if res.get("breakdown"):
        print("idle gaps:", res["breakdown"]["idle_gaps"])
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
