"""Run one cell of the port's benchmark once, on the card it starts on.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout that holds ``BENCHMARK.json``. The cell
names a configuration (``benchmark/configs``), a traffic mix
(``benchmark/traffic``, whose ``driver`` is a module of
``benchmark/harness``) and its own file (``benchmark/cells``). Set-up makes
the frames on the card from the seed and warms every shape the cell uses;
the window then drives the program for ``--seconds``. With ``--trace 0``
the result carries the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics, each read by ``benchmark/metrics/<name>.py`` from the
run's records. After the window the plain reference
(``benchmark/harness/reference.py``) judges a seeded sample of what the
window produced; every number compared is printed beside its limit, on
standard error and under ``checks`` in the result. The last line of
standard output is the result, one JSON object.

Exits non-zero, printing no result, without a card (or with fewer than the
cell asks for), or when JAX or the JAX package is loaded once the window
has closed.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, BENCH_DIR)

FORBIDDEN = ("jax", "jaxlib", "flax", "slam_tpu")
# every number the last run's reference worked out, limited or not
NUMBERS = {}


def loaded_forbidden() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole: ``slam_tpu_torch`` is not ``slam_tpu``."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _cache_dirs(root: str) -> None:
    """Build and kernel caches at fixed paths inside the checkout (the
    port's own nvcc and g++ outputs already go to ``build/slam_tpu_torch``)."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(root, "build", "bench_cache", sub)


def run_cell(root: str, name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", bench_dir: str = BENCH_DIR) -> dict:
    """One run of cell ``name``: set-up, window, reference. Returns the
    result object (``correct``, ``attempted``, ``failed``, ``metrics``,
    ``device``, ``breakdown`` when traced, ``checks`` last)."""
    import torch

    from harness import checks, spec
    from harness import trace as tr

    if root not in sys.path:
        sys.path.insert(0, root)
    man = spec.manifest(root)
    wl = spec.workload(man, name)
    cfg = spec.config(wl["config"], bench_dir)
    mix = spec.traffic(wl["traffic"], bench_dir)
    cell = spec.cell(name, bench_dir)
    driver = spec.driver(mix["driver"])
    dev = torch.device(device)

    spans = tr.Spans(trace)
    k1 = tr.K1Shapes().install()
    from slam_tpu_torch.utils import timer

    run = driver.make(cfg, mix, cell, seed, dev, spans)
    run.warm()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - T_START

    dtrace = tr.DeviceTrace(dev, k1, driver.SPANS) if trace else None
    if trace:
        timer.enable_timing()
    spans.reset()
    k1_setup = list(k1.calls)
    k1.calls.clear()
    rec = run.window(seconds, dtrace)
    stats = timer.TIME_STATS
    timer.disable_timing()
    rec["setup_s"] = setup_s
    rec["spans"] = {k: list(v) for k, v in spans.seconds.items()}
    rec["timer"] = ({k: [stats.totals[k], stats.counts[k]]
                     for k in stats.totals} if stats is not None else {})
    rec["k1_shapes"] = list(k1.calls)
    rec["k1_shapes_setup"] = k1_setup
    if trace:
        rec["trace"] = dtrace.read()
    memory_peak = (torch.cuda.max_memory_allocated(dev)
                   if dev.type == "cuda" else 0)
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    group = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in spec.metrics_for(man, name, group):
        value = spec.reader(m["name"], bench_dir)(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    numbers, attempted, failed = run.judge(seed)
    NUMBERS.clear()
    NUMBERS.update(numbers)
    compared = checks.compare(numbers, cell["limits"])
    correct = all(c["ok"] for c in compared.values())
    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": metrics,
           "device": {"platform": "gpu" if dev.type == "cuda" else "cpu",
                      "kind": kind, "count": 1,
                      "memory_peak_bytes": int(memory_peak)}}
    if trace:
        t = rec["trace"]
        out["device"]["busy_s"] = t["busy_s"]
        out["device"]["window_s"] = t["traced_s"]
        out["breakdown"] = {"device_ops": t["device_ops"],
                            "idle_gaps": t["idle_gaps"]}
    out["checks"] = {k: [v["value"], v["limit"]] for k, v in compared.items()}
    for k, v in compared.items():
        print(f"check {k}: {v['value']!r} limit {v['limit']!r} "
              f"{'ok' if v['ok'] else 'FAILED'}", file=sys.stderr)
    if found := loaded_forbidden():
        raise SystemExit(f"JAX loaded in the benchmark process: {found}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = os.getcwd()
    _cache_dirs(root)
    os.environ.setdefault("USE_FLAX", "0")

    import torch

    from harness import spec

    chips = spec.workload(spec.manifest(root), args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = run_cell(root, args.workload, args.seed, args.seconds,
                   bool(args.trace))
    sys.stdout.flush()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
