"""The controls of the comparison that decides ``correct``: runs that have
to come out not correct.

    python3 benchmark/control.py --workload <cell> --seed <n> \
        --seconds <s> --control tf32|reference-f32

- ``tf32``: the program with its full-float32 pin lifted (TF32 allowed for
  matmuls and cuDNN), the nearest precision below the float32 the fleet's
  configuration states for the device VO (its pose LMs, window BAs and
  retrieval); every module that pins calls a stand-in that enables TF32
  instead.
- ``reference-f32``: the reference's local and pose BAs solved in
  float32 stand in for the live cell's solves (the configuration states
  the Mapper's LM in float64), compared with the float64 reference.
- ``reference-tf32``: the reference's retrieval scores from TF32-rounded
  signatures stand in for the fleet's reported scores (the program's own
  TF32 path moves nothing: its products are not tensor-core GEMMs).
- ``fault:<name>``: a fault of ``benchmark/tests/faults.py`` planted in the
  program, for a number's reading under that fault.
- ``none``: a sound run, for the lower readings; a live cell's numbers
  are then read a second time with ``reference-f32`` standing in, from
  the same samples.

Prints one JSON line: the control, ``correct`` and every compared number
beside its limit. The benchmark's own runs never run a control.
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import run  # noqa: E402


def allow_tf32() -> None:
    import torch

    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True


def lift_f32_pin() -> None:
    """Every module that imported ``pin_full_f32`` gets the stand-in."""
    import importlib
    import pkgutil

    import slam_tpu_torch
    from slam_tpu_torch import precision

    precision.pin_full_f32 = allow_tf32
    for m in pkgutil.walk_packages(slam_tpu_torch.__path__, "slam_tpu_torch."):
        try:
            mod = importlib.import_module(m.name)
        except ImportError:
            continue
        if getattr(mod, "pin_full_f32", None) is not None:
            mod.pin_full_f32 = allow_tf32
    allow_tf32()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", required=True,
                    help="none, tf32, reference-f32, reference-tf32 or "
                         "fault:<name>")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--bench-dir", default=run.BENCH_DIR)
    args = ap.parse_args(argv)
    root = os.getcwd()
    sys.path.insert(0, root)
    made = []
    if args.control == "none":
        from harness import live

        def kept(*a, _make=live.make, **k):
            made.append(_make(*a, **k))
            return made[-1]

        live.make = kept
    elif args.control == "tf32":
        lift_f32_pin()
    elif args.control.startswith("fault:"):
        sys.path.insert(0, os.path.join(os.path.dirname(
            os.path.abspath(__file__)), "tests"))
        import faults

        getattr(faults, args.control[len("fault:"):])()
    elif args.control in ("reference-f32", "reference-tf32"):
        import torch

        from harness import fleet, live

        mod, name, value = ((live, "control_dtype", torch.float32)
                            if args.control == "reference-f32"
                            else (fleet, "control_tf32", True))

        def controlled(*a, _make=mod.make, **k):
            r = _make(*a, **k)
            setattr(r, name, value)
            return r

        mod.make = controlled
    else:
        raise SystemExit(f"unknown control {args.control!r}")
    out = run.run_cell(root, args.workload, args.seed, args.seconds, False,
                       device=args.device, bench_dir=args.bench_dir)
    line = {"control": args.control, "workload": args.workload,
            "seed": args.seed, "correct": out["correct"],
            "checks": out["checks"], "numbers": dict(run.NUMBERS)}
    if made:
        import numpy as np
        import torch

        r = made[-1]
        r.control_dtype = torch.float32
        vocab = np.load(os.path.join(root, r.cell["vocabulary"]))["codebook"]
        line["reference_f32_numbers"] = r.numbers(vocab)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
