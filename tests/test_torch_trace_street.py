"""``tools/trace_euroc_ba.py --scene street`` through both packages on the
CPU: a 6-frame drive of the small circuit (radius 30 m, the blackout at
frames 3-6), an ATE line every 2 frames, the track reset, and a global BA
run at the end of the drive (6 frames close no loop), whose line (K, M, the
solver branch, the cost before and after, the LM steps accepted, the
keyframes' ATE) both packages print. The JAX LM, traced again for its
costs, ends at its solve's cost. The hooks come out again after each
session (``Tracer.close``)."""
import contextlib
import importlib
import io
import re

import numpy as np
import pytest
import torch

import torch_tools_shared  # noqa: F401  (puts tools/ on the path)
import trace_euroc_ba as tracer

torch.set_num_threads(1)
FRAMES = 6
ARGS = ["--scene", "street", "--device", "cpu", "--frames", str(FRAMES),
        "--radius", "30", "--drift-yaw", "1.2e-4", "--no-reloc",
        "--every", "2"]


def _trace(package):
    """The traced drive, the tracer and its printed lines; a global BA runs
    on the drive's map before its ``Mapper.end``."""
    pkg = "slam_tpu" if package == "jax" else "slam_tpu_torch"
    mapper_cls = importlib.import_module(pkg + ".pipeline.mapper").Mapper
    end, advance = mapper_cls.end, mapper_cls.advance
    t = tracer.Tracer(tracer.parse_args(ARGS + ["--package", package]))
    kw = {} if package == "jax" else {"device": "cpu"}

    def end_after_global_ba(mapper, *a, **k):
        db = mapper.map_db
        t.helpers.global_bundle_adjust(db.latest_keyframe().id, db,
                                       mapper.settings, **kw)
        return end(mapper, *a, **k)

    out = io.StringIO()
    try:
        t.patch(mapper_cls, "end", end_after_global_ba)
        with contextlib.redirect_stdout(out):
            res = t.run()
    finally:
        t.close()
    assert mapper_cls.end is end and mapper_cls.advance is advance
    return res, t, out.getvalue().splitlines()


@pytest.fixture(scope="module")
def traces():
    return {package: _trace(package) for package in ("jax", "torch")}


@pytest.mark.parametrize("package", ["jax", "torch"])
def test_street_hooks_print(traces, package):
    res, t, lines = traces[package]
    assert res["keyframes"] == FRAMES and res["track_resets"] == 1
    ate = [ln for ln in lines if re.match(r"frame \d+: keyframes' ATE", ln)]
    assert [int(ln.split()[1][:-1]) for ln in ate] == [1, 3, 5]
    resets = [ln for ln in lines if ln.startswith("track reset at frame 3:")]
    assert len(resets) == 1, lines
    glob = [ln for ln in lines if ln.startswith("global BA at frame 5")]
    assert len(glob) == 1, lines
    g = t.globals[0]
    assert g.K == 16 and g.nk == FRAMES and g.cg == 0
    assert "dense Schur" in glob[0] and f"of {g.iterations} LM steps" \
        in glob[0]
    c0, c1, accepted = g.steps()
    assert len(g.costs) == g.iterations + 2
    assert c1 <= c0 and 1 <= accepted <= g.iterations


def test_street_traces_agree(traces):
    """Both packages trace the same drive: the same keyframes and reset, the
    same global BA but for the rule on points never triangulated (the JAX
    package's problem takes them, the port's leaves them out); the JAX LM
    traced again ends where its solve ended."""
    (jres, jt, jlines), (tres, tt, _) = traces["jax"], traces["torch"]
    assert jres["keyframes"] == tres["keyframes"]
    jg, tg = jt.globals[0], tt.globals[0]
    assert (jg.K, jg.nk, jg.cg, jg.iterations) == (tg.K, tg.nk, tg.cg,
                                                    tg.iterations)
    assert len(jt.at_origin) > 0
    assert jg.nm - tg.nm == len(jt.at_origin)
    replay = [ln for ln in jlines if "the JAX LM traced again" in ln]
    assert len(replay) == 1
    final, solve = (float(v) for v in re.findall(
        r"final ([\d.e+-]+) against the solve's ([\d.e+-]+)", replay[0])[0])
    np.testing.assert_allclose(final, solve, rtol=1e-6)


def test_street_scale_fit(traces):
    """The drive's Sim3-fit scale and the odometry's sideways error a step
    (``Tracer.scale_fit``): the same odometry in both packages. (The
    fixture ends each drive with a global BA, which in the JAX package
    takes the points never triangulated and moves every keyframe, so only
    the port's scale is held near 1.)"""
    (_, jt, _), (_, tt, _) = traces["jax"], traces["torch"]
    jf, tf = jt.scale_fit(), tt.scale_fit()
    assert set(jf) == set(tf) == {
        "sim3_scale_0_99", "sim3_scale_all", "odometry_sideways_mm_0_99",
        "odometry_sideways_mm_all"}
    assert jf["odometry_sideways_mm_all"] == tf["odometry_sideways_mm_all"]
    assert tf["sim3_scale_0_99"] == tf["sim3_scale_all"]  # 6 frames
    assert 0.95 < tf["sim3_scale_all"] < 1.05


def test_street_replay_splits_the_local_ba_from_the_truth():
    """``--replay-kf 2`` on the 6-frame drive: keyframe 2's local BA solved
    again, split into its stages, then solved from the truth with each term
    off in turn; the hooks come out again."""
    from slam_tpu_torch.ops import ba
    from slam_tpu_torch.pipeline import bundle_adjustment as bamod
    from slam_tpu_torch.pipeline import mapper_helpers as helpers

    before = (helpers.local_bundle_adjust, helpers.create_new_map_points,
              ba.solve_ba_two_stage, bamod._ProblemBuilder.build)
    t = tracer.Tracer(tracer.parse_args(ARGS + ["--replay-kf", "2"]))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        got = t.replay_local()
    lines = out.getvalue().splitlines()
    assert (helpers.local_bundle_adjust, helpers.create_new_map_points,
            ba.solve_ba_two_stage, bamod._ProblemBuilder.build) == before
    assert any(ln.startswith("split keyframe 2's local BA (K 3,")
               for ln in lines), lines
    for name in ("before the BA", "after stage 1", "after stage 2"):
        assert any(ln.startswith(f"  {name}: newest keyframe off by")
                   for ln in lines), name
    depth = [ln for ln in lines if "median depth in the newest keyframe" in ln]
    assert len(depth) == 3 and "(0 points)" not in depth[0], depth
    assert any(re.match(r"  level 1: \d+ observations", ln) for ln in lines)
    np.testing.assert_allclose(got["the truth"], (0.0, 0.0, 1.0), atol=1e-12)
    variants = [k for k in got if k.startswith("stage 2 alone")]
    assert len(variants) == 7, variants
    # the anchor holds the newest keyframe; without it the gauge is free
    assert got["stage 2 alone, every term"][0] < 1e-3
    assert all(0.95 < v[2] < 1.05 for v in got.values())
