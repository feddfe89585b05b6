"""The profiling and vocabulary tools through both packages on the CPU:
``tools/torch_profile_pipeline.py`` against ``tools/profile_pipeline.py``
(the same timer sections over the same rendered frames; the original's BA
bucket prewarm, a workaround for remote compiles, is dropped in the port
and stubbed out here), and ``tools/torch_eval_vocab_transfer.py``'s
``eval_domain`` against the original's on the dot-field and room domains,
with the port's pyramid taken from the JAX package (rows equal, scores
within 1e-3 after both round them to 3 places); the room's case, about
80 s, is marked slow."""
import io
import sys

import pytest
import torch
from torch_tools_shared import port_audit_in_jax_mapper, share_jax_pyramid

import eval_vocab_transfer as jvocab
import profile_pipeline as jprof
import torch_eval_vocab_transfer as tvocab
import torch_profile_pipeline as tprof

torch.set_num_threads(1)


def _sections(table):
    return {ln.split()[0] for ln in table.splitlines()[1:]}


def test_profile_sections_match_jax_tool(monkeypatch):
    import bench

    port_audit_in_jax_mapper(monkeypatch)
    monkeypatch.setattr(bench, "_prewarm_ba_buckets", lambda settings: None)
    out = io.StringIO()
    monkeypatch.setattr(sys, "stdout", out)
    jprof.main(n_frames=5, n_warm=2)
    monkeypatch.undo()
    lines = out.getvalue().splitlines()
    assert lines[0].startswith("fps=") and lines[1].startswith("advance_ms")
    want = _sections("\n".join(lines[2:]))
    res = tprof.profile(n_frames=5, n_warm=2, device="cpu")
    got = _sections(res["stats"].table())
    assert {"local_bundle_adjust", "create_new_map_points",
            "detect_and_extract"} <= got
    assert got == want
    assert len(res["advance_ms"]) == len(res["prefetch_ms"]) == 3
    assert res["fps"] > 0


@pytest.mark.parametrize("domain", [
    "dots", pytest.param("room", marks=pytest.mark.slow)])
def test_eval_domain_matches_jax_tool(domain, monkeypatch):
    lap, seed = 4, 100
    jdom = {"dots": lambda: jvocab._dots_domain(lap, seed),
            "room": lambda: jvocab._room_domain(lap, seed, tile=0)}[domain]
    want = jvocab.eval_domain(domain, *jdom(), lap, seed=seed)
    share_jax_pyramid(monkeypatch)
    got = tvocab.eval_domain(domain, *tvocab.DOMAINS[domain](lap, seed), lap,
                             seed=seed, device="cpu")
    assert len(got) == len(want) == len(tvocab.LEVELS)
    for a, b in zip(want, got):
        assert a.keys() == b.keys()
        for k in ("domain", "level", "lap", "recall", "mean_candidates"):
            assert a[k] == b[k], (k, a, b)
        for k in ("min_genuine_score", "mean_genuine_score"):
            assert abs(a[k] - b[k]) <= 1e-3, (k, a, b)
    assert got[0]["recall"] == 1.0             # exact re-renders
