"""The BA solver's PCG branch and its fixed-order segment sums on the card,
held to the CPU: a global-BA problem above the dense-Schur limit (K = 160
padded poses, M = 8,192 points, O = 65,536 observations, pose edges and a
prior) solved with the PCG budget ``pick_cg_iters`` gives (96), poses and
points within 1e-4 of the CPU's; and ``segment_sum`` of the normal blocks
of a padded local-BA problem at the reference's quanta (K 16, M 256, O
1024) bit-equal on the card and the CPU, so that a torch release that
changes CUDA ``index_put_(accumulate=True)`` fails here; and a problem
replayed at its first sight in a larger captured bucket that covers it
(``ops/ba._dispatch``'s cover) bit-equal to the twin at that bucket's sizes and within two float32
ulps of its own bucket's replay, for both entries. The card
tests import no JAX, so they run on a machine without it:

    python -m pytest tests/test_torch_ba_card.py --noconftest -m cuda

On the CPU the same file checks the generator's problem, the PCG branch
against the dense Schur solve, and ``segment_sum`` against a loop in row
order."""
import pytest
import torch

from slam_tpu_torch.ops import ba
from slam_tpu_torch.utils.synthetic import ba_problem

torch.set_num_threads(1)
PCG = (160, 8192, 8)
QUANTA = (16, 256, 4)


def _on(p, device):
    return type(p)(*(t.to(device) for t in p))


def _normal_blocks(p):
    """{name: (values, segment ids, segments)} of the sums one LM step
    takes over the reprojection edges."""
    r, J_pose, J_pt, _, _ = ba._reproj_terms(p.poses, p.points, p,
                                             ba.HUBER_DELTA)
    K, M = p.poses.shape[1], p.points.shape[1]
    return {
        "Hpp": (torch.einsum("soci,socj->soij", J_pose, J_pose), p.obs_kf, K),
        "Wkm": (torch.einsum("soci,socj->soij", J_pose, J_pt),
                p.obs_kf * M + p.obs_mp, K * M),
        "Hll": (torch.einsum("soci,socj->soij", J_pt, J_pt), p.obs_mp, M),
        "bp": (-torch.einsum("soci,soc->soi", J_pose, r), p.obs_kf, K),
        "bl": (-torch.einsum("soci,soc->soi", J_pt, r), p.obs_mp, M)}


def test_ba_problem_shapes():
    K, M, J = QUANTA
    p = ba_problem(K, M, J, seed=1)
    assert tuple(p.poses.shape) == (1, K, 4, 4)
    assert tuple(p.obs_kf.shape) == (1, M * J)
    kf = p.obs_kf[0].reshape(M, J)
    # distinct observers per point
    assert bool((torch.sort(kf, dim=1).values.diff(dim=1) > 0).all())
    assert ba.pick_cg_iters(*PCG[:2]) == 96
    assert PCG[0] * PCG[1] > ba.DENSE_SCHUR_MAX_KM


def test_pcg_agrees_with_dense_schur_on_cpu():
    """Both solvers of ``lm_run`` reach the same optimum (1e-4) on a small
    problem of the generator's."""
    p = ba_problem(24, 512, 6, seed=2)
    dense = ba.solve_ba(p, 5, 0)
    pcg = ba.solve_ba(p, 5, 96)
    cost0 = float(ba._total_cost(p.poses, p.points, p, ba.HUBER_DELTA)[0])
    assert float(dense.cost) < 0.1 * cost0
    assert float((pcg.poses - dense.poses).abs().max()) < 1e-4
    assert float((pcg.points - dense.points).abs().max()) < 1e-4


@pytest.mark.parametrize("block", ["Hpp", "Wkm", "Hll", "bp", "bl"])
def test_segment_sum_adds_in_row_order_on_cpu(block):
    values, idx, n = _normal_blocks(ba_problem(*QUANTA, seed=1))[block]
    want = torch.zeros((n,) + values.shape[2:])
    for v, i in zip(values[0], idx[0]):
        want[i] = want[i] + v
    assert torch.equal(ba.segment_sum(values, idx, n)[0], want)


@pytest.mark.cuda
def test_pcg_on_the_card_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    K, M, J = PCG
    p = ba_problem(K, M, J, seed=0)
    cg = ba.pick_cg_iters(K, M)
    cpu = ba.solve_ba(p, 5, cg)
    card = ba.solve_ba(_on(p, "cuda"), 5, cg)
    assert float((card.poses.cpu() - cpu.poses).abs().max()) < 1e-4
    assert float((card.points.cpu() - cpu.points).abs().max()) < 1e-4


@pytest.mark.cuda
def test_segment_sum_on_the_card_is_bit_equal():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for name, (values, idx, n) in _normal_blocks(
            ba_problem(*QUANTA, seed=1)).items():
        got = ba.segment_sum(values.cuda(), idx.cuda(), n).cpu()
        assert torch.equal(got, ba.segment_sum(values, idx, n)), name


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ["solve_ba", "solve_ba_two_stage"])
def test_cover_replay_on_card(entry):
    """A problem of the local BA's smallest bucket (K 16, M 256, O 1024,
    built by ``_ProblemBuilder``) replayed at its first sight in a captured
    larger bucket that covers it (``ops/ba._dispatch``'s cover; larger
    in M, in O, in K and in all three): bit-equal to the op-by-op twin on the problem padded to
    that bucket's sizes, as every replay is to its twin; and within two
    float32 ulps (of each output's largest magnitude) of the replay of its
    own bucket. On the card the larger bucket's float64 reductions (the
    Schur complement's contraction over M, the cost's sum over O, the
    (6K, 6K) solve) may round otherwise than the smaller bucket's, and the
    float32 results then part by a last bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import test_torch_ba_cover as cover

    def on_card(args):
        return tuple(_on(a, "cuda") if isinstance(a, ba.BAProblem)
                     else a.cuda() for a in args)

    args = on_card(cover.problem(entry, cover.SMALL, 1))
    ulp = torch.finfo(torch.float32).eps
    try:
        ba.BA_GRAPHS.clear()
        cover.call(entry, args)                  # sighting
        own = cover.call(entry, args)            # capture and replay
        assert ba.BA_GRAPHS.counters()["replays"] == 1
        cover.equal(own, cover.call(entry, args, eager=True),
                    "own replay against the eager twin")
        for axes, sizes in sorted(cover.LARGER.items()):
            ba.BA_GRAPHS.clear()
            for seed in (100, 101):              # sighting, capture
                cover.call(entry, on_card(cover.problem(entry, sizes,
                                                        seed)))
            covered = cover.call(entry, args)
            b = ba.last_served()
            c = ba.BA_GRAPHS.counters()
            assert (c["buckets"], c["captures"], c["covers"]) == (2, 1, 1)
            assert b["covered"] and b["K"] * b["M"] * b["O"] > 16 * 256 * 1024
            twin = cover.call(entry, cover.grown(
                entry, args, (b["K"], b["M"], b["O"])), eager=True)
            cover.equal(covered, cover.cut(twin, covered),
                        f"cover in {axes} against the twin at its sizes")
            for f, x, y in zip(ba.BAResult._fields, covered, own):
                gap = float((x - y).abs().max())
                assert gap <= 2 * ulp * float(y.abs().max()), (axes, f, gap)
    finally:
        ba.BA_GRAPHS.clear()
