"""The control and the faults: a run with the timed path broken underneath
comes out not correct. The control itself separates from sound runs only
at a cell's size, where a cloud has thousands of views near the
threshold: that case runs on the card (`cuda`); here its parts are
checked."""
import time

import pytest
import torch

from benchmark import control, harness, reference, scenes
from benchmark.tests import tiny


def test_near_misses_count_the_band_below_the_threshold():
    scores = torch.tensor([[-1.0, 0.70, 0.5995, 0.80],
                           [-1.0, 0.70, 0.59995, 0.65],
                           [-1.0, 0.61, 0.62, 0.63],
                           [-1.0, 0.5995, 0.9, -1.0]])
    payload = torch.tensor([[False, True, True, True]] * 3
                           + [[False, True, True, False]])
    anchored = torch.tensor([True, True, True, False])
    # row 0 is in the band, row 1 is rounding, row 2 is clear, row 3 is
    # not anchored
    assert reference.near_misses(scores, payload, anchored, 0.6,
                                 (1e-4, 1e-3)) == 1


GEO = scenes.SceneGeometry(views=5, width=96, height=72, focal_px=390.0,
                           radius_mm=60.0, cam_radius_mm=650.0, tex_size=96,
                           yaw_span_rad=1.0, pitch_span_rad=0.5)


def _patches():
    cap = scenes.make_capture(GEO, scenes.scene_seed(2**31 + 1, 1), "cpu")
    cams = reference.RefCameras(cap.K, cap.R, cap.C, GEO.width, GEO.height,
                                "cpu")
    pos = torch.tensor([[0.0, 0.0, -60.0], [5.0, 0.0, -59.79]])
    nrm = torch.nn.functional.normalize(pos, dim=1)
    ref = torch.tensor([2, 2])
    return cap, cams, pos, nrm, ref


def test_removed_anchor_is_searched_before_the_first_visible_view():
    cap, cams, pos, nrm, ref = _patches()
    vis = torch.tensor([[False, False, True, True, True],
                        [False, True, False, True, True]])
    got = reference.removed_anchor_ncc(cap.images, cams, pos, nrm, ref, vis,
                                       11)
    want = []
    for b, first in enumerate((2, 1)):
        views = torch.nonzero(vis[b]).flatten()
        means = []
        for a in range(first):
            slots = torch.cat([torch.tensor([a]), views])[None]
            sc, _ = reference.slot_ncc(cap.images, cams, pos[b:b + 1],
                                       nrm[b:b + 1], ref[b:b + 1], slots,
                                       torch.ones_like(slots, dtype=bool),
                                       11)
            means.append(float(sc[0, 1:].mean()))
        want.append(max(means))
    assert got.tolist() == pytest.approx(want, abs=1e-6)


def test_control_scores_in_bfloat16_in_the_filters_place():
    from densepoints_tpu_torch.core.cameras import Cameras
    from densepoints_tpu_torch.pmvs import optimize

    cap, _, pos, nrm, ref = _patches()
    cams = Cameras.from_projection_matrices(cap.P, widths=GEO.width,
                                            heights=GEO.height)
    vis = torch.tensor([[False, True, True, True, True]] * 2)
    real = optimize.allview_scores
    want, anchor, _ = real(cap.images, cams, pos, nrm, ref, vis, 11)
    with control.control():
        assert optimize.allview_scores is not real
        got, got_anchor, _ = optimize.allview_scores(
            cap.images, cams, pos, nrm, ref, vis, 11)
    assert optimize.allview_scores is real
    assert torch.equal(anchor, got_anchor)
    assert torch.equal(got == -1, want == -1)
    diff = (got - want).abs().max()
    assert 1e-5 < diff < 2e-2  # bfloat16, not float32


@pytest.mark.parametrize("mode", ["control", "control_solve"])
def test_control_scores_the_objective_in_bfloat16(mode):
    """In the objective's place too: Nelder-Mead minimises the reference's
    bfloat16 cost, through its plain step (no graph capture)."""
    from densepoints_tpu_torch.core.cameras import Cameras
    from densepoints_tpu_torch.ops import nm_step
    from densepoints_tpu_torch.pmvs import optimize

    cap, _, pos, nrm, ref = _patches()
    cams = Cameras.from_projection_matrices(cap.P, widths=GEO.width,
                                            heights=GEO.height)
    vis = torch.tensor([[False, True, True, True, True]] * 2)
    params = torch.tensor([[[0.0, 0.0, 0.0], [0.001, 0.05, -0.05]]] * 2)
    want = optimize.photometric_objective_paged(cap.images, cams, pos, nrm,
                                                ref, vis, 11)(params)
    seen = {}
    real_nm = optimize.nelder_mead
    with control.MODES[mode]():
        f = optimize.photometric_objective_paged(cap.images, cams, pos, nrm,
                                                 ref, vis, 11)
        got = f(params)

        def spy(f, x0, init_step, **kw):
            seen["step"] = isinstance(f, nm_step.StepObjective)
            seen["eager"] = kw.get("_eager")
            return x0, None, None

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr("densepoints_tpu_torch.ops.simplex.nelder_mead", spy)
            optimize.nelder_mead(f, params[:, 0], torch.ones(3))
    assert optimize.nelder_mead is real_nm
    assert seen == {"step": False, "eager": True}
    diff = (got - want).abs().max()
    assert 1e-5 < diff < 2e-2  # bfloat16, not float32


def test_half_the_batch_unscored_is_not_correct(tmp_path):
    """The NCC filter scores half of each batch and keeps the rest as
    given: the kept patches that fail acceptance outright show."""
    bench = tiny.write_bench(tmp_path)
    cell = harness.load_cell("tiny-grid4", bench)
    result, checks = harness.run_cell(cell, 2**31 + 77, 0, False, "cpu",
                                      time.perf_counter(),
                                      window=control.half_unscored)
    assert result["correct"] is False
    share = next(c for c in checks if c["name"] == "photo_fail_share")
    assert not share["ok"] and share["value"] > 0.05


def test_nelder_mead_unchanged_is_not_correct(tmp_path):
    """Nelder-Mead returns the state it was given: next to the poses it
    left as they started, the reference finds a better objective."""
    bench = tiny.write_bench(tmp_path)
    cell = harness.load_cell("tiny-grid4", bench)
    result, checks = harness.run_cell(cell, 2**31 + 77, 0, False, "cpu",
                                      time.perf_counter(),
                                      window=control.nm_unchanged)
    assert result["correct"] is False
    gain = next(c for c in checks if c["name"] == "refine_gain")
    assert not gain["ok"] and gain["value"] > 2 * gain["limit"]


@pytest.mark.cuda
def test_control_is_not_correct_at_the_cells_size():
    """On the card: `python -m pytest benchmark/tests -m cuda`."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = harness.load_cell("dtu49-grid8")
    result, checks = harness.run_cell(cell, 2**31 + 99, 4, False, "cuda",
                                      time.perf_counter(),
                                      window=control.control)
    assert result["correct"] is False
    assert not next(c for c in checks
                    if c["name"] == "near_miss_share")["ok"]
