"""The paper's analysis helpers in the PyTorch port against the JAX
package's, on the CPU, bit for bit: ``flowviz.flowlib``'s ``flow_error``,
``evaluate_flow``, ``interp_gt_flow``, ``segment_flow``,
``disp_to_flowfile`` and ``scale_image``; ``utils.viz``'s
``tensor2array`` (cv2's RAINBOW and BONE colormaps, rebuilt without cv2)
and ``transpose_image``; ``utils.profiling``'s ``seed_everything``,
``StepTimer`` and ``profile_trace`` (a ``torch.profiler`` trace)."""

import glob
import json
import random
import time

import cv2
import numpy as np
import pytest
import torch

from understanding_flow_robustness_tpu.flowviz import flowlib as jflowlib
from understanding_flow_robustness_tpu.utils import profiling as jprofiling
from understanding_flow_robustness_tpu.utils import viz as jviz
from understanding_flow_robustness_tpu_torch import utils
from understanding_flow_robustness_tpu_torch.flowviz import flowlib
from understanding_flow_robustness_tpu_torch.utils import profiling, viz


def _flows(seed, h=37, w=53):
    """GT with unknown (> 1e7) and zero pixels, a prediction."""
    rng = np.random.RandomState(seed)
    gt = (rng.randn(h, w, 2) * 20).astype(np.float32)
    gt[rng.rand(h, w) < 0.1] = 0
    gt[rng.rand(h, w) < 0.05, 0] = 1e9
    gt[rng.rand(h, w) < 0.05, 1] = -2e8
    pred = (gt + rng.randn(h, w, 2) * 3).astype(np.float32)
    return gt, pred


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_flow_error_and_evaluate_flow(seed):
    gt, pred = _flows(seed)
    args = (gt[..., 0], gt[..., 1], pred[..., 0], pred[..., 1])
    got, want = flowlib.flow_error(*args), jflowlib.flow_error(*args)
    assert type(got) is float and got == want and np.isfinite(got)
    assert flowlib.evaluate_flow(gt, pred) == jflowlib.evaluate_flow(gt, pred)
    # the inputs are not mutated
    assert np.array_equal(gt, _flows(seed)[0])


@pytest.mark.parametrize("seed", [0, 1])
def test_interp_gt_flow(seed):
    """Sparse GT: a mask with holes, NaN holes in the flow itself (their
    mask left on), points outside the hull filled with 1e8."""
    rng = np.random.RandomState(seed)
    flow = (rng.randn(24, 31, 2) * 5).astype(np.float32)
    mask = (rng.rand(24, 31) < 0.3).astype(np.uint8)
    flow[rng.rand(24, 31) < 0.05] = np.nan
    got = flowlib.interp_gt_flow(flow, mask)
    want = jflowlib.interp_gt_flow(flow, mask)
    assert got.dtype == want.dtype and got.shape == want.shape == (24, 31, 2)
    assert np.array_equal(got, want, equal_nan=True)
    assert (got == 1e8).any() and np.isfinite(got).all()
    no_mask = flowlib.interp_gt_flow(flow)
    assert np.array_equal(no_mask, jflowlib.interp_gt_flow(flow),
                          equal_nan=True)


def test_segment_flow():
    """Every octant, the axes, zero flow and flows above LARGEFLOW."""
    rng = np.random.RandomState(3)
    flow = rng.randn(40, 40, 2).astype(np.float32)
    flow[0, :8] = [[1, 0], [0, 1], [-1, 0], [0, -1], [0, 0], [1, 1],
                   [-1, -1], [2e8, 1]]
    flow[1, :4] = [[1, -1], [-1, 1], [3, 0.5], [-0.5, -3]]
    got, want = flowlib.segment_flow(flow), jflowlib.segment_flow(flow)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert set(np.unique(got)) == set(range(9))


def test_disp_to_flowfile(tmp_path):
    disp = (np.random.RandomState(4).rand(13, 17) * 60).astype(np.float32)
    flowlib.disp_to_flowfile(disp, str(tmp_path / "t.flo"))
    jflowlib.disp_to_flowfile(disp, str(tmp_path / "j.flo"))
    data = (tmp_path / "t.flo").read_bytes()
    assert data == (tmp_path / "j.flo").read_bytes()
    assert len(data) == 12 + 13 * 17 * 2 * 4


@pytest.mark.parametrize("new_range", [(0, 255), (255, 0), (10, 200),
                                       (0.5, 100.25)])
def test_scale_image(new_range):
    rng = np.random.RandomState(5)
    for img in ((rng.randn(9, 11) * 30).astype(np.float32),
                rng.rand(9, 11, 3), rng.randint(0, 999, (7, 5))):
        got = flowlib.scale_image(img, new_range)
        want = jflowlib.scale_image(img, new_range)
        assert got.dtype == want.dtype == np.uint8
        assert np.array_equal(got, want)


def test_colormap_luts_are_cv2s():
    """The port's LUTs, built from OpenCV's control points, against
    cv2.applyColorMap of every value."""
    x = np.arange(256, dtype=np.uint8)[None]
    for name, cmap in (("rainbow", cv2.COLORMAP_RAINBOW),
                       ("bone", cv2.COLORMAP_BONE)):
        want = cv2.cvtColor(cv2.applyColorMap(x, cmap), cv2.COLOR_BGR2RGB)
        assert np.array_equal(viz.colormap_lut(name), want[0]), name


def _maps():
    rng = np.random.RandomState(6)
    heat = (rng.rand(21, 34) * 300 - 20).astype(np.float32)
    return {
        "heat": heat,
        "heat_c1": heat[..., None],
        "zeros": np.zeros((8, 9), np.float32),
        "negative": -np.abs(heat),
        "f64": rng.rand(10, 12),
        "rgb01": rng.rand(6, 7, 3).astype(np.float32),
        "rgb_pm1": (rng.rand(6, 7, 3) * 2 - 1).astype(np.float32),
        "other": rng.rand(2, 3, 4, 5).astype(np.float32),
    }


@pytest.mark.parametrize("colormap", ["rainbow", "bone"])
@pytest.mark.parametrize("max_value", [255, None, 1.0, 37.5])
def test_tensor2array_matches_jax(colormap, max_value):
    """Both colormaps, ``max_value=None`` (the guarded auto-scale),
    all-zero and all-negative maps, (H, W, 1) maps and 3-channel images,
    against the JAX package's tensor2array with cv2."""
    for key, arr in _maps().items():
        got = viz.tensor2array(arr, max_value, colormap)
        want = jviz.tensor2array(arr, max_value, colormap)
        assert got.dtype == want.dtype == np.float32, key
        assert got.shape == want.shape, key
        assert np.array_equal(got, want), key


def test_transpose_image_and_exports():
    img = np.random.RandomState(7).rand(5, 6, 3)
    assert np.array_equal(viz.transpose_image(img),
                          jviz.transpose_image(img))
    for name in ("StepTimer", "profile_trace", "seed_everything",
                 "tensor2array", "transpose_image"):
        assert name in utils.__all__ and hasattr(utils, name)


def test_seed_everything_draws_what_jax_draws():
    draws = []
    for mod in (jprofiling, profiling):
        rs = mod.seed_everything(123)
        draws.append((random.random(), np.random.rand(3).tolist(),
                      rs.rand(3).tolist(), type(rs)))
    assert draws[0] == draws[1]


def test_step_timer_matches_jax(monkeypatch):
    """Both timers over the same clock readings."""
    summaries = []
    for mod in (jprofiling, profiling):
        ticks = iter([10.0, 10.5, 11.25, 11.5, 13.0, 13.125, 14.0])
        monkeypatch.setattr(time, "time", lambda: next(ticks))
        t = mod.StepTimer()
        for _ in range(3):
            t.data_loaded()
            t.step_done()
        summaries.append((t.summary(), t.data_time, t.batch_time))
        monkeypatch.undo()
    assert summaries[0] == summaries[1]
    assert summaries[0][0]["steps"] == 3


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    """On the CPU the trace holds the ops run inside it and a named
    region.  A trace that cannot be written (its directory is a file)
    raises, where the JAX package's runs the block untraced."""
    with profiling.profile_trace(str(tmp_path / "log")) as prof:
        assert prof is not None
        with torch.profiler.record_function("ufr_analysis_step"):
            torch.mm(torch.ones(16, 16), torch.ones(16, 16))
    files = glob.glob(str(tmp_path / "log" / "*.pt.trace.json"))
    assert len(files) == 1
    names = {e.get("name") for e in json.load(open(files[0]))["traceEvents"]}
    assert {"aten::mm", "ufr_analysis_step"} <= names
    (tmp_path / "file").write_text("")
    ran = []
    with pytest.raises(OSError):
        with profiling.profile_trace(str(tmp_path / "file" / "log")):
            ran.append(1)
    assert not ran
    with jprofiling.profile_trace(str(tmp_path / "file" / "log")):
        ran.append(1)
    assert ran == [1]
