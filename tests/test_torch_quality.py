"""NIQE, the matting metrics and the video helpers of the port
(``vmg_tpu_torch/eval/niqe.py``, ``eval/matting_metrics.py``,
``utils/video.py``) against the JAX package's, which use cv2 (present
here; the card's machine has none, and the port's use scipy).

* NIQE on seeded RGB and grayscale images with a seeded statistics
  ``.npz`` the test writes (the reference's file is not in the repo):
  within ``rtol=1e-6`` -- both sum in float64, cv2's filter and resize
  and scipy's in other orders;
* SAD, MSE, gradient and connectivity errors on seeded mattes, trimaps and
  masked predictions (also with a constant prediction and with ties between
  the largest components): SAD, MSE and connectivity exactly, the gradient
  error within ``rtol=1e-6`` (float32 gradients of float64 filters);
* the progress bar's output is the JAX package's; ``make_video`` writes an
  MP4 where cv2 is, and the statistics path is refused by name.
"""

import io
import os
import sys

import numpy as np
import pytest

from vmg_tpu.eval import matting_metrics as j_matting
from vmg_tpu.eval import niqe as j_niqe
from vmg_tpu.utils import video as j_video
from vmg_tpu_torch.eval import matting_metrics, niqe
from vmg_tpu_torch.utils import video


def _pris(path, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((36, 36))
    win = np.outer(*(2 * [np.exp(-np.arange(-3, 4) ** 2 / (2 * (7 / 6) ** 2))]))
    np.savez(path, mu_pris_param=rng.standard_normal((1, 36)),
             cov_pris_param=a @ a.T / 36 + np.eye(36), gaussian_window=win / win.sum())
    return str(path)


def test_niqe_matches_jax(tmp_path):
    pris = _pris(tmp_path / "pris.npz")
    rng = np.random.default_rng(1)
    base = rng.integers(0, 256, (200, 300, 3)).astype(np.float64)
    smooth = (base + np.roll(base, 1, 0) + np.roll(base, 1, 1)) / 3
    for img, crop in ((smooth, 0), (smooth.astype(np.uint8), 4), (smooth[..., 0], 0)):
        want = j_niqe.niqe(img, pris, crop_border=crop)
        got = niqe.niqe(img, pris, crop_border=crop)
        assert np.isfinite(want) and want > 0
        np.testing.assert_allclose(got, want, rtol=1e-6)
    with pytest.raises(FileNotFoundError, match="natural-scene statistics"):
        niqe.niqe(smooth, str(tmp_path / "missing.npz"))


def _mattes(seed):
    rng = np.random.default_rng(seed)
    alpha = rng.integers(0, 256, (64, 80)).astype(np.uint8)
    alpha[:20] = 0
    alpha[-10:] = 255
    trimap = np.full(alpha.shape, 128, np.uint8)
    trimap[:16], trimap[-8:] = 0, 255
    pred = np.clip(alpha.astype(int) + rng.integers(-40, 41, alpha.shape), 0, 255)
    pred = pred.astype(np.uint8)
    pred[trimap == 0], pred[trimap == 255] = 0, 255
    return alpha, trimap, pred


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_matting_metrics_match_jax(seed):
    alpha, trimap, pred = _mattes(seed)
    cases = [(alpha, trimap, pred)]
    if seed == 2:  # a constant unknown region, and two equal largest components
        flat = np.where(trimap == 128, 77, pred).astype(np.uint8)
        ties = np.zeros((8, 9), np.uint8)
        ties[1:3, 1:3] = ties[5:7, 5:7] = 200
        cases += [(alpha, trimap, flat), (ties, np.full(ties.shape, 128, np.uint8), ties)]
    for a, t, p in cases:
        for name in ("sad", "mse", "connectivity"):
            assert getattr(matting_metrics, name)(a, t, p) == getattr(j_matting, name)(a, t, p), name
        np.testing.assert_allclose(matting_metrics.gradient_error(a, t, p),
                                   j_matting.gradient_error(a, t, p), rtol=1e-6)
    with pytest.raises(ValueError, match="masked"):
        matting_metrics.sad(alpha, trimap, np.full_like(pred, 9))


def test_progress_bar_and_video(tmp_path, monkeypatch):
    got, want = io.StringIO(), io.StringIO()
    bar = video.ProgressBar(3, width=10, stream=got)
    monkeypatch.setattr(sys, "stdout", want)
    jbar = j_video.ProgressBar(3, width=10)
    for b in (bar, jbar):
        b.start = 0.0
    monkeypatch.setattr("time.time", lambda: 6.0)
    for _ in range(3):
        bar.update("x")
        jbar.update("x")
    assert got.getvalue() == want.getvalue()

    import cv2

    for i in range(3):
        cv2.imwrite(str(tmp_path / f"{i:03d}.png"), np.full((16, 24, 3), 40 * i, np.uint8))
    out = video.make_video(str(tmp_path), str(tmp_path / "clip.mp4"), fps=5)
    assert os.path.getsize(out) > 0
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(RuntimeError, match="cv2"):
        video.make_video(str(tmp_path), str(tmp_path / "again.mp4"))
