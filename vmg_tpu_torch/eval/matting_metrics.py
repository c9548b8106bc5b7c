"""Matting metrics: SAD, MSE, gradient error and connectivity error
(``vmg_tpu/eval/matting_metrics.py``; the reference's
``mmedit/core/evaluation/metrics.py:12-137`` and ``metric_utils.py``).

Host numpy and scipy, without cv2: cv2's ``filter2D`` with
``BORDER_REPLICATE`` is ``scipy.ndimage.correlate(mode='nearest')``, its
min-max ``normalize`` is written out, and ``connectedComponentsWithStats``
at connectivity 4 is ``scipy.ndimage.label`` with its default cross
structure (both number the components in raster order, so a tie in the
largest component resolves alike).  Alpha mattes in [0, 255], trimaps in
{0, 128, 255}; the predicted alpha must already be masked by the trimap.
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage


def _check(alpha, trimap, pred_alpha):
    if alpha.ndim != 2 or trimap.ndim != 2 or pred_alpha.ndim != 2:
        raise ValueError("alpha, trimap and pred_alpha must be 2-D")
    if not ((pred_alpha[trimap == 0] == 0).all()
            and (pred_alpha[trimap == 255] == 255).all()):
        raise ValueError("pred_alpha should be masked by trimap before evaluation")


def sad(alpha, trimap, pred_alpha):
    """Sum of absolute differences, in thousands."""
    _check(alpha, trimap, pred_alpha)
    diff = np.abs(pred_alpha.astype(np.float64) / 255 - alpha.astype(np.float64) / 255)
    return diff.sum() / 1000


def mse(alpha, trimap, pred_alpha):
    """Mean squared error over the unknown region."""
    _check(alpha, trimap, pred_alpha)
    weight_sum = (trimap == 128).sum()
    if weight_sum == 0:
        return 0.0
    diff = pred_alpha.astype(np.float64) / 255 - alpha.astype(np.float64) / 255
    return float((diff ** 2).sum() / weight_sum)


def gaussian(x, sigma):
    return np.exp(-x ** 2 / (2 * sigma ** 2)) / (sigma * np.sqrt(2 * np.pi))


def dgaussian(x, sigma):
    return -x * gaussian(x, sigma) / sigma ** 2


def gauss_filter(sigma, epsilon=1e-2):
    """The derivative-of-Gaussian filter pair (x, y)."""
    half_size = np.ceil(sigma * np.sqrt(-2 * np.log(np.sqrt(2 * np.pi) * sigma * epsilon)))
    size = int(2 * half_size + 1)
    i = np.arange(size)[:, None] - half_size
    j = np.arange(size)[None, :] - half_size
    filter_x = gaussian(i, sigma) * dgaussian(j, sigma)
    filter_x = filter_x / np.sqrt((filter_x ** 2).sum())
    return filter_x, filter_x.T


def gauss_gradient(img, sigma):
    """Gaussian gradient magnitude, replicate borders."""
    filter_x, filter_y = gauss_filter(sigma)
    gx = ndimage.correlate(img, filter_x, mode="nearest")
    gy = ndimage.correlate(img, filter_y, mode="nearest")
    return np.sqrt(gx ** 2 + gy ** 2)


def _minmax(img):
    """cv2.normalize(img, _, 1.0, 0.0, NORM_MINMAX): onto [0, 1]; a constant
    image maps to 0."""
    lo, hi = img.min(), img.max()
    scale = 1.0 / (hi - lo) if hi - lo > np.finfo(np.float64).eps else 0.0
    return (img - lo) * scale


def gradient_error(alpha, trimap, pred_alpha, sigma=1.4):
    """Gradient error over the unknown region, in thousands."""
    _check(alpha, trimap, pred_alpha)
    a_grad = gauss_gradient(_minmax(alpha.astype(np.float64)), sigma).astype(np.float32)
    p_grad = gauss_gradient(_minmax(pred_alpha.astype(np.float64)), sigma).astype(np.float32)
    return float(((a_grad - p_grad) ** 2 * (trimap == 128)).sum() / 1000)


def connectivity(alpha, trimap, pred_alpha, step=0.1):
    """Connectivity error over the unknown region, in thousands: per
    threshold level, each pixel's distance to the largest 4-connected
    component of the thresholded intersection."""
    _check(alpha, trimap, pred_alpha)
    alpha = alpha.astype(np.float32) / 255
    pred_alpha = pred_alpha.astype(np.float32) / 255

    thresh_steps = np.arange(0, 1 + step, step)
    round_down_map = -np.ones_like(alpha)
    for i in range(1, len(thresh_steps)):
        intersection = (alpha >= thresh_steps[i]) & (pred_alpha >= thresh_steps[i])
        labels, n = ndimage.label(intersection)
        omega = np.zeros_like(alpha)
        if n:
            size = np.bincount(labels.ravel(), minlength=n + 1)[1:]
            omega[labels == np.argmax(size) + 1] = 1
        mask = (round_down_map == -1) & (omega == 0)
        round_down_map[mask] = thresh_steps[i - 1]
    round_down_map[round_down_map == -1] = 1

    alpha_diff = alpha - round_down_map
    pred_diff = pred_alpha - round_down_map
    alpha_phi = 1 - alpha_diff * (alpha_diff >= 0.15)
    pred_phi = 1 - pred_diff * (pred_diff >= 0.15)
    return float(np.sum(np.abs(alpha_phi - pred_phi) * (trimap == 128)) / 1000)
