"""Evaluation metrics on host numpy: PSNR, SSIM and the MATLAB YCbCr.

Port of ``vmg_tpu/eval/metrics.py`` (the reference's ``utils/metrics.py``
with the skimage conventions of ``tools/test_reds4.py``), without cv2:
SSIM keeps only the valid region ``[5:-5, 5:-5]`` of cv2's ``filter2D``
with the 11-tap, sigma 1.5 Gaussian window, so a valid-region float64
correlation with that window is the whole function and the border mode
never enters.  The window is separable; the two 1-D passes differ from
the 2-D filter by float64 rounding only.
"""

from __future__ import annotations

import math

import numpy as np


def calculate_psnr(img1: np.ndarray, img2: np.ndarray, border: int = 0) -> float:
    """PSNR on [0, 255] arrays with optional border crop."""
    if img1.shape != img2.shape:
        raise ValueError("Input images must have the same dimensions.")
    h, w = img1.shape[:2]
    img1 = img1[border: h - border or None, border: w - border or None]
    img2 = img2[border: h - border or None, border: w - border or None]
    mse = np.mean((img1.astype(np.float64) - img2.astype(np.float64)) ** 2)
    if mse == 0:
        return float("inf")
    return 20 * math.log10(255.0 / math.sqrt(mse))


def psnr_float01(img_test: np.ndarray, img_true: np.ndarray) -> float:
    """skimage's peak_signal_noise_ratio on float [0, 1] (data_range 1), as
    the oracle clip selector uses it."""
    err = np.mean((img_test.astype(np.float64) - img_true.astype(np.float64)) ** 2)
    if err == 0:
        return float("inf")
    return 10 * math.log10(1.0 / err)


def psnr_exceed_check(psnr: float) -> float:
    """Cap an infinite PSNR as the reference does."""
    if psnr >= float("inf"):
        return float(10 * np.log10(255.0 ** 2 / 0.65025))
    return float(psnr)


def gaussian_taps(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    """cv2.getGaussianKernel(size, sigma) for sigma > 0: exp(-(i - c)^2 /
    (2 sigma^2)), normalised to sum 1, in float64."""
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2
    g = np.exp(-(x * x) / (2 * sigma * sigma))
    return g / g.sum()


def _valid_filter(img: np.ndarray, taps: np.ndarray) -> np.ndarray:
    """Correlation of a 2-D float64 image with the outer product of taps,
    over the positions where the window lies inside the image."""
    k = taps.size
    h, w = img.shape
    rows = sum(taps[i] * img[i: h - k + 1 + i] for i in range(k))
    return sum(taps[j] * rows[:, j: w - k + 1 + j] for j in range(k))


def _ssim_single(img1: np.ndarray, img2: np.ndarray) -> float:
    C1 = (0.01 * 255) ** 2
    C2 = (0.03 * 255) ** 2
    img1 = img1.astype(np.float64)
    img2 = img2.astype(np.float64)
    g = gaussian_taps()
    mu1 = _valid_filter(img1, g)
    mu2 = _valid_filter(img2, g)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 ** 2, mu2 ** 2, mu1 * mu2
    sigma1_sq = _valid_filter(img1 ** 2, g) - mu1_sq
    sigma2_sq = _valid_filter(img2 ** 2, g) - mu2_sq
    sigma12 = _valid_filter(img1 * img2, g) - mu1_mu2
    ssim_map = ((2 * mu1_mu2 + C1) * (2 * sigma12 + C2)) / (
        (mu1_sq + mu2_sq + C1) * (sigma1_sq + sigma2_sq + C2))
    return float(ssim_map.mean())


def structural_similarity(img1: np.ndarray, img2: np.ndarray) -> float:
    """SSIM on [0, 255]; the per-channel mean for colour images."""
    if img1.shape != img2.shape:
        raise ValueError("Input images must have the same dimensions.")
    if img1.ndim == 3:
        return float(np.mean([_ssim_single(img1[..., i], img2[..., i])
                              for i in range(img1.shape[2])]))
    return _ssim_single(img1, img2)


def rgb2ycbcr_matlab(img: np.ndarray) -> np.ndarray:
    """MATLAB's (skimage's) rgb2ycbcr: uint8 RGB -> float YCbCr, Y in
    [16, 235]."""
    x = img.astype(np.float64)
    if img.dtype == np.uint8:
        x = x / 255.0
    y = x @ np.asarray([[65.481, -37.797, 112.0],
                        [128.553, -74.203, -93.786],
                        [24.966, 112.0, -18.214]])
    y += np.asarray([16.0, 128.0, 128.0])
    return y
