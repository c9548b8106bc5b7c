"""NIQE, the no-reference quality metric (``vmg_tpu/eval/niqe.py``; the
reference's ``mmedit/core/evaluation/metrics.py:470`` with its
``niqe_pris_params.npz``).

MSCN coefficients, per-patch GGD / AGGD features at two scales, and the
Mahalanobis-like distance of their Gaussian to the pretrained Gaussian of
natural-scene statistics.  numpy and scipy, without cv2 (the card's
machine has none): cv2's ``filter2D`` with ``BORDER_REPLICATE`` is
``scipy.ndimage.correlate`` with ``mode='nearest'`` (a correlation, not a
convolution), and its bilinear resize to exactly half size is the 2x2
mean.  The statistics file is an argument: the repo ships none.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np
from scipy.ndimage import correlate
from scipy.special import gamma as _gamma

_GAM_RANGE = np.arange(0.2, 10.001, 0.001)
_GAM_RECIP = 1.0 / _GAM_RANGE
_R_GAM = _gamma(_GAM_RECIP) * _gamma(3 * _GAM_RECIP) / (_gamma(2 * _GAM_RECIP) ** 2)


def load_pris(path: str):
    """(mu_pris, cov_pris, gaussian_window) from a ``niqe_pris_params.npz``."""
    if not path or not os.path.exists(path):
        raise FileNotFoundError(f"NIQE: no natural-scene statistics at {path!r}; pass the path "
                                "of a niqe_pris_params.npz (mu_pris_param, cov_pris_param, "
                                "gaussian_window)")
    data = np.load(path)
    return data["mu_pris_param"].ravel(), data["cov_pris_param"], data["gaussian_window"]


def _estimate_aggd(block: np.ndarray) -> Tuple[float, float, float]:
    """Asymmetric GGD parameters (alpha, beta_l, beta_r)."""
    block = block.flatten()
    left, right = block[block < 0], block[block > 0]
    left_std = np.sqrt(np.mean(left ** 2)) if left.size else 0.0
    right_std = np.sqrt(np.mean(right ** 2)) if right.size else 0.0
    gammahat = left_std / right_std if right_std > 0 else np.inf
    sq = np.mean(block ** 2)
    rhat = (np.mean(np.abs(block)) ** 2) / sq if sq > 0 else 0.0
    rhatnorm = (rhat * (gammahat ** 3 + 1) * (gammahat + 1)
                / ((gammahat ** 2 + 1) ** 2)) if np.isfinite(gammahat) else 0.0
    alpha = _GAM_RANGE[np.argmin((_R_GAM - rhatnorm) ** 2)]
    g1, g3 = float(_gamma(1 / alpha)), float(_gamma(3 / alpha))
    return float(alpha), left_std * np.sqrt(g1 / g3), right_std * np.sqrt(g1 / g3)


def _block_features(mscn: np.ndarray) -> list:
    alpha, bl, br = _estimate_aggd(mscn)
    feats = [alpha, (bl + br) / 2]
    for shift in [(0, 1), (1, 0), (1, 1), (1, -1)]:
        alpha, bl, br = _estimate_aggd(mscn * np.roll(mscn, shift, axis=(0, 1)))
        feats.extend([alpha, (br - bl) * (_gamma(2 / alpha) / _gamma(1 / alpha)), bl, br])
    return feats


def niqe(img: np.ndarray, pris_params_path: str, crop_border: int = 0,
         block_size: int = 96) -> float:
    """NIQE of a grayscale or RGB image in [0, 255] (lower is better), with
    the statistics of ``pris_params_path``."""
    mu_pris, cov_pris, window = load_pris(pris_params_path)
    if img.ndim == 3:
        img = 0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2]
    img = img.astype(np.float64)
    if crop_border:
        img = img[crop_border:-crop_border, crop_border:-crop_border]
    h, w = img.shape
    nbh, nbw = h // block_size, w // block_size
    img = img[:nbh * block_size, :nbw * block_size]

    feats_all = []
    for scale in (1, 2):
        mu = correlate(img, window, mode="nearest")
        sigma = np.sqrt(np.abs(correlate(img ** 2, window, mode="nearest") - mu ** 2))
        mscn = (img - mu) / (sigma + 1.0)
        bs = block_size // scale
        feats_all.append(np.asarray([_block_features(mscn[bi * bs:(bi + 1) * bs,
                                                          bj * bs:(bj + 1) * bs])
                                     for bi in range(nbh) for bj in range(nbw)]))
        if scale == 1:  # half size, bilinear: each output pixel the mean of a 2x2 block
            hh, ww = img.shape[0] // 2, img.shape[1] // 2
            img = img[:2 * hh, :2 * ww].reshape(hh, 2, ww, 2).mean(axis=(1, 3))
    feats = np.concatenate(feats_all, axis=1)

    mu_dist = np.nanmean(feats, axis=0)
    good = feats[~np.isnan(feats).any(axis=1)]
    cov_dist = np.cov(good, rowvar=False)
    pinv = np.linalg.pinv((cov_pris + cov_dist) / 2)
    d = mu_pris - mu_dist
    return float(np.sqrt(d @ pinv @ d))
