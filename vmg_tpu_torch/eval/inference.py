"""Sliding-window inference (port of ``vmg_tpu/eval/inference.py``, the
reference Tester's protocol), line for line on host numpy.

Model-agnostic: drives any ``forward_fn(clip) -> sr_clip`` with the
contract of :class:`vmg_tpu_torch.serve.SRServer` (numpy float32 ``(1, T,
h, w, 3)`` RGB in [0, 1] -> ``(1, T, 4h, 4w, 3)``) through

  * spatial tiled inference with overlap-discard blending (``test_image``),
  * temporal sliding clips with overlap trimming (``test_clips``),
  * the REDS oracle: per-frame best-PSNR clip selection against GT
    (``test_clips_max``), which the published REDS4 numbers use,
  * FPS timing on the first clip (``evaluate_fps``).

``device_tiled_fn`` (:mod:`vmg_tpu_torch.eval.device_tiled`) replaces the
host tile loop with one that keeps the clip and the sums on the card.
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional, Sequence

import numpy as np

from vmg_tpu_torch.eval.metrics import psnr_exceed_check, psnr_float01


class SlidingEvaluator:
    def __init__(
        self,
        forward_fn: Callable[[np.ndarray], np.ndarray],
        scale: int = 4,
        test_num_frames: int = 50,
        overlapped_mode: str | int = "mid",
        spatial_wins: Optional[Sequence[int]] = (128, 128),
        overlapped_spatial_length: Optional[int] = 20,
        dataset_name: str = "REDS",
        data_enhance: bool = False,
        tta_hflip: bool = True,
        tta_vflip: bool = True,
        tta_rot: bool = False,
        device_tiled_fn: Optional[Callable] = None,
    ):
        self.forward_fn = forward_fn
        self.scale = scale
        self.test_num_frames = test_num_frames
        if overlapped_mode == "small":
            self.overlapped_num_frames = 2
        elif overlapped_mode == "mid":
            self.overlapped_num_frames = test_num_frames // 2
        elif overlapped_mode == "large":
            self.overlapped_num_frames = test_num_frames - 1
        elif not isinstance(overlapped_mode, str):
            self.overlapped_num_frames = int(overlapped_mode)
        else:
            raise ValueError(f"bad overlapped_mode {overlapped_mode!r}")
        self.spatial_wins = tuple(spatial_wins) if spatial_wins else None
        self.overlapped_spatial_length = overlapped_spatial_length
        self.dataset_name = dataset_name
        self.data_enhance = data_enhance
        self.tta = (tta_hflip, tta_vflip, tta_rot)
        # optional whole-frame tiled forward whose tile loop runs on the
        # card (vmg_tpu_torch.eval.device_tiled); replaces the host tile
        # loop when provided
        self.device_tiled_fn = device_tiled_fn
        self.t_idx_list: List[int] = []

    # -- TTA (reference Tester.py:387-445; the flip/transpose transforms
    #    are involutions, so augment == augment_inverse) ----------------

    def augment(self, clip: np.ndarray) -> np.ndarray:
        """clip: (B, T, H, W, C)."""
        hflip, vflip, rot90 = self.tta
        if hflip:
            clip = clip[:, :, :, ::-1]
        if vflip:
            clip = clip[:, :, ::-1]
        if rot90:
            clip = clip.transpose(0, 1, 3, 2, 4)
        return np.ascontiguousarray(clip)

    augment_inverse = augment

    # -- spatial tiling ------------------------------------------------

    def test_image(self, inputs: np.ndarray) -> np.ndarray:
        """inputs: (1, T, H, W, C) float32 -> (1, T, sH, sW, C)."""
        B, T, H, W, C = inputs.shape
        win_h, win_w = self.spatial_wins
        ov = self.overlapped_spatial_length
        s = self.scale
        stride_h, stride_w = win_h - ov, win_w - ov
        h_idx_list = list(range(0, H - win_h, stride_h)) + [max(0, H - win_h)]
        w_idx_list = list(range(0, W - win_w, stride_w)) + [max(0, W - win_w)]
        E = np.zeros((B, T, H * s, W * s, C), np.float32)
        Wacc = np.zeros_like(E)

        for h_idx in h_idx_list:
            for w_idx in w_idx_list:
                patch = inputs[:, :, h_idx : h_idx + win_h, w_idx : w_idx + win_w]
                out = np.asarray(self.forward_fn(patch), np.float32).copy()
                mask = np.ones_like(out)
                # NOTE: the reference trims ov//2 pixels of the *SR-space*
                # patch (Tester.py:128-139), i.e. only ov//(2*scale) LR
                # pixels -- reproduced exactly
                t = ov // 2
                if h_idx < h_idx_list[-1]:
                    out[:, :, -t:, :] = 0
                    mask[:, :, -t:, :] = 0
                if w_idx < w_idx_list[-1]:
                    out[:, :, :, -t:] = 0
                    mask[:, :, :, -t:] = 0
                if h_idx > h_idx_list[0]:
                    out[:, :, :t, :] = 0
                    mask[:, :, :t, :] = 0
                if w_idx > w_idx_list[0]:
                    out[:, :, :, :t] = 0
                    mask[:, :, :, :t] = 0
                E[:, :, h_idx * s : (h_idx + win_h) * s,
                  w_idx * s : (w_idx + win_w) * s] += out
                Wacc[:, :, h_idx * s : (h_idx + win_h) * s,
                     w_idx * s : (w_idx + win_w) * s] += mask
        return E / Wacc

    def _run_clip(self, clip: np.ndarray) -> np.ndarray:
        if self.overlapped_spatial_length is None or self.spatial_wins is None:
            return np.asarray(self.forward_fn(clip), np.float32)
        if self.device_tiled_fn is not None:
            return np.asarray(self.device_tiled_fn(clip), np.float32)
        return self.test_image(clip)

    # -- temporal sliding ----------------------------------------------

    def _clip_starts(self, T: int) -> List[int]:
        stride = self.test_num_frames - self.overlapped_num_frames
        if stride <= 0:
            raise ValueError(
                f"overlap {self.overlapped_num_frames} leaves no stride for "
                f"clips of {self.test_num_frames} frames; reduce "
                f"overlapped_mode"
            )
        return list(range(0, T - self.test_num_frames, stride)) + [
            max(0, T - self.test_num_frames)
        ]

    def test_clips(self, inputs: np.ndarray) -> np.ndarray:
        B, T, H, W, C = inputs.shape
        s = self.scale
        tn = self.test_num_frames
        ov = self.overlapped_num_frames
        not_overlap_border = ov > 0
        E = np.zeros((B, T, H * s, W * s, C), np.float32)
        N = np.zeros((B, T, 1, 1, 1), np.float32)
        self.t_idx_list = self._clip_starts(T)

        for t_idx in self.t_idx_list:
            clip = inputs[:, t_idx : t_idx + tn]
            out = self._run_clip(clip).copy()
            n = np.ones((B, tn, 1, 1, 1), np.float32)
            if not_overlap_border:
                if t_idx < self.t_idx_list[-1]:
                    out[:, -(ov // 2):] = 0
                    n[:, -(ov // 2):] = 0
                if t_idx > self.t_idx_list[0]:
                    out[:, : ov // 2] = 0
                    n[:, : ov // 2] = 0
            E[:, t_idx : t_idx + tn] += out
            N[:, t_idx : t_idx + tn] += n
        return E / N

    def test_clips_max(self, inputs: np.ndarray, HR: np.ndarray) -> np.ndarray:
        """Oracle per-frame clip selection against GT (REDS protocol)."""
        B, T, H, W, C = inputs.shape
        tn = self.test_num_frames
        self.t_idx_list = self._clip_starts(T)
        n_clips = len(self.t_idx_list)
        outs = []
        psnrs = np.full((T, n_clips), -np.inf, np.float64)

        for idx, t_idx in enumerate(self.t_idx_list):
            clip = inputs[:, t_idx : t_idx + tn]
            out = self._run_clip(clip)
            outs.append(out)
            hr = HR[:, t_idx : t_idx + tn]
            for i in range(tn):
                test = np.clip(out[0, i], 0, 1)
                true = np.clip(hr[0, i], 0, 1)
                psnrs[t_idx + i, idx] = psnr_exceed_check(psnr_float01(test, true))

        best = psnrs.argmax(axis=1)  # (T,)
        s = self.scale
        result = np.zeros((B, T, H * s, W * s, C), np.float32)
        for f in range(T):
            idx = int(best[f])
            t_idx = self.t_idx_list[idx]
            if t_idx <= f < t_idx + tn:
                result[:, f] = outs[idx][:, f - t_idx]
        return result

    # -- top-level -----------------------------------------------------

    def evaluate(self, inputs_uint8: np.ndarray,
                 HR_uint8: Optional[np.ndarray] = None) -> np.ndarray:
        """inputs: (T, H, W, 3) uint8 RGB -> (T, sH, sW, 3) uint8."""
        x = inputs_uint8.astype(np.float32)[None] / 255.0
        if self.data_enhance:
            x = self.augment(x)
        if self.dataset_name == "Vimeo90k_septuplet":
            out = self._run_clip(x)
        elif self.dataset_name == "REDS":
            hr = HR_uint8.astype(np.float32)[None] / 255.0
            if self.data_enhance:
                hr = self.augment(hr)
            out = self.test_clips_max(x, hr)
        else:
            out = self.test_clips(x)
        if self.data_enhance:
            out = self.augment_inverse(out)
        out = np.clip(out[0], 0.0, 1.0)
        return np.round(out * 255.0).astype(np.uint8)

    def evaluate_fps(self, inputs_uint8: np.ndarray,
                     HR_uint8: Optional[np.ndarray] = None):
        """Returns (outputs_uint8, fps) with the reference's timing protocol:
        on REDS, time one extra forward of the first test_num_frames clip."""
        outputs = self.evaluate(inputs_uint8, HR_uint8)
        clip = inputs_uint8[: self.test_num_frames].astype(np.float32)[None] / 255.0
        # a warm-up forward out of the timed region
        _ = self._run_clip(clip)
        begin = time.time()
        out = self._run_clip(clip)
        np.asarray(out)  # forces completion (host transfer)
        elapsed = time.time() - begin
        n = self.test_num_frames
        if self.dataset_name not in ("REDS", "Vimeo90k_septuplet"):
            n = self.test_num_frames * len(self.t_idx_list or [1])
        return outputs, float(n / elapsed)
