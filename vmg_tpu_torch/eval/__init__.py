"""Evaluation: the reference Tester's protocols over the port's model.

:func:`run_eval` is ``tools/eval.py``'s ``main()`` as a function of the
configuration objects, the roots and the checkpoint (``python -m
vmg_tpu_torch.eval`` is its command line).  It walks the LR tree clip by
clip, runs the sliding / tiled / oracle protocol of
:class:`SlidingEvaluator`, scores every frame against GT (PSNR, PSNR-Y,
SSIM, SSIM-Y), writes the output PNGs and logs per-frame, per-clip and
dataset lines and the FPS; it returns the same numbers.  The model runs
on the card unless ``device="cpu"``; float32 with the exact (erf) GELU
by default, ``fast_gelu`` for tanh, as the JAX command line.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from vmg_tpu_torch.eval.eval_utils import index_generation, read_seq_images
from vmg_tpu_torch.eval.inference import SlidingEvaluator
from vmg_tpu_torch.eval.metrics import calculate_psnr, rgb2ycbcr_matlab, structural_similarity
from vmg_tpu_torch.eval.png import write_png


def gt_root_for(cfg, lr_root: str, gt_root: Optional[str] = None) -> str:
    """The GT root: given, in the config, or by the experiment's name as the
    reference tester derives it (Vimeo: drop "_LR"; REDS: the sharp tree;
    Vid4 / UDM10: ``<root>/LR/X4`` -> ``<root>/GT``)."""
    if gt_root or cfg.dataset.gt_root:
        return gt_root or cfg.dataset.gt_root
    if "Vimeo" in cfg.name:
        return lr_root.replace("_LR", "")
    if "RED" in cfg.name:
        return lr_root.replace("train_sharp_bicubic", "train_sharp")
    return lr_root.replace("LR/X4", "GT")


def find_clips(root: str):
    """One- or two-level clip trees (REDS4: ``000/``; Vimeo: ``00001/0001/``)."""
    out = []
    for d in sorted(os.listdir(root)):
        p = os.path.join(root, d)
        if not os.path.isdir(p):
            continue
        subs = [s for s in sorted(os.listdir(p)) if os.path.isdir(os.path.join(p, s))]
        if subs:
            out.extend(os.path.join(d, s) for s in subs)
        else:
            out.append(d)
    return out


def load_model(cfg, checkpoint: Optional[str], device="cuda", fast_gelu: bool = False,
               logger=None):
    """The float32 eval model on ``device`` with the weights of
    ``checkpoint``: a reference ``.pth``/``.pt`` file (its container per
    ``cfg.eval.checkpoint_from``), a directory of the port's trainer
    checkpoints (the latest step), or ``"random"``/None (seed 0)."""
    import torch

    from vmg_tpu_torch.ckpt import load_reference_checkpoint, reference_state_dict
    from vmg_tpu_torch.ckpt.io import restore_checkpoint
    from vmg_tpu_torch.models.vmg import create_model

    strict = cfg.path.strict_load
    gelu = "tanh" if fast_gelu else "erf"
    if checkpoint is None or checkpoint == "random":
        if logger is not None:
            logger.warning("using RANDOM weights (smoke run)")
        return create_model(cfg.network, is_train=False, device=device, gelu=gelu,
                            generator=torch.Generator().manual_seed(0))
    model = create_model(cfg.network, is_train=False, device=device, gelu=gelu)
    if checkpoint.endswith((".pth", ".pt")):
        sd = reference_state_dict(load_reference_checkpoint(checkpoint, cfg.eval.checkpoint_from),
                                  strict=strict)
    else:
        state = restore_checkpoint(checkpoint)
        sd = state["params"] if "params" in state else state
    model.load_state_dict(sd, strict=strict)
    return model


def make_forwards(model, cfg, device_tiles: bool = False):
    """(forward_fn, device_tiled_fn) over ``model`` for
    :class:`SlidingEvaluator`: numpy clips in and out, the clip mirrored
    where the protocol says; the device-tiled one (or None) runs the tile
    loop on the model's device."""
    import torch

    from vmg_tpu_torch.eval.device_tiled import make_device_tiled_forward

    dev = next(model.parameters()).device
    mirrors = cfg.dataset.use_mirrors

    @torch.inference_mode()
    def apply(x):
        T = x.shape[1]
        if mirrors:  # the model reuses the flipped forward flow backward
            x = torch.cat([x, x.flip(1)], dim=1)
        return model(x, frames_mirror=mirrors)[:, :T]

    def forward_fn(clip):
        return apply(torch.from_numpy(np.ascontiguousarray(clip)).to(dev)).cpu().numpy()

    if not (device_tiles and cfg.dataset.wins):
        return forward_fn, None
    lr_hw = (cfg.dataset.image_shape[1] // cfg.scale, cfg.dataset.image_shape[2] // cfg.scale)
    tiled = make_device_tiled_forward(apply, cfg.scale, tuple(cfg.dataset.wins),
                                      cfg.dataset.overlapped_spatial_length, lr_hw)

    @torch.inference_mode()
    def device_tiled_fn(clip):
        return tiled(torch.from_numpy(np.ascontiguousarray(clip)).to(dev)).cpu().numpy()

    return forward_fn, device_tiled_fn


def flops_line(cfg) -> str:
    """``dataset.FLOPs``' log line (``tools/eval.py:67-78``): the forward
    FLOPs of the network on one clip of ``flops_num_frames`` LR frames of
    ``image_shape``, counted on fake tensors of a model on the meta device
    (nothing is computed or allocated; ``eval/flops.py``: convolutions and
    matrix products, 2 x the multiply-adds)."""
    import torch

    from vmg_tpu_torch.eval.flops import model_flops
    from vmg_tpu_torch.models.vmg import create_model

    h, w = cfg.dataset.image_shape[1] // cfg.scale, cfg.dataset.image_shape[2] // cfg.scale
    T = cfg.dataset.flops_num_frames
    model = create_model(cfg.network, device="meta")
    x = torch.zeros((1, T, h, w, 3), device="meta")
    return f"FLOPs = {model_flops(model, x) / 1e9:.2f} G on (1, {T}, {h}, {w}, 3)"


def run_eval(cfg, *, checkpoint: Optional[str] = None, lr_root: Optional[str] = None,
             gt_root: Optional[str] = None, max_clips: Optional[int] = None,
             topk: Optional[int] = None, device_tiles: bool = False, fast_gelu: bool = False,
             device="cuda", model=None) -> dict:
    """Evaluate on the LR / GT trees; returns {"frames": [(clip, frame,
    psnr, psnr_y, ssim, ssim_y)], "clips": {clip: (psnr, psnr_y, ssim,
    ssim_y)}, "dataset": (psnr, psnr_y, ssim, ssim_y, fps), "topk": [(clip,
    psnr)]}.  ``model``: an eval model to use instead of loading one."""
    from vmg_tpu_torch.utils.logging_utils import AverageMeter, setup_logger

    logger = setup_logger("vmg_tpu_torch.eval", cfg.path.output_dir, "eval")
    if cfg.dataset.FLOPs:
        logger.info(flops_line(cfg))
    lr_root = lr_root or cfg.dataset.dataset_root
    if not lr_root:
        raise ValueError("no LR root: set dataset.dataset_root in the config or pass lr_root")
    gt_root = gt_root_for(cfg, lr_root, gt_root)
    if model is None:
        model = load_model(cfg, checkpoint, device, fast_gelu, logger)
    forward_fn, device_tiled_fn = make_forwards(model, cfg, device_tiles)
    evaluator = SlidingEvaluator(
        forward_fn, scale=cfg.scale, test_num_frames=cfg.dataset.num_frames,
        overlapped_mode=cfg.dataset.overlapped_mode, spatial_wins=cfg.dataset.wins,
        overlapped_spatial_length=cfg.dataset.overlapped_spatial_length,
        dataset_name="REDS" if cfg.dataset.name in ("REDS", "REDS4") else cfg.dataset.name,
        device_tiled_fn=device_tiled_fn)

    clips = find_clips(lr_root)
    if max_clips:
        clips = clips[:max_clips]
    ds = [AverageMeter() for _ in range(4)]
    ds_fps = AverageMeter()
    frames, clip_scores, per_clip = [], [], {}
    for clip in clips:
        lr_imgs = read_seq_images(os.path.join(lr_root, clip))
        gt_imgs = read_seq_images(os.path.join(gt_root, clip))
        n_gt = gt_imgs.shape[0]
        windows = index_generation(min(cfg.dataset.num_out_frames, n_gt), n_gt)
        meters = [AverageMeter() for _ in range(4)]
        tested = set()
        save_dir = os.path.join(cfg.path.output_dir, clip)
        os.makedirs(save_dir, exist_ok=True)
        for indices in windows:
            sel = np.asarray(indices)
            out, fps = evaluator.evaluate_fps(lr_imgs[sel], gt_imgs[sel])
            ds_fps.update(fps)
            for i, frame_idx in enumerate(indices):
                if frame_idx in tested:
                    continue
                tested.add(frame_idx)
                if cfg.dataset.eval_mid_clip:
                    # Vimeo: score only the centre frame (or the two mirror centres)
                    if cfg.dataset.use_mirrors:
                        if i not in (3, 10):
                            continue
                    elif i != len(indices) // 2:
                        continue
                output, target = out[i], gt_imgs[frame_idx]
                oy = rgb2ycbcr_matlab(output)[..., 0]
                ty = rgb2ycbcr_matlab(target)[..., 0]
                scores = (calculate_psnr(output, target), calculate_psnr(oy, ty),
                          structural_similarity(output, target), structural_similarity(oy, ty))
                for m, v in zip(meters, scores):
                    m.update(v)
                write_png(os.path.join(save_dir, f"{cfg.name}-{frame_idx + 1:08d}.png"), output)
                frames.append((clip, frame_idx, *scores))
                logger.info(f"{clip} {frame_idx + 1:3d} - PSNR {scores[0]:.4f} "
                            f"PSNR-Y {scores[1]:.4f} SSIM {scores[2]:.5f} SSIM-Y {scores[3]:.5f}")
        avg = tuple(m.average() for m in meters)
        logger.info(f"[clip {clip}] PSNR {avg[0]:.4f} PSNR-Y {avg[1]:.4f} SSIM {avg[2]:.5f} "
                    f"SSIM-Y {avg[3]:.5f}")
        for m, v in zip(ds, avg):
            m.update(v)
        per_clip[clip] = avg
        clip_scores.append((clip, avg[0]))
    best = sorted(clip_scores, key=lambda kv: -kv[1])[:topk] if topk else []
    for rank, (clip, p) in enumerate(best, 1):
        logger.info(f"[top-{rank}] {clip}: PSNR {p:.4f}")
    dataset = tuple(m.average() for m in ds) + (ds_fps.average(),)
    logger.info(f"[dataset] PSNR {dataset[0]:.4f} PSNR-Y {dataset[1]:.4f} SSIM {dataset[2]:.5f} "
                f"SSIM-Y {dataset[3]:.5f} FPS {dataset[4]:.3f}")
    return {"frames": frames, "clips": per_clip, "dataset": dataset, "topk": best}
