"""Evaluation command line, the counterpart of ``tools/eval.py``:

    python -m vmg_tpu_torch.eval --preset vid4 --checkpoint VMG.pth \\
        [--lr-root DIR] [--gt-root DIR] [--max-clips N] [--topk K] \\
        [--device-tiles] [--fast-gelu] [--output-dir DIR] [--device cpu]

``--preset`` names one of the JAX package's evaluation configs
(``configs.EVAL_PRESETS``; there is no YAML loader on the card).
``--checkpoint``: a reference ``.pth``, a directory of the port's trainer
checkpoints, or ``random`` (seed-0 weights).  Runs on the card unless
``--device cpu``; without a card it raises.
"""

from __future__ import annotations

import argparse
import copy
import sys

from vmg_tpu_torch.configs import EVAL_PRESETS
from vmg_tpu_torch.eval import run_eval


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="VMG evaluation (PSNR / SSIM / FPS)")
    p.add_argument("--preset", required=True, choices=sorted(EVAL_PRESETS))
    p.add_argument("--checkpoint", default=None,
                   help="reference .pth, port checkpoint directory, or 'random'")
    p.add_argument("--lr-root", default=None, help="override the LR root")
    p.add_argument("--gt-root", default=None, help="override the GT root")
    p.add_argument("--max-clips", type=int, default=None)
    p.add_argument("--topk", type=int, default=None, help="report the k best clips by PSNR")
    p.add_argument("--device-tiles", action="store_true",
                   help="run the spatial tile loop on the device (one upload, one download)")
    p.add_argument("--fast-gelu", action="store_true", help="tanh-approximate GELU")
    p.add_argument("--output-dir", default=None, help="override the PNG and log directory")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    cfg = copy.deepcopy(EVAL_PRESETS[args.preset])
    if args.output_dir:
        cfg.path.output_dir = args.output_dir
    run_eval(cfg, checkpoint=args.checkpoint, lr_root=args.lr_root, gt_root=args.gt_root,
             max_clips=args.max_clips, topk=args.topk, device_tiles=args.device_tiles,
             fast_gelu=args.fast_gelu, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
