"""Dataset preparation command line, the counterpart of
``tools/prepare_data.py`` (reference ``datasets/`` scripts): packed trees
from PNG frame trees, the x4 LR side by MATLAB's antialiased bicubic
(``ops.resize.imresize_matlab``, on the card unless ``--device cpu``),
clip-key pickles, the Vimeo-90K split and the annotation files.

    # REDS (clip/frame.png tree)
    python -m vmg_tpu_torch.tools.prepare_data pack   --src /REDS/train_sharp --dst hr.pack
    python -m vmg_tpu_torch.tools.prepare_data gen-lr --src /REDS/train_sharp --dst lr.pack
    python -m vmg_tpu_torch.tools.prepare_data keys   --src hr.pack --dst REDS_keys.pkl

    # Vimeo-90K septuplets (sequences/a/b/im1..im7.png)
    python -m vmg_tpu_torch.tools.prepare_data sep-vimeo --src .../sequences \\
        --list .../sep_trainlist.txt --dst .../sequences/train
    python -m vmg_tpu_torch.tools.prepare_data pack --src .../sequences/train \\
        --dst vimeo_hr.pack --layout vimeo
    python -m vmg_tpu_torch.tools.prepare_data ann --dataset vimeo \\
        --list sep_trainlist.txt --dst meta_info_Vimeo90K_GT.txt
    python -m vmg_tpu_torch.tools.prepare_data ann --dataset reds --dst meta_info_REDS_GT.txt

The packed trees are the JAX package's format: either package reads them.
"""

from __future__ import annotations

import argparse
import glob
import os
import pickle
import shutil
import sys

import numpy as np
import torch

from vmg_tpu_torch.data.storage import PackedBackend, PackedWriter
from vmg_tpu_torch.eval.eval_utils import read_image
from vmg_tpu_torch.ops.resize import imresize_matlab


def _iter_frames(src, layout: str = "clips"):
    """Yield (clip_key, frame_id, path).  ``clips``: clip/NNNNN.png, frame
    ids 0, 1, ... in name order (REDS); ``vimeo``: a/b/im{1..7}.png, frame
    ids from the names, clip key 'a/b'."""
    if layout == "vimeo":
        for a in sorted(os.listdir(src)):
            pa = os.path.join(src, a)
            if not os.path.isdir(pa):
                continue
            for b in sorted(os.listdir(pa)):
                pb = os.path.join(pa, b)
                if not os.path.isdir(pb):
                    continue
                for path in sorted(glob.glob(os.path.join(pb, "im*.png"))):
                    yield f"{a}/{b}", int(os.path.basename(path)[2:-4]), path
        return
    for clip in sorted(d for d in os.listdir(src) if os.path.isdir(os.path.join(src, d))):
        for fi, path in enumerate(sorted(glob.glob(os.path.join(src, clip, "*.png")))):
            yield clip, fi, path


def _device(name: str) -> torch.device:
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device visible; pass --device cpu to resize on the CPU")
    return dev


def cmd_pack(args):
    writer = first = None
    for clip, fi, path in _iter_frames(args.src, args.layout):
        img = read_image(path)
        if writer is None:
            first = img.shape
            writer = PackedWriter(args.dst, first)
        writer.add(f"{clip}_{fi}", img, clip_key=clip)
    if writer is None:
        raise SystemExit(f"no PNG frames under {args.src}")
    writer.close()
    print(f"packed -> {args.dst} ({first})")


def cmd_gen_lr(args):
    dev = _device(args.device)
    writer = None
    for clip, fi, path in _iter_frames(args.src, args.layout):
        hr = torch.from_numpy(read_image(path).astype(np.float32) / 255.0).to(dev)
        lr = imresize_matlab(hr, 1.0 / args.scale).cpu().numpy()
        lr = np.clip(np.round(lr * 255.0), 0, 255).astype(np.uint8)
        if writer is None:
            writer = PackedWriter(args.dst, lr.shape)
        writer.add(f"{clip}_{fi}", lr, clip_key=clip)
    if writer is None:
        raise SystemExit(f"no PNG frames under {args.src}")
    writer.close()
    print(f"LR packed -> {args.dst}")


def cmd_keys(args):
    be = PackedBackend(args.src)
    with open(args.dst, "wb") as f:
        pickle.dump({"keys": be.keys}, f)
    print(f"{len(be.keys)} clip keys -> {args.dst}")


def cmd_sep_vimeo(args):
    """Copy each a/b clip directory of the split list from --src to --dst
    (reference datasets/sep_vimeo.py:9-29)."""
    with open(args.list) as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    os.makedirs(args.dst, exist_ok=True)
    for line in lines:
        dst_dir = os.path.join(args.dst, line)
        if not os.path.isdir(dst_dir):
            shutil.copytree(os.path.join(args.src, line), dst_dir)
    print(f"{len(lines)} clips -> {args.dst}")


_REDS4_CLIPS = (0, 11, 15, 20)  # the REDS4 evaluation clips
# (reference mmedit/datasets/sr_reds_multiple_gt_dataset.py:46-49)


def cmd_ann(args):
    """Annotation files (reference datasets/create_ann.py): vimeo -> '<a/b>
    (256, 448, 3)' a split-list line; reds -> the 266 training clip ids
    (000..269 without REDS4)."""
    if args.dataset == "vimeo":
        if not args.list:
            raise SystemExit("--list required for --dataset vimeo")
        with open(args.list) as f:
            lines = [ln.strip() for ln in f if ln.strip()]
        with open(args.dst, "w") as f:
            for line in lines:
                f.write(f"{line} (256, 448, 3)\n")
        print(f"{len(lines)} entries -> {args.dst}")
    else:
        clips = [f"{i:03d}" for i in range(270) if i not in _REDS4_CLIPS]
        with open(args.dst, "w") as f:
            f.write("\n".join(clips) + "\n")
        print(f"{len(clips)} clips -> {args.dst}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="VMG dataset preparation")
    sub = p.add_subparsers(dest="cmd", required=True)
    for name, fn in (("pack", cmd_pack), ("gen-lr", cmd_gen_lr), ("keys", cmd_keys)):
        sp = sub.add_parser(name)
        sp.add_argument("--src", required=True)
        sp.add_argument("--dst", required=True)
        if name in ("pack", "gen-lr"):
            sp.add_argument("--layout", choices=("clips", "vimeo"), default="clips")
        if name == "gen-lr":
            sp.add_argument("--scale", type=int, default=4)
            sp.add_argument("--device", default="cuda", help="cuda (default) or cpu")
        sp.set_defaults(fn=fn)
    sp = sub.add_parser("sep-vimeo")
    sp.add_argument("--src", required=True)
    sp.add_argument("--list", required=True)
    sp.add_argument("--dst", required=True)
    sp.set_defaults(fn=cmd_sep_vimeo)
    sp = sub.add_parser("ann")
    sp.add_argument("--dataset", choices=("vimeo", "reds"), required=True)
    sp.add_argument("--list", default=None)
    sp.add_argument("--dst", required=True)
    sp.set_defaults(fn=cmd_ann)
    args = p.parse_args(argv)
    args.fn(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
