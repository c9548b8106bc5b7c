"""The port's evaluation command line against ``tools/eval.py``'s
``main()`` (split from ``tests/test_torch_eval.py``, whose helpers it uses).
"""

import dataclasses
import importlib
import os
import sys

import cv2
import numpy as np
import torch
import yaml

from vmg_tpu.eval import eval_utils as j_utils
from vmg_tpu.eval import metrics as j_metrics
from vmg_tpu_torch.configs import TINY_TEST_PRESET, DatasetConfig, ExperimentConfig, PathConfig
from vmg_tpu_torch.eval import run_eval

from test_torch_eval import FIXTURE, PRESETS, REPO, _two_threads, _write_tree  # noqa: F401


def test_eval_cli_matches_jax_cli(tmp_path, monkeypatch):
    T, h, w = 4, 80, 80  # 2 x 2 tiles of 64 a clip
    lr_root = _write_tree(str(tmp_path), T, h, w)
    net = {f.name: getattr(TINY_TEST_PRESET, f.name) for f in dataclasses.fields(TINY_TEST_PRESET)}
    net = {k: [list(x) if isinstance(x, tuple) else x for x in v] if isinstance(v, tuple) else v
           for k, v in net.items()}
    raw = yaml.safe_load(open(os.path.join(PRESETS, "vmg_eval_vid4.yml")))
    raw["network"] = net
    raw["dataset"].update(dataset_root=lr_root, gt_root=None, num_frames=T,
                          image_shape=[3, 4 * h, 4 * w], wins=[64, 64],
                          overlapped_spatial_length=20)
    raw["path"]["output_dir"] = str(tmp_path / "jax")
    cfg_path = str(tmp_path / "vid4_tiny.yml")
    yaml.safe_dump(raw, open(cfg_path, "w"))
    # the fixture holds float16 tensors, which the JAX command line passes to
    # its convolutions as they are (a dtype error there); it gets the same
    # file in float32 (exact), the port the committed file
    ck = torch.load(FIXTURE, map_location="cpu", weights_only=True)
    f32 = str(tmp_path / "ref_tiny_mine_f32.pth")
    torch.save({**ck, "state_dict": {k: v.float() for k, v in ck["state_dict"].items()}}, f32)
    sys.path.insert(0, os.path.join(REPO, "tools"))
    eval_mod = importlib.import_module("eval")
    monkeypatch.setattr(sys, "argv", ["eval.py", "--config", cfg_path, "--checkpoint", f32,
                                      "--topk", "1"])
    eval_mod.main()

    cfg = ExperimentConfig(
        name="VMG-Vid4", network=TINY_TEST_PRESET,
        dataset=DatasetConfig(name="Vid4", dataset_root=lr_root, num_frames=T,
                              num_out_frames=10000, image_shape=(3, 4 * h, 4 * w), wins=(64, 64),
                              overlapped_spatial_length=20),
        path=PathConfig(output_dir=str(tmp_path / "port")))
    res = run_eval(cfg, checkpoint=FIXTURE, topk=1, device="cpu")
    assert len(res["frames"]) == 2 * T and len(res["topk"]) == 1
    for clip, idx, psnr, psnr_y, ssim, ssim_y in res["frames"]:
        name = f"VMG-Vid4-{idx + 1:08d}.png"
        mine = cv2.imread(str(tmp_path / "port" / clip / name))[..., ::-1]
        ref = cv2.imread(str(tmp_path / "jax" / clip / name))[..., ::-1]
        assert mine.shape == (4 * h, 4 * w, 3)
        assert np.abs(mine.astype(int) - ref.astype(int)).max() <= 1
        gt = j_utils.read_image(os.path.join(lr_root.replace("LR/X4", "GT"), clip,
                                             f"{idx:08d}.png"))
        ry, gy = (j_metrics.rgb2ycbcr_matlab(v)[..., 0] for v in (ref, gt))
        assert abs(psnr - j_metrics.calculate_psnr(ref, gt)) <= 1e-3
        assert abs(psnr_y - j_metrics.calculate_psnr(ry, gy)) <= 1e-3
        assert abs(ssim - j_metrics.structural_similarity(ref, gt)) <= 1e-5
        assert abs(ssim_y - j_metrics.structural_similarity(ry, gy)) <= 1e-5
    assert all(np.isfinite(v) for v in res["dataset"])
