"""The port's data-preparation tools against the JAX package's
(``tools/prepare_data.py``, ``tools/make_demo_data.py``) on CPU, on a tiny
PNG tree written by cv2: ``pack``, ``keys``, ``sep-vimeo`` and ``ann``
give identical files; ``gen-lr`` and the demo tool's LR are within one
uint8 level (the JAX package resizes in XLA, the port in PyTorch); the
demo tool's HR is bit-equal.  The port's command lines run in-process
with ``--device cpu`` and raise without it when there is no card."""

import importlib.util
import os
import pickle
import sys
from argparse import Namespace

import cv2
import numpy as np
import pytest
import torch

from vmg_tpu_torch.data.storage import PackedBackend
from vmg_tpu_torch.eval.eval_utils import read_image
from vmg_tpu_torch.tools import make_demo_data, prepare_data

TOOLS = os.path.join(os.path.dirname(__file__), os.pardir, "tools")


@pytest.fixture(autouse=True)
def _few_torch_threads():
    """The suite runs in several worker processes at once; torch at full
    width in each of them oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", os.path.join(TOOLS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_prep():
    return _jax_tool("prepare_data")


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def png_trees(tmp_path_factory):
    """A REDS-layout tree (two clips of three 36x52 frames) and a Vimeo
    septuplet tree (a/b/im1..im7, 32x44), written by cv2."""
    root = tmp_path_factory.mktemp("png")
    rng = np.random.default_rng(0)
    for clip in ("000", "001"):
        os.makedirs(root / "reds" / clip)
        for i in range(3):
            cv2.imwrite(str(root / "reds" / clip / f"{i:08d}.png"),
                        rng.integers(0, 256, (36, 52, 3), dtype=np.uint8))
    for ab in ("00001/0001", "00001/0002", "00002/0007"):
        os.makedirs(root / "vimeo" / ab)
        for i in range(1, 8):
            cv2.imwrite(str(root / "vimeo" / ab / f"im{i}.png"),
                        rng.integers(0, 256, (32, 44, 3), dtype=np.uint8))
    with open(root / "sep_trainlist.txt", "w") as f:
        f.write("00001/0001\n00002/0007\n\n")
    return root


@pytest.mark.parametrize("layout", ["clips", "vimeo"])
def test_pack_and_keys_identical(jax_prep, png_trees, tmp_path, layout):
    src = str(png_trees / ("reds" if layout == "clips" else "vimeo"))
    for name, mod in (("jax", jax_prep), ("port", prepare_data)):
        mod.cmd_pack(Namespace(src=src, dst=str(tmp_path / name / "hr"), layout=layout))
        mod.cmd_keys(Namespace(src=str(tmp_path / name / "hr"),
                               dst=str(tmp_path / name / "keys.pkl")))
    for f in ("hr/data.bin", "hr/meta.json", "keys.pkl"):
        assert _bytes(tmp_path / "jax" / f) == _bytes(tmp_path / "port" / f), f
    be = PackedBackend(str(tmp_path / "port" / "hr"))
    key = "000_2" if layout == "clips" else "00002/0007_7"
    path = ("reds/000/00000002.png" if layout == "clips" else "vimeo/00002/0007/im7.png")
    np.testing.assert_array_equal(be.read(key),
                                  read_image(str(png_trees / path)).astype(np.float32) / 255.0)
    with open(tmp_path / "port" / "keys.pkl", "rb") as f:
        assert pickle.load(f)["keys"] == be.keys


def test_gen_lr_within_one_level(jax_prep, png_trees, tmp_path):
    src = str(png_trees / "reds")
    jax_prep.cmd_gen_lr(Namespace(src=src, dst=str(tmp_path / "jax"), layout="clips", scale=4))
    assert prepare_data.main(["gen-lr", "--src", src, "--dst", str(tmp_path / "port"),
                              "--device", "cpu"]) == 0
    a, b = PackedBackend(str(tmp_path / "jax")), PackedBackend(str(tmp_path / "port"))
    assert a.frame_shape == b.frame_shape == (9, 13, 3) and a.index == b.index
    diff = np.abs(a._mm.astype(np.int16) - b._mm.astype(np.int16))
    assert diff.max() <= 1, diff.max()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            prepare_data.main(["gen-lr", "--src", src, "--dst", str(tmp_path / "x")])


def test_sep_vimeo_and_ann_identical(jax_prep, png_trees, tmp_path):
    lst = str(png_trees / "sep_trainlist.txt")
    for name, mod in (("jax", jax_prep), ("port", prepare_data)):
        mod.cmd_sep_vimeo(Namespace(src=str(png_trees / "vimeo"), list=lst,
                                    dst=str(tmp_path / name / "train")))
        for ds in ("vimeo", "reds"):
            mod.cmd_ann(Namespace(dataset=ds, list=lst, dst=str(tmp_path / name / f"{ds}.txt")))
    files = {}
    for name in ("jax", "port"):
        root = tmp_path / name
        files[name] = sorted(os.path.relpath(os.path.join(d, f), root)
                             for d, _, fs in os.walk(root) for f in fs)
    assert files["jax"] == files["port"] and len(files["port"]) == 2 * 7 + 2
    for f in files["port"]:
        assert _bytes(tmp_path / "jax" / f) == _bytes(tmp_path / "port" / f), f
    assert prepare_data.main(["ann", "--dataset", "reds", "--dst", str(tmp_path / "r.txt")]) == 0
    assert _bytes(tmp_path / "r.txt") == _bytes(tmp_path / "port" / "reds.txt")


def test_demo_data_matches_jax(tmp_path, monkeypatch, capsys):
    jax_demo = _jax_tool("make_demo_data")
    monkeypatch.setattr(sys, "argv", ["make_demo_data.py", "--out", str(tmp_path / "jax"),
                                      "--frames", "3", "--size", "64"])
    jax_demo.main()
    want_psnr = float(capsys.readouterr().out.split("PSNR:")[1].split()[0])
    assert make_demo_data.main(["--out", str(tmp_path / "port"), "--frames", "3", "--size",
                                "64", "--device", "cpu"]) == 0
    got_psnr = float(capsys.readouterr().out.split("PSNR:")[1].split()[0])
    assert abs(got_psnr - want_psnr) <= 0.05, (got_psnr, want_psnr)
    for f in ("hr.pack/data.bin", "hr.pack/meta.json", "lr.pack/meta.json"):
        assert _bytes(tmp_path / "jax" / f) == _bytes(tmp_path / "port" / f), f
    a = PackedBackend(str(tmp_path / "jax" / "lr.pack"))._mm.astype(np.int16)
    b = PackedBackend(str(tmp_path / "port" / "lr.pack"))._mm.astype(np.int16)
    assert np.abs(a - b).max() <= 1
    for sub, tol in (("GT", 0), ("LR", 1)):
        for i in range(3):
            rel = os.path.join("val", sub, "000", f"{i:08d}.png")
            x = read_image(str(tmp_path / "jax" / rel)).astype(np.int16)
            y = read_image(str(tmp_path / "port" / rel)).astype(np.int16)
            assert np.abs(x - y).max() <= tol, rel
