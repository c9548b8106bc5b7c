"""The port's evaluation path (``vmg_tpu_torch.eval``) against ``vmg_tpu.eval``
and ``tools/eval.py`` on CPU.

* Metrics against ``vmg_tpu.eval.metrics`` (cv2): PSNR to 1e-12 dB, SSIM
  and SSIM-Y to 1e-9 (the port's separable float64 window differs from
  cv2's 2-D filter by rounding only), the Y channel exactly.
* PNG: files of every colour type and depth that cv2 writes read equal to
  ``vmg_tpu.eval.eval_utils.read_image``; the port's files read back by cv2
  equal; every row filter (0-4) decodes; palette and interlaced files
  raise.
* ``index_generation`` and ``SlidingEvaluator`` equal to ``vmg_tpu``'s,
  exactly (both are numpy on the same forward function), for a pointwise
  and a frame-mixing forward: tiles, sliding clips, the oracle, TTA,
  ``evaluate`` and ``evaluate_fps``.
* The device-tiled forward equals host tiling with the tiny model on CPU,
  within 1e-6; each evaluation preset equals ``vmg_tpu.configs.load_config``
  of its YAML, field by field; both packages refuse a clip length the
  trajectory window does not divide (REDS4's 50 frames at windows of 16
  and 32), here with a tiny stand-in.
* End to end: ``run_eval`` and ``tools/eval.py``'s ``main()`` on one
  synthetic Vid4 tree from ``tests/fixtures/ref_tiny_mine.pth`` (the JAX
  command line from its exact float32 copy): per-frame
  PSNR within 1e-3 dB, SSIM within 1e-5, output PNGs within 1 LSB (the two
  forwards agree to 2e-4, ``test_ckpt_fixture.py``'s tolerance, so a
  rounding to uint8 may land one step apart).
"""

import copy
import dataclasses
import os
import struct
import zlib

import cv2
import numpy as np
import pytest
import torch

from vmg_tpu.configs import load_config
from vmg_tpu.eval import eval_utils as j_utils
from vmg_tpu.eval import metrics as j_metrics
from vmg_tpu.eval.inference import SlidingEvaluator as JEvaluator
from vmg_tpu_torch.configs import EVAL_PRESETS
from vmg_tpu_torch.eval import eval_utils, metrics, png, run_eval
from vmg_tpu_torch.eval.inference import SlidingEvaluator

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRESETS = os.path.join(REPO, "vmg_tpu", "configs", "presets")
FIXTURE = os.path.join(REPO, "tests", "fixtures", "ref_tiny_mine.pth")


@pytest.fixture(autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


# ---- metrics ----------------------------------------------------------------

@pytest.mark.parametrize("shape,noise", [((40, 48, 3), 20), ((33, 27, 3), 3), ((31, 45), 40)])
def test_metrics_match_cv2(shape, noise):
    rng = np.random.default_rng(sum(shape))
    a = rng.integers(0, 256, shape, dtype=np.uint8)
    b = np.clip(a.astype(int) + rng.integers(-noise, noise + 1, shape), 0, 255).astype(np.uint8)
    assert abs(metrics.calculate_psnr(a, b) - j_metrics.calculate_psnr(a, b)) <= 1e-12
    assert abs(metrics.calculate_psnr(a, b, 4) - j_metrics.calculate_psnr(a, b, 4)) <= 1e-12
    assert abs(metrics.structural_similarity(a, b)
               - j_metrics.structural_similarity(a, b)) <= 1e-9
    assert metrics.calculate_psnr(a, a) == j_metrics.calculate_psnr(a, a) == float("inf")
    if len(shape) == 3:
        ya, yb = metrics.rgb2ycbcr_matlab(a), metrics.rgb2ycbcr_matlab(b)
        np.testing.assert_array_equal(ya, j_metrics.rgb2ycbcr_matlab(a))
        ya, yb = ya[..., 0], yb[..., 0]
        assert abs(metrics.calculate_psnr(ya, yb) - j_metrics.calculate_psnr(ya, yb)) <= 1e-12
        assert abs(metrics.structural_similarity(ya, yb)
                   - j_metrics.structural_similarity(ya, yb)) <= 1e-9
    f, g = a / 255.0, b / 255.0
    assert metrics.psnr_float01(f, g) == j_metrics.psnr_float01(f, g)
    assert metrics.psnr_exceed_check(metrics.psnr_float01(f, f)) == \
        j_metrics.psnr_exceed_check(j_metrics.psnr_float01(f, f))
    np.testing.assert_allclose(metrics.gaussian_taps(), cv2.getGaussianKernel(11, 1.5)[:, 0],
                               rtol=0, atol=1e-16)


# ---- PNG ----------------------------------------------------------------------

def _png_cases():
    rng = np.random.default_rng(3)
    ramp = np.add.outer(np.arange(19), np.arange(23)).astype(np.uint8) * 5
    return {
        "grey8": rng.integers(0, 256, (19, 23), dtype=np.uint8),
        "bgr8": np.stack([ramp, ramp[::-1], rng.integers(0, 256, ramp.shape, dtype=np.uint8)], -1),
        "bgra8": rng.integers(0, 256, (19, 23, 4), dtype=np.uint8),
        "bgr16": rng.integers(0, 65536, (13, 17, 3), dtype=np.uint16),
        "grey16": rng.integers(0, 65536, (13, 17), dtype=np.uint16),
    }


@pytest.mark.parametrize("case", sorted(_png_cases()))
@pytest.mark.parametrize("level", [0, 9])
def test_png_read_matches_cv2(tmp_path, case, level):
    img = _png_cases()[case]
    path = str(tmp_path / f"{case}.png")
    assert cv2.imwrite(path, img, [cv2.IMWRITE_PNG_COMPRESSION, level])
    np.testing.assert_array_equal(eval_utils.read_image(path), j_utils.read_image(path))
    got, want = png.read_png(path), cv2.imread(path, cv2.IMREAD_UNCHANGED)
    assert got.dtype == want.dtype
    if want.ndim == 3:  # cv2: BGR(A); the port: RGB(A)
        want = want[..., [2, 1, 0, 3][:want.shape[2]]]
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", sorted(_png_cases()))
def test_png_write_reads_back_in_cv2(tmp_path, case):
    img = _png_cases()[case]  # as RGB(A) for the port's writer
    path = str(tmp_path / f"{case}.png")
    png.write_png(path, img)
    back = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if back.ndim == 3:
        back = back[..., [2, 1, 0, 3][:back.shape[2]]]
    np.testing.assert_array_equal(back, img)
    np.testing.assert_array_equal(png.read_png(path), img)


def _filtered_png(path, img, kinds):
    """An RGB8 PNG whose rows use the given filter types (cycled)."""
    h, w, ch = img.shape
    bpp, raw, prior = ch, bytearray(), bytearray(w * ch)
    for y in range(h):
        line, kind = img[y].tobytes(), kinds[y % len(kinds)]
        out = bytearray(len(line))
        for x in range(len(line)):
            a = line[x - bpp] if x >= bpp else 0
            b, c = prior[x], prior[x - bpp] if x >= bpp else 0
            pred = [0, a, b, (a + b) // 2, png._paeth(a, b, c)][kind]
            out[x] = (line[x] - pred) & 0xFF
        raw += bytes([kind]) + out
        prior = bytearray(line)
    chunk = png._chunk
    with open(path, "wb") as f:
        f.write(png._SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(bytes(raw))) + chunk(b"IEND", b""))


def test_png_every_row_filter(tmp_path):
    img = np.random.default_rng(5).integers(0, 256, (10, 9, 3), dtype=np.uint8)
    path = str(tmp_path / "filters.png")
    _filtered_png(path, img, [0, 1, 2, 3, 4])
    np.testing.assert_array_equal(png.read_png(path), img)
    np.testing.assert_array_equal(cv2.imread(path)[..., ::-1], img)


def test_png_refuses_what_it_cannot_read(tmp_path):
    path = str(tmp_path / "x.png")
    cv2.imwrite(path, np.zeros((4, 4, 3), np.uint8))
    data = bytearray(open(path, "rb").read())
    for colour, interlace, words in ((3, 0, "palette"), (2, 1, "interlaced")):
        body = struct.pack(">IIBBBBB", 4, 4, 8, colour, 0, 0, interlace)
        bad = data[:8] + png._chunk(b"IHDR", body) + data[33:]
        open(path, "wb").write(bytes(bad))
        with pytest.raises(ValueError, match=words):
            png.read_png(path)
    open(path, "wb").write(b"GIF89a")
    with pytest.raises(ValueError, match="not a PNG"):
        eval_utils.read_image(path)


def test_read_seq_images(tmp_path):
    rng = np.random.default_rng(1)
    for i in range(3):
        cv2.imwrite(str(tmp_path / f"{i:08d}.png"), rng.integers(0, 256, (8, 6, 3), np.uint8))
    np.testing.assert_array_equal(eval_utils.read_seq_images(str(tmp_path)),
                                  j_utils.read_seq_images(str(tmp_path)))


def test_index_generation():
    # windows of one frame never advance (right += n_out - 1): both loop
    # forever, so the grid starts at two
    for n_gt in range(2, 40):
        for n_out in range(2, n_gt + 1):
            assert eval_utils.index_generation(n_out, n_gt) == j_utils.index_generation(n_out, n_gt)


# ---- SlidingEvaluator -------------------------------------------------------

def _pointwise(clip):
    up = clip.repeat(4, axis=2).repeat(4, axis=3)
    return (0.9 * up + 0.05).astype(np.float32)


def _mixing(clip):
    up = clip.repeat(4, axis=2).repeat(4, axis=3)
    ramp = np.arange(clip.shape[1], dtype=np.float32)[None, :, None, None, None] / 50
    return (0.8 * up + 0.1 * up.mean(axis=1, keepdims=True) + ramp).astype(np.float32)


@pytest.mark.parametrize("fn", [_pointwise, _mixing])
@pytest.mark.parametrize("dataset,enhance,wins,mode", [
    ("REDS", False, (16, 16), "mid"), ("REDS", True, (16, 16), "small"),
    ("Vid4", False, (16, 16), 3), ("Vid4", True, None, "mid"),
    ("Vimeo90k_septuplet", False, (12, 20), "mid"), ("Udm10", False, (24, 24), "large")])
def test_sliding_evaluator_matches(fn, dataset, enhance, wins, mode):
    rng = np.random.default_rng(len(dataset) + (wins or (0,))[0])
    T, H, W = 9, 24, 28
    lr = rng.integers(0, 256, (T, H, W, 3), dtype=np.uint8)
    hr = rng.integers(0, 256, (T, 4 * H, 4 * W, 3), dtype=np.uint8)
    kw = dict(scale=4, test_num_frames=4, overlapped_mode=mode, spatial_wins=wins,
              overlapped_spatial_length=4 if wins else None, dataset_name=dataset,
              data_enhance=enhance, tta_rot=enhance)
    mine, ref = SlidingEvaluator(fn, **kw), JEvaluator(fn, **kw)
    x = lr.astype(np.float32)[None] / 255.0
    np.testing.assert_array_equal(mine.augment(x), ref.augment(x))
    if wins:
        np.testing.assert_array_equal(mine.test_image(x[:, :4]), ref.test_image(x[:, :4]))
    np.testing.assert_array_equal(mine.test_clips(x), ref.test_clips(x))
    assert mine.t_idx_list == ref.t_idx_list
    h = hr.astype(np.float32)[None] / 255.0
    np.testing.assert_array_equal(mine.test_clips_max(x, h), ref.test_clips_max(x, h))
    got, want = mine.evaluate(lr, hr), ref.evaluate(lr, hr)
    assert got.dtype == np.uint8 and got.shape == (T, 4 * H, 4 * W, 3)
    np.testing.assert_array_equal(got, want)
    (got, fps), (want, _) = mine.evaluate_fps(lr, hr), ref.evaluate_fps(lr, hr)
    np.testing.assert_array_equal(got, want)
    assert np.isfinite(fps) and fps > 0


# ---- the tiled forward on the device ---------------------------------------


# ---- presets and the clip-length refusal -------------------------------------

_YML = {"reds4_full": "vmg_eval_reds4_full.yml", "reds4_few_levels": "vmg_eval_reds4_few_levels.yml",
        "vid4": "vmg_eval_vid4.yml", "udm10": "vmg_eval_udm10.yml",
        "vimeo90k": "vmg_eval_vimeo90k.yml"}


@pytest.mark.parametrize("name", sorted(_YML))
def test_eval_presets_match_yaml(name):
    want, got = load_config(os.path.join(PRESETS, _YML[name]), is_train=False), EVAL_PRESETS[name]
    assert (got.name, got.scale) == (want.name, want.scale)
    assert got.eval.checkpoint_from == want.eval.checkpoint_from
    for section in ("network", "dataset", "path"):
        for f in dataclasses.fields(getattr(got, section)):
            g, w = getattr(getattr(got, section), f.name), getattr(getattr(want, section), f.name)
            assert g == (tuple(w) if isinstance(w, list) else w), (section, f.name, g, w)


def test_run_eval_refuses_flops_and_a_missing_card(tmp_path):
    cfg = copy.deepcopy(EVAL_PRESETS["vid4"])
    cfg.dataset.FLOPs = True
    cfg.path.output_dir = str(tmp_path)
    with pytest.raises(ValueError, match="FLOP"):
        run_eval(cfg, lr_root=str(tmp_path), device="cpu")
    if not torch.cuda.is_available():
        cfg.dataset.FLOPs = False
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run_eval(cfg, lr_root=str(tmp_path), checkpoint="random")


# ---- end to end against tools/eval.py --------------------------------------

def _write_tree(root, T, h, w):
    rng = np.random.default_rng(9)
    lr_root, gt_root = os.path.join(root, "Vid4", "LR", "X4"), os.path.join(root, "Vid4", "GT")
    for clip in ("calendar", "city"):
        for sub, (hh, ww) in ((lr_root, (h, w)), (gt_root, (4 * h, 4 * w))):
            os.makedirs(os.path.join(sub, clip), exist_ok=True)
            base = rng.integers(40, 200, (hh, ww, 3))
            for i in range(T):
                img = np.clip(base + rng.integers(-30, 31, base.shape), 0, 255).astype(np.uint8)
                cv2.imwrite(os.path.join(sub, clip, f"{i:08d}.png"), img)
    return lr_root
