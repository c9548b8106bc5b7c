"""The port's training data path against ``vmg_tpu.data`` on CPU.

* Packed trees: each package's writer gives the same bytes, and each reads
  the other's; the PNG backend reads frames cv2 wrote as the JAX backend
  does; the LMDB backend decodes through a fake ``lmdb`` module (given to
  the port only: the sandbox has none) and names the package when it is
  missing; JPEG is refused.
* ``IterSampler``: the same index lists over replicas, ratios, seeds and
  epochs.
* ``REDSDataset`` / ``VimeoDataset``: samples bit-equal to the JAX
  package's at several (epoch, index) with every flip, rotation, reverse
  and mirror on, through the native assembler (built here with g++) and
  the numpy path; ``get_batch`` equal to the stacked samples; a packed
  dataset whose library does not load raises.
* ``PrefetchLoader``: the JAX loader's batches with 1 and 3 workers; a
  worker's error reaches the consumer; ``accumulate_batches`` as JAX's.
* ``imresize_matlab`` within 1e-5 of JAX's, ``pixel_unshuffle`` exact,
  the colour conversions exact on uint8.
* ``TRAIN_PRESETS`` equal, field by field, to ``load_config`` of the four
  training YAMLs.
"""

import dataclasses
import os
import sys
import types

import cv2
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from vmg_tpu.configs import load_config
from vmg_tpu.configs.config import DatasetConfig as JDatasetConfig
from vmg_tpu.data import clip_dataset as jclip
from vmg_tpu.data import color as jcolor
from vmg_tpu.data import loader as jloader
from vmg_tpu.data import storage as jstorage
from vmg_tpu.data.sampler import IterSampler as JIterSampler
from vmg_tpu.ops.pixel_shuffle import pixel_unshuffle as j_unshuffle
from vmg_tpu.ops.resize import imresize_matlab as j_imresize
from vmg_tpu_torch import _build
from vmg_tpu_torch.configs import TRAIN_PRESETS, DatasetConfig
from vmg_tpu_torch.data import clip_dataset, color, loader, native, storage
from vmg_tpu_torch.data.sampler import IterSampler
from vmg_tpu_torch.ops.pixel_shuffle import pixel_shuffle, pixel_unshuffle
from vmg_tpu_torch.ops.resize import imresize_matlab

PRESETS = os.path.join(os.path.dirname(__file__), os.pardir, "vmg_tpu", "configs", "presets")
HR, LR = (48, 64), (12, 16)


@pytest.fixture(autouse=True)
def _few_torch_threads():
    """The suite runs in several worker processes at once; torch at full
    width in each of them oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _write_tree(root, writer_cls, clips, frames, first=0, seed=0):
    """HR and LR packed trees of random frames; keys '<clip>_<frame>'."""
    rng = np.random.default_rng(seed)
    hw = writer_cls(os.path.join(root, "hr"), HR + (3,))
    lw = writer_cls(os.path.join(root, "lr"), LR + (3,))
    for c in clips:
        for f in range(first, first + frames):
            hw.add(f"{c}_{f}", rng.integers(0, 256, HR + (3,), dtype=np.uint8), clip_key=c)
            lw.add(f"{c}_{f}", rng.integers(0, 256, LR + (3,), dtype=np.uint8), clip_key=c)
    hw.close()
    lw.close()
    return os.path.join(root, "hr"), os.path.join(root, "lr")


@pytest.fixture(scope="module")
def reds_tree(tmp_path_factory):
    return _write_tree(str(tmp_path_factory.mktemp("reds")), storage.PackedWriter,
                       ["000", "001", "002"], 10)


def _ds_kwargs(hr, lr, **kw):
    base = dict(dataroot_HR=hr, dataroot_LR=lr, num_frames=4, crop_size=32,
                image_shape=(3,) + HR, total_num_frames=10)
    base.update(kw)
    return base


def test_packed_trees_cross_read(tmp_path):
    ours = _write_tree(str(tmp_path / "port"), storage.PackedWriter, ["a", "b"], 3)
    theirs = _write_tree(str(tmp_path / "jax"), jstorage.PackedWriter, ["a", "b"], 3)
    for mine, jax_root in zip(ours, theirs):
        for name in ("data.bin", "meta.json"):
            with open(os.path.join(mine, name), "rb") as f1, \
                    open(os.path.join(jax_root, name), "rb") as f2:
                assert f1.read() == f2.read(), name
        a, b = storage.PackedBackend(jax_root), jstorage.PackedBackend(mine)
        assert a.keys == b.keys == ["a", "b"] and a.frame_shape == b.frame_shape
        for key in a.index:
            np.testing.assert_array_equal(a.read(key), b.read(key))
            assert a.read(key).dtype == np.float32


@pytest.mark.parametrize("kind", ["rgb", "gray", "rgba", "gray16"])
def test_image_backend_matches_jax(tmp_path, kind):
    rng = np.random.default_rng(1)
    if kind == "gray16":
        img = rng.integers(0, 65536, (9, 11), dtype=np.uint16)
    else:
        shape = {"rgb": (9, 11, 3), "gray": (9, 11), "rgba": (9, 11, 4)}[kind]
        img = rng.integers(0, 256, shape, dtype=np.uint8)
    os.makedirs(tmp_path / "clip")
    cv2.imwrite(str(tmp_path / "clip_3.png"), img)
    got = storage.ImageFolderBackend(str(tmp_path)).read("clip_3")
    want = jstorage.ImageFolderBackend(str(tmp_path)).read("clip_3")
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert storage.ImageFolderBackend(str(tmp_path)).keys == ["clip"]
    assert storage.detect_backend(str(tmp_path)) == "img"


def test_image_backend_refuses_jpeg(tmp_path):
    (tmp_path / "x_1.jpg").write_bytes(b"\xff\xd8\xff\xe0")
    with pytest.raises(FileNotFoundError, match="x_1.png .*PNG frames only.*JPEG"):
        storage.ImageFolderBackend(str(tmp_path)).read("x_1")
    (tmp_path / "x_0.png").write_bytes(b"\xff\xd8\xff\xe0 not a png")
    with pytest.raises(ValueError, match="not a PNG"):
        storage.ImageFolderBackend(str(tmp_path)).read("x_0")


def test_lmdb_backend_decodes_bgr(tmp_path, monkeypatch):
    rng = np.random.default_rng(2)
    frames = {f"000_{i}": rng.integers(0, 256, (5, 7, 3), dtype=np.uint8) for i in range(3)}
    opened = []

    class Txn:
        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

        def get(self, key):
            return frames[key.decode("ascii")].tobytes()

    class Env:
        def begin(self, write=False):
            assert not write
            return Txn()

    fake = types.ModuleType("lmdb")
    fake.open = lambda root, **kw: opened.append((root, kw)) or Env()
    import pickle

    with open(tmp_path / "keys.pkl", "wb") as f:
        pickle.dump({"keys": ["000"]}, f)
    monkeypatch.setitem(sys.modules, "lmdb", fake)
    root = str(tmp_path / "x.lmdb")
    assert storage.detect_backend(root) == "lmdb"
    be = storage.open_backend("lmdb", root, (5, 7, 3), str(tmp_path / "keys.pkl"))
    assert be.keys == ["000"]
    for key, bgr in frames.items():
        want = bgr[:, :, ::-1].astype(np.float32) / 255.0
        np.testing.assert_array_equal(be.read(key), want)
    assert len(opened) == 1 and opened[0][1]["readonly"]
    monkeypatch.setitem(sys.modules, "lmdb", None)
    with pytest.raises(RuntimeError, match="'lmdb' package"):
        storage.LmdbBackend(root, (5, 7, 3))


@pytest.mark.parametrize("replicas", [1, 2, 3])
@pytest.mark.parametrize("ratio", [1, 2])
def test_sampler_matches_jax(replicas, ratio):
    for size in (1, 7, 10):
        for seed in (0, 5):
            for rank in range(replicas):
                mine = IterSampler(size, replicas, rank, ratio=ratio, seed=seed)
                theirs = JIterSampler(size, replicas, rank, ratio=ratio, seed=seed)
                assert len(mine) == len(theirs)
                for epoch in (0, 1, 3):
                    mine.set_epoch(epoch)
                    theirs.set_epoch(epoch)
                    assert list(mine) == list(theirs)


AUGMENT = [dict(), dict(use_mirrors=True), dict(use_hflip=False, use_rot=False),
           dict(random_reverse=False, use_vflip=False), dict(pre_seed=7)]


@pytest.mark.parametrize("native_path", [True, False])
@pytest.mark.parametrize("aug", range(len(AUGMENT)))
def test_reds_samples_match_jax(reds_tree, native_path, aug):
    kw = _ds_kwargs(*reds_tree, **AUGMENT[aug])
    mine = clip_dataset.create_dataset(DatasetConfig(**kw))
    mine.use_native = native_path
    theirs = jclip.create_dataset(JDatasetConfig(**kw))
    theirs.use_native = False  # the JAX package's numpy path
    assert isinstance(mine, clip_dataset.REDSDataset) and len(mine) == 3
    before = native.calls
    for epoch in (0, 1, 4):
        mine.set_epoch(epoch)
        theirs.set_epoch(epoch)
        for index in range(3):
            a, b = mine[index], theirs[index]
            assert a["key"] == b["key"]
            for k in ("LRs", "HRs"):
                assert a[k].dtype == np.float32 and a[k].shape == b[k].shape
                np.testing.assert_array_equal(a[k], b[k])
        batch = mine.get_batch([2, 0, 0, 1])
        if not native_path:
            assert batch is None
            continue
        stack = [mine[i] for i in (2, 0, 0, 1)]
        assert batch["keys"] == [s["key"] for s in stack]
        for k in ("LRs", "HRs"):
            np.testing.assert_array_equal(batch[k], np.stack([s[k] for s in stack]))
    assert (native.calls > before) == native_path


def test_every_augmentation_drawn(reds_tree):
    """Over the samples the tests draw, each flag takes both values."""
    ds = clip_dataset.create_dataset(DatasetConfig(**_ds_kwargs(*reds_tree)))
    seen = set()
    for epoch in (0, 1, 4):
        ds.set_epoch(epoch)
        for index in range(3):
            key, lr_idx, _, cy, cx, flags = ds._native_plan(index)
            seen |= {("flags", flags & b and 1, b) for b in (1, 2, 4)}
            seen.add(("reverse", lr_idx[0] > lr_idx[-1]))
    assert all(("flags", v, b) in seen for v in (0, 1) for b in (1, 2, 4))
    assert {("reverse", True), ("reverse", False)} <= seen


def test_native_matches_numpy_clip(reds_tree):
    be = storage.PackedBackend(reds_tree[0])
    for flags in range(8):
        args = (be._mm, be.frame_shape, [3, 1, 4], 5, 9, 32, 32, flags & 1, flags & 2,
                flags & 4)
        np.testing.assert_array_equal(native.assemble_clip(*args),
                                      native.assemble_clip_numpy(*args))
    with pytest.raises(ValueError, match="out of bounds"):
        native.assemble_clip(be._mm, be.frame_shape, [0], 40, 0, 32, 32, 0, 0, 0)


def test_packed_dataset_without_its_library_raises(reds_tree, monkeypatch):
    def broken():
        raise RuntimeError("g++ failed")

    monkeypatch.setattr(native, "load_packbatch", broken)
    ds = clip_dataset.create_dataset(DatasetConfig(**_ds_kwargs(*reds_tree)))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        ds[0]
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        ds.get_batch([0, 1])
    assert _build.load_packbatch().assemble_batch  # the real library builds here


@pytest.fixture(scope="module")
def vimeo_tree(tmp_path_factory):
    return _write_tree(str(tmp_path_factory.mktemp("vimeo")), storage.PackedWriter,
                       ["00001/0001", "00001/0002", "00002/0001"], 7, first=1, seed=3)


@pytest.mark.parametrize("aug", range(len(AUGMENT)))
def test_vimeo_samples_match_jax(vimeo_tree, aug):
    kw = _ds_kwargs(*vimeo_tree, name="Vimeo90k_septuplet", num_frames=7, **AUGMENT[aug])
    mine = clip_dataset.create_dataset(DatasetConfig(**kw))
    theirs = jclip.create_dataset(JDatasetConfig(**kw))
    assert isinstance(mine, clip_dataset.VimeoDataset)
    for epoch in (0, 2):
        mine.set_epoch(epoch)
        theirs.set_epoch(epoch)
        for index in range(3):
            a, b = mine[index], theirs[index]
            assert a["key"] == b["key"]
            for k in ("LRs", "HRs"):
                np.testing.assert_array_equal(a[k], b[k])
    rep = clip_dataset.RepeatDataset(mine, 3)
    assert len(rep) == 9
    np.testing.assert_array_equal(rep[4]["HRs"], mine[1]["HRs"])


@pytest.mark.parametrize("workers", [1, 3])
def test_loader_matches_jax(reds_tree, workers):
    kw = _ds_kwargs(*reds_tree, batch_size=2, n_workers=workers, dataset_expand_ratio=3)
    mine = loader.create_dataloader(clip_dataset.create_dataset(DatasetConfig(**kw)),
                                    DatasetConfig(**kw))
    jcfg = JDatasetConfig(**kw)
    theirs = jloader.create_dataloader(jclip.create_dataset(jcfg), jcfg)
    assert len(mine) == len(theirs) == 4
    for epoch in (0, 1):
        for ld in (mine, theirs):
            ld.dataset.set_epoch(epoch)
            ld.sampler.set_epoch(epoch)
        got, want = list(mine), list(theirs)
        assert len(got) == len(want) == 4
        for a, b in zip(got, want):
            assert a["keys"] == b["keys"]
            for k in ("LRs", "HRs"):
                np.testing.assert_array_equal(a[k], b[k])
        tensors = [{k: torch.from_numpy(b[k]) for k in ("LRs", "HRs")} for b in got]
        for grad_acc in (1, 2, 3):
            acc = list(loader.accumulate_batches(iter(got), grad_acc))
            acc_t = list(loader.accumulate_batches(iter(tensors), grad_acc))
            jacc = list(jloader.accumulate_batches(iter(want), grad_acc))
            assert len(acc) == len(acc_t) == len(jacc) == 4 // grad_acc
            for a, t, b in zip(acc, acc_t, jacc):
                for k in ("LRs", "HRs"):
                    np.testing.assert_array_equal(a[k], b[k])
                    np.testing.assert_array_equal(t[k].numpy(), b[k])


def test_loader_raises_a_worker_error_and_feeds_the_device(reds_tree):
    class Broken:
        def __len__(self):
            return 6

        def __getitem__(self, i):
            if i == 4:
                raise KeyError(f"bad sample {i}")
            return {"LRs": np.full((1, 2, 2, 3), i, np.float32),
                    "HRs": np.full((1, 8, 8, 3), i, np.float32), "key": str(i)}

    ld = loader.PrefetchLoader(Broken(), list(range(6)), 2, num_workers=3, prefetch=1)
    seen = []
    with pytest.raises(KeyError, match="bad sample 4"):
        for b in ld:
            seen.append(b["keys"])
    assert seen == [["0", "1"], ["2", "3"]]
    ld = loader.PrefetchLoader(Broken(), list(range(4)), 2, num_workers=2)
    feed = loader.DeviceFeed(loader.accumulate_batches(iter(ld), 2), "cpu")
    out = list(feed)
    assert len(out) == 1 and len(feed.waits) == 1
    assert isinstance(out[0]["LRs"], torch.Tensor)
    np.testing.assert_array_equal(out[0]["LRs"][:, 0, 0, 0, 0].numpy(), [0, 1, 2, 3])


def test_device_feed_takes_no_batch_ahead():
    taken = []

    def batches():
        for i in range(3):
            taken.append(i)
            yield {"LRs": np.full((1, 2), i, np.float32), "HRs": np.full((1, 4), i, np.float32)}

    feed = loader.DeviceFeed(batches(), "cpu")
    for i, b in enumerate(feed):
        assert taken == list(range(i + 1)) and len(feed.waits) == i + 1
        assert int(b["HRs"][0, 0]) == i
    assert len(feed.waits) == 3


@pytest.mark.parametrize("shape,scale", [((37, 41, 3), 0.25), ((2, 48, 64, 3), 0.5),
                                         ((33, 45, 3), 1 / 3), ((9, 11, 3), 4.0),
                                         ((1, 31, 17, 3), 0.25)])
def test_imresize_matlab_matches_jax(shape, scale):
    x = np.random.default_rng(4).random(shape, dtype=np.float32)
    want = np.asarray(j_imresize(jnp.asarray(x), scale))
    got = imresize_matlab(torch.from_numpy(x), scale)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_pixel_unshuffle_matches_jax():
    x = np.random.default_rng(5).random((2, 3, 12, 16, 5), dtype=np.float32)
    got = pixel_unshuffle(torch.from_numpy(x), 2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(j_unshuffle(jnp.asarray(x), 2)))
    np.testing.assert_array_equal(pixel_shuffle(got, 2).numpy(), x)


def test_colour_conversions_match_jax():
    rng = np.random.default_rng(6)
    img = rng.integers(0, 256, (17, 19, 3), dtype=np.uint8)
    for only_y in (True, False):
        np.testing.assert_array_equal(color.rgb2ycbcr(img, only_y),
                                      jcolor.rgb2ycbcr(img, only_y))
        np.testing.assert_array_equal(color.bgr2ycbcr(img, only_y),
                                      jcolor.bgr2ycbcr(img, only_y))
    np.testing.assert_array_equal(color.ycbcr2rgb(img), jcolor.ycbcr2rgb(img))
    f = img.astype(np.float32) / 255
    np.testing.assert_allclose(color.ycbcr2rgb(f), jcolor.ycbcr2rgb(f), atol=1e-6)
    # cv2's BGR -> gray on every (B, G) pair at several R
    b, g, r = np.meshgrid(np.arange(256), np.arange(256), [0, 1, 77, 128, 254, 255],
                          indexing="ij")
    grid = np.stack([b, g, r], -1).reshape(-1, 1, 3).astype(np.uint8)
    for tar, imgs in (("gray", [img, grid]), ("y", [img]), ("other", [img])):
        for a, w in zip(color.channel_convert(3, tar, imgs),
                        jcolor.channel_convert(3, tar, imgs)):
            np.testing.assert_array_equal(a, w)
    gray = rng.integers(0, 256, (5, 6, 1), dtype=np.uint8)
    for a, w in zip(color.channel_convert(1, "RGB", [gray]),
                    jcolor.channel_convert(1, "RGB", [gray])):
        np.testing.assert_array_equal(a, w)


_TRAIN_YML = {"reds_full": "vmg_reds_full.yml", "reds_few_levels": "vmg_reds_few_levels.yml",
              "tiny_demo": "vmg_tiny_demo.yml", "demo_overfit": "vmg_demo_overfit.yml"}


@pytest.mark.parametrize("name", sorted(_TRAIN_YML))
def test_train_presets_match_yaml(name):
    from vmg_tpu_torch.models.vmg import check_supported

    want = load_config(os.path.join(PRESETS, _TRAIN_YML[name]), is_train=True)
    got = TRAIN_PRESETS[name]
    assert (got.name, got.scale) == (want.name, want.scale)
    for section in ("network", "dataset", "train", "logger", "path"):
        for f in dataclasses.fields(getattr(got, section)):
            g, w = getattr(getattr(got, section), f.name), getattr(getattr(want, section), f.name)
            assert g == (tuple(w) if isinstance(w, list) else w), (section, f.name, g, w)
    check_supported(got.network)
