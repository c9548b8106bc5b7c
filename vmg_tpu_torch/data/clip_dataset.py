"""Training clip datasets (``vmg_tpu/data/clip_dataset.py``; reference
``data/REDS.py``, ``data/Vimeo.py``).

A random T-frame window of each clip, an optional temporal reverse, a
paired LR / HR random crop, hflip / vflip / rot90 and an optional mirror
extension.  Every sample's draws come from a generator seeded by
(pre_seed, epoch, index), in a fixed order -- start frame, reverse; crop
row, crop column; hflip, vflip, rot90 -- so a sample is the JAX package's
sample, bit for bit, and any sample can be drawn again.

Output is channels-last float32 RGB: {'LRs': (T, h, w, 3),
'HRs': (T, 4h, 4w, 3), 'key': str}.
"""

from __future__ import annotations

import pickle
from typing import Dict, List

import numpy as np

from vmg_tpu_torch.configs import DatasetConfig
from vmg_tpu_torch.data import native
from vmg_tpu_torch.data.storage import PackedBackend, detect_backend, open_backend


class ClipDatasetBase:
    def __init__(self, cfg: DatasetConfig, scale: int = 4):
        self.cfg = cfg
        self.scale = scale
        self.num_frames = cfg.num_frames
        self.hr_crop = cfg.crop_size
        self.lr_crop = cfg.crop_size // scale
        hr_shape = (cfg.image_shape[1], cfg.image_shape[2], cfg.image_shape[0])
        lr_shape = (cfg.image_shape[1] // scale, cfg.image_shape[2] // scale,
                    cfg.image_shape[0])
        kind = detect_backend(cfg.dataroot_HR)
        self.hr = open_backend(kind, cfg.dataroot_HR, hr_shape, cfg.cache_keys)
        self.lr = open_backend(kind, cfg.dataroot_LR, lr_shape, cfg.cache_keys)
        self.keys = self._load_keys()
        if not self.keys:
            raise ValueError(f"{cfg.dataroot_HR}: empty clip key list")
        self.epoch = 0

    def _load_keys(self) -> List[str]:
        if self.cfg.cache_keys:
            with open(self.cfg.cache_keys, "rb") as f:
                return list(pickle.load(f)["keys"])
        return list(self.hr.keys)

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self):
        return len(self.keys)

    def _rng(self, index: int) -> np.random.Generator:
        seed = (self.cfg.pre_seed or 0, self.epoch, index)
        return np.random.default_rng(np.random.SeedSequence(seed))

    def _flips(self, rng):
        """(hflip, vflip, rot90): three draws, in this order."""
        hflip = self.cfg.use_hflip and rng.random() < 0.5
        vflip = self.cfg.use_vflip and rng.random() < 0.5
        rot90 = self.cfg.use_rot and rng.random() < 0.5
        return hflip, vflip, rot90

    def _crop_origin(self, rng, lr_shape):
        """The LR crop's (row, column): two draws."""
        H, W = lr_shape[:2]
        rnd_h = int(rng.integers(0, max(0, H - self.lr_crop) + 1))
        rnd_w = int(rng.integers(0, max(0, W - self.lr_crop) + 1))
        return rnd_h, rnd_w

    def _finalize(self, rng, lr_list, hr_list, key) -> Dict:
        """Crop, augment and mirror per-frame arrays (the plain path)."""
        rnd_h, rnd_w = self._crop_origin(rng, lr_list[0].shape)
        lc, hc, hh, hw = self.lr_crop, self.hr_crop, rnd_h * self.scale, rnd_w * self.scale
        lr_list = [v[rnd_h: rnd_h + lc, rnd_w: rnd_w + lc] for v in lr_list]
        hr_list = [v[hh: hh + hc, hw: hw + hc] for v in hr_list]
        hflip, vflip, rot90 = self._flips(rng)

        def aug(img):
            if hflip:
                img = img[:, ::-1]
            if vflip:
                img = img[::-1]
            if rot90:
                img = img.transpose(1, 0, 2)
            return img

        lr_list, hr_list = [aug(v) for v in lr_list], [aug(v) for v in hr_list]
        if self.cfg.use_mirrors:
            lr_list = lr_list + lr_list[::-1]
            hr_list = hr_list + hr_list[::-1]
        return {"LRs": np.ascontiguousarray(np.stack(lr_list, 0)),
                "HRs": np.ascontiguousarray(np.stack(hr_list, 0)), "key": key}


class REDSDataset(ClipDatasetBase):
    """A random T-frame window of 100-frame REDS clips (reference
    data/REDS.py:143-215).

    On packed trees the gather, crop, augment and float conversion run in
    the native assembler (:mod:`vmg_tpu_torch.data.native`), which must
    build; ``use_native = False`` takes the numpy path, which gives the same
    bits.  LMDB and PNG trees take the numpy path."""

    use_native: bool = True

    def _native(self) -> bool:
        return (self.use_native and isinstance(self.hr, PackedBackend)
                and isinstance(self.lr, PackedBackend))

    def _sample_frames(self, rng) -> List[int]:
        total = self.cfg.total_num_frames
        start = int(rng.integers(0, total - self.num_frames + 1))
        frames = list(range(start, start + self.num_frames))
        if self.cfg.random_reverse and rng.random() < 0.5:
            frames.reverse()
        return frames

    def _native_plan(self, index: int):
        """(key, lr frame numbers, hr frame numbers, cy, cx, flags), with
        the numpy path's draws in the numpy path's order."""
        rng = self._rng(index)
        key = self.keys[index]
        frames = self._sample_frames(rng)
        cy, cx = self._crop_origin(rng, self.lr.frame_shape)
        hflip, vflip, rot90 = self._flips(rng)
        flags = int(hflip) | (int(vflip) << 1) | (int(rot90) << 2)
        lr_idx = [self.lr.index[f"{key}_{v}"] for v in frames]
        hr_idx = [self.hr.index[f"{key}_{v}"] for v in frames]
        return key, lr_idx, hr_idx, cy, cx, flags

    def __getitem__(self, index: int) -> Dict:
        if self._native():
            key, lr_idx, hr_idx, cy, cx, flags = self._native_plan(index)
            hflip, vflip, rot90 = flags & 1, (flags >> 1) & 1, (flags >> 2) & 1
            lrs = native.assemble_clip(self.lr._mm, self.lr.frame_shape, lr_idx, cy, cx,
                                       self.lr_crop, self.lr_crop, hflip, vflip, rot90)
            hrs = native.assemble_clip(self.hr._mm, self.hr.frame_shape, hr_idx,
                                       cy * self.scale, cx * self.scale, self.hr_crop,
                                       self.hr_crop, hflip, vflip, rot90)
            if self.cfg.use_mirrors:
                lrs = np.concatenate([lrs, lrs[::-1]], axis=0)
                hrs = np.concatenate([hrs, hrs[::-1]], axis=0)
            return {"LRs": lrs, "HRs": hrs, "key": key}
        rng = self._rng(index)
        key = self.keys[index]
        frames = self._sample_frames(rng)
        hr_list = [self.hr.read(f"{key}_{v}") for v in frames]
        lr_list = [self.lr.read(f"{key}_{v}") for v in frames]
        return self._finalize(rng, lr_list, hr_list, key)

    def get_batch(self, indices):
        """A whole batch in one native call a tree (``assemble_batch``,
        OpenMP over clips), equal to stacking the per-clip samples; None
        where the native path does not apply (the loader then stacks)."""
        if not self._native():
            return None
        B, T = len(indices), self.num_frames
        lr_idx, hr_idx = np.empty((B, T), np.int64), np.empty((B, T), np.int64)
        lr_crops, hr_crops = np.zeros((B, 4), np.int64), np.zeros((B, 4), np.int64)
        keys = []
        for b, index in enumerate(indices):
            key, lr_idx[b], hr_idx[b], cy, cx, flags = self._native_plan(index)
            lr_crops[b] = (cy, cx, flags, 0)
            hr_crops[b] = (cy * self.scale, cx * self.scale, flags, 0)
            keys.append(key)
        lrs = native.assemble_batch(self.lr._mm, self.lr.frame_shape, lr_idx, lr_crops,
                                    self.lr_crop, self.lr_crop)
        hrs = native.assemble_batch(self.hr._mm, self.hr.frame_shape, hr_idx, hr_crops,
                                    self.hr_crop, self.hr_crop)
        if self.cfg.use_mirrors:
            lrs = np.concatenate([lrs, lrs[:, ::-1]], axis=1)
            hrs = np.concatenate([hrs, hrs[:, ::-1]], axis=1)
        return {"LRs": lrs, "HRs": hrs, "keys": keys}


class VimeoDataset(ClipDatasetBase):
    """Vimeo-90K septuplets (reference data/Vimeo.py:140-209); frames are
    1-indexed im1..im7."""

    def __getitem__(self, index: int) -> Dict:
        rng = self._rng(index)
        key = self.keys[index]
        frames = list(range(1, self.num_frames + 1))
        if self.cfg.random_reverse and rng.random() < 0.5:
            frames.reverse()
        hr_list = [self.hr.read(f"{key}_{v}") for v in frames]
        lr_list = [self.lr.read(f"{key}_{v}") for v in frames]
        return self._finalize(rng, lr_list, hr_list, key)


def create_dataset(cfg: DatasetConfig, scale: int = 4) -> ClipDatasetBase:
    if cfg.name == "Vimeo90k_septuplet":
        return VimeoDataset(cfg, scale)
    if cfg.name == "REDS":
        return REDSDataset(cfg, scale)
    raise NotImplementedError(f"Dataset {cfg.name!r} is not recognized")


class RepeatDataset:
    """Repeat a dataset ``times`` times (reference
    mmedit/datasets/dataset_wrappers.py RepeatDataset)."""

    def __init__(self, dataset, times: int):
        self.dataset = dataset
        self.times = times

    def set_epoch(self, epoch: int):
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def __getitem__(self, idx):
        return self.dataset[idx % len(self.dataset)]

    def __len__(self):
        return self.times * len(self.dataset)
