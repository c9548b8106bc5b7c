"""Frame storage backends (``vmg_tpu/data/storage.py``), without cv2.

  * ``packed`` -- one flat ``data.bin`` of raw uint8 HWC RGB frames plus a
    ``meta.json`` index, read through ``np.memmap``: the JAX package's
    format, byte for byte, so each package reads the other's trees.
    Written by :class:`PackedWriter` (``vmg_tpu_torch.tools.prepare_data``).
  * ``lmdb``   -- the reference's LMDB shards (raw BGR frames); the ``lmdb``
    package is imported when such a root is opened.
  * ``img``    -- a folder of PNG frames, ``<root>/<clip>_<frame>.png``
    (the key joined with the extension, as the JAX backend reads them),
    through the port's own PNG codec (``eval/png.py``).  JPEG is refused:
    the machine with the card has neither cv2 nor PIL.

Every backend's ``read`` returns float32 RGB HWC in [0, 1].
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Dict, List, Optional, Tuple

import numpy as np

from vmg_tpu_torch.eval.png import read_png


class PackedBackend:
    """Packed frames: ``meta.json`` + ``data.bin`` (raw uint8 HWC)."""

    def __init__(self, root: str):
        with open(os.path.join(root, "meta.json")) as f:
            self.meta = json.load(f)
        self.frame_shape = tuple(self.meta["frame_shape"])  # (H, W, C)
        self.index: Dict[str, int] = self.meta["index"]  # key -> frame number
        self._frame_bytes = int(np.prod(self.frame_shape))
        self._mm = np.memmap(os.path.join(root, "data.bin"), dtype=np.uint8, mode="r")

    @property
    def keys(self) -> List[str]:
        return self.meta["clip_keys"]

    def read(self, key: str) -> np.ndarray:
        off = self.index[key] * self._frame_bytes
        img = self._mm[off: off + self._frame_bytes].reshape(self.frame_shape)
        return img.astype(np.float32) / 255.0


class PackedWriter:
    """Writes a packed tree; frames are stored in the order they are added."""

    def __init__(self, root: str, frame_shape: Tuple[int, int, int]):
        os.makedirs(root, exist_ok=True)
        self.root = root
        self.frame_shape = tuple(frame_shape)
        self._f = open(os.path.join(root, "data.bin"), "wb")
        self.index: Dict[str, int] = {}
        self.clip_keys: List[str] = []
        self._n = 0

    def add(self, key: str, img_uint8: np.ndarray, clip_key: Optional[str] = None):
        if img_uint8.dtype != np.uint8 or img_uint8.shape != self.frame_shape:
            raise ValueError(f"{key}: expected uint8 {self.frame_shape}, got "
                             f"{img_uint8.dtype} {img_uint8.shape}")
        self._f.write(np.ascontiguousarray(img_uint8).tobytes())
        self.index[key] = self._n
        self._n += 1
        if clip_key and (not self.clip_keys or self.clip_keys[-1] != clip_key):
            self.clip_keys.append(clip_key)

    def close(self):
        self._f.close()
        with open(os.path.join(self.root, "meta.json"), "w") as f:
            json.dump({"frame_shape": self.frame_shape, "index": self.index,
                       "clip_keys": self.clip_keys, "num_frames": self._n}, f)


class LmdbBackend:
    """The reference's LMDB shards (BGR uint8 raw frames)."""

    def __init__(self, root: str, frame_shape: Tuple[int, int, int],
                 keys_pkl: Optional[str] = None):
        try:
            import lmdb  # noqa: F401
        except ImportError as e:
            raise RuntimeError(f"{root}: reading an LMDB root needs the 'lmdb' package, "
                               "which is not installed") from e
        self.root = root
        self.frame_shape = frame_shape  # (H, W, C)
        self._env = None
        self._keys: Optional[List[str]] = None
        if keys_pkl:
            with open(keys_pkl, "rb") as f:
                self._keys = list(pickle.load(f)["keys"])

    def _ensure(self):
        if self._env is None:  # opened lazily, in the thread that reads first
            import lmdb

            self._env = lmdb.open(self.root, readonly=True, lock=False, readahead=False,
                                  meminit=False)

    @property
    def keys(self) -> List[str]:
        return self._keys or []

    def read(self, key: str) -> np.ndarray:
        self._ensure()
        with self._env.begin(write=False) as txn:
            buf = txn.get(key.encode("ascii"))
        H, W, C = self.frame_shape
        img = np.frombuffer(buf, dtype=np.uint8).reshape(H, W, C)
        return img[:, :, ::-1].astype(np.float32) / 255.0  # stored BGR -> RGB


class ImageFolderBackend:
    """PNG frames: ``read(key)`` reads ``<root>/<key>.png``."""

    def __init__(self, root: str):
        self.root = root

    @property
    def keys(self) -> List[str]:
        return sorted(d for d in os.listdir(self.root)
                      if os.path.isdir(os.path.join(self.root, d)))

    def read(self, key: str) -> np.ndarray:
        path = os.path.join(self.root, key + ".png")
        if not os.path.exists(path):
            raise FileNotFoundError(f"{path} (the image backend reads PNG frames only: no "
                                    "JPEG decoder without cv2 or PIL)")
        img = read_png(path)
        if img.ndim == 2:
            img = img[:, :, None].repeat(3, 2)
        return img[:, :, :3].astype(np.float32) / 255.0


def open_backend(kind: str, root: str, frame_shape=None, keys_pkl=None):
    if kind == "packed":
        return PackedBackend(root)
    if kind == "lmdb":
        return LmdbBackend(root, frame_shape, keys_pkl)
    if kind == "img":
        return ImageFolderBackend(root)
    raise ValueError(f"unknown backend {kind!r}")


def detect_backend(root: str) -> str:
    if root.endswith(".lmdb"):
        return "lmdb"
    if os.path.exists(os.path.join(root, "meta.json")):
        return "packed"
    return "img"
