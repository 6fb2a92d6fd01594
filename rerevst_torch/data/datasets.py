"""Training data and its loader (host side, numpy NHWC) —
``rerevst_tpu/data/datasets.py``.

* ``FrameDataset`` — COCO-style content jpgs x a random WikiArt-style jpg per
  sample: resize to load_size, a random fine_size crop, a random
  h / v / both flip at p = 0.25 each (``train/dataset.py:420-526``).
* ``MPIDataset`` — the Figure-16 ablation's MPI Sintel clean frame pairs
  with their backward ``.mat`` flow and occlusion masks, the masks times the
  validity of the backward warp (``train/dataset.py:224-415``).
* ``VideoDataset`` — the ablation's video frame pairs with forward flow and
  masks, read from a zip archive (``train/dataset.py:38-219``).
* ``Loader`` — a shuffled, batched, thread-prefetched epoch iterator in
  place of torch's DataLoader.
* ``get_loader`` — the dataset factory.

The same Python ``random``, numpy and cv2 calls in the same order as the JAX
package: for the same seed and files, one reader thread gives bit-identical
batches.  Batches are dicts of float32 NHWC arrays (``Content``,
``Style``, ImageNet-normalized; the ablations add ``NextContent`` and a
flow and a mask).  Reading images needs cv2 (and ``.mat`` flows scipy),
which the card's machine lacks: there the train step takes batches made by
other means.
"""

from __future__ import annotations

import glob
import io
import os
import queue
import random
import threading
import zipfile
from typing import Dict, Iterator, List, Optional

import numpy as np

from rerevst_torch.ops.image import IMAGENET_MEAN, IMAGENET_STD


def _cv2():
    import cv2

    return cv2


def _apply_flip(img: np.ndarray, flip_rand: float) -> np.ndarray:
    cv2 = _cv2()
    if flip_rand <= 0.25:
        return cv2.flip(img, 1)
    if flip_rand <= 0.5:
        return cv2.flip(img, 0)
    if flip_rand <= 0.75:
        return cv2.flip(img, -1)
    return img


def _process_img(img_bgr: np.ndarray, fine_size: int,
                 load_size: Optional[int], x1: int, y1: int,
                 flip_rand: Optional[float]) -> np.ndarray:
    """BGR uint8 -> normalized RGB float32 HWC with the crop/flip
    augmentation (``train/dataset.py:442-469``)."""
    cv2 = _cv2()
    img = cv2.cvtColor(img_bgr, cv2.COLOR_BGR2RGB)
    if load_size is not None:
        img = cv2.resize(img, (load_size, load_size))
    img = img[x1:x1 + fine_size, y1:y1 + fine_size, :]
    if flip_rand is not None:
        img = _apply_flip(img, flip_rand)
    img = img.astype(np.float32) / 255.0
    return (img - IMAGENET_MEAN) / IMAGENET_STD


def _process_flow(flow: np.ndarray, fine_size: int, x1: int, y1: int,
                  flip_rand: Optional[float]) -> np.ndarray:
    """Crop and flip a flow field, negating the components a flip reverses
    (``train/dataset.py:335-352``)."""
    flow = flow[x1:x1 + fine_size, y1:y1 + fine_size, :].copy()
    if flip_rand is not None and flip_rand <= 0.75:
        flow = _apply_flip(flow, flip_rand)
        if flip_rand <= 0.25 or flip_rand > 0.5:
            flow[:, :, 0] = -flow[:, :, 0]
        if flip_rand > 0.25:
            flow[:, :, 1] = -flow[:, :, 1]
    return flow.astype(np.float32)


def _warp_validity(shape_hw, backward_flow: np.ndarray) -> np.ndarray:
    """Where the backward warp's source lands in the frame: a warp of ones
    with ``INTER_LINEAR`` (``warp_opencv``, ``train/dataset.py:27-33,270``),
    [H, W, 3]."""
    cv2 = _cv2()
    h, w = shape_hw
    flow = -backward_flow.astype(np.float32).copy()
    flow[:, :, 0] += np.arange(w)
    flow[:, :, 1] += np.arange(h)[:, None]
    ones = np.ones((h, w, 3), np.float32)
    return cv2.remap(ones, flow, None, cv2.INTER_LINEAR)


def _style_item(rng: random.Random, style: np.ndarray, fine_size: int,
                load_size: int, flip: bool) -> np.ndarray:
    """A style image's crop: resized to max(h, w, load_size), the draws in
    the reference's order."""
    h, w, _ = style.shape
    ls = max(h, w, load_size)
    x1 = rng.randint(0, ls - fine_size)
    y1 = rng.randint(0, ls - fine_size)
    fr = rng.random() if flip else None
    return _process_img(style, fine_size, ls, x1, y1, fr)


def _pair_item(rng: random.Random, pre: np.ndarray, cur: np.ndarray,
               flow: np.ndarray, mask: np.ndarray, fine_size: int,
               flip: bool, flow_key: str, mask_key: str
               ) -> Dict[str, np.ndarray]:
    """One ablation pair's crop: both frames, the flow and the mask under
    the same crop and flip."""
    x1 = rng.randint(0, pre.shape[0] - fine_size)
    y1 = rng.randint(0, pre.shape[1] - fine_size)
    fr = rng.random() if flip else None
    return {
        "Content": _process_img(pre, fine_size, None, x1, y1, fr),
        "NextContent": _process_img(cur, fine_size, None, x1, y1, fr),
        flow_key: _process_flow(flow, fine_size, x1, y1, fr),
        mask_key: _apply_flip(
            mask[x1:x1 + fine_size, y1:y1 + fine_size],
            fr if fr is not None else 1.0).astype(np.float32),
    }


class FrameDataset:
    """Content jpg x random style jpg (``train/dataset.py:420-526``)."""

    def __init__(self, load_size=288, fine_size=256, flip=True,
                 content_path="data/content", style_path="data/style",
                 seed: Optional[int] = None):
        self.content = sorted(glob.glob(os.path.join(content_path, "*.jpg")))
        self.styles = sorted(glob.glob(os.path.join(style_path, "*.jpg")))
        if not self.content or not self.styles:
            raise FileNotFoundError(
                f"no jpgs under {content_path!r} / {style_path!r}")
        self.load_size, self.fine_size, self.flip = load_size, fine_size, flip
        self.rng = random.Random(seed)

    def __len__(self):
        return len(self.content)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        cv2 = _cv2()
        rng = self.rng
        content = cv2.imread(self.content[index])
        style = cv2.imread(rng.choice(self.styles))

        x1 = rng.randint(0, self.load_size - self.fine_size)
        y1 = rng.randint(0, self.load_size - self.fine_size)
        fr = rng.random() if self.flip else None
        return {"Content": _process_img(content, self.fine_size,
                                        self.load_size, x1, y1, fr),
                "Style": _style_item(rng, style, self.fine_size,
                                     self.load_size, self.flip)}


class MPIDataset:
    """MPI Sintel pairs, backward flow and occlusion masks
    (``train/dataset.py:224-415``): ``mpi_path/{clean,flow_mat,
    occlusions}``."""

    def __init__(self, load_size=288, fine_size=256, flip=True,
                 mpi_path="data/MPI", style_path="data/style",
                 seed: Optional[int] = None):
        import scipy.io  # noqa: F401 — fail early if missing

        self.pre, self.cur, self.flow, self.mask = [], [], [], []
        for folder in sorted(glob.glob(os.path.join(mpi_path, "clean",
                                                    "*/"))):
            n = len(glob.glob(os.path.join(folder, "*.png")))
            name = os.path.basename(os.path.dirname(folder))
            for i in range(2, n + 1):
                self.pre.append(os.path.join(folder, f"frame_{i-1:04d}.png"))
                self.cur.append(os.path.join(folder, f"frame_{i:04d}.png"))
                self.flow.append(os.path.join(
                    mpi_path, "flow_mat", f"{name}_frame_{i-1:04d}.mat"))
                self.mask.append(os.path.join(
                    mpi_path, "occlusions", name, f"frame_{i-1:04d}.png"))
        self.styles = sorted(glob.glob(os.path.join(style_path, "*.jpg")))
        self.load_size, self.fine_size, self.flip = load_size, fine_size, flip
        self.rng = random.Random(seed)

    def __len__(self):
        return len(self.cur)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        import scipy.io

        cv2 = _cv2()
        pre = cv2.imread(self.pre[index])
        cur = cv2.imread(self.cur[index])
        backward_flow = -scipy.io.loadmat(
            self.flow[index], verify_compressed_data_integrity=False)["Img"]
        # Occlusions are 255: validity is 1 - mask/255, and a pixel whose
        # source leaves the frame is invalid too.
        mask = 1.0 - cv2.imread(self.mask[index]) / 255.0
        mask = mask * _warp_validity(pre.shape[:2], backward_flow)
        out = _pair_item(self.rng, pre, cur, backward_flow, mask,
                         self.fine_size, self.flip, "BackwardFlow",
                         "BackwardMask")
        style = cv2.imread(self.rng.choice(self.styles))
        out["Style"] = _style_item(self.rng, style, self.fine_size,
                                   self.load_size, self.flip)
        return out


def normalize_video_data(data: Dict) -> Dict:
    """The internal schema ({'frames': [(pre, cur), ...], 'flows',
    'masks'}) from itself or from the reference's ``video_data.pickle``
    ({'pre_frame_list', 'cur_frame_list', 'flow_list', 'mask_list'},
    ``train/dataset.py:59-63``)."""
    if "pre_frame_list" in data:
        return {
            "frames": list(zip(data["pre_frame_list"],
                               data["cur_frame_list"])),
            "flows": list(data["flow_list"]),
            "masks": list(data["mask_list"]),
        }
    return data


def load_video_pickle(path: str = "video_data.pickle") -> Dict:
    """The file the reference reads for --use_video
    (``train/dataset.py:541-542``).  Unpickling runs code: read only a file
    of your own."""
    import pickle

    with open(path, "rb") as f:
        return normalize_video_data(pickle.load(f))


class VideoDataset:
    """Frame pairs, forward flow and masks read from a zip archive
    (``train/dataset.py:38-219``).  `data` names the zip members in either
    schema of ``normalize_video_data``; `style_path` is a directory of
    ``.jpg`` files or a ``.zip`` of them (``train/dataset.py:65-78``)."""

    def __init__(self, load_size=288, fine_size=256, flip=True,
                 video_path="data/video.zip", style_path="data/style",
                 data: Optional[Dict] = None, seed: Optional[int] = None):
        self.zip_path = video_path
        self._zip = None  # opened at first read
        self.data = normalize_video_data(
            data or {"frames": [], "flows": [], "masks": []})
        self._style_zip = None
        if style_path.endswith(".zip"):
            self.style_zip_path = style_path
            with zipfile.ZipFile(style_path) as z:
                self.styles = sorted(n for n in z.namelist()
                                     if n.endswith(".jpg"))
        else:
            self.style_zip_path = None
            self.styles = sorted(glob.glob(os.path.join(style_path,
                                                        "*.jpg")))
        self.load_size, self.fine_size, self.flip = load_size, fine_size, flip
        self.rng = random.Random(seed)
        self._lock = threading.Lock()  # the reader threads share the zips

    def _member(self, member: str) -> bytes:
        with self._lock:
            if self._zip is None:
                self._zip = zipfile.ZipFile(self.zip_path)
            return self._zip.read(member)

    def _read_img(self, member: str) -> np.ndarray:
        return _cv2().imdecode(np.frombuffer(self._member(member), np.uint8),
                               1)

    def _read_style(self, name: str) -> np.ndarray:
        cv2 = _cv2()
        if self.style_zip_path is None:
            return cv2.imread(name)
        with self._lock:
            if self._style_zip is None:
                self._style_zip = zipfile.ZipFile(self.style_zip_path)
            buf = self._style_zip.read(name)
        return cv2.imdecode(np.frombuffer(buf, np.uint8), 1)

    def _read_flow(self, member: str, h: int, w: int) -> np.ndarray:
        """The reference's flow members are raw float32: a 32-float header,
        then H W 2 values (``train/dataset.py:162-164``); ``.npy`` is read
        too, and anything else is decoded as an image."""
        buf = self._member(member)
        if member.endswith(".npy"):
            return np.load(io.BytesIO(buf))
        arr = np.frombuffer(buf, np.float32)
        if arr.size == 32 + h * w * 2:
            return np.reshape(arr[32:], (h, w, 2))
        return _cv2().imdecode(np.frombuffer(buf, np.uint8), -1)

    def __len__(self):
        return len(self.data["frames"])

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        pre_name, cur_name = self.data["frames"][index]
        pre = self._read_img(pre_name)
        cur = self._read_img(cur_name)
        flow = self._read_flow(self.data["flows"][index],
                               cur.shape[0], cur.shape[1])
        # Occlusions are 255: validity is 1 - mask/255
        # (``train/dataset.py:166-168``).
        mask = 1.0 - self._read_img(self.data["masks"][index]) / 255.0
        out = _pair_item(self.rng, pre, cur, flow, mask, self.fine_size,
                         self.flip, "ForwardFlow", "ForwardMask")
        style = self._read_style(self.rng.choice(self.styles))
        out["Style"] = _style_item(self.rng, style, self.fine_size,
                                   self.load_size, self.flip)
        return out


class Loader:
    """Shuffled, batched, thread-prefetched epoch iterator: `num_workers`
    reader threads fill a bounded queue with stacked NHWC numpy batches."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 num_workers: int = 2, seed: int = 0, drop_last: bool = True):
        self.ds = dataset
        self.bs = batch_size
        self.shuffle = shuffle
        self.workers = max(num_workers, 1)
        self.seed = seed
        self.drop_last = drop_last
        self._epoch = 0

    def __len__(self):
        n = len(self.ds) // self.bs
        return n if self.drop_last else -(-len(self.ds) // self.bs)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        idx = list(range(len(self.ds)))
        if self.shuffle:
            random.Random(self.seed + self._epoch).shuffle(idx)
        self._epoch += 1

        batches: List[List[int]] = [
            idx[i:i + self.bs] for i in range(0, len(idx), self.bs)]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.bs]

        q: "queue.Queue" = queue.Queue(maxsize=4)
        stop = object()

        def worker(my_batches):
            # Always emit the stop sentinel, an exception included: a dead
            # worker must never deadlock the consumer.
            err = None
            try:
                for b in my_batches:
                    items = [self.ds[i] for i in b]
                    q.put({k: np.stack([it[k] for it in items])
                           for k in items[0]})
            except BaseException as e:  # noqa: BLE001 — re-raised below
                err = e
            q.put((stop, err))

        n_w = min(self.workers, max(len(batches), 1))
        shards = [batches[i::n_w] for i in range(n_w)]
        threads = [threading.Thread(target=worker, args=(s,), daemon=True)
                   for s in shards]
        for t in threads:
            t.start()
        done = 0
        while done < n_w:
            item = q.get()
            if isinstance(item, tuple) and len(item) == 2 and item[0] is stop:
                done += 1
                if item[1] is not None:
                    raise RuntimeError("data loader worker failed") \
                        from item[1]
            else:
                yield item


def get_loader(batch_size, load_size=288, fine_size=256, flip=True,
               content_path="./data/content/", style_path="./data/style/",
               num_workers=2, use_mpi=False, use_video=False,
               video_data: Optional[Dict] = None, seed: int = 0,
               video_pickle: str = "video_data.pickle") -> Loader:
    """Dataset factory (``train/dataset.py:531-552``): `content_path` is
    the MPI root under `use_mpi` and the video zip under `use_video`."""
    if use_mpi and use_video:
        raise ValueError("use_mpi and use_video are mutually exclusive")
    if use_mpi:
        ds = MPIDataset(load_size, fine_size, flip, content_path, style_path,
                        seed=seed)
    elif use_video:
        if video_data is None:
            # The reference reads this pickle for --use_video
            # (train/dataset.py:541-542).
            video_data = load_video_pickle(video_pickle)
        ds = VideoDataset(load_size, fine_size, flip, content_path,
                          style_path, data=video_data, seed=seed)
    else:
        ds = FrameDataset(load_size, fine_size, flip, content_path,
                          style_path, seed=seed)
    return Loader(ds, batch_size, shuffle=True, num_workers=num_workers,
                  seed=seed)
