"""Training data and its loader (host side, numpy NHWC) —
``rerevst_tpu/data/datasets.py``.

* ``FrameDataset`` — COCO-style content jpgs x a random WikiArt-style jpg per
  sample: resize to load_size, a random fine_size crop, a random
  h / v / both flip at p = 0.25 each (``train/dataset.py:420-526``).
* ``Loader`` — a shuffled, batched, thread-prefetched epoch iterator in
  place of torch's DataLoader.
* ``get_loader`` — the dataset factory.

The same Python ``random``, numpy and cv2 calls in the same order as the JAX
package: for the same seed and files, one reader thread gives bit-identical
batches.  Batches are dicts of float32 NHWC arrays (``Content``,
``Style``), ImageNet-normalized.  The Figure-16 ablation datasets
(``MPIDataset``, ``VideoDataset``) are ROADMAP.md Queue 1 item 6b.
Reading images needs cv2, which the card's machine lacks: there the train
step takes batches made by other means.
"""

from __future__ import annotations

import glob
import os
import queue
import random
import threading
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
        out = {"Content": _process_img(content, self.fine_size,
                                       self.load_size, x1, y1, fr)}

        h, w, _ = style.shape
        ls = max(h, w, self.load_size)
        x1 = rng.randint(0, ls - self.fine_size)
        y1 = rng.randint(0, ls - self.fine_size)
        fr = rng.random() if self.flip else None
        out["Style"] = _process_img(style, self.fine_size, ls, x1, y1, fr)
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
               seed: int = 0) -> Loader:
    """Dataset factory (``train/dataset.py:531-552``)."""
    if use_mpi or use_video:
        raise NotImplementedError(
            "the MPI Sintel and video-pair datasets are not ported yet: "
            "ROADMAP.md Queue 1 item 6b (Figure-16 ablations)")
    ds = FrameDataset(load_size, fine_size, flip, content_path, style_path,
                      seed=seed)
    return Loader(ds, batch_size, shuffle=True, num_workers=num_workers,
                  seed=seed)
