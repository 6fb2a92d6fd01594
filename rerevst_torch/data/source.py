"""Frame sources: streaming and sampled access to a clip's frames —
``rerevst_tpu/data/source.py``.

A ``FrameSource`` gives an in-memory list, a glob of frame files (image
files through cv2, or ``.npy`` arrays) and a container video file the same
three operations:

* ``len(source)``       — the frame count (Pass 1 samples every
  ``interval``-th frame plus the last);
* ``iter(source)``      — the frames in order, decoded lazily (Pass 2);
* ``read_indices(ix)``  — only the sampled frames, one at a time (Pass 1).

``Stylization.stylize_video`` takes any of them (plain sequences are
wrapped), so a clip on disk never has to fit in memory.
"""

from __future__ import annotations

from typing import Iterator, Sequence, Union

import numpy as np

from rerevst_torch.data import video


class FrameSource:
    """Length, ordered iteration, and access by non-decreasing index."""

    def __len__(self) -> int:
        raise NotImplementedError

    def __iter__(self) -> Iterator[np.ndarray]:
        raise NotImplementedError

    def read_indices(self, indices: Sequence[int]) -> Iterator[np.ndarray]:
        """Yield the frames at `indices` (non-decreasing), one at a time, by
        a single sequential scan; sources with cheap random access
        override it."""
        want = list(indices)
        if any(b < a for a, b in zip(want, want[1:])):
            raise ValueError("indices must be non-decreasing")
        it = iter(self)
        cur, cur_i = None, -1
        for idx in want:
            while cur_i < idx:
                cur = next(it)
                cur_i += 1
            yield cur


class ListSource(FrameSource):
    """In-memory frames."""

    def __init__(self, frames: Sequence[np.ndarray]):
        self._frames = frames

    def __len__(self) -> int:
        return len(self._frames)

    def __iter__(self) -> Iterator[np.ndarray]:
        return iter(self._frames)

    def read_indices(self, indices: Sequence[int]) -> Iterator[np.ndarray]:
        for i in indices:
            yield self._frames[i]


class PathsSource(FrameSource):
    """One image file per frame (the reference's input layout)."""

    def __init__(self, paths: Sequence[str]):
        self.paths = list(paths)

    @staticmethod
    def read(path: str) -> np.ndarray:
        return video.read_frame(path)

    def __len__(self) -> int:
        return len(self.paths)

    def __iter__(self) -> Iterator[np.ndarray]:
        for p in self.paths:
            yield self.read(p)

    def read_indices(self, indices: Sequence[int]) -> Iterator[np.ndarray]:
        for i in indices:
            yield self.read(self.paths[i])


class NpySource(PathsSource):
    """One ``.npy`` file per frame (BGR uint8 HxWx3): a lossless spool that
    needs no image codec (the serving layer's clip sessions)."""

    @staticmethod
    def read(path: str) -> np.ndarray:
        return np.load(path)


class VideoSource(FrameSource):
    """A container video file, decoded lazily.  Every access is a fresh
    sequential pass (seeking is codec-dependent, a scan is exact); ``len``
    counts frames with ``grab()``, which decodes nothing (the container's
    frame-count field is only a hint)."""

    def __init__(self, path: str):
        self.path = path
        self._n = None

    def __len__(self) -> int:
        if self._n is None:
            cap = video.require_cv2().VideoCapture(self.path)
            if not cap.isOpened():
                raise FileNotFoundError(f"cannot open video {self.path!r}")
            n = 0
            try:
                while cap.grab():
                    n += 1
            finally:
                cap.release()
            if n == 0:
                raise ValueError(f"no decodable frames in {self.path!r}")
            self._n = n
        return self._n

    def __iter__(self) -> Iterator[np.ndarray]:
        return video.iter_video(self.path)


def as_source(obj: Union[FrameSource, str, Sequence[np.ndarray]]
              ) -> FrameSource:
    """A FrameSource as it is; a str is a video file or a frame glob;
    anything else an in-memory sequence."""
    if isinstance(obj, FrameSource):
        return obj
    if isinstance(obj, str):
        if video.is_video_file(obj):
            return VideoSource(obj)
        paths = video.list_frames(obj)
        if not paths:
            raise FileNotFoundError(f"no frames match {obj!r}")
        return PathsSource(paths)
    return ListSource(obj)
