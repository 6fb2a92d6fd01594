"""Frame readers and the video writer (host side) — ``rerevst_tpu/data/video.py``.

Glob'd frame files and container video files in, PNG frames and an MJPG
``.avi`` out, all through OpenCV.  cv2 is imported only where a frame is
read or written, so the rest of the package, and in-memory clips, run
without it.
"""

from __future__ import annotations

import glob
import os
from typing import Iterator, List

import numpy as np


def require_cv2(purpose: str = "frame and video file I/O",
                instead: str = "pass in-memory frames (BGR uint8 arrays)"):
    """The ``cv2`` module, or an ImportError that says what needed it and
    what to do instead."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError(f"{purpose} needs OpenCV (cv2), which is not "
                          f"installed; {instead} instead") from e
    return cv2


def list_frames(pattern: str) -> List[str]:
    return sorted(glob.glob(pattern))


def read_frame(path: str) -> np.ndarray:
    """BGR uint8 HWC, like the reference's read_img."""
    img = require_cv2().imread(path)
    if img is None:
        raise FileNotFoundError(path)
    return img


def iter_frames(pattern: str) -> Iterator[np.ndarray]:
    for p in list_frames(pattern):
        yield read_frame(p)


#: Extensions treated as container video files (the reference reads only
#: frame directories).
VIDEO_EXTS = (".avi", ".mp4", ".mov", ".mkv", ".webm", ".m4v")


def is_video_file(path: str) -> bool:
    return (os.path.splitext(path)[1].lower() in VIDEO_EXTS
            and os.path.isfile(path))


def iter_video(path: str, max_frames: int = 0) -> Iterator[np.ndarray]:
    """Stream BGR uint8 frames from a video file, one decoded frame in memory
    at a time."""
    cv2 = require_cv2()
    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise FileNotFoundError(f"cannot open video {path!r}")
    n = 0
    try:
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            yield frame
            n += 1
            if max_frames and n >= max_frames:
                break
    finally:
        cap.release()
    if n == 0:
        raise ValueError(f"no decodable frames in {path!r}")


def read_video(path: str, max_frames: int = 0) -> List[np.ndarray]:
    """Decode a video file into BGR uint8 frames (all of them by default);
    for long videos prefer ``iter_video`` or ``data.source.VideoSource``."""
    return list(iter_video(path, max_frames))


def write_frame(path: str, img_bgr: np.ndarray) -> None:
    cv2 = require_cv2()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    cv2.imwrite(path, img_bgr)


class VideoWriter:
    """Incremental video writer: opens on the first frame, so a streaming
    pipeline writes as it goes."""

    def __init__(self, path: str, fps: int = 24, codec: str = "MJPG"):
        self.path, self.fps, self.codec = path, fps, codec
        self._writer = None

    def write(self, frame_bgr: np.ndarray) -> None:
        if self._writer is None:
            cv2 = require_cv2()
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            self._writer = cv2.VideoWriter(
                self.path, cv2.VideoWriter_fourcc(*self.codec), self.fps,
                (frame_bgr.shape[1], frame_bgr.shape[0]))
        self._writer.write(frame_bgr)

    def close(self) -> None:
        if self._writer is not None:
            self._writer.release()
            self._writer = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def write_video(path: str, frames_bgr, fps: int = 24,
                codec: str = "MJPG") -> None:
    """Write BGR uint8 frames to a video file (MJPG .avi at 24 fps by
    default, as the reference writes its results)."""
    with VideoWriter(path, fps=fps, codec=codec) as w:
        for f in frames_bgr:
            w.write(f)
