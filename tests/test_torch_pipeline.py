"""Pass 2 of rerevst_torch's stylize_video keeps one batch in flight, as
rerevst_tpu's does: chunk k+1 is read, prepped, uploaded and launched
before chunk k is fetched, and only the worker thread touches the source.

On the CPU the same order runs with plain copies; the frames must equal,
bit for bit, those of the serial order (each chunk prepped, uploaded,
stylized, cropped, fetched and converted before the next is read), since
both run the same operations on the same tensors.
"""

import threading
from pathlib import Path

import numpy as np
import pytest

from flax import serialization

import torch_threads  # noqa: F401  (torch's threads in xdist workers)

from rerevst_torch.api import Stylization
from rerevst_torch.data.source import FrameSource
from rerevst_torch.data.transforms import model_to_bgr
from rerevst_torch.ops.image import crop_back

CKPT = Path(__file__).resolve().parent.parent / "models" / \
    "demo_plum_4000.msgpack"


def _clip(n, h=64, w=112, seed=0):
    rng = np.random.default_rng(seed)
    f = rng.uniform(0.05, 0.2, (3, 2))
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    return [np.clip(np.stack([128 + 100 * np.sin((xx + 3 * i) * f[c, 0]
                                                 + (yy + i) * f[c, 1] + c)
                              for c in range(3)], -1), 0, 255)
            .astype(np.uint8) for i in range(n)]


def _style(size=64):
    rng = np.random.default_rng(1)
    return (rng.random((size, size, 3)) * 255).astype(np.uint8)


class _Source(FrameSource):
    """An in-memory clip that records which thread reads each frame."""

    def __init__(self, frames):
        self.frames = frames
        self.readers = []

    def __len__(self):
        return len(self.frames)

    def __iter__(self):
        for f in self.frames:
            self.readers.append(threading.current_thread())
            yield f

    def read_indices(self, indices):
        for i in indices:
            yield self.frames[i]


@pytest.fixture(scope="module")
def params():
    return serialization.msgpack_restore(CKPT.read_bytes())


def _session(params, use_global):
    s = Stylization(params=params, device="cpu", use_global=use_global)
    s.prepare_style(_style())
    return s


def _instrument(s):
    """Log each launch and each fetch, in order, with its chunk index."""
    log = []
    stylize, fetch = s._stylize, s._fetch

    def _stylize(x):
        log.append(("launch", sum(e[0] == "launch" for e in log)))
        return stylize(x)

    def _fetch(out, *ready):
        log.append(("fetch", sum(e[0] == "fetch" for e in log)))
        return fetch(out, *ready)

    s._stylize, s._fetch = _stylize, _fetch
    return log


def _serial(s, frames, bs):
    """The serial order: one chunk end to end before the next is read."""
    out, n = [], len(frames)
    for i in range(0, n, bs):
        chunk = frames[i:i + bs]
        xs = s._prep_batch_host(chunk)
        if xs.shape[0] < bs and n > bs:
            xs = np.concatenate([xs, np.repeat(xs[-1:], bs - xs.shape[0], 0)])
        h, w = s._orig_hw
        host = s._fetch(crop_back(s._stylize(s._upload(xs))[:len(chunk)],
                                  h, w, s.infer.pad))
        out += [model_to_bgr(host[j:j + 1]) for j in range(len(chunk))]
    return out


@pytest.mark.parametrize("use_global", [True, False],
                         ids=["global", "per-frame"])
def test_next_chunk_launches_before_fetch(params, use_global):
    s = _session(params, use_global)
    src = _Source(_clip(10))
    log = _instrument(s)
    frames = list(s.stylize_video(src, batch_size=3))
    assert len(frames) == 10
    launches = [i for i, e in enumerate(log) if e[0] == "launch"]
    fetches = [i for i, e in enumerate(log) if e[0] == "fetch"]
    assert len(launches) == len(fetches) == 4
    for k in range(3):  # chunk k+1 launches before chunk k is fetched
        assert launches[k + 1] < fetches[k]
    assert log[-1] == ("fetch", 3)
    # Pass 2 reads the clip once, on the worker thread only.
    assert len(src.readers) == 10
    assert threading.main_thread() not in src.readers
    assert len(set(src.readers)) == 1


@pytest.mark.parametrize("use_global,n,bs", [(True, 10, 3), (False, 10, 3),
                                             (True, 4, 4), (True, 2, 4)])
def test_frames_equal_serial_order(params, use_global, n, bs):
    s = _session(params, use_global)
    clip = _clip(n)
    got = list(s.stylize_video(clip, batch_size=bs))
    want = _serial(s, clip, bs)  # under the statistics Pass 1 froze
    assert len(got) == len(want) == n
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_early_stop_and_source_errors(params):
    s = _session(params, False)
    gen = s.stylize_video(_clip(10), batch_size=3)
    first = [next(gen) for _ in range(4)]
    gen.close()  # joins the worker with a chunk in flight
    assert all(f.shape == (64, 112, 3) for f in first)

    class Broken(_Source):
        def __iter__(self):
            yield from self.frames[:3]
            raise OSError("disk gone")

    with pytest.raises(OSError, match="disk gone"):
        list(s.stylize_video(Broken(_clip(6)), batch_size=2))
