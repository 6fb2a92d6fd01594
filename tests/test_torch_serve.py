"""rerevst_torch.serve against rerevst_tpu.serve, over real sockets.

The same request script goes to the JAX server and the port's (both fp32,
``max_body_mb=1``, ``max_frames=4``): per request the status code, the
error type and the JSON keys must agree, and one real ``/video`` of a
3-frame clip must agree within 1 uint8 count (the two fp32 pipelines differ
by about 1e-6 of the pixel scale, which flips an occasional rounding).  The
rest of ``tests/test_serve.py`` is mirrored on the port alone: the two-pass
protocol, chunked and async clip sessions, the spool's locking and pruning,
the micro-batcher (its unit tests run on both packages' ``_MicroBatcher``,
which is pure Python), batched against unbatched frames and the boot warmup.

Fixtures: the bundled checkpoint upcast to fp32; content frames
``docs/demo_frame_{00,16,32}.jpg`` cropped to 64x96; ``docs/demo_style.jpg``
resized to 64x64.  Every ``urlopen`` and ``join`` has a timeout, every poll
a deadline, and every server shuts down in a finalizer.
"""

import importlib
import io
import json
import os
import queue
import re
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from flax import serialization

import torch_threads  # noqa: F401  (torch's threads in xdist workers)

from rerevst_torch import serve as port_serve
from rerevst_torch.api import Stylization
from rerevst_torch.config import InferenceConfig, ModelConfig, dtype_from_name
from rerevst_torch.multistyle import MultiStylization

cv2 = pytest.importorskip("cv2")

REPO = Path(__file__).resolve().parent.parent
TIMEOUT = 120  # seconds: every request and join


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    from rerevst_tpu.io.checkpoint import save_params

    def cast(node):
        if isinstance(node, dict):
            return {k: cast(v) for k, v in node.items()}
        return np.asarray(node, np.float32)

    tree = serialization.msgpack_restore(
        (REPO / "models" / "demo_plum_4000.msgpack").read_bytes())
    path = str(tmp_path_factory.mktemp("srv") / "fp32.msgpack")
    save_params(path, cast(tree))
    return path


@pytest.fixture(scope="module")
def clip():
    frames = [cv2.imread(str(REPO / "docs" / f"demo_frame_{i:02d}.jpg"))
              [:64, :96] for i in (0, 16, 32)]
    style = cv2.resize(cv2.imread(str(REPO / "docs" / "demo_style.jpg")),
                       (64, 64))
    return frames, style


@pytest.fixture
def start(request):
    """start(serve_fn, ckpt, **kw) -> url of a server on a free port, shut
    down when the test ends."""

    def _start(serve_fn, path, **kw):
        server = serve_fn(path, port=0, dtype="f32", **kw)
        t = threading.Thread(target=server.serve_forever, daemon=True)
        t.start()

        def stop():
            server.shutdown()
            server.server_close()
            t.join(TIMEOUT)

        request.addfinalizer(stop)
        host, port = server.server_address[:2]
        return f"http://{host}:{port}"

    return _start


def _port(path, **kw):
    return port_serve.serve(path, device="cpu", **kw)


def _req(url, body=None, method="POST"):
    """(status, body bytes, content type) of one request."""
    req = urllib.request.Request(url, data=body, method=method)
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
            return r.status, r.read(), r.headers.get("Content-Type")
    except urllib.error.HTTPError as e:
        return e.code, e.read(), e.headers.get("Content-Type")


def _get(url):
    return _req(url, method="GET")


def _png(img):
    ok, buf = cv2.imencode(".png", img)
    assert ok
    return buf.tobytes()


def _npz(frames, **extra):
    bio = io.BytesIO()
    np.savez(bio, **{f"f{i:05d}": f for i, f in enumerate(frames)}, **extra)
    return bio.getvalue()


def _frames(body):
    with np.load(io.BytesIO(body)) as z:
        return [z[k] for k in sorted(z.files)]


def _max_counts(a, b):
    assert len(a) == len(b)
    return max(int(np.abs(x.astype(np.int16) - y.astype(np.int16)).max())
               for x, y in zip(a, b))


def _local(ckpt, style, frames, interval):
    """The port's own session on the clip, as the service runs it."""
    s = Stylization(ckpt, use_global=True, device="cpu",
                    infer=InferenceConfig(sample_interval=interval,
                                          batch_size=min(len(frames), 8)))
    s.prepare_style(style)
    return list(s.stylize_video(frames))


# ---------------------------------------------------------------------------
# Protocol parity with the JAX server
# ---------------------------------------------------------------------------

def _script(clip):
    frames, style = clip
    return [
        ("healthz", "GET", "/healthz", None),
        ("metrics", "GET", "/metrics", None),
        ("stylize before style", "POST", "/stylize", _png(frames[0])),
        ("undecodable image", "POST", "/stylize", b"not an image"),
        ("unknown route", "POST", "/nope", b""),
        ("unknown GET route", "GET", "/nope", None),
        ("oversized body", "POST", "/stylize", b"\0" * (2 << 20)),
        ("clip before style", "POST", "/clip/open?interval=2", b""),
        ("interpolate before styles", "POST", "/interpolate",
         _npz(frames)),
        ("style", "POST", "/style", _png(style)),
        ("malformed npz", "POST", "/video", b"definitely not an npz"),
        ("too many frames", "POST", "/video", _npz([frames[0]] * 5)),
        ("wrong dtype", "POST", "/video",
         _npz([frames[0].astype(np.float32)])),
        ("mixed geometry", "POST", "/video",
         _npz([frames[0], frames[1][:32]])),
        ("unknown clip token", "POST", "/clip/nope/finish", b""),
        ("video", "POST", "/video?interval=2", _npz(frames)),
    ]


def _summary(status, body, ctype):
    """What must agree between the two servers for one reply."""
    out = {"status": status}
    if ctype == "application/json":
        data = json.loads(body)
        out["keys"] = sorted(data)
        if "error" in data:
            out["error_type"] = data["error"]["type"]
            out["error_keys"] = sorted(data["error"])
    elif ctype.startswith("text/plain"):
        out["series"] = sorted({line.split()[0].split("{")[0]
                                for line in body.decode().splitlines()
                                if line and not line.startswith("#")})
    else:
        out["ctype"] = ctype
    return out


WANT_STATUS = {"healthz": 200, "metrics": 200, "stylize before style": 409,
               "undecodable image": 400, "unknown route": 404,
               "unknown GET route": 404, "oversized body": 413,
               "clip before style": 409, "interpolate before styles": 409,
               "style": 200, "malformed npz": 400, "too many frames": 400,
               "wrong dtype": 400, "mixed geometry": 400,
               "unknown clip token": 409, "video": 200}


def test_protocol_parity_with_jax_server(ckpt, clip, start):
    from rerevst_tpu.serve import serve as jax_serve

    urls = {"jax": start(jax_serve, ckpt, max_body_mb=1, max_frames=4),
            "port": start(_port, ckpt, max_body_mb=1, max_frames=4)}
    replies = {k: [] for k in urls}
    for name, method, path, body in _script(clip):
        for k, url in urls.items():
            replies[k].append((name, *_req(url + path, body, method)))
    for (name, *a), (_, *b) in zip(replies["jax"], replies["port"]):
        assert _summary(*a) == _summary(*b), name
        assert a[0] == WANT_STATUS[name], (name, a[1][:200])
    # The one real clip: the same frames within 1 count.
    outs = {k: _frames(r[-1][2]) for k, r in replies.items()}
    assert [f.shape for f in outs["port"]] == [clip[0][0].shape] * 3
    assert _max_counts(outs["port"], outs["jax"]) <= 1
    port_hz = json.loads(replies["port"][0][2])
    assert port_hz == {"ok": True, "device": "cpu", "has_style": False,
                       "has_stats": False}


@pytest.mark.parametrize("kw,err,match", [
    ({"aot": "bundle", "use_global": False}, ValueError, "--no-global"),
    ({"aot": "missing.rvaot"}, FileNotFoundError, "missing.rvaot"),
    ({"mix": "tail"}, ValueError, "unknown fp32_mix"),
])
def test_unported_options_raise(ckpt, kw, err, match):
    """--no-global has no AOT path; --aot loads its bundle (a missing file
    raises; test_serve_aot_stylize serves one); an unknown --mix region
    raises (test_serve_mix_matches_direct_session serves 'out') and --tiles
    runs (test_serve_tiles_matches_untiled)."""
    with pytest.raises(err, match=match):
        _port(ckpt, **kw)


def _stylize_once(url, clip):
    """Style, one Pass-1 frame, then one /stylize of that frame: the
    decoded reply."""
    frames, style = clip
    assert _req(url + "/style", _png(style))[0] == 200
    assert _req(url + "/pass1?last=1", _png(frames[0]))[0] == 200
    status, body, _ = _req(url + "/stylize", _png(frames[0]))
    assert status == 200, body[:200]
    return cv2.imdecode(np.frombuffer(body, np.uint8), cv2.IMREAD_COLOR)


def test_serve_mix_matches_direct_session(ckpt, clip, start):
    """serve --dtype f16 --mix out: /stylize of a 64x96 frame within 1 count
    of a direct f16 session with fp32_mix='out' (its fp32 frames pass the
    service's uint8 conversion as they are)."""
    def f16(path, **kw):
        return _port(path, **dict(kw, dtype="f16"))

    got = _stylize_once(start(f16, ckpt, mix="out"), clip)
    frames, style = clip
    s = Stylization(ckpt, device="cpu",
                    cfg=ModelConfig(dtype=dtype_from_name("f16"),
                                    fp32_mix="out"))
    s.prepare_style(style)
    s.add(frames[0])
    s.compute()
    want = s.transfer(frames[0])
    assert got.shape == want.shape == frames[0].shape
    assert _max_counts([got], [want]) <= 1


def test_serve_tiles_matches_untiled(ckpt, clip, start):
    """serve --tiles 2: /stylize of a 64x96 frame (padded to 192x256, both
    regions tile) within 1 count of the untiled server's."""
    outs = [_stylize_once(start(_port, ckpt, tiles=t), clip) for t in (1, 2)]
    assert outs[0].shape == clip[0][0].shape
    assert np.abs(outs[0].astype(np.int16) - outs[1].astype(np.int16)).max() \
        <= 1


def test_serve_aot_stylize(ckpt, clip, start, tmp_path):
    """serve --aot: a CPU bundle of the fp32 session at the frame's padded
    geometry serves /stylize from its graph, with the eager server's
    frame."""
    from rerevst_torch.io.aot import save_bundle

    s = Stylization(ckpt, cfg=ModelConfig(dtype=dtype_from_name("f32")),
                    device="cpu")
    path = str(tmp_path / "pass2.rvaot")
    save_bundle(path, s, (192, 256), batches=(1,), platforms=("cpu",))
    servers = []

    def keep(path_, **kw):
        servers.append(_port(path_, **kw))
        return servers[-1]

    want = _stylize_once(start(_port, ckpt), clip)
    got = _stylize_once(start(keep, ckpt, aot=path), clip)
    assert servers[0].service.session.pass2_mode == "aot"
    assert np.array_equal(got, want)


def test_cli_flags_match_jax(capsys, monkeypatch):
    """The same flags as ``rerevst_tpu.serve``, plus ``--device``."""
    from rerevst_tpu import serve as jax_serve

    monkeypatch.setattr("rerevst_tpu.profiling.enable_compile_cache",
                        lambda: None)
    flags = {}
    for name, main in (("port", port_serve.main), ("jax", jax_serve.main)):
        with pytest.raises(SystemExit):
            main(["--help"])
        flags[name] = set(re.findall(r"^\s+(--[a-z][a-z-]*)",
                                     capsys.readouterr().out, re.M))
    assert flags["port"] == flags["jax"] | {"--device"}


def test_image_endpoints_without_cv2_answer_500(ckpt, start, monkeypatch):
    """Where OpenCV is missing (the card's machine), the image endpoints
    answer 500 with the ImportError; the .npz endpoints work."""

    def no_cv2(*a, **k):
        raise ImportError("the image endpoints need OpenCV (cv2)")

    monkeypatch.setattr(port_serve, "require_cv2", no_cv2)
    url = start(_port, ckpt)
    s, body, _ = _req(url + "/style", b"\x89PNG")
    assert s == 500
    assert json.loads(body)["error"]["type"] == "ImportError"
    s, _, _ = _get(url + "/healthz")
    assert s == 200


# ---------------------------------------------------------------------------
# The port alone (the cases of tests/test_serve.py)
# ---------------------------------------------------------------------------

def test_healthz_and_metrics(ckpt, start):
    url = start(_port, ckpt)
    for _ in range(2):
        assert _get(url + "/healthz")[0] == 200
    s, body, ctype = _get(url + "/metrics")
    assert s == 200 and ctype.startswith("text/plain")
    text = body.decode()
    assert "rerevst_uptime_seconds" in text
    assert "rerevst_open_clip_sessions 0" in text
    m = re.search(r'rerevst_requests_total\{endpoint="healthz"\} (\d+)',
                  text)
    assert m and int(m.group(1)) >= 2, text
    assert 'rerevst_session_ready{part="style"} 0' in text


def test_two_pass_protocol_over_http(ckpt, clip, start):
    """/style, /pass1 over the clip, /stylize: the frame a local session
    gives after the same calls."""
    frames, style = clip
    url = start(_port, ckpt)
    assert _req(url + "/style", _png(style))[0] == 200
    for i, f in enumerate(frames):
        last = "1" if i == len(frames) - 1 else "0"
        assert _req(url + f"/pass1?last={last}", _png(f))[0] == 200
    s, body, ctype = _req(url + "/stylize", _png(frames[1]))
    assert s == 200 and ctype == "image/png"
    out = cv2.imdecode(np.frombuffer(body, np.uint8), cv2.IMREAD_COLOR)
    local = Stylization(ckpt, device="cpu")
    local.prepare_style(style)
    for f in frames:
        local.add(f)
    local.compute()
    np.testing.assert_array_equal(out, local.transfer(frames[1]))


def test_video_and_interpolate_over_http(ckpt, clip, start):
    """/video equals the session's stylize_video; /styles + /interpolate
    equal MultiStylization on the same frames and weights."""
    frames, style = clip
    url = start(_port, ckpt)
    _req(url + "/style", _png(style))
    s, body, _ = _req(url + "/video?interval=2", _npz(frames))
    assert s == 200
    want = _local(ckpt, style, frames, 2)
    for a, b in zip(_frames(body), want):
        np.testing.assert_array_equal(a, b)

    style2 = frames[1][:64, :64]
    s, body, _ = _req(url + "/styles", _npz([style, style2]))
    assert s == 200 and json.loads(body)["styles"] == 2
    weights = np.asarray([[1.0, 0.0], [0.5, 0.5], [0.0, 1.0]], np.float32)
    s, body, _ = _req(url + "/interpolate", _npz(frames, weights=weights))
    assert s == 200, body
    outs = _frames(body)
    ms = MultiStylization(ckpt, device="cpu")
    ms.prepare_styles([style, style2])
    want = list(ms.interpolate_video(frames, weights=weights.tolist()))
    for a, b in zip(outs, want):
        np.testing.assert_array_equal(a, b)
    assert np.abs(outs[0].astype(int) - outs[2].astype(int)).mean() > 0.2
    s, body, _ = _req(url + "/interpolate",
                      _npz([frames[0]], weights=np.ones((5, 2), np.float32)))
    assert s == 400 and "weights shape" in json.loads(body)["error"]["message"]


def test_chunked_clip_session_exceeds_body_cap(ckpt, clip, start):
    """A clip above the body cap streams through the /clip protocol (every
    request under the cap) and equals the local pipeline frame for frame;
    /result reads in two ranges; a closed session is gone."""
    frames3, style = clip
    frames = frames3 * 2
    cap_mb = 0.05
    cap = int(cap_mb * (1 << 20))
    assert len(_npz(frames)) > cap, "fixture must exceed the body cap"
    url = start(_port, ckpt, max_body_mb=cap_mb, max_frames=64)
    assert _req(url + "/style", _png(style))[0] == 200
    s, body, _ = _req(url + "/clip/open?interval=2", b"")
    assert s == 200
    token = json.loads(body)["clip"]
    for i in range(0, len(frames), 2):
        chunk = _npz(frames[i:i + 2])
        assert len(chunk) <= cap
        s, body, _ = _req(url + f"/clip/{token}/frames", chunk)
        assert s == 200, body
    assert json.loads(body)["received"] == len(frames)
    s, body, _ = _req(url + f"/clip/{token}/finish", b"")
    assert s == 200, body
    assert json.loads(body) == {"frames": len(frames), "pass1": "batched"}
    outs = []
    for first in (0, 4):
        s, body, _ = _get(url + f"/clip/{token}/result?start={first}&count=4")
        assert s == 200
        outs += _frames(body)
    assert _req(url + f"/clip/{token}/close", b"")[0] == 200
    assert _req(url + f"/clip/{token}/finish", b"")[0] == 409
    want = _local(ckpt, style, frames, 2)
    assert len(outs) == len(want)
    for a, b in zip(outs, want):
        np.testing.assert_array_equal(a, b)


def test_async_clip_finish_polls_to_done(ckpt, clip, start):
    """finish?async=1 answers 202 at once; /status reports progress to
    done; frames cannot be appended meanwhile; the result equals the
    synchronous finish's."""
    frames, style = clip
    url = start(_port, ckpt, max_frames=16)

    def run_clip(async_mode):
        token = json.loads(_req(url + "/clip/open?interval=2", b"")[1])["clip"]
        assert _req(url + f"/clip/{token}/frames", _npz(frames))[0] == 200
        if async_mode:
            s, body, _ = _req(url + f"/clip/{token}/finish?async=1", b"")
            assert s == 202 and json.loads(body)["started"] is True
            s, body, _ = _req(url + f"/clip/{token}/frames", _npz(frames))
            assert s == 409, body
            deadline = time.monotonic() + TIMEOUT
            while True:
                st = json.loads(_get(url + f"/clip/{token}/status")[1])
                if st["status"] == "done":
                    assert st["progress"] == len(frames) and st["done"]
                    break
                assert st["status"] == "running", st
                assert time.monotonic() < deadline, "async finish hung"
                time.sleep(0.05)
        else:
            assert _req(url + f"/clip/{token}/finish", b"")[0] == 200
        s, body, _ = _get(url + f"/clip/{token}/result?start=0&count=8")
        assert s == 200
        _req(url + f"/clip/{token}/close", b"")
        return _frames(body)

    assert _req(url + "/style", _png(style))[0] == 200
    sync_outs = run_clip(False)
    async_outs = run_clip(True)
    assert len(async_outs) == len(sync_outs) == len(frames)
    for a, b in zip(async_outs, sync_outs):
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def spool_service(ckpt):
    """A service for spool-layer unit tests (no device work: the style
    slot is stubbed so clip_open passes its check; no finish runs)."""
    svc = port_serve.StylizeService(ckpt, dtype="f32", device="cpu")
    svc.session.style = object()
    return svc


def test_concurrent_clip_frames_lose_no_frames(spool_service):
    svc = spool_service
    token = svc.clip_open(interval=8)
    frame = np.full((8, 8, 3), 7, np.uint8)
    n_threads, chunks, per_chunk = 8, 4, 2
    errs = []

    def upload():
        try:
            for _ in range(chunks):
                svc.clip_frames(token, [frame] * per_chunk, max_frames=1024)
        except Exception as e:  # pragma: no cover - failure path
            errs.append(e)

    ts = [threading.Thread(target=upload, daemon=True)
          for _ in range(n_threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(TIMEOUT)
        assert not t.is_alive()
    assert not errs
    total = n_threads * chunks * per_chunk
    clip = svc._clip(token)
    assert clip["n"] == total
    names = {f"frame_{i:06d}.npy" for i in range(total)}
    assert names <= set(os.listdir(clip["dir"]))
    svc.clip_close(token)
    assert not os.path.exists(clip["dir"])


def test_abandoned_clip_sessions_are_pruned(spool_service):
    svc = spool_service
    stale_tok = svc.clip_open(interval=8)
    stale_dir = svc._clip(stale_tok)["dir"]
    assert os.path.isdir(stale_dir)
    svc.clips[stale_tok]["ts"] -= svc.CLIP_TTL_S + 1  # age it out
    fresh_tok = svc.clip_open(interval=8)
    assert stale_tok not in svc.clips
    assert not os.path.exists(stale_dir)
    svc.MAX_OPEN_CLIPS = len(svc.clips)  # instance override for the test
    try:
        with pytest.raises(RuntimeError, match="too many open clip"):
            svc.clip_open(interval=8)
    finally:
        del svc.MAX_OPEN_CLIPS
        svc.clip_close(fresh_tok)


# ---------------------------------------------------------------------------
# The micro-batcher, both packages
# ---------------------------------------------------------------------------

BATCHERS = ["rerevst_tpu.serve", "rerevst_torch.serve"]


def _batcher(module):
    return importlib.import_module(module)._MicroBatcher


def _submit_all(submit, frames):
    """submit(frame) for every frame at once, each on its own thread."""
    outs = [None] * len(frames)
    barrier = threading.Barrier(len(frames), timeout=TIMEOUT)

    def call(i):
        barrier.wait()
        outs[i] = submit(frames[i])

    ts = [threading.Thread(target=call, args=(i,), daemon=True)
          for i in range(len(frames))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(TIMEOUT)
        assert not t.is_alive()
    return outs


@pytest.mark.parametrize("module", BATCHERS)
def test_microbatcher_coalesces_and_maps_results(module):
    b = _batcher(module)(lambda frames, pad_to=0: [f + 1 for f in frames],
                         window_s=0.2, max_batch=8)
    frames = [np.full((4, 4, 3), i, np.int32) for i in range(6)]
    outs = _submit_all(b.submit, frames)
    for o, f in zip(outs, frames):
        np.testing.assert_array_equal(o, f + 1)
    assert sum(b.calls) == 6
    assert max(b.calls) > 1, f"nothing coalesced: {b.calls}"

    def boom(frames, pad_to=0):
        raise RuntimeError("no stats")

    with pytest.raises(RuntimeError, match="no stats"):
        _batcher(module)(boom, window_s=0.01).submit(frames[0])


@pytest.mark.parametrize("module", BATCHERS)
def test_microbatcher_groups_by_shape(module):
    sizes = []

    def fn(frames, pad_to=0):
        sizes.append({f.shape for f in frames})
        return [f * 2 for f in frames]

    b = _batcher(module)(fn, window_s=0.2, max_batch=8)
    frames = ([np.ones((4, 4, 3), np.int32)] * 2
              + [np.ones((6, 4, 3), np.int32)] * 2)
    outs = _submit_all(b.submit, frames)
    for o, f in zip(outs, frames):
        np.testing.assert_array_equal(o, f * 2)
    assert all(len(s) == 1 for s in sizes), f"mixed-shape call: {sizes}"


@pytest.mark.parametrize("module", BATCHERS)
def test_microbatcher_bucket_respects_batch_max(module):
    pads = []

    def fn(frames, pad_to=0):
        pads.append((len(frames), pad_to))
        return [f + 1 for f in frames]

    b = _batcher(module)(fn, window_s=0.3, max_batch=6)
    frames = [np.full((4, 4, 3), i, np.int32) for i in range(6)]
    outs = _submit_all(b.submit, frames)
    for o, f in zip(outs, frames):
        np.testing.assert_array_equal(o, f + 1)
    assert all(p <= 6 for _, p in pads), f"bucket exceeded batch-max: {pads}"
    assert all(p >= n and (p == 6 or p & (p - 1) == 0) for n, p in pads)
    assert sum(n for n, _ in pads) == 6
    assert b.n_frames == 6 and b.n_calls == len(pads)


@pytest.mark.parametrize("module", BATCHERS)
def test_microbatcher_dead_worker_raises_instead_of_hanging(module,
                                                            monkeypatch):
    cls = _batcher(module)
    b = cls.__new__(cls)
    b.q = queue.Queue()
    dead = threading.Thread(target=lambda: None)
    dead.start()
    dead.join(TIMEOUT)
    b._thread = dead
    monkeypatch.setattr(cls, "WAIT_POLL_S", 0.05)
    with pytest.raises(RuntimeError, match="worker thread died"):
        b.submit(np.zeros((2, 2, 3), np.uint8))


# ---------------------------------------------------------------------------
# The service's batched path and its warmup
# ---------------------------------------------------------------------------

def _two_pass_service(ckpt, clip, **kw):
    frames, style = clip
    svc = port_serve.StylizeService(ckpt, dtype="f32", device="cpu", **kw)
    svc.set_style(style)
    for i, f in enumerate(frames):
        svc.pass1(f, last=i == len(frames) - 1)
    return svc


def test_batched_stylize_service_matches_unbatched(ckpt, clip):
    """Concurrent /stylize calls through the micro-batcher (one batched
    call, padded to a bucket) give the frames of the plain per-request
    path, byte for byte, as in the JAX package's test."""
    frames, _ = clip
    plain_svc = _two_pass_service(ckpt, clip)
    assert plain_svc.batcher is None
    plain = [plain_svc.stylize(f) for f in frames]
    svc = _two_pass_service(ckpt, clip, batch_window_ms=500.0)
    batched = _submit_all(svc.stylize, frames)
    for a, b in zip(plain, batched):
        np.testing.assert_array_equal(a, b)
    assert sum(svc.batcher.calls) == len(frames)
    assert max(svc.batcher.calls) > 1, svc.batcher.calls
    assert "rerevst_microbatch_frames_total 3" in svc.metrics()


def test_boot_warmup_leaves_clean_session_and_identical_results(ckpt, clip):
    """warmup runs the real session (and, micro-batching on, each batch
    bucket), then resets it: healthz claims no style, and the next clip
    gives the frames of a never-warmed service."""
    frames, _ = clip

    def run(warm):
        svc = port_serve.StylizeService(ckpt, dtype="f32", device="cpu",
                                        batch_window_ms=1.0, batch_max=4)
        if warm:
            assert svc.warmup(frames[0].shape[:2]) > 0
            hz = svc.healthz()
            assert not hz["has_style"] and not hz["has_stats"]
        _, style = clip
        svc.set_style(style)
        for i, f in enumerate(frames):
            svc.pass1(f, last=i == len(frames) - 1)
        return svc.stylize(frames[0])

    np.testing.assert_array_equal(run(warm=True), run(warm=False))
