#!/usr/bin/env python3
"""``chip_smoke.py``'s phase distributed alone, on whatever cards the
machine has (2 and 4 shards: the first cards, or logical shards of cuda:0),
after the three sessions it compares against (global f16, fp32 and f16
pair-lane on the 33-frame 512x512 clip) and the train phases' generator.

    python3 scripts/chip_distributed.py

Prints the phase's JSON lines (the card's name and power limit first) and
the launches per mesh path; fails as the phase does.  With four cards,
``python3 -m rerevst_torch.parallel.dryrun 4 --device cuda`` and
``--processes 4 --device cuda`` run the dry runs over four cards in one
process and over four NCCL ranks.
"""

import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(HERE))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_distributed: CUDA is not available", file=sys.stderr)
        return 2
    from rerevst_torch.api import Stylization
    from rerevst_torch.config import ModelConfig
    from rerevst_torch.kernels import _build

    t0 = time.perf_counter()
    print(cs.nvidia_smi(), torch.cuda.device_count(), flush=True)
    _build.library()
    ckpt = str(HERE / "models" / "demo_plum_4000.msgpack")
    clip = cs.synth_clip(cs.CLIP_FRAMES, cs.CONTENT, cs.CONTENT, seed=0)
    style = cs.synth_style(cs.CONTENT, cs.CONTENT, seed=1)
    sessions = {}
    for key, dtype, pl in (("f16", torch.float16, False),
                           ("fp32", torch.float32, False),
                           ("f16_pairlane", torch.float16, True)):
        s = Stylization(ckpt, cfg=ModelConfig(dtype=dtype, pairlane=pl),
                        device="cuda")
        s.prepare_style(style)
        list(s.stylize_video(clip, batch_size=cs.BATCH))
        sessions[key] = s
    host, _ = cs.train_host_params(torch)
    print("setup_s", time.perf_counter() - t0, flush=True)
    res = cs.distributed_phase(torch, sessions, host)
    print("launches", res["launches"], flush=True)
    print("total_s", time.perf_counter() - t0, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
