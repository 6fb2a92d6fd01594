"""first_frame_ms.infer: the benchmark's own host span from a clip being
handed to ``stylize_video`` to its first yielded frame (Pass 1 and the
pipeline's ramp), median over the window's clips.  Layer: session.  Moves
frames_per_s."""

import statistics


def read(ctx):
    spans = ctx.counters.get("first_frame_ms") or []
    return statistics.median(spans) if spans else None
