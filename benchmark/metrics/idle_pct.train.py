"""idle_pct.train: the share of the untraced window in which no operation
would run on the card: the traced window's device busy time (the union of
the profiler's device intervals) per unit of work, times the untraced
window's work, over the untraced window's time.  The profiler slows the
host, so the traced window's own idle share reads high (PERF.md section
3).  Layer: device.  Moves train_images_per_s."""


def read(ctx):
    t, c, tc = ctx.trace, ctx.counters, ctx.traced_counters
    if t is None or t.busy_s <= 0 or not tc or not tc.get("work") \
            or not c.get("work") or c["window_s"] <= 0:
        return None
    busy = t.busy_s / tc["work"] * c["work"]
    return 100.0 * (1.0 - busy / c["window_s"])
