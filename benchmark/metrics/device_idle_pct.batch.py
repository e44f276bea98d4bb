"""Share of the traced window in which no operation ran on the card, in
percent (``busy_s`` from the profiler's device timeline)."""


def read(rec):
    t = rec.trace
    return 100.0 * (1.0 - t.busy_s / t.window_s) if t.window_s else None
