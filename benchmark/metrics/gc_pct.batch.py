"""Share of the window spent in Python's collector, in percent: the seconds of
the program's ``gc`` spans (one a collection, any generation) that end in the
window over the window's seconds."""


def read(rec):
    got = rec.spans.get("gc")
    return 100.0 * sum(got) / rec.window.seconds if got and rec.window.seconds else None
