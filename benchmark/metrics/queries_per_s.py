"""Questions answered in the window over the window's seconds (host clock)."""


def read(rec):
    n = rec.questions_done()
    return n / rec.window.seconds if n else None
