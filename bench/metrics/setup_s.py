"""Process start to the window's opening: imports, kernel load (and build,
on a checkout's first run), weights, cache and warm-up (host clock)."""


def read(ro):
    return ro.setup_s
