"""Output tokens emitted inside the window over the window's seconds: one
token per running slot per decode step (host clock)."""


def read(ro):
    return sum(it.running for it in ro.window()) / ro.seconds
