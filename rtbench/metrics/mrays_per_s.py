"""Millions of exact traced path segments a second: every segment of the
frames of the window (the kernels' int64 counts, summed on the card after
the window's closing ``synchronize``) over the window's wall seconds."""


def read(rd):
    if not rd["window_s"]:
        return None
    return rd["segments"] / rd["window_s"] / 1e6
