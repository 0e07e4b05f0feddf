"""Seconds from the process's start to the window's: imports, the scene
built from the configuration, instantiated and moved to the card, and
the warm frames (in a checkout's first run, the nvcc build too)."""


def read(rd):
    return rd["setup_s"]
