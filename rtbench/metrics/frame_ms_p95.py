"""The 95th percentile, over every frame of the window, of the frame
period in milliseconds: host clock from the start of one
``Engine.update`` to the start of the next, the last closed by the
window's ``synchronize``."""
import numpy as np


def read(rd):
    if not rd["periods"]:
        return None
    return float(np.quantile(np.asarray(rd["periods"]), 0.95)) * 1e3
