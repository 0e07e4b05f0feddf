"""The share of the traced window in which no kernel, copy or fill runs on
the card (the mean over the cards used)."""
from rtbench.harness import busy_seconds


def read(tr):
    if tr["window_us"] is None or not tr["busy"]:
        return None
    window = (tr["window_us"][1] - tr["window_us"][0]) / 1e6
    return 100.0 * (1.0 - busy_seconds(tr) / window)
