"""Frozen copies of the yardstick: what the benchmark measures with must
not move when the program changes. Each module says where it was copied
from."""
