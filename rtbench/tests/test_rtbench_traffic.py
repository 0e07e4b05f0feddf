"""The traffic generator: deterministic in the seed, every seed the same
set of turns."""
import numpy as np

from rtbench import traffic


def deltas(seed, n=64):
    mouse = traffic.Mouse(traffic.load("orbit1440")["mouse"], seed)
    return [mouse.next() for _ in range(n)]


def test_same_seed_same_deltas():
    assert deltas(2 ** 31 + 12345) == deltas(2 ** 31 + 12345)
    assert deltas(1) != deltas(2)


def test_every_seed_sends_the_same_set_of_turns():
    mix = traffic.load("orbit1440")["mouse"]
    n = mix["block"]
    for seed in (0, 99, 2 ** 33 + 1):
        d = np.asarray(deltas(seed, 4 * n))
        for b in range(4):
            blk = d[b * n:(b + 1) * n]
            assert sorted(blk[:, 0]) == sorted(mix["dx"])
            assert sorted(np.abs(blk[0::2, 1])) == sorted(mix["dy_pairs"])
            assert (blk[1::2, 1] == -blk[0::2, 1]).all()
            assert 2 <= blk[:, 0].min() and blk[:, 0].max() <= 12
            assert np.abs(blk[:, 1]).max() <= 2


def test_still_sends_nothing():
    assert "mouse" not in traffic.load("still")


def test_params_are_the_defaults_the_size_and_the_mixs_own():
    assert traffic.params(traffic.load("still")) == dict(width=1920,
                                                         height=1080)
    assert traffic.params(traffic.load("orbit1440")) == dict(width=2560,
                                                             height=1440)
    assert traffic.params(traffic.load("orbit1440"), (64, 36)) == \
        dict(width=64, height=36)
    mix = dict(params=dict(bounces=2, skybox=False))
    assert traffic.params(mix, (16, 9)) == dict(width=16, height=9,
                                                bounces=2, skybox=False)
