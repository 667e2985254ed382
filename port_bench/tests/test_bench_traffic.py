"""The traffic generator: the same seed gives the same inputs, and every
seed gives every fleet the same lengths in another order."""

import numpy as np
import pytest

from port_bench import spec
from port_bench import traffic as tr


def _cell(name):
    return spec.load_cell(name)


@pytest.mark.parametrize("name", ["arctic-sd.decode-b32",
                                  "ljspeech-sd.decode-b256"])
def test_fleets_hold_the_quantile_multiset(name):
    cell = _cell(name)
    cfg, traffic = cell.config, cell.traffic
    frames = tr.fleet_frames(traffic, cfg)
    want = sorted(int(f) * cfg["upsampling_factor"] - 1 for f in frames)
    seen = set()
    for seed in (0, 7, 2 ** 31 + 5, 2 ** 40 + 3):
        for i in range(3):
            ids, (x, h, n) = tr.fleet(traffic, cfg, seed, i)
            assert sorted(n) == want
            assert len(ids) == len(set(ids)) == cfg["decode_batch_size"]
            assert x.shape == (cfg["decode_batch_size"], 1)
            assert (x == cell.arch.seed_class(cfg)).all()
            for b, nb in enumerate(n):
                f = (nb + 1) // cfg["upsampling_factor"]
                assert not h[b, f:].any() and h[b, :f].any()
            seen.add(tuple(n))
    assert len(seen) > 1          # the seed permutes the rows


def test_fleets_repeat_per_seed():
    cell = _cell("arctic-sd.decode-b32")
    a = tr.fleet(cell.traffic, cell.config, 2 ** 31 + 9, 1)
    b = tr.fleet(cell.traffic, cell.config, 2 ** 31 + 9, 1)
    c = tr.fleet(cell.traffic, cell.config, 2 ** 31 + 10, 1)
    assert a[1][2] == b[1][2]
    np.testing.assert_array_equal(a[1][1], b[1][1])
    assert not np.array_equal(a[1][1], c[1][1])


def test_arctic_lengths_are_the_issue_s_quantiles():
    cell = _cell("arctic-sd.decode-b32")
    frames = tr.fleet_frames(cell.traffic, cell.config)
    # median 2.9 s, sigma 0.25: the longest quantile (0.984) is 4.97 s
    assert frames.max() * 80 - 1 == 79519
    assert abs(np.median(frames) / 200 - 2.9) < 0.05


def test_ljspeech_durations_have_the_published_range_and_mean():
    cell = _cell("ljspeech-sd.decode-b256")
    q = (np.arange(20000) + 0.5) / 20000
    d = tr._quantiles(cell.traffic["durations"], q)
    assert 1.11 <= d.min() and d.max() <= 10.10
    assert abs(d.mean() - 6.57) < 0.02
    # the configuration's cut, listed in its reduced
    assert cell.config["duration_scale"] == 0.125
    assert "duration_scale" in cell.config["reduced"]
    secs = tr.fleet_frames(cell.traffic, cell.config) * 110 / 22050
    assert 0.16 <= secs.min() and secs.max() <= 1.27


def test_a_duration_table_gives_its_quantiles():
    table = dict(dist="table", s=[4.0, 1.0, 3.0, 2.0])
    np.testing.assert_allclose(tr._quantiles(table, np.array([0.0, 0.5, 1.0])),
                               [1.0, 2.5, 4.0])


@pytest.mark.parametrize("name", ["arctic-sd.train-t23040",
                                  "arctic-sd.train-dp4"])
def test_train_windows(name):
    cell = _cell(name)
    cfg, traffic = cell.config, cell.traffic
    T = tr.window_length(cfg)
    assert T == 23040
    x, h, t = tr.train_window(cfg, 2 ** 31 + 1, 3)
    assert x.shape == t.shape == (T,)
    assert h.shape == (T // cfg["upsampling_factor"], cfg["n_aux"])
    np.testing.assert_array_equal(x[1:], t[:-1])
    assert x.min() >= 0 and x.max() < cfg["n_quantize"]
    x2, h2, _t2 = tr.train_window(cfg, 2 ** 31 + 1, 3)
    np.testing.assert_array_equal(x, x2)
    np.testing.assert_array_equal(h, h2)
    # every rank's windows differ from every other's
    idx = {tr.window_index(traffic, r, s) for r in range(traffic["ranks"])
           for s in range(tr.WINDOWS_PER_RANK)}
    assert len(idx) == traffic["ranks"] * tr.WINDOWS_PER_RANK
    assert cfg["batch_size"] == traffic["ranks"]
