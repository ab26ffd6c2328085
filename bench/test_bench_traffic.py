"""The traffic files and the generator: determinism, clipping, the
768-token cap of the program's pages, and arrivals."""
import numpy as np
import pytest

from bench import manifest as mf, traffic

MIXES = sorted(p.stem for p in (mf.BENCH / "traffic").glob("*.json"))


@pytest.mark.parametrize("name", MIXES)
def test_mix_sizes_are_fixed_and_clipped(name):
    mix = mf.load_traffic(name)
    t1, p1, o1 = traffic.arrays(mix, 35)
    t2, p2, o2 = traffic.arrays(mix, 35)
    assert np.array_equal(t1, t2) and np.array_equal(p1, p2) \
        and np.array_equal(o1, o2)
    assert p1.min() >= mix["prompt"]["min"]
    assert p1.max() <= mix["prompt"]["max"]
    assert o1.min() >= mix["output"]["min"]
    assert o1.max() <= mix["output"]["max"]
    assert (p1 + o1).max() <= traffic.MAX_TOTAL
    assert len(t1) >= 20


@pytest.mark.parametrize("name", MIXES)
def test_prompts_follow_the_seed(name):
    mix = mf.load_traffic(name)
    a = traffic.requests(mix, 10, 2 ** 31 + 5, 1000)
    b = traffic.requests(mix, 10, 2 ** 31 + 5, 1000)
    c = traffic.requests(mix, 10, 7, 1000)
    assert [r.prompt for r in a] == [r.prompt for r in b]
    assert [r.prompt for r in a] != [r.prompt for r in c]
    assert [r.prompt_len for r in a] == [r.prompt_len for r in c]
    for r in a:
        assert len(r.prompt) == r.prompt_len
        assert 0 <= min(r.prompt) and max(r.prompt) < 1000


def test_backlog_is_due_at_zero_and_open_loop_ends_at_its_horizon():
    backlog = dict(name="b", arrivals={"process": "backlog"},
                   n_requests=50, shape_seed=1, warm_s=0, drain_s=0,
                   prompt=dict(dist="lognormal", median=100, sigma=0.5,
                               min=10, max=200),
                   output=dict(dist="lognormal", median=50, sigma=0.5,
                               min=5, max=100))
    t, p, o = traffic.arrays(backlog, 35)
    assert len(t) == 50 and not t.any()
    poisson = dict(backlog, arrivals={"process": "poisson", "rate": 4.0},
                   warm_s=5)
    t, _, _ = traffic.arrays(poisson, 30)
    assert t.max() < 35 + traffic.SLACK_S
    assert 35 + traffic.SLACK_S - t.max() < 2
    assert abs(len(t) / (35 + traffic.SLACK_S) - 4.0) < 1.5
    # the window's arrivals are a prefix of a longer window's
    t2, p2, _ = traffic.arrays(poisson, 40)
    assert np.array_equal(t2[:len(t)], t)
    assert np.array_equal(p2[:len(t)], traffic.arrays(poisson, 30)[1])


def test_a_mix_past_the_page_cap_is_refused():
    mix = mf.load_traffic(MIXES[0])
    bad = dict(mix, output=dict(mix["output"], max=traffic.MAX_TOTAL))
    with pytest.raises(ValueError):
        traffic.arrays(bad, 10)
