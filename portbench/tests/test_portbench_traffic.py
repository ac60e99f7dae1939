"""The traffic generator: a seed gives the same requests every time, and every seed gets the
same amount of work (new images per call, request sizes and gaps) in another order."""

import numpy as np

from portbench.harness import traffic


def _calls(mix, seed, n):
    _, _, stream = traffic.streams(traffic.kind(mix).Stream, mix, 8, seed)
    return [stream.next() for _ in range(n)]


def test_triplet_streams_repeat_from_the_seed(tiny_mixes):
    mix = tiny_mixes["triplet_reuse"]
    a, b, c = _calls(mix, 2 ** 40 + 3, 20), _calls(mix, 2 ** 40 + 3, 20), _calls(mix, 9, 20)
    assert all(np.array_equal(x.ring_idx, y.ring_idx) and x.paths == y.paths
               for x, y in zip(a, b))
    assert any(not np.array_equal(x.ring_idx, y.ring_idx) for x, y in zip(a, c))
    assert [x.new for x in a] == [x.new for x in c]


def test_reuse_stream_holds_its_share_of_new_images(tiny_mixes):
    mix = {**tiny_mixes["triplet_reuse"], "triplets": 24}
    calls = _calls(mix, 1, 50)
    new = [c.new for c in calls]
    assert set(new) == {7, 8} and sum(new) == round(50 * 72 * 0.1)
    seen = set()
    for c in calls:  # every key that is not new in a call was seen before it
        keys = [k for role in c.paths for k in role]
        assert len(set(c.row_map)) == c.new and set(c.row_map).isdisjoint(seen)
        seen |= set(c.row_map)
        assert set(keys) <= seen


def test_open_schedule_repeats_and_keeps_its_sizes(tiny_mixes):
    mix = {**tiny_mixes["serve_open"], "rate_per_s": 16.0, "block": 60}
    schedule = traffic.kind(mix).schedule
    a = schedule(mix, 30.0, 32, np.random.default_rng([5, 2]))
    b = schedule(mix, 30.0, 32, np.random.default_rng([5, 2]))
    c = schedule(mix, 30.0, 32, np.random.default_rng([6, 2]))
    assert [(r.due, r.ring_idx.tolist()) for r in a] == [(r.due, r.ring_idx.tolist()) for r in b]
    assert len(a) == len(c) == 480
    assert sorted(r.pairs for r in a) == sorted(r.pairs for r in c)
    assert abs(a[-1].due - 30.0) < 1.0 and a[0].due == 0.0
    blocks = lambda s: sorted(  # noqa: E731
        tuple(np.round(np.diff([r.due for r in s[b:b + 60]]), 9)) for b in range(0, 480, 60))
    # the same blocks of arrivals (but for the gap that closes each block), in another order
    assert [r.due for r in a] != [r.due for r in c]
    assert sum(x == y for x, y in zip(blocks(a), blocks(c))) >= 7
