"""Each mix is deterministic for a seed, and seeds change the order of
the work, not its amount."""
import numpy as np
import pytest

import tiny
from portbench import traffic

SEEDS = [0, 2 ** 31 + 11]


@pytest.mark.parametrize("name", ["decode_session", "open_loop_4k"])
def test_mix_files_load(name):
    assert traffic.load_mix(name)["driver"] in ("session", "open_loop")


@pytest.mark.parametrize("seed", SEEDS)
def test_session_is_deterministic(seed):
    a = traffic.session_inputs(tiny.SESSION, 512, seed)
    b = traffic.session_inputs(tiny.SESSION, 512, seed)
    assert np.array_equal(a.prompts, b.prompts)
    assert a.check_rows == b.check_rows
    assert a.prompts.shape == (3, 96) and a.prompts.min() >= 1
    assert len(set(map(tuple, a.prompts))) == 3


@pytest.mark.parametrize("seed", SEEDS)
def test_open_loop_is_deterministic(seed):
    a = traffic.open_loop(tiny.OPEN_LOOP, 512, seed, 5.0)
    b = traffic.open_loop(tiny.OPEN_LOOP, 512, seed, 5.0)
    assert [(x.due_s, x.max_new_tokens, x.prompt.tolist()) for x in a] == \
        [(x.due_s, x.max_new_tokens, x.prompt.tolist()) for x in b]


def test_open_loop_same_work_same_shape_other_tokens():
    mix = traffic.load_mix("open_loop_4k")
    runs = [traffic.open_loop(mix, 32000, s, 51.0) for s in SEEDS]
    shapes = [[(x.due_s, len(x.prompt), x.max_new_tokens) for x in r]
              for r in runs]
    assert shapes[0] == shapes[1]
    assert any(not np.array_equal(a.prompt, b.prompt)
               for a, b in zip(*runs))
    for r in runs:
        win = [x for x in r if x.counted]
        assert len(win) == round(mix["rate_per_s"] * 51.0)
        assert win[0].due_s == 0 and all(0 <= x.due_s < 51.0 for x in win)
        assert all(x.due_s >= 51.0 for x in r if not x.counted)
        assert all(len(x.prompt) + x.max_new_tokens <= mix["max_seq_len"]
                   for x in r)
        lens = sorted(len(x.prompt) for x in win)
        assert mix["prompt"]["min"] <= lens[0] and \
            lens[-1] <= mix["prompt"]["max"] + 0
        shared = sum(len(x.prompt) >= 512 and any(
            np.array_equal(x.prompt[:512], y.prompt[:512])
            for y in win if y is not x) for x in win)
        assert shared >= 0.55 * len(win)


def test_percentile_nearest_rank():
    v = list(range(1, 101))
    assert traffic.percentile(v, 90) == 90 and traffic.percentile(v, 95) == 95
    assert traffic.percentile([5.0], 90) == 5.0


def test_shape_seed_is_another_order_of_the_same_work():
    mix = traffic.load_mix("open_loop_4k")
    other = dict(mix, shape_seed=traffic.SHAPE_SEED + 1)
    a, b = (traffic.open_loop(m, 32000, 5, 51.0) for m in (mix, other))
    for size in (lambda x: len(x.prompt), lambda x: x.max_new_tokens):
        assert sorted(map(size, a)) == sorted(map(size, b))
    assert [len(x.prompt) for x in a] != [len(x.prompt) for x in b]
