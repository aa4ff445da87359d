"""The traffic generator: draws fixed by the seed, differing across seeds,
the same multiset of lengths in every call; the check's sample."""
import numpy as np

import pb_tiny  # noqa: F401  (paths)
from perfbench import traffic
from perfbench.spec import load_cell


def test_same_seed_same_inputs():
    cell = load_cell("nemo12b.longdoc")
    a = traffic.make_call(cell.traffic, 131072, 2 ** 31 + 7, 3)
    b = traffic.make_call(cell.traffic, 131072, 2 ** 31 + 7, 3)
    assert (a.tokens == b.tokens).all() and (a.valid == b.valid).all()


def test_seeds_differ_in_tokens_and_order_not_in_lengths():
    cell = load_cell("nemo12b.longdoc")
    calls = [traffic.make_call(cell.traffic, 131072, s, 0)
             for s in (1, 2, 3, 4)]
    assert len({c.tokens[:, :64].tobytes() for c in calls}) == 4
    assert len({tuple(c.lengths) for c in calls}) > 1
    for c in calls:
        assert sorted(c.lengths) == sorted(traffic.prompt_lengths(cell.traffic))
        assert c.padded_len % 128 == 0
        assert (c.valid.sum(1) == c.lengths).all()
        assert (c.tokens[~c.valid] == 0).all()


def test_lengths_are_log_uniform_strata():
    t = {"requests_per_call": 4, "prompt_len": {
        "dist": "log_uniform", "min": 8192, "max": 24576,
        "draw": "stratified_midpoints"}}
    got = traffic.prompt_lengths(t)
    want = [8192 * 3 ** ((r + 0.5) / 4) for r in range(4)]
    assert np.allclose(got, want, atol=0.5)


def test_task_lengths_are_the_published_means():
    """A request per task, its mean words times the tokens per word; every
    request of a mix may give 32 outputs (LongBench's max_gen)."""
    for name, want in [("nemo12b.longdoc", 6), ("mixtral8x7b.longdoc", 3)]:
        t = load_cell(name).traffic
        tasks = t["prompt_len"]["tasks"]
        assert len(tasks) == want == t["requests_per_call"]
        got = traffic.prompt_lengths(t)
        assert got == [round(x["words"] * 1.3333) for x in tasks]
        assert all(x["max_gen"] == t["decode_steps"] + 1 for x in tasks)
    t = {"requests_per_call": 2, "prompt_len": {
        "dist": "tasks", "tokens_per_word": 1.5,
        "tasks": [{"words": 10}, {"words": 21}]}}
    assert traffic.prompt_lengths(t) == [15, 32]
    t["requests_per_call"] = 3
    try:
        traffic.prompt_lengths(t)
    except ValueError:
        pass
    else:
        raise AssertionError("a task list and a request count that differ")


def test_check_sample_holds_a_longest_request():
    cell = load_cell("nemo12b.longdoc")
    calls = [traffic.make_call(cell.traffic, 131072, 99, j)
             for j in range(3)]
    picks = traffic.check_sample(cell.traffic, 99, calls)
    assert picks == traffic.check_sample(cell.traffic, 99, calls)
    assert len(picks) == cell.traffic["check_requests"]
    ci, row = picks[0]
    assert calls[ci].lengths[row] == max(calls[ci].lengths)
    assert len(set(picks)) == len(picks)
