"""The port's paged KV pool against the JAX package's, op by op.

Seeded churned sequences of every mutator (chunked append with rollover,
page and token eviction, release + prefix adoption, CoW forks, reclaim,
forced rollover) run on both packages from the same numpy inputs. After
every op each field must be equal: the integer pool state and the devstats
vector bit for bit, K/V/scores exactly (they are copies of the same
inputs). The port's pool must also keep F1-F4.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import paged_cache as jpc
from repro_torch.convert import layer_cache_to_numpy
from repro_torch.core import devstats
from repro_torch.core import paged_cache as tpc

B, P, page, KV, hd, T = 3, 6, 4, 2, 8, 7


def _assert_same(jc, tc, ctx):
    jn, tn = layer_cache_to_numpy(jc), layer_cache_to_numpy(tc)
    for f, want in jn.items():
        np.testing.assert_array_equal(tn[f], want, err_msg=f"{ctx}: {f}")


def _assert_invariants(tc, ctx):
    ref = tc.ref_count.numpy()
    bt = tc.block_table.numpy()
    for b in range(B):                                          # F3
        row = bt[b][bt[b] >= 0]
        assert len(row) == len(set(row.tolist())), (ctx, "F3")
    counts = np.bincount(bt[bt >= 0], minlength=ref.size)        # F2
    np.testing.assert_array_equal(counts, ref, err_msg=f"{ctx}: F2")
    assert (ref >= 0).all(), (ctx, "F1")
    assert (tc.pos.numpy()[ref == 0] == -1).all(), (ctx, "F4")


class Pair:
    """One JAX and one port cache driven with identical inputs."""

    def __init__(self):
        self.j = jpc.init_layer_cache(B, P, page, KV, hd, jnp.float32,
                                      track_stats=True)
        self.t = tpc.init_layer_cache(B, P, page, KV, hd, torch.float32,
                                      track_stats=True, device="cpu")

    def apply(self, name, *args, port_kw=None, **kw):
        """Run op ``name`` on both; numpy args go to each as its arrays.
        ``port_kw`` are keyword arguments only the port's op takes."""
        ja = [jnp.asarray(a) if isinstance(a, np.ndarray) else a
              for a in args]
        ta = [torch.from_numpy(a) if isinstance(a, np.ndarray) else a
              for a in args]
        jk = {k: jnp.asarray(v) for k, v in kw.items()}
        tk = {k: torch.from_numpy(v) for k, v in kw.items()}
        tk.update(port_kw or {})
        jr = getattr(jpc, name)(self.j, *ja, **jk)
        tr = getattr(tpc, name)(self.t, *ta, **tk)
        if not isinstance(jr, jpc.PagedLayerCache):
            self.j = jr[0]
            for a, b in zip(jr[1:], tr[1:]):
                np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        else:
            self.j = jr


def _churn(seed, steps=40):
    rng = np.random.default_rng(seed)
    pair = Pair()
    nxt = np.zeros(B, np.int32)              # next position per row
    ops = ["append", "append", "append", "evict_pages", "evict_page",
           "adopt", "evict_tokens", "reclaim", "rollover", "fork",
           "evict_token", "write_token"]
    for step in range(steps):
        op = ops[rng.integers(len(ops))]
        en = rng.random(B) < 0.5
        if op == "append":
            n = rng.integers(0, T + 1, B).astype(np.int32)
            t = np.arange(T, dtype=np.int32)
            pos = np.where(t[None] < n[:, None], nxt[:, None] + t, -1)
            times = tpc.rollover_times(pair.t.cur_off.numpy(),
                                       pair.t.head_mapped().numpy(), n, page)
            pair.apply("append_chunk",
                       rng.standard_normal((B, T, KV, hd), np.float32),
                       rng.standard_normal((B, T, KV, hd), np.float32),
                       pos.astype(np.int32),
                       (rng.integers(0, 4, (B, T)) / 4).astype(np.float32),
                       n, port_kw=dict(times=times))
            nxt += n
        elif op == "write_token":
            pair.apply("write_token",
                       rng.standard_normal((B, KV, hd), np.float32),
                       rng.standard_normal((B, KV, hd), np.float32),
                       nxt.copy(), rng.random(B).astype(np.float32),
                       active=en)
            nxt += en
        elif op == "evict_pages":
            pair.apply("evict_pages_mask", rng.random((B, P)) < 0.15)
        elif op == "evict_page":
            pair.apply("evict_page", rng.integers(0, P, B).astype(np.int32),
                       enable=en)
        elif op == "adopt":
            r, s = rng.choice(B, 2, replace=False)
            n = int(jpc.row_intact_prefix_pages(pair.j, int(s)))
            assert int(tpc.row_intact_prefix_pages(pair.t, int(s))) == n
            reset = np.arange(B) == r
            pair.apply("release_rows", reset)
            src = np.where(reset, s, -1).astype(np.int32)
            pair.apply("adopt_prefix", src,
                       np.where(reset, n, 0).astype(np.int32), enable=reset)
            nxt[r] = n * page
        elif op == "evict_tokens":
            pair.apply("evict_token_mask", rng.random((B, P, page)) < 0.1)
        elif op == "reclaim":
            pair.apply("reclaim_empty_pages", include_current=en)
        elif op == "rollover":
            pair.apply("chunk_rollover", en)
        elif op == "fork":
            pair.apply("fork_page", rng.integers(0, P, B).astype(np.int32),
                       enable=en)
        elif op == "evict_token":
            pair.apply("evict_token",
                       rng.integers(0, P * page, B).astype(np.int32),
                       enable=en)
        ctx = f"seed {seed} step {step} {op}"
        _assert_same(pair.j, pair.t, ctx)
        _assert_invariants(pair.t, ctx)
    return pair


@pytest.mark.parametrize("seed", [0, 1])
def test_churned_replay_is_bit_equal(seed):
    stats = _churn(seed).t.stats.numpy()      # cumulative over the replay
    assert stats[devstats.PAGES_ALLOCATED] > 0
    assert stats[devstats.PAGES_EVICTED] > 0
    assert stats[devstats.TOKENS_WRITTEN] > 0


def test_rollover_plan_marks_every_boundary():
    # a full head rolls at 0, a mapped head with room after page - off
    # tokens, an unmapped head with room never, an idle row never
    times = tpc.rollover_times(np.array([4, 1, 2, 4]),
                               np.array([True, True, False, True]),
                               np.array([9, 9, 9, 0]), 4)
    assert times == [0, 3, 4, 7, 8]


def test_small_pool_is_refused():
    # a pool below batch * num_pages is taken, as in JAX, and plans a
    # rollover check at every token index; one without a working page for
    # every row is refused
    c = tpc.init_layer_cache(2, 4, 4, 1, 8, torch.float32, pool_pages=7,
                             device="cpu")
    assert c.pool_pages == 7
    assert tpc.append_plan(c, np.array([4, 1]), np.array([True, True]),
                           np.array([5, 5]), 5) == [0, 1, 2, 3, 4]
    full = tpc.init_layer_cache(2, 4, 4, 1, 8, torch.float32, device="cpu")
    assert tpc.append_plan(full, np.array([4, 1]), np.array([True, True]),
                           np.array([5, 5]), 5) == [0, 3, 4]
    with pytest.raises(ValueError, match="working page"):
        tpc.init_layer_cache(2, 4, 4, 1, 8, torch.float32, pool_pages=1,
                             device="cpu")
