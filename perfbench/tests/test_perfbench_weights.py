"""The weights of a run: a rule for every leaf the port's trees hold, the
Mamba mixer's leaves as the port initialises them, and the attention-only
trees drawn bit for bit as before the rules by name."""
import math

import pytest
import torch

import pb_tiny  # noqa: F401  (paths)
from perfbench import weights


def _cfg(arch, dtype="float32"):
    from repro_torch.configs import get_arch
    cfg = get_arch(arch).reduced()
    return type(cfg)(**{**cfg.__dict__, "dtype": dtype})


def _archs():
    from repro_torch.configs import ARCHS
    return sorted(ARCHS)


@pytest.mark.parametrize("arch", _archs())
def test_every_leaf_of_every_tree_gets_weights(arch):
    params = weights.make_params(_cfg(arch), 2 ** 31 + 9, "cpu")
    for path, t in weights._leaves(params):
        assert torch.isfinite(t).all(), path


def test_mamba_leaves_follow_the_port_init():
    params = weights.make_params(_cfg("jamba-1.5-large-398b", "bfloat16"),
                                 2 ** 33 + 1, "cpu")
    mixers = [lp["mamba"] for lp in params["layers"] if "mamba" in lp]
    assert len(mixers) == 3
    dts = []
    for m in mixers:
        ds = m["A_log"].shape[-1]
        want = torch.log(torch.arange(1, ds + 1, dtype=torch.float32))
        assert m["A_log"].dtype == torch.float32
        assert torch.equal(m["A_log"], want.expand_as(m["A_log"]))
        assert torch.equal(m["D"], torch.ones_like(m["D"]))
        assert torch.equal(m["conv_b"], torch.zeros_like(m["conv_b"]))
        dt = torch.nn.functional.softplus(m["dt_bias"])
        assert float(dt.min()) >= 1e-3 * (1 - 1e-5)
        assert float(dt.max()) <= 1e-1 * (1 + 1e-5)
        dts.append(dt)
        for name in ("in_proj", "x_proj", "dt_proj", "out_proj", "conv_w"):
            w = m[name].float()
            assert float(w.std()) == pytest.approx(
                1 / math.sqrt(w.shape[-2]), rel=0.2), name
    dt = torch.cat(dts).log10()
    # log-uniform over two decades: a quarter in each half decade or so
    for lo in (-3.0, -2.5, -2.0, -1.5):
        share = float(((dt >= lo) & (dt < lo + 0.5)).float().mean())
        assert 0.15 < share < 0.35, (lo, share)


def test_a_leaf_without_a_rule_raises():
    with pytest.raises(ValueError, match="layers.0.mixer.gamma"):
        weights.init_leaf(("layers", 0, "mixer", "gamma"), torch.zeros(4))


def _parents_rule(path, shape):
    """The rule before leaves were ruled by name: norm scales 1 (None),
    biases 0, the embedding and the head 0.02, 1 / sqrt(fan_in) else."""
    if path[-1] in ("scale",):
        return None
    if path[-1] in ("bias",):
        return 0.0
    if path[0] in ("embed", "lm_head"):
        return 0.02
    return 1.0 / math.sqrt(shape[-2])


@pytest.mark.parametrize("arch", ["mistral-nemo-12b", "mixtral-8x7b"])
def test_attention_trees_match_the_parents_rule(arch, monkeypatch):
    cfg = _cfg(arch, "bfloat16")
    seed = 2 ** 31 + 17
    now = weights.make_params(cfg, seed, "cpu")

    def parents(path, leaf):
        s = _parents_rule(path, tuple(leaf.shape))
        if s is None:
            leaf.fill_(1.0)
        else:
            leaf.mul_(s)
    monkeypatch.setattr(weights, "init_leaf", parents)
    before = weights.make_params(cfg, seed, "cpu")
    a, b = list(weights._leaves(now)), list(weights._leaves(before))
    assert [p for p, _ in a] == [p for p, _ in b]
    for (path, x), (_, y) in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(
            x.flatten().view(torch.uint8), y.flatten().view(torch.uint8)), path
