"""Training over a grid in the torch port, on the CPU: gloo ranks (one
spawned process each, ``mesh.run_ranks``), against the JAX package's own
sharded step and the port's one-device step.

- **Rule parity** (no devices): for every arch at full size (the port's
  ``init_model`` on the meta device, JAX's ``eval_shape``), every leaf's
  spec equals JAX's ``param_shardings`` spec without the repetition
  dimension, at (16, 16) over (data, model), (2, 16, 16) with pods and
  the expert-parallel (16, 8, 2); ZeRO-1 (``opt_shardings(zero1=True)``)
  gives the same moment bytes per rank as JAX's.
- **The sharded step against JAX** (2 AdamW steps, f32): reduced
  llama-3.2-1b at (data 2, model 2) with ZeRO-1, qwen2.5-3b at
  reduced(tp=2) (KV heads split) at (2, 2), reduced mixtral-8x7b at
  (2, 2) (the MoE block's model-split region) and at (data 1, expert 2,
  tp 2) (expert parallelism). JAX runs in a subprocess with 4 forced host
  devices on a mesh of ``Auto`` axes (jax 0.9's ``make_mesh`` defaults to
  ``Explicit``, on which ``with_sharding_constraint`` refuses).
- **Equal to one device**: reduced jamba (no ``ac``: the MoE block's
  regions average ``aux`` per data shard, as JAX's do, so only the
  unconstrained step equals one device), xlstm and musicgen (with its
  conditioning) at (2, 2).
- Local shapes on every rank, ``seq_parallel``, a grid checkpoint read on
  one device, ``train.py --mesh`` refusing a group of 4 ranks.

Tolerances (f32): losses and grad norms within 1e-5 relative, parameters
within atol 1e-5, moments within 1e-4 of their largest value (xlstm's
recurrence leaves its embedding's first moment 2.1e-5 of its largest
from one device's). The AdamW
``eps`` is 1e-5, not 1e-8: at 1e-8 an element whose gradient lies within
rounding of zero moves by about +-lr either way, a discontinuity of
Adam's and not of the step; the gradients themselves are held through the
moments.

This module imports no JAX at its top: the spawned ranks import it.
"""
import functools
import hashlib
import os
import pickle
import subprocess
import sys
import warnings
from datetime import timedelta
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, get_arch
from repro_torch.launch import mesh
from repro_torch.models.transformer import init_model
from repro_torch.sharding import rules
from repro_torch.training import AdamWConfig, DataConfig, init_adamw, lm_batch
from repro_torch.training.tree import key_of, leaves, leaves_with_path

ROOT = Path(__file__).resolve().parent.parent
TIMEOUT = timedelta(seconds=120)
GRID_2D = ((2, 2), ("data", "model"))
GRID_EP = ((1, 2, 2), ("data", "expert", "tp"))
# name -> (arch, reduced(tp=), grid, ZeRO-1)
JAX_CASES = {
    "llama-zero1": ("llama-3.2-1b", 1, GRID_2D, True),
    "kv-split": ("qwen2.5-3b", 2, GRID_2D, False),
    "mixtral-model": ("mixtral-8x7b", 1, GRID_2D, False),
    "mixtral-ep": ("mixtral-8x7b", 1, GRID_EP, False),
}
# arch -> whether the step takes ``ac``
ONE_DEVICE = {"jamba-1.5-large-398b": False, "xlstm-1.3b": True,
              "musicgen-medium": True}
ONE_DEVICE_STEPS = 1
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model")),
          "ep": ((16, 8, 2), ("data", "expert", "tp"))}
B, S, STEPS = 4, 64, 2
OPT = dict(lr_peak=1e-3, warmup_steps=0, total_steps=10, eps=1e-5)
ATOL, RTOL, MOMENT_RTOL = 1e-5, 1e-5, 1e-4


def _cfg(arch: str, tp: int = 1):
    return get_arch(arch).reduced(tp=tp)


def _batches(cfg) -> list:
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=S, batch_size=B,
                      seed=0)
    return [lm_batch(dcfg, i, num_codebooks=cfg.num_codebooks)
            for i in range(STEPS)]


def _cond(cfg):
    if not cfg.cross_attention:
        return None
    from repro_torch.models.multimodal import make_inputs
    return make_inputs(torch.Generator().manual_seed(1), cfg, B, 4,
                       "cpu")["cond"]


def _np_tree(tree) -> dict:
    return {key_of(p): rules.full(t).detach().numpy().copy()
            for p, t in leaves_with_path(tree)}


# ------------------------------------------------------------ the port

def _train(cfg, params, batches, *, grid=None, ac=None, zero1=False,
           cond=None, comm=None):
    """STEPS AdamW steps from ``params`` (whole tensors), on ``grid`` when
    given -> {"metrics", "params", "mu", "nu"[, "local"]} (whole values
    on every rank; "local": this rank's shapes of each leaf)."""
    from repro_torch.training import batch_to_device, make_train_step
    opt = init_adamw(params)
    if grid is not None:
        p_sh = rules.param_shardings(grid, cfg, params)
        o_sh = rules.opt_shardings(grid, cfg, opt, p_sh, zero1=zero1)
        params = rules.distribute(grid, params, p_sh)
        opt = opt._replace(mu=rules.distribute(grid, opt.mu, o_sh.mu),
                           nu=rules.distribute(grid, opt.nu, o_sh.nu))
        if cond is not None:
            cond = rules.place(grid, cond, (rules.batch_axes(grid, B),
                                            None, None))
    for p in leaves(params):
        p.requires_grad_(True)
    step = make_train_step(cfg, AdamWConfig(**OPT), ac=ac)
    metrics = []
    for i, b in enumerate(batches):
        if comm is not None:
            from torch.distributed.tensor.debug import CommDebugMode
            mode = CommDebugMode()
            with mode:
                params, opt, m = step(params, opt, batch_to_device(
                    b, "cpu", grid), cond=cond)
            comm.append({str(k).split(".")[-1]: v for k, v in
                         mode.get_comm_counts().items()})
        else:
            params, opt, m = step(params, opt,
                                  batch_to_device(b, "cpu", grid), cond=cond)
        metrics.append({k: float(v) for k, v in m.items()})
    out = {"metrics": metrics, "params": _np_tree(params),
           "mu": _np_tree(opt.mu), "nu": _np_tree(opt.nu)}
    if grid is not None:
        out["local"] = {n: {key_of(p): tuple(t.to_local().shape)
                            for p, t in leaves_with_path(tree)}
                        for n, tree in (("params", params), ("mu", opt.mu))}
        out["global"] = {key_of(p): tuple(t.shape)
                         for p, t in leaves_with_path(params)}
        out["specs"] = {"params": p_sh, "mu": o_sh.mu}
    return out


def _rank(group, jparams: dict, ckpt: str):
    """One rank: the JAX cases, the one-device archs, seq_parallel, a
    checkpoint, the launcher's refusal."""
    warnings.filterwarnings("ignore")
    torch.set_num_threads(1)
    from repro_torch.convert import params_from_jax
    from repro_torch.launch import train as train_mod
    from repro_torch.training import save_checkpoint
    from repro_torch.training.tree import map_leaves
    grids = {g: mesh.make_grid(*g, device="cpu") for g in (GRID_2D, GRID_EP)}
    out = {"backend": torch.distributed.get_backend()}
    for case, (arch, tp, g, zero1) in JAX_CASES.items():
        cfg = _cfg(arch, tp)
        grid = grids[g]
        comm = []
        out[case] = _train(cfg, params_from_jax(jparams[case], cfg,
                                                device="cpu"),
                           _batches(cfg), grid=grid, zero1=zero1,
                           ac=rules.activation_constraint(grid, B),
                           comm=comm)
        out[case]["comm"] = comm
    grid = grids[GRID_2D]
    for arch, use_ac in ONE_DEVICE.items():
        cfg = _cfg(arch)
        out[arch] = _train(cfg, init_model(cfg, seed=0, device="cpu"),
                           _batches(cfg)[:ONE_DEVICE_STEPS], grid=grid,
                           cond=_cond(cfg),
                           ac=rules.activation_constraint(grid, B)
                           if use_ac else None)
    # seq_parallel: one step's loss and gradients, with and without
    from repro_torch.training import batch_to_device
    from repro_torch.training.train_step import value_and_grad
    cfg = _cfg("llama-3.2-1b")
    p = rules.distribute(grid, init_model(cfg, seed=0, device="cpu"),
                         rules.param_shardings(grid, cfg, init_model(
                             cfg, seed=0, device="meta")))
    for t in leaves(p):
        t.requires_grad_(True)
    batch = batch_to_device(_batches(cfg)[0], "cpu", grid)
    out["seq_parallel"] = {}
    for sp in (False, True):
        (loss, _), g = value_and_grad(
            p, cfg, batch, ac=rules.activation_constraint(grid, B, sp))
        out["seq_parallel"][sp] = (float(rules.full(loss)), _np_tree(g))
    # a grid checkpoint: every rank gathers, rank 0 writes
    state = map_leaves(rules.full, {"params": p})
    if group.rank == 0:
        save_checkpoint(ckpt, 1, state)
    out["ckpt_params"] = _np_tree(p)
    try:
        train_mod.main(["--arch", "llama-3.2-1b", "--reduced", "--mesh",
                        "single", "--device", "cpu", "--steps", "1"])
        out["mesh_error"] = None
    except ValueError as e:
        out["mesh_error"] = str(e)
    return out if group.rank == 0 else _digest(out)


def _digest(out):
    """A rank's record with every array replaced by a digest of its bytes
    (the values are whole on every rank: rank 0 brings them, the others
    show that theirs are the same)."""
    if isinstance(out, dict):
        return {k: _digest(v) for k, v in out.items()}
    if isinstance(out, np.ndarray):
        return hashlib.sha1(np.ascontiguousarray(out).tobytes()).hexdigest()
    if isinstance(out, (list, tuple)):
        return type(out)(_digest(v) for v in out)
    return out


# ------------------------------------------------------------ JAX

def _jax_main(jparams_path: str, out_path: str) -> None:
    """JAX's sharded step on each case (4 host devices, ``Auto`` axes),
    and its rules at the production meshes for every arch."""
    import jax
    from jax.sharding import AbstractMesh, AxisType

    from repro.configs import get_arch as jget_arch
    from repro.models.transformer import init_model as jinit_model
    from repro.sharding import rules as jrules
    from repro.training import AdamWConfig as JAdamWConfig
    from repro.training import init_adamw as jinit_adamw
    from repro.training import make_train_step as jmake_train_step
    res = {"steps": {}, "specs": {}, "zero1": {}}
    with open(jparams_path, "rb") as f:
        jparams = pickle.load(f)
    for case, (arch, tp, (shape, axes), zero1) in JAX_CASES.items():
        cfg = jget_arch(arch).reduced(tp=tp)
        m = jax.make_mesh(shape, axes, axis_types=(AxisType.Auto,) * len(
            axes))
        params = jax.tree.map(jax.numpy.asarray, jparams[case])
        opt = jinit_adamw(params)
        p_sh = jrules.param_shardings(m, cfg, params)
        o_sh = jrules.opt_shardings(m, cfg, opt, p_sh, zero1=zero1)
        step = jmake_train_step(cfg, JAdamWConfig(**OPT),
                                ac=jrules.activation_constraint(m, B),
                                moment_shardings=o_sh.mu if zero1 else None)
        jstep = jax.jit(step, out_shardings=(p_sh, o_sh, None))
        params, opt = jax.device_put(params, p_sh), jax.device_put(opt, o_sh)
        metrics = []
        for b in _batches(_cfg(arch, tp)):
            b = {k: jax.device_put(v, jax.sharding.NamedSharding(
                m, jax.sharding.PartitionSpec("data"))) for k, v in b.items()}
            params, opt, mt = jstep(params, opt, b)
            metrics.append({k: float(v) for k, v in mt.items()})
        res["steps"][case] = {"metrics": metrics,
                              "params": jax.device_get(params),
                              "mu": jax.device_get(opt.mu),
                              "nu": jax.device_get(opt.nu)}
    for arch in ARCHS:
        cfg = jget_arch(arch)
        shapes = jax.eval_shape(lambda: jinit_model(jax.random.PRNGKey(0),
                                                    cfg))
        oshapes = jax.eval_shape(jinit_adamw, shapes)
        for name, (shape, axes) in MESHES.items():
            am = AbstractMesh(shape, axes)
            psh = jrules.param_shardings(am, cfg, shapes)
            osh = jrules.opt_shardings(am, cfg, oshapes, psh, zero1=True)
            flat = jax.tree_util.tree_flatten_with_path(shapes)[0]
            specs = [s.spec for s in jax.tree.leaves(psh)]
            zspecs = [s.spec for s in jax.tree.leaves(osh.mu)]
            res["specs"][arch, name] = {
                jrules._path_str(p): (tuple(l.shape), tuple(s))
                for (p, l), s in zip(flat, specs)}
            per_rank, rep = 0, 0
            for (p, l), z in zip(flat, zspecs):
                z = tuple(z) + (None,) * (len(l.shape) - len(z))
                split = int(np.prod([am.shape[a] for e in z if e is not None
                                     for a in (e if isinstance(e, tuple)
                                               else (e,))]))
                per_rank += 4 * int(np.prod(l.shape)) // split
                stacked = jrules._path_str(p).startswith("pattern/")
                rep += bool(stacked and z[0] == "data")
            res["zero1"][arch, name] = (per_rank, rep)
    with open(out_path, "wb") as f:
        pickle.dump(res, f)


def _jax_params(arch: str, tp: int) -> dict:
    import jax

    from repro.configs import get_arch as jget_arch
    from repro.models.transformer import init_model as jinit_model
    return jax.device_get(jinit_model(jax.random.PRNGKey(0),
                                      jget_arch(arch).reduced(tp=tp)))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("grid")
    jparams = {c: _jax_params(a, tp) for c, (a, tp, _, _) in JAX_CASES.items()}
    with open(tmp / "params.pkl", "wb") as f:
        pickle.dump(jparams, f)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                           str(ROOT / "tests")]))
    code = (f"import test_torch_grid as t; t._jax_main("
            f"{str(tmp / 'params.pkl')!r}, {str(tmp / 'jax.pkl')!r})")
    proc = subprocess.Popen([sys.executable, "-c", code], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        one = {}
        for arch in ONE_DEVICE:
            cfg = _cfg(arch)
            one[arch] = _train(cfg, init_model(cfg, seed=0, device="cpu"),
                               _batches(cfg)[:ONE_DEVICE_STEPS],
                               cond=_cond(cfg))
        ranks = mesh.run_ranks(_rank, 4, jparams, str(tmp / "ckpt"),
                               device="cpu", timeout=TIMEOUT)
        log, _ = proc.communicate(timeout=600)
        assert proc.returncode == 0, log[-4000:]
        with open(tmp / "jax.pkl", "rb") as f:
            jax_res = pickle.load(f)
    finally:
        torch.set_num_threads(threads)
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return {"one": one, "ranks": ranks, "jax": jax_res,
            "ckpt": str(tmp / "ckpt")}


# ------------------------------------------------------------ helpers

@functools.cache
def _meta_params(arch: str) -> dict:
    return init_model(get_arch(arch), device="meta")


def _port_spec_tree(arch: str, grid) -> dict:
    cfg = get_arch(arch)
    params = _meta_params(arch)
    specs = rules.param_shardings(grid, cfg, params)
    flat_s = dict(zip([key_of(p) for p, _ in leaves_with_path(params)],
                      _spec_leaves(specs)))
    return cfg, params, flat_s


def _spec_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [s for v in tree.values() for s in _spec_leaves(v)]
    if isinstance(tree, list):
        return [s for v in tree for s in _spec_leaves(v)]
    return [tree]


def _jax_key(cfg, key: str) -> tuple[str, bool]:
    """The JAX path of a port leaf, and whether it is stacked."""
    parts = key.split("/")
    if parts[0] != "layers":
        return key, False
    i, P = int(parts[1]), cfg.pattern_period
    reps = cfg.full_pattern_reps
    if i < reps * P:
        return "/".join(["pattern", str(i % P)] + parts[2:]), True
    return "/".join(["tail", str(i - reps * P)] + parts[2:]), False


def _jax_tree_np(tree, cfg) -> dict:
    from repro_torch.convert import params_from_jax
    return {key_of(p): t.numpy() for p, t in leaves_with_path(
        params_from_jax(tree, cfg, device="cpu"))}


def _close(got: dict, want: dict, what: str, atol: float) -> None:
    assert set(got) == set(want), what
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=atol,
                                   err_msg=f"{what} {k}")


def _ranks_agree(runs, key: str) -> dict:
    """Rank 0's record of ``key``, after checking that every other rank
    holds the same values (their digests)."""
    r0 = runs["ranks"][0][key]
    for r, rank in enumerate(runs["ranks"][1:], 1):
        assert rank[key] == _digest(r0), (key, r)
    return r0


def _metrics_close(got: list, want: list, what: str) -> None:
    for i, (g, w) in enumerate(zip(got, want)):
        for k in ("loss", "grad_norm", "ce", "aux"):
            assert abs(g[k] - w[k]) <= RTOL * max(abs(w[k]), 1.0), (
                what, i, k, g[k], w[k])


def _run_is_whole(run: dict, want: dict, what: str) -> None:
    """Params within ATOL, moments within ATOL of their largest value."""
    _close(run["params"], want["params"], f"{what} params", ATOL)
    for m in ("mu", "nu"):
        top = max(float(np.abs(v).max()) for v in want[m].values())
        _close(run[m], want[m], f"{what} {m}", MOMENT_RTOL * top + 1e-30)


# ------------------------------------------------------------ rules

@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_specs_match_jax(runs, arch, mesh_name):
    """Every leaf's spec equals JAX's without the repetition dimension,
    and every split dimension divides its axes."""
    grid = mesh.abstract_grid(*MESHES[mesh_name])
    cfg, params, specs = _port_spec_tree(arch, grid)
    want = runs["jax"]["specs"][arch, mesh_name]
    shapes = {key_of(p): tuple(t.shape) for p, t in leaves_with_path(params)}
    seen = set()
    for key, spec in specs.items():
        jkey, stacked = _jax_key(cfg, key)
        jshape, jspec = want[jkey]
        jspec = jspec + (None,) * (len(jshape) - len(jspec))
        if stacked:
            jshape, jspec = jshape[1:], jspec[1:]
        assert shapes[key] == jshape, (key, shapes[key], jshape)
        assert spec == jspec, (key, spec, jspec)
        for n, e in zip(shapes[key], spec):
            assert n % rules.axis_size(grid, *rules.axes_of(e)) == 0
        seen.add(jkey)
    assert seen == set(want)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_zero1_moment_bytes_match_jax(runs, arch, mesh_name, capsys):
    """ZeRO-1 moments hold as many bytes per rank as JAX's; where JAX
    splits a stacked leaf's repetition dimension the port splits another
    dimension of the same leaf (printed: how many leaves)."""
    grid = mesh.abstract_grid(*MESHES[mesh_name])
    cfg, params, _ = _port_spec_tree(arch, grid)
    psh = rules.param_shardings(grid, cfg, params)
    osh = rules.opt_shardings(grid, cfg, init_adamw(params), psh,
                              zero1=True)
    per_rank = 0
    for (_, t), z in zip(leaves_with_path(params), _spec_leaves(osh.mu)):
        per_rank += 4 * t.numel() // rules.axis_size(
            grid, *[a for e in z for a in rules.axes_of(e)])
    want, rep = runs["jax"]["zero1"][arch, mesh_name]
    with capsys.disabled():
        print(f"\n  {arch} {mesh_name}: mu bytes per rank {per_rank} "
              f"(JAX {want}); JAX splits the repetition dim of {rep} "
              f"stacked leaves", end="")
    assert per_rank == want


# ------------------------------------------------------------ steps

@pytest.mark.parametrize("case", list(JAX_CASES))
def test_sharded_step_matches_jax(runs, case, capsys):
    """The port's sharded step (every rank) equals JAX's own: losses,
    grad norms, parameters and moments after 2 AdamW steps."""
    arch, tp, _, _ = JAX_CASES[case]
    cfg = _cfg(arch, tp)
    j = runs["jax"]["steps"][case]
    want = {"params": _jax_tree_np(j["params"], cfg),
            "mu": _jax_tree_np(j["mu"], cfg),
            "nu": _jax_tree_np(j["nu"], cfg)}
    got = _ranks_agree(runs, case)
    _metrics_close(got["metrics"], j["metrics"], case)
    _run_is_whole(got, want, case)
    with capsys.disabled():
        print(f"\n  {case}: losses {[m['loss'] for m in got['metrics']]} "
              f"(JAX {[m['loss'] for m in j['metrics']]}); collectives "
              f"per step {got['comm']}", end="")


def test_expert_parallel_step_exchanges_tokens(runs):
    """The expert-parallel step runs its all-to-alls (two per MoE layer
    forward, two more backward), the model-split one none."""
    for r in runs["ranks"]:
        ep = sum(c.get("all_to_all_single", 0)
                 for c in r["mixtral-ep"]["comm"])
        assert ep >= 4 * STEPS, r["mixtral-ep"]["comm"]
        assert not any(c.get("all_to_all_single", 0)
                       for c in r["mixtral-model"]["comm"])


@pytest.mark.parametrize("arch", list(ONE_DEVICE))
def test_grid_step_equals_one_device(runs, arch):
    """jamba, xlstm and musicgen at (2, 2) equal the one-device step."""
    want = runs["one"][arch]
    got = _ranks_agree(runs, arch)
    _metrics_close(got["metrics"], want["metrics"], arch)
    _run_is_whole(got, want, arch)


@pytest.mark.parametrize("case", ["llama-zero1", "mixtral-ep"])
def test_local_shapes_follow_the_rules(runs, case):
    """Every parameter's and moment's shard on every rank is its global
    shape divided along the dimensions its spec splits."""
    _, _, (shape, axes), _ = JAX_CASES[case]
    grid = mesh.abstract_grid(shape, axes)
    for rank in runs["ranks"]:
        run = rank[case]
        for what in ("params", "mu"):
            specs = _spec_leaves(run["specs"][what])
            for (key, local), spec in zip(run["local"][what].items(), specs):
                want = tuple(n // rules.axis_size(grid, *rules.axes_of(e))
                             for n, e in zip(run["global"][key], spec))
                assert local == want, (case, what, key, local, want, spec)


def test_zero1_moments_split_over_data(runs):
    """With ZeRO-1 every moment a rank holds is at most its parameter
    shard's size, and in all a half (data 2) of them."""
    run = runs["ranks"][0]["llama-zero1"]
    p = sum(np.prod(s) for s in run["local"]["params"].values())
    m = sum(np.prod(s) for s in run["local"]["mu"].values())
    assert m < p and all(
        np.prod(run["local"]["mu"][k]) <= np.prod(run["local"]["params"][k])
        for k in run["local"]["mu"])


def test_seq_parallel_gives_the_same_step(runs):
    """Splitting the sequence over ``model`` between the mixers leaves one
    step's loss and gradients as they were (gradients within 1e-6)."""
    sp = _ranks_agree(runs, "seq_parallel")
    (l0, g0), (l1, g1) = sp[False], sp[True]
    assert abs(l0 - l1) <= RTOL * abs(l0)
    _close(g1, g0, "seq_parallel grads", 1e-6)


def test_grid_checkpoint_loads_on_one_device(runs):
    from repro_torch.training import load_checkpoint
    cfg = _cfg("llama-3.2-1b")
    like = {"params": init_model(cfg, seed=1, device="cpu")}
    got = load_checkpoint(runs["ckpt"], 1, like)
    want = _ranks_agree(runs, "ckpt_params")
    for p, t in leaves_with_path(got["params"]):
        np.testing.assert_array_equal(t.numpy(), want[key_of(p)])


def test_train_mesh_refuses_other_world_sizes(runs):
    """``train.py --mesh single`` in a group of 4 ranks raises, naming the
    256 ranks its grid needs; nothing falls back to one device."""
    for rank in runs["ranks"]:
        assert rank["mesh_error"] and "256" in rank["mesh_error"], \
            rank["mesh_error"]
        assert rank["backend"] == "gloo"


# ------------------------------------------------------------ factories

def test_production_grid_shapes():
    assert mesh.production_grid_shape() == ((16, 16), ("data", "model"))
    assert mesh.production_grid_shape(True) == ((2, 16, 16),
                                                ("pod", "data", "model"))
    assert mesh.production_grid_shape(layout="ep") == (
        (16, 8, 2), ("data", "expert", "tp"))
    assert mesh.production_grid_shape(True, "ep") == (
        (2, 16, 8, 2), ("pod", "data", "expert", "tp"))
    with pytest.raises(ValueError, match="layout"):
        mesh.production_grid_shape(layout="3d")


def test_make_grid_names_the_world_size(monkeypatch):
    for v in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(v, raising=False)
    with pytest.raises(ValueError, match="world size 512"):
        mesh.make_production_grid(multi_pod=True, device="cpu")
    with pytest.raises(ValueError, match="world size 4"):
        mesh.make_debug_grid(2, 2, device="cpu")


def test_batch_and_model_axes():
    g = mesh.abstract_grid((2, 16, 16), ("pod", "data", "model"))
    assert rules.batch_axes(g, 64) == ("pod", "data")
    assert rules.batch_axes(g, 16) == "data"
    assert rules.batch_axes(g, 3) is None
    assert rules.model_axes(g) == "model"
    assert rules.model_axes(mesh.abstract_grid(*MESHES["ep"])) == (
        "expert", "tp")
    assert rules.data_shardings(g, {"t": torch.zeros(64, 8)}) == {
        "t": (("pod", "data"), None)}
