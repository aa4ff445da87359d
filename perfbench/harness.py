"""One run of a cell: set up the program, warm it up, drive closed-loop
calls of the one-shot path for the window, optionally profile one more
call, then check what the window produced against the reference.

The timed path is the port's own entry, ``repro_torch.models.transformer``:
``forward_prefill`` over a call's right-padded prompts (embedding, each
layer's projections with K5 flash attention, the MLP or the MoE capacity
dispatch, Alg. 2 compression and paging), the greedy first token read to
the host, then ``decode_step`` per output token (Alg. 3 append, K1 paged
attention with its fused page scores, eviction and rollover), the greedy
tokens kept on the device and read once at the end. Both entry points are
looked up on the module at every call.
"""
from __future__ import annotations

import gc
import sys
import time
from contextlib import nullcontext
from dataclasses import dataclass, field

import numpy as np
import torch

from perfbench import traffic as traffic_mod
from perfbench.spec import Cell, cache_config, model_config
from perfbench.weights import make_params

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
WARM_INDEX = 2 ** 31 - 1        # the warm-up call's stream, never timed


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's (compared whole: ``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


@dataclass
class Program:
    cfg: object
    ccfg: object
    policy: object
    params: dict
    decode: dict
    device: torch.device


@dataclass
class Snapshot:
    """One call's paged layers after its prefill or its decode: block
    tables (B, P), positions of the pool (N + 1, page), write heads."""
    block_table: list
    pos: list
    cur_page: list

    @classmethod
    def take(cls, cache, paged_layers):
        layers = paged_layers(cache.layers)
        return cls([c.block_table.clone() for c in layers],
                   [c.pos_buf.clone() for c in layers],
                   [c.cur_page.clone() for c in layers])

    def positions(self, layer: int, row: int) -> list:
        """Per logical slot of ``row``: its live positions, None when the
        slot is unmapped."""
        bt = self.block_table[layer][row].tolist()
        pos = self.pos[layer].cpu()
        return [None if p < 0 else [t for t in pos[p].tolist() if t >= 0]
                for p in bt]

    def live(self, layer: int, row: int) -> set:
        return {t for s in self.positions(layer, row) if s for t in s}

    def mapped_pages(self) -> int:
        """Mapped (row, slot) entries over all layers."""
        return int(sum(int((bt >= 0).sum()) for bt in self.block_table))


@dataclass
class CallRecord:
    call: traffic_mod.Call
    t0: float                 # call start
    t1: float                 # first tokens on the host
    t2: float                 # last decode step's tokens on the host
    served: np.ndarray        # (B, T + 1) greedy tokens
    issue_s: float            # host seconds inside decode_step calls
    steps: int
    prefill_logits: torch.Tensor | None = None   # (B, vocab), as served
    pre: Snapshot | None = None
    post: Snapshot | None = None

    @property
    def ttft(self) -> float:
        return self.t1 - self.t0

    @property
    def decode_s(self) -> float:
        return self.t2 - self.t1


@dataclass
class Window:
    records: list = field(default_factory=list)

    @property
    def seconds(self) -> float:
        return self.records[-1].t2 - self.records[0].t0


def setup(cell: Cell, seed: int, device) -> Program:
    from repro_torch.core.policies import get_policy
    cfg = model_config(cell.config)
    ccfg = cache_config(cell.config)
    params = make_params(cfg, seed, device)
    return Program(cfg, ccfg, get_policy(ccfg.policy), params,
                   cell.config["decode"], torch.device(device))


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_call(prog: Program, call: traffic_mod.Call, steps: int,
             snapshot: bool = True, spans: bool = False) -> CallRecord:
    """One call of the timed path: prefill, first tokens to the host,
    ``steps`` decode steps, all tokens to the host."""
    from repro_torch.models import transformer
    rf = torch.profiler.record_function if spans else None
    t0 = time.perf_counter()
    tokens = torch.as_tensor(call.tokens, device=prog.device)
    valid = torch.as_tensor(call.valid, device=prog.device)
    S = call.padded_len
    with (rf("perfbench.prefill") if rf else nullcontext()):
        logits, cache = transformer.forward_prefill(
            prog.params, prog.cfg, tokens, prog.policy, prog.ccfg,
            valid=valid, total_seq_hint=S + steps)
        tok = logits.argmax(-1)
    first = logits if snapshot else None
    pre = Snapshot.take(cache, transformer.paged_layers) if snapshot else None
    out = [tok]
    tok.cpu()                   # the first tokens on the host
    t1 = time.perf_counter()
    issue = 0.0
    for _ in range(steps):
        with (rf("perfbench.decode_step") if rf else nullcontext()):
            a = time.perf_counter()
            logits, cache = transformer.decode_step(
                prog.params, prog.cfg, tok, cache, prog.policy, prog.ccfg,
                decode_splits=prog.decode["decode_splits"],
                fused_scores=prog.decode["fused_scores"])
            issue += time.perf_counter() - a
            tok = logits.argmax(-1)
        out.append(tok)
    post = Snapshot.take(cache, transformer.paged_layers) if snapshot \
        else None
    served = torch.stack(out, 1).cpu().numpy()
    t2 = time.perf_counter()
    del cache, logits
    return CallRecord(call, t0, t1, t2, served, issue, steps,
                      first, pre, post)


def warm_up(prog: Program, cell: Cell, seed: int) -> None:
    """One call at the shapes of the mix: every call has them."""
    call = traffic_mod.make_call(cell.traffic, prog.cfg.vocab_size, seed,
                                 WARM_INDEX)
    run_call(prog, call, cell.traffic["decode_steps"], snapshot=False)
    _sync(prog.device)


def measure(prog: Program, cell: Cell, seed: int, seconds: float) -> Window:
    """Closed-loop calls until ``seconds`` have passed since the first one
    started; a started call runs to its end. The collector is off over the
    window, the set-up's objects frozen out of its reach: a collection
    inside a decode step would land on one run's steps and not another's."""
    win = Window()
    gc.collect()
    gc.freeze()
    gc.disable()
    try:
        deadline = time.perf_counter() + seconds
        j = 0
        while True:
            call = traffic_mod.make_call(cell.traffic, prog.cfg.vocab_size,
                                         seed, j)
            win.records.append(run_call(prog, call,
                                        cell.traffic["decode_steps"]))
            j += 1
            if time.perf_counter() >= deadline:
                return win
    finally:
        gc.enable()
        gc.unfreeze()


def end_to_end(win: Window, setup_s: float, peak_bytes: int) -> dict:
    """The cell's end-to-end numbers over the window."""
    recs = win.records
    valid = sum(int(r.call.lengths.sum()) for r in recs)
    rows = sum(len(r.call.lengths) for r in recs)
    return {
        "ttft_s": sum(r.ttft * len(r.call.lengths) for r in recs) / rows,
        "prompt_tok_s": valid / win.seconds,
        "peak_mem_gib": peak_bytes / 2 ** 30,
        "setup_s": setup_s,
    }


def profile_call(prog: Program, cell: Cell, seed: int):
    """Profile one more call of the mix (CPU and CUDA activities) -> the
    record and the finished profile."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if prog.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    call = traffic_mod.make_call(cell.traffic, prog.cfg.vocab_size, seed,
                                 WARM_INDEX - 1)
    with profile(activities=acts) as prof:
        with torch.profiler.record_function("perfbench.call"):
            rec = run_call(prog, call, cell.traffic["decode_steps"],
                           snapshot=True, spans=True)
        _sync(prog.device)
    return rec, prof


def kv_bytes_per_page(prog: Program) -> int:
    from repro_torch.models.common import dtype_of
    elt = torch.empty((), dtype=dtype_of(prog.ccfg.dtype)).element_size()
    return (prog.ccfg.page_size * prog.cfg.num_kv_heads
            * prog.cfg.resolved_head_dim * 2 * elt)


@dataclass
class Context:
    """What a per-layer metric reads: the program, the window's calls, the
    profiled call and its trace (None without a card's activities)."""
    prog: Program
    cell: Cell
    window: Window
    traced: CallRecord | None
    trace: object | None          # perfbench.trace.Trace


def per_layer(ctx: Context) -> dict:
    """Every per-layer metric of the cell its reader finds something for;
    a share of a peak or a roofline above 100% stops the run."""
    from perfbench.spec import metric_reader
    out = {}
    for m in ctx.cell.per_layer:
        value = metric_reader(m["name"])(ctx)
        if value is None:
            continue
        if m["unit"] == "%" and ("roofline" in m["name"] or
                                 "mfu" in m["name"]) and value > 100.0:
            raise RuntimeError(f"{m['name']} reads {value}% of its peak: its "
                               f"operations or bytes are counted too high, "
                               f"or its time misses part of the work")
        out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def execute(cell: Cell, seed: int, seconds: float, trace: bool, device,
            t_start: float, log=print) -> dict:
    """One run: set-up and warm-up, the window, [one profiled call,] the
    check. Returns the result line's object (``check`` last)."""
    from perfbench.check import report, run_check, verdict
    from perfbench.trace import Trace
    dev = torch.device(device)
    marks = [("start", t_start), ("imports", time.time())]
    if dev.type == "cuda":
        from repro_torch.kernels.build import build_all
        build_all()
        marks.append(("kernels built or found", time.time()))
    prog = setup(cell, seed, dev)
    _sync(dev)
    marks.append(("weights", time.time()))
    warm_up(prog, cell, seed)
    marks.append(("warm-up call", time.time()))
    setup_s = time.time() - t_start
    log("set-up: " + ", ".join(f"{name} {b - a:.3f} s" for (_, a), (name, b)
                               in zip(marks, marks[1:])))
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    win = measure(prog, cell, seed, seconds)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    log("window calls (ttft s, decode ms a step, issue ms a step): " + "; ".join(
        f"{r.ttft:.4f} {1e3 * r.decode_s / r.steps:.3f} "
        f"{1e3 * r.issue_s / r.steps:.3f}" for r in win.records))
    bad = forbidden_modules()
    if bad:
        raise SystemExit(f"modules of {', '.join(bad)} are loaded in the "
                         f"process that measured")
    line: dict = {"correct": False, "attempted": sum(
        len(r.call.lengths) for r in win.records), "failed": 0}
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev)
                   if dev.type == "cuda" else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak)}
    if trace:
        rec, prof = profile_call(prog, cell, seed)
        tr = Trace.from_profile(prof) if dev.type == "cuda" else None
        ctx = Context(prog, cell, win, rec, tr)
        line["metrics"] = per_layer(ctx)
        if tr is not None:
            device_info["busy_s"] = tr.busy_s
            device_info["window_s"] = tr.window_s
            line["breakdown"] = {"device_ops": tr.device_ops(),
                                 "idle_gaps": tr.idle_gaps()}
        del rec, prof, tr, ctx
    else:
        e2e = end_to_end(win, setup_s, peak)
        line["metrics"] = {m["name"]: {"value": float(e2e[m["name"]]),
                                       "unit": m["unit"]}
                           for m in cell.end_to_end}
    line["device"] = device_info
    numbers, picks = run_check(prog, cell, seed, win.records)
    line["correct"] = verdict(numbers, cell.limits)
    line["check"] = report(numbers, cell.limits)
    log(f"checked requests (call, row): {picks}")
    for k in numbers:
        if k not in cell.limits:
            log(f"reading {k} {numbers[k]!r} (not compared)")
    for k, v in line["check"].items():
        log(f"check {k} {v['value']!r} limit {v['limit']!r}")
    return line
