"""The plain reference of the one-shot path, in plain torch and float32
(TF32 off): one request at a time, one layer at a time, the layer's
weights upcast from the tensors the benchmark made and handed to the
program too. It imports nothing of the program.

What it works out again, for a prompt of n tokens and the tokens the
program served (t0 from the prefill, t1..tT from T decode steps fed
t0..t(T-1)):

- the decoder: RMSNorm, GQA attention with RoPE on interleaved pairs
  (x[2i], x[2i+1]) at positions 0..n-1, causal over the request's own
  tokens; a SwiGLU MLP, or a top-k softmax router in f32 (ties to the
  lower expert, gates renormalised over the k) with, in the prefill, the
  capacity rule of the configuration: per row of padded length S, ranks
  within each expert in (token, k) order, kept below int(factor * S * k /
  E) rounded up to a multiple of 8, and in decode every routed expert
  kept;
- Alg. 2: each layer's token scores mean_h ||v|| / mean_h ||k|| (k after
  RoPE), the ``cache_budget`` best kept (ties to the earlier token), in
  position order, in pages of ``page_size``; under the ``full`` policy
  every token of the prompt;
- Alg. 3 over the decode: each step writes its token to the working page,
  attends over every live token, and when the working page is full and
  more than ``cache_budget`` tokens live, evicts the full page of lowest
  mean token score (ties to the lower logical slot), then rolls onto the
  first free slot; under ``full`` it never evicts;
- the logits of the last prompt token and of each decode step.

A row has the logical slots of the program's slab (``logical_slots``):
the padded prompt and its decode in pages, capped under
``paged_eviction`` at the budget's pages and a working page.

Given ``follow``, the decode starts from those pages (the program's after
its prefill) instead of the reference's own selection, which is returned
all the same.

``precision="fp8"`` is the control: every product's operands rounded to
float8 e4m3 with one scale per tensor (amax / 448), as an fp8 path would
compute them; the rest as above. ``precision="bf16"`` is a witness, not a
reference: every product's operands and result rounded to bf16, as the
program's bf16 products are.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

ROWS = 1024          # query rows per attention block
MLP_ROWS = 4096      # token rows per MLP block


def _q8(t: torch.Tensor) -> torch.Tensor:
    s = t.abs().amax().clamp_min(1e-12) / 448.0
    return (t / s).to(torch.float8_e4m3fn).float() * s


def _q16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


class Arith:
    """Products in f32, with fp8-rounded operands (the control) or with
    bf16-rounded operands and results (the witness)."""

    def __init__(self, precision: str):
        if precision not in ("f32", "fp8", "bf16"):
            raise ValueError(precision)
        self.round = {"f32": None, "fp8": _q8, "bf16": _q16}[precision]
        self.out = _q16 if precision == "bf16" else None

    def w(self, t: torch.Tensor) -> torch.Tensor:
        t = t.float()
        return self.round(t) if self.round else t

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.round:
            a = self.round(a)
        return self.out(a @ b) if self.out else a @ b

    def bmm(self, a, b):
        if self.round:
            a, b = self.round(a), self.round(b)
        o = torch.bmm(a, b)
        return self.out(o) if self.out else o


def rms_norm(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * \
        scale.float()


def rope(x, positions, theta):
    """x (n, heads, hd), positions (n,): pairs (x[2i], x[2i+1]) rotated by
    pos * theta^(-2i/hd), the angle formed in f32."""
    hd = x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=x.device) / hd)
    ang = positions.float()[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                       -1).reshape(x.shape)


def token_scores(k, v):
    """(n, KV, hd) -> (n,): mean over heads of ||v|| over that of ||k||."""
    kn = torch.linalg.vector_norm(k, dim=-1).mean(-1)
    vn = torch.linalg.vector_norm(v, dim=-1).mean(-1)
    return vn / kn.clamp_min(1e-6)


def capacity(factor: float, S: int, k: int, E: int) -> int:
    cap = int(factor * (S * k / E))
    return max(cap - cap % -8, 8)


def _take(positions: list, *ts):
    """Each of ``ts`` at ``positions``, by one index tensor: indexing by
    the list itself costs ~10 ms a tensor at the full cache's 15k."""
    ix = torch.from_numpy(np.array(positions, dtype=np.int64)).to(
        ts[0].device)
    return tuple(t[ix] for t in ts)


@dataclass
class Layer:
    kept: torch.Tensor               # (C,) kept positions, ascending
    scores: torch.Tensor             # (n + T,) token scores by position
    start: tuple                     # (slots, head) the decode started from
    final: set                       # live positions after the decode


@dataclass
class Result:
    logits: torch.Tensor             # (T + 1, vocab) f32
    layers: list                     # Layer per attention layer


class Reference:
    def __init__(self, params: dict, config: dict, precision: str = "f32"):
        self.p = params
        # the model as it is run: the source's values, each port difference
        # at the value the port runs
        m = {**config["model"], **{k: d["runs"] for k, d in
                                   config.get("port_differences", {}).items()}}
        self.m = m
        self.cache = config["cache"]
        self.eps = m["rms_norm_eps"]
        self.H, self.KV = m["num_attention_heads"], m["num_key_value_heads"]
        self.hd = m["head_dim"]
        self.E = m.get("num_local_experts", 0)
        self.k = m.get("num_experts_per_tok", 0)
        self.ar = Arith(precision)
        evicts(self.cache["policy"])
        if m.get("sliding_window") or m.get("attn_layer_period"):
            raise ValueError("this reference runs attention layers without "
                             "a window, every layer")

    # ----------------------------------------------------------- blocks
    def _attend_prefill(self, q, k, v):
        """Causal attention over the request's tokens, in row blocks."""
        n, H, hd = q.shape
        KV, G = self.KV, H // self.KV
        scale = 1.0 / math.sqrt(hd)
        out = torch.empty_like(q)
        kt = k.permute(1, 2, 0)                       # (KV, hd, n)
        vt = v.permute(1, 0, 2)                       # (KV, n, hd)
        for r0 in range(0, n, ROWS):
            r1 = min(n, r0 + ROWS)
            qb = q[r0:r1].reshape(r1 - r0, KV, G, hd).permute(1, 2, 0, 3) \
                .reshape(KV, G * (r1 - r0), hd)
            s = self.ar.bmm(qb, kt[:, :, :r1]) * scale   # (KV, G*rows, r1)
            qi = torch.arange(r0, r1, device=q.device).repeat(G)
            mask = torch.arange(r1, device=q.device)[None, :] <= qi[:, None]
            p = torch.softmax(s.masked_fill_(~mask, -torch.inf), -1)
            del s
            o = self.ar.bmm(p, vt[:, :r1])                # (KV, G*rows, hd)
            out[r0:r1] = o.reshape(KV, G, r1 - r0, hd).permute(2, 0, 1, 3) \
                .reshape(r1 - r0, H, hd)
        return out

    def _attend_one(self, q, k, v):
        """One query (H, hd) over live keys (m, KV, hd)."""
        KV, G, hd = self.KV, self.H // self.KV, self.hd
        s = self.ar.bmm(q.reshape(KV, G, hd), k.permute(1, 2, 0)) / \
            math.sqrt(hd)
        o = self.ar.bmm(torch.softmax(s, -1), v.permute(1, 0, 2))
        return o.reshape(self.H, hd)

    def _mlp(self, lp, h):
        ar = self.ar
        w = {n: ar.w(lp["mlp"][n]) for n in ("w_gate", "w_up", "w_down")}
        out = torch.empty_like(h)
        for r0 in range(0, h.shape[0], MLP_ROWS):
            x = h[r0:r0 + MLP_ROWS]
            a = torch.nn.functional.silu(ar.mm(x, w["w_gate"])) * \
                ar.mm(x, w["w_up"])
            out[r0:r0 + MLP_ROWS] = ar.mm(a, w["w_down"])
        return out

    def _moe(self, lp, h, cap: int | None):
        """Top-k experts per token; with ``cap``, the prefill's capacity
        rule over the tokens in order."""
        ar, E, K = self.ar, self.E, self.k
        moe = lp["moe"]
        probs = torch.softmax(ar.mm(h, ar.w(moe["router"])), -1)
        top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
        top_p, top_e = top_p[:, :K], top_e[:, :K]
        top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)
        flat_e = top_e.reshape(-1)
        keep = torch.ones_like(flat_e, dtype=torch.bool)
        if cap is not None:
            onehot = torch.nn.functional.one_hot(flat_e, E)
            rank = (onehot.cumsum(0) - onehot).gather(1, flat_e[:, None])[:, 0]
            keep = rank < cap
        out = torch.zeros_like(h)
        gate = top_p.reshape(-1)
        tok = torch.arange(h.shape[0], device=h.device).repeat_interleave(K)
        for e in range(E):
            sel = keep & (flat_e == e)
            if not bool(sel.any()):
                continue
            wg, wu, wd = (ar.w(moe[n][e]) for n in
                          ("w_gate", "w_up", "w_down"))
            t, g = tok[sel], gate[sel]
            for r0 in range(0, t.shape[0], MLP_ROWS):
                tt, gg = t[r0:r0 + MLP_ROWS], g[r0:r0 + MLP_ROWS]
                x = h[tt]
                a = torch.nn.functional.silu(ar.mm(x, wg)) * ar.mm(x, wu)
                out.index_add_(0, tt, ar.mm(a, wd) * gg[:, None])
        return out

    def _ffn(self, lp, h, cap):
        return self._moe(lp, h, cap) if "moe" in lp else self._mlp(lp, h)

    # ------------------------------------------------------------- Alg. 3
    def _decode_layer(self, q, k, v, start, sc, n):
        """The T decode tokens of one layer through its evicting cache,
        from ``start`` = (logical slots, head). q (T, H, hd), k / v
        (n + T, KV, hd) by position, sc (n + T,) token scores. Returns
        (attention outputs (T, H, hd), the live positions at the end)."""
        cache = alg3(start, sc.tolist(), self.cache)
        outs = []
        for i in range(q.shape[0]):
            cache.write(n + i, attend=lambda live: outs.append(
                self._attend_one(q[i], *_take(live, k, v))))
        return torch.stack(outs), {t for s in cache.slots if s for t in s}

    # ------------------------------------------------------------ request
    @torch.no_grad()
    def run(self, prompt: torch.Tensor, served: torch.Tensor,
            padded_len: int, follow: list | None = None) -> Result:
        """prompt (n,) token ids, served (T + 1,) the program's tokens;
        ``padded_len``: the length of the row as the program ran it (the
        capacity rule's S). ``follow``: per layer, the (logical slots,
        head) the decode starts from instead of the reference's own
        selection (the program's pages after its prefill), each slot a
        list of positions or None; the reference's own selection is
        returned all the same."""
        if torch.backends.cuda.matmul.allow_tf32:
            raise RuntimeError("the reference runs with TF32 off")
        p, ar, eps = self.p, self.ar, self.eps
        n, T = prompt.shape[0], served.shape[0] - 1
        dev = p["embed"].device
        toks = torch.cat([prompt, served[:T]]).to(dev)
        x = p["embed"][toks].float()                      # (n + T, D)
        pos = torch.arange(n + T, device=dev)
        cap = None
        if self.E:
            cap = capacity(self.m["moe_capacity_factor"], padded_len, self.k,
                           self.E)
        page = self.cache["page_size"]
        P = logical_slots(self.cache, padded_len, T)
        layers = []
        for lp in p["layers"]:
            a = lp["attn"]
            h = rms_norm(x, lp["norm1"]["scale"], eps)
            wq, wk, wv, wo = (ar.w(a[nm]) for nm in ("wq", "wk", "wv", "wo"))
            q = rope(ar.mm(h, wq).reshape(n + T, self.H, self.hd), pos,
                     self.m["rope_theta"])
            k = rope(ar.mm(h, wk).reshape(n + T, self.KV, self.hd), pos,
                     self.m["rope_theta"])
            v = ar.mm(h, wv).reshape(n + T, self.KV, self.hd)
            sc = token_scores(k, v)
            kept = alg2_keep(sc[:n], self.cache)
            ids = kept.tolist()
            start = follow[len(layers)] if follow is not None else \
                Alg3.after_prefill(
                    [ids[i:i + page] for i in range(0, len(ids), page)], P)
            o_pre = self._attend_prefill(q[:n], k[:n], v[:n])
            o_dec, final = self._decode_layer(q[n:], k, v, start, sc, n)
            o = torch.cat([o_pre, o_dec]).reshape(n + T, -1)
            x = x + ar.mm(o, wo)
            del q, k, v, o, o_pre, h
            h = rms_norm(x, lp["norm2"]["scale"], eps)
            if cap is None:
                x = x + self._ffn(lp, h, None)
            else:
                x = x + torch.cat([self._ffn(lp, h[:n], cap),
                                   self._ffn(lp, h[n:], None)])
            layers.append(Layer(kept=kept, scores=sc, start=start,
                                final=final))
        h = rms_norm(x[n - 1:], p["final_norm"]["scale"], eps)
        logits = ar.mm(h, ar.w(p["lm_head"]).T)
        return Result(logits=logits, layers=layers)


EVICTS = {"paged_eviction": True, "full": False}


def evicts(policy: str) -> bool:
    """Whether Alg. 3 evicts under ``policy``; the policies this reference
    does not follow raise."""
    if policy not in EVICTS:
        raise ValueError(f"the reference follows {' and '.join(EVICTS)}, "
                         f"not {policy}")
    return EVICTS[policy]


def logical_slots(cache: dict, padded_len: int, T: int) -> int:
    """A row's logical slots, as the program's policy sizes its slab for a
    prompt of ``padded_len`` and T decode tokens: their pages, capped
    under an evicting policy at the budget's pages and a working page."""
    page = cache["page_size"]
    P = -(-(padded_len + T) // page)
    if evicts(cache["policy"]):
        P = min(P, cache["cache_budget"] // page + 1)
    return P


def alg2_keep(sc: torch.Tensor, cache: dict) -> torch.Tensor:
    """Alg. 2 over a prompt's token scores ``sc`` (n,): the kept positions,
    ascending: the ``cache_budget`` best (ties to the earlier token), or
    every one under a policy that never evicts."""
    n = sc.shape[0]
    if not evicts(cache["policy"]):
        return torch.arange(n, device=sc.device)
    order = torch.sort(-sc, stable=True).indices[:min(cache["cache_budget"],
                                                      n)]
    return order.sort().values


def alg3(start: tuple, scores: list, cache: dict) -> "Alg3":
    """Alg. 3 of the configuration's ``cache`` from ``start`` = (slots,
    head)."""
    return Alg3(*start, scores, cache["page_size"], cache["cache_budget"],
                evicts(cache["policy"]))


class Alg3:
    """Alg. 3's bookkeeping of one row of one layer: logical slots, each a
    list of positions or None (unmapped), and the working slot ``cur``.
    ``scores`` by position rank the pages. ``evicts`` False: the ``full``
    policy's, which never evicts; with no slot free it parks the head,
    which then starts over (an eviction of the head's page)."""

    def __init__(self, slots: list, cur: int, scores: list, page: int,
                 budget: int, evicts: bool = True):
        self.slots = [None if s is None else list(s) for s in slots]
        self.cur = cur
        if self.slots[cur] is None:
            self.slots[cur] = []
        self.scores, self.page, self.budget = scores, page, budget
        self.evicts = evicts
        self.evictions: list = []     # (the full pages, the one evicted)

    @staticmethod
    def after_prefill(pages: list, P: int) -> tuple:
        """(slots, head): the prompt's pages in slots 0.., the working page
        after them (the last slot when they fill every one)."""
        slots = list(pages) + [None] * (P - len(pages))
        return slots, min(len(pages), P - 1)

    def live(self) -> int:
        return sum(len(s) for s in self.slots if s)

    def _mean(self, s):
        return sum(self.scores[t] for t in s) / len(s)

    def write(self, position: int, attend=None) -> None:
        """Write at the head, attend over the live positions, then evict
        and roll over when the head's page is full."""
        self.slots[self.cur].append(position)
        if attend is not None:
            attend([t for s in self.slots if s for t in s])
        if len(self.slots[self.cur]) < self.page:
            return
        if self.evicts and self.live() > self.budget:
            means = [self._mean(s) if s is not None and len(s) >= self.page
                     else math.inf for s in self.slots]
            j = min(range(len(self.slots)), key=lambda i: means[i])
            self.evictions.append(([list(s) for s in self.slots if s is not
                                    None and len(s) >= self.page],
                                   list(self.slots[j])))
            self.slots[j] = None
        free = [j for j, s in enumerate(self.slots) if s is None]
        if not free and not self.evicts:
            self.evictions.append(([], list(self.slots[self.cur])))
            free = [self.cur]
        elif not free:
            # no slot left: the fewest-token page other than the head goes
            cand = [(len(s), j) for j, s in enumerate(self.slots)
                    if s and j != self.cur]
            j = min(cand)[1]
            self.evictions.append(([], list(self.slots[j])))
            self.slots[j] = None
            free = [j]
        self.cur = free[0]
        self.slots[self.cur] = []
