"""Token sampling: greedy / temperature / top-k / top-p, batched.

Greedy is the exact argmax (first index on ties, as in the JAX package).
The stochastic path draws from a ``torch.Generator``; it cannot reproduce
``jax.random.categorical``'s bits, only its distribution."""
from __future__ import annotations

import torch


def filter_logits(logits: torch.Tensor, *, temperature: float = 1.0,
                  top_k: int = 0, top_p: float = 1.0) -> torch.Tensor:
    """Temperature-scaled f32 logits with the top-k / top-p masks applied
    (-inf outside), as the JAX sampler builds them."""
    logits = logits.float() / max(temperature, 1e-6)
    V = logits.shape[-1]
    if top_k and top_k < V:
        kth = torch.topk(logits, top_k, dim=-1).values[:, -1:]
        logits = torch.where(logits < kth, -torch.inf, logits)
    if top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        # keep the smallest prefix with cumulative mass >= top_p
        cutoff_idx = (cum < top_p).sum(-1, keepdim=True)
        cutoff = sorted_logits.gather(-1, cutoff_idx)
        logits = torch.where(logits < cutoff, -torch.inf, logits)
    return logits


def sample_tokens(gen: torch.Generator | None, logits: torch.Tensor, *,
                  temperature: float = 1.0, top_k: int = 0, top_p: float = 1.0,
                  greedy: bool = False) -> torch.Tensor:
    """logits: (B, V) -> (B,) int32."""
    if greedy or temperature == 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(filter_logits(logits, temperature=temperature,
                                        top_k=top_k, top_p=top_p), dim=-1)
    return torch.multinomial(probs, 1, generator=gen)[:, 0].to(torch.int32)
