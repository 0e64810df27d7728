"""Token sampling: greedy / temperature / top-k (``repro/serve/sampling.py``),
drawing from an explicit ``torch.Generator``."""

from __future__ import annotations

import torch


def sample(generator: torch.Generator | None, logits: torch.Tensor, *,
           temperature: float = 0.0, top_k: int = 0) -> torch.Tensor:
    """logits: (B, V) -> (B,) int32.  Greedy takes the first largest logit
    (as ``jnp.argmax``); otherwise a categorical draw over
    ``logits / temperature``, restricted to the top ``top_k`` when > 0.
    ``torch`` and ``jax.random`` give other draws from one seed."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits.to(torch.float32) / temperature
    if top_k > 0:
        floor = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < floor, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        torch.int32)
