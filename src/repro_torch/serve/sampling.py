"""Greedy and temperature sampling for the serving engine.

Greedy rows take the first maximal logit, as ``jnp.argmax`` does, so
temperature-0 tokens match the reference exactly.  Temperature > 0 rows
draw by the Gumbel-max trick from an explicit ``torch.Generator``: the
same distribution as the reference's ``jax.random.categorical``, but not
its threefry bits.
"""
from __future__ import annotations

import torch


def sample_tokens(last: torch.Tensor, temperatures: torch.Tensor,
                  generator: torch.Generator, *,
                  any_temp: bool) -> torch.Tensor:
    """last: (R, V) logits; temperatures: (R,) float32; returns (R,) int32.

    Greedy unless the row's temperature is positive.  ``any_temp=False``
    skips the draw (all rows greedy)."""
    greedy = torch.argmax(last, dim=-1)
    if not any_temp:
        return greedy.to(torch.int32)
    temp = temperatures.clamp_min(1e-6)[:, None]
    u = torch.rand(last.shape, generator=generator, dtype=torch.float32,
                   device=last.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(1e-20)))
    sampled = torch.argmax(last.float() / temp + gumbel, dim=-1)
    return torch.where(temperatures > 0, sampled, greedy).to(torch.int32)
