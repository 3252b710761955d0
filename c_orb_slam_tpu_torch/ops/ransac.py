"""RANSAC hypothesis draws shared by the solvers (twoview, pnp).

Counterpart of the JAX package's jax.random.choice(key, m, shape=(n, k),
replace=True, p=probs) calls. A torch.Generator cannot reproduce a
jax.random stream, so each solver also takes an injected first draw
(``idx``); tests pass the JAX draw there.
"""

from __future__ import annotations

from typing import Optional

import torch


def draw(weights: torch.Tensor, n: int, k: int, generator: Optional[torch.Generator]):
    """(n, k) int64 indices drawn with replacement with probability
    proportional to `weights`; all-zero weights draw uniformly instead of
    failing. The generator must live on the weights' device."""
    w = weights.to(torch.float32)
    w = w + (w.sum() <= 0).to(torch.float32)
    return torch.multinomial(w, n * k, replacement=True, generator=generator).view(n, k)
