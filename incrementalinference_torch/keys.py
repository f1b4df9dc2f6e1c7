"""Host-side random keys and the draws made from them.

The JAX package derives a threefry key per request from (seed, counter) on
the host and splits it for every sub-draw.  Here a key is a plain 63-bit
Python int: ``split`` mixes it host-side (splitmix64), and ``generator``
turns one key into a ``torch.Generator`` on the device where the draw
happens.  So every factor, product stage and block keeps its own stream, as
in the JAX package, and no draw ever needs a device round trip to make a
seed.  The streams differ from threefry's: the two packages agree in
distribution, not sample for sample.
"""

from __future__ import annotations

from typing import List

import torch

_M64 = (1 << 64) - 1
_M63 = (1 << 63) - 1


def _mix(x: int) -> int:
    """splitmix64 finaliser."""
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def make_key(seed: int, counter: int = 0) -> int:
    """Key number ``counter`` of the stream seeded by ``seed``."""
    return _mix(_mix(int(seed) & _M64) ^ int(counter)) & _M63


def split(key: int, n: int) -> List[int]:
    """``n`` independent child keys of ``key``."""
    return [_mix(_mix(int(key)) ^ (i + 1)) & _M63 for i in range(n)]


def generator(key: int, device) -> torch.Generator:
    """A torch generator on ``device`` seeded by ``key``."""
    g = torch.Generator(device=device)
    g.manual_seed(int(key) & _M63)
    return g


def categorical(key: int, logits: torch.Tensor, n: int) -> torch.Tensor:
    """``n`` draws from the categorical with 1-D ``logits`` (inverse CDF:
    one uniform per draw, no (n, K) matrix — K is 50k on the large path)."""
    p = torch.softmax(logits, dim=0)
    cdf = torch.cumsum(p, dim=0)
    u = torch.rand(n, generator=generator(key, logits.device),
                   device=logits.device, dtype=logits.dtype) * cdf[-1]
    return torch.searchsorted(cdf, u, right=True).clamp_(
        max=logits.shape[0] - 1)


def categorical_rows(key: int, logits: torch.Tensor) -> torch.Tensor:
    """One draw per row of ``logits`` (R, K) by the Gumbel-max trick — the
    form ``jax.random.categorical(key, logits, axis=-1)`` takes."""
    u = torch.rand(logits.shape, generator=generator(key, logits.device),
                   device=logits.device, dtype=logits.dtype)
    tiny = torch.finfo(logits.dtype).tiny
    gumbel = -torch.log(-torch.log(u.clamp_(min=tiny)))
    return torch.argmax(logits + gumbel, dim=-1)
