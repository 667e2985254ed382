"""The noise of the program's sampler, worked out again: Gumbel-max over
the logits, ``argmax(logits + g)``, with the noise ``g`` of each (row,
step, class) that the route which decoded the fleet draws.

- The CUDA kernel (``csrc/ar_persistent.cu``, the sampling stage): one
  64-bit seed a fleet, ``torch.randint(0, 2**62)`` from the caller's
  generator; for (row b, step i, class j) the Philox4x32-10 block of the
  counter ``(j // 4, b, i, 0)`` under the key ``(seed mod 2**32, seed //
  2**32)``, its word ``j % 4`` as ``w``, the uniform ``((w >> 9) + 0.5)
  * 2**-23`` and ``g = -log(-log(u))`` in float32.
- The plain loop on the CPU: every step draws ``torch.rand((B, Q),
  float64)`` from the caller's generator, and ``g = -log(-log(u))`` in
  float64.

Philox4x32-10 as Salmon, Moraes, Dror and Shaw define it ("Parallel
random numbers: as easy as 1, 2, 3", SC 2011), in int64 tensors whose
products are cut into 16-bit halves so that none overflows.
"""

from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85


def _mulhilo(a: int, b: torch.Tensor):
    """The high and low 32-bit words of ``a * b`` (a < 2**32, b int64
    values < 2**32)."""
    a_lo, a_hi = a & 0xFFFF, a >> 16
    b_lo, b_hi = b & 0xFFFF, b >> 16
    ll = a_lo * b_lo
    mid = a_lo * b_hi + a_hi * b_lo + (ll >> 16)
    return a_hi * b_hi + (mid >> 16), ((mid & 0xFFFF) << 16) | (ll & 0xFFFF)


def philox4x32_10(c0, c1, c2, c3, key: tuple) -> tuple:
    """The four output words (int64 tensors) of the counters ``c0 .. c3``
    (int64 tensors that broadcast together) under ``key`` (two ints)."""
    k0, k1 = key
    for r in range(10):
        if r:
            k0, k1 = (k0 + _W0) & _MASK, (k1 + _W1) & _MASK
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def kernel_noise(seed: int, row: int, n: int, Q: int,
                 device) -> torch.Tensor:
    """(n, Q) float32: the CUDA kernel's noise of ``row`` at steps 0 ..
    n - 1 of a fleet sampled under ``seed``."""
    groups = -(-Q // 4)
    i64 = dict(dtype=torch.int64, device=device)
    c0 = torch.arange(groups, **i64)[None, :]
    c2 = torch.arange(n, **i64)[:, None]
    zero = torch.zeros((), **i64)
    words = philox4x32_10(c0, zero + row, c2, zero,
                          (seed & _MASK, (seed >> 32) & _MASK))
    w = torch.stack(torch.broadcast_tensors(*words), dim=-1)
    w = w.reshape(n, groups * 4)[:, :Q]
    u = ((w >> 9).to(torch.float32) + 0.5) * (1.0 / 8388608.0)
    return -torch.log(-torch.log(u))


def plain_noise(generator: torch.Generator, B: int, n: int,
                Q: int) -> torch.Tensor:
    """(B, n, Q) float64: the plain loop's noise of a fleet of B rows over
    n steps, drawn from ``generator`` as the loop draws it."""
    u = torch.stack([torch.rand((B, Q), generator=generator,
                                dtype=torch.float64) for _ in range(n)],
                    dim=1)
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float64).tiny)))


def fleet_seeds(generator: torch.Generator, n_fleets: int) -> list:
    """The kernel's seed of each of ``n_fleets`` sampled fleets, drawn in
    turn from ``generator`` as the program draws one a fleet."""
    return [int(torch.randint(0, 2 ** 62, (1,), generator=generator))
            for _ in range(n_fleets)]
