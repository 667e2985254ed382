"""Random weights from the seed, made on the device in the layout the
program and the reference both take: ``{group: {"w", "b"}}`` of
channels-last matrices (see ``reference/wavenet.py``).

One ``torch.Generator`` on the device draws every weight matrix in one
uniform call, scaled leaf by leaf to its Xavier bound (the reference
model's initialization), and every bias in one normal call at 0.05, so the
bias paths carry real values.  The upsampler starts near replication.
For decoding the values are rounded to bfloat16, the type the kernels
take them in; for training they stay float32, the master copy a trainer
keeps (from bfloat16 values, Adam's first steps of 1e-4 would round back
to the same bfloat16 weights in the forward).  Both are held as float32.
The same seed gives the same weights, so the reference makes its own copy
after the program has run.
"""

from __future__ import annotations

import math

import torch


def _layout(cfg: dict) -> list:
    """(group, name, shape, Xavier bound or None for a bias)."""
    Q, A, R, S = cfg["n_quantize"], cfg["n_aux"], cfg["n_resch"], \
        cfg["n_skipch"]
    L = cfg["dilation_depth"] * cfg["dilation_repeat"]
    k = cfg["kernel_size"]

    def xavier(kk, fan_in, fan_out):
        return math.sqrt(6.0 / (fan_in * kk + fan_out * kk))

    return [
        ("causal", "w", (k, Q, R), xavier(k, Q, R)),
        ("dil", "w", (L, k, R, 2 * R), xavier(k, R, R)),
        ("aux", "w", (L, A, 2 * R), xavier(1, A, R)),
        ("skip", "w", (L, R, S), xavier(1, R, S)),
        ("res", "w", (L, R, R), xavier(1, R, R)),
        ("post1", "w", (S, S), xavier(1, S, S)),
        ("post2", "w", (S, Q), xavier(1, S, Q)),
        ("causal", "b", (R,), None),
        ("dil", "b", (L, 2 * R), None),
        ("aux", "b", (L, 2 * R), None),
        ("skip", "b", (L, S), None),
        ("res", "b", (L, R), None),
        ("post1", "b", (S,), None),
        ("post2", "b", (Q,), None),
        ("upsampling", "w", (cfg["upsampling_factor"],), None),
        ("upsampling", "b", (), None),
    ]


def make_params(cfg: dict, seed: int, device, bf16_values: bool = True
                ) -> dict:
    """The weights of ``seed`` on ``device``, float32 (holding bfloat16
    values with ``bf16_values``)."""
    device = torch.device(device)
    lay = _layout(cfg)
    gen = torch.Generator(device=device).manual_seed(seed % 2 ** 64)
    n_w = sum(math.prod(s) for _g, _n, s, b in lay if b is not None)
    n_b = sum(math.prod(s) for _g, _n, s, b in lay if b is None)
    u = torch.rand(n_w, generator=gen, device=device)
    z = torch.randn(n_b, generator=gen, device=device)
    params: dict = {}
    iu = iz = 0
    for group, name, shape, bound in lay:
        n = math.prod(shape)
        if bound is not None:
            t = (2.0 * u[iu:iu + n] - 1.0) * bound
            iu += n
        else:
            t = 0.05 * z[iz:iz + n]
            iz += n
            if group == "upsampling" and name == "w":
                t = 1.0 + t
        t = t.reshape(shape)
        if bf16_values:
            t = t.to(torch.bfloat16).float()
        params.setdefault(group, {})[name] = t.contiguous()
    return params
