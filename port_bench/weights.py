"""Random weights from the seed, made on the device in the layout the
configuration's architecture gives (its ``layout``), which the program and
the reference both take: ``{group: {"w", "b"}}`` of channels-last matrices
(for the mu-law WaveNet, see ``reference/wavenet.py``).

One ``torch.Generator`` on the device draws every weight matrix in one
uniform call, scaled leaf by leaf to its Xavier bound (the reference
model's initialization), and every bias in one normal call at 0.05, so the
bias paths carry real values; a leaf's centre is added to its draw (the
mu-law WaveNet's upsampler starts near replication).
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

from port_bench import spec


def make_params(cfg: dict, seed: int, device, bf16_values: bool = True
                ) -> dict:
    """The weights of ``seed`` on ``device``, float32 (holding bfloat16
    values with ``bf16_values``)."""
    device = torch.device(device)
    lay = spec.architecture(cfg).layout(cfg)
    gen = torch.Generator(device=device).manual_seed(seed % 2 ** 64)
    n_w = sum(math.prod(s) for _g, _n, s, b, _c in lay if b is not None)
    n_b = sum(math.prod(s) for _g, _n, s, b, _c in lay if b is None)
    u = torch.rand(n_w, generator=gen, device=device)
    z = torch.randn(n_b, generator=gen, device=device)
    params: dict = {}
    iu = iz = 0
    for group, name, shape, bound, centre in lay:
        n = math.prod(shape)
        if bound is not None:
            t = (2.0 * u[iu:iu + n] - 1.0) * bound
            iu += n
        else:
            t = 0.05 * z[iz:iz + n]
            iz += n
        if centre:
            t = centre + t
        t = t.reshape(shape)
        if bf16_values:
            t = t.to(torch.bfloat16).float()
        params.setdefault(group, {})[name] = t.contiguous()
    return params
