"""The discretized mixture-of-logistics (MoL) output of a WaveNet vocoder:
its likelihood and its sampler.

The head of r9y9/wavenet_vocoder's mixture preset (``hparams.py`` of
v0.1.1; ``wavenet_vocoder/mixture.py``), which takes both from PixelCNN++
(Salimans et al., arXiv:1701.05517): the last 1x1 gives, per position,
``3 M`` numbers, M mixture logits, M means and M log-scales (clamped below
at ``log_scale_min``), of a mixture of M logistics over the waveform
amplitude in [-1, 1], discretized into ``num_classes`` bins.

- ``mol_loss``: the mean negative log-likelihood of the target samples,
  with PixelCNN++'s edge cases (the first and last bins take the logistic's
  tails, at -0.999 and 0.999) and its switch to the density at the bin's
  centre where the bin's mass is under 1e-5.
- ``mol_sample``: the component by Gumbel-max over the logits (argmax in
  greedy mode), then the component's logistic by inversion,
  ``mu + exp(log_s) (log v - log(1 - v))``, clamped to [-1, 1].  The
  uniforms lie in (1e-5, 1 - 1e-5), as r9y9's sampler draws them: here
  ``1e-5 + (1 - 2e-5) u`` of a uniform u in (0, 1).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

#: r9y9's ``log_scale_min``, log(1e-14)
LOG_SCALE_MIN = math.log(1e-14)

#: The uniforms' interval, (U_LO, 1 - U_LO): ``U_LO + U_SPAN * u``
U_LO = 1e-5
U_SPAN = 1.0 - 2e-5


def mol_split(y: torch.Tensor, n_mix: int, log_scale_min: float):
    """(..., 3M) head outputs -> (logits, means, log_scales), each (..., M),
    the log-scales clamped below at ``log_scale_min``."""
    M = n_mix
    return (y[..., :M], y[..., M:2 * M],
            torch.clamp(y[..., 2 * M:3 * M], min=log_scale_min))


def mol_loss(y: torch.Tensor, target: torch.Tensor, n_mix: int,
             num_classes: int, log_scale_min: float,
             mask: torch.Tensor | None = None) -> torch.Tensor:
    """The mean negative log-likelihood of ``target`` (..., float in [-1, 1])
    under the mixtures ``y`` (..., 3M) (``mask``, where given, weights the
    positions: the mean over its ones).  PixelCNN++'s
    ``discretized_mix_logistic_loss`` as r9y9's ``mixture.py`` computes it."""
    logit_probs, means, log_scales = mol_split(y, n_mix, log_scale_min)
    x = target[..., None]
    centered = x - means
    inv_stdv = torch.exp(-log_scales)
    plus_in = inv_stdv * (centered + 1.0 / (num_classes - 1))
    cdf_plus = torch.sigmoid(plus_in)
    min_in = inv_stdv * (centered - 1.0 / (num_classes - 1))
    cdf_min = torch.sigmoid(min_in)
    # log probability of the lowest bin (x = -1 edge) and of the highest
    log_cdf_plus = plus_in - F.softplus(plus_in)
    log_one_minus_cdf_min = -F.softplus(min_in)
    cdf_delta = cdf_plus - cdf_min
    mid_in = inv_stdv * centered
    # the density at the bin's centre, for bins of very small mass
    log_pdf_mid = mid_in - log_scales - 2.0 * F.softplus(mid_in)
    inner_inner = torch.where(
        cdf_delta > 1e-5, torch.log(torch.clamp(cdf_delta, min=1e-12)),
        log_pdf_mid - math.log((num_classes - 1) / 2))
    inner = torch.where(x > 0.999, log_one_minus_cdf_min, inner_inner)
    log_probs = torch.where(x < -0.999, log_cdf_plus, inner)
    log_probs = log_probs + F.log_softmax(logit_probs, dim=-1)
    nll = -torch.logsumexp(log_probs, dim=-1)
    if mask is None:
        return nll.mean()
    mask = mask.to(nll.dtype)
    return (nll * mask).sum() / mask.sum().clamp(min=1.0)


def mol_uniform(u: torch.Tensor) -> torch.Tensor:
    """u in (0, 1) -> the sampler's uniform in (1e-5, 1 - 1e-5), in u's
    dtype (each operation rounded, as the kernel's f32 ``__fmul_rn`` /
    ``__fadd_rn``)."""
    return u * U_SPAN + U_LO


def mol_choose(logits: torch.Tensor, u: torch.Tensor | None) -> torch.Tensor:
    """The component of each row: argmax of the logits (``u`` None) or of
    the logits plus the Gumbel noise ``-log(-log(mol_uniform(u)))``; ties
    to the lowest index."""
    if u is None:
        return logits.argmax(dim=-1)
    return (logits - torch.log(-torch.log(mol_uniform(u)))).argmax(dim=-1)


def mol_value(means: torch.Tensor, log_scales: torch.Tensor,
              c: torch.Tensor, v: torch.Tensor | None) -> torch.Tensor:
    """The sample of each row from its component ``c``: ``mu_c`` (greedy,
    ``v`` None) or ``mu_c + exp(log_s_c) (log v' - log(1 - v'))`` with
    ``v' = mol_uniform(v)``, clamped to [-1, 1]."""
    mu = means.gather(-1, c[..., None])[..., 0]
    if v is None:
        return torch.clamp(mu, -1.0, 1.0)
    ls = log_scales.gather(-1, c[..., None])[..., 0]
    w = mol_uniform(v)
    return torch.clamp(mu + torch.exp(ls) * (torch.log(w) - torch.log(1.0 - w)),
                       -1.0, 1.0)


def mol_sample(y: torch.Tensor, n_mix: int, log_scale_min: float,
               mode: str, generator: torch.Generator | None = None
               ) -> torch.Tensor:
    """(B, 3M) head outputs -> (B,) float32 samples in [-1, 1]: greedy
    (``mode`` "argmax": the likeliest component's mean) or sampled, from
    one ``torch.rand((B, M + 1), float64)`` of ``generator`` a step (the
    component's M uniforms, then the logistic's), in float64."""
    logits, means, log_scales = mol_split(y, n_mix, log_scale_min)
    if mode == "argmax":
        c = mol_choose(logits, None)
        return mol_value(means, log_scales, c, None).float()
    if mode != "sampling":
        raise ValueError(f"mode must be sampling or argmax, got {mode!r}")
    gdev = generator.device if generator is not None else "cpu"
    u = torch.rand((y.shape[0], n_mix + 1), generator=generator,
                   dtype=torch.float64, device=gdev).to(y.device)
    logits, means, log_scales = (t.double() for t in
                                 (logits, means, log_scales))
    c = mol_choose(logits, u[:, :n_mix])
    return mol_value(means, log_scales, c, u[:, n_mix]).float()

