"""The benchmark's plain reference of the mixture-of-logistics (MoL)
WaveNet vocoder: float32 plain PyTorch, no kernels, cache or batching.

It follows r9y9/wavenet_vocoder's LJSpeech mixture preset (``hparams.py``
of v0.1.1, ``wavenet_vocoder/wavenet.py``, ``modules.py`` and
``mixture.py``), the vocoder of Tacotron 2 (Shen et al., arXiv:1712.05884
section 2.3), whose output and sampler are PixelCNN++'s (Salimans et al.,
arXiv:1701.05517):

- the upsampler: per stage a ``ConvTranspose2d(1, 1, (F, s), stride (1,
  s), padding ((F - 1) / 2, 0))`` over (frequency, time), then a ReLU;
- the input: a 1x1 conv from the scalar sample in [-1, 1] to R channels;
- each layer l (dilation d): ``z = dilconv_k(x) + W_c h_up``, split into
  halves ``a`` and ``b`` of G channels, ``g = tanh(a) sigmoid(b)``, skip
  ``s_l = W_skip g + b_skip``, output ``(W_out g + b_out + x) sqrt(0.5)``;
- the skips in r9y9's legacy form: ``s_0``, then ``(skips + s_l)
  sqrt(0.5)``;
- the head: ReLU, 1x1 S -> S, ReLU, 1x1 S -> 3M (M logits, M means, M
  log-scales clamped below at ``log_scale_min``);
- the loss: the discretized logistic mixture's negative log-likelihood
  over ``n_quantize`` bins, with PixelCNN++'s edge cases at +-0.999 and its
  ``cdf_delta > 1e-5`` switch, over the positions from the receptive field
  on; Adam as torch's;
- the sampler: the component by Gumbel-max, ``argmax(logits - log(-log
  u))``, then ``clamp(mu_c + exp(log_s_c) (log v - log(1 - v)), -1, 1)``,
  u and v uniform in (1e-5, 1 - 1e-5); greedy: ``argmax(logits)`` and
  ``clamp(mu_c)``.

Departures from the preset, each a reparametrisation or a layout: the
weights come in their effective form (r9y9 trains them under weight
normalisation, which folding makes exact at inference); the weights are
channels-last matrices (``y = x @ w + b``) in the layout the benchmark
draws them in, ``{group: {name: tensor}}``: ``causal.w (1, 1, R)``,
``causal.b (R,)``, ``dil.w (L, k, R, 2G)`` whose columns are the sigmoid
half ``b`` then the tanh half ``a`` (r9y9's halves in the other order),
``dil.b (L, 2G)``, ``aux.w (L, A, 2G)`` (r9y9's conditioning 1x1 has no
bias), ``skip.w (L, G, S)``, ``res.w (L, G, R)``, ``post1.w (S, S)``,
``post2.w (S, 3M)``, ``upsampling.w<i> (F, s_i)`` and ``.b<i> ()``.  Tap j
of a kernel of size k reads the input (k - 1 - j) x dilation positions
back.  Dropout (training only) takes masks given from outside.

It imports torch and numpy alone, nothing of the program under test.  Matrix
products go through ``mm`` so that a control can put a lower precision in
their place (``fp8_matmul``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

#: The uniforms' interval of r9y9's sampler, (1e-5, 1 - 1e-5)
U_LO = 1e-5


def strict_float32() -> None:
    """Float32 products in float32: no TF32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def dilations(cfg: dict) -> list:
    return [2 ** i for _ in range(cfg["dilation_repeat"])
            for i in range(cfg["dilation_depth"])]


def receptive_field(cfg: dict) -> int:
    return (cfg["kernel_size"] - 1) * sum(dilations(cfg)) + 1


def upsample(params: dict, frames: torch.Tensor, cfg: dict) -> torch.Tensor:
    """(B, F, C) frames -> (B, F * prod(scales), C): the stages of
    ``ConvTranspose2d`` and ReLU over the (frequency, time) plane."""
    x = frames.transpose(1, 2)[:, None]                  # (B, 1, C, F)
    for i, s in enumerate(cfg["upsampling_scales"]):
        w = params["upsampling"][f"w{i}"]                # (F, s)
        b = params["upsampling"][f"b{i}"]
        pad = (w.shape[0] - 1) // 2
        x = torch.relu(F.conv_transpose2d(x, w[None, None], b.reshape(1),
                                          stride=(1, s), padding=(pad, 0)))
    return x[:, 0].transpose(1, 2)


def _delay(x: torch.Tensor, shift: int) -> torch.Tensor:
    """x (B, T, C) delayed by ``shift`` positions, zeros before t = 0."""
    if shift == 0:
        return x
    if shift >= x.shape[1]:
        return torch.zeros_like(x)
    return F.pad(x[:, :-shift], (0, 0, shift, 0))


def forward(params: dict, cfg: dict, samples: torch.Tensor,
            aux: torch.Tensor, mm=torch.matmul, masks=None) -> torch.Tensor:
    """(B, T) samples and (B, T, A) sample-rate aux -> (B, T, 3M) mixture
    outputs; those at t describe the sample at t + 1.  ``masks`` (L, each
    broadcasting against (B, T, R)) multiply each layer's conv input."""
    k, G = cfg["kernel_size"], cfg["n_gatech"]
    x = samples[..., None] * params["causal"]["w"][0, 0] \
        + params["causal"]["b"]
    half = 0.5 ** 0.5
    skips = None
    for l, d in enumerate(dilations(cfg)):
        xin = x if masks is None else x * masks[l]
        w = params["dil"]["w"][l]
        z = params["dil"]["b"][l] + mm(aux, params["aux"]["w"][l])
        for j in range(k):
            z = z + mm(_delay(xin, (k - 1 - j) * d), w[j])
        g = torch.tanh(z[..., G:]) * torch.sigmoid(z[..., :G])
        s = mm(g, params["skip"]["w"][l]) + params["skip"]["b"][l]
        x = (mm(g, params["res"]["w"][l]) + params["res"]["b"][l] + x) * half
        skips = s if skips is None else (skips + s) * half
    y = torch.relu(skips)
    y = torch.relu(mm(y, params["post1"]["w"]) + params["post1"]["b"])
    return mm(y, params["post2"]["w"]) + params["post2"]["b"]


class Adam:
    """torch's Adam: bias-corrected moments, eps outside the square root,
    weight decay as L2 on the gradient."""

    def __init__(self, lr: float, weight_decay: float = 0.0,
                 betas=(0.9, 0.999), eps: float = 1e-8):
        self.lr, self.wd, self.betas, self.eps = lr, weight_decay, betas, eps
        self.m: dict = {}
        self.v: dict = {}
        self.t = 0

    def step(self, params: dict, grads: dict) -> None:
        self.t += 1
        b1, b2 = self.betas
        for key, g in grads.items():
            p = params[key[0]][key[1]]
            if self.wd:
                g = g + self.wd * p
            m = self.m.get(key, torch.zeros_like(p)) * b1 + (1 - b1) * g
            v = self.v.get(key, torch.zeros_like(p)) * b2 + (1 - b2) * g * g
            self.m[key], self.v[key] = m, v
            denom = (v.sqrt() / (1 - b2 ** self.t) ** 0.5) + self.eps
            params[key[0]][key[1]] = p - (self.lr / (1 - b1 ** self.t)) * m \
                / denom


def leaves(params: dict) -> list:
    return [(g, n) for g in sorted(params) for n in sorted(params[g])]


class _Fp8(torch.autograd.Function):
    """Operands through float8 e4m3 on the way in (one scale per tensor),
    their gradients through e5m2 on the way back."""

    @staticmethod
    def forward(ctx, x):
        return _fp8_round(x, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return _fp8_round(g, torch.float8_e5m2, 57344.0)


def _fp8_round(x: torch.Tensor, dtype, fmax: float) -> torch.Tensor:
    scale = x.detach().abs().amax().clamp_min(1e-30) / fmax
    return (x / scale).to(dtype).to(x.dtype) * scale


def fp8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The product with both operands in float8 e4m3 (per-tensor scaled):
    the precision next below the bfloat16 the configuration states."""
    return torch.matmul(_Fp8.apply(a), _Fp8.apply(b))


def split(y: torch.Tensor, cfg: dict):
    """(..., 3M) -> logits, means, log-scales (clamped), each (..., M)."""
    M = cfg["n_mix"]
    return (y[..., :M], y[..., M:2 * M],
            torch.clamp(y[..., 2 * M:3 * M], min=cfg["log_scale_min"]))


def nll(y: torch.Tensor, target: torch.Tensor, cfg: dict) -> torch.Tensor:
    """Per position, the negative log-likelihood of ``target`` (...,) under
    ``y`` (..., 3M): ``discretized_mix_logistic_loss`` of r9y9's
    ``mixture.py``, its conditions as masks."""
    logit_probs, means, log_scales = split(y, cfg)
    nc = cfg["n_quantize"]
    t = target[..., None].expand_as(means)
    centered = t - means
    inv_stdv = torch.exp(-log_scales)
    plus_in = inv_stdv * (centered + 1.0 / (nc - 1))
    min_in = inv_stdv * (centered - 1.0 / (nc - 1))
    cdf_delta = torch.sigmoid(plus_in) - torch.sigmoid(min_in)
    log_cdf_plus = plus_in - F.softplus(plus_in)
    log_one_minus_cdf_min = -F.softplus(min_in)
    mid_in = inv_stdv * centered
    log_pdf_mid = mid_in - log_scales - 2.0 * F.softplus(mid_in)
    c1 = (cdf_delta > 1e-5).to(y.dtype)
    inner_inner = c1 * torch.log(torch.clamp(cdf_delta, min=1e-12)) \
        + (1.0 - c1) * (log_pdf_mid - float(np.log((nc - 1) / 2)))
    c2 = (t > 0.999).to(y.dtype)
    inner = c2 * log_one_minus_cdf_min + (1.0 - c2) * inner_inner
    c3 = (t < -0.999).to(y.dtype)
    log_probs = c3 * log_cdf_plus + (1.0 - c3) * inner
    log_probs = log_probs + F.log_softmax(logit_probs, dim=-1)
    return -torch.logsumexp(log_probs, dim=-1)


def loss_and_grads(params: dict, cfg: dict, batch, mm=torch.matmul,
                   masks=None):
    """The mean loss of one window ``(samples (B, T), frames (B, F, A),
    targets (B, T))`` over positions >= the receptive field, and the
    gradient of every leaf."""
    x, h, t = batch
    p = {g: {n: v.detach().requires_grad_(True) for n, v in d.items()}
         for g, d in params.items()}
    aux = upsample(p, h, cfg)
    y = forward(p, cfg, x, aux, mm, masks)
    rf = receptive_field(cfg)
    loss = nll(y[:, rf:], t[:, rf:], cfg).mean()
    loss.backward()
    return loss.detach(), {key: p[key[0]][key[1]].grad for key in leaves(p)}


def train_steps(params: dict, cfg: dict, steps: list, lr: float,
                weight_decay: float = 0.0, mm=torch.matmul,
                ranks_used=None, masks=None) -> dict:
    """Adam steps from ``params`` (not changed): ``steps[s]`` the ranks'
    windows of step s, ``masks[s][r]`` (or None) the dropout masks of rank
    r's window at step s; each step averages the gradients of the windows
    in ``ranks_used`` (default all).  Returns each step's mean loss, the
    first step's gradient and the params after the last step."""
    p = {g: dict(d) for g, d in params.items()}
    opt = Adam(lr, weight_decay)
    losses, first = [], None
    for s, windows in enumerate(steps):
        use = range(len(windows)) if ranks_used is None else ranks_used
        loss_sum, grad_sum = 0.0, None
        for r in use:
            m = None if masks is None else masks[s][r]
            loss, grads = loss_and_grads(p, cfg, windows[r], mm, m)
            loss_sum += float(loss)
            grad_sum = grads if grad_sum is None else {
                key: grad_sum[key] + g for key, g in grads.items()}
        n = len(list(use))
        grads = {key: g / n for key, g in grad_sum.items()}
        if first is None:
            first = grads
        losses.append(loss_sum / n)
        opt.step(p, grads)
    return dict(losses=losses, grad1=first, params=p)


def uniform(u: torch.Tensor) -> torch.Tensor:
    """u in (0, 1) -> the sampler's uniform in (1e-5, 1 - 1e-5), each
    operation rounded in u's dtype."""
    return u * (1.0 - 2 * U_LO) + U_LO


def candidates(y: torch.Tensor, cfg: dict, u: torch.Tensor | None,
               v: torch.Tensor | None):
    """Per row of ``y`` (n, 3M), every component's score (the logits, plus
    the Gumbel noise of the uniforms ``u`` (n, M)) and the sample it gives
    (its mean, or with the logistic's uniform ``v`` (n,) its logistic's
    draw), clamped to [-1, 1]; float64."""
    logits, means, log_scales = (t.double() for t in split(y, cfg))
    score = logits
    if u is not None:
        score = logits - torch.log(-torch.log(uniform(u.double())))
    if v is None:
        value = means
    else:
        w = uniform(v.double())[:, None]
        value = means + torch.exp(log_scales) * (torch.log(w)
                                                 - torch.log(1.0 - w))
    return score, torch.clamp(value, -1.0, 1.0)


@torch.no_grad()
def served_gaps(params: dict, cfg: dict, frames, served, noise,
                value_scale: float, mm=torch.matmul) -> torch.Tensor:
    """For one utterance decoded from ``frames`` (F, A): at each served
    sample, teacher-forced on the served samples (from 0.0, silence,
    repeated over the receptive field, with the first aux column repeated
    before the utterance's own), the gap of the component that explains it
    best: over the components c, the least of max(the gap of c's score
    below the best score, ``value_scale`` x |served - c's sample|).
    ``noise`` is None (greedy) or the (u (n, M), v (n,)) uniforms of the
    sampler's steps."""
    rf = receptive_field(cfg)
    dev = params["causal"]["w"].device
    served = torch.as_tensor(served, dtype=torch.float32, device=dev)
    n = len(served)
    h = upsample(params, torch.as_tensor(frames, device=dev)[None], cfg)
    aux = torch.cat([h[:, :1].expand(-1, rf - 1, -1), h], dim=1)
    aux = aux[:, : rf + n - 1]
    x = torch.cat([torch.zeros(rf, device=dev), served[:-1]])[None]
    y = forward(params, cfg, x, aux, mm)[0, rf - 1:]
    u, v = (None, None) if noise is None else noise
    score, value = candidates(y, cfg, u, v)
    comp_gap = score.max(dim=-1, keepdim=True).values - score
    value_gap = (served.double()[:, None] - value).abs()
    return torch.maximum(comp_gap, value_scale * value_gap).min(dim=-1).values
