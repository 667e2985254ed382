"""The benchmark's plain reference: a float32 WaveNet in plain PyTorch.

It follows the model of kan-bayashi/PytorchWaveNetVocoder
(``wavenet_vocoder/nets/wavenet.py``): a learned frame-to-sample
upsampler, a causal conv of the one-hot input, a stack of gated residual
layers with dilated causal convs and 1x1 aux conditioning, the skip sum
and a two-layer ReLU post stack over 256 mu-law classes; Adam as torch's,
and the cross-entropy with the first ``receptive_field`` positions left
out.  Weights come in the layout the benchmark makes them in: a dict
``{group: {"w", "b"}}`` of channels-last matrices (``y = x @ w + b``):
``causal.w (k, Q, R)``, ``dil.w (L, k, R, 2R)`` (columns: sigmoid half,
then tanh half), ``aux.w (L, A, 2R)``, ``skip.w (L, R, S)``, ``res.w (L,
R, R)``, ``post1.w (S, S)``, ``post2.w (S, Q)``, ``upsampling.w (uf,)``.
Tap j of a kernel of size k reads the input (k - 1 - j) x dilation
positions back.

It imports nothing but torch and numpy, and nothing of the program under
test.  Matrix products go through ``mm`` so that a control can put a lower
precision in their place (``fp8_matmul``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def dilations(cfg: dict) -> list:
    return [2 ** i for _ in range(cfg["dilation_repeat"])
            for i in range(cfg["dilation_depth"])]


def receptive_field(cfg: dict) -> int:
    return (cfg["kernel_size"] - 1) * sum(dilations(cfg)) + 1


def strict_float32() -> None:
    """Float32 products in float32: no TF32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def upsample(params: dict, frames: torch.Tensor, uf: int) -> torch.Tensor:
    """(B, F, A) frames -> (B, F * uf, A): output phase p of a frame is
    ``frame * w[p] + b``."""
    B, n, A = frames.shape
    w, b = params["upsampling"]["w"], params["upsampling"]["b"]
    return (frames[:, :, None, :] * w[None, None, :, None] + b).reshape(
        B, n * uf, A)


def _delay(x: torch.Tensor, shift: int) -> torch.Tensor:
    """x (B, T, C) delayed by ``shift`` positions, zeros before t = 0."""
    if shift == 0:
        return x
    if shift >= x.shape[1]:
        return torch.zeros_like(x)
    return F.pad(x[:, :-shift], (0, 0, shift, 0))


def forward(params: dict, cfg: dict, ids: torch.Tensor, aux: torch.Tensor,
            mm=torch.matmul) -> torch.Tensor:
    """(B, T) class ids and (B, T, A) sample-rate aux -> (B, T, Q) logits;
    the logits at t predict the class at t + 1."""
    k, R = cfg["kernel_size"], cfg["n_resch"]
    ids = ids.long()
    wc = params["causal"]["w"]
    out = params["causal"]["b"] + sum(_delay(wc[j][ids], k - 1 - j)
                                      for j in range(k))
    skip = 0.0
    for l, d in enumerate(dilations(cfg)):
        w = params["dil"]["w"][l]
        z = params["dil"]["b"][l] + mm(aux, params["aux"]["w"][l]) \
            + params["aux"]["b"][l]
        for j in range(k):
            z = z + mm(_delay(out, (k - 1 - j) * d), w[j])
        g = torch.sigmoid(z[..., :R]) * torch.tanh(z[..., R:])
        skip = skip + mm(g, params["skip"]["w"][l]) + params["skip"]["b"][l]
        out = out + mm(g, params["res"]["w"][l]) + params["res"]["b"][l]
    y = torch.relu(skip)
    y = torch.relu(mm(y, params["post1"]["w"]) + params["post1"]["b"])
    return mm(y, params["post2"]["w"]) + params["post2"]["b"]


def masked_ce(logits: torch.Tensor, targets: torch.Tensor,
              receptive_field_: int) -> torch.Tensor:
    """Mean cross-entropy over positions >= the receptive field."""
    logp = torch.log_softmax(logits[:, receptive_field_:], dim=-1)
    t = targets[:, receptive_field_:].long()
    return -logp.gather(-1, t[..., None]).mean()


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


def loss_and_grads(params: dict, cfg: dict, batch, mm=torch.matmul):
    """Loss of one window ``(ids (B, T), frames (B, F, A), targets (B, T))``
    and the gradient of every leaf."""
    x, h, t = batch
    p = {g: {n: v.detach().requires_grad_(True) for n, v in d.items()}
         for g, d in params.items()}
    aux = upsample(p, h, cfg["upsampling_factor"])
    loss = masked_ce(forward(p, cfg, x, aux, mm), t, receptive_field(cfg))
    loss.backward()
    return loss.detach(), {key: p[key[0]][key[1]].grad for key in leaves(p)}


def train_steps(params: dict, cfg: dict, steps: list, lr: float,
                weight_decay: float = 0.0, mm=torch.matmul,
                ranks_used=None) -> dict:
    """Adam steps from ``params`` (not changed): ``steps[s]`` is the list of
    the ranks' windows of step s; each step averages the gradients of the
    windows in ``ranks_used`` (default all).  Returns each step's mean
    loss over those windows, the first step's gradient and the params after
    the last step."""
    p = {g: dict(d) for g, d in params.items()}
    opt = Adam(lr, weight_decay)
    losses, first = [], None
    for windows in steps:
        use = range(len(windows)) if ranks_used is None else ranks_used
        loss_sum, grad_sum = 0.0, None
        for r in use:
            loss, grads = loss_and_grads(p, cfg, windows[r], mm)
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
    """The product with both operands in float8 (per-tensor scaled): the
    precision next below the bfloat16 the configurations state."""
    return torch.matmul(_Fp8.apply(a), _Fp8.apply(b))


def mulaw_pcm_table(n_quantize: int) -> np.ndarray:
    """The 16-bit PCM value a wav holds for each mu-law class: the class
    decoded (compression constant Q - 1, the class's centre), rounded to
    float32, scaled by 32768, rounded to the nearest integer and clipped."""
    m = n_quantize - 1
    y = np.arange(n_quantize, dtype=np.float64)
    fx = (y - 0.5) / m * 2 - 1
    wav = (np.sign(fx) / m * ((1 + m) ** np.abs(fx) - 1)).astype(np.float32)
    return np.clip(np.rint(wav * np.float32(32768.0)), -32768,
                   32767).astype(np.int16)


def mulaw_encode(x: np.ndarray, n_quantize: int) -> np.ndarray:
    """Waveform in [-1, 1] -> classes 0 .. Q-1 (compression Q - 1, rounded
    half up)."""
    m = n_quantize - 1
    fx = np.sign(x) * np.log1p(m * np.abs(x)) / np.log1p(m)
    return np.floor((fx + 1) / 2 * m + 0.5).astype(np.int64)


@torch.no_grad()
def served_gaps(params: dict, cfg: dict, frames: np.ndarray,
                served: np.ndarray, seed_id: int,
                noise: torch.Tensor | None = None) -> torch.Tensor:
    """For one utterance decoded from ``frames`` (F, A): the gap by which
    each served class's logit lies below the best logit, teacher-forced on
    the served classes; with ``noise`` (n, Q), a sampler's Gumbel noise at
    each served step, the gap of the logits plus the noise.  Generation
    starts from ``seed_id`` repeated over the receptive field, with the
    first aux column repeated before the utterance's own; served class i
    is predicted at position rf - 1 + i."""
    rf = receptive_field(cfg)
    dev = params["causal"]["w"].device
    n = len(served)
    h = upsample(params, torch.as_tensor(frames, device=dev)[None],
                 cfg["upsampling_factor"])
    aux = torch.cat([h[:, :1].expand(-1, rf - 1, -1), h], dim=1)
    aux = aux[:, : rf + n - 1]
    s = torch.as_tensor(served, dtype=torch.int64, device=dev)
    ids = torch.cat([torch.full((rf,), seed_id, dtype=torch.int64,
                                device=dev), s[:-1]])[None]
    logits = forward(params, cfg, ids, aux)[0, rf - 1:]
    if noise is not None:
        logits = logits.double() + noise.double()
    return logits.max(dim=-1).values - logits.gather(-1, s[:, None])[:, 0]
