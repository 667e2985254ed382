"""Bridges into and out of the port: JAX params pytrees, Adam moments and
JSON model configs.

The port keeps the JAX package's parameter layout (see
``models/wavenet.py``), so a JAX params pytree maps onto the port's params
dict key for key, shape for shape, value for value, and back.  The Adam
moments move the same way: a checkpoint holds them as params-shaped
``mu``/``nu`` trees with a step ``count`` (the form the JAX
``restore_train_state`` grafts onto its optax state), and torch's Adam
holds them per parameter.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pytorchwavenetvocoder_tpu_torch.models.wavenet import Params, WaveNetConfig


def param_leaves(params: Params) -> list:
    """``(group, name, tensor)`` for every leaf, in the params dict's order:
    the order the port's optimizer holds them in."""
    return [(g, n, t) for g, leaves in params.items() for n, t in leaves.items()]


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", copy=True).numpy()


def params_from_jax(tree: dict, device="cpu") -> Params:
    """A JAX params pytree (nested dict of numpy arrays, as a checkpoint's
    ``"model"`` entry holds it) -> the port's params dict of torch tensors:
    same keys, shapes, dtypes and values."""
    return {group: {name: torch.as_tensor(np.array(v, copy=True),
                                          device=device)
                    for name, v in leaves.items()}
            for group, leaves in tree.items()}


def params_to_jax(params: Params) -> dict:
    """The port's params -> a JAX params pytree of numpy arrays (the inverse
    of ``params_from_jax``): a checkpoint's ``"model"`` entry."""
    return {group: {name: _to_numpy(t) for name, t in leaves.items()}
            for group, leaves in params.items()}


def adam_moments(optimizer: torch.optim.Optimizer, params: Params):
    """torch Adam's per-parameter state -> ``(count, mu, nu)``: the step
    count and params-shaped trees of the moment tensors (zeros and count 0
    before the first step)."""
    mu: dict = {}
    nu: dict = {}
    count = 0
    for g, n, p in param_leaves(params):
        s = optimizer.state.get(p, {})
        if s:
            count = int(s["step"])
        mu.setdefault(g, {})[n] = s["exp_avg"] if s else torch.zeros_like(p)
        nu.setdefault(g, {})[n] = (s["exp_avg_sq"] if s
                                   else torch.zeros_like(p))
    return count, mu, nu


def adam_moments_to_jax(optimizer: torch.optim.Optimizer,
                        params: Params) -> dict:
    """torch Adam's per-parameter state -> ``{"count", "mu", "nu"}`` with
    params-shaped numpy trees (zeros and count 0 before the first step)."""
    count, mu, nu = adam_moments(optimizer, params)
    return {"count": np.asarray(count, np.int32), "mu": params_to_jax(mu),
            "nu": params_to_jax(nu)}


def adam_moments_from_jax(optimizer: torch.optim.Optimizer, params: Params,
                          count, mu: dict, nu: dict) -> None:
    """Load params-shaped ``mu``/``nu`` trees and the step ``count`` into a
    torch Adam built over ``params`` (``parallel/train.py::make_optimizer``).
    """
    state = {}
    for i, (g, n, p) in enumerate(param_leaves(params)):
        state[i] = {
            "step": torch.tensor(float(np.asarray(count))),
            "exp_avg": torch.as_tensor(np.asarray(mu[g][n]), dtype=p.dtype,
                                       device=p.device),
            "exp_avg_sq": torch.as_tensor(np.asarray(nu[g][n]),
                                          dtype=p.dtype, device=p.device),
        }
    optimizer.load_state_dict(
        {"state": state,
         "param_groups": optimizer.state_dict()["param_groups"]})


def config_from_json_conf(conf: dict) -> WaveNetConfig:
    """Build a WaveNetConfig from the framework's JSON model.conf.

    The JSON keeps the pipeline's frame factor in ``upsampling_factor``
    with ``use_upsampling_layer`` holding the on/off switch; the config
    encodes "off" as factor 0 (`convert.py:194-207` of the JAX package).
    """
    config = WaveNetConfig.from_dict(conf)
    if not conf.get("use_upsampling_layer", True):
        config = dataclasses.replace(config, upsampling_factor=0)
    return config


# ---------------------------------------------------------------------------
# the reference's (kan-bayashi/PytorchWaveNetVocoder) checkpoints
# ---------------------------------------------------------------------------
#
# The reference ``WaveNet`` (`wavenet_vocoder/nets/wavenet.py:157-210`)
# holds per-layer ``dil_sigmoid``/``dil_tanh`` causal convs, ``aux_1x1_*``,
# ``skip_1x1``/``res_1x1``, ``conv_post_*`` and ``upsampling.conv``; the
# port's params stack the layers on a leading L axis, fuse the sigmoid and
# tanh halves into one 2R gate ([:R] sigmoid, [R:] tanh) and keep weights
# channels-last: an ``nn.Conv1d`` weight (out, in, k) is (k, in, out) here,
# tap for tap (tap j of both multiplies x[t - (k - 1 - j) d]), and the
# ``ConvTranspose2d(1, 1, (1, uf), (1, uf))`` upsampler is its (uf,)
# per-phase scale.  Every map below is a permutation, split or stack, so a
# round trip is bit-identical and Adam's moments move like their weights.


def _conv(w: torch.Tensor) -> torch.Tensor:
    """A Conv1d weight (out, in, k) -> (k, in, out)."""
    return w.permute(2, 1, 0)


def _f32(v) -> torch.Tensor:
    """A float32 CPU copy of a tensor or array."""
    if not isinstance(v, torch.Tensor):
        return torch.from_numpy(np.array(v, np.float32))
    return v.detach().to("cpu", torch.float32, copy=True)


def params_from_torch_state_dict(state_dict: dict,
                                 config: WaveNetConfig) -> Params:
    """A reference ``WaveNet`` state dict (tensors or arrays) -> the port's
    params, float32 on the CPU."""
    sd = {k: _f32(v) for k, v in state_dict.items()}
    c = config
    L, k, R = c.n_layers, c.kernel_size, c.n_resch
    causal_w = _conv(sd["causal.conv.weight"])
    if tuple(causal_w.shape) != (k, c.n_quantize, R):
        raise ValueError(f"causal.conv.weight is {tuple(causal_w.shape)} as "
                         f"(k, in, out); the config says "
                         f"{(k, c.n_quantize, R)}")

    def layers(fmt):
        return torch.stack([sd[fmt.format(l)] for l in range(L)])

    # (L, out, in, k) -> (L, k, in, out); 1x1 convs (L, out, in, 1) -> (L, in, out)
    dil_w = torch.cat([layers("dil_sigmoid.{}.conv.weight"),
                       layers("dil_tanh.{}.conv.weight")], dim=1)
    aux_w = torch.cat([layers("aux_1x1_sigmoid.{}.weight"),
                       layers("aux_1x1_tanh.{}.weight")], dim=1)
    params: Params = {
        "causal": {"w": causal_w.contiguous(), "b": sd["causal.conv.bias"]},
        "dil": {"w": dil_w.permute(0, 3, 2, 1).contiguous(),
                "b": torch.cat([layers("dil_sigmoid.{}.conv.bias"),
                                layers("dil_tanh.{}.conv.bias")], dim=1)},
        "aux": {"w": aux_w[..., 0].transpose(1, 2).contiguous(),
                "b": torch.cat([layers("aux_1x1_sigmoid.{}.bias"),
                                layers("aux_1x1_tanh.{}.bias")], dim=1)},
        "skip": {"w": layers("skip_1x1.{}.weight")[..., 0].transpose(1, 2)
                 .contiguous(), "b": layers("skip_1x1.{}.bias")},
        "res": {"w": layers("res_1x1.{}.weight")[..., 0].transpose(1, 2)
                .contiguous(), "b": layers("res_1x1.{}.bias")},
        "post1": {"w": sd["conv_post_1.weight"][..., 0].T.contiguous(),
                  "b": sd["conv_post_1.bias"]},
        "post2": {"w": sd["conv_post_2.weight"][..., 0].T.contiguous(),
                  "b": sd["conv_post_2.bias"]},
    }
    if c.upsampling_factor > 0:
        params["upsampling"] = {
            "w": sd["upsampling.conv.weight"].reshape(-1).contiguous(),
            "b": sd["upsampling.conv.bias"].reshape(())}
    return params


def torch_state_dict_from_params(params: Params,
                                 config: WaveNetConfig) -> dict:
    """The inverse of ``params_from_torch_state_dict``: the port's params
    (tensors, or a checkpoint's numpy tree) -> the reference ``WaveNet``
    state dict of contiguous float32 CPU tensors, which the reference's
    ``load_state_dict`` takes."""
    p = {g: {n: _f32(v) for n, v in leaves.items()}
         for g, leaves in params.items()}
    L, R = config.n_layers, config.n_resch

    def t_conv(w):                     # (k, in, out) -> (out, in, k)
        return w.permute(2, 1, 0).contiguous()

    def t_1x1(w):                      # (in, out) -> (out, in, 1)
        return w.T[..., None].contiguous()

    sd = {
        "causal.conv.weight": t_conv(p["causal"]["w"]),
        "causal.conv.bias": p["causal"]["b"].contiguous(),
        "conv_post_1.weight": t_1x1(p["post1"]["w"]),
        "conv_post_1.bias": p["post1"]["b"].contiguous(),
        "conv_post_2.weight": t_1x1(p["post2"]["w"]),
        "conv_post_2.bias": p["post2"]["b"].contiguous(),
    }
    for l in range(L):
        dw, db = p["dil"]["w"][l], p["dil"]["b"][l]
        aw, ab = p["aux"]["w"][l], p["aux"]["b"][l]
        sd[f"dil_sigmoid.{l}.conv.weight"] = t_conv(dw[..., :R])
        sd[f"dil_sigmoid.{l}.conv.bias"] = db[:R].contiguous()
        sd[f"dil_tanh.{l}.conv.weight"] = t_conv(dw[..., R:])
        sd[f"dil_tanh.{l}.conv.bias"] = db[R:].contiguous()
        sd[f"aux_1x1_sigmoid.{l}.weight"] = t_1x1(aw[:, :R])
        sd[f"aux_1x1_sigmoid.{l}.bias"] = ab[:R].contiguous()
        sd[f"aux_1x1_tanh.{l}.weight"] = t_1x1(aw[:, R:])
        sd[f"aux_1x1_tanh.{l}.bias"] = ab[R:].contiguous()
        sd[f"skip_1x1.{l}.weight"] = t_1x1(p["skip"]["w"][l])
        sd[f"skip_1x1.{l}.bias"] = p["skip"]["b"][l].contiguous()
        sd[f"res_1x1.{l}.weight"] = t_1x1(p["res"]["w"][l])
        sd[f"res_1x1.{l}.bias"] = p["res"]["b"][l].contiguous()
    if config.upsampling_factor > 0:
        sd["upsampling.conv.weight"] = \
            p["upsampling"]["w"].reshape(1, 1, 1, -1).contiguous()
        sd["upsampling.conv.bias"] = p["upsampling"]["b"].reshape(1)
    return sd


def torch_conf_dict_from_config(config: WaveNetConfig,
                                feature_type: str = "world",
                                upsampling_factor_no_layer: int = 80) -> dict:
    """The model.conf fields the reference's decode reads
    (`wavenet_vocoder/bin/decode.py:266-309`).  The port says "no upsampling
    layer" with ``upsampling_factor == 0``; the reference keeps the frame
    factor beside ``use_upsampling_layer=False`` (its decode counts samples
    with it), which ``upsampling_factor_no_layer`` supplies."""
    c = config
    return {
        "n_quantize": c.n_quantize,
        "n_aux": c.n_aux,
        "n_resch": c.n_resch,
        "n_skipch": c.n_skipch,
        "dilation_depth": c.dilation_depth,
        "dilation_repeat": c.dilation_repeat,
        "kernel_size": c.kernel_size,
        "upsampling_factor": (c.upsampling_factor if c.upsampling_factor > 0
                              else upsampling_factor_no_layer),
        "use_upsampling_layer": c.upsampling_factor > 0,
        "use_speaker_code": False,
        "feature_type": feature_type,
    }


def config_from_torch_conf(conf) -> WaveNetConfig:
    """A WaveNetConfig from the reference's model.conf (an argparse
    Namespace or a dict), with the reference's defaults."""
    if not isinstance(conf, dict):
        conf = vars(conf)
    uf = conf.get("upsampling_factor", 80)
    if not conf.get("use_upsampling_layer", True):
        uf = 0
    return WaveNetConfig(
        n_quantize=conf.get("n_quantize", 256),
        n_aux=conf.get("n_aux", 28),
        n_resch=conf.get("n_resch", 512),
        n_skipch=conf.get("n_skipch", 256),
        dilation_depth=conf.get("dilation_depth", 10),
        dilation_repeat=conf.get("dilation_repeat", 3),
        kernel_size=conf.get("kernel_size", 2),
        upsampling_factor=uf,
    )


def torch_param_key_order(config: WaveNetConfig) -> list:
    """The reference state dict's key order, which is its
    ``model.parameters()`` order (module registration order,
    `wavenet_vocoder/nets/wavenet.py:188-211`; weight then bias; no
    buffers): the indices of a torch optimizer's state."""
    L = config.n_layers
    keys = ["causal.conv.weight", "causal.conv.bias"]
    if config.upsampling_factor > 0:
        keys += ["upsampling.conv.weight", "upsampling.conv.bias"]
    for mod in ("dil_sigmoid", "dil_tanh"):
        for l in range(L):
            keys += [f"{mod}.{l}.conv.weight", f"{mod}.{l}.conv.bias"]
    for mod in ("aux_1x1_sigmoid", "aux_1x1_tanh", "skip_1x1", "res_1x1"):
        for l in range(L):
            keys += [f"{mod}.{l}.weight", f"{mod}.{l}.bias"]
    keys += ["conv_post_1.weight", "conv_post_1.bias",
             "conv_post_2.weight", "conv_post_2.bias"]
    return keys


def find_adam_state(opt_state):
    """``(count, mu, nu)`` of the Adam state in a checkpoint's optimizer
    entry, or None: this package's ``{"adam_moments": {count, mu, nu}}``,
    an optax ``ScaleByAdamState`` (by its fields, or as the restricted
    unpickler's ``OpaqueState``, by position) anywhere in a chain of
    states."""
    if isinstance(opt_state, dict):
        m = opt_state.get("adam_moments")
        return None if m is None else (m["count"], m["mu"], m["nu"])
    if all(hasattr(opt_state, a) for a in ("count", "mu", "nu")):
        return opt_state.count, opt_state.mu, opt_state.nu
    if getattr(type(opt_state), "pickled_class", "").endswith(
            ".ScaleByAdamState"):
        return tuple(opt_state[:3])
    if isinstance(opt_state, (tuple, list)):
        for element in opt_state:
            found = find_adam_state(element)
            if found is not None:
                return found
    return None


def torch_adam_moments_from_opt_state(opt_state, config: WaveNetConfig):
    """A checkpoint's Adam moments in the reference's parameter index
    space: ``(count, {index: (exp_avg, exp_avg_sq)})`` of float32 tensors,
    indices in ``torch_param_key_order``, or None without Adam state.  The
    moment trees are params-shaped, and the layout maps are permutations,
    so each moment moves exactly like its weight."""
    adam = find_adam_state(opt_state)
    if adam is None:
        return None
    count, mu, nu = adam
    mu_sd = torch_state_dict_from_params(mu, config)
    nu_sd = torch_state_dict_from_params(nu, config)
    order = torch_param_key_order(config)
    if set(order) != set(mu_sd):
        raise ValueError(f"the moments' keys differ from the reference's: "
                         f"{sorted(set(order) ^ set(mu_sd))}")
    return int(np.asarray(count)), {i: (mu_sd[k], nu_sd[k])
                                    for i, k in enumerate(order)}
