#!/usr/bin/env python
"""Convert checkpoints between the reference (kan-bayashi/PytorchWaveNetVocoder)
and the bundle this package and the JAX package share.

Counterpart of ``pytorchwavenetvocoder_tpu/bin/convert_checkpoint.py``, with
the same flags:

``--direction to_jax`` (default): the reference's ``checkpoint-*.pkl``
(``torch.save`` of ``{model, optimizer, iterations}``, `train.py:315-332`)
and its pickled argparse ``model.conf`` (`train.py:429`) become a bundle
(pickle checkpoint + JSON model.conf) that ``bin/decode.py`` and
``bin/train.py --resume`` of either package read.  Adam's moments carry
over: every layout map is a permutation, so each moment maps like its
weight.

``--direction to_torch``: a bundle of this package or of the JAX package
(read without optax, ``parallel/checkpoint.py::load_checkpoint``) becomes a
reference ``torch.save`` checkpoint, Adam moments included, and the pickled
Namespace model.conf the reference's ``decode.py:249`` loads.

Run: ``python -m pytorchwavenetvocoder_tpu_torch.bin.convert_checkpoint
--checkpoint ... --config ... --outdir ... [--direction to_torch]``.
"""

from __future__ import annotations

import argparse
import logging
import os
import pickle

import numpy as np
import torch

from pytorchwavenetvocoder_tpu_torch.bin.common import configure_logging, echo_args


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Convert a PytorchWaveNetVocoder checkpoint")
    parser.add_argument("--checkpoint", required=True,
                        help="to_jax: reference checkpoint-*.pkl "
                        "(torch.save format); to_torch: a bundle's "
                        "checkpoint-*.pkl")
    parser.add_argument("--config", required=True,
                        help="to_jax: reference model.conf (pickled "
                        "argparse Namespace); to_torch: a bundle's "
                        "model.conf (JSON)")
    parser.add_argument("--outdir", required=True,
                        help="directory for the converted bundle")
    parser.add_argument("--direction", default="to_jax",
                        choices=["to_jax", "to_torch"],
                        help="conversion direction (see module docstring)")
    parser.add_argument("--verbose", default=1, type=int)
    return parser


def _out_path(args) -> str:
    name = os.path.basename(args.checkpoint)
    if not name.startswith("checkpoint-"):
        name = "checkpoint-converted.pkl"
    os.makedirs(args.outdir, exist_ok=True)
    return os.path.join(args.outdir, name)


def _reference_moments(ckpt, config):
    """The reference's torch-Adam state as ``{"adam_moments": {count, mu,
    nu}}`` with params-shaped numpy trees, or None where the checkpoint
    holds no complete Adam state (torch's optimizer state is indexed in
    ``model.parameters()`` order, ``torch_param_key_order``)."""
    from pytorchwavenetvocoder_tpu_torch.convert import (
        params_from_torch_state_dict,
        params_to_jax,
        torch_param_key_order,
    )

    ref_opt = ckpt.get("optimizer") if isinstance(ckpt, dict) else None
    if not (isinstance(ref_opt, dict) and ref_opt.get("state")):
        return None
    order = torch_param_key_order(config)
    ids = [pid for group in ref_opt.get("param_groups", [])
           for pid in group["params"]]
    st = ref_opt["state"]
    if len(ids) != len(order) or not set(st) <= set(ids):
        return None
    key = dict(zip(ids, order))
    mu_sd = {key[i]: s["exp_avg"] for i, s in st.items()}
    nu_sd = {key[i]: s["exp_avg_sq"] for i, s in st.items()}
    if set(mu_sd) != set(order):
        return None
    count = int(float(np.asarray(next(iter(st.values()))["step"])))
    return {"adam_moments": {
        "count": count,
        "mu": params_to_jax(params_from_torch_state_dict(mu_sd, config)),
        "nu": params_to_jax(params_from_torch_state_dict(nu_sd, config)),
    }}


def _to_jax(args) -> str:
    from pytorchwavenetvocoder_tpu_torch.convert import (
        config_from_torch_conf,
        params_from_torch_state_dict,
        params_to_jax,
    )
    from pytorchwavenetvocoder_tpu_torch.parallel.checkpoint import (
        save_model_conf,
    )

    # the reference pickles an argparse Namespace: not a weights-only file
    conf = torch.load(args.config, map_location="cpu", weights_only=False)
    config = config_from_torch_conf(conf)
    logging.info("model config: %s", config)
    ckpt = torch.load(args.checkpoint, map_location="cpu", weights_only=False)
    state_dict = ckpt["model"] if "model" in ckpt else ckpt
    params = params_from_torch_state_dict(state_dict, config)
    iterations = int(ckpt.get("iterations", 0)) if isinstance(ckpt, dict) \
        else 0
    optimizer = _reference_moments(ckpt, config)
    if optimizer is not None:
        logging.info("converted Adam moments (count=%d).",
                     optimizer["adam_moments"]["count"])
    elif isinstance(ckpt, dict) and ckpt.get("optimizer"):
        logging.warning("reference optimizer state incomplete; a resume "
                        "from this bundle restarts Adam.")
    out_path = _out_path(args)
    with open(out_path, "wb") as f:
        pickle.dump({"model": params_to_jax(params), "optimizer": optimizer,
                     "iterations": iterations}, f)
    # the reference's args take precedence so upsampling_factor stays the
    # frame factor when the learned upsampler is off (cf. bin/train.py)
    conf_dict = conf if isinstance(conf, dict) else vars(conf)
    save_model_conf(args.outdir, dict(config.to_dict(), **conf_dict))
    logging.info("wrote %s (+ model.conf)", out_path)
    return out_path


def _to_torch(args) -> str:
    from pytorchwavenetvocoder_tpu_torch.convert import (
        config_from_json_conf,
        torch_adam_moments_from_opt_state,
        torch_conf_dict_from_config,
        torch_param_key_order,
        torch_state_dict_from_params,
    )
    from pytorchwavenetvocoder_tpu_torch.parallel.checkpoint import (
        load_checkpoint,
        load_model_conf,
    )

    conf = load_model_conf(args.config)
    config = config_from_json_conf(conf)
    logging.info("model config: %s", config)
    # the frame factor survives in the JSON conf when the learned upsampler
    # is off (config.upsampling_factor == 0); the reference needs it
    uf_pipeline = int(conf.get("upsampling_factor", 0) or 0)
    if config.upsampling_factor == 0 and uf_pipeline <= 0:
        raise SystemExit(
            "model.conf lacks the pipeline frame factor (upsampling_factor"
            " is 0/absent while use_upsampling_layer is false); the "
            "reference decode needs it for sample counts: add the true "
            "shift-derived factor to the JSON conf")
    payload = load_checkpoint(args.checkpoint)
    params = payload["model"] if "model" in payload else payload
    iterations = int(payload.get("iterations", 0))
    state_dict = torch_state_dict_from_params(params, config)

    # the reference's train.py --resume reads checkpoint["optimizer"]
    # unconditionally (train.py:505-511): a torch Adam over stand-ins, one
    # per parameter in model.parameters() order, gives a state dict of
    # this torch version's form, with the moments mapped in where the
    # bundle has them
    order = torch_param_key_order(config)
    stand_ins = [torch.nn.Parameter(torch.zeros(1)) for _ in order]
    opt = torch.optim.Adam(stand_ins, lr=float(conf.get("lr", 1e-4)),
                           weight_decay=float(conf.get("weight_decay", 0.0)))
    opt_sd = opt.state_dict()
    moments = torch_adam_moments_from_opt_state(payload.get("optimizer"),
                                                config)
    if moments is not None:
        count, per_param = moments
        opt_sd["state"] = {
            i: {"step": torch.tensor(float(count)), "exp_avg": mu,
                "exp_avg_sq": nu}
            for i, (mu, nu) in per_param.items()}
        logging.info("exported Adam moments (count=%d).", count)
    else:
        logging.warning("checkpoint has no Adam moments; the exported "
                        "optimizer state is fresh (a resume restarts Adam).")
    conf_out = torch_conf_dict_from_config(
        config, feature_type=conf.get("feature_type", "world"),
        upsampling_factor_no_layer=uf_pipeline)
    out_path = _out_path(args)
    torch.save({"model": state_dict, "optimizer": opt_sd,
                "iterations": iterations}, out_path)
    torch.save(argparse.Namespace(**conf_out),
               os.path.join(args.outdir, "model.conf"))
    logging.info("wrote %s (+ model.conf)", out_path)
    return out_path


def main(argv=None) -> str:
    """Convert; returns the written checkpoint's path."""
    args = get_parser().parse_args(argv)
    configure_logging(args.verbose)
    echo_args(args)
    return _to_jax(args) if args.direction == "to_jax" else _to_torch(args)


if __name__ == "__main__":
    main()
