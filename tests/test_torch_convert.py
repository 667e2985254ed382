"""The port's bridge to the reference's (PyTorch) checkpoints against the JAX
package's ``convert.py`` and ``bin/convert_checkpoint.py``: the same params
from a reference state dict, the same state dict, conf dicts, key order and
Adam moments back, bit-identical round trips, and CLI outputs that load to
the same tensors as the JAX CLI's."""

import argparse
import os
import pickle

import numpy as np
import pytest
import torch

import jax

from pytorchwavenetvocoder_tpu import convert as jconv
from pytorchwavenetvocoder_tpu.bin import convert_checkpoint as jax_cli
from pytorchwavenetvocoder_tpu.models import wavenet as J
from pytorchwavenetvocoder_tpu.models.wavenet import WaveNetConfig as JConfig
from pytorchwavenetvocoder_tpu.parallel import checkpoint as jck
from pytorchwavenetvocoder_tpu.parallel import train as jtr

from pytorchwavenetvocoder_tpu_torch import convert as pconv
from pytorchwavenetvocoder_tpu_torch.bin import convert_checkpoint as port_cli
from pytorchwavenetvocoder_tpu_torch.models.wavenet import WaveNetConfig
from pytorchwavenetvocoder_tpu_torch.parallel import checkpoint as pck

torch.set_num_threads(2)

CASES = [(2, 0), (2, 10), (3, 0), (3, 10)]     # (kernel_size, upsampling)


def _cfgs(k, uf):
    kw = dict(n_quantize=256, n_aux=6, n_resch=16, n_skipch=8,
              dilation_depth=3, dilation_repeat=2, kernel_size=k,
              upsampling_factor=uf)
    return JConfig(**kw), WaveNetConfig(**kw)


def _state_dict(jc, seed=0):
    """A seeded reference-layout state dict of numpy float32 arrays, the
    shapes the reference WaveNet registers (`wavenet.py:157-210`)."""
    zeros = jax.tree.map(lambda a: np.zeros(a.shape, np.float32),
                         J.init_wavenet_params(jax.random.PRNGKey(0), jc))
    shapes = {k: v.shape for k, v in
              jconv.torch_state_dict_from_params(zeros, jc).items()}
    rng = np.random.RandomState(seed)
    return {k: rng.randn(*shapes[k]).astype(np.float32)
            for k in jconv.torch_param_key_order(jc)}


def _with_moments(s, mu, nu, count):
    """An optax state with its ScaleByAdamState's moments replaced."""
    if hasattr(s, "mu") and hasattr(s, "nu"):
        return s._replace(mu=mu, nu=nu, count=count)
    if isinstance(s, tuple) and not hasattr(s, "_fields"):
        return tuple(_with_moments(x, mu, nu, count) for x in s)
    return s


def _np_tree(tree):
    return {g: {n: np.asarray(v) for n, v in leaves.items()}
            for g, leaves in tree.items()}


def _assert_trees_equal(a, b):
    assert a.keys() == b.keys()
    for g in a:
        assert a[g].keys() == b[g].keys(), g
        for n in a[g]:
            x, y = np.asarray(a[g][n]), np.asarray(b[g][n])
            assert x.dtype == y.dtype and x.shape == y.shape, (g, n)
            np.testing.assert_array_equal(x, y, err_msg=f"{g}/{n}")


def _assert_sds_equal(a, b):
    assert list(a) == list(b) or set(a) == set(b)
    for k in a:
        x = a[k].numpy() if isinstance(a[k], torch.Tensor) else a[k]
        y = b[k].numpy() if isinstance(b[k], torch.Tensor) else b[k]
        assert x.shape == y.shape and x.dtype == y.dtype, k
        np.testing.assert_array_equal(x, y, err_msg=k)


@pytest.mark.parametrize("k, uf", CASES)
def test_bridge_matches_jax_convert(k, uf):
    jc, pc = _cfgs(k, uf)
    sd = _state_dict(jc, seed=k * 100 + uf)
    want = _np_tree(jconv.params_from_torch_state_dict(sd, jc))
    got = pconv.params_from_torch_state_dict(
        {n: torch.from_numpy(v) for n, v in sd.items()}, pc)
    _assert_trees_equal(pconv.params_to_jax(got), want)
    # and back, from the port's tensors and from a numpy tree alike
    want_sd = jconv.torch_state_dict_from_params(want, jc)
    for tree in (got, want):
        back = pconv.torch_state_dict_from_params(tree, pc)
        assert set(back) == set(want_sd)
        assert all(t.is_contiguous() and t.dtype == torch.float32
                   for t in back.values())
        _assert_sds_equal(back, want_sd)
    assert pconv.torch_param_key_order(pc) == jconv.torch_param_key_order(jc)
    assert pconv.torch_conf_dict_from_config(pc, "melspc", 110) == \
        jconv.torch_conf_dict_from_config(jc, "melspc", 110)
    conf = argparse.Namespace(**jconv.torch_conf_dict_from_config(jc))
    assert pconv.config_from_torch_conf(conf).to_dict() == \
        jconv.config_from_torch_conf(conf).to_dict()
    assert pconv.config_from_torch_conf(vars(conf)) == \
        pconv.config_from_torch_conf(conf)


@pytest.mark.parametrize("k, uf", CASES)
def test_adam_moments_match_jax(k, uf, tmp_path):
    """The moments of an optax Adam state in the reference's index space:
    from the live optax state, from its checkpoint read without optax
    (``OpaqueState``), and from the port's ``adam_moments`` form."""
    jc, pc = _cfgs(k, uf)
    rng = np.random.RandomState(k + uf)
    params = J.init_wavenet_params(jax.random.PRNGKey(1), jc)
    mu, nu = (jax.tree.map(lambda a: np.asarray(rng.randn(*a.shape), np.float32),
                           params) for _ in range(2))
    live = _with_moments(jtr.make_optimizer(1e-3).init(params), mu, nu,
                         np.asarray(5, np.int32))
    count, want = jconv.torch_adam_moments_from_opt_state(live, jc)
    assert count == 5

    state = jtr.TrainState(params=params, opt_state=live,
                           step=np.asarray(5, np.int32))
    path = jck.save_checkpoint(str(tmp_path), state, iterations=5)
    pickled = pck.load_checkpoint(path)["optimizer"]
    ported = {"adam_moments": {"count": np.asarray(5, np.int32),
                               "mu": _np_tree(mu), "nu": _np_tree(nu)}}
    for opt_state in (live, pickled, ported):
        got_count, got = pconv.torch_adam_moments_from_opt_state(opt_state,
                                                                 pc)
        assert got_count == count and got.keys() == want.keys()
        for i, (m, v) in want.items():
            np.testing.assert_array_equal(got[i][0].numpy(), m)
            np.testing.assert_array_equal(got[i][1].numpy(), v)
    assert pconv.find_adam_state({"adam_moments": None}) is None
    assert pconv.torch_adam_moments_from_opt_state(None, pc) is None


@pytest.mark.parametrize("k, uf", CASES)
def test_round_trips_are_bit_identical(k, uf):
    jc, pc = _cfgs(k, uf)
    sd = {n: torch.from_numpy(v) for n, v in _state_dict(jc, seed=7).items()}
    params = pconv.params_from_torch_state_dict(sd, pc)
    _assert_sds_equal(pconv.torch_state_dict_from_params(params, pc), sd)
    again = pconv.params_from_torch_state_dict(
        pconv.torch_state_dict_from_params(params, pc), pc)
    _assert_trees_equal(pconv.params_to_jax(again),
                        pconv.params_to_jax(params))


def _reference_bundle(tmp_path, jc):
    """A reference ``torch.save`` checkpoint (state dict, torch Adam state
    indexed in ``model.parameters()`` order, iterations) and its pickled
    Namespace model.conf."""
    sd = {n: torch.from_numpy(v) for n, v in _state_dict(jc, seed=3).items()}
    order = jconv.torch_param_key_order(jc)
    params = [torch.nn.Parameter(sd[n].clone()) for n in order]
    opt = torch.optim.Adam(params, lr=1e-3)
    g = torch.Generator().manual_seed(0)
    for _ in range(2):
        for p in params:
            p.grad = torch.randn(p.shape, generator=g)
        opt.step()
    ckpt = {"model": sd, "optimizer": opt.state_dict(), "iterations": 123}
    refdir = tmp_path / "ref"
    refdir.mkdir()
    torch.save(ckpt, str(refdir / "checkpoint-123.pkl"))
    conf = argparse.Namespace(**jconv.torch_conf_dict_from_config(jc),
                              lr=1e-3)
    torch.save(conf, str(refdir / "model.conf"))
    return str(refdir / "checkpoint-123.pkl"), str(refdir / "model.conf")


@pytest.mark.parametrize("k, uf", [(2, 10), (3, 0)])
def test_convert_cli_to_jax_writes_what_the_jax_cli_writes(tmp_path, k, uf):
    jc, _ = _cfgs(k, uf)
    ckpt, conf = _reference_bundle(tmp_path, jc)
    argv = ["--checkpoint", ckpt, "--config", conf, "--verbose", "0"]
    jax_cli.main(argv + ["--outdir", str(tmp_path / "jax")])
    out = port_cli.main(argv + ["--outdir", str(tmp_path / "port")])
    assert os.path.basename(out) == "checkpoint-123.pkl"
    with open(tmp_path / "jax" / "checkpoint-123.pkl", "rb") as f:
        want = pickle.load(f)
    with open(out, "rb") as f:
        got = pickle.load(f)
    assert got["iterations"] == want["iterations"] == 123
    _assert_trees_equal(got["model"], _np_tree(want["model"]))
    wm, gm = want["optimizer"]["adam_moments"], got["optimizer"]["adam_moments"]
    assert int(gm["count"]) == int(wm["count"]) == 2
    _assert_trees_equal(gm["mu"], _np_tree(wm["mu"]))
    _assert_trees_equal(gm["nu"], _np_tree(wm["nu"]))
    assert pck.load_model_conf(str(tmp_path / "port")) == \
        pck.load_model_conf(str(tmp_path / "jax"))


@pytest.mark.parametrize("k, uf", [(2, 10), (3, 0)])
def test_convert_cli_to_torch_writes_what_the_jax_cli_writes(tmp_path, k,
                                                             uf):
    """A JAX bundle (optax state) -> reference files: both CLIs' files load
    to the same tensors, moments included; the port also carries the
    moments of its own bundles (``adam_moments``)."""
    jc, pc = _cfgs(k, uf)
    state = jtr.create_train_state(jax.random.PRNGKey(2), jc, lr=1e-3)
    step = jtr.make_train_step(jc, lr=1e-3, donate=False)
    rng = np.random.RandomState(0)
    T = 60
    bx = rng.randint(0, 256, (1, T + 1)).astype(np.int32)
    bh = rng.randn(1, T // uf if uf else T, jc.n_aux).astype(np.float32)
    for _ in range(2):
        state, _ = step(state, bx[:, :-1], bh, bx[:, 1:])
    bundle = tmp_path / "bundle"
    path = jck.save_checkpoint(str(bundle), state, iterations=2)
    # the frame factor the reference needs, kept when the upsampler is off
    jck.save_model_conf(str(bundle), dict(jc.to_dict(), feature_type="world",
                                          use_upsampling_layer=uf > 0,
                                          upsampling_factor=uf or 80))
    argv = ["--checkpoint", path, "--config", str(bundle / "model.conf"),
            "--direction", "to_torch", "--verbose", "0"]
    jax_cli.main(argv + ["--outdir", str(tmp_path / "jax")])
    port_cli.main(argv + ["--outdir", str(tmp_path / "port")])

    def load(d):
        return (torch.load(os.path.join(d, "checkpoint-2.pkl"),
                           map_location="cpu", weights_only=False),
                vars(torch.load(os.path.join(d, "model.conf"),
                                map_location="cpu", weights_only=False)))

    (want, wconf), (got, gconf) = load(tmp_path / "jax"), load(tmp_path / "port")
    assert gconf == wconf and got["iterations"] == want["iterations"] == 2
    _assert_sds_equal(got["model"], want["model"])
    ws, gs = want["optimizer"], got["optimizer"]
    assert gs["param_groups"] == ws["param_groups"]
    assert gs["state"].keys() == ws["state"].keys() and len(ws["state"])
    for i, s in ws["state"].items():
        assert float(gs["state"][i]["step"]) == float(s["step"]) == 2.0
        for key in ("exp_avg", "exp_avg_sq"):
            np.testing.assert_array_equal(gs["state"][i][key].numpy(),
                                          s[key].numpy())

    # the port's own bundle (moments as adam_moments) exports them too
    from pytorchwavenetvocoder_tpu_torch.parallel import train as ptr

    ps = ptr.create_train_state(pc, lr=1e-3, params=pconv.params_from_jax(
        _np_tree(state.params)))
    own = pck.save_checkpoint(str(tmp_path / "own"), ps, iterations=4)
    port_cli.main(["--checkpoint", own, "--config", str(bundle / "model.conf"),
                   "--direction", "to_torch", "--verbose", "0", "--outdir",
                   str(tmp_path / "own_ref")])
    ref = torch.load(str(tmp_path / "own_ref" / "checkpoint-4.pkl"),
                     map_location="cpu", weights_only=False)
    assert len(ref["optimizer"]["state"]) == len(
        pconv.torch_param_key_order(pc))
    _assert_sds_equal(ref["model"], want["model"])
