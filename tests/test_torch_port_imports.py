"""The PyTorch port stands alone: no JAX at import, JAX bundles load without
optax, and CUDA requests that cannot be served raise."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from pytorchwavenetvocoder_tpu_torch._build import AUX_MAX
from pytorchwavenetvocoder_tpu_torch.models.wavenet import (
    WaveNetConfig,
    _check_impl,
    batch_fast_generate,
    init_wavenet_params,
)
from pytorchwavenetvocoder_tpu_torch.ops.ar_kernel import (
    ar_generate,
    ar_kernel_constraint_error,
)
from pytorchwavenetvocoder_tpu_torch.ops.train_kernel import (
    MAX_RESCH,
    layer_stack_constraint_error,
)

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_no_jax():
    # every module of the port, walked (not listed): none may load JAX, optax
    # or the JAX package
    code = (
        "import importlib, pkgutil, sys\n"
        "import pytorchwavenetvocoder_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "pkg.__name__ + '.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "need = {'bin.decode', 'bin.train', 'bin.convert_checkpoint', "
        "'bin.profile_ar', 'bin.profile_stack', 'bin.matmul_chain_probe', "
        "'parallel.distributed', 'parallel.train', 'parallel.checkpoint', "
        "'convert', 'ops.ar_kernel', 'ops.train_kernel', "
        "'ops.matmul_chain', 'data.generator', 'native', 'bin.calc_stats', "
        "'bin.noise_shaping', 'bin.feature_extract', 'bin.eval_mcd', "
        "'dsp.world', 'dsp.harvest', 'dsp.torch_dsp', 'dsp.harvest_torch', "
        "'eval.mcd', 'eval.klatt'}\n"
        "missing = {n for n in need if pkg.__name__ + '.' + n not in names}\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'optax', 'pytorchwavenetvocoder_tpu')]\n"
        "print(len(names), sorted(missing), bad)\n"
        "sys.exit(1 if bad or missing else 0)\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_host_clis_start_without_torch():
    """The recipe's host CLIs (each stage a process of its own) import no
    torch: the package's and ``ops``' names load at first use."""
    code = (
        "import sys\n"
        "import pytorchwavenetvocoder_tpu_torch.bin.feature_extract\n"
        "import pytorchwavenetvocoder_tpu_torch.bin.calc_stats\n"
        "import pytorchwavenetvocoder_tpu_torch.bin.noise_shaping\n"
        "import pytorchwavenetvocoder_tpu_torch.bin.eval_mcd\n"
        "import pytorchwavenetvocoder_tpu_torch as pkg\n"
        "assert 'torch' not in sys.modules, 'torch imported'\n"
        "from pytorchwavenetvocoder_tpu_torch.ops import StandardScaler\n"
        "assert 'torch' not in sys.modules, 'torch imported by ops'\n"
        "from pytorchwavenetvocoder_tpu_torch.ops import FusedLayerStack\n"
        "assert pkg.WaveNetConfig.__module__.endswith('models.wavenet')\n"
        "assert pkg.encode_mu_law is not None and 'torch' in sys.modules\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def _tiny(**kw):
    base = dict(n_quantize=256, n_aux=8, n_resch=16, n_skipch=16,
                dilation_depth=3, dilation_repeat=1, kernel_size=2,
                upsampling_factor=0)
    base.update(kw)
    return WaveNetConfig(**base)


def test_cuda_impl_on_cpu_raises():
    cfg = _tiny(compute_dtype="bfloat16")
    params = init_wavenet_params(cfg, torch.Generator().manual_seed(0))
    rng = np.random.RandomState(0)
    x = rng.randint(0, 256, (2, cfg.receptive_field)).astype(np.int32)
    h = rng.randn(2, cfg.receptive_field + 5, cfg.n_aux).astype(np.float32)
    with pytest.raises(ValueError, match="CUDA device"):
        batch_fast_generate(params, cfg, x, h, [5, 5], impl="cuda")
    # int8 decode serves kernel_size 2 and 3; kernel_size 4 raises
    cfg4 = _tiny(compute_dtype="bfloat16", kernel_size=4)
    params4 = init_wavenet_params(cfg4, torch.Generator().manual_seed(0))
    x4 = rng.randint(0, 256, (2, cfg4.receptive_field)).astype(np.int32)
    h4 = rng.randn(2, cfg4.receptive_field + 5, cfg4.n_aux).astype(np.float32)
    with pytest.raises(NotImplementedError, match="int8"):
        batch_fast_generate(params4, cfg4, x4, h4, [5, 5], quantize=True)
    # kernel_size 3 decodes in int8 on the plain route
    cfg3 = _tiny(compute_dtype="bfloat16", kernel_size=3)
    params3 = init_wavenet_params(cfg3, torch.Generator().manual_seed(0))
    x3 = rng.randint(0, 256, (2, cfg3.receptive_field)).astype(np.int32)
    h3 = rng.randn(2, cfg3.receptive_field + 5, cfg3.n_aux).astype(np.float32)
    out = batch_fast_generate(params3, cfg3, x3, h3, [5, 4], quantize=True)
    assert [len(o) for o in out] == [5, 4]
    with pytest.raises(ValueError, match="impl"):
        batch_fast_generate(params, cfg, x, h, [5, 5], impl="scan")


def test_kernel_envelopes_name_what_is_out():
    flag = WaveNetConfig(compute_dtype="bfloat16")
    assert ar_kernel_constraint_error(flag) is None
    assert layer_stack_constraint_error(flag) is None
    assert "kernel_size" in ar_kernel_constraint_error(
        WaveNetConfig(compute_dtype="bfloat16", kernel_size=4))
    # the ljspeech models' kernel_size 3, bf16 and int8, warm-up and loop
    lj = WaveNetConfig(compute_dtype="bfloat16", kernel_size=3, n_aux=39,
                       upsampling_factor=110)
    assert ar_kernel_constraint_error(lj) is None
    assert ar_kernel_constraint_error(lj, quantize=True) is None
    assert layer_stack_constraint_error(lj) is None
    assert "kernel_size" in layer_stack_constraint_error(
        WaveNetConfig(compute_dtype="bfloat16", kernel_size=4))
    # float32 configs decode through the bf16 pack, as the JAX kernel's;
    # float64 (the exactness tests' dtype) is out
    assert ar_kernel_constraint_error(WaveNetConfig()) is None
    assert "compute_dtype" in ar_kernel_constraint_error(
        WaveNetConfig(compute_dtype="float64"))
    assert "n_resch" in ar_kernel_constraint_error(
        WaveNetConfig(compute_dtype="bfloat16", n_resch=100))
    # every aux width to AUX_MAX (a speaker-coded 128-band mel model is
    # 129); the first past it is refused
    for n_aux in (97, 129, 200, AUX_MAX):
        wide = WaveNetConfig(compute_dtype="bfloat16", n_aux=n_aux)
        assert layer_stack_constraint_error(wide) is None
        assert ar_kernel_constraint_error(wide) is None
        assert ar_kernel_constraint_error(wide, quantize=True) is None
    past = WaveNetConfig(compute_dtype="bfloat16", n_aux=AUX_MAX + 1)
    assert "n_aux" in layer_stack_constraint_error(past)
    assert "n_aux" in ar_kernel_constraint_error(past)
    # the int8 variant: the bf16 envelope and kernel_size 2 or 3, at every
    # n_resch the bf16 route takes (its integer products are exact at any
    # width); past K2's MAX_RESCH the warm-up kernel refuses both, and the
    # cuda route raises naming n_resch, int8 as bf16
    assert ar_kernel_constraint_error(flag, quantize=True) is None
    why = ar_kernel_constraint_error(
        WaveNetConfig(compute_dtype="bfloat16", kernel_size=4), quantize=True)
    assert "int8" in why and "kernel_size" in why
    for n_resch in (1152, 2048):
        wide = WaveNetConfig(compute_dtype="bfloat16", n_resch=n_resch)
        assert ar_kernel_constraint_error(wide, quantize=True) is None
        assert ar_kernel_constraint_error(wide) is None
        assert layer_stack_constraint_error(wide) is None
    past = WaveNetConfig(compute_dtype="bfloat16", n_resch=MAX_RESCH + 128)
    assert "n_resch" in layer_stack_constraint_error(past)
    for quantize in (False, True):
        with pytest.raises(NotImplementedError, match="n_resch"):
            _check_impl("cuda", past, torch.device("cuda"), quantize)
    assert ar_kernel_constraint_error(WaveNetConfig(), quantize=True) is None
    assert "compute_dtype" in ar_kernel_constraint_error(
        WaveNetConfig(compute_dtype="float64"), quantize=True)


@pytest.mark.parametrize("kw, what", [
    (dict(n_resch=2176), "n_resch"),          # only the warm-up kernel refuses
    (dict(kernel_size=4), "kernel_size"),
    (dict(compute_dtype="float64"), "compute_dtype"),
])
def test_check_impl_refuses_before_any_work(kw, what):
    # the whole CUDA envelope (warm-up and AR kernels) is checked up front;
    # the device object alone is enough, no card is touched
    cfg = WaveNetConfig(**dict(dict(compute_dtype="bfloat16"), **kw))
    with pytest.raises(NotImplementedError, match=what):
        _check_impl("cuda", cfg, torch.device("cuda"), False)
    assert _check_impl("plain", cfg, torch.device("cpu"), False) == "plain"


@pytest.mark.parametrize("quantize", [False, True])
def test_check_impl_auto_serves_float32_configs(quantize):
    # a float32 conf (what the JAX bin/convert_checkpoint.py writes for a
    # reference checkpoint) resolves to the kernels on a CUDA device, from
    # the envelopes alone: no card is touched
    for k in (2, 3):
        cfg = WaveNetConfig(compute_dtype="float32", kernel_size=k)
        assert _check_impl("auto", cfg, torch.device("cuda"), quantize) \
            == "cuda"
        assert _check_impl("cuda", cfg, torch.device("cuda"), quantize) \
            == "cuda"
        assert _check_impl("auto", cfg, torch.device("cpu"), quantize) \
            == "plain"


@pytest.mark.parametrize("kw, what", [
    (dict(kernel_size=4), "kernel_size"),
    (dict(n_aux=AUX_MAX + 1), "n_aux"),
    (dict(compute_dtype="float64"), "compute_dtype"),
])
def test_check_impl_auto_raises_outside_the_envelope(kw, what):
    # on a CUDA device auto means the kernels: where an envelope refuses
    # the config (and no padding of the channel widths can serve it) it
    # raises with the envelope's reason, as cuda does, and never decodes
    # plainly on the card; on the CPU it is plain
    cfg = WaveNetConfig(**dict(dict(compute_dtype="bfloat16"), **kw))
    for impl in ("auto", "cuda"):
        with pytest.raises(NotImplementedError, match=what):
            _check_impl(impl, cfg, torch.device("cuda"), False)
    assert _check_impl("auto", cfg, torch.device("cpu"), False) == "plain"
    assert _check_impl("plain", cfg, torch.device("cuda"), False) == "plain"


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("kw", [
    # the sd-mini recipe's widths (egs/arctic/sd-mini/run.sh)
    dict(n_resch=32, n_skipch=16, dilation_depth=5, dilation_repeat=1),
    dict(n_resch=64),
    dict(n_skipch=192),
])
def test_check_impl_serves_widths_off_the_kernels_tiling(kw, quantize):
    # channel widths off the kernels' multiples are zero-padded to them on
    # the cuda route, so auto and cuda resolve to the kernels on a CUDA
    # device (from the envelopes alone: no card is touched)
    cfg = WaveNetConfig(**dict(dict(compute_dtype="bfloat16"), **kw))
    for impl in ("auto", "cuda"):
        assert _check_impl(impl, cfg, torch.device("cuda"), quantize) \
            == "cuda"
    assert _check_impl("auto", cfg, torch.device("cpu"), quantize) == "plain"


def test_float32_configs_run_on_the_kernels_as_bf16():
    # the cuda route runs a float32 conf as the bf16 conf on the same
    # weights; bf16 confs (and float64 ones, which it refuses) stay as
    # they are
    from pytorchwavenetvocoder_tpu_torch.models.wavenet import _kernel_config

    for k in (2, 3):
        cfg = WaveNetConfig(compute_dtype="float32", kernel_size=k)
        got = _kernel_config(cfg)
        assert got.compute_dtype == "bfloat16"
        assert got == WaveNetConfig(compute_dtype="bfloat16", kernel_size=k)
    for dt in ("bfloat16", "float64"):
        cfg = WaveNetConfig(compute_dtype=dt)
        assert _kernel_config(cfg) is cfg


@pytest.mark.parametrize("kw, B, route", [
    (dict(kernel_size=2), 32, "units"),
    (dict(kernel_size=2), 1024, "stream"),
    (dict(kernel_size=3), 16, "units"),
    (dict(kernel_size=3), 4096, "stream"),
    # no cut of the gate into units fits shared memory: it streams
    (dict(kernel_size=3, n_resch=768), 1, "stream"),
    (dict(kernel_size=3, n_resch=1024), 16, "stream"),
])
def test_ar_route_from_the_plan_and_the_fleet(kw, B, route):
    # one kernel (the launch loop is gone); its gate design is decided from
    # what the wrapper can see before any work: whether the gate has a cut
    # into units, and the fleet against AR_STREAM_FROM_B
    from pytorchwavenetvocoder_tpu_torch.ops.ar_kernel import (
        AR_STREAM_FROM_B,
        H100_SMS,
        _plan_units,
        ar_gate,
    )

    cfg = WaveNetConfig(**dict(dict(compute_dtype="bfloat16", n_resch=512,
                                    n_skipch=256), **kw))
    assert ar_gate(cfg, B) == route
    start = AR_STREAM_FROM_B[(cfg.kernel_size, False)]
    if route == "units":
        assert ar_gate(cfg, start) == "stream"
        # below the threshold: the cut into units wherever it gives every
        # block one unit at most
        units = _plan_units(cfg, False, start - 1, H100_SMS)
        one_each = units["stages"]["gate"]["units"] <= H100_SMS
        assert ar_gate(cfg, start - 1) == ("units" if one_each else "stream")


def test_wrapper_refuses_other_devices():
    cfg = _tiny(compute_dtype="bfloat16")
    params = init_wavenet_params(cfg, torch.Generator().manual_seed(0),
                                 device="meta")
    carry = (torch.empty((7, 2, 32), device="meta"),
             torch.empty((2, 1), dtype=torch.int32, device="meta"),
             torch.empty((2,), dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        ar_generate(params, cfg, carry, torch.empty((2, 20, 8),
                                                     device="meta"),
                    8, 4, "argmax")


def test_load_jax_checkpoint_without_optax_or_jax(tmp_path, monkeypatch):
    from pytorchwavenetvocoder_tpu.models.wavenet import (
        WaveNetConfig as JConfig,
    )
    from pytorchwavenetvocoder_tpu.parallel import (
        create_train_state,
        save_checkpoint,
        save_model_conf,
    )

    from pytorchwavenetvocoder_tpu_torch.parallel.checkpoint import (
        OpaqueState,
        load_checkpoint,
        load_model_conf,
    )

    jcfg = JConfig(n_aux=8, n_resch=16, n_skipch=16, dilation_depth=3,
                   dilation_repeat=1, upsampling_factor=10)
    state = create_train_state(jax.random.PRNGKey(0), jcfg, lr=1e-3,
                               weight_decay=1e-4)
    path = save_checkpoint(str(tmp_path), state, iterations=7)
    save_model_conf(str(tmp_path), dict(jcfg.to_dict(), feature_type="world"))
    want = {g: {k: np.asarray(v) for k, v in leaves.items()}
            for g, leaves in state.params.items()}
    for name in list(sys.modules):
        if name.split(".")[0] in ("optax", "jax", "jaxlib"):
            monkeypatch.setitem(sys.modules, name, None)
    payload = load_checkpoint(path)
    assert payload["iterations"] == 7
    assert payload["model"].keys() == want.keys()
    for group, leaves in want.items():
        assert payload["model"][group].keys() == leaves.keys()
        for name, v in leaves.items():
            got = payload["model"][group][name]
            assert isinstance(got, np.ndarray)
            np.testing.assert_array_equal(got, v)
    opt = payload["optimizer"]
    found = []

    def walk(node):
        if isinstance(node, OpaqueState):
            found.append(type(node).pickled_class)
        if isinstance(node, tuple):
            for n in node:
                walk(n)

    walk(opt)
    assert any("ScaleByAdamState" in f for f in found), found
    assert load_model_conf(str(tmp_path))["n_resch"] == 16


def test_restricted_unpickler_refuses_other_classes(tmp_path):
    import pickle

    from pytorchwavenetvocoder_tpu_torch.parallel.checkpoint import (
        load_checkpoint,
    )

    path = tmp_path / "evil.pkl"
    with open(path, "wb") as f:
        pickle.dump({"model": {}, "x": subprocess.CompletedProcess([], 0)}, f)
    with pytest.raises(pickle.UnpicklingError, match="subprocess"):
        load_checkpoint(str(path))
