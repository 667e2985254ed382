"""The PyTorch port stands alone: no JAX at import, JAX bundles load without
optax, and CUDA requests that cannot be served raise."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

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
    layer_stack_constraint_error,
)

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        "import pytorchwavenetvocoder_tpu_torch\n"
        "import pytorchwavenetvocoder_tpu_torch.bin.decode\n"
        "import pytorchwavenetvocoder_tpu_torch.bin.train\n"
        "import pytorchwavenetvocoder_tpu_torch.parallel.train\n"
        "import pytorchwavenetvocoder_tpu_torch.parallel.checkpoint\n"
        "from pytorchwavenetvocoder_tpu_torch.data import train_generator\n"
        "from pytorchwavenetvocoder_tpu_torch.ops import FusedLayerStack\n"
        "import pytorchwavenetvocoder_tpu_torch.ops.ar_kernel\n"
        "import pytorchwavenetvocoder_tpu_torch.ops.train_kernel\n"
        "import pytorchwavenetvocoder_tpu_torch.ops.matmul_chain\n"
        "import pytorchwavenetvocoder_tpu_torch.bin.matmul_chain_probe\n"
        "import pytorchwavenetvocoder_tpu_torch.parallel\n"
        "import pytorchwavenetvocoder_tpu_torch.data\n"
        "import pytorchwavenetvocoder_tpu_torch.convert\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'optax', 'pytorchwavenetvocoder_tpu')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
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
    assert "compute_dtype" in ar_kernel_constraint_error(WaveNetConfig())
    assert "n_resch" in ar_kernel_constraint_error(
        WaveNetConfig(compute_dtype="bfloat16", n_resch=96))
    assert "n_aux" in layer_stack_constraint_error(
        WaveNetConfig(compute_dtype="bfloat16", n_aux=200))
    # the int8 variant: the bf16 envelope, kernel_size 2 or 3, n_resch <= 1024
    assert ar_kernel_constraint_error(flag, quantize=True) is None
    why = ar_kernel_constraint_error(
        WaveNetConfig(compute_dtype="bfloat16", kernel_size=4), quantize=True)
    assert "int8" in why and "kernel_size" in why
    assert "n_resch" in ar_kernel_constraint_error(
        WaveNetConfig(compute_dtype="bfloat16", n_resch=1152), quantize=True)
    assert ar_kernel_constraint_error(
        WaveNetConfig(compute_dtype="bfloat16", n_resch=1152)) is None
    assert "compute_dtype" in ar_kernel_constraint_error(WaveNetConfig(),
                                                         quantize=True)


@pytest.mark.parametrize("kw, what", [
    (dict(n_resch=1152), "n_resch"),          # only the warm-up kernel refuses
    (dict(kernel_size=4), "kernel_size"),
    (dict(compute_dtype="float32"), "compute_dtype"),
])
def test_check_impl_refuses_before_any_work(kw, what):
    # the whole CUDA envelope (warm-up and AR kernels) is checked up front;
    # the device object alone is enough, no card is touched
    cfg = WaveNetConfig(**dict(dict(compute_dtype="bfloat16"), **kw))
    with pytest.raises(NotImplementedError, match=what):
        _check_impl("cuda", cfg, torch.device("cuda"), False)
    assert _check_impl("plain", cfg, torch.device("cpu"), False) == "plain"


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
