"""The matmul-chain probe (``scripts/matmul_chain_probe.py``) and its port
on the CPU: the port's plain chain against the JAX Pallas kernel itself.

The script runs as it is (``runpy``, argv ``B n variant``) with
``pallas_call`` in interpret mode; its first chain call's inputs and output
are captured and the run stops there.  ``jax.jit`` is the identity for the
run (the capture needs concrete arrays), x64 is off as the script expects,
and its compilation-cache settings are dropped, so nothing is written
beside it.
"""

import os
import runpy
import sys

import numpy as np
import pytest
import torch

import jax
from jax.experimental import pallas as pl

from pytorchwavenetvocoder_tpu_torch.bin import matmul_chain_probe as probe
from pytorchwavenetvocoder_tpu_torch.ops import matmul_chain as mc

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "scripts", "matmul_chain_probe.py")

#: the order in which the script hands its weights to pallas_call
#: (`:61-88` there; full and dual also ship ws, which they never read)
SHIPPED = {"split": ("wc", "wp", "ws"), "merged": ("wm", "ws"),
           "spine": ("wc", "ws"), "full": ("wc", "ws", "wb"),
           "dual": ("wc", "ws", "wb"), "int8": ("w1", "w2", "wsc"),
           "int8raw": ("w1", "w2")}


class _Captured(Exception):
    pass


def _jax_probe(monkeypatch, B, n, variant):
    """(x0, {name: weight}, out) of the script's first chain call, numpy."""
    cap = {}
    real_pallas_call = pl.pallas_call
    real_update = jax.config.update

    def pallas_call(kernel, **kw):
        f = real_pallas_call(kernel, **dict(kw, interpret=True))

        def call(*args):
            out = f(*args)
            cap["args"] = [np.asarray(a) for a in args]
            cap["out"] = np.asarray(out)
            raise _Captured
        return call

    def update(name, value):
        if "cache" not in name:
            real_update(name, value)

    monkeypatch.setattr(pl, "pallas_call", pallas_call)
    monkeypatch.setattr(jax, "jit", lambda f, *a, **k: f)
    monkeypatch.setattr(jax.config, "update", update)
    monkeypatch.setattr(sys, "argv", [SCRIPT, str(B), str(n), variant])
    # the script's int32 shifts take a Python int, which x64 (on in this
    # suite) would make int64
    with jax.enable_x64(False), pytest.raises(_Captured):
        runpy.run_path(SCRIPT, run_name="__main__")
    x0, *weights = cap["args"]
    return x0, dict(zip(SHIPPED[variant], weights)), cap["out"]


# at B=8 and two steps: the bf16 chains grow (~700 from randn) but stay
# finite, and the step boundary (int8's bf16 carry, int8raw's truncation)
# is crossed once
@pytest.mark.parametrize("variant", mc.VARIANTS)
def test_plain_chain_matches_the_jax_pallas_kernel(monkeypatch, variant):
    B, n = 8, 2
    x0, weights, out = _jax_probe(monkeypatch, B, n, variant)
    assert x0.shape == (B, mc.R) and out.shape == (B, mc.R)
    w = mc.chain_weights_from_numpy(weights)
    x = torch.from_numpy(x0.astype(np.float32)).to(torch.bfloat16)
    got = mc.matmul_chain_reference(x, w, variant, n)
    assert got.dtype == torch.bfloat16 and got.shape == (B, mc.R)
    got = got.float().numpy()
    want = out.astype(np.float32)
    assert np.isfinite(want).all() and np.isfinite(got).all()
    if variant == "int8raw":
        # integer products and shifts: exact in both
        np.testing.assert_array_equal(got, want)
        return
    # f32 sums in another order (XLA's dot against PyTorch's) round a few
    # bf16 values the other way, and the chain carries every flip through
    # the later layers and steps: the same plain chain with f64 instead of
    # f32 sums moves by 1.4e-2 to 1.5e-2 of max|out| (B=128, two steps),
    # and this comparison reads 1.1e-2 to 1.7e-2 (2-3.5 bf16 ulps at the
    # largest values), so the limit is 3e-2.  int8: the integer products
    # and the dequantization agree exactly, but sigmoid and tanh an f32 ulp
    # apart flip a gate quantum now and then, which moves every column of
    # its row a little: 8.3e-3 of max|out| in 7.8% of the elements here;
    # limits 2e-2 and 25%.  A dropped weight or a per-tensor scale moves
    # the output by its own size.
    d = np.abs(got - want)
    rel = d.max() / np.abs(want).max()
    if variant == "int8":
        assert rel <= 2e-2 and (d > 0).mean() <= 0.25, (rel, (d > 0).mean())
    else:
        assert rel <= 3e-2, rel


def test_wrapper_takes_the_plain_version_on_the_cpu():
    gen = torch.Generator().manual_seed(3)
    w = mc.make_chain_weights("int8raw", gen)
    x0 = torch.randn((5, mc.R), generator=gen).to(torch.bfloat16)
    before = mc.matmul_chain.launches
    got = mc.matmul_chain(x0, w, "int8raw", 2)
    assert mc.matmul_chain.launches == before     # no kernel launch
    assert torch.equal(got, mc.matmul_chain_reference(x0, w, "int8raw", 2))
    with pytest.raises(ValueError, match="unsupported device"):
        mc.matmul_chain(x0.to("meta"), w, "int8raw", 2)
    with pytest.raises(ValueError, match="variant"):
        mc.matmul_chain(x0, w, "tiled", 2)


@pytest.mark.parametrize("variant", mc.VARIANTS)
def test_weights_have_the_script_shapes_and_bytes(variant):
    w = mc.make_chain_weights(variant, torch.Generator().manual_seed(0))
    assert tuple(w) == mc.VARIANT_WEIGHTS[variant]
    assert sum(t.numel() * t.element_size() for t in w.values()) == \
        mc.weight_bytes(variant)
    for name, t in w.items():
        if t.dtype == torch.int8:
            assert t.abs().max() <= 127
        elif name == "wsc":
            assert t.min() >= 1e-4
        else:   # randn x 0.02
            assert 0.015 < t.float().std() < 0.025
    # the weights the variant reads, each once: 86.5 / 55.1 / 62.9 / 43.6 /
    # 43.3 MB (split and merged / spine / full and dual / int8 / int8raw)
    mb = {"split": 86.5, "merged": 86.5, "spine": 55.1, "full": 62.9,
          "dual": 62.9, "int8": 43.6, "int8raw": 43.3}[variant]
    assert abs(mc.weight_bytes(variant) / 1e6 - mb) < 0.1
    # the script's FLOP count (`:222-228`)
    R, S, L = mc.R, mc.S, mc.L
    want = {"split": 2 * 4 * R * (2 * 2 * R + (S + R)) * L,
            "merged": 2 * 4 * (2 * R) * (2 * R) * L + 2 * 4 * R * (S + R) * L,
            "spine": 2 * 4 * R * (2 * R + S + R) * L,
            "full": 2 * 4 * R * 2 * R * 2 * L,
            "dual": 2 * 4 * R * 2 * R * 2 * L,
            "int8": 2 * 4 * R * (4 * R + S + R) * L,
            "int8raw": 2 * 4 * R * (4 * R + S + R) * L}[variant]
    assert mc.step_ops(variant, 4) == want


@pytest.mark.parametrize("variant, cw1, cw2", [("split", 16, 32),
                                               ("int8", 16, 64)])
def test_packed_units_hold_the_unit_columns(variant, cw1, cw2):
    # the kernel's unit (layer l, column group g) reads one run of tiles:
    # [K/16][quarters * cw/16][16][16] over columns q * N/quarters + g * cw
    w = mc.make_chain_weights(variant, torch.Generator().manual_seed(1))
    p1, p2 = mc.pack_chain_weights(w, variant, cw1, cw2)
    full1 = (torch.cat([w["wc"], w["wp"]], dim=1) if variant == "split"
             else w["w1"])
    quarters = 4 if variant == "int8" else 1
    for packed, ref, q, cw in ((p1, full1, quarters, cw1),
                               (p2, w["ws" if variant == "split" else "w2"],
                                1, cw2)):
        Lw, K, N = ref.shape
        G = N // (q * cw)
        assert packed.shape == (Lw, G, K // 16, q * cw // 16, 16, 16)
        rng = np.random.RandomState(0)
        for _ in range(50):
            l, g, k = rng.randint(Lw), rng.randint(G), rng.randint(K)
            qq, cc = rng.randint(q), rng.randint(cw)
            col, lc = qq * (N // q) + g * cw + cc, qq * cw + cc
            assert packed[l, g, k // 16, lc // 16, k % 16, lc % 16] == \
                ref[l, k, col]


def test_weights_from_numpy_refuse_other_shapes():
    with pytest.raises(ValueError, match="shape"):
        mc.chain_weights_from_numpy({"wc": np.zeros((2, 3), np.float32)})
    with pytest.raises(ValueError, match="unknown"):
        mc.chain_weights_from_numpy({"wz": np.zeros((2, 3), np.float32)})


def test_probe_cli_on_the_cpu(capsys):
    res = probe.main(["8", "2", "split", "--device", "cpu"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("chain B=8 variant=split: ")
    assert "us/step" in line and "T(FL)OPs" in line and "cpu" in line
    assert res["out"].shape == (8, mc.R)
    assert torch.isfinite(res["out"].float()).all()
    assert res["us_per_step"] > 0


def test_probe_cli_defaults_to_cuda_and_says_so():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs the kernel")
    with pytest.raises(RuntimeError, match="--device cuda"):
        probe.main(["8", "2", "split"])
