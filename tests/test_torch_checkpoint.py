"""The port's checkpoints (ggml_tpu_torch.checkpoint) against the JAX
package's format and its resume contract, on the CPU.

- A nested dict of tensors (f32 and bf16, a 0-d one) and its metadata
  (int, float, bool, str) round trip; bf16 comes back as the f32 it widens to.
- Resume is bit-exact: 10 AdamW steps in one run equal 5 steps, a
  checkpoint, a fresh Optimizer loading it and 5 more, for flat and nested
  (LoRA-shaped) params, f32 and bf16 moments, and an accumulation period
  stopped in its middle.
- A port checkpoint read by JAX's checkpoint.load_params (and a JAX one by
  the port's, integer tensors too) gives the same tensor names, values and
  counters.
- latest_checkpoint skips a truncated file and takes the one before it.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ggml_tpu import checkpoint as jckpt
from ggml_tpu.opt import AdamWConfig as JaxAdamWConfig
from ggml_tpu.opt import Optimizer as JaxOptimizer
from ggml_tpu_torch import checkpoint as ckpt
from ggml_tpu_torch.opt import AdamWConfig, Optimizer
from tests.test_torch_rules import one_thread  # noqa: F401  (the autouse fixture)

RNG = np.random.default_rng(21)
W = RNG.standard_normal((4, 3)).astype(np.float32)
X = RNG.standard_normal((16, 4)).astype(np.float32)
Y = (X @ RNG.standard_normal((4, 3)).astype(np.float32)).astype(np.float32)


def _flat_model(p, x):
    return x @ p["w"] + p["b"]


def _nested_model(p, x):
    return x @ (p["layer"]["w"] + p["layer"]["b"] @ p["layer"]["a"]) + p["bias"]


def _params(nested: bool):
    if nested:  # a LoRA-shaped tree
        return {"layer": {"w": torch.from_numpy(W), "a": torch.full((2, 3), 0.1), "b": torch.full((4, 2), 0.05)},
                "bias": torch.zeros(3)}
    return {"w": torch.from_numpy(W), "b": torch.zeros(3)}


def test_params_round_trip(tmp_path):
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "nested": {"b": torch.ones(4, dtype=torch.bfloat16) / 3, "c": torch.tensor(2.5)}}
    p = tmp_path / "p.gguf"
    ckpt.save_params(p, tree, metadata={"step": 7, "lr": 0.5, "done": True, "note": "hi"})
    back, md = ckpt.load_params(p, device="cpu")
    assert torch.equal(back["a"], tree["a"])
    assert back["nested"]["b"].dtype == torch.float32 and torch.equal(back["nested"]["b"], tree["nested"]["b"].float())
    assert back["nested"]["c"].shape == (1,) and float(back["nested"]["c"][0]) == 2.5
    assert md["step"] == 7 and md["lr"] == 0.5 and md["done"] is True and md["note"] == "hi"
    assert md["general.architecture"] == "ggml_tpu.checkpoint" and not (tmp_path / "p.gguf.tmp").exists()
    assert ckpt.load_params(p, dtype=torch.bfloat16, device="cpu")[0]["a"].dtype == torch.bfloat16
    with pytest.raises(ValueError):
        ckpt.save_params(tmp_path / "q.gguf", {"a/b": torch.zeros(1)})


@pytest.mark.parametrize("nested", [False, True], ids=["flat", "nested"])
@pytest.mark.parametrize("state_dtype,period", [("float32", 1), ("bfloat16", 1), ("float32", 3)],
                         ids=["f32", "bf16", "period3"])
def test_resume_is_bit_exact(tmp_path, nested, state_dtype, period):
    model = _nested_model if nested else _flat_model
    cfg = AdamWConfig(alpha=0.01, wd=0.01, state_dtype=state_dtype)
    make = lambda: Optimizer(model, _params(nested), loss_type="mse", adamw=cfg, opt_period=period)
    a = make()
    for _ in range(10):
        a.step(X, Y)
    b = make()
    for _ in range(5):
        b.step(X, Y)
    path = tmp_path / "opt.gguf"
    ckpt.save_optimizer(path, b)
    c = make()
    ckpt.load_optimizer(path, c)
    assert int(c.state["t"]) == int(b.state["t"]) and int(c.state["i_acc"]) == 5 % period
    for _ in range(5):
        c.step(X, Y)
    for key in ("params", "m", "v", "g_acc", "t", "i_acc"):
        sa, sc = a.state[key], c.state[key]
        flat = lambda s: [s] if isinstance(s, torch.Tensor) else [x for v in s.values() for x in flat(v)]
        for x, y in zip(flat(sa), flat(sc)):
            assert x.dtype == y.dtype and torch.equal(x, y), key


def test_jax_reads_a_port_checkpoint_and_the_port_a_jax_one(tmp_path):
    opt = Optimizer(_nested_model, _params(True), loss_type="mse", adamw=AdamWConfig(alpha=0.01))
    for _ in range(3):
        opt.step(X, Y)
    path = tmp_path / "port.gguf"
    ckpt.save_optimizer(path, opt)
    tree, md = jckpt.load_params(path)
    assert int(md["opt.t"]) == 3 and int(md["opt.i_acc"]) == 0 and md["opt.loss_type"] == "mse"
    assert int(md["opt.period"]) == 1 and set(tree) == {"params", "m", "v", "g_acc"}
    for key in tree:
        assert set(tree[key]) == {"layer", "bias"} and set(tree[key]["layer"]) == {"w", "a", "b"}
        np.testing.assert_array_equal(np.asarray(tree[key]["layer"]["a"]), opt.state[key]["layer"]["a"].numpy())
        np.testing.assert_array_equal(np.asarray(tree[key]["bias"]), opt.state[key]["bias"].numpy())

    jopt = JaxOptimizer(lambda p, x: x @ p["w"] + p["b"], {"w": jnp.asarray(W), "b": jnp.zeros(3)},
                        loss_type="mse", adamw=JaxAdamWConfig(alpha=0.01))
    for _ in range(2):
        jopt.step(jnp.asarray(X), jnp.asarray(Y))
    jpath = tmp_path / "jax.gguf"
    jckpt.save_optimizer(jpath, jopt)
    port = Optimizer(_flat_model, _params(False), loss_type="mse", adamw=AdamWConfig(alpha=0.01))
    ckpt.load_optimizer(jpath, port)
    assert int(port.state["t"]) == 2
    for key in ("params", "m", "v"):
        for name in ("w", "b"):
            np.testing.assert_array_equal(port.state[key][name].numpy(), np.asarray(jopt.state[key][name]))
    ints = tmp_path / "ints.gguf"  # the JAX writer stores integer arrays as I8..I64 tensors
    jckpt.save_params(ints, {"n": np.arange(-3, 4, dtype=np.int32), "k": np.arange(5, dtype=np.int8)})
    back, _ = ckpt.load_params(ints, device="cpu")
    assert back["n"].dtype == torch.int32 and back["n"].tolist() == list(range(-3, 4))
    assert back["k"].dtype == torch.int8 and back["k"].tolist() == list(range(5))


def test_latest_checkpoint_skips_a_truncated_file(tmp_path):
    opt = Optimizer(_flat_model, _params(False), loss_type="mse")
    assert ckpt.latest_checkpoint(tmp_path) == (None, -1)
    for step in (2, 4):
        opt.step(X, Y)
        ckpt.save_optimizer(tmp_path / f"step{step}.gguf", opt)
    assert ckpt.latest_checkpoint(tmp_path) == (tmp_path / "step4.gguf", 4)
    data = (tmp_path / "step4.gguf").read_bytes()
    (tmp_path / "step6.gguf").write_bytes(data[:-40])  # the last (padded) tensor and part of the one before
    (tmp_path / "step9.gguf.tmp").write_bytes(data)  # a write that never got published
    (tmp_path / "stepx.gguf").write_bytes(data)
    assert ckpt.latest_checkpoint(tmp_path) == (tmp_path / "step4.gguf", 4)
    fresh = Optimizer(_flat_model, _params(False), loss_type="mse")
    ckpt.load_optimizer(ckpt.latest_checkpoint(tmp_path)[0], fresh)
    assert torch.equal(fresh.params["w"], opt.params["w"])
