"""QLoRA in the port (ggml_tpu_torch): planar_matmul's backward and LoRA
finetuning over a base kept in planes, against the JAX package.

- planar_matmul's dx (dequantize the planes to bf16, multiply the bf16
  gradient with them, f32 sums) against jax.vjp of the JAX planar_matmul
  (its Pallas forward in interpret mode) for compact Q4_K, Q4_0, Q8_0 and
  Q6_K planes at M = 5 and M = 40 (the GEMV and the matmul forwards): the
  same bf16 operands, f32 sums in another order, NMSE <= 1e-6 (they read
  1e-12 or below).  Against autograd through the exactly dequantized f32
  weight: NMSE <= 1e-4, the bf16 operands' rounding (the JAX package's own
  gate, tests/test_qlora.py).
- finetune_lora(keep_quantized=True) of a 2-layer GPT-J Q4_K GGUF (n_embd 256,
  its weights the matmul forward's nibble and compact planes at 64 rows)
  against JAX's, 3 AdamW steps at lr 1e-3: losses within 1e-4, every `a`
  within NMSE 1e-9 (they read 1e-10 or below), every `b` within NMSE 1e-3
  with at most one element in 1000 farther than 1e-4 from JAX's.  Each
  forward rounds x to bf16 before every planar product, so f32 sums in
  another order move single roundings (the step-0 logits differ by NMSE
  1e-7), and AdamW's first step moves each element of b (zero at init) by
  lr times the sign of its gradient, whatever the gradient's size: a
  gradient element near zero can take the other sign (4 of 18432 elements
  differ by more than 1e-4, the largest by 1.9e-3; b's NMSE reads 2e-7 to
  1.3e-4).
- The base planes are bit for bit the same after training, and b = 0 leaves
  the wrapped forward equal to the base's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggml_tpu.dtypes import GGMLType as JGGMLType
from ggml_tpu.kernels import qmatmul as jqmatmul
from ggml_tpu.opt import AdamWConfig as JaxAdamWConfig
from ggml_tpu.opt import finetune_lora as jax_finetune_lora
from ggml_tpu.quant import planar as jplanar
from ggml_tpu_torch.dtypes import GGMLType
from ggml_tpu_torch.gguf import GGUFFile
from ggml_tpu_torch.kernels import qmatmul
from ggml_tpu_torch.models import gpt2, gptj
from ggml_tpu_torch.opt import AdamWConfig, Optimizer, finetune_lora, make_lm_model_fn
from ggml_tpu_torch.opt.lora import init_lora, wrap_lora
from ggml_tpu_torch.quant.planar import PlanarWeight, repack
from ggml_tpu_torch.quant.reference import dequantize
from tests.test_torch_rules import nmse, one_thread, random_raw  # noqa: F401  (one_thread: the autouse fixture)

N, K = 192, 512
FORMATS = [GGMLType.Q4_K, GGMLType.Q4_0, GGMLType.Q8_0, GGMLType.Q6_K]
CFG = gptj.GPTJConfig(n_vocab=256, n_ctx=128, n_embd=256, n_head=4, n_layer=2, n_rot=32)
SEQ, BATCH, STEPS = 32, 2, 3


def _weights(t: GGMLType):
    raw = random_raw(t, N, K, seed=int(t) + 3)
    jpw = jplanar.repack(raw, JGGMLType(int(t)), (N, K), backend="numpy")
    dense = dequantize(raw.reshape(-1), t, N * K).reshape(N, K)
    return repack(raw, t, (N, K)), jpw, dense


@pytest.fixture(scope="module", params=FORMATS, ids=lambda t: t.name)
def weights(request):
    return _weights(request.param)


@pytest.mark.parametrize("m", [5, 40], ids=["M5-gemv", "M40-matmul"])
def test_dx_matches_jax_vjp(weights, m):
    pw, jpw, _ = weights
    rng = np.random.default_rng(m)
    x = rng.standard_normal((m, K)).astype(np.float32)
    g = rng.standard_normal((m, N)).astype(np.float32)
    _, vjp = jax.vjp(lambda v: jqmatmul.planar_matmul(v, jpw, interpret=True), jnp.asarray(x))
    (want,) = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    y = qmatmul.planar_matmul(xt, pw)
    (got,) = torch.autograd.grad(y, xt, torch.from_numpy(g))
    assert got.dtype == torch.float32 and got.shape == (m, K)
    assert nmse(np.asarray(want), got.numpy()) <= 1e-6
    assert pw.k == K and all(not t.requires_grad for t in pw.buffers())


def test_dx_matches_the_dense_gradient(weights):
    pw, _, dense = weights
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((40, K)).astype(np.float32))
    t = torch.from_numpy(rng.standard_normal((40, N)).astype(np.float32))
    grads = []
    for fn in (lambda v: qmatmul.planar_matmul(v, pw), lambda v: v @ torch.from_numpy(dense).t()):
        v = x.clone().requires_grad_()
        ((fn(v) - t) ** 2).sum().backward()
        grads.append(v.grad.numpy())
    assert nmse(grads[1], grads[0]) <= 1e-4


def test_planar_matmul_without_grad_takes_no_autograd_node(weights):
    pw, _, _ = weights
    x = torch.ones((3, K))
    assert qmatmul.planar_matmul(x, pw).grad_fn is None
    with torch.no_grad():
        assert qmatmul.planar_matmul(x.requires_grad_(), pw).grad_fn is None


@pytest.fixture(scope="module")
def tiny_q4k(tmp_path_factory):
    path = tmp_path_factory.mktemp("qlora") / "gptj-q4k.gguf"
    gptj.write_random_gguf(path, CFG, seed=3)
    return path


def _tokens():
    pattern = np.random.default_rng(0).integers(0, CFG.n_vocab, 13)
    return np.resize(pattern, BATCH * SEQ * 4 + 1).astype(np.int32)


@pytest.fixture(scope="module")
def runs(tiny_q4k):
    kw = dict(rank=4, keep_quantized=True, seq_len=SEQ, batch=BATCH, steps=STEPS)
    want = jax_finetune_lora(str(tiny_q4k), _tokens(), adamw=JaxAdamWConfig(alpha=1e-3), **kw)
    got = finetune_lora(str(tiny_q4k), _tokens(), adamw=AdamWConfig(alpha=1e-3), device="cpu", **kw)
    return want, got


def test_qlora_finetune_matches_jax(runs):
    (jl, jlora), (tl, tlora) = runs
    assert len(tl) == STEPS and np.abs(np.array(jl) - np.array(tl)).max() <= 1e-4, (jl, tl)
    assert tl[-1] < tl[0]
    assert set(tlora) == set(jlora) and len(tlora) == 6 * CFG.n_layer  # JAX returns its pytree sorted
    far = total = 0
    for name, ab in tlora.items():
        assert nmse(np.asarray(jlora[name]["a"]), ab["a"].numpy()) <= 1e-9, name
        assert nmse(np.asarray(jlora[name]["b"]), ab["b"].numpy()) <= 1e-3, name
        d = np.abs(np.asarray(jlora[name]["b"]) - ab["b"].numpy())
        far, total = far + int((d > 1e-4).sum()), total + d.size
    assert far <= total // 1000, (far, total)


def test_qlora_trains_through_the_matmul_forward(tiny_q4k):
    """At batch * seq = 64 rows every planar weight takes kernel C's path."""
    with GGUFFile(tiny_q4k) as g:
        base = gpt2.load_params(g, torch.float32, keep_quantized=True, device="cpu")
    planes = {k: v for k, v in base.items() if isinstance(v, PlanarWeight) and k != "token_embd.weight"}
    assert len(planes) == 6 * CFG.n_layer + 1
    assert {qmatmul.select_kernel(pw, BATCH * SEQ) for pw in planes.values()} == {"q4k_matmul"}
    assert {pw.d is None for pw in planes.values()} == {True, False}  # nibble planes and compact ones


def test_base_planes_stay_unchanged_and_b0_is_the_identity(tiny_q4k):
    with GGUFFile(tiny_q4k) as g:
        base = gpt2.load_params(g, torch.float32, keep_quantized=True, device="cpu")
        cfg = gptj.config_from_gguf(g)
    before = {k: [t.clone() for t in v.buffers()] for k, v in base.items() if isinstance(v, PlanarWeight)}
    lora = init_lora(base, 4)
    fn = make_lm_model_fn(gptj, cfg, SEQ, BATCH)
    x = torch.from_numpy(_tokens()[: BATCH * SEQ].reshape(BATCH, SEQ)).long()
    with torch.no_grad():
        assert torch.equal(fn(wrap_lora(base, lora, 1.0), x), fn(base, x))
    opt = Optimizer(lambda p, toks, frozen: fn(wrap_lora(frozen, p, 1.0), toks), lora,
                    loss_type="cross_entropy_sparse", adamw=AdamWConfig(alpha=1e-2), frozen=base)
    losses = [float(opt.step(x, torch.roll(x, -1, 1))["loss"]) for _ in range(3)]
    assert losses[-1] < losses[0]
    assert any(float(ab["b"].abs().max()) > 0 for ab in opt.params.values())
    for k, planes in before.items():
        assert all(torch.equal(a, b) for a, b in zip(planes, base[k].buffers())), k
    assert dataclasses.asdict(cfg)["rope_deinterleaved"] is False  # file order, as finetune_lora trains
