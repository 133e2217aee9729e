"""Rematerialization in the port: make_lm_model_fn(remat_policy=...) against
jax.checkpoint with the same jax.checkpoint_policies policy, on the CPU.

Four models, each under the four argument-free policies:
- a tiny f32 GPT-2 (E 32, 4 heads, 2 layers, batch 2 x 32) with its plain
  attention (no kernel on the path) and with train_flash (kernels K, L, M;
  JAX's Pallas calls in interpret mode),
- QLoRA of a tiny GPT-J Q4_K GGUF file (E 256, 2 layers; every linear at
  M = 64 takes kernel C) with a rank-4 adapter on every target,
- QLoRA of a tiny llama Q4_K GGUF file with a Q6_K head (E 256, GQA 4/2,
  2 layers; C on the linears, G on the head) with the default targets.
The adapters' b are random (not zero), so every adapter has a gradient.

For each: the port's gradients with remat equal its gradients without, bit
for bit; the kernels' plain versions run as many times under the policy as
JAX's make_jaxpr of the remat'd value_and_grad holds pallas_call equations
(a pallas_call's output is not a dot, so every policy but
everything_saveable runs the forward kernels again in the backward: C on
every linear but the head, whose output only the loss reads, and K in
every layer; L and M once each); and under nothing_saveable and bench.py's
dots_with_no_batch_dims_saveable the gradients follow JAX's under the same
policy (jitted; the compiles are most of the file's time, so not for
everything_saveable, whose jaxpr is the one without remat, nor for
dots_saveable, which recomputes what nothing_saveable does): NMSE <= 1e-10
in f32 (GPT-2; f32 sums in another order; they read at most 1.8e-13),
<= 1e-5 through the planes, where x is
rounded to bf16 before every planar product and a last-bit difference
flips single roundings, which the llama's SwiGLU spreads (GPT-J's read at
most 1.4e-7, the llama's 1.8e-6).  Unknown names and the policy factories
raise ValueError.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.extend import core as jcore

from ggml_tpu.gguf import GGUFFile as JaxGGUFFile
from ggml_tpu.models.common import causal_mask as jax_causal_mask
from ggml_tpu.models import gpt2 as jgpt2
from ggml_tpu.models import gptj as jgptj
from ggml_tpu.models import llama as jllama
from ggml_tpu.opt import lora as jlora
from ggml_tpu.opt.finetune import make_lm_model_fn as jax_make_lm_model_fn
from ggml_tpu.opt.optimizer import LOSS_TYPES as JAX_LOSS_TYPES
from ggml_tpu_torch.convert import params_from_numpy
from ggml_tpu_torch.dtypes import GGMLType
from ggml_tpu_torch.gguf import GGUFFile
from ggml_tpu_torch.kernels import flash_attn, qmatmul
from ggml_tpu_torch.models import gpt2, gptj, llama
from ggml_tpu_torch.opt import make_lm_model_fn
from ggml_tpu_torch.opt.lora import init_lora, wrap_lora
from ggml_tpu_torch.opt.optimizer import LOSS_TYPES
from tests.test_torch_rules import nmse

POLICIES = ["everything_saveable", "nothing_saveable", "dots_saveable", "dots_with_no_batch_dims_saveable"]
# each JAX compile of a value_and_grad costs 1.5-5 s alone (4-20 s in the
# tier-1 run's workers): JAX's gradients are compiled for the policy that
# saves nothing and for bench.py's
COMPILED = ("nothing_saveable", "dots_with_no_batch_dims_saveable")
MODELS = ["gpt2", "gpt2-flash", "gptj-qlora", "llama-qlora"]
SEQ, BATCH = 32, 2
GPT2_CFG = dict(n_vocab=64, n_ctx=32, n_embd=32, n_head=4, n_layer=2)
GPTJ_CFG = gptj.GPTJConfig(n_vocab=256, n_ctx=128, n_embd=256, n_head=4, n_layer=2, n_rot=32)
LLAMA_CFG = llama.LlamaConfig(n_vocab=256, n_ctx=128, n_embd=256, n_head=4, n_head_kv=2, n_layer=2, n_ff=512)
GPTJ_TARGETS = ("attn_q.weight", "attn_k.weight", "attn_v.weight", "attn_output.weight", "ffn_up.weight",
                "ffn_down.weight", "output.weight")
# the plain versions of the kernels a training step runs (C, G; K, L, M)
PLAIN = ((qmatmul, "_matmul_plain"), (qmatmul, "_q8_matmul_plain"), (flash_attn, "_fa_forward_lse_plain"),
         (flash_attn, "_fa_bwd_dq_plain"), (flash_attn, "_fa_bwd_dkv_plain"))


def pallas_calls(jaxpr) -> int:
    """pallas_call equations in a jaxpr and every jaxpr inside it."""
    n = 0
    for eqn in jaxpr.eqns:
        n += eqn.primitive.name == "pallas_call"
        for v in eqn.params.values():
            for sub in v if isinstance(v, (list, tuple)) else [v]:
                if isinstance(sub, jcore.ClosedJaxpr):
                    n += pallas_calls(sub.jaxpr)
                elif isinstance(sub, jcore.Jaxpr):
                    n += pallas_calls(sub)
    return n


def _lora_both(jbase, tbase, targets):
    """The same rank-4 adapters for both packages: init_lora's `a` (equal
    bit for bit) and a random nonzero b."""
    ja = jlora.init_lora(jbase, 4, targets=targets)
    rng = np.random.default_rng(7)
    jl, tl = {}, {}
    for name, ab in ja.items():
        b = (rng.standard_normal(ab["b"].shape) * 0.02).astype(np.float32)
        a = np.asarray(ab["a"])
        jl[name] = {"a": jnp.asarray(a), "b": jnp.asarray(b)}
        tl[name] = {"a": torch.from_numpy(a.copy()), "b": torch.from_numpy(b)}
    assert set(tl) == set(init_lora(tbase, 4, targets=targets))
    return jl, tl


@pytest.fixture(scope="module")
def setups(tmp_path_factory):
    """model -> the JAX and port model functions under a policy (jfn, tfn),
    the trainable params of both (jp, tp), how each wraps them into the
    model's params (jwrap, twrap), the tokens, and whether the path is all
    f32."""
    d = tmp_path_factory.mktemp("remat")
    # the JAX causal_mask caches its first result: made here, outside any
    # trace, so that no tracer stays in that cache
    jax_causal_mask.cache_clear()
    jax_causal_mask(SEQ)
    toks = np.random.default_rng(0).integers(0, 64, (BATCH, SEQ)).astype(np.int32)
    out = {}
    jparams = jgpt2.init_random_params(jgpt2.GPT2Config(**GPT2_CFG), seed=1)
    for name, flash in (("gpt2", False), ("gpt2-flash", True)):
        out[name] = dict(
            jfn=lambda pol, flash=flash: jax_make_lm_model_fn(jgpt2, jgpt2.GPT2Config(**GPT2_CFG), SEQ, BATCH,
                                                              remat_policy=pol, train_flash=flash),
            tfn=lambda pol, flash=flash: make_lm_model_fn(gpt2, gpt2.GPT2Config(**GPT2_CFG), SEQ, BATCH,
                                                          remat_policy=pol, train_flash=flash),
            jp=jparams, tp=params_from_numpy({k: np.asarray(v) for k, v in jparams.items()}, device="cpu"),
            jwrap=lambda p: p, twrap=lambda p: p, toks=toks, f32=True)
    for name, fam, jfam, cfg, targets, types in (
            ("gptj-qlora", gptj, jgptj, GPTJ_CFG, GPTJ_TARGETS, None),
            ("llama-qlora", llama, jllama, LLAMA_CFG, jlora.DEFAULT_TARGETS, {"output.weight": GGMLType.Q6_K})):
        path = d / f"{name}.gguf"
        fam.write_random_gguf(path, cfg, seed=3, **({"types": types} if types else {}))
        jg = JaxGGUFFile(str(path))
        jbase = dict(jgpt2.load_params(jg, jnp.float32, keep_quantized=True))
        jcfg = jfam.config_from_gguf(jg)
        with GGUFFile(path) as g:
            tbase = gpt2.load_params(g, torch.float32, keep_quantized=True, device="cpu")
            tcfg = fam.config_from_gguf(g)
        jl, tl = _lora_both(jbase, tbase, targets)
        out[name] = dict(
            jfn=lambda pol, jfam=jfam, jcfg=jcfg: jax_make_lm_model_fn(jfam, jcfg, SEQ, BATCH, remat_policy=pol),
            tfn=lambda pol, fam=fam, tcfg=tcfg: make_lm_model_fn(fam, tcfg, SEQ, BATCH, remat_policy=pol),
            jp=jl, tp=tl, jwrap=lambda p, jbase=jbase: jlora.wrap_lora(jbase, p, 1.0),
            twrap=lambda p, tbase=tbase: wrap_lora(tbase, p, 1.0), toks=toks, f32=False)
    return out


def _leaves(tree):
    return [x for v in tree.values() for x in (_leaves(v) if isinstance(v, dict) else [v])]


def _port_grads(s, policy, monkeypatch):
    """The port's loss gradients under the policy, and how often each kernel's
    plain version ran."""
    runs = {}
    for mod, name in PLAIN:
        def counted(*a, _f=getattr(mod, name), _n=name, **k):
            runs[_n] = runs.get(_n, 0) + 1
            return _f(*a, **k)
        monkeypatch.setattr(mod, name, counted)
    leaves = jax.tree.map(lambda t: t.clone().requires_grad_(), s["tp"])
    x = torch.from_numpy(s["toks"]).long()
    loss = LOSS_TYPES["cross_entropy_sparse"](s["tfn"](policy)(s["twrap"](leaves), x), x)
    grads = torch.autograd.grad(loss, _leaves(leaves))
    monkeypatch.undo()
    return grads, runs


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("model", MODELS)
def test_remat_follows_jax(setups, model, policy, monkeypatch):
    s = setups[model]
    if "plain" not in s:
        s["plain"] = _port_grads(s, None, monkeypatch)[0]
    plain = s["plain"]
    grads, runs = _port_grads(s, policy, monkeypatch)
    assert all(torch.equal(a, b) for a, b in zip(grads, plain))

    x = jnp.asarray(s["toks"])
    jfn = s["jfn"](policy)
    loss = lambda p: JAX_LOSS_TYPES["cross_entropy_sparse"](jfn(s["jwrap"](p), x), x)
    traced = jax.jit(jax.value_and_grad(loss)).trace(s["jp"])  # its jaxpr is make_jaxpr's
    want_calls = pallas_calls(traced.jaxpr.jaxpr)
    assert sum(runs.values()) == want_calls, (runs, want_calls)
    if model != "gpt2":
        assert want_calls > 0
    if policy not in COMPILED:
        return
    _, jgrads = traced.lower().compile()(s["jp"])
    gate = 1e-10 if s["f32"] else 1e-5
    for j, t in zip(jax.tree.leaves(jgrads), grads):
        assert nmse(np.asarray(j), t.numpy()) <= gate


def test_remat_counts_under_the_bench_policy(setups, monkeypatch):
    """What a step runs under dots_with_no_batch_dims_saveable: GPT-J's 13
    forward C launches (12 linears and the head) and 12 again in the
    backward; the llama's 14 C (7 linears a layer) twice and its G head once;
    GPT-2's K twice a layer, L and M once."""
    want = {"gptj-qlora": ({"_matmul_plain": 13}, {"_matmul_plain": 25}),
            "llama-qlora": ({"_matmul_plain": 14, "_q8_matmul_plain": 1},
                            {"_matmul_plain": 28, "_q8_matmul_plain": 1}),
            "gpt2-flash": ({"_fa_forward_lse_plain": 2, "_fa_bwd_dq_plain": 2, "_fa_bwd_dkv_plain": 2},
                           {"_fa_forward_lse_plain": 4, "_fa_bwd_dq_plain": 2, "_fa_bwd_dkv_plain": 2})}
    for model, (without, with_remat) in want.items():
        assert _port_grads(setups[model], None, monkeypatch)[1] == without, model
        assert _port_grads(setups[model], "dots_with_no_batch_dims_saveable", monkeypatch)[1] == with_remat, model


@pytest.mark.parametrize("name", ["checkpoint_dots", "checkpoint_dots_with_no_batch_dims", "save_only_these_names",
                                  "offload_dot_with_no_batch_dims", "dots_saveable_please"])
def test_policy_names(name):
    cfg = gpt2.GPT2Config(**GPT2_CFG)
    if name.startswith("checkpoint_dots"):  # JAX's aliases
        assert callable(make_lm_model_fn(gpt2, cfg, SEQ, BATCH, remat_policy=name))
        assert hasattr(jax.checkpoint_policies, name)
    else:  # a policy factory of JAX's (it takes names), or a name JAX lacks
        assert hasattr(jax.checkpoint_policies, name) == (name != "dots_saveable_please")
        with pytest.raises(ValueError, match="not an argument-free"):
            make_lm_model_fn(gpt2, cfg, SEQ, BATCH, remat_policy=name)
