"""The port's GPT-J slice over multiplied-out nibble planes and through the
flash prefill against the JAX GPTJ, on the CPU.

A tiny GPT-J (E=512, 2 layers): (1) synthesized Q4_0 planes from the JAX
package carried over as numpy; (2) a GGUF written with the repo's writer from
random blocks that mixes Q4_0, Q4_1, Q2_K and Q3_K, loaded by both packages.
Prefill of 40 tokens runs kernel C's plain version over multiplied-out planes,
of 5 tokens and each decode step kernel H's (q4_gemv) and the decode attention.
The JAX side is its forward run op by op (Pallas kernels in interpret mode);
the port is fed the JAX run's tokens.  Gates (assert_same_choice): logits
NMSE <= 1e-6 at prefill and at every decode step, the same argmax wherever
the JAX top-two margin exceeds 1e-3.  The flash prefill (use_flash_prefill)
is held to the JAX flash prefill at 1e-6 and to the port's own plain-attention
prefill at 1e-5.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggml_tpu.dtypes import GGMLType as JGGMLType
from ggml_tpu.gguf import GGUFWriter
from ggml_tpu.models import gptj as jgptj
from ggml_tpu_torch.convert import params_from_numpy
from ggml_tpu_torch.dtypes import GGMLType, get_type_traits
from ggml_tpu_torch.kernels import qmatmul
from ggml_tpu_torch.models import gptj
from ggml_tpu_torch.quant.planar import PlanarWeight
from ggml_tpu_torch.quant.reference import random_blocks
from tests.test_torch_gptj import _jax_prefill, _port_prefill
from tests.test_torch_gptj_q8 import assert_same_choice, teacher_forced_decode
from tests.test_torch_rules import (  # noqa: F401  (one_thread: the autouse fixture)
    assert_planes_equal, nmse, one_thread, params_to_numpy)

E, LAYERS, VOCAB = 512, 2, 512
CFG = dict(n_vocab=VOCAB, n_ctx=256, n_embd=E, n_head=4, n_layer=LAYERS, n_rot=32, rope_deinterleaved=True)
MAX_SEQ = 64
# (type, fp16 field scale): the scale keeps each format's weights near 0.05
TYPES = {"attn_q": (GGMLType.Q4_0, 1e-2), "attn_k": (GGMLType.Q4_1, 5e-3), "attn_v": (GGMLType.Q2_K, 3e-3),
         "attn_output": (GGMLType.Q3_K, 1e-3), "ffn_up": (GGMLType.Q4_1, 5e-3), "ffn_down": (GGMLType.Q2_K, 3e-3),
         "output": (GGMLType.Q3_K, 1e-3), "token_embd": (GGMLType.Q4_0, 1e-2)}


def _prompt(t: int):
    return np.random.default_rng(100 + t).integers(0, VOCAB, (1, t)).astype(np.int32)


@pytest.fixture(scope="module")
def synth_models():
    jcfg = jgptj.GPTJConfig(**CFG)
    jparams = jgptj.synth_quantized_params(jcfg, JGGMLType.Q4_0, seed=0, dtype=jnp.float32)
    tparams = params_from_numpy(params_to_numpy(jparams), device="cpu")
    jm = jgptj.GPTJ(jparams, jcfg, max_seq=MAX_SEQ, batch=1)
    tm = gptj.GPTJ(tparams, gptj.GPTJConfig(**CFG), max_seq=MAX_SEQ, batch=1, device="cpu")
    return jm, tm


@pytest.fixture(scope="module")
def gguf_path(tmp_path_factory):
    rng = np.random.default_rng(41)
    w = GGUFWriter()
    w.add_string("general.architecture", "gptj")
    for key, val in (("context_length", 128), ("embedding_length", E), ("attention.head_count", 4),
                     ("block_count", LAYERS), ("vocab_size", VOCAB), ("rope.dimension_count", 32)):
        w.add_u32("gptj." + key, val)

    def dense(name, *shape, scale=0.05):
        w.add_tensor(name, (rng.standard_normal(shape) * scale).astype(np.float32))

    def quantized(name, n, k):
        t, scale = TYPES[name.split(".")[-2]]
        blocks = random_blocks(t, n * k // get_type_traits(t).block_size, rng, scale=scale)
        w.add_tensor(name, blocks, JGGMLType(int(t)), raw_shape_ne=(k, n))

    quantized("token_embd.weight", VOCAB, E)
    w.add_tensor("output_norm.weight", np.ones(E, np.float32))
    dense("output_norm.bias", E)
    quantized("output.weight", VOCAB, E)
    dense("output.bias", VOCAB)
    for i in range(LAYERS):
        pre = f"blk.{i}."
        w.add_tensor(pre + "attn_norm.weight", np.ones(E, np.float32))
        dense(pre + "attn_norm.bias", E)
        for nm in ("attn_q", "attn_k", "attn_v", "attn_output"):
            quantized(pre + nm + ".weight", E, E)
        quantized(pre + "ffn_up.weight", 4 * E, E)
        dense(pre + "ffn_up.bias", 4 * E)
        quantized(pre + "ffn_down.weight", E, 4 * E)
        dense(pre + "ffn_down.bias", E)
    path = tmp_path_factory.mktemp("gptj_q4") / "tiny-nibbles.gguf"
    w.write(path)
    return path


@pytest.fixture(scope="module")
def gguf_models(gguf_path):
    jm = jgptj.GPTJ.from_gguf(gguf_path, dtype=jnp.float32, keep_quantized=True, max_seq=48, batch=1)
    tm = gptj.GPTJ.from_gguf(gguf_path, dtype=torch.float32, device="cpu", max_seq=48, batch=1)
    return jm, tm


@pytest.fixture(params=["synth-q4_0", "gguf-mixed"])
def models(request):
    return request.getfixturevalue("synth_models" if request.param == "synth-q4_0" else "gguf_models")


def test_synthesized_q4_0_planes_route_to_kernel_h(synth_models):
    _, tm = synth_models
    w = tm.params["blk.0.attn_qkvup.weight"]
    assert (w.kind, w.group, w.supers, w.scales.dtype) == ("q4", 32, None, torch.bfloat16)
    assert w.scales.shape == (2, 8, 7 * E) and w.offsets.shape == (16, 7 * E)
    assert [qmatmul.select_kernel(w, m) for m in (1, 5, 40)] == ["q4_gemv", "q4_gemv", "q4k_matmul"]


def test_every_gguf_weight_holds_the_jax_planes(gguf_models):
    """Each nibble-type weight is loaded into the planes the JAX package
    holds (q/k after the RoPE column permutation), bit for bit, and decode
    routes it to kernel H."""
    jm, tm = gguf_models
    assert tm.cfg.rope_deinterleaved
    for name, (t, _) in TYPES.items():
        key = ("" if name in ("output", "token_embd") else "blk.1.") + name + ".weight"
        pw = tm.params[key]
        assert pw.kind == "q4" and pw.supers is None and pw.orig_type == t
        assert pw.group == (16 if t in (GGMLType.Q2_K, GGMLType.Q3_K) else 32)
        assert_planes_equal(pw, jm.params[key])
        assert qmatmul.select_kernel(pw, 1) == "q4_gemv" and qmatmul.select_kernel(pw, 40) == "q4k_matmul"
    np.testing.assert_array_equal(tm.params["token_embd.weight@dense"].numpy(),
                                  np.asarray(jm.params["token_embd.weight@dense"]))


@pytest.mark.parametrize("t", [40, 5], ids=["prefill40-matmul", "prefill5-gemv"])
def test_prefill_logits_match_jax(models, t):
    jm, tm = models
    prompt = _prompt(t)
    want, _ = _jax_prefill(jm, prompt)
    got, _ = _port_prefill(tm, prompt)
    assert got.shape == np.asarray(want).shape == (1, t, VOCAB)
    assert_same_choice(want, got, f"prefill {t}")


def test_decode_matches_jax(models):
    jm, tm = models
    steps = list(teacher_forced_decode(jm, tm, _prompt(5), 6))
    assert len(steps) == 6
    for step, (jl, tl) in enumerate(steps):
        assert_same_choice(jl, tl, f"decode step {step}")


def test_flash_prefill_matches_jax_and_the_plain_attention(models):
    """use_flash_prefill on both sides: the current tokens only, through the
    flash kernel's plain version here and the Pallas kernel there; the cache
    is written all the same."""
    jm, tm = models
    prompt = _prompt(40)
    jcache = jm.new_cache(dtype=jnp.float32)
    want, jcache = jgptj.forward(jm.params, dataclasses.replace(jm.cfg, use_flash_prefill=True),
                                 jnp.asarray(prompt), jnp.zeros((1,), jnp.int32), jcache, jnp.int32(0),
                                 prefill=True)
    tcache = tm.new_cache(dtype=torch.float32)
    zero = torch.zeros((), dtype=torch.int32)
    got = gptj.forward(tm.params, dataclasses.replace(tm.cfg, use_flash_prefill=True),
                       torch.from_numpy(prompt).long(), zero.expand(1), tcache, zero, prefill=True)[0].numpy()
    assert_same_choice(want, got, "flash prefill 40")
    plain, plain_cache = _port_prefill(tm, prompt)
    assert nmse(plain, got) <= 1e-5
    # the first layer's rows do not depend on the attention; the later ones do
    torch.testing.assert_close(tcache[0][0], plain_cache[0][0], rtol=0, atol=0)
    torch.testing.assert_close(tcache[0][1], plain_cache[0][1], rtol=0, atol=0)
    for (k, v), (pk, pv), (jk, jv) in zip(tcache, plain_cache, jcache):
        assert nmse(pk[:, :, :40].numpy(), k[:, :, :40].numpy()) <= 1e-5
        assert nmse(np.asarray(jk)[:, :, :40], k[:, :, :40].numpy()) <= 1e-6
        assert nmse(np.asarray(jv)[:, :, :40], v[:, :, :40].numpy()) <= 1e-6
        assert not k[:, :, 40:].any()


def test_long_prompts_take_the_flash_branch(synth_models, monkeypatch):
    """A prompt of flash_min_seq tokens or more goes through flash_attention
    without the option; a shorter one and a decode step do not."""
    from ggml_tpu_torch.kernels import flash_attn

    _, tm = synth_models
    calls = []
    real = flash_attn.flash_attention
    monkeypatch.setattr(flash_attn, "flash_attention", lambda *a, **kw: calls.append(a[0].shape) or real(*a, **kw))
    short = gptj.GPTJ(tm.params, dataclasses.replace(tm.cfg, flash_min_seq=8), max_seq=32, device="cpu")
    logits, cache, n_past = short.prefill(short.new_cache(torch.float32), _prompt(7))
    assert calls == []
    logits, cache, n_past = short.prefill(short.new_cache(torch.float32), _prompt(8))
    assert calls == [(1, 4, 8, E // 4)] * LAYERS and bool(torch.isfinite(logits).all())
    short.decode_greedy(cache, torch.argmax(logits, dim=-1, keepdim=True), n_past, 2)
    assert len(calls) == LAYERS


def test_bf16_model_flash_prefill_matches_jax(monkeypatch):
    """A bf16 model: RoPE leaves q and k in f32 beside a bf16 v, and they
    reach the flash kernel so (the JAX kernel multiplies the f32 values).
    Against the JAX bf16 model the two packages differ by bf16 roundings of
    every layer's activations, about 1e-4 at the logits whichever attention
    runs; the flash prefill is held to 5e-4 and to twice what the
    plain-attention prefill shows."""
    from ggml_tpu_torch.kernels import flash_attn

    jcfg, tcfg = jgptj.GPTJConfig(**CFG), gptj.GPTJConfig(**CFG)
    jparams = jgptj.synth_quantized_params(jcfg, JGGMLType.Q4_0, seed=0, dtype=jnp.bfloat16)
    tparams = params_from_numpy(params_to_numpy(jparams), device="cpu")
    seen = []
    real = flash_attn.flash_attention
    monkeypatch.setattr(flash_attn, "flash_attention",
                        lambda q, k, v, **kw: seen.append((q.dtype, k.dtype, v.dtype)) or real(q, k, v, **kw))
    prompt = _prompt(40)
    zero = torch.zeros((), dtype=torch.int32)
    err = {}
    for flash in (True, False):
        want, _ = jgptj.forward(jparams, dataclasses.replace(jcfg, use_flash_prefill=flash), jnp.asarray(prompt),
                                jnp.zeros((1,), jnp.int32), jgptj.init_cache(jcfg, 1, MAX_SEQ, jnp.bfloat16),
                                jnp.int32(0), prefill=True)
        got = gptj.forward(tparams, dataclasses.replace(tcfg, use_flash_prefill=flash),
                           torch.from_numpy(prompt).long(), zero.expand(1),
                           gptj.init_cache(tcfg, 1, MAX_SEQ, torch.bfloat16, "cpu"), zero, prefill=True)[0]
        assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
        err[flash] = nmse(np.asarray(want.astype(jnp.float32)), got.float().numpy())
    assert seen == [(torch.float32, torch.float32, torch.bfloat16)] * LAYERS
    assert err[True] <= 5e-4 and err[True] <= 2 * err[False], err


SYNTH = [(GGMLType.Q4_0, None), (GGMLType.Q4_1, None), (GGMLType.Q2_K, None), (GGMLType.Q3_K, None),
         (GGMLType.Q3_K, False), (GGMLType.Q4_K, None)]


@pytest.mark.parametrize("scale", ["tiny", "e512"])
@pytest.mark.parametrize("t,use_q4", SYNTH, ids=lambda v: v.name if isinstance(v, GGMLType) else str(v))
def test_synthesized_planes_have_the_jax_layout(t, use_q4, scale):
    """synth_quantized_params builds, for the nibble types, planes of the JAX
    synthesis's kinds, shapes, types and constant scale values (the random
    codes come from another generator), at E=512 and at random_config("tiny")
    (E=256: Q4_K is not compact there)."""
    if scale == "tiny":
        jcfg, cfg = jgptj.random_config("tiny"), gptj.random_config("tiny")
        assert dataclasses.asdict(cfg) == {k: v for k, v in dataclasses.asdict(jcfg).items()
                                           if k in dataclasses.asdict(cfg)}
    else:
        jcfg, cfg = jgptj.GPTJConfig(**dict(CFG, n_vocab=9000)), gptj.GPTJConfig(**dict(CFG, n_vocab=9000))
    jparams = jgptj.synth_quantized_params(jcfg, JGGMLType(int(t)), seed=0, dtype=jnp.float32, use_q4=use_q4)
    want = params_from_numpy(params_to_numpy(jparams), device="cpu")
    got = gptj.synth_quantized_params(cfg, t, seed=0, dtype=torch.float32, device="cpu", use_q4=use_q4)
    assert got.keys() == want.keys()
    for name, w in want.items():
        g = got[name]
        if not isinstance(w, PlanarWeight):
            assert g.shape == w.shape and g.dtype == w.dtype, name
            continue
        assert (g.kind, g.group, g.n, g.k, g.orig_type, g.sb) == (w.kind, w.group, w.n, w.k, w.orig_type, w.sb), name
        assert g.codes.shape == w.codes.shape and g.codes.dtype == w.codes.dtype, name
        for plane in ("scales", "offsets", "d", "dmin"):
            gp, wp = getattr(g, plane), getattr(w, plane)
            assert (gp is None) == (wp is None), (name, plane)
            if wp is not None:
                assert gp.dtype == wp.dtype, (name, plane)
                torch.testing.assert_close(gp, wp, rtol=0, atol=0)
    head = got["output.weight"]
    assert head.kind == ("q8" if use_q4 is False else "q4")
    if head.kind == "q4":
        assert int(head.codes.min()) == 0 and int(head.codes.max()) == 255
