"""The port's GPT-J slice over int8 planes against the JAX GPTJ on the same
parameters, on the CPU.

A tiny GPT-J (E=512, 2 layers) with synthesized Q8_0 planes from the JAX
package carried over as numpy.  Prefill of 40 tokens runs the matmul kernel's
plain version (G), of 5 tokens and each decode step the int8 GEMV's (E) and
the decode attention (D).  The JAX side is its forward run op by op (Pallas
kernels in interpret mode).  The port is fed the JAX run's tokens.  Gates
(assert_same_choice): logits NMSE <= 1e-6 at prefill and at every decode
step, and the same argmax wherever the JAX top-two margin exceeds 1e-3.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ggml_tpu.dtypes import GGMLType as JGGMLType
from ggml_tpu.models import gptj as jgptj
from ggml_tpu_torch.convert import params_from_numpy
from ggml_tpu_torch.dtypes import GGMLType
from ggml_tpu_torch.models import gptj
from ggml_tpu_torch.quant.planar import PlanarWeight
from tests.test_torch_gptj import _jax_prefill, _port_prefill
from tests.test_torch_rules import nmse, one_thread, params_to_numpy  # noqa: F401  (the autouse fixture)

CFG = dict(n_vocab=512, n_ctx=256, n_embd=512, n_head=4, n_layer=2, n_rot=32,
           rope_deinterleaved=True)
MAX_SEQ = 64
SYNTH = [(GGMLType.Q8_0, None), (GGMLType.Q5_0, None), (GGMLType.Q5_1, None), (GGMLType.Q5_K, None),
         (GGMLType.Q6_K, None), (GGMLType.Q4_K, False), (GGMLType.Q4_K, None)]


@pytest.fixture(scope="module")
def models():
    jcfg = jgptj.GPTJConfig(**CFG)
    jparams = jgptj.synth_quantized_params(jcfg, JGGMLType.Q8_0, seed=0, dtype=jnp.float32)
    tparams = params_from_numpy(params_to_numpy(jparams), device="cpu")
    jm = jgptj.GPTJ(jparams, jcfg, max_seq=MAX_SEQ, batch=1)
    tm = gptj.GPTJ(tparams, gptj.GPTJConfig(**CFG), max_seq=MAX_SEQ, batch=1, device="cpu")
    return jm, tm


def _prompt(t: int):
    return np.random.default_rng(100 + t).integers(0, CFG["n_vocab"], (1, t)).astype(np.int32)


def assert_same_choice(jl, tl, where):
    """Logits NMSE <= 1e-6 over the step (<= 1e-4 at each position of it),
    and the same argmax at the last position unless JAX's own top two are
    within 1e-3 of each other.

    The GEMV steps (up to 32 rows) agree with JAX bit for bit or to 1e-15,
    until a last-bit difference of a layer norm, softmax or tanh crosses a
    rounding boundary of the next int8 quantization: one such code costs its
    row about 2e-5 in this tiny model.  Above 32 rows the f32 sums of the
    bf16 products run in another order than XLA's and single bf16 casts round
    the other way: rows of a 40-token prefill read 1e-8 to 9e-6 and the step
    5e-7 to 2e-6 over the prompts tried (seeds t, 100+t, 200+t, 300+t); the
    tests pin the prompt of seed 100+t."""
    jl, tl = np.asarray(jl), np.asarray(tl)
    assert nmse(jl, tl) <= 1e-6, (where, nmse(jl, tl))
    rows = [nmse(jl[0, i], tl[0, i]) for i in range(jl.shape[1])]
    assert max(rows) <= 1e-4, (where, rows)
    top2 = np.sort(jl[0, -1])[-2:]
    if top2[1] - top2[0] > 1e-3:
        assert int(np.argmax(jl[0, -1])) == int(np.argmax(tl[0, -1])), where


def teacher_forced_decode(jm, tm, prompt, n_steps: int):
    """Prefill both sides, then decode n_steps with both sides fed the JAX
    side's greedy token; yields (jax logits, port logits) per step."""
    jl, jcache = _jax_prefill(jm, prompt)
    _, tcache = _port_prefill(tm, prompt)
    t = prompt.shape[1]
    pos = torch.tensor(t, dtype=torch.int32)
    for n_past in range(t, t + n_steps):
        tok = int(np.argmax(np.asarray(jl)[0, -1]))
        jl, jcache = jgptj.forward(jm.params, jm.cfg, jnp.asarray([[tok]], jnp.int32),
                                   jnp.full((1,), n_past, jnp.int32), jcache, jnp.int32(n_past))
        tl = gptj.forward(tm.params, tm.cfg, torch.tensor([[tok]]), pos.expand(1), tcache, pos)[0].numpy()
        pos += 1
        yield jl, tl


@pytest.mark.parametrize("t", [40, 5], ids=["prefill40-matmul", "prefill5-gemv"])
def test_prefill_logits_match_jax(models, t):
    jm, tm = models
    prompt = _prompt(t)
    want, _ = _jax_prefill(jm, prompt)
    got, _ = _port_prefill(tm, prompt)
    assert got.shape == np.asarray(want).shape == (1, t, CFG["n_vocab"])
    assert_same_choice(want, got, f"prefill {t}")


def test_decode_matches_jax(models):
    jm, tm = models
    steps = list(teacher_forced_decode(jm, tm, _prompt(5), 6))
    assert len(steps) == 6
    for step, (jl, tl) in enumerate(steps):
        assert_same_choice(jl, tl, f"decode step {step}")


def test_generate_runs_on_q8_planes(models):
    _, tm = models
    out = tm.generate(_prompt(3), 5)
    assert len(out) == 5 and all(0 <= t < CFG["n_vocab"] for t in out)


@pytest.mark.parametrize("t,use_q4", SYNTH, ids=lambda v: v.name if isinstance(v, GGMLType) else str(v))
def test_synthesized_planes_have_the_jax_layout(t, use_q4):
    """synth_quantized_params builds, for every ported type, planes of the
    JAX synthesis's kinds, shapes, types and constant scale values (the random
    codes come from another generator)."""
    cfg = dict(CFG, n_vocab=9000)  # an lm head wider than 8192 takes the 2048 pad
    jparams = jgptj.synth_quantized_params(jgptj.GPTJConfig(**cfg), JGGMLType(int(t)), seed=0,
                                           dtype=jnp.float32, use_q4=use_q4)
    want = params_from_numpy(params_to_numpy(jparams), device="cpu")
    got = gptj.synth_quantized_params(gptj.GPTJConfig(**cfg), t, seed=0, dtype=torch.float32,
                                      device="cpu", use_q4=use_q4)
    assert got.keys() == want.keys()
    for name, w in want.items():
        g = got[name]
        if not isinstance(w, PlanarWeight):
            assert g.shape == w.shape and g.dtype == w.dtype, name
            continue
        assert (g.kind, g.group, g.n, g.k, g.orig_type) == (w.kind, w.group, w.n, w.k, w.orig_type), name
        assert g.codes.shape == w.codes.shape and g.codes.dtype == w.codes.dtype, name
        for plane in ("scales", "offsets", "d", "dmin"):
            gp, wp = getattr(g, plane), getattr(w, plane)
            assert (gp is None) == (wp is None), (name, plane)
            if wp is not None:
                assert gp.dtype == wp.dtype, (name, plane)
                torch.testing.assert_close(gp, wp, rtol=0, atol=0)
    if got["output.weight"].kind == "q8":
        codes = got["output.weight"].codes
        assert int(codes.min()) == -128 and int(codes.max()) == 127 and got["output.weight"].npad == 10240


def test_synth_rejects_unported_types():
    with pytest.raises(NotImplementedError):
        gptj.synth_quantized_params(gptj.GPTJConfig(**CFG), GGMLType.IQ4_NL, device="cpu")
    with pytest.raises(ValueError):
        gptj.synth_quantized_params(gptj.GPTJConfig(**CFG), GGMLType.Q8_0, device="cpu", use_q4=True)
