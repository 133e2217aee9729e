"""The port's dense Engine on Q4_K planes against JAX's Engine on the CPU
(ROADMAP.md section 3: the engine on quantized planes held against the
reference).

A tiny GPT-J GGUF file of Q4_K blocks (models/gptj.write_random_gguf: E 512,
2 layers, vocab 256; weights of std about 0.02) loaded quantized by both
packages: every linear stays compact Q4_K planes.  Both engines admit two
prompts of 20 and 27 tokens in one (2, 32) prefill, so the prompt rows take
the matmul kernel C at M = 64 on both sides (JAX's Pallas kernels in
interpret mode inside its jitted engine, the port's plain versions), and
decode at M = 2 through B (the compact Q4_K GEMV).

f32 activations (the repo's Q4 gates): the admitted cache rows within NMSE
1e-6 of JAX's (C's f32 sums run in another order than XLA's: 4e-14 in layer
0, 2e-9 to 4e-8 in layer 1), the first step's logits over each engine's own
cache within 1e-5 (1.8e-6 here, all of it from those rows: over JAX's cache
the port's step reads 1e-14), and every id equal, a third request admitted
mid-stretch included.

bf16 activations (what the card runs): JAX's jitted step and JAX's own
forward run op by op differ by 1.2e-4 at the logits on this file (XLA fuses
the elementwise ops of a bf16 model and rounds only their outputs to bf16,
where op by op every op rounds), so ids may part at a near tie.  The gate:
over JAX's admitted cache, the port's first step within NMSE 3e-4 of JAX's
jitted step (1.1e-4 here; the port against JAX op by op reads 9.5e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggml_tpu.models import gptj as jgptj
from ggml_tpu.serve import Engine as JEngine
from ggml_tpu_torch.kernels import qmatmul
from ggml_tpu_torch.models import gptj
from ggml_tpu_torch.quant.planar import PlanarWeight
from ggml_tpu_torch.serve import Engine
from tests.test_torch_rules import nmse, one_thread  # noqa: F401  (the autouse fixture)

CFG = gptj.GPTJConfig(n_vocab=256, n_ctx=128, n_embd=512, n_head=4, n_layer=2, n_rot=32)
MAX_SEQ, BUCKET = 64, 32
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(scope="module")
def gguf(tmp_path_factory):
    path = tmp_path_factory.mktemp("serve_q4") / "gptj_q4k.gguf"
    gptj.write_random_gguf(path, CFG, seed=12)
    return path


def _engines(path, dt: str):
    """Both engines with two prompts admitted in one (2, 32) prefill."""
    jdt, tdt = DTYPES[dt]
    jm = jgptj.GPTJ.from_gguf(str(path), dtype=jdt, max_seq=MAX_SEQ)
    tm = gptj.GPTJ.from_gguf(path, dtype=tdt, max_seq=MAX_SEQ, device="cpu")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, CFG.n_vocab, n).astype(np.int32) for n in (20, 27, 9)]
    jeng = JEngine(jm, max_batch=2, max_seq=MAX_SEQ, horizon=4, cache_dtype=jdt)
    eng = Engine(tm, max_batch=2, max_seq=MAX_SEQ, horizon=4, cache_dtype=tdt)
    for e in (jeng, eng):
        for p in prompts[:2]:
            e.submit(p, 6)
        e._admit(BUCKET)
    assert list(eng.n_past) == list(jeng.n_past) == [19, 26]
    return jm, tm, jeng, eng, prompts


def _f32(a) -> np.ndarray:
    return a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)


def _jax_step(jm, jeng):
    """JAX's first step over its engine's cache, jitted as the engine's step:
    every slot's last prompt token at its position n_past."""
    tok, n_past = jnp.asarray(jeng.cur_tok.reshape(-1, 1)), jnp.asarray(jeng.n_past)
    return _f32(jax.jit(jgptj.forward, static_argnums=1)(jm.params, jm.cfg, tok, n_past, jeng.cache, n_past)[0][:, -1])


def _port_step(tm, eng, cache):
    tok, n_past = torch.as_tensor(eng.cur_tok.reshape(-1, 1)).long(), torch.as_tensor(eng.n_past)
    with torch.no_grad():
        return _f32(gptj.forward(tm.params, tm.cfg, tok, n_past, cache, n_past)[0][:, -1])


def test_q4k_engine_matches_jax_engine(gguf):
    jm, tm, jeng, eng, prompts = _engines(gguf, "f32")
    planar = [k for k, v in tm.params.items() if isinstance(v, PlanarWeight) and k != "token_embd.weight"]
    assert len(planar) == 6 * CFG.n_layer + 1
    assert {qmatmul.select_kernel(tm.params[k], 64) for k in planar} == {"q4k_matmul"}
    assert {qmatmul.select_kernel(tm.params[k], 2) for k in planar} == {"q4k_gemv_rows"}
    for (jk, jv), (tk, tv) in zip(jeng.cache, eng.cache):
        for s, t in ((0, 20), (1, 27)):
            assert nmse(_f32(jk[s, :, :t]), _f32(tk[s, :, :t])) <= 1e-6
            assert nmse(_f32(jv[s, :, :t]), _f32(tv[s, :, :t])) <= 1e-6
    want = _jax_step(jm, jeng)
    assert nmse(want, _port_step(tm, eng, eng.cache)) <= 1e-5  # rewrites each slot's row n_past identically
    for e in (jeng, eng):
        e.submit(prompts[2], 6)
    jres, res = jeng.run(bucket=BUCKET), eng.run(bucket=BUCKET)
    assert [res[r] for r in (1, 2, 3)] == [jres[r] for r in (1, 2, 3)]


def test_q4k_bf16_first_step_matches_jax(gguf):
    jm, tm, jeng, eng, _ = _engines(gguf, "bf16")
    cache = [(torch.from_numpy(_f32(k)).bfloat16(), torch.from_numpy(_f32(v)).bfloat16()) for k, v in jeng.cache]
    got = nmse(_jax_step(jm, jeng), _port_step(tm, eng, cache))
    assert got <= 3e-4, got
