"""The port's GGUF path: a tiny GPT-J written to a Q4_K GGUF file, loaded by
ggml_tpu.models.gptj.GPTJ.from_gguf(keep_quantized=True) and by the port's
GPTJ.from_gguf(device="cpu"), both in f32 activations.

Reader, Q4_K repack, the on-load q/k RoPE permutation and the model run
through both packages from the same bytes.  Gates as in test_torch_gptj.py,
against the JAX forward run op by op at prefill and jitted at decode
(jax_decode_step): logits NMSE <= 1e-6 at prefill and at each of 16 greedy
decode steps, and the 16 greedy tokens equal.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

transformers = pytest.importorskip("transformers")

from ggml_tpu.dtypes import GGMLType as JGGMLType
from ggml_tpu.gguf import GGUFFile as JGGUFFile
from ggml_tpu.models import gptj as jgptj
from ggml_tpu_torch.gguf import GGUFFile
from ggml_tpu_torch.models import gptj
from ggml_tpu_torch.quant.planar import PlanarWeight
from tests.test_torch_gptj import _jax_prefill, _port_prefill, greedy_decode_both
from tests.test_torch_rules import nmse, one_thread  # noqa: F401  (the autouse fixture)

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from tools.convert_hf_gptj import convert_state_dict


@pytest.fixture(scope="module")
def gguf_path(tmp_path_factory):
    cfg = transformers.GPTJConfig(
        vocab_size=512, n_positions=128, n_embd=512, n_layer=2, n_head=4, rotary_dim=32,
        resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0,
    )
    torch.manual_seed(21)
    model = transformers.GPTJForCausalLM(cfg).eval()
    path = tmp_path_factory.mktemp("gptj_q4k") / "tiny-q4k.gguf"
    convert_state_dict(model.state_dict(), cfg, ftype=JGGMLType.Q4_K).write(path)
    return path


@pytest.fixture(scope="module")
def models(gguf_path):
    jm = jgptj.GPTJ.from_gguf(gguf_path, dtype=jnp.float32, keep_quantized=True, max_seq=48, batch=1)
    tm = gptj.GPTJ.from_gguf(gguf_path, dtype=torch.float32, device="cpu", max_seq=48, batch=1)
    return jm, tm


def test_reader_matches_jax_reader(gguf_path):
    jg = JGGUFFile(gguf_path)
    with GGUFFile(gguf_path) as g:
        assert g.metadata.keys() == jg.metadata.keys()
        assert list(g.tensors) == list(jg.tensors)
        for name, info in g.tensors.items():
            assert (info.shape, int(info.ggml_type)) == (jg.tensors[name].shape, int(jg.tensors[name].ggml_type))
            np.testing.assert_array_equal(g.tensor_bytes(name), jg.tensor_bytes(name))
        name = "blk.0.attn_q.weight"
        assert g.tensors[name].ggml_type == JGGMLType.Q4_K
        np.testing.assert_array_equal(g.to_float32(name), jg.to_float32(name))
    jg.close()


def test_weights_stay_q4k_planes(models):
    _, tm = models
    assert tm.cfg.rope_deinterleaved
    for name in ("output.weight", "blk.1.attn_q.weight", "blk.1.ffn_down.weight"):
        assert isinstance(tm.params[name], PlanarWeight)
    assert tm.params["token_embd.weight@dense"].dtype == torch.float32


def test_gguf_prefill_and_decode_match_jax(models):
    jm, tm = models
    prompt = np.random.default_rng(4).integers(0, 512, (1, 7)).astype(np.int32)
    want, _ = _jax_prefill(jm, prompt)
    got, _ = _port_prefill(tm, prompt)
    assert nmse(np.asarray(want), got) <= 1e-6
    steps = list(greedy_decode_both(jm, tm, prompt, 16))
    assert len(steps) == 16
    for step, (jl, tl, jtok, ttok) in enumerate(steps):
        assert nmse(jl, tl) <= 1e-6, (step, nmse(jl, tl))
        assert jtok == ttok, step
