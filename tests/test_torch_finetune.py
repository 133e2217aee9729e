"""The port's finetuning path (ggml_tpu_torch.opt.finetune, the GGUF writer,
the finetune CLI) against the JAX package's, on a tiny GPT-2 GGUF whose
weights come from init_random_params (no transformers).

The GGUF writer writes the JAX writer's bytes.  finetune trains in f32 through
the cache-window attention in both packages: over 10 steps the losses agree
within 1e-4 (f32 sums in another order, amplified by AdamW's normalization),
for GPT-2 and for a tiny f32 GPT-J (test_gptj_finetune_matches_jax).
The output GGUF loads in both packages with the trained weights bit for bit.
The CLI runs full-weight training, LoRA (--lora-rank) and checkpoints
(--checkpoint-dir, --checkpoint-every); --dp, qwen2moe and falcon still raise
(llama, qwen2 and qwen3 train: tests/test_torch_llama_train.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ggml_tpu.gguf import GGUFFile as JaxGGUFFile
from ggml_tpu.gguf import GGUFWriter as JaxGGUFWriter
from ggml_tpu.models import gpt2 as jax_gpt2
from ggml_tpu.opt import AdamWConfig as JaxAdamWConfig
from ggml_tpu.opt import finetune as jax_finetune
from ggml_tpu_torch.cli import finetune as cli
from ggml_tpu_torch.dtypes import GGMLType
from ggml_tpu_torch.gguf import GGUFFile, GGUFWriter
from ggml_tpu_torch.models import gpt2
from ggml_tpu_torch.opt import AdamWConfig, finetune
from ggml_tpu_torch.quant.reference import random_blocks
from tests.test_torch_rules import tiny_gptj_f32_gguf

SHAPE = dict(n_vocab=64, n_ctx=32, n_embd=32, n_head=4, n_layer=2)


def _pattern(n):
    return np.asarray(([7, 11, 23, 42, 5] * (n // 5 + 1))[:n], np.int32)


@pytest.fixture(scope="module")
def tiny_gguf(tmp_path_factory):
    params = jax_gpt2.init_random_params(jax_gpt2.GPT2Config(**SHAPE), seed=5)
    w = JaxGGUFWriter()
    w.add_string("general.architecture", "gpt2")
    w.add_u32("gpt2.vocab_size", SHAPE["n_vocab"])
    w.add_u32("gpt2.context_length", SHAPE["n_ctx"])
    w.add_u32("gpt2.embedding_length", SHAPE["n_embd"])
    w.add_u32("gpt2.attention.head_count", SHAPE["n_head"])
    w.add_u32("gpt2.block_count", SHAPE["n_layer"])
    w.add_array("tokenizer.ggml.tokens", [f"t{i}" for i in range(SHAPE["n_vocab"])])
    for name, p in params.items():
        w.add_tensor(name, np.asarray(p))
    path = tmp_path_factory.mktemp("ft") / "tiny.gguf"
    w.write(path)
    return path


@pytest.mark.parametrize("alignment", [32, 64])
def test_gguf_writer_writes_the_jax_bytes(tmp_path, alignment):
    rng = np.random.default_rng(0)
    tensors = {"a": rng.standard_normal((3, 5)).astype(np.float32), "b": rng.standard_normal(7).astype(np.float32),
               "c": rng.standard_normal((4, 2, 6)).astype(np.float32),
               "q": random_blocks(GGMLType.Q4_K, 6, rng)}
    files = []
    for cls in (JaxGGUFWriter, GGUFWriter):
        w = cls(alignment=alignment)
        w.add_u32("u", 7)
        w.add_u64("big", 2**40)
        w.add_f32("f", 0.1)
        w.add_string("s", "gpt2 ü")
        w.add_array("strs", ["x", "yy"])
        w.add_array("ints", [1, 2, 3])
        w.add_array("floats", [0.5, 1.25])
        w.add_tensor("a", tensors["a"])
        w.add_tensor("b", tensors["b"])
        w.add_tensor("c", tensors["c"], 1)  # F16
        w.add_tensor("h", tensors["a"].astype(np.float16))
        w.add_tensor("q", tensors["q"], GGMLType.Q4_K, raw_shape_ne=(512, 3))  # Q4_K blocks as they are
        files.append(tmp_path / f"{cls.__module__.split('.')[0]}.gguf")
        w.write(files[-1])
    assert files[0].read_bytes() == files[1].read_bytes()
    with pytest.raises(NotImplementedError):
        GGUFWriter().add_tensor("q", tensors["a"], 12)  # Q4_K
    for bad in (dict(), dict(raw_shape_ne=(512, 2))):  # raw bytes need their ne, and all of their bytes
        with pytest.raises(ValueError):
            GGUFWriter().add_tensor("q", tensors["q"], 12, **bad)


def test_finetune_matches_jax_and_the_output_loads_in_both(tiny_gguf, tmp_path):
    toks = _pattern(400)
    want, _ = jax_finetune(str(tiny_gguf), toks, seq_len=16, batch=4, steps=10, adamw=JaxAdamWConfig(alpha=3e-3))
    out = tmp_path / "trained.gguf"
    got, opt = finetune(str(tiny_gguf), toks, seq_len=16, batch=4, steps=10, adamw=AdamWConfig(alpha=3e-3),
                        out_path=out, device="cpu")
    assert len(got) == 10 and np.abs(np.array(want) - np.array(got)).max() <= 1e-4, (want, got)
    assert got[-1] < 0.8 * got[0]

    # the trained weights, bit for bit, from either package's reader; both models agree on them
    jf, tf = JaxGGUFFile(str(out)), GGUFFile(out)
    assert tf.metadata["gpt2.block_count"] == SHAPE["n_layer"] and list(tf.tensors) == list(opt.params)
    for name, p in opt.params.items():
        np.testing.assert_array_equal(tf.to_float32(name), p.numpy(), err_msg=name)
        np.testing.assert_array_equal(jf.to_float32(name), p.numpy(), err_msg=name)
    tf.close()
    prompt = np.array([[7, 11, 23]], np.int32)
    jm = jax_gpt2.GPT2.from_gguf(str(out), max_seq=16)
    m = gpt2.GPT2.from_gguf(out, max_seq=16, device="cpu")
    assert m.generate(prompt, 6) == [int(t) for t in jm.generate(prompt, 6)]


def test_cli_runs_on_the_cpu(tiny_gguf, tmp_path, capsys):
    np.save(tmp_path / "toks.npy", _pattern(200))
    out = tmp_path / "cli.gguf"
    args = [str(tiny_gguf), str(out), "--tokens", str(tmp_path / "toks.npy"), "--seq", "16", "--batch", "2",
            "--steps", "2", "--device", "cpu"]
    cli.main(args)
    assert out.exists() and "final loss" in capsys.readouterr().out
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        cli.main(args + ["--dp", "2"])
    cli.main(args + ["--lora-rank", "4", "--lora-out", str(tmp_path / "adapter.gguf")])
    assert (tmp_path / "adapter.gguf").exists() and "+ adapter" in capsys.readouterr().out
    ckpts = tmp_path / "ckpts"
    cli.main(args + ["--checkpoint-dir", str(ckpts), "--checkpoint-every", "1"])
    assert sorted(p.name for p in ckpts.iterdir()) == ["step1.gguf", "step2.gguf"]


def test_finetune_rejects_families_and_options_not_ported(tiny_gguf):
    from ggml_tpu_torch.opt.finetune import _family

    assert _family("gptj").__name__ == "ggml_tpu_torch.models.gptj"
    for arch in ("llama", "qwen2", "qwen3"):
        assert _family(arch).__name__ == "ggml_tpu_torch.models.llama"
    for arch, item in (("qwen2moe", "the MoE block"), ("falcon", "the other families")):
        with pytest.raises(NotImplementedError, match=f"ROADMAP.md, section 1 item ., {item}"):
            _family(arch)
    with pytest.raises(ValueError):
        _family("nope")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        finetune(str(tiny_gguf), _pattern(100), steps=1, mesh=object(), device="cpu")


def test_finetune_checkpoints_resume_the_run(tiny_gguf, tmp_path):
    """checkpoint_path + checkpoint_every write step<N>.gguf; the optimizer
    loaded from step2 and stepped on the batches of steps 3-4 ends where the
    4-step run ended, bit for bit."""
    from ggml_tpu_torch.checkpoint import latest_checkpoint, load_optimizer
    from ggml_tpu_torch.opt import token_windows

    toks = _pattern(400)
    _, opt = finetune(str(tiny_gguf), toks, seq_len=16, batch=4, steps=4, checkpoint_path=str(tmp_path),
                      checkpoint_every=2, device="cpu")
    assert latest_checkpoint(tmp_path) == (tmp_path / "step4.gguf", 4)
    _, resumed = finetune(str(tiny_gguf), toks, seq_len=16, batch=4, steps=0, device="cpu")
    load_optimizer(tmp_path / "step2.gguf", resumed)
    ds = token_windows(toks, 16)
    rng = np.random.default_rng(0)
    ds.shuffle(rng)  # the loop's first shuffle; its 6 batches of 4 cover steps 0-5
    for step in (2, 3):
        resumed.step(*ds.get_batch(step, 4))
    for name, p in opt.params.items():
        assert torch.equal(resumed.params[name], p), name


def test_gptj_finetune_matches_jax(tmp_path):
    """Full-weight finetuning of a tiny f32 GPT-J (2 layers, n_embd 256), the
    masked attention over the cache window under autograd: 10 steps within
    1e-4 of JAX's losses, and the trained model loads in both packages."""
    from ggml_tpu.models import gptj as jax_gptj
    from ggml_tpu_torch.models import gptj

    cfg = gptj.GPTJConfig(n_vocab=256, n_ctx=128, n_embd=256, n_head=4, n_layer=2, n_rot=32)
    path = tiny_gptj_f32_gguf(tmp_path / "gptj.gguf", cfg, seed=2)
    toks = _pattern(400)
    want, _ = jax_finetune(str(path), toks, seq_len=32, batch=4, steps=10, adamw=JaxAdamWConfig(alpha=3e-3))
    out = tmp_path / "trained.gguf"
    got, opt = finetune(str(path), toks, seq_len=32, batch=4, steps=10, adamw=AdamWConfig(alpha=3e-3),
                        out_path=out, device="cpu")
    assert len(got) == 10 and np.abs(np.array(want) - np.array(got)).max() <= 1e-4, (want, got)
    assert got[-1] < 0.8 * got[0]
    prompt = np.array([[7, 11, 23]], np.int32)
    jm = jax_gptj.GPTJ.from_gguf(str(out), dtype=jnp.float32, keep_quantized=False, max_seq=16)
    m = gptj.GPTJ.from_gguf(out, dtype=torch.float32, keep_quantized=False, max_seq=16, device="cpu")
    assert m.generate(prompt, 6) == [int(t) for t in jm.generate(prompt, 6)]
