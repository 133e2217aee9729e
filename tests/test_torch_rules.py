"""Rules of the PyTorch/CUDA port (ggml_tpu_torch) and helpers its CPU tests
share: the port imports neither JAX nor the JAX package, its entry points
default to the card, and parameters carry over from ggml_tpu as numpy."""

import inspect
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for a test module's PyTorch ops (a module imports
    it to use it): the tiny models' ops take microseconds, and eight threads
    a worker beside the other workers of the parallel test run oversubscribe
    the cores (a speculative round of the tiny Llama read 0.3 s with eight
    threads beside three busy workers, 13 ms with one)."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def nmse(ref, got) -> float:
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    return float(((ref - got) ** 2).sum() / (ref * ref).sum())


def planar_fields(pw) -> dict:
    """A ggml_tpu PlanarWeight as the dict of numpy fields that
    ggml_tpu_torch.convert.params_from_numpy takes."""
    return dict(
        kind=pw.kind, codes=np.asarray(pw.codes), scales=np.asarray(pw.scales),
        offsets=None if pw.offsets is None else np.asarray(pw.offsets),
        supers=None if pw.supers is None else tuple(np.asarray(s) for s in pw.supers),
        group=pw.group, n=pw.n, k=pw.k, sb=pw.sb, orig_type=int(pw.orig_type))


def random_raw(ggml_type, n: int, k: int, seed: int) -> np.ndarray:
    """Raw blocks (n, row bytes) of a random (n, k) weight of a ggml type the
    port has ported: random codes and sub-scales, finite fp16 scales."""
    from ggml_tpu_torch.dtypes import get_type_traits
    from ggml_tpu_torch.quant.reference import random_blocks

    tr = get_type_traits(ggml_type)
    blocks = random_blocks(ggml_type, n * k // tr.block_size, np.random.default_rng(seed), scale=2e-3)
    return blocks.reshape(n, -1)


def assert_planes_equal(pw, jpw):
    """A port PlanarWeight holds the planes of a ggml_tpu PlanarWeight bit
    for bit, in the same types."""
    assert (pw.kind, pw.group, pw.n, pw.k, int(pw.orig_type)) == (
        jpw.kind, jpw.group, jpw.n, jpw.k, int(jpw.orig_type))
    assert (pw.supers is None) == (jpw.supers is None)
    pairs = [("codes", pw.codes, jpw.codes), ("scales", pw.scales, jpw.scales),
             ("offsets", pw.offsets, jpw.offsets)]
    if jpw.supers is not None:
        assert pw.sb == jpw.sb
        pairs += [("d", pw.d, jpw.supers[0]), ("dmin", pw.dmin, jpw.supers[1])]
    for name, got, want in pairs:
        assert (got is None) == (want is None), name
        if want is not None:
            want = np.asarray(want)
            assert got.numpy().dtype == want.dtype and got.shape == want.shape, name
            np.testing.assert_array_equal(got.numpy(), want, err_msg=name)


def params_to_numpy(params: dict) -> dict:
    from ggml_tpu.quant.planar import PlanarWeight

    return {k: planar_fields(v) if isinstance(v, PlanarWeight) else np.asarray(v)
            for k, v in params.items()}


def tiny_gpt2_gguf(path, shape: dict, tokens: list[str], merges: list[str], seed: int = 9, **meta):
    """A GPT-2 GGUF of f32 weights from the JAX init_random_params (numpy
    draws), written by the port's writer, with a byte-level vocabulary and
    the tokenizer.ggml.* integers in meta (eos_token_id, ...)."""
    from ggml_tpu.models import gpt2 as jgpt2
    from ggml_tpu_torch.gguf import GGUFWriter

    params = jgpt2.init_random_params(jgpt2.GPT2Config(**shape), seed=seed)
    w = GGUFWriter()
    w.add_string("general.architecture", "gpt2")
    for key, field in (("vocab_size", "n_vocab"), ("context_length", "n_ctx"), ("embedding_length", "n_embd"),
                       ("attention.head_count", "n_head"), ("block_count", "n_layer")):
        w.add_u32(f"gpt2.{key}", shape[field])
    w.add_string("tokenizer.ggml.model", "gpt2")
    w.add_array("tokenizer.ggml.tokens", tokens)
    w.add_array("tokenizer.ggml.merges", merges)
    for key, val in meta.items():
        w.add_u32(f"tokenizer.ggml.{key}", val)
    for name, p in params.items():
        w.add_tensor(name, np.asarray(p))
    w.write(path)
    return path


def tiny_gptj_f32_gguf(path, cfg, seed: int):
    """A GPT-J GGUF of f32 weights: the port's write_random_gguf Q4_K file
    (written beside it) dequantized, its metadata carried over."""
    from ggml_tpu_torch.gguf import GGUFFile, GGUFWriter
    from ggml_tpu_torch.models import gptj

    q4k = path.with_suffix(".q4k.gguf")
    gptj.write_random_gguf(q4k, cfg, seed=seed)
    w = GGUFWriter()
    with GGUFFile(q4k) as g:
        for key, val in g.metadata.items():
            (w.add_string if isinstance(val, str) else w.add_u32)(key, val)
        for name in g.tensors:
            w.add_tensor(name, g.to_float32(name))
    w.write(path)
    return path


def _port_modules() -> list[str]:
    import ggml_tpu_torch

    names = ["ggml_tpu_torch"]
    for info in pkgutil.walk_packages(ggml_tpu_torch.__path__, "ggml_tpu_torch."):
        names.append(info.name)
    return names


def test_port_modules_listed():
    names = _port_modules()
    for want in ("ggml_tpu_torch.kernels.qmatmul", "ggml_tpu_torch.kernels.decode_attn",
                 "ggml_tpu_torch.kernels.flash_attn",
                 "ggml_tpu_torch.models.gptj", "ggml_tpu_torch.models.gpt2", "ggml_tpu_torch.convert",
                 "ggml_tpu_torch.opt.dataset", "ggml_tpu_torch.opt.optimizer", "ggml_tpu_torch.opt.finetune",
                 "ggml_tpu_torch.cli.finetune", "ggml_tpu_torch.sampling", "ggml_tpu_torch.tokenizer",
                 "ggml_tpu_torch.grammar", "ggml_tpu_torch.ppl", "ggml_tpu_torch.models.registry",
                 "ggml_tpu_torch.cli.generate", "ggml_tpu_torch.cli.gguf_dump", "ggml_tpu_torch.opt.lora",
                 "ggml_tpu_torch.checkpoint", "ggml_tpu_torch.models.llama", "ggml_tpu_torch.ops.core",
                 "ggml_tpu_torch.serve", "ggml_tpu_torch.cli.server", "ggml_tpu_torch.paged_kv",
                 "ggml_tpu_torch.serving_matrix", "ggml_tpu_torch.models.mnist", "ggml_tpu_torch.opt.fit",
                 "ggml_tpu_torch.speculative", "ggml_tpu_torch.models.deepseek", "ggml_tpu_torch.models.glm4moe",
                 "ggml_tpu_torch.models.olmoe", "ggml_tpu_torch.models.dbrx", "ggml_tpu_torch.models.phimoe",
                 "ggml_tpu_torch.models.gptoss", "ggml_tpu_torch.models.phi2", "ggml_tpu_torch.models.random_gguf",
                 "ggml_tpu_torch.models.gemma2", "ggml_tpu_torch.models.phi3", "ggml_tpu_torch.models.neox",
                 "ggml_tpu_torch.models.falcon"):
        assert want in names


@pytest.mark.parametrize("target", ["package", "chip_smoke"])
def test_port_imports_no_jax(target):
    """Import every module of the port (or chip_smoke.py) in a fresh
    interpreter and check that neither jax nor ggml_tpu got loaded."""
    if target == "package":
        stmt = "; ".join(f"import {m}" for m in _port_modules())
    else:
        stmt = "import chip_smoke"
    code = (f"import sys; {stmt}; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'ggml_tpu')); "
            "print(bad); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_entry_points_default_to_cuda():
    from ggml_tpu_torch.convert import params_from_numpy
    from ggml_tpu_torch.cli import finetune as cli
    from ggml_tpu_torch.cli import generate, gguf_dump, server
    from ggml_tpu_torch.models import (common, dbrx, deepseek, falcon, gemma2, glm4moe, gpt2, gptj, gptoss, llama,
                                       mnist, neox, olmoe, phi2, phi3, phimoe, registry)
    from ggml_tpu_torch.checkpoint import load_params
    from ggml_tpu_torch.opt import finetune, finetune_lora
    from ggml_tpu_torch.paged_kv import PagedKVManager
    from ggml_tpu_torch.ppl import perplexity

    for fn in (gptj.GPTJ.__init__, gptj.GPTJ.from_gguf, gptj.synth_quantized_params,
               gptj.init_cache, common.init_layer_cache, gpt2.load_params, params_from_numpy,
               gpt2.GPT2.__init__, gpt2.GPT2.from_gguf, gpt2.init_random_params, gpt2.init_cache, finetune,
               finetune_lora, load_params, registry.load_model, perplexity, llama.Llama.__init__,
               llama.Llama.from_gguf, llama.init_cache, server.ServerState.__init__, PagedKVManager.__init__,
               mnist.init_fc, mnist.init_cnn, mnist.load_gguf, deepseek.Deepseek.__init__,
               deepseek.Deepseek.from_gguf, deepseek.init_cache,
               *(f for mod, cls in ((glm4moe, glm4moe.GLM4MoE), (olmoe, olmoe.OlmoE), (dbrx, dbrx.DBRX),
                                    (phimoe, phimoe.PhiMoE), (gptoss, gptoss.GptOss), (gemma2, gemma2.Gemma2),
                                    (phi2, phi2.Phi2), (phi3, phi3.Phi3), (neox, neox.NeoX), (falcon, falcon.Falcon))
                 for f in (cls.__init__, cls.from_gguf, mod.init_cache))):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn.__qualname__
    assert cli.parser().parse_args(["in.gguf", "out.gguf", "--tokens", "t.npy"]).device == "cuda"
    assert generate.parser().parse_args(["m.gguf"]).device == "cuda"
    assert server.parser().parse_args(["m.gguf"]).device == "cuda"
    assert not hasattr(gguf_dump.parser().parse_args(["m.gguf"]), "device")  # reads the file on the host only
    # speculative decoding runs on its models' device: the card unless they were loaded on the CPU
    import torch

    from ggml_tpu_torch import speculative

    target = llama.Llama({}, llama.LlamaConfig(n_layer=1))
    for dec in (speculative.make_speculative_decoder(target, target),
                speculative.make_speculative_decoder_sampled(target, target, sampler={})):
        assert dec.device == torch.device("cuda") and dec.state is None  # nothing allocated before a call

