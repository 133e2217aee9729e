"""Arch registry: GGUF general.architecture -> model family class (port of
ggml_tpu/models/registry.py, the analog of llama.cpp's LLM_ARCH table).

ARCHS holds the families the port has; an architecture the JAX package
serves but the port does not yet raises NotImplementedError, and one neither
knows raises KeyError, as the JAX registry does.
"""

from __future__ import annotations

import importlib

# arch -> (module under ggml_tpu_torch.models, wrapper class name)
ARCHS: dict[str, tuple[str, str]] = {
    "gpt2": ("gpt2", "GPT2"),
    "gptj": ("gptj", "GPTJ"),
    # the llama family (qkv biases, qk-norm, granite scales, NoPE,
    # interleaved RoPE, a decoupled head_dim; the experts of Mixtral, which
    # is a llama file with llama.expert_count, qwen2moe, qwen3moe, granitemoe)
    "llama": ("llama", "Llama"),
    "qwen2": ("llama", "Llama"),
    "qwen3": ("llama", "Llama"),
    "qwen2moe": ("llama", "Llama"),
    "qwen3moe": ("llama", "Llama"),
    "granite": ("llama", "Llama"),
    "granitemoe": ("llama", "Llama"),
    "smollm3": ("llama", "Llama"),
    "ernie4_5": ("llama", "Llama"),
    "helium": ("llama", "Llama"),
    "seed_oss": ("llama", "Llama"),
    # DeepSeek V2/V3: multi-head latent attention, group-limited routing
    "deepseek2": ("deepseek", "Deepseek"),
    # the other mixture-of-experts families: GLM-4.5's DeepSeek routing
    # (dots1 reads the same module), OLMoE, DBRX, Phi-3.5-MoE's
    # sparsemixer, gpt-oss's sinks and sliding windows
    "glm4moe": ("glm4moe", "GLM4MoE"),
    "dots1": ("glm4moe", "GLM4MoE"),
    "olmoe": ("olmoe", "OlmoE"),
    "dbrx": ("dbrx", "DBRX"),
    "phimoe": ("phimoe", "PhiMoE"),
    "gpt-oss": ("gptoss", "GptOss"),
    # the dense families: Gemma 1/2/3 (one module), Phi-2, Phi-3 (LongRoPE),
    # GPT-NeoX, Falcon
    "gemma": ("gemma2", "Gemma2"),
    "gemma2": ("gemma2", "Gemma2"),
    "gemma3": ("gemma2", "Gemma2"),
    "phi2": ("phi2", "Phi2"),
    "phi3": ("phi3", "Phi3"),
    "gptneox": ("neox", "NeoX"),
    "falcon": ("falcon", "Falcon"),
}

# the rest of the JAX registry's table (ggml_tpu/models/registry.py:15-73)
_NOT_PORTED = (
    "bloom", "mpt", "starcoder", "starcoder2", "command-r", "olmo", "olmo2", "olmo3",
    "persimmon", "nemotron", "stablelm", "glm", "glm4", "qwen3next",
    "bamba", "jamba", "mamba", "falcon_mamba", "mamba2", "rwkv", "xlstm", "recurrentgemma", "lfm2", "llama4",
    "apertus", "granitehybrid", "minimax", "zamba2", "chameleon", "jetmoe",
)


def model_class(arch: str):
    """Resolve an architecture string to its wrapper class."""
    if arch in _NOT_PORTED:
        raise NotImplementedError(f"architecture {arch!r} is not ported yet (ROADMAP.md, section 1); "
                                  f"ported: {sorted(ARCHS)}")
    if arch not in ARCHS:
        raise KeyError(f"unknown architecture {arch!r}; known: {sorted(ARCHS)}")
    mod, cls = ARCHS[arch]
    return getattr(importlib.import_module(f"..{mod}", __name__), cls)


def load_model(path, arch: str | None = None, max_seq: int = 512, batch: int = 1,
               keep_quantized: bool = False, device="cuda", **kw):
    """Open a GGUF file and build the right family wrapper on `device`."""
    from ..gguf import GGUFFile

    if arch is None:
        with GGUFFile(path) as g:
            arch = g.metadata.get("general.architecture", "gpt2")
    cls = model_class(arch)
    return cls.from_gguf(path, keep_quantized=keep_quantized, max_seq=max_seq, batch=batch, device=device, **kw)


def load_tokenizer(g):
    """Tokenizer from GGUF metadata (BPE or SPM), or None if absent."""
    from ..tokenizer import BPETokenizer, SPMTokenizer

    if "tokenizer.ggml.tokens" not in g.metadata:
        return None
    kind = g.metadata.get("tokenizer.ggml.model") or ["gpt2"]
    kind = kind[0] if isinstance(kind, (list, tuple)) else kind
    return SPMTokenizer.from_gguf(g) if kind == "llama" else BPETokenizer.from_gguf(g)
