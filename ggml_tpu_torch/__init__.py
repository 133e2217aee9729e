"""ggml_tpu_torch — the PyTorch/CUDA port of ggml_tpu for NVIDIA Hopper.

The JAX package ggml_tpu stays the reference; this package imports nothing of
it, and nothing of JAX.  Public surface (lazy imports keep `import
ggml_tpu_torch` light):

    ggml_tpu_torch.GGUFFile              GGUF v3 reader
    ggml_tpu_torch.GGMLType              on-disk dtype ids + traits
    ggml_tpu_torch.repack / PlanarWeight Q4_K nibble planes, int8 planes of
                                         Q8_0, Q5_0, Q5_1, Q5_K, Q6_K
    ggml_tpu_torch.planar_matmul         quantized matmul through the CUDA kernels
    ggml_tpu_torch.fused_decode_attention  single-token attention kernel
    ggml_tpu_torch.models.gptj           GPT-J (greedy and sampled generation)
    ggml_tpu_torch.models.llama          the Llama family (GQA, RMSNorm, SwiGLU, rotate-half RoPE)
    ggml_tpu_torch.models.registry       load_model / load_tokenizer from a GGUF file
    ggml_tpu_torch.opt                   AdamW training, finetune, LoRA / QLoRA (finetune_lora)
    ggml_tpu_torch.checkpoint            optimizer state to and from a GGUF file
    ggml_tpu_torch.params_from_numpy     weights carried over from ggml_tpu

Command lines: python -m ggml_tpu_torch.cli.{generate,gguf_dump,finetune}.
"""

__version__ = "0.1.0"

_LAZY = {
    "GGUFFile": ("ggml_tpu_torch.gguf", "GGUFFile"),
    "GGMLType": ("ggml_tpu_torch.dtypes", "GGMLType"),
    "repack": ("ggml_tpu_torch.quant.planar", "repack"),
    "PlanarWeight": ("ggml_tpu_torch.quant.planar", "PlanarWeight"),
    "planar_matmul": ("ggml_tpu_torch.kernels.qmatmul", "planar_matmul"),
    "fused_decode_attention": ("ggml_tpu_torch.kernels.decode_attn", "fused_decode_attention"),
    "params_from_numpy": ("ggml_tpu_torch.convert", "params_from_numpy"),
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        mod, attr = _LAZY[name]
        return getattr(importlib.import_module(mod), attr)
    raise AttributeError(f"module 'ggml_tpu_torch' has no attribute {name!r}")


def __dir__():
    return sorted(list(_LAZY) + ["models", "kernels", "quant"])
