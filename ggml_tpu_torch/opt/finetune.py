"""LM finetuning: GGUF in -> next-token training -> GGUF out (port of
ggml_tpu/opt/finetune.py; the downstream analog is llama.cpp's finetune
example).

make_lm_model_fn builds the model function the Optimizer trains: the family
forward from an empty cache, optionally in bf16 over f32 master weights and
(GPT-2) through the flash-attention training kernels.  Ported families: gpt2,
gptj.  Checkpoints go through checkpoint.py (atomic publish, bit-exact
resume).
"""

from __future__ import annotations

import numpy as np
import torch

from ..dtypes import GGMLType
from ..gguf import GGUFFile, GGUFWriter
from .dataset import Dataset
from .optimizer import AdamWConfig, Optimizer

# the families the JAX package finetunes, with the ROADMAP.md item that ports them
_NOT_PORTED = {
    "llama": "the llama family", "qwen2": "the llama family", "qwen3": "the llama family",
    "qwen2moe": "the llama family", "qwen3moe": "the llama family",
    "deepseek2": "the other families", "gemma2": "the other families", "phi2": "the other families",
    "gptneox": "the other families", "falcon": "the other families",
}


def _family(arch: str):
    if arch == "gpt2":
        from ..models import gpt2 as fam

        return fam
    if arch == "gptj":
        from ..models import gptj as fam

        return fam
    if arch in _NOT_PORTED:
        raise NotImplementedError(f"finetuning {arch} is not ported yet (ROADMAP.md, {_NOT_PORTED[arch]})")
    raise ValueError("finetune supports gpt2/gptj/llama(+qwen2/3, qwen*moe)/deepseek2/"
                     f"gemma2/phi2/gptneox/falcon, not {arch}")


def make_lm_model_fn(fam, cfg, seq_len: int, batch: int, compute_dtype=None, cast_logits_f32: bool = True,
                     remat_policy: str | None = None, train_flash: bool = False):
    """(params, tokens (B, T)) -> logits (B, T, V) through the family forward
    from an empty cache (positions from the zero cache_len).

    compute_dtype=torch.bfloat16: f32 master weights are cast to bf16 where
    the forward begins (a differentiable .to(), so the gradients come back
    in f32); None keeps the whole pass in f32.  cast_logits_f32=False keeps
    the logits in the compute type, for the fused cross entropy.
    train_flash=True: attention through the flash-attention training kernels
    (O(seq) residuals; GPT-2, whose forward takes the flag); no cache is
    allocated for prompts longer than one token.  remat_policy
    (jax.checkpoint policies) has no counterpart yet.  params may hold
    PlanarWeight and LoRAWeight values (QLoRA), which no cast touches."""
    if remat_policy:
        raise NotImplementedError("rematerialization (remat_policy) is not ported yet (ROADMAP.md, remat)")

    def model_fn(params, tokens):
        if compute_dtype is not None:
            params = {k: v.to(compute_dtype) if getattr(v, "dtype", None) == torch.float32 else v
                      for k, v in params.items()}
        b, t = tokens.shape
        cache = (None if train_flash and t > 1 else
                 fam.init_cache(cfg, b, seq_len, compute_dtype or torch.float32, device=tokens.device))
        zero = torch.zeros((), dtype=torch.int32, device=tokens.device)
        kw = {"train_flash": True} if train_flash else {}
        logits, _ = fam.forward(params, cfg, tokens, zero.expand(b), cache, zero, **kw)
        return logits.float() if cast_logits_f32 else logits

    return model_fn


def token_windows(tokens: np.ndarray, seq_len: int) -> Dataset:
    """Non-overlapping (input, target) next-token windows as a Dataset."""
    tokens = np.asarray(tokens, np.int32).reshape(-1)
    n = (len(tokens) - 1) // seq_len
    if n == 0:
        raise ValueError(f"need more than seq_len={seq_len} tokens, got {len(tokens)}")
    x = np.stack([tokens[i * seq_len:(i + 1) * seq_len] for i in range(n)])
    y = np.stack([tokens[i * seq_len + 1:(i + 1) * seq_len + 1] for i in range(n)])
    return Dataset(x, y)


def save_params_gguf(path, params: dict, metadata: dict, half: bool = False):
    """Write a params dict back to GGUF with the source metadata, so the
    result loads wherever the original did (tensor names are GGUF names)."""
    w = GGUFWriter()
    for key, val in metadata.items():
        if isinstance(val, bool):
            w.add_u32(key, int(val))
        elif isinstance(val, (int, np.integer)):
            (w.add_u32 if 0 <= int(val) < 2**32 else w.add_u64)(key, int(val))
        elif isinstance(val, (float, np.floating)):
            w.add_f32(key, float(val))
        elif isinstance(val, str):
            w.add_string(key, val)
        elif isinstance(val, (list, tuple, np.ndarray)):
            w.add_array(key, list(val))
    t = GGMLType.F16 if half else GGMLType.F32
    for name, p in params.items():
        if "@" in name:  # loader-made aliases, not file tensors
            continue
        arr = p.detach().float().cpu().numpy() if isinstance(p, torch.Tensor) else np.asarray(p, np.float32)
        w.add_tensor(name, arr, t if arr.ndim >= 2 else GGMLType.F32)
    w.write(path)


def finetune(model_path, tokens, *, arch: str | None = None, seq_len: int = 64, batch: int = 2,
             steps: int = 100, adamw: AdamWConfig | None = None, mesh=None, seed: int = 0, out_path=None,
             checkpoint_path=None, checkpoint_every: int = 0, log=None, device="cuda"):
    """Next-token finetuning loop in f32 through the cache-window attention.
    Returns (losses, opt).  tokens: flat int array of training token ids;
    out_path: write the trained weights as GGUF; checkpoint_path +
    checkpoint_every: the optimizer state every checkpoint_every steps as
    <checkpoint_path>/step<N>.gguf (checkpoint.py, atomic)."""
    if mesh is not None:
        raise NotImplementedError("data-parallel finetuning is not ported yet (ROADMAP.md, parallel/)")
    with GGUFFile(model_path) as g:
        arch = arch or g.metadata.get("general.architecture", "gpt2")
        fam = _family(arch)
        from ..models.gpt2 import load_params

        params = load_params(g, torch.float32, keep_quantized=False, device=device)
        params = {k: v for k, v in params.items() if "@" not in k}
        cfg = fam.config_from_gguf(g)
        metadata = dict(g.metadata)

    ds = token_windows(tokens, seq_len)
    model_fn = make_lm_model_fn(fam, cfg, seq_len, batch)
    opt = Optimizer(model_fn, params, loss_type="cross_entropy_sparse", adamw=adamw or AdamWConfig())

    rng = np.random.default_rng(seed)
    n_batches = max(1, ds.ndata // batch)
    losses = []
    for step in range(steps):
        if step % n_batches == 0:
            ds.shuffle(rng)
        x, y = ds.get_batch(step % n_batches, batch)
        metrics = opt.step(x, y)
        losses.append(float(metrics["loss"]))
        if log is not None and (step % 10 == 0 or step == steps - 1):
            log(f"step {step:5d}  loss {losses[-1]:.4f}")
        if checkpoint_path and checkpoint_every and (step + 1) % checkpoint_every == 0:
            from ..checkpoint import save_optimizer

            save_optimizer(f"{checkpoint_path}/step{step + 1}.gguf", opt)
    if out_path is not None:
        save_params_gguf(out_path, opt.params, metadata)
    return losses, opt
