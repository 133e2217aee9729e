"""LM finetuning: GGUF in -> next-token training -> GGUF out (port of
ggml_tpu/opt/finetune.py; the downstream analog is llama.cpp's finetune
example).

make_lm_model_fn builds the model function the Optimizer trains: the family
forward from an empty cache, optionally in bf16 over f32 master weights and
(GPT-2) through the flash-attention training kernels.  Ported families: gpt2,
gptj and the dense llama family (llama, qwen2, qwen3).  remat_policy runs
each layer under torch.utils.checkpoint, the counterpart of jax.checkpoint
(see _remat).  Checkpoints go through checkpoint.py (atomic publish,
bit-exact resume).
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
    "qwen2moe": "section 1 item 4, the MoE block", "qwen3moe": "section 1 item 4, the MoE block",
    "deepseek2": "section 1 item 6, the other families", "gemma2": "section 1 item 6, the other families",
    "phi2": "section 1 item 6, the other families", "gptneox": "section 1 item 6, the other families",
    "falcon": "section 1 item 6, the other families",
}


def _family(arch: str):
    if arch == "gpt2":
        from ..models import gpt2 as fam

        return fam
    if arch == "gptj":
        from ..models import gptj as fam

        return fam
    if arch in ("llama", "qwen2", "qwen3"):
        from ..models import llama as fam

        return fam
    if arch in _NOT_PORTED:
        raise NotImplementedError(f"finetuning {arch} is not ported yet (ROADMAP.md, {_NOT_PORTED[arch]})")
    raise ValueError("finetune supports gpt2/gptj/llama(+qwen2/3, qwen*moe)/deepseek2/"
                     f"gemma2/phi2/gptneox/falcon, not {arch}")


# the argument-free policies of jax.checkpoint_policies, under both of their
# names; the aten products each saves (a "dot" is a dot_general: torch's
# mm and addmm are the products without batch dims, bmm and baddbmm the
# batched ones, such as the attention's)
_NO_BATCH_DOTS = ("mm", "addmm")
_DOTS = _NO_BATCH_DOTS + ("bmm", "baddbmm")
_REMAT_SAVES = {
    "everything_saveable": None, "nothing_saveable": (),
    "dots_saveable": _DOTS, "checkpoint_dots": _DOTS,
    "dots_with_no_batch_dims_saveable": _NO_BATCH_DOTS, "checkpoint_dots_with_no_batch_dims": _NO_BATCH_DOTS,
}


def _remat(policy: str):
    """The per-layer wrapper (models/common.run_layers) that rematerializes a
    training forward as jax.checkpoint(model_fn, policy=getattr(
    jax.checkpoint_policies, policy)) does, or None for everything_saveable,
    which saves all (no remat).

    Each layer runs under torch.utils.checkpoint (non-reentrant): the
    forward keeps its inputs, and the backward runs the layer's forward
    again for what it needs.  The "dots" policies also keep the outputs of
    the products they name, through selective checkpointing (a policy over
    aten ops), so those are not recomputed; everything else is, the
    hand-written kernels included, as JAX recomputes a pallas_call's output
    (it is not a dot): the planar matmuls' kernels (C, G) and the training
    flash forward (K) run again in the backward, on every layer's linears.
    Outside the layers nothing is recomputed: JAX does not recompute the
    head either, as only the loss reads its output.  Values never change,
    only memory and launches.

    Per layer, where JAX wraps the whole model function: PyTorch's
    checkpoint recomputes a region's whole forward at the first use of any
    of its saved tensors, so one region over the model would hold every
    recomputed activation at once and lower no peak (a CPU run of a 12-layer
    GPT-2 read a higher peak with it than without), where XLA schedules
    JAX's recompute layer by layer beside the backward.  The layer inputs
    are kept beside what the policy keeps, and each layer's forward runs
    again whole, so the kernels run again exactly where JAX's do.  The
    training forwards draw no random numbers, so the recompute needs no
    saved RNG state (preserve_rng_state=False)."""
    if policy not in _REMAT_SAVES:  # a name JAX lacks, or one of its policy factories (save_only_these_names...)
        raise ValueError(f"remat_policy {policy!r} is not an argument-free jax.checkpoint_policies policy; "
                         f"one of {sorted(_REMAT_SAVES)}")
    saves = _REMAT_SAVES[policy]
    if saves is None:
        return None
    from torch.utils.checkpoint import (CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts,
                                       set_checkpoint_early_stop)

    kw = {}
    if saves:
        ops = {getattr(torch.ops.aten, name).default for name in saves}

        def keep(ctx, op, *args, **kwargs):
            return CheckpointPolicy.MUST_SAVE if op in ops else CheckpointPolicy.PREFER_RECOMPUTE

        kw["context_fn"] = lambda: create_selective_checkpoint_contexts(keep)

    def remat_layer(layer, i, x):
        # the whole layer again: left to stop early, the recompute would end
        # at the last op that saves a tensor, before ffn_down's kernel, whose
        # output JAX recomputes (the next layer's input needs it there)
        with set_checkpoint_early_stop(False):
            return checkpoint(layer, i, x, use_reentrant=False, preserve_rng_state=False, **kw)

    return remat_layer


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
    allocated for prompts longer than one token.  remat_policy: the name of
    an argument-free jax.checkpoint_policies policy (everything_saveable,
    nothing_saveable, dots_saveable, dots_with_no_batch_dims_saveable, and
    the checkpoint_dots aliases), under which every layer is
    rematerialized (see _remat).  params may hold PlanarWeight and
    LoRAWeight values (QLoRA), which no cast touches."""
    remat = _remat(remat_policy) if remat_policy else None

    def model_fn(params, tokens):
        if compute_dtype is not None:
            params = {k: v.to(compute_dtype) if getattr(v, "dtype", None) == torch.float32 else v
                      for k, v in params.items()}
        b, t = tokens.shape
        cache = (None if train_flash and t > 1 else
                 fam.init_cache(cfg, b, seq_len, compute_dtype or torch.float32, device=tokens.device))
        zero = torch.zeros((), dtype=torch.int32, device=tokens.device)
        kw = {"train_flash": True} if train_flash else {}
        if remat is not None:
            kw["layer_remat"] = remat
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
