"""LoRA adapters: low-rank finetuning and the adapter GGUF (save, load,
merge) — port of ggml_tpu/opt/lora.py.

The llama.cpp adapter analog: its GGUF LoRA files carry <name>.lora_a /
<name>.lora_b tensor pairs, and common/common.cpp merges them at load.

Two ways to train, as in the JAX package:
- dense base: the train step merges W + (alpha/r)·B@A and autograd
  differentiates through the merge with respect to the adapters only;
- keep_quantized=True (QLoRA): the base stays planes on the card and every
  adapted weight is wrapped as a models.common.LoRAWeight, whose linear() is
  the fused kernel's product plus the rank-r adapter products; gradients
  reach the adapters through planar_matmul's backward.
The optimizer state is O(r·(n+k)) per adapted weight either way.
"""

from __future__ import annotations

import numpy as np
import torch

from ..dtypes import GGMLType
from ..gguf import GGUFFile, GGUFWriter

DEFAULT_TARGETS = (
    "attn_q.weight", "attn_k.weight", "attn_v.weight", "attn_qkv.weight",
    "attn_output.weight", "ffn_up.weight", "ffn_gate.weight", "ffn_down.weight",
)


def _shape_and_device(w):
    """(n, k) in ggml orientation and the device of a dense or planar weight
    (a PlanarWeight has n and k, no shape)."""
    from ..quant.planar import PlanarWeight

    if isinstance(w, PlanarWeight):
        return (w.n, w.k), w.codes.device
    return tuple(w.shape), w.device


def init_lora(params: dict, rank: int, targets=DEFAULT_TARGETS, seed: int = 0) -> dict:
    """{weight name: {'a': (r, k) ~ N(0, 1/r), 'b': (n, r) zeros}} f32 on the
    weight's device, for every 2-D target, dense or planar (QLoRA).  b = 0
    makes the adapted model exactly the base at step 0.  `a` comes from the
    JAX package's numpy draws in the same order, so it equals JAX's bit for
    bit."""
    from ..quant.planar import PlanarWeight

    rng = np.random.default_rng(seed)
    lora = {}
    for name, w in params.items():
        if not name.endswith(tuple(targets)):
            continue
        if not (isinstance(w, PlanarWeight) or getattr(w, "ndim", 0) == 2):
            continue
        (n, k), device = _shape_and_device(w)
        a = (rng.standard_normal((rank, k)) / np.sqrt(rank)).astype(np.float32)
        lora[name] = {"a": torch.from_numpy(a).to(device),
                      "b": torch.zeros((n, rank), dtype=torch.float32, device=device)}
    if not lora:
        raise ValueError(f"no LoRA targets matched among {len(params)} params")
    return lora


def wrap_lora(params: dict, lora: dict, scale: float = 1.0) -> dict:
    """params with every adapted weight wrapped as a models.common.LoRAWeight
    (base + scale·B@A applied as rank-r products inside linear()).  The QLoRA
    apply: quantized bases stay planes on the card, only the adapters train."""
    from ..models.common import LoRAWeight

    out = dict(params)
    for name, ab in lora.items():
        out[name] = LoRAWeight(params[name], ab["a"], ab["b"], scale)
    return out


def merge_lora(params: dict, lora: dict, scale: float = 1.0) -> dict:
    """params with W <- W + scale * B @ A (f32) for every adapted weight.  Used
    inside the dense train step (gradients flow to a and b) and for export."""
    out = dict(params)
    for name, ab in lora.items():
        out[name] = params[name].float() + scale * (ab["b"] @ ab["a"])
    return out


def save_lora_gguf(path, lora: dict, alpha: float, base_arch: str = ""):
    """Adapter-only GGUF (llama.cpp layout: general.type=adapter,
    adapter.type=lora, adapter.lora.alpha, <name>.lora_a/.lora_b tensors)."""
    w = GGUFWriter()
    w.add_string("general.type", "adapter")
    w.add_string("general.architecture", base_arch or "unknown")
    w.add_string("adapter.type", "lora")
    w.add_f32("adapter.lora.alpha", float(alpha))
    for name, ab in lora.items():
        for suffix, key in ((".lora_a", "a"), (".lora_b", "b")):
            w.add_tensor(name + suffix, ab[key].detach().float().cpu().numpy(), GGMLType.F32)
    w.write(path)


def load_lora_gguf(path) -> tuple[dict, float]:
    """-> (lora dict of f32 CPU tensors, alpha).  Scale at apply time =
    alpha / rank."""
    with GGUFFile(path) as g:
        if g.metadata.get("adapter.type") != "lora":
            raise ValueError(f"{path}: not a LoRA adapter GGUF (adapter.type {g.metadata.get('adapter.type')!r})")
        alpha = float(g.metadata.get("adapter.lora.alpha", 1.0))
        lora: dict = {}
        for tname in g.tensors:
            for suffix, key in ((".lora_a", "a"), (".lora_b", "b")):
                if tname.endswith(suffix):
                    lora.setdefault(tname[: -len(suffix)], {})[key] = torch.from_numpy(g.to_float32(tname).copy())
    for name, ab in lora.items():
        if set(ab) != {"a", "b"}:
            raise ValueError(f"{path}: {name} has {sorted(ab)}, not a and b")
    return lora, alpha


def _row_permutations(cfg) -> dict:
    """Weight-name suffix -> the output-row permutation the loader applied to
    it: GPT-J's q and k rows when its RoPE runs deinterleaved
    (models/gptj.py rope_permutation; GPTJ.from_gguf permutes by default)."""
    if not getattr(cfg, "rope_deinterleaved", False):
        return {}
    from ..models.gptj import rope_permutation

    perm = torch.from_numpy(rope_permutation(cfg.head_dim, cfg.n_head, cfg.n_rot))
    return {"attn_q.weight": perm, "attn_k.weight": perm}


def apply_lora_to_params(params: dict, path, scale: float | None = None, cfg=None) -> dict:
    """Load an adapter GGUF and merge it into dense params (the
    common/common.cpp load-time apply).  cfg: the config the params were
    loaded under.  finetune_lora trains on the file's rows; where the loader
    permuted a weight's rows (GPT-J's q and k under rope_deinterleaved), the
    adapter's b rows take the same permutation, so the update lands on the
    rows it was trained for.  (The JAX generate --lora merges file-order
    adapters into the permuted rows: ROADMAP.md, "Faults found".)  A
    llama-family model keeps the file's q/k rows (Llama.from_gguf), as do
    the gemma, phi2, phi3, gptneox and falcon loaders, so their adapters
    merge as they are; one loaded with llamacpp_permuted=True has its
    q and k rows unpermuted, and the file-order adapter is merged into them
    unchanged, as the JAX package merges it (ROADMAP.md, section 3)."""
    lora, alpha = load_lora_gguf(path)
    rank = next(iter(lora.values()))["a"].shape[0]
    s = (alpha / rank) if scale is None else scale
    perms = _row_permutations(cfg)
    placed = {}
    for name, ab in lora.items():
        device = params[name].device
        b = ab["b"]
        for suffix, perm in perms.items():
            if name.endswith(suffix):
                b = b[perm]
        placed[name] = {"a": ab["a"].to(device), "b": b.to(device)}
    out = dict(params)
    out.update(merge_lora({k: params[k] for k in placed}, placed, s))
    return out


def finetune_lora(model_path, tokens, *, rank: int = 8, alpha: float | None = None, arch: str | None = None,
                  seq_len: int = 64, batch: int = 2, steps: int = 100, adamw=None, targets=DEFAULT_TARGETS,
                  seed: int = 0, adapter_out=None, merged_out=None, log=None, keep_quantized: bool = False,
                  device="cuda", base: dict | None = None):
    """LoRA next-token finetuning.  Returns (losses, lora dict).

    alpha defaults to rank (scale 1.0).  adapter_out: write the adapter GGUF;
    merged_out: write base + adapter merged as a full model GGUF (f32).

    keep_quantized=True is QLoRA: the base stays planes on the card, the
    forward runs the inference kernels (kernel C at batch·seq_len > 32 rows),
    and gradients reach the adapters through planar_matmul's backward, so a
    6B Q4_K base finetunes on one card.  Beyond the reference, which
    restricts training to F32/F16 params (src/ggml.c:5859).  A
    mixture-of-experts base's stacked experts, never adapted (they are not
    2-D), load in finetune.moe_expert_dtype(device): bf16 on the card.

    base: the file's params as models.gpt2.load_params returned them (with
    this keep_quantized, on `device`), to train over weights already in
    memory instead of loading the file again; they are not changed."""
    from ..models.gpt2 import load_params
    from .finetune import _family, make_lm_model_fn, moe_expert_dtype, save_params_gguf, token_windows
    from .optimizer import AdamWConfig, Optimizer

    with GGUFFile(model_path) as g:
        arch = arch or g.metadata.get("general.architecture", "gpt2")
        fam = _family(arch)
        if base is None:
            base = load_params(g, torch.float32, keep_quantized=keep_quantized, device=device,
                               expert_dtype=moe_expert_dtype(device))
        if not keep_quantized:
            # keep_quantized keeps the loader's aliases (token_embd.weight@dense:
            # the embedding gather needs a dense table beside the planes)
            base = {k: v for k, v in base.items() if "@" not in k}
        cfg = fam.config_from_gguf(g)
        metadata = dict(g.metadata)

    alpha = float(rank if alpha is None else alpha)
    scale = alpha / rank
    lora = init_lora(base, rank, targets=targets, seed=seed)
    lm_fn = make_lm_model_fn(fam, cfg, seq_len, batch, expert_dtype=moe_expert_dtype(device))

    if keep_quantized:
        # the quantized base rides the step as the Optimizer's `frozen`
        # argument: no optimizer state, no gradient
        def model_fn(lora_params, toks, frozen_base):
            return lm_fn(wrap_lora(frozen_base, lora_params, scale), toks)

        opt = Optimizer(model_fn, lora, loss_type="cross_entropy_sparse", adamw=adamw or AdamWConfig(alpha=1e-3),
                        frozen=base)
    else:
        def model_fn(lora_params, toks):
            return lm_fn(merge_lora(base, lora_params, scale), toks)

        opt = Optimizer(model_fn, lora, loss_type="cross_entropy_sparse", adamw=adamw or AdamWConfig(alpha=1e-3))
    ds = token_windows(tokens, seq_len)
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
    trained = opt.params
    if adapter_out is not None:
        save_lora_gguf(adapter_out, trained, alpha, base_arch=arch)
    if merged_out is not None:
        if keep_quantized:
            # the merged export is a dense model: dequantize the base once
            # (llama.cpp merges adapters into dequantized weights the same
            # way, src/llama-adapter.cpp)
            del base, opt
            with GGUFFile(model_path) as g:
                dense = load_params(g, torch.float32, keep_quantized=False, device=device)
            base = {k: v for k, v in dense.items() if "@" not in k}
        save_params_gguf(merged_out, merge_lora(base, trained, scale), metadata)
    return losses, trained
