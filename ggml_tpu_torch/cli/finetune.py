"""Finetune a GGUF LM on a token stream and write the result back to GGUF
(port of ggml_tpu/cli/finetune.py): full weights, or LoRA adapters over a
dense base, or over a base kept quantized on the card (QLoRA).

Usage:
  python -m ggml_tpu_torch.cli.finetune model.gguf out.gguf --tokens data.npy \\
      [--arch gptj] [--seq 128] [--batch 4] [--steps 200] [--lr 1e-4] [--device cuda] \\
      [--checkpoint-dir ckpts --checkpoint-every 50]
  python -m ggml_tpu_torch.cli.finetune model-q4_k.gguf merged.gguf --tokens data.npy \\
      --lora-rank 8 [--lora-alpha 8] [--lora-targets attn_q.weight,attn_v.weight] \\
      --lora-quantized --lora-out adapter.gguf

tokens: .npy int array or a text file of whitespace-separated token ids.
"""

import argparse
import pathlib

import numpy as np


def _load_tokens(path) -> np.ndarray:
    p = pathlib.Path(path)
    if p.suffix == ".npy":
        return np.load(p).astype(np.int32).reshape(-1)
    return np.asarray([int(t) for t in p.read_text().split()], np.int32)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("model")
    ap.add_argument("out")
    ap.add_argument("--tokens", required=True)
    ap.add_argument("--arch", default=None)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dp", type=int, default=0, help="data-parallel mesh size (not ported)")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=0)
    ap.add_argument("--lora-rank", type=int, default=0, help="train LoRA adapters instead of full weights")
    ap.add_argument("--lora-alpha", type=float, default=None)
    ap.add_argument("--lora-out", default=None, help="adapter-only GGUF output (with --lora-rank)")
    ap.add_argument("--lora-targets", default=None,
                    help="comma list of weight-name suffixes to adapt (default: attention+ffn projections; "
                         "add output.weight for untied-head models)")
    ap.add_argument("--lora-quantized", action="store_true",
                    help="QLoRA: keep the base quantized on the card (the inference kernels serve the "
                         "forward; only the adapters train)")
    return ap


def main(argv=None):
    args = parser().parse_args(argv)

    from ggml_tpu_torch.opt import AdamWConfig, finetune

    if args.lora_rank:
        from ggml_tpu_torch.opt import finetune_lora
        from ggml_tpu_torch.opt.lora import DEFAULT_TARGETS

        targets = (tuple(t for t in args.lora_targets.split(",") if t)
                   if args.lora_targets else DEFAULT_TARGETS)
        losses, _ = finetune_lora(
            args.model, _load_tokens(args.tokens), rank=args.lora_rank, alpha=args.lora_alpha, arch=args.arch,
            seq_len=args.seq, batch=args.batch, steps=args.steps, targets=targets,
            adamw=AdamWConfig(alpha=args.lr), seed=args.seed, adapter_out=args.lora_out, merged_out=args.out,
            log=print, keep_quantized=args.lora_quantized, device=args.device,
        )
        print(f"final loss {losses[-1]:.4f}  (first {losses[0]:.4f}) -> {args.out}"
              + (f" + adapter {args.lora_out}" if args.lora_out else ""))
        return

    if args.dp:
        raise NotImplementedError("data-parallel finetuning is not ported yet (ROADMAP.md, parallel/)")
    if args.checkpoint_dir:
        pathlib.Path(args.checkpoint_dir).mkdir(parents=True, exist_ok=True)
    losses, _ = finetune(
        args.model, _load_tokens(args.tokens), arch=args.arch, seq_len=args.seq, batch=args.batch,
        steps=args.steps, adamw=AdamWConfig(alpha=args.lr), seed=args.seed, out_path=args.out,
        checkpoint_path=args.checkpoint_dir, checkpoint_every=args.checkpoint_every, log=print,
        device=args.device,
    )
    print(f"final loss {losses[-1]:.4f}  (first {losses[0]:.4f}) -> {args.out}")


if __name__ == "__main__":
    main()
