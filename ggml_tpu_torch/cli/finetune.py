"""Finetune a GGUF LM on a token stream and write the result back to GGUF
(port of ggml_tpu/cli/finetune.py, full-weight training only).

Usage:
  python -m ggml_tpu_torch.cli.finetune model.gguf out.gguf --tokens data.npy \\
      [--arch gpt2] [--seq 128] [--batch 4] [--steps 200] [--lr 1e-4] [--device cuda]

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
    ap.add_argument("--checkpoint-dir", default=None, help="not ported")
    ap.add_argument("--lora-rank", type=int, default=0, help="LoRA adapters (not ported)")
    ap.add_argument("--lora-alpha", type=float, default=None)
    ap.add_argument("--lora-out", default=None)
    ap.add_argument("--lora-targets", default=None)
    ap.add_argument("--lora-quantized", action="store_true")
    return ap


def main(argv=None):
    args = parser().parse_args(argv)

    if args.lora_rank or args.lora_out or args.lora_targets or args.lora_quantized or args.lora_alpha is not None:
        raise NotImplementedError("LoRA finetuning is not ported yet (ROADMAP.md, LoRA/QLoRA)")
    if args.dp:
        raise NotImplementedError("data-parallel finetuning is not ported yet (ROADMAP.md, parallel/)")
    if args.checkpoint_dir:
        raise NotImplementedError("optimizer checkpoints are not ported yet (ROADMAP.md, checkpoint.py)")

    from ggml_tpu_torch.opt import AdamWConfig, finetune

    losses, _ = finetune(
        args.model, _load_tokens(args.tokens), arch=args.arch, seq_len=args.seq, batch=args.batch,
        steps=args.steps, adamw=AdamWConfig(alpha=args.lr), seed=args.seed, out_path=args.out, log=print,
        device=args.device,
    )
    print(f"final loss {losses[-1]:.4f}  (first {losses[0]:.4f}) -> {args.out}")


if __name__ == "__main__":
    main()
