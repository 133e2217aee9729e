"""Text-generation CLI (port of ggml_tpu/cli/generate.py) — the analog of
the reference's gpt-2/gpt-j example binaries (examples/gpt-2/main-backend.cpp:784
main; flags mirror examples/common.cpp gpt_params).

Usage:
  python -m ggml_tpu_torch.cli.generate model.gguf -p "Hello" -n 64 --top-k 40 --top-p 0.95 --temp 0.8
  python -m ggml_tpu_torch.cli.generate model-00001-of-00003.gguf ...                # a split file: its first shard
  python -m ggml_tpu_torch.cli.generate model.gguf -p "Hello" --quantized --verbose   # planes, kernel report
  python -m ggml_tpu_torch.cli.generate model.gguf -p "Hello" --device cpu            # plain versions, CPU

The text goes to stdout (the prompt, then the generated text); the kernel
report (--verbose) and the load and predict times go to stderr.  Decoding
runs on the model's device loop where the family has one: --top-k 1 keeps
one token, the argmax (the reference sampler keeps exactly top_k candidates),
and decodes greedily; otherwise the first token is drawn from the prefill
logits and the rest by the model's decode_sampled (a CUDA graph replay a
token on the card), seeded by --seed.  A family without decode_sampled
(gpt2) and --grammar take the host loop of models.common.generate.
"""

import argparse
import sys
import time

import numpy as np


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("model")
    ap.add_argument("-p", "--prompt", default="Hello")
    ap.add_argument("-n", "--n-predict", type=int, default=64)
    ap.add_argument("--arch", default=None,
                    help="override GGUF general.architecture (see "
                         "ggml_tpu_torch.models.registry.ARCHS for the ported ones)")
    ap.add_argument("--top-k", type=int, default=40)
    ap.add_argument("--top-p", type=float, default=0.95)
    ap.add_argument("--temp", type=float, default=0.8)
    ap.add_argument("--seed", type=int, default=-1)
    ap.add_argument("--quantized", action="store_true", help="keep weights packed (the CUDA kernels)")
    ap.add_argument("--max-seq", type=int, default=512)
    ap.add_argument("--verbose", action="store_true",
                    help="print the kernel-selection report (which kernel each matmul site ran) "
                         "after generation")
    ap.add_argument("--lora", default=None,
                    help="adapter GGUF (cli.finetune --lora-out) merged into the dense weights at load, "
                         "on the rows it was trained for")
    ap.add_argument("--grammar", default=None,
                    help="GBNF grammar file constraining generation "
                         "(llama.cpp grammars; host-side sampling)")
    ap.add_argument("--device", default="cuda")
    return ap


def decode(model, ids: np.ndarray, n: int, generator, temperature: float = 0.8, top_k: int = 40,
           top_p: float = 0.95, sampler=None) -> list[int]:
    """The n ids generated after the prompt ids (1, t), as the CLI decodes
    them (see the module docstring); sampler (a GrammarSampler) takes the
    host loop.  generator: a torch.Generator on the model's device."""
    from ggml_tpu_torch.sampling import sample_top_k_top_p

    if sampler is not None:
        return model.generate(ids, n, sampler=sampler, key=generator)
    if top_k == 1:
        return model.generate(ids, n)
    kw = dict(temperature=temperature, top_k=top_k, top_p=top_p)
    if not hasattr(model, "decode_sampled"):
        return model.generate(ids, n, sampler=lambda logits, gen: sample_top_k_top_p(logits, gen, **kw),
                              key=generator)
    if n <= 0:
        return []
    logits, cache, n_past = model.prefill(model.new_cache(), ids)
    first, generator = sample_top_k_top_p(logits, generator, **kw)
    if n == 1:
        return [int(first[0])]
    cache, toks = model.decode_sampled(cache, first.reshape(-1, 1), n_past, n - 1, generator, **kw)
    return [int(first[0])] + toks[:, 0].tolist()


def main(argv=None):
    args = parser().parse_args(argv)
    if args.lora and args.quantized:
        raise SystemExit("--lora merges into dense weights; drop --quantized")

    import torch

    from ggml_tpu_torch.gguf import GGUFFile
    from ggml_tpu_torch.models.registry import load_model, load_tokenizer

    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the port runs on the card (--device cpu runs the plain versions)")
    # dense products sum as the JAX package's do under XLA: f32 products in
    # full f32, bf16 products reduced in f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

    with GGUFFile(args.model) as g:
        arch = args.arch or g.metadata.get("general.architecture", "gpt2")
        tok = load_tokenizer(g)
        eos_meta = g.metadata.get("tokenizer.ggml.eos_token_id", -1)
    t_load0 = time.perf_counter()
    m = load_model(args.model, arch=arch, keep_quantized=args.quantized, max_seq=args.max_seq, batch=1,
                   device=args.device)
    if args.lora:
        from ggml_tpu_torch.opt.lora import apply_lora_to_params

        m.params = apply_lora_to_params(m.params, args.lora, cfg=m.cfg)
    t_load = time.perf_counter() - t_load0

    if tok is not None:
        ids = np.asarray([tok.encode(args.prompt)], np.int32)
    else:
        print("(no tokenizer in GGUF; prompt interpreted as space-separated ids)", file=sys.stderr)
        ids = np.asarray([[int(t) for t in args.prompt.split()]], np.int32)

    generator = torch.Generator(device=m.device)
    generator.manual_seed(args.seed if args.seed >= 0 else int(time.time()))

    sampler = None
    if args.grammar:
        from ggml_tpu_torch.grammar import GrammarSampler

        if tok is None:
            raise SystemExit("--grammar needs a tokenizer in the GGUF")
        eos_meta = int(eos_meta[0] if isinstance(eos_meta, (list, tuple, np.ndarray)) else eos_meta)
        with open(args.grammar) as f:
            sampler = GrammarSampler(f.read(), tok, eos_id=eos_meta)

    t0 = time.perf_counter()
    out = decode(m, ids, args.n_predict, generator, temperature=args.temp, top_k=args.top_k, top_p=args.top_p,
                 sampler=sampler)
    dt = time.perf_counter() - t0

    text = tok.decode(out) if tok else " ".join(map(str, out))
    print(args.prompt + text)
    if args.verbose:
        from ggml_tpu_torch.kernels.qmatmul import kernel_selection_report

        report = kernel_selection_report()
        print("kernel selection (distinct matmul sites):", file=sys.stderr)
        for line in report or ["  (no planar matmuls run — dense weights)"]:
            print(f"  {line}", file=sys.stderr)
    print(
        f"\n   load time = {t_load*1000:8.2f} ms\n"
        f"predict time = {dt*1000:8.2f} ms / {dt*1000/max(1,args.n_predict):.2f} ms per token",
        file=sys.stderr,
    )


if __name__ == "__main__":
    main()
