#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ggml_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --long-decode-profile   # phases 1, 2 and the decode profiles after a long prompt only
    python3 chip_smoke.py --flash-times           # phases 1, 2 and kernel J's and its mask ranges' times only
    python3 chip_smoke.py --train-times           # phases 1, 2 and kernels K, L, M's times at the training shapes only
    python3 chip_smoke.py --gemv-times            # phases 1, 2 and the GEMV kernels' times at the decode shapes only
    python3 chip_smoke.py --front-end             # phases 1, 2 and the text front end (4i) only
    python3 chip_smoke.py --qlora                 # phases 1, 2, the GGUF writer and QLoRA fine-tuning (4j) only
    python3 chip_smoke.py --iquants               # phases 1, 2 and GPT-J-6B from IQ4_XS, IQ1_M, TQ2_0 files (4k) only
    python3 chip_smoke.py --llama                 # phases 1, 2 and Llama-3-8B from a Q4_K GGUF file (4l) only
    python3 chip_smoke.py --serve                 # phases 1, 2 and serving (4m: the Engine, the HTTP server; 4n: the
                                                  # paged, chunked and q8 KV engines) only
    python3 chip_smoke.py --train                 # phases 1, 2 and training (4g, 4h, 4o, 4p, 4q) only

Phases (any failure exits non-zero without the result line):
1. the card, as nvidia-smi reports its name and power limit;
2. build the kernels from ggml_tpu_torch/kernels/csrc with nvcc (sm_90a);
3. hold each kernel against its plain PyTorch version on the card at the
   GPT-J-6B shapes of the main paths, and time kernel, plain version and one
   library call computing the same function (a yardstick only; the port
   never calls it), beside the least time the card could take (bound);
   kernel G also over IQ1_M (groups of 8, offsets) and TQ2_0 (groups of
   256) planes repacked from random blocks, at M = 1, 8, 100 and 1024, and
   E over IQ2_XS and IQ1_S planes; A, B, C, F, G, H and J also at the
   Llama-3-8B shapes GPT-J never reached (N = 1024 and 14336, ffn_down's K =
   14336 over expanded planes for H, the 128256-row Q6_K head, J under GQA
   32/8 at d = 128);
4. serve greedy requests through GPT-J-6B at its published widths
   (EleutherAI/gpt-j-6b: n_vocab 50400, E 4096, 16 heads, 28 layers, n_rot
   64, context 2048), decoding as CUDA graph replays (one capture per model,
   made while warming up), counting every kernel launch of each run, then
   decoding the first request again eagerly (the same ids, ms/token side by
   side), and profiling eager and graphed decode: (a)
   synthesized compact Q4_K planes, prompts 8, 100, 1, a seeded sampled
   request (twice, eagerly, and with top_k = 1 against the greedy ids), then
   a 1024-token prompt through the flash prefill (J and its two helpers) and
   profiles of decode steps after a 1088-token prompt, (b) synthesized Q8_0 planes, three
   requests, (c) compact Q6_K planes repacked from random blocks, one
   request, (e) synthesized Q4_0 planes (multiplied-out nibble planes),
   prompts 8, 100, 1 and 1024, (f) synthesized Q3_K planes (groups of 16),
   one request; then (d) hold a tiny GPT-J on the card against the same model
   on the CPU for a Q4_K, a Q8_0, a mixed Q4_K/Q6_K, a Q4_0 and a mixed
   Q4_1/Q2_K/Q3_K parameter set, a GGUF file mixing all eleven IQ* and TQ*
   types, and a flash prefill; (g) train GPT-2-medium
   at its published widths (openai-community/gpt2-medium: n_vocab 50257, E
   1024, 16 heads, 24 layers, tied head) for 1 + 6 AdamW steps of batch 8 x
   512 as bench.py's train mode composes them (bf16 over f32 masters, bf16
   moments, fused cross entropy, flash attention through kernels K, L, M),
   counting every launch, and profile one step; (h) a tiny f32 GPT-2 on the
   card against the same model on the CPU: loss, every gradient through the
   flash kernels, 3 AdamW steps; (i) the text front end: write a GPT-J-6B
   GGUF (Q4_K blocks, a byte-level BPE vocabulary of 50400 entries; 4 of
   its 28 layers in the whole run, all 28 with --front-end and --qlora), run
   `python -m ggml_tpu_torch.cli.generate --quantized` on it, then load it
   here: the CLI's greedy text, a seeded sampled request twice, a grammar-
   constrained request, perplexity through the planes and dense bf16, and
   the dense model's graphed decode beside its floor; (j) QLoRA fine-tuning
   of GPT-J-6B from the same file: the base as Q4_K planes, finetune_lora
   (rank 8, batch 4 x 128, 8 AdamW steps) through kernel C (exactly 169
   launches a step), finite falling losses, the adapter GGUF round trip, the
   base unchanged, peak memory, a profiled step by class; then a tiny GPT-J
   QLoRA run on the card against the CPU and a checkpoint resume on the card;
   (k) GPT-J-6B (4 of its 28 layers; all 28 with --iquants) from three GGUF
   files written with every 2-D weight in one type, IQ4_XS (E at decode),
   IQ1_M and TQ2_0 (G at every M, 6 launches a layer and one a decode
   token), each loaded as planes (as `generate --quantized` loads it) and
   deleted: the load, greedy requests from prompts of 8 and 100
   (IQ1_M also 1024, through J and G at M = 1024) as graph replays, the
   first again eagerly (the same ids), ms/token beside the plane-byte
   floor, a profiled graphed token by class; (l) Llama-3-8B at its
   published widths (meta-llama/Meta-Llama-3-8B: vocab 128256, E 4096, 32
   layers, 32 heads over 8 kv heads, n_ff 14336, rope base 500000) from a
   4.65 GB GGUF file of Q4_K weights with a Q6_K head and a 128256-entry
   byte-level BPE vocabulary: the load, greedy requests from prompts of 8
   and 100 as graph replays (225 planar launches a decode token: A on 192
   linears, H on 32 ffn_down over planes expanded on every call, F on the
   head), the first again eagerly (the same ids), a seeded sampled request,
   a 1024-token prefill through J and C, flash against plain attention over
   one layer, the generate CLI as a subprocess (its text equals this
   process's greedy text), a profiled prefill and decode by class, then
   tiny Llamas (a Q4_K/Q6_K file, six dense variants, the flash prefill
   under GQA) on the card against the CPU; (m) serving through
   serve.Engine: bench_serve's mix on 4a's GPT-J-6B Q4_K planes (8 slots,
   max_seq 256, bucket 32; 24 requests of 4-30-token prompts x 32 new),
   timed and profiled, with exact B and C launches, each request alone and
   the mix at horizon 1 giving the same ids; then, on 4l's Llama-3-8B, 4
   slots at max_seq 2048 with per-request temperature 0 and 0.8 and a
   1100-token prompt through J at b = 4, exact B, H, F, C and J launches,
   and the HTTP server (cli/server.py) in process answering concurrent
   plain and streamed requests; (n) serving at long prompts and over pages
   on 4a's planes: bench.py's serve_long mix through a chunked engine
   (chunks of 256: C at M = 2048, no head), serve_paged's mix through a
   paged engine with the prefix cache (its stretches as CUDA graph
   replays), exact launches, tok/s, ms a step and the idle share, each
   request alone equal to itself in the mix, published pages bit for bit,
   paged against dense, eviction under page pressure with host snapshots;
   the q8 KV cache on bench_serve's mix (its codes against the plain
   quantizer); then 4l's Llama-3-8B through a paged and a chunked engine at
   4 slots; (o) QLoRA of GPT-J-6B on 4a's planes at bench_qlora's shape
   (rank 16 on its six targets, batch 2 x 512, lr 1e-4), without remat and
   with its dots_with_no_batch_dims_saveable: ms/step, tokens/s, peak
   memory, exact C launches (85 a step, 169 with remat), the first step
   equal across the two; (p) QLoRA of Llama-3-8B from 4l's file (rank 16,
   the default targets, batch 2 x 512) without and with remat: exact C and
   G launches, a profiled step by class, peak memory, the adapter round
   trip, then generate --lora as a subprocess on its widths cut to 2
   layers against this process's merged model; (q) MNIST through opt.fit
   (fc and cnn, validation accuracy > 0.92), bench_mnist's eval µs/image,
   the GGUF round trip; and in (g), GPT-2-large at bench_train's 774m shape
   (batch 4 x 512) without and with remat: K twice a layer under remat;
5. one JSON line listing every kernel, then the result line.

Runs only where torch.cuda.is_available(); it imports nothing of JAX.
"""

from __future__ import annotations

import copy
import dataclasses
import inspect
import json
import os
import re
import subprocess
import sys
import tempfile
import time
import traceback

HBM_BYTES_PER_S = 3.35e12  # H100 SXM (NVIDIA data sheet)
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}
TRAIN = ("flash_attn_fwd_lse", "flash_attn_bwd_dq", "flash_attn_bwd_dkv")  # kernels K, L, M
FLUSH_BYTES = 128 << 20  # written between timed launches: evicts the 50 MB L2
PLAIN = {"q4k_gemv_qact": "_gemv_qact_plain", "q4k_gemv_rows": "_gemv_rows_plain",
         "q4k_matmul": "_matmul_plain", "q8_gemv": "_q8_gemv_plain", "q8_gemv_sb": "_q8_gemv_plain",
         "q8_matmul": "_q8_matmul_plain", "q4_gemv": "_q4_gemv_plain", "q4k_gemv_i8": "_gemv_i8_plain"}
SOURCES = {
    "q4k_gemv_qact": ("ggml_tpu_torch/kernels/csrc/q4k_gemv.cu", "ggml_tpu/kernels/qmatmul.py:523"),
    "q4k_gemv_rows": ("ggml_tpu_torch/kernels/csrc/q4k_gemv.cu", "ggml_tpu/kernels/qmatmul.py:446"),
    "q4k_matmul": ("ggml_tpu_torch/kernels/csrc/q4k_matmul.cu", "ggml_tpu/kernels/qmatmul.py:79"),
    "decode_attn": ("ggml_tpu_torch/kernels/csrc/decode_attn.cu", "ggml_tpu/kernels/decode_attn.py:37"),
    "q8_gemv": ("ggml_tpu_torch/kernels/csrc/q8_gemv.cu", "ggml_tpu/kernels/qmatmul.py:189"),
    "q8_gemv_sb": ("ggml_tpu_torch/kernels/csrc/q8_gemv.cu", "ggml_tpu/kernels/qmatmul.py:645"),
    "q8_matmul": ("ggml_tpu_torch/kernels/csrc/q8_matmul.cu", "ggml_tpu/kernels/qmatmul.py:133"),
    "q4_gemv": ("ggml_tpu_torch/kernels/csrc/q4_gemv.cu", "ggml_tpu/kernels/qmatmul.py:292"),
    "q4k_gemv_i8": ("ggml_tpu_torch/kernels/csrc/q4k_gemv.cu", "ggml_tpu/kernels/qmatmul.py:482"),
    "flash_attn": ("ggml_tpu_torch/kernels/csrc/flash_attn_sm90.cu", "ggml_tpu/kernels/flash_attn.py:30"),
    "flash_split": ("ggml_tpu_torch/kernels/csrc/flash_attn_sm90.cu", "ggml_tpu/kernels/flash_attn.py:30"),
    "flash_mask_ranges": ("ggml_tpu_torch/kernels/csrc/flash_attn_sm90.cu", "ggml_tpu/kernels/flash_attn.py:30"),
    "flash_attn_fwd_lse": ("ggml_tpu_torch/kernels/csrc/flash_attn_sm90.cu", "ggml_tpu/kernels/flash_attn.py:180"),
    "flash_attn_bwd_dq": ("ggml_tpu_torch/kernels/csrc/flash_bwd_sm90.cu", "ggml_tpu/kernels/flash_attn.py:222"),
    "flash_attn_bwd_dkv": ("ggml_tpu_torch/kernels/csrc/flash_bwd_sm90.cu", "ggml_tpu/kernels/flash_attn.py:254"),
}
# NMSE of a kernel against its plain version on the card: the int8 kernels
# differ only in the order of their f32 sums, the matmuls in the order of
# their bf16 products too; the flash kernel rounds p (and, for bf16 q, its
# output) to bf16, and a last-bit difference of a score moves single roundings;
# K, L and M round their bf16 outputs (1e-6; f32 inputs 1e-10, the LSE 1e-12);
# L and M keep p and ds f32 (hi + lo bf16 products), where one bf16 product
# of each would read about 6e-6: their gate, 3e-7, tells the two apart; J's
# helpers are exact (the hi/lo split bit for bit, the mask ranges equal)
GATE = {"q4k_gemv_qact": 1e-6, "q4k_gemv_rows": 1e-6, "q4k_matmul": 1e-5, "decode_attn": 1e-6,
        "q8_gemv": 1e-9, "q8_gemv_sb": 1e-9, "q8_matmul": 1e-8, "q4_gemv": 1e-9, "q4k_gemv_i8": 1e-9,
        "flash_attn": 1e-6, "flash_split": 0.0, "flash_mask_ranges": 0.0,
        "flash_attn_fwd_lse": 1e-6, "flash_attn_bwd_dq": 3e-7, "flash_attn_bwd_dkv": 3e-7}


class SmokeFailure(Exception):
    pass


_START = time.perf_counter()


def stage(title: str):
    """A phase's header, with the seconds since the script started."""
    print(f"== {title} [{time.perf_counter() - _START:.1f}s]", flush=True)


def check(cond: bool, msg: str):
    if not cond:
        raise SmokeFailure(msg)


def errors(ref, got):
    """NMSE and the largest absolute error (a reference of zeros: NMSE 0 if
    got is zero too, else inf)."""
    ref, got = ref.double(), got.double()
    sq = float(((ref - got) ** 2).sum())
    norm = float((ref * ref).sum())
    return (sq / norm if norm else (0.0 if sq == 0 else float("inf")), float((ref - got).abs().max()))


def device_ms(torch, fn, flush, iters: int, by_reads: bool = False) -> float:
    """Device time of one call of fn, with L2 flushed before each call by
    writing `flush` (which leaves L2 full of dirty lines: every line a call
    reads evicts one that is written back), or, by_reads, by summing it
    (clean lines).  A sleep kernel holds the GPU while the host queues every
    call, so host launch overhead is not in the window; the flushes are
    timed alone and subtracted."""
    clear = (lambda: flush.view(torch.float32).sum()) if by_reads else flush.zero_
    fn()
    clear()
    torch.cuda.synchronize()

    def window(body):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(100_000_000)
        start.record()
        for _ in range(iters):
            body()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    both = window(lambda: (clear(), fn()))
    alone = window(clear)
    return max(both - alone, 0.0)


def random_planes(torch, n: int, k: int, npad: int, d_dtype, gen):
    """A compact Q4_K weight with random codes, sub-scales, mins and
    superblock scales on the card."""
    from ggml_tpu_torch.dtypes import GGMLType
    from ggml_tpu_torch.quant.planar import PlanarWeight

    kw = dict(device="cuda", generator=gen)
    sup = (2, k // 512, npad)  # d, dmin: one per 256-element superblock of each half-plane
    return PlanarWeight(
        kind="q4", codes=torch.randint(0, 256, (k // 2, npad), dtype=torch.uint8, **kw),
        scales=torch.randint(0, 64, (2, k // 64, npad), dtype=torch.int8, **kw),
        offsets=torch.randint(0, 64, (k // 32, npad), dtype=torch.int8, **kw),
        group=32, n=n, k=k, orig_type=GGMLType.Q4_K, sb=8,
        supers=((torch.rand(sup, **kw) * 1e-3).to(d_dtype), (torch.rand(sup, **kw) * 1e-3).to(d_dtype)))


def random_q8_planes(torch, n: int, k: int, npad: int, fmt: str, gen):
    """A q8 weight with random planes on the card.  fmt: "q8_0" / "q6_k_synth"
    (bf16 scales per 32 / 16 codes, no offsets, as the synthesis builds
    them), "q5_1" / "q5_k_synth" (f32 / bf16 scales and offsets per 32),
    "q6_k" (compact: int8 sub-scales per 16, f32 d per 256) and "q5_k"
    (compact: 6-bit sub-scale and min codes per 32, f32 d and dmin per 256),
    as repack builds them, and "q6_k_bf16" / "q5_k_bf16" (the same with
    bf16 d and dmin)."""
    from ggml_tpu_torch.dtypes import GGMLType
    from ggml_tpu_torch.quant.planar import PlanarWeight

    kw = dict(device="cuda", generator=gen)
    g = 16 if fmt.startswith("q6_k") else 32
    small = lambda rows, dt: ((torch.rand((rows, npad), **kw) + 0.5) * 1e-3).to(dt)
    codes = lambda lo, hi, rows: torch.randint(lo, hi, (rows, npad), dtype=torch.int8, **kw)
    dd = torch.bfloat16 if fmt.endswith("_bf16") else torch.float32
    if fmt.startswith("q6_k") and fmt != "q6_k_synth":
        return PlanarWeight(kind="q8", codes=codes(-32, 32, k), scales=codes(-128, 128, k // 16), offsets=None,
                            group=16, n=n, k=k, orig_type=GGMLType.Q6_K, sb=16, supers=(small(k // 256, dd), None))
    if fmt.startswith("q5_k") and fmt != "q5_k_synth":
        return PlanarWeight(kind="q8", codes=codes(0, 32, k), scales=codes(0, 64, k // 32),
                            offsets=codes(0, 64, k // 32), group=32, n=n, k=k, orig_type=GGMLType.Q5_K, sb=8,
                            supers=(small(k // 256, dd), small(k // 256, dd)))
    orig, dt, affine = {"q8_0": (GGMLType.Q8_0, torch.bfloat16, False),
                        "q6_k_synth": (GGMLType.Q6_K, torch.bfloat16, False),
                        "q5_1": (GGMLType.Q5_1, torch.float32, True),
                        "q5_k_synth": (GGMLType.Q5_K, torch.bfloat16, True)}[fmt]
    return PlanarWeight(kind="q8", codes=codes(-128, 128, k), scales=small(k // g, dt),
                        offsets=-8 * small(k // g, dt) if affine else None, group=g, n=n, k=k, orig_type=orig)


def iq_planes(torch, np, slabs: dict, n: int, k: int, npad: int, fmt: str):
    """A weight of an IQ* or TQ* type on the card, as repack builds it
    (multiplied-out int8 planes, f32 scales and offsets).  fmt: the type's
    name in lower case ("iq1_m", "tq2_0", ...), "_bf16" at the end for bf16
    scale and offset planes.  A slab of 1024 rows is repacked with the
    port's repack from random blocks once per type and K (cached in slabs),
    then tiled along N on the card and rotated by n columns: the host
    repacks 4 to 17 M weights, not N x K."""
    from ggml_tpu_torch.dtypes import GGMLType, get_type_traits
    from ggml_tpu_torch.quant import reference
    from ggml_tpu_torch.quant.planar import PlanarWeight, repack

    t = GGMLType[fmt.removesuffix("_bf16").upper()]
    if (t, k) not in slabs:
        rng = np.random.default_rng(7 * int(t) + k)
        raw = reference.random_blocks(t, 1024 * k // get_type_traits(t).block_size, rng, scale=1e-3)
        slabs[t, k] = repack(raw, t, (1024, k)).to("cuda")
    base = slabs[t, k]
    dt = torch.bfloat16 if fmt.endswith("_bf16") else torch.float32
    tile = lambda a, dtype=None: None if a is None else torch.roll(
        a.repeat(1, -(-npad // 1024))[:, :npad], n % 1024, dims=-1).to(dtype or a.dtype).contiguous()
    return PlanarWeight(kind="q8", codes=tile(base.codes), scales=tile(base.scales, dt),
                        offsets=tile(base.offsets, dt), group=base.group, n=n, k=k, orig_type=t)


def random_q4_planes(torch, n: int, k: int, npad: int, fmt: str, gen, offsets: bool = True):
    """A q4 weight with multiplied-out random scale and offset planes (or
    none) on the card.  fmt: "q4_0" / "q3_k" (bf16 planes per 32 / 16 codes,
    as the synthesis builds them), "q4_0_f32" (f32 planes per 32, as repack
    builds them)."""
    from ggml_tpu_torch.dtypes import GGMLType
    from ggml_tpu_torch.quant.planar import PlanarWeight

    kw = dict(device="cuda", generator=gen)
    g, dt, orig = {"q4_0": (32, torch.bfloat16, GGMLType.Q4_0), "q3_k": (16, torch.bfloat16, GGMLType.Q3_K),
                   "q4_0_f32": (32, torch.float32, GGMLType.Q4_0)}[fmt]
    small = lambda shape: ((torch.rand(shape, **kw) + 0.5) * 2.5e-3).to(dt)
    return PlanarWeight(kind="q4", codes=torch.randint(0, 256, (k // 2, npad), dtype=torch.uint8, **kw),
                        scales=small((2, k // 2 // g, npad)),
                        offsets=-8 * small((k // g, npad)) if offsets else None, group=g, n=n, k=k, orig_type=orig)


def phase_kernels(torch, F, qmatmul, decode_attn, flash_attn, flush):
    """Each kernel against its plain version at the main path's shapes."""
    import numpy as np

    from ggml_tpu_torch.quant.planar import expand_compact

    gen = torch.Generator(device="cuda")
    gen.manual_seed(1234)
    results = {name: [] for name in SOURCES}
    slabs = {}  # iq_planes' repacked slabs

    def record(name, r, gate=None):
        gate = GATE[name] if gate is None else gate
        results[name].append(r)
        us = lambda v: "not timed" if v is None else f"{v * 1e3:.1f}us"
        print(f"  {name:14s} {r['shape']:44s} nmse={r['nmse']:.2e} max_abs={r['max_abs_err']:.2e} "
              f"kernel={us(r['ms'])} plain={us(r['plain_ms'])} "
              f"library={us(r['library_ms'])} bound={r['bound_ms'] * 1e3:.1f}us ({r['bound_by']})")
        check(r["nmse"] <= gate, f"{name} {r['shape']}: NMSE {r['nmse']:.3e} > {gate:g}")

    def gemv_case(name, m, k, n, npad, d_dtype=torch.bfloat16, fmt=None, time_it=True, offsets=True, x_row=None):
        """x_row: row 3 of x (row 0 at M = 1) all zeros ("zero") or with its
        amax once, in the last 256 rows of K ("late-amax"), among random
        rows; "tile-amax" (kernel A): tile 1 of the low half-plane all zeros
        and the row's amax once, in tile 2 of the high half-plane."""
        if fmt is None:
            pw, label = random_planes(torch, n, k, npad, d_dtype, gen), f"d={str(d_dtype)[6:]}"
        elif fmt in ("q4_0", "q3_k", "q4_0_f32"):
            pw, label = random_q4_planes(torch, n, k, npad, fmt, gen, offsets), fmt + ("" if offsets else " no offsets")
        elif fmt == "q4_k_expanded":  # compact Q4_K planes multiplied out, as planar_matmul hands them to H
            pw, label = expand_compact(random_planes(torch, n, k, npad, torch.float32, gen)), "q4_k expanded (f32)"
        elif fmt.startswith(("iq", "tq")):
            pw = iq_planes(torch, np, slabs, n, k, npad, fmt)
            label = f"{fmt} (G={pw.group}{', offsets' if pw.offsets is not None else ''})"
        else:
            pw, label = random_q8_planes(torch, n, k, npad, fmt, gen), fmt
        x = torch.randn((m, k), device="cuda", generator=gen).to(torch.bfloat16)
        r = min(3, m - 1)
        kt2 = qmatmul._sb_gemv_k_tile(k // 2, 32, 8)
        if x_row == "zero":
            x[r] = 0
        elif x_row == "late-amax":
            x[r] = x[r].clamp(-1, 1)
            x[r, k - 11] = -6.5
        elif x_row == "tile-amax":
            x[r] = x[r].clamp(-1, 1)
            x[r, kt2:2 * kt2] = 0
            x[r, k // 2 + 2 * kt2 + 5] = -6.5
        label += f" x row {r} {x_row}" if x_row else ""
        if name == "q4k_gemv_i8":  # activations that are int8 already
            x = torch.randint(-127, 128, (m, k), dtype=torch.int8, device="cuda", generator=gen)
        wrapper = getattr(qmatmul, name)
        plain = getattr(qmatmul, PLAIN[name])
        plain_fn = (lambda: plain(x, pw, kt2)) if name in ("q4k_gemv_qact", "q4k_gemv_i8") else (lambda: plain(x, pw))
        got = wrapper(x, pw)
        torch.cuda.synchronize()
        nmse, mae = errors(plain_fn(), got)
        check(bool(torch.isfinite(got).all()), f"{name} {label}: values not finite")
        check(x_row != "zero" or not got[r].any(), f"{name} {label}: a row of zeros gives a nonzero y")
        w = qmatmul.planar_dequant(pw, torch.bfloat16)
        plane = pw.plane_bytes()
        moved = plane + x.numel() * x.element_size() + m * npad * 4
        ops = 2 * m * k * npad
        kind = "bf16" if name.endswith("matmul") else "int8"
        t_bytes, t_ops = moved / HBM_BYTES_PER_S * 1e3, ops / PEAK_OPS[kind] * 1e3
        rec = dict(shape=f"M={m} K={k} N={n} Npad={npad} {label}", nmse=nmse, max_abs_err=mae,
                   ms=device_ms(torch, lambda: wrapper(x, pw), flush, 50) if time_it else None,
                   plain_ms=device_ms(torch, plain_fn, flush, 5) if time_it else None,
                   library_ms=device_ms(torch, lambda: torch.matmul(x.to(torch.bfloat16), w), flush, 20)
                   if time_it else None,
                   bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations")
        del w, pw
        record(name, rec)

    gemv_case("q4k_gemv_qact", 1, 4096, 28672, 28672)   # attn_qkvup
    gemv_case("q4k_gemv_qact", 1, 4096, 4096, 4096)     # attn_output
    gemv_case("q4k_gemv_qact", 1, 16384, 4096, 4096)    # ffn_down
    gemv_case("q4k_gemv_qact", 1, 4096, 50400, 51200)   # lm head
    gemv_case("q4k_gemv_qact", 1, 4096, 4096, 4096, torch.float32)  # repacked planes: f32 d/dmin
    gemv_case("q4k_gemv_rows", 8, 4096, 28672, 28672)
    gemv_case("q4k_gemv_rows", 8, 16384, 4096, 4096)
    gemv_case("q4k_matmul", 100, 4096, 28672, 28672)
    gemv_case("q4k_matmul", 100, 16384, 4096, 4096)

    qkvup, attn_out, ffn_down, head = (4096, 28672, 28672), (4096, 4096, 4096), (16384, 4096, 4096), (4096, 50400, 51200)
    for m in (1, 8):  # E: synthesized Q8_0 planes and affine f32 planes, as repack builds Q5_1
        gemv_case("q8_gemv", m, *qkvup, fmt="q8_0")
        gemv_case("q8_gemv", m, *qkvup, fmt="q5_1")
    gemv_case("q8_gemv", 1, *qkvup, fmt="q6_k_synth")   # groups of 16
    gemv_case("q8_gemv", 1, *qkvup, fmt="q5_k_synth")   # bf16 scales and offsets
    for shape in (attn_out, ffn_down, head):
        gemv_case("q8_gemv", 1, *shape, fmt="q8_0")
    for m in (1, 8):  # F: compact planes as repack builds them
        gemv_case("q8_gemv_sb", m, *qkvup, fmt="q6_k")
        gemv_case("q8_gemv_sb", m, *qkvup, fmt="q5_k")
    for shape in (attn_out, ffn_down, head):
        gemv_case("q8_gemv_sb", 1, *shape, fmt="q6_k")
    gemv_case("q8_gemv_sb", 1, *ffn_down, fmt="q5_k")
    gemv_case("q8_matmul", 100, *qkvup, fmt="q8_0")     # G
    gemv_case("q8_matmul", 100, *ffn_down, fmt="q8_0")
    gemv_case("q8_matmul", 100, *qkvup, fmt="q5_k")     # compact planes, offset term
    gemv_case("q8_matmul", 100, *ffn_down, fmt="q6_k")  # compact planes, groups of 16

    for m in (1, 8):  # H: planes as the synthesis builds Q4_0 and Q3_K
        gemv_case("q4_gemv", m, *qkvup, fmt="q4_0")
        gemv_case("q4_gemv", m, *qkvup, fmt="q3_k")
    gemv_case("q4_gemv", 1, *qkvup, fmt="q4_0_f32")     # f32 planes, as repack builds them
    for shape in (attn_out, ffn_down, head):
        gemv_case("q4_gemv", 1, *shape, fmt="q4_0")
    # H at its edges, correctness only: groups of 32 and 16, f32 and bf16
    # planes, offsets and none, M = 1, 7 and 32 (its blocks take 1, 8, 8 x
    # 4 rows of x), the smallest K (K/2 = 8 G), half a slab at the end (K/2 =
    # 384), a K split over a cluster of 8 with Npad = 128 x 3, and x rows of
    # zeros or with their amax once, at the end of K
    for fmt in ("q4_0", "q3_k", "q4_0_f32"):
        for offsets in (True, False):
            for m in (1, 7, 32):
                gemv_case("q4_gemv", m, 256 if fmt == "q3_k" else 512, 300, 384, fmt=fmt, offsets=offsets,
                          time_it=False)
    for m in (1, 7, 32):
        gemv_case("q4_gemv", m, 768, 600, 640, fmt="q3_k", time_it=False)
        gemv_case("q4_gemv", m, 16384, 300, 384, fmt="q4_0_f32", offsets=m != 7, time_it=False)
    for x_row in ("zero", "late-amax"):
        gemv_case("q4_gemv", 7, 4096, 300, 384, fmt="q4_0", time_it=False, x_row=x_row)
        gemv_case("q4_gemv", 7, 16384, 600, 640, fmt="q3_k", time_it=False, x_row=x_row)
    gemv_case("q4k_gemv_i8", 1, *qkvup)                 # int8 x, on no path of planar_matmul
    # A, B, the int8-x entry, E and F at the edges of the same pipeline,
    # correctness only: M = 1, 7 and 32; Npad = 128 x 3 and x 5; a K split
    # over a cluster of 8 (Npad = 384 at K = 16384); the smallest K (A/B:
    # 512, E: 8 G, F: one superblock of 256) and K ending in half a slab (E
    # with groups of 16; F's K is whole superblocks, whole slabs); f32 and
    # bf16 float planes, offsets and none; for A a rank with no rows (K =
    # 4608: 9 slabs over 4), ranges across a tile's edge (K = 12288: 3 slabs
    # a rank, 8 a tile), 4 tiles a half (K = 16384); rows of zeros, rows
    # with their amax once in the last 256 values of K, and for A a zero
    # tile and the amax in the third of four tiles of a half
    for k in (512, 4608, 12288, 16384):
        for d_dtype in (torch.bfloat16, torch.float32):
            gemv_case("q4k_gemv_qact", 1, k, 300, 384, d_dtype, time_it=False)
    for x_row in ("zero", "late-amax", "tile-amax"):
        gemv_case("q4k_gemv_qact", 1, 16384, 600, 640, time_it=False, x_row=x_row)
    for m in (7, 32):
        for k in (512, 16384):
            gemv_case("q4k_gemv_rows", m, k, 300, 384, torch.float32 if m == 7 else torch.bfloat16, time_it=False)
    for x_row in ("zero", "late-amax"):
        gemv_case("q4k_gemv_rows", 7, 16384, 600, 640, time_it=False, x_row=x_row)
    for k in (512, 12288, 16384):
        gemv_case("q4k_gemv_i8", 1, k, 300, 384, time_it=False)
    for m in (1, 7, 32):
        for fmt in ("q8_0", "q5_1", "q6_k_synth", "q5_k_synth"):  # bf16 none, f32 offsets, G 16, bf16 offsets
            g = 16 if fmt == "q6_k_synth" else 32
            for k in (8 * g, 4224 if g == 16 else 4608, 16384):
                gemv_case("q8_gemv", m, k, 300, 384, fmt=fmt, time_it=False)
        for fmt in ("q6_k", "q5_k", "q6_k_bf16", "q5_k_bf16"):
            for k in (256, 16384):
                gemv_case("q8_gemv_sb", m, k, 300, 384, fmt=fmt, time_it=False)
    for x_row in ("zero", "late-amax"):
        gemv_case("q8_gemv", 7, 4224, 600, 640, fmt="q6_k_synth", time_it=False, x_row=x_row)
        gemv_case("q8_gemv_sb", 7, 4096, 600, 640, fmt="q6_k", time_it=False, x_row=x_row)
        gemv_case("q8_gemv_sb", 1, 4096, 600, 640, fmt="q5_k", time_it=False, x_row=x_row)
    # C at QLoRA's M = 512 (batch 4 x 128) over the GGUF file's shapes (q, k,
    # v, attn_output; ffn_up; ffn_down; the head) and the fused qkvup's
    for shape in (attn_out, (4096, 16384, 16384), ffn_down, head, qkvup):
        gemv_case("q4k_matmul", 512, *shape)
    for m in (100, 1024):  # C over multiplied-out planes, and at the long prompt's M
        gemv_case("q4k_matmul", m, *qkvup, fmt="q4_0")
    gemv_case("q4k_matmul", 100, *qkvup, fmt="q3_k")
    gemv_case("q4k_matmul", 1024, *qkvup)               # compact planes
    gemv_case("q8_matmul", 1024, *qkvup, fmt="q8_0")
    for shape in (attn_out, ffn_down):  # the long prompt's other two prefill shapes
        gemv_case("q4k_matmul", 1024, *shape)
        gemv_case("q8_matmul", 1024, *shape, fmt="q8_0")
    # C and G at their edges, correctness only: one row and a ragged row tile
    # (M = 1, 33), a half-plane ending in half a stage (q4, K=192), K % 128 ==
    # 32 (q8, K=4128), groups of 16 (Q3_K, Q6_K), f32 and bf16 planes, and
    # Npad = 128 times an odd number
    for m in (1, 33):
        gemv_case("q4k_matmul", m, 192, 300, 384, fmt="q4_0_f32", time_it=False)
        gemv_case("q4k_matmul", m, 256, 600, 640, fmt="q4_0", time_it=False)
        gemv_case("q4k_matmul", m, 256, 600, 640, fmt="q3_k", time_it=False)
        gemv_case("q4k_matmul", m, 1024, 1100, 1152, d_dtype=torch.float32, time_it=False)
        gemv_case("q8_matmul", m, 4128, 300, 384, fmt="q5_1", time_it=False)
        gemv_case("q8_matmul", m, 4128, 300, 384, fmt="q8_0", time_it=False)
        gemv_case("q8_matmul", m, 512, 600, 640, fmt="q6_k", time_it=False)
        gemv_case("q8_matmul", m, 512, 600, 640, fmt="q5_k_synth", time_it=False)
    # G at the groups of IQ1_M (8, with offsets) and TQ2_0 (256), over planes
    # repacked from random blocks: decode's M = 1 (these groups take G at
    # every M), 8, prefill's 100 and the long prompt's 1024 on attn_qkvup;
    # M = 1 on ffn_down and attn_output, whose 32 tiles split K over 4
    # blocks; then E over IQ2_XS (groups of 16) and IQ1_S (groups of 32,
    # offsets) planes at M = 1 and 8
    for fmt in ("iq1_m", "tq2_0"):
        for m in (1, 8, 100, 1024):
            gemv_case("q8_matmul", m, *qkvup, fmt=fmt)
        gemv_case("q8_matmul", 1, *ffn_down, fmt=fmt)
        gemv_case("q8_matmul", 1, *attn_out, fmt=fmt)
    for fmt in ("iq2_xs", "iq1_s"):
        for m in (1, 8):
            gemv_case("q8_gemv", m, *qkvup, fmt=fmt)
    # and at their edges, correctness only: one row and a ragged row tile,
    # f32 and bf16 planes, Npad = 128 x 5, a K of two stages
    for m in (1, 33):
        for fmt in ("iq1_m", "tq2_0", "iq1_m_bf16", "tq2_0_bf16"):
            gemv_case("q8_matmul", m, 256, 600, 640, fmt=fmt, time_it=False)
    slabs.clear()
    # Llama-3-8B from a Q4_K file with a Q6_K head (phase 4l), the shapes
    # GPT-J never reached: A on k and v (N = 1024) and ffn_gate/ffn_up (N =
    # 14336), B on those at prompt 8; H on ffn_down (K = 14336: no compact
    # tile, so the planes are expanded to f32 first) at decode and prompt 8;
    # F on the 128256-row head; C at K = 14336 (ffn_down) and N = 14336 at
    # prompt 100 and the 1024-token prefill; G on the head there, and at K = 14336
    l_kv, l_ffn, l_down, l_head = (4096, 1024, 1024), (4096, 14336, 14336), (14336, 4096, 4096), (4096, 128256, 129024)
    gemv_case("q4k_gemv_qact", 1, *l_kv, d_dtype=torch.float32)
    gemv_case("q4k_gemv_qact", 1, *l_ffn, d_dtype=torch.float32)
    gemv_case("q4k_gemv_rows", 8, *l_ffn, d_dtype=torch.float32)
    for m in (1, 8):
        gemv_case("q4_gemv", m, *l_down, fmt="q4_k_expanded")
        gemv_case("q8_gemv_sb", m, *l_head, fmt="q6_k")
    for m in (100, 1024):
        gemv_case("q4k_matmul", m, *l_down, d_dtype=torch.float32)
        gemv_case("q4k_matmul", m, *l_ffn, d_dtype=torch.float32)
        gemv_case("q8_matmul", m, *l_head, fmt="q6_k")
    gemv_case("q8_matmul", 100, *l_down, fmt="q6_k")
    # serving (phase 4m): GPT-J's engine step at M = 8 also takes B on
    # attn_output and the head, its (8, 32) admission C at M = 256; Llama's
    # step at M = 4 takes B, H and F, its (4, 1120) admission C at M = 4480
    gemv_case("q4k_gemv_rows", 8, 4096, 4096, 4096)
    gemv_case("q4k_gemv_rows", 8, 4096, 50400, 51200)
    gemv_case("q4k_matmul", 256, 4096, 28672, 28672)
    gemv_case("q4k_matmul", 256, 16384, 4096, 4096)
    gemv_case("q4k_gemv_rows", 4, *l_ffn, d_dtype=torch.float32)
    gemv_case("q4_gemv", 4, *l_down, fmt="q4_k_expanded")
    gemv_case("q8_gemv_sb", 4, *l_head, fmt="q6_k")
    gemv_case("q4k_matmul", 4480, *l_ffn, d_dtype=torch.float32)
    # chunked serving (phase 4n): GPT-J's (8, 256) chunk dispatch takes C at M = 2048
    for shape in (qkvup, attn_out, ffn_down):
        gemv_case("q4k_matmul", 2048, *shape)

    def flash_case(b, h, h_kv, nq, nkv, d, types, causal=True, max_bias=0.0, softcap=0.0, time_it=True,
                   dead_row=None):
        """J against its plain version.  types: "bfloat16" or "float32" for
        q, k and v alike, "mixed" for f32 q and k with a bf16 v (the bf16
        model's prefill).  dead_row: a row of the mask set to -1e30
        everywhere (at a ragged n_kv with ALiBi, J folds in the JAX
        wrapper's kv padding, so most heads keep such a row live).  The bound counts the unmasked (q, k) pairs only (the
        causal half): 4*h*d operations a pair at the rate of the inputs' type;
        for "mixed" the f32 q . k costs three bf16 products, so 8*h*d a pair at
        the bf16 rate.  The library call takes one type, so "mixed" is timed
        against SDPA on q and k rounded to bf16: it computes less.  q, k and v
        are head views of (b, n, h, d) tensors, as the model hands them over.
        The mixed causal cases that are timed also hold J's split helper
        against its plain version, bit for bit (the mask ranges: ranges_case)."""
        qk_type = torch.float32 if types == "mixed" else getattr(torch, types)
        v_type = torch.bfloat16 if types == "mixed" else qk_type
        mk = lambda dt, b_, n_, h_: torch.randn((b_, n_, h_, d), device="cuda", generator=gen).to(dt).transpose(1, 2)
        q, k, v = mk(qk_type, b, nq, h), mk(qk_type, b, nkv, h_kv), mk(v_type, b, nkv, h_kv)
        rows = torch.arange(nq, device="cuda")[:, None] + (nkv - nq)
        mask = torch.where(torch.arange(nkv, device="cuda")[None, :] <= rows, 0.0, -1e30) if causal else None
        if dead_row is not None:
            mask[dead_row] = -1e30
        scale = d ** -0.5
        call = lambda: flash_attn.flash_attention(q, k, v, mask=mask, scale=scale, max_bias=max_bias,
                                                  logit_softcap=softcap)
        slopes = torch.from_numpy(flash_attn.alibi_slopes(h, max_bias)).cuda()
        plain_fn = lambda: flash_attn._flash_attention_plain(
            q, k, v, mask, slopes, scale / softcap if softcap else scale, softcap)
        got = call()
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), "flash_attn: output not finite")
        nmse, mae = errors(plain_fn(), got)
        pairs = int((mask > -5e29).sum()) if causal else nq * nkv
        moved = ((q.numel() + k.numel() + b * nq * h * d) * q.element_size() + v.numel() * v.element_size()
                 + (nq * nkv * 4 if causal else 0))
        ops = (8 if types == "mixed" else 4) * b * h * d * pairs
        t_bytes = moved / HBM_BYTES_PER_S * 1e3
        t_ops = ops / PEAK_OPS["f32" if types == "float32" else "bf16"] * 1e3
        lib_q, lib_k, lib_v = (q.to(v_type).contiguous(), k.to(v_type).repeat_interleave(h // h_kv, 1).contiguous(),
                               v.repeat_interleave(h // h_kv, 1).contiguous())
        lib = lambda: F.scaled_dot_product_attention(lib_q, lib_k, lib_v, is_causal=causal and nq == nkv,
                                                     scale=scale)
        plain_lib = max_bias == 0.0 and softcap == 0.0 and (not causal or nq == nkv)  # what one SDPA call computes
        rec = dict(shape=f"b={b} h={h} h_kv={h_kv} nq={nq} nkv={nkv} d={d} "
                         f"{'f32 q/k, bf16 v' if types == 'mixed' else types}"
                         f"{' causal' if causal else ''}{' alibi' if max_bias else ''}{' softcap' if softcap else ''}"
                         f"{f' row {dead_row} masked everywhere' if dead_row is not None else ''}",
                   nmse=nmse, max_abs_err=mae,
                   ms=device_ms(torch, call, flush, 20) if time_it else None,
                   plain_ms=device_ms(torch, plain_fn, flush, 3) if time_it else None,
                   library_ms=device_ms(torch, lib, flush, 20) if time_it and plain_lib else None,
                   bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations")
        record("flash_attn", rec, 1e-9 if types == "float32" else GATE["flash_attn"])
        if not (time_it and causal and types == "mixed"):
            return
        label = f"b={b} h={h} nq={nq} nkv={nkv} d={d}"
        split = lambda: flash_attn.split_hi_lo(k)
        split_plain = lambda: flash_attn._split_hi_lo_plain(k)
        check(torch.equal(split(), split_plain()), f"flash_split {label}: not equal to its plain version")
        t_split = k.numel() * 8 / HBM_BYTES_PER_S * 1e3  # f32 in, two bf16 planes out
        record("flash_split", dict(shape=f"k f32, {label}", nmse=0.0, max_abs_err=0.0,
                                   ms=device_ms(torch, split, flush, 20), plain_ms=device_ms(torch, split_plain, flush, 5),
                                   library_ms=None, bound_ms=t_split, bound_by="bytes"))

    def ranges_case(nq, nkv, kind, time_it=False):
        """J's helper flash_mask_ranges against its plain version, exactly.
        kind: "causal" (the models' mask), "random" (normal values: every
        tile has its own min and max), "misaligned" (random, the mask 4
        bytes past a 16-byte boundary: the scalar path, as any nkv % 4 !=
        0).  Bound: the mask read once, the ranges written once.  Library:
        amin and amax over the tile view (nq/64, 64, nkv/64, 64), two calls
        (nq and nkv multiples of 64)."""
        if kind == "causal":
            mask = torch.where(torch.arange(nkv, device="cuda")[None, :] <= torch.arange(nq, device="cuda")[:, None],
                               0.0, -1e30)
        elif kind == "random":
            mask = torch.randn((nq, nkv), device="cuda", generator=gen)
        else:
            mask = torch.randn(nq * nkv + 1, device="cuda", generator=gen)[1:].view(nq, nkv)
        call = lambda: flash_attn.mask_ranges(mask)
        plain_fn = lambda: flash_attn._mask_ranges_plain(mask)
        check(torch.equal(call(), plain_fn()), f"flash_mask_ranges ({nq}, {nkv}) {kind}: not equal to its plain version")
        lib = None
        if time_it and nq % 64 == 0 and nkv % 64 == 0:
            tiles = mask.view(nq // 64, 64, nkv // 64, 64)
            lib = device_ms(torch, lambda: (tiles.amin(dim=(1, 3)), tiles.amax(dim=(1, 3))), flush, 20)
        n_out = 2 * -(-nq // 64) * -(-nkv // 64)
        record("flash_mask_ranges", dict(shape=f"{kind} mask ({nq}, {nkv})", nmse=0.0, max_abs_err=0.0,
                                         ms=device_ms(torch, call, flush, 20) if time_it else None,
                                         plain_ms=device_ms(torch, plain_fn, flush, 5) if time_it else None,
                                         library_ms=lib, bound_ms=(mask.numel() + n_out) * 4 / HBM_BYTES_PER_S * 1e3,
                                         bound_by="bytes"))

    for types in ("mixed", "bfloat16"):
        flash_case(1, 16, 16, 1024, 1024, 256, types)   # the 1024-token prefill of GPT-J (a bf16 model: mixed)
        flash_case(1, 16, 16, 2048, 2048, 256, types)   # the full context
        flash_case(1, 4, 4, 100, 100, 128, types)       # the tiny model's heads, ragged tiles
    flash_case(1, 32, 8, 1024, 1024, 128, "mixed")      # Llama-3-8B's 1024-token prefill: GQA 32/8, d = 128
    flash_case(4, 32, 8, 1120, 1120, 128, "mixed")      # serving's (4, 1120) admission of Llama-3-8B (phase 4m)
    # the mask ranges at the long prefill's shape (and the full context), then
    # exactness only at ragged shapes: ragged tiles on the 16-byte path (1000,
    # 64 x 80), and the scalar path (nkv % 4 != 0, a misaligned mask)
    ranges_case(1024, 1024, "causal", time_it=True)
    ranges_case(2048, 2048, "causal", time_it=True)
    for nq, nkv, kind in ((1000, 1000, "causal"), (1000, 1000, "random"), (64, 80, "random"), (37, 53, "random"),
                          (130, 1001, "random"), (200, 200, "misaligned")):
        ranges_case(nq, nkv, kind)
    # correctness only: GQA, ALiBi, softcap, ragged lengths, no mask
    flash_case(2, 8, 2, 37, 53, 64, "float32", max_bias=8.0, softcap=30.0, time_it=False)
    flash_case(1, 4, 4, 37, 53, 64, "float32", causal=False, time_it=False)
    for types in ("mixed", "bfloat16"):
        flash_case(2, 8, 2, 100, 200, 64, types, max_bias=8.0, softcap=30.0, time_it=False)
    # a row masked everywhere at a ragged n_kv with ALiBi slopes below 0.5
    for types in ("float32", "mixed", "bfloat16"):
        flash_case(1, 16, 16, 8, 40, 64, types, max_bias=8.0, time_it=False, dead_row=3)

    def train_case(b, h, h_kv, nq, nkv, d, dtype, mask_kind="causal", max_bias=0.0, time_it=True):
        """K, L and M against their plain versions on the same inputs (L and
        M are handed K's lse and the delta of K's output; all three the
        mask's tile ranges, computed once, as the autograd Function does).
        mask_kind: "causal" (-1e30 above the diagonal, offset by nkv - nq),
        None, "dead-inf" / "dead-1e30" (causal, and row 7 all -inf / all
        -1e30), "dead-both" (row 7 all -1e30, row 9 all -inf; at a ragged n_kv
        K folds in the JAX wrapper's padding, so neither row is dead there),
        "edge-inf" / "edge-1e30" (causal, rows 63 and 64, either side of a
        tile edge, all -inf / all -1e30).  The LSE is held to NMSE
        1e-12 on the live rows and to equality on the rows masked everywhere
        (about -1e30, or +1e30 where dead).  Bounds: each input read
        once, each output written once; operations over the unmasked pairs, 2d
        per product and pair (K: 2 products, L: 3, M: 4) at the inputs' rate.
        Library: SDPA's forward (K) and backward (L + M, the time stands in
        both rows) on the same bf16 tensors, causal; none for other masks."""
        dt = getattr(torch, dtype)
        mk = lambda *shape: torch.randn(shape, device="cuda", generator=gen).to(dt)
        q, k, v, do = mk(b, h, nq, d), mk(b, h_kv, nkv, d), mk(b, h_kv, nkv, d), mk(b, nq, h, d)
        mask = None
        if mask_kind is not None:
            rows = torch.arange(nq, device="cuda")[:, None] + (nkv - nq)
            mask = torch.where(torch.arange(nkv, device="cuda")[None, :] <= rows, 0.0, -1e30)
            if mask_kind in ("dead-inf", "dead-1e30"):
                mask[7] = float("-inf") if mask_kind == "dead-inf" else -1e30
            elif mask_kind == "dead-both":
                mask[7], mask[9] = -1e30, float("-inf")
            elif mask_kind in ("edge-inf", "edge-1e30"):
                mask[63:65] = float("-inf") if mask_kind == "edge-inf" else -1e30
        scale = d ** -0.5
        slopes = flash_attn._slopes_on(h, max_bias, q.device)
        ranges = None if mask is None else flash_attn.mask_ranges(mask)
        fwd = lambda: flash_attn.flash_attention_fwd_lse(q, k, v, mask, scale, max_bias, ranges=ranges)
        o, lse = fwd()
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
        args = (q, k, v, mask, scale, max_bias, do, lse, delta)
        pargs = (q, k, v, mask, slopes, scale, do, lse, delta)
        dq = flash_attn.flash_attention_bwd_dq(*args, ranges=ranges)
        dk, dv = flash_attn.flash_attention_bwd_dkv(*args, ranges=ranges)
        torch.cuda.synchronize()
        check(all(bool(torch.isfinite(t).all()) for t in (o, dq, dk, dv)), f"K/L/M {dtype}: output not finite")
        po, plse = flash_attn._fa_forward_lse_plain(q, k, v, mask, slopes, scale)
        live = plse.abs() < 1e20  # the other rows sit at about -1e30 (masked everywhere) or +1e30 (dead)
        check(torch.equal(lse[~live], plse[~live]), f"K {dtype} {mask_kind}: rows masked everywhere differ from "
              "the plain version")
        pdq = flash_attn._fa_bwd_dq_plain(*pargs)
        pdk, pdv = flash_attn._fa_bwd_dkv_plain(*pargs)
        lse_nmse, _ = errors(plse[live], lse[live])
        check(lse_nmse <= 1e-12, f"K {dtype} {mask_kind}: LSE NMSE {lse_nmse:.3e} > 1e-12")
        pairs = b * h * (int((mask > -5e29).sum()) if mask is not None else nq * nkv)
        el = q.element_size()
        rate = PEAK_OPS["f32" if dtype == "float32" else "bf16"]
        io = {"flash_attn_fwd_lse": (2 * q.numel() + k.numel() + v.numel()) * el + b * h * nq * 4,
              "flash_attn_bwd_dq": (2 * q.numel() + k.numel() + v.numel() + do.numel()) * el + 2 * b * h * nq * 4,
              "flash_attn_bwd_dkv": (q.numel() + 2 * k.numel() + 2 * v.numel() + do.numel()) * el + 2 * b * h * nq * 4}
        products = {"flash_attn_fwd_lse": 2, "flash_attn_bwd_dq": 3, "flash_attn_bwd_dkv": 4}
        lib_fwd = lib_bwd = None
        if time_it and mask_kind == "causal" and dtype == "bfloat16" and h == h_kv and nq == nkv:
            lq, lk, lv = (t.detach().clone().requires_grad_() for t in (q, k, v))
            lo = F.scaled_dot_product_attention(lq, lk, lv, is_causal=True, scale=scale)
            ldo = do.transpose(1, 2).contiguous()
            lib_fwd = device_ms(torch, lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True, scale=scale),
                                flush, 20)
            lib_bwd = device_ms(torch, lambda: torch.autograd.grad(lo, (lq, lk, lv), ldo, retain_graph=True), flush, 20)
        cases = (("flash_attn_fwd_lse", fwd, lambda: flash_attn._fa_forward_lse_plain(q, k, v, mask, slopes, scale),
                  [(po, o)], lib_fwd),
                 ("flash_attn_bwd_dq", lambda: flash_attn.flash_attention_bwd_dq(*args, ranges=ranges),
                  lambda: flash_attn._fa_bwd_dq_plain(*pargs), [(pdq, dq)], lib_bwd),
                 ("flash_attn_bwd_dkv", lambda: flash_attn.flash_attention_bwd_dkv(*args, ranges=ranges),
                  lambda: flash_attn._fa_bwd_dkv_plain(*pargs), [(pdk, dk), (pdv, dv)], lib_bwd))
        shape = (f"b={b} h={h} h_kv={h_kv} nq={nq} nkv={nkv} d={d} {dtype} {mask_kind or 'no mask'}"
                 f"{' alibi' if max_bias else ''}")
        if time_it and dtype == "bfloat16":
            # the control: p and ds rounded to bf16 for one bf16 product each
            # must read above L's and M's gate, or the gate cannot see that loss
            p, ds, qf, kf, dof = flash_attn._p_ds_plain(*pargs)
            r = lambda t: t.to(dt).float()
            one = max(errors(pdq, torch.matmul(r(ds), kf).to(dt))[0],
                      errors(pdk, torch.matmul(r(ds).transpose(-1, -2), qf).to(dt))[0],
                      errors(pdv, torch.matmul(r(p).transpose(-1, -2), dof).to(dt))[0])
            del p, ds, qf, kf, dof
            print(f"  L/M control, p and ds as one bf16 product each: worst NMSE {one:.2e} "
                  f"(gate {GATE['flash_attn_bwd_dq']:g})")
            check(one > GATE["flash_attn_bwd_dq"], f"L/M gate {GATE['flash_attn_bwd_dq']:g} does not catch "
                  f"one-product rounding (NMSE {one:.2e})")
        for name, call, plain_fn, pairs_out, lib in cases:
            errs = [errors(ref, got) for ref, got in pairs_out]
            t_bytes = (io[name] + (nq * nkv * 4 if mask is not None else 0)) / HBM_BYTES_PER_S * 1e3
            t_ops = products[name] * 2 * d * pairs / rate * 1e3
            rec = dict(shape=shape, nmse=max(e[0] for e in errs), max_abs_err=max(e[1] for e in errs),
                       lse_nmse=lse_nmse if name == "flash_attn_fwd_lse" else None,
                       ms=device_ms(torch, call, flush, 20) if time_it else None,
                       plain_ms=device_ms(torch, plain_fn, flush, 3) if time_it else None, library_ms=lib,
                       bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations")
            record(name, rec, 1e-10 if dtype == "float32" else GATE[name])

    train_case(8, 16, 16, 512, 512, 64, "bfloat16")    # GPT-2-medium's training step, one layer
    train_case(4, 16, 16, 1024, 1024, 64, "bfloat16")  # GPT-2's context
    # correctness only: GQA, ALiBi, ragged lengths, no mask, dead rows (the
    # bf16 -1e30 row makes K walk its block again without skipping)
    for dtype in ("float32", "bfloat16"):
        train_case(2, 8, 2, 64, 128, 64, dtype, time_it=False)
        train_case(1, 4, 4, 64, 64, 64, dtype, max_bias=8.0, time_it=False)
        train_case(1, 4, 4, 50, 96, 64, dtype, time_it=False)
        train_case(1, 4, 4, 64, 64, 64, dtype, mask_kind=None, time_it=False)
        train_case(1, 2, 2, 128, 128, 64, dtype, mask_kind="dead-inf", time_it=False)
    train_case(1, 2, 2, 64, 64, 64, "float32", mask_kind="dead-1e30", time_it=False)
    train_case(1, 2, 2, 128, 128, 64, "bfloat16", mask_kind="dead-1e30", time_it=False)
    # both kinds at a ragged n_kv, where K folds in the JAX wrapper's padding
    for dtype in ("float32", "bfloat16"):
        train_case(1, 4, 4, 64, 100, 64, dtype, mask_kind="dead-both", time_it=False)
    train_case(1, 4, 4, 64, 100, 64, "float32", mask_kind="dead-both", max_bias=8.0, time_it=False)
    # the edges of K's and M's tile walks in bf16: head dims 128 and 72 (zero
    # columns up to 128, M's 32-row q tiles), a causal offset with neither
    # length a multiple of 64, GQA 16/4, rows masked everywhere on both
    # sides of a tile edge (with ALiBi too)
    train_case(1, 4, 4, 128, 128, 128, "bfloat16", time_it=False)
    train_case(1, 4, 4, 100, 164, 72, "bfloat16", time_it=False)
    train_case(1, 4, 4, 100, 164, 64, "bfloat16", time_it=False)
    train_case(2, 16, 4, 128, 128, 64, "bfloat16", time_it=False)
    for kind in ("edge-1e30", "edge-inf"):
        train_case(1, 2, 2, 128, 128, 64, "bfloat16", mask_kind=kind, time_it=False)
    train_case(1, 4, 4, 200, 200, 128, "bfloat16", mask_kind="edge-1e30", max_bias=8.0, time_it=False)

    # D: the chunk edges of the split kernel (64 keys), the end of GPT-J's
    # window, GQA, a window above the old kernel's 48 KB cap; the main shape last
    for hq, hkv, d, s, pos in ((16, 16, 256, 256, 0), (16, 16, 256, 256, 100), (16, 16, 256, 256, 255),
                               (16, 16, 256, 2048, 63), (16, 16, 256, 2048, 64), (16, 16, 256, 2048, 127),
                               (16, 16, 256, 2048, 1087), (16, 4, 128, 2048, 2047), (16, 16, 256, 8192, 8191),
                               (16, 16, 256, 2048, 2047)):
        q = torch.randn((1, hq, 1, d), device="cuda", generator=gen)
        kn, vn = (torch.randn((1, hkv, 1, d), device="cuda", generator=gen).to(torch.bfloat16) for _ in range(2))
        kc, vc = (torch.randn((1, hkv, s, d), device="cuda", generator=gen).to(torch.bfloat16) for _ in range(2))
        p = torch.tensor(pos, dtype=torch.int32, device="cuda")
        scale = d ** -0.5
        call = lambda: decode_attn.fused_decode_attention(q, kn, vn, kc, vc, p, scale=scale)
        plain_fn = lambda: decode_attn._decode_attention_plain(q, kn, vn, kc, vc, pos, scale)
        got = call()
        torch.cuda.synchronize()
        nmse, mae = errors(plain_fn(), got)
        qb, kw_, vw_ = q.to(torch.bfloat16), kc[:, :, : pos + 1], vc[:, :, : pos + 1]
        if hq != hkv:  # SDPA's own GQA where this torch has it, else the kv heads repeated before the timing
            try:
                F.scaled_dot_product_attention(qb, kw_, vw_, scale=scale, enable_gqa=True)
                lib = lambda: F.scaled_dot_product_attention(qb, kw_, vw_, scale=scale, enable_gqa=True)
            except TypeError:
                kw_, vw_ = kw_.repeat_interleave(hq // hkv, 1), vw_.repeat_interleave(hq // hkv, 1)
                lib = lambda: F.scaled_dot_product_attention(qb, kw_, vw_, scale=scale)
        else:
            lib = lambda: F.scaled_dot_product_attention(qb, kw_, vw_, scale=scale)
        moved = q.numel() * 4 + 2 * hkv * d * 2 + 2 * hkv * (pos + 1) * d * 2 + hq * d * 4
        ops = 4 * hq * (pos + 1) * d
        t_bytes, t_ops = moved / HBM_BYTES_PER_S * 1e3, ops / PEAK_OPS["f32"] * 1e3
        rec = dict(shape=f"hq={hq} hkv={hkv} d={d} S={s} pos={pos}", nmse=nmse, max_abs_err=mae,
                   ms=device_ms(torch, call, flush, 50), plain_ms=device_ms(torch, plain_fn, flush, 5),
                   library_ms=device_ms(torch, lib, flush, 20),
                   bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations")
        record("decode_attn", rec)

    return results


def launch_counts() -> dict:
    from ggml_tpu_torch.models.common import launch_tables

    return {k: v for table in launch_tables() for k, v in table.items()}


def reset_launches():
    from ggml_tpu_torch.models.common import launch_tables

    for table in launch_tables():
        for k in table:
            table[k] = 0


def q6k_planes_like(torch, np, params: dict) -> dict:
    """`params` with every planar weight replaced by a compact Q6_K weight of
    the same shape, built with the port's own repack from random Q6_K blocks.
    Columns are independent in the planar layout, so a slab of 1024 rows is
    repacked once per K on the host, tiled along N on the card and rotated by
    another number of columns for every weight: each gets planes of its own
    in device memory, and the host repacks 21 M weights, not 6 G.  (The pad
    columns of the lm head hold tiled codes instead of zeros; planar_matmul
    cuts them off.)"""
    from ggml_tpu_torch.dtypes import GGMLType
    from ggml_tpu_torch.quant import reference
    from ggml_tpu_torch.quant.planar import PlanarWeight, repack

    rng = np.random.default_rng(0)
    slab_rows, slabs, out = 1024, {}, {}
    for i, (name, v) in enumerate(params.items()):
        if not isinstance(v, PlanarWeight):
            out[name] = v
            continue
        if v.k not in slabs:
            raw = reference.random_blocks(GGMLType.Q6_K, slab_rows * v.k // 256, rng, scale=1e-4)
            slabs[v.k] = repack(raw, GGMLType.Q6_K, (slab_rows, v.k)).to("cuda")
        base = slabs[v.k]
        npad = -(-v.n // slab_rows) * slab_rows  # what repack pads a wide weight to
        tile = lambda t: torch.roll(t.repeat(1, npad // slab_rows), 128 * (i % 8) + 4 * (i // 8), dims=-1)
        out[name] = PlanarWeight(kind="q8", codes=tile(base.codes), scales=tile(base.scales), offsets=None,
                                 group=base.group, n=v.n, k=v.k, orig_type=GGMLType.Q6_K,
                                 supers=(tile(base.d), None), sb=base.sb)
    return out


def phase_gptj(torch, np, label: str, params: dict, kernels: dict, prompts, profile: bool, max_seq: int = 256,
               long_decode_profile: int = 0, sampled: bool = False, cfg=None):
    """GPT-J-6B at published widths (cfg, the whole model by default) over
    `params`: one greedy request of 64
    tokens per prompt length, decoded as CUDA graph replays (the default on
    the card), every launch counted (a replay adds its captured step's
    launches); the graphs are captured while each prompt length is warmed up,
    once per model and cache type, and no request captures again.  Then the
    first request decodes again eagerly (graph=False): the same ids, eager
    and graphed ms/token side by side.  With long_decode_profile, profiles of
    decode steps after a prompt of that length; with sampled, a seeded
    sampled request twice (equal ids, eager and graphed alike) and with
    top_k = 1 (the greedy ids).  kernels names the wrapper each step must go
    through: "decode" (M=1), "rows" (2..32-token prefill), "matmul" (longer
    prefill).  A prompt of flash_min_seq (1024) tokens or more must also go
    through the flash kernel and its split once per layer, and the mask
    ranges once per prefill."""
    from ggml_tpu_torch.models import gptj
    from ggml_tpu_torch.quant.planar import PlanarWeight

    cfg = cfg or gptj.random_config("6b")
    # the planes a decode token reads (a GGUF file's token embedding also
    # has planes, beside its dense copy for the row gather)
    plane_bytes = sum(v.plane_bytes() for k, v in params.items()
                      if isinstance(v, PlanarWeight) and k != "token_embd.weight")
    print(f"  {label}: {plane_bytes / 1e9:.3f} GB of planes read per decode token, bound at "
          f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s: {plane_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms/token")
    model = gptj.GPTJ(params, cfg, max_seq=max_seq, device="cuda")
    for t in prompts:  # warm-up of each path: first-use allocations, library handles, the decode graph
        model.generate(np.arange(t)[None], 4)
    torch.cuda.synchronize()
    captures = lambda: sum(g.captures for g in model.decode_graphs.values())
    captured = captures()

    n_gen = 64
    # quantized linears a layer: 3 for the synthesized fused qkvup, 6 from a
    # GGUF file (q, k, v, attn_output, ffn_up, ffn_down apart)
    per_layer = sum(1 for k, v in params.items() if k.startswith("blk.0.") and isinstance(v, PlanarWeight))
    layers = cfg.n_layer
    rng = np.random.default_rng(0)
    reset_launches()
    requests = []
    for t in prompts:
        before = launch_counts()
        prompt = rng.integers(0, cfg.n_vocab, (1, t))
        first, ids, t0, t1, t2, finite, event_ms = greedy_request(torch, model, prompt, n_gen - 1, graph=True)
        after = launch_counts()
        delta = {k: after[k] - before[k] for k in after}
        steps = n_gen - 1 + (1 if t == 1 else 0)  # a 1-token prompt is a decode step too
        want = {k: 0 for k in delta}
        want[kernels["decode"]] = (per_layer * layers + 1) * steps
        want["decode_attn"] = layers * steps
        if t > 1:
            want[kernels["rows" if t <= 32 else "matmul"]] += per_layer * layers + 1
        if t >= cfg.flash_min_seq:  # J and its split per layer (a bf16 model hands over f32 q and k), the ranges once
            want["flash_attn"] = want["flash_split"] = layers
            want["flash_mask_ranges"] = 1
        toks = [first] + ids
        check(finite, f"{label}, prompt {t}: prefill logits not finite")
        check(len(toks) == n_gen and all(0 <= x < cfg.n_vocab for x in toks), f"{label}, prompt {t}: tokens {toks}")
        check(delta == want, f"{label}, prompt {t}: launches {delta}, want {want}")
        dec_ms = (t2 - t1) * 1e3 / (n_gen - 1)
        req = dict(model=label, prompt=t, prefill_ms=(t1 - t0) * 1e3, decode_ms_per_token=dec_ms,
                   decode_event_ms_per_token=event_ms,
                   decode_tok_per_s=1e3 / dec_ms, plane_gb_per_s=plane_bytes / (dec_ms * 1e-3) / 1e9,
                   launches=delta, first_tokens=toks[:8], prompt_tokens=prompt, ids=toks)
        requests.append(req)
        print(f"  request prompt={t:4d}: prefill {req['prefill_ms']:.1f} ms, decode "
              f"{dec_ms:.2f} ms/token graphed ({event_ms:.2f} between CUDA events; {req['decode_tok_per_s']:.1f} tok/s, "
              f"{req['plane_gb_per_s']:.0f} GB/s of planes), launches {delta}")
    counts = launch_counts()
    check(captures() == captured == 1, f"{label}: {captured} decode graphs captured while warming up, "
          f"{captures()} after the requests; want 1 and no capture per request")
    long_prompt = max(prompts) >= cfg.flash_min_seq
    roles = {"decode"} | {"rows" if t <= 32 else "matmul" for t in prompts if t > 1}
    flash = ["flash_attn", "flash_split", "flash_mask_ranges"] if long_prompt else []
    for name in {*(kernels[r] for r in roles), "decode_attn", *flash}:
        check(counts[name] > 0, f"{label}: {name} was never launched on its main path")

    # the first request again, eagerly: the same kernels in the same order
    req = requests[0]
    _, ids, _, t1, t2, _, _ = greedy_request(torch, model, req["prompt_tokens"], n_gen - 1, graph=False)
    eager_ms = (t2 - t1) * 1e3 / (n_gen - 1)
    check(ids == req["ids"][1:], f"{label}, prompt {req['prompt']}: eager ids {ids[:8]}... differ from the "
          f"graphed {req['ids'][1:9]}...")
    req["eager_decode_ms_per_token"] = eager_ms
    print(f"  prompt={req['prompt']}: decode eager {eager_ms:.2f} / graphed {req['decode_ms_per_token']:.2f} "
          f"ms/token, the same {len(ids)} ids; decode graphs captured: {captures()}")
    sampling = sampled_requests(torch, model, req, n_gen) if sampled else None
    for r in requests:
        del r["prompt_tokens"], r["ids"]
    trace = profile_decode(torch, np, model) if profile else None
    graphed = profile_decode_graphed(torch, np, model) if profile else None
    prefill_trace = profile_prefill(torch, np, model, max(prompts)) if profile and long_prompt else None
    long_trace = profile_decode(torch, np, model, prompt=long_decode_profile) if long_decode_profile else None
    long_graphed = profile_decode_graphed(torch, np, model, prompt=long_decode_profile) if long_decode_profile else None
    flash_nmse = flash_against_plain_attention(torch, np, model, max(prompts)) if long_prompt else None
    return dict(counts=counts, requests=requests, plane_bytes=plane_bytes, decode_graph_captures=captures(),
                sampled=sampling, decode_trace=trace, graphed_decode_trace=graphed, prefill_trace=prefill_trace,
                long_decode_trace=long_trace, long_graphed_decode_trace=long_graphed,
                flash_vs_plain_attention=flash_nmse)


def greedy_request(torch, model, prompt, n: int, graph: bool):
    """Prefill `prompt`, then n greedy decode steps: (first token, the n ids,
    host clock before the prefill, after it, after the decode, logits
    finite, the decode's device ms/token between two CUDA events)."""
    cache = model.new_cache(torch.bfloat16)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache, n_past = model.prefill(cache, prompt)
    first = torch.argmax(logits, dim=-1, keepdim=True)
    finite = bool(torch.isfinite(logits).all())
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    start.record()
    cache, ids = model.decode_greedy(cache, first, n_past, n, graph=graph)
    end.record()
    t2 = time.perf_counter()
    end.synchronize()
    return int(first[0, 0]), ids[:, 0].tolist(), t0, t1, t2, finite, start.elapsed_time(end) / n


def sampled_requests(torch, model, req: dict, n_gen: int) -> dict:
    """Sampled decode on the card (after the launch counters are read): the
    prompt of `req` (a greedy request), the first token drawn from the
    prefill logits and n_gen - 1 more by the graphed sampled loop, at
    temperature 0.8, top_k 40, top_p 0.95 from a generator seeded 1234: run
    twice, the same ids; eagerly, the same ids again (the same kernels and
    the same draws); with top_k = 1, the greedy request's ids, or the same
    ids up to a step where the largest logit is tied and top_k = 1 takes
    another of the tied (bf16 logits over 128256 entries tie)."""
    from ggml_tpu_torch.sampling import sample_top_k_top_p

    def run(top_k, graph=True):
        logits, cache, n_past = model.prefill(model.new_cache(torch.bfloat16), req["prompt_tokens"])
        gen = torch.Generator(device="cuda")
        gen.manual_seed(1234)
        kw = dict(temperature=0.8, top_k=top_k, top_p=0.95)
        first, gen = sample_top_k_top_p(logits, gen, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cache, ids = model.decode_sampled(cache, first.reshape(-1, 1), n_past, n_gen - 1, gen, graph=graph, **kw)
        ms = (time.perf_counter() - t0) * 1e3 / (n_gen - 1)
        return [int(first[0])] + ids[:, 0].tolist(), ms

    runs = [run(40), run(40)]
    eager, eager_ms = run(40, graph=False)
    greedy_ids, _ = run(1)
    ids = runs[0][0]
    check(len(ids) == n_gen and all(0 <= x < model.cfg.n_vocab for x in ids), f"sampled decode: ids {ids}")
    check(runs[1][0] == ids, f"sampled decode, seed 1234 twice: {ids[:8]}... then {runs[1][0][:8]}...")
    check(eager == ids, f"sampled decode, eager against graphed: {eager[:8]}... against {ids[:8]}...")
    tie = None
    if greedy_ids != req["ids"]:
        # top_k = 1 keeps every logit tied with the largest (the JAX sampler's
        # rule); the greedy loop takes the first: the two may part only where
        # the largest logit is tied, and both picks must be such maxima
        tie = next(i for i, (a, b) in enumerate(zip(greedy_ids, req["ids"])) if a != b)
        logits, cache, n_past = model.prefill(model.new_cache(torch.bfloat16), req["prompt_tokens"])
        for j, tok in enumerate(req["ids"][:tie]):
            logits, cache = model.decode_step(cache, [[tok]], n_past + j)
        top = logits[0].max()
        check(bool(logits[0, greedy_ids[tie]] == top) and bool(logits[0, req["ids"][tie]] == top),
              f"sampled decode with top_k=1: {greedy_ids[:8]}..., greedy {req['ids'][:8]}...: they part at step "
              f"{tie}, where the logits of the two picks are {float(logits[0, greedy_ids[tie]])} and "
              f"{float(logits[0, req['ids'][tie]])}, the largest {float(top)}")
    distinct = len(set(ids))
    print(f"  sampled request (temperature 0.8, top_k 40, top_p 0.95, seed 1234), prompt={req['prompt']}: "
          f"{n_gen} ids, {distinct} distinct, the same twice ({runs[0][1]:.2f}, {runs[1][1]:.2f} ms/token graphed; "
          f"eager {eager_ms:.2f}, the same ids); top_k=1 gives the greedy ids"
          + ("" if tie is None else f" up to step {tie}, where it takes another of the tied largest logits"))
    return dict(ids=ids[:16], distinct=distinct, graphed_ms_per_token=[r[1] for r in runs],
                eager_ms_per_token=eager_ms, same_twice=True, eager_equal=True, top_k_1_is_greedy=tie is None,
                top_k_1_parts_at_a_tie=tie)


def flash_against_plain_attention(torch, np, model, t: int) -> float:
    """Logits at every position of a t-token prefill through the flash kernel
    against the same prefill through the plain f32 attention over the cache
    window (flash_min_seq raised out of reach), over the model's first layer
    at full width, on the card (after the launch counters are read).  The two
    differ in bf16 roundings only: the plain attention reads k back from the
    bf16 cache and rounds the normalized p, the flash branch takes k in f32
    and rounds p before it is normalized.  NMSE <= 1e-4."""
    from ggml_tpu_torch.models import gptj

    prompt = torch.from_numpy(np.random.default_rng(t).integers(0, model.cfg.n_vocab, (1, t))).to(model.device)
    zero = torch.zeros((), dtype=torch.int32, device=model.device)

    def logits(**changes):
        cfg = dataclasses.replace(model.cfg, n_layer=1, **changes)
        cache = gptj.init_cache(cfg, 1, model.max_seq, torch.bfloat16, model.device)
        return gptj.forward(model.params, cfg, prompt, zero.expand(1), cache, zero, prefill=True)[0]

    nmse, _ = errors(logits(flash_min_seq=1 << 30), logits())
    print(f"  {t}-token prefill over one layer at full width, flash against plain attention, logits at every "
          f"position: NMSE {nmse:.2e}")
    check(nmse <= 1e-4, f"flash prefill against plain attention over one layer: NMSE {nmse:.2e} > 1e-4")
    return nmse


def _device_events(prof):
    """Device-side events only (kernels, copies, fills): the ops that launch
    them carry the same time again as their own "device time"."""
    return [e for e in prof.key_averages() if e.device_type.name == "CUDA"]


def profile_prefill(torch, np, model, t: int) -> dict:
    """Device time of one prefill of t tokens by kernel, from a
    torch.profiler trace (after the launch counters are read)."""
    from torch.profiler import ProfilerActivity, profile

    prompt = np.arange(t)[None]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.prefill(model.new_cache(torch.bfloat16), prompt)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
    events = _device_events(prof)
    total_us = sum(e.self_device_time_total for e in events)
    ours = {name: sum(e.self_device_time_total for e in events if name in e.key) / 1e3
            for name in ("q4k_matmul_kernel", "q8_matmul_kernel", "qmatmul_xsum_kernel", "fa_sm90_kernel",
                         "flash_split_kernel", "flash_mask_ranges_kernel")}
    ours = {k: v for k, v in ours.items() if v}
    trace = dict(prompt=t, host_ms=host_ms, device_ms=total_us / 1e3, port_kernels_ms=ours,
                 other_device_ms=total_us / 1e3 - sum(ours.values()))
    print(f"  profiled a {t}-token prefill: {host_ms:.1f} ms on the host's clock (profiler on), device busy "
          f"{trace['device_ms']:.1f} ms; port kernels "
          + ", ".join(f"{k} {v:.1f} ms" for k, v in ours.items())
          + f"; other ops {trace['other_device_ms']:.1f} ms")
    return trace


def profile_decode(torch, np, model, steps: int = 8, prompt: int = 8) -> dict:
    """Device time per decode token by kernel, from a torch.profiler trace of
    `steps` eager decode steps (graph=False: every launch shows) after a
    `prompt`-token prompt (the launch counters are read before this, so
    these launches are not counted as the main path's).  Prints decode
    attention D's share of the device time."""
    from torch.profiler import ProfilerActivity, profile

    cache = model.new_cache(torch.bfloat16)
    logits, cache, n_past = model.prefill(cache, np.arange(prompt)[None])
    first = torch.argmax(logits, dim=-1, keepdim=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        model.decode_greedy(cache, first, n_past, steps, graph=False)
        torch.cuda.synchronize()
    events = _device_events(prof)
    total_us = sum(e.self_device_time_total for e in events)
    ours = {name: sum(e.self_device_time_total for e in events if name in e.key)
            for name in ("gemv_sm90_kernel", "decode_attn_kernel")}
    ours = {k: v for k, v in ours.items() if v}
    launches = sum(e.count for e in prof.key_averages() if e.key.startswith("cudaLaunchKernel"))  # and ...ExC: cluster launches
    trace = dict(steps=steps, prompt=prompt, device_ms_per_token=total_us / steps / 1e3,
                 launches_per_token=launches / steps,
                 port_kernels_ms_per_token={k: v / steps / 1e3 for k, v in ours.items()},
                 other_device_ms_per_token=(total_us - sum(ours.values())) / steps / 1e3,
                 decode_attn_share=ours.get("decode_attn_kernel", 0.0) / total_us)
    print(f"  profiled {steps} eager decode steps at pos {prompt}..{prompt + steps - 1}: decode attention D "
          f"{trace['port_kernels_ms_per_token'].get('decode_attn_kernel', 0.0):.3f} ms/token, "
          f"{trace['decode_attn_share'] * 100:.1f} % of the device time")
    print(f"  profiled {steps} eager decode steps: device busy {trace['device_ms_per_token']:.3f} ms/token, "
          f"{trace['launches_per_token']:.0f} kernel launches/token; port kernels "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in trace["port_kernels_ms_per_token"].items())
          + f"; other ops {trace['other_device_ms_per_token']:.3f} ms")
    return trace


def profile_decode_graphed(torch, np, model, steps: int = 32, prompt: int = 8) -> dict:
    """The graphed decode loop after a `prompt`-token prompt: host ms/token
    of `steps` replays on the host's clock (the cache rows copied in and out
    included), then, over the same request again under torch.profiler,
    device busy per token (copies included) and the graph launches; the
    card's idle share of a token is 1 - busy / host.  After the launch
    counters are read."""
    from torch.profiler import ProfilerActivity, profile

    def request():
        logits, cache, n_past = model.prefill(model.new_cache(torch.bfloat16), np.arange(prompt)[None])
        first = torch.argmax(logits, dim=-1, keepdim=True)
        torch.cuda.synchronize()
        return cache, first, n_past

    cache, first, n_past = request()
    t0 = time.perf_counter()
    model.decode_greedy(cache, first, n_past, steps)  # returns the ids to the host: the card is done
    host_ms = (time.perf_counter() - t0) * 1e3 / steps
    cache, first, n_past = request()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        model.decode_greedy(cache, first, n_past, steps)
        torch.cuda.synchronize()
    events = _device_events(prof)
    total_us = sum(e.self_device_time_total for e in events)
    ours = {name: sum(e.self_device_time_total for e in events if name in e.key) / steps / 1e3
            for name in ("gemv_sm90_kernel", "q8_matmul_kernel", "qmatmul_xsum_kernel", "decode_attn_kernel")}
    ours = {k: v for k, v in ours.items() if v}
    graph_launches = sum(e.count for e in prof.key_averages() if e.key.startswith("cudaGraphLaunch"))
    busy = total_us / steps / 1e3
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:5]
    trace = dict(steps=steps, prompt=prompt, host_ms_per_token=host_ms, device_ms_per_token=busy,
                 idle_share=1.0 - busy / host_ms, graph_launches_per_token=graph_launches / steps,
                 port_kernels_ms_per_token=ours, other_device_ms_per_token=busy - sum(ours.values()),
                 top_kernels_ms_per_token={e.key[:80]: e.self_device_time_total / steps / 1e3 for e in top},
                 top_kernels_calls_per_token={e.key[:80]: e.count / steps for e in top})
    print(f"  graphed decode, {steps} steps at pos {prompt}..{prompt + steps - 1}: host {host_ms:.3f} ms/token, "
          f"device busy {busy:.3f} ms/token (idle {trace['idle_share'] * 100:.1f} %), "
          f"{trace['graph_launches_per_token']:.2f} graph launches/token; port kernels "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in ours.items())
          + f"; other ops {trace['other_device_ms_per_token']:.3f} ms")
    return trace


def phase_tiny_reference(torch, np):
    """A tiny GPT-J on the card (kernels) against the same weights on the CPU
    (plain versions), fed the same tokens, for five parameter sets:
    synthesized Q4_K, synthesized Q8_0, Q4_K with Q6_K ffn_down and
    output.weight (compact planes repacked from random blocks), synthesized
    Q4_0, and Q4_1 with Q2_K ffn_down and Q3_K attn_output and output.weight
    (nibble planes repacked from random blocks), and a GGUF file whose 14
    matmul weights cycle through the eleven IQ* and TQ* types (write_random_gguf
    (types=), loaded with GPTJ.from_gguf: IQ1_M's groups of 8 and the TQ
    types' 256 take kernel G at every M); the Q4_0 set also prefills
    through the flash kernel (use_flash_prefill).  Prefill of 40 tokens has
    no int8 activations: NMSE <= 1e-5 (bf16 product order).
    The int8 paths: the card sums in f32 in another order than the CPU, and a
    last-bit difference that crosses a rounding boundary of the bf16 cast or
    of the int8 quantization moves one activation code, which costs about
    1e-4 at the logits of this tiny model: NMSE <= 5e-4."""
    from ggml_tpu_torch.dtypes import GGMLType
    from ggml_tpu_torch.models import gptj
    from ggml_tpu_torch.quant import reference
    from ggml_tpu_torch.quant.planar import repack

    cfg = gptj.GPTJConfig(n_vocab=512, n_ctx=256, n_embd=512, n_head=4, n_layer=2, n_rot=32,
                          rope_deinterleaved=True)
    synth = lambda t: gptj.synth_quantized_params(cfg, t, seed=3, dtype=torch.float32, device="cpu")
    mixed = synth(GGMLType.Q4_K)
    rng = np.random.default_rng(5)
    for name in ("output.weight", "blk.0.ffn_down.weight", "blk.1.ffn_down.weight"):
        n, k = mixed[name].n, mixed[name].k
        mixed[name] = repack(reference.random_blocks(GGMLType.Q6_K, n * k // 256, rng, scale=1e-4),
                             GGMLType.Q6_K, (n, k))
    nibbles = synth(GGMLType.Q4_1)
    for name, t, scale in (("output.weight", GGMLType.Q3_K, 1e-4), ("blk.0.attn_output.weight", GGMLType.Q3_K, 1e-4),
                           ("blk.0.ffn_down.weight", GGMLType.Q2_K, 3e-4), ("blk.1.ffn_down.weight", GGMLType.Q2_K, 3e-4)):
        n, k = nibbles[name].n, nibbles[name].k
        nibbles[name] = repack(reference.random_blocks(t, n * k // 256, rng, scale=scale), t, (n, k))
    with tempfile.TemporaryDirectory(prefix="tiny-iq-") as tmp:
        path = f"{tmp}/tiny-iq.gguf"
        names = gptj.matmul_weight_names(cfg)
        gptj.write_random_gguf(path, cfg, seed=7,
                               types={n: GGMLType[IQ_TYPES[i % len(IQ_TYPES)]] for i, n in enumerate(names)})
        iq_mix = gptj.GPTJ.from_gguf(path, dtype=torch.float32, device="cpu").params
    out = {}
    flash_cfg = dataclasses.replace(cfg, use_flash_prefill=True)
    for label, cpu_params, run_cfg in (
            ("q4_k", synth(GGMLType.Q4_K), cfg), ("q8_0", synth(GGMLType.Q8_0), cfg), ("q4_k+q6_k", mixed, cfg),
            ("q4_0", synth(GGMLType.Q4_0), cfg), ("q4_1+q2_k+q3_k", nibbles, cfg),
            ("eleven IQ*/TQ* types", iq_mix, cfg),
            ("q4_0 flash prefill", synth(GGMLType.Q4_0), flash_cfg)):
        # Module.to moves in place: copy the planar weights before moving them
        gpu_params = {k: copy.deepcopy(v).to("cuda") for k, v in cpu_params.items()}
        for t, gate in ((40, 1e-5), (5, 5e-4)):
            prompt = torch.from_numpy(np.random.default_rng(t).integers(0, 512, (1, t)))
            runs = []
            for params, dev in ((cpu_params, "cpu"), (gpu_params, "cuda")):
                cache = gptj.init_cache(cfg, 1, 64, torch.bfloat16, dev)
                zero = torch.zeros((), dtype=torch.int32, device=dev)
                runs.append([gptj.forward(params, run_cfg, prompt.to(dev), zero.expand(1), cache, zero,
                                          prefill=True)[0][:, -1].cpu(), cache, dev])
            nm, _ = errors(runs[0][0], runs[1][0])
            check(nm <= gate, f"tiny GPT-J {label}, prefill {t}: card vs CPU NMSE {nm:.2e} > {gate:g}")
            worst = 0.0
            tok = int(torch.argmax(runs[0][0]))
            for step in range(8):
                step_logits = []
                for params, (_, cache, dev) in zip((cpu_params, gpu_params), runs):
                    pos = torch.tensor(t + step, dtype=torch.int32, device=dev)
                    step_logits.append(gptj.forward(params, cfg, torch.tensor([[tok]], device=dev),
                                                    pos.expand(1), cache, pos)[0][0, -1].cpu())
                nm_step, _ = errors(*step_logits)
                worst = max(worst, nm_step)
                tok = int(torch.argmax(step_logits[0]))
            check(worst <= 5e-4, f"tiny GPT-J {label}, decode after {t}: card vs CPU NMSE {worst:.2e} > 5e-4")
            out[f"{label}/{t}"] = dict(prefill_nmse=nm, decode_worst_nmse=worst)
            print(f"  tiny GPT-J {label}, prompt {t}: prefill NMSE {nm:.2e}, 8 decode steps worst NMSE {worst:.2e}")

    # the bf16 flash kernel inside the model: a bf16 tiny model on the card,
    # flash prefill against its own plain-attention prefill (bf16 roundings of
    # k and p differ between the two; gated over one layer, see
    # flash_against_plain_attention)
    params = gptj.synth_quantized_params(cfg, GGMLType.Q4_0, seed=3, dtype=torch.bfloat16, device="cuda")
    prompt = torch.from_numpy(np.random.default_rng(40).integers(0, 512, (1, 40))).cuda()
    nms = []
    for depth in (1, cfg.n_layer):
        logits = []
        for run_cfg in (cfg, flash_cfg):
            zero = torch.zeros((), dtype=torch.int32, device="cuda")
            logits.append(gptj.forward(params, dataclasses.replace(run_cfg, n_layer=depth), prompt, zero.expand(1),
                                       gptj.init_cache(cfg, 1, 64), zero, prefill=True)[0].float())
        nms.append(errors(*logits)[0])
    check(nms[0] <= 1e-4, f"tiny bf16 GPT-J, flash against plain-attention prefill over one layer: NMSE {nms[0]:.2e} > 1e-4")
    out["q4_0 bf16 flash vs plain attention"] = dict(one_layer_nmse=nms[0], two_layer_nmse=nms[1])
    print(f"  tiny bf16 GPT-J q4_0, prompt 40, flash against plain-attention prefill on the card: NMSE {nms[0]:.2e} "
          f"over one layer, {nms[1]:.2e} over two")
    return out


def _kernel_class(key: str) -> str:
    """What a device kernel of a training step is, by its name: K is J's
    wgmma kernel with its LSE flag set (or the f32 kernel's LSE instance), L
    fa_bwd_dq_sm90_kernel (fa_bwd_dq_f32_kernel for f32), M
    fa_bwd_dkv_sm90_kernel (fa_bwd_dkv_f32_kernel)."""
    if re.search(r"fa_sm90_kernel<\d+, \w+, true>", key) or "flash_attn_f32_kernel<true>" in key:
        return "K"
    if "fa_bwd_dq" in key:
        return "L"
    if "fa_bwd_dkv" in key:
        return "M"
    if "flash_mask_ranges" in key:
        return "mask ranges"
    if any(tag in key.lower() for tag in ("gemm", "xmma", "cutlass", "nvjet", "cublas")):
        return "GEMM"
    return "other"


def phase_train(torch, np) -> dict:
    """GPT-2-medium at its published widths, trained as bench.py's train
    mode composes it (make_lm_model_fn + Optimizer; batch 8 x 512 tokens,
    bf16 forward and backward over f32 masters, bf16 moments, the fused
    sparse cross entropy, flash attention) on a repeating pattern of random
    token ids from token_windows: 1 warm step, 6 timed ones with every launch
    counted (24 layers: exactly 24 of each of K, L and M a step, and one
    flash_mask_ranges a step, once per forward for every layer's K, L and
    M), then one profiled step (after the counters are read)."""
    from torch.profiler import ProfilerActivity, profile

    from ggml_tpu_torch.models import gpt2
    from ggml_tpu_torch.opt import AdamWConfig, Optimizer, make_lm_model_fn, token_windows

    cfg = gpt2.GPT2Config(n_vocab=50257, n_ctx=1024, n_embd=1024, n_head=16, n_layer=24)
    batch, seq, steps = 8, 512, 6
    t0 = time.perf_counter()
    params = gpt2.init_random_params(cfg, seed=0, device="cuda")
    n_params = sum(p.numel() for p in params.values())
    model_fn = make_lm_model_fn(gpt2, cfg, seq, batch, compute_dtype=torch.bfloat16, cast_logits_f32=False,
                                train_flash=True)
    opt = Optimizer(model_fn, params, loss_type="cross_entropy_sparse_fused",
                    adamw=AdamWConfig(state_dtype="bfloat16"), classify=False)
    del params
    pattern = np.random.default_rng(0).integers(0, cfg.n_vocab, 97)
    ds = token_windows(np.resize(pattern, batch * seq + 1), seq)
    x, y = (torch.from_numpy(a).cuda() for a in ds.get_batch(0, batch))
    torch.cuda.synchronize()
    print(f"  {n_params / 1e6:.1f} M parameters, set up in {time.perf_counter() - t0:.1f}s")

    torch.cuda.reset_peak_memory_stats()
    losses = [float(opt.step(x, y)["loss"])]  # warm
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics = [opt.step(x, y) for _ in range(steps)]
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / steps
    counts = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses += [float(m["loss"]) for m in metrics]
    per_step = TRAIN + ("flash_mask_ranges",)
    # K, L and M once per layer; the ranges once per forward, handed to every layer's K, L and M
    want = {k: (cfg.n_layer * steps if k in TRAIN else steps if k == "flash_mask_ranges" else 0) for k in counts}
    check(counts == want, f"GPT-2-medium training: launches {counts}, want {want}")
    check(all(np.isfinite(losses)), f"GPT-2-medium training: losses {losses}")
    check(losses[-1] < losses[0], f"GPT-2-medium training: the loss did not fall: {losses}")

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        opt.step(x, y)
        torch.cuda.synchronize()
    events = _device_events(prof)
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    shares = {}
    for e in events:
        cls = _kernel_class(e.key)
        shares[cls] = shares.get(cls, 0.0) + e.self_device_time_total / 1e3
    others = sorted((e for e in events if _kernel_class(e.key) == "other"), key=lambda e: -e.self_device_time_total)
    top_other = [dict(kernel=e.key[:120], ms=e.self_device_time_total / 1e3, calls=e.count) for e in others[:8]]
    launches = sum(e.count for e in prof.key_averages() if e.key.startswith("cudaLaunchKernel"))  # and ...ExC: cluster launches
    tokens = batch * seq
    flop = 6.0 * n_params * tokens
    out = dict(model="gpt2-medium", n_params=n_params, batch=batch, seq=seq, steps=steps, ms_per_step=step_ms,
               tokens_per_s=tokens / (step_ms * 1e-3), mfu=flop / (step_ms * 1e-3) / PEAK_OPS["bf16"],
               floor_ms_per_step=flop / PEAK_OPS["bf16"] * 1e3, losses=losses, peak_memory_gb=peak_gb,
               launches=counts, counts=counts, profiled_step=dict(
                   device_busy_ms=busy_ms, ms_by_class=shares, cuda_launches=launches,
                   share_by_class={k: v / busy_ms for k, v in shares.items()}, top_other_kernels=top_other))
    print(f"  {step_ms:.1f} ms/step on the host's clock ({tokens / (step_ms * 1e-3):.0f} tokens/s, MFU "
          f"{out['mfu'] * 100:.1f} % of {PEAK_OPS['bf16'] / 1e12:.0f} TFLOP/s; floor {out['floor_ms_per_step']:.2f} "
          f"ms/step), peak memory {peak_gb:.2f} GB")
    print(f"  losses {[round(v, 4) for v in losses]}")
    print(f"  launches over {steps} steps: " + ", ".join(f"{k} {counts[k]}" for k in per_step))
    print(f"  profiled step: device busy {busy_ms:.1f} ms, {launches} kernel launches; "
          + ", ".join(f"{k} {v:.2f} ms ({v / busy_ms * 100:.1f} %)" for k, v in sorted(shares.items())))
    for o in top_other:
        print(f"    other: {o['ms']:7.2f} ms in {o['calls']:5d} calls  {o['kernel']}")
    del opt
    torch.cuda.empty_cache()
    return out


def phase_train_774m(torch, np) -> dict:
    """4g, GPT-2-large at bench_train's 774m shape (bench.py:615-621,
    638-642; openai-community/gpt2-large: n_vocab 50257, E 1280, 20 heads,
    36 layers, context 512 there): batch 4 x 512, bf16 over f32 masters,
    bf16 moments, the fused sparse cross entropy, flash attention; without
    remat and with bench's policy, 1 warm step and 4 timed each.  K, L and M
    once per layer and the mask ranges once a forward (36, 36, 36, 1 a
    step); with remat K runs again in every layer's recomputed forward (72
    a step), the mask ranges (computed before the layers) are not
    recomputed.  Checks: exact launches, finite losses, the first step's
    loss and the parameters after it equal across the runs, the peak lower
    with remat."""
    import gc

    from ggml_tpu_torch.models import gpt2
    from ggml_tpu_torch.opt import AdamWConfig, Optimizer, make_lm_model_fn

    cfg = gpt2.GPT2Config(n_vocab=50257, n_ctx=512, n_embd=1280, n_head=20, n_layer=36)
    batch, seq, steps = 4, 512, 4
    t0 = time.perf_counter()
    params = gpt2.init_random_params(cfg, seed=0, device="cuda")
    n_params = sum(p.numel() for p in params.values())
    rng = np.random.default_rng(0)
    x, y = (torch.from_numpy(rng.integers(0, cfg.n_vocab, (batch, seq))).cuda() for _ in range(2))
    torch.cuda.synchronize()
    out = dict(model="gpt2-large", n_params=n_params, batch=batch, seq=seq, steps=steps, remat=REMAT, runs={},
               counts={}, setup_s=time.perf_counter() - t0)
    per_step = {}
    for policy in (None, REMAT):
        name = policy or "none"
        gc.collect()
        torch.cuda.empty_cache()
        model_fn = make_lm_model_fn(gpt2, cfg, seq, batch, compute_dtype=torch.bfloat16, cast_logits_f32=False,
                                    remat_policy=policy, train_flash=True)
        opt = Optimizer(model_fn, params, loss_type="cross_entropy_sparse_fused",
                        adamw=AdamWConfig(state_dtype="bfloat16"), classify=False)
        run = timed_training(torch, np, opt, x, y, steps)
        per_step[name] = {k: v // steps for k, v in run["counts"].items() if v}
        k_per_step = cfg.n_layer * (2 if policy else 1)
        want = {k: 0 for k in run["counts"]}
        want.update(flash_attn_fwd_lse=k_per_step * steps, flash_attn_bwd_dq=cfg.n_layer * steps,
                    flash_attn_bwd_dkv=cfg.n_layer * steps, flash_mask_ranges=steps)
        check(run["counts"] == want, f"GPT-2-large, remat {name}: launches {run['counts']}, want {want}")
        check(all(np.isfinite(run["losses"])), f"GPT-2-large, remat {name}: losses {run['losses']}")
        flop = 6.0 * n_params * batch * seq
        run["mfu"] = flop / (run["ms_per_step"] * 1e-3) / PEAK_OPS["bf16"]
        for k, v in run["counts"].items():
            out["counts"][k] = out["counts"].get(k, 0) + v
        out["runs"][name] = run
        del opt
    del params
    out["remat_against_none"] = compare_remat(torch, "GPT-2-large", out["runs"], exact=True)
    out["launches_per_step"] = per_step
    _remat_line(f"GPT-2-large ({n_params / 1e6:.0f} M parameters, 4 x 512)", out["runs"], per_step)
    print(f"  remat against none: {out['remat_against_none']}")
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_tiny_train(torch, np) -> dict:
    """A tiny f32 GPT-2 (2 layers, E 64, 4 heads, seq 64) on the card (f32
    kernels K, L, M) against the same model on the CPU (plain versions): the
    loss and every gradient through train_flash, then 3 AdamW steps.  f32 sums
    in another order: NMSE <= 1e-10 for loss and gradients; params after the
    steps <= 1e-8, the key bias left out (softmax ignores a shift shared by a
    row's scores, so its gradient is rounding noise, which AdamW turns into
    +-alpha steps of either sign)."""
    from ggml_tpu_torch.models import gpt2
    from ggml_tpu_torch.opt import AdamWConfig, Optimizer, make_lm_model_fn
    from ggml_tpu_torch.opt.optimizer import LOSS_TYPES

    cfg = gpt2.GPT2Config(n_vocab=128, n_ctx=64, n_embd=64, n_head=4, n_layer=2)
    rng = np.random.default_rng(3)
    x, y = (torch.from_numpy(rng.integers(0, 128, (2, 64))) for _ in range(2))
    fn = make_lm_model_fn(gpt2, cfg, 64, 2, cast_logits_f32=False, train_flash=True)
    cpu = gpt2.init_random_params(cfg, seed=1, device="cpu")
    runs = []
    for dev in ("cpu", "cuda"):
        leaves = {k: v.to(dev).clone().requires_grad_() for k, v in cpu.items()}
        loss = LOSS_TYPES["cross_entropy_sparse_fused"](fn(leaves, x.to(dev)), y.to(dev))
        loss.backward()
        opt = Optimizer(fn, {k: v.to(dev) for k, v in cpu.items()}, loss_type="cross_entropy_sparse_fused",
                        adamw=AdamWConfig(alpha=1e-3, wd=0.01), classify=False)
        for _ in range(3):
            opt.step(x.to(dev), y.to(dev))
        runs.append((float(loss.detach()), {k: v.grad.cpu() for k, v in leaves.items()},
                     {k: v.cpu() for k, v in opt.params.items()}))
    (l0, g0, p0), (l1, g1, p1) = runs
    loss_nmse = errors(torch.tensor([l0]), torch.tensor([l1]))[0]
    grad_nmse = max(errors(g0[k], g1[k])[0] for k in g0)
    E = cfg.n_embd
    drop_key_bias = lambda k, t: torch.cat([t[:E], t[2 * E:]]) if k.endswith("attn_qkv.bias") else t
    param_nmse = max(errors(drop_key_bias(k, p0[k]), drop_key_bias(k, p1[k]))[0] for k in p0)
    print(f"  tiny f32 GPT-2, card against CPU: loss NMSE {loss_nmse:.2e}, worst gradient NMSE {grad_nmse:.2e}, "
          f"params after 3 AdamW steps worst NMSE {param_nmse:.2e}")
    check(loss_nmse <= 1e-10 and grad_nmse <= 1e-10, f"tiny GPT-2: loss {loss_nmse:.2e}, gradients {grad_nmse:.2e}")
    check(param_nmse <= 1e-8, f"tiny GPT-2: params after 3 AdamW steps NMSE {param_nmse:.2e} > 1e-8")
    return dict(loss_nmse=loss_nmse, worst_grad_nmse=grad_nmse, worst_param_nmse_after_3_steps=param_nmse)


# the text the phase-4i vocabulary learns its merges from, its prompts and its
# perplexity stream
FRONT_END_TEXT = (
    "The river had been rising for three days when the ferryman decided that the old boat would make one more "
    "crossing before the bridge was closed. He checked the ropes, counted the oars, and looked at the grey sky "
    "as if it owed him an answer. On the far bank a small crowd was waiting: a teacher with a bag of books, two "
    "farmers who wanted to sell their apples in town, a girl carrying a cage with a sleeping cat, and a "
    "traveller nobody knew. It is not far, the ferryman said, and the water is slower than it looks. Nobody "
    "believed him, but everybody climbed in. Halfway across, the current turned the boat around twice, and the "
    "apples rolled from one side to the other while the cat woke up and complained about it. The teacher "
    "started to read aloud, partly to calm the children and partly to calm herself, a story about a city built "
    "on islands where people travelled only by water and measured the time of day by the colour of the waves. "
    "When they reached the other side, the traveller paid with a coin that none of them had seen before, "
    "thanked the ferryman in a language he did not know, and walked into the rain. In the years that followed, "
    "people in the village told the story many times, and each time the river was a little wider, the storm a "
    "little darker, and the coin a little brighter, until the children believed that the ferryman had once "
    "carried a king. He never corrected them. He only said that every crossing is different, that the water "
    "remembers nothing, and that a good boat is worth more than a fast one."
)
# lowercase words and spaces: the placeholder tokens of the phase-4i
# vocabulary are lowercase words, so random weights meet it within the
# sampler's scan of 512 candidates
FRONT_END_GRAMMAR = "root ::= [a-z] [a-z ]*"


def _placeholders(taken: set, n: int) -> list[str]:
    """n lowercase pseudo-words not in `taken`, every other one after a space
    symbol: the rest of a byte-level vocabulary of word pieces."""
    out, i = [], 0
    while len(out) < n:
        word, j = "", i
        while True:
            word = chr(ord("a") + j % 26) + word
            j = j // 26 - 1
            if j < 0:
                break
        tok = ("\u0120" if i % 2 else "") + word
        if tok not in taken:
            out.append(tok)
        i += 1
    return out


GPTJ6B_GGUF = "gpt-j-6b-q4_k.gguf"


def write_gptj6b_gguf(np, tmp: str, n_layer: int = 28) -> tuple:
    """The GGUF file phases 4i and 4j read, written into the directory tmp
    with the port's writer: GPT-J-6B's published widths (n_layer of its 28
    layers), Q4_K blocks from random_blocks, F32 norms and biases, a
    byte-level BPE vocabulary of 50400 entries (the 256 byte symbols, the
    merges learned from FRONT_END_TEXT, lowercase placeholder words,
    <|endoftext|> at 50256).  Returns (path, dict(n_merges, gguf_write_s,
    gguf_bytes, n_layer), tokens, merges, eos)."""
    from ggml_tpu_torch.models import gptj
    from ggml_tpu_torch.tokenizer import byte_level_vocab, learn_merges

    cfg = gptj.GPTJConfig(n_layer=n_layer)  # EleutherAI/gpt-j-6b
    merges = learn_merges(FRONT_END_TEXT, 100_000)  # until every word is one symbol
    tokens = byte_level_vocab(merges)
    eos = 50256
    fill = _placeholders(set(tokens), cfg.n_vocab - len(tokens) - 1)
    tokens = tokens + fill[: eos - len(tokens)] + ["<|endoftext|>"] + fill[eos - len(tokens):]
    check(len(tokens) == cfg.n_vocab and tokens[eos] == "<|endoftext|>" and len(set(tokens)) == len(tokens),
          f"vocabulary of {len(tokens)} entries")
    path = os.path.join(tmp, GPTJ6B_GGUF)
    t0 = time.perf_counter()
    gptj.write_random_gguf(path, cfg, seed=0, tokenizer=dict(model="gpt2", tokens=tokens, merges=merges,
                                                               eos_token_id=eos))
    info = dict(n_merges=len(merges), gguf_write_s=time.perf_counter() - t0, gguf_bytes=os.path.getsize(path),
                n_layer=n_layer)
    print(f"  wrote {info['gguf_bytes'] / 1e9:.3f} GB of GGUF ({len(merges)} merges) in {info['gguf_write_s']:.1f}s")
    return path, info, tokens, merges, eos


def phase_front_end(torch, np, written: tuple) -> dict:
    """4i: the text front end at GPT-J-6B's published widths, from the GGUF
    file write_gptj6b_gguf wrote (`written` is what it returned).  The generate CLI
    runs as a user runs it (a subprocess, --quantized --top-k 1 --verbose);
    then in this process, counting launches, the Q4_K model from the same
    file: the greedy text the CLI printed, a sampled request twice (the CLI's
    decode: the graphed sampled loop), a grammar-constrained request (the
    eager host loop), perplexity over 3072 tokens at window 1024, stride 512;
    then the file loaded dense bf16 (the CLI's default load): the same
    perplexity (|dppl|/ppl < 1 %) and a graphed greedy decode beside its
    floor."""
    from ggml_tpu_torch.cli import generate as cli
    from ggml_tpu_torch.grammar import GrammarSampler
    from ggml_tpu_torch.models import gptj
    from ggml_tpu_torch.models.registry import load_model
    from ggml_tpu_torch.ppl import perplexity
    from ggml_tpu_torch.quant.planar import PlanarWeight
    from ggml_tpu_torch.tokenizer import BPETokenizer

    path, _, tokens, merges, eos = written
    tok = BPETokenizer(tokens, merges)
    prompt = " ".join(FRONT_END_TEXT.split()[:48])
    prompt_ids = np.asarray([tok.encode(prompt)], np.int32)
    check(prompt_ids.shape[1] > 32 and tok.decode(prompt_ids[0]) == prompt, f"prompt of {prompt_ids.shape[1]} tokens")
    stream = np.asarray(tok.encode(FRONT_END_TEXT) * 16, np.int32)[:3072]
    check(len(stream) == 3072, f"perplexity stream of {len(stream)} tokens")
    out = dict(written[1], prompt_tokens=int(prompt_ids.shape[1]))

    # the CLI as a user runs it
    cmd = [sys.executable, "-m", "ggml_tpu_torch.cli.generate", path, "-p", prompt, "-n", "64", "--quantized",
           "--top-k", "1", "--seed", "0", "--verbose"]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    out["cli_wall_s"] = time.perf_counter() - t0
    check(r.returncode == 0, f"the generate CLI exited {r.returncode}:\n{r.stderr[-4000:]}")
    load = re.search(r"load time =\s*([\d.]+) ms", r.stderr)
    pred = re.search(r"predict time =\s*([\d.]+) ms / ([\d.]+) ms per token", r.stderr)
    check(load is not None and pred is not None, f"no timing lines in the CLI's stderr:\n{r.stderr[-2000:]}")
    out["cli_load_s"], out["cli_predict_ms"], out["cli_ms_per_token"] = (
        float(load[1]) / 1e3, float(pred[1]), float(pred[2]))
    report = re.findall(r"^\s+(q4|q8)\s+K=(\d+)\s+N=(\d+)\s+(gemv-M|matmul-M) -> (.+)$", r.stderr, re.M)
    out["cli_report"] = [" ".join(x) for x in report]
    check({(c, p) for *_, c, p in report} == {("gemv-M", "q4k_gemv_qact"), ("matmul-M", "q4k_matmul")},
          f"kernel report {report}")
    print(f"  CLI (python -m ggml_tpu_torch.cli.generate --quantized --top-k 1 -n 64): exit 0 in "
          f"{out['cli_wall_s']:.1f}s, load {out['cli_load_s']:.1f}s, predict {out['cli_predict_ms']:.1f} ms = "
          f"{out['cli_ms_per_token']:.2f} ms/token (prefill and graph capture included); report: "
          + "; ".join(out["cli_report"]))

    # the same file in this process, every launch counted
    reset_launches()
    t0 = time.perf_counter()
    model = gptj.GPTJ.from_gguf(path, max_seq=512, device="cuda")  # the CLI's max_seq
    torch.cuda.synchronize()
    out["q4k_load_s"] = time.perf_counter() - t0
    plane_bytes = sum(v.plane_bytes() for k, v in model.params.items()
                      if isinstance(v, PlanarWeight) and k != "token_embd.weight")
    ids = model.generate(prompt_ids, 64)
    check(r.stdout == prompt + tok.decode(ids) + "\n", f"CLI text {r.stdout[-200:]!r} differs from "
          f"{prompt + tok.decode(ids)!r}")
    first, rest, t0, t1, t2, finite, event_ms = greedy_request(torch, model, prompt_ids, 63, graph=True)
    check(finite and [first] + rest == ids, "a second greedy request gave other ids")
    out["q4k_prefill_ms"], out["q4k_ms_per_token"] = (t1 - t0) * 1e3, (t2 - t1) * 1e3 / 63
    out["q4k_plane_floor_ms"] = plane_bytes / HBM_BYTES_PER_S * 1e3
    print(f"  Q4_K from the file: loaded in {out['q4k_load_s']:.1f}s; the CLI's text again; prefill "
          f"{out['q4k_prefill_ms']:.1f} ms, graphed decode {out['q4k_ms_per_token']:.2f} ms/token "
          f"({event_ms:.2f} between CUDA events; plane floor {out['q4k_plane_floor_ms']:.3f})")

    sampled = []
    for _ in range(2):
        gen = torch.Generator(device="cuda")
        gen.manual_seed(1234)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = cli.decode(model, prompt_ids, 64, gen, temperature=0.8, top_k=40, top_p=0.95)
        sampled.append((got, (time.perf_counter() - t0) * 1e3 / 64))
    check(sampled[0][0] == sampled[1][0] and len(sampled[0][0]) == 64, "the seeded sampled request did not repeat")
    out["sampled_ms_per_token"] = [ms for _, ms in sampled]
    out["sampled_text"] = tok.decode(sampled[0][0])[:120]
    print(f"  sampled (temperature 0.8, top_k 40, top_p 0.95, seed 1234) twice: the same text, "
          f"{sampled[0][1]:.2f} and {sampled[1][1]:.2f} ms/token with the prefill (the first captures its graph)")

    sampler = GrammarSampler(FRONT_END_GRAMMAR, tok, eos_id=eos)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gids = model.generate(prompt_ids, 16, sampler=sampler)
    out["grammar_ms_per_token"] = (time.perf_counter() - t0) * 1e3 / 16
    while gids and gids[-1] == eos:
        gids = gids[:-1]
    text = tok.decode(gids)
    check(len(gids) > 0 and re.fullmatch(r"[a-z][a-z ]*", text) is not None, f"grammar output {text!r}")
    out["grammar_text"] = text
    print(f"  grammar {FRONT_END_GRAMMAR!r}, 16 tokens: {text!r}, {out['grammar_ms_per_token']:.2f} ms/token "
          "(the eager host loop, prefill included)")

    def ppl_of(m):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p = perplexity(gptj.forward, m.params, m.cfg, stream, window=1024, stride=512,
                       init_cache_fn=gptj.init_cache, cache_dtype=torch.bfloat16, device="cuda")
        return p, time.perf_counter() - t0

    out["ppl_q4k"], out["ppl_q4k_s"] = ppl_of(model)

    t0 = time.perf_counter()
    dense = load_model(path, device="cuda")  # the CLI's default: dense bf16, max_seq 512
    torch.cuda.synchronize()
    out["dense_load_s"] = time.perf_counter() - t0
    out["ppl_dense"], out["ppl_dense_s"] = ppl_of(dense)
    rel = abs(out["ppl_q4k"] - out["ppl_dense"]) / out["ppl_dense"]
    out["ppl_rel_delta"] = rel
    check(np.isfinite(out["ppl_q4k"]) and np.isfinite(out["ppl_dense"]) and rel < 0.01,
          f"perplexity Q4_K planes {out['ppl_q4k']}, dense bf16 {out['ppl_dense']}")
    print(f"  perplexity over {len(stream)} tokens (window 1024, stride 512): Q4_K planes {out['ppl_q4k']:.3f} "
          f"({out['ppl_q4k_s']:.2f}s), dense bf16 {out['ppl_dense']:.3f} ({out['ppl_dense_s']:.2f}s), "
          f"|dppl|/ppl {rel:.2e}")

    dense_bytes = sum(v.numel() * v.element_size() for k, v in dense.params.items()
                      if v.dim() == 2 and k != "token_embd.weight")
    dense.generate(prompt_ids, 4)  # captures the dense decode graph
    first, rest, t0, t1, t2, finite, event_ms = greedy_request(torch, dense, prompt_ids, 63, graph=True)
    check(finite and len(rest) == 63, "dense greedy decode")
    out["dense_ms_per_token"], out["dense_event_ms_per_token"] = (t2 - t1) * 1e3 / 63, event_ms
    out["dense_bytes_per_token"] = dense_bytes
    out["dense_floor_ms"] = dense_bytes / HBM_BYTES_PER_S * 1e3
    print(f"  dense bf16 from the file: loaded in {out['dense_load_s']:.1f}s; graphed greedy decode "
          f"{out['dense_ms_per_token']:.2f} ms/token ({event_ms:.2f} between CUDA events) against a floor of "
          f"{out['dense_floor_ms']:.3f} ({dense_bytes / 1e9:.3f} GB a token at {HBM_BYTES_PER_S / 1e12:.2f} TB/s)")
    counts = launch_counts()
    for name in ("q4k_gemv_qact", "q4k_matmul", "decode_attn", "flash_attn", "flash_split", "flash_mask_ranges"):
        check(counts[name] > 0, f"front end: {name} was never launched on its path")
    out["counts"] = counts
    print(f"  launches in this process: {counts}")
    for label, m in (("Q4_K from the file", model), ("dense bf16", dense)):
        print(f"  {label}:")
        trace = profile_decode_graphed(torch, np, m, prompt=prompt_ids.shape[1])
        out[f"{label.split()[0].lower()}_graphed_trace"] = trace
        print("    top kernels (ms, calls per token): " + "; ".join(
            f"{k} {v:.3f}, {trace['top_kernels_calls_per_token'][k]:.0f}"
            for k, v in trace["top_kernels_ms_per_token"].items()))
    del model, dense
    torch.cuda.empty_cache()
    return out


# 4j: QLoRA fine-tuning of GPT-J-6B at the JAX finetune CLI's default shape
# (lr 1e-3, the JAX finetune_lora's default: at 1e-2 the losses rose after
# the first step, 11.72 -> 9.45 -> 11.78 ... 11.81, PERF.md)
QLORA = dict(rank=8, batch=4, seq=128, steps=8, lr=1e-3)
# autograd nodes of the plain attention's backward (its forward runs in the
# "gptj.attention" range)
_ATTENTION_BACKWARD = ("BmmBackward0", "SoftmaxBackward0", "WhereBackward0", "IndexCopyBackward0")


def tensor_checksums(torch, params: dict, chunk: int = 1 << 26) -> list:
    """One position-weighted sum of the bytes of each tensor in params (every
    plane of a PlanarWeight): a changed byte moves its sum.  Summed in
    chunks of 64 MB (int64 partials: 8 bytes a byte)."""
    from ggml_tpu_torch.quant.planar import PlanarWeight

    sums = []
    for v in params.values():
        for t in (v.buffers() if isinstance(v, PlanarWeight) else (v,)):
            b = t.contiguous().reshape(-1).view(torch.uint8)
            acc = torch.zeros((), dtype=torch.int64, device=b.device)
            for i in range(0, b.numel(), chunk):
                c = b[i:i + chunk].to(torch.int64)
                acc += (c * (torch.arange(i, i + c.numel(), device=b.device, dtype=torch.int64) % 65521 + 1)).sum()
            sums.append(acc)
    return [int(a) for a in sums]


def _qlora_class(event, kernel: str) -> str:
    """What a device kernel of a QLoRA step computes, from its name and the
    ranges and autograd nodes around the op that launched it."""
    if "q4k_matmul_kernel" in kernel or "qmatmul_xsum_kernel" in kernel:
        return "C"
    if "q8_matmul_kernel" in kernel:
        return "G"
    e = event
    while e is not None:
        if e.name == "planar_matmul.bwd_dequant":
            return "backward dequant"
        if e.name == "planar_matmul.bwd_product":
            return "backward products"
        if e.name in ("gptj.attention", "llama.attention") or e.name.endswith(_ATTENTION_BACKWARD):
            return "attention"
        e = e.cpu_parent
    return "other"


_QLORA_RANGES = ("planar_matmul.bwd_dequant", "planar_matmul.bwd_product", "gptj.attention", "llama.attention")


def qlora_step_breakdown(prof) -> tuple:
    """(device busy ms, {class: ms}) of a profiled step: every device kernel
    (and copy) booked to the class of the op that launched it.  Busy leaves
    out the device-side spans of the named ranges, which cover the same
    kernels again."""
    busy = sum(e.self_device_time_total for e in _device_events(prof)
               if e.key not in _QLORA_RANGES and not getattr(e, "is_user_annotation", False)) / 1e3
    ms = {}
    for e in prof.events():
        for k in getattr(e, "kernels", ()):
            cls = _qlora_class(e, k.name)
            ms[cls] = ms.get(cls, 0.0) + k.duration / 1e3
    return busy, ms


def _adapters_agree(ref: dict, got: dict, what: str) -> dict:
    """The adapter gate of the card-against-CPU and resume checks: every
    `a` within NMSE 1e-6, every `b` within NMSE 1e-3 with at most one
    element in 1000 farther than 1e-4.  AdamW's first step moves each
    element of b (zero at init) by lr times the sign of its gradient, so a
    gradient element near zero whose sign differs with the order of f32 sums
    moves by 2 lr, and a's later gradients (which read b) with it: PR 12's
    first card run read a at NMSE 3.3e-8 with one b element off."""
    worst_a = max(errors(ref[n]["a"].cpu(), got[n]["a"].cpu())[0] for n in ref)
    worst_b = max(errors(ref[n]["b"].cpu(), got[n]["b"].cpu())[0] for n in ref)
    far = sum(int(((ref[n]["b"].cpu() - got[n]["b"].cpu()).abs() > 1e-4).sum()) for n in ref)
    total = sum(ref[n]["b"].numel() for n in ref)
    exact = all(bool((ref[n][k].cpu() == got[n][k].cpu()).all()) for n in ref for k in "ab")
    check(set(ref) == set(got) and worst_a <= 1e-6 and worst_b <= 1e-3 and far <= total // 1000,
          f"{what}: adapters a NMSE {worst_a:.2e}, b NMSE {worst_b:.2e}, {far} of {total} b elements off by > 1e-4")
    return dict(worst_a_nmse=worst_a, worst_b_nmse=worst_b, b_elements_off=far, b_elements=total, bit_exact=exact)


def phase_qlora(torch, np, path: str, tmp: str) -> dict:
    """4j: QLoRA fine-tuning of GPT-J-6B from the GGUF file phase 4i read
    (every matmul weight Q4_K): the base loaded as planes on the card, then
    finetune_lora(keep_quantized=True, rank 8) at the JAX finetune CLI's
    default shape, batch 4 x 128 tokens, 8 AdamW steps at lr 1e-3 on a
    repeated pattern of 61 random ids, every launch counted: kernel C computes
    each forward's 169 quantized linears at M = 512 (6 a layer and the head),
    exactly 169 launches a step, and nothing else of the port's kernels runs;
    the backward dequantizes the planes to bf16 and multiplies in f32
    (planar_matmul's backward, plain PyTorch as in the JAX package).  Checks:
    finite losses, the last below the first, the adapter through
    save_lora_gguf / load_lora_gguf / wrap_lora over the same base gives
    Optimizer.eval's loss within 1e-6 relative, the base's bytes unchanged
    (checksums before and after).  Then one profiled step (device time by
    class: C, backward dequant, backward products, attention, other), a tiny
    GPT-J Q4_K QLoRA run on the card against the CPU, and a checkpoint resume
    on the card."""
    from torch.profiler import ProfilerActivity, profile

    from ggml_tpu_torch.checkpoint import load_optimizer, save_optimizer
    from ggml_tpu_torch.gguf import GGUFFile
    from ggml_tpu_torch.models import gpt2, gptj
    from ggml_tpu_torch.opt import AdamWConfig, Optimizer, finetune_lora, make_lm_model_fn, token_windows
    from ggml_tpu_torch.opt.lora import init_lora, load_lora_gguf, save_lora_gguf, wrap_lora
    from ggml_tpu_torch.quant.planar import PlanarWeight

    import gc

    rank, batch, seq, steps, lr = (QLORA[k] for k in ("rank", "batch", "seq", "steps", "lr"))
    out = dict(QLORA)
    # earlier phases' models can outlive them in reference cycles (a model and
    # its decode graphs): free them, so this phase's memory is its own
    gc.collect()
    torch.cuda.empty_cache()
    out["allocated_before_gb"] = torch.cuda.memory_allocated() / 1e9
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with GGUFFile(path) as g:
        base = gpt2.load_params(g, torch.float32, keep_quantized=True, device="cuda")
        cfg = gptj.config_from_gguf(g)
    torch.cuda.synchronize()
    out["load_s"] = time.perf_counter() - t0
    planes = [k for k, v in base.items() if isinstance(v, PlanarWeight) and k != "token_embd.weight"]
    check(len(planes) == 6 * cfg.n_layer + 1, f"{len(planes)} quantized linears")
    t0 = time.perf_counter()
    before = tensor_checksums(torch, base)
    out["checksum_s"] = time.perf_counter() - t0
    print(f"  loaded {len(planes)} quantized linears as planes and the dense embedding in {out['load_s']:.1f}s "
          f"({torch.cuda.memory_allocated() / 1e9:.2f} GB on the card, {out['allocated_before_gb']:.2f} before); "
          f"{len(before)} checksums in {out['checksum_s']:.1f}s")

    pattern = np.random.default_rng(12).integers(0, cfg.n_vocab, 61)
    toks = np.resize(pattern, batch * seq * steps + 1).astype(np.int32)
    stamps = []
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses, trained = finetune_lora(path, toks, rank=rank, keep_quantized=True, seq_len=seq, batch=batch,
                                    steps=steps, adamw=AdamWConfig(alpha=lr), base=base, device="cuda",
                                    log=lambda line: stamps.append(time.perf_counter()))  # after steps 0 and 7
    out["run_s"] = time.perf_counter() - t0
    counts = launch_counts()
    out["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["losses"], out["counts"] = losses, counts
    out["first_step_ms"] = (stamps[0] - t0) * 1e3
    out["host_ms_per_step"] = (stamps[1] - stamps[0]) * 1e3 / (steps - 1)
    print(f"  finetune_lora: {steps} steps in {out['run_s']:.1f}s, step 0 {out['first_step_ms']:.0f} ms, then "
          f"{out['host_ms_per_step']:.1f} ms/step on the host's clock (the loss read back every step); peak "
          f"memory {out['peak_memory_gb']:.2f} GB; q4k_matmul launches {counts['q4k_matmul']} "
          f"({counts['q4k_matmul'] // steps} a step)")
    print(f"  losses {[round(v, 4) for v in losses]}")
    want = {k: (len(planes) * steps if k == "q4k_matmul" else 0) for k in counts}
    check(counts == want, f"QLoRA: launches {counts}, want {want}")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0], f"QLoRA losses {losses}")
    check(tensor_checksums(torch, base) == before, "QLoRA: the base planes changed")

    fn = make_lm_model_fn(gptj, cfg, seq, batch)
    model_fn = lambda p, t, frozen: fn(wrap_lora(frozen, p, 1.0), t)  # alpha = rank
    x, y = token_windows(toks, seq).get_batch(0, batch)
    opt = Optimizer(model_fn, trained, loss_type="cross_entropy_sparse", adamw=AdamWConfig(alpha=lr), frozen=base)
    adapter = os.path.join(tmp, "qlora-adapter.gguf")
    save_lora_gguf(adapter, trained, alpha=float(rank), base_arch="gptj")
    loaded, alpha = load_lora_gguf(adapter)
    reloaded = Optimizer(model_fn, {k: {kk: v.cuda() for kk, v in ab.items()} for k, ab in loaded.items()},
                         loss_type="cross_entropy_sparse", frozen=base)
    l_mem, l_file = float(opt.eval(x, y)["loss"]), float(reloaded.eval(x, y)["loss"])
    out["adapter_bytes"], out["eval_loss"], out["eval_loss_reloaded"] = os.path.getsize(adapter), l_mem, l_file
    check(alpha == rank and abs(l_mem - l_file) <= 1e-6 * abs(l_mem),
          f"adapter round trip: alpha {alpha}, eval loss {l_mem} in memory, {l_file} from the file")
    print(f"  adapter GGUF {out['adapter_bytes'] / 1e6:.2f} MB ({len(loaded)} adapters): Optimizer.eval loss "
          f"{l_mem:.6f} in memory, {l_file:.6f} from the file; the base's bytes unchanged")
    del reloaded

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        opt.step(x, y)
        torch.cuda.synchronize()
        prof_host_ms = (time.perf_counter() - t0) * 1e3
    busy, by_class = qlora_step_breakdown(prof)
    booked = sum(by_class.values())
    out["profiled_step"] = dict(host_ms=prof_host_ms, device_busy_ms=busy, ms_by_class=by_class,
                                unbooked_ms=busy - booked, idle_share=1.0 - busy / out["host_ms_per_step"])
    print(f"  profiled step: {prof_host_ms:.1f} ms on the host's clock (profiler on), device busy {busy:.1f} ms "
          f"(idle {out['profiled_step']['idle_share'] * 100:.1f} % of the unprofiled step); "
          + ", ".join(f"{k} {v:.1f} ms ({v / busy * 100:.1f} %)" for k, v in sorted(by_class.items()))
          + f"; not booked to an op {busy - booked:.1f} ms")
    del opt, base, trained
    torch.cuda.empty_cache()

    # a tiny GPT-J Q4_K on the card (kernel C at M = 128) against the CPU (plain versions)
    tcfg = gptj.GPTJConfig(n_vocab=256, n_ctx=128, n_embd=256, n_head=4, n_layer=2, n_rot=32)
    tiny = os.path.join(tmp, "tiny-gptj-q4k.gguf")
    gptj.write_random_gguf(tiny, tcfg, seed=3)
    ttoks = np.resize(np.random.default_rng(0).integers(0, tcfg.n_vocab, 13), 2 * 64 * 6 + 1).astype(np.int32)
    runs = {dev: finetune_lora(tiny, ttoks, rank=4, keep_quantized=True, seq_len=64, batch=2, steps=3,
                               adamw=AdamWConfig(alpha=1e-3), device=dev) for dev in ("cpu", "cuda")}
    dl = float(np.abs(np.array(runs["cpu"][0]) - np.array(runs["cuda"][0])).max())
    check(dl <= 1e-4, f"tiny QLoRA, card against CPU: losses {runs['cpu'][0]} and {runs['cuda'][0]}")
    out["tiny_card_vs_cpu"] = dict(loss_max_abs_diff=dl, **_adapters_agree(runs["cpu"][1], runs["cuda"][1],
                                                                            "tiny QLoRA, card against CPU"))
    print(f"  tiny GPT-J Q4_K QLoRA, 3 steps, card against CPU: losses within {dl:.2e}; "
          + ", ".join(f"{k} {v}" for k, v in out["tiny_card_vs_cpu"].items() if k != "loss_max_abs_diff"))

    # checkpoint resume on the card: 6 steps against 4, save, a fresh optimizer loading it, 2 more
    with GGUFFile(tiny) as g:
        tbase = gpt2.load_params(g, torch.float32, keep_quantized=True, device="cuda")
    tfn = make_lm_model_fn(gptj, tcfg, 64, 2)
    lora0 = init_lora(tbase, 4)
    ds = token_windows(ttoks, 64)
    batches = [ds.get_batch(i, 2) for i in range(6)]
    make = lambda: Optimizer(lambda p, t, f: tfn(wrap_lora(f, p, 1.0), t), lora0, loss_type="cross_entropy_sparse",
                             adamw=AdamWConfig(alpha=1e-2), frozen=tbase)
    whole = make()
    lw = [float(whole.step(*b)["loss"]) for b in batches]
    part = make()
    for b in batches[:4]:
        part.step(*b)
    ck = os.path.join(tmp, "step4.gguf")
    save_optimizer(ck, part)
    resumed = make()
    load_optimizer(ck, resumed)
    lres = [float(resumed.step(*b)["loss"]) for b in batches[4:]]
    dl = max(abs(a - b) for a, b in zip(lw[4:], lres))
    check(int(resumed.state["t"]) == 6 and dl <= 1e-4, f"resume on the card: losses {lw[4:]} and {lres}")
    out["resume"] = dict(loss_max_abs_diff=dl, **_adapters_agree(whole.params, resumed.params,
                                                                 "resume on the card"))
    print(f"  checkpoint resume on the card (tiny QLoRA, 4 steps, save, load, 2 more against 6): losses 5-6 "
          f"within {dl:.2e}; " + ", ".join(f"{k} {v}" for k, v in out["resume"].items() if k != "loss_max_abs_diff"))
    return out


# bench_qlora's shape (bench.py:681-770): rank 16, batch 2 x 512, lr 1e-4,
# its six targets, the fused sparse cross entropy on the logits as they come
QLORA_BENCH = dict(rank=16, batch=2, seq=512, steps=6, lr=1e-4)
QLORA_BENCH_TARGETS = ("attn_qkvup.weight", "attn_qkv.weight", "attn_output.weight", "ffn_up.weight",
                       "ffn_down.weight", "output.weight")
# bench_qlora's and bench_train-774m's default rematerialization (bench.py:638-642, 722-728)
REMAT = "dots_with_no_batch_dims_saveable"


def _clone_tree(torch, tree):
    return {k: _clone_tree(torch, v) if isinstance(v, dict) else v.detach().clone() for k, v in tree.items()}


def timed_training(torch, np, opt, x, y, steps: int) -> dict:
    """1 warm step, then `steps` timed ones on the host's clock around steps
    that end in a sync (no loss read back in between), every launch of the
    timed steps counted; peak memory (max_memory_allocated after
    reset_peak_memory_stats before the warm step) and the same less what
    was allocated when the run began; the first step's loss and the
    parameters after it (the run-against-run check)."""
    import gc

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()
    first = opt.step(x, y)
    out = dict(first_loss=float(first["loss"]), after_first=_clone_tree(torch, opt.params))
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics = [opt.step(x, y) for _ in range(steps)]
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / steps
    out.update(ms_per_step=ms, tokens_per_s=x.numel() / (ms * 1e-3), counts=launch_counts(),
               peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
               peak_above_start_gb=(torch.cuda.max_memory_allocated() - start) / 1e9,
               losses=[out["first_loss"]] + [float(m["loss"]) for m in metrics])
    out["forward_backward_peak_gb"] = forward_backward_peak(torch, opt, x, y)
    return out


def forward_backward_peak(torch, opt, x, y) -> float:
    """GB allocated at the peak of one forward and backward of opt's model
    and loss (no update, launches not counted) above what was allocated
    before it: what remat moves.  A step's own peak may come later, in the
    update (AdamW's f32 copies of every parameter and moment), after the
    activations are freed."""
    from ggml_tpu_torch.opt.optimizer import _leaves, _tree_map

    before = launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()
    leaves = _tree_map(lambda p: p.detach().requires_grad_(True), opt.params)
    outputs = opt.model_fn(leaves, x) if opt.frozen is None else opt.model_fn(leaves, x, opt.frozen)
    grads = torch.autograd.grad(opt.loss_fn(outputs, y), _leaves(leaves))
    del outputs, grads
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - start) / 1e9
    from ggml_tpu_torch.models.common import launch_tables

    for table in launch_tables():  # the counts stay those of the timed steps
        for k in table:
            table[k] = before[k]
    return peak


def profiled_training_step(torch, opt, x, y) -> dict:
    """One step under torch.profiler (after the counters were read): host ms,
    device busy ms and busy ms by class (qlora_step_breakdown)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        opt.step(x, y)
        torch.cuda.synchronize()
        host = (time.perf_counter() - t0) * 1e3
    busy, by_class = qlora_step_breakdown(prof)
    return dict(host_ms=host, device_busy_ms=busy, ms_by_class=by_class, unbooked_ms=busy - sum(by_class.values()))


def compare_remat(torch, label: str, runs: dict, exact: bool) -> dict:
    """Each run with remat against the run without ("none"): the first
    step's loss (the same forward: equal bit for bit where the card's
    kernels are deterministic at these shapes, gated at 1e-6 relative), the
    parameters after one step (bit for bit, or within the adapter gate),
    and the forward and backward's peak memory lower with remat."""
    plain = runs["none"]
    out = {}
    for name, remat in runs.items():
        if name == "none":
            continue
        l0, l1 = plain["first_loss"], remat["first_loss"]
        check(abs(l0 - l1) <= 1e-6 * abs(l0), f"{label}: the first step's loss {l0} without remat, {l1} with {name}")
        same = _clone_equal(torch, plain["after_first"], remat["after_first"])
        out[name] = dict(first_loss_bit_exact=l0 == l1, params_after_first_step_bit_exact=same)
        if not same:
            check(not exact, f"{label}: the parameters after one step differ with {name}")
            out[name].update(_adapters_agree(plain["after_first"], remat["after_first"], f"{label}, {name}"))
        check(remat["forward_backward_peak_gb"] < plain["forward_backward_peak_gb"],
              f"{label}: a forward and backward's peak {remat['forward_backward_peak_gb']:.2f} GB with {name}, "
              f"{plain['forward_backward_peak_gb']:.2f} without")
    for run in runs.values():
        del run["after_first"]
    return out


def _clone_equal(torch, a: dict, b: dict) -> bool:
    return set(a) == set(b) and all(_clone_equal(torch, a[k], b[k]) if isinstance(a[k], dict)
                                    else bool(torch.equal(a[k], b[k])) for k in a)


def _remat_line(label: str, runs: dict, per_step: dict):
    for name, r in runs.items():
        took = f" ({r['run_s']:.1f}s in all)" if "run_s" in r else ""
        print(f"  {label}, remat {name}{took}: {r['ms_per_step']:.1f} ms/step on the host's clock "
              f"({r['tokens_per_s']:.0f} tokens/s), peak memory {r['peak_memory_gb']:.2f} GB "
              f"({r['peak_above_start_gb']:.2f} above the run's start; a forward and backward "
              f"{r['forward_backward_peak_gb']:.2f} above its start), launches a step {per_step[name]}, "
              f"losses {[round(v, 4) for v in r['losses']]}")


def _profile_lines(runs: dict):
    for name, r in runs.items():
        p = r["profiled_step"]
        print(f"  profiled step, remat {name}: {p['host_ms']:.1f} ms on the host's clock (profiler on), device busy "
              f"{p['device_busy_ms']:.1f} ms; " + ", ".join(f"{k} {v:.1f} ms ({v / p['device_busy_ms'] * 100:.1f} %)"
                                                            for k, v in sorted(p["ms_by_class"].items()))
              + f"; not booked to an op {p['unbooked_ms']:.1f} ms")


def phase_qlora_bench(torch, np, params: dict, card: str) -> dict:
    """4o: QLoRA of GPT-J-6B Q4_K at bench_qlora's shape (bench.py:681-770)
    over synthesized compact planes (bf16 embedding and norms, as 4a holds
    them): rank 16 on bench's six targets (the fused qkvup, attn_output,
    ffn_down, the head), batch 2 x 512 seeded random ids, lr 1e-4, the
    fused sparse cross entropy on bf16 logits, the base as the Optimizer's
    `frozen`; run without remat and with bench's policy: 1 warm step and 6
    timed, and one profiled step (device busy by class); then once more
    under nothing_saveable, which recomputes the same kernels without the
    selective policy's dispatch mode (the host's cost of that mode).  C
    runs on every linear at M = 1024, 85 a forward; with remat again on the
    84 layer linears in the backward (tests/test_torch_remat.py: every
    layer linear, not the head), 169 a step.  Checks: finite losses, the
    exact launches, the first step's loss and the adapters after it equal
    across the runs, a forward and backward's peak lower with remat, the
    base's bytes unchanged."""
    import gc

    from ggml_tpu_torch.models import gptj
    from ggml_tpu_torch.opt import AdamWConfig, Optimizer, make_lm_model_fn
    from ggml_tpu_torch.opt.lora import init_lora, wrap_lora

    rank, batch, seq, steps, lr = (QLORA_BENCH[k] for k in ("rank", "batch", "seq", "steps", "lr"))
    cfg = gptj.random_config("6b")
    rng = np.random.default_rng(0)
    x, y = (torch.from_numpy(rng.integers(0, cfg.n_vocab, (batch, seq))).cuda() for _ in range(2))
    before = tensor_checksums(torch, params)
    forward = planar_launches(params, batch * seq, head=True)
    recomputed = planar_launches(params, batch * seq, head=False)
    check(forward == {"q4k_matmul": 85} and recomputed == {"q4k_matmul": 84}, f"kernels at M = {batch * seq}: "
          f"{forward}, {recomputed}")
    out = dict(QLORA_BENCH, targets=list(QLORA_BENCH_TARGETS), remat=REMAT, card=card, runs={}, counts={})
    per_step = {}
    for policy in (None, REMAT, "nothing_saveable"):
        name = policy or "none"
        gc.collect()
        torch.cuda.empty_cache()
        lora = init_lora(params, rank, targets=QLORA_BENCH_TARGETS)
        lm_fn = make_lm_model_fn(gptj, cfg, seq, batch, cast_logits_f32=False, remat_policy=policy)
        opt = Optimizer(lambda p, t, frozen: lm_fn(wrap_lora(frozen, p, 1.0), t), lora,
                        loss_type="cross_entropy_sparse_fused", adamw=AdamWConfig(alpha=lr), classify=False,
                        frozen=params)
        run = timed_training(torch, np, opt, x, y, steps)
        per_step[name] = {k: v // steps for k, v in run["counts"].items() if v}
        want = {k: 0 for k in run["counts"]}
        want["q4k_matmul"] = (85 + (84 if policy else 0)) * steps
        check(run["counts"] == want, f"4o, remat {name}: launches {run['counts']}, want {want}")
        check(all(np.isfinite(run["losses"])), f"4o, remat {name}: losses {run['losses']}")
        for k, v in run["counts"].items():
            out["counts"][k] = out["counts"].get(k, 0) + v
        run["profiled_step"] = profiled_training_step(torch, opt, x, y)
        run["adapters"] = len(lora)
        out["runs"][name] = run
        del opt, lora
    out["remat_against_none"] = compare_remat(torch, "4o", out["runs"], exact=False)
    check(tensor_checksums(torch, params) == before, "4o: the base planes changed")
    out["launches_per_step"] = per_step
    _remat_line("GPT-J-6B Q4_K QLoRA (rank 16, 2 x 512)", out["runs"], per_step)
    _profile_lines(out["runs"])
    print(f"  remat against none: {out['remat_against_none']}; the base's bytes unchanged ({card})")
    gc.collect()
    torch.cuda.empty_cache()
    return out


LLAMA_QLORA = dict(rank=16, batch=2, seq=512, steps=6, lr=1e-3)  # finetune_lora's defaults but rank and shape


def phase_qlora_llama(torch, np, path: str, tmp: str, card: str) -> dict:
    """4p: QLoRA of Llama-3-8B from phase 4l's Q4_K file (Q6_K head), as
    finetune_lora composes it: the base through load_params(keep_quantized=
    True) (f32 embedding and norms, Q4_K planes, the Q6_K head as int8
    planes), rank 16 on DEFAULT_TARGETS (q, k, v, attn_output, ffn_gate,
    ffn_up, ffn_down: 224 adapters), f32 logits and the sparse cross entropy,
    lr 1e-3, batch 2 x 512 seeded random ids; run without remat and with
    bench's policy: 1 warm step, 6 timed, one profiled (device time by
    class: C, G, backward dequant, backward products, attention, other).
    C on all 224 linears at M = 1024 (ffn_down's K = 14336 planes too), G
    on the head: 224 C and 1 G a step, 448 C with remat (the head is not
    recomputed).  Checks: finite losses, exact launches, the first step's
    loss and the adapters after it across the two runs, the peak lower with
    remat, the base's bytes unchanged, the adapter round trip
    (save_lora_gguf, load_lora_gguf, wrap_lora) giving Optimizer.eval's
    loss within 1e-6 relative.  Then generate --lora as a subprocess on a
    Llama-3-8B-width file cut to 2 layers, with the trained adapters of
    layers 0 and 1: its greedy ids equal this process's over merge_lora'd
    dense bf16 weights."""
    import gc

    from ggml_tpu_torch.dtypes import GGMLType
    from ggml_tpu_torch.gguf import GGUFFile
    from ggml_tpu_torch.models import gpt2, llama
    from ggml_tpu_torch.opt import AdamWConfig, Optimizer, make_lm_model_fn
    from ggml_tpu_torch.opt.lora import (apply_lora_to_params, init_lora, load_lora_gguf, save_lora_gguf,
                                         wrap_lora)
    from ggml_tpu_torch.quant.planar import PlanarWeight

    rank, batch, seq, steps, lr = (LLAMA_QLORA[k] for k in ("rank", "batch", "seq", "steps", "lr"))
    gc.collect()
    torch.cuda.empty_cache()
    out = dict(LLAMA_QLORA, remat=REMAT, card=card, runs={}, counts={})
    t0 = time.perf_counter()
    with GGUFFile(path) as g:
        base = gpt2.load_params(g, torch.float32, keep_quantized=True, device="cuda")
        cfg = llama.config_from_gguf(g)
    torch.cuda.synchronize()
    out["load_s"] = time.perf_counter() - t0
    planar = [k for k, v in base.items() if isinstance(v, PlanarWeight) and k != "token_embd.weight"]
    check(len(planar) == 7 * cfg.n_layer + 1, f"{len(planar)} planar linears")
    m = batch * seq
    forward, recomputed = planar_launches(base, m, head=True), planar_launches(base, m, head=False)
    check(forward == {"q4k_matmul": 224, "q8_matmul": 1} and recomputed == {"q4k_matmul": 224},
          f"kernels at M = {m}: {forward}, {recomputed}")
    kinds = {}
    for k in planar:
        pw = base[k]
        kind = f"{pw.kind} {'compact' if pw.d is not None else 'planes'} K={pw.k}"
        kinds[kind] = kinds.get(kind, 0) + 1
    out["plane_kinds"] = kinds
    before = tensor_checksums(torch, base)
    print(f"  loaded as planes with load_params(keep_quantized=True) in {out['load_s']:.1f}s "
          f"({torch.cuda.memory_allocated() / 1e9:.2f} GB on the card); plane kinds {kinds}; at M = {m}: "
          f"{forward} a forward")
    rng = np.random.default_rng(1)
    x, y = (torch.from_numpy(rng.integers(0, cfg.n_vocab, (batch, seq))).cuda() for _ in range(2))
    per_step = {}
    for policy in (None, REMAT):
        name = policy or "none"
        gc.collect()
        torch.cuda.empty_cache()
        lora = init_lora(base, rank)
        lm_fn = make_lm_model_fn(llama, cfg, seq, batch, remat_policy=policy)
        model_fn = lambda p, t, frozen: lm_fn(wrap_lora(frozen, p, 1.0), t)  # alpha = rank
        opt = Optimizer(model_fn, lora, loss_type="cross_entropy_sparse", adamw=AdamWConfig(alpha=lr), frozen=base)
        t0 = time.perf_counter()
        run = timed_training(torch, np, opt, x, y, steps)
        per_step[name] = {k: v // steps for k, v in run["counts"].items() if v}
        want = {k: 0 for k in run["counts"]}
        want.update(q4k_matmul=(224 + (224 if policy else 0)) * steps, q8_matmul=steps)
        check(run["counts"] == want, f"4p, remat {name}: launches {run['counts']}, want {want}")
        check(all(np.isfinite(run["losses"])), f"4p, remat {name}: losses {run['losses']}")
        for k, v in run["counts"].items():
            out["counts"][k] = out["counts"].get(k, 0) + v
        run["profiled_step"] = profiled_training_step(torch, opt, x, y)
        run["adapters"] = len(lora)
        run["run_s"] = time.perf_counter() - t0  # the warm, timed and profiled steps and the peak's pass
        out["runs"][name] = run
        if policy:
            trained = _clone_tree(torch, opt.params)
            adapter = os.path.join(tmp, "llama-qlora-adapter.gguf")
            save_lora_gguf(adapter, trained, alpha=float(rank), base_arch="llama")
            loaded, alpha = load_lora_gguf(adapter)
            reloaded = Optimizer(model_fn, {k: {kk: v.cuda() for kk, v in ab.items()} for k, ab in loaded.items()},
                                 loss_type="cross_entropy_sparse", frozen=base)
            l_mem, l_file = float(opt.eval(x, y)["loss"]), float(reloaded.eval(x, y)["loss"])
            out.update(adapter_bytes=os.path.getsize(adapter), eval_loss=l_mem, eval_loss_reloaded=l_file)
            check(alpha == rank and abs(l_mem - l_file) <= 1e-6 * abs(l_mem),
                  f"4p adapter round trip: alpha {alpha}, eval loss {l_mem} in memory, {l_file} from the file")
            del reloaded
        del opt, lora
    out["remat_against_none"] = compare_remat(torch, "4p", out["runs"], exact=False)
    check(tensor_checksums(torch, base) == before, "4p: the base planes changed")
    out["launches_per_step"] = per_step
    _remat_line("Llama-3-8B Q4_K QLoRA (rank 16, 2 x 512)", out["runs"], per_step)
    _profile_lines(out["runs"])
    print(f"  adapter GGUF {out['adapter_bytes'] / 1e6:.2f} MB: Optimizer.eval loss {out['eval_loss']:.6f} in memory, "
          f"{out['eval_loss_reloaded']:.6f} from the file; remat against none: {out['remat_against_none']}")
    del base
    gc.collect()
    torch.cuda.empty_cache()

    # generate --lora on Llama-3-8B's widths cut to 2 layers (a dense merge of
    # 32 layers would take minutes), with the trained adapters of layers 0 and 1
    cut = dataclasses.replace(cfg, n_layer=2)
    small = os.path.join(tmp, "llama3-8b-2-layers.gguf")
    t0 = time.perf_counter()
    llama.write_random_gguf(small, cut, seed=0, types={"output.weight": GGMLType.Q6_K})
    small_adapter = os.path.join(tmp, "llama-2-layers-adapter.gguf")
    save_lora_gguf(small_adapter, {k: v for k, v in trained.items() if k.startswith(("blk.0.", "blk.1."))},
                   alpha=float(rank), base_arch="llama")
    out["lora_file_write_s"] = time.perf_counter() - t0
    prompt = [int(t) for t in np.random.default_rng(2).integers(0, cfg.n_vocab, 8)]
    text = " ".join(map(str, prompt))
    cmd = [sys.executable, "-m", "ggml_tpu_torch.cli.generate", small, "-p", text, "-n", "16", "--top-k", "1",
           "--seed", "0", "--lora", small_adapter]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    out["lora_cli_wall_s"] = time.perf_counter() - t0
    check(r.returncode == 0 and r.stdout.startswith(text), f"generate --lora exited {r.returncode}:\n"
          f"{r.stderr[-4000:]}")
    cli_ids = [int(t) for t in r.stdout[len(text):].split()]
    t0 = time.perf_counter()
    model = llama.Llama.from_gguf(small, keep_quantized=False, max_seq=512, device="cuda")  # the CLI's load
    model.params = apply_lora_to_params(model.params, small_adapter, cfg=model.cfg)
    out["lora_load_merge_s"] = time.perf_counter() - t0
    ids = model.generate(np.asarray([prompt]), 16)
    check(cli_ids == ids, f"generate --lora ids {cli_ids}, in process {ids}")
    out["lora_cli_ids"] = ids
    del model
    print(f"  generate --lora (Llama-3-8B widths, 2 layers, dense bf16 + the adapters of layers 0-1): files written "
          f"in {out['lora_file_write_s']:.1f}s, the CLI exit 0 in {out['lora_cli_wall_s']:.1f}s, loaded and merged "
          f"here in {out['lora_load_merge_s']:.1f}s; its 16 greedy ids equal this process's")
    for f in (small, small_adapter):
        os.remove(f)
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_mnist(torch, np, tmp: str, card: str) -> dict:
    """4q: MNIST through opt.fit at the JAX package's tests/test_mnist.py
    settings: synthetic_mnist n 2048 seed 1, batch 256, val_split 0.125,
    the fc model 4 epochs at lr 1e-3 and the cnn 3 epochs at 3e-3 (AdamW,
    cross entropy), each gated at validation accuracy > 0.92; then
    bench_mnist's eval (bench.py:231-259): init_fc(0) over 10000 seeded
    images, one batch, µs/image on the host's clock with the logits back
    on the host (three timings), and the same for the cnn; a reference-
    format GGUF of the trained parameters written from the card and loaded
    back onto it bit for bit.  No kernel of the port runs here (cuBLAS,
    cuDNN: JAX's MNIST runs no Pallas kernel either)."""
    from ggml_tpu_torch.models import mnist
    from ggml_tpu_torch.opt import AdamWConfig, Dataset, Optimizer, fit

    images, onehot, _ = mnist.synthetic_mnist(2048, seed=1)
    evals = torch.from_numpy(np.random.default_rng(0).random((10000, 28, 28)).astype(np.float32)).cuda()
    out = dict(card=card, n=2048, batch=256, val_split=0.125)
    reset_launches()
    for kind, init, fwd, epochs, lr in (("fc", mnist.init_fc, mnist.fc_forward, 4, 1e-3),
                                        ("cnn", mnist.init_cnn, mnist.cnn_forward, 3, 3e-3)):
        opt = Optimizer(fwd, init(0, device="cuda"), loss_type="cross_entropy", adamw=AdamWConfig(alpha=lr))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        train, ev = fit(opt, Dataset(images, onehot), batch_size=256, epochs=epochs, val_split=0.125, silent=True)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        acc, acc_unc = ev.accuracy()
        loss, loss_unc = ev.loss()
        check(acc > 0.92, f"MNIST {kind}: validation accuracy {acc}")
        path = os.path.join(tmp, f"mnist-{kind}.gguf")
        mnist.save_gguf(opt.params, path)
        back = mnist.load_gguf(path, device="cuda")
        check(all(torch.equal(back[k], v) for k, v in opt.params.items()), f"MNIST {kind}: the GGUF round trip")
        os.remove(path)
        params = init(0, device="cuda")
        with torch.no_grad():
            fwd(params, evals).cpu()  # warm: cuBLAS and cuDNN handles, the algorithm choice
            us = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                logits = fwd(params, evals).cpu()
                us.append((time.perf_counter() - t0) / evals.shape[0] * 1e6)
        check(logits.shape == (10000, 10) and bool(torch.isfinite(logits).all()), f"MNIST {kind} eval logits")
        finite = lambda v: v if np.isfinite(v) else None  # one validation batch: no stderr of its loss
        out[kind] = dict(epochs=epochs, lr=lr, fit_s=fit_s, val_accuracy=acc, val_accuracy_stderr=finite(acc_unc),
                         val_loss=loss, val_loss_stderr=finite(loss_unc), train_loss_last_epoch=train.loss()[0],
                         eval_us_per_image=us, gguf_round_trip="bit for bit")
        print(f"  {kind}: fit {epochs} epochs in {fit_s:.2f}s, validation accuracy {acc * 100:.2f} +- "
              f"{acc_unc * 100:.2f} %, loss {loss:.4f} +- {loss_unc:.4f}; eval of 10000 images "
              + ", ".join(f"{u:.4f}" for u in us) + f" us/image ({card}); GGUF round trip bit for bit")
    out["counts"] = launch_counts()
    check(not any(out["counts"].values()), f"MNIST launched the port's kernels: {out['counts']}")
    return out


# the eleven IQ* and TQ* GGUF types, in the order phase 4d's tiny file cycles them
IQ_TYPES = ("IQ4_NL", "IQ4_XS", "IQ3_S", "IQ3_XXS", "IQ2_S", "IQ2_XS", "IQ2_XXS", "IQ1_M", "IQ1_S", "TQ2_0", "TQ1_0")


def phase_iquants(torch, np, tmp: str, card: str, n_layer: int = 28) -> list:
    """4k: GPT-J-6B at its published widths (n_layer of its 28 layers) from three GGUF files written
    into tmp by write_random_gguf with every 2-D weight in one type: IQ4_XS
    (groups of 32: E at decode, G at prefill), IQ1_M (groups of 8 with
    offsets) and TQ2_0 (groups of 256), which take G at every M.  Each file
    loads as planes through GPTJ.from_gguf (what `generate --quantized`
    does), is deleted, and serves greedy requests through phase_gptj
    (prompts 8 and 100; IQ1_M also 1024, through J and G at M = 1024):
    graph replays, the first request again eagerly with the same ids, exact
    launch counts (q, k, v and ffn_up apart: 6 linears a layer and the head
    a decode token, 169 at 28 layers),
    ms/token beside the plane-byte floor, and profiled decode tokens by
    class."""
    import gc

    from ggml_tpu_torch.dtypes import GGMLType
    from ggml_tpu_torch.models import gptj
    from ggml_tpu_torch.quant.planar import PlanarWeight

    cfg = dataclasses.replace(gptj.GPTJConfig(), n_layer=n_layer)  # EleutherAI/gpt-j-6b
    e_kernels = dict(decode="q8_gemv", rows="q8_gemv", matmul="q8_matmul")
    g_kernels = dict(decode="q8_matmul", rows="q8_matmul", matmul="q8_matmul")
    runs = []
    for t, kernels, prompts, max_seq in ((GGMLType.IQ4_XS, e_kernels, (8, 100), 256),
                                         (GGMLType.IQ1_M, g_kernels, (8, 100, 1024), 2048),
                                         (GGMLType.TQ2_0, g_kernels, (8, 100), 256)):
        label = t.name.lower()
        path = os.path.join(tmp, f"gpt-j-6b-{label}.gguf")
        t0 = time.perf_counter()
        gptj.write_random_gguf(path, cfg, seed=0, types=dict.fromkeys(gptj.matmul_weight_names(cfg), t))
        write_s, gguf_bytes = time.perf_counter() - t0, os.path.getsize(path)
        t0 = time.perf_counter()
        model = gptj.GPTJ.from_gguf(path, max_seq=max_seq, device="cuda")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        os.remove(path)
        print(f"  {t.name}: wrote {gguf_bytes / 1e9:.3f} GB of GGUF in {write_s:.1f}s, loaded as planes in "
              f"{load_s:.1f}s ({card})")
        run = phase_gptj(torch, np, label, model.params, kernels, prompts, profile=True, max_seq=max_seq, cfg=cfg)
        req = run["requests"][0]  # prompt 8: its prefill of 8 tokens is one launch of each linear too
        linears = sum(1 for k, v in model.params.items() if isinstance(v, PlanarWeight) and k != "token_embd.weight")
        per_token = {k: (v - (linears if k == kernels["rows"] else 0)) / 63 for k, v in req["launches"].items() if v}
        graphed = run["graphed_decode_trace"]
        run.update(type=t.name, gguf_write_s=write_s, gguf_bytes=gguf_bytes, load_s=load_s,
                   launches_per_decode_token=per_token, floor_ms=run["plane_bytes"] / HBM_BYTES_PER_S * 1e3,
                   n_layer=cfg.n_layer)
        check(per_token[kernels["decode"]] == linears == 6 * cfg.n_layer + 1,
              f"{label}: launches per decode token {per_token}")
        print(f"  {t.name} ({card}, {cfg.n_layer} layers): load {load_s:.1f}s; launches a decode token {per_token}; "
              "graphed decode "
              + ", ".join(f"{r['decode_ms_per_token']:.3f}" for r in run["requests"])
              + f" ms/token (prompts {', '.join(str(r['prompt']) for r in run['requests'])}; eager "
              f"{req['eager_decode_ms_per_token']:.3f}, the same ids) against a floor of {run['floor_ms']:.3f} "
              f"({run['plane_bytes'] / 1e9:.3f} GB at {HBM_BYTES_PER_S / 1e12:.2f} TB/s); a graphed token: host "
              f"{graphed['host_ms_per_token']:.3f} ms, device busy {graphed['device_ms_per_token']:.3f}, "
              + ", ".join(f"{k} {v:.3f}" for k, v in graphed["port_kernels_ms_per_token"].items())
              + f", other ops {graphed['other_device_ms_per_token']:.3f}")
        runs.append(run)
        del model, run
        gc.collect()  # a model and its decode graphs form a reference cycle
        torch.cuda.empty_cache()
    return runs


# 4l: the Llama family at Llama-3-8B's published widths, from a Q4_K GGUF file
LLAMA3_8B_GGUF = "meta-llama-3-8b-q4_k.gguf"
# planar launches of one Llama-3-8B decode token by wrapper: A on the 192
# linears at K = 4096 (q, k, v, attn_output, ffn_gate, ffn_up), H on the 32
# ffn_down (K = 14336: expanded planes), F on the Q6_K head
LLAMA_DECODE_LAUNCHES = {"q4k_gemv_qact": 192, "q4_gemv": 32, "q8_gemv_sb": 1}


def write_llama3_8b_gguf(np, tmp: str) -> tuple:
    """The GGUF file phase 4l reads, written into the directory tmp with the
    port's writer (models/llama.write_random_gguf): Llama-3-8B's published
    widths, every 2-D weight Q4_K but output.weight Q6_K (as llama.cpp's
    Q4_K_S and Q4_K_M files keep the head), F32 norms, a byte-level BPE
    vocabulary of 128256 entries (tokenizer.ggml.model gpt2, as Llama 3's
    files have: the 256 byte symbols, the merges learned from
    FRONT_END_TEXT, lowercase placeholder words, then <|begin_of_text|> at
    128000, <|end_of_text|> at 128001 and reserved special tokens).  Returns
    (path, dict(gguf_write_s, gguf_bytes), tokens, merges)."""
    from ggml_tpu_torch.dtypes import GGMLType
    from ggml_tpu_torch.models import llama
    from ggml_tpu_torch.tokenizer import byte_level_vocab, learn_merges

    cfg = llama.llama3_8b_config()
    merges = learn_merges(FRONT_END_TEXT, 100_000)  # until every word is one symbol
    tokens = byte_level_vocab(merges)
    bos, eos = 128000, 128001
    tokens = (tokens + _placeholders(set(tokens), bos - len(tokens)) + ["<|begin_of_text|>", "<|end_of_text|>"]
              + [f"<|reserved_special_token_{i}|>" for i in range(cfg.n_vocab - bos - 2)])
    check(len(tokens) == cfg.n_vocab and len(set(tokens)) == len(tokens), f"vocabulary of {len(tokens)} entries")
    path = os.path.join(tmp, LLAMA3_8B_GGUF)
    t0 = time.perf_counter()
    llama.write_random_gguf(path, cfg, seed=0, types={"output.weight": GGMLType.Q6_K},
                            tokenizer=dict(model="gpt2", tokens=tokens, merges=merges, bos_token_id=bos,
                                           eos_token_id=eos))
    info = dict(gguf_write_s=time.perf_counter() - t0, gguf_bytes=os.path.getsize(path))
    print(f"  wrote {info['gguf_bytes'] / 1e9:.3f} GB of GGUF ({len(merges)} merges) in {info['gguf_write_s']:.1f}s")
    return path, info, tokens, merges


# a graphed token's kernels by class: the GEMV pipeline's instances by their
# plane layout (Planes<nibbles, compact, ...>), C and G by name, and, in an
# eager profile, the ops inside the expansion and attention ranges
_GEMV_CLASS = {("true", "true"): "A", ("true", "false"): "H", ("false", "true"): "F", ("false", "false"): "E"}


_LLAMA_RANGES = ("planar_matmul.expand_compact", "llama.attention")


def _llama_class(event, kernel: str) -> str:
    m = re.search(r"Planes<(true|false), (true|false)", kernel)
    if m:
        return _GEMV_CLASS[m[1], m[2]]
    if "q4k_matmul_kernel" in kernel or "qmatmul_xsum_kernel" in kernel:
        return "C"
    if "q8_matmul_kernel" in kernel:
        return "G"
    while event is not None:
        if event.name == "planar_matmul.expand_compact":
            return "H expansions"
        if event.name == "llama.attention":
            return "attention"
        event = event.cpu_parent
    return "other"


def profile_llama_decode(torch, np, model, steps: int = 32, prompt: int = 8) -> dict:
    """Llama decode after a `prompt`-token prompt (after the launch counters
    are read): host ms/token of `steps` graphed replays, then under
    torch.profiler the same request again: device busy a token (copies
    included), the idle share 1 - busy / host, and busy by class from the
    kernels' names (A, H, F; the expansions and the attention's ops are
    PyTorch kernels in "other" there); then 8 eager steps, where the ops
    of the ranges planar_matmul.expand_compact and llama.attention are
    booked to "H expansions" and "attention"."""
    from torch.profiler import ProfilerActivity, profile

    def request():
        logits, cache, n_past = model.prefill(model.new_cache(torch.bfloat16), np.arange(prompt)[None])
        first = torch.argmax(logits, dim=-1, keepdim=True)
        torch.cuda.synchronize()
        return cache, first, n_past

    cache, first, n_past = request()
    t0 = time.perf_counter()
    model.decode_greedy(cache, first, n_past, steps)  # returns the ids to the host: the card is done
    host_ms = (time.perf_counter() - t0) * 1e3 / steps
    cache, first, n_past = request()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        model.decode_greedy(cache, first, n_past, steps)
        torch.cuda.synchronize()
    events = _device_events(prof)
    busy = sum(e.self_device_time_total for e in events) / steps / 1e3
    graphed = {}
    for e in events:
        cls = _llama_class(None, e.key)
        graphed[cls] = graphed.get(cls, 0.0) + e.self_device_time_total / steps / 1e3
    cache, first, n_past = request()
    eager_steps = 8
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        model.decode_greedy(cache, first, n_past, eager_steps, graph=False)
        torch.cuda.synchronize()
    # the two ranges from the kernels the profiler ties to the ops that
    # launched them (it ties no kernel to a cudaLaunchKernelExC, the GEMVs'
    # launch), every other class from the device events by name
    eager = {}
    for e in _device_events(prof):
        if e.key in _LLAMA_RANGES or getattr(e, "is_user_annotation", False):
            continue  # a range's device span: its kernels, and the gaps between them
        cls = _llama_class(None, e.key)
        eager[cls] = eager.get(cls, 0.0) + e.self_device_time_total / eager_steps / 1e3
    for e in prof.events():
        for k in getattr(e, "kernels", ()):
            cls = _llama_class(e, k.name)
            if cls in ("H expansions", "attention"):
                eager[cls] = eager.get(cls, 0.0) + k.duration / eager_steps / 1e3
                eager["other"] -= k.duration / eager_steps / 1e3
    launches = sum(e.count for e in prof.key_averages() if e.key.startswith("cudaLaunchKernel")) / eager_steps
    trace = dict(steps=steps, prompt=prompt, host_ms_per_token=host_ms, device_ms_per_token=busy,
                 idle_share=1.0 - busy / host_ms, graphed_ms_per_token_by_class=graphed,
                 eager_ms_per_token_by_class=eager, eager_launches_per_token=launches)
    fmt = lambda d: ", ".join(f"{k} {v:.3f}" for k, v in sorted(d.items(), key=lambda kv: -kv[1]))
    print(f"  graphed decode, {steps} steps at pos {prompt}..{prompt + steps - 1}: host {host_ms:.3f} ms/token, "
          f"device busy {busy:.3f} (idle {trace['idle_share'] * 100:.1f} %); by class (ms/token): {fmt(graphed)}")
    print(f"  eager decode, {eager_steps} steps, {launches:.0f} kernel launches/token; device ms/token by class: "
          f"{fmt(eager)}")
    return trace


def llama_flash_against_plain_attention(torch, np, model, t: int) -> dict:
    """flash_against_plain_attention for a Llama: logits at every position
    of a t-token prefill over the model's first layer at full width, through
    J (f32 q and k, bf16 v, p rounded to bf16 before it is normalized), and
    through the plain GQA attention over the cache window (flash_min_seq out
    of reach) twice: over the model's bf16 cache (the decode path: k read
    back rounded to bf16, the normalized p rounded to bf16) and over an f32
    cache (k, p and the product in f32: the reference).  Gate: J against the
    f32 reference, NMSE <= 1e-4; J against the bf16 path and the bf16 path
    against the reference are printed (the second is the plain path's own
    rounding)."""
    from ggml_tpu_torch.models import llama

    prompt = torch.from_numpy(np.random.default_rng(t).integers(0, model.cfg.n_vocab, (1, t))).to(model.device)
    zero = torch.zeros((), dtype=torch.int32, device=model.device)

    def logits(cache_dtype=torch.bfloat16, **changes):
        cfg = dataclasses.replace(model.cfg, n_layer=1, **changes)
        cache = llama.init_cache(cfg, 1, model.max_seq, cache_dtype, model.device)
        return llama.forward(model.params, cfg, prompt, zero.expand(1), cache, zero, prefill=True)[0]

    flash, plain, ref = logits(), logits(flash_min_seq=1 << 30), logits(torch.float32, flash_min_seq=1 << 30)
    out = dict(flash_vs_f32_plain=errors(ref, flash)[0], flash_vs_bf16_plain=errors(plain, flash)[0],
               bf16_plain_vs_f32_plain=errors(ref, plain)[0])
    print(f"  {t}-token prefill over one layer at full width, logits at every position: flash against the plain "
          f"attention over an f32 cache NMSE {out['flash_vs_f32_plain']:.2e}, against the plain attention over the "
          f"bf16 cache {out['flash_vs_bf16_plain']:.2e}; the bf16-cache plain attention against the f32 one "
          f"{out['bf16_plain_vs_f32_plain']:.2e}")
    check(out["flash_vs_f32_plain"] <= 1e-4,
          f"Llama flash prefill against plain f32 attention over one layer: NMSE "
          f"{out['flash_vs_f32_plain']:.2e} > 1e-4")
    return out


def tiny_llama_params(torch, cfg, seed: int, biases: bool = False, tied: bool = False) -> dict:
    """Random f32 parameters of a small llama-family model on the CPU (norm
    weights near 1; q/k/v biases and per-head q/k norms where asked)."""
    gen = torch.Generator().manual_seed(seed)
    w = lambda *shape, s=0.05: torch.randn(shape, generator=gen) * s
    near_one = lambda n: 1 + 0.1 * torch.randn((n,), generator=gen)
    E, hd = cfg.n_embd, cfg.head_dim
    p = {"token_embd.weight": w(cfg.n_vocab, E, s=0.5), "output_norm.weight": near_one(E)}
    if not tied:
        p["output.weight"] = w(cfg.n_vocab, E)
    for i in range(cfg.n_layer):
        pre = f"blk.{i}."
        p[pre + "attn_norm.weight"] = near_one(E)
        for name, n in (("attn_q", cfg.n_head * hd), ("attn_k", cfg.n_head_kv * hd), ("attn_v", cfg.n_head_kv * hd)):
            p[pre + name + ".weight"] = w(n, E)
            if biases:
                p[pre + name + ".bias"] = w(n, s=0.1)
        if cfg.qk_norm:
            p[pre + "attn_q_norm.weight"], p[pre + "attn_k_norm.weight"] = near_one(hd), near_one(hd)
        p[pre + "attn_output.weight"] = w(E, cfg.n_head * hd)
        p[pre + "ffn_norm.weight"] = near_one(E)
        p[pre + "ffn_gate.weight"], p[pre + "ffn_up.weight"] = w(cfg.n_ff, E), w(cfg.n_ff, E)
        p[pre + "ffn_down.weight"] = w(E, cfg.n_ff)
    return p


def phase_tiny_llama(torch, np, tmp: str) -> dict:
    """Tiny Llamas on the card (kernels, cuBLAS) against the same weights on
    the CPU (plain versions), fed the same tokens: a GGUF file of Q4_K
    weights with a Q6_K head (E 512, GQA 4/2, head_dim 128, n_ff 10240:
    ffn_down's planes are expanded for H, as at 8B), prefill of 40 tokens (C,
    G: NMSE <= 5e-5; GPT-J's 1e-5 read 1.02e-5 here: every activation is
    rounded to bf16 before a product, a last-bit difference of the card's
    sums, rsqrt, sin or cos flips some of those roundings, and the SwiGLU
    over 10240 columns spreads them; against JAX on the CPU the same prefill
    reads 3.1e-6), then 8 decode steps (A, H, F) over the cache rows that
    prefill wrote (<= 2e-3: those rows differ by the same roundings, and
    each int8 activation code a difference moves costs 1e-4 to 4e-4;
    7.35e-4 was read), and of 5 (B, H, F: integer sums) with 8 decode steps
    (<= 5e-4, as GPT-J's); then dense f32 variants (qwen2 biases with a tied output,
    qwen3 q/k norms with head_dim 48, granite scales, smollm3 NoPE, ernie4_5
    interleaved RoPE, YaRN) with 6-token prompts and 3 decode steps (<=
    5e-4); then the Q4_K model in bf16 on the card, flash prefill against its
    own plain-attention prefill over an f32 cache, over one layer (<= 1e-4),
    and over its bf16 cache (printed)."""
    from ggml_tpu_torch.dtypes import GGMLType
    from ggml_tpu_torch.models import llama

    cfg = llama.LlamaConfig(n_vocab=512, n_ctx=128, n_embd=512, n_head=4, n_head_kv=2, n_layer=2, n_ff=10240,
                            rope_base=500000.0)
    path = os.path.join(tmp, "tiny-llama-q4_k.gguf")
    llama.write_random_gguf(path, cfg, seed=3, types={"output.weight": GGMLType.Q6_K})
    q4k = llama.Llama.from_gguf(path, dtype=torch.float32, device="cpu").params
    base = dict(n_vocab=96, n_ctx=128, n_embd=128, n_head=4, n_head_kv=2, n_layer=2, n_ff=192, rope_base=500000.0)
    dense = {"qwen2 biases, tied": ({}, dict(biases=True, tied=True)),
             "qwen3 q/k norm, head_dim 48": (dict(n_embd=96, qk_norm=True, head_dim_override=48), {}),
             "granite scales": (dict(embd_scale=12.0, resid_scale=0.22, attn_scale=0.0078125, logit_scale=8.0), {}),
             "smollm3 NoPE": (dict(nope_interval=2), {}), "ernie4_5 interleaved": (dict(rope_interleaved=True), {}),
             "yarn": (dict(rope_scaling="yarn", rope_scale=4.0, n_ctx_orig=32), {})}
    sets = [("q4_k+q6_k file", q4k, cfg, ((40, 5e-5, 2e-3), (5, 5e-4, 5e-4)), 8)]
    for i, (label, (over, opts)) in enumerate(dense.items()):
        vcfg = llama.LlamaConfig(**dict(base, **over))
        sets.append((label, tiny_llama_params(torch, vcfg, seed=10 + i, **opts), vcfg, ((6, 5e-4, 5e-4),), 3))
    out = {}
    for label, cpu_params, run_cfg, prompts, n_steps in sets:
        gpu_params = {k: copy.deepcopy(v).to("cuda") for k, v in cpu_params.items()}
        for t, gate, step_gate in prompts:
            prompt = torch.from_numpy(np.random.default_rng(t).integers(0, run_cfg.n_vocab, (1, t)))
            runs = []
            for params, dev in ((cpu_params, "cpu"), (gpu_params, "cuda")):
                cache = llama.init_cache(run_cfg, 1, 64, torch.float32, dev)
                zero = torch.zeros((), dtype=torch.int32, device=dev)
                runs.append([llama.forward(params, run_cfg, prompt.to(dev), zero.expand(1), cache, zero,
                                           prefill=True)[0][:, -1].cpu(), cache, dev])
            nm, _ = errors(runs[0][0], runs[1][0])
            check(nm <= gate, f"tiny Llama {label}, prefill {t}: card vs CPU NMSE {nm:.2e} > {gate:g}")
            worst, tok = 0.0, int(torch.argmax(runs[0][0]))
            for step in range(n_steps):
                step_logits = []
                for params, (_, cache, dev) in zip((cpu_params, gpu_params), runs):
                    pos = torch.tensor(t + step, dtype=torch.int32, device=dev)
                    step_logits.append(llama.forward(params, run_cfg, torch.tensor([[tok]], device=dev),
                                                     pos.expand(1), cache, pos)[0][0, -1].cpu())
                worst = max(worst, errors(*step_logits)[0])
                tok = int(torch.argmax(step_logits[0]))
            check(worst <= step_gate, f"tiny Llama {label}, decode after {t}: card vs CPU NMSE {worst:.2e} > "
                  f"{step_gate:g}")
            out[f"{label}/{t}"] = dict(prefill_nmse=nm, decode_worst_nmse=worst)
            print(f"  tiny Llama {label}, prompt {t}: prefill NMSE {nm:.2e}, {n_steps} decode steps worst NMSE "
                  f"{worst:.2e}")

    # the bf16 flash kernel under GQA inside the model, against the plain
    # attention's prefill over an f32 cache and over the bf16 cache, one layer
    # and two (see llama_flash_against_plain_attention)
    params = llama.Llama.from_gguf(path, dtype=torch.bfloat16, device="cuda").params
    prompt = torch.from_numpy(np.random.default_rng(40).integers(0, cfg.n_vocab, (1, 40))).cuda()
    zero = torch.zeros((), dtype=torch.int32, device="cuda")
    nms = {}
    for depth in (1, cfg.n_layer):
        run = lambda cache_dtype, **kw: llama.forward(
            params, dataclasses.replace(cfg, n_layer=depth, **kw), prompt, zero.expand(1),
            llama.init_cache(cfg, 1, 64, cache_dtype), zero, prefill=True)[0].float()
        flash, plain, ref = run(torch.bfloat16, use_flash_prefill=True), run(torch.bfloat16), run(torch.float32)
        nms[depth] = dict(flash_vs_f32_plain=errors(ref, flash)[0], flash_vs_bf16_plain=errors(plain, flash)[0],
                          bf16_plain_vs_f32_plain=errors(ref, plain)[0])
    check(nms[1]["flash_vs_f32_plain"] <= 1e-4, f"tiny bf16 Llama, flash against plain f32 attention over one layer: "
          f"NMSE {nms[1]['flash_vs_f32_plain']:.2e}")
    out["q4_k bf16 flash vs plain attention"] = nms
    print(f"  tiny bf16 Llama q4_k (GQA 4/2), prompt 40, flash prefill on the card over one layer / two: against "
          f"the plain attention over an f32 cache NMSE {nms[1]['flash_vs_f32_plain']:.2e} / "
          f"{nms[2]['flash_vs_f32_plain']:.2e}, over the bf16 cache {nms[1]['flash_vs_bf16_plain']:.2e} / "
          f"{nms[2]['flash_vs_bf16_plain']:.2e}")
    return out


def phase_llama(torch, np, tmp: str, card: str, serve: bool = False, train: bool = False) -> dict:
    """4l: Llama-3-8B at its published widths (meta-llama/Meta-Llama-3-8B
    config.json: vocab 128256, E 4096, 32 layers, 32 heads over 8 kv heads,
    head_dim 128, n_ff 14336, rope base 500000, context 8192, untied head)
    from the Q4_K GGUF file write_llama3_8b_gguf writes into tmp, loaded as
    planes through Llama.from_gguf (what `generate --quantized` does):
    greedy requests of 64 tokens from prompts of 8 and 100 decoded as graph
    replays with exact launch counts (225 planar launches a decode token,
    LLAMA_DECODE_LAUNCHES), the first again eagerly (the same ids), a seeded
    sampled request (twice, eagerly, and with top_k = 1 against the greedy
    ids), a 1024-token prefill at max_seq 2048 through J (32 launches with
    their split, the mask ranges once) and C, flash against plain attention
    over one layer, the generate CLI as a subprocess (its text against this
    process's greedy text at the CLI's max_seq), a profiled prefill and
    profiled decode by class; then tiny Llamas on the card against the CPU."""
    import gc

    from ggml_tpu_torch.models import llama
    from ggml_tpu_torch.quant.planar import PlanarWeight
    from ggml_tpu_torch.tokenizer import BPETokenizer

    gc.collect()  # earlier phases' models and their decode graphs form reference cycles
    torch.cuda.empty_cache()
    path, info, tokens, merges = write_llama3_8b_gguf(np, tmp)
    out = dict(info)
    t0 = time.perf_counter()
    model = llama.Llama.from_gguf(path, max_seq=2048, device="cuda")
    torch.cuda.synchronize()
    out["load_s"] = time.perf_counter() - t0
    cfg = model.cfg
    want_cfg = llama.llama3_8b_config()
    check(dataclasses.replace(cfg, rms_eps=want_cfg.rms_eps) == want_cfg, f"config {cfg}")
    planar = {k: v for k, v in model.params.items() if isinstance(v, PlanarWeight) and k != "token_embd.weight"}
    check(len(planar) == 7 * cfg.n_layer + 1, f"{len(planar)} planar linears")
    plane_bytes = sum(v.plane_bytes() for v in planar.values())
    out.update(plane_bytes=plane_bytes, floor_ms=plane_bytes / HBM_BYTES_PER_S * 1e3)
    print(f"  loaded as planes in {out['load_s']:.1f}s ({card}); {plane_bytes / 1e9:.3f} GB of planes read per "
          f"decode token: floor {out['floor_ms']:.3f} ms/token at {HBM_BYTES_PER_S / 1e12:.2f} TB/s")
    for t in (8, 100, 1024):  # warm-up of each path: first-use allocations, library handles, the decode graph
        model.generate(np.arange(t)[None], 4)
    torch.cuda.synchronize()
    captures = lambda m: sum(g.captures for g in m.decode_graphs.values())
    captured = captures(model)

    n_gen, linears = 64, 7 * cfg.n_layer
    rng = np.random.default_rng(0)
    reset_launches()
    requests = []
    for t in (8, 100):
        before = launch_counts()
        prompt = rng.integers(0, cfg.n_vocab, (1, t))
        first, ids, t0, t1, t2, finite, event_ms = greedy_request(torch, model, prompt, n_gen - 1, graph=True)
        delta = {k: v - before[k] for k, v in launch_counts().items()}
        want = dict.fromkeys(delta, 0)
        for k, n in LLAMA_DECODE_LAUNCHES.items():
            want[k] += n * (n_gen - 1)
        if t <= 32:  # B on the K = 4096 linears, H on ffn_down, F on the head
            want["q4k_gemv_rows"] += linears - cfg.n_layer
            want["q4_gemv"] += cfg.n_layer
            want["q8_gemv_sb"] += 1
        else:  # C on every Q4_K linear, G on the head
            want["q4k_matmul"] += linears
            want["q8_matmul"] += 1
        toks = [first] + ids
        check(finite and len(toks) == n_gen and all(0 <= x < cfg.n_vocab for x in toks),
              f"Llama-3-8B, prompt {t}: tokens {toks[:8]}..., finite {finite}")
        check(delta == want, f"Llama-3-8B, prompt {t}: launches {delta}, want {want}")
        dec_ms = (t2 - t1) * 1e3 / (n_gen - 1)
        req = dict(prompt=t, prefill_ms=(t1 - t0) * 1e3, decode_ms_per_token=dec_ms, decode_event_ms_per_token=event_ms,
                   plane_gb_per_s=plane_bytes / (dec_ms * 1e-3) / 1e9, launches=delta, first_tokens=toks[:8],
                   prompt_tokens=prompt, ids=toks)
        requests.append(req)
        print(f"  request prompt={t:4d}: prefill {req['prefill_ms']:.1f} ms, decode {dec_ms:.3f} ms/token graphed "
              f"({event_ms:.3f} between CUDA events; {req['plane_gb_per_s']:.0f} GB/s of planes)")
    decode_only = dict(requests[0]["launches"])
    decode_only["q4k_gemv_rows"] -= linears - cfg.n_layer
    decode_only["q4_gemv"] -= cfg.n_layer
    decode_only["q8_gemv_sb"] -= 1
    per_token = {k: v / (n_gen - 1) for k, v in decode_only.items() if v}
    out["launches_per_decode_token"] = per_token
    print(f"  launches a decode token: {per_token} ({sum(per_token.values()):.0f} planar kernels; each H call "
          "expands its compact planes first)")

    before = launch_counts()
    prompt = rng.integers(0, cfg.n_vocab, (1, 1024))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, _, _ = model.prefill(model.new_cache(torch.bfloat16), prompt)
    finite = bool(torch.isfinite(logits).all())
    torch.cuda.synchronize()
    out["prefill_1024_ms"] = (time.perf_counter() - t0) * 1e3
    delta = {k: v - before[k] for k, v in launch_counts().items()}
    want = dict.fromkeys(delta, 0)
    want.update(q4k_matmul=linears, q8_matmul=1, flash_attn=cfg.n_layer, flash_split=cfg.n_layer, flash_mask_ranges=1)
    check(finite and delta == want, f"Llama-3-8B 1024-token prefill: launches {delta}, want {want}, finite {finite}")
    print(f"  1024-token prefill (max_seq 2048): {out['prefill_1024_ms']:.1f} ms, launches {delta}")
    counts = launch_counts()
    check(captures(model) == captured == 1, f"Llama-3-8B: {captures(model)} decode graphs captured, want 1")
    for name in ("q4k_gemv_qact", "q4k_gemv_rows", "q4k_matmul", "q4_gemv", "q8_gemv_sb", "q8_matmul", "flash_attn",
                 "flash_split", "flash_mask_ranges"):
        check(counts[name] > 0, f"Llama-3-8B: {name} was never launched on its main path")
    out["counts"] = counts

    req = requests[0]  # the first request again, eagerly: the same kernels in the same order
    _, ids, _, t1, t2, _, _ = greedy_request(torch, model, req["prompt_tokens"], n_gen - 1, graph=False)
    req["eager_decode_ms_per_token"] = (t2 - t1) * 1e3 / (n_gen - 1)
    check(ids == req["ids"][1:], f"Llama-3-8B, prompt 8: eager ids {ids[:8]}... differ from the graphed "
          f"{req['ids'][1:9]}...")
    print(f"  prompt=8: decode eager {req['eager_decode_ms_per_token']:.2f} / graphed {req['decode_ms_per_token']:.3f} "
          f"ms/token, the same {len(ids)} ids")
    out["sampled"] = sampled_requests(torch, model, req, n_gen)
    for r in requests:
        del r["prompt_tokens"], r["ids"]
    out["requests"] = requests
    out["flash_vs_plain_attention"] = llama_flash_against_plain_attention(torch, np, model, 1024)

    # the CLI as a user runs it, on the same file
    tok = BPETokenizer(tokens, merges)
    text = " ".join(FRONT_END_TEXT.split()[:48])
    prompt_ids = np.asarray([tok.encode(text)], np.int32)
    cmd = [sys.executable, "-m", "ggml_tpu_torch.cli.generate", path, "-p", text, "-n", "16", "--quantized",
           "--top-k", "1", "--seed", "0", "--verbose"]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    out["cli_wall_s"] = time.perf_counter() - t0
    check(r.returncode == 0, f"the generate CLI exited {r.returncode}:\n{r.stderr[-4000:]}")
    load = re.search(r"load time =\s*([\d.]+) ms", r.stderr)
    check(load is not None, f"no load time in the CLI's stderr:\n{r.stderr[-2000:]}")
    out["cli_load_s"] = float(load[1]) / 1e3
    report = re.findall(r"^\s+(q4|q8)\s+K=(\d+)\s+N=(\d+)\s+(gemv-M|matmul-M) -> (.+)$", r.stderr, re.M)
    out["cli_report"] = [" ".join(x) for x in report]
    kernel_of = {(kind, int(k), c): p for kind, k, _, c, p in report}
    check(len(report) == 10 and kernel_of == {
        ("q4", 4096, "gemv-M"): "q4k_gemv_qact", ("q4", 4096, "matmul-M"): "q4k_matmul",
        ("q4", 14336, "gemv-M"): "q4_gemv", ("q4", 14336, "matmul-M"): "q4k_matmul",
        ("q8", 4096, "gemv-M"): "q8_gemv_sb", ("q8", 4096, "matmul-M"): "q8_matmul"}, f"kernel report {report}")
    same = llama.Llama(model.params, cfg, max_seq=512, device="cuda")  # the CLI's max_seq
    ids = same.generate(prompt_ids, 16)
    check(r.stdout == text + tok.decode(ids) + "\n", f"CLI text {r.stdout[-200:]!r} differs from "
          f"{text + tok.decode(ids)!r}")
    del same
    print(f"  CLI (python -m ggml_tpu_torch.cli.generate --quantized --top-k 1 -n 16): exit 0 in "
          f"{out['cli_wall_s']:.1f}s, load {out['cli_load_s']:.1f}s, the text of this process's greedy request; "
          "report: " + "; ".join(out["cli_report"]))

    out["prefill_trace"] = profile_prefill(torch, np, model, 1024)
    out["decode_trace"] = profile_llama_decode(torch, np, model)
    if serve:
        stage("4m. serving: Llama-3-8B (the same model), 4 slots, and the HTTP server")
        out["serve"] = phase_serve_llama(torch, np, model, path, tokens, merges, card)
        stage("4n. serving: Llama-3-8B (the same model), 4 slots, paged and chunked engines")
        out["serve_paged_chunked"] = phase_serve_llama_paged(torch, np, model, card)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    if train:
        stage("4p. QLoRA of Llama-3-8B from the same file, rank 16, batch 2 x 512, with and without remat")
        out["qlora"] = phase_qlora_llama(torch, np, path, tmp, card)
    os.remove(path)
    out["tiny"] = phase_tiny_llama(torch, np, tmp)
    print(f"  Llama-3-8B ({card}): load {out['load_s']:.1f}s; graphed decode "
          + ", ".join(f"{r['decode_ms_per_token']:.3f}" for r in requests)
          + f" ms/token (prompts 8, 100; eager {req['eager_decode_ms_per_token']:.2f}) against a floor of "
          f"{out['floor_ms']:.3f}; 1024-token prefill {out['prefill_1024_ms']:.1f} ms")
    return out


# 4m: serving through serve.Engine (continuous batching) and cli/server.py.
# bench_serve's mix (bench.py:771-812): GPT-J-6B Q4_K, 8 slots, max_seq 256,
# bucket 32, a warm request, then 24 requests of 4-30-token prompts x 32 new
SERVE_SLOTS, SERVE_REQUESTS, SERVE_NEW, SERVE_BUCKET = 8, 24, 32, 32
# planar launches of one engine step (M = slots) by wrapper: GPT-J's
# synthesized planes take B on all 85 linears; Llama-3-8B's file takes B on
# the 192 K = 4096 linears, H on the 32 ffn_down (expanded planes), F on the head
GPTJ_STEP_LAUNCHES = {"q4k_gemv_rows": 85}
LLAMA_STEP_LAUNCHES = {"q4k_gemv_rows": 192, "q4_gemv": 32, "q8_gemv_sb": 1}


def _engine_delta(eng, before: dict) -> dict:
    return {k: v - before[k] for k, v in _engine_marks(eng).items()}


def _engine_marks(eng) -> dict:
    marks = dict(decode_steps=eng.decode_steps, replays=eng.replays, captures=eng.captures,
                 prefill_count=eng.prefill_count, chunk_dispatches=eng.chunk_dispatches,
                 cached_prefix_tokens=eng.cached_prefix_tokens)
    if eng.paged is not None:
        scan = eng._paged_scan
        marks.update(paged_replays=scan.replays, paged_steps=scan.steps, paged_captures=scan.captures)
    return marks


def _prefill_spans(eng) -> int:
    return sum(1 for kind, _, _ in eng.events if kind == "prefill")


def _first_step_logits(torch, np, eng, prompt, bucket: int):
    """The logits the engine's first step computes for `prompt` alone in slot
    0 (admitted through the batched prefill, then the re-decode of its last
    token at position t - 1 among max_batch rows), read by calling the
    family forward once over the engine's cache and state as _steps does."""
    rid = eng.submit(prompt, 1)
    eng._admit(bucket)
    eng._load_state(np.array([s is not None for s in eng.slots]), eng._slot_budget())
    with torch.no_grad():
        logits, _ = eng._fwd(eng.model.params, eng.cfg, eng._tok, eng._np, eng.cache, eng._np)
    eng.cancel(rid)
    eng.slots = [None] * eng.max_batch
    return logits[0, -1].float()


def profile_serve(torch, eng, prompts, max_new: int) -> dict:
    """One wave of the mix (its first max_batch requests: one batched
    prefill, then their decode) under torch.profiler, after the launch
    counters are read: the host's time, the device's busy time (kernels,
    copies, fills) and so the card's idle share, busy time by class (B: the
    GEMV pipeline; C with its group sums; the rest: attention, norms, GELU,
    RoPE, casts, cache writes), and the graph launches.  The profiler's own
    cost on the host (about 1500 eager launches a prefill) counts as idle."""
    from torch.profiler import ProfilerActivity, profile

    t_all = time.perf_counter()
    for p in prompts[:eng.max_batch]:
        eng.submit(p, max_new)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.run(bucket=SERVE_BUCKET)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
    events = _device_events(prof)
    busy = sum(e.self_device_time_total for e in events) / 1e3
    by = {name: sum(e.self_device_time_total for e in events if name in e.key) / 1e3
          for name in ("gemv_sm90_kernel", "q4k_matmul_kernel", "qmatmul_xsum_kernel", "fa_sm90_kernel")}
    by = {k: v for k, v in by.items() if v}
    trace = dict(requests=min(len(prompts), eng.max_batch), host_ms=host_ms, device_busy_ms=busy,
                 idle_share=1 - busy / host_ms, port_kernels_ms=by, other_device_ms=busy - sum(by.values()),
                 graph_launches=sum(e.count for e in prof.key_averages() if e.key.startswith("cudaGraphLaunch")),
                 profile_s=time.perf_counter() - t_all)
    print(f"  profiled one wave ({trace['requests']} requests): host {host_ms:.1f} ms, device busy {busy:.1f} ms "
          f"(idle {trace['idle_share'] * 100:.1f} %), {trace['graph_launches']} graph launches; "
          + ", ".join(f"{k} {v:.1f} ms" for k, v in by.items())
          + f"; other {trace['other_device_ms']:.1f} ms ({trace['profile_s']:.1f}s with the trace's processing)")
    eng.events.clear()
    return trace


def phase_serve_gptj(torch, np, params: dict, card: str) -> dict:
    """4m (GPT-J-6B): bench_serve's mix through serve.Engine over phase 4a's
    synthesized Q4_K planes.  A warm request (a 16-token prompt, 2 new: the
    decode graph of 16 steps captured), then 24 requests of 4-30-token
    prompts x 32 new from seed 0, timed on the host clock with CUDA events
    around every tick and batched prefill (device ms inside them; the idle
    share is what they leave of the host's time), with exact launch counts:
    B (85 a step at M = 8) and C (84 a batched prefill at M = 8 x 32: no
    head, whose logits would be dropped), no other kernel, no capture.  Then: each request alone through the same
    engine (the same ids: the engine's invariant), a request's slot rows
    after a single and after a grouped admission (equal: both are one (8,
    32) prefill), one wave again under torch.profiler (the idle share; the
    events' spans also hold the card's waits for an eager prefill's
    launches), the whole mix through an engine at horizon 1 (the same ids),
    and the first step's logits against b = 1 prefill logits."""
    import gc

    from ggml_tpu_torch.models import gptj
    from ggml_tpu_torch.serve import Engine

    cfg = gptj.random_config("6b")
    model = gptj.GPTJ(params, cfg, max_seq=256, device="cuda")
    rng = np.random.default_rng(0)
    eng = Engine(model, max_batch=SERVE_SLOTS, max_seq=256, cache_dtype=torch.bfloat16, record_events=True)
    t0 = time.perf_counter()
    eng.submit(rng.integers(0, cfg.n_vocab, 16).tolist(), 2)
    eng.run(bucket=SERVE_BUCKET)
    torch.cuda.synchronize()
    out = dict(warm_s=time.perf_counter() - t0, captures_while_warming=eng.captures, horizon=eng._hb)
    check(eng.captures == 1 and eng._hb == 16, f"GPT-J serving: {eng.captures} captures at horizon {eng._hb}")
    eng.event_ms()
    prompts = [rng.integers(0, cfg.n_vocab, int(rng.integers(4, 30))).tolist() for _ in range(SERVE_REQUESTS)]
    reset_launches()
    marks = _engine_marks(eng)
    rids = [eng.submit(p, SERVE_NEW) for p in prompts]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = eng.run(bucket=SERVE_BUCKET)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    waves = _prefill_spans(eng)
    ev = eng.event_ms()
    delta = _engine_delta(eng, marks)
    ids = [res[r] for r in rids]
    n_tok = sum(len(x) for x in ids)
    check(all(len(x) == SERVE_NEW and all(0 <= t < cfg.n_vocab for t in x) for x in ids),
          f"GPT-J serving: lengths {[len(x) for x in ids]}")
    want = dict.fromkeys(counts, 0)
    for k, n in GPTJ_STEP_LAUNCHES.items():
        want[k] += n * delta["decode_steps"]
    want["q4k_matmul"] += 3 * cfg.n_layer * waves  # a batched prefill runs no head
    check(counts == want and delta["captures"] == 0 and delta["prefill_count"] == SERVE_REQUESTS,
          f"GPT-J serving: launches {counts}, want {want}; {delta}, {waves} batched prefills")
    busy = ev.get("tick", 0.0) + ev.get("prefill", 0.0)
    out.update(requests=SERVE_REQUESTS, tokens=n_tok, wall_s=wall, tok_per_s=n_tok / wall, engine=delta,
               batched_prefills=waves, tick_ms=ev.get("tick", 0.0), prefill_ms=ev.get("prefill", 0.0),
               ms_per_step=ev.get("tick", 0.0) / delta["decode_steps"], idle_share=1 - busy / (wall * 1e3),
               launches=counts, counts=counts)
    print(f"  GPT-J-6B Q4_K, {SERVE_SLOTS} slots ({card}): {SERVE_REQUESTS} requests, {n_tok} tokens in "
          f"{wall * 1e3:.1f} ms: {out['tok_per_s']:.1f} tok/s; {delta['decode_steps']} steps in {delta['replays']} "
          f"graph replays, {out['ms_per_step']:.3f} ms a step on the card ({ev.get('tick', 0.0):.1f} ms), "
          f"{waves} batched prefills {ev.get('prefill', 0.0):.1f} ms, idle {out['idle_share'] * 100:.1f} %; "
          f"launches {counts}; warm-up with its capture {out['warm_s']:.1f}s")

    out["profile"] = profile_serve(torch, eng, prompts, SERVE_NEW)
    # the engine's invariant on the card: each request alone, through the same engine
    t0 = time.perf_counter()
    for p, got in zip(prompts, ids):
        rid = eng.submit(p, SERVE_NEW)
        alone = eng.run(bucket=SERVE_BUCKET)[rid]
        check(alone == got, f"GPT-J serving: prompt of {len(p)} alone {alone[:8]}... batched {got[:8]}...")
    out["alone_s"] = time.perf_counter() - t0
    # a single and a grouped admission write the same rows (one (8, 32) prefill each)
    rows = []
    for group in (prompts[:1], prompts[:SERVE_SLOTS]):
        for p in group:
            eng.submit(p, 1)
        eng._admit(SERVE_BUCKET)
        rows.append([(k[0, :, :len(prompts[0])].clone(), v[0, :, :len(prompts[0])].clone()) for k, v in eng.cache])
        eng.slots = [None] * eng.max_batch
    out["grouped_admission_rows_equal"] = all(torch.equal(a, b) for la, lb in zip(*rows) for a, b in zip(la, lb))
    check(out["grouped_admission_rows_equal"], "GPT-J serving: a grouped admission's rows differ from a single one's")
    # the first step's logits against b = 1 prefill logits, held as
    # assert_same_choice holds a position (NMSE <= 1e-6, the same argmax
    # unless the top two are within 1e-3) where both sides run the same
    # kernels: a 4-token prompt at bucket 4 (the engine's (8, 4) prefill and
    # b = 1's (1, 4) one both take B, int8 activations per row).  At bucket
    # 32 the engine's prompt rows take C (bf16 activations, M = 256) and b =
    # 1's take B: recorded over one layer and the whole depth (28 layers of
    # random weights carry a rounding far, as flash_against_plain_attention
    # found), not gated
    p = prompts[0]
    one = gptj.GPTJ(params, dataclasses.replace(cfg, n_layer=1), max_seq=256, device="cuda")
    eng_one = Engine(one, max_batch=SERVE_SLOTS, max_seq=256, cache_dtype=torch.bfloat16)
    out["first_step_vs_b1"] = {}
    for label, m, e, q, bucket in (("B both sides, 28 layers", model, eng, p[:4], 4),
                                   ("C against B, 28 layers", model, eng, p, SERVE_BUCKET),
                                   ("C against B, 1 layer", one, eng_one, p, SERVE_BUCKET)):
        step = _first_step_logits(torch, np, e, q, bucket)
        solo = m.prefill(m.new_cache(torch.bfloat16), np.asarray([q]))[0][0].float()
        top2 = torch.topk(solo, 2).values
        out["first_step_vs_b1"][label] = dict(prompt=len(q), nmse=errors(solo, step)[0],
                                              top2_gap=float(top2[0] - top2[1]),
                                              same_argmax=bool(step.argmax() == solo.argmax()))
    gate = out["first_step_vs_b1"]["B both sides, 28 layers"]
    check(gate["nmse"] <= 1e-6 and (gate["same_argmax"] or gate["top2_gap"] <= 1e-3),
          f"GPT-J serving: first step against b = 1 prefill logits, the same kernels: {gate}")
    print(f"  each request alone through the same engine: the same ids ({out['alone_s']:.1f}s); a grouped "
          f"admission's rows equal a single one's; first step against b = 1 prefill logits {out['first_step_vs_b1']}")
    del eng, one, eng_one
    gc.collect()

    h1 = Engine(model, max_batch=SERVE_SLOTS, max_seq=256, cache_dtype=torch.bfloat16, horizon=1)
    h1.submit(prompts[0], 2)  # warm: the capture of its one-step graph
    h1.run(bucket=SERVE_BUCKET)
    r1 = [h1.submit(p, SERVE_NEW) for p in prompts]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res1 = h1.run(bucket=SERVE_BUCKET)
    torch.cuda.synchronize()
    out["horizon1_tok_per_s"] = n_tok / (time.perf_counter() - t0)
    check([res1[r] for r in r1] == ids, "GPT-J serving: horizon 1 ids differ from horizon 16's")
    print(f"  horizon 1: the same ids, {out['horizon1_tok_per_s']:.1f} tok/s ({h1.captures} capture)")
    del h1, model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_serve_llama(torch, np, model, path: str, tokens: list, merges: list, card: str) -> dict:
    """4m (Llama-3-8B): serve.Engine over phase 4l's model (not loaded
    again), 4 slots at max_seq 2048, bucket 32.  A warm request (the decode
    graph of per-request sampling captured), then four requests
    at once: temperature 0 from prompts of 8, 100 and 1100 tokens and
    temperature 0.8 (top_p 0.95) from 8, 32 new each: three batched
    prefills ((4, 32), (4, 128) and (4, 1120): J at b = 4 over 1120 rows,
    C at M = 4480), exact launch counts (B 192, H 32, F 1 a step; C 224 a
    prefill; J and its split 32, the mask ranges once); the greedy requests
    equal the same request alone through the engine, the sampled one is in
    the vocabulary.  Then the HTTP server (cli/server.ServerState over the
    same file and model, 4 slots, max_seq 512) in this process: two prompts
    asked concurrently with and without streaming, the streamed text equal
    to the plain one."""
    import gc
    import threading
    import urllib.request

    from ggml_tpu_torch.cli import server
    from ggml_tpu_torch.serve import Engine
    from ggml_tpu_torch.tokenizer import BPETokenizer

    cfg = model.cfg
    rng = np.random.default_rng(1)
    eng = Engine(model, max_batch=4, max_seq=2048, cache_dtype=torch.bfloat16, record_events=True, seed=7)
    t0 = time.perf_counter()
    eng.submit(rng.integers(0, cfg.n_vocab, 8).tolist(), 2, sampling={"temperature": 0.0})
    eng.run(bucket=SERVE_BUCKET)
    torch.cuda.synchronize()
    out = dict(warm_s=time.perf_counter() - t0)
    eng.event_ms()
    plan = [(8, 0.0), (100, 0.0), (1100, 0.0), (8, 0.8)]
    prompts = [rng.integers(0, cfg.n_vocab, t).tolist() for t, _ in plan]
    reset_launches()
    marks = _engine_marks(eng)
    rids = [eng.submit(p, SERVE_NEW, sampling={"temperature": temp, "top_p": 0.95}) for p, (_, temp) in
            zip(prompts, plan)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = eng.run(bucket=SERVE_BUCKET)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    waves = _prefill_spans(eng)
    ev = eng.event_ms()
    delta = _engine_delta(eng, marks)
    ids = [res[r] for r in rids]
    check(all(len(x) == SERVE_NEW and all(0 <= t < cfg.n_vocab for t in x) for x in ids),
          f"Llama serving: {[len(x) for x in ids]} ids")
    want = dict.fromkeys(counts, 0)
    for k, n in LLAMA_STEP_LAUNCHES.items():
        want[k] += n * delta["decode_steps"]
    want.update(q4k_matmul=7 * cfg.n_layer * waves, flash_attn=cfg.n_layer, flash_split=cfg.n_layer,
                flash_mask_ranges=1)
    check(waves == 3 and counts == want and delta["captures"] == 0,
          f"Llama serving: launches {counts}, want {want}; {delta}, {waves} batched prefills")
    for p, (t, temp), got in zip(prompts, plan, ids):
        if temp == 0.0:
            rid = eng.submit(p, SERVE_NEW, sampling={"temperature": 0.0})
            alone = eng.run(bucket=SERVE_BUCKET)[rid]
            check(alone == got, f"Llama serving: prompt of {t} alone {alone[:8]}... batched {got[:8]}...")
    out.update(wall_s=wall, tokens=sum(len(x) for x in ids), tok_per_s=sum(len(x) for x in ids) / wall,
               engine=delta, batched_prefills=waves, tick_ms=ev.get("tick", 0.0), prefill_ms=ev.get("prefill", 0.0),
               ms_per_step=ev.get("tick", 0.0) / delta["decode_steps"],
               idle_share=1 - (ev.get("tick", 0.0) + ev.get("prefill", 0.0)) / (wall * 1e3), launches=counts,
               counts=counts, sampled_ids=ids[3][:8], sampled_distinct=len(set(ids[3])))
    print(f"  Llama-3-8B, 4 slots ({card}): prompts 8, 100, 1100 (temperature 0) and 8 (0.8): {out['tokens']} "
          f"tokens in {wall * 1e3:.1f} ms; {delta['decode_steps']} steps, {out['ms_per_step']:.3f} ms a step on the "
          f"card; 3 batched prefills {out['prefill_ms']:.1f} ms (J at b = 4); launches {counts}; greedy requests "
          f"alone give the same ids; sampled {out['sampled_distinct']} distinct of {SERVE_NEW}")
    del eng
    gc.collect()

    state = server.ServerState(path, max_batch=4, max_seq=512, model=model)
    httpd = server.serve(state, "127.0.0.1", 0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    tok = BPETokenizer(tokens, merges)
    words = FRONT_END_TEXT.split()
    texts = [" ".join(words[:12]), " ".join(words[20:60])]
    replies = {}

    def ask(key, text, stream):
        body = json.dumps({"prompt": text, "max_tokens": 16, "temperature": 0, "stream": stream}).encode()
        req = urllib.request.Request(base + "/v1/completions", body, {"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            if not stream:
                replies[key] = json.loads(r.read())["choices"][0]
                return
            parts, fin = [], None
            for line in r:
                line = line.decode().strip()
                if line.startswith("data: ") and line[6:] != "[DONE]":
                    ch = json.loads(line[6:])["choices"][0]
                    parts.append(ch["text"])
                    fin = ch["finish_reason"] or fin
            replies[key] = dict(text="".join(parts), finish_reason=fin)

    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(base + "/health", timeout=60) as r:
            check(json.loads(r.read()) == {"status": "ok"}, "server: /health")
        threads = [threading.Thread(target=ask, args=((i, s), text, s)) for i, text in enumerate(texts)
                   for s in (False, True)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=150)
    finally:
        httpd.shutdown()
        state.shutdown()
    out["http_s"] = time.perf_counter() - t0
    check(state.error is None, f"server: the engine thread stopped: {state.error!r}")
    check(len(replies) == 4, f"server: {len(replies)} of 4 replies")
    for i, text in enumerate(texts):
        plain, streamed = replies[(i, False)], replies[(i, True)]
        check(plain["text"] == streamed["text"] and plain["finish_reason"] == streamed["finish_reason"],
              f"server: streamed {streamed} differs from {plain}")
        check(plain["finish_reason"] in ("length", "stop"), f"server: reply {plain}")
    out["http"] = dict(replies=[replies[(i, False)]["text"][:60] for i in range(len(texts))],
                       captures=state.engine.captures, prompt_tokens=[len(tok.encode(t)) for t in texts])
    print(f"  HTTP server (4 slots, max_seq 512, the same model): 2 prompts x (plain, streamed) asked at once "
          f"answered in {out['http_s']:.1f}s, each stream equal to its plain reply")
    del state
    gc.collect()
    return out


# 4n: serving at long prompts and over pages: bench.py's serve_long
# (:970-1027: GPT-J-6B Q4_K, 8 slots, max_seq 1152, chunks of 256, 16
# prompts of 256-1024 tokens from seed 0 x 64 new) and serve_paged
# (:1029-1088: pages of 64, max_seq 1024, 8 x 16 + 8 pages, the prefix
# cache; 16 requests, the even ones a shared 256-token prefix plus 8-64
# tokens, the odd ones 64-256 tokens, x 32 new), both after two warm passes;
# the q8 KV cache on bench_serve's mix; Llama-3-8B's paged and chunked engines
LONG_SLOTS, LONG_SEQ, LONG_CHUNK, LONG_NEW, LONG_LENS = 8, 1152, 256, 64, (256, 1025)
PAGED_SEQ, PAGE, PAGED_NEW, PAGED_SHARED, PRESSURE_PAGES = 1024, 64, 32, 256, 24
PAGED_TAILS = ((8, 64), (64, 256))  # the even requests' tokens after the shared prefix, the odd ones' tokens
LLAMA_TAILS, LLAMA_OTHER = (20, 40, 9, 33), 100  # 4n (c): tokens after the shared prefix; one unshared prompt


class _Forwards:
    """Records each family forward an engine runs outside its graphs (the
    prefills, chunk dispatches and suffix prefills) as (rows M, head run)."""

    def __init__(self, eng):
        self.eng, self.fwd, self.calls = eng, eng._fwd, []
        eng._fwd = self

    def __call__(self, params, cfg, tokens, *args, need_logits=True, **kw):
        self.calls.append((tokens.shape[0] * tokens.shape[1], need_logits))
        return self.fwd(params, cfg, tokens, *args, need_logits=need_logits, **kw)

    def close(self):
        self.eng._fwd = self.fwd


def planar_launches(params: dict, m: int, head: bool, times: int = 1, into: dict | None = None) -> dict:
    """The launches of `times` forwards at M rows by wrapper: every planar
    linear's kernel at M (qmatmul.select_kernel, as planar_matmul picks it),
    the head only where it runs."""
    from ggml_tpu_torch.kernels import qmatmul
    from ggml_tpu_torch.quant.planar import PlanarWeight

    out = {} if into is None else into
    for key, w in params.items():
        if isinstance(w, PlanarWeight) and key != "token_embd.weight" and (head or key != "output.weight"):
            name = qmatmul.select_kernel(w, m)
            out[name] = out.get(name, 0) + times
    return out


def timed_mix(torch, eng, prompts, n_new: int, bucket: int = SERVE_BUCKET) -> dict:
    """One pass of a mix through an engine: every request submitted, then
    run() timed on the host clock ending in a sync, with the launch counts,
    the engine's counters and event spans, and the forwards run outside a
    graph.  The exact launches: those forwards' planar linears plus each
    decode step's (all linears at M = max_batch)."""
    reset_launches()
    marks = _engine_marks(eng)
    rec = _Forwards(eng)
    rids = [eng.submit(p, n_new) for p in prompts]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        res = eng.run(bucket=bucket)
        torch.cuda.synchronize()
    finally:
        rec.close()
    wall = time.perf_counter() - t0
    counts = {k: v for k, v in launch_counts().items() if v}
    delta = _engine_delta(eng, marks)
    want = planar_launches(eng.model.params, eng.max_batch, True, delta["decode_steps"])
    for m, head in rec.calls:
        planar_launches(eng.model.params, m, head, into=want)
    ids = [res[r] for r in rids]
    ev = eng.event_ms()
    busy = sum(ev.values())
    check(counts == {k: v for k, v in want.items() if v} and delta["captures"] == 0
          and delta.get("paged_captures", 0) == 0, f"launches {counts}, want {want}; {delta}")
    check(all(len(x) == n_new for x in ids), f"lengths {[len(x) for x in ids]}")
    tokens = sum(len(x) for x in ids)
    return dict(ids=ids, wall_s=wall, tokens=tokens, tok_per_s=tokens / wall, counts=counts, engine=delta,
                event_ms=ev, idle_share=1 - busy / (wall * 1e3), forwards=len(rec.calls))


def profile_device(torch, fn) -> dict:
    """fn() once under torch.profiler after a sync: host ms, device busy ms
    and busy ms by class (B: the GEMV pipeline; C with its group sums; GEMM:
    cuBLAS, the f32 attention products; the rest: gathers, copies, casts,
    softmax, norms, GELU, RoPE, cache writes)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        with torch.no_grad():
            fn()
        torch.cuda.synchronize()
        host = (time.perf_counter() - t0) * 1e3
    by = {"B": 0.0, "C": 0.0, "GEMM": 0.0, "other": 0.0}
    for e in _device_events(prof):
        key = e.key
        if re.fullmatch(r"(gptj|llama)\.attention|planar_matmul\..*", key):
            continue  # a record_function range: a device event spanning its kernels and the gaps between them
        library = any(t in key.lower() for t in ("gemm", "xmma", "cutlass", "nvjet", "cublas"))
        cls = ("B" if "gemv_sm90_kernel" in key else "C" if ("q4k_matmul_kernel" in key or "qmatmul_xsum" in key)
               else "GEMM" if library else "other")
        by[cls] += e.self_device_time_total / 1e3
    busy = sum(by.values())
    return dict(host_ms=host, busy_ms=busy, by_class_ms=by, idle_share=1 - busy / host)


def _run_ids(eng, prompts, n_new: int, bucket: int = SERVE_BUCKET) -> list:
    rids = [eng.submit(p, n_new) for p in prompts]
    res = eng.run(bucket=bucket)
    return [res[r] for r in rids]


def phase_serve_long(torch, np, params: dict, card: str) -> dict:
    """4n (a): serve_long's mix through a chunked engine over 4a's planes:
    each (8, 256) chunk dispatch C at M = 2048 (84 launches, no head), each
    step B at M = 8 (85); tok/s, the device ms of the chunk dispatches and
    the ticks, the idle share; every request equal to itself alone through
    the same engine (the engine's invariant); 4 against the unchunked
    bucketed engine, counted (C sees other M there: not gated)."""
    import gc

    from ggml_tpu_torch.models import gptj
    from ggml_tpu_torch.serve import Engine

    cfg = gptj.random_config("6b")
    model = gptj.GPTJ(params, cfg, max_seq=LONG_SEQ, device="cuda")
    rng = np.random.default_rng(0)
    lens = rng.integers(*LONG_LENS, 2 * LONG_SLOTS)
    prompts = [rng.integers(0, cfg.n_vocab, int(n)).tolist() for n in lens]
    eng = Engine(model, max_batch=LONG_SLOTS, max_seq=LONG_SEQ, cache_dtype=torch.bfloat16,
                 prefill_chunk=LONG_CHUNK, record_events=True)
    t0 = time.perf_counter()
    for _ in range(2):  # warm passes: the capture, first-use allocations
        _run_ids(eng, prompts, LONG_NEW)
    torch.cuda.synchronize()
    eng.event_ms()
    out = dict(warm_s=time.perf_counter() - t0, prompt_tokens=int(lens.sum()))
    out.update(timed_mix(torch, eng, prompts, LONG_NEW))
    ev, delta = out["event_ms"], out["engine"]
    out.update(chunk_ms=ev.get("chunk", 0.0), tick_ms=ev.get("tick", 0.0), install_ms=ev.get("prefill", 0.0),
               ms_per_chunk_dispatch=ev.get("chunk", 0.0) / max(1, delta["chunk_dispatches"]),
               ms_per_step=ev.get("tick", 0.0) / max(1, delta["decode_steps"]))
    check(delta["chunk_dispatches"] > 0 and delta["prefill_count"] == len(prompts), f"serve_long: {delta}")
    print(f"  serve_long, GPT-J-6B Q4_K, {LONG_SLOTS} slots, max_seq {LONG_SEQ}, chunks of {LONG_CHUNK} ({card}): "
          f"{len(prompts)} prompts ({out['prompt_tokens']} tokens) x {LONG_NEW}: {out['tokens']} tokens in "
          f"{out['wall_s'] * 1e3:.1f} ms, {out['tok_per_s']:.1f} tok/s; {delta['chunk_dispatches']} chunk dispatches "
          f"{out['chunk_ms']:.1f} ms ({out['ms_per_chunk_dispatch']:.2f} each), {delta['decode_steps']} steps "
          f"{out['tick_ms']:.1f} ms ({out['ms_per_step']:.3f} a step), installs {out['install_ms']:.1f} ms, idle "
          f"{out['idle_share'] * 100:.1f} %; launches {out['counts']}; warm passes {out['warm_s']:.1f}s")
    t0 = time.perf_counter()
    for p, got in zip(prompts, out["ids"]):
        alone = _run_ids(eng, [p], LONG_NEW)[0]
        check(alone == got, f"serve_long: prompt of {len(p)} alone {alone[:8]}... in the mix {got[:8]}...")
    out["alone_s"] = time.perf_counter() - t0
    toks = torch.as_tensor(np.asarray([p[:LONG_CHUNK] for p in prompts[:LONG_SLOTS]]), device=eng.device)
    pos = torch.full((), LONG_CHUNK, dtype=torch.int32, device=eng.device)
    out["chunk_profile"] = profile_device(torch, lambda: eng._fwd(
        model.params, cfg, toks, pos.expand(LONG_SLOTS), eng._chunk_cache, pos, need_logits=False))
    prof = out["chunk_profile"]
    print(f"  one ({LONG_SLOTS}, {LONG_CHUNK}) chunk dispatch profiled: host {prof['host_ms']:.1f} ms, device busy "
          f"{prof['busy_ms']:.1f} ms: " + ", ".join(f"{k} {v:.1f}" for k, v in prof["by_class_ms"].items()))
    ids = out.pop("ids")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    base = Engine(model, max_batch=LONG_SLOTS, max_seq=LONG_SEQ, cache_dtype=torch.bfloat16)
    unchunked = _run_ids(base, prompts[:4], LONG_NEW)
    out["equal_to_unchunked"] = sum(a == b for a, b in zip(unchunked, ids[:4]))
    print(f"  each request alone through the chunked engine: the same ids ({out['alone_s']:.1f}s); "
          f"{out['equal_to_unchunked']} of 4 equal to the unchunked bucketed engine's (not gated)")
    del base, model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_serve_paged(torch, np, params: dict, card: str) -> dict:
    """4n (b): serve_paged's mix through a paged engine with the prefix
    cache over 4a's planes: tok/s, ms a paged step (events around each
    stretch's graph replay), the idle share, the prefix-cache hits, exact
    launches (each prefill's and suffix prefill's linears at its M, B at M
    = 8 a step) and the stretch captures (one per h).  Checks: the pages a
    hit attaches hold, bit for bit, the rows of the prefill that published
    them; every request equals itself on a second hit pass; the first paged
    step's logits against the dense forward over the same admitted rows
    (NMSE <= 1e-5), the dense engine's ids counted; and a pool too small for
    the mix evicts (snapshots and resumes) with every request finishing
    with the ids of its unevicted run, one prefill a request."""
    import gc

    from ggml_tpu_torch.models import gptj
    from ggml_tpu_torch.paged_kv import PagedConfig, paged_gather
    from ggml_tpu_torch.serve import Engine

    cfg = gptj.random_config("6b")
    model = gptj.GPTJ(params, cfg, max_seq=PAGED_SEQ, device="cuda")
    per_seq = PAGED_SEQ // PAGE
    pcfg = PagedConfig(n_pages=LONG_SLOTS * per_seq + 8, page_size=PAGE, max_pages_per_seq=per_seq,
                       prefix_cache=True)
    rng = np.random.default_rng(0)
    shared = rng.integers(0, cfg.n_vocab, PAGED_SHARED).tolist()
    prompts = [shared + rng.integers(0, cfg.n_vocab, int(rng.integers(*PAGED_TAILS[0]))).tolist() if i % 2 == 0
               else rng.integers(0, cfg.n_vocab, int(rng.integers(*PAGED_TAILS[1]))).tolist()
               for i in range(2 * LONG_SLOTS)]
    eng = Engine(model, max_batch=LONG_SLOTS, max_seq=PAGED_SEQ, cache_dtype=torch.bfloat16, paged=pcfg,
                 record_events=True)
    t0 = time.perf_counter()
    warm = [_run_ids(eng, prompts, PAGED_NEW) for _ in range(2)]  # pass 1 publishes, pass 2 hits
    torch.cuda.synchronize()
    eng.event_ms()
    out = dict(warm_s=time.perf_counter() - t0)
    eng.cached_prefix_tokens = 0
    out.update(timed_mix(torch, eng, prompts, PAGED_NEW))
    ev, delta = out["event_ms"], out["engine"]
    scan = eng._paged_scan
    out.update(paged_ms=ev.get("paged", 0.0), prefill_ms=ev.get("prefill", 0.0),
               ms_per_paged_step=ev.get("paged", 0.0) / max(1, delta["paged_steps"]),
               hits_tokens=delta["cached_prefix_tokens"], stretch_captures=scan.captures,
               stretch_horizons=sorted(scan.graphs), eager_steps=delta["decode_steps"] - delta["paged_steps"])
    # every even request attaches the shared prefix; a prompt seen in a warm
    # pass also attaches its own published pages
    check(delta["cached_prefix_tokens"] >= PAGED_SHARED * LONG_SLOTS, f"serve_paged: hits {delta}")
    check(scan.captures == len(scan.graphs) and delta["paged_replays"] > 0, f"serve_paged: {delta}")
    out["equal_to_hit_pass"] = out["ids"] == warm[1]
    out["equal_to_publishing_pass"] = sum(a == b for a, b in zip(out["ids"], warm[0]))
    check(out["equal_to_hit_pass"], "serve_paged: a hit pass's ids differ from the next one's")
    print(f"  serve_paged, GPT-J-6B Q4_K, {LONG_SLOTS} slots, pages of {PAGE}, {pcfg.n_pages} pages ({card}): "
          f"{len(prompts)} requests x {PAGED_NEW}: {out['tokens']} tokens in {out['wall_s'] * 1e3:.1f} ms, "
          f"{out['tok_per_s']:.1f} tok/s; {delta['paged_steps']} steps in {delta['paged_replays']} stretch replays "
          f"{out['paged_ms']:.1f} ms ({out['ms_per_paged_step']:.3f} a step), {out['eager_steps']} eager steps, "
          f"{delta['prefill_count']} prefills {out['prefill_ms']:.1f} ms, idle {out['idle_share'] * 100:.1f} %; "
          f"prefix hits {out['hits_tokens']} tokens; {scan.captures} stretch captures (h = {out['stretch_horizons']});"
          f" launches {out['counts']}; the same ids as the last hit pass, {out['equal_to_publishing_pass']} of "
          f"{len(prompts)} as the publishing pass")

    # the published pages of the shared prefix against the publisher's prefill rows
    pages = eng.mgr.match_prefix(prompts[0])[:PAGED_SHARED // PAGE]
    check(len(pages) == PAGED_SHARED // PAGE, f"serve_paged: {len(pages)} published pages")
    with torch.no_grad():
        _, slot_cache, _, _ = eng._prefill(prompts[0], SERVE_BUCKET)
    idx = torch.tensor(pages, device=eng.device)
    out["published_pages_bit_exact"] = all(
        torch.equal(paged_gather(pool, idx), buf[0, :, :PAGED_SHARED]) for layer, rows in zip(eng.mgr.pools, slot_cache)
        for pool, buf in zip(layer, rows))
    check(out["published_pages_bit_exact"], "serve_paged: published pages differ from the publisher's prefill rows")
    del slot_cache

    # the first paged step against the dense forward over the same admitted rows
    for p in prompts[:LONG_SLOTS]:
        eng.submit(p, 1)
    eng._admit(SERVE_BUCKET)
    mgr = eng.mgr
    active = np.array([s is not None for s in eng.slots])
    dev = lambda a, dt=torch.long: torch.as_tensor(np.asarray(a)).to(eng.device, dt)
    wpage, woff = mgr.step_coords(active)
    tables, n_past, tok = dev(mgr.tables), dev(mgr.lengths), dev(eng.cur_tok.reshape(-1, 1))
    with torch.no_grad():
        dense = [(paged_gather(kp, tables), paged_gather(vp, tables)) for kp, vp in mgr.pools]
        want = gptj.forward(model.params, cfg, tok, n_past, dense, n_past)[0][:, -1].float()
    del dense
    step = []
    out["step_profile"] = profile_device(torch, lambda: step.append(eng._paged_step(
        model.params, mgr.pools, tok, n_past, tables, dev(wpage), dev(woff), dev(active, torch.bool))[0].float()))
    got = step[0]
    prof = out["step_profile"]
    print(f"  one paged step profiled (eager): host {prof['host_ms']:.1f} ms, device busy {prof['busy_ms']:.1f} ms: "
          + ", ".join(f"{k} {v:.1f}" for k, v in prof["by_class_ms"].items()))
    out["paged_vs_dense_first_step_nmse"] = errors(want, got)[0]
    check(out["paged_vs_dense_first_step_nmse"] <= 1e-5, f"serve_paged: paged against dense {out}")
    for i in range(eng.max_batch):
        eng.slots[i] = None
        mgr.release(i)
    ids = out.pop("ids")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    dense_eng = Engine(model, max_batch=LONG_SLOTS, max_seq=PAGED_SEQ, cache_dtype=torch.bfloat16)
    out["equal_to_dense_engine"] = sum(a == b for a, b in zip(_run_ids(dense_eng, prompts, PAGED_NEW), ids))
    del dense_eng
    gc.collect()
    print(f"  published pages equal the publisher's prefill rows bit for bit; first paged step against the dense "
          f"forward over the same rows NMSE {out['paged_vs_dense_first_step_nmse']:.2e}; {out['equal_to_dense_engine']}"
          f" of {len(prompts)} requests equal to the dense engine's ids (not gated: batched prefills at other M)")

    # page pressure: a pool of 24 pages for a mix whose 8 slots hold up to 48
    plain = dict(max_batch=LONG_SLOTS, max_seq=PAGED_SEQ, cache_dtype=torch.bfloat16)
    ref = Engine(model, paged=PagedConfig(pcfg.n_pages, PAGE, per_seq), **plain)
    want_ids = _run_ids(ref, prompts, PAGED_NEW)
    del ref
    small = Engine(model, paged=PagedConfig(PRESSURE_PAGES, PAGE, per_seq), **plain)
    evicted = []
    evict = small._evict
    small._evict = lambda i, req: evicted.append(req.rid) or evict(i, req)
    t0 = time.perf_counter()
    got_ids = _run_ids(small, prompts, PAGED_NEW)
    out["pressure"] = dict(evictions=len(evicted), requests_evicted=len(set(evicted)), wall_s=time.perf_counter() - t0,
                           prefills=small.prefill_count, free_pages=small.mgr.free_pages())
    check(got_ids == want_ids and len(evicted) > 0 and small.prefill_count == len(prompts)
          and small.mgr.free_pages() == PRESSURE_PAGES, f"serve_paged under page pressure: {out['pressure']}")
    print(f"  {PRESSURE_PAGES} pages under pressure: {len(evicted)} evictions of {len(set(evicted))} requests (host "
          f"snapshots, resumed), every request finished with the ids of its unevicted run, one prefill each "
          f"({out['pressure']['wall_s']:.1f}s)")
    del small, model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_serve_q8(torch, np, params: dict, card: str) -> dict:
    """4n (d): the q8 KV cache on bench_serve's mix through GPT-J-6B at 8
    slots: the KV bytes against bf16's, tok/s with exact launches, one
    layer's codes and scales on the card against the plain quantizer on the
    host over the same bf16 rows (the bf16 engine's, admitted at the same
    M), the ids against the bf16 cache's counted (another result by design:
    not gated)."""
    import gc

    from ggml_tpu_torch.models import common, gptj
    from ggml_tpu_torch.serve import Engine

    cfg = gptj.random_config("6b")
    model = gptj.GPTJ(params, cfg, max_seq=256, device="cuda")
    rng = np.random.default_rng(0)
    warm = rng.integers(0, cfg.n_vocab, 16).tolist()
    prompts = [rng.integers(0, cfg.n_vocab, int(rng.integers(4, 30))).tolist() for _ in range(SERVE_REQUESTS)]
    engines = {}
    for dt in ("q8_kv", torch.bfloat16):
        e = engines[str(dt)] = Engine(model, max_batch=SERVE_SLOTS, max_seq=256, cache_dtype=dt, record_events=True)
        _run_ids(e, [warm], 2)
        e.event_ms()
    q8, bf = engines["q8_kv"], engines["torch.bfloat16"]
    kv_bytes = sum(c.nbytes for layer in q8.cache for c in layer)
    bf_bytes = sum(c.nbytes for layer in bf.cache for c in layer)
    # one layer's codes and scales against the plain quantizer over the bf16 rows
    for e in (q8, bf):
        e.submit(prompts[0], 1)
        e._admit(SERVE_BUCKET)
    t = len(prompts[0])
    rows = bf.cache[0][0][0, :, :t].cpu()
    codes, scales = common._quantize_rows(rows)
    got_c, got_s = q8.cache[0][0].codes[0, :, :t].cpu(), q8.cache[0][0].scales[0, :, :t].cpu()
    diff = (got_c.to(torch.int16) - codes.to(torch.int16)).abs()
    rel = float(((got_s - scales).abs() / scales.clamp(min=1e-30)).max())
    out = dict(kv_bytes=kv_bytes, bf16_kv_bytes=bf_bytes, kv_ratio=kv_bytes / bf_bytes, codes_off=int((diff > 0).sum()),
               codes_max_diff=int(diff.max()), scales_max_rel=rel)
    check(int(diff.max()) <= 1 and rel <= 1e-7, f"q8 KV: codes and scales against the plain quantizer {out}")
    for e in (q8, bf):
        e.cancel(e.slots[0].rid)
        e.slots = [None] * e.max_batch
        e.event_ms()  # that admission's span is not the mix's
    # the first step's logits, q8 against bf16 over the same prompt (each
    # engine's own cache), over 28 layers and over one: not gated
    one = gptj.GPTJ(params, dataclasses.replace(cfg, n_layer=1), max_seq=256, device="cuda")
    out["first_step_q8_vs_bf16_nmse"] = {}
    for label, m in (("28 layers", model), ("1 layer", one)):
        e8 = q8 if m is model else Engine(m, max_batch=SERVE_SLOTS, max_seq=256, cache_dtype="q8_kv")
        e16 = bf if m is model else Engine(m, max_batch=SERVE_SLOTS, max_seq=256, cache_dtype=torch.bfloat16)
        a, b = (_first_step_logits(torch, np, e, prompts[0], SERVE_BUCKET) for e in (e16, e8))
        out["first_step_q8_vs_bf16_nmse"][label] = errors(a, b)[0]
        for e in (e8, e16):
            e.event_ms()
    del one
    out.update(timed_mix(torch, q8, prompts, SERVE_NEW))
    ev, delta = out["event_ms"], out["engine"]
    out["ms_per_step"] = ev.get("tick", 0.0) / max(1, delta["decode_steps"])
    bf_ids = _run_ids(bf, prompts, SERVE_NEW)
    out["equal_to_bf16"] = sum(a == b for a, b in zip(out.pop("ids"), bf_ids))
    print(f"  q8 KV cache, GPT-J-6B Q4_K, {SERVE_SLOTS} slots, bench_serve's mix ({card}): KV {kv_bytes / 1e9:.3f} GB "
          f"against bf16's {bf_bytes / 1e9:.3f} ({out['kv_ratio']:.3f}x); {out['tokens']} tokens in "
          f"{out['wall_s'] * 1e3:.1f} ms, {out['tok_per_s']:.1f} tok/s, {out['ms_per_step']:.3f} ms a step, idle "
          f"{out['idle_share'] * 100:.1f} %; layer 0's codes against the plain quantizer: {out['codes_off']} off by "
          f"{out['codes_max_diff']}, scales within {rel:.1e}; {out['equal_to_bf16']} of {SERVE_REQUESTS} requests "
          f"give the bf16 cache's ids (not gated); first step's logits against bf16's NMSE "
          f"{out['first_step_q8_vs_bf16_nmse']}; launches {out['counts']}")
    del q8, bf, engines, model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_serve_4n(torch, np, params: dict, card: str) -> dict:
    """4n's GPT-J-6B parts over 4a's planes: serve_long, serve_paged, the q8
    KV cache."""
    stage("4n. serving: serve_long's mix, GPT-J-6B Q4_K, 8 slots, chunked prefill (chunks of 256)")
    out = dict(serve_long=phase_serve_long(torch, np, params, card))
    stage("4n. serving: serve_paged's mix, GPT-J-6B Q4_K, 8 slots, paged KV (pages of 64) with the prefix cache")
    out["serve_paged"] = phase_serve_paged(torch, np, params, card)
    stage("4n. serving: the q8 KV cache on bench_serve's mix, GPT-J-6B Q4_K, 8 slots")
    out["serve_q8"] = phase_serve_q8(torch, np, params, card)
    return out


def phase_serve_llama_paged(torch, np, model, card: str) -> dict:
    """4n (c): Llama-3-8B (4l's model) at 4 slots through a paged engine
    (pages of 64, max_seq 1024, the prefix cache) and a chunked engine
    (chunks of 256): four requests sharing a 256-token prefix and one of 100
    tokens x 16 new, a warm pass each, then a timed pass with exact launches
    (a paged step: B on 192 linears at M = 4, H on 32 ffn_down, F on the
    head) and ms a step beside 4m's dense engine."""
    import gc

    from ggml_tpu_torch.paged_kv import PagedConfig
    from ggml_tpu_torch.serve import Engine

    cfg = model.cfg
    rng = np.random.default_rng(2)
    shared = rng.integers(0, cfg.n_vocab, PAGED_SHARED).tolist()
    prompts = [shared + rng.integers(0, cfg.n_vocab, n).tolist() for n in LLAMA_TAILS]
    prompts.append(rng.integers(0, cfg.n_vocab, LLAMA_OTHER).tolist())
    per_seq = PAGED_SEQ // PAGE
    n_new = 16
    out = {}
    counts: dict = {}
    kinds = (("paged", dict(paged=PagedConfig(4 * per_seq + per_seq, PAGE, per_seq, prefix_cache=True))),
             ("chunked", dict(prefill_chunk=LONG_CHUNK)))
    for label, kw in kinds:
        eng = Engine(model, max_batch=4, max_seq=PAGED_SEQ, cache_dtype=torch.bfloat16, record_events=True, **kw)
        _run_ids(eng, prompts, n_new)
        torch.cuda.synchronize()
        eng.event_ms()
        eng.cached_prefix_tokens = 0
        run = timed_mix(torch, eng, prompts, n_new)
        ev, delta = run["event_ms"], run["engine"]
        span, steps = (("paged", delta["paged_steps"]) if label == "paged" else ("tick", delta["decode_steps"]))
        run["ms_per_step"] = ev.get(span, 0.0) / max(1, steps)
        if label == "paged":
            check(delta["cached_prefix_tokens"] >= PAGED_SHARED * 4, f"Llama paged: hits {delta}")
        for k, v in run["counts"].items():
            counts[k] = counts.get(k, 0) + v
        out[label] = run
        print(f"  Llama-3-8B {label}, 4 slots ({card}): {run['tokens']} tokens in {run['wall_s'] * 1e3:.1f} ms, "
              f"{run['tok_per_s']:.1f} tok/s, {run['ms_per_step']:.3f} ms a step on the card (4m's dense engine: "
              f"12.54-12.56), idle {run['idle_share'] * 100:.1f} %; prefix hits {delta['cached_prefix_tokens']}; "
              f"launches {run['counts']}")
        del eng
        gc.collect()
    out["paged_equal_chunked"] = sum(a == b for a, b in zip(out["paged"].pop("ids"), out["chunked"].pop("ids")))
    out["counts"] = counts
    print(f"  {out['paged_equal_chunked']} of {len(prompts)} requests give the same ids through both engines "
          "(not gated: suffix prefills and chunks take C and B at other M)")
    torch.cuda.empty_cache()
    return out


def flash_times(torch, flash_attn) -> dict:
    """Kernel J's device time (µs) at GPT-J's 1024-token prefill, f32 q/k
    with a bf16 v and all bf16 (each call computes its mask ranges), then its
    helper flash_mask_ranges alone on the 1024 x 1024 causal mask, and
    beside it the floor of this timing: a PyTorch kernel that writes one
    float; those two also with L2 flushed by reads (no dirty lines to write
    back); three timings of 20 calls each.  The mode that sets two trees side
    by side in one call (copy this script into the other tree and run it
    there with --flash-times)."""
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    n = 1024
    mask = torch.where(torch.arange(n, device="cuda")[None, :] <= torch.arange(n, device="cuda")[:, None], 0.0, -1e30)
    out = {}
    for types, qk in (("f32 q/k, bf16 v", torch.float32), ("bfloat16", torch.bfloat16)):
        mk = lambda dt: torch.randn((1, n, 16, 256), device="cuda", generator=gen).to(dt).transpose(1, 2)
        q, k, v = mk(qk), mk(qk), mk(torch.bfloat16)
        call = lambda: flash_attn.flash_attention(q, k, v, mask=mask, scale=1 / 16)
        out[types] = [device_ms(torch, call, flush, 20) * 1e3 for _ in range(3)]
        print(f"  J {types}: " + ", ".join(f"{t:.1f}us" for t in out[types]))
    one = torch.empty(1, device="cuda")
    for by_reads in (False, True):
        for key, call in (("flash_mask_ranges 1024x1024", lambda: flash_attn.mask_ranges(mask)),
                          ("floor: one float written", one.zero_)):
            key += ", L2 flushed by reads" if by_reads else ""
            out[key] = [device_ms(torch, call, flush, 20, by_reads) * 1e3 for _ in range(3)]
            print(f"  {key}: " + ", ".join(f"{t:.2f}us" for t in out[key]))
    return out


def train_times(torch, flash_attn) -> dict:
    """Kernels K, L and M's device time (µs) at GPT-2-medium's training
    shape (b=8, n=512) and at GPT-2's context (b=4, n=1024), h=16, d=64,
    bf16, causal, three timings of 20 calls each: the mode that sets two
    trees side by side in one call (copy this script into the other tree and
    run it there with --train-times).  Where a wrapper takes the mask's tile
    ranges (each wrapper's signature is asked, so that an older tree runs
    too), they are computed once beforehand, as the autograd Function does
    once per layer."""
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    takes_ranges = "ranges" in inspect.signature(flash_attn.flash_attention_fwd_lse).parameters
    l_takes_ranges = "ranges" in inspect.signature(flash_attn.flash_attention_bwd_dq).parameters
    out = {}
    for b, n in ((8, 512), (4, 1024)):
        mk = lambda *shape: torch.randn(shape, device="cuda", generator=gen).to(torch.bfloat16)
        q, k, v, do = mk(b, 16, n, 64), mk(b, 16, n, 64), mk(b, 16, n, 64), mk(b, n, 16, 64)
        mask = torch.where(torch.arange(n, device="cuda")[None, :] <= torch.arange(n, device="cuda")[:, None],
                           0.0, -1e30)
        kw = dict(ranges=flash_attn.mask_ranges(mask)) if takes_ranges else {}
        l_kw = kw if l_takes_ranges else {}
        o, lse = flash_attn.flash_attention_fwd_lse(q, k, v, mask, 0.125, 0.0, **kw)
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
        args = (q, k, v, mask, 0.125, 0.0, do, lse, delta)
        for name, call in (("K", lambda: flash_attn.flash_attention_fwd_lse(q, k, v, mask, 0.125, 0.0, **kw)),
                           ("L", lambda: flash_attn.flash_attention_bwd_dq(*args, **l_kw)),
                           ("M", lambda: flash_attn.flash_attention_bwd_dkv(*args, **kw))):
            key = f"{name} b={b} n={n}"
            out[key] = [device_ms(torch, call, flush, 20) * 1e3 for _ in range(3)]
            print(f"  {key}: " + ", ".join(f"{t:.1f}us" for t in out[key]))
    return out


def gemv_times(torch, qmatmul) -> dict:
    """Device time (µs) of the GEMV kernels at GPT-J-6B's four decode
    shapes (attn_qkvup, attn_output, ffn_down, the head), three timings of
    50 calls each, each call with its activation quantization: A (compact
    Q4_K, M = 1), B (compact Q4_K, M = 8), E (Q8_0 planes), F (compact Q6_K)
    and H (Q4_0 planes) at M = 1 and 8.  The mode that sets two trees side
    by side in one call (copy this script into the other tree and run it
    there with --gemv-times)."""
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    shapes = dict(attn_qkvup=(4096, 28672, 28672), attn_output=(4096, 4096, 4096), ffn_down=(16384, 4096, 4096),
                  head=(4096, 50400, 51200))
    kernels = (("A", "q4k_gemv_qact", None, (1,)), ("B", "q4k_gemv_rows", None, (8,)),
               ("E", "q8_gemv", "q8_0", (1, 8)), ("F", "q8_gemv_sb", "q6_k", (1, 8)), ("H", "q4_gemv", "q4_0", (1, 8)))
    out = {}
    for label, (k, n, npad) in shapes.items():
        for kernel, name, fmt, ms in kernels:
            if fmt is None:
                pw = random_planes(torch, n, k, npad, torch.bfloat16, gen)
            elif fmt == "q4_0":
                pw = random_q4_planes(torch, n, k, npad, fmt, gen)
            else:
                pw = random_q8_planes(torch, n, k, npad, fmt, gen)
            fn = getattr(qmatmul, name)
            for m in ms:
                x = torch.randn((m, k), device="cuda", generator=gen).to(torch.bfloat16)
                key = f"{kernel} {label} M={m}"
                out[key] = [device_ms(torch, lambda: fn(x, pw), flush, 50) * 1e3 for _ in range(3)]
                print(f"  {key}: " + ", ".join(f"{t:.1f}us" for t in out[key]))
            del pw
    return out


def main() -> int:
    try:
        import numpy as np
        import torch
        import torch.nn.functional as F
    except ImportError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 2
    try:
        from ggml_tpu_torch.kernels import _build, decode_attn, flash_attn, qmatmul
    except ImportError as e:
        print(f"chip_smoke: the ggml_tpu_torch package is not here ({e})", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False  # dense f32 products in full f32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False  # bf16 GEMMs sum in f32, as XLA's

    try:
        stage("1. card")
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
        check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
        card = smi.stdout.strip().splitlines()[0]
        print(card)
        print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

        stage("2. build")
        t0 = time.perf_counter()
        _build.lib()
        print(f"  kernels built and loaded in {time.perf_counter() - t0:.1f}s")
        for line in _build.build_log.splitlines():
            if "registers" in line or "spill" in line or line.startswith("=="):
                print("  " + line.strip())

        if sys.argv[1:] == ["--flash-times"]:
            stage("3. kernel J and its mask ranges at the 1024-token prefill (h=16, d=256, causal), three timings each")
            times = flash_times(torch, flash_attn)
            print(json.dumps(dict(card=card, flash_times_us=times)))
            print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                                     "count": torch.cuda.device_count()}}))
            return 0

        if sys.argv[1:] == ["--train-times"]:
            stage("3. kernels K, L and M at the training shapes (h=16, d=64, bf16, causal), three timings each")
            times = train_times(torch, flash_attn)
            print(json.dumps(dict(card=card, train_times_us=times)))
            print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                                     "count": torch.cuda.device_count()}}))
            return 0

        if sys.argv[1:] == ["--gemv-times"]:
            stage("3. kernels A, B, E, F and H at GPT-J-6B's decode shapes (M = 1 and 8), three timings each")
            times = gemv_times(torch, qmatmul)
            print(json.dumps(dict(card=card, gemv_times_us=times)))
            print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                                     "count": torch.cuda.device_count()}}))
            return 0

        if sys.argv[1:] == ["--front-end"]:
            stage("4i. the text front end: GPT-J-6B from a Q4_K GGUF file, the generate CLI, perplexity")
            with tempfile.TemporaryDirectory(prefix="gptj6b-gguf-") as tmp:
                front = phase_front_end(torch, np, write_gptj6b_gguf(np, tmp))
            print(json.dumps(dict(card=card, front_end=front)))
            print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                                     "count": torch.cuda.device_count()}}))
            return 0

        if sys.argv[1:] == ["--qlora"]:
            stage("4j. QLoRA fine-tuning of GPT-J-6B from a Q4_K GGUF file, batch 4 x 128, rank 8")
            with tempfile.TemporaryDirectory(prefix="gptj6b-gguf-") as tmp:
                qlora = phase_qlora(torch, np, write_gptj6b_gguf(np, tmp)[0], tmp)
            print(json.dumps(dict(card=card, qlora=qlora)))
            print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                                     "count": torch.cuda.device_count()}}))
            return 0

        if sys.argv[1:] == ["--train"]:
            from ggml_tpu_torch.dtypes import GGMLType
            from ggml_tpu_torch.models import gptj

            train = {}
            stage("4g. GPT-2-medium training, batch 8 x 512, bf16 over f32 masters, AdamW, flash attention")
            train["gpt2_medium"] = phase_train(torch, np)
            stage("4g. GPT-2-large training at bench_train's 774m shape, batch 4 x 512, with and without remat")
            train["gpt2_large"] = phase_train_774m(torch, np)
            stage("4h. tiny f32 GPT-2 training on the card against the CPU")
            train["tiny_gpt2"] = phase_tiny_train(torch, np)
            stage("4o. QLoRA of GPT-J-6B Q4_K (synthesized compact planes) at bench_qlora's shape")
            params = gptj.synth_quantized_params(gptj.random_config("6b"), GGMLType.Q4_K, seed=0,
                                                 dtype=torch.bfloat16, device="cuda")
            train["qlora_gptj"] = phase_qlora_bench(torch, np, params, card)
            del params
            with tempfile.TemporaryDirectory(prefix="llama3-8b-gguf-") as tmp:
                stage("4p. QLoRA of Llama-3-8B from a Q4_K GGUF file (Q6_K head), rank 16, batch 2 x 512")
                path = write_llama3_8b_gguf(np, tmp)[0]
                train["qlora_llama"] = phase_qlora_llama(torch, np, path, tmp, card)
                os.remove(path)
                stage("4q. MNIST: fc and cnn through opt.fit, bench_mnist's eval")
                train["mnist"] = phase_mnist(torch, np, tmp, card)
            print(json.dumps(dict(card=card, train=train)))
            print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                                     "count": torch.cuda.device_count()}}))
            return 0

        if sys.argv[1:] == ["--iquants"]:
            stage("4k. GPT-J-6B from IQ4_XS, IQ1_M and TQ2_0 GGUF files")
            with tempfile.TemporaryDirectory(prefix="gptj6b-gguf-") as tmp:
                iq = phase_iquants(torch, np, tmp, card)
            print(json.dumps(dict(card=card, iquants=iq)))
            print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                                     "count": torch.cuda.device_count()}}))
            return 0

        if sys.argv[1:] == ["--llama"]:
            stage("4l. Llama-3-8B from a Q4_K GGUF file (Q6_K head)")
            with tempfile.TemporaryDirectory(prefix="llama3-8b-gguf-") as tmp:
                run = phase_llama(torch, np, tmp, card)
            print(json.dumps(dict(card=card, llama=run)))
            print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                                     "count": torch.cuda.device_count()}}))
            return 0

        if sys.argv[1:] == ["--serve"]:
            from ggml_tpu_torch.dtypes import GGMLType
            from ggml_tpu_torch.models import gptj, llama

            stage("4m. serving: GPT-J-6B Q4_K (synthesized compact planes), 8 slots, bench_serve's mix")
            params = gptj.synth_quantized_params(gptj.random_config("6b"), GGMLType.Q4_K, seed=0,
                                                 dtype=torch.bfloat16, device="cuda")
            served = dict(gptj=phase_serve_gptj(torch, np, params, card))
            served.update(phase_serve_4n(torch, np, params, card))
            del params
            torch.cuda.empty_cache()
            stage("4m. serving: Llama-3-8B from a Q4_K GGUF file (Q6_K head), 4 slots, and the HTTP server")
            with tempfile.TemporaryDirectory(prefix="llama3-8b-gguf-") as tmp:
                path, _, tokens, merges = write_llama3_8b_gguf(np, tmp)
                t0 = time.perf_counter()
                model = llama.Llama.from_gguf(path, max_seq=2048, device="cuda")
                torch.cuda.synchronize()
                print(f"  loaded as planes in {time.perf_counter() - t0:.1f}s")
                served["llama"] = phase_serve_llama(torch, np, model, path, tokens, merges, card)
                stage("4n. serving: Llama-3-8B (the same model), 4 slots, paged and chunked engines")
                served["llama_paged_chunked"] = phase_serve_llama_paged(torch, np, model, card)
                del model
            print(json.dumps(dict(card=card, serve=served)))
            print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                                     "count": torch.cuda.device_count()}}))
            return 0

        if sys.argv[1:] == ["--long-decode-profile"]:
            stage("4. GPT-J-6B Q4_K (synthesized compact planes), decode after a 1088-token prompt, profiled")
            from ggml_tpu_torch.dtypes import GGMLType
            from ggml_tpu_torch.models import gptj

            cfg = gptj.random_config("6b")
            params = gptj.synth_quantized_params(cfg, GGMLType.Q4_K, seed=0, dtype=torch.bfloat16, device="cuda")
            model = gptj.GPTJ(params, cfg, max_seq=2048, device="cuda")
            model.generate(np.arange(1088)[None], 4)  # warm-up of the path
            trace = profile_decode(torch, np, model, prompt=1088)
            graphed = profile_decode_graphed(torch, np, model, prompt=1088)
            print(json.dumps(dict(card=card, long_decode_trace=trace, long_graphed_decode_trace=graphed)))
            print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                                     "count": torch.cuda.device_count()}}))
            return 0

        stage("3. kernels against their plain versions")
        flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
        kernel_results = phase_kernels(torch, F, qmatmul, decode_attn, flash_attn, flush)
        del flush

        from ggml_tpu_torch.dtypes import GGMLType
        from ggml_tpu_torch.models import gptj

        cfg = gptj.random_config("6b")
        synth = lambda t: gptj.synth_quantized_params(cfg, t, seed=0, dtype=torch.bfloat16, device="cuda")
        runs = []
        q4k_kernels = dict(decode="q4k_gemv_qact", rows="q4k_gemv_rows", matmul="q4k_matmul")
        stage("4a. GPT-J-6B Q4_K (synthesized compact planes), three greedy requests, then a 1024-token prompt")
        params = synth(GGMLType.Q4_K)
        runs.append(phase_gptj(torch, np, "q4_k", params, q4k_kernels, (8, 100, 1), profile=True, sampled=True))
        runs.append(phase_gptj(torch, np, "q4_k long", params, q4k_kernels, (1024,), profile=False, max_seq=2048,
                               long_decode_profile=1088))
        stage("4m. serving: GPT-J-6B Q4_K (the same planes), 8 slots, bench_serve's mix")
        runs.append(phase_serve_gptj(torch, np, params, card))
        runs += phase_serve_4n(torch, np, params, card).values()
        stage("4o. QLoRA of GPT-J-6B Q4_K (the same planes) at bench_qlora's shape, with and without remat")
        runs.append(phase_qlora_bench(torch, np, params, card))
        del params
        torch.cuda.empty_cache()
        stage("4b. GPT-J-6B Q8_0 (synthesized int8 planes), three greedy requests")
        params = synth(GGMLType.Q8_0)
        runs.append(phase_gptj(torch, np, "q8_0", params, dict(
            decode="q8_gemv", rows="q8_gemv", matmul="q8_matmul"), (8, 100, 1), profile=True))
        stage("4c. GPT-J-6B Q6_K (compact planes repacked from random blocks), one greedy request")
        t0 = time.perf_counter()
        params = q6k_planes_like(torch, np, params)
        torch.cuda.synchronize()
        print(f"  repacked and tiled in {time.perf_counter() - t0:.1f}s")
        runs.append(phase_gptj(torch, np, "q6_k", params, dict(
            decode="q8_gemv_sb", rows="q8_gemv_sb"), (8,), profile=True))
        del params
        torch.cuda.empty_cache()
        q4_kernels = dict(decode="q4_gemv", rows="q4_gemv", matmul="q4k_matmul")
        stage("4e. GPT-J-6B Q4_0 (synthesized multiplied-out nibble planes), context 2048, four greedy requests")
        params = synth(GGMLType.Q4_0)
        runs.append(phase_gptj(torch, np, "q4_0", params, q4_kernels, (8, 100, 1, 1024), profile=True, max_seq=2048))
        del params
        torch.cuda.empty_cache()
        stage("4f. GPT-J-6B Q3_K (synthesized nibble planes, groups of 16), one greedy request")
        params = synth(GGMLType.Q3_K)
        runs.append(phase_gptj(torch, np, "q3_k", params, q4_kernels, (8,), profile=False))
        del params
        torch.cuda.empty_cache()
        stage("4d. tiny GPT-J on the card against the CPU")
        tiny = phase_tiny_reference(torch, np)
        stage("4g. GPT-2-medium training, batch 8 x 512, bf16 over f32 masters, AdamW, flash attention")
        runs.append(phase_train(torch, np))
        stage("4g. GPT-2-large training at bench_train's 774m shape, batch 4 x 512, with and without remat")
        runs.append(phase_train_774m(torch, np))
        stage("4h. tiny f32 GPT-2 training on the card against the CPU")
        tiny["gpt2_train"] = phase_tiny_train(torch, np)
        with tempfile.TemporaryDirectory(prefix="mnist-") as tmp:
            stage("4q. MNIST: fc and cnn through opt.fit, bench_mnist's eval")
            runs.append(phase_mnist(torch, np, tmp, card))
        with tempfile.TemporaryDirectory(prefix="gptj6b-gguf-") as tmp:
            # 4i and 4j at 4 of GPT-J's 28 layers in the whole run, which 4p's
            # training of Llama-3-8B would otherwise take past 1000 s (loading
            # the 28-layer file three times and 4j's once took 187 s of PR 17's
            # first whole run; --front-end and --qlora run all 28)
            stage("4i. the text front end: GPT-J-6B (4 of its 28 layers) from a Q4_K GGUF file, the generate CLI, "
                  "perplexity")
            written = write_gptj6b_gguf(np, tmp, n_layer=4)
            runs.append(phase_front_end(torch, np, written))
            stage("4j. QLoRA fine-tuning of GPT-J-6B (4 layers) from the same file, batch 4 x 128, rank 8")
            runs.append(phase_qlora(torch, np, written[0], tmp))
            os.remove(written[0])
            # at 4 of its 28 layers in the whole run, which 4l and 4m would
            # otherwise take past 700 s (--iquants runs all 28)
            stage("4k. GPT-J-6B (4 of its 28 layers) from IQ4_XS, IQ1_M and TQ2_0 GGUF files")
            runs += phase_iquants(torch, np, tmp, card, n_layer=4)
            stage("4l. Llama-3-8B from a Q4_K GGUF file (Q6_K head)")
            llama_run = phase_llama(torch, np, tmp, card, serve=True, train=True)
            runs += [llama_run, llama_run.pop("serve"), llama_run.pop("serve_paged_chunked"), llama_run.pop("qlora")]
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1
    except Exception:
        traceback.print_exc()
        return 1

    stage("5. summary")
    kernels = []
    # q4k_gemv_i8 lies on no path of planar_matmul (at M=1 that hands bf16 x to
    # q4k_gemv_qact), so its launches are 0; phase 3 holds it against its plain version
    for name, recs in kernel_results.items():
        # the shape the main path spends most time in: the widest GEMV, the longest window,
        # the 1024-token prefill
        main_rec = recs[-1] if name == "decode_attn" else recs[0]
        kernels.append(dict(
            name=name, route="cuda", source=SOURCES[name][0], replaces=SOURCES[name][1],
            launches=sum(r["counts"].get(name, 0) for r in runs), max_abs_err=max(r["max_abs_err"] for r in recs),
            nmse=max(r["nmse"] for r in recs), shape=main_rec["shape"], ms=main_rec["ms"],
            plain_ms=main_rec["plain_ms"], bound_ms=main_rec["bound_ms"], bound_by=main_rec["bound_by"],
            library_ms=main_rec["library_ms"], shapes=recs))
    print(json.dumps(dict(card=card, runs=runs, tiny_reference=tiny)))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
