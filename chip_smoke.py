#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ggml_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --long-decode-profile   # phases 1, 2 and the decode profiles after a long prompt only
    python3 chip_smoke.py --flash-times           # phases 1, 2 and kernel J's and its mask ranges' times only
    python3 chip_smoke.py --train-times           # phases 1, 2 and kernels K, L, M's times at the training shapes only
    python3 chip_smoke.py --gemv-times            # phases 1, 2 and the GEMV kernels' times at the decode shapes only
    python3 chip_smoke.py --gptj                  # phases 1, 2 and GPT-J-6B's synthesized planes (4a-4c, 4e, 4f,
                                                  # 4m-4o, 4r) at all 28 layers only
    python3 chip_smoke.py --front-end             # phases 1, 2 and the text front end (4i) only
    python3 chip_smoke.py --qlora                 # phases 1, 2, the GGUF writer and QLoRA fine-tuning (4j) only
    python3 chip_smoke.py --iquants               # phases 1, 2 and GPT-J-6B from IQ4_XS, IQ1_M, TQ2_0 files (4k) only
    python3 chip_smoke.py --llama                 # phases 1, 2 and Llama-3-8B from a Q4_K GGUF file (4l) only
    python3 chip_smoke.py --serve                 # phases 1, 2 and serving (4m: the Engine, the HTTP server; 4n: the
                                                  # paged, chunked and q8 KV engines) only
    python3 chip_smoke.py --train                 # phases 1, 2 and training (4g, 4h, 4o, 4p, 4q) only
    python3 chip_smoke.py --spec                  # phases 1, 2 and speculative decoding (4r) only
    python3 chip_smoke.py --moe                   # phases 1, 2 and the mixture-of-experts block (4s) only, Qwen3-30B-A3B
                                                  # as deep as the card and the disk allow (at most 48 layers)
    python3 chip_smoke.py --deepseek              # phases 1, 2 and the DeepSeek family (4t) only, DeepSeek-V2-Lite at
                                                  # all 27 layers
    python3 chip_smoke.py --moe-families          # phases 1, 2 and the other MoE families (4u) only, each model as
                                                  # deep as the card and the disk allow (at most its published depth)
    python3 chip_smoke.py --dense-families        # phases 1, 2 and the dense families (4v) only, each model as deep
                                                  # as the card and the disk allow (at most its published depth)

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
   32/8 at d = 128), and at Qwen3-30B-A3B's (K = 2048 and N = 4096, 512,
   2048 for A, B and C, the 151936-row Q6_K head for F and G, J under GQA
   32/4), at DeepSeek-V2-Lite's (A at K = 2048 and N = 3072, 576, 2048,
   2816; B and C on q and attn_kv_a_mqa; C at K = 2816 and G over Q5_0
   planes at K = 10944 at M = 1, 4 and 1024; F on the 102400-row head) and
   DeepSeek-V3's (A on attn_q_a, attn_q_b and attn_output; H at K = 18432;
   E on the 129280-row Q6_K head over expanded planes);
4. serve greedy requests through GPT-J-6B at its published widths
   (EleutherAI/gpt-j-6b: n_vocab 50400, E 4096, 16 heads, 28 layers, n_rot
   64, context 2048; the synthesized planes of (a)-(c), (e), (f), (m)-(o)
   and (r) at 4 of its 28 layers in the whole run, all 28 with --gptj,
   --serve, --spec and --train: the launch counts quoted below are at 28),
   decoding as CUDA graph replays (one capture per model,
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
   GGUF (Q4_K blocks, a byte-level BPE vocabulary of 50400 entries; 2 of
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
   (k) GPT-J-6B (2 of its 28 layers; all 28 with --iquants) from three GGUF
   files written with every 2-D weight in one type, IQ4_XS (E at decode),
   IQ1_M and TQ2_0 (G at every M, 6 launches a layer and one a decode
   token), each loaded as planes (as `generate --quantized` loads it) and
   deleted: the load, greedy requests from prompts of 8 and 100
   (IQ1_M also 1024, through J and G at M = 1024) as graph replays, the
   first again eagerly (the same ids), ms/token beside the plane-byte
   floor, a profiled graphed token by class; (l) Llama-3-8B at its
   published widths (meta-llama/Meta-Llama-3-8B: vocab 128256, E 4096, 32
   layers, 32 heads over 8 kv heads, n_ff 14336, rope base 500000; 2 of
   its 32 layers in the whole run, all 32 with --llama, --serve, --spec and
   --train, where the counts quoted below hold) from a 4.65 GB GGUF file of Q4_K weights with a Q6_K head and a 128256-entry
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
   (batch 4 x 512) without and with remat: K twice a layer under remat; (r)
   speculative decoding on 4a's planes: bench_spec's shape (a 2-layer
   self-draft, k = 7, 192 tokens, with bench's pinned-argmax bias, with a
   two-token bias whose rounds accept part of their drafts, and without a
   bias) against plain graphed decode, the sampled decoder, and
   bench_spec_serve's mix (8 slots, k = 4: greedy and sampled against the
   plain engine; dense and paged with the two-token bias), exact launches
   a round, every token the argmax of its own verify row and every round
   at the position of its history (the replayed rounds, or the rows the
   engines' rounds computed, read as they ran), splits from plain greedy
   reported with both rows; then 4l's Llama-3-8B through a paged engine
   with the prefix cache and a 2-layer self-draft at 4 slots, pinned (the
   final norm zeroed: ids equal) and not, its paged verify held against
   llama.forward over the gathered windows; (s) the llama family's
   mixture-of-experts block: bench_moe_decode's shape (8 layers of E 4096,
   8 experts of 7168, 2 a token, bf16 weights synthesized on the card) as
   graphed and eager greedy decode beside its two floors (every expert
   streamed; the top-2 alone), grouped against dense experts, profiles by
   class; Qwen3-30B-A3B (E 2048, 32 heads over 4, head_dim 128, 128
   experts of 768, 8 a token, vocab 151936; 2 of its 48 layers in the whole
   run) from a qwen3moe Q4_K GGUF file with a Q6_K head: the load, a
   1024-token prefill (J, C, G, the grouped experts) and graphed decode
   with exact launches, the engine at bench_serve's mix dense and paged and
   at 16 slots (grouped experts inside the tick's graph), the paged step
   against the dense forward, a captured 16-row forward against eager, LoRA
   at 1 x 512 twice (the first step bit for bit), and tiny MoE files of the
   four architectures on the card against the CPU; (t) the DeepSeek family
   (models/deepseek.py: absorbed MLA, group-limited routing, shared
   experts): bench_mla_decode's shape (16 layers of V2-Lite's attention
   with a dense FFN, bf16 synthesized on the card) graphed and eager beside
   its floor, the attention's share of busy time; DeepSeek-V2-Lite
   (deepseek-ai/DeepSeek-V2-Lite config.json: vocab 102400, E 2048, 16
   heads, kv_lora 512, 64 experts of 1408 with 2 shared, 6 a token, one
   dense layer; 2 of its 27 layers in the whole run, all 27 with
   --deepseek) from a deepseek2 Q4_K file (Q6_K head, llama.cpp's Q5_0
   fallback where K is not whole superblocks) through registry.load_model:
   the load, a 1024-token prefill and graphed decode with exact launches (C
   and G at M = 1), the generate CLI, the Engine dense, paged with the
   prefix cache, chunked, q8, at 16 slots and with a 2-layer self-draft,
   LoRA at 1 x 512 and finetune of a 2-layer cut; DeepSeek-V3's widths
   (q_lora 1536, 128 heads, 256 experts of 2048, 8 groups, sigmoid scores
   with a bias) at its 3 dense layers and 1 MoE layer: a 1024-token
   prefill, graphed decode, the route on the card against the CPU's,
   grouped against dense experts; (u) the other mixture-of-experts
   families (models/glm4moe.py with dots1, olmoe.py, dbrx.py, phimoe.py,
   gptoss.py): gpt-oss-20b, Phi-3.5-MoE, GLM-4.5-Air, OLMoE-1B-7B (2
   layers each in the whole run) and DBRX (1 layer) at their published
   widths from Q4_K GGUF files with a Q6_K head (llama.cpp's Q5_0 and Q8_0
   fallbacks where K is not whole superblocks: every gpt-oss row at K =
   2880), through registry.load_model: the load, 32 greedy tokens graphed
   and eagerly (the same ids) with exact launches beside the every-expert
   and top-k floors, a profiled decode by class, the engine at 4 slots
   (each request equal to itself alone but at tied picks), q8_kv refused;
   for gpt-oss-20b and Phi-3.5-MoE the paged engine with a prefix hit and
   the chunked one, for gpt-oss-20b a 1-layer self-draft and one HTTP
   request to cli/server.py, for Phi-3.5-MoE engines on both sides of its
   LongRoPE switch; tiny files of all six architectures (dots1 too) on the
   card against the CPU; in phase 3, G at K = 2880 and 1408 over Q5_0
   planes and on the 201088-row Q8_0 head, A at gpt-oss's, GLM-4.5-Air's
   and DBRX's attention shapes, F on the 151552- and 32064-row heads; (v)
   the dense families (models/gemma2.py for gemma, gemma2 and gemma3,
   phi2.py, phi3.py, neox.py, falcon.py): Gemma-2-9B, Gemma-3-12B, Phi-2,
   Phi-3.5-mini, GPT-NeoX-20B and Falcon-7B (4 layers each in the whole
   run) at their published widths from Q4_K GGUF files with a Q6_K head or
   a Q6_K embedding where the head is tied (Falcon-7B's K = 4544 takes the
   Q5_0 and Q8_0 fallbacks): the load, prefills of 8, 100 and 1024 tokens,
   32 greedy tokens graphed and eagerly with exact launches beside the
   plane-byte floor, a profiled decode by class, the engine at 4 slots
   dense, paged (the gemma family's and Phi-3's own steps), chunked, q8
   (the gemma family and Phi-3.5), with a 1-layer self-draft, any parting
   only at a tie; one QLoRA and one full-weight step of the four families
   JAX finetunes; tiny files of every variant and their first training
   steps on the card against the CPU; in phase 3, A, B and C at their
   attention and MLP shapes, C over multiplied-out Q4_K planes at K = 3840
   and 18176, G over Q5_0 planes at K = 4544 (N = 4544, 64, 18176), H at K
   = 14336, 15360 and 10240, F on the 51200-, 32064-, 50432-, 256000- and
   262208-row heads;
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
    as repack builds them, "q6_k_bf16" / "q5_k_bf16" (the same with bf16 d
    and dmin), "q5_0" (codes -16..15, f32 scales per 32, as repack builds
    Q5_0) and "q8_0_f32" (f32 scales per 32, as repack builds Q8_0)."""
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
    if fmt == "q5_0":  # as repack builds Q5_0: codes q - 16, one f32 scale per 32, no offsets
        return PlanarWeight(kind="q8", codes=codes(-16, 16, k), scales=small(k // 32, torch.float32), offsets=None,
                            group=32, n=n, k=k, orig_type=GGMLType.Q5_0)
    orig, dt, affine = {"q8_0": (GGMLType.Q8_0, torch.bfloat16, False),
                        "q8_0_f32": (GGMLType.Q8_0, torch.float32, False),
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
        elif fmt == "q6_k_expanded":  # compact Q6_K planes with no F tile, multiplied out for E
            pw, label = expand_compact(random_q8_planes(torch, n, k, npad, "q6_k", gen)), "q6_k expanded (f32)"
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
    # Qwen3-30B-A3B from a Q4_K file with a Q6_K head (phase 4s), E 2048: A
    # at K = 2048 on q (N = 4096) and k, v (N = 512) and at K = 4096 on
    # attn_output (N = 2048); B on them at the engine's M = 4 and 16; C at the
    # 1024-token prefill and at LoRA's M = 512; F and G on the 151936-row head
    q_q, q_kv, q_o, q_head = (2048, 4096, 4096), (2048, 512, 512), (4096, 2048, 2048), (2048, 151936, 152576)
    for shape in (q_q, q_kv, q_o):
        gemv_case("q4k_gemv_qact", 1, *shape, d_dtype=torch.float32)
        gemv_case("q4k_gemv_rows", 4, *shape, d_dtype=torch.float32)
        gemv_case("q4k_matmul", 1024, *shape, d_dtype=torch.float32)
    gemv_case("q4k_gemv_rows", 16, *q_q, d_dtype=torch.float32)
    gemv_case("q4k_matmul", 512, *q_q, d_dtype=torch.float32)
    for m in (1, 4, 16):
        gemv_case("q8_gemv_sb", m, *q_head, fmt="q6_k")
    gemv_case("q8_matmul", 1024, *q_head, fmt="q6_k")
    # DeepSeek-V2-Lite from a deepseek2 Q4_K file with a Q6_K head (phase
    # 4t), E 2048: A at K = 2048 on q (N = 3072), attn_kv_a_mqa (576),
    # attn_output (2048) and the shared experts' gate and up (2816), B at the
    # engine's M = 4 and C at the 1024-token prefill on q and attn_kv_a_mqa;
    # at every M, C on the shared ffn_down (K = 2816: Q4_K planes multiplied
    # out, 44 groups a half-plane, no GEMV tile) and G on the dense layer's
    # ffn_down (K = 10944: Q5_0 int8 planes, 342 groups); F on the
    # 102400-row head.  DeepSeek-V3's widths (E 7168): A on attn_q_a (K =
    # 7168, N = 1536), attn_q_b (K = 1536, N = 24576) and attn_output (K =
    # 16384, N = 7168); H on the dense ffn_down (K = 18432: no compact
    # tile, expanded); E on the 129280-row Q6_K head (K = 7168: no F tile,
    # expanded)
    v2_q, v2_kva, v2_o, v2_sh = (2048, 3072, 3072), (2048, 576, 640), (2048, 2048, 2048), (2048, 2816, 2816)
    for shape in (v2_q, v2_kva, v2_o, v2_sh):
        gemv_case("q4k_gemv_qact", 1, *shape, d_dtype=torch.float32)
    for shape in (v2_q, v2_kva):
        gemv_case("q4k_gemv_rows", 4, *shape, d_dtype=torch.float32)
        gemv_case("q4k_matmul", 1024, *shape, d_dtype=torch.float32)
    for m in (1, 4, 1024):
        gemv_case("q4k_matmul", m, 2816, 2048, 2048, fmt="q4_0_f32")
        gemv_case("q8_matmul", m, 10944, 2048, 2048, fmt="q5_0")
    gemv_case("q8_gemv_sb", 1, 2048, 102400, 102400, fmt="q6_k")
    for shape in ((7168, 1536, 1536), (1536, 24576, 24576), (16384, 7168, 7168)):
        gemv_case("q4k_gemv_qact", 1, *shape)
    gemv_case("q4_gemv", 1, 18432, 7168, 7168, fmt="q4_k_expanded")
    gemv_case("q8_gemv", 1, 7168, 129280, 130048, fmt="q6_k_expanded")
    # the other mixture-of-experts families from Q4_K files with a Q6_K head
    # (phase 4u).  gpt-oss-20b, E 2880: every row at K = 2880 is a Q5_0
    # plane (llama.cpp's fallback; 90 groups of 32, no GEMV tile), so G at
    # every M on q (N = 4096), k and v (N = 512) and an expert-sized N =
    # 2880, and on the 201088-row head (Q6_K's fallback, Q8_0); A on
    # attn_output (K = 4096, N = 2880).  GLM-4.5-Air, E 4096: A on q (N =
    # 12288) and attn_output (K = 12288), G on the shared expert's ffn_down
    # (K = 1408, Q5_0: 44 groups), F on the 151552-row head.  DBRX: A at K =
    # 6144 on q (N = 6144) and k, v (N = 1024).  F on Phi-3.5-MoE's
    # 32064-row head.
    for m in (1, 4, 1024):
        for n, npad in ((4096, 4096), (512, 512), (2880, 2944)):
            gemv_case("q8_matmul", m, 2880, n, npad, fmt="q5_0")
    for m in (1, 4):
        gemv_case("q8_matmul", m, 2880, 201088, 201728, fmt="q8_0_f32")
        gemv_case("q8_matmul", m, 1408, 4096, 4096, fmt="q5_0")
    for shape in ((4096, 2880, 2944), (4096, 12288, 12288), (12288, 4096, 4096), (6144, 6144, 6144),
                  (6144, 1024, 1024)):
        gemv_case("q4k_gemv_qact", 1, *shape, d_dtype=torch.float32)
    gemv_case("q8_gemv_sb", 1, 4096, 151552, 151552, fmt="q6_k")
    gemv_case("q8_gemv_sb", 1, 4096, 32064, 32768, fmt="q6_k")
    # the dense families from Q4_K files with a Q6_K head (phase 4v).
    # Gemma-2-9B, E 3584: A on q (N = 4096), k and v (2048), gate and up
    # (14336), attn_output (K = 4096); ffn_down (K = 14336) has no compact
    # tile: H over expanded planes.  Gemma-3-12B, E 3840: K % 512 != 0, so
    # q, k, v, gate and up are Q4_K planes multiplied out (f32 scales and
    # offsets per 32, as repack builds them) with 60 groups a half-plane, no
    # GEMV tile: C at every M, decode included; H on ffn_down (K = 15360,
    # expanded).  Phi-2 (E 2560): A on q and ffn_up (10240), H on ffn_down
    # (K = 10240), F on the 51200-row head.  Phi-3.5-mini (E 3072): A on q,
    # gate (8192) and ffn_down (K = 8192), F on the 32064-row head at K =
    # 3072.  GPT-NeoX-20B (E 6144): A on q, ffn_up (24576) and ffn_down (K =
    # 24576), F on the 50432-row head.  Falcon-7B (E 4544, not whole
    # superblocks): q, k, v (N = 64, padded to 128), attn_output and ffn_up
    # are Q5_0 planes with 142 groups: G at every M; ffn_down (K = 18176)
    # multiplied-out Q4_K with 284 groups a half-plane: C at every M.  The
    # tied heads of Gemma and Falcon are the embeddings' dense copies (a
    # library product, as JAX's einsum), not planes: F is held at Gemma's
    # widths all the same (N = 256000 at K = 3584, 262208 at K = 3840, padded
    # to 263168).
    for shape in ((3584, 4096, 4096), (3584, 2048, 2048), (3584, 14336, 14336), (4096, 3584, 3584),
                  (4096, 3840, 3840), (2560, 2560, 2560), (2560, 10240, 10240), (3072, 8192, 8192),
                  (8192, 3072, 3072), (6144, 24576, 24576), (24576, 6144, 6144)):
        gemv_case("q4k_gemv_qact", 1, *shape, d_dtype=torch.float32)
    for shape in ((3584, 4096, 4096), (3072, 3072, 3072), (6144, 6144, 6144)):
        gemv_case("q4k_gemv_rows", 4, *shape, d_dtype=torch.float32)
        gemv_case("q4k_matmul", 1024, *shape, d_dtype=torch.float32)
    for m in (1, 4, 1024):
        gemv_case("q4k_matmul", m, 3840, 4096, 4096, fmt="q4_0_f32")
        gemv_case("q4k_matmul", m, 18176, 4544, 5120, fmt="q4_0_f32")
        for n, npad in ((4544, 5120), (64, 128), (18176, 18432)):
            gemv_case("q8_matmul", m, 4544, n, npad, fmt="q5_0")
    gemv_case("q4k_matmul", 1, 3840, 15360, 15360, fmt="q4_0_f32")
    for k, n in ((14336, 3584), (15360, 3840), (10240, 2560)):
        gemv_case("q4_gemv", 1, k, n, n, fmt="q4_k_expanded")
    for k, n, npad in ((2560, 51200, 51200), (3072, 32064, 32768), (6144, 50432, 51200), (3584, 256000, 256000),
                       (3840, 262208, 263168)):
        gemv_case("q8_gemv_sb", 1, k, n, npad, fmt="q6_k")

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
    flash_case(1, 32, 4, 1024, 1024, 128, "mixed")      # Qwen3-30B-A3B's 1024-token prefill: GQA 32/4 (phase 4s)
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


def gptj_config_of(params: dict):
    """GPT-J-6B's config for synthesized weights (gptj.random_config("6b"))
    at the depth `params` holds: the whole run cuts it, the phases' own
    flags run all 28 layers."""
    from ggml_tpu_torch.models import gptj

    n_layer = 1 + max(int(k.split(".")[1]) for k in params if k.startswith("blk."))
    return dataclasses.replace(gptj.random_config("6b"), n_layer=n_layer)


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

    cfg = cfg or gptj_config_of(params)
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
        if e.name in ("gptj.attention", "family.attention") or e.name.endswith(_ATTENTION_BACKWARD):
            return "attention"
        e = e.cpu_parent
    return "other"


_QLORA_RANGES = ("planar_matmul.bwd_dequant", "planar_matmul.bwd_product", "gptj.attention", "family.attention")


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
    cfg = gptj_config_of(params)
    rng = np.random.default_rng(0)
    x, y = (torch.from_numpy(rng.integers(0, cfg.n_vocab, (batch, seq))).cuda() for _ in range(2))
    before = tensor_checksums(torch, params)
    forward = planar_launches(params, batch * seq, head=True)
    recomputed = planar_launches(params, batch * seq, head=False)
    linears = 3 * cfg.n_layer + 1  # the fused qkvup, attn_output, ffn_down a layer, and the head
    check(forward == {"q4k_matmul": linears} and recomputed == {"q4k_matmul": linears - 1},
          f"kernels at M = {batch * seq}: "
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
        want["q4k_matmul"] = (linears + (linears - 1 if policy else 0)) * steps
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
    linears = 7 * cfg.n_layer  # the Q4_K linears, every one adapted (224 at 32 layers)
    check(forward == {"q4k_matmul": linears, "q8_matmul": 1} and recomputed == {"q4k_matmul": linears},
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
        want.update(q4k_matmul=(linears + (linears if policy else 0)) * steps, q8_matmul=steps)
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
LLAMA_LAYERS = 4  # the whole run's depth of Llama-3-8B (--llama, --serve, --spec, --train: all 32)


def llama_step_launches(n_layer: int, m: int = 1) -> dict:
    """Planar launches of one Llama-3-8B token step by wrapper at n_layer
    layers: at M = 1 (decode) A, at 2 <= M <= 32 (an engine step) B, on the
    6 linears of a layer at K = 4096 (q, k, v, attn_output, ffn_gate,
    ffn_up), H on its ffn_down (K = 14336: expanded planes), F on the Q6_K
    head (225 at 32 layers)."""
    return {"q4k_gemv_qact" if m == 1 else "q4k_gemv_rows": 6 * n_layer, "q4_gemv": n_layer, "q8_gemv_sb": 1}


def write_llama3_8b_gguf(np, tmp: str, n_layer: int = 32) -> tuple:
    """The GGUF file phase 4l reads, written into the directory tmp with the
    port's writer (models/llama.write_random_gguf): Llama-3-8B's published
    widths at n_layer of its 32 layers, every 2-D weight Q4_K but output.weight Q6_K (as llama.cpp's
    Q4_K_S and Q4_K_M files keep the head), F32 norms, a byte-level BPE
    vocabulary of 128256 entries (tokenizer.ggml.model gpt2, as Llama 3's
    files have: the 256 byte symbols, the merges learned from
    FRONT_END_TEXT, lowercase placeholder words, then <|begin_of_text|> at
    128000, <|end_of_text|> at 128001 and reserved special tokens).  Returns
    (path, dict(gguf_write_s, gguf_bytes), tokens, merges)."""
    from ggml_tpu_torch.dtypes import GGMLType
    from ggml_tpu_torch.models import llama
    from ggml_tpu_torch.tokenizer import byte_level_vocab, learn_merges

    cfg = dataclasses.replace(llama.llama3_8b_config(), n_layer=n_layer)
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


_LLAMA_RANGES = {"planar_matmul.expand_compact": "H expansions", "family.attention": "attention"}
_MOE_RANGES = {**_LLAMA_RANGES, "llama.moe_experts": "experts", "llama.moe_router": "router"}


def _llama_class(event, kernel: str, ranges: dict = _LLAMA_RANGES, n_vocab: int | None = None) -> str:
    """A kernel's class in a llama-family trace: the port's kernels by name
    (A, H, F, E by their plane layout, C, G, J), then by the ranges around
    the op that launched it (ranges: range name -> class), then, given
    n_vocab, the head by its product's N, else other."""
    m = re.search(r"Planes<(true|false), (true|false)", kernel)
    if m:
        return _GEMV_CLASS[m[1], m[2]]
    for name, cls in (("q4k_matmul_kernel", "C"), ("qmatmul_xsum_kernel", "C"), ("q8_matmul_kernel", "G"),
                      ("fa_sm90_kernel", "J"), ("flash_split_kernel", "J"), ("flash_mask_ranges_kernel", "J")):
        if name in kernel:
            return cls
    while event is not None:
        if event.name in ranges:
            return ranges[event.name]
        if n_vocab and event.name in ("aten::mm", "aten::addmm") and any(n_vocab in s for s in event.input_shapes or () if s):
            return "head"
        event = event.cpu_parent
    return "other"


def profile_classes(torch, fn, steps: int = 1, ranges: dict = _LLAMA_RANGES, n_vocab: int | None = None) -> dict:
    """fn() once under torch.profiler after a sync, fn running `steps`
    steps: host ms, device busy ms (copies included), the idle share 1 -
    busy / host, busy ms by _llama_class and the kernel launches, each a
    step.  Every device event is booked by its kernel's name; then each
    kernel the profiler ties to the op that launched it (it ties none to a
    cudaLaunchKernelExC, the GEMVs' launch, nor to a graph replay's) and
    that its name leaves in "other" moves to the class of the ranges around
    that op (or to the head)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], record_shapes=n_vocab is not None) as prof:
        t0 = time.perf_counter()
        with torch.no_grad():
            fn()
        torch.cuda.synchronize()
        host = (time.perf_counter() - t0) * 1e3 / steps
    by: dict = {}
    for e in _device_events(prof):
        if e.key in ranges or e.key.startswith("planar_matmul.") or getattr(e, "is_user_annotation", False):
            continue  # a range's device span: its kernels, and the gaps between them
        cls = _llama_class(None, e.key)
        by[cls] = by.get(cls, 0.0) + e.self_device_time_total / 1e3 / steps
    busy = sum(by.values())
    for e in prof.events():
        for k in getattr(e, "kernels", ()):
            cls = _llama_class(e, k.name, ranges, n_vocab)
            if cls != "other" and _llama_class(None, k.name) == "other":
                by[cls] = by.get(cls, 0.0) + k.duration / 1e3 / steps
                by["other"] = by.get("other", 0.0) - k.duration / 1e3 / steps
    launches = sum(e.count for e in prof.key_averages() if e.key.startswith("cudaLaunchKernel")) / steps
    return dict(host_ms=host, busy_ms=busy, idle_share=1 - busy / host, by_class_ms=by, launches=launches)


def _fmt_classes(d: dict) -> str:
    return ", ".join(f"{k} {v:.3f}" for k, v in sorted(d.items(), key=lambda kv: -kv[1]))


def profile_llama_decode(torch, np, model, steps: int = 32, prompt: int = 8, ranges: dict = _LLAMA_RANGES,
                         n_vocab: int | None = None) -> dict:
    """Llama decode after a `prompt`-token prompt (after the launch counters
    are read): host ms/token of `steps` graphed replays, then under
    torch.profiler the same request again: device busy a token, the idle
    share 1 - busy / host, and busy by class (profile_classes: by the
    kernels' names alone in a replay); then 8 eager steps, where the ops of
    the ranges (the H expansions, the attention; the experts and the router
    under _MOE_RANGES) and, given n_vocab, the head get their classes."""

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
    graphed = profile_classes(torch, lambda: model.decode_greedy(cache, first, n_past, steps), steps)
    cache, first, n_past = request()
    eager_steps = 8
    eager = profile_classes(torch, lambda: model.decode_greedy(cache, first, n_past, eager_steps, graph=False),
                            eager_steps, ranges, n_vocab)
    busy = graphed["busy_ms"]
    trace = dict(steps=steps, prompt=prompt, host_ms_per_token=host_ms, device_ms_per_token=busy,
                 idle_share=1.0 - busy / host_ms, graphed_ms_per_token_by_class=graphed["by_class_ms"],
                 eager_ms_per_token_by_class=eager["by_class_ms"], eager_launches_per_token=eager["launches"],
                 eager_device_ms_per_token=eager["busy_ms"], eager_host_ms_per_token=eager["host_ms"])
    print(f"  graphed decode, {steps} steps at pos {prompt}..{prompt + steps - 1}: host {host_ms:.3f} ms/token, "
          f"device busy {busy:.3f} (idle {trace['idle_share'] * 100:.1f} %); by class (ms/token): "
          f"{_fmt_classes(graphed['by_class_ms'])}")
    print(f"  eager decode, {eager_steps} steps, {eager['launches']:.0f} kernel launches/token, device busy "
          f"{eager['busy_ms']:.3f} ms/token; by class: {_fmt_classes(eager['by_class_ms'])}")
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


def phase_llama(torch, np, tmp: str, card: str, serve: bool = False, train: bool = False, n_layer: int = 32) -> dict:
    """4l: Llama-3-8B at its published widths (meta-llama/Meta-Llama-3-8B
    config.json: vocab 128256, E 4096, 32 layers, 32 heads over 8 kv heads,
    head_dim 128, n_ff 14336, rope base 500000, context 8192, untied head)
    from the Q4_K GGUF file write_llama3_8b_gguf writes into tmp, loaded as
    planes through Llama.from_gguf (what `generate --quantized` does):
    greedy requests of 64 tokens from prompts of 8 and 100 decoded as graph
    replays with exact launch counts (225 planar launches a decode token,
    llama_step_launches), the first again eagerly (the same ids), a seeded
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
    path, info, tokens, merges = write_llama3_8b_gguf(np, tmp, n_layer)
    out = dict(info)
    t0 = time.perf_counter()
    model = llama.Llama.from_gguf(path, max_seq=2048, device="cuda")
    torch.cuda.synchronize()
    out["load_s"] = time.perf_counter() - t0
    cfg = model.cfg
    want_cfg = dataclasses.replace(llama.llama3_8b_config(), n_layer=n_layer)
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
        for k, n in llama_step_launches(cfg.n_layer).items():
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
        stage("4r. speculative serving: Llama-3-8B (the same model), 4 slots, paged with the prefix cache, "
              "2-layer self-draft")
        out["spec"] = phase_spec_llama(torch, np, model, card)
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

    cfg = gptj_config_of(params)
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
    want["q4k_gemv_rows"] += (3 * cfg.n_layer + 1) * delta["decode_steps"]  # B on every linear a step
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
    for label, m, e, q, bucket in ((f"B both sides, {cfg.n_layer} layers", model, eng, p[:4], 4),
                                   (f"C against B, {cfg.n_layer} layers", model, eng, p, SERVE_BUCKET),
                                   ("C against B, 1 layer", one, eng_one, p, SERVE_BUCKET)):
        step = _first_step_logits(torch, np, e, q, bucket)
        solo = m.prefill(m.new_cache(torch.bfloat16), np.asarray([q]))[0][0].float()
        top2 = torch.topk(solo, 2).values
        out["first_step_vs_b1"][label] = dict(prompt=len(q), nmse=errors(solo, step)[0],
                                              top2_gap=float(top2[0] - top2[1]),
                                              same_argmax=bool(step.argmax() == solo.argmax()))
    gate = out["first_step_vs_b1"][f"B both sides, {cfg.n_layer} layers"]
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
    for k, n in llama_step_launches(cfg.n_layer, 4).items():
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
    prefills, chunk dispatches and suffix prefills) as (rows M, head run).
    attr "_draft_fwd" with only_prefill: the draft's prefills (its eager
    steps on a paged engine are counted by round)."""

    def __init__(self, eng, attr: str = "_fwd", only_prefill: bool = False):
        self.eng, self.attr, self.only_prefill, self.calls = eng, attr, only_prefill, []
        self.fwd = getattr(eng, attr)
        setattr(eng, attr, self)

    def __call__(self, params, cfg, tokens, *args, need_logits=True, **kw):
        if kw.get("prefill") or not self.only_prefill:
            self.calls.append((tokens.shape[0] * tokens.shape[1], need_logits))
        return self.fwd(params, cfg, tokens, *args, need_logits=need_logits, **kw)

    def close(self):
        setattr(self.eng, self.attr, self.fwd)


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
        if re.fullmatch(r"(gptj|family)\.attention|planar_matmul\..*", key):
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

    cfg = gptj_config_of(params)
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

    cfg = gptj_config_of(params)
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

    cfg = gptj_config_of(params)
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
    for label, m in ((f"{cfg.n_layer} layers", model), ("1 layer", one)):
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
              f"{run['tok_per_s']:.1f} tok/s, {run['ms_per_step']:.3f} ms a step on the card, "
              f"idle {run['idle_share'] * 100:.1f} %; prefix hits {delta['cached_prefix_tokens']}; "
              f"launches {run['counts']}")
        del eng
        gc.collect()
    out["paged_equal_chunked"] = sum(a == b for a, b in zip(out["paged"].pop("ids"), out["chunked"].pop("ids")))
    out["counts"] = counts
    print(f"  {out['paged_equal_chunked']} of {len(prompts)} requests give the same ids through both engines "
          "(not gated: suffix prefills and chunks take C and B at other M)")
    torch.cuda.empty_cache()
    return out


# 4r: speculative decoding.  bench_spec (bench.py:836-904): GPT-J-6B Q4_K
# with _spec_bias_params' output bias, a 2-layer self-draft over the target's
# tensors, k = 7, 192 tokens from token 11 at n_past 0, max_seq 256;
# bench_spec_serve (:907-968): 8 slots, 24 requests of 4-30-token prompts
# from default_rng(0) x 32 new, k = 4, the same draft, max_seq 256, bucket
# 32, two warm passes, greedy and sampled (temperature 0.7, top_k 40, top_p 0.95)
SPEC_K, SPEC_TOKENS, SPEC_FIRST, SPEC_DRAFT_LAYERS, SPEC_SERVE_K = 7, 192, 11, 2, 4
SPEC_PARTIAL_PROMPT = 32  # 4r (a)'s partial run: random prompt tokens before the first
SPEC_SAMPLER = {"temperature": 0.7, "top_k": 40, "top_p": 0.95}


def spec_partial_params(torch, params: dict, n_vocab: int) -> dict:
    """A draft that agrees in part: an f32 output bias of 1e4 on tokens 7
    and 11 alike (far above the logits of random weights, so that both
    models always answer one of the two; f32 at 1e4 keeps the raw logits to
    1e-3), and the 2-layer draft and the deeper target pick the same one
    about as often as not: rounds accept some of their drafts.  The planes
    are shared; the logits less the bias are the raw ones."""
    bias = torch.zeros((n_vocab,), dtype=torch.float32, device="cuda")
    bias[torch.tensor([7, 11], device="cuda")] = 1.0e4
    return dict(params) | {"output.bias": bias}


def spec_bias_params(torch, params: dict, n_vocab: int) -> dict:
    """bench.py's _spec_bias_params: an f32 output bias that pins the argmax
    (3e5, 2e5, 1e5 on tokens 7, 11, 23, far above the logits of random
    weights), so that draft and target agree by construction and the run
    measures the machinery at its ceiling.  The planes are shared."""
    bias = torch.zeros((n_vocab,), dtype=torch.float32, device="cuda")
    bias[torch.tensor([7, 11, 23], device="cuda")] = torch.tensor([3.0e5, 2.0e5, 1.0e5], device="cuda")
    return dict(params) | {"output.bias": bias}


def layer_launches(params: dict, n_layer: int, m: int, head: bool, times: int = 1, into: dict | None = None) -> dict:
    """planar_launches over the first n_layer layers only (a draft that is a
    prefix of the target's layers over its tensors), the head where it runs."""
    from ggml_tpu_torch.kernels import qmatmul
    from ggml_tpu_torch.quant.planar import PlanarWeight

    out = {} if into is None else into
    for key, w in params.items():
        if not isinstance(w, PlanarWeight) or key == "token_embd.weight" or (key == "output.weight" and not head):
            continue
        if key.startswith("blk.") and int(key.split(".")[1]) >= n_layer:
            continue
        name = qmatmul.select_kernel(w, m)
        out[name] = out.get(name, 0) + times
    return out


def spec_round_launches(target, draft, k: int, b: int) -> dict:
    """The launches of one speculative round over b slots: k draft steps at
    M = b with the head, the step that writes d_k's row without it, the
    verify at M = b (k + 1); GPT-J's draft steps at b = 1 and one position
    take the decode attention (kernel D) in each layer."""
    from ggml_tpu_torch.models import gptj

    out = layer_launches(draft.params, draft.cfg.n_layer, b, True, k)
    layer_launches(draft.params, draft.cfg.n_layer, b, False, 1, into=out)
    layer_launches(target.params, target.cfg.n_layer, b * (k + 1), True, 1, into=out)
    if b == 1 and isinstance(draft, gptj.GPTJ):
        out["decode_attn"] = draft.cfg.n_layer * (k + 1)
    return out


def teacher_forced_verify(torch, model, tokens: list, accepted: list, k: int, keep: int | None = None,
                          start: int = 0, cache=None) -> dict:
    """The verify rows of a speculative run replayed: round r starts at
    position p (p_0 = start, p_r+1 = p_r + accepted_r + 1) and runs the
    target over tokens[p:p + k + 1] (zero-padded) at p over one cache (a
    fresh one, or `cache` prefilled with tokens[:start]), the call the
    decoder makes; row j <= accepted_r is the row the real verify computed
    (its inputs are the accepted tokens, its cache rows those of the
    accepted history; rows past it are rewritten by the next round).
    Returns {emitted index: (argmax, top-2 gap)} and, for index `keep`,
    the row."""
    from ggml_tpu_torch.speculative import _forward_for

    cache = model.new_cache() if cache is None else cache
    out, row = {}, None
    p = start
    with torch.no_grad():
        for a in accepted:
            seq = (tokens[p:p + k + 1] + [0] * (k + 1))[:k + 1]
            pos = torch.full((), p, dtype=torch.int32, device=model.device)
            logits = _forward_for(model)(model.params, model.cfg, torch.tensor([seq], device=model.device),
                                         pos.expand(1), cache, pos)[0][0].float()
            best = torch.argmax(logits[:a + 1], dim=-1)  # the first of tied maxima, as the decoder's argmax
            top = torch.topk(logits[:a + 1], 2, dim=-1).values
            for j in range(a + 1):
                out[p - start + j] = (int(best[j]), float(top[j, 0] - top[j, 1]))
                if p - start + j == keep:
                    row = logits[j].clone()
            p += a + 1
    return out, row


def plain_logits_at(torch, model, tokens: list, q: int, start: int = 0, cache=None, batch: int = 1):
    """The logits a plain decode step computes for emitted index q: eager
    steps over tokens[start..start + q] from a fresh cache or `cache`
    (prefilled with tokens[:start]): kernels A and D, as the graph.  batch
    2: the same steps over the sequence twice (M = 2: kernel B, the verify's
    route; the prefix prefilled at b = 2)."""
    from ggml_tpu_torch.speculative import _forward_for

    fwd = _forward_for(model)
    if batch > 1:
        cache = [(kc.repeat(batch, 1, 1, 1), vc.repeat(batch, 1, 1, 1)) for kc, vc in model.new_cache()]
    elif cache is None:
        cache = model.new_cache()
    dev = model.device
    with torch.no_grad():
        if batch > 1 and start:
            zero = torch.zeros((), dtype=torch.int32, device=dev)
            fwd(model.params, model.cfg, torch.tensor([tokens[:start]] * batch, device=dev), zero.expand(batch),
                cache, zero, prefill=True, need_logits=False)
        for i in range(start, start + q + 1):
            pos = torch.full((), i, dtype=torch.int32, device=dev)
            logits, _ = fwd(model.params, model.cfg, torch.tensor([[tokens[i]]] * batch, device=dev),
                            pos.expand(batch), cache, pos)
    return logits[0, -1].float()


class SpecTap:
    """The verify rows a greedy speculative engine's rounds computed, read
    as they ran.  Installed before the engine's first tick (so that every
    capture holds it), it wraps the engine's round: each round's verify
    inputs (tokens (B, k + 1), positions (B,)) and logits (B, k + 1, V) are
    copied into static f32 buffers (one copy each a round, inside the
    round's graph), and each fetched stretch is read from them before the
    engine consumes it: per request its rounds as (position, tokens fed,
    n_acc, block, the argmax of each row, and with keep_rows the rows).
    reference(eng, tokens, positions) -> logits: a verify of the same
    inputs by another route over the engine's pools or cache as they stand
    after the replay; its NMSE against the engine's rows of live slots is
    kept a round (paged engines: one round a replay)."""

    def __init__(self, torch, eng, reference=None, keep_rows: bool = False):
        from ggml_tpu_torch.serve import SPEC_STRETCH

        r = 1 if eng.paged is not None else SPEC_STRETCH
        b, t, v = eng.max_batch, eng.draft_k + 1, eng.cfg.n_vocab
        self.logits = torch.zeros((r, b, t, v), dtype=torch.float32, device=eng.device)
        self.tokens = torch.zeros((r, b, t), dtype=torch.long, device=eng.device)
        self.pos = torch.zeros((r, b), dtype=torch.long, device=eng.device)
        self.eng, self.reference, self.keep_rows, self.i = eng, reference, keep_rows, 0
        self.rounds: dict = {}
        self.first: dict = {}  # request -> its first token emitted by a round (check)
        self.nmse: list = []
        self.saved = {name: getattr(eng, name) for name in
                      ("_spec_round", "_spec_rounds", "_spec_paged_round", "_consume_spec_blocks")}
        spec_round, consume = self.saved["_spec_round"], self.saved["_consume_spec_blocks"]

        def tapped_round(sampled, verify):
            def tapped_verify(seq, pos):
                out = verify(seq, pos)
                self.logits[self.i].copy_(out)
                self.tokens[self.i].copy_(seq)
                self.pos[self.i].copy_(pos)
                self.i += 1
                return out
            return spec_round(sampled, tapped_verify)

        def restart(fn):
            def run(*args):
                self.i = 0
                return fn(*args)
            return run

        def tapped_consume(blocks, n_accs, active):
            self._take(torch, blocks, n_accs, active)
            return consume(blocks, n_accs, active)

        eng._spec_round = tapped_round
        eng._spec_rounds = restart(self.saved["_spec_rounds"])
        eng._spec_paged_round = restart(self.saved["_spec_paged_round"])
        eng._consume_spec_blocks = tapped_consume

    def _take(self, torch, blocks, n_accs, active):
        eng, r = self.eng, blocks.shape[0]
        best = self.logits[:r].argmax(dim=-1).cpu().numpy()  # the first of tied maxima, as the engine's argmax
        tokens, pos = self.tokens[:r].cpu().numpy(), self.pos[:r].cpu().numpy()
        live = [i for i, s in enumerate(eng.slots) if s is not None and not s.done and active[i]]
        if self.reference is not None and live:
            with torch.no_grad():
                ref = self.reference(eng, self.tokens[0], self.pos[0].to(torch.int32)).float()
            self.nmse.append(max(errors(ref[i], self.logits[0, i])[0] for i in live))
        for j in range(r):
            for i in live:
                self.rounds.setdefault(eng.slots[i].rid, []).append(dict(
                    pos=int(pos[j, i]), tokens=tokens[j, i].tolist(), n_acc=int(n_accs[j, i]),
                    block=blocks[j, i].tolist(), argmax=best[j, i].tolist(),
                    rows=self.logits[j, i].clone() if self.keep_rows else None))

    def close(self):
        for name, fn in self.saved.items():
            setattr(self.eng, name, fn)

    def check(self, prompts, rids, ids, k: int) -> dict:
        """The rounds against the emitted ids, exactly: round by round from
        the prompt's end (at its last token where the admission re-decodes
        it, emitting token 0; past it where the prefill emitted token 0),
        each round's position and first token those of the history so far,
        its drafts fed, and each emitted token the argmax of its own verify
        row; the rounds that accepted some but not all of their drafts
        counted."""
        bad, rounds, partial, accepted = [], 0, 0, 0
        for rid, prompt, out in zip(rids, prompts, ids):
            mine = self.rounds.get(rid, [])
            redecode = bool(mine) and mine[0]["pos"] == len(prompt) - 1
            toks, p, e = list(prompt) + list(out), len(prompt) - redecode, 1 - redecode
            self.first[rid] = e
            for rd in mine:
                if e >= len(out):
                    break
                n = rd["n_acc"]
                rounds += 1
                partial += 0 < n < k
                accepted += n
                if rd["pos"] != p or rd["tokens"][0] != toks[p]:
                    bad.append(f"request {rid}: a round at position {rd['pos']} feeding {rd['tokens'][0]}, want "
                               f"{p} feeding {toks[p]}")
                for j in range(min(n + 1, len(out) - e)):
                    if not rd["block"][j] == out[e + j] == rd["argmax"][j]:
                        bad.append(f"request {rid}, token {e + j}: emitted {out[e + j]}, block {rd['block'][j]}, "
                                   f"its verify row's argmax {rd['argmax'][j]}")
                    if j < n and rd["tokens"][j + 1] != rd["block"][j]:
                        bad.append(f"request {rid}: draft {j + 1} fed {rd['tokens'][j + 1]}, accepted {rd['block'][j]}")
                p, e = p + n + 1, e + n + 1
            if e < len(out):
                bad.append(f"request {rid}: its rounds cover {e} of {len(out)} tokens")
        return dict(bad=bad, rounds=rounds, partial_rounds=partial, acceptance=accepted / max(1, rounds * k),
                    reference_nmse=max(self.nmse, default=None))

    def row(self, rid, q: int):
        """The verify row that emitted token q of request rid (keep_rows,
        after check; None for a token the prefill emitted)."""
        e = self.first[rid]
        if q < e:
            return None
        for rd in self.rounds[rid]:
            if e + rd["n_acc"] >= q:
                return rd["rows"][q - e]
            e += rd["n_acc"] + 1
        raise KeyError(q)


def gathered_reference(fwd):
    """A verify of a paged engine's round by another route: the family's
    dense forward over the slots' windows gathered from the pools (the
    tables the round used), at the round's positions; it writes the round's
    rows into its copy as the paged step wrote them into the pages."""
    from ggml_tpu_torch.paged_kv import paged_gather

    def ref(eng, tokens, pos):
        views = [(paged_gather(kp, eng._ptables), paged_gather(vp, eng._ptables)) for kp, vp in eng.mgr.pools]
        return fwd(eng.model.params, eng.cfg, tokens, pos, views, pos)[0]

    return ref


def tapped_run(torch, eng, prompts, n_new: int, reference=None, keep_rows: bool = False):
    """One pass of a mix through a speculative engine under a SpecTap
    (installed before the engine's first tick); returns (ids, request ids,
    the tap's check, the tap)."""
    tap = SpecTap(torch, eng, reference, keep_rows)
    try:
        rids = [eng.submit(p, n_new) for p in prompts]
        res = eng.run(bucket=SERVE_BUCKET)
    finally:
        tap.close()
    ids = [res[r] for r in rids]
    return ids, rids, tap.check(prompts, rids, ids, eng.draft_k), tap


def phase_spec_gptj(torch, np, params: dict, card: str) -> dict:
    """4r (a): bench_spec's shape on 4a's planes.  Plain graphed greedy
    decode of 192 tokens in the same process, then the speculative decoder
    (one round a CUDA graph replay, replayed in groups) over a 2-layer
    self-draft at k = 7: ids, rounds, the acceptance rate, ms a round,
    ms/token against plain, the exact launches a round (A: 7 GEMVs a draft
    step and 6 for the step that writes d_k's row; D: 2 a draft step; B: 85
    for the verify's 8 rows), each emitted token the argmax of its verify
    row (the rounds replayed over the emitted tokens from a fresh cache: the
    same calls, so the same rows where the decoder kept its positions and
    caches right).  Three outputs: bench's pinned-argmax bias from token 11
    at n_past 0 (every draft accepted; the ids equal plain greedy's); the
    two-token bias of spec_partial_params after a 32-token random prompt
    (from token 11 alone both models repeat token 7), whose rounds must
    accept some of their drafts (at least one round, an acceptance strictly
    between 0 and 1); and no bias from token 11 (none accepted).  The
    verify's rows take B (int8 activations per row) where plain decode takes
    A (per K-tile); where the ids part from plain greedy, the plain row there
    must give the plain id as its argmax, and its route difference to the
    verify row (NMSE of the logits less the bias), the two candidates'
    margins on both rows and the same step at M = 2 (B's route) are
    reported."""
    from ggml_tpu_torch.models import gptj
    from ggml_tpu_torch.speculative import make_speculative_decoder

    cfg = gptj_config_of(params)
    k, n = SPEC_K, SPEC_TOKENS
    out, problems = dict(counts={}), []
    prompt = np.random.default_rng(0).integers(0, cfg.n_vocab, SPEC_PARTIAL_PROMPT).tolist()
    variants = (("bias", spec_bias_params(torch, params, cfg.n_vocab), []),
                ("partial", spec_partial_params(torch, params, cfg.n_vocab), prompt), ("no_bias", params, []))
    clone = lambda c: [(kc.clone(), vc.clone()) for kc, vc in c]
    for label, p, pre in variants:
        target = gptj.GPTJ(p, cfg, max_seq=256, device="cuda")
        mem = torch.cuda.memory_allocated()
        draft = gptj.GPTJ(p, dataclasses.replace(cfg, n_layer=SPEC_DRAFT_LAYERS), max_seq=256, device="cuda")
        check(torch.cuda.memory_allocated() == mem, "GPT-J spec: building the self-draft allocated memory")
        tc0, dc0, first, start = target.new_cache(), draft.new_cache(), SPEC_FIRST, 0
        if pre:
            with torch.no_grad():
                tlog, tc0, start = target.prefill(tc0, np.asarray([pre]))
                draft.prefill(dc0, np.asarray([pre]))
            first = int(torch.argmax(tlog[0]))
        target.decode_greedy(clone(tc0), np.asarray([[first]]), start, n)  # warm: the decode graph
        cache = clone(tc0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cache, plain = target.decode_greedy(cache, np.asarray([[first]]), start, n)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3 / n
        plain = plain[:, 0].tolist()
        dec = make_speculative_decoder(target, draft, k=k, max_new=n)
        dec(clone(tc0), clone(dc0), first, start)  # warm: the round's capture
        tc, dc = clone(tc0), clone(dc0)
        reset_launches()
        replays0 = dec.replays
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ids, rounds, tc, dc = dec(tc, dc, first, start)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {key: v for key, v in launch_counts().items() if v}
        replays = dec.replays - replays0
        per_round = spec_round_launches(target, draft, k, 1)
        want = {key: v * replays for key, v in per_round.items()}
        check(counts == want and replays == rounds and dec.captures == 1,
              f"GPT-J spec ({label}): launches {counts}, want {want}; {replays} replays for {rounds} rounds")
        ids = ids.tolist()
        accepted = dec.accepted.tolist()
        check(len(accepted) == rounds and sum(a + 1 for a in accepted) >= n, f"GPT-J spec: accepted {accepted}")
        eager_ms = None
        if label == "bias":  # the same rounds eagerly on the card, timed beside the graphed ones
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eager, _, _, _ = dec(target.new_cache(), draft.new_cache(), SPEC_FIRST, 0, graph=False)
            torch.cuda.synchronize()
            eager_ms = (time.perf_counter() - t0) * 1e3 / n
            check(eager.tolist() == ids and dec.accepted.tolist() == accepted, "GPT-J spec: eager rounds differ")
            out["sampled"] = spec_sampled_decoder(torch, target, draft, k, n)
        tokens = pre + [first] + ids
        split = next((i for i in range(n) if ids[i] != plain[i]), None)
        rows, row = teacher_forced_verify(torch, target, tokens, accepted, k, keep=split, start=start,
                                          cache=clone(tc0))
        wrong = [i for i in range(n) if rows[i][0] != ids[i]]
        if wrong:
            problems.append(f"GPT-J spec ({label}): tokens {wrong[:8]} are not the argmax of their verify rows")
        partial = sum(1 for a in accepted if 0 < a < k)
        run = dict(rounds=rounds, acceptance=(n / rounds - 1) / k, mean_accepted=float(np.mean(accepted)),
                   partial_rounds=partial, prompt=len(pre), ties_emitted=sum(1 for i in range(n) if rows[i][1] == 0.0),
                   eager_ms_per_token=eager_ms, wall_ms=wall * 1e3, ms_per_round=wall * 1e3 / rounds,
                   ms_per_token=wall * 1e3 / n, plain_ms_per_token=plain_ms, speedup=plain_ms / (wall * 1e3 / n),
                   per_round=per_round, replays=replays, equal_to_plain=split is None, counts=counts)
        if label == "partial" and not (partial and 0 < run["acceptance"] < 1):
            problems.append(f"GPT-J spec (partial): no round accepted part of its drafts: {accepted}")
        if split is not None:
            bias = p["output.bias"].float() if "output.bias" in p else 0.0
            history = pre + [first] + plain
            plain_row = plain_logits_at(torch, target, history, split, start, clone(tc0))
            plain_argmax = int(torch.argmax(plain_row))
            plain_row = plain_row - bias
            b_row = plain_logits_at(torch, target, history, split, start, batch=2) - bias
            row = row - bias
            a, b = plain[split], ids[split]
            nmse, max_abs = errors(plain_row, row)
            run["split"] = dict(step=split, plain_id=a, spec_id=b, plain_row_argmax=plain_argmax,
                                plain_row_margin=float(plain_row[a] - plain_row[b]),
                                verify_row_margin=float(row[b] - row[a]), plain_against_verify_nmse=nmse,
                                max_abs=max_abs, m2_against_verify_nmse=errors(b_row, row)[0],
                                m2_against_plain_nmse=errors(b_row, plain_row)[0])
            if label == "bias" or run["split"]["plain_row_argmax"] != a:
                problems.append(f"GPT-J spec ({label}): the ids part from plain greedy at step {split}: {run['split']}")
        for key, v in counts.items():
            out["counts"][key] = out["counts"].get(key, 0) + v
        out[label] = run
        print(f"  GPT-J-6B Q4_K spec, {label} ({card}): {n} tokens after {len(pre) or 'no'} prompt tokens in {rounds} "
              f"rounds (acceptance {run['acceptance']:.3f}, {partial} rounds accepting part of their drafts), "
              f"{run['ms_per_round']:.3f} ms a round, {run['ms_per_token']:.3f} ms/token against plain {plain_ms:.3f} "
              f"({run['speedup']:.2f}x)" + (f", eager {eager_ms:.3f}" if eager_ms else "")
              + f"; launches a round {per_round}; {n - len(wrong)} of {n} tokens the argmax of their verify row "
              f"({run['ties_emitted']} at exact ties); " + ("ids equal plain greedy" if split is None
                                                              else f"split {run['split']}"))
        del target, draft, dec, tc, dc, cache, tc0, dc0
    check(not problems, "; ".join(problems))
    return out


def spec_sampled_decoder(torch, target, draft, k: int, n: int) -> dict:
    """The sampled speculative decoder (rejection sampling, its round a CUDA
    graph with the draws from a generator registered with it) at bench_spec's
    shape: the same ids twice from one seed, graphed and eager, tokens in the
    vocabulary, the acceptance rate."""
    from ggml_tpu_torch.speculative import make_speculative_decoder_sampled

    dec = make_speculative_decoder_sampled(target, draft, k=k, max_new=n, sampler=SPEC_SAMPLER)
    runs = []
    for graph in (True, True, False):
        gen = torch.Generator(device="cuda").manual_seed(3)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ids, rounds, _, _, _ = dec(target.new_cache(), draft.new_cache(), SPEC_FIRST, 0, gen, graph=graph)
        torch.cuda.synchronize()
        runs.append((ids.tolist(), rounds, (time.perf_counter() - t0) * 1e3 / n))
    (ids, rounds, _), again, eager = runs
    check(again[:2] == (ids, rounds) and eager[:2] == (ids, rounds) and all(0 <= t < target.cfg.n_vocab for t in ids),
          f"GPT-J sampled spec: runs from one seed differ: {runs}")
    out = dict(rounds=rounds, acceptance=(n / rounds - 1) / k, ms_per_token=again[2], eager_ms_per_token=eager[2],
               captures=dec.captures)
    print(f"  sampled decoder ({SPEC_SAMPLER}): the same ids twice and eagerly from one seed, {rounds} rounds "
          f"(acceptance {out['acceptance']:.3f}), {again[2]:.3f} ms/token graphed, {eager[2]:.3f} eager")
    return out


def spec_timed_mix(torch, eng, prompts, n_new: int, bucket: int = SERVE_BUCKET) -> dict:
    """timed_mix for a speculative engine: the exact launches are those of
    its rounds (spec_round_launches, max_batch rows) plus every prefill of
    the target and the draft outside the graphs."""
    reset_launches()
    marks = _engine_marks(eng)
    rounds0, drafted0, accepted0 = eng.spec_rounds, eng.spec_drafted, eng.spec_accepted
    rec, drec = _Forwards(eng), _Forwards(eng, "_draft_fwd", only_prefill=True)
    rids = [eng.submit(p, n_new) for p in prompts]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        res = eng.run(bucket=bucket)
        torch.cuda.synchronize()
    finally:
        rec.close()
        drec.close()
    wall = time.perf_counter() - t0
    counts = {k: v for k, v in launch_counts().items() if v}
    delta = _engine_delta(eng, marks)
    rounds = eng.spec_rounds - rounds0
    want = {key: v * rounds for key, v in spec_round_launches(eng.model, eng.draft, eng.draft_k, eng.max_batch).items()}
    for m, head in rec.calls:
        planar_launches(eng.model.params, m, head, into=want)
    for m, head in drec.calls:
        layer_launches(eng.draft.params, eng.draft.cfg.n_layer, m, head, into=want)
    ids = [res[r] for r in rids]
    ev = eng.event_ms()
    busy = sum(ev.values())
    check(counts == {k: v for k, v in want.items() if v} and delta["captures"] == 0,
          f"spec launches {counts}, want {want}; {delta}")
    check(all(len(x) == n_new for x in ids), f"lengths {[len(x) for x in ids]}")
    tokens = sum(len(x) for x in ids)
    drafted = eng.spec_drafted - drafted0
    return dict(ids=ids, wall_s=wall, tokens=tokens, tok_per_s=tokens / wall, counts=counts, engine=delta,
                rounds=rounds, replays=delta["replays"], acceptance=(eng.spec_accepted - accepted0) / max(1, drafted),
                event_ms=ev, idle_share=1 - busy / (wall * 1e3), forwards=len(rec.calls) + len(drec.calls))


def phase_spec_serve(torch, np, params: dict, card: str) -> dict:
    """4r (b): bench_spec_serve's mix on 4a's planes with the pinned-argmax
    bias: the plain engine, the greedy speculative engine (its stretches of
    4 rounds one CUDA graph replay each) and the sampled one, two warm passes
    each, then a timed pass with exact launches (a round: B on 7 draft
    linears x 4 steps and 6 for the last, C on 85 for the verify at M = 40)
    and the acceptance rate; greedy ids equal the plain engine's."""
    import gc

    from ggml_tpu_torch.models import gptj
    from ggml_tpu_torch.serve import Engine

    cfg = gptj_config_of(params)
    biased = spec_bias_params(torch, params, cfg.n_vocab)
    model = gptj.GPTJ(biased, cfg, max_seq=256, device="cuda")
    draft = gptj.GPTJ(biased, dataclasses.replace(cfg, n_layer=SPEC_DRAFT_LAYERS), max_seq=256, device="cuda")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.n_vocab, int(rng.integers(4, 30))).tolist() for _ in range(SERVE_REQUESTS)]
    out = dict(counts={})
    spec = dict(draft=draft, draft_k=SPEC_SERVE_K)
    for label, kw in (("plain", {}), ("greedy", spec), ("sampled", dict(spec, sampler=SPEC_SAMPLER))):
        eng = Engine(model, max_batch=SERVE_SLOTS, max_seq=256, cache_dtype=torch.bfloat16, record_events=True, **kw)
        t0 = time.perf_counter()
        for _ in range(2):  # warm passes: the graphs' captures
            _run_ids(eng, prompts, SERVE_NEW)
        torch.cuda.synchronize()
        eng.event_ms()
        warm = time.perf_counter() - t0
        run = (timed_mix if label == "plain" else spec_timed_mix)(torch, eng, prompts, SERVE_NEW)
        run["warm_s"] = warm
        if label != "plain":
            ev = run["event_ms"]
            run["ms_per_round"] = ev.get("spec", 0.0) / max(1, run["rounds"])
        for key, v in run["counts"].items():
            out["counts"][key] = out["counts"].get(key, 0) + v
        out[label] = run
        print(f"  GPT-J-6B Q4_K {label} engine, {SERVE_SLOTS} slots, k = {SPEC_SERVE_K} ({card}): {run['tokens']} tokens "
              f"in {run['wall_s'] * 1e3:.1f} ms, {run['tok_per_s']:.1f} tok/s, idle {run['idle_share'] * 100:.1f} %"
              + ("" if label == "plain" else f"; {run['rounds']} rounds in {run['replays']} replays, "
                 f"{run['ms_per_round']:.3f} ms a round, acceptance {run['acceptance']:.3f}")
              + f"; launches {run['counts']}; warm passes {warm:.1f}s")
        del eng
        gc.collect()
    check(out["greedy"]["ids"] == out["plain"]["ids"], "GPT-J spec serving: greedy ids differ from the plain engine's")
    for label in ("plain", "greedy", "sampled"):
        out[label].pop("ids")
    del model, draft
    out.update(spec_serve_partial(torch, np, params, prompts, card))
    torch.cuda.empty_cache()
    return out


def spec_serve_partial(torch, np, params: dict, prompts, card: str) -> dict:
    """bench_spec_serve's mix with spec_partial_params' two-token bias, so
    that rounds accept some of their drafts, through a dense engine (4
    rounds a graph replay) and a paged one (pages of 64, one round a graph
    replay, its verify the generic adapter over gptj.forward), each under a
    SpecTap, one pass: every round's position and fed tokens those of the
    emitted history and every emitted token the argmax of the verify row
    it came from (exact); rounds that accept part of their drafts, and an
    acceptance strictly between 0 and 1; the paged verify's rows against
    gptj.forward over the gathered windows, NMSE <= 1e-5 (the gate of 4n's
    paged step against the dense forward)."""
    import gc

    from ggml_tpu_torch.models import gptj
    from ggml_tpu_torch.paged_kv import PagedConfig
    from ggml_tpu_torch.serve import Engine

    cfg = gptj_config_of(params)
    biased = spec_partial_params(torch, params, cfg.n_vocab)
    model = gptj.GPTJ(biased, cfg, max_seq=256, device="cuda")
    draft = gptj.GPTJ(biased, dataclasses.replace(cfg, n_layer=SPEC_DRAFT_LAYERS), max_seq=256, device="cuda")
    per_seq = 256 // PAGE
    out, problems = {}, []
    kinds = (("partial", {}, None),
             ("partial_paged", dict(paged=PagedConfig(SERVE_SLOTS * per_seq + per_seq, PAGE, per_seq)),
              gathered_reference(gptj.forward)))
    for label, kw, reference in kinds:
        eng = Engine(model, max_batch=SERVE_SLOTS, max_seq=256, cache_dtype=torch.bfloat16, draft=draft,
                     draft_k=SPEC_SERVE_K, **kw)
        t0 = time.perf_counter()
        ids, _, run, tap = tapped_run(torch, eng, prompts, SERVE_NEW, reference)
        run["wall_s"] = time.perf_counter() - t0
        run["bad"] = run["bad"][:8]
        run["ids"] = ids
        if run["bad"] or not (run["partial_rounds"] and 0 < run["acceptance"] < 1):
            problems.append(f"GPT-J spec serving ({label}): {run}")
        if reference is not None and not run["reference_nmse"] <= 1e-5:
            problems.append(f"GPT-J spec serving ({label}): the paged verify against gptj.forward over the gathered "
                            f"windows, NMSE {run['reference_nmse']}")
        out[label] = run
        print(f"  GPT-J-6B Q4_K {label} engine ({card}): {run['rounds']} rounds of live slots, "
              f"{run['partial_rounds']} accepting part of their drafts, acceptance {run['acceptance']:.3f}; every "
              f"round's position and fed tokens those of the history, every token the argmax of its verify row: "
              f"{not run['bad']}" + ("" if reference is None else f"; the verify against the dense forward over the "
                                     f"gathered windows NMSE {run['reference_nmse']:.2e}")
              + f" ({run['wall_s']:.1f}s, with the capture and the checks)")
        del eng, tap  # the tap's buffers live as long as the graphs that write them
        gc.collect()
    out["partial_equal_paged"] = sum(a == b for a, b in zip(out["partial"].pop("ids"), out["partial_paged"].pop("ids")))
    print(f"  {out['partial_equal_paged']} of {len(prompts)} requests give the same ids through both partial engines "
          "(not gated: prefills and verifies at other M)")
    del model, draft
    check(not problems, "; ".join(problems))
    return out


def phase_spec(torch, np, params: dict, card: str) -> dict:
    stage("4r. speculative serving: bench_spec_serve's mix, GPT-J-6B Q4_K, 8 slots, k = 4, greedy and sampled")
    out = dict(spec_serve=phase_spec_serve(torch, np, params, card))
    stage("4r. speculative decoding: bench_spec's shape, GPT-J-6B Q4_K, 2-layer self-draft, k = 7, 192 tokens")
    out["spec"] = phase_spec_gptj(torch, np, params, card)
    return out


def phase_spec_llama(torch, np, model, card: str) -> dict:
    """4r (c): Llama-3-8B (4l's model) at 4 slots through a paged engine
    with the prefix cache (4n (c)'s prompts: four sharing a 256-token prefix
    and one of 100, x 16 new) without and with a 2-layer self-draft (k = 4:
    the verify's 20 rows take B, H and F as a step's 4 do), each a checked
    pass (the speculative one under a SpecTap) and a timed one, exact
    launches, tok/s and the acceptance rate.  The speculative engine's
    rounds, exactly: every round's position and fed tokens those of the
    emitted history, every emitted token the argmax of its own paged verify
    row; its paged verify's rows against llama.forward over the windows
    gathered from the pools at the same shape (B = 4, T = 5), NMSE <= 1e-5 a
    round (the gate of 4n's paged step against the dense forward).  Pinned:
    the final norm's weight zeroed (the Llama head has no bias to pin with,
    as bench's _spec_bias_params pins GPT-J's), every logit 0 and the argmax
    token 0 on both paths: the ids equal the plain engine's and every draft
    is accepted (the bookkeeping of full rounds; the rows' values are not
    tested there).  Random weights: no draft accepted; a plain step and a
    verify attend and multiply at other shapes over histories written by
    other shapes, so the ids part from the plain engine's at near-ties;
    where the checked passes part, the candidates' margin on the verify row
    that emitted the speculative id is reported (the plain engine's row is
    not read).  A first pass and a later one take other prefix hits, so
    their ids may part too."""
    import gc

    from ggml_tpu_torch.models import llama
    from ggml_tpu_torch.paged_kv import PagedConfig
    from ggml_tpu_torch.serve import Engine

    cfg = model.cfg
    rng = np.random.default_rng(2)
    shared = rng.integers(0, cfg.n_vocab, PAGED_SHARED).tolist()
    prompts = [shared + rng.integers(0, cfg.n_vocab, n).tolist() for n in LLAMA_TAILS]
    prompts.append(rng.integers(0, cfg.n_vocab, LLAMA_OTHER).tolist())
    per_seq = PAGED_SEQ // PAGE
    out, problems = dict(counts={}), []
    pinned = dict(model.params) | {"output_norm.weight": torch.zeros_like(model.params["output_norm.weight"])}
    for variant, params in (("pinned", pinned), ("random", model.params)):
        target = llama.Llama(params, cfg, max_seq=model.max_seq, device="cuda")
        mem = torch.cuda.memory_allocated()
        draft = llama.Llama(params, dataclasses.replace(cfg, n_layer=SPEC_DRAFT_LAYERS), max_seq=PAGED_SEQ,
                            device="cuda")
        check(torch.cuda.memory_allocated() == mem, "Llama spec: building the self-draft allocated memory")
        runs = {}
        for label, kw in (("paged", {}), ("paged_spec", dict(draft=draft, draft_k=SPEC_SERVE_K))):
            eng = Engine(target, max_batch=4, max_seq=PAGED_SEQ, cache_dtype=torch.bfloat16, record_events=True,
                         paged=PagedConfig(4 * per_seq + per_seq, PAGE, per_seq, prefix_cache=True), **kw)
            if label == "paged":
                first_pass = _run_ids(eng, prompts, 16)
            else:
                tapped = tapped_run(torch, eng, prompts, 16, gathered_reference(llama.forward),
                                    keep_rows=variant == "random")
            torch.cuda.synchronize()
            eng.event_ms()
            eng.cached_prefix_tokens = 0
            run = (timed_mix if label == "paged" else spec_timed_mix)(torch, eng, prompts, 16)
            check(run["engine"]["cached_prefix_tokens"] >= PAGED_SHARED * 4, f"Llama spec: hits {run['engine']}")
            if label == "paged_spec":
                run["ms_per_round"] = run["event_ms"].get("spec", 0.0) / max(1, run["rounds"])
                ids, rids, taken, tap = tapped
                run["checked"] = dict(taken, bad=taken["bad"][:8])
                if taken["bad"] or not taken["reference_nmse"] <= 1e-5:
                    problems.append(f"Llama spec ({variant}): {run['checked']}")
            for key, v in run["counts"].items():
                out["counts"][key] = out["counts"].get(key, 0) + v
            runs[label] = run
            print(f"  Llama-3-8B {variant} {label}, 4 slots ({card}): {run['tokens']} tokens in "
                  f"{run['wall_s'] * 1e3:.1f} ms, {run['tok_per_s']:.1f} tok/s, prefix hits "
                  f"{run['engine']['cached_prefix_tokens']}"
                  + ("" if label == "paged" else f", {run['rounds']} rounds ({run['ms_per_round']:.3f} ms a round on "
                     f"the card), acceptance {run['acceptance']:.3f}; checked pass: every round's position and fed "
                     f"tokens those of the history and every token the argmax of its verify row: "
                     f"{not run['checked']['bad']}, the paged verify against llama.forward over the gathered windows "
                     f"NMSE {run['checked']['reference_nmse']:.2e} at most") + f"; launches {run['counts']}")
            del eng  # before the tap, whose buffers its graphs write
            gc.collect()
        plain, spec = runs["paged"].pop("ids"), runs["paged_spec"].pop("ids")
        runs["equal_requests"] = sum(a == b for a, b in zip(plain, spec))
        if variant == "pinned":
            if plain != spec or runs["paged_spec"]["acceptance"] != 1.0:
                problems.append(f"Llama spec (pinned): ids equal {runs['equal_requests']} of {len(prompts)}, "
                                f"acceptance {runs['paged_spec']['acceptance']}")
        else:  # the checked passes (the first of each engine: the same prefix hits) where they part
            runs["splits"] = []
            runs["first_pass_equal_requests"] = sum(a == b for a, b in zip(first_pass, ids))
            runs["passes_equal"] = dict(plain=sum(a == b for a, b in zip(first_pass, plain)),
                                        spec=sum(a == b for a, b in zip(ids, spec)))
            for rid, a, b in zip(rids, first_pass, ids):
                q = next((i for i in range(len(a)) if a[i] != b[i]), None)
                row = None if q is None else tap.row(rid, q)
                if row is not None:
                    top = torch.topk(row, 2).values
                    runs["splits"].append(dict(step=q, plain_id=a[q], spec_id=b[q],
                                               verify_row_margin=float(row[b[q]] - row[a[q]]),
                                               verify_row_top2_gap=float(top[0] - top[1])))
                elif q is not None:
                    runs["splits"].append(dict(step=q, plain_id=a[q], spec_id=b[q]))
        del tapped, tap
        print(f"  {variant}: {runs['equal_requests']} of {len(prompts)} requests give the same ids with and without "
              f"the draft" + ("" if variant == "pinned" else f" ({runs['first_pass_equal_requests']} in the checked "
                              f"passes; where those part, the candidates on the verify row: {runs['splits']}; "
                              f"first and timed passes equal in {runs['passes_equal']} requests)"))
        if variant == "random":  # rejection-sampling rounds over the pages, graphed
            sampled = []
            for _ in range(2):
                eng = Engine(target, max_batch=4, max_seq=PAGED_SEQ, cache_dtype=torch.bfloat16, seed=5,
                             paged=PagedConfig(4 * per_seq + per_seq, PAGE, per_seq, prefix_cache=True), draft=draft,
                             draft_k=SPEC_SERVE_K, sampler=SPEC_SAMPLER)
                sampled.append((_run_ids(eng, prompts, 16), eng.spec_accepted / max(1, eng.spec_drafted),
                                eng.captures))
                del eng
                gc.collect()
            check(sampled[0] == sampled[1] and all(len(x) == 16 for x in sampled[0][0]),
                  "Llama sampled paged spec: two runs from one seed differ")
            runs["sampled_acceptance"] = sampled[0][1]
            print(f"  sampled paged engine ({SPEC_SAMPLER}): the same ids twice from one seed, acceptance "
                  f"{sampled[0][1]:.3f}, {sampled[0][2]} capture")
        out[variant] = runs
        del target, draft
    torch.cuda.empty_cache()
    check(not problems, "; ".join(problems))
    return out


# 4s: the llama family's mixture-of-experts block.  (a) bench_moe_decode
# (bench.py:502-531): _synth_moe_llama("8x7g") (bench.py:445-479), random
# bf16 weights (their values do not matter, only the bytes), batch 1,
# max_seq 128, 32 greedy tokens from token 11 at n_past 0 to warm up, then
# 32 timed from n_past 32; (b) Qwen3-30B-A3B (Qwen/Qwen3-30B-A3B
# config.json) from a qwen3moe Q4_K GGUF file with a Q6_K head and Q6_K
# ffn_down experts, its depth cut (MOE_QWEN_LAYERS; all 48 under --moe where
# the card and the time allow); (c) the engine on (b) at bench_serve's mix
# (4 slots, 24 requests of 4-30-token prompts from default_rng(0) x 32 new,
# bucket 32), dense and paged with the prefix cache, and at 16 slots; (d)
# finetune_lora(keep_quantized=True) on (b)'s file (rank 8 on the default
# targets, batch 1 x 512, lr 1e-3) and finetune of the model cut to one
# layer, as a user calls them; (e) tiny Mixtral, qwen2moe, qwen3moe and granitemoe files on the card against
# the CPU
MOE_BENCH = dict(n_vocab=32000, n_ctx=4096, n_embd=4096, n_head=32, n_head_kv=8, n_layer=8, n_ff=7168, n_expert=8,
                 n_expert_used=2)
MOE_TOKENS, MOE_FIRST, MOE_MAX_SEQ = 32, 11, 128
MOE_QWEN_LAYERS = 2  # the whole run's depth of Qwen3-30B-A3B (--moe: MOE_QWEN_LAYERS_ALONE)
MOE_QWEN_LAYERS_ALONE = 48
MOE_QWEN_FF_EXP = 768  # moe_intermediate_size
MOE_SLOTS_GROUPED = 16  # an engine tick of 16 rows takes the grouped experts (JAX's rule: >= 16 tokens)
MOE_LORA = dict(rank=8, batch=1, seq=512, steps=3, lr=1e-3)
# bf16 grouped against dense experts, one step's logits: the two paths round
# other bf16 products in another order, and random layers spread it (on an
# H100: 4.9e-4 over 8 layers of bench_moe's shape, 9.8e-5 to 7.9e-4 over 2
# to 48 layers of Qwen3-30B-A3B's); the f32 paths agree to 1e-12 on the CPU
# (tests/test_torch_moe.py)
MOE_GROUPED_GATE = 1e-2


def synth_moe_params(torch, cfg, seed: int = 0) -> dict:
    """bench.py's _synth_moe_llama on the card: normal(0, 0.02) bf16 weights
    from a seeded generator, its names and shapes (the router ffn_gate_inp
    (E, D), the stacked experts), norms of ones."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    d, f, e, hd = cfg.n_embd, cfg.n_ff, cfg.n_expert, cfg.head_dim
    shapes = {"token_embd.weight": (cfg.n_vocab, d), "output.weight": (cfg.n_vocab, d)}
    ones = {"output_norm.weight": (d,)}
    for i in range(cfg.n_layer):
        pre = f"blk.{i}."
        ones[pre + "attn_norm.weight"] = ones[pre + "ffn_norm.weight"] = (d,)
        shapes.update({pre + "attn_q.weight": (cfg.n_head * hd, d), pre + "attn_k.weight": (cfg.n_head_kv * hd, d),
                       pre + "attn_v.weight": (cfg.n_head_kv * hd, d), pre + "attn_output.weight": (d, cfg.n_head * hd),
                       pre + "ffn_gate_inp.weight": (e, d), pre + "ffn_gate_exps.weight": (e, f, d),
                       pre + "ffn_up_exps.weight": (e, f, d), pre + "ffn_down_exps.weight": (e, d, f)})
    out = {}
    for name, shape in sorted(shapes.items()):
        out[name] = torch.randn(shape, generator=gen, device="cuda", dtype=torch.bfloat16).mul_(0.02)
    for name, shape in ones.items():
        out[name] = torch.ones(shape, dtype=torch.bfloat16, device="cuda")
    return out


def moe_stream_bytes(torch, params: dict, cfg, cache) -> dict:
    """Bytes a decode token reads at least: every tensor but the embedding
    (one row of it), the KV cache window the attention reads whole (a
    Deepseek's latent pair), and every expert (JAX's dense path) or only the
    top-k (a path that reads the chosen experts alone); a model without
    experts reads the same either way.  Planes count their plane bytes."""
    from ggml_tpu_torch.quant.planar import PlanarWeight

    size = lambda t: t.plane_bytes() if isinstance(t, PlanarWeight) else t.numel() * t.element_size()
    experts = sum(size(v) for k, v in params.items() if "_exps." in k)
    rest = sum(size(v) for k, v in params.items() if "_exps." not in k and not k.startswith("token_embd"))
    rest += cfg.n_embd * 2 + sum(size(k) + size(v) for k, v in cache)
    every = experts + rest
    topk = (experts * cfg.n_expert_used / cfg.n_expert if cfg.n_expert else 0) + rest
    return dict(every_bytes=every, topk_bytes=topk, every_floor_ms=every / HBM_BYTES_PER_S * 1e3,
                topk_floor_ms=topk / HBM_BYTES_PER_S * 1e3)


def _with_env(key: str, value: str, fn):
    old = os.environ.get(key)
    os.environ[key] = value
    try:
        return fn()
    finally:
        if old is None:
            del os.environ[key]
        else:
            os.environ[key] = old


def grouped_against_dense(torch, model, cache, token: int, pos: int) -> dict:
    """One decode step's logits with the experts forced through the grouped
    path (GGML_TPU_MOE_GROUPED=1) and through the dense path (0), each over
    its own copy of the cache: NMSE, gated at MOE_GROUPED_GATE (bf16: the
    two paths round other products in another order)."""
    tok = torch.tensor([[token]], device=model.device)
    p = torch.tensor(pos, dtype=torch.int32, device=model.device)
    copy = lambda: [(k.clone(), v.clone()) for k, v in cache]
    with torch.no_grad():
        grouped = _with_env("GGML_TPU_MOE_GROUPED", "1", lambda: model.decode_logits(copy(), tok, p)).float()
        dense = _with_env("GGML_TPU_MOE_GROUPED", "0", lambda: model.decode_logits(copy(), tok, p)).float()
    nm, mae = errors(dense, grouped)
    check(bool(torch.isfinite(grouped).all()) and nm <= MOE_GROUPED_GATE,
          f"grouped against dense experts: NMSE {nm:.2e} > {MOE_GROUPED_GATE:g}")
    return dict(nmse=nm, max_abs_err=mae, same_argmax=int(grouped.argmax()) == int(dense.argmax()))


def moe_decode_run(torch, np, model, prompt, n: int) -> dict:
    """A greedy request: prefill `prompt`, one graphed warm-up request (the
    capture), then n graphed tokens timed, the launches of those tokens
    counted (reset just before, read just after), then the same n eagerly
    from the same position over the same cache: equal ids, ms/token each."""
    cache = model.new_cache(torch.bfloat16)
    logits, cache, n_past = model.prefill(cache, prompt)
    first = torch.argmax(logits, dim=-1, keepdim=True)
    model.decode_greedy(cache, first, n_past, n)  # the capture and first uses
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    cache, ids = model.decode_greedy(cache, first, n_past, n)
    graphed_ms = (time.perf_counter() - t0) * 1e3 / n
    counts = {k: v for k, v in launch_counts().items() if v}
    t0 = time.perf_counter()
    cache, eager = model.decode_greedy(cache, first, n_past, n, graph=False)
    eager_ms = (time.perf_counter() - t0) * 1e3 / n
    ids, eager = ids[:, 0].tolist(), eager[:, 0].tolist()
    check(ids == eager, f"graphed ids {ids[:8]}... against eager {eager[:8]}...")
    check(all(0 <= t < model.cfg.n_vocab for t in ids), f"ids {ids[:8]}")
    return dict(first=int(first[0, 0]), ids=ids, n_past=n_past, cache=cache, graphed_ms_per_token=graphed_ms,
                eager_ms_per_token=eager_ms, counts=counts, launches_per_token={k: v / n for k, v in counts.items()})


def phase_moe_bench(torch, np, card: str) -> dict:
    """4s (a): bench_moe_decode's shape (MOE_BENCH): the weights synthesized
    on the card, 32 greedy tokens from token 11 at n_past 0 (the capture and
    warm-up), then 32 from n_past 32 graphed and timed, then again eagerly
    (the same ids); ms/token and tokens/s beside the two floors (every
    expert streamed, as the dense path does; the top-2 alone); one step's
    logits through the grouped and the dense experts; graphed and eager
    decode profiled by class (profile_llama_decode).  No kernel of the port is on this path
    (dense bf16 weights, the plain attention): its counts stay 0."""
    import gc

    from ggml_tpu_torch.models import llama

    gc.collect()
    torch.cuda.empty_cache()
    cfg = llama.LlamaConfig(**MOE_BENCH)
    t0 = time.perf_counter()
    params = synth_moe_params(torch, cfg)
    torch.cuda.synchronize()
    out = dict(config=MOE_BENCH, card=card, synth_s=time.perf_counter() - t0)
    model = llama.Llama(params, cfg, max_seq=MOE_MAX_SEQ, batch=1, device="cuda")
    first = torch.tensor([[MOE_FIRST]], device="cuda")
    cache = model.new_cache(torch.bfloat16)
    t0 = time.perf_counter()
    cache, warm = model.decode_greedy(cache, first, 0, MOE_TOKENS)
    torch.cuda.synchronize()
    out["warm_s"] = time.perf_counter() - t0
    reset_launches()
    t0 = time.perf_counter()
    cache, ids = model.decode_greedy(cache, first, MOE_TOKENS, MOE_TOKENS)
    dt = time.perf_counter() - t0
    out["counts"] = {k: v for k, v in launch_counts().items() if v}
    t0 = time.perf_counter()
    cache, eager = model.decode_greedy(cache, first, MOE_TOKENS, MOE_TOKENS, graph=False)
    eager_dt = time.perf_counter() - t0
    ids, eager = ids[:, 0].tolist(), eager[:, 0].tolist()
    check(ids == eager and all(0 <= t < cfg.n_vocab for t in ids), f"bench_moe: graphed {ids[:8]}, eager {eager[:8]}")
    floors = moe_stream_bytes(torch, params, cfg, cache)
    out.update(floors, ms_per_token=dt * 1e3 / MOE_TOKENS, tokens_per_s=MOE_TOKENS / dt,
               eager_ms_per_token=eager_dt * 1e3 / MOE_TOKENS, ids=ids, port_launches=out["counts"])
    out["every_floor_share"] = out["every_floor_ms"] / out["ms_per_token"]
    print(f"  bench_moe_decode's shape (8 layers, 8 experts of 7168, 2 a token, bf16) on {card}: "
          f"{out['ms_per_token']:.3f} ms/token graphed ({out['tokens_per_s']:.1f} tok/s), eager "
          f"{out['eager_ms_per_token']:.3f}; floors: every expert streamed {out['every_bytes'] / 1e9:.2f} GB = "
          f"{out['every_floor_ms']:.3f} ms, the top-2 alone {out['topk_bytes'] / 1e9:.2f} GB = "
          f"{out['topk_floor_ms']:.3f} ms; graphed ids equal eager; port launches {out['counts']}")
    out["grouped_vs_dense"] = grouped_against_dense(torch, model, cache, ids[-1], 2 * MOE_TOKENS)
    print(f"  one step's logits, grouped against dense experts: NMSE {out['grouped_vs_dense']['nmse']:.2e} "
          f"(gate {MOE_GROUPED_GATE:g}), same argmax {out['grouped_vs_dense']['same_argmax']}")
    out["decode_trace"] = profile_llama_decode(torch, np, model, ranges=_MOE_RANGES, n_vocab=cfg.n_vocab)
    del model, params, cache
    gc.collect()
    torch.cuda.empty_cache()
    return out


def write_qwen3_moe_gguf(np, tmp: str, n_layer: int) -> tuple:
    """Qwen3-30B-A3B's GGUF file at its published widths cut to n_layer
    layers (models/llama.write_random_gguf, arch qwen3moe): Q4_K weights, a
    Q6_K head and Q6_K ffn_down experts (as llama.cpp's Q4_K_M keeps them),
    an F32 router, ones for the norms (q/k norms too).  Returns (path,
    config, dict(gguf_write_s, gguf_bytes))."""
    from ggml_tpu_torch.dtypes import GGMLType
    from ggml_tpu_torch.models import llama

    cfg = dataclasses.replace(llama.qwen3_30b_a3b_config(), n_layer=n_layer)
    types = {"output.weight": GGMLType.Q6_K} | {f"blk.{i}.ffn_down_exps.weight": GGMLType.Q6_K
                                                 for i in range(n_layer)}
    path = os.path.join(tmp, f"qwen3-30b-a3b-{n_layer}-layers-q4_k.gguf")
    t0 = time.perf_counter()
    llama.write_random_gguf(path, cfg, seed=0, types=types, arch="qwen3moe", n_ff_exp=MOE_QWEN_FF_EXP)
    info = dict(gguf_write_s=time.perf_counter() - t0, gguf_bytes=os.path.getsize(path))
    print(f"  wrote {info['gguf_bytes'] / 1e9:.3f} GB of qwen3moe GGUF ({n_layer} of 48 layers) in "
          f"{info['gguf_write_s']:.1f}s")
    return path, cfg, info


def phase_moe_qwen(torch, np, path: str, want_cfg, card: str) -> tuple:
    """4s (b): Qwen3-30B-A3B from write_qwen3_moe_gguf's file, loaded as
    Llama.from_gguf loads it (the attention and head as planes, the experts
    dequantized to bf16): the load, a 1024-token prefill (J at GQA 32/4, C
    on every attention linear, G on the head, the grouped experts) with its
    exact launches and busy time by class, graphed decode of 32 tokens
    after an 8-token prompt (A on the 4 attention linears of every layer, F
    on the head) with exact launches a token, ms/token beside its floor,
    and eagerly, the same ids; grouped against dense experts at one step.
    Returns (model, record)."""
    from ggml_tpu_torch.models import llama
    from ggml_tpu_torch.quant.planar import PlanarWeight

    t0 = time.perf_counter()
    model = llama.Llama.from_gguf(path, max_seq=2048, device="cuda")
    torch.cuda.synchronize()
    cfg = model.cfg
    out = dict(load_s=time.perf_counter() - t0, card=card, n_layer=cfg.n_layer,
               card_gb=torch.cuda.memory_allocated() / 1e9)
    check(dataclasses.replace(cfg, rms_eps=want_cfg.rms_eps) == want_cfg, f"config {cfg}")  # eps read as f32
    planar = [k for k, v in model.params.items() if isinstance(v, PlanarWeight) and k != "token_embd.weight"]
    check(len(planar) == 4 * cfg.n_layer + 1, f"{len(planar)} planar linears")
    exps = model.params["blk.0.ffn_gate_exps.weight"]
    check(exps.shape == (128, MOE_QWEN_FF_EXP, 2048) and exps.dtype == torch.bfloat16, f"experts {exps.shape}")
    print(f"  loaded in {out['load_s']:.1f}s ({out['card_gb']:.2f} GB on the card): {len(planar)} planar linears, "
          f"the experts bf16")
    rng = np.random.default_rng(0)
    long = rng.integers(0, cfg.n_vocab, (1, 1024))
    model.prefill(model.new_cache(torch.bfloat16), long)  # first uses
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    logits, _, _ = model.prefill(model.new_cache(torch.bfloat16), long)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    counts = {k: v for k, v in launch_counts().items() if v}
    want = planar_launches(model.params, 1024, head=True)
    want.update(flash_attn=cfg.n_layer, flash_split=cfg.n_layer, flash_mask_ranges=1)
    check(counts == want and bool(torch.isfinite(logits).all()), f"1024-token prefill: launches {counts}, want {want}")
    prof = profile_classes(torch, lambda: model.prefill(model.new_cache(torch.bfloat16), long), 1, _MOE_RANGES,
                           cfg.n_vocab)
    out["prefill"] = dict(ms=prefill_ms, counts=counts, profile=prof)
    print(f"  1024-token prefill: {prefill_ms:.1f} ms, launches {counts}; device busy {prof['busy_ms']:.1f} ms by "
          f"class: {_fmt_classes(prof['by_class_ms'])}")
    run = moe_decode_run(torch, np, model, rng.integers(0, cfg.n_vocab, (1, 8)), MOE_TOKENS)
    want = {k: v * MOE_TOKENS for k, v in planar_launches(model.params, 1, head=True).items()}
    check(run["counts"] == want, f"decode launches {run['counts']}, want {want}")
    floors = moe_stream_bytes(torch, model.params, cfg, run.pop("cache"))
    run.update(floors, counts_prefill=out["prefill"]["counts"])
    run["every_floor_share"] = run["every_floor_ms"] / run["graphed_ms_per_token"]
    out["decode"] = run
    print(f"  decode after 8 tokens: {run['graphed_ms_per_token']:.3f} ms/token graphed, "
          f"{run['eager_ms_per_token']:.3f} eager (the same {MOE_TOKENS} ids); floors: every expert "
          f"{run['every_bytes'] / 1e9:.2f} GB = {run['every_floor_ms']:.3f} ms, the top-8 alone "
          f"{run['topk_bytes'] / 1e9:.2f} GB = {run['topk_floor_ms']:.3f} ms; launches a token "
          f"{run['launches_per_token']}")
    cache = model.new_cache(torch.bfloat16)
    model.prefill(cache, np.asarray([[run["first"]]]))
    out["grouped_vs_dense"] = grouped_against_dense(torch, model, cache, run["ids"][0], 1)
    print(f"  one step's logits, grouped against dense experts: NMSE {out['grouped_vs_dense']['nmse']:.2e}")
    out["decode"]["trace"] = profile_llama_decode(torch, np, model, ranges=_MOE_RANGES, n_vocab=cfg.n_vocab)
    return model, out


def paged_against_dense(torch, np, model) -> dict:
    """The model's paged decode step over 4 slots (random bf16 pools, pages
    of 16; positions 5, 40, 77 and an inactive slot) against its dense
    forward (its family's, speculative._forward_for: the llama family's
    paged step is its own, every other family's the generic adapter over
    that forward) over the windows gathered from the pools after the step
    (the step's rows written into them): NMSE over the active slots."""
    from ggml_tpu_torch.models import llama
    from ggml_tpu_torch.paged_kv import PagedConfig, make_paged_decode_step, paged_gather
    from ggml_tpu_torch.speculative import _forward_for

    cfg, dev = model.cfg, model.device
    forward = _forward_for(model)
    pcfg = PagedConfig(n_pages=40, page_size=16, max_pages_per_seq=8)
    gen = torch.Generator(device=dev).manual_seed(5)
    n_kv = getattr(cfg, "n_head_kv", cfg.n_head)
    pools = [tuple(torch.randn((pcfg.n_pages + 1, n_kv, 16, cfg.head_dim), generator=gen,
                               device=dev).to(torch.bfloat16) for _ in range(2)) for _ in range(cfg.n_layer)]
    tables = torch.tensor([[1, 2, 3, 4, 0, 0, 0, 0], [5, 6, 7, 8, 9, 10, 11, 12], [13, 14, 15, 16, 17, 18, 19, 20],
                           [0] * 8], device=dev)
    lengths = torch.tensor([5, 40, 77, 0], device=dev)
    wpage = torch.stack([tables[i, lengths[i] // 16] for i in range(3)] + [torch.tensor(pcfg.n_pages, device=dev)])
    woff = torch.tensor([5, 8, 13, 0], device=dev)
    active = torch.tensor([True, True, True, False], device=dev)
    tokens = torch.tensor([[17], [200], [301], [0]], device=dev)
    step = make_paged_decode_step(model, pcfg, forward_fn=None if forward is llama.forward else forward)
    with torch.no_grad():
        got, pools = step(model.params, pools, tokens, lengths, tables, wpage, woff, active)
        views = [(paged_gather(kp, tables), paged_gather(vp, tables)) for kp, vp in pools]
        pos = lengths.to(torch.int32)
        want = forward(model.params, cfg, tokens, pos, views, pos)[0]
    nm = max(errors(want[i].float(), got[i].float())[0] for i in range(3))
    check(nm <= 1e-5 and not got[3].any(), f"{type(model).__name__}: paged step against the dense forward: "
                                            f"NMSE {nm:.2e}")
    return dict(nmse=nm)


def captured_grouped_forward(torch, np, model, rows: int) -> dict:
    """The engine's decode step at `rows` slots (>= 16: the grouped experts,
    the tokens sorted by expert on the card) captured as a CUDA graph
    (models/common.capture_graph) and replayed, against the same forward run
    eagerly on the same state: equal logits."""
    from ggml_tpu_torch.models import llama
    from ggml_tpu_torch.models.common import capture_graph

    cfg, dev = model.cfg, model.device
    cache = llama.init_cache(cfg, rows, 256, torch.bfloat16, dev)
    gen = torch.Generator(device="cuda").manual_seed(6)
    for k, v in cache:
        k.copy_(torch.randn(k.shape, generator=gen, device=dev))
        v.copy_(torch.randn(v.shape, generator=gen, device=dev))
    tok = torch.randint(0, cfg.n_vocab, (rows, 1), generator=gen, device=dev)
    pos = torch.randint(0, 200, (rows,), generator=gen, device=dev).to(torch.int32)
    out = torch.empty((rows, cfg.n_vocab), dtype=torch.float32, device=dev)

    def run():
        out.copy_(llama.forward(model.params, cfg, tok, pos, cache, pos)[0][:, -1].float())

    graph, _ = capture_graph(run, dev)
    graph.replay()
    replayed = out.clone()
    with torch.no_grad():
        run()
    check(torch.equal(replayed, out) and bool(torch.isfinite(out).all()),
          f"the captured {rows}-row forward replays other logits than eager: {errors(out, replayed)}")
    return dict(rows=rows, equal=True)


def router_hook(torch, model) -> tuple:
    """(module, function name, margins, decisions) of the model's router,
    for wrapping the function where its forward looks it up.  margins(args,
    out) -> ((rows,), (rows,)): the smallest change that flips a routing
    decision of each row, as a value and in units of one rounding (ulp) of
    the router's scores in their own type (bf16 logits: 2^-7 of the value;
    the deepseek route's f32 ones 2^-23).  Top-k, gpt-oss and the deepseek
    route: the gap between the k-th and (k+1)-th selection values.
    sparsemixer: over both rounds and every expert but those picked, the
    relative gap (max - s) / max(|s|, max) from 2 jitter (its mask's edge;
    in ulps the score change that crosses it) or from 0 (a tie with the
    round's pick).  decisions(args, out) -> (rows, n): the chosen experts;
    sparsemixer's picks and both masks."""
    from ggml_tpu_torch.models import deepseek, glm4moe, gptoss, llama, phimoe

    def ulp(x, dtype):
        return torch.finfo(dtype).eps * torch.ldexp(torch.ones_like(x), torch.frexp(x).exponent - 1)

    def gap_k(sel, k, dtype):
        v = sel.float().reshape(-1, sel.shape[-1]).sort(dim=-1, descending=True).values
        gap = v[:, k - 1] - v[:, k]
        return gap, gap / ulp(torch.maximum(v[:, k - 1].abs(), v[:, k].abs()), dtype)

    def chosen(out):
        return out[1].reshape(-1, out[1].shape[-1]).sort(dim=-1).values

    if isinstance(model, phimoe.PhiMoE):
        def rounds(scores, jitter):
            s = scores.float().reshape(-1, scores.shape[-1])
            taken = torch.zeros_like(s, dtype=torch.bool)
            for _ in range(2):
                m, i = s.masked_fill(taken, float("-inf")).max(dim=-1, keepdim=True)
                rel = (m - s) / torch.maximum(s.abs(), m)
                taken = taken | torch.nn.functional.one_hot(i[:, 0], s.shape[-1]).bool()
                yield s, m, i, rel, taken

        def margins(a, out):
            raw, ulps = [], []
            for s, m, _, rel, taken in rounds(*a):
                edge = (rel - 2 * a[1]).abs()
                raw.append(torch.minimum(edge, rel).masked_fill(taken, float("inf")).amin(dim=-1))
                u = torch.minimum(edge * torch.maximum(s.abs(), m) / ulp(s, a[0].dtype), (m - s) / ulp(m, a[0].dtype))
                ulps.append(u.masked_fill(taken, float("inf")).amin(dim=-1))
            return torch.stack(raw).amin(dim=0), torch.stack(ulps).amin(dim=0)

        def decisions(a, out):
            return torch.cat([torch.cat([i, (rel > 2 * a[1]).long()], dim=-1) for _, _, i, rel, _ in rounds(*a)],
                             dim=-1)

        return phimoe, "sparsemixer_top2_gates", margins, decisions
    if isinstance(model, (glm4moe.GLM4MoE, deepseek.Deepseek)):
        def ds_margins(a, out):
            logits, bias, cfg = a
            sc = torch.sigmoid(logits.float()) if cfg.score_func == "sigmoid" else torch.softmax(logits.float(), -1)
            return gap_k(sc + bias.float(), cfg.n_expert_used, torch.float32)

        return deepseek, "route_logits", ds_margins, lambda a, out: chosen(out)
    return (gptoss if isinstance(model, gptoss.GptOss) else llama), "moe_topk", \
        lambda a, out: gap_k(a[0], a[1], a[0].dtype), lambda a, out: chosen(out)


def routed_prefill(torch, np, model, tokens: list, chunk: int = 0) -> tuple:
    """The model's own b = 1 prefill of tokens through its family forward
    (in chunks of `chunk` rows through the cache when given), with its
    router wrapped (router_hook): (the last row's logits f32, the router
    margins and their ulps, each (MoE layers, rows), the decisions, a list
    over the MoE layers)."""
    from ggml_tpu_torch.speculative import _forward_for

    forward = _forward_for(model)
    mod, name, margins, decisions = router_hook(torch, model)
    real = getattr(mod, name)
    calls = []

    def hooked(*a, **kw):
        out = real(*a, **kw)
        calls.append((margins(a, out), decisions(a, out)))
        return out

    step = chunk or len(tokens)
    toks = torch.as_tensor(np.asarray([tokens]), device=model.device)
    cache = model.new_cache(torch.bfloat16)
    setattr(mod, name, hooked)
    try:
        with torch.no_grad():
            for a in range(0, len(tokens), step):
                pos = torch.tensor([a], dtype=torch.int32, device=model.device)
                logits = forward(model.params, model.cfg, toks[:, a:a + step], pos, cache, pos,
                                 prefill=step == len(tokens))[0]
    finally:
        setattr(mod, name, real)
    n_moe = len(calls) // -(-len(tokens) // step)
    per_layer = [calls[i::n_moe] for i in range(n_moe)]
    return (logits[0, -1].float(), [torch.stack([torch.cat([m[j] for m, _ in c]) for c in per_layer]) for j in (0, 1)],
            [torch.cat([d for _, d in c]) for c in per_layer])


def split_margins(torch, np, model, prompts, a_ids, b_ids, n: int = 4, flips: bool = False) -> list:
    """Where two engines' greedy ids part: for the first n requests whose ids
    differ, at the first step where they do, the model's own b = 1 prefill
    of the prompt and the ids both engines gave before it (a third rounding
    of the same sums; routed_prefill): the gap between its top two logits
    on the last row, the gap between the two engines' picks there, and the
    smallest router margin (router_hook) over the layers on that row and on
    any row, and on any row in ulps of the router's scores.  With flips, the same tokens prefilled again in chunks of 16
    (M = 16 a forward: kernel B's int8 rows on the Q4_K linears where the
    whole sequence runs C over bf16 rows, another rounding of the same
    sums): the routing decisions (rows x MoE layers) that differ between the
    two prefills, and the picks' gap in the chunked one."""
    out = []
    for prompt, a, b in zip(prompts, a_ids, b_ids):
        a, b = list(a), list(b)
        if a == b or len(out) == n:
            continue
        j = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
        logits, (margins, ulps), decisions = routed_prefill(torch, np, model, prompt + a[:j])
        top = logits.topk(2).values
        last = margins[:, -1]
        rec = dict(step=j, a_id=a[j], b_id=b[j], top2_gap=float(top[0] - top[1]),
                   picks_gap=float(logits[a[j]] - logits[b[j]]), argmax=int(logits.argmax()),
                   router_margin_min=float(last.min()), router_margin_layer=int(last.argmin()),
                   router_margin_any_row=float(margins.min()), router_ulps_any_row=float(ulps.min()))
        if flips:
            chunked, _, again = routed_prefill(torch, np, model, prompt + a[:j], chunk=16)
            rec.update(route_flips=int(sum(int((x != y).any(dim=-1).sum()) for x, y in zip(decisions, again))),
                       chunked_picks_gap=float(chunked[a[j]] - chunked[b[j]]),
                       chunked_logits_max_abs=float((chunked - logits).abs().max()))
        out.append(rec)
    return out


def phase_moe_serve(torch, np, model, card: str) -> dict:
    """4s (c): the engine on (b)'s model at bench_serve's mix: 4 slots dense
    and paged with the prefix cache (pages of 16), a warm pass each, a timed
    pass with exact launches (timed_mix: B on the attention linears at M =
    4, F on the head, C and G at the admissions); then 16 slots (every
    tick's 16 rows take the grouped experts inside its graph); the paged
    step against the dense forward; a captured 16-row forward against
    eager."""
    import gc

    from ggml_tpu_torch.paged_kv import PagedConfig
    from ggml_tpu_torch.serve import Engine

    cfg = model.cfg
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.n_vocab, int(rng.integers(4, 30))).tolist() for _ in range(SERVE_REQUESTS)]
    out, counts = {}, {}
    kinds = (("dense", 4, {}), ("paged", 4, dict(paged=PagedConfig(4 * 16 + 16, 16, 16, prefix_cache=True))),
             ("dense_16_slots", MOE_SLOTS_GROUPED, {}))
    for label, slots, kw in kinds:
        eng = Engine(model, max_batch=slots, max_seq=256, cache_dtype=torch.bfloat16, record_events=True, **kw)
        _run_ids(eng, prompts, SERVE_NEW)
        torch.cuda.synchronize()
        eng.event_ms()
        run = timed_mix(torch, eng, prompts, SERVE_NEW)
        ev, delta = run["event_ms"], run["engine"]
        span, steps = ("paged", delta["paged_steps"]) if label == "paged" else ("tick", delta["decode_steps"])
        run["ms_per_step"] = ev.get(span, 0.0) / max(1, steps)
        for k, v in run["counts"].items():
            counts[k] = counts.get(k, 0) + v
        out[label] = run
        print(f"  {label}, {slots} slots ({card}): {run['tokens']} tokens in {run['wall_s'] * 1e3:.1f} ms, "
              f"{run['tok_per_s']:.1f} tok/s, {run['ms_per_step']:.3f} ms a step on the card, idle "
              f"{run['idle_share'] * 100:.1f} %; prefix hits {delta['cached_prefix_tokens']}; launches {run['counts']}")
        del eng
        gc.collect()
    out["paged_equal_dense"] = sum(a == b for a, b in zip(out["paged"]["ids"], out["dense"]["ids"]))
    out["split_margins"] = split_margins(torch, np, model, prompts, out["dense"]["ids"], out["paged"]["ids"])
    for run in out.values():
        if isinstance(run, dict):
            run.pop("ids", None)
    out["counts"] = counts
    out["paged_step_vs_dense"] = paged_against_dense(torch, np, model)
    out["captured_grouped"] = captured_grouped_forward(torch, np, model, MOE_SLOTS_GROUPED)
    print(f"  {out['paged_equal_dense']} of {len(prompts)} requests give the same ids dense and paged; the paged step "
          f"against the dense forward over the gathered windows: NMSE {out['paged_step_vs_dense']['nmse']:.2e}; a "
          f"captured {MOE_SLOTS_GROUPED}-row forward (grouped experts) replays equal to eager")
    print("  where dense and paged part, a b = 1 prefill up to the split: "
          + "; ".join(f"step {m['step']}: top-2 gap {m['top2_gap']:.4f}, picks' gap {m['picks_gap']:.4f} (argmax "
                      f"{'dense' if m['argmax'] == m['a_id'] else 'paged' if m['argmax'] == m['b_id'] else 'neither'}"
                      f"), router k/k+1 margin {m['router_margin_min']:.5f} (layer {m['router_margin_layer']})"
                      for m in out["split_margins"]))
    torch.cuda.empty_cache()
    return out


def phase_moe_train(torch, np, path: str, tmp: str, card: str, want_step: dict) -> dict:
    """4s (d): the finetuning entry points on Qwen3-30B-A3B, as a user calls
    them.  finetune_lora(keep_quantized=True) on (b)'s file, twice: each call
    loads the file itself (the attention and the head as planes, the frozen
    experts in bf16: finetune.moe_expert_dtype), rank 8 on the default
    targets (q, k, v, attn_output: the experts are 3-D), batch 1 x 512 of a
    repeated seeded pattern, lr 1e-3, 1 + 3 steps, the experts' products
    grouped (512 tokens): the call's seconds to the end of step 0 (load
    included), ms/step over steps 1-3 on the host's clock (the log's stamps
    after steps 0 and 3; the loss read back every step), exact launches
    (want_step a step: C on the 4 attention linears of every layer, G on the
    head), peak memory, losses finite and falling; the losses and the
    trained adapters equal across the two calls bit for bit.  Then finetune
    (full weights: f32 masters, the experts cast to bf16 in the forward) of
    the same model cut to one layer, 1 + 3 steps at 1 x 512 at the default
    AdamW: its seconds to step 0, ms/step, peak memory, finite losses, no
    launch of the port's kernels (every weight dense), the trained experts
    f32."""
    import gc

    from ggml_tpu_torch.opt import AdamWConfig, finetune, finetune_lora

    rank, batch, seq, steps, lr = (MOE_LORA[k] for k in ("rank", "batch", "seq", "steps", "lr"))
    pattern = np.random.default_rng(1).integers(0, 151936, 61)
    toks = np.resize(pattern, batch * seq * (steps + 1) + 1).astype(np.int32)

    def timed(fn):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        stamps = []
        t0 = time.perf_counter()
        losses, result = fn(lambda line: stamps.append(time.perf_counter()))  # after steps 0 and `steps`
        run = dict(to_first_step_s=stamps[0] - t0, ms_per_step=(stamps[1] - stamps[0]) * 1e3 / steps,
                   counts={k: v for k, v in launch_counts().items() if v}, losses=losses,
                   peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9, allocated_before_gb=before / 1e9)
        run["tokens_per_s"] = batch * seq / (run["ms_per_step"] * 1e-3)
        return run, result

    runs, adapters = [], []
    want = {k: v * (steps + 1) for k, v in want_step.items()}
    for _ in range(2):
        run, trained = timed(lambda log: finetune_lora(
            path, toks, rank=rank, keep_quantized=True, seq_len=seq, batch=batch, steps=steps + 1,
            adamw=AdamWConfig(alpha=lr), device="cuda", log=log))
        check(run["counts"] == want and all(np.isfinite(run["losses"])) and run["losses"][-1] < run["losses"][0],
              f"4s LoRA: launches {run['counts']}, want {want}; losses {run['losses']}")
        run["adapters"] = len(trained)
        runs.append(run)
        adapters.append(trained)
        del trained
    a, b = runs
    same = a["losses"] == b["losses"] and all(torch.equal(adapters[0][n][k], adapters[1][n][k])
                                              for n in adapters[0] for k in "ab")
    check(same, f"4s LoRA: two calls differ ({a['losses']} against {b['losses']})")
    del adapters
    out = dict(MOE_LORA, card=card, runs=runs, equal_across_calls=same, counts=a["counts"], launches_per_step=want_step)
    print(f"  finetune_lora(keep_quantized=True) rank {rank} ({a['adapters']} adapters), {batch} x {seq}: "
          f"{a['to_first_step_s']:.1f} / {b['to_first_step_s']:.1f} s to the end of step 0 (the load included), "
          f"then {a['ms_per_step']:.1f} / {b['ms_per_step']:.1f} ms/step ({a['tokens_per_s']:.0f} tok/s), launches a "
          f"step {want_step}, peak {a['peak_memory_gb']:.2f} GB; losses {[round(v, 4) for v in a['losses']]}; both "
          "calls equal bit for bit")

    cut_dir = os.path.join(tmp, "cut")  # apart from the whole run's file, which may hold as many layers
    os.makedirs(cut_dir, exist_ok=True)
    path1, cfg1, info = write_qwen3_moe_gguf(np, cut_dir, 1)
    run, opt = timed(lambda log: finetune(path1, toks, seq_len=seq, batch=batch, steps=steps + 1, device="cuda",
                                          log=log))
    exps = opt.params["blk.0.ffn_gate_exps.weight"]
    check(run["counts"] == {} and all(np.isfinite(run["losses"])) and exps.dtype == torch.float32,
          f"4s finetune: launches {run['counts']}, losses {run['losses']}, experts {exps.dtype}")
    run.update(info, n_layer=cfg1.n_layer, params=sum(v.numel() for v in opt.params.values()))
    del opt, exps
    os.remove(path1)
    out["full"] = run
    print(f"  finetune (full weights, 1 of 48 layers, {run['params'] / 1e9:.3f} B f32 parameters), {batch} x {seq}: "
          f"{run['to_first_step_s']:.1f} s to the end of step 0, then {run['ms_per_step']:.1f} ms/step, peak "
          f"{run['peak_memory_gb']:.2f} GB; losses {[round(v, 4) for v in run['losses']]}; the experts trained in f32")
    return out


def phase_moe_tiny(torch, np, tmp: str) -> dict:
    """4s (e): tiny files (E 64, 4 heads over 2 kv heads, 2 layers, 4
    experts of 32, 2 a token; write_random_gguf with F32 weights) of
    Mixtral (llama), qwen2moe (its shared expert), qwen3moe and granitemoe
    on the card against the same file on the CPU, fed the same tokens: f32
    (TF32 off) at a 12-token prompt (the dense experts) and 3 decode steps,
    NMSE <= 1e-9; bf16 at a 20-token prompt (the grouped experts: bf16
    only on the card) and 3 decode steps, NMSE <= 1e-3 (bf16 products
    rounded in another order)."""
    from ggml_tpu_torch.dtypes import GGMLType
    from ggml_tpu_torch.models import llama

    base = dict(n_vocab=256, n_ctx=64, n_embd=64, n_head=4, n_head_kv=2, n_layer=2, n_ff=96, rope_base=10000.0,
                n_expert=4, n_expert_used=2)
    archs = {"llama": {}, "qwen2moe": {}, "qwen3moe": dict(head_dim_override=32),
             "granitemoe": dict(embd_scale=12.0, resid_scale=0.22, attn_scale=0.0625, logit_scale=8.0)}
    out = {}
    for i, (arch, over) in enumerate(archs.items()):
        path = os.path.join(tmp, f"tiny-{arch}.gguf")
        llama.write_random_gguf(path, llama.LlamaConfig(**base, **over), seed=20 + i, arch=arch, n_ff_exp=32,
                                default_type=GGMLType.F32)
        for dtype, t, gate in ((torch.float32, 12, 1e-9), (torch.bfloat16, 20, 1e-3)):
            models = [llama.Llama.from_gguf(path, dtype=dtype, keep_quantized=False, device=d, max_seq=32)
                      for d in ("cpu", "cuda")]
            prompt = torch.from_numpy(np.random.default_rng(t).integers(0, 256, (1, t)))
            runs = []
            for m in models:
                zero = torch.zeros((), dtype=torch.int32, device=m.device)
                cache = m.new_cache(torch.float32)
                runs.append([llama.forward(m.params, m.cfg, prompt.to(m.device), zero.expand(1), cache, zero,
                                           prefill=True)[0][:, -1].float().cpu(), cache])
            worst = errors(runs[0][0], runs[1][0])[0]
            tok = int(torch.argmax(runs[0][0]))
            for step in range(3):
                logits = []
                for m, (_, cache) in zip(models, runs):
                    pos = torch.tensor(t + step, dtype=torch.int32, device=m.device)
                    logits.append(llama.forward(m.params, m.cfg, torch.tensor([[tok]], device=m.device),
                                                pos.expand(1), cache, pos)[0][0, -1].float().cpu())
                worst = max(worst, errors(*logits)[0])
                tok = int(torch.argmax(logits[0]))
            name = f"{arch}/{str(dtype)[6:]}"
            check(worst <= gate, f"tiny {name}: card against CPU NMSE {worst:.2e} > {gate:g}")
            out[name] = worst
        os.remove(path)
    print("  tiny MoE files, card against CPU, worst NMSE over the prefill and 3 steps: "
          + ", ".join(f"{k} {v:.1e}" for k, v in out.items()))
    return out


def phase_moe(torch, np, tmp: str, card: str, n_layer: int) -> list:
    """4s: (a)-(e) above; returns the run records, each with its counts."""
    import gc

    runs = [phase_moe_bench(torch, np, card)]
    path, cfg, info = write_qwen3_moe_gguf(np, tmp, n_layer)
    model, qwen = phase_moe_qwen(torch, np, path, cfg, card)
    qwen.update(info)
    qwen["counts"] = {}
    for key in ("prefill", "decode"):
        for k, v in qwen[key]["counts"].items():
            qwen["counts"][k] = qwen["counts"].get(k, 0) + v
    runs.append(qwen)
    runs.append(phase_moe_serve(torch, np, model, card))
    want_step = planar_launches(model.params, MOE_LORA["batch"] * MOE_LORA["seq"], head=True)
    del model
    runs.append(phase_moe_train(torch, np, path, tmp, card, want_step))
    os.remove(path)
    gc.collect()
    torch.cuda.empty_cache()
    runs.append(dict(tiny=phase_moe_tiny(torch, np, tmp), counts={}))
    return runs


# 4t: the DeepSeek family (models/deepseek.py: absorbed MLA, group-limited
# routing, shared experts, leading dense layers): (a) bench_mla_decode's
# exact shape (bench.py:534-590, scale "lite": V2-Lite's attention with a
# dense FFN, 16 layers of bf16 synthesized on the card, batch 1, max_seq
# 128, 32 + 32 tokens from token 11); (b) DeepSeek-V2-Lite from a deepseek2
# Q4_K GGUF file (Q6_K head) through the normal entry points, DS_LITE_LAYERS
# of its 27 layers in the whole run (--deepseek: all 27): the load, a
# 1024-token prefill, graphed decode, the generate CLI, the Engine (dense,
# paged, chunked, q8, 16 slots, a self-draft), LoRA and finetune; (c)
# DeepSeek-V3's widths cut to its 3 dense layers and 1 MoE layer (q_lora,
# 8 groups, sigmoid scores with a bias, routed scaling), synthesized on the
# card: a 1024-token prefill, graphed decode, the route on the card against
# the CPU's, grouped against dense experts
DS_MLA = dict(n_vocab=32000, n_embd=2048, n_head=16, n_layer=16, n_ff=8192, n_dense_lead=16, kv_lora_rank=512,
              qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128, q_lora_rank=0, n_expert=0)
DS_TOKENS, DS_FIRST, DS_MAX_SEQ = 32, 11, 128
DS_LITE_LAYERS = 4  # the whole run's depth of DeepSeek-V2-Lite: the dense layer and 3 MoE layers
DS_LITE_LAYERS_ALONE = 27  # --deepseek
DS_LITE_FF_EXP, DS_V3_FF_EXP = 1408, 2048  # moe_intermediate_size
DS_V3_LAYERS = 4  # DeepSeek-V3's 3 dense layers and its first MoE layer
DS_SERVE_SEQ, DS_SHARED = 256, 64  # the engine's max_seq; the paged mix's shared prefix
DS_LORA = dict(rank=8, batch=1, seq=512, steps=3, lr=1e-3)
_DS_RANGES = {"planar_matmul.expand_compact": "expansions", "deepseek.attention": "MLA attention",
              "deepseek.moe_experts": "experts", "deepseek.router": "router"}


def synth_mla_params(torch, cfg, seed: int = 0) -> dict:
    """bench.py's _synth_on_device for bench_mla_decode: normal(0, 0.02)
    bf16 weights from a seeded generator on the card, norms of ones."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    d, H, r = cfg.n_embd, cfg.n_head, cfg.kv_lora_rank
    shapes = {"token_embd.weight": (cfg.n_vocab, d), "output.weight": (cfg.n_vocab, d)}
    ones = {"output_norm.weight": (d,)}
    for i in range(cfg.n_layer):
        pre = f"blk.{i}."
        ones.update({pre + "attn_norm.weight": (d,), pre + "ffn_norm.weight": (d,), pre + "attn_kv_a_norm.weight": (r,)})
        shapes.update({pre + "attn_q.weight": (H * cfg.qk_head_dim, d),
                       pre + "attn_kv_a_mqa.weight": (r + cfg.qk_rope_dim, d),
                       pre + "attn_kv_b.weight": (H * (cfg.qk_nope_dim + cfg.v_head_dim), r),
                       pre + "attn_output.weight": (d, H * cfg.v_head_dim), pre + "ffn_gate.weight": (cfg.n_ff, d),
                       pre + "ffn_up.weight": (cfg.n_ff, d), pre + "ffn_down.weight": (d, cfg.n_ff)})
    out = {name: torch.randn(shape, generator=gen, device="cuda", dtype=torch.bfloat16).mul_(0.02)
           for name, shape in sorted(shapes.items())}
    out.update({name: torch.ones(shape, dtype=torch.bfloat16, device="cuda") for name, shape in ones.items()})
    return out


def phase_ds_mla(torch, np, card: str) -> dict:
    """4t (a): bench_mla_decode's shape (DS_MLA), as bench.py runs it: 32
    greedy tokens from token 11 at n_past 0 (the capture and warm-up), then
    32 from n_past 32 graphed and timed, then eagerly (the same ids);
    ms/token and tokens/s beside the floor (the weights' bytes a token at
    3.35 TB/s); graphed and eager decode profiled, the absorbed attention's
    share of eager busy time read by its range.  Dense bf16 weights: no
    kernel of the port is on this path, its counts stay 0."""
    import gc

    from ggml_tpu_torch.models import deepseek

    gc.collect()
    torch.cuda.empty_cache()
    cfg = deepseek.DeepseekConfig(**DS_MLA)
    t0 = time.perf_counter()
    params = synth_mla_params(torch, cfg)
    torch.cuda.synchronize()
    out = dict(config=DS_MLA, card=card, synth_s=time.perf_counter() - t0)
    model = deepseek.Deepseek(params, cfg, max_seq=DS_MAX_SEQ, device="cuda")
    first = torch.tensor([[DS_FIRST]], device="cuda")
    cache = model.new_cache(torch.bfloat16)
    cache, _ = model.decode_greedy(cache, first, 0, DS_TOKENS)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    cache, ids = model.decode_greedy(cache, first, DS_TOKENS, DS_TOKENS)
    dt = time.perf_counter() - t0
    out["counts"] = {k: v for k, v in launch_counts().items() if v}
    t0 = time.perf_counter()
    cache, eager = model.decode_greedy(cache, first, DS_TOKENS, DS_TOKENS, graph=False)
    eager_dt = time.perf_counter() - t0
    ids, eager = ids[:, 0].tolist(), eager[:, 0].tolist()
    check(ids == eager and all(0 <= t < cfg.n_vocab for t in ids) and out["counts"] == {},
          f"bench_mla: graphed {ids[:8]}, eager {eager[:8]}, launches {out['counts']}")
    floors = moe_stream_bytes(torch, params, cfg, cache)
    out.update(weights_bytes=floors["every_bytes"], floor_ms=floors["every_floor_ms"], ms_per_token=dt * 1e3 / DS_TOKENS,
               mla_lite_bf16_decode_tokens_per_sec_per_chip=DS_TOKENS / dt,
               eager_ms_per_token=eager_dt * 1e3 / DS_TOKENS, ids=ids)
    out["decode_trace"] = profile_llama_decode(torch, np, model, ranges=_DS_RANGES, n_vocab=cfg.n_vocab)
    by = out["decode_trace"]["eager_ms_per_token_by_class"]
    out["attention_share_of_eager_busy"] = by.get("MLA attention", 0.0) / out["decode_trace"]["eager_device_ms_per_token"]
    print(f"  bench_mla_decode's shape (16 layers, bf16) on {card}: {out['ms_per_token']:.3f} ms/token graphed "
          f"({out['mla_lite_bf16_decode_tokens_per_sec_per_chip']:.1f} tok/s), eager {out['eager_ms_per_token']:.3f}; "
          f"floor {out['weights_bytes'] / 1e9:.3f} GB = {out['floor_ms']:.3f} ms; the absorbed attention "
          f"{out['attention_share_of_eager_busy'] * 100:.1f} % of eager busy; graphed ids equal eager")
    del model, params, cache
    gc.collect()
    torch.cuda.empty_cache()
    return out


def write_v2_lite_gguf(np, tmp: str, n_layer: int) -> tuple:
    """DeepSeek-V2-Lite's GGUF file at its published widths cut to n_layer
    layers (models/deepseek.write_random_gguf): Q4_K weights with llama.cpp's
    fallbacks (Q5_0 for the dense ffn_down, K = 10944, and ffn_down_exps, K
    = 1408), a Q6_K head, an F32 router and a zero selection bias (V2 has
    none), ones for the norms, a byte-level BPE vocabulary of 102400
    entries (the byte symbols, FRONT_END_TEXT's merges, placeholder words,
    <｜begin▁of▁sentence｜> at 100000 and <｜end▁of▁sentence｜> at 100001).
    Returns (path, config, dict(gguf_write_s, gguf_bytes), tokens, merges)."""
    from ggml_tpu_torch.dtypes import GGMLType
    from ggml_tpu_torch.models import deepseek
    from ggml_tpu_torch.tokenizer import byte_level_vocab, learn_merges

    cfg = dataclasses.replace(deepseek.deepseek_v2_lite_config(), n_layer=n_layer)
    merges = learn_merges(FRONT_END_TEXT, 100_000)
    tokens = byte_level_vocab(merges)
    bos, eos = 100000, 100001
    fill = _placeholders(set(tokens), cfg.n_vocab - len(tokens) - 2)
    tokens = (tokens + fill[:bos - len(tokens)] + ["<｜begin▁of▁sentence｜>", "<｜end▁of▁sentence｜>"]
              + fill[bos - len(tokens):])
    check(len(tokens) == cfg.n_vocab and len(set(tokens)) == len(tokens), f"vocabulary of {len(tokens)} entries")
    path = os.path.join(tmp, f"deepseek-v2-lite-{n_layer}-layers-q4_k.gguf")
    t0 = time.perf_counter()
    deepseek.write_random_gguf(path, cfg, seed=0, types={"output.weight": GGMLType.Q6_K}, n_ff_exp=DS_LITE_FF_EXP,
                               tokenizer=dict(model="gpt2", tokens=tokens, merges=merges, bos_token_id=bos,
                                              eos_token_id=eos))
    info = dict(gguf_write_s=time.perf_counter() - t0, gguf_bytes=os.path.getsize(path))
    print(f"  wrote {info['gguf_bytes'] / 1e9:.3f} GB of deepseek2 GGUF ({n_layer} of 27 layers) in "
          f"{info['gguf_write_s']:.1f}s")
    return path, cfg, info, tokens, merges


def ds_prefill_and_decode(torch, np, model, label: str) -> dict:
    """A Deepseek's 1024-token prefill (after a first-use run) with its
    exact launches (each planar linear's kernel at M = 1024, the head's) and
    busy time by class (_DS_RANGES); graphed decode of DS_TOKENS tokens
    after an 8-token prompt (moe_decode_run: eagerly the same ids) with its
    exact launches a token, beside the every-expert and top-k floors;
    grouped against dense experts at one step.  Returns the record, its
    counts summed."""
    cfg, p = model.cfg, model.params
    rng = np.random.default_rng(0)
    long = rng.integers(0, cfg.n_vocab, (1, 1024))
    model.prefill(model.new_cache(torch.bfloat16), long)  # first uses
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    logits, _, _ = model.prefill(model.new_cache(torch.bfloat16), long)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    counts = {k: v for k, v in launch_counts().items() if v}
    want = planar_launches(p, 1024, head=True)
    check(counts == want and bool(torch.isfinite(logits).all()), f"{label} prefill: launches {counts}, want {want}")
    prof = profile_classes(torch, lambda: model.prefill(model.new_cache(torch.bfloat16), long), 1, _DS_RANGES,
                           cfg.n_vocab)
    out = dict(prefill=dict(ms=prefill_ms, counts=counts, profile=prof), long_prompt=long)
    print(f"  1024-token prefill: {prefill_ms:.1f} ms, launches {counts}; device busy {prof['busy_ms']:.1f} ms by "
          f"class: {_fmt_classes(prof['by_class_ms'])}")
    run = moe_decode_run(torch, np, model, rng.integers(0, cfg.n_vocab, (1, 8)), DS_TOKENS)
    want = {k: v * DS_TOKENS for k, v in planar_launches(p, 1, head=True).items()}
    check(run["counts"] == want, f"{label} decode launches {run['counts']}, want {want}")
    run.update(moe_stream_bytes(torch, p, cfg, run.pop("cache")))
    run["every_floor_share"] = run["every_floor_ms"] / run["graphed_ms_per_token"]
    out["decode"] = run
    print(f"  decode after 8 tokens: {run['graphed_ms_per_token']:.3f} ms/token graphed, "
          f"{run['eager_ms_per_token']:.3f} eager (the same {DS_TOKENS} ids); floors: every expert "
          f"{run['every_bytes'] / 1e9:.3f} GB = {run['every_floor_ms']:.3f} ms, the top {cfg.n_expert_used} alone "
          f"{run['topk_bytes'] / 1e9:.3f} GB = {run['topk_floor_ms']:.3f} ms; launches a token "
          f"{run['launches_per_token']}")
    cache = model.new_cache(torch.bfloat16)
    model.prefill(cache, np.asarray([[run["first"]]]))
    out["grouped_vs_dense"] = grouped_against_dense(torch, model, cache, run["ids"][0], 1)
    print(f"  one step's logits, grouped against dense experts: NMSE {out['grouped_vs_dense']['nmse']:.2e}")
    out["counts"] = dict(counts)
    for k, v in run["counts"].items():
        out["counts"][k] = out["counts"].get(k, 0) + v
    return out


def phase_ds_lite(torch, np, path: str, want_cfg, tokens, merges, card: str) -> tuple:
    """4t (b), the model: DeepSeek-V2-Lite loaded through
    registry.load_model(keep_quantized=True) (the linears as planes, the
    experts and attn_kv_b dense bf16): the load; a 1024-token prefill with
    its exact launches (C on every planar linear, G on the dense ffn_down
    and the head) and busy time by class; graphed decode of 32 tokens after
    an 8-token prompt with exact launches a token (A on q, attn_kv_a_mqa,
    attn_output and the gate and up products, C on the shared ffn_down and
    G on the dense ffn_down at M = 1, F on the head), ms/token beside the
    every-expert and top-6 floors, eagerly the same ids; grouped against
    dense experts at one step; the generate CLI in a subprocess, its text
    this process's greedy text, its kernel report.  Returns (model, record)."""
    from ggml_tpu_torch.kernels import qmatmul
    from ggml_tpu_torch.models import deepseek, registry
    from ggml_tpu_torch.quant.planar import PlanarWeight
    from ggml_tpu_torch.tokenizer import BPETokenizer

    t0 = time.perf_counter()
    model = registry.load_model(path, keep_quantized=True, max_seq=2048, device="cuda")
    torch.cuda.synchronize()
    cfg = model.cfg
    out = dict(load_s=time.perf_counter() - t0, card=card, n_layer=cfg.n_layer,
               card_gb=torch.cuda.memory_allocated() / 1e9)
    check(isinstance(model, deepseek.Deepseek) and dataclasses.replace(cfg, rms_eps=want_cfg.rms_eps) == want_cfg,
          f"model {type(model).__name__}, config {cfg}")
    p = model.params
    planar = [k for k, v in p.items() if isinstance(v, PlanarWeight) and k != "token_embd.weight"]
    exps, kv_b = p["blk.1.ffn_gate_exps.weight"], p["blk.0.attn_kv_b.weight"]
    check(exps.shape == (64, DS_LITE_FF_EXP, 2048) and exps.dtype == torch.bfloat16
          and isinstance(kv_b, torch.Tensor) and kv_b.dtype == torch.bfloat16, f"experts {exps.shape}, kv_b {kv_b}")
    check(qmatmul.select_kernel(p["blk.1.ffn_down_shexp.weight"], 1) == "q4k_matmul"
          and qmatmul.select_kernel(p["blk.0.ffn_down.weight"], 1) == "q8_matmul", "C and G at M = 1")
    print(f"  loaded in {out['load_s']:.1f}s ({out['card_gb']:.2f} GB on the card): {len(planar)} planar linears, "
          "the experts and attn_kv_b bf16; C on the shared ffn_down and G on the dense ffn_down at M = 1")
    out.update(ds_prefill_and_decode(torch, np, model, "V2-Lite"))
    del out["long_prompt"]
    out["decode"]["trace"] = profile_llama_decode(torch, np, model, ranges=_DS_RANGES, n_vocab=cfg.n_vocab)

    tok = BPETokenizer(tokens, merges)
    text = " ".join(FRONT_END_TEXT.split()[:48])
    cmd = [sys.executable, "-m", "ggml_tpu_torch.cli.generate", path, "-p", text, "-n", "16", "--quantized",
           "--top-k", "1", "--seed", "0", "--verbose"]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    out["cli_wall_s"] = time.perf_counter() - t0
    check(r.returncode == 0, f"the generate CLI exited {r.returncode}:\n{r.stderr[-4000:]}")
    report = re.findall(r"^\s+(q4|q8)\s+K=(\d+)\s+N=(\d+)\s+(gemv-M|matmul-M) -> (.+)$", r.stderr, re.M)
    out["cli_report"] = [" ".join(x) for x in report]
    kernel_of = {(kind, int(k), int(n), c): path_ for kind, k, n, c, path_ in report}
    check(kernel_of.get(("q4", 2816, 2048, "gemv-M")) == "q4k_matmul"
          and kernel_of.get(("q8", 10944, 2048, "gemv-M")) == "q8_matmul", f"kernel report {report}")
    same = deepseek.Deepseek(p, cfg, max_seq=512, device="cuda")  # the CLI's max_seq
    ids = same.generate(np.asarray([tok.encode(text)], np.int32), 16)
    check(r.stdout == text + tok.decode(ids) + "\n", f"CLI text {r.stdout[-200:]!r} differs from "
          f"{text + tok.decode(ids)!r}")
    del same
    print(f"  CLI (python -m ggml_tpu_torch.cli.generate --quantized --top-k 1 -n 16): exit 0 in "
          f"{out['cli_wall_s']:.1f}s, the text of this process's greedy request; report: "
          + "; ".join(out["cli_report"]))
    return model, out


def phase_ds_serve(torch, np, model, card: str) -> dict:
    """4t (b), the Engine on the model at bench_serve's mix (24 requests of
    4-30-token prompts x 32 new from seed 0, max_seq 256, bucket 32): 4
    slots dense, paged with the prefix cache (pages of 16; the even
    requests behind a shared 64-token prefix, as serve_paged shares), chunked
    (chunks of 16), q8 (the latent cache's bytes against bf16 and against an
    expanded per-head cache), 16 slots (the grouped experts inside the
    tick's graph), each a warm pass and a timed pass with exact launches
    (timed_mix); the dense engine with a 2-layer self-draft at k = 4 (its
    tok/s, rounds and acceptance, ids beside the dense engine's); a paged
    engine with a draft raises, as JAX's does."""
    import gc

    from ggml_tpu_torch.models import deepseek
    from ggml_tpu_torch.paged_kv import PagedConfig
    from ggml_tpu_torch.serve import Engine

    cfg = model.cfg
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.n_vocab, int(rng.integers(4, 30))).tolist() for _ in range(SERVE_REQUESTS)]
    shared = rng.integers(0, cfg.n_vocab, DS_SHARED).tolist()
    paged_prompts = [shared + q if i % 2 == 0 else q for i, q in enumerate(prompts)]
    pcfg = PagedConfig(4 * DS_SERVE_SEQ // 16 + 16, 16, DS_SERVE_SEQ // 16, prefix_cache=True)
    kinds = (("dense", 4, prompts, {}), ("paged", 4, paged_prompts, dict(paged=pcfg)),
             ("chunked", 4, prompts, dict(prefill_chunk=16)), ("q8", 4, prompts, dict(cache_dtype="q8_kv")),
             ("dense_16_slots", MOE_SLOTS_GROUPED, prompts, {}))
    out, counts = {}, {}
    for label, slots, mix, kw in kinds:
        kw = dict(dict(cache_dtype=torch.bfloat16), **kw)
        eng = Engine(model, max_batch=slots, max_seq=DS_SERVE_SEQ, record_events=True, **kw)
        _run_ids(eng, mix, SERVE_NEW)
        torch.cuda.synchronize()
        eng.event_ms()
        eng.cached_prefix_tokens = 0
        run = timed_mix(torch, eng, mix, SERVE_NEW)
        ev, delta = run["event_ms"], run["engine"]
        span, steps = ("paged", delta["paged_steps"]) if label == "paged" else ("tick", delta["decode_steps"])
        run["ms_per_step"] = ev.get(span, 0.0) / max(1, steps)
        if label == "q8":
            run["cache_bytes"] = sum(a.nbytes + b.nbytes for a, b in eng.cache)
            run["bf16_cache_bytes"] = cfg.n_layer * slots * DS_SERVE_SEQ * (cfg.kv_lora_rank + cfg.qk_rope_dim) * 2
            run["expanded_cache_bytes"] = (cfg.n_layer * slots * DS_SERVE_SEQ * cfg.n_head
                                           * (cfg.qk_head_dim + cfg.v_head_dim) * 2)
        for k, v in run["counts"].items():
            counts[k] = counts.get(k, 0) + v
        out[label] = run
        print(f"  {label}, {slots} slots ({card}): {run['tokens']} tokens in {run['wall_s'] * 1e3:.1f} ms, "
              f"{run['tok_per_s']:.1f} tok/s, {run['ms_per_step']:.3f} ms a step on the card, idle "
              f"{run['idle_share'] * 100:.1f} %; prefix hits {delta['cached_prefix_tokens']}; launches {run['counts']}"
              + (f"; cache {run['cache_bytes'] / 1e6:.2f} MB (bf16 {run['bf16_cache_bytes'] / 1e6:.2f}, expanded "
                 f"per head {run['expanded_cache_bytes'] / 1e6:.2f})" if label == "q8" else ""))
        del eng
        gc.collect()
    draft = deepseek.Deepseek(model.params, dataclasses.replace(cfg, n_layer=2), max_seq=DS_SERVE_SEQ, device="cuda")
    eng = Engine(model, max_batch=4, max_seq=DS_SERVE_SEQ, cache_dtype=torch.bfloat16, draft=draft, draft_k=4)
    _run_ids(eng, prompts, SERVE_NEW)
    torch.cuda.synchronize()
    r0, d0, a0 = eng.spec_rounds, eng.spec_drafted, eng.spec_accepted
    reset_launches()
    t0 = time.perf_counter()
    ids = _run_ids(eng, prompts, SERVE_NEW)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    spec = dict(wall_s=wall, tok_per_s=sum(map(len, ids)) / wall, rounds=eng.spec_rounds - r0,
                acceptance=(eng.spec_accepted - a0) / max(1, eng.spec_drafted - d0),
                counts={k: v for k, v in launch_counts().items() if v},
                equal_to_dense=sum(a == b for a, b in zip(ids, out["dense"]["ids"])))
    check(all(len(x) == SERVE_NEW and all(0 <= t < cfg.n_vocab for t in x) for x in ids), "draft engine ids")
    for k, v in spec["counts"].items():
        counts[k] = counts.get(k, 0) + v
    out["draft"] = spec
    print(f"  dense with a 2-layer self-draft, k = 4: {spec['tok_per_s']:.1f} tok/s, {spec['rounds']} rounds, "
          f"acceptance {spec['acceptance'] * 100:.1f} %; {spec['equal_to_dense']} of {len(ids)} requests give the "
          "dense engine's ids")
    del eng
    try:
        Engine(model, max_batch=4, max_seq=DS_SERVE_SEQ, cache_dtype=torch.bfloat16, draft=draft, paged=pcfg)
        raise SmokeFailure("a paged engine over a Deepseek target took a draft")
    except ValueError:
        out["paged_draft_raises"] = True
    del draft
    out["paged_equal_dense"] = sum(a == b for a, b in zip(out["paged"]["ids"][1::2], out["dense"]["ids"][1::2]))
    for run in out.values():
        if isinstance(run, dict):
            run.pop("ids", None)
    out["counts"] = counts
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_ds_train(torch, np, path: str, tmp: str, card: str) -> dict:
    """4t (b), finetuning as a user calls it: finetune_lora over the file
    (rank 8 on the default targets: attn_output and the dense layer's
    SwiGLU; batch 1 x 512 of a repeated seeded pattern, lr 1e-3, 1 + 3
    steps; the base loaded dense f32, its frozen experts bf16: the file's
    attn_kv_b is Q4_K, which QLoRA cannot reshape, as in JAX): seconds to
    the end of step 0 (the load included), ms/step, peak memory, finite
    losses; then finetune (full weights) of the model cut to its dense layer
    and one MoE layer, 1 + 3 steps at 1 x 512."""
    import gc

    from ggml_tpu_torch.opt import finetune, finetune_lora

    rank, batch, seq, steps, lr = (DS_LORA[k] for k in ("rank", "batch", "seq", "steps", "lr"))
    from ggml_tpu_torch.opt import AdamWConfig

    pattern = np.random.default_rng(1).integers(0, 102400, 61)
    toks = np.resize(pattern, batch * seq * (steps + 1) + 1).astype(np.int32)

    def timed(fn):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        stamps = []
        t0 = time.perf_counter()
        losses, result = fn(lambda line: stamps.append(time.perf_counter()))
        run = dict(to_first_step_s=stamps[0] - t0, ms_per_step=(stamps[1] - stamps[0]) * 1e3 / steps,
                   counts={k: v for k, v in launch_counts().items() if v}, losses=losses,
                   peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
        check(all(np.isfinite(losses)), f"losses {losses}")
        return run, result

    lora, trained = timed(lambda log: finetune_lora(path, toks, rank=rank, seq_len=seq, batch=batch, steps=steps + 1,
                                                    adamw=AdamWConfig(alpha=lr), device="cuda", log=log))
    lora["adapters"] = len(trained)
    del trained
    print(f"  finetune_lora rank {rank} ({lora['adapters']} adapters), {batch} x {seq}: {lora['to_first_step_s']:.1f} s "
          f"to the end of step 0 (the load included), then {lora['ms_per_step']:.1f} ms/step, peak "
          f"{lora['peak_memory_gb']:.2f} GB; losses {[round(v, 4) for v in lora['losses']]}")
    cut_dir = os.path.join(tmp, "cut")  # apart from the whole run's file, which may hold as many layers
    os.makedirs(cut_dir, exist_ok=True)
    path2, cfg2, info, _, _ = write_v2_lite_gguf(np, cut_dir, 2)
    full, opt = timed(lambda log: finetune(path2, toks, seq_len=seq, batch=batch, steps=steps + 1, device="cuda",
                                           log=log))
    check(opt.params["blk.1.ffn_gate_exps.weight"].dtype == torch.float32, "the trained experts are f32 masters")
    full.update(info, params=sum(v.numel() for v in opt.params.values()))
    del opt
    os.remove(path2)
    print(f"  finetune (full weights, 2 of 27 layers, {full['params'] / 1e9:.3f} B f32 parameters), {batch} x {seq}: "
          f"{full['to_first_step_s']:.1f} s to the end of step 0, then {full['ms_per_step']:.1f} ms/step, peak "
          f"{full['peak_memory_gb']:.2f} GB; losses {[round(v, 4) for v in full['losses']]}")
    counts = dict(lora["counts"])
    for k, v in full["counts"].items():
        counts[k] = counts.get(k, 0) + v
    return dict(DS_LORA, card=card, lora=lora, full=full, counts=counts)


def synth_v3_params(torch, cfg, seed: int = 0) -> dict:
    """DeepSeek-V3's parameters at its widths on the card, cut to cfg's
    layers: the 2-D linears as synthesized Q4_K planes (models/gptj.
    synth_planar_weight: compact where K allows it), a Q6_K head, the token
    embedding, attn_kv_b and the stacked experts normal(0, 0.02) bf16, the
    router normal(0, 0.02) f32, the selection bias normal(0, 0.5) f32 (as
    JAX's parity test draws it), norms of ones."""
    from ggml_tpu_torch.dtypes import GGMLType
    from ggml_tpu_torch.models.gptj import synth_planar_weight

    gen = torch.Generator(device="cuda").manual_seed(seed + 7)
    dgen = torch.Generator(device="cuda").manual_seed(seed)
    normal = lambda shape, s=0.02, dt=torch.bfloat16: torch.randn(shape, generator=dgen, device="cuda", dtype=dt).mul_(s)
    q4 = lambda n, k: synth_planar_weight(n, k, GGMLType.Q4_K, gen)
    ones = lambda n: torch.ones((n,), dtype=torch.bfloat16, device="cuda")
    d, H, r, e, f = cfg.n_embd, cfg.n_head, cfg.kv_lora_rank, cfg.n_expert, DS_V3_FF_EXP
    p = {"token_embd.weight": normal((cfg.n_vocab, d)), "output_norm.weight": ones(d),
         "output.weight": synth_planar_weight(cfg.n_vocab, d, GGMLType.Q6_K, gen)}
    for i in range(cfg.n_layer):
        pre = f"blk.{i}."
        p.update({pre + "attn_norm.weight": ones(d), pre + "ffn_norm.weight": ones(d),
                  pre + "attn_q_a.weight": q4(cfg.q_lora_rank, d), pre + "attn_q_a_norm.weight": ones(cfg.q_lora_rank),
                  pre + "attn_q_b.weight": q4(H * cfg.qk_head_dim, cfg.q_lora_rank),
                  pre + "attn_kv_a_mqa.weight": q4(r + cfg.qk_rope_dim, d), pre + "attn_kv_a_norm.weight": ones(r),
                  pre + "attn_kv_b.weight": normal((H * (cfg.qk_nope_dim + cfg.v_head_dim), r)),
                  pre + "attn_output.weight": q4(d, H * cfg.v_head_dim)})
        if i < cfg.n_dense_lead:
            p.update({pre + "ffn_gate.weight": q4(cfg.n_ff, d), pre + "ffn_up.weight": q4(cfg.n_ff, d),
                      pre + "ffn_down.weight": q4(d, cfg.n_ff)})
            continue
        p.update({pre + "ffn_gate_inp.weight": normal((e, d), dt=torch.float32),
                  pre + "exp_probs_b.bias": normal((e,), 0.5, torch.float32),
                  pre + "ffn_gate_exps.weight": normal((e, f, d)), pre + "ffn_up_exps.weight": normal((e, f, d)),
                  pre + "ffn_down_exps.weight": normal((e, d, f)),
                  pre + "ffn_gate_shexp.weight": q4(cfg.n_shared * f, d),
                  pre + "ffn_up_shexp.weight": q4(cfg.n_shared * f, d),
                  pre + "ffn_down_shexp.weight": q4(d, cfg.n_shared * f)})
    return p


def phase_ds_v3(torch, np, card: str) -> dict:
    """4t (c): DeepSeek-V3's widths (deepseek_v3_config) at its 3 dense
    layers and its first MoE layer (synth_v3_params: 22.5 GB of bf16
    experts): a 1024-token prefill with its exact launches and busy time by
    class; the route of its 1024 rows on the card against the CPU's route
    of the same f32 router logits: the same experts; graphed decode of 32
    tokens with exact launches (A, H on the dense ffn_down over expanded
    planes, E on the head over expanded planes), eagerly the same ids,
    ms/token beside the every-expert and top-8 floors; grouped against
    dense experts at one step."""
    import gc

    from ggml_tpu_torch.models import deepseek

    gc.collect()
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(deepseek.deepseek_v3_config(), n_layer=DS_V3_LAYERS)
    t0 = time.perf_counter()
    params = synth_v3_params(torch, cfg)
    torch.cuda.synchronize()
    out = dict(card=card, n_layer=cfg.n_layer, synth_s=time.perf_counter() - t0,
               card_gb=torch.cuda.memory_allocated() / 1e9)
    model = deepseek.Deepseek(params, cfg, max_seq=1088, device="cuda")
    print(f"  DeepSeek-V3 ({cfg.n_layer} layers: 3 dense, 1 MoE; synthesized in {out['synth_s']:.1f}s, "
          f"{out['card_gb']:.2f} GB)")
    out.update(ds_prefill_and_decode(torch, np, model, "V3"))
    routed = []
    real = deepseek.deepseek_route

    def tap(h, w, bias, c):
        routed.append((h.float().reshape(-1, h.shape[-1]).clone(), w, bias))
        return real(h, w, bias, c)

    deepseek.deepseek_route = tap
    try:
        model.prefill(model.new_cache(torch.bfloat16), out.pop("long_prompt"))
    finally:
        deepseek.deepseek_route = real
    h, w, bias = routed[0]
    router = torch.matmul(h, w.float().t())
    _, card_idx = deepseek.route_logits(router, bias, cfg)
    _, cpu_idx = deepseek.route_logits(router.cpu(), bias.cpu(), cfg)
    same = int((card_idx.cpu() == cpu_idx).all(dim=-1).sum())
    check(same == h.shape[0], f"the route on the card and the CPU's: {same} of {h.shape[0]} rows agree")
    per = cfg.n_expert // cfg.n_group
    scores = torch.sigmoid(router.cpu()) + bias.cpu()
    surv = scores.view(-1, cfg.n_group, per).topk(2, dim=-1).values.sum(-1).topk(cfg.topk_group, dim=-1).indices
    masked_rows = int(sum(bool(((cpu_idx[i] // per)[:, None] != surv[i][None, :]).all(-1).any())
                          for i in range(h.shape[0])))
    out["route"] = dict(rows=h.shape[0], equal_rows=same, rows_with_a_masked_group_expert=masked_rows)
    print(f"  the route of the 1024-token prefill's {h.shape[0]} rows on the card equals the CPU's route of the "
          f"same router logits ({masked_rows} rows choose an expert of a masked group)")
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_deepseek(torch, np, tmp: str, card: str, n_layer: int) -> list:
    """4t: (a)-(c) above, V2-Lite at n_layer of its 27 layers; returns the
    run records, each with its counts."""
    import gc

    stage("4t (a). bench_mla_decode's shape: 16 layers of V2-Lite's attention, bf16, graphed decode")
    runs = [phase_ds_mla(torch, np, card)]
    stage(f"4t (b). DeepSeek-V2-Lite ({n_layer} of 27 layers) from a deepseek2 Q4_K GGUF file")
    path, cfg, info, tokens, merges = write_v2_lite_gguf(np, tmp, n_layer)
    model, lite = phase_ds_lite(torch, np, path, cfg, tokens, merges, card)
    lite.update(info)
    runs.append(lite)
    runs.append(phase_ds_serve(torch, np, model, card))
    del model
    gc.collect()
    torch.cuda.empty_cache()
    runs.append(phase_ds_train(torch, np, path, tmp, card))
    os.remove(path)
    stage("4t (c). DeepSeek-V3's widths: its 3 dense layers and 1 MoE layer, synthesized")
    runs.append(phase_ds_v3(torch, np, card))
    return runs


# 4u: the other mixture-of-experts families (models/glm4moe.py, which also
# reads dots1, olmoe.py, dbrx.py, phimoe.py, gptoss.py), each at its
# published widths from a GGUF file of random Q4_K weights with a Q6_K head
# (llama.cpp's fallbacks where K is not whole superblocks: Q4_K -> Q5_0,
# Q6_K -> Q8_0), its depth cut (MF_MODELS; --moe-families: as deep as the
# card and the disk allow, at most the published depth): (a) the load
# through registry.load_model, 32 greedy tokens graphed and eagerly (the
# same ids) beside the every-expert and top-k floors, exact launches, a
# profiled decode by class, the load's card-side decode of an expert
# against the host's; (b) the engine at 4 slots over mixed prompts, each
# request equal to itself alone through the same engine but at a tie
# (mf_parted: tied picks or a tied routing decision), the paged step
# against the dense forward; (c) for gpt-oss-20b and Phi-3.5-MoE the paged
# engine with a prefix hit and the chunked one, for gpt-oss-20b a 1-layer
# self-draft, each request equal to the dense engine's but at a tie, for
# Phi-3.5-MoE engines on both sides of its LongRoPE switch (max_seq 4096:
# the short factors; 8192: the long ones); (d) q8_kv refused; (e) one HTTP request to cli/server.py on the gpt-oss file; (f)
# tiny files of the six architectures on the card against the CPU
MF_TOKENS, MF_SEQ, MF_SERVE_SEQ, MF_NEW = 32, 2048, 256, 16
# name -> (module, config function, the whole run's depth, published depth, writer arguments)
MF_MODELS = {
    "gpt-oss-20b": ("gptoss", "gpt_oss_20b_config", 2, 24, {}),
    "Phi-3.5-MoE": ("phimoe", "phi35_moe_config", 2, 32, {}),
    "GLM-4.5-Air": ("glm4moe", "glm45_air_config", 2, 46, dict(n_ff_exp=1408, n_shared=1, bias_std=0.02)),
    "OLMoE-1B-7B": ("olmoe", "olmoe_1b_7b_config", 2, 16, {}),
    "DBRX": ("dbrx", "dbrx_config", 1, 40, {}),
}
# the ranges of the eager profile: the families' attention, routers and
# experts; planar_matmul's expansions
_MF_RANGES = {**_LLAMA_RANGES, "llama.moe_experts": "experts", "llama.moe_router": "router",
              "deepseek.moe_experts": "experts", "deepseek.router": "router", "phimoe.moe_experts": "experts",
              "phimoe.router": "router", "gptoss.moe_experts": "experts", "gptoss.router": "router"}
# a greedy request parts from itself alone only where its two candidates tie:
# the b = 1 reference's logits of the two picks within this (bf16 roundings
# of logits of about 1-4 are 1/128-1/32)
MF_TIE = 0.0625


def _mf_layer_bytes(cfg, n_ff_exp: int) -> tuple:
    """(bf16 bytes on the card, GGUF bytes) of one layer at ~4.5 bits a
    quantized weight: the experts dominate."""
    e, d = getattr(cfg, "n_expert", 0), cfg.n_embd
    params = 3 * e * n_ff_exp * d + 4 * d * cfg.n_head * cfg.head_dim
    return 2 * params, params * 9 // 16


def mf_depth(torch, cfg, kw: dict, tmp: str, most: int) -> int:
    """The deepest cut the card (12 GB kept for the rest) and the free disk
    (the file twice, 2 GB kept) hold, at most `most`."""
    import shutil

    card, disk = _mf_layer_bytes(cfg, kw.get("n_ff_exp", cfg.n_ff))
    free_card = torch.cuda.mem_get_info()[1] - 12e9
    free_disk = shutil.disk_usage(tmp).free - 2e9
    return max(1, min(most, int(free_card // card), int(free_disk // (2 * disk))))


def write_mf_gguf(np, tmp: str, name: str, n_layer: int, vocab: bool = False) -> tuple:
    """The model's GGUF file at its published widths cut to n_layer layers
    (its module's write_random_gguf, seed 0, Q4_K with a Q6_K head); with
    vocab, a byte-level BPE vocabulary of n_vocab entries (the byte
    symbols, FRONT_END_TEXT's merges, placeholder words, <|endoftext|> last).
    Returns (path, config, dict(gguf_write_s, gguf_bytes))."""
    import importlib

    from ggml_tpu_torch.dtypes import GGMLType
    from ggml_tpu_torch.tokenizer import byte_level_vocab, learn_merges

    mod_name, fn, _, _, kw = MF_MODELS[name]
    mod = importlib.import_module(f"ggml_tpu_torch.models.{mod_name}")
    cfg = dataclasses.replace(getattr(mod, fn)(), n_layer=n_layer)
    tok_kw = {}
    if vocab:
        merges = learn_merges(FRONT_END_TEXT, 100_000)
        tokens = byte_level_vocab(merges)
        tokens = tokens + _placeholders(set(tokens), cfg.n_vocab - len(tokens) - 1) + ["<|endoftext|>"]
        check(len(tokens) == cfg.n_vocab and len(set(tokens)) == len(tokens), f"vocabulary of {len(tokens)}")
        tok_kw = dict(tokenizer=dict(model="gpt2", tokens=tokens, merges=merges, eos_token_id=cfg.n_vocab - 1))
    path = os.path.join(tmp, f"{name.lower()}-{n_layer}-layers-q4_k.gguf")
    t0 = time.perf_counter()
    mod.write_random_gguf(path, cfg, seed=0, types={"output.weight": GGMLType.Q6_K}, **kw, **tok_kw)
    info = dict(gguf_write_s=time.perf_counter() - t0, gguf_bytes=os.path.getsize(path))
    print(f"  wrote {info['gguf_bytes'] / 1e9:.3f} GB of {name} GGUF ({n_layer} layers) in "
          f"{info['gguf_write_s']:.1f}s")
    return path, cfg, info


def _mf_classes(by: dict) -> dict:
    """busy ms by class folded into linears (the port's kernels and the
    head), experts (with the router), attention and other."""
    out = dict(linears=0.0, experts=0.0, attention=0.0, other=0.0)
    for k, v in by.items():
        key = ("linears" if k in ("A", "B", "C", "E", "F", "G", "H", "H expansions", "head") else
               "experts" if k in ("experts", "router") else "attention" if k in ("attention", "J") else "other")
        out[key] += v
    return out


def mf_parted(torch, np, model, label: str, prompts, want: list, got: list) -> list:
    """Where an engine's ids part from the dense engine's (or a request's
    alone from its ids in the mix): split_margins with flips for each such
    request; each must part at a tie: the two picks within MF_TIE in the b =
    1 reference, or a tied routing decision on one of its rows: one that
    another rounding of the same sums flips (route_flips > 0), or one
    within a rounding of the router's scores (router_ulps_any_row <= 1:
    the engines' kernels round those scores either way)."""
    parted = split_margins(torch, np, model, prompts, want, got, n=len(prompts), flips=True)
    for m in parted:
        check(abs(m["picks_gap"]) <= MF_TIE or m["route_flips"] > 0 or m["router_ulps_any_row"] <= 1.0,
              f"{type(model).__name__} {label}: a request parts from the dense engine beyond a tie: {m}")
    return parted


def _fmt_parted(parted: list) -> str:
    return "; ".join(f"step {m['step']}: picks' gap {m['picks_gap']:.4f} (top-2 {m['top2_gap']:.4f}), router margin "
                     f"{m['router_margin_min']:.5f} on the row, {m['router_margin_any_row']:.5f} on any "
                     f"({m['router_ulps_any_row']:.2f} ulps), "
                     f"{m['route_flips']} routing decisions flip in chunks of 16 (picks' gap there "
                     f"{m['chunked_picks_gap']:.4f})" for m in parted)


def mf_dequant_check(torch, np, model, path: str) -> dict:
    """The first expert of the first ffn_gate_exps, decoded on the card by
    the load (quant/torch_dequant.py), against the host's numpy decode of
    the same blocks cast to the same type: equal bit for bit."""
    from ggml_tpu_torch.dtypes import GGMLType, row_size
    from ggml_tpu_torch.gguf import GGUFFile
    from ggml_tpu_torch.quant.reference import dequantize

    name = next(k for k in model.params if k.endswith("ffn_gate_exps.weight"))
    got = model.params[name][0]
    with GGUFFile(path) as g:
        info = g.tensors[name]
        t, (n, k) = GGMLType(info.ggml_type), (int(d) for d in info.shape[1:])
        want = dequantize(g.tensor_bytes(name)[:n * row_size(t, k)], t, n * k).reshape(n, k)
    want = torch.from_numpy(want).to(got.dtype)
    check(torch.equal(got.cpu().view(torch.int16), want.view(torch.int16)),
          f"{name}: the card's decode of {t.name} differs from the host's")
    return dict(tensor=name, type=t.name, equal=True)


def engine_run(torch, model, counts: dict, label: str, prompts, n_new: int, **kw) -> tuple:
    """An Engine over the model (4 slots, MF_SERVE_SEQ rows, a bf16 cache
    unless kw says otherwise) warmed up on the first prompt (its captures
    and first uses), then the prompts run for n_new tokens each on the
    host clock, their launches added to counts.  Returns (the engine, the
    ids, dict(wall_s, tok_per_s, slots))."""
    from ggml_tpu_torch.serve import Engine

    eng = Engine(model, **dict(dict(max_batch=4, max_seq=MF_SERVE_SEQ, cache_dtype=torch.bfloat16), **kw))
    _run_ids(eng, prompts[:1], 2)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    ids = _run_ids(eng, prompts, n_new)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for k, v in launch_counts().items():
        counts[k] = counts.get(k, 0) + v
    check(all(len(x) == n_new and all(0 <= t < model.cfg.n_vocab for t in x) for x in ids),
          f"{type(model).__name__} {label} ids")
    return eng, ids, dict(wall_s=wall, tok_per_s=sum(map(len, ids)) / wall, slots=eng.max_batch)


def phase_mf_model(torch, np, name: str, tmp: str, card: str, n_layer: int) -> dict:
    """4u (a)-(e) for one model; returns its record with its counts."""
    import gc
    import importlib

    from ggml_tpu_torch.kernels import qmatmul
    from ggml_tpu_torch.models import registry
    from ggml_tpu_torch.paged_kv import PagedConfig
    from ggml_tpu_torch.quant.planar import PlanarWeight
    from ggml_tpu_torch.serve import Engine

    mod = importlib.import_module(f"ggml_tpu_torch.models.{MF_MODELS[name][0]}")
    path, want_cfg, info = write_mf_gguf(np, tmp, name, n_layer, vocab=name == "gpt-oss-20b")
    t0 = time.perf_counter()
    model = registry.load_model(path, keep_quantized=True, max_seq=MF_SEQ, device="cuda")
    torch.cuda.synchronize()
    cfg, p = model.cfg, model.params
    out = dict(model=name, n_layer=n_layer, load_s=time.perf_counter() - t0, card=card,
               card_gb=torch.cuda.memory_allocated() / 1e9, **info)
    same = lambda got, want: got == want or (isinstance(want, float) and got == float(np.float32(want)))  # f32 keys
    check(type(model).__module__ == mod.__name__ and all(
        same(getattr(cfg, f.name), getattr(want_cfg, f.name)) for f in dataclasses.fields(cfg)),
          f"{name}: {type(model).__name__}, config {cfg}")
    planar = sorted({str(v.orig_type.name) for k, v in p.items() if isinstance(v, PlanarWeight)})
    exps = next(v for k, v in p.items() if k.endswith("ffn_gate_exps.weight"))
    check(exps.dtype == torch.bfloat16 and exps.dim() == 3, f"{name} experts {exps.dtype} {exps.shape}")
    kernels_m1 = sorted({qmatmul.select_kernel(w, 1) for k, w in p.items()
                         if isinstance(w, PlanarWeight) and k != "token_embd.weight"})
    out.update(plane_types=planar, kernels_at_m1=kernels_m1)
    print(f"  loaded in {out['load_s']:.1f}s ({out['card_gb']:.2f} GB on the card): planes {planar}, the experts "
          f"bf16 {tuple(exps.shape)}; at M = 1: {kernels_m1}")

    rng = np.random.default_rng(0)
    run = moe_decode_run(torch, np, model, rng.integers(0, cfg.n_vocab, (1, 8)), MF_TOKENS)
    want = {k: v * MF_TOKENS for k, v in planar_launches(p, 1, head=True).items()}
    check(run["counts"] == want, f"{name} decode launches {run['counts']}, want {want}")
    run.update(moe_stream_bytes(torch, p, cfg, run.pop("cache")))
    run["every_floor_share"] = run["every_floor_ms"] / run["graphed_ms_per_token"]
    trace = profile_llama_decode(torch, np, model, ranges=_MF_RANGES, n_vocab=cfg.n_vocab)
    trace["eager_by_four_classes"] = _mf_classes(trace["eager_ms_per_token_by_class"])
    run["trace"] = trace
    out["decode"] = run
    counts = dict(run["counts"])
    print(f"  decode after 8 tokens ({card}): {run['graphed_ms_per_token']:.3f} ms/token graphed, "
          f"{run['eager_ms_per_token']:.3f} eager (the same {MF_TOKENS} ids); floors: every expert "
          f"{run['every_bytes'] / 1e9:.3f} GB = {run['every_floor_ms']:.3f} ms, the top {cfg.n_expert_used} alone "
          f"{run['topk_bytes'] / 1e9:.3f} GB = {run['topk_floor_ms']:.3f} ms; launches a token "
          f"{run['launches_per_token']}; an eager token by class: {_fmt_classes(trace['eager_by_four_classes'])}")

    def engine(label, prompts, n_new=MF_NEW, **kw):
        return engine_run(torch, model, counts, label, prompts, n_new, **kw)

    prompts = [rng.integers(0, cfg.n_vocab, int(rng.integers(4, 30))).tolist() for _ in range(8)]
    eng, ids, rec = engine("dense", prompts)
    alone = [_run_ids(eng, [q], len(x))[0] for q, x in zip(prompts, ids)]
    rec.update(equal=sum(a == b for a, b in zip(alone, ids)), parted=mf_parted(torch, np, model, "alone", prompts,
                                                                                 ids, alone))
    out["engine"] = rec
    print(f"  engine, 4 slots, 8 prompts of 4-30 tokens x {MF_NEW}: {rec['tok_per_s']:.1f} tok/s; "
          f"{rec['equal']} of 8 requests equal to themselves alone" + (
              f"; where they part: {_fmt_parted(rec['parted'])}" if rec["parted"] else ""))
    del eng
    try:
        Engine(model, max_batch=4, max_seq=MF_SERVE_SEQ, cache_dtype="q8_kv")
        raise SmokeFailure(f"{name}: a q8 KV cache was accepted")
    except TypeError:
        out["q8_kv_refused"] = True
    out["paged_step_vs_dense"] = paged_against_dense(torch, np, model)
    out["dequant"] = mf_dequant_check(torch, np, model, path)
    print(f"  the paged step against the dense forward over the gathered windows: NMSE "
          f"{out['paged_step_vs_dense']['nmse']:.2e}; {out['dequant']['tensor']}'s first expert decoded on the card "
          f"equals the host's {out['dequant']['type']} decode bit for bit; q8_kv refused")
    if name in ("gpt-oss-20b", "Phi-3.5-MoE"):
        shared = rng.integers(0, cfg.n_vocab, 48).tolist()
        mix = [shared + q if i % 2 == 0 else q for i, q in enumerate(prompts)]
        pcfg = PagedConfig(4 * MF_SERVE_SEQ // 16 + 16, 16, MF_SERVE_SEQ // 16, prefix_cache=True)
        _, dense_ids, _ = engine("dense (paged mix)", mix)
        eng, paged_ids, rec = engine("paged", mix, paged=pcfg)
        check(eng.cached_prefix_tokens > 0, f"{name}: no prefix hit")
        rec.update(prefix_hits=eng.cached_prefix_tokens, equal_to_dense=sum(a == b for a, b in zip(paged_ids, dense_ids)),
                   parted=mf_parted(torch, np, model, "paged", mix, dense_ids, paged_ids))
        out["paged"] = rec
        del eng
        eng, chunk_ids, rec = engine("chunked", prompts, prefill_chunk=16)
        rec.update(equal_to_dense=sum(a == b for a, b in zip(chunk_ids, ids)),
                   parted=mf_parted(torch, np, model, "chunked", prompts, ids, chunk_ids))
        out["chunked"] = rec
        del eng
        for label in ("paged", "chunked"):
            r = out[label]
            print(f"  {label} ({'pages of 16, the prefix cache; half the mix behind a 48-token prefix, ' if label == 'paged' else 'chunks of 16, '}"
                  f"{r.get('prefix_hits', 0)} prefix tokens hit): {r['tok_per_s']:.1f} tok/s, {r['equal_to_dense']} of 8 "
                  f"equal to the dense engine" + (f"; where they part: {_fmt_parted(r['parted'])}" if r["parted"] else ""))
    if name == "gpt-oss-20b":
        draft = type(model)(p, dataclasses.replace(cfg, n_layer=1), max_seq=MF_SERVE_SEQ, device="cuda")
        eng, draft_ids, rec = engine("draft", prompts, draft=draft, draft_k=4)
        rec.update(rounds=eng.spec_rounds, acceptance=eng.spec_accepted / max(1, eng.spec_drafted),
                   equal_to_dense=sum(a == b for a, b in zip(draft_ids, ids)),
                   parted=mf_parted(torch, np, model, "draft", prompts, ids, draft_ids))
        out["draft"] = rec
        del eng, draft
        print(f"  dense with a 1-layer self-draft, k = 4: {rec['tok_per_s']:.1f} tok/s, {rec['rounds']} rounds, "
              f"acceptance {rec['acceptance'] * 100:.1f} %, {rec['equal_to_dense']} of 8 equal to the dense engine"
              + (f"; where they part: {_fmt_parted(rec['parted'])}" if rec["parted"] else ""))
        out["http"] = mf_http(torch, np, model, path)
    if name == "Phi-3.5-MoE":
        for seq in (4096, 8192):  # the short factors at max_seq <= n_ctx_orig, the long ones above
            eng, _, out[f"engine_max_seq_{seq}"] = engine(f"max_seq {seq}", prompts[:4], n_new=8, max_seq=seq)
            del eng
        zero = torch.zeros((), dtype=torch.int32, device="cuda")
        tok = torch.as_tensor(np.asarray([prompts[0]]), device="cuda")
        with torch.no_grad():
            short, long = (mod.forward(p, cfg, tok, zero.expand(1), mod.init_cache(cfg, 1, s, torch.bfloat16), zero)[0]
                           for s in (4096, 4097))
        out["longrope_logits_nmse"] = errors(short.float(), long.float())[0]
        check(out["longrope_logits_nmse"] > 0, "Phi-3.5-MoE: the long and short factors gave the same logits")
        print(f"  engines at max_seq 4096 (short factors) and 8192 (long): {out['engine_max_seq_4096']['tok_per_s']:.1f}"
              f" and {out['engine_max_seq_8192']['tok_per_s']:.1f} tok/s; a prefill's logits with the two factor "
              f"sets part by NMSE {out['longrope_logits_nmse']:.2e}")
    out["counts"] = counts
    del model
    gc.collect()
    torch.cuda.empty_cache()
    os.remove(path)
    return out


def mf_http(torch, np, model, path: str) -> dict:
    """One non-streamed completion from cli/server.py over the loaded model
    (ServerState(model=...), serve on a free local port): its text is the
    greedy text of the prompt through the same model."""
    import json
    import threading
    import urllib.request

    from ggml_tpu_torch.cli import server
    from ggml_tpu_torch.serve import Engine

    state = server.ServerState(path, max_batch=4, max_seq=512, model=model)
    httpd = server.serve(state, "127.0.0.1", 0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    text = " ".join(FRONT_END_TEXT.split()[:12])
    body = json.dumps({"prompt": text, "max_tokens": 8, "temperature": 0}).encode()
    t0 = time.perf_counter()
    try:
        req = urllib.request.Request(f"http://127.0.0.1:{httpd.server_address[1]}/v1/completions", body,
                                     {"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as r:
            reply = json.loads(r.read())["choices"][0]
    finally:
        httpd.shutdown()
        state.shutdown()
    wall = time.perf_counter() - t0
    check(state.error is None and reply["finish_reason"] in ("length", "stop"), f"server: {reply}, {state.error!r}")
    eng = Engine(model, max_batch=4, max_seq=512, eos_id=state.eos_id, cache_dtype=torch.bfloat16)
    want = state.tok.decode(_run_ids(eng, [state.encode(text)], 8)[0])
    check(reply["text"] == want, f"server text {reply['text']!r}, the engine's greedy text {want!r}")
    print(f"  HTTP server on the gpt-oss file: one completion of 8 tokens in {wall:.1f}s, the engine's greedy text")
    return dict(wall_s=wall, text=reply["text"][:60], finish_reason=reply["finish_reason"])


# 4u (f): tiny files of the six architectures (E 64, 4 heads over 2 kv
# heads, 2 layers, 4-8 experts of 24-32; F32 weights), card against CPU
_MF_TINY = dict(n_vocab=256, n_ctx=64, n_embd=64, n_head=4, n_head_kv=2, n_layer=2)


def phase_mf_tiny(torch, np, tmp: str) -> dict:
    """Each architecture's tiny file on the card against the same file on
    the CPU, fed the same tokens: f32 (TF32 off) at a 12-token prompt (the
    dense experts) and 3 decode steps, NMSE <= 1e-9; bf16 at a 20-token
    prompt (the grouped experts where a family has them: bf16 only on the
    card) and 3 decode steps, NMSE <= 1e-3."""
    from ggml_tpu_torch.dtypes import GGMLType
    from ggml_tpu_torch.models import dbrx, glm4moe, gptoss, olmoe, phimoe

    archs = {
        "glm4moe": (glm4moe, glm4moe.GLM4MoEConfig(**_MF_TINY, head_dim=16, n_ff=96, n_rot=8, n_expert=8,
                                                   n_expert_used=3, n_group=2, topk_group=1), dict(n_ff_exp=24)),
        "dots1": (glm4moe, glm4moe.GLM4MoEConfig(**_MF_TINY, head_dim=16, n_ff=96, n_rot=16, qk_norm=True,
                                                 n_expert=8, n_expert_used=3, moe_renorm=False),
                  dict(n_ff_exp=24, arch="dots1")),
        "olmoe": (olmoe, olmoe.OlmoEConfig(**_MF_TINY, n_ff=32, n_expert=8, n_expert_used=3), {}),
        "dbrx": (dbrx, dbrx.DBRXConfig(**_MF_TINY, n_ff=32, n_expert=4, n_expert_used=2, clamp_kqv=0.05), {}),
        "phimoe": (phimoe, phimoe.PhiMoEConfig(**_MF_TINY, n_ctx_orig=16, head_dim=16, n_ff=32, n_expert=4,
                                               n_expert_used=2, longrope=True, long_mscale=1.2), {}),
        "gpt-oss": (gptoss, gptoss.GptOssConfig(**_MF_TINY, head_dim=16, n_ff=32, n_expert=4, n_expert_used=2,
                                                sliding_window=6, rope_scaling="yarn", rope_scale=4.0,
                                                n_ctx_orig=16), {}),
    }
    from ggml_tpu_torch.models import registry

    out = {}
    for i, (arch, (mod, cfg, kw)) in enumerate(archs.items()):
        path = os.path.join(tmp, f"tiny-{arch}.gguf")
        mod.write_random_gguf(path, cfg, seed=30 + i, default_type=GGMLType.F32, **kw)
        out.update(tiny_against_cpu(torch, np, mod, registry.model_class(arch), path, arch))
        os.remove(path)
    print("  tiny files, card against CPU, worst NMSE over the prefill and 3 steps: "
          + ", ".join(f"{k} {v:.1e}" for k, v in out.items()))
    return out


def tiny_against_cpu(torch, np, mod, cls, path: str, label: str) -> dict:
    """A tiny file's model (cls) on the card against the same file on the
    CPU, fed the same tokens through mod.forward: f32 (TF32 off) at a
    12-token prompt and 3 greedy decode steps, NMSE <= 1e-9; bf16 at a
    20-token prompt and 3 steps, NMSE <= 1e-3.  Returns {label/dtype: the
    worst NMSE}."""
    out = {}
    for dtype, t, gate in ((torch.float32, 12, 1e-9), (torch.bfloat16, 20, 1e-3)):
        models = [cls.from_gguf(path, dtype=dtype, keep_quantized=False, device=d, max_seq=32) for d in ("cpu", "cuda")]
        prompt = torch.from_numpy(np.random.default_rng(t).integers(0, 256, (1, t)))
        runs = []
        for m in models:
            zero = torch.zeros((), dtype=torch.int32, device=m.device)
            cache = m.new_cache(torch.float32)
            runs.append([mod.forward(m.params, m.cfg, prompt.to(m.device), zero.expand(1), cache, zero)[0][:, -1]
                         .float().cpu(), cache])
        worst = errors(runs[0][0], runs[1][0])[0]
        tok = int(torch.argmax(runs[0][0]))
        for step in range(3):
            logits = []
            for m, (_, cache) in zip(models, runs):
                pos = torch.tensor(t + step, dtype=torch.int32, device=m.device)
                logits.append(mod.forward(m.params, m.cfg, torch.tensor([[tok]], device=m.device), pos.expand(1),
                                          cache, pos)[0][0, -1].float().cpu())
            worst = max(worst, errors(*logits)[0])
            tok = int(torch.argmax(logits[0]))
        name = f"{label}/{str(dtype)[6:]}"
        check(worst <= gate, f"tiny {name}: card against CPU NMSE {worst:.2e} > {gate:g}")
        out[name] = worst
    return out


def phase_moe_families(torch, np, tmp: str, card: str, deep: bool) -> list:
    """4u: (a)-(e) for each model at MF_MODELS' depth (deep: mf_depth's), then
    (f); returns the run records, each with its counts."""
    import importlib

    runs = []
    for name, (mod_name, fn, depth, most, kw) in MF_MODELS.items():
        if deep:
            cfg = getattr(importlib.import_module(f"ggml_tpu_torch.models.{mod_name}"), fn)()
            depth = mf_depth(torch, cfg, kw, tmp, most)
        stage(f"4u. {name} ({depth} of {most} layers) from a Q4_K GGUF file")
        runs.append(phase_mf_model(torch, np, name, tmp, card, depth))
    stage("4u (f). tiny glm4moe, dots1, olmoe, dbrx, phimoe and gpt-oss files on the card against the CPU")
    runs.append(dict(tiny=phase_mf_tiny(torch, np, tmp), counts={}))
    return runs


# 4v: the dense families (models/gemma2.py, which reads gemma, gemma2 and
# gemma3 files, phi2.py, phi3.py, neox.py, falcon.py), each at its published
# widths from a GGUF file of random Q4_K weights with a Q6_K head (the
# embedding of a tied model, llama.cpp's rule where a file has no output
# tensor; llama.cpp's fallbacks where K is not whole superblocks: Q4_K ->
# Q5_0, Q6_K -> Q8_0), its depth cut (DV_MODELS; --dense-families: as deep
# as the card and the disk allow, at most the published depth): (a) the
# load through registry.load_model; (b) prefills of 8, 100 and 1024 tokens
# timed, with exact launches; (c) 32 greedy tokens graphed and eagerly (the
# same ids) beside the plane-byte floor, exact launches a token, an eager
# token profiled by class; (d) the engine at 4 slots over mixed prompts:
# dense (each request equal to itself alone but at a tie: dense_parted),
# paged with a prefix hit (the gemma family's and Phi-3's own steps, the
# generic adapter for the others), chunked, q8 (the gemma family and
# Phi-3.5; the others refuse it) and with a 1-layer self-draft, each
# request equal to the dense engine's but at a tie (q8 is another result:
# each q8 request equal to itself alone), the paged step against the
# dense forward; (e) for the four families JAX finetunes, one QLoRA step
# over the loaded planes and one full-weight step over their f32
# dequantization; (f) tiny files of every variant on the card against the
# CPU, with finetune's and finetune_lora's first steps
DV_PREFILLS = (8, 100, 1024)
DV_TRAIN = dict(rank=8, batch=1, seq=128, lr=1e-3)
# name -> (module, config function, the whole run's depth, published depth, writer arguments, finetuned)
DV_MODELS = {
    "Gemma-2-9B": ("gemma2", "gemma2_9b_config", 4, 42, dict(arch="gemma2"), True),
    "Gemma-3-12B": ("gemma2", "gemma3_12b_config", 4, 48, dict(arch="gemma3"), False),
    "Phi-2": ("phi2", "phi2_config", 4, 32, {}, True),
    "Phi-3.5-mini": ("phi3", "phi35_mini_config", 4, 32, {}, False),
    "GPT-NeoX-20B": ("neox", "gpt_neox_20b_config", 4, 44, {}, True),
    "Falcon-7B": ("falcon", "falcon_7b_config", 4, 32, {}, True),
}


def _dv_layer_bytes(cfg) -> tuple:
    """(bytes on the card, GGUF bytes) of one layer at ~4.5 bits a weight."""
    d, hd = cfg.n_embd, cfg.head_dim
    n_kv = getattr(cfg, "n_head_kv", cfg.n_head)
    n_ff = getattr(cfg, "n_ff", 4 * d)
    params = 2 * d * cfg.n_head * hd + 2 * d * n_kv * hd + 3 * d * n_ff
    return params * 9 // 16, params * 9 // 16


def dv_depth(torch, cfg, tmp: str, most: int) -> int:
    """The deepest cut the card (24 GB kept for the head, the engines and
    a full-weight step) and the free disk (2 GB kept) hold, at most `most`."""
    import shutil

    card, disk = _dv_layer_bytes(cfg)
    free_card = torch.cuda.mem_get_info()[1] - 24e9
    free_disk = shutil.disk_usage(tmp).free - 2e9
    return max(1, min(most, int(free_card // card), int(free_disk // disk)))


def write_dv_gguf(np, tmp: str, name: str, n_layer: int) -> tuple:
    """The model's GGUF file at its published widths cut to n_layer layers
    (its module's write_random_gguf, seed 0, Q4_K with a Q6_K head or, where
    the head is tied, a Q6_K embedding).  Returns (path, config,
    dict(gguf_write_s, gguf_bytes))."""
    import importlib

    from ggml_tpu_torch.dtypes import GGMLType

    mod_name, fn, _, _, kw, _ = DV_MODELS[name]
    mod = importlib.import_module(f"ggml_tpu_torch.models.{mod_name}")
    cfg = dataclasses.replace(getattr(mod, fn)(), n_layer=n_layer)
    head = "token_embd.weight" if mod_name in ("gemma2", "falcon") else "output.weight"
    path = os.path.join(tmp, f"{name.lower()}-{n_layer}-layers-q4_k.gguf")
    t0 = time.perf_counter()
    mod.write_random_gguf(path, cfg, seed=0, types={head: GGMLType.Q6_K}, **kw)
    info = dict(gguf_write_s=time.perf_counter() - t0, gguf_bytes=os.path.getsize(path))
    print(f"  wrote {info['gguf_bytes'] / 1e9:.3f} GB of {name} GGUF ({n_layer} layers) in "
          f"{info['gguf_write_s']:.1f}s")
    return path, cfg, info


def dv_stream_bytes(params: dict, cache) -> dict:
    """Bytes a decode token reads at least: every plane and dense tensor but
    the embedding (one row of it) and its planes, the head (a tied model's
    dense embedding, read whole once), the KV cache window the attention
    reads whole; the floor at HBM_BYTES_PER_S."""
    from ggml_tpu_torch.quant.planar import PlanarWeight

    size = lambda t: t.plane_bytes() if isinstance(t, PlanarWeight) else t.numel() * t.element_size()
    total = sum(size(v) for k, v in params.items() if not k.startswith("token_embd"))
    if "output.weight" not in params:  # tied: the dense embedding is the head
        total += size(params.get("token_embd.weight@dense", params["token_embd.weight"]))
    total += sum(size(k) + size(v) for k, v in cache)
    return dict(stream_bytes=total, floor_ms=total / HBM_BYTES_PER_S * 1e3)


def dense_parted(torch, np, model, label: str, prompts, want: list, got: list) -> list:
    """Where an engine's ids part from the dense engine's (or a request's
    alone from its ids in the mix): at the first step where a request parts,
    three references of its prompt and the ids before it through the
    model's own forward, each another rounding of the same sums: the b = 1
    prefill whole, the same in chunks of 16 rows (every linear B: int8
    activations a row), and the same sequence as enough identical rows to
    make M > 32 (every linear C: bf16 activations), as an engine's padded
    admission runs it.  Each parting must be at a tie: the references
    preferring different picks, or the two picks within MF_TIE in a
    reference or within the rounding envelope, the largest change of any
    logit between the B and C references (another rounding of the same sums:
    up to 0.35 at Phi-3.5-mini's widths, whose SwiGLU spreads the int8
    roundings; 0.06 at Phi-2's)."""
    from ggml_tpu_torch.speculative import _forward_for

    forward = _forward_for(model)
    out = []
    for prompt, a, b in zip(prompts, want, got):
        a, b = list(a), list(b)
        if a == b:
            continue
        j = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
        seq = prompt + a[:j]
        t = len(seq)
        gaps, lasts = [], []
        for step, rows in ((t, 1), (16, 1), (t, -(-33 // t))):
            toks = torch.as_tensor(np.asarray([seq] * rows), device=model.device)
            cache = [(k[:1].repeat(rows, 1, 1, 1), v[:1].repeat(rows, 1, 1, 1)) for k, v in model.new_cache(torch.bfloat16)]
            with torch.no_grad():
                for s in range(0, t, step):
                    pos = torch.full((rows,), s, dtype=torch.int32, device=model.device)
                    logits = forward(model.params, model.cfg, toks[:, s:s + step], pos, cache, pos[0],
                                     prefill=step == t)[0]
            lasts.append(logits[0, -1].float())
            gaps.append(float(lasts[-1][a[j]] - lasts[-1][b[j]]))
        rec = dict(step=j, a_id=a[j], b_id=b[j], picks_gap=gaps[0], chunked_picks_gap=gaps[1], batched_picks_gap=gaps[2],
                   envelope=float((lasts[1] - lasts[2]).abs().max()))
        check(min(map(abs, gaps)) <= max(MF_TIE, rec["envelope"]) or len({g > 0 for g in gaps}) > 1,
              f"{type(model).__name__} {label}: a request parts beyond a tie: {rec}")
        out.append(rec)
    return out


def _fmt_dparted(parted: list) -> str:
    return "; ".join(f"step {m['step']}: picks' gap {m['picks_gap']:.4f} (chunked {m['chunked_picks_gap']:.4f}, "
                     f"batched {m['batched_picks_gap']:.4f}; envelope {m['envelope']:.4f})" for m in parted)


def dv_train(torch, np, model, path: str, card: str, full_layers: int) -> dict:
    """4v (e): finetune_lora(keep_quantized=True) over the loaded model's
    planes (its dense tensors cast to f32: finetune_lora's base=), rank 8 on
    the default targets, batch 1 x 128, lr 1e-3, one step: its seconds,
    launches, peak memory, a finite loss.  Then one full-weight step of its
    first full_layers layers (the whole run's cut: f32 weights, moments and
    gradients of a deeper cut would not fit the card): every plane
    dequantized to f32 on the card (qmatmul.planar_dequant: the planes'
    values, the GGUF's up to the last bit of a product), the family's
    make_lm_model_fn from an Optimizer at the default AdamW, as finetune
    runs it, no launch of the port's kernels (every weight dense)."""
    import gc

    from ggml_tpu_torch.gguf import GGUFFile
    from ggml_tpu_torch.kernels import qmatmul
    from ggml_tpu_torch.opt import AdamWConfig, Optimizer, finetune_lora
    from ggml_tpu_torch.opt.finetune import _family, make_lm_model_fn
    from ggml_tpu_torch.quant.planar import PlanarWeight

    with GGUFFile(path) as g:
        fam = _family(g.metadata["general.architecture"])
    model.decode_graphs.clear()  # the decode graphs' pools (a gemma's holds its f32 head copy): no more decode
    rank, batch, seq, lr = (DV_TRAIN[k] for k in ("rank", "batch", "seq", "lr"))
    toks = np.resize(np.random.default_rng(1).integers(0, model.cfg.n_vocab, 61), batch * seq + 1).astype(np.int32)

    def timed(fn):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        loss, extra = fn()
        torch.cuda.synchronize()
        run = dict(s=time.perf_counter() - t0, loss=loss, counts={k: v for k, v in launch_counts().items() if v},
                   peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9, **extra)
        check(np.isfinite(loss), f"{type(model).__name__}: loss {loss}")
        return run

    base = {k: v if isinstance(v, PlanarWeight) else v.float() for k, v in model.params.items()}

    def qlora():
        losses, trained = finetune_lora(path, toks, rank=rank, keep_quantized=True, seq_len=seq, batch=batch,
                                        steps=1, adamw=AdamWConfig(alpha=lr), device="cuda", base=base)
        return losses[0], dict(adapters=len(trained))

    out = dict(DV_TRAIN, qlora=timed(qlora))
    want = planar_launches(base, batch * seq, True)
    check(out["qlora"]["counts"] == {k: v for k, v in want.items() if v},
          f"QLoRA launches {out['qlora']['counts']}, want {want} (the forward; the backward dequantizes)")
    del base

    kept = {k: v for k, v in model.params.items()
            if not ((k == "token_embd.weight" and "token_embd.weight@dense" in model.params) or (
                k.startswith("blk.") and int(k.split(".")[1]) >= full_layers))}

    def dequantized() -> dict:
        params = {}
        for k, v in kept.items():
            if isinstance(v, PlanarWeight):
                v = qmatmul.planar_dequant(v, torch.float32)[:, :v.n].t().contiguous()
            params[k.replace("@dense", "")] = v.float()
        return params

    def full():
        # the Optimizer clones the dict it is handed, which is then freed
        fn = make_lm_model_fn(fam, dataclasses.replace(model.cfg, n_layer=full_layers), seq, batch)
        opt = Optimizer(fn, dequantized(), loss_type="cross_entropy_sparse", adamw=AdamWConfig())
        loss = float(opt.step(toks[:-1].reshape(batch, seq), toks[1:].reshape(batch, seq))["loss"])
        n = sum(v.numel() for v in opt.params.values())
        del opt
        return loss, dict(params=n, n_layer=full_layers)

    # f32 weights, AdamW's three state copies, the gradients and two update
    # temporaries: seven copies of the weights
    n_params = sum(v.n * v.k if isinstance(v, PlanarWeight) else v.numel() for v in kept.values())
    gc.collect()
    torch.cuda.empty_cache()
    need, free = 7 * 4 * n_params, torch.cuda.mem_get_info()[0]
    if need > free:  # a deep model's planes beside them (--dense-families)
        out["full"] = dict(skipped=f"needs {need / 1e9:.1f} GB, {free / 1e9:.1f} GB free", params=n_params)
        print(f"  QLoRA, rank {rank}, {batch} x {seq}: one step in {out['qlora']['s']:.2f} s, loss "
              f"{out['qlora']['loss']:.4f}; the full-weight step of {full_layers} layers skipped: "
              f"{out['full']['skipped']} ({card})")
        return out
    out["full"] = timed(full)
    check(out["full"]["counts"] == {}, f"full step launches {out['full']['counts']}")
    q, f = out["qlora"], out["full"]
    print(f"  QLoRA, rank {rank}, {batch} x {seq}: one step in {q['s']:.2f} s, loss {q['loss']:.4f}, peak "
          f"{q['peak_memory_gb']:.2f} GB; full weights ({full_layers} layers, {f['params'] / 1e9:.3f} B f32 "
          f"parameters): one step in "
          f"{f['s']:.2f} s, loss {f['loss']:.4f}, peak {f['peak_memory_gb']:.2f} GB ({card})")
    return out


def phase_dv_model(torch, np, name: str, tmp: str, card: str, n_layer: int) -> dict:
    """4v (a)-(e) for one model; returns its record with its counts."""
    import gc
    import importlib

    from ggml_tpu_torch.kernels import qmatmul
    from ggml_tpu_torch.models import registry
    from ggml_tpu_torch.paged_kv import PagedConfig
    from ggml_tpu_torch.quant.planar import PlanarWeight
    from ggml_tpu_torch.serve import Engine

    mod_name = DV_MODELS[name][0]
    mod = importlib.import_module(f"ggml_tpu_torch.models.{mod_name}")
    path, want_cfg, info = write_dv_gguf(np, tmp, name, n_layer)
    t0 = time.perf_counter()
    model = registry.load_model(path, keep_quantized=True, max_seq=MF_SEQ, device="cuda")
    torch.cuda.synchronize()
    cfg, p = model.cfg, model.params
    out = dict(model=name, n_layer=n_layer, load_s=time.perf_counter() - t0, card=card,
               card_gb=torch.cuda.memory_allocated() / 1e9, **info)
    same = lambda got, want: got == want or (isinstance(want, float) and got == float(np.float32(want)))  # f32 keys
    check(type(model).__module__ == mod.__name__ and all(
        same(getattr(cfg, f.name), getattr(want_cfg, f.name)) for f in dataclasses.fields(cfg)),
          f"{name}: {type(model).__name__}, config {cfg}")
    planar = sorted({str(v.orig_type.name) for v in p.values() if isinstance(v, PlanarWeight)})
    sites = {}
    for k, w in p.items():
        if isinstance(w, PlanarWeight) and k != "token_embd.weight":
            sites.setdefault(f"K={w.k} N={w.n} {w.orig_type.name}", {m: qmatmul.select_kernel(w, m) for m in (1, 4, 1024)})
    out.update(plane_types=planar, sites=sites)
    print(f"  loaded in {out['load_s']:.1f}s ({out['card_gb']:.2f} GB on the card): planes {planar}; kernels at "
          f"M = 1, 4, 1024: " + "; ".join(f"{s}: {', '.join(k.values())}" for s, k in sites.items()))

    counts = {}
    rng = np.random.default_rng(0)
    prefills = {}
    for t in DV_PREFILLS:
        prompt = rng.integers(0, cfg.n_vocab, (1, t))
        model.prefill(model.new_cache(torch.bfloat16), prompt)  # first uses at this length
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        logits, _, _ = model.prefill(model.new_cache(torch.bfloat16), prompt)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        got = {k: v for k, v in launch_counts().items() if v}
        want = {k: v for k, v in planar_launches(p, t, True).items() if v}
        check(got == want and bool(torch.isfinite(logits).all()), f"{name} prefill {t}: launches {got}, want {want}")
        for k, v in got.items():
            counts[k] = counts.get(k, 0) + v
        prefills[t] = dict(ms=ms, tok_per_s=t / ms * 1e3, counts=got)
    out["prefill"] = prefills
    print("  prefill: " + ", ".join(f"{t} tokens {r['ms']:.1f} ms ({r['tok_per_s']:.0f} tok/s)"
                                     for t, r in prefills.items()))

    run = moe_decode_run(torch, np, model, rng.integers(0, cfg.n_vocab, (1, 8)), MF_TOKENS)
    want = {k: v * MF_TOKENS for k, v in planar_launches(p, 1, head=True).items()}
    check(run["counts"] == want, f"{name} decode launches {run['counts']}, want {want}")
    run.update(dv_stream_bytes(p, run.pop("cache")))
    run["floor_share"] = run["floor_ms"] / run["graphed_ms_per_token"]
    run["trace"] = profile_llama_decode(torch, np, model, n_vocab=cfg.n_vocab)
    out["decode"] = run
    for k, v in run["counts"].items():
        counts[k] = counts.get(k, 0) + v
    print(f"  decode after 8 tokens ({card}): {run['graphed_ms_per_token']:.3f} ms/token graphed, "
          f"{run['eager_ms_per_token']:.3f} eager (the same {MF_TOKENS} ids); floor {run['stream_bytes'] / 1e9:.3f} GB "
          f"= {run['floor_ms']:.3f} ms ({run['floor_share'] * 100:.1f} % of graphed); launches a token "
          f"{run['launches_per_token']}")

    def engine(label, prompts, n_new=MF_NEW, **kw):
        return engine_run(torch, model, counts, label, prompts, n_new, **kw)

    prompts = [rng.integers(0, cfg.n_vocab, int(rng.integers(4, 30))).tolist() for _ in range(8)]
    eng, ids, rec = engine("dense", prompts)
    alone = [_run_ids(eng, [q], len(x))[0] for q, x in zip(prompts, ids)]
    rec.update(equal=sum(a == b for a, b in zip(alone, ids)),
               parted=dense_parted(torch, np, model, "alone", prompts, ids, alone))
    out["engine"] = rec
    del eng
    shared = rng.integers(0, cfg.n_vocab, 48).tolist()
    mix = [shared + q if i % 2 == 0 else q for i, q in enumerate(prompts)]
    pcfg = PagedConfig(4 * MF_SERVE_SEQ // 16 + 16, 16, MF_SERVE_SEQ // 16, prefix_cache=True)
    _, dense_ids, _ = engine("dense (paged mix)", mix)
    eng, paged_ids, rec = engine("paged", mix, paged=pcfg)
    check(eng.cached_prefix_tokens > 0, f"{name}: no prefix hit")
    rec.update(prefix_hits=eng.cached_prefix_tokens, equal_to_dense=sum(a == b for a, b in zip(paged_ids, dense_ids)),
               parted=dense_parted(torch, np, model, "paged", mix, dense_ids, paged_ids))
    out["paged"] = rec
    del eng
    eng, chunk_ids, rec = engine("chunked", prompts, prefill_chunk=16)
    rec.update(equal_to_dense=sum(a == b for a, b in zip(chunk_ids, ids)),
               parted=dense_parted(torch, np, model, "chunked", prompts, ids, chunk_ids))
    out["chunked"] = rec
    del eng
    draft = type(model)(p, dataclasses.replace(cfg, n_layer=1), max_seq=MF_SERVE_SEQ, device=model.device)
    eng, draft_ids, rec = engine("draft", prompts, draft=draft, draft_k=4)
    rec.update(rounds=eng.spec_rounds, acceptance=eng.spec_accepted / max(1, eng.spec_drafted),
               equal_to_dense=sum(a == b for a, b in zip(draft_ids, ids)),
               parted=dense_parted(torch, np, model, "draft", prompts, ids, draft_ids))
    out["draft"] = rec
    del eng, draft
    if mod_name in ("gemma2", "phi3"):
        eng, q8_ids, rec = engine("q8", prompts[:4], cache_dtype="q8_kv")
        q8_alone = [_run_ids(eng, [q], len(x))[0] for q, x in zip(prompts[:4], q8_ids)]
        rec.update(equal_to_dense=sum(a == b for a, b in zip(q8_ids, ids)),
                   equal_alone=sum(a == b for a, b in zip(q8_alone, q8_ids)),
                   parted=dense_parted(torch, np, model, "q8 alone", prompts[:4], q8_ids, q8_alone))
        out["q8"] = rec
        del eng
    else:
        try:
            Engine(model, max_batch=4, max_seq=MF_SERVE_SEQ, cache_dtype="q8_kv")
            raise SmokeFailure(f"{name}: a q8 KV cache was accepted")
        except TypeError:
            out["q8"] = "refused"
    out["paged_step_vs_dense"] = paged_against_dense(torch, np, model)
    for label in ("engine", "paged", "chunked", "draft", "q8"):
        r = out[label]
        if isinstance(r, dict):
            agree = (f"{r['equal']} of 8 equal to themselves alone" if label == "engine" else
                     f"{r['equal_alone']} of 4 equal to themselves alone, {r['equal_to_dense']} to the dense engine"
                     if label == "q8" else f"{r['equal_to_dense']} of 8 equal to the dense engine")
            extra = (f", {r['prefix_hits']} prefix tokens hit" if label == "paged" else
                     f", {r['rounds']} rounds, acceptance {r['acceptance'] * 100:.1f} %" if label == "draft" else "")
            print(f"  engine {'dense' if label == 'engine' else label}, 4 slots: {r['tok_per_s']:.1f} tok/s{extra}; {agree}"
                  + (f"; where they part: {_fmt_dparted(r['parted'])}" if r["parted"] else ""))
    print(f"  q8_kv {'refused' if out['q8'] == 'refused' else 'served'}; the paged step against the dense forward: "
          f"NMSE {out['paged_step_vs_dense']['nmse']:.2e}")
    if DV_MODELS[name][5]:
        out["train"] = dv_train(torch, np, model, path, card, min(n_layer, DV_MODELS[name][2]))
        for k, v in out["train"]["qlora"]["counts"].items():
            counts[k] = counts.get(k, 0) + v
    out["counts"] = counts
    del model, p
    gc.collect()
    torch.cuda.empty_cache()
    os.remove(path)
    return out


# 4v (f): tiny files of every variant (E 64, 4 heads, 2-3 layers; F32
# weights), card against CPU, the configs of tests/test_torch_dense_families.py
_DV_TINY = dict(n_vocab=256, n_ctx=64, n_embd=64, n_head=4, n_layer=2)


def phase_dv_tiny(torch, np, tmp: str) -> dict:
    """Each variant's tiny file on the card against the same file on the
    CPU (tiny_against_cpu).  For gemma2, phi2, gptneox and falcon, finetune's and
    finetune_lora's (dense) first two losses on the card against the CPU's,
    within 1e-5."""
    from ggml_tpu_torch.dtypes import GGMLType
    from ggml_tpu_torch.models import falcon, gemma2, neox, phi2, phi3
    from ggml_tpu_torch.opt import AdamWConfig, finetune, finetune_lora

    g = dict(_DV_TINY, n_head_kv=2, head_dim=16, n_ff=96)
    variants = {
        "gemma": (gemma2, gemma2.Gemma2Config(**g, sliding_window=0, attn_softcap=0.0, final_softcap=0.0,
                                              sandwich=False, query_pre_attn_scalar=16.0), dict(arch="gemma")),
        "gemma2": (gemma2, gemma2.Gemma2Config(**g, sliding_window=6, attn_softcap=0.01, final_softcap=0.3,
                                               query_pre_attn_scalar=24.0), dict(arch="gemma2")),
        "gemma3": (gemma2, gemma2.Gemma2Config(**dict(g, n_layer=3), rope_base=1e6, sliding_window=5,
                                               attn_softcap=0.0, final_softcap=0.0, sliding_pattern=3, qk_norm=True,
                                               rope_local_base=10000.0, rope_scale_global=8.0,
                                               query_pre_attn_scalar=16.0), dict(arch="gemma3")),
        "phi2": (phi2, phi2.Phi2Config(**_DV_TINY, n_head_kv=2, n_ff=96, n_rot=8), {}),
        "phi3": (phi3, phi3.Phi3Config(**g, n_ctx_orig=16, sliding_window=6, longrope=True), {}),
        "gptneox": (neox, neox.NeoXConfig(**_DV_TINY, n_ff=96, n_rot=8), {}),
        "gptneox-sequential": (neox, neox.NeoXConfig(**_DV_TINY, n_ff=96, n_rot=8, parallel_residual=False), {}),
        "falcon": (falcon, falcon.FalconConfig(**_DV_TINY, n_head_kv=1), {}),
        "falcon-dual-norm": (falcon, falcon.FalconConfig(**_DV_TINY, n_head_kv=2, dual_norm=True), {}),
    }
    from ggml_tpu_torch.models import registry

    out, train = {}, {}
    toks = np.resize(np.random.default_rng(0).integers(0, 256, 13), 200).astype(np.int32)
    for i, (case, (mod, cfg, kw)) in enumerate(variants.items()):
        path = os.path.join(tmp, f"tiny-{case}.gguf")
        mod.write_random_gguf(path, cfg, seed=30 + i, default_type=GGMLType.F32, **kw)
        out.update(tiny_against_cpu(torch, np, mod, registry.model_class(kw.get("arch", case.split("-")[0])), path,
                                    case))
        if case in ("gemma2", "phi2", "gptneox", "falcon"):
            kw = dict(seq_len=16, batch=2, steps=2)
            full = [finetune(path, toks, adamw=AdamWConfig(alpha=3e-3), device=d, **kw)[0] for d in ("cpu", "cuda")]
            lora = [finetune_lora(path, toks, rank=4, adamw=AdamWConfig(alpha=1e-3), device=d, **kw)[0]
                    for d in ("cpu", "cuda")]
            gap = max(abs(a - b) for pair in (full, lora) for a, b in zip(*pair))
            check(gap <= 1e-5, f"tiny {case} training: card losses {full[1]}, {lora[1]} against CPU {full[0]}, "
                               f"{lora[0]}")
            train[case] = dict(finetune=full[1], finetune_lora=lora[1], max_loss_gap=gap)
        os.remove(path)
    print("  tiny files, card against CPU, worst NMSE over the prefill and 3 steps: "
          + ", ".join(f"{k} {v:.1e}" for k, v in out.items()))
    print("  tiny training, card against CPU, largest loss gap over 2 steps of finetune and finetune_lora: "
          + ", ".join(f"{k} {v['max_loss_gap']:.1e}" for k, v in train.items()))
    return dict(forward=out, train=train)


def phase_dense_families(torch, np, tmp: str, card: str, deep: bool) -> list:
    """4v: (a)-(e) for each model at DV_MODELS' depth (deep: dv_depth's),
    then (f); returns the run records, each with its counts."""
    import importlib

    runs = []
    for name, (mod_name, fn, depth, most, _, _) in DV_MODELS.items():
        if deep:
            cfg = getattr(importlib.import_module(f"ggml_tpu_torch.models.{mod_name}"), fn)()
            depth = dv_depth(torch, cfg, tmp, most)
        stage(f"4v. {name} ({depth} of {most} layers) from a Q4_K GGUF file")
        runs.append(phase_dv_model(torch, np, name, tmp, card, depth))
    stage("4v (f). tiny gemma, gemma2, gemma3, phi2, phi3, gptneox and falcon files on the card against the CPU")
    runs.append(dict(tiny=phase_dv_tiny(torch, np, tmp), counts={}))
    return runs


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


# the whole run's depth of GPT-J-6B's synthesized planes (4a-4f, 4m-4o, 4r);
# --gptj runs them at all 28 layers, --serve, --spec and --train theirs too
GPTJ_LAYERS = 8
GPTJ_FILE_LAYERS = 4  # the whole run's depth of 4i-4k's GPT-J-6B files


def phase_gptj_synth(torch, np, card: str, n_layer: int) -> list:
    """4a-4c, 4e, 4f, 4m-4o and 4r over GPT-J-6B's synthesized planes at its
    published widths, cut to n_layer of its 28 layers; returns the runs."""
    from ggml_tpu_torch.dtypes import GGMLType
    from ggml_tpu_torch.models import gptj

    cfg = dataclasses.replace(gptj.random_config("6b"), n_layer=n_layer)
    synth = lambda t: gptj.synth_quantized_params(cfg, t, seed=0, dtype=torch.bfloat16, device="cuda")
    runs = []
    q4k_kernels = dict(decode="q4k_gemv_qact", rows="q4k_gemv_rows", matmul="q4k_matmul")
    stage(f"4a. GPT-J-6B Q4_K (synthesized compact planes, {n_layer} of its 28 layers), three greedy requests, then "
          "a 1024-token prompt")
    params = synth(GGMLType.Q4_K)
    runs.append(phase_gptj(torch, np, "q4_k", params, q4k_kernels, (8, 100, 1), profile=True, sampled=True))
    runs.append(phase_gptj(torch, np, "q4_k long", params, q4k_kernels, (1024,), profile=False, max_seq=2048,
                           long_decode_profile=1088))
    stage("4m. serving: GPT-J-6B Q4_K (the same planes), 8 slots, bench_serve's mix")
    runs.append(phase_serve_gptj(torch, np, params, card))
    runs += phase_serve_4n(torch, np, params, card).values()
    runs += phase_spec(torch, np, params, card).values()
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
    return runs


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

        if sys.argv[1:] == ["--spec"]:
            from ggml_tpu_torch.dtypes import GGMLType
            from ggml_tpu_torch.models import gptj, llama

            with tempfile.TemporaryDirectory(prefix="llama3-8b-gguf-") as tmp:
                path = write_llama3_8b_gguf(np, tmp)[0]
                t0 = time.perf_counter()
                model = llama.Llama.from_gguf(path, max_seq=2048, device="cuda")
                torch.cuda.synchronize()
                print(f"  Llama-3-8B loaded as planes in {time.perf_counter() - t0:.1f}s")
                stage("4r. speculative serving: Llama-3-8B, 4 slots, paged with the prefix cache, 2-layer self-draft")
                spec = dict(spec_llama=phase_spec_llama(torch, np, model, card))
                del model
            torch.cuda.empty_cache()
            params = gptj.synth_quantized_params(gptj.random_config("6b"), GGMLType.Q4_K, seed=0,
                                                 dtype=torch.bfloat16, device="cuda")
            spec.update(phase_spec(torch, np, params, card))
            del params
            print(json.dumps(dict(card=card, spec=spec)))
            print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                                     "count": torch.cuda.device_count()}}))
            return 0

        if sys.argv[1:] == ["--moe"]:
            import shutil

            with tempfile.TemporaryDirectory(prefix="qwen3-moe-gguf-") as tmp:
                # the deepest Qwen3-30B-A3B the card (about 1.22 GB a layer in
                # bf16 experts, 12 GB kept for the rest) and the disk (about
                # 0.4 GB of GGUF a layer) hold, at most its 48 layers
                card_gb = torch.cuda.mem_get_info()[1] / 1e9
                disk_gb = shutil.disk_usage(tmp).free / 1e9
                n_layer = max(1, min(MOE_QWEN_LAYERS_ALONE, int((card_gb - 12) / 1.25), int(disk_gb / 0.42) - 2))
                print(f"  card {card_gb:.1f} GB, free disk {disk_gb:.1f} GB: Qwen3-30B-A3B at {n_layer} of 48 layers")
                stage(f"4s. mixture of experts: bench_moe_decode's shape, Qwen3-30B-A3B ({n_layer} of 48 layers) "
                      "decode, prefill, the engine and LoRA, tiny MoE files")
                moe = phase_moe(torch, np, tmp, card, n_layer)
            print(json.dumps(dict(card=card, moe=moe), default=str))
            print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                                     "count": torch.cuda.device_count()}}))
            return 0

        if sys.argv[1:] == ["--deepseek"]:
            with tempfile.TemporaryDirectory(prefix="deepseek-gguf-") as tmp:
                stage(f"4t. DeepSeek: bench_mla_decode's shape, DeepSeek-V2-Lite (all {DS_LITE_LAYERS_ALONE} "
                      "layers), DeepSeek-V3's widths")
                ds = phase_deepseek(torch, np, tmp, card, DS_LITE_LAYERS_ALONE)
            print(json.dumps(dict(card=card, deepseek=ds), default=str))
            print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                                     "count": torch.cuda.device_count()}}))
            return 0

        if sys.argv[1:] == ["--moe-families"]:
            with tempfile.TemporaryDirectory(prefix="moe-families-gguf-") as tmp:
                mf = phase_moe_families(torch, np, tmp, card, deep=True)
            print(json.dumps(dict(card=card, moe_families=mf), default=str))
            print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                                     "count": torch.cuda.device_count()}}))
            return 0

        if sys.argv[1:] == ["--dense-families"]:
            with tempfile.TemporaryDirectory(prefix="dense-families-gguf-") as tmp:
                dv = phase_dense_families(torch, np, tmp, card, deep=True)
            print(json.dumps(dict(card=card, dense_families=dv), default=str))
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

        if sys.argv[1:] == ["--gptj"]:
            runs = phase_gptj_synth(torch, np, card, 28)
            print(json.dumps(dict(card=card, runs=runs)))
            print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                                     "count": torch.cuda.device_count()}}))
            return 0

        stage("3. kernels against their plain versions")
        flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
        kernel_results = phase_kernels(torch, F, qmatmul, decode_attn, flash_attn, flush)
        del flush

        runs = phase_gptj_synth(torch, np, card, GPTJ_LAYERS)
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
            # 4i, 4j and 4k at GPTJ_FILE_LAYERS of GPT-J's 28 layers in the
            # whole run, which the later phases would otherwise take past the
            # time limit (loading the 28-layer file three times and 4j's once
            # took 187 s of an earlier whole run; --front-end, --qlora and
            # --iquants run all 28)
            stage(f"4i. the text front end: GPT-J-6B ({GPTJ_FILE_LAYERS} of its 28 layers) from a Q4_K GGUF file, "
                  "the generate CLI, perplexity")
            written = write_gptj6b_gguf(np, tmp, n_layer=GPTJ_FILE_LAYERS)
            runs.append(phase_front_end(torch, np, written))
            stage(f"4j. QLoRA fine-tuning of GPT-J-6B ({GPTJ_FILE_LAYERS} layers) from the same file, batch 4 x 128, "
                  "rank 8")
            runs.append(phase_qlora(torch, np, written[0], tmp))
            os.remove(written[0])
            stage(f"4k. GPT-J-6B ({GPTJ_FILE_LAYERS} of its 28 layers) from IQ4_XS, IQ1_M and TQ2_0 GGUF files")
            runs += phase_iquants(torch, np, tmp, card, n_layer=GPTJ_FILE_LAYERS)
            stage(f"4l. Llama-3-8B ({LLAMA_LAYERS} of its 32 layers) from a Q4_K GGUF file (Q6_K head)")
            llama_run = phase_llama(torch, np, tmp, card, serve=True, train=True, n_layer=LLAMA_LAYERS)
            runs += [llama_run, llama_run.pop("serve"), llama_run.pop("serve_paged_chunked"), llama_run.pop("spec"),
                     llama_run.pop("qlora")]
        with tempfile.TemporaryDirectory(prefix="qwen3-moe-gguf-") as tmp:
            stage(f"4s. mixture of experts: bench_moe_decode's shape, Qwen3-30B-A3B ({MOE_QWEN_LAYERS} of 48 layers) "
                  "decode, prefill, the engine and LoRA, tiny MoE files")
            runs += phase_moe(torch, np, tmp, card, MOE_QWEN_LAYERS)
        with tempfile.TemporaryDirectory(prefix="deepseek-gguf-") as tmp:
            stage(f"4t. DeepSeek: bench_mla_decode's shape, DeepSeek-V2-Lite ({DS_LITE_LAYERS} of 27 layers), "
                  "DeepSeek-V3's widths")
            runs += phase_deepseek(torch, np, tmp, card, DS_LITE_LAYERS)
        with tempfile.TemporaryDirectory(prefix="moe-families-gguf-") as tmp:
            runs += phase_moe_families(torch, np, tmp, card, deep=False)
        with tempfile.TemporaryDirectory(prefix="dense-families-gguf-") as tmp:
            runs += phase_dense_families(torch, np, tmp, card, deep=False)
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1
    except Exception:
        traceback.print_exc()
        return 1

    stage(f"5. summary (the run so far: {time.perf_counter() - _START:.1f}s)")
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
    print(json.dumps(dict(card=card, runs=runs, tiny_reference=tiny), default=str))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
