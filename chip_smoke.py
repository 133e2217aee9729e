#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ggml_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero without the result line):
1. the card, as nvidia-smi reports its name and power limit;
2. build the kernels from ggml_tpu_torch/kernels/csrc with nvcc (sm_90a);
3. hold each kernel against its plain PyTorch version on the card at the
   GPT-J-6B shapes of the main paths, and time kernel, plain version and one
   library call computing the same function (a yardstick only; the port
   never calls it), beside the least time the card could take (bound);
4. serve greedy requests through GPT-J-6B at its published widths
   (EleutherAI/gpt-j-6b: n_vocab 50400, E 4096, 16 heads, 28 layers, n_rot
   64), counting every kernel launch of each run: (a) synthesized compact
   Q4_K planes, (b) synthesized Q8_0 planes, three requests each, (c) compact
   Q6_K planes repacked from random blocks, one request; then hold a tiny
   GPT-J on the card against the same model on the CPU for a Q4_K, a Q8_0
   and a mixed Q4_K/Q6_K parameter set;
5. one JSON line listing every kernel, then the result line.

Runs only where torch.cuda.is_available(); it imports nothing of JAX.
"""

from __future__ import annotations

import copy
import json
import subprocess
import sys
import time
import traceback

HBM_BYTES_PER_S = 3.35e12  # H100 SXM (NVIDIA data sheet)
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}
FLUSH_BYTES = 128 << 20  # written between timed launches: evicts the 50 MB L2
PLAIN = {"q4k_gemv_qact": "_gemv_qact_plain", "q4k_gemv_rows": "_gemv_rows_plain",
         "q4k_matmul": "_matmul_plain", "q8_gemv": "_q8_gemv_plain", "q8_gemv_sb": "_q8_gemv_plain",
         "q8_matmul": "_q8_matmul_plain"}
SOURCES = {
    "q4k_gemv_qact": ("ggml_tpu_torch/kernels/csrc/q4k_gemv.cu", "ggml_tpu/kernels/qmatmul.py:523"),
    "q4k_gemv_rows": ("ggml_tpu_torch/kernels/csrc/q4k_gemv.cu", "ggml_tpu/kernels/qmatmul.py:446"),
    "q4k_matmul": ("ggml_tpu_torch/kernels/csrc/q4k_matmul.cu", "ggml_tpu/kernels/qmatmul.py:79"),
    "decode_attn": ("ggml_tpu_torch/kernels/csrc/decode_attn.cu", "ggml_tpu/kernels/decode_attn.py:37"),
    "q8_gemv": ("ggml_tpu_torch/kernels/csrc/q8_gemv.cu", "ggml_tpu/kernels/qmatmul.py:189"),
    "q8_gemv_sb": ("ggml_tpu_torch/kernels/csrc/q8_gemv.cu", "ggml_tpu/kernels/qmatmul.py:645"),
    "q8_matmul": ("ggml_tpu_torch/kernels/csrc/q8_matmul.cu", "ggml_tpu/kernels/qmatmul.py:133"),
}
# NMSE of a kernel against its plain version on the card: the int8 kernels
# differ only in the order of their f32 sums, the matmuls in the order of
# their bf16 products too
GATE = {"q4k_gemv_qact": 1e-6, "q4k_gemv_rows": 1e-6, "q4k_matmul": 1e-5, "decode_attn": 1e-6,
        "q8_gemv": 1e-9, "q8_gemv_sb": 1e-9, "q8_matmul": 1e-8}


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str):
    if not cond:
        raise SmokeFailure(msg)


def errors(ref, got):
    ref, got = ref.double(), got.double()
    return (float(((ref - got) ** 2).sum() / (ref * ref).sum()),
            float((ref - got).abs().max()))


def device_ms(torch, fn, flush, iters: int) -> float:
    """Device time of one call of fn, with L2 flushed before each call.  A
    sleep kernel holds the GPU while the host queues every call, so host
    launch overhead is not in the window; the flushes are timed alone and
    subtracted."""
    fn()
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

    both = window(lambda: (flush.zero_(), fn()))
    alone = window(flush.zero_)
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
    as repack builds them."""
    from ggml_tpu_torch.dtypes import GGMLType
    from ggml_tpu_torch.quant.planar import PlanarWeight

    kw = dict(device="cuda", generator=gen)
    g = 16 if fmt.startswith("q6_k") else 32
    small = lambda rows, dt: ((torch.rand((rows, npad), **kw) + 0.5) * 1e-3).to(dt)
    codes = lambda lo, hi, rows: torch.randint(lo, hi, (rows, npad), dtype=torch.int8, **kw)
    if fmt == "q6_k":
        return PlanarWeight(kind="q8", codes=codes(-32, 32, k), scales=codes(-128, 128, k // 16), offsets=None,
                            group=16, n=n, k=k, orig_type=GGMLType.Q6_K, sb=16,
                            supers=(small(k // 256, torch.float32), None))
    if fmt == "q5_k":
        return PlanarWeight(kind="q8", codes=codes(0, 32, k), scales=codes(0, 64, k // 32),
                            offsets=codes(0, 64, k // 32), group=32, n=n, k=k, orig_type=GGMLType.Q5_K, sb=8,
                            supers=(small(k // 256, torch.float32), small(k // 256, torch.float32)))
    orig, dt, affine = {"q8_0": (GGMLType.Q8_0, torch.bfloat16, False),
                        "q6_k_synth": (GGMLType.Q6_K, torch.bfloat16, False),
                        "q5_1": (GGMLType.Q5_1, torch.float32, True),
                        "q5_k_synth": (GGMLType.Q5_K, torch.bfloat16, True)}[fmt]
    return PlanarWeight(kind="q8", codes=codes(-128, 128, k), scales=small(k // g, dt),
                        offsets=-8 * small(k // g, dt) if affine else None, group=g, n=n, k=k, orig_type=orig)


def phase_kernels(torch, F, qmatmul, decode_attn, flush):
    """Each kernel against its plain version at the main path's shapes."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1234)
    results = {name: [] for name in SOURCES}

    def record(name, r):
        results[name].append(r)
        print(f"  {name:14s} {r['shape']:44s} nmse={r['nmse']:.2e} max_abs={r['max_abs_err']:.2e} "
              f"kernel={r['ms'] * 1e3:.1f}us plain={r['plain_ms'] * 1e3:.1f}us "
              f"library={r['library_ms'] * 1e3:.1f}us bound={r['bound_ms'] * 1e3:.1f}us ({r['bound_by']})")
        check(r["nmse"] <= GATE[name], f"{name} {r['shape']}: NMSE {r['nmse']:.3e} > {GATE[name]:g}")

    def gemv_case(name, m, k, n, npad, d_dtype=torch.bfloat16, fmt=None):
        if fmt is None:
            pw, label = random_planes(torch, n, k, npad, d_dtype, gen), f"d={str(d_dtype)[6:]}"
        else:
            pw, label = random_q8_planes(torch, n, k, npad, fmt, gen), fmt
        x = torch.randn((m, k), device="cuda", generator=gen).to(torch.bfloat16)
        wrapper = getattr(qmatmul, name)
        plain = getattr(qmatmul, PLAIN[name])
        plain_fn = ((lambda: plain(x, pw, qmatmul._sb_gemv_k_tile(k // 2, 32, 8)))
                    if name == "q4k_gemv_qact" else (lambda: plain(x, pw)))
        got = wrapper(x, pw)
        torch.cuda.synchronize()
        nmse, mae = errors(plain_fn(), got)
        w = qmatmul.planar_dequant(pw, torch.bfloat16)
        plane = pw.plane_bytes()
        moved = plane + x.numel() * 2 + m * npad * 4
        ops = 2 * m * k * npad
        kind = "bf16" if name.endswith("matmul") else "int8"
        t_bytes, t_ops = moved / HBM_BYTES_PER_S * 1e3, ops / PEAK_OPS[kind] * 1e3
        rec = dict(shape=f"M={m} K={k} N={n} Npad={npad} {label}", nmse=nmse, max_abs_err=mae,
                   ms=device_ms(torch, lambda: wrapper(x, pw), flush, 50),
                   plain_ms=device_ms(torch, plain_fn, flush, 5),
                   library_ms=device_ms(torch, lambda: torch.matmul(x, w), flush, 20),
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

    hq = hkv = 16
    d, s = 256, 256
    for pos in (0, 100, 255):
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


def launch_counts(qmatmul, decode_attn) -> dict:
    return {**qmatmul.launches, **decode_attn.launches}


def reset_launches(qmatmul, decode_attn):
    for table in (qmatmul.launches, decode_attn.launches):
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


def phase_gptj(torch, np, qmatmul, decode_attn, label: str, params: dict, kernels: dict, prompts, profile: bool):
    """GPT-J-6B at published widths over `params`: one greedy request of 64
    tokens per prompt length, every launch counted.  kernels names the
    wrapper each step must go through: "decode" (M=1), "rows" (2..32-token
    prefill), "matmul" (longer prefill)."""
    from ggml_tpu_torch.models import gptj
    from ggml_tpu_torch.quant.planar import PlanarWeight

    cfg = gptj.random_config("6b")
    plane_bytes = sum(v.plane_bytes() for v in params.values() if isinstance(v, PlanarWeight))
    print(f"  {label}: {plane_bytes / 1e9:.3f} GB of planes read per decode token, bound at "
          f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s: {plane_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms/token")
    model = gptj.GPTJ(params, cfg, max_seq=256, device="cuda")
    for t in prompts:  # warm-up of each path: first-use allocations and library handles
        model.generate(np.arange(t)[None], 4)
    torch.cuda.synchronize()

    n_gen, per_layer = 64, 3
    layers = cfg.n_layer
    rng = np.random.default_rng(0)
    reset_launches(qmatmul, decode_attn)
    requests = []
    for t in prompts:
        before = launch_counts(qmatmul, decode_attn)
        prompt = rng.integers(0, cfg.n_vocab, (1, t))
        cache = model.new_cache(torch.bfloat16)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache, n_past = model.prefill(cache, prompt)
        first = torch.argmax(logits, dim=-1, keepdim=True)
        finite = bool(torch.isfinite(logits).all())
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        cache, ids = model.decode_greedy(cache, first, n_past, n_gen - 1)
        t2 = time.perf_counter()
        after = launch_counts(qmatmul, decode_attn)
        delta = {k: after[k] - before[k] for k in after}
        steps = n_gen - 1 + (1 if t == 1 else 0)  # a 1-token prompt is a decode step too
        want = {k: 0 for k in delta}
        want[kernels["decode"]] = (per_layer * layers + 1) * steps
        want["decode_attn"] = layers * steps
        if t > 1:
            want[kernels["rows" if t <= 32 else "matmul"]] += per_layer * layers + 1
        toks = [int(first[0, 0])] + ids[:, 0].tolist()
        check(finite, f"{label}, prompt {t}: prefill logits not finite")
        check(len(toks) == n_gen and all(0 <= x < cfg.n_vocab for x in toks), f"{label}, prompt {t}: tokens {toks}")
        check(delta == want, f"{label}, prompt {t}: launches {delta}, want {want}")
        dec_ms = (t2 - t1) * 1e3 / (n_gen - 1)
        req = dict(model=label, prompt=t, prefill_ms=(t1 - t0) * 1e3, decode_ms_per_token=dec_ms,
                   decode_tok_per_s=1e3 / dec_ms, plane_gb_per_s=plane_bytes / (dec_ms * 1e-3) / 1e9,
                   launches=delta, first_tokens=toks[:8])
        requests.append(req)
        print(f"  request prompt={t:3d}: prefill {req['prefill_ms']:.1f} ms, decode "
              f"{dec_ms:.2f} ms/token ({req['decode_tok_per_s']:.1f} tok/s, "
              f"{req['plane_gb_per_s']:.0f} GB/s of planes), launches {delta}")
    counts = launch_counts(qmatmul, decode_attn)
    for name in {*kernels.values(), "decode_attn"}:
        check(counts[name] > 0, f"{label}: {name} was never launched on its main path")
    trace = profile_decode(torch, np, model) if profile else None
    return dict(counts=counts, requests=requests, plane_bytes=plane_bytes, decode_trace=trace)


def profile_decode(torch, np, model, steps: int = 8) -> dict:
    """Device time per decode token by kernel, from a torch.profiler trace of
    `steps` decode steps after an 8-token prompt (the launch counters are read
    before this, so these launches are not counted as the main path's)."""
    from torch.profiler import ProfilerActivity, profile

    cache = model.new_cache(torch.bfloat16)
    logits, cache, n_past = model.prefill(cache, np.arange(8)[None])
    first = torch.argmax(logits, dim=-1, keepdim=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        model.decode_greedy(cache, first, n_past, steps)
        torch.cuda.synchronize()
    # device-side events only (kernels, copies, fills): the ops that launch
    # them carry the same time again as their own "device time"
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    total_us = sum(e.self_device_time_total for e in events)
    ours = {name: sum(e.self_device_time_total for e in events if name in e.key)
            for name in ("q4k_gemv_kernel", "q8_gemv_kernel", "quant_segments", "decode_attn_kernel")}
    ours = {k: v for k, v in ours.items() if v}
    launches = sum(e.count for e in prof.key_averages() if e.key == "cudaLaunchKernel")
    trace = dict(steps=steps, device_ms_per_token=total_us / steps / 1e3,
                 launches_per_token=launches / steps,
                 port_kernels_ms_per_token={k: v / steps / 1e3 for k, v in ours.items()},
                 other_device_ms_per_token=(total_us - sum(ours.values())) / steps / 1e3)
    print(f"  profiled {steps} decode steps: device busy {trace['device_ms_per_token']:.3f} ms/token, "
          f"{trace['launches_per_token']:.0f} kernel launches/token; port kernels "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in trace["port_kernels_ms_per_token"].items())
          + f"; other ops {trace['other_device_ms_per_token']:.3f} ms")
    return trace


def phase_tiny_reference(torch, np):
    """A tiny GPT-J on the card (kernels) against the same weights on the CPU
    (plain versions), fed the same tokens, for three parameter sets:
    synthesized Q4_K, synthesized Q8_0, and Q4_K with Q6_K ffn_down and
    output.weight (compact planes repacked from random blocks).  Prefill of
    40 tokens has no int8 activations: NMSE <= 1e-5 (bf16 product order).
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
    out = {}
    for label, cpu_params in (("q4_k", synth(GGMLType.Q4_K)), ("q8_0", synth(GGMLType.Q8_0)),
                              ("q4_k+q6_k", mixed)):
        # Module.to moves in place: copy the planar weights before moving them
        gpu_params = {k: copy.deepcopy(v).to("cuda") for k, v in cpu_params.items()}
        for t, gate in ((40, 1e-5), (5, 5e-4)):
            prompt = torch.from_numpy(np.random.default_rng(t).integers(0, 512, (1, t)))
            runs = []
            for params, dev in ((cpu_params, "cpu"), (gpu_params, "cuda")):
                cache = gptj.init_cache(cfg, 1, 64, torch.bfloat16, dev)
                zero = torch.zeros((), dtype=torch.int32, device=dev)
                runs.append([gptj.forward(params, cfg, prompt.to(dev), zero.expand(1), cache, zero,
                                          prefill=True)[:, -1].cpu(), cache, dev])
            nm, _ = errors(runs[0][0], runs[1][0])
            check(nm <= gate, f"tiny GPT-J {label}, prefill {t}: card vs CPU NMSE {nm:.2e} > {gate:g}")
            worst = 0.0
            tok = int(torch.argmax(runs[0][0]))
            for step in range(8):
                step_logits = []
                for params, (_, cache, dev) in zip((cpu_params, gpu_params), runs):
                    pos = torch.tensor(t + step, dtype=torch.int32, device=dev)
                    step_logits.append(gptj.forward(params, cfg, torch.tensor([[tok]], device=dev),
                                                    pos.expand(1), cache, pos)[0, -1].cpu())
                nm_step, _ = errors(*step_logits)
                worst = max(worst, nm_step)
                tok = int(torch.argmax(step_logits[0]))
            check(worst <= 5e-4, f"tiny GPT-J {label}, decode after {t}: card vs CPU NMSE {worst:.2e} > 5e-4")
            out[f"{label}/{t}"] = dict(prefill_nmse=nm, decode_worst_nmse=worst)
            print(f"  tiny GPT-J {label}, prompt {t}: prefill NMSE {nm:.2e}, 8 decode steps worst NMSE {worst:.2e}")
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
        from ggml_tpu_torch.kernels import _build, decode_attn, qmatmul
    except ImportError as e:
        print(f"chip_smoke: the ggml_tpu_torch package is not here ({e})", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False  # dense f32 products in full f32
    torch.backends.cudnn.allow_tf32 = False

    try:
        print("== 1. card")
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
        check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
        card = smi.stdout.strip().splitlines()[0]
        print(card)
        print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

        print("== 2. build")
        t0 = time.perf_counter()
        _build.lib()
        print(f"  kernels built and loaded in {time.perf_counter() - t0:.1f}s")
        for line in _build.build_log.splitlines():
            if "registers" in line or "spill" in line or line.startswith("=="):
                print("  " + line.strip())

        print("== 3. kernels against their plain versions")
        flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
        kernel_results = phase_kernels(torch, F, qmatmul, decode_attn, flush)
        del flush

        from ggml_tpu_torch.dtypes import GGMLType
        from ggml_tpu_torch.models import gptj

        cfg = gptj.random_config("6b")
        synth = lambda t: gptj.synth_quantized_params(cfg, t, seed=0, dtype=torch.bfloat16, device="cuda")
        runs = []
        print("== 4a. GPT-J-6B Q4_K (synthesized compact planes), three greedy requests")
        params = synth(GGMLType.Q4_K)
        runs.append(phase_gptj(torch, np, qmatmul, decode_attn, "q4_k", params, dict(
            decode="q4k_gemv_qact", rows="q4k_gemv_rows", matmul="q4k_matmul"), (8, 100, 1), profile=True))
        del params
        torch.cuda.empty_cache()
        print("== 4b. GPT-J-6B Q8_0 (synthesized int8 planes), three greedy requests")
        params = synth(GGMLType.Q8_0)
        runs.append(phase_gptj(torch, np, qmatmul, decode_attn, "q8_0", params, dict(
            decode="q8_gemv", rows="q8_gemv", matmul="q8_matmul"), (8, 100, 1), profile=True))
        print("== 4c. GPT-J-6B Q6_K (compact planes repacked from random blocks), one greedy request")
        t0 = time.perf_counter()
        params = q6k_planes_like(torch, np, params)
        torch.cuda.synchronize()
        print(f"  repacked and tiled in {time.perf_counter() - t0:.1f}s")
        runs.append(phase_gptj(torch, np, qmatmul, decode_attn, "q6_k", params, dict(
            decode="q8_gemv_sb", rows="q8_gemv_sb"), (8,), profile=False))
        del params
        torch.cuda.empty_cache()
        print("== 4d. tiny GPT-J on the card against the CPU")
        tiny = phase_tiny_reference(torch, np)
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1
    except Exception:
        traceback.print_exc()
        return 1

    print("== 5. summary")
    kernels = []
    for name, recs in kernel_results.items():
        # the shape the main path spends most time in: the widest GEMV, the longest window
        main_rec = recs[-1] if name == "decode_attn" else recs[0]
        kernels.append(dict(
            name=name, route="cuda", source=SOURCES[name][0], replaces=SOURCES[name][1],
            launches=sum(r["counts"][name] for r in runs), max_abs_err=max(r["max_abs_err"] for r in recs),
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
