"""Drive the PyTorch port (paddle_tpu_torch) on one NVIDIA card.

Run from the root of a checkout, on a machine with a CUDA card and the CUDA
toolkit:

    python3 chip_smoke.py

Phases, each printing one JSON line (any failure ends the script with a
non-zero exit):

1. build    - nvcc builds the CUDA kernels from paddle_tpu_torch/ops/csrc.
2. kernels  - each kernel against its plain PyTorch version on the card, at
              the serving path's shapes plus ragged and float32 cases, held
              to the elementwise bound OUT_TOL; at the serving shapes the
              bound must also reject a control (the plain version with the
              last key tile dropped). It reports the kernel's, the plain
              version's and one PyTorch library call's time
              (scaled_dot_product_attention, timed as a yardstick only), and
              the least time the card could take.
3. serve256 - the flagship Transformer (bench.py's config: vocab 8192, 4+4
              layers, 8 heads, d_model 512, d_ff 2048, bf16, random weights
              from a seed) built with is_test=True, pruned to its logits as
              save_inference_model prunes, answers 4 requests of batch 8 at
              seq 256 through Executor.run; each request must launch the
              one-pass kernel 12 times. One batch-1 request also runs on the
              CPU with the same weights, and the logits must agree.
4. serve4096 - the same weights at seq 4096 (bench.py's long-sequence
              config), batch 1; the request must launch the flash kernel 12
              times.
5. logits_control - the card-vs-CPU limits of phase 3 must reject the
              serving program with its decoder self-attention made
              non-causal.

Then it prints the card's name and power limit (nvidia-smi), one JSON line
with every kernel's numbers, and last {"ok": true, "device": {...}}. It
imports nothing of JAX or of the JAX package paddle_tpu.
"""
import json
import subprocess
import sys
import time

SEED = 1234
LONG_SEQ = 4096
REQUESTS, BATCH = 4, 8

# H100 SXM published dense peaks (NVIDIA data sheet)
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

# Kernel vs plain version on the same inputs, elementwise:
#     |got - want| <= rtol * |want| + atol * rms(want's row)
# where a row is one (batch, token, head)'s D outputs. bfloat16: the two
# round the same f32 sum to bf16 once, after different summation orders, so
# an element may differ by one ulp, at most 2^-7 of it. P's rounding to bf16
# (in the flash kernel per k-tile against the running max, in the plain
# version once against the row max) moves a row's f32 sums by about
# 2^-8 / sqrt(3) * sqrt(sum_j (p_j v_j)^2), which is 2^-8 / sqrt(3) times
# the row's rms; atol allows 2^-5, eight times 2^-8, for the largest of
# millions of such errors. float32 differs by summation order only.
OUT_TOL = {"bfloat16": (2.0 ** -7, 2.0 ** -5), "float32": (1e-5, 1e-5)}
# lse (f32, O(log T_k)): rtol and an absolute atol
LSE_TOL = (1e-5, 1e-5)
# A control the bound must reject: the kernel's output against the plain
# version with the last 64-key tile dropped.
CONTROL_DROP_KEYS = 64
# Card vs CPU logits of the bf16 model (same weights, same request): the two
# devices round bf16 products and sums in different orders through 8
# layers. The limits sit between the sound reading (0.0090 relative error,
# 0.973 top-1 agreement) and that of a faulty program, the decoder's
# self-attention made non-causal (0.270, 0.469), which phase logits_control
# must reject. Both readings: NVIDIA H100 80GB HBM3, 700 W (PERF.md).
LOGITS_REL_ERR_MAX = 0.03
TOP1_AGREE_MIN = 0.93


def emit(obj):
    print(json.dumps(obj), flush=True)


def time_ms(fn, iters=20, warmup=3):
    """Mean device time of fn() over `iters` back-to-back calls (CUDA
    events)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def attention_bound_ms(b, t_q, t_k, h, d, causal, itemsize, with_lse):
    """Least time for one call: the larger of its bytes (q, k, v read once,
    out and lse written once) over the memory rate and its operations
    (4*D per unmasked (row, col) pair) over the peak for its type."""
    offset = t_k - t_q
    if causal:
        pairs = sum(min(t_k, max(0, r + offset + 1)) for r in range(t_q))
    else:
        pairs = t_q * t_k
    flops = 4.0 * b * h * d * pairs
    nbytes = itemsize * b * h * d * (2 * t_q + 2 * t_k) + \
        (4 * b * t_q * h if with_lse else 0)
    peak = PEAK_BF16_FLOPS if itemsize == 2 else PEAK_F32_FLOPS
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def phase_build():
    from paddle_tpu_torch.ops import _build
    t0 = time.perf_counter()
    logs = _build.build_all()
    seconds = time.perf_counter() - t0
    for name, log in logs.items():
        with open(log) as f:
            for line in f:
                if "registers" in line or "spill" in line or "error" in line:
                    print("%s: %s" % (name, line.rstrip()), file=sys.stderr)
    emit({"phase": "build", "ok": True, "seconds": seconds,
          "libraries": sorted(logs)})


def _qkv(gen, b, t_q, t_k, h, d, dtype):
    import torch
    mk = lambda t: torch.randn(b, t, h, d, generator=gen, device="cuda",
                               dtype=torch.float32).to(dtype)
    return mk(t_q), mk(t_k), mk(t_k)


def _sdpa(q, k, v, causal):
    """PyTorch's fused attention on the same [B, T, H, D] tensors (the
    yardstick; the port never calls it)."""
    import torch
    import torch.nn.functional as F
    tr = lambda x: x.transpose(1, 2)
    t_q, t_k = q.shape[1], k.shape[1]
    if causal and t_q != t_k:
        mask = torch.ones(t_q, t_k, dtype=torch.bool,
                          device=q.device).tril(diagonal=t_k - t_q)
        return lambda: F.scaled_dot_product_attention(tr(q), tr(k), tr(v),
                                                      attn_mask=mask)
    return lambda: F.scaled_dot_product_attention(tr(q), tr(k), tr(v),
                                                  is_causal=causal)


# (kernel, B, T_q, T_k, H, D, causal, dtype, weight on the serving path)
KERNEL_CASES = [
    ("onepass", 8, 256, 256, 8, 64, False, "bfloat16", 8),
    ("onepass", 8, 256, 256, 8, 64, True, "bfloat16", 4),
    ("onepass", 8, 200, 256, 8, 64, True, "bfloat16", 0),
    ("onepass", 2, 77, 77, 2, 40, True, "float32", 0),
    ("onepass", 1, 130, 100, 2, 128, True, "float32", 0),
    ("onepass", 1, 512, 512, 4, 128, True, "bfloat16", 0),  # largest tile
    ("flash", 1, 4096, 4096, 8, 64, False, "bfloat16", 8),
    ("flash", 1, 4096, 4096, 8, 64, True, "bfloat16", 4),
    ("flash", 1, 1100, 1100, 8, 64, True, "bfloat16", 0),
    ("flash", 1, 1030, 1100, 2, 128, False, "float32", 0),
    ("flash", 1, 130, 100, 2, 40, True, "float32", 0),
    ("flash", 2, 1000, 1100, 2, 64, True, "bfloat16", 0),
]
# shapes each kernel must refuse with an exception: (kernel, T_k, D)
REJECT_CASES = [("onepass", 513, 64), ("onepass", 256, 136),
                ("flash", 1024, 12)]


def err_ratio(got, want, rtol, atol, row_scale=True):
    """max over elements of |got - want| / (rtol*|want| + atol*scale), where
    scale is the rms of want's last dim (row_scale) or 1; <= 1 passes."""
    got, want = got.float(), want.float()
    scale = want.pow(2).mean(-1, keepdim=True).sqrt() if row_scale else 1.0
    return ((got - want).abs() / (rtol * want.abs() + atol * scale)).max().item()


def phase_kernels():
    import torch
    from paddle_tpu_torch.ops import attention as A
    wrappers = {"onepass": (A.onepass_attention_fwd_bthd,
                            A.onepass_attention_fwd_plain),
                "flash": (A.flash_attention_fwd_bthd,
                          A.flash_attention_fwd_plain)}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    timed = ("kernel_ms", "plain_ms", "library_ms", "bound_ms")
    # per kernel: weighted sums over the serving mix, and the bf16 max error
    summary = {k: dict(dict.fromkeys(timed + ("weight", "ops_bound_ms"), 0.0),
                       max_abs_err=0.0) for k in wrappers}
    failed = []
    for kernel, b, t_q, t_k, h, d, causal, dtype, weight in KERNEL_CASES:
        tdtype = getattr(torch, dtype)
        q, k, v = _qkv(gen, b, t_q, t_k, h, d, tdtype)
        fn, plain = wrappers[kernel]
        launches0 = fn.launches
        got, want = fn(q, k, v, causal), plain(q, k, v, causal)
        torch.cuda.synchronize()
        rec = {"phase": "kernels", "kernel": kernel,
               "shape": [b, t_q, t_k, h, d], "causal": causal,
               "dtype": dtype, "tol": OUT_TOL[dtype]}
        if kernel == "flash":
            (got, got_lse), (want, want_lse) = got, want
            rec["lse_err_ratio"] = err_ratio(got_lse, want_lse, *LSE_TOL,
                                             row_scale=False)
            rec["lse_max_abs_err"] = (got_lse - want_lse).abs().max().item()
        rec["launches"] = fn.launches - launches0
        rec["err_ratio"] = err_ratio(got, want, *OUT_TOL[dtype])
        rec["max_abs_err"] = (got.float() - want.float()).abs().max().item()
        rec["ok"] = rec["err_ratio"] <= 1 and \
            rec.get("lse_err_ratio", 0.0) <= 1 and \
            bool(torch.isfinite(got.float()).all())
        s = summary[kernel]
        if weight:
            drop = slice(0, t_k - CONTROL_DROP_KEYS)
            wrong = plain(q, k[:, drop].contiguous(), v[:, drop].contiguous(),
                          causal)
            wrong = wrong[0] if kernel == "flash" else wrong
            rec["control_err_ratio"] = err_ratio(got, wrong, *OUT_TOL[dtype])
            rec["ok"] = rec["ok"] and rec["control_err_ratio"] > 1
            bound, by = attention_bound_ms(b, t_q, t_k, h, d, causal,
                                           q.element_size(), kernel == "flash")
            rec.update(kernel_ms=time_ms(lambda: fn(q, k, v, causal)),
                       plain_ms=time_ms(lambda: plain(q, k, v, causal), iters=5),
                       library_ms=time_ms(_sdpa(q, k, v, causal)),
                       bound_ms=bound, bound_by=by)
            s["weight"] += weight
            for key in timed:
                s[key] += weight * rec[key]
            if by == "operations":
                s["ops_bound_ms"] += weight * bound
        if dtype == "bfloat16":
            s["max_abs_err"] = max(s["max_abs_err"], rec["max_abs_err"])
        emit(rec)
        if not rec["ok"]:
            failed.append(rec)
        del q, k, v, got, want
    for kernel, t_k, d in REJECT_CASES:
        q, k, v = _qkv(gen, 1, 16, t_k, 2, d, torch.bfloat16)
        try:
            wrappers[kernel][0](q, k, v)
        except ValueError as e:
            emit({"phase": "kernels", "kernel": kernel, "rejects":
                  [1, 16, t_k, 2, d], "error": str(e), "ok": True})
        else:
            raise AssertionError("%s accepted T_k=%d D=%d" % (kernel, t_k, d))
    if failed:
        raise AssertionError("kernels disagree with their plain versions (or "
                             "the bound misses the control): %r" % failed)
    return summary


def _request(transformer, batch, seq_len, seed):
    b = transformer.synthetic_batch(batch, seq_len,
                                    transformer.FLAGSHIP_CFG["tgt_vocab"], seed)
    return {"src_ids": b["src_ids"], "tgt_ids": b["tgt_ids"]}


def _logits_agreement(card, cpu):
    """(max |card - cpu| / max |cpu|, share of rows with the same top-1)."""
    rel_err = float(abs(card - cpu).max() / abs(cpu).max())
    top1 = float((card.argmax(-1) == cpu.argmax(-1)).mean())
    return rel_err, top1


def phase_serve256(fluid, transformer, A, exe, scope):
    """Returns what phase logits_control needs: (serving program, the
    batch-1 feed, the logits name, the CPU's logits)."""
    import torch
    cfg = transformer.FLAGSHIP_CFG
    attn = 3 * cfg["n_layer"]       # enc self, dec causal self, cross
    serve, startup, logits = transformer.serving_programs(SEED, **cfg)
    exe.run(startup, scope=scope)
    seconds = []
    for i in range(REQUESTS):
        feed = _request(transformer, BATCH, 256, SEED + i)
        before = (A.onepass_attention_fwd_bthd.launches,
                  A.flash_attention_fwd_bthd.launches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, = exe.run(serve, feed=feed, fetch_list=[logits], scope=scope,
                       return_numpy=False)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        launched = (A.onepass_attention_fwd_bthd.launches - before[0],
                    A.flash_attention_fwd_bthd.launches - before[1])
        if tuple(out.shape) != (BATCH, 256, cfg["tgt_vocab"]) or \
                not bool(torch.isfinite(out.float()).all()):
            raise AssertionError("request %d: bad logits %s" % (i, out.shape))
        if launched != (attn, 0):
            raise AssertionError("request %d launched (one-pass, flash) = %s, "
                                 "want (%d, 0)" % (i, launched, attn))

    # one batch-1 request on the card and on the CPU, same weights
    feed = _request(transformer, 1, 256, SEED + 100)
    card, = exe.run(serve, feed=feed, fetch_list=[logits], scope=scope)
    cpu_scope = fluid.Scope()
    for p in serve.all_parameters():
        cpu_scope.set(p.name, scope.get(p.name).cpu())
    cpu, = fluid.Executor(fluid.CPUPlace()).run(
        serve, feed=feed, fetch_list=[logits], scope=cpu_scope)
    rel_err, top1 = _logits_agreement(card, cpu)
    ok = rel_err <= LOGITS_REL_ERR_MAX and top1 >= TOP1_AGREE_MIN
    # the first request pays one-time costs (allocator growth, cuBLAS
    # handles); the steady rate is over the others
    emit({"phase": "serve256", "ok": ok, "requests": REQUESTS,
          "batch": BATCH, "seq_len": 256, "request_seconds": seconds,
          "tokens_per_s": BATCH * 256 * (REQUESTS - 1) / sum(seconds[1:]),
          "onepass_launches_per_request": attn,
          "card_vs_cpu_logits_rel_err": rel_err,
          "rel_err_max": LOGITS_REL_ERR_MAX, "top1_agreement": top1,
          "top1_min": TOP1_AGREE_MIN})
    if not ok:
        raise AssertionError("card and CPU logits disagree")
    return serve, feed, logits, cpu


def phase_serve4096(fluid, transformer, A, exe, scope):
    import torch
    cfg = dict(transformer.FLAGSHIP_CFG, seq_len=LONG_SEQ)
    attn = 3 * cfg["n_layer"]
    serve, _, logits = transformer.serving_programs(SEED, **cfg)
    feed = _request(transformer, 1, LONG_SEQ, SEED + 200)
    exe.run(serve, feed=feed, fetch_list=[logits], scope=scope,
            return_numpy=False)                      # warm: allocator growth
    before = (A.onepass_attention_fwd_bthd.launches,
              A.flash_attention_fwd_bthd.launches)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, = exe.run(serve, feed=feed, fetch_list=[logits], scope=scope,
                   return_numpy=False)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launched = (A.onepass_attention_fwd_bthd.launches - before[0],
                A.flash_attention_fwd_bthd.launches - before[1])
    ok = tuple(out.shape) == (1, LONG_SEQ, cfg["tgt_vocab"]) and \
        bool(torch.isfinite(out.float()).all()) and launched == (0, attn)
    emit({"phase": "serve4096", "ok": ok, "batch": 1, "seq_len": LONG_SEQ,
          "request_seconds": seconds, "tokens_per_s": LONG_SEQ / seconds,
          "launches": {"onepass": launched[0], "flash": launched[1]},
          "peak_memory_bytes": torch.cuda.max_memory_allocated()})
    if not ok:
        raise AssertionError("long request failed: launches %s" % (launched,))


def phase_logits_control(exe, scope, serve, feed, logits, cpu):
    """The card-vs-CPU limits must reject a faulty path: the serving program
    with its decoder self-attention made non-causal, run on the card,
    against the sound program's CPU logits."""
    faulty = serve.clone(for_test=True)
    flipped = 0
    for op in faulty.global_block().ops:
        if op.type == "fused_attention" and op.attr("causal"):
            op.attrs["causal"] = False
            flipped += 1
    card, = exe.run(faulty, feed=feed, fetch_list=[logits], scope=scope)
    rel_err, top1 = _logits_agreement(card, cpu)
    caught = rel_err > LOGITS_REL_ERR_MAX or top1 < TOP1_AGREE_MIN
    emit({"phase": "logits_control", "ok": caught,
          "fault": "decoder self-attention not causal",
          "ops_changed": flipped, "card_vs_cpu_logits_rel_err": rel_err,
          "top1_agreement": top1})
    if not caught:
        raise AssertionError("the logits limits pass a faulty program")


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    try:
        import paddle_tpu_torch.fluid as fluid
        from paddle_tpu_torch.models import transformer
        from paddle_tpu_torch.ops import attention as A
    except ImportError as e:
        print("chip_smoke: run from the root of a checkout (%s)" % e,
              file=sys.stderr)
        return 2

    phase_build()
    summary = phase_kernels()

    exe, scope = fluid.Executor(), fluid.Scope()   # CUDAPlace(0)
    A.onepass_attention_fwd_bthd.launches = 0
    A.flash_attention_fwd_bthd.launches = 0
    check = phase_serve256(fluid, transformer, A, exe, scope)
    phase_serve4096(fluid, transformer, A, exe, scope)
    launches = {"onepass": A.onepass_attention_fwd_bthd.launches,
                "flash": A.flash_attention_fwd_bthd.launches}
    phase_logits_control(exe, scope, *check)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
          else "nvidia-smi: %s" % smi.stderr.strip())
    replaces = {"onepass": "paddle_tpu/ops/attention.py:123",
                "flash": "paddle_tpu/ops/attention.py:272"}
    kernels = []
    for name in ("onepass", "flash"):
        s = summary[name]
        w = s["weight"]
        kernels.append({
            "name": name + "_attention_fwd_bthd", "route": "cuda",
            "source": "paddle_tpu_torch/ops/csrc/attention.cu",
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": s["max_abs_err"], "ms": s["kernel_ms"] / w,
            "plain_ms": s["plain_ms"] / w, "bound_ms": s["bound_ms"] / w,
            "bound_by": "operations" if 2 * s["ops_bound_ms"] >= s["bound_ms"]
            else "bytes",
            "library_ms": s["library_ms"] / w})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
