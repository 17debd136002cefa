"""Check and time the port's attention kernels alone on one card.

Run from the root of a checkout, on a machine with a CUDA card and the CUDA
toolkit:

    python3 tools/torch_attention_probe.py            # forward and backward
    python3 tools/torch_attention_probe.py --fwd      # forward only
    python3 tools/torch_attention_probe.py --bwd      # backward only

It builds the CUDA kernels (paddle_tpu_torch/ops/csrc) and prints the
registers, spills and any serialization warning ptxas gave the attention
kernels (every instantiation: DP = 64, 128 and 256, and the CUDA-core
ones). It holds every forward
case of chip_smoke.py's KERNEL_CASES and every backward case of its
BWD_CASES (one-pass and flash) against the plain version with
chip_smoke.py's bounds and kernel names (a backward case also names the
(batch, row, head) where each gradient's error is largest against its
bound), and times the one-pass and flash forward kernels beside PyTorch's
scaled_dot_product_attention, and the one-pass backward and the flash
backward pair (dq, dkv) beside SDPA's backward, each with the least time
the card could take (chip_smoke.py's bounds), at the serving and training
paths' shapes and at D = 256 (bench.py's wide Transformer). One JSON line
per case, then the card's name and power limit. It is the quick loop for
kernel work: a few seconds of card time after the build, against
chip_smoke.py's minutes.
"""
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# (kernel, B, T, H, D, causal): the paths' forward shapes, bf16, and the
# wide Transformer's (D = 256); the flash kernels at D = 256 at seq 4096
TIMED = [("onepass", 8, 256, 8, 64, False),
         ("onepass", 256, 256, 8, 64, False),
         ("onepass", 256, 256, 8, 64, True),
         ("onepass", 64, 256, 8, 256, False),
         ("onepass", 64, 256, 8, 256, True),
         ("flash", 1, 4096, 8, 64, False),
         ("flash", 8, 4096, 8, 64, False),
         ("flash", 8, 4096, 8, 64, True),
         ("flash", 2, 4096, 8, 256, False),
         ("flash", 2, 4096, 8, 256, True)]
# (kernel, B, T, H, D, causal): the backward at train256's, train4096's and
# train256_wide's shapes, and the flash pair at D = 256, bf16
TIMED_BWD = [("onepass_bwd", 256, 256, 8, 64, False),
             ("onepass_bwd", 256, 256, 8, 64, True),
             ("onepass_bwd", 64, 256, 8, 256, False),
             ("onepass_bwd", 64, 256, 8, 256, True),
             ("flash_bwd", 8, 4096, 8, 64, False),
             ("flash_bwd", 8, 4096, 8, 64, True),
             ("flash_bwd", 2, 4096, 8, 256, False),
             ("flash_bwd", 2, 4096, 8, 256, True)]


def _ptxas_lines(logs):
    for name in ("attention", "attention_bwd"):
        with open(logs[name]) as f:
            for line in f:
                if any(w in line for w in ("registers", "spill", "warning",
                                           "error", "Compiling entry")):
                    print("%s: %s" % (name, line.rstrip()), flush=True)


def _forward(cs, A, gen):
    import torch
    fns = {"onepass": (A.onepass_attention_fwd_bthd,
                       A.onepass_attention_fwd_plain),
           "flash": (A.flash_attention_fwd_bthd, A.flash_attention_fwd_plain)}
    ok = True
    for kernel, b, t_q, t_k, h, d, causal, dtype, _, _ in cs.KERNEL_CASES:
        q, k, v = cs._qkv(gen, b, t_q, t_k, h, d, getattr(torch, dtype))
        fn, plain = fns[kernel]
        got = fn(q, k, v, causal)
        rec = {"kernel": kernel, "shape": [b, t_q, t_k, h, d],
               "causal": causal, "dtype": dtype,
               "cuda_kernel": A.last_kernel_name()}
        want = plain(q, k, v, causal)
        if kernel == "flash":
            (got, got_lse), (want, want_lse) = got, want
            rec["lse_err_ratio"] = cs.err_ratio(got_lse, want_lse,
                                                *cs.LSE_TOL, row_scale=False)
        rec["err_ratio"] = cs.err_ratio(got, want, *cs.OUT_TOL[dtype])
        rec["ok"] = rec["err_ratio"] <= 1 and \
            rec.get("lse_err_ratio", 0.0) <= 1 and \
            bool(torch.isfinite(got.float()).all()) and \
            cs.FWD_CODE_PATH[cs._code_dtype(dtype, d)] in rec["cuda_kernel"]
        ok = ok and rec["ok"]
        print(json.dumps(rec), flush=True)
    for kernel, b, t, h, d, causal in TIMED:
        q, k, v = cs._qkv(gen, b, t, t, h, d, torch.bfloat16)
        fn = fns[kernel][0]
        fn(q, k, v, causal)
        bound, by = cs._bound(4.0 * b * h * d * cs._pairs(t, t, causal),
                              2 * b * h * d * 4 * t +
                              (4 * b * t * h if kernel == "flash" else 0), 2)
        print(json.dumps({
            "kernel": kernel, "shape": [b, t, t, h, d], "causal": causal,
            "cuda_kernel": A.last_kernel_name(),
            "kernel_ms": cs.time_ms(lambda: fn(q, k, v, causal)),
            "sdpa_ms": cs.time_ms(cs._sdpa(q, k, v, causal)),
            "bound_ms": bound, "bound_by": by}), flush=True)
        del q, k, v
    return ok


def _worst(got, want, bound):
    """(batch, row, head) of the element with the largest error against
    its bound, and the number of elements over it."""
    import torch
    diff = (got.float() - want.float()).abs()
    ratio = torch.nan_to_num(diff / bound, nan=1e30, posinf=1e30)
    ratio = torch.where(diff == 0, torch.zeros_like(ratio), ratio)
    at = torch.unravel_index(ratio.argmax(), ratio.shape)[:3]
    return {"at": [int(i) for i in at], "over": int((ratio > 1).sum())}


def _backward(cs, A, gen):
    import torch
    ok = True
    for kernel, b, t_q, t_k, h, d, causal, dtype, _, _ in cs.BWD_CASES:
        tdtype = getattr(torch, dtype)
        q, k, v = cs._qkv(gen, b, t_q, t_k, h, d, tdtype)
        do = torch.randn(q.shape, generator=gen, device="cuda").to(tdtype)
        if kernel == "onepass_bwd":
            got = A.onepass_attention_bwd_bthd(q, k, v, do, causal)
            names = A.last_bwd_kernel_name().split(" + ")
            want = A.onepass_attention_bwd_plain(q, k, v, do, causal)
        else:
            out, lse = A.flash_attention_fwd_bthd(q, k, v, causal)
            delta = A.flash_delta(out, do)
            dq = A.flash_attention_bwd_dq(q, k, v, do, lse, delta, causal)
            names = [A.last_bwd_kernel_name()]
            got = (dq,) + A.flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                                    causal)
            names.append(A.last_bwd_kernel_name())
            want = (A.flash_attention_bwd_dq_plain(q, k, v, do, lse, delta,
                                                   causal),) + \
                A.flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta,
                                                causal)
        torch.cuda.synchronize()
        rtol, atol = cs.BWD_TOL[kernel][dtype]
        rec = {"kernel": kernel, "shape": [b, t_q, t_k, h, d],
               "causal": causal, "dtype": dtype, "cuda_kernels": names,
               "err_ratio": {}, "err_ratio_without_flips": {}, "worst": {}}
        if dtype != "bfloat16":
            extra = (None,) * 3
        elif kernel == "onepass_bwd":
            extra = cs.onepass_bwd_rounding_bound(A, q, k, v, do, causal)
        else:
            extra = cs.flash_bwd_rounding_bound(A, q, k, v, do, out, lse,
                                                causal)
        for n, g, w, e in zip(("dq", "dk", "dv"), got, want, extra):
            bound = cs.bwd_bound(w, rtol, atol, e)
            rec["err_ratio"][n] = cs.err_ratio(g, w, 0, 0, bound=bound)
            rec["err_ratio_without_flips"][n] = cs.err_ratio(g, w, rtol,
                                                             atol)
            rec["worst"][n] = _worst(g, w, bound)
        del extra
        want_names = cs.BWD_CODE_PATH[kernel][cs._code_dtype(dtype, d)]
        rec["ok"] = max(rec["err_ratio"].values()) <= 1 and \
            all(bool(torch.isfinite(g.float()).all()) for g in got) and \
            len(names) == len(want_names) and \
            all(n.startswith(p) for n, p in zip(names, want_names))
        ok = ok and rec["ok"]
        print(json.dumps(rec), flush=True)
        del q, k, v, do, got, want
        if kernel == "flash_bwd":
            del out, lse, delta
        torch.cuda.empty_cache()
    for kernel, b, t, h, d, causal in TIMED_BWD:
        q, k, v = cs._qkv(gen, b, t, t, h, d, torch.bfloat16)
        do = torch.randn(q.shape, generator=gen, device="cuda").to(
            torch.bfloat16)
        rec = {"kernel": kernel, "shape": [b, t, t, h, d], "causal": causal}
        if kernel == "onepass_bwd":
            parts = {"onepass_bwd": lambda: A.onepass_attention_bwd_bthd(
                q, k, v, do, causal)}
        else:
            out, lse = A.flash_attention_fwd_bthd(q, k, v, causal)
            delta = A.flash_delta(out, do)
            parts = {"flash_bwd_" + part: (
                lambda fn=fn: fn(q, k, v, do, lse, delta, causal))
                for part, fn in (("dq", A.flash_attention_bwd_dq),
                                 ("dkv", A.flash_attention_bwd_dkv))}
        for part, fn in parts.items():
            fn()
            rec[part] = {"cuda_kernel": A.last_bwd_kernel_name(),
                         "ms": cs.time_ms(fn, iters=10)}
            rec[part]["bound_ms"], rec[part]["bound_by"] = cs.bwd_bound_ms(
                part, b, t, t, h, d, causal, 2)
        rec["sdpa_bwd_ms"] = cs.time_ms(cs._sdpa_bwd(q, k, v, do, causal),
                                        iters=10)
        rec["vs_sdpa"] = sum(r["ms"] for r in rec.values()
                             if isinstance(r, dict)) / rec["sdpa_bwd_ms"]
        print(json.dumps(rec), flush=True)
        del q, k, v, do, parts
        if kernel == "flash_bwd":
            del out, lse, delta
        torch.cuda.empty_cache()
    return ok


def main():
    import torch
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import attention as A

    _ptxas_lines(_build.build_all())
    gen = torch.Generator(device="cuda")
    gen.manual_seed(cs.SEED)
    ok = True
    if "--bwd" not in sys.argv[1:]:
        ok = _forward(cs, A, gen) and ok
    if "--fwd" not in sys.argv[1:]:
        ok = _backward(cs, A, gen) and ok
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip() or smi.stderr.strip())
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
