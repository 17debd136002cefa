"""Check and time the port's attention forward kernels alone on one card.

Run from the root of a checkout, on a machine with a CUDA card and the CUDA
toolkit:

    python3 tools/torch_attention_probe.py

It builds the CUDA kernels (paddle_tpu_torch/ops/csrc), holds every forward
case of chip_smoke.py's KERNEL_CASES against its plain version with
chip_smoke.py's bounds, and times the one-pass and flash forward kernels
(CUDA events) beside PyTorch's scaled_dot_product_attention at the shapes
of the serving and training paths. One JSON line per case, then the card's
name and power limit. It is the quick loop for kernel work: a few seconds
of card time after the build, against chip_smoke.py's minute and a half.
"""
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# (kernel, B, T, H, D, causal): the paths' forward shapes, bf16
TIMED = [("onepass", 8, 256, 8, 64, False),
         ("onepass", 256, 256, 8, 64, False),
         ("onepass", 256, 256, 8, 64, True),
         ("flash", 1, 4096, 8, 64, False),
         ("flash", 8, 4096, 8, 64, False),
         ("flash", 8, 4096, 8, 64, True)]


def main():
    import torch
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import attention as A

    _build.build_all()
    fns = {"onepass": (A.onepass_attention_fwd_bthd,
                       A.onepass_attention_fwd_plain),
           "flash": (A.flash_attention_fwd_bthd, A.flash_attention_fwd_plain)}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(cs.SEED)
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
            bool(torch.isfinite(got.float()).all())
        ok = ok and rec["ok"]
        print(json.dumps(rec), flush=True)
    for kernel, b, t, h, d, causal in TIMED:
        q, k, v = cs._qkv(gen, b, t, t, h, d, torch.bfloat16)
        fn = fns[kernel][0]
        print(json.dumps({
            "kernel": kernel, "shape": [b, t, t, h, d], "causal": causal,
            "kernel_ms": cs.time_ms(lambda: fn(q, k, v, causal)),
            "sdpa_ms": cs.time_ms(cs._sdpa(q, k, v, causal))}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip() or smi.stderr.strip())
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
