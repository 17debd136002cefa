"""Profile serving requests or training steps of the PyTorch port
(paddle_tpu_torch) on one card: wall time per request or step, the device's
busy share, and device time by kernel name and by kind.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 tools/torch_profile_serve.py --seq 256            # batch 8
    python3 tools/torch_profile_serve.py --seq 4096           # batch 1
    python3 tools/torch_profile_serve.py --train --seq 256    # batch 256
    python3 tools/torch_profile_serve.py --train --seq 4096   # batch 8
    python3 tools/torch_profile_serve.py --train --wide       # batch 64
    python3 tools/torch_profile_serve.py --train --model bert    # batch 256
    python3 tools/torch_profile_serve.py --train --model deepfm  # batch 4096

It builds the flagship model (bench.py's config; with --wide bench.py's wide
Transformer, d_model 2048 and d_ff 8192, so D = 256; with --model
bench.py's BERT-base or DeepFM leg, training only) with random weights
from the seed chip_smoke.py uses. Serving: two warm-up requests, then three
traced with torch.profiler. Training (bench.py's training leg, as
chip_smoke.py's train phases run it): one warm step, then two steps traced
through Executor.run_steps. It prints one JSON line. Busy share is the
summed device time of the traced kernels over the wall time of the traced
window (one stream, so kernels do not overlap). Peak memory is over the
traced window. FLAGS_* variables in the environment (for example
FLAGS_dropout_save_mask=1) apply and are echoed.
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SEED = 1234


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--train", action="store_true",
                    help="trace training steps instead of requests")
    ap.add_argument("--wide", action="store_true",
                    help="bench.py's wide Transformer (d_model 2048, d_ff "
                    "8192; training batch 64)")
    ap.add_argument("--model", choices=("transformer", "bert", "deepfm"),
                    default="transformer",
                    help="with --train: bench.py's BERT-base (batch 256, "
                    "seq 128) or DeepFM (batch 4096) leg")
    args = ap.parse_args()
    if args.model != "transformer" and not args.train:
        ap.error("--model %s trains only: add --train" % args.model)

    import torch
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.models import bert, deepfm, transformer

    cfg = dict(transformer.FLAGSHIP_CFG, seq_len=args.seq)
    if args.wide:       # bench.py's WIDE_CFG_OVERRIDES
        cfg.update(d_model=2048, d_ff=8192)
    exe, scope = fluid.Executor(), fluid.Scope()
    if args.train:
        n, warm, unit = 2, 1, "step"
        if args.model == "bert":
            cfg, batch = dict(bert.BERT_BASE_CFG), bert.BERT_BASE_BATCH
            args.seq = cfg["seq_len"]
            main_prog, startup, loss = bert.training_programs(SEED, **cfg)
            one = bert.synthetic_batch(batch, args.seq, cfg["vocab_size"],
                                       seed=SEED)
        elif args.model == "deepfm":
            cfg = dict(deepfm.DEEPFM_BENCH_CFG, d_model=None)
            batch, args.seq = deepfm.DEEPFM_BENCH_BATCH, None
            main_prog, startup, loss, _ = deepfm.training_programs(
                SEED, **deepfm.DEEPFM_BENCH_CFG)
            one = deepfm.synthetic_batch(batch, cfg["num_fields"],
                                         cfg["vocab_size"], seed=SEED)
        else:
            # bench.py's BATCH, LONGSEQ_BATCH and WIDE_BATCH
            batch = 64 if args.wide else (256 if args.seq <= 512 else 8)
            main_prog, startup, loss = transformer.training_programs(
                SEED, **cfg)
            one = transformer.synthetic_batch(batch, args.seq,
                                              cfg["tgt_vocab"], SEED)

        def run(steps):
            exe.run_steps(main_prog, feed={k: v[None].repeat(steps, 0)
                                           for k, v in one.items()},
                          n_steps=steps, fetch_list=[loss], scope=scope,
                          return_numpy=False)
    else:
        batch, n, warm, unit = (8 if args.seq <= 512 else 1), 3, 2, "request"
        serve, startup, logits = transformer.serving_programs(SEED, **cfg)
        b = transformer.synthetic_batch(batch, args.seq, cfg["tgt_vocab"],
                                        SEED)
        feed = {"src_ids": b["src_ids"], "tgt_ids": b["tgt_ids"]}

        def run(requests):
            for _ in range(requests):
                exe.run(serve, feed=feed, fetch_list=[logits], scope=scope,
                        return_numpy=False)
    exe.run(startup, scope=scope)
    run(warm)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(n)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    kernels = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            ms, calls = kernels.get(e.name, (0.0, 0))
            kernels[e.name] = (ms + e.time_range.elapsed_us() / 1e3, calls + 1)
    busy_ms = sum(ms for ms, _ in kernels.values()) / n
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:16]
    by_kind = {}
    for name, (ms, calls) in kernels.items():
        kind = _kind(name)
        kms, kcalls = by_kind.get(kind, (0.0, 0))
        by_kind[kind] = (kms + ms / n, kcalls + calls / n)
    print(json.dumps({
        "mode": "train" if args.train else "serve", "model": args.model,
        "seq_len": args.seq, "d_model": cfg["d_model"],
        "batch": batch, unit + "s": n,
        "wall_ms_per_" + unit: wall_ms,
        "device_busy_ms_per_" + unit: busy_ms if kernels else None,
        "busy_share": busy_ms / wall_ms if kernels else None,
        "peak_memory_bytes": torch.cuda.max_memory_allocated(),
        "flags": {k: v for k, v in os.environ.items()
                  if k.startswith("FLAGS_")},
        "kernel_launches_per_" + unit:
            sum(c for _, c in kernels.values()) / n,
        "ms_and_launches_by_kind": by_kind,
        "top_kernels": [[name[:80], ms / n, calls / n]
                        for name, (ms, calls) in top]}))
    return 0


# the port's kernels by their CUDA function names (csrc/*.cu)
_PORT_KERNELS = [("onepass_bwd_dq_kernel", "onepass_bwd"),
                 # ahead of "bwd_dkv_kernel", a substring of the next two
                 ("onepass_bwd_dkv_kernel_wgmma", "onepass_bwd"),
                 ("flash_bwd_dq_kernel_wgmma", "flash_bwd_dq"),
                 ("flash_bwd_dkv_kernel_wgmma", "flash_bwd_dkv"),
                 ("bwd_dkv_kernel", "attention_bwd_dkv"),
                 ("flash_bwd_dq_kernel", "flash_bwd_dq"),
                 ("onepass_fwd_kernel", "onepass_fwd"),
                 ("flash_fwd_kernel", "flash_fwd"),
                 ("adam_multi_kernel", "adam"),
                 ("ce_fwd_kernel", "ce_fwd"),
                 ("ce_bwd_kernel", "ce_bwd"),
                 ("ln_bwd_kernel", "ln_bwd"),      # and ln_bwd_kernel_wide
                 ("namespace)::scatter_kernel", "emb_scatter"),
                 ("namespace)::segsum_kernel", "emb_segsum")]


def _kind(name):
    for fn, kind in _PORT_KERNELS:
        if fn in name:
            return kind
    low = name.lower()
    if any(k in low for k in ("gemm", "nvjet", "cutlass", "xmma", "cublas")):
        return "matmul"
    return "other"


if __name__ == "__main__":
    sys.exit(main())
