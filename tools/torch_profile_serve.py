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
    python3 tools/torch_profile_serve.py --train --model resnet50  # batch 64

It builds the flagship model (bench.py's config; with --wide bench.py's wide
Transformer, d_model 2048 and d_ff 8192, so D = 256; with --model
bench.py's BERT-base, DeepFM or ResNet-50 leg, training only) with random
weights from the seed chip_smoke.py uses. Serving: two warm-up requests, then three
traced with torch.profiler. Training (bench.py's training leg, as
chip_smoke.py's train phases run it): one warm step, then two steps traced
through Executor.run_steps. It prints one JSON line. Busy share is the
summed device time of the traced kernels over the wall time of the traced
window (one stream, so kernels do not overlap). Peak memory is over the
traced window. Device time is also summed by kind: the port's kernels by
name, cuDNN's convolutions ("conv"), cuBLAS's and CUTLASS's products
("matmul") and all others ("other"). For ResNet-50 it also reports the host
time a step spends in the 161 momentum ops, through the executor's group
lowering and op by op (two more steps each, after the trace). FLAGS_*
variables in the environment (for example FLAGS_dropout_save_mask=1) apply
and are echoed.
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
    ap.add_argument("--model", choices=("transformer", "bert", "deepfm",
                                        "resnet50"),
                    default="transformer",
                    help="with --train: bench.py's BERT-base (batch 256, "
                    "seq 128), DeepFM (batch 4096) or ResNet-50 (batch 64, "
                    "3x224x224, bf16) leg")
    args = ap.parse_args()
    if args.model != "transformer" and not args.train:
        ap.error("--model %s trains only: add --train" % args.model)

    import torch
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.models import bert, deepfm, resnet, transformer

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
        elif args.model == "resnet50":
            cfg = {"d_model": None}
            batch, args.seq = resnet.RESNET_BENCH_BATCH, None
            main_prog, startup, loss, _ = resnet.training_programs(
                SEED, dataset="flowers", dtype=resnet.RESNET_BENCH_DTYPE)
            one = resnet.synthetic_batch(batch, [3, 224, 224], 1000,
                                         seed=SEED)
        else:
            # bench.py's BATCH, LONGSEQ_BATCH and WIDE_BATCH
            batch = 64 if args.wide else (256 if args.seq <= 512 else 8)
            main_prog, startup, loss = transformer.training_programs(
                SEED, **cfg)
            one = transformer.synthetic_batch(batch, args.seq,
                                              cfg["tgt_vocab"], SEED)

        def run(steps, runner=None):
            (runner or exe).run_steps(
                main_prog, feed={k: v[None].repeat(steps, 0)
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
    extra = {}
    if args.model == "resnet50":
        conv = sorted(((ms, calls, name) for name, (ms, calls)
                       in kernels.items() if _kind(name) == "conv"),
                      reverse=True)[:8]
        extra["top_conv_kernels"] = [[name[:100], ms / n, calls / n]
                                     for ms, calls, name in conv]
        extra["momentum_host_ms_per_step"] = _momentum_host_ms(fluid, run)
    print(json.dumps(dict({
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
                        for name, (ms, calls) in top]}, **extra)))
    return 0


def _momentum_host_ms(fluid, run, steps=2):
    """Host time a training step spends in its momentum ops, by route:
    {"grouped": ms, "op_by_op": ms}. The executor's calls into the group
    lowering and into each op's lowering are timed as they enqueue their
    launches; op by op is the same program with momentum's group lowering
    taken out of the registry, so the executor plans no group."""
    import torch
    from paddle_tpu_torch.fluid.ops import registry
    executor = fluid.executor
    spent = []

    def timed(fn, is_momentum):
        def call(op, env, ctx):
            if not is_momentum(op):
                return fn(op, env, ctx)
            t0 = time.perf_counter()
            out = fn(op, env, ctx)
            spent.append(time.perf_counter() - t0)
            return out
        return call
    lower_group, lower_op = executor.lower_group, executor.lower_op
    executor.lower_group = timed(lower_group,
                                 lambda ops: ops[0].type == "momentum")
    executor.lower_op = timed(lower_op, lambda op: op.type == "momentum")
    result = {}
    try:
        for route in ("grouped", "op_by_op"):
            if route == "op_by_op":
                group = registry._GROUP_LOWERINGS.pop("momentum")
            try:
                runner = fluid.Executor()   # plans the program anew
                run(1, runner)              # and warms up
                torch.cuda.synchronize()
                del spent[:]
                run(steps, runner)
                torch.cuda.synchronize()
                result[route] = sum(spent) * 1e3 / steps
            finally:
                if route == "op_by_op":
                    registry._GROUP_LOWERINGS["momentum"] = group
    finally:
        executor.lower_group, executor.lower_op = lower_group, lower_op
    return result


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


# cuDNN's convolution kernels and its layout transposes around them
# (implicit-GEMM fprop, dgrad and wgrad kernels, cudnn:: and cutlass_cudnn
# names): ahead of "matmul", whose markers ("gemm", "xmma", "cutlass") they
# share
_CONV_MARKERS = ("conv", "fprop", "dgrad", "wgrad", "cudnn", "nchwtonhwc",
                 "nhwctonchw", "tensortransform")


def _kind(name):
    for fn, kind in _PORT_KERNELS:
        if fn in name:
            return kind
    low = name.lower()
    if any(k in low for k in _CONV_MARKERS):
        return "conv"
    if any(k in low for k in ("gemm", "nvjet", "cutlass", "xmma", "cublas")):
        return "matmul"
    return "other"


if __name__ == "__main__":
    sys.exit(main())
