"""Profile serving requests of the PyTorch port (paddle_tpu_torch) on one
card: wall time per request, the device's busy share, and device time by
kernel name.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 tools/torch_profile_serve.py --seq 256     # batch 8
    python3 tools/torch_profile_serve.py --seq 4096    # batch 1

It builds the flagship model (bench.py's config) with random weights from
the seed chip_smoke.py uses, warms up with two requests, then traces
three with torch.profiler and prints one JSON line. Busy share is the
summed device time of the traced kernels over the wall time of the traced
window (one stream, so kernels do not overlap).
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
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.models import transformer

    batch = 8 if args.seq <= 512 else 1
    cfg = dict(transformer.FLAGSHIP_CFG, seq_len=args.seq)
    serve, startup, logits = transformer.serving_programs(SEED, **cfg)
    exe, scope = fluid.Executor(), fluid.Scope()
    exe.run(startup, scope=scope)
    b = transformer.synthetic_batch(batch, args.seq, cfg["tgt_vocab"], SEED)
    feed = {"src_ids": b["src_ids"], "tgt_ids": b["tgt_ids"]}

    def request():
        exe.run(serve, feed=feed, fetch_list=[logits], scope=scope,
                return_numpy=False)

    for _ in range(2):
        request()
    torch.cuda.synchronize()
    n = 3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            request()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    kernels = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            ms, calls = kernels.get(e.name, (0.0, 0))
            kernels[e.name] = (ms + e.time_range.elapsed_us() / 1e3, calls + 1)
    busy_ms = sum(ms for ms, _ in kernels.values()) / n
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:12]
    print(json.dumps({
        "seq_len": args.seq, "batch": batch, "requests": n,
        "wall_ms_per_request": wall_ms,
        "device_busy_ms_per_request": busy_ms if kernels else None,
        "busy_share": busy_ms / wall_ms if kernels else None,
        "kernel_launches_per_request": sum(c for _, c in kernels.values()) / n,
        "top_kernels": [[name[:80], ms / n, calls / n]
                        for name, (ms, calls) in top]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
