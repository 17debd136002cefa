"""Time the training steps whose embedding gradients go through the
port's row sums (``tensor_ops.scatter_rows_``) with the card's in-order
route (``add_rows_in_order_``: the same bits in every run) and with
``index_add_`` (atomics, the order changing from run to run), in one
process on one card, windows alternating in, add, add, in, in, add.

Usage, from the root of a checkout, on a machine with the card:
  python3 tools/torch_row_sums_ab.py [--steps 4]

Legs: bench.py's BERT-base (batch 256, seq 128: a [2, 768] token-type
table takes 32,768 ids a step), DeepFM (batch 4096, two sparse
[100000, ...] tables) and the flagship Transformer (batch 256, seq 256).
Prints one JSON line a leg ({leg: {"in_order": [ms a step, ...],
"index_add": [...]}}) and the card's name and power limit.
"""
import argparse
import gc
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch

import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.fluid.ops import tensor_ops
from paddle_tpu_torch.models import bert, deepfm, transformer

ORDER = ["in_order", "index_add", "index_add", "in_order", "in_order",
         "index_add"]


def _index_add(dst, rows, vals):
    return dst.index_add_(0, *tensor_ops._row_adds(dst, rows, vals))


def _stacked(feed, steps):
    import numpy as np
    return {n: np.stack([x] * steps) for n, x in feed.items()}


def legs():
    """(name, (main, startup, loss), feed(seed))."""
    b = bert.BERT_BASE_CFG
    yield ("bert_base", bert.training_programs(1234, **b),
           lambda s: bert.synthetic_batch(bert.BERT_BASE_BATCH,
                                          b["seq_len"], b["vocab_size"],
                                          seed=s))
    d = deepfm.DEEPFM_BENCH_CFG
    yield ("deepfm", deepfm.training_programs(1234, **d)[:3],
           lambda s: deepfm.synthetic_batch(deepfm.DEEPFM_BENCH_BATCH,
                                            d["num_fields"],
                                            d["vocab_size"], seed=s))
    c = transformer.FLAGSHIP_CFG
    yield ("train256", transformer.training_programs(1234, **c),
           lambda s: transformer.synthetic_batch(256, c["seq_len"],
                                                 c["tgt_vocab"], s))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=4)
    args = p.parse_args(argv)
    routes = {"in_order": tensor_ops.add_rows_in_order_,
              "index_add": _index_add}
    for name, (main_prog, startup, loss), feed in legs():
        exe, scope = fluid.Executor(), fluid.Scope()
        exe.run(startup, scope=scope)
        warm, window = _stacked(feed(1), 1), _stacked(feed(2), args.steps)
        times = {r: [] for r in routes}
        try:
            for route in ORDER:
                tensor_ops.add_rows_in_order_ = routes[route]
                exe.run_steps(main_prog, feed=warm, n_steps=1,
                              fetch_list=[loss], scope=scope)
                gc.collect()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                exe.run_steps(main_prog, feed=window, n_steps=args.steps,
                              fetch_list=[loss], scope=scope)
                torch.cuda.synchronize()
                times[route].append(
                    (time.perf_counter() - t0) / args.steps * 1e3)
        finally:
            tensor_ops.add_rows_in_order_ = routes["in_order"]
        print(json.dumps({name: times}), flush=True)
        del exe, scope
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
