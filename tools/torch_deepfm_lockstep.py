"""Hold bench.py's DeepFM leg on the card against the CPU step by step.

Run from the root of a checkout, on a machine with a CUDA card and the CUDA
toolkit:

    python3 tools/torch_deepfm_lockstep.py [--steps N] [--startup card|cpu]

It builds the DeepFM training program (bench.py's DEEPFM_CFG, batch 4096,
Adam(1e-3), sparse tables) and runs its startup program on the card
(Philox draws) or on the CPU. Then, for each of N steps, it runs the step
on the card and on the CPU from the same state (the CPU's state after the
step before) and the same batch, and prints one JSON line: for the loss,
every parameter's gradient (the sparse tables' per-occurrence values) and
every persistable after the step, max |card - cpu| / max |cpu| and
||card - cpu|| / ||cpu||, and how many ReLU preactivations of the MLP lie
on the two sides of 0 on the two devices. chip_smoke.py's deepfm_parity
phase runs the same lockstep with limits; this tool shows what moves the
readings.
"""
import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SEED = 1234


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--startup", choices=("card", "cpu"), default="card")
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.fluid.executor import as_numpy
    from paddle_tpu_torch.models import deepfm

    cfg, batch = deepfm.DEEPFM_BENCH_CFG, deepfm.DEEPFM_BENCH_BATCH
    with fluid.unique_name.guard():
        main_prog, startup, loss, _ = deepfm.training_programs(SEED, **cfg)
    block = main_prog.global_block()
    card, cpu = fluid.Executor(), fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    (card if args.startup == "card" else cpu).run(startup, scope=scope)
    names = [v.name for v in block.vars.values()
             if v.persistable and scope.get(v.name) is not None]
    state = {n: scope.get(n).cpu().clone() for n in names}
    grads = [p.name + "@GRAD" for p in main_prog.all_parameters()]
    relu_in = [op.input("X")[0] for op in block.ops if op.type == "relu"]
    fetch = [loss.name] + grads + relu_in

    def step(exe, feed):
        sc = fluid.Scope()
        for n, t in state.items():
            sc.set(n, t.clone())
        got = exe.run(main_prog, feed=feed, fetch_list=fetch, scope=sc)
        return ([np.asarray(as_numpy(g), np.float64) for g in got],
                {n: sc.get(n).cpu().clone() for n in names})

    def compare(c, w):
        d = np.abs(c - w)
        return [float(d.max() / max(np.abs(w).max(), 1e-30)),
                float(np.linalg.norm(c - w) /
                      max(np.linalg.norm(w), 1e-30))]

    for i in range(args.steps):
        feed = deepfm.synthetic_batch(batch, cfg["num_fields"],
                                      cfg["vocab_size"], seed=SEED + 400 + i)
        c, c_state = step(card, feed)
        w, w_state = step(cpu, feed)
        n_grads = 1 + len(grads)
        rec = {"step": i, "startup": args.startup,
               "loss": compare(c[0], w[0])}
        rec.update({g: compare(a, b)
                    for g, a, b in zip(grads, c[1:n_grads], w[1:n_grads])})
        rec.update({n: compare(np.asarray(as_numpy(c_state[n]), np.float64),
                               np.asarray(as_numpy(w_state[n]), np.float64))
                    for n in names})
        rec["relu_sign_flips"] = {
            name: int(np.sum((a > 0) != (b > 0)))
            for name, a, b in zip(relu_in, c[n_grads:], w[n_grads:])}
        print(json.dumps(rec), flush=True)
        state = w_state
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip() or smi.stderr.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
