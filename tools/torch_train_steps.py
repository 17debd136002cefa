"""Time the training windows of chip_smoke.py's train256 and train256_wide
phases alone, on one card.

Run from the root of a checkout, on a machine with a CUDA card and the CUDA
toolkit:

    python3 tools/torch_train_steps.py [ADAM_LAUNCHES_PER_STEP] [--sync-debug]

It builds the kernels, then runs chip_smoke.py's `_train_phase` for the
flagship Transformer at seq 256 (batch 256) and for bench.py's wide one
(batch 64): startup, one warm step, 4 steps through run_steps, each phase
printing chip_smoke.py's JSON line (step ms, tokens/s, launches a step). The argument is the number of
Adam launches a step that the checkout's executor makes (default 1), which
the phase checks. Two checkouts are compared in one call by copying this
script into each and running them in turns (A, B, B, A). Python's automatic
garbage collection is off for the run, so that in neither checkout a full
collection of an earlier phase's garbage lands in a window. After each phase
it prints the caching allocator's counts (allocation retries, device
mallocs and frees, peak reserved bytes). With --sync-debug PyTorch warns,
with a stack, at every operation that makes the host wait for the card.
"""
import gc
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import chip_smoke as cs
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.models import transformer
    from paddle_tpu_torch.ops import _build
    import torch
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    gc.disable()
    args = [a for a in sys.argv[1:] if a != "--sync-debug"]
    adam = int(args[0]) if args else 1
    _build.build_all()
    if "--sync-debug" in sys.argv[1:]:
        import traceback
        import warnings

        def show(message, category, filename, lineno, file=None, line=None):
            print("sync: %s" % message, file=sys.stderr)
            traceback.print_stack(limit=10, file=sys.stderr)
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
    counters = cs._counters()
    cfg = dict(transformer.FLAGSHIP_CFG)
    attn = 3 * cfg["n_layer"]
    want = dict(dict.fromkeys(counters, 0), onepass=attn, onepass_bwd=attn,
                adam=adam)
    for name, phase_cfg, batch in (
            ("train256", cfg, cs.TRAIN_BATCH),
            ("train256_wide", dict(cfg, **cs.WIDE_CFG_OVERRIDES),
             cs.WIDE_BATCH)):
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_stats()
        cs._train_phase(name, fluid, transformer, counters, phase_cfg, batch,
                        cs.TRAIN_STEPS, want)
        after = torch.cuda.memory_stats()
        cs.emit({"phase": name, "allocator": {
            k: after.get(k, 0) - (0 if k.endswith("peak") else
                                  before.get(k, 0))
            for k in ("num_alloc_retries", "num_device_alloc",
                      "num_device_free", "reserved_bytes.all.peak")}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
