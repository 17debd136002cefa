"""FLAGS_* environment flag system.

The port's copy of ``paddle_tpu/fluid/flags.py``: the same ``FLAGS_*``
names, types and defaults for the flags the ported modules read, so one
environment configures both packages alike; ``dump()`` prints the
effective values. Flags of modules not yet ported join the table with
those modules: ``rng_impl`` and ``dropout_rng`` (the JAX package's random
bit sources, ROADMAP Queue 2 item 3), and the ``monitor_*`` flags and
``profiler_max_events`` (fluid.monitor and fluid.profiler, Queue 1 item
10) are not here yet.

Also hosts ``warn_noop(...)``: a one-time warning when a knob kept for the
reference's scripts (memory_optimize, release_memory) does nothing in the
port, with the same message form as the JAX package's.
"""
import os
import warnings

__all__ = ["get", "dump", "warn_noop", "WHITELIST"]

# name (without FLAGS_ prefix) -> (type, default, help)
WHITELIST = {
    "check_nan_inf": (bool, False,
                      "after every run, check the values the run writes "
                      "to the scope or fetches for NaN/Inf (executor.py; "
                      "reference platform/enforce nan check)"),
    "adam_kernel": (bool, True,
                    "use the fused dense-Adam CUDA kernel on the card "
                    "(ops/adam_kernel.py; 0 forces the plain path for A/B)"),
    "ce_kernel": (bool, False,
                  "use the cross-entropy CUDA kernels, forward and backward "
                  "(ops/ce_kernel.py, csrc/ce.cu); default off"),
    "ln_kernel": (bool, False,
                  "use the one-pass LayerNorm backward CUDA kernel "
                  "(ops/layernorm_kernel.py, csrc/layernorm.cu); default "
                  "off"),
    "emb_grad_sorted": (bool, False,
                        "presort the dense embedding-grad scatter updates "
                        "(fluid/ops/tensor_ops.py; A/B experiment)"),
    "emb_grad_kernel": (str, "",
                        "dense embedding-grad CUDA kernel, one launch a "
                        "call with no sort and no atomics: 'scatter' (each "
                        "id's row added in the table dtype, in id order) or "
                        "'segsum' (each row's sum in f32, in id order, "
                        "rounded once); '' keeps the plain scatter-add "
                        "(ops/emb_grad_kernel.py, csrc/emb_grad.cu)"),
    "dropout_save_mask": (bool, False,
                          "materialize dropout masks for the backward pass "
                          "instead of redrawing them from the saved "
                          "generator state"),
    "flash_min_seq": (int, 1024,
                      "key length from which the flash attention kernel "
                      "takes over from the dense path (ops/attention.py)"),
    "onepass_max_seq": (int, 512,
                        "longest sequence for the one-pass attention "
                        "kernel (bounded by its shared-memory score tile)"),
    "fraction_of_gpu_memory_to_use": (float, 1.0,
                                      "accepted for reference script "
                                      "compat; no-op (PyTorch's caching "
                                      "allocator owns device memory)"),
    "benchmark": (bool, False,
                  "accepted for reference script compat (reference uses it "
                  "to force sync kernels; the port's launches stay "
                  "asynchronous)"),
    "eager_delete_tensor_gb": (float, -1.0,
                               "accepted for reference compat; no-op (the "
                               "executor drops each intermediate after its "
                               "last reader)"),
}


def get(name, default=None):
    """Read flag `name` (without the FLAGS_ prefix) from the environment,
    typed per the whitelist. Unknown names fall through to `default`."""
    raw = os.environ.get("FLAGS_" + name)
    spec = WHITELIST.get(name)
    if spec is None:
        return raw if raw is not None else default
    typ, dflt, _ = spec
    if raw is None:
        return dflt if default is None else default
    if typ is bool:
        return raw.lower() not in ("", "0", "false", "no")
    return typ(raw)


def dump():
    """Effective flag values, one line each."""
    lines = []
    for name, (typ, dflt, help_) in sorted(WHITELIST.items()):
        lines.append("FLAGS_%s=%r (default %r) - %s"
                     % (name, get(name), dflt, help_))
    return "\n".join(lines)


_warned = set()


def warn_noop(feature, why):
    """One-time warning that a configured knob is a documented no-op."""
    if feature in _warned:
        return
    _warned.add(feature)
    warnings.warn(
        "%s is a no-op in the PyTorch build: %s" % (feature, why),
        stacklevel=3)
