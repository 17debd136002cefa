"""FLAGS_* environment flag system.

The port's copy of ``paddle_tpu/fluid/flags.py``: the same ``FLAGS_*``
names, types and defaults for the flags the ported modules read, so one
environment configures both packages alike. Flags of modules not yet
ported join the table with those modules.
"""
import os

__all__ = ["get", "WHITELIST"]

# name (without FLAGS_ prefix) -> (type, default, help)
WHITELIST = {
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
                        "dense embedding-grad CUDA kernel: 'scatter' "
                        "(atomic adds in the table dtype) or 'segsum' "
                        "(argsort outside, one f32 sum per row rounded "
                        "once); '' keeps the plain scatter-add "
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
