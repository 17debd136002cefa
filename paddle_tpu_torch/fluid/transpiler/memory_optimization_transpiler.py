"""memory_optimize / release_memory (reference:
python/paddle/fluid/transpiler/memory_optimization_transpiler.py, liveness-
based var reuse). The port's executor already frees each value after its
last reader (executor._Plan), so these are no-ops kept for the reference's
scripts."""

__all__ = ["memory_optimize", "release_memory"]


def memory_optimize(input_program, skip_opt_set=None, print_log=False,
                    level=0, skip_grads=False):
    from .. import flags
    flags.warn_noop(
        "memory_optimize()",
        "the executor already frees every value after its last reader "
        "(executor._Plan's liveness); the program is not rewritten")
    return None


def release_memory(input_program, skip_opt_set=None):
    return None
