"""Program transpilers (reference: python/paddle/fluid/transpiler/).

The port has the inference rewrites and the memory no-ops;
DistributeTranspiler waits for the distributed modules (ROADMAP Queue 1
item 9)."""
from .memory_optimization_transpiler import memory_optimize, release_memory
from .inference_transpiler import InferenceTranspiler

__all__ = ["memory_optimize", "release_memory", "InferenceTranspiler"]
