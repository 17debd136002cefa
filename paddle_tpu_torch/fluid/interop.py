"""Carry parameters across from the JAX package.

``params_from_numpy`` takes a model's parameters read as numpy arrays (for
example ``np.asarray(jax_scope.get(name))`` for each parameter of a program
the JAX package ran) and writes them into the port's scope as tensors on
one device, so both packages can be fed the same weights.
"""
import numpy as np
import torch

__all__ = ["params_from_numpy", "tensor_from_numpy"]


def tensor_from_numpy(arr):
    """A CPU tensor of a numpy array. A bfloat16 array (numpy's extension
    dtype from ml_dtypes, which torch.from_numpy rejects) is reinterpreted
    through its uint16 bits, without importing ml_dtypes."""
    arr = np.ascontiguousarray(arr)
    if not arr.flags.writeable:       # e.g. a view of a JAX array
        arr = arr.copy()
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def params_from_numpy(arrays, scope, device):
    """Write {name: np.ndarray} into `scope` as tensors on `device`.

    Each name must already hold a tensor in the scope (run the startup
    program first) of the same shape; a missing name raises KeyError and a
    mis-shaped one ValueError, before anything is written."""
    device = torch.device(device)
    for name, arr in arrays.items():
        old = scope.get(name)
        if old is None:
            raise KeyError("parameter %r is not in the scope" % name)
        if tuple(old.shape) != tuple(np.shape(arr)):
            raise ValueError("parameter %r has shape %s in the scope, %s given"
                             % (name, tuple(old.shape), tuple(np.shape(arr))))
    for name, arr in arrays.items():
        scope.set(name, tensor_from_numpy(np.asarray(arr)).to(device))
