"""Core IR enums and dtype utilities.

The port's copy of ``paddle_tpu/fluid/core_types.py``: the same variable
roles, op-role bits and canonical dtype strings, so a Program built here
serializes exactly like one built by the JAX package. Added for PyTorch:
``to_torch_dtype`` maps a canonical dtype string to its ``torch.dtype``
("bfloat16" <-> ``torch.bfloat16``), and ``convert_dtype`` accepts a
``torch.dtype`` as well as numpy dtypes and strings.
"""
import numpy as np
import torch

__all__ = ["VarType", "OpRole", "convert_dtype", "dtype_is_floating",
           "to_torch_dtype"]


class VarType(object):
    """Variable roles (not storage formats)."""
    LOD_TENSOR = "lod_tensor"          # dense (possibly ragged-annotated) tensor
    SELECTED_ROWS = "selected_rows"    # sparse row-slice gradients (embedding)
    LOD_TENSOR_ARRAY = "lod_tensor_array"
    LOD_RANK_TABLE = "lod_rank_table"
    STEP_SCOPES = "step_scopes"
    READER = "reader"
    RAW = "raw"
    FEED_MINIBATCH = "feed_minibatch"
    FETCH_LIST = "fetch_list"


class OpRole(object):
    """Op role bits, used by transpilers/backward to classify ops.

    Reference parity: op_proto_maker.h OpRole (Forward/Backward/Optimize/RPC/Dist/LRSched).
    """
    Forward = 0
    Backward = 1
    Optimize = 2
    RPC = 3
    Dist = 4
    LRSched = 16
    Loss = 256

    KEY = "op_role"          # attr name carrying the role
    VAR_KEY = "op_role_var"  # attr naming (param, grad) pairs on optimize/backward ops


_DTYPE_ALIASES = {
    "float32": "float32", "fp32": "float32", "f32": "float32",
    "float64": "float64", "fp64": "float64", "double": "float64",
    "float16": "float16", "fp16": "float16", "half": "float16",
    "bfloat16": "bfloat16", "bf16": "bfloat16",
    "int8": "int8", "uint8": "uint8",
    "int16": "int16", "int32": "int32", "int64": "int64",
    "bool": "bool",
}

_TORCH_DTYPES = {
    "float32": torch.float32, "float64": torch.float64,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "int8": torch.int8, "uint8": torch.uint8, "int16": torch.int16,
    "int32": torch.int32, "int64": torch.int64, "bool": torch.bool,
}
_TORCH_NAMES = {v: k for k, v in _TORCH_DTYPES.items()}


def convert_dtype(dtype):
    """Normalize a dtype spec (str / np.dtype / torch.dtype) to a canonical
    string."""
    if dtype is None:
        return None
    if isinstance(dtype, torch.dtype):
        if dtype not in _TORCH_NAMES:
            raise ValueError("unsupported dtype: %r" % (dtype,))
        return _TORCH_NAMES[dtype]
    if isinstance(dtype, str):
        key = dtype.lower()
        if key in _DTYPE_ALIASES:
            return _DTYPE_ALIASES[key]
        return np.dtype(dtype).name
    try:
        name = np.dtype(dtype).name
        return _DTYPE_ALIASES.get(name, name)
    except TypeError:
        name = getattr(dtype, "name", None) or getattr(dtype, "__name__", None)
        if name and name.lower() in _DTYPE_ALIASES:
            return _DTYPE_ALIASES[name.lower()]
        raise ValueError("unsupported dtype: %r" % (dtype,))


def dtype_is_floating(dtype):
    return convert_dtype(dtype) in ("float16", "bfloat16", "float32", "float64")


def to_torch_dtype(dtype):
    """The ``torch.dtype`` of a dtype spec."""
    return _TORCH_DTYPES[convert_dtype(dtype)]
