"""Data layers (the port's counterpart of ``paddle_tpu/fluid/layers/io.py``):
``data`` declares a feed variable, ``load`` emits a load host op (run by
fluid/io.py's handler). Ragged (lod_level > 0) inputs come with a later
slice."""
from ..core_types import VarType, convert_dtype
from ..layer_helper import LayerHelper

__all__ = ["data", "load"]


def data(name, shape, append_batch_size=True, dtype="float32", lod_level=0,
         type=VarType.LOD_TENSOR, stop_gradient=True):
    if lod_level:
        raise NotImplementedError("ragged (lod_level > 0) data is not ported "
                                  "yet")
    helper = LayerHelper("data")
    shape = list(shape)
    if append_batch_size:
        shape = [-1] + shape
    return helper.create_global_variable(
        name=name, shape=shape, dtype=convert_dtype(dtype),
        type=type, stop_gradient=stop_gradient, lod_level=lod_level,
        is_data=True)


def load(out, file_path, load_as_fp16=None):
    """Emit a load op filling `out` from file_path (reference load_op.cc)."""
    from ..framework import default_main_program
    default_main_program().global_block().append_op(
        type="load", inputs={}, outputs={"Out": [out]},
        attrs={"file_path": file_path,
               "load_as_fp16": bool(load_as_fp16)})
    return out
