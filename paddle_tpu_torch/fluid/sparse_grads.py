"""Sparse row gradients: the ``@ROWS`` companion convention.

The port's copy of ``paddle_tpu/fluid/sparse_grads.py``. A sparse
embedding's gradient is the pair ``G`` ([n, dim] values) and ``G@ROWS``
([n] ids) that ``lookup_table_grad`` writes (ops/tensor_ops.py), the
reference's SelectedRows (rows, value, height) without the [vocab, dim]
tensor. The optimizer, regularizer and clip passes find the pair here and
densify it where their rewrite needs the dense form.
"""

ROWS_SUFFIX = "@ROWS"

# the optimizer op types with a sparse lowering (ops/optimizer_ops.py)
SPARSE_CAPABLE_OPTIMIZERS = frozenset(["sgd", "adagrad", "adam"])


def sparse_rows_var(block, grad_name):
    """The companion rows var name if `grad_name` is a sparse grad pair."""
    name = grad_name + ROWS_SUFFIX
    return name if block._has_var_recursive(name) else None


def densify(block, param, grad):
    """Append a ``selected_rows_densify`` op turning the (values, rows) pair
    into a dense gradient of the param's shape; returns the dense grad
    Variable, or ``grad`` itself when it is not a pair."""
    rows = sparse_rows_var(block, grad.name)
    if rows is None:
        return grad
    dense = block.create_var(name=grad.name + "@DENSE", shape=param.shape,
                             dtype=param.dtype)
    block.append_op(type="selected_rows_densify",
                    inputs={"X": [grad.name], "Rows": [rows],
                            "Ref": [param.name]},
                    outputs={"Out": [dense.name]})
    return dense
