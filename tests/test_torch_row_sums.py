"""The row sums of the port's sparse and embedding gradients, on the CPU:
``scatter_rows_`` (the dense embedding gradient, the densify of a sparse
pair, sparse SGD) and the sparse optimizers' ``_merge_rows``.

On a CUDA tensor both add through ``add_rows_in_order_``, whose every run
gives the same bits (``index_add_`` on the card adds with atomics, in an
order that changes from run to run). Here that route runs on CPU tensors,
on one thread (the CPU's index_put_ splits the ids among its threads,
where the card's kernel adds each id's run in order), and must give what
``index_add_`` gives, bit for bit: ids repeated many times, negative ids
(which wrap once), ids still out of range (dropped), in float32 and
bfloat16 (which index_add_ adds in float32 and rounds once), rows of 1 to
100 columns (padded to IN_ORDER_MIN_WIDTH below it), into zeros and into
a table. ``_merge_rows`` keeps its ids ascending and sums in float32 in
batch order. chip_smoke.py's row_sums phase holds the route on the card:
twice, bit for bit, and against the CPU's index_add_.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.fluid.ops import optimizer_ops, tensor_ops


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _ids(n, vocab, seed=0):
    """Zipf-skewed ids over [0, vocab) with negative and out-of-range ones
    among them."""
    rng = np.random.RandomState(seed)
    ids = np.minimum(rng.zipf(1.3, n) - 1, vocab - 1)
    ids[:8] = [-1, -vocab, vocab, vocab + 5, -vocab - 1, 0, vocab - 1, -2]
    rng.shuffle(ids)
    return torch.from_numpy(ids.astype(np.int64))


def _vals(n, width, dtype, seed=1):
    v = np.random.RandomState(seed).randn(n, width).astype(np.float32)
    return torch.from_numpy(v).to(dtype)


def _reference(dst, rows, vals):
    """The CPU route as it stands: wrap, drop, cast, index_add_."""
    n = dst.shape[0]
    rows = tensor_ops.wrap_ids(rows.reshape(-1).long(), n)
    valid = (rows >= 0) & (rows < n)
    vals = torch.where(valid[:, None], vals.to(dst.dtype),
                       torch.zeros((), dtype=dst.dtype))
    return dst.index_add_(0, rows.clamp(0, n - 1), vals)


CASES = [(50, 2000, 1), (50, 2000, 16), (300, 4000, 33), (7, 500, 100),
         (2, 1000, 64)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("vocab,n,width", CASES)
@pytest.mark.parametrize("into", ["zeros", "table"])
def test_card_route_is_index_add_bit_for_bit(vocab, n, width, dtype, into):
    rows, vals = _ids(n, vocab), _vals(n, width, dtype)
    dst = torch.zeros(vocab, width, dtype=dtype) if into == "zeros" else \
        _vals(vocab, width, dtype, seed=2)
    want = _reference(dst.clone(), rows, vals)
    got = tensor_ops.add_rows_in_order_(dst.clone(), rows, vals)
    assert got.dtype == dtype
    assert torch.equal(got, want)
    # and scatter_rows_ on the CPU is that route's answer too
    assert torch.equal(tensor_ops.scatter_rows_(dst.clone(), rows, vals),
                       want)


def test_card_route_casts_and_works_in_place():
    """vals in float32 into a bfloat16 table: cast first, as index_add_
    takes them; the table itself is updated and returned."""
    rows, vals = _ids(300, 20), _vals(300, 8, torch.float32)
    dst = torch.zeros(20, 8, dtype=torch.bfloat16)
    want = _reference(dst.clone(), rows, vals)
    out = tensor_ops.add_rows_in_order_(dst, rows, vals)
    assert out.data_ptr() == dst.data_ptr() and torch.equal(dst, want)


def test_card_route_adds_in_batch_order():
    """Four adds into one float32 row whose sum depends on the order: in
    batch order ((1 + 2^24) + 1) - 2^24 rounds to 0; adding the two 1s
    first would give 2."""
    dst = torch.zeros(2, 1)
    rows = torch.tensor([0, 0, 0, 0])
    vals = torch.tensor([[1.0], [2.0 ** 24], [1.0], [-(2.0 ** 24)]])
    got = tensor_ops.add_rows_in_order_(dst, rows, vals)
    assert got[0, 0].item() == 0.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_merge_rows_ascending_ids_and_ordered_sums(dtype):
    vocab, n, width = 40, 1500, 8
    rows, vals = _ids(n, vocab), _vals(n, width, dtype)
    ids, sums = optimizer_ops._merge_rows(rows, vals, vocab)
    assert sums.dtype == torch.float32
    wrapped = tensor_ops.wrap_ids(rows, vocab)
    keep = (wrapped >= 0) & (wrapped < vocab)
    want_ids = torch.unique(wrapped[keep])
    assert torch.equal(ids, want_ids)
    assert (ids[1:] > ids[:-1]).all()
    dense = torch.zeros(vocab, width).index_add_(
        0, wrapped[keep], vals[keep].float())
    assert torch.equal(sums, dense[ids])
