"""How PyTorch's row sums behave on the card: index_add_, and
index_put_(accumulate=True) at each row width as it is and padded to 64
columns (the route of ``tensor_ops.add_rows_in_order_``), each run twice
on the same inputs and held against the CPU's index_add_, on Zipf-skewed
ids into zeros and into a table, in float32 and bfloat16; then each
one's time at DeepFM's, the Transformer's and BERT-base's table shapes.

Usage, from the root of a checkout, on a machine with the card:
  python3 tools/torch_index_put_probe.py

Prints one JSON line a case ({"twice_equal", "equal_cpu", "max_abs"} for
each route) and one a timed shape (ms a call, host clock over 20 calls).
"""
import json
import time

import torch

ROUTES = ("index_add", "index_put", "index_put_pad")


def zipf_ids(gen, n, vocab, a=1.2):
    p = torch.arange(1, vocab + 1, dtype=torch.float64) ** -a
    return torch.multinomial(p / p.sum(), n, replacement=True, generator=gen)


def index_add(dst, rows, vals):
    return dst.clone().index_add_(0, rows, vals)


def index_put(dst, rows, vals):
    return dst.clone().index_put_((rows,), vals, accumulate=True)


def index_put_pad(dst, rows, vals, width=64):
    w = dst.shape[1]
    if w >= width:
        return index_put(dst, rows, vals)
    d = dst.new_zeros((dst.shape[0], width))
    d[:, :w] = dst
    v = vals.new_zeros((vals.shape[0], width))
    v[:, :w] = vals
    return d.index_put_((rows,), v, accumulate=True)[:, :w]


def ms_a_call(fn, iters=20):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


def main():
    fns = dict(zip(ROUTES, (index_add, index_put, index_put_pad)))
    gen = torch.Generator().manual_seed(0)
    for vocab, n in [(100000, 20000), (2073, 400), (64, 5000)]:
        rows = zipf_ids(gen, n, vocab)
        widths = [1, 2, 16, 32, 33, 64] if vocab == 100000 else \
            [1, 2, 8, 16, 31, 32, 33, 64, 768]
        for width in widths:
            for dtype in (torch.float32, torch.bfloat16):
                for zero in (True, False):
                    vals = torch.randn(n, width, generator=gen).to(dtype)
                    dst = torch.zeros(vocab, width, dtype=dtype) if zero \
                        else torch.randn(vocab, width, generator=gen).to(dtype)
                    want = index_add(dst, rows, vals)
                    card = (dst.cuda(), rows.cuda(), vals.cuda())
                    rec = {"vocab": vocab, "n": n, "width": width,
                           "dtype": str(dtype), "zero": zero}
                    for name, fn in fns.items():
                        a, b = fn(*card), fn(*card)
                        rec[name] = {
                            "twice_equal": bool(torch.equal(a, b)),
                            "equal_cpu": bool(torch.equal(a.cpu(), want)),
                            "max_abs": float((a.cpu().float() -
                                              want.float()).abs().max())}
                    print(json.dumps(rec), flush=True)
    for vocab, n, width, dtype in [
            (100000, 4096 * 26, 1, torch.float32),
            (100000, 4096 * 26, 16, torch.float32),
            (32000, 16384, 1024, torch.bfloat16),
            (2, 32768, 768, torch.bfloat16),
            (30522, 32768, 768, torch.bfloat16)]:
        rows = torch.randint(0, vocab, (n,), device="cuda")
        vals = torch.randn(n, width, device="cuda").to(dtype)
        dst = torch.zeros(vocab, width, device="cuda", dtype=dtype)
        print(json.dumps({"shape": [vocab, n, width, str(dtype)]} | {
            name + "_ms": ms_a_call(lambda fn=fn: fn(dst, rows, vals))
            for name, fn in fns.items()}), flush=True)


if __name__ == "__main__":
    main()
