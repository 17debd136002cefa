"""Where the embedding-grad kernels' time goes, on the card.

Builds a copy of paddle_tpu_torch/ops/csrc/emb_grad.cu with clock64()
counters added (the kernel's own source, patched at fixed anchors), runs
both variants at train256's shape (65,536 ids into [8192, 512] bf16) on
uniform and Zipf-skewed ids, and prints for the slowest block its warps'
cycles: the id scan (the window loop, drains excluded), the drains, and
inside the drains the waits for staged dout (stage barrier included) and
the adds; then each variant's time through the real wrapper (CUDA events)
and the card's name and power limit. Run from the root of a checkout on a
machine with a CUDA card and the CUDA toolkit:

    python3 tools/torch_emb_grad_probe.py
"""
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (anchor in csrc/emb_grad.cu, text put in its place)
PATCHES = [
    ('#include "hopper.cuh"\n',
     '#include "hopper.cuh"\n__device__ unsigned long long* g_dbg;\n'),
    ("  int w = 0;   // this pass's next window\n",
     "  int w = 0;   // this pass's next window\n"
     "  unsigned long long t_loop = 0, t_wait = 0, t_add = 0, t_drain = 0,"
     " t_all = clock64(), t1 = 0;\n"),
    ("  auto drain = [&](int count) {\n",
     "  auto drain = [&](int count) {\n"
     "    unsigned long long td = clock64();\n"),
    ("    for (int j = 0; j < kIdStages - 1; ++j) issue_ids(w + j);\n  };",
     "    for (int j = 0; j < kIdStages - 1; ++j) issue_ids(w + j);\n"
     "    t_drain += clock64() - td;\n  };"),
    ("    for (w = 0; w < windows;) {\n",
     "    unsigned long long tl = clock64(), td0 = t_drain;\n"
     "    for (w = 0; w < windows;) {\n"),
    ("    if (count) drain(count);\n",
     "    t_loop += clock64() - tl - (t_drain - td0);\n"
     "    if (count) drain(count);\n"),
    ("      cp_async_wait<kDoutStages - 2>();\n"
     "      __syncthreads();   // stage s landed; stage s - 1 read by all\n"
     "      issue_dout(s + kDoutStages - 1);\n",
     "      unsigned long long t0 = clock64();\n"
     "      cp_async_wait<kDoutStages - 2>();\n"
     "      __syncthreads();   // stage s landed; stage s - 1 read by all\n"
     "      issue_dout(s + kDoutStages - 1);\n"
     "      t1 = clock64();\n      t_wait += t1 - t0;\n"),
    ("        }\n      }\n    }\n    cp_async_wait<0>();\n"
     "    __syncthreads();   // the adds done",
     "        }\n      }\n      t_add += clock64() - t1;\n    }\n"
     "    cp_async_wait<0>();\n    __syncthreads();   // the adds done"),
    ("    __syncthreads();   // the acc read before the next pass zeroes it\n"
     "  }\n}",
     "    __syncthreads();   // the acc read before the next pass zeroes it\n"
     "  }\n  if (lane == 0) {\n"
     "    unsigned long long* d = g_dbg + (blockIdx.x * kWarps + warp) * 5;\n"
     "    d[0] = t_loop; d[1] = t_drain; d[2] = t_wait; d[3] = t_add;\n"
     "    d[4] = clock64() - t_all;\n  }\n}"),
]
FIELDS = ("scan", "drains", "drain_waits", "drain_adds", "total")
SET_DBG = ('\nextern "C" int set_dbg(void* p) {\n'
           '  return (int)cudaMemcpyToSymbol(g_dbg, &p, sizeof(p));\n}\n')


def instrument(src):
    """The kernel source with the counters; raises if an anchor is gone."""
    for anchor, text in PATCHES:
        if src.count(anchor) != 1:
            raise ValueError("anchor not found once in emb_grad.cu: %r"
                             % anchor[:60])
        src = src.replace(anchor, text)
    return src + SET_DBG


def main():
    import torch
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import emb_grad_kernel as EG
    out_dir = os.path.join(ROOT, "build", "paddle_tpu_torch", "emb_probe")
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(out_dir, "emb_grad_probe.cu")
    with open(os.path.join(_build._CSRC, "emb_grad.cu")) as f:
        text = instrument(f.read())
    with open(src, "w") as f:
        f.write(text)
    lib_path = os.path.join(out_dir, "libemb_grad_probe.so")
    build = subprocess.run([_build._nvcc()] + _build.NVCC_FLAGS +
                           ["-I", _build._CSRC, "-o", lib_path, src],
                           capture_output=True, text=True)
    if build.returncode:
        print(build.stdout[-3000:] + build.stderr[-3000:], file=sys.stderr)
        return 1
    for line in (build.stdout + build.stderr).splitlines():
        if "registers" in line or "spill" in line:
            print("ptxas: " + line.strip())
    lib = ctypes.CDLL(lib_path)
    entries = {impl: getattr(lib, "emb_grad_" + impl)
               for impl in ("scatter", "segsum")}
    for f in entries.values():
        f.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + \
            [ctypes.c_void_p]
    lib.set_dbg.argtypes = [ctypes.c_void_p]
    blocks, warps = 4096, 16
    dbg = torch.zeros(blocks * warps * len(FIELDS), dtype=torch.int64,
                      device="cuda")
    assert lib.set_dbg(dbg.data_ptr()) == 0
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1234)
    vocab, dim, n = 8192, 512, 65536
    stream = torch.cuda.current_stream().cuda_stream
    for draw in ("uniform", "zipf"):
        if draw == "zipf":
            p = 1.0 / torch.arange(1, vocab + 1, dtype=torch.float64,
                                   device="cuda")
            ids = torch.multinomial(p, n, replacement=True, generator=gen)
        else:
            ids = torch.randint(0, vocab, (n,), generator=gen, device="cuda")
        dout = torch.randn(n, dim, generator=gen, device="cuda").bfloat16()
        w = torch.empty(vocab, dim, dtype=torch.bfloat16, device="cuda")
        dw = torch.empty_like(w)
        for impl, f in entries.items():
            for _ in range(3):
                dbg.zero_()
                err = f(ids.data_ptr(), dout.data_ptr(), dw.data_ptr(), n,
                        vocab, dim, 1, stream)
                if err:
                    raise RuntimeError("probe kernel: CUDA error %d" % err)
            torch.cuda.synchronize()
            d = dbg.view(blocks, warps, len(FIELDS))
            total = d[:, :, -1].max(1).values
            used = int((total > 0).sum())
            slow = int(total.argmax())
            wrapper = getattr(EG, "emb_grad_" + impl)
            print(json.dumps({
                "ids": draw, "kernel": impl, "shape": [vocab, dim, n],
                "blocks": used,
                "block_cycles_max": int(total.max()),
                "block_cycles_median": int(total[:used].median()),
                "slowest_block_warps_max": {
                    k: int(d[slow, :, i].max())
                    for i, k in enumerate(FIELDS)},
                "slowest_block_warps_min": {
                    k: int(d[slow, :, i].min())
                    for i, k in enumerate(FIELDS)},
                "wrapper_ms": _time_ms(lambda: wrapper(w, ids, dout))}))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
          else "nvidia-smi: " + smi.stderr.strip())
    return 0


def _time_ms(fn, iters=20, warmup=3):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


if __name__ == "__main__":
    sys.exit(main())
