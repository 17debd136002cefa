"""Drive the PyTorch port (paddle_tpu_torch) on one NVIDIA card.

Run from the root of a checkout, on a machine with a CUDA card and the CUDA
toolkit:

    python3 chip_smoke.py

Phases, each printing one JSON line (any failure ends the script with a
non-zero exit):

1. build    - nvcc builds the CUDA kernels from paddle_tpu_torch/ops/csrc.
2. kernels  - each kernel (attention forward and backward, fused Adam,
              cross-entropy forward and backward, LayerNorm backward, the
              two embedding-grad kernels) against its plain PyTorch version
              on the card, at the serving and training paths' shapes plus
              ragged and float32 cases, held to the elementwise bounds
              below; each attention forward and backward case names the
              CUDA kernels it launched (bfloat16 up to D = 256: the
              tensor-core *_wgmma kernels at DP = 64, 128 or 256; float32,
              and bfloat16 past D = 256: the CUDA-core ones, which split D
              into 128-column chunks: float32 at D 136, 256 and 512,
              bfloat16 at 264 and 512, each timed and with a control), and
              one line each lists them by dtype; Adam as the training step
              runs it (one launch over the flagship's 67 parameter shapes,
              p, m1 and m2 bit for bit the plain version's, with its host
              time a call); at
              the paths' shapes the bound must also reject a control (a
              plain version with the last key tile, delta, the label
              column, the ignore mask, the sum(g * xhat) term or the last
              id chunk dropped or moved, or a wrong beta2). It reports
              the kernel's, the plain version's and one PyTorch library
              call's time (scaled_dot_product_attention forward or backward,
              torch._fused_adam_, F.cross_entropy,
              native_layer_norm_backward, embedding_dense_backward:
              yardsticks only), and the least time the card could take.
              The embedding-grad kernels must equal their plain versions
              bit for bit (also on Zipf-skewed ids, timed, and on a table
              past one band a block) in one device kernel a call, counted
              in a torch.profiler trace. Shapes the kernels refuse must
              raise.
3. serve256 - the flagship Transformer (bench.py's config: vocab 8192, 4+4
              layers, 8 heads, d_model 512, d_ff 2048, bf16, random weights
              from a seed) built with is_test=True, pruned to its logits as
              save_inference_model prunes, answers 4 requests of batch 8 at
              seq 256 through Executor.run; each request must launch the
              one-pass kernel 12 times. One batch-1 request also runs on the
              CPU with the same weights, and the logits must agree.
4. serve4096 - the same weights at seq 4096 (bench.py's long-sequence
              config), batch 1; the request must launch the flash kernel 12
              times.
5. logits_control - the card-vs-CPU limits of phase 3 must reject the
              serving program with its decoder self-attention made
              non-causal.
6. train256 - the flagship training program (bench.py's training leg: the
              same config, dropout 0.1, append_backward + Adam(1e-4).minimize)
              at batch TRAIN_BATCH, seq 256: startup on the card, one warm
              step, then Executor.run_steps over 4 stacked steps. Every loss
              must be finite and each step must launch 12 one-pass forward,
              12 one-pass backward, 0 flash kernels and 1 Adam kernel that
              covers the 67 parameters the Adam kernel takes.
7. train256_kernels - train256 with FLAGS_ce_kernel=1, FLAGS_ln_kernel=1
              and FLAGS_emb_grad_kernel=scatter, then =segsum (the flags
              restored after): each step must launch, besides the attention
              and Adam kernels of train256, 1 CE forward, 1 CE backward, 20
              LayerNorm backward and 2 scatter (then 2 segsum) kernels.
8. train_parity - the same program with dropout 0, batch 2, one step on the
              card and one on the CPU from the same weights, with the flags
              off and then on (scatter, segsum): the loss and the gradients
              of a q/k weight of each attention kind, of both embeddings,
              of proj.w and of one LayerNorm scale must agree within limits
              that reject the program with its decoder self-attention made
              non-causal.
9. train4096 - the training program at seq 4096, batch 8, one warm step then
              2 steps through run_steps; each step must launch 12 flash
              forward, 12 dq, 12 dkv, 0 one-pass and 1 Adam kernel (67
              parameters).
10. train256_wide - bench.py's wide Transformer leg (d_model 2048, d_ff
              8192, 8 heads: D = 256; 4+4 layers, dropout 0.1) at batch 64,
              seq 256, one warm step then 4 steps through run_steps; each
              step must launch 12 one-pass forward, 12 one-pass backward
              and 1 Adam kernel (67 parameters).
11. train_parity_wide - train_parity's check (flags off) at the wide width,
              1+1 layers, batch 2, dropout 0.
12. bert_base - bench.py's BERT-base leg (vocab 30,522, 12 layers, 12
              heads, d_model 768, d_ff 3072, seq 128, dropout 0.1, bf16,
              Adam(1e-4)) at batch 256: one warm step, then 4 steps
              through run_steps; each step must launch 12 one-pass forward,
              12 one-pass backward and 2 Adam kernels (the 74 parameters
              the kernel takes, 72 a launch) and nothing else.
13. bert_base_kernels - bert_base with FLAGS_ce_kernel=1, FLAGS_ln_kernel=1
              and FLAGS_emb_grad_kernel=scatter: also 25 LayerNorm backward
              launches a step, and no CE or embedding-grad launch (their
              gates refuse V 30,522 and 2, and the [30522, 768] and [2, 768]
              tables).
14. bert_parity - one step of BERT at full width with 2 layers, batch 2,
              dropout 0, on the card and on the CPU, in bf16 and in f32:
              the loss and the gradients of word_emb, mlm.transform.w,
              pooler.w, an attention weight and a LayerNorm scale within
              BERT_PARITY_LIMITS, which the card's step with the masked
              positions moved one token on must break.
15. deepfm - bench.py's DeepFM leg (26 fields, vocab 100,000, embed 16, MLP
              128-64, sparse tables, Adam(1e-3)) at batch 4096: one warm
              step, then 8 steps through run_steps; each step one Adam
              launch (the [416, 128] weight), nothing else.
16. deepfm_parity - the DeepFM leg for 3 f32 steps in lockstep on the card
              and on the CPU, on batches with repeated ids: loss, AUC and
              histograms, the sparse gradients' rows and values, the MLP
              weights' gradients, Adam's moments and the parameters' change
              within the limits set out above DFM_LOSS_REL_MAX, and the
              rows no id touched to a few ulp, which the card's steps with
              the tables' adam ops in lazy mode must break.
17. momentum_group - the 161 momentum ops of bench.py's ResNet-50 leg
              through the executor's group lowering and op by op on the
              same card tensors: every ParamOut and VelocityOut bit for
              bit; the host time of each route.
18. resnet50 - bench.py's ResNet-50 leg (3x224x224, 1000 classes, bf16,
              Momentum(0.01, 0.9)) at batch 64: one warm step, then 8
              steps through run_steps; images/s, step ms, peak memory,
              model TFLOP/s from the conv and fc shapes (forward times 3),
              and no launch of any of the port's kernels.
19. resnet50_kernels - resnet50 with the three kernel flags, 2 steps: still
              no launch (the CE gate refuses V = 1000).
20. resnet_parity - bench.py's ResNet-50 program at batch 4 on 3x128x128
              images, float32 and bfloat16 from the same weights, 3 steps
              in lockstep from the CPU's state: every op of each step on
              the card from the CPU's values of its inputs within
              RESNET_OP_TOL of the CPU's outputs, and, in float32, the
              whole step's loss and named gradients and states within
              RESNET_STEP_LIMITS; controls (the unbiased running variance;
              TF32 convolutions; the is_test program) must fail.
21. inference_serve - serve256's program (batch 8, seq 256, bf16, weights
              from SEED) saved by fluid.io.save_inference_model, loaded by
              load_inference_model into a fresh Scope and by
              fluid.inference.create_paddle_predictor: the same 4 requests
              through the in-memory, loaded and predictor routes give the
              same logits bit for bit, each request 12 one-pass launches;
              save, load and request times and the artifact's bytes. Control:
              one element of proj.w changed in a copy of the artifact must
              change the logits.
22. inference_resnet50 - ResNet-50 (flowers, f32, is_test) at batch 64,
              running statistics drawn from a seeded generator, saved,
              loaded, and folded by InferenceTranspiler: all 53 batch_norm
              ops gone, the folded logits within FOLD_REL_MAX of the
              unfolded ones (top-1 agreement printed); ms and device
              kernels a batch of each (the kernels counted in a fresh
              process's torch.profiler trace). Control: fused biases that
              leave the running mean out must miss the bound.
23. checkpoint - the flagship training program (dropout 0.1) at batch 32:
              2 steps, save_checkpoint, 2 more (run A); load_checkpoint
              into a fresh Scope restores every persistable and generator
              state bit for bit, and the same 2 steps (run B) give A's
              losses within CKPT_LOSS_REL_MAX. Control: the resume without
              the generator states must miss.

The kernel cases also time rows 1, 3, 8 and 11 at BERT-base's shapes
(attention at batch 256, 12 heads, seq 128, D 64; LayerNorm on [32768,
768]; Adam over its 74 parameters in 2 launches). Then it prints the card's
name and power limit (nvidia-smi), one JSON line with every kernel's
numbers (with a "bert_base" entry where a kernel runs at BERT-base's
shapes), and last {"ok": true, "device": {...}}. It imports nothing of JAX
or of the JAX package paddle_tpu.
"""
import contextlib
import gc
import json
import os
import subprocess
import sys
import time

SEED = 1234
LONG_SEQ = 4096
REQUESTS, BATCH = 4, 8
# bench.py's BATCH and LONGSEQ_BATCH: the training legs' batches
TRAIN_BATCH, TRAIN_STEPS = 256, 4
# bench.py's WIDE_CFG_OVERRIDES and WIDE_BATCH: d_model 2048 over the
# flagship's 8 heads, so D = 256
WIDE_CFG_OVERRIDES = dict(d_model=2048, d_ff=8192)
WIDE_BATCH = 64
LONG_TRAIN_BATCH, LONG_TRAIN_STEPS = 8, 2
# bench.py's BERT and DeepFM legs: the timed steps, and bert_parity's depth
# (full width)
DEEPFM_STEPS = 8
BERT_PARITY_LAYERS = 2

# H100 SXM published dense peaks (NVIDIA data sheet)
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

# Kernel vs plain version on the same inputs, elementwise:
#     |got - want| <= rtol * |want| + atol * rms(want's row)
# where a row is one (batch, token, head)'s D outputs. bfloat16: the two
# round the same f32 sum to bf16 once, after different summation orders, so
# an element may differ by one ulp, at most 2^-7 of it. P's rounding to bf16
# (in the flash kernel per k-tile against the running max, in the plain
# version once against the row max) moves a row's f32 sums by about
# 2^-8 / sqrt(3) * sqrt(sum_j (p_j v_j)^2), which is 2^-8 / sqrt(3) times
# the row's rms; atol allows 2^-5, eight times 2^-8, for the largest of
# millions of such errors. float32 differs by summation order only.
OUT_TOL = {"bfloat16": (2.0 ** -7, 2.0 ** -5), "float32": (1e-5, 1e-5)}
# The backward kernels' gradients, by the same elementwise bound. P and dS
# round elementwise in both the kernel and its plain version, so rtol covers
# the output's rounding and atol 2^-8 the orders of its f32 sums, which
# rejects the controls by a wide margin. In bf16 the tensor cores sum S and
# dP (and the one-pass kernel its row sum l and delta = rowsum(dP o P)) in
# another order than the plain version, which can flip the bf16 rounding of
# single P and dS terms: flash_bwd_rounding_bound and
# onepass_bwd_rounding_bound add what those flips can move to the bound.
BWD_TOL = {kernel: {"bfloat16": (2.0 ** -7, 2.0 ** -8),
                    "float32": (1e-5, 1e-5)}
           for kernel in ("onepass_bwd", "flash_bwd")}
# lse (f32, O(log T_k)): rtol and an absolute atol
LSE_TOL = (1e-5, 1e-5)
# A control the bound must reject: the kernel's output against the plain
# version with the last 64-key tile dropped.
CONTROL_DROP_KEYS = 64
# Card vs CPU logits of the bf16 model (same weights, same request): the two
# devices round bf16 products and sums in different orders through 8
# layers. The limits sit between the sound reading (0.0090 relative error,
# 0.973 top-1 agreement) and that of a faulty program, the decoder's
# self-attention made non-causal (0.270, 0.469), which phase logits_control
# must reject. Both readings: NVIDIA H100 80GB HBM3, 700 W (PERF.md).
LOGITS_REL_ERR_MAX = 0.03
TOP1_AGREE_MIN = 0.93


def emit(obj):
    print(json.dumps(obj), flush=True)


def time_ms(fn, iters=20, warmup=3):
    """Mean device time of fn() over `iters` back-to-back calls (CUDA
    events)."""
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


def phase_build():
    from paddle_tpu_torch.ops import _build
    t0 = time.perf_counter()
    logs = _build.build_all()
    seconds = time.perf_counter() - t0
    for name, log in logs.items():
        with open(log) as f:
            for line in f:
                if "registers" in line or "spill" in line or "error" in line:
                    print("%s: %s" % (name, line.rstrip()), file=sys.stderr)
    emit({"phase": "build", "ok": True, "seconds": seconds,
          "libraries": sorted(logs)})


def _qkv(gen, b, t_q, t_k, h, d, dtype):
    import torch
    mk = lambda t: torch.randn(b, t, h, d, generator=gen, device="cuda",
                               dtype=torch.float32).to(dtype)
    return mk(t_q), mk(t_k), mk(t_k)


def _sdpa(q, k, v, causal):
    """PyTorch's fused attention on the same [B, T, H, D] tensors (the
    yardstick; the port never calls it)."""
    import torch
    import torch.nn.functional as F
    tr = lambda x: x.transpose(1, 2)
    t_q, t_k = q.shape[1], k.shape[1]
    if causal and t_q != t_k:
        mask = torch.ones(t_q, t_k, dtype=torch.bool,
                          device=q.device).tril(diagonal=t_k - t_q)
        return lambda: F.scaled_dot_product_attention(tr(q), tr(k), tr(v),
                                                      attn_mask=mask)
    return lambda: F.scaled_dot_product_attention(tr(q), tr(k), tr(v),
                                                  is_causal=causal)


# (kernel, B, T_q, T_k, H, D, causal, dtype, path, weight on that path):
# a case with a path is timed and enters that kernel's summary over the
# path's mix, and its bound must reject a control. The edges (D = 40 and
# 128, T not a multiple of the tiles, causal rows with no key at T_q > T_k)
# run in both dtypes: bfloat16 takes the tensor-core kernels, float32 the
# CUDA-core ones. D = 256 (bench.py's wide Transformer: d_model 2048, 8
# heads) runs in bfloat16 on the tensor cores. Past D = 128 in float32 and
# past 256 in bfloat16 the CUDA-core kernels split D into 128-column chunks
# (path "wide_d": timed, a control each, no path mix).
KERNEL_CASES = [
    ("onepass", 8, 256, 256, 8, 64, False, "bfloat16", "serve256", 8),
    ("onepass", 8, 256, 256, 8, 64, True, "bfloat16", "serve256", 4),
    ("onepass", 256, 256, 256, 8, 64, False, "bfloat16", "train256", 8),
    ("onepass", 256, 256, 256, 8, 64, True, "bfloat16", "train256", 4),
    ("onepass", 256, 128, 128, 12, 64, False, "bfloat16", "bert_base", 12),
    ("onepass", 8, 200, 256, 8, 64, True, "bfloat16", None, 0),
    ("onepass", 2, 77, 77, 2, 40, True, "float32", None, 0),
    ("onepass", 1, 130, 100, 2, 128, True, "float32", None, 0),
    ("onepass", 2, 77, 77, 2, 40, True, "bfloat16", None, 0),
    ("onepass", 1, 130, 100, 2, 128, True, "bfloat16", None, 0),
    ("onepass", 1, 512, 512, 4, 128, True, "bfloat16", None, 0),  # largest
    ("onepass", 64, 256, 256, 8, 256, False, "bfloat16", "train256_wide", 8),
    ("onepass", 64, 256, 256, 8, 256, True, "bfloat16", "train256_wide", 4),
    ("onepass", 2, 200, 232, 2, 256, True, "bfloat16", None, 0),
    ("onepass", 1, 130, 100, 2, 256, True, "bfloat16", None, 0),
    ("onepass", 1, 512, 512, 4, 256, True, "bfloat16", None, 0),
    ("flash", 1, 4096, 4096, 8, 64, False, "bfloat16", "serve4096", 8),
    ("flash", 1, 4096, 4096, 8, 64, True, "bfloat16", "serve4096", 4),
    ("flash", 8, 4096, 4096, 8, 64, False, "bfloat16", "train4096", 8),
    ("flash", 8, 4096, 4096, 8, 64, True, "bfloat16", "train4096", 4),
    ("flash", 1, 1100, 1100, 8, 64, True, "bfloat16", None, 0),
    ("flash", 1, 1030, 1100, 2, 128, False, "float32", None, 0),
    ("flash", 1, 130, 100, 2, 40, True, "float32", None, 0),
    ("flash", 2, 1000, 1100, 2, 64, True, "bfloat16", None, 0),
    ("flash", 1, 130, 100, 2, 40, True, "bfloat16", None, 0),
    ("flash", 1, 1030, 1100, 2, 128, False, "bfloat16", None, 0),
    ("flash", 2, 1100, 1000, 2, 64, True, "bfloat16", None, 0),
    ("flash", 1, 1100, 1100, 2, 256, True, "bfloat16", None, 0),
    ("flash", 1, 1030, 1100, 2, 256, False, "bfloat16", None, 0),
    ("flash", 2, 1100, 1000, 2, 256, True, "bfloat16", None, 0),
] + [(kernel, b, t, t, 4, d, causal, dtype, "wide_d", 1)
     for d, dtype in ((136, "float32"), (256, "float32"), (512, "float32"),
                      (264, "bfloat16"), (512, "bfloat16"))
     for kernel, b, t, causal in (("onepass", 2, 256, True),
                                  ("flash", 1, 1100, False))]
# the widest head dim the bf16 tensor-core kernels take; past it bf16 runs
# the CUDA-core kernels
WGMMA_MAX_D = 256


def _code_dtype(dtype, d):
    """The key of FWD_CODE_PATH and BWD_CODE_PATH for a case: the dtype,
    or "bfloat16_cuda_cores" past WGMMA_MAX_D."""
    return dtype if dtype == "float32" or d <= WGMMA_MAX_D else \
        "bfloat16_cuda_cores"


# the CUDA kernel each forward must launch (a part of the instantiation's
# name as attention.last_kernel_name() reports it)
FWD_CODE_PATH = {"bfloat16": "_wgmma<", "float32": "<float>",
                 "bfloat16_cuda_cores": "_kernel<__nv_bfloat16>"}
# the CUDA kernels each backward must launch, dq then dkv (prefixes of the
# names attention.last_bwd_kernel_name() reports: after each flash wrapper,
# and after the one-pass wrapper as "dq + dkv")
BWD_CODE_PATH = {
    "onepass_bwd": {"bfloat16": ("onepass_bwd_dq_kernel_wgmma<",
                                 "onepass_bwd_dkv_kernel_wgmma<"),
                    "float32": ("onepass_bwd_dq_kernel<float>",
                                "bwd_dkv_kernel<float, true>"),
                    "bfloat16_cuda_cores": (
                        "onepass_bwd_dq_kernel<__nv_bfloat16>",
                        "bwd_dkv_kernel<__nv_bfloat16, true>")},
    "flash_bwd": {"bfloat16": ("flash_bwd_dq_kernel_wgmma<",
                               "flash_bwd_dkv_kernel_wgmma<"),
                  "float32": ("flash_bwd_dq_kernel<float>",
                              "bwd_dkv_kernel<float, false>"),
                  "bfloat16_cuda_cores": (
                      "flash_bwd_dq_kernel<__nv_bfloat16>",
                      "bwd_dkv_kernel<__nv_bfloat16, false>")}}
# the backward's edges (D = 40 and 128, T not a multiple of the tiles,
# causal rows with no key at T_q > T_k) run in both dtypes, as the
# forward's; D = 256 in bfloat16; and the CUDA-core kernels' chunks past
# D = 128 (float32) and 256 (bfloat16), as the forward's ("wide_d")
BWD_CASES = [
    ("onepass_bwd", 256, 256, 256, 8, 64, False, "bfloat16", "train256", 8),
    ("onepass_bwd", 256, 256, 256, 8, 64, True, "bfloat16", "train256", 4),
    ("onepass_bwd", 256, 128, 128, 12, 64, False, "bfloat16", "bert_base",
     12),
    ("onepass_bwd", 8, 256, 256, 8, 64, False, "bfloat16", None, 0),
    ("onepass_bwd", 8, 256, 256, 8, 64, True, "bfloat16", None, 0),
    ("onepass_bwd", 8, 200, 256, 8, 64, True, "bfloat16", None, 0),
    ("onepass_bwd", 2, 77, 77, 2, 40, True, "float32", None, 0),
    ("onepass_bwd", 1, 130, 100, 2, 128, True, "float32", None, 0),
    ("onepass_bwd", 1, 512, 512, 4, 128, True, "bfloat16", None, 0),
    ("onepass_bwd", 2, 77, 77, 2, 40, True, "bfloat16", None, 0),
    ("onepass_bwd", 1, 130, 100, 2, 128, True, "bfloat16", None, 0),
    ("onepass_bwd", 64, 256, 256, 8, 256, False, "bfloat16", "train256_wide",
     8),
    ("onepass_bwd", 64, 256, 256, 8, 256, True, "bfloat16", "train256_wide",
     4),
    ("onepass_bwd", 2, 200, 232, 2, 256, True, "bfloat16", None, 0),
    ("onepass_bwd", 1, 130, 100, 2, 256, True, "bfloat16", None, 0),
    ("onepass_bwd", 1, 512, 512, 4, 256, True, "bfloat16", None, 0),
    ("flash_bwd", 8, 4096, 4096, 8, 64, False, "bfloat16", "train4096", 8),
    ("flash_bwd", 8, 4096, 4096, 8, 64, True, "bfloat16", "train4096", 4),
    ("flash_bwd", 1, 4096, 4096, 8, 64, False, "bfloat16", None, 0),
    ("flash_bwd", 1, 4096, 4096, 8, 64, True, "bfloat16", None, 0),
    ("flash_bwd", 1, 1100, 1100, 8, 64, True, "bfloat16", None, 0),
    ("flash_bwd", 2, 1000, 1100, 2, 64, True, "bfloat16", None, 0),
    ("flash_bwd", 1, 1030, 1100, 2, 128, False, "float32", None, 0),
    ("flash_bwd", 1, 130, 100, 2, 40, True, "float32", None, 0),
    ("flash_bwd", 1, 130, 100, 2, 40, True, "bfloat16", None, 0),
    ("flash_bwd", 2, 77, 77, 2, 40, False, "bfloat16", None, 0),
    ("flash_bwd", 1, 1030, 1100, 2, 128, False, "bfloat16", None, 0),
    ("flash_bwd", 1, 1100, 1100, 2, 128, True, "bfloat16", None, 0),
    ("flash_bwd", 2, 1100, 1000, 2, 64, True, "bfloat16", None, 0),
    ("flash_bwd", 1, 1100, 1100, 2, 256, True, "bfloat16", None, 0),
    ("flash_bwd", 1, 1030, 1100, 2, 256, False, "bfloat16", None, 0),
    ("flash_bwd", 2, 1100, 1000, 2, 256, True, "bfloat16", None, 0),
] + [(kernel, b, t, t, 4, d, causal, dtype, "wide_d", 1)
     for d, dtype in ((136, "float32"), (256, "float32"), (512, "float32"),
                      (264, "bfloat16"), (512, "bfloat16"))
     for kernel, b, t, causal in (("onepass_bwd", 2, 256, True),
                                  ("flash_bwd", 1, 1100, False))]
# the 2-D parameters of the flagship model that the fused Adam kernel takes,
# with their count per step (48 + 8 + 8 + 2 + 1 = 67), and one f32 case
ADAM_CASES = [((512, 512), "bfloat16", 48), ((512, 2048), "bfloat16", 8),
              ((2048, 512), "bfloat16", 8), ((8192, 512), "bfloat16", 2),
              ((512, 8192), "bfloat16", 1), ((16, 256), "float32", 0)]
# the 2-D parameters the kernel takes in BERT-base: the four [768, 768],
# the [768, 3072] and the [3072, 768] weights of each of the 12 layers,
# mlm.transform.w and pooler.w: 74, past the 72 one launch takes, so 2
# launches a step
BERT_ADAM_CASES = [((768, 768), "bfloat16", 50),
                   ((768, 3072), "bfloat16", 12),
                   ((3072, 768), "bfloat16", 12)]
# Adam kernel vs plain version (assert_allclose semantics, |got - want| <=
# atol + rtol*|want|): the moments at tests/test_adam_kernel.py's tolerance;
# p within one unit in the last place of its dtype
ADAM_MOMENT_TOL = (1e-5, 1e-7)
ADAM_P_RTOL = {"bfloat16": 2.0 ** -7, "float32": 2.0 ** -23}
ADAM_HPARAMS = (0.9, 0.999, 1e-8)
# shapes each kernel must refuse with an exception: (kernel, T_k, D,
# dtype): T_k past the one-pass kernels' 512, D not a multiple of 8
REJECT_CASES = [("onepass", 513, 64, "bfloat16"),
                ("flash", 1024, 12, "bfloat16"),
                ("onepass_bwd", 513, 64, "bfloat16"),
                ("flash_bwd", 1024, 12, "bfloat16")]
ADAM_REJECT_SHAPES = [(512,), (7, 128), (8, 100)]
# The flag-gated kernels, elementwise like OUT_TOL (|got - want| <= rtol *
# |want| + atol * scale). CE loss and lse (f32, O(10)): the two sum V exps
# in other orders, about 1e-7 of the sum; the bound allows 1e-5 relative and
# 1e-5 absolute (scale 1), which the label logit read from the neighbouring
# column (a change of O(1)) breaks by far. CE dlogits, LayerNorm dx: both
# round the same f32 value to bf16 after f32 sums in other orders, so an
# element may be one bf16 ulp off (2^-7 of it); atol 2^-12 of the row's rms
# covers f32 noise near zero. float32: 1e-5 and 1e-5. LayerNorm dgamma and
# dbeta (f32 sums over all rows in other orders): 1e-5 relative and 1e-5 of
# the vector's rms.
CE_LOSS_TOL = (1e-5, 1e-5)
ROW_TOL = {"bfloat16": (2.0 ** -7, 2.0 ** -12), "float32": (1e-5, 1e-5)}
LN_PARAM_TOL = (1e-5, 1e-5)
IGNORE = -100
# CE (tokens, V, dtype, path weight on train256); LN (rows, d, dtype, path,
# path weight: train256's 20 and BERT-base's 25 a step); the path cases are
# timed and must reject a control
CE_CASES = [(65536, 8192, "bfloat16", 1), (24, 384, "bfloat16", 0),
            (64, 1024, "float32", 0)]
LN_CASES = [(65536, 512, "bfloat16", "train256", 20),
            (32768, 768, "bfloat16", "bert_base", 25),
            (24, 384, "bfloat16", None, 0), (64, 1024, "float32", None, 0),
            (16, 8192, "bfloat16", None, 0)]
# embedding grad: (vocab, dim, ids, dtype, id draw, douts, path weight,
# timed). Both kernels add each row's douts in id order, as their plain
# versions do (the scatter rounding to the table dtype after every add, the
# segsum in f32, rounded once), and must equal them bit for bit in every
# case. "uniform" ids are uniform over the table; "zipf" ids take row r
# with p proportional to 1 / (r + 1) (row 0 about a tenth of them); "int"
# douts are integers in [-4, 4], "randn" standard normal. The path case is
# timed and must reject a control; the Zipf case and the [32768, 1024]
# table (the segsum past one band a block: several passes) are timed too.
# The untimed cases also hold two ids the kernels must skip.
EMB_CASES = [(8192, 512, 65536, "bfloat16", "uniform", "int", 2, True),
             (8192, 512, 65536, "bfloat16", "uniform", "randn", 0, False),
             (8192, 512, 65536, "bfloat16", "zipf", "randn", 0, True),
             (32768, 1024, 65536, "bfloat16", "uniform", "int", 0, True),
             (1024, 512, 65536, "float32", "uniform", "int", 0, False),
             (64, 128, 256, "float32", "uniform", "int", 0, False)]
# the last id chunk dropped: the embedding kernels' control
EMB_CONTROL_DROP = 512
# shapes the flag-gated kernels must refuse: CE and LN (rows, cols);
# embedding (impl, (vocab, dim), ids, dtype)
ROW_REJECT_SHAPES = [(12, 128), (16, 100)]
EMB_REJECT_CASES = [("scatter", (64, 100), 256, "float32"),
                    ("segsum", (64, 128), 100, "float32"),
                    ("scatter", (8192, 512), 65536, "float32")]
# TPU kernel each port kernel replaces
REPLACES = {
    "onepass": "paddle_tpu/ops/attention.py:123",
    "flash": "paddle_tpu/ops/attention.py:272",
    "onepass_bwd": "paddle_tpu/ops/attention.py:146",
    "flash_bwd_dq": "paddle_tpu/ops/attention.py:400",
    "flash_bwd_dkv": "paddle_tpu/ops/attention.py:447",
    "adam": "paddle_tpu/ops/adam_kernel.py:53",
    "ce_fwd": "paddle_tpu/ops/ce_kernel.py:60",
    "ce_bwd": "paddle_tpu/ops/ce_kernel.py:72",
    "ln_bwd": "paddle_tpu/ops/layernorm_kernel.py:43",
    "emb_scatter": "paddle_tpu/ops/emb_grad_kernel.py:96",
    "emb_segsum": "paddle_tpu/ops/emb_grad_kernel.py:147",
}


def err_ratio(got, want, rtol, atol, row_scale=True, bound=None):
    """max over elements of |got - want| / (rtol*|want| + atol*scale), where
    scale is the rms of want's last dim (row_scale) or 1, or over
    |got - want| / bound where an elementwise bound is given; <= 1 passes.
    An element equal to its want counts 0, also where its bound is 0 (a
    causal row whose gradient is exactly zero); one that differs where its
    bound is 0 counts 1e30, so a bound of 0 (rtol = atol = 0) asks for
    equality; a NaN in got or want counts 1e30 too."""
    import torch
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    if bound is None:
        scale = want.pow(2).mean(-1, keepdim=True).sqrt() if row_scale \
            else 1.0
        bound = rtol * want.abs() + atol * scale
    ratio = torch.nan_to_num(diff / bound, nan=1e30, posinf=1e30)
    return torch.where(diff == 0, torch.zeros_like(ratio), ratio).max().item()


def _pairs(t_q, t_k, causal):
    """Unmasked (row, col) pairs of one (batch, head)."""
    if not causal:
        return t_q * t_k
    offset = t_k - t_q
    return sum(min(t_k, max(0, r + offset + 1)) for r in range(t_q))


def _bound(flops, nbytes, itemsize):
    peak = PEAK_BF16_FLOPS if itemsize == 2 else PEAK_F32_FLOPS
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def bwd_bound_ms(part, b, t_q, t_k, h, d, causal, itemsize):
    """Least time of one backward call. Operations per unmasked pair: 10*D
    one-pass (S, dP, dQ, dK, dV), 6*D flash dq (S, dP, dQ), 8*D flash dkv
    (S, dP, dK, dV). Bytes: each input read once, each output written
    once (q, k, v, dO; lse and delta f32 for flash; dq, dk, dv)."""
    per_pair, rows_q, rows_k, f32_rows = {
        "onepass_bwd": (10, 3, 4, 0), "flash_bwd_dq": (6, 3, 2, 2),
        "flash_bwd_dkv": (8, 2, 4, 2)}[part]
    flops = per_pair * d * b * h * _pairs(t_q, t_k, causal)
    nbytes = itemsize * b * h * d * (rows_q * t_q + rows_k * t_k) + \
        4 * f32_rows * b * t_q * h
    return _bound(flops, nbytes, itemsize)


def _bf16_flip(x, eps):
    """Elementwise: how far the bf16 rounding of an f32 value within eps of
    x can lie from that of x. Rounding is monotone, so the two differ only
    where a rounding midpoint lies within eps of x, and then by at most
    eps plus one bf16 ulp of |x| + eps; elsewhere they are equal."""
    import torch
    a = x.abs()
    ulp = lambda y: torch.ldexp(torch.ones_like(y), torch.frexp(y)[1] - 8)
    # the place of a within its bf16 ulp (the low 16 bits of its f32 bits)
    frac = (a.view(torch.int32) & 0xFFFF).float() / 65536.0
    dist = torch.where(a == 0, torch.zeros_like(a), (frac - 0.5).abs() * ulp(a))
    return torch.where(dist <= eps, eps + ulp(a + eps), torch.zeros_like(a))


def flash_bwd_rounding_bound(A, q, k, v, do, out, lse, causal):
    """Elementwise bound on what the orders of the f32 sums in S, dP and
    delta can move the bf16 flash backward's dq, dk and dv, as (e_dq, e_dk,
    e_dv): its bound is BWD_TOL's plus these (float32 rounds neither P nor
    dS, and keeps BWD_TOL's alone).

    Two implementations with the Pallas kernels' rounding points (the CUDA
    kernel on the tensor cores, the plain version through cuBLAS, the Pallas
    kernel through XLA) sum S = Q K^T, dP = dO V^T and delta = rowsum(dO o O),
    D exact products of bf16 values each, in other orders. A sum of D terms
    in f32 in any order lies within D 2^-24 sum_d |a_d b_d| of the exact sum
    (the tensor cores' D / 16 steps, each truncating to 2^-23, inside it), so
    the two sums differ by at most err = D 2^-23 sum_d |a_d b_d|: err_S for
    S, err_dP for dP - delta (both sums' err). Then:
    - P = exp(S scale - lse) differs by a relative err_P = scale err_S +
      2^-22 (|S scale| + |lse|) + 2^-20: the roundings of the argument on
      both sides (the kernel's in base 2: scale log2 e, lse log2 e, one
      multiply-add) and the exponentials' errors (exp's few ulps,
      ex2.approx's 2^-22);
    - the unrounded dS = P (dP - delta) scale differs by err_dS =
      scale (P err_dP + err_P P |dP - delta|) + 2^-22 |dS| (its roundings).
    Both are rounded to bf16 before their products, and a rounded term
    differs only where a bf16 rounding midpoint lies within its err
    (_bf16_flip): rarely for a normal term, which then moves by one bf16
    ulp, but always in a row that sees one key, whose P is 1 and whose dS is
    f32 noise (dP equals delta but for rounding). dq_d = sum_j dS_j K_jd,
    dk_d = sum_q dS_qj Q_qd and dv_d = sum_q P_qj dO_qd then move by at most
    the same sums over those moves times |K|, |Q| and |dO|, times 1 + 2^-6
    for the output's own bf16 rounding. Masked pairs and keyless rows are
    exact in both (dS = 0, P = 1/T_k). Taken one batch element at a time,
    to keep the [H, T_q, T_k] f32 temporaries small."""
    return _bwd_rounding_bound(A, q, k, v, do, causal, out, lse)


def onepass_bwd_rounding_bound(A, q, k, v, do, causal):
    """flash_bwd_rounding_bound's elementwise bound for the bf16 one-pass
    backward, (e_dq, e_dk, e_dv), whose P and delta come from statistics
    that each implementation computes itself: P = exp(S scale - m) / l with
    m the row max and l = sum_j exp(S_j scale - m), and delta = rowsum(dP o
    P) from that P (the kernel: m and l online, delta online as sum dP
    2^(S' - m) rescaled with m and divided by l at the end).

    The extension, with e_j = scale err_S_j (flash_bwd_rounding_bound's
    err_S of each score):
    - P_j = exp(s_j) / sum_i exp(s_i) does not move with m but for the
      roundings of s - m, so moving every s_i by at most e_i moves log P_j
      by at most e_j + sum_i P_i e_i (the log of the sum moves by the
      P-weighted mean of the moves); l's own sum of T_k positive terms in
      another order adds T_k 2^-23, the divide (or multiply by 1 / l) one
      more rounding. So err_P = e_j + sum_i P_i e_i + T_k 2^-23 +
      2^-22 (|S scale| + |m|) + 2^-20, the last two terms as for flash.
    - delta = sum_j dP_j P_j moves by err_delta = sum_j P_j (err_dP_j +
      |dP_j| err_P_j) + T_k 2^-23 sum_j |dP_j| P_j (the orders of its own
      sum of T_k terms, the online rescales included), where err_dP_j is
      dP's own err; dP - delta then moves by err_dP_j + err_delta in place
      of flash's err_dP + delta's D-term err.
    The rest is flash_bwd_rounding_bound's: the flips of bf16 P and dS,
    carried through dq, dk and dv."""
    return _bwd_rounding_bound(A, q, k, v, do, causal)


def _bwd_rounding_bound(A, q, k, v, do, causal, out=None, lse=None):
    """The two bounds above: flash where out and lse are given, else
    one-pass."""
    import torch
    scale = A._scale_of(q, None)
    gamma = q.shape[-1] * 2.0 ** -23
    t_k = k.shape[1]
    ein = torch.einsum
    e_dq, e_dk, e_dv = (torch.zeros(x.shape, dtype=torch.float32,
                                    device=x.device) for x in (q, k, v))
    exact = A._masked(q, k, causal) | A._keyless(q, k, causal)
    for b in range(q.shape[0]):
        qb, kb, vb, dob = (x[b:b + 1].float() for x in (q, k, v, do))
        s = A._scores(qb, kb, causal, scale)
        e_s = gamma * scale * ein("bqhd,bkhd->bhqk", qb.abs(), kb.abs())
        dp = ein("bqhd,bkhd->bhqk", dob, vb)
        e_dp = gamma * ein("bqhd,bkhd->bhqk", dob.abs(), vb.abs())
        if lse is not None:
            ob = out[b:b + 1].float()
            lb = lse[b:b + 1].permute(0, 2, 1)[..., None]
            p = A._flash_p(qb, kb, lse[b:b + 1], causal, scale)
            rel_p = e_s + 2.0 ** -22 * (s.abs() + lb.abs()) + 2.0 ** -20
            dp -= A.flash_delta(ob, dob).permute(0, 2, 1)[..., None]
            e_dp += gamma * (dob * ob).abs().sum(-1).permute(0, 2, 1)[
                ..., None]
        else:
            m = s.amax(dim=-1, keepdim=True)
            p = torch.exp(s - m)
            p /= p.sum(dim=-1, keepdim=True)
            rel_p = e_s + (p * e_s).sum(-1, keepdim=True) + \
                t_k * 2.0 ** -23 + 2.0 ** -22 * (s.abs() + m.abs()) + \
                2.0 ** -20
            pdp = p * dp.abs()
            e_delta = (p * e_dp + pdp * rel_p).sum(-1, keepdim=True) + \
                t_k * 2.0 ** -23 * pdp.sum(-1, keepdim=True)
            del pdp
            dp -= (dp * p).sum(-1, keepdim=True)
            e_dp += e_delta
            del e_delta, m
        del s, e_s
        ds = p * dp * scale
        e_ds = scale * (p * e_dp + rel_p * p * dp.abs()) + \
            2.0 ** -22 * ds.abs()
        del dp, e_dp
        f_ds = _bf16_flip(ds, e_ds).masked_fill_(exact, 0.0)
        del ds, e_ds
        f_p = _bf16_flip(p, rel_p * p).masked_fill_(exact, 0.0)
        del p, rel_p
        e_dq[b:b + 1] = ein("bhqk,bkhd->bqhd", f_ds, kb.abs())
        e_dk[b:b + 1] = ein("bhqk,bqhd->bkhd", f_ds, qb.abs())
        e_dv[b:b + 1] = ein("bhqk,bqhd->bkhd", f_p, dob.abs())
        del f_p, f_ds
    return tuple(e * (1 + 2.0 ** -6) for e in (e_dq, e_dk, e_dv))


def bwd_bound(want, rtol, atol, extra=None):
    """The elementwise bound rtol |want| + atol rms(want's row) (+ extra)."""
    bound = rtol * want.float().abs() + \
        atol * want.float().pow(2).mean(-1, keepdim=True).sqrt()
    return bound if extra is None else bound + extra


def _sdpa_bwd(q, k, v, do, causal):
    """PyTorch's fused attention backward on the same tensors (the
    yardstick; the port never calls it): one autograd.grad of an SDPA
    output, computing dq, dk and dv."""
    import torch
    import torch.nn.functional as F
    tr = lambda x: x.transpose(1, 2)
    leaves = [tr(x).detach().requires_grad_(True) for x in (q, k, v)]
    t_q, t_k = q.shape[1], k.shape[1]
    if causal and t_q != t_k:
        mask = torch.ones(t_q, t_k, dtype=torch.bool,
                          device=q.device).tril(diagonal=t_k - t_q)
        out = F.scaled_dot_product_attention(*leaves, attn_mask=mask)
    else:
        out = F.scaled_dot_product_attention(*leaves, is_causal=causal)
    g = tr(do)
    return lambda: torch.autograd.grad(out, leaves, g, retain_graph=True)


def _summary_add(summary, key, path, weight, rec, bound_by):
    s = summary.setdefault((key, path), dict(
        weight=0.0, kernel_ms=0.0, plain_ms=0.0, library_ms=0.0,
        bound_ms=0.0, ops_bound_ms=0.0, library=True))
    s["weight"] += weight
    for k in ("kernel_ms", "plain_ms", "bound_ms"):
        s[k] += weight * rec[k]
    if rec.get("library_ms") is None:
        s["library"] = False
    else:
        s["library_ms"] += weight * rec["library_ms"]
    if bound_by == "operations":
        s["ops_bound_ms"] += weight * rec["bound_ms"]


def _fwd_cases(A, gen, summary, max_err, failed):
    """Returns {kernel: {dtype: sorted names of the CUDA kernels run}}."""
    import torch
    wrappers = {"onepass": (A.onepass_attention_fwd_bthd,
                            A.onepass_attention_fwd_plain),
                "flash": (A.flash_attention_fwd_bthd,
                          A.flash_attention_fwd_plain)}
    paths = {}
    for kernel, b, t_q, t_k, h, d, causal, dtype, path, weight in \
            KERNEL_CASES:
        tdtype = getattr(torch, dtype)
        q, k, v = _qkv(gen, b, t_q, t_k, h, d, tdtype)
        fn, plain = wrappers[kernel]
        launches0 = fn.launches
        got = fn(q, k, v, causal)
        cuda_kernel = A.last_kernel_name()
        want = plain(q, k, v, causal)
        torch.cuda.synchronize()
        rec = {"phase": "kernels", "kernel": kernel,
               "shape": [b, t_q, t_k, h, d], "causal": causal,
               "dtype": dtype, "path": path, "tol": OUT_TOL[dtype],
               "cuda_kernel": cuda_kernel}
        paths.setdefault(kernel, {}).setdefault(dtype, set()).add(
            cuda_kernel)
        if kernel == "flash":
            (got, got_lse), (want, want_lse) = got, want
            rec["lse_err_ratio"] = err_ratio(got_lse, want_lse, *LSE_TOL,
                                             row_scale=False)
            rec["lse_max_abs_err"] = (got_lse - want_lse).abs().max().item()
        rec["launches"] = fn.launches - launches0
        rec["err_ratio"] = err_ratio(got, want, *OUT_TOL[dtype])
        rec["max_abs_err"] = (got.float() - want.float()).abs().max().item()
        rec["ok"] = rec["err_ratio"] <= 1 and \
            rec.get("lse_err_ratio", 0.0) <= 1 and \
            bool(torch.isfinite(got.float()).all()) and \
            (kernel != "flash" or bool(torch.isfinite(got_lse).all())) and \
            FWD_CODE_PATH[_code_dtype(dtype, d)] in cuda_kernel
        del want
        if weight:
            drop = slice(0, t_k - CONTROL_DROP_KEYS)
            wrong = plain(q, k[:, drop].contiguous(), v[:, drop].contiguous(),
                          causal)
            wrong = wrong[0] if kernel == "flash" else wrong
            rec["control_err_ratio"] = err_ratio(got, wrong, *OUT_TOL[dtype])
            rec["ok"] = rec["ok"] and rec["control_err_ratio"] > 1
            del wrong
            bound, by = _bound(
                4.0 * b * h * d * _pairs(t_q, t_k, causal),
                q.element_size() * b * h * d * (2 * t_q + 2 * t_k) +
                (4 * b * t_q * h if kernel == "flash" else 0),
                q.element_size())
            rec.update(kernel_ms=time_ms(lambda: fn(q, k, v, causal)),
                       plain_ms=time_ms(lambda: plain(q, k, v, causal),
                                        iters=5),
                       library_ms=time_ms(_sdpa(q, k, v, causal)),
                       bound_ms=bound, bound_by=by)
            _summary_add(summary, kernel, path, weight, rec, by)
        if dtype == "bfloat16":
            max_err[kernel] = max(max_err.get(kernel, 0.0),
                                  rec["max_abs_err"])
        emit(rec)
        if not rec["ok"]:
            failed.append(rec)
        del q, k, v, got
    return {kernel: {dtype: sorted(names) for dtype, names in by.items()}
            for kernel, by in paths.items()}


def _onepass_bwd_no_delta(A, q, k, v, do, causal):
    """Control: the one-pass backward's plain version with delta dropped."""
    import torch
    scale = A._scale_of(q, None)
    s = A._scores(q, k, causal, scale)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    ds = A._ds(p, dp, 0.0, A._masked(q, k, causal), scale, q.dtype)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.float(), k.float()).to(q.dtype)
    return (dq,) + A._dkv(q, do, p, ds, k, v)


def _bwd_cases(A, gen, summary, max_err, failed):
    """Returns {kernel: {dtype: sorted names of the CUDA kernels run}}."""
    import torch
    paths = {}
    for kernel, b, t_q, t_k, h, d, causal, dtype, path, weight in BWD_CASES:
        tdtype = getattr(torch, dtype)
        q, k, v = _qkv(gen, b, t_q, t_k, h, d, tdtype)
        do = torch.randn(q.shape, generator=gen, device="cuda").to(tdtype)
        rtol, atol = BWD_TOL[kernel][dtype]
        rec = {"phase": "kernels", "kernel": kernel,
               "shape": [b, t_q, t_k, h, d], "causal": causal,
               "dtype": dtype, "path": path, "tol": [rtol, atol]}
        names = ("dq", "dk", "dv")
        if kernel == "onepass_bwd":
            fn = A.onepass_attention_bwd_bthd
            before = fn.launches
            got = fn(q, k, v, do, causal)
            rec["cuda_kernel"] = A.last_bwd_kernel_name().split(" + ")
            want = A.onepass_attention_bwd_plain(q, k, v, do, causal)
            rec["launches"] = fn.launches - before
            parts = {"onepass_bwd": (lambda: fn(q, k, v, do, causal),
                                     lambda: A.onepass_attention_bwd_plain(
                                         q, k, v, do, causal))}
        else:
            out, lse = A.flash_attention_fwd_bthd(q, k, v, causal)
            delta = A.flash_delta(out, do)
            before = (A.flash_attention_bwd_dq.launches,
                      A.flash_attention_bwd_dkv.launches)
            got = (A.flash_attention_bwd_dq(q, k, v, do, lse, delta, causal),)
            cuda_kernels = [A.last_bwd_kernel_name()]
            got += A.flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal)
            cuda_kernels.append(A.last_bwd_kernel_name())
            rec["cuda_kernel"] = cuda_kernels
            rec["launches"] = [A.flash_attention_bwd_dq.launches - before[0],
                               A.flash_attention_bwd_dkv.launches - before[1]]
            want = (A.flash_attention_bwd_dq_plain(q, k, v, do, lse, delta,
                                                   causal),) + \
                A.flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta,
                                                causal)
            parts = {
                "flash_bwd_dq": (
                    lambda: A.flash_attention_bwd_dq(q, k, v, do, lse, delta,
                                                     causal),
                    lambda: A.flash_attention_bwd_dq_plain(
                        q, k, v, do, lse, delta, causal)),
                "flash_bwd_dkv": (
                    lambda: A.flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                                      causal),
                    lambda: A.flash_attention_bwd_dkv_plain(
                        q, k, v, do, lse, delta, causal))}
        for name in rec["cuda_kernel"]:
            paths.setdefault(kernel, {}).setdefault(dtype, set()).add(name)
        # the bf16 bound: BWD_TOL's plus what the orders of the f32 sums in
        # S, dP, delta (and the one-pass kernel's l) can flip
        flips = dtype == "bfloat16"
        if not flips:
            extra = (None,) * 3
        elif kernel == "onepass_bwd":
            extra = onepass_bwd_rounding_bound(A, q, k, v, do, causal)
        else:
            extra = flash_bwd_rounding_bound(A, q, k, v, do, out, lse, causal)
        torch.cuda.synchronize()
        rec["err_ratio"] = {
            n: err_ratio(g, w, 0, 0, bound=bwd_bound(w, rtol, atol, e))
            for n, g, w, e in zip(names, got, want, extra)}
        if flips:
            rec["err_ratio_without_flips"] = {
                n: err_ratio(g, w, rtol, atol)
                for n, g, w in zip(names, got, want)}
        rec["max_abs_err"] = {n: (g.float() - w.float()).abs().max().item()
                              for n, g, w in zip(names, got, want)}
        want_names = BWD_CODE_PATH[kernel][_code_dtype(dtype, d)]
        rec["ok"] = max(rec["err_ratio"].values()) <= 1 and \
            all(bool(torch.isfinite(g.float()).all()) for g in got) and \
            len(rec["cuda_kernel"]) == len(want_names) and \
            all(n.startswith(p) for n, p in zip(rec["cuda_kernel"],
                                                want_names))
        del want
        if weight:
            # controls: delta dropped (dq, dk), the last key tile dropped (dv)
            drop = slice(0, t_k - CONTROL_DROP_KEYS)
            kd, vd = k[:, drop].contiguous(), v[:, drop].contiguous()
            if kernel == "onepass_bwd":
                wrong = _onepass_bwd_no_delta(A, q, k, v, do, causal)[:2]
                wrong_dv = A.onepass_attention_bwd_plain(q, kd, vd, do,
                                                         causal)[2]
            else:
                zero = torch.zeros_like(delta)
                wrong = (A.flash_attention_bwd_dq_plain(
                    q, k, v, do, lse, zero, causal),
                    A.flash_attention_bwd_dkv_plain(
                        q, k, v, do, lse, zero, causal)[0])
                out_d, lse_d = A.flash_attention_fwd_plain(q, kd, vd, causal)
                wrong_dv = A.flash_attention_bwd_dkv_plain(
                    q, kd, vd, do, lse_d, A.flash_delta(out_d, do),
                    causal)[1]
                del out_d, lse_d, zero
            e_dv = extra[2] if extra[2] is None else extra[2][:, drop]
            rec["control_err_ratio"] = {
                n: err_ratio(g, w, 0, 0, bound=bwd_bound(w, rtol, atol, e))
                for n, g, w, e in (("dq", got[0], wrong[0], extra[0]),
                                   ("dk", got[1], wrong[1], extra[1]),
                                   ("dv", got[2][:, drop], wrong_dv, e_dv))}
            rec["ok"] = rec["ok"] and \
                min(rec["control_err_ratio"].values()) > 1
            del wrong, wrong_dv, kd, vd
            lib = _sdpa_bwd(q, k, v, do, causal)
            rec["library_ms"] = time_ms(lib, iters=10)
            del lib
            for part, (kfn, pfn) in parts.items():
                bound, by = bwd_bound_ms(part, b, t_q, t_k, h, d, causal,
                                         q.element_size())
                prec = {"kernel_ms": time_ms(kfn, iters=10),
                        "plain_ms": time_ms(pfn, iters=3, warmup=1),
                        "bound_ms": bound, "bound_by": by,
                        # SDPA's backward computes dq, dk and dv together:
                        # a yardstick for the one-pass kernel, and for the
                        # flash pair only summed (per-case line, PERF.md)
                        "library_ms": rec["library_ms"]
                        if part == "onepass_bwd" else None}
                rec[part] = prec
                _summary_add(summary, part, path, weight, prec, by)
        if dtype == "bfloat16":
            err = max(rec["max_abs_err"].values())
            for part in (("onepass_bwd",) if kernel == "onepass_bwd" else
                         ("flash_bwd_dq", "flash_bwd_dkv")):
                max_err[part] = max(max_err.get(part, 0.0), err)
        emit(rec)
        if not rec["ok"]:
            failed.append(rec)
        del q, k, v, do, got, parts, extra
        if kernel == "flash_bwd":
            del out, lse, delta
        torch.cuda.empty_cache()
    return {kernel: {dtype: sorted(names) for dtype, names in by.items()}
            for kernel, by in paths.items()}


def _adam_close(x, y, rtol, atol):
    return bool(((x.float() - y.float()).abs() <=
                 atol + rtol * y.float().abs()).all())


def _adam_cases(K, gen, max_err, failed):
    """adam_update (a one-entry call of the multi-tensor kernel) on each
    shape against its plain version; at the path's shapes its bound must
    reject a control (a wrong beta2)."""
    import torch
    b1, b2, eps = ADAM_HPARAMS
    for shape, dtype, weight in ADAM_CASES:
        tdtype = getattr(torch, dtype)
        rnd = lambda: torch.randn(shape, generator=gen, device="cuda")
        p, g = rnd().to(tdtype), rnd().to(tdtype)
        m1, m2 = rnd() * 0.1, rnd().abs() * 0.1
        lr_t = torch.tensor(0.003, device="cuda")
        want = K.adam_update_plain(p, g, m1, m2, lr_t, b1, b2, eps)
        before = K.adam_update.launches
        got = K.adam_update(p.clone(), g, m1.clone(), m2.clone(), lr_t,
                            b1, b2, eps)
        torch.cuda.synchronize()
        rtol, atol = ADAM_MOMENT_TOL
        rec = {"phase": "kernels", "kernel": "adam", "shape": list(shape),
               "dtype": dtype, "launches": K.adam_update.launches - before,
               "p_elements_differing": int((got[0] != want[0]).sum()),
               "m1_elements_differing": int((got[1] != want[1]).sum()),
               "m2_elements_differing": int((got[2] != want[2]).sum()),
               "max_abs_err": max((x.float() - y.float()).abs().max().item()
                                  for x, y in zip(got, want))}
        rec["ok"] = _adam_close(got[0], want[0], ADAM_P_RTOL[dtype], 0.0) \
            and _adam_close(got[1], want[1], rtol, atol) and \
            _adam_close(got[2], want[2], rtol, atol)
        if weight:
            # control: the plain update with a wrong beta2
            wrong = K.adam_update_plain(p, g, m1, m2, lr_t, b1, 0.99, eps)
            rec["control_rejected"] = not _adam_close(got[2], wrong[2], rtol,
                                                      atol)
            rec["ok"] = rec["ok"] and rec["control_rejected"]
            del wrong
        if dtype == "bfloat16":
            max_err["adam"] = max(max_err.get("adam", 0.0),
                                  rec["max_abs_err"])
        emit(rec)
        if not rec["ok"]:
            failed.append(rec)


def _adam_multi_case(K, gen, summary, max_err, failed, cases=ADAM_CASES,
                     path="train"):
    """A training step's update: one adam_update_multi call over the
    admitted parameter shapes of `cases` (the flagship's 67 by default, one
    launch; BERT-base's 74, two launches of up to 72), each with its own
    lr_t, bit for bit the plain version's p, m1 and m2, and a wrong beta2
    rejected. Timed: the call on the card (CUDA events), the wrapper's host
    time a call (the card's queue never full), the plain version, and one
    torch._fused_adam_ call on the same tensors as float32 lists."""
    import torch
    b1, b2, eps = ADAM_HPARAMS
    shapes = [(shape, dtype) for shape, dtype, n in cases
              for _ in range(n)]
    rnd = lambda shape: torch.randn(shape, generator=gen, device="cuda")
    ps = [rnd(shape).to(getattr(torch, dtype)) for shape, dtype in shapes]
    gs = [rnd(p.shape).to(p.dtype) for p in ps]
    m1s = [rnd(p.shape) * 0.1 for p in ps]
    m2s = [rnd(p.shape).abs() * 0.1 for p in ps]
    lr_ts = [torch.full((1,), 0.003 * (1 + i / len(ps)), device="cuda")
             for i in range(len(ps))]
    want = K.adam_update_multi_plain(ps, gs, m1s, m2s, lr_ts, b1, b2, eps)
    got = [[t.clone() for t in ts] for ts in (ps, m1s, m2s)]
    before = K.adam_update_multi.launches
    K.adam_update_multi(got[0], gs, got[1], got[2], lr_ts, b1, b2, eps)
    torch.cuda.synchronize()
    rec = {"phase": "kernels", "kernel": "adam_multi", "tensors": len(ps),
           "elements": sum(p.numel() for p in ps), "path": path,
           "launches": K.adam_update_multi.launches - before,
           "last_tensors": K.adam_update_multi.last_tensors}
    for i, name in enumerate(("p", "m1", "m2")):
        rec[name + "_elements_differing"] = sum(
            int((x != w[i]).sum()) for x, w in zip(got[i], want))
    rec["max_abs_err"] = max((x.float() - w[i].float()).abs().max().item()
                             for i in range(3) for x, w in zip(got[i], want))
    # control: the plain update with a wrong beta2
    rtol, atol = ADAM_MOMENT_TOL
    wrong = K.adam_update_multi_plain(ps, gs, m1s, m2s, lr_ts, b1, 0.99, eps)
    rec["control_rejected"] = not all(_adam_close(x, w[2], rtol, atol)
                                      for x, w in zip(got[2], wrong))
    del wrong, want
    rec["ok"] = rec["launches"] == -(-len(ps) // K._MAX_TENSORS) and \
        rec["last_tensors"] == len(ps) and \
        rec["p_elements_differing"] == rec["m1_elements_differing"] == \
        rec["m2_elements_differing"] == 0 and rec["control_rejected"]
    # bytes: p, g, m1, m2 read, p, m1, m2 written; about 12 f32 operations
    # an element
    nbytes = sum(p.numel() * (2 * p.element_size() + g.element_size() + 16)
                 for p, g in zip(ps, gs))
    bound, by = _bound(12.0 * rec["elements"], nbytes, 4)
    run = lambda: K.adam_update_multi(got[0], gs, got[1], got[2], lr_ts, b1,
                                      b2, eps)
    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        run()
    host_ms = (time.perf_counter() - t0) * 1e3 / 10
    f32 = [[x.float() for x in xs] for xs in (ps, gs, m1s, m2s)]
    steps = [torch.ones((), device="cuda") for _ in ps]
    rec.update(
        kernel_ms=time_ms(run), host_ms=host_ms,
        plain_ms=time_ms(lambda: K.adam_update_multi_plain(
            ps, gs, m1s, m2s, lr_ts, b1, b2, eps), iters=3, warmup=1),
        library="one torch._fused_adam_ call on the %d tensors as float32 "
        "lists" % len(ps),
        library_ms=time_ms(lambda: torch._fused_adam_(
            *f32, [], steps, lr=1e-4, beta1=b1, beta2=b2, weight_decay=0.0,
            eps=eps, amsgrad=False, maximize=False)),
        bound_ms=bound, bound_by=by)
    _summary_add(summary, "adam", path, 1, rec, by)
    summary[("adam", path)]["host_ms"] = host_ms
    max_err["adam"] = max(max_err.get("adam", 0.0), rec["max_abs_err"])
    emit(rec)
    if not rec["ok"]:
        failed.append(rec)
    del ps, gs, m1s, m2s, lr_ts, got, f32
    torch.cuda.empty_cache()


def _ce_inputs(gen, t, v, dtype):
    """Logits, int64 labels (the ignore index, V and -1 on three rows of
    every 64, uniform elsewhere), f32 dloss, and the mask of those rows."""
    import torch
    logits = (torch.randn(t, v, generator=gen, device="cuda") * 2).to(dtype)
    label = torch.randint(0, v, (t,), generator=gen, device="cuda")
    label[0::64], label[1::64], label[2::64] = IGNORE, v, -1
    dloss = torch.rand(t, generator=gen, device="cuda")
    masked = (label == IGNORE) | (label < 0) | (label >= v)
    return logits, label, dloss, masked


def _ce_bwd_unmasked(logits, label, lse, dloss):
    """Control: the CE backward's plain version with the ignore mask
    dropped."""
    import torch
    v = logits.shape[1]
    onehot = torch.arange(v, device=logits.device) == label[:, None]
    return ((torch.exp(logits.float() - lse[:, None]) - onehot.float()) *
            dloss[:, None]).to(logits.dtype)


def _ce_cases(CE, gen, summary, max_err, failed):
    import torch
    import torch.nn.functional as F
    for t, v, dtype, weight in CE_CASES:
        logits, label, dloss, masked = _ce_inputs(gen, t, v,
                                                  getattr(torch, dtype))
        before = (CE.ce_forward.launches, CE.ce_backward.launches)
        loss, lse = CE.ce_forward(logits, label, IGNORE)
        dl = CE.ce_backward(logits, label, lse, dloss, IGNORE)
        want_loss, want_lse = CE.ce_forward_plain(logits, label, IGNORE)
        want_dl = CE.ce_backward_plain(logits, label, lse, dloss, IGNORE)
        torch.cuda.synchronize()
        rtol, atol = ROW_TOL[dtype]
        path = "train256" if weight else None
        fwd = {"phase": "kernels", "kernel": "ce_fwd", "shape": [t, v],
               "dtype": dtype, "path": path, "tol": CE_LOSS_TOL,
               "masked_rows": int(masked.sum()),
               "launches": CE.ce_forward.launches - before[0],
               "err_ratio": max(
                   err_ratio(loss, want_loss, *CE_LOSS_TOL, row_scale=False),
                   err_ratio(lse, want_lse, *CE_LOSS_TOL, row_scale=False)),
               "max_abs_err": max((loss - want_loss).abs().max().item(),
                                  (lse - want_lse).abs().max().item())}
        fwd["ok"] = fwd["err_ratio"] <= 1 and \
            bool(torch.isfinite(lse).all()) and \
            bool(torch.isfinite(loss).all()) and \
            bool((loss[masked] == 0).all())
        bwd = {"phase": "kernels", "kernel": "ce_bwd", "shape": [t, v],
               "dtype": dtype, "path": path, "tol": [rtol, atol],
               "launches": CE.ce_backward.launches - before[1],
               "err_ratio": err_ratio(dl, want_dl, rtol, atol),
               "max_abs_err": (dl.float() - want_dl.float()).abs().max()
               .item()}
        bwd["ok"] = bwd["err_ratio"] <= 1 and \
            bool(torch.isfinite(dl.float()).all()) and \
            bool((dl[masked] == 0).all())
        del want_dl, want_loss, want_lse
        if weight:
            # controls: the label logit read from the neighbouring column;
            # the ignore mask dropped
            shifted = torch.where(masked, label, (label + 1) % v)
            wrong = CE.ce_forward_plain(logits, shifted, IGNORE)[0]
            fwd["control_err_ratio"] = err_ratio(loss, wrong, *CE_LOSS_TOL,
                                                 row_scale=False)
            wrong = _ce_bwd_unmasked(logits, label, lse, dloss)
            bwd["control_err_ratio"] = err_ratio(dl, wrong, rtol, atol)
            del wrong, shifted
            for rec in (fwd, bwd):
                rec["ok"] = rec["ok"] and rec["control_err_ratio"] > 1
            # bytes: logits (and dlogits) once, label int64, lse/loss/dloss
            # f32; operations: a handful of f32 ones per logit
            n, isz = t * v, logits.element_size()
            lib_label = torch.where(masked, torch.full_like(label, IGNORE),
                                    label)
            leaf = logits.detach().requires_grad_(True)
            g = dloss.to(logits.dtype)
            bound, by = _bound(4.0 * n, n * isz + t * 16, 4)
            fwd.update(
                kernel_ms=time_ms(lambda: CE.ce_forward(logits, label,
                                                        IGNORE)),
                plain_ms=time_ms(lambda: CE.ce_forward_plain(
                    logits, label, IGNORE), iters=3, warmup=1),
                library="F.cross_entropy(reduction='none')",
                library_ms=time_ms(lambda: F.cross_entropy(
                    logits, lib_label, ignore_index=IGNORE,
                    reduction="none")),
                bound_ms=bound, bound_by=by)
            bound, by = _bound(5.0 * n, 2 * n * isz + t * 16, 4)
            bwd.update(
                kernel_ms=time_ms(lambda: CE.ce_backward(
                    logits, label, lse, dloss, IGNORE)),
                plain_ms=time_ms(lambda: CE.ce_backward_plain(
                    logits, label, lse, dloss, IGNORE), iters=3, warmup=1),
                # no PyTorch call computes the backward alone
                library_ms=None,
                library_fwd_bwd_ms=time_ms(lambda: torch.autograd.grad(
                    F.cross_entropy(leaf, lib_label, ignore_index=IGNORE,
                                    reduction="none"), leaf, g)),
                bound_ms=bound, bound_by=by)
            _summary_add(summary, "ce_fwd", path, weight, fwd,
                         fwd["bound_by"])
            _summary_add(summary, "ce_bwd", path, weight, bwd,
                         bwd["bound_by"])
            del leaf, lib_label, g
        for rec in (fwd, bwd):
            if dtype == "bfloat16":
                max_err[rec["kernel"]] = max(max_err.get(rec["kernel"], 0.0),
                                             rec["max_abs_err"])
            emit(rec)
            if not rec["ok"]:
                failed.append(rec)
        del logits, label, dloss, masked, loss, lse, dl
        torch.cuda.empty_cache()


LN_EPS = 1e-5


def _ln_dx_no_s2(x, dy, gamma, eps):
    """Control: the LayerNorm backward's dx with the sum(g * xhat) term
    dropped."""
    import torch
    xf, dyf = x.float(), dy.float()
    mean = xf.mean(dim=1, keepdim=True)
    cx = xf - mean
    rstd = torch.rsqrt((cx * cx).mean(dim=1, keepdim=True) + eps)
    g = dyf * gamma
    return (rstd * (g - g.sum(dim=1, keepdim=True) / x.shape[1])).to(x.dtype)


def _ln_cases(LN, gen, summary, max_err, failed):
    import torch
    for r, d, dtype, path, weight in LN_CASES:
        tdtype = getattr(torch, dtype)
        rnd = lambda *shape: torch.randn(*shape, generator=gen, device="cuda")
        x, dy = (rnd(r, d) * 2 + 0.3).to(tdtype), rnd(r, d).to(tdtype)
        gamma = 1.0 + 0.1 * rnd(d)
        before = LN.ln_backward.launches
        got = LN.ln_backward(x, dy, gamma, LN_EPS)
        want = LN.ln_backward_plain(x, dy, gamma, LN_EPS)
        torch.cuda.synchronize()
        rtol, atol = ROW_TOL[dtype]
        names = ("dx", "dgamma", "dbeta")
        tols = ((rtol, atol), LN_PARAM_TOL, LN_PARAM_TOL)
        rec = {"phase": "kernels", "kernel": "ln_bwd", "shape": [r, d],
               "dtype": dtype, "path": path,
               "tol": {"dx": [rtol, atol], "dgamma_dbeta": LN_PARAM_TOL},
               "launches": LN.ln_backward.launches - before,
               "err_ratio": {n: err_ratio(g.reshape(-1, w.shape[-1]),
                                          w.reshape(-1, w.shape[-1]), *tol)
                             for n, g, w, tol in zip(names, got, want,
                                                     tols)},
               "max_abs_err": {n: (g.float() - w.float()).abs().max().item()
                               for n, g, w in zip(names, got, want)}}
        rec["ok"] = max(rec["err_ratio"].values()) <= 1 and \
            all(bool(torch.isfinite(g.float()).all()) for g in got)
        del want
        if weight:
            wrong = _ln_dx_no_s2(x, dy, gamma, LN_EPS)
            rec["control_err_ratio"] = err_ratio(got[0], wrong, rtol, atol)
            rec["ok"] = rec["ok"] and rec["control_err_ratio"] > 1
            del wrong
            # bytes: x and dy read, dx written, gamma read, dgamma and dbeta
            # written; about 20 f32 operations an element
            isz = x.element_size()
            bound, by = _bound(20.0 * r * d, 3 * r * d * isz + 3 * d * 4, 4)
            gw, gb = gamma.to(tdtype), torch.zeros(d, device="cuda",
                                                   dtype=tdtype)
            _, mean, rstd = torch.ops.aten.native_layer_norm(x, [d], gw, gb,
                                                             LN_EPS)
            # three reads, the median kept: one launch's time moved
            # between calls of this script before (PERF.md)
            reads = sorted(time_ms(lambda: LN.ln_backward(x, dy, gamma,
                                                          LN_EPS))
                           for _ in range(3))
            rec.update(
                kernel_ms=reads[1], kernel_ms_reads=reads,
                plain_ms=time_ms(lambda: LN.ln_backward_plain(
                    x, dy, gamma, LN_EPS), iters=5),
                library="torch.ops.aten.native_layer_norm_backward",
                library_ms=time_ms(
                    lambda: torch.ops.aten.native_layer_norm_backward(
                        dy, x, [d], mean, rstd, gw, gb, [True, True, True])),
                bound_ms=bound, bound_by=by)
            _summary_add(summary, "ln_bwd", path, weight, rec, by)
            del gw, gb, mean, rstd
        if dtype == "bfloat16":
            max_err["ln_bwd"] = max(max_err.get("ln_bwd", 0.0),
                                    max(rec["max_abs_err"].values()))
        emit(rec)
        if not rec["ok"]:
            failed.append(rec)
        del x, dy, gamma, got


# Counts the device kernels (and copies or memsets) of one embedding-grad
# wrapper call, on already-cast inputs of each case's shapes, in a
# torch.profiler trace: argv[1] holds [[key, vocab, dim, n, dtype, impl],
# ...]; prints {key: count}. It runs in a fresh process: in this script's
# process, after the earlier phases, the profiler's traces of these calls
# came back without device events (PERF.md, PR 8).
_COUNT_KERNELS = r"""
import json, sys
import torch
from torch.profiler import ProfilerActivity, profile
from paddle_tpu_torch.ops import emb_grad_kernel as EG
out = {}
for key, vocab, dim, n, dtype, impl in json.loads(sys.argv[1]):
    tdtype = getattr(torch, dtype)
    ids = torch.randint(0, vocab, (n,), device="cuda")
    dout = torch.randn(n, dim, device="cuda").to(tdtype)
    w = torch.empty(vocab, dim, dtype=tdtype, device="cuda")
    fn = getattr(EG, "emb_grad_" + impl)
    fn(w, ids, dout)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn(w, ids, dout)
        torch.cuda.synchronize()
    out[key] = sum(1 for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
print(json.dumps(out))
"""


def _emb_kernels_per_call(EG):
    """{(vocab, dim, n, dtype, impl): device kernels of one call} for every
    embedding case the gate admits."""
    import torch
    todo = [["%d,%d,%d,%s,%s" % (v, d, n, dt, impl), v, d, n, dt, impl]
            for v, d, n, dt, _, _, _, _ in EMB_CASES
            for impl in ("scatter", "segsum")
            if EG.emb_grad_ok((v, d), n, impl, dtype=getattr(torch, dt))]
    run = subprocess.run([sys.executable, "-c", _COUNT_KERNELS,
                          json.dumps(todo)], capture_output=True, text=True,
                         timeout=600,
                         cwd=os.path.dirname(os.path.abspath(__file__)))
    if run.returncode:
        raise RuntimeError("counting the embedding kernels failed:\n%s"
                           % run.stderr[-3000:])
    counts = json.loads(run.stdout.strip().splitlines()[-1])
    return {tuple(row[1:]): counts[row[0]] for row in todo}


def _emb_ids(gen, vocab, n, draw):
    import torch
    if draw == "zipf":
        p = 1.0 / torch.arange(1, vocab + 1, dtype=torch.float64,
                               device="cuda")
        return torch.multinomial(p, n, replacement=True, generator=gen)
    return torch.randint(0, vocab, (n,), generator=gen, device="cuda")


def _emb_cases(EG, gen, summary, max_err, failed):
    import torch
    kernels_per_call = _emb_kernels_per_call(EG)
    for vocab, dim, n, dtype, draw, douts, weight, timed in EMB_CASES:
        tdtype = getattr(torch, dtype)
        ids = _emb_ids(gen, vocab, n, draw)
        if not timed:          # ids the kernels must skip
            ids[:2] = torch.tensor([vocab, -1], device="cuda")
        if douts == "int":
            dout = torch.randint(-4, 5, (n, dim), generator=gen,
                                 device="cuda").to(tdtype)
        else:
            dout = torch.randn(n, dim, generator=gen,
                               device="cuda").to(tdtype)
        w = torch.empty(vocab, dim, dtype=tdtype, device="cuda")
        for impl, fn, plain in (
                ("scatter", EG.emb_grad_scatter, EG.emb_grad_scatter_plain),
                ("segsum", EG.emb_grad_segsum, EG.emb_grad_segsum_plain)):
            if not EG.emb_grad_ok(w.shape, n, impl, dtype=tdtype):
                continue
            before = fn.launches
            got = fn(w, ids, dout)
            want = plain(w, ids, dout)
            torch.cuda.synchronize()
            key = "emb_" + impl
            rec = {"phase": "kernels", "kernel": key,
                   "shape": [vocab, dim, n], "dtype": dtype, "ids": draw,
                   "douts": douts, "path": "train256" if weight else None,
                   "bound": "exact", "launches": fn.launches - before,
                   "device_kernels_per_call": kernels_per_call[
                       (vocab, dim, n, dtype, impl)],
                   "ids_of_busiest_row": int(torch.bincount(
                       ids.clamp(0, vocab - 1), minlength=vocab).max()),
                   "err_ratio": err_ratio(got, want, 0.0, 0.0,
                                          row_scale=False),
                   "elements_differing": int((got != want).sum()),
                   "max_abs_err": (got.float() - want.float()).abs().max()
                   .item()}
            rec["ok"] = rec["err_ratio"] <= 1 and \
                rec["device_kernels_per_call"] == 1 and \
                bool(torch.isfinite(got.float()).all())
            del want
            if weight:
                keep = slice(0, n - EMB_CONTROL_DROP)
                wrong = plain(w, ids[keep], dout[keep])
                rec["control_err_ratio"] = err_ratio(got, wrong, 0.0, 0.0,
                                                     row_scale=False)
                rec["ok"] = rec["ok"] and rec["control_err_ratio"] > 1
                del wrong
            if timed:
                # bytes: ids and dout read once, dW written once
                isz = dout.element_size()
                bound, by = _bound(float(n * dim),
                                   n * 8 + (n + vocab) * dim * isz, isz)
                rec.update(
                    kernel_ms=time_ms(lambda: fn(w, ids, dout)),
                    plain_ms=time_ms(lambda: plain(w, ids, dout), iters=3,
                                     warmup=1),
                    library="torch.ops.aten.embedding_dense_backward",
                    library_ms=time_ms(
                        lambda: torch.ops.aten.embedding_dense_backward(
                            dout, ids, vocab, -1, False)),
                    bound_ms=bound, bound_by=by)
            if weight:
                _summary_add(summary, key, "train256", weight, rec,
                             rec["bound_by"])
            if dtype == "bfloat16":
                max_err[key] = max(max_err.get(key, 0.0), rec["max_abs_err"])
            emit(rec)
            if not rec["ok"]:
                failed.append(rec)
            del got
        del ids, dout, w
    torch.cuda.empty_cache()


def _flag_gated_rejects(CE, LN, EG):
    """Shapes the CE, LayerNorm and embedding-grad kernels refuse must
    raise."""
    import torch

    def expect(kernel, shape, call):
        try:
            call()
        except ValueError as e:
            emit({"phase": "kernels", "kernel": kernel, "rejects": shape,
                  "error": str(e), "ok": True})
        else:
            raise AssertionError("%s accepted %s" % (kernel, shape))
    for r, c in ROW_REJECT_SHAPES:
        x = torch.zeros(r, c, dtype=torch.bfloat16, device="cuda")
        lab = torch.zeros(r, dtype=torch.int64, device="cuda")
        rows = torch.zeros(r, device="cuda")
        expect("ce_fwd", [r, c], lambda: CE.ce_forward(x, lab))
        expect("ce_bwd", [r, c], lambda: CE.ce_backward(x, lab, rows, rows))
        expect("ln_bwd", [r, c], lambda: LN.ln_backward(
            x, x, torch.ones(c, device="cuda"), LN_EPS))
    for impl, shape, n, dtype in EMB_REJECT_CASES:
        w = torch.zeros(shape, dtype=getattr(torch, dtype), device="cuda")
        ids = torch.zeros(n, dtype=torch.int64, device="cuda")
        dout = torch.zeros(n, shape[1], device="cuda")
        expect("emb_" + impl, list(shape) + [n, dtype],
               lambda: EG.emb_grad(w, ids, dout, impl))


def phase_kernels():
    """Every kernel against its plain version. Returns (summary {(kernel,
    path): weighted sums over the path's mix}, {kernel: max |err| over the
    bf16 cases})."""
    import torch
    from paddle_tpu_torch.ops import attention as A
    from paddle_tpu_torch.ops import adam_kernel as K
    from paddle_tpu_torch.ops import ce_kernel as CE
    from paddle_tpu_torch.ops import emb_grad_kernel as EG
    from paddle_tpu_torch.ops import layernorm_kernel as LN
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    summary, max_err, failed = {}, {}, []
    emit({"phase": "kernels", "code_paths":
          _fwd_cases(A, gen, summary, max_err, failed)})
    torch.cuda.empty_cache()
    emit({"phase": "kernels", "code_paths":
          _bwd_cases(A, gen, summary, max_err, failed)})
    _adam_cases(K, gen, max_err, failed)
    _adam_multi_case(K, gen, summary, max_err, failed)
    _adam_multi_case(K, gen, summary, max_err, failed, BERT_ADAM_CASES,
                     "bert_base")
    _ce_cases(CE, gen, summary, max_err, failed)
    _ln_cases(LN, gen, summary, max_err, failed)
    _emb_cases(EG, gen, summary, max_err, failed)
    _flag_gated_rejects(CE, LN, EG)
    rejecting = {"onepass": lambda q, k, v: A.onepass_attention_fwd_bthd(
                     q, k, v),
                 "flash": lambda q, k, v: A.flash_attention_fwd_bthd(q, k, v),
                 "onepass_bwd": lambda q, k, v: A.onepass_attention_bwd_bthd(
                     q, k, v, q),
                 "flash_bwd": lambda q, k, v: A.flash_attention_bwd_dq(
                     q, k, v, q, *[torch.zeros(q.shape[:3], device="cuda")] *
                     2)}
    for kernel, t_k, d, dtype in REJECT_CASES:
        q, k, v = _qkv(gen, 1, 16, t_k, 2, d, getattr(torch, dtype))
        try:
            rejecting[kernel](q, k, v)
        except ValueError as e:
            emit({"phase": "kernels", "kernel": kernel, "rejects":
                  [1, 16, t_k, 2, d], "dtype": dtype, "error": str(e),
                  "ok": True})
        else:
            raise AssertionError("%s accepted T_k=%d D=%d %s"
                                 % (kernel, t_k, d, dtype))
    for shape in ADAM_REJECT_SHAPES:
        p = torch.zeros(shape, device="cuda")
        try:
            K.adam_update(p, p, p, p, torch.zeros((), device="cuda"),
                          *ADAM_HPARAMS)
        except ValueError as e:
            emit({"phase": "kernels", "kernel": "adam", "rejects":
                  list(shape), "error": str(e), "ok": True})
        else:
            raise AssertionError("adam accepted shape %s" % (shape,))
    torch.cuda.empty_cache()
    if failed:
        raise AssertionError("kernels disagree with their plain versions (or "
                             "the bound misses the control): %r" % failed)
    return summary, max_err


def _request(transformer, batch, seq_len, seed):
    b = transformer.synthetic_batch(batch, seq_len,
                                    transformer.FLAGSHIP_CFG["tgt_vocab"], seed)
    return {"src_ids": b["src_ids"], "tgt_ids": b["tgt_ids"]}


def _logits_agreement(card, cpu):
    """(max |card - cpu| / max |cpu|, share of rows with the same top-1)."""
    rel_err = float(abs(card - cpu).max() / abs(cpu).max())
    top1 = float((card.argmax(-1) == cpu.argmax(-1)).mean())
    return rel_err, top1


def phase_serve256(fluid, transformer, A, exe, scope):
    """Returns what phase logits_control needs: (serving program, the
    batch-1 feed, the logits name, the CPU's logits)."""
    import torch
    cfg = transformer.FLAGSHIP_CFG
    attn = 3 * cfg["n_layer"]       # enc self, dec causal self, cross
    serve, startup, logits = transformer.serving_programs(SEED, **cfg)
    exe.run(startup, scope=scope)
    seconds = []
    for i in range(REQUESTS):
        feed = _request(transformer, BATCH, 256, SEED + i)
        before = (A.onepass_attention_fwd_bthd.launches,
                  A.flash_attention_fwd_bthd.launches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, = exe.run(serve, feed=feed, fetch_list=[logits], scope=scope,
                       return_numpy=False)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        launched = (A.onepass_attention_fwd_bthd.launches - before[0],
                    A.flash_attention_fwd_bthd.launches - before[1])
        if tuple(out.shape) != (BATCH, 256, cfg["tgt_vocab"]) or \
                not bool(torch.isfinite(out.float()).all()):
            raise AssertionError("request %d: bad logits %s" % (i, out.shape))
        if launched != (attn, 0):
            raise AssertionError("request %d launched (one-pass, flash) = %s, "
                                 "want (%d, 0)" % (i, launched, attn))

    # one batch-1 request on the card and on the CPU, same weights
    feed = _request(transformer, 1, 256, SEED + 100)
    card, = exe.run(serve, feed=feed, fetch_list=[logits], scope=scope)
    cpu_scope = fluid.Scope()
    for p in serve.all_parameters():
        cpu_scope.set(p.name, scope.get(p.name).cpu())
    cpu, = fluid.Executor(fluid.CPUPlace()).run(
        serve, feed=feed, fetch_list=[logits], scope=cpu_scope)
    rel_err, top1 = _logits_agreement(card, cpu)
    ok = rel_err <= LOGITS_REL_ERR_MAX and top1 >= TOP1_AGREE_MIN
    # the first request pays one-time costs (allocator growth, cuBLAS
    # handles); the steady rate is over the others
    emit({"phase": "serve256", "ok": ok, "requests": REQUESTS,
          "batch": BATCH, "seq_len": 256, "request_seconds": seconds,
          "tokens_per_s": BATCH * 256 * (REQUESTS - 1) / sum(seconds[1:]),
          "onepass_launches_per_request": attn,
          "card_vs_cpu_logits_rel_err": rel_err,
          "rel_err_max": LOGITS_REL_ERR_MAX, "top1_agreement": top1,
          "top1_min": TOP1_AGREE_MIN})
    if not ok:
        raise AssertionError("card and CPU logits disagree")
    return serve, feed, logits, cpu


def phase_serve4096(fluid, transformer, A, exe, scope):
    import torch
    cfg = dict(transformer.FLAGSHIP_CFG, seq_len=LONG_SEQ)
    attn = 3 * cfg["n_layer"]
    serve, _, logits = transformer.serving_programs(SEED, **cfg)
    feed = _request(transformer, 1, LONG_SEQ, SEED + 200)
    exe.run(serve, feed=feed, fetch_list=[logits], scope=scope,
            return_numpy=False)                      # warm: allocator growth
    before = (A.onepass_attention_fwd_bthd.launches,
              A.flash_attention_fwd_bthd.launches)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, = exe.run(serve, feed=feed, fetch_list=[logits], scope=scope,
                   return_numpy=False)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launched = (A.onepass_attention_fwd_bthd.launches - before[0],
                A.flash_attention_fwd_bthd.launches - before[1])
    ok = tuple(out.shape) == (1, LONG_SEQ, cfg["tgt_vocab"]) and \
        bool(torch.isfinite(out.float()).all()) and launched == (0, attn)
    emit({"phase": "serve4096", "ok": ok, "batch": 1, "seq_len": LONG_SEQ,
          "request_seconds": seconds, "tokens_per_s": LONG_SEQ / seconds,
          "launches": {"onepass": launched[0], "flash": launched[1]},
          "peak_memory_bytes": torch.cuda.max_memory_allocated()})
    if not ok:
        raise AssertionError("long request failed: launches %s" % (launched,))


def phase_logits_control(exe, scope, serve, feed, logits, cpu):
    """The card-vs-CPU limits must reject a faulty path: the serving program
    with its decoder self-attention made non-causal, run on the card,
    against the sound program's CPU logits."""
    faulty = serve.clone(for_test=True)
    flipped = 0
    for op in faulty.global_block().ops:
        if op.type == "fused_attention" and op.attr("causal"):
            op.attrs["causal"] = False
            flipped += 1
    card, = exe.run(faulty, feed=feed, fetch_list=[logits], scope=scope)
    rel_err, top1 = _logits_agreement(card, cpu)
    caught = rel_err > LOGITS_REL_ERR_MAX or top1 < TOP1_AGREE_MIN
    emit({"phase": "logits_control", "ok": caught,
          "fault": "decoder self-attention not causal",
          "ops_changed": flipped, "card_vs_cpu_logits_rel_err": rel_err,
          "top1_agreement": top1})
    if not caught:
        raise AssertionError("the logits limits pass a faulty program")


def _counters():
    """name -> the wrapper whose `launches` counts its kernel."""
    from paddle_tpu_torch.ops import attention as A
    from paddle_tpu_torch.ops import adam_kernel as K
    from paddle_tpu_torch.ops import ce_kernel as CE
    from paddle_tpu_torch.ops import emb_grad_kernel as EG
    from paddle_tpu_torch.ops import layernorm_kernel as LN
    return {"onepass": A.onepass_attention_fwd_bthd,
            "flash": A.flash_attention_fwd_bthd,
            "onepass_bwd": A.onepass_attention_bwd_bthd,
            "flash_bwd_dq": A.flash_attention_bwd_dq,
            "flash_bwd_dkv": A.flash_attention_bwd_dkv,
            "adam": K.adam_update_multi,
            "ce_fwd": CE.ce_forward,
            "ce_bwd": CE.ce_backward,
            "ln_bwd": LN.ln_backward,
            "emb_scatter": EG.emb_grad_scatter,
            "emb_segsum": EG.emb_grad_segsum}


# the training flags that put the flag-gated kernels on the path
KERNEL_FLAGS = {"FLAGS_ce_kernel": "1", "FLAGS_ln_kernel": "1"}


@contextlib.contextmanager
def _env(**values):
    """Set environment variables for a block and restore them after."""
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _zero(counters):
    for fn in counters.values():
        fn.launches = 0


def _read(counters):
    return {name: fn.launches for name, fn in counters.items()}


def train_flops_per_token(cfg):
    """bench.py's 6N rule (train_matmul_flops_per_token): matmul params
    times 6, plus the attention score and context products times 3."""
    d, dff, nl = cfg["d_model"], cfg["d_ff"], cfg["n_layer"]
    n_matmul = nl * (4 * d * d + 2 * d * dff) + \
        nl * (8 * d * d + 2 * d * dff) + d * cfg["tgt_vocab"]
    return 6 * n_matmul + 3 * nl * 3 * 2 * (2 * cfg["seq_len"] * d)


def _stacked(feed, steps):
    """A feed repeated on a leading [steps] axis, as run_steps takes it."""
    import numpy as np
    return {n: np.stack([x] * steps) for n, x in feed.items()}


# the parameters the fused Adam kernel takes in the flagship model (and in
# the wide one): one launch a step covers them all
ADAM_TENSORS = sum(n for _, _, n in ADAM_CASES)


def _window(name, fluid, counters, programs, warm_feed, feed, steps,
            want_per_step, adam_tensors, info, work):
    """Startup on the card, one warm step on `warm_feed` (stacked [1,
    ...]), then `steps` steps through run_steps on `feed` (stacked [steps,
    ...]) with every launch count zeroed just before and read just after.
    Every loss must be finite, the launches must be `want_per_step` times
    the steps, and the step's Adam call must have covered `adam_tensors`
    parameters (None: a path with no Adam launch). Emits the phase's line (`info`, the window's times and
    rates per unit of `work` = {unit: count a step}, peak memory) and
    returns the launches."""
    import numpy as np
    import torch
    main, startup, loss = programs
    exe, scope = fluid.Executor(), fluid.Scope()
    exe.run(startup, scope=scope)
    warm = exe.run_steps(main, feed=warm_feed, n_steps=1, fetch_list=[loss],
                         scope=scope)
    # the earlier phases' programs and scopes are cyclic garbage: collect
    # it now, so that no full collection of it lands in the window
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero(counters)
    t0 = time.perf_counter()
    losses, = exe.run_steps(main, feed=feed, n_steps=steps,
                            fetch_list=[loss], scope=scope,
                            return_numpy=False)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launched = _read(counters)
    losses = losses.float().cpu().numpy()
    want = {k: v * steps for k, v in want_per_step.items()}
    tensors = counters["adam"].last_tensors
    ok = losses.shape == (steps,) and bool(np.isfinite(losses).all()) and \
        bool(np.isfinite(np.asarray(warm[0])).all()) and launched == want \
        and (adam_tensors is None or tensors == adam_tensors)
    rec = dict({"phase": name, "ok": ok}, **info)
    rec.update({"flags": {k: v for k, v in os.environ.items()
                          if k.startswith("FLAGS_")},
                "steps": steps, "losses": losses.tolist(),
                "warm_loss": float(np.asarray(warm[0]).reshape(-1)[0]),
                "window_seconds": seconds, "step_ms": seconds / steps * 1e3})
    for unit, count in work.items():
        rec[unit + "_per_s"] = count * steps / seconds
    rec.update({"launches": launched, "launches_want": want,
                "adam_tensors_a_step": tensors,
                "peak_memory_bytes": torch.cuda.max_memory_allocated()})
    emit(rec)
    if not ok:
        raise AssertionError("%s failed: launches %s, want %s, Adam "
                             "tensors a step %s (want %s), losses %s"
                             % (name, launched, want, tensors, adam_tensors,
                                losses))
    del exe, scope
    torch.cuda.empty_cache()
    return launched


def _train_phase(name, fluid, transformer, counters, cfg, batch, steps,
                 want_per_step):
    """The flagship Transformer's training program (bench.py's training
    leg) through _window at `batch`; each step's one Adam launch must cover
    ADAM_TENSORS parameters."""
    vocab, seq = cfg["tgt_vocab"], cfg["seq_len"]
    tokens = batch * seq
    return _window(
        name, fluid, counters, transformer.training_programs(SEED, **cfg),
        _stacked(transformer.synthetic_batch(batch, seq, vocab, SEED), 1),
        _stacked(transformer.synthetic_batch(batch, seq, vocab, SEED + 1),
                 steps), steps,
        want_per_step, ADAM_TENSORS,
        {"batch": batch, "seq_len": seq,
         "dropout_rate": cfg["dropout_rate"]},
        {"tokens": tokens, "model_tflops": tokens *
         train_flops_per_token(cfg) / 1e12})


# Card vs CPU after one training step of the bf16 model with dropout 0
# (same weights, same batch): the loss by |card - cpu| / |cpu|, each
# gradient by max |card - cpu| / max |cpu|. The limits sit between the sound
# reading (loss 2.6e-6, gradients 0.031-0.038) and that of the program with
# its decoder self-attention made non-causal (loss 2.0e-4, gradients
# 0.159-0.969), which phase train_parity must reject. Both readings: NVIDIA
# H100 80GB HBM3, 700 W (PERF.md). They hold with the flag-gated kernels on
# the card's path too; the CPU takes the plain lowerings either way.
TRAIN_LOSS_REL_MAX = 3e-5
TRAIN_GRAD_REL_MAX = 0.08
PARITY_GRADS = ["enc.0.attn.q.w", "dec.0.self.q.w", "dec.0.self.k.w",
                "dec.0.cross.q.w", "dec.3.cross.k.w", "src_emb", "tgt_emb",
                "proj.w", "dec.3.ffn_post.ln_scale"]
# the flags of each train_parity run on the card
PARITY_FLAGS = [("off", {}),
                ("scatter", dict(KERNEL_FLAGS,
                                 FLAGS_emb_grad_kernel="scatter")),
                ("segsum", dict(KERNEL_FLAGS,
                                FLAGS_emb_grad_kernel="segsum"))]


def _make_noncausal(program):
    """The decoder's self-attention made non-causal, in its forward ops and
    in the fwd_attrs of their grad ops."""
    changed = 0
    for op in program.global_block().ops:
        if op.type == "fused_attention" and op.attr("causal"):
            op.attrs["causal"] = False
            changed += 1
        elif op.type == "grad_of" and \
                op.attr("fwd_type") == "fused_attention" and \
                op.attr("fwd_attrs").get("causal"):
            # a new dict: a clone shares its attrs' nested values
            op.attrs["fwd_attrs"] = dict(op.attr("fwd_attrs"), causal=False)
            changed += 1
    return changed


# the wide parity check (bench.py's wide Transformer, D = 256, at 1 + 1
# layers): the same gradients in its one layer
WIDE_PARITY_GRADS = ["enc.0.attn.q.w", "dec.0.self.q.w", "dec.0.self.k.w",
                     "dec.0.cross.q.w", "dec.0.cross.k.w", "src_emb",
                     "tgt_emb", "proj.w", "dec.0.ffn_post.ln_scale"]


def _card_vs_cpu(name, fluid, counters, programs, feed, grads, flag_runs,
                 control, info, limits=(None, None)):
    """One training step of `programs` (main, startup, loss) on the card and
    on the CPU from the same startup state and `feed`, for each of
    `flag_runs` ([(name, env)]) on the card: the loss and the gradients of
    `grads` must agree within `limits` (loss, gradients; by default
    TRAIN_LOSS_REL_MAX and TRAIN_GRAD_REL_MAX), and `control` =
    (description, program, feed), a faulty run on the card, must not."""
    import numpy as np
    import torch
    main, startup, loss = programs
    loss_max = limits[0] or TRAIN_LOSS_REL_MAX
    grad_max = limits[1] or TRAIN_GRAD_REL_MAX
    fetch = [loss.name] + [n + "@GRAD" for n in grads]
    exe, scope = fluid.Executor(), fluid.Scope()
    exe.run(startup, scope=scope)
    state = {v.name: scope.get(v.name).cpu().clone()
             for v in main.global_block().vars.values()
             if v.persistable and scope.get(v.name) is not None}

    def run(program, place, run_feed=feed):
        sc = fluid.Scope()
        for n, t in state.items():
            sc.set(n, t.clone())
        e = exe if place == "card" else fluid.Executor(fluid.CPUPlace())
        return e.run(program, feed=run_feed, fetch_list=fetch, scope=sc)

    def agreement(card, cpu):
        rel = {"loss": float(abs(card[0] - cpu[0]) / abs(cpu[0]))}
        for n, c, w in zip(grads, card[1:], cpu[1:]):
            rel[n] = float(np.abs(c - w).max() / np.abs(w).max())
        ok = rel["loss"] <= loss_max and \
            max(v for k, v in rel.items() if k != "loss") <= grad_max
        return rel, ok

    cpu = run(main, "cpu")
    what, faulty, faulty_feed = control
    failures = []
    for flag_name, flags in flag_runs:
        with _env(**flags):
            _zero(counters)
            card = run(main, "card")
            launched = {k: v for k, v in _read(counters).items() if v}
            rel, ok = agreement(card, cpu)
            wrong, control_ok = agreement(run(faulty, "card", faulty_feed),
                                          cpu)
        rec = dict({"phase": name, "flags": flag_name,
                    "ok": ok and not control_ok}, **info)
        rec.update({"loss_card": float(card[0]), "loss_cpu": float(cpu[0]),
                    "rel_err": rel, "loss_rel_max": loss_max,
                    "grad_rel_max": grad_max,
                    "card_launches": launched, "control": what,
                    "control_rel_err": wrong,
                    "control_rejected": not control_ok})
        emit(rec)
        if not ok or control_ok:
            failures.append((flag_name, rel, wrong))
    if failures:
        raise AssertionError("%s: card vs CPU %s" % (name, failures))
    torch.cuda.empty_cache()


def phase_train_parity(fluid, transformer, counters, name="train_parity",
                       cfg=None, grads=PARITY_GRADS, flag_runs=PARITY_FLAGS):
    """The flagship's training step (dropout 0, batch 2) on the card and on
    the CPU; the control is the program with its decoder self-attention
    made non-causal."""
    cfg = dict(cfg or transformer.FLAGSHIP_CFG, dropout_rate=0.0)
    programs = transformer.training_programs(SEED, **cfg)
    feed = transformer.synthetic_batch(2, cfg["seq_len"], cfg["tgt_vocab"],
                                       SEED + 300)
    faulty = programs[0].clone()
    changed = _make_noncausal(faulty)
    _card_vs_cpu(name, fluid, counters, programs, feed, grads, flag_runs,
                 ("decoder self-attention not causal (%d ops changed)"
                  % changed, faulty, feed),
                 {"batch": 2, "d_model": cfg["d_model"],
                  "n_head": cfg["n_head"], "n_layer": cfg["n_layer"],
                  "seq_len": cfg["seq_len"], "dropout_rate": 0.0})


def bert_flops_per_step(cfg, batch, max_predictions=20):
    """bench.py's 6N rule for BERT: the encoder's matmul params times 6 a
    token plus the attention score and context products times 3, and the
    MLM head (transform and vocab projection, on max_predictions tokens a
    sequence) and the pooler and NSP head (one token) times 6."""
    d, dff, nl, t = cfg["d_model"], cfg["d_ff"], cfg["n_layer"], \
        cfg["seq_len"]
    enc = 6 * nl * (4 * d * d + 2 * d * dff) + 3 * nl * 2 * (2 * t * d)
    heads = 6 * max_predictions * (d * d + d * cfg["vocab_size"]) + \
        6 * (d * d + 2 * d)
    return batch * (t * enc + heads)


def _bert_phase(name, fluid, bert, counters, cfg, batch, steps,
                want_per_step):
    """bench.py's BERT leg (bert.training_programs: Adam(1e-4)) through
    _window at `batch`; each step's Adam call must cover the 74 parameters
    the kernel takes."""
    tokens = batch * cfg["seq_len"]
    feed = lambda seed: bert.synthetic_batch(
        batch, cfg["seq_len"], cfg["vocab_size"], seed=seed)
    return _window(
        name, fluid, counters, bert.training_programs(SEED, **cfg),
        _stacked(feed(SEED), 1), _stacked(feed(SEED + 1), steps), steps,
        want_per_step, sum(n for _, _, n in BERT_ADAM_CASES),
        {"batch": batch, "seq_len": cfg["seq_len"],
         "n_layer": cfg["n_layer"], "d_model": cfg["d_model"],
         "vocab_size": cfg["vocab_size"], "dtype": cfg["dtype"],
         "dropout_rate": cfg["dropout_rate"]},
        {"tokens": tokens,
         "model_tflops": bert_flops_per_step(cfg, batch) / 1e12})


# bert_parity's gradients: the word embedding, the MLM transform, the
# pooler, one attention weight and one LayerNorm scale
BERT_PARITY_GRADS = ["word_emb", "mlm.transform.w", "pooler.w",
                     "bert.0.attn.q.w", "bert.1.ffn_post.ln_scale"]
# bert_parity's limits (loss, gradients) by dtype. bfloat16: train_parity's
# gradient limit; its loss limit sits between the sound reading, 8.4e-5,
# and the control's, 3.3e-4 (this phase on an NVIDIA H100 80GB HBM3 at
# 700 W; PERF.md): the loss averages the bf16 noise of 40 masked tokens,
# where the flagship's averages 512 tokens (so train_parity's 3e-5 times
# sqrt(512 / 40) = 1.1e-4 for the same noise a token). float32: the orders
# of f32 sums only, 1e-7 an operation through the step.
BERT_PARITY_LIMITS = {"bfloat16": (1.5e-4, TRAIN_GRAD_REL_MAX),
                      "float32": (1e-5, 1e-3)}


def phase_bert_parity(fluid, bert, counters, cfg, batch=2):
    """BERT at `cfg` (dropout 0) for one training step on the card and on
    the CPU, in bfloat16 and in float32, at BERT_PARITY_LIMITS; the control
    is the card's step with the masked positions moved one token on."""
    for dtype, limits in BERT_PARITY_LIMITS.items():
        dcfg = dict(cfg, dropout_rate=0.0, dtype=dtype)
        programs = bert.training_programs(SEED, **dcfg)
        feed = bert.synthetic_batch(batch, cfg["seq_len"], cfg["vocab_size"],
                                    seed=SEED + 500)
        shifted = dict(feed, mlm_positions=(feed["mlm_positions"] + 1) %
                       cfg["seq_len"])
        _card_vs_cpu("bert_parity", fluid, counters, programs, feed,
                     BERT_PARITY_GRADS, PARITY_FLAGS[:1],
                     ("mlm_positions moved one token on", programs[0],
                      shifted),
                     {"batch": batch, "d_model": cfg["d_model"],
                      "n_head": cfg["n_head"], "n_layer": cfg["n_layer"],
                      "seq_len": cfg["seq_len"],
                      "vocab_size": cfg["vocab_size"], "dtype": dtype,
                      "dropout_rate": 0.0}, limits)


def _deepfm_phase(fluid, deepfm, counters, cfg, batch, steps):
    """bench.py's DeepFM leg (deepfm.training_programs: Adam(1e-3), both
    tables sparse) through _window at `batch`: each step one Adam launch,
    for the [416, 128] first MLP weight, the one parameter the kernel
    takes; the sparse tables' adam ops run alone, on their sparse path."""
    main, startup, loss, _ = deepfm.training_programs(SEED, **cfg)
    none = dict.fromkeys(counters, 0)
    feed = lambda seed: deepfm.synthetic_batch(
        batch, cfg["num_fields"], cfg["vocab_size"], seed=seed)
    return _window(
        "deepfm", fluid, counters, (main, startup, loss),
        _stacked(feed(SEED), 1), _stacked(feed(SEED + 1), steps), steps,
        dict(none, adam=1), 1, dict({"batch": batch}, **cfg),
        {"examples": batch})


# deepfm_parity: bench.py's DeepFM leg at its full size (float32, sparse
# tables, non-lazy Adam) for 3 steps in lockstep: each step runs on the card
# and on the CPU from the CPU's state after the step before, on a batch
# whose ids repeat (106,496 ids over 100,000 rows), and the two steps must
# agree:
# - the loss to 1e-5 relative (f32 sums in other orders: about 1e-7);
# - the AUC to 1e-5 absolute; the histograms to the same totals and
#   sum |card - cpu| at most twice the count of the CPU's probabilities
#   within 1e-5 (40 times the f32 noise of a probability) of a bucket edge
#   k / 4095, the only ones that can change bucket; and the card's AUC
#   within 1e-6 of the area recomputed on the host from its histograms;
# - the rows no id of the step touched, in both tables' parameters and
#   moments, elementwise to 1e-6 (about 8 f32 ulp) of |before| + |the
#   CPU's change| (a zero must stay zero): the non-lazy update decays their
#   moments and moves their parameters by a few elementwise f32 operations
#   on both devices, which differ in their last bits; relative to the
#   result alone, a parameter moved to near 0 would read large;
# - the sparse pairs' rows equal; the gradients (the pairs' values, the MLP
#   weights'), the moments after the step and the step's change of the
#   parameters, of both tables and the MLP weights, by ||card - cpu|| /
#   ||cpu|| to 0.05. The orders of f32 sums (the card's index_add_ adds an
#   id's repeats in another order than the CPU's loop) move these by about
#   1e-6. A ReLU preactivation within rounding of 0 can take the other side
#   on the other device and so route one example's gradient another way:
#   tools/torch_deepfm_lockstep.py saw one such flip in 12 steps, which
#   moved that example's sparse values by 0.135 of their largest and these
#   norms by at most 0.0044 (NVIDIA H100 80GB HBM3, 700 W); the limit
#   admits about ten a step, where a dropped or misplaced duplicate moves
#   them by far more.
# The control, the card's steps with the tables' adam ops in lazy mode
# (rows untouched in a step keep their moments and parameters), must fail
# the untouched rows' check from the second step on (their moments are
# then 1 / b1 = 1.11 times the CPU's).
DFM_LOSS_REL_MAX = 1e-5
DFM_UNTOUCHED_REL_MAX = 1e-6
DFM_NORM_MAX = 0.05
DFM_AUC_ABS_MAX = 1e-5
DFM_EDGE = 1e-5
DFM_PARITY_STEPS = 3
DFM_TABLES = ["fm_first", "fm_second"]
DFM_MLP = ["fc_0.w_0", "fc_1.w_0", "fc_2.w_0"]


def _auc_of(pos, neg):
    """The auc op's area from its histograms, in float64 on the host."""
    import numpy as np
    pos, neg = np.asarray(pos, np.float64), np.asarray(neg, np.float64)
    above = np.cumsum(pos[::-1])[::-1]
    return float(np.sum(neg * (above - pos / 2.0)) /
                 max(pos.sum() * neg.sum(), 1.0))


def _deepfm_step_agreement(card, cpu, prev, ids, vocab):
    """One lockstep step's readings and verdict: card and cpu are (fetched
    {name: array}, state after the step {name: array}), prev the state
    before it, ids the step's ids."""
    import numpy as np
    (cf, cs), (wf, ws) = card, cpu
    r = {"loss": abs(float(cf["loss"]) - float(wf["loss"])) /
         abs(float(wf["loss"]))}

    def norm(c, w):
        return float(np.linalg.norm(c - w) / max(np.linalg.norm(w), 1e-30))
    for n in DFM_TABLES + DFM_MLP:
        r[n + "@GRAD"] = norm(cf[n + "@GRAD"], wf[n + "@GRAD"])
        r[n + "_step"] = norm(cs[n] - prev[n], ws[n] - prev[n])
        for m in (1, 2):
            k = "%s_moment%d_acc_0" % (n, m)
            r[k] = norm(cs[k], ws[k])
    rows_equal = all(np.array_equal(cf[t + "@GRAD@ROWS"],
                                    wf[t + "@GRAD@ROWS"]) for t in DFM_TABLES)
    untouched = np.setdiff1d(np.arange(vocab), ids)

    def untouched_rel(k):
        c, w, p = (x[k][untouched] for x in (cs, ws, prev))
        scale = np.abs(p) + np.abs(w - p)     # the operands' magnitudes
        return float(np.max(np.abs(c - w) / np.maximum(scale, 1e-30)))
    r["untouched_rows_rel"] = max(
        untouched_rel(k) for t in DFM_TABLES
        for k in (t, t + "_moment1_acc_0", t + "_moment2_acc_0"))
    pos, neg = cs["auc_0_stat_pos"], cs["auc_0_stat_neg"]
    p = np.asarray(wf["prob"], np.float64)
    near = int(np.sum(np.abs(p * 4095 - np.round(p * 4095)) <
                      4095 * DFM_EDGE))
    r.update(hist_l1=int(np.abs(pos - ws["auc_0_stat_pos"]).sum() +
                         np.abs(neg - ws["auc_0_stat_neg"]).sum()),
             hist_l1_max=2 * near,
             auc_abs=abs(float(cf["auc"]) - float(wf["auc"])),
             auc_vs_histograms=abs(float(cf["auc"]) - _auc_of(pos, neg)))
    totals = pos.sum() + neg.sum() == \
        ws["auc_0_stat_pos"].sum() + ws["auc_0_stat_neg"].sum()
    ok = r["loss"] <= DFM_LOSS_REL_MAX and rows_equal and totals and \
        r["untouched_rows_rel"] <= DFM_UNTOUCHED_REL_MAX and \
        r["hist_l1"] <= r["hist_l1_max"] and \
        r["auc_abs"] <= DFM_AUC_ABS_MAX and \
        r["auc_vs_histograms"] <= 1e-6 and \
        all(v <= DFM_NORM_MAX for k, v in r.items()
            if k.endswith(("@GRAD", "_step", "_acc_0")))
    return r, bool(ok)


def phase_deepfm_parity(fluid, deepfm, counters, cfg, batch):
    import numpy as np
    import torch
    main, startup, loss, auc = deepfm.training_programs(SEED, **cfg)
    block = main.global_block()
    prob = [op.output("Out")[0] for op in block.ops
            if op.type == "sigmoid"][0]
    grads = [n + "@GRAD" for n in DFM_TABLES + DFM_MLP] + \
        [t + "@GRAD@ROWS" for t in DFM_TABLES]
    fetch = {"loss": loss.name, "auc": auc.name, "prob": prob}
    fetch.update({g: g for g in grads})
    cpu_exe, card_exe = fluid.Executor(fluid.CPUPlace()), fluid.Executor()
    scope = fluid.Scope()
    cpu_exe.run(startup, scope=scope)
    names = [v.name for v in block.vars.values()
             if v.persistable and scope.get(v.name) is not None]
    start = {n: scope.get(n).clone() for n in names}
    feeds = [deepfm.synthetic_batch(batch, cfg["num_fields"],
                                    cfg["vocab_size"], seed=SEED + 400 + i)
             for i in range(DFM_PARITY_STEPS)]

    def step(exe, program, state, feed):
        sc = fluid.Scope()
        for n, t in state.items():
            sc.set(n, t.clone())
        got = exe.run(program, feed=feed, fetch_list=list(fetch.values()),
                      scope=sc)
        after = {n: sc.get(n).cpu() for n in names}
        as64 = lambda t: np.asarray(fluid.executor.as_numpy(t))
        return ({k: as64(v) for k, v in zip(fetch, got)},
                {n: as64(t) for n, t in after.items()}), after

    faulty = main.clone()
    for op in faulty.global_block().ops:
        if op.type == "adam" and op.input("GradRows"):
            op.attrs["lazy_mode"] = True
    state, readings, control, ok, control_ok = start, [], [], True, True
    _zero(counters)
    for i, feed in enumerate(feeds):
        prev = {n: np.asarray(fluid.executor.as_numpy(t))
                for n, t in state.items()}
        ids = feed["feat_ids"].reshape(-1)
        cpu, cpu_state = step(cpu_exe, main, state, feed)
        card, _ = step(card_exe, main, state, feed)
        r, step_ok = _deepfm_step_agreement(card, cpu, prev, ids,
                                            cfg["vocab_size"])
        wrong, wrong_ok = _deepfm_step_agreement(
            step(card_exe, faulty, state, feed)[0], cpu, prev, ids,
            cfg["vocab_size"])
        r["repeated_ids"] = int(ids.size - np.unique(ids).size)
        readings.append(r)
        control.append(wrong)
        ok, control_ok = ok and step_ok, control_ok and wrong_ok
        state = cpu_state
    launched = {k: v for k, v in _read(counters).items() if v}
    emit(dict({"phase": "deepfm_parity", "ok": ok and not control_ok,
               "batch": batch, "steps": DFM_PARITY_STEPS,
               "lockstep": "each step from the CPU's state",
               "rel_err": readings,
               "limits": {"loss": DFM_LOSS_REL_MAX, "norm": DFM_NORM_MAX,
                          "auc_abs": DFM_AUC_ABS_MAX},
               "card_launches": launched,
               "control": "the tables' adam ops in lazy mode",
               "control_rel_err": control,
               "control_rejected": not control_ok}, **cfg))
    if not ok or control_ok:
        raise AssertionError("deepfm_parity: card vs CPU %s, control %s"
                             % (readings, control))
    torch.cuda.empty_cache()


# ResNet-50: bench.py's leg (resnet.training_programs: dataset "flowers",
# 3x224x224, 1000 classes, bf16, Momentum(0.01, 0.9)) at batch 64, one warm
# step then RESNET_STEPS through run_steps
RESNET_STEPS = 8
RESNET_IMAGE = [3, 224, 224]
RESNET_CLASSES = 1000
MOMENTUM_TIMING_ROUNDS = 9


def resnet_flops_per_image(program):
    """Forward multiply-adds, times 2, of the program's conv2d and mul ops
    from their shapes (the bench leg's 3x224x224 input); a training step
    does 3 times this (forward, grad of the input, grad of the weight)."""
    block = program.global_block()
    total = 0
    for op in block.ops:
        if op.type == "conv2d":
            out = block.var(op.output("Output")[0]).shape
            w = block.var(op.input("Filter")[0]).shape
            total += 2 * out[1] * out[2] * out[3] * w[1] * w[2] * w[3]
        elif op.type == "mul":
            w = block.var(op.input("Y")[0]).shape
            total += 2 * w[0] * w[1]
    return total


def _momentum_group_check(fluid, main):
    """The executor's group lowering of the step's 161 momentum ops on the
    card, against each op's own lowering on the same card tensors: every
    ParamOut and VelocityOut bit for bit. Also the host time of each route:
    the median of MOMENTUM_TIMING_ROUNDS calls, the routes in turns, each
    call synchronized before and its launches only enqueued (one call
    reads up to twice its median on this host)."""
    import torch
    from paddle_tpu_torch.fluid.core_types import to_torch_dtype
    from paddle_tpu_torch.fluid.ops import optimizer_ops, registry
    block = main.global_block()
    ops = [op for op in block.ops if op.type == "momentum"]
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    lr = torch.full((1,), 0.01, device="cuda")
    inputs = []
    for op in ops:
        p = block.var(op.input("Param")[0])
        dtype = to_torch_dtype(p.dtype)
        draw = lambda: torch.randn(p.shape, generator=gen, device="cuda")
        inputs.append({"Param": [draw().to(dtype)], "Grad": [draw().to(dtype)],
                       "Velocity": [draw()], "LearningRate": [lr]})
    ctx = registry.LoweringContext("cuda")
    attrs = [op.attrs for op in ops]
    routes = {"group": lambda: optimizer_ops._momentum_group(
                  ctx, inputs, attrs),
              "op_by_op": lambda: [optimizer_ops._momentum(ctx, i, a)
                                   for i, a in zip(inputs, attrs)]}
    times, outs = {}, {}
    for _ in range(MOMENTUM_TIMING_ROUNDS):
        for route, call in routes.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs[route] = call()
            times.setdefault(route, []).append(
                (time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    times = {route: sorted(ms)[len(ms) // 2] for route, ms in times.items()}
    equal = all(torch.equal(g[s][0], a[s][0])
                for g, a in zip(outs["group"], outs["op_by_op"])
                for s in ("ParamOut", "VelocityOut"))
    emit({"phase": "momentum_group", "ok": equal, "ops": len(ops),
          "bf16_params": sum(i["Param"][0].dtype == torch.bfloat16
                             for i in inputs),
          "bit_for_bit": equal, "host_ms_group": times["group"],
          "host_ms_op_by_op": times["op_by_op"]})
    if not equal:
        raise AssertionError("momentum group lowering differs from the "
                             "op-by-op lowering on the card")


def _resnet_phase(name, fluid, resnet, counters, batch, steps):
    """bench.py's ResNet-50 leg through _window at `batch`: no kernel of
    the port's on its path (no attention, Adam, LayerNorm or embedding; the
    cross-entropy gate refuses V = 1000), so every launch count is 0."""
    main, startup, loss, _ = resnet.training_programs(
        SEED, dataset="flowers", dtype=resnet.RESNET_BENCH_DTYPE)
    feed = lambda seed: resnet.synthetic_batch(batch, RESNET_IMAGE,
                                               RESNET_CLASSES, seed=seed)
    flops = resnet_flops_per_image(main)
    return _window(
        name, fluid, counters, (main, startup, loss),
        _stacked(feed(SEED), 1), _stacked(feed(SEED + 1), steps), steps,
        dict.fromkeys(counters, 0), None,
        {"batch": batch, "image": RESNET_IMAGE, "classes": RESNET_CLASSES,
         "dtype": resnet.RESNET_BENCH_DTYPE, "depth": 50,
         "forward_gflop_per_image": flops / 1e9},
        {"images": batch, "model_tflops": 3 * flops * batch / 1e12})


# resnet_parity: bench.py's ResNet-50 program (depth 50, 1000 classes) at
# batch 4 on 3x128x128 images (the last stage normalizes 4 * 4 * 4 = 64
# values a channel; global pooling takes any image size), in float32 and in
# bfloat16 from the same weights (the bf16 program reads the f32 startup
# state rounded to its parameters' dtype) and batches, for 3 steps in
# lockstep: each step starts on the card and on the CPU from the CPU's
# state after the step before.
#
# Op by op: the CPU runs the step keeping every value; then every op of the
# card's plan runs on the card from the CPU's values of its inputs, and each
# output must lie within RESNET_OP_TOL of the CPU's, relative to its largest
# magnitude, by the output's dtype. This holds each op where the whole step
# cannot be held tightly: a random-init ResNet-50 amplifies rounding through
# its fifty layers (a 1e-7 relative change of the input moves its gradients
# by 3.8% in norm, and a ReLU preactivation within rounding of 0 can take
# the other side on the other device). float32 1e-4: sums in other orders,
# and batch_norm's E[x^2] - E[x]^2, which cancels where a channel's mean is
# a few times its spread. bfloat16 2^-6, two bf16 ulps at the largest
# value. Integer outputs (top_k's indices, accuracy's counts) exactly. The
# loss, the gradients of conv1's weight, a middle bottleneck
# conv, the last batch_norm scale and the fc weight, MeanOut and
# VarianceOut of the first and the last batch_norm, and conv1's and the fc
# weight's velocity and parameter after the update are among the outputs.
# Controls, each on the card's first step only, must fail: the running
# variance updated with the unbiased estimate (F.batch_norm's update),
# and, in float32, cuDNN's convolutions allowed TF32.
#
# Sound readings (NVIDIA H100 80GB HBM3, 700 W; PERF.md): float32 1.8e-5,
# bfloat16 0.0066 (and 2.7e-6 on its f32 outputs); the controls read 8.0e-4
# (TF32, a weight gradient) and 8.0e-3 (a VarianceOut).
#
# Whole step: the card also runs each step whole from the CPU's state; the
# loss and the named quantities are reported beside the op-by-op readings,
# with limits RESNET_STEP_LIMITS in float32 (loss relative; the others by
# ||card - cpu|| / ||cpu||), which the is_test program (running statistics
# in place of the batch's) must fail. Sound readings: loss 3.4e-6 to
# 6.7e-6, the others at most 0.025 (conv1's gradient, after fifty layers of
# amplification); the control: loss 217, up to 2,090. In bfloat16 the
# whole step is reported only: the amplified rounding leaves the gradients
# below the last stage uncorrelated (conv1's 1.15 in norm).
RESNET_PARITY_BATCH = 4
RESNET_PARITY_IMAGE = [3, 128, 128]
RESNET_PARITY_STEPS = 3
RESNET_OP_TOL = {"float32": 1e-4, "bfloat16": 2.0 ** -6, "int64": 0.0,
                 "int32": 0.0}
RESNET_STEP_LIMITS = {"loss": 1e-4, "named": 0.1}
# conv1, a middle bottleneck's 3x3 conv, the last batch_norm's scale and
# the fc weight; the first and the last batch_norm's running statistics
RESNET_PARITY_GRADS = ["conv2d_0.w_0", "conv2d_26.w_0", "batch_norm_52.w_0",
                       "fc_0.w_0"]
RESNET_PARITY_STATE = ["batch_norm_0.w_1", "batch_norm_0.w_2",
                       "batch_norm_52.w_1", "batch_norm_52.w_2",
                       "conv2d_0.w_0", "conv2d_0.w_0_velocity_acc_0",
                       "fc_0.w_0", "fc_0.w_0_velocity_acc_0"]


def _rel_max(got, want):
    import numpy as np
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() or 1.0))


def _rel_norm(got, want):
    import numpy as np
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) /
                 (np.linalg.norm(want) or 1.0))


def _cpu_step(fluid, main, state, feed, names):
    """The step on the CPU from `state`, every name in `names` kept:
    (values by name, the state after)."""
    scope = fluid.Scope()
    for n, t in state.items():
        scope.set(n, t.clone())
    got = fluid.Executor(fluid.CPUPlace()).run(
        main, feed=feed, fetch_list=names, scope=scope, return_numpy=False)
    return dict(zip(names, got)), {n: scope.get(n) for n in state}


def _replay_on_card(fluid, main, fetch, state, feed, vals, after):
    """Every op of the card's plan of the step on the card, each from the
    CPU step's values of its inputs (`state` before the step, `feed`,
    `vals`); each output's max |card - cpu| / max |cpu| against the CPU's
    value (`vals`, or `after` for a persistable). A name that two ops write
    (a gradient and its sum with a later contribution) is checked at its
    last writer and read from the card's own value before it. Returns
    {name: (op type, dtype, error)}."""
    import torch
    from paddle_tpu_torch.fluid.core_types import to_torch_dtype
    from paddle_tpu_torch.fluid.interop import tensor_from_numpy
    from paddle_tpu_torch.fluid.ops import grad_ops, registry
    block = main.global_block()
    plan = fluid.executor._Plan(main, fetch)
    last_writer = {n: k for k, (op, _) in enumerate(plan.steps)
                   for n in op.output_arg_names}
    own, final = {}, set()

    def value(n):
        if n in own and n not in final:
            return own[n]
        if n in feed:
            t = tensor_from_numpy(feed[n])
        else:
            t = state[n] if n in state else vals[n]
        return t.to(device="cuda", dtype=to_torch_dtype(block.var(n).dtype))

    ctx = registry.LoweringContext("cuda")
    tape, errs = {}, {}
    with torch.no_grad():
        for k, (op, _) in enumerate(plan.steps):
            if k in plan.in_run:
                continue
            run = plan.runs.get(k, (k,))
            ops = [plan.steps[j][0] for j in run]
            env = {n: value(n) for o in ops for n in o.input_arg_names
                   if n != "@EMPTY@"}
            if len(run) > 1:
                registry.lower_group(ops, env, ctx)
            elif k in plan.taped:
                tape[k] = grad_ops.record_forward(op, env, ctx,
                                                  plan.taped[k])
            else:
                ctx.record = tape.pop(plan.grad_fwd[k]) \
                    if k in plan.grad_fwd else None
                registry.lower_op(op, env, ctx)
                ctx.record = None
            for j, o in zip(run, ops):
                for n in o.output_arg_names:
                    if n == "@EMPTY@" or n not in env:
                        continue
                    own[n] = env[n]
                    if last_writer[n] != j:
                        continue
                    final.add(n)
                    want = fluid.executor.as_numpy(
                        after[n] if n in after else vals[n])
                    got = fluid.executor.as_numpy(env[n]).reshape(
                        want.shape)
                    errs[n] = (o.type, str(env[n].dtype)[6:],
                               _rel_max(got, want))
    return errs


def _op_verdict(errs):
    """(ok, the worst output of each dtype) of a replay."""
    worst = {}
    for n, (t, dtype, e) in errs.items():
        if dtype in RESNET_OP_TOL and e > worst.get(dtype, ("", "", -1))[2]:
            worst[dtype] = (n, t, e)
    ok = all(e <= RESNET_OP_TOL[d] for d, (_, _, e) in worst.items())
    return ok, worst


def _unbiased_running_variance():
    """The batch_norm lowering with VarianceOut blended from the unbiased
    batch variance, as F.batch_norm updates it (a control)."""
    from paddle_tpu_torch.fluid.ops import nn_ops

    def lowering(ctx, inputs, attrs):
        outs = nn_ops._batch_norm(ctx, inputs, attrs)
        x, var = inputs["X"][0], inputs["Variance"][0]
        m = attrs.get("momentum", 0.9)
        n = x.numel() // var.numel()
        bvar = (outs["VarianceOut"][0] - var * m) / (1.0 - m)
        outs["VarianceOut"] = [var * m + bvar * (n / (n - 1.0)) * (1.0 - m)]
        return outs
    return lowering


def _card_step(fluid, exe, program, state, feed, fetch):
    """The whole step on the card from `state`: (the fetches by name, the
    RESNET_PARITY_STATE persistables after it as numpy)."""
    scope = fluid.Scope()
    for n, t in state.items():
        scope.set(n, t.clone())
    got = exe.run(program, feed=feed, fetch_list=fetch, scope=scope)
    return dict(zip(fetch, got)), {n: fluid.executor.as_numpy(scope.get(n))
                                   for n in RESNET_PARITY_STATE}


def _step_readings(card, card_after, cpu, cpu_after, loss):
    r = {"loss": abs(float(card[loss]) - float(cpu[loss])) /
         abs(float(cpu[loss]))}
    for n in RESNET_PARITY_GRADS:
        r[n + "@GRAD"] = _rel_norm(card[n + "@GRAD"], cpu[n + "@GRAD"])
    for n in RESNET_PARITY_STATE:
        r[n] = _rel_norm(card_after[n], cpu_after[n])
    return r


def _step_ok(r):
    return r["loss"] <= RESNET_STEP_LIMITS["loss"] and \
        max(v for k, v in r.items() if k != "loss") <= \
        RESNET_STEP_LIMITS["named"]


def phase_resnet_parity(fluid, resnet, counters):
    from unittest import mock
    import torch
    from paddle_tpu_torch.fluid.ops import nn_ops, registry
    failures = []
    programs = {}
    for dtype in ("float32", "bfloat16"):
        with fluid.unique_name.guard():
            programs[dtype] = resnet.training_programs(
                SEED, dataset="flowers", dtype=dtype)
    with fluid.unique_name.guard():
        is_test = resnet.training_programs(SEED, dataset="flowers",
                                           is_test=True)
    main, startup = programs["float32"][:2]
    scope = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=scope)
    start = {v.name: scope.get(v.name)
             for v in main.global_block().vars.values()
             if v.persistable and scope.get(v.name) is not None}
    feeds = [resnet.synthetic_batch(RESNET_PARITY_BATCH, RESNET_PARITY_IMAGE,
                                    RESNET_CLASSES, seed=SEED + 600 + i)
             for i in range(RESNET_PARITY_STEPS)]
    card_exe = fluid.Executor()
    _zero(counters)
    for dtype, (main, _, loss, acc) in programs.items():
        block = main.global_block()
        names = sorted({n for op in block.ops for n in op.output_arg_names
                        if n != "@EMPTY@" and not block.var(n).persistable})
        fetch = [loss.name, acc.name]
        grads = [loss.name] + [n + "@GRAD" for n in RESNET_PARITY_GRADS]
        state, op_readings, step_readings, controls = start, [], [], {}
        ok = True
        for i, feed in enumerate(feeds):
            vals, after = _cpu_step(fluid, main, state, feed, names)
            errs = _replay_on_card(fluid, main, fetch, state, feed, vals,
                                   after)
            step_ok, worst = _op_verdict(errs)
            named = {n: errs[n][2] for n in
                     [loss.name] + [g + "@GRAD" for g in
                                    RESNET_PARITY_GRADS] +
                     RESNET_PARITY_STATE}
            op_readings.append({"worst": worst, "named": named})
            ok = ok and step_ok
            cpu = {n: fluid.executor.as_numpy(vals[n]) for n in grads}
            cpu_after = {n: fluid.executor.as_numpy(after[n])
                         for n in RESNET_PARITY_STATE}
            r = _step_readings(*_card_step(fluid, card_exe, main, state,
                                           feed, grads),
                               cpu, cpu_after, loss.name)
            step_readings.append(r)
            if dtype == "float32":
                ok = ok and _step_ok(r)
            if i == 0:
                with mock.patch.dict(registry._LOWERINGS, batch_norm=(
                        _unbiased_running_variance())):
                    controls["unbiased_running_variance"] = _op_verdict(
                        _replay_on_card(fluid, main, fetch, state, feed,
                                        vals, after))
                if dtype == "float32":
                    with mock.patch.object(nn_ops, "CONV_FP32_PRECISION",
                                           "tf32"):
                        controls["tf32_convolutions"] = _op_verdict(
                            _replay_on_card(fluid, main, fetch, state, feed,
                                            vals, after))
                    wrong = _step_readings(
                        *_card_step(fluid, card_exe, is_test[0], state, feed,
                                    grads),
                        cpu, cpu_after, loss.name)
                    controls["is_test_program"] = (_step_ok(wrong), wrong)
            state = after
        caught = not any(c[0] for c in controls.values())
        emit({"phase": "resnet_parity", "dtype": dtype,
              "ok": ok and caught, "batch": RESNET_PARITY_BATCH,
              "image": RESNET_PARITY_IMAGE, "steps": RESNET_PARITY_STEPS,
              "lockstep": "each step, and each op, from the CPU's state",
              "op_tol": RESNET_OP_TOL, "step_limits": RESNET_STEP_LIMITS,
              "op_by_op": op_readings, "whole_step": step_readings,
              "controls": {k: {"passed": v[0], "readings": v[1]}
                           for k, v in controls.items()},
              "controls_rejected": caught})
        if not (ok and caught):
            failures.append(dtype)
    launched = {k: v for k, v in _read(counters).items() if v}
    if launched:
        failures.append("launches %s" % launched)
    if failures:
        raise AssertionError("resnet_parity: %s" % failures)
    torch.cuda.empty_cache()


# ---- persistence and inference: fluid.io, the predictor, the transpiler ----

# The artifacts and checkpoints are written under the checkout's build/
# directory (gitignored) and removed after each phase.
IO_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                      "chip_smoke_io")
RESNET_INFER_BATCH = 64
# fold vs no fold: max |folded - unfolded| / max |unfolded| logits (f32
# sums in another order only; relative to the largest logit, so free of
# the random model's scale)
FOLD_REL_MAX = 1e-4
FOLD_TIMING_ROUNDS = 5
CKPT_BATCH = 32
CKPT_STEPS = 2
CKPT_LOSS_REL_MAX = 1e-5


def _artifact_bytes(dirname):
    return sum(os.path.getsize(os.path.join(root, n))
               for root, _, names in os.walk(dirname) for n in names)


def _timed_ms(fn):
    """(result, ms) of fn() on the card, synchronized on both sides."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def phase_inference_serve(fluid, transformer, counters):
    """serve256's program saved by save_inference_model, loaded by
    load_inference_model into a fresh Scope and by create_paddle_predictor,
    and the same REQUESTS requests through the in-memory, loaded and
    predictor routes in turns: the logits bit for bit the in-memory
    program's, 12 one-pass launches a request on each route. Control: one
    element of proj.w changed in a copy of the artifact changes the
    logits. Returns the phase's launches."""
    import shutil
    import numpy as np
    import torch
    from paddle_tpu_torch.fluid.inference import (AnalysisConfig,
                                                  create_paddle_predictor)
    cfg = transformer.FLAGSHIP_CFG
    attn = 3 * cfg["n_layer"]
    serve, startup, logits = transformer.serving_programs(SEED, **cfg)
    exe, scope = fluid.Executor(), fluid.Scope()
    exe.run(startup, scope=scope)
    target = serve.global_block().var(logits)
    os.makedirs(IO_DIR, exist_ok=True)
    root = os.path.join(IO_DIR, "serve")
    shutil.rmtree(root, ignore_errors=True)
    model_dir = os.path.join(root, "model")
    with fluid.scope_guard(scope):
        _, save_ms = _timed_ms(lambda: fluid.io.save_inference_model(
            model_dir, ["src_ids", "tgt_ids"], [target], exe,
            main_program=serve))
    loaded_scope = fluid.Scope()
    with fluid.scope_guard(loaded_scope):
        (loaded, feeds, fetches), load_ms = _timed_ms(
            lambda: fluid.io.load_inference_model(model_dir, exe))
    predictor, predictor_ms = _timed_ms(
        lambda: create_paddle_predictor(AnalysisConfig(model_dir)))
    routes = {
        "in_memory": lambda f: exe.run(serve, feed=f, fetch_list=[logits],
                                       scope=scope, return_numpy=False)[0],
        "loaded": lambda f: exe.run(loaded, feed=f, scope=loaded_scope,
                                    return_numpy=False)[0],
        "predictor": lambda f: predictor.run(f, return_numpy=False)[0]}
    requests = [_request(transformer, BATCH, 256, SEED + i)
                for i in range(REQUESTS)]
    for fn in routes.values():
        fn(requests[0])                       # warm: allocator growth
    outs = {route: [] for route in routes}
    request_ms = {route: [] for route in routes}
    launched = {route: dict.fromkeys(counters, 0) for route in routes}
    total = dict.fromkeys(counters, 0)
    for feed in requests:                     # the routes in turns
        for route, fn in routes.items():
            _zero(counters)
            out, ms = _timed_ms(lambda: fn(feed))
            for k, n in _read(counters).items():
                launched[route][k] += n
                total[k] += n
            outs[route].append(out)
            request_ms[route].append(ms)
    want = dict.fromkeys(counters, 0)
    want["onepass"] = attn * REQUESTS
    same = {route: all(torch.equal(a, b) for a, b in
                       zip(outs[route], outs["in_memory"]))
            for route in ("loaded", "predictor")}
    shapes_ok = all(tuple(o.shape) == (BATCH, 256, cfg["tgt_vocab"]) and
                    bool(torch.isfinite(o.float()).all())
                    for route in outs for o in outs[route])

    # control: one element of proj.w changed in a copy of the artifact
    faulty_dir = os.path.join(root, "faulty")
    shutil.copytree(model_dir, faulty_dir)
    w_file = os.path.join(faulty_dir, "proj.w.bf16.npy")
    w = np.load(w_file)
    w[0, 0] += 1.0
    np.save(w_file, w)
    faulty_scope = fluid.Scope()
    with fluid.scope_guard(faulty_scope):
        faulty, _, _ = fluid.io.load_inference_model(faulty_dir, exe)
    faulty_out = exe.run(faulty, feed=requests[0], scope=faulty_scope,
                         return_numpy=False)[0]
    caught = not torch.equal(faulty_out, outs["in_memory"][0])
    nbytes = _artifact_bytes(model_dir)
    shutil.rmtree(root, ignore_errors=True)
    ok = all(same.values()) and shapes_ok and caught and \
        all(launched[r] == want for r in routes) and \
        feeds == ["src_ids", "tgt_ids"] and \
        [v.name for v in fetches] == [logits]
    emit({"phase": "inference_serve", "ok": ok, "requests": REQUESTS,
          "batch": BATCH, "seq_len": 256, "dtype": cfg["dtype"],
          "save_seconds": save_ms / 1e3, "artifact_bytes": nbytes,
          "load_seconds": load_ms / 1e3,
          "predictor_load_seconds": predictor_ms / 1e3,
          "request_ms": request_ms,
          "bit_for_bit_with_in_memory": same,
          "launches": launched, "launches_want": want,
          "control": {"fault": "proj.w[0, 0] + 1 in a copy of the artifact",
                      "logits_differ": caught}})
    if not ok:
        raise AssertionError("inference_serve failed: same %s, launches %s "
                             "(want %s), control caught %s"
                             % (same, launched, want, caught))
    del exe, scope, loaded_scope, predictor, faulty_scope, outs
    torch.cuda.empty_cache()
    return total


# Counts the device kernels of one request of each saved model (argv[1]:
# {label: artifact dir}; argv[2]: the feed's .npy) in a torch.profiler
# trace, in a fresh process as _COUNT_KERNELS does; prints {label: count}.
_COUNT_REQUEST_KERNELS = r"""
import json, sys
import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile
from paddle_tpu_torch.fluid.inference import (AnalysisConfig,
                                              create_paddle_predictor)
feed = {"img": np.load(sys.argv[2])}
out = {}
for label, model_dir in json.loads(sys.argv[1]).items():
    predictor = create_paddle_predictor(AnalysisConfig(model_dir))
    predictor.run(feed, return_numpy=False)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        predictor.run(feed, return_numpy=False)
        torch.cuda.synchronize()
    out[label] = sum(1 for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA)
print(json.dumps(out))
"""


def _fold_control(fluid, scope, bn_bias):
    """The folded program on a scope whose fused biases hold the batch
    norm's bias alone (the running mean left out)."""
    faulty = fluid.Scope()
    faulty._vars = dict(scope._vars)
    for fused, bias in bn_bias.items():
        faulty.set(fused, scope.get(fused).new_tensor(bias))
    return faulty


def phase_inference_resnet50(fluid, resnet, counters):
    """ResNet-50 (flowers, f32, is_test) with running statistics drawn from
    a seeded numpy generator, saved, loaded, and loaded again and folded by
    InferenceTranspiler: no batch_norm op left, the folded logits within
    FOLD_REL_MAX of the unfolded ones; control: the fused biases without
    the running mean must miss. ms and device kernels a batch of each
    program. Returns the phase's launches."""
    import shutil
    import numpy as np
    import torch
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = SEED
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        _, loss, _ = resnet.build(dataset="flowers", is_test=True)
    block = main.global_block()
    logits = block.var([op for op in block.ops
                        if op.type == "softmax_with_cross_entropy"][0]
                       .input("Logits")[0])
    exe, scope = fluid.Executor(), fluid.Scope()
    exe.run(startup, scope=scope)
    # as tests/test_inference_transpiler.py draws them: means N(0, 0.3^2),
    # variances U(0.5, 2)
    rng = np.random.RandomState(SEED)
    bn_ops = [op for op in block.ops if op.type == "batch_norm"]
    for op in bn_ops:
        n = block.var(op.input("Mean")[0]).shape[0]
        scope.set(op.input("Mean")[0], torch.from_numpy(
            (rng.randn(n) * 0.3).astype("float32")).cuda())
        scope.set(op.input("Variance")[0], torch.from_numpy(
            rng.uniform(0.5, 2.0, n).astype("float32")).cuda())
    os.makedirs(IO_DIR, exist_ok=True)
    root = os.path.join(IO_DIR, "resnet50")
    shutil.rmtree(root, ignore_errors=True)
    dirs = {"unfolded": os.path.join(root, "unfolded"),
            "folded": os.path.join(root, "folded")}
    with fluid.scope_guard(scope):
        _, save_ms = _timed_ms(lambda: fluid.io.save_inference_model(
            dirs["unfolded"], ["img"], [logits], exe, main_program=main))
    del scope
    scopes, programs = {}, {}
    for label in ("unfolded", "folded"):
        scopes[label] = fluid.Scope()
        with fluid.scope_guard(scopes[label]):
            (programs[label], _, fetches), load_ms = _timed_ms(
                lambda: fluid.io.load_inference_model(dirs["unfolded"], exe))
    fused_bias = {op.output("Y")[0] + ".fused_bn_bias":
                  scopes["folded"].get(op.input("Bias")[0]).cpu().numpy()
                  for op in bn_ops}
    fluid.transpiler.InferenceTranspiler().transpile(
        programs["folded"], fluid.CUDAPlace(0), scope=scopes["folded"])
    n_bn = {label: sum(op.type == "batch_norm"
                       for op in p.global_block().ops)
            for label, p in programs.items()}
    with fluid.scope_guard(scopes["folded"]):
        fluid.io.save_inference_model(
            dirs["folded"], ["img"], fetches, exe,
            main_program=programs["folded"])
    img = resnet.synthetic_batch(RESNET_INFER_BATCH, RESNET_IMAGE,
                                 RESNET_CLASSES, seed=SEED)["img"]
    feed = {"img": img}
    run = lambda label, s=None: exe.run(
        programs[label], feed=feed, scope=s or scopes[label],
        return_numpy=False)[0].float()
    total = dict.fromkeys(counters, 0)
    out, ms = {}, {label: [] for label in programs}
    for label in programs:
        run(label)                            # warm
    _zero(counters)
    for _ in range(FOLD_TIMING_ROUNDS):       # in turns
        for label in programs:
            out[label], t = _timed_ms(lambda: run(label))
            ms[label].append(t)
    launched = _read(counters)
    for k, n in launched.items():
        total[k] += n
    ref = out["unfolded"]
    scale = float(ref.abs().max())
    rel_err = float((out["folded"] - ref).abs().max()) / scale
    top1 = float((out["folded"].argmax(-1) == ref.argmax(-1)).float().mean())
    faulty = _fold_control(fluid, scopes["folded"], fused_bias)
    control_err = float((run("folded", faulty) - ref).abs().max()) / scale

    np.save(os.path.join(root, "img.npy"), img)
    counted = subprocess.run(
        [sys.executable, "-c", _COUNT_REQUEST_KERNELS, json.dumps(dirs),
         os.path.join(root, "img.npy")], capture_output=True, text=True,
        timeout=600, cwd=os.path.dirname(os.path.abspath(__file__)))
    if counted.returncode:
        raise RuntimeError("counting the ResNet-50 kernels failed:\n%s"
                           % counted.stderr[-3000:])
    kernels = json.loads(counted.stdout.strip().splitlines()[-1])
    nbytes = _artifact_bytes(dirs["unfolded"])
    shutil.rmtree(root, ignore_errors=True)
    ok = n_bn == {"unfolded": 53, "folded": 0} and rel_err <= FOLD_REL_MAX \
        and control_err > FOLD_REL_MAX and bool(torch.isfinite(ref).all()) \
        and launched == dict.fromkeys(counters, 0)
    emit({"phase": "inference_resnet50", "ok": ok,
          "batch": RESNET_INFER_BATCH, "image": RESNET_IMAGE,
          "dtype": "float32", "save_seconds": save_ms / 1e3,
          "artifact_bytes": nbytes, "load_seconds": load_ms / 1e3,
          "batch_norm_ops": n_bn, "folded_rel_err": rel_err,
          "rel_err_max": FOLD_REL_MAX, "top1_agreement": top1,
          "ms_per_batch": ms, "device_kernels_per_batch": kernels,
          "port_kernel_launches": launched,
          "control": {"fault": "fused bias = bn bias (running mean left "
                               "out)", "rel_err": control_err}})
    if not ok:
        raise AssertionError("inference_resnet50 failed: batch norms %s, "
                             "rel err %g, control %g, launches %s"
                             % (n_bn, rel_err, control_err, launched))
    del scopes, programs, faulty
    torch.cuda.empty_cache()
    return total


def _rel(a, b):
    import numpy as np
    return float(np.max(np.abs(a - b) / np.abs(b)))


def phase_checkpoint(fluid, transformer, counters):
    """The flagship training program (dropout 0.1) at CKPT_BATCH: run A
    takes CKPT_STEPS steps, save_checkpoint, CKPT_STEPS more; run B
    load_checkpoint's into a fresh Scope (every persistable and generator
    state bit for bit the saved one) and takes the same steps, its losses
    within CKPT_LOSS_REL_MAX of A's. Control: a resume without the
    generator states, whose dropout masks differ, must miss. Returns the
    phase's launches."""
    import shutil
    import torch
    cfg = transformer.FLAGSHIP_CFG
    main, startup, loss = transformer.training_programs(SEED, **cfg)
    batch = lambda seed: _stacked(transformer.synthetic_batch(
        CKPT_BATCH, cfg["seq_len"], cfg["tgt_vocab"], seed), CKPT_STEPS)
    exe, scope = fluid.Executor(), fluid.Scope()
    exe.run(startup, scope=scope)
    _zero(counters)
    steps = lambda s: exe.run_steps(main, feed=batch(SEED + 1),
                                    n_steps=CKPT_STEPS, fetch_list=[loss],
                                    scope=s)[0]
    exe.run_steps(main, feed=batch(SEED), n_steps=CKPT_STEPS,
                  fetch_list=[loss], scope=scope)
    os.makedirs(IO_DIR, exist_ok=True)
    ckpt = os.path.join(IO_DIR, "ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    with fluid.scope_guard(scope):
        _, save_ms = _timed_ms(lambda: fluid.io.save_checkpoint(
            exe, ckpt, main, step=CKPT_STEPS))
    names = [v.name for v in main.list_vars() if v.persistable and
             scope.get(v.name) is not None]
    saved = {n: scope.get(n).clone() for n in names}
    gens = {k: g.get_state() for k, g in scope._generators.items()}
    run_a = steps(scope)
    nbytes = _artifact_bytes(ckpt)
    resumed = fluid.Scope()
    with fluid.scope_guard(resumed):
        meta, load_ms = _timed_ms(
            lambda: fluid.io.load_checkpoint(exe, ckpt, main))
    state_equal = all(torch.equal(resumed.get(n), saved[n]) for n in names)
    gens_equal = set(resumed._generators) == set(gens) and all(
        torch.equal(resumed._generators[k].get_state(), s)
        for k, s in gens.items())
    devices = sorted({str(resumed.get(n).device) for n in names})
    run_b = steps(resumed)
    control = fluid.Scope()
    with fluid.scope_guard(control):
        fluid.io.load_checkpoint(exe, ckpt, main)
    control._generators.clear()
    run_c = steps(control)
    launched = _read(counters)
    shutil.rmtree(ckpt, ignore_errors=True)
    rel_b, rel_c = _rel(run_b, run_a), _rel(run_c, run_a)
    ok = state_equal and gens_equal and meta.get("step") == CKPT_STEPS and \
        rel_b <= CKPT_LOSS_REL_MAX and rel_c > CKPT_LOSS_REL_MAX and \
        devices == [str(exe.device)]
    emit({"phase": "checkpoint", "ok": ok, "batch": CKPT_BATCH,
          "seq_len": cfg["seq_len"], "dropout_rate": cfg["dropout_rate"],
          "persistables": len(names), "generators": len(gens),
          "checkpoint_bytes": nbytes, "save_seconds": save_ms / 1e3,
          "load_seconds": load_ms / 1e3, "state_bit_for_bit": state_equal,
          "generators_bit_for_bit": gens_equal, "loaded_on": devices,
          "losses_a": run_a.tolist(), "losses_b": run_b.tolist(),
          "loss_rel_err": rel_b, "rel_err_max": CKPT_LOSS_REL_MAX,
          "control": {"fault": "resume without the generator states",
                      "losses": run_c.tolist(), "loss_rel_err": rel_c},
          "launches": launched})
    if not ok:
        raise AssertionError("checkpoint failed: state %s, generators %s, "
                             "loss rel %g, control %g, devices %s"
                             % (state_equal, gens_equal, rel_b, rel_c,
                                devices))
    del exe, scope, resumed, control, saved
    torch.cuda.empty_cache()
    return launched


def _path_numbers(s, path):
    """A kernel's numbers over a path's mix of cases (weighted means)."""
    w = s["weight"]
    return {"path": path, "ms": s["kernel_ms"] / w,
            "plain_ms": s["plain_ms"] / w, "bound_ms": s["bound_ms"] / w,
            "bound_by": "operations" if 2 * s["ops_bound_ms"] >= s["bound_ms"]
            else "bytes",
            "library_ms": s["library_ms"] / w if s["library"] else None}


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    try:
        import paddle_tpu_torch.fluid as fluid
        from paddle_tpu_torch.models import bert, deepfm, resnet, transformer
        from paddle_tpu_torch.ops import attention as A
    except ImportError as e:
        print("chip_smoke: run from the root of a checkout (%s)" % e,
              file=sys.stderr)
        return 2

    phase_build()
    summary, max_err = phase_kernels()
    counters = _counters()
    launches = dict.fromkeys(counters, 0)

    def add(launched):
        for k, n in launched.items():
            launches[k] += n

    exe, scope = fluid.Executor(), fluid.Scope()   # CUDAPlace(0)
    _zero(counters)
    check = phase_serve256(fluid, transformer, A, exe, scope)
    add(_read(counters))
    _zero(counters)
    phase_serve4096(fluid, transformer, A, exe, scope)
    add(_read(counters))
    phase_logits_control(exe, scope, *check)
    del exe, scope, check
    torch.cuda.empty_cache()

    cfg = dict(transformer.FLAGSHIP_CFG)
    attn = 3 * cfg["n_layer"]
    none = dict.fromkeys(counters, 0)
    # one Adam launch a step for the 67 parameters the kernel takes
    train = dict(none, onepass=attn, onepass_bwd=attn, adam=1)
    add(_train_phase("train256", fluid, transformer, counters, cfg,
                     TRAIN_BATCH, TRAIN_STEPS, train))
    # 1 CE forward and backward, a LayerNorm backward for each of the
    # 2 * 4 encoder and 3 * 4 decoder layer norms, one grad per embedding
    flagged = dict(train, ce_fwd=1, ce_bwd=1, ln_bwd=5 * cfg["n_layer"])
    for impl in ("scatter", "segsum"):
        with _env(FLAGS_emb_grad_kernel=impl, **KERNEL_FLAGS):
            add(_train_phase("train256_kernels", fluid, transformer,
                             counters, cfg, TRAIN_BATCH, TRAIN_STEPS,
                             dict(flagged, **{"emb_" + impl: 2})))
    phase_train_parity(fluid, transformer, counters)
    add(_train_phase("train4096", fluid, transformer, counters,
                     dict(cfg, seq_len=LONG_SEQ), LONG_TRAIN_BATCH,
                     LONG_TRAIN_STEPS,
                     dict(none, flash=attn, flash_bwd_dq=attn,
                          flash_bwd_dkv=attn, adam=1)))
    # bench.py's wide Transformer (WIDE_CFG_OVERRIDES, WIDE_BATCH): D = 256,
    # the one-pass kernels at DP = 256
    wide = dict(cfg, **WIDE_CFG_OVERRIDES)
    add(_train_phase("train256_wide", fluid, transformer, counters, wide,
                     WIDE_BATCH, TRAIN_STEPS, train))
    phase_train_parity(fluid, transformer, counters, "train_parity_wide",
                       dict(wide, n_layer=1), WIDE_PARITY_GRADS,
                       PARITY_FLAGS[:1])

    # bench.py's BERT-base leg: 12 encoder layers, each one one-pass
    # attention forward and backward (T 128, D 64); Adam's 74 admitted
    # parameters in 2 launches; with the flags, a LayerNorm backward for the
    # embedding's and each layer's 2, and no CE kernel (V 30,522 and 2) or
    # embedding-grad kernel ([30522, 768], [2, 768]): the gates refuse them
    bcfg = bert.BERT_BASE_CFG
    bert_train = dict(none, onepass=bcfg["n_layer"],
                      onepass_bwd=bcfg["n_layer"], adam=2)
    with fluid.unique_name.guard():
        add(_bert_phase("bert_base", fluid, bert, counters, bcfg,
                        bert.BERT_BASE_BATCH, TRAIN_STEPS, bert_train))
    with fluid.unique_name.guard(), \
            _env(FLAGS_emb_grad_kernel="scatter", **KERNEL_FLAGS):
        add(_bert_phase("bert_base_kernels", fluid, bert, counters, bcfg,
                        bert.BERT_BASE_BATCH, TRAIN_STEPS,
                        dict(bert_train, ln_bwd=2 * bcfg["n_layer"] + 1)))
    with fluid.unique_name.guard():
        phase_bert_parity(fluid, bert, counters,
                          dict(bcfg, n_layer=BERT_PARITY_LAYERS))
    # bench.py's DeepFM leg: sparse tables, one Adam launch a step
    with fluid.unique_name.guard():
        add(_deepfm_phase(fluid, deepfm, counters, deepfm.DEEPFM_BENCH_CFG,
                          deepfm.DEEPFM_BENCH_BATCH, DEEPFM_STEPS))
    with fluid.unique_name.guard():
        phase_deepfm_parity(fluid, deepfm, counters,
                            deepfm.DEEPFM_BENCH_CFG,
                            deepfm.DEEPFM_BENCH_BATCH)

    # bench.py's ResNet-50 leg: no kernel of the port's on its path, with
    # the kernel flags on too (the CE gate refuses V = 1000)
    with fluid.unique_name.guard():
        main_prog = resnet.training_programs(
            SEED, dataset="flowers", dtype=resnet.RESNET_BENCH_DTYPE)[0]
        _momentum_group_check(fluid, main_prog)
        del main_prog
    with fluid.unique_name.guard():
        add(_resnet_phase("resnet50", fluid, resnet, counters,
                          resnet.RESNET_BENCH_BATCH, RESNET_STEPS))
    with fluid.unique_name.guard(), \
            _env(FLAGS_emb_grad_kernel="scatter", **KERNEL_FLAGS):
        add(_resnet_phase("resnet50_kernels", fluid, resnet, counters,
                          resnet.RESNET_BENCH_BATCH, 2))
    phase_resnet_parity(fluid, resnet, counters)

    # a trained or built model saved, loaded, resumed and served
    add(phase_inference_serve(fluid, transformer, counters))
    with fluid.unique_name.guard():
        add(phase_inference_resnet50(fluid, resnet, counters))
    add(phase_checkpoint(fluid, transformer, counters))

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
          else "nvidia-smi: %s" % smi.stderr.strip())
    sources = {"onepass": "attention.cu", "flash": "attention.cu",
               "onepass_bwd": "attention_bwd.cu",
               "flash_bwd_dq": "attention_bwd.cu",
               "flash_bwd_dkv": "attention_bwd.cu", "adam": "adam.cu",
               "ce_fwd": "ce.cu", "ce_bwd": "ce.cu", "ln_bwd": "layernorm.cu",
               "emb_scatter": "emb_grad.cu", "emb_segsum": "emb_grad.cu"}
    # the forward kernels are summarised over the serving mix (as in the
    # first slice), the others over the training paths'
    paths = {"onepass": "serve256", "flash": "serve4096",
             "onepass_bwd": "train256", "flash_bwd_dq": "train4096",
             "flash_bwd_dkv": "train4096", "adam": "train",
             "ce_fwd": "train256", "ce_bwd": "train256", "ln_bwd": "train256",
             "emb_scatter": "train256", "emb_segsum": "train256"}
    kernels = []
    for name, path in paths.items():
        row = {"name": counters[name].__name__, "route": "cuda",
               "source": "paddle_tpu_torch/ops/csrc/" + sources[name],
               "replaces": REPLACES[name], "launches": launches[name],
               "max_abs_err": max_err[name]}
        row.update(_path_numbers(summary[(name, path)], path))
        if "host_ms" in summary[(name, path)]:
            row["host_ms"] = summary[(name, path)]["host_ms"]
        kernels.append(row)
        # the attention rows also summarised over the D = 256 path's mix
        # (train256_wide), and rows 1, 3, 8 and 11 at BERT-base's shapes,
        # where the kernel runs on those paths
        for key, sub in (("d256", "train256_wide"), ("bert_base",
                                                     "bert_base")):
            extra = summary.get((name, sub))
            if extra:
                row[key] = _path_numbers(extra, sub)
                if "host_ms" in extra:
                    row[key]["host_ms"] = extra["host_ms"]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
