"""Drive the PyTorch port (paddle_tpu_torch) on one NVIDIA card.

Run from the root of a checkout, on a machine with a CUDA card and the CUDA
toolkit:

    python3 chip_smoke.py
    python3 chip_smoke.py --control-flow   # build, then phases 42-45 only
    python3 chip_smoke.py --sequences      # build, then phases 46-49 only
    python3 chip_smoke.py --recurrent      # build, then phases 49a-51 only
    python3 chip_smoke.py --decoding       # build, then phases 52-55 only
    python3 chip_smoke.py --ctc            # build, then phases 56-60 only
    python3 chip_smoke.py --fusion         # build, then phases 61-65 only
    python3 chip_smoke.py --host-io        # build, then phases 66-67 only
    python3 chip_smoke.py --recordio       # build, then phases 68-70 only

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
11b. train256_recipe - train256 under the Fluid Transformer's recipe
              (PaddlePaddle/models transformer config.py), built through
              the public API: transformer.build(label_smooth_eps=0.1), then
              Adam(noam_decay(512, 8000) * 2.0, beta1 0.9, beta2 0.997,
              epsilon 1e-9).minimize; bench.py's config and batch, nothing
              cut, one warm step then 4 through run_steps. Each step must
              launch 12 one-pass forward, 12 one-pass backward and 1 Adam
              kernel (67 parameters) and no cross-entropy kernel (soft
              labels); the learning rate fetched at each step must lie
              within 1e-6 of 2 * 512^-0.5 * min(s^-0.5, s * 8000^-1.5),
              @LR_DECAY_COUNTER@ after the window must equal the steps run,
              and one more step may wait for the card only in the
              executor (torch.cuda.set_sync_debug_mode's report).
11c. recipe_parity - the recipe at 1 + 1 layers, full width, dropout 0,
              batch 2: one step on the card and on the CPU within
              train_parity's limits; control: label_smooth's epsilon 0 (the
              raw one-hot) on the card.
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
              losses bit for bit. Control: the resume without the
              generator states must miss.
24. se_resnext50 - SE-ResNeXt-50 at full width (3x224x224, 1000 classes,
              cardinality 32, reduction 16, bf16, Adam(1e-3) as
              benchmark/fluid_benchmark.py trains it) at batch 64: one warm
              step, then 4 steps through run_steps; images/s, step ms,
              peak memory, model TFLOP/s, and each step one Adam launch
              covering the 19 parameters the kernel takes, nothing else.
              Then se_resnext50_adam_routes: the step's 225 adam ops
              through the executor's group lowering, all, the 19 the
              kernel takes and the 206 of the plain route, each route's
              device ms and kernels (torch.profiler) and host ms.
25. se_resnext_parity - resnet_parity's check of the same program at batch
              4 on 3x64x64 images (dropout_prob set to 0), float32 and
              bfloat16, 3 steps in lockstep; control: each excitation's
              sigmoid made the identity on the card (op by op, and the
              float32 whole step).
26. zoo     - every model of tools/torch_fluid_benchmark.py but the two
              recurrent ones (mnist, resnet, vgg, se_resnext,
              transformer, deepfm), built by the tool's build_programs,
              at batch 64: one warm step, then 2 steps through
              run_steps; examples/s, step ms, peak memory and launches
              (Adam 0, 0, 1, 1, 1, 1 a step; the transformer also 12
              one-pass forward and 12 backward), each Adam launch over
              the shapes of ZOO_ADAM_CASES, which the kernel cases hold
              against the plain version. Then the mnist MLP for 3 steps
              on the card and on the CPU from the same parameters: losses
              within 1e-5 relative.
23a. row_sums - (before checkpoint) scatter_rows_ and _merge_rows twice
              on the card on the same inputs (Zipf ids over DeepFM's
              100,000-row tables, a 2-row table of BERT's width, negative
              and out-of-range ids): equal bits, and the CPU's index_add_.
              Also the NN lowerings' row sums twice, equal bits:
              hierarchical_sigmoid's W and Bias gradients (16,384 Zipf
              labels over 2,073 classes), tree_conv's child sums and
              gradients at nn_chain's widths, and add_along_rows_ (sampled
              softmax's gradient) on [16384, 8192] logits.
27. optimizers - every other Fluid optimizer (LarsMomentum, Adagrad dense
              and sparse on an is_sparse embedding, Adamax, DecayedAdagrad,
              Adadelta, RMSProp plain and centered with momentum, Ftrl at
              lr_power -0.5 and -0.7), ModelAverage (5 steps, apply and
              restore) and append_LARS with Momentum on the mnist MLP in
              float32, 3 steps in lockstep with the CPU (as resnet_parity):
              each step's loss within 1e-5 relative, and each op replayed
              on the card from the CPU's inputs within RESNET_OP_TOL;
              control: RMSProp's decay changed on the card. Then each
              learning-rate schedule for 12 steps on the card against its
              closed form (within 1e-6 of its largest rate) and its step
              counter.
28. book    - the Fluid book's straight-line models (tools/
              torch_book_models.py: fit_a_line, recognize_digits_conv,
              image_classification at ResNet-32, word2vec,
              recommender_system) at the book's widths and batches: one
              warm step and 4 steps through run_steps each (examples/s,
              step ms, peak memory, op count, no port kernel launched),
              then 3 steps in lockstep with the CPU (as optimizers);
              recognize_digits_conv also on batches holding ignore_index
              labels, and its control (cross_entropy without its mask on
              the card) must fail; word2vec twice from one state, bit for
              bit.
29. tensor_layers - tools/torch_tensor_programs.py's tensor_chain (train256's
              heads through split, stack, unstack, reverse, pad, crop,
              unsqueeze, squeeze, expand and multiplex; BERT-base's
              masked-LM gather and scatter back, overwrite False and True;
              ResNet-50's conv2 maps through pad2d, conv2d,
              shuffle_channel, space_to_depth, pad_constant_like and crop;
              bf16, Adam(1e-4)) at those widths: one warm step and 4
              through run_steps, one Adam launch a step over its 3 fc
              weights; then 3 steps in lockstep with the CPU at fewer
              sequences and maps (each op within RESNET_OP_TOL, the ops
              that move or pick values bit for bit, losses within 1e-5);
              gather's and scatter(overwrite=False)'s gradients twice from
              one state, bit for bit. Control: scatter with overwrite=True
              keeping the first of repeated updates on the card.
30. serve_ids - serve256's program with argmax, argsort,
              sampling_id(softmax), has_nan and has_inf of its logits
              appended: 4 requests of batch 8, 12 one-pass launches each;
              argmax and argsort equal to the CPU's on the card's logits;
              sampled ids in the vocabulary; the ms a request the ids add.
              sampling_id on 65,536 rows of a 16-class distribution passes
              a chi-square test (p > 1e-4); control: the distribution
              shifted by one class must fail it.
31. initializers - init_zoo's startup on the card: Bilinear ([256, 256, 4,
              4]) and NumpyArrayInitializer (the [256, 512] sinusoid table,
              an int32 table) bit for bit; TruncatedNormal(0, 0.02) on
              [8192, 512] within 2 std at variance 0.7737 std^2; MSRA
              uniform and normal on [512, 512, 3, 3] at variance 2 / fan_in
              (uniform within sqrt(6 / fan_in)); moments within 5 standard
              errors. Control: an untruncated normal must fail.
32. fc_gan    - examples/fc_gan.py's D and G programs, 60 steps of each in
              lockstep with the CPU: losses within 1e-5; each step leaves
              the other net's parameters bit for bit. Control: the D
              optimizer without parameter_list moves G's.
33. fgsm_digits - FGSM adversarial training of the book's digits model
              (tools/torch_grad_programs.py: fluid.gradients of the loss in
              the image, a step of 0.1 along its sign, the same net on it
              sharing every parameter, Adam on the mean of both losses) at
              the book's widths, batch 64: one warm step and 4 through
              run_steps, each adversarial loss above its clean loss, no
              port kernel; 3 steps in lockstep with the CPU (each op
              replayed, losses within 1e-5). Control: sign as the identity
              on the card.
34. input_grads_resnet50 - inference_resnet50's program (f32, is_test,
              drawn running statistics) with two fluid.gradients over its
              one forward (the FGSM direction, then the class-score
              saliency map from one_hot(label)) at batch 64: ms a batch,
              peak memory, busy share (torch.profiler), no port kernel; the
              loss on adv above the clean loss; at batch 4 on 3x128x128 each
              op replayed from the CPU's values and the whole run's loss,
              adv and map against the CPU. Control: the is_test batch
              norm's gradient in its training form on the card.
35. nets      - fluid.nets at its users' widths, forward and backward under
              SGD: img_conv_group as VGG-16's first block (batch 64, f32),
              glu over a [8192, 4096] bf16 fc, scaled_dot_product_attention
              at train256's widths ([256, 256, 512], 8 heads, bf16) and an
              fc over three bf16 inputs (512, 512, 2048): a window each, no
              port kernel, then lockstep with the CPU at small batches.
              Control: the attention's 1/sqrt(d) scale ignored on the card.
36. bhtd_attention - the fused_attention op in its default [B, H, T, D]
              layout at [8, 8, 4096, 64] bf16, causal and not, with
              fluid.gradients of q, k, v: each run launches the flash
              forward, dq and dkv kernels once; out and the gradients equal
              the bthd route's on the transposed tensors bit for bit; both
              routes' ms. At T 256 the dense reference, no launch. Control:
              the bthd route on the untransposed tensors must differ.
37. check_nan_inf - train256's step through Executor.run with the
              FLAGS_check_nan_inf scan on and off, in turns from one state:
              losses and state bit for bit, step ms of both; log of a
              negative feed raises FloatingPointError naming its output.
              Control: with the scan off it returns NaN.
38. dcgan     - DCGAN at dcgan.torch's widths (tools/torch_nn_programs.py:
              nz 100, ngf = ndf = 64, 64x64x3, batch 64, f32, Adam(2e-4,
              0.5)): one warm D and G step, 4 D and 4 G steps through
              run_steps (ms a D and a G step, peak memory, busy share, no
              port kernel); 2 alternating D and G steps in lockstep with
              the CPU at batch 8 (each op replayed, losses within 1e-5, the
              other net's parameters untouched). Control: G's transposed
              convolution filters flipped spatially on the card.
39. stn_digits - a spatial transformer (PyTorch's STN tutorial's
              localisation net, affine_grid, grid_sampler) before the
              book's digits net, batch 64: a window, 3 lockstep steps from
              the identity transform. Control: grid_sampler over half-pixel
              coordinates on the card.
40. word2vec_hsigmoid - the book's word2vec (dict 2073) with hsigmoid in
              place of its softmax, batch 100: a window, 3 lockstep steps,
              the W and bias gradients twice, bit for bit. Control: the
              path codes inverted on the card.
41. nn_layers - nn_chain: group_norm, affine_channel, lrn, fsp, a grouped
              Bilinear conv2d_transpose, the resizes and adaptive pooling
              on ResNet-50's conv2 maps; C3D's first blocks (conv3d,
              pool3d, conv3d_transpose, adaptive_pool3d) on [8, 3, 16, 112,
              112]; row_conv, im2sequence, bilinear_tensor_product,
              conv_shift, data_norm, tree_conv and similarity_focus; sampled
              softmax (customized and uniform), sample_logits over [16384,
              8192] logits and spectral_norm of D's [512, 256, 4, 4] weight;
              f32, Adam(1e-4): a window (one Adam launch a step over the LM
              head's weight, busy share), 2 lockstep steps of the
              deterministic parts at smaller maps, clips and rows; the
              drawing heads' invariants at full width; spectral_norm's
              sigma after 20 steps against float64 power iteration and the
              largest singular value. Control: the antialiasing shrink
              without antialiasing on the card.
42. rnn_encoder_decoder - the Fluid book's RNN encoder-decoder
              (tools/torch_control_flow_programs.py: two StaticRNNs, an fc
              head, Adam(5e-3)) at the WMT-14 seq2seq's widths (dictionary
              30,000, embedding and hidden 512, T 32, batch 64, f32): one
              warm step and 4 through run_steps, one Adam launch a step
              over its 6 admitted parameters, busy share; the trained model
              saved, loaded and served a batch of 8 on the card and the CPU
              (ms and host syncs a request); 30 lockstep steps at the book
              test's widths, each recurrent op replayed as one op.
              Control: the card's recurrent ops run their steps reversed.
43. while_loop - benchmark/predictor_bench.py's While model (8 trips, fc
              32) saved without the AOT export and served 20 requests (ms
              and host syncs a request, the CPU serving the same
              artifact); trained at width 1,024, batch 256 through
              while_grad (the inferred bound): a window, busy share, 3
              lockstep steps; a dropout body keeps one mask on every trip.
              Control: max_trip_count two below the trips, every
              parameter's gradient NaN on the card.
44. switch_ifelse - the Switch programs of
              tests/test_control_flow_grad.py (taken, untaken, default) at
              width 1,024, batch 256, one lockstep step each (the untaken
              case's x gradient exactly 0), and the IfElse regressor: a
              window, busy share, 3 lockstep steps. Control: the untaken
              branch given a gradient on the card.
45. tensor_arrays - every array op at BERT-base's widths ([256, 128, 768]
              bf16 hidden states, lengths 1-128), inputs made on the card
              first: ms a run, peak memory, busy share; every output equals
              the CPU's bit for bit, no port kernel launches. Control:
              shrink_memory keeping the rows whose length equals the step.
46. understand_sentiment_conv - the Fluid book's convolution_net
              (tools/torch_sequence_programs.py: an is_sparse embedding
              [5,148, 128] of ragged words, two sequence_conv_pools of 512
              filters, Adagrad(0.002)) at batch 128 on IMDB-shaped review
              lengths (T 1,024 or 2,048): one warm step and 4 through
              Executor.run, each batch its own T (step ms, examples, real
              and padded tokens a second, peak memory, no port kernel),
              busy share and the top kernels of a step; saved, loaded and
              served at batch 8 on the card and the CPU; the pad ids
              rewritten, the step bit for bit; 3 lockstep steps at batch
              16. Controls: every length set to T, every length one short.
47. understand_sentiment_dyn_rnn - the book's DynamicRNN LSTM at the same
              widths: 2 steps (a recurrent op over every padded step),
              busy share at T 256, each row's last memory its hidden
              state at its length - 1 bit for bit, 2 lockstep steps.
48. recommender_system - the book's whole recommender (its movie tower's
              ragged categories and title) at batch 256: a window, busy
              share, the pad ids rewritten, 3 lockstep steps.
49. sequence_chain - every sequence lowering and pool type at BERT-base's
              widths (x [256, 128, 768] f32, lengths 1-128; ids [256,
              128]): a window with one Adam launch a step over the
              sequence_conv filter [2,304, 768], host syncs a step, busy
              share; 2 lockstep steps at batch 32, the ops that move
              values bit for bit. Control: sequence_reverse reversing the
              padding too on the card.
49a. zoo     - (the phase of 26) the tool's stacked_dynamic_lstm and
              machine_translation (1 Adam launch a step each), with their
              busy share and host syncs a step.
50. rnn_lockstep - the tool's stacked_dynamic_lstm and machine_translation
              at its widths (batch 64), 3 steps each in lockstep with the
              CPU: every op replayed on the card from the CPU's values
              within 1e-4, losses within 1e-5; machine_translation's
              fc_2.w_0 gradient, which cancels to noise, within 4 times
              the CPU's own error against the step in float64. Controls:
              dynamic_lstm's and dynamic_gru's Length dropped on the
              card, their is_reverse flipped, their input's gradient
              0.1% too large, and fc_2.w_0's gradient 1% too large (the
              last two must be named the worst output).
51. rnn_chain - every recurrent lowering in one language model
              (tools/torch_rnn_programs.py: dynamic_lstm with peepholes,
              op lstm reversed, dynamic_gru in origin mode, op gru
              reversed, an LSTMP of 2,048 cells projected to 512,
              cudnn_lstm at 2 layers bidirectional, gru_unit and
              lstm_unit in a StaticRNN) at the PTB "medium" LSTM's widths
              (vocabulary 10,000, hidden 650, T 35, batch 20, lengths
              1-35), f32, Adam(1e-3): a window (one Adam launch a step
              over the LSTMP's two weights), host syncs a step, busy
              share; 2 lockstep steps, forward and backward of every
              lowering. Controls: cudnn_lstm's backward direction run
              forward on the card, and its input's gradient 0.1% too
              large there (which must be named the worst output).
52. book_machine_translation - the Fluid book's machine translation
              (tools/torch_decode_programs.py: an fc encoder, a DynamicRNN
              decoder, Adam(5e-3)) at the WMT-14 seq2seq's widths
              (dictionary 30,000, embedding and hidden 512, T 32, batch
              64, f32): a window with one Adam launch a step over its 4
              admitted parameters, busy share, host syncs a step; trained
              2 steps, saved by save_persistables, loaded into a fresh
              scope, and 4 beam-search requests (fluid.contrib's
              BeamSearchDecoder: 8 sources of 2 rows, top-k 50, 32 steps,
              then beam_search_decode): ms, tokens a second, no port
              launch, device kernels and busy share, no host sync inside
              the search.
53. book_label_semantic_roles - the book's chapter 7 (eight ragged
              features, depth 8 of dynamic_lstm, linear_chain_crf,
              crf_decoding, SGD) at its widths (batch 10, sentences of 5-50
              words): one warm step and 4 through Executor.run, busy share,
              host syncs a step; 4 tagging requests (the is_test program
              whose crf_decoding outputs the tags) from the trained scope.
54. word2vec_nce - the book's word2vec with nce (dictionary 2,073, 10
              negatives, batch 100): a window; the nce lowering's draws on
              the card held by their invariants (labels first, in range,
              the same on every call, another for another seed, logits and
              cost against float64, uniform by chi-square).
55. decode_lockstep - the three programs' steps in lockstep with the CPU
              (every op replayed within 1e-4, ints exactly, losses within
              1e-5; the card's nce drawing the CPU generator's negatives);
              the beam and tagging requests replayed op by op from the
              CPU's values, and both whole on the card against the CPU,
              a beam's ids or a Viterbi path differing only after a
              decision whose CPU candidates lie within 2^-20 of each
              other (counted; a beam's ids exact and its scores within
              1e-4 before its source's first). Controls, each named
              the worst output: beam_search taking each row's best, not
              the source's top 2; beam_search_decode following each
              parent one step late; the CRF forward without its stop row;
              Viterbi's last tag without stop; nce without the negatives'
              bias (0 at the first step: its gradient is named).
56. crnn_ctc  - PaddlePaddle/models' CRNN-CTC text recognizer
              (tools/torch_ctc_pool_programs.py: gray 48 x 512 images, 95
              classes and the blank, two GRUs of 200 over T 64, warpctc,
              Momentum, batch 32): a run_steps window, the
              evaluator.EditDistance's eval() and the true edit distance
              after it, busy share, kernels and host syncs a step (none in
              the slice's lowerings); then 4 decode requests of 32 images
              from the trained scope (ctc_greedy_decoder).
57. segnet_basic - SegNet-Basic at CamVid's 3 x 352 x 480, 11 classes,
              batch 12 (four index pools and four unpools): a window,
              mean_iou each step (its counts add up to the pixels),
              images/s, model TFLOP/s, busy share, host syncs.
58. spp_net   - SPP-net ZF-5 at 224, batch 64 (spp's 4 x 4, 2 x 2, 1 x 1
              levels): a window, images/s, model TFLOP/s, busy share.
59. ctc_pool_chain - every case the three models do not reach, each at
              its named shape (C3D's pool1 by max_pool3d_with_index,
              SegNet's uncropped 45 x 60 -> 23 x 30 adaptive bins,
              ResNet-50's padded stem and global pools, unpool over
              repeated indices, spp by average, warpctc with an infeasible
              row, ctc_align and edit_distance at CRNN's decode,
              precision_recall over 1,000 classes): a window, its outputs
              checked, busy share, kernels and host syncs a step.
60. ctc_pool_lockstep - the four programs (with ctc_pool_chain: every
              case the models do not reach) at narrow widths in lockstep
              with the CPU: every op replayed within 1e-4, Masks, the
              aligned ids, the edit distances and mean_iou's counts exact,
              losses within 1e-5, the tied windows counted. Controls, each
              named the worst output: CTC with the skip between equal
              labels allowed, the index pools' gradient sent whole to the
              first maximum, unpool's first write winning, edit_distance
              normalized by the hypothesis's length, ctc_align without
              merging.
61. fused_stacked_lstm - the stacked LSTM with its fc -> dynamic_lstm
              pairs fused (fusion_lstm), Adam: window, step phase, the
              unfused twin's busy share, one step of each from one state,
              folded (fused_embedding_fc_lstm) and unfused requests.
62. fused_ctr - a Criteo-shaped CTR model through the embedding, pool,
              FM and tower fusions: window, step phase, its twin, requests.
63. fused_resnet50 - ResNet-50's request folded by InferenceTranspiler,
              its conv epilogues fused (conv2d_fusion), against the
              unfused request.
64. fusion_chain - every other fused op at its source's shape, forward and
              backward.
65. fusion_lockstep - the fused programs and requests in lockstep with
              the CPU; four controls.
66. input_pipeline - ResNet-50 from a PyReader and as numpy feeds, the
              stacked LSTM from a DataFeeder, the py_reader chain, the
              graph readers to EOFException, the CTR reader.
67. host_ops_chain - Go blocks, split and merge of DeepFM's ids, py_func in
              a training step, the combined save and load of ResNet-50's
              persistables, delete_var, fake_init, the engine stubs; then
              host_io_lockstep: their exact values against the CPU's,
              two controls.
68. recordio_io - the flowers dataset's 256 images written into a record
              file and over 4, read by RecordScanner and by the threaded
              feeder (MB/s), a corrupt copy, the dataset modules' digests.
69. recordio_resnet50 - ResNet-50 f32 trained from that file through the
              graph reader ops; its first step bit for bit the numpy-fed
              twin's (control: a sample swapped).
70. async_ctr - DeepFM through AsyncExecutor(thread_num=4) over 4 record
              files, one Adam launch a step, every sample once; one thread
              bit for bit an Executor.run loop (control: a batch skipped).

Every line carries "script_seconds", the time since the script started.

The kernel cases also time rows 1, 3, 8 and 11 at BERT-base's shapes
(attention at batch 256, 12 heads, seq 128, D 64; LayerNorm on [32768,
768]; Adam over its 74 parameters in 2 launches), row 11 at
SE-ResNeXt-50's (its 19 parameters in one launch) and at the recipe's
constants (RECIPE_ADAM_CASES: the flagship's 67 parameters at beta2 0.997,
epsilon 1e-9 and an lr_t near 1e-7, bit for bit), and each kernel the zoo
phase runs at its float32 shapes: rows 1 and 3 at the tool's transformer's
(batch 64, 8 heads, seq 128, D 64), row 11 over the parameters each zoo
model's step gives the kernel (ZOO_ADAM_CASES), and row 11 over
tensor_chain's 3 fc weights (TENSOR_ADAM_CASES) and over nn_chain's LM
head (NN_ADAM_CASES) and over the encoder-decoder's 6 admitted parameters
(ENC_DEC_ADAM_CASES) and over sequence_chain's sequence_conv filter
(SEQ_CHAIN_ADAM_CASES) and over rnn_chain's LSTMP weights
(RNN_CHAIN_ADAM_CASES) and over the book MT's 4 admitted parameters
(DEC_ADAM_CASES). Then it prints the card's
name and power limit (nvidia-smi), one JSON line with every kernel's
numbers (with a "bert_base" entry where a kernel runs at BERT-base's
shapes, "se_resnext50", "train256_recipe", "tensor_layers",
"nn_layers", "rnn_encoder_decoder", "sequence_chain", "rnn_chain" and
"dec" ones for Adam,
and a
"zoo_<model>" one where a kernel runs in that zoo model), and last {"ok": true, "device": {...}}. It imports nothing of JAX or of the JAX package
paddle_tpu.
"""
import contextlib
import gc
import json
import math
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


_START = time.perf_counter()


def emit(obj):
    print(json.dumps(dict(obj, script_seconds=time.perf_counter() - _START)),
          flush=True)


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
# (path "wide_d": timed, a control each, no path mix). tools/
# torch_fluid_benchmark.py's transformer trains in float32 (batch 64, T 128,
# 8 heads, D 64): path "zoo_transformer", the CUDA-core kernels.
KERNEL_CASES = [
    ("onepass", 8, 256, 256, 8, 64, False, "bfloat16", "serve256", 8),
    ("onepass", 8, 256, 256, 8, 64, True, "bfloat16", "serve256", 4),
    ("onepass", 64, 128, 128, 8, 64, False, "float32", "zoo_transformer", 8),
    ("onepass", 64, 128, 128, 8, 64, True, "float32", "zoo_transformer", 4),
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
# D = 128 (float32) and 256 (bfloat16), as the forward's ("wide_d"); the
# tool's float32 transformer, as the forward's ("zoo_transformer")
BWD_CASES = [
    ("onepass_bwd", 64, 128, 128, 8, 64, False, "float32", "zoo_transformer",
     8),
    ("onepass_bwd", 64, 128, 128, 8, 64, True, "float32", "zoo_transformer",
     4),
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
# the 2-D parameters the kernel takes in SE-ResNeXt-50 at full width: the
# excitation weights [C / 16, C] of the 3, 4, 6 and 3 blocks of each stage
# and the last stage's 3 squeeze weights [2048, 128]: 19, one launch a step
# (the other 206 trainable parameters take the plain route)
SE_RESNEXT_ADAM_CASES = [((16, 256), "bfloat16", 3),
                         ((32, 512), "bfloat16", 4),
                         ((64, 1024), "bfloat16", 6),
                         ((128, 2048), "bfloat16", 3),
                         ((2048, 128), "bfloat16", 3)]
# the 2-D parameters the kernel takes in each model of
# tools/torch_fluid_benchmark.py that has any, all float32 (the tool builds
# every model in float32): VGG-16's two [512, 512] fc weights, the 19 of
# SE-ResNeXt-50's shapes at cardinality 16, the transformer's 67 of the
# flagship's shapes, DeepFM's [26 * 8, 128] fc weight, the stacked LSTM's
# 3 recurrent and 3 input-projection weights [128, 512] and its [5000,
# 128] embedding (7 of its 12), machine_translation's [128, 384] GRU,
# projection and gru_unit weights, its two [4000, 128] embeddings and its
# two [128, 128] attention weights (9 of its 14). phase_zoo checks each
# model's step against its list.
ZOO_ADAM_CASES = {
    "vgg": [((512, 512), "float32", 2)],
    "se_resnext": [(s, "float32", n) for s, _, n in SE_RESNEXT_ADAM_CASES],
    "transformer": [(s, "float32", n) for s, _, n in ADAM_CASES if n],
    "deepfm": [((208, 128), "float32", 1)],
    "stacked_dynamic_lstm": [((128, 512), "float32", 6),
                             ((5000, 128), "float32", 1)],
    "machine_translation": [((128, 384), "float32", 5),
                            ((4000, 128), "float32", 2),
                            ((128, 128), "float32", 2)]}
# Adam kernel vs plain version (assert_allclose semantics, |got - want| <=
# atol + rtol*|want|): the moments at tests/test_adam_kernel.py's tolerance;
# p within one unit in the last place of its dtype
ADAM_MOMENT_TOL = (1e-5, 1e-7)
ADAM_P_RTOL = {"bfloat16": 2.0 ** -7, "float32": 2.0 ** -23}
ADAM_HPARAMS = (0.9, 0.999, 1e-8)
# the Fluid Transformer recipe's Adam (PaddlePaddle/models transformer
# config.py: beta2 0.997, epsilon 1e-9) over the flagship's 67 admitted
# parameters, at an lr_t of the Noam rate's magnitude at d_model 512 and
# warmup 8000 (2 * 512^-0.5 * 8000^-1.5 * s * sqrt(1 - b2^s) / (1 - b1^s)
# is about 7e-8 a step early on): the kernel folds 1 - beta in double, so
# these constants are held bit for bit as ADAM_CASES are
RECIPE_ADAM_CASES = [case for case in ADAM_CASES if case[2]]
RECIPE_ADAM_HPARAMS = (0.9, 0.997, 1e-9)
RECIPE_LR_T = 1e-7
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
                     path="train", hparams=ADAM_HPARAMS, lr_t=0.003):
    """A training step's update: one adam_update_multi call over the
    admitted parameter shapes of `cases` (the flagship's 67 by default, one
    launch; BERT-base's 74, two launches of up to 72) at `hparams` (beta1,
    beta2, epsilon), each with its own lr_t (from `lr_t` up to twice it),
    bit for bit the plain version's p, m1 and m2, and a wrong beta2 (0.99)
    rejected. Timed: the call on the card (CUDA events), the wrapper's host
    time a call (the card's queue never full), the plain version, and one
    torch._fused_adam_ call on the same tensors as float32 lists."""
    import torch
    b1, b2, eps = hparams
    shapes = [(shape, dtype) for shape, dtype, n in cases
              for _ in range(n)]
    rnd = lambda shape: torch.randn(shape, generator=gen, device="cuda")
    ps = [rnd(shape).to(getattr(torch, dtype)) for shape, dtype in shapes]
    gs = [rnd(p.shape).to(p.dtype) for p in ps]
    m1s = [rnd(p.shape) * 0.1 for p in ps]
    m2s = [rnd(p.shape).abs() * 0.1 for p in ps]
    lr_ts = [torch.full((1,), lr_t * (1 + i / len(ps)), device="cuda")
             for i in range(len(ps))]
    want = K.adam_update_multi_plain(ps, gs, m1s, m2s, lr_ts, b1, b2, eps)
    got = [[t.clone() for t in ts] for ts in (ps, m1s, m2s)]
    before = K.adam_update_multi.launches
    K.adam_update_multi(got[0], gs, got[1], got[2], lr_ts, b1, b2, eps)
    torch.cuda.synchronize()
    rec = {"phase": "kernels", "kernel": "adam_multi", "tensors": len(ps),
           "elements": sum(p.numel() for p in ps), "path": path,
           "beta1": b1, "beta2": b2, "epsilon": eps, "lr_t": lr_t,
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
            *f32, [], steps, lr=lr_t, beta1=b1, beta2=b2, weight_decay=0.0,
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
    _adam_multi_case(K, gen, summary, max_err, failed, SE_RESNEXT_ADAM_CASES,
                     "se_resnext50")
    for model, cases in ZOO_ADAM_CASES.items():
        _adam_multi_case(K, gen, summary, max_err, failed, cases,
                         "zoo_" + model)
    _adam_multi_case(K, gen, summary, max_err, failed, RECIPE_ADAM_CASES,
                     "train256_recipe", RECIPE_ADAM_HPARAMS, RECIPE_LR_T)
    _adam_multi_case(K, gen, summary, max_err, failed, TENSOR_ADAM_CASES,
                     "tensor_layers")
    _adam_multi_case(K, gen, summary, max_err, failed, NN_ADAM_CASES,
                     "nn_layers")
    _adam_multi_case(K, gen, summary, max_err, failed, ENC_DEC_ADAM_CASES,
                     "rnn_encoder_decoder")
    _adam_multi_case(K, gen, summary, max_err, failed, SEQ_CHAIN_ADAM_CASES,
                     "sequence_chain")
    _adam_multi_case(K, gen, summary, max_err, failed, RNN_CHAIN_ADAM_CASES,
                     "rnn_chain")
    _adam_multi_case(K, gen, summary, max_err, failed, DEC_ADAM_CASES,
                     "book_machine_translation")
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
            want_per_step, adam_tensors, info, work, check=None):
    """Startup on the card, one warm step on `warm_feed` (stacked [1,
    ...]), then `steps` steps through run_steps on `feed` (stacked [steps,
    ...]) with every launch count zeroed just before and read just after.
    Every loss must be finite, the launches must be `want_per_step` times
    the steps, and the step's Adam call must have covered `adam_tensors`
    parameters (None: a path with no Adam launch). `check` = (variables
    fetched beside the loss, fn(scope, their stacked values) -> (readings,
    ok)) adds a check of the window's own. Emits the phase's line (`info`,
    the window's times and rates per unit of `work` = {unit: count a
    step}, peak memory) and returns the launches."""
    import numpy as np
    import torch
    t_start = time.perf_counter()
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
    extra_fetch, check_fn = check or ([], None)
    _zero(counters)
    t0 = time.perf_counter()
    losses, *extra = exe.run_steps(main, feed=feed, n_steps=steps,
                                   fetch_list=[loss] + list(extra_fetch),
                                   scope=scope, return_numpy=False)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launched = _read(counters)
    losses = losses.float().cpu().numpy()
    want = {k: v * steps for k, v in want_per_step.items()}
    tensors = counters["adam"].last_tensors if launched["adam"] else None
    readings, check_ok = check_fn(scope, extra) if check_fn else ({}, True)
    ok = losses.shape == (steps,) and bool(np.isfinite(losses).all()) and \
        bool(np.isfinite(np.asarray(warm[0])).all()) and launched == want \
        and (adam_tensors is None or tensors == adam_tensors) and check_ok
    rec = dict({"phase": name, "ok": ok}, **info)
    rec.update(readings)
    rec.update({"flags": {k: v for k, v in os.environ.items()
                          if k.startswith("FLAGS_")},
                "steps": steps, "losses": losses.tolist(),
                "warm_loss": float(np.asarray(warm[0]).reshape(-1)[0]),
                "window_seconds": seconds, "step_ms": seconds / steps * 1e3})
    for unit, count in work.items():
        rec[unit + "_per_s"] = count * steps / seconds
    rec.update({"launches": launched, "launches_want": want,
                "adam_tensors_a_step": tensors,
                "peak_memory_bytes": torch.cuda.max_memory_allocated(),
                "phase_seconds": time.perf_counter() - t_start})
    emit(rec)
    if not ok:
        raise AssertionError("%s failed: launches %s, want %s, Adam "
                             "tensors a step %s (want %s), losses %s, "
                             "check %s" % (name, launched, want, tensors,
                                           adam_tensors, losses, readings))
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


# ---- the Fluid Transformer's training recipe ----

# PaddlePaddle/models transformer/config.py TrainTaskConfig: label smoothing
# 0.1, Adam(beta1 0.9, beta2 0.997, epsilon 1e-9) (RECIPE_ADAM_HPARAMS) at
# the learning rate noam_decay(d_model, 8000) * 2.0. The rate fetched at
# each step must lie within RECIPE_LR_REL_MAX of its closed form in float64
# (the float32 pow and products on the step are a few ulps off it).
RECIPE_EPS = 0.1
RECIPE_WARMUP = 8000
RECIPE_LR_SCALE = 2.0
RECIPE_LR_REL_MAX = 1e-6
LR_COUNTER = "@LR_DECAY_COUNTER@"


def recipe_programs(fluid, transformer, cfg):
    """The recipe built as a user builds it, through the public API, in
    fresh programs (the startup program seeded with SEED). Returns (main,
    startup, avg_loss, the learning-rate variable)."""
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = SEED
    with fluid.program_guard(main, startup):
        _, loss = transformer.build(label_smooth_eps=RECIPE_EPS, **cfg)
        lr = fluid.layers.noam_decay(cfg["d_model"], RECIPE_WARMUP) * \
            RECIPE_LR_SCALE
        b1, b2, eps = RECIPE_ADAM_HPARAMS
        fluid.optimizer.Adam(learning_rate=lr, beta1=b1, beta2=b2,
                             epsilon=eps).minimize(loss)
    return main, startup, loss, lr


def noam_rate(step, d_model):
    """The recipe's learning rate at `step` (counted from 1), in float64."""
    return RECIPE_LR_SCALE * d_model ** -0.5 * \
        min(step ** -0.5, step * RECIPE_WARMUP ** -1.5)


def _host_syncs(fluid, main, feed, loss, scope):
    """The places ("file:line") where one more step of `main` through
    run_steps (`feed` stacked [1, ...]) waits for the card, as
    torch.cuda.set_sync_debug_mode("warn") reports them (it sees the
    synchronizing calls PyTorch flags, not every one)."""
    import warnings
    import torch
    exe = fluid.Executor()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            exe.run_steps(main, feed=feed, n_steps=1, fetch_list=[loss],
                          scope=scope, return_numpy=False)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return ["%s:%d" % (os.path.relpath(w.filename), w.lineno)
            for w in caught if "synchroniz" in str(w.message)]


def phase_train256_recipe(fluid, transformer, counters, cfg, want_per_step):
    """train256 under the recipe (nothing cut: bench.py's CFG, batch
    TRAIN_BATCH, seq 256) through _window: besides train256's launches
    (the cross-entropy kernels' gate refuses soft labels, as the JAX
    gate), the rate fetched at each step against its closed form, the
    step counter after the window against the steps run (warm step
    included), and one more step's host syncs, none of which may lie in
    the port's lowerings or kernels (only the executor's feed copies)."""
    import numpy as np
    main, startup, loss, lr = recipe_programs(fluid, transformer, cfg)
    vocab, seq, steps = cfg["tgt_vocab"], cfg["seq_len"], TRAIN_STEPS
    one_step = _stacked(transformer.synthetic_batch(TRAIN_BATCH, seq, vocab,
                                                    SEED + 2), 1)

    def check(scope, fetched):
        counter = int(scope.get(LR_COUNTER).reshape(-1)[0])
        syncs = _host_syncs(fluid, main, one_step, loss, scope)
        in_lowerings = [w for w in syncs if "paddle_tpu_torch/" in w and
                        "/executor.py" not in w]
        rates = fetched[0].double().cpu().numpy().reshape(-1)
        # the warm step was step 1: the window runs steps 2 .. steps + 1
        want = np.array([noam_rate(k, cfg["d_model"])
                         for k in range(2, steps + 2)])
        rel = np.abs(rates - want) / want
        return ({"lr": rates.tolist(), "lr_closed_form": want.tolist(),
                 "lr_rel_err_max": float(rel.max()),
                 "lr_rel_max": RECIPE_LR_REL_MAX,
                 "lr_counter": counter, "steps_run": steps + 1,
                 "host_syncs_one_step": syncs},
                bool(rel.max() <= RECIPE_LR_REL_MAX) and
                counter == steps + 1 and not in_lowerings)
    tokens = TRAIN_BATCH * seq
    b1, b2, eps = RECIPE_ADAM_HPARAMS
    return _window(
        "train256_recipe", fluid, counters, (main, startup, loss),
        _stacked(transformer.synthetic_batch(TRAIN_BATCH, seq, vocab, SEED),
                 1),
        _stacked(transformer.synthetic_batch(TRAIN_BATCH, seq, vocab,
                                             SEED + 1), steps), steps,
        want_per_step, ADAM_TENSORS,
        {"batch": TRAIN_BATCH, "seq_len": seq,
         "dropout_rate": cfg["dropout_rate"], "label_smooth_eps": RECIPE_EPS,
         "learning_rate": "noam_decay(%d, %d) * %s" % (
             cfg["d_model"], RECIPE_WARMUP, RECIPE_LR_SCALE),
         "adam": {"beta1": b1, "beta2": b2, "epsilon": eps}},
        {"tokens": tokens, "model_tflops": tokens *
         train_flops_per_token(cfg) / 1e12},
        check=([lr], check))


def phase_recipe_parity(fluid, transformer, counters):
    """The recipe at n_layer 1, dropout 0, batch 2: one step on the card and
    one on the CPU from the same weights, at train_parity's limits, on the
    gradients of WIDE_PARITY_GRADS (train_parity's, in one layer); the
    control is the card's step with label_smooth's epsilon set to 0 (the
    raw one-hot in place of the smoothed labels)."""
    cfg = dict(transformer.FLAGSHIP_CFG, n_layer=1, dropout_rate=0.0)
    main, startup, loss, _ = recipe_programs(fluid, transformer, cfg)
    feed = transformer.synthetic_batch(2, cfg["seq_len"], cfg["tgt_vocab"],
                                       SEED + 300)
    faulty = main.clone()
    changed = 0
    for op in faulty.global_block().ops:
        if op.type == "label_smooth":
            op.attrs["epsilon"] = 0.0
            changed += 1
    _card_vs_cpu("recipe_parity", fluid, counters, (main, startup, loss),
                 feed, WIDE_PARITY_GRADS, PARITY_FLAGS[:1],
                 ("label_smooth epsilon 0 on the card: the raw one-hot "
                  "(%d op changed)" % changed, faulty, feed),
                 {"batch": 2, "d_model": cfg["d_model"],
                  "n_head": cfg["n_head"], "n_layer": 1,
                  "seq_len": cfg["seq_len"], "dropout_rate": 0.0,
                  "label_smooth_eps": RECIPE_EPS})


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
#   ||cpu|| to 0.05. The orders of f32 sums in the matmuls (an id's
#   repeats add in the CPU's order on the card too: phase_row_sums) move
#   these by about 1e-6. A ReLU preactivation within rounding of 0 can take the other side
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


def conv_flops_per_image(program):
    """Forward multiply-adds, times 2, of the program's conv2d and mul ops
    from their shapes (a grouped filter [out, in / groups, kh, kw] counts
    each output's in / groups channels); a training step does 3 times this
    (forward, grad of the input, grad of the weight)."""
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


def _image_phase(name, fluid, model, programs, counters, batch, steps,
                 image, classes, want_per_step, adam_tensors, info):
    """An image model's training `programs` (main, startup, loss, acc)
    through _window at `batch`, fed by `model`.synthetic_batch at `image`
    and `classes`: images/s and model TFLOP/s from the program's conv and
    fc shapes (forward times 3)."""
    main, startup, loss, _ = programs
    feed = lambda seed: model.synthetic_batch(batch, image, classes,
                                              seed=seed)
    flops = conv_flops_per_image(main)
    return _window(
        name, fluid, counters, (main, startup, loss),
        _stacked(feed(SEED), 1), _stacked(feed(SEED + 1), steps), steps,
        want_per_step, adam_tensors,
        dict({"batch": batch, "image": image, "classes": classes,
              "forward_gflop_per_image": flops / 1e9}, **info),
        {"images": batch, "model_tflops": 3 * flops * batch / 1e12})


def _resnet_phase(name, fluid, resnet, counters, batch, steps):
    """bench.py's ResNet-50 leg through _image_phase at `batch`: no kernel
    of the port's on its path (no attention, Adam, LayerNorm or embedding;
    the cross-entropy gate refuses V = 1000), so every launch count is 0."""
    return _image_phase(
        name, fluid, resnet, resnet.training_programs(
            SEED, dataset="flowers", dtype=resnet.RESNET_BENCH_DTYPE),
        counters, batch, steps, RESNET_IMAGE, RESNET_CLASSES,
        dict.fromkeys(counters, 0), None,
        {"dtype": resnet.RESNET_BENCH_DTYPE, "depth": 50})


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
                 "int32": 0.0, "int8": 0.0}
# A float32 output that cancels to rounding noise cannot be held to 1e-4 of
# its own size on any device: two evaluations of it differ by their
# rounding. _lockstep_step lets the card's value differ from the CPU's by
# CANCEL_NOISE times the CPU's own largest error against the same step in
# float64 (so the card's error may be up to 3 times the CPU's).
CANCEL_NOISE = 4.0
RESNET_STEP_LIMITS = {"loss": 1e-4, "named": 0.1}
# conv1, a middle bottleneck's 3x3 conv, the last batch_norm's scale and
# the fc weight; the first and the last batch_norm's running statistics
RESNET_PARITY_GRADS = ["conv2d_0.w_0", "conv2d_26.w_0", "batch_norm_52.w_0",
                       "fc_0.w_0"]
RESNET_PARITY_STATE = ["batch_norm_0.w_1", "batch_norm_0.w_2",
                       "batch_norm_52.w_1", "batch_norm_52.w_2",
                       "conv2d_0.w_0", "conv2d_0.w_0_velocity_acc_0",
                       "fc_0.w_0", "fc_0.w_0_velocity_acc_0"]


def _rel_max(got, want, scale=None):
    """max |got - want| / max |want| (or, given `scale` of want's size,
    / the larger of max |want| and max |scale|: the value before a step
    that updated it, or a multiple of the rounding noise of an output that
    cancels, _lockstep_step)."""
    import numpy as np
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if not want.size:
        return 0.0       # an XShape output: a shape, no values
    top = np.abs(want).max()
    if scale is not None and np.size(scale) == want.size:
        top = max(top, np.abs(np.asarray(scale, np.float64)).max())
    return float(np.abs(got - want).max() / (top or 1.0))


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


def _op_name(op):
    """An op's type, a grad_of op's with its forward's ("grad_of:nce")."""
    return op.type + (":" + op.attr("fwd_type") if op.type == "grad_of"
                      else "")


def _replay_on_card(fluid, main, fetch, state, feed, vals, after,
                    scales=None):
    """Every op of the card's plan of the step on the card, each from the
    CPU step's values of its inputs (`state` before the step, `feed`,
    `vals`); each output's max |card - cpu| / max |cpu| against the CPU's
    value (`vals`, or `after` for a persistable, whose difference is taken
    relative to the larger of its largest values before and after the
    step: an update that nearly cancels its parameter, as Adagrad's of a
    bias whose gradient changes sign, keeps the rounding of its operands'
    size). A name that two ops write
    (a gradient and its sum with a later contribution) is checked at its
    last writer and read from the card's own value before it; after it, a
    reader gets the CPU's value (a persistable's from `after`: ModelAverage
    sums the parameters the optimizer just updated). An output named in
    `scales` is measured against the larger of its own size and its scale
    there (_lockstep_step: an output that cancels to rounding noise).
    Returns {name: (op type (_op_name), dtype, error)}."""
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
        elif n in state:
            t = after[n] if n in final else state[n]
        else:
            t = vals[n]
        return t.to(device="cuda", dtype=to_torch_dtype(block.var(n).dtype))

    # a generator for dropout's snapshot, which its grad op reads back; a
    # while or conditional_block op runs its sub-block as one op
    ctx = registry.LoweringContext(
        "cuda", torch.Generator(device="cuda"),
        block_runner=fluid.executor._BlockRunner(main))
    tape, errs, scales = {}, {}, scales or {}
    with torch.no_grad():
        for k, (op, _) in enumerate(plan.steps):
            if k in plan.in_run:
                continue
            run = plan.runs.get(k, (k,))
            ops = [plan.steps[j][0] for j in run]
            for o in ops:
                registry.fold_const(o, ctx)
            env = {n: value(n) for o in ops for n in o.input_arg_names
                   if n != "@EMPTY@"}
            if len(run) > 1:
                registry.lower_group(ops, env, ctx)
            elif k in plan.taped:
                tape[k] = grad_ops.record_forward(op, env, ctx,
                                                  plan.taped[k])
            else:
                if k in plan.grad_fwd:
                    ctx.record, ctx.retain_graph = plan.record_for(tape, k)
                registry.lower_op(op, env, ctx)
                ctx.record, ctx.retain_graph = None, False
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
                    scale = scales.get(n)
                    if scale is None and n in after and n in state:
                        scale = fluid.executor.as_numpy(state[n])
                    errs[n] = (_op_name(o), str(env[n].dtype)[6:],
                               _rel_max(got, want, scale))
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


def _card_step(fluid, exe, program, state, feed, fetch, names):
    """The whole step on the card from `state`: (the fetches by name, the
    persistables `names` after it as numpy)."""
    scope = fluid.Scope()
    for n, t in state.items():
        scope.set(n, t.clone())
    got = exe.run(program, feed=feed, fetch_list=fetch, scope=scope)
    return dict(zip(fetch, got)), {n: fluid.executor.as_numpy(scope.get(n))
                                   for n in names}


def _step_readings(card, card_after, cpu, cpu_after, loss, grads, states):
    r = {"loss": abs(float(card[loss]) - float(cpu[loss])) /
         abs(float(cpu[loss]))}
    for n in grads:
        r[n + "@GRAD"] = _rel_norm(card[n + "@GRAD"], cpu[n + "@GRAD"])
    for n in states:
        r[n] = _rel_norm(card_after[n], cpu_after[n])
    return r


def _step_ok(r):
    return r["loss"] <= RESNET_STEP_LIMITS["loss"] and \
        max(v for k, v in r.items() if k != "loss") <= \
        RESNET_STEP_LIMITS["named"]


def _image_parity(name, fluid, programs, feeds, grads, states, op_controls,
                  step_controls, counters, kernels, info):
    """An image model's training `programs` ({dtype: (main, startup, loss,
    acc)}, the float32 startup state first) for len(`feeds`) steps in
    lockstep, card against CPU: every op of each step replayed on the card
    from the CPU's values within RESNET_OP_TOL, and the whole step on the
    card from the CPU's state, its loss, the gradients of `grads` and the
    persistables `states` within RESNET_STEP_LIMITS in float32 (reported
    in bfloat16). On the first step each op control ({name: (dtypes, a
    context that breaks a lowering)}) replays the ops again and each step
    control ({name: (a program or None for the same one, a context)}) runs
    the float32 whole step again: each must fail. One JSON line a dtype;
    no kernel of the port's but those named in `kernels` may launch."""
    import torch
    failures = []
    main, startup = programs["float32"][:2]
    scope = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=scope)
    start = {v.name: scope.get(v.name)
             for v in main.global_block().vars.values()
             if v.persistable and scope.get(v.name) is not None}
    card_exe = fluid.Executor()
    t0 = time.perf_counter()
    _zero(counters)
    for dtype, (main, _, loss, acc) in programs.items():
        block = main.global_block()
        names = sorted({n for op in block.ops for n in op.output_arg_names
                        if n != "@EMPTY@" and not block.var(n).persistable})
        fetch = [loss.name, acc.name]
        grad_names = [loss.name] + [n + "@GRAD" for n in grads]
        state, op_readings, step_readings, controls = start, [], [], {}
        ok = True
        for i, feed in enumerate(feeds):
            vals, after = _cpu_step(fluid, main, state, feed, names)
            errs = _replay_on_card(fluid, main, fetch, state, feed, vals,
                                   after)
            step_ok, worst = _op_verdict(errs)
            named = {n: errs[n][2] for n in grad_names + states}
            op_readings.append({"worst": worst, "named": named})
            ok = ok and step_ok
            cpu = {n: fluid.executor.as_numpy(vals[n]) for n in grad_names}
            cpu_after = {n: fluid.executor.as_numpy(after[n])
                         for n in states}
            readings = lambda program: _step_readings(
                *_card_step(fluid, card_exe, program, state, feed,
                            grad_names, states),
                cpu, cpu_after, loss.name, grads, states)
            r = readings(main)
            step_readings.append(r)
            if dtype == "float32":
                ok = ok and _step_ok(r)
            if i == 0:
                for control, (dtypes, context) in op_controls.items():
                    if dtype in dtypes:
                        with context():
                            controls[control] = _op_verdict(_replay_on_card(
                                fluid, main, fetch, state, feed, vals,
                                after))
                if dtype == "float32":
                    for control, (program, context) in step_controls.items():
                        with context():
                            wrong = readings(program or main)
                        controls[control] = (_step_ok(wrong), wrong)
            state = after
        caught = not any(c[0] for c in controls.values())
        emit(dict({"phase": name, "dtype": dtype, "ok": ok and caught,
                   "steps": len(feeds),
                   "lockstep": "each step, and each op, from the CPU's "
                   "state", "op_tol": RESNET_OP_TOL,
                   "step_limits": RESNET_STEP_LIMITS,
                   "op_by_op": op_readings, "whole_step": step_readings,
                   "controls": {k: {"passed": v[0], "readings": v[1]}
                                for k, v in controls.items()},
                   "controls_rejected": caught,
                   "launches": {k: v for k, v in _read(counters).items()
                                if v},
                   "phase_seconds": time.perf_counter() - t0}, **info))
        if not (ok and caught):
            failures.append(dtype)
    launched = {k: v for k, v in _read(counters).items()
                if v and k not in kernels}
    if launched:
        failures.append("launches %s" % launched)
    if failures:
        raise AssertionError("%s: %s" % (name, failures))
    torch.cuda.empty_cache()


def phase_resnet_parity(fluid, resnet, counters):
    from unittest import mock
    from paddle_tpu_torch.fluid.ops import nn_ops, registry
    programs = {}
    for dtype in ("float32", "bfloat16"):
        with fluid.unique_name.guard():
            programs[dtype] = resnet.training_programs(
                SEED, dataset="flowers", dtype=dtype)
    with fluid.unique_name.guard():
        is_test = resnet.training_programs(SEED, dataset="flowers",
                                           is_test=True)[0]
    feeds = [resnet.synthetic_batch(RESNET_PARITY_BATCH, RESNET_PARITY_IMAGE,
                                    RESNET_CLASSES, seed=SEED + 600 + i)
             for i in range(RESNET_PARITY_STEPS)]
    _image_parity(
        "resnet_parity", fluid, programs, feeds, RESNET_PARITY_GRADS,
        RESNET_PARITY_STATE,
        {"unbiased_running_variance": (
            ("float32", "bfloat16"), lambda: mock.patch.dict(
                registry._LOWERINGS, batch_norm=_unbiased_running_variance())),
         "tf32_convolutions": (("float32",), lambda: mock.patch.object(
             nn_ops, "CONV_FP32_PRECISION", "tf32"))},
        {"is_test_program": (is_test, contextlib.nullcontext)}, counters,
        (), {"batch": RESNET_PARITY_BATCH, "image": RESNET_PARITY_IMAGE})


# se_resnext_parity: the full-width SE-ResNeXt-50 program (1000 classes,
# cardinality 32, reduction 16, Adam(1e-3)) at batch 4 on 3x64x64 images
# (the last stage normalizes 4 * 2 * 2 = 16 values a channel), float32 and
# bfloat16 from the same weights, for 3 steps in lockstep, as
# resnet_parity: each op within RESNET_OP_TOL, the float32 whole step
# within RESNET_STEP_LIMITS (the loss; the gradients of the stem conv, a
# middle grouped conv, the last batch_norm scale, the last block's squeeze
# fc and the classifier; the first and the last batch_norm's running
# statistics, the stem's and the classifier's first moment and weight).
# The dropout(0.2) op drops nothing (dropout_prob set to 0 in the program:
# the CPU's and the card's generators differ). Control, on the first step:
# each excitation's sigmoid made the identity on the card, op by op in both
# dtypes and on the float32 whole step. The Adam kernel is the one kernel
# of the port's on this path (the step's group of adam ops launches it on
# the card, replayed or whole).
SE_PARITY_BATCH = 4
SE_PARITY_IMAGE = [3, 64, 64]
SE_PARITY_STEPS = 3
SE_PARITY_GRADS = ["conv2d_0.w_0", "conv2d_25.w_0", "batch_norm_52.w_0",
                   "fc_30.w_0", "fc_32.w_0"]
SE_PARITY_STATE = ["batch_norm_0.w_1", "batch_norm_0.w_2",
                   "batch_norm_52.w_1", "batch_norm_52.w_2",
                   "conv2d_0.w_0", "conv2d_0.w_0_moment1_acc_0",
                   "fc_32.w_0", "fc_32.w_0_moment1_acc_0"]


def _sigmoid_as_identity(ctx, inputs, attrs):
    """The sigmoid lowering made the identity (a control)."""
    return {"Out": inputs["X"]}


def phase_se_resnext_parity(fluid, se_resnext, counters):
    from unittest import mock
    from paddle_tpu_torch.fluid.ops import registry
    cfg = dict(se_resnext.SE_RESNEXT50_CFG, img_size=SE_PARITY_IMAGE[1])
    programs = {}
    for dtype in ("float32", "bfloat16"):
        with fluid.unique_name.guard():
            programs[dtype] = se_resnext.training_programs(
                SEED, **dict(cfg, dtype=dtype))
        for op in programs[dtype][0].global_block().ops:
            if "dropout_prob" in op.attrs:
                op.attrs["dropout_prob"] = 0.0
    feeds = [se_resnext.synthetic_batch(SE_PARITY_BATCH, SE_PARITY_IMAGE,
                                        cfg["class_dim"],
                                        seed=SEED + 700 + i)
             for i in range(SE_PARITY_STEPS)]
    no_sigmoid = lambda: mock.patch.dict(registry._LOWERINGS,
                                         sigmoid=_sigmoid_as_identity)
    _image_parity(
        "se_resnext_parity", fluid, programs, feeds, SE_PARITY_GRADS,
        SE_PARITY_STATE,
        {"excitation_without_sigmoid": (("float32", "bfloat16"),
                                        no_sigmoid)},
        {"whole_step_excitation_without_sigmoid": (None, no_sigmoid)},
        counters, ("adam",),
        {"batch": SE_PARITY_BATCH, "image": SE_PARITY_IMAGE,
         "cardinality": cfg["cardinality"], "classes": cfg["class_dim"]})


# ---- benchmark/fluid_benchmark.py's image zoo: SE-ResNeXt-50, the tool ----

SE_RESNEXT_STEPS = 4
SE_RESNEXT_ADAM_TENSORS = sum(n for _, _, n in SE_RESNEXT_ADAM_CASES)
ADAM_ROUTE_ROUNDS = 5


def _adam_routes(fluid, main):
    """The step's adam ops through the executor's group lowering on the
    card, on random tensors of their parameters' shapes and dtypes: all of
    them, then only those the fused kernel takes, then only the others
    (the plain route). Each route's device time and kernel launches a call
    (torch.profiler: the summed time of its device kernels) and host time
    (the median of ADAM_ROUTE_ROUNDS calls, each synchronized before and
    its launches only enqueued)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch.fluid.core_types import to_torch_dtype
    from paddle_tpu_torch.fluid.ops import optimizer_ops, registry
    from paddle_tpu_torch.ops.adam_kernel import adam_ok
    block = main.global_block()
    ops = [op for op in block.ops if op.type == "adam"]
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    scalar = lambda v: torch.full((1,), v, device="cuda")
    lr, b1p, b2p = scalar(1e-3), scalar(0.9), scalar(0.999)
    inputs = []
    for op in ops:
        p = block.var(op.input("Param")[0])
        draw = lambda: torch.randn(p.shape, generator=gen, device="cuda")
        dtype = to_torch_dtype(p.dtype)
        inputs.append({"Param": [draw().to(dtype)],
                       "Grad": [draw().to(dtype)],
                       "Moment1": [draw() * 0.1],
                       "Moment2": [draw().abs() * 0.1],
                       "Beta1Pow": [b1p], "Beta2Pow": [b2p],
                       "LearningRate": [lr]})
    ctx = registry.LoweringContext("cuda")
    taken = [k for k, i in enumerate(inputs) if adam_ok(i["Param"][0].shape)]
    routes = {"all": list(range(len(ops))), "kernel": taken,
              "plain": [k for k in range(len(ops)) if k not in taken]}
    t_start = time.perf_counter()
    rec = {"phase": "se_resnext50_adam_routes", "adam_ops": len(ops)}
    for route, ks in routes.items():
        call = lambda: optimizer_ops._adam_group(
            ctx, [inputs[k] for k in ks], [ops[k].attrs for k in ks])
        call()
        host = []
        for _ in range(ADAM_ROUTE_ROUNDS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call()
            host.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        rec[route] = {
            "params": len(ks),
            "elements": sum(inputs[k]["Param"][0].numel() for k in ks),
            "host_ms": sorted(host)[len(host) // 2],
            "device_ms": sum(e.time_range.elapsed_us() for e in kernels) /
            1e3,
            "device_kernels": len(kernels)}
    rec["ok"] = rec["kernel"]["params"] == SE_RESNEXT_ADAM_TENSORS
    rec["phase_seconds"] = time.perf_counter() - t_start
    emit(rec)
    if not rec["ok"]:
        raise AssertionError("se_resnext50: the Adam kernel takes %d "
                             "parameters, want %d" % (rec["kernel"]["params"],
                                                      SE_RESNEXT_ADAM_TENSORS))
    del inputs
    torch.cuda.empty_cache()


def phase_se_resnext50(fluid, se_resnext, counters):
    """SE-ResNeXt-50 at full width (se_resnext.SE_RESNEXT50_CFG: 3x224x224,
    1000 classes, cardinality 32, reduction 16, bf16; Adam(1e-3) as
    benchmark/fluid_benchmark.py trains it) through _image_phase at
    SE_RESNEXT50_BATCH: each step one Adam launch covering the
    SE_RESNEXT_ADAM_TENSORS parameters the kernel takes, nothing else (the
    cross-entropy gate refuses V = 1000). Then the step's Adam routes
    (_adam_routes). Returns the window's launches."""
    cfg = se_resnext.SE_RESNEXT50_CFG
    programs = se_resnext.training_programs(SEED, **cfg)
    launched = _image_phase(
        "se_resnext50", fluid, se_resnext, programs, counters,
        se_resnext.SE_RESNEXT50_BATCH, SE_RESNEXT_STEPS,
        [3, cfg["img_size"], cfg["img_size"]], cfg["class_dim"],
        dict(dict.fromkeys(counters, 0), adam=1), SE_RESNEXT_ADAM_TENSORS,
        {"dtype": cfg["dtype"], "depth": cfg["layers"],
         "cardinality": cfg["cardinality"], "learning_rate": 1e-3})
    _adam_routes(fluid, programs[0])
    return launched


ZOO_BATCH, ZOO_STEPS = 64, 2
ZOO_MNIST_STEPS = 3
ZOO_LOSS_REL_MAX = 1e-5


def _load_tool(name):
    """tools/<name>.py, loaded by its path (tools/ is not a package)."""
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools",
                        name + ".py")
    spec = importlib.util.spec_from_file_location(name, path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


def _zoo_mnist_card_vs_cpu(fluid, tool):
    """The mnist MLP for ZOO_MNIST_STEPS steps through run_steps on the
    card and on the CPU from the same parameters (the CPU's startup state)
    and batches: the losses within ZOO_LOSS_REL_MAX relative."""
    import numpy as np
    t0 = time.perf_counter()
    with fluid.unique_name.guard():
        main, startup, loss, gen = tool.build_programs(
            tool.parse_args(["--model", "mnist"]), fluid)
    startup.random_seed = SEED
    draws = [gen() for _ in range(ZOO_MNIST_STEPS)]
    feed = {k: np.stack([d[k] for d in draws]) for k in draws[0]}
    cpu_scope = fluid.Scope()
    cpu_exe = fluid.Executor(fluid.CPUPlace())
    cpu_exe.run(startup, scope=cpu_scope)
    card_scope = fluid.Scope()
    for v in main.global_block().vars.values():
        t = cpu_scope.get(v.name) if v.persistable else None
        if t is not None:
            card_scope.set(v.name, t.to("cuda"))
    card, = fluid.Executor().run_steps(main, feed=feed,
                                       n_steps=ZOO_MNIST_STEPS,
                                       fetch_list=[loss], scope=card_scope)
    cpu, = cpu_exe.run_steps(main, feed=feed, n_steps=ZOO_MNIST_STEPS,
                             fetch_list=[loss], scope=cpu_scope)
    rel = np.abs(card - cpu) / np.abs(cpu)
    rec = {"phase": "zoo_mnist_card_vs_cpu", "steps": ZOO_MNIST_STEPS,
           "card_losses": card.tolist(), "cpu_losses": cpu.tolist(),
           "loss_rel_err": rel.tolist(), "limit": ZOO_LOSS_REL_MAX,
           "ok": bool((rel <= ZOO_LOSS_REL_MAX).all()),
           "phase_seconds": time.perf_counter() - t0}
    emit(rec)
    if not rec["ok"]:
        raise AssertionError("zoo: mnist card vs CPU losses %s" % rel)


def _zoo_adam_tensors(model, main):
    """The parameters of `model`'s step that the Adam kernel takes, which
    must be those of ZOO_ADAM_CASES[model] (shapes, dtypes and counts), or
    raise. Returns their count (None: none, no Adam launch)."""
    import collections
    from paddle_tpu_torch.ops.adam_kernel import adam_ok
    block = main.global_block()
    params = [block.var(op.input("Param")[0]) for op in block.ops
              if op.type == "adam"]
    admitted = collections.Counter((tuple(p.shape), p.dtype) for p in params
                                   if adam_ok(tuple(p.shape)))
    cases = collections.Counter()
    for shape, dtype, n in ZOO_ADAM_CASES.get(model, []):
        cases[(shape, dtype)] += n
    if admitted != cases:
        raise AssertionError(
            "zoo %s: the Adam kernel takes %s, the kernel cases hold %s"
            % (model, sorted(admitted.items()), sorted(cases.items())))
    return sum(cases.values()) or None


# the zoo's models and the launches a step of each, by kernel: the Adam
# kernel 0 for mnist and resnet, whose parameters its gate refuses, 1 for
# the others; the transformer's 4 + 4 layers 12 one-pass forward and 12
# backward. The recurrent models run in the recurrent slice's phases, with
# their busy share and host syncs a step.
ZOO_LAUNCHES = {"mnist": {}, "resnet": {}, "vgg": {"adam": 1},
                "se_resnext": {"adam": 1},
                "transformer": {"onepass": 12, "onepass_bwd": 12, "adam": 1},
                "deepfm": {"adam": 1}, "stacked_dynamic_lstm": {"adam": 1},
                "machine_translation": {"adam": 1}}
ZOO_RECURRENT = ("stacked_dynamic_lstm", "machine_translation")


def _zoo_recurrent_readings(fluid, model, programs, draws):
    """A recurrent zoo model's busy share (_busy_named over one step
    through Executor.run) and its host syncs a step (_step_syncs)."""
    import collections
    m = collections.namedtuple("Model", "main startup loss")(*programs)
    rec = {"phase": "zoo_" + model + "_busy", "card": _card(),
           "busy": _busy_named(fluid, m, draws[1]),
           "step_host_syncs": _step_syncs(fluid, m, _stack_feeds(draws))}
    emit(rec)
    return rec


def phase_zoo(fluid, counters, models):
    """The `models` of tools/torch_fluid_benchmark.py, each built by the
    tool's build_programs (the model and Adam(1e-3)) and fed by its batch
    generator, through _window at ZOO_BATCH, 1 warm step and ZOO_STEPS
    steps: examples/s, step ms, peak memory and the launches a step of each
    kernel of the port's (ZOO_LAUNCHES), each model's Adam launch over the
    parameter shapes of ZOO_ADAM_CASES, which phase_kernels holds against
    the plain version; the recurrent models' busy share and host syncs a
    step. Then the mnist card-vs-CPU check (with mnist). Returns the
    launches."""
    import numpy as np
    tool = _load_tool("torch_fluid_benchmark")
    none = dict.fromkeys(counters, 0)
    total = dict(none)
    for model in models:
        want = dict(none, **ZOO_LAUNCHES[model])
        args = tool.parse_args(["--model", model, "--batch_size",
                                str(ZOO_BATCH)])
        t0 = time.perf_counter()
        with fluid.unique_name.guard():
            main, startup, loss, gen = tool.build_programs(args, fluid)
        startup.random_seed = SEED
        adam_tensors = _zoo_adam_tensors(model, main)
        draws = [gen() for _ in range(ZOO_STEPS + 1)]
        stacked = {k: np.stack([d[k] for d in draws]) for k in draws[0]}
        launched = _window(
            "zoo_" + model, fluid, counters, (main, startup, loss),
            {k: v[:1] for k, v in stacked.items()},
            {k: v[1:] for k, v in stacked.items()}, ZOO_STEPS, want,
            adam_tensors,
            {"model": model, "batch": ZOO_BATCH, "card": _card(),
             "ops": len(main.global_block().ops),
             "build_seconds": time.perf_counter() - t0},
            {"examples": ZOO_BATCH})
        for k, n in launched.items():
            total[k] += n
        if model in ZOO_RECURRENT:
            _zoo_recurrent_readings(fluid, model, (main, startup, loss),
                                    draws)
    if "mnist" in models:
        _zoo_mnist_card_vs_cpu(fluid, tool)
    return total


# ---- every Fluid optimizer and learning-rate schedule ----

# The zoo's mnist MLP (and, for sparse Adagrad, the same head over an
# is_sparse embedding) in float32 at fluid_benchmark.py's learning rate,
# OPT_STEPS steps in lockstep, as resnet_parity runs: each step once through
# run_steps on the card and once on the CPU from the CPU's state before it,
# the loss within OPT_LOSS_REL_MAX relative (zoo_mnist_card_vs_cpu's
# limit), and every op of the step replayed on the card from the CPU's
# values of its inputs within RESNET_OP_TOL of the CPU's outputs. A
# free-running run cannot be held so: Adagrad, Adamax and FTRL divide by
# the root (FTRL at lr_power -0.7 a power) of a gradient's square, so an
# element whose gradient sums to near 0 turns a 1e-7 difference in
# summation order into a step that differs by a share of the learning
# rate, and the next steps carry it on.
OPT_STEPS = 3
OPT_BATCH = 64
OPT_LR = 0.001
OPT_LOSS_REL_MAX = 1e-5
MODEL_AVERAGE_STEPS = 5
SCHEDULE_STEPS = 12
SPARSE_VOCAB, SPARSE_IDS = 1000, 16
OPTIMIZER_CASES = {
    "lars_momentum": lambda fl: fl.optimizer.LarsMomentum(OPT_LR, 0.9),
    "adagrad": lambda fl: fl.optimizer.Adagrad(OPT_LR),
    "adagrad_sparse": lambda fl: fl.optimizer.Adagrad(OPT_LR),
    "adamax": lambda fl: fl.optimizer.Adamax(OPT_LR),
    "decayed_adagrad": lambda fl: fl.optimizer.DecayedAdagrad(OPT_LR),
    "adadelta": lambda fl: fl.optimizer.Adadelta(OPT_LR),
    "rmsprop": lambda fl: fl.optimizer.RMSProp(OPT_LR),
    "rmsprop_centered": lambda fl: fl.optimizer.RMSProp(
        OPT_LR, momentum=0.9, centered=True),
    "ftrl": lambda fl: fl.optimizer.Ftrl(OPT_LR, l1=1e-4, l2=1e-4),
    "ftrl_power": lambda fl: fl.optimizer.Ftrl(OPT_LR, lr_power=-0.7),
}


def _poly_rate(s, cycle=False):
    """polynomial_decay(0.1, 5, 0.001, power=2.0) at step s; cycled, step 0
    divides by ceil(0) * 5 = 0, which is NaN in both packages."""
    if cycle:
        decay = math.ceil(s / 5) * 5
        if not decay:
            return float("nan")
        return (0.1 - 0.001) * (1.0 - s / decay) ** 2.0 + 0.001
    return (0.1 - 0.001) * (1.0 - min(s / 5, 1.0)) ** 2.0 + 0.001


# name -> (the schedule built on fluid.layers, its closed form at step s,
# the counter's first value); as tests/test_torch_lr_schedules.py
SCHEDULES = {
    "noam": (lambda L: L.noam_decay(64, 4) * 2.0,
             lambda s: 2.0 * 64 ** -0.5 * min(s ** -0.5, s * 4 ** -1.5), 1),
    "exponential": (lambda L: L.exponential_decay(0.1, 3, 0.5),
                    lambda s: 0.1 * 0.5 ** (s / 3), 0),
    "exponential_staircase": (
        lambda L: L.exponential_decay(0.1, 3, 0.5, staircase=True),
        lambda s: 0.1 * 0.5 ** (s // 3), 0),
    "natural_exp": (lambda L: L.natural_exp_decay(0.1, 3, 0.5),
                    lambda s: 0.1 * math.exp(-0.5 * s / 3), 0),
    "inverse_time": (lambda L: L.inverse_time_decay(0.1, 3, 0.5,
                                                    staircase=True),
                     lambda s: 0.1 / (1.0 + 0.5 * (s // 3)), 0),
    "polynomial": (lambda L: L.polynomial_decay(0.1, 5, 0.001, power=2.0),
                   _poly_rate, 0),
    "polynomial_cycle": (lambda L: L.polynomial_decay(0.1, 5, 0.001,
                                                      power=2.0, cycle=True),
                         lambda s: _poly_rate(s, cycle=True), 0),
    "piecewise": (lambda L: L.piecewise_decay([3, 6, 9],
                                              [0.1, 0.05, 0.01, 0.005]),
                  lambda s: [0.1, 0.05, 0.01, 0.005][
                      sum(s >= b for b in (3, 6, 9))], 0),
    "cosine": (lambda L: L.cosine_decay(0.1, 2, 6),
               lambda s: 0.05 * (math.cos((s // 2) * math.pi / 6) + 1.0),
               0),
    "linear_warmup": (lambda L: L.linear_lr_warmup(0.1, 5, 0.01, 0.1),
                      lambda s: 0.01 + 0.09 * s / 5 if s < 5 else 0.1, 0),
}


def _mnist_programs(fluid, mlp, optimize, sparse=False):
    """The mnist MLP (mlp.build) in fresh programs, its startup seeded with
    SEED, and ``optimize(fluid, loss)``; with `sparse`, the MLP's input is
    the sum of SPARSE_IDS rows of an is_sparse [SPARSE_VOCAB, 784]
    embedding. Returns (main, startup, loss, what optimize returned)."""
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = SEED
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        if sparse:
            ids = fluid.layers.data(name="ids", shape=[SPARSE_IDS, 1],
                                    dtype="int64")
            label = fluid.layers.data(name="label", shape=[1], dtype="int64")
            h = fluid.layers.reduce_sum(fluid.layers.embedding(
                ids, size=[SPARSE_VOCAB, 784], is_sparse=True), dim=1)
            for _ in range(2):
                h = fluid.layers.fc(input=h, size=mlp.HID, act="relu")
            loss = fluid.layers.mean(fluid.layers.softmax_with_cross_entropy(
                fluid.layers.fc(input=h, size=10), label))
        else:
            _, loss, _ = mlp.build()
        extra = optimize(fluid, loss)
    return main, startup, loss, extra


def _mnist_feeds(mlp, steps, sparse=False):
    """`steps` batches (with `sparse`, repeated ids among them)."""
    import numpy as np
    if sparse:
        rng = np.random.RandomState(SEED)
        return [{"ids": rng.randint(0, SPARSE_VOCAB,
                                    (OPT_BATCH, SPARSE_IDS, 1)),
                 "label": rng.randint(0, 10, (OPT_BATCH, 1))}
                for _ in range(steps)]
    return [mlp.synthetic_batch(OPT_BATCH, seed=SEED + k)
            for k in range(steps)]


def _lockstep_step(fluid, main, card_main, loss, state, feed, names,
                   exact_ops=(), card_feed=None, cancelling=()):
    """One step of `main` in lockstep, card against CPU, from the CPU's
    `state`: the step through run_steps on the card (`card_main` in main's
    place, fed `card_feed(feed)` where a control gives one), and every op
    of it replayed on the card from the CPU's values (_replay_on_card).
    An output of `cancelling`, which cancels to float32 rounding noise,
    may differ from the CPU's by CANCEL_NOISE times the CPU's own error
    against the step in float64, where that exceeds RESNET_OP_TOL of its
    size. Returns (the CPU's state after, the card's scope, the loss's
    relative error, the worst outputs, the inexact outputs of the op types
    `exact_ops`, ok, the op errors, {cancelling output: the CPU's largest
    value and its largest error against float64, the card's largest
    difference from the CPU and its limit})."""
    vals, after = _cpu_step(fluid, main, state, feed, names)
    wide = _float64_values(fluid, main, state, feed, cancelling) \
        if cancelling else {}
    tol = RESNET_OP_TOL["float32"]
    noise = {n: (vals[n].double() - wide[n]).abs().numpy()
             for n in cancelling}
    scales = {n: noise[n] * (CANCEL_NOISE / tol) for n in cancelling}
    card_scope = fluid.Scope()
    for n, t in state.items():
        card_scope.set(n, t.to("cuda", copy=True))
    fed = card_feed(feed) if card_feed else feed
    card, = fluid.Executor().run_steps(card_main, feed={
        n: v[None] for n, v in fed.items()}, n_steps=1,
        fetch_list=[loss], scope=card_scope)
    cpu = float(vals[loss.name])
    loss_rel = abs(float(card[0]) - cpu) / abs(cpu)
    errs = _replay_on_card(fluid, card_main, [loss.name], state, fed, vals,
                           after, scales)
    ok, worst = _op_verdict(errs)
    inexact = {n: (t, e) for n, (t, _, e) in errs.items()
               if t in exact_ops and e != 0.0}
    cancelled = {}
    for n in cancelling:
        top = float(vals[n].abs().max())
        limit = max(top, float(scales[n].max())) * tol
        cancelled[n] = {"cpu_max": top,
                        "cpu_err_vs_float64": float(noise[n].max()),
                        "card_diff": errs[n][2] * limit / tol,
                        "card_limit": limit}
    return after, card_scope, loss_rel, worst, inexact, ok, errs, cancelled


def _float64_values(fluid, main, state, feed, names):
    """The values of `names` after the step of `main` run on the CPU with
    every float32 variable and the state in float64."""
    import torch
    wide = main.clone()
    for k in range(wide.num_blocks):
        for v in wide.block(k).vars.values():
            if v.dtype == "float32":
                v.dtype = "float64"
    vals, _ = _cpu_step(fluid, wide, {
        n: t.double() if t.dtype == torch.float32 else t
        for n, t in state.items()}, feed, names)
    return vals


def _step_names(main):
    """The non-persistable outputs of main's ops, sorted (a sequence_pool
    writes its MaxIndex only when it pools by MAX)."""
    block = main.global_block()
    return sorted({n for op in block.ops for slot, names in
                   op.outputs.items() for n in names
                   if n != "@EMPTY@" and not block.var(n).persistable and
                   not (op.type == "sequence_pool" and slot == "MaxIndex"
                        and op.attr("pooltype") != "MAX")})


def _lockstep(fluid, programs, feeds, card_main=None, exact_ops=(),
              loss_rel_max=None, card_feed=None, cancelling=()):
    """Each feed of `feeds` one step of `programs` (main, startup, loss) in
    lockstep, card against CPU, from the CPU's state before it (the startup
    run on the CPU): the step through run_steps on the card, its loss
    within `loss_rel_max` (default OPT_LOSS_REL_MAX) of the CPU's, and
    every op of it replayed on the card from the CPU's values
    (_replay_on_card) within RESNET_OP_TOL, the outputs of the op types
    `exact_ops` bit for bit; `card_main` (a control) runs on the card in
    main's place, and a control's `card_feed(feed)` is what the card is
    fed; the outputs `cancelling` are held to the CPU's own float32 noise
    (_lockstep_step), and the readings list them. Returns (the last
    step's card scope, readings, ok)."""
    loss_rel_max = loss_rel_max or OPT_LOSS_REL_MAX
    main, startup, loss = programs[:3]
    card_main = card_main or main
    block = main.global_block()
    scope = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=scope)
    state = {n: scope.get(n) for n, v in block.vars.items()
             if v.persistable and scope.get(n) is not None}
    names = _step_names(main)
    loss_rel, worst, inexact, ok, cancelled = [], [], {}, True, []
    for feed in feeds:
        state, card_scope, rel, step_worst, step_inexact, step_ok, errs, \
            step_cancelled = _lockstep_step(fluid, main, card_main, loss,
                                            state, feed, names, exact_ops,
                                            card_feed, cancelling)
        loss_rel.append(rel)
        worst.append(step_worst)
        cancelled.append(step_cancelled)
        inexact.update(step_inexact)
        ok = ok and step_ok
    ok = ok and max(loss_rel) <= loss_rel_max and not inexact
    rec = {"loss_rel_err": loss_rel, "loss_rel_max": loss_rel_max,
           "op_tol": RESNET_OP_TOL, "worst_op": worst}
    if cancelling:
        rec.update(cancel_noise=CANCEL_NOISE, cancelling=cancelled)
    if exact_ops:
        rec.update(exact_outputs_a_step=sum(
            1 for t, _, _ in errs.values() if t in exact_ops),
            inexact_outputs=inexact)
    return card_scope, rec, ok


def _model_average_check(fluid, mlp):
    """SGD with ModelAverage (window 2 to 3 steps) for MODEL_AVERAGE_STEPS
    lockstep steps (the accumulate ops replayed with the rest); then apply() on the card must put in each parameter's place
    its sums over its counts in float64, rounded once, bit for bit, and
    restore() the very tensors apply() took."""
    def optimize(fl, loss):
        fl.optimizer.SGD(OPT_LR).minimize(loss)
        ma = fl.optimizer.ModelAverage(0.15, min_average_window=2,
                                       max_average_window=3)
        ma.build()
        return ma
    programs = _mnist_programs(fluid, mlp, optimize)
    ma = programs[3]
    card_scope, rec, ok = _lockstep(
        fluid, programs, _mnist_feeds(mlp, MODEL_AVERAGE_STEPS))
    params = [p.name for p in programs[0].all_parameters()]
    trained = {n: card_scope.get(n) for n in params}
    with fluid.scope_guard(card_scope):
        ma.apply()
    exact = True
    for n in params:
        sums = sum(card_scope.get("%s_sum_%d_acc_0" % (n, k)).double().cpu()
                   for k in (1, 2, 3))
        count = int(card_scope.get(n + "_num_accumulates_acc_0").cpu()[0] +
                    card_scope.get(n + "_old_num_accumulates_acc_0")
                    .cpu()[0])
        exact = exact and bool(((sums / count).float() ==
                                card_scope.get(n).cpu()).all())
    with fluid.scope_guard(card_scope):
        ma.restore()
    restored = all(card_scope.get(n) is trained[n] for n in params)
    rec.update({"steps": MODEL_AVERAGE_STEPS,
                "applied_equals_sums_over_counts": exact,
                "restore_gives_back_the_trained_tensors": restored})
    return rec, ok and exact and restored


def _lars_check(fluid, mlp):
    """Momentum with append_LARS (each parameter its own rate Variable),
    OPT_STEPS lockstep steps."""
    def optimize(fl, loss):
        opt = fl.optimizer.Momentum(learning_rate=OPT_LR, momentum=0.9)
        p_g = opt.backward(loss)
        fl.layers.append_LARS(p_g, learning_rate=OPT_LR, weight_decay=0.01)
        opt.apply_gradients(p_g)
    programs = _mnist_programs(fluid, mlp, optimize)
    _, rec, ok = _lockstep(fluid, programs, _mnist_feeds(mlp, OPT_STEPS))
    rates = {tuple(op.input("LearningRate"))
             for op in programs[0].global_block().ops
             if op.type == "momentum"}
    rec["rate_variables"] = len(rates)
    return rec, ok and len(rates) == len(programs[0].all_parameters())


def _schedule_check(fluid, name):
    """One schedule for SCHEDULE_STEPS steps on the card (x [4] -> fc 1 ->
    mean, SGD at the schedule's rate): each fetched rate within
    RECIPE_LR_REL_MAX of the largest of its closed form's rates (a float32
    schedule may cancel: cosine_decay's cos + 1 near cos = -1), NaN where
    that is NaN, and the counter after the steps at its first value +
    SCHEDULE_STEPS - 1."""
    import numpy as np
    schedule, closed, first = SCHEDULES[name]
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = SEED
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[4], dtype="float32")
        loss = fluid.layers.mean(fluid.layers.fc(input=x, size=1))
        lr = schedule(fluid.layers)
        fluid.optimizer.SGD(learning_rate=lr).minimize(loss)
    exe, scope = fluid.Executor(), fluid.Scope()
    exe.run(startup, scope=scope)
    feed = {"x": np.random.RandomState(SEED).randn(
        SCHEDULE_STEPS, 2, 4).astype("float32")}
    rates, = exe.run_steps(main, feed=feed, n_steps=SCHEDULE_STEPS,
                           fetch_list=[lr], scope=scope)
    rates = rates.astype(np.float64).reshape(-1)
    want = np.array([closed(first + k) for k in range(SCHEDULE_STEPS)])
    finite = np.isfinite(want)
    rel = np.abs(rates[finite] - want[finite]) / want[finite].max()
    counter = int(scope.get(LR_COUNTER).reshape(-1)[0])
    return ({"lr_rel_err_max": float(rel.max()), "counter": counter},
            bool(rel.max() <= RECIPE_LR_REL_MAX) and
            bool((np.isnan(rates) == ~finite).all()) and
            counter == first + SCHEDULE_STEPS - 1)


def phase_optimizers(fluid, counters):
    """Every optimizer this slice adds (OPTIMIZER_CASES), ModelAverage and
    append_LARS with Momentum in lockstep with the CPU, and every schedule
    (SCHEDULES) on the card against its closed form. No kernel of the
    port's launches: none of these has one."""
    from paddle_tpu_torch.models import mlp
    t_start = time.perf_counter()
    _zero(counters)
    results, failed = {}, []
    for name, make in OPTIMIZER_CASES.items():
        sparse = name.endswith("_sparse")
        programs = _mnist_programs(
            fluid, mlp, lambda fl, loss, make=make: make(fl).minimize(loss),
            sparse)
        _, rec, ok = _lockstep(fluid, programs,
                               _mnist_feeds(mlp, OPT_STEPS, sparse))
        results[name] = dict(rec, ok=ok)
    for name, fn in (("model_average", _model_average_check),
                     ("append_lars_momentum", _lars_check)):
        rec, ok = fn(fluid, mlp)
        results[name] = dict(rec, ok=ok)
    # control: RMSProp's decay 0.9 in place of 0.95 on the card only must
    # fail the replay
    programs = _mnist_programs(
        fluid, mlp, lambda fl, loss: OPTIMIZER_CASES["rmsprop"](fl).minimize(
            loss))
    faulty = programs[0].clone()
    for op in faulty.global_block().ops:
        if op.type == "rmsprop":
            op.attrs["decay"] = 0.9
    _, rec, control_passed = _lockstep(fluid, programs,
                                       _mnist_feeds(mlp, OPT_STEPS),
                                       card_main=faulty)
    results["control_rmsprop_decay_0.9_on_the_card"] = dict(
        rec, ok=not control_passed)
    for name in SCHEDULES:
        rec, ok = _schedule_check(fluid, name)
        results["schedule_" + name] = dict(rec, ok=ok)
    launched = {k: v for k, v in _read(counters).items() if v}
    failed = [k for k, r in results.items() if not r["ok"]]
    emit({"phase": "optimizers", "ok": not failed and not launched,
          "steps": OPT_STEPS, "batch": OPT_BATCH, "learning_rate": OPT_LR,
          "results": results, "launches": launched,
          "phase_seconds": time.perf_counter() - t_start})
    if failed or launched:
        raise AssertionError("optimizers: %s failed, launches %s"
                             % (failed, launched))


# ---- the Fluid book's straight-line models (tools/torch_book_models.py) ----

# Each model at the book's widths and batch: startup on the card, one warm
# step, BOOK_STEPS steps through run_steps (_window: examples/s, step ms,
# peak memory, launches: none of the port's kernels is on these paths, the
# Adam gate refuses every book parameter and cross_entropy is not the CE
# kernel's op); then BOOK_PARITY_STEPS steps in lockstep with the CPU
# (_lockstep: each loss within OPT_LOSS_REL_MAX, each op replayed on the
# card from the CPU's values within RESNET_OP_TOL; an Adam op replayed so
# takes the CPU's gradient, so no near-epsilon amplification reaches it).
BOOK_STEPS = 4
BOOK_PARITY_STEPS = 3
# the share of recognize_digits_conv's control batch labelled ignore_index
BOOK_IGNORED = 8
W2V_RUNS = 2


def _cross_entropy_unmasked(ctx, inputs, attrs):
    """cross_entropy on the card without its ignore and out-of-range mask
    (a control): every label gathered, clamped into the classes. CPU
    tensors take the real lowering."""
    import torch
    from paddle_tpu_torch.fluid.ops import loss_ops
    x, label = inputs["X"][0], inputs["Label"][0]
    if not x.is_cuda:
        return loss_ops._cross_entropy(ctx, inputs, attrs)
    idx = label.reshape(-1).long().clamp(0, x.shape[-1] - 1)
    return {"Y": [-torch.log(torch.gather(x, -1, idx[:, None]) + 1e-12)]}


def _w2v_twice(fluid, tool):
    """word2vec at the book's width, W2V_RUNS runs of BOOK_STEPS steps on
    the card from one state (the CPU's startup): its four sparse lookups
    of one table reach sgd through scatter_rows_, so the losses and the
    table must be equal bit for bit from run to run."""
    import numpy as np
    import torch
    b = tool.programs("word2vec", fluid, seed=SEED)
    scope = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(b.startup, scope=scope)
    state = {n: scope.get(n) for n, v in b.main.global_block().vars.items()
             if v.persistable and scope.get(n) is not None}
    draws = [tool.synthetic_batch("word2vec", tool.BATCH["word2vec"],
                                  seed=SEED + 50 + k)
             for k in range(BOOK_STEPS)]
    feed = {k: np.stack([d[k] for d in draws]) for k in draws[0]}
    exe, runs = fluid.Executor(), []
    for _ in range(W2V_RUNS):
        card = fluid.Scope()
        for n, t in state.items():
            card.set(n, t.to("cuda", copy=True))
        losses, = exe.run_steps(b.main, feed=feed, n_steps=BOOK_STEPS,
                                fetch_list=[b.loss], scope=card)
        runs.append((losses, card.get("shared_w").cpu()))
    equal = all(np.array_equal(r[0], runs[0][0]) and
                torch.equal(r[1], runs[0][1]) for r in runs[1:])
    return {"runs": W2V_RUNS, "steps": BOOK_STEPS,
            "losses": [r[0].tolist() for r in runs],
            "losses_and_table_bit_for_bit": equal}, equal


def phase_book(fluid, counters):
    """The Fluid book's five straight-line models (fit_a_line,
    recognize_digits_conv, image_classification, word2vec,
    recommender_system) at the book's widths and batches: a _window each
    (no port kernel launches) and BOOK_PARITY_STEPS lockstep steps card
    against CPU; recognize_digits_conv also on a batch with BOOK_IGNORED
    labels at ignore_index, which must pass, and its control
    (cross_entropy without its mask on the card), which must fail;
    word2vec's runs bit for bit (_w2v_twice). Returns the launches."""
    import numpy as np
    from unittest import mock
    from paddle_tpu_torch.fluid.ops import registry
    tool = _load_tool("torch_book_models")
    none = dict.fromkeys(counters, 0)
    total, results = dict(none), {}
    for name in tool.MODELS:
        t0 = time.perf_counter()
        b = tool.programs(name, fluid, seed=SEED)
        batch = tool.BATCH[name]
        draws = [tool.synthetic_batch(name, batch, seed=SEED + k)
                 for k in range(BOOK_STEPS + 1)]
        stacked = {k: np.stack([d[k] for d in draws]) for k in draws[0]}
        launched = _window(
            "book_" + name, fluid, counters, (b.main, b.startup, b.loss),
            {k: v[:1] for k, v in stacked.items()},
            {k: v[1:] for k, v in stacked.items()}, BOOK_STEPS, none, None,
            {"model": name, "batch": batch,
             "ops": len(b.main.global_block().ops),
             "build_seconds": time.perf_counter() - t0},
            {"examples": batch})
        for k, n in launched.items():
            total[k] += n
        feeds = [tool.synthetic_batch(name, batch, seed=SEED + 100 + k)
                 for k in range(BOOK_PARITY_STEPS)]
        _, rec, ok = _lockstep(fluid, b, feeds)
        results[name] = dict(rec, ok=ok)
    digits = tool.programs("recognize_digits_conv", fluid, seed=SEED)
    ignored = [tool.synthetic_batch("recognize_digits_conv",
                                    tool.BATCH["recognize_digits_conv"],
                                    seed=SEED + 200 + k)
               for k in range(BOOK_PARITY_STEPS)]
    for f in ignored:
        f["label"][:BOOK_IGNORED] = IGNORE
    _, rec, ok = _lockstep(fluid, digits, ignored)
    results["recognize_digits_conv_ignore_index"] = dict(rec, ok=ok)
    with mock.patch.dict(registry._LOWERINGS,
                         cross_entropy=_cross_entropy_unmasked):
        _, rec, control_passed = _lockstep(fluid, digits, ignored)
    results["control_cross_entropy_unmasked_on_the_card"] = dict(
        rec, ok=not control_passed)
    rec, ok = _w2v_twice(fluid, tool)
    results["word2vec_twice"] = dict(rec, ok=ok)
    failed = [k for k, r in results.items() if not r["ok"]]
    emit({"phase": "book", "ok": not failed, "parity_steps":
          BOOK_PARITY_STEPS, "results": results})
    if failed:
        raise AssertionError("book: %s failed" % failed)
    return total


# ---- the tensor layers and the initializers (tools/torch_tensor_programs.py)

# tensor_chain at its widths (train256's heads, BERT-base's masked-LM gather,
# ResNet-50's conv2 maps, bf16, Adam(1e-4)): one warm step and TENSOR_STEPS
# through run_steps (_window), one Adam launch a step over the three fc
# weights ([512, 512] and two [768, 768]; the conv filter, the biases and
# the scale take the plain route). Then TENSOR_PARITY_STEPS steps in
# lockstep with the CPU at TENSOR_PARITY_WIDTHS (the same widths, fewer
# sequences and maps: the CPU runs the bf16 conv; _lockstep), each op
# replayed on the card from the CPU's values within RESNET_OP_TOL, the ops
# that move or pick values (TENSOR_EXACT_OPS) bit for bit, the losses
# within OPT_LOSS_REL_MAX; gather's and scatter(overwrite=False)'s gradients at
# full width twice from one state, bit for bit. Control: scatter with
# overwrite=True keeping the first of repeated updates on the card.
TENSOR_STEPS = 4
TENSOR_PARITY_STEPS = 3
TENSOR_PARITY_WIDTHS = dict(batch=4, mlm_seqs=8, maps=2)
TENSOR_ADAM_CASES = [((512, 512), "bfloat16", 1), ((768, 768), "bfloat16", 2)]
TENSOR_ADAM_TENSORS = sum(n for _, _, n in TENSOR_ADAM_CASES)
TENSOR_EXACT_OPS = {"split", "stack", "unstack", "concat", "reverse", "pad",
                    "crop", "squeeze2", "unsqueeze2", "expand", "reshape2",
                    "multiplex", "gather", "pad2d", "shuffle_channel",
                    "space_to_depth", "pad_constant_like", "fill_constant"}
# serve_ids: serve256's program with argmax, argsort, sampling_id(softmax),
# has_nan and has_inf of its logits; sampling_id on SAMPLING_ROWS copies of a
# SAMPLING_CLASSES-class distribution must pass a chi-square test at p >
# SAMPLING_P_MIN, and a distribution shifted by one class must fail it
SAMPLING_ROWS, SAMPLING_CLASSES, SAMPLING_P_MIN = 65536, 16, 1e-4
# initializers: draws within INIT_SE standard errors of their moments
INIT_SE = 5.0
# fc_gan: examples/fc_gan.py's steps (D then G) in lockstep with the CPU
GAN_STEPS = 60
GAN_LOSS_REL_MAX = 1e-5


def _scatter_first_lands(ctx, inputs, attrs):
    """scatter on the card with the first of repeated ids' updates landing
    where the JAX lowering keeps the last (a control). CPU tensors and
    overwrite=False take the real lowering."""
    from paddle_tpu_torch.fluid.ops import tensor_ops
    x = inputs["X"][0]
    if not x.is_cuda or not attrs.get("overwrite", True):
        return tensor_ops._scatter(ctx, inputs, attrs)
    ids = inputs["Ids"][0].reshape(-1).long().flip(0)
    return {"Out": [tensor_ops._scatter_set(x, ids,
                                            inputs["Updates"][0].flip(0))]}


def _row_grads_twice(fluid, chain):
    """tensor_chain at full width: two steps on the card from one state
    (the card's startup), fetching the gradient gather passes to its X and
    the one scatter(overwrite=False) passes to its Updates: equal bits
    (_grads_twice)."""
    import numpy as np
    tool = _load_tool("torch_tensor_programs")
    block = chain.main.global_block()
    gather, = [op for op in block.ops if op.type == "gather"]
    add, = [op for op in block.ops if op.type == "scatter" and
            not op.attrs["overwrite"]]
    names = [gather.input("X")[0] + "@GRAD", add.input("Updates")[0] + "@GRAD"]
    rec, ok = _grads_twice(fluid, chain, tool.chain_batch(SEED + 300), names)
    rec["ids"] = int(np.prod(block.var(gather.input("Index")[0]).shape))
    return rec, ok


def phase_tensor_layers(fluid, counters):
    """tensor_chain (tools/torch_tensor_programs.py) on the card: the
    _window at its widths, the lockstep steps, the row gradients twice and
    the control. Returns the window's launches."""
    from unittest import mock
    from paddle_tpu_torch.fluid.ops import registry
    import torch
    tool = _load_tool("torch_tensor_programs")
    t0 = time.perf_counter()
    chain = tool.tensor_chain(fluid, seed=SEED)
    # the chain's inputs stand for other models' activations, so they are
    # made on the card, in the program's dtypes, before the window (set-up)
    block = chain.main.global_block()
    batch = {k: torch.from_numpy(v).to("cuda", getattr(
        torch, block.var(k).dtype)) for k, v in tool.chain_batch(SEED).items()}
    stacked = lambda steps: {k: v[None].expand(steps, *v.shape)
                             for k, v in batch.items()}
    none = dict.fromkeys(counters, 0)
    launched = _window(
        "tensor_layers", fluid, counters, chain[:3], stacked(1),
        stacked(TENSOR_STEPS), TENSOR_STEPS, dict(none, adam=1),
        TENSOR_ADAM_TENSORS, {"widths": tool.CHAIN, "dtype": "bfloat16",
                              "ops": len(chain.main.global_block().ops),
                              "build_seconds": time.perf_counter() - t0},
        {"steps": 1})
    del batch
    t0 = time.perf_counter()
    results = {}
    small = tool.tensor_chain(fluid, seed=SEED, **TENSOR_PARITY_WIDTHS)
    feeds = [tool.chain_batch(SEED + 100 + k, **TENSOR_PARITY_WIDTHS)
             for k in range(TENSOR_PARITY_STEPS)]
    _, rec, ok = _lockstep(fluid, small[:3], feeds,
                           exact_ops=TENSOR_EXACT_OPS)
    results["lockstep"] = dict(rec, ok=ok)
    with mock.patch.dict(registry._LOWERINGS, scatter=_scatter_first_lands):
        _, rec, control_passed = _lockstep(fluid, small[:3], feeds[:1],
                                           exact_ops=TENSOR_EXACT_OPS)
    results["control_scatter_first_update_lands_on_the_card"] = dict(
        rec, ok=not control_passed)
    rec, ok = _row_grads_twice(fluid, chain)
    results["row_gradients_twice"] = dict(rec, ok=ok)
    failed = [k for k, r in results.items() if not r["ok"]]
    emit({"phase": "tensor_layers_parity", "ok": not failed,
          "widths": TENSOR_PARITY_WIDTHS, "steps": TENSOR_PARITY_STEPS,
          "results": results, "phase_seconds": time.perf_counter() - t0})
    if failed:
        raise AssertionError("tensor_layers: %s failed" % failed)
    return launched


def _chi_square_p(ids, probs):
    """p-value of the chi-square test of `ids`' counts against `probs`,
    the classes under 5 expected draws merged into one cell."""
    import numpy as np
    from scipy import stats
    counts = np.bincount(ids, minlength=len(probs)).astype(np.float64)
    expected = probs * len(ids)
    small = expected < 5
    if small.any():
        counts = np.append(counts[~small], counts[small].sum())
        expected = np.append(expected[~small], expected[small].sum())
    return float(stats.chi2.sf(((counts - expected) ** 2 / expected).sum(),
                               len(expected) - 1))


def _sampling_check(fluid):
    """sampling_id on the card over SAMPLING_ROWS copies of one
    distribution: (readings, ok): the chi-square test against it passes,
    against the distribution shifted by one class (the control) fails."""
    import numpy as np
    probs = np.linspace(1.0, 4.0, SAMPLING_CLASSES)
    probs /= probs.sum()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="p", shape=[SAMPLING_CLASSES],
                              dtype="float32")
        ids = fluid.layers.sampling_id(x)
    drawn, = fluid.Executor().run(main, feed={"p": np.tile(
        probs, (SAMPLING_ROWS, 1)).astype("float32")}, fetch_list=[ids])
    p = _chi_square_p(drawn, probs)
    p_shifted = _chi_square_p(drawn, np.roll(probs, 1))
    return ({"rows": SAMPLING_ROWS, "classes": SAMPLING_CLASSES,
             "chi_square_p": p, "p_min": SAMPLING_P_MIN,
             "control_shifted_p": p_shifted},
            p > SAMPLING_P_MIN and p_shifted <= SAMPLING_P_MIN)


def phase_serve_ids(fluid, transformer, A, counters):
    """serve256's program with next-token ids appended (argmax over the
    vocabulary, argsort, sampling_id of the softmax, has_nan, has_inf):
    REQUESTS requests of batch BATCH, each 12 one-pass launches; argmax and
    argsort equal to the CPU's on the card's own logits, ties included;
    every sampled id in the vocabulary; no NaN or infinity flagged; the
    ms a request the ids add to serving; _sampling_check. Returns the
    launches."""
    import numpy as np
    import torch
    from paddle_tpu_torch.fluid.ops import registry
    cfg = transformer.FLAGSHIP_CFG
    vocab, attn = cfg["tgt_vocab"], 3 * cfg["n_layer"]
    serve, startup, logits_name = transformer.serving_programs(SEED, **cfg)
    ext = serve.clone()
    L = fluid.layers
    with fluid.program_guard(ext, fluid.Program()):
        logits = ext.global_block().var(logits_name)
        top = L.argmax(logits, axis=-1)
        _, order = L.argsort(logits, axis=-1)
        sampled = L.sampling_id(L.softmax(L.reshape(logits, [-1, vocab])))
        nan, inf = L.has_nan(logits), L.has_inf(logits)
    exe, scope = fluid.Executor(), fluid.Scope()
    exe.run(startup, scope=scope)
    fetch = [logits_name, top, order, sampled, nan, inf]
    feeds = [_request(transformer, BATCH, 256, SEED + 400 + i)
             for i in range(REQUESTS)]
    for prog, names in ((serve, [logits_name]), (ext, fetch)):   # warm
        exe.run(prog, feed=feeds[0], fetch_list=names, scope=scope,
                return_numpy=False)
    plain_ms, ids_ms = [], []
    _zero(counters)
    for feed in feeds:
        _, ms = _timed_ms(lambda: exe.run(serve, feed=feed,
                                          fetch_list=[logits_name],
                                          scope=scope, return_numpy=False))
        plain_ms.append(ms)
        before = A.onepass_attention_fwd_bthd.launches
        out, ms = _timed_ms(lambda: exe.run(ext, feed=feed, fetch_list=fetch,
                                            scope=scope, return_numpy=False))
        ids_ms.append(ms)
        ids_launches = A.onepass_attention_fwd_bthd.launches - before
    launched = _read(counters)
    card_logits, top_t, order_t, sampled_t, nan_t, inf_t = out
    cpu = card_logits.cpu()
    ctx = registry.LoweringContext("cpu")
    want_top, = registry.get_lowering("arg_max")(
        ctx, {"X": [cpu]}, {"axis": -1})["Out"]
    want_order, = registry.get_lowering("argsort")(
        ctx, {"X": [cpu]}, {"axis": -1})["Indices"]
    rows = cpu.reshape(-1, vocab)
    ties = int((rows == rows.max(-1, keepdim=True).values).sum(-1).gt(1)
               .sum())
    checks = {
        "argmax_equal": bool(torch.equal(top_t.cpu(), want_top)),
        "argsort_equal": bool(torch.equal(order_t.cpu(), want_order)),
        "sampled_in_vocab": bool(((sampled_t >= 0) & (sampled_t < vocab))
                                 .all()),
        "sampled_shape": list(sampled_t.shape) == [BATCH * 256],
        "no_nan_or_inf_flagged": not bool(nan_t.any()) and
        not bool(inf_t.any()),
        "launches": launched == dict(dict.fromkeys(counters, 0),
                                     onepass=2 * attn * REQUESTS)
        and ids_launches == attn}
    sampling, sampling_ok = _sampling_check(fluid)
    ok = all(checks.values()) and sampling_ok
    emit({"phase": "serve_ids", "ok": ok, "requests": REQUESTS,
          "batch": BATCH, "seq_len": 256, "checks": checks,
          "rows_with_tied_maxima": ties,
          "request_ms": plain_ms, "request_ms_with_ids": ids_ms,
          "added_ms_a_request": float(np.mean(ids_ms[1:]) -
                                      np.mean(plain_ms[1:])),
          "onepass_launches_per_request": ids_launches,
          "launches": launched, "sampling": sampling})
    if not ok:
        raise AssertionError("serve_ids failed: %s, sampling %s"
                             % (checks, sampling))
    del exe, scope
    torch.cuda.empty_cache()
    return launched


def _moments(x):
    """(mean, variance, n) of a card tensor, in float64."""
    x = x.double().reshape(-1)
    m = x.mean()
    return float(m), float(((x - m) ** 2).mean()), x.numel()


def _draw_readings(x, var, fourth, bound):
    """A draw against a distribution of mean 0, variance `var`, fourth
    moment `fourth`, every |x| <= bound (None: no bound): (readings, ok)
    at INIT_SE standard errors."""
    m, v, n = _moments(x)
    se_m, se_v = math.sqrt(var / n), math.sqrt((fourth - var ** 2) / n)
    peak = float(x.abs().max())
    return ({"mean": m, "variance": v, "variance_want": var,
             "variance_se": se_v, "max_abs": peak, "bound": bound},
            abs(m) <= INIT_SE * se_m and abs(v - var) <= INIT_SE * se_v and
            (bound is None or peak <= bound))


def _init_checks(tool, zoo, scope):
    """{parameter: (readings, ok)} of init_zoo's startup run into
    `scope` on the card."""
    import torch
    results = {}
    for name in ("bilinear", "sinusoid", "int_table"):
        got = scope.get(name).cpu()
        want = torch.from_numpy(zoo.values[name])
        results[name] = ({"dtype": str(got.dtype), "bit_for_bit":
                          bool(torch.equal(got, want))},
                         got.dtype == want.dtype and torch.equal(got, want))
    std = tool.TRUNC_STD
    pdf = math.exp(-2.0) / math.sqrt(2 * math.pi)
    z = math.erf(math.sqrt(2.0))
    results["trunc_normal"] = _draw_readings(
        scope.get("trunc_normal") / std, 1 - 4 * pdf / z, 3 - 28 * pdf / z,
        2.0 * (1 + 1e-6))
    shape = tool.ZOO["msra_uniform"][0]
    fan_in = shape[1] * shape[2] * shape[3]
    var = 2.0 / fan_in
    bound = math.sqrt(6.0 / fan_in)
    results["msra_uniform"] = _draw_readings(
        scope.get("msra_uniform"), var, bound ** 4 / 5, bound)
    results["msra_normal"] = _draw_readings(
        scope.get("msra_normal"), var, 3 * var ** 2, None)
    return results


def phase_initializers(fluid):
    """init_zoo's startup program on the card: Bilinear and the two
    NumpyArrayInitializer tables bit for bit the numpy values;
    TruncatedNormal(0, 0.02) within 2 std, its variance 0.7737 std^2 (not
    rescaled); MSRA uniform within sqrt(6 / fan_in) and both MSRA draws at
    variance 2 / fan_in; the moments within INIT_SE standard errors.
    Control: gaussian_random in truncated_gaussian_random's place must
    fail the TruncatedNormal check."""
    import torch
    tool = _load_tool("torch_tensor_programs")
    zoo = tool.init_zoo(fluid, seed=SEED)
    exe, scope = fluid.Executor(), fluid.Scope()
    _, ms = _timed_ms(lambda: exe.run(zoo.startup, scope=scope))
    results = {k: dict(r, ok=ok) for k, (r, ok) in
               _init_checks(tool, zoo, scope).items()}
    faulty = zoo.startup.clone()
    for op in faulty.global_block().ops:
        if op.type == "truncated_gaussian_random":
            op.type = "gaussian_random"
    control = fluid.Scope()
    exe.run(faulty, scope=control)
    rec, passed = _init_checks(tool, zoo, control)["trunc_normal"]
    results["control_untruncated_normal"] = dict(rec, ok=not passed)
    failed = [k for k, r in results.items() if not r["ok"]]
    emit({"phase": "initializers", "ok": not failed, "shapes": {
        n: s for n, (s, _) in tool.ZOO.items()}, "startup_ms": ms,
        "results": results})
    if failed:
        raise AssertionError("initializers: %s failed" % failed)
    del scope, control
    torch.cuda.empty_cache()


def _gan_step(fluid, exe, program, loss, state, feed, device):
    """One step of `program` from `state` on the executor's device: (the
    loss, the persistables after it, on the CPU)."""
    scope = fluid.Scope()
    for n, t in state.items():
        scope.set(n, t.to(device, copy=True))
    got, = exe.run(program, feed=feed, fetch_list=[loss], scope=scope)
    return float(got), {n: scope.get(n).cpu() for n in state}


def _gan_lockstep(fluid, tool, gan, steps):
    """`steps` steps of the D then the G program, each on the card and on
    the CPU from the CPU's state before it: (readings, ok): every loss
    within GAN_LOSS_REL_MAX of the CPU's, and each card step leaving the
    other net's parameters bit for bit as they were."""
    import torch
    cpu_exe, card_exe = fluid.Executor(fluid.CPUPlace()), fluid.Executor()
    scope = fluid.Scope()
    cpu_exe.run(gan.startup, scope=scope)
    state = {n: scope.get(n) for n in scope._vars
             if scope.get(n) is not None}
    rel, kept, losses = [], True, []
    for k in range(steps):
        d_feed, g_feed = tool.gan_batch(SEED + k)
        for program, loss, feed, other in (
                (gan.d_main, gan.d_loss, d_feed, tool.G_PARAMS),
                (gan.g_main, gan.g_loss, g_feed, tool.D_PARAMS)):
            cpu, after = _gan_step(fluid, cpu_exe, program, loss, state,
                                   feed, "cpu")
            card, card_after = _gan_step(fluid, card_exe, program, loss,
                                         state, feed, "cuda")
            rel.append(abs(card - cpu) / abs(cpu))
            losses.append(card)
            kept = kept and all(torch.equal(card_after[n], state[n])
                                for n in other)
            state = after
    return ({"steps": steps, "loss_rel_err_max": max(rel),
             "loss_rel_max": GAN_LOSS_REL_MAX, "losses_first": losses[:2],
             "losses_last": losses[-2:],
             "other_nets_parameters_kept": kept},
            max(rel) <= GAN_LOSS_REL_MAX and kept)


def phase_fc_gan(fluid, counters):
    """examples/fc_gan.py's two programs (tools/torch_tensor_programs.py)
    for GAN_STEPS steps in lockstep, card against CPU; control: the D
    optimizer without parameter_list must move G's parameters on the
    card. No kernel of the port's launches (the Adam gate refuses the
    GAN's parameters)."""
    t0 = time.perf_counter()
    tool = _load_tool("torch_tensor_programs")
    _zero(counters)
    rec, ok = _gan_lockstep(fluid, tool, tool.fc_gan(fluid, seed=SEED),
                            GAN_STEPS)
    launched = {k: v for k, v in _read(counters).items() if v}
    control, control_kept = _gan_lockstep(
        fluid, tool, tool.fc_gan(fluid, seed=SEED, d_parameter_list=None), 1)
    ok = ok and not launched and not control["other_nets_parameters_kept"]
    emit({"phase": "fc_gan", "ok": ok, "batch": tool.GAN_BATCH,
          "learning_rate": tool.GAN_LR, "lockstep": rec,
          "control_d_optimizer_without_parameter_list": control,
          "launches": launched,
          "phase_seconds": time.perf_counter() - t0})
    if not ok:
        raise AssertionError("fc_gan failed: %s, control %s, launches %s"
                             % (rec, control, launched))


# ---- input gradients, fluid.nets, the bhtd layout and the NaN check
# (tools/torch_grad_programs.py)

# fgsm_digits: the FGSM training step of the book's digits model at its
# widths and batch (tools/torch_grad_programs.py): one warm step and
# FGSM_STEPS through run_steps (_window; no port kernel: the Adam gate
# refuses the model's parameters), each step's adversarial loss above its
# clean loss; then FGSM_PARITY_STEPS steps in lockstep with the CPU
# (_lockstep: each op replayed on the card from the CPU's values, the
# clean loss, the adversarial loss and the step's objective within
# OPT_LOSS_REL_MAX). Control: sign as the identity on the card (the step
# along the gradient itself) must fail the lockstep.
FGSM_STEPS = 4
FGSM_PARITY_STEPS = 3


def _sign_as_identity(ctx, inputs, attrs):
    """sign on the card as the identity (a control). CPU tensors take the
    real lowering."""
    from paddle_tpu_torch.fluid.ops import math_ops
    x = inputs["X"][0]
    if not x.is_cuda:
        return math_ops._sign(ctx, inputs, attrs)
    return {"Out": [x.clone()]}


def phase_fgsm_digits(fluid, counters):
    """FGSM adversarial training of recognize_digits_conv (Goodfellow et
    al. 2015) at the book's widths, batch 64: every op of the clean
    forward has two grad ops (fluid.gradients, then minimize). Returns the
    launches."""
    import numpy as np
    from unittest import mock
    from paddle_tpu_torch.fluid.ops import registry
    t0 = time.perf_counter()
    tool = _load_tool("torch_grad_programs")
    g = tool.fgsm_digits(fluid, seed=SEED)
    batch = tool.DIGITS_BATCH
    draws = [tool.digits_batch(batch, seed=SEED + k)
             for k in range(FGSM_STEPS + 1)]
    stacked = {k: np.stack([d[k] for d in draws]) for k in draws[0]}
    block = g.main.global_block()
    types = [op.type for op in block.ops]

    def adversarial_above_clean(scope, extra):
        clean, adv = (x.float().cpu().numpy() for x in extra)
        return ({"clean_losses": clean.tolist(),
                 "adversarial_losses": adv.tolist()},
                bool((adv > clean).all()))
    launched = _window(
        "fgsm_digits", fluid, counters, (g.main, g.startup, g.total),
        {k: v[:1] for k, v in stacked.items()},
        {k: v[1:] for k, v in stacked.items()}, FGSM_STEPS,
        dict.fromkeys(counters, 0), None,
        {"batch": batch, "ops": len(types),
         "grad_of": types.count("grad_of"),
         "batch_norm_grad": types.count("batch_norm_grad"),
         "epsilon": tool.FGSM_EPS},
        {"examples": batch},
        ([g.loss, g.loss_adv], adversarial_above_clean))
    feeds = [tool.digits_batch(batch, seed=SEED + 100 + k)
             for k in range(FGSM_PARITY_STEPS)]
    _, rec, ok = _lockstep(fluid, (g.main, g.startup, g.total), feeds)
    with mock.patch.dict(registry._LOWERINGS, sign=_sign_as_identity):
        _, control, control_passed = _lockstep(
            fluid, (g.main, g.startup, g.total), feeds[:1])
    ok = ok and not control_passed
    emit({"phase": "fgsm_digits_parity", "ok": ok,
          "steps": FGSM_PARITY_STEPS, "lockstep": rec,
          "control_sign_as_identity_on_the_card": dict(
              control, passed=control_passed),
          "phase_seconds": time.perf_counter() - t0})
    if not ok:
        raise AssertionError("fgsm_digits parity failed: %s, control %s"
                             % (rec, control))
    return launched


# input_grads_resnet50: phase inference_resnet50's program (flowers, f32,
# is_test, 1000 classes, 224^2, running statistics drawn from SEED) with
# the two input gradients of tools/torch_grad_programs.py appended: the
# FGSM direction (eps 8/255) and the class-score saliency map (Simonyan et
# al. 2014), both over the one forward, at batch RESNET_INFER_BATCH: ms a
# batch over INPUT_GRAD_ROUNDS runs, peak memory, the busy share of two
# runs traced by torch.profiler, launches (none of the port's kernels);
# the loss on adv (a second run with adv as the feed) above the clean
# loss. Then the program at resnet_parity's batch and image against the
# CPU: each op replayed on the card from the CPU's values within
# RESNET_OP_TOL, and the whole run's loss (RESNET_STEP_LIMITS["loss"]),
# adv and saliency map (["named"], by norm) from the CPU's state. Control:
# the is_test batch norm's gradient in its training form on the card (from
# the batch statistics) must fail the replay.
INPUT_GRAD_ROUNDS = 5


def _batch_norm_grad_training_form():
    from paddle_tpu_torch.fluid.ops import nn_ops

    def lowering(ctx, inputs, attrs):
        if inputs["X"][0].is_cuda:
            attrs = dict(attrs, is_test=False, use_global_stats=False)
        return nn_ops._batch_norm_grad(ctx, inputs, attrs)
    return lowering


def _busy_share(run, n=2, by_name=None):
    """(wall ms, device-busy ms, {kind: [device ms, launches]}) a call of
    run() over n calls traced by torch.profiler (one stream: kernels do
    not overlap); kinds as tools/torch_profile_serve.py classes them
    ("conv": cuDNN's convolutions and layout transposes, "matmul",
    "other"). A dict `by_name` takes the same a kernel name."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    kind = _load_tool("torch_profile_serve")._kind
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n
    by_kind = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            for table, key in ((by_kind, kind(e.name)),
                               (by_name if by_name is not None else {},
                                e.name)):
                k = table.setdefault(key, [0.0, 0])
                k[0] += e.time_range.elapsed_us() / 1e3 / n
                k[1] += 1.0 / n
    return wall, sum(ms for ms, _ in by_kind.values()), by_kind


def phase_input_grads_resnet50(fluid, resnet, counters):
    import numpy as np
    import torch
    from unittest import mock
    from paddle_tpu_torch.fluid.ops import registry
    t0 = time.perf_counter()
    tool = _load_tool("torch_grad_programs")
    g = tool.input_grads_resnet(fluid, seed=SEED, dataset="flowers")
    block = g.main.global_block()
    types = [op.type for op in block.ops]
    stats = tool.draw_bn_stats(g.main, SEED)
    exe, scope = fluid.Executor(), fluid.Scope()
    exe.run(g.startup, scope=scope)
    for n, v in stats.items():
        scope.set(n, torch.from_numpy(v).cuda())
    feed = resnet.synthetic_batch(RESNET_INFER_BATCH, RESNET_IMAGE,
                                  RESNET_CLASSES, seed=SEED)
    fetch = [g.adv.name, g.saliency.name, g.loss.name]
    run = lambda f=feed: exe.run(g.main, feed=f, fetch_list=fetch,
                                 scope=scope, return_numpy=False)
    run()                                     # warm
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero(counters)
    ms = []
    for _ in range(INPUT_GRAD_ROUNDS):
        out, t = _timed_ms(run)
        ms.append(t)
    launched = _read(counters)
    peak = torch.cuda.max_memory_allocated()
    wall, busy, by_kind = _busy_share(run)
    adv, saliency, loss = out
    step = (adv - torch.from_numpy(feed["img"]).cuda()).abs()
    adv_loss, = exe.run(g.main, feed=dict(feed, img=adv),
                        fetch_list=[g.loss.name], scope=scope)
    eps = tool.RESNET_EPS
    moved = float(((step - eps).abs() <= 1e-6).float().mean())
    first = {"saliency_shape": list(saliency.shape),
             "saliency_finite": bool(torch.isfinite(saliency).all()),
             "adv_share_moved_by_eps": moved,
             "clean_loss": float(loss), "adversarial_loss": float(adv_loss)}
    ok = first["saliency_finite"] and moved > 0.99 and \
        float(adv_loss) > float(loss) and \
        launched == dict.fromkeys(counters, 0) and \
        list(saliency.shape) == [RESNET_INFER_BATCH] + RESNET_IMAGE
    del exe, scope, out, adv, saliency, step
    torch.cuda.empty_cache()

    # against the CPU at resnet_parity's batch and image
    cpu_scope = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(g.startup, scope=cpu_scope)
    state = {v.name: cpu_scope.get(v.name) for v in block.vars.values()
             if v.persistable and cpu_scope.get(v.name) is not None}
    state.update({n: torch.from_numpy(v) for n, v in stats.items()})
    small = resnet.synthetic_batch(RESNET_PARITY_BATCH, RESNET_PARITY_IMAGE,
                                   RESNET_CLASSES, seed=SEED + 700)
    names = sorted({n for op in block.ops for n in op.output_arg_names
                    if n != "@EMPTY@" and not block.var(n).persistable})
    vals, after = _cpu_step(fluid, g.main, state, small, names)
    errs = _replay_on_card(fluid, g.main, fetch, state, small, vals, after)
    op_ok, worst = _op_verdict(errs)
    card, _ = _card_step(fluid, fluid.Executor(), g.main, state, small,
                         fetch, [])
    cpu = {n: fluid.executor.as_numpy(vals[n]) for n in fetch}
    whole = {"loss": abs(float(card[g.loss.name]) - float(cpu[g.loss.name]))
             / abs(float(cpu[g.loss.name])),
             "adv": _rel_norm(card[g.adv.name], cpu[g.adv.name]),
             "saliency": _rel_norm(card[g.saliency.name],
                                   cpu[g.saliency.name])}
    whole_ok = whole["loss"] <= RESNET_STEP_LIMITS["loss"] and \
        max(whole["adv"], whole["saliency"]) <= RESNET_STEP_LIMITS["named"]
    with mock.patch.dict(registry._LOWERINGS,
                         batch_norm_grad=_batch_norm_grad_training_form()):
        control_ok, control_worst = _op_verdict(_replay_on_card(
            fluid, g.main, fetch, state, small, vals, after))
    ok = ok and op_ok and whole_ok and not control_ok
    emit({"phase": "input_grads_resnet50", "ok": ok,
          "batch": RESNET_INFER_BATCH, "image": RESNET_IMAGE,
          "dtype": "float32", "ops": len(types),
          "grad_of": types.count("grad_of"),
          "batch_norm_grad": types.count("batch_norm_grad"),
          "epsilon": eps, "ms_per_batch": ms,
          "images_per_s": RESNET_INFER_BATCH * 1e3 / min(ms),
          "peak_memory_bytes": peak, "profiled_wall_ms": wall,
          "device_busy_ms": busy, "busy_share": busy / wall,
          "device_ms_and_launches_by_kind": by_kind,
          "conv_flops_a_batch_forward": conv_flops_per_image(g.main) *
          RESNET_INFER_BATCH,
          "port_kernel_launches": launched, "first_gradient": first,
          "parity": {"batch": RESNET_PARITY_BATCH,
                     "image": RESNET_PARITY_IMAGE, "op_tol": RESNET_OP_TOL,
                     "worst_op": worst, "ops_ok": op_ok,
                     "whole_run": whole,
                     "whole_limits": RESNET_STEP_LIMITS},
          "control_batch_norm_grad_training_form_on_the_card": {
              "passed": control_ok, "worst_op": control_worst},
          "phase_seconds": time.perf_counter() - t0})
    if not ok:
        raise AssertionError("input_grads_resnet50 failed: %s, ops %s, "
                             "whole run %s, control passed %s, launches %s"
                             % (first, worst, whole, control_ok, launched))
    return launched


# nets: fluid.nets at the widths of the models that use them, each net's
# program trained by SGD(1e-3) on a mean of squares (forward and
# backward): img_conv_group as VGG-16's first block (64 filters twice,
# 3x3, on 3x224x224, batch 64, f32), glu over a [8192, 4096] bf16 fc (a
# gated FFN at train256's d_model), scaled_dot_product_attention at
# train256's widths ([256, 256, 512], 8 heads, bf16, dropout 0; the q, k,
# v projections fc's) and an fc over three bf16 inputs of widths 512, 512
# and 2048 (16,384 rows). Each: one warm step and NETS_STEPS through
# run_steps (_window, the feeds made on the card before it; no port
# kernel), then NETS_PARITY_STEPS steps in lockstep with the CPU at
# NETS_PARITY_BATCH (each op within RESNET_OP_TOL; the loss within
# OPT_LOSS_REL_MAX in f32, TRAIN_LOSS_REL_MAX in bf16). Control: the
# attention's 1/sqrt(d) scale ignored on the card.
NETS_STEPS = 3
NETS_PARITY_STEPS = 2
NETS_PARITY_BATCH = {"img_conv_group": 2, "glu": 256,
                     "scaled_dot_product_attention": 4, "fc_three_inputs": 256}


def _net_programs(fluid, name):
    """(main, startup, loss, {feed: per-example shape}, dtype) of net
    `name` at its width."""
    L = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = SEED
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        if name == "img_conv_group":
            shapes, dtype = {"img": RESNET_IMAGE}, "float32"
            out = fluid.nets.img_conv_group(
                L.data(name="img", shape=RESNET_IMAGE, dtype="float32"),
                conv_num_filter=[64, 64], pool_size=2, conv_act="relu",
                pool_stride=2)
        elif name == "glu":
            shapes, dtype = {"x": [512]}, "bfloat16"
            x = L.cast(L.data(name="x", shape=[512], dtype="float32"),
                       dtype)
            out = fluid.nets.glu(L.fc(x, 4096), dim=-1)
        elif name == "scaled_dot_product_attention":
            shapes, dtype = {"x": [256, 512]}, "bfloat16"
            x = L.cast(L.data(name="x", shape=[256, 512], dtype="float32"),
                       dtype)
            q, k, v = (L.fc(x, 512, num_flatten_dims=2, bias_attr=False)
                       for _ in range(3))
            out = fluid.nets.scaled_dot_product_attention(q, k, v, 8)
        else:
            shapes = {"a": [512], "b": [512], "c": [2048]}
            dtype = "bfloat16"
            xs = [L.cast(L.data(name=n, shape=s, dtype="float32"), dtype)
                  for n, s in shapes.items()]
            out = L.fc(xs, 512)
        loss = L.mean(L.square(L.cast(out, "float32")))
        fluid.optimizer.SGD(learning_rate=1e-3).minimize(loss)
    return main, startup, loss, shapes, dtype


NET_BATCH = {"img_conv_group": 64, "glu": 8192,
             "scaled_dot_product_attention": 256, "fc_three_inputs": 16384}


def _scale_ignored(ctx, inputs, attrs):
    """scale on the card as the identity (a control)."""
    from paddle_tpu_torch.fluid.ops import math_ops
    x = inputs["X"][0]
    if not x.is_cuda:
        return math_ops._scale(ctx, inputs, attrs)
    return {"Out": [x.clone()]}


def phase_nets(fluid, counters):
    import numpy as np
    import torch
    from unittest import mock
    from paddle_tpu_torch.fluid.ops import registry
    t0 = time.perf_counter()
    results, total = {}, dict.fromkeys(counters, 0)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    for name in NET_BATCH:
        main, startup, loss, shapes, dtype = _net_programs(fluid, name)
        batch = NET_BATCH[name]
        feed = {n: torch.rand([NETS_STEPS + 1, batch] + s, generator=gen,
                              device="cuda") * 2 - 1
                for n, s in shapes.items()}
        launched = _window(
            "nets_" + name, fluid, counters, (main, startup, loss),
            {n: v[:1] for n, v in feed.items()},
            {n: v[1:] for n, v in feed.items()}, NETS_STEPS,
            dict.fromkeys(counters, 0), None,
            {"net": name, "batch": batch, "dtype": dtype,
             "ops": len(main.global_block().ops)},
            {"examples": batch})
        del feed
        for k, n in launched.items():
            total[k] += n
        rng = np.random.RandomState(SEED + 800)
        small = [{n: rng.uniform(-1, 1, [NETS_PARITY_BATCH[name]] + s)
                  .astype("float32") for n, s in shapes.items()}
                 for _ in range(NETS_PARITY_STEPS)]
        limit = OPT_LOSS_REL_MAX if dtype == "float32" else \
            TRAIN_LOSS_REL_MAX
        _, rec, ok = _lockstep(fluid, (main, startup, loss), small,
                               loss_rel_max=limit)
        results[name] = dict(rec, ok=ok)
        if name == "scaled_dot_product_attention":
            with mock.patch.dict(registry._LOWERINGS, scale=_scale_ignored):
                _, rec, passed = _lockstep(fluid, (main, startup, loss),
                                           small[:1], loss_rel_max=limit)
            results["control_attention_scale_ignored_on_the_card"] = dict(
                rec, ok=not passed)
    failed = [k for k, r in results.items() if not r["ok"]]
    emit({"phase": "nets", "ok": not failed,
          "parity_steps": NETS_PARITY_STEPS,
          "parity_batch": NETS_PARITY_BATCH, "results": results,
          "phase_seconds": time.perf_counter() - t0})
    if failed:
        raise AssertionError("nets: %s failed" % failed)
    return total


# bhtd_attention: the fused_attention op in its default [B, H, T, D]
# layout at train4096's shapes ([8, 8, 4096, 64], bf16), causal and not,
# forward and backward through fluid.gradients: each run launches the
# flash forward, dq and dkv kernels once (rows 2, 4, 5); out, dQ, dK and
# dV from ops/attention.fused_attention equal the bthd route's on the
# transposed tensors bit for bit (the same kernels on the same values);
# the two routes' ms (CUDA events, forward and backward). At T 256 the
# dense reference runs, no kernel launch. Control: the bthd route on the
# untransposed tensors (H and T swapped) must differ.
BHTD_SHAPE = (8, 8, LONG_SEQ, 64)
BHTD_SHORT = 256


def _bhtd_program(fluid, causal, t):
    """(program, [out, dq, dk, dv]): q, k, v [B, 8, t, 64] fed in f32, cast
    to bf16, the fused_attention op (default layout), and the gradients of
    the mean of the output's squares in q, k and v."""
    L = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        h, d = BHTD_SHAPE[1], BHTD_SHAPE[3]
        qkv = [L.data(name=n, shape=[h, t, d], dtype="float32",
                      stop_gradient=False) for n in "qkv"]
        helper = fluid.LayerHelper("fused_attention")
        out = helper.create_variable_for_type_inference("bfloat16")
        helper.append_op(type="fused_attention",
                         inputs={s: [L.cast(x, "bfloat16")]
                                 for s, x in zip("QKV", qkv)},
                         outputs={"Out": [out]},
                         attrs={"causal": causal, "scale": -1.0})
        loss = L.mean(L.square(L.cast(out, "float32")))
        grads = fluid.gradients(loss, qkv)
    return main, [out] + grads


def _attention_and_grads(fn, q, k, v, do, causal):
    import torch
    leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
    out = fn(*leaves, causal=causal)
    return [out.detach()] + list(torch.autograd.grad(out, leaves, do))


def phase_bhtd_attention(fluid, A, counters):
    import torch
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    b, h, t, d = BHTD_SHAPE
    exe, total, readings, ok = fluid.Executor(), None, {}, True
    tr = lambda x: x.transpose(1, 2).contiguous()
    back = lambda x: x.transpose(1, 2)
    for causal in (False, True):
        feed = {n: torch.randn(BHTD_SHAPE, generator=gen, device="cuda")
                for n in "qkv"}
        main, outs = _bhtd_program(fluid, causal, t)
        exe.run(main, feed=feed, fetch_list=[o.name for o in outs],
                scope=fluid.Scope(), return_numpy=False)       # warm
        _zero(counters)
        got = exe.run(main, feed=feed, fetch_list=[o.name for o in outs],
                      scope=fluid.Scope(), return_numpy=False)
        torch.cuda.synchronize()
        launched = _read(counters)
        want = dict.fromkeys(counters, 0)
        want.update(flash=1, flash_bwd_dq=1, flash_bwd_dkv=1)
        total = launched if total is None else \
            {k: total[k] + n for k, n in launched.items()}
        q, k, v = (feed[n].to(torch.bfloat16) for n in "qkv")
        do = torch.randn(q.shape, generator=gen, device="cuda").to(
            torch.bfloat16)
        bhtd = _attention_and_grads(A.fused_attention, q, k, v, do, causal)
        bthd = [back(x) for x in _attention_and_grads(
            A.fused_attention_bthd, tr(q), tr(k), tr(v), tr(do), causal)]
        equal = [bool(torch.equal(x, y)) for x, y in zip(bhtd, bthd)]
        control_equal = bool(torch.equal(
            A.fused_attention_bthd(q, k, v, causal), bhtd[0]))
        ms = {"bhtd": time_ms(lambda: _attention_and_grads(
                  A.fused_attention, q, k, v, do, causal), iters=10),
              "bthd": time_ms(lambda: _attention_and_grads(
                  A.fused_attention_bthd, tr(q), tr(k), tr(v), tr(do),
                  causal), iters=10)}
        case_ok = launched == want and all(equal) and not control_equal \
            and all(bool(torch.isfinite(x.float()).all()) for x in got)
        ok = ok and case_ok
        readings["causal" if causal else "non_causal"] = {
            "launches_a_run": {k: n for k, n in launched.items() if n},
            "out_dq_dk_dv_equal_to_bthd": equal,
            "control_untransposed_equal": control_equal,
            "ms_fwd_bwd_with_transposes": ms, "ok": case_ok}
        del feed, got, bhtd, bthd
    short = {n: torch.randn((b, h, BHTD_SHORT, d), generator=gen,
                            device="cuda") for n in "qkv"}
    main, outs = _bhtd_program(fluid, True, BHTD_SHORT)
    _zero(counters)
    got = exe.run(main, feed=short, fetch_list=[o.name for o in outs],
                  scope=fluid.Scope(), return_numpy=False)
    dense = _read(counters)
    q, k, v = (short[n].to(torch.bfloat16) for n in "qkv")
    dense_ok = dense == dict.fromkeys(counters, 0) and torch.equal(
        got[0], A.reference_attention(q, k, v, True)) and \
        all(bool(torch.isfinite(x.float()).all()) for x in got)
    ok = ok and dense_ok
    emit({"phase": "bhtd_attention", "ok": ok, "shape": list(BHTD_SHAPE),
          "dtype": "bfloat16", "cases": readings,
          "t256_dense": {"launches": {k: n for k, n in dense.items() if n},
                         "ok": dense_ok},
          "phase_seconds": time.perf_counter() - t0})
    if not ok:
        raise AssertionError("bhtd_attention failed: %s, T 256 %s"
                             % (readings, dense))
    torch.cuda.empty_cache()
    return total


# check_nan_inf: train256's program (TRAIN_BATCH, seq 256, dropout 0.1)
# for NAN_STEPS steps through Executor.run from one startup state in two
# scopes, one executor with FLAGS_check_nan_inf's check on and one with
# it off, in turns: the losses and every persistable after the steps bit
# for bit equal; each step's ms, and the scan alone on the state the steps
# wrote (NAN_SCAN_ROUNDS times, host clock with a synchronize). Then log of a negative feed with the
# check on raises FloatingPointError naming its output; the control, the
# same run with it off, returns NaN and does not raise.
NAN_STEPS = 6
NAN_SCAN_ROUNDS = 5


def phase_check_nan_inf(fluid, transformer, cfg):
    import numpy as np
    import torch
    t0 = time.perf_counter()
    main, startup, loss = transformer.training_programs(SEED, **cfg)
    off, on = fluid.Executor(), fluid.Executor()
    on.check_nan_inf = True
    scopes = {"off": fluid.Scope(), "on": fluid.Scope()}
    off.run(startup, scope=scopes["off"])
    persist = [v.name for v in main.global_block().vars.values()
               if v.persistable and scopes["off"].get(v.name) is not None]
    for n in persist:
        scopes["on"].set(n, scopes["off"].get(n).clone())
    losses, ms = {"off": [], "on": []}, {"off": [], "on": []}
    for k in range(NAN_STEPS + 1):
        feed = transformer.synthetic_batch(TRAIN_BATCH, cfg["seq_len"],
                                           cfg["tgt_vocab"], SEED + 900 + k)
        for label, exe in (("off", off), ("on", on)):
            (got,), t = _timed_ms(lambda: exe.run(
                main, feed=feed, fetch_list=[loss], scope=scopes[label]))
            losses[label].append(float(np.asarray(got).reshape(-1)[0]))
            if k:                      # the first step warms up
                ms[label].append(t)
    same = losses["off"] == losses["on"] and all(
        torch.equal(scopes["off"].get(n), scopes["on"].get(n))
        for n in persist)
    # the scan alone on the step's state: what it reads and its ms
    plan = on._plan(main, [loss.name])
    scanned = sum(scopes["on"].get(n).numel() *
                  scopes["on"].get(n).element_size() for n in plan.written
                  if scopes["on"].has(n) and
                  scopes["on"].get(n).is_floating_point())
    scan_ms = [_timed_ms(lambda: on._check_finite(
        plan, {}, scopes["on"]))[1] for _ in range(NAN_SCAN_ROUNDS)]
    del scopes
    torch.cuda.empty_cache()
    prog, startup_log = fluid.Program(), fluid.Program()
    with fluid.program_guard(prog, startup_log), fluid.unique_name.guard():
        x = fluid.layers.data(name="x", shape=[4], dtype="float32")
        out = fluid.layers.log(x)
    feed = {"x": -np.ones((2, 4), "float32")}
    raised = None
    try:
        on.run(prog, feed=feed, fetch_list=[out], scope=fluid.Scope())
    except FloatingPointError as e:
        raised = str(e)
    control, = off.run(prog, feed=feed, fetch_list=[out],
                       scope=fluid.Scope())
    ok = same and bool(np.isfinite(losses["on"]).all()) and \
        raised is not None and repr(out.name) in raised and \
        bool(np.isnan(control).all())
    emit({"phase": "check_nan_inf", "ok": ok, "batch": TRAIN_BATCH,
          "seq_len": cfg["seq_len"], "steps": NAN_STEPS,
          "losses": losses, "losses_and_state_bit_for_bit": same,
          "step_ms": ms, "mean_step_ms": {k: sum(v) / len(v)
                                          for k, v in ms.items()},
          "scan_alone_ms": scan_ms, "scanned_state_bytes": scanned,
          "log_of_negative_raised": raised,
          "control_flag_off_returned_nan": bool(np.isnan(control).all()),
          "phase_seconds": time.perf_counter() - t0})
    if not ok:
        raise AssertionError("check_nan_inf failed: losses %s, raised %r"
                             % (losses, raised))


# ---- the rest of the NN layers (tools/torch_nn_programs.py)

# dcgan: DCGAN at dcgan.torch's widths (batch 64, f32, Adam(2e-4, 0.5)): one
# warm D and G step, then DCGAN_STEPS D steps and DCGAN_STEPS G steps through
# run_steps (no port kernel: the Adam gate refuses 4-D filters and 1-D batch
# norm parameters); then DCGAN_PARITY_STEPS alternating D and G steps in
# lockstep with the CPU at batch DCGAN_PARITY_BATCH (each op replayed on the
# card from the CPU's values within RESNET_OP_TOL, losses within
# OPT_LOSS_REL_MAX, the other net's parameters untouched). Control: G's
# transposed-convolution filters flipped spatially on the card.
DCGAN_STEPS = 4
DCGAN_PARITY_STEPS = 2
DCGAN_PARITY_BATCH = 8
# stn_digits: the spatial transformer on the book's digits (batch 64, Adam);
# a window, STN_PARITY_STEPS lockstep steps from the identity transform.
# Control: grid_sampler over half-pixel (not align-corners) coordinates on
# the card.
STN_STEPS = 4
STN_PARITY_STEPS = 3
# word2vec_hsigmoid: the book's word2vec with hsigmoid (batch 100, SGD); a
# window, W2V_HS_PARITY_STEPS lockstep steps, and the W and bias gradients
# twice from one state, bit for bit. Control: the path codes inverted on the
# card.
W2V_HS_STEPS = 4
W2V_HS_PARITY_STEPS = 3
# nn_layers: nn_chain at its widths (every part, its inputs made on the card
# before the window), NN_STEPS steps, one Adam launch a step over the LM
# head's [512, 8192] weight (NN_ADAM_CASES); NN_PARITY_STEPS lockstep steps
# of its deterministic parts at NN_PARITY_WIDTHS (fewer maps, clips, rows and
# nodes; the CPU runs the C3D blocks at 16x16); the drawing heads held by
# their invariants at full width; spectral_norm's sigma after SN_CALLS
# single-step iterations against float64 power iteration from the same
# start (within SN_ITER_REL_MAX) and against the largest singular value
# (within SN_GAP_MAX: 20 steps of power iteration on a Gaussian [512, 4096]
# weight leave 1-2.5% of it, tests/test_torch_nn_ops.py). Control: the
# antialiasing shrink without antialiasing on the card.
NN_STEPS = 3
NN_PARITY_STEPS = 2
NN_PARITY_WIDTHS = dict(maps=2, channels=64, size=16, clips=1, frames=4,
                        clip_size=16, rows=2, steps=40, width=64, im_maps=2,
                        im_channels=16, im_w=20, pairs=64, pair_dim=32,
                        pair_out=16, shifts=64, dense_batch=256, trees=2,
                        nodes=32, node_feat=16, tree_out=16, focus_maps=2,
                        sm_rows=64)
NN_ADAM_CASES = [((512, 8192), "float32", 1)]
NN_ADAM_TENSORS = sum(n for _, _, n in NN_ADAM_CASES)
SN_CALLS = 20
SN_ITER_REL_MAX = 1e-4
SN_GAP_MAX = 0.025
SAMPLE_CHI_DRAWS = 65536


def _stack_feeds(feeds):
    """A list of step feeds as run_steps takes them, [steps, ...]."""
    import numpy as np
    return {k: np.stack([f[k] for f in feeds]) for k in feeds[0]}


def _persistables(*programs):
    return sorted({n for p in programs for n, v in p.global_block()
                   .vars.items() if v.persistable})


def _gan_alternating_lockstep(fluid, gan, feeds, control=None):
    """D then G, each step of `feeds` ((d_feed, g_feed) pairs), in lockstep
    card against CPU from the CPU's state (_lockstep_step), the lowerings
    `control` ({op type: lowering}) patched in on the card's runs. Returns
    (readings, ok): losses within OPT_LOSS_REL_MAX, every op within
    RESNET_OP_TOL, each card step leaving the other net's parameters bit
    for bit as they were."""
    import torch
    from unittest import mock
    from paddle_tpu_torch.fluid.ops import registry
    scope = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(gan.startup, scope=scope)
    state = {n: scope.get(n) for n in _persistables(gan.d_main, gan.g_main)
             if scope.get(n) is not None}
    names = {p: _step_names(p) for p in (gan.d_main, gan.g_main)}
    rel, worst, kept, ok = [], [], True, True
    patch = mock.patch.dict(registry._LOWERINGS, control or {})
    for d_feed, g_feed in feeds:
        for main, loss, feed, other in (
                (gan.d_main, gan.d_loss, d_feed, gan.g_params),
                (gan.g_main, gan.g_loss, g_feed, gan.d_params)):
            with patch:
                after, card, r, w, _, step_ok, _, _ = _lockstep_step(
                    fluid, main, main, loss, state, feed, names[main])
            rel.append(r)
            worst.append(w)
            ok = ok and step_ok
            kept = kept and all(torch.equal(card.get(n).cpu(), state[n])
                                for n in other)
            state = after
    ok = ok and max(rel) <= OPT_LOSS_REL_MAX and kept
    return {"loss_rel_err": rel, "loss_rel_max": OPT_LOSS_REL_MAX,
            "op_tol": RESNET_OP_TOL, "worst_op": worst,
            "other_nets_parameters_kept": kept}, ok


def _conv_transpose_flipped(ctx, inputs, attrs):
    """conv2d_transpose on the card with its filter flipped spatially (the
    classic mistake of porting a transposed convolution as a convolution's
    gradient; a control). CPU tensors take the real lowering."""
    from paddle_tpu_torch.fluid.ops import nn_ops
    w = inputs["Filter"][0]
    if w.is_cuda:
        inputs = dict(inputs, Filter=[w.flip(-1, -2)])
    return nn_ops._conv2d_transpose(ctx, inputs, attrs)


def phase_dcgan(fluid, counters):
    """DCGAN (tools/torch_nn_programs.py) on the card: D and G windows, the
    busy share of a D and a G step, the lockstep and its control. Returns
    the window's launches."""
    import numpy as np
    import torch
    t_start = time.perf_counter()
    tool = _load_tool("torch_nn_programs")
    gan = tool.dcgan(fluid, seed=SEED)
    draws = [tool.dcgan_batch(SEED + k) for k in range(DCGAN_STEPS + 1)]
    d_stack = _stack_feeds([d for d, _ in draws])
    g_stack = _stack_feeds([g for _, g in draws])
    exe, scope = fluid.Executor(), fluid.Scope()
    exe.run(gan.startup, scope=scope)
    for main, loss, stack in ((gan.d_main, gan.d_loss, d_stack),
                              (gan.g_main, gan.g_loss, g_stack)):
        exe.run_steps(main, feed={k: v[:1] for k, v in stack.items()},
                      n_steps=1, fetch_list=[loss], scope=scope)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero(counters)
    rec = {"phase": "dcgan", "widths": tool.DCGAN, "steps": DCGAN_STEPS,
           "ops": {"d": len(gan.d_main.global_block().ops),
                   "g": len(gan.g_main.global_block().ops)}}
    losses = {}
    for part, main, loss, stack in (("d", gan.d_main, gan.d_loss, d_stack),
                                    ("g", gan.g_main, gan.g_loss, g_stack)):
        t0 = time.perf_counter()
        got, = exe.run_steps(main, feed={k: v[1:] for k, v in stack.items()},
                             n_steps=DCGAN_STEPS, fetch_list=[loss],
                             scope=scope)
        torch.cuda.synchronize()
        rec[part + "_step_ms"] = (time.perf_counter() - t0) * 1e3 / \
            DCGAN_STEPS
        losses[part] = np.asarray(got).reshape(-1).tolist()
    launched = _read(counters)
    rec["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    one_d = {k: v[1] for k, v in d_stack.items()}
    one_g = {k: v[1] for k, v in g_stack.items()}
    wall, busy, by_kind = _busy_share(lambda: (
        exe.run(gan.d_main, feed=one_d, fetch_list=[gan.d_loss],
                scope=scope),
        exe.run(gan.g_main, feed=one_g, fetch_list=[gan.g_loss],
                scope=scope)))
    rec.update(losses=losses, images_per_s=tool.DCGAN["batch"] * 1e3 /
               (rec["d_step_ms"] + rec["g_step_ms"]),
               profiled_wall_ms_d_and_g=wall, device_busy_ms=busy,
               busy_share=busy / wall, device_ms_by_kind=by_kind,
               launches=launched)
    del exe, scope
    torch.cuda.empty_cache()
    widths = dict(batch=DCGAN_PARITY_BATCH)
    feeds = [tool.dcgan_batch(SEED + 100 + k, **widths)
             for k in range(DCGAN_PARITY_STEPS)]
    lock, lock_ok = _gan_alternating_lockstep(fluid, gan, feeds)
    control, control_passed = _gan_alternating_lockstep(
        fluid, gan, feeds[:1], {"conv2d_transpose": _conv_transpose_flipped})
    finite = all(np.isfinite(v).all() for v in losses.values())
    ok = finite and not any(launched.values()) and lock_ok and \
        not control_passed
    rec.update(ok=ok, parity_batch=DCGAN_PARITY_BATCH, lockstep=lock,
               control_g_filter_flipped_on_the_card=dict(
                   control, ok=not control_passed),
               phase_seconds=time.perf_counter() - t_start)
    emit(rec)
    if not ok:
        raise AssertionError("dcgan failed: %s" % rec)
    return launched


def _grid_sampler_half_pixel(ctx, inputs, attrs):
    """grid_sampler on the card over half-pixel coordinates
    (align_corners=False; a control). CPU tensors take the real lowering."""
    import torch.nn.functional as F
    from paddle_tpu_torch.fluid.ops import nn_ops
    x, grid = inputs["X"][0], inputs["Grid"][0]
    if not x.is_cuda:
        return nn_ops._grid_sampler(ctx, inputs, attrs)
    return {"Output": [F.grid_sample(x, grid, padding_mode="border",
                                     align_corners=False)]}


def phase_stn_digits(fluid, counters):
    """The spatial transformer on the book's digits: a _window (no port
    kernel), the lockstep from the identity transform and its control.
    Returns the window's launches."""
    from unittest import mock
    from paddle_tpu_torch.fluid.ops import registry
    tool = _load_tool("torch_nn_programs")
    t0 = time.perf_counter()
    prog = tool.stn_digits(fluid, seed=SEED)
    batch = tool.STN["batch"]
    stacked = _stack_feeds([tool.stn_batch(SEED + k, batch)
                            for k in range(STN_STEPS + 1)])
    none = dict.fromkeys(counters, 0)
    launched = _window(
        "stn_digits", fluid, counters, prog[:3],
        {k: v[:1] for k, v in stacked.items()},
        {k: v[1:] for k, v in stacked.items()}, STN_STEPS, none, None,
        {"batch": batch, "ops": len(prog.main.global_block().ops),
         "build_seconds": time.perf_counter() - t0}, {"examples": batch})
    t0 = time.perf_counter()
    feeds = [tool.stn_batch(SEED + 100 + k, batch)
             for k in range(STN_PARITY_STEPS)]
    results = {}
    _, rec, ok = _lockstep(fluid, prog[:3], feeds)
    results["lockstep"] = dict(rec, ok=ok)
    with mock.patch.dict(registry._LOWERINGS,
                         grid_sampler=_grid_sampler_half_pixel):
        _, rec, passed = _lockstep(fluid, prog[:3], feeds[:1])
    results["control_grid_sampler_half_pixel_on_the_card"] = dict(
        rec, ok=not passed)
    failed = [k for k, r in results.items() if not r["ok"]]
    emit({"phase": "stn_digits_parity", "ok": not failed, "batch": batch,
          "steps": STN_PARITY_STEPS, "results": results,
          "phase_seconds": time.perf_counter() - t0})
    if failed:
        raise AssertionError("stn_digits: %s failed" % failed)
    return launched


def _hsigmoid_codes_inverted(ctx, inputs, attrs):
    """hierarchical_sigmoid on the card with every path code inverted (a
    control). CPU tensors take the real lowering."""
    import torch
    from paddle_tpu_torch.fluid.ops import misc_nn_ops
    x = inputs["X"][0]
    if x.is_cuda and inputs.get("PathTable") is None:
        _, path, code = misc_nn_ops._binary_tree_paths(
            attrs.get("num_classes", 2))
        inputs = dict(inputs, PathTable=[torch.tensor(path, device="cuda")],
                      PathCode=[1 - torch.tensor(code, device="cuda")])
    return misc_nn_ops._hierarchical_sigmoid(ctx, inputs, attrs)


def _grads_twice(fluid, prog, feed, names, runs=2):
    """`runs` steps of `prog` on the card from one state (the card's
    startup), fetching `names`: (readings, equal and nonzero)."""
    exe, scope = fluid.Executor(), fluid.Scope()
    exe.run(prog.startup, scope=scope)
    state = {n: scope.get(n).clone() for n in scope._vars
             if scope.get(n) is not None}
    got = []
    for _ in range(runs):
        run = fluid.Scope()
        for n, t in state.items():
            run.set(n, t.clone())
        got.append(exe.run(prog.main, feed=feed, fetch_list=names,
                           scope=run, return_numpy=False))
        del run
    equal = all(bool((a == b).all()) for r in got[1:]
                for a, b in zip(got[0], r))
    nonzero = all(bool((a != 0).any()) for a in got[0])
    return {"gradients": names, "runs": runs,
            "shapes": [list(a.shape) for a in got[0]],
            "bit_for_bit": equal, "nonzero": nonzero}, equal and nonzero


def phase_word2vec_hsigmoid(fluid, counters):
    """The book's word2vec with hsigmoid: a _window (no port kernel), the
    lockstep, the W and bias gradients twice and the control. Returns the
    window's launches."""
    from unittest import mock
    from paddle_tpu_torch.fluid.ops import registry
    tool = _load_tool("torch_nn_programs")
    t0 = time.perf_counter()
    prog = tool.word2vec_hsigmoid(fluid, seed=SEED)
    batch = tool.W2V["batch"]
    stacked = _stack_feeds([tool.w2v_batch(SEED + k, batch,
                                           tool.W2V["dict_size"])
                            for k in range(W2V_HS_STEPS + 1)])
    launched = _window(
        "word2vec_hsigmoid", fluid, counters, prog[:3],
        {k: v[:1] for k, v in stacked.items()},
        {k: v[1:] for k, v in stacked.items()}, W2V_HS_STEPS,
        dict.fromkeys(counters, 0), None,
        {"batch": batch, "widths": tool.W2V,
         "ops": len(prog.main.global_block().ops),
         "build_seconds": time.perf_counter() - t0}, {"examples": batch})
    t0 = time.perf_counter()
    feeds = [tool.w2v_batch(SEED + 100 + k, batch, tool.W2V["dict_size"])
             for k in range(W2V_HS_PARITY_STEPS)]
    results = {}
    _, rec, ok = _lockstep(fluid, prog[:3], feeds)
    results["lockstep"] = dict(rec, ok=ok)
    with mock.patch.dict(registry._LOWERINGS,
                         hierarchical_sigmoid=_hsigmoid_codes_inverted):
        _, rec, passed = _lockstep(fluid, prog[:3], feeds[:1])
    results["control_path_codes_inverted_on_the_card"] = dict(
        rec, ok=not passed)
    rec, ok = _grads_twice(fluid, prog, feeds[0], ["hs.w@GRAD", "hs.b@GRAD"])
    results["hsigmoid_gradients_twice"] = dict(rec, ok=ok)
    failed = [k for k, r in results.items() if not r["ok"]]
    emit({"phase": "word2vec_hsigmoid_parity", "ok": not failed,
          "steps": W2V_HS_PARITY_STEPS, "results": results,
          "phase_seconds": time.perf_counter() - t0})
    if failed:
        raise AssertionError("word2vec_hsigmoid: %s failed" % failed)
    return launched


def _resize_without_antialias(ctx, inputs, attrs):
    """bilinear_interp on the card without antialiasing (a control). CPU
    tensors take the real lowering."""
    import torch.nn.functional as F
    from paddle_tpu_torch.fluid.ops import nn_ops
    x = inputs["X"][0]
    if not x.is_cuda:
        return nn_ops._bilinear_interp(ctx, inputs, attrs)
    return {"Out": [F.interpolate(x, (attrs["out_h"], attrs["out_w"]),
                                  mode="bilinear", align_corners=False)]}


def _drawing_heads_check(tool):
    """sample_logits and the uniform sampled softmax at nn_chain's widths
    on the card: the samples in range, the labels first, q by its formula,
    the accidental hits at -1e20, the draws log-uniform (sample_logits) and
    uniform (sampled softmax, whose loss at zero logits is log(the columns
    left)), chi-square p > 1e-4 on SAMPLE_CHI_DRAWS draws; each call's ms.
    Returns (readings, ok)."""
    import math
    import numpy as np
    import torch
    from paddle_tpu_torch.fluid.ops import misc_nn_ops, registry
    w = tool.CHAIN
    n, v, s = w["sm_rows"], w["vocab"], w["samples"]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    logits = torch.randn(n, v, generator=gen, device="cuda")
    labels = torch.randint(0, v, (n, 1), generator=gen, device="cuda")
    ctx = registry.LoweringContext("cuda", torch.Generator(device="cuda"))
    ctx.generator.manual_seed(SEED + 1)
    out = misc_nn_ops._sample_logits(
        ctx, {"Logits": [logits], "Labels": [labels]},
        {"num_samples": s, "remove_accidental_hits": True})
    samples, q = out["Samples"][0], out["Probabilities"][0]
    sl = out["SampledLogits"][0]
    want_q = torch.log((samples + 2.0) / (samples + 1.0)) / math.log(v + 1)
    hit = (samples[:, 1:] == labels).reshape(n, s)
    want = torch.gather(logits, 1, samples) - torch.log(q + 1e-20)
    drawn = samples[:, 1:].reshape(-1)[:SAMPLE_CHI_DRAWS].cpu().numpy()
    k = np.arange(v, dtype=np.float64)
    log_uniform = np.log((k + 2) / (k + 1)) / np.log(v + 1)
    rec = {"rows": n, "classes": v, "samples": s,
           "in_range": bool((samples >= 0).all() and (samples < v).all()),
           "labels_first": bool(torch.equal(samples[:, :1], labels)),
           "q_formula": bool(torch.equal(q, want_q)),
           "hits": int(hit.sum()),
           "hits_at_minus_1e20": bool((sl[:, 1:][hit] < -0.99e20).all()),
           "others_exact": bool(torch.equal(sl[:, 1:][~hit],
                                            want[:, 1:][~hit])),
           "log_uniform_p": _chi_square_p(drawn, log_uniform),
           "sample_logits_ms": time_ms(lambda: misc_nn_ops._sample_logits(
               ctx, {"Logits": [logits], "Labels": [labels]},
               {"num_samples": s}), iters=5, warmup=1)}
    zeros = torch.zeros(n, v, device="cuda")
    ctx.generator.manual_seed(SEED + 2)
    loss, = misc_nn_ops._sampled_softmax_ce(
        ctx, {"Logits": [zeros], "Labels": [labels]},
        {"num_samples": s, "remove_accidental_hits": True})["Loss"]
    replay = torch.Generator(device="cuda")
    replay.manual_seed(SEED + 2)
    drawn = torch.randint(0, v, (n, s), generator=replay, device="cuda")
    columns = 1 + s - (drawn == labels).sum(1, keepdim=True)
    rec.update(
        uniform_loss_rel_err=float(((loss - torch.log(columns.float())) /
                                    torch.log(columns.float())).abs().max()),
        uniform_p=_chi_square_p(
            drawn.reshape(-1)[:SAMPLE_CHI_DRAWS].cpu().numpy(),
            np.full(v, 1.0 / v)),
        sampled_softmax_ms=time_ms(lambda: misc_nn_ops._sampled_softmax_ce(
            ctx, {"Logits": [logits], "Labels": [labels]},
            {"num_samples": s}), iters=5, warmup=1))
    ok = rec["in_range"] and rec["labels_first"] and rec["q_formula"] and \
        rec["hits"] > 0 and rec["hits_at_minus_1e20"] and \
        rec["others_exact"] and rec["log_uniform_p"] > 1e-4 and \
        rec["uniform_p"] > 1e-4 and rec["uniform_loss_rel_err"] <= 1e-6
    return rec, ok


def _spectral_norm_check(tool):
    """spectral_norm's lowering SN_CALLS times on the card on DCGAN D's
    [512, 256, 4, 4] weight (N(0, 0.02)), one power-iteration step a call,
    U and V carried: sigma = u W v against float64 power iteration from the
    same U and V (within SN_ITER_REL_MAX) and against the largest singular
    value (at most it, within SN_GAP_MAX); ms a call. Returns (readings,
    ok)."""
    import numpy as np
    import torch
    from paddle_tpu_torch.fluid.ops import misc_nn_ops, registry
    shape = tool.CHAIN["sn_shape"]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 3)
    w = torch.randn(shape, generator=gen, device="cuda") * 0.02
    wm = w.reshape(shape[0], -1)
    u0 = torch.randn(shape[0], generator=gen, device="cuda")
    v0 = torch.randn(wm.shape[1], generator=gen, device="cuda")
    ctx = registry.LoweringContext("cuda")
    attrs = {"dim": 0, "power_iters": 1, "eps": 1e-12}
    u, v = u0, v0
    for _ in range(SN_CALLS):
        out = misc_nn_ops._spectral_norm(ctx, {"Weight": [w], "U": [u],
                                               "V": [v]}, attrs)
        u, v = out["UOut"][0], out["VOut"][0]
    sigma = float(w.norm() / out["Out"][0].norm())
    m = wm.double().cpu().numpy()
    u64, v64 = u0.double().cpu().numpy(), v0.double().cpu().numpy()
    for _ in range(SN_CALLS):
        v64 = m.T @ u64
        v64 /= np.linalg.norm(v64) + 1e-12
        u64 = m @ v64
        u64 /= np.linalg.norm(u64) + 1e-12
    sigma64 = float(u64 @ m @ v64)
    sigma_max = float(torch.linalg.matrix_norm(wm.double(), ord=2))
    rec = {"shape": list(shape), "calls": SN_CALLS, "sigma": sigma,
           "sigma_float64_iteration": sigma64, "sigma_max": sigma_max,
           "iteration_rel_err": abs(sigma - sigma64) / sigma64,
           "gap_to_sigma_max": 1 - sigma / sigma_max,
           "ms_a_call": time_ms(lambda: misc_nn_ops._spectral_norm(
               ctx, {"Weight": [w], "U": [u], "V": [v]}, attrs))}
    ok = rec["iteration_rel_err"] <= SN_ITER_REL_MAX and \
        -1e-6 <= rec["gap_to_sigma_max"] <= SN_GAP_MAX
    return rec, ok


def phase_nn_layers(fluid, counters):
    """nn_chain (tools/torch_nn_programs.py) on the card: the _window at its
    widths (one Adam launch a step) with its busy share, the lockstep of its
    deterministic parts and the control, the drawing heads' invariants and
    spectral_norm's sigma. Returns the window's launches."""
    import torch
    from unittest import mock
    from paddle_tpu_torch.fluid.ops import registry
    tool = _load_tool("torch_nn_programs")
    t0 = time.perf_counter()
    chain = tool.nn_chain(fluid, seed=SEED)
    block = chain.main.global_block()
    # the chain's inputs stand for other models' activations: made on the
    # card, in the program's dtypes, before the window (set-up)
    batch = {k: torch.from_numpy(v).to("cuda", getattr(
        torch, block.var(k).dtype)) for k, v in tool.chain_batch(SEED).items()}
    stacked = lambda steps: {k: v[None].expand(steps, *v.shape)
                             for k, v in batch.items()}

    def busy(scope, _extra):
        exe = fluid.Executor()
        wall, busy_ms, by_kind = _busy_share(lambda: exe.run(
            chain.main, feed=batch, fetch_list=[chain.loss], scope=scope))
        return {"profiled_wall_ms": wall, "device_busy_ms": busy_ms,
                "busy_share": busy_ms / wall,
                "device_ms_by_kind": by_kind}, True
    launched = _window(
        "nn_layers", fluid, counters, chain[:3], stacked(1),
        stacked(NN_STEPS), NN_STEPS,
        dict(dict.fromkeys(counters, 0), adam=1), NN_ADAM_TENSORS,
        {"widths": tool.CHAIN, "dtype": "float32", "parts": chain.parts,
         "ops": len(block.ops), "build_seconds": time.perf_counter() - t0},
        {"steps": 1}, check=([], busy))
    del batch
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    parts = tuple(p for p in tool.PARTS if p not in tool.RANDOM_PARTS)
    small = tool.nn_chain(fluid, seed=SEED, parts=parts, **NN_PARITY_WIDTHS)
    feeds = [tool.chain_batch(SEED + 100 + k, parts=parts,
                              **NN_PARITY_WIDTHS)
             for k in range(NN_PARITY_STEPS)]
    results = {}
    _, rec, ok = _lockstep(fluid, small[:3], feeds)
    results["lockstep"] = dict(rec, ok=ok)
    with mock.patch.dict(registry._LOWERINGS,
                         bilinear_interp=_resize_without_antialias):
        _, rec, passed = _lockstep(fluid, small[:3], feeds[:1])
    results["control_shrink_without_antialiasing_on_the_card"] = dict(
        rec, ok=not passed)
    rec, ok = _drawing_heads_check(tool)
    results["drawing_heads"] = dict(rec, ok=ok)
    rec, ok = _spectral_norm_check(tool)
    results["spectral_norm_sigma"] = dict(rec, ok=ok)
    failed = [k for k, r in results.items() if not r["ok"]]
    emit({"phase": "nn_layers_parity", "ok": not failed,
          "widths": NN_PARITY_WIDTHS, "parts": parts,
          "steps": NN_PARITY_STEPS, "results": results,
          "phase_seconds": time.perf_counter() - t0})
    if failed:
        raise AssertionError("nn_layers: %s failed" % failed)
    return launched


# Row sums (scatter_rows_, _merge_rows): ROW_SUM_RUNS calls of each route
# on the card on the same inputs must give equal bits, on ids with many
# repeats (a Zipf draw over DeepFM's 100,000-row tables, and a 2-row table
# such as BERT's token types), and equal the CPU's index_add_.
ROW_SUM_RUNS = 2
ROW_SUM_CASES = [(100000, 26 * 4096, 16, "float32", "zipf"),
                 (100000, 26 * 4096, 1, "float32", "zipf"),
                 (100000, 26 * 4096, 16, "bfloat16", "zipf"),
                 (2, 32768, 768, "bfloat16", "uniform"),
                 (2073, 400, 32, "float32", "uniform")]


# the NN lowerings' row sums: hsigmoid's W and Bias gradients (labels drawn
# Zipf over word2vec's 2073 classes, so the tree's top nodes repeat in every
# row), tree_conv's child sums and their gradient at nn_chain's widths, and
# the gradient of sampled softmax's picks along the rows of [16384, 8192]
# logits (add_along_rows_)
NN_ROW_SUM_HSIGMOID = (16384, 256, 2073)
NN_ROW_SUM_TREE = (64, 256, 128, 128)
NN_ROW_SUM_ALONG = (16384, 8192, 1025)


def _nn_row_sum_routes(gen):
    """Each NN route ROW_SUM_RUNS times on the card on the same inputs:
    equal bits every run; its ms a call and its largest difference from the
    CPU's result (the forward products round apart, so not 0). Returns
    (readings, ok)."""
    import numpy as np
    import torch
    from paddle_tpu_torch.fluid.ops import misc_nn_ops, registry
    tool = _load_tool("torch_nn_programs")
    b, f, k = NN_ROW_SUM_HSIGMOID
    p = torch.arange(1, k + 1, dtype=torch.float64) ** -1.1
    hs = {"X": torch.randn(b, f, generator=gen),
          "W": torch.randn(k - 1, f, generator=gen) * 0.1,
          "Label": torch.multinomial(p / p.sum(), b, replacement=True,
                                     generator=gen)[:, None],
          "Bias": torch.randn(k - 1, 1, generator=gen)}
    t, n, nf, out = NN_ROW_SUM_TREE
    tree = {"NodesVector": torch.randn(t, n, nf, generator=gen),
            "EdgeSet": torch.from_numpy(tool.tree_edges(
                t, n, np.random.RandomState(SEED))),
            "Filter": torch.randn(nf, 3, out, 1, generator=gen) * 0.1}
    rows, cols, picks = NN_ROW_SUM_ALONG
    along = {"dst": torch.zeros(rows, cols),
             "idx": torch.randint(0, cols, (rows, picks), generator=gen),
             "vals": torch.randn(rows, picks, generator=gen)}

    on = {}

    def inputs(ins, device):
        """ins on `device`, moved once."""
        key = (id(ins), device)
        if key not in on:
            on[key] = {s: v.to(device) for s, v in ins.items()}
        return on[key]

    def op_grads(op, ins, attrs, slot, wrt):
        def run(device):
            ctx = registry.LoweringContext(device)
            x = {s: [v.detach().requires_grad_(s in wrt)]
                 for s, v in inputs(ins, device).items()}
            y, = registry.get_lowering(op)(ctx, x, attrs)[slot]
            g = torch.ones_like(y) / y.numel()
            return torch.autograd.grad(y, [x[s][0] for s in wrt], g)
        return run

    def along_rows(device):
        a = inputs(along, device)
        return [misc_nn_ops.add_along_rows_(a["dst"].clone(), a["idx"],
                                            a["vals"])]
    routes = {
        "hsigmoid_w_and_bias_grads": op_grads(
            "hierarchical_sigmoid", hs, {"num_classes": k}, "Out",
            ["W", "Bias"]),
        "tree_conv_child_sums_and_grads": op_grads(
            "tree_conv", tree, {"max_depth": 2}, "Out",
            ["NodesVector", "Filter"]),
        "sampled_softmax_grad_along_rows": along_rows}
    recs, ok = {}, True
    for name, run in routes.items():
        cpu = run("cpu")
        outs = [run("cuda") for _ in range(ROW_SUM_RUNS)]
        same = all(torch.equal(a, b) for o in outs[1:]
                   for a, b in zip(outs[0], o))
        recs[name] = {
            "runs_bit_for_bit": same,
            "max_rel_diff_to_cpu": max(
                float((a.cpu().double() - c.double()).abs().max() /
                      (c.double().abs().max() or 1.0))
                for a, c in zip(outs[0], cpu)),
            "ms": time_ms(lambda: run("cuda"), iters=3, warmup=1)}
        ok = ok and same
    del on
    return recs, ok


def phase_row_sums():
    """scatter_rows_ (into zeros and into a table, as sparse SGD adds)
    and _merge_rows on each ROW_SUM_CASES case, ROW_SUM_RUNS times on the
    card: equal bits every time, and the CPU's values; negative and
    out-of-range ids among them. Each route's device ms a call, and
    index_add_'s into zeros (the route scatter_rows_ took before)."""
    import numpy as np
    import torch
    from paddle_tpu_torch.fluid.ops import optimizer_ops, tensor_ops
    t_start = time.perf_counter()
    gen = torch.Generator().manual_seed(SEED)
    cases, ok = [], True
    for vocab, n, width, dtype, draw in ROW_SUM_CASES:
        dt = getattr(torch, dtype)
        if draw == "zipf":
            p = torch.arange(1, vocab + 1, dtype=torch.float64) ** -1.1
            ids = torch.multinomial(p / p.sum(), n, replacement=True,
                                    generator=gen)
        else:
            ids = torch.randint(0, vocab, (n,), generator=gen)
        ids[:16] = torch.tensor([-1, -vocab, vocab, vocab + 3] * 4)
        vals = torch.randn(n, width, generator=gen).to(dt)
        table = torch.randn(vocab, width, generator=gen).to(dt)
        routes = {
            "scatter_zeros": lambda d, i, v: tensor_ops.scatter_rows_(
                torch.zeros_like(d), i, v),
            "scatter_table": lambda d, i, v: tensor_ops.scatter_rows_(
                d.clone(), i, v),
            "merge_rows": lambda d, i, v: torch.cat([
                x.double().reshape(-1) for x in
                optimizer_ops._merge_rows(i, v, d.shape[0])])}
        rec = {"vocab": vocab, "ids": n, "width": width, "dtype": dtype,
               "draw": draw, "most_repeats": int(torch.bincount(
                   ids.clamp(0, vocab - 1)).max())}
        for route, fn in routes.items():
            cpu = fn(table, ids, vals)
            card_in = (table.cuda(), ids.cuda(), vals.cuda())
            outs = [fn(*card_in) for _ in range(ROW_SUM_RUNS)]
            same = all(torch.equal(o, outs[0]) for o in outs[1:])
            equal_cpu = torch.equal(outs[0].cpu(), cpu)
            rec[route] = {"runs_bit_for_bit": same,
                          "equals_cpu_index_add": equal_cpu,
                          "ms": time_ms(lambda: fn(*card_in), iters=5,
                                        warmup=1)}
            ok = ok and same and equal_cpu
        # the route it replaces: index_add_ (atomics) into zeros
        rows, adds = tensor_ops._row_adds(table, ids, vals)
        rows, adds = rows.cuda(), adds.cuda()
        zeros = torch.zeros(table.shape, dtype=dt, device="cuda")
        rec["index_add_ms"] = time_ms(
            lambda: zeros.clone().index_add_(0, rows, adds), iters=5,
            warmup=1)
        cases.append(rec)
    nn_routes, nn_ok = _nn_row_sum_routes(gen)
    ok = ok and nn_ok
    emit({"phase": "row_sums", "ok": ok, "runs": ROW_SUM_RUNS,
          "cases": cases, "nn_routes": nn_routes,
          "phase_seconds": time.perf_counter() - t_start})
    if not ok:
        raise AssertionError("row sums differ from run to run or from the "
                             "CPU")


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
# run B's losses must equal run A's; the control must miss them by more
# than this
CKPT_CONTROL_REL_MIN = 1e-5


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
    equal to A's bit for bit (the embedding gradients' row sums give the
    same bits in every run: phase_row_sums). Control: a resume without
    the generator states, whose dropout masks differ, must miss A's
    losses by more than CKPT_CONTROL_REL_MIN. Returns the phase's
    launches."""
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
    losses_equal = bool((run_b == run_a).all())
    ok = state_equal and gens_equal and meta.get("step") == CKPT_STEPS and \
        losses_equal and rel_c > CKPT_CONTROL_REL_MIN and \
        devices == [str(exe.device)]
    emit({"phase": "checkpoint", "ok": ok, "batch": CKPT_BATCH,
          "seq_len": cfg["seq_len"], "dropout_rate": cfg["dropout_rate"],
          "persistables": len(names), "generators": len(gens),
          "checkpoint_bytes": nbytes, "save_seconds": save_ms / 1e3,
          "load_seconds": load_ms / 1e3, "state_bit_for_bit": state_equal,
          "generators_bit_for_bit": gens_equal, "loaded_on": devices,
          "losses_a": run_a.tolist(), "losses_b": run_b.tolist(),
          "loss_rel_err": rel_b, "losses_bit_for_bit": losses_equal,
          "control": {"fault": "resume without the generator states",
                      "losses": run_c.tolist(), "loss_rel_err": rel_c,
                      "rel_err_min": CKPT_CONTROL_REL_MIN},
          "launches": launched})
    if not ok:
        raise AssertionError("checkpoint failed: state %s, generators %s, "
                             "loss rel %g, control %g, devices %s"
                             % (state_equal, gens_equal, rel_b, rel_c,
                                devices))
    del exe, scope, resumed, control, saved
    torch.cuda.empty_cache()
    return launched


# ---- control flow and tensor arrays (tools/torch_control_flow_programs.py)

# rnn_encoder_decoder: the book's model at the WMT-14 seq2seq's widths
# (ENC_DEC: dictionary 30,000, embedding and hidden 512, T 32, batch 64,
# f32, Adam(5e-3)): one warm step and ENC_DEC_STEPS through run_steps, one
# Adam launch a step over the 6 parameters the gate takes (the two
# [30000, 512] tables and the four [512, 512] step weights:
# ENC_DEC_ADAM_CASES); the trained model saved by save_inference_model,
# loaded and served a batch of ENC_DEC_SERVE_BATCH on the card and on the
# CPU from the same artifact (logits within SERVE_REL_MAX of the largest);
# ENC_DEC_PARITY_STEPS lockstep steps at the book test's widths. Control:
# the card's recurrent ops run their steps in reverse order.
ENC_DEC_STEPS = 4
ENC_DEC_PARITY_STEPS = 30
ENC_DEC_SERVE_BATCH = 8
ENC_DEC_ADAM_CASES = [((30000, 512), "float32", 2),
                      ((512, 512), "float32", 4)]
ENC_DEC_ADAM_TENSORS = sum(n for _, _, n in ENC_DEC_ADAM_CASES)
SERVE_REL_MAX = 1e-4
# while_loop: benchmark/predictor_bench.py's While model (8 trips, fc 32,
# batch 4) saved without aot_example_inputs and served WHILE_REQUESTS
# times from the artifact (ms and host syncs a request; the CPU serves the
# same artifact); trained at WHILE_TRAIN (width 1,024, batch 256, SGD)
# through while_grad with the inferred bound: a window of WHILE_STEPS and
# WHILE_PARITY_STEPS lockstep steps; the dropout body at WHILE_TRAIN's
# widths keeps one mask on every trip. Control: max_trip_count two below
# the trips, where every parameter's gradient on the card must be NaN.
WHILE_REQUESTS = 20
WHILE_STEPS = 4
WHILE_PARITY_STEPS = 3
# switch_ifelse: the three Switch programs at BRANCHY (width 1,024, batch
# 256) one lockstep step each (the gradients of x and w with them), the
# untaken case's x gradient exactly 0; the IfElse regressor a window of
# BRANCHY_STEPS and BRANCHY_PARITY_STEPS lockstep steps. Control: the
# untaken branch given a gradient on the card.
BRANCHY_STEPS = 8
BRANCHY_PARITY_STEPS = 3
# tensor_arrays: every array op at BERT-base's widths (ARRAYS: [256, 128,
# 768] bf16, lengths 1-128), inputs made on the card first, ARRAY_RUNS
# runs timed; every output the card makes equals the CPU's bit for bit.
# Control: shrink_memory keeping the rows whose length equals the step.
ARRAY_RUNS = 5


def _cf_tool():
    return _load_tool("torch_control_flow_programs")


def _recurrent_reversed(ctx, inputs, attrs):
    """recurrent on the card with its steps in the other order (a
    control). CPU tensors take the real lowering."""
    from paddle_tpu_torch.fluid.ops import rnn_ops
    if ctx.device.type == "cuda":
        attrs = dict(attrs, reverse=not attrs.get("reverse", False))
    return rnn_ops._recurrent(ctx, inputs, attrs)


def _untaken_branch_given_a_gradient(ctx, inputs, attrs):
    """conditional_block_grad on the card replaying its block whatever
    its predicate (a control). CPU tensors take the real lowering."""
    from paddle_tpu_torch.fluid.ops import control_ops
    if ctx.device.type == "cuda":
        inputs = dict(inputs, Cond=[])
    return control_ops._conditional_block_grad(ctx, inputs, attrs)


def _shrink_keeps_the_step(ctx, inputs, attrs):
    """shrink_rnn_memory on the card keeping the rows whose length equals
    the step (an off-by-one; a control). CPU tensors take the real
    lowering."""
    from paddle_tpu_torch.fluid.ops import array_ops
    x = inputs["X"][0]
    if not x.is_cuda:
        return array_ops._shrink_rnn_memory(ctx, inputs, attrs)
    rt = inputs["RankTable"][0]
    step = inputs["I"][0].reshape(-1)[0].to(rt.lengths.dtype)
    alive = rt.lengths[rt.order.long()] >= step
    return {"Out": [x * alive.reshape((-1,) + (1,) * (x.dim() - 1))
                    .to(x.dtype)]}


def _sync_places(run):
    """(the result of run(), the places ("file:line") where it waits for
    the card, as torch.cuda.set_sync_debug_mode("warn") reports them)."""
    import warnings
    import torch
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = run()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, ["%s:%d" % (os.path.relpath(w.filename), w.lineno)
                 for w in caught if "synchroniz" in str(w.message)]


def _serve_artifact(fluid, model, scope, feed, name, requests=1):
    """`model` saved from `scope` by save_inference_model (no AOT export),
    loaded on the card and on the CPU, `feed` served: (card output, CPU
    output, ms a request on the card over `requests`, the places a
    request waits for the card, artifact bytes)."""
    import shutil
    import torch
    root = os.path.join(IO_DIR, name)
    shutil.rmtree(root, ignore_errors=True)
    exe = fluid.Executor()
    with fluid.scope_guard(scope):
        fluid.io.save_inference_model(root, model.feeds, [model.out], exe,
                                      main_program=model.main)
    size = _artifact_bytes(root)
    outs = {}
    for place, ex in (("cuda", exe), ("cpu",
                                      fluid.Executor(fluid.CPUPlace()))):
        served = fluid.Scope()
        with fluid.scope_guard(served):
            prog, _, _ = fluid.io.load_inference_model(root, ex)
        outs[place] = (ex, prog, served)
    ex, prog, served = outs["cuda"]
    card = ex.run(prog, feed=feed, scope=served)[0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(requests):
        ex.run(prog, feed=feed, scope=served, return_numpy=False)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / requests
    _, syncs = _sync_places(lambda: ex.run(prog, feed=feed, scope=served,
                                           return_numpy=False))
    ex, prog, served = outs["cpu"]
    cpu = ex.run(prog, feed=feed, scope=served)[0]
    shutil.rmtree(root, ignore_errors=True)
    return card, cpu, ms, syncs, size


def _step_busy(fluid, model, feed, by_name=None):
    """Startup and one warm step on the card, then _busy_share of a step
    through Executor.run: (wall ms, busy ms, by kind)."""
    exe, scope = fluid.Executor(), fluid.Scope()
    exe.run(model.startup, scope=scope)
    fetch = [model.loss] if model.loss is not None else [model.out]
    exe.run(model.main, feed=feed, fetch_list=fetch, scope=scope)
    return _busy_share(lambda: exe.run(model.main, feed=feed,
                                       fetch_list=fetch, scope=scope,
                                       return_numpy=False), by_name=by_name)


def _step_syncs(fluid, model, stacked):
    """The places where a training step of `model` through run_steps
    (after the startup and one step) waits for the card (_host_syncs), by
    place: {"count": n, "places": {place: times}}."""
    import collections
    exe, scope = fluid.Executor(), fluid.Scope()
    exe.run(model.startup, scope=scope)
    one = {k: v[:1] for k, v in stacked.items()}
    exe.run_steps(model.main, feed=one, n_steps=1, fetch_list=[model.loss],
                  scope=scope)
    places = _host_syncs(fluid, model.main, one, model.loss, scope)
    return {"count": len(places),
            "places": dict(collections.Counter(places))}


def _busy_rec(wall, busy, by_kind):
    return {"profiled_wall_ms": wall, "device_busy_ms": busy,
            "busy_share": busy / wall, "device_ms_by_kind": by_kind}


def phase_rnn_encoder_decoder(fluid, counters):
    """The book's RNN encoder-decoder at ENC_DEC: a _window, its busy
    share, the trained model served from its artifact on the card and the
    CPU, the lockstep at the book test's widths and its control. Returns
    the window's launches."""
    import numpy as np
    from unittest import mock
    from paddle_tpu_torch.fluid.ops import registry
    tool = _cf_tool()
    t0 = time.perf_counter()
    w = tool.ENC_DEC
    m = tool.rnn_encoder_decoder(fluid, seed=SEED)
    block = m.main.global_block()
    stacked = _stack_feeds([tool.enc_dec_batch(SEED + k)
                            for k in range(ENC_DEC_STEPS + 1)])
    launched = _window(
        "rnn_encoder_decoder", fluid, counters, m[:3],
        {k: v[:1] for k, v in stacked.items()},
        {k: v[1:] for k, v in stacked.items()}, ENC_DEC_STEPS,
        dict(dict.fromkeys(counters, 0), adam=1), ENC_DEC_ADAM_TENSORS,
        {"widths": w, "ops": len(block.ops),
         "step_ops": len(m.main.block(1).ops),
         "adam_parameters": sum(op.type == "adam" for op in block.ops),
         "build_seconds": time.perf_counter() - t0},
        {"tokens": w["batch"] * w["seq"]})
    t0 = time.perf_counter()
    one = tool.enc_dec_batch(SEED + 50)
    results = {"busy": _busy_rec(*_step_busy(fluid, m, one)),
               "step_host_syncs": _step_syncs(fluid, m, stacked)}
    exe, scope = fluid.Executor(), fluid.Scope()
    exe.run(m.startup, scope=scope)
    exe.run_steps(m.main, feed={k: v[:2] for k, v in stacked.items()},
                  n_steps=2, fetch_list=[m.loss], scope=scope)
    feed = {k: one[k][:ENC_DEC_SERVE_BATCH] for k in m.feeds}
    card, cpu, ms, syncs, size = _serve_artifact(
        fluid, m, scope, feed, "rnn_encoder_decoder")
    rel = _rel_max(card, cpu)
    results["serve"] = {
        "batch": ENC_DEC_SERVE_BATCH, "shape": list(card.shape),
        "ms_a_request": ms, "host_syncs_a_request": len(syncs),
        "host_sync_places": syncs, "artifact_bytes": size,
        "rel_max_card_vs_cpu": rel,
        "limit": SERVE_REL_MAX,
        "ok": card.shape == (ENC_DEC_SERVE_BATCH, w["seq"], w["vocab"]) and
        bool(np.isfinite(card).all()) and rel <= SERVE_REL_MAX}
    del exe, scope
    narrow = tool.rnn_encoder_decoder(fluid, seed=SEED,
                                      **tool.ENC_DEC_NARROW)
    feeds = [tool.enc_dec_batch(SEED + 100, **tool.ENC_DEC_NARROW)] * \
        ENC_DEC_PARITY_STEPS
    _, rec, ok = _lockstep(fluid, narrow[:3], feeds)
    results["lockstep"] = dict(rec, ok=ok)
    with mock.patch.dict(registry._LOWERINGS, recurrent=_recurrent_reversed):
        _, rec, passed = _lockstep(fluid, narrow[:3], feeds[:1])
    results["control_steps_reversed_on_the_card"] = dict(rec, ok=not passed)
    failed = [k for k, r in results.items() if not r.get("ok", True)]
    emit({"phase": "rnn_encoder_decoder_parity", "ok": not failed,
          "parity_steps": ENC_DEC_PARITY_STEPS,
          "parity_widths": tool.ENC_DEC_NARROW, "results": results,
          "phase_seconds": time.perf_counter() - t0})
    if failed:
        raise AssertionError("rnn_encoder_decoder: %s failed" % failed)
    return launched


def phase_while_loop(fluid, counters):
    """predictor_bench.py's While model served from its artifact, trained
    at WHILE_TRAIN (a _window, its busy share, the lockstep), the control
    bound and the dropout body. Returns the window's launches."""
    import numpy as np
    import torch
    tool = _cf_tool()
    t0 = time.perf_counter()
    results = {}
    serve = tool.while_loop(fluid, seed=SEED)
    exe, scope = fluid.Executor(), fluid.Scope()
    exe.run(serve.startup, scope=scope)
    feed = {"x": tool.while_batch(SEED)["x"]}
    card, cpu, ms, syncs, size = _serve_artifact(
        fluid, serve, scope, feed, "while_loop", WHILE_REQUESTS)
    rel = _rel_max(card, cpu)
    results["serve"] = {
        "widths": tool.WHILE_SERVE, "ms_a_request": ms,
        "host_syncs_a_request": len(syncs), "host_sync_places": syncs,
        "artifact_bytes": size,
        "rel_max_card_vs_cpu": rel, "limit": SERVE_REL_MAX,
        "ok": card.shape == (tool.WHILE_SERVE["batch"],
                             tool.WHILE_SERVE["width"]) and
        rel <= SERVE_REL_MAX}
    del exe, scope
    w = tool.WHILE_TRAIN
    m = tool.while_loop(fluid, seed=SEED, train=True, **w)
    stacked = _stack_feeds([tool.while_batch(SEED + k, **w)
                            for k in range(WHILE_STEPS + 1)])
    launched = _window(
        "while_loop", fluid, counters, m[:3],
        {k: v[:1] for k, v in stacked.items()},
        {k: v[1:] for k, v in stacked.items()}, WHILE_STEPS,
        dict.fromkeys(counters, 0), None,
        {"widths": w, "ops": [len(b.ops) for b in m.main.blocks],
         "build_seconds": time.perf_counter() - t0},
        {"examples": w["batch"]})
    t1 = time.perf_counter()
    one = tool.while_batch(SEED + 50, **w)
    results["busy"] = _busy_rec(*_step_busy(fluid, m, one))
    results["step_host_syncs"] = _step_syncs(fluid, m, stacked)
    feeds = [tool.while_batch(SEED + 100 + k, **w)
             for k in range(WHILE_PARITY_STEPS)]
    _, rec, ok = _lockstep(fluid, m[:3], feeds)
    results["lockstep"] = dict(rec, ok=ok)
    bounded = tool.while_loop(fluid, seed=SEED, train=True,
                              max_trip_count=w["trips"] - 2, **w)
    exe, scope = fluid.Executor(), fluid.Scope()
    exe.run(bounded.startup, scope=scope)
    grads = [p.name + "@GRAD" for p in bounded.main.all_parameters()]
    got = exe.run(bounded.main, feed=one, fetch_list=[bounded.loss] + grads,
                  scope=scope)
    nan = [bool(np.isnan(g).all()) for g in got[1:]]
    results["control_bound_two_below_the_trips"] = {
        "max_trip_count": w["trips"] - 2, "trips": w["trips"],
        "gradients": grads, "all_nan": nan,
        "ok": len(nan) == 4 and all(nan) and bool(np.isfinite(got[0]))}
    drop = tool.while_dropout(fluid, **w)
    exe.run(drop.startup, scope=scope)
    acc, = exe.run(drop.main, fetch_list=[drop.out], scope=scope,
                   return_numpy=False)
    values = torch.unique(acc).cpu().tolist()
    kept = float((acc != 0).float().mean())
    results["dropout_body_one_mask_every_trip"] = {
        "values": values, "kept_share": kept,
        "ok": values == [0.0, float(w["trips"])] and 0.45 < kept < 0.55}
    del exe, scope
    torch.cuda.empty_cache()
    failed = [k for k, r in results.items() if not r.get("ok", True)]
    emit({"phase": "while_loop_parity", "ok": not failed,
          "parity_steps": WHILE_PARITY_STEPS, "results": results,
          "phase_seconds": time.perf_counter() - t1})
    if failed:
        raise AssertionError("while_loop: %s failed" % failed)
    return launched


def _grads_lockstep(fluid, m, feed, fetch):
    """One run of `m` fetching `fetch`, card against CPU from the CPU's
    startup state: every op of the card's plan replayed on the card from
    the CPU's values (_replay_on_card) within RESNET_OP_TOL, and each value
    the card's whole run fetches within OPT_LOSS_REL_MAX of the CPU's
    largest. Returns (readings, ok, the card's values by name)."""
    block = m.main.global_block()
    scope = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(m.startup, scope=scope)
    state = {n: scope.get(n) for n, v in block.vars.items()
             if v.persistable and scope.get(n) is not None}
    vals, after = _cpu_step(fluid, m.main, state, feed,
                            sorted(set(_step_names(m.main)) | set(fetch)))
    card_scope = fluid.Scope()
    for n, t in state.items():
        card_scope.set(n, t.to("cuda", copy=True))
    card = dict(zip(fetch, fluid.Executor().run(
        m.main, feed=feed, fetch_list=fetch, scope=card_scope)))
    errs = _replay_on_card(fluid, m.main, fetch, state, feed, vals, after)
    ok, worst = _op_verdict(errs)
    whole = {n: _rel_max(card[n], fluid.executor.as_numpy(vals[n]))
             for n in fetch}
    ok = ok and max(whole.values()) <= OPT_LOSS_REL_MAX
    return {"worst_op": worst, "ops": len(errs), "fetched_rel_max": whole,
            "limit": OPT_LOSS_REL_MAX}, ok, card


def phase_switch_ifelse(fluid, counters):
    """The Switch programs (one lockstep run each with the gradients of x
    and w; the untaken case's exactly 0, and its control) and the IfElse
    regressor (a _window, its busy share, the lockstep) at BRANCHY.
    Returns the window's launches."""
    from unittest import mock
    from paddle_tpu_torch.fluid.ops import registry
    tool = _cf_tool()
    t0 = time.perf_counter()
    w = tool.BRANCHY
    results = {}
    feed = {"x": tool.branchy_batch(SEED + 100, **w)["x"]}
    for case in tool.SWITCH_CASES:
        m = tool.switch(fluid, case, **w)
        fetch = [m.loss.name, "x@GRAD", "w@GRAD"]
        rec, ok, card = _grads_lockstep(fluid, m, feed, fetch)
        if case == "untaken":
            zero = not card["x@GRAD"].any() and not card["w@GRAD"].any()
            rec["grads_zero"] = zero
            ok = ok and zero
            with mock.patch.dict(
                    registry._LOWERINGS,
                    conditional_block_grad=_untaken_branch_given_a_gradient):
                control, _, card = _grads_lockstep(fluid, m, feed, fetch)
            control["grads_zero"] = not card["x@GRAD"].any() and \
                not card["w@GRAD"].any()
            results["control_untaken_branch_given_a_gradient"] = dict(
                control, ok=not control["grads_zero"])
        results["switch_" + case] = dict(rec, ok=ok)
    m = tool.ifelse(fluid, **w)
    stacked = _stack_feeds([tool.branchy_batch(SEED + k, **w)
                            for k in range(BRANCHY_STEPS + 1)])
    launched = _window(
        "switch_ifelse", fluid, counters, m[:3],
        {k: v[:1] for k, v in stacked.items()},
        {k: v[1:] for k, v in stacked.items()}, BRANCHY_STEPS,
        dict.fromkeys(counters, 0), None,
        {"program": "ifelse", "widths": w,
         "ops": len(m.main.global_block().ops)}, {"examples": w["batch"]})
    results["ifelse_busy"] = _busy_rec(*_step_busy(
        fluid, m, tool.branchy_batch(SEED + 50, **w)))
    feeds = [tool.branchy_batch(SEED + 200 + k, **w)
             for k in range(BRANCHY_PARITY_STEPS)]
    _, rec, ok = _lockstep(fluid, m[:3], feeds)
    results["ifelse_lockstep"] = dict(rec, ok=ok)
    failed = [k for k, r in results.items() if not r.get("ok", True)]
    emit({"phase": "switch_ifelse_parity", "ok": not failed,
          "results": results, "phase_seconds": time.perf_counter() - t0})
    if failed:
        raise AssertionError("switch_ifelse: %s failed" % failed)
    return launched


def _arrays_run(fluid, m, feed, device):
    """A run of the tensor_arrays program on `device`'s executor from
    `feed`: run() -> {output name: tensor}."""
    exe = fluid.Executor() if device == "cuda" else \
        fluid.Executor(fluid.CPUPlace())
    names = list(m.out)
    fetch = [m.out[n] for n in names]

    def run():
        return dict(zip(names, exe.run(
            m.main, feed=feed, fetch_list=fetch, return_numpy=False,
            scope=fluid.Scope())))
    return run


def phase_tensor_arrays(fluid, counters):
    """Every array op at ARRAYS on the card against the CPU, bit for bit,
    inputs made on the card first; its control. No port kernel may
    launch."""
    import torch
    from unittest import mock
    from paddle_tpu_torch.fluid.ops import registry
    tool = _cf_tool()
    t0 = time.perf_counter()
    w = tool.ARRAYS
    m = tool.tensor_arrays(fluid)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    feed = {"hidden": torch.randn(w["batch"], w["seq"], w["hidden"],
                                  generator=gen, device="cuda")
            .to(torch.bfloat16),
            "lens": torch.randint(1, w["seq"] + 1, (w["batch"], 1),
                                  generator=gen, device="cuda",
                                  dtype=torch.int32),
            "mask": torch.rand(w["batch"], 1, generator=gen,
                               device="cuda") < 0.5}
    # a row of length `step`, where the control's off-by-one shows
    feed["lens"][0] = w["step"]
    card_run = _arrays_run(fluid, m, feed, "cuda")
    card_run()
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero(counters)
    t1 = time.perf_counter()
    for _ in range(ARRAY_RUNS):
        card = card_run()
    torch.cuda.synchronize()
    run_ms = (time.perf_counter() - t1) * 1e3 / ARRAY_RUNS
    launched = _read(counters)
    peak = torch.cuda.max_memory_allocated()
    cpu = _arrays_run(fluid, m, {k: v.cpu() for k, v in feed.items()},
                      "cpu")()
    unequal = [n for n in card if not torch.equal(card[n].cpu(), cpu[n])]
    busy = _busy_rec(*_busy_share(card_run))
    with mock.patch.dict(registry._LOWERINGS,
                         shrink_rnn_memory=_shrink_keeps_the_step):
        control = card_run()
    control_unequal = [n for n in control
                       if not torch.equal(control[n].cpu(), cpu[n])]
    ok = not unequal and not any(launched.values()) and \
        control_unequal == ["shrunk"]
    rec = {"phase": "tensor_arrays", "ok": ok, "widths": w,
           "ops": len(m.main.global_block().ops),
           "outputs": {n: [list(v.shape), str(v.dtype)[6:]]
                       for n, v in card.items()},
           "runs": ARRAY_RUNS, "run_ms": run_ms, "peak_memory_bytes": peak,
           "launches": launched, "unequal_to_cpu": unequal,
           "control_shrink_keeps_the_step_on_the_card": {
               "unequal_to_cpu": control_unequal,
               "ok": control_unequal == ["shrunk"]},
           "phase_seconds": time.perf_counter() - t0}
    rec.update(busy)
    emit(rec)
    if not ok:
        raise AssertionError("tensor_arrays failed: %s" % rec)
    return launched


def control_flow_phases(fluid, counters, add):
    """The control-flow slice's phases, each with its launches added."""
    with fluid.unique_name.guard():
        add(phase_rnn_encoder_decoder(fluid, counters))
    add(phase_while_loop(fluid, counters))
    add(phase_switch_ifelse(fluid, counters))
    add(phase_tensor_arrays(fluid, counters))


# ---- ragged sequences (tools/torch_sequence_programs.py) ------------------

# understand_sentiment_conv: the book's convolution_net at SENTIMENT
# (dictionary 5,148, embedding 128, 512 filters, batch 128; IMDB-shaped
# reviews padded to T 1,024 or 2,048): one warm step, then SENT_STEPS
# steps through Executor.run, each batch its own T (_ragged_window; no port
# kernel launches: Adagrad); busy share of a step; the trained model saved
# (feeds words, words@LEN) and served a batch of SENT_SERVE_BATCH on the
# card and the CPU; the pad ids rewritten (one step from one state on each
# feed: loss and every persistable within RESNET_OP_TOL); SENT_PARITY_STEPS
# lockstep steps at SENT_PARITY (batch 16, reviews cut to 256 tokens).
# Controls: every length set to T, every length shortened by one.
SENT_STEPS = 4
SENT_PARITY_STEPS = 3
SENT_PARITY = dict(batch=16, cut=(10, 256))
SENT_SERVE_BATCH = 8
# understand_sentiment_dyn_rnn: the book's DynamicRNN LSTM at SENTIMENT (a
# recurrent op over every padded step): one warm step and DYN_RNN_STEPS;
# each row's last state bit for bit the hidden state at its length - 1;
# DYN_RNN_PARITY_STEPS lockstep steps at DYN_RNN_PARITY (batch 8, reviews
# cut to 60 tokens).
DYN_RNN_STEPS = 2
DYN_RNN_PARITY_STEPS = 2
DYN_RNN_PARITY = dict(batch=8, cut=(10, 60))
# the busy share of a dyn_rnn step is traced on a batch of 128 reviews cut
# to 256 tokens (T 256): a trace of a step at T 2,048 holds some 150,000
# kernel events, which the profiler takes minutes to read back
DYN_RNN_BUSY = dict(cut=(10, 256))
# recommender_system: the book's whole model (tools/torch_book_models.py,
# the movie tower's ragged categories and title) at batch 256: a _window
# of REC_STEPS, busy share, the pad ids rewritten, REC_PARITY_STEPS
# lockstep steps.
REC_STEPS = 4
REC_PARITY_STEPS = 3
# sequence_chain: every sequence lowering at CHAIN (x [256, 128, 768] f32,
# lengths 1-128; ids [256, 128]): a _window of CHAIN_STEPS, one Adam launch
# a step over the sequence_conv filter [2,304, 768]; host syncs a step;
# CHAIN_PARITY_STEPS lockstep steps at CHAIN_PARITY (batch 32), the ops
# that move or pick values (SEQ_EXACT_OPS) bit for bit. Control:
# sequence_reverse on the card reversing the padding too.
CHAIN_STEPS = 4
CHAIN_PARITY_STEPS = 2
CHAIN_PARITY = dict(batch=32)
SEQ_CHAIN_ADAM_CASES = [((2304, 768), "float32", 1)]
SEQ_EXACT_OPS = {"sequence_reverse", "sequence_expand", "sequence_expand_as",
                 "sequence_concat", "sequence_pad", "sequence_unpad",
                 "sequence_slice", "sequence_enumerate", "sequence_reshape",
                 "sequence_erase", "sequence_mask"}

_CARD = []


def _card():
    """The card's name and power limit, as nvidia-smi gives them."""
    if not _CARD:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        _CARD.append(smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
                     else "nvidia-smi: %s" % smi.stderr.strip())
    return _CARD[0]


def _seq_tool():
    return _load_tool("torch_sequence_programs")


def _busy_named(fluid, model, feed, top=6):
    """_step_busy's readings with the `top` kernels by device ms a step:
    [name, ms, launches]."""
    names = {}
    rec = _busy_rec(*_step_busy(fluid, model, feed, names))
    rec["top_kernels"] = [[n[:120], ms, c] for n, (ms, c) in sorted(
        names.items(), key=lambda kv: -kv[1][0])[:top]]
    return rec


def _tokens(feeds, ragged):
    """(real tokens, padded tokens) of `feeds`: the sum of the lengths of
    the ragged input `ragged`, and batch times T."""
    real = sum(int(f[ragged + "@LEN"].sum()) for f in feeds)
    return real, sum(int(f[ragged].shape[0] * f[ragged].shape[1])
                     for f in feeds)


def _ragged_window(name, fluid, counters, model, warm, feeds, ragged,
                   want_per_step, info):
    """Startup on the card, one warm step on `warm`, then one step through
    Executor.run on each batch of `feeds` (each its own T, as a ragged
    stream is fed) with every launch count zeroed just before and read
    just after. Every loss must be finite and the launches `want_per_step`
    times the steps. Emits the phase's line (step ms, examples, real and
    padded tokens of the ragged input `ragged` a second, the batches' T,
    peak memory, launches) and returns (the launches, the scope)."""
    import numpy as np
    import torch
    t_start = time.perf_counter()
    exe, scope = fluid.Executor(), fluid.Scope()
    exe.run(model.startup, scope=scope)
    warm_loss, = exe.run(model.main, feed=warm, fetch_list=[model.loss],
                         scope=scope)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero(counters)
    t0 = time.perf_counter()
    losses = [exe.run(model.main, feed=f, fetch_list=[model.loss],
                      scope=scope, return_numpy=False)[0] for f in feeds]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launched = _read(counters)
    losses = [float(v) for v in losses]
    steps = len(feeds)
    want = {k: v * steps for k, v in want_per_step.items()}
    real, padded = _tokens(feeds, ragged)
    ok = bool(np.isfinite(losses).all()) and \
        bool(np.isfinite(warm_loss).all()) and launched == want
    rec = dict({"phase": name, "ok": ok, "card": _card()}, **info)
    rec.update({
        "steps": steps, "T": [int(f[ragged].shape[1]) for f in feeds],
        "losses": losses, "warm_loss": float(np.asarray(warm_loss)),
        "window_seconds": seconds, "step_ms": seconds / steps * 1e3,
        "examples_per_s": sum(f[ragged].shape[0] for f in feeds) / seconds,
        "real_tokens_per_s": real / seconds,
        "padded_tokens_per_s": padded / seconds,
        "real_token_share": real / padded,
        "launches": launched, "launches_want": want,
        "launches_a_step": {k: v / steps for k, v in launched.items()},
        "peak_memory_bytes": torch.cuda.max_memory_allocated(),
        "phase_seconds": time.perf_counter() - t_start})
    emit(rec)
    if not ok:
        raise AssertionError("%s failed: launches %s, want %s, losses %s"
                             % (name, launched, want, losses))
    return launched, scope


def _pad_invariance(fluid, model, feed, ragged, seed):
    """One step on the card from one state on `feed` and on `feed` with
    new ids at the pad positions of its ragged inputs `ragged`: the
    losses' and every persistable's largest difference relative to its
    largest value, within RESNET_OP_TOL (float32)."""
    import numpy as np
    tool = _seq_tool()
    repadded = tool.repad(feed, seed, ragged)
    changed = sum(int((repadded[n] != feed[n]).sum()) for n in ragged)
    exe, scope = fluid.Executor(), fluid.Scope()
    exe.run(model.startup, scope=scope)
    block = model.main.global_block()
    state = {n: scope.get(n) for n, v in block.vars.items()
             if v.persistable and scope.get(n) is not None}
    runs = []
    for f in (feed, repadded):
        sc = fluid.Scope()
        for n, t in state.items():
            sc.set(n, t.clone())
        loss, = exe.run(model.main, feed=f, fetch_list=[model.loss],
                        scope=sc)
        runs.append((loss, {n: fluid.executor.as_numpy(sc.get(n))
                            for n in state}))
    (l0, s0), (l1, s1) = runs
    rel = {"loss": _rel_max(l1, l0)}
    rel.update({n: _rel_max(s1[n], s0[n]) for n in s0})
    worst = max(rel.items(), key=lambda kv: kv[1])
    return {"pad_ids_rewritten": changed, "worst": worst,
            "bit_for_bit": all(v == 0.0 for v in rel.values()),
            "limit": RESNET_OP_TOL["float32"],
            "ok": changed > 0 and worst[1] <= RESNET_OP_TOL["float32"]}


def _sqrt_ulps():
    """torch.sqrt of 2^20 positive float32 values on the card against the
    CPU's (correctly rounded): how many differ, and by how many units in
    the last place at most (the replay's measure of a persistable the step
    updates rests on it)."""
    import torch
    gen = torch.Generator()
    gen.manual_seed(SEED)
    x = torch.rand(1 << 20, generator=gen) * 4.0 + 1e-3
    cpu = torch.sqrt(x)
    card = torch.sqrt(x.cuda()).cpu()
    ulps = (card.view(torch.int32) - cpu.view(torch.int32)).abs()
    return {"values": x.numel(), "differing": int((ulps > 0).sum()),
            "max_ulps": int(ulps.max())}


def _lengths_control(fluid, model, feeds, ragged, how):
    """A lockstep step whose card is fed wrong lengths (`how`: "all_T" or
    "short_by_one"); it must miss its bound. Returns the readings."""
    import numpy as np
    key = ragged + "@LEN"

    def card_feed(f):
        lens = f[key]
        wrong = np.full_like(lens, f[ragged].shape[1]) if how == "all_T" \
            else np.maximum(lens - 1, 0)
        return dict(f, **{key: wrong})
    _, rec, passed = _lockstep(fluid, model[:3], feeds[:1],
                               card_feed=card_feed)
    return dict(rec, ok=not passed)


def _sequence_reverse_pads_too(ctx, inputs, attrs):
    """sequence_reverse on the card reversing the whole padded time axis,
    padding and all (a control). CPU tensors take the real lowering."""
    import torch
    from paddle_tpu_torch.fluid.ops import sequence_ops
    x = inputs["X"][0]
    if not x.is_cuda:
        return sequence_ops._sequence_reverse(ctx, inputs, attrs)
    return {"Y": [torch.flip(x, dims=[1])]}


def phase_understand_sentiment_conv(fluid, counters):
    """convolution_net at SENTIMENT: a _ragged_window, its busy share, the
    model served from its artifact, the pad ids rewritten, the lockstep
    and its two length controls. Returns the window's launches."""
    import numpy as np
    tool = _seq_tool()
    t0 = time.perf_counter()
    w = tool.SENTIMENT
    m = tool.understand_sentiment_conv(fluid, seed=SEED)
    feeds = [tool.review_batch(SEED + k) for k in range(SENT_STEPS + 1)]
    launched, scope = _ragged_window(
        "understand_sentiment_conv", fluid, counters, m, feeds[0],
        feeds[1:], "words", dict.fromkeys(counters, 0),
        {"widths": w, "ops": len(m.main.global_block().ops),
         # the ids Adagrad's sparse merge adds as one run: the pad id 0
         "id_0_repeats": [int((f["words"] == 0).sum()) for f in feeds[1:]],
         "build_seconds": time.perf_counter() - t0})
    t1 = time.perf_counter()
    results = {"busy": _busy_named(fluid, m, feeds[1])}
    one = tool.review_batch(SEED + 50, batch=SENT_SERVE_BATCH)
    serve = m._replace(feeds=["words", "words@LEN"])
    card, cpu, ms, syncs, size = _serve_artifact(
        fluid, serve, scope, {k: one[k] for k in serve.feeds},
        "understand_sentiment_conv", 5)
    rel = _rel_max(card, cpu)
    results["serve"] = {
        "batch": SENT_SERVE_BATCH, "T": int(one["words"].shape[1]),
        "shape": list(card.shape), "ms_a_request": ms,
        "host_syncs_a_request": len(syncs), "host_sync_places": syncs,
        "artifact_bytes": size, "rel_max_card_vs_cpu": rel,
        "limit": SERVE_REL_MAX,
        "ok": card.shape == (SENT_SERVE_BATCH, w["classes"]) and
        bool(np.isfinite(card).all()) and rel <= SERVE_REL_MAX}
    del scope
    results["pad_invariance"] = _pad_invariance(fluid, m, feeds[1],
                                                ["words"], SEED)
    results["sqrt_card_vs_cpu"] = _sqrt_ulps()
    par = [tool.review_batch(SEED + 100 + k, **SENT_PARITY)
           for k in range(SENT_PARITY_STEPS)]
    _, rec, ok = _lockstep(fluid, m[:3], par)
    results["lockstep"] = dict(rec, ok=ok, widths=SENT_PARITY,
                               T=[int(f["words"].shape[1]) for f in par])
    for how in ("all_T", "short_by_one"):
        results["control_lengths_" + how + "_on_the_card"] = \
            _lengths_control(fluid, m, par, "words", how)
    failed = [k for k, r in results.items() if not r.get("ok", True)]
    emit({"phase": "understand_sentiment_conv_parity", "ok": not failed,
          "card": _card(), "parity_steps": SENT_PARITY_STEPS,
          "results": results, "phase_seconds": time.perf_counter() - t1})
    if failed:
        raise AssertionError("understand_sentiment_conv: %s failed"
                             % failed)
    return launched


def phase_understand_sentiment_dyn_rnn(fluid, counters):
    """dyn_rnn_lstm at SENTIMENT: a _ragged_window, its busy share, each
    row's memory frozen past its length, the lockstep. Returns the
    window's launches."""
    import numpy as np
    tool = _seq_tool()
    t0 = time.perf_counter()
    m = tool.understand_sentiment_dyn_rnn(fluid, seed=SEED)
    block = m.main.global_block()
    feeds = [tool.review_batch(SEED + k)
             for k in range(DYN_RNN_STEPS + 1)]
    launched, scope = _ragged_window(
        "understand_sentiment_dyn_rnn", fluid, counters, m, feeds[0],
        feeds[1:], "words", dict.fromkeys(counters, 0),
        {"widths": tool.SENTIMENT, "ops": len(block.ops),
         "step_ops": len(m.main.block(1).ops),
         "build_seconds": time.perf_counter() - t0})
    t1 = time.perf_counter()
    short = tool.review_batch(SEED + 60, **DYN_RNN_BUSY)
    results = {"busy": dict(_busy_named(fluid, m, short),
                            T=int(short["words"].shape[1]))}
    rnn, = [op for op in block.ops if op.type == "recurrent"]
    final_h = rnn.output("FinalState")[0]
    states, final = fluid.Executor().run(
        m.main, feed=feeds[1], fetch_list=[m.out, final_h], scope=scope)
    lens = feeds[1]["words@LEN"]
    at_len = states[np.arange(len(lens)), lens - 1]
    results["memory_frozen_past_length"] = {
        "length_input": rnn.input("Length"), "T": int(states.shape[1]),
        "ok": rnn.input("Length") == ["words@LEN"] and
        bool(np.array_equal(at_len, final))}
    del scope
    par = [tool.review_batch(SEED + 100 + k, **DYN_RNN_PARITY)
           for k in range(DYN_RNN_PARITY_STEPS)]
    _, rec, ok = _lockstep(fluid, m[:3], par)
    results["lockstep"] = dict(rec, ok=ok, widths=DYN_RNN_PARITY,
                               T=[int(f["words"].shape[1]) for f in par])
    failed = [k for k, r in results.items() if not r.get("ok", True)]
    emit({"phase": "understand_sentiment_dyn_rnn_parity", "ok": not failed,
          "card": _card(), "parity_steps": DYN_RNN_PARITY_STEPS,
          "results": results, "phase_seconds": time.perf_counter() - t1,
          "whole_phase_seconds": time.perf_counter() - t0})
    if failed:
        raise AssertionError("understand_sentiment_dyn_rnn: %s failed"
                             % failed)
    return launched


def phase_recommender_system(fluid, counters):
    """The book's whole recommender at batch 256: a _window, busy share,
    the pad ids of its ragged categories and titles rewritten, the
    lockstep. Returns the window's launches."""
    import numpy as np
    book = _load_tool("torch_book_models")
    t0 = time.perf_counter()
    name, batch = "recommender_system", 256
    b = book.programs(name, fluid, seed=SEED)
    draws = [book.synthetic_batch(name, batch, seed=SEED + k)
             for k in range(REC_STEPS + 1)]
    stacked = _stack_feeds(draws)
    real = sum(_tokens(draws[1:], n)[0] for n in ("category_id",
                                                 "movie_title"))
    padded = sum(_tokens(draws[1:], n)[1] for n in ("category_id",
                                                   "movie_title"))
    launched = _window(
        name, fluid, counters, (b.main, b.startup, b.loss),
        {k: v[:1] for k, v in stacked.items()},
        {k: v[1:] for k, v in stacked.items()}, REC_STEPS,
        dict.fromkeys(counters, 0), None,
        {"card": _card(), "batch": batch,
         "ops": len(b.main.global_block().ops),
         "T": {n: int(draws[0][n].shape[1])
               for n in ("category_id", "movie_title")},
         "real_token_share": real / padded,
         "build_seconds": time.perf_counter() - t0},
        {"examples": batch, "real_tokens": real / REC_STEPS,
         "padded_tokens": padded / REC_STEPS})
    t1 = time.perf_counter()
    results = {"busy": _busy_named(fluid, b, draws[1]),
               "pad_invariance": _pad_invariance(
                   fluid, b, draws[1], ["category_id", "movie_title"],
                   SEED)}
    feeds = [book.synthetic_batch(name, batch, seed=SEED + 100 + k)
             for k in range(REC_PARITY_STEPS)]
    _, rec, ok = _lockstep(fluid, b[:3], feeds)
    results["lockstep"] = dict(rec, ok=ok)
    failed = [k for k, r in results.items() if not r.get("ok", True)]
    emit({"phase": "recommender_system_parity", "ok": not failed,
          "card": _card(), "parity_steps": REC_PARITY_STEPS,
          "results": results, "phase_seconds": time.perf_counter() - t1})
    if failed:
        raise AssertionError("recommender_system: %s failed" % failed)
    return launched


def phase_sequence_chain(fluid, counters):
    """Every sequence lowering at CHAIN: a _window (one Adam launch a step
    over the sequence_conv filter), host syncs a step, busy share, the
    lockstep and its control. Returns the window's launches."""
    from unittest import mock
    from paddle_tpu_torch.fluid.ops import registry
    from paddle_tpu_torch.ops import adam_kernel
    tool = _seq_tool()
    t0 = time.perf_counter()
    w = tool.CHAIN
    m = tool.sequence_chain(fluid, seed=SEED)
    block = m.main.global_block()
    admitted = sorted(op.input("Param")[0] for op in block.ops
                      if op.type == "adam" and adam_kernel.adam_ok(
                          tuple(block.var(op.input("Param")[0]).shape)))
    draws = [tool.chain_batch(SEED + k) for k in range(CHAIN_STEPS + 1)]
    stacked = _stack_feeds(draws)
    real, padded = _tokens(draws[1:], "x")
    launched = _window(
        "sequence_chain", fluid, counters, m[:3],
        {k: v[:1] for k, v in stacked.items()},
        {k: v[1:] for k, v in stacked.items()}, CHAIN_STEPS,
        dict(dict.fromkeys(counters, 0), adam=1), len(admitted),
        {"card": _card(), "widths": w, "ops": len(block.ops),
         "op_types": sorted({op.type for op in block.ops
                             if op.type.startswith("sequence_")}),
         "adam_admitted": {n: list(block.var(n).shape) for n in admitted},
         "real_token_share": real / padded,
         "build_seconds": time.perf_counter() - t0},
        {"examples": w["batch"], "real_tokens": real / CHAIN_STEPS,
         "padded_tokens": padded / CHAIN_STEPS})
    t1 = time.perf_counter()
    results = {"busy": _busy_named(fluid, m, draws[1]),
               "step_host_syncs": _step_syncs(fluid, m, stacked)}
    small = tool.sequence_chain(fluid, seed=SEED, **CHAIN_PARITY)
    feeds = [tool.chain_batch(SEED + 100 + k, **CHAIN_PARITY)
             for k in range(CHAIN_PARITY_STEPS)]
    _, rec, ok = _lockstep(fluid, small[:3], feeds, exact_ops=SEQ_EXACT_OPS)
    results["lockstep"] = dict(rec, ok=ok, widths=dict(w, **CHAIN_PARITY))
    with mock.patch.dict(registry._LOWERINGS,
                         sequence_reverse=_sequence_reverse_pads_too):
        _, rec, passed = _lockstep(fluid, small[:3], feeds[:1])
    results["control_reverse_pads_too_on_the_card"] = dict(rec,
                                                           ok=not passed)
    failed = [k for k, r in results.items() if not r.get("ok", True)]
    emit({"phase": "sequence_chain_parity", "ok": not failed,
          "card": _card(), "parity_steps": CHAIN_PARITY_STEPS,
          "results": results, "phase_seconds": time.perf_counter() - t1})
    if failed:
        raise AssertionError("sequence_chain: %s failed" % failed)
    return launched


def sequence_phases(fluid, counters, add):
    """The ragged-sequence slice's phases, each with its launches added."""
    add(phase_understand_sentiment_conv(fluid, counters))
    add(phase_understand_sentiment_dyn_rnn(fluid, counters))
    with fluid.unique_name.guard():
        add(phase_recommender_system(fluid, counters))
    add(phase_sequence_chain(fluid, counters))


# ---- the recurrent ops and fluid_benchmark's two RNN models ----

# rnn_lockstep: tools/torch_fluid_benchmark.py's stacked_dynamic_lstm and
# machine_translation at its widths (batch ZOO_BATCH), RNN_PARITY_STEPS
# steps each in lockstep with the CPU from the CPU's startup state, every
# op replayed within RESNET_OP_TOL, losses within OPT_LOSS_REL_MAX.
# Controls, one step each: the card's dynamic_lstm and dynamic_gru without
# their Length input, with is_reverse flipped, and with their input's
# gradient RNN_PLANTED too large; machine_translation's fc_2.w_0 gradient
# RNN_PLANTED_CANCELLING too large on the card (RNN_CANCELLING). A planted
# gradient leaves the forward as it is: the replay must name it as the
# worst output.
RNN_PARITY_STEPS = 3
RNN_PLANTED = 1e-3
RNN_PLANTED_CANCELLING = 1e-2
# At initialization machine_translation's attention is near uniform, so
# the gradient of its decoder projection fc_2.w_0 cancels to noise: its
# terms through the attention's broadcast add sum to 1.25e-6 in absolute
# value and leave 1.95e-11, and the CPU's float32 value lies 4.2e-4 of its
# size from the step in float64. It alone is held to CANCEL_NOISE times
# that error (_lockstep_step); the phase lists it with its numbers.
RNN_CANCELLING = {"machine_translation": ("fc_2.w_0@GRAD",)}
# rnn_chain: tools/torch_rnn_programs.py's chain at its CHAIN widths: a
# _window of RNN_CHAIN_STEPS (one Adam launch a step over the LSTMP's
# [512, 8192] recurrent and [2048, 512] projection weights:
# RNN_CHAIN_ADAM_CASES), host syncs a step, busy share;
# RNN_CHAIN_PARITY_STEPS lockstep steps. Controls: cudnn_lstm's backward
# direction run forward on the card, and its input's gradient RNN_PLANTED
# too large there.
RNN_CHAIN_STEPS = 4
RNN_CHAIN_PARITY_STEPS = 2
RNN_CHAIN_ADAM_CASES = [((512, 8192), "float32", 1),
                        ((2048, 512), "float32", 1)]
# the op types of the recurrent lowerings, each of which rnn_chain runs
RNN_LOWERINGS = ("dynamic_lstm", "lstm", "dynamic_gru", "gru", "lstmp",
                 "cudnn_lstm", "gru_unit", "lstm_unit")


def _on_the_card(lowering, change):
    """`lowering` with its (inputs, attrs) changed by `change` on the card
    (a control). CPU tensors take the real lowering."""
    def lower(ctx, inputs, attrs):
        if ctx.device.type == "cuda":
            inputs, attrs = change(inputs, attrs)
        return lowering(ctx, inputs, attrs)
    return lower


def _without_length(inputs, attrs):
    return dict(inputs, Length=[]), attrs


def _reverse_flipped(inputs, attrs):
    return inputs, dict(attrs, is_reverse=not attrs.get("is_reverse", False))


def _grad_off(slot, k, off):
    """A control's change: input `k` of `slot` as it is, its gradient
    1 + `off` times the true one."""
    import torch

    class Off(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x.view_as(x)

        @staticmethod
        def backward(ctx, g):
            return g * (1.0 + off)

    def change(inputs, attrs):
        vals = list(inputs[slot])
        vals[k] = Off.apply(vals[k])
        return dict(inputs, **{slot: vals}), attrs
    return change


def _rnn_controls(main, model):
    """{name: ({op type: control lowering}, the gradients it plants or
    None)} for rnn_lockstep."""
    from paddle_tpu_torch.fluid.ops import rnn_ops
    block = main.global_block()
    ops = {"dynamic_lstm": rnn_ops._dynamic_lstm,
           "dynamic_gru": rnn_ops._dynamic_gru}
    inputs = [op.input("Input")[0] + "@GRAD" for op in block.ops
              if op.type in ops]
    controls = {name: ({op: _on_the_card(fn, change)
                        for op, fn in ops.items()}, planted)
                for name, change, planted in (
                    ("length_dropped", _without_length, None),
                    ("is_reverse_flipped", _reverse_flipped, None),
                    ("input_grad_off", _grad_off("Input", 0, RNN_PLANTED),
                     inputs))}
    for n in RNN_CANCELLING.get(model, ()):
        params = next(op for op in block.ops
                      if op.type == "recurrent").input("Params")
        k = params.index(n[:-len("@GRAD")])
        controls["cancelling_grad_off"] = ({"recurrent": _on_the_card(
            rnn_ops._recurrent,
            _grad_off("Params", k, RNN_PLANTED_CANCELLING))}, [n])
    return controls


def _control_missed(rec, passed, planted):
    """Did a one-step control fail, and where it planted wrong gradients,
    with one of them the worst float32 output of the replay?"""
    if planted is None:
        return not passed
    worst = rec["worst_op"][0]["float32"][0]
    return not passed and any(worst.startswith(g) for g in planted)


def phase_rnn_lockstep(fluid):
    """Both recurrent zoo models in lockstep with the CPU, each with its
    controls (checks: no launch counted)."""
    from unittest import mock
    from paddle_tpu_torch.fluid.ops import registry
    tool = _load_tool("torch_fluid_benchmark")
    t0 = time.perf_counter()
    results = {}
    for model in ZOO_RECURRENT:
        with fluid.unique_name.guard():
            main, startup, loss, gen = tool.build_programs(
                tool.parse_args(["--model", model, "--batch_size",
                                 str(ZOO_BATCH)]), fluid)
        startup.random_seed = SEED
        feeds = [gen() for _ in range(RNN_PARITY_STEPS)]
        cancelling = RNN_CANCELLING.get(model, ())
        _, rec, ok = _lockstep(fluid, (main, startup, loss), feeds,
                               cancelling=cancelling)
        results[model] = dict(rec, ok=ok)
        for name, (lowerings, planted) in _rnn_controls(main, model).items():
            with mock.patch.dict(registry._LOWERINGS, **lowerings):
                _, rec, passed = _lockstep(fluid, (main, startup, loss),
                                           feeds[:1], cancelling=cancelling)
            results[model + "_control_" + name] = dict(
                rec, ok=_control_missed(rec, passed, planted))
    failed = [k for k, r in results.items() if not r["ok"]]
    emit({"phase": "rnn_lockstep", "ok": not failed, "card": _card(),
          "batch": ZOO_BATCH, "steps": RNN_PARITY_STEPS,
          "results": results, "phase_seconds": time.perf_counter() - t0})
    if failed:
        raise AssertionError("rnn_lockstep: %s failed" % failed)


def _cudnn_backward_run_forward(ctx, inputs, attrs):
    """cudnn_lstm on the card with its backward direction run from t = 0
    (a control). CPU tensors take the real lowering."""
    from paddle_tpu_torch.fluid.ops import rnn_ops
    if ctx.device.type != "cuda" or not attrs.get("is_bidirec", False):
        return rnn_ops._cudnn_lstm(ctx, inputs, attrs)
    times = rnn_ops._times
    try:
        rnn_ops._times = lambda n, reverse: range(n)
        return rnn_ops._cudnn_lstm(ctx, inputs, attrs)
    finally:
        rnn_ops._times = times


def phase_rnn_chain(fluid, counters):
    """Every recurrent lowering at the PTB medium LSTM's widths: a _window
    (one Adam launch a step over the LSTMP's weights), host syncs a step,
    busy share, the lockstep and its control. Returns the window's
    launches."""
    from unittest import mock
    from paddle_tpu_torch.fluid.ops import registry, rnn_ops
    from paddle_tpu_torch.ops import adam_kernel
    tool = _load_tool("torch_rnn_programs")
    t0 = time.perf_counter()
    w = tool.CHAIN
    m = tool.rnn_chain(fluid, seed=SEED)
    block = m.main.global_block()
    admitted = sorted(op.input("Param")[0] for op in block.ops
                      if op.type == "adam" and adam_kernel.adam_ok(
                          tuple(block.var(op.input("Param")[0]).shape)))
    draws = [tool.chain_batch(SEED + k) for k in range(RNN_CHAIN_STEPS + 1)]
    stacked = _stack_feeds(draws)
    real = sum(int(d["words@LEN"].sum()) for d in draws[1:])
    launched = _window(
        "rnn_chain", fluid, counters, m[:3],
        {k: v[:1] for k, v in stacked.items()},
        {k: v[1:] for k, v in stacked.items()}, RNN_CHAIN_STEPS,
        dict(dict.fromkeys(counters, 0), adam=1), len(admitted),
        {"card": _card(), "widths": w, "ops": len(block.ops),
         "step_ops": len(m.main.block(1).ops),
         "recurrent_ops": sorted(op.type for op in block.ops
                                 if op.type in RNN_LOWERINGS),
         "adam_admitted": {n: list(block.var(n).shape) for n in admitted},
         "build_seconds": time.perf_counter() - t0},
        {"examples": w["batch"], "real_tokens": real / RNN_CHAIN_STEPS,
         "padded_tokens": w["batch"] * w["seq"]})
    t1 = time.perf_counter()
    results = {"busy": _busy_named(fluid, m, draws[1]),
               "step_host_syncs": _step_syncs(fluid, m, stacked)}
    feeds = [tool.chain_batch(SEED + 100 + k)
             for k in range(RNN_CHAIN_PARITY_STEPS)]
    _, rec, ok = _lockstep(fluid, m[:3], feeds)
    results["lockstep"] = dict(rec, ok=ok)
    with mock.patch.dict(registry._LOWERINGS,
                         cudnn_lstm=_cudnn_backward_run_forward):
        _, rec, passed = _lockstep(fluid, m[:3], feeds[:1])
    results["control_cudnn_backward_run_forward_on_the_card"] = dict(
        rec, ok=not passed)
    with mock.patch.dict(registry._LOWERINGS, cudnn_lstm=_on_the_card(
            rnn_ops._cudnn_lstm, _grad_off("Input", 0, RNN_PLANTED))):
        _, rec, passed = _lockstep(fluid, m[:3], feeds[:1])
    results["control_cudnn_input_grad_off_on_the_card"] = dict(
        rec, ok=_control_missed(rec, passed, [
            op.input("Input")[0] + "@GRAD" for op in m.main.global_block().ops
            if op.type == "cudnn_lstm"]))
    failed = [k for k, r in results.items() if not r.get("ok", True)]
    emit({"phase": "rnn_chain_parity", "ok": not failed, "card": _card(),
          "parity_steps": RNN_CHAIN_PARITY_STEPS, "results": results,
          "phase_seconds": time.perf_counter() - t1})
    if failed:
        raise AssertionError("rnn_chain: %s failed" % failed)
    return launched


def recurrent_phases(fluid, counters, add):
    """The recurrent slice's phases, each with its launches added."""
    add(phase_zoo(fluid, counters, ZOO_RECURRENT))
    phase_rnn_lockstep(fluid)
    add(phase_rnn_chain(fluid, counters))


# ---- decoding: beam search, the linear-chain CRF, NCE ----

# book_machine_translation: tools/torch_decode_programs.py's MT at its
# WMT-14 widths (dictionary 30,000, embedding and hidden 512, T 32, batch
# 64): a _window of DEC_STEPS with one Adam launch a step over the 4
# parameters the kernel takes (DEC_ADAM_CASES), busy share, host syncs a
# step; then DEC_TRAIN_STEPS steps, save_persistables, load_persistables
# into a fresh scope and DEC_REQUESTS beam-search requests (MT_BEAM: 8
# sources of 2 rows, top-k 50, 32 steps): ms, generated tokens a second,
# port launches (none), device kernels and busy share a request, host
# syncs inside the search (none).
DEC_STEPS = 4
DEC_TRAIN_STEPS = 2
DEC_REQUESTS = 4
DEC_ADAM_CASES = [((30000, 512), "float32", 2), ((512, 512), "float32", 2)]
DEC_ADAM_TENSORS = sum(n for _, _, n in DEC_ADAM_CASES)
# book_label_semantic_roles: the book's chapter 7 at its widths (SRL:
# batch 10, sentences of 5-50 words, depth 8, SGD: no port kernel): one
# warm step and SRL_STEPS through Executor.run (each batch its own T),
# busy share, host syncs a step; DEC_REQUESTS tagging requests from the
# trained scope (the is_test program whose crf_decoding outputs the tags,
# tool.srl_tagger).
SRL_STEPS = 4
# word2vec_nce: a _window of W2V_NCE_STEPS at the book's widths (batch
# 100, no port kernel); the nce lowering's draws on the card held by their
# invariants (NCE_REL_MAX against float64, chi-square p > 1e-4 on
# SAMPLE_CHI_DRAWS draws).
W2V_NCE_STEPS = 4
NCE_REL_MAX = 1e-5
# decode_lockstep: each program's DEC_PARITY_STEPS steps in lockstep with
# the CPU (_lockstep: every op replayed within RESNET_OP_TOL, ints
# exactly; losses within OPT_LOSS_REL_MAX; the card's nce takes the CPU
# generator's negatives, as its invariants are held in word2vec_nce); the
# beam-search and tagging requests replayed op by op; and both requests
# whole on the card against the CPU, where a beam's ids or a Viterbi path
# may differ only after a decision whose CPU candidates lie within
# NEAR_TIE_REL of each other (counted), and a beam's ids are exact and its
# scores within RESNET_OP_TOL before its source's first such decision.
DEC_PARITY_STEPS = {"book_machine_translation": 1,
                    "book_label_semantic_roles": 2, "word2vec_nce": 3}
NEAR_TIE_REL = 2.0 ** -20


def _dec_tool():
    return _load_tool("torch_decode_programs")


def _beam_ops(program):
    return [op for op in program.global_block().ops
            if op.type == "beam_search"]


def _decode_request(fluid, dec, exe, scope, feed, extra=()):
    """One request: {name: numpy} of ids, scores, sentences and `extra`."""
    names = [dec.ids.name, dec.scores.name, dec.sentences.name] + \
        list(extra)
    return dict(zip(names, exe.run(dec.main, feed=feed, fetch_list=names,
                                   scope=scope)))


def _serve_requests(fluid, counters, program, scope, feeds, fetch, tokens):
    """`feeds` requests of `program` on the card (fetching `fetch`), each
    timed, with every port launch counted; busy share, device kernels and
    host syncs of one more. `tokens`: the tokens a request makes (the beam
    search's) or labels (the CRF's)."""
    import torch
    exe = fluid.Executor()
    exe.run(program, feed=feeds[0], fetch_list=fetch, scope=scope)
    torch.cuda.synchronize()
    _zero(counters)
    ms = []
    for f in feeds:
        t0 = time.perf_counter()
        exe.run(program, feed=f, fetch_list=fetch, scope=scope,
                return_numpy=False)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    launched = _read(counters)
    wall, busy, by_kind = _busy_share(lambda: exe.run(
        program, feed=feeds[0], fetch_list=fetch, scope=scope,
        return_numpy=False))
    _, syncs = _sync_places(lambda: exe.run(
        program, feed=feeds[0], fetch_list=fetch, scope=scope,
        return_numpy=False))
    mean = sum(ms) / len(ms)
    rec = {"requests": len(feeds), "ms_a_request": ms, "ms_mean": mean,
           "tokens_a_request": tokens,
           "tokens_per_s": tokens / mean * 1e3,
           "port_launches": launched,
           "device_kernels_a_request": sum(c for _, c in by_kind.values()),
           "busy": _busy_rec(wall, busy, by_kind),
           "host_syncs_a_request": len(syncs), "host_sync_places": syncs,
           # those in the port's lowerings, not the executor's feed copies
           "host_syncs_in_the_search": sum(
               "paddle_tpu_torch/" in p and "/executor.py" not in p
               for p in syncs)}
    rec["ok"] = not any(launched.values()) and \
        not rec["host_syncs_in_the_search"]
    return rec


def phase_book_machine_translation(fluid, counters):
    """The book's MT at the WMT-14 widths: a _window (one Adam launch a
    step over its 4 admitted parameters), busy share, host syncs a step,
    then trained, saved, loaded into a fresh scope and served
    DEC_REQUESTS beam-search requests. Returns the window's launches."""
    import shutil
    import numpy as np
    import torch
    from paddle_tpu_torch.ops import adam_kernel
    tool = _dec_tool()
    t0 = time.perf_counter()
    w = tool.MT
    m = tool.book_machine_translation(fluid, seed=SEED)
    block = m.main.global_block()
    admitted = sorted(op.input("Param")[0] for op in block.ops
                      if op.type == "adam" and adam_kernel.adam_ok(
                          tuple(block.var(op.input("Param")[0]).shape)))
    stacked = _stack_feeds([tool.mt_batch(SEED + k)
                            for k in range(DEC_STEPS + 1)])
    launched = _window(
        "book_machine_translation", fluid, counters, m[:3],
        {k: v[:1] for k, v in stacked.items()},
        {k: v[1:] for k, v in stacked.items()}, DEC_STEPS,
        dict(dict.fromkeys(counters, 0), adam=1), DEC_ADAM_TENSORS,
        {"build_seconds": time.perf_counter() - t0, "card": _card(),
         "widths": w, "ops": len(block.ops),
         "step_ops": len(m.main.block(1).ops),
         "adam_admitted": {n: list(block.var(n).shape) for n in admitted}},
        {"examples": w["batch"], "tokens": w["batch"] * w["seq"]})
    t0 = time.perf_counter()
    results = {"busy": _busy_named(fluid, m, tool.mt_batch(SEED + 50)),
               "step_host_syncs": _step_syncs(fluid, m, stacked)}
    exe, scope = fluid.Executor(), fluid.Scope()
    exe.run(m.startup, scope=scope)
    exe.run_steps(m.main, feed={k: v[:DEC_TRAIN_STEPS]
                                for k, v in stacked.items()},
                  n_steps=DEC_TRAIN_STEPS, fetch_list=[m.loss], scope=scope)
    root = os.path.join(IO_DIR, "book_machine_translation")
    shutil.rmtree(root, ignore_errors=True)
    t1 = time.perf_counter()
    with fluid.scope_guard(scope):
        fluid.io.save_persistables(exe, root, main_program=m.main)
    saved = time.perf_counter() - t1
    served = fluid.Scope()
    t1 = time.perf_counter()
    with fluid.scope_guard(served):
        fluid.io.load_persistables(exe, root, main_program=m.main)
    loaded = time.perf_counter() - t1
    size = _artifact_bytes(root)
    shutil.rmtree(root, ignore_errors=True)
    same = all(torch.equal(served.get(n), scope.get(n)) for n in
               ("src_emb", "tgt_emb", "proj", "dec_fc", "proj.b"))
    del exe, scope
    beam = tool.MT_BEAM
    dec = tool.mt_decoder(fluid)
    feeds = [tool.mt_request(SEED + 60 + k) for k in range(DEC_REQUESTS)]
    rows = beam["sources"] * beam["beam"]
    rec = _serve_requests(fluid, counters, dec.main, served, feeds,
                          [dec.ids, dec.scores, dec.sentences],
                          rows * beam["max_len"])
    out = _decode_request(fluid, dec, fluid.Executor(), served, feeds[0])
    ids, scores, sent = (out[n] for n in (dec.ids.name, dec.scores.name,
                                          dec.sentences.name))
    rec.update({
        "beam": beam, "ops": len(dec.main.global_block().ops),
        "beam_search_ops": len(_beam_ops(dec.main)),
        "sources_per_s": beam["sources"] / rec["ms_mean"] * 1e3,
        "save_seconds": saved, "load_seconds": loaded,
        "checkpoint_bytes": size, "loaded_equal_saved": same,
        "ids_shape": list(ids.shape), "sentences_shape": list(sent.shape),
        "ids_in_top_k": bool(((ids >= 0) & (ids < beam["topk"])).all()),
        "scores_finite": bool(np.isfinite(scores).all())})
    rec["ok"] = rec["ok"] and same and rec["ids_in_top_k"] and \
        rec["scores_finite"] and \
        list(ids.shape) == [rows, beam["max_len"], 1] and \
        list(sent.shape) == [rows, beam["max_len"]]
    results["beam_search_requests"] = rec
    failed = [k for k, r in results.items() if not r.get("ok", True)]
    emit({"phase": "book_machine_translation_decode", "ok": not failed,
          "card": _card(), "results": results,
          "phase_seconds": time.perf_counter() - t0})
    if failed:
        raise AssertionError("book_machine_translation: %s failed" % failed)
    return launched


def phase_book_label_semantic_roles(fluid, counters):
    """The book's SRL at its widths: SRL_STEPS ragged batches through
    Executor.run (no port kernel), busy share, host syncs a step, and
    DEC_REQUESTS tagging requests (crf_decoding's tags) from the trained
    scope. Returns the window's launches."""
    import numpy as np
    tool = _dec_tool()
    t0 = time.perf_counter()
    w = tool.SRL
    m = tool.book_label_semantic_roles(fluid, seed=SEED)
    block = m.main.global_block()
    draws = [tool.srl_batch(SEED + k) for k in range(SRL_STEPS + 1)]
    launched, scope = _ragged_window(
        "book_label_semantic_roles", fluid, counters, m, draws[0],
        draws[1:], "word_data", dict.fromkeys(counters, 0),
        {"widths": w, "ops": len(block.ops),
         "lstm_ops": sum(op.type == "dynamic_lstm" for op in block.ops),
         "build_seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    results = {"busy": _busy_named(fluid, m, draws[1]),
               "step_host_syncs": _step_syncs(
                   fluid, m, _stack_feeds([draws[1], draws[1]]))}
    test = tool.srl_tagger(m)
    feeds = [tool.srl_batch(SEED + 60 + k) for k in range(DEC_REQUESTS)]
    real = sum(int(f["word_data@LEN"].sum()) for f in feeds) / len(feeds)
    rec = _serve_requests(fluid, counters, test, scope, feeds, [m.out],
                          real)
    out, = fluid.Executor().run(test, feed=feeds[0], fetch_list=[m.out],
                                scope=scope)
    rec.update({"path_shape": list(out.shape),
                "tags_in_range": bool(((out >= 0) &
                                       (out < w["label_dict"])).all())})
    rec["ok"] = rec["ok"] and rec["tags_in_range"] and \
        list(out.shape) == list(feeds[0]["word_data"].shape[:2])
    results["tagging_requests"] = rec
    failed = [k for k, r in results.items() if not r.get("ok", True)]
    emit({"phase": "book_label_semantic_roles_decode", "ok": not failed,
          "card": _card(), "results": results,
          "phase_seconds": time.perf_counter() - t0})
    if failed:
        raise AssertionError("book_label_semantic_roles: %s failed"
                             % failed)
    return launched


def _nce_draws_check(tool):
    """The nce lowering on the card at word2vec_nce's shapes: the labels
    first, the negatives in [0, V), the same draw on every call and
    another for another seed, SampleLogits the picked rows' products plus
    biases and Cost the NCE formula over SampleLogits (each within
    NCE_REL_MAX of float64), the negatives uniform (chi-square p > 1e-4
    on SAMPLE_CHI_DRAWS draws); ms a call. Returns (readings, ok)."""
    import math
    import numpy as np
    import torch
    from paddle_tpu_torch.fluid.ops import decode_ops, registry
    w = tool.W2V
    b, d, v = w["batch"], w["hidden"], w["dict_size"]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 5)
    ins = {"Input": [torch.rand(b, d, generator=gen, device="cuda")],
           "Label": [torch.randint(0, v, (b, 1), generator=gen,
                                   device="cuda")],
           "Weight": [torch.randn(v, d, generator=gen, device="cuda") * 0.05],
           "Bias": [torch.randn(v, generator=gen, device="cuda") * 0.05]}
    attrs = {"num_neg_samples": 10, "seed": 12345, "num_total_classes": v}
    ctx = registry.LoweringContext("cuda")
    lower = registry.get_lowering("nce")
    out, again = lower(ctx, ins, attrs), lower(ctx, ins, attrs)
    other = lower(ctx, ins, dict(attrs, seed=54321))
    labels = out["SampleLabels"][0]
    x64, w64, b64 = (ins[k][0].double() for k in ("Input", "Weight",
                                                   "Bias"))
    picked = (x64[:, None, :] * w64[labels]).sum(-1) + b64[labels]
    logits = out["SampleLogits"][0].double()
    log_q = -math.log(v)
    cost = (torch.nn.functional.softplus(-(logits[:, 0] - log_q)) +
            torch.nn.functional.softplus(logits[:, 1:] - log_q).sum(1))
    drawn = decode_ops.nce_negatives("cuda", 12345, SAMPLE_CHI_DRAWS // 10,
                                     10, v).reshape(-1).cpu().numpy()
    rec = {"rows": b, "classes": v, "negatives": 10,
           "labels_first": bool(torch.equal(labels[:, :1],
                                             ins["Label"][0])),
           "in_range": bool(((labels >= 0) & (labels < v)).all()),
           "same_every_call": all(torch.equal(out[s][0], again[s][0])
                                  for s in out),
           "other_seed_differs": not torch.equal(
               other["SampleLabels"][0], labels),
           "logits_rel_err": float((logits - picked).abs().max() /
                                   picked.abs().max()),
           "cost_rel_err": float((out["Cost"][0].double().reshape(-1) -
                                  cost).abs().max() / cost.abs().max()),
           "uniform_p": _chi_square_p(drawn, np.full(v, 1.0 / v)),
           "nce_ms": time_ms(lambda: lower(ctx, ins, attrs), iters=10,
                             warmup=2)}
    ok = rec["labels_first"] and rec["in_range"] and \
        rec["same_every_call"] and rec["other_seed_differs"] and \
        rec["logits_rel_err"] <= NCE_REL_MAX and \
        rec["cost_rel_err"] <= NCE_REL_MAX and rec["uniform_p"] > 1e-4
    return rec, ok


def phase_word2vec_nce(fluid, counters):
    """The book's word2vec with NCE: a _window (no port kernel) and the
    nce draws' invariants on the card. Returns the window's launches."""
    tool = _dec_tool()
    t0 = time.perf_counter()
    prog = tool.word2vec_nce(fluid, seed=SEED)
    batch = tool.W2V["batch"]
    stacked = _stack_feeds([tool.w2v_batch(SEED + k)
                            for k in range(W2V_NCE_STEPS + 1)])
    launched = _window(
        "word2vec_nce", fluid, counters, prog[:3],
        {k: v[:1] for k, v in stacked.items()},
        {k: v[1:] for k, v in stacked.items()}, W2V_NCE_STEPS,
        dict.fromkeys(counters, 0), None,
        {"build_seconds": time.perf_counter() - t0, "card": _card(),
         "batch": batch, "widths": tool.W2V,
         "ops": len(prog.main.global_block().ops)}, {"examples": batch})
    t0 = time.perf_counter()
    rec, ok = _nce_draws_check(tool)
    emit({"phase": "word2vec_nce_draws", "ok": ok, "card": _card(),
          "results": rec, "phase_seconds": time.perf_counter() - t0})
    if not ok:
        raise AssertionError("word2vec_nce: the draws failed %s" % rec)
    return launched


def _on_cpu_draws(bias_on_negatives=True):
    """nce on the card drawing the negatives that the CPU's generator
    draws for the same seed and batch (the lockstep's teacher-forced
    draws); without `bias_on_negatives` (a control) the negatives' logits
    lack their bias. CPU tensors take the real lowering."""
    from paddle_tpu_torch.fluid.ops import decode_ops

    def lower(ctx, inputs, attrs):
        x, w = inputs["Input"][0], inputs["Weight"][0]
        if not x.is_cuda:
            return decode_ops._nce(ctx, inputs, attrs)
        neg = decode_ops.nce_negatives(
            "cpu", attrs.get("seed", 12345) or 12345, x.shape[0],
            attrs.get("num_neg_samples", 10), w.shape[0]).to(x.device)
        label, bias = inputs["Label"][0], inputs["Bias"][0]
        if bias_on_negatives:
            return decode_ops.nce_forward(x, label, w, bias, neg)
        out = decode_ops.nce_forward(x, label, w, None, neg)
        logits = out["SampleLogits"][0]
        pos = logits[:, 0] + bias.reshape(-1)[label.reshape(-1).long()]
        out["SampleLogits"] = [logits.clone()]
        out["SampleLogits"][0][:, 0] = pos
        out["Cost"] = [decode_ops.nce_cost(pos, logits[:, 1:], w.shape[0])]
        return out
    return lower


def _per_row_top1(ctx, inputs, attrs):
    """beam_search on the card taking each row's own best candidate, not
    the top beam_size of the source's rows (a control). CPU tensors take
    the real lowering."""
    import torch
    from paddle_tpu_torch.fluid.ops import decode_ops
    scores = inputs["scores"][0]
    if not scores.is_cuda:
        return decode_ops._beam_search(ctx, inputs, attrs)
    total = scores + inputs["pre_scores"][0]
    val, idx = total.max(dim=1)
    return {"selected_ids": [idx.reshape(-1, 1)],
            "selected_scores": [val.reshape(-1, 1)],
            "parent_idx": [torch.arange(total.shape[0],
                                        device=scores.device)]}


def _backtrack_one_step_late(ctx, inputs, attrs):
    """beam_search_decode on the card following each parent one step late
    (a control). CPU tensors take the real lowering."""
    import torch
    from paddle_tpu_torch.fluid.ops import decode_ops
    ids, parents = inputs["Ids"][0], inputs["ParentIdx"][0]
    if not ids.is_cuda:
        return decode_ops._beam_search_decode(ctx, inputs, attrs)
    t, bw = parents.shape[0], parents.shape[1]
    ids2 = ids.reshape(t, bw)
    pos = prev = torch.arange(bw, device=ids.device)
    toks = [None] * t
    for s in reversed(range(t)):
        toks[s] = ids2[s][prev]
        prev, pos = pos, parents[s].long()[pos]
    return {"SentenceIds": [torch.stack(toks, dim=1).long()],
            "SentenceScores": inputs["Scores"]}


def _stop_row_zeroed(tr):
    """The transition [n + 2, n] with its stop row (row 1) zeroed."""
    import torch
    mask = torch.ones_like(tr[:, :1])
    mask[1] = 0.0
    return tr * mask


def _ll_without_stop(e, tr, label, lens):
    """path - logZ with logZ's forward left without the stop row (the path
    score keeps it)."""
    from paddle_tpu_torch.fluid.ops import decode_ops
    e, tr = e.float(), tr.float()
    return decode_ops.crf_path_score(e, tr, label, lens) - \
        decode_ops.crf_log_z(e, _stop_row_zeroed(tr), lens)


def _crf_without_stop(ctx, inputs, attrs):
    """linear_chain_crf on the card whose forward leaves out the stop row
    (a control). CPU tensors take the real lowering."""
    from paddle_tpu_torch.fluid.ops import decode_ops
    outs = decode_ops._linear_chain_crf(ctx, inputs, attrs)
    e, tr, label, lens = decode_ops._crf_operands(inputs)
    if e.is_cuda:
        outs["LogLikelihood"] = [_ll_without_stop(e, tr, label, lens)
                                 .reshape(-1, 1)]
    return outs


def _crf_grad_without_stop(ctx, inputs, attrs):
    """linear_chain_crf_grad on the card by autograd over the forward
    without the stop row (the control's gradient). CPU tensors take the
    real lowering."""
    import torch
    from paddle_tpu_torch.fluid.ops import decode_ops
    e, tr, label, lens = decode_ops._crf_operands(inputs)
    if not e.is_cuda:
        return decode_ops._linear_chain_crf_grad(ctx, inputs, attrs)
    cot = inputs["LL@GRAD"][0].reshape(-1).float().expand(e.shape[0])
    with torch.enable_grad():
        el = e.detach().float().requires_grad_(True)
        tl = tr.detach().float().requires_grad_(True)
        de, dt = torch.autograd.grad(_ll_without_stop(el, tl, label, lens),
                                     (el, tl), cot)
    return {"Emission@GRAD": [de.to(e.dtype)],
            "Transition@GRAD": [dt.to(tr.dtype)]}


def _viterbi_without_stop(ctx, inputs, attrs):
    """crf_decoding on the card taking its last tag without the stop row
    (a control). CPU tensors take the real lowering."""
    from paddle_tpu_torch.fluid.ops import decode_ops
    e = inputs["Emission"][0]
    if not e.is_cuda:
        return decode_ops._crf_decoding(ctx, inputs, attrs)
    b, t = e.shape[0], e.shape[1]
    lens = decode_ops._lengths((inputs.get("Length") or [None])[0], b, t,
                               e.device)
    path = decode_ops.viterbi(
        e.float(), _stop_row_zeroed(inputs["Transition"][0].float()), lens)
    label = (inputs.get("Label") or [None])[0]
    if label is not None:
        path = (path == label.reshape(b, t).long()).long()
    return {"ViterbiPath": [path]}


def _named_miss(rec, passed, dtype, op_types):
    """Did a one-step control fail, with an output of one of `op_types`
    the worst of `dtype` in its replay?"""
    worst = rec["worst_op"][0].get(dtype)
    return not passed and worst is not None and worst[1] in op_types


def _replay_program(fluid, program, fetch, state, feed):
    """Every op of `program` (no training step: the state stays) replayed
    on the card from the CPU's values: (readings, ok, the CPU's values)."""
    names = _step_names(program)
    vals, _ = _cpu_step(fluid, program, state, feed, names)
    errs = _replay_on_card(fluid, program, fetch, state, feed, vals, state)
    ok, worst = _op_verdict(errs)
    return {"worst_op": [worst], "outputs": len(errs),
            "op_tol": RESNET_OP_TOL}, ok, vals


def _beam_near_ties(dec, vals, feed, beam):
    """[steps, sources] bools: at that step the CPU's candidates of that
    source that decide its selections (its top beam_size + 1 totals)
    include two within NEAR_TIE_REL of each other."""
    import numpy as np
    def value(n):
        return np.asarray(vals[n] if n in vals else feed[n], np.float64)
    ties = []
    for op in _beam_ops(dec.main):
        total = value(op.input("scores")[0]) + \
            value(op.input("pre_scores")[0])
        top = -np.sort(-total.reshape(total.shape[0] // beam, -1),
                       axis=1)[:, :beam + 1]
        gaps = top[:, :-1] - top[:, 1:]
        ties.append((gaps <= NEAR_TIE_REL * np.abs(top[:, :-1])).any(1))
    return np.array(ties)


def _clean_steps(ties, beam):
    """Each source's steps before its first near tie at the CPU, and a
    [rows, steps] mask of them."""
    import numpy as np
    steps, sources = ties.shape
    clean = [int(np.argmax(ties[:, g])) if ties[:, g].any() else steps
             for g in range(sources)]
    mask = np.zeros((sources * beam, steps), bool)
    for g, n in enumerate(clean):
        mask[g * beam:(g + 1) * beam, :n] = True
    return clean, mask


def _compare_beams(card, cpu, ties, beam):
    """A source whose card ids first differ from the CPU's at a step
    where the CPU's candidates tie within rounding is excused from there
    on (its ids before its first near tie are therefore equal): (excused
    places, unexcused sources)."""
    import numpy as np
    card = card.reshape(card.shape[0], -1)
    cpu = cpu.reshape(cpu.shape[0], -1)
    excused, bad = [], []
    for g in range(ties.shape[1]):
        rows = slice(g * beam, (g + 1) * beam)
        diff = np.nonzero((card[rows] != cpu[rows]).any(0))[0]
        if not diff.size:
            continue
        s = int(diff[0])
        (excused if ties[s, g] else bad).append([g, s])
    return excused, bad


def _viterbi_margins(emission, transition, lens):
    """Per row, the least gap between the CPU's best and second-best
    candidates over the decisions its Viterbi path takes (each step's
    predecessor of the path's tag, and the last tag), relative to the
    larger, in float64."""
    import numpy as np
    e = np.asarray(emission, np.float64)
    tr = np.asarray(transition, np.float64)
    margins = []
    for b in range(e.shape[0]):
        n = max(int(lens[b]), 1)
        alpha, gaps, bps = tr[0] + e[b, 0], [], []
        for t in range(1, n):
            s = alpha[:, None] + tr[2:]
            bps.append(s)
            alpha = s.max(0) + e[b, t]
        fin = np.sort(alpha + tr[1])[::-1]
        gaps.append((fin[0] - fin[1]) / max(abs(fin[0]), 1e-30))
        tag = int(np.argmax(alpha + tr[1]))
        for s in reversed(bps):
            col = np.sort(s[:, tag])[::-1]
            gaps.append((col[0] - col[1]) / max(abs(col[0]), 1e-30))
            tag = int(np.argmax(s[:, tag]))
        margins.append(min(gaps))
    return np.array(margins)


def phase_decode_lockstep(fluid):
    """The three decoding programs in lockstep with the CPU, the beam and
    tagging requests replayed op by op and run whole, and the five
    controls (checks: no launch counted)."""
    import numpy as np
    import torch
    from unittest import mock
    from paddle_tpu_torch.fluid.ops import registry
    tool = _dec_tool()
    t0 = time.perf_counter()
    results = {}
    patch = lambda **kw: mock.patch.dict(registry._LOWERINGS, **kw)
    # the book's MT: training steps, then the beam search from the CPU's
    # startup state
    mt = tool.book_machine_translation(fluid, seed=SEED)
    feeds = [tool.mt_batch(SEED + 200 + k)
             for k in range(DEC_PARITY_STEPS["book_machine_translation"])]
    _, rec, ok = _lockstep(fluid, mt[:3], feeds)
    results["book_machine_translation"] = dict(rec, ok=ok)
    scope = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(mt.startup, scope=scope)
    beam = tool.MT_BEAM
    dec = tool.mt_decoder(fluid)
    state = {n: scope.get(n) for n, v in dec.main.global_block().vars.items()
             if v.persistable and scope.get(n) is not None}
    feed = tool.mt_request(SEED + 210)
    fetch = [dec.ids.name, dec.scores.name, dec.sentences.name]
    rec, ok, vals = _replay_program(fluid, dec.main, fetch, state, feed)
    results["beam_search_replayed"] = dict(rec, ok=ok)
    for name, lowering, op_type in (
            ("beam_search_top_1_of_each_row", _per_row_top1, "beam_search"),
            ("beam_search_decode_one_step_late", _backtrack_one_step_late,
             "beam_search_decode")):
        with patch(**{op_type: lowering}):
            rec, passed, _ = _replay_program(fluid, dec.main, fetch, state,
                                             feed)
        results["control_" + name] = dict(rec, ok=_named_miss(
            rec, passed, "int64", (op_type,)))
    card_scope = fluid.Scope()
    for n, t in state.items():
        card_scope.set(n, t.to("cuda", copy=True))
    card = _decode_request(fluid, dec, fluid.Executor(), card_scope, feed)
    ties = _beam_near_ties(dec, vals, feed, beam["beam"])
    ids = [a.reshape(a.shape[0], -1) for a in (
        card[dec.ids.name], np.asarray(vals[dec.ids.name]))]
    scores = [a.reshape(a.shape[0], -1) for a in (
        card[dec.scores.name], np.asarray(vals[dec.scores.name]))]
    excused, bad = _compare_beams(ids[0], ids[1], ties, beam["beam"])
    # before a source's first near tie its ids are held exactly and its
    # scores within the float tolerance; after it, only a difference that
    # starts at a non-tie is caught
    clean, mask = _clean_steps(ties, beam["beam"])
    clean_rel = _rel_max(scores[0][mask], scores[1][mask]) \
        if mask.any() else 0.0
    same = ~(ids[0] != ids[1]).any(1)
    score_rel = _rel_max(scores[0][same], scores[1][same]) \
        if same.any() else 0.0
    tol = RESNET_OP_TOL["float32"]
    results["beam_search_whole_request"] = {
        "decisions": int(ties.size),
        "near_tie_places_at_the_cpu": int(ties.sum()),
        "near_tie_rel": NEAR_TIE_REL,
        "steps_before_each_sources_first_near_tie": clean,
        "ids_equal_before_the_first_near_tie": bool(
            (ids[0][mask] == ids[1][mask]).all()),
        "scores_rel_err_before_the_first_near_tie": clean_rel,
        "sources_differing_after_a_near_tie": excused,
        "sources_differing_otherwise": bad,
        "rows_with_equal_ids": int(same.sum()),
        "scores_rel_err_on_equal_rows": score_rel,
        "ok": not bad and sum(clean) > 0 and clean_rel <= tol and
        score_rel <= tol and bool((ids[0][mask] == ids[1][mask]).all())}
    del scope, card_scope, state, vals
    torch.cuda.empty_cache()
    # the book's SRL: training steps, the controls, the crf_decoding
    # request whole
    srl = tool.book_label_semantic_roles(fluid, seed=SEED)
    feeds = [tool.srl_batch(SEED + 220 + k)
             for k in range(DEC_PARITY_STEPS["book_label_semantic_roles"])]
    _, rec, ok = _lockstep(fluid, srl[:3], feeds)
    results["book_label_semantic_roles"] = dict(rec, ok=ok)
    with patch(linear_chain_crf=_crf_without_stop,
               linear_chain_crf_grad=_crf_grad_without_stop):
        _, rec, passed = _lockstep(fluid, srl[:3], feeds[:1])
    results["control_crf_forward_without_stop"] = dict(rec, ok=_named_miss(
        rec, passed, "float32", ("linear_chain_crf",
                                 "linear_chain_crf_grad")))
    # the tagging request: replayed, its control, and whole
    scope = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(srl.startup, scope=scope)
    state = {n: scope.get(n) for n, v in srl.main.global_block().vars.items()
             if v.persistable and scope.get(n) is not None}
    tagger = tool.srl_tagger(srl)
    feed = tool.srl_batch(SEED + 230)
    rec, ok, vals = _replay_program(fluid, tagger, [srl.out.name], state,
                                    feed)
    results["tagging_replayed"] = dict(rec, ok=ok)
    with patch(crf_decoding=_viterbi_without_stop):
        rec, passed, _ = _replay_program(fluid, tagger, [srl.out.name],
                                         state, feed)
    results["control_viterbi_without_stop"] = dict(rec, ok=_named_miss(
        rec, passed, "int64", ("crf_decoding",)))
    crf = next(op for op in tagger.global_block().ops
               if op.type == "crf_decoding")
    cpu_path = np.asarray(vals[srl.out.name])
    emission = np.asarray(vals[crf.input("Emission")[0]])
    card_scope = fluid.Scope()
    for n, t in state.items():
        card_scope.set(n, t.to("cuda", copy=True))
    card_path, = fluid.Executor().run(tagger, feed=feed,
                                      fetch_list=[srl.out.name],
                                      scope=card_scope)
    margins = _viterbi_margins(emission, scope.get("crfw").numpy(),
                               feed["word_data@LEN"])
    differ = np.nonzero((card_path != cpu_path).any(1))[0]
    results["tagging_whole_request"] = {
        "rows": int(card_path.shape[0]),
        "rows_differing": differ.tolist(),
        "least_margin": float(margins.min()),
        "near_tie_rows_at_the_cpu": int((margins <= NEAR_TIE_REL).sum()),
        "ok": all(margins[r] <= NEAR_TIE_REL for r in differ)}
    del scope, card_scope, state, vals
    # word2vec with NCE, the card drawing the CPU's negatives
    w2v = tool.word2vec_nce(fluid, seed=SEED)
    feeds = [tool.w2v_batch(SEED + 240 + k)
             for k in range(DEC_PARITY_STEPS["word2vec_nce"])]
    with patch(nce=_on_cpu_draws()):
        _, rec, ok = _lockstep(fluid, w2v[:3], feeds)
    results["word2vec_nce"] = dict(rec, ok=ok)
    with patch(nce=_on_cpu_draws(bias_on_negatives=False)):
        _, rec, passed = _lockstep(fluid, w2v[:3], feeds[:1])
    # the bias starts at 0, so the forward is the same at the first step
    # and the nce op's gradient (the bias's, which the negatives' terms
    # feed) shows it
    results["control_nce_without_the_negatives_bias"] = dict(
        rec, ok=_named_miss(rec, passed, "float32", ("nce", "grad_of:nce")))
    failed = [k for k, r in results.items() if not r["ok"]]
    emit({"phase": "decode_lockstep", "ok": not failed, "card": _card(),
          "steps": DEC_PARITY_STEPS, "results": results,
          "phase_seconds": time.perf_counter() - t0})
    if failed:
        raise AssertionError("decode_lockstep: %s failed" % failed)


def decoding_phases(fluid, counters, add):
    """The decoding slice's phases, each with its launches added."""
    add(phase_book_machine_translation(fluid, counters))
    add(phase_book_label_semantic_roles(fluid, counters))
    add(phase_word2vec_nce(fluid, counters))
    phase_decode_lockstep(fluid)


# ---- CTC and index pooling: CRNN-CTC, SegNet-Basic, SPP-net ----

# crnn_ctc: tools/torch_ctc_pool_programs.py's CRNN at the public model's
# widths (CRNN: gray images 1 x 48 x 512, 95 classes and the blank, T 64,
# labels up to 24, batch 32, Momentum: no port kernel): a _window of
# CTC_STEPS, the evaluator.EditDistance states and eval() after it (the
# warm step and the window: (CTC_STEPS + 1) * 32 sequences), the true
# distance (edit_distance with both lengths) over the window; busy share
# and device kernels a step, host syncs a step (none in ctc_pool_ops.py
# or metric_ops.py: the CTC recursion and the edit distances' DP run on
# the card); then CTC_REQUESTS decode requests of a batch from the trained
# scope (the for_test program pruned to the decoder, tool.crnn_decoder).
CTC_STEPS = 4
CTC_REQUESTS = 4
# segnet_basic: SegNet-Basic at CamVid's shapes (3 x 352 x 480, 11
# classes, batch 12): a _window of SEG_STEPS with mean_iou each step (its
# wrong and correct counts must add up to the batch's pixels), images/s,
# model TFLOP/s (convolutions, forward x 3); busy share, host syncs.
SEG_STEPS = 3
# spp_net: SPP-net ZF-5 at 224 (batch 64): a _window of SPP_STEPS,
# images/s, model TFLOP/s (convolutions and fc, forward x 3), busy share.
SPP_STEPS = 4
# ctc_pool_chain: tools/torch_ctc_pool_programs.py's chain of the cases the
# three models do not reach, each at its named shape (tool.CHAIN: C3D's
# pool1, SegNet's uncropped 45 x 60 -> 23 x 30 map, ResNet-50's stem and
# last maps, unpool over repeated indices, spp by average at SPP-net's
# conv5, warpctc, ctc_align and edit_distance at CRNN's shapes,
# precision_recall over 1,000 classes; SGD: no port kernel): a _window of
# CHAIN_STEPS with its outputs checked (every Mask inside its plane, the
# infeasible CTC row within CHAIN_INFEASIBLE of 1e5 and the others below
# it, the unnormalized distances whole numbers, precision_recall's states
# counting every example of the warm step and the window); busy share,
# device kernels and host syncs a step.
CHAIN_STEPS = 3
CHAIN_INFEASIBLE = (1e5, 1.01e5)
# ctc_pool_lockstep: each program at CTC_PARITY's widths, CTC_PARITY_STEPS
# steps in lockstep with the CPU (_lockstep: every op replayed within
# RESNET_OP_TOL, ints exact, the outputs of CTC_EXACT_OPS bit for bit,
# losses within OPT_LOSS_REL_MAX), the windows with tied maxima at the
# CPU counted for each index pool (the Mask is held exact there too);
# the gradients of a convolution's bias that a batch_norm follows, which
# cancel to rounding noise, held to CANCEL_NOISE times the CPU's own error
# against float64. Controls, each of which must miss with its op's output
# the worst of its dtype: CTC allowing the skip between equal labels (the
# chain's labels repeat in row 1), the index pools' gradient sent whole
# to the first maximum (the chain's inputs hold tied positive maxima),
# unpool where the first write wins, edit_distance normalized by the
# hypothesis's length, ctc_align not merging repeats.
CTC_PARITY_STEPS = 2
CTC_PARITY = {
    "crnn_ctc": dict(image=[1, 48, 128], channels=[8, 16, 16, 32],
                     hidden=32, classes=95, max_label=8, batch=4),
    "segnet_basic": dict(image=[3, 64, 96], channels=16, kernel=7,
                         classes=11, batch=2),
    "spp_net": dict(image=[3, 112, 112], channels=[16, 32, 32, 32, 32],
                    fc=64, classes=100, pyramid=3, dropout=0.0, batch=4),
    "ctc_pool_chain": dict(pool3d=[1, 8, 4, 16, 16], adaptive=[2, 8, 45, 60],
                           adaptive_out=[23, 30], padded=[2, 8, 16, 16],
                           global_=[2, 16, 7, 7], unpool=[2, 8, 14, 14],
                           spp=[2, 16, 13, 13], ctc=[4, 16, 12], ctc_in=8,
                           max_label=6, short=4, ignored=[1, 2],
                           pr_classes=1000, pr_batch=16, pr_in=16)}
CTC_EXACT_OPS = ("max_pool2d_with_index", "max_pool3d_with_index", "unpool",
                 "ctc_align", "edit_distance", "arg_max")
INDEX_POOLS = ("max_pool2d_with_index", "max_pool3d_with_index")
# the slice's lowerings, where no host read may be
SLICE_LOWERINGS = ("paddle_tpu_torch/fluid/ops/ctc_pool_ops.py",
                   "paddle_tpu_torch/fluid/ops/metric_ops.py")


def _ctc_tool():
    return _load_tool("torch_ctc_pool_programs")


def _slice_syncs(places, lowerings=SLICE_LOWERINGS):
    """The places of `places` inside a slice's `lowerings`."""
    return [p for p in places if p.startswith(lowerings)]


def phase_crnn_ctc(fluid, counters):
    """CRNN-CTC at the public model's widths: a _window with the
    evaluator's and the true edit distances, the step's busy share and
    host syncs, then CTC_REQUESTS decode requests from the trained scope.
    Returns the window's launches."""
    import numpy as np
    tool = _ctc_tool()
    t0 = time.perf_counter()
    w = tool.CRNN
    m = tool.crnn_ctc(fluid, seed=SEED)
    ev = m.extra["evaluator"]
    stacked = _stack_feeds([tool.crnn_batch(SEED + k)
                            for k in range(CTC_STEPS + 1)])
    kept = {}

    def scores(scope, extra):
        true, = extra
        kept["scope"] = scope
        with fluid.scope_guard(scope):
            avg, err = ev.eval(None)
        seqs = int(fluid.executor.as_numpy(scope.get(ev.seq_num.name))
                   .sum())
        true = true.float().cpu().numpy()
        rec = {"evaluator_avg_distance": float(avg[0]),
               "evaluator_instance_error": float(err[0]),
               "evaluator_sequences": seqs,
               "true_distance_mean": float(true.mean())}
        ok = seqs == (CTC_STEPS + 1) * w["batch"] and \
            bool(np.isfinite(true).all()) and 0.0 <= err[0] <= 1.0 and \
            bool(np.isfinite(avg[0]))
        return {"scores": rec}, bool(ok)
    launched = _window(
        "crnn_ctc", fluid, counters, m[:3],
        {k: v[:1] for k, v in stacked.items()},
        {k: v[1:] for k, v in stacked.items()}, CTC_STEPS,
        dict.fromkeys(counters, 0), None,
        {"build_seconds": time.perf_counter() - t0, "card": _card(),
         "widths": w, "frames": tool.crnn_frames(w)[0],
         "ops": len(m.main.global_block().ops)},
        {"images": w["batch"]}, ([m.extra["distance"]], scores))
    _slice_step_phase("crnn_ctc", fluid, m, stacked)
    t0 = time.perf_counter()
    dec = tool.crnn_decoder(m)
    feeds = [{"pixel": tool.crnn_batch(SEED + 60 + k)["pixel"]}
             for k in range(CTC_REQUESTS)]
    fetch = [m.out, m.extra["decoded_length"]]
    rec = _serve_requests(fluid, counters, dec, kept["scope"], feeds, fetch,
                          w["batch"])
    ids, lens = fluid.Executor().run(dec, feed=feeds[0], fetch_list=fetch,
                                     scope=kept["scope"])
    frames = tool.crnn_frames(w)[0]
    rec.update({"ops": len(dec.global_block().ops),
                "images_per_s": w["batch"] / rec["ms_mean"] * 1e3,
                "in_the_slices_lowerings": _slice_syncs(
                    rec["host_sync_places"]),
                "ids_shape": list(ids.shape),
                "lengths": [int(v) for v in lens],
                "ids_in_range": bool(((ids >= 0) & (ids < w["classes"]))
                                     .all()),
                "lengths_in_range": bool(((lens >= 0) & (lens <= frames))
                                         .all())})
    rec["ok"] = rec["ok"] and rec["ids_in_range"] and \
        rec["lengths_in_range"] and list(ids.shape) == [w["batch"], frames]
    del kept
    emit(dict({"phase": "crnn_ctc_decode", "card": _card(),
               "phase_seconds": time.perf_counter() - t0}, **rec))
    if not rec["ok"]:
        raise AssertionError("crnn_ctc: the decode requests failed %s" % rec)
    return launched


def phase_segnet_basic(fluid, counters):
    """SegNet-Basic at CamVid's shapes: a _window with mean_iou each step,
    images/s and model TFLOP/s, busy share, host syncs. Returns the
    window's launches."""
    import numpy as np
    tool = _ctc_tool()
    t0 = time.perf_counter()
    w = tool.SEGNET
    m = tool.segnet_basic(fluid, seed=SEED)
    flops = conv_flops_per_image(m.main)
    stacked = _stack_feeds([tool.segnet_batch(SEED + k)
                            for k in range(SEG_STEPS + 1)])
    pixels = w["batch"] * w["image"][1] * w["image"][2]

    def scores(scope, extra):
        miou, wrong, correct = (v.cpu().numpy() for v in extra)
        counted = (wrong.astype(np.int64) + correct).sum(axis=-1)
        rec = {"mean_iou": miou.tolist(),
               "pixels_counted_a_step": counted.tolist()}
        ok = bool((counted == pixels).all()) and \
            bool(((miou >= 0) & (miou <= 1)).all())
        return {"scores": rec}, ok
    launched = _window(
        "segnet_basic", fluid, counters, m[:3],
        {k: v[:1] for k, v in stacked.items()},
        {k: v[1:] for k, v in stacked.items()}, SEG_STEPS,
        dict.fromkeys(counters, 0), None,
        {"build_seconds": time.perf_counter() - t0, "card": _card(),
         "widths": w, "ops": len(m.main.global_block().ops),
         "forward_gflop_per_image": flops / 1e9},
        {"images": w["batch"], "model_tflops": 3 * flops * w["batch"] / 1e12},
        ([m.out, m.extra["wrong"], m.extra["correct"]], scores))
    _slice_step_phase("segnet_basic", fluid, m, stacked)
    return launched


def phase_spp_net(fluid, counters):
    """SPP-net ZF-5 at 224: a _window with images/s and model TFLOP/s,
    busy share, host syncs. Returns the window's launches."""
    tool = _ctc_tool()
    t0 = time.perf_counter()
    w = tool.SPP
    m = tool.spp_net(fluid, seed=SEED)
    flops = conv_flops_per_image(m.main)
    stacked = _stack_feeds([tool.spp_batch(SEED + k)
                            for k in range(SPP_STEPS + 1)])
    launched = _window(
        "spp_net", fluid, counters, m[:3],
        {k: v[:1] for k, v in stacked.items()},
        {k: v[1:] for k, v in stacked.items()}, SPP_STEPS,
        dict.fromkeys(counters, 0), None,
        {"build_seconds": time.perf_counter() - t0, "card": _card(),
         "widths": w, "ops": len(m.main.global_block().ops),
         "pyramid_features": m.extra["features"].shape[1],
         "forward_gflop_per_image": flops / 1e9},
        {"images": w["batch"], "model_tflops": 3 * flops * w["batch"] / 1e12})
    _slice_step_phase("spp_net", fluid, m, stacked)
    return launched


def phase_ctc_pool_chain(fluid, counters):
    """The chain at CHAIN's widths: a _window with its outputs checked,
    then its _step phase. Returns the window's launches."""
    import numpy as np
    tool = _ctc_tool()
    t0 = time.perf_counter()
    w = tool.CHAIN
    m = tool.ctc_pool_chain(fluid, seed=SEED)
    ex = m.extra
    stacked = _stack_feeds([tool.chain_batch(SEED + k)
                            for k in range(CHAIN_STEPS + 1)])
    planes = {k: int(np.prod(w[s][2:])) for k, s in (
        ("pool3d_mask", "pool3d"), ("adaptive_mask", "adaptive"),
        ("padded_mask", "padded"), ("global_mask", "global_"),
        ("unpool_mask", "unpool"))}
    fetch = [ex["ctc_infeasible"], ex["distance"], ex["pr_accum"]] + \
        [ex[k] for k in planes]

    def scores(scope, extra):
        ctc, dist, accum, *masks = (v.cpu().numpy() for v in extra)
        states = fluid.executor.as_numpy(scope.get("pr_states"))
        inside = {k: bool(((v >= 0) & (v < planes[k])).all())
                  for k, v in zip(planes, masks)}
        rec = {"infeasible_row_loss": ctc[:, 0, 0].tolist(),
               "feasible_rows_loss_max": float(ctc[:, 1:].max()),
               "distance_max": float(dist.max()),
               "pr_accum_metrics": accum[-1].tolist(),
               "pr_examples_counted": float(states[:, :2].sum()),
               "masks_inside_their_planes": inside}
        lo, hi = CHAIN_INFEASIBLE
        ok = all(inside.values()) and \
            bool(((ctc[:, 0] > lo) & (ctc[:, 0] < hi)).all()) and \
            bool((ctc[:, 1:] < lo).all()) and \
            bool((dist == np.round(dist)).all()) and \
            bool(((dist >= 0) & (dist <= max(w["ctc"][1], w["max_label"])))
                 .all()) and \
            bool(((accum >= 0) & (accum <= 1)).all()) and \
            rec["pr_examples_counted"] == (CHAIN_STEPS + 1) * w["pr_batch"]
        return {"scores": rec}, ok
    launched = _window(
        "ctc_pool_chain", fluid, counters, m[:3],
        {k: v[:1] for k, v in stacked.items()},
        {k: v[1:] for k, v in stacked.items()}, CHAIN_STEPS,
        dict.fromkeys(counters, 0), None,
        {"build_seconds": time.perf_counter() - t0, "card": _card(),
         "widths": w, "ops": len(m.main.global_block().ops)},
        {"chains": 1}, (fetch, scores))
    _slice_step_phase("ctc_pool_chain", fluid, m, stacked)
    return launched


def _slice_step_phase(name, fluid, model, stacked, lowerings=SLICE_LOWERINGS):
    """Phase `name`_step: busy share (with the top kernels), device kernels
    and host syncs of a step of `model`; it fails if a sync lies in the
    slice's `lowerings`."""
    t0 = time.perf_counter()
    busy = _busy_named(fluid, model, {k: v[0] for k, v in stacked.items()})
    busy["device_kernels_a_step"] = sum(
        c for _, c in busy["device_ms_by_kind"].values())
    syncs = _step_syncs(fluid, model, stacked)
    syncs["in_the_slices_lowerings"] = _slice_syncs(syncs["places"],
                                                    lowerings)
    ok = not syncs["in_the_slices_lowerings"]
    emit({"phase": name + "_step", "ok": ok, "card": _card(), "busy": busy,
          "step_host_syncs": syncs,
          "phase_seconds": time.perf_counter() - t0})
    if not ok:
        raise AssertionError("%s: host syncs in the slice's lowerings %s"
                             % (name, syncs))


def _on_card_patched(lowering, module, attr, replacement):
    """`lowering` with module.`attr` replaced by `replacement` while it runs
    on the card (a control). CPU tensors take the real lowering."""
    from unittest import mock

    def lower(ctx, inputs, attrs):
        if ctx.device.type != "cuda":
            return lowering(ctx, inputs, attrs)
        with mock.patch.object(module, attr, replacement):
            return lowering(ctx, inputs, attrs)
    return lower


def _no_repeats(label):
    """label_repeats all 0: the skip between equal labels allowed."""
    import torch
    return torch.zeros(label.shape, device=label.device)


def _first_max_only(windows, positions):
    """max_with_index with each window's Out its first maximum alone, so
    that the whole gradient goes there."""
    import torch
    arg = windows.argmax(dim=-1, keepdim=True)
    mask = torch.gather(positions.expand(windows.shape), -1, arg)[..., 0]
    return torch.gather(windows, -1, arg)[..., 0], mask.int()


def _first_write_wins(idx, size):
    """unpool_winners with the first source in input order winning."""
    import torch
    n, c, k = idx.shape
    ordinal = torch.arange(k, device=idx.device).expand(n, c, k)
    first = torch.full((n, c, size), k, dtype=torch.int64,
                       device=idx.device).scatter_reduce(
        2, idx.long(), ordinal, reduce="amin", include_self=True)
    return torch.where(first < k, first, -1)


def _edit_distance_by_hyp_length(ctx, inputs, attrs):
    """edit_distance on the card normalized by the hypothesis's length (a
    control). CPU tensors take the real lowering."""
    from paddle_tpu_torch.fluid.ops import ctc_pool_ops as C
    hyp = inputs["Hyps"][0]
    if not hyp.is_cuda or not attrs.get("normalized", True):
        return C._edit_distance(ctx, inputs, attrs)
    out = C._edit_distance(ctx, inputs, dict(attrs, normalized=False))
    hlen = C._lengths((inputs.get("HypsLength") or [None])[0],
                      hyp.shape[0], hyp.shape[1], hyp.device)
    out["Out"] = [out["Out"][0] / hlen.float().clamp(min=1.0)[:, None]]
    return out


def _ctc_controls():
    """{program: {control: ({op type: lowering}, dtype, named op types)}}
    for ctc_pool_lockstep."""
    from paddle_tpu_torch.fluid.ops import ctc_pool_ops as C
    pools = {op: _on_card_patched(C._max_pool2d_with_index if "2d" in op
                                  else C._max_pool3d_with_index, C,
                                  "max_with_index", _first_max_only)
             for op in INDEX_POOLS}
    no_merge = _on_the_card(C._ctc_align, lambda i, a: (
        i, dict(a, merge_repeated=False)))
    return {
        "ctc_pool_chain": {
            "ctc_skip_between_equal_labels": (
                {"warpctc": _on_card_patched(C._warpctc, C, "label_repeats",
                                             _no_repeats)},
                "float32", ("warpctc", "grad_of:warpctc")),
            "pool_gradient_to_the_first_maximum": (
                pools, "float32",
                tuple("grad_of:" + op for op in INDEX_POOLS)),
            "unpool_first_write_wins": (
                {"unpool": _on_card_patched(C._unpool, C, "unpool_winners",
                                            _first_write_wins)},
                "float32", ("unpool", "grad_of:unpool"))},
        "crnn_ctc": {
            "edit_distance_by_the_hypothesis_length": (
                {"edit_distance": _edit_distance_by_hyp_length},
                "float32", ("edit_distance",)),
            "ctc_align_without_merging": (
                {"ctc_align": no_merge}, "int32", ("ctc_align",))}}


def _conv_biases_before_batch_norm(main):
    """The gradients of each convolution bias that a batch_norm follows: 0
    by construction, rounding noise in float32."""
    block = main.global_block()
    params = {p.name for p in main.all_parameters()}
    bn_inputs = {op.input("X")[0] for op in block.ops
                 if op.type == "batch_norm"}
    return tuple(sorted(op.input("Y")[0] + "@GRAD" for op in block.ops
                        if op.type == "elementwise_add" and
                        op.output("Out")[0] in bn_inputs and
                        op.input("Y")[0] in params))


def _tied_windows(fluid, main, startup, feed):
    """{Mask name: [windows, windows whose maximum the CPU sees more than
    once]} for each index pool of one CPU step of `main` from the
    startup."""
    import torch
    from paddle_tpu_torch.fluid.ops import ctc_pool_ops as C
    block = main.global_block()
    pools = [op for op in block.ops if op.type in INDEX_POOLS]
    if not pools:
        return {}
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    xs = exe.run(main, feed=feed, fetch_list=[op.input("X")[0]
                                              for op in pools],
                 scope=scope, return_numpy=False)
    out = {}
    for op, x in zip(pools, xs):
        nd = x.dim() - 2
        windows, _ = C.pool_windows(
            x, list(op.attr("ksize")), list(op.attr("strides") or [1] * nd),
            list(op.attr("paddings") or [0] * nd),
            adaptive=op.attr("adaptive") or False,
            global_pool=op.attr("global_pooling") or False)
        top = windows.amax(dim=-1, keepdim=True)
        ties = (windows == top).sum(dim=-1) > 1
        out[op.output("Mask")[0]] = [int(ties.numel()), int(ties.sum())]
    return out


def phase_ctc_pool_lockstep(fluid):
    """The slice's four programs in lockstep with the CPU at CTC_PARITY's
    widths, with the five controls (checks: no launch counted)."""
    from unittest import mock
    from paddle_tpu_torch.fluid.ops import registry
    tool = _ctc_tool()
    t0 = time.perf_counter()
    results = {}
    controls = _ctc_controls()
    for name, (build, batch, _) in tool.PROGRAMS.items():
        widths = CTC_PARITY[name]
        m = build(fluid, seed=SEED, **widths)
        feeds = [batch(SEED + 300 + k, **widths)
                 for k in range(CTC_PARITY_STEPS)]
        cancelling = _conv_biases_before_batch_norm(m.main)
        _, rec, ok = _lockstep(fluid, m[:3], feeds, exact_ops=CTC_EXACT_OPS,
                               cancelling=cancelling)
        ties = _tied_windows(fluid, m.main, m.startup, feeds[0])
        results[name] = dict(rec, widths=widths, ok=ok,
                             tied_windows_at_the_cpu=ties)
        for cname, (lowerings, dtype, named) in controls.get(name,
                                                             {}).items():
            with mock.patch.dict(registry._LOWERINGS, **lowerings):
                _, rec, passed = _lockstep(fluid, m[:3], feeds[:1],
                                           exact_ops=CTC_EXACT_OPS,
                                           cancelling=cancelling)
            results["control_" + cname] = dict(rec, ok=_named_miss(
                rec, passed, dtype, named))
    failed = [k for k, r in results.items() if not r["ok"]]
    emit({"phase": "ctc_pool_lockstep", "ok": not failed, "card": _card(),
          "steps": CTC_PARITY_STEPS, "results": results,
          "phase_seconds": time.perf_counter() - t0})
    if failed:
        raise AssertionError("ctc_pool_lockstep: %s failed" % failed)


def ctc_pool_phases(fluid, counters, add):
    """The CTC and index-pooling slice's phases, each with its launches
    added."""
    add(phase_crnn_ctc(fluid, counters))
    add(phase_segnet_basic(fluid, counters))
    add(phase_spp_net(fluid, counters))
    add(phase_ctc_pool_chain(fluid, counters))
    phase_ctc_pool_lockstep(fluid)


# ---- object detection (tools/torch_detection_programs.py) -------------------
# mobilenet_ssd: MobileNet-SSD at its published widths (VOC: 3 x 300 x 300,
# 21 classes, batch 64, RMSProp): a _window of SSD_STEPS, images/s, then
# its _step phase (busy share, kernels a step, host syncs: none may lie
# in detection_ops.py); then SSD_REQUESTS detect requests of 64 images
# from the trained scope through the inference program, timed, with
# evaluator.DetectionMAP accumulating over them (its state reset first)
# and metrics.DetectionMAP fed the fetched detections: the two mAPs must
# agree, and every detection row must be padding (label -1) or a class
# with a score in (0, 1] and a finite box.
SSD_STEPS = 3
SSD_REQUESTS = 4
# faster_rcnn: Faster R-CNN ResNet-50-C4 on one 800 x 1216 image
# (Momentum): a _window of FRCNN_STEPS, its _step phase, then one
# inference request (generate_proposals 6,000 / 1,000, per-class decode,
# multiclass_nms): detections [1, 100, 6], timed, busy share, syncs.
FRCNN_STEPS = 2
# detection_chain: the tool's chain at CHAIN's widths (SGD): a _window of
# DET_CHAIN_STEPS with its outputs checked (finite yolo boxes and scores
# in [0, 1], mask targets in {-1, 0, 1}, every proposal at a row of its
# own in RestoreIndex), then its _step phase.
DET_CHAIN_STEPS = 3
# detection_lockstep: each program at DET_PARITY's widths, DET_PARITY_STEPS
# steps in lockstep with the CPU (_lockstep: every op replayed within
# RESNET_OP_TOL, integers exact, the outputs of DET_EXACT_OPS bit for bit,
# the loss within OPT_LOSS_REL_MAX); the batch norms' scale and bias
# gradients, sums that cancel to rounding noise, held to CANCEL_NOISE times
# the CPU's own error against float64; the chain's outputs that its loss
# does not read (which the step's plan leaves out) and each model's detect
# program
# replayed op by op from the CPU's values (_replay_program); MobileNet-
# SSD's evaluator over DET_MAP_REQUESTS requests on the card and on the CPU
# from the same state: its positive counts and tp / fp rows' classes
# equal, the scores and mAPs within MAP_REL_MAX. Controls, each of which
# must miss with its op's output the worst of its dtype:
# generate_proposals without suppression, bipartite_match without its
# per-prediction fill, roi_align sampling at the bins' corners, box_coder
# without its +1 pixel (_box_coder_control: Faster R-CNN's decode alone on
# inputs of a trained model's size), yolov3_loss with
# ignore_thresh off (the chain's heads at 608, where some predictions
# overlap a gt box by more than 0.7), roi_pool's Argmax the last of tied
# maxima (the chain's map after ReLU holds tied zeros).
DET_PARITY_STEPS = 1
DET_MAP_REQUESTS = 2
MAP_REL_MAX = 1e-4
DET_PARITY = {
    "mobilenet_ssd": dict(image=[3, 96, 96], classes=5, scale=0.25,
                          repeats=2, max_gt=6, objects=4, batch=8),
    "faster_rcnn": dict(image=[3, 128, 192], classes=9, gt=4, channels=8,
                        depth=[1, 2, 2], head_depth=1, rpn_channels=32,
                        pre_nms=600, post_nms=100, test_pre_nms=300,
                        test_post_nms=50, rpn_batch=64, roi_batch=32,
                        resolution=7, use_random=False),
    "detection_chain": dict(pooled=3, yolo_batch=2, yolo_image=608,
                            yolo_classes=80, yolo_gt=50, vgg=[2, 8, 12, 14],
                            vgg_rois=10, rfcn=[1, 18, 12, 14],
                            rfcn_classes=2, rfcn_rois=8, face_map=8,
                            face_image=256, east=[2, 8, 16, 16],
                            text=[1, 4, 16, 16], quads=6, text_out=[4, 8],
                            cascade_rois=16, cascade_classes=6, fpn_rois=40,
                            mask_rois=12, mask_gt=4, mask_vertices=8,
                            mask_classes=6, mask_res=7, p2=[16, 24])}
DET_EXACT_OPS = ("bipartite_match", "target_assign", "mine_hard_examples",
                 "multiclass_nms", "distribute_fpn_proposals",
                 "generate_mask_labels", "box_clip")
DET_LOWERINGS = ("paddle_tpu_torch/fluid/ops/detection_ops.py",)


def _det_tool():
    return _load_tool("torch_detection_programs")


def _det_window(name, fluid, counters, m, t0, batch, steps, work,
                check=None, lowerings=DET_LOWERINGS, info=None, want=None,
                adam_tensors=None):
    """Model `m` (built since `t0`) at full width through _window (`want`
    launches a step, none by default; an Adam launch covering
    `adam_tensors`), then its _step phase (host syncs in the slice's
    `lowerings`); `info` adds to the window's line. Returns (launches, the
    trained scope)."""
    stacked = _stack_feeds([batch(SEED + k) for k in range(steps + 1)])
    kept = {}
    fetch, fn = check or ([], None)

    def keep(scope, extra):
        kept["scope"] = scope
        return fn(scope, extra) if fn else ({}, True)
    launched = _window(
        name, fluid, counters, m[:3], {k: v[:1] for k, v in stacked.items()},
        {k: v[1:] for k, v in stacked.items()}, steps,
        want or dict.fromkeys(counters, 0), adam_tensors,
        dict({"build_seconds": time.perf_counter() - t0, "card": _card(),
              "ops": len(m.main.global_block().ops)}, **(info or {})),
        work, (fetch, keep))
    _slice_step_phase(name, fluid, m, stacked, lowerings)
    return launched, kept["scope"]


def _detect_requests(fluid, counters, program, scope, feeds, fetch, images,
                     lowerings=DET_LOWERINGS):
    """_serve_requests of an inference program, with its peak memory and
    its host syncs in the slice's `lowerings` (none may be: the
    detection_map host op reads the card by design, in
    fluid/host_ops.py)."""
    import torch
    torch.cuda.reset_peak_memory_stats()
    rec = _serve_requests(fluid, counters, program, scope, feeds, fetch,
                          images)
    rec["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    rec["in_the_slices_lowerings"] = _slice_syncs(rec["host_sync_places"],
                                                  lowerings)
    rec["images_per_s"] = rec.pop("tokens_per_s")
    rec["images_a_request"] = rec.pop("tokens_a_request")
    rec.pop("host_syncs_in_the_search")
    rec["ok"] = not any(rec["port_launches"].values()) and \
        not rec["in_the_slices_lowerings"]
    return rec


def _detections_ok(det, classes):
    """Every row padding (label -1) or a class with a score in (0, 1] and
    a finite box."""
    import numpy as np
    label, score = det[..., 0], det[..., 1]
    real = label >= 0
    return bool(np.isfinite(det).all()) and \
        bool(((label == -1) | ((label < classes) & (label == np.round(
            label)))).all()) and bool(((score[real] > 0) &
                                       (score[real] <= 1)).all())


def phase_mobilenet_ssd(fluid, counters):
    """MobileNet-SSD: training window, step phase, SSD_REQUESTS detect
    requests with both DetectionMAPs. Returns the window's launches."""
    import numpy as np
    tool = _det_tool()
    w = tool.SSD
    t0 = time.perf_counter()
    m = tool.mobilenet_ssd(fluid, seed=SEED)
    launched, scope = _det_window("mobilenet_ssd", fluid, counters, m, t0,
                                  tool.ssd_batch, SSD_STEPS,
                                  {"images": w["batch"]})
    t0 = time.perf_counter()
    infer = m.extra["infer"]
    ev = infer.extra["evaluator"]
    exe = fluid.Executor()
    exe.run(infer.startup, scope=scope)
    feeds = [tool.ssd_batch(SEED + 60 + k) for k in range(SSD_REQUESTS)]
    fetch = [infer.out] + infer.extra["maps"]
    rec = _detect_requests(fluid, counters, infer.main, scope, feeds, fetch,
                           w["batch"])
    with fluid.scope_guard(scope):
        ev.reset(exe)
    metric = fluid.metrics.DetectionMAP(overlap_threshold=0.5,
                                        evaluate_difficult=False,
                                        ap_version="11point")
    dets_ok, maps = True, []
    for f in feeds:
        det, cur, accum = exe.run(infer.main, feed=f, fetch_list=fetch,
                                  scope=scope)
        gt = np.concatenate([f["gt_label"].astype(np.float32), f["gt_box"],
                             f["difficult"].astype(np.float32)], -1)
        metric.update(det, gt)
        maps.append([float(cur[0]), float(accum[0]), metric.eval()])
        dets_ok = dets_ok and _detections_ok(det, w["classes"]) and \
            det.shape == (w["batch"], 200, 6)
    agree = abs(maps[-1][1] - maps[-1][2]) <= 1e-6
    rec.update({"ops": len(infer.main.global_block().ops),
                "maps_batch_accum_metrics": maps,
                "evaluator_equals_metrics": agree,
                "detections_well_formed": dets_ok})
    rec["ok"] = rec["ok"] and agree and dets_ok
    emit(dict({"phase": "mobilenet_ssd_detect", "card": _card(),
               "phase_seconds": time.perf_counter() - t0}, **rec))
    if not rec["ok"]:
        raise AssertionError("mobilenet_ssd: the detect requests failed %s"
                             % rec)
    return launched


def phase_faster_rcnn(fluid, counters):
    """Faster R-CNN: training window, step phase, one inference request.
    Returns the window's launches."""
    tool = _det_tool()
    w = tool.FRCNN
    t0 = time.perf_counter()
    m = tool.faster_rcnn(fluid, seed=SEED)
    launched, scope = _det_window("faster_rcnn", fluid, counters, m, t0,
                                  tool.frcnn_batch, FRCNN_STEPS,
                                  {"images": 1})
    t0 = time.perf_counter()
    infer = m.extra["infer"]
    f = tool.frcnn_batch(SEED + 60)
    feed = {k: f[k] for k in infer.feeds}
    rec = _detect_requests(fluid, counters, infer.main, scope, [feed],
                           [infer.out], 1)
    det, = fluid.Executor().run(infer.main, feed=feed, fetch_list=[infer.out],
                                scope=scope)
    ok = det.shape == (1, 100, 6) and _detections_ok(det, w["classes"])
    rec.update({"ops": len(infer.main.global_block().ops),
                "detections_well_formed": ok,
                "detections": int((det[..., 0] >= 0).sum())})
    rec["ok"] = rec["ok"] and ok
    emit(dict({"phase": "faster_rcnn_detect", "card": _card(),
               "phase_seconds": time.perf_counter() - t0}, **rec))
    if not rec["ok"]:
        raise AssertionError("faster_rcnn: the inference request failed %s"
                             % rec)
    return launched


def phase_detection_chain(fluid, counters):
    """The chain at CHAIN's widths: a _window with its outputs checked,
    then its _step phase. Returns the window's launches."""
    import numpy as np
    tool = _det_tool()
    w = tool.CHAIN

    def scores(scope, extra):
        boxes, probs, masks, restore = (v.cpu().numpy() for v in extra)
        rec = {"yolo_boxes_finite": bool(np.isfinite(boxes).all()),
               "yolo_scores_in_range": bool(((probs >= 0) & (probs <= 1))
                                            .all()),
               "mask_values": sorted(int(v) for v in np.unique(masks)),
               "every_roi_placed_once": all(
                   (r >= 0).all() and len(set(r.reshape(-1).tolist())) ==
                   w["fpn_rois"] for r in restore)}
        ok = rec["yolo_boxes_finite"] and rec["yolo_scores_in_range"] and \
            set(rec["mask_values"]) <= {-1, 0, 1} and \
            rec["every_roi_placed_once"]
        return {"scores": rec}, ok
    t0 = time.perf_counter()
    m = tool.detection_chain(fluid, seed=SEED)
    ex = m.extra
    fetch = [ex["yolo_boxes"][2], ex["yolo_scores"][2], ex["masks"][2],
             ex["fpn_restore"]]
    launched, _ = _det_window("detection_chain", fluid, counters, m, t0,
                              tool.chain_batch, DET_CHAIN_STEPS,
                              {"chains": 1}, (fetch, scores))
    return launched


def _bn_gradients(main):
    """The scale and bias gradients of main's batch norms: sums over a
    channel that cancel to rounding noise."""
    block = main.global_block()
    return tuple(sorted(op.input(s)[0] + "@GRAD" for op in block.ops
                        if op.type == "batch_norm" for s in ("Scale", "Bias")
                        if block.has_var(op.input(s)[0] + "@GRAD")))


def _no_suppression(iou, thresh):
    import torch
    return torch.ones(iou.shape[:-1], dtype=torch.bool, device=iou.device)


def _at_bin_corners(n, dtype, device):
    import torch
    return torch.arange(n, dtype=dtype, device=device) / n


def _last_maximum(forward):
    """roi_pool's `forward` with each bin's Argmax its last maximum in
    row-major order (the first of the map turned half round)."""
    def fn(x, bids, ymask, xmask):
        out, arg = forward(x.flip(2, 3), bids, ymask.flip(-1),
                           xmask.flip(-1))
        last = x.shape[2] * x.shape[3] - 1
        return out, arg.where(arg < 0, last - arg)
    return fn


def _box_coder_control(fluid, tool, widths):
    """Faster R-CNN's decode alone (box_coder decode_center_size in pixels,
    the regression weights as variances) replayed on the card from the
    CPU's values, then with box_normalized on the card, which drops its
    +1 pixel: {"box_coder_decode": readings, "control_box_coder_without_
    the_pixel": readings}. The inputs are of a trained model's size: 64
    RoIs of 16 to 96 pixels inside DET_PARITY's image and deltas N(0, 1)
    for each class (shifts of 10 to 20% of a RoI). The pixel moves a
    decoded corner by about var * delta of a pixel: replayed in the whole
    detect program it missed by 1.41e-4 of the largest corner against the
    1e-4 limit; on these inputs the CPU's two decodes differ by 2.7e-3 to
    3.6e-3 of it (seeds 0 to 4)."""
    import numpy as np
    from unittest import mock
    from paddle_tpu_torch.fluid.ops import detection_ops as D
    from paddle_tpu_torch.fluid.ops import registry
    L = fluid.layers
    r, c = 64, widths["classes"]
    h, w = widths["image"][1:]
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        rois = L.data(name="rois", shape=[r, 4], dtype="float32",
                      append_batch_size=False)
        deltas = L.data(name="deltas", shape=[c, r, 4], dtype="float32",
                        append_batch_size=False)
        weights = L.assign(np.tile(np.float32(tool.FRCNN_REG_WEIGHTS),
                                   (r, 1)))
        out = L.box_coder(rois, weights, deltas,
                          code_type="decode_center_size",
                          box_normalized=False)
    rng = np.random.RandomState(SEED + 360)
    sides = rng.uniform(16, 96, (r, 2))
    x0, y0 = rng.uniform(0, w - sides[:, 0]), rng.uniform(0, h - sides[:, 1])
    feed = {"rois": np.stack([x0, y0, x0 + sides[:, 0], y0 + sides[:, 1]],
                             1).astype(np.float32),
            "deltas": rng.randn(c, r, 4).astype(np.float32)}
    rec, ok, _ = _replay_program(fluid, main, [out.name], {}, feed)
    results = {"box_coder_decode": dict(rec, ok=ok)}
    plus_one = _on_the_card(D._box_coder, lambda i, a: (
        i, dict(a, box_normalized=True)))
    with mock.patch.dict(registry._LOWERINGS, box_coder=plus_one):
        rec, passed, _ = _replay_program(fluid, main, [out.name], {}, feed)
    results["control_box_coder_without_the_pixel"] = dict(
        rec, ok=_named_miss(rec, passed, "float32", ("box_coder",)))
    return results


def _det_controls():
    """{program: {control: ({op type: lowering}, dtype, named op types)}}
    for detection_lockstep."""
    from paddle_tpu_torch.fluid.ops import detection_ops as D
    return {
        "faster_rcnn": {
            "nms_without_suppression": (
                {"generate_proposals": _on_card_patched(
                    D._generate_proposals, D, "greedy_keep",
                    _no_suppression)},
                "float32", ("generate_proposals",)),
            "roi_align_at_bin_corners": (
                {"roi_align": _on_card_patched(D._roi_align, D,
                                               "sample_offsets",
                                               _at_bin_corners)},
                "float32", ("roi_align", "grad_of:roi_align"))},
        "mobilenet_ssd": {
            "bipartite_match_without_the_per_prediction_fill": (
                {"bipartite_match": _on_the_card(D._bipartite_match,
                                                 lambda i, a: (i, dict(
                                                     a, match_type=
                                                     "bipartite")))},
                "int32", ("bipartite_match",))},
        "detection_chain": {
            "yolov3_loss_without_ignore_thresh": (
                {"yolov3_loss": _on_the_card(D._yolov3_loss, lambda i, a: (
                    i, dict(a, ignore_thresh=1.0)))},
                "float32", ("yolov3_loss",)),
            "roi_pool_argmax_the_last_maximum": (
                {"roi_pool": _on_card_patched(D._roi_pool, D,
                                              "_roi_max_forward",
                                              _last_maximum(
                                                  D._roi_max_forward))},
                "int64", ("roi_pool",))}}


def _chain_side_outputs(m):
    """The names of the chain's outputs that its loss does not read."""
    ex = m.extra
    out = ex["yolo_boxes"] + ex["yolo_scores"] + list(ex["masks"]) + \
        ex["fpn_levels"] + [ex[k] for k in (
            "density_boxes", "polygons", "decoded", "assigned",
            "fpn_restore", "p2_anchors")]
    return [v.name for v in out]


def _detect_program(m):
    """The model's inference program pruned to its detections (no host
    op), and its feeds."""
    infer = m.extra["infer"]
    feeds = [n for n in infer.feeds if n in ("image", "im_info")]
    return infer.main._prune(feeds, [infer.out.name]), feeds


def _map_state_parity(fluid, tool, m, state, widths):
    """MobileNet-SSD's evaluator over DET_MAP_REQUESTS requests on the card
    and on the CPU from `state`: (readings, ok)."""
    import numpy as np
    infer = m.extra["infer"]
    ev = infer.extra["evaluator"]
    fetch = [infer.out] + infer.extra["maps"]
    runs = {}
    for place in ("cpu", "cuda"):
        exe = fluid.Executor(fluid.CPUPlace() if place == "cpu" else None)
        scope = fluid.Scope()
        for n, t in state.items():
            scope.set(n, t.to(place, copy=True))
        exe.run(infer.startup, scope=scope)
        maps = []
        for k in range(DET_MAP_REQUESTS):
            f = tool.ssd_batch(SEED + 400 + k, **widths)
            _, cur, accum = exe.run(infer.main, feed=f, fetch_list=fetch,
                                    scope=scope)
            maps.append([float(cur[0]), float(accum[0])])
        runs[place] = (maps, [fluid.executor.as_numpy(scope.get(v.name))
                              for v in ev.states])
    (cmaps, cstate), (gmaps, gstate) = runs["cpu"], runs["cuda"]
    counts = all(c.shape == g.shape and (c[:, 0] == g[:, 0]).all()
                 for c, g in zip(cstate, gstate)) and \
        (cstate[0] == gstate[0]).all()
    scores = max(float(np.abs(c[:, 1] - g[:, 1]).max(initial=0.0))
                 for c, g in zip(cstate[1:], gstate[1:])) \
        if counts else float("inf")
    rel = max(abs(a - b) / max(abs(b), 1e-12) if b else abs(a)
              for ca, ga in zip(cmaps, gmaps) for a, b in zip(ga, ca))
    rec = {"maps_cpu": cmaps, "maps_card": gmaps,
           "state_rows": [int(c.shape[0]) for c in cstate],
           "counts_and_classes_equal": bool(counts),
           "score_diff_max": scores, "map_rel_err": rel}
    return rec, bool(counts) and scores <= MAP_REL_MAX and \
        rel <= MAP_REL_MAX


def phase_detection_lockstep(fluid):
    """The slice's three programs in lockstep with the CPU at
    DET_PARITY's widths, both detect programs replayed, MobileNet-SSD's
    mAP state on both, and the six controls (checks: no launch counted)."""
    from unittest import mock
    from paddle_tpu_torch.fluid.ops import registry
    tool = _det_tool()
    t0 = time.perf_counter()
    results = {}
    controls = _det_controls()
    for name, (build, batch, _) in tool.PROGRAMS.items():
        widths = DET_PARITY[name]
        m = build(fluid, seed=SEED, **widths)
        feeds = [batch(SEED + 300 + k, **widths)
                 for k in range(DET_PARITY_STEPS)]
        cancelling = _bn_gradients(m.main)
        _, rec, ok = _lockstep(fluid, m[:3], feeds, exact_ops=DET_EXACT_OPS,
                               cancelling=cancelling)
        results[name] = dict(rec, widths=widths, ok=ok)
        scope = fluid.Scope()
        fluid.Executor(fluid.CPUPlace()).run(m.startup, scope=scope)
        state = {n: scope.get(n) for n, v in m.main.global_block().vars.items()
                 if v.persistable and scope.get(n) is not None}
        if name == "detection_chain":
            # the outputs the loss does not read, which the step's plan
            # leaves out
            side = _chain_side_outputs(m)
            rec, ok, _ = _replay_program(fluid, m.main._prune(m.feeds, side),
                                         side, state, feeds[0])
            results[name + "_side_outputs"] = dict(rec, ok=ok)
        if "infer" in m.extra:
            prog, names = _detect_program(m)
            f = batch(SEED + 350, **widths)
            rec, ok, _ = _replay_program(fluid, prog, [m.extra["infer"].out
                                                       .name], state,
                                         {n: f[n] for n in names})
            results[name + "_detect"] = dict(rec, ok=ok)
            if name == "faster_rcnn":
                results.update(_box_coder_control(fluid, tool, widths))
            else:
                rec, ok = _map_state_parity(fluid, tool, m, state, widths)
                results[name + "_map_state"] = dict(rec, ok=ok)
        for cname, (lowerings, dtype, named) in controls.get(name,
                                                             {}).items():
            with mock.patch.dict(registry._LOWERINGS, **lowerings):
                _, rec, passed = _lockstep(fluid, m[:3], feeds[:1],
                                           exact_ops=DET_EXACT_OPS,
                                           cancelling=cancelling)
            results["control_" + cname] = dict(rec, ok=_named_miss(
                rec, passed, dtype, named))
    failed = [k for k, r in results.items() if not r["ok"]]
    emit({"phase": "detection_lockstep", "ok": not failed, "card": _card(),
          "steps": DET_PARITY_STEPS, "results": results,
          "phase_seconds": time.perf_counter() - t0})
    if failed:
        raise AssertionError("detection_lockstep: %s failed" % failed)


def detection_phases(fluid, counters, add):
    """The object detection slice's phases, each with its launches
    added."""
    add(phase_mobilenet_ssd(fluid, counters))
    add(phase_faster_rcnn(fluid, counters))
    add(phase_detection_chain(fluid, counters))
    phase_detection_lockstep(fluid)


# ---- model compression and chunk evaluation --------------------------------
# tools/torch_compression_programs.py at its full widths (f32, seeded
# synthetic images and ids; no port kernel on these paths: Momentum and
# SGD). qat_resnet50: quantization-aware ResNet-50 (224, 1,000 classes,
# batch 64, Momentum), its QAT_ROUND_TRIPS round trips counted; a _window
# of QAT_STEPS, its _step phase (busy share, kernels a step, host syncs:
# none may lie in COMP_LOWERINGS); then QAT_REQUESTS frozen is_test
# requests of 64 images; the frozen model saved (float), the int8
# Calibrator over the tool's calibration batches (8 images each) and its
# int8 model saved, the two artifacts' bytes; the int8 model loaded and
# QAT_REQUESTS requests of it, its QAT_WEIGHTS weights int8 on the card,
# its logits against the float model's.
QAT_STEPS = 3
QAT_REQUESTS = 4
QAT_ROUND_TRIPS = 104
QAT_WEIGHTS = 54
# slim_resnet: a ResNet-101 teacher merged into a ResNet-50 student (224,
# batch 32, soft-label and FSP losses, Momentum): a _window of SLIM_STEPS,
# its _step phase, then Compressor.run with PruneStrategy(0.5) on the
# student over the tool's two batches: the sparsity read back within
# SPARSITY_TOL of the ratio, every pruned weight 0 on the card, the host
# ms of the masks (built on the host, a copy each way a parameter).
SLIM_STEPS = 3
SPARSITY_TOL = 0.01
# srl_chunk_eval: the book's SRL trained SRL_CHUNK_STEPS ragged batches
# (Executor.run), then CHUNK_REQUESTS tagging requests scored by
# chunk_eval (busy share, kernels, host syncs), then the same requests
# through evaluator.ChunkEvaluator (reset first) and metrics.ChunkEvaluator
# fed the op's counts: their precision, recall and F1 within CHUNK_REL of
# each other; chunk_eval's own kernels at the request's shape.
SRL_CHUNK_STEPS = 3
CHUNK_REQUESTS = 4
CHUNK_REL = 1e-6
# compression_chain: the tool's chain at CHAIN's widths (SGD): a _window of
# COMP_CHAIN_STEPS on one feed with its outputs checked (buckets in [0,
# vocab), int8 values in range, the channel-wise quantizer's values
# integers in [-127, 127], pair counts no more than the batch's pairs),
# then its _step phase.
COMP_CHAIN_STEPS = 3
# compression_lockstep: each program at COMP_PARITY's widths, one step in
# lockstep with the CPU (_lockstep: every op replayed within RESNET_OP_TOL,
# integers exact, the outputs of COMP_EXACT_OPS bit for bit: quantized
# values, hash buckets, pair and chunk counts; the batch norms' cancelling
# gradients passed as `cancelling`). qat_resnet replayed at 8 bits with its
# whole-step loss not held (one value an ulp from a half step rounds apart
# on two devices: the loss 15.5% apart at batch 2 on an H100 80GB HBM3 at
# 700 W), then at the tool's FINE_BITS with the loss held to
# RESNET_STEP_LIMITS, as resnet_parity's; its frozen program converted to int8
# from one state on the card and on the CPU (int8 weights bit for bit)
# and the converted request replayed; the Calibrator's ranges on both
# within RESNET_OP_TOL. srl_chunk_eval's tagging request replayed, its
# targets the CPU's own tags but for one position in five (a trained
# tagger's agreement). Controls, each of which must miss with its op's
# output the worst of its dtype: quantize by a reciprocal multiply (the
# chain's activation holds boundary_values), round half away from zero
# (the quantize op on the half-step grid), hash without its position
# salt, the channel-wise quantizer with one scale a tensor, the moving
# average with its rate swapped, chunk_eval without its type check.
COMP_PARITY_STEPS = 1
COMP_PARITY = {
    "qat_resnet": dict(dataset="flowers", depth=50, image=[3, 64, 64],
                       classes=10, batch=4, calib_batch=2, calib_batches=1),
    "slim_resnet": dict(dataset="cifar10", teacher_depth=32, depth=20,
                        image=[3, 32, 32], classes=10, batch=4),
    "srl_chunk_eval": dict(batch=10),
    "compression_chain": dict(act=[4, 64, 28, 28],
                              filters=[[64, 3, 7, 7], [64, 64, 3, 3],
                                       [256, 64, 1, 1]],
                              ids_batch=512, queries=16, boundary=256)}
COMP_EXACT_OPS = ("fake_quantize_abs_max",
                  "fake_channel_wise_quantize_abs_max", "quantize", "hash",
                  "positive_negative_pair", "chunk_eval", "crf_decoding")
COMP_LOWERINGS = ("paddle_tpu_torch/fluid/ops/quantize_ops.py",
                  "paddle_tpu_torch/fluid/ops/parity_ops.py")
# a trained tagger's targets: its own tags but for this share of positions
CHUNK_DISAGREE = 0.2


def _comp_tool():
    return _load_tool("torch_compression_programs")


def _comp_io(name):
    import shutil
    path = os.path.join(IO_DIR, name)
    shutil.rmtree(path, ignore_errors=True)
    os.makedirs(path)
    return path


def phase_qat_resnet50(fluid, counters):
    """QAT ResNet-50: training window and step phase, frozen requests, the
    float and int8 artifacts, int8 requests. Returns the window's
    launches."""
    import numpy as np
    import torch
    tool = _comp_tool()
    w = tool.QAT
    t0 = time.perf_counter()
    m = tool.qat_resnet(fluid, seed=SEED)
    trips = m.extra["round_trips"]
    launched, scope = _det_window(
        "qat_resnet50", fluid, counters, m, t0, tool.qat_batch, QAT_STEPS,
        {"images": w["batch"]}, lowerings=COMP_LOWERINGS,
        info={"round_trips": trips, "round_trips_want": QAT_ROUND_TRIPS})
    t0 = time.perf_counter()
    exe = fluid.Executor()
    infer = tool.infer_program(fluid, m)
    logits = infer.global_block().var(m.out.name)
    feeds = [{"img": tool.qat_batch(SEED + 60 + k)["img"]}
             for k in range(QAT_REQUESTS)]
    frozen = _detect_requests(fluid, counters, infer, scope, feeds,
                              [logits], w["batch"], COMP_LOWERINGS)
    float_logits = exe.run(infer, feed=feeds[0], fetch_list=[logits],
                           scope=scope)[0]
    float_dir, int8_dir = _comp_io("qat_float"), _comp_io("qat_int8")
    with fluid.scope_guard(scope):
        fluid.io.save_inference_model(float_dir, ["img"], [logits], exe,
                                      main_program=infer)
    cal = fluid.contrib.Calibrator(program=infer, exe=exe,
                                   feed_var_names=["img"],
                                   fetch_list=[logits], scope=scope)
    sampled = len(cal.sampled_names())
    t1 = time.perf_counter()
    for k in range(w["calib_batches"]):
        cal.sample_data(tool.calib_batch(SEED + 80 + k))
    sample_ms = (time.perf_counter() - t1) * 1e3 / w["calib_batches"]
    t1 = time.perf_counter()
    with fluid.scope_guard(scope):
        cal.save_int8_model(int8_dir)
    save_s = time.perf_counter() - t1
    loaded = fluid.Scope()
    with fluid.scope_guard(loaded):
        prog, feed_names, fetches = fluid.io.load_inference_model(int8_dir,
                                                                  exe)
    int8 = {n: t for n, t in loaded._vars.items() if n.endswith("@INT8")}
    int8_rec = _detect_requests(fluid, counters, prog, loaded, feeds,
                                fetches, w["batch"], COMP_LOWERINGS)
    int8_logits = exe.run(prog, feed=feeds[0], fetch_list=fetches,
                          scope=loaded)[0]
    on_card = all(t.dtype == torch.int8 and t.is_cuda for t in int8.values())
    rel = float(np.abs(int8_logits - float_logits).max() /
                np.abs(float_logits).max())
    rec = {"frozen_requests": frozen, "int8_requests": int8_rec,
           "calibrated_outputs": sampled,
           "calibration_ms_a_batch": sample_ms,
           "calibration_batch": w["calib_batch"],
           "int8_save_seconds": save_s,
           "float_artifact_bytes": _artifact_bytes(float_dir),
           "int8_artifact_bytes": _artifact_bytes(int8_dir),
           "int8_weights": len(int8), "int8_weights_on_card": on_card,
           "int8_scales": len(prog._dist_attrs.get("int8_scales", {})),
           "calibrated_scales": len(cal.program._dist_attrs["int8_scales"]),
           "logits_int8_vs_float_rel": rel,
           "logits_finite": bool(np.isfinite(int8_logits).all() and
                                 np.isfinite(float_logits).all()),
           "feeds": feed_names}
    rec["artifact_ratio"] = rec["int8_artifact_bytes"] / \
        rec["float_artifact_bytes"]
    ok = frozen["ok"] and int8_rec["ok"] and on_card and \
        len(int8) == QAT_WEIGHTS and trips == QAT_ROUND_TRIPS and \
        rec["logits_finite"] and 0 < sampled <= 256 and \
        rec["calibrated_scales"] == sampled and feed_names == ["img"] and \
        rec["int8_artifact_bytes"] < rec["float_artifact_bytes"]
    emit(dict({"phase": "qat_resnet50_int8", "ok": ok, "card": _card(),
               "phase_seconds": time.perf_counter() - t0}, **rec))
    if not ok:
        raise AssertionError("qat_resnet50: the int8 path failed %s" % rec)
    return launched


def phase_slim_resnet(fluid, counters):
    """Distillation and pruning: training window and step phase of the
    merged program, then Compressor.run with PruneStrategy. Returns the
    window's launches."""
    import torch
    tool = _comp_tool()
    w = tool.SLIM
    slim = fluid.contrib.slim
    t0 = time.perf_counter()
    m = tool.slim_resnet(fluid, seed=SEED)
    launched, scope = _det_window(
        "slim_resnet", fluid, counters, m, t0, tool.slim_batch, SLIM_STEPS,
        {"images": w["batch"]}, lowerings=COMP_LOWERINGS,
        info={"teacher_depth": w["teacher_depth"], "depth": w["depth"],
              "student_params": len(m.extra["student_params"])})
    t0 = time.perf_counter()
    host = {"prune": [], "apply_masks": []}

    def timed(fn, key):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            host[key].append((time.perf_counter() - t1) * 1e3)
            return out
        return run
    batches = [tool.slim_batch(SEED + 90 + k)
               for k in range(w["reader_batches"])]
    strat = slim.PruneStrategy(
        pruner=timed(slim.prune_parameters, "prune"),
        target_ratio=w["prune_ratio"], params=m.extra["student_params"])
    comp = fluid.contrib.Compressor(
        fluid.CUDAPlace(0), scope, m.main, train_reader=lambda: iter(batches),
        train_feed_list=["img"], train_fetch_list=[m.loss])
    comp.strategies = [strat]
    apply_masks = slim.prune.apply_masks
    slim.prune.apply_masks = timed(apply_masks, "apply_masks")
    try:
        t1 = time.perf_counter()
        final = comp.run()
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t1
    finally:
        slim.prune.apply_masks = apply_masks
    sparsity = slim.sparsity(scope, strat.masks)
    dead = all(bool((scope.get(n)[torch.from_numpy(mask).to(
        scope.get(n).device) == 0] == 0).all())
        for n, mask in strat.masks.items())
    finite = all(bool(torch.isfinite(scope.get(n)).all())
                 for n in strat.masks)
    rec = {"compressor_seconds": run_s, "batches": len(batches),
           "pruned_params": len(strat.masks), "sparsity": sparsity,
           "prune_host_ms": host["prune"],
           "apply_masks_host_ms_a_batch": host["apply_masks"],
           "pruned_weights_zero": dead, "weights_finite": finite,
           "final_ops": len(final.global_block().ops)}
    ok = abs(sparsity - w["prune_ratio"]) <= SPARSITY_TOL and dead and \
        finite and len(host["apply_masks"]) == len(batches)
    emit(dict({"phase": "slim_resnet_compressor", "ok": ok, "card": _card(),
               "phase_seconds": time.perf_counter() - t0}, **rec))
    if not ok:
        raise AssertionError("slim_resnet: the Compressor failed %s" % rec)
    return launched


def phase_srl_chunk_eval(fluid, counters):
    """The SRL tagger's requests scored by chunk_eval and both
    ChunkEvaluators. Returns the training window's launches."""
    import numpy as np
    import torch
    from paddle_tpu_torch.fluid.ops import registry
    tool = _comp_tool()
    t0 = time.perf_counter()
    m = tool.srl_chunk_eval(fluid, seed=SEED)
    draws = [tool.srl_batch(SEED + k) for k in range(SRL_CHUNK_STEPS + 1)]
    launched, scope = _ragged_window(
        "srl_chunk_eval", fluid, counters, m, draws[0], draws[1:],
        "word_data", dict.fromkeys(counters, 0),
        {"build_seconds": time.perf_counter() - t0,
         "chunk_types": m.extra["chunk_types"]})
    t0 = time.perf_counter()
    exe = fluid.Executor()
    tagger, ev = m.extra["tagger"], m.extra["evaluator"]
    counts = m.extra["counts"]
    exe.run(tagger.startup, scope=scope)
    feeds = [tool.srl_batch(SEED + 60 + k) for k in range(CHUNK_REQUESTS)]
    real = sum(int(f["word_data@LEN"].sum()) for f in feeds) / len(feeds)
    rec = _detect_requests(fluid, counters, tagger.main, scope, feeds,
                           [tagger.out] + ev.metrics + counts, real,
                           COMP_LOWERINGS)
    rec["labels_per_s"] = rec.pop("images_per_s")
    rec["labels_a_request"] = rec.pop("images_a_request")
    metric = fluid.metrics.ChunkEvaluator()
    seen = []
    with fluid.scope_guard(scope):
        ev.reset(exe)
        for f in feeds:
            got = exe.run(tagger.main, feed=f, fetch_list=ev.metrics +
                          counts, scope=scope)
            metric.update(*got[-3:])
            seen.append([int(np.asarray(v).reshape(-1)[0])
                         for v in got[-3:]])
        evaluated = [float(v[0]) for v in ev.eval(exe)]
    metrics = list(metric.eval())
    # chunk_eval alone at a request's shape: its kernels
    f = feeds[0]
    lab = torch.from_numpy(f["target"]).cuda()
    lowering = registry.get_lowering("chunk_eval")
    ctx = registry.LoweringContext("cuda")
    attrs = {"chunk_scheme": tool.CHUNK_SCHEME,
             "num_chunk_types": m.extra["chunk_types"]}
    _, busy, by_kind = _busy_share(lambda: lowering(
        ctx, {"Inference": [lab], "Label": [lab]}, attrs))
    rec.update({"counts_infer_label_correct": seen,
                "evaluator_prf": evaluated, "metrics_prf": metrics,
                "chunk_eval_kernels": sum(c for _, c in by_kind.values()),
                "chunk_eval_device_ms": busy,
                "request_T": [int(f["word_data"].shape[1]) for f in feeds]})
    agree = all(abs(a - b) <= CHUNK_REL * max(abs(b), 1e-12)
                for a, b in zip(evaluated, metrics))
    sane = all(0 <= c <= min(i, l) for i, l, c in seen) and \
        all(i > 0 and l > 0 for i, l, _ in seen)
    rec["ok"] = rec["ok"] and agree and sane
    emit(dict({"phase": "srl_chunk_eval_requests", "card": _card(),
               "phase_seconds": time.perf_counter() - t0}, **rec))
    if not rec["ok"]:
        raise AssertionError("srl_chunk_eval: the requests failed %s" % rec)
    return launched


def phase_compression_chain(fluid, counters):
    """The chain at CHAIN's widths: a _window with its outputs checked,
    then its _step phase. Returns the window's launches."""
    import numpy as np
    tool = _comp_tool()
    w = tool.CHAIN

    def check(scope, extra):
        buckets, int8, pairs, quantized = extra[0], extra[1], extra[2:5], \
            extra[5:]
        b = buckets.cpu().numpy()
        q8 = int8.cpu().numpy().astype(np.int64)
        n = w["ids_batch"]
        rec = {"buckets_in_range": bool(((b >= 0) &
                                         (b < w["vocab"])).all()),
               "int8_range": [int(q8.min()), int(q8.max())],
               "pairs_a_step": [float(p.cpu().numpy().sum()) /
                                COMP_CHAIN_STEPS for p in pairs],
               "pairs_bound": n * (n - 1) // 2,
               "channel_quantized_integers": all(
                   bool((q.cpu() == q.cpu().round()).all()) and
                   float(q.abs().max()) <= 127 for q in quantized)}
        ok = rec["buckets_in_range"] and rec["channel_quantized_integers"] \
            and -128 <= rec["int8_range"][0] and rec["int8_range"][1] <= 127 \
            and sum(rec["pairs_a_step"]) <= rec["pairs_bound"]
        return {"outputs": rec}, ok
    t0 = time.perf_counter()
    m = tool.compression_chain(fluid, seed=SEED)
    ex = m.extra
    fetch = [ex["buckets"], ex["int8"]] + ex["pairs"] + \
        ex["channel_quantized"]
    # one feed for every step: its two [64, 256, 56, 56] activations take
    # seconds to draw on the host
    one = tool.chain_batch(SEED)
    launched, _ = _det_window("compression_chain", fluid, counters, m, t0,
                              lambda seed: one, COMP_CHAIN_STEPS,
                              {"chains": 1}, (fetch, check),
                              lowerings=COMP_LOWERINGS)
    return launched


def _quant_by_reciprocal(x, scale, bits):
    """quantize_ops._quant multiplying by the scale's reciprocal, as a CUDA
    kernel divides by a number (a control)."""
    import torch
    bnt = float((1 << (bits - 1)) - 1)
    s = torch.clamp(scale, min=1e-8)
    return torch.round(torch.clamp(x * (1.0 / s), -1.0, 1.0) * bnt), bnt


def _on_card_only(real, control):
    """`control` on the card, `real` on the CPU."""
    def lower(ctx, inputs, attrs):
        fn = control if ctx.device.type == "cuda" else real
        return fn(ctx, inputs, attrs)
    return lower


def _quantize_half_away(ctx, inputs, attrs):
    import torch
    v = inputs["Input"][0] * attrs.get("Scale", 1.0)
    r = torch.sign(v) * torch.floor(torch.abs(v) + 0.5)
    return {"Output": [torch.clamp(r, -128, 127).to(torch.int8)]}


def _hash_without_salt(ctx, inputs, attrs):
    import torch
    from paddle_tpu_torch.fluid.ops import parity_ops as P
    x = inputs["X"][0]
    flat = x.reshape(x.shape[0], -1).to(torch.int64) & 0xFFFFFFFF
    outs = []
    for i in range(attrs.get("num_hash", 1)):
        mixed = (P.mul32(flat, 2654435761) +
                 ((0x9E3779B9 * (i + 1)) & 0xFFFFFFFF)) & 0xFFFFFFFF
        mixed = P.mul32(mixed ^ (mixed >> 16), 0xC2B2AE35)
        outs.append(torch.remainder(mixed.sum(dim=1) & 0xFFFFFFFF,
                                    attrs.get("mod_by", 1)))
    return {"Out": [torch.stack(outs, dim=1)[..., None]]}


def _channel_wise_one_scale(ctx, inputs, attrs):
    import torch
    from paddle_tpu_torch.fluid.ops import parity_ops as P
    outs = P._fake_cw_quant(ctx, inputs, attrs)
    x = inputs["X"][0]
    rng = float(2 ** (attrs.get("bit_length", 8) - 1) - 1)
    s = torch.clamp(x.abs().amax(), min=1e-12)
    outs["Out"] = [torch.round(x / s * rng)]
    return outs


def _without_type_check(matched):
    """parity_ops.matched_chunks (`matched`) with the label's chunk types
    taken to be the inference's: a match opens where both begin any chunk
    (a control)."""
    def run(ib, ie, ity, lb, le, lty):
        import torch
        return matched(ib, ie, ity, lb, le, torch.where(lty >= 0, ity, lty))
    return run


def _comp_controls():
    """{program: {control: ({op type: lowering}, dtype, named op types)}}
    for compression_lockstep."""
    from paddle_tpu_torch.fluid.ops import parity_ops as P
    from paddle_tpu_torch.fluid.ops import quantize_ops as Q
    return {
        "compression_chain": {
            "quantize_by_a_reciprocal_multiply": (
                {"fake_quantize_abs_max": _on_card_patched(
                    Q._fake_quantize_abs_max, Q, "_quant",
                    _quant_by_reciprocal)},
                "float32", ("fake_quantize_abs_max",)),
            "round_half_away_from_zero": (
                {"quantize": _on_card_only(Q._quantize,
                                           _quantize_half_away)},
                "int8", ("quantize",)),
            "hash_without_its_position_salt": (
                {"hash": _on_card_only(P._hash, _hash_without_salt)},
                "int64", ("hash",)),
            "channel_wise_quantize_with_one_scale_a_tensor": (
                {"fake_channel_wise_quantize_abs_max": _on_card_only(
                    P._fake_cw_quant, _channel_wise_one_scale)},
                "float32", ("fake_channel_wise_quantize_abs_max",)),
            "moving_average_with_its_rate_swapped": (
                {"fake_quantize_moving_average_abs_max": _on_the_card(
                    Q._fake_quantize_moving_avg, lambda i, a: (i, dict(
                        a, moving_rate=1.0 - a.get("moving_rate", 0.9))))},
                "float32", ("fake_quantize_moving_average_abs_max",))},
        "srl_chunk_eval": {
            "chunk_eval_without_its_type_check": (
                {"chunk_eval": _on_card_patched(
                    P._chunk_eval, P, "matched_chunks",
                    _without_type_check(P.matched_chunks))},
                "int64", ("chunk_eval",))}}


def _cpu_state(fluid, m):
    """The persistables after m's startup on the CPU."""
    scope = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(m.startup, scope=scope)
    return {n: scope.get(n) for n, v in m.main.global_block().vars.items()
            if v.persistable and scope.get(n) is not None}


def _tagging_request(fluid, tool, m, state, widths):
    """The tagger's request feed whose targets are the CPU's own tags but
    for CHUNK_DISAGREE of positions, and the CPU state with the
    evaluator's."""
    import numpy as np
    tagger = m.extra["tagger"]
    scope = fluid.Scope()
    for n, t in state.items():
        scope.set(n, t.clone())
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(tagger.startup, scope=scope)
    f = tool.srl_batch(SEED + 500, **widths)
    tags, = exe.run(tagger.main, feed=f, fetch_list=[tagger.out],
                    scope=scope)
    rng = np.random.RandomState(SEED)
    other = rng.randint(0, tool.SRL["label_dict"], tags.shape)
    f["target"] = np.where(rng.rand(*tags.shape) < CHUNK_DISAGREE, other,
                           tags).astype(np.int64)[..., None]
    full = dict(state)
    for v in m.extra["evaluator"].states:
        full[v.name] = scope.get(v.name)
    return f, full


def phase_compression_lockstep(fluid):
    """The slice's programs in lockstep with the CPU at COMP_PARITY's
    widths, the int8 conversion and calibration on both, the tagging
    request replayed, and the six controls (checks: no launch counted)."""
    from unittest import mock
    from paddle_tpu_torch.fluid.ops import registry
    tool = _comp_tool()
    t0 = time.perf_counter()
    results = {}
    controls = _comp_controls()
    for name, (build, batch, _) in tool.PROGRAMS.items():
        widths = COMP_PARITY[name]
        m = build(fluid, seed=SEED, **widths)
        feeds = [batch(SEED + 300 + k, **widths)
                 for k in range(COMP_PARITY_STEPS)]
        cancelling = _bn_gradients(m.main)
        if name == "qat_resnet":
            # 8 bits: every op replayed, the whole step's loss not held
            # (nor its float64 run taken: it rounds apart too)
            _, rec, ok = _lockstep(fluid, m[:3], feeds,
                                   exact_ops=COMP_EXACT_OPS,
                                   loss_rel_max=float("inf"))
            results[name + "_8_bits"] = dict(rec, widths=widths, ok=ok)
            widths = dict(widths, bits=tool.FINE_BITS)
            results.update(_int8_parity(fluid, tool, build(
                fluid, seed=SEED, **widths), widths))
        elif name == "srl_chunk_eval":
            feed, full = _tagging_request(fluid, tool, m,
                                          _cpu_state(fluid, m), widths)
            tagger = m.extra["tagger"]
            fetch = [tagger.out.name] + [v.name for v in m.extra["counts"]]
            # the request to its tags and counts (the evaluator's sums,
            # which update its states, left out: no state changes)
            request = tagger.main._prune(list(feed), fetch)
            rec, ok, vals = _replay_program(fluid, request, fetch, full,
                                            feed)
            counts = [int(vals[n].reshape(-1)[0]) for n in fetch[1:]]
            results[name + "_request"] = dict(rec, counts=counts,
                                               ok=ok and counts[2] > 0)
            for cname, (lowerings, dtype, named) in controls[name].items():
                with mock.patch.dict(registry._LOWERINGS, **lowerings):
                    rec, passed, _ = _replay_program(fluid, request, fetch,
                                                     full, feed)
                results["control_" + cname] = dict(rec, ok=_named_miss(
                    rec, passed, dtype, named))
        else:
            _, rec, ok = _lockstep(fluid, m[:3], feeds,
                                   exact_ops=COMP_EXACT_OPS,
                                   cancelling=cancelling)
            results[name] = dict(rec, widths=widths, ok=ok)
            for cname, (lowerings, dtype, named) in controls.get(
                    name, {}).items():
                with mock.patch.dict(registry._LOWERINGS, **lowerings):
                    _, rec, passed = _lockstep(fluid, m[:3], feeds[:1],
                                               exact_ops=COMP_EXACT_OPS)
                results["control_" + cname] = dict(rec, ok=_named_miss(
                    rec, passed, dtype, named))
    failed = [k for k, r in results.items() if not r["ok"]]
    emit({"phase": "compression_lockstep", "ok": not failed, "card": _card(),
          "steps": COMP_PARITY_STEPS, "results": results,
          "phase_seconds": time.perf_counter() - t0})
    if failed:
        raise AssertionError("compression_lockstep: %s failed" % failed)


def _int8_parity(fluid, tool, m, widths):
    """The QAT model at FINE_BITS: one step in lockstep with its loss held
    to RESNET_STEP_LIMITS (a random-init ResNet-50's whole step: 2.6e-5 at
    batch 2, 64 x 64, on an H100 80GB HBM3 at 700 W);
    from the CPU's startup state, the frozen program calibrated and
    converted to int8 on the card and on the CPU (the ranges within
    RESNET_OP_TOL, the int8 weights bit for bit) and the converted request
    replayed on the card. {result: readings}."""
    import numpy as np
    out = {}
    feeds = [tool.qat_batch(SEED + 300, **widths)]
    _, rec, ok = _lockstep(fluid, m[:3], feeds, exact_ops=COMP_EXACT_OPS,
                           loss_rel_max=RESNET_STEP_LIMITS["loss"],
                           cancelling=_bn_gradients(m.main))
    out["qat_resnet_fine_bits"] = dict(rec, widths=widths, ok=ok)
    state = _cpu_state(fluid, m)
    runs = {}
    for place in ("cpu", "cuda"):
        exe = fluid.Executor(fluid.CPUPlace() if place == "cpu" else None)
        infer = tool.infer_program(fluid, m)
        scope = fluid.Scope()
        for n, t in state.items():
            if infer.global_block().has_var(n):
                scope.set(n, t.to(place, copy=True))
        cal = fluid.contrib.Calibrator(
            program=infer, exe=exe, feed_var_names=["img"],
            fetch_list=[infer.global_block().var(m.out.name)], scope=scope)
        cal.sample_data(tool.calib_batch(SEED + 310, **widths))
        ranges = dict(cal._ranges)
        with fluid.scope_guard(scope):
            cal.save_int8_model()
        int8 = {n: fluid.executor.as_numpy(t) for n, t in scope._vars.items()
                if n.endswith("@INT8")}
        runs[place] = (ranges, int8, infer, scope)
    (cr, ci, cprog, cscope), (gr, gi, _, _) = runs["cpu"], runs["cuda"]
    range_err = max(abs(gr[n] - v) / max(v, 1e-12) for n, v in cr.items())
    same_int8 = set(gi) == set(ci) and all(
        gi[n].dtype == np.int8 and (gi[n] == ci[n]).all() for n in ci)
    out["qat_int8_conversion"] = {
        "calibrated_outputs": len(cr), "range_rel_err": range_err,
        "int8_weights": len(ci), "int8_bit_for_bit": bool(same_int8),
        "ok": bool(same_int8) and range_err <= RESNET_OP_TOL["float32"] and
        set(gr) == set(cr)}
    converted = {n: cscope.get(n) for n, v in cprog.global_block()
                 .vars.items() if v.persistable and
                 cscope.get(n) is not None}
    rec, ok, _ = _replay_program(
        fluid, cprog, [m.out.name], converted,
        {"img": tool.qat_batch(SEED + 320, **widths)["img"]})
    out["qat_int8_request"] = dict(rec, ok=ok)
    return out


def compression_phases(fluid, counters, add):
    """The model compression and chunk evaluation slice's phases, each
    with its launches added."""
    add(phase_qat_resnet50(fluid, counters))
    add(phase_slim_resnet(fluid, counters))
    add(phase_srl_chunk_eval(fluid, counters))
    add(phase_compression_chain(fluid, counters))
    phase_compression_lockstep(fluid)


# ---- fused ops, host ops and the input pipeline ----------------------------
# tools/torch_fusion_programs.py and tools/torch_input_programs.py at their
# full widths (f32, seeded synthetic ids, features and images).
# fused_stacked_lstm: models/stacked_lstm.py at fluid_benchmark's widths
# (batch 64, T 64) with each fc -> dynamic_lstm pair one fusion_lstm, Adam:
# a window of FUSED_STEPS with one Adam launch a step over
# FUSED_LSTM_ADAM_TENSORS parameters (the stacked LSTM's 7 the kernel
# takes), its _step phase (no host sync in fusion_ops.py), the unfused
# twin's busy share and kernels a step, one whole step of each from one
# state on the card (the loss within FUSED_TWIN_REL, every parameter
# after it within FUSED_TWIN_REL of its size: the same products and
# recurrences either way), then FUSED_REQUESTS serving requests of 64
# sentences, folded (fused_embedding_fc_lstm over W_emb · W_fc) and
# unfused, their probabilities within FOLD_REL of each other (the fold
# rounds one product differently).
FUSED_STEPS = 3
FUSED_REQUESTS = 4
FUSED_LSTM_ADAM_TENSORS = 7
FUSED_TWIN_REL = 1e-5
FOLD_REL = 1e-4
# fused_ctr: the Criteo-shaped CTR model (batch 4,096, SGD): a window, its
# _step phase, the twin's busy share, one step of each from one state
# (FUSED_TWIN_REL), FUSED_REQUESTS click-probability requests of 4,096,
# fused and unfused, equal within FUSED_TWIN_REL.
# fused_resnet50: ResNet-50's is_test request of 64 images with drawn
# batch-norm statistics, folded by InferenceTranspiler, its 53 conv
# epilogues fused into conv2d_fusion: FUSED_REQUESTS requests of each,
# the probabilities within FUSED_TWIN_REL.
RESNET_FUSED_CONVS = 53
# fusion_chain: every other fused op at its source's shape, SGD: a window
# with its outputs finite, then its _step phase.
FUSION_LOWERINGS = ("paddle_tpu_torch/fluid/ops/fusion_ops.py",)
HOST_OPS_FILE = "paddle_tpu_torch/fluid/host_ops.py"
# input_pipeline: ResNet-50 (batch 64, Momentum) trained from a
# fluid.io.PyReader (decorate_sample_generator, capacity 64) to its end,
# READER_BATCHES batches, then the same batches fed as numpy; the stacked
# LSTM from a DataFeeder over FEEDER_BATCHES ragged batches (one Adam
# launch each); the py_reader -> Preprocessor chain; the graph reader
# chain READER_READS reads on the random source, then to EOFException on a
# finite one; create_ctr_reader over a written file of 4,096 lines.
READER_BATCHES = 8
FEEDER_BATCHES = 4
READER_READS = 4
# fusion_lockstep at FUSION_PARITY's widths: each program one step in
# lockstep with the CPU, each request replayed; the fused and unfused
# stacked LSTM's whole steps on the card within FUSED_TWIN_REL. Controls,
# each of which must miss: fusion_lstm with is_reverse dropped,
# attention_lstm with LSTMWeight's rows taken x-first,
# fused_embedding_seq_pool without its Length mask, conv2d_fusion without
# its residual. host_io_lockstep: split_ids and merge_ids, the
# DataFeeder's bucketed feeds and the combined file's arrays bit for bit
# the CPU's; the Go block's copy bit for bit the weight before the step.
# Controls: merge_ids in shard order, a go block without its input clone.
FUSION_PARITY = {
    "fused_stacked_lstm": dict(vocab=500, seq=16, emb=32, hidden=32,
                               layers=3, classes=2, batch=8, lr=0.001),
    "fused_ctr": dict(slots=6, max_len=8, vocab=1000, emb=10, dense=13,
                      factors=10, tower=[64, 64, 64], batch=64, lr=0.001),
    "fusion_chain": dict(ffn_rows=256, ffn_in=64, ffn=256,
                         gru_batch=4, gru_t=12, gru_in=48, gru_hidden=20,
                         conv_batch=4, conv_t=24, conv_emb=16, conv_ctx=3,
                         conv_filters=32, expand_batch=4, expand_t=8,
                         expand_seq=16, expand_vec=8, expand_out=16,
                         ssd_batch=2, ssd_heads=[[32, 10, 3], [64, 5, 6],
                                                 [32, 3, 6]],
                         inc_batch=2, inc_in=24, inc_side=14,
                         inc_filters=[[8, 1], [16, 3], [4, 5], [4, 1]],
                         att_batch=4, att_t=12, att_m=16, att_d=8,
                         lr=0.001)}
RESNET_PARITY = dict(dataset="cifar10", depth=20, classes=10,
                     image=[3, 32, 32], batch=4)


def _fusion_tool():
    return _load_tool("torch_fusion_programs")


def _input_tool():
    return _load_tool("torch_input_programs")


def _twin_steps(fluid, fused, twin, feed):
    """One step of each from the twin's startup state on the card: (the
    losses' relative difference, the parameters' largest relative
    difference after it)."""
    import torch
    exe = fluid.Executor()
    su, sf = fluid.Scope(), fluid.Scope()
    exe.run(twin.startup, scope=su)
    exe.run(fused.startup, scope=sf)
    for n in list(sf._vars):
        if su.get(n) is not None:
            sf.set(n, su.get(n).clone())
    lu, = exe.run(twin.main, feed=feed, fetch_list=[twin.loss], scope=su)
    lf, = exe.run(fused.main, feed=feed, fetch_list=[fused.loss], scope=sf)
    params = [p.name for p in twin.main.all_parameters()]
    rel = max(float((sf.get(n) - su.get(n)).abs().max() /
                    su.get(n).abs().max().clamp(min=1e-30)) for n in params)
    torch.cuda.synchronize()
    return abs(float(lf) - float(lu)) / abs(float(lu)), rel


def _twin_busy(fluid, twin, feed):
    """The unfused twin's step: busy share and device kernels."""
    busy = _busy_rec(*_step_busy(fluid, twin, feed))
    busy["device_kernels_a_step"] = sum(
        c for _, c in busy["device_ms_by_kind"].values())
    return busy


def _request_pair(fluid, counters, fused, unfused, scope, feeds, fetch,
                  work):
    """FUSED_REQUESTS requests of the fused program, of the unfused one and
    of the fused one again over `scope` (the order a time's own check):
    each's timings (_detect_requests) and their outputs' largest relative
    difference."""
    import numpy as np
    recs, outs = {}, {}
    for key, prog in (("fused", fused), ("unfused", unfused),
                      ("fused_again", fused)):
        recs[key] = _detect_requests(fluid, counters, prog, scope, feeds,
                                     [fetch], work, FUSION_LOWERINGS)
        recs[key]["samples_per_s"] = recs[key].pop("images_per_s")
        outs[key] = fluid.Executor().run(prog, feed=feeds[0],
                                         fetch_list=[fetch], scope=scope)[0]
    top = np.abs(outs["unfused"]).max()
    rel = float(np.abs(outs["fused"] - outs["unfused"]).max() / top)
    finite = bool(np.isfinite(outs["fused"]).all())
    return recs, rel, finite


def phase_fused_stacked_lstm(fluid, counters):
    """The fused stacked LSTM: window, step phase, the twin, one step of
    each, the folded requests. Returns the window's launches."""
    tool = _fusion_tool()
    w = tool.STACKED
    t0 = time.perf_counter()
    m = tool.fused_stacked_lstm(fluid, seed=SEED)
    twin = tool.stacked_lstm(fluid, seed=SEED)
    want = dict(dict.fromkeys(counters, 0), adam=1)
    launched, _ = _det_window(
        "fused_stacked_lstm", fluid, counters, m, t0, tool.stacked_batch,
        FUSED_STEPS, {"sentences": w["batch"]},
        lowerings=FUSION_LOWERINGS, want=want,
        adam_tensors=FUSED_LSTM_ADAM_TENSORS)
    t0 = time.perf_counter()
    feed = tool.stacked_batch(SEED + 40)
    twin_busy = _twin_busy(fluid, twin, feed)
    loss_rel, param_rel = _twin_steps(fluid, m, twin, feed)
    # the requests over the twin's state after one step, folded
    exe, scope = fluid.Executor(), fluid.Scope()
    exe.run(twin.startup, scope=scope)
    exe.run(twin.main, feed=feed, fetch_list=[twin.loss], scope=scope)
    tool.fold_embedding_fc(scope)
    folded = tool.stacked_lstm_request(fluid, True)
    plain = tool.stacked_lstm_request(fluid, False)
    feeds = []
    for k in range(FUSED_REQUESTS):
        f = tool.stacked_batch(SEED + 50 + k)
        f.pop("label")
        feeds.append(f)
    recs, rel, finite = _request_pair(fluid, counters, folded.main,
                                      plain.main, scope, feeds,
                                      folded.out.name, w["batch"])
    ok = loss_rel <= FUSED_TWIN_REL and param_rel <= FUSED_TWIN_REL and \
        rel <= FOLD_REL and finite and \
        all(r["ok"] for r in recs.values())
    rec = {"phase": "fused_stacked_lstm_twin", "ok": ok, "card": _card(),
           "twin_busy": twin_busy, "twin_loss_rel": loss_rel,
           "twin_param_rel": param_rel, "twin_limit": FUSED_TWIN_REL,
           "requests": recs, "folded_vs_unfused_rel": rel,
           "fold_limit": FOLD_REL,
           "phase_seconds": time.perf_counter() - t0}
    emit(rec)
    if not ok:
        raise AssertionError("fused_stacked_lstm: %s" % rec)
    return launched


def phase_fused_ctr(fluid, counters):
    """The fused CTR model: window, step phase, the twin, one step of
    each, the requests. Returns the window's launches."""
    tool = _fusion_tool()
    w = tool.CTR
    t0 = time.perf_counter()
    m = tool.fused_ctr(fluid, seed=SEED)
    twin = tool.ctr(fluid, seed=SEED)
    launched, scope = _det_window(
        "fused_ctr", fluid, counters, m, t0, tool.ctr_batch, FUSED_STEPS,
        {"examples": w["batch"]}, lowerings=FUSION_LOWERINGS)
    t0 = time.perf_counter()
    feed = tool.ctr_batch(SEED + 40)
    twin_busy = _twin_busy(fluid, twin, feed)
    loss_rel, param_rel = _twin_steps(fluid, m, twin, feed)
    feeds = [{k: v for k, v in tool.ctr_batch(SEED + 50 + k).items()
              if k != "label"} for k in range(FUSED_REQUESTS)]
    names = list(feeds[0])
    fused = m.main.clone(for_test=True)._prune(names, [m.out.name])
    plain = twin.main.clone(for_test=True)._prune(names, [twin.out.name])
    recs, rel, finite = _request_pair(fluid, counters, fused, plain, scope,
                                      feeds, m.out.name, w["batch"])
    ok = loss_rel <= FUSED_TWIN_REL and param_rel <= FUSED_TWIN_REL and \
        rel <= FUSED_TWIN_REL and finite and \
        all(r["ok"] for r in recs.values())
    rec = {"phase": "fused_ctr_twin", "ok": ok, "card": _card(),
           "twin_busy": twin_busy, "twin_loss_rel": loss_rel,
           "twin_param_rel": param_rel, "twin_limit": FUSED_TWIN_REL,
           "requests": recs, "fused_vs_unfused_rel": rel,
           "phase_seconds": time.perf_counter() - t0}
    emit(rec)
    if not ok:
        raise AssertionError("fused_ctr: %s" % rec)
    return launched


def phase_fused_resnet50(fluid, counters):
    """ResNet-50's request, folded and its conv epilogues fused, against
    the transpiled unfused request. Returns its launches (none)."""
    import torch
    tool = _fusion_tool()
    w = tool.RESNET
    t0 = time.perf_counter()
    exe, scope = fluid.Executor(), fluid.Scope()
    m = tool.fused_resnet50(fluid, exe, fluid.CUDAPlace(0), scope, seed=SEED)
    transpile_s = time.perf_counter() - t0
    feeds = [tool.resnet_batch(SEED + 50 + k) for k in range(FUSED_REQUESTS)]
    _zero(counters)
    recs, rel, finite = _request_pair(fluid, counters, m.main,
                                      m.extra["unfused"], scope, feeds,
                                      m.out.name, w["batch"])
    launched = _read(counters)
    block = m.main.global_block()
    ok = m.extra["fused_ops"] == RESNET_FUSED_CONVS and \
        rel <= FUSED_TWIN_REL and finite and \
        all(r["ok"] for r in recs.values()) and \
        "conv2d" not in {op.type for op in block.ops}
    rec = {"phase": "fused_resnet50", "ok": ok, "card": _card(),
           "conv2d_fusion_ops": m.extra["fused_ops"],
           "ops": len(block.ops),
           "unfused_ops": len(m.extra["unfused"].global_block().ops),
           "transpile_and_fuse_seconds": transpile_s, "requests": recs,
           "fused_vs_unfused_rel": rel,
           "peak_memory_bytes": torch.cuda.max_memory_allocated(),
           "phase_seconds": time.perf_counter() - t0}
    emit(rec)
    if not ok:
        raise AssertionError("fused_resnet50: %s" % rec)
    return launched


def phase_fusion_chain(fluid, counters):
    """The chain at CHAIN's widths: a window with every fused output
    finite, then its _step phase. Returns the window's launches."""
    import torch
    tool = _fusion_tool()
    t0 = time.perf_counter()
    m = tool.fusion_chain(fluid, seed=SEED)
    outs = [v for vs in m.extra["outputs"].values() for v in vs]

    def check(scope, extra):
        finite = [bool(torch.isfinite(v).all()) for v in extra]
        return {"outputs_checked": len(finite),
                "fused_op_types": sorted(m.extra["outputs"])}, all(finite)
    one = tool.chain_batch(SEED)
    launched, _ = _det_window(
        "fusion_chain", fluid, counters, m, t0, lambda seed: one,
        FUSED_STEPS, {"chains": 1}, (outs, check),
        lowerings=FUSION_LOWERINGS)
    return launched


def _timed_host(name, times):
    """Executor host handler `name` wrapped to append its ms (the card
    synchronized before and after) to `times`; returns the original."""
    import torch
    from paddle_tpu_torch.fluid import executor as E
    real = E._HOST_HANDLERS[name]

    def run(exe, op, st):
        torch.cuda.synchronize()
        t = time.perf_counter()
        real(exe, op, st)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    E._HOST_HANDLERS[name] = run
    return real


def _py_reader_window(fluid, counters, tool):
    """ResNet-50 trained from its PyReader to the reader's end, then on
    the same batches fed as numpy: each batch's feed ms (the wait on the
    reader's queue) and step ms, the busy share of a numpy-fed step and
    of a reader-fed one (the reader's second pass, after its first
    batch), the copy of a batch's images to the card."""
    import numpy as np
    import torch
    m, reader = tool.resnet_reader(fluid, seed=SEED,
                                   batches=READER_BATCHES)
    exe, scope = fluid.Executor(), fluid.Scope()
    exe.run(m.startup, scope=scope)
    batches = tool.image_batches(SEED, batches=READER_BATCHES)
    exe.run(m.main, feed=batches[0], fetch_list=[m.loss], scope=scope)
    torch.cuda.synchronize()
    gc.collect()
    feed_ms, step_ms, losses = [], [], []
    _zero(counters)
    reader.start()
    while True:
        t = time.perf_counter()
        try:
            feed = reader.next()
        except StopIteration:
            break
        t1 = time.perf_counter()
        loss, = exe.run(m.main, feed=feed, fetch_list=[m.loss], scope=scope,
                        return_numpy=False)
        torch.cuda.synchronize()
        feed_ms.append((t1 - t) * 1e3)
        step_ms.append((time.perf_counter() - t1) * 1e3)
        losses.append(float(loss.reshape(-1)[0]))
    launched = _read(counters)
    numpy_ms = []
    for b in batches:
        t = time.perf_counter()
        exe.run(m.main, feed=b, fetch_list=[m.loss], scope=scope,
                return_numpy=False)
        torch.cuda.synchronize()
        numpy_ms.append((time.perf_counter() - t) * 1e3)
    wall, busy, by_kind = _busy_share(lambda: exe.run(
        m.main, feed=batches[0], fetch_list=[m.loss], scope=scope,
        return_numpy=False))
    # the reader's second pass: its first step (the wait for the first
    # batch) unprofiled, the next two profiled, the rest read off
    reader.start()
    exe.run(m.main, feed=reader.next(), fetch_list=[m.loss], scope=scope,
            return_numpy=False)
    r_wall, r_busy, r_kind = _busy_share(lambda: exe.run(
        m.main, feed=reader.next(), fetch_list=[m.loss], scope=scope,
        return_numpy=False))
    while True:
        try:
            reader.next()
        except StopIteration:
            break
    _, places = _sync_places(lambda: exe.run(
        m.main, feed=batches[0], fetch_list=[m.loss], scope=scope,
        return_numpy=False))
    img = batches[0]["img"]
    copies = []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        torch.from_numpy(img).cuda()
        torch.cuda.synchronize()
        copies.append((time.perf_counter() - t) * 1e3)
    rec = {"batch": m.extra["widths"]["batch"], "batches": len(step_ms),
           "reader_feed_ms_a_batch": feed_ms, "reader_step_ms": step_ms,
           "reader_step_ms_mean": float(np.mean(step_ms)),
           "numpy_step_ms": numpy_ms,
           "numpy_step_ms_mean": float(np.mean(numpy_ms)),
           "images_per_s_reader": len(step_ms) * img.shape[0] /
           (sum(step_ms) + sum(feed_ms)) * 1e3,
           "busy": _busy_rec(wall, busy, by_kind),
           "reader_busy": _busy_rec(r_wall, r_busy, r_kind),
           "host_syncs_a_step": len(places), "host_sync_places": places,
           "image_copy_ms": copies, "image_batch_bytes": img.nbytes,
           "losses": losses}
    ok = len(step_ms) == READER_BATCHES and \
        bool(np.isfinite(losses).all()) and not any(launched.values())
    return rec, ok, launched


def _feeder_run(fluid, counters, tool):
    """The stacked LSTM over FEEDER_BATCHES DataFeeder batches: the
    bucketed lengths and one Adam launch a batch."""
    import numpy as np
    import torch
    m, feeder = tool.lstm_feeder(fluid, fluid.CUDAPlace(0), seed=SEED)
    exe, scope = fluid.Executor(), fluid.Scope()
    exe.run(m.startup, scope=scope)
    samples = tool.ragged_samples(SEED, batches=FEEDER_BATCHES)
    lens, feed_ms, step_ms, losses = [], [], [], []
    _zero(counters)
    for batch in samples:
        t = time.perf_counter()
        feed = feeder.feed(batch)
        t1 = time.perf_counter()
        loss, = exe.run(m.main, feed=feed, fetch_list=[m.loss], scope=scope,
                        return_numpy=False)
        torch.cuda.synchronize()
        feed_ms.append((t1 - t) * 1e3)
        step_ms.append((time.perf_counter() - t1) * 1e3)
        losses.append(float(loss.reshape(-1)[0]))
        lens.append([max(len(s[0]) for s in batch),
                     int(feed["words"].shape[1])])
    launched = _read(counters)
    rec = {"longest_and_bucketed": lens, "feed_ms": feed_ms,
           "step_ms": step_ms, "losses": losses, "launches": launched}
    ok = launched["adam"] == FEEDER_BATCHES and \
        bool(np.isfinite(losses).all()) and all(
            b == max(8, 1 << (n - 1).bit_length()) for n, b in lens)
    return rec, ok, launched


def _reader_ops_run(fluid, tool):
    """The py_reader chain, the graph reader chain and the CTR reader."""
    import numpy as np
    exe = fluid.Executor()
    m, reader = tool.py_reader_chain(fluid, seed=SEED)
    slots = tool.slot_batches(SEED)
    reader.decorate_tensor_provider(lambda: iter(slots))
    scope = fluid.Scope()
    exe.run(m.startup, scope=scope)
    py_losses = [float(exe.run(m.main, feed=f, fetch_list=[m.loss],
                               scope=scope)[0]) for f in reader]
    g = tool.reader_chain(fluid)
    w = g.extra["widths"]
    scope = fluid.Scope()
    sums = [float(exe.run(g.main, fetch_list=[g.loss, g.out], scope=scope)
                  [0]) for _ in range(READER_READS)]
    shape = list(exe.run(g.main, fetch_list=[g.out],
                         scope=scope)[0].shape)
    n_samples = 9
    scope = fluid.Scope()
    scope.set(g.extra["source"], tool.finite_source(
        fluid, tool.reader_samples(SEED, n_samples)))
    reads, eof = 0, False
    try:
        for _ in range(100):
            exe.run(g.main, fetch_list=[g.loss], scope=scope)
            reads += 1
    except fluid.EOFException:
        eof = True
    path = os.path.join(IO_DIR, "ctr_slots.txt")
    os.makedirs(IO_DIR, exist_ok=True)
    t = time.perf_counter()
    rows = tool.write_ctr_file(path, SEED)
    write_s = time.perf_counter() - t
    c = tool.ctr_reader_program(fluid, path)
    scope = fluid.Scope()
    exe.run(c.main, scope=scope)
    ctr = scope.get(c.extra["reader"])
    got, t = [], time.perf_counter()
    try:
        while True:
            got.append(ctr.read())
    except fluid.EOFException:
        pass
    read_ms = (time.perf_counter() - t) * 1e3
    os.remove(path)
    labels = np.concatenate([b[0] for b in got]).reshape(-1)
    want_reads = n_samples // w["batch"] * w["passes"]
    rec = {"py_reader_losses": py_losses,
           "graph_chain_sums": sums, "graph_chain_shape": shape,
           "finite_source_reads": reads, "reads_want": want_reads,
           "eof": eof, "ctr_batches": len(got), "ctr_rows": len(labels),
           "ctr_slot_widths": [int(a.shape[1]) for a in got[0][1:]],
           "ctr_read_ms": read_ms, "ctr_write_seconds": write_s}
    ok = len(py_losses) == len(slots) and \
        bool(np.isfinite(py_losses).all()) and \
        shape == [w["batch"]] + list(w["shape"]) and eof and \
        reads == want_reads and \
        labels.tolist() == [r[0] for r in rows] and \
        len(got[0]) == 1 + tool.CTR_FILE["slots"]
    return rec, ok


def phase_input_pipeline(fluid, counters):
    """The PyReader, DataFeeder, py_reader and graph-reader paths. Returns
    their launches."""
    t0 = time.perf_counter()
    tool = _input_tool()
    reader, ok1, l1 = _py_reader_window(fluid, counters, tool)
    feeder, ok2, l2 = _feeder_run(fluid, counters, tool)
    ops, ok3 = _reader_ops_run(fluid, tool)
    ok = ok1 and ok2 and ok3
    import torch
    rec = {"phase": "input_pipeline", "ok": ok, "card": _card(),
           "py_reader_resnet50": reader, "data_feeder_lstm": feeder,
           "reader_ops": ops,
           "peak_memory_bytes": torch.cuda.max_memory_allocated(),
           "phase_seconds": time.perf_counter() - t0}
    emit(rec)
    if not ok:
        raise AssertionError("input_pipeline: %s" % rec)
    return {k: l1[k] + l2[k] for k in l1}


def _go_run(fluid, tool, widths=None):
    """go_program once on the card, its first block released after the
    parent's step: (the weight before the step, after it, the block's
    copy, the product, x, the places that waited)."""
    import threading
    import torch
    ev = threading.Event()
    m = tool.go_program(fluid, ev.wait, seed=SEED, **(widths or {}))
    exe, scope = fluid.Executor(), fluid.Scope()
    exe.run(m.startup, scope=scope)
    feed = tool.go_batch(SEED, **(widths or {}))
    before = scope.get("go_w").clone()
    exe.run(m.main, feed=feed, fetch_list=[m.loss], scope=scope)
    torch.cuda.synchronize()
    after = scope.get("go_w").clone()
    ev.set()
    kids = exe.go_join(120)
    return (before, after, kids[0].get(m.extra["snapshot"]),
            kids[1].get(m.extra["product"]), feed["x"], len(kids))


def _combine_round_trip(fluid, tool, exe, state, path):
    """save_combine of `state` ({name: tensor}) into `path` and
    load_combine back: (save ms, load ms, bytes, the loaded values)."""
    import torch
    names = sorted(state)
    dtypes = {torch.float32: "float32", torch.int64: "int64",
              torch.bfloat16: "bfloat16", torch.int32: "int32"}
    save, load = tool.combine_programs(
        fluid, names, [list(state[n].shape) for n in names],
        [dtypes[state[n].dtype] for n in names], path)
    scope = fluid.Scope()
    for n in names:
        scope.set(n, state[n])
    t = time.perf_counter()
    exe.run(save, scope=scope)
    save_ms = (time.perf_counter() - t) * 1e3
    loaded = fluid.Scope()
    t = time.perf_counter()
    exe.run(load, scope=loaded)
    if exe.device.type == "cuda":
        torch.cuda.synchronize()
    load_ms = (time.perf_counter() - t) * 1e3
    return save_ms, load_ms, os.path.getsize(path), \
        {n: loaded.get(n) for n in names}


def phase_host_ops_chain(fluid, counters):
    """Go blocks, split and merge of DeepFM's ids, py_func in a training
    step, the combined save and load of ResNet-50's persistables, and the
    other host ops. Returns the launches (the Go program's Adam)."""
    import numpy as np
    import torch
    t0 = time.perf_counter()
    tool = _input_tool()
    ftool = _fusion_tool()
    rec = {"phase": "host_ops_chain", "card": _card()}
    _zero(counters)
    before, after, snap, prod, x, n_kids = _go_run(fluid, tool)
    launched = _read(counters)
    x_dev = torch.from_numpy(x).cuda()
    rec["go"] = {"blocks_joined": n_kids,
                 "copy_is_the_weight_before": bool(torch.equal(snap,
                                                               before)),
                 "step_updated_the_weight": not bool(torch.equal(before,
                                                                 after)),
                 "product_rel": float((prod - x_dev @ before).abs().max() /
                                      (x_dev @ before).abs().max()),
                 "launches": launched}
    ok = n_kids == 2 and rec["go"]["copy_is_the_weight_before"] and \
        rec["go"]["step_updated_the_weight"] and \
        rec["go"]["product_rel"] <= FUSED_TWIN_REL and launched["adam"] == 1
    # split_ids / merge_ids at DeepFM's 106,496 ids
    m = tool.split_merge_program(fluid, seed=SEED)
    exe, scope = fluid.Executor(), fluid.Scope()
    exe.run(m.startup, scope=scope)
    feed = tool.split_ids_batch(SEED)
    fetch = [m.out.name, m.extra["direct"]]
    exe.run(m.main, feed=feed, fetch_list=fetch, scope=scope)
    times = {"split_ids": [], "merge_ids": []}
    real = {k: _timed_host(k, v) for k, v in times.items()}
    try:
        t = time.perf_counter()
        merged, direct = exe.run(m.main, feed=feed, fetch_list=fetch,
                                 scope=scope, return_numpy=False)
        torch.cuda.synchronize()
        run_ms = (time.perf_counter() - t) * 1e3
    finally:
        from paddle_tpu_torch.fluid import executor as E
        E._HOST_HANDLERS.update(real)
    _, syncs = _sync_places(lambda: exe.run(m.main, feed=feed,
                                            fetch_list=fetch, scope=scope,
                                            return_numpy=False))
    exact = bool(torch.equal(merged, direct.reshape(merged.shape)))
    rec["split_merge"] = {"ids": int(feed["ids"].size),
                          "shards": m.extra["widths"]["shards"],
                          "merged_equals_lookup": exact,
                          "split_ids_ms": times["split_ids"],
                          "merge_ids_ms": times["merge_ids"],
                          "program_ms": run_ms,
                          "host_sync_places": syncs}
    ok = ok and exact
    # py_func forward and backward in a training step
    grads = {}
    for use in (True, False):
        p = tool.py_func_programs(fluid, use, seed=SEED)
        exe, scope = fluid.Executor(), fluid.Scope()
        exe.run(p.startup, scope=scope)
        f = tool.py_func_batch(SEED)
        fetch = [p.loss.name] + [n + "@GRAD" for n in
                                 ("pf_w1", "pf_b1", "pf_w2", "pf_b2")]
        grads[use] = exe.run(p.main, feed=f, fetch_list=fetch, scope=scope)
        if use:
            torch.cuda.synchronize()
            t = time.perf_counter()
            exe.run(p.main, feed=f, fetch_list=[p.loss], scope=scope,
                    return_numpy=False)
            torch.cuda.synchronize()
            step_ms = (time.perf_counter() - t) * 1e3
            _, places = _sync_places(lambda: exe.run(
                p.main, feed=f, fetch_list=[p.loss], scope=scope,
                return_numpy=False))
    rels = [float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))
            for a, b in zip(grads[True], grads[False])]
    rec["py_func"] = {"rel_vs_tanh": rels, "limit": FUSED_TWIN_REL,
                      "step_ms": step_ms, "host_syncs_a_step": len(places),
                      "host_sync_places": places}
    ok = ok and max(rels) <= FUSED_TWIN_REL
    # save_combine / load_combine of ResNet-50's persistables
    r = ftool.resnet_request(fluid, seed=SEED)
    exe, scope = fluid.Executor(), fluid.Scope()
    exe.run(r.startup, scope=scope)
    state = {n: scope.get(n) for n in _persistables(r.main)
             if scope.get(n) is not None}
    path = os.path.join(IO_DIR, "resnet50_combined")
    os.makedirs(IO_DIR, exist_ok=True)
    save_ms, load_ms, size, loaded = _combine_round_trip(
        fluid, tool, exe, state, path)
    os.remove(path)
    same = all(torch.equal(loaded[n], state[n]) for n in state)
    rec["combine"] = {"variables": len(state), "bytes": size,
                      "save_ms": save_ms, "load_ms": load_ms,
                      "loaded_bit_for_bit": same,
                      "on_card": all(v.is_cuda for v in loaded.values())}
    ok = ok and same and rec["combine"]["on_card"]
    # delete_var, fake_init, the engine stubs
    mi = tool.misc_program(fluid)
    scope = fluid.Scope()
    out, = exe.run(mi.main, feed={"x": np.ones((2, 4), np.float32)},
                   fetch_list=[mi.out], scope=scope)
    table = scope.get(mi.extra["table"])
    raised = []
    for kind in ("tensorrt_engine", "ngraph_engine"):
        try:
            exe.run(tool.engine_program(fluid, kind), scope=fluid.Scope())
        except NotImplementedError:
            raised.append(kind)
    rec["misc"] = {"deleted": scope.get(mi.extra["deleted"]) is None,
                   "fake_init_zeros_on_card": bool(
                       table.is_cuda and not table.any()),
                   "stubs_raised": raised}
    ok = ok and rec["misc"]["deleted"] and \
        rec["misc"]["fake_init_zeros_on_card"] and len(raised) == 2 and \
        bool((out == 3).all())
    rec.update({"ok": ok, "launches": launched,
                "peak_memory_bytes": torch.cuda.max_memory_allocated(),
                "phase_seconds": time.perf_counter() - t0})
    emit(rec)
    if not ok:
        raise AssertionError("host_ops_chain: %s" % rec)
    return launched


def _shard_order(ids, rows):
    """merge_ids putting each shard's rows one shard after the other (a
    control)."""
    import torch
    dim = rows[0].shape[-1] if rows[0].dim() > 1 else 1
    return torch.cat([r.reshape(r.shape[0], dim) for r in rows])


def _lstm_x_rows_first(inputs, attrs):
    """attention_lstm's LSTMWeight read with its x rows first (a control's
    change)."""
    import torch
    lw, d = inputs["LSTMWeight"][0], inputs["C0"][0].shape[1]
    return dict(inputs, LSTMWeight=[torch.cat([lw[d:], lw[:d]])]), attrs


def _fusion_controls():
    """{program: {control: ({op type: lowering}, dtype, named op types)}}
    for fusion_lockstep's programs."""
    from paddle_tpu_torch.fluid.ops import fusion_ops as FO
    return {
        "fused_stacked_lstm": {
            "fusion_lstm_with_is_reverse_dropped": (
                {"fusion_lstm": _on_the_card(
                    FO._fusion_lstm, lambda i, a: (i, dict(
                        a, is_reverse=False)))},
                "float32", ("fusion_lstm", "grad_of:fusion_lstm"))},
        "fused_ctr": {
            "fused_embedding_seq_pool_without_its_length_mask": (
                {"fused_embedding_seq_pool": _on_the_card(
                    FO._fused_embedding_seq_pool, _without_length)},
                "float32", ("fused_embedding_seq_pool",
                            "grad_of:fused_embedding_seq_pool"))},
        "fusion_chain": {
            "attention_lstm_with_lstm_weight_x_rows_first": (
                {"attention_lstm": _on_the_card(FO._attention_lstm,
                                                _lstm_x_rows_first)},
                "float32", ("attention_lstm", "grad_of:attention_lstm"))}}


def _cpu_resnet_state(fluid, tool):
    """fused_resnet50 at RESNET_PARITY's widths built on the CPU: (the
    model, its persistables after the fold)."""
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    m = tool.fused_resnet50(fluid, exe, fluid.CPUPlace(), scope, seed=SEED,
                            **RESNET_PARITY)
    state = {n: scope.get(n) for n in _persistables(m.main)
             if scope.get(n) is not None}
    return m, state


def _lockstep_programs(fluid, results):
    """fusion_lockstep's cases and controls into `results`."""
    from unittest import mock
    from paddle_tpu_torch.fluid.ops import fusion_ops as FO
    from paddle_tpu_torch.fluid.ops import registry
    tool = _fusion_tool()
    controls = _fusion_controls()
    for name, widths in FUSION_PARITY.items():
        build, batch, _ = tool.PROGRAMS[name]
        m = build(fluid, seed=SEED, **widths)
        feeds = [batch(SEED + 300, **widths)]
        _, rec, ok = _lockstep(fluid, m[:3], feeds)
        results[name] = dict(rec, ok=ok)
        for cname, (lowerings, dtype, named) in controls[name].items():
            with mock.patch.dict(registry._LOWERINGS, **lowerings):
                _, rec, passed = _lockstep(fluid, m[:3], feeds)
            results["control_" + cname] = dict(rec, ok=_named_miss(
                rec, passed, dtype, named))
    # the stacked LSTM's fused and unfused whole steps on the card
    w = FUSION_PARITY["fused_stacked_lstm"]
    loss_rel, param_rel = _twin_steps(
        fluid, tool.fused_stacked_lstm(fluid, seed=SEED, **w),
        tool.stacked_lstm(fluid, seed=SEED, **w),
        tool.stacked_batch(SEED + 301, **w))
    results["stacked_lstm_fused_vs_unfused_on_the_card"] = {
        "loss_rel": loss_rel, "param_rel": param_rel,
        "limit": FUSED_TWIN_REL,
        "ok": loss_rel <= FUSED_TWIN_REL and param_rel <= FUSED_TWIN_REL}
    # the folded request replayed
    twin = tool.stacked_lstm(fluid, seed=SEED, **w)
    state = _cpu_state(fluid, twin)
    scope = fluid.Scope()
    for n, t in state.items():
        scope.set(n, t)
    tool.fold_embedding_fc(scope)
    state[tool.FOLD] = scope.get(tool.FOLD)
    req = tool.stacked_lstm_request(fluid, True, **w)
    feed = tool.stacked_batch(SEED + 302, **w)
    feed.pop("label")
    rec, ok, _ = _replay_program(fluid, req.main, [req.out.name], {
        n: state[n] for n in _persistables(req.main)}, feed)
    results["stacked_lstm_folded_request"] = dict(rec, ok=ok)
    # ResNet's fused request replayed, and without its residual
    m, state = _cpu_resnet_state(fluid, tool)
    feed = tool.resnet_batch(SEED + 303, **RESNET_PARITY)
    rec, ok, _ = _replay_program(fluid, m.main, [m.out.name], state, feed)
    results["fused_resnet_request"] = dict(rec, ok=ok)
    with mock.patch.dict(registry._LOWERINGS, conv2d_fusion=_on_the_card(
            FO._conv2d_fusion, lambda i, a: (dict(i, ResidualData=[]), a))):
        rec, passed, _ = _replay_program(fluid, m.main, [m.out.name], state,
                                         feed)
    results["control_conv2d_fusion_without_its_residual"] = dict(
        rec, ok=_named_miss(rec, passed, "float32", ("conv2d_fusion",)))


def _split_merge_values(fluid, tool, place, table=None):
    """split_merge_program at its full width on `place`: (the table, the
    merged rows and the shards, as numpy)."""
    import torch
    exe = fluid.Executor(place)
    m = tool.split_merge_program(fluid, seed=SEED)
    scope = fluid.Scope()
    exe.run(m.startup, scope=scope)
    if table is not None:
        scope.set("split_table", torch.from_numpy(table).to(exe.device))
    got = exe.run(m.main, feed=tool.split_ids_batch(SEED),
                  fetch_list=[m.out.name] + m.extra["shards"], scope=scope)
    return fluid.executor.as_numpy(scope.get("split_table")), got


def _lockstep_host(fluid, results):
    """host_io_lockstep's cases into `results`: split_ids / merge_ids,
    the bucketed feeds, the combined file, the Go block's copy, and their
    two controls."""
    import numpy as np
    import torch
    from unittest import mock
    from paddle_tpu_torch.fluid import host_ops
    tool = _input_tool()
    table, cpu = _split_merge_values(fluid, tool, fluid.CPUPlace())
    _, card = _split_merge_values(fluid, tool, fluid.CUDAPlace(0), table)
    same = [bool(np.array_equal(a, b)) for a, b in zip(card, cpu)]
    results["split_merge_ids"] = {"outputs": len(same),
                                  "bit_for_bit": all(same), "ok": all(same)}
    with mock.patch.object(host_ops, "merge_rows", _shard_order):
        _, control = _split_merge_values(fluid, tool, fluid.CUDAPlace(0),
                                         table)
    results["control_merge_ids_in_shard_order"] = {
        "merged_equal": bool(np.array_equal(control[0], cpu[0])),
        "ok": not np.array_equal(control[0], cpu[0])}
    feeds = []
    for place in (fluid.CPUPlace(), fluid.CUDAPlace(0)):
        m, feeder = tool.lstm_feeder(fluid, place, seed=SEED)
        feeds.append([feeder.feed(b) for b in
                      tool.ragged_samples(SEED, batches=FEEDER_BATCHES)])
    same = all(np.array_equal(a[k], b[k]) for a, b in zip(*feeds)
               for k in a)
    results["data_feeder_bucketed_feeds"] = {
        "lengths": [int(f["words"].shape[1]) for f in feeds[1]],
        "ok": bool(same)}
    r = _fusion_tool().resnet_request(fluid, seed=SEED, **RESNET_PARITY)
    state = _cpu_state(fluid, r)
    arrays = {}
    for place in ("cpu", "cuda"):
        exe = fluid.Executor(fluid.CPUPlace() if place == "cpu" else None)
        path = os.path.join(IO_DIR, "combined_" + place)
        os.makedirs(IO_DIR, exist_ok=True)
        _combine_round_trip(fluid, tool, exe, {
            n: t.to(place, copy=True) for n, t in state.items()}, path)
        with np.load(path) as z:
            arrays[place] = {k: z[k].tobytes() for k in z.files}
        os.remove(path)
    results["combined_file_arrays"] = {
        "arrays": len(arrays["cpu"]),
        "ok": arrays["cpu"] == arrays["cuda"]}
    before, after, snap, _, _, _ = _go_run(fluid, tool)
    results["go_block_copy"] = {"ok": bool(torch.equal(snap, before)) and
                                not bool(torch.equal(before, after))}
    with mock.patch.object(host_ops, "_snapshot", lambda v: v):
        before, after, snap, _, _, _ = _go_run(fluid, tool)
    results["control_go_block_without_its_input_clone"] = {
        "copy_equals_the_weight_before": bool(torch.equal(snap, before)),
        "ok": not bool(torch.equal(snap, before))}


def _lockstep_verdict(phase, t0, results):
    """Emit a lockstep phase's line from its `results`; raise if any case
    or control failed."""
    failed = [k for k, r in results.items() if not r["ok"]]
    emit({"phase": phase, "ok": not failed, "card": _card(),
          "results": results,
          "controls": sorted(k for k in results if k.startswith("control_")),
          "phase_seconds": time.perf_counter() - t0})
    if failed:
        raise AssertionError("%s: %s failed" % (phase, failed))


def phase_fusion_lockstep(fluid):
    """The fused programs and requests in lockstep with the CPU; four
    controls."""
    t0 = time.perf_counter()
    results = {}
    _lockstep_programs(fluid, results)
    _lockstep_verdict("fusion_lockstep", t0, results)


def phase_host_io_lockstep(fluid):
    """The host ops' and the feeds' exact values against the CPU's; two
    controls."""
    t0 = time.perf_counter()
    results = {}
    _lockstep_host(fluid, results)
    _lockstep_verdict("host_io_lockstep", t0, results)


def fusion_phases(fluid, counters, add):
    """The fused ops' phases, each with its launches added."""
    add(phase_fused_stacked_lstm(fluid, counters))
    add(phase_fused_ctr(fluid, counters))
    add(phase_fused_resnet50(fluid, counters))
    add(phase_fusion_chain(fluid, counters))
    phase_fusion_lockstep(fluid)


def host_io_phases(fluid, counters, add):
    """The input pipeline's and the host ops' phases."""
    add(phase_input_pipeline(fluid, counters))
    add(phase_host_ops_chain(fluid, counters))
    phase_host_io_lockstep(fluid)


# recordio_io: dataset.flowers.train()'s 256 synthetic samples (3x224x224
# f32 images, labels as [1] int64, about 154 MB) written into one record
# file and split over RECORDIO_FILES files, in a temporary directory that
# the phase deletes; the one file read by RecordScanner, the split ones by
# MultiFileFeeder at RECORDIO_THREADS threads (the page cache warm from
# the write): MB/s of the records' bytes, the decoded samples held against
# those written by a digest (in order for the scanner, as a multiset for
# the feeder). A copy with one payload byte flipped must raise through
# RecordScanner; the feeder's records from it are counted (it drops the
# rest of a file silently, as the JAX package's does: ROADMAP Queue 3).
# Each dataset module's first 64 train samples (no cache present) must
# give the digest tools/torch_recordio_programs.py pins, which the CPU
# tests hold against the JAX package.
RECORDIO_FILES = 4
RECORDIO_THREADS = 4
# recordio_resnet50: bench.py's ResNet-50 leg in f32 (224, 1,000 classes,
# Momentum(0.01, 0.9), batch 64) reading that file through
# create_recordio_file_reader -> create_batch_reader(64) ->
# create_double_buffer_reader -> read: 4 batches, then EOFException, then a
# second pass (its first step unprofiled, the next two traced for the busy
# share, the fourth, then EOFException again). The read op's host ms (the
# card synchronized around it) and a batch's pageable copy to the card.
# Card check: the first reader-fed step's loss bit for bit the numpy-fed
# twin's on the same 64 samples from the same state; the control, the
# batch with its last sample swapped for the next batch's first, must
# differ. No port kernel is on this path.
RECORDIO_RESNET_PASSES = 2
# async_ctr: bench.py's DeepFM leg (26 fields, vocab 100,000, embed 16, MLP
# 128-64, sparse tables, Adam(1e-3), batch 4,096) through
# AsyncExecutor.run(thread_num=4) over 4 record files of 32,768 seeded
# samples (ids repeat in a batch): 8 steps, one Adam launch each (the
# [416, 128] weight), every sample fed once (the fetched ids and labels
# against those written, as multisets), then the same run traced for its
# busy share. Card check: AsyncExecutor.run(thread_num=1) over one file of
# the samples in order gives, bit for bit, the losses of an Executor.run
# loop over the same batches from the same state; the control, the loop
# with its second batch skipped, must differ.
ASYNC_THREADS = 4


def _recordio_tool():
    return _load_tool("torch_recordio_programs")


def _scope_copy(fluid, scope):
    """A new scope holding a copy of each of `scope`'s tensors."""
    import torch
    out = fluid.Scope()
    for n, v in scope._vars.items():
        out.set(n, v.clone() if isinstance(v, torch.Tensor) else v)
    return out


def _mb_s(nbytes, seconds):
    return nbytes / seconds / 1e6


def phase_recordio_io(fluid):
    """Record files written and read at the flowers images' size, a
    corrupt copy, and the dataset modules' digests."""
    import shutil
    import tempfile
    from paddle_tpu_torch import dataset, native
    from paddle_tpu_torch.reader import recordio as rio
    t0 = time.perf_counter()
    tool = _recordio_tool()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_recordio_")
    try:
        t = time.perf_counter()
        samples = tool.image_samples(fluid)
        draw_s = time.perf_counter() - t
        sample_bytes = sum(s[0].nbytes + s[1].nbytes for s in samples)
        written = [tool.sample_digest(s) for s in samples]
        one = os.path.join(tmp, "flowers.rec")
        t = time.perf_counter()
        n_one = tool.write_samples(fluid, one, samples)
        write_one_s = time.perf_counter() - t
        t = time.perf_counter()
        split = rio.convert_reader_to_recordio_files(
            os.path.join(tmp, "flowers"), len(samples) // RECORDIO_FILES,
            lambda: iter(samples))
        write_split_s = time.perf_counter() - t
        one_bytes = os.path.getsize(one)
        split_bytes = sum(os.path.getsize(p) for p in split)
        t = time.perf_counter()
        with native.RecordScanner(one) as sc:
            recs = list(sc)
        scan_s = time.perf_counter() - t
        t = time.perf_counter()
        scanned = [tool.sample_digest(rio.decode_sample(r)) for r in recs]
        decode_s = time.perf_counter() - t
        t = time.perf_counter()
        with native.MultiFileFeeder(split, RECORDIO_THREADS) as f:
            fed = list(f)
        feed_s = time.perf_counter() - t
        fed_digests = sorted(tool.sample_digest(rio.decode_sample(r))
                             for r in fed)
        del recs, fed
        bad = os.path.join(tmp, "corrupt.rec")
        blob = bytearray(open(split[0], "rb").read())
        blob[24 + 100] ^= 0xFF            # inside the first chunk's payload
        open(bad, "wb").write(bytes(blob))
        try:
            with native.RecordScanner(bad) as sc:
                list(sc)
            corrupt_raised = False
        except IOError:
            corrupt_raised = True
        with native.MultiFileFeeder([bad], 1) as f:
            feeder_from_corrupt = sum(1 for _ in f)
        home = os.path.join(tmp, "empty_data_home")
        os.makedirs(home)
        saved, dataset.common.DATA_HOME = dataset.common.DATA_HOME, home
        try:
            digests = {name: tool.dataset_digest(stream(dataset))
                       for name, stream in tool.DATASET_STREAMS.items()}
        finally:
            dataset.common.DATA_HOME = saved
    finally:
        shutil.rmtree(tmp)
    wrong = sorted(n for n, d in digests.items()
                   if d != tool.DATASET_DIGESTS[n])
    rec = {"phase": "recordio_io", "card": _card(),
           "samples": len(samples), "sample_bytes": sample_bytes,
           "draw_seconds": draw_s,
           "one_file": {"records": n_one, "bytes": one_bytes,
                        "write_seconds": write_one_s,
                        "write_mb_s": _mb_s(one_bytes, write_one_s),
                        "scan_seconds": scan_s,
                        "scan_mb_s": _mb_s(one_bytes, scan_s),
                        "decode_seconds": decode_s,
                        "in_order": scanned == written},
           "split_files": {"files": len(split), "bytes": split_bytes,
                           "write_seconds": write_split_s,
                           "write_mb_s": _mb_s(split_bytes, write_split_s),
                           "threads": RECORDIO_THREADS,
                           "feeder_seconds": feed_s,
                           "feeder_mb_s": _mb_s(split_bytes, feed_s),
                           "same_samples": fed_digests == sorted(written)},
           "page_cache": "warm (read just after the write)",
           "corrupt_copy_raised": corrupt_raised,
           "feeder_records_from_corrupt_copy": feeder_from_corrupt,
           "dataset_digests": digests, "dataset_digests_wrong": wrong,
           "phase_seconds": time.perf_counter() - t0}
    rec["ok"] = bool(n_one == len(samples) == len(scanned) and
                     scanned == written and fed_digests == sorted(written)
                     and corrupt_raised and not wrong)
    emit(rec)
    if not rec["ok"]:
        raise AssertionError("recordio_io: %s" % rec)


def _loss_bits(loss):
    """A fetched float32 loss's bytes."""
    import numpy as np
    return np.asarray(loss, np.float32).tobytes()


def phase_recordio_resnet50(fluid, counters):
    """ResNet-50 trained from a record file through the graph reader ops;
    its first step against the numpy-fed twin's. Returns its launches."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    t0 = time.perf_counter()
    tool = _recordio_tool()
    w = tool.RESNET
    tmp = tempfile.mkdtemp(prefix="chip_smoke_recordio_")
    try:
        samples = tool.image_samples(fluid)
        path = os.path.join(tmp, "flowers.rec")
        tool.write_samples(fluid, path, samples)
        batches = len(samples) // w["batch"]
        with fluid.unique_name.guard():
            m = tool.recordio_resnet(fluid, path, seed=SEED)
        with fluid.unique_name.guard():
            twin = tool.recordio_resnet(fluid, path, seed=SEED, reader=False)
        exe = fluid.Executor()
        scope = fluid.Scope()
        exe.run(m.startup, scope=scope)
        start = _scope_copy(fluid, scope)
        first = tool.image_feed(samples[:w["batch"]])
        swapped = tool.image_feed(samples[:w["batch"] - 1] +
                                  samples[w["batch"]:w["batch"] + 1])
        twin_loss, control_loss = [
            exe.run(twin.main, feed=feed, fetch_list=[twin.loss],
                    scope=_scope_copy(fluid, start))[0]
            for feed in (first, swapped)]
        del start
        torch.cuda.synchronize()
        gc.collect()
        read_ms, step_ms, losses, eofs = [], [], [], []
        busy = None
        run = lambda: exe.run(m.main, fetch_list=[m.loss], scope=scope)[0]
        real = _timed_host("read", read_ms)
        _zero(counters)
        try:
            for p in range(RECORDIO_RESNET_PASSES):
                k = 0
                while k < batches:
                    if p == 1 and k == 1:
                        busy = _busy_share(run, n=2)
                        k += 2
                        continue
                    t = time.perf_counter()
                    loss = run()
                    step_ms.append((time.perf_counter() - t) * 1e3)
                    losses.append(float(np.asarray(loss).reshape(-1)[0]))
                    if p == 0 and k == 0:
                        reader_loss = loss
                    k += 1
                try:
                    run()
                    eofs.append(False)
                except fluid.EOFException:
                    eofs.append(True)
        finally:
            from paddle_tpu_torch.fluid import executor as E
            E._HOST_HANDLERS["read"] = real
        launched = _read(counters)
        copies = []
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            torch.from_numpy(first["img"]).cuda()
            torch.cuda.synchronize()
            copies.append((time.perf_counter() - t) * 1e3)
    finally:
        shutil.rmtree(tmp)
    wall, busy_ms, by_kind = busy
    bit_equal = _loss_bits(reader_loss) == _loss_bits(twin_loss)
    control_differs = _loss_bits(control_loss) != _loss_bits(twin_loss)
    rec = {"phase": "recordio_resnet50", "card": _card(),
           "batch": w["batch"], "batches_a_pass": batches,
           "passes": RECORDIO_RESNET_PASSES, "eof_after_each_pass": eofs,
           "step_ms": step_ms,
           "step_ms_mean_after_the_first": float(np.mean(step_ms[1:])),
           "images_per_s": w["batch"] / np.mean(step_ms[1:]) * 1e3,
           "read_op_host_ms": read_ms,
           "busy": _busy_rec(wall, busy_ms, by_kind),
           "image_copy_ms": copies, "image_batch_bytes": first["img"].nbytes,
           "losses": losses,
           "reader_loss": float(np.asarray(reader_loss).reshape(-1)[0]),
           "twin_loss": float(np.asarray(twin_loss).reshape(-1)[0]),
           "first_step_bit_for_bit": bit_equal,
           "control_loss": float(np.asarray(control_loss).reshape(-1)[0]),
           "control_differs": control_differs, "launches": launched,
           "peak_memory_bytes": torch.cuda.max_memory_allocated(),
           "phase_seconds": time.perf_counter() - t0}
    rec["ok"] = bool(eofs == [True] * RECORDIO_RESNET_PASSES and
                     len(losses) == 2 * batches - 2 and
                     np.isfinite(losses).all() and bit_equal and
                     control_differs and not any(launched.values()))
    emit(rec)
    if not rec["ok"]:
        raise AssertionError("recordio_resnet50: %s" % rec)
    return launched


def _ctr_rows(samples):
    """(ids, label) samples as the rows of one float64 array (the ids
    exact), sorted: a multiset to compare."""
    import numpy as np
    a = np.concatenate([np.stack([s[0] for s in samples]),
                        np.stack([s[1] for s in samples])], axis=1,
                       dtype=np.float64)
    return a[np.lexsort(a.T[::-1])]


def phase_async_ctr(fluid, counters):
    """DeepFM trained by AsyncExecutor from record files; its losses
    against an Executor.run loop. Returns the launches of the main run."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    t0 = time.perf_counter()
    tool = _recordio_tool()
    w = tool.CTR
    tmp = tempfile.mkdtemp(prefix="chip_smoke_recordio_")
    try:
        rows = tool.ctr_samples(SEED)
        t = time.perf_counter()
        paths = tool.write_ctr_files(fluid, os.path.join(tmp, "ctr"), rows)
        write_s = time.perf_counter() - t
        one = os.path.join(tmp, "ctr_all.rec")
        tool.write_samples(fluid, one, rows)
        with fluid.unique_name.guard():
            m = tool.ctr_programs(fluid, seed=SEED)
        exe = fluid.AsyncExecutor()            # CUDAPlace(0)
        desc = fluid.DataFeedDesc(slots=m.feeds, batch_size=w["batch"])
        feeds = tool.ctr_feeds(rows, w["batch"])
        scope = fluid.Scope()
        with fluid.scope_guard(scope):
            exe.run(m.startup)
            start = _scope_copy(fluid, scope)
            warm = tool.ctr_feeds(tool.ctr_samples(SEED + 1), w["batch"])[0]
            exe.run(m.main, feed=warm, fetch_list=[m.loss])
            torch.cuda.synchronize()
            gc.collect()
            _zero(counters)
            t = time.perf_counter()
            out = exe.run(m.main, data_feed=desc, filelist=paths,
                          thread_num=ASYNC_THREADS,
                          fetch=["feat_ids", "label", m.loss])
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t
            launched = _read(counters)
            wall, busy_ms, by_kind = _busy_share(lambda: exe.run(
                m.main, data_feed=desc, filelist=paths,
                thread_num=ASYNC_THREADS, fetch=[m.loss]), n=1)
        fed = [(i, l) for ids, labels, _ in out
               for i, l in zip(ids, labels)]
        every_once = len(fed) == len(rows) and bool(
            (_ctr_rows(fed) == _ctr_rows(rows)).all())
        # the card check: one thread over one file against a loop
        checks = {}
        for name, run_feeds in (("loop", feeds),
                                ("control", feeds[:1] + feeds[2:])):
            sc = _scope_copy(fluid, start)
            checks[name] = [exe.run(m.main, feed=f, fetch_list=[m.loss],
                                    scope=sc)[0] for f in run_feeds]
        sc = _scope_copy(fluid, start)
        with fluid.scope_guard(sc):
            checks["async"] = [o[0] for o in exe.run(
                m.main, data_feed=desc, filelist=[one], thread_num=1,
                fetch=[m.loss])]
    finally:
        shutil.rmtree(tmp)
    bits = {k: [_loss_bits(v) for v in vs] for k, vs in checks.items()}
    bit_equal = bits["async"] == bits["loop"]
    control_differs = bits["control"] != bits["async"][:len(bits["control"])]
    steps = len(out)
    losses = [float(np.asarray(o[2]).reshape(-1)[0]) for o in out]
    rec = {"phase": "async_ctr", "card": _card(), "batch": w["batch"],
           "samples": len(rows), "files": len(paths),
           "threads": ASYNC_THREADS, "steps": steps,
           "write_seconds": write_s, "run_seconds": wall_s,
           "steps_per_s": steps / wall_s,
           "examples_per_s": len(rows) / wall_s,
           "busy": _busy_rec(wall, busy_ms, by_kind),
           "every_sample_once": every_once, "losses": losses,
           "one_thread_losses": [float(np.asarray(v).reshape(-1)[0])
                                 for v in checks["async"]],
           "one_thread_bit_for_bit_the_loop": bit_equal,
           "control_losses": [float(np.asarray(v).reshape(-1)[0])
                              for v in checks["control"]],
           "control_differs": control_differs, "launches": launched,
           "phase_seconds": time.perf_counter() - t0}
    rec["ok"] = bool(steps == len(rows) // w["batch"] and every_once and
                     launched["adam"] == steps and
                     sum(launched.values()) == steps and
                     np.isfinite(losses).all() and bit_equal and
                     control_differs)
    emit(rec)
    if not rec["ok"]:
        raise AssertionError("async_ctr: %s" % rec)
    return launched


def recordio_phases(fluid, counters, add):
    """The record files, ResNet-50 from a record file and DeepFM through
    AsyncExecutor."""
    phase_recordio_io(fluid)
    add(phase_recordio_resnet50(fluid, counters))
    add(phase_async_ctr(fluid, counters))


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
        from paddle_tpu_torch.models import (bert, deepfm, resnet,
                                             se_resnext, transformer)
        from paddle_tpu_torch.ops import attention as A
    except ImportError as e:
        print("chip_smoke: run from the root of a checkout (%s)" % e,
              file=sys.stderr)
        return 2

    phase_build()
    counters = _counters()
    launches = dict.fromkeys(counters, 0)

    def add(launched):
        for k, n in launched.items():
            launches[k] += n

    slices = {"--control-flow": control_flow_phases,
              "--sequences": sequence_phases,
              "--recurrent": recurrent_phases,
              "--decoding": decoding_phases,
              "--ctc": ctc_pool_phases,
              "--detection": detection_phases,
              "--compression": compression_phases,
              "--fusion": fusion_phases,
              "--host-io": host_io_phases,
              "--recordio": recordio_phases}
    if len(sys.argv) == 2 and sys.argv[1] in slices:
        # one slice's phases alone (no kernel line, no contract line)
        slices[sys.argv[1]](fluid, counters, add)
        emit({"phase": sys.argv[1][2:].replace("-", "_") + "_only",
              "card": _card(), "launches": launches})
        return 0
    summary, max_err = phase_kernels()

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
    # the Fluid Transformer's recipe (label smoothing, Noam rate, Adam at
    # beta2 0.997 and epsilon 1e-9) at bench.py's width: train256's
    # launches a step, no cross-entropy kernel (soft labels)
    add(phase_train256_recipe(fluid, transformer, counters, cfg, train))
    phase_recipe_parity(fluid, transformer, counters)

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
    phase_row_sums()
    add(phase_checkpoint(fluid, transformer, counters))

    # benchmark/fluid_benchmark.py's image zoo: SE-ResNeXt-50 at full width
    # (one Adam launch a step over its 19 admitted parameters), its parity,
    # and every model of tools/torch_fluid_benchmark.py
    with fluid.unique_name.guard():
        add(phase_se_resnext50(fluid, se_resnext, counters))
    phase_se_resnext_parity(fluid, se_resnext, counters)
    add(phase_zoo(fluid, counters, [m for m in ZOO_LAUNCHES
                                     if m not in ZOO_RECURRENT]))
    # every other Fluid optimizer, ModelAverage, append_LARS and the
    # learning-rate schedules
    phase_optimizers(fluid, counters)
    # the Fluid book's straight-line models
    add(phase_book(fluid, counters))
    # the tensor layers and the initializers: tensor_chain (one Adam launch
    # a step), serve256's program turned into next-token ids (12 one-pass
    # launches a request), init_zoo's startup and examples/fc_gan.py
    with fluid.unique_name.guard():
        add(phase_tensor_layers(fluid, counters))
    add(phase_serve_ids(fluid, transformer, A, counters))
    phase_initializers(fluid)
    phase_fc_gan(fluid, counters)
    # input gradients and several backward passes over one forward (FGSM
    # training, ResNet-50's FGSM direction and saliency map), fluid.nets,
    # the fused_attention op in its default bhtd layout (rows 2, 4 and 5
    # once a call) and FLAGS_check_nan_inf
    add(phase_fgsm_digits(fluid, counters))
    add(phase_input_grads_resnet50(fluid, resnet, counters))
    add(phase_nets(fluid, counters))
    add(phase_bhtd_attention(fluid, A, counters))
    phase_check_nan_inf(fluid, transformer, cfg)
    # the rest of the NN layers: DCGAN (transposed convolutions), a spatial
    # transformer, word2vec with hsigmoid, and nn_chain (the layers at
    # ResNet-50's, C3D's, DeepSpeech's, DeepFM's and train256's widths: one
    # Adam launch a step)
    with fluid.unique_name.guard():
        add(phase_dcgan(fluid, counters))
    add(phase_stn_digits(fluid, counters))
    add(phase_word2vec_hsigmoid(fluid, counters))
    add(phase_nn_layers(fluid, counters))
    # control flow and tensor arrays: the book's RNN encoder-decoder at the
    # WMT-14 seq2seq's widths (one Adam launch a step), a While model
    # served and trained, the Switch and IfElse programs, the array ops at
    # BERT-base's widths
    control_flow_phases(fluid, counters, add)
    # ragged sequences: the book's two sentiment nets at their published
    # widths (IMDB-shaped reviews, T 1,024 or 2,048), its whole
    # recommender, and every sequence lowering at BERT-base's widths (one
    # Adam launch a step)
    sequence_phases(fluid, counters, add)
    # the recurrent ops: the zoo's stacked_dynamic_lstm and
    # machine_translation, both in lockstep, and every recurrent lowering
    # at the PTB medium LSTM's widths (one Adam launch a step)
    recurrent_phases(fluid, counters, add)
    # decoding: the book's machine translation (trained with one Adam
    # launch a step, saved, loaded and beam-searched), its semantic role
    # labelling (the CRF and Viterbi), word2vec with NCE, and all three in
    # lockstep with the CPU
    decoding_phases(fluid, counters, add)
    # CTC and index pooling: the CRNN-CTC recognizer (trained, scored by
    # evaluator.EditDistance, decoding requests), SegNet-Basic (index
    # pooling and unpool, scored by mean_iou), SPP-net, and the four
    # programs in lockstep with the CPU
    ctc_pool_phases(fluid, counters, add)
    # object detection: MobileNet-SSD (trained, then detect requests scored
    # by both DetectionMAPs), Faster R-CNN (trained, then an inference
    # request), every other detection lowering at its source's shape, and
    # the three programs in lockstep with the CPU
    detection_phases(fluid, counters, add)
    # model compression and chunk evaluation: a quantization-aware ResNet-50
    # (trained, frozen, calibrated, saved and served in int8), a ResNet-101
    # teacher distilled into a ResNet-50 student pruned by the Compressor,
    # the book's SRL tagger scored by chunk_eval, every other compression
    # lowering at its source's shape, and the four in lockstep with the CPU
    compression_phases(fluid, counters, add)
    # fused ops: the stacked LSTM fused (one Adam launch a step) and
    # served folded, a Criteo-shaped CTR model, ResNet-50's request with
    # its conv epilogues fused, every other fused op at its source's
    # shape, and the four in lockstep with the CPU
    fusion_phases(fluid, counters, add)
    # the in-process input pipeline (PyReader, DataFeeder, py_reader, the
    # graph readers) and the host ops (Go, split and merge of ids,
    # py_func, the combined save and load), their exact values held
    # against the CPU's
    host_io_phases(fluid, counters, add)
    # record files: written and read at the flowers images' size, ResNet-50
    # trained from one through the graph reader ops, DeepFM through
    # AsyncExecutor (one Adam launch a step), each with a card check
    recordio_phases(fluid, counters, add)

    print(_card())
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
        # (train256_wide), rows 1, 3, 8 and 11 at BERT-base's shapes, row
        # 11 at SE-ResNeXt-50's and at the recipe's constants, and rows 1,
        # 3 and 11 at the zoo models' float32 shapes, where the kernel runs
        # on those paths
        for key, sub in [("d256", "train256_wide"),
                         ("bert_base", "bert_base"),
                         ("se_resnext50", "se_resnext50"),
                         ("train256_recipe", "train256_recipe"),
                         ("tensor_layers", "tensor_layers"),
                         ("nn_layers", "nn_layers"),
                         ("rnn_encoder_decoder", "rnn_encoder_decoder"),
                         ("sequence_chain", "sequence_chain"),
                         ("rnn_chain", "rnn_chain"),
                         ("dec", "book_machine_translation")] + \
                [("zoo_" + m,) * 2 for m in ZOO_ADAM_CASES]:
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
