#!/usr/bin/env python3
"""Smoke run of tfimm_tpu_torch on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card, ``nvcc``
and PyTorch built for CUDA. It needs no JAX and no network. Phases, each of
which ends the run with a non-zero exit code on failure:

1. Environment: torch/CUDA/nvcc versions, the card's name and power limit;
   build the CUDA kernels from ``tfimm_tpu_torch/csrc`` and time the build.
2. Each kernel against its plain PyTorch version on the card, at the shapes
   of the main path and at the edges of its coverage, in bf16 and in f32
   with TF32 off: ``fused_mha`` within 2e-2 (bf16) and 1e-5 (f32),
   ``fused_mha_bwd`` within 2e-2 and 1e-4 of the largest plain value.
   Kernel and plain times at the ViT-B shapes (CUDA events around 20
   back-to-back calls, median of 5 such runs after warm-up), and the time of the one PyTorch call that computes
   the same function, ``F.scaled_dot_product_attention`` (for the backward:
   that call's backward alone), on the same q, k, v. Each kernel and its
   SDPA call also with their operands out of L2 (``cold_ms``), and the
   kernel's share of the bound and ratio to SDPA both ways.
3. The serving path: ``create_model("vit_base_patch16_224")`` in bf16 with
   seeded random weights answers 5 requests of 128 uint8 NHWC images through
   ``create_preprocessing`` and ``model.predict``. Every request must launch
   the fused_mha kernel once per block; outputs must be finite and agree
   with the same weights run in f32 through the plain attention. Then a
   ``torch.profiler`` split of one request's device time.
4. The training path: ``tfimm_tpu_torch.train.run`` trains ViT-B/16 at batch
   64 in bf16 mixed precision with AdamW for 6 steps on one fixed synthetic
   batch. Every step must launch fused_mha and its backward once per block,
   every loss must be finite and the last below the first. With seeded
   weights, one step's loss and gradients through the bf16 kernels must
   agree with the same weights in f32 through the plain attention. Then the
   step time, a ``torch.profiler`` split of the step's device time, and
   ``time_model(..., target="backprop", batch_size=64)``.
5. ``convnext_mlp`` against its plain version on the card at ConvNeXt-B's
   four stage shapes at batch 128 and at the edges of its coverage (C = 96,
   C = 12, M = 98), in bf16 and in f32 with TF32 off, within 2e-2 and 1e-5
   of the largest plain value. At the stage shapes, kernel, plain and
   cuBLAS-floor times (the two ``F.linear`` products alone), each with its
   rate and its share of the bound, with the operands out of L2
   (``cold_ms``) and back to back in L2; the kernel's three launches (row
   statistics, fc1, fc2) out of L2 from a profile. ptxas' registers and
   spills of the GEMM launches are printed after the build.
6. The ConvNeXt serving path: ``create_model("convnext_base")`` in bf16
   with seeded random weights (layer-scale gammas near 1) answers 5
   requests of 128 uint8 224x224 NHWC images through
   ``create_preprocessing`` and ``model.predict``. Every request must
   launch ``convnext_mlp`` once per block (36) and no attention kernel;
   logits must be finite and non-zero, and agree on 16 images with the same
   weights in f32 through the eager composition (autograd recording). Then
   a ``torch.profiler`` split of one request's device time, with each of
   ``convnext_mlp``'s three launches per request.
7. ``window_mha`` and ``swin_block`` against their plain versions on the
   card at Swin-T's stage shapes at batch 128 (shifted and unshifted) and
   at the edges of their coverage (N = 144, d = 8, 16 and 64, an odd
   window count), in bf16 and in f32 with TF32 off, within 2e-2 of the
   largest plain value in bf16 and 1e-5 (``window_mha``) or 1e-4
   (``swin_block``) in f32. Two controls: with the shift mask left out of
   the plain version a shifted stage-1 block, and with the bias left out
   the stage-1 attention, must miss the bar by far. Each case prints the
   body ``window_mha`` took (from the profiler's kernel names: the TMA +
   wgmma body or the first one); every bf16 case with N <= 64 and d <= 64
   must take the wgmma body, every other case the first. ``window_mha``
   at every stage shape (stages 1-3 unshifted and shifted, stage 4) with
   its operands out of L2 (``cold_ms``) and back to back, with its bound,
   and summed over a request (10 launches inside ``swin_block``, 2 at
   stage 4); at stage 4 also its plain version and
   ``F.scaled_dot_product_attention`` with the float mask; ``swin_block``
   at stages 1-3 beside the cuBLAS floor of its four ``F.linear``
   products. Beside each, the block run per op (cuBLAS, ``window_mha``,
   eager LayerNorm), at stages 1-3 and at stage 4, where the gate sends
   Swin-T's blocks that way, as CUDA-event and profiler device times.
8. The Swin serving path: ``create_model("swin_tiny_patch4_window7_224")``
   in bf16 with seeded random weights answers 5 requests of 128 uint8
   224x224 NHWC images. Every request must launch ``swin_block`` 10 times
   (stages 1-3) and ``window_mha`` twice (stage 4), and nothing else;
   logits must be finite and non-zero and agree on 16 images with the same
   weights in f32 on the CPU through the plain versions (which launch
   nothing). Then a ``torch.profiler`` split of one request's device time.
9. ``window_mha_bwd`` against its plain version on the card at Swin-T's
   four training shapes at batch 64 (stages 1-3 unshifted and shifted,
   stage 4 unshifted) and at the forward's edges, in bf16 and in f32 with
   TF32 off: dq, dk, dv and dbias within 2e-2 and 1e-4 of the largest plain
   value. Two controls on the shifted stage-1 input must miss the bar by
   ``CONTROL_FACTOR``: dbias against the plain version without the mask,
   and the backward against the plain version without the bias. Two calls
   must give a bit-identical dbias. Each case prints the body it took (as
   phase 7, with the same rule). Per stage: kernel times out of L2
   (``cold_ms``) and as profiler device time back to back, plain and bound
   times, and the backward alone of ``F.scaled_dot_product_attention``
   with the bias (and mask) as a float mask that requires grad.
10. The Swin training path: ``tfimm_tpu_torch.train.run`` trains Swin-T at
   batch 64 in bf16 mixed precision with AdamW (lr 1e-3, weight decay
   0.05), label smoothing 0.1, mixup 0.8, cutmix 1.0 and drop path 0.2
   for 6 steps on one fixed synthetic batch. Every step must launch
   ``window_mha`` and ``window_mha_bwd`` 12 times each and nothing else;
   every loss must be finite, and the mean of the last two below the first
   (mixup changes the targets from step to step). With seeded weights, one
   step's loss and two gradients on 8 images through the bf16 kernels must
   agree with the same weights in f32 on the CPU through the plain
   versions. Then the rate over steps 2-6, a ``torch.profiler`` split of
   one step and ``time_model(..., target="backprop", batch_size=64)``.
11. ``talking_head_attention`` against its plain version on the card at
   CaiT-S24's shape at batch 128 (N = 196, H = 8, d = 48) and at the edges
   of its coverage (H = 4; H = 6 with N = 576; H = 16 with N = 784; H = 2
   with d = 8; H = 10 with d = 72), in bf16 and in f32 with TF32 off,
   within 2e-2 and 1e-5 of the largest plain value. Two controls must miss
   the bar by
   ``CONTROL_FACTOR``: the plain version without the pre-softmax mix, and
   with w_w transposed. Each shape prints the body that took it
   (``tma.cait_route``: the Hopper body, TMA + wgmma, or the first
   design's); CaiT-S24's must launch the Hopper body. Kernel times out of
   L2 (``cold_ms``) and back to back, the wrapper's host time a call, plain
   and bound times, and the cuBLAS floor (the batched q k^T and p v
   products alone: no PyTorch call mixes heads).
12. The CaiT serving path: ``create_model("cait_s24_224")`` in bf16 with
   seeded random weights (layer scales near 1, head mixes at std 0.3)
   answers 5 requests of 128 uint8 224x224 NHWC images. Every request must
   launch ``talking_head_attention`` 24 times and nothing else (the
   class-attention blocks have no kernel); logits must be finite and
   non-zero and agree on 16 images with the same weights in f32 on the CPU
   through the plain version. Then a ``torch.profiler`` split of one
   request.
13. ``talking_head_attention_bwd`` against its plain version at the
   training shape (batch 64) and the edges: dq, dk, dv, dw_l, dw_w and db_w
   within 2e-2 (bf16) and 1e-4 (f32) of the largest plain value, db_l
   exactly 0; the plain backward with w_w transposed must miss the bar by
   ``CONTROL_FACTOR``; two calls must be bit-identical. Kernel times out
   of L2, with the forward's log2 l as a training step hands it over and
   without (the first pass recomputing it), each launch's device time out
   of L2 (``cold_launch_parts``; the phase fails if the profile kept no
   event of one), back to back, the wrapper's host time a call, plain and
   bound times, and the cuBLAS floor of the backward's five products;
   CaiT-S24's must launch the Hopper body's two launches.
14. The CaiT training path: ``tfimm_tpu_torch.train.run`` trains CaiT-S24
   at batch 64 in bf16 mixed precision with the DeiT recipe the CaiT paper
   trains with (AdamW at weight decay 0.05, label smoothing 0.1, mixup 0.8,
   cutmix 1.0, drop path 0.1, no attention dropout), lr 1e-3, for 6 steps.
   Every step must launch ``talking_head_attention`` and its backward 24
   times each and nothing else; the losses must be finite and the mean of
   the last two below the first; one seeded step on 8 images, bf16 on the
   card against f32 on the CPU: the loss within 2e-2, a ``proj_l`` and a
   qkv weight gradient within 1e-1. Then the rate over steps 2-6, a
   profile of one step and ``time_model(..., target="backprop")``.

15. ``flash_attention_relpos`` against its plain version on the card at
   SAM-B's global blocks (B = 12 heads, a 64 x 64 grid, d = 64) and
   windowed blocks of one image (B = 300, 14 x 14), and at the edges (SAM-H's
   d = 80 with 16 heads, a 48 x 64 grid, N = 49, a row whose scores pass
   80), in bf16 and in f32 with TF32 off: the output and the lse within
   2e-2 and 1e-5 of the largest plain value. Control: the plain version
   without the bias must miss the bar by ``CONTROL_FACTOR`` at the global
   shape. Kernel, plain, bound times at the two SAM-B shapes, and
   ``F.scaled_dot_product_attention`` with the bias as a float mask; the
   kernel and SDPA also with their operands out of L2 (``cold_ms``), and
   the kernel's share of the bound and ratio to SDPA both ways.
16. The SAM serving path: ``create_model("sam_vit_b")`` in bf16 with seeded
   random weights (rel-pos tables and position embedding away from their
   zero init) behind a ``SAMPredictor``, which answers requests on three
   uint8 images (1200x1800, 1024x1024, 500x700): ``set_image``, then 2
   points (multimask), 1 box, and the points with the first call's best
   low-resolution logits as the mask prompt. Every ``set_image`` must
   launch the kernel 12 times (4 global, 8 windowed blocks), the prompt
   calls none; embeddings, scores and logits finite; the first image's
   embedding and logits within 5e-2 of the same weights in f32 on the CPU
   through the plain version. Then the ``set_image`` and prompt-call
   latencies (CUDA events), the encoder's rate at batch 8 through
   ``forward_features``, and a ``torch.profiler`` split of one
   ``set_image``.
17. ``flash_attention_relpos_bwd`` against its plain version on the card at
   phase 15's shapes (SAM-B's global and windowed blocks, the edges, a row
   whose scores pass 80), in bf16 and f32 with TF32 off: dq, dk, dv, drh
   and drw within 2e-2 and 1e-4 of the largest plain value. Control: the
   plain backward without the bias must miss the bar by
   ``CONTROL_FACTOR``; two calls must be bit-identical. Kernel (its two
   launches; bf16 forms delta in the first), plain, bound times at the two
   SAM-B shapes, and the backward of ``F.scaled_dot_product_attention``
   with the bias as a bf16 float mask that requires grad, plus the two sums
   that give drh and drw.
18. SAM fine-tuning: ``create_model("sam_vit_b")`` on the card with the
   seeded weights of phase 16 in f32, run in bf16 (inputs in bf16, AdamW on
   the f32 parameters). (a) The encoder step at bs1, as the JAX package
   measures it: ``model.train()``, ``model(x, features_only=True)``, the
   f32 mean, ``backward()`` and one AdamW step, 6 times. Every step must
   launch the forward and the backward kernel 4 times each (the global
   blocks; the windows run eager in training); losses, gradients and
   parameters finite; the seeded weights' gradients of two parameters in
   bf16 on the card within 1e-1 of f32 on the CPU. Step time over steps
   2-6 (CUDA events) and a profile with the device's idle share. (b) The
   gradient through the eval-mode model: 12 + 12 launches, the pass's time
   and idle share. (c) The whole model (encoder, prompt encoder, mask
   decoder) on 2 images with one box each, ``multimask_output=False``, BCE
   of the low-resolution logits against the boxes' masks, AdamW for 6
   steps: 4 + 4 launches a step, the loss must fall; step time and idle
   share.
19. ``pvt_sra`` against its plain version on the card at pvt_v2_b2's stage 1
   at batch 128 (N = 3136, S = 49, C = 64; pvt_small's and
   pvt_v2_b2_linear's too), pvt_v2_b0's C = 32, S = 256, a ragged N,
   C = 512 and 300 images of one 64-row tile each (three tiles on some
   blocks of the TMA + wgmma body, whose two consumers then take alternate
   images), in bf16 and in f32 with TF32 off, within 2e-2 and 1e-5 of the
   largest plain value; each case's body read from one profile of them
   all (the TMA + wgmma body where ``tma.sra_route`` takes the call, the
   first bodies elsewhere). Control: the plain version with k and v
   swapped must miss the bar by ``CONTROL_FACTOR``. At every bf16 shape, kernel, plain and
   library times with the operands out of L2 (``cold_ms``; the library
   is ``F.linear`` + ``F.scaled_dot_product_attention`` + ``F.linear`` on
   the same inputs), the bound, and the kernel back to back in L2.
20. PVT serving: ``pvt_v2_b2`` in bf16 with seeded random weights answers
   5 requests of 128 uint8 224x224 images with ``TFIMM_TPU_FUSED_PVT_SRA=1``
   (3 ``pvt_sra`` launches a request, stage 1) and again with it off (0);
   ``pvt_small`` and ``pvt_v2_b2_linear`` with it on (3 each). Logits
   finite and non-zero; the first 16 images' within 5e-2 of the same
   weights in f32 on the card through the eager path; the rate of each run
   and a profile of one request of each model.
21. ``poolformer_block`` against its plain version on the card at
   poolformer_s12's four stage shapes at batch 128 and a 4x4 map, with
   layer scales and norm weights near 1, in bf16 and in f32 with TF32 off,
   within 2e-2 and 1e-4 of the largest plain value. Control: the plain
   version with ls1 = 1 must miss the bar. Kernel, plain, bound and cuBLAS
   floor (the two ``F.linear`` products alone) times per stage and per
   request.
22. PoolFormer serving: ``poolformer_s12`` in bf16 with seeded random
   weights (layer scales near 1) answers 5 requests of 128 images with
   ``TFIMM_TPU_FUSED_POOLFORMER=1`` (12 launches a request) and with it off
   (0), gated as phase 20, with the rate of each run and a profile.

23. ``convnext_block`` against its plain version on the card at ConvNeXt-B's
   four stage shapes (batch cut to 16) and the edges (ConvNeXt-T's C = 96,
   a ragged 9 x 13 map, convnext_xlarge's C = 2048 with hidden 8192), in
   bf16 and in f32 with TF32 off, within 2e-2 and 1e-4 of the largest plain
   value. Control: the plain version with the depthwise taps flipped in H
   must miss the bar by ``CONTROL_FACTOR``. At the stage shapes at batch
   128, with the operands out of L2 (a 512 MB write before each call):
   kernel, plain, bound, the per-op library block (cuDNN depthwise,
   ``F.layer_norm``, ``F.linear``, tanh ``F.gelu``, ``F.linear``, scale and
   residual) and the default path (cuDNN depthwise + ``convnext_mlp``), per
   stage and per request; the kernel's three launches (depthwise +
   LayerNorm, fc1, fc2) from a profile, and cuDNN's depthwise conv alone
   beside the first.
24. ConvNeXt serving through the fused block: ``convnext_base`` in bf16
   with seeded random weights (std 0.05, gammas near 1) answers 5 requests
   of 128 uint8 224x224 images with ``TFIMM_TPU_FUSED_CONVNEXT=1`` (36
   ``convnext_block`` launches a request, no ``convnext_mlp``) and with it
   off (36 ``convnext_mlp``), gated as phase 20, with the rate of each run
   and a profile of one request with the switch on (and each of
   ``convnext_block``'s three launches per request).
25. The ConvNeXt training path: ``tfimm_tpu_torch.train.run`` trains
   ConvNeXt-B at batch 64 in bf16 mixed precision with the ConvNeXt paper's
   ImageNet-1K recipe as far as ``train/`` takes it (AdamW at weight decay
   0.05, label smoothing 0.1, mixup 0.8, cutmix 1.0, drop path 0.5) for 6
   steps. No step may launch a kernel (the blocks run per op under
   autograd); every loss must be finite. The rate over steps 2-6 and a
   profile of one step with the device's idle share.

26. ``flash_attention`` against its plain version on the card at the
   slice's shape (64 images x 12 heads, N = 1025, d = 64), SAM-B's global
   shape (12 rows, N = 4096) and the edges (N = 1024, 1 and 63; d = 8, 128
   and 256), a row whose scores sit near 300, in bf16 and in f32 with TF32
   off: the output within 2e-2 and 1e-5 of the largest plain value, the lse
   within 1e-5. Control: the clamped no-max softmax of ``fused_mha`` must
   miss the bar by ``CONTROL_FACTOR`` on the large-score row. The packed
   route (q, k, v as strided views of one qkv) must equal contiguous
   copies. Kernel, plain, bound and library times with the operands out of
   L2: the library is ``F.scaled_dot_product_attention`` held to its flash
   backend, on (B, H, N, d); the kernel and the library also back to back.
27. ``flash_attention_bwd`` in the same way at the training shape (32
   images x 12 heads) and the same edges: dq, dk, dv within 2e-2 and 1e-4;
   control: the clamped softmax's masked backward; two calls bit-identical.
   The library is SDPA's flash backward alone.
28. ViT at 512x512 serving: ``create_model("vit_base_patch16_384",
   interpolate_input=True)`` in bf16 with seeded random weights answers 5
   requests of 64 uint8 512x512 images; the 24 x 24 position table is
   resized to 32 x 32 (N = 1025) at each call. Every request must launch
   ``flash_attention`` 12 times and nothing else; logits finite and
   non-zero, and on 4 images within 5e-2 of the same weights in f32
   through the plain attention (capturing the weights, which launches
   nothing). Then a profile of one request.
29. ViT at 512x512 training: ``train.run`` trains it with
   ``ModelConfig.input_size=(512, 512)`` at batch 32 in bf16 mixed
   precision with AdamW for 6 steps: 12 ``flash_attention`` and 12
   ``flash_attention_bwd`` launches a step and nothing else; finite
   losses, the last below the first; a seeded step on 4 images, bf16
   through the kernels against f32 through the plain attention (no
   launch): the loss within 2e-2, two gradients within 1e-1. The rate over
   steps 2-6 and a profile of one step with the device's idle share.
30. float16: ConvNeXt-B, Swin-T, CaiT-S24, PVTv2-B2 and PoolFormer-S12
   (their switches on) answer 8 uint8 images through ``predict`` in
   float16, and SAM-B encodes 8 images through ``set_image``, with no
   kernel launch (no kernel takes f16: each gate declines it); each within
   5e-2 of the largest value of the same weights in f32 on the card.

31. ``ln_dense`` (LayerNorm + Dense) and its backward against their plain
   versions on the card at ViT-B/16's widths: LN1 -> qkv (O = 2304) and
   LN2 -> fc1 (O = 3072) at training batch 64 (M = 12,608) and, forward
   only, serving batch 128 (M = 25,216), and at the edges (M = 197, C = 96
   with O = 40 and no bias, ViT-L's C = 1024, C = 100, C = 3072), in bf16
   and in f32 with TF32 off: the output and dx within 2e-2 and 1e-5,
   dgamma, dbeta, dW and db within 2e-2 and 1e-4 of the largest plain
   value; two backward calls bit-identical; each backward's body read from
   one profile of them all (the TMA + wgmma body where
   ``tma.ln_dense_bwd_route`` takes the call). Then, with the operands out
   of L2, kernel, plain, bound and library times at the training and
   serving shapes: the library is one eager ``F.layer_norm`` +
   ``F.linear`` (cuBLAS) on the same operands, for the backward that
   composition's autograd backward alone; beside it the port's own eager
   pair (``ops/norm.py · LayerNorm`` then ``Dense``); and, from one more
   profile, each launch of the backward and the library backward's device
   time, out of L2.
32. ``ln_dense_or_none`` at its place in ViT-B/16: a bf16 model with seeded
   weights runs a bs64 batch; on each of its 12 blocks' real inputs the op
   against the block's own ``norm1`` -> ``attn.qkv`` and ``norm2`` ->
   ``mlp.fc1``, forward within 2e-2 and, with a seeded cotangent, the five
   gradients within 5e-2 of the largest eager value (the eager composition
   rounds dz to bf16, the kernel keeps it in f32): 24 ``ln_dense`` and 24
   ``ln_dense_bwd`` launches and no others. With ``TFIMM_TPU_LN_DENSE=0``
   the op returns None. Then the 24 pairs' forward and backward timed
   through the kernels, the eager modules and ``F.layer_norm`` +
   ``F.linear``.

33. The models API on the card: ``save_model`` of a bf16 ViT-B/16 with
   seeded weights, then ``load_model(device="cuda")``: the logits of 8
   images equal the original's bit for bit. ``create_model(...,
   model_path=..., input_size=(512, 512))`` in bf16 carries the weights
   across through the position-embedding hook (14 x 14 -> 32 x 32, N =
   1025) and answers 5 requests of 64 uint8 512x512 images: 12
   ``flash_attention`` launches a request and nothing else, logits finite
   and non-zero, and on 4 images within 5e-2 of the same transfer in f32
   through the plain attention. An ``EmbeddingModel`` over ConvNeXt-B
   (bf16, seeded weights) gives finite (128, 128) embeddings in eval mode
   (36 ``convnext_mlp`` launches), and its rate over 5 requests of 128
   uint8 images; in training mode its BatchNorm moves the
   running statistics by the momentum rule, within 2e-2 of the update
   computed from the batch.

34. ``fused_mha`` against its plain version at PiT-B's stage 1 (128 images,
   N = 962, H = 4, d = 64) and PiT-S's (N = 730, H = 3, d = 48), in bf16
   and in f32 with TF32 off, within 2e-2 and 1e-5; the body each shape
   took (the profiler's kernel name); kernel, plain, bound and
   ``F.scaled_dot_product_attention`` times, back to back and out of L2,
   into ``fused_mha``'s ``shapes``.
35. ResNet serving: ``resnet50``, ``seresnext50_32x4d`` and
   ``ecaresnet50d`` in bf16 (``he_state_dict``'s seeded weights,
   BatchNorm statistics set norm by norm from 32 seeded images in f32)
   answer 5 requests of 128 uint8 224x224 images each through
   ``model.predict``, with no kernel launch; logits finite and non-zero,
   the first 16 images' within 5e-2 of the same weights in f32 on the
   card; the rate of each model and a profile of one request split into
   cuDNN convs, BatchNorm, cuBLAS GEMMs, swish and sigmoid, means, copies
   and the rest.
36. ResNet-50 training: ``train.run`` trains it at batch 64 in bf16 mixed
   precision with SGD (momentum 0.9, lr 0.025), L2 weight decay 1e-4,
   label smoothing 0.1 and an EMA at decay 0.9, 6 steps: no launch,
   finite losses; every BatchNorm's running mean moved and stayed finite;
   the EMA holds the running statistics and differs from them; a
   validation pass reads the EMA's (a hook on the stem's BatchNorm) and
   scores 1.0 on the EMA's own predictions; one seeded step, bf16 against
   f32: the loss within 2e-2, the head's weight and the last norm's bias
   gradients within 1e-1 (the convs' and norm scales' printed); the rate
   over steps 2-6 and a profile of one step.
37. VGG-16 and ConvMixer-768/32 serving as phase 35; ConvMixer's bf16
   request is held step by step (the stem, each of its 32 blocks and the
   head against f32 on the bf16 step's own input, ``stepwise``),
   its end-to-end difference printed.
38. PiT-B serving as phase 35: 13 ``fused_mha`` launches a request (3 + 6
   + 4 blocks) and no other kernel; the f32 reference through the plain
   attention (no launch).
39. EfficientNet serving as phase 35, each at its own input size:
   ``efficientnet_b0`` (224), ``efficientnet_b4`` (380),
   ``efficientnet_v2_s`` (300) and ``mobilenet_v2_100`` (224); the last
   norm of each residual branch seeded near 0.2 (``branch_ends``); no
   kernel launch. B0, B4 and MobileNetV2 are held step by step as
   ConvMixer (``STEPWISE``), V2-S end to end.
40. The Mixer family serving as phase 35 at 224x224: ``mixer_b16_224``,
   ``resmlp_big_24_224``, ``gmlp_s16_224`` and ``gmixer_24_224`` with
   ``seeded_state_dict``'s weights (std 0.02, norms and layer scales near
   1; no BatchNorm); no kernel launch.
41. BiT serving as phase 35 at 448x448: ``resnetv2_50x1_bitm`` at bs128
   and ``resnetv2_101x3_bitm`` at bs32 (``he_state_dict``'s weights;
   GroupNorm needs no calibration); no kernel launch; the logits within
   5e-2 of f32 end to end (on the CPU at 96-128 px both packages part by
   2% there: ``scripts/perf/torch_bf16_drift.py resnetv2``). The profile
   of a request also splits out GroupNorm's passes and the weight
   standardisation (``range_split``).
42. The hybrid ViTs serving as phase 38 at their input sizes:
   ``vit_base_r50_s16_384`` at bs64, ``vit_small_r26_s32_384`` at bs128
   and ``vit_tiny_r_s16_p8_224`` (the stem alone) at bs128, 12
   ``fused_mha`` launches a request, each on the bf16 TMA + wgmma body
   (the profile names it), the f32 reference through the plain attention
   (no launch), the split as phase 41. Then ``fused_mha`` at
   ViT-B/16-R50's (64, 577, 12, 64) as phase 34, into ``shapes``.
43. Training through ``train.run`` with phase 4's recipe for 6 steps:
   ``vit_base_r50_s16_384`` at 384x384 bs32 (12 + 12 launches a step),
   ``pit_b_224`` at bs64 (13 + 13) and ``pit_s_224`` at bs64 (12 + 12, d =
   48); finite losses; a seeded step on 8 images, bf16 through the kernels
   against f32 through the plain attention: the loss within 2e-2, the
   held gradients within 1e-1; the rate over steps 2-6 and a profile of a
   step. Then ``fused_mha_bwd`` at (32, 577, 12, 64), (64, 962, 4, 64)
   and (64, 730, 3, 48) against its plain version, its bodies, its device
   time out of L2 beside its bound and SDPA's backward's device time,
   both from profiles, into ``shapes``.
44. SAM-B's automatic mask generator in bf16 (``sam_state_dict``'s
   weights): ``SAMAutomaticMaskGenerator(model).generate`` with the default
   knobs (32x32 points in batches of 64, thresholds 0.88 / 0.95) on a
   seeded 768x1024 uint8 image, and with permissive ones (no thresholds,
   16x16 points, one crop layer: 5 crops, uncompressed RLE). Every crop's
   ``set_image`` must launch ``flash_attention_relpos`` 12 times and
   nothing else, every decode batch nothing; the default records pass
   their thresholds, the permissive ones keep the invariants of
   tests/models/test_amg.py (area, bbox, crop box, point) and include the
   full-image crop. The wall time of each ``generate``, a profile of one
   decode batch and of a whole ``generate`` (busy against wall). Then the
   same weights in f32 with TF32 off, 8x8 points on a 384x512 image, on the
   card and on the CPU (no launch there): the same records in the same
   order, bboxes within 1 px, scores within 1e-3, masks at IoU >= 0.99.
45. LoRA-ConvNeXt-B (rank 4, alpha 4) in bf16 with seeded weights (B at
   std 0.5, gammas near 1): 5 requests of 128 uint8 images through
   ``predict`` with ``TFIMM_TPU_FUSED_CONVNEXT`` pinned to 0 (36
   ``convnext_mlp`` launches a request, fed the merged weights) and to 1
   (36 ``convnext_block``); the logits within 2e-2 of
   ``convert_to_regular_model``'s through the same kernels and within 5e-2
   of the same LoRA weights in f32 on the card through the eager path (no
   launch); the base ConvNeXt-B without the update misses that bar by 10x.
   Then three AdamW steps of LoRA fine-tuning through ``lora_optimizer``
   (f32 parameters, a bs64 batch in bf16): finite losses, no launch, every
   frozen tensor unchanged, every trainable one (the factors, the head)
   moved; the step times.
46. int8 quantization (``quantize_int8``). (a) ``int8_dense_matmul`` at
   ViT-B/16 bs128's qkv (M = 25,216, 768 -> 2,304) and fc2 (3,072 ->
   768) and at an odd shape (M = 5, K = 100, N = 36: the zero padding to
   ``torch._int_mm``'s shapes), and ``int8_conv`` at ResNet-50's stage-3
   3x3 (bs128, 14x14, 256 -> 256, pad 1) and its strided stage-2 entry
   (56x56, 128 -> 128, stride 2), on the card and on the CPU from the
   same seeded inputs, in f32 and bf16 activations: the int32 products
   and the outputs equal bit for bit. Each bf16 product's parts
   (quantise, ``_int_mm``, rescale; the conv's im2col) timed with CUDA
   events beside ``F.linear`` and cuDNN's conv in bf16 at the same shape,
   and the profile's kernels. (b) ViT-B/16 quantized at the defaults (48
   int8 layers) answers 5 bf16 bs128 requests through ``predict``: 12
   ``fused_mha`` launches and 48 int8 products a request, nothing else;
   img/s beside the float model's in the same process; finite logits; each
   block of the int8 model in bf16 within 5e-2 of the same block of the
   same int8 model in f32 fed the bf16 block's input, and the logits'
   distance end to end and from the float model printed. (c) ResNet-50
   with calibrated BatchNorm, quantized with ``convs=True`` (its 13 3x3
   convs of stages 2-4), 5 bf16 bs128 requests: 13 int8 convs a request,
   no launch, finite logits, img/s beside the float model. (d) ConvNeXt-B
   and Swin-T at the defaults, 2 bf16 bs128 requests each: ConvNeXt-B's 3
   float blocks of stage 1 launch ``convnext_mlp`` (or ``convnext_block``
   with ``TFIMM_TPU_FUSED_CONVNEXT=1``) and its 33 int8 blocks decline;
   Swin-T's 4 float blocks of stages 1-2 launch ``swin_block`` and its int8
   stages 3-4 neither it nor ``window_mha``; finite logits. (e) SAM-B with
   its image encoder quantized: one 1024x1024 ``set_image`` with 12
   ``flash_attention_relpos`` launches, three prompt calls with none, the
   latencies beside the float model's.
47. Checkpoints, the deployment artifact, distillation and the embedding
   factory, through ``run()``. (a) ViT-B/16 at bs64, bf16 mixed precision,
   AdamW at lr 1e-4, 3 steps an epoch on 192 fixed synthetic images, with
   ``ckpt_dir`` in a temporary directory, ``ckpt_every_it=2`` and
   ``ckpt_to_keep=2``: run A trains one epoch, run B resumes from A's
   directory for two, run C trains both in a directory of its own. B's
   restore must give A's epoch, optimizer step count and Adam moments bit
   for bit; B must end bit for bit where C ends (``fused_mha_bwd`` is
   first checked to repeat bit for bit on the card; the largest
   difference is printed); both directories must keep the steps orbax's
   rules keep (steps 2, 4 and 6; step 6 holding epoch 1, its epoch-end
   save skipped), and ``<ckpt_dir>/model`` must hold the parameters and
   ``model.pt2``; every step must launch ``fused_mha`` and its backward 12
   times each and nothing else. The checkpoint's size and the seconds a
   save and a restore take. (b) C's ``model/`` loaded on the card equals
   C's parameters bit for bit; ``export_model`` (f32, symbolic batch,
   log-softmax) and ``load_exported`` then answer 5 requests of 128 uint8
   images and one of 7: 12 ``fused_mha`` launches a call and nothing else,
   log-probabilities within 1e-4 of the eager f32 model's on the same
   images; the exported program's img/s beside ``model.predict``'s in
   f32, and the host time of one no-grad ``fused_mha`` call through the
   custom op beside one of its wrapper called directly (bf16, bs128).
   (c) ``DistillationProblem`` through ``run()``: C's ``model/`` as a
   ``SavedModel`` teacher, a ``vit_base_patch32_224`` student without a
   head, bs128, bf16 mixed precision, Adam at lr 1e-4, 6 steps on one
   fixed batch: 24 ``fused_mha`` launches a step (12 at N = 197, 12 at
   N = 50) and 12 ``fused_mha_bwd``, finite losses, the last below the
   first; with seeded weights one ``train_step`` through the bf16 kernels
   within 2e-2 (loss) and 1e-1 (two gradients) of the same step in f32
   through the plain attention; img/s over steps 2-6 and the device's idle
   share. (d) ``EmbeddingModelFactory`` (ViT-B/16, ``embed_dim=512``)
   builds on the card; a bs128 bf16 eval forward launches 12 ``fused_mha``
   and nothing else and is within 5e-2 of the same weights in f32 through
   the plain attention.

Phase 6 pins ``TFIMM_TPU_FUSED_CONVNEXT`` to 0 for its run, so that its
launch counts hold whatever the environment says.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py --phases 17,18

runs phase 1 and the phases named (2-47) alone, for a quicker look at one
path, and lists only the kernels those phases measured in full.
"""

from __future__ import annotations

import contextlib
import functools
import io
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
MODEL = "vit_base_patch16_224"
BATCH = 128
REQUESTS = 5
TOL = {"bfloat16": 2e-2, "float32": 1e-5}
# The backward's bar is relative to the largest plain value: in bf16 the
# kernel rounds p and ds to bf16 before their products; in f32 it sums in
# another order.
BWD_TOL = {"bfloat16": 2e-2, "float32": 1e-4}
# (B, N, H, d): ViT-B/16's attention, odd H (vit_tiny), a small d, d = 80
# (vit_huge) with N below one tile.
EDGE_SHAPES = [(2, 197, 3, 64), (2, 50, 4, 32), (2, 17, 16, 80)]
MHA_SHAPES = [(128, 197, 12, 64), *EDGE_SHAPES]
TRAIN_BATCH = 64
TRAIN_STEPS = 6
BWD_SHAPES = [(TRAIN_BATCH, 197, 12, 64), *EDGE_SHAPES]
CLAMP_SHAPE = (2, 197, 12, 64)
CONVNEXT = "convnext_base"
# (M, C, H) of ConvNeXt-B's four stages at batch 128 and 224x224, and the
# number of blocks of each that a request runs.
CONVNEXT_STAGES = [(401408, 128, 512), (100352, 256, 1024),
                   (25088, 512, 2048), (6272, 1024, 4096)]
CONVNEXT_DEPTHS = (3, 3, 27, 3)
# ConvNeXt-T's C = 96, C = 12 (no multiple of 8), M = 98 = 2 * 7 * 7.
CONVNEXT_EDGES = [(6272, 96, 384), (200, 12, 48), (98, 512, 2048),
                  (98, 1024, 4096)]
CONVNEXT_TOL = {"bfloat16": 2e-2, "float32": 1e-5}
CONVNEXT_CHECK_IMAGES = 16
# The launches inside one counted call of convnext_mlp and convnext_block,
# by the profiler's kernel names (the TMA + wgmma GEMMs of mlp_gemm.cuh, or
# the mma.sync body's off that route).
CONVNEXT_LAUNCH_PARTS = {
    "convnext_mlp": [
        ("row statistics", ("row_stats",)),
        ("fc1 (LN prologue, tanh GELU)", ("mlp_gemm_fc1",
                                          "mlp_gemm_bf16_kernel<true>")),
        ("fc2 (residual)", ("mlp_gemm_fc2", "mlp_gemm_bf16_kernel<false>"))],
    "convnext_block": [
        ("depthwise + LayerNorm", ("dw_ln",)),
        ("fc1 (tanh GELU)", ("convnext_block_fc1",
                             "convnext_block_gemm_bf16_kernel<true>")),
        ("fc2 (residual)", ("convnext_block_fc2",
                            "convnext_block_gemm_bf16_kernel<false>"))]}
# The seven launches of one swin_block call (six where proj's epilogue takes
# X2's row statistics: SWIN_X2_STATS is then not launched) and the five of
# one poolformer_block call (bf16: the GEMMs on mlp_gemm.cuh's wgmma body).
SWIN_X2_STATS = "row statistics of X2"
CONVNEXT_LAUNCH_PARTS["swin_block"] = [
    ("row statistics of x", ("swin_row_stats_kernel<__nv_bfloat16>",)),
    ("qkv (LN1 prologue)", ("swin_qkv_",)),
    ("attention (window_mha)", ("window_mha_wgmma_kernel",
                                "window_mha_bf16_kernel")),
    ("proj (X2 in f32)", ("swin_proj_",)),
    (SWIN_X2_STATS, ("swin_row_stats_kernel<float>",)),
    ("fc1 (LN2 prologue on f32 X2, GELU)", ("swin_fc1_",)),
    ("fc2 (f32 residual)", ("swin_fc2_",))]
CONVNEXT_LAUNCH_PARTS["poolformer_block"] = [
    ("GN1 statistics", ("gn_stats_kernel<__nv_bfloat16>",)),
    ("pool (x1 in f32)", ("pool_x1_kernel",)),
    ("GN2 statistics", ("gn_stats_kernel<float>",)),
    ("fc1 (GN2 prologue on f32 x1, GELU)", ("pf_fc1_",)),
    ("fc2 (f32 residual)", ("pf_fc2_",))]
# The GEMMs of those blocks, by their kernels' name prefix (gemm_bodies).
GEMM_PRODUCTS = {"swin_block": ("swin_qkv", "swin_proj", "swin_fc1",
                                "swin_fc2"),
                 "poolformer_block": ("pf_fc1", "pf_fc2")}
# The launches inside one counted call of talking_head_attention_bwd: the
# Hopper body's (A) rows and (B) dq, dk, dv; the first design's rows and
# keys; the fixed-order sum of the mix-gradient partials.
CAIT_BWD_PARTS = [
    ("rows (l, delta, a, draw, dw_l and dw_w partials)",
     ("talking_head_bwd_rows", "rows_kernel")),
    ("dq, dk, dv", ("talking_head_bwd_dqkv", "keys_kernel")),
    ("mix-gradient sums", ("mix_sum_kernel",))]
CONVNEXT_LAUNCH_PARTS["talking_head_attention_bwd"] = CAIT_BWD_PARTS
# cuDNN's convolution kernels, by the profiler's names.
CUDNN_CONV_KEYS = ("depthwise", "fprop", "conv2d", "convolution")
SWIN = "swin_tiny_patch4_window7_224"
# (BW, N, C, H, map side) of Swin-T's stages 1-3 at batch 128, each run by
# one unshifted and one shifted block of a pair, and the blocks of each
# that a request runs; then the stage-4 attention, unshifted (its 7x7 map is
# one window).
SWIN_STAGES = [(8192, 49, 96, 3, 56), (2048, 49, 192, 6, 28),
               (512, 49, 384, 12, 14)]
SWIN_DEPTHS = (2, 2, 6)
SWIN_STAGE4 = (128, 49, 768, 24, 7)
# Window 12 (N = 144), d = 16, d = 64, d = 8 with window 4 (the hf_swin
# fixture), an odd window count.
SWIN_EDGES = [(32, 144, 128, 4, 24), (64, 49, 64, 4, 14), (64, 49, 256, 4, 0),
              (64, 16, 16, 2, 8), (3, 49, 96, 3, 0)]
SWIN_TOL = {"window_mha": {"bfloat16": 2e-2, "float32": 1e-5},
            "swin_block": {"bfloat16": 2e-2, "float32": 1e-4}}
# Launches of one Swin-T request: the 10 blocks of stages 1-3 through
# swin_block, the 2 attentions of stage 4 through window_mha.
SWIN_LAUNCHES = {"swin_block": 10, "window_mha": 2}
# (BW, N, C, H, map side) of Swin-T's four stages in training at batch 64,
# and the blocks of each that a step runs (half of those of stages 1-3
# shifted); the stage-4 map is one window, so its blocks are unshifted.
SWIN_TRAIN_BATCH = 64
SWIN_TRAIN_STAGES = [(4096, 49, 96, 3, 56), (1024, 49, 192, 6, 28),
                     (256, 49, 384, 12, 14), (64, 49, 768, 24, 7)]
SWIN_TRAIN_DEPTHS = (2, 2, 6, 2)
# The backward's bar: in bf16 the kernel rounds p and ds to bf16 before
# their products; in f32 it sums in another order, dbias over every window.
WINDOW_BWD_TOL = {"bfloat16": 2e-2, "float32": 1e-4}
# Launches of one Swin-T training step: every block per op.
SWIN_TRAIN_LAUNCHES = {"window_mha": 12, "window_mha_bwd": 12}
SWIN_CHECK_IMAGES = 8
CAIT = "cait_s24_224"
# (B, N, H, d) of cait_s24_224's talking-head attention at batch 128, then
# the edges: cait_xxs (H = 4), cait_xs24_384 (H = 6, N = 576),
# cait_m48_448 (H = 16, N = 784, batch 2), the golden fixture's H = 2, d = 8,
# and more than 8 heads above d = 64 (H = 10, d = 72).
CAIT_SHAPES = [(128, 196, 8, 48), (16, 196, 4, 48), (4, 576, 6, 48),
               (2, 784, 16, 48), (16, 16, 2, 8), (2, 50, 10, 72)]
CAIT_TRAIN_BATCH = 64
CAIT_BWD_SHAPES = [(CAIT_TRAIN_BATCH, 196, 8, 48), *CAIT_SHAPES[1:]]
# The forward's bar: the kernel rounds the mixed probabilities once, as its
# plain version does; the backward's: f32 throughout, summed in another
# order (the mix gradients over every entry of the batch).
CAIT_TOL = {"bfloat16": 2e-2, "float32": 1e-5}
CAIT_BWD_TOL = {"bfloat16": 2e-2, "float32": 1e-4}
CAIT_LAUNCHES = {"talking_head_attention": 24}
CAIT_TRAIN_LAUNCHES = {"talking_head_attention": 24,
                       "talking_head_attention_bwd": 24}
CAIT_CHECK_IMAGES = 16
# A control must miss its bar by at least this factor.
SAM = "sam_vit_b"
# flash_attention_relpos (B, gh, gw, d): SAM-B's global blocks (12 heads of
# one 1024 x 1024 image) and windowed blocks (25 windows x 12 heads of one
# image), then the edges: SAM-H's head dim (16 heads of d = 80), gh != gw,
# N = 49, and one row whose scores pass 80 (no clamp may apply).
RELPOS_SHAPES = [(12, 64, 64, 64), (300, 14, 14, 64)]
RELPOS_EDGES = [(16, 14, 14, 80), (2, 48, 64, 64), (4, 7, 7, 64)]
RELPOS_BIG = (2, 14, 14, 64)
RELPOS_TOL = {"bfloat16": 2e-2, "float32": 1e-5}
# SAMPredictor requests: uint8 images (H, W), each set_image then 3 prompt
# calls; every set_image launches the kernel once per encoder block.
SAM_IMAGES = [(1200, 1800), (1024, 1024), (500, 700)]
SAM_LAUNCHES = {"flash_attention_relpos": 12}
SAM_BATCH = 8
SAM_TOL = 5e-2
# flash_attention_relpos_bwd: dq, dk, dv, drh, drw against the plain
# backward (bf16 rounds p and ds before their products; f32 sums in another
# order).
RELPOS_BWD_TOL = {"bfloat16": 2e-2, "float32": 1e-4}
# SAM fine-tuning: the encoder step at bs1 as the JAX package measures it
# (scripts/perf/sam_encoder_sweep.py), the eval-mode gradient pass, and the
# whole model (2 images, one box each) for 6 AdamW steps. bf16 compute with
# f32 parameters and AdamW state, as train.run's mixed precision.
SAM_TRAIN_STEPS = 6
SAM_TRAIN_LR = 1e-4
SAM_TRAIN_WEIGHT_DECAY = 0.1
SAM_TRAIN_LAUNCHES = {"flash_attention_relpos": 4,
                      "flash_attention_relpos_bwd": 4}
SAM_EVAL_LAUNCHES = {"flash_attention_relpos": 12,
                     "flash_attention_relpos_bwd": 12}
SAM_GRAD_PARAMS = ("image_encoder.blocks.2.attn.rel_pos_h",
                   "image_encoder.blocks.0.attn.qkv.weight")
SAM_FINETUNE_IMAGES = 2
# pvt_sra (B, N, S, C): pvt_v2_b2's stage 1 at batch 128 (pvt_small's and
# pvt_v2_b2_linear's too), pvt_v2_b0's C = 32, S = 256, a ragged N, C = 512,
# one 64-row tile an image over three tiles a block.
SRA_SHAPES = [(128, 3136, 49, 64), (128, 3136, 49, 32), (16, 3136, 256, 64),
              (4, 3001, 49, 64), (2, 64, 49, 512), (300, 49, 49, 64)]
SRA_TOL = {"bfloat16": 2e-2, "float32": 1e-5}
# PVT serving: (model, the SRA switch, pvt_sra launches a request).
PVT_RUNS = [("pvt_v2_b2", "1", 3), ("pvt_v2_b2", "0", 0), ("pvt_small", "1", 3),
            ("pvt_v2_b2_linear", "1", 3)]
# poolformer_block (B, H, W, C, hidden): poolformer_s12's four stages at
# batch 128, and the blocks of each that a request runs; then a 4x4 map,
# where edges and corners are all but one pixel in four, and two widths off
# the wgmma route (C = 60 and 6: the mma.sync GEMMs and one channel a pool
# thread).
POOL_STAGES = [(128, 56, 56, 64, 256), (128, 28, 28, 128, 512),
               (128, 14, 14, 320, 1280), (128, 7, 7, 512, 2048)]
POOL_DEPTHS = (2, 2, 6, 2)
POOL_EDGES = [(128, 4, 4, 64, 256), (16, 7, 7, 60, 240), (4, 5, 3, 6, 24)]
# f32: two whole-map GroupNorms and two products summed in another order.
POOL_TOL = {"bfloat16": 2e-2, "float32": 1e-4}
POOLFORMER = "poolformer_s12"
POOLFORMER_RUNS = [("1", 12), ("0", 0)]
FAMILY_CHECK_IMAGES = 16
# convnext_block (B, H, W, C, hidden): ConvNeXt-B's four stages at batch
# 128 (CONVNEXT_DEPTHS blocks of each a request); against the plain version
# at batch CONVNEXT_BLOCK_CHECK_BATCH, then the edges: ConvNeXt-T's C = 96,
# a ragged 9 x 13 map, convnext_xlarge's widest stage (C = 2048, hidden
# 8192) at a small M.
CONVNEXT_BLOCK_STAGES = [(128, 56, 56, 128, 512), (128, 28, 28, 256, 1024),
                         (128, 14, 14, 512, 2048), (128, 7, 7, 1024, 4096)]
CONVNEXT_BLOCK_CHECK_BATCH = 16
CONVNEXT_BLOCK_EDGES = [(16, 56, 56, 96, 384), (8, 9, 13, 128, 512),
                        (2, 7, 7, 2048, 8192)]
# f32: 49 taps, a LayerNorm and two products, each summed in another order.
CONVNEXT_BLOCK_TOL = {"bfloat16": 2e-2, "float32": 1e-4}
# ConvNeXt-B serving: (switch, launches a request) with
# TFIMM_TPU_FUSED_CONVNEXT on (every block whole) and off (convnext_mlp).
CONVNEXT_FUSED_RUNS = [("1", {"convnext_block": 36}),
                       ("0", {"convnext_mlp": 36})]
CONVNEXT_TRAIN_BATCH = 64
# ViT-B/16 at 512x512 (N = 1025): the 384 variant's 24 x 24 position table
# resized at each call (serving), or built at 32 x 32 (training).
VIT512 = "vit_base_patch16_384"
VIT512_SIZE = (512, 512)
VIT512_BATCH = 64
VIT512_TRAIN_BATCH = 32
VIT512_CHECK_IMAGES = 4
VIT512_LAUNCHES = {"flash_attention": 12}
VIT512_TRAIN_LAUNCHES = {"flash_attention": 12, "flash_attention_bwd": 12}
# flash_attention (B, H, N, d): the slice's serving and training shapes and
# SAM-B's global shape, then the edges: N = 1024, one token, a ragged 63,
# d = 8, 128 and 256; and a row whose scores sit near 300.
FLASH_SHAPE = (VIT512_BATCH, 12, 1025, 64)
FLASH_TRAIN_SHAPE = (VIT512_TRAIN_BATCH, 12, 1025, 64)
FLASH_SAM_SHAPE = (1, 12, 4096, 64)
FLASH_EDGES = [(2, 3, 1024, 64), (3, 2, 1, 64), (2, 2, 63, 64),
               (4, 2, 300, 8), (1, 2, 300, 128), (1, 2, 200, 256)]
FLASH_BIG = (2, 3, 197, 64)
FLASH_TOL = {"bfloat16": 2e-2, "float32": 1e-5}
FLASH_BWD_TOL = {"bfloat16": 2e-2, "float32": 1e-4}
FLASH_LSE_TOL = 1e-5
# At N = 1 the true dq and dk are 0: both versions' rounding noise, held
# against max|dv|.
FLASH_ZERO_GRAD_TOL = 1e-4
# float16 (phase 30): a model of each family with a kernel, run with every
# opt-in kernel switched on.
F16_MODELS = [CONVNEXT, SWIN, CAIT, "pvt_v2_b2", POOLFORMER]
F16_SWITCHES = ("TFIMM_TPU_FUSED_CONVNEXT", "TFIMM_TPU_FUSED_PVT_SRA",
                "TFIMM_TPU_FUSED_POOLFORMER")
F16_IMAGES = 8
# ln_dense (phases 31-32): (M, C, O) at ViT-B/16's widths, LN1 -> qkv and
# LN2 -> fc1, at training batch 64 (forward and backward) and serving batch
# 128 (forward); the edges as (M, C, O, bias).
LN_DENSE_TRAIN = [(64 * 197, 768, 2304), (64 * 197, 768, 3072)]
LN_DENSE_SERVE = [(128 * 197, 768, 2304), (128 * 197, 768, 3072)]
LN_DENSE_EDGES = [(197, 768, 2304, True), (197, 96, 40, False),
                  (394, 1024, 3072, True), (130, 100, 36, True),
                  (40, 3072, 64, True)]
LN_DENSE_TOL = {"bfloat16": 2e-2, "float32": 1e-5}
LN_DENSE_SUM_TOL = {"bfloat16": 2e-2, "float32": 1e-4}
LN_DENSE_EPS = 1e-6
LN_DENSE_BATCH = 64
LN_DENSE_VIT_TOL = {"forward": 2e-2, "backward": 5e-2}
LN_DENSE_VIT_LAUNCHES = {"ln_dense": 24, "ln_dense_bwd": 24}
# The models API (phase 33): a bf16 ViT-B/16 saved and loaded; the same
# weights carried to 512x512 and served as phase 28; an EmbeddingModel over
# ConvNeXt-B.
API_IMAGES = 8
EMBED_DIM = 128
EMBED_LAUNCHES = {"convnext_mlp": 36}
# PiT's attention (phase 34): fused_mha at the first stages of PiT-B
# (31 x 31 tokens and a class token, 4 heads of 64) and PiT-S (27 x 27, 3
# heads of 48) at bs128.
PIT_MHA_SHAPES = {"pit_b_stage1": (128, 962, 4, 64),
                  "pit_s_stage1": (128, 730, 3, 48)}
# The conv nets (phases 35-38): ResNet-50, SE-ResNeXt-50 and ECA-ResNet-50d
# serving; ResNet-50 training with its EMA; VGG-16 and ConvMixer-768/32
# serving (no kernel on these paths); PiT-B serving (fused_mha in each of
# its 3 + 6 + 4 blocks).
RESNETS = ("resnet50", "seresnext50_32x4d", "ecaresnet50d")
RESNET = "resnet50"
RESNET_TRAIN_BATCH = 64
RESNET_EMA_DECAY = 0.9
VGG = "vgg16"
CONVMIXER = "convmixer_768_32"
PIT = "pit_b_224"
PIT_LAUNCHES = {"fused_mha": 13}
# The EfficientNet family (phase 39), each at its own input size:
# EfficientNet-B0 at 224 (TF SAME, batch_norm_tf, MBConv with SE and
# swish), B4 at 380 (32 blocks), V2-S at 300 (ConvBnAct, EdgeResidual) and
# MobileNetV2 at 224 (symmetric padding, ReLU6); the Mixer family (phase
# 40) at 224: MLP-Mixer-B/16, ResMLP-B24/8 (784 tokens), gMLP-S/16 and
# gMixer-24. No kernel on these paths.
EFFICIENTNETS = ("efficientnet_b0", "efficientnet_b4", "efficientnet_v2_s",
                 "mobilenet_v2_100")
MIXERS = ("mixer_b16_224", "resmlp_big_24_224", "gmlp_s16_224",
          "gmixer_24_224")
# Held step by step (``stepwise``), their end-to-end bf16 drift printed: on
# the CPU at 96-128 px B0, B4 and MobileNetV2 part from f32 by 3.3-5.8% end
# to end, as in the JAX package (3.3-6.0%), V2-S by 2.8%
# (``scripts/perf/torch_bf16_drift.py efficientnet``).
STEPWISE = (CONVMIXER, "efficientnet_b0", "efficientnet_b4",
            "mobilenet_v2_100")
# BiT (phase 41): BiT-M R50x1 and R101x3 (6,144 channels at the last
# stage) at their 448x448, each at its batch; no kernel on this path.
BITS = {"resnetv2_50x1_bitm": 128, "resnetv2_101x3_bitm": 32}
# The hybrid ViTs (phase 42) at their input sizes and batches: ViT-B/16-R50
# at 384 (N = 577), R26-S/32 at 384 (N = 145) and Ti/16 on the stem alone
# at 224 (N = 50); 12 fused_mha a request. Then fused_mha at ViT-B/16-R50's
# shape, timed as phase 34 times PiT's.
HYBRIDS = {"vit_base_r50_s16_384": 64, "vit_small_r26_s32_384": 128,
           "vit_tiny_r_s16_p8_224": 128}
HYBRID_LAUNCHES = {"fused_mha": 12}
HYBRID_MHA_SHAPES = {"vit_base_r50_s16_384": (64, 577, 12, 64)}
# The body every bf16 fused_mha of these paths must take (d <= 64).
MHA_BF16_BODY = "fused_mha_fwd_bf16_kernel<1>"
# Training through run() (phase 43): (model, batch, launches a step, the
# gradients held within 1e-1 of f32, those printed). The hybrid's stem conv
# feeds a GroupNorm, which makes its cotangent orthogonal to its output, as
# a BatchNorm does to ResNet-50's convs (phase 36): printed, not held.
MHA_TRAIN_RUNS = [
    ("vit_base_r50_s16_384", 32, {"fused_mha": 12, "fused_mha_bwd": 12},
     ("blocks.0.attn.qkv.weight", "head.weight"),
     ("patch_embed.backbone.stem.conv.weight",)),
    ("pit_b_224", 64, {"fused_mha": 13, "fused_mha_bwd": 13},
     ("transformers.0.blocks.0.attn.qkv.weight", "patch_embed.conv.weight",
      "head.weight"), ()),
    ("pit_s_224", 64, {"fused_mha": 12, "fused_mha_bwd": 12},
     ("transformers.0.blocks.0.attn.qkv.weight", "patch_embed.conv.weight",
      "head.weight"), ())]
TRAIN_CHECK_IMAGES = 8
# fused_mha_bwd at the training shapes of phase 43: ViT-B/16-R50's blocks
# at bs32, PiT-B's and PiT-S's first stages at bs64.
MHA_BWD_SHAPES = {"vit_base_r50_s16_384": (32, 577, 12, 64),
                  "pit_b_stage1": (64, 962, 4, 64),
                  "pit_s_stage1": (64, 730, 3, 48)}
# SAM-B's automatic mask generator (phase 44): the default knobs on a
# 768x1024 image, the permissive ones (every mask kept but the crop-edge
# ones, 16x16 points, one crop layer: 5 crops), and the f32 card-vs-CPU
# check at 8x8 points on a 384x512 image.
AMG_IMAGE = (768, 1024)
AMG_PERMISSIVE = dict(pred_iou_thresh=0.0, stability_score_thresh=0.0,
                      points_per_side=16, crop_n_layers=1,
                      output_mode="uncompressed_rle")
AMG_CHECK_IMAGE = (384, 512)
AMG_CHECK = dict(pred_iou_thresh=0.0, stability_score_thresh=0.0,
                 points_per_side=8, crop_n_layers=0)
AMG_CHECK_TOL = {"bbox_px": 1.0, "score": 1e-3, "mask_iou": 0.99}
# LoRA-ConvNeXt-B (phase 45): rank 4, alpha 4; B drawn at this std, so
# that the update (about W's own size) moves the logits far past the bar.
LORA_RANK = 4
LORA_ALPHA = 4.0
LORA_B_STD = 0.5
LORA_RUNS = [("0", {"convnext_mlp": 36}, "serve_lora_convnext"),
             ("1", {"convnext_block": 36}, "serve_lora_convnext_fused")]
LORA_MERGED_TOL = 2e-2
LORA_F32_TOL = 5e-2
LORA_CONTROL_FACTOR = 10.0
LORA_TRAIN_BATCH = 64
LORA_TRAIN_STEPS = 3
# int8 quantization (phase 46): int8_dense_matmul at ViT-B/16 bs128's qkv
# and fc2 and an odd shape, (M, K, N); int8_conv at ResNet-50's stage-3 3x3
# and its strided stage-2 entry at bs128, (B, H, W, C, O, stride, pad).
INT8_DENSE_SHAPES = [(128 * 197, 768, 2304), (128 * 197, 3072, 768),
                     (5, 100, 36)]
INT8_CONV_SHAPES = [(128, 14, 14, 256, 256, 1, 1),
                    (128, 56, 56, 128, 128, 2, 1)]
INT8_VIT_LAUNCHES = {"fused_mha": 12}
INT8_VIT_LAYERS = 48
INT8_RESNET_CONVS = 13
INT8_TOL = 5e-2
# (model, TFIMM_TPU_FUSED_CONVNEXT, launches of an int8 request and of a
# float one, path) at the default thresholds: the float blocks keep their
# kernels (ConvNeXt-B's stage 1, Swin-T's stages 1-2).
INT8_GATE_RUNS = [
    (CONVNEXT, "0", {"convnext_mlp": 3}, {"convnext_mlp": 36},
     "serve_convnext_int8"),
    (CONVNEXT, "1", {"convnext_block": 3}, {"convnext_block": 36},
     "serve_convnext_fused_int8"),
    (SWIN, "0", {"swin_block": 4}, {"swin_block": 10, "window_mha": 2},
     "serve_swin_int8")]
INT8_GATE_REQUESTS = 2
INT8_SAM_LAYERS = 48
# Checkpoints and distillation (phase 47): steps an epoch of runs A-C, the
# saving cadence and how many of the newest steps orbax keeps; the
# exported program's batches; the distillation student and its run; the
# embedding factory's width.
CKPT_STEPS = 3
CKPT_EVERY = 2
CKPT_KEEP = 2
EXPORT_BATCHES = (BATCH, 7)
EXPORT_TOL = 1e-4
DISTILL_STUDENT = "vit_base_patch32_224"
DISTILL_BATCH = 128
DISTILL_STEPS = 6
DISTILL_LAUNCHES = {"fused_mha": 24, "fused_mha_bwd": 12}
EMBED_FACTORY_DIM = 512
# cuDNN's conv kernels and layout transposes, by name.
CONV_NET_CONV_KEYS = ("fprop", "dgrad", "wgrad", "implicit", "conv", "cudnn",
                      "winograd", "nchwtonhwc", "nhwctonchw")
# The 50 MB L2 is evicted before each cold-timed call by a write this large.
L2_FLUSH_BYTES = 512 * 2 ** 20
# Tiny launches that open and close each short profile (profile_pad).
PROFILE_PAD = 256
# profile_cases' range that names the flush's kernel.
FLUSH_RANGE = "chip_smoke flush"
CONTROL_FACTOR = 5.0
# H100 SXM peaks (NVIDIA's data sheet, dense): bf16 tensor cores and HBM3.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_S = 3.35e12
# f32 outside the tensor cores (the depthwise taps).
PEAK_F32_FLOPS = 67e12
# Device-time groups of a training step or a request, by kernel name (first
# match).
KERNEL_GROUPS = [("convnext_block (convnext_block.cu: depthwise + LayerNorm, "
                  "GEMMs)", ("convnext_block",)),
                 ("pvt_sra (pvt_sra.cu)", ("pvt_sra",)),
                 ("poolformer_block (poolformer_block.cu: GroupNorm "
                  "statistics, pool, GEMMs)", ("gn_stats", "pool_x1",
                                               "pf_fc1_", "pf_fc2_")),
                 # The Hopper backward (attention_bwd.cuh) is one template
                 # for both: <DC, 0> without the bias, <DC, 1 or 2> with it.
                 ("flash attention backward (flash_attention_bwd.cu)",
                  ("flash_bwd", "attn_bwd_rows_kernel<1, 0>",
                   "attn_bwd_keys_kernel<1, 0>", "attn_bwd_rows_kernel<2, 0>",
                   "attn_bwd_keys_kernel<2, 0>")),
                 ("flash attention (flash_attention.cu)", ("flash_fwd",)),
                 ("rel-pos flash attention backward "
                  "(flash_attention_relpos_bwd.cu)", ("relpos_bwd",
                                                      "attn_bwd::")),
                 ("rel-pos flash attention (flash_attention_relpos.cu)",
                  ("relpos_fwd",)),
                 ("talking-head attention backward (cait_attention_bwd.cu)",
                  ("talking_head_bwd", "rows_kernel", "keys_kernel",
                   "mix_sum_kernel")),
                 ("talking-head attention (cait_attention.cu)",
                  ("talking_head_fwd",)),
                 ("swin_block (GEMMs, row statistics)",
                  ("swin_qkv_", "swin_proj_", "swin_fc1_", "swin_fc2_",
                   "swin_row_stats")),
                 ("window attention backward (window_mha_bwd.cu)",
                  ("window_mha_bwd", "dbias_sum")),
                 ("window attention (window_mha.cu; within swin_block at "
                  "stages 1-3)", ("window_mha",)),
                 ("convnext_mlp", ("mlp_gemm", "row_stats")),
                 ("fused_mha_bwd", ("fused_mha_bwd",)),
                 ("fused_mha fwd", ("fused_mha_fwd",)),
                 ("depthwise conv (cuDNN)", CUDNN_CONV_KEYS),
                 ("GEMMs (cuBLAS)", ("gemm", "cutlass", "xmma", "nvjet", "splitk")),
                 ("optimizer (foreach)", ("multi_tensor_apply",)),
                 ("memcpy/memset", ("memcpy", "memset"))]
OTHER_KERNELS = "elementwise, LayerNorm, reductions"


@contextlib.contextmanager
def restored_env(var: str):
    """On leaving, set the environment variable ``var`` back to what it was
    on entry (unset if it was unset)."""
    saved = os.environ.get(var)
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop(var, None)
        else:
            os.environ[var] = saved


class SmokeFailure(Exception):
    pass


def print_registers(build_log: str) -> None:
    """Registers and spills, from ptxas' report in the build log, of the
    backward's Hopper launches (``csrc/attention_bwd.cuh``: (A) rows and
    (B) keys, per 64-column chunks DC and bias), of the GEMM body of
    ``csrc/mlp_gemm.cuh`` on TMA and wgmma (per caller, swin_block's and
    poolformer_block's products among them, and tile width), the
    tiled depthwise + LayerNorm launch of ``convnext_block.cu`` and the
    talking-head kernels' Hopper launches (``cait_attention.cu`` and
    ``cait_attention_bwd.cu``, per padded head count), the window
    attention's (``window_mha.cu``, ``window_mha_bwd.cu``), ``pvt_sra.cu``'s
    and ``ln_dense.cu``'s backward (its two GEMMs per tile width, its dx
    pass per column chunks); nothing when the library was built by an
    earlier process."""
    import re

    lines = build_log.splitlines()
    seen = set()
    biases = {"0": "none", "1": "gw = 64", "2": "general"}
    for i, line in enumerate(lines[:-2]):
        found = re.search(r"Function properties for "
                          r"\S*attn_bwd_(rows|keys)_kernelILi(\d)ELi(\d)E",
                          line)
        tiled = re.search(r"Function properties for \S*?((?:mlp_gemm_fc[12]|"
                          r"convnext_block_fc[12]|ln_dense_fwd|"
                          r"swin_(?:qkv|proj|fc1|fc2)|pf_fc[12])"
                          r"_wgmma_kernel|"
                          r"convnext_block_dw_ln_tile_kernel)ILi(\d+)E", line)
        cait = re.search(r"Function properties for \S*?((?:talking_head_|"
                         r"window_mha)\w*?_wgmma_kernel|pvt_sra_wgmma_kernel|"
                         r"ln_dense_d[zw]_wgmma_kernel|ln_dense_dx_rows_kernel)"
                         r"(?:ILi(\d+)E)?", line)
        if not (found or tiled or cait) or (found or tiled or cait).groups() in seen:
            continue
        seen.add((found or tiled or cait).groups())
        spills = lines[i + 1].strip()
        used = re.search(r"Used (\d+) registers", lines[i + 2])
        regs = used.group(1) if used else "?"
        if cait:
            name, nh = cait.groups()
            heads = f", heads padded to NH = {nh}" if nh else ""
            if name.startswith("ln_dense"):
                heads = (f", {nh} column chunks" if "rows" in name
                         else f", output tile columns {nh}")
            split = (" (setmaxnreg then splits them between the warpgroups)"
                     if name.startswith("talking_head") else "")
            print(f"ptxas: {name}{heads}: {regs} registers a thread at launch"
                  f"{split}; {spills}", flush=True)
            continue
        if tiled:
            name, param = tiled.groups()
            what = ("tile columns" if "dw_ln" in name
                    else "output tile columns")
            print(f"ptxas: {name}<{param}> ({what} {param}): {regs} "
                  f"registers a thread at launch; {spills}", flush=True)
            continue
        launch, dc, bias = found.groups()
        print(f"ptxas: attention backward launch {'A' if launch == 'rows' else 'B'}"
              f" ({launch}), DC = {dc}, bias {biases[bias]}: "
              f"{regs} registers a thread; {spills}", flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def run(cmd) -> str:
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    return (proc.stdout + proc.stderr).strip()


def cuda_time_ms(fn, iters: int = 20, repeats: int = 5, warmup: int = 3) -> float:
    """Device time of one call of ``fn``: CUDA events around ``iters``
    back-to-back calls, so that the host enqueues ahead of the device and
    its own work per call stays out of the time; the median of ``repeats``
    such runs, after warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def bound(nbytes: float, flops: float):
    """(ms, what bounds it): the larger of the bytes over the card's memory
    rate and the operations over its bf16 tensor-core peak."""
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def heads(qkv, nb_heads):
    """Contiguous q, k, v (B, H, N, d) from packed qkv (B, N, 3 * H * d)."""
    b, n, three_d = qkv.shape
    parts = qkv.reshape(b, n, 3, nb_heads, three_d // 3 // nb_heads)
    return [t.contiguous() for t in parts.permute(2, 0, 3, 1, 4)]


def mha_input(b, n, h, d, dtype, seed, clamp=False):
    """Seeded normal qkv (B, N, 3*H*d) on the card. With ``clamp``, query 0
    of every head points along keys 3 and 5, so that two of its scores land
    near 160, far above the softmax clamp of 80."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(b, n, 3, h, d, generator=g, device="cuda")
    if clamp:
        x[:, 0, 0] = 20.0 * (x[:, 3, 1] + x[:, 5, 1])
    return x.reshape(b, n, 3 * h * d).to(dtype)


def phase_kernels(report, gpu_line):
    import torch
    import torch.nn.functional as F

    from tfimm_tpu_torch.ops.kernels.fused_mha import fused_mha, fused_mha_reference

    cases = [(shape, False) for shape in MHA_SHAPES]
    cases.append((CLAMP_SHAPE, True))
    for dtype in (torch.bfloat16, torch.float32):
        tol = TOL[str(dtype).split(".")[1]]
        for i, ((b, n, h, d), clamp) in enumerate(cases):
            qkv = mha_input(b, n, h, d, dtype, seed=i, clamp=clamp)
            scale = d ** -0.5
            out = fused_mha(qkv, h, scale)
            ref = fused_mha_reference(qkv, h, scale)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            ok = torch.allclose(out.float(), ref.float(), atol=tol, rtol=tol)
            finite = bool(torch.isfinite(out).all())
            print(f"fused_mha {str(dtype):15s} B={b} N={n} H={h} d={d}"
                  f"{' clamp' if clamp else ''}: max_abs_err={err!r} "
                  f"tol={tol} {'ok' if ok and finite else 'FAIL'}", flush=True)
            check(ok and finite, f"fused_mha disagrees with its plain version "
                  f"({dtype}, {(b, n, h, d)}, clamp={clamp}): {err}")
            if dtype == torch.bfloat16 and (b, n, h, d) == MHA_SHAPES[0]:
                report["max_abs_err"] = err
                report["ms"] = cuda_time_ms(lambda: fused_mha(qkv, h, scale))
                report["plain_ms"] = cuda_time_ms(
                    lambda: fused_mha_reference(qkv, h, scale))
                # qkv read once, out written once; q k^T and p v.
                report["bound_ms"], report["bound_by"] = bound(
                    2 * b * n * 4 * h * d, 4 * b * h * n * n * d)
                q, k, v = heads(qkv, h)

                def sdpa_call():
                    return F.scaled_dot_product_attention(q, k, v, scale=scale)

                report["library_ms"] = cuda_time_ms(sdpa_call)
                print(f"fused_mha bf16 {MHA_SHAPES[0]}: kernel "
                      f"{report['ms']!r} ms, plain {report['plain_ms']!r} ms, "
                      f"scaled_dot_product_attention {report['library_ms']!r} "
                      f"ms, bound {report['bound_ms']!r} ms "
                      f"({report['bound_by']})", flush=True)
                print_shares("fused_mha", report,
                             cold_ms(lambda: fused_mha(qkv, h, scale)),
                             cold_ms(sdpa_call), gpu_line)


def print_shares(name, times, kernel_cold_ms, library_cold_ms, gpu_line):
    """A kernel's time back to back (``times["ms"]``, CUDA events around
    back-to-back calls) and with its operands out of L2 (``cold_ms``), each
    as a share of the bound and as a ratio to the library call's time taken
    the same way."""
    bound_ms, lib_ms = times["bound_ms"], times["library_ms"]
    print(f"{name}: back to back {times['ms']!r} ms, {bound_ms / times['ms']!r} "
          f"of the bound, {times['ms'] / lib_ms!r} x SDPA's {lib_ms!r} ms; "
          f"out of L2 {kernel_cold_ms!r} ms, {bound_ms / kernel_cold_ms!r} of "
          f"the bound, {kernel_cold_ms / library_cold_ms!r} x SDPA's "
          f"{library_cold_ms!r} ms; on {gpu_line}", flush=True)


def unmasked_bwd(qkv, g, nb_heads, scale):
    """The plain backward in f32 with the clamp mask left out: dqkv
    (B, N, 3*H*d) in the packed layout, as f32."""
    import torch

    b, n, three_d = qkv.shape
    d = three_d // 3 // nb_heads
    q, k, v = qkv.float().reshape(b, n, 3, nb_heads, d).permute(2, 0, 3, 1, 4)
    g = g.float().reshape(b, n, nb_heads, d).transpose(1, 2)
    s = torch.matmul(q * scale, k.transpose(-1, -2))
    e = torch.exp(torch.clamp(s, max=80.0))
    p = e / e.sum(dim=-1, keepdim=True)
    dv = torch.matmul(p.transpose(-1, -2), g)
    dp = torch.matmul(g, v.transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dq = scale * torch.matmul(ds, k)
    dk = scale * torch.matmul(ds.transpose(-1, -2), q)
    return torch.stack([dq, dk, dv], dim=2).permute(0, 3, 2, 1, 4).reshape(
        b, n, three_d)


def phase_backward_kernel(report, gpu_line):
    import torch
    import torch.nn.functional as F

    from tfimm_tpu_torch.ops.kernels.fused_mha import (
        fused_mha_bwd,
        fused_mha_bwd_reference,
    )

    cases = [(shape, False) for shape in BWD_SHAPES]
    cases.append((CLAMP_SHAPE, True))
    for dtype in (torch.bfloat16, torch.float32):
        tol = BWD_TOL[str(dtype).split(".")[1]]
        for i, ((b, n, h, d), clamp) in enumerate(cases):
            qkv = mha_input(b, n, h, d, dtype, seed=100 + i, clamp=clamp)
            gen = torch.Generator(device="cuda").manual_seed(200 + i)
            g = torch.randn(b, n, h * d, generator=gen, device="cuda").to(dtype)
            scale = d ** -0.5
            got = fused_mha_bwd(qkv, g, h, scale).float()
            ref = fused_mha_bwd_reference(qkv, g, h, scale).float()
            torch.cuda.synchronize()
            err = (got - ref).abs().max().item()
            bar = tol * ref.abs().max().item()
            ok = err <= bar and bool(torch.isfinite(got).all())
            note = ""
            if clamp:
                # Two of query 0's scores sit far above the clamp, where the
                # mask zeroes the score cotangent. Without the mask the
                # gradient would be another one: it must fail the same bar.
                far = (got - unmasked_bwd(qkv, g, h, scale)).abs().max().item()
                ok = ok and far > bar
                note = f" clamp (unmasked backward off by {far!r})"
            print(f"fused_mha_bwd {str(dtype):15s} B={b} N={n} H={h} d={d}"
                  f"{note}: max_abs_err={err!r} bar={bar!r} "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            check(ok, f"fused_mha_bwd disagrees with its plain version "
                  f"({dtype}, {(b, n, h, d)}, clamp={clamp}): {err} > {bar}")
            if dtype == torch.bfloat16 and (b, n, h, d) == BWD_SHAPES[0]:
                report["max_abs_err"] = err
                report["ms"] = cuda_time_ms(lambda: fused_mha_bwd(qkv, g, h, scale))
                report["plain_ms"] = cuda_time_ms(
                    lambda: fused_mha_bwd_reference(qkv, g, h, scale))
                # qkv and g read once, dqkv written once; s = q k^T again
                # and the four products of the backward.
                report["bound_ms"], report["bound_by"] = bound(
                    2 * b * n * 7 * h * d, 10 * b * h * n * n * d)
                q, k, v = [t.requires_grad_() for t in heads(qkv, h)]
                out = F.scaled_dot_product_attention(q, k, v, scale=scale)
                gh = g.reshape(b, n, h, d).transpose(1, 2).contiguous()

                def sdpa_bwd():
                    return torch.autograd.grad(out, (q, k, v), gh,
                                               retain_graph=True)

                report["library_ms"] = cuda_time_ms(sdpa_bwd)
                print(f"fused_mha_bwd bf16 {BWD_SHAPES[0]}: kernel "
                      f"{report['ms']!r} ms, plain {report['plain_ms']!r} ms, "
                      f"scaled_dot_product_attention backward "
                      f"{report['library_ms']!r} ms, bound "
                      f"{report['bound_ms']!r} ms ({report['bound_by']})",
                      flush=True)
                print_shares("fused_mha_bwd", report,
                             cold_ms(lambda: fused_mha_bwd(qkv, g, h, scale)),
                             cold_ms(sdpa_bwd), gpu_line)


def seeded_state_dict(model, seed: int, std: float = 0.02):
    """Every parameter drawn from a seeded normal, in f32 on the CPU: the
    LayerNorm, GroupNorm and Affine weights and the layer scales
    (ConvNeXt's and CaiT's gammas, PoolFormer's layer_scale_1 and _2,
    ResMLP's ls1 and ls2) around 1,
    Swin's relative-position bias tables and CaiT's (H, H) head mixes with
    std 0.3, the rest with std ``std``. The heads, which start at zero, then
    give non-zero logits, and the branches of a ConvNeXt or CaiT block do
    not vanish, as they would at gamma's init value of 1e-5 or 1e-6."""
    import torch

    from tfimm_tpu_torch.ops.norm import Affine, GroupNorm, LayerNorm

    near_one = {f"{name}.weight" for name, module in model.named_modules()
                if isinstance(module, (LayerNorm, GroupNorm, Affine))}
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for name, p in model.state_dict().items():
        r = torch.randn(p.shape, generator=g)
        if name in near_one or name.rsplit(".", 1)[-1].startswith(
                ("gamma", "layer_scale", "ls1", "ls2")):
            sd[name] = 1.0 + 0.1 * r
        elif name.endswith(("relative_position_bias_table", "proj_l.weight",
                            "proj_w.weight")):
            sd[name] = 0.3 * r   # a small table or mix would hide it
        else:
            sd[name] = std * r
    return sd


def phase_slice(reports, gpu_line):
    import torch

    import tfimm_tpu_torch as tfm
    from tfimm_tpu_torch.ops.kernels import dispatch

    model = tfm.create_model(MODEL, device="cuda", dtype=torch.bfloat16, seed=0)
    sd = seeded_state_dict(model, seed=0)
    model.load_state_dict(sd)
    pp = tfm.create_preprocessing(MODEL, dtype=torch.bfloat16, device="cuda")
    nb_blocks = model.cfg.nb_blocks
    g = torch.Generator(device="cuda").manual_seed(1)
    requests = [torch.randint(0, 256, (BATCH, 224, 224, 3), generator=g,
                              device="cuda", dtype=torch.uint8)
                for _ in range(REQUESTS)]
    torch.cuda.synchronize()

    dispatch.reset_launch_counts()
    seconds, outputs = [], []
    for img in requests:
        before = dispatch.launch_counts["fused_mha"]
        t0 = time.perf_counter()
        logits = model.predict(pp(img))
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        rose = dispatch.launch_counts["fused_mha"] - before
        check(rose == nb_blocks,
              f"fused_mha launched {rose} times in one request, expected {nb_blocks}")
        check(tuple(logits.shape) == (BATCH, model.cfg.nb_classes),
              f"logits shape {tuple(logits.shape)}")
        check(bool(torch.isfinite(logits).all()), "non-finite logits")
        check(bool(logits.abs().max() > 0), "all-zero logits")
        outputs.append(logits)
    launches = dispatch.launch_counts["fused_mha"]
    bwd_launches = dispatch.launch_counts["fused_mha_bwd"]
    for name, report in reports.items():
        report["launches_by_path"]["serve"] = dispatch.launch_counts[name]
    check(launches == REQUESTS * nb_blocks,
          f"fused_mha launches {launches} != {REQUESTS * nb_blocks}")
    check(bwd_launches == 0,
          f"serving launched fused_mha_bwd {bwd_launches} times")
    img_s = [BATCH / s for s in seconds[1:]]
    print(f"slice {MODEL} bs{BATCH} bf16: request seconds {seconds!r}", flush=True)
    print(f"slice {MODEL} bs{BATCH} bf16: {statistics.median(img_s)!r} img/s "
          f"(median of requests 2-{REQUESTS}) on {gpu_line}", flush=True)

    # The same weights in f32 through the plain attention: capturing the
    # attention weights makes every block decline the fused kernel.
    x = requests[0]
    with torch.inference_mode():
        feats = model.forward(pp(x), features_only=True)
    model32 = tfm.create_model(MODEL, device="cuda", dtype=torch.float32, seed=0)
    model32.load_state_dict(sd)
    pp32 = tfm.create_preprocessing(MODEL, dtype=torch.float32, device="cuda")
    before = dispatch.launch_counts["fused_mha"]
    with torch.inference_mode():
        ref_logits, ref_feats = model32(pp32(x), return_features=True)
    check(dispatch.launch_counts["fused_mha"] == before,
          "the f32 reference went through the kernel")
    for name, got, want in (("forward_features", feats, ref_feats["features"]),
                            ("logits", outputs[0], ref_logits)):
        rel = ((got.float() - want).abs().max() / want.abs().max()).item()
        print(f"slice {name}: bf16 kernel path vs f32 plain path rel err "
              f"{rel!r} (bar 5e-2)", flush=True)
        check(rel < 5e-2, f"{name} rel err {rel} >= 5e-2")
    del model32

    # Where a request's device time goes.
    wall_ms, groups, _ = device_split(lambda: model.predict(pp(x)), steps=2)
    busy_ms = sum(groups.values())
    request_ms = statistics.median(seconds[1:]) * 1e3
    print(f"slice {MODEL} bs{BATCH} request profile: device busy {busy_ms!r} "
          f"ms; wall {wall_ms!r} ms under the profiler, {request_ms!r} ms "
          f"without; device idle share {1.0 - busy_ms / request_ms!r}",
          flush=True)
    for group, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"slice {MODEL} request profile: {group}: {ms!r} ms", flush=True)


def expected(**counts) -> dict:
    """Launch counts of every kernel: ``counts``, and 0 for the others."""
    from tfimm_tpu_torch.ops.kernels import dispatch

    return {**dict.fromkeys(dispatch.launch_counts, 0), **counts}


def train_config() -> dict:
    """ViT-B/16 at batch 64, bf16 mixed precision, AdamW at lr 1e-4, 6
    epochs of one step each on the same 64 synthetic images."""
    data = {"batch_size": TRAIN_BATCH, "nb_samples": TRAIN_BATCH,
            "input_size": (224, 224), "nb_classes": 1000, "seed": 0}
    return {
        "trainer_class": "Trainer",
        "trainer": {"validation_before_training": False,
                    "display_loss_every_it": 1},
        "problem_class": "ClassificationProblem",
        "problem": {"model_class": "ModelFactory",
                    "model": {"model_name": MODEL},
                    "optimizer_class": "OptimizerFactory",
                    "optimizer": {"optimizer": "adamw",
                                  "lr_schedule_class": "LRConstFactory",
                                  "lr_schedule": {"lr": 1e-4}},
                    "mixed_precision": True},
        "train_dataset_class": "SyntheticDataset", "train_dataset": data,
        "timekeeping_class": "Timekeeping",
        "timekeeping": {"nb_epochs": TRAIN_STEPS, "batch_size": TRAIN_BATCH,
                        "nb_samples_per_epoch": TRAIN_BATCH},
        "device": "cuda",
    }


def device_split(fn, steps: int = 3):
    """``torch.profiler`` over ``steps`` calls of ``fn``: the wall time of a
    call under the profiler, its device time by kernel group and by kernel
    name (ms)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    groups, names = {}, {}
    for evt in prof.events():
        # User annotations (the optimizer's step range) span kernels that
        # are counted on their own.
        if (evt.device_type != torch.autograd.DeviceType.CUDA
                or getattr(evt, "is_user_annotation", False)):
            continue
        name = evt.name.lower()
        group = next((g for g, keys in KERNEL_GROUPS
                      if any(k in name for k in keys)), OTHER_KERNELS)
        ms = evt.time_range.elapsed_us() / 1e3
        groups[group] = groups.get(group, 0.0) + ms
        names[evt.name] = names.get(evt.name, 0.0) + ms
    return (wall_ms / steps, {g: ms / steps for g, ms in groups.items()},
            {n: ms / steps for n, ms in names.items()})


def device_ms(fn, steps: int = 10, tries: int = 5) -> float:
    """Device time of one call of ``fn``: the sum of its kernels' device
    times under ``torch.profiler`` over ``steps`` calls, over ``steps``. It
    leaves out the gaps in which the device waits for the host, which CUDA
    events around back-to-back calls count where a call's host work is
    longer than its device work. A profile that kept no device event is
    taken again, up to ``tries`` profiles in all; then the phase fails."""
    fn()
    for attempt in range(1, tries + 1):
        _, groups, _ = device_split(fn, steps=steps)
        if groups:
            return sum(groups.values())
        print(f"profile {attempt} of {tries} kept no device event",
              flush=True)
    raise SmokeFailure(f"{tries} profiles in a row kept no device event")


def launch_parts(names, kernel) -> dict:
    """Device ms of each launch of ``kernel`` (CONVNEXT_LAUNCH_PARTS) from
    a profile's kernel names (``device_split``)."""
    return {part: sum(ms for name, ms in names.items()
                      if any(k in name for k in keys))
            for part, keys in CONVNEXT_LAUNCH_PARTS[kernel]}


def print_launch_parts(what, names, kernel) -> None:
    for part, ms in launch_parts(names, kernel).items():
        print(f"{what} request profile launch {kernel} {part}: {ms!r} ms per "
              f"request", flush=True)


def profile_pad(flush) -> None:
    """PROFILE_PAD tiny launches (fills of ``flush``, which the readers
    leave out), a synchronize and a 50 ms pause, at each end of a short
    profile. In some full runs on the H100 the sessions after phase 18
    lost their first few records and all from some point on (one with
    4,096 fills ahead of its calls kept 4,091 of them and no call; one
    padded after its calls kept all but its first six); the cause is not
    known. The pads keep the calls away from both ends."""
    import torch

    for _ in range(PROFILE_PAD):
        flush[:4].fill_(0.0)
    torch.cuda.synchronize()
    time.sleep(0.05)


def profile_cases(cases: dict, tries: int = 5) -> dict:
    """The device events of a phase's cases, from one profile: ``cases``
    maps a label to (fn, calls, keys); the label's ``calls`` calls of
    ``fn``, each after a negation in place of L2_FLUSH_BYTES (so its
    operands are out of L2; a kernel ``fn`` does not launch, whose name is
    read from a range of its own ahead of the cases), run in one
    ``record_function(label)`` range that opens with a 1 ms pause and ends
    with a synchronize, so that the device's clock, as the profile aligns
    it with the host's, places each launch inside its range. Returns
    {label: [(name, ms), ...]}, the device events that started inside the
    label's range, the flush's left out. A profile in which the flush's
    range kept no event, or a label's range holds no flush or more than
    ``calls`` (its events would not be its own), no other event, or none
    whose name holds a key of ``keys``, is taken again two seconds later,
    up to ``tries`` in all; then the phase fails."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    flush = torch.zeros(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                        device="cuda")
    for fn, _, _ in cases.values():
        fn()
    torch.cuda.synchronize()
    for attempt in range(1, tries + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            profile_pad(flush)
            with record_function(FLUSH_RANGE):
                flush.neg_()
                torch.cuda.synchronize()
            for label, (fn, calls, _) in cases.items():
                with record_function(label):
                    time.sleep(0.001)
                    for _ in range(calls):
                        flush.neg_()
                        fn()
                    torch.cuda.synchronize()
            profile_pad(flush)
        ranges = {evt.name: evt.time_range for evt in prof.events()
                  if evt.device_type == cpu
                  and (evt.name in cases or evt.name == FLUSH_RANGE)}
        device = [(evt.time_range.start, evt.name,
                   evt.time_range.elapsed_us() / 1e3)
                  for evt in prof.events() if evt.device_type == cuda
                  and not getattr(evt, "is_user_annotation", False)]

        def inside(label):
            span = ranges.get(label)
            return [(name, ms) for start, name, ms in device
                    if span is not None and span.start <= start <= span.end]

        flush_names = {name for name, _ in inside(FLUSH_RANGE)}
        found, short = {}, [] if flush_names else ["the flush"]
        for label, (_, calls, keys) in cases.items():
            events = inside(label)
            found[label] = [(name, ms) for name, ms in events
                            if name not in flush_names]
            flushes = len(events) - len(found[label])
            if (not 0 < flushes <= calls or not found[label]
                    or any(not any(k in name for name, _ in found[label])
                           for k in keys)):
                short.append(f"{label} ({flushes} flushes, "
                             f"{sorted({n[:60] for n, _ in found[label]})})")
        if not short:
            return found
        print(f"profile {attempt} of {tries} lacks {short}", flush=True)
        time.sleep(2.0)
    raise SmokeFailure(f"{tries} profiles in a row lacked the launches of "
                       f"some of {list(cases)}")


def launch_means(events, calls: int) -> dict:
    """Device ms of every kernel in ``events`` (name, ms) of ``calls``
    calls, by name: a name's mean over its events, times its launches a
    call."""
    by_name = {}
    for name, t in events:
        by_name.setdefault(name, []).append(t)
    return {name: statistics.mean(ts) * max(1, round(len(ts) / calls))
            for name, ts in by_name.items()}


def cold_device_events(fn, calls: int = 3, tries: int = 5,
                       need=()) -> list:
    """The device events (name, ms) of ``calls`` calls of ``fn`` from one
    profile, each call after a write of L2_FLUSH_BYTES, so its operands are
    out of L2; the flush's own fill left out. ``need`` lists the launches
    the profile must hold, each as a tuple of name keys of which one must
    be in an event's name. A profile that kept no device event, or none of
    a needed launch (a profile may drop events), is taken again two seconds
    later, up to ``tries`` profiles in all; then the phase fails."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                        device="cuda")
    fn()
    torch.cuda.synchronize()
    for attempt in range(1, tries + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            profile_pad(flush)
            for _ in range(calls):
                flush.fill_(1.0)
                fn()
            torch.cuda.synchronize()
            profile_pad(flush)
        events = [(evt.name, evt.time_range.elapsed_us() / 1e3)
                  for evt in prof.events()
                  if evt.device_type == torch.autograd.DeviceType.CUDA
                  and "Fill" not in evt.name]
        names = sorted({name[:90] for name, _ in events})
        missing = [keys for keys in need
                   if not any(k in name for name, _ in events for k in keys)]
        if events and not missing:
            return events
        kept = f"no launch of {missing}" if events else "no device event"
        print(f"profile {attempt} of {tries} kept {kept}: {names}",
              flush=True)
        time.sleep(2.0)
    raise SmokeFailure(f"{tries} profiles in a row kept no device event or "
                       f"no launch of one of {list(need)}")


def cold_launch_parts(fn, kernel, calls: int = 3, events=None,
                      skip=()) -> dict:
    """Device ms of each launch of one call of ``fn`` (a call of
    ``kernel``), its operands out of L2 (``cold_device_events``, or the
    ``events`` of such a profile already taken); each launch's mean over
    the events the profile kept of it (a profile may drop a call's
    events). ``skip``: launches this call does not run, reported as 0.0.
    The phase fails if the profile kept none of a launch, or one of a
    launch in ``skip``."""
    if events is None:
        events = cold_device_events(fn, calls,
                                    need=launch_keys(kernel, skip))
    parts = {}
    for part, keys in CONVNEXT_LAUNCH_PARTS[kernel]:
        ms = [t for name, t in events if any(k in name for k in keys)]
        check(bool(ms) is (part not in skip),
              f"{kernel}: the profile kept {len(ms)} launches of {part}"
              f"{', which this call does not run' if part in skip else ''}: "
              f"{sorted({name[:90] for name, _ in events})}")
        parts[part] = sum(ms) / len(ms) if ms else 0.0
    return parts


def launch_keys(kernel, skip=()) -> list:
    """The name keys of each launch of ``kernel`` (CONVNEXT_LAUNCH_PARTS)
    but those in ``skip``, as ``cold_device_events`` needs them."""
    return [keys for part, keys in CONVNEXT_LAUNCH_PARTS[kernel]
            if part not in skip]


def cold_call_kernels(fn, calls: int = 3, need=()) -> dict:
    """Device ms of every kernel one call of ``fn`` launches, by name, its
    operands out of L2 (``cold_device_events``, which retakes a profile
    without a launch that ``need`` names; ``launch_means``)."""
    return launch_means(cold_device_events(fn, calls, need=need), calls)


def run_watched(config, problem="ClassificationProblem"):
    """``train.run(config)`` with every step it takes watched: its loss, its
    wall time (the step ends by reading the loss, which synchronises) and
    its kernel launches (``problem`` names the problem class). Returns
    (trainer, steps, the run's launch counts); the counts start at 0 just
    before the run."""
    import tfimm_tpu_torch.train as ttrain
    from tfimm_tpu_torch.ops.kernels import dispatch

    steps = []
    problem_cls = getattr(ttrain, problem)
    train_step = problem_cls.train_step

    def watched_step(self, data, it):
        before = dict(dispatch.launch_counts)
        t0 = time.perf_counter()
        out = train_step(self, data, it)
        steps.append((out[0], time.perf_counter() - t0,
                      {k: dispatch.launch_counts[k] - before[k] for k in before}))
        return out

    problem_cls.train_step = watched_step
    try:
        dispatch.reset_launch_counts()
        trainer = ttrain.run(config, parse_cmdline_args=False)
        counts = dict(dispatch.launch_counts)
    finally:
        problem_cls.train_step = train_step
    return trainer, steps, counts


def phase_train(reports, gpu_line):
    import torch

    from tfimm_tpu_torch.ops.kernels import dispatch
    from tfimm_tpu_torch.parallel.step import cross_entropy_loss
    from tfimm_tpu_torch.utils.profile import time_model

    trainer, steps, counts = run_watched(train_config())
    problem = trainer.problem
    nb_blocks = problem.model.cfg.nb_blocks
    check(len(steps) == TRAIN_STEPS, f"{len(steps)} training steps, "
          f"expected {TRAIN_STEPS}")
    for it, (loss, seconds, rose) in enumerate(steps):
        print(f"train step {it}: loss {loss!r}, {seconds!r} s, launches {rose}",
              flush=True)
        check(rose == expected(fused_mha=nb_blocks, fused_mha_bwd=nb_blocks),
              f"step {it} launched {rose}, expected {nb_blocks} of each "
              f"attention kernel")
        check(math.isfinite(loss), f"step {it}: loss {loss}")
    check(steps[-1][0] < steps[0][0],
          f"the loss did not fall: {steps[0][0]} -> {steps[-1][0]}")
    for name, report in reports.items():
        report["launches_by_path"]["train"] = counts[name]
    # The rate is all the images of steps 2-N over all their time, so that a
    # stall in any step counts; the median step is kept beside it.
    timed = [s for _, s, _ in steps[1:]]
    step_s = sum(timed) / len(timed)
    print(f"train {MODEL} bs{TRAIN_BATCH} bf16 mixed precision adamw: "
          f"{TRAIN_BATCH * len(timed) / sum(timed)!r} img/s ({len(timed)} steps "
          f"2-{TRAIN_STEPS} in {sum(timed) * 1e3!r} ms; median step "
          f"{statistics.median(timed) * 1e3!r} ms, slowest "
          f"{max(timed) * 1e3!r} ms) on {gpu_line}", flush=True)

    # One step's loss and gradients with seeded weights: bf16 through the
    # kernels against f32 through the plain attention (capturing the
    # attention weights makes every block decline the kernels).
    model, pp = problem.model, problem.preprocessing
    model.load_state_dict(seeded_state_dict(model, seed=1))
    model.train()
    images, labels = next(iter(trainer.train_ds))
    images = torch.as_tensor(images, device="cuda")
    labels = torch.as_tensor(labels, device="cuda")
    names = ("blocks.0.attn.qkv.weight", "head.weight")

    def loss_and_grads(x, return_features):
        model.zero_grad(set_to_none=True)
        before = dict(dispatch.launch_counts)
        out = model(x, return_features=return_features)
        logits = out[0] if return_features else out
        loss = cross_entropy_loss(logits.float(), labels)
        loss.backward()
        rose = {k: dispatch.launch_counts[k] - before[k] for k in before}
        params = dict(model.named_parameters())
        return loss.item(), {n: params[n].grad.float() for n in names}, rose

    loss_k, grads_k, rose = loss_and_grads(pp(images).to(torch.bfloat16), False)
    check(rose == expected(fused_mha=nb_blocks, fused_mha_bwd=nb_blocks),
          f"the bf16 step launched {rose}")
    loss_r, grads_r, rose = loss_and_grads(pp(images), True)
    check(rose == expected(), f"the f32 reference went through the kernels: {rose}")
    rel = abs(loss_k - loss_r) / abs(loss_r)
    print(f"train loss: bf16 kernel path {loss_k!r} vs f32 plain path "
          f"{loss_r!r}, rel err {rel!r} (bar 2e-2)", flush=True)
    check(rel < 2e-2, f"loss rel err {rel} >= 2e-2")
    for name in names:
        ref = grads_r[name]
        rel = ((grads_k[name] - ref).abs().max() / ref.abs().max()).item()
        print(f"train grad {name}: max|diff| / max|ref| {rel!r} (bar 1e-1)",
              flush=True)
        check(rel < 1e-1, f"{name} gradient rel err {rel} >= 1e-1")
        check(ref.abs().max().item() > 0, f"{name}: zero reference gradient")

    batch = (images.cpu().numpy(), labels.cpu().numpy())
    wall_ms, groups, _ = device_split(lambda: problem.train_step(batch, 0))
    busy_ms = sum(groups.values())
    # The profiler slows the host down, so the idle share is taken against
    # the mean step time of steps 2-N measured without it.
    print(f"train step profile: device busy {busy_ms!r} ms per step; wall "
          f"{wall_ms!r} ms under the profiler, {step_s * 1e3!r} ms without; "
          f"device idle share {1.0 - busy_ms / (step_s * 1e3)!r}", flush=True)
    for group, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"train step profile: {group}: {ms!r} ms per step", flush=True)

    img_s = time_model(MODEL, target="backprop", batch_size=TRAIN_BATCH,
                       samples=3)
    print(f"time_model {MODEL} backprop bs{TRAIN_BATCH} bf16: {img_s!r} img/s "
          f"on {gpu_line}", flush=True)


def convnext_inputs(m, c, hidden, dtype, seed):
    """Seeded inputs of ``convnext_mlp`` on the card: x and shortcut
    normal, the LN weight and gamma near 1, the weights scaled so that both
    products are of unit size."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape, scale=1.0, shift=0.0):
        return torch.randn(*shape, generator=g, device="cuda") * scale + shift

    return (rnd(m, c).to(dtype), rnd(m, c).to(dtype),
            rnd(c, scale=0.1, shift=1.0), rnd(c, scale=0.1),
            rnd(hidden, c, scale=c ** -0.5).to(dtype), rnd(hidden, scale=0.1),
            rnd(c, hidden, scale=hidden ** -0.5).to(dtype),
            rnd(c, scale=0.1), rnd(c, scale=0.1, shift=1.0))


def convnext_mlp_bound(m, c, hidden):
    """x and shortcut read once, out written once, both weights read once
    (bf16), the f32 vectors; the two products."""
    nbytes = 2 * (3 * m * c + 2 * c * hidden) + 4 * (4 * c + hidden)
    return bound(nbytes, 4 * m * c * hidden)


def phase_convnext_kernel(report):
    import torch
    import torch.nn.functional as F

    from tfimm_tpu_torch.ops.kernels.convnext_mlp import (
        convnext_mlp,
        convnext_mlp_reference,
    )

    worst = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        tol = CONVNEXT_TOL[str(dtype).split(".")[1]]
        for i, (m, c, hidden) in enumerate(CONVNEXT_STAGES + CONVNEXT_EDGES):
            args = convnext_inputs(m, c, hidden, dtype, seed=300 + i)
            got = convnext_mlp(*args, 1e-6).float()
            ref = convnext_mlp_reference(*args, 1e-6).float()
            torch.cuda.synchronize()
            err = (got - ref).abs().max().item()
            bar = tol * ref.abs().max().item()
            ok = err <= bar and bool(torch.isfinite(got).all())
            print(f"convnext_mlp {str(dtype):15s} M={m} C={c} H={hidden}: "
                  f"max_abs_err={err!r} bar={bar!r} {'ok' if ok else 'FAIL'}",
                  flush=True)
            check(ok, f"convnext_mlp disagrees with its plain version "
                  f"({dtype}, {(m, c, hidden)}): {err} > {bar}")
            if dtype == torch.bfloat16 and i < len(CONVNEXT_STAGES):
                worst = max(worst, err)
            del args, got, ref
    report["max_abs_err"] = worst

    # Per stage shape, then per request (each stage's times its blocks):
    # with the operands out of L2 (a 512 MB write before each call), and
    # back to back in L2 as PRs 3-15 timed them.
    keys = ("ms", "plain_ms", "cublas_floor_ms", "bound_ms", "warm_ms",
            "plain_warm_ms", "cublas_floor_warm_ms")
    totals = dict.fromkeys(keys, 0.0)
    parts_total = {}
    bound_by = {}
    for (m, c, hidden), depth in zip(CONVNEXT_STAGES, CONVNEXT_DEPTHS):
        args = convnext_inputs(m, c, hidden, torch.bfloat16, seed=400)
        x, w1, w2 = args[0], args[4], args[6]
        h = torch.randn(m, hidden, device="cuda").to(torch.bfloat16)
        t = {"ms": cold_ms(lambda: convnext_mlp(*args, 1e-6)),
             "plain_ms": cold_ms(lambda: convnext_mlp_reference(*args, 1e-6),
                                 calls=3, warmup=1),
             "fc1_ms": cold_ms(lambda: F.linear(x, w1)),
             "fc2_ms": cold_ms(lambda: F.linear(h, w2)),
             "warm_ms": cuda_time_ms(lambda: convnext_mlp(*args, 1e-6)),
             "plain_warm_ms": cuda_time_ms(
                 lambda: convnext_mlp_reference(*args, 1e-6), iters=5),
             "fc1_warm_ms": cuda_time_ms(lambda: F.linear(x, w1)),
             "fc2_warm_ms": cuda_time_ms(lambda: F.linear(h, w2))}
        t["cublas_floor_ms"] = t["fc1_ms"] + t["fc2_ms"]
        t["cublas_floor_warm_ms"] = t["fc1_warm_ms"] + t["fc2_warm_ms"]
        t["bound_ms"], by = convnext_mlp_bound(m, c, hidden)
        bound_by[by] = bound_by.get(by, 0.0) + depth * t["bound_ms"]
        tflop = 4 * m * c * hidden / 1e12
        for key, what in (("ms", "kernel"), ("plain_ms", "plain"),
                          ("cublas_floor_ms", "cuBLAS floor"),
                          ("warm_ms", "kernel in L2"),
                          ("plain_warm_ms", "plain in L2"),
                          ("cublas_floor_warm_ms", "cuBLAS floor in L2")):
            print(f"convnext_mlp bf16 M={m} C={c} H={hidden}: {what} "
                  f"{t[key]!r} ms, {tflop / (t[key] / 1e3)!r} TFLOP/s, "
                  f"{t['bound_ms'] / t[key]!r} of the bound", flush=True)
        print(f"convnext_mlp bf16 M={m} C={c} H={hidden}: F.linear fc1 "
              f"{t['fc1_ms']!r} ms, fc2 {t['fc2_ms']!r} ms out of L2 "
              f"({t['fc1_warm_ms']!r}, {t['fc2_warm_ms']!r} in L2); bound "
              f"{t['bound_ms']!r} ms ({by}); {depth} blocks a request",
              flush=True)
        parts = cold_launch_parts(lambda: convnext_mlp(*args, 1e-6),
                                  "convnext_mlp")
        for part, ms in parts.items():
            print(f"convnext_mlp bf16 M={m} C={c} H={hidden}: launch {part} "
                  f"{ms!r} ms out of L2 (profiler)", flush=True)
            parts_total[part] = parts_total.get(part, 0.0) + depth * ms
        for key in keys:
            totals[key] += depth * t[key]
        del args, x, w1, w2, h
    report.update(totals)
    report["bound_by"] = max(bound_by, key=bound_by.get)
    report["library_ms"] = None
    print(f"convnext_mlp per ConvNeXt-B bs{BATCH} request "
          f"({sum(CONVNEXT_DEPTHS)} calls, operands out of L2): kernel "
          f"{totals['ms']!r} ms, plain {totals['plain_ms']!r} ms, cuBLAS floor "
          f"{totals['cublas_floor_ms']!r} ms "
          f"({totals['ms'] / totals['cublas_floor_ms']!r} x), bound "
          f"{totals['bound_ms']!r} ms ({report['bound_by']}); in L2: kernel "
          f"{totals['warm_ms']!r} ms, plain {totals['plain_warm_ms']!r} ms, "
          f"cuBLAS floor {totals['cublas_floor_warm_ms']!r} ms", flush=True)
    print("convnext_mlp per request, launches out of L2 (profiler): "
          + "; ".join(f"{part} {ms!r} ms" for part, ms in parts_total.items()),
          flush=True)


def phase_convnext_slice(reports, gpu_line):
    """Phase 6, with TFIMM_TPU_FUSED_CONVNEXT pinned to 0 for its run (the
    variable restored after): the default path, whatever the environment
    says."""
    with restored_env("TFIMM_TPU_FUSED_CONVNEXT"):
        os.environ["TFIMM_TPU_FUSED_CONVNEXT"] = "0"
        convnext_slice(reports, gpu_line)


def convnext_slice(reports, gpu_line):
    import torch

    import tfimm_tpu_torch as tfm
    from tfimm_tpu_torch.ops.kernels import dispatch

    model = tfm.create_model(CONVNEXT, device="cuda", dtype=torch.bfloat16,
                             seed=0)
    sd = seeded_state_dict(model, seed=2, std=0.05)
    model.load_state_dict(sd)
    pp = tfm.create_preprocessing(CONVNEXT, dtype=torch.bfloat16, device="cuda")
    nb_blocks = sum(model.cfg.nb_blocks)
    g = torch.Generator(device="cuda").manual_seed(3)
    requests = [torch.randint(0, 256, (BATCH, 224, 224, 3), generator=g,
                              device="cuda", dtype=torch.uint8)
                for _ in range(REQUESTS)]
    torch.cuda.synchronize()

    dispatch.reset_launch_counts()
    seconds, outputs = [], []
    for img in requests:
        before = dict(dispatch.launch_counts)
        t0 = time.perf_counter()
        logits = model.predict(pp(img))
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        rose = {k: dispatch.launch_counts[k] - before[k] for k in before}
        check(rose == expected(convnext_mlp=nb_blocks),
              f"one ConvNeXt request launched {rose}, expected convnext_mlp "
              f"{nb_blocks} times and nothing else")
        check(tuple(logits.shape) == (BATCH, model.cfg.nb_classes),
              f"logits shape {tuple(logits.shape)}")
        check(bool(torch.isfinite(logits).all()), "non-finite logits")
        check(bool(logits.abs().max() > 0), "all-zero logits")
        outputs.append(logits)
    for name, report in reports.items():
        report["launches_by_path"]["serve_convnext"] = dispatch.launch_counts[name]
    img_s = [BATCH / s for s in seconds[1:]]
    request_ms = statistics.median(seconds[1:]) * 1e3
    print(f"slice {CONVNEXT} bs{BATCH} bf16: request seconds {seconds!r}",
          flush=True)
    print(f"slice {CONVNEXT} bs{BATCH} bf16: {statistics.median(img_s)!r} img/s "
          f"(median of requests 2-{REQUESTS}; range {min(img_s)!r}-"
          f"{max(img_s)!r}) on {gpu_line}", flush=True)

    # The same weights in f32 through the eager composition: with autograd
    # recording the parameters, every block declines the kernel.
    x = requests[0][:CONVNEXT_CHECK_IMAGES]
    with torch.inference_mode():
        feats = model.forward(pp(x), features_only=True)
    model32 = tfm.create_model(CONVNEXT, device="cuda", dtype=torch.float32,
                               seed=0)
    model32.load_state_dict(sd)
    pp32 = tfm.create_preprocessing(CONVNEXT, dtype=torch.float32,
                                    device="cuda")
    before = dict(dispatch.launch_counts)
    with torch.enable_grad():
        ref_logits, ref_feats = model32(pp32(x), return_features=True)
    check(dispatch.launch_counts == before,
          "the f32 eager reference launched a kernel")
    for name, got, want in (
            ("forward_features", feats, ref_feats["conv_features"]),
            ("logits", outputs[0][:CONVNEXT_CHECK_IMAGES], ref_logits)):
        want = want.detach()
        rel = ((got.float() - want).abs().max() / want.abs().max()).item()
        print(f"slice {CONVNEXT} {name}: bf16 kernel path vs f32 eager path "
              f"rel err {rel!r} (bar 5e-2)", flush=True)
        check(rel < 5e-2, f"{CONVNEXT} {name} rel err {rel} >= 5e-2")
    del model32, ref_logits, ref_feats

    img = requests[1]
    wall_ms, groups, names = device_split(lambda: model.predict(pp(img)),
                                          steps=2)
    busy_ms = sum(groups.values())
    print(f"{CONVNEXT} request profile: device busy {busy_ms!r} ms per request; "
          f"wall {wall_ms!r} ms under the profiler, {request_ms!r} ms without; "
          f"device idle share {1.0 - busy_ms / request_ms!r}", flush=True)
    for group, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"{CONVNEXT} request profile: {group}: {ms!r} ms per request",
              flush=True)
    for name, ms in sorted(names.items(), key=lambda kv: -kv[1])[:12]:
        print(f"{CONVNEXT} request profile kernel: {ms!r} ms {name[:150]}",
              flush=True)
    print_launch_parts(CONVNEXT, names, "convnext_mlp")


def swin_inputs(bw, n, c, h, side, shifted, dtype, seed):
    """Seeded inputs of ``swin_block`` and ``window_mha`` on the card: x and
    a packed qkv normal, the LayerNorm weights near 1, the matrices scaled
    so that every product is of unit size, a bias (H, N, N) of std 0.5 (a
    small table would hide a kernel that drops it) and, for a shifted block
    on a map of more than one window, the model's shift mask."""
    import torch

    from tfimm_tpu_torch.architectures.swin import _attention_mask
    from tfimm_tpu_torch.ops.kernels.swin_block import SwinBlockParams

    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape, scale=1.0, shift=0.0):
        return torch.randn(*shape, generator=g, device="cuda") * scale + shift

    hid = 4 * c
    params = SwinBlockParams(
        rnd(c, scale=0.1, shift=1.0), rnd(c, scale=0.1),
        rnd(3 * c, c, scale=c ** -0.5).to(dtype), rnd(3 * c, scale=0.1),
        rnd(c, c, scale=c ** -0.5).to(dtype), rnd(c, scale=0.1),
        rnd(c, scale=0.1, shift=1.0), rnd(c, scale=0.1),
        rnd(hid, c, scale=c ** -0.5).to(dtype), rnd(hid, scale=0.1),
        rnd(c, hid, scale=hid ** -0.5).to(dtype), rnd(c, scale=0.1))
    ws = math.isqrt(n)
    mask = None
    if shifted and side > ws:
        mask = torch.from_numpy(_attention_mask((side, side), ws, ws // 2))
        mask = mask.to("cuda")
    return (rnd(bw, n, c).to(dtype), rnd(bw, n, 3 * c).to(dtype), params,
            rnd(h, n, n, scale=0.5), mask)


def held(got, ref, tol):
    """(max abs err, bar = tol * max|ref|, within the bar and finite)."""
    import torch

    err = (got.float() - ref.float()).abs().max().item()
    bar = tol * ref.float().abs().max().item()
    return err, bar, err <= bar and bool(torch.isfinite(got).all())


def window_body(fn, bwd=False) -> str:
    """The body one call of ``fn`` (a ``window_mha`` launch or, with
    ``bwd``, a ``window_mha_bwd`` one) ran, read from the profiler's kernel
    names: "wgmma" for the TMA + wgmma body (``window_mha_wgmma_kernel``,
    ``window_mha_bwd_wgmma_kernel``), "first" for the first bodies
    (``mma.sync`` in bf16, FMAs in f32)."""
    key = "window_mha_bwd_" if bwd else "window_mha_"
    events = cold_device_events(fn, 1, need=[(key,)])
    names = {name for name, _ in events
             if key in name and (bwd or "window_mha_bwd" not in name)}
    bodies = {"wgmma" if "wgmma" in name else "first" for name in names}
    check(len(bodies) == 1, f"{key}: the profile shows {sorted(names)}")
    return bodies.pop()


def window_body_expected(dtype, n, d) -> str:
    """The body ``tma.window_route`` sends a call with 16-byte aligned
    operands (every case here) to: the TMA + wgmma one in bf16 with
    N <= 64 and d <= 64, else the first."""
    import torch

    return "wgmma" if dtype == torch.bfloat16 and n <= 64 and d <= 64 \
        else "first"


def window_fwd_bound(bw, n, c, h, nb_win):
    """q, k, v read and out written once (bf16), the f32 bias and the mask
    of ``nb_win`` windows (0 without); q k^T and p v."""
    return bound(2 * 4 * bw * n * c + 4 * (h + nb_win) * n * n,
                 4 * bw * n * n * c)


def swin_block_bound(bw, n, c, h, nb_win):
    """x read and out written once (bf16), the four matrices (bf16), the
    f32 vectors, the bias and the mask of ``nb_win`` windows (0 without);
    the four products and the attention's two."""
    m = bw * n
    nbytes = (2 * (2 * m * c + 12 * c * c) + 4 * 13 * c
              + 4 * (h + nb_win) * n * n)
    return bound(nbytes, 24 * m * c * c + 4 * m * n * c)


def swin_traffic_bound(bw, n, c, h, nb_win, x2_reads=3):
    """(ms, what bounds it) of swin_block's multi-launch form, whose
    intermediates cross device memory: x read three times (statistics,
    qkv, proj's shortcut); qkv, A and M1 written and read once (bf16); X2
    written once and read ``x2_reads`` times (f32: fc1, fc2 and, where
    proj does not take its statistics, their launch); the row statistics
    (f32 mean and rstd) written and read once each; out written once; the
    matrices, vectors, bias and mask once; the same operations as
    ``swin_block_bound``."""
    m, hid = bw * n, 4 * c
    nbytes = (2 * m * c * (3 + 2 * 3 + 2 + 1) + 4 * m * c * (1 + x2_reads)
              + 2 * 2 * m * hid + 4 * 8 * m + 2 * 12 * c * c + 4 * 13 * c
              + 4 * (h + nb_win) * n * n)
    return bound(nbytes, 24 * m * c * c + 4 * m * n * c)


def gemm_bodies(kernel, fn=None, events=None, wgmma=False) -> dict:
    """The body and tile width each GEMM of ``kernel`` (GEMM_PRODUCTS) ran
    on in calls of ``fn`` (or in the device ``events`` of such calls), read
    from the profiler's kernel names: "wgmma <BN>" for the TMA + wgmma body
    (``<product>_wgmma_kernel<BN>``), "mma.sync" or "FMA" for the tile
    bodies (``<product>_tile_kernel<T>``, bf16 or f32). With ``wgmma`` the
    phase fails unless every product ran the wgmma body."""
    if events is None:
        events = cold_device_events(fn, 1, need=[
            (product + "_",) for product in GEMM_PRODUCTS[kernel]])
    bodies = {}
    for product in GEMM_PRODUCTS[kernel]:
        found = set()
        for name, _ in events:
            hit = re.search(product + r"_(wgmma|tile)_kernel<(\w+)>", name)
            if hit:
                body, arg = hit.groups()
                found.add(f"wgmma {arg}" if body == "wgmma"
                          else "FMA" if arg == "float" else "mma.sync")
        check(len(found) == 1, f"{kernel}: the profile shows {sorted(found)} "
              f"for {product}")
        bodies[product.split("_", 1)[1]] = found.pop()
    if wgmma:
        check(all(b.startswith("wgmma") for b in bodies.values()),
              f"{kernel}: a product left the TMA + wgmma body: {bodies}")
    return bodies


def bodies_line(bodies) -> str:
    return "bodies (profiler) " + ", ".join(f"{product} {body}" for
                                            product, body in bodies.items())


def per_op_block(params, c, h, side, shifted, dtype):
    """A ``SwinTransformerBlock`` on the card holding the tensors of
    ``params``, and a call that runs it per op, as the model runs the blocks
    its gate declines: in training mode (all rates 0) the gate declines the
    block kernel, and under ``no_grad`` the attention takes ``window_mha``.
    Returns the call and the (B, side^2, C) tokens it takes."""
    import torch

    import tfimm_tpu_torch as tfm
    from tfimm_tpu_torch.architectures.swin import SwinTransformerBlock
    from tfimm_tpu_torch.core import Context

    ws = tfm.model_config(SWIN).window_size
    blk = SwinTransformerBlock(tfm.model_config(SWIN), (side, side), c, h,
                               0.0, ws // 2 if shifted else 0)
    blk = blk.to("cuda", dtype)
    with torch.no_grad():
        for dst, src in zip(
                (blk.norm1.weight, blk.norm1.bias, blk.attn.qkv.weight,
                 blk.attn.qkv.bias, blk.attn.proj.weight, blk.attn.proj.bias,
                 blk.norm2.weight, blk.norm2.bias, blk.mlp.fc1.weight,
                 blk.mlp.fc1.bias, blk.mlp.fc2.weight, blk.mlp.fc2.bias),
                params):
            dst.copy_(src)
    tokens = torch.randn(BATCH, side * side, c, device="cuda").to(dtype)

    def run():
        with Context(training=True), torch.no_grad():
            return blk(tokens)

    return run


def compare_paths(what, kernel, per_op):
    """Print the block kernel's time and the per-op block's, each as CUDA
    events around back-to-back calls, as device time and out of L2
    (``cold_ms``). Returns the per-op block's (back-to-back, out of L2)
    times."""
    times = {name: (cuda_time_ms(fn), device_ms(fn), cold_ms(fn))
             for name, fn in (("swin_block", kernel), ("per-op", per_op))}
    print(f"{what}: " + "; ".join(
        f"{name} {ev!r} ms between events, {dev!r} ms device, {cold!r} ms "
        f"out of L2" for name, (ev, dev, cold) in times.items())
        + " (per-op: cuBLAS, window_mha, eager LayerNorm)", flush=True)
    return times["per-op"][0], times["per-op"][2]


def phase_swin_kernels(reports, gpu_line):
    import torch
    import torch.nn.functional as F

    from tfimm_tpu_torch.ops.kernels.swin_block import (
        swin_block,
        swin_block_reference,
    )
    from tfimm_tpu_torch.ops.kernels.window_mha import (
        window_mha,
        window_mha_reference,
    )

    cases = ([(shape, shifted) for shape in SWIN_STAGES
              for shifted in (False, True)] + [(SWIN_STAGE4, False)]
             + [(shape, shape[4] > 0) for shape in SWIN_EDGES])
    worst = {"window_mha": 0.0, "swin_block": 0.0}
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[1]
        for i, ((bw, n, c, h, side), shifted) in enumerate(cases):
            x, qkv, params, bias, mask = swin_inputs(bw, n, c, h, side,
                                                     shifted, dtype, 500 + i)
            q, k, v = qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:]
            scale = (c // h) ** -0.5
            what = (f"{dname:8s} BW={bw} N={n} C={c} H={h}"
                    f"{' shifted' if mask is not None else ''}")
            outs = {}
            for name, kernel, plain, args in (
                    ("window_mha", window_mha, window_mha_reference,
                     (q, k, v, bias, mask)),
                    ("swin_block", swin_block, swin_block_reference,
                     (x, params, bias, mask))):
                got = kernel(*args, nb_heads=h, scale=scale)
                ref = plain(*args, nb_heads=h, scale=scale)
                torch.cuda.synchronize()
                err, bar, ok = held(got, ref, SWIN_TOL[name][dname])
                how = ""
                if name == "window_mha":
                    body = window_body(
                        lambda: kernel(*args, nb_heads=h, scale=scale))
                    want = window_body_expected(dtype, n, c // h)
                    how = f"; body {body}"
                    check(body == want, f"window_mha {what} ran the {body} "
                          f"body, expected the {want} one")
                if name == "swin_block":
                    how = "; " + bodies_line(gemm_bodies(
                        name, lambda: kernel(*args, nb_heads=h, scale=scale),
                        wgmma=dtype == torch.bfloat16))
                print(f"{name} {what}: max_abs_err={err!r} bar={bar!r} "
                      f"{'ok' if ok else 'FAIL'}{how}", flush=True)
                check(ok, f"{name} disagrees with its plain version ({what}): "
                      f"{err} > {bar}")
                if dtype == torch.bfloat16 and (bw, n, c, h, side) in (
                        SWIN_STAGES + [SWIN_STAGE4]):
                    worst[name] = max(worst[name], err)
                outs[name] = (got, bar)
            if dtype == torch.bfloat16 and mask is not None and i == 1:
                # Controls on the shifted stage-1 block: the plain versions
                # without the mask, and the attention without the bias, must
                # land far outside the bar.
                got, bar = outs["swin_block"]
                far = (got.float() - swin_block_reference(
                    x, params, bias, None, nb_heads=h, scale=scale).float())
                far = far.abs().max().item()
                print(f"swin_block control {what}: without the mask off by "
                      f"{far!r}, {far / bar!r} bars", flush=True)
                check(far > CONTROL_FACTOR * bar, "swin_block: leaving the "
                      "mask out stays within the bar")
                got, bar = outs["window_mha"]
                far = (got.float() - window_mha_reference(
                    q, k, v, torch.zeros_like(bias), mask, nb_heads=h,
                    scale=scale).float()).abs().max().item()
                print(f"window_mha control {what}: without the bias off by "
                      f"{far!r}, {far / bar!r} bars", flush=True)
                check(far > CONTROL_FACTOR * bar, "window_mha: leaving the "
                      "bias out stays within the bar")
            del x, qkv, q, k, v, params, bias, mask, outs, got, ref
    for name, err in worst.items():
        reports[name]["max_abs_err"] = err

    # window_mha where the main path runs it: inside swin_block at stages
    # 1-3 (one unshifted and one shifted block of each pair) and alone at
    # stage 4, each shape with its operands out of L2 (cold_ms) and back to
    # back, and summed over a request.
    report = reports["window_mha"]
    cases = [(shape, shifted, depth // 2)
             for shape, depth in zip(SWIN_STAGES, SWIN_DEPTHS)
             for shifted in (False, True)] + [(SWIN_STAGE4, False, 2)]
    stages = {}
    inside = dict.fromkeys(("cold_ms", "ms", "bound_ms"), 0.0)
    for (bw, n, c, h, side), shifted, launches in cases:
        _, qkv, _, bias, mask = swin_inputs(bw, n, c, h, side, shifted,
                                            torch.bfloat16, 600)
        q, k, v = qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:]
        scale = (c // h) ** -0.5

        def call():
            return window_mha(q, k, v, bias, mask, nb_heads=h, scale=scale)

        body = window_body(call)
        check(body == "wgmma", f"window_mha bf16 BW={bw} C={c} ran the "
              f"{body} body, expected the wgmma one")
        nb_win = 0 if mask is None else mask.shape[0]
        t = {"cold_ms": cold_ms(call), "ms": cuda_time_ms(call)}
        t["bound_ms"], by = window_fwd_bound(bw, n, c, h, nb_win)
        what = f"BW={bw} C={c} H={h}{' shifted' if shifted else ''}"
        print(f"window_mha bf16 {what}: out of L2 {t['cold_ms']!r} ms, "
              f"{t['bound_ms'] / t['cold_ms']!r} of the bound "
              f"{t['bound_ms']!r} ms ({by}); back to back {t['ms']!r} ms; "
              f"body {body}; {launches} launches a request", flush=True)
        stages[what] = t
        if (bw, n, c, h, side) != SWIN_STAGE4:
            for key in inside:
                inside[key] += launches * t[key]
        del qkv, q, k, v, bias, mask
    stage4 = stages[f"BW={SWIN_STAGE4[0]} C={SWIN_STAGE4[2]} "
                    f"H={SWIN_STAGE4[3]}"]
    request = {key: inside[key] + 2 * stage4[key] for key in inside}
    print(f"window_mha per {SWIN} bs{BATCH} request: inside swin_block (10 "
          f"launches) {inside['cold_ms']!r} ms out of L2, {inside['ms']!r} "
          f"back to back, bound {inside['bound_ms']!r}; with stage 4's 2 "
          f"{request['cold_ms']!r} / {request['ms']!r} ms, bound "
          f"{request['bound_ms']!r}; on {gpu_line}", flush=True)
    report["stages"] = {"per_shape": stages, "inside_swin_block": inside,
                        "request": request}

    # Stage 4 alone: the kernel out of L2, its device time, the plain
    # version and SDPA with the bias as a float mask.
    bw, n, c, h, side = SWIN_STAGE4
    _, qkv, _, bias, _ = swin_inputs(bw, n, c, h, side, False, torch.bfloat16,
                                     600)
    q, k, v = qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:]
    scale = (c // h) ** -0.5
    report["ms"] = stage4["cold_ms"]
    device = device_ms(
        lambda: window_mha(q, k, v, bias, nb_heads=h, scale=scale), steps=20)
    report["plain_ms"] = cuda_time_ms(
        lambda: window_mha_reference(q, k, v, bias, nb_heads=h, scale=scale))
    report["bound_ms"], report["bound_by"] = window_fwd_bound(bw, n, c, h, 0)
    qh, kh, vh = heads(qkv, h)
    attn_mask = bias.to(torch.bfloat16)[None]
    report["library_ms"] = cuda_time_ms(lambda: F.scaled_dot_product_attention(
        qh, kh, vh, attn_mask=attn_mask, scale=scale))
    report["library_cold_ms"] = cold_ms(lambda: F.scaled_dot_product_attention(
        qh, kh, vh, attn_mask=attn_mask, scale=scale))
    print(f"window_mha bf16 {SWIN_STAGE4[:4]}: kernel {report['ms']!r} ms "
          f"out of L2 ({device!r} ms device back to back), "
          f"plain {report['plain_ms']!r} ms, scaled_dot_product_attention "
          f"(float mask) {report['library_ms']!r} ms back to back, "
          f"{report['library_cold_ms']!r} out of L2, bound "
          f"{report['bound_ms']!r} ms ({report['bound_by']})", flush=True)
    del qkv, q, k, v, qh, kh, vh
    x, _, params, bias, _ = swin_inputs(bw, n, c, h, side, False,
                                        torch.bfloat16, 601)
    compare_paths(f"stage-4 block bf16 BW={bw} C={c} H={h}",
                  lambda: swin_block(x, params, bias, nb_heads=h, scale=scale),
                  per_op_block(params, c, h, side, False, torch.bfloat16))
    del x, params, bias

    # swin_block where the main path runs it: stages 1-3, per stage shape,
    # then per request (each stage's times its blocks, half of them shifted):
    # back to back (in L2) and out of L2 (cold_ms), each launch out of L2
    # by the profiler, the per-op block, the fused bound and the multi-launch
    # form's traffic bound, the cuBLAS floor of the products both ways.
    report = reports["swin_block"]
    keys = ("ms", "cold_ms", "plain_ms", "per_op_ms", "per_op_cold_ms",
            "cublas_floor_ms", "cublas_floor_cold_ms", "bound_ms",
            "traffic_bound_ms")
    totals = dict.fromkeys(keys, 0.0)
    launch_totals = {part: 0.0 for part, _ in CONVNEXT_LAUNCH_PARTS[
        "swin_block"]}
    stages = {}
    for (bw, n, c, h, side), depth in zip(SWIN_STAGES, SWIN_DEPTHS):
        m = bw * n
        tflop = (24 * m * c * c + 4 * m * n * c) / 1e12
        for shifted in (False, True):
            what = (f"swin_block bf16 BW={bw} C={c} H={h}"
                    f"{' shifted' if shifted else ''}")
            x, _, params, bias, mask = swin_inputs(bw, n, c, h, side, shifted,
                                                   torch.bfloat16, 700)
            scale = (c // h) ** -0.5

            def call():
                return swin_block(x, params, bias, mask, nb_heads=h,
                                  scale=scale)

            # What ran, from the profile: each product's body and width, and
            # whether X2's statistics took a launch of their own.
            events = cold_device_events(call, need=launch_keys(
                "swin_block", {SWIN_X2_STATS}))
            bodies = gemm_bodies("swin_block", events=events, wgmma=True)
            bodies["attention"] = ("wgmma" if any(
                "window_mha_wgmma_kernel" in name for name, _ in events)
                else "first")
            check(bodies["attention"] == "wgmma", f"{what}: the attention "
                  f"left the wgmma body")
            x2_launch = any(k in name for name, _ in events
                            for k in dict(CONVNEXT_LAUNCH_PARTS[
                                "swin_block"])[SWIN_X2_STATS])
            x2_reads = 3 if x2_launch else 2
            t = {"ms": cuda_time_ms(call), "cold_ms": cold_ms(call),
                 "plain_ms": cuda_time_ms(lambda: swin_block_reference(
                     x, params, bias, mask, nb_heads=h, scale=scale), iters=5)}
            nb_win = 0 if mask is None else mask.shape[0]
            t["bound_ms"], by = swin_block_bound(bw, n, c, h, nb_win)
            t["traffic_bound_ms"], tby = swin_traffic_bound(bw, n, c, h,
                                                            nb_win, x2_reads)
            for key, name in (("ms", "kernel back to back"),
                              ("cold_ms", "kernel out of L2"),
                              ("plain_ms", "plain")):
                print(f"{what}: {name} {t[key]!r} ms, "
                      f"{tflop / (t[key] / 1e3)!r} TFLOP/s, "
                      f"{t['bound_ms'] / t[key]!r} of the bound "
                      f"{t['bound_ms']!r} ms ({by}), "
                      f"{t['traffic_bound_ms'] / t[key]!r} of the multi-launch "
                      f"form's bound {t['traffic_bound_ms']!r} ms ({tby}; X2 "
                      f"read {x2_reads} times)",
                      flush=True)
            print(f"{what}: {bodies_line(bodies)}", flush=True)
            parts = cold_launch_parts(
                call, "swin_block", events=events,
                skip=set() if x2_launch else {SWIN_X2_STATS})
            for part, ms in parts.items():
                print(f"{what}: launch {part} {ms!r} ms out of L2 (profiler)",
                      flush=True)
                launch_totals[part] += depth // 2 * ms
            t["per_op_ms"], t["per_op_cold_ms"] = compare_paths(
                what, call, per_op_block(params, c, h, side, shifted,
                                         torch.bfloat16))
            for key in ("ms", "cold_ms", "plain_ms", "per_op_ms",
                        "per_op_cold_ms", "bound_ms", "traffic_bound_ms"):
                totals[key] += depth // 2 * t[key]
            stages[what] = {k: t[k] for k in ("ms", "cold_ms", "per_op_ms",
                                               "per_op_cold_ms")}
        w_qkv, w_proj, w1, w2 = params.w_qkv, params.w_proj, params.w1, params.w2
        h1 = torch.randn(m, c, device="cuda").to(torch.bfloat16)
        mid = torch.randn(m, 4 * c, device="cuda").to(torch.bfloat16)
        products = ((h1, w_qkv), (h1, w_proj), (h1, w1), (mid, w2))
        floor = sum(cuda_time_ms(lambda a=a, w=w: F.linear(a, w))
                    for a, w in products)
        floor_cold = sum(cold_ms(lambda a=a, w=w: F.linear(a, w))
                         for a, w in products)
        print(f"swin_block bf16 BW={bw} C={c}: cuBLAS floor (four F.linear) "
              f"{floor!r} ms back to back, {floor_cold!r} ms out of L2, "
              f"{24 * m * c * c / 1e12 / (floor / 1e3)!r} TFLOP/s; {depth} "
              f"blocks a request", flush=True)
        totals["cublas_floor_ms"] += depth * floor
        totals["cublas_floor_cold_ms"] += depth * floor_cold
        del x, params, bias, mask, h1, mid, products
    report.update(totals)
    report["bound_by"] = "operations"
    report["library_ms"] = totals["cublas_floor_ms"]
    report["launch_cold_ms"] = launch_totals
    report["stages"] = stages
    print(f"swin_block per {SWIN} bs{BATCH} request ({sum(SWIN_DEPTHS)} calls): "
          f"kernel {totals['ms']!r} ms back to back, {totals['cold_ms']!r} ms "
          f"out of L2; per-op block {totals['per_op_ms']!r} / "
          f"{totals['per_op_cold_ms']!r} ms; plain {totals['plain_ms']!r} ms; "
          f"cuBLAS floor {totals['cublas_floor_ms']!r} / "
          f"{totals['cublas_floor_cold_ms']!r} ms; bound "
          f"{totals['bound_ms']!r} ms (operations); the multi-launch form's "
          f"bound {totals['traffic_bound_ms']!r} ms", flush=True)
    for part, ms in launch_totals.items():
        print(f"swin_block per {SWIN} bs{BATCH} request: launch {part} "
              f"{ms!r} ms out of L2 (profiler)", flush=True)


def phase_swin_slice(reports, gpu_line):
    import torch

    import tfimm_tpu_torch as tfm
    from tfimm_tpu_torch.ops.kernels import dispatch

    model = tfm.create_model(SWIN, device="cuda", dtype=torch.bfloat16, seed=0)
    sd = seeded_state_dict(model, seed=4, std=0.05)
    model.load_state_dict(sd)
    pp = tfm.create_preprocessing(SWIN, dtype=torch.bfloat16, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(5)
    requests = [torch.randint(0, 256, (BATCH, 224, 224, 3), generator=g,
                              device="cuda", dtype=torch.uint8)
                for _ in range(REQUESTS)]
    torch.cuda.synchronize()

    dispatch.reset_launch_counts()
    seconds, outputs = [], []
    for img in requests:
        before = dict(dispatch.launch_counts)
        t0 = time.perf_counter()
        logits = model.predict(pp(img))
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        rose = {k: dispatch.launch_counts[k] - before[k] for k in before}
        check(rose == expected(**SWIN_LAUNCHES),
              f"one Swin request launched {rose}, expected {SWIN_LAUNCHES} "
              f"and nothing else")
        check(tuple(logits.shape) == (BATCH, model.cfg.nb_classes),
              f"logits shape {tuple(logits.shape)}")
        check(bool(torch.isfinite(logits).all()), "non-finite logits")
        check(bool(logits.abs().max() > 0), "all-zero logits")
        outputs.append(logits)
    for name, report in reports.items():
        report["launches_by_path"]["serve_swin"] = dispatch.launch_counts[name]
    img_s = [BATCH / s for s in seconds[1:]]
    request_ms = statistics.median(seconds[1:]) * 1e3
    print(f"slice {SWIN} bs{BATCH} bf16: request seconds {seconds!r}",
          flush=True)
    print(f"slice {SWIN} bs{BATCH} bf16: {statistics.median(img_s)!r} img/s "
          f"(median of requests 2-{REQUESTS}; range {min(img_s)!r}-"
          f"{max(img_s)!r}) on {gpu_line}", flush=True)

    # The same weights in f32 on the CPU, where every kernel wrapper runs
    # its plain version and launches nothing.
    x = requests[0][:CONVNEXT_CHECK_IMAGES]
    with torch.inference_mode():
        feats = model.forward(pp(x), features_only=True)
    model32 = tfm.create_model(SWIN, device="cpu", dtype=torch.float32,
                               seed=0)
    model32.load_state_dict(sd)
    pp32 = tfm.create_preprocessing(SWIN, dtype=torch.float32, device="cpu")
    before = dict(dispatch.launch_counts)
    with torch.inference_mode():
        ref_logits, ref_feats = model32(pp32(x.cpu()), return_features=True)
    check(dispatch.launch_counts == before,
          "the f32 CPU reference launched a kernel")
    for name, got, want in (
            ("forward_features", feats, ref_feats["features"]),
            ("logits", outputs[0][:CONVNEXT_CHECK_IMAGES], ref_logits)):
        got = got.float().cpu()
        rel = ((got - want).abs().max() / want.abs().max()).item()
        print(f"slice {SWIN} {name}: bf16 kernel path vs f32 plain path on "
              f"the CPU rel err {rel!r} (bar 5e-2)", flush=True)
        check(rel < 5e-2, f"{SWIN} {name} rel err {rel} >= 5e-2")
    del model32, ref_logits, ref_feats

    img = requests[1]
    wall_ms, groups, names = device_split(lambda: model.predict(pp(img)),
                                          steps=2)
    busy_ms = sum(groups.values())
    print(f"{SWIN} request profile: device busy {busy_ms!r} ms per request; "
          f"wall {wall_ms!r} ms under the profiler, {request_ms!r} ms without; "
          f"device idle share {1.0 - busy_ms / request_ms!r}", flush=True)
    for group, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"{SWIN} request profile: {group}: {ms!r} ms per request",
              flush=True)
    for name, ms in sorted(names.items(), key=lambda kv: -kv[1])[:12]:
        print(f"{SWIN} request profile kernel: {ms!r} ms {name[:150]}",
              flush=True)
    print_launch_parts(SWIN, names, "swin_block")


def window_bwd_inputs(bw, n, c, h, side, shifted, dtype, seed):
    """Seeded inputs of ``window_mha_bwd`` on the card: a packed qkv and g
    normal, a bias (H, N, N) of std 0.5 and, for a shifted block on a map
    of more than one window, the model's shift mask."""
    import torch

    from tfimm_tpu_torch.architectures.swin import _attention_mask

    g = torch.Generator(device="cuda").manual_seed(seed)
    ws = math.isqrt(n)
    mask = None
    if shifted and side > ws:
        mask = torch.from_numpy(_attention_mask((side, side), ws, ws // 2))
        mask = mask.to("cuda")
    return (torch.randn(bw, n, 3 * c, generator=g, device="cuda").to(dtype),
            torch.randn(bw, n, c, generator=g, device="cuda").to(dtype),
            0.5 * torch.randn(h, n, n, generator=g, device="cuda"), mask)


def window_bwd_plain(qkv, g, bias, mask, h, scale):
    """The plain backward as (dq, dk, dv, dbias)."""
    from tfimm_tpu_torch.ops.kernels.window_mha import window_mha_bwd_reference

    c = qkv.shape[-1] // 3
    return window_mha_bwd_reference(qkv[..., :c], qkv[..., c:2 * c],
                                    qkv[..., 2 * c:], bias, mask, g,
                                    nb_heads=h, scale=scale)


def window_bwd_bound(bw, n, c, h, nb_win):
    """q, k, v, g read and dq, dk, dv written once (bf16), the f32 bias, the
    mask of ``nb_win`` windows (0 without) and dbias; five products of
    2 BW H N^2 d operations."""
    nbytes = 2 * 7 * bw * n * c + 4 * (2 * h + nb_win) * n * n
    return bound(nbytes, 10 * bw * n * n * c)


def sdpa_backward_ms(qkv, g, bias, mask, h, scale):
    """(ms, backend) of the backward alone of
    ``F.scaled_dot_product_attention`` with the bias (plus the mask) as a
    float mask that requires grad: dq, dk, dv and the bias's gradient, summed
    over the windows by the broadcast's backward. The first SDPA backend
    (memory-efficient, then math) that returns a mask gradient is timed."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    bw, n, _ = qkv.shape
    q, k, v = [t.requires_grad_() for t in heads(qkv, h)]
    gh = g.reshape(bw, n, h, -1).transpose(1, 2).contiguous()
    leaf = bias.clone().requires_grad_()
    failures = []
    for backend in (SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel(backend):
                m = leaf.to(qkv.dtype)[None]
                if mask is not None:
                    nb_win = mask.shape[0]
                    m = (m[None] + mask.to(qkv.dtype)[None, :, None]).expand(
                        bw // nb_win, nb_win, h, n, n).reshape(bw, h, n, n)
                out = F.scaled_dot_product_attention(q, k, v, attn_mask=m,
                                                     scale=scale)
                grads = torch.autograd.grad(out, (q, k, v, leaf), gh,
                                            retain_graph=True)
                check(grads[3] is not None, "no mask gradient")
                return cuda_time_ms(lambda: torch.autograd.grad(
                    out, (q, k, v, leaf), gh, retain_graph=True),
                    iters=10), backend.name
        except (RuntimeError, SmokeFailure) as e:
            failures.append(f"{backend.name}: {str(e).splitlines()[0][:120]}")
    print(f"window_mha_bwd: no SDPA backend gave a mask gradient: {failures}",
          flush=True)
    return None, None


def phase_window_bwd_kernel(report, gpu_line):
    import torch

    from tfimm_tpu_torch.ops.kernels.window_mha import window_mha_bwd

    cases = ([(shape, shifted) for shape in SWIN_TRAIN_STAGES[:3]
              for shifted in (False, True)] + [(SWIN_TRAIN_STAGES[3], False)]
             + [(shape, shape[4] > 0) for shape in SWIN_EDGES])
    names = ("dq", "dk", "dv", "dbias")
    worst = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[1]
        tol = WINDOW_BWD_TOL[dname]
        for i, ((bw, n, c, h, side), shifted) in enumerate(cases):
            qkv, g, bias, mask = window_bwd_inputs(bw, n, c, h, side, shifted,
                                                   dtype, 800 + i)
            scale = (c // h) ** -0.5
            what = (f"{dname:8s} BW={bw} N={n} C={c} H={h}"
                    f"{' shifted' if mask is not None else ''}")
            dqkv, dbias = window_mha_bwd(qkv, g, bias, mask, nb_heads=h,
                                         scale=scale)
            got = (dqkv[..., :c], dqkv[..., c:2 * c], dqkv[..., 2 * c:], dbias)
            ref = window_bwd_plain(qkv, g, bias, mask, h, scale)
            torch.cuda.synchronize()
            body = window_body(lambda: window_mha_bwd(
                qkv, g, bias, mask, nb_heads=h, scale=scale), bwd=True)
            want = window_body_expected(dtype, n, c // h)
            print(f"window_mha_bwd {what}: body {body}", flush=True)
            check(body == want, f"window_mha_bwd {what} ran the {body} body, "
                  f"expected the {want} one")
            bars = []
            for name, a, b in zip(names, got, ref):
                err, bar, ok = held(a, b, tol)
                bars.append(bar)
                print(f"window_mha_bwd {what} {name}: max_abs_err={err!r} "
                      f"bar={bar!r} {'ok' if ok else 'FAIL'}", flush=True)
                check(ok, f"window_mha_bwd {name} disagrees with its plain "
                      f"version ({what}): {err} > {bar}")
                if dtype == torch.bfloat16 and (bw, n, c, h, side) in \
                        SWIN_TRAIN_STAGES:
                    worst = max(worst, err)
            if dtype == torch.bfloat16 and i == 1:
                # Controls on the shifted stage-1 input.
                no_mask = window_bwd_plain(qkv, g, bias, None, h, scale)
                far = (dbias - no_mask[3]).abs().max().item()
                print(f"window_mha_bwd control {what}: dbias without the mask "
                      f"off by {far!r}, {far / bars[3]!r} bars", flush=True)
                check(far > CONTROL_FACTOR * bars[3], "window_mha_bwd: "
                      "leaving the mask out of dbias stays within the bar")
                no_bias = window_bwd_plain(qkv, g, torch.zeros_like(bias),
                                           mask, h, scale)
                misses = [(a.float() - b.float()).abs().max().item() / bar
                          for a, b, bar in zip(got, no_bias, bars)]
                print(f"window_mha_bwd control {what}: without the bias "
                      f"{dict(zip(names, misses))} bars off", flush=True)
                check(max(misses[:3]) > CONTROL_FACTOR, "window_mha_bwd: "
                      "leaving the bias out stays within the bar")
                again = window_mha_bwd(qkv, g, bias, mask, nb_heads=h,
                                       scale=scale)
                same = (torch.equal(again[1], dbias)
                        and torch.equal(again[0], dqkv))
                print(f"window_mha_bwd {what}: a second call gives a "
                      f"bit-identical dbias and dqkv: {same}", flush=True)
                check(same, "window_mha_bwd is not deterministic")
                del no_mask, no_bias, again
            del qkv, g, bias, mask, dqkv, dbias, got, ref
    report["max_abs_err"] = worst

    # Per stage shape, then per training step (each stage's times its
    # blocks, half of those of stages 1-3 shifted): the kernel out of L2
    # (cold_ms) and as profiler device time back to back.
    keys = ("ms", "device_ms", "plain_ms", "bound_ms", "library_ms")
    totals = dict.fromkeys(keys, 0.0)
    bound_by, backends = {}, set()
    for (bw, n, c, h, side), depth in zip(SWIN_TRAIN_STAGES,
                                          SWIN_TRAIN_DEPTHS):
        shifts = (False, True) if side > math.isqrt(n) else (False,)
        for shifted in shifts:
            qkv, g, bias, mask = window_bwd_inputs(
                bw, n, c, h, side, shifted, torch.bfloat16, 900)
            scale = (c // h) ** -0.5

            def kernel():
                return window_mha_bwd(qkv, g, bias, mask, nb_heads=h,
                                      scale=scale)

            events_ms = cuda_time_ms(kernel)
            t = {"ms": cold_ms(kernel), "device_ms": device_ms(kernel, steps=20),
                 "plain_ms": cuda_time_ms(
                     lambda: window_bwd_plain(qkv, g, bias, mask, h, scale),
                     iters=5)}
            nb_win = 0 if mask is None else mask.shape[0]
            t["bound_ms"], by = window_bwd_bound(bw, n, c, h, nb_win)
            t["library_ms"], backend = sdpa_backward_ms(qkv, g, bias, mask,
                                                        h, scale)
            backends.add(backend)
            blocks = depth // len(shifts)
            bound_by[by] = bound_by.get(by, 0.0) + blocks * t["bound_ms"]
            print(f"window_mha_bwd bf16 BW={bw} C={c} H={h}"
                  f"{' shifted' if mask is not None else ''}: kernel "
                  f"{t['ms']!r} ms out of L2, {t['device_ms']!r} ms device "
                  f"back to back ({events_ms!r} ms between events), "
                  f"{t['bound_ms'] / t['ms']!r} of the bound "
                  f"{t['bound_ms']!r} ms ({by}); plain {t['plain_ms']!r} ms; "
                  f"scaled_dot_product_attention backward ({backend}) "
                  f"{t['library_ms']!r} ms; {blocks} blocks a step; on "
                  f"{gpu_line}", flush=True)
            for key in keys:
                if t[key] is None or totals[key] is None:
                    totals[key] = None
                else:
                    totals[key] += blocks * t[key]
            del qkv, g, bias, mask
    report.update(totals)
    report["bound_by"] = max(bound_by, key=bound_by.get)
    print(f"window_mha_bwd per {SWIN} bs{SWIN_TRAIN_BATCH} training step "
          f"({sum(SWIN_TRAIN_DEPTHS)} calls): kernel {totals['ms']!r} ms "
          f"out of L2, {totals['device_ms']!r} ms device back to back, "
          f"plain {totals['plain_ms']!r} ms, SDPA backward "
          f"({'/'.join(map(str, sorted(backends, key=str)))}) "
          f"{totals['library_ms']!r} ms, bound {totals['bound_ms']!r} ms "
          f"({report['bound_by']}) on {gpu_line}", flush=True)


def swin_train_config() -> dict:
    """Swin-T at batch 64 with the Swin paper's ImageNet-1K recipe (AdamW at
    weight decay 0.05, label smoothing 0.1, mixup 0.8, cutmix 1.0, drop path
    0.2), bf16 mixed precision, lr 1e-3, 6 epochs of one step each on the
    same 64 synthetic images."""
    data = {"batch_size": SWIN_TRAIN_BATCH, "nb_samples": SWIN_TRAIN_BATCH,
            "input_size": (224, 224), "nb_classes": 1000, "seed": 0}
    return {
        "trainer_class": "Trainer",
        "trainer": {"validation_before_training": False,
                    "display_loss_every_it": 1},
        "problem_class": "ClassificationProblem",
        "problem": {"model_class": "ModelFactory",
                    "model": {"model_name": SWIN, "drop_path_rate": 0.2},
                    "optimizer_class": "OptimizerFactory",
                    "optimizer": {"optimizer": "adamw", "weight_decay": 0.05,
                                  "lr_schedule_class": "LRConstFactory",
                                  "lr_schedule": {"lr": 1e-3}},
                    "mixed_precision": True, "label_smoothing": 0.1,
                    "mixup_alpha": 0.8, "cutmix_alpha": 1.0},
        "train_dataset_class": "SyntheticDataset", "train_dataset": data,
        "timekeeping_class": "Timekeeping",
        "timekeeping": {"nb_epochs": TRAIN_STEPS,
                        "batch_size": SWIN_TRAIN_BATCH,
                        "nb_samples_per_epoch": SWIN_TRAIN_BATCH},
        "device": "cuda",
    }


def phase_swin_train(reports, gpu_line):
    import torch

    import tfimm_tpu_torch as tfm
    from tfimm_tpu_torch.ops.kernels import dispatch
    from tfimm_tpu_torch.parallel.step import cross_entropy_loss
    from tfimm_tpu_torch.utils.profile import time_model

    trainer, steps, counts = run_watched(swin_train_config())
    problem = trainer.problem
    check(len(steps) == TRAIN_STEPS, f"{len(steps)} Swin training steps, "
          f"expected {TRAIN_STEPS}")
    for it, (loss, seconds, rose) in enumerate(steps):
        print(f"swin train step {it}: loss {loss!r}, {seconds!r} s, launches "
              f"{rose}", flush=True)
        check(rose == expected(**SWIN_TRAIN_LAUNCHES),
              f"Swin step {it} launched {rose}, expected "
              f"{SWIN_TRAIN_LAUNCHES} and nothing else")
        check(math.isfinite(loss), f"Swin step {it}: loss {loss}")
    losses = [loss for loss, _, _ in steps]
    # Mixup and cutmix change the targets every step, so one step's loss
    # may rise; the mean of the last two must lie below the first.
    last = (losses[-1] + losses[-2]) / 2
    print(f"swin train loss: first {losses[0]!r}, mean of the last two "
          f"{last!r}", flush=True)
    check(last < losses[0], f"the Swin loss did not fall: {losses}")
    for name, report in reports.items():
        report["launches_by_path"]["train_swin"] = counts[name]
    timed = [s for _, s, _ in steps[1:]]
    step_s = sum(timed) / len(timed)
    print(f"train {SWIN} bs{SWIN_TRAIN_BATCH} bf16 mixed precision adamw "
          f"mixup/cutmix: {SWIN_TRAIN_BATCH * len(timed) / sum(timed)!r} img/s "
          f"({len(timed)} steps 2-{TRAIN_STEPS} in {sum(timed) * 1e3!r} ms; "
          f"median step {statistics.median(timed) * 1e3!r} ms, slowest "
          f"{max(timed) * 1e3!r} ms) on {gpu_line}", flush=True)

    # One step's loss and gradients with seeded weights, no mixup, in eval
    # mode (drop path off): bf16 through the kernels on the card against
    # f32 through the plain versions on the CPU.
    model, pp = problem.model, problem.preprocessing
    sd = seeded_state_dict(model, seed=6, std=0.05)
    model.load_state_dict(sd)
    model.eval()
    images, labels = next(iter(trainer.train_ds))
    images = torch.as_tensor(images[:SWIN_CHECK_IMAGES])
    labels = torch.as_tensor(labels[:SWIN_CHECK_IMAGES])
    names = ("layers.0.blocks.1.attn.relative_position_bias_table",
             "layers.0.blocks.0.attn.qkv.weight")

    def loss_and_grads(m, x, y):
        m.zero_grad(set_to_none=True)
        before = dict(dispatch.launch_counts)
        loss = cross_entropy_loss(m(x).float(), y)
        loss.backward()
        rose = {k: dispatch.launch_counts[k] - before[k] for k in before}
        params = dict(m.named_parameters())
        return loss.item(), {n: params[n].grad.float().cpu() for n in names}, rose

    loss_k, grads_k, rose = loss_and_grads(
        model, pp(images.to("cuda")).to(torch.bfloat16), labels.to("cuda"))
    check(rose == expected(**SWIN_TRAIN_LAUNCHES),
          f"the bf16 Swin step launched {rose}")
    model32 = tfm.create_model(SWIN, device="cpu", dtype=torch.float32, seed=0)
    model32.load_state_dict(sd)
    model32.eval()
    pp32 = tfm.create_preprocessing(SWIN, dtype=torch.float32, device="cpu")
    loss_r, grads_r, rose = loss_and_grads(model32, pp32(images), labels)
    check(rose == expected(), f"the f32 CPU reference launched {rose}")
    rel = abs(loss_k - loss_r) / abs(loss_r)
    print(f"swin train loss: bf16 kernel path {loss_k!r} vs f32 plain path on "
          f"the CPU {loss_r!r}, rel err {rel!r} (bar 2e-2)", flush=True)
    check(rel < 2e-2, f"Swin loss rel err {rel} >= 2e-2")
    for name in names:
        ref = grads_r[name]
        rel = ((grads_k[name] - ref).abs().max() / ref.abs().max()).item()
        print(f"swin train grad {name}: max|diff| / max|ref| {rel!r} "
              f"(bar 1e-1)", flush=True)
        check(rel < 1e-1, f"{name} gradient rel err {rel} >= 1e-1")
        check(ref.abs().max().item() > 0, f"{name}: zero reference gradient")
    del model32, grads_r

    batch = next(iter(trainer.train_ds))
    wall_ms, groups, kernel_names = device_split(
        lambda: problem.train_step(batch, 0))
    busy_ms = sum(groups.values())
    print(f"swin train step profile: device busy {busy_ms!r} ms per step; wall "
          f"{wall_ms!r} ms under the profiler, {step_s * 1e3!r} ms without; "
          f"device idle share {1.0 - busy_ms / (step_s * 1e3)!r}", flush=True)
    for group, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"swin train step profile: {group}: {ms!r} ms per step",
              flush=True)
    for name, ms in sorted(kernel_names.items(), key=lambda kv: -kv[1])[:15]:
        print(f"swin train step profile kernel: {ms!r} ms {name[:150]}",
              flush=True)

    img_s = time_model(SWIN, target="backprop", batch_size=SWIN_TRAIN_BATCH,
                       samples=3)
    print(f"time_model {SWIN} backprop bs{SWIN_TRAIN_BATCH} bf16: {img_s!r} "
          f"img/s on {gpu_line}", flush=True)


def cait_inputs(b, n, h, d, dtype, seed):
    """Seeded inputs of the talking-head kernels on the card: qkv and g
    normal, the (H, H) mixes random (std 0.5, not symmetric), b_l of unit
    size (the softmax ignores it) and b_w of std 0.02: a larger b_w makes
    its term b_w[h] colsum(v_h), a sum over N keys, dwarf the attention, and
    the bar, relative to the largest value, would then hide a wrong mix."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * scale

    return (rnd(b, n, 3 * h * d).to(dtype), rnd(h, h, scale=0.5), rnd(h),
            rnd(h, h, scale=0.5), rnd(h, scale=0.02),
            rnd(b, n, h * d).to(dtype))


def cait_bound(b, n, h, d, backward=False):
    """bf16 qkv (and g) read and out (dqkv) written once; the per-head
    products (2 forward, 5 backward, of 2 B H N^2 d operations each) and
    the two (H, H) mixes of every entry (2 B N^2 H^2 each)."""
    dim = h * d
    if backward:
        return bound(2 * 7 * b * n * dim, 10 * b * h * n * n * d
                     + 4 * b * n * n * h * h)
    return bound(2 * 4 * b * n * dim, 4 * b * h * n * n * d
                 + 4 * b * n * n * h * h)


def cait_floor_ms(qkv, g, h, backward=False):
    """The batched cuBLAS products of the same attention without the mixes,
    over (B H, N, d): q k^T and p v, and for the backward q k^T, g v^T,
    p^T g, ds k and ds^T q."""
    import torch

    b, n, three_d = qkv.shape
    q, k, v = [t.reshape(b * h, n, -1) for t in heads(qkv, h)]
    p = torch.randn(b * h, n, n, device="cuda").to(qkv.dtype)
    if not backward:
        return (cuda_time_ms(lambda: torch.matmul(q, k.transpose(1, 2)))
                + cuda_time_ms(lambda: torch.matmul(p, v)))
    gh = g.reshape(b, n, h, -1).transpose(1, 2).reshape(b * h, n, -1)
    return (cuda_time_ms(lambda: torch.matmul(q, k.transpose(1, 2)))
            + cuda_time_ms(lambda: torch.matmul(gh, v.transpose(1, 2)))
            + cuda_time_ms(lambda: torch.matmul(p.transpose(1, 2), gh))
            + cuda_time_ms(lambda: torch.matmul(p, k))
            + cuda_time_ms(lambda: torch.matmul(p.transpose(1, 2), q)))


def cait_body(nb_heads, *operands) -> str:
    """Which body of the talking-head kernels takes these operands
    (``tma.cait_route``)."""
    import torch

    from tfimm_tpu_torch.ops.kernels.tma import cait_route

    if cait_route(nb_heads, *operands):
        return "Hopper body: TMA + wgmma"
    if operands[0].dtype == torch.bfloat16:
        return "first design: mma.sync"
    return "f32 FMA body"


def check_hopper_body(what, events, keys) -> None:
    """Check that a profile's device ``events`` (name, ms; never empty, as
    ``cold_device_events`` gives them) hold every launch named by ``keys``
    (the Hopper body's kernels), and print them."""
    names = sorted({name[:90] for name, _ in events})
    print(f"{what} cait_s24 launches out of L2: {names}", flush=True)
    check(all(any(key in name for name in names) for key in keys),
          f"{what}: cait_s24 did not run the Hopper body: {names}")


def host_ms_per_call(what, fn) -> float:
    """Host ms of one call of ``fn``: the median of
    ``scripts/perf/torch_bwd_host_time.py · host_ms`` (calls in a row behind
    a sleep kernel). The phase fails if the card caught up with the host in
    any round, for then the calls waited for the card."""
    import importlib.util

    path = REPO / "scripts" / "perf" / "torch_bwd_host_time.py"
    spec = importlib.util.spec_from_file_location("torch_bwd_host_time", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    timed = module.host_ms(fn)
    print(f"{what}: the wrapper's host time {timed}", flush=True)
    check(timed["rounds_the_card_caught_up"] == 0, f"{what}: the card caught "
          f"up with the host while the wrapper's host time was taken")
    return timed["host_ms"]


def phase_cait_kernel(report, gpu_line):
    import torch

    from tfimm_tpu_torch.ops.kernels.cait_attention import (
        talking_head_attention,
        talking_head_attention_reference,
    )

    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[1]
        for i, (b, n, h, d) in enumerate(CAIT_SHAPES):
            qkv, wl, bl, ww, bw, _ = cait_inputs(b, n, h, d, dtype, 1100 + i)
            scale = d ** -0.5
            what = (f"{dname:8s} B={b} N={n} H={h} d={d} "
                    f"({cait_body(h, qkv)})")
            got = talking_head_attention(qkv, wl, bl, ww, bw, nb_heads=h,
                                         scale=scale)
            ref = talking_head_attention_reference(qkv, wl, bl, ww, bw,
                                                   nb_heads=h, scale=scale)
            torch.cuda.synchronize()
            err, bar, ok = held(got, ref, CAIT_TOL[dname])
            print(f"talking_head_attention {what}: max_abs_err={err!r} "
                  f"bar={bar!r} {'ok' if ok else 'FAIL'}", flush=True)
            check(ok, f"talking_head_attention disagrees with its plain "
                  f"version ({what}): {err} > {bar}")
            if dtype == torch.bfloat16 and i == 0:
                report["max_abs_err"] = err
                # Controls: the plain version without the pre-softmax mix,
                # and with w_w transposed, must miss the bar by far.
                eye = torch.eye(h, device="cuda")
                for name, args in (
                        ("without the pre-softmax mix",
                         (qkv, eye, torch.zeros_like(bl), ww, bw)),
                        ("with w_w transposed", (qkv, wl, bl, ww.t(), bw))):
                    far = (got.float() - talking_head_attention_reference(
                        *args, nb_heads=h, scale=scale).float())
                    far = far.abs().max().item()
                    print(f"talking_head_attention control {what}: {name} "
                          f"off by {far!r}, {far / bar!r} bars", flush=True)
                    check(far > CONTROL_FACTOR * bar, f"talking_head_attention:"
                          f" the plain version {name} stays within the bar")
            del qkv, got, ref

    b, n, h, d = CAIT_SHAPES[0]
    qkv, wl, bl, ww, bw, _ = cait_inputs(b, n, h, d, torch.bfloat16, 1200)
    scale = d ** -0.5

    def call():
        return talking_head_attention(qkv, wl, bl, ww, bw, nb_heads=h,
                                      scale=scale)

    report["cold_ms"] = report["ms"] = cold_ms(call)
    report["warm_ms"] = cuda_time_ms(call)
    report["host_ms"] = host_ms_per_call("talking_head_attention", call)
    check_hopper_body("talking_head_attention",
                      cold_device_events(call,
                                         need=[("talking_head_fwd_wgmma",)]),
                      ("talking_head_fwd_wgmma",))
    report["plain_ms"] = cuda_time_ms(lambda: talking_head_attention_reference(
        qkv, wl, bl, ww, bw, nb_heads=h, scale=scale), iters=5)
    report["bound_ms"], report["bound_by"] = cait_bound(b, n, h, d)
    report["library_ms"] = None   # no one PyTorch call mixes heads
    report["cublas_floor_ms"] = cait_floor_ms(qkv, None, h)
    print(f"talking_head_attention bf16 {CAIT_SHAPES[0]} "
          f"({cait_body(h, qkv)}): kernel out of L2 {report['cold_ms']!r} ms, "
          f"{report['bound_ms'] / report['cold_ms']!r} of the bound "
          f"{report['bound_ms']!r} ms ({report['bound_by']}); back to back "
          f"{report['warm_ms']!r} ms; the wrapper's host time "
          f"{report['host_ms']!r} ms a call; plain {report['plain_ms']!r} ms; "
          f"cuBLAS floor (batched q k^T and p v alone) "
          f"{report['cublas_floor_ms']!r} ms; on {gpu_line}", flush=True)


def phase_cait_slice(reports, gpu_line):
    import torch

    import tfimm_tpu_torch as tfm
    from tfimm_tpu_torch.ops.kernels import dispatch

    model = tfm.create_model(CAIT, device="cuda", dtype=torch.bfloat16, seed=0)
    sd = seeded_state_dict(model, seed=7, std=0.05)
    model.load_state_dict(sd)
    pp = tfm.create_preprocessing(CAIT, dtype=torch.bfloat16, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(8)
    requests = [torch.randint(0, 256, (BATCH, 224, 224, 3), generator=g,
                              device="cuda", dtype=torch.uint8)
                for _ in range(REQUESTS)]
    torch.cuda.synchronize()

    dispatch.reset_launch_counts()
    seconds, outputs = [], []
    for img in requests:
        before = dict(dispatch.launch_counts)
        t0 = time.perf_counter()
        logits = model.predict(pp(img))
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        rose = {k: dispatch.launch_counts[k] - before[k] for k in before}
        check(rose == expected(**CAIT_LAUNCHES),
              f"one CaiT request launched {rose}, expected {CAIT_LAUNCHES} "
              f"and nothing else")
        check(tuple(logits.shape) == (BATCH, model.cfg.nb_classes),
              f"logits shape {tuple(logits.shape)}")
        check(bool(torch.isfinite(logits).all()), "non-finite logits")
        check(bool(logits.abs().max() > 0), "all-zero logits")
        outputs.append(logits)
    for name, report in reports.items():
        report["launches_by_path"]["serve_cait"] = dispatch.launch_counts[name]
    img_s = [BATCH / s for s in seconds[1:]]
    request_ms = statistics.median(seconds[1:]) * 1e3
    print(f"slice {CAIT} bs{BATCH} bf16: request seconds {seconds!r}",
          flush=True)
    print(f"slice {CAIT} bs{BATCH} bf16: {statistics.median(img_s)!r} img/s "
          f"(median of requests 2-{REQUESTS}; range {min(img_s)!r}-"
          f"{max(img_s)!r}) on {gpu_line}", flush=True)

    # The same weights in f32 on the CPU, where the kernel wrapper runs its
    # plain version and launches nothing.
    x = requests[0][:CAIT_CHECK_IMAGES]
    with torch.inference_mode():
        feats = model.forward(pp(x), features_only=True)
    model32 = tfm.create_model(CAIT, device="cpu", dtype=torch.float32, seed=0)
    model32.load_state_dict(sd)
    pp32 = tfm.create_preprocessing(CAIT, dtype=torch.float32, device="cpu")
    before = dict(dispatch.launch_counts)
    with torch.inference_mode():
        ref_logits, ref_feats = model32(pp32(x.cpu()), return_features=True)
    check(dispatch.launch_counts == before,
          "the f32 CPU reference launched a kernel")
    for name, got, want in (
            ("forward_features", feats, ref_feats["features"]),
            ("logits", outputs[0][:CAIT_CHECK_IMAGES], ref_logits)):
        got = got.float().cpu()
        rel = ((got - want).abs().max() / want.abs().max()).item()
        print(f"slice {CAIT} {name}: bf16 kernel path vs f32 plain path on "
              f"the CPU rel err {rel!r} (bar 5e-2)", flush=True)
        check(rel < 5e-2, f"{CAIT} {name} rel err {rel} >= 5e-2")
    del model32, ref_logits, ref_feats

    img = requests[1]
    wall_ms, groups, names = device_split(lambda: model.predict(pp(img)),
                                          steps=2)
    busy_ms = sum(groups.values())
    print(f"{CAIT} request profile: device busy {busy_ms!r} ms per request; "
          f"wall {wall_ms!r} ms under the profiler, {request_ms!r} ms without; "
          f"device idle share {1.0 - busy_ms / request_ms!r}", flush=True)
    for group, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"{CAIT} request profile: {group}: {ms!r} ms per request",
              flush=True)
    for name, ms in sorted(names.items(), key=lambda kv: -kv[1])[:12]:
        print(f"{CAIT} request profile kernel: {ms!r} ms {name[:150]}",
              flush=True)


def phase_cait_bwd_kernel(report, gpu_line):
    import torch

    from tfimm_tpu_torch.ops.kernels import cait_attention as cait_module
    from tfimm_tpu_torch.ops.kernels.cait_attention import (
        talking_head_attention_bwd,
        talking_head_attention_bwd_reference,
    )

    names = ("dq", "dk", "dv", "dw_l", "dw_w", "db_w")

    def pieces(grads, dim):
        dqkv, dwl, _, dww, dbw = grads
        return (dqkv[..., :dim], dqkv[..., dim:2 * dim], dqkv[..., 2 * dim:],
                dwl, dww, dbw)

    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[1]
        for i, (b, n, h, d) in enumerate(CAIT_BWD_SHAPES):
            args = cait_inputs(b, n, h, d, dtype, 1300 + i)
            scale = d ** -0.5
            what = (f"{dname:8s} B={b} N={n} H={h} d={d} "
                    f"({cait_body(h, args[0], args[5])})")
            got = talking_head_attention_bwd(*args, nb_heads=h, scale=scale)
            ref = talking_head_attention_bwd_reference(*args, nb_heads=h,
                                                       scale=scale)
            torch.cuda.synchronize()
            check(torch.equal(got[2], torch.zeros_like(got[2])),
                  "talking_head_attention_bwd: db_l is not exactly 0")
            bars = []
            for name, a, w in zip(names, pieces(got, h * d),
                                  pieces(ref, h * d)):
                err, bar, ok = held(a, w, CAIT_BWD_TOL[dname])
                bars.append(bar)
                print(f"talking_head_attention_bwd {what} {name}: "
                      f"max_abs_err={err!r} bar={bar!r} "
                      f"{'ok' if ok else 'FAIL'}", flush=True)
                check(ok, f"talking_head_attention_bwd {name} disagrees with "
                      f"its plain version ({what}): {err} > {bar}")
                if dtype == torch.bfloat16 and i == 0:
                    report["max_abs_err"] = max(report.get("max_abs_err", 0.0),
                                                err)
            if dtype == torch.bfloat16 and i == 0:
                # Control: the plain backward with w_w transposed.
                qkv, wl, bl, ww, bw, g = args
                wrong = pieces(talking_head_attention_bwd_reference(
                    qkv, wl, bl, ww.t(), bw, g, nb_heads=h, scale=scale), h * d)
                misses = [(a.float() - w.float()).abs().max().item() / bar
                          for a, w, bar in zip(pieces(got, h * d), wrong, bars)]
                print(f"talking_head_attention_bwd control {what}: with w_w "
                      f"transposed {dict(zip(names, misses))} bars off",
                      flush=True)
                check(max(misses) > CONTROL_FACTOR, "talking_head_attention_"
                      "bwd: w_w transposed stays within the bar")
                again = talking_head_attention_bwd(*args, nb_heads=h,
                                                   scale=scale)
                same = all(torch.equal(a, w) for a, w in zip(again, got))
                print(f"talking_head_attention_bwd {what}: a second call is "
                      f"bit-identical: {same}", flush=True)
                check(same, "talking_head_attention_bwd is not deterministic")
                del again, wrong
            del args, got, ref

    b, n, h, d = CAIT_BWD_SHAPES[0]
    args = cait_inputs(b, n, h, d, torch.bfloat16, 1400)
    scale = d ** -0.5
    # Under autograd (a training step) the forward's Hopper body keeps log2 l
    # and the backward skips the pass that recomputes it: that call is the
    # one timed as "ms"; "recompute_ms" is the call without it.
    _, stats = cait_module._forward(*args[:5], h, scale, True)

    def call():
        return talking_head_attention_bwd(*args, nb_heads=h, scale=scale,
                                          row_stats=stats)

    def recompute():
        return talking_head_attention_bwd(*args, nb_heads=h, scale=scale)

    hopper_keys = ("talking_head_bwd_rows_wgmma",
                   "talking_head_bwd_dqkv_wgmma")
    events = cold_device_events(
        call, need=[(k,) for k in hopper_keys]
        + launch_keys("talking_head_attention_bwd"))
    check_hopper_body("talking_head_attention_bwd", events, hopper_keys)
    report["launch_cold_ms"] = cold_launch_parts(
        call, "talking_head_attention_bwd", events=events)
    report["cold_ms"] = report["ms"] = cold_ms(call)
    report["warm_ms"] = cuda_time_ms(call, iters=10)
    report["recompute_ms"] = cold_ms(recompute)
    report["host_ms"] = host_ms_per_call("talking_head_attention_bwd", call)
    report["plain_ms"] = cuda_time_ms(
        lambda: talking_head_attention_bwd_reference(*args, nb_heads=h,
                                                     scale=scale), iters=3)
    report["bound_ms"], report["bound_by"] = cait_bound(b, n, h, d, True)
    report["library_ms"] = None
    report["cublas_floor_ms"] = cait_floor_ms(args[0], args[5], h, True)
    print(f"talking_head_attention_bwd bf16 {CAIT_BWD_SHAPES[0]} "
          f"({cait_body(h, args[0], args[5])}), with the forward's log2 l as "
          f"in training: kernel out of L2 {report['cold_ms']!r} ms, "
          f"{report['bound_ms'] / report['cold_ms']!r} of the bound "
          f"{report['bound_ms']!r} ms ({report['bound_by']}); back to back "
          f"{report['warm_ms']!r} ms; recomputing l {report['recompute_ms']!r} "
          f"ms out of L2; the wrapper's host time {report['host_ms']!r} ms a "
          f"call; plain {report['plain_ms']!r} ms; cuBLAS floor (the "
          f"five batched products alone) {report['cublas_floor_ms']!r} ms; on "
          f"{gpu_line}", flush=True)
    for part, ms in report["launch_cold_ms"].items():
        print(f"talking_head_attention_bwd launch {part}: {ms!r} ms out of "
              f"L2", flush=True)


def cait_train_config() -> dict:
    """CaiT-S24 at batch 64 with the DeiT recipe the CaiT paper trains with
    (AdamW at weight decay 0.05, label smoothing 0.1, mixup 0.8, cutmix
    1.0, drop path 0.1, no attention dropout), bf16 mixed precision, lr
    1e-3, 6 epochs of one step each on the same 64 synthetic images."""
    cfg = swin_train_config()
    cfg["problem"]["model"] = {"model_name": CAIT, "drop_path_rate": 0.1}
    for part in ("train_dataset", "timekeeping"):
        cfg[part]["batch_size"] = CAIT_TRAIN_BATCH
    cfg["train_dataset"]["nb_samples"] = CAIT_TRAIN_BATCH
    cfg["timekeeping"]["nb_samples_per_epoch"] = CAIT_TRAIN_BATCH
    return cfg


def phase_cait_train(reports, gpu_line):
    import torch

    import tfimm_tpu_torch as tfm
    from tfimm_tpu_torch.ops.kernels import dispatch
    from tfimm_tpu_torch.parallel.step import cross_entropy_loss
    from tfimm_tpu_torch.utils.profile import time_model

    trainer, steps, counts = run_watched(cait_train_config())
    problem = trainer.problem
    check(len(steps) == TRAIN_STEPS, f"{len(steps)} CaiT training steps, "
          f"expected {TRAIN_STEPS}")
    for it, (loss, seconds, rose) in enumerate(steps):
        print(f"cait train step {it}: loss {loss!r}, {seconds!r} s, launches "
              f"{rose}", flush=True)
        check(rose == expected(**CAIT_TRAIN_LAUNCHES),
              f"CaiT step {it} launched {rose}, expected "
              f"{CAIT_TRAIN_LAUNCHES} and nothing else")
        check(math.isfinite(loss), f"CaiT step {it}: loss {loss}")
    losses = [loss for loss, _, _ in steps]
    last = (losses[-1] + losses[-2]) / 2
    print(f"cait train loss: first {losses[0]!r}, mean of the last two "
          f"{last!r}", flush=True)
    check(last < losses[0], f"the CaiT loss did not fall: {losses}")
    for name, report in reports.items():
        report["launches_by_path"]["train_cait"] = counts[name]
    timed = [s for _, s, _ in steps[1:]]
    step_s = sum(timed) / len(timed)
    print(f"train {CAIT} bs{CAIT_TRAIN_BATCH} bf16 mixed precision adamw "
          f"mixup/cutmix: {CAIT_TRAIN_BATCH * len(timed) / sum(timed)!r} img/s "
          f"({len(timed)} steps 2-{TRAIN_STEPS} in {sum(timed) * 1e3!r} ms; "
          f"median step {statistics.median(timed) * 1e3!r} ms, slowest "
          f"{max(timed) * 1e3!r} ms) on {gpu_line}", flush=True)

    # One step's loss and gradients with seeded weights, no mixup, in eval
    # mode (drop path off): bf16 through the kernels on the card against
    # f32 through the plain versions on the CPU.
    model, pp = problem.model, problem.preprocessing
    sd = seeded_state_dict(model, seed=9, std=0.05)
    model.load_state_dict(sd)
    model.eval()
    images, labels = next(iter(trainer.train_ds))
    images = torch.as_tensor(images[:SWIN_CHECK_IMAGES])
    labels = torch.as_tensor(labels[:SWIN_CHECK_IMAGES])
    names = ("blocks.0.attn.proj_l.weight", "blocks.0.attn.qkv.weight")

    def loss_and_grads(m, x, y):
        m.zero_grad(set_to_none=True)
        before = dict(dispatch.launch_counts)
        loss = cross_entropy_loss(m(x).float(), y)
        loss.backward()
        rose = {k: dispatch.launch_counts[k] - before[k] for k in before}
        params = dict(m.named_parameters())
        return loss.item(), {n: params[n].grad.float().cpu() for n in names}, rose

    loss_k, grads_k, rose = loss_and_grads(
        model, pp(images.to("cuda")).to(torch.bfloat16), labels.to("cuda"))
    check(rose == expected(**CAIT_TRAIN_LAUNCHES),
          f"the bf16 CaiT step launched {rose}")
    model32 = tfm.create_model(CAIT, device="cpu", dtype=torch.float32, seed=0)
    model32.load_state_dict(sd)
    model32.eval()
    pp32 = tfm.create_preprocessing(CAIT, dtype=torch.float32, device="cpu")
    loss_r, grads_r, rose = loss_and_grads(model32, pp32(images), labels)
    check(rose == expected(), f"the f32 CPU reference launched {rose}")
    rel = abs(loss_k - loss_r) / abs(loss_r)
    print(f"cait train loss: bf16 kernel path {loss_k!r} vs f32 plain path on "
          f"the CPU {loss_r!r}, rel err {rel!r} (bar 2e-2)", flush=True)
    check(rel < 2e-2, f"CaiT loss rel err {rel} >= 2e-2")
    for name in names:
        ref = grads_r[name]
        rel = ((grads_k[name] - ref).abs().max() / ref.abs().max()).item()
        print(f"cait train grad {name}: max|diff| / max|ref| {rel!r} "
              f"(bar 1e-1)", flush=True)
        check(rel < 1e-1, f"{name} gradient rel err {rel} >= 1e-1")
        check(ref.abs().max().item() > 0, f"{name}: zero reference gradient")
    del model32, grads_r

    batch = next(iter(trainer.train_ds))
    wall_ms, groups, kernel_names = device_split(
        lambda: problem.train_step(batch, 0))
    busy_ms = sum(groups.values())
    print(f"cait train step profile: device busy {busy_ms!r} ms per step; wall "
          f"{wall_ms!r} ms under the profiler, {step_s * 1e3!r} ms without; "
          f"device idle share {1.0 - busy_ms / (step_s * 1e3)!r}", flush=True)
    for group, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"cait train step profile: {group}: {ms!r} ms per step",
              flush=True)
    for name, ms in sorted(kernel_names.items(), key=lambda kv: -kv[1])[:15]:
        print(f"cait train step profile kernel: {ms!r} ms {name[:150]}",
              flush=True)

    img_s = time_model(CAIT, target="backprop", batch_size=CAIT_TRAIN_BATCH,
                       samples=3)
    print(f"time_model {CAIT} backprop bs{CAIT_TRAIN_BATCH} bf16: {img_s!r} "
          f"img/s on {gpu_line}", flush=True)


def relpos_inputs(b, gh, gw, d, dtype, seed, big=False):
    """Seeded inputs of flash_attention_relpos on the card: q, k, v normal,
    the rel terms at std 2 (SAM's come from q and the rel-pos tables). With
    ``big``, query 0 of every row points along keys 3 and 5, so that two of
    its scores sit near 300, far above the clamp of 80 that the other
    attention kernels apply."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    n = gh * gw
    q, k, v = (torch.randn(b, n, d, generator=gen, device="cuda")
               for _ in range(3))
    if big:
        q[:, 0] = 300.0 / d ** 0.5 * (k[:, 3] + k[:, 5])
    rh = 2.0 * torch.randn(b, n, gh, generator=gen, device="cuda")
    rw = 2.0 * torch.randn(b, n, gw, generator=gen, device="cuda")
    return [t.to(dtype) for t in (q, k, v, rh, rw)]


def relpos_bound(b, gh, gw, d):
    """bf16 q, k, v and the rel terms read once, out (bf16) and the f32 lse
    written once; q k^T and p v."""
    n = gh * gw
    return bound(2 * (4 * b * n * d + b * n * (gh + gw)) + 4 * b * n,
                 4 * b * n * n * d)


def phase_relpos_kernel(report, gpu_line):
    import torch
    import torch.nn.functional as F

    from tfimm_tpu_torch.ops.kernels.flash_attention_relpos import (
        flash_attention_relpos,
        flash_attention_relpos_reference,
        flash_attention_relpos_with_lse,
    )

    cases = [(shape, False) for shape in RELPOS_SHAPES + RELPOS_EDGES]
    cases.append((RELPOS_BIG, True))
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[1]
        for i, ((b, gh, gw, d), big) in enumerate(cases):
            q, k, v, rh, rw = relpos_inputs(b, gh, gw, d, dtype, 1500 + i, big)
            kw = dict(grid_size=(gh, gw), scale=d ** -0.5)
            what = f"{dname:8s} B={b} grid={gh}x{gw} d={d}{' big' if big else ''}"
            out, lse = flash_attention_relpos_with_lse(q, k, v, rh, rw, **kw)
            ref, ref_lse = flash_attention_relpos_reference(q, k, v, rh, rw,
                                                            **kw)
            torch.cuda.synchronize()
            err, bar, ok = held(out, ref, RELPOS_TOL[dname])
            lerr, lbar, lok = held(lse, ref_lse, RELPOS_TOL[dname])
            note = ""
            if big:
                top = ref_lse[:, 0].min().item()
                ok = ok and top > 100.0
                note = f" (row 0's lse {top!r})"
            print(f"flash_attention_relpos {what}: max_abs_err={err!r} "
                  f"bar={bar!r}; lse max_abs_err={lerr!r} bar={lbar!r}{note} "
                  f"{'ok' if ok and lok else 'FAIL'}", flush=True)
            check(ok and lok, f"flash_attention_relpos disagrees with its "
                  f"plain version ({what}): {err} > {bar} or lse {lerr} > {lbar}")
            if dtype == torch.bfloat16 and i == 0:
                report["max_abs_err"] = err
                # Control: the plain version without the bias must miss the
                # bar by far.
                far = (out.float() - flash_attention_relpos_reference(
                    q, k, v, torch.zeros_like(rh), torch.zeros_like(rw),
                    **kw)[0].float()).abs().max().item()
                print(f"flash_attention_relpos control {what}: without the "
                      f"bias off by {far!r}, {far / bar!r} bars", flush=True)
                check(far > CONTROL_FACTOR * bar, "flash_attention_relpos: "
                      "the plain version without the bias stays within the bar")
            del q, k, v, rh, rw, out, lse, ref, ref_lse

    for j, (b, gh, gw, d) in enumerate(RELPOS_SHAPES):
        q, k, v, rh, rw = relpos_inputs(b, gh, gw, d, torch.bfloat16, 1600 + j)
        kw = dict(grid_size=(gh, gw), scale=d ** -0.5)
        n = gh * gw
        # The library call: SDPA with the bias materialised as a bf16 float
        # mask, made before the timer starts; (1, B, N, d) operands, since
        # SDPA's fused backends take only 4-D inputs (3-D ones run its
        # unfused math path).
        mask = (rh[..., :, None] + rw[..., None, :]).reshape(1, b, n, n)
        q4, k4, v4 = q[None], k[None], v[None]

        def sdpa_call():
            return F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask,
                                                  scale=kw["scale"])[0]

        times = {
            "ms": cuda_time_ms(lambda: flash_attention_relpos(q, k, v, rh, rw,
                                                              **kw)),
            "plain_ms": cuda_time_ms(lambda: flash_attention_relpos_reference(
                q, k, v, rh, rw, **kw), iters=5),
            "library_ms": cuda_time_ms(sdpa_call),
        }
        times["bound_ms"], times["bound_by"] = relpos_bound(b, gh, gw, d)
        sdpa = sdpa_call()
        ref = flash_attention_relpos_reference(q, k, v, rh, rw, **kw)[0]
        sdpa_err = (sdpa.float() - ref.float()).abs().max().item()
        kind = "global" if j == 0 else "windowed"
        if j == 0:
            report.update(times)
        else:
            report["windowed"] = times
        print(f"flash_attention_relpos bf16 {kind} (B, gh, gw, d) = "
              f"{(b, gh, gw, d)}: kernel {times['ms']!r} ms, "
              f"{times['bound_ms'] / times['ms']!r} of the bound "
              f"{times['bound_ms']!r} ms ({times['bound_by']}); plain "
              f"{times['plain_ms']!r} ms; scaled_dot_product_attention with "
              f"the float mask {times['library_ms']!r} ms (its max abs diff "
              f"to plain {sdpa_err!r}); on {gpu_line}", flush=True)
        print_shares(f"flash_attention_relpos {kind}", times,
                     cold_ms(lambda: flash_attention_relpos(q, k, v, rh, rw,
                                                            **kw)),
                     cold_ms(sdpa_call), gpu_line)
        del q, k, v, q4, k4, v4, rh, rw, mask, sdpa, ref


def sam_state_dict(model, seed: int):
    """``seeded_state_dict`` at std 0.02, with SAM's zero-initialised
    rel-pos tables (std 0.5) and position embedding (std 0.5) drawn away
    from zero, so that the bias really moves the scores, and its embedding
    tables and Fourier matrix at their own init's scale (std 1)."""
    import torch

    sd = seeded_state_dict(model, seed=seed, std=0.02)
    g = torch.Generator().manual_seed(seed + 1)
    tables = ("iou_token.weight", "mask_tokens.weight", "not_a_point_embed.weight",
              "no_mask_embed.weight", "positional_encoding_gaussian_matrix")
    for name, t in sd.items():
        if name.endswith(("rel_pos_h", "rel_pos_w", "pos_embed")):
            sd[name] = 0.5 * torch.randn(t.shape, generator=g)
        elif name.endswith(tables) or ".point_embeddings." in name:
            sd[name] = torch.randn(t.shape, generator=g)
    return sd


def event_ms(fn) -> float:
    """One call of ``fn`` between two CUDA events, in ms (the call ends on
    the host or enqueues its device work; the end event waits for it)."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def sam_prompts(h, w):
    """The three prompt calls of one request on an (h, w) image: 2 points
    (multimask), 1 box, then the points with the best low-resolution logits
    of the first call as the mask prompt."""
    import numpy as np

    points = np.array([[0.3 * w, 0.4 * h], [0.6 * w, 0.7 * h]], np.float32)
    labels = np.array([1, 0], np.int32)
    box = np.array([[0.2 * w, 0.2 * h, 0.7 * w, 0.8 * h]], np.float32)
    return points, labels, box


def sam_request(predictor, image):
    """set_image, then the three prompt calls. Returns the results of the
    calls, the launch counts of set_image and of the prompt calls, and
    their CUDA-event times (ms)."""
    import numpy as np

    from tfimm_tpu_torch.ops.kernels import dispatch

    h, w = image.shape[:2]
    points, labels, box = sam_prompts(h, w)
    before = dict(dispatch.launch_counts)
    set_ms = event_ms(lambda: predictor.set_image(image))
    after_set = dict(dispatch.launch_counts)
    results, prompt_ms = [], []

    def call(**prompt):
        results.append(predictor(**prompt))

    prompt_ms.append(event_ms(lambda: call(points=points, labels=labels,
                                           multimask_output=True)))
    prompt_ms.append(event_ms(lambda: call(boxes=box, multimask_output=False)))
    best = results[0][2][int(np.argmax(results[0][1]))][None]
    prompt_ms.append(event_ms(lambda: call(points=points, labels=labels,
                                           masks=best,
                                           multimask_output=False)))
    set_launches = {k: after_set[k] - before[k] for k in before}
    prompt_launches = {k: dispatch.launch_counts[k] - after_set[k]
                       for k in before}
    return results, set_launches, prompt_launches, set_ms, prompt_ms


def phase_sam_slice(reports, gpu_line):
    import numpy as np
    import torch

    import tfimm_tpu_torch as tfm
    from tfimm_tpu_torch.architectures.segment_anything import SAMPredictor
    from tfimm_tpu_torch.ops.kernels import dispatch

    model = tfm.create_model(SAM, device="cuda", dtype=torch.bfloat16, seed=0)
    sd = sam_state_dict(model, seed=16)
    model.load_state_dict(sd)
    predictor = SAMPredictor(model)
    rng = np.random.default_rng(17)
    images = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
              for h, w in SAM_IMAGES]
    sam_request(predictor, images[1])   # warm-up: cuBLAS handles, allocator
    torch.cuda.synchronize()

    dispatch.reset_launch_counts()
    latencies = []
    first = None      # image 0's embedding and first logits, on the CPU
    for image in images:
        results, set_l, prompt_l, set_ms, prompt_ms = sam_request(predictor,
                                                                  image)
        check(set_l == expected(**SAM_LAUNCHES), f"one set_image launched "
              f"{set_l}, expected {SAM_LAUNCHES} and nothing else")
        check(prompt_l == expected(), f"the prompt calls launched {prompt_l}")
        emb = predictor.image_embedding
        check(tuple(emb.shape) == (1, *model.grid_size(), model.cfg.embed_dim),
              f"embedding shape {tuple(emb.shape)}")
        check(bool(torch.isfinite(emb).all()), "non-finite image embedding")
        h, w = image.shape[:2]
        for (masks, scores, logits), k in zip(results, (3, 1, 1)):
            check(masks.shape == (k, h, w) and masks.dtype == bool,
                  f"masks {masks.shape} {masks.dtype}")
            check(scores.shape == (k,)
                  and logits.shape == (k, *model.mask_size()),
                  f"scores {scores.shape}, logits {logits.shape}")
            check(bool(np.isfinite(scores).all() and np.isfinite(logits).all()),
                  "non-finite scores or logits")
        if first is None:
            first = (emb.float().cpu(), torch.from_numpy(results[0][2]))
        latencies.append((set_ms, prompt_ms))
        print(f"{SAM} request on a {h}x{w} uint8 image: set_image "
              f"{set_ms!r} ms, prompt calls {prompt_ms!r} ms (CUDA events); "
              f"launches {set_l['flash_attention_relpos']} + "
              f"{prompt_l['flash_attention_relpos']}", flush=True)
    for name, report in reports.items():
        report["launches_by_path"]["serve_sam"] = dispatch.launch_counts[name]
    set_med = statistics.median(s for s, _ in latencies)
    prompt_med = statistics.median(t for _, ts in latencies for t in ts)
    print(f"{SAM} bf16 SAMPredictor: set_image {set_med!r} ms, prompt call "
          f"{prompt_med!r} ms (medians over {len(images)} images) on "
          f"{gpu_line}", flush=True)

    # The same weights in f32 on the CPU, where the kernel wrapper runs its
    # plain version and launches nothing: the first image's embedding and
    # the first prompt call's low-resolution logits.
    model32 = tfm.create_model(SAM, device="cpu", dtype=torch.float32, seed=0)
    model32.load_state_dict(sd)
    ref = SAMPredictor(model32)
    points, labels, _ = sam_prompts(*SAM_IMAGES[0])
    before = dict(dispatch.launch_counts)
    ref.set_image(images[0])
    ref_logits = ref(points=points, labels=labels, multimask_output=True)[2]
    check(dispatch.launch_counts == before,
          "the f32 CPU reference launched a kernel")
    for name, got, want in (
            ("image embedding", first[0], ref.image_embedding),
            ("decoder logits", first[1], torch.from_numpy(ref_logits))):
        rel = ((got - want).abs().max() / want.abs().max()).item()
        print(f"{SAM} {name}: bf16 kernel path vs f32 plain path on the CPU "
              f"rel err {rel!r} (bar {SAM_TOL})", flush=True)
        check(rel < SAM_TOL, f"{SAM} {name} rel err {rel} >= {SAM_TOL}")
    del model32, ref

    # Encoder throughput at batch 8 through forward_features.
    pp = tfm.create_preprocessing(SAM, dtype=torch.bfloat16, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(18)
    batch = pp(torch.randint(0, 256, (SAM_BATCH, *model.cfg.input_size, 3),
                             generator=g, device="cuda", dtype=torch.uint8))

    def encode():
        with torch.inference_mode():
            return model(batch, features_only=True)

    before = dispatch.launch_counts["flash_attention_relpos"]
    feats = encode()
    torch.cuda.synchronize()
    check(dispatch.launch_counts["flash_attention_relpos"]
          == before + SAM_LAUNCHES["flash_attention_relpos"],
          "a batch-8 encoder pass did not launch the kernel once per block")
    check(bool(torch.isfinite(feats).all()), "non-finite batch-8 features")
    ms = cuda_time_ms(encode, iters=3, repeats=3, warmup=1)
    print(f"{SAM} encoder bs{SAM_BATCH} bf16 forward_features: {ms!r} ms, "
          f"{SAM_BATCH / ms * 1e3!r} img/s on {gpu_line}", flush=True)

    image = images[1]
    wall_ms, groups, names = device_split(lambda: predictor.set_image(image),
                                          steps=2)
    busy_ms = sum(groups.values())
    set_ms = latencies[1][0]
    print(f"{SAM} set_image profile ({image.shape[0]}x{image.shape[1]}): "
          f"device busy {busy_ms!r} ms; wall {wall_ms!r} ms under the "
          f"profiler, {set_ms!r} ms without; device idle share "
          f"{1.0 - busy_ms / set_ms!r}", flush=True)
    for group, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"{SAM} set_image profile: {group}: {ms!r} ms", flush=True)
    for name, ms in sorted(names.items(), key=lambda kv: -kv[1])[:12]:
        print(f"{SAM} set_image profile kernel: {ms!r} ms {name[:150]}",
              flush=True)


def relpos_bwd_bound(b, gh, gw, d):
    """qs, k, v, out, do and the rel terms read, dq, dk, dv, drh and drw
    written once (bf16), the f32 lse read; the five products."""
    n = gh * gw
    return bound(2 * (8 * b * n * d + 2 * b * n * (gh + gw)) + 4 * b * n,
                 10 * b * n * n * d)


def relpos_bwd_inputs(b, gh, gw, d, dtype, seed, big=False):
    """The backward's inputs on the card: qs, k, v, the rel terms, the
    kernel forward's out and lse, and a normal cotangent do."""
    import torch

    from tfimm_tpu_torch.ops.kernels.flash_attention_relpos import (
        flash_attention_relpos_with_lse,
        scale_query,
    )

    q, k, v, rh, rw = relpos_inputs(b, gh, gw, d, dtype, seed, big)
    scale = d ** -0.5
    out, lse = flash_attention_relpos_with_lse(q, k, v, rh, rw,
                                               grid_size=(gh, gw), scale=scale)
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    do = torch.randn(out.shape, generator=gen, device="cuda").to(dtype)
    return scale_query(q, scale), k, v, rh, rw, out, lse, do


def sdpa_relpos_backward_ms(args, grid):
    """(ms back to back, ms out of L2, backend) of the backward of
    ``F.scaled_dot_product_attention`` on (1, B, N, d) operands with the
    bias as a bf16 float mask that requires grad, plus the two sums that
    reduce the mask's gradient to drh and drw. The first SDPA backend
    (memory-efficient, then math) that returns a mask gradient is timed;
    None where none does."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    qs, k, v, rh, rw, _, _, do = args
    gh, gw = grid
    b, n, _ = qs.shape
    leaves = [t.detach()[None].requires_grad_() for t in (qs, k, v)]
    mask = (rh[..., :, None] + rw[..., None, :]).reshape(1, b, n, n)
    mask = mask.detach().requires_grad_()
    failures = []
    for backend in (SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel(backend):
                out = F.scaled_dot_product_attention(*leaves, attn_mask=mask,
                                                     scale=1.0)

                def call():
                    grads = torch.autograd.grad(out, (*leaves, mask), do[None],
                                                retain_graph=True)
                    dm = grads[3].reshape(b, n, gh, gw)
                    return grads[:3], dm.sum(-1), dm.sum(-2)

                call()
                return (cuda_time_ms(call, iters=10), cold_ms(call),
                        backend.name)
        except RuntimeError as e:
            failures.append(f"{backend.name}: {str(e).splitlines()[0][:120]}")
    print(f"flash_attention_relpos_bwd: no SDPA backend gave a mask gradient: "
          f"{failures}", flush=True)
    return None, None, None


def phase_relpos_bwd_kernel(report, gpu_line):
    import torch

    from tfimm_tpu_torch.ops.kernels.flash_attention_relpos import (
        flash_attention_relpos_bwd,
        flash_attention_relpos_bwd_reference,
    )

    names = ("dq", "dk", "dv", "drh", "drw")
    cases = [(shape, False) for shape in RELPOS_SHAPES + RELPOS_EDGES]
    cases.append((RELPOS_BIG, True))
    worst = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[1]
        for i, ((b, gh, gw, d), big) in enumerate(cases):
            args = relpos_bwd_inputs(b, gh, gw, d, dtype, 1700 + i, big)
            kw = dict(grid_size=(gh, gw))
            what = f"{dname:8s} B={b} grid={gh}x{gw} d={d}{' big' if big else ''}"
            got = flash_attention_relpos_bwd(*args, **kw)
            ref = flash_attention_relpos_bwd_reference(*args, **kw)
            torch.cuda.synchronize()
            bars = []
            for name, a, r in zip(names, got, ref):
                err, bar, ok = held(a, r, RELPOS_BWD_TOL[dname])
                bars.append(bar)
                print(f"flash_attention_relpos_bwd {what} {name}: "
                      f"max_abs_err={err!r} bar={bar!r} "
                      f"{'ok' if ok else 'FAIL'}", flush=True)
                check(ok, f"flash_attention_relpos_bwd {name} disagrees with "
                      f"its plain version ({what}): {err} > {bar}")
                if dtype == torch.bfloat16 and i < len(RELPOS_SHAPES):
                    worst = max(worst, err)
            if dtype == torch.bfloat16 and i == 1:
                # Control: the plain backward without the bias must miss the
                # bar by far; two calls must be bit-identical.
                qs, k, v, rh, rw, out, lse, do = args
                no_bias = flash_attention_relpos_bwd_reference(
                    qs, k, v, torch.zeros_like(rh), torch.zeros_like(rw), out,
                    lse, do, **kw)
                misses = [(a.float() - r.float()).abs().max().item() / bar
                          for a, r, bar in zip(got, no_bias, bars)]
                print(f"flash_attention_relpos_bwd control {what}: without "
                      f"the bias {dict(zip(names, misses))} bars off",
                      flush=True)
                check(min(misses) > CONTROL_FACTOR, "flash_attention_relpos_"
                      "bwd: leaving the bias out stays within the bar")
                again = flash_attention_relpos_bwd(*args, **kw)
                same = all(torch.equal(a, r) for a, r in zip(got, again))
                print(f"flash_attention_relpos_bwd {what}: a second call is "
                      f"bit-identical: {same}", flush=True)
                check(same, "flash_attention_relpos_bwd is not deterministic")
                del no_bias, again
            del args, got, ref
    report["max_abs_err"] = worst

    for j, (b, gh, gw, d) in enumerate(RELPOS_SHAPES):
        args = relpos_bwd_inputs(b, gh, gw, d, torch.bfloat16, 1800 + j)
        kw = dict(grid_size=(gh, gw))
        times = {
            "ms": cuda_time_ms(lambda: flash_attention_relpos_bwd(*args, **kw)),
            "cold_ms": cold_ms(lambda: flash_attention_relpos_bwd(*args, **kw)),
            "plain_ms": cuda_time_ms(
                lambda: flash_attention_relpos_bwd_reference(*args, **kw),
                iters=5),
        }
        (times["library_ms"], times["library_cold_ms"],
         backend) = sdpa_relpos_backward_ms(args, (gh, gw))
        times["bound_ms"], times["bound_by"] = relpos_bwd_bound(b, gh, gw, d)
        kind = "global" if j == 0 else "windowed"
        if j == 0:
            report.update(times)
        else:
            report["windowed"] = times
        print(f"flash_attention_relpos_bwd bf16 {kind} (B, gh, gw, d) = "
              f"{(b, gh, gw, d)}: kernel (two launches) back to back "
              f"{times['ms']!r} ms, {times['bound_ms'] / times['ms']!r} of "
              f"the bound {times['bound_ms']!r} ms ({times['bound_by']}); out "
              f"of L2 {times['cold_ms']!r} ms, "
              f"{times['bound_ms'] / times['cold_ms']!r} of the bound; plain "
              f"{times['plain_ms']!r} ms; scaled_dot_product_attention "
              f"backward with a float mask that requires grad ({backend}) "
              f"and the two sums: back to back {times['library_ms']!r} ms, "
              f"out of L2 {times['library_cold_ms']!r} ms; on {gpu_line}",
              flush=True)
        del args


def launches_of(fn):
    """(fn's result, the kernel launches it made)."""
    from tfimm_tpu_torch.ops.kernels import dispatch

    before = dict(dispatch.launch_counts)
    out = fn()
    return out, {k: dispatch.launch_counts[k] - before[k] for k in before}


def timed_steps(step, launches, what):
    """``step`` SAM_TRAIN_STEPS times, each between CUDA events and each
    held to ``launches``. Returns the step times (ms) and the run's launch
    counts, which start at 0 just before it."""
    from tfimm_tpu_torch.ops.kernels import dispatch

    times = []
    dispatch.reset_launch_counts()
    for it in range(SAM_TRAIN_STEPS):
        ms, rose = launches_of(lambda: event_ms(step))
        times.append(ms)
        check(rose == expected(**launches), f"{what} {it} launched {rose}, "
              f"expected {launches}")
    return times, dict(dispatch.launch_counts)


def profile_idle(what, fn, step_ms, steps=2):
    """A ``torch.profiler`` split of ``fn``: device busy time and the idle
    share against ``step_ms``, the call's time without the profiler."""
    wall_ms, groups, names = device_split(fn, steps=steps)
    busy_ms = sum(groups.values())
    print(f"{what} profile: device busy {busy_ms!r} ms; wall {wall_ms!r} ms "
          f"under the profiler, {step_ms!r} ms without; device idle share "
          f"{1.0 - busy_ms / step_ms!r}", flush=True)
    for group, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"{what} profile: {group}: {ms!r} ms", flush=True)
    for name, ms in sorted(names.items(), key=lambda kv: -kv[1])[:8]:
        print(f"{what} profile kernel: {ms!r} ms {name[:150]}", flush=True)


def sam_finetune_batch(model, pp):
    """SAM_FINETUNE_IMAGES seeded uint8 1024x1024 images, one box each (no
    points, no mask prompt), and a target mask: 1 inside each box on the
    low-resolution grid."""
    import numpy as np
    import torch

    rng = np.random.default_rng(19)
    n = SAM_FINETUNE_IMAGES
    size = model.cfg.input_size
    images = rng.integers(0, 256, (n, *size, 3), dtype=np.uint8)
    lo = rng.uniform(0.1, 0.4, (n, 2)) * size[0]
    hi = lo + rng.uniform(0.3, 0.5, (n, 2)) * size[0]
    boxes = np.concatenate([lo, hi], axis=1)[:, None].astype(np.float32)
    mh, mw = model.mask_size()
    ys = (np.arange(mh) + 0.5) * size[0] / mh
    xs = (np.arange(mw) + 0.5) * size[1] / mw
    target = np.zeros((n, 1, mh, mw), np.float32)
    for i, (x0, y0, x1, y1) in enumerate(boxes[:, 0]):
        target[i, 0] = ((ys[:, None] >= y0) & (ys[:, None] <= y1)
                        & (xs[None] >= x0) & (xs[None] <= x1))
    inputs = {"images": pp(torch.from_numpy(images)),
              "points": torch.zeros(n, 0, 2, device="cuda"),
              "labels": torch.zeros(n, 0, dtype=torch.int32, device="cuda"),
              "boxes": torch.from_numpy(boxes).to("cuda"),
              "masks": torch.zeros(n, 0, mh, mw, device="cuda")}
    return inputs, torch.from_numpy(target).to("cuda")


def phase_sam_train(reports, gpu_line):
    import torch
    import torch.nn.functional as F

    import tfimm_tpu_torch as tfm
    from tfimm_tpu_torch.ops.kernels import dispatch
    from tfimm_tpu_torch.train import OptimizerConfig, OptimizerFactory
    from tfimm_tpu_torch.train.optimizers import constant_schedule

    def adamw(params):
        cfg = OptimizerConfig(optimizer="adamw",
                              weight_decay=SAM_TRAIN_WEIGHT_DECAY)
        return OptimizerFactory(cfg, timekeeping=None).optimizer(
            params, constant_schedule(SAM_TRAIN_LR))

    model = tfm.create_model(SAM, device="cuda", dtype=torch.float32, seed=0)
    sd = sam_state_dict(model, seed=18)
    model.load_state_dict(sd)
    pp = tfm.create_preprocessing(SAM, dtype=torch.bfloat16, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(20)
    x = pp(torch.randint(0, 256, (1, *model.cfg.input_size, 3), generator=g,
                         device="cuda", dtype=torch.uint8))
    path_counts = dict.fromkeys(dispatch.launch_counts, 0)

    def add_path(counts):
        for k, c in counts.items():
            path_counts[k] += c

    # (1) The encoder fine-tuning step at bs1, as the JAX package measures
    # it: the f32 mean of the embedding in training mode, then AdamW.
    model.train()
    opt = adamw(model.image_encoder.parameters())
    losses = []

    def encoder_step():
        opt.zero_grad()
        loss = model(x, features_only=True).float().mean()
        loss.backward()
        opt.step()
        losses.append(loss.detach())

    step_ms, counts = timed_steps(encoder_step, SAM_TRAIN_LAUNCHES,
                                  "encoder step")
    add_path(counts)
    losses = [loss.item() for loss in losses]
    check(all(math.isfinite(loss) for loss in losses),
          f"non-finite encoder losses {losses}")
    params = list(model.image_encoder.parameters())
    check(all(bool(torch.isfinite(p.grad).all()) for p in params),
          "a non-finite encoder gradient")
    check(all(bool(torch.isfinite(p).all()) for p in params),
          "a non-finite encoder parameter after the steps")
    timed = step_ms[1:]
    enc_ms = sum(timed) / len(timed)
    print(f"{SAM} encoder fine-tuning step bs1 1024x1024 bf16 (f32 "
          f"parameters, AdamW): {enc_ms!r} ms a step over steps "
          f"2-{SAM_TRAIN_STEPS} (CUDA events; steps {step_ms!r}), "
          f"{1e3 / enc_ms!r} img/s; launches "
          f"{SAM_TRAIN_LAUNCHES} a step; losses {losses!r}; on {gpu_line}",
          flush=True)
    profile_idle(f"{SAM} encoder fine-tuning step", encoder_step, enc_ms)

    # The seeded weights' gradients: bf16 on the card against f32 on the
    # CPU (the plain versions: the window eager, the global blocks through
    # the plain forward and backward).
    def encoder_grads(m, inputs):
        m.zero_grad(set_to_none=True)
        loss, rose = launches_of(
            lambda: m(inputs, features_only=True).float().mean())
        loss.backward()
        named = dict(m.named_parameters())
        return loss.item(), {n: named[n].grad.float().cpu()
                             for n in SAM_GRAD_PARAMS}, rose

    model.load_state_dict(sd)
    loss_k, grads_k, _ = encoder_grads(model, x)
    model32 = tfm.create_model(SAM, device="cpu", dtype=torch.float32, seed=0)
    model32.load_state_dict(sd)
    model32.train()
    t0 = time.perf_counter()
    loss_r, grads_r, rose = encoder_grads(model32, x.float().cpu())
    check(rose == expected(), f"the f32 CPU reference launched {rose}")
    print(f"{SAM} encoder gradient: f32 reference on the CPU took "
          f"{time.perf_counter() - t0!r} s; loss bf16 {loss_k!r} vs f32 "
          f"{loss_r!r}", flush=True)
    for name in SAM_GRAD_PARAMS:
        ref = grads_r[name]
        rel = ((grads_k[name] - ref).abs().max() / ref.abs().max()).item()
        print(f"{SAM} encoder grad {name}: bf16 kernel path vs f32 plain "
              f"path on the CPU max|diff| / max|ref| {rel!r} (bar 1e-1)",
              flush=True)
        check(rel < 1e-1, f"{name} gradient rel err {rel} >= 1e-1")
        check(ref.abs().max().item() > 0, f"{name}: zero reference gradient")
    del model32, grads_r

    # (2) A gradient through the eval-mode model: every block takes the
    # kernel, the windows (B = 300, N = 196) too.
    model.eval()

    def eval_grad():
        model.zero_grad(set_to_none=True)
        model(x, features_only=True).float().mean().backward()

    eval_grad()
    dispatch.reset_launch_counts()
    eval_ms = event_ms(eval_grad)
    rose = dict(dispatch.launch_counts)
    check(rose == expected(**SAM_EVAL_LAUNCHES), f"the eval-mode gradient "
          f"pass launched {rose}, expected {SAM_EVAL_LAUNCHES}")
    add_path(rose)
    check(all(bool(torch.isfinite(p.grad).all()) for p in params),
          "a non-finite eval-mode gradient")
    eval_ms = statistics.median([eval_ms] + [event_ms(eval_grad)
                                            for _ in range(2)])
    print(f"{SAM} eval-mode gradient pass bs1 1024x1024 bf16: {eval_ms!r} ms "
          f"(CUDA events, median of 3); launches {SAM_EVAL_LAUNCHES}; on "
          f"{gpu_line}", flush=True)
    profile_idle(f"{SAM} eval-mode gradient pass", eval_grad, eval_ms)

    # (3) Whole-model fine-tuning: encoder, prompt encoder and mask decoder,
    # one box per image, BCE of the low-resolution logits, AdamW.
    model.load_state_dict(sd)
    model.train()
    opt = adamw(model.parameters())
    inputs, target = sam_finetune_batch(model, pp)
    losses = []

    def sam_step():
        opt.zero_grad()
        _, _, logits = model(inputs, multimask_output=False,
                             return_logits=True)
        loss = F.binary_cross_entropy_with_logits(logits.float(), target)
        loss.backward()
        opt.step()
        losses.append(loss.detach())

    step_ms, counts = timed_steps(sam_step, SAM_TRAIN_LAUNCHES,
                                  "fine-tuning step")
    add_path(counts)
    losses = [loss.item() for loss in losses]
    check(all(math.isfinite(loss) for loss in losses),
          f"non-finite fine-tuning losses {losses}")
    check(all(bool(torch.isfinite(p).all()) for p in model.parameters()),
          "a non-finite parameter after fine-tuning")
    print(f"{SAM} fine-tuning losses (BCE of the low-resolution logits, "
          f"{SAM_FINETUNE_IMAGES} images, one box each): {losses!r}",
          flush=True)
    check(losses[-1] < losses[0], f"the fine-tuning loss did not fall: "
          f"{losses}")
    timed = step_ms[1:]
    ft_ms = sum(timed) / len(timed)
    print(f"{SAM} whole-model fine-tuning step bs{SAM_FINETUNE_IMAGES} bf16 "
          f"(f32 parameters, AdamW): {ft_ms!r} ms a step over steps "
          f"2-{SAM_TRAIN_STEPS} (steps {step_ms!r}); on {gpu_line}",
          flush=True)
    profile_idle(f"{SAM} whole-model fine-tuning step", sam_step, ft_ms)
    for name, report in reports.items():
        report["launches_by_path"]["train_sam"] = path_counts[name]


def sra_inputs(b, n, s, c, dtype, seed):
    """Seeded inputs of ``pvt_sra`` on the card: x and the kv projection
    normal, the matrices scaled so that q and y are of unit size."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * scale

    return (rnd(b, n, c).to(dtype), rnd(b, s, 2 * c).to(dtype),
            rnd(c, c, scale=c ** -0.5).to(dtype), rnd(c, scale=0.1),
            rnd(c, c, scale=c ** -0.5).to(dtype), rnd(c, scale=0.1))


def sra_bound(b, n, s, c):
    """x read and y written once (bf16), k and v read once, the two
    matrices (bf16) and biases (f32); the four products."""
    nbytes = 2 * (2 * b * n * c + 2 * b * s * c + 2 * c * c) + 4 * 2 * c
    return bound(nbytes, 2 * b * n * c * (2 * c + 2 * s))


def body_of(events) -> str:
    """The body a call ran, from its device events (``profile_cases``):
    "wgmma" where one of its kernels is a TMA + wgmma body (its name holds
    "wgmma"), else "first"."""
    return "wgmma" if any("wgmma" in name for name, _ in events) else "first"


def sra_body_expected(dtype, s, c) -> str:
    """The body ``tma.sra_route`` sends a ``pvt_sra`` call with contiguous
    16-byte aligned operands (every case here) to."""
    import torch

    return "wgmma" if (dtype == torch.bfloat16 and c % 16 == 0 and c <= 64
                       and s <= 64) else "first"


def phase_sra_kernel(report, gpu_line):
    """Phase 19: ``pvt_sra`` against its plain version at every shape in
    both dtypes, a control; each case's body read from one profile of
    them all, printed and checked; then,
    at every bf16 shape, the kernel, its plain version and F.linear + SDPA
    + F.linear with their operands out of L2 (``cold_ms``), and the kernel
    back to back in L2."""
    import torch
    import torch.nn.functional as F

    from tfimm_tpu_torch.ops.kernels.pvt_sra import pvt_sra, pvt_sra_reference

    calls, cases = {}, {}
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[1]
        for i, (b, n, s, c) in enumerate(SRA_SHAPES):
            x, kv, wq, bq, wp, bp = sra_inputs(b, n, s, c, dtype, 1900 + i)
            scale = c ** -0.5
            what = f"{dname:8s} B={b} N={n} S={s} C={c}"
            got = pvt_sra(x, kv, wq, bq, wp, bp, scale)
            ref = pvt_sra_reference(x, kv[..., :c], kv[..., c:], wq, bq, wp,
                                    bp, scale)
            torch.cuda.synchronize()
            err, bar, ok = held(got, ref, SRA_TOL[dname])
            print(f"pvt_sra {what}: max_abs_err={err!r} bar={bar!r} "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            check(ok, f"pvt_sra disagrees with its plain version ({what}): "
                  f"{err} > {bar}")
            calls[what] = (functools.partial(pvt_sra, x, kv, wq, bq, wp, bp,
                                             scale), 1, ("pvt_sra_",))
            cases[what] = (dtype, b, n, s, c)
            if dtype == torch.bfloat16 and i == 0:
                report["max_abs_err"] = err
                # Control: the plain version with k and v swapped must miss.
                far = (got.float() - pvt_sra_reference(
                    x, kv[..., c:], kv[..., :c], wq, bq, wp, bp,
                    scale).float()).abs().max().item()
                print(f"pvt_sra control {what}: k and v swapped off by "
                      f"{far!r}, {far / bar!r} bars", flush=True)
                check(far > CONTROL_FACTOR * bar,
                      "pvt_sra: the plain version with k and v swapped stays "
                      "within the bar")
            del x, kv, got, ref

    bodies = {}
    for what, events in profile_cases(calls).items():
        dtype, b, n, s, c = cases[what]
        body = body_of(events)
        print(f"pvt_sra {what}: body {body}", flush=True)
        check(body == sra_body_expected(dtype, s, c),
              f"pvt_sra ({what}) ran the {body} body")
        bodies[str(dtype).split(".")[1], b, n, s, c] = body
    del calls

    for i, (b, n, s, c) in enumerate(SRA_SHAPES):
        x, kv, wq, bq, wp, bp = sra_inputs(b, n, s, c, torch.bfloat16,
                                           2000 + i)
        scale = c ** -0.5
        k, v = kv[..., :c].unsqueeze(1), kv[..., c:].unsqueeze(1)
        bq16, bp16 = bq.to(torch.bfloat16), bp.to(torch.bfloat16)

        def kernel():
            return pvt_sra(x, kv, wq, bq, wp, bp, scale)

        def library():
            q = F.linear(x, wq, bq16) * scale
            o = F.scaled_dot_product_attention(q.unsqueeze(1), k, v,
                                               scale=1.0)
            return F.linear(o.squeeze(1), wp, bp16)

        times = {"ms": cold_ms(kernel), "ms_in_l2": cuda_time_ms(kernel),
                 "plain_ms": cold_ms(lambda: pvt_sra_reference(
                     x, kv[..., :c], kv[..., c:], wq, bq, wp, bp, scale),
                     calls=3, warmup=1),
                 "library_ms": cold_ms(library)}
        times["bound_ms"], times["bound_by"] = sra_bound(b, n, s, c)
        times["shape"] = (b, n, s, c)
        if i == 0:
            report.update(times)
        else:
            report.setdefault("shapes", []).append(times)
        times["body"] = bodies["bfloat16", b, n, s, c]
        print(f"pvt_sra bf16 (B, N, S, C) = {(b, n, s, c)} "
              f"({times['body']} body), operands "
              f"out of L2: kernel {times['ms']!r} ms, "
              f"{times['bound_ms'] / times['ms']!r} of the bound "
              f"{times['bound_ms']!r} ms ({times['bound_by']}); plain "
              f"{times['plain_ms']!r} ms; F.linear + scaled_dot_product_"
              f"attention + F.linear {times['library_ms']!r} ms; back to back "
              f"in L2: kernel {times['ms_in_l2']!r} ms; on {gpu_line}",
              flush=True)
        del x, kv


def family_requests(model, pp, requests, launches, batch=BATCH):
    """Serve ``requests`` of ``batch`` images through ``model.predict``;
    each must launch the kernels of ``launches`` (name -> count) as many
    times and nothing else, and give finite, non-zero logits. Returns
    (request seconds, the first logits)."""
    import torch

    from tfimm_tpu_torch.ops.kernels import dispatch

    seconds, first = [], None
    for img in requests:
        before = dict(dispatch.launch_counts)
        t0 = time.perf_counter()
        logits = model.predict(pp(img))
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        rose = {k: dispatch.launch_counts[k] - before[k] for k in before}
        check(rose == expected(**launches), f"one {model.cfg.name} request "
              f"launched {rose}, expected {launches} and nothing else")
        check(tuple(logits.shape) == (batch, model.cfg.nb_classes),
              f"logits shape {tuple(logits.shape)}")
        check(bool(torch.isfinite(logits).all()), "non-finite logits")
        check(bool(logits.abs().max() > 0), "all-zero logits")
        first = logits if first is None else first
    return seconds, first


def family_serving(reports, gpu_line, path, kernel, switch_var, runs, seed):
    """Phases 20, 22 and 24: each (model, switch, launches) of ``runs`` in
    bf16 with seeded weights answers REQUESTS requests of BATCH uint8
    224x224 images, each launching ``kernel`` ``launches`` times (or the
    kernels of a ``launches`` dict, name -> count) and nothing else; the
    logits of the first FAMILY_CHECK_IMAGES images are held within 5e-2 of
    the same weights in f32 on the card through the eager path (switch
    off, autograd recording, no launch); a profile of one request of each
    model's first run."""
    import torch

    import tfimm_tpu_torch as tfm
    from tfimm_tpu_torch.ops.kernels import dispatch

    g = torch.Generator(device="cuda").manual_seed(seed)
    requests = [torch.randint(0, 256, (BATCH, 224, 224, 3), generator=g,
                              device="cuda", dtype=torch.uint8)
                for _ in range(REQUESTS)]
    x = requests[0][:FAMILY_CHECK_IMAGES]
    dispatch.reset_launch_counts()
    path_counts = expected()
    profiled = set()
    with restored_env(switch_var):
        for name, switch, launches in runs:
            model = tfm.create_model(name, device="cuda", dtype=torch.bfloat16,
                                     seed=0)
            sd = seeded_state_dict(model, seed=seed, std=0.05)
            model.load_state_dict(sd)
            pp = tfm.create_preprocessing(name, dtype=torch.bfloat16,
                                          device="cuda")
            os.environ[switch_var] = switch
            torch.cuda.synchronize()
            before = dict(dispatch.launch_counts)
            if not isinstance(launches, dict):
                launches = {kernel: launches}
            seconds, logits = family_requests(model, pp, requests, launches)
            for k in path_counts:
                path_counts[k] += dispatch.launch_counts[k] - before[k]
            img_s = [BATCH / t for t in seconds[1:]]
            request_ms = statistics.median(seconds[1:]) * 1e3
            how = "kernel" if switch == "1" else "eager"
            print(f"slice {name} bs{BATCH} bf16 ({switch_var}={switch}, "
                  f"{how}): request seconds {seconds!r}", flush=True)
            print(f"slice {name} bs{BATCH} bf16 ({how}): "
                  f"{statistics.median(img_s)!r} img/s (median of requests "
                  f"2-{REQUESTS}; range {min(img_s)!r}-{max(img_s)!r}), "
                  f"launches a request {launches}; on {gpu_line}",
                  flush=True)

            os.environ[switch_var] = "0"
            model32 = tfm.create_model(name, device="cuda",
                                       dtype=torch.float32, seed=0)
            model32.load_state_dict(sd)
            pp32 = tfm.create_preprocessing(name, dtype=torch.float32,
                                            device="cuda")
            before = dict(dispatch.launch_counts)
            with torch.enable_grad():   # every kernel gate declines
                ref = model32(pp32(x)).detach()
            check(dispatch.launch_counts == before,
                  "the f32 eager reference launched a kernel")
            got = logits[:FAMILY_CHECK_IMAGES].float()
            rel = ((got - ref).abs().max() / ref.abs().max()).item()
            print(f"slice {name} ({how}) logits: bf16 vs f32 eager on the "
                  f"card rel err {rel!r} (bar 5e-2)", flush=True)
            check(rel < 5e-2, f"{name} ({how}) logits rel err {rel} >= 5e-2")
            del model32, ref

            if name not in profiled:
                profiled.add(name)
                os.environ[switch_var] = switch
                img = requests[1]
                wall_ms, groups, names = device_split(
                    lambda: model.predict(pp(img)), steps=2)
                busy_ms = sum(groups.values())
                print(f"{name} ({how}) request profile: device busy "
                      f"{busy_ms!r} ms per request; wall {wall_ms!r} ms under "
                      f"the profiler, {request_ms!r} ms without; device idle "
                      f"share {1.0 - busy_ms / request_ms!r}", flush=True)
                for group, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
                    print(f"{name} ({how}) request profile: {group}: {ms!r} "
                          f"ms per request", flush=True)
                for kname, ms in sorted(names.items(),
                                        key=lambda kv: -kv[1])[:8]:
                    print(f"{name} ({how}) request profile kernel: {ms!r} ms "
                          f"{kname[:150]}", flush=True)
                if kernel in CONVNEXT_LAUNCH_PARTS and switch == "1":
                    print_launch_parts(f"{name} ({how})", names, kernel)
            del model
    for report_name, report in reports.items():
        report["launches_by_path"][path] = path_counts[report_name]


def pool_inputs(b, h, w, c, hidden, dtype, seed):
    """Seeded inputs of ``poolformer_block`` on the card: x normal, the
    norm weights and both layer scales near 1 (at their init of 1e-5 the
    block would return x to bf16 precision), the MLP scaled to unit-size
    products."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape, scale=1.0, shift=0.0):
        return torch.randn(*shape, generator=g, device="cuda") * scale + shift

    near_one = dict(scale=0.1, shift=1.0)
    return (rnd(b, h, w, c).to(dtype), rnd(c, **near_one), rnd(c, scale=0.1),
            rnd(c, **near_one), rnd(c, **near_one), rnd(c, scale=0.1),
            rnd(hidden, c, scale=c ** -0.5).to(dtype), rnd(hidden, scale=0.1),
            rnd(c, hidden, scale=hidden ** -0.5).to(dtype), rnd(c, scale=0.1),
            rnd(c, **near_one))


def pool_bound(b, h, w, c, hidden):
    """x read and out written once (bf16), both matrices (bf16), the f32
    vectors; the two products (4 * B * H * W * C * hidden)."""
    m = b * h * w
    nbytes = 2 * (2 * m * c + 2 * c * hidden) + 4 * (7 * c + hidden)
    return bound(nbytes, 4 * m * c * hidden)


def pool_traffic_bound(b, h, w, c, hidden):
    """(ms, what bounds it) of poolformer_block's five-launch form, whose
    intermediates cross device memory: x read three times (GN1's two
    passes, the pool; bf16), x1 written once and read three times (GN2's
    second pass, fc1, fc2; f32: the pool takes its first pass), h written
    and read once (bf16), out written once; the matrices and vectors once;
    the two products."""
    m = b * h * w
    nbytes = (2 * m * c * 3 + 4 * m * c * 4 + 2 * 2 * m * hidden
              + 2 * m * c + 2 * 2 * c * hidden + 4 * (7 * c + hidden))
    return bound(nbytes, 4 * m * c * hidden)


def phase_pool_kernel(report, gpu_line):
    import torch
    import torch.nn.functional as F

    from tfimm_tpu_torch.ops.kernels.poolformer_block import (
        poolformer_block,
        poolformer_block_reference,
    )

    worst = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[1]
        for i, (b, h, w, c, hid) in enumerate(POOL_STAGES + POOL_EDGES):
            args = pool_inputs(b, h, w, c, hid, dtype, 2100 + i)
            what = f"{dname:8s} B={b} {h}x{w}x{c} hidden={hid}"
            got = poolformer_block(*args)
            ref = poolformer_block_reference(*args)
            torch.cuda.synchronize()
            err, bar, ok = held(got, ref, POOL_TOL[dname])
            bodies = gemm_bodies(
                "poolformer_block", lambda: poolformer_block(*args),
                wgmma=dtype == torch.bfloat16 and i < len(POOL_STAGES))
            print(f"poolformer_block {what}: max_abs_err={err!r} bar={bar!r} "
                  f"{'ok' if ok else 'FAIL'}; {bodies_line(bodies)}",
                  flush=True)
            check(ok, f"poolformer_block disagrees with its plain version "
                  f"({what}): {err} > {bar}")
            if dtype == torch.bfloat16 and i < len(POOL_STAGES):
                worst = max(worst, err)
            if dtype == torch.bfloat16 and i == 0:
                # Control: the plain version without the token mixer's
                # layer scale (ls1 = 1) must miss the bar.
                far = (got.float() - poolformer_block_reference(
                    *args[:3], torch.ones_like(args[3]), *args[4:]).float())
                far = far.abs().max().item()
                print(f"poolformer_block control {what}: ls1 = 1 off by "
                      f"{far!r}, {far / bar!r} bars", flush=True)
                check(far > CONTROL_FACTOR * bar, "poolformer_block: the "
                      "plain version without ls1 stays within the bar")
            del args, got, ref
    report["max_abs_err"] = worst

    # Per stage shape, then per request: back to back (in L2) and out of
    # L2 (cold_ms), each launch out of L2 by the profiler, the fused bound
    # and the five-launch form's traffic bound, the cuBLAS floor both ways.
    keys = ("ms", "cold_ms", "plain_ms", "cublas_floor_ms",
            "cublas_floor_cold_ms", "bound_ms", "traffic_bound_ms")
    totals = dict.fromkeys(keys, 0.0)
    launch_totals = {part: 0.0 for part, _ in CONVNEXT_LAUNCH_PARTS[
        "poolformer_block"]}
    bound_by = {}
    stages = {}
    for (b, h, w, c, hid), depth in zip(POOL_STAGES, POOL_DEPTHS):
        args = pool_inputs(b, h, w, c, hid, torch.bfloat16, 2200)
        m = b * h * w
        z = torch.randn(m, c, device="cuda").to(torch.bfloat16)
        hidden = torch.randn(m, hid, device="cuda").to(torch.bfloat16)
        w1, w2 = args[6], args[8]
        stage = f"poolformer_block bf16 {b}x{h}x{w}x{c}"

        def call():
            return poolformer_block(*args)

        t = {"ms": cuda_time_ms(call), "cold_ms": cold_ms(call),
             "plain_ms": cuda_time_ms(
                 lambda: poolformer_block_reference(*args), iters=5),
             "fc1_ms": cuda_time_ms(lambda: F.linear(z, w1)),
             "fc2_ms": cuda_time_ms(lambda: F.linear(hidden, w2)),
             "cublas_floor_cold_ms": (cold_ms(lambda: F.linear(z, w1))
                                      + cold_ms(lambda: F.linear(hidden,
                                                                 w2)))}
        t["cublas_floor_ms"] = t["fc1_ms"] + t["fc2_ms"]
        t["bound_ms"], by = pool_bound(b, h, w, c, hid)
        t["traffic_bound_ms"], tby = pool_traffic_bound(b, h, w, c, hid)
        bound_by[by] = bound_by.get(by, 0.0) + depth * t["bound_ms"]
        for key, what in (("ms", "kernel back to back"),
                          ("cold_ms", "kernel out of L2"), ("plain_ms", "plain"),
                          ("cublas_floor_ms", "cuBLAS floor back to back"),
                          ("cublas_floor_cold_ms", "cuBLAS floor out of L2")):
            print(f"{stage}: {what} {t[key]!r} ms, "
                  f"{t['bound_ms'] / t[key]!r} of the bound, "
                  f"{t['traffic_bound_ms'] / t[key]!r} of the five-launch "
                  f"form's bound", flush=True)
        events = cold_device_events(call, need=launch_keys("poolformer_block"))
        bodies = gemm_bodies("poolformer_block", events=events, wgmma=True)
        print(f"{stage}: F.linear fc1 {t['fc1_ms']!r} ms, fc2 {t['fc2_ms']!r} "
              f"ms; bound {t['bound_ms']!r} ms ({by}); the five-launch form's "
              f"bound {t['traffic_bound_ms']!r} ms ({tby}); {depth} blocks a "
              f"request; {bodies_line(bodies)}", flush=True)
        for part, ms in cold_launch_parts(call, "poolformer_block",
                                          events=events).items():
            print(f"{stage}: launch {part} {ms!r} ms out of L2 (profiler)",
                  flush=True)
            launch_totals[part] += depth * ms
        for key in keys:
            totals[key] += depth * t[key]
        stages[stage] = {k: t[k] for k in ("ms", "cold_ms")}
        del args, z, hidden
    report.update(totals)
    report["bound_by"] = max(bound_by, key=bound_by.get)
    report["library_ms"] = None
    report["launch_cold_ms"] = launch_totals
    report["stages"] = stages
    print(f"poolformer_block per {POOLFORMER} bs{BATCH} request "
          f"({sum(POOL_DEPTHS)} calls): kernel {totals['ms']!r} ms back to "
          f"back, {totals['cold_ms']!r} ms out of L2; plain "
          f"{totals['plain_ms']!r} ms; cuBLAS floor "
          f"{totals['cublas_floor_ms']!r} / {totals['cublas_floor_cold_ms']!r} "
          f"ms; bound {totals['bound_ms']!r} ms ({report['bound_by']}); the "
          f"five-launch form's bound {totals['traffic_bound_ms']!r} ms; on "
          f"{gpu_line}", flush=True)
    for part, ms in launch_totals.items():
        print(f"poolformer_block per {POOLFORMER} bs{BATCH} request: launch "
              f"{part} {ms!r} ms out of L2 (profiler)", flush=True)


def cold_ms(fn, calls: int = 10, warmup: int = 2) -> float:
    """Device time of one call of ``fn`` with its operands out of L2: before
    each call a write of L2_FLUSH_BYTES evicts the 50 MB L2 (and lets the
    host enqueue the call ahead of the device); CUDA events around the call
    alone; the median over ``calls``."""
    import torch

    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                        device="cuda")
    for _ in range(warmup):
        fn()
    events = []
    for _ in range(calls):
        flush.fill_(1.0)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def convnext_block_inputs(b, h, w, c, hidden, dtype, seed):
    """Seeded inputs of ``convnext_block`` on the card: x normal, the taps of
    a unit-size output, the LN weight and gamma near 1, the MLP scaled to
    unit-size products."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape, scale=1.0, shift=0.0):
        return torch.randn(*shape, generator=g, device="cuda") * scale + shift

    near_one = dict(scale=0.1, shift=1.0)
    return (rnd(b, h, w, c).to(dtype), rnd(c, 1, 7, 7, scale=0.2),
            rnd(c, scale=0.1), rnd(c, **near_one), rnd(c, scale=0.1),
            rnd(hidden, c, scale=c ** -0.5).to(dtype), rnd(hidden, scale=0.1),
            rnd(c, hidden, scale=hidden ** -0.5).to(dtype), rnd(c, scale=0.1),
            rnd(c, **near_one))


def convnext_block_bound(b, h, w, c, hidden):
    """(ms, what bounds it): x read and out written once (bf16), the two
    matrices (bf16), the f32 taps and vectors; the two products on the
    tensor cores (4 * M * C * hidden at the bf16 peak) and the 49 taps on
    the CUDA cores (98 * M * C at the f32 peak); the largest of the three."""
    m = b * h * w
    nbytes = 2 * (2 * m * c + 2 * c * hidden) + 4 * (54 * c + hidden)
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = max(4 * m * c * hidden / PEAK_BF16_FLOPS,
                98 * m * c / PEAK_F32_FLOPS) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def per_op_convnext_block(x, dw, dw_b, ln_w, ln_b, w1, b1, w2, b2, gamma):
    """The library's block, one PyTorch call an op: cuDNN's depthwise conv
    on the channels-last view, F.layer_norm, F.linear, the tanh F.gelu,
    F.linear, the scale and the residual, all in x's dtype."""
    import torch.nn.functional as F

    c = x.shape[-1]
    d = F.conv2d(x.permute(0, 3, 1, 2), dw, dw_b, padding=3, groups=c)
    z = F.layer_norm(d.permute(0, 2, 3, 1), (c,), ln_w, ln_b, 1e-6)
    hid = F.gelu(F.linear(z, w1, b1), approximate="tanh")
    return x + gamma * F.linear(hid, w2, b2)


def default_convnext_block(x, dw, dw_b, ln_w, ln_b, w1, b1, w2, b2, gamma):
    """The default path of a ConvNeXt block at inference: cuDNN's depthwise
    conv in x's dtype, then the convnext_mlp kernel."""
    import torch.nn.functional as F

    from tfimm_tpu_torch.ops.kernels.convnext_mlp import convnext_mlp

    c = x.shape[-1]
    d = F.conv2d(x.permute(0, 3, 1, 2), dw.to(x.dtype), dw_b.to(x.dtype),
                 padding=3, groups=c).permute(0, 2, 3, 1)
    return convnext_mlp(d.reshape(-1, c), x.reshape(-1, c), ln_w, ln_b, w1,
                        b1, w2, b2, gamma, 1e-6)


def phase_convnext_block_kernel(report, gpu_line):
    """Phase 23: ``convnext_block`` against its plain version, then its
    time at ConvNeXt-B's stage shapes beside the plain version, the per-op
    library block and the default path (cuDNN depthwise + convnext_mlp),
    each with its operands out of L2."""
    import torch
    import torch.nn.functional as F

    from tfimm_tpu_torch.ops.kernels.convnext_block import (
        convnext_block,
        convnext_block_reference,
    )

    checked = [(CONVNEXT_BLOCK_CHECK_BATCH, *shape[1:])
               for shape in CONVNEXT_BLOCK_STAGES] + CONVNEXT_BLOCK_EDGES
    worst = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[1]
        for i, (b, h, w, c, hid) in enumerate(checked):
            args = convnext_block_inputs(b, h, w, c, hid, dtype, 2300 + i)
            what = f"{dname:8s} B={b} {h}x{w}x{c} hidden={hid}"
            got = convnext_block(*args)
            ref = convnext_block_reference(*args)
            torch.cuda.synchronize()
            err, bar, ok = held(got, ref, CONVNEXT_BLOCK_TOL[dname])
            print(f"convnext_block {what}: max_abs_err={err!r} bar={bar!r} "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            check(ok, f"convnext_block disagrees with its plain version "
                  f"({what}): {err} > {bar}")
            if dtype == torch.bfloat16 and i < len(CONVNEXT_BLOCK_STAGES):
                worst = max(worst, err)
            if dtype == torch.bfloat16 and i == 0:
                # Control: the plain version with the depthwise weight
                # flipped in H must miss the bar.
                flipped = (args[0], args[1].flip(2), *args[2:])
                far = (got.float() - convnext_block_reference(*flipped).float())
                far = far.abs().max().item()
                print(f"convnext_block control {what}: taps flipped in H off "
                      f"by {far!r}, {far / bar!r} bars", flush=True)
                check(far > CONTROL_FACTOR * bar, "convnext_block: the plain "
                      "version with flipped taps stays within the bar")
            del args, got, ref
    report["max_abs_err"] = worst

    keys = ("ms", "plain_ms", "library_ms", "default_path_ms", "bound_ms",
            "dw_ln_ms", "cudnn_depthwise_ms", "cudnn_depthwise_call_ms",
            "cudnn_depthwise_events_ms")
    totals = dict.fromkeys(keys, 0.0)
    bound_by = {}
    for (b, h, w, c, hid), depth in zip(CONVNEXT_BLOCK_STAGES, CONVNEXT_DEPTHS):
        args = convnext_block_inputs(b, h, w, c, hid, torch.bfloat16, 2400)
        lib_args = (args[0], args[1].to(torch.bfloat16),
                    *(t.to(torch.bfloat16) for t in args[2:]))
        t = {"ms": cold_ms(lambda: convnext_block(*args)),
             "plain_ms": cold_ms(lambda: convnext_block_reference(*args),
                                 calls=3, warmup=1),
             "library_ms": cold_ms(lambda: per_op_convnext_block(*lib_args)),
             "default_path_ms": cold_ms(
                 lambda: default_convnext_block(*args))}
        x_nchw, dw = args[0].permute(0, 3, 1, 2), lib_args[1]

        def conv():
            return F.conv2d(x_nchw, dw, lib_args[2], padding=3, groups=c)

        # cuDNN's depthwise conv measured as the launch it is held against
        # is: its kernel's device time, by the profiler. Besides, the whole
        # call's kernels (F.conv2d adds the bias in a launch of its own)
        # and CUDA events around each call.
        conv_kernels = cold_call_kernels(conv, need=[CUDNN_CONV_KEYS])
        t["cudnn_depthwise_ms"] = sum(
            ms for name, ms in conv_kernels.items()
            if any(k in name for k in CUDNN_CONV_KEYS))
        check(t["cudnn_depthwise_ms"] > 0, "convnext_block: no cuDNN "
              "convolution kernel in the profile of F.conv2d")
        t["cudnn_depthwise_call_ms"] = sum(conv_kernels.values())
        t["cudnn_depthwise_events_ms"] = cold_ms(conv)
        for name, ms in conv_kernels.items():
            print(f"convnext_block bf16 {b}x{h}x{w}x{c}: cuDNN's depthwise "
                  f"conv launches {name[:120]} {ms!r} ms out of L2 "
                  f"(profiler)", flush=True)
        parts = cold_launch_parts(lambda: convnext_block(*args),
                                  "convnext_block")
        t["dw_ln_ms"] = parts["depthwise + LayerNorm"]
        for part, ms in parts.items():
            print(f"convnext_block bf16 {b}x{h}x{w}x{c}: launch {part} "
                  f"{ms!r} ms out of L2 (profiler)", flush=True)
        t["bound_ms"], by = convnext_block_bound(b, h, w, c, hid)
        bound_by[by] = bound_by.get(by, 0.0) + depth * t["bound_ms"]
        for key, what in (("ms", "kernel"), ("plain_ms", "plain"),
                          ("library_ms", "per-op library block"),
                          ("default_path_ms", "default path (cuDNN "
                           "depthwise + convnext_mlp)")):
            print(f"convnext_block bf16 {b}x{h}x{w}x{c}: {what} {t[key]!r} "
                  f"ms, {t['bound_ms'] / t[key]!r} of the bound", flush=True)
        print(f"convnext_block bf16 {b}x{h}x{w}x{c}: its depthwise + "
              f"LayerNorm launch {t['dw_ln_ms']!r} ms, cuDNN's depthwise "
              f"conv kernel {t['cudnn_depthwise_ms']!r} ms (both profiler "
              f"device time); the F.conv2d call with its bias add "
              f"{t['cudnn_depthwise_call_ms']!r} ms (profiler), "
              f"{t['cudnn_depthwise_events_ms']!r} ms (CUDA events)",
              flush=True)
        print(f"convnext_block bf16 {b}x{h}x{w}x{c}: bound {t['bound_ms']!r} "
              f"ms ({by}); {depth} blocks a request", flush=True)
        for key in keys:
            totals[key] += depth * t[key]
        del args, lib_args
    report.update(totals)
    report["bound_by"] = max(bound_by, key=bound_by.get)
    print(f"convnext_block per {CONVNEXT} bs{BATCH} request "
          f"({sum(CONVNEXT_DEPTHS)} calls, operands out of L2): kernel "
          f"{totals['ms']!r} ms, plain {totals['plain_ms']!r} ms, per-op "
          f"library block {totals['library_ms']!r} ms, default path "
          f"{totals['default_path_ms']!r} ms, bound {totals['bound_ms']!r} ms "
          f"({report['bound_by']}); its depthwise + LayerNorm launch "
          f"{totals['dw_ln_ms']!r} ms against cuDNN's depthwise conv "
          f"kernel {totals['cudnn_depthwise_ms']!r} ms (both profiler device "
          f"time; the F.conv2d call with its bias add "
          f"{totals['cudnn_depthwise_call_ms']!r} ms, by CUDA events "
          f"{totals['cudnn_depthwise_events_ms']!r} ms); on {gpu_line}",
          flush=True)


def convnext_train_config() -> dict:
    """ConvNeXt-B at batch 64 with the ConvNeXt paper's ImageNet-1K recipe
    as far as train/ takes it (AdamW at weight decay 0.05, label smoothing
    0.1, mixup 0.8, cutmix 1.0, drop path 0.5 for ConvNeXt-B; the paper's lr
    4e-3 at batch 4096 scaled to 6.25e-5 at batch 64), bf16 mixed precision,
    TRAIN_STEPS epochs of one step each on the same 64 synthetic images."""
    data = {"batch_size": CONVNEXT_TRAIN_BATCH,
            "nb_samples": CONVNEXT_TRAIN_BATCH, "input_size": (224, 224),
            "nb_classes": 1000, "seed": 0}
    return {
        "trainer_class": "Trainer",
        "trainer": {"validation_before_training": False,
                    "display_loss_every_it": 1},
        "problem_class": "ClassificationProblem",
        "problem": {"model_class": "ModelFactory",
                    "model": {"model_name": CONVNEXT, "drop_path_rate": 0.5},
                    "optimizer_class": "OptimizerFactory",
                    "optimizer": {"optimizer": "adamw", "weight_decay": 0.05,
                                  "lr_schedule_class": "LRConstFactory",
                                  "lr_schedule": {
                                      "lr": 4e-3 * CONVNEXT_TRAIN_BATCH / 4096}},
                    "mixed_precision": True, "label_smoothing": 0.1,
                    "mixup_alpha": 0.8, "cutmix_alpha": 1.0},
        "train_dataset_class": "SyntheticDataset", "train_dataset": data,
        "timekeeping_class": "Timekeeping",
        "timekeeping": {"nb_epochs": TRAIN_STEPS,
                        "batch_size": CONVNEXT_TRAIN_BATCH,
                        "nb_samples_per_epoch": CONVNEXT_TRAIN_BATCH},
        "device": "cuda",
    }


def phase_convnext_train(reports, gpu_line):
    """Phase 25: ``train.run`` trains ConvNeXt-B at batch 64 in bf16 mixed
    precision. No kernel launches (every block runs per op under autograd,
    as the JAX package's gates decline in training); every loss finite; the
    rate over steps 2-N and the idle share of one profiled step."""
    trainer, steps, counts = run_watched(convnext_train_config())
    problem = trainer.problem
    check(len(steps) == TRAIN_STEPS, f"{len(steps)} ConvNeXt training steps, "
          f"expected {TRAIN_STEPS}")
    for it, (loss, seconds, rose) in enumerate(steps):
        print(f"convnext train step {it}: loss {loss!r}, {seconds!r} s, "
              f"launches {rose}", flush=True)
        check(rose == expected(), f"ConvNeXt step {it} launched {rose}, "
              f"expected no kernel")
        check(math.isfinite(loss), f"ConvNeXt step {it}: loss {loss}")
    check(counts == expected(), f"the ConvNeXt run launched {counts}")
    for name, report in reports.items():
        report["launches_by_path"]["train_convnext"] = counts[name]
    timed = [s for _, s, _ in steps[1:]]
    step_s = sum(timed) / len(timed)
    print(f"train {CONVNEXT} bs{CONVNEXT_TRAIN_BATCH} bf16 mixed precision "
          f"adamw mixup/cutmix drop path 0.5: "
          f"{CONVNEXT_TRAIN_BATCH * len(timed) / sum(timed)!r} img/s "
          f"({len(timed)} steps 2-{TRAIN_STEPS} in {sum(timed) * 1e3!r} ms; "
          f"median step {statistics.median(timed) * 1e3!r} ms, slowest "
          f"{max(timed) * 1e3!r} ms) on {gpu_line}", flush=True)
    batch = next(iter(trainer.train_ds))
    profile_idle(f"{CONVNEXT} train step",
                 lambda: problem.train_step(batch, 0), step_s * 1e3, steps=1)


def flash_inputs(shape, dtype, seed, big=False):
    """Seeded q, k, v (B, H, N, d) normal on the card. With ``big``, query 0
    of every row points along keys 3 and 5, so that two of its scores sit
    near 300, far above the clamp of 80 of ``fused_mha``."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(shape, generator=gen, device="cuda")
               for _ in range(3))
    if big:
        q[..., 0, :] = 300.0 / shape[-1] ** 0.5 * (k[..., 3, :] + k[..., 5, :])
    return [t.to(dtype) for t in (q, k, v)]


def flash_bound(b, h, n, d, backward=False):
    """(ms, what bounds it) of the flash forward (q, k, v read, out and the
    f32 lse written; q k^T and p v) or backward (qs, k, v, out, do and the
    lse read, dq, dk, dv written; its five products), in bf16."""
    rows = b * h
    if backward:
        return bound(2 * 8 * rows * n * d + 4 * rows * n,
                     10 * rows * n * n * d)
    return bound(2 * 4 * rows * n * d + 4 * rows * n, 4 * rows * n * n * d)


def clamped_attention(q, k, v, scale):
    """The attention of ``fused_mha``'s plain version on (..., N, d): the
    clamped no-max softmax in f32 (the control of phase 26)."""
    import torch

    from tfimm_tpu_torch.ops.kernels.dispatch import softmax_nomax
    from tfimm_tpu_torch.ops.kernels.flash_attention import scale_query

    s = torch.matmul(scale_query(q, scale).float(),
                     k.float().transpose(-1, -2))
    return torch.matmul(softmax_nomax(s), v.float())


def clamped_bwd(qs, k, v, do):
    """dq, dk, dv of the clamped no-max softmax with its mask (the backward
    of ``fused_mha``'s plain version) from the scaled q, in f32: the control
    of phase 27."""
    import torch

    from tfimm_tpu_torch.ops.kernels.dispatch import (
        softmax_clamp_grad_mask,
        softmax_nomax,
    )

    qs, k, v, do = (t.float() for t in (qs, k, v, do))
    s = torch.matmul(qs, k.transpose(-1, -2))
    p = softmax_nomax(s)
    dp = torch.matmul(do, v.transpose(-1, -2))
    ds = softmax_clamp_grad_mask(
        s, p * (dp - (dp * p).sum(dim=-1, keepdim=True)))
    return (torch.matmul(ds, k), torch.matmul(ds.transpose(-1, -2), qs),
            torch.matmul(p.transpose(-1, -2), do))


def sdpa_flash(fn):
    """``fn()`` with ``F.scaled_dot_product_attention`` held to its flash
    backend."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
        return fn()


def phase_flash_kernel(report, gpu_line):
    """Phase 26: ``flash_attention`` against its plain version, the
    control, the packed route, then the times."""
    import torch
    import torch.nn.functional as F

    from tfimm_tpu_torch.ops.kernels.flash_attention import (
        flash_attention,
        flash_attention_packed,
        flash_attention_reference,
        flash_attention_with_lse,
    )

    cases = [(shape, False) for shape in
             [FLASH_SHAPE, FLASH_SAM_SHAPE, *FLASH_EDGES]]
    cases.append((FLASH_BIG, True))
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[1]
        for i, (shape, big) in enumerate(cases):
            q, k, v = flash_inputs(shape, dtype, 2600 + i, big)
            what = f"{dname:8s} (B, H, N, d)={shape}{' big' if big else ''}"
            out, lse = flash_attention_with_lse(q, k, v)
            ref, ref_lse = flash_attention_reference(q, k, v)
            torch.cuda.synchronize()
            err, bar, ok = held(out, ref, FLASH_TOL[dname])
            lerr, lbar, lok = held(lse, ref_lse, FLASH_LSE_TOL)
            note = ""
            if big:
                top = ref_lse[..., 0].min().item()
                far = (out.float() - clamped_attention(
                    q, k, v, shape[-1] ** -0.5)).abs().max().item()
                ok = ok and top > 100.0 and far > CONTROL_FACTOR * bar
                note = (f" (row 0's lse {top!r}; the clamped softmax off by "
                        f"{far!r}, {far / bar!r} bars)")
            print(f"flash_attention {what}: max_abs_err={err!r} bar={bar!r}; "
                  f"lse max_abs_err={lerr!r} bar={lbar!r}{note} "
                  f"{'ok' if ok and lok else 'FAIL'}", flush=True)
            check(ok and lok, f"flash_attention disagrees with its plain "
                  f"version ({what}): {err} > {bar} or lse {lerr} > {lbar}")
            if dtype == torch.bfloat16 and i == 0:
                report["max_abs_err"] = err
            del q, k, v, out, lse, ref, ref_lse

    b, h, n, d = FLASH_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(2690)
    qkv = torch.randn(4, n, 3 * h * d, generator=gen,
                      device="cuda").to(torch.bfloat16)
    parts = qkv.view(4, n, 3, h, d).permute(2, 0, 3, 1, 4).contiguous()
    got = flash_attention_packed(qkv, h, d ** -0.5)
    want = flash_attention(*parts).transpose(1, 2).reshape(4, n, h * d)
    check(torch.equal(got, want), "flash_attention: the packed route "
          "differs from contiguous copies")
    print("flash_attention packed qkv (4, 1025, 3 x 12 x 64): equal to "
          "contiguous copies ok", flush=True)

    for shape in (FLASH_SHAPE, FLASH_SAM_SHAPE):
        q, k, v = flash_inputs(shape, torch.bfloat16, 2650)
        times = {
            "ms": cold_ms(lambda: flash_attention(q, k, v)),
            "plain_ms": cold_ms(lambda: flash_attention_reference(q, k, v),
                                calls=3, warmup=1),
            "library_ms": cold_ms(lambda: sdpa_flash(
                lambda: F.scaled_dot_product_attention(q, k, v))),
        }
        times["bound_ms"], times["bound_by"] = flash_bound(*shape)
        warm_ms = cuda_time_ms(lambda: flash_attention(q, k, v))
        library_warm_ms = cuda_time_ms(lambda: sdpa_flash(
            lambda: F.scaled_dot_product_attention(q, k, v)))
        lib_err = (sdpa_flash(lambda: F.scaled_dot_product_attention(q, k, v))
                   .float() - flash_attention_reference(q, k, v)[0].float()
                   ).abs().max().item()
        if shape == FLASH_SHAPE:
            report.update(times)
        else:
            report["sam_global"] = times
        print(f"flash_attention bf16 (B, H, N, d) = {shape}, operands out of "
              f"L2: kernel {times['ms']!r} ms, {times['bound_ms'] / times['ms']!r}"
              f" of the bound {times['bound_ms']!r} ms ({times['bound_by']}); "
              f"plain {times['plain_ms']!r} ms; scaled_dot_product_attention "
              f"(flash backend) {times['library_ms']!r} ms (its max abs diff "
              f"to plain {lib_err!r}); back to back: kernel {warm_ms!r} ms, "
              f"{times['bound_ms'] / warm_ms!r} of the bound, SDPA (flash "
              f"backend) {library_warm_ms!r} ms; on {gpu_line}", flush=True)
        del q, k, v


def phase_flash_bwd_kernel(report, gpu_line):
    """Phase 27: ``flash_attention_bwd`` against its plain version, the
    control, determinism, then the times."""
    import torch
    import torch.nn.functional as F

    from tfimm_tpu_torch.ops.kernels.flash_attention import (
        flash_attention_bwd,
        flash_attention_bwd_reference,
        flash_attention_with_lse,
        scale_query,
    )

    def case(shape, dtype, seed, big=False):
        q, k, v = flash_inputs(shape, dtype, seed, big)
        out, lse = flash_attention_with_lse(q, k, v)
        gen = torch.Generator(device="cuda").manual_seed(seed + 1)
        do = torch.randn(out.shape, generator=gen, device="cuda").to(dtype)
        return scale_query(q, shape[-1] ** -0.5), k, v, out, lse, do

    cases = [(shape, False) for shape in
             [FLASH_TRAIN_SHAPE, FLASH_SAM_SHAPE, *FLASH_EDGES]]
    cases.append((FLASH_BIG, True))
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[1]
        for i, (shape, big) in enumerate(cases):
            args = case(shape, dtype, 2700 + 2 * i, big)
            what = f"{dname:8s} (B, H, N, d)={shape}{' big' if big else ''}"
            got = flash_attention_bwd(*args)
            want = flash_attention_bwd_reference(*args)
            torch.cuda.synchronize()
            errs, bars, ok = [], [], True
            for name, g, w in zip(("dq", "dk", "dv"), got, want):
                err, bar, good = held(g, w, FLASH_BWD_TOL[dname])
                if shape[2] == 1 and name != "dv":
                    # One key: p = 1, so dq and dk are 0, and both versions
                    # give the rounding noise of dp - delta.
                    bar = FLASH_ZERO_GRAD_TOL * want[2].float().abs().max().item()
                    good = err <= bar and bool(torch.isfinite(g).all())
                errs.append(err)
                bars.append(bar)
                ok = ok and good
            note = ""
            if big:
                far = max((g.float() - c).abs().max().item() / bar
                          for g, c, bar in zip(got, clamped_bwd(*args[:3],
                                                                args[5]),
                                               bars))
                ok = ok and far > CONTROL_FACTOR
                note = f" (the clamped softmax's backward off by {far!r} bars)"
            print(f"flash_attention_bwd {what}: dq, dk, dv max_abs_err="
                  f"{errs!r} bars={bars!r}{note} {'ok' if ok else 'FAIL'}",
                  flush=True)
            check(ok, f"flash_attention_bwd disagrees with its plain version "
                  f"({what}): {errs} > {bars}")
            if dtype == torch.bfloat16 and i == 0:
                report["max_abs_err"] = max(errs)
                again = flash_attention_bwd(*args)
                check(all(torch.equal(a, b_) for a, b_ in zip(got, again)),
                      "flash_attention_bwd: two calls differ")
            del args, got, want

    for shape in (FLASH_TRAIN_SHAPE, FLASH_SAM_SHAPE):
        args = case(shape, torch.bfloat16, 2750)
        q, k, v = (t.detach().clone().requires_grad_() for t in
                   flash_inputs(shape, torch.bfloat16, 2750))
        out = sdpa_flash(lambda: F.scaled_dot_product_attention(q, k, v))
        times = {
            "ms": cold_ms(lambda: flash_attention_bwd(*args)),
            "plain_ms": cold_ms(lambda: flash_attention_bwd_reference(*args),
                                calls=3, warmup=1),
            "library_ms": cold_ms(lambda: torch.autograd.grad(
                out, (q, k, v), args[5], retain_graph=True)),
        }
        times["warm_ms"] = cuda_time_ms(lambda: flash_attention_bwd(*args))
        times["library_warm_ms"] = cuda_time_ms(lambda: torch.autograd.grad(
            out, (q, k, v), args[5], retain_graph=True))
        times["bound_ms"], times["bound_by"] = flash_bound(*shape,
                                                           backward=True)
        b, h, n, d = shape
        recompute_ms = 14 * b * h * n * n * d / PEAK_BF16_FLOPS * 1e3
        if shape == FLASH_TRAIN_SHAPE:
            report.update(times)
        else:
            report["sam_global"] = times
        print(f"flash_attention_bwd bf16 (B, H, N, d) = {shape}, operands out "
              f"of L2: kernel (two launches) {times['ms']!r} ms, "
              f"{times['bound_ms'] / times['ms']!r} of the bound "
              f"{times['bound_ms']!r} ms ({times['bound_by']}; the two "
              f"launches' seven products {recompute_ms!r} ms); plain "
              f"{times['plain_ms']!r} ms; scaled_dot_product_attention's "
              f"flash backward {times['library_ms']!r} ms; back to back: "
              f"kernel {times['warm_ms']!r} ms, "
              f"{times['bound_ms'] / times['warm_ms']!r} of the bound, "
              f"SDPA's flash backward {times['library_warm_ms']!r} ms; on "
              f"{gpu_line}", flush=True)
        del args, q, k, v, out


def phase_vit512_slice(reports, gpu_line):
    """Phase 28: ViT-B/16 at 512x512 serving through flash attention, the
    position table resized at each call."""
    import torch

    import tfimm_tpu_torch as tfm
    from tfimm_tpu_torch.ops.kernels import dispatch

    model = tfm.create_model(VIT512, interpolate_input=True, device="cuda",
                             dtype=torch.bfloat16, seed=0)
    sd = seeded_state_dict(model, seed=28)
    model.load_state_dict(sd)
    pp = tfm.create_preprocessing(VIT512, dtype=torch.bfloat16, device="cuda")
    check(model.cfg.grid_size == (24, 24), f"{VIT512} grid {model.cfg.grid_size}")
    g = torch.Generator(device="cuda").manual_seed(28)
    requests = [torch.randint(0, 256, (VIT512_BATCH, *VIT512_SIZE, 3),
                              generator=g, device="cuda", dtype=torch.uint8)
                for _ in range(REQUESTS)]
    torch.cuda.synchronize()
    dispatch.reset_launch_counts()
    seconds, logits = family_requests(model, pp, requests, VIT512_LAUNCHES,
                                      batch=VIT512_BATCH)
    counts = dict(dispatch.launch_counts)
    check(counts == expected(**{k: REQUESTS * n
                                for k, n in VIT512_LAUNCHES.items()}),
          f"the {VIT512} 512x512 run launched {counts}")
    for name, report in reports.items():
        report["launches_by_path"]["serve_vit512"] = counts[name]
    img_s = [VIT512_BATCH / t for t in seconds[1:]]
    request_ms = statistics.median(seconds[1:]) * 1e3
    print(f"slice {VIT512} interpolate_input 512x512 (N = 1025) "
          f"bs{VIT512_BATCH} bf16: request seconds {seconds!r}", flush=True)
    print(f"slice {VIT512} 512x512 bs{VIT512_BATCH} bf16: "
          f"{statistics.median(img_s)!r} img/s (median of requests "
          f"2-{REQUESTS}; range {min(img_s)!r}-{max(img_s)!r}), launches a "
          f"request {VIT512_LAUNCHES}; on {gpu_line}", flush=True)

    # The same weights in f32 through the plain attention: capturing the
    # attention weights makes every block decline the kernel.
    x = requests[0][:VIT512_CHECK_IMAGES]
    model32 = tfm.create_model(VIT512, interpolate_input=True, device="cuda",
                               dtype=torch.float32, seed=0)
    model32.load_state_dict(sd)
    pp32 = tfm.create_preprocessing(VIT512, dtype=torch.float32, device="cuda")
    with torch.inference_mode():
        (ref, _), rose = launches_of(
            lambda: model32(pp32(x), return_features=True))
    check(rose == expected(), f"the f32 reference launched {rose}")
    got = logits[:VIT512_CHECK_IMAGES].float()
    rel = ((got - ref).abs().max() / ref.abs().max()).item()
    print(f"slice {VIT512} 512x512 logits: bf16 flash path vs f32 plain path "
          f"rel err {rel!r} (bar 5e-2)", flush=True)
    check(rel < 5e-2, f"{VIT512} 512x512 logits rel err {rel} >= 5e-2")
    del model32, ref
    profile_idle(f"{VIT512} 512x512 request",
                 lambda: model.predict(pp(requests[1])), request_ms)


def vit512_train_config() -> dict:
    """ViT-B/16 (the 384 variant's config) built at 512x512, batch 32, bf16
    mixed precision, AdamW at lr 1e-4, TRAIN_STEPS epochs of one step each
    on the same 32 synthetic images."""
    config = train_config()
    data = dict(config["train_dataset"], batch_size=VIT512_TRAIN_BATCH,
                nb_samples=VIT512_TRAIN_BATCH, input_size=VIT512_SIZE)
    config["train_dataset"] = data
    config["problem"]["model"] = {"model_name": VIT512,
                                  "input_size": VIT512_SIZE}
    config["timekeeping"] = {"nb_epochs": TRAIN_STEPS,
                             "batch_size": VIT512_TRAIN_BATCH,
                             "nb_samples_per_epoch": VIT512_TRAIN_BATCH}
    return config


def phase_vit512_train(reports, gpu_line):
    """Phase 29: ``train.run`` trains ViT-B/16 at 512x512 through the flash
    kernels; a seeded step against f32 through the plain attention."""
    import torch

    from tfimm_tpu_torch.parallel.step import cross_entropy_loss

    trainer, steps, counts = run_watched(vit512_train_config())
    problem = trainer.problem
    check(problem.model.cfg.grid_size == (32, 32),
          f"grid {problem.model.cfg.grid_size}")
    check(len(steps) == TRAIN_STEPS, f"{len(steps)} training steps")
    for it, (loss, seconds, rose) in enumerate(steps):
        print(f"vit512 train step {it}: loss {loss!r}, {seconds!r} s, "
              f"launches {rose}", flush=True)
        check(rose == expected(**VIT512_TRAIN_LAUNCHES),
              f"step {it} launched {rose}, expected {VIT512_TRAIN_LAUNCHES}")
        check(math.isfinite(loss), f"step {it}: loss {loss}")
    check(steps[-1][0] < steps[0][0],
          f"the loss did not fall: {steps[0][0]} -> {steps[-1][0]}")
    for name, report in reports.items():
        report["launches_by_path"]["train_vit512"] = counts[name]
    timed = [s for _, s, _ in steps[1:]]
    step_s = sum(timed) / len(timed)
    print(f"train {VIT512} 512x512 bs{VIT512_TRAIN_BATCH} bf16 mixed "
          f"precision adamw: {VIT512_TRAIN_BATCH * len(timed) / sum(timed)!r} "
          f"img/s ({len(timed)} steps 2-{TRAIN_STEPS} in "
          f"{sum(timed) * 1e3!r} ms; median step "
          f"{statistics.median(timed) * 1e3!r} ms, slowest "
          f"{max(timed) * 1e3!r} ms) on {gpu_line}", flush=True)

    # One seeded step on VIT512_CHECK_IMAGES images: bf16 through the
    # kernels against f32 through the plain attention (capturing the
    # weights makes every block decline the kernels).
    model, pp = problem.model, problem.preprocessing
    model.load_state_dict(seeded_state_dict(model, seed=29))
    model.train()
    images, labels = next(iter(trainer.train_ds))
    images = torch.as_tensor(images[:VIT512_CHECK_IMAGES], device="cuda")
    labels = torch.as_tensor(labels[:VIT512_CHECK_IMAGES], device="cuda")
    names = ("blocks.0.attn.qkv.weight", "pos_embed")

    def loss_and_grads(x, return_features):
        model.zero_grad(set_to_none=True)
        out = model(x, return_features=return_features)
        logits = out[0] if return_features else out
        loss = cross_entropy_loss(logits.float(), labels)
        loss.backward()
        params = dict(model.named_parameters())
        return loss.item(), {n: params[n].grad.float() for n in names}

    (loss_k, grads_k), rose = launches_of(
        lambda: loss_and_grads(pp(images).to(torch.bfloat16), False))
    check(rose == expected(**VIT512_TRAIN_LAUNCHES),
          f"the bf16 step launched {rose}")
    (loss_r, grads_r), rose = launches_of(
        lambda: loss_and_grads(pp(images), True))
    check(rose == expected(), f"the f32 reference launched {rose}")
    rel = abs(loss_k - loss_r) / abs(loss_r)
    print(f"vit512 train loss: bf16 flash path {loss_k!r} vs f32 plain path "
          f"{loss_r!r}, rel err {rel!r} (bar 2e-2)", flush=True)
    check(rel < 2e-2, f"loss rel err {rel} >= 2e-2")
    for name in names:
        ref = grads_r[name]
        rel = ((grads_k[name] - ref).abs().max() / ref.abs().max()).item()
        print(f"vit512 train grad {name}: max|diff| / max|ref| {rel!r} "
              f"(bar 1e-1)", flush=True)
        check(rel < 1e-1, f"{name} gradient rel err {rel} >= 1e-1")
        check(ref.abs().max().item() > 0, f"{name}: zero reference gradient")
    del grads_k, grads_r
    batch = next(iter(trainer.train_ds))
    profile_idle(f"{VIT512} 512x512 train step",
                 lambda: problem.train_step(batch, 0), step_s * 1e3, steps=1)


def phase_float16(reports, gpu_line):
    """Phase 30: float16 models take their plain paths: no launch, each
    within 5e-2 of f32 of the same weights on the card."""
    import torch

    import tfimm_tpu_torch as tfm
    from tfimm_tpu_torch.architectures.segment_anything import SAMPredictor
    from tfimm_tpu_torch.ops.kernels import dispatch

    g = torch.Generator(device="cuda").manual_seed(30)
    images = torch.randint(0, 256, (F16_IMAGES, 224, 224, 3), generator=g,
                           device="cuda", dtype=torch.uint8)
    dispatch.reset_launch_counts()
    with restored_env(F16_SWITCHES[0]), restored_env(F16_SWITCHES[1]), \
            restored_env(F16_SWITCHES[2]):
        for var in F16_SWITCHES:
            os.environ[var] = "1"
        for name in F16_MODELS:
            outs = {}
            for dtype in (torch.float32, torch.float16):
                model = tfm.create_model(name, device="cuda", dtype=dtype,
                                         seed=0)
                model.load_state_dict(seeded_state_dict(model, seed=30))
                pp = tfm.create_preprocessing(name, dtype=dtype,
                                              device="cuda")
                outs[dtype], rose = launches_of(
                    lambda: model.predict(pp(images)))
                torch.cuda.synchronize()
                check(dtype == torch.float32 or rose == expected(),
                      f"{name} float16 launched {rose}")
                del model
            got, want = outs[torch.float16], outs[torch.float32]
            check(got.dtype == torch.float16
                  and bool(torch.isfinite(got).all()),
                  f"{name} float16: non-finite or {got.dtype} logits")
            rel = ((got.float() - want).abs().max() / want.abs().max()).item()
            print(f"float16 {name} (switches on): predict on {F16_IMAGES} "
                  f"images, no launch, rel err to f32 {rel!r} (bar 5e-2)",
                  flush=True)
            check(rel < 5e-2, f"{name} float16 rel err {rel} >= 5e-2")

    embeddings = {}
    for dtype in (torch.float32, torch.float16):
        model = tfm.create_model(SAM, device="cuda", dtype=dtype, seed=0)
        model.load_state_dict(sam_state_dict(model, seed=30))
        predictor = SAMPredictor(model)
        embs = []
        for img in images.cpu().numpy():
            _, rose = launches_of(lambda: predictor.set_image(img))
            embs.append(predictor.image_embedding)
            check(dtype == torch.float32 or rose == expected(),
                  f"{SAM} float16 set_image launched {rose}")
        torch.cuda.synchronize()
        embeddings[dtype] = torch.cat(embs)
        del model, predictor
    got, want = embeddings[torch.float16], embeddings[torch.float32]
    check(bool(torch.isfinite(got).all()), f"{SAM} float16: non-finite")
    rel = ((got.float() - want.float()).abs().max()
           / want.float().abs().max()).item()
    print(f"float16 {SAM}: set_image on {F16_IMAGES} images, no launch, rel "
          f"err to f32 {rel!r} (bar 5e-2)", flush=True)
    check(rel < 5e-2, f"{SAM} float16 rel err {rel} >= 5e-2")
    for name, report in reports.items():
        report["launches_by_path"]["serve_f16"] = 0
    print(f"float16 phase on {gpu_line}", flush=True)


def ln_dense_inputs(m, c, o, dtype, seed, bias=True):
    """Seeded (x, gamma, beta, w, b, g) of ``ln_dense`` on the card: x away
    from zero mean, gamma near 1, w scaled to unit-size outputs, the f32
    vectors, a unit cotangent g."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape, scale=1.0, shift=0.0):
        return torch.randn(*shape, generator=gen, device="cuda") * scale + shift

    return (rnd(m, c, scale=2.0, shift=0.5).to(dtype),
            rnd(c, scale=0.1, shift=1.0), rnd(c, scale=0.1),
            rnd(o, c, scale=c ** -0.5).to(dtype),
            rnd(o, scale=0.1) if bias else None, rnd(m, o).to(dtype))


def ln_dense_bound(m, c, o, backward=False):
    """(ms, what bounds it) in bf16: the forward reads x and w and writes y
    (2 M C O operations); the backward reads x, g and w and writes dx and dW
    (4 M C O); the f32 vectors beside them."""
    if backward:
        nbytes = 2 * (2 * m * c + m * o + 2 * o * c) + 4 * (4 * c + o)
        return bound(nbytes, 4 * m * c * o)
    return bound(2 * (m * c + o * c + m * o) + 4 * (2 * c + o), 2 * m * c * o)


def library_ln_dense(x, gamma, beta, w, b):
    """One eager F.layer_norm + F.linear (cuBLAS) in x's dtype."""
    import torch.nn.functional as F

    dt = x.dtype
    z = F.layer_norm(x, (x.shape[-1],), gamma.to(dt), beta.to(dt),
                     LN_DENSE_EPS)
    return F.linear(z, w, None if b is None else b.to(dt))


def eager_pair(gamma, beta, w, b):
    """(fn, parameters): the port's own eager LayerNorm then Dense in w's
    dtype, as a model cast to it holds them, with these weights."""
    import torch

    from tfimm_tpu_torch.ops.basic import Dense
    from tfimm_tpu_torch.ops.norm import LayerNorm

    norm = LayerNorm(w.shape[1], eps=LN_DENSE_EPS)
    dense = Dense(w.shape[1], w.shape[0], use_bias=b is not None)
    norm, dense = (mod.to(device="cuda", dtype=w.dtype) for mod in (norm, dense))
    with torch.no_grad():
        for p, v in zip([*norm.parameters(), *dense.parameters()],
                        (gamma, beta, w, b)):
            p.copy_(v)
    return (lambda x: dense(norm(x)),
            [*norm.parameters(), *dense.parameters()])


def ln_dense_bwd_body_expected(dtype, c, o) -> str:
    """The body ``tma.ln_dense_bwd_route`` sends a backward with contiguous
    16-byte aligned operands (every case here) to."""
    import torch

    from tfimm_tpu_torch.ops.kernels.tma import LN_BWD_MAX_DIM

    return "wgmma" if (dtype == torch.bfloat16 and c % 8 == 0 and o % 8 == 0
                       and c <= LN_BWD_MAX_DIM) else "first"


def backward_of(fn, x, params, g):
    """A closure that runs the autograd backward alone of ``fn(x)`` with
    respect to x and ``params`` (the graph is built once and kept)."""
    import torch

    leaves = [x.detach().clone().requires_grad_(), *params]
    y = fn(leaves[0])
    return lambda: torch.autograd.grad(y, leaves, g, retain_graph=True)


def phase_ln_dense_kernel(reports, gpu_line):
    """Phase 31: ``ln_dense`` and its backward against their plain
    versions, each backward's body read from one profile of them all; then
    the times, with the backward's launches and the library backward's
    device time from one more profile."""
    import torch

    from tfimm_tpu_torch.ops.kernels.ln_dense import (
        ln_dense,
        ln_dense_bwd,
        ln_dense_bwd_reference,
        ln_dense_reference,
    )

    cases = [(*shape, True) for shape in LN_DENSE_TRAIN] + LN_DENSE_EDGES
    names = ("dx", "dgamma", "dbeta", "dW", "db")
    calls, expect = {}, {}
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[1]
        for i, (m, c, o, bias) in enumerate(cases):
            x, gamma, beta, w, b, gy = ln_dense_inputs(m, c, o, dtype, 3100 + i,
                                                       bias)
            what = f"{dname:8s} (M, C, O)=({m}, {c}, {o}){'' if bias else ' no bias'}"
            y = ln_dense(x, gamma, beta, w, b, eps=LN_DENSE_EPS)
            ref = ln_dense_reference(x, gamma, beta, w, b, LN_DENSE_EPS)
            torch.cuda.synchronize()
            err, bar, ok = held(y, ref, LN_DENSE_TOL[dname])
            print(f"ln_dense {what}: max_abs_err={err!r} bar={bar!r} "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            check(ok, f"ln_dense disagrees with its plain version ({what}): "
                  f"{err} > {bar}")
            if dtype == torch.bfloat16 and i == 0:
                reports["ln_dense"]["max_abs_err"] = err
            got = ln_dense_bwd(x, gamma, beta, w, gy, bias, LN_DENSE_EPS)
            want = ln_dense_bwd_reference(x, gamma, beta, w, gy, bias,
                                          LN_DENSE_EPS)
            torch.cuda.synchronize()
            check((got[4] is None) == (not bias), f"ln_dense_bwd db ({what})")
            calls[what] = (functools.partial(ln_dense_bwd, x, gamma, beta, w,
                                             gy, bias, LN_DENSE_EPS),
                           1, ("ln_dense_d",))
            expect[what] = ln_dense_bwd_body_expected(dtype, c, o)
            errs = []
            for k, (a, r) in enumerate(zip(got, want)):
                if r is None:
                    continue
                tol = (LN_DENSE_TOL if k == 0 else LN_DENSE_SUM_TOL)[dname]
                err, bar, ok = held(a, r, tol)
                errs.append(err)
                print(f"ln_dense_bwd {what} {names[k]}: max_abs_err={err!r} "
                      f"bar={bar!r} {'ok' if ok else 'FAIL'}", flush=True)
                check(ok, f"ln_dense_bwd {names[k]} disagrees with its plain "
                      f"version ({what}): {err} > {bar}")
            if dtype == torch.bfloat16 and i == 0:
                reports["ln_dense_bwd"]["max_abs_err"] = max(errs)
                again = ln_dense_bwd(x, gamma, beta, w, gy, bias, LN_DENSE_EPS)
                check(all(torch.equal(a, r) for a, r in zip(got, again)),
                      "ln_dense_bwd: two calls differ")
                print(f"ln_dense_bwd {what}: two calls bit-identical ok",
                      flush=True)
            del x, gamma, beta, w, b, gy, y, ref, got, want
    for what, events in profile_cases(calls).items():
        body = body_of(events)
        print(f"ln_dense_bwd {what}: body {body}", flush=True)
        check(body == expect[what], f"ln_dense_bwd ({what}) ran the {body} "
              f"body")
    del calls

    calls, timed = {}, {}
    for backward in (False, True):
        name = "ln_dense_bwd" if backward else "ln_dense"
        shapes = LN_DENSE_TRAIN + ([] if backward else LN_DENSE_SERVE)
        for j, (m, c, o) in enumerate(shapes):
            x, gamma, beta, w, b, gy = ln_dense_inputs(m, c, o, torch.bfloat16,
                                                       3150 + j)
            eager, eager_params = eager_pair(gamma, beta, w, b)
            if backward:
                lib_params = [t.detach().clone().requires_grad_()
                              for t in (gamma, beta, w, b)]
                fns = {
                    "ms": lambda: ln_dense_bwd(x, gamma, beta, w, gy, True,
                                               LN_DENSE_EPS),
                    "plain_ms": lambda: ln_dense_bwd_reference(
                        x, gamma, beta, w, gy, True, LN_DENSE_EPS),
                    "library_ms": backward_of(
                        lambda t: library_ln_dense(t, *lib_params), x,
                        lib_params, gy),
                    "eager_ms": backward_of(eager, x, eager_params, gy),
                }
            else:
                fns = {
                    "ms": lambda: ln_dense(x, gamma, beta, w, b,
                                           eps=LN_DENSE_EPS),
                    "plain_ms": lambda: ln_dense_reference(
                        x, gamma, beta, w, b, LN_DENSE_EPS),
                    "library_ms": lambda: library_ln_dense(x, gamma, beta, w,
                                                           b),
                    "eager_ms": lambda: eager(x),
                }
            with torch.inference_mode(not backward):
                times = {k: cold_ms(fn, calls=3 if k == "plain_ms" else 10,
                                    warmup=1 if k == "plain_ms" else 2)
                         for k, fn in fns.items()}
            times["bound_ms"], times["bound_by"] = ln_dense_bound(m, c, o,
                                                                  backward)
            times["shape"] = (m, c, o)
            if backward:
                what = f"ln_dense_bwd bf16 (M, C, O) = ({m}, {c}, {o})"
                times["host_ms"] = host_ms_per_call(what, fns["ms"])
                calls[what] = (functools.partial(
                    ln_dense_bwd, x, gamma, beta, w, gy, True, LN_DENSE_EPS),
                    3, ("ln_dense_d",))
                calls[what + " library"] = (fns["library_ms"], 3, ())
            if j == 0:
                reports[name].update(times)
            else:
                reports[name].setdefault("shapes", []).append(times)
            if backward:
                timed[what] = reports[name] if j == 0 else times
            print(f"{name} bf16 (M, C, O) = ({m}, {c}, {o}), operands out of "
                  f"L2: kernel {times['ms']!r} ms, "
                  f"{times['bound_ms'] / times['ms']!r} of the bound "
                  f"{times['bound_ms']!r} ms ({times['bound_by']}); plain "
                  f"{times['plain_ms']!r} ms; F.layer_norm + F.linear"
                  f"{' backward' if backward else ''} {times['library_ms']!r} "
                  f"ms; the port's LayerNorm + Dense{' backward' if backward else ''} "
                  f"{times['eager_ms']!r} ms; on {gpu_line}", flush=True)
            del x, gamma, beta, w, b, gy, eager, eager_params, fns

    events = profile_cases(calls)
    for what, times in timed.items():
        times["launch_cold_ms"] = launch_means(events[what], 3)
        for kernel, ms in sorted(times["launch_cold_ms"].items()):
            print(f"{what} launch {kernel[:70]}: {ms!r} ms out of L2 "
                  f"(profiler)", flush=True)
        times["device_ms"] = sum(times["launch_cold_ms"].values())
        times["library_device_ms"] = sum(
            launch_means(events[what + " library"], 3).values())
        print(f"{what}: its launches' device time {times['device_ms']!r} ms "
              f"out of L2, the wrapper's host time {times['host_ms']!r} ms a "
              f"call; F.layer_norm + F.linear backward's device time "
              f"{times['library_device_ms']!r} ms out of L2 (profiler), its "
              f"event time {times['library_ms']!r} ms; on {gpu_line}",
              flush=True)


def phase_ln_dense_vit(reports, gpu_line):
    """Phase 32: ``ln_dense_or_none`` on the real inputs of ViT-B/16's 24
    LayerNorm -> Dense pairs against the blocks' own modules."""
    import torch
    import torch.nn.functional as F

    import tfimm_tpu_torch as tfm
    from tfimm_tpu_torch.ops.kernels import dispatch
    from tfimm_tpu_torch.ops.kernels.ln_dense import ln_dense_or_none

    model = tfm.create_model(MODEL, device="cuda", dtype=torch.bfloat16, seed=0)
    model.load_state_dict(seeded_state_dict(model, seed=32))
    pp = tfm.create_preprocessing(MODEL, dtype=torch.bfloat16, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(32)
    images = torch.randint(0, 256, (LN_DENSE_BATCH, 224, 224, 3),
                           generator=gen, device="cuda", dtype=torch.uint8)
    pairs = []
    with torch.no_grad():
        _, feats = model(pp(images), return_features=True)
        for j, block in enumerate(model.blocks):
            x_in = feats["patch_embedding" if j == 0 else f"block_{j - 1}"]
            x_mid = x_in + block.attn(block.norm1(x_in))
            pairs.append((f"block {j} norm1 -> qkv", x_in, block.norm1,
                          block.attn.qkv))
            pairs.append((f"block {j} norm2 -> fc1", x_mid, block.norm2,
                          block.mlp.fc1))
    del feats
    cots = [torch.randn(*x.shape[:-1], lin.out_features, generator=gen,
                        device="cuda").to(x.dtype) for _, x, _, lin in pairs]
    torch.cuda.synchronize()

    def grads_of(fn, x, params, cot):
        xl = x.detach().clone().requires_grad_()
        for p in params:
            p.grad = None
        y = fn(xl)
        y.backward(cot)
        return y.detach(), [xl.grad] + [p.grad for p in params]

    worst = {"forward": 0.0, "backward": 0.0}
    dispatch.reset_launch_counts()
    for (what, x, norm, lin), cot in zip(pairs, cots):
        params = [norm.weight, norm.bias, lin.weight, lin.bias]
        with dispatch.capture_dispatches() as seen:
            y, got = grads_of(lambda t: ln_dense_or_none(
                t, norm.weight, norm.bias, lin.weight, lin.bias,
                eps=norm.eps), x, params, cot)
        check(seen == {"ln_dense"}, f"{what}: the op dispatched {seen}")
        ye, want = grads_of(lambda t: lin(norm(t)), x, params, cot)
        err, bar, ok = held(y, ye, LN_DENSE_VIT_TOL["forward"])
        worst["forward"] = max(worst["forward"], err / bar)
        check(ok, f"ln_dense at {what}: forward {err} > {bar}")
        for name, a, r in zip(("dx", "dgamma", "dbeta", "dW", "db"), got, want):
            err, bar, ok = held(a, r, LN_DENSE_VIT_TOL["backward"])
            worst["backward"] = max(worst["backward"], err / bar)
            check(ok, f"ln_dense at {what}: {name} {err} > {bar}")
    counts = dict(dispatch.launch_counts)
    check(counts == expected(**LN_DENSE_VIT_LAUNCHES),
          f"the 24 ViT-B/16 pairs launched {counts}")
    for name, report in reports.items():
        report["launches_by_path"]["vit_blocks"] = counts[name]
    print(f"ln_dense at ViT-B/16's 12 blocks (bs{LN_DENSE_BATCH}, bf16, "
          f"seeded weights): 24 pairs against the blocks' eager norm -> "
          f"Dense, worst error in bars: forward {worst['forward']!r} (bar "
          f"{LN_DENSE_VIT_TOL['forward']} of max), five gradients "
          f"{worst['backward']!r} (bar {LN_DENSE_VIT_TOL['backward']}); "
          f"launches {counts['ln_dense']} + {counts['ln_dense_bwd']} ok",
          flush=True)

    x, norm, lin = pairs[0][1], pairs[0][2], pairs[0][3]
    with restored_env("TFIMM_TPU_LN_DENSE"):
        os.environ["TFIMM_TPU_LN_DENSE"] = "0"
        check(ln_dense_or_none(x, norm.weight, norm.bias, lin.weight,
                               lin.bias) is None,
              "TFIMM_TPU_LN_DENSE=0 did not decline")
    print("ln_dense_or_none with TFIMM_TPU_LN_DENSE=0: None ok", flush=True)

    def library(t, norm, lin):
        return F.linear(F.layer_norm(t, (t.shape[-1],), norm.weight,
                                     norm.bias, norm.eps), lin.weight,
                        lin.bias)

    routes = {
        "ms": lambda t, norm, lin: ln_dense_or_none(
            t, norm.weight, norm.bias, lin.weight, lin.bias, eps=norm.eps),
        "eager_ms": lambda t, norm, lin: lin(norm(t)),
        "library_ms": library,
    }
    timed = {}
    for key, route in routes.items():
        def step():
            for (_, x, norm, lin), cot in zip(pairs, cots):
                xl = x.detach().requires_grad_()
                route(xl, norm, lin).backward(cot)
        timed[key] = cuda_time_ms(step, iters=3, repeats=3, warmup=1)
    reports["ln_dense"]["vit_blocks"] = timed
    print(f"ViT-B/16 bs{LN_DENSE_BATCH} bf16, the 24 LayerNorm -> Dense pairs "
          f"forward and backward (parameter gradients accumulating): through "
          f"ln_dense {timed['ms']!r} ms; the blocks' eager LayerNorm + Dense "
          f"{timed['eager_ms']!r} ms; F.layer_norm + F.linear "
          f"{timed['library_ms']!r} ms; on {gpu_line}", flush=True)
    model.zero_grad(set_to_none=True)


def phase_models_api(reports, gpu_line):
    """Phase 33: save/load, create_model from a saved model with the
    position-embedding transfer, and EmbeddingModel, on the card."""
    import tempfile

    import torch

    import tfimm_tpu_torch as tfm
    from tfimm_tpu_torch.ops.kernels import dispatch

    model = tfm.create_model(MODEL, device="cuda", dtype=torch.bfloat16, seed=0)
    model.load_state_dict(seeded_state_dict(model, seed=33))
    pp = tfm.create_preprocessing(MODEL, dtype=torch.bfloat16, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(33)
    x = torch.randint(0, 256, (API_IMAGES, 224, 224, 3), generator=gen,
                      device="cuda", dtype=torch.uint8)
    with tempfile.TemporaryDirectory() as path:
        t0 = time.perf_counter()
        tfm.save_model(model, path)
        t_save = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded = tfm.load_model(path, device="cuda")
        t_load = time.perf_counter() - t0
        check(loaded.pos_embed.dtype == torch.bfloat16,
              f"load_model gave {loaded.pos_embed.dtype}")
        check(torch.equal(model.predict(pp(x)), loaded.predict(pp(x))),
              "the loaded model's logits differ from the saved model's")
        print(f"save_model {MODEL} bf16: {t_save!r} s; load_model to the card "
              f"{t_load!r} s; logits of {API_IMAGES} images equal bit for bit "
              f"ok", flush=True)
        del loaded
        big = tfm.create_model(MODEL, model_path=path, input_size=VIT512_SIZE,
                               device="cuda", dtype=torch.bfloat16)
        big32 = tfm.create_model(MODEL, model_path=path,
                                 input_size=VIT512_SIZE, device="cuda",
                                 dtype=torch.float32)
    check(tuple(big.pos_embed.shape) == (1, 1025, 768),
          f"the transferred position table is {tuple(big.pos_embed.shape)}")
    check(torch.equal(big.blocks[0].attn.qkv.weight,
                      model.blocks[0].attn.qkv.weight),
          "transfer_weights changed a block's weights")
    pp512 = tfm.create_preprocessing(MODEL, dtype=torch.bfloat16, device="cuda")
    requests = [torch.randint(0, 256, (VIT512_BATCH, *VIT512_SIZE, 3),
                              generator=gen, device="cuda", dtype=torch.uint8)
                for _ in range(REQUESTS)]
    torch.cuda.synchronize()
    dispatch.reset_launch_counts()
    seconds, logits = family_requests(big, pp512, requests, VIT512_LAUNCHES,
                                      batch=VIT512_BATCH)
    counts = dict(dispatch.launch_counts)
    check(counts == expected(**{k: REQUESTS * n
                                for k, n in VIT512_LAUNCHES.items()}),
          f"the transferred 512x512 run launched {counts}")
    for name, report in reports.items():
        report["launches_by_path"]["serve_vit512_transferred"] = counts[name]
    img_s = [VIT512_BATCH / t for t in seconds[1:]]
    print(f"create_model({MODEL}, model_path=..., input_size={VIT512_SIZE}) "
          f"bs{VIT512_BATCH} bf16: {statistics.median(img_s)!r} img/s (median "
          f"of requests 2-{REQUESTS}; range {min(img_s)!r}-{max(img_s)!r}), "
          f"launches a request {VIT512_LAUNCHES}; on {gpu_line}", flush=True)
    pp32 = tfm.create_preprocessing(MODEL, dtype=torch.float32, device="cuda")
    with torch.inference_mode():
        (ref, _), rose = launches_of(lambda: big32(
            pp32(requests[0][:VIT512_CHECK_IMAGES]), return_features=True))
    check(rose == expected(), f"the f32 reference launched {rose}")
    rel = ((logits[:VIT512_CHECK_IMAGES].float() - ref).abs().max()
           / ref.abs().max()).item()
    print(f"transferred 512x512 logits: bf16 flash path vs f32 plain path rel "
          f"err {rel!r} (bar 5e-2)", flush=True)
    check(rel < 5e-2, f"transferred 512x512 logits rel err {rel} >= 5e-2")
    del model, big, big32, ref, requests

    backbone = tfm.create_model(CONVNEXT, device="cuda", dtype=torch.bfloat16,
                                seed=0, drop_path_rate=0.0)
    backbone.load_state_dict(seeded_state_dict(backbone, seed=34, std=0.05))
    emb = tfm.EmbeddingModel(backbone, EMBED_DIM).to(device="cuda",
                                                     dtype=torch.bfloat16)
    pp_cnx = tfm.create_preprocessing(CONVNEXT, dtype=torch.bfloat16,
                                      device="cuda")
    images = pp_cnx(torch.randint(0, 256, (BATCH, 224, 224, 3), generator=gen,
                                  device="cuda", dtype=torch.uint8))
    emb.eval()
    dispatch.reset_launch_counts()
    with torch.inference_mode():
        out = emb(images)
    counts = dict(dispatch.launch_counts)
    check(counts == expected(**EMBED_LAUNCHES),
          f"the EmbeddingModel's eval pass launched {counts}")
    for name, report in reports.items():
        report["launches_by_path"]["embed_convnext"] = counts[name]
    check(tuple(out.shape) == (BATCH, EMBED_DIM)
          and bool(torch.isfinite(out).all()),
          f"EmbeddingModel gave {tuple(out.shape)}, finite "
          f"{bool(torch.isfinite(out).all())}")
    raw = torch.randint(0, 256, (BATCH, 224, 224, 3), generator=gen,
                        device="cuda", dtype=torch.uint8)
    seconds = []
    with torch.inference_mode():
        for _ in range(REQUESTS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            emb(pp_cnx(raw))
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
    img_s = [BATCH / t for t in seconds[1:]]
    print(f"EmbeddingModel({CONVNEXT}, {EMBED_DIM}) bs{BATCH} bf16: "
          f"{statistics.median(img_s)!r} img/s (median of requests "
          f"2-{REQUESTS}; range {min(img_s)!r}-{max(img_s)!r}) on {gpu_line}",
          flush=True)
    fc_out = []
    hook = emb.fc.register_forward_hook(lambda m, i, o: fc_out.append(o))
    emb.train()
    with torch.no_grad():
        emb(images[:16])
    hook.remove()
    z = fc_out[0].float()
    n = z.shape[0]
    want_mean = 0.1 * z.mean(dim=0)
    want_var = 0.9 + 0.1 * z.var(dim=0, unbiased=True)
    for what, got, want in (("running_mean", emb.bn.running_mean, want_mean),
                            ("running_var", emb.bn.running_var, want_var)):
        err, bar, ok = held(got, want, 2e-2)
        check(ok, f"EmbeddingModel BatchNorm {what}: {err} > {bar}")
    print(f"EmbeddingModel({CONVNEXT}, {EMBED_DIM}) bf16: eval embeddings "
          f"{tuple(out.shape)} finite, {EMBED_LAUNCHES} launches; a training "
          f"pass on {n} images moved the BatchNorm's running statistics by the "
          f"momentum rule ok", flush=True)

def mha_body(qkv, h, scale) -> str:
    """The body ``fused_mha`` took on ``qkv``: its kernel's name in one
    profiled call (``cold_device_events``, which retakes a profile that
    lost the launch)."""
    from tfimm_tpu_torch.ops.kernels.fused_mha import fused_mha

    events = cold_device_events(lambda: fused_mha(qkv, h, scale), calls=1,
                                need=[("fused_mha_fwd",)])
    names = sorted({name for name, _ in events if "fused_mha_fwd" in name})
    check(len(names) == 1, f"fused_mha launched {names}")
    return names[0]


def phase_pit_mha(report, gpu_line, cases=None):
    """Phase 34 (and 42 at the hybrid's shape, ``cases``): ``fused_mha``
    against its plain version at PiT-B's and PiT-S's stage-1 shapes, bf16
    and f32; the body each took; kernel, plain, bound and SDPA times, back
    to back and out of L2."""
    import torch
    import torch.nn.functional as F

    from tfimm_tpu_torch.ops.kernels.fused_mha import fused_mha, fused_mha_reference

    shapes = report.setdefault("shapes", {})
    for name, (b, n, h, d) in (cases or PIT_MHA_SHAPES).items():
        scale = d ** -0.5
        entry = {"shape": [b, n, h, d]}
        for dtype in (torch.bfloat16, torch.float32):
            tol = TOL[str(dtype).split(".")[1]]
            qkv = mha_input(b, n, h, d, dtype, seed=34)
            out = fused_mha(qkv, h, scale)
            ref = fused_mha_reference(qkv, h, scale)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            ok = (torch.allclose(out.float(), ref.float(), atol=tol, rtol=tol)
                  and bool(torch.isfinite(out).all()))
            print(f"fused_mha {name} {str(dtype):15s} (B, N, H, d) = "
                  f"{(b, n, h, d)}: max_abs_err={err!r} tol={tol} "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            check(ok, f"fused_mha disagrees with its plain version at {name} "
                  f"({dtype}): {err}")
            if dtype != torch.bfloat16:
                continue
            entry["max_abs_err"] = err
            entry["body"] = mha_body(qkv, h, scale)
            check(MHA_BF16_BODY in entry["body"],
                  f"fused_mha at {name} ran {entry['body']}")
            entry["ms"] = cuda_time_ms(lambda: fused_mha(qkv, h, scale))
            entry["plain_ms"] = cuda_time_ms(
                lambda: fused_mha_reference(qkv, h, scale), iters=3, repeats=3)
            entry["bound_ms"], entry["bound_by"] = bound(
                2 * b * n * 4 * h * d, 4 * b * h * n * n * d)
            q, k, v = heads(qkv, h)

            def sdpa_call():
                return F.scaled_dot_product_attention(q, k, v, scale=scale)

            entry["library_ms"] = cuda_time_ms(sdpa_call)
            entry["cold_ms"] = cold_ms(lambda: fused_mha(qkv, h, scale))
            entry["library_cold_ms"] = cold_ms(sdpa_call)
            print(f"fused_mha {name} bf16: body {entry['body']}; kernel "
                  f"{entry['ms']!r} ms back to back, {entry['cold_ms']!r} out "
                  f"of L2 ({entry['bound_ms'] / entry['cold_ms']!r} of the "
                  f"bound {entry['bound_ms']!r} ms, {entry['bound_by']}); "
                  f"plain {entry['plain_ms']!r}; SDPA {entry['library_ms']!r} "
                  f"back to back, {entry['library_cold_ms']!r} out of L2 (the "
                  f"kernel {entry['cold_ms'] / entry['library_cold_ms']!r}x); "
                  f"on {gpu_line}", flush=True)
        shapes[name] = entry


def he_state_dict(model, seed: int) -> dict:
    """Seeded f32 CPU weights for a conv net: every conv and Dense weight
    normal with He's std sqrt(2 / fan in) (Dense sqrt(1 / fan in)), norm
    weights near 1, but near 0.2 for the last norm of a residual branch
    (ResNet's, which ``zero_init_last_bn`` starts at 0, and ConvMixer's
    ``blocks.{j}.0.fn.2``: near 1, a bf16 rounding grows block by block,
    to 8-11% of ResNet-50's logits and to their size at ConvMixer's 32
    blocks; EfficientNet's blocks with a skip likewise, ``branch_ends``),
    norm biases with std 0.5 (a
    trained net's: at 0.02 a ConvMixer's pooled features, a mean of
    normalised maps, would be a rounding residue and its bf16 logits off by
    7% of f32's), the other biases and everything else with std 0.02;
    BatchNorm's running statistics as they were."""
    import torch

    from tfimm_tpu_torch.ops.norm import Affine, BatchNorm, GroupNorm, LayerNorm

    norms = {f"{name}.weight" for name, m in model.named_modules()
             if isinstance(m, (LayerNorm, GroupNorm, BatchNorm, Affine))}
    ends = branch_ends(model)
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for name, p in model.state_dict().items():
        p = p.detach().float().cpu()
        if "running_" in name:
            sd[name] = p.clone()
            continue
        r = torch.randn(p.shape, generator=g)
        fan_in = int(p[0].numel()) if p.dim() > 1 else 1
        if name in norms:
            branch_end = (bool((p == 0).all()) or name in ends
                          or name.endswith(".fn.2.weight"))
            sd[name] = (0.2 if branch_end else 1.0) * (1.0 + 0.1 * r)
        elif name[:-len("bias")] + "weight" in norms:
            sd[name] = 0.5 * r
        elif p.dim() >= 3:
            sd[name] = r * math.sqrt(2.0 / fan_in)
        elif p.dim() == 2 and name.endswith("weight"):
            sd[name] = r * math.sqrt(1.0 / fan_in)
        else:
            sd[name] = 0.02 * r
    return sd


def branch_ends(model) -> set:
    """The weights of the last norm of each residual branch of an
    EfficientNet-family model: ``bn3`` of an MBConv, ``bn2`` of a fused
    MBConv or a depthwise-separable block, ``bn1`` of a ConvBnAct, in the
    blocks that add their input back."""
    from tfimm_tpu_torch.architectures import efficientnet_blocks as eb

    last = {eb.InvertedResidual: "bn3", eb.EdgeResidual: "bn2",
            eb.DepthwiseSeparableConv: "bn2", eb.ConvBnAct: "bn1"}
    return {f"{name}.{last[type(m)]}.weight"
            for name, m in model.named_modules()
            if type(m) in last and m.skip}


def calibrated_model(name, seed: int, images, device: str = "cuda"):
    """``name`` in f32 on the card with ``he_state_dict`` weights, each
    BatchNorm's running statistics set to the mean and variance of its
    input over ``images`` in eval mode, the norms in the order they run
    (each one after those before it are set, as a trained net's statistics
    follow its data): in one forward pass, each norm's statistics set by a
    hook just before it normalises. Returns the model (eval mode) and its
    state dict on the CPU."""
    import torch

    import tfimm_tpu_torch as tfm
    from tfimm_tpu_torch.ops.norm import BatchNorm

    model = tfm.create_model(name, device=device, dtype=torch.float32, seed=0)
    model.load_state_dict(he_state_dict(model, seed))
    x = tfm.create_preprocessing(name, device=device)(images)
    model.eval()

    def calibrate(bn, inp):
        flat = inp[0].detach().float().reshape(-1, bn.dim)
        bn.running_mean.copy_(flat.mean(dim=0))
        bn.running_var.copy_(flat.var(dim=0))

    hooks = [m.register_forward_pre_hook(calibrate) for m in model.modules()
             if isinstance(m, BatchNorm)]
    try:
        with torch.no_grad():
            model(x)
    finally:
        for hook in hooks:
            hook.remove()
    return model, {k: v.detach().cpu().clone()
                   for k, v in model.state_dict().items()}


def seeded_model(name, seed: int, images, device: str = "cuda"):
    """``name`` in f32 on the card with ``seeded_state_dict`` weights (std
    0.02, norms and layer scales near 1), the Mixer family's: no BatchNorm
    to calibrate, ``images`` unused. Returns the model (eval mode) and its
    state dict on the CPU."""
    import torch

    import tfimm_tpu_torch as tfm

    model = tfm.create_model(name, device=device, dtype=torch.float32, seed=0)
    sd = seeded_state_dict(model, seed)
    model.load_state_dict(sd)
    return model.eval(), sd


def conv_net_groups(names: dict) -> dict:
    """A profile's device ms by kernel name (``device_split``) split into
    cuDNN convs, BatchNorm, cuBLAS GEMMs (the 1x1 convs, the Dense layers
    and the heads, ``F.linear``), the port's kernels, swish and sigmoid
    (the EfficientNets' activations and SE gates, gMixer's GLU), means
    (SE's squeeze, LayerNorm's statistics, the pooled heads), copies (TF
    SAME's ``F.pad`` and its fill, the Mixers' token transposes, casts)
    and the rest (other elementwise passes, LayerNorm's among them,
    pools)."""
    groups = {}
    for kname, ms in names.items():
        low = kname.lower()
        if any(k in low for k in ("fused_mha", "flash_fwd", "flash_bwd")):
            group = "the port's kernels"
        elif any(k in low for k in CONV_NET_CONV_KEYS):
            group = "convs (cuDNN)"
        elif "batch_norm" in low or "bn_" in low:
            group = "BatchNorm"
        elif any(k in low for k in ("gemm", "cutlass", "nvjet", "splitk")):
            group = "GEMMs (cuBLAS)"
        elif "silu" in low or "sigmoid" in low:
            group = "swish, sigmoid"
        elif "reduce_kernel" in low and "mean" in low:
            group = "means"
        elif any(k in low for k in ("copy", "pad", "fill")):
            group = "copies (pads, transposes, casts)"
        else:
            group = "elementwise, pools, reductions, the rest"
        groups[group] = groups.get(group, 0.0) + ms
    return groups


def stepwise(model, model32, x16, x32) -> dict:
    """Each step of a bf16 request of a ConvMixer or an EfficientNet (the
    stem, every block, the head) against the same step of the f32 model
    fed the bf16 model's own input to that step: max|diff| / max|f32| by
    step. End to end the two part by more than 5e-2 on seeded weights:
    ConvMixer's 32 blocks of ReLU and BatchNorm magnify one bf16 rounding
    block by block, and so do the EfficientNets' blocks (most at the
    blocks that open a stage, which have no skip), in the JAX package as in
    the port (``scripts/perf/torch_bf16_drift.py``)."""
    import torch

    from tfimm_tpu_torch.architectures.convmixer import ConvMixer

    def rel(got, want):
        return ((got.float() - want).abs().max() / want.abs().max()).item()

    m = model32
    if isinstance(m, ConvMixer):
        stem = lambda x: m.stem["2"](m.act(m.stem["0"](x)))  # noqa: E731
        blocks = [(f"block_{j}", b) for j, b in enumerate(m.blocks)]
        head_input = "features"
        head = m.forward_head
    else:   # EfficientNet
        stem = lambda x: m.act(m.bn1(m.conv_stem(x)))  # noqa: E731
        blocks = list(zip(m.block_names, (b for st in m.blocks for b in st)))
        head_input = m.block_names[-1]
        head = lambda x: m.forward_head(  # noqa: E731
            m.act(m.bn2(m.conv_head(x))))
    with torch.inference_mode():
        logits, feats = model(x16, return_features=True)
        rels = {"stem": rel(feats["stem"], stem(x32))}
        before = "stem"
        for name, block in blocks:
            rels[name] = rel(feats[name], block(feats[before].float()))
            before = name
        rels["head"] = rel(logits, head(feats[head_input].float()))
    return rels


def conv_net_serving(reports, gpu_line, path, runs, seed,
                     weights=calibrated_model, batches=None, ranges=()):
    """Phases 35 and 37-42: each (model, launches) of ``runs`` in bf16
    with the weights of ``weights`` (``calibrated_model``, or
    ``seeded_model`` for the Mixers) answers REQUESTS requests of BATCH
    uint8 images (or the model's batch in ``batches``) at the model's own
    ``input_size`` (224x224 but for EfficientNet-B4's 380, V2-S's 300 and
    the 384 and 448 of BiT and the hybrids), each launching the kernels of
    ``launches`` and nothing else; the logits of the first
    FAMILY_CHECK_IMAGES images within 5e-2 of the same weights in f32 on
    the card, through the plain attention (no launch); the rate of each
    run and a profile of one request split by ``conv_net_groups``, with
    the modules of ``ranges`` split out (``range_split``). Where the
    requests launch ``fused_mha``, the profile names its body, which must
    be the bf16 TMA + wgmma one."""
    import torch

    import tfimm_tpu_torch as tfm
    import tfimm_tpu_torch.ops.attention as attention
    from tfimm_tpu_torch.ops.kernels import dispatch

    g = torch.Generator(device="cuda").manual_seed(seed)
    by_size = {}

    def requests_at(size, batch):
        """REQUESTS requests of ``batch`` uint8 images of ``size``, drawn in
        order of first use."""
        if (size, batch) not in by_size:
            by_size[size, batch] = [
                torch.randint(0, 256, (batch, *size, 3), generator=g,
                              device="cuda", dtype=torch.uint8)
                for _ in range(REQUESTS)]
        return by_size[size, batch]

    dispatch.reset_launch_counts()
    path_counts = expected()
    for name, launches in runs:
        size = tuple(tfm.model_config(name).input_size)
        batch = (batches or {}).get(name, BATCH)
        requests = requests_at(size, batch)
        x = requests[0][:FAMILY_CHECK_IMAGES]
        model32, sd = weights(name, seed, requests[-1][:32])
        model = tfm.create_model(name, device="cuda", dtype=torch.bfloat16,
                                 seed=0)
        model.load_state_dict(sd)
        pp = tfm.create_preprocessing(name, dtype=torch.bfloat16,
                                      device="cuda")
        torch.cuda.synchronize()
        before = dict(dispatch.launch_counts)
        seconds, logits = family_requests(model, pp, requests, launches,
                                          batch=batch)
        for k in path_counts:
            path_counts[k] += dispatch.launch_counts[k] - before[k]
        img_s = [batch / t for t in seconds[1:]]
        request_ms = statistics.median(seconds[1:]) * 1e3
        print(f"slice {name} bs{batch} bf16 {size[0]}x{size[1]}: request "
              f"seconds {seconds!r}", flush=True)
        print(f"slice {name} bs{batch} bf16 {size[0]}x{size[1]}: "
              f"{statistics.median(img_s)!r} "
              f"img/s (median of requests 2-{REQUESTS}; range "
              f"{min(img_s)!r}-{max(img_s)!r}), launches a request "
              f"{launches or 'none'}; on {gpu_line}", flush=True)

        # The f32 reference: the same weights and statistics; the attention
        # (PiT) through its plain path, so that it launches nothing.
        pp32 = tfm.create_preprocessing(name, device="cuda")
        fused = attention.fused_mha_or_none
        attention.fused_mha_or_none = lambda *args: None
        try:
            before = dict(dispatch.launch_counts)
            with torch.inference_mode():
                ref = model32(pp32(x))
            check(dispatch.launch_counts == before,
                  "the f32 reference launched a kernel")
        finally:
            attention.fused_mha_or_none = fused
        got = logits[:FAMILY_CHECK_IMAGES].float()
        rel = ((got - ref).abs().max() / ref.abs().max()).item()
        if name in STEPWISE:
            print(f"slice {name} logits: bf16 vs f32 on the card rel err "
                  f"{rel!r} (not held: see stepwise); on {gpu_line}",
                  flush=True)
            rels = stepwise(model, model32, pp(x), pp32(x))
            name_, rel = max(rels.items(), key=lambda kv: kv[1])
            print(f"slice {name}: each step in bf16 vs f32 on the bf16 "
                  f"step's input, largest rel err {rel!r} at {name_} (bar "
                  f"5e-2); {rels!r}", flush=True)
        else:
            print(f"slice {name} logits: bf16 vs f32 on the card rel err "
                  f"{rel!r} (bar 5e-2); on {gpu_line}", flush=True)
        check(rel < 5e-2, f"{name} logits rel err {rel} >= 5e-2")
        del model32, ref

        img = requests[1]
        for attempt in range(5):
            wall_ms, _, names = device_split(lambda: model.predict(pp(img)),
                                             steps=2)
            if names:
                break
            print(f"profile {attempt + 1} of 5 kept no device event",
                  flush=True)
        check(bool(names), f"{name}: five profiles kept no device event")
        groups = conv_net_groups(names)
        busy_ms = sum(groups.values())
        if "fused_mha" in launches:
            bodies = sorted({n for n in names if "fused_mha_fwd" in n})
            print(f"{name} request profile: fused_mha body {bodies}",
                  flush=True)
            check(len(bodies) == 1 and MHA_BF16_BODY in bodies[0],
                  f"{name}: fused_mha ran {bodies}, not {MHA_BF16_BODY}")
        if ranges:
            groups = range_split(lambda: model.predict(pp(img)), ranges)
            busy_ms = sum(groups.values())
        print(f"{name} request profile: device busy {busy_ms!r} ms per "
              f"request; wall {wall_ms!r} ms under the profiler, "
              f"{request_ms!r} ms without; device idle share "
              f"{1.0 - busy_ms / request_ms!r}; on {gpu_line}", flush=True)
        for group, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
            print(f"{name} request profile: {group}: {ms!r} ms per request "
                  f"({ms / busy_ms!r} of busy); on {gpu_line}", flush=True)
        for kname, ms in sorted(names.items(), key=lambda kv: -kv[1])[:8]:
            print(f"{name} request profile kernel: {ms!r} ms {kname[:150]}",
                  flush=True)
        del model
    for report_name, report in reports.items():
        report["launches_by_path"][path] = path_counts[report_name]


def resnet_train_config() -> dict:
    """ResNet-50 at batch 64 with the ResNet recipe as far as train/ takes
    it (SGD with momentum 0.9, lr 0.1 at batch 256 scaled to 0.025, L2
    weight decay 1e-4, label smoothing 0.1), bf16 mixed precision, an EMA
    of the weights and statistics at decay 0.9, TRAIN_STEPS epochs of one
    step each on the same 64 synthetic images."""
    data = {"batch_size": RESNET_TRAIN_BATCH,
            "nb_samples": RESNET_TRAIN_BATCH, "input_size": (224, 224),
            "nb_classes": 1000, "seed": 0}
    return {
        "trainer_class": "Trainer",
        "trainer": {"validation_before_training": False,
                    "display_loss_every_it": 1},
        "problem_class": "ClassificationProblem",
        "problem": {"model_class": "ModelFactory",
                    "model": {"model_name": RESNET},
                    "optimizer_class": "OptimizerFactory",
                    "optimizer": {"optimizer": "sgd",
                                  "lr_schedule_class": "LRConstFactory",
                                  "lr_schedule": {
                                      "lr": 0.1 * RESNET_TRAIN_BATCH / 256}},
                    "weight_decay": 1e-4, "mixed_precision": True,
                    "label_smoothing": 0.1, "ema_decay": RESNET_EMA_DECAY},
        "train_dataset_class": "SyntheticDataset", "train_dataset": data,
        "timekeeping_class": "Timekeeping",
        "timekeeping": {"nb_epochs": TRAIN_STEPS,
                        "batch_size": RESNET_TRAIN_BATCH,
                        "nb_samples_per_epoch": RESNET_TRAIN_BATCH},
        "device": "cuda",
    }


def phase_resnet_train(reports, gpu_line):
    """Phase 36: ``train.run`` trains ResNet-50 at batch 64 in bf16 mixed
    precision with an EMA. No launch; finite losses; the running
    statistics moved and stayed finite; the EMA holds them; a validation
    pass reads the averaged ones; a seeded bf16 step against f32; the rate
    and a profile."""
    import torch
    from torch.func import functional_call

    from tfimm_tpu_torch.ops.norm import BatchNorm
    from tfimm_tpu_torch.parallel.step import cross_entropy_loss

    trainer, steps, counts = run_watched(resnet_train_config())
    problem = trainer.problem
    model = problem.model
    check(len(steps) == TRAIN_STEPS, f"{len(steps)} ResNet training steps, "
          f"expected {TRAIN_STEPS}")
    for it, (loss, seconds, rose) in enumerate(steps):
        print(f"resnet train step {it}: loss {loss!r}, {seconds!r} s, "
              f"launches {rose}", flush=True)
        check(rose == expected(), f"ResNet step {it} launched {rose}")
        check(math.isfinite(loss), f"ResNet step {it}: loss {loss}")
    check(counts == expected(), f"the ResNet run launched {counts}")
    for name, report in reports.items():
        report["launches_by_path"]["train_resnet"] = counts[name]
    timed = [s for _, s, _ in steps[1:]]
    step_s = sum(timed) / len(timed)
    print(f"train {RESNET} bs{RESNET_TRAIN_BATCH} bf16 mixed precision sgd "
          f"ema {RESNET_EMA_DECAY}: "
          f"{RESNET_TRAIN_BATCH * len(timed) / sum(timed)!r} img/s "
          f"({len(timed)} steps 2-{TRAIN_STEPS} in {sum(timed) * 1e3!r} ms; "
          f"median step {statistics.median(timed) * 1e3!r} ms, slowest "
          f"{max(timed) * 1e3!r} ms) on {gpu_line}", flush=True)

    # The running statistics: moved from their start (0 and 1), finite, and
    # averaged by the EMA, which no longer equals them.
    live = model.state_dict()
    bns = [n for n, m in model.named_modules() if isinstance(m, BatchNorm)]
    means = [live[f"{n}.running_mean"] for n in bns]
    variances = [live[f"{n}.running_var"] for n in bns]
    check(all(bool(torch.isfinite(t).all()) for t in means + variances),
          "non-finite running statistics")
    moved = sum(bool(t.abs().max() > 0) for t in means)
    print(f"resnet train: {moved} of {len(bns)} BatchNorms' running means "
          f"moved from 0", flush=True)
    check(moved == len(bns), f"only {moved} of {len(bns)} running means moved")
    ema = problem.ema_params
    stats = [f"{n}.running_{s}" for n in bns for s in ("mean", "var")]
    check(set(stats) <= set(ema), "the EMA does not hold the statistics")
    apart = max(((ema[k] - live[k]).abs().max() / live[k].abs().max()).item()
                for k in stats)
    print(f"resnet train: EMA statistics vs live, largest rel difference "
          f"{apart!r}", flush=True)
    check(apart > 1e-3, "the EMA statistics equal the live ones")

    # Validation reads the EMA's weights and statistics: a hook on the stem's
    # BatchNorm sees the EMA's running variance during the pass, and on
    # labels taken from the EMA model's own predictions the accuracy is 1.
    images, _ = next(iter(trainer.train_ds))
    x = problem.preprocessing(torch.as_tensor(images, device="cuda"))
    model.eval()
    with torch.no_grad():
        labels = functional_call(model, ema, (x,)).argmax(-1).cpu().numpy()
        live_labels = model(x).argmax(-1).cpu().numpy()
    seen = []
    hook = model.bn1.register_forward_hook(
        lambda m, inp, out: seen.append(m.running_var.detach().clone()))
    try:
        val = problem.validation([(images, labels)])["val/accuracy"]
    finally:
        hook.remove()
    read_ema = len(seen) == 1 and torch.equal(seen[0], ema["bn1.running_var"])
    print(f"resnet validation: accuracy {val!r} on the EMA's own labels (the "
          f"live model's {float((live_labels == labels).mean())!r}); the "
          f"stem BatchNorm read the EMA's statistics: {read_ema}", flush=True)
    check(read_ema and not torch.equal(seen[0], live["bn1.running_var"]),
          "validation did not read the EMA's running statistics")
    check(val == 1.0, f"validation accuracy {val} on the EMA's own labels")

    # One seeded step's loss and gradients: bf16 against f32 (cuDNN in both,
    # TF32 off), in training mode (batch statistics).
    model.load_state_dict(he_state_dict(model, seed=36))
    model.train()
    labels = torch.as_tensor(next(iter(trainer.train_ds))[1], device="cuda")
    # The head's weight and the last norm's bias are held. The convs' and
    # the norm scales' gradients are printed, not held: a conv's output
    # feeds a training BatchNorm, which makes its cotangent orthogonal to
    # that output, so the weight's gradient is a small difference of large
    # sums, which bf16 moves by 16-140% in the port and in the JAX package
    # alike (scripts/perf/torch_bf16_drift.py).
    last = f"layer4.{len(model.layer4) - 1}"
    names = ("fc.weight", f"{last}.bn3.bias")
    shown = ("conv1.weight", f"{last}.conv3.weight", f"{last}.bn3.weight")

    def loss_and_grads(inputs):
        model.zero_grad(set_to_none=True)
        loss = cross_entropy_loss(model(inputs).float(), labels)
        loss.backward()
        params = dict(model.named_parameters())
        return loss.item(), {n: params[n].grad.float()
                             for n in names + shown}

    x32 = problem.preprocessing(torch.as_tensor(images, device="cuda"))
    loss_k, grads_k = loss_and_grads(x32.to(torch.bfloat16))
    loss_r, grads_r = loss_and_grads(x32)
    rel = abs(loss_k - loss_r) / abs(loss_r)
    print(f"resnet train loss: bf16 {loss_k!r} vs f32 {loss_r!r}, rel err "
          f"{rel!r} (bar 2e-2)", flush=True)
    check(rel < 2e-2, f"ResNet loss rel err {rel} >= 2e-2")
    for name in names + shown:
        ref = grads_r[name]
        rel = ((grads_k[name] - ref).abs().max() / ref.abs().max()).item()
        held = name in names
        print(f"resnet train grad {name}: max|diff| / max|ref| {rel!r} "
              f"({'bar 1e-1' if held else 'not held'})", flush=True)
        if held:
            check(rel < 1e-1, f"{name} gradient rel err {rel} >= 1e-1")
            check(ref.abs().max().item() > 0,
                  f"{name}: zero reference gradient")

    batch = next(iter(trainer.train_ds))
    profile_idle(f"{RESNET} train step", lambda: problem.train_step(batch, 0),
                 step_s * 1e3, steps=1)


def module_ranges() -> list:
    """The modules ``range_split`` splits out of a BiT or hybrid request:
    GroupNorm's passes and the weight standardisation of each StdConv2d."""
    from tfimm_tpu_torch.ops.conv import StdConv2d
    from tfimm_tpu_torch.ops.norm import GroupNorm

    return [(GroupNorm, "forward", "GroupNorm"),
            (StdConv2d, "_kernel", "weight standardisation")]


def range_split(fn, ranges, steps: int = 2, tries: int = 5) -> dict:
    """A ``torch.profiler`` split of one call of ``fn`` (the mean of
    ``steps``, after one call unprofiled): the device ms of the kernels
    that ran inside each module call of ``ranges`` ((class, method, label):
    for the profile's length each call of the method runs in a
    ``record_function(label)`` range, whose span the profile keeps on the
    device's timeline too; a kernel belongs to the label whose device span
    holds its start, the stream being serial), then the other kernels by
    ``conv_net_groups``. The groups sum to the device's busy time. A
    profile that kept no device event, or no span of a label, is taken
    again, up to ``tries`` in all; then the phase fails."""
    import bisect

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = torch.autograd.DeviceType.CUDA
    labels = {label for _, _, label in ranges}
    saved = []
    for cls, method, label in ranges:
        orig = getattr(cls, method)

        def ranged(self, *args, _orig=orig, _label=label, **kwargs):
            with record_function(_label):
                return _orig(self, *args, **kwargs)

        saved.append((cls, method, orig))
        setattr(cls, method, ranged)
    try:
        fn()
        torch.cuda.synchronize()
        for attempt in range(1, tries + 1):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(steps):
                    fn()
                torch.cuda.synchronize()
            device = [evt for evt in prof.events() if evt.device_type == cuda]
            kernels = [evt for evt in device
                       if not getattr(evt, "is_user_annotation", False)]
            spans = sorted((evt.time_range.start, evt.time_range.end, evt.name)
                           for evt in device if evt.name in labels
                           and getattr(evt, "is_user_annotation", False))
            if kernels and {name for _, _, name in spans} == labels:
                break
            print(f"profile {attempt} of {tries} kept {len(kernels)} device "
                  f"events and the spans of "
                  f"{sorted({name for _, _, name in spans})}", flush=True)
        else:
            raise SmokeFailure(f"{tries} profiles in a row kept no device "
                               f"event or no span of one of {sorted(labels)}")
    finally:
        for cls, method, orig in saved:
            setattr(cls, method, orig)
    starts = [start for start, _, _ in spans]
    split, rest = dict.fromkeys(sorted(labels), 0.0), {}
    for evt in kernels:
        start = evt.time_range.start
        ms = evt.time_range.elapsed_us() / 1e3 / steps
        at = bisect.bisect_right(starts, start) - 1
        if at >= 0 and start < spans[at][1]:
            split[spans[at][2]] += ms
        else:
            rest[evt.name] = rest.get(evt.name, 0.0) + ms
    return {**split, **conv_net_groups(rest)}


def mha_train_config(name, batch) -> dict:
    """``name`` at its own input size and ``batch``, phase 4's recipe (bf16
    mixed precision, AdamW at lr 1e-4), TRAIN_STEPS epochs of one step each
    on the same ``batch`` synthetic images."""
    import tfimm_tpu_torch as tfm

    config = train_config()
    size = tuple(tfm.model_config(name).input_size)
    config["train_dataset"] = dict(config["train_dataset"], batch_size=batch,
                                   nb_samples=batch, input_size=size)
    config["problem"]["model"] = {"model_name": name}
    config["timekeeping"] = {"nb_epochs": TRAIN_STEPS, "batch_size": batch,
                             "nb_samples_per_epoch": batch}
    return config


def mha_bwd_times(report, gpu_line):
    """``fused_mha_bwd`` at MHA_BWD_SHAPES: against its plain version in
    bf16, the body it took, and its device time out of L2 beside its bound,
    its plain version's time and the device time of SDPA's backward alone
    (both from profiles, so that no host time of autograd counts; the
    kernel's CUDA-event time out of L2 too), into ``fused_mha_bwd``'s
    ``shapes``."""
    import torch
    import torch.nn.functional as F

    from tfimm_tpu_torch.ops.kernels.fused_mha import (
        fused_mha_bwd,
        fused_mha_bwd_reference,
    )

    shapes = report.setdefault("shapes", {})
    for i, (name, (b, n, h, d)) in enumerate(MHA_BWD_SHAPES.items()):
        scale = d ** -0.5
        qkv = mha_input(b, n, h, d, torch.bfloat16, seed=430 + i)
        gen = torch.Generator(device="cuda").manual_seed(440 + i)
        g = torch.randn(b, n, h * d, generator=gen,
                        device="cuda").to(torch.bfloat16)
        got = fused_mha_bwd(qkv, g, h, scale).float()
        ref = fused_mha_bwd_reference(qkv, g, h, scale).float()
        err = (got - ref).abs().max().item()
        bar = BWD_TOL["bfloat16"] * ref.abs().max().item()
        ok = err <= bar and bool(torch.isfinite(got).all())
        print(f"fused_mha_bwd {name} bf16 (B, N, H, d) = {(b, n, h, d)}: "
              f"max_abs_err={err!r} bar={bar!r} {'ok' if ok else 'FAIL'}",
              flush=True)
        check(ok, f"fused_mha_bwd disagrees with its plain version at {name}: "
              f"{err} > {bar}")
        del got, ref
        kernel = cold_call_kernels(lambda: fused_mha_bwd(qkv, g, h, scale),
                                   need=[("fused_mha_bwd_dq",),
                                         ("fused_mha_bwd_dkv",)])
        bodies = sorted(k for k in kernel if "fused_mha_bwd" in k)
        check(len(bodies) == 2 and all("bf16_kernel<1>" in k for k in bodies),
              f"fused_mha_bwd at {name} ran {bodies}")
        q, k, v = [t.requires_grad_() for t in heads(qkv, h)]
        out = F.scaled_dot_product_attention(q, k, v, scale=scale)
        gh = g.reshape(b, n, h, d).transpose(1, 2).contiguous()

        def sdpa_bwd():
            return torch.autograd.grad(out, (q, k, v), gh, retain_graph=True)

        library = cold_call_kernels(sdpa_bwd)
        entry = {"shape": [b, n, h, d], "max_abs_err": err,
                 "bodies": [k[:60] for k in bodies],
                 "device_ms": sum(kernel.values()),
                 "cold_ms": cold_ms(lambda: fused_mha_bwd(qkv, g, h, scale)),
                 "plain_ms": cuda_time_ms(
                     lambda: fused_mha_bwd_reference(qkv, g, h, scale),
                     iters=3, repeats=3),
                 "library_device_ms": sum(library.values())}
        entry["bound_ms"], entry["bound_by"] = bound(
            2 * b * n * 7 * h * d, 10 * b * h * n * n * d)
        print(f"fused_mha_bwd {name}: bodies {entry['bodies']}; device "
              f"{entry['device_ms']!r} ms out of L2 (profiler; CUDA events "
              f"{entry['cold_ms']!r}), {entry['bound_ms'] / entry['device_ms']!r}"
              f" of the bound {entry['bound_ms']!r} ms ({entry['bound_by']}); "
              f"plain {entry['plain_ms']!r} ms; SDPA's backward {entry['library_device_ms']!r} ms device out "
              f"of L2 (the kernel "
              f"{entry['device_ms'] / entry['library_device_ms']!r}x; "
              f"{sorted(n_[:50] for n_ in library)}); on {gpu_line}",
              flush=True)
        shapes[name] = entry
        del q, k, v, out, qkv, g


def phase_mha_train(reports, gpu_line):
    """Phase 43: ``train.run`` trains ViT-B/16-R50 at 384x384, PiT-B and
    PiT-S in bf16 mixed precision, each step launching ``fused_mha`` and
    its backward once a block; finite losses; a seeded step on
    TRAIN_CHECK_IMAGES images against f32 through the plain attention; the
    rate over steps 2-6 and a profile of one step. Then ``fused_mha_bwd``
    at their shapes (``mha_bwd_times``)."""
    import torch

    import tfimm_tpu_torch.ops.attention as attention
    from tfimm_tpu_torch.parallel.step import cross_entropy_loss

    for name, report in reports.items():
        for path in ("train_vit_hybrid", "train_pit"):
            report["launches_by_path"].setdefault(path, 0)
    for name, batch, launches, held, shown in MHA_TRAIN_RUNS:
        path = "train_pit" if name.startswith("pit") else "train_vit_hybrid"
        trainer, steps, counts = run_watched(mha_train_config(name, batch))
        problem = trainer.problem
        check(len(steps) == TRAIN_STEPS, f"{len(steps)} {name} steps")
        for it, (loss, seconds, rose) in enumerate(steps):
            print(f"{name} train step {it}: loss {loss!r}, {seconds!r} s, "
                  f"launches {rose}", flush=True)
            check(rose == expected(**launches),
                  f"{name} step {it} launched {rose}, expected {launches}")
            check(math.isfinite(loss), f"{name} step {it}: loss {loss}")
        for kname, report in reports.items():
            report["launches_by_path"][path] += counts[kname]
        timed = [s for _, s, _ in steps[1:]]
        step_s = sum(timed) / len(timed)
        size = problem.model.cfg.input_size
        print(f"train {name} {size[0]}x{size[1]} bs{batch} bf16 mixed "
              f"precision adamw: {batch * len(timed) / sum(timed)!r} img/s "
              f"({len(timed)} steps 2-{TRAIN_STEPS} in {sum(timed) * 1e3!r} "
              f"ms; median step {statistics.median(timed) * 1e3!r} ms, "
              f"slowest {max(timed) * 1e3!r} ms) on {gpu_line}", flush=True)

        # One seeded step: bf16 through the kernels against f32 through the
        # plain attention (fused_mha_or_none declined: its gate does not
        # look at autograd), which must launch nothing.
        model, pp = problem.model, problem.preprocessing
        model.load_state_dict(seeded_state_dict(model, seed=43))
        model.train()
        images, labels = next(iter(trainer.train_ds))
        images = torch.as_tensor(images[:TRAIN_CHECK_IMAGES], device="cuda")
        labels = torch.as_tensor(labels[:TRAIN_CHECK_IMAGES], device="cuda")

        def loss_and_grads(x):
            model.zero_grad(set_to_none=True)
            loss = cross_entropy_loss(model(x).float(), labels)
            loss.backward()
            params = dict(model.named_parameters())
            return loss.item(), {n: params[n].grad.float()
                                 for n in held + shown}

        (loss_k, grads_k), rose = launches_of(
            lambda: loss_and_grads(pp(images).to(torch.bfloat16)))
        check(rose == expected(**launches), f"the bf16 {name} step launched "
              f"{rose}")
        fused = attention.fused_mha_or_none
        attention.fused_mha_or_none = lambda *args: None
        try:
            (loss_r, grads_r), rose = launches_of(
                lambda: loss_and_grads(pp(images)))
        finally:
            attention.fused_mha_or_none = fused
        check(rose == expected(), f"the f32 {name} reference launched {rose}")
        rel = abs(loss_k - loss_r) / abs(loss_r)
        print(f"{name} train loss: bf16 kernel path {loss_k!r} vs f32 plain "
              f"path {loss_r!r}, rel err {rel!r} (bar 2e-2)", flush=True)
        check(rel < 2e-2, f"{name} loss rel err {rel} >= 2e-2")
        for pname in held + shown:
            ref = grads_r[pname]
            rel = ((grads_k[pname] - ref).abs().max()
                   / ref.abs().max()).item()
            print(f"{name} train grad {pname}: max|diff| / max|ref| {rel!r} "
                  f"({'bar 1e-1' if pname in held else 'not held'})",
                  flush=True)
            if pname in held:
                check(rel < 1e-1, f"{name} {pname} gradient rel err {rel}")
                check(ref.abs().max().item() > 0,
                      f"{name} {pname}: zero reference gradient")
        del grads_k, grads_r
        batch_ = next(iter(trainer.train_ds))
        profile_idle(f"{name} train step",
                     lambda: problem.train_step(batch_, 0), step_s * 1e3,
                     steps=1)
        del trainer, problem, model
        torch.cuda.empty_cache()
    mha_bwd_times(reports["fused_mha_bwd"], gpu_line)


def watch_amg(gen):
    """Wrap ``gen``'s predictor's ``set_image`` and ``gen._process_points``
    so that each call's launch counts are logged: returns {"set": [...],
    "decode": [...]}, one dict of launches a call."""
    from tfimm_tpu_torch.ops.kernels import dispatch

    log = {"set": [], "decode": []}

    def watched(fn, key):
        def call(*args, **kwargs):
            before = dict(dispatch.launch_counts)
            out = fn(*args, **kwargs)
            log[key].append({k: dispatch.launch_counts[k] - before[k]
                             for k in before})
            return out
        return call

    gen.predictor.set_image = watched(gen.predictor.set_image, "set")
    gen._process_points = watched(gen._process_points, "decode")
    return log


def check_amg_records(records, image_hw, crop_n_layers, overlap):
    """The invariants of tests/models/test_amg.py::test_generate_end_to_end
    on uncompressed-RLE records: the area is the RLE's; the bbox bounds the
    decoded segmentation exactly; the crop box is one of
    ``generate_crop_boxes``'; the point lies inside the image."""
    import numpy as np

    from tfimm_tpu_torch.architectures.segment_anything.amg import (
        area_from_rle,
        generate_crop_boxes,
        rle_to_mask,
    )

    h, w = image_hw
    boxes, _ = generate_crop_boxes(image_hw, crop_n_layers, overlap)
    crops = {(float(x0), float(y0), float(x1 - x0), float(y1 - y0))
             for x0, y0, x1, y1 in boxes}
    for rec in records:
        rle = rec["segmentation"]
        check(rle["size"] == [h, w], f"RLE size {rle['size']}")
        seg = rle_to_mask(rle)
        check(rec["area"] == area_from_rle(rle) == int(seg.sum()),
              f"area {rec['area']} against the RLE's")
        x, y, bw, bh = rec["bbox"]
        if seg.any():
            ys, xs = np.nonzero(seg)
            check((x, y, bw, bh) == (xs.min(), ys.min(),
                                     xs.max() + 1 - xs.min(),
                                     ys.max() + 1 - ys.min()),
                  f"bbox {rec['bbox']} does not bound its segmentation")
        else:
            check((bw, bh) == (0.0, 0.0), f"empty mask with bbox {rec['bbox']}")
        check(tuple(rec["crop_box"]) in crops, f"crop box {rec['crop_box']}")
        (px, py), = rec["point_coords"]
        check(0 <= px <= w and 0 <= py <= h, f"point {(px, py)} off the image")
        check(0.0 <= rec["stability_score"] <= 1.0
              and math.isfinite(rec["predicted_iou"]),
              f"scores {rec['predicted_iou']}, {rec['stability_score']}")


def phase_sam_amg(reports, gpu_line):
    """Phase 44: SAM-B's automatic mask generator in bf16 on the card."""
    import numpy as np
    import torch

    import tfimm_tpu_torch as tfm
    from tfimm_tpu_torch.architectures.segment_anything import (
        SAMAutomaticMaskGenerator,
    )
    from tfimm_tpu_torch.ops.kernels import dispatch

    model = tfm.create_model(SAM, device="cuda", dtype=torch.bfloat16, seed=0)
    sd = sam_state_dict(model, seed=44)
    model.load_state_dict(sd)
    rng = np.random.default_rng(44)
    image = rng.integers(0, 256, (*AMG_IMAGE, 3), dtype=np.uint8)
    per_crop = SAM_LAUNCHES["flash_attention_relpos"]

    gen = SAMAutomaticMaskGenerator(model)
    gen.predictor.set_image(image)   # warm-up: cuBLAS handles, allocator
    gen.predictor.clear_image()
    permissive = SAMAutomaticMaskGenerator(model, **AMG_PERMISSIVE)
    logs = [watch_amg(gen), watch_amg(permissive)]
    torch.cuda.synchronize()

    dispatch.reset_launch_counts()
    t0 = time.perf_counter()
    records = gen.generate(image)
    torch.cuda.synchronize()
    default_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loose = permissive.generate(image)
    torch.cuda.synchronize()
    permissive_s = time.perf_counter() - t0
    for name, report in reports.items():
        report["launches_by_path"]["serve_sam_amg"] = dispatch.launch_counts[name]
    for log, crops, what in ((logs[0], 1, "default"),
                             (logs[1], 5, "permissive")):
        check(len(log["set"]) == crops, f"{what}: {len(log['set'])} crops, "
              f"expected {crops}")
        for launches in log["set"]:
            check(launches == expected(**SAM_LAUNCHES), f"{what}: a crop's "
                  f"set_image launched {launches}, expected {SAM_LAUNCHES} "
                  f"and nothing else")
        for launches in log["decode"]:
            check(launches == expected(), f"{what}: a decode batch launched "
                  f"{launches}")
    check(dispatch.launch_counts["flash_attention_relpos"] == 6 * per_crop,
          f"{dispatch.launch_counts['flash_attention_relpos']} launches in "
          f"the two runs, expected {6 * per_crop}")
    print(f"{SAM} bf16 automatic masks, default knobs, {AMG_IMAGE[0]}x"
          f"{AMG_IMAGE[1]} image: generate {default_s!r} s, {len(records)} "
          f"records, {len(logs[0]['decode'])} decode batches, "
          f"{per_crop} launches a crop; on {gpu_line}", flush=True)
    for rec in records:
        seg = rec["segmentation"]
        check(seg.shape == AMG_IMAGE and seg.dtype == bool
              and rec["area"] == int(seg.sum()), "a default record's mask")
        check(rec["predicted_iou"] > 0.88 and rec["stability_score"] >= 0.95,
              f"a record below the thresholds: {rec['predicted_iou']}, "
              f"{rec['stability_score']}")
    check(len(loose) > 0, "the permissive generator returned no record")
    check_amg_records(loose, AMG_IMAGE, 1, permissive.crop_overlap_ratio)
    full = [0.0, 0.0, float(AMG_IMAGE[1]), float(AMG_IMAGE[0])]
    check(any(r["crop_box"] == full for r in loose),
          "no record from the full-image crop")
    print(f"{SAM} bf16 automatic masks, permissive knobs {AMG_PERMISSIVE}: "
          f"generate {permissive_s!r} s, {len(loose)} records from "
          f"{len({tuple(r['crop_box']) for r in loose})} of 5 crops, "
          f"{len(logs[1]['decode'])} decode batches", flush=True)

    # Where a generate's time goes: one decode batch, and a whole generate.
    gen.predictor.set_image(image)
    points = gen.point_grids[0][:gen.points_per_batch] * np.array(
        [AMG_IMAGE[1], AMG_IMAGE[0]], np.float32)
    scaled = torch.as_tensor(gen.predictor.resizer.scale_points(
        points.astype(np.float32)), device="cuda")
    wall_ms, groups, names = device_split(
        lambda: gen._process_points(scaled, AMG_IMAGE), steps=3)
    busy_ms = sum(groups.values())
    print(f"{SAM} decode batch of {gen.points_per_batch} points (3 masks "
          f"each, {AMG_IMAGE[0]}x{AMG_IMAGE[1]}): device busy {busy_ms!r} "
          f"ms, wall {wall_ms!r} ms under the profiler; device idle share "
          f"{1.0 - busy_ms / wall_ms!r}", flush=True)
    for kname, ms in sorted(names.items(), key=lambda kv: -kv[1])[:6]:
        print(f"{SAM} decode batch profile kernel: {ms!r} ms {kname[:150]}",
              flush=True)
    gen.predictor.clear_image()
    wall_ms, groups, _ = device_split(lambda: gen.generate(image), steps=1)
    busy_ms = sum(groups.values())
    print(f"{SAM} default generate profile: device busy {busy_ms!r} ms, wall "
          f"{wall_ms!r} ms under the profiler, {default_s * 1e3!r} ms "
          f"without; device idle share {1.0 - busy_ms / (default_s * 1e3)!r}",
          flush=True)
    for group, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"{SAM} default generate profile: {group}: {ms!r} ms",
              flush=True)
    del gen, permissive, model

    # f32, TF32 off: the card (the kernel's f32 body) against the CPU (the
    # plain version, no launch): one decode batch of every grid point mask
    # by mask, then generate's records one by one.
    check_image = rng.integers(0, 256, (*AMG_CHECK_IMAGE, 3), dtype=np.uint8)
    runs, batches = {}, {}
    for device in ("cuda", "cpu"):
        model32 = tfm.create_model(SAM, device=device, dtype=torch.float32,
                                   seed=0)
        model32.load_state_dict(sd)
        gen32 = SAMAutomaticMaskGenerator(model32, **AMG_CHECK)
        before = dict(dispatch.launch_counts)
        gen32.predictor.set_image(check_image)
        points = gen32.point_grids[0] * np.array(
            [AMG_CHECK_IMAGE[1], AMG_CHECK_IMAGE[0]], np.float32)
        scaled = torch.as_tensor(gen32.predictor.resizer.scale_points(
            points.astype(np.float32)), device=device)
        batches[device] = [t.cpu() for t in gen32._process_points(
            scaled, AMG_CHECK_IMAGE)]
        gen32.predictor.clear_image()
        runs[device] = gen32.generate(check_image)
        rose = {k: dispatch.launch_counts[k] - before[k] for k in before}
        want = expected(flash_attention_relpos=2 * per_crop) \
            if device == "cuda" else expected()
        check(rose == want, f"the f32 {device} run launched {rose}")
        del model32, gen32
    (m_card, iou_card, stab_card, box_card), (m_cpu, iou_cpu, stab_cpu,
                                              box_cpu) = (batches["cuda"],
                                                          batches["cpu"])
    union = (m_card | m_cpu).sum(dim=(1, 2))
    mask_iou = torch.where(union > 0, (m_card & m_cpu).sum(dim=(1, 2))
                           / union.clamp(min=1), 1.0)   # two empty masks: 1
    batch_worst = {
        "bbox_px": (box_card - box_cpu).abs().max().item(),
        "score": max((iou_card.float() - iou_cpu.float()).abs().max().item(),
                     (stab_card - stab_cpu).abs().max().item()),
        "mask_iou": mask_iou.min().item()}
    print(f"{SAM} f32 decode batch, card vs CPU, {len(m_card)} masks of "
          f"{len(points)} points: worst bbox {batch_worst['bbox_px']!r} px, "
          f"worst score {batch_worst['score']!r}, worst mask IoU "
          f"{batch_worst['mask_iou']!r} (bars {AMG_CHECK_TOL})", flush=True)
    check(batch_worst["bbox_px"] <= AMG_CHECK_TOL["bbox_px"]
          and batch_worst["score"] <= AMG_CHECK_TOL["score"]
          and batch_worst["mask_iou"] >= AMG_CHECK_TOL["mask_iou"],
          f"f32 card vs CPU decode batch out of its bars: {batch_worst}")
    card, cpu = runs["cuda"], runs["cpu"]
    check(len(card) == len(cpu) > 0, f"f32 records: {len(card)} on the "
          f"card, {len(cpu)} on the CPU")
    worst = {"bbox_px": 0.0, "score": 0.0, "mask_iou": 1.0}
    for a, b in zip(card, cpu):
        worst["bbox_px"] = max(worst["bbox_px"], max(
            abs(p - q) for p, q in zip(a["bbox"], b["bbox"])))
        worst["score"] = max(worst["score"],
                             abs(a["predicted_iou"] - b["predicted_iou"]),
                             abs(a["stability_score"] - b["stability_score"]))
        sa, sb = a["segmentation"], b["segmentation"]
        union = int((sa | sb).sum())
        iou = int((sa & sb).sum()) / union if union else 1.0
        worst["mask_iou"] = min(worst["mask_iou"], iou)
    print(f"{SAM} f32 automatic masks, card vs CPU, {len(card)} records in "
          f"order: worst bbox {worst['bbox_px']!r} px, worst score "
          f"{worst['score']!r}, worst mask IoU {worst['mask_iou']!r} (bars "
          f"{AMG_CHECK_TOL})", flush=True)
    check(worst["bbox_px"] <= AMG_CHECK_TOL["bbox_px"]
          and worst["score"] <= AMG_CHECK_TOL["score"]
          and worst["mask_iou"] >= AMG_CHECK_TOL["mask_iou"],
          f"f32 card vs CPU records out of their bars: {worst}")


def lora_state_dict(model, seed: int):
    """``seeded_state_dict`` at std 0.05 (gammas near 1), with LoRA's B
    drawn at LORA_B_STD (its init is zero, where the update vanishes)."""
    import torch

    sd = seeded_state_dict(model, seed=seed, std=0.05)
    g = torch.Generator().manual_seed(seed + 1)
    for name, t in sd.items():
        if name.endswith("weight_lora_b"):
            sd[name] = LORA_B_STD * torch.randn(t.shape, generator=g)
    return sd


def phase_lora_convnext(reports, gpu_line):
    """Phase 45: LoRA-ConvNeXt-B serving through convnext_mlp and
    convnext_block, and LoRA fine-tuning."""
    import functools

    import torch

    import tfimm_tpu_torch as tfm
    from tfimm_tpu_torch.architectures import lora
    from tfimm_tpu_torch.ops.kernels import dispatch

    kw = dict(lora_rank=LORA_RANK, lora_alpha=LORA_ALPHA)
    model = lora.create_model(CONVNEXT, device="cuda", dtype=torch.bfloat16,
                              seed=0, **kw)
    sd = lora_state_dict(model, seed=45)
    model.load_state_dict(sd)
    regular = lora.convert_to_regular_model(model)
    base = tfm.create_model(CONVNEXT, device="cuda", dtype=torch.bfloat16,
                            seed=0)
    base.load_state_dict({k: v for k, v in sd.items()
                          if not k.endswith(("weight_lora_a",
                                             "weight_lora_b"))})
    pp = tfm.create_preprocessing(CONVNEXT, dtype=torch.bfloat16,
                                  device="cuda")
    g = torch.Generator(device="cuda").manual_seed(45)
    requests = [torch.randint(0, 256, (BATCH, 224, 224, 3), generator=g,
                              device="cuda", dtype=torch.uint8)
                for _ in range(REQUESTS)]
    x = requests[0][:FAMILY_CHECK_IMAGES]

    # The same LoRA weights in f32 on the card, every gate declined.
    model32 = lora.create_model(CONVNEXT, device="cuda", dtype=torch.float32,
                                seed=0, **kw)
    model32.load_state_dict(sd)
    pp32 = tfm.create_preprocessing(CONVNEXT, dtype=torch.float32,
                                    device="cuda")
    before = dict(dispatch.launch_counts)
    with torch.enable_grad():
        ref = model32(pp32(x)).detach()
    check(dispatch.launch_counts == before,
          "the f32 eager reference launched a kernel")
    del model32

    def rel(got, want):
        return ((got.float() - want.float()).abs().max()
                / want.float().abs().max()).item()

    torch.cuda.synchronize()
    with restored_env("TFIMM_TPU_FUSED_CONVNEXT"):
        for switch, launches, path in LORA_RUNS:
            os.environ["TFIMM_TPU_FUSED_CONVNEXT"] = switch
            dispatch.reset_launch_counts()
            seconds, logits = family_requests(model, pp, requests, launches,
                                              batch=BATCH)
            for name, report in reports.items():
                report["launches_by_path"][path] = dispatch.launch_counts[name]
            img_s = [BATCH / t for t in seconds[1:]]
            how = "convnext_block" if switch == "1" else "convnext_mlp"
            print(f"LoRA {CONVNEXT} (rank {LORA_RANK}) bs{BATCH} bf16 "
                  f"through {how}: request seconds {seconds!r}", flush=True)
            print(f"LoRA {CONVNEXT} bs{BATCH} bf16 ({how}): "
                  f"{statistics.median(img_s)!r} img/s (median of requests "
                  f"2-{REQUESTS}; range {min(img_s)!r}-{max(img_s)!r}), "
                  f"launches a request {launches}; on {gpu_line}", flush=True)
            got = logits[:FAMILY_CHECK_IMAGES]
            with torch.inference_mode():
                merged = regular.predict(pp(x))
                control = base.predict(pp(x))
            errs = {"merged": rel(got, merged), "f32": rel(got, ref),
                    "control": rel(control, ref)}
            print(f"LoRA {CONVNEXT} ({how}) logits: against the merged "
                  f"base model {errs['merged']!r} (bar {LORA_MERGED_TOL}), "
                  f"against the f32 plain reference {errs['f32']!r} (bar "
                  f"{LORA_F32_TOL}); the base model without the update "
                  f"against that reference {errs['control']!r} (must miss "
                  f"the bar by {LORA_CONTROL_FACTOR}x)", flush=True)
            check(errs["merged"] < LORA_MERGED_TOL,
                  f"LoRA vs merged rel err {errs['merged']}")
            check(errs["f32"] < LORA_F32_TOL,
                  f"LoRA vs f32 rel err {errs['f32']}")
            check(errs["control"] >= LORA_CONTROL_FACTOR * LORA_F32_TOL,
                  f"the base model without the update is within "
                  f"{errs['control']} of the LoRA reference")
    del regular, base, model

    # Fine-tuning: f32 parameters, the batch in bf16, AdamW on the
    # trainable ones through lora_optimizer.
    model = lora.create_model(CONVNEXT, device="cuda", dtype=torch.float32,
                              seed=0, **kw)
    model.load_state_dict(sd)
    model.train()
    opt = lora.lora_optimizer(
        functools.partial(torch.optim.AdamW, lr=1e-4, weight_decay=0.05),
        model, train_bias=model.cfg.lora_train_bias,
        trainable_layers=[model.cfg.classifier])
    trainable = set(model.trainable_weights)
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    g = torch.Generator(device="cuda").manual_seed(46)
    batch = pp(torch.randint(0, 256, (LORA_TRAIN_BATCH, 224, 224, 3),
                             generator=g, device="cuda", dtype=torch.uint8))
    labels = torch.randint(0, model.cfg.nb_classes, (LORA_TRAIN_BATCH,),
                           generator=g, device="cuda")
    drop = torch.Generator(device="cuda").manual_seed(47)   # drop path
    losses, seconds = [], []
    launched = dict(dispatch.launch_counts)
    for _ in range(LORA_TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt.zero_grad(set_to_none=True)
        loss = torch.nn.functional.cross_entropy(
            model(batch, generator=drop).float(), labels)
        loss.backward()
        opt.step()
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        losses.append(loss.item())
    check(dispatch.launch_counts == launched, "LoRA fine-tuning launched "
          "a kernel")
    check(all(math.isfinite(v) for v in losses), f"losses {losses}")
    for k, p in model.named_parameters():
        if k in trainable:
            check(not torch.equal(p.detach(), before[k]), f"{k} did not move")
        else:
            check(torch.equal(p.detach(), before[k]), f"frozen {k} moved")
    check(any(k.endswith("weight_lora_b") for k in trainable)
          and any(k.startswith("head.fc") for k in trainable),
          f"trainable {sorted(trainable)[:4]}")
    print(f"LoRA {CONVNEXT} fine-tuning bs{LORA_TRAIN_BATCH} bf16 (f32 "
          f"parameters, AdamW on {len(trainable)} of "
          f"{len(before)} tensors): losses {losses!r}, step seconds "
          f"{seconds!r}; no launch, frozen tensors unchanged; on {gpu_line}",
          flush=True)


def int8_products(dtype, shape, conv):
    """Seeded int8 weights and scales and an activation of ``shape`` on the
    CPU: (x, weight_q, weight_scale, conv arguments or None)."""
    import torch

    g = torch.Generator().manual_seed(sum(shape))
    if conv:
        b, h, w, c, o, stride, pad = shape
        wq = torch.randint(-127, 128, (o, c, 3, 3), generator=g,
                           dtype=torch.int8)
        x = torch.randn(b, h, w, c, generator=g)
        args = ((stride, stride), ((pad, pad), (pad, pad)), (1, 1))
    else:
        m, k, o = shape
        wq = torch.randint(-127, 128, (o, k), generator=g, dtype=torch.int8)
        x = torch.randn(m, k, generator=g)
        args = None
    ws = torch.rand(o, generator=g) * 1e-3 + 1e-4
    return x.to(dtype), wq, ws, args


def int8_parts(x, wq, ws, args):
    """The stages of one int8 product on ``x``'s device, as callables:
    quantise (the scale and the int8 activations), im2col (convs),
    ``_int_mm`` and rescale, and the int32 accumulator."""
    from tfimm_tpu_torch import quant

    xf = x.float()
    if args is None:
        def scale():
            return xf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-6) \
                * (1.0 / 127.0)
    else:
        def scale():
            return xf.abs().amax().clamp_min(1e-6) * (1.0 / 127.0)
    s = scale()
    q = quant._quantize(xf, s)
    parts = {"quantise": lambda: quant._quantize(x.float(), scale())}
    if args is not None:
        strides, pads, dilation = args
        patches, _ = quant._im2col(q, wq.shape[2:], strides, pads, dilation)
        parts["im2col"] = lambda: quant._im2col(q, wq.shape[2:], strides,
                                                pads, dilation)
        a, w2 = patches, wq.reshape(wq.shape[0], -1)
        factor = s * ws
        rescale = lambda acc: acc.float().mul_(factor).to(x.dtype)  # noqa: E731
    else:
        a, w2 = q, wq
        rescale = lambda acc: acc.float().mul_(s).mul_(ws).to(x.dtype)  # noqa: E731
    acc = quant.int_mm(a, w2)
    parts["_int_mm"] = lambda: quant.int_mm(a, w2)
    parts["rescale"] = lambda: rescale(acc)
    return parts, acc


def phase_int8_products(gpu_line):
    """Phase 46 (a): the int8 products on the card against the CPU, and
    the bf16 products' parts timed beside the bf16 library call."""
    import torch
    import torch.nn.functional as F

    from tfimm_tpu_torch import quant

    cases = [(shape, False) for shape in INT8_DENSE_SHAPES] + \
        [(shape, True) for shape in INT8_CONV_SHAPES]
    for shape, conv in cases:
        what = ("int8_conv (B, H, W, C, O, stride, pad)" if conv
                else "int8_dense_matmul (M, K, N)")
        for dtype in (torch.float32, torch.bfloat16):
            x, wq, ws, args = int8_products(dtype, shape, conv)

            def product(x, wq, ws):
                if conv:
                    return quant.int8_conv((wq, ws), x, *args)
                return quant.int8_dense_matmul((wq, ws), x)

            want = product(x, wq, ws)
            _, want_acc = int8_parts(x, wq, ws, args)
            xc, wqc, wsc = x.cuda(), wq.cuda(), ws.cuda()
            got = product(xc, wqc, wsc)
            parts, got_acc = int8_parts(xc, wqc, wsc, args)
            torch.cuda.synchronize()
            got, got_acc = got.cpu(), got_acc.cpu()
            differ = int((got != want).sum())
            print(f"int8 {what} {shape} {str(dtype)[6:]}: card against CPU: "
                  f"int32 products equal {torch.equal(got_acc, want_acc)}, "
                  f"outputs differing {differ} of {want.numel()}, max|diff| "
                  f"{(got.float() - want.float()).abs().max().item()!r}",
                  flush=True)
            check(torch.equal(got_acc, want_acc),
                  f"int8 {shape}: the card's int32 products differ")
            check(torch.equal(got, want),
                  f"int8 {shape} {dtype}: the card's output differs from the "
                  f"CPU's in {differ} places")
            if dtype != torch.bfloat16 or shape[0] < 17:
                continue
            times = {name: cuda_time_ms(fn) for name, fn in parts.items()}
            times["whole"] = cuda_time_ms(lambda: product(xc, wqc, wsc))
            w = torch.randn(wq.shape, device="cuda", dtype=dtype)
            if conv:
                xn = xc.permute(0, 3, 1, 2)
                (stride, _), ((pad, _), _), _ = args
                library = "cuDNN conv2d bf16"
                times[library] = cuda_time_ms(lambda: F.conv2d(
                    xn, w, stride=stride, padding=pad))
            else:
                library = "F.linear bf16"
                times[library] = cuda_time_ms(lambda: F.linear(xc, w))
            parts_ms = sum(times[name] for name in parts)
            print(f"int8 {what} {shape} bf16 on the card (CUDA events, ms): "
                  f"{times!r}; the parts sum to {parts_ms!r}, the int8 GEMM "
                  f"is {times['_int_mm'] / parts_ms!r} of them; the whole "
                  f"product against {library}: "
                  f"{times['whole'] / times[library]!r}x; on {gpu_line}",
                  flush=True)
            _, groups, names = device_split(lambda: product(xc, wqc, wsc))
            for name, ms in sorted(names.items(), key=lambda kv: -kv[1])[:8]:
                print(f"int8 {what} {shape} bf16 profile kernel: {ms!r} ms "
                      f"{name[:120]}", flush=True)


def int8_counted():
    """Counts of the int8 products (``quant.int8_dense_matmul`` and
    ``int8_conv``, which the layers look up at each call), and a function
    that puts the originals back."""
    from tfimm_tpu_torch import quant

    counts = {"int8_dense_matmul": 0, "int8_conv": 0}
    real = {name: getattr(quant, name) for name in counts}

    def counted(name):
        def call(*args, **kwargs):
            counts[name] += 1
            return real[name](*args, **kwargs)
        return call

    for name in counts:
        setattr(quant, name, counted(name))

    def restore():
        for name, fn in real.items():
            setattr(quant, name, fn)

    return counts, restore


def int8_serving(reports, gpu_line, path, name, qmodel, fmodel, pp, requests,
                 launches, float_launches, products):
    """``qmodel`` (int8) and ``fmodel`` (float) answer ``requests``, each
    request launching ``launches`` (``float_launches``) and nothing else;
    ``qmodel``'s requests run ``products`` int8 products (name -> count)
    each. Records the int8 launch counts under ``path``; returns the int8
    model's first logits."""
    from tfimm_tpu_torch.ops.kernels import dispatch

    batch = requests[0].shape[0]
    counts, restore = int8_counted()
    try:
        dispatch.reset_launch_counts()
        seconds, logits = family_requests(qmodel, pp, requests, launches,
                                          batch=batch)
        for kname, report in reports.items():
            report["launches_by_path"][path] = dispatch.launch_counts[kname]
        want = {k: v * len(requests) for k, v in products.items()}
        check(counts == {**dict.fromkeys(counts, 0), **want},
              f"{name} int8 requests ran {counts}, expected {want}")
    finally:
        restore()
    fseconds, _ = family_requests(fmodel, pp, requests, float_launches,
                                  batch=batch)
    rates = {}
    for what, secs in (("int8", seconds), ("float", fseconds)):
        img_s = [batch / t for t in secs[1:]] or [batch / secs[0]]
        rates[what] = statistics.median(img_s)
        print(f"int8 {name} bs{batch} bf16, {what} model: request seconds "
              f"{secs!r}; {rates[what]!r} img/s (median of requests "
              f"2-{len(secs)}); launches a request "
              f"{(launches if what == 'int8' else float_launches) or 'none'};"
              f" on {gpu_line}", flush=True)
    print(f"int8 {name} bs{batch} bf16: int8 / float img/s "
          f"{rates['int8'] / rates['float']!r}; int8 products a request "
          f"{products}; on {gpu_line}", flush=True)
    img = requests[-1]
    wall_ms, groups, names = device_split(lambda: qmodel.predict(pp(img)),
                                          steps=2)
    busy_ms = sum(groups.values())
    request_ms = statistics.median(seconds[1:] or seconds) * 1e3
    int_mm_ms = sum(ms for kname, ms in names.items()
                    if "gemm_s8" in kname or "imma" in kname)
    print(f"int8 {name} request profile: device busy {busy_ms!r} ms, of it "
          f"the int8 GEMMs {int_mm_ms!r}; wall {wall_ms!r} ms under the "
          f"profiler, {request_ms!r} without; device idle share "
          f"{1.0 - busy_ms / request_ms!r}; on {gpu_line}", flush=True)
    for group, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"int8 {name} request profile: {group}: {ms!r} ms", flush=True)
    return logits


def phase_int8(reports, gpu_line):
    """Phase 46: int8 quantization on the card."""
    import copy

    import numpy as np
    import torch

    import tfimm_tpu_torch as tfm
    from tfimm_tpu_torch.architectures.segment_anything import SAMPredictor
    from tfimm_tpu_torch.ops.kernels import dispatch
    from tfimm_tpu_torch.quant import any_quantized, quantize_int8

    def rel(got, want):
        return ((got.float() - want.float()).abs().max()
                / want.float().abs().max()).item()

    def int8_layers(model):
        return [n for n, m in model.named_modules() if any_quantized(m)]

    phase_int8_products(gpu_line)
    g = torch.Generator(device="cuda").manual_seed(46)

    def requests_of(size, n=REQUESTS):
        return [torch.randint(0, 256, (BATCH, *size, 3), generator=g,
                              device="cuda", dtype=torch.uint8)
                for _ in range(n)]

    # (b) ViT-B/16.
    model = tfm.create_model(MODEL, device="cuda", dtype=torch.bfloat16,
                             seed=0)
    model.load_state_dict(seeded_state_dict(model, seed=46))
    q = quantize_int8(model)
    check(len(int8_layers(q)) == INT8_VIT_LAYERS,
          f"{MODEL}: {len(int8_layers(q))} int8 layers")
    pp = tfm.create_preprocessing(MODEL, dtype=torch.bfloat16, device="cuda")
    requests = requests_of((224, 224))
    logits = int8_serving(reports, gpu_line, "serve_vit_int8", MODEL, q,
                          model, pp, requests, INT8_VIT_LAUNCHES,
                          INT8_VIT_LAUNCHES,
                          {"int8_dense_matmul": INT8_VIT_LAYERS})
    x = pp(requests[0][:FAMILY_CHECK_IMAGES])
    q32 = copy.deepcopy(q).float()
    io = []
    hooks = [blk.register_forward_hook(
        lambda m, args, out: io.append((args[0], out))) for blk in q.blocks]
    with torch.inference_mode():
        got = q.predict(x)
        for h in hooks:
            h.remove()
        blocks = [rel(out, blk32(inp.float()))
                  for blk32, (inp, out) in zip(q32.blocks, io)]
        ref32 = q32.predict(x.float())
        float_ref = model.predict(x)
    check(bool(torch.isfinite(got).all()), "non-finite int8 logits")
    check(torch.equal(got, logits[:FAMILY_CHECK_IMAGES]),
          "the check's int8 logits differ from the request's")
    print(f"int8 {MODEL}: each block in bf16 against the same int8 block in "
          f"f32 on the bf16 block's input, largest rel err {max(blocks)!r} "
          f"(bar {INT8_TOL}): {blocks!r}; the logits end to end "
          f"{rel(got, ref32)!r} (printed); the int8 model against the float "
          f"model in bf16 {rel(got, float_ref)!r} (printed); on {gpu_line}",
          flush=True)
    check(max(blocks) < INT8_TOL, f"int8 ViT block rel err {max(blocks)}")
    del model, q, q32

    # (c) ResNet-50 with its 3x3 convs in int8.
    requests = requests_of((224, 224))
    model32, sd = calibrated_model(RESNET, 46, requests[-1][:32])
    del model32
    model = tfm.create_model(RESNET, device="cuda", dtype=torch.bfloat16,
                             seed=0)
    model.load_state_dict(sd)
    q = quantize_int8(model, convs=True)
    convs = int8_layers(q)
    check(len(convs) == INT8_RESNET_CONVS and all(
        q.get_submodule(n).weight_q.dim() == 4 for n in convs),
        f"{RESNET}: int8 layers {convs}")
    pp = tfm.create_preprocessing(RESNET, dtype=torch.bfloat16, device="cuda")
    logits = int8_serving(reports, gpu_line, "serve_resnet_int8", RESNET, q,
                          model, pp, requests, {}, {},
                          {"int8_conv": INT8_RESNET_CONVS})
    with torch.inference_mode():
        float_ref = model.predict(pp(requests[0][:FAMILY_CHECK_IMAGES]))
    print(f"int8 {RESNET} (convs=True: {convs}): the int8 model against the "
          f"float model in bf16 {rel(logits[:FAMILY_CHECK_IMAGES], float_ref)!r}"
          f" (printed); on {gpu_line}", flush=True)
    del model, q

    # (d) ConvNeXt-B and Swin-T: the gates as found.
    with restored_env("TFIMM_TPU_FUSED_CONVNEXT"):
        built = {}
        for name, switch, launches, float_launches, path in INT8_GATE_RUNS:
            os.environ["TFIMM_TPU_FUSED_CONVNEXT"] = switch
            if name not in built:
                built.clear()
                model = tfm.create_model(name, device="cuda",
                                         dtype=torch.bfloat16, seed=0)
                model.load_state_dict(seeded_state_dict(model, seed=47))
                built[name] = (model, quantize_int8(model))
            model, q = built[name]
            layers = int8_layers(q)
            pp = tfm.create_preprocessing(name, dtype=torch.bfloat16,
                                          device="cuda")
            requests = requests_of((224, 224), INT8_GATE_REQUESTS)
            int8_serving(reports, gpu_line, path, name, q, model, pp,
                         requests, launches, float_launches,
                         {"int8_dense_matmul": len(layers)})
            print(f"int8 {name} (TFIMM_TPU_FUSED_CONVNEXT={switch}): "
                  f"{len(layers)} int8 layers, from {layers[0]}; launches a "
                  f"request {launches}, the float model's {float_launches}",
                  flush=True)
        del built, model, q

    # (e) SAM-B with its image encoder in int8.
    model = tfm.create_model(SAM, device="cuda", dtype=torch.bfloat16, seed=0)
    model.load_state_dict(sam_state_dict(model, seed=46))
    qmodel = copy.deepcopy(model)
    qmodel.image_encoder = quantize_int8(model.image_encoder)
    check(len(int8_layers(qmodel.image_encoder)) == INT8_SAM_LAYERS,
          f"{SAM} encoder int8 layers {len(int8_layers(qmodel.image_encoder))}")
    image = np.random.default_rng(46).integers(0, 256, (1024, 1024, 3),
                                               dtype=np.uint8)
    ms = {}
    dispatch.reset_launch_counts()
    for what, m in (("int8", qmodel), ("float", model)):
        predictor = SAMPredictor(m)
        sam_request(predictor, image)   # warm-up
        before = dict(dispatch.launch_counts)
        results, set_l, prompt_l, set_ms, prompt_ms = sam_request(predictor,
                                                                  image)
        check(set_l == expected(**SAM_LAUNCHES), f"{what} set_image launched "
              f"{set_l}, expected {SAM_LAUNCHES} and nothing else")
        check(prompt_l == expected(), f"the prompt calls launched {prompt_l}")
        check(bool(torch.isfinite(predictor.image_embedding).all()),
              "non-finite image embedding")
        check(all(np.isfinite(r[2]).all() for r in results),
              "non-finite decoder logits")
        if what == "int8":
            for kname, report in reports.items():
                report["launches_by_path"]["serve_sam_int8"] = \
                    dispatch.launch_counts[kname] - before[kname]
            emb = predictor.image_embedding.float()
        ms[what] = (set_ms, prompt_ms)
        print(f"int8 {SAM} ({what} image encoder) 1024x1024: set_image "
              f"{set_ms!r} ms, prompt calls {prompt_ms!r} ms (CUDA events); "
              f"launches {set_l['flash_attention_relpos']} + "
              f"{prompt_l['flash_attention_relpos']}; on {gpu_line}",
              flush=True)
    print(f"int8 {SAM}: set_image int8 / float {ms['int8'][0] / ms['float'][0]!r};"
          f" the int8 embedding against the float one "
          f"{rel(emb, predictor.image_embedding)!r} (printed)", flush=True)
    del model, qmodel


def ckpt_config(ckpt_dir, nb_epochs) -> dict:
    """Phase 4's ViT-B/16 recipe, CKPT_STEPS steps an epoch on CKPT_STEPS x
    TRAIN_BATCH fixed synthetic images, checkpointed into ``ckpt_dir``."""
    config = train_config()
    images = CKPT_STEPS * TRAIN_BATCH
    config["trainer"] = dict(config["trainer"], ckpt_dir=ckpt_dir,
                             ckpt_every_it=CKPT_EVERY, ckpt_to_keep=CKPT_KEEP)
    config["train_dataset"] = dict(config["train_dataset"], nb_samples=images)
    config["timekeeping"] = {"nb_epochs": nb_epochs, "batch_size": TRAIN_BATCH,
                             "nb_samples_per_epoch": images}
    return config


def orbax_kept(saves) -> list:
    """The steps orbax's manager keeps of the trainer's ``saves`` (in
    order) with ``max_to_keep=CKPT_KEEP`` and a 12 h
    ``keep_time_interval``, every save within 12 h of the first: a save
    not above the latest step is skipped, and after each save the first
    step and the CKPT_KEEP newest stay."""
    kept = []
    for step in saves:
        if kept and step <= kept[-1]:
            continue
        kept.append(step)
        kept = sorted({kept[0], *kept[-CKPT_KEEP:]})
    return kept


def stored_epoch(ckpt_dir, step) -> int:
    import torch

    return torch.load(os.path.join(ckpt_dir, str(step), "state.pt"),
                      map_location="cpu", weights_only=True, mmap=True)["epoch"]


def check_steps(what, steps, nb_blocks):
    for it, (loss, seconds, rose) in enumerate(steps):
        print(f"{what} step {it}: loss {loss!r}, {seconds!r} s, launches "
              f"{rose}", flush=True)
        check(rose == expected(fused_mha=nb_blocks, fused_mha_bwd=nb_blocks),
              f"{what} step {it} launched {rose}, expected {nb_blocks} of "
              f"each attention kernel")
        check(math.isfinite(loss), f"{what} step {it}: loss {loss}")


def ckpt_resume(reports, gpu_line, root):
    """Phase 47 (a): runs A, B (resumed from A) and C (uninterrupted) of
    ViT-B/16 through run() with checkpoints. Returns run C's trainer."""
    import torch

    import tfimm_tpu_torch.train as ttrain
    from tfimm_tpu_torch.ops.kernels.fused_mha import fused_mha_bwd
    from tfimm_tpu_torch.train import checkpoint

    # B can end bit for bit where C ends only if the backward repeats.
    qkv = mha_input(TRAIN_BATCH, 197, 12, 64, torch.bfloat16, seed=47)
    g = mha_input(TRAIN_BATCH, 197, 4, 64, torch.bfloat16, seed=48)
    repeats = torch.equal(fused_mha_bwd(qkv, g, 12, 0.125),
                          fused_mha_bwd(qkv, g, 12, 0.125))
    print(f"ckpt: fused_mha_bwd at (B, N, H, d) = ({TRAIN_BATCH}, 197, 12, "
          f"64) repeats bit for bit: {repeats}", flush=True)
    check(repeats, "fused_mha_bwd does not repeat bit for bit on the card")
    del qkv, g

    a_dir, c_dir = os.path.join(root, "a"), os.path.join(root, "c")
    saves, loads = [], []
    real_save, real_load = checkpoint.CheckpointManager.save, \
        ttrain.Trainer._load_ckpt
    run_a = {}

    def timed_save(self, step, state):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        written = real_save(self, step, state)
        saves.append((self.directory, step, time.perf_counter() - t0,
                      written))
        return written

    def checked_load(self):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        real_load(self)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        loads.append(seconds)
        if self.cfg.ckpt_dir != a_dir or "problem" not in run_a:
            return
        # Run B, just restored: A's state at its last step, bit for bit.
        was, now = run_a["problem"], self.problem
        check(now.epoch == was.epoch == 1
              and now.optimizer.step_count == was.optimizer.step_count
              == CKPT_STEPS, f"B restored epoch {now.epoch} and step count "
              f"{now.optimizer.step_count}; A ended at {was.epoch} and "
              f"{was.optimizer.step_count}")
        sw, sn = was.model.state_dict(), now.model.state_dict()
        check(all(torch.equal(sn[k], v) for k, v in sw.items()),
              "B's restored parameters differ from A's")
        ow = was.optimizer.state_dict()["optimizer"]["state"]
        on = now.optimizer.state_dict()["optimizer"]["state"]
        check(len(on) == len(ow) and all(
            torch.equal(on[i][k], v.to(on[i][k].device)) for i in ow
            for k, v in ow[i].items()), "B's restored Adam moments differ "
            "from A's")
        print(f"ckpt: B restored step {was.optimizer.step_count}, epoch "
              f"{now.epoch} and the Adam moments of {len(on)} tensors bit "
              f"for bit in {seconds!r} s (torch.load of the latest step to "
              f"the card, warm page cache, and load_state_dict) on "
              f"{gpu_line}", flush=True)

    checkpoint.CheckpointManager.save = timed_save
    ttrain.Trainer._load_ckpt = checked_load
    try:
        a, steps, _ = run_watched(ckpt_config(a_dir, 1))
        nb_blocks = a.problem.model.cfg.nb_blocks
        check(len(steps) == CKPT_STEPS, f"run A took {len(steps)} steps")
        check_steps("ckpt run A", steps, nb_blocks)
        check(sorted(int(n) for n in os.listdir(a_dir) if n.isdigit())
              == orbax_kept([2, 3]), f"A kept {sorted(os.listdir(a_dir))}")
        run_a["problem"] = a.problem
        b, steps_b, counts = run_watched(ckpt_config(a_dir, 2))
        check(len(loads) == 2 and "problem" in run_a, "B was not restored")
        check(len(steps_b) == CKPT_STEPS, f"run B took {len(steps_b)} steps")
        check_steps("ckpt run B", steps_b, nb_blocks)
        for name, report in reports.items():
            report["launches_by_path"]["train_vit_resumed"] = counts[name]
        del a, run_a["problem"]
        c, steps_c, _ = run_watched(ckpt_config(c_dir, 2))
        check(len(steps_c) == 2 * CKPT_STEPS, f"run C took {len(steps_c)} "
              f"steps")
        check_steps("ckpt run C", steps_c, nb_blocks)
    finally:
        checkpoint.CheckpointManager.save = real_save
        ttrain.Trainer._load_ckpt = real_load

    # The trainer saves at every CKPT_EVERY-th step and at each epoch's end:
    # A at 2 and 3, B at 4, 6 and 6 (skipped), C at all five.
    for what, directory, made in (("A and B", a_dir, [2, 3, 4, 6, 6]),
                                  ("C", c_dir, [2, 3, 4, 6, 6])):
        kept = sorted(int(n) for n in os.listdir(directory) if n.isdigit())
        written = [step for d, step, _, w in saves if d == directory and w]
        skipped = [step for d, step, _, w in saves if d == directory and not w]
        print(f"ckpt {what}: saves {made}, written {written}, skipped "
              f"{skipped}, kept {kept}; epochs stored "
              f"{ {s: stored_epoch(directory, s) for s in kept} }", flush=True)
        check([s for d, s, _, _ in saves if d == directory] == made,
              f"{what}: the trainer saved at {saves}")
        check(kept == orbax_kept(made), f"{what} kept {kept}, orbax's rules "
              f"keep {orbax_kept(made)}")
        check(skipped == [6] and stored_epoch(directory, 6) == 1,
              f"{what}: skipped {skipped}, step 6 holds epoch "
              f"{stored_epoch(directory, 6)}, expected the skipped epoch-end "
              f"save to leave epoch 1")
        check(sorted(os.listdir(os.path.join(directory, "model")))
              == ["config.json", "model.pt2", "params.npz"],
              f"{what}: save_model wrote {os.listdir(os.path.join(directory, 'model'))}"
              f" (no model.pt2: its export failed, see the warning above)")

    sb, sc = b.problem.model.state_dict(), c.problem.model.state_dict()
    diff = max((sb[k].float() - v.float()).abs().max().item()
               for k, v in sc.items())
    ob = b.problem.optimizer.state_dict()["optimizer"]["state"]
    oc = c.problem.optimizer.state_dict()["optimizer"]["state"]
    print(f"ckpt: B (resumed) against C (uninterrupted) after "
          f"{2 * CKPT_STEPS} steps: largest parameter difference {diff!r}",
          flush=True)
    check(diff == 0.0 and all(torch.equal(sb[k], v) for k, v in sc.items()),
          f"B's parameters differ from C's by up to {diff}")
    check(all(torch.equal(ob[i][k], v.to(ob[i][k].device)) for i in oc
              for k, v in oc[i].items()), "B's Adam moments differ from C's")
    check(b.problem.optimizer.step_count == c.problem.optimizer.step_count
          == 2 * CKPT_STEPS and b.problem.epoch == c.problem.epoch == 2,
          "B and C ended at different steps or epochs")
    del b
    step_dir = os.path.join(c_dir, "6")
    size = sum(os.path.getsize(os.path.join(step_dir, n))
               for n in os.listdir(step_dir))
    params = sum(t.numel() * t.element_size() for t in sc.values())
    save_s = [s for _, _, s, w in saves if w]
    print(f"ckpt {MODEL} bs{TRAIN_BATCH} adamw: a step's checkpoint "
          f"{size!r} bytes ({params!r} of f32 parameters and buffers); "
          f"{len(save_s)} saves {save_s!r} s (median "
          f"{statistics.median(save_s)!r}); restore {loads[1]!r} s; "
          f"train img/s (steps 2-{2 * CKPT_STEPS} of C) "
          f"{TRAIN_BATCH * (len(steps_c) - 1) / sum(s for _, s, _ in steps_c[1:])!r}"
          f" on {gpu_line}", flush=True)
    return c


def export_serving(reports, gpu_line, c):
    """Phase 47 (b): C's model/ loaded on the card, exported and served."""
    import importlib

    import torch

    import tfimm_tpu_torch as tfm
    from tfimm_tpu_torch.ops.kernels import dispatch
    from tfimm_tpu_torch.ops.kernels.fused_mha import fused_mha
    from tfimm_tpu_torch.utils.export import export_model, load_exported

    model_dir = os.path.join(c.cfg.ckpt_dir, "model")
    loaded = tfm.load_model(model_dir, device="cuda")
    want = c.problem.model.state_dict()
    got = loaded.state_dict()
    check(set(got) == set(want) and all(torch.equal(got[k], v)
                                        for k, v in want.items()),
          "load_model of C's model/ differs from C's parameters")
    print(f"export: load_model of C's model/ on the card equals C's "
          f"parameters bit for bit", flush=True)
    path = os.path.join(model_dir, "exported_here.pt2")
    t0 = time.perf_counter()
    export_model(loaded, path, normalize_logits=True)
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    exported = load_exported(path)
    load_s = time.perf_counter() - t0
    check(exported.device.type == "cuda", f"load_exported gave a program on "
          f"{exported.device}")
    nb_blocks = loaded.cfg.nb_blocks
    gen = torch.Generator(device="cuda").manual_seed(47)
    requests = [torch.randint(0, 256, (EXPORT_BATCHES[0], 224, 224, 3),
                              generator=gen, device="cuda", dtype=torch.uint8)
                for _ in range(REQUESTS)]
    odd = torch.randint(0, 256, (EXPORT_BATCHES[1], 224, 224, 3),
                        generator=gen, device="cuda", dtype=torch.uint8)
    torch.cuda.synchronize()
    dispatch.reset_launch_counts()
    seconds, outputs = [], []
    for img in requests + [odd]:
        before = dict(dispatch.launch_counts)
        t0 = time.perf_counter()
        out = exported(img)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        rose = {k: dispatch.launch_counts[k] - before[k] for k in before}
        check(rose == expected(fused_mha=nb_blocks), f"one call of the "
              f"exported program launched {rose}, expected {nb_blocks} "
              f"fused_mha and nothing else")
        check(tuple(out.shape) == (len(img), loaded.cfg.nb_classes)
              and out.dtype == torch.float32
              and bool(torch.isfinite(out).all()),
              f"the exported program gave {tuple(out.shape)} {out.dtype}")
        outputs.append(out)
    counts = dict(dispatch.launch_counts)
    for name, report in reports.items():
        report["launches_by_path"]["serve_vit_exported"] = counts[name]
    pp = tfm.create_preprocessing(MODEL, device="cuda")
    for img, out in ((requests[0], outputs[0]), (odd, outputs[-1])):
        with torch.no_grad():
            ref = torch.log_softmax(loaded(pp(img)).float(), dim=-1)
        err = (out - ref).abs().max().item()
        print(f"export: bs{len(img)} log-probabilities of the exported "
              f"program vs the eager f32 model: max abs diff {err!r} (bar "
              f"{EXPORT_TOL})", flush=True)
        check(err <= EXPORT_TOL, f"bs{len(img)}: the exported program is "
              f"{err} from the eager model")
    eager = []
    for img in requests:
        t0 = time.perf_counter()
        loaded.predict(pp(img))
        torch.cuda.synchronize()
        eager.append(time.perf_counter() - t0)
    img_s = [EXPORT_BATCHES[0] / t for t in seconds[1:REQUESTS]]
    eager_s = [EXPORT_BATCHES[0] / t for t in eager[1:]]
    print(f"export {MODEL} f32: export_model {export_s!r} s, load_exported "
          f"{load_s!r} s; bs{EXPORT_BATCHES[0]} exported program "
          f"{statistics.median(img_s)!r} img/s (median of requests "
          f"2-{REQUESTS}; range {min(img_s)!r}-{max(img_s)!r}) against "
          f"model.predict {statistics.median(eager_s)!r} img/s (range "
          f"{min(eager_s)!r}-{max(eager_s)!r}); bs{EXPORT_BATCHES[1]} "
          f"{seconds[-1] * 1e3!r} ms; on {gpu_line}", flush=True)
    del exported, loaded, requests

    # What the op adds to a no-grad call: the host time of fused_mha through
    # tfimm_tpu_torch::fused_mha beside its wrapper called directly.
    module = importlib.import_module("tfimm_tpu_torch.ops.kernels.fused_mha")
    qkv = mha_input(BATCH, 197, 12, 64, torch.bfloat16, seed=49)
    with torch.no_grad():
        op_ms = host_ms_per_call("fused_mha through the custom op",
                                 lambda: fused_mha(qkv, 12, 0.125))
        direct_ms = host_ms_per_call(
            "fused_mha's wrapper called directly",
            lambda: module._fused_mha_forward(qkv, 12, 0.125))
    print(f"export: fused_mha bf16 (B, N, H, d) = ({BATCH}, 197, 12, 64) host "
          f"ms a call through the op {op_ms!r}, the wrapper directly "
          f"{direct_ms!r}: the dispatcher adds {op_ms - direct_ms!r} ms a "
          f"call, {nb_blocks * (op_ms - direct_ms)!r} ms a request; on "
          f"{gpu_line}", flush=True)


def distill_config(teacher_dir) -> dict:
    """A ViT-B/32 student without a head distilled from the saved ViT-B/16
    (a ``SavedModel`` with the teacher's own mean and std on the 0-255
    scale): bs128, bf16 mixed precision, Adam at lr 1e-4, DISTILL_STEPS
    epochs of one step on the same synthetic images."""
    import tfimm_tpu_torch as tfm

    cfg = tfm.model_config(MODEL)
    data = {"batch_size": DISTILL_BATCH, "nb_samples": DISTILL_BATCH,
            "input_size": (224, 224), "nb_classes": 1000, "seed": 0}
    return {
        "trainer_class": "Trainer",
        "trainer": {"validation_before_training": False,
                    "display_loss_every_it": 1},
        "problem_class": "DistillationProblem",
        "problem": {"teacher_class": "SavedModel",
                    "teacher": {"path": teacher_dir,
                                "mean": tuple(255.0 * m for m in cfg.mean),
                                "std": tuple(255.0 * s for s in cfg.std)},
                    "student_class": "ModelFactory",
                    "student": {"model_name": DISTILL_STUDENT,
                                "nb_classes": 0},
                    "optimizer_class": "OptimizerFactory",
                    "optimizer": {"optimizer": "adam",
                                  "lr_schedule_class": "LRConstFactory",
                                  "lr_schedule": {"lr": 1e-4}},
                    "mixed_precision": True},
        "train_dataset_class": "SyntheticDataset", "train_dataset": data,
        "timekeeping_class": "Timekeeping",
        "timekeeping": {"nb_epochs": DISTILL_STEPS,
                        "batch_size": DISTILL_BATCH,
                        "nb_samples_per_epoch": DISTILL_BATCH},
        "device": "cuda",
    }


def distillation(reports, gpu_line, teacher_dir):
    """Phase 47 (c): ViT-B/16 -> ViT-B/32 distillation through run()."""
    import torch

    trainer, steps, counts = run_watched(distill_config(teacher_dir),
                                         problem="DistillationProblem")
    problem = trainer.problem
    check(len(steps) == DISTILL_STEPS, f"{len(steps)} distillation steps")
    for it, (loss, seconds, rose) in enumerate(steps):
        print(f"distill step {it}: loss {loss!r}, {seconds!r} s, launches "
              f"{rose}", flush=True)
        check(rose == expected(**DISTILL_LAUNCHES), f"distillation step {it} "
              f"launched {rose}, expected {DISTILL_LAUNCHES}")
        check(math.isfinite(loss), f"distillation step {it}: loss {loss}")
    check(steps[-1][0] < steps[0][0], f"the distillation loss did not fall: "
          f"{steps[0][0]} -> {steps[-1][0]}")
    for name, report in reports.items():
        report["launches_by_path"]["train_distill"] = counts[name]
    timed = [s for _, s, _ in steps[1:]]
    step_s = sum(timed) / len(timed)
    print(f"distill {MODEL} -> {DISTILL_STUDENT} bs{DISTILL_BATCH} bf16 "
          f"adam: {DISTILL_BATCH * len(timed) / sum(timed)!r} img/s "
          f"({len(timed)} steps 2-{DISTILL_STEPS} in {sum(timed) * 1e3!r} ms; "
          f"median step {statistics.median(timed) * 1e3!r} ms) on {gpu_line}",
          flush=True)

    # One seeded step: bf16 through the kernels (train_step) against f32
    # through the plain attention (capturing the attention weights makes
    # every block decline the kernels), both teacher and student.
    student, teacher = problem.student, problem.teacher
    student.load_state_dict(seeded_state_dict(student, seed=47))
    teacher.load_state_dict(seeded_state_dict(teacher, seed=48))
    images, labels = next(iter(trainer.train_ds))
    x = torch.as_tensor(images, device="cuda")
    names = ("blocks.0.attn.qkv.weight", "blocks.11.mlp.fc2.weight")

    def plain_embeddings(model, pp):
        emb = model(pp(x), features_only=True, return_features=True)[0]
        emb = emb.float()
        return emb / (torch.linalg.vector_norm(emb, dim=-1, keepdim=True)
                      + 1e-8)

    def reference():
        teacher.eval()
        with torch.no_grad():
            target = plain_embeddings(teacher, problem.teacher_preprocessing)
        student.train()
        student.zero_grad(set_to_none=True)
        loss = torch.mean(torch.square(
            plain_embeddings(student, problem.student_preprocessing) - target))
        loss.backward()
        params = dict(student.named_parameters())
        return loss.item(), {n: params[n].grad.float().clone() for n in names}

    (loss_r, grads_r), rose = launches_of(reference)
    check(rose == expected(), f"the f32 reference launched {rose}")
    (loss_k, _), rose = launches_of(lambda: problem.train_step(
        (images, labels), 0))
    check(rose == expected(**DISTILL_LAUNCHES), f"the seeded bf16 step "
          f"launched {rose}")
    params = dict(student.named_parameters())
    rel = abs(loss_k - loss_r) / abs(loss_r)
    print(f"distill loss: bf16 kernel path {loss_k!r} vs f32 plain path "
          f"{loss_r!r}, rel err {rel!r} (bar 2e-2)", flush=True)
    check(rel < 2e-2, f"distillation loss rel err {rel} >= 2e-2")
    for name in names:
        ref = grads_r[name]
        rel = ((params[name].grad.float() - ref).abs().max()
               / ref.abs().max()).item()
        print(f"distill grad {name}: max|diff| / max|ref| {rel!r} (bar 1e-1)",
              flush=True)
        check(rel < 1e-1, f"{name} gradient rel err {rel} >= 1e-1")
        check(ref.abs().max().item() > 0, f"{name}: zero reference gradient")

    batch = (images, labels)
    wall_ms, groups, _ = device_split(lambda: problem.train_step(batch, 0))
    busy_ms = sum(groups.values())
    print(f"distill step profile: device busy {busy_ms!r} ms per step; wall "
          f"{wall_ms!r} ms under the profiler, {step_s * 1e3!r} ms without; "
          f"device idle share {1.0 - busy_ms / (step_s * 1e3)!r}", flush=True)
    for group, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"distill step profile: {group}: {ms!r} ms per step",
              flush=True)


def embedding_factory(gpu_line):
    """Phase 47 (d): EmbeddingModelFactory over ViT-B/16 on the card."""
    import copy

    import torch

    import tfimm_tpu_torch as tfm
    import tfimm_tpu_torch.train as ttrain

    factory = ttrain.get_class("EmbeddingModelFactory")(
        cfg=ttrain.EmbeddingModelConfig(backbone_name=MODEL,
                                        embed_dim=EMBED_FACTORY_DIM))
    model, pp = factory(device="cuda")
    check(isinstance(model, tfm.EmbeddingModel)
          and model.backbone.cfg.nb_classes == 0,
          f"EmbeddingModelFactory built {type(model).__name__}")
    model.backbone.load_state_dict(seeded_state_dict(model.backbone, seed=50))
    model16 = copy.deepcopy(model).to(torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(50)
    x = torch.randint(0, 256, (BATCH, 224, 224, 3), generator=gen,
                      device="cuda", dtype=torch.uint8)
    with torch.inference_mode():
        out, rose = launches_of(lambda: model16(pp(x).to(torch.bfloat16)))
        torch.cuda.synchronize()
        check(rose == expected(fused_mha=model.backbone.cfg.nb_blocks),
              f"the bf16 embedding forward launched {rose}")
        (ref, _), rose = launches_of(lambda: model(pp(x),
                                                   return_features=True))
        check(rose == expected(), f"the f32 reference launched {rose}")
    check(tuple(out.shape) == (BATCH, EMBED_FACTORY_DIM)
          and bool(torch.isfinite(out).all()),
          f"the factory's model gave {tuple(out.shape)}")
    rel = ((out.float() - ref).abs().max() / ref.abs().max()).item()
    print(f"EmbeddingModelFactory({MODEL}, embed_dim={EMBED_FACTORY_DIM}) "
          f"bs{BATCH} bf16: {tuple(out.shape)}, 12 fused_mha, vs f32 plain "
          f"path rel err {rel!r} (bar 5e-2) on {gpu_line}", flush=True)
    check(rel < 5e-2, f"embedding rel err {rel} >= 5e-2")


def phase_ckpt_export_distill(reports, gpu_line):
    """Phase 47: checkpoints, the deployment artifact, distillation and the
    embedding factory (``ckpt_resume``, ``export_serving``,
    ``distillation``, ``embedding_factory``), in a temporary directory."""
    import tempfile

    import torch

    with tempfile.TemporaryDirectory() as root:
        c = ckpt_resume(reports, gpu_line, root)
        export_serving(reports, gpu_line, c)
        teacher_dir = os.path.join(c.cfg.ckpt_dir, "model")
        del c
        torch.cuda.empty_cache()
        distillation(reports, gpu_line, teacher_dir)
    torch.cuda.empty_cache()
    embedding_factory(gpu_line)


def main(argv) -> int:
    all_phases = list(range(2, 48))
    phases = all_phases
    if argv[:1] == ["--phases"] and len(argv) == 2:
        phases = sorted({int(p) for p in argv[1].split(",")})
        if not set(phases) <= set(all_phases):
            print("chip_smoke: --phases takes numbers from 2 to 47",
                  file=sys.stderr)
            return 2
    elif argv:
        print("usage: chip_smoke.py [--phases N,N,...]", file=sys.stderr)
        return 2
    if not (REPO / "tfimm_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run it from a checkout of the repository "
              "(tfimm_tpu_torch/ not found beside it)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke run "
              "needs an NVIDIA card", file=sys.stderr)
        return 1

    from tfimm_tpu_torch.ops.kernels import build

    try:
        print(f"python {sys.version.split()[0]} torch {torch.__version__} "
              f"cuda {torch.version.cuda}", flush=True)
        print(run([build.find_nvcc(), "--version"]).splitlines()[-1], flush=True)
        gpu_line = run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"]).splitlines()[0]
        print(gpu_line, flush=True)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        print(f"allow_tf32: matmul {torch.backends.cuda.matmul.allow_tf32} "
              f"cudnn {torch.backends.cudnn.allow_tf32}", flush=True)
        t0 = time.perf_counter()
        log = io.StringIO()
        with contextlib.redirect_stdout(log):
            build.kernel_library(verbose=True)
        print(log.getvalue(), flush=True)
        print(f"kernel build {time.perf_counter() - t0!r} s", flush=True)
        print_registers(log.getvalue())

        reports = {
            "fused_mha": {"name": "fused_mha", "route": "cuda",
                          "source": "tfimm_tpu_torch/csrc/fused_mha.cu",
                          "replaces": "tfimm_tpu/ops/pallas/fused_mha.py:136"},
            "fused_mha_bwd": {"name": "fused_mha_bwd", "route": "cuda",
                              "source": "tfimm_tpu_torch/csrc/fused_mha_bwd.cu",
                              "replaces": "tfimm_tpu/ops/pallas/fused_mha.py:267"},
            "convnext_mlp": {"name": "convnext_mlp", "route": "cuda",
                             "source": "tfimm_tpu_torch/csrc/convnext_mlp.cu",
                             "replaces": "tfimm_tpu/ops/pallas/convnext_mlp.py:90"},
            "window_mha": {"name": "window_mha", "route": "cuda",
                           "source": "tfimm_tpu_torch/csrc/window_mha.cu",
                           "replaces": "tfimm_tpu/ops/pallas/window_mha.py:225"},
            "swin_block": {"name": "swin_block", "route": "cuda",
                           "source": "tfimm_tpu_torch/csrc/swin_block.cu",
                           "replaces": "tfimm_tpu/ops/pallas/swin_block.py:103"},
            "window_mha_bwd": {
                "name": "window_mha_bwd", "route": "cuda",
                "source": "tfimm_tpu_torch/csrc/window_mha_bwd.cu",
                "replaces": "tfimm_tpu/ops/pallas/window_mha.py:417"},
        }
        reports["fused_mha"]["work"] = f"bf16 (B, N, H, d) = {MHA_SHAPES[0]}"
        reports["fused_mha_bwd"]["work"] = f"bf16 (B, N, H, d) = {BWD_SHAPES[0]}"
        reports["convnext_mlp"]["work"] = (
            f"bf16, one {CONVNEXT} bs{BATCH} request: " + " + ".join(
                f"{n} x (M, C, H) = {shape}"
                for n, shape in zip(CONVNEXT_DEPTHS, CONVNEXT_STAGES)))
        reports["window_mha"]["work"] = (
            f"bf16 (BW, N, C, H) = {SWIN_STAGE4[:4]}, no mask, operands out "
            f"of L2; 'stages': every stage shape of a {SWIN} bs{BATCH} "
            f"request and the request's sums")
        reports["swin_block"]["work"] = (
            f"bf16, one {SWIN} bs{BATCH} request: " + " + ".join(
                f"{n} x (BW, N, C, H) = {shape[:4]}, half shifted"
                for n, shape in zip(SWIN_DEPTHS, SWIN_STAGES)))
        reports["window_mha_bwd"]["work"] = (
            f"bf16, one {SWIN} bs{SWIN_TRAIN_BATCH} training step: "
            + " + ".join(f"{n} x (BW, N, C, H) = {shape[:4]}"
                         for n, shape in zip(SWIN_TRAIN_DEPTHS,
                                             SWIN_TRAIN_STAGES))
            + ", half of stages 1-3 shifted; operands out of L2 (two "
            "launches, counted as one)")
        reports["talking_head_attention"] = {
            "name": "talking_head_attention", "route": "cuda",
            "source": "tfimm_tpu_torch/csrc/cait_attention.cu",
            "replaces": "tfimm_tpu/ops/pallas/cait_attention.py:95",
            "work": (f"bf16 (B, N, H, d) = {CAIT_SHAPES[0]}, operands out of "
                     f"L2; 'warm_ms' back to back; 'host_ms' the wrapper's "
                     f"host time a call")}
        reports["talking_head_attention_bwd"] = {
            "name": "talking_head_attention_bwd", "route": "cuda",
            "source": "tfimm_tpu_torch/csrc/cait_attention_bwd.cu",
            "replaces": "tfimm_tpu/ops/pallas/cait_attention.py:241",
            "work": (f"bf16 (B, N, H, d) = {CAIT_BWD_SHAPES[0]}, with the "
                     f"forward's log2 l as under autograd (three launches, "
                     f"counted as one); 'recompute_ms': without it; operands "
                     f"out of L2; 'host_ms' the wrapper's host time a call")}
        reports["flash_attention_relpos"] = {
            "name": "flash_attention_relpos", "route": "cuda",
            "source": "tfimm_tpu_torch/csrc/flash_attention_relpos.cu",
            "replaces": "tfimm_tpu/ops/pallas/flash_attention_relpos.py:247",
            "work": (f"bf16 (B, gh, gw, d) = {RELPOS_SHAPES[0]}: one {SAM} "
                     f"global block of one 1024x1024 image; 'windowed': "
                     f"{RELPOS_SHAPES[1]}, one windowed block")}
        reports["flash_attention_relpos_bwd"] = {
            "name": "flash_attention_relpos_bwd", "route": "cuda",
            "source": "tfimm_tpu_torch/csrc/flash_attention_relpos_bwd.cu",
            "replaces": "tfimm_tpu/ops/pallas/flash_attention_relpos.py:617",
            "work": (f"bf16 (B, gh, gw, d) = {RELPOS_SHAPES[0]}: one {SAM} "
                     f"global block's backward (two launches, counted as "
                     f"one; the bf16 kernel forms delta in the first); "
                     f"'windowed': {RELPOS_SHAPES[1]}")}
        reports["pvt_sra"] = {
            "name": "pvt_sra", "route": "cuda",
            "source": "tfimm_tpu_torch/csrc/pvt_sra.cu",
            "replaces": "tfimm_tpu/ops/pallas/pvt_sra.py:63",
            "work": (f"bf16 (B, N, S, C) = {SRA_SHAPES[0]}: the stage-1 "
                     f"attention of pvt_v2_b2 at bs{BATCH}")}
        reports["poolformer_block"] = {
            "name": "poolformer_block", "route": "cuda",
            "source": "tfimm_tpu_torch/csrc/poolformer_block.cu",
            "replaces": "tfimm_tpu/ops/pallas/poolformer_block.py:97",
            "work": (f"bf16, one {POOLFORMER} bs{BATCH} request: " + " + ".join(
                f"{n} x (B, H, W, C, hidden) = {shape}"
                for n, shape in zip(POOL_DEPTHS, POOL_STAGES))
                + " (five launches, counted as one)")}
        reports["convnext_block"] = {
            "name": "convnext_block", "route": "cuda",
            "source": "tfimm_tpu_torch/csrc/convnext_block.cu",
            "replaces": "tfimm_tpu/ops/pallas/convnext_block.py:74",
            "work": (f"bf16, one {CONVNEXT} bs{BATCH} request with "
                     f"TFIMM_TPU_FUSED_CONVNEXT=1: " + " + ".join(
                         f"{n} x (B, H, W, C, hidden) = {shape}"
                         for n, shape in zip(CONVNEXT_DEPTHS,
                                             CONVNEXT_BLOCK_STAGES))
                     + " (three launches, counted as one)")}
        reports["flash_attention"] = {
            "name": "flash_attention", "route": "cuda",
            "source": "tfimm_tpu_torch/csrc/flash_attention.cu",
            "replaces": "tfimm_tpu/ops/pallas/flash_attention_kernel.py:74",
            "work": (f"bf16 (B, H, N, d) = {FLASH_SHAPE}: one block of a "
                     f"{VIT512} bs{VIT512_BATCH} request at 512x512; "
                     f"'sam_global': {FLASH_SAM_SHAPE}; operands out of L2")}
        reports["flash_attention_bwd"] = {
            "name": "flash_attention_bwd", "route": "cuda",
            "source": "tfimm_tpu_torch/csrc/flash_attention_bwd.cu",
            "replaces": "tfimm_tpu/ops/pallas/flash_attention_kernel.py:189",
            "work": (f"bf16 (B, H, N, d) = {FLASH_TRAIN_SHAPE}: one block's "
                     f"backward of a {VIT512} bs{VIT512_TRAIN_BATCH} training "
                     f"step at 512x512 (two launches, counted as one; the "
                     f"bf16 kernel up to d = 128 forms delta in the first); "
                     f"'sam_global': {FLASH_SAM_SHAPE}; operands out of L2")}
        reports["ln_dense"] = {
            "name": "ln_dense", "route": "cuda",
            "source": "tfimm_tpu_torch/csrc/ln_dense.cu",
            "replaces": "tfimm_tpu/ops/pallas/ln_dense.py:84",
            "work": (f"bf16 (M, C, O) = {LN_DENSE_TRAIN[0]}: ViT-B/16's LN1 "
                     f"-> qkv at training bs64 (row statistics and the GEMM, "
                     f"two launches counted as one); 'shapes': LN2 -> fc1 and "
                     f"serving bs128; operands out of L2")}
        reports["ln_dense_bwd"] = {
            "name": "ln_dense_bwd", "route": "cuda",
            "source": "tfimm_tpu_torch/csrc/ln_dense.cu",
            "replaces": "tfimm_tpu/ops/pallas/ln_dense.py:139",
            "work": (f"bf16 (M, C, O) = {LN_DENSE_TRAIN[0]}: the backward of "
                     f"ViT-B/16's LN1 -> qkv at bs64 (_bwd_dx_call at :139 "
                     f"and _bwd_dw_call at :211: dx, dgamma, dbeta, dW and "
                     f"db in seven launches counted as one); 'shapes': LN2 "
                     f"-> fc1; operands out of L2")}
        for report in reports.values():
            report["launches_by_path"] = {}
        run_phase = {
            2: lambda: (phase_kernels(reports["fused_mha"], gpu_line),
                        phase_backward_kernel(reports["fused_mha_bwd"],
                                              gpu_line)),
            3: lambda: phase_slice(reports, gpu_line),
            4: lambda: phase_train(reports, gpu_line),
            5: lambda: phase_convnext_kernel(reports["convnext_mlp"]),
            6: lambda: phase_convnext_slice(reports, gpu_line),
            7: lambda: phase_swin_kernels(reports, gpu_line),
            8: lambda: phase_swin_slice(reports, gpu_line),
            9: lambda: phase_window_bwd_kernel(reports["window_mha_bwd"],
                                               gpu_line),
            10: lambda: phase_swin_train(reports, gpu_line),
            11: lambda: phase_cait_kernel(reports["talking_head_attention"],
                                          gpu_line),
            12: lambda: phase_cait_slice(reports, gpu_line),
            13: lambda: phase_cait_bwd_kernel(
                reports["talking_head_attention_bwd"], gpu_line),
            14: lambda: phase_cait_train(reports, gpu_line),
            15: lambda: phase_relpos_kernel(reports["flash_attention_relpos"],
                                            gpu_line),
            16: lambda: phase_sam_slice(reports, gpu_line),
            17: lambda: phase_relpos_bwd_kernel(
                reports["flash_attention_relpos_bwd"], gpu_line),
            18: lambda: phase_sam_train(reports, gpu_line),
            19: lambda: phase_sra_kernel(reports["pvt_sra"], gpu_line),
            20: lambda: family_serving(reports, gpu_line, "serve_pvt",
                                       "pvt_sra", "TFIMM_TPU_FUSED_PVT_SRA",
                                       PVT_RUNS, seed=20),
            21: lambda: phase_pool_kernel(reports["poolformer_block"],
                                          gpu_line),
            22: lambda: family_serving(
                reports, gpu_line, "serve_poolformer", "poolformer_block",
                "TFIMM_TPU_FUSED_POOLFORMER",
                [(POOLFORMER, sw, n) for sw, n in POOLFORMER_RUNS], seed=22),
            23: lambda: phase_convnext_block_kernel(reports["convnext_block"],
                                                    gpu_line),
            24: lambda: family_serving(
                reports, gpu_line, "serve_convnext_fused", "convnext_block",
                "TFIMM_TPU_FUSED_CONVNEXT",
                [(CONVNEXT, sw, n) for sw, n in CONVNEXT_FUSED_RUNS], seed=24),
            25: lambda: phase_convnext_train(reports, gpu_line),
            26: lambda: phase_flash_kernel(reports["flash_attention"],
                                           gpu_line),
            27: lambda: phase_flash_bwd_kernel(reports["flash_attention_bwd"],
                                               gpu_line),
            28: lambda: phase_vit512_slice(reports, gpu_line),
            29: lambda: phase_vit512_train(reports, gpu_line),
            30: lambda: phase_float16(reports, gpu_line),
            31: lambda: phase_ln_dense_kernel(reports, gpu_line),
            32: lambda: phase_ln_dense_vit(reports, gpu_line),
            33: lambda: phase_models_api(reports, gpu_line),
            34: lambda: phase_pit_mha(reports["fused_mha"], gpu_line),
            35: lambda: conv_net_serving(reports, gpu_line, "serve_resnet",
                                         [(n, {}) for n in RESNETS], seed=35),
            36: lambda: phase_resnet_train(reports, gpu_line),
            37: lambda: conv_net_serving(
                reports, gpu_line, "serve_vgg_convmixer",
                [(VGG, {}), (CONVMIXER, {})], seed=37),
            38: lambda: conv_net_serving(reports, gpu_line, "serve_pit",
                                         [(PIT, PIT_LAUNCHES)], seed=38),
            39: lambda: conv_net_serving(
                reports, gpu_line, "serve_efficientnet",
                [(n, {}) for n in EFFICIENTNETS], seed=39),
            40: lambda: conv_net_serving(
                reports, gpu_line, "serve_mixer", [(n, {}) for n in MIXERS],
                seed=40, weights=seeded_model),
            41: lambda: conv_net_serving(
                reports, gpu_line, "serve_bit", [(n, {}) for n in BITS],
                seed=41, batches=BITS, ranges=module_ranges()),
            42: lambda: (
                conv_net_serving(
                    reports, gpu_line, "serve_vit_hybrid",
                    [(n, HYBRID_LAUNCHES) for n in HYBRIDS], seed=42,
                    batches=HYBRIDS, ranges=module_ranges()),
                phase_pit_mha(reports["fused_mha"], gpu_line,
                              HYBRID_MHA_SHAPES)),
            43: lambda: phase_mha_train(reports, gpu_line),
            44: lambda: phase_sam_amg(reports, gpu_line),
            45: lambda: phase_lora_convnext(reports, gpu_line),
            46: lambda: phase_int8(reports, gpu_line),
            47: lambda: phase_ckpt_export_distill(reports, gpu_line),
        }
        for number in phases:
            run_phase[number]()
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1

    keys = ("name", "route", "source", "replaces", "work", "launches",
            "launches_by_path", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")
    kernels = []
    for report in reports.values():
        report["launches"] = sum(report["launches_by_path"].values())
        if phases != all_phases and not all(k in report for k in keys):
            continue   # a kernel the chosen phases did not measure
        entry = {k: report[k] for k in keys}
        for extra in ("cublas_floor_ms", "cublas_floor_warm_ms",
                      "plain_warm_ms", "dw_ln_ms", "cudnn_depthwise_ms",
                      "cudnn_depthwise_call_ms", "cudnn_depthwise_events_ms",
                      "windowed", "default_path_ms",
                      "sam_global", "eager_ms", "shapes", "vit_blocks",
                      "cold_ms", "library_cold_ms", "warm_ms",
                      "library_warm_ms", "host_ms", "launch_cold_ms",
                      "recompute_ms", "per_op_ms", "per_op_cold_ms",
                      "cublas_floor_cold_ms", "stages", "device_ms",
                      "library_device_ms"):
            if extra in report:
                entry[extra] = report[extra]
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
