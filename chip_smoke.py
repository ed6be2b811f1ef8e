#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port (``lfm_tpu_torch``) on one H100.

    python3 chip_smoke.py

Imports nothing of JAX or ``lfm_tpu``. Phases, each printing JSON lines:

1. build: nvcc builds ``lfm_tpu_torch/kernels/csrc/*.cu`` into one library,
   in a thread, while the main path's DiT-L/2 is made with seeded non-zero
   weights and saved as the ``model_0.pth`` that phases 5e and 9 start
   from.
2. kernels: each hand-written kernel against its plain PyTorch version on
   the same seeded inputs, with the error against the stated tolerance, the
   kernel's time, the plain version's time, the bound and the time of one
   library call computing the same function:
   - attention_small (K1), bf16 at (8, 256, 16, 64), (2, 1024, 16, 64),
     (32, 256, 16, 64) (the train step's shape), (8, 256, 16, 72) (DiT-XL's
     head) and (N, 256, 16, 64), the last also on the thirds of a fused qkv
     row (K2's layout), and f32 at the f32 DiT's heads, (8, 256, 16, 64),
     (32, 256, 16, 64) (train_f32's shape) and (8, 256, 16, 72), past T =
     256 (attention_long_f32.cuh's key-block kernel, the whole row one
     block) at (2, 1024, 16, 64) (an f32 DiT-L/2 at 512 px, the long_f32
     path's shape), (2, 512, 16, 64), (2, 300, 16, 64) and (2, 1024, 16,
     72), and at the origin ADM's heads, (N, 16, 4, 128) (celeb256_adm's
     path), (16, 64, 4, 128), (16, 16, 4, 256), and past T = 64 (the
     key-block kernel of attention_long_f32.cuh, the whole row one block)
     at (16, 256, 4, 128) and (16, 1024, 4, 128) (the adm512_attn path's
     shapes), (16, 256, 4, 256) and (16, 1024, 4, 256); library:
     scaled_dot_product_attention;
   - fused_dit_block (K2) at T=256, C=1024, hidden 4096, 16 heads, N=1
     (cli_eval's nfe and time), N=8 and N, every weight non-zero;
     library: the same block composed of cuBLAS bf16 matmuls and
     scaled_dot_product_attention;
   - attention_small_bwd (K3), bf16 at (32, 256, 16, 64) and
     (8, 1024, 16, 64), f32 at (8, 256, 16, 64), (32, 256, 16, 64),
     (8, 256, 16, 72) and (2, 1024, 16, 64) (past T = 256: the dq kernel of
     attention_long_f32.cuh), and f32 at the origin ADM's heads
     (attention_bwd_wide_f32.cu: its one-pass kernel at T <= 64, 48 at D =
     256, its dq and dk/dv kernels past it) at (112, 16, 4, 128)
     (celeb256_adm's train step, the adm_train path), (24, 64, 4, 128) and
     (24, 16, 4, 256) (celeb512_adm's at its batch), (16, 256, 4, 128) and
     (16, 1024, 4, 256), and at batch 16 on the routes' edges: T = 33, 65,
     257 and 513 at D = 128, 48, 49 and 257 at D = 256;
     library: the backward of scaled_dot_product_attention through autograd
     (its saved forward graph, backward alone);
   - flash_attention (K4), bf16 at (2, 4096, 16, 64) (DiT-L/2 at 1024 px,
     the long_t path) and (4, 2048, 16, 64), f32 at (1, 4096, 4, 128) and
     (2, 4096, 16, 64) (an f32 DiT-L/2 at 1024 px);
     library: scaled_dot_product_attention;
   - groupnorm_silu (K6), bf16 at (N, 32, 32, 256), (N, 32, 32, 768) (the
     largest in-norm input of celeb256_adm), (N, 4, 4, 1024) and
     (N, 32, 32, 256) offset by +8, f32 at (8, 32, 32, 256), each with its
     launch (gn_plan); where x fits the L2 the timed calls cycle over
     copies of it; library: silu(group_norm) on an f32 channels-last view,
     and (library_bf16_ms) on the bf16 one;
   - K5, the differentiable fused block, at the train step's batch (32) and
     at 8, T=256, C=1024, hidden 4096, 16 heads, every weight non-zero:
     block_train_fwd with full and slim streams (library: the block
     composed as for K2, its streams kept), mlp_bwd and attn_bwd on the
     kernel forward's own streams (library: autograd's backward of the same
     half composed of cuBLAS, layer_norm and SDPA, backward alone); mlp_bwd
     gives a digest of its outputs and fails unless a second call on the
     same inputs gives the same bits. Then
     one block-level check at N = 8: make_fused_block_train with the hybrid
     backward (path block_hybrid) and with pallas_bwd (path
     block_pallas_bwd), each against autograd through reference_block, all
     10 cotangents, with the launch counts of each.
   - P1, the int8 GEMM (int8_gemm_sm90.cuh, s8 wgmma + TMA) and the row
     quantization (int8_gemm.cu): quant_rows at fc2's input, (51200,
     4096) f32 (no single library call computes it: library_ms null);
     int8_dense at the int8 path's four products, M = 51200 (N = 200 x T
     = 256) with (K, N) = (1024, 3072) to bf16 (qkv), (1024, 1024) (proj),
     (1024, 4096) + GELU (fc1) and (4096, 1024) (fc2), f32 out, library:
     torch._int_mm (cuBLASLt) with eager quantization and dequantization;
     int8_mlp and bf16_mlp at P1's own call, 16384 rows, D 1024, H 4096,
     CHAIN 8 (tools/microbench_int8.py's inputs), library: the _int_mm
     chain and F.linear + gelu in bf16.
   N is the preset's sampling batch (200), the sampling path's batch.
   Then one attention_redesign line: each shape of the redesigned
   attention kernels (bf16 K1 and K4, the wgmma + TMA forward of
   attention_sm90.cuh; bf16 K3, the wgmma + TMA backward of
   attention_bwd_sm90.cuh; f32 K1 at the origin ADM's T <= 64, the one-pass
   kernel of attention_wide.cu; f32 K1 and K3 at the DiT's heads and T <=
   256, the one-pass kernels of attention_row_f32.cuh; f32 K4, K1 and K3
   past T = 256, and f32 K1 at the ADM's D = 128/256 past T = 64, the
   key-block and whole-row kernels of attention_long_f32.cuh) with its ms,
   share of its bound, ratio to SDPA and output digest, and the registers
   and spills of each of the 12 wgmma kernel instances, the 14 instances
   of attention_row_f32.cuh, the 11 of attention_long_f32.cuh, the 6 of
   attention_wide.cu's one-pass kernel and the 13 of attention_bwd_wide_f32.cu
   (f32 K3 at D 128/256) from the build's ptxas report; a spill fails the
   run. And one gemm_redesign line: each NT GEMM of K2 at
   N and of K5's forward at the train batch, and each NN and TN GEMM of
   K5's MLP and attention backward at the train batch, alone (the
   persistent wgmma + TMA GEMM of gemm_sm90.cuh, through kernels/gemm.py;
   tools/bench_block.py's gemm_rows, mlp_gemm_rows and attn_gemm_rows) with
   its ms, TFLOP/s, share of its bound, tile width (and, for the
   backward's, CTAs and splits of K) and torch.matmul's time for the same
   product, and the registers and spills of its 16 instances; a spill
   fails the run. And one int8_redesign line: P1's int8 GEMM alone at the
   int8 path's four products (M = 51200) and the probe step's two
   (tools/bench_int8.py's gemm_rows) with its ms, TOP/s, share of its
   bound, tile width and schedule, int8_dense's and torch._int_mm's times
   for the same int32 product, and the output's digest; it fails unless
   the output equals the plain version's and int8_dense's bit for bit, and
   on a spill in any of its 8 instances. And one groupnorm_redesign line:
   each K6 shape above with its ms, share of its bound, library times and
   digest; gn_eval, the 22 GroupNorm + SiLU calls of one celeb256_adm
   evaluation at batch N (tools/bench_groupnorm.py's bench_gn_eval: each
   on its own seeded input, timed as one chain) with its ms, bound,
   plain and library times; and the registers and spills of K6's 8
   instances; a spill, or a gn_eval call off its plain version by more
   than K6_TOL, fails the run.
3. grad: a 2-block DiT at DiT-L width (C = 1024, 16 heads, T = 256), batch
   8, bf16 compute on f32 masters; the flow-matching loss's parameter
   gradients with attention through K1/K3, and through
   dit_fused_apply(train_vjp=True) (K5's forward, the hybrid backward
   through K3), each against plain autograd of reference_attention, per
   tensor. Then the same model in f32 (f32 compute, as train_f32): its
   gradients through f32 K1/K3 against plain autograd in f32, per tensor.
4. main_fused: ``make_sampler`` on the celeb256_dit preset, a bf16 DiT-L/2
   at full width and depth with seeded non-zero weights, dopri5 at the
   preset's tolerances, full-size VAE decode of N samples to
   (N, 256, 256, 3); fused_dit_block must launch 24 x NFE times.
5. main_module: the same model with use_fused_dit=False, euler at 4 steps;
   attention_small must launch 24 x NFE times. The fused and module
   velocities at one (t, x) must agree.
5b. int8_main: the same model and noise with use_int8_dit=True (w8a8, the
   weights quantized once when the sampler is built), euler at 4 steps,
   VAE decode; quant_rows and int8_dense must each launch 4 x 24 x NFE
   times and nothing else (no K1, no K2). The int8 velocity at one (t, x)
   must agree with the plain int8 path on the card, and with main_module's
   bf16 velocity within the JAX package's 8%.
5c. fid: FIDInceptionV3 with seeded weights (eval/inception.py) on the
   card over main_module's and int8_main's 200 images; its activations on
   2 images against the same module on the CPU. main_module's statistics
   are written as the file that cli_eval's fid command scores against
   (that command computes the one Fréchet distance of the run); the int8
   images' activations and statistics must be finite, and their mean term
   and trace difference against the bf16 ones are printed.
5d. p1_probe: tools/microbench_int8.py's measure() (P1's probe: int8_mlp
   against bf16_mlp, each chained 8 times per call); int8_mlp and bf16_mlp
   must each launch 8 x (1 + REPS) times and nothing else.
5e. cli_eval: ``lfm_tpu_torch.cli.main.main`` in-process on the
   celeb256_dit preset from phase 1's model_0.pth (the VAE and Inception
   seeded as above): ``fid`` (euler at 4 steps, 400 samples in batches of
   200, against 5c's statistics, with --output_log), ``nfe`` (3 trials of
   dopri5 at batch 1) and ``time`` (a warm-up and 5 timed runs at batch
   1). The FID must be finite and the log line the reference's; each
   command must launch fused_dit_block exactly depth x its NFE (fid:
   steps x batches; nfe and time: the NFE each run returned) and nothing
   else.
5f. karras: ``make_sampler`` on celeb256_dit with ``use_karras_samplers``,
   the same bf16 DiT-L/2 through K2 and the same N noise: Karras heun and
   Karras euler at KARRAS_STEPS (40) sigmas, VAE decode; each run's NFE
   must equal the velocity calls counted (``build_velocity``'s function
   wrapped) and JAX's count (heun 78, euler 39), fused_dit_block must
   launch depth x NFE times and nothing else, the images finite. Then
   Karras heun at 5 steps (NFE 8) on the same weights in f32 (f32 K1, TF32
   off) at batch 2 on the card against the same call on the CPU, within
   F32_VEL_TOL.
5g. adaptive_more: ``odeint`` on the same model's velocity (K2) at batch
   ADAPTIVE_BATCH (16), each run counted alone: dopri8 with the sampling
   policy's floor (``resolve_eval_noise``: "auto" for bf16 dopri8; the
   calibrated level printed), bosh3 and adaptive_heun at the preset's
   1e-5 (no floor); NFE = velocity calls = fused_dit_block launches /
   depth, finite latents, the last step landing on t = 0 exactly. A
   dopri8 run without the floor, capped at ADAPTIVE_CAP steps, is printed
   beside them (the thrash the floor prevents), never gated on its NFE.
6. adm_main: ``make_sampler`` on the celeb256_adm preset, a bf16 origin-ADM
   UNet at full width (nf 256, ch_mult 1 2 2 2, 2 ResBlocks per level, 4
   heads, attention through K1) with seeded non-zero weights, dopri5 at
   the preset's tolerances, full-size VAE decode of N samples;
   attention_small must launch (attention layers) x NFE times and
   groupnorm_silu never, both counts from ``build_unet_plan``.
7. adm_fused_gn: the same weights with use_fused_gn, euler at 4 steps;
   groupnorm_silu must launch (ResBlocks) x 4 times, and the velocity at
   one (t, x) must agree with the unfused model's.
7b. adm512_attn: ``make_sampler`` on the celeb512_adm preset (the origin
   ADM at full width: nf 256, ch_mult 1 2 2 2 4, 2 ResBlocks per level, 4
   heads, bf16 with its f32 attention) with attention at ds 2, 4, 8 and 16
   (guided-diffusion's habit of attending at 32x32 and 16x16: an
   attn_resolutions override), seeded non-zero weights, the preset's batch
   (16), euler at 2 steps, VAE decode to (16, 512, 512, 3); f32
   attention_small must launch (attention layers) x NFE times and nothing
   else, at D = 128 past T = 64 (T = 1024 and 256) through
   attention_long_f32.cuh's key-block kernel, both counts from
   ``build_unet_plan``; the velocity at one (t, x) must agree with the
   same model's with plain attention within VEL_TOL.
7c. edm_cfg: ``make_sampler`` on the imnet_adm preset, EDM's DhariwalUNet
   at full width (nf 256, ch_mult 1 2 3 4, 2 blocks a level, attention at
   16, 8 and 4, 1000 classes; 407.4 M parameters) with seeded non-zero
   weights, bf16, batch 16 doubled to 32 by CFG 1.25 (null label -1),
   euler at 2 steps, VAE decode to (16, 256, 256, 3); it must launch no
   hand-written kernel (JAX's EDM attention and GroupNorm are plain). One
   CFG evaluation is timed alone, beside its bound (its operations counted
   on the meta device: bf16 convolutions, f32 products). The same weights in f32 on the card (TF32
   off) must give the CPU's velocity at batch 2 within F32_VEL_TOL; the
   bf16 velocity must be within VEL_TOL of the f32 one; the guided
   velocity from one doubled batch must equal uncond + s (cond - uncond)
   from two calls within CFG_TOL in f32.
8. long_t: ``make_sampler`` on celeb256_dit at image_size 1024 (DiT-L/2 at
   full width and depth, T = 4096 tokens, past the fused block's gate),
   euler at 2 steps, batch 2, VAE decode to 1024^2; flash_attention must
   launch 24 x 2 times and attention_small never.
8b. long_f32: ``make_sampler`` on celeb256_dit at image_size 512 in f32
   (an f32 DiT-L/2 at full width and depth from the same weights, T = 1024
   tokens: f32 K1 past T = 256, attention_long_f32.cuh's key-block kernel
   with its whole row one block), euler at 2 steps, batch 2, VAE decode to
   512^2; attention_small must launch 24 x 2 times, all f32, and nothing
   else; the velocity at one (t, x) must agree with the same f32 model's
   with plain attention within F32_VEL_TOL.
9. train: ``train(...)`` on the celeb256_dit preset (DiT-L/2 at full width
   and depth, batch 32, bf16 on f32 masters, grad checkpointing, EMA), from
   seeded non-zero weights given as a ``model_0.pth``, with a full-width
   seeded VAE encoder over synthetic 256^2 images in [-1, 1], below one
   epoch so no demo plot runs. A run of 1 step (which also warms the card
   up) checks the EMA against decay * p0 + (1 - decay) * p1 and that the
   parameters moved; a run of TRAIN_STEPS steps counts K3 launches (24 per
   step) and K1 launches (2 x 24 per step, the forward and its
   recompute). The loop logs, and so waits for the loss, after step 1;
   the time from that log call to the end of the run, after a sync, over
   TRAIN_STEPS - 1 is the seconds per step.
9b. train_remat: the train phase's step (``make_train_step`` on the
   module path, bf16 on f32 masters, K1 / K3, the same model_0.pth, VAE
   encoder, batches and draws) under no remat, the full recompute (None),
   ``dots``, ``all_dots`` and ``dots_attn``, 1 + TRAIN_STEPS steps each,
   the launch counts and the peak memory reset before each: exactly 24 K3
   a step under each, 24 K1 a step without remat and under ``dots_attn``
   and 48 under the others, and nothing else; step 1's loss equal to no
   remat's, its gradients within GRAD_TOL of no remat's. Seconds a step
   (steps 2 to 1 + TRAIN_STEPS, after a sync) and peak GiB per policy, and,
   since the step's peak is the optimizer's update under most policies, one
   more forward and backward alone on step 1's batch: the GiB the forward
   leaves allocated for backward and the peak over both.
10. train_fused: the same train step (the same model_0.pth, VAE encoder,
   batches, draws, AdamW + EMA) through make_train_step(model_apply=
   dit_fused_model_apply(model)), whose blocks are K5's forward and the
   hybrid backward through K3, for 1 + TRAIN_STEPS steps: step 1's loss
   against the train phase's step 1 (the same batch and draws) within 2%,
   the EMA after step 1, and launch counts of exactly 24 block_train_fwd
   and 24 attention_small_bwd per step and nothing else; the time of steps
   2 to 1 + TRAIN_STEPS, after a sync, is the seconds per step.
10b. train_f32: ``train(...)`` on the same preset, model_0.pth, VAE encoder
   and images with precision="f32" (f32 compute on f32 masters, grad
   checkpointing and EMA as the preset sets them), 1 + TRAIN_F32_STEPS
   steps (tools/bench_train.py's timed_train: the time from the log after
   step 1 to the end, after a sync, over TRAIN_F32_STEPS is the seconds
   per step): exactly 2 x 24 f32 attention_small (forward and recompute)
   and 24 f32 attention_small_bwd per step and no other kernel, f32
   parameters that stay finite, and step 1's loss within F32_LOSS_TOL of
   the same f32 model's with plain attention (use_flash_attention=False)
   on the same batch and draws, while the same plain step with attention's
   products in TF32 lands outside it.
10c. adm_train: a raw-RGB NVAE LMDB (``train.lmdb``) of 224 seeded 256^2
   records written with the port's ``minilmdb.write_db``, and ``cli.main
   train --preset celeb256_adm --datadir <it>`` in-process for 3 steps: the
   origin ADM at full width (153.1 M parameters), bf16 on f32 masters, the
   preset's batch of 112 read through ``LMDBDataset`` and encoded by the
   seeded VAE, initialised as the JAX package initialises it. Each step is
   timed alone and its launch counts reset just before it and read just
   after: exactly one f32 attention_small and one f32 attention_small_bwd
   (attention_bwd_wide_f32.cu) per attention layer (6, from
   ``build_unet_plan``) and nothing else; the losses and parameters must
   be finite. Two batches make an epoch, so step 3 follows epoch 0's demo
   plot (dopri5 through K1) and checkpoint. Then one f32 step of the same
   model (seeded non-zero weights) on the LMDB's first batch through K1 /
   K3 and through their plain versions, TF32 off: every gradient within
   F32_GRAD_TOL. Then ``train(...)`` for 2 steps of celeb512_adm at full
   width (362.7 M, bf16, batch 24, seeded 512^2 images: K3 at (24, 64, 4,
   128) and (24, 16, 4, 256)) and of imnet_adm (EDM's DhariwalUNet, 407.4 M,
   bf16, 1000 classes, batch 16: no kernel, as in JAX), each step timed and
   counted as above.
10d. the downstream tasks on celeb256_adm at full width (the origin ADM,
   bf16 with its f32 attention, 6 attention layers). ``inpaint_train``:
   ``train_inpainting`` (9 input channels) for 1 + 4 steps at the preset's
   batch of 112 over ``InpaintingTrainDataset``'s items of seeded uint8
   images (no files, no Pillow) with LaMa's mixed masks; ``semantic_train``:
   ``train_semantic`` (8 channels, the SpatialRescaler trained with it) the
   same on seeded images and label maps of 19 classes (CelebAMask-HQ's).
   Each step is timed and counted alone: exactly one f32 attention_small
   and one f32 attention_small_bwd per attention layer and nothing else;
   finite losses, parameters and EMA; the EMA after step 1 equal to decay
   p0 + (1 - decay) p1 and moved; for semantic synthesis, every tensor of
   the rescaler moved by step 1. Then one step's loss gradients in f32
   (``cond_fm_loss`` on the first batch, fixed draws) through K1 / K3
   against the same with use_flash=False, TF32 off and cuDNN deterministic:
   every gradient, the rescaler's too, within F32_GRAD_TOL (1e-5).
   ``inpaint_sample``: ``make_inpainting_sampler`` at batch 25 with the
   preset's dopri5 at 1e-5 on seeded images and LaMa masks: outside the
   hole the composite equals the input image bit for bit; exactly
   (attention layers) x NFE f32 attention_small and nothing else; the
   conditional velocity through K1 within VEL_TOL of plain attention's; then
   the seeded Inception's activations of the composites and the inputs and
   FID / P-IDS / U-IDS (``metrics_from_activations``), with the host seconds
   of the port's SVM fit. ``semantic_sample``: ``make_semantic_sampler`` at
   batch 16, euler at the preset's 40 steps: (attention layers) x NFE f32
   attention_small and nothing else, finite images in [0, 1].
10e. the other networks, none of which launches a hand-written kernel (as
   in the JAX package: their attentions are einsums and their GroupNorm
   flax's), each path asserting zero launches. ``song``: EDM's SongUNet,
   ``ncsn++`` and ``ddpm++`` at ModelConfig()'s full width (161,240,324
   and 157,428,484 parameters, exactly), each trained 2 steps at batch 32
   through ``cli.main train --model_type ... --dataset synthetic``
   in-process, then sampled by ``make_sampler`` at euler 2 steps, batch
   16, with the VAE decode; f32 on the card against the CPU at batch 2,
   bf16 against f32. ``adm_context``: imnet_adm's widths with
   ``model_type="adm_context"`` (538,786,564 parameters), CFG 1.25 euler 2
   steps at batch 16 (null label -1), one ``train(...)`` step at batch 16;
   f32 card against CPU. ``layout``: celeb256_adm with ``layout=True`` at
   full width (181,457,156 parameters), its context the
   ``TransformerTextEncoder`` (dim 512, depth 8) over
   ``ObjectsBoundingBoxConditionalBuilder`` tokens of seeded synthetic
   annotations: a bf16 forward at batch 16, one gradient step of the UNet
   and the encoder together (the flow-matching loss, the port's fused
   AdamW); f32 card against CPU at batch 2. ``variants``:
   ``EncoderUNetModel`` with each pool, ``SuperResModel``,
   ``UNetUpsamplerModel`` and ResNet-18 (eval and train mode), each
   forward on the card against the CPU in f32. Each line has its seconds
   and peak memory beside the card's name and power limit.
10f. the ranks: one process per GPU under torch.distributed, started from
   this script with the kernels built here (each rank only loads them).
   ``dist_world``: NCCL over ``torch.cuda.device_count()`` ranks (one on
   one card): sharded FID on celeb256_dit at full width (DiT-L/2, fused,
   K2), euler 4 steps over 64 samples, seeded FIDInceptionV3, against
   ``generate_fid_activations`` in this process; one train step through
   ``train(...)`` from model_0.pth (K1 / K3) against the train phase's
   step 1. ``dist_shared``: two ranks on cuda:0 over gloo, chosen by
   name: (a) the same sharded FID, each index against this process, and
   JAX's batch arithmetic; (b) three data-parallel f32 steps of
   ``train(...)`` at global batch 32 (16 a rank; an f32 VAE, whose
   encoder's roundings do not depend on the batch as bf16's do) against
   this process's three f32 steps from the same weights and draws; (c) one
   ``fsdp=2`` and one ``tp=2`` f32 step through core/partition.py at batch
   16 against the replicated step, tp=2 launching K1 and K3 at 8 heads;
   (d) ``train(...)`` of a DiT-S/2 on latents at batch 32 (a small
   content.pth), in which SIGTERM reaches rank 1 alone after its step 1:
   both ranks save at the check of step 3 and exactly one content.pth is
   written.
   Every rank's counts are reset before each of its runs and read after:
   exactly the K2 count an evaluation and the K1 / K3 counts a step of
   main_fused, train and train_f32. A rank that fails fails the script.
11. a ``kernels`` line with every ported kernel (f32 K1 at celeb256_adm's
   (200, 16, 4, 128) as its own entry, attention_small_f32, with
   adm_main's launches; f32 K1 and K3 at the f32 DiT's (32, 256, 16, 64)
   as attention_small_f32_dit and attention_small_bwd_f32, with
   train_f32's; f32 K1 at (2, 1024, 16, 64) as attention_small_f32_long,
   with long_f32's; f32 K1 at (16, 1024, 4, 128) as
   attention_small_f32_wide, with adm512_attn's; f32 K3 at celeb256_adm's
   (112, 16, 4, 128) as attention_small_bwd_f32_wide, with adm_train's),
   each with its source
   files, then the card's name and power limit, then the last line
   ``{"ok": true, "device": {...}}``.

Every path resets all launch counts just before it runs and reads them
just after.

Any failed check raises, so the exit code is not 0. Without CUDA, or
without the package beside it, the script exits non-zero before printing
any result.
"""

from __future__ import annotations

import copy
import dataclasses
import hashlib
import itertools
import json
import math
import os
import random
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, dense bf16 tensor-core
# flop/s, f32 flop/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12
SEED = 0  # weights and kernel inputs
# K1: max abs error / max |plain| on bf16 outputs, a few bf16 ulps (2^-8
# relative): p rounded before or after normalisation, f32 sums in another order
K1_TOL = 2e-2
# K2: max |out - plain| / max |plain - x|, the error against the block's own
# update rather than the residual stream x, which would hide a wrong update;
# the floor is one bf16 ulp of the largest output (2^-5 at |out| in [4, 8))
# against an update of about 3, from roundings that fall the other way
K2_TOL = 2e-2
# K3: max abs error / max |plain| for each of dq, dk, dv in bf16: p and ds
# round to bf16 on both sides, and a rounding that falls the other way moves
# a term by 2^-8
K3_TOL = 2e-2
# K4: max abs error / max |plain| in bf16, as K1 (its plain version takes
# the same key blocks)
K4_TOL = 2e-2
# K6: max abs error / max |plain| in bf16: one rounding of the output on
# both sides, which may fall the other way after f32 sums in another order
K6_TOL = 2e-2
# f32 kernels (K1, K3, K4, K6): f32 sums in another order
F32_TOL = 1e-4
# fused vs module velocity (DiT), fused vs plain GroupNorm + SiLU (ADM):
# max abs / max |reference| (as tests/test_dit_fused.py)
VEL_TOL = 5e-2
# DiT parameter gradients through K1/K3, and through dit_fused_apply(
# train_vjp=True), vs plain autograd: max abs error / max |plain| per
# tensor, the bf16 tolerance of the CPU parity tests (for the fused path
# tighter than the JAX package's own 8e-2, tests/test_dit_fused.py:190: the
# card reads 0.6-0.7% for both)
GRAD_TOL = 5e-2
# long_f32's f32 velocity through f32 K1 against the same f32 DiT-L/2 with
# plain attention: max abs / max |plain|, f32 sums in another order carried
# through 24 blocks (as F32_TOL for one kernel)
F32_VEL_TOL = 1e-4
# the same in f32 through f32 K1/K3: f32 sums in another order, carried
# through two blocks of the backward (tests/test_torch_cuda.py's f32 case;
# the card reads 3.8e-7)
F32_GRAD_TOL = 1e-5
# train_f32's step-1 loss against the same f32 model's with plain attention
# on the same batch and draws, relative: set between the readings of the
# card (NVIDIA H100 80GB HBM3), 0.0 with the f32 kernels and 8.0e-7 (8 f32
# ulps of a loss of 2.39) with the plain attention's products in TF32; the
# phase also checks that the TF32 reading stays above it
F32_LOSS_TOL = 4e-7
# K5 against its plain versions: max abs error / max |plain| per output,
# bf16 streams and f32 sums of bf16 products at the same rounding points (a
# rounding that falls the other way moves a term by 2^-8); out and x1 (and
# dx1, dx) against the block's update |plain - x| (|plain - dy|, |plain -
# dx1|), as K2, so that the residual cannot hide a wrong update, with one
# bf16 ulp of the largest output allowed on top (the output's own rounding)
K5_TOL = 2e-2
BF16_ULP = 2.0 ** -7  # the largest spacing of bf16 values, relative
# make_fused_block_train's 10 cotangents vs autograd through reference_block,
# which keeps in f32 what the kernels round to bf16 (dh2, dpr, do, dqkv):
# the bf16 tolerance of the CPU gradient tests
BLOCK_GRAD_TOL = 5e-2
# the fused train step's loss vs the module step's: the JAX package's own
# tolerance for its fused path against its module path
# (tests/test_dit_fused.py:180)
FUSED_LOSS_TOL = 2e-2
# P1: quant_rows bit-exact (the same IEEE divisions and ties to even);
# int8_dense, one product, max abs error / max |plain| within 1e-5 (exact
# int32 sums, the same f32 dequant; GELU's tanh may differ in the last bit);
# bf16 out within one rounding of it. int8_mlp, one step of P1's call,
# within 2e-2: a GELU output that differs in its last bit can land on the
# other side of a rounding boundary of the hidden's quantization, and one
# int8 step of one hidden value moves an output by up to ~1e-2 of the
# largest. After P1's chain of 8, within 0.15: the chain amplifies such
# flips; giving the plain chain's GELU last-bit changes alone (f64 GELU
# rounded to f32) moves its output by 8.4% of its largest at P1's scales,
# 3.3% at scales that hold the chain's size (512 rows on the CPU).
# bf16_mlp, one step and the chain of 8, within 2e-2: f32 sums in another
# order round to bf16 the other way (0.8% after the chain, the same test)
INT8_TOL = 1e-5
P1_STEP_TOL = 2e-2
P1_CHAIN_TOL = 0.15
BF16_MLP_TOL = 2e-2
# the int8 velocity against the plain int8 path on the card: the GELU's
# last-bit differences flip a few quantizations a block, 24 blocks deep
INT8_VEL_TOL = 1e-2
# the int8 velocity against the bf16 module's: the JAX package's own
# bound for its int8 path (tests/test_dit_int8.py:62)
INT8_VS_BF16_TOL = 8e-2
# Inception pool3 on the card against the same module on the CPU, f32 with
# TF32 off: max abs / max |CPU|, f32 convolutions in other algorithms over
# 95 layers
FID_ACT_TOL = 1e-3
INT8_OPS = 1979e12  # dense int8 tensor-core op/s, H100 SXM data sheet
P1_ROWS = 51200  # the int8 path's rows at the sampling batch: 200 x 256 tokens
TRAIN_STEPS = 6  # the first step is not timed
TRAIN_F32_STEPS = 6  # timed steps of train_f32, after its first
ADM_FUSED_STEPS = 4  # euler steps of the adm_fused_gn path
LONG_T_SIZE = 1024  # image size of the long_t path: T = (1024 / 8 / 2)^2 = 4096
LONG_F32_SIZE = 512  # image size of the long_f32 path: T = (512 / 8 / 2)^2 = 1024
# adm512_attn's attention: at ds 2, 4, 8, 16 of celeb512_adm's 64^2 latent, T
# = 1024, 256 (D 128), 64 (D 128), 16 (D 256)
ADM512_ATTN = (2, 4, 8, 16)
# cli_eval: the fid command's samples and euler steps, nfe's trials and
# time's timed repetitions
CLI_FID_SAMPLES, CLI_FID_STEPS, CLI_NFE_TRIALS, CLI_TIME_REPS = 400, 4, 3, 5
# edm_cfg: imnet_adm's sampling batch (doubled by CFG) and euler steps
EDM_BATCH, EDM_STEPS = 16, 2
# adm_train: the NVAE LMDB's seeded 256^2 records and the steps of
# celeb256_adm's CLI run (at the preset's batch of 112: two batches an
# epoch, so step 3 follows the end of epoch 0, its demo plot and
# checkpoint); celeb512_adm's and imnet_adm's batches and steps
ADM_TRAIN_RECORDS, ADM_TRAIN_STEPS = 224, 3
ADM512_TRAIN_BATCH, ADM512_TRAIN_STEPS = 24, 2
EDM_TRAIN_BATCH, EDM_TRAIN_STEPS = 16, 2
# the downstream paths: the train steps (1 + 4, one epoch at the preset's
# batch), CelebAMask-HQ's 19 classes, and the samplers' batches
DS_TRAIN_STEPS, SEG_CLASSES, INPAINT_BATCH, SEMANTIC_BATCH = 5, 19, 25, 16
# the other networks (10e): SongUNet's CLI train steps and batch, the
# samplers' batch and euler steps, the context UNet's train batch, the
# layout path's batch and its annotations' token builder, the CPU checks'
# batch; the full-width parameter counts the JAX package's eval_shape gives
SONG_TRAIN_STEPS, SONG_TRAIN_BATCH, NETS_BATCH, NETS_STEPS = 2, 32, 16, 2
CONTEXT_TRAIN_BATCH, LAYOUT_BATCH, LAYOUT_OBJECTS, CPU_BATCH = 16, 16, 5, 2
FULL_WIDTH_PARAMS = {"ncsn++": 161_240_324, "ddpm++": 157_428_484,
                     "adm_context": 538_786_564, "layout": 181_457_156}
# the downstream f32 gradient gates: a tensor's largest gradient floored at
# this share of the step's largest (tests/test_torch_adm_train.py's floor)
GRAD_FLOOR = 1e-3
# f32 K3 at the origin ADM's heads (attention_bwd_wide_f32.cu): celeb256_adm's
# train step at its batch, celeb512_adm's two at its batch of 24 (the
# one-pass kernel), past T = 64 at D = 128 and at the gate at D = 256 (the
# dq and dk/dv kernels); then the routes' edges: the one-pass kernel's 33
# keys at D = 128 and last T at D = 256 (48), the first T of the two
# kernels at each head dim (65, 49) and of their dq kernel's second and
# third instances (257, and 513 at D = 128)
K3_WIDE = [(112, 16, 4, 128), (24, 64, 4, 128), (24, 16, 4, 256), (16, 256, 4, 128),
           (16, 1024, 4, 256), (16, 33, 4, 128), (16, 65, 4, 128), (16, 257, 4, 128),
           (16, 513, 4, 128), (16, 48, 4, 256), (16, 49, 4, 256), (16, 257, 4, 256)]
# the guided velocity from one doubled batch against uncond + s (cond -
# uncond) from two calls, f32: the same arithmetic at other batch sizes,
# where cuDNN may take other algorithms
CFG_TOL = 1e-5
# karras: the Karras loops' steps at the sampling batch (heun NFE 78, euler
# 39), and the f32 card-against-CPU check's batch and steps (heun NFE 8)
KARRAS_STEPS, KARRAS_F32_BATCH, KARRAS_F32_STEPS = 40, 2, 5
# adaptive_more: its batch, and the step cap of the unfloored dopri8 run
ADAPTIVE_BATCH, ADAPTIVE_CAP = 16, 20
# train_remat: the policies, no remat first (the gradients' reference)
REMAT_RUNS = (("no_remat", False, None), ("full", True, None), ("dots", True, "dots"),
              ("all_dots", True, "all_dots"), ("dots_attn", True, "dots_attn"))


def karras_nfe(method: str, steps: int) -> int:
    """JAX's count (lfm_tpu/sample/sample.py::sample_latents): steps - 1
    pairs, heun correcting the first 39 of them."""
    pairs = max(steps - 1, 0)
    return 2 * min(pairs, 39) + (pairs - min(pairs, 39)) if method == "heun" else pairs


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bound_ms(nbytes: float, flops: float, peak: float = BF16_FLOPS):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def time_ms(torch, fn, reps: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def digest(torch, *tensors) -> str:
    """A digest of the tensors' bytes: equal outputs, equal digests."""
    h = hashlib.sha1()
    for t in tensors:
        h.update(t.contiguous().view(-1).view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def rel_err(a, b):
    err = float((a.float() - b.float()).abs().max())
    return err, err / float(b.float().abs().max())


def library_attn_half(F, x, mod, wqkv, bqkv, wproj, bproj, *, num_heads):
    """The block's attention half from library calls (cuBLAS bf16 matmuls,
    layer_norm, scaled_dot_product_attention): (x1, pr, qkv, ao). A
    yardstick of speed only, as are the two below."""
    n, t, c = x.shape
    m = mod.reshape(n, 6, 1, c)
    h = F.layer_norm(x, (c,), eps=1e-6) * (1 + m[:, 1]) + m[:, 0]
    qkv = F.linear(h, wqkv, bqkv)
    q, k, v = qkv.view(n, t, 3, num_heads, c // num_heads).permute(2, 0, 3, 1, 4)
    ao = F.scaled_dot_product_attention(q, k, v).transpose(1, 2).reshape(n, t, c)
    pr = F.linear(ao, wproj, bproj)
    return x + m[:, 2] * pr, pr, qkv, ao


def library_mlp_half(F, x1, mod, w1, b1, w2, b2):
    """The block's MLP half from library calls: (out, h2, u)."""
    n, t, c = x1.shape
    m = mod.reshape(n, 6, 1, c)
    h = F.layer_norm(x1, (c,), eps=1e-6) * (1 + m[:, 4]) + m[:, 3]
    u = F.linear(h, w1, b1)
    h2 = F.linear(F.gelu(u, approximate="tanh"), w2, b2)
    return x1 + m[:, 5] * h2, h2, u


def library_block_streams(F, x, mod, wqkv, bqkv, wproj, bproj, w1, b1, w2, b2, *, num_heads):
    """K2's block from library calls, with the streams K5's forward writes:
    (out, x1, h2, pr, qkv, ao, u)."""
    x1, pr, qkv, ao = library_attn_half(F, x, mod, wqkv, bqkv, wproj, bproj,
                                        num_heads=num_heads)
    out, h2, u = library_mlp_half(F, x1, mod, w1, b1, w2, b2)
    return out, x1, h2, pr, qkv, ao, u


def library_block(F, **kwargs):
    return library_block_streams(F, **kwargs)[0]


def library_int8_dense(torch, F, x, q_w, s_w, bias, gelu, out_dtype):
    """int8_dense from library calls: eager row quantization, torch._int_mm
    (cuBLASLt), eager dequant. A yardstick of speed only."""
    xf = x.float()
    s = xf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8) / 127.0
    q = torch.round(xf / s).clamp_(-127, 127).to(torch.int8)
    y = torch._int_mm(q, q_w.t()).float() * s * s_w
    if bias is not None:
        y = y + bias.float()
    return (F.gelu(y, approximate="tanh") if gelu else y).to(out_dtype)


def library_int8_mlp(torch, F, x, q1, s1, b1, q2, s2, b2):
    h = library_int8_dense(torch, F, x, q1, s1, b1, True, torch.float32)
    return library_int8_dense(torch, F, h, q2, s2, b2, False, torch.float32)


def library_bf16_mlp(F, x, w1, w2):
    return F.linear(F.gelu(F.linear(x, w1), approximate="tanh"), w2)


def backward_only(torch, fn, inputs, cotangent):
    """A closure running autograd's backward of ``fn(*inputs)`` alone (its
    forward graph built once and kept)."""
    leaves = [a.detach().requires_grad_(True) for a in inputs]
    out = fn(*leaves)
    return lambda: torch.autograd.grad(out, leaves, cotangent, retain_graph=True)


def output_errors(names, got, want, updates=None):
    """{name: (max abs error, relative error, reference, ulp)}: the reference
    is max |plain - base| where ``updates`` names a base tensor, and then ulp
    is one bf16 ulp of max |plain|; else max |plain|, ulp 0."""
    errs = {}
    for name, g, w in zip(names, got, want):
        err = float((g.float() - w.float()).abs().max())
        base = (updates or {}).get(name)
        ref = float(((w.float() - base.float()) if base is not None else w.float()).abs().max())
        ulp = BF16_ULP * float(w.float().abs().max()) if base is not None else 0.0
        errs[name] = (err, err / ref, ref, ulp)
    return errs


def check_errors(what, errs, tol):
    for name, (err, rel, ref, ulp) in errs.items():
        if not err <= tol * ref + ulp:
            raise AssertionError(f"{what} {name}: max abs err {err} is {rel} of its reference "
                                 f"{ref} > {tol} (+ one bf16 ulp, {ulp})")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        return run(torch, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def run(torch, work: str) -> int:
    """The phases of the module docstring; ``work`` holds the train phase's
    files."""
    import torch.nn.functional as F

    from lfm_tpu_torch.core.checkpoint import reference_state_dict
    from lfm_tpu_torch.core.config import get_preset
    from lfm_tpu_torch.core.device import no_tf32
    from lfm_tpu_torch.core.rng import SampleRNG
    from lfm_tpu_torch.data import DataLoader, SyntheticImageDataset
    from lfm_tpu_torch.kernels import _build
    from lfm_tpu_torch.kernels.dit_block import FUSED_DIT_BLOCK, fused_dit_block, reference_block
    from lfm_tpu_torch.kernels.dit_block_train import (ATTN_BWD, BLOCK_TRAIN_FWD, MLP_BWD,
                                                       attn_bwd, block_train_fwd,
                                                       make_fused_block_train, mlp_bwd,
                                                       reference_attn_bwd,
                                                       reference_block_fwd_streams,
                                                       reference_mlp_bwd)
    from lfm_tpu_torch.kernels.flash_attention import (ATTENTION_SMALL, ATTENTION_SMALL_BWD,
                                                       FLASH_ATTENTION, attention_small,
                                                       attention_small_bwd, flash_attention,
                                                       reference_attention,
                                                       reference_attention_bwd,
                                                       reference_flash_attention)
    from lfm_tpu_torch.kernels.groupnorm_silu import (GROUPNORM_SILU, gn_plan, groupnorm_silu,
                                                      reference_groupnorm_silu)
    from lfm_tpu_torch.kernels.int8_matmul import (BF16_MLP, INT8_DENSE, INT8_MLP, QUANT_ROWS,
                                                   bf16_mlp, int8_dense, int8_mlp, quant_rows,
                                                   reference_bf16_mlp, reference_int8_dense,
                                                   reference_int8_mlp, reference_quant_rows)
    import numpy as np
    from torch.utils.flop_counter import FlopCounterMode

    from lfm_tpu_torch.cli.main import main as cli_main
    from lfm_tpu_torch.eval.fid import ActivationExtractor, activation_statistics, save_statistics
    from lfm_tpu_torch.eval.inception import seeded_inception_state_dict
    from lfm_tpu_torch.nn.dit_int8 import dit_int8_apply, quantize_params_int8, quantize_weight
    from lfm_tpu_torch.tools import bench_groupnorm, bench_train, microbench_int8
    from lfm_tpu_torch.nn.adm_unet import plan_layers
    from lfm_tpu_torch.nn.dit import DiT
    from lfm_tpu_torch.nn.dit_fused import (cast_params_bf16, dit_fused_apply,
                                           dit_fused_model_apply)
    from lfm_tpu_torch.nn.factory import create_network
    from lfm_tpu_torch.nn.init import seeded_init_
    from lfm_tpu_torch.nn import layers as nn_layers
    from lfm_tpu_torch.ode.flow import interpolate
    from lfm_tpu_torch.sample import sharded
    from lfm_tpu_torch.ode.solvers import calibrate_eval_noise, odeint
    from lfm_tpu_torch.sample import sample as sample_mod
    from lfm_tpu_torch.sample.sample import (build_velocity, make_sampler, noise_and_labels,
                                             resolve_eval_noise, sample_latents)
    from lfm_tpu_torch.train.loop import train
    from lfm_tpu_torch.train.state import create_train_state, make_optimizer
    from lfm_tpu_torch.train.train import fm_train_loss, make_train_step
    from lfm_tpu_torch.vae.autoencoder_kl import create_vae

    dev = torch.device("cuda")
    bf, f32 = torch.bfloat16, torch.float32
    t_all = time.time()
    config = get_preset("celeb256_dit")
    counters = {"attention_small": ATTENTION_SMALL, "fused_dit_block": FUSED_DIT_BLOCK,
                "attention_small_bwd": ATTENTION_SMALL_BWD, "flash_attention": FLASH_ATTENTION,
                "groupnorm_silu": GROUPNORM_SILU, "dit_block_train_fwd": BLOCK_TRAIN_FWD,
                "dit_block_train_mlp_bwd": MLP_BWD, "dit_block_train_attn_bwd": ATTN_BWD,
                "quant_rows": QUANT_ROWS, "int8_dense": INT8_DENSE, "int8_mlp": INT8_MLP,
                "bf16_mlp": BF16_MLP}

    def reset_counts():
        for c in counters.values():
            c.reset()

    def counts():
        return {name: c.count for name, c in counters.items()}

    # 1. build, in a thread, while the DiT-L/2 of the main path is made and
    # saved as the model_0.pth that the train phase starts from
    built = {}

    def build():
        t = time.time()
        try:
            built["lib"] = _build.build()
        except BaseException as e:  # raised again below, in the main thread
            built["error"] = e
        built["seconds"] = time.time() - t

    builder = threading.Thread(target=build)
    builder.start()
    model = create_network(config.model, dtype=bf, use_flash=config.model.use_flash_attention,
                           device=dev)
    seeded_init_(model, SEED)
    ckpt_path = os.path.join(work, "model_0.pth")
    torch.save({"pos_embed": model.pos_embed.cpu(),
                **{k: v.cpu() for k, v in model.state_dict().items()}}, ckpt_path)
    probe = "blocks.0.attn.qkv.weight"
    p0 = dict(model.named_parameters())[probe].detach().clone()
    builder.join()
    if "error" in built:
        raise built["error"]
    _build.load_library()
    emit({"phase": "build", "seconds": built["seconds"], "until_joined": time.time() - t_all,
          "lib": os.path.relpath(built["lib"])})

    # 2. kernels against their plain versions
    t0 = time.time()
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)

    def rn(*shape, scale=1.0, dtype=bf):
        return (scale * torch.randn(*shape, generator=gen, device=dev)).to(dtype)

    batch = config.sample.batch_size
    train_batch = config.train.batch_size
    k1_rows, k2_rows, k3_rows, k4_rows, k6_rows = {}, {}, {}, {}, {}
    k1_cases = sorted({(8, 256, 16, 64, bf), (2, 1024, 16, 64, bf), (train_batch, 256, 16, 64, bf),
                       (8, 256, 16, 72, bf), (batch, 256, 16, 64, bf)}, key=lambda c: c[:4])
    # f32: the DiT's heads (train_f32's shape among them), then the origin
    # ADM's (celeb256_adm's path first)
    f32_dit = [(8, 256, 16, 64), (train_batch, 256, 16, 64), (8, 256, 16, 72)]
    # and past T = 256, where f32 K1 takes attention_long_f32.cuh's key-block
    # kernel with its whole row one block (64 query rows up to T = 512, 32
    # past it) and f32 K3 its dq kernel: an f32 DiT-L/2 at 512 px (the
    # long_f32 path's shape), T = 512, ragged T (300) and DiT-XL/2's head
    f32_long = [(2, 1024, 16, 64)]
    f32_long_k1 = f32_long + [(2, 512, 16, 64), (2, 300, 16, 64), (2, 1024, 16, 72)]
    # then the origin ADM's heads (celeb256_adm's path first), and D =
    # 128/256 past T = 64 (the key-block kernel with its whole row one
    # block; adm512_attn's shapes first)
    f32_wide = [(16, 256, 4, 128), (16, 1024, 4, 128), (16, 256, 4, 256), (16, 1024, 4, 256)]
    k1_f32 = [c + (f32,) for c in f32_dit + f32_long_k1] + [
        (batch, 16, 4, 128, f32), (16, 64, 4, 128, f32), (16, 16, 4, 256, f32)] + [
        c + (f32,) for c in f32_wide]
    # and K2's layout: q, k, v as the thirds of one (N, T, 3C) qkv row
    k1_qkv = [(batch, 256, 16, 64, bf)]
    for n, t, h, d, dt, layout in ([c + ("separate",) for c in k1_cases + k1_f32]
                                   + [c + ("qkv",) for c in k1_qkv]):
        t_case = time.time()
        if layout == "qkv":
            qkv = rn(n, t, 3 * h * d, dtype=dt)
            q, k, v = (a.view(n, t, h, d) for a in qkv.split(h * d, dim=-1))
        else:
            q, k, v = rn(n, t, h, d, dtype=dt), rn(n, t, h, d, dtype=dt), rn(n, t, h, d, dtype=dt)
        out = attention_small(q, k, v)
        ref = reference_attention(q, k, v)
        torch.cuda.synchronize()
        err, rel = rel_err(out, ref)
        tol = K1_TOL if dt == bf else F32_TOL
        if not rel <= tol:
            raise AssertionError(f"attention_small {(n, t, h, d, dt)}: max abs err {err} is {rel} "
                                 f"of max |plain| > {tol}")
        qh, kh, vh = (a.transpose(1, 2).contiguous() for a in (q, k, v))
        esize = q.element_size()
        bms, by = bound_ms(4 * n * t * h * d * esize, 4 * n * h * t * t * d,
                           BF16_FLOPS if dt == bf else F32_FLOPS)
        row = {"shape": [n, t, h, d], "dtype": str(dt), "layout": layout, "max_abs_err": err,
               "rel_err": rel, "tol": tol, "digest": digest(torch, out),
               "ms": time_ms(torch, lambda: attention_small(q, k, v)),
               "plain_ms": time_ms(torch, lambda: reference_attention(q, k, v)),
               "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(qh, kh, vh)),
               "bound_ms": bms, "bound_by": by, "seconds": time.time() - t_case}
        k1_rows[(n, t, h, d, dt) + ((layout,) if layout != "separate" else ())] = row
        emit({"phase": "kernel", "name": "attention_small", **row})
        del q, k, v, qh, kh, vh, out, ref

    t, c, heads = 256, 1024, 16
    hid = 4 * c

    def block_inputs(n):
        """A DiT-L/2 block's inputs for a batch of n, every weight non-zero."""
        return dict(x=rn(n, t, c), mod=rn(n, 6 * c, scale=0.3),
                    wqkv=rn(3 * c, c, scale=c ** -0.5), bqkv=rn(3 * c, scale=0.02),
                    wproj=rn(c, c, scale=c ** -0.5), bproj=rn(c, scale=0.02),
                    w1=rn(hid, c, scale=c ** -0.5), b1=rn(hid, scale=0.02),
                    w2=rn(c, hid, scale=hid ** -0.5), b2=rn(c, scale=0.02))

    # N = 1 is cli_eval's nfe and time (batch 1), whose fc1 takes other
    # tiles (gemm_tile at M = 256 rows) than N = 8 and the sampling batch
    for n in sorted({1, 8, batch}):
        t_case = time.time()
        blk = block_inputs(n)
        out = fused_dit_block(**blk, num_heads=heads)
        ref = reference_block(**blk, num_heads=heads)
        torch.cuda.synchronize()
        err = float((out.float() - ref.float()).abs().max())
        update = float((ref.float() - blk["x"].float()).abs().max())
        rel = err / update
        if not rel <= K2_TOL:
            raise AssertionError(f"fused_dit_block N={n}: max abs err {err} is {rel} of "
                                 f"max |plain - x| > {K2_TOL}")
        nbytes = 2 * (2 * n * t * c + 6 * n * c + 4 * c * c + 2 * c * hid + 5 * c + hid)
        bms, by = bound_ms(nbytes, 2 * n * t * c * (4 * c + 2 * hid) + 4 * n * t * t * c)
        row = {"shape": [n, t, c, hid, heads], "max_abs_err": err, "max_update": update,
               "rel_err": rel, "tol": K2_TOL,
               "ms": time_ms(torch, lambda: fused_dit_block(**blk, num_heads=heads)),
               "plain_ms": time_ms(torch, lambda: reference_block(**blk, num_heads=heads)),
               "library_ms": time_ms(torch, lambda: library_block(F, **blk, num_heads=heads)),
               "bound_ms": bms, "bound_by": by, "seconds": time.time() - t_case}
        k2_rows[n] = row
        emit({"phase": "kernel", "name": "fused_dit_block", **row})
        del blk, out, ref

    for n, t, h, d, dt in ([(train_batch, 256, 16, 64, bf), (8, 1024, 16, 64, bf)]
                           + [c + (f32,) for c in f32_dit + f32_long + K3_WIDE]):
        t_case = time.time()
        q, k, v, do = (rn(n, t, h, d, dtype=dt) for _ in range(4))
        got = attention_small_bwd(q, k, v, do)
        want = reference_attention_bwd(q, k, v, do)
        torch.cuda.synchronize()
        tol = K3_TOL if dt == bf else F32_TOL
        errs = {}
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            errs[name] = rel_err(g, w)
            if not errs[name][1] <= tol:
                raise AssertionError(f"attention_small_bwd {(n, t, h, d, dt)} {name}: max abs err "
                                     f"{errs[name][0]} is {errs[name][1]} of max |plain| > {tol}")
        qh, kh, vh = (a.transpose(1, 2).contiguous().requires_grad_(True) for a in (q, k, v))
        doh = do.transpose(1, 2).contiguous()
        oh = F.scaled_dot_product_attention(qh, kh, vh)

        def sdpa_bwd():
            torch.autograd.grad(oh, (qh, kh, vh), doh, retain_graph=True)

        bms, by = bound_ms(7 * n * t * h * d * q.element_size(), 10 * n * h * t * t * d,
                           BF16_FLOPS if dt == bf else F32_FLOPS)
        row = {"shape": [n, t, h, d], "dtype": str(dt),
               "max_abs_err": max(e[0] for e in errs.values()),
               "rel_err": {name: e[1] for name, e in errs.items()}, "tol": tol,
               "digest": digest(torch, *got),
               "ms": time_ms(torch, lambda: attention_small_bwd(q, k, v, do)),
               "plain_ms": time_ms(torch, lambda: reference_attention_bwd(q, k, v, do)),
               "library_ms": time_ms(torch, sdpa_bwd),
               "bound_ms": bms, "bound_by": by, "seconds": time.time() - t_case}
        k3_rows[(n, t, d, dt)] = row
        emit({"phase": "kernel", "name": "attention_small_bwd", **row})
        del q, k, v, do, got, want, qh, kh, vh, doh, oh

    for n, t, h, d, dt in ((2, 4096, 16, 64, bf), (4, 2048, 16, 64, bf), (1, 4096, 4, 128, f32),
                           (2, 4096, 16, 64, f32)):
        t_case = time.time()
        q, k, v = (rn(n, t, h, d, dtype=dt) for _ in range(3))
        out = flash_attention(q, k, v)
        ref = reference_flash_attention(q, k, v)
        torch.cuda.synchronize()
        err, rel = rel_err(out, ref)
        tol = K4_TOL if dt == bf else F32_TOL
        if not rel <= tol:
            raise AssertionError(f"flash_attention {(n, t, h, d, dt)}: max abs err {err} is {rel} "
                                 f"of max |plain| > {tol}")
        qh, kh, vh = (a.transpose(1, 2).contiguous() for a in (q, k, v))
        bms, by = bound_ms(4 * n * t * h * d * q.element_size(), 4 * n * h * t * t * d,
                           BF16_FLOPS if dt == bf else F32_FLOPS)
        row = {"shape": [n, t, h, d], "dtype": str(dt), "max_abs_err": err, "rel_err": rel,
               "tol": tol, "ms": time_ms(torch, lambda: flash_attention(q, k, v)),
               "plain_ms": time_ms(torch, lambda: reference_flash_attention(q, k, v)),
               "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(qh, kh, vh)),
               "bound_ms": bms, "bound_by": by, "seconds": time.time() - t_case}
        k4_rows[(n, t, h, d, dt)] = row
        emit({"phase": "kernel", "name": "flash_attention", **row})
        del q, k, v, qh, kh, vh, out, ref

    # the redesigned attention kernels: the wgmma + TMA forward (bf16 K1 and
    # K4) and backward (bf16 K3), the one-pass f32 K1 at the origin ADM's
    # short sequences, the one-pass f32 K1 and K3 at the DiT's heads, and f32
    # K4, K1 and K3 past T = 256 and f32 K1 at the origin ADM's D = 128/256
    # past T = 64 (the key-block kernel); time against bound and SDPA at
    # every shape above, and ptxas's registers and spills of each instance
    csrc = "lfm_tpu_torch/kernels/csrc/"

    def f32_dit_row(r):
        return r["dtype"] == str(f32) and r["shape"][1] <= 256 and r["shape"][3] <= 80

    def f32_long_row(r):
        return r["dtype"] == str(f32) and r["shape"][1] > (64 if r["shape"][3] >= 128 else 256)

    redesign = [{"kernel": name, "source": csrc + src, "shape": r["shape"], "dtype": r["dtype"],
                 "layout": r.get("layout", "separate"), "ms": r["ms"], "bound_ms": r["bound_ms"],
                 "bound_share": r["bound_ms"] / r["ms"], "library_ms": r["library_ms"],
                 "vs_sdpa": r["ms"] / r["library_ms"], "digest": r.get("digest")}
                for name, src, rows, pick in (
                    ("attention_small", "attention_sm90.cuh", k1_rows,
                     lambda r: r["dtype"] == str(bf)),
                    ("attention_small", "attention_wide.cu", k1_rows,
                     lambda r: r["dtype"] == str(f32) and r["shape"][1] <= 64
                     and r["shape"][3] >= 128),
                    ("attention_small", "attention_row_f32.cuh", k1_rows, f32_dit_row),
                    ("attention_small", "attention_long_f32.cuh", k1_rows, f32_long_row),
                    ("attention_small_bwd", "attention_bwd_sm90.cuh", k3_rows,
                     lambda r: r["dtype"] == str(bf)),
                    ("attention_small_bwd", "attention_row_f32.cuh", k3_rows, f32_dit_row),
                    ("attention_small_bwd", "attention_long_f32.cuh", k3_rows,
                     lambda r: f32_long_row(r) and r["shape"][3] <= 80),
                    ("attention_small_bwd", "attention_bwd_wide_f32.cu", k3_rows,
                     lambda r: r["dtype"] == str(f32) and r["shape"][3] >= 128),
                    ("flash_attention", "attention_sm90.cuh", k4_rows,
                     lambda r: r["dtype"] == str(bf)),
                    ("flash_attention", "attention_long_f32.cuh", k4_rows,
                     lambda r: r["dtype"] == str(f32)))
                for r in rows.values() if pick(r)]
    ptxas = {}
    flash = r"long32\d+(flash_f32_kernel)ILi(\d+)ELi(\d+)ELi(\d+)E"
    for stem, pattern in (("attention_sm90", r"(attn_\w+_kernel)ILi(\d+)ELb([01])E"),
                          ("attention_bwd", r"sm90\d+(attn_bwd_\w+_kernel)ILi(\d+)E"),
                          ("attention_row_f32", r"row32\d+(attn_row_kernel)ILi(\d+)ELi(\d+)E"),
                          ("attention_bwd_row_f32",
                           r"row32\d+(attn_row_bwd_\w+_kernel)ILi(\d+)E(?:Li(\d+)E)?"),
                          ("flash_attention_f32", flash), ("attention_long_f32", flash),
                          ("attention_wide", flash),
                          ("attention_wide", r"(attn_short_f32_kernel)ILi(\d+)ELi(\d+)ELi(\d+)E"),
                          ("attention_bwd_long_f32",
                           r"long32\d+(attn_long_bwd_dq_kernel)ILi(\d+)ELi(\d+)E"),
                          ("attention_bwd_wide_f32",
                           r"wide32\d+(attn_wide_bwd_\w+_kernel)ILi(\d+)E(?:Li(\d+)E)?"
                           r"(?:Li(\d+)E)?(?:Li(\d+)E)?")):
        for mangled, use in _build.ptxas_usage(stem).items():
            m = re.search(pattern, mangled)
            if m:
                args = [{"1": "true", "0": "false"}.get(a, a) if stem == "attention_sm90" else a
                        for a in m.groups()[1:] if a]
                ptxas[f"{m.group(1)}<{', '.join(args)}>"] = use
    emit({"phase": "attention_redesign", "shapes": redesign, "ptxas": ptxas})
    spilled = {k: u for k, u in ptxas.items() if u.get("spill_stores") or u.get("spill_loads")}
    # wgmma: 8 forward instances (2 modes x 2 padded head dims x NORM_P), 4
    # of K3 (2 kernels x 2 padded head dims); f32 one-pass: 6 of K1 (2
    # padded head dims x TK 64, 128, 256), 6 of K3's dq kernel, 2 of its
    # dk/dv kernel; attention_long_f32.cuh: 3 of K4 (DP 64, 80, 128; f32 K1
    # takes those up to T = 512), 4 of f32 K1's own (DP 64, 80 past T = 512,
    # DP 128 past it and DP 256 past T = 64: 32 query rows, 1024 keys), 4 of
    # K3's dq kernel past T = 256 (2 padded head dims x TK 512, 1024); 6 of
    # attention_wide.cu's one-pass f32 K1 at T <= 64 (DP 128, 256 x 3 sizes);
    # 13 of f32 K3 at D 128/256 (attention_bwd_wide_f32.cu: 6 of the
    # one-pass kernel, DP 128 x TK 16, 32, 64 and DP 256 x 16, 32, 48; 5 of
    # the dq kernel, DP x its rows and whole-row keys; 2 of the dk/dv kernel)
    if len(ptxas) != 56 or spilled:
        raise AssertionError(f"attention: {len(ptxas)} kernel instances, spills {spilled}")

    for n, hh, ww, c, dt, offset in ((batch, 32, 32, 256, bf, 0.0), (batch, 32, 32, 768, bf, 0.0),
                                     (batch, 4, 4, 1024, bf, 0.0), (batch, 32, 32, 256, bf, 8.0),
                                     (8, 32, 32, 256, f32, 0.0)):
        t_case = time.time()
        x = (rn(n, hh, ww, c, dtype=f32) + offset).to(dt)
        scale, bias = 1.0 + rn(c, scale=0.1, dtype=f32), rn(c, scale=0.1, dtype=f32)
        out = groupnorm_silu(x, scale, bias)
        ref = reference_groupnorm_silu(x, scale, bias)
        torch.cuda.synchronize()
        err, rel = rel_err(out, ref)
        tol = K6_TOL if dt == bf else F32_TOL
        if not rel <= tol:
            raise AssertionError(f"groupnorm_silu {(n, hh, ww, c, dt, offset)}: max abs err {err} "
                                 f"is {rel} of max |plain| > {tol}")
        # where x fits the L2, the timed calls cycle over copies of it, so
        # that no call finds its input there; library: silu(group_norm) on
        # the f32 channels-last view, and on x's own (bf16) view
        xs = bench_groupnorm.rotation(x)
        cyc = itertools.cycle(xs)
        lib = itertools.cycle([bench_groupnorm.library(a, scale, bias, f32) for a in xs])
        lib_own = itertools.cycle([bench_groupnorm.library(a, scale, bias, dt) for a in xs])
        bms, by = bound_ms(2 * x.numel() * x.element_size() + 2 * c * 4, 10 * x.numel(),
                           F32_FLOPS)
        row = {"shape": [n, hh, ww, c], "dtype": str(dt), "offset": offset, "max_abs_err": err,
               "rel_err": rel, "tol": tol, "digest": digest(torch, out),
               "differ_from_plain": int((out != ref).sum()), "copies": len(xs),
               "plan": gn_plan(n, hh * ww, c, 32, dt)._asdict(),
               "ms": time_ms(torch, lambda: groupnorm_silu(next(cyc), scale, bias)),
               "plain_ms": time_ms(torch, lambda: reference_groupnorm_silu(next(cyc), scale,
                                                                           bias)),
               "library_ms": time_ms(torch, lambda: next(lib)()),
               "library_bf16_ms": time_ms(torch, lambda: next(lib_own)()) if dt == bf else None,
               "bound_ms": bms, "bound_by": by, "seconds": time.time() - t_case}
        k6_rows[(n, hh, ww, c, dt, offset)] = row
        emit({"phase": "kernel", "name": "groupnorm_silu", **row})
        del x, xs, cyc, lib, lib_own, out, ref

    # the redesigned K6: each shape above against its bound and its library
    # calls; gn_eval, the 22 calls of one celeb256_adm evaluation at batch N
    # as one chain; ptxas's registers and spills of its 8 instances (bf16 and
    # f32 x 16-byte and one-element chunks x held and streamed)
    t_case = time.time()
    gn_eval = bench_groupnorm.bench_gn_eval(timing_only=False)
    gn_eval["ms_median"] = sorted(gn_eval["ms"])[len(gn_eval["ms"]) // 2]
    gn_ptxas = {}
    for mangled, use in _build.ptxas_usage("groupnorm_silu").items():
        m = re.search(r"gn_silu_kernelI(13__nv_bfloat16|f)Li(\d+)ELb([01])E", mangled)
        if m:
            gn_ptxas[f"gn_silu_kernel<{'float' if m.group(1) == 'f' else 'bf16'}, {m.group(2)}, "
                     f"{'true' if m.group(3) == '1' else 'false'}>"] = use
    emit({"phase": "groupnorm_redesign",
          "shapes": [{"shape": r["shape"], "dtype": r["dtype"], "offset": r["offset"],
                      "ms": r["ms"], "bound_ms": r["bound_ms"],
                      "bound_share": r["bound_ms"] / r["ms"], "library_ms": r["library_ms"],
                      "library_bf16_ms": r["library_bf16_ms"], "digest": r["digest"],
                      "plan": r["plan"]} for r in k6_rows.values()],
          "gn_eval": {**gn_eval, "bound_share": gn_eval["bound_ms"] / gn_eval["ms_median"]},
          "ptxas": gn_ptxas, "seconds": time.time() - t_case})
    if gn_eval["launches"] != 22 or not gn_eval["rel_err"] <= K6_TOL:
        raise AssertionError(f"gn_eval: {gn_eval['launches']} calls, max abs err "
                             f"{gn_eval['max_abs_err']} is {gn_eval['rel_err']} of max |plain| "
                             f"> {K6_TOL}")
    spilled = {k: u for k, u in gn_ptxas.items() if u.get("spill_stores") or u.get("spill_loads")}
    if len(gn_ptxas) != 8 or spilled:
        raise AssertionError(f"groupnorm_silu: {len(gn_ptxas)} kernel instances, spills {spilled}")

    # K5: the forward with its streams, then each backward half on the
    # kernel forward's own streams (t and c as K2's; the loops above rebound
    # them)
    t, c = 256, 1024
    k5_rows = {}
    weights_bytes = 2 * (4 * c * c + 2 * c * hid + 5 * c + hid)
    stream_names = {"full": ("out", "x1", "h2", "pr", "qkv", "ao", "u"),
                    "slim": ("out", "h2", "pr", "qkv")}
    stream_width = {"full": 8 * c + hid, "slim": 6 * c}
    for n in sorted({8, train_batch}):
        blk = block_inputs(n)
        x, mod = blk["x"], blk["mod"]
        for mode in ("full", "slim"):
            t_case = time.time()
            got = block_train_fwd(**blk, num_heads=heads, save_streams=mode)
            want = reference_block_fwd_streams(**blk, num_heads=heads, save_streams=mode)
            torch.cuda.synchronize()
            errs = output_errors(stream_names[mode], got, want, {"out": x, "x1": x})
            check_errors(f"block_train_fwd {mode} N={n}", errs, K5_TOL)
            bms, by = bound_ms(weights_bytes + 2 * n * t * c + 2 * 6 * n * c
                               + 2 * n * t * stream_width[mode],
                               2 * n * t * c * (4 * c + 2 * hid) + 4 * n * t * t * c)
            row = {"shape": [n, t, c, hid, heads], "streams": mode,
                   "max_abs_err": max(e[0] for e in errs.values()),
                   "rel_err": {k: e[1] for k, e in errs.items()}, "tol": K5_TOL,
                   "ms": time_ms(torch, lambda: block_train_fwd(**blk, num_heads=heads,
                                                                save_streams=mode)),
                   "plain_ms": time_ms(torch, lambda: reference_block_fwd_streams(
                       **blk, num_heads=heads, save_streams=mode)),
                   "library_ms": time_ms(torch, lambda: library_block_streams(
                       F, **blk, num_heads=heads)),
                   "bound_ms": bms, "bound_by": by, "seconds": time.time() - t_case}
            k5_rows[("fwd", mode, n)] = row
            emit({"phase": "kernel", "name": "dit_block_train_fwd", **row})
            del got, want
        out, x1, h2, pr, qkv, ao, u = block_train_fwd(**blk, num_heads=heads)
        dy = rn(n, t, c)

        t_case = time.time()
        margs = (x1, mod, h2, u, blk["w1"], blk["w2"], dy)
        got = mlp_bwd(*margs)
        first = digest(torch, *got)
        again = digest(torch, *mlp_bwd(*margs))
        want = reference_mlp_bwd(*margs)
        torch.cuda.synchronize()
        if again != first:  # fixed-order sums, no atomics: the same bits each call
            raise AssertionError(f"mlp_bwd N={n}: two calls on the same inputs differ "
                                 f"({first} != {again})")
        errs = output_errors(("dx1", "dmod", "dw1", "db1", "dw2", "db2"), got, want, {"dx1": dy})
        check_errors(f"mlp_bwd N={n}", errs, K5_TOL)
        lib = backward_only(torch, lambda *a: library_mlp_half(F, *a)[0],
                            (x1, mod, blk["w1"], blk["b1"], blk["w2"], blk["b2"]), dy)
        bms, by = bound_ms(2 * (4 * n * t * c + n * t * hid + 6 * n * c + 2 * c * hid)
                           + 4 * (3 * n * c + 2 * c * hid + hid + c), 8 * n * t * c * hid)
        row = {"shape": [n, t, c, hid, heads], "max_abs_err": max(e[0] for e in errs.values()),
               "rel_err": {k: e[1] for k, e in errs.items()}, "tol": K5_TOL, "digest": first,
               "ms": time_ms(torch, lambda: mlp_bwd(*margs)),
               "plain_ms": time_ms(torch, lambda: reference_mlp_bwd(*margs)),
               "library_ms": time_ms(torch, lib), "bound_ms": bms, "bound_by": by,
               "seconds": time.time() - t_case}
        k5_rows[("mlp", n)] = row
        emit({"phase": "kernel", "name": "dit_block_train_mlp_bwd", **row})
        dx1 = got[0]
        del got, want, lib

        t_case = time.time()
        aargs = (x, mod, pr, qkv, ao, blk["wqkv"], blk["wproj"], dx1)
        got = attn_bwd(*aargs, num_heads=heads)
        want = reference_attn_bwd(*aargs, num_heads=heads)
        torch.cuda.synchronize()
        errs = output_errors(("dx", "dmod", "dwqkv", "dbqkv", "dwproj", "dbproj"), got, want,
                             {"dx": dx1})
        check_errors(f"attn_bwd N={n}", errs, K5_TOL)
        lib = backward_only(torch, lambda *a: library_attn_half(F, *a, num_heads=heads)[0],
                            (x, mod, blk["wqkv"], blk["bqkv"], blk["wproj"], blk["bproj"]), dx1)
        bms, by = bound_ms(2 * (8 * n * t * c + 6 * n * c + 4 * c * c)
                           + 4 * (3 * n * c + 4 * c * c + 4 * c),
                           # five T x T products a head (logits, dv, dp, dq,
                           # dk); ao is a stream, so the CostEstimate's sixth
                           # (PV again) is not work the function needs
                           16 * n * t * c * c + 10 * n * t * t * c)
        row = {"shape": [n, t, c, hid, heads], "max_abs_err": max(e[0] for e in errs.values()),
               "rel_err": {k: e[1] for k, e in errs.items()}, "tol": K5_TOL,
               "ms": time_ms(torch, lambda: attn_bwd(*aargs, num_heads=heads)),
               "plain_ms": time_ms(torch, lambda: reference_attn_bwd(*aargs, num_heads=heads)),
               "library_ms": time_ms(torch, lib), "bound_ms": bms, "bound_by": by,
               "seconds": time.time() - t_case}
        k5_rows[("attn", n)] = row
        emit({"phase": "kernel", "name": "dit_block_train_attn_bwd", **row})
        del got, want, lib, blk, x, mod, out, x1, h2, pr, qkv, ao, u, dy, dx1

    # the redesigned GEMM (gemm_sm90.cuh): each NT GEMM of K2 at the sampling
    # batch and of K5's forward at the train batch, and each NN / TN GEMM of
    # K5's MLP and attention backward at the train batch, alone, against its
    # bound and torch.matmul of the same product; ptxas's registers and
    # spills of its 8 NT and 8 NN / TN instances
    from lfm_tpu_torch.tools.bench_block import attn_gemm_rows, gemm_rows, mlp_gemm_rows

    gemms = {"fused_dit_block": gemm_rows(batch, False, reps=10),
             "dit_block_train_fwd": gemm_rows(train_batch, True, reps=10),
             "dit_block_train_mlp_bwd": mlp_gemm_rows(train_batch, reps=10),
             "dit_block_train_attn_bwd": attn_gemm_rows(train_batch, reps=10)}
    gemm_ptxas = {re.sub(r"^_ZN3lfm4sm9016gemm_sm90_kernelI(.*)EEv.*$", r"gemm_sm90_kernel<\1>",
                         k): u
                  for stem in ("gemm_sm90", "gemm_sm90_bwd")
                  for k, u in _build.ptxas_usage(stem).items() if "gemm_sm90_kernel" in k}
    emit({"phase": "gemm_redesign", "source": csrc + "gemm_sm90.cuh", "gemms": gemms,
          "ptxas": gemm_ptxas})
    spilled = {k: u for k, u in gemm_ptxas.items()
               if u.get("spill_stores") or u.get("spill_loads")}
    # NT: 4 epilogue kinds x 2 tile widths; NN dgelu, NN store into f32 and
    # bf16, TN store x 2
    if len(gemm_ptxas) != 16 or spilled:
        raise AssertionError(f"wgmma GEMM: {len(gemm_ptxas)} kernel instances, spills {spilled}")

    # make_fused_block_train against autograd through reference_block, each
    # backward mode a path of its own
    t_case = time.time()
    blk = block_inputs(8)
    dy = rn(8, t, c)
    leaves = [a.detach().requires_grad_(True) for a in blk.values()]
    want = torch.autograd.grad(reference_block(*leaves, num_heads=heads), leaves, dy)
    block_counts, block_errs = {}, {}
    expected = {"block_hybrid": {"dit_block_train_fwd": 1, "attention_small_bwd": 1},
                "block_pallas_bwd": {"dit_block_train_fwd": 1, "dit_block_train_mlp_bwd": 1,
                                     "dit_block_train_attn_bwd": 1}}
    for path, kw in (("block_hybrid", {}), ("block_pallas_bwd", {"pallas_bwd": True})):
        fn = make_fused_block_train(heads, 4, 2, **kw)
        leaves = [a.detach().requires_grad_(True) for a in blk.values()]
        reset_counts()
        got = torch.autograd.grad(fn(*leaves), leaves, dy)
        torch.cuda.synchronize()
        block_counts[path] = counts()
        block_errs[path] = output_errors(list(blk), got, want)
        check_errors(f"make_fused_block_train ({path})", block_errs[path], BLOCK_GRAD_TOL)
        if {k: v for k, v in block_counts[path].items() if v} != expected[path]:
            raise AssertionError(f"{path}: launches {block_counts[path]}, expected "
                                 f"{expected[path]}")
    emit({"phase": "block_train", "shape": [8, t, c, hid, heads], "tol": BLOCK_GRAD_TOL,
          "rel_err": {p: {k: e[1] for k, e in errs.items()} for p, errs in block_errs.items()},
          "launches": block_counts, "seconds": time.time() - t_case})
    del blk, dy, leaves, want, got

    # P1: row quantization and the int8 GEMM at the int8 path's shapes, then
    # the probe's two chains at its own call
    t_case = time.time()
    x = rn(P1_ROWS, 4 * c, dtype=f32)
    q, sq = quant_rows(x)
    wq, wsq = reference_quant_rows(x)
    torch.cuda.synchronize()
    mismatches = int((q != wq).sum()) + int((sq != wsq).sum())
    if mismatches:
        raise AssertionError(f"quant_rows (51200, 4096): {mismatches} values differ from plain")
    bms, by = bound_ms(x.numel() * 5 + 4 * P1_ROWS, 3 * x.numel(), F32_FLOPS)
    p1_rows = {"quant_rows": {
        "shape": list(x.shape), "max_abs_err": 0.0, "mismatches": mismatches,
        "ms": time_ms(torch, lambda: quant_rows(x)),
        "plain_ms": time_ms(torch, lambda: reference_quant_rows(x)), "library_ms": None,
        "bound_ms": bms, "bound_by": by, "seconds": time.time() - t_case}}
    emit({"phase": "kernel", "name": "quant_rows", **p1_rows["quant_rows"]})
    del x, q, sq, wq, wsq
    int8_cases = (("qkv", c, 3 * c, "store", bf, f32), ("proj", c, c, "store", f32, bf),
                  ("fc1", c, hid, "gelu", f32, f32), ("fc2", hid, c, "store", f32, f32))
    for layer, k, n, epi, odt, xdt in int8_cases:
        t_case = time.time()
        x = rn(P1_ROWS, k, dtype=xdt)
        qw, sw = quantize_weight(rn(n, k, scale=k ** -0.5, dtype=f32))
        b = rn(n, scale=0.02)
        out = int8_dense(x, qw, sw, b, epi, odt)
        ref = reference_int8_dense(x, qw, sw, b, epi, odt)
        torch.cuda.synchronize()
        err, rel = rel_err(out, ref)
        tol = INT8_TOL if odt == f32 else 2.0 ** -8
        if not rel <= tol:
            raise AssertionError(f"int8_dense {layer} (51200, {k}) x ({n}, {k}): max abs err "
                                 f"{err} is {rel} of max |plain| > {tol}")
        nbytes = x.numel() * x.element_size() + n * k + 6 * n + P1_ROWS * n * out.element_size()
        bms, by = bound_ms(nbytes, 2 * P1_ROWS * n * k, INT8_OPS)
        row = {"layer": layer, "shape": [P1_ROWS, k, n], "epilogue": epi, "out": str(odt),
               "max_abs_err": err, "rel_err": rel, "tol": tol,
               "ms": time_ms(torch, lambda: int8_dense(x, qw, sw, b, epi, odt)),
               "plain_ms": time_ms(torch, lambda: reference_int8_dense(x, qw, sw, b, epi, odt),
                                   reps=5),
               "library_ms": time_ms(torch, lambda: library_int8_dense(
                   torch, F, x, qw, sw, b, epi == "gelu", odt)),
               "bound_ms": bms, "bound_by": by, "seconds": time.time() - t_case}
        p1_rows[layer] = row
        emit({"phase": "kernel", "name": "int8_dense", **row})
        del x, qw, sw, b, out, ref
    inp = microbench_int8.probe_inputs(dev, SEED)
    dh = microbench_int8.D * microbench_int8.H
    p1_ops = microbench_int8.CHAIN * 2 * (2 * inp["x"].shape[0] * dh)
    # x read and the output written in bf16, the two weights (int8 with their
    # f32 scales, or bf16) read once
    p1_io = 2 * 2 * inp["x"].numel()
    x = inp["x"]
    steps = {"int8_mlp": (int8_mlp(x, inp["w1"], inp["s1"], None, inp["w2"], inp["s2"], None),
                          reference_int8_mlp(x, inp["w1"], inp["s1"], None, inp["w2"],
                                             inp["s2"], None)),
             "bf16_mlp": (bf16_mlp(x, inp["w1b"], inp["w2b"]),
                          reference_bf16_mlp(x, inp["w1b"], inp["w2b"]))}
    for name, run, plain, lib, peak, wbytes, step_tol, chain_tol in (
            ("int8_mlp", microbench_int8.run_int8, reference_int8_mlp,
             lambda *a: library_int8_mlp(torch, F, *a), INT8_OPS,
             2 * dh + 4 * (microbench_int8.D + microbench_int8.H), P1_STEP_TOL, P1_CHAIN_TOL),
            ("bf16_mlp", microbench_int8.run_bf16, reference_bf16_mlp,
             lambda *a: library_bf16_mlp(F, *a), BF16_FLOPS, 4 * dh, BF16_MLP_TOL,
             BF16_MLP_TOL)):
        t_case = time.time()
        out, ref = run(inp), run(inp, plain)
        torch.cuda.synchronize()
        err, rel = rel_err(out, ref)
        step_err, step_rel = rel_err(*steps[name])
        if not step_rel <= step_tol:
            raise AssertionError(f"{name}, one step: max abs err {step_err} is {step_rel} of "
                                 f"max |plain| > {step_tol}")
        if not (rel <= chain_tol and float(ref.float().abs().max()) > 0):
            raise AssertionError(f"{name} chain of {microbench_int8.CHAIN}: max abs err {err} "
                                 f"is {rel} of max |plain| > {chain_tol}")
        bms, by = bound_ms(p1_io + wbytes, p1_ops, peak)
        row = {"shape": [inp["x"].shape[0], microbench_int8.D, microbench_int8.H],
               "chain": microbench_int8.CHAIN, "max_abs_err": err, "rel_err": rel,
               "tol": chain_tol, "step_rel_err": step_rel, "step_tol": step_tol,
               "max_plain": float(ref.float().abs().max()),
               "ms": time_ms(torch, lambda: run(inp), reps=5, warmup=1),
               "plain_ms": time_ms(torch, lambda: run(inp, plain), reps=2, warmup=1),
               "library_ms": time_ms(torch, lambda: run(inp, lib), reps=5, warmup=1),
               "bound_ms": bms, "bound_by": by, "seconds": time.time() - t_case}
        p1_rows[name] = row
        emit({"phase": "kernel", "name": name, **row})
        del out, ref
    del inp, x, steps

    # the redesigned int8 GEMM (int8_gemm_sm90.cuh): each of the int8 path's
    # four products and the probe step's two alone, against its bound and
    # torch._int_mm of the same int8 operands; its output against the plain
    # version's and int8_dense's, bit for bit; ptxas's registers and spills
    # of its 8 instances
    from lfm_tpu_torch.tools.bench_int8 import gemm_rows as int8_gemm_rows

    int8_gemms = int8_gemm_rows(reps=10, repeats=1)
    int8_ptxas = {re.sub(r"^_ZN3lfm4sm9021int8_gemm_sm90_kernelI(.*)EEv.*$",
                         r"int8_gemm_sm90_kernel<\1>", k): u
                  for k, u in _build.ptxas_usage("int8_gemm").items()
                  if "int8_gemm_sm90_kernel" in k}
    emit({"phase": "int8_redesign", "source": csrc + "int8_gemm_sm90.cuh", "gemms": int8_gemms,
          "ptxas": int8_ptxas})
    spilled = {k: u for k, u in int8_ptxas.items()
               if u.get("spill_stores") or u.get("spill_loads")}
    # 2 tile widths x GELU or not x f32 or bf16 out
    if len(int8_ptxas) != 8 or spilled:
        raise AssertionError(f"int8 GEMM: {len(int8_ptxas)} kernel instances, spills {spilled}")
    unequal = [r["product"] for r in int8_gemms
               if not (r["equals_plain"] and r["dense_equals_gemm"])]
    if unequal:
        raise AssertionError(f"int8 GEMM: outputs not bit-identical for {unequal}")
    emit({"phase": "kernels_vs_plain", "seconds": time.time() - t0})

    # 3. gradients of a small full-width DiT through K1/K3, and through the
    # fused train path, against plain autograd
    t0 = time.time()
    grads = {}
    for variant in ("kernels", "plain", "fused", "kernels_f32", "plain_f32"):
        small = DiT(img_resolution=32, patch_size=2, hidden_size=1024, depth=2, num_heads=16,
                    dtype=f32 if variant.endswith("f32") else bf,
                    use_flash=variant.startswith("kernels")).to(dev)
        seeded_init_(small, SEED)
        g = torch.Generator(device=dev)
        g.manual_seed(SEED + 2)
        z0, z1 = (torch.randn(8, 32, 32, 4, generator=g, device=dev) for _ in range(2))
        tt = torch.rand(8, generator=g, device=dev)
        z_t, u = interpolate(z0, z1, tt)
        if variant == "fused":
            v = dit_fused_apply(small, dict(small.named_parameters()), tt, z_t, train_vjp=True)
        else:
            v = small(tt, z_t, train=True)
        torch.mean(torch.square(v - u)).backward()
        grads[variant] = {name: p.grad.float() for name, p in small.named_parameters()}
        del small, v
    worst = {variant: max((rel_err(grads[variant][name], want)[1], name)
                          for name, want in grads[plain].items())
             for variant, plain in (("kernels", "plain"), ("fused", "plain"),
                                    ("kernels_f32", "plain_f32"))}
    emit({"phase": "grad", "tensors": len(grads["plain"]), "max_rel_err": worst["kernels"][0],
          "tensor": worst["kernels"][1], "tol": GRAD_TOL,
          "fused_max_rel_err": worst["fused"][0], "fused_tensor": worst["fused"][1],
          "f32_max_rel_err": worst["kernels_f32"][0], "f32_tensor": worst["kernels_f32"][1],
          "f32_tol": F32_GRAD_TOL, "seconds": time.time() - t0})
    for variant, tol in (("kernels", GRAD_TOL), ("fused", GRAD_TOL),
                         ("kernels_f32", F32_GRAD_TOL)):
        if not worst[variant][0] <= tol:
            raise AssertionError(f"DiT gradient of {worst[variant][1]} ({variant}): "
                                 f"{worst[variant][0]} > {tol}")
    del grads

    # 4. main path, fused blocks: celeb256_dit, bf16 DiT-L/2, dopri5, VAE decode
    vae = create_vae(dtype=bf, device=dev)
    seeded_init_(vae, SEED + 1)
    depth = model.depth
    noise, y = noise_and_labels(config, SampleRNG(config.sample.seed), range(batch),
                                device=dev)
    sampler = make_sampler(config, model, None, vae, None, device=dev)
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.time()
    res = sampler(noise, y)
    torch.cuda.synchronize()
    secs = time.time() - t0
    fused_counts = counts()
    k2_launches = FUSED_DIT_BLOCK.count
    img = res.images
    emit({"phase": "main_fused", "seconds": secs, "method": config.sample.method,
          "atol": config.sample.atol, "rtol": config.sample.rtol, "nfe": res.nfe,
          "images": list(img.shape), "launches": fused_counts,
          "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
          "image_mean": float(img.float().mean()), "image_std": float(img.float().std())})
    if tuple(img.shape) != (batch, 256, 256, 3):
        raise AssertionError(f"image shape {tuple(img.shape)}")
    if not (bool(torch.isfinite(img).all()) and float(img.min()) >= 0.0 and float(img.max()) <= 1.0):
        raise AssertionError("images are not finite values in [0, 1]")
    if not bool(torch.isfinite(res.latents).all()):
        raise AssertionError("latents are not finite")
    if k2_launches != depth * res.nfe or sum(fused_counts.values()) != k2_launches:
        raise AssertionError(f"fused path: {k2_launches} fused_dit_block launches for NFE "
                             f"{res.nfe} x depth {depth}; launches {fused_counts}")

    # 5. main path, module blocks: attention through attention_small
    mconfig = dataclasses.replace(config, sample=dataclasses.replace(
        config.sample, use_fused_dit=False, method="euler", num_steps=4))
    msampler = make_sampler(mconfig, model, None, vae, None, device=dev)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    mres = msampler(noise, y)
    torch.cuda.synchronize()
    msecs = time.time() - t0
    module_counts = counts()
    k1_module = ATTENTION_SMALL.count
    mimg = mres.images
    with torch.no_grad():
        tt = torch.full((batch,), 0.5, device=dev)
        v_fused = dit_fused_apply(model, cast_params_bf16(model.state_dict()), tt, noise)
        v_module = model(tt, noise)
    vel_err = float((v_fused - v_module).abs().max()) / float(v_module.abs().max())
    emit({"phase": "main_module", "seconds": msecs, "method": "euler", "nfe": mres.nfe,
          "images": list(mimg.shape), "launches": module_counts, "velocity_rel_err": vel_err,
          "velocity_tol": VEL_TOL})
    if not (bool(torch.isfinite(mimg).all()) and tuple(mimg.shape) == tuple(img.shape)):
        raise AssertionError("module path images are not finite or have the wrong shape")
    if k1_module != depth * mres.nfe or sum(module_counts.values()) != k1_module:
        raise AssertionError(f"module path: {module_counts} launches for NFE {mres.nfe} x "
                             f"depth {depth}")
    if not vel_err <= VEL_TOL:
        raise AssertionError(f"fused vs module velocity: {vel_err} > {VEL_TOL}")
    del sampler, msampler, res, img, v_fused

    # 5b. int8_main: the same model and noise through the w8a8 blocks
    t_int8 = time.time()
    iconfig = dataclasses.replace(config, sample=dataclasses.replace(
        config.sample, use_int8_dit=True, method="euler", num_steps=4))
    torch.cuda.synchronize()
    t0 = time.time()
    isampler = make_sampler(iconfig, model, None, vae, None, device=dev)
    torch.cuda.synchronize()
    quantize_s = time.time() - t0
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.time()
    ires = isampler(noise, y)
    torch.cuda.synchronize()
    isecs = time.time() - t0
    int8_counts = counts()
    iimg = ires.images
    with torch.no_grad():
        qparams = quantize_params_int8(model, model.state_dict())
        v_int8 = dit_int8_apply(model, qparams, tt, noise)
        v_int8_plain = dit_int8_apply(model, qparams, tt, noise, plain=True)
    int8_err = float((v_int8 - v_int8_plain).abs().max()) / float(v_int8_plain.abs().max())
    int8_bf16_err = float((v_int8 - v_module).abs().max()) / float(v_module.abs().max())
    per_eval = 4 * depth
    emit({"phase": "int8_main", "seconds": isecs, "samples_per_s": batch / isecs,
          "method": "euler", "nfe": ires.nfe, "quantize_seconds": quantize_s,
          "images": list(iimg.shape), "launches": int8_counts,
          "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
          "velocity_rel_err_vs_plain": int8_err, "velocity_tol": INT8_VEL_TOL,
          "velocity_rel_err_vs_bf16_module": int8_bf16_err, "vs_bf16_tol": INT8_VS_BF16_TOL,
          "image_mean": float(iimg.float().mean()), "phase_seconds": time.time() - t_int8})
    if tuple(iimg.shape) != (batch, 256, 256, 3) or not (
            bool(torch.isfinite(iimg).all()) and bool(torch.isfinite(ires.latents).all())):
        raise AssertionError(f"int8 images {tuple(iimg.shape)} are not finite or mis-shaped")
    want_counts = {"quant_rows": per_eval * ires.nfe, "int8_dense": per_eval * ires.nfe}
    if {k: v for k, v in int8_counts.items() if v} != want_counts:
        raise AssertionError(f"int8 path: launches {int8_counts}, expected {want_counts}")
    if not int8_err <= INT8_VEL_TOL:
        raise AssertionError(f"int8 velocity vs its plain version: {int8_err} > {INT8_VEL_TOL}")
    if not int8_bf16_err <= INT8_VS_BF16_TOL:
        raise AssertionError(f"int8 vs bf16 module velocity: {int8_bf16_err} > "
                             f"{INT8_VS_BF16_TOL}")
    del isampler, ires, qparams, v_int8, v_int8_plain, v_module, noise
    torch.cuda.empty_cache()

    # 5c. fid: seeded Inception over the bf16 module's images, whose
    # statistics cli_eval scores the CLI's fid command against
    t_fid = time.time()
    inception_sd = seeded_inception_state_dict(SEED)
    extractor = ActivationExtractor(inception_sd, device=dev)
    act_cpu = ActivationExtractor(inception_sd, device="cpu")(mimg[:2].cpu())
    act_dev = extractor(mimg[:2])
    act_err = float(abs(act_dev - act_cpu).max()) / float(abs(act_cpu).max())
    extractor(mimg[:50])  # warm-up (cuDNN's algorithm choice)
    torch.cuda.synchronize()
    t0 = time.time()
    acts, acts_int8 = (extractor.over_batches(images.split(50)) for images in (mimg, iimg))
    torch.cuda.synchronize()
    extract_s = time.time() - t0
    stats_path = os.path.join(work, "main_module_stats.npy")
    mu, sigma = activation_statistics(acts)
    save_statistics(stats_path, mu, sigma)
    # the int8 images' statistics against the bf16 ones: the Fréchet
    # distance's mean term and trace difference (its sqrtm is cli_eval's)
    mu8, sigma8 = activation_statistics(acts_int8)
    mean_sq = float(((mu8 - mu) ** 2).sum())
    trace_diff = float(np.trace(sigma8) - np.trace(sigma))
    emit({"phase": "fid", "images": [int(mimg.shape[0]), int(iimg.shape[0])],
          "features": int(acts.shape[1]),
          "weights": "seeded (no pt_inception checkpoint in the repository): a "
                     "protocol-level number, not image quality",
          "activation_rel_err_vs_cpu": act_err, "activation_tol": FID_ACT_TOL,
          "int8_vs_bf16_mean_sq": mean_sq, "int8_vs_bf16_trace_diff": trace_diff,
          "extract_ms_per_image": 1e3 * extract_s / (2 * batch),
          "phase_seconds": time.time() - t_fid})
    for name, a, m, sg in (("bf16", acts, mu, sigma), ("int8", acts_int8, mu8, sigma8)):
        if not (a.shape == (batch, 2048) and np.isfinite(a).all() and np.isfinite(m).all()
                and np.isfinite(sg).all()):
            raise AssertionError(f"{name} Inception activations {a.shape} or their statistics "
                                 "are not finite")
    if not act_err <= FID_ACT_TOL:
        raise AssertionError(f"Inception activations on the card vs the CPU: {act_err} > "
                             f"{FID_ACT_TOL}")
    del extractor, acts, acts_int8, mimg, iimg, inception_sd
    torch.cuda.empty_cache()

    # 5d. p1_probe: P1's probe tool, int8_mlp against bf16_mlp
    reset_counts()
    p1_line = microbench_int8.measure(dev)
    probe_counts = counts()
    calls = microbench_int8.CHAIN * (1 + microbench_int8.REPS)
    emit({"phase": "p1_probe", **p1_line, "launches": probe_counts})
    if {k: v for k, v in probe_counts.items() if v} != {"int8_mlp": calls, "bf16_mlp": calls}:
        raise AssertionError(f"p1_probe: launches {probe_counts}, expected {calls} of each")

    # 5e. cli_eval: the CLI's fid, nfe and time on celeb256_dit from model_0.pth
    t_cli = time.time()
    cli_args = ["--preset", "celeb256_dit", "--ckpt", ckpt_path]
    fid_log = os.path.join(work, "fid_log.txt")
    cli_counts, cli_seconds, score_s = {}, {}, []
    score = sharded.fid_from_activations

    def timed_score(acts, path):  # the host sqrtm, timed apart from the generation
        t0 = time.time()
        try:
            return score(acts, path)
        finally:
            score_s.append(time.time() - t0)

    sharded.fid_from_activations = timed_score
    for cmd, args in (("fid", ["--method", "euler", "--steps", str(CLI_FID_STEPS),
                               "--n_sample", str(CLI_FID_SAMPLES), "--batch_size", str(batch),
                               "--real_img_dir", stats_path, "--output_log", fid_log,
                               "--epoch_id", "0"]),
                      ("nfe", ["--n_sample", str(CLI_NFE_TRIALS)]),
                      ("time", ["--n_sample", str(CLI_TIME_REPS)])):
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.time()
        cli_out = cli_main([cmd, *cli_args, *args])
        torch.cuda.synchronize()
        cli_seconds[cmd] = time.time() - t0
        cli_counts[cmd] = counts()
        if cmd == "fid":
            cli_fid = cli_out
        elif cmd == "nfe":
            cli_nfes = cli_out
        else:
            cli_time = cli_out
    sharded.fid_from_activations = score
    # fused_dit_block, depth launches an evaluation: the fid command's euler
    # steps for each of its batches, every nfe trial's and every time run's
    # (the warm-up's and each repetition's) NFE
    cli_nfe = {"fid": CLI_FID_STEPS * math.ceil(CLI_FID_SAMPLES / batch),
               "nfe": sum(cli_nfes), "time": sum(cli_time["nfe"])}
    with open(fid_log) as f:
        log_text = f.read()
    emit({"phase": "cli_eval", "preset": "celeb256_dit", "commands": ["fid", "nfe", "time"],
          "fid": cli_fid, "fid_samples": CLI_FID_SAMPLES, "fid_steps": CLI_FID_STEPS,
          "fid_seconds": cli_seconds["fid"], "fid_score_seconds": score_s[0],
          "fid_samples_per_s_without_score": CLI_FID_SAMPLES
          / (cli_seconds["fid"] - score_s[0]), "log_line": log_text.strip(), "nfe_trials": cli_nfes,
          "nfe_seconds": cli_seconds["nfe"], "time_ms": cli_time["ms"],
          "time_ms_mean": float(np.mean(cli_time["ms"])),
          "time_ms_std": float(np.std(cli_time["ms"])), "time_nfe": cli_time["nfe"],
          "time_seconds": cli_seconds["time"], "launches": cli_counts,
          "weights": "seeded DiT-L/2, VAE and Inception: a protocol-level FID",
          "phase_seconds": time.time() - t_cli})
    if not math.isfinite(cli_fid):
        raise AssertionError(f"cli_eval: FID {cli_fid} is not finite")
    if log_text != f"Epoch = 0, FID = {cli_fid}\n":
        raise AssertionError(f"cli_eval: --output_log holds {log_text!r}")
    if len(cli_nfes) != CLI_NFE_TRIALS or len(cli_time["nfe"]) != 1 + CLI_TIME_REPS:
        raise AssertionError(f"cli_eval: {len(cli_nfes)} nfe trials, {len(cli_time['nfe'])} "
                             "time runs")
    for cmd, c in cli_counts.items():
        if {k: v for k, v in c.items() if v} != {"fused_dit_block": depth * cli_nfe[cmd]}:
            raise AssertionError(f"cli_eval {cmd}: launches {c}, expected "
                                 f"{depth * cli_nfe[cmd]} fused_dit_block ({depth} x NFE "
                                 f"{cli_nfe[cmd]})")
    cli_all = {k: sum(c[k] for c in cli_counts.values()) for k in counters}
    cli_batch1 = {k: cli_counts["nfe"][k] + cli_counts["time"][k] for k in counters}

    # 5f. karras: the Karras heun and euler loops through make_sampler on
    # celeb256_dit (K2) at the preset's batch, then VAE decode; the velocity
    # calls counted by wrapping what build_velocity returns
    t_k = time.time()
    vel_calls = [0]

    def counting_build_velocity(*args, **kwargs):
        velocity = real_build_velocity(*args, **kwargs)

        def counted(tt, x):
            vel_calls[0] += 1
            return velocity(tt, x)

        return counted

    real_build_velocity = sample_mod.build_velocity
    sample_mod.build_velocity = counting_build_velocity
    karras_rows, karras_counts = {}, {}
    noise, y = noise_and_labels(config, SampleRNG(config.sample.seed), range(batch),
                                device=dev)  # main_fused's noise
    try:
        for method in ("heun", "euler"):
            kconfig = dataclasses.replace(config, sample=dataclasses.replace(
                config.sample, use_karras_samplers=True, method=method, num_steps=KARRAS_STEPS))
            ksampler = make_sampler(kconfig, model, None, vae, None, device=dev)
            reset_counts()
            vel_calls[0] = 0
            torch.cuda.synchronize()
            t0 = time.time()
            kres = ksampler(noise, y)
            torch.cuda.synchronize()
            kc = counts()
            karras_counts[method] = kc
            kimg = kres.images
            row = {"seconds": time.time() - t0, "nfe": kres.nfe, "velocity_calls": vel_calls[0],
                   "nfe_jax_formula": karras_nfe(method, KARRAS_STEPS), "launches": kc,
                   "images": list(kimg.shape), "image_mean": float(kimg.float().mean()),
                   "images_finite": bool(torch.isfinite(kimg).all())}
            karras_rows[method] = row
            if not (row["nfe"] == row["velocity_calls"] == row["nfe_jax_formula"]):
                raise AssertionError(f"karras {method}: NFE {row['nfe']}, velocity calls "
                                     f"{row['velocity_calls']}, JAX's formula "
                                     f"{row['nfe_jax_formula']}")
            if {k: v for k, v in kc.items() if v} != {"fused_dit_block": depth * kres.nfe}:
                raise AssertionError(f"karras {method}: launches {kc}, expected "
                                     f"{depth * kres.nfe} fused_dit_block")
            if not (row["images_finite"] and tuple(kimg.shape) == (batch, 256, 256, 3)):
                raise AssertionError(f"karras {method}: images not finite or shaped "
                                     f"{tuple(kimg.shape)}")
            del ksampler, kres, kimg
    finally:
        sample_mod.build_velocity = real_build_velocity
    # f32: Karras heun at KARRAS_F32_STEPS on the same weights in f32 (f32 K1,
    # TF32 off) on the card against the same call on the CPU
    f32_card = create_network(config.model, dtype=f32, use_flash=True, device=dev)
    f32_card.load_state_dict(model.state_dict())
    f32_cpu = create_network(config.model, dtype=f32, use_flash=True, device="cpu")
    f32_cpu.load_state_dict(model.state_dict())
    knoise = noise[:KARRAS_F32_BATCH].float()
    reset_counts()
    t0 = time.time()
    with no_tf32(), torch.no_grad():
        kz_card, knfe = sample_latents(build_velocity(f32_card, None, 1.0), knoise,
                                       method="heun", num_steps=KARRAS_F32_STEPS,
                                       use_karras=True)
        torch.cuda.synchronize()
        kf32_card_s = time.time() - t0
        kf32_counts, kf32_dtypes = counts(), dict(ATTENTION_SMALL.by_dtype)
        t0 = time.time()
        kz_cpu, _ = sample_latents(build_velocity(f32_cpu, None, 1.0), knoise.cpu(),
                                   method="heun", num_steps=KARRAS_F32_STEPS, use_karras=True)
        kf32_cpu_s = time.time() - t0
    kf32_err = float((kz_card.cpu() - kz_cpu).abs().max()) / float(kz_cpu.abs().max())
    emit({"phase": "karras", "preset": "celeb256_dit", "batch": batch, "steps": KARRAS_STEPS,
          **{method: row for method, row in karras_rows.items()},
          "f32": {"batch": KARRAS_F32_BATCH, "steps": KARRAS_F32_STEPS, "nfe": knfe,
                  "rel_err_vs_cpu": kf32_err, "tol": F32_VEL_TOL, "launches": kf32_counts,
                  "launches_by_dtype": kf32_dtypes, "card_seconds": kf32_card_s,
                  "cpu_seconds": kf32_cpu_s},
          "phase_seconds": time.time() - t_k})
    if not (knfe == karras_nfe("heun", KARRAS_F32_STEPS) and bool(torch.isfinite(kz_card).all())):
        raise AssertionError(f"karras f32: NFE {knfe} or latents not finite")
    if ({k: v for k, v in kf32_counts.items() if v} != {"attention_small": depth * knfe}
            or kf32_dtypes != {"float32": depth * knfe}):
        raise AssertionError(f"karras f32: launches {kf32_counts} {kf32_dtypes}, expected "
                             f"{depth * knfe} f32 attention_small")
    if not kf32_err <= F32_VEL_TOL:
        raise AssertionError(f"karras f32: card latents {kf32_err} of the CPU's > {F32_VEL_TOL}")
    del f32_card, f32_cpu, kz_card, kz_cpu
    torch.cuda.empty_cache()

    # 5g. adaptive_more: dopri8 (with the sampling policy's "auto" floor),
    # bosh3 and adaptive_heun through odeint on the same model (K2) at batch
    # ADAPTIVE_BATCH; each run counted alone
    t_ad = time.time()
    dnoise = noise[:ADAPTIVE_BATCH]
    avel = build_velocity(model, None, 1.0, use_fused_dit=True)
    with torch.no_grad():
        t_start = torch.tensor(1.0, device=dev)
        level = float(calibrate_eval_noise(avel, t_start, dnoise, avel(t_start, dnoise), f32))
    adaptive_rows, adaptive_counts = {}, {}
    for method in ("dopri8", "bosh3", "adaptive_heun", "dopri8_capped"):
        capped = method.endswith("_capped")
        m = method.removesuffix("_capped")
        en = 0.0 if capped else resolve_eval_noise(
            dataclasses.replace(config.sample, method=m), model)
        calls = [0]

        def counted(tt, x, calls=calls):
            calls[0] += 1
            return avel(tt, x)

        reset_counts()
        torch.cuda.synchronize()
        t0 = time.time()
        with torch.no_grad():
            ares = odeint(counted, dnoise, 1.0, 0.0, method=m, rtol=config.sample.rtol,
                          atol=config.sample.atol, eval_noise=en,
                          max_steps=ADAPTIVE_CAP if capped else 10_000)
        torch.cuda.synchronize()
        ac = counts()
        adaptive_counts[method] = ac
        row = {"seconds": time.time() - t0, "eval_noise": en, "nfe": ares.nfe,
               "velocity_calls": calls[0], "steps": ares.num_steps,
               "rejected": ares.num_rejected, "t_end": ares.t_end, "launches": ac,
               "latents_finite": bool(torch.isfinite(ares.y).all())}
        adaptive_rows[method] = row
        if capped:
            continue  # printed beside the floored run, never gated on its NFE
        if not (ares.nfe == calls[0] and ac["fused_dit_block"] == depth * ares.nfe
                and sum(ac.values()) == ac["fused_dit_block"]):
            raise AssertionError(f"adaptive_more {method}: NFE {ares.nfe}, velocity calls "
                                 f"{calls[0]}, launches {ac}")
        if not (row["latents_finite"] and ares.t_end == 0.0):
            raise AssertionError(f"adaptive_more {method}: latents finite "
                                 f"{row['latents_finite']}, ended at t = {ares.t_end}")
    emit({"phase": "adaptive_more", "preset": "celeb256_dit", "batch": ADAPTIVE_BATCH,
          "rtol": config.sample.rtol, "atol": config.sample.atol,
          "auto_level": level, "capped_max_steps": ADAPTIVE_CAP, **adaptive_rows,
          "phase_seconds": time.time() - t_ad})
    if adaptive_rows["dopri8"]["eval_noise"] != "auto":
        raise AssertionError("adaptive_more: the policy gave bf16 dopri8 no auto floor")
    del avel, dnoise, noise, knoise

    # 6. adm_main: celeb256_adm, bf16 origin-ADM UNet, dopri5, VAE decode
    t_adm = time.time()
    aconfig = get_preset("celeb256_adm")
    am = aconfig.model
    adm = create_network(am, dtype=bf, use_flash=am.use_flash_attention, device=dev)
    seeded_init_(adm, SEED)
    layers = list(plan_layers(adm.plan))
    n_attn = sum(spec.kind == "attn" for spec in layers)
    n_res = sum(spec.kind.startswith("res") for spec in layers)
    # _GNSiLU: every ResBlock's in-norm, and its out-norm without scale-shift
    gn_per_eval = n_res * (1 if am.use_scale_shift_norm else 2)
    anoise, ay = noise_and_labels(aconfig, SampleRNG(aconfig.sample.seed), range(batch),
                                  device=dev)
    asampler = make_sampler(aconfig, adm, None, vae, None, device=dev)
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.time()
    ares = asampler(anoise, ay)
    torch.cuda.synchronize()
    asecs = time.time() - t0
    adm_counts = counts()
    aimg = ares.images
    emit({"phase": "adm_main", "preset": "celeb256_adm", "seconds": asecs,
          "method": aconfig.sample.method, "atol": aconfig.sample.atol,
          "rtol": aconfig.sample.rtol, "nfe": ares.nfe, "images": list(aimg.shape),
          "params": sum(p.numel() for p in adm.parameters()), "attention_layers": n_attn,
          "resblocks": n_res, "launches": adm_counts,
          "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
          "image_mean": float(aimg.float().mean()), "image_std": float(aimg.float().std()),
          "phase_seconds": time.time() - t_adm})
    if tuple(aimg.shape) != (batch, 256, 256, 3):
        raise AssertionError(f"adm image shape {tuple(aimg.shape)}")
    if not (bool(torch.isfinite(aimg).all()) and float(aimg.min()) >= 0.0
            and float(aimg.max()) <= 1.0 and bool(torch.isfinite(ares.latents).all())):
        raise AssertionError("adm images are not finite values in [0, 1]")
    k1_adm = adm_counts["attention_small"]
    if k1_adm != n_attn * ares.nfe or sum(adm_counts.values()) != k1_adm:
        raise AssertionError(f"adm path: {adm_counts} launches for NFE {ares.nfe} x "
                             f"{n_attn} attention layers")

    # 7. adm_fused_gn: the same weights, GroupNorm + SiLU through K6, euler
    t_fgn = time.time()
    fconfig = dataclasses.replace(aconfig, sample=dataclasses.replace(
        aconfig.sample, method="euler", num_steps=ADM_FUSED_STEPS))
    adm_fused = create_network(am, dtype=bf, use_flash=am.use_flash_attention,
                               use_fused_gn=True, device=dev)
    adm_fused.load_state_dict(adm.state_dict())
    fsampler = make_sampler(fconfig, adm_fused, None, vae, None, device=dev)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    fres = fsampler(anoise, ay)
    torch.cuda.synchronize()
    fsecs = time.time() - t0
    fgn_counts = counts()
    with torch.no_grad():
        tt = torch.full((batch,), 0.5, device=dev)
        v_fgn, v_plain = adm_fused(tt, anoise), adm(tt, anoise)
    fgn_err = float((v_fgn - v_plain).abs().max()) / float(v_plain.abs().max())
    emit({"phase": "adm_fused_gn", "seconds": fsecs, "method": "euler", "nfe": fres.nfe,
          "images": list(fres.images.shape), "launches": fgn_counts,
          "groupnorm_silu_per_eval": gn_per_eval, "velocity_rel_err": fgn_err,
          "velocity_tol": VEL_TOL, "phase_seconds": time.time() - t_fgn})
    if not (bool(torch.isfinite(fres.images).all())
            and tuple(fres.images.shape) == tuple(aimg.shape)):
        raise AssertionError("adm_fused_gn images are not finite or have the wrong shape")
    k6_fgn, k1_fgn = fgn_counts["groupnorm_silu"], fgn_counts["attention_small"]
    if (k6_fgn != gn_per_eval * fres.nfe or k1_fgn != n_attn * fres.nfe
            or sum(fgn_counts.values()) != k6_fgn + k1_fgn):
        raise AssertionError(f"adm_fused_gn: {fgn_counts} launches for NFE {fres.nfe}, "
                             f"{gn_per_eval} GroupNorm + SiLU and {n_attn} attention per eval")
    if not fgn_err <= VEL_TOL:
        raise AssertionError(f"fused vs plain GroupNorm + SiLU velocity: {fgn_err} > {VEL_TOL}")
    del adm, adm_fused, asampler, fsampler, ares, fres, aimg, anoise, v_fgn, v_plain
    torch.cuda.empty_cache()

    # 7b. adm512_attn: celeb512_adm attending at ds 2, 4, 8 and 16, f32 K1
    # at D = 128/256 past T = 64 through the key-block kernel
    t_a5 = time.time()
    a5config = get_preset("celeb512_adm")
    a5config = dataclasses.replace(
        a5config, model=dataclasses.replace(a5config.model, attn_resolutions=ADM512_ATTN),
        sample=dataclasses.replace(a5config.sample, method="euler", num_steps=2))
    a5m = a5config.model
    a5_models = {}
    for use_flash in (True, False):  # the kernels, and plain attention
        a5_models[use_flash] = create_network(a5m, dtype=bf, use_flash=use_flash, device=dev)
    seeded_init_(a5_models[True], SEED)
    a5_models[False].load_state_dict(a5_models[True].state_dict())
    a5_attn = [spec for spec in plan_layers(a5_models[True].plan) if spec.kind == "attn"]
    a5_batch = a5config.sample.batch_size
    a5noise, a5y = noise_and_labels(a5config, SampleRNG(a5config.sample.seed), range(a5_batch),
                                    device=dev)
    a5sampler = make_sampler(a5config, a5_models[True], None, vae, None, device=dev)
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.time()
    a5res = a5sampler(a5noise, a5y)
    torch.cuda.synchronize()
    a5secs = time.time() - t0
    a5_counts = counts()
    a5_dtypes = dict(ATTENTION_SMALL.by_dtype)
    a5_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    a5img = a5res.images
    with torch.no_grad():
        tt = torch.full((a5_batch,), 0.5, device=dev)
        v_a5, v_a5_plain = (a5_models[k](tt, a5noise) for k in (True, False))
    a5_err = float((v_a5 - v_a5_plain).abs().max()) / float(v_a5_plain.abs().max())
    emit({"phase": "adm512_attn", "preset": "celeb512_adm", "attn_resolutions": ADM512_ATTN,
          "seconds": a5secs, "method": "euler", "nfe": a5res.nfe, "images": list(a5img.shape),
          "params": sum(p.numel() for p in a5_models[True].parameters()),
          "attention_layers": len(a5_attn), "launches": a5_counts,
          "launches_by_dtype": a5_dtypes, "peak_gib": a5_peak,
          "velocity_rel_err_vs_plain_attention": a5_err, "velocity_tol": VEL_TOL,
          "image_mean": float(a5img.float().mean()), "phase_seconds": time.time() - t_a5})
    size = a5m.image_size
    if tuple(a5img.shape) != (a5_batch, size, size, 3) or not bool(torch.isfinite(a5img).all()):
        raise AssertionError(f"adm512_attn images {tuple(a5img.shape)} are not finite or "
                             "mis-shaped")
    k1_a5 = len(a5_attn) * a5res.nfe
    if ({k: v for k, v in a5_counts.items() if v} != {"attention_small": k1_a5}
            or a5_dtypes != {"float32": k1_a5}):
        raise AssertionError(f"adm512_attn: launches {a5_counts} by dtype {a5_dtypes}, expected "
                             f"{k1_a5} f32 attention_small ({len(a5_attn)} layers x NFE "
                             f"{a5res.nfe})")
    if not a5_err <= VEL_TOL:
        raise AssertionError(f"adm512_attn: velocity {a5_err} off plain attention's > {VEL_TOL}")
    del a5_models, a5sampler, a5res, a5img, a5noise, v_a5, v_a5_plain
    torch.cuda.empty_cache()

    # 7c. edm_cfg: imnet_adm, EDM's DhariwalUNet at full width, CFG 1.25
    t_edm = time.time()
    econfig = get_preset("imnet_adm")
    econfig = dataclasses.replace(econfig, sample=dataclasses.replace(
        econfig.sample, method="euler", num_steps=EDM_STEPS, batch_size=EDM_BATCH))
    em, escale = econfig.model, econfig.sample.cfg_scale
    edm = seeded_init_(create_network(em, dtype=bf, device=dev), SEED)
    enoise, ey = noise_and_labels(econfig, SampleRNG(econfig.sample.seed), range(EDM_BATCH),
                                  device=dev)
    esampler = make_sampler(econfig, edm, None, vae, None, device=dev)
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.time()
    eres = esampler(enoise, ey)
    torch.cuda.synchronize()
    esecs = time.time() - t0
    edm_counts = counts()
    e_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    eimg = eres.images
    with torch.no_grad():
        # one bf16 CFG evaluation at the doubled batch, alone
        evel = build_velocity(edm, ey, escale)
        eval_ms = time_ms(torch, lambda: evel(0.5, enoise), reps=5, warmup=1)
        edm32 = create_network(em, dtype=f32, device=dev)
        edm32.load_state_dict(edm.state_dict())
        tt = torch.full((EDM_BATCH,), 0.5, device=dev)
        v_bf, v_32 = edm(tt, enoise, ey), edm32(tt, enoise, ey)
        # f32 on the card (TF32 off within forward) against the CPU
        edm_cpu = copy.deepcopy(edm32).cpu()
        t0 = time.time()
        v_cpu = edm_cpu(tt[:2].cpu(), enoise[:2].cpu(), ey[:2].cpu())
        cpu_s = time.time() - t0
        card_err = rel_err(edm32(tt[:2], enoise[:2], ey[:2]).cpu(), v_cpu)[1]
        # the guided velocity (one doubled batch, null label -1) against two calls
        guided = build_velocity(edm32, ey, escale)(0.5, enoise)
        cond = v_32
        uncond = edm32(tt, enoise, torch.full_like(ey, edm32.null_label))
        cfg_err = rel_err(guided, uncond + escale * (cond - uncond))[1]
    bf_err = rel_err(v_bf, v_32)[1]
    # one CFG evaluation's operations, counted on the meta device: the bf16
    # convolutions, and the f32 products of the attention and the embedding
    with FlopCounterMode(display=False) as flops, torch.no_grad():
        n2, s = 2 * EDM_BATCH, em.latent_size
        create_network(em, dtype=bf, device="meta")(
            torch.zeros(n2, device="meta"), torch.zeros(n2, s, s, em.num_in_channels,
                                                         device="meta"),
            torch.zeros(n2, dtype=torch.long, device="meta"))
    eops = {str(k): v for k, v in flops.get_flop_counts()["Global"].items()}
    conv_ops = eops.pop("aten.convolution")
    eval_bound_ms = 1e3 * (conv_ops / BF16_FLOPS + sum(eops.values()) / F32_FLOPS)
    emit({"phase": "edm_cfg", "preset": "imnet_adm", "model": "DhariwalUNet",
          "params": sum(p.numel() for p in edm.parameters()), "batch": EDM_BATCH,
          "evaluated_batch": 2 * EDM_BATCH, "cfg_scale": escale, "seconds": esecs,
          "samples_per_s": EDM_BATCH / esecs, "method": "euler", "nfe": eres.nfe,
          "ms_per_evaluation": eval_ms, "bf16_conv_tflop_per_evaluation": conv_ops / 1e12,
          "f32_tflop_per_evaluation": sum(eops.values()) / 1e12,
          "bound_ms_per_evaluation": eval_bound_ms, "bound_by": "operations",
          "images": list(eimg.shape), "launches": edm_counts,
          "peak_gib": e_peak, "f32_card_vs_cpu_rel_err": card_err, "f32_tol": F32_VEL_TOL,
          "cpu_seconds_batch2": cpu_s, "bf16_vs_f32_rel_err": bf_err, "bf16_tol": VEL_TOL,
          "cfg_vs_two_calls_rel_err": cfg_err, "cfg_tol": CFG_TOL,
          "image_mean": float(eimg.float().mean()), "phase_seconds": time.time() - t_edm})
    if tuple(eimg.shape) != (EDM_BATCH, em.image_size, em.image_size, 3) or not (
            bool(torch.isfinite(eimg).all()) and float(eimg.min()) >= 0.0
            and float(eimg.max()) <= 1.0 and bool(torch.isfinite(eres.latents).all())):
        raise AssertionError(f"edm_cfg images {tuple(eimg.shape)} are not finite values in "
                             "[0, 1]")
    if eres.nfe != EDM_STEPS or any(edm_counts.values()):
        raise AssertionError(f"edm_cfg: NFE {eres.nfe}, launches {edm_counts}; expected "
                             f"{EDM_STEPS} and no hand-written kernel")
    if not card_err <= F32_VEL_TOL:
        raise AssertionError(f"edm_cfg: f32 velocity on the card vs the CPU {card_err} > "
                             f"{F32_VEL_TOL}")
    if not bf_err <= VEL_TOL:
        raise AssertionError(f"edm_cfg: bf16 velocity vs f32 {bf_err} > {VEL_TOL}")
    if not cfg_err <= CFG_TOL:
        raise AssertionError(f"edm_cfg: guided velocity vs two calls {cfg_err} > {CFG_TOL}")
    del edm, edm32, edm_cpu, esampler, eres, eimg, enoise, v_bf, v_32, v_cpu, guided, uncond
    torch.cuda.empty_cache()

    # 8. long_t: DiT-L/2 at 1024 px (T = 4096), module path through K4
    t_long = time.time()
    lconfig = dataclasses.replace(
        config, model=dataclasses.replace(config.model, image_size=LONG_T_SIZE),
        sample=dataclasses.replace(config.sample, method="euler", num_steps=2, batch_size=2))
    long_model = create_network(lconfig.model, dtype=bf,
                                use_flash=lconfig.model.use_flash_attention, device=dev)
    long_model.load_state_dict(model.state_dict())
    tokens = (long_model.img_resolution // long_model.patch_size) ** 2
    lnoise, ly = noise_and_labels(lconfig, SampleRNG(lconfig.sample.seed),
                                  range(lconfig.sample.batch_size), device=dev)
    lsampler = make_sampler(lconfig, long_model, None, vae, None, device=dev)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    lres = lsampler(lnoise, ly)
    torch.cuda.synchronize()
    lsecs = time.time() - t0
    long_counts = counts()
    limg = lres.images
    emit({"phase": "long_t", "image_size": LONG_T_SIZE, "tokens": tokens, "seconds": lsecs,
          "method": "euler", "nfe": lres.nfe, "images": list(limg.shape),
          "launches": long_counts, "image_mean": float(limg.float().mean()),
          "phase_seconds": time.time() - t_long})
    if tuple(limg.shape) != (2, LONG_T_SIZE, LONG_T_SIZE, 3) or not bool(
            torch.isfinite(limg).all()):
        raise AssertionError(f"long_t images {tuple(limg.shape)} are not finite or mis-shaped")
    k4_long = long_counts["flash_attention"]
    if k4_long != depth * lres.nfe or sum(long_counts.values()) != k4_long:
        raise AssertionError(f"long_t: {long_counts} launches for NFE {lres.nfe} x depth {depth}")
    del long_model, lsampler, lres, limg, lnoise
    torch.cuda.empty_cache()

    # 8b. long_f32: an f32 DiT-L/2 at 512 px (T = 1024), module path through
    # f32 K1 past T = 256 (attention_long_f32.cuh)
    t_lf = time.time()
    fconfig = dataclasses.replace(
        config, model=dataclasses.replace(config.model, image_size=LONG_F32_SIZE),
        sample=dataclasses.replace(config.sample, method="euler", num_steps=2, batch_size=2))
    f32_models = {}
    for use_flash in (True, False):  # the kernels, and plain attention
        f32_models[use_flash] = create_network(fconfig.model, dtype=f32, use_flash=use_flash,
                                               device=dev)
        f32_models[use_flash].load_state_dict(model.state_dict())
    lf_tokens = (f32_models[True].img_resolution // f32_models[True].patch_size) ** 2
    fnoise, fy = noise_and_labels(fconfig, SampleRNG(fconfig.sample.seed),
                                  range(fconfig.sample.batch_size), device=dev)
    fsampler = make_sampler(fconfig, f32_models[True], None, vae, None, device=dev)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    fres = fsampler(fnoise, fy)
    torch.cuda.synchronize()
    lf_secs = time.time() - t0
    lf_counts = counts()
    lf_dtypes = dict(ATTENTION_SMALL.by_dtype)
    fimg = fres.images
    with torch.no_grad():
        tt = torch.full((fconfig.sample.batch_size,), 0.5, device=dev)
        v_lf, v_lf_plain = (f32_models[k](tt, fnoise) for k in (True, False))
    lf_err = float((v_lf - v_lf_plain).abs().max()) / float(v_lf_plain.abs().max())
    emit({"phase": "long_f32", "image_size": LONG_F32_SIZE, "tokens": lf_tokens,
          "seconds": lf_secs, "method": "euler", "nfe": fres.nfe, "images": list(fimg.shape),
          "launches": lf_counts, "launches_by_dtype": lf_dtypes,
          "velocity_rel_err_vs_plain_attention": lf_err, "velocity_tol": F32_VEL_TOL,
          "image_mean": float(fimg.float().mean()), "phase_seconds": time.time() - t_lf})
    if tuple(fimg.shape) != (2, LONG_F32_SIZE, LONG_F32_SIZE, 3) or not bool(
            torch.isfinite(fimg).all()) or v_lf.dtype != f32:
        raise AssertionError(f"long_f32 images {tuple(fimg.shape)} are not finite or "
                             f"mis-shaped, or the velocity is {v_lf.dtype}")
    k1_lf = depth * fres.nfe
    if lf_tokens != 1024 or lf_counts["attention_small"] != k1_lf or sum(
            lf_counts.values()) != k1_lf or lf_dtypes != {"float32": k1_lf}:
        raise AssertionError(f"long_f32: T = {lf_tokens}, {lf_counts} launches by dtype "
                             f"{lf_dtypes} for NFE {fres.nfe} x depth {depth}")
    if not lf_err <= F32_VEL_TOL:
        raise AssertionError(f"long_f32 velocity vs plain attention: {lf_err} > {F32_VEL_TOL}")
    del f32_models, fsampler, fres, fimg, fnoise, v_lf, v_lf_plain
    torch.cuda.empty_cache()

    # 9. train: celeb256_dit through train(...), from the seeded weights above
    t_train = time.time()
    del model
    torch.cuda.empty_cache()
    tc = dataclasses.replace(config.train, model_ckpt=ckpt_path)
    tconfig = dataclasses.replace(config, train=tc, output_dir=work)
    dataset = SyntheticImageDataset(n=train_batch * (TRAIN_STEPS + 2), image_size=256,
                                    seed=SEED)
    train_dataset = dataset  # the ranks' (10f); the downstream paths rebind the name
    if TRAIN_STEPS >= len(dataset) // train_batch:
        raise AssertionError("the train run must stay below one epoch (no demo plot)")

    def train_run(max_steps):
        logs = []
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        t_run = time.time()
        state = train(tconfig, dataset=dataset, vae=vae, device=dev, max_steps=max_steps,
                      log_fn=lambda line: logs.append((time.time(), line)))
        torch.cuda.synchronize()
        t_end = time.time()
        steps = [(t, line) for t, line in logs if "Loss: " in line]
        if len(steps) != 1:
            raise AssertionError(f"train: expected one log line, after step 1; got {steps}")
        loss = float(re.search(r"Loss: (\S+),", steps[0][1]).group(1))
        return state, loss, steps[0], t_end, t_end - t_run

    state1, loss1, _, _, run1_s = train_run(1)
    i = state1.names.index(probe)
    p1, ema1 = state1.params[i].detach(), state1.ema[i].detach()
    decay = tc.ema_decay
    ema_err = float((ema1 - (decay * p0 + (1 - decay) * p1)).abs().max())
    moved = float((p1 - p0).abs().max())
    train_p1 = p1.float().cpu()  # dist_world's step 1 is held against it
    del state1, p1, ema1
    torch.cuda.empty_cache()
    state, loss_again, (t_log, line), t_end, run_s = train_run(TRAIN_STEPS)
    train_counts = counts()
    k1_train, k3_train = ATTENTION_SMALL.count, ATTENTION_SMALL_BWD.count
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    tdepth = len([name for name in state.names if name.endswith("attn.qkv.weight")])
    finite = all(bool(torch.isfinite(p).all()) for p in state.params)
    sec_per_step = (t_end - t_log) / (TRAIN_STEPS - 1)
    emit({"phase": "train", "preset": "celeb256_dit", "model": config.model.model_type,
          "batch": train_batch, "steps": state.step, "seconds_per_step": sec_per_step,
          "images_per_s": train_batch / sec_per_step, "peak_gib": peak,
          "loss_step1": loss1, "loss_step1_again": loss_again, "log": line,
          "run_seconds": [run1_s, run_s], "launches": train_counts,
          "ema_max_abs_err": ema_err, "param_max_change_step1": moved,
          "params_finite": finite, "seconds": time.time() - t_train})
    if not (math.isfinite(loss1) and math.isfinite(loss_again) and finite):
        raise AssertionError(f"train: step 1's loss {loss1}, {loss_again} or the parameters "
                             "are not finite")
    if not moved > 0:
        raise AssertionError("train: the parameters did not move in one step")
    if not ema_err <= 1e-6 * float(p0.abs().max()):
        raise AssertionError(f"train: EMA is off decay * p0 + (1 - decay) * p1 by {ema_err}")
    if (state.step != TRAIN_STEPS or k3_train != tdepth * TRAIN_STEPS
            or k1_train != 2 * tdepth * TRAIN_STEPS
            or sum(train_counts.values()) != k1_train + k3_train):
        raise AssertionError(f"train: {state.step} steps, {k3_train} attention_small_bwd and "
                             f"{k1_train} attention_small launches for depth {tdepth}")
    del state
    torch.cuda.empty_cache()

    # 9b. train_remat: the train phase's step (module path, bf16 on f32
    # masters, K1 / K3, the same model_0.pth, batches and draws) under each
    # remat policy, 1 + TRAIN_STEPS steps each, counted and timed alone
    t_rm = time.time()
    remat_rows, remat_counts = {}, {}
    rgen = torch.Generator(device=dev)
    rgen.manual_seed(SEED)
    grads_ref = None
    for run_name, remat, policy in REMAT_RUNS:
        rmodel = create_network(config.model, dtype=bf,
                                use_flash=config.model.use_flash_attention, remat=remat,
                                remat_policy=policy, device=dev)
        rmodel.load_state_dict(reference_state_dict(torch.load(ckpt_path, map_location="cpu",
                                                               weights_only=False)))
        rmodel.train()
        rloader = DataLoader(dataset, train_batch, shuffle=True, drop_last=True, seed=tc.seed)
        rloader.set_epoch(0)
        rstate = create_train_state(rmodel)
        rstep = make_train_step(
            rmodel, make_optimizer(tc, tc.steps_per_epoch or max(len(rloader), 1)),
            ema_decay=tc.ema_decay, use_ema=tc.use_ema, encode_fn=vae.encode_sample,
            scale_factor=config.scale_factor, label_dropout=config.model.label_dropout > 0,
            dropout=config.model.dropout > 0, seed=tc.seed + 1)
        rbatches = iter(rloader)
        reset_counts()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        rx1 = torch.from_numpy(next(rbatches)["x"]).to(dev)
        rloss1 = float(rstep(rstate, {"x": rx1})[0])
        grads = [p.grad.detach().clone() for p in rstate.params]
        if grads_ref is None:
            grads_ref, rloss_ref = grads, rloss1
        grad_err = max(float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
                       for g, w in zip(grads, grads_ref))
        del grads
        torch.cuda.synchronize()
        t0 = time.time()
        for _ in range(TRAIN_STEPS):
            rloss = rstep(rstate, {"x": torch.from_numpy(next(rbatches)["x"]).to(dev)})[0]
        torch.cuda.synchronize()
        rsec = (time.time() - t0) / TRAIN_STEPS
        rc = counts()
        remat_counts[run_name] = rc
        rsteps = rstate.step
        step_peak = torch.cuda.max_memory_allocated() / 2 ** 30
        # the step's peak is the optimizer's under most policies; what a
        # policy keeps shows in one forward and backward alone: the memory
        # the forward leaves allocated for backward, and the peak over both
        with torch.no_grad():
            rz0 = vae.encode_sample(rx1, rgen) * config.scale_factor
        rt = torch.rand((train_batch,), generator=rgen, device=dev)
        rz1 = torch.randn(rz0.shape, generator=rgen, device=dev)
        for p in rstate.params:
            p.grad = None
        torch.cuda.synchronize()
        m0 = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fb_loss = fm_train_loss(rmodel, rz0.float(), None, rt, rz1)
        saved_gib = (torch.cuda.memory_allocated() - m0) / 2 ** 30
        fb_loss.backward()
        torch.cuda.synchronize()
        fb_peak_gib = (torch.cuda.max_memory_allocated() - m0) / 2 ** 30
        del fb_loss, rz0, rz1, rt
        row = {"remat": remat, "policy": policy, "steps": rsteps, "seconds_per_step": rsec,
               "images_per_s": train_batch / rsec, "peak_gib": step_peak,
               "saved_for_backward_gib": saved_gib, "fwd_bwd_peak_gib": fb_peak_gib,
               "loss_step1": rloss1,
               "loss_step1_diff": rloss1 - rloss_ref, "grad_max_rel_err_vs_no_remat": grad_err,
               "loss_last": float(rloss), "launches": rc,
               "k1_per_step": rc["attention_small"] / rsteps,
               "k3_per_step": rc["attention_small_bwd"] / rsteps}
        remat_rows[run_name] = row
        k1_want = (1 if run_name in ("no_remat", "dots_attn") else 2) * tdepth * rsteps
        if (rsteps != 1 + TRAIN_STEPS or rc["attention_small_bwd"] != tdepth * rsteps
                or rc["attention_small"] != k1_want
                or sum(rc.values()) != rc["attention_small"] + rc["attention_small_bwd"]):
            raise AssertionError(f"train_remat {run_name}: {rsteps} steps, launches {rc}, "
                                 f"expected {k1_want} attention_small and "
                                 f"{tdepth * rsteps} attention_small_bwd")
        if not (math.isfinite(rloss1) and rloss1 == rloss_ref):
            raise AssertionError(f"train_remat {run_name}: step 1's loss {rloss1} is not no "
                                 f"remat's {rloss_ref}")
        if not grad_err <= GRAD_TOL:
            raise AssertionError(f"train_remat {run_name}: step 1's gradients {grad_err} of no "
                                 f"remat's > {GRAD_TOL}")
        del rmodel, rstate, rstep, rloader, rbatches, rx1
        torch.cuda.empty_cache()
    del grads_ref
    emit({"phase": "train_remat", "preset": "celeb256_dit", "model": config.model.model_type,
          "batch": train_batch, "grad_tol": GRAD_TOL, **remat_rows,
          "seconds": time.time() - t_rm})

    # 10. train_fused: the same step through the fused blocks (K5's forward,
    # the hybrid backward through K3), from the same weights, batches and draws
    t_tf = time.time()
    fmodel = create_network(config.model, dtype=bf, use_flash=config.model.use_flash_attention,
                            device=dev)
    fmodel.load_state_dict(reference_state_dict(torch.load(ckpt_path, map_location="cpu",
                                                           weights_only=False)))
    fmodel.train()
    loader = DataLoader(dataset, train_batch, shuffle=True, drop_last=True, seed=tc.seed)
    loader.set_epoch(0)
    fstate = create_train_state(fmodel)
    fstep = make_train_step(
        fmodel, make_optimizer(tc, tc.steps_per_epoch or max(len(loader), 1)),
        model_apply=dit_fused_model_apply(fmodel), ema_decay=tc.ema_decay, use_ema=tc.use_ema,
        encode_fn=vae.encode_sample, scale_factor=config.scale_factor, seed=tc.seed + 1)
    batches = iter(loader)

    def fused_step():
        return fstep(fstate, {"x": torch.from_numpy(next(batches)["x"]).to(dev)})

    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    floss1 = float(fused_step()[0])
    i = fstate.names.index(probe)
    p1, ema1 = fstate.params[i].detach(), fstate.ema[i].detach()
    fema_err = float((ema1 - (decay * p0 + (1 - decay) * p1)).abs().max())
    fmoved = float((p1 - p0).abs().max())
    torch.cuda.synchronize()
    t0 = time.time()
    for _ in range(TRAIN_STEPS):
        floss = fused_step()[0]
    torch.cuda.synchronize()
    fsec_per_step = (time.time() - t0) / TRAIN_STEPS
    tf_counts = counts()
    fpeak = torch.cuda.max_memory_allocated() / 2 ** 30
    fsteps = fstate.step
    ffinite = all(bool(torch.isfinite(p).all()) for p in fstate.params)
    floss_err = abs(floss1 - loss1) / abs(loss1)
    emit({"phase": "train_fused", "preset": "celeb256_dit", "model": config.model.model_type,
          "batch": train_batch, "steps": fsteps, "seconds_per_step": fsec_per_step,
          "images_per_s": train_batch / fsec_per_step, "peak_gib": fpeak,
          "loss_step1": floss1, "module_loss_step1": loss1, "loss_rel_err": floss_err,
          "loss_tol": FUSED_LOSS_TOL, "loss_last": float(floss), "launches": tf_counts,
          "ema_max_abs_err": fema_err, "param_max_change_step1": fmoved,
          "params_finite": ffinite, "seconds": time.time() - t_tf})
    if not (math.isfinite(floss1) and ffinite):
        raise AssertionError(f"train_fused: step 1's loss {floss1} or the parameters are not "
                             "finite")
    if not floss_err <= FUSED_LOSS_TOL:
        raise AssertionError(f"train_fused: step 1's loss {floss1} is {floss_err} off the module "
                             f"path's {loss1} > {FUSED_LOSS_TOL}")
    if not (fmoved > 0 and fema_err <= 1e-6 * float(p0.abs().max())):
        raise AssertionError(f"train_fused: parameters moved {fmoved}; EMA off by {fema_err}")
    want_counts = {"dit_block_train_fwd": tdepth * fsteps, "attention_small_bwd": tdepth * fsteps}
    if fsteps != 1 + TRAIN_STEPS or {k: v for k, v in tf_counts.items() if v} != want_counts:
        raise AssertionError(f"train_fused: {fsteps} steps, launches {tf_counts}, expected "
                             f"{want_counts}")
    del fstate, fstep, fmodel, p1, ema1
    torch.cuda.empty_cache()

    # 10b. train_f32: the same train(...) in f32, every attention through f32
    # K1 and K3; step 1's loss against the same model with plain attention
    t_f32 = time.time()
    f32_config = dataclasses.replace(tconfig, train=dataclasses.replace(tc, precision="f32"))
    reset_counts()
    f32_run = bench_train.timed_train(f32_config, dataset, vae, dev, TRAIN_F32_STEPS)
    f32_counts = counts()
    f32_dtypes = {name: dict(c.by_dtype) for name, c in counters.items() if c.by_dtype}
    f32_state = f32_run.pop("state")
    f32_finite = all(bool(torch.isfinite(p).all()) for p in f32_state.params)
    f32_param_dtypes = sorted({str(p.dtype) for p in f32_state.params})
    f32_steps = f32_state.step
    del f32_state
    torch.cuda.empty_cache()
    pmodel = create_network(config.model, dtype=f32, use_flash=False,
                            remat=tc.use_grad_checkpointing, remat_policy=tc.remat_policy,
                            device=dev)
    p_weights = reference_state_dict(torch.load(ckpt_path, map_location="cpu",
                                                weights_only=False))
    pmodel.load_state_dict(p_weights)
    pmodel.train()
    ploader = DataLoader(dataset, train_batch, shuffle=True, drop_last=True, seed=tc.seed)
    ploader.set_epoch(0)
    pbatch = {"x": torch.from_numpy(next(iter(ploader))["x"]).to(dev)}
    pstep = make_train_step(
        pmodel, make_optimizer(tc, tc.steps_per_epoch or max(len(ploader), 1)),
        ema_decay=tc.ema_decay, use_ema=tc.use_ema, encode_fn=vae.encode_sample,
        scale_factor=config.scale_factor, label_dropout=config.model.label_dropout > 0,
        seed=tc.seed + 1)
    reset_counts()
    ploss1 = float(pstep(create_train_state(pmodel), pbatch)[0])
    plain_counts = counts()

    # the same plain step from the same weights with attention's products in
    # TF32 (the rest in f32): how far an attention error of TF32's size moves
    # step 1's loss, against which F32_LOSS_TOL is set
    def tf32_attention(*qkv):
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            return reference_attention(*qkv)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev

    pmodel.load_state_dict(p_weights)
    nn_layers.reference_attention = tf32_attention
    try:
        tf32_loss1 = float(pstep(create_train_state(pmodel), pbatch)[0])
    finally:
        nn_layers.reference_attention = reference_attention
    del pmodel, pstep, p_weights, pbatch
    torch.cuda.empty_cache()
    f32_loss_err = abs(f32_run["loss_step1"] - ploss1) / abs(ploss1)
    tf32_loss_err = abs(tf32_loss1 - ploss1) / abs(ploss1)
    emit({"phase": "train_f32", "preset": "celeb256_dit", "model": config.model.model_type,
          "batch": train_batch, "precision": "f32", "steps": f32_steps,
          **{k: f32_run[k] for k in ("seconds_per_step", "images_per_s", "peak_gib",
                                     "loss_step1")},
          "plain_attention_loss_step1": ploss1, "loss_rel_err": f32_loss_err,
          "loss_tol": F32_LOSS_TOL, "tf32_attention_loss_step1": tf32_loss1,
          "tf32_attention_loss_rel_err": tf32_loss_err, "launches": f32_counts, "launches_by_dtype": f32_dtypes,
          "param_dtypes": f32_param_dtypes, "params_finite": f32_finite,
          "card": torch.cuda.get_device_name(0), "seconds": time.time() - t_f32})
    if not (math.isfinite(f32_run["loss_step1"]) and f32_finite
            and f32_param_dtypes == [str(f32)]):
        raise AssertionError(f"train_f32: step 1's loss {f32_run['loss_step1']}, parameters "
                             f"finite {f32_finite}, dtypes {f32_param_dtypes}")
    if not f32_loss_err <= F32_LOSS_TOL:
        raise AssertionError(f"train_f32: step 1's loss {f32_run['loss_step1']} is "
                             f"{f32_loss_err} off plain attention's {ploss1} > {F32_LOSS_TOL}")
    if not tf32_loss_err > F32_LOSS_TOL:
        raise AssertionError(f"train_f32: attention in TF32 moves step 1's loss by only "
                             f"{tf32_loss_err} <= {F32_LOSS_TOL}: the loss check cannot tell it "
                             "from f32")
    want_counts = {"attention_small": 2 * tdepth * f32_steps,
                   "attention_small_bwd": tdepth * f32_steps}
    want_dtypes = {k: {"float32": v} for k, v in want_counts.items()}
    if (f32_steps != 1 + TRAIN_F32_STEPS
            or {k: v for k, v in f32_counts.items() if v} != want_counts
            or f32_dtypes != want_dtypes or any(plain_counts.values())):
        raise AssertionError(f"train_f32: {f32_steps} steps, launches {f32_counts} by dtype "
                             f"{f32_dtypes}, expected {want_dtypes}; plain step {plain_counts}")

    # 10c. adm_train: celeb256_adm trained through the CLI from an NVAE LMDB
    # written here; its f32 gradients with and without the kernels;
    # celeb512_adm (K3 at D = 256) and imnet_adm (EDM, labels) through train(...)
    t_at = time.time()
    del f32_run
    torch.cuda.empty_cache()
    from lfm_tpu_torch.cli import main as cli_module
    from lfm_tpu_torch.data import minilmdb
    from lfm_tpu_torch.kernels import flash_attention as fa_module
    from lfm_tpu_torch.train import loop as loop_module
    from lfm_tpu_torch.train.train import fm_train_loss

    def timed_steps(run, module=loop_module, factory="make_train_step", watch=None):
        """Run ``run()`` with each train step that ``module.factory`` makes
        (``train/loop.py``'s by default) timed alone (synchronised before
        and after), its loss read and the launch counts reset just before it
        and read just after; ``watch(state, phase)`` is called with "before"
        and "after" around the first step. Returns (what run returned,
        [{"seconds", "loss", "launches"}, ...], the launches of the whole
        run, its peak GiB)."""
        steps = []
        real = getattr(module, factory)

        def make(*args, **kwargs):
            step = real(*args, **kwargs)

            def timed(state, b):
                before = counts()
                reset_counts()
                if watch is not None and not steps:
                    watch(state, "before")
                torch.cuda.synchronize()
                t_step = time.time()
                loss, gnorm = step(state, b)
                loss = float(loss)
                steps.append({"seconds": time.time() - t_step, "loss": loss,
                              "launches": {k: v for k, v in counts().items() if v}})
                if watch is not None and len(steps) == 1:
                    watch(state, "after")
                for name, c in counters.items():  # the run's counts go on
                    c.count += before[name]
                return loss, gnorm

            return timed

        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        setattr(module, factory, make)
        try:
            out = run()
        finally:
            setattr(module, factory, real)
        torch.cuda.synchronize()
        return out, steps, counts(), torch.cuda.max_memory_allocated() / 2 ** 30

    def step_summary(steps):
        later = [st["seconds"] for st in steps[1:]] or [steps[0]["seconds"]]
        return {"seconds_per_step": sum(later) / len(later),
                "step_seconds": [st["seconds"] for st in steps],
                "losses": [st["loss"] for st in steps],
                "launches_per_step": [st["launches"] for st in steps]}

    acfg = get_preset("celeb256_adm")
    a_layers = list(plan_layers(create_network(acfg.model, dtype=bf, device="meta").plan))
    a_attn = sum(spec.kind == "attn" for spec in a_layers)
    db_root = os.path.join(work, "celeba")
    rec_rng = np.random.default_rng(SEED)
    minilmdb.write_db(os.path.join(db_root, "train.lmdb"), {
        str(i).encode(): rec_rng.integers(0, 256, (256, 256, 3), dtype=np.uint8).tobytes()
        for i in range(ADM_TRAIN_RECORDS)})
    cwd = os.getcwd()
    os.chdir(work)  # the run's experiment directory goes under work
    try:
        a_state, a_steps, at_counts, a_peak = timed_steps(lambda: cli_main(
            ["train", "--preset", "celeb256_adm", "--datadir", db_root,
             "--max_steps", str(ADM_TRAIN_STEPS)]))
    finally:
        os.chdir(cwd)
    a_batch = acfg.train.batch_size
    a_finite = all(bool(torch.isfinite(p).all()) for p in a_state.params)
    a_params = sum(p.numel() for p in a_state.params)
    emit({"phase": "adm_train", "preset": "celeb256_adm", "data": "NVAE LMDB (minilmdb)",
          "records": ADM_TRAIN_RECORDS, "batch": a_batch, "precision": acfg.train.precision,
          "steps": a_state.step, "params": a_params, "attention_layers": a_attn,
          **step_summary(a_steps), "images_per_s": a_batch / step_summary(a_steps)[
              "seconds_per_step"], "peak_gib": a_peak, "launches": at_counts,
          "params_finite": a_finite, "seconds": time.time() - t_at})
    want_step = {"attention_small": a_attn, "attention_small_bwd": a_attn}
    if not (a_state.step == ADM_TRAIN_STEPS == len(a_steps) and a_finite
            and all(math.isfinite(st["loss"]) for st in a_steps)):
        raise AssertionError(f"adm_train: {a_state.step} steps, losses "
                             f"{[st['loss'] for st in a_steps]}, parameters finite {a_finite}")
    if any(st["launches"] != want_step for st in a_steps):
        raise AssertionError(f"adm_train: launches per step "
                             f"{[st['launches'] for st in a_steps]}, expected {want_step}")
    # the whole run: the steps' K3, and K1 also in the demo plot's sampling
    # after epoch 0 (a multiple of the attention layers)
    demo_k1 = at_counts["attention_small"] - a_attn * ADM_TRAIN_STEPS
    if (at_counts["attention_small_bwd"] != a_attn * ADM_TRAIN_STEPS or demo_k1 < 0
            or demo_k1 % a_attn or sum(at_counts.values()) != at_counts["attention_small"]
            + at_counts["attention_small_bwd"]):
        raise AssertionError(f"adm_train: launches {at_counts} for {ADM_TRAIN_STEPS} steps of "
                             f"{a_attn} attention layers")
    del a_state
    torch.cuda.empty_cache()

    # the f32 gradient gate: one f32 step of the same model (seeded non-zero
    # weights: the preset's zero-initialised projections would give attention
    # no gradient) on the first batch of the LMDB, through K1 / K3 and through
    # their plain versions, twice (the second plain run gives the floor);
    # TF32 off and cuDNN's deterministic algorithms in all three, so that
    # the convolutions' backward sums alike in each
    t_gate = time.time()
    from lfm_tpu_torch.data.lmdb_datasets import LMDBDataset

    gate_ds = LMDBDataset(db_root, train=True, image_size=256, seed=SEED)
    gx = torch.from_numpy(np.stack([gate_ds[i][0] for i in range(a_batch)])).to(dev)
    gg = torch.Generator(device=dev)
    gg.manual_seed(SEED + 3)
    with torch.no_grad():
        gz0 = vae.encode_sample(gx, gg).float() * acfg.scale_factor
    gt = torch.rand(a_batch, generator=gg, device=dev)
    gz1 = torch.randn(gz0.shape, generator=gg, device=dev)
    del gx
    gate_grads, gate_counts = {}, {}

    def plain_k3(q, k, v, do):
        return torch.stack(reference_attention_bwd(q, k, v, do), dim=2)

    deterministic = torch.backends.cudnn.deterministic
    for variant in ("kernels", "plain", "plain_again"):
        gmodel = create_network(acfg.model, dtype=f32, use_flash=True, device=dev)
        seeded_init_(gmodel, SEED)
        real_fwd, real_bwd = fa_module._forward, fa_module._backward_packed
        if variant != "kernels":
            fa_module._forward, fa_module._backward_packed = reference_attention, plain_k3
        reset_counts()
        torch.backends.cudnn.deterministic = True
        try:
            with no_tf32():
                gloss = fm_train_loss(gmodel, gz0, None, gt, gz1)
                gloss.backward()
        finally:
            fa_module._forward, fa_module._backward_packed = real_fwd, real_bwd
            torch.backends.cudnn.deterministic = deterministic
        torch.cuda.synchronize()
        gate_counts[variant] = {k: v for k, v in counts().items() if v}
        gate_grads[variant] = {name: p.grad.detach().clone()
                               for name, p in gmodel.named_parameters()}
        gate_grads[variant + "_loss"] = float(gloss.detach())
        del gmodel, gloss
        torch.cuda.empty_cache()
    g_worst, g_floor = (max((rel_err(gate_grads[variant][name], want)[1], name)
                            for name, want in gate_grads["plain"].items())
                        for variant in ("kernels", "plain_again"))
    emit({"phase": "adm_train_f32_grad", "preset": "celeb256_adm", "batch": a_batch,
          "tensors": len(gate_grads["plain"]), "max_rel_err": g_worst[0], "tensor": g_worst[1],
          "tol": F32_GRAD_TOL, "plain_rerun_max_rel_err": g_floor[0],
          "loss": gate_grads["kernels_loss"],
          "plain_loss": gate_grads["plain_loss"], "launches": gate_counts,
          "seconds": time.time() - t_gate})
    if gate_counts != {"kernels": want_step, "plain": {}, "plain_again": {}}:
        raise AssertionError(f"adm_train f32 gradients: launches {gate_counts}, expected "
                             f"{want_step} with the kernels and none without")
    if not g_worst[0] <= F32_GRAD_TOL:
        raise AssertionError(f"adm_train f32 gradient of {g_worst[1]}: {g_worst[0]} > "
                             f"{F32_GRAD_TOL}")
    del gate_grads, gz0, gz1, gt, gate_ds
    torch.cuda.empty_cache()

    # celeb512_adm (K3 at (24, 64, 4, 128) and (24, 16, 4, 256)) and imnet_adm
    # (EDM with labels, no kernel) through train(...) on seeded images
    other_train = {}
    for preset, batch_n, steps_n, size, classes in (
            ("celeb512_adm", ADM512_TRAIN_BATCH, ADM512_TRAIN_STEPS, 512, 1),
            ("imnet_adm", EDM_TRAIN_BATCH, EDM_TRAIN_STEPS, 256, 1000)):
        t_ot = time.time()
        ocfg = get_preset(preset)
        ocfg = dataclasses.replace(ocfg, output_dir=work, train=dataclasses.replace(
            ocfg.train, batch_size=batch_n))
        ods = SyntheticImageDataset(n=batch_n * (steps_n + 1), image_size=size,
                                    num_classes=classes, seed=SEED)
        o_layers = ([] if not ocfg.model.use_origin_adm else list(plan_layers(
            create_network(ocfg.model, dtype=bf, device="meta").plan)))
        o_attn = sum(spec.kind == "attn" for spec in o_layers)
        o_state, o_steps, o_counts, o_peak = timed_steps(lambda: train(
            ocfg, dataset=ods, vae=vae, device=dev, max_steps=steps_n, log_fn=lambda line: None))
        o_finite = all(bool(torch.isfinite(p).all()) for p in o_state.params)
        summary = step_summary(o_steps)
        emit({"phase": "adm_train", "preset": preset, "data": f"synthetic {size}^2",
              "labels": classes > 1, "batch": batch_n, "precision": ocfg.train.precision,
              "steps": o_state.step, "params": sum(p.numel() for p in o_state.params),
              "attention_layers": o_attn, **summary,
              "images_per_s": batch_n / summary["seconds_per_step"], "peak_gib": o_peak,
              "launches": o_counts, "params_finite": o_finite, "seconds": time.time() - t_ot})
        want = ({"attention_small": o_attn, "attention_small_bwd": o_attn} if o_attn else {})
        if not (o_state.step == steps_n == len(o_steps) and o_finite
                and all(math.isfinite(st["loss"]) for st in o_steps)):
            raise AssertionError(f"{preset} train: {o_state.step} steps, losses "
                                 f"{summary['losses']}, parameters finite {o_finite}")
        if any(st["launches"] != want for st in o_steps):
            raise AssertionError(f"{preset} train: launches per step "
                                 f"{summary['launches_per_step']}, expected {want}")
        other_train[preset] = o_counts
        del o_state, ods
        torch.cuda.empty_cache()

    # 10d. the downstream tasks on celeb256_adm at full width: inpainting
    # (9 input channels) and semantic synthesis (8, with the SpatialRescaler)
    # trained through K1 / K3 and sampled through K1
    from lfm_tpu_torch.data.inpainting import InpaintingTrainDataset
    from lfm_tpu_torch.data.masks import get_mask_generator
    from lfm_tpu_torch.eval.inpainting_metrics import metrics_from_activations, pids_uids
    from lfm_tpu_torch.nn.encoders import SpatialRescaler
    from lfm_tpu_torch.sample.downstream import make_inpainting_sampler, make_semantic_sampler
    from lfm_tpu_torch.train import downstream_loops as ds_module
    from lfm_tpu_torch.train.conditional import (cond_fm_loss, cond_velocity,
                                                 inpainting_condition, semantic_condition)

    base_cfg = get_preset("celeb256_adm").replace(output_dir=work)
    d_batch = base_cfg.train.batch_size

    def task_config(in_ch):
        return base_cfg.replace(model=dataclasses.replace(base_cfg.model, num_in_channels=in_ch))

    class SeededInpainting(InpaintingTrainDataset):
        """InpaintingTrainDataset's items over seeded uint8 images (no files,
        no Pillow), with LaMa's mixed masks."""

        def __init__(self, n, seed):
            super().__init__(os.path.join(work, "no_files"), get_mask_generator(seed=seed),
                             image_size=256, seed=seed)
            self.images = np.random.default_rng(seed).integers(0, 256, (n, 256, 256, 3),
                                                               dtype=np.uint8)

        def __len__(self):
            return len(self.images)

        def _image(self, i):
            return self.images[i]

    class SeededSegmentation:
        """(image in [-1, 1], label map) items: seeded uint8 images and maps
        of SEG_CLASSES classes in 16 x 16 cells."""

        num_classes = SEG_CLASSES

        def __init__(self, n, seed):
            rng = np.random.default_rng(seed)
            self.images = rng.integers(0, 256, (n, 256, 256, 3), dtype=np.uint8)
            cells = rng.integers(0, SEG_CLASSES, (n, 16, 16))
            self.segs = np.repeat(np.repeat(cells, 16, 1), 16, 2).astype(np.int32)

        def __len__(self):
            return len(self.images)

        def __getitem__(self, i):
            return self.images[i].astype(np.float32) / 127.5 - 1.0, self.segs[i]

    def first_step_watch(record, decay):
        """Around step 1: the EMA against decay p0 + (1 - decay) p1, and
        which of the rescaler's tensors moved."""

        def watch(state, when):
            if when == "before":
                record["p0"] = [p.detach().clone() for p in state.params]
                return
            p0 = record.pop("p0")
            with torch.no_grad():
                want = torch._foreach_add(torch._foreach_mul(p0, decay), state.params,
                                          alpha=1 - decay)
                record["ema_err"] = max(float((e - w).abs().max())
                                        for e, w in zip(state.ema, want))
                record["ema_moved"] = sum(not torch.equal(e, q) for e, q in zip(state.ema, p0))
                record["cond_moved"] = {n: not torch.equal(p, q) for n, p, q in
                                        zip(state.names, state.params, p0)
                                        if n.startswith("cond.")}
            record["tensors"] = len(p0)
            record["cond0"] = {n: q for n, q in zip(state.names, p0) if n.startswith("cond.")}

        return watch

    def grad_gate(cfg, cond_fn, make_rescaler, batch, n_eps):
        """One step's loss (cond_fm_loss) and gradients in f32 through K1 /
        K3 and with use_flash=False, the same weights, batch and draws, TF32
        off and cuDNN deterministic: (worst relative error, its tensor,
        tensors, launches of each, losses)."""
        gg = torch.Generator(device=dev)
        gg.manual_seed(SEED + 5)
        lat = (len(batch["x"]), 32, 32, 4)
        eps = [torch.randn(lat, generator=gg, device=dev) for _ in range(n_eps)]
        gt = torch.rand(lat[0], generator=gg, device=dev)
        gz1 = torch.randn(lat, generator=gg, device=dev)
        grads, launches, losses, weights = {}, {}, {}, None
        deterministic = torch.backends.cudnn.deterministic
        for use_flash in (True, False):
            gm = create_network(cfg.model, dtype=f32, use_flash=use_flash, device=dev)
            if weights is None:
                weights = seeded_init_(gm, SEED).state_dict()
            else:
                gm.load_state_dict(weights)
            rescaler = make_rescaler()
            reset_counts()
            torch.backends.cudnn.deterministic = True
            try:
                with no_tf32():
                    loss = cond_fm_loss(gm, cond_fn, rescaler, batch, gt, gz1, eps=eps)
                    loss.backward()
            finally:
                torch.backends.cudnn.deterministic = deterministic
            torch.cuda.synchronize()
            launches[use_flash] = {k: v for k, v in counts().items() if v}
            losses[use_flash] = float(loss.detach())
            named = list(gm.named_parameters()) + (
                [] if rescaler is None else [("cond." + n, p)
                                             for n, p in rescaler.named_parameters()])
            grads[use_flash] = {n: p.grad.detach().clone() for n, p in named}
            del gm, rescaler, loss
            torch.cuda.empty_cache()
        # a tensor's largest gradient is floored at GRAD_FLOOR of the step's
        # largest: a convolution's bias ahead of a GroupNorm with one channel
        # a group has a gradient that is zero but for rounding
        floor = GRAD_FLOOR * max(float(g.abs().max()) for g in grads[False].values())
        worst = max((float((grads[True][n] - want).abs().max())
                     / max(float(want.abs().max()), floor), n)
                    for n, want in grads[False].items())
        cond_grad = max([float(g.abs().max()) for n, g in grads[True].items()
                         if n.startswith("cond.")], default=None)
        return worst, len(grads[False]), launches, losses, cond_grad

    # inpaint_train and semantic_train: train_inpainting / train_semantic
    # for 1 + 4 steps at the preset's batch (one epoch: the run returns
    # before the demo panel), each step timed and counted alone
    d_attn = a_attn  # the 9- and 8-channel ADMs attend as celeb256_adm
    want_step = {"attention_small": d_attn, "attention_small_bwd": d_attn}
    d_counts, d_lines = {}, {}
    for task in ("inpaint", "semantic"):
        t_task = time.time()
        in_ch = 9 if task == "inpaint" else 8
        tcfg = task_config(in_ch)
        n_items = d_batch * DS_TRAIN_STEPS
        dataset = (SeededInpainting(n_items, SEED) if task == "inpaint"
                   else SeededSegmentation(n_items, SEED))
        watched = {}
        watch = first_step_watch(watched, tcfg.train.ema_decay)
        if task == "inpaint":
            def run_task():
                return ds_module.train_inpainting(tcfg, dataset, vae, device=dev,
                                                  max_steps=DS_TRAIN_STEPS,
                                                  log_fn=lambda line: None)
        else:
            def run_task():
                return ds_module.train_semantic(
                    tcfg, dataset, vae, SpatialRescaler(3, multiplier=0.5,
                                                        in_channels=SEG_CLASSES, out_channels=4),
                    num_classes=SEG_CLASSES, device=dev, max_steps=DS_TRAIN_STEPS,
                    log_fn=lambda line: None)
        d_state, d_steps, d_run_counts, d_peak = timed_steps(
            run_task, module=ds_module, factory="make_cond_train_step", watch=watch)
        summary = step_summary(d_steps)
        finite = all(bool(torch.isfinite(p).all()) for p in d_state.params + d_state.ema)
        # the rescaler over the run: the network's output conv starts at zero
        # (JAX's init), so no gradient reaches the condition before step 2
        cond_moved = {n: not torch.equal(p, watched["cond0"][n])
                      for n, p in zip(d_state.names, d_state.params) if n in watched["cond0"]}
        n_params = sum(p.numel() for p in d_state.params)
        del d_state
        torch.cuda.empty_cache()
        # the gradient gate on the first batch, in f32
        t_gate = time.time()
        items = [dataset[i] for i in range(d_batch)]
        if task == "inpaint":
            gbatch = {k: torch.from_numpy(np.stack([it[j] for it in items])).to(dev)
                      for j, k in enumerate(("x", "mask", "masked"))}
            gcond, n_eps, make_r = inpainting_condition(vae, tcfg.scale_factor), 2, lambda: None
        else:
            gbatch = {k: torch.from_numpy(np.stack([it[j] for it in items])).to(dev)
                      for j, k in enumerate(("x", "seg"))}

            def make_r():
                r = SpatialRescaler(3, multiplier=0.5, in_channels=SEG_CLASSES,
                                    out_channels=4).to(dev)
                r.reset_parameters(torch.Generator(device=dev).manual_seed(SEED + 6))
                return r

            gcond, n_eps = semantic_condition(vae, tcfg.scale_factor, SEG_CLASSES), 1
        g_worst, g_tensors, g_launches, g_losses, g_cond = grad_gate(tcfg, gcond, make_r, gbatch,
                                                                     n_eps)
        del gbatch, items, dataset
        torch.cuda.empty_cache()
        line = {"phase": f"{task}_train", "preset": "celeb256_adm", "in_channels": in_ch,
                "batch": d_batch, "precision": tcfg.train.precision, "steps": len(d_steps),
                "params": n_params, "attention_layers": d_attn, **summary,
                "images_per_s": d_batch / summary["seconds_per_step"], "peak_gib": d_peak,
                "launches": d_run_counts, "finite": finite,
                "ema_max_abs_err_step1": watched["ema_err"],
                "ema_tensors_moved_step1": watched["ema_moved"], "tensors": watched["tensors"],
                "cond_moved_step1": watched["cond_moved"], "cond_moved_in_run": cond_moved,
                "f32_cond_grad_max": g_cond, "f32_grad_floor": GRAD_FLOOR,
                "f32_grad_max_rel_err": g_worst[0], "f32_grad_tensor": g_worst[1],
                "f32_grad_tensors": g_tensors, "f32_grad_tol": F32_GRAD_TOL,
                "f32_grad_launches": {str(k): v for k, v in g_launches.items()},
                "f32_losses": {str(k): v for k, v in g_losses.items()},
                "gate_seconds": time.time() - t_gate, "seconds": time.time() - t_task}
        emit(line)
        d_lines[task], d_counts[f"{task}_train"] = line, d_run_counts
        if not (len(d_steps) == DS_TRAIN_STEPS and finite
                and all(math.isfinite(st["loss"]) for st in d_steps)):
            raise AssertionError(f"{task}_train: {len(d_steps)} steps, losses "
                                 f"{summary['losses']}, finite {finite}")
        if any(st["launches"] != want_step for st in d_steps) or d_run_counts != {
                **{k: 0 for k in counters}, "attention_small": d_attn * DS_TRAIN_STEPS,
                "attention_small_bwd": d_attn * DS_TRAIN_STEPS}:
            raise AssertionError(f"{task}_train: launches per step "
                                 f"{summary['launches_per_step']}, run {d_run_counts}, "
                                 f"expected {want_step} a step")
        if not (watched["ema_err"] <= 1e-6 and watched["ema_moved"] > 0):
            raise AssertionError(f"{task}_train: the EMA after step 1 is "
                                 f"{watched['ema_err']} off decay p0 + (1 - decay) p1, "
                                 f"{watched['ema_moved']} tensors moved")
        if task == "semantic" and not (cond_moved and all(cond_moved.values()) and g_cond):
            raise AssertionError(f"semantic_train: the rescaler moved {cond_moved}, its f32 "
                                 f"gradient {g_cond}")
        if g_launches != {True: want_step, False: {}} or not g_worst[0] <= F32_GRAD_TOL:
            raise AssertionError(f"{task}_train f32 gradients: {g_worst} (tol {F32_GRAD_TOL}), "
                                 f"launches {g_launches}")

    # inpaint_sample: make_inpainting_sampler at batch INPAINT_BATCH with the
    # preset's method, then the Inception activations and FID / P-IDS / U-IDS
    t_is = time.time()
    icfg = task_config(9)
    icfg = icfg.replace(sample=dataclasses.replace(icfg.sample, batch_size=INPAINT_BATCH))
    i_models = {}
    for use_flash in (True, False):
        i_models[use_flash] = create_network(icfg.model, dtype=bf, use_flash=use_flash,
                                             device=dev)
    seeded_init_(i_models[True], SEED)
    i_models[False].load_state_dict(i_models[True].state_dict())
    irng = np.random.default_rng(SEED + 7)
    i_img = irng.integers(0, 256, (INPAINT_BATCH, 256, 256, 3)).astype(np.float32) / 127.5 - 1
    mgen = get_mask_generator(seed=SEED)
    i_mask = np.stack([mgen((256, 256)) for _ in range(INPAINT_BATCH)])[..., None]
    i_sampler = make_inpainting_sampler(icfg, i_models[True], None, vae, None, device=dev)
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.time()
    i_out = i_sampler(i_img, i_mask, i_img * (1 - i_mask), range(INPAINT_BATCH))
    torch.cuda.synchronize()
    i_secs = time.time() - t0
    is_counts = counts()
    i_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    img01 = (torch.from_numpy(i_img).to(dev) + 1) / 2
    keep = (torch.from_numpy(i_mask).to(dev) == 0).expand_as(img01)
    composite_exact = torch.equal(i_out.images[keep], img01[keep])
    # the velocity through K1 against plain attention, on the run's condition
    with torch.no_grad():
        ib = {"x": torch.from_numpy(i_img).to(dev), "mask": torch.from_numpy(i_mask).to(dev),
              "masked": torch.from_numpy(i_img * (1 - i_mask)).to(dev)}
        _, ic = inpainting_condition(vae, icfg.scale_factor)(
            None, ib, generator=torch.Generator(device=dev).manual_seed(SEED))
        ix = torch.randn(ic.shape[:3] + (4,), generator=torch.Generator(device=dev).manual_seed(
            SEED + 1), device=dev)
        v_k1, v_plain = (cond_velocity(i_models[k], ic)(torch.tensor(0.5, device=dev), ix)
                         for k in (True, False))
    i_vel_err = float((v_k1 - v_plain).abs().max()) / float(v_plain.abs().max())
    extractor = ActivationExtractor(seeded_inception_state_dict(SEED), device=dev)
    fake_acts, real_acts = extractor(i_out.images), extractor(img01)
    t_m = time.time()
    i_fid, i_pids, i_uids = metrics_from_activations(fake_acts, real_acts)
    metrics_s = time.time() - t_m
    t_m = time.time()
    pids_uids(fake_acts, real_acts)
    svm_s = time.time() - t_m
    emit({"phase": "inpaint_sample", "preset": "celeb256_adm", "in_channels": 9,
          "batch": INPAINT_BATCH, "method": icfg.sample.method, "atol": icfg.sample.atol,
          "rtol": icfg.sample.rtol, "nfe": i_out.nfe, "seconds": i_secs,
          "images": list(i_out.images.shape), "hole_share": float(i_mask.mean()),
          "composite_equals_input_outside_hole": composite_exact, "launches": is_counts,
          "peak_gib": i_peak, "velocity_rel_err_vs_plain": i_vel_err, "velocity_tol": VEL_TOL,
          "fid": i_fid, "pids": i_pids, "uids": i_uids, "metrics_host_seconds": metrics_s,
          "svm_host_seconds": svm_s, "inception": "seeded weights (protocol only)",
          "phase_seconds": time.time() - t_is})
    if not (composite_exact and bool(torch.isfinite(i_out.images).all())
            and tuple(i_out.images.shape) == (INPAINT_BATCH, 256, 256, 3)):
        raise AssertionError(f"inpaint_sample: composite equals the input outside the hole: "
                             f"{composite_exact}, shape {tuple(i_out.images.shape)}")
    if (is_counts["attention_small"] != d_attn * i_out.nfe
            or sum(is_counts.values()) != is_counts["attention_small"]):
        raise AssertionError(f"inpaint_sample: {is_counts} launches for NFE {i_out.nfe} x "
                             f"{d_attn} attention layers")
    if not i_vel_err <= VEL_TOL:
        raise AssertionError(f"inpaint_sample velocity through K1 vs plain: {i_vel_err} > "
                             f"{VEL_TOL}")
    if not all(math.isfinite(v) for v in (i_fid, i_pids, i_uids)):
        raise AssertionError(f"inpaint_sample metrics: {(i_fid, i_pids, i_uids)}")
    del i_models, i_sampler, i_out, img01, keep, ib, ic, ix, v_k1, v_plain, extractor
    torch.cuda.empty_cache()

    # semantic_sample: make_semantic_sampler at batch SEMANTIC_BATCH, euler
    # at the preset's num_steps
    t_ss = time.time()
    scfg = task_config(8)
    scfg = scfg.replace(sample=dataclasses.replace(scfg.sample, method="euler",
                                                   batch_size=SEMANTIC_BATCH))
    s_model = seeded_init_(create_network(scfg.model, dtype=bf, use_flash=True, device=dev), SEED)
    s_rescaler = SpatialRescaler(3, multiplier=0.5, in_channels=SEG_CLASSES, out_channels=4)
    s_rescaler.to(dev).reset_parameters(torch.Generator(device=dev).manual_seed(SEED))
    s_seg = SeededSegmentation(SEMANTIC_BATCH, SEED + 8).segs
    s_sampler = make_semantic_sampler(scfg, s_model, None, s_rescaler, None, vae, None,
                                      SEG_CLASSES, device=dev)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    s_out = s_sampler(s_seg, range(SEMANTIC_BATCH))
    torch.cuda.synchronize()
    s_secs = time.time() - t0
    ss_counts = counts()
    s_img = s_out.images
    emit({"phase": "semantic_sample", "preset": "celeb256_adm", "in_channels": 8,
          "classes": SEG_CLASSES, "batch": SEMANTIC_BATCH, "method": "euler",
          "nfe": s_out.nfe, "seconds": s_secs, "images": list(s_img.shape),
          "launches": ss_counts, "image_mean": float(s_img.mean()),
          "phase_seconds": time.time() - t_ss})
    if not (tuple(s_img.shape) == (SEMANTIC_BATCH, 256, 256, 3)
            and bool(torch.isfinite(s_img).all()) and float(s_img.min()) >= 0
            and float(s_img.max()) <= 1):
        raise AssertionError(f"semantic_sample: images {tuple(s_img.shape)} not finite in [0, 1]")
    if (ss_counts["attention_small"] != d_attn * s_out.nfe
            or sum(ss_counts.values()) != ss_counts["attention_small"]):
        raise AssertionError(f"semantic_sample: {ss_counts} launches for NFE {s_out.nfe} x "
                             f"{d_attn} attention layers")
    del s_model, s_rescaler, s_sampler, s_out, s_img
    torch.cuda.empty_cache()

    # 10e. the other networks: SongUNet, the context DhariwalUNet, the
    # layout UNet with its token encoder, the model zoo's variants; no
    # hand-written kernel on any of them
    nets = other_networks(torch, work, dev, vae, counts, reset_counts, cli_main)

    # 10f. the ranks: NCCL over every card, then two ranks sharing cuda:0
    # over gloo
    per_step = {"bf16": {k: v // TRAIN_STEPS for k, v in train_counts.items() if v},
                "f32": {k: v // (1 + TRAIN_F32_STEPS) for k, v in f32_counts.items() if v}}
    dist_counts = dist_phases(torch, work, dev, config, tconfig, f32_config, train_dataset, vae,
                              ckpt_path, probe, loss1, train_p1, depth, per_step, counters,
                              counts, reset_counts)

    # 11. the kernels line, the card, the last line
    by_path = {"main_fused": fused_counts, "main_module": module_counts,
               "int8_main": int8_counts, "p1_probe": probe_counts, "adm_main": adm_counts,
               "cli_eval": cli_all, "cli_eval_batch1": cli_batch1, "adm_fused_gn": fgn_counts,
               "adm512_attn": a5_counts, "edm_cfg": edm_counts, "long_t": long_counts,
               "long_f32": lf_counts, "karras": karras_counts["heun"],
               "karras_euler": karras_counts["euler"], "karras_f32": kf32_counts,
               **{f"adaptive_{m}": c for m, c in adaptive_counts.items()},
               "train": train_counts,
               **{f"train_remat_{m}": c for m, c in remat_counts.items()},
               "train_fused": tf_counts, "train_f32": f32_counts, "adm_train": at_counts,
               "adm512_train": other_train["celeb512_adm"],
               "edm_train": other_train["imnet_adm"], **d_counts,
               "inpaint_sample": is_counts, "semantic_sample": ss_counts, **nets,
               **dist_counts, **block_counts}
    kdir, p1 = "lfm_tpu/kernels/", "tools/microbench_int8_pallas.py"
    # name, source (the C entry's or kernel's file first, then the files
    # of the kernels it launches), TPU kernel, the path whose count is
    # "launches", the row; the f32 K1 and K3 entries count under
    # attention_small(_bwd)
    kernels = (
        ("attention_small", "attention_sm90.cuh", kdir + "flash_attention.py:163", "train",
         k1_rows[(train_batch, 256, 16, 64, bf)]),
        ("attention_small_f32", "attention_wide.cu", kdir + "flash_attention.py:163", "adm_main",
         k1_rows[(batch, 16, 4, 128, f32)]),
        ("attention_small_f32_dit", "attention_row_f32.cuh", kdir + "flash_attention.py:163",
         "train_f32", k1_rows[(train_batch, 256, 16, 64, f32)]),
        ("attention_small_f32_long", ("attention_long_f32.cuh", "attention_long_f32.cu",
                                      "flash_attention_f32.cu"),
         kdir + "flash_attention.py:163", "long_f32", k1_rows[(2, 1024, 16, 64, f32)]),
        ("attention_small_f32_wide", ("attention_wide.cu", "attention_long_f32.cuh",
                                      "flash_attention_f32.cu"),
         kdir + "flash_attention.py:163", "adm512_attn", k1_rows[(16, 1024, 4, 128, f32)]),
        ("attention_small_bwd_f32", "attention_row_f32.cuh", kdir + "flash_attention.py:233",
         "train_f32", k3_rows[(train_batch, 256, 64, f32)]),
        ("attention_small_bwd_f32_wide", "attention_bwd_wide_f32.cu",
         kdir + "flash_attention.py:233", "adm_train", k3_rows[(a_batch, 16, 128, f32)]),
        ("fused_dit_block", "dit_block.cu", kdir + "dit_block.py:135", "main_fused",
         k2_rows[batch]),
        ("fused_dit_block_n1", "dit_block.cu", kdir + "dit_block.py:135", "cli_eval_batch1",
         k2_rows[1]),
        ("attention_small_bwd", "attention_bwd_sm90.cuh", kdir + "flash_attention.py:233", "train",
         k3_rows[(train_batch, 256, 64, bf)]),
        ("flash_attention", "attention_sm90.cuh", kdir + "flash_attention.py:74", "long_t",
         k4_rows[(2, 4096, 16, 64, bf)]),
        ("groupnorm_silu", "groupnorm_silu.cu", kdir + "groupnorm_silu.py:68", "adm_fused_gn",
         k6_rows[(batch, 32, 32, 256, bf, 0.0)]),
        ("dit_block_train_fwd", "dit_block_train.cu", kdir + "dit_block_train.py:357",
         "train_fused", k5_rows[("fwd", "full", train_batch)]),
        ("dit_block_train_mlp_bwd", ("dit_block_train.cu", "gemm_sm90.cuh", "gemm_sm90_bwd.cu"),
         kdir + "dit_block_train.py:398", "block_pallas_bwd", k5_rows[("mlp", train_batch)]),
        ("dit_block_train_attn_bwd", ("dit_block_train.cu", "gemm_sm90.cuh", "gemm_sm90_bwd.cu",
                                      "attention_bwd_sm90.cuh"),
         kdir + "dit_block_train.py:429", "block_pallas_bwd", k5_rows[("attn", train_batch)]),
        ("quant_rows", "int8_gemm.cu", p1 + ":92", "int8_main", p1_rows["quant_rows"]),
        ("int8_dense", "int8_gemm_sm90.cuh", p1 + ":92", "int8_main", p1_rows["fc2"]),
        ("int8_mlp", "int8_gemm_sm90.cuh", p1 + ":92", "p1_probe", p1_rows["int8_mlp"]),
        ("bf16_mlp", "int8_gemm.cu", p1 + ":103", "p1_probe", p1_rows["bf16_mlp"]),
    )
    def counter(name):
        return re.sub(r"(_f32(_dit|_long|_wide)?|_n1)$", "", name)

    def sources(src):
        return [csrc + f for f in ((src,) if isinstance(src, str) else src)]

    emit({"kernels": [
        {"name": name, "route": "cuda", "source": sources(src)[0], "sources": sources(src),
         "replaces": tpu, "launches": by_path[path][counter(name)],
         "launches_by_path": {p: c[counter(name)] for p, c in by_path.items()},
         **{key: row[key] for key in ("shape", "max_abs_err", "ms", "plain_ms", "bound_ms",
                                      "bound_by", "library_ms")}}
        for name, src, tpu, path, row in kernels
    ], "seconds_total": time.time() - t_all})
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def card_line() -> str:
    """nvidia-smi's name and power limit of the card."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return smi.stdout.strip().splitlines()[0]


DIST_FID_SAMPLES, DIST_FID_STEPS = 64, 4  # the ranks' sharded FID: samples, euler steps
DIST_F32_STEPS = 3  # dist_shared's data-parallel f32 steps
DIST_PART_BATCH = 16  # the partition steps' batch of latents
DIST_SHARED_RANKS = 2
DIST_PREEMPT_MODEL = "DiT-S/2"  # the preemption check's network: a small content.pth
DIST_TIMEOUT_S = 300  # a phase's ranks must end within this
# the ranks' sharded-FID activations against one process: as FID_ACT_TOL
DIST_ACT_TOL = FID_ACT_TOL
# the f32 steps (through an f32 VAE) against one process: each step's loss
# relative, step 1's gradients max abs error / max |one process| per tensor,
# and the parameters absolute (tests/test_partition.py's bound), except
# where Adam turns rounding noise into a step: elements whose gradient falls
# below DIST_NOISE_GRAD (100 x Adam's eps; the qkv bias's key third has a
# zero gradient in exact arithmetic) move up to about lr a step on each side
# and are held within that. Set above the readings on NVIDIA H100 80GB HBM3
# at 700 W: loss 1.2e-7, gradients 2.0e-6, parameters 6.0e-7 (the partition
# steps: 0 and 1.5e-8)
DIST_F32_LOSS_TOL, DIST_GRAD_TOL, DIST_PARAM_TOL, DIST_NOISE_GRAD = 1e-6, 2e-5, 2e-5, 1e-6
# dist_world's bf16 step against the train phase's step 1: one rank on one
# card is the same arithmetic (0 on NVIDIA H100 80GB HBM3); over several
# cards, the loss within the fused path's bound and the probe within one
# Adam step of lr either way
DIST_BF16_LOSS_TOL = FUSED_LOSS_TOL


def dist_compare_names(names, depth):
    """The parameters a rank sends back: all but the blocks', and the first
    and last block's."""
    keep = ("blocks.0.", f"blocks.{depth - 1}.")
    return [n for n in names if not n.startswith("blocks.") or n.startswith(keep)]


def dist_rank(rank, world, backend, store, task_path):
    """One rank of a dist phase (spawned): join, run the task's jobs with
    the counts reset before each and read after, write the results."""
    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from lfm_tpu_torch.core import multihost
    from lfm_tpu_torch.kernels import _build

    task = torch.load(task_path, weights_only=False)
    if not _build.library_path().is_file():
        raise RuntimeError("the kernels were not built before the ranks started")
    _build.load_library()
    dev = torch.device("cuda", rank if backend == "nccl" else 0)
    if backend == "nccl":
        # torchrun's environment, as a launcher sets it: a world of one
        # joins through it too (an explicit num_processes=1 joins nothing)
        os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                          MASTER_ADDR="127.0.0.1", MASTER_PORT=str(task["port"]))
        multihost.initialize()
    else:
        multihost.initialize(f"file://{store}", world, rank, backend=backend, device=dev)
    import torch.distributed as dist

    out = {"joined": (dist.get_backend(), dist.get_world_size(), str(torch.cuda.current_device()))}
    for job in task["jobs"]:
        t0 = time.time()
        out[job] = DIST_JOBS[job](torch, dev, task, rank)
        torch.cuda.synchronize(dev)
        out[job]["seconds"] = time.time() - t0
        torch.cuda.empty_cache()
    multihost.sync_hosts()
    torch.save(out, os.path.join(task["out"], f"rank{rank}.pt"))
    multihost.shutdown()


def _dist_counters():
    from lfm_tpu_torch.kernels.dit_block import FUSED_DIT_BLOCK
    from lfm_tpu_torch.kernels.flash_attention import ATTENTION_SMALL, ATTENTION_SMALL_BWD

    return {"attention_small": ATTENTION_SMALL, "fused_dit_block": FUSED_DIT_BLOCK,
            "attention_small_bwd": ATTENTION_SMALL_BWD}


def _dist_counted(fn):
    """fn() with the rank's counts reset before and read after: (result,
    counts, K1 / K3 launches by head count)."""
    cs = _dist_counters()
    for c in cs.values():
        c.reset()
    res = fn()
    return res, {k: c.count for k, c in cs.items() if c.count}, {
        k: dict(c.by_heads) for k, c in cs.items() if c.by_heads}


def _dist_model(torch, task, dev, dtype, remat=True):
    from lfm_tpu_torch.core.checkpoint import reference_state_dict
    from lfm_tpu_torch.nn.factory import create_network

    m = task["config"].model
    tc = task["config"].train
    model = create_network(m, dtype=dtype, use_flash=m.use_flash_attention,
                           remat=remat and tc.use_grad_checkpointing,
                           remat_policy=tc.remat_policy, device=dev)
    model.load_state_dict(reference_state_dict(torch.load(task["ckpt"], map_location="cpu",
                                                          weights_only=False)))
    return model


def _dist_vae(torch, dev, dtype=None):
    """The script's seeded VAE; in f32 for the f32 steps, whose bound would
    otherwise be the bf16 encoder's, whose roundings depend on the batch
    (cuDNN picks its algorithm by the batch)."""
    from lfm_tpu_torch.nn.init import seeded_init_
    from lfm_tpu_torch.vae.autoencoder_kl import create_vae

    return seeded_init_(create_vae(dtype=dtype or torch.bfloat16, device=dev), SEED + 1)


def dist_fid_config(config):
    return config.replace(sample=dataclasses.replace(
        config.sample, method="euler", num_steps=DIST_FID_STEPS, n_sample=DIST_FID_SAMPLES,
        batch_size=DIST_FID_SAMPLES))


def job_fid(torch, dev, task, rank):
    """Sharded FID on celeb256_dit, fused (K2)."""
    from lfm_tpu_torch.eval.inception import seeded_inception_state_dict
    from lfm_tpu_torch.sample import sharded

    cfg = dist_fid_config(task["config"])
    model = _dist_model(torch, task, dev, torch.bfloat16)
    vae = _dist_vae(torch, dev)
    inception = seeded_inception_state_dict(SEED)
    acts, counts, heads = _dist_counted(lambda: sharded.generate_fid_activations(
        cfg, model, None, vae, None, inception, device=dev))
    _, n_steps, gb = sharded.make_sharded_generator(cfg, model, None, device=dev)
    return {"acts": acts, "counts": counts, "heads": heads, "arith": (n_steps, gb)}


def _recording_train(torch, task, cfg, dev, max_steps, names, rank=None,
                     sigterm_after=None):
    """train(...) with each step's loss on this rank (the global mean) and
    each compared element's smallest |gradient|; with ``sigterm_after``
    rank 1 sends itself SIGTERM after that step."""
    import signal

    from lfm_tpu_torch.train import loop as loop_mod

    real, losses, low, grads1 = loop_mod.make_train_step, [], {}, {}

    def recording(*a, **k):
        step = real(*a, **k)

        def wrapped(state, batch):
            loss, gnorm = step(state, batch)
            losses.append(float(loss))
            for name, p in zip(state.names, state.params):
                if name in names:  # p.grad: the gradient averaged over the ranks
                    g = p.grad.detach().abs()
                    low[name] = g if name not in low else torch.minimum(low[name], g)
                    if state.step == 1:
                        grads1[name] = p.grad.detach().float().cpu()
            if rank == 1 and state.step == sigterm_after:
                os.kill(os.getpid(), signal.SIGTERM)
            return loss, gnorm

        return wrapped

    loop_mod.make_train_step = recording
    try:
        vae = None
        if "latent" not in cfg.dataset:
            vae = _dist_vae(torch, dev,
                            torch.float32 if cfg.train.precision == "f32" else torch.bfloat16)
        state = loop_mod.train(cfg, dataset=task["dataset"], vae=vae, device=dev,
                               max_steps=max_steps, log_fn=lambda *a: None)
    finally:
        loop_mod.make_train_step = real
    params = {n: p.detach().float().cpu() for n, p in zip(state.names, state.params)
              if n in names}
    return state.step, losses, params, {n: g.cpu() for n, g in low.items()}, grads1


def job_train1(torch, dev, task, rank):
    """One data-parallel bf16 step of train(...) from model_0.pth."""
    names = [task["probe"]]
    (step, losses, params, _, _), counts, heads = _dist_counted(
        lambda: _recording_train(torch, task, task["config"], dev, 1, names))
    return {"step": step, "losses": losses, "probe": params[task["probe"]], "counts": counts,
            "heads": heads}


def job_train3(torch, dev, task, rank):
    """Three data-parallel f32 steps of DiT-L/2."""
    (step, losses, params, _, grads1), counts, heads = _dist_counted(
        lambda: _recording_train(torch, task, task["f32_config"], dev, DIST_F32_STEPS,
                                 task["names"]))
    return {"step": step, "losses": losses, "params": params, "grads1": grads1,
            "counts": counts, "heads": heads}


def job_preempt(torch, dev, task, rank):
    """train(...) of DiT-S/2 on latents (a small content.pth): SIGTERM
    reaches rank 1 alone after its step 1, and every rank saves at the
    check of step DIST_F32_STEPS and returns."""
    from lfm_tpu_torch.core import checkpoint as ckpt

    cfg = task["preempt_config"]
    (step, _, _, _, _), counts, heads = _dist_counted(
        lambda: _recording_train(torch, dict(task, dataset=task["latents"]), cfg, dev, None,
                                 (), rank=rank, sigterm_after=1))
    content = ckpt.load_content(cfg.exp_path) if rank == 0 else None
    return {"step": step, "files": sorted(os.listdir(cfg.exp_path)), "counts": counts,
            "content_step": None if content is None else content["global_step"]}


def dist_part_batch(torch, config, dev):
    s = config.model.latent_size
    g = torch.Generator(device="cpu").manual_seed(SEED + 7)
    return {"x": torch.randn((DIST_PART_BATCH, s, s, 4), generator=g).to(dev)}


def dist_part_step(torch, model, config, mesh=None):
    from lfm_tpu_torch.train.state import make_optimizer
    from lfm_tpu_torch.train.train import make_train_step

    tc = dataclasses.replace(config.train, no_lr_decay=True)
    return make_train_step(model, make_optimizer(tc, 10), use_ema=False, scale_factor=1.0,
                           seed=SEED, mesh=mesh)


def job_partition(torch, dev, task, rank):
    """One fsdp=2 and one tp=2 f32 step through core/partition.py (dp=1:
    both ranks compute the whole batch)."""
    from lfm_tpu_torch.core.partition import combined_shardings, shard_params
    from lfm_tpu_torch.core.sharding import make_mesh
    from lfm_tpu_torch.train.state import create_train_state

    out = {}
    for name, layout, rules in (("fsdp", dict(fsdp=2), "none"), ("tp", dict(tp=2), "dit")):
        mesh = make_mesh(dp=1, **layout)
        model = _dist_model(torch, task, dev, torch.float32, remat=False)
        part = shard_params(model, combined_shardings(model, mesh, tp_rules=rules), mesh)
        state = create_train_state(model, part)
        step = dist_part_step(torch, model, task["config"], mesh)
        batch = dist_part_batch(torch, task["config"], dev)
        t0 = time.time()
        (loss, gnorm), counts, heads = _dist_counted(lambda: step(state, batch))
        torch.cuda.synchronize(dev)
        secs = time.time() - t0
        full = part.full(state.params)
        out[name] = {"loss": float(loss), "gnorm": float(gnorm), "counts": counts,
                     "heads": heads, "step_seconds": secs,
                     "params": {n: p.float().cpu() for n, p in zip(state.names, full)
                                if n in task["names"]}}
        del model, part, state, full
        torch.cuda.empty_cache()
    return out


DIST_JOBS = {"fid": job_fid, "train1": job_train1, "train3": job_train3,
             "preempt": job_preempt, "partition": job_partition}


def run_ranks(torch, work, name, world, backend, task):
    """Spawn ``world`` ranks of ``task``; fails unless every rank ends with
    0 within DIST_TIMEOUT_S. Returns each rank's results and the wall time."""
    import torch.multiprocessing as mp

    import socket

    out = os.path.join(work, name)
    os.makedirs(out, exist_ok=True)
    with socket.socket() as s:  # a free port on the loopback address for NCCL's store
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    task = dict(task, out=out, port=port)
    task_path = os.path.join(out, "task.pt")
    torch.save(task, task_path)
    ctx = mp.get_context("spawn")
    t0 = time.time()
    procs = [ctx.Process(target=dist_rank, args=(r, world, backend, os.path.join(out, "store"),
                                                 task_path))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = t0 + DIST_TIMEOUT_S
    try:
        while any(p.is_alive() for p in procs):
            if any(p.exitcode not in (None, 0) for p in procs) or time.time() > deadline:
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
    codes = [p.exitcode for p in procs]
    if codes != [0] * world:
        raise AssertionError(f"{name}: the ranks exited with {codes}")
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
            for r in range(world)], time.time() - t0


def dist_phases(torch, work, dev, config, tconfig, f32_config, dataset, vae, ckpt_path, probe,
                loss1, train_p1, depth, per_step, counters, counts, reset_counts):
    """10f: dist_world and dist_shared; returns their per-rank launch counts
    by path for the kernels line."""
    from lfm_tpu_torch.core.checkpoint import reference_state_dict
    from lfm_tpu_torch.data import SyntheticLatentDataset
    from lfm_tpu_torch.eval.inception import seeded_inception_state_dict
    from lfm_tpu_torch.nn.dit import DIT_CONFIGS
    from lfm_tpu_torch.nn.factory import create_network
    from lfm_tpu_torch.sample import sharded
    from lfm_tpu_torch.train.state import create_train_state

    card = card_line()
    f32_exp = dataclasses.replace(f32_config, exp="dist_f32",
                                  train=dataclasses.replace(f32_config.train, num_epoch=1))
    preempt_config = dataclasses.replace(
        tconfig, exp="dist_preempt", dataset="synthetic_latent",
        model=dataclasses.replace(tconfig.model, model_type=DIST_PREEMPT_MODEL),
        train=dataclasses.replace(tconfig.train, model_ckpt=None, num_epoch=1,
                                  preempt_check_every=DIST_F32_STEPS))
    weights = reference_state_dict(torch.load(ckpt_path, map_location="cpu",
                                              weights_only=False))
    names = dist_compare_names(list(weights), depth)
    task = {"config": tconfig, "f32_config": f32_exp, "ckpt": ckpt_path, "dataset": dataset,
            "probe": probe, "names": names, "preempt_config": preempt_config,
            "latents": SyntheticLatentDataset(n=4 * tconfig.train.batch_size,
                                              latent_size=config.model.latent_size, seed=SEED)}
    k2_eval = {"fused_dit_block": depth * DIST_FID_STEPS}

    def check_counts(what, got, want, heads=None, want_heads=None):
        if got != want or (want_heads is not None and heads != want_heads):
            raise AssertionError(f"{what}: launches {got} by heads {heads}, expected {want} "
                                 f"by heads {want_heads}")

    # one process, no torch.distributed: the sharded FID the ranks are held to
    fcfg = dist_fid_config(config)
    fmodel = create_network(config.model, dtype=torch.bfloat16,
                            use_flash=config.model.use_flash_attention, device=dev)
    fmodel.load_state_dict(weights)
    reset_counts()
    t0 = time.time()
    acts1 = sharded.generate_fid_activations(fcfg, fmodel, None, vae, None,
                                             seeded_inception_state_dict(SEED), device=dev)
    one_fid_s = time.time() - t0
    one_fid_counts = {k: v for k, v in counts().items() if v}
    check_counts("dist one-process fid", one_fid_counts, k2_eval)
    del fmodel
    torch.cuda.empty_cache()

    def act_err(a):
        return float(abs(a - acts1).max()) / float(abs(acts1).max())

    # dist_world: NCCL over every card
    world = torch.cuda.device_count()
    world_res, wall = run_ranks(torch, work, "dist_world", world, "nccl",
                                dict(task, jobs=["fid", "train1"]))
    rows = []
    for r, got in enumerate(world_res):
        if got["joined"] != ("nccl", world, str(r)):
            raise AssertionError(f"dist_world rank {r} joined {got['joined']}")
        check_counts(f"dist_world rank {r} fid", got["fid"]["counts"], k2_eval)
        check_counts(f"dist_world rank {r} train", got["train1"]["counts"], per_step["bf16"])
        loss_err = abs(got["train1"]["losses"][0] - loss1) / abs(loss1)
        probe_err = float((got["train1"]["probe"] - train_p1).abs().max())
        rows.append({"rank": r, "joined": got["joined"],
                     "fid_act_rel_err": act_err(got["fid"]["acts"]),
                     "fid_seconds": got["fid"]["seconds"], "fid_arith": got["fid"]["arith"],
                     "train_loss": got["train1"]["losses"][0], "train_loss_rel_err": loss_err,
                     "train_probe_max_abs_err": probe_err,
                     "train_seconds": got["train1"]["seconds"],
                     "launches": {"fid": got["fid"]["counts"],
                                  "train": got["train1"]["counts"]}})
    emit({"phase": "dist_world", "backend": "nccl", "ranks": world, "card": card,
          "fid_samples": DIST_FID_SAMPLES, "fid_steps": DIST_FID_STEPS,
          "one_process_fid_seconds": one_fid_s, "one_process_train_loss": loss1,
          "act_tol": DIST_ACT_TOL, "loss_tol": DIST_BF16_LOSS_TOL, "rows": rows,
          "wall_seconds": wall})
    lr = float(tconfig.train.lr)
    for row in rows:
        if not (row["fid_act_rel_err"] <= DIST_ACT_TOL
                and row["train_loss_rel_err"] <= DIST_BF16_LOSS_TOL
                and row["train_probe_max_abs_err"] <= 2 * lr
                and row["fid_arith"] == (1, DIST_FID_SAMPLES)):
            raise AssertionError(f"dist_world: {row}")

    # dist_shared: two ranks on cuda:0 over gloo; this process's f32 steps
    # and the replicated partition step first, held to the ranks' after
    t_ref = time.time()
    ref_exp = dataclasses.replace(f32_exp, exp="dist_f32_one")
    reset_counts()
    ref_step, ref_losses, ref_params, ref_low, ref_grads1 = _recording_train(
        torch, task, ref_exp, dev, DIST_F32_STEPS, names)
    ref_f32_counts = {k: v for k, v in counts().items() if v}
    check_counts("dist one-process f32 steps", ref_f32_counts,
                 {k: v * DIST_F32_STEPS for k, v in per_step["f32"].items()})
    torch.cuda.empty_cache()
    pmodel = create_network(config.model, dtype=torch.float32,
                            use_flash=config.model.use_flash_attention, device=dev)
    pmodel.load_state_dict(weights)
    pstate = create_train_state(pmodel)
    reset_counts()
    ploss, pgnorm = dist_part_step(torch, pmodel, config)(pstate,
                                                           dist_part_batch(torch, config, dev))
    part_counts = {k: v for k, v in counts().items() if v}
    part_heads = {k: dict(c.by_heads) for k, c in counters.items() if c.by_heads}
    part_params = {n: p.detach().float().cpu() for n, p in zip(pstate.names, pstate.params)
                   if n in names}
    part_low = {n: p.grad.detach().abs().cpu() for n, p in zip(pstate.names, pstate.params)
                if n in names}
    del pmodel, pstate
    torch.cuda.empty_cache()
    ref_s = time.time() - t_ref

    def params_err(got, want, low, steps):
        """The largest error of the elements whose gradient stays above the
        noise, and of all; fails where any exceeds its bound."""
        stats = {"max_above_noise": 0.0, "max": 0.0, "noise_elements": 0, "elements": 0}
        for n, b in want.items():
            err = (got[n] - b).abs().detach()
            noise = low[n] < DIST_NOISE_GRAD
            quiet = float(torch.where(noise, 0.0, err).max())
            stats["elements"] += err.numel()
            stats["noise_elements"] += int(noise.sum())
            stats["max"] = max(stats["max"], float(err.max()))
            stats["max_above_noise"] = max(stats["max_above_noise"], quiet)
            if not (quiet <= DIST_PARAM_TOL and float(err.max()) <= 2.2 * steps * lr):
                raise AssertionError(f"dist_shared: {n} off by {quiet} above the noise, "
                                     f"{float(err.max())} in all")
        return stats

    def grads_err(got, want):
        return max(float((got[n] - g).abs().max()) / float(g.abs().max())
                   for n, g in want.items())

    shared_res, wall = run_ranks(torch, work, "dist_shared", DIST_SHARED_RANKS, "gloo",
                                 dict(task, jobs=["fid", "train3", "preempt", "partition"]))
    rows = []
    n_heads = DIT_CONFIGS[config.model.model_type][3]
    if set(part_heads["attention_small"]) != {n_heads}:
        raise AssertionError(f"the replicated step launched K1 at {part_heads}")
    for r, got in enumerate(shared_res):
        if got["joined"] != ("gloo", DIST_SHARED_RANKS, "0"):
            raise AssertionError(f"dist_shared rank {r} joined {got['joined']}")
        fid, t3, pre, part = got["fid"], got["train3"], got["preempt"], got["partition"]
        check_counts(f"dist_shared rank {r} fid", fid["counts"], k2_eval)
        check_counts(f"dist_shared rank {r} f32 steps", t3["counts"],
                     {k: v * DIST_F32_STEPS for k, v in per_step["f32"].items()})
        for layout, want_heads in (("fsdp", n_heads), ("tp", n_heads // 2)):
            check_counts(f"dist_shared rank {r} {layout}", part[layout]["counts"], part_counts,
                         part[layout]["heads"],
                         {k: {want_heads: sum(v.values())} for k, v in part_heads.items()})
        pre_depth = DIT_CONFIGS[DIST_PREEMPT_MODEL][0]
        check_counts(f"dist_shared rank {r} preempt", pre["counts"],
                     {k: v * DIST_F32_STEPS * pre_depth // depth
                      for k, v in per_step["bf16"].items()})
        if pre["step"] != DIST_F32_STEPS or pre["files"] != ["config.json", "content.pth"] or (
                r == 0 and pre["content_step"] != DIST_F32_STEPS) or t3["step"] != DIST_F32_STEPS:
            raise AssertionError(f"dist_shared rank {r}: preempted at step {pre['step']}, "
                                 f"files {pre['files']}, content at {pre['content_step']}")
        loss_errs = [abs(a - b) / abs(b) for a, b in zip(t3["losses"], ref_losses)]
        part_loss = {k: abs(part[k]["loss"] - float(ploss)) / abs(float(ploss))
                     for k in ("fsdp", "tp")}
        rows.append({
            "rank": r, "joined": got["joined"], "fid_act_rel_err": act_err(fid["acts"]),
            "fid_arith": fid["arith"],
            "fid_seconds": fid["seconds"], "f32_losses": t3["losses"],
            "f32_loss_rel_errs": loss_errs,
            "f32_param_err": params_err(t3["params"], ref_params, ref_low, DIST_F32_STEPS),
            "f32_grad1_rel_err": grads_err(t3["grads1"], ref_grads1),
            "f32_seconds": t3["seconds"], "preempted_at": pre["step"], "files": pre["files"],
            "preempt_seconds": pre["seconds"],
            "part_loss_rel_err": part_loss,
            "part_param_err": {k: params_err(part[k]["params"], part_params, part_low, 1)
                               for k in ("fsdp", "tp")},
            "part_step_seconds": {k: part[k]["step_seconds"] for k in ("fsdp", "tp")},
            "part_heads": {k: part[k]["heads"] for k in ("fsdp", "tp")},
            "launches": {"fid": fid["counts"], "f32_steps": t3["counts"],
                         "preempt": pre["counts"],
                         "fsdp": part["fsdp"]["counts"], "tp": part["tp"]["counts"]}})
        if not (rows[-1]["fid_act_rel_err"] <= DIST_ACT_TOL
                and fid["arith"] == (1, DIST_FID_SAMPLES)
                and max(loss_errs) <= DIST_F32_LOSS_TOL and len(loss_errs) == DIST_F32_STEPS
                and rows[-1]["f32_grad1_rel_err"] <= DIST_GRAD_TOL
                and max(part_loss.values()) <= DIST_F32_LOSS_TOL):
            raise AssertionError(f"dist_shared: {rows[-1]}")
    emit({"phase": "dist_shared", "backend": "gloo", "ranks": DIST_SHARED_RANKS,
          "device": "cuda:0", "card": card,
          "gloo_cuda_collectives": "all_reduce, all_gather and barrier on CUDA tensors, "
                                   "no host copy in the port's code",
          "f32_steps": DIST_F32_STEPS, "one_process_f32_losses": ref_losses,
          "part_batch": DIST_PART_BATCH, "part_loss": float(ploss), "part_heads": part_heads,
          "tols": {"act": DIST_ACT_TOL, "f32_loss": DIST_F32_LOSS_TOL, "grad": DIST_GRAD_TOL,
                   "param": DIST_PARAM_TOL, "noise_grad": DIST_NOISE_GRAD},
          "rows": rows, "one_process_seconds": ref_s, "wall_seconds": wall})
    def full(c):
        return {**dict.fromkeys(counters, 0), **c}

    w0, s0 = world_res[0], shared_res[0]
    return {"dist_world_fid": full(w0["fid"]["counts"]),
            "dist_world_train": full(w0["train1"]["counts"]),
            "dist_shared_fid": full(s0["fid"]["counts"]),
            "dist_shared_f32": full(s0["train3"]["counts"]),
            "dist_shared_fsdp": full(s0["partition"]["fsdp"]["counts"]),
            "dist_shared_tp": full(s0["partition"]["tp"]["counts"])}


def other_networks(torch, work, dev, vae, counts, reset_counts, cli_main):
    """Phase 10e: the networks that launch no hand-written kernel, each run
    with every count reset just before it and checked to stay zero just
    after. Returns {path: launches}."""
    import numpy as np

    from lfm_tpu_torch.core.config import Config, ModelConfig, TrainConfig, get_preset
    from lfm_tpu_torch.core.rng import SampleRNG
    from lfm_tpu_torch.data import SyntheticImageDataset
    from lfm_tpu_torch.data.layout import Annotation, ObjectsBoundingBoxConditionalBuilder
    from lfm_tpu_torch.nn import variants
    from lfm_tpu_torch.nn.factory import create_network
    from lfm_tpu_torch.nn.init import seeded_init_
    from lfm_tpu_torch.nn.text_encoder import TransformerTextEncoder
    from lfm_tpu_torch.ode.flow import interpolate
    from lfm_tpu_torch.sample.sample import make_sampler, noise_and_labels
    from lfm_tpu_torch.train.loop import train
    from lfm_tpu_torch.train.state import (create_train_state, make_fused_adamw_ema,
                                           make_optimizer)

    bf, f32 = torch.bfloat16, torch.float32
    card = card_line()
    launches = {}

    def run_counted(path, fn):
        """fn() with the counts reset just before it and read just after
        (zero expected), its seconds and peak memory."""
        torch.cuda.synchronize()
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        out = fn()
        torch.cuda.synchronize()
        secs = time.time() - t0
        got = counts()
        launches[path] = got
        if any(got.values()):
            raise AssertionError(f"{path}: hand-written kernels launched {got}; none expected")
        return out, secs, torch.cuda.max_memory_allocated() / 2 ** 30

    def card_vs_cpu(model, *args, **kwargs):
        """The f32 model on the card (TF32 off within forward) against a
        copy on the CPU, on the first CPU_BATCH rows of its inputs; a tuple
        of outputs is read at its first."""

        def on(v, device):
            if torch.is_tensor(v):
                return v[:CPU_BATCH].to(device)
            return tuple(on(a, device) for a in v) if isinstance(v, tuple) else v

        def first(out):
            return out[0] if isinstance(out, tuple) else out

        with torch.no_grad():
            on_card = first(model(*on(args, dev), **{k: on(v, dev) for k, v in kwargs.items()}))
            cpu = copy.deepcopy(model).cpu()
            on_cpu = first(cpu(*on(args, "cpu"), **{k: on(v, "cpu") for k, v in kwargs.items()}))
        del cpu
        return rel_err(on_card.cpu(), on_cpu)[1]

    def check_images(path, out, batch, size):
        img = out.images
        if tuple(img.shape) != (batch, size, size, 3) or not (
                bool(torch.isfinite(img).all()) and float(img.min()) >= 0.0
                and float(img.max()) <= 1.0):
            raise AssertionError(f"{path}: images {tuple(img.shape)} not finite in [0, 1]")

    def check_params(path, model, key):
        n = sum(p.numel() for p in model.parameters())
        if n != FULL_WIDTH_PARAMS[key]:
            raise AssertionError(f"{path}: {n} parameters, the JAX package's are "
                                 f"{FULL_WIDTH_PARAMS[key]}")
        return n

    def check_errors_of(path, errs):
        for name, (err, tol) in errs.items():
            if not err <= tol:
                raise AssertionError(f"{path}: {name} {err} > {tol}")

    # song: ncsn++ and ddpm++ through the CLI's train, then sampled
    for model_type in ("ncsn++", "ddpm++"):
        t_phase = time.time()
        path = f"song_{model_type}"
        cwd = os.getcwd()
        os.chdir(work)  # the run's experiment directory goes under work
        try:
            state, train_s, train_peak = run_counted(f"{path}_train", lambda: cli_main(
                ["train", "--model_type", model_type, "--dataset", "synthetic",
                 "--batch_size", str(SONG_TRAIN_BATCH), "--max_steps", str(SONG_TRAIN_STEPS),
                 "--exp", path]))
        finally:
            os.chdir(cwd)
        if state.step != SONG_TRAIN_STEPS or not all(bool(torch.isfinite(p).all())
                                                      for p in state.params):
            raise AssertionError(f"{path}: {state.step} train steps, parameters not finite")
        # NCSN++'s Fourier frequencies are among the trained parameters, as in
        # JAX; two steps cannot show them move (zero-initialised output layers
        # give them no gradient before step 3), so this checks only that
        freqs_is_param = "map_noise.freqs" in state.names if model_type == "ncsn++" else None
        del state
        cfg = Config(model=ModelConfig(model_type=model_type))
        cfg = cfg.replace(sample=dataclasses.replace(cfg.sample, method="euler",
                                                     num_steps=NETS_STEPS))
        model = seeded_init_(create_network(cfg.model, dtype=bf, device=dev), SEED)
        n_params = check_params(path, model, model_type)
        noise, _ = noise_and_labels(cfg, SampleRNG(cfg.sample.seed), range(NETS_BATCH),
                                    device=dev)
        sampler = make_sampler(cfg, model, None, vae, None, device=dev)
        out, sample_s, sample_peak = run_counted(path, lambda: sampler(noise))
        check_images(path, out, NETS_BATCH, cfg.model.image_size)
        m32 = create_network(cfg.model, dtype=f32, device=dev)
        m32.load_state_dict(model.state_dict())
        tt = torch.full((NETS_BATCH,), 0.5, device=dev)
        with torch.no_grad():
            bf_err = rel_err(model(tt, noise), m32(tt, noise))[1]
        card_err = card_vs_cpu(m32, tt, noise)
        emit({"phase": "song", "model_type": model_type, "params": n_params,
              "train_batch": SONG_TRAIN_BATCH, "train_steps": SONG_TRAIN_STEPS,
              "train_seconds": train_s, "train_peak_gib": train_peak,
              "freqs_is_param": freqs_is_param, "sample_batch": NETS_BATCH, "method": "euler",
              "nfe": out.nfe, "sample_seconds": sample_s, "sample_peak_gib": sample_peak,
              "f32_card_vs_cpu_rel_err": card_err, "f32_tol": F32_VEL_TOL,
              "bf16_vs_f32_rel_err": bf_err, "bf16_tol": VEL_TOL,
              "launches": launches[path], "card": card, "seconds": time.time() - t_phase})
        check_errors_of(path, {"f32 card vs CPU": (card_err, F32_VEL_TOL),
                               "bf16 vs f32": (bf_err, VEL_TOL)})
        if freqs_is_param is False:
            raise AssertionError(f"{path}: map_noise.freqs is not among the trained parameters")
        del model, m32, sampler, out, noise
        torch.cuda.empty_cache()

    # adm_context: imnet_adm's widths, CFG (null label -1) and one train step
    t_phase = time.time()
    ccfg = get_preset("imnet_adm")
    ccfg = ccfg.replace(model=dataclasses.replace(ccfg.model, model_type="adm_context"),
                        sample=dataclasses.replace(ccfg.sample, method="euler",
                                                   num_steps=NETS_STEPS),
                        output_dir=work,
                        train=dataclasses.replace(ccfg.train, batch_size=CONTEXT_TRAIN_BATCH))
    cm = ccfg.model
    model = seeded_init_(create_network(cm, dtype=bf, device=dev), SEED)
    n_params = check_params("adm_context", model, "adm_context")
    noise, y = noise_and_labels(ccfg, SampleRNG(ccfg.sample.seed), range(NETS_BATCH), device=dev)
    sampler = make_sampler(ccfg, model, None, vae, None, device=dev)
    out, sample_s, sample_peak = run_counted("adm_context", lambda: sampler(noise, y))
    check_images("adm_context", out, NETS_BATCH, cm.image_size)
    m32 = create_network(cm, dtype=f32, device=dev)
    m32.load_state_dict(model.state_dict())
    card_err = card_vs_cpu(m32, torch.full((NETS_BATCH,), 0.5, device=dev), noise, y)
    del model, m32, sampler, out
    torch.cuda.empty_cache()
    ds = SyntheticImageDataset(n=2 * CONTEXT_TRAIN_BATCH, image_size=cm.image_size,
                               num_classes=cm.num_classes, seed=SEED)
    state, train_s, train_peak = run_counted("adm_context_train", lambda: train(
        ccfg, dataset=ds, vae=vae, device=dev, max_steps=1, log_fn=lambda line: None))
    finite = all(bool(torch.isfinite(p).all()) for p in state.params)
    emit({"phase": "adm_context", "preset": "imnet_adm", "params": n_params,
          "batch": NETS_BATCH, "evaluated_batch": 2 * NETS_BATCH,
          "cfg_scale": ccfg.sample.cfg_scale, "method": "euler", "nfe": NETS_STEPS,
          "sample_seconds": sample_s, "sample_peak_gib": sample_peak,
          "train_batch": CONTEXT_TRAIN_BATCH, "train_steps": state.step,
          "train_seconds": train_s, "train_peak_gib": train_peak, "params_finite": finite,
          "f32_card_vs_cpu_rel_err": card_err, "f32_tol": F32_VEL_TOL,
          "launches": launches["adm_context"], "card": card, "seconds": time.time() - t_phase})
    check_errors_of("adm_context", {"f32 card vs CPU": (card_err, F32_VEL_TOL)})
    if state.step != 1 or not finite:
        raise AssertionError(f"adm_context train: {state.step} steps, finite {finite}")
    del state, ds, noise, y
    torch.cuda.empty_cache()

    # layout: celeb256_adm with layout=True, its context from the token
    # encoder over box tokens of seeded synthetic annotations
    t_phase = time.time()
    lcfg = get_preset("celeb256_adm")
    lm = dataclasses.replace(lcfg.model, layout=True)
    builder = ObjectsBoundingBoxConditionalBuilder(80, LAYOUT_OBJECTS, 1024)
    ann_rng = np.random.default_rng(SEED)
    tokens = []
    for i in range(LAYOUT_BATCH):
        anns = []
        for _ in range(1 + i % LAYOUT_OBJECTS):
            x0, y0 = ann_rng.uniform(0.0, 0.6, 2)
            w, h = ann_rng.uniform(0.1, 0.4, 2)
            anns.append(Annotation(bbox=(float(x0), float(y0), float(w), float(h)),
                                   category_no=int(ann_rng.integers(80)), area=float(w * h)))
        tokens.append(builder.build(anns, rng=random.Random(SEED + i)))
    tokens = torch.as_tensor(np.stack(tokens), device=dev)
    with dev:
        encoder = seeded_init_(TransformerTextEncoder(dtype=bf), SEED + 1)
    model = seeded_init_(create_network(lm, dtype=bf, device=dev), SEED)
    n_params = check_params("layout", model, "layout")
    s = lm.latent_size
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    z0 = torch.randn((LAYOUT_BATCH, s, s, 4), generator=gen, device=dev)
    z1 = torch.randn((LAYOUT_BATCH, s, s, 4), generator=gen, device=dev)
    t = torch.rand((LAYOUT_BATCH,), generator=gen, device=dev)

    def layout_forward():
        with torch.no_grad():
            return model(t, z0, context=encoder(tokens))

    v, fwd_s, fwd_peak = run_counted("layout", layout_forward)
    both = torch.nn.ModuleDict({"unet": model, "encoder": encoder})
    lstate = create_train_state(both)
    update = make_fused_adamw_ema(make_optimizer(TrainConfig(), 1))

    def layout_step():
        z_t, u = interpolate(z0, z1, t)
        pred = model(t, z_t, train=True, generator=gen, context=encoder(tokens))
        loss = torch.mean(torch.square(pred.float() - u.float()))
        grads = torch.autograd.grad(loss, lstate.params)
        return float(loss), grads, float(update(lstate, grads))

    (loss, grads, gnorm), step_s, step_peak = run_counted("layout_train", layout_step)
    grads_finite = all(bool(torch.isfinite(g).all()) for g in grads)
    enc_grad = max(float(g.abs().max()) for n, g in zip(lstate.names, grads)
                   if n.startswith("encoder."))
    del grads, lstate, both
    m32 = create_network(lm, dtype=f32, device=dev)
    m32.load_state_dict(model.state_dict())
    with dev:
        enc32 = TransformerTextEncoder()
    enc32.load_state_dict(encoder.state_dict())
    with torch.no_grad():
        ctx32 = enc32(tokens)
    card_err = max(card_vs_cpu(m32, t, z0, context=ctx32), card_vs_cpu(enc32, tokens))
    emit({"phase": "layout", "preset": "celeb256_adm", "params": n_params,
          "encoder_params": sum(p.numel() for p in encoder.parameters()),
          "context": list(ctx32.shape), "batch": LAYOUT_BATCH, "forward_seconds": fwd_s,
          "forward_peak_gib": fwd_peak, "velocity_finite": bool(torch.isfinite(v).all()),
          "train_loss": loss, "grad_norm": gnorm, "grads_finite": grads_finite,
          "encoder_grad_max": enc_grad, "train_step_seconds": step_s,
          "train_peak_gib": step_peak, "f32_card_vs_cpu_rel_err": card_err,
          "f32_tol": F32_VEL_TOL, "launches": launches["layout"], "card": card,
          "seconds": time.time() - t_phase})
    check_errors_of("layout", {"f32 card vs CPU": (card_err, F32_VEL_TOL)})
    if not (bool(torch.isfinite(v).all()) and math.isfinite(loss) and grads_finite
            and enc_grad > 0):
        raise AssertionError(f"layout: velocity finite {bool(torch.isfinite(v).all())}, loss "
                             f"{loss}, gradients finite {grads_finite}, encoder's {enc_grad}")
    del model, encoder, m32, enc32, v, ctx32
    torch.cuda.empty_cache()

    # variants: each forward on the card against the CPU, f32
    t_phase = time.time()
    gen.manual_seed(SEED)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    tt = torch.rand((NETS_BATCH,), generator=gen, device=dev)
    x32 = rand(NETS_BATCH, 32, 32, 4)
    upsampler_ctx = (rand(NETS_BATCH, 16, 16, 3), torch.full((NETS_BATCH,), 0.1, device=dev))
    cases = [(f"encoder_unet_{pool}",
              lambda pool=pool: variants.EncoderUNetModel(pool=pool, num_head_channels=64),
              (tt, x32), {}) for pool in ("adaptive", "attention", "spatial", "spatial_v2")]
    cases += [("super_res", lambda: variants.SuperResModel(in_channels=8), (tt, x32),
               {"low_res": rand(NETS_BATCH, 16, 16, 4)}),
              ("unet_upsampler", variants.UNetUpsamplerModel,
               (tt, rand(NETS_BATCH, 64, 64, 3)), {"context": upsampler_ctx}),
              ("resnet18_eval", variants.resnet18, (rand(NETS_BATCH, 32, 32, 3),), {}),
              ("resnet18_train", variants.resnet18, (rand(NETS_BATCH, 32, 32, 3),), {})]
    rows = []
    for name, build, args, kwargs in cases:
        with dev:
            m = seeded_init_(build(), SEED).train(name.endswith("_train"))

        def forward():
            with torch.no_grad():
                out = m(*args, **kwargs)
            return out[0] if isinstance(out, tuple) else out

        out, secs, peak = run_counted(f"variants_{name}", forward)
        err = card_vs_cpu(m, *args, **kwargs)
        rows.append({"name": name, "params": sum(p.numel() for p in m.parameters()),
                     "output": list(out.shape), "finite": bool(torch.isfinite(out).all()),
                     "f32_card_vs_cpu_rel_err": err, "seconds": secs, "peak_gib": peak})
        del m, out
    emit({"phase": "variants", "batch": NETS_BATCH, "rows": rows, "f32_tol": F32_VEL_TOL,
          "card": card, "seconds": time.time() - t_phase})
    for row in rows:
        if not row["finite"] or not row["f32_card_vs_cpu_rel_err"] <= F32_VEL_TOL:
            raise AssertionError(f"variants {row['name']}: finite {row['finite']}, f32 card vs "
                                 f"CPU {row['f32_card_vs_cpu_rel_err']} > {F32_VEL_TOL}")
    return launches


if __name__ == "__main__":
    sys.exit(main())
