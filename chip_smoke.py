#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`dimsum_torch`) on one NVIDIA card:
its sampling and training paths at full DiM-L/2 width, at 256 px and, for
sampling, at 512 px (also sequence-parallel over 4 ranks on the card),
sampling from a checkpoint by the reference's eval protocol through
`python -m dimsum_torch.sample`, the rest of the model zoo (DiT-XL/2 at
512 px; a MoE, cond_init, cpe DiM-L/2; DiM-XL/2 --block-type linear), the
Mamba language model at mamba-2.8b's width and depth (scoring and
generation), scoring samples (FID, KID,
precision/recall with InceptionV3 on the card) through `python -m
dimsum_torch.sample_ddp` and `calc_metrics`, and training for real
through `python -m dimsum_torch.train` (with remat and data
parallelism).

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero:

  1. device   the card's name and power limit (nvidia-smi).
  2. build    nvcc builds every kernel source of the port (one process per
              source, all started together) into build/dimsum_torch/.
  3. kernel   the selective-scan kernel against its plain PyTorch version
              at the DiM-L/2 mixer shape (batch 24, L 256, dim 1024, N 16,
              r 32) in bf16 and fp32, forward and reversed (the reverse
              entry: the recurrence from the last step to the first), plus
              a ragged dim, a ragged L reversed, L 1024 (the 512-px
              mixer) both ways, and the mixer of linear + v2 (dim 2048,
              r 64) both ways in bf16 and reversed in fp32: max error
              against the
              stated tolerance, kernel and plain times (CUDA events), and
              the bound (bytes, fp32 operations and the transcendentals on
              the special-function units, the largest).
  4. model    full-width DiM-L/2 at 256 px (depth 16, seeded random
              weights), one CFG forward in fp32 with TF32 off through the
              kernel and through the plain scan: they must agree, and the
              kernel must launch exactly 32 times per forward.
  5. sample   the sampling path: `dimsum_torch.bench.run` (batch 12, CFG
              1.4, GVP velocity, 250 Euler grid points, bf16).  Launch
              counts are set to 0 just before and read just after; the
              samples must be finite.
  6. kernel-train  the training pair, kernels 2 (forward with saved
              states: its state pass and main pass) and 3 (backward: its
              carry pass and main pass), against their plain versions at
              the training mixer shape (batch 16, L 256, dim 1024, N 16, r
              32) in bf16 and fp32, forward and reversed, plus a ragged
              dim, at the 512-px one (batch 4, L 1024) in bf16 and fp32,
              and at a ragged L (4 x 1000, bf16); then their h0 entries
              (--cond-init training: kernel 2 seeded from h0, kernel 3
              returning dh0) at the training mixer shape in bf16 and fp32
              and at the ragged L: max error against the stated
              tolerance, kernel and plain times, and the bound.
  7. train-grad  full-width DiM-L/2 in fp32 with TF32 off at batch 2, one
              training loss (label dropout 0.1, stochastic depth 0.1, the
              same seeded draws) through the kernels and through the plain
              scan: the loss and every parameter's gradient must agree, and
              kernels 2 and 3 must each launch 32 times.
  8. train    the training path: `dimsum_torch.train_bench.run` (DiM-L/2,
              batch 16, bf16 over fp32 weights, AdamW, clip 1.0, EMA), 10
              timed steps after 3 of warm-up.  Counts set to 0 just before and
              read just after: 32 launches per step of kernels 2 and 3, none
              of kernel 1; finite losses and grad norms; the parameters and
              their EMA move.
  9. train-512  the 512-px training path: `train_bench.run` at 512 px
              (DiM-L/2, batch 4, bf16), 3 timed steps after 1 of warm-up;
              counts set to 0 just before and read just after: 32 launches
              per step of kernels 2 and 3, none of kernel 1; finite losses
              and grad norms.
 10. kernel-attn  the full-block attention kernels against their plain
              PyTorch version at the 512-px shapes, DiT (24, 1024, 16, 64)
              and cross (24, 1024, 8, 64): bf16 through the sm90 kernel
              (TMA + wgmma, csrc/full_attention_sm90.cu), fp32 through the
              fp32 kernel (csrc/full_attention_f32.cu: S on the FP32 pipe,
              P V as three TF32 tensor-core products); each record names
              the kernel that ran.  Max error against the stated tolerance,
              kernel, plain and SDPA times (SDPA is a yardstick only: the
              port never calls it at these shapes; its device time too),
              and the bound; also the first kernel (csrc/full_attention.cu)
              in the same dtype, held to the same tolerance and timed on the
              same inputs; and DiT-XL/2's heads at 512 px, (8, 1024, 16,
              72), which take the first kernel, in bf16 and fp32.  Then q
              and k 40x at the DiT shape (logits
              ~1e3) in both dtypes, at the same tolerances.  Plus the
              autograd Function's gradient against the plain version's at
              a small shape.
 11. model-512  full-width DiM-L/2 at 512 px (latent 64, L 1024) in fp32
              with TF32 off, one CFG forward of 2 images (4 rows) through
              both kernels (scan and attention) and through both plain
              routes: they must agree, with 36 attention (all through the
              fp32 kernel) and 32 scan launches per forward.
 12. model-512-bf16  the same forward in bf16 at three seeds of inputs,
              its q and k projections scaled by 4 so that attention is
              peaked, through the sm90 attention kernel and through the
              plain attention (the scan kernel on both sides): they must
              agree within MODEL_512_BF16_TOL, with 36 sm90 launches; and
              each of the 36 calls, on the inputs the model gave it, within
              the kernel tolerance of the plain version.  Two faulty
              attentions (no online rescale; the last key tile dropped)
              must miss both limits.
 13. sample-512  the 512-px sampling path: `dimsum_torch.bench.run`
              with image_size 512 (batch 12, CFG 1.4, GVP velocity, 250
              Euler grid points, bf16).  Counts set to 0 just before and
              read just after: 32 scan and 36 attention launches per
              forward, all 36 through the sm90 kernel; the samples must be
              finite.
 14. kernel-state  the scan's state entry (csrc/selective_scan_fwd.cu's
              second entry: a full delta, h0, the last state) against its
              plain version at the sample-sp-512 shape (8, 256, 1024, N 16,
              delta = dt_low @ dt_w with r 32 in the compute dtype) in bf16
              and fp32, and at a ragged L and dim (8, 250, 1000): both SP
              passes (zero state in and the last state out; seeded from an
              h0), max error against the stated tolerance, kernel, device
              and plain times, and the bound.
 15. sample-sp-512  DiM-L/2 at 512 px sequence-parallel: SP_RANKS = 4
              processes on the one card (gloo, tcp://localhost), 256 of the
              1024 tokens a rank in every mixer (halo conv, two-pass scan
              through the state entry), the seeded weights of sample-512:
              one fp32 CFG drift call of 8 rows (TF32 off) against the
              unsharded forward (scaled error <= SP_512_FP32_TOL), then
              SP_STEPS Euler grid points with CFG 1.4 in bf16 against the
              unsharded run (<= SP_512_BF16_TOL).  Counts set to 0 just
              before and read just after on every rank: 2 x 32 state-entry
              and 36 attention launches a drift call (the fp32 call's
              through the fp32 kernel, the bf16 calls' through sm90), none
              of kernel 1.  Records the wall time a drift call, the unsharded one's,
              and the all_gathers' share of a call, in all and by kind
              (halos, summaries, outputs; timed between synchronizations
              in one more call).
 16. kernel-norm  the add + norm and norm + modulate kernels against their
              plain PyTorch versions at the 256-px rows (24 x 256 x 1024):
              the add + norm site and every norm + modulate call site
              (norm_2, the DiT block's two LayerNorms, the FinalLayer's,
              the deferred top of the pending tail), bf16 and fp32: max
              error against the stated tolerance, kernel and plain times,
              and the bound; bf16 norm_2 also with a cold L2 (128 MB
              written before each launch), and norm_2 and the DiT block's
              second LayerNorm at the 512-px rows (24 x 1024 x 1024).
              Alone: python3 -c "import chip_smoke as s;
              s.phase_kernel_norm()".
 17. kernel-convx  the conv + x_proj kernel against its plain version at the
              mixer shape (24, 256, 1024, W 4, R 64, x a strided slice of
              in_proj's output), forward and reversed, bf16 and fp32, plus
              L 1024, DiM-XL/2's R 68, ragged L (65, 127 reversed) and the
              gate's widest R (512): the same fields.  The fp32 route also
              at the fused fp32 512-px shape (24 x 1024 x 1024) and at
              DiM-XL/2's at 512 px (8 x 1024 x 1152, R 68), both ways; every
              fp32 case with its device ms.
 18. model-fused  full-width DiM-L/2 at 256 px in fp32 with TF32 off, one
              CFG forward with the fused-kernel switches on (pallas_norm,
              fused_norm, conv_xproj) through the kernels and through their
              plain versions, and with the switches off: all must agree, at
              pending_tail 0 (15 add + norm, 25 norm + modulate, 32 conv +
              x_proj launches per forward) and 2 (3, 37, 32).
 19. train-grad-fused  phase 7's training gradient with the three switches
              on, through the kernels and through their plain versions:
              the loss and every gradient must agree; one forward's
              launches, none from the backward.
 20. sample-fused  phase 5's sampling run with the three switches on.
              Counts set to 0 just before and read just after: 15, 25 and
              32 launches per forward; the samples must be finite.
 21. sample-fused-512  phase 20's run at 512 px: 15, 25 and 32 fused
              and 36 sm90 attention launches per forward; finite samples.
 22. variants  full-width DiM-L/2 at 256 px in four other configurations,
              built from their JAX CLI flags: (a) linear + Mamba v2 with
              the CLI's other defaults, (b) combined_fourier, (c)
              combined_einfft, (d) the published one with the fused
              switches.  Each: one fp32 CFG forward of 24 rows through
              the kernels and the plain versions (1e-3 of scale), and its
              launches of the scan's forward and reverse entries (16/16,
              24/8, 8/8, 24/8; (d) also 32 conv + x_proj, 8
              anticausal).  (a) and (b) sampled in bf16 (Euler,
              VARIANT_STEPS grid points, CFG 1.4: s, img/s), (a) also
              through `python -m dimsum_torch.sample ODE` in a process of
              its own from a reference-layout checkpoint.  Then the
              reversed blocks' two routes (`phase_reverse_route`): the
              published configuration's bf16 CFG forward with the reverse
              inside the mixers (the route without a gradient) and with
              the block's flips, alternated, at 256 and 512 px and fused
              at 512 px (the three cells in one process): wall and device
              ms and launches a forward, and the two routes' outputs
              compared.  Alone: python3 -c
              "import chip_smoke as s; s.phase_variants()"
              (`s.phase_reverse_route()` for the routes alone).
 23. xl-linear  DiM-XL/2 with the JAX CLI's --block-type linear and its
              other defaults (Mamba v2, LayerNorm) at 256 px, full depth
              24, dt_rank 72 (the scan kernels' RMAX 128): one fp32 CFG
              forward of 24 rows through the kernels and the plain routes
              (1e-3 of scale; 24 launches of the scan's forward entry and
              24 of its reverse entry); `python -m dimsum_torch.sample ODE
              --bf16` in a process of its own (4 images, XL_LINEAR_STEPS
              Euler points: finite, the drift calls' launches); one fp32
              step at depth 2 through kernels 2 and 3 (4 launches each)
              and through the plain scan: loss and every gradient.  Alone:
              python3 -c "import chip_smoke as s; s.phase_xl_linear()".
 24. models-rest  the rest of the zoo from the JAX CLIs' flags
              (`cli.model_config`), seeded random weights: DiT-XL/2 at 512
              px (28 blocks, hidden 1152, Dh 72, L 1024), one fp32 CFG
              forward of 8 rows through the kernels and the plain routes,
              without and with fused_norm (1e-4 of scale; 28 launches of
              the first attention kernel, 57 of norm + modulate), then
              `python -m dimsum_torch.sample ODE --model DiT-XL/2
              --image-size 512 --bf16` in a process of its own (8 images,
              REST_STEPS Euler points: 28 first-kernel launches a drift
              call); DiM-L/2 with the published combined block and
              --is-moe --cond-mamba --cond-init --pe-type cpe: one fp32
              CFG forward of 24 rows (1e-3 of scale; 16 state-entry
              launches with h0, none of kernel 1), a bf16 sample of 12
              images, REST_TRAIN_STEPS bf16 steps through the training
              CLI's Trainer (16 launches a step of each h0 training
              kernel), and one fp32 step at depth 2 whose loss and every
              gradient match the plain route.  Alone: python3 -c "import
              chip_smoke as s; s.phase_models_rest()".
 25. lm       the Mamba LM at mamba-2.8b's width and depth (d_model 2560,
              64 layers, d_inner 5120, dt_rank 160, vocab 50280), seeded
              weights built on the card.  First kernel-rank: kernels 1-3
              at dt_rank 72 (DiM-XL/2 linear), 96, 128, 160 (the LM's 1 x
              2048 x 5120) and 256 (the cap) against their plain versions
              in bf16 and fp32 (the reverse entry at r 72; the h0 entries
              at 256), each kernel's device ms beside its bound computed
              from the case's inputs (the bf16 expansion on the tensor
              cores, fp32's on the FP32 pipe); a rank of 257 must raise in
              all three wrappers.  Then at 2 layers of full width in fp32:
              the logits of a seeded 2048-token sequence through the scan
              kernel and the plain scan (1e-3 of scale).  The full model in
              fp32 (11 GB): `MambaScorer.loglikelihood` of the sequence
              with 64 kernel-1 launches, finite; `generate` at batch 8, a
              64-token prompt, 128 new tokens, greedy: the first new token
              the argmax of the forward's last logits, tokens/s.  In bf16:
              the scoring again, 64 launches.  Alone: python3 -c "import
              chip_smoke as s; s.phase_lm()".
 26. sample-dopri5  the sampling path from a checkpoint: seeded random
              DiM-L/2 weights written in the reference's .pt layout (a
              different "ema" and "model") and a full-width SD-VAE (ch 128,
              ch_mult 1 2 4 4) with seeded random weights written as a
              diffusers state dict, both into a temporary directory; then
              `python -m dimsum_torch.sample ODE` (dopri5, --compute-nfe,
              CFG 1.4, 256 px, bf16, DOPRI5_BATCH images, VAE decode to
              PNGs).  Counts set to 0 just before and read just after: 32
              launches of kernel 1 per drift call, NFE + 1 calls; one 256 x
              256 PNG per image; finite latents.  `--params ema|raw` must
              take the matching weights, and a checkpoint with one key
              removed must be refused.  Prints the NFE, the seconds and the
              decode seconds.
 27. sample-sde-512  the checkpoint adapted to 512 px (`adapt_checkpoint`)
              and sampled by the CLI's SDE mode (Euler-Maruyama over
              SDE_512_STEPS grid points, CFG 1.4, bf16): 32 scan and 36 sm90
              attention launches per model call; finite samples.
 28. sample-512-fp32  the adapted checkpoint sampled by the CLI's ODE
              mode in its default dtype, fp32 (TF32 off; Euler over
              FP32_512_STEPS grid points, CFG 1.4, 2 images): 32 scan and
              36 attention launches per drift call, all through the fp32
              kernel; finite samples.  Then sample-512-fp32-fused: the same
              run with the JAX switches DIMSUM_PALLAS_NORM,
              DIMSUM_FUSED_NORM and DIMSUM_CONV_XPROJ set to "1" (32 conv +
              x_proj launches a drift call, all on the fp32 route, 15 add +
              norm, 25 norm + modulate), held to the plain run's samples;
              seconds per drift call of both.
 29. likelihood  the CLI's `--likelihood` at cfg 1.0 (256 px, bf16, 2
              images, LIKELIHOOD_STEPS grid points): 32 launches of kernels
              2 and 3 per drift call of the augmented ODE, finite bits/dim;
              and one augmented drift call of the fp32 model (TF32 off)
              through the kernels and through the plain scan: they must
              agree.
 30. eval     the evaluation path from the same checkpoint and SD-VAE
              (`phase_eval`): EVAL_REAL real PNGs (the VAE decode of
              seeded latents); `python -m dimsum_torch.sample_ddp ODE` in a
              process of its own, with its rerun (EVAL_SAMPLES samples in
              batches of
              EVAL_BATCH, Euler over EVAL_STEPS grid points, CFG 1.4, bf16,
              the VAE decode, the port's InceptionV3 on the card with
              seeded weights, fid50k_full, kid50k_full, pr50k3_full,
              --eval-streaming --save-images): 32 launches of kernel 1 a
              drift call, finite metrics; rerun with its feature chunks on
              disk: no launch, the same metrics; `python -m
              dimsum_torch.calc_metrics` over the two folders: FID within
              1e-3; InceptionV3 on the card within 1e-4 of its fp64 CPU
              run, PR on the card equal to numpy's, KID within 1e-6 of
              its terms' scale of its fp64 value; generation,
              decode and InceptionV3 images/s and the metric seconds.
              Alone: python3 -c "import chip_smoke as s; s.phase_eval()".
 31. train-cli  `python -m dimsum_torch.train` on full-width DiM-L/2 at
              256 px with the published ImageNet flags (bf16 over fp32
              weights, global batch 16) from a seeded latent memmap of 128
              samples (latents.dat fp32 (N, 4, 32, 32), labels.dat int64,
              2 MB) in a temporary directory: epoch 0 as a process of
              its own (the content checkpoint, a sample grid at epoch 0
              through `--vae-ckpt random`), then `--resume` in a
              process of its own for epoch 1 (`train.Trainer`, what the
              module's main runs).  It must start at step 8, epoch 1, with
              its weights, EMA and AdamW state equal to the saved file bit
              for bit; the native gather runs; counts set to 0 just before
              and read just after its epoch (in its process): 32 launches
              of kernels 2 and 3 a step, none of kernel 1; finite losses;
              two content checkpoints (two 7.4-GB saves; the keep-2
              rotation is the CPU test's, `test_trains_and_rotates_
              checkpoints`, for the smoke's time).
              Records s/step (the last log window of the CLI's own
              process); for the resumed run, itself a process of its own,
              the s/step, kernels' device ms a step and idle share of its
              last log window, recorded by torch.profiler (CUDA activity
              only) over that window's steps; peak memory, beside train's
              s/step and peak memory; the phase's seconds.  Alone:
              python3 -c "import chip_smoke as s; s.phase_train_cli()".
 32. train-remat  one fp32 step of full-width DiM-L/2 at batch 2 (TF32
              off, cuDNN deterministic, the math SDPA; drop path and label
              dropout 0.1 from one generator seed) twice without remat and
              with --grad-checkpoint under None and "scan": the loss, every
              gradient and the generator's state after the step equal those
              without remat, to 4 times the spread of the two runs without
              (0 when they agree); 64/32 and 32/32 launches of kernels 2/3.
              Then train_bench's bf16 protocol at batch 16 without remat,
              under None and under "scan" (3 timed steps after 1 each):
              s/step, peak memory (remat's must be lower), launches a
              step.
 33. train-ddp  2 gloo processes on the one card (NCCL takes one rank a
              device), DiM-L/2 at full width and depth 4, fp32: 2
              data-parallel steps of 2 samples a rank, each rank's
              generator, against rank 0 replaying both ranks' micro-batches
              in turn: loss, weights and EMA (tolerances in
              `phase_train_ddp`), the replicas equal, 16 launches of
              kernels 2 and 3 a rank.
 34. parallel  full-width DiM-L/2 at 256 px through the parallel CLIs as
              2 gloo ranks on the one card, in one group of processes: (a)
              `train --tp 2 --is-moe` (2 fp32 steps, experts 4 a rank,
              capacity dispatch) against the same steps unsharded (loss,
              grad_norm, gradients and weights leaf by leaf); (b)
              `sample_ddp --tp 2` under the four fused switches and (c)
              `sample --pp 2` against the unsharded run; then (d) `bench
              --bf16-residual` under DIMSUM_PALLAS_NORM / FUSED_NORM (and
              DIMSUM_PENDING_TAIL=2) held to the fp32 plain route, (e) one
              fp32 forward under each JAX switch against the default
              route, and timed beside it (DIMSUM_FULL_ATTN=1 at 512 px:
              36 launches of the fp32 attention kernel).  Tolerances in
              `phase_parallel`.
 35. kernel-cases  the cases the Pallas scan kernels take beyond the model
              zoo's (`phase_kernel_cases`): kernel 1 at N 64 and 256
              (the split entry: 32-state tiles and their combine) and
              grouped B/C, the state entry grouped (G 2, 4) and at N 256
              with h0 and the last state, kernels 2 and 3 on a full
              delta (their delta entries) and at N 64 / 256, each against
              its plain version with device, kernel and plain times and
              the bound; then the JAX front end `selective_scan` through
              autograd at the training mixer shape, grouped (G 2, fp32),
              on a full delta (bf16) and kernel 1 at N 64 without a
              gradient, held to the plain route, with the launch counts
              set to 0 just before and read just after.
 36. kernels  the smoke's seconds (and the variants and models-rest
              phases'), then one
              {"kernels": [...]} line (all ten kernels; rows 1-3 with
              their `rank_cases` from kernel-rank and their launches in the
              LM's scoring and in xl-linear; the scan
              with its reverse entry's times, bound, plain time and error
              at the combined block's mixer shape and at linear + v2's,
              whose sampling run in the variants phase makes the reverse
              launches, beside its own,
              both training kernels, conv + x_proj and norm + modulate
              (norm_2) with their L 1024 times and bound beside the
              256-px ones (norm + modulate also with its L2-cold device
              time, `cold_device_ms`), the scan's
              state entry with its second SP pass's (h0) beside its first's,
              the sm90 and fp32 attention kernels with their cross-shape
              times beside the DiT ones; the first attention kernel with
              models-rest's DiT-XL/2 sampling launches and its times at
              DiT-XL/2's heads (bf16; fp32 and its Dh-64 times beside);
              kernels 2 and 3 also with train-cli's launches and their h0
              entries' times, error and models-rest launches; add + norm
              and norm + modulate with their bf16-residual case's times,
              bound and the parallel phase's launches),
              then the nvidia-smi line, then {"ok": true, "device": {...}}
              as the last line.  Each record's `ms` (CUDA events around
              back-to-back launches, which below ~0.05 ms can read the
              host's launch gaps) has `device_ms` beside it: the median
              duration of the kernel's launches in torch.profiler's CUDA
              activity over the same launches.

Exits with an error and prints no result when CUDA is not available, or
when the port's package is not beside this script.
"""

from __future__ import annotations

import gc
import json
import math
import sys
import time

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
BF16_TC_FLOP_PER_S = 989e12
TF32_TC_FLOP_PER_S = 495e12
# exp on the special-function units: 16 per SM per clock (CUDA programming
# guide, sm_90), 132 SMs at the 1.98 GHz boost clock
SFU_EXP_PER_S = 16 * 132 * 1.98e9
STEPS = 250  # Euler grid points of the bench protocol
# timed and untimed steps of the train phase, as train_bench's defaults
TRAIN_STEPS, TRAIN_WARMUP = 10, 3
# timed steps of the 512-px train phase (after one of warm-up)
TRAIN_512_STEPS = 3


def emit(obj):
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
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


def held_stream_ms(fn, iters: int = 20, hold_ms: float = 20.0) -> float:
    """Device time per call of `fn` by CUDA events around `iters` calls
    queued behind a spin kernel that holds the stream for `hold_ms`, so
    the host has queued every launch before the first one runs and the
    calls run back to back: the host's launch gaps, which `cuda_ms` reads,
    are left out.  It times every kernel `fn` launches."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # cycles at the 1.98 GHz boost clock: at a lower clock it holds longer
    torch.cuda._sleep(int(hold_ms * 1.98e6))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, cls, iters: int = 20, tries: int = 5,
              kernels: int = 1) -> float:
    """Device time per call of `fn` in the kernels of `profile_forward`'s
    class `cls` (None: every kernel), from torch.profiler's CUDA activity over `iters` calls
    after one untimed: the kernels alone, without the host's launch gaps,
    which `cuda_ms` reads below ~0.05 ms.  Each kernel of the class (one
    launch a call each) counts with the median of its launches' durations,
    those of zero length left out: in a process that has run many profiler
    sessions, some sessions record only part of the window's launches (or
    none; then the window is profiled again), and some add records of no
    duration, which halved a mean (the state entry's second pass read
    0.0140 ms in one smoke, 0.0292 in every fresh window).  If `tries`
    windows in a row record no kernel of the class (one smoke saw three
    empty windows in a row for the first attention kernel), the time is
    `held_stream_ms`'s, and a `device-ms-fallback` record says so.  A
    window with fewer than `kernels` kernels of the class (the distinct
    kernels a call launches) counts as empty: one smoke's window of the
    training forward's split entry held its combine kernel alone, 0.0339
    ms against the call's 0.4452."""
    import statistics

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from dimsum_torch.profile_forward import kernel_class

    fn()
    torch.cuda.synchronize()
    windows = []
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        durations = {}
        n_cuda = 0
        for e in prof.events():
            us = e.time_range.elapsed_us()
            n_cuda += e.device_type == DeviceType.CUDA
            if (e.device_type == DeviceType.CUDA and us > 0
                    and not getattr(e, "is_user_annotation", False)
                    and cls in (None, kernel_class(e.name))):
                durations.setdefault(e.name, []).append(us)
        if len(durations) >= kernels:
            return sum(statistics.median(v) for v in durations.values()) / 1e3
        windows.append(n_cuda)
    ms = held_stream_ms(fn, iters)
    emit({"phase": "device-ms-fallback", "class": cls,
          "cuda_events_per_window": windows, "held_stream_ms": ms})
    return ms


def scan_inputs(batch, L, dim, n, r, dtype, seed):
    """Mixer-like inputs: u, z, B, C ~ N(0, 1); dt = softplus(dt_low @ dt_w
    + bias) with the Mamba dt init (bias from dt log-uniform in
    [1e-3, 0.1]); A = -(1..N) per channel; D = 1."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = torch.device("cuda")

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)

    dt = torch.exp(torch.rand(dim, generator=g, device=dev)
                   * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    x = dict(u=randn(batch, L, dim), dt_low=randn(batch, L, r),
             dt_w=(torch.rand(r, dim, generator=g, device=dev) * 2 - 1)
             / math.sqrt(r),
             A=-torch.arange(1, n + 1, device=dev, dtype=torch.float32)
             .repeat(dim, 1),
             B=randn(batch, L, n), C=randn(batch, L, n),
             D=torch.ones(dim, device=dev), z=randn(batch, L, dim),
             delta_bias=dt + torch.log(-torch.expm1(-dt)))
    fp32 = ("A", "D", "delta_bias")
    return {k: (v if k in fp32 else v.to(dtype)).contiguous()
            for k, v in x.items()}


def _bound(nbytes, flops, n_sfu, tc_flops=0):
    """(bound ms, "bytes" or "operations", which operations): the largest
    of the bytes over HBM bandwidth, the fp32 operations over the fp32
    peak, the transcendentals over the special-function units and the
    bf16 tensor-core operations (`tc_flops`) over their peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    times = {"fp32": flops / FP32_FLOP_PER_S * 1e3,
             "sfu": n_sfu / SFU_EXP_PER_S * 1e3,
             "bf16_tc": tc_flops / BF16_TC_FLOP_PER_S * 1e3}
    ops = max(times, key=times.get)
    if t_bytes >= times[ops]:
        return t_bytes, "bytes", None
    return times[ops], "operations", ops


def _bound_fields(bound):
    """A scan_bound / train_bounds tuple as record fields."""
    return dict(zip(("bound_ms", "bound_by", "bound_ops", "bytes", "flop",
                     "transcendentals", "tc_flop"), bound))


def _expansion_flops(x, per_elem):
    """(fp32 flop, bf16 tensor-core flop) of a scan kernel on x: the dt
    expansion's 2r a (b, t, d) runs on the tensor cores (mma.sync) for
    bf16 inputs and as fp32 FMAs for fp32 ones; `per_elem` more fp32 flop
    a (b, t, d) besides.  A full delta (x["delta"]) has no expansion."""
    batch, L, dim = x["u"].shape
    if "delta" in x:
        return batch * L * dim * per_elem, 0
    big, two_r = batch * L * dim, 2 * x["dt_w"].shape[0]
    if x["u"].element_size() == 2:
        return big * per_elem, big * two_r
    return big * (two_r + per_elem), 0


def scan_bound(x):
    """Least time for one scan call: each input read once and the output
    written once, over HBM bandwidth; the operations, 2r (dt expansion:
    fp32 FMAs, or bf16 tensor-core products for bf16 inputs) + 7N (per
    state: dt*A, exp2, du*B, two FMAs) + 12 (bias, softplus, du, skip,
    gate) per (b, t, d), each over its unit's peak; and the N + 3
    transcendentals per (b, t, d) (an exp2 per state; exp and log in
    softplus; exp in the gate) over the special-function units.  Returns
    (ms, bound_by, which operations, bytes, flop, transcendentals, bf16
    tensor-core flop)."""
    batch, L, dim = x["u"].shape
    n = x["A"].shape[1]
    nbytes = sum(v.numel() * v.element_size() for v in x.values())
    nbytes += x["u"].numel() * x["u"].element_size()  # the output
    flops, tc = _expansion_flops(x, 7 * n + 12)
    n_sfu = batch * L * dim * (n + 3)
    return (*_bound(nbytes, flops, n_sfu, tc), nbytes, flops, n_sfu, tc)


def phase_kernel():
    import torch

    # the reverse cases take the reverse entry (the recurrence from the
    # last step to the first, no flips); ragged-L-reverse's ragged chunk is
    # the first it walks; the v2 cases are the mixers of linear + v2
    # (d_inner 2048, dt_rank 64: the r <= 64 instantiation), whose reverse
    # branch makes the reverse entry's launches in the variants phase
    cases = [
        ("mixer-bf16", 24, 256, 1024, 32, torch.bfloat16, False),
        ("mixer-bf16-reverse", 24, 256, 1024, 32, torch.bfloat16, True),
        ("mixer-fp32", 24, 256, 1024, 32, torch.float32, False),
        ("mixer-fp32-reverse", 24, 256, 1024, 32, torch.float32, True),
        ("ragged-dim-bf16", 24, 256, 1000, 32, torch.bfloat16, False),
        ("ragged-L-bf16-reverse", 24, 250, 1024, 32, torch.bfloat16, True),
        ("L1024-bf16", 24, 1024, 1024, 32, torch.bfloat16, False),
        ("L1024-bf16-reverse", 24, 1024, 1024, 32, torch.bfloat16, True),
        ("v2-bf16", 24, 256, 2048, 64, torch.bfloat16, False),
        ("v2-bf16-reverse", 24, 256, 2048, 64, torch.bfloat16, True),
        ("v2-fp32-reverse", 24, 256, 2048, 64, torch.float32, True),
    ]
    timed = ("mixer-bf16", "L1024-bf16", "mixer-bf16-reverse",
             "L1024-bf16-reverse", "v2-bf16", "v2-bf16-reverse")
    return {name: _scan_case("kernel", name, (batch, L, dim, 16, r), dtype,
                             reverse, 100 + i, name in timed)
            for i, (name, batch, L, dim, r, dtype, reverse)
            in enumerate(cases)}


def _scan_case(phase, name, shape, dtype, reverse, seed, timed,
               plain_timed=True, inputs=None):
    """Kernel 1 (its reverse entry with `reverse`) against its plain
    version on `scan_inputs(*shape)` (passed through `inputs` where given):
    the error against the stated tolerance, the kernel's time (CUDA events;
    with `timed` also its device ms), the plain version's (with
    `plain_timed`) and the bound.  Raises if they disagree."""
    import torch

    from dimsum_torch.ops.selective_scan import (selective_scan_cuda,
                                                 selective_scan_dtlow)

    x = scan_inputs(*shape, dtype, seed=seed)
    if inputs is not None:
        x = inputs(x)
    args = [x[k] for k in ("u", "dt_low", "dt_w", "A", "B", "C", "D")]
    kw = dict(z=x["z"], delta_bias=x["delta_bias"], delta_softplus=True)
    with torch.inference_mode():
        got = selective_scan_cuda(*args, reverse=reverse, **kw).float()
        want = selective_scan_dtlow(*args, reverse=reverse, impl="ref",
                                    **kw).float()
        torch.cuda.synchronize()
        # fp32: exp2 vs exp and summation order; bf16: one fp32 value
        # may round to neighbouring bf16 numbers (2 ulp = 2^-6)
        tol = 1e-4 if dtype == torch.float32 else 1.6e-2
        err = (got - want).abs()
        ok = bool(torch.isfinite(got).all()) and bool(
            (err <= tol + tol * want.abs()).all())
        ms = cuda_ms(lambda: selective_scan_cuda(
            *args, reverse=reverse, **kw), iters=20)
        # the split entry above 32 states: the scan and its combine
        dev_ms = (device_ms(lambda: selective_scan_cuda(
            *args, reverse=reverse, **kw), "selective_scan",
            kernels=1 + (shape[3] > 32)) if timed else None)
        plain_ms = (cuda_ms(lambda: selective_scan_dtlow(
            *args, impl="ref", reverse=reverse, **kw), iters=3, warmup=1)
            if plain_timed else None)
    rec = {"phase": phase, "case": name, "shape": list(shape),
           "dtype": str(dtype).split(".")[-1], "reverse": reverse,
           "max_abs_err": err.max().item(),
           "max_abs_ref": want.abs().max().item(), "tol": tol,
           "ok": ok, "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
           **_bound_fields(scan_bound(x))}
    emit(rec)
    if not ok:
        raise AssertionError(f"kernel disagrees with plain on {name}")
    return rec


def _mixers(model):
    from dimsum_torch.models.mamba import Mamba

    return [m for m in model.modules() if isinstance(m, Mamba)]


def phase_model():
    import torch

    from dimsum_torch.models.dim import DiM_models, build_dim, forward_with_cfg
    from dimsum_torch.ops.selective_scan import selective_scan_cuda

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = DiM_models["DiM-L/2"](img_resolution=32, num_classes=1000,
                                use_attn_every_k_layers=4,
                                dtype=torch.float32)
    model = build_dim(cfg, "cuda", seed=0)
    g = torch.Generator(device="cuda").manual_seed(1)
    half = torch.randn((12, 4, 32, 32), generator=g, device="cuda")
    x = torch.cat([half, half])
    t = torch.rand(12, generator=g, device="cuda").repeat(2)
    y = torch.cat([torch.randint(0, 1000, (12,), generator=g, device="cuda"),
                   torch.full((12,), 1000, device="cuda")])
    with torch.inference_mode():
        selective_scan_cuda.launches = 0
        got = forward_with_cfg(model, x, t, y, cfg_scale=1.4)
        torch.cuda.synchronize()
        launches = selective_scan_cuda.launches
        for m in _mixers(model):
            m.scan_impl = "ref"
        want = forward_with_cfg(model, x, t, y, cfg_scale=1.4)
        torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    # fp32 scans differ by ~1e-6 relative (exp2 vs exp, sum order); 16
    # blocks of random weights amplify that, not past 1e-3 of the scale
    tol = 1e-3 * max(1.0, scale)
    rec = {"phase": "model", "model": "DiM-L/2", "rows": x.shape[0],
           "dtype": "float32", "tf32": False, "launches_per_forward":
           launches, "max_abs_err": err, "max_abs_ref": scale, "tol": tol,
           "finite": bool(torch.isfinite(got).all()),
           "n_mixers": len(_mixers(model))}
    emit(rec)
    if launches != 32 or not rec["finite"] or not err <= tol:
        raise AssertionError(f"model phase failed: {rec}")
    del model
    torch.cuda.empty_cache()


def phase_sample():
    import torch

    from dimsum_torch import bench
    from dimsum_torch.ops.selective_scan import selective_scan_cuda

    selective_scan_cuda.launches = 0
    record, samples = bench.run(batch=12, steps=STEPS, dtype="bf16",
                                cfg_scale=1.4, device="cuda", seed=0)
    torch.cuda.synchronize()
    launches = {"selective_scan_fwd": selective_scan_cuda.launches}
    finite = bool(torch.isfinite(samples).all())
    rec = {"phase": "sample", **record, "launches": launches,
           "shape": list(samples.shape), "finite": finite,
           "sample_std": samples.float().std().item()}
    emit(rec)
    # one warm-up drift call plus STEPS - 1 Euler steps, 32 mixers each
    if not finite or list(samples.shape) != [12, 4, 32, 32] \
            or launches["selective_scan_fwd"] != 32 * STEPS:
        raise AssertionError(f"sample phase failed: {rec}")
    return launches


def train_bounds(x, chunk, h0=False):
    """Least time of the two training kernels on x's shapes: each input
    read once and each output written once over HBM bandwidth, the fp32
    operations over the fp32 peak (the dt expansion's 2r over the bf16
    tensor-core peak for bf16 inputs), and the transcendentals over the
    special-function units (`_bound`).  Kernel 2: kernel 1's inputs, y
    (u's type), o and the states (fp32); 2r + 7N + 12 flop and N + 3
    transcendentals per (b, t, d), as kernel 1.  Kernel 3 (with its partial
    sums): u, dt_low, dt_w, A, B, C, bias, go and the states in, du, ddt
    (fp32) and dA, dB, dC out; 2r + 20N + 18 flop per (b, t, d) (replay:
    expansion, softplus, sigmoid, 5 per state; reverse step: 15 per state)
    and N + 3 transcendentals: an exp2 per state, exp and log in softplus,
    and the sigmoid's reciprocal (its exp is softplus's exp(-|x|)).  That
    kernel 3 computes each state's exp2 again in the reverse step, and the
    sigmoid's exp anew, and that kernel 2's state and main passes each
    compute every state's exp2 and hand dt over through o, are the
    kernels' own choices and not counted.  With `h0` kernel 2 also reads
    h0 and kernel 3 writes dh0, (batch, dim, N) fp32 each.  With a full
    "delta" in x (the delta entries) it is read in place of dt_low and dt_w,
    and there is no expansion."""
    batch, L, dim = x["u"].shape
    n = x["A"].shape[1]
    esize = x["u"].element_size()
    n_chunks = -(-L // chunk)
    big, small = batch * L * dim, batch * L * n
    dt_in = (x["delta"].numel() if "delta" in x
             else x["dt_low"].numel() + x["dt_w"].numel())
    common = (x["u"].numel() + dt_in
              + 2 * small) * esize + x["A"].numel() * 4 + dim * 4
    states = batch * n_chunks * n * dim * 4
    seed = batch * dim * n * 4 if h0 else 0
    fwd_bytes = (common + x["z"].numel() * esize + dim * 4  # z, D
                 + big * esize + big * 4 + states + seed)   # y, o, states
    bwd_bytes = (common + big * 4 + states                  # go, states
                 + 2 * big * 4 + dim * n * 4 + 2 * small * 4 + seed)
    out = {}
    for name, nbytes, (flops, tc), n_sfu in (
            ("fwd_train", fwd_bytes, _expansion_flops(x, 7 * n + 12),
             big * (n + 3)),
            ("bwd", bwd_bytes, _expansion_flops(x, 20 * n + 18),
             big * (n + 3))):
        out[name] = (*_bound(nbytes, flops, n_sfu, tc), nbytes, flops,
                     n_sfu, tc)
    return out


def _scaled_err(got, want):
    """Max |got - want| over max |want|, in fp32."""
    got, want = got.float(), want.float()
    return ((got - want).abs().max() / want.abs().max().clamp_min(1e-30)
            ).item()


def phase_kernel_train():
    import torch

    cases = [
        ("train-bf16", 16, 256, 1024, torch.bfloat16, False, False),
        ("train-bf16-reverse", 16, 256, 1024, torch.bfloat16, True, False),
        ("train-fp32", 16, 256, 1024, torch.float32, False, False),
        ("train-fp32-reverse", 16, 256, 1024, torch.float32, True, False),
        ("train-ragged-dim-bf16", 16, 256, 1000, torch.bfloat16, False,
         False),
        # the 512-px training mixer: the same tokens in 4 rows of L 1024
        ("L1024-bf16", 4, 1024, 1024, torch.bfloat16, False, False),
        ("L1024-fp32", 4, 1024, 1024, torch.float32, False, False),
        # a ragged last chunk and a ragged last group of chunks
        ("ragged-L-bf16", 4, 1000, 1024, torch.bfloat16, False, False),
        # --cond-init training: the h0 entries (h0 in, dh0 out)
        ("h0-bf16", 16, 256, 1024, torch.bfloat16, False, True),
        ("h0-fp32", 16, 256, 1024, torch.float32, False, True),
        ("h0-ragged-L-bf16", 4, 1000, 1024, torch.bfloat16, False, True),
    ]
    timed = ("train-bf16", "L1024-bf16", "h0-bf16")
    return {name: _train_case("kernel-train", name, (batch, L, dim, 16, 32),
                              dtype, reverse, seeded, i, name in timed)
            for i, (name, batch, L, dim, dtype, reverse, seeded)
            in enumerate(cases)}


def _train_case(phase, name, shape, dtype, reverse, seeded, i, timed,
                plain_timed=True, full_delta=False):
    """Kernels 2 and 3 (their h0 entries with `seeded`; their delta entries
    with `full_delta`, on delta = dt_low @ dt_w in `dtype`) against their
    plain versions on `scan_inputs(*shape)`, flipped along L with `reverse`
    (the Function flips around the kernels): every output's scaled error,
    each kernel's time (with `timed` also its device ms), the plain
    versions' (with `plain_timed`) and the bounds.  Raises if they
    disagree."""
    import torch

    from dimsum_torch.ops import selective_scan as ss

    batch, L, dim, n, r = shape
    x = scan_inputs(batch, L, dim, n, r, dtype, seed=200 + i)
    if reverse:  # the Function flips around the kernels
        x = {k: (v.flip(1) if v.ndim == 3 else v) for k, v in x.items()}
    if full_delta:
        x["delta"] = (x.pop("dt_low") @ x.pop("dt_w")).contiguous()
    args = ([x[k] for k in ("u", "delta")] + [None] if full_delta else
            [x[k] for k in ("u", "dt_low", "dt_w")]) + [
        x[k] for k in ("A", "B", "C", "D")]
    kw = dict(z=x["z"], delta_bias=x["delta_bias"], delta_softplus=True)
    if seeded:
        kw["h0"] = torch.randn(
            (batch, dim, n), device="cuda", generator=torch.Generator(
                device="cuda").manual_seed(100 + i))
    g = torch.randn(x["u"].shape, device="cuda", generator=torch
                    .Generator(device="cuda").manual_seed(i)).to(dtype)
    low = dtype == torch.bfloat16
    with torch.no_grad():
        got_f = ss.selective_scan_fwd_train_cuda(*args, **kw)
        want_f = ss.selective_scan_fwd_train_ref(*args, **kw)
        bkw = dict(kw, o=want_f[1], boundaries=want_f[2], g=g)
        got_b = ss.selective_scan_bwd(*args, **bkw)
        want_b = ss.selective_scan_bwd_ref(*args, **bkw)
        torch.cuda.synchronize()
        # relative to each tensor's largest value: fp32 1e-4 (exp2
        # against exp, summation order); outputs stored in bf16 1.6e-2
        # (one rounding step either way)
        errs, ok = {}, True
        for key, a, b in zip(
                ("y", "o", "boundaries", "du", "ddelta", "dA", "dB",
                 "dC", "dD", "dz", "dbias", "dh0"), got_f + got_b,
                want_f + want_b):
            tol = 1.6e-2 if a.dtype == torch.bfloat16 else 1e-4
            errs[key] = _scaled_err(a, b)
            ok = ok and bool(torch.isfinite(a.float()).all()) and \
                errs[key] <= tol
        fwd_err = max((a.float() - b.float()).abs().max().item()
                      for a, b in zip(got_f, want_f))
        bwd_err = max((a.float() - b.float()).abs().max().item()
                      for a, b in zip(got_b, want_b))
        go = torch.randn(x["u"].shape, device="cuda")
        core = (*args[:6], x["delta_bias"], True, go, want_f[2])
        ckw = dict(return_dh0=True) if seeded else {}
        fwd_ms = cuda_ms(lambda: ss.selective_scan_fwd_train_cuda(
            *args, **kw), iters=20)
        fwd_plain = (cuda_ms(lambda: ss.selective_scan_fwd_train_ref(
            *args, **kw), iters=3, warmup=1) if plain_timed else None)
        bwd_ms = cuda_ms(lambda: ss.selective_scan_bwd_core_cuda(
            *core, **ckw), iters=20)
        bwd_plain = (cuda_ms(lambda: ss.selective_scan_bwd_core_ref(
            *core, **ckw), iters=3, warmup=1) if plain_timed else None)
        fwd_dev = bwd_dev = None
        if timed:
            # kernel 2: its state and main passes, and above 32 states the
            # combine; kernel 3: its carry and main passes
            fwd_dev = device_ms(lambda: ss.selective_scan_fwd_train_cuda(
                *args, **kw), "selective_scan_fwd_train", kernels=2 + (n > 32))
            bwd_dev = device_ms(lambda: ss.selective_scan_bwd_core_cuda(
                *core, **ckw), "selective_scan_bwd", kernels=2)
    bounds = train_bounds(x, ss.TRAIN_CHUNK, seeded)
    rec = {"phase": phase, "case": name, "shape": list(shape),
           "dtype": str(dtype).split(".")[-1], "reverse": reverse,
           "h0": seeded, "full_delta": full_delta,
           "scaled_err": errs, "tol_fp32": 1e-4, "tol_bf16": 1.6e-2,
           "ok": ok, "low_precision_outputs": low,
           "fwd_train": {"max_abs_err": fwd_err, "ms": fwd_ms,
                         "device_ms": fwd_dev, "plain_ms": fwd_plain,
                         **_bound_fields(bounds["fwd_train"])},
           "bwd": {"max_abs_err": bwd_err, "ms": bwd_ms,
                   "device_ms": bwd_dev, "plain_ms": bwd_plain,
                   **_bound_fields(bounds["bwd"])}}
    emit(rec)
    if not ok:
        raise AssertionError(f"training kernels disagree on {name}")
    return rec


def _train_model(dtype, seed=0):
    from dimsum_torch.models.dim import DiM_models, build_dim

    cfg = DiM_models["DiM-L/2"](img_resolution=32, num_classes=1000,
                                use_attn_every_k_layers=4,
                                label_dropout=0.1, drop_path=0.1,
                                dtype=dtype)
    return build_dim(cfg, "cuda", seed=seed, train=True)


def phase_train_grad():
    import torch

    from dimsum_torch.ops import selective_scan as ss
    from dimsum_torch.transport import create_transport

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = _train_model(torch.float32)
    transport = create_transport("GVP", "velocity")
    g = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn((2, 4, 32, 32), generator=g, device="cuda")
    y = torch.randint(0, 1000, (2,), generator=g, device="cuda")

    def loss_and_grads():
        gen = torch.Generator(device="cuda").manual_seed(4)  # same draws
        model.zero_grad(set_to_none=True)
        loss = transport.training_losses(
            lambda xt, t, **kw: model(xt, t, train=True, generator=gen,
                                      **kw), x, gen, {"y": y})["loss"].mean()
        loss.backward()
        torch.cuda.synchronize()
        return loss.item(), {n: p.grad.clone() for n, p in
                             model.named_parameters() if p.grad is not None}

    counts = (ss.selective_scan_cuda, ss.selective_scan_fwd_train_cuda,
              ss.selective_scan_bwd_core_cuda)
    for c in counts:
        c.launches = 0
    loss, grads = loss_and_grads()
    launches = [c.launches for c in counts]
    for m in _mixers(model):
        m.scan_impl = "ref"
    want_loss, want = loss_and_grads()
    # fp32 kernels differ from the plain scan by ~1e-6 relative per call
    # (exp2 against exp, summation order); 16 blocks of random weights and
    # the backward amplify that, not past 2e-3 of each tensor's scale
    tol = 2e-3
    errs = {n: _scaled_err(grads[n], want[n]) for n in want}
    worst = max(errs, key=errs.get)
    rec = {"phase": "train-grad", "model": "DiM-L/2", "batch": 2,
           "dtype": "float32", "tf32": False, "loss": loss,
           "loss_plain": want_loss,
           "loss_rel_err": abs(loss - want_loss) / abs(want_loss),
           "n_grads": len(want), "same_grad_set": set(grads) == set(want),
           "worst_grad": worst, "worst_grad_scaled_err": errs[worst],
           "tol": tol, "launches_per_step": {
               "selective_scan_fwd": launches[0],
               "selective_scan_fwd_train": launches[1],
               "selective_scan_bwd": launches[2]}}
    emit(rec)
    if (launches != [0, 32, 32] or not rec["same_grad_set"]
            or not rec["loss_rel_err"] <= 1e-4 or not errs[worst] <= tol):
        raise AssertionError(f"train-grad phase failed: {rec}")
    del model, grads, want
    torch.cuda.empty_cache()


def _zeroed_scan_counts():
    """The three scan wrappers by name, their launch counts set to 0."""
    from dimsum_torch.ops import selective_scan as ss

    counts = {"selective_scan_fwd": ss.selective_scan_cuda,
              "selective_scan_fwd_train": ss.selective_scan_fwd_train_cuda,
              "selective_scan_bwd": ss.selective_scan_bwd_core_cuda}
    for c in counts.values():
        c.launches = 0
    ss.selective_scan_cuda.reverse_launches = 0
    return counts


def phase_train():
    import torch

    from dimsum_torch import train_bench

    counts = _zeroed_scan_counts()
    record, state = train_bench.run(batch=16, bf16=True, steps=TRAIN_STEPS,
                                    warmup=TRAIN_WARMUP, device="cuda",
                                    seed=0)
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counts.items()}
    init = dict(_train_model(torch.bfloat16, seed=0).named_parameters())
    # a parameter whose last gradient is well above Adam's eps must have
    # moved (a smaller one may move by less than its rounding); one out of
    # the graph (CondMamba's cond_proj), which the step gives a zero
    # gradient, must not at weight decay 0
    moved, wrong, no_grad, ema_moved = 0, [], [], 0
    for name, p in state.model.named_parameters():
        changed = not torch.equal(p, init[name])
        moved += changed
        ema_moved += not torch.equal(state.ema_params[name], init[name])
        if not p.grad.any():
            no_grad.append(name)
            if changed:
                wrong.append(name)
        elif not changed and p.grad.abs().max().item() > 1e-6:
            wrong.append(name)
    n_steps = TRAIN_STEPS + TRAIN_WARMUP
    finite = bool(all(math.isfinite(v) for v in
                      record["loss"] + record["grad_norm"]))
    rec = {"phase": "train", **record, "launches": launches,
           "params_moved": moved, "ema_moved": ema_moved,
           "n_param_tensors": len(init), "without_grad": len(no_grad),
           "wrong": wrong, "finite": finite}
    emit(rec)
    RESULTS["train"] = record
    if (not finite or launches["selective_scan_fwd"] != 0
            or launches["selective_scan_fwd_train"] != 32 * n_steps
            or launches["selective_scan_bwd"] != 32 * n_steps
            or wrong or len(no_grad) != 64
            or not all("cond_proj" in n for n in no_grad)
            or ema_moved < moved):
        raise AssertionError(f"train phase failed: {rec}")
    del state, init
    torch.cuda.empty_cache()
    return {k: launches[k] for k in ("selective_scan_fwd_train",
                                     "selective_scan_bwd")}


def phase_train_512():
    """The 512-px training path: `train_bench.run` at image_size 512 (L
    1024, batch 4, bf16 over fp32 weights), TRAIN_512_STEPS timed steps
    after one of warm-up.  Counts set to 0 just before and read just after:
    32 launches per step of kernels 2 and 3, none of kernel 1; finite
    losses and grad norms."""
    import torch

    from dimsum_torch import train_bench

    counts = _zeroed_scan_counts()
    record, state = train_bench.run(batch=4, bf16=True,
                                    steps=TRAIN_512_STEPS, warmup=1,
                                    device="cuda", seed=0, image_size=512)
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counts.items()}
    n_steps = TRAIN_512_STEPS + 1
    finite = bool(all(math.isfinite(v) for v in
                      record["loss"] + record["grad_norm"]))
    rec = {"phase": "train-512", **record, "launches": launches,
           "finite": finite}
    emit(rec)
    if (not finite or launches["selective_scan_fwd"] != 0
            or launches["selective_scan_fwd_train"] != 32 * n_steps
            or launches["selective_scan_bwd"] != 32 * n_steps):
        raise AssertionError(f"train-512 phase failed: {rec}")
    del state
    torch.cuda.empty_cache()


def attn_bound(B, L, H, Dh, dtype):
    """Least time for one full-block attention call: q, k, v read once and
    o written once over HBM bandwidth; 4 L^2 Dh flop per (batch, head) (the
    two products) over the tensor-core bf16 peak, or for fp32 the lesser
    of the fp32 peak and three TF32 tensor-core products (~fp32 accuracy)
    over the TF32 peak, so that the bound reads the same work whichever
    design runs it; and the L^2 exp per (batch, head) over the
    special-function units.  The largest bounds."""
    import torch

    esize = torch.tensor([], dtype=dtype).element_size()
    nbytes = 4 * B * L * H * Dh * esize
    flops = 4 * B * H * L * L * Dh
    n_exp = B * H * L * L
    if dtype == torch.bfloat16:
        t_flops = flops / BF16_TC_FLOP_PER_S
    else:
        t_flops = min(flops / FP32_FLOP_PER_S, 3 * flops / TF32_TC_FLOP_PER_S)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(t_flops, n_exp / SFU_EXP_PER_S) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), nbytes, flops, n_exp


def attn_inputs(B, L, H, Dh, dtype, seed, logit_scale=1.0):
    """q, k, v (B, L, H, Dh) as channel slices of one (B, L, 3 H Dh)
    N(0, 1) projection, the layout the modules give the kernel; q and k
    scaled by `logit_scale`."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn((B, L, 3 * H * Dh), generator=g, device="cuda")
    qkv[..., :2 * H * Dh] *= logit_scale
    qkv = qkv.to(dtype)
    return [qkv[..., i * H * Dh:(i + 1) * H * Dh].reshape(B, L, H, Dh)
            for i in range(3)]


def _first_attention_kernel(q, k, v, scale):
    """csrc/full_attention.cu, the first design, on Dh-64 and Dh-72 inputs,
    which the route sends to the Hopper redesigns (the sm90 kernel in
    bf16, the fp32 kernel in fp32): its body checked, and its time beside
    theirs and SDPA's on the same inputs in the same run (at Dh 72 the
    times before the redesign)."""
    import torch

    from dimsum_torch.ops.full_attention import full_attention_first

    out = torch.empty(q.shape, device=q.device, dtype=q.dtype)
    full_attention_first(q, k, v, out, scale)
    return out


def phase_kernel_attn():
    import torch
    import torch.nn.functional as F

    from dimsum_torch.ops import full_attention as attention_ops
    from dimsum_torch.ops.full_attention import (
        attention_kernel, full_attention_ref, full_block_attention,
        full_block_attention_cuda)

    cases = [
        ("dit-bf16", 24, 1024, 16, 64, torch.bfloat16),
        ("cross-bf16", 24, 1024, 8, 64, torch.bfloat16),
        ("dit-fp32", 24, 1024, 16, 64, torch.float32),
        ("cross-fp32", 24, 1024, 8, 64, torch.float32),
        # every 1152-wide model at 512 px, at the models-rest phase's CFG
        # batch of 8 rows: DiT-XL/2 and DiM-XL/2's DiT block (16 heads),
        # DiM-XL/2's cross fusion (8 heads on a 576-wide half)
        ("dh72-bf16", 8, 1024, 16, 72, torch.bfloat16),
        ("dh72-fp32", 8, 1024, 16, 72, torch.float32),
        ("dh72-cross-bf16", 8, 1024, 8, 72, torch.bfloat16),
        ("dh72-cross-fp32", 8, 1024, 8, 72, torch.float32),
    ]
    results = {}
    for i, (name, B, L, H, Dh, dtype) in enumerate(cases):
        q, k, v = attn_inputs(B, L, H, Dh, dtype, seed=300 + i)
        scale = Dh ** -0.5
        kernel = attention_kernel(dtype, Dh)
        counter = getattr(attention_ops, kernel)
        # relative to the output's largest value: fp32 2e-5 (the same fp32
        # products summed in other orders, exp2 against exp); bf16 1.6e-2
        # (P rounded to bf16 against the running row max in the kernel, the
        # final one in the plain version; bf16 output)
        tol = 2e-5 if dtype == torch.float32 else 1.6e-2
        with torch.inference_mode():
            before = counter.launches
            got = full_block_attention_cuda(q, k, v, scale).float()
            took_route = counter.launches - before == 1
            want = full_attention_ref(q, k, v, scale).float()
            torch.cuda.synchronize()
            scale_ref = want.abs().max().item()
            err = (got - want).abs().max().item()
            ok = (bool(torch.isfinite(got).all())
                  and err <= tol * scale_ref and took_route)
            ms = cuda_ms(lambda: full_block_attention_cuda(q, k, v, scale),
                         iters=50)
            dev_ms = device_ms(
                lambda: full_block_attention_cuda(q, k, v, scale),
                "full_block_attention")
            plain_ms = cuda_ms(lambda: full_attention_ref(q, k, v, scale),
                               iters=3, warmup=1)
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            library_ms = cuda_ms(
                lambda: F.scaled_dot_product_attention(qt, kt, vt),
                iters=50)
            library_dev_ms = device_ms(
                lambda: F.scaled_dot_product_attention(qt, kt, vt), None)
            # the first kernel (csrc/full_attention.cu), which Dh 80-128
            # still takes, held to the same tolerance and timed on the
            # same inputs
            s = torch.tensor(scale, dtype=dtype).item()
            got_first = _first_attention_kernel(q, k, v, s).float()
            torch.cuda.synchronize()
            first_err = (got_first - want).abs().max().item()
            ok = ok and first_err <= tol * scale_ref
            first = {"max_abs_err": first_err, "ms": cuda_ms(
                lambda: _first_attention_kernel(q, k, v, s), iters=10),
                "device_ms": device_ms(
                    lambda: _first_attention_kernel(q, k, v, s),
                    "full_block_attention", iters=5)}
            del got_first
        bound_ms, bound_by, nbytes, flops, n_exp = attn_bound(B, L, H, Dh,
                                                              dtype)
        rec = {"phase": "kernel-attn", "case": name, "shape": [B, L, H, Dh],
               "dtype": str(dtype).split(".")[-1], "kernel": kernel,
               "max_abs_err": err, "max_abs_ref": scale_ref, "tol_rel": tol,
               "ok": ok, "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
               "library_ms": library_ms, "library_device_ms": library_dev_ms,
               "bound_ms": bound_ms,
               "bound_by": bound_by, "bytes": nbytes, "flop": flops,
               "exp": n_exp, "tflop_per_s": flops / ms / 1e9,
               "first_kernel": first}
        emit(rec)
        if not ok:
            raise AssertionError(f"attention kernel disagrees on {name}")
        results[name] = rec
        del q, k, v, got, want
        torch.cuda.empty_cache()

    # logits of order 1e3 (q and k 40x N(0, 1)) at the DiT shape, Dh 64
    # and Dh 72: the softmax near one-hot, where a row's two largest logits
    # may nearly tie
    for i, (B, Dh, dtype) in enumerate((
            (24, 64, torch.float32), (24, 64, torch.bfloat16),
            (8, 72, torch.float32), (8, 72, torch.bfloat16))):
        q, k, v = attn_inputs(B, 1024, 16, Dh, dtype, seed=320 + i,
                              logit_scale=40.0)
        tol = 2e-5 if dtype == torch.float32 else 1.6e-2
        kernel = attention_kernel(dtype, Dh)
        counter = getattr(attention_ops, kernel)
        with torch.inference_mode():
            before = counter.launches
            got = full_block_attention_cuda(q, k, v, Dh ** -0.5).float()
            took_route = counter.launches - before == 1
            want = full_attention_ref(q, k, v, Dh ** -0.5).float()
            torch.cuda.synchronize()
        scale_ref = want.abs().max().item()
        err = (got - want).abs().max().item()
        rec = {"phase": "kernel-attn", "case": (
            f"{'dit' if Dh == 64 else 'dh72'}-{dtype}-logits40"
            .replace("torch.", "")), "shape": [B, 1024, 16, Dh],
               "kernel": kernel, "max_abs_err": err,
               "max_abs_ref": scale_ref, "tol_rel": tol}
        results[rec["case"]] = rec
        emit(rec)
        if not (bool(torch.isfinite(got).all()) and err <= tol * scale_ref
                and took_route):
            raise AssertionError(f"attention kernel disagrees: {rec}")
        del q, k, v, got, want
        torch.cuda.empty_cache()

    # the Function: kernel forward, backward recomputed through the plain
    # version; against autograd through the plain version alone
    grad = {}
    for dtype in (torch.float32, torch.bfloat16):
        leaves = [x.detach().requires_grad_(True) for x in
                  attn_inputs(2, 256, 2, 64, dtype, seed=310)]
        g = torch.randn(leaves[0].shape, device="cuda", generator=torch
                        .Generator(device="cuda").manual_seed(311)).to(dtype)
        before = full_block_attention_cuda.launches
        got = torch.autograd.grad(full_block_attention(*leaves, 0.125),
                                  leaves, g)
        launched = full_block_attention_cuda.launches - before
        want = torch.autograd.grad(full_attention_ref(*leaves, 0.125),
                                   leaves, g)
        torch.cuda.synchronize()
        tol = 2e-5 if dtype == torch.float32 else 1.6e-2
        errs = [_scaled_err(a, b) for a, b in zip(got, want)]
        grad[str(dtype).split(".")[-1]] = {"scaled_err": errs, "tol": tol,
                                           "launches": launched}
        if launched != 1 or not max(errs) <= tol:
            raise AssertionError(f"attention gradient disagrees: {grad}")
    emit({"phase": "kernel-attn", "case": "grad", "shape": [2, 256, 2, 64],
          **grad})
    return results


def _attention_modules(model):
    from dimsum_torch.models.attention import Attention, CrossAttentionFusion

    return [m for m in model.modules()
            if isinstance(m, (Attention, CrossAttentionFusion))]


ATTENTION_KERNELS = ("full_attention_sm90", "full_attention_f32",
                     "full_attention_first")


def _zeroed_attention_counts():
    """The scan kernel's, the attention route's and each attention
    kernel's launch counters, set to 0."""
    from dimsum_torch.ops import full_attention as attention_ops
    from dimsum_torch.ops.selective_scan import selective_scan_cuda

    counts = {"selective_scan_fwd": selective_scan_cuda,
              "full_block_attention": attention_ops.full_block_attention_cuda,
              **{n: getattr(attention_ops, n) for n in ATTENTION_KERNELS}}
    for c in counts.values():
        c.launches = 0
    return counts


def _attention_launches(calls, kernel, scan=32):
    """What `_zeroed_attention_counts` reads after `calls` drift calls of
    the 512-px model: `scan` scan and 36 attention launches each, all
    through the attention kernel `kernel`."""
    return {"selective_scan_fwd": scan * calls,
            "full_block_attention": 36 * calls,
            **{n: 36 * calls * (n == kernel) for n in ATTENTION_KERNELS}}


def phase_model_512():
    import torch

    from dimsum_torch.models.dim import DiM_models, build_dim, forward_with_cfg

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = DiM_models["DiM-L/2"](img_resolution=64, num_classes=1000,
                                use_attn_every_k_layers=4,
                                dtype=torch.float32)
    model = build_dim(cfg, "cuda", seed=0)
    g = torch.Generator(device="cuda").manual_seed(2)
    half = torch.randn((2, 4, 64, 64), generator=g, device="cuda")
    x = torch.cat([half, half])
    t = torch.rand(2, generator=g, device="cuda").repeat(2)
    y = torch.cat([torch.randint(0, 1000, (2,), generator=g, device="cuda"),
                   torch.full((2,), 1000, device="cuda")])
    with torch.inference_mode():
        counts = _zeroed_attention_counts()
        got = forward_with_cfg(model, x, t, y, cfg_scale=1.4)
        torch.cuda.synchronize()
        # fp32: every call through the fp32 kernel
        launches = {k: c.launches for k, c in counts.items()}
        for m in _mixers(model):
            m.scan_impl = "ref"
        for m in _attention_modules(model):
            m.attn_impl = "ref"
        want = forward_with_cfg(model, x, t, y, cfg_scale=1.4)
        torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    # fp32 kernels differ from the plain versions by ~1e-6 relative (exp2
    # against exp, summation order); 16 blocks of random weights amplify
    # that, not past 1e-3 of the scale
    tol = 1e-3 * max(1.0, scale)
    rec = {"phase": "model-512", "model": "DiM-L/2", "image_size": 512,
           "tokens": cfg.num_patches, "rows": x.shape[0], "dtype": "float32",
           "tf32": False, "launches_per_forward": launches,
           "max_abs_err": err, "max_abs_ref": scale, "tol": tol,
           "finite": bool(torch.isfinite(got).all()),
           "shape": list(got.shape)}
    emit(rec)
    if (launches != _attention_launches(1, "full_attention_f32")
            or not rec["finite"] or not err <= tol
            or rec["shape"] != [4, 4, 64, 64]):
        raise AssertionError(f"model-512 phase failed: {rec}")
    del model
    torch.cuda.empty_cache()


def _attention_without_rescale(q, k, v, sm_scale):
    """A faulty full-block attention, a control for model-512-bf16's
    tolerance: each 64-key tile's P taken against that tile's own row max
    and the tiles added without the rescale an online softmax owes them."""
    import torch

    qs = q * torch.tensor(sm_scale, dtype=q.dtype, device=q.device)
    qt, kt, vt = (t.transpose(1, 2).float() for t in (qs, k, v))
    s = torch.matmul(qt, kt.transpose(-1, -2)).unflatten(-1, (-1, 64))
    p = torch.exp(s - s.amax(-1, keepdim=True)).flatten(-2)
    o = torch.matmul(p.to(v.dtype).float(), vt) / p.sum(-1, keepdim=True)
    return o.to(q.dtype).transpose(1, 2)


def _attention_last_tile_dropped(q, k, v, sm_scale):
    """The other control: the plain attention over all keys but the last
    64, what a key loop that stops one tile short computes."""
    from dimsum_torch.ops.full_attention import full_attention_ref

    return full_attention_ref(q, k[:, :-64], v[:, :-64], sm_scale)


# model-512-bf16's limits, relative to the largest value of what they
# compare, from the phase's readings on an H100 (PERF.md section 6).  The
# seeded weights give near-uniform attention (logit spread 0.38), where a
# faulty attention reads no worse than bf16 rounding (end to end 0.0092
# against 0.0086 sound); the q and k projections are therefore scaled by
# QK_GAIN 4 (spread 6.1, peaked as a trained model's).  There: end to end,
# sound 0.0082-0.0112 and the faulty attentions at least 0.054; per call
# (each of the 36 calls, kernel against plain version on the inputs the
# model gave it), sound at most 0.0074 and faulty at least 0.34.
MODEL_512_BF16_TOL = 2.5e-2
MODEL_512_BF16_CALL_TOL = 1.6e-2  # the kernel tolerance
MODEL_512_BF16_SEEDS = (2, 3, 4)
MODEL_512_BF16_QK_GAIN = 4.0


def _sharpen_attention(model, gain):
    """Multiply the q and k projections of every attention module by `gain`
    (a power of two, exact in bf16): its logits by gain^2."""
    import torch

    from dimsum_torch.models.attention import Attention

    with torch.no_grad():
        for m in _attention_modules(model):
            lins = [m.qkv] if isinstance(m, Attention) else [m.qkv1, m.qkv2]
            for lin in lins:
                rows = 2 * lin.weight.shape[0] // 3
                lin.weight[:rows] *= gain
                if lin.bias is not None:
                    lin.bias[:rows] *= gain


def phase_model_512_bf16(qk_gain=MODEL_512_BF16_QK_GAIN):
    """The bf16 512-px CFG forward, the sampling path's own dtype, through
    the sm90 attention kernel and through the plain attention; the scan
    kernel runs on both sides, so only the attention differs.  Three seeds
    of inputs, the attention sharpened by `qk_gain`.  In the kernel's
    forward each attention call is also held against the plain version on
    the strided q, k, v the model gave it, and two faulty attentions on the
    same inputs and through the whole forward show that both limits catch
    them."""
    import torch

    from dimsum_torch.models import attention
    from dimsum_torch.models.dim import DiM_models, build_dim, forward_with_cfg
    from dimsum_torch.ops.full_attention import full_attention_ref

    cfg = DiM_models["DiM-L/2"](img_resolution=64, num_classes=1000,
                                use_attn_every_k_layers=4,
                                dtype=torch.bfloat16)
    model = build_dim(cfg, "cuda", seed=0)
    _sharpen_attention(model, qk_gain)
    kernel_attention = attention.full_block_attention
    controls = {"no_rescale": _attention_without_rescale,
                "last_tile_dropped": _attention_last_tile_dropped}

    def rel_err(got, want):
        return (got.float() - want).abs().max() / want.abs().max()

    calls = []

    def checked_attention(q, k, v, sm_scale):
        out = kernel_attention(q, k, v, sm_scale)
        want = full_attention_ref(q, k, v, sm_scale).float()
        logits = torch.einsum("lhd,mhd->hlm", q[0].float(), k[0].float())
        calls.append(torch.stack(
            [rel_err(out, want)] + [rel_err(fn(q, k, v, sm_scale), want)
                                    for fn in controls.values()]
            + [(logits * sm_scale).std()]))
        return out

    def forward_through(fn, x, t, y):
        attention.full_block_attention = fn
        try:
            return forward_with_cfg(model, x, t, y, cfg_scale=1.4).float()
        finally:
            attention.full_block_attention = kernel_attention

    readings, finite, shape = [], True, None
    with torch.inference_mode():
        for seed in MODEL_512_BF16_SEEDS:
            g = torch.Generator(device="cuda").manual_seed(seed)
            half = torch.randn((2, 4, 64, 64), generator=g, device="cuda")
            x = torch.cat([half, half])
            t = torch.rand(2, generator=g, device="cuda").repeat(2)
            y = torch.cat([
                torch.randint(0, 1000, (2,), generator=g, device="cuda"),
                torch.full((2,), 1000, device="cuda")])
            calls.clear()
            counters = _zeroed_attention_counts()
            got = forward_through(checked_attention, x, t, y)
            torch.cuda.synchronize()
            counts = {k: c.launches for k, c in counters.items()}
            # over the calls: (kernel, faulty..., logit spread) columns
            call_max = torch.stack(calls).amax(0).tolist()
            call_min = torch.stack(calls).amin(0).tolist()
            finite = finite and bool(torch.isfinite(got).all())
            shape = list(got.shape)
            want = forward_through(full_attention_ref, x, t, y)
            scale = want.abs().max().item()
            reading = {"seed": seed, "launches": counts, "max_abs_ref": scale,
                       "calls": len(calls),
                       "rel_err": (got - want).abs().max().item() / scale,
                       "call_max_rel_err": call_max[0],
                       # how peaked the attention is: the spread of the
                       # first row's logits, the largest over the calls
                       "call_max_logit_std": call_max[-1]}
            for i, name in enumerate(controls):
                bad = forward_through(controls[name], x, t, y)
                reading[f"{name}_rel_err"] = \
                    (bad - want).abs().max().item() / scale
                reading[f"call_{name}_least_rel_err"] = call_min[1 + i]
            readings.append(reading)
    worst = max(r["rel_err"] for r in readings)
    control = min(r[f"{name}_rel_err"] for r in readings for name in controls)
    call_worst = max(r["call_max_rel_err"] for r in readings)
    call_control = min(r[f"call_{name}_least_rel_err"] for r in readings
                       for name in controls)
    rec = {"phase": "model-512-bf16", "model": "DiM-L/2", "image_size": 512,
           "tokens": cfg.num_patches, "rows": 4, "dtype": "bfloat16",
           "qk_gain": qk_gain, "readings": readings, "max_rel_err": worst,
           "least_control_rel_err": control, "tol_rel": MODEL_512_BF16_TOL,
           "call_max_rel_err": call_worst,
           "call_least_control_rel_err": call_control,
           "call_tol_rel": MODEL_512_BF16_CALL_TOL, "finite": finite,
           "shape": shape}
    emit(rec)
    if (any(r["launches"] != _attention_launches(1, "full_attention_sm90")
            or r["calls"] != 36 for r in readings)
            or not finite or not worst <= MODEL_512_BF16_TOL
            or not control > MODEL_512_BF16_TOL
            or not call_worst <= MODEL_512_BF16_CALL_TOL
            or not call_control > MODEL_512_BF16_CALL_TOL
            or shape != [4, 4, 64, 64]):
        raise AssertionError(f"model-512-bf16 phase failed: {rec}")
    del model
    torch.cuda.empty_cache()


def phase_sample_512():
    import torch

    from dimsum_torch import bench

    counts = _zeroed_attention_counts()
    record, samples = bench.run(batch=12, steps=STEPS, dtype="bf16",
                                cfg_scale=1.4, device="cuda", seed=0,
                                image_size=512)
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counts.items()}
    finite = bool(torch.isfinite(samples).all())
    rec = {"phase": "sample-512", **record, "launches": launches,
           "shape": list(samples.shape), "finite": finite,
           "sample_std": samples.float().std().item()}
    emit(rec)
    # one warm-up drift call plus STEPS - 1 Euler steps
    if (not finite or list(samples.shape) != [12, 4, 64, 64]
            or launches != _attention_launches(STEPS, "full_attention_sm90")):
        raise AssertionError(f"sample-512 phase failed: {rec}")
    return launches


def state_bound(x, h0: bool, last: bool):
    """Least time for one call of the state entry: as `scan_bound`, with
    the full delta read in place of dt_low and dt_w (no 2r expansion
    flops), and h0 read and the last state written, fp32 (batch, dim, N),
    where the call takes them."""
    batch, L, dim = x["u"].shape
    n = x["A"].shape[1]
    nbytes = sum(v.numel() * v.element_size() for v in x.values())
    nbytes += x["u"].numel() * x["u"].element_size()  # the output
    nbytes += (int(h0) + int(last)) * batch * dim * n * 4
    flops = batch * L * dim * (7 * n + 12)
    n_sfu = batch * L * dim * (n + 3)
    return (*_bound(nbytes, flops, n_sfu), nbytes, flops, n_sfu)


def state_inputs(batch, L, dim, n, dtype, seed):
    """`scan_inputs` with the full delta = dt_low @ dt_w in `dtype`, as
    the sequence-parallel mixer makes it, and an fp32 h0 (batch, dim, n)."""
    import torch

    x = scan_inputs(batch, L, dim, n, 32, dtype, seed)
    x["delta"] = (x.pop("dt_low") @ x.pop("dt_w")).contiguous()
    h0 = torch.randn((batch, dim, n), device="cuda", generator=torch
                     .Generator(device="cuda").manual_seed(seed + 1))
    return x, h0


def phase_kernel_state():
    import torch

    from dimsum_torch.ops.selective_scan import (selective_scan_state,
                                                 selective_scan_state_cuda)

    cases = [
        ("sp-bf16", 8, 256, 1024, torch.bfloat16),
        ("sp-fp32", 8, 256, 1024, torch.float32),
        ("ragged-bf16", 8, 250, 1000, torch.bfloat16),
    ]
    results = {}
    for i, (name, batch, L, dim, dtype) in enumerate(cases):
        x, h0 = state_inputs(batch, L, dim, 16, dtype, seed=700 + 2 * i)
        args = [x[k] for k in ("u", "delta", "A", "B", "C", "D")]
        kw = dict(z=x["z"], delta_bias=x["delta_bias"], delta_softplus=True)
        # the first SP pass (the port of _scan_kernel_with_state): zero
        # state in, the last state out; the second: seeded from h0
        first = dict(kw, return_last_state=True)
        second = dict(kw, h0=h0)
        with torch.inference_mode():
            y1, last = selective_scan_state_cuda(*args, **first)
            y2 = selective_scan_state_cuda(*args, **second)
            w1, w_last = selective_scan_state(*args, impl="ref", **first)
            w2 = selective_scan_state(*args, impl="ref", **second)
            torch.cuda.synchronize()
            # the outputs as phase kernel's; the fp32 last state, never
            # rounded to bf16, to 1e-4 of its scale in both dtypes
            tol = 1e-4 if dtype == torch.float32 else 1.6e-2
            errs = [(a.float() - b.float()).abs() for a, b in
                    ((y1, w1), (y2, w2))]
            ok = all(bool(torch.isfinite(a).all()) and bool(
                (e <= tol + tol * b.float().abs()).all())
                for a, b, e in ((y1, w1, errs[0]), (y2, w2, errs[1])))
            state_err = _scaled_err(last, w_last)
            ok = ok and state_err <= 1e-4
            main = name != "ragged-bf16"
            ms = cuda_ms(lambda: selective_scan_state_cuda(*args, **first),
                         iters=50)
            h0_ms = cuda_ms(lambda: selective_scan_state_cuda(
                *args, **second), iters=50)
            dev_ms = (device_ms(lambda: selective_scan_state_cuda(
                *args, **first), "selective_scan") if main else None)
            h0_dev_ms = (device_ms(lambda: selective_scan_state_cuda(
                *args, **second), "selective_scan") if main else None)
            plain_ms = cuda_ms(lambda: selective_scan_state(
                *args, impl="ref", **first), iters=3, warmup=1)
        bound = state_bound(x, h0=False, last=True)
        rec = {"phase": "kernel-state", "case": name,
               "shape": [batch, L, dim, 16], "dtype": str(dtype).split(".")[-1],
               "max_abs_err": max(e.max().item() for e in errs),
               "max_abs_ref": max(w1.abs().max().item(),
                                  w2.abs().max().item()),
               "tol": tol, "last_state_scaled_err": state_err,
               "last_state_tol": 1e-4, "ok": ok, "ms": ms,
               "device_ms": dev_ms, "plain_ms": plain_ms,
               **_bound_fields(bound), "h0_ms": h0_ms,
               "h0_device_ms": h0_dev_ms,
               "h0_bound_ms": state_bound(x, h0=True, last=False)[0]}
        emit(rec)
        if not ok:
            raise AssertionError(f"state kernel disagrees with plain on "
                                 f"{name}: {rec}")
        results[name] = rec
    return results


# sample-sp-512: ranks on the one card (gloo: NCCL refuses two ranks on
# one device), images (CFG rows 2x), Euler grid points, seconds for the
# process group's collectives and for the whole group of ranks
SP_RANKS, SP_BATCH, SP_STEPS = 4, 4, 4
SP_TIMEOUT, SP_DEADLINE = 300, 480
# scaled errors against the unsharded model on the card.  fp32: only the
# order of the scan's fp32 sums differs (the two-level fold across shards;
# phase model's 16 random blocks amplify ~1e-6 to not past 1e-3, and here
# the fold alone moves ~1e-7).  bf16 (a few Euler steps): the SP mixer
# materializes dt = dt_low @ dt_w in bf16, as the JAX package does
# (mamba.py:252), where the unsharded kernel expands it in fp32; on the
# small DiM that rounding moves the forward 1.5e-2 of scale against a 5e-2
# limit (tests/test_torch_dim.py::test_bf16_dim_forward_tracks_jax).
SP_512_FP32_TOL, SP_512_BF16_TOL = 1e-4, 5e-2


def _sp_counts(zero: bool = False):
    from dimsum_torch.ops import full_attention as attention_ops
    from dimsum_torch.ops.selective_scan import (selective_scan_cuda,
                                                 selective_scan_state_cuda)

    fns = {"selective_scan_fwd_state": selective_scan_state_cuda,
           "selective_scan_fwd": selective_scan_cuda,
           "full_block_attention": attention_ops.full_block_attention_cuda,
           **{n: getattr(attention_ops, n) for n in ATTENTION_KERNELS}}
    if zero:
        for fn in fns.values():
            fn.launches = 0
    return {k: fn.launches for k, fn in fns.items()}


def _sp_rank(rank, k, port, out_dir):
    """One rank of sample-sp-512 (a process of its own on the one card);
    writes its record to out_dir/rank<rank>.json."""
    import datetime
    import os

    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group(
        "gloo", init_method=f"tcp://localhost:{port}", world_size=k,
        rank=rank, timeout=datetime.timedelta(seconds=SP_TIMEOUT))
    try:
        rec = _sp_rank_run(rank, k)
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(rec, f)
    finally:
        dist.destroy_process_group()


def _sp_rank_run(rank, k):
    import torch
    import torch.distributed as dist

    from dimsum_torch.models.dim import DiM_models, build_dim, forward_with_cfg
    from dimsum_torch.models.mamba import Mamba
    from dimsum_torch.parallel import make_seq_group
    from dimsum_torch.transport import Sampler, create_transport

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    group = make_seq_group(1, k).seq

    # every all_gather of this rank counted; with `timed` set, timed from
    # a synchronized device to the gathered result on it, by kind: a mixer
    # gathers the conv's halos, the scan's summaries and its output, in
    # that order
    kinds = ("halos", "summaries", "outputs")
    gathers = {"calls": 0, "timed": False,
               "seconds": dict.fromkeys(kinds, 0.0)}
    real = dist.all_gather

    def counted(parts, x, group=None):
        kind = kinds[gathers["calls"] % 3]
        gathers["calls"] += 1
        if not gathers["timed"]:
            return real(parts, x, group=group)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(parts, x, group=group)
        torch.cuda.synchronize()
        gathers["seconds"][kind] += time.perf_counter() - t0
        return out

    dist.all_gather = counted

    def model_for(dtype):
        # the seeded weights of sample-512 (bench.run at image_size 512)
        cfg = DiM_models["DiM-L/2"](img_resolution=64, num_classes=1000,
                                    use_attn_every_k_layers=4, dtype=dtype,
                                    seq_group=group)
        return build_dim(cfg, "cuda", seed=0)

    def sharded(model, on):
        for m in model.modules():
            if isinstance(m, Mamba):
                m.seq_group = group if on else None

    g = torch.Generator(device="cuda").manual_seed(0)
    half = torch.randn((SP_BATCH, 4, 64, 64), generator=g, device="cuda")
    z = torch.cat([half, half])
    y = torch.cat([
        torch.randint(0, 1000, (SP_BATCH,), generator=g, device="cuda"),
        torch.full((SP_BATCH,), 1000, device="cuda")])
    t = torch.rand(SP_BATCH, generator=g, device="cuda").repeat(2)
    rec = {"rank": rank}

    # (i) one fp32 CFG drift call, TF32 off, against the unsharded forward
    model = model_for(torch.float32)
    with torch.inference_mode():
        _sp_counts(zero=True)
        got = forward_with_cfg(model, z, t, y, cfg_scale=1.4)
        torch.cuda.synchronize()
        rec["fp32_launches"] = _sp_counts()
        rec["fp32_finite"] = bool(torch.isfinite(got).all())
        if rank == 0:
            sharded(model, False)
            want = forward_with_cfg(model, z, t, y, cfg_scale=1.4)
            rec["fp32_scaled_err"] = _scaled_err(got, want)
            rec["fp32_max_abs_ref"] = want.abs().max().item()
    del model, got
    torch.cuda.empty_cache()
    dist.barrier()

    # (ii) a few bf16 Euler steps with CFG 1.4 against the unsharded run
    model = model_for(torch.bfloat16)
    sampler = Sampler(create_transport("GVP", "velocity"))

    def model_fn(x, t, y=None):
        return forward_with_cfg(model, x, t, y, cfg_scale=1.4)

    def sample(steps):
        return sampler.sample_ode(sampling_method="euler",
                                  num_steps=steps)(z, model_fn, y=y)

    with torch.inference_mode():
        sample(2)  # one untimed drift call
        torch.cuda.synchronize()
        dist.barrier()
        _sp_counts(zero=True)
        t0 = time.perf_counter()
        out = sample(SP_STEPS)
        torch.cuda.synchronize()
        rec["seconds"] = time.perf_counter() - t0
        rec["launches"] = _sp_counts()
        rec["finite"] = bool(torch.isfinite(out).all())
        rec["shape"] = list(out[:SP_BATCH].shape)
        # one more drift call with every all_gather timed between
        # synchronizations: the collectives' share of a call
        calls0 = gathers["calls"]
        gathers["timed"] = True
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model_fn(z, t, y)
        torch.cuda.synchronize()
        rec["timed_call_seconds"] = time.perf_counter() - t0
        rec["gather_seconds"] = gathers["seconds"]
        rec["gathers_per_call"] = gathers["calls"] - calls0
        gathers["timed"] = False
        dist.barrier()
        if rank == 0:
            # the unsharded run, alone on the card (the other ranks wait)
            sharded(model, False)
            sample(2)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want = sample(SP_STEPS)
            torch.cuda.synchronize()
            rec["unsharded_seconds"] = time.perf_counter() - t0
            rec["bf16_scaled_err"] = _scaled_err(out, want)
            rec["bf16_max_abs_ref"] = want.float().abs().max().item()
    dist.barrier()
    return rec


def phase_sample_sp_512():
    """sample-sp-512: DiM-L/2 at 512 px sequence-parallel over SP_RANKS
    ranks, processes on the one card joined by gloo, every mixer's conv
    and scan split along L (256 of the 1024 tokens a rank)."""
    import os
    import socket
    import tempfile

    import torch
    import torch.multiprocessing as mp

    from dimsum_torch.ops import cuda_build

    phase_t0 = time.perf_counter()
    cuda_build.build()  # here, not in each rank
    torch.cuda.empty_cache()
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        ctx = mp.start_processes(_sp_rank, args=(SP_RANKS, port, tmp),
                                 nprocs=SP_RANKS, join=False,
                                 start_method="spawn")
        try:
            while not ctx.join(timeout=5):
                if time.perf_counter() - t0 > SP_DEADLINE:
                    raise TimeoutError(f"sample-sp-512: ranks still running "
                                       f"after {SP_DEADLINE} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
                    p.join(10)
        group_seconds = time.perf_counter() - t0
        recs = []
        for r in range(SP_RANKS):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                recs.append(json.load(f))
    calls = SP_STEPS - 1
    # the bf16 steps through the sm90 kernel, the fp32 call through the
    # fp32 kernel; every scan through the state entry
    want = {"selective_scan_fwd_state": 2 * 32 * calls,
            **_attention_launches(calls, "full_attention_sm90", scan=0)}
    want_fp32 = {"selective_scan_fwd_state": 2 * 32,
                 **_attention_launches(1, "full_attention_f32", scan=0)}
    r0 = recs[0]
    seconds = max(r["seconds"] for r in recs)
    share = {kind: max(r["gather_seconds"][kind] / r["timed_call_seconds"]
                       for r in recs) for kind in recs[0]["gather_seconds"]}
    rec = {"phase": "sample-sp-512", "model": "DiM-L/2", "image_size": 512,
           "ranks": SP_RANKS, "backend": "gloo", "batch": SP_BATCH,
           "rows": 2 * SP_BATCH, "steps": SP_STEPS, "cfg_scale": 1.4,
           "fp32_scaled_err": r0["fp32_scaled_err"],
           "fp32_tol": SP_512_FP32_TOL,
           "bf16_scaled_err": r0["bf16_scaled_err"],
           "bf16_tol": SP_512_BF16_TOL,
           "launches": [r["launches"] for r in recs],
           "fp32_launches": [r["fp32_launches"] for r in recs],
           "seconds": seconds, "seconds_per_call": seconds / calls,
           "unsharded_seconds_per_call": r0["unsharded_seconds"] / calls,
           "gathers_per_call": r0["gathers_per_call"],
           "timed_call_seconds": [r["timed_call_seconds"] for r in recs],
           "gather_share": max(sum(r["gather_seconds"].values())
                               / r["timed_call_seconds"] for r in recs),
           "gather_share_by_kind": share,
           "group_seconds": group_seconds,
           "finite": all(r["finite"] and r["fp32_finite"] for r in recs),
           "shape": r0["shape"]}
    emit(rec)
    if (not rec["finite"] or rec["shape"] != [SP_BATCH, 4, 64, 64]
            or not rec["fp32_scaled_err"] <= SP_512_FP32_TOL
            or not rec["bf16_scaled_err"] <= SP_512_BF16_TOL
            or any(r["launches"] != want for r in recs)
            or any(r["fp32_launches"] != want_fp32 for r in recs)
            or rec["gathers_per_call"] != 3 * 32):
        raise AssertionError(f"sample-sp-512 phase failed: {rec}")
    return r0["launches"]


def norm_bound(numel, rows, d, esize, flags):
    """Least time for one add + norm or norm + modulate call: each input
    read once and each output written once over HBM bandwidth, against the
    fp32 operations per value (2 for the moment, 2 to normalize, 2 more for
    LayerNorm's centred variance, 1 for each present gate, branch, residual,
    weight and bias, 3 for the modulation) over the fp32 peak.  `flags`
    maps each operand to its element size in bytes (absent: 0)."""
    per_row = sum(flags.get(k, 0) for k in ("branch", "res", "total"))
    per_batch = sum(flags.get(k, 0) for k in ("gate", "shift", "scale"))
    per_chan = flags.get("w", 0) + flags.get("b", 0)
    nbytes = (numel * (2 * esize + per_row) + rows * per_batch * d
              + per_chan * d)
    ops = 4 + 2 * (not flags["rms"]) + sum(
        1 for k in ("branch", "gate", "res", "w", "b") if flags.get(k)) + (
        3 if flags.get("shift") else 0)
    flops = numel * ops
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), nbytes, flops


# (name, has_branch, has_gate, has_res, has_mod, is_rms, has_w): the norm +
# modulate call sites of the fused-kernel configuration
NORM_SITES = (
    ("norm_2", True, True, False, True, True, True),
    ("dit-h2", True, True, False, True, False, False),
    ("dit-h1-final", False, False, False, True, False, False),
    ("deferred-top", True, True, True, False, True, True),
)


def norm_case_inputs(B, L, D, dtype, seed):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)

    def r(*shape, s=1.0):
        return s * torch.randn(shape, generator=g, device="cuda")

    v = dict(x=r(B, L, D), branch=r(B, L, D), residual=r(B, L, D),
             gate=r(B, D, s=0.5), shift=r(B, D, s=0.3), scale=r(B, D, s=0.3),
             weight=1 + r(D, s=0.1), bias=r(D, s=0.1))
    fp32 = ("residual", "weight", "bias")
    return {k: (t if k in fp32 else t.to(dtype)) for k, t in v.items()}


def _case_record(name, dtype, shape, got, want, tols, ms, plain_ms, bound):
    """One kernel case: each output's max error against the plain
    version's, within its tolerance relative to that output's largest
    value; the kernel and plain times; the bound."""
    import torch

    errs, ok = [], True
    for a, b, tol in zip(got, want, tols):
        err = (a.float() - b.float()).abs().max().item()
        scale = b.float().abs().max().item()
        errs.append(err)
        ok = ok and bool(torch.isfinite(a.float()).all()) and \
            err <= tol * max(scale, 1e-30)
    return {"case": name, "shape": shape,
            "dtype": str(dtype).split(".")[-1], "max_abs_err": max(errs),
            "errs_out_total": errs, "tol_rel": tols, "ok": ok, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound[0],
            "bound_by": bound[1], "bytes": bound[2], "flop": bound[3]}


# the 512-px cases (L 1024) of the two sites with gate, shift and scale
NORM_SITES_L1024 = ("norm_2", "dit-h2")
# bytes written between launches for the L2-cold reading (the L2 is 50 MB)
L2_FLUSH_BYTES = 128 * 2**20


def _norm_site_record(site, v, dtype, low, flush=None, bf16_res=False):
    """One norm + modulate site on the inputs `v`: the kernel against its
    plain version, `cuda_ms`, `device_ms`, the plain time and the bound; with
    `flush` (a tensor), also `cold_device_ms`: the kernel's device time when
    `flush` is written before each launch, so that its inputs and outputs
    come from device memory and not from the L2.  `bf16_res`: the residual
    and the total in x's dtype (the bf16 residual stream)."""
    import torch

    from dimsum_torch.ops.norms import norm_modulate_cuda, norm_modulate_ref

    name, br, gt, res, mod, rms, w = site
    B, L, D = v["x"].shape
    esize = v["x"].element_size()
    residual = v["residual"].to(dtype) if bf16_res else v["residual"]
    kw = dict(weight=v["weight"] if w else None,
              bias=v["bias"] if w and not rms else None,
              branch=v["branch"] if br else None,
              gate=v["gate"] if gt else None,
              residual=residual if res else None,
              shift=v["shift"] if mod else None,
              scale=v["scale"] if mod else None,
              eps=1e-5 if rms else 1e-6, is_rms=rms,
              total_dtype=torch.float32 if res and not bf16_res else None)
    with torch.inference_mode():
        got = norm_modulate_cuda(v["x"], **kw)
        want = norm_modulate_ref(v["x"], **kw)
        torch.cuda.synchronize()
        ms = cuda_ms(lambda: norm_modulate_cuda(v["x"], **kw), iters=20)
        dev_ms = device_ms(lambda: norm_modulate_cuda(v["x"], **kw),
                           "norm_modulate")
        cold_ms = None if flush is None else device_ms(
            lambda: (flush.add_(1), norm_modulate_cuda(v["x"], **kw)),
            "norm_modulate")
        plain_ms = cuda_ms(lambda: norm_modulate_ref(v["x"], **kw), iters=5)
    res_size = esize if bf16_res else 4
    tot_size = res_size if res else esize
    bound = norm_bound(B * L * D, B, D, esize, dict(
        branch=esize * br, gate=esize * gt, res=res_size * res,
        shift=esize * mod, scale=esize * mod, w=4 * w,
        b=4 * (w and not rms), total=tot_size, rms=rms))
    rec = _case_record(name, dtype, [B, L, D], got, want,
                       (low, 1e-5 if res and not bf16_res else low), ms,
                       plain_ms, bound)
    rec["device_ms"] = dev_ms
    rec["residual_dtype"] = str(residual.dtype).split(".")[-1]
    if flush is not None:
        rec["cold_device_ms"] = cold_ms
    emit({"phase": "kernel-norm", "kernel": "norm_modulate", **rec})
    if not rec["ok"]:
        raise AssertionError(f"norm_modulate kernel disagrees: {rec}")
    return rec


def _add_norm_bf16_residual(v, B, L, D, low):
    """add + norm on a bf16 residual with its total rounded to bf16, the
    case of the bf16 residual stream (residual_in_fp32=False): the kernel
    against its plain version, its times and its bound (x, res, out and
    total, 2 bytes each)."""
    import torch

    from dimsum_torch.ops.norms import add_norm_cuda, add_norm_ref

    bf16 = torch.bfloat16
    x2 = v["x"].reshape(-1, D)
    r2 = v["residual"].reshape(-1, D).to(bf16)
    args = (x2, r2, v["weight"], None, 1e-5, True, bf16)
    with torch.inference_mode():
        got = add_norm_cuda(*args)
        want = add_norm_ref(*args[:6], bf16, bf16)
        torch.cuda.synchronize()
        exact = torch.equal(got[1], want[1])
        ms = cuda_ms(lambda: add_norm_cuda(*args), iters=20)
        dev_ms = device_ms(lambda: add_norm_cuda(*args), "add_norm")
        plain_ms = cuda_ms(lambda: add_norm_ref(*args[:6], bf16, bf16),
                           iters=5)
    bound = norm_bound(B * L * D, B, D, 2, dict(res=2, total=2, w=4,
                                                rms=True))
    rec = _case_record("add_norm-bf16-residual", bf16, [B, L, D], got, want,
                       (low, 0.0), ms, plain_ms, bound)
    rec.update(device_ms=dev_ms, residual_dtype="bfloat16",
               total_bit_for_bit=exact)
    emit({"phase": "kernel-norm", "kernel": "add_norm", **rec})
    if not (rec["ok"] and exact):
        raise AssertionError(f"add_norm bf16-residual case disagrees: {rec}")
    return rec


def phase_kernel_norm():
    import torch

    from dimsum_torch.ops.norms import add_norm_cuda, add_norm_ref

    B, L, D = 24, 256, 1024
    results = {"add_norm": {}, "norm_modulate": {}}
    flush = torch.zeros(L2_FLUSH_BYTES // 4, device="cuda")
    for i, dtype in enumerate((torch.bfloat16, torch.float32)):
        esize = torch.tensor([], dtype=dtype).element_size()
        # relative to each output's largest value: fp32 1e-5 (rsqrt and
        # summation order); stored in bf16 1.6e-2 (one rounding step)
        low = 1.6e-2 if dtype == torch.bfloat16 else 1e-5
        v = norm_case_inputs(B, L, D, dtype, seed=400 + i)
        x2 = v["x"].reshape(-1, D)
        r2 = v["residual"].reshape(-1, D)
        with torch.inference_mode():
            args = (x2, r2, v["weight"], None, 1e-5, True)
            got = add_norm_cuda(*args)
            want = add_norm_ref(*args, dtype)
            torch.cuda.synchronize()
            ms = cuda_ms(lambda: add_norm_cuda(*args), iters=20)
            dev_ms = device_ms(lambda: add_norm_cuda(*args), "add_norm")
            plain_ms = cuda_ms(lambda: add_norm_ref(*args, dtype), iters=5)
        bound = norm_bound(B * L * D, B, D, esize,
                           dict(res=4, total=4, w=4, rms=True))
        rec = _case_record("add_norm", dtype, [B, L, D], got, want,
                           (low, 1e-5), ms, plain_ms, bound)
        rec["device_ms"] = dev_ms
        emit({"phase": "kernel-norm", "kernel": "add_norm", **rec})
        if not rec["ok"]:
            raise AssertionError(f"add_norm kernel disagrees: {rec}")
        results["add_norm"][rec["dtype"]] = rec
        if dtype == torch.bfloat16:
            # the bf16 residual stream: the residual read and the total
            # written in bf16 (8 bytes a value against 12)
            rec = _add_norm_bf16_residual(v, B, L, D, low)
            results["add_norm"]["bf16-residual"] = rec

        for site in NORM_SITES:
            # the main case (norm_2, bf16) also read with a cold L2
            cold = flush if site[0] == "norm_2" and i == 0 else None
            rec = _norm_site_record(site, v, dtype, low, cold)
            results["norm_modulate"][f"{site[0]}-{rec['dtype']}"] = rec
            if site[0] == "deferred-top" and dtype == torch.bfloat16:
                rec = _norm_site_record(site, v, dtype, low, bf16_res=True)
                results["norm_modulate"]["deferred-top-bf16-residual"] = rec
        del v, x2, r2
        torch.cuda.empty_cache()
    # the 512-px shape, bf16: the inputs (100 MB at norm_2) exceed the L2
    v = norm_case_inputs(B, 4 * L, D, torch.bfloat16, seed=402)
    for site in NORM_SITES:
        if site[0] in NORM_SITES_L1024:
            rec = _norm_site_record(site, v, torch.bfloat16, 1.6e-2)
            results["norm_modulate"][f"{site[0]}-L1024-bfloat16"] = rec
    del v, flush
    torch.cuda.empty_cache()
    return results


def convx_bound(B, L, D, W, R, esize, peak):
    """Least time for one conv + x_proj call: x read once, x_conv and x_dbl
    (fp32) written once, the weights read once, over HBM bandwidth; against
    the product's 2 B L D R flop at `peak` (tensor cores for bf16, the fp32
    peak for fp32) plus the conv's 2 W + 5 fp32 operations per value (taps,
    bias, SiLU)."""
    nbytes = (2 * B * L * D * esize + B * L * R * 4 + D * (W + 1) * 4
              + R * D * esize)
    flops = 2 * B * L * D * R + B * L * D * (2 * W + 5)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (2 * B * L * D * R / peak
             + B * L * D * (2 * W + 5) / FP32_FLOP_PER_S) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), nbytes, flops


def phase_kernel_convx():
    import torch

    from dimsum_torch.ops.conv_xproj import conv_xproj_cuda, conv_xproj_ref

    cases = [
        ("mixer-bf16", 24, 256, 1024, 64, torch.bfloat16, False),
        ("mixer-bf16-reverse", 24, 256, 1024, 64, torch.bfloat16, True),
        ("mixer-fp32", 24, 256, 1024, 64, torch.float32, False),
        ("mixer-fp32-reverse", 24, 256, 1024, 64, torch.float32, True),
        ("L1024-bf16", 24, 1024, 1024, 64, torch.bfloat16, False),
        ("xl-R68-bf16", 24, 256, 1152, 68, torch.bfloat16, False),
        # the fp32 route at the fused fp32 512-px shape (the sampling CLI's
        # default dtype) and at DiM-XL/2's mixer at 512 px (8 CFG rows)
        ("L1024-fp32", 24, 1024, 1024, 64, torch.float32, False),
        ("L1024-fp32-reverse", 24, 1024, 1024, 64, torch.float32, True),
        ("xl-R68-fp32", 8, 1024, 1152, 68, torch.float32, False),
        ("xl-R68-fp32-reverse", 8, 1024, 1152, 68, torch.float32, True),
        # ragged L (one token past four 16-token units, and 127); the
        # gate's widest R
        ("ragged-L65-bf16", 24, 65, 1024, 64, torch.bfloat16, False),
        ("ragged-L127-bf16-reverse", 24, 127, 1024, 64, torch.bfloat16, True),
        ("R512-bf16", 24, 256, 1024, 512, torch.bfloat16, False),
    ]
    results = {}
    for i, (name, B, L, D, R, dtype, reverse) in enumerate(cases):
        g = torch.Generator(device="cuda").manual_seed(500 + i)
        # x_in as the mixer gets it: the first half of in_proj's output
        xz = torch.randn((B, L, 2 * D), generator=g, device="cuda").to(dtype)
        x = xz[..., :D]
        cw = 0.3 * torch.randn((D, 4), generator=g, device="cuda")
        cb = 0.1 * torch.randn(D, generator=g, device="cuda")
        w = (torch.randn((R, D), generator=g, device="cuda")
             / math.sqrt(D)).to(dtype)
        with torch.inference_mode():
            got = conv_xproj_cuda(x, cw, cb, w, reverse)
            want = conv_xproj_ref(x, cw, cb, w, reverse)
            torch.cuda.synchronize()
            ms = cuda_ms(lambda: conv_xproj_cuda(x, cw, cb, w, reverse),
                         iters=20)
            bf16 = dtype == torch.bfloat16
            dev_ms = (device_ms(lambda: conv_xproj_cuda(x, cw, cb, w,
                                                        reverse),
                                "conv_xproj")
                      if name in ("mixer-bf16", "L1024-bf16") or not bf16
                      else None)
            plain_ms = cuda_ms(lambda: conv_xproj_ref(x, cw, cb, w, reverse),
                               iters=5)
        bound = convx_bound(B, L, D, 4, R, x.element_size(),
                            BF16_TC_FLOP_PER_S if bf16 else FP32_FLOP_PER_S)
        # relative to each output's largest value: x_conv fp32 1e-5 (exp),
        # bf16 1.6e-2 (one rounding step); x_dbl fp32 1e-5 (summation
        # order), from bf16 x_conv 1e-2 (an entry rounded the other way)
        rec = _case_record(name, dtype, [B, L, D, 4, R], got, want,
                           (1.6e-2, 1e-2) if bf16 else (1e-5, 1e-5), ms,
                           plain_ms, bound)
        rec.update(reverse=reverse, device_ms=dev_ms)
        emit({"phase": "kernel-convx", **rec})
        if not rec["ok"]:
            raise AssertionError(f"conv_xproj kernel disagrees on {name}")
        results[name] = rec
        del xz, x, got, want
        torch.cuda.empty_cache()
    return results


FUSED_ON = dict(pallas_norm=True, fused_norm=True, conv_xproj=True)


def _fused_counts():
    from dimsum_torch.ops.conv_xproj import conv_xproj_cuda
    from dimsum_torch.ops.norms import add_norm_cuda, norm_modulate_cuda

    return {"add_norm": add_norm_cuda, "norm_modulate": norm_modulate_cuda,
            "conv_xproj": conv_xproj_cuda}


def _plain_fused(model):
    """Send every fused-kernel site of `model` to the kernels' plain
    versions."""
    for m in model.modules():
        if hasattr(m, "norm_impl"):
            m.norm_impl = "ref"
        if hasattr(m, "conv_impl"):
            m.conv_impl = "ref"


# launches per DiM-L/2 forward with the three switches on
FUSED_LAUNCHES = {0: {"add_norm": 15, "norm_modulate": 25, "conv_xproj": 32},
                  2: {"add_norm": 3, "norm_modulate": 37, "conv_xproj": 32}}


def phase_model_fused():
    import torch

    from dimsum_torch.models.dim import DiM_models, build_dim, forward_with_cfg

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(6)
    half = torch.randn((12, 4, 32, 32), generator=g, device="cuda")
    x = torch.cat([half, half])
    t = torch.rand(12, generator=g, device="cuda").repeat(2)
    y = torch.cat([torch.randint(0, 1000, (12,), generator=g, device="cuda"),
                   torch.full((12,), 1000, device="cuda")])

    def build(**switches):
        cfg = DiM_models["DiM-L/2"](img_resolution=32, num_classes=1000,
                                    use_attn_every_k_layers=4,
                                    dtype=torch.float32, **switches)
        return build_dim(cfg, "cuda", seed=0)

    counts = _fused_counts()
    with torch.inference_mode():
        model = build()
        default = forward_with_cfg(model, x, t, y, cfg_scale=1.4)
        del model
        for pending_tail in (0, 2):
            model = build(**FUSED_ON, pending_tail=pending_tail)
            for c in counts.values():
                c.launches = 0
            got = forward_with_cfg(model, x, t, y, cfg_scale=1.4)
            torch.cuda.synchronize()
            launches = {k: c.launches for k, c in counts.items()}
            _plain_fused(model)
            plain = forward_with_cfg(model, x, t, y, cfg_scale=1.4)
            torch.cuda.synchronize()
            del model
            scale = default.abs().max().item()
            # fp32 kernels and plain versions differ by ~1e-6 relative per
            # call (rsqrt, exp, summation order); 16 blocks of random
            # weights amplify that, not past 1e-3 of the scale
            tol = 1e-3 * max(1.0, scale)
            errs = {"kernels_vs_plain": (got - plain).abs().max().item(),
                    "kernels_vs_default": (got - default).abs().max().item(),
                    "plain_vs_default": (plain - default).abs().max().item()}
            rec = {"phase": "model-fused", "model": "DiM-L/2",
                   "rows": x.shape[0], "dtype": "float32", "tf32": False,
                   "switches": {**FUSED_ON, "pending_tail": pending_tail},
                   "launches_per_forward": launches, "max_abs_err": errs,
                   "max_abs_ref": scale, "tol": tol,
                   "finite": bool(torch.isfinite(got).all())}
            emit(rec)
            if (launches != FUSED_LAUNCHES[pending_tail] or not rec["finite"]
                    or not max(errs.values()) <= tol):
                raise AssertionError(f"model-fused phase failed: {rec}")
    torch.cuda.empty_cache()


def phase_train_grad_fused():
    import torch

    from dimsum_torch.models.dim import DiM_models, build_dim
    from dimsum_torch.transport import create_transport

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = DiM_models["DiM-L/2"](img_resolution=32, num_classes=1000,
                                use_attn_every_k_layers=4,
                                label_dropout=0.1, drop_path=0.1,
                                dtype=torch.float32, **FUSED_ON)
    model = build_dim(cfg, "cuda", seed=0, train=True)
    transport = create_transport("GVP", "velocity")
    g = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn((2, 4, 32, 32), generator=g, device="cuda")
    y = torch.randint(0, 1000, (2,), generator=g, device="cuda")

    def loss_and_grads():
        gen = torch.Generator(device="cuda").manual_seed(4)  # same draws
        model.zero_grad(set_to_none=True)
        loss = transport.training_losses(
            lambda xt, t, **kw: model(xt, t, train=True, generator=gen,
                                      **kw), x, gen, {"y": y})["loss"].mean()
        loss.backward()
        torch.cuda.synchronize()
        return loss.item(), {n: p.grad.clone() for n, p in
                             model.named_parameters() if p.grad is not None}

    counts = _fused_counts()
    for c in counts.values():
        c.launches = 0
    loss, grads = loss_and_grads()
    launches = {k: c.launches for k, c in counts.items()}
    _plain_fused(model)
    want_loss, want = loss_and_grads()
    # as train-grad: ~1e-6 relative per call, amplified by 16 blocks and
    # the backward, not past 2e-3 of each tensor's scale
    tol = 2e-3
    errs = {n: _scaled_err(grads[n], want[n]) for n in want}
    worst = max(errs, key=errs.get)
    rec = {"phase": "train-grad-fused", "model": "DiM-L/2", "batch": 2,
           "dtype": "float32", "tf32": False, "switches": FUSED_ON,
           "loss": loss, "loss_plain": want_loss,
           "loss_rel_err": abs(loss - want_loss) / abs(want_loss),
           "n_grads": len(want), "same_grad_set": set(grads) == set(want),
           "worst_grad": worst, "worst_grad_scaled_err": errs[worst],
           "tol": tol, "launches_per_step": launches}
    emit(rec)
    if (launches != FUSED_LAUNCHES[0] or not rec["same_grad_set"]
            or not rec["loss_rel_err"] <= 1e-4 or not errs[worst] <= tol):
        raise AssertionError(f"train-grad-fused phase failed: {rec}")
    del model, grads, want
    torch.cuda.empty_cache()


def phase_sample_fused():
    import torch

    from dimsum_torch import bench

    counts = _fused_counts()
    for c in counts.values():
        c.launches = 0
    record, samples = bench.run(batch=12, steps=STEPS, dtype="bf16",
                                cfg_scale=1.4, device="cuda", seed=0,
                                **FUSED_ON)
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counts.items()}
    finite = bool(torch.isfinite(samples).all())
    rec = {"phase": "sample-fused", **record, "launches": launches,
           "shape": list(samples.shape), "finite": finite,
           "sample_std": samples.float().std().item()}
    emit(rec)
    # one warm-up drift call plus STEPS - 1 Euler steps
    want = {k: n * STEPS for k, n in FUSED_LAUNCHES[0].items()}
    if not finite or list(samples.shape) != [12, 4, 32, 32] \
            or launches != want:
        raise AssertionError(f"sample-fused phase failed: {rec}")
    return launches


def phase_sample_fused_512():
    """phase_sample_fused's run at 512 px: the fused kernels and the sm90
    attention kernel together, as the fused 512-px sampling path runs."""
    import torch

    from dimsum_torch import bench

    counts = {**_fused_counts(), **_zeroed_attention_counts()}
    for c in counts.values():
        c.launches = 0
    record, samples = bench.run(batch=12, steps=STEPS, dtype="bf16",
                                cfg_scale=1.4, device="cuda", seed=0,
                                image_size=512, **FUSED_ON)
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counts.items()}
    finite = bool(torch.isfinite(samples).all())
    rec = {"phase": "sample-fused-512", **record, "launches": launches,
           "shape": list(samples.shape), "finite": finite,
           "sample_std": samples.float().std().item()}
    emit(rec)
    # one warm-up drift call plus STEPS - 1 Euler steps
    want = {k: n * STEPS for k, n in FUSED_LAUNCHES[0].items()}
    want.update(_attention_launches(STEPS, "full_attention_sm90"))
    if not finite or list(samples.shape) != [12, 4, 64, 64] \
            or launches != want:
        raise AssertionError(f"sample-fused-512 phase failed: {rec}")
    return launches


# the published DiM-L/2 flags of the reference's sampling script, in bf16
DIM_L2_ARGS = ["--model", "DiM-L/2", "--num-classes", "1001",
               "--block-type", "combined", "--bimamba-type", "none",
               "--rms-norm", "--fused-add-norm", "--learnable-pe",
               "--cond-mamba", "--use-attn-every-k-layers", "4",
               "--path-type", "GVP", "--bf16"]
DOPRI5_BATCH = 4      # images of the dopri5 run (8 CFG rows)
SDE_512_STEPS = 10    # grid points of the 512-px SDE run
FP32_512_STEPS = 10   # grid points of the fp32 512-px ODE run
LIKELIHOOD_STEPS = 6  # grid points of the likelihood run


def _dim_l2_config(image_size, dtype=None):
    import torch

    from dimsum_torch.models.dim import DiM_models

    return DiM_models["DiM-L/2"](img_resolution=image_size // 8,
                                 num_classes=1001, label_dropout=0.1,
                                 use_attn_every_k_layers=4,
                                 dtype=dtype or torch.float32)


def write_checkpoints(tmp):
    """Seeded random DiM-L/2 weights (256 px) in the reference's .pt
    layout, "ema" from `random_init_` seed 0 and "model" from seed 1, and
    a full-width SD-VAE (ch 128, ch_mult 1 2 4 4) with seeded random
    weights as a diffusers state dict.  Returns (checkpoint path, its
    state dicts, VAE path)."""
    import argparse
    import os

    import torch

    from dimsum_torch.models.dim import DiM, random_init_
    from dimsum_torch.models.vae import load_vae

    with torch.device("cuda"):
        net = DiM(_dim_l2_config(256))
    sds = {}
    for key, seed in (("ema", 0), ("model", 1)):
        random_init_(net, seed)
        sds[key] = {k: v.detach().to("cpu", copy=True)
                    for k, v in net.state_dict().items()}
    path = os.path.join(tmp, "dim-l2-256.pt")
    torch.save({**sds, "args": argparse.Namespace(model="DiM-L/2")}, path)
    vae_path = os.path.join(tmp, "sd-vae.pt")
    torch.save({k: v.cpu() for k, v in
                load_vae("random:0", "cuda").state_dict().items()}, vae_path)
    del net
    torch.cuda.empty_cache()
    return path, sds, vae_path


def _sample_argv(ckpt, out, *extra):
    return ["ODE", *DIM_L2_ARGS, "--image-size", "256", "--ckpt", ckpt,
            "--sample-dir", out, *extra]


def phase_sample_dopri5(tmp, ckpt, sds, vae_path):
    """The reference's eval protocol through `python -m
    dimsum_torch.sample`: ODE dopri5 (atol 1e-6, rtol 1e-3), CFG 1.4, 256
    px, bf16, DOPRI5_BATCH images from the checkpoint's EMA weights,
    decoded by the SD-VAE into PNGs.  Counts set to 0 just before and read
    just after: 32 launches of kernel 1 per drift call, NFE + 1 calls (the
    NFE and the uncounted initial-step probe), none of kernels 2 and 3;
    one 256 x 256 PNG per image; finite latents.  Then `--params` picks the
    checkpoint's "ema" or "model" weights (one Euler step of one image
    against the same step through a model built from each seed), and a
    checkpoint with one key removed is refused."""
    import os

    import torch

    from dimsum_torch import sample
    from dimsum_torch.models.dim import build_dim, forward_with_cfg
    from dimsum_torch.transport import Sampler, create_transport
    from dimsum_torch.utils.png import read_png

    out = os.path.join(tmp, "samples")
    counts = _zeroed_scan_counts()
    rec = sample.main(_sample_argv(
        ckpt, out, "--vae-ckpt", vae_path, "--sampling-method", "dopri5",
        "--compute-nfe", "--cfg-scale", "1.4", "--global-batch-size",
        str(DOPRI5_BATCH)))
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counts.items()}
    pngs = sorted(f for f in os.listdir(out) if f.endswith(".png"))
    sizes = sorted({read_png(os.path.join(out, f)).shape for f in pngs})
    finite = bool(torch.isfinite(rec["samples"]).all())
    nfe = rec["nfe"]

    # --params: one Euler step of one image, through the CLI and through a
    # model built from each seed
    picked = {}
    for params, seed in (("ema", 0), ("raw", 1)):
        got = sample.main(_sample_argv(
            ckpt, os.path.join(tmp, "quick"), "--params", params,
            "--sampling-method", "euler", "--num-sampling-steps", "2",
            "--cfg-scale", "1.4", "--global-batch-size", "1"))["samples"]
        net = build_dim(_dim_l2_config(256, torch.bfloat16), "cuda", seed)
        g = torch.Generator(device="cuda").manual_seed(0)
        z = torch.randn((1, 4, 32, 32), generator=g, device="cuda")
        y = torch.randint(0, 1000, (1,), generator=g, device="cuda")
        with torch.no_grad():
            want = Sampler(create_transport("GVP", "velocity")).sample_ode(
                sampling_method="euler", num_steps=2)(
                torch.cat([z, z]), lambda x, t, y=None: forward_with_cfg(
                    net, x, t, y, cfg_scale=1.4),
                y=torch.cat([y, torch.full((1,), 1000, device="cuda")]))[:1]
        picked[params] = (got, _scaled_err(got, want))
        del net
    params_apart = _scaled_err(picked["raw"][0], picked["ema"][0])

    dropped = "blocks.1.freq_mamba.mixer.x_proj.weight"
    bad = os.path.join(tmp, "missing-key.pt")
    torch.save({"ema": {k: v for k, v in sds["ema"].items()
                        if k != dropped}}, bad)
    try:
        sample.main(_sample_argv(bad, os.path.join(tmp, "quick"),
                                 "--sampling-method", "euler",
                                 "--num-sampling-steps", "2"))
        refused = False
    except ValueError as e:
        refused = dropped in str(e)
    os.remove(bad)

    rec_out = {"phase": "sample-dopri5", "model": "DiM-L/2",
               "image_size": 256, "dtype": "bfloat16", "cfg_scale": 1.4,
               "batch": DOPRI5_BATCH, "nfe": nfe, "seconds": rec["seconds"],
               "s_per_image": rec["seconds"] / DOPRI5_BATCH,
               "decode_seconds": rec["decode_seconds"],
               "launches": launches, "pngs": len(pngs), "png_shapes": sizes,
               "finite": finite,
               "latent_std": rec["samples"].float().std().item(),
               "params_err": {k: v[1] for k, v in picked.items()},
               "params_apart": params_apart, "missing_key_refused": refused}
    emit(rec_out)
    # one CLI call through the card: the same weights, the same ops
    if (not finite or len(pngs) != DOPRI5_BATCH
            or sizes != [(256, 256, 3)]
            or launches["selective_scan_fwd"] != 32 * (nfe + 1)
            or launches["selective_scan_fwd_train"] != 0
            or launches["selective_scan_bwd"] != 0
            or max(v[1] for v in picked.values()) > 1e-3
            or not params_apart > 0.05 or not refused):
        raise AssertionError(f"sample-dopri5 phase failed: {rec_out}")
    torch.cuda.empty_cache()
    return launches


def phase_sample_sde_512(tmp, sds):
    """The 256-px checkpoint adapted to 512 px (`adapt_checkpoint`: the
    position embedding resized bicubically as the JAX package does), saved,
    and sampled through `python -m dimsum_torch.sample SDE` at 512 px:
    Euler-Maruyama over SDE_512_STEPS grid points, diffusion sigma_t, the
    Mean last step, CFG 1.4, bf16, 2 images.  The velocity model's SDE
    drift calls the model twice (drift and score): 2 (SDE_512_STEPS - 1)
    + 2 calls, each with 32 scan launches and 36 attention launches, all
    through the sm90 kernel.  Counts set to 0 just before and read just
    after; finite samples."""
    import os

    import torch

    from dimsum_torch import sample
    from dimsum_torch.models.dim import DiM
    from dimsum_torch.utils.ckpt import adapt_checkpoint, resize_pos_embed

    with torch.device("meta"):
        template = DiM(_dim_l2_config(512)).state_dict()
    adapted = adapt_checkpoint(sds["ema"], template)
    pos_ok = torch.equal(adapted["pos_embed"],
                         resize_pos_embed(sds["ema"]["pos_embed"], 1024))
    path = os.path.join(tmp, "dim-l2-512-adapted.pt")
    torch.save({"ema": adapted}, path)
    del adapted

    counts = {**_zeroed_scan_counts(), **_zeroed_attention_counts()}
    rec = sample.main(["SDE", *DIM_L2_ARGS, "--image-size", "512", "--ckpt",
                       path, "--sample-dir", os.path.join(tmp, "sde"),
                       "--diffusion-form", "sigma", "--last-step", "Mean",
                       "--num-sampling-steps", str(SDE_512_STEPS),
                       "--cfg-scale", "1.4", "--global-batch-size", "2"])
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counts.items()}
    calls = 2 * (SDE_512_STEPS - 1) + 2
    finite = bool(torch.isfinite(rec["samples"]).all())
    out = {"phase": "sample-sde-512", "model": "DiM-L/2", "image_size": 512,
           "dtype": "bfloat16", "steps": SDE_512_STEPS, "model_calls": calls,
           "seconds": rec["seconds"], "launches": launches,
           "shape": list(rec["samples"].shape), "finite": finite,
           "pos_embed_resized": pos_ok,
           "sample_std": rec["samples"].float().std().item()}
    emit(out)
    if (not finite or not pos_ok or out["shape"] != [2, 4, 64, 64]
            or launches != {"selective_scan_fwd_train": 0,
                            "selective_scan_bwd": 0,
                            **_attention_launches(calls,
                                                  "full_attention_sm90")}):
        raise AssertionError(f"sample-sde-512 phase failed: {out}")
    torch.cuda.empty_cache()
    return path


def phase_sample_512_fp32(tmp, path):
    """The default fp32 512-px sampling path: the adapted checkpoint at
    `path` sampled through `python -m dimsum_torch.sample ODE` in its
    default dtype, fp32 (TF32 off, the CLI's default), Euler over
    FP32_512_STEPS grid points, CFG 1.4, 2 images: FP32_512_STEPS - 1 drift
    calls, each with 32 scan launches and 36 attention launches, all
    through the fp32 attention kernel.  Counts set to 0 just before and
    read just after; finite samples.  Returns the launches."""
    import os

    import torch

    from dimsum_torch import sample

    counts = _zeroed_attention_counts()
    rec = sample.main(["ODE", *[a for a in DIM_L2_ARGS if a != "--bf16"],
                       "--image-size", "512", "--ckpt", path,
                       "--sample-dir", os.path.join(tmp, "ode-fp32"),
                       "--sampling-method", "euler",
                       "--num-sampling-steps", str(FP32_512_STEPS),
                       "--cfg-scale", "1.4", "--global-batch-size", "2"])
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counts.items()}
    calls = FP32_512_STEPS - 1
    finite = bool(torch.isfinite(rec["samples"]).all())
    out = {"phase": "sample-512-fp32", "model": "DiM-L/2", "image_size": 512,
           "dtype": str(rec["samples"].dtype).split(".")[-1],
           "steps": FP32_512_STEPS, "model_calls": calls,
           "seconds": rec["seconds"],
           "seconds_per_call": rec["seconds"] / calls, "launches": launches,
           "shape": list(rec["samples"].shape), "finite": finite,
           "sample_std": rec["samples"].float().std().item()}
    emit(out)
    if (not finite or out["shape"] != [2, 4, 64, 64]
            or out["dtype"] != "float32"
            or launches != _attention_launches(calls, "full_attention_f32")):
        raise AssertionError(f"sample-512-fp32 phase failed: {out}")
    torch.cuda.empty_cache()
    return launches, {**out, "samples": rec["samples"]}


# the JAX package's fused-kernel switches that sample-512-fp32-fused sets
FUSED_ENV = ("DIMSUM_PALLAS_NORM", "DIMSUM_FUSED_NORM", "DIMSUM_CONV_XPROJ")


def phase_sample_512_fp32_fused(tmp, path, plain):
    """sample-512-fp32's run (`plain`: its record and samples) under the
    JAX package's fused-kernel switches, as a user runs the JAX sample.py
    fused: DIMSUM_PALLAS_NORM, DIMSUM_FUSED_NORM and DIMSUM_CONV_XPROJ set
    to "1" around `sample.main` and restored after, the same checkpoint,
    grid, images and fp32.  Each drift call takes 32 conv + x_proj
    launches, all on the fp32 route, 15 add + norm, 25 norm + modulate and
    36 fp32 attention launches.  Counts set to 0 just before and read just
    after; finite samples, held to the plain run's."""
    import os

    import torch

    from dimsum_torch import sample
    from dimsum_torch.ops.conv_xproj import conv_xproj_cuda

    counts = {**_fused_counts(), **_zeroed_attention_counts()}
    for c in counts.values():
        c.launches = 0
    conv_xproj_cuda.fp32_launches = 0
    saved = {k: os.environ.get(k) for k in FUSED_ENV}
    os.environ.update({k: "1" for k in FUSED_ENV})
    try:
        rec = sample.main([
            "ODE", *[a for a in DIM_L2_ARGS if a != "--bf16"],
            "--image-size", "512", "--ckpt", path,
            "--sample-dir", os.path.join(tmp, "ode-fp32-fused"),
            "--sampling-method", "euler",
            "--num-sampling-steps", str(FP32_512_STEPS),
            "--cfg-scale", "1.4", "--global-batch-size", "2"])
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counts.items()}
    launches["conv_xproj_fp32"] = conv_xproj_cuda.fp32_launches
    calls = FP32_512_STEPS - 1
    want = {k: n * calls for k, n in FUSED_LAUNCHES[0].items()}
    want.update(_attention_launches(calls, "full_attention_f32"))
    want["conv_xproj_fp32"] = want["conv_xproj"]
    got, ref = rec["samples"], plain["samples"]
    scale = ref.abs().max().item()
    # the fused kernels and the plain routes differ by ~1e-6 relative a
    # call (rsqrt, exp, summation order), which the 16 blocks of random
    # weights amplify as in model-fused (1e-3 of scale a forward); Euler
    # adds the calls' velocity errors times dt, whose sum is 1, so the
    # samples stay within the same 1e-3 of scale
    tol = 1e-3 * max(1.0, scale)
    err = (got - ref).abs().max().item()
    finite = bool(torch.isfinite(got).all())
    out = {"phase": "sample-512-fp32-fused", "model": "DiM-L/2",
           "image_size": 512, "dtype": str(got.dtype).split(".")[-1],
           "switches": {k: "1" for k in FUSED_ENV},
           "steps": FP32_512_STEPS, "model_calls": calls,
           "seconds": rec["seconds"],
           "seconds_per_call": rec["seconds"] / calls,
           "plain_seconds_per_call": plain["seconds_per_call"],
           "launches": launches, "shape": list(got.shape), "finite": finite,
           "max_abs_err_vs_plain": err, "max_abs_ref": scale, "tol": tol,
           "sample_std": got.float().std().item()}
    emit(out)
    if (not finite or out["shape"] != [2, 4, 64, 64]
            or out["dtype"] != "float32" or launches != want
            or not err <= tol):
        raise AssertionError(f"sample-512-fp32-fused phase failed: {out}")
    torch.cuda.empty_cache()
    return launches


def phase_likelihood(tmp, ckpt):
    """`python -m dimsum_torch.sample ODE --likelihood` at cfg 1.0, 256 px,
    bf16, 2 images: the samples by Euler over LIKELIHOOD_STEPS grid points
    (kernel 1), then their bits/dim by the augmented reverse ODE over the
    same grid, whose vector-Jacobian products take kernels 2 and 3: 32
    launches of each per drift call.  Counts set to 0 just before and read
    just after; finite bits/dim.  Then one augmented drift call of the fp32
    model (TF32 off) through the kernels and through the plain scan: the
    drift within 1e-3 and the vector-Jacobian product within 2e-3 of their
    scales (as the model and train-grad phases hold a forward and a
    gradient), the divergence estimate within 2e-3 of its terms' sum."""
    import os

    import torch

    from dimsum_torch import sample
    from dimsum_torch.models.dim import build_dim
    from dimsum_torch.transport import Sampler, create_transport

    counts = _zeroed_scan_counts()
    rec = sample.main(_sample_argv(
        ckpt, os.path.join(tmp, "likelihood"), "--sampling-method", "euler",
        "--num-sampling-steps", str(LIKELIHOOD_STEPS), "--likelihood",
        "--cfg-scale", "1.0", "--global-batch-size", "2"))
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counts.items()}
    bpd = rec["bpd"]
    calls = LIKELIHOOD_STEPS - 1

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    net = build_dim(_dim_l2_config(256), "cuda", seed=0)
    net.requires_grad_(False)
    g = torch.Generator(device="cuda").manual_seed(6)
    x = torch.randn((2, 4, 32, 32), generator=g, device="cuda")
    y = torch.randint(0, 1000, (2,), generator=g, device="cuda")
    t = torch.full((2,), 0.3, device="cuda")
    eps = torch.randint(0, 2, x.shape, generator=g, device="cuda").float()         * 2 - 1
    sampler = Sampler(create_transport("GVP", "velocity"))
    aug_counts = _zeroed_scan_counts()
    dx, vjp = sampler.augmented_drift(x, t, net, eps, y=y)
    aug_launches = {k: c.launches for k, c in aug_counts.items()}
    for m in _mixers(net):
        m.scan_impl = "ref"
    dx_ref, vjp_ref = sampler.augmented_drift(x, t, net, eps, y=y)
    torch.cuda.synchronize()
    div, div_ref = (vjp * eps).sum((1, 2, 3)), (vjp_ref * eps).sum((1, 2, 3))
    div_err = ((div - div_ref).abs()
               / (vjp_ref * eps).abs().sum((1, 2, 3))).max().item()
    errs = {"drift": _scaled_err(dx, dx_ref), "vjp": _scaled_err(vjp, vjp_ref),
            "divergence": div_err}
    out = {"phase": "likelihood", "model": "DiM-L/2", "image_size": 256,
           "dtype": "bfloat16", "steps": LIKELIHOOD_STEPS,
           "seconds": rec["seconds"], "launches": launches,
           "bits_per_dim": bpd.tolist(),
           "finite": bool(torch.isfinite(bpd).all()),
           "fp32_check": {"errs": errs, "tol": {"drift": 1e-3, "vjp": 2e-3,
                                                "divergence": 2e-3},
                          "launches": aug_launches,
                          "divergence": div_ref.tolist()}}
    emit(out)
    if (not out["finite"]
            or launches["selective_scan_fwd"] != 32 * calls
            or launches["selective_scan_fwd_train"] != 32 * calls
            or launches["selective_scan_bwd"] != 32 * calls
            or aug_launches != {"selective_scan_fwd": 0,
                                "selective_scan_fwd_train": 32,
                                "selective_scan_bwd": 32}
            or not errs["drift"] <= 1e-3 or not errs["vjp"] <= 2e-3
            or not div_err <= 2e-3):
        raise AssertionError(f"likelihood phase failed: {out}")
    del net
    torch.cuda.empty_cache()
    return launches


# eval: EVAL_REAL real PNGs; EVAL_SAMPLES samples in batches of EVAL_BATCH
# over EVAL_STEPS Euler grid points (CFG 1.4, bf16), scored by the port's
# InceptionV3 with seeded weights
EVAL_REAL, EVAL_SAMPLES, EVAL_BATCH, EVAL_STEPS = 64, 64, 32, 10
EVAL_METRICS = "fid50k_full,kid50k_full,pr50k3_full"
EVAL_DETECTOR = "jax-random"  # the JAX CLIs' spec: the port's InceptionV3


def _eval_run(spec):
    """`python -m dimsum_torch.sample_ddp` runs one after the other in a
    process of their own (its `main`, what the module runs), the scan
    launch counts set to 0 just before and read just after each.  `spec`
    is a JSON list of [argv, output path]; each run's record, its
    launches and its seconds go to its output path."""
    import torch

    from dimsum_torch import sample_ddp

    for argv, out in json.loads(spec):
        counts = _zeroed_scan_counts()
        t0 = time.perf_counter()
        rec = sample_ddp.main(argv)
        torch.cuda.synchronize()
        rec["run_seconds"] = time.perf_counter() - t0
        rec["launches"] = {k: c.launches for k, c in counts.items()}
        with open(out, "w") as f:
            json.dump(rec, f)


def _metric_values(run_dir):
    """{name: value} of the metric-*.jsonl files in `run_dir` (the last
    line of each)."""
    import os

    out = {}
    for name in sorted(os.listdir(run_dir)):
        if name.startswith("metric-") and name.endswith(".jsonl"):
            with open(os.path.join(run_dir, name)) as f:
                out.update(json.loads(f.read().splitlines()[-1])["results"])
    return out


def phase_eval(tmp=None, ckpt=None, vae_path=None):
    """eval: the evaluation path on full-width DiM-L/2 at 256 px, from the
    checkpoint and SD-VAE that `write_checkpoints` wrote into `tmp` (made
    here when the phase runs alone: python3 -c "import chip_smoke as s;
    s.phase_eval()").

      1. real side: EVAL_REAL PNGs, the VAE decode of seeded latents
         (another seed than the samples'), written by `write_png`;
      2. streaming: `python -m dimsum_torch.sample_ddp ODE` in a process of
         its own: EVAL_SAMPLES samples in batches of EVAL_BATCH, Euler over
         EVAL_STEPS grid points, CFG 1.4, bf16, the SD-VAE decode, the
         port's InceptionV3 (`--eval-detector jax-random`) on the card,
         fid50k_full, kid50k_full and pr50k3_full, --eval-streaming
         --save-images.  32 launches of kernel 1 a drift call, counted in
         its process; EVAL_SAMPLES PNGs; finite metrics;
      3. resume: the same command with its feature chunks on disk: no
         launch of kernel 1, no batch generated, the same metrics (1e-9
         relative: the real side now comes from the stats cache);
      4. disk route: `python -m dimsum_torch.calc_metrics` over the two
         folders with the same detector: FID within 1e-3 relative of
         step 2's (the features of the same uint8 images);
      5. the network against its plain run: the card's InceptionV3 (fp32,
         TF32 off) on 4 of the real images within 1e-4 of scale of the
         same network in fp64 on the CPU; precision/recall by
         impl="torch" on the card equal to impl="numpy" on step 2's
         features, and KID by both routes against its fp64 value: the
         torch route within 1e-6 of the kernel terms' scale (KID near 0
         cancels terms of that size; the numpy route's fp32 sums are
         recorded beside it);
      6. timings (nvidia-smi's card beside them in the device phase):
         generation, VAE decode and InceptionV3 (batch 64) images/s, the
         metric seconds and the phase's seconds."""
    import os
    import subprocess
    import tempfile

    if tmp is None:
        with tempfile.TemporaryDirectory() as tmp:
            ckpt, _, vae_path = write_checkpoints(tmp)
            return phase_eval(tmp, ckpt, vae_path)

    import copy

    import numpy as np
    import torch

    from dimsum_torch.eval.features import latents_to_uint8
    from dimsum_torch.eval.fid import compute_kid, compute_precision_recall
    from dimsum_torch.eval.inception import (InceptionDetector,
                                             preprocess_uint8)
    from dimsum_torch.models.vae import load_vae
    from dimsum_torch.utils.png import read_png, write_png

    phase_t0 = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    real_dir = os.path.join(tmp, "eval-real")
    sample_dir = os.path.join(tmp, "eval", "samples")
    os.makedirs(real_dir)

    # 1. the real side
    vae = load_vae(vae_path, "cuda")
    g = torch.Generator(device="cuda").manual_seed(11)
    z = torch.randn((EVAL_REAL, 4, 32, 32), generator=g, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        real = torch.cat([latents_to_uint8(vae.decode(z[i:i + 16]))
                          for i in range(0, EVAL_REAL, 16)])
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    for i, im in enumerate(real.permute(0, 2, 3, 1).cpu().numpy()):
        write_png(os.path.join(real_dir, f"{i:06d}.png"), im)
    del vae
    torch.cuda.empty_cache()

    def run(cmd, what):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, *cmd], cwd=root,
                              capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr)
            raise AssertionError(f"eval: the {what} exited "
                                 f"{proc.returncode}")
        return time.perf_counter() - t0

    argv = ["ODE", *DIM_L2_ARGS, "--image-size", "256", "--ckpt", ckpt,
            "--vae-ckpt", vae_path, "--sampling-method", "euler",
            "--num-sampling-steps", str(EVAL_STEPS), "--cfg-scale", "1.4",
            "--num-fid-samples", str(EVAL_SAMPLES), "--per-proc-batch-size",
            str(EVAL_BATCH), "--eval-refdir", real_dir, "--eval-metric",
            EVAL_METRICS, "--eval-detector", EVAL_DETECTOR,
            "--eval-streaming", "--save-images", "--sample-dir", sample_dir]
    # 2. streaming, 3. resumed: one process for both (one start fewer)
    outs = [os.path.join(tmp, f"eval-run{i}.json") for i in range(2)]
    process_wall = run(["-c", "import sys, chip_smoke as s; "
                        "s._eval_run(sys.argv[1])",
                        json.dumps([[argv, out] for out in outs])],
                       "streaming and resumed runs")
    recs = []
    for out in outs:
        with open(out) as f:
            recs.append(json.load(f))
    walls = [r["run_seconds"] for r in recs]
    streamed = {k: v for r in recs[0]["results"]
                for k, v in r["results"].items()}
    resumed = {k: v for r in recs[1]["results"]
               for k, v in r["results"].items()}
    pngs = sorted(f for f in os.listdir(sample_dir) if f.endswith(".png"))

    # 4. the disk route over the two folders
    disk_dir = os.path.join(tmp, "eval", "disk")
    disk_wall = run(["-m", "dimsum_torch.calc_metrics", "--metrics",
                     EVAL_METRICS, "--real-dir", real_dir, "--gen-dir",
                     sample_dir, "--image-size", "256", "--detector",
                     EVAL_DETECTOR, "--batch-size", str(EVAL_BATCH),
                     "--cache-dir", os.path.join(tmp, "eval", "cache"),
                     "--run-dir", disk_dir], "calc_metrics run")
    disk = _metric_values(disk_dir)

    # 5. the network against its fp64 run; KID and PR against numpy
    det = InceptionDetector.random(0, "cuda")
    x = np.stack([read_png(os.path.join(real_dir, f"{i:06d}.png"))
                  .transpose(2, 0, 1) for i in range(4)])
    got = det(x)
    plain = copy.deepcopy(det.model).to("cpu", torch.float64)
    with torch.no_grad():
        want = plain(preprocess_uint8(torch.from_numpy(x)).double()).numpy()
    net_err = float(np.abs(got - want).max() / np.abs(want).max())
    del plain
    chunks = os.path.join(sample_dir, "feat-chunks-rank0")
    gen_feats = np.concatenate([np.load(os.path.join(chunks, f))
                                for f in sorted(os.listdir(chunks))])
    real_feats = det(real)
    pr = {impl: compute_precision_recall(real_feats, gen_feats, impl=impl,
                                         device="cuda")
          for impl in ("torch", "numpy")}
    kid = {impl: compute_kid(real_feats, gen_feats, impl=impl,
                             device="cuda") for impl in ("torch", "numpy")}
    # KID is a difference of kernel sums whose terms are ~kid_scale each:
    # near 0 it cancels them, and the numpy route's fp32 sums carry ~1e-7
    # of them, so both routes are held to the fp64 value on that scale
    kid["fp64"] = compute_kid(real_feats.astype(np.float64),
                              gen_feats.astype(np.float64), impl="numpy")
    n_feat = real_feats.shape[1]
    kid_scale = float(((gen_feats.astype(np.float64)
                        @ real_feats.astype(np.float64).T / n_feat + 1)
                       ** 3).mean())
    kid_rel = {impl: abs(kid[impl] - kid["fp64"]) / kid_scale
               for impl in ("torch", "numpy")}

    # 6. InceptionV3 at batch 64 on the card, from uint8 images there
    real_dev = real.cuda()
    inception_ms = cuda_ms(lambda: det.features(real_dev), iters=5)
    first = recs[0]
    sec = first["seconds"]
    calls = (EVAL_SAMPLES // EVAL_BATCH) * (EVAL_STEPS - 1)
    rec = {"phase": "eval", "model": "DiM-L/2", "image_size": 256,
           "dtype": "bfloat16", "cfg_scale": 1.4, "steps": EVAL_STEPS,
           "samples": EVAL_SAMPLES, "batch": EVAL_BATCH, "real": EVAL_REAL,
           "detector": EVAL_DETECTOR,
           "detector_device": first.get("detector_device"),
           "drift_calls": calls,
           "launches": first["launches"],
           "resumed_launches": recs[1]["launches"],
           "resumed_generated_batches": recs[1]["generated_batches"],
           "pngs": len(pngs), "streamed": streamed, "resumed": resumed,
           "resumed_rel": max((abs(resumed.get(k, math.nan) - v)
                               / max(abs(v), 1e-30)
                               for k, v in streamed.items()),
                              default=math.nan),
           "disk": disk,
           "disk_fid_rel": abs(disk.get("fid50k_full", math.nan)
                               - streamed["fid50k_full"])
           / abs(streamed["fid50k_full"]),
           "inception_fp64_err": net_err,
           "pr": pr, "kid": kid, "kid_scale": kid_scale,
           "kid_err_of_scale": kid_rel,
           "generation_images_per_s": EVAL_SAMPLES / sec["generate"],
           "decode_images_per_s": EVAL_SAMPLES / sec["decode"],
           "real_decode_images_per_s": EVAL_REAL / decode_s,
           "inception_images_per_s": real_dev.shape[0] / inception_ms * 1e3,
           "inception_batch": real_dev.shape[0],
           "features_s": sec["features"], "write_s": sec["write"],
           "metrics_s": sec["metrics"],
           "metric_math_s": sum(r["total_time"]
                                for r in first["results"]),
           "cli_seconds": {"streaming": walls[0], "resumed": walls[1],
                           "process": process_wall,
                           "calc_metrics": disk_wall},
           "seconds": time.perf_counter() - phase_t0}
    emit(rec)
    values = list(streamed.values()) + list(disk.values())
    if (rec["launches"] != {"selective_scan_fwd": 32 * calls,
                            "selective_scan_fwd_train": 0,
                            "selective_scan_bwd": 0}
            or any(recs[1]["launches"].values())
            or recs[1]["generated_batches"] != 0
            or len(pngs) != EVAL_SAMPLES
            or sorted(streamed) != ["fid50k_full", "kid50k_full",
                                    "pr50k3_full_precision",
                                    "pr50k3_full_recall"]
            or not all(math.isfinite(v) for v in values)
            or not rec["resumed_rel"] <= 1e-9
            or rec["detector_device"] != "cuda:0"
            or not rec["disk_fid_rel"] <= 1e-3
            or not net_err <= 1e-4
            or pr["torch"] != pr["numpy"]
            or not kid_rel["torch"] <= 1e-6):
        raise AssertionError(f"eval phase failed: {rec}")
    torch.cuda.empty_cache()
    return rec


def phase_sampling_path():
    """The sampling path from a checkpoint (sample-dopri5, sample-sde-512,
    sample-512-fp32 and sample-512-fp32-fused, likelihood) and its
    evaluation (eval) on files written into a temporary directory, removed
    after.  Returns sample-512-fp32's launches and
    sample-512-fp32-fused's."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        ckpt, sds, vae_path = write_checkpoints(tmp)
        phase_sample_dopri5(tmp, ckpt, sds, vae_path)
        path = phase_sample_sde_512(tmp, sds)
        launches, plain = phase_sample_512_fp32(tmp, path)
        fused = phase_sample_512_fp32_fused(tmp, path, plain)
        del plain
        phase_likelihood(tmp, ckpt)
        phase_eval(tmp, ckpt, vae_path)
        return launches, fused


# ---------------------------------------------------------------------------
# training for real: the CLI, remat, data parallelism
# ---------------------------------------------------------------------------

# results a later phase reads (train-cli reads train's record)
RESULTS = {}
# train-cli: a seeded latent memmap of TRAIN_CLI_SAMPLES rows, global batch
# 16: 8 steps an epoch; epoch 0, then resumed for epoch 1.  The loss is
# logged every half epoch: the last window's s/step is the steady one
TRAIN_CLI_SAMPLES, TRAIN_CLI_STEPS = 128, 8
# the published ImageNet recipe (scripts/train.sh), bf16 over fp32 weights,
# at global batch 16 (one card); the content checkpoint every epoch, no
# numbered snapshot (7.4 GB each), the sample grid at epoch 0 only
TRAIN_CLI_ARGS = [
    "--dataset", "latent_memmap", "--model", "DiM-L/2", "--image-size",
    "256", "--num-classes", "1000", "--global-batch-size", "16",
    "--path-type", "GVP", "--diffusion-form", "none", "--lr", "1e-4",
    "--block-type", "combined", "--bimamba-type", "none", "--cond-mamba",
    "--rms-norm", "--fused-add-norm", "--drop-path", "0.1",
    "--label-dropout", "0.15", "--learnable-pe",
    "--use-attn-every-k-layers", "4", "--max-grad-norm", "1", "--bf16",
    "--save-content-every", "1", "--ckpt-every", "1000", "--plot-every",
    "1000", "--log-every", str(TRAIN_CLI_STEPS // 2), "--vae-ckpt",
    "random"]


def _write_latent_memmap(path, n, seed=0):
    """latents.dat (n, 4, 32, 32) fp32 and labels.dat (n,) int64, the
    layout `preprocess.py` writes, from a seed."""
    import os

    import numpy as np

    rng = np.random.default_rng(seed)
    rng.standard_normal((n, 4, 32, 32)).astype(np.float32).tofile(
        os.path.join(path, "latents.dat"))
    rng.integers(0, 1000, n).astype(np.int64).tofile(
        os.path.join(path, "labels.dat"))


def _same_train_state(saved, state) -> dict:
    """Which parts of a live `TrainState` equal a `save_train_state` file's
    contents bit for bit."""
    import torch

    def same(a, b):
        return set(a) == set(b) and all(
            torch.equal(a[k].cpu(), b[k].cpu()) for k in a)

    opt_saved = saved["opt"]["state"]
    opt_live = state.optimizer.state_dict()["state"]
    return {"step": saved["step"] == state.step,
            "model": same(saved["model"], state.model.state_dict()),
            "ema": same(saved["ema"], state.ema_params),
            "adamw": set(opt_saved) == set(opt_live) and all(
                same(opt_saved[i], opt_live[i]) for i in opt_saved)}


def _kernel_ms(prof):
    """Device time of the CUDA kernels a torch.profiler session recorded
    (memcpy and memset left out), or None if it recorded none."""
    from torch.autograd import DeviceType

    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and not e.key.startswith(("Memcpy", "Memset"))]
    if not kernels:
        return None
    return sum(e.self_device_time_total for e in kernels) / 1e3


def _train_cli_resumed(spec: str):
    """The resumed run of train-cli, in a process of its own as a user's
    would be: `train.Trainer` (what the CLI's main runs) with --resume,
    its state held to the saved file, the launch counts set to 0 just
    before its epoch and read just after, and torch.profiler (CUDA
    activity only) recording the steps of its last log window, so that
    their kernel time and the window's wall time are of one run (the
    profiler starts a step earlier, in the window before).  `spec` is a
    JSON [argv, output path]; the record goes to the output path."""
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    from dimsum_torch import train as train_cli

    argv, out = json.loads(spec)
    trainer = train_cli.Trainer(train_cli.parse_args(argv))
    try:
        resumed_at = [trainer.train_steps, trainer.init_epoch]
        saved = torch.load(os.path.join(
            trainer.content_dir, f"{resumed_at[0]:07d}.pt"),
            map_location="cpu", weights_only=False, mmap=True)
        same = _same_train_state(saved, trainer.state)
        del saved
        counts = _zeroed_scan_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        # train step k runs in the profiler's step k: the last window's
        # steps are recorded, the one before them warms the profiler up
        window = trainer.args.log_every
        step = trainer.train_step
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=TRAIN_CLI_STEPS - window,
                                       warmup=1, active=window)) as prof:
            def profiled_step(*args, **kwargs):
                prof.step()
                return step(*args, **kwargs)

            trainer.train_step = profiled_step
            trainer.fit()
            torch.cuda.synchronize()
        rec = {"resumed_at_step_epoch": resumed_at,
               "resumed_state_equals_file": same,
               "launches": {k: c.launches for k, c in counts.items()},
               "max_memory_allocated_GB":
                   torch.cuda.max_memory_allocated() / 1e9,
               "windows": [{"steps": h["steps"], "seconds": h["seconds"]}
                           for h in trainer.history],
               "losses": [h["loss"] for h in trainer.history],
               "last_window_kernel_ms": _kernel_ms(prof),
               "native_gather": trainer.dataset.is_native}
    finally:
        trainer.close()
    with open(out, "w") as f:
        json.dump(rec, f)


def phase_train_cli():
    """train-cli: `python -m dimsum_torch.train` on full-width DiM-L/2 at
    256 px with the published flags (TRAIN_CLI_ARGS) from a seeded latent
    memmap, epoch 0 in a process of its own; then resumed for epoch 1 in
    another (`_train_cli_resumed`), whose last log window gives the
    device idle share: its kernels' time against its wall time, with the
    profiler's own host cost in it.  Two content checkpoints of 7.4 GB
    are written (the keep-2 rotation is left to the CPU test
    `test_trains_and_rotates_checkpoints`, for the smoke's time limit).
    Alone: python3 -c "import chip_smoke as s; s.phase_train_cli()"."""
    import os
    import re
    import subprocess
    import tempfile

    from dimsum_torch.utils.ckpt import checkpoint_steps
    from dimsum_torch.utils.png import read_png

    phase_t0 = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    bench = RESULTS.get("train")

    def run(cmd, what):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, *cmd], cwd=root,
                              capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr)
            raise AssertionError(f"train-cli: the {what} exited "
                                 f"{proc.returncode}")
        return proc.stderr, time.perf_counter() - t0

    with tempfile.TemporaryDirectory() as tmp:
        _write_latent_memmap(tmp, TRAIN_CLI_SAMPLES)
        argv = ["--exp", "cli", "--datadir", tmp, "--results-dir",
                os.path.join(tmp, "results"), *TRAIN_CLI_ARGS]
        exp = os.path.join(tmp, "results", "cli")
        log, first_seconds = run(
            ["-m", "dimsum_torch.train", *argv, "--epochs", "0"],
            "first run")
        first_losses = [float(v) for v in re.findall(r"loss=(\S+)", log)]
        first_rates = [float(v) for v in
                       re.findall(r"steps/sec=(\S+)", log)]
        content_after_first = checkpoint_steps(os.path.join(exp, "content"))
        grid_path = os.path.join(exp, "samples_epoch00000.png")
        grid = read_png(grid_path) if os.path.exists(grid_path) else None

        out = os.path.join(tmp, "resumed.json")
        spec = json.dumps([[*argv, "--epochs", "1", "--resume"], out])
        _, second_seconds = run(
            ["-c", "import sys, chip_smoke as s; "
                   "s._train_cli_resumed(sys.argv[1])", spec],
            "resumed run")
        with open(out) as f:
            resumed = json.load(f)
        content = checkpoint_steps(os.path.join(exp, "content"))
        snapshots = checkpoint_steps(os.path.join(exp, "checkpoints"))
    steps = TRAIN_CLI_STEPS
    # the CLI's s/step: the last log window of its own process (steps
    # 5-8), as a user's run reads it
    s_per_step = 1 / first_rates[-1] if first_rates else math.inf
    launches, losses = resumed["launches"], resumed["losses"]
    last = resumed["windows"][-1] if resumed["windows"] else None
    kernel_ms = resumed["last_window_kernel_ms"]
    measured = last is not None and kernel_ms is not None
    rec = {"phase": "train-cli", "model": "DiM-L/2", "image_size": 256,
           "batch": 16, "dtype": "bf16 over fp32 weights",
           "samples": TRAIN_CLI_SAMPLES, "steps_per_epoch": steps,
           "first_run": {"epochs": [0], "seconds": first_seconds,
                         "losses": first_losses,
                         "steps_per_sec": first_rates,
                         "content_steps": content_after_first,
                         "grid_shape": None if grid is None
                         else list(grid.shape)},
           "second_run_seconds": second_seconds, **resumed,
           "content_steps": content, "snapshot_steps": snapshots,
           "s_per_step": s_per_step,
           # the resumed run's last window (under the profiler)
           "resumed_s_per_step": None if last is None
           else last["seconds"] / last["steps"],
           # None: the profiler recorded no kernel (not measured)
           "resumed_device_ms_per_step": kernel_ms / last["steps"]
           if measured else None,
           "resumed_device_idle_share": max(
               0.0, 1 - kernel_ms / 1e3 / last["seconds"])
           if measured else None,
           "train_bench": None if bench is None else {
               "s_per_step": bench["s_per_step"],
               "max_memory_allocated_GB": bench["max_memory_allocated_GB"]},
           "seconds": time.perf_counter() - phase_t0}
    emit(rec)
    finite = bool(losses and first_losses
                  and all(math.isfinite(v) for v in losses + first_losses))
    if (not finite or resumed["resumed_at_step_epoch"] != [steps, 1]
            or not all(resumed["resumed_state_equals_file"].values())
            or launches["selective_scan_fwd"] != 0
            or launches["selective_scan_fwd_train"] != 32 * steps
            or launches["selective_scan_bwd"] != 32 * steps
            or not resumed["native_gather"]
            or [w["steps"] for w in resumed["windows"]]
            != [steps // 2, steps // 2]
            or content_after_first != [steps]
            or content != [steps, 2 * steps]
            or snapshots != [] or grid is None
            or grid.shape != (1024, 1024, 3) or grid.std() == 0):
        raise AssertionError(f"train-cli phase failed: {rec}")
    return {"selective_scan_fwd_train": launches["selective_scan_fwd_train"],
            "selective_scan_bwd": launches["selective_scan_bwd"]}


REMAT_BENCH_STEPS, REMAT_BENCH_WARMUP = 3, 1


def _deterministic():
    """TF32 off, cuDNN's deterministic algorithms and the plain (math)
    SDPA, whose backward sums in a fixed order (the memory-efficient one
    adds with atomics): a context in which two runs of one step give the
    same bits."""
    import contextlib

    import torch
    from torch.nn.attention import SDPBackend, sdpa_kernel

    stack = contextlib.ExitStack()
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.backends.cudnn.deterministic)

    def restore():
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32,
         torch.backends.cudnn.deterministic) = flags

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    stack.callback(restore)
    stack.enter_context(sdpa_kernel(SDPBackend.MATH))
    return stack


def phase_train_remat():
    """train-remat: one fp32 training step of full-width DiM-L/2 at batch
    2 (label dropout and drop path 0.1, the same generator seed) without
    remat, twice, and with --grad-checkpoint under the policies None and
    "scan"; then train_bench's bf16 protocol at batch 16 with and without
    remat: s/step and peak memory.  Alone: python3 -c "import chip_smoke
    as s; s.phase_train_remat()"."""
    import torch

    from dimsum_torch import train_bench
    from dimsum_torch.transport import create_transport
    from dimsum_torch.utils import remat

    phase_t0 = time.perf_counter()
    gc.collect()
    gc.freeze()  # see phase_train_cli
    with _deterministic():
        model = _train_model(torch.float32)
        transport = create_transport("GVP", "velocity")
        g = torch.Generator(device="cuda").manual_seed(3)
        x = torch.randn((2, 4, 32, 32), generator=g, device="cuda")
        y = torch.randint(0, 1000, (2,), generator=g, device="cuda")

        def step(policy):
            model.remat_keep = None if policy == "off" else \
                remat.parse_policy(policy)
            gen = torch.Generator(device="cuda").manual_seed(4)
            model.zero_grad(set_to_none=True)
            counts = _zeroed_scan_counts()
            loss = transport.training_losses(
                lambda xt, t, **kw: model(xt, t, train=True, generator=gen,
                                          **kw), x, gen,
                {"y": y})["loss"].mean()
            loss.backward()
            torch.cuda.synchronize()
            return (loss.item(), {n: p.grad.clone() for n, p in
                                  model.named_parameters()
                                  if p.grad is not None},
                    {k: c.launches for k, c in counts.items()},
                    gen.get_state())

        base = step("off")
        runs = {"off (again)": step("off"), "None": step(None),
                "scan": step("scan")}
        model.remat_keep = None

    def errs(run):
        return max(_scaled_err(run[1][n], base[1][n]) for n in base[1])

    spread = errs(runs["off (again)"])
    # two runs without remat set the tolerance: 0 where they agree
    tol = 4 * spread
    fp32 = {name: {"loss": r[0], "loss_equal": r[0] == base[0],
                   "worst_grad_scaled_err": errs(r),
                   "same_grad_set": set(r[1]) == set(base[1]),
                   "generator_state_equal": torch.equal(r[3], base[3]),
                   "launches": r[2]} for name, r in runs.items()}
    want = {"off (again)": [0, 32, 32], "None": [0, 64, 32],
            "scan": [0, 32, 32]}
    del model, base, runs
    torch.cuda.empty_cache()

    bf16 = {}
    for name, kw in (("off", {}), ("None", dict(grad_checkpoint=True)),
                     ("scan", dict(grad_checkpoint=True,
                                   remat_policy="scan"))):
        counts = _zeroed_scan_counts()
        record, state = train_bench.run(batch=16, bf16=True,
                                        steps=REMAT_BENCH_STEPS,
                                        warmup=REMAT_BENCH_WARMUP,
                                        device="cuda", seed=0, **kw)
        torch.cuda.synchronize()
        n = REMAT_BENCH_STEPS + REMAT_BENCH_WARMUP
        bf16[name] = {"s_per_step": record["s_per_step"],
                      "max_memory_allocated_GB":
                          record["max_memory_allocated_GB"],
                      "launches_per_step": {
                          k: c.launches / n for k, c in counts.items()},
                      "finite": all(map(math.isfinite, record["loss"]))}
        del state
        torch.cuda.empty_cache()
    gc.unfreeze()
    rec = {"phase": "train-remat", "model": "DiM-L/2", "fp32_batch": 2,
           "tf32": False, "sdpa": "math", "tol": tol, "spread": spread,
           "fp32": fp32, "bf16_batch": 16, "bf16": bf16,
           "seconds": time.perf_counter() - phase_t0}
    emit(rec)
    bad = [name for name, r in fp32.items()
           if not r["worst_grad_scaled_err"] <= tol or not r["same_grad_set"]
           or not r["generator_state_equal"]
           or (tol == 0 and not r["loss_equal"])
           or [r["launches"][k] for k in ("selective_scan_fwd",
                                          "selective_scan_fwd_train",
                                          "selective_scan_bwd")]
           != want[name]]
    per_step = {"off": 32, "None": 64, "scan": 32}
    bad += [name for name, r in bf16.items()
            if not r["finite"] or r["launches_per_step"] != {
                "selective_scan_fwd": 0,
                "selective_scan_fwd_train": per_step[name],
                "selective_scan_bwd": 32}]
    if (bad or not bf16["None"]["max_memory_allocated_GB"]
            < bf16["off"]["max_memory_allocated_GB"]
            or not bf16["scan"]["max_memory_allocated_GB"]
            < bf16["off"]["max_memory_allocated_GB"]):
        raise AssertionError(f"train-remat phase failed ({bad}): {rec}")


# train-ddp: 2 ranks on the one card, DiM-L/2 at full width and depth 4
DDP_RANKS, DDP_DEPTH, DDP_STEPS, DDP_BATCH, DDP_SEED = 2, 4, 2, 2, 11
DDP_LR, DDP_EMA = 1e-3, 0.9
DDP_TIMEOUT, DDP_DEADLINE = 300, 420


def _ddp_state():
    import dataclasses

    import torch

    from dimsum_torch.models.dim import DiM_models, build_dim
    from dimsum_torch.parallel import create_optimizer, create_train_state

    cfg = dataclasses.replace(
        DiM_models["DiM-L/2"](img_resolution=32, num_classes=1000,
                              use_attn_every_k_layers=4, label_dropout=0.1,
                              drop_path=0.1, dtype=torch.float32),
        depth=DDP_DEPTH)
    model = build_dim(cfg, "cuda", seed=0, train=True)
    return create_train_state(model, create_optimizer(model, lr=DDP_LR))


def _ddp_data(k):
    import torch

    g = torch.Generator(device="cuda").manual_seed(5)
    shape = (DDP_STEPS, k * DDP_BATCH)
    return (torch.randn((*shape, 4, 32, 32), generator=g, device="cuda"),
            torch.randint(0, 1000, shape, generator=g, device="cuda"))


def _flat_state(state):
    import torch

    return torch.cat([p.detach().reshape(-1)
                      for p in state.model.parameters()]
                     + [e.reshape(-1) for e in state.ema_params.values()])


def _ddp_rank(rank, k, port, out_dir, backend):
    """One rank of train-ddp, a process of its own on the one card (gloo)
    or on card `rank` (NCCL): `init_distributed`, DDP_STEPS data-parallel
    steps on its slice of each batch with its own generator; rank 0 then
    replays every rank's micro-batches in one model and writes the
    record."""
    import os

    import torch
    import torch.distributed as dist

    from dimsum_torch.parallel import init_distributed, make_train_step
    from dimsum_torch.transport import create_transport

    torch.cuda.set_device(rank if backend == "nccl" else 0)
    init_distributed(f"localhost:{port}", k, rank, "cuda", backend=backend,
                     timeout_s=DDP_TIMEOUT)
    try:
        with _deterministic():
            x, y = _ddp_data(k)
            state = _ddp_state()
            step = make_train_step(
                state.model, create_transport("GVP", "velocity"),
                state.optimizer, max_grad_norm=1.0, ema_decay=DDP_EMA,
                group=dist.group.WORLD)
            gen = torch.Generator(device="cuda").manual_seed(
                DDP_SEED * k + rank)
            counts = _zeroed_scan_counts()
            sl = slice(rank * DDP_BATCH, (rank + 1) * DDP_BATCH)
            t0 = time.perf_counter()
            losses = [step(state, x[s, sl], y[s, sl], gen)["loss"].item()
                      for s in range(DDP_STEPS)]
            seconds = time.perf_counter() - t0
            launches = {n: c.launches for n, c in counts.items()}
            flat = _flat_state(state)
            ref = flat.clone()
            dist.broadcast(ref, src=0)
            flags = [None] * k
            dist.all_gather_object(flags, (torch.equal(ref, flat), launches))
            if rank == 0:
                rec = _ddp_replay(state, losses, x, y, k)
                rec.update(replicas_equal=[f[0] for f in flags],
                           launches=[f[1] for f in flags],
                           dp_seconds=seconds)
                with open(os.path.join(out_dir, "rank0.json"), "w") as f:
                    json.dump(rec, f)
    finally:
        dist.destroy_process_group()


def _ddp_replay(dp_state, dp_losses, x, y, k):
    """One process: each step, rank 0's micro-batch, then rank 1's, ...,
    each with its rank's generator, the gradients summed and divided by
    k, then the same clip, AdamW and EMA; compared with the data-parallel
    state."""
    import torch

    from dimsum_torch.parallel import clip_by_global_norm, ema_update
    from dimsum_torch.transport import create_transport

    state = _ddp_state()
    model, params = state.model, list(state.model.parameters())
    transport = create_transport("GVP", "velocity")
    gens = [torch.Generator(device="cuda").manual_seed(DDP_SEED * k + r)
            for r in range(k)]
    noise = {n: torch.zeros_like(p, dtype=torch.bool)
             for n, p in model.named_parameters()}
    losses = []
    for s in range(DDP_STEPS):
        model.zero_grad(set_to_none=True)
        total = 0.0
        for r in range(k):
            sl = slice(r * DDP_BATCH, (r + 1) * DDP_BATCH)
            loss = transport.training_losses(
                lambda xt, t, **kw: model(xt, t, train=True,
                                          generator=gens[r], **kw),
                x[s, sl], gens[r], {"y": y[s, sl]})["loss"].mean()
            loss.backward()
            total = total + loss.detach()
        with torch.no_grad():
            for n, p in model.named_parameters():
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
                p.grad.div_(k)
                g = p.grad.abs()
                noise[n] |= g <= 1e-3 * g.max().clamp_min(1e-30)
        losses.append((total / k).item())
        clip_by_global_norm(params, 1.0)
        state.optimizer.step()
        ema_update(state.ema_params, model, DDP_EMA)
    torch.cuda.synchronize()
    worst = {"weights": 0.0, "ema": 0.0, "noise_weights": 0.0,
             "noise_ema": 0.0}
    exact = True
    dp_params = dict(dp_state.model.named_parameters())
    for n, p in model.named_parameters():
        for key, got, want in (("weights", dp_params[n].detach(), p.detach()),
                               ("ema", dp_state.ema_params[n],
                                state.ema_params[n])):
            d = (got - want).abs()
            exact &= bool(torch.equal(got, want))
            # beyond the tolerance, in units of it: atol 2e-6 + rtol 1e-5
            # (the CPU test's), or for noise entries 2 lr a step
            rel = d / (2e-6 + 1e-5 * want.abs())
            if (~noise[n]).any():
                worst[key] = max(worst[key], rel[~noise[n]].max().item())
            if noise[n].any():
                worst["noise_" + key] = max(
                    worst["noise_" + key],
                    (d[noise[n]] / (2 * DDP_LR * DDP_STEPS)).max().item())
    return {"losses": dp_losses, "replay_losses": losses,
            "loss_rel_err": max(abs(a - b) / abs(b)
                                for a, b in zip(dp_losses, losses)),
            "worst_in_tolerances": worst, "bit_for_bit": exact}


def phase_train_ddp(ranks: int = DDP_RANKS, backend: str = "gloo"):
    """train-ddp: data-parallel training on `ranks` processes joined
    through `init_distributed`: by gloo on the one card (the default; NCCL
    cannot put two ranks on one GPU), or by NCCL one rank a card on a
    machine with `ranks` cards.  DiM-L/2 at full width and depth DDP_DEPTH
    (cut from 16), fp32 with TF32 off: DDP_STEPS steps of DDP_BATCH a rank
    with each rank's generator (seed DDP_SEED * ranks + rank), against one
    process replaying every rank's micro-batches in turn.  The loss to
    rtol 1e-6, the weights and the EMA to atol 2e-6 + rtol 1e-5, entries
    whose gradient is rounding noise to 2 lr a step (as the CPU test,
    tests/test_torch_ddp.py).  Alone: python3 -c "import chip_smoke as s;
    s.phase_train_ddp()"; on 4 cards s.phase_train_ddp(4, "nccl")."""
    import os
    import socket
    import tempfile

    import torch
    import torch.multiprocessing as mp

    from dimsum_torch.ops import cuda_build

    phase_t0 = time.perf_counter()
    cuda_build.build()  # here, not in each rank
    torch.cuda.empty_cache()
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        ctx = mp.start_processes(_ddp_rank,
                                 args=(ranks, port, tmp, backend),
                                 nprocs=ranks, join=False,
                                 start_method="spawn")
        try:
            while not ctx.join(timeout=5):
                if time.perf_counter() - t0 > DDP_DEADLINE:
                    raise TimeoutError(f"train-ddp: ranks still running "
                                       f"after {DDP_DEADLINE} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
                    p.join(10)
        with open(os.path.join(tmp, "rank0.json")) as f:
            r0 = json.load(f)
    per_rank = 2 * DDP_DEPTH * DDP_STEPS
    rec = {"phase": "train-ddp", "model": f"DiM-L/2 at depth {DDP_DEPTH}",
           "ranks": ranks, "backend": backend, "batch_per_rank":
           DDP_BATCH, "steps": DDP_STEPS, "dtype": "float32", "tf32": False,
           "lr": DDP_LR, "group_seconds": time.perf_counter() - t0, **r0,
           "seconds": time.perf_counter() - phase_t0}
    emit(rec)
    worst = r0["worst_in_tolerances"]
    if (not all(r0["replicas_equal"]) or not r0["loss_rel_err"] <= 1e-6
            or not all(math.isfinite(v) for v in r0["losses"])
            or max(worst.values()) > 1
            or any(n != {"selective_scan_fwd": 0,
                         "selective_scan_fwd_train": per_rank,
                         "selective_scan_bwd": per_rank}
                   for n in r0["launches"])):
        raise AssertionError(f"train-ddp phase failed: {rec}")


# ---------------------------------------------------------------------------
# parallel: tensor, expert and pipeline parallelism as ranks on the one card,
# the bf16 residual stream, the JAX opt-in switches
# ---------------------------------------------------------------------------

PAR_RANKS = 2
PAR_TIMEOUT, PAR_DEADLINE = 420, 480
PAR_TRAIN_STEPS, PAR_TRAIN_BATCH, PAR_TRAIN_LR = 2, 2, 1e-4
PAR_SAMPLE_STEPS = 4  # Euler grid points of the TP, PP and bf16 runs
# DiM-L/2's published flags beside --model and --image-size, fp32 (the
# CLIs' default)
PAR_MODEL_ARGS = ["--num-classes", "1000", "--label-dropout", "0.1",
                  "--block-type", "combined",
                  "--bimamba-type", "none", "--rms-norm", "--cond-mamba",
                  "--learnable-pe", "--use-attn-every-k-layers", "4"]
PAR_ARGS = ["--model", "DiM-L/2", "--image-size", "256", *PAR_MODEL_ARGS,
            "--path-type", "GVP"]
PAR_SAMPLE_ARGS = [*PAR_ARGS, "--sampling-method", "euler",
                   "--num-sampling-steps", str(PAR_SAMPLE_STEPS),
                   "--cfg-scale", "1.4", "--device", "cuda"]
# the four fused-kernel switches of leg (b), as a user sets them (the
# deferred tail through the norm + modulate kernel: FUSED_LAUNCHES[2])
PAR_FUSED_ENV = {"DIMSUM_PALLAS_NORM": "1", "DIMSUM_FUSED_NORM": "1",
                 "DIMSUM_CONV_XPROJ": "1", "DIMSUM_PENDING_TAIL": "2"}


def _par_counts(zero: bool = False):
    """Every kernel's launch count the parallel phase reads (set to 0
    first with `zero`)."""
    from dimsum_torch.ops import full_attention as attention_ops
    from dimsum_torch.ops import selective_scan as ss
    from dimsum_torch.ops.conv_xproj import conv_xproj_cuda
    from dimsum_torch.ops.norms import add_norm_cuda, norm_modulate_cuda

    fields = {
        "selective_scan_fwd": (ss.selective_scan_cuda, "launches"),
        "selective_scan_fwd_train": (ss.selective_scan_fwd_train_cuda,
                                     "launches"),
        "selective_scan_bwd": (ss.selective_scan_bwd_core_cuda, "launches"),
        "conv_xproj": (conv_xproj_cuda, "launches"),
        "add_norm": (add_norm_cuda, "launches"),
        "add_norm_bf16_residual": (add_norm_cuda, "bf16_residual_launches"),
        "norm_modulate": (norm_modulate_cuda, "launches"),
        "norm_modulate_bf16_residual": (norm_modulate_cuda,
                                        "bf16_residual_launches"),
        **{n: (getattr(attention_ops, n), "launches")
           for n in ATTENTION_KERNELS}}
    if zero:
        for fn, attr in fields.values():
            setattr(fn, attr, 0)
    return {k: getattr(fn, attr) for k, (fn, attr) in fields.items()}


def _rel_err(got, want):
    """max |got - want| over max |want|."""
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp_min(1e-30)).item()


class _env:
    """A context that sets environment variables and restores them."""

    def __init__(self, **env):
        self.env, self.saved = env, {}

    def __enter__(self):
        import os

        for k, v in self.env.items():
            self.saved[k] = os.environ.get(k)
            os.environ[k] = v

    def __exit__(self, *exc):
        import os

        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _par_train(rank, k, port, tmp):
    """Leg (a): `python -m dimsum_torch.train --tp 2 --is-moe` (its
    argument parsing and Trainer) for PAR_TRAIN_STEPS fp32 steps (TF32
    off), stopped before the epoch's end (the epoch's content save would
    write this model's 10 GB state); then, on rank 0, the same steps of
    the unsharded model (all 8 experts on one rank, the same capacity
    dispatch: the JAX `switch_ep_gspmd` with mesh=None) from the same
    weights, batches and generator.  Held (`_par_train_errors`): each
    step's loss and grad_norm, the first step's gradients leaf by leaf
    (gathered from the shards; AdamW's steps hide a gradient's scale),
    and the weights after the steps leaf by leaf.  Returns the record
    (rank 0)."""
    import gc

    import torch
    import torch.distributed as dist

    from dimsum_torch import train as train_cli
    from dimsum_torch.data import device_batches
    from dimsum_torch.models.factory import build_model
    from dimsum_torch.parallel import (create_optimizer, create_train_state,
                                       gather_state_dict, make_train_step)
    from dimsum_torch.utils.ckpt import full_names

    argv = ["--exp", "tp", "--datadir", tmp, "--results-dir",
            f"{tmp}/results", "--dataset", "latent_memmap", *PAR_ARGS,
            "--is-moe", "--global-batch-size", str(PAR_TRAIN_BATCH),
            "--num-workers", "1", "--log-every", "1000", "--lr",
            str(PAR_TRAIN_LR), "--tp", str(k), "--num-processes", str(k),
            "--process-id", str(rank), "--coordinator",
            f"localhost:{port}", "--device", "cuda"]
    trainer = train_cli.Trainer(train_cli.parse_args(argv))
    try:
        batches, losses, norms, grads = [], [], [], None
        _par_counts(zero=True)
        trainer.loader.set_epoch(0)
        t0 = time.perf_counter()
        for x, y in device_batches(trainer.loader, trainer.device):
            if len(losses) == PAR_TRAIN_STEPS:
                break
            batches.append((x, y))
            out = trainer.train_step(trainer.state, x, y, trainer.generator)
            losses.append(out["loss"].item())
            norms.append(out["grad_norm"].item())
            if grads is None:  # the first step's (clipped) gradients
                grads = {n: p.grad.clone() for n, p in
                         trainer.state.model.named_parameters()}
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = _par_counts()
        tp_sd = gather_state_dict(trainer.state.model.state_dict(),
                                  trainer.tp_group,
                                  order=full_names(trainer.state.model)[1])
        tp_grads = gather_state_dict(grads, trainer.tp_group)
        del grads
        cfg, args = trainer.cfg, trainer.args
        local_params = sum(p.numel() for p in
                           trainer.state.model.parameters())
        trainer.state = None
        gc.collect()
        torch.cuda.empty_cache()
        ones = [dist.new_group([r]) for r in range(k)]  # every rank calls
        rec = None
        if rank != 0:
            del tp_sd, tp_grads
        else:
            model = build_model(dataclasses_replace(cfg, tp_group=ones[0]),
                                trainer.device, seed=args.global_seed,
                                train=True)
            opt = create_optimizer(model, lr=args.lr, weight_decay=0.0)
            state = create_train_state(model, opt)
            step = make_train_step(model, trainer.transport, opt,
                                   max_grad_norm=args.max_grad_norm,
                                   ema_decay=args.ema_decay,
                                   tp_group=ones[0])
            gen = torch.Generator(trainer.device).manual_seed(
                args.global_seed)
            errs = _par_train_errors(model, state, step, batches, gen,
                                     tp_sd, tp_grads)
            rec = {"leg": "a", "cli": "python -m dimsum_torch.train --tp 2 "
                   "--is-moe", "steps": len(losses), "losses": losses,
                   "grad_norms": norms,
                   "loss_rel_err": max(abs(a - b) / abs(b) for a, b in
                                       zip(losses, errs["ref_losses"])),
                   "grad_norm_rel_err": max(
                       abs(a - b) / abs(b)
                       for a, b in zip(norms, errs["ref_grad_norms"])),
                   **errs, "launches_rank0": launches, "seconds": seconds,
                   "params_rank0": local_params,
                   "params_full": sum(p.numel() for p in model.parameters()),
                   "gathered_keys_equal": list(tp_sd)
                   == list(model.state_dict())}
            del model, state, opt, tp_sd, tp_grads
        dist.barrier()
        return rec
    finally:
        trainer.close()


def _par_train_errors(model, state, step, batches, gen, tp_sd, tp_grads):
    """The unsharded steps of leg (a) and the TP run's distance from them,
    each leaf's worst reported by name:

    * `grad_err`: the first step's gradients, max |g_tp - g| over the
      leaf's largest |g|, floored at 1e-2 of the model's largest (a leaf
      whose true gradient is 0, such as attention key biases, is rounding
      noise); limit 1e-4;
    * `weights_err`: the weights after the steps in units of 2e-6 +
      1e-5 |w| (the CPU test's), over the entries whose gradient is
      above noise in every step (above 1e-3 of its leaf's largest, as
      phase train-ddp); limit 1.  The others take AdamW steps of
      lr * noise / eps that hang on the order of the sums: their share is
      reported."""
    import torch

    params = dict(model.named_parameters())
    noise = {n: torch.zeros_like(p, dtype=torch.bool)
             for n, p in params.items()}
    ref_losses, ref_norms = [], []
    grad_err, grad_leaf = 0.0, None
    for i, (x, y) in enumerate(batches):
        out = step(state, x, y, gen)
        ref_losses.append(out["loss"].item())
        ref_norms.append(out["grad_norm"].item())
        with torch.no_grad():
            peak = {n: p.grad.abs().max().item() for n, p in params.items()}
            for n, p in params.items():
                noise[n] |= p.grad.abs() <= 1e-3 * max(peak[n], 1e-30)
            if i == 0:
                floor = 1e-2 * max(peak.values())
                for n, p in params.items():
                    d = (tp_grads[n] - p.grad).abs().max().item()
                    e = d / max(peak[n], floor, 1e-30)
                    if e > grad_err:
                        grad_err, grad_leaf = e, n
    weights_err, weights_leaf, noisy, total = 0.0, None, 0, 0
    with torch.no_grad():
        for n, want in model.state_dict().items():
            rel = (tp_sd[n] - want).abs() / (2e-6 + 1e-5 * want.abs())
            mask = noise.get(n)
            if mask is not None:
                noisy += int(mask.sum())
                rel = rel[~mask]
            total += want.numel()
            if rel.numel() and rel.max().item() > weights_err:
                weights_err, weights_leaf = rel.max().item(), n
    return {"ref_losses": ref_losses, "ref_grad_norms": ref_norms,
            "grad_err": grad_err, "grad_worst_leaf": grad_leaf,
            "weights_err": weights_err, "weights_worst_leaf": weights_leaf,
            "noise_share": noisy / total}


def dataclasses_replace(obj, **kw):
    import dataclasses

    return dataclasses.replace(obj, **kw)


def _par_sample_tp(rank, k, port, tmp):
    """Leg (b): `python -m dimsum_torch.sample_ddp --tp 2` with the fused
    switches in the environment (rows 1, 5, 6 and 7 on the ranks'
    shards); rank 0 then runs the same command without --tp.  Returns the
    record (rank 0)."""
    import torch

    from dimsum_torch import sample_ddp

    argv = ["ODE", *PAR_SAMPLE_ARGS, "--per-proc-batch-size", "2",
            "--num-fid-samples", "2"]
    with _env(**PAR_FUSED_ENV):
        _par_counts(zero=True)
        t0 = time.perf_counter()
        got = sample_ddp.main([*argv, "--sample-dir", f"{tmp}/tp", "--tp",
                               str(k), "--num-processes", str(k),
                               "--process-id", str(rank), "--coordinator",
                               f"localhost:{port}"])
        seconds = time.perf_counter() - t0
        launches = _par_counts()
        if rank != 0:
            return None
        want = sample_ddp.main([*argv, "--sample-dir", f"{tmp}/one"])
    got_t, want_t = (torch.as_tensor(r["latents"]) for r in (got, want))
    return {"leg": "b", "cli": "python -m dimsum_torch.sample_ddp --tp 2",
            "env": PAR_FUSED_ENV, "shape": list(got_t.shape),
            "rel_err": _rel_err(got_t, want_t),
            "finite": bool(torch.isfinite(got_t).all()),
            "launches_rank0": launches, "seconds": seconds}


def _par_sample_pp(rank, k, port, tmp):
    """Leg (c): `python -m dimsum_torch.sample --pp 2` (2 stages of 8
    blocks, 2 microbatches), its stages being these ranks; rank 0 then
    runs the command without --pp.  Returns the record (rank 0)."""
    import torch

    from dimsum_torch import sample

    argv = ["ODE", *PAR_SAMPLE_ARGS, "--global-batch-size", "2"]
    _par_counts(zero=True)
    t0 = time.perf_counter()
    got = sample.main([*argv, "--sample-dir", f"{tmp}/pp", "--pp", str(k),
                       "--pp-microbatches", "2"], _stage=(rank, k, port))
    seconds = time.perf_counter() - t0
    launches = _par_counts()
    if rank != 0:
        return None
    want = sample.main([*argv, "--sample-dir", f"{tmp}/pp-one"])
    return {"leg": "c", "cli": "python -m dimsum_torch.sample --pp 2",
            "stages": k, "microbatches": 2,
            "rel_err": _rel_err(got["samples"], want["samples"]),
            "finite": bool(torch.isfinite(got["samples"]).all()),
            "launches_rank0": launches, "seconds": seconds}


def _par_rank(rank, k, ports, tmp):
    """One rank of the parallel phase: legs (a), (b) and (c) in turn, each
    in its own process group (the CLIs make and end theirs), TF32 off;
    rank 0 writes the records."""
    import os

    import torch

    torch.cuda.set_device(0)
    recs = []
    with _deterministic():
        for leg, port in zip((_par_train, _par_sample_tp, _par_sample_pp),
                             ports):
            t0 = time.perf_counter()
            rec = leg(rank, k, port, tmp)
            if rank == 0:
                rec["leg_seconds"] = time.perf_counter() - t0
                recs.append(rec)
            torch.cuda.empty_cache()
    if rank == 0:
        with open(os.path.join(tmp, "par.json"), "w") as f:
            json.dump(recs, f)


def _par_bf16_residual():
    """Leg (d): `python -m dimsum_torch.bench --bf16-residual` under
    DIMSUM_PALLAS_NORM=1 DIMSUM_FUSED_NORM=1 (and with
    DIMSUM_PENDING_TAIL=2, whose deferred top sites take the norm +
    modulate kernel on the bf16 residual): a short bf16 sample, its
    launches, then one CFG forward of the same bf16 model held to the fp32
    plain route (fp32 weights and residual, the plain norms) on the same
    inputs."""
    import torch

    from dimsum_torch import bench
    from dimsum_torch.models.dim import DiM_models, forward_with_cfg
    from dimsum_torch.models.factory import build_model, fused_switches

    recs = []
    for tail in ("0", "2"):
        with _env(DIMSUM_PALLAS_NORM="1", DIMSUM_FUSED_NORM="1",
                  DIMSUM_PENDING_TAIL=tail):
            fused = fused_switches()
        _par_counts(zero=True)
        rec, out = bench.run(batch=4, steps=PAR_SAMPLE_STEPS, dtype="bf16",
                             device="cuda", residual_in_fp32=False,
                             **fused)
        torch.cuda.synchronize()
        launches = _par_counts()
        cfg = DiM_models["DiM-L/2"](img_resolution=32, num_classes=1000,
                                    use_attn_every_k_layers=4,
                                    dtype=torch.bfloat16,
                                    residual_in_fp32=False, **fused)
        net = build_model(cfg, "cuda", seed=0)
        ref = build_model(dataclasses_replace(
            cfg, dtype=torch.float32, residual_in_fp32=True,
            pallas_norm=False, fused_norm=False, pending_tail=0), "cuda",
            seed=0)
        g = torch.Generator(device="cuda").manual_seed(3)
        x = torch.randn(8, 4, 32, 32, generator=g, device="cuda")
        t = torch.rand(8, generator=g, device="cuda")
        y = torch.randint(0, 1000, (8,), generator=g, device="cuda")
        with torch.inference_mode(), _deterministic():
            got = forward_with_cfg(net, x, t, y, cfg_scale=1.4)
            for m in ref.modules():
                for attr in ("attn_impl", "norm_impl", "scan_impl",
                             "conv_impl"):
                    if hasattr(m, attr):
                        setattr(m, attr, "ref")
            want = forward_with_cfg(ref, x, t, y, cfg_scale=1.4)
        del net, ref
        torch.cuda.empty_cache()
        recs.append({"leg": "d", "cli": "python -m dimsum_torch.bench "
                     "--bf16-residual", "pending_tail": int(tail),
                     "img_per_s": rec["value"], "seconds": rec["seconds"],
                     "sample_finite": bool(torch.isfinite(out).all()),
                     "launches": launches,
                     "forward_rel_err_vs_fp32_plain": _rel_err(got, want),
                     "forward_finite": bool(torch.isfinite(got).all())})
    return recs


# leg (e): each JAX opt-in switch, its value, the image size it acts at
PAR_SWITCHES = (
    ("DIMSUM_DWT_CL", "1", 256), ("DIMSUM_FUSED_WAVELET", "1", 256),
    ("DIMSUM_NORM_MXU", "1", 256), ("DIMSUM_FLASH_ATTN", "1", 256),
    ("DIMSUM_DWT_CL", "1", 512), ("DIMSUM_WAVELET_ONE_REARRANGE", "1", 512),
    ("DIMSUM_FULL_ATTN", "1", 512), ("DIMSUM_FULL_ATTN", "0", 512))
PAR_SWITCH_REPEATS = 3  # timed warm forwards a route (the median)


def _par_switches():
    """Leg (e): one fp32 CFG forward (TF32 off, 4 rows) of DiM-L/2 under
    each JAX switch: the config that `cli.model_config` reads under the
    variable, its switch fields set on the model
    (`blocks.apply_switches`, as `DiM` sets them), held to the default
    route's forward on the same model and inputs, and timed beside it (the
    median wall s of PAR_SWITCH_REPEATS warm forwards each); at 512 px
    DIMSUM_FULL_ATTN=1 takes the full-block kernel (row 4) and =0 SDPA."""
    import torch

    from dimsum_torch.models.blocks import apply_switches
    from dimsum_torch.models.dim import forward_with_cfg
    from dimsum_torch.models.factory import ENV_SWITCHES, build_model

    recs = []
    for size in (256, 512):
        argv = ["--model", "DiM-L/2", "--image-size", str(size),
                *PAR_MODEL_ARGS]
        base = _rest_config(argv, torch.float32)
        net = build_model(base, "cuda", seed=0)
        g = torch.Generator(device="cuda").manual_seed(size)
        lat = size // 8
        x = torch.randn(2, 4, lat, lat, generator=g, device="cuda")
        x = torch.cat([x, x])
        t = torch.rand(2, generator=g, device="cuda").repeat(2)
        y = torch.cat([torch.randint(0, 1000, (2,), generator=g,
                                     device="cuda"),
                       torch.full((2,), 1000, device="cuda")])
        default = {f: getattr(base, f) for f in ENV_SWITCHES.values()}

        def timed():
            """The median wall s of PAR_SWITCH_REPEATS warm forwards."""
            times = []
            for _ in range(PAR_SWITCH_REPEATS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                forward_with_cfg(net, x, t, y, cfg_scale=1.4)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            return sorted(times)[len(times) // 2]

        with torch.inference_mode(), _deterministic():
            want = forward_with_cfg(net, x, t, y, cfg_scale=1.4)
            recs.append({"leg": "e", "switch": "default",
                         "image_size": size, "seconds": timed()})
            for name, value, at in PAR_SWITCHES:
                if at != size:
                    continue
                with _env(**{name: value}):
                    cfg = _rest_config(argv, torch.float32)
                field = ENV_SWITCHES[name]
                fields = {f: getattr(cfg, f) for f in ENV_SWITCHES.values()}
                apply_switches(net, **fields)
                _par_counts(zero=True)
                got = forward_with_cfg(net, x, t, y, cfg_scale=1.4)
                torch.cuda.synchronize()
                launches = _par_counts()
                seconds = timed()
                apply_switches(net, **default)
                recs.append({"leg": "e", "switch": f"{name}={value}",
                             "image_size": size, "field": field,
                             "value": getattr(cfg, field),
                             "rel_err": _rel_err(got, want),
                             "finite": bool(torch.isfinite(got).all()),
                             "launches": launches, "seconds": seconds})
        del net
        torch.cuda.empty_cache()
    return recs


def phase_parallel():
    """parallel: full-width DiM-L/2 at 256 px (hidden 1024, d_inner 2048,
    depth 16, the shared DiT block every 4th) through the parallel CLIs
    as 2 ranks on the one card (gloo, which `init_distributed` takes for
    ranks that share a card: each sum an all_reduce and the hop an
    all_gather through host memory), the bf16 residual stream and the JAX
    switches.  Each leg is held to the port's single-process, unsharded
    run on the same weights, seed and inputs:
    (a) `train --tp 2 --is-moe`: each step's loss rtol 1e-5 and grad_norm
    rtol 1e-4, the first step's gradients leaf by leaf 1e-4 of the leaf's
    scale, the weights leaf by leaf within 2e-6 + 1e-5 |w| where the
    gradients are above noise (`_par_train_errors`; fp32, TF32 off);
    (b) `sample_ddp --tp 2` under the four fused switches (the deferred
    tail at 2) and (c) `sample --pp 2`: 1e-5 of the samples' scale
    (fp32); (d) `bench --bf16-residual`: the bf16 CFG forward 5e-2 of
    scale from the fp32 plain route (the port's bf16 tolerance); (e) each
    switch 1e-5 of scale from the default route (fp32).
    Rows 2 and 3 run in (a), rows 1, 5, 6 and 7 in (b) on the ranks'
    d_inner / 2 = 512 channels a mixer, row 1 in (c), rows 5 and 6 on a
    bf16 residual in (d), row 4 under DIMSUM_FULL_ATTN=1 at 512 px in (e).
    Alone: python3 -c "import chip_smoke as s; s.phase_parallel()"."""
    import os
    import socket
    import tempfile

    import torch
    import torch.multiprocessing as mp

    from dimsum_torch.ops import cuda_build

    phase_t0 = time.perf_counter()
    cuda_build.build()  # here, not in each rank
    torch.cuda.empty_cache()
    ports = []
    for _ in range(3):
        with socket.socket() as s:
            s.bind(("localhost", 0))
            ports.append(s.getsockname()[1])
    with tempfile.TemporaryDirectory() as tmp:
        _write_latent_memmap(tmp, 4 * PAR_TRAIN_BATCH)
        t0 = time.perf_counter()
        ctx = mp.start_processes(_par_rank, args=(PAR_RANKS, ports, tmp),
                                 nprocs=PAR_RANKS, join=False,
                                 start_method="spawn")
        try:
            while not ctx.join(timeout=5):
                if time.perf_counter() - t0 > PAR_DEADLINE:
                    raise TimeoutError(f"parallel: ranks still running "
                                       f"after {PAR_DEADLINE} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
                    p.join(10)
        with open(os.path.join(tmp, "par.json")) as f:
            legs = json.load(f)
    group_seconds = time.perf_counter() - t0
    for rec in legs:
        emit({"phase": "parallel", **rec})
    t0 = time.perf_counter()
    bf16 = _par_bf16_residual()
    for rec in bf16:
        emit({"phase": "parallel", **rec})
    bf16_seconds = time.perf_counter() - t0
    t0 = time.perf_counter()
    switches = _par_switches()
    for rec in switches:
        emit({"phase": "parallel", **rec})
    a, b, c = legs
    rec = {"phase": "parallel", "ranks": PAR_RANKS,
           "group_seconds": group_seconds, "bf16_seconds": bf16_seconds,
           "switches_seconds": time.perf_counter() - t0,
           "seconds": time.perf_counter() - phase_t0}
    emit(rec)
    la, lb, lc = (r["launches_rank0"] for r in legs)
    calls = lb["selective_scan_fwd"] // 32
    ok = (a["loss_rel_err"] <= 1e-5 and a["grad_norm_rel_err"] <= 1e-4
          and a["grad_err"] <= 1e-4 and a["weights_err"] <= 1
          and a["gathered_keys_equal"]
          and all(math.isfinite(v) for v in a["losses"])
          and la["selective_scan_fwd_train"] > 0
          and la["selective_scan_bwd"] == la["selective_scan_fwd_train"]
          and b["rel_err"] <= 1e-5 and b["finite"] and calls > 0
          and lb["selective_scan_fwd"] == 32 * calls
          and all(lb[n] == v * calls
                  for n, v in FUSED_LAUNCHES[2].items())
          and c["rel_err"] <= 1e-5 and c["finite"]
          and lc["selective_scan_fwd"] > 0
          and all(r["forward_rel_err_vs_fp32_plain"] <= 5e-2
                  and r["forward_finite"] and r["sample_finite"]
                  and r["launches"]["add_norm_bf16_residual"] > 0
                  for r in bf16)
          and bf16[1]["launches"]["norm_modulate_bf16_residual"] > 0
          and all(r["rel_err"] <= 1e-5 and r["finite"] for r in switches
                  if r["switch"] != "default"))
    full = [r for r in switches if r["switch"] == "DIMSUM_FULL_ATTN=1"]
    ok = ok and full and full[0]["launches"]["full_attention_f32"] == 36 \
        and [r for r in switches if r["switch"] == "DIMSUM_FULL_ATTN=0"][
            0]["launches"]["full_attention_f32"] == 0
    if not ok:
        raise AssertionError(f"parallel phase failed: {legs} {bf16} "
                             f"{switches}")
    return {"legs": legs, "bf16": bf16, "switches": switches, **rec}


# ---------------------------------------------------------------------------
# variants: the DiM zoo's other configurations at full DiM-L/2 width
# ---------------------------------------------------------------------------

# the JAX CLI flags of each configuration beside --model DiM-L/2
# --image-size 256: (a) the CLI's own defaults for the rest (LayerNorm,
# plain Mamba, a fixed APE, no DiT block, the gated MLP); (b), (c) and (d)
# the published flags, (d) also with the fused-kernel switches (DiMConfig
# fields, VARIANT_SWITCHES)
_PUBLISHED_FLAGS = ["--rms-norm", "--cond-mamba", "--learnable-pe",
                    "--use-attn-every-k-layers", "4"]
VARIANT_FLAGS = {
    "linear-v2": ["--block-type", "linear", "--bimamba-type", "v2"],
    "combined_fourier": ["--block-type", "combined_fourier",
                         "--bimamba-type", "none", *_PUBLISHED_FLAGS],
    "combined_einfft": ["--block-type", "combined_einfft",
                        "--bimamba-type", "none", *_PUBLISHED_FLAGS],
    "published-fused": ["--block-type", "combined", "--bimamba-type",
                        "none", *_PUBLISHED_FLAGS],
}
VARIANT_SWITCHES = {"published-fused": FUSED_ON}
# launches a forward of the scan's forward and reverse entries, and of
# the conv + x_proj kernel (all, anticausal) where it is on: (a) 16 v2
# mixers, each a forward and a reverse branch; (b) 16 spatial and 16 DCT
# mixers; (c) 16 spatial mixers (EinFFT has none); (d) 32 mixers.  In
# (b), (c) and (d) the spatial mixers of the 8 reversed blocks run in
# reverse time (the reverse inside the mixer, as every reversed block
# runs it without a gradient; the DCT mixers' zigzag keeps the flips)
VARIANT_LAUNCHES = {
    "linear-v2": dict(scan_fwd=16, scan_reverse=16),
    "combined_fourier": dict(scan_fwd=24, scan_reverse=8),
    "combined_einfft": dict(scan_fwd=8, scan_reverse=8),
    "published-fused": dict(scan_fwd=24, scan_reverse=8, conv_xproj=32,
                            conv_xproj_reverse=8),
}
VARIANT_STEPS = 10     # Euler grid points of the variants' sampling run
VARIANT_CLI_STEPS = 4  # grid points of the variants' CLI run


def _variant_config(name, dtype):
    """DiM-L/2 at 256 px (1000 classes, label dropout 0.1) built from the
    configuration's CLI flags by `cli.model_config`, with its switches."""
    import argparse
    import dataclasses

    import torch

    from dimsum_torch import cli

    p = argparse.ArgumentParser()
    cli.add_model_args(p)
    cli.add_moe_args(p)
    args = p.parse_args(["--model", "DiM-L/2", "--image-size", "256",
                         "--num-classes", "1000", "--label-dropout", "0.1",
                         *VARIANT_FLAGS[name],
                         *(["--bf16"] if dtype == torch.bfloat16 else [])])
    return dataclasses.replace(cli.model_config(args),
                               **VARIANT_SWITCHES.get(name, {}))


def _variant_counts(zero: bool = False):
    """The launch counts the variants phase reads (set to 0 first with
    `zero`)."""
    from dimsum_torch.ops import full_attention as attention_ops
    from dimsum_torch.ops.conv_xproj import conv_xproj_cuda
    from dimsum_torch.ops.norms import add_norm_cuda, norm_modulate_cuda
    from dimsum_torch.ops.selective_scan import (selective_scan_cuda,
                                                 selective_scan_state_cuda)

    fields = {"scan": (selective_scan_cuda, "launches"),
              "scan_state": (selective_scan_state_cuda, "launches"),
              **{n: (getattr(attention_ops, n), "launches")
                 for n in ATTENTION_KERNELS},
              "scan_reverse": (selective_scan_cuda, "reverse_launches"),
              "conv_xproj": (conv_xproj_cuda, "launches"),
              "conv_xproj_reverse": (conv_xproj_cuda, "reverse_launches"),
              "add_norm": (add_norm_cuda, "launches"),
              "norm_modulate": (norm_modulate_cuda, "launches")}
    if zero:
        for fn, attr in fields.values():
            setattr(fn, attr, 0)
    got = {k: getattr(fn, attr) for k, (fn, attr) in fields.items()}
    got["scan_fwd"] = got.pop("scan") - got["scan_reverse"]
    return got


def _variant_launches_ok(name, launches, calls=1):
    return all(launches[k] == v * calls
               for k, v in VARIANT_LAUNCHES[name].items())


def _sample_run(spec):
    """`python -m dimsum_torch.sample` in a process of its own (its
    `main`), the launch counts of `_variant_counts` set to 0 just before
    and read just after in this process.  `spec` is a JSON [argv, output
    path]; the record's numbers and the launches go to the output path."""
    import torch

    from dimsum_torch import sample

    argv, out = json.loads(spec)
    _variant_counts(zero=True)
    rec = sample.main(argv)
    torch.cuda.synchronize()
    samples = rec["samples"].float()
    with open(out, "w") as f:
        json.dump({"launches": _variant_counts(), "seconds": rec["seconds"],
                   "shape": list(samples.shape),
                   "finite": bool(torch.isfinite(samples).all()),
                   "std": samples.std().item()}, f)


def _variant_sample(name, g, y):
    """The configuration `name` in bf16 at 256 px sampled once (12 images,
    CFG 1.4, GVP velocity, Euler over VARIANT_STEPS grid points) after
    one untimed 2-point run, the noise drawn from `g`: s, img/s, the
    launches of its drift calls, finite."""
    import torch

    from dimsum_torch.models.dim import build_dim, forward_with_cfg
    from dimsum_torch.transport import Sampler, create_transport

    cfg = _variant_config(name, torch.bfloat16)
    net = build_dim(cfg, "cuda", seed=0)
    z = torch.randn((12, 4, 32, 32), generator=g, device="cuda")
    z = torch.cat([z, z])
    sampler = Sampler(create_transport("GVP", "velocity"))

    def model_fn(x_, t_, y=None):
        return forward_with_cfg(net, x_, t_, y, cfg_scale=1.4)

    with torch.inference_mode():
        sampler.sample_ode(sampling_method="euler", num_steps=2)(
            z, model_fn, y=y)
        torch.cuda.synchronize()
        _variant_counts(zero=True)
        t0 = time.perf_counter()
        samples = sampler.sample_ode(sampling_method="euler",
                                     num_steps=VARIANT_STEPS)(
            z, model_fn, y=y)[:12]
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    launches = _variant_counts()
    del net
    torch.cuda.empty_cache()
    rec = {"phase": "variants-sample", "case": name, "dtype": "bfloat16",
           "cfg_scale": 1.4, "images": 12, "steps": VARIANT_STEPS,
           "model_calls": VARIANT_STEPS - 1, "seconds": seconds,
           "img_per_s": 12 / seconds, "launches": launches,
           "finite": bool(torch.isfinite(samples).all()),
           "sample_std": samples.float().std().item()}
    emit(rec)
    if (not rec["finite"]
            or not _variant_launches_ok(name, launches, VARIANT_STEPS - 1)):
        raise AssertionError(f"variants-sample failed: {rec}")
    return rec


def phase_variants():
    """variants: full-width DiM-L/2 at 256 px (hidden 1024, depth 16, L
    256, seeded weights) in four configurations: (a) linear + v2 with the
    CLI's other defaults, (b) combined_fourier and (c) combined_einfft with
    the published flags, (d) the published configuration with
    native_reverse and the fused switches.  For each, one fp32 CFG forward
    of 24 rows (TF32 off) through the kernels and through the plain
    versions (scan, and in (d) the fused sites): 1e-3 of scale, as the
    model phase; the launches of the forward (VARIANT_LAUNCHES).  Then
    (a) and (b) each sampled in bf16 (CFG 1.4, Euler over VARIANT_STEPS
    grid points, 12 images): s and img/s, the launches of its drift
    calls, finite; and
    `python -m dimsum_torch.sample ODE` on (a) in a process of its own
    from a seeded checkpoint under the reference's key names, writing
    latents: finite, VARIANT_CLI_STEPS - 1 drift calls' launches.  Alone:
    python3 -c "import chip_smoke as s; s.phase_variants()"."""
    import os
    import subprocess
    import tempfile

    import torch

    from dimsum_torch.models.dim import build_dim, forward_with_cfg

    phase_t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(7)
    half = torch.randn((12, 4, 32, 32), generator=g, device="cuda")
    x = torch.cat([half, half])
    t = torch.rand(12, generator=g, device="cuda").repeat(2)
    y = torch.cat([torch.randint(0, 1000, (12,), generator=g, device="cuda"),
                   torch.full((12,), 1000, device="cuda")])
    records = {}
    for name in VARIANT_FLAGS:
        cfg = _variant_config(name, torch.float32)
        model = build_dim(cfg, "cuda", seed=0)
        with torch.inference_mode():
            _variant_counts(zero=True)
            got = forward_with_cfg(model, x, t, y, cfg_scale=1.4)
            torch.cuda.synchronize()
            launches = _variant_counts()
            for m in _mixers(model):
                m.scan_impl = "ref"
            _plain_fused(model)
            want = forward_with_cfg(model, x, t, y, cfg_scale=1.4)
            torch.cuda.synchronize()
        del model
        torch.cuda.empty_cache()
        err = (got - want).abs().max().item()
        scale = want.abs().max().item()
        tol = 1e-3 * max(1.0, scale)
        rec = {"phase": "variants", "case": name, "model": "DiM-L/2",
               "flags": VARIANT_FLAGS[name],
               "switches": VARIANT_SWITCHES.get(name, {}),
               "block_type": cfg.block_type, "scan_type": cfg.scan_type,
               "rows": x.shape[0], "dtype": "float32", "tf32": False,
               "launches_per_forward": launches, "max_abs_err": err,
               "max_abs_ref": scale, "tol": tol,
               "finite": bool(torch.isfinite(got).all())}
        emit(rec)
        records[name] = rec
        if (not _variant_launches_ok(name, launches) or not rec["finite"]
                or not err <= tol):
            raise AssertionError(f"variants phase failed: {rec}")

    # (a) and (b) sampled in bf16, the bench protocol cut to VARIANT_STEPS
    # points
    sample_rec = _variant_sample("linear-v2", g, y)
    fourier_rec = _variant_sample("combined_fourier", g, y)
    name = "linear-v2"

    # (a) through the sampling CLI from a reference-layout checkpoint
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        ckpt_cfg = _variant_config(name, torch.float32)
        net = build_dim(ckpt_cfg, "cuda", seed=3, train=True)
        path = os.path.join(tmp, "dim-l2-linear-v2.pt")
        torch.save({"ema": {k: v.detach().cpu()
                            for k, v in net.state_dict().items()}}, path)
        n_keys = len(net.state_dict())
        del net
        torch.cuda.empty_cache()
        out = os.path.join(tmp, "cli.json")
        argv = ["ODE", "--model", "DiM-L/2", "--image-size", "256",
                "--num-classes", "1000", "--label-dropout", "0.1",
                *VARIANT_FLAGS[name], "--path-type", "GVP", "--bf16",
                "--ckpt", path, "--sample-dir", os.path.join(tmp, "out"),
                "--sampling-method", "euler", "--num-sampling-steps",
                str(VARIANT_CLI_STEPS), "--cfg-scale", "1.4",
                "--global-batch-size", "4"]
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-c", "import sys, chip_smoke as s; "
             "s._sample_run(sys.argv[1])", json.dumps([argv, out])],
            cwd=root, capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr)
            raise AssertionError(f"variants: the sampling CLI exited "
                                 f"{proc.returncode}")
        with open(out) as f:
            cli_rec = json.load(f)
        latents = sorted(os.listdir(os.path.join(tmp, "out")))
    cli_out = {"phase": "variants-cli", "case": name, "argv": argv,
               "checkpoint_keys": n_keys, "process_seconds": wall,
               "files": latents, **cli_rec}
    emit(cli_out)
    if (not cli_rec["finite"] or cli_rec["shape"] != [4, 4, 32, 32]
            or not latents
            or not _variant_launches_ok(name, cli_rec["launches"],
                                        VARIANT_CLI_STEPS - 1)):
        raise AssertionError(f"variants-cli failed: {cli_out}")
    routes = phase_reverse_route()
    seconds = time.perf_counter() - phase_t0
    emit({"phase": "variants-seconds", "seconds": seconds})
    return {"forward": records, "sample": sample_rec,
            "sample_fourier": fourier_rec, "cli": cli_out,
            "routes": routes, "seconds": seconds}


# the reversed blocks' routes: (image size, fused switches) of the published
# configuration, the alternation of the routes' windows (True: the reverse
# inside the mixers, False: the block's flips; timed windows, then as many
# profiled ones), forwards a window
REVERSE_ROUTE_CELLS = ((256, {}), (512, {}), (512, FUSED_ON))
REVERSE_ROUTE_ORDER = (True, False, False, True)
REVERSE_ROUTE_PROFILED = (True, False)
REVERSE_ROUTE_ITERS = 5


def _reverse_route_cells(spec):
    """`phase_reverse_route`'s cells, one after the other in this process:
    `spec` is a JSON list of [image size, switches, output path]."""
    import torch

    for cell in json.loads(spec):
        _reverse_route_cell(*cell)
        torch.cuda.empty_cache()


def _reverse_route_cell(image_size, switches, out):
    """One cell of `phase_reverse_route`: the record goes to the output
    path."""
    import dataclasses
    import statistics

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from dimsum_torch.models.dim import build_dim, forward_with_cfg
    from dimsum_torch.ops.selective_scan import selective_scan_cuda

    t0 = time.perf_counter()
    latent = image_size // 8
    cfg = dataclasses.replace(
        _variant_config("published-fused", torch.bfloat16),
        img_resolution=latent,
        **{**{k: False for k in FUSED_ON}, **switches})
    net = build_dim(cfg, "cuda", seed=0)
    reversed_blocks = [m for m in net.modules()
                       if getattr(m, "native", False)]
    g = torch.Generator(device="cuda").manual_seed(11)
    half = torch.randn((12, 4, latent, latent), generator=g, device="cuda")
    x = torch.cat([half, half])
    t = torch.rand(12, generator=g, device="cuda").repeat(2)
    y = torch.cat([torch.randint(0, 1000, (12,), generator=g, device="cuda"),
                   torch.full((12,), 1000, device="cuda")])

    def forward(native):
        for m in reversed_blocks:
            m.native = native
        return forward_with_cfg(net, x, t, y, cfg_scale=1.4)

    walls, device, kernels = ({True: [], False: []} for _ in range(3))
    outs, rev = {}, {}
    with torch.inference_mode():
        for native in (True, False):
            forward(native)
            selective_scan_cuda.reverse_launches = 0
            outs[native] = forward(native).float()
            torch.cuda.synchronize()
            rev[native] = selective_scan_cuda.reverse_launches
        for native in REVERSE_ROUTE_ORDER:
            walls[native].append(cuda_ms(lambda: forward(native),
                                         iters=REVERSE_ROUTE_ITERS,
                                         warmup=1))
        for native in REVERSE_ROUTE_PROFILED:
            forward(native)
            torch.cuda.synchronize()
            # CUDA activity only: the host's op events would make each
            # session's summary take seconds
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(REVERSE_ROUTE_ITERS):
                    forward(native)
                torch.cuda.synchronize()
            found = [e for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA
                     and not getattr(e, "is_user_annotation", False)
                     and not e.key.startswith(("Memcpy", "Memset"))]
            if found:
                device[native].append(sum(
                    e.self_device_time_total for e in found) / 1e3
                    / REVERSE_ROUTE_ITERS)
                kernels[native].append(
                    sum(e.count for e in found) / REVERSE_ROUTE_ITERS)
    err = (outs[True] - outs[False]).abs().max().item()
    scale = outs[False].abs().max().item()
    rec = {"phase": "reverse-route", "image_size": image_size,
           "switches": switches, "dtype": "bfloat16", "rows": 24,
           "reversed_blocks": len(reversed_blocks),
           "order": ["native" if n else "flips"
                     for n in REVERSE_ROUTE_ORDER],
           "profiled_order": ["native" if n else "flips"
                              for n in REVERSE_ROUTE_PROFILED],
           "iters": REVERSE_ROUTE_ITERS}
    for native, route in ((True, "native"), (False, "flips")):
        rec[route] = {
            "wall_ms": statistics.median(walls[native]),
            "wall_ms_windows": walls[native],
            "device_ms": (statistics.median(device[native])
                          if device[native] else None),
            "device_ms_windows": device[native],
            "kernels_per_forward": kernels[native],
            "reverse_launches": rev[native]}
    rec.update(max_abs_diff=err, max_abs_ref=scale,
               bit_for_bit=bool(torch.equal(outs[True], outs[False])),
               tol=1e-2 * max(1.0, scale),
               finite=bool(torch.isfinite(outs[True]).all()),
               seconds=time.perf_counter() - t0)
    with open(out, "w") as f:
        json.dump(rec, f)


def phase_reverse_route():
    """The published DiM-L/2 (bf16, seeded weights) for each of
    REVERSE_ROUTE_CELLS, all in one process of their own (the cells took a
    process each until the smoke had to fit a new phase; their profiler
    sessions may slow the later cells' host work): one CFG forward of 24
    rows with its 8 reversed blocks' reverse inside their mixers
    (`native`, what every forward without a gradient takes) and with the
    block's two flips around the mixer (`flips`, forced by setting the
    blocks' `native` to False; what a forward under a gradient takes).
    Windows of REVERSE_ROUTE_ITERS forwards timed by CUDA events in the
    order REVERSE_ROUTE_ORDER, then profiled ones (torch.profiler's CUDA
    activity: the kernels, memcpy and memset left out) in the order
    REVERSE_ROUTE_PROFILED.  For each route: the median wall ms and
    device ms a forward over its windows, each profiled window's kernel
    launches a forward (the profiler's count; some sessions record
    fewer), the scan's reverse launches by its counter; the two routes'
    outputs compared (the same function: within 1e-2 of scale in bf16,
    and whether bit for bit).  Alone: python3 -c "import chip_smoke as
    s; s.phase_reverse_route()"."""
    import os
    import subprocess
    import tempfile

    root = os.path.dirname(os.path.abspath(__file__))
    records = []
    with tempfile.TemporaryDirectory() as tmp:
        cells = [[image_size, switches, os.path.join(tmp, f"cell{i}.json")]
                 for i, (image_size, switches)
                 in enumerate(REVERSE_ROUTE_CELLS)]
        proc = subprocess.run(
            [sys.executable, "-c", "import sys, chip_smoke as s; "
             "s._reverse_route_cells(sys.argv[1])", json.dumps(cells)],
            cwd=root, capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr)
            raise AssertionError(f"reverse-route: the cells' process "
                                 f"exited {proc.returncode}")
        for image_size, _, out in cells:
            with open(out) as f:
                rec = json.load(f)
            emit(rec)
            records.append(rec)
            if (not rec["finite"] or not rec["max_abs_diff"] <= rec["tol"]
                    or rec["native"]["reverse_launches"] != 8
                    or rec["flips"]["reverse_launches"] != 0
                    or not rec["native"]["device_ms"]
                    or not rec["flips"]["device_ms"]):
                raise AssertionError(f"reverse-route failed: {rec}")
    return records


# the models-rest phase: (a) DiT-XL/2 at 512 px; (b) DiM-L/2 at 256 px,
# the published combined block with MoE, cond_init and cpe, from the JAX
# CLIs' flags; Euler grid points of their bf16 samples; training steps of
# (b) through the training CLI's Trainer
DIT_XL_ARGS = ["--model", "DiT-XL/2", "--image-size", "512",
               "--num-classes", "1001", "--label-dropout", "0.1"]
DIM_REST_ARGS = ["--model", "DiM-L/2", "--image-size", "256",
                 "--num-classes", "1001", "--label-dropout", "0.1",
                 "--block-type", "combined", "--bimamba-type", "none",
                 *_PUBLISHED_FLAGS, "--is-moe", "--cond-init", "--pe-type",
                 "cpe"]
REST_STEPS = 10
REST_TRAIN_STEPS = 3
# (c) DiM-XL/2 at 512 px, the published combined block at hidden 1152
DIM_XL_ARGS = ["--model", "DiM-XL/2", "--image-size", "512",
               "--num-classes", "1001", "--label-dropout", "0.1",
               "--block-type", "combined", "--bimamba-type", "none",
               *_PUBLISHED_FLAGS]
# a forward's launches: (a) 28 DiT blocks' attention at Dh 72, through the
# Hopper redesign of its dtype (none through the first kernel), with
# fused_norm two norm + modulate calls a block and the FinalLayer's; (b) 8
# combined blocks of two CondMamba mixers each (the 8 odd blocks are MoE),
# every scan seeded from h0 through the state entry; (c) 24 combined
# blocks, each two cross-fusion attentions (8 heads of Dh 72), and 6
# calls of the shared DiT block (16 heads of Dh 72, every 4th block): 54
# at Dh 72; with the three fused-kernel switches, add + norm at the 23
# residual tops, norm + modulate at the 24 norm_2 sites, twice in each DiT
# call and once in the FinalLayer, conv + x_proj in the 48 mixers
DIT_XL_ATTENTION, DIT_XL_NORMS = 28, 57
DIM_REST_SCANS = 16
DIM_XL_ATTENTION = 54
DIM_XL_FUSED = {"add_norm": 23, "norm_modulate": 37, "conv_xproj": 48}


def _rest_config(argv, dtype):
    """The model config `cli.model_config` builds from `argv`."""
    import argparse

    import torch

    from dimsum_torch import cli

    p = argparse.ArgumentParser()
    cli.add_model_args(p)
    cli.add_moe_args(p)
    return cli.model_config(p.parse_args(
        [*argv, *(["--bf16"] if dtype == torch.bfloat16 else [])]))


def _rest_forward(name, cfg, x, t, y, seed=0):
    """One fp32 CFG forward of `cfg`'s model through the kernels and
    through the plain routes (attention, norms, scans), the launches of
    the kernel forward: the record."""
    import torch

    from dimsum_torch.models.dim import forward_with_cfg
    from dimsum_torch.models.factory import build_model

    net = build_model(cfg, "cuda", seed=seed)
    with torch.inference_mode():
        _variant_counts(zero=True)
        got = forward_with_cfg(net, x, t, y, cfg_scale=1.4)
        torch.cuda.synchronize()
        launches = _variant_counts()
        for m in net.modules():
            for attr in ("attn_impl", "norm_impl", "scan_impl",
                         "conv_impl"):
                if hasattr(m, attr):
                    setattr(m, attr, "ref")
        want = forward_with_cfg(net, x, t, y, cfg_scale=1.4)
        torch.cuda.synchronize()
    del net
    torch.cuda.empty_cache()
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    return {"phase": "models-rest", "case": name, "rows": x.shape[0],
            "dtype": "float32", "tf32": False, "launches": launches,
            "max_abs_err": err, "max_abs_ref": scale,
            "finite": bool(torch.isfinite(got).all())}


def _rest_train(spec):
    """REST_TRAIN_STEPS bf16 steps of (b) through the training CLI's
    `Trainer` (what `python -m dimsum_torch.train` runs: its argument
    parsing, model, AdamW and EMA state, latent loader and step), in a
    process of its own, stopped before the epoch's end: the content
    checkpoint an epoch writes would be the 18 GB of this model's state.
    The launch counts set to 0 just before the steps and read just after.
    `spec` is a JSON [argv, output path]."""
    import torch

    from dimsum_torch import train as train_cli
    from dimsum_torch.data import device_batches
    from dimsum_torch.ops import selective_scan as ss

    argv, out = json.loads(spec)
    trainer = train_cli.Trainer(train_cli.parse_args(argv))
    try:
        counts = _zeroed_scan_counts()
        for c in (ss.selective_scan_fwd_train_cuda,
                  ss.selective_scan_bwd_core_cuda):
            c.h0_launches = 0
        ss.selective_scan_state_cuda.launches = 0
        losses, seconds = [], []
        trainer.loader.set_epoch(0)
        for x, y in device_batches(trainer.loader, trainer.device):
            if len(losses) == REST_TRAIN_STEPS:
                break
            t0 = time.perf_counter()
            metrics = trainer.train_step(trainer.state, x, y,
                                         trainer.generator)
            losses.append(metrics["loss"].item())
            seconds.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        rec = {"launches": {k: c.launches for k, c in counts.items()},
               "h0_launches": {
                   "selective_scan_fwd_train":
                       ss.selective_scan_fwd_train_cuda.h0_launches,
                   "selective_scan_bwd":
                       ss.selective_scan_bwd_core_cuda.h0_launches},
               "state_launches": ss.selective_scan_state_cuda.launches,
               "losses": losses, "step_seconds": seconds,
               "params": sum(p.numel() for p in
                             trainer.state.model.parameters()),
               "max_memory_allocated_GB":
                   torch.cuda.max_memory_allocated() / 1e9}
    finally:
        trainer.close()
    with open(out, "w") as f:
        json.dump(rec, f)


def phase_models_rest():
    """models-rest: the rest of the model zoo on the card, built from the
    JAX CLIs' flags by `cli.model_config` with seeded random weights.
    (a) DiT-XL/2 at 512 px (28 blocks, hidden 1152, 16 heads of Dh 72, L
    1024): one fp32 CFG forward of 8 rows (TF32 off) through the kernels
    and through the plain routes, without and with `fused_norm` (28
    launches of the fp32 attention kernel, none of the first one, and 57
    of norm + modulate);
    then `python -m dimsum_torch.sample ODE --model DiT-XL/2 --image-size
    512 --bf16` in a process of its own (8 images, Euler over REST_STEPS
    grid points, CFG 1.4; 28 launches a drift call of the sm90 attention
    kernel, none of the first one).  (b) DiM-L/2 at 256 px, the published
    combined
    block with --is-moe --cond-init --pe-type cpe: one fp32 CFG forward of
    24 rows against the plain routes (16 launches of the scan's state
    entry with h0, none of kernel 1); a bf16 sample of 12 images (Euler
    over REST_STEPS points); REST_TRAIN_STEPS bf16 steps through the
    training CLI's Trainer (16 launches a step of each h0 training
    kernel); and one fp32 training step of the same model at depth 2
    through the kernels and the plain routes: the loss and every
    gradient, cond_proj's (dh0's path) among them.  (c) DiM-XL/2 at 512
    px (24 published combined blocks at hidden 1152, full depth): one fp32
    CFG forward of 8 rows through the kernels and the plain routes,
    without and with the fused-kernel switches (`fused_norm`,
    `pallas_norm`, `conv_xproj`: 23 add + norm, 37 norm + modulate and 48
    conv + x_proj launches); 54 launches of the fp32 attention kernel at
    Dh 72, none of the first one.
    Alone: python3 -c "import chip_smoke as s; s.phase_models_rest()"."""
    import dataclasses
    import os
    import subprocess
    import tempfile

    import torch

    from dimsum_torch.models.dim import build_dim, forward_with_cfg
    from dimsum_torch.ops import selective_scan as ss
    from dimsum_torch.transport import Sampler, create_transport

    phase_t0 = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}

    def check(ok, rec):
        emit(rec)
        if not ok:
            raise AssertionError(f"models-rest failed: {rec}")
        return rec

    def cfg_batch(n, latent, seed):
        g = torch.Generator(device="cuda").manual_seed(seed)
        half = torch.randn((n, 4, latent, latent), generator=g,
                           device="cuda")
        t = torch.rand(n, generator=g, device="cuda").repeat(2)
        y = torch.cat([torch.randint(0, 1000, (n,), generator=g,
                                     device="cuda"),
                       torch.full((n,), 1000, device="cuda")])
        return torch.cat([half, half]), t, y, g

    def run(cmd, what, timeout=600):
        proc = subprocess.run([sys.executable, *cmd], cwd=root,
                              capture_output=True, text=True,
                              timeout=timeout)
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr)
            raise AssertionError(f"models-rest: the {what} exited "
                                 f"{proc.returncode}")

    # (a) DiT-XL/2 at 512 px, fp32, plain and fused; 1e-4 of the output's
    # scale
    dit = _rest_config(DIT_XL_ARGS, torch.float32)
    x, t, y, _ = cfg_batch(4, 64, 13)
    for fused in (False, True):
        rec = _rest_forward("DiT-XL/2-512" + ("-fused" if fused else ""),
                            dataclasses.replace(dit, fused_norm=fused),
                            x, t, y)
        rec["tol"] = 1e-4 * max(1.0, rec["max_abs_ref"])
        launches = rec["launches"]
        out[rec["case"]] = check(
            rec["finite"] and rec["max_abs_err"] <= rec["tol"]
            and launches["full_attention_f32"] == DIT_XL_ATTENTION
            and launches["full_attention_first"] == 0
            and launches["norm_modulate"] == (DIT_XL_NORMS if fused else 0),
            rec)
    with tempfile.TemporaryDirectory() as tmp:
        res = os.path.join(tmp, "dit.json")
        argv = ["ODE", *DIT_XL_ARGS, "--path-type", "GVP", "--bf16",
                "--sample-dir",
                os.path.join(tmp, "dit"), "--sampling-method", "euler",
                "--num-sampling-steps", str(REST_STEPS), "--cfg-scale",
                "1.4", "--global-batch-size", "8"]
        t0 = time.perf_counter()
        run(["-c", "import sys, chip_smoke as s; s._sample_run(sys.argv[1])",
             json.dumps([argv, res])], "DiT-XL/2 sampling CLI")
        wall = time.perf_counter() - t0
        with open(res) as f:
            cli_rec = json.load(f)
    calls = REST_STEPS - 1
    rec = {"phase": "models-rest", "case": "DiT-XL/2-512-sample-cli",
           "argv": argv, "process_seconds": wall, "model_calls": calls,
           "img_per_s": 8 / cli_rec["seconds"], **cli_rec}
    out[rec["case"]] = check(
        cli_rec["finite"] and cli_rec["shape"] == [8, 4, 64, 64]
        and cli_rec["launches"]["full_attention_sm90"]
        == DIT_XL_ATTENTION * calls
        and cli_rec["launches"]["full_attention_first"] == 0, rec)

    # (c) DiM-XL/2 at 512 px, fp32, plain and with the three fused-kernel
    # switches; 1e-4 of the output's scale, as (a)
    dim_xl = _rest_config(DIM_XL_ARGS, torch.float32)
    x, t, y, _ = cfg_batch(4, 64, 23)
    for fused in (False, True):
        rec = _rest_forward("DiM-XL/2-512" + ("-fused" if fused else ""),
                            dataclasses.replace(
                                dim_xl, **(FUSED_ON if fused else {})),
                            x, t, y)
        rec["tol"] = 1e-4 * max(1.0, rec["max_abs_ref"])
        launches = rec["launches"]
        out[rec["case"]] = check(
            rec["finite"] and rec["max_abs_err"] <= rec["tol"]
            and launches["full_attention_f32"] == DIM_XL_ATTENTION
            and launches["full_attention_first"] == 0
            and all(launches[k] == (v if fused else 0)
                    for k, v in DIM_XL_FUSED.items()), rec)

    # (b) the MoE / cond_init / cpe DiM-L/2: fp32 forward, 1e-3 of scale
    # as the model phase (16 blocks of random weights)
    dim = _rest_config(DIM_REST_ARGS, torch.float32)
    x, t, y, g = cfg_batch(12, 32, 17)
    rec = _rest_forward("DiM-L/2-moe-cond_init-cpe", dim, x, t, y)
    rec["tol"] = 1e-3 * max(1.0, rec["max_abs_ref"])
    launches = rec["launches"]
    out[rec["case"]] = check(
        rec["finite"] and rec["max_abs_err"] <= rec["tol"]
        and launches["scan_state"] == DIM_REST_SCANS
        and launches["scan_fwd"] == launches["scan_reverse"] == 0, rec)

    net = build_dim(_rest_config(DIM_REST_ARGS, torch.bfloat16), "cuda",
                    seed=0)
    z = torch.randn((12, 4, 32, 32), generator=g, device="cuda")
    z = torch.cat([z, z])
    sampler = Sampler(create_transport("GVP", "velocity"))

    def model_fn(x_, t_, y=None):
        return forward_with_cfg(net, x_, t_, y, cfg_scale=1.4)

    with torch.inference_mode():
        sampler.sample_ode(sampling_method="euler", num_steps=2)(
            z, model_fn, y=y)
        torch.cuda.synchronize()
        _variant_counts(zero=True)
        t0 = time.perf_counter()
        samples = sampler.sample_ode(sampling_method="euler",
                                     num_steps=REST_STEPS)(
            z, model_fn, y=y)[:12]
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    launches = _variant_counts()
    del net
    torch.cuda.empty_cache()
    rec = {"phase": "models-rest", "case": "DiM-L/2-moe-sample",
           "dtype": "bfloat16", "images": 12, "steps": REST_STEPS,
           "model_calls": calls, "seconds": seconds,
           "img_per_s": 12 / seconds, "launches": launches,
           "finite": bool(torch.isfinite(samples).all()),
           "sample_std": samples.float().std().item()}
    out[rec["case"]] = check(
        rec["finite"] and launches["scan_state"] == DIM_REST_SCANS * calls
        and launches["scan_fwd"] == 0, rec)

    with tempfile.TemporaryDirectory() as tmp:
        _write_latent_memmap(tmp, 16 * REST_TRAIN_STEPS)
        res = os.path.join(tmp, "train.json")
        argv = ["--exp", "rest", "--datadir", tmp, "--results-dir",
                os.path.join(tmp, "results"), "--dataset", "latent_memmap",
                *DIM_REST_ARGS, "--path-type", "GVP", "--bf16",
                "--global-batch-size", "16",
                "--lr", "1e-4", "--drop-path", "0.1", "--max-grad-norm",
                "1", "--epochs", "0"]
        t0 = time.perf_counter()
        run(["-c", "import sys, chip_smoke as s; s._rest_train(sys.argv[1])",
             json.dumps([argv, res])], "training CLI's Trainer")
        wall = time.perf_counter() - t0
        with open(res) as f:
            train_rec = json.load(f)
    n = REST_TRAIN_STEPS
    rec = {"phase": "models-rest", "case": "DiM-L/2-moe-train",
           "argv": argv, "process_seconds": wall, "steps": n,
           "batch": 16, **train_rec}
    out[rec["case"]] = check(
        len(train_rec["losses"]) == n
        and all(math.isfinite(v) for v in train_rec["losses"])
        and train_rec["h0_launches"]["selective_scan_fwd_train"]
        == DIM_REST_SCANS * n
        and train_rec["h0_launches"]["selective_scan_bwd"]
        == DIM_REST_SCANS * n
        and train_rec["launches"]["selective_scan_fwd"] == 0
        and train_rec["state_launches"] == 0, rec)

    # one fp32 step at depth 2 (block 0 combined: 2 seeded mixers; block 1
    # MoE) through the kernels and the plain routes; tolerances as
    # train-grad
    model = build_dim(dataclasses.replace(dim, depth=2), "cuda", seed=0,
                      train=True)
    transport = create_transport("GVP", "velocity")
    g = torch.Generator(device="cuda").manual_seed(19)
    xs = torch.randn((2, 4, 32, 32), generator=g, device="cuda")
    ys = torch.randint(0, 1000, (2,), generator=g, device="cuda")

    def loss_and_grads():
        gen = torch.Generator(device="cuda").manual_seed(4)
        model.zero_grad(set_to_none=True)
        loss = transport.training_losses(
            lambda xt, t_, **kw: model(xt, t_, train=True, generator=gen,
                                       **kw), xs, gen, {"y": ys}
        )["loss"].mean()
        loss.backward()
        torch.cuda.synchronize()
        return loss.item(), {n: p.grad.clone() for n, p in
                             model.named_parameters() if p.grad is not None}

    for c in (ss.selective_scan_fwd_train_cuda,
              ss.selective_scan_bwd_core_cuda):
        c.h0_launches = 0
    loss, grads = loss_and_grads()
    h0_launches = [ss.selective_scan_fwd_train_cuda.h0_launches,
                   ss.selective_scan_bwd_core_cuda.h0_launches]
    for m in _mixers(model):
        m.scan_impl = "ref"
    want_loss, want = loss_and_grads()
    del model
    torch.cuda.empty_cache()
    errs = {k: _scaled_err(grads[k], want[k]) for k in want}
    worst = max(errs, key=errs.get)
    cond = [k for k in want if k.endswith("cond_proj.weight")]
    rec = {"phase": "models-rest", "case": "DiM-moe-depth2-train-grad",
           "dtype": "float32", "batch": 2, "loss": loss,
           "loss_plain": want_loss,
           "loss_rel_err": abs(loss - want_loss) / abs(want_loss),
           "n_grads": len(want), "same_grad_set": set(grads) == set(want),
           "worst_grad": worst, "worst_grad_scaled_err": errs[worst],
           "cond_proj_scaled_err": {k: errs[k] for k in cond},
           "tol": 2e-3, "h0_launches": h0_launches}
    out[rec["case"]] = check(
        h0_launches == [2, 2] and rec["same_grad_set"] and len(cond) == 2
        and all(want[k].abs().max() > 0 for k in cond)
        and rec["loss_rel_err"] <= 1e-4 and errs[worst] <= 2e-3, rec)
    out["seconds"] = time.perf_counter() - phase_t0
    emit({"phase": "models-rest-seconds", "seconds": out["seconds"]})
    return out


# rows 1-3 above dt_rank 64 (the kernels' RMAX 128 and 256 templates):
# (case, (batch, L, dim, N, r), dtype).  The LM's scoring and gradient shape
# (mamba-2.8b: d_inner 5120, r 160, one 2048-token sequence); DiM-XL/2
# --block-type linear's mixers (d_inner 2304, r 72: 24 CFG rows of 256
# tokens to sample, 8 rows to train), forward and reversed (its v2 branch);
# mamba-790m's (r 96) and mamba-1.4b's (r 128) ranks; the cap, r 256
# (d_model 4096), in both dtypes and through the training kernels' h0
# entries.  Plain times for DiM-XL/2's cases (the LM shape's plain
# training pair takes seconds a call; PERF.md keeps PR 21's).
RANK_SCAN_CASES = (
    ("lm-r160-bf16", (1, 2048, 5120, 16, 160), "bfloat16", False),
    ("lm-r160-fp32", (1, 2048, 5120, 16, 160), "float32", False),
    ("xl-linear-r72-bf16", (24, 256, 2304, 16, 72), "bfloat16", False),
    ("xl-linear-r72-bf16-reverse", (24, 256, 2304, 16, 72), "bfloat16",
     True),
    ("xl-linear-r72-fp32", (24, 256, 2304, 16, 72), "float32", False),
    ("r96-bf16", (1, 2048, 3072, 16, 96), "bfloat16", False),
    ("r128-bf16", (1, 2048, 4096, 16, 128), "bfloat16", False),
    ("r256-bf16", (1, 2048, 8192, 16, 256), "bfloat16", False),
    ("r256-fp32", (1, 2048, 8192, 16, 256), "float32", True),
)
RANK_TRAIN_CASES = (
    ("lm-r160-bf16", (1, 2048, 5120, 16, 160), "bfloat16", False),
    ("lm-r160-fp32", (1, 2048, 5120, 16, 160), "float32", False),
    ("xl-linear-r72-bf16", (8, 256, 2304, 16, 72), "bfloat16", False),
    ("r96-bf16", (1, 2048, 3072, 16, 96), "bfloat16", False),
    ("r128-bf16", (1, 2048, 4096, 16, 128), "bfloat16", False),
    ("r256-bf16", (1, 2048, 8192, 16, 256), "bfloat16", False),
    ("r256-fp32-h0", (1, 2048, 8192, 16, 256), "float32", True),
)


def phase_kernel_rank():
    """kernel-rank: kernels 1-3 at the ranks above 64 (RANK_SCAN_CASES,
    RANK_TRAIN_CASES) against their plain versions, each kernel's device
    ms beside its bound computed from the case's inputs; then a rank past
    the cap (257) must raise NotImplementedError in all three wrappers."""
    import torch

    from dimsum_torch.ops import selective_scan as ss

    timed_plain = ("xl-",)
    scans = {name: _scan_case("kernel-rank", name, shape,
                              getattr(torch, dtype), reverse, 400 + i, True,
                              name.startswith(timed_plain))
             for i, (name, shape, dtype, reverse)
             in enumerate(RANK_SCAN_CASES)}
    trains = {name: _train_case("kernel-rank-train", name, shape,
                                getattr(torch, dtype), False, seeded, 60 + i,
                                True, name.startswith(timed_plain))
              for i, (name, shape, dtype, seeded)
              in enumerate(RANK_TRAIN_CASES)}
    x = scan_inputs(1, 64, 256, 16, 257, torch.bfloat16, seed=9)
    args = [x[k] for k in ("u", "dt_low", "dt_w", "A", "B", "C")]
    refused = []
    with torch.no_grad():
        for fn in (lambda: ss.selective_scan_cuda(*args),
                   lambda: ss.selective_scan_fwd_train_cuda(*args),
                   lambda: ss.selective_scan_bwd_core_cuda(
                       *args, None, True, torch.zeros(1, 64, 256,
                                                      device="cuda"),
                       torch.zeros(1, 4, 16, 256, device="cuda"))):
            try:
                fn()
            except NotImplementedError as e:
                refused.append(str(e))
    rec = {"phase": "kernel-rank-cap", "rank": 257, "refused": refused}
    emit(rec)
    if len(refused) != 3:
        raise AssertionError(f"a rank past the cap was not refused: {rec}")
    return {"scan": scans, "train": trains}


# kernel-cases: the cases the Pallas scan kernels take beyond the zoo's.
# Kernel 1 at the sampling mixer shape (24 x 256 x 1024, r 32): N past 32
# and grouped B/C (name, N, G, dtype, reverse); the state entry, grouped at
# that shape and at N 256 with h0 and the last state at the SP shape (8 x
# 256 x 1024) (name, shape, G, dtype, h0 and last); kernels 2 and 3 at the
# training mixer shape (16 x 256 x 1024) on a full delta and at N past 32
# (name, N, dtype, full delta).
CASE_SCANS = (
    ("n64-bf16", 64, None, "bfloat16", False),
    ("n64-bf16-reverse", 64, None, "bfloat16", True),
    ("n64-fp32", 64, None, "float32", False),
    ("n256-bf16", 256, None, "bfloat16", False),
    ("n256-fp32", 256, None, "float32", False),
    ("g2-bf16", 16, 2, "bfloat16", False),
)
CASE_STATES = (
    ("g2-bf16", (24, 256, 1024, 16), 2, "bfloat16", False),
    ("g4-bf16", (24, 256, 1024, 16), 4, "bfloat16", False),
    ("g4-fp32", (24, 256, 1024, 16), 4, "float32", False),
    ("g2-n64-bf16", (24, 256, 1024, 64), 2, "bfloat16", False),
    ("n256-h0-last-bf16", (8, 256, 1024, 256), None, "bfloat16", True),
)
CASE_TRAINS = (
    ("delta-bf16", 16, "bfloat16", True),
    ("delta-fp32", 16, "float32", True),
    ("n64-bf16", 64, "bfloat16", False),
    ("n256-fp32", 256, "float32", False),
)
# the JAX op API on the card: (name, N, G, dtype, needs a gradient, op):
# `selective_scan` on a full delta through autograd, grouped (the state
# entry, the backward through the plain scan) and not (kernels 2 and 3's
# delta entries); `selective_scan_dtlow` at N 64 without a gradient
# (kernel 1's split entry)
CASE_FRONT = (
    ("grouped-g2-fp32", 16, 2, "float32", True, "selective_scan"),
    ("delta-bf16", 16, None, "bfloat16", True, "selective_scan"),
    ("dtlow-n64-bf16", 64, None, "bfloat16", False, "selective_scan_dtlow"),
)


def _grouped(x, groups, seed):
    """x with B and C replaced by grouped ones, (batch, L, G, N) ~ N(0, 1)
    in B's dtype."""
    import torch

    if groups is None:
        return x
    batch, L, n = x["B"].shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    for k in ("B", "C"):
        x[k] = torch.randn((batch, L, groups, n), generator=g,
                           device="cuda").to(x["u"].dtype)
    return x


def _state_case(name, shape, groups, dtype, seeded, seed):
    """The state entry on `state_inputs(*shape)` (grouped B/C with
    `groups`; with `seeded` h0 in and the last state out) against the
    plain scan: the errors against the stated tolerances, kernel, device
    and plain times, and the bound."""
    import torch

    from dimsum_torch.ops.selective_scan import (selective_scan_ref,
                                                 selective_scan_state_cuda)

    x, h0 = state_inputs(*shape, dtype, seed=seed)
    x = _grouped(x, groups, seed + 7)
    args = [x[k] for k in ("u", "delta", "A", "B", "C", "D")]
    kw = dict(z=x["z"], delta_bias=x["delta_bias"], delta_softplus=True)
    if seeded:
        kw.update(h0=h0, return_last_state=True)
    with torch.inference_mode():
        got = selective_scan_state_cuda(*args, **kw)
        want = selective_scan_ref(*args, **kw)
        got, want = ((got, want) if seeded else ((got,), (want,)))
        torch.cuda.synchronize()
        # the output as phase kernel's, relative to its largest value; the
        # fp32 last state to 1e-4 of its scale in both dtypes
        tols = [1e-4 if dtype == torch.float32 else 1.6e-2, 1e-4]
        errs = [_scaled_err(a, b) for a, b in zip(got, want)]
        ok = all(bool(torch.isfinite(a.float()).all()) and e <= t
                 for a, e, t in zip(got, errs, tols))
        run = lambda: selective_scan_state_cuda(*args, **kw)  # noqa: E731
        ms = cuda_ms(run, iters=20)
        dev_ms = device_ms(run, "selective_scan", kernels=1 + (shape[3] > 32))
        plain_ms = cuda_ms(lambda: selective_scan_ref(*args, **kw), iters=2,
                           warmup=1)
    rec = {"phase": "kernel-cases-state", "case": name, "shape": list(shape),
           "groups": groups, "dtype": str(dtype).split(".")[-1],
           "h0_and_last": seeded,
           "max_abs_err": max((a.float() - b.float()).abs().max().item()
                              for a, b in zip(got, want)),
           "scaled_err": errs, "tol": tols[:len(errs)], "ok": ok, "ms": ms,
           "device_ms": dev_ms, "plain_ms": plain_ms,
           **_bound_fields(state_bound(x, seeded, seeded))}
    emit(rec)
    if not ok:
        raise AssertionError(f"state entry disagrees on {name}: {rec}")
    return rec


def _front_case(name, n, groups, dtype, grad, op, seed):
    """The JAX op `op` (`selective_scan` on a full delta, or
    `selective_scan_dtlow`) at the training mixer shape 16 x 256 x 1024 on
    the card against its plain route (impl="ref"), forward and, with
    `grad`, backward through autograd: y and every input's gradient, each
    relative to its largest value."""
    import torch

    from dimsum_torch.ops import selective_scan as ss

    if op == "selective_scan":
        x, _ = state_inputs(16, 256, 1024, n, dtype, seed=seed)
        keys = ("u", "delta", "A", "B", "C", "D", "z", "delta_bias")
    else:
        x = scan_inputs(16, 256, 1024, n, 32, dtype, seed=seed)
        keys = ("u", "dt_low", "dt_w", "A", "B", "C", "D", "z",
                "delta_bias")
    x = _grouped(x, groups, seed + 7)
    w = torch.randn(x["u"].shape, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(seed + 1))

    def run(impl):
        leaves = {k: x[k].clone().requires_grad_(grad) for k in keys}
        with torch.set_grad_enabled(grad):
            y = getattr(ss, op)(*(leaves[k] for k in keys),
                                delta_softplus=True, impl=impl)
            if grad:
                (y.float() * w).sum().backward()
        return {"y": y.detach(), **{f"d{k}": leaves[k].grad for k in keys
                                    if grad}}

    got = run("cuda")
    torch.cuda.synchronize()
    want = run("ref")
    # relative to each tensor's largest value: fp32 1e-4; bf16 outputs and
    # gradients 1.6e-2 (one bf16 rounding step)
    tol = 1e-4 if dtype == torch.float32 else 1.6e-2
    errs = {k: _scaled_err(got[k], want[k]) for k in got}
    ok = all(bool(torch.isfinite(got[k].float()).all()) and errs[k] <= tol
             for k in got)
    rec = {"phase": "kernel-cases-front", "case": name, "op": op,
           "shape": [16, 256, 1024, n], "groups": groups,
           "dtype": str(dtype).split(".")[-1], "grad": grad,
           "scaled_err": errs, "tol": tol, "ok": ok}
    emit(rec)
    if not ok:
        raise AssertionError(f"selective_scan disagrees on {name}: {rec}")
    return rec


def phase_kernel_cases():
    """kernel-cases: the scan kernels' cases beyond the zoo's (CASE_SCANS,
    CASE_STATES, CASE_TRAINS) against their plain versions, each kernel's
    device ms beside its bound from the case's inputs; then the front end
    (CASE_FRONT) through autograd with the launch counts set to 0 just
    before and read just after; N 257 and a G that does not divide dim
    must raise."""
    import torch

    from dimsum_torch.ops import selective_scan as ss

    t0 = time.perf_counter()
    scans = {}
    for i, (name, n, groups, dtype, reverse) in enumerate(CASE_SCANS):
        scans[name] = _scan_case(
            "kernel-cases", name, (24, 256, 1024, n, 32),
            getattr(torch, dtype), reverse, 800 + i, True,
            inputs=lambda x, g=groups, i=i: _grouped(x, g, 850 + i))
        scans[name]["groups"] = groups
    states = {name: _state_case(name, shape, groups, getattr(torch, dtype),
                                seeded, 900 + 2 * i)
              for i, (name, shape, groups, dtype, seeded)
              in enumerate(CASE_STATES)}
    trains = {name: _train_case("kernel-cases-train", name,
                                (16, 256, 1024, n, 32), getattr(torch, dtype),
                                False, False, 90 + i, True,
                                full_delta=full)
              for i, (name, n, dtype, full) in enumerate(CASE_TRAINS)}
    counts = {"selective_scan_fwd": ss.selective_scan_cuda,
              "selective_scan_fwd_state": ss.selective_scan_state_cuda,
              "selective_scan_fwd_train": ss.selective_scan_fwd_train_cuda,
              "selective_scan_bwd": ss.selective_scan_bwd_core_cuda}
    keys = ("launches", "split_launches", "grouped_launches",
            "delta_launches")
    for fn in counts.values():
        for k in keys:
            if hasattr(fn, k):
                setattr(fn, k, 0)
    front = {name: _front_case(name, n, groups, getattr(torch, dtype), grad,
                               op, 950 + 3 * i)
             for i, (name, n, groups, dtype, grad, op)
             in enumerate(CASE_FRONT)}
    launches = {name: {k: getattr(fn, k) for k in keys if hasattr(fn, k)}
                for name, fn in counts.items()}
    # the op API's run: the grouped forward on the state entry, the delta
    # pair once each, kernel 1's split entry once
    expect = {"selective_scan_fwd_state": 1, "selective_scan_fwd_train": 1,
              "selective_scan_bwd": 1, "selective_scan_fwd": 1}
    refused = []
    x = scan_inputs(1, 32, 64, 257, 8, torch.float32, seed=9)
    args = [x[k] for k in ("u", "dt_low", "dt_w", "A", "B", "C")]
    bad_g = _grouped(scan_inputs(1, 32, 64, 16, 8, torch.float32, seed=9),
                     3, 9)
    with torch.no_grad():
        for exc, fn in (
                (NotImplementedError, lambda: ss.selective_scan_cuda(*args)),
                (NotImplementedError,
                 lambda: ss.selective_scan_fwd_train_cuda(*args)),
                (ValueError, lambda: ss.selective_scan_cuda(
                    *[bad_g[k] for k in ("u", "dt_low", "dt_w", "A", "B",
                                         "C")]))):
            try:
                fn()
            except exc as e:
                refused.append(str(e))
    rec = {"phase": "kernel-cases-launches", "launches": launches,
           "expected": expect, "refused": refused,
           "seconds": time.perf_counter() - t0}
    emit(rec)
    if any(launches[k]["launches"] != v for k, v in expect.items()):
        raise AssertionError(f"the front end's run missed a kernel: {rec}")
    if len(refused) != 3:
        raise AssertionError(f"N 257 or G 3 of dim 64 was not refused: "
                             f"{rec}")
    return {"scan": scans, "state": states, "train": trains, "front": front,
            "launches": launches, "seconds": rec["seconds"]}


def _add_case_fields(by_name, cases):
    """Rows 1, 2, 3 and 8 of the kernels line (`by_name`) with the cases
    beyond the zoo from `phase_kernel_cases` (`cases`): N past 32
    (`state_cases`), grouped B/C (`grouped_cases`) and a full delta
    (`delta_cases`; every case of the state entry is one), each with its
    numbers, and each kernel's launches in the op API's run
    (`cases_launches`); kernels 2 and 3 take no groups (the grouped route's
    backward is the plain scan's), kernel 1 no full delta (the state
    entry's).  The rows' max_abs_err takes the cases' in."""
    def case_list(recs, sub=None):
        return [{"case": r["case"], "shape": r["shape"], "dtype": r["dtype"],
                 **{k: r.get(k) for k in ("reverse", "groups", "full_delta",
                                          "h0_and_last")},
                 **{k: (r if sub is None else r[sub])[k] for k in (
                     "max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
                     "bound_by", "bound_ops")}}
                for r in recs]

    scans, states = cases["scan"].values(), cases["state"].values()
    rows = {
        "selective_scan_fwd": (
            case_list(r for r in scans if not r["groups"]),
            case_list(r for r in scans if r["groups"]), []),
        "selective_scan_fwd_state": (
            case_list(r for r in states if not r["groups"]),
            case_list(r for r in states if r["groups"]),
            case_list(states))}
    for name, key in (("selective_scan_fwd_train", "fwd_train"),
                      ("selective_scan_bwd", "bwd")):
        trains = cases["train"].values()
        rows[name] = (
            case_list((r for r in trains if not r["full_delta"]), key), [],
            case_list((r for r in trains if r["full_delta"]), key))
    for name, (more, grouped, delta) in rows.items():
        rec = by_name[name]
        rec.update(state_cases=more, grouped_cases=grouped,
                   delta_cases=delta,
                   cases_launches=cases["launches"][name])
        rec["max_abs_err"] = max([rec["max_abs_err"]] + [
            c["max_abs_err"] for c in more + grouped + delta])


LM_MODEL = "mamba-2.8b"
LM_SCORE_LEN = 2048          # one sequence of the scorer's largest bucket
LM_GEN_BATCH, LM_GEN_PROMPT, LM_GEN_NEW = 8, 64, 128
LM_PLAIN_LAYERS = 2          # the plain-route check's depth (full width)


def _lm_tokens(shape, vocab, seed):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randint(0, vocab, shape, generator=g, device="cuda")


def _lm_score(model, ids):
    """`MambaScorer.loglikelihood` of ids (1, L) as one prefix token and
    the rest: (log-likelihood, greedy flag, seconds, kernel-1 launches),
    the launches set to 0 just before and read just after."""
    import torch

    from dimsum_torch.eval.lm_harness import MambaScorer
    from dimsum_torch.ops.selective_scan import selective_scan_cuda

    scorer = MambaScorer(model, max_length=LM_SCORE_LEN)
    tokens = ids[0].tolist()
    scorer.loglikelihood(tokens[:1], tokens[1:64])  # untimed warm-up
    torch.cuda.synchronize()
    selective_scan_cuda.launches = 0
    t0 = time.perf_counter()
    ll, greedy = scorer.loglikelihood(tokens[:1], tokens[1:])
    torch.cuda.synchronize()
    return ll, greedy, time.perf_counter() - t0, selective_scan_cuda.launches


def phase_lm():
    """lm: the Mamba language model at mamba-2.8b's published width and
    depth (d_model 2560, 64 layers, vocab 50277 padded to 50280, d_inner
    5120, dt_rank 160), seeded random weights built on the card.  First
    kernel-rank (the scan kernels at r > 64).  Then at LM_PLAIN_LAYERS
    layers of full width in fp32 (TF32 off): the logits of a seeded
    LM_SCORE_LEN-token sequence through the scan kernel and through the
    plain scan (1e-3 of scale).  The full model in fp32 (11 GB of
    weights): `MambaScorer.loglikelihood` of the sequence, 64 kernel-1
    launches, finite; `generate` at batch LM_GEN_BATCH, a LM_GEN_PROMPT-
    token prompt and LM_GEN_NEW new tokens, greedy (the prompt fed token by
    token, then the plain one-token step): its first new token equal to
    the argmax of the forward's last logits, tokens/s.  The full model in
    bf16: the same scoring, 64 launches, finite.  Alone: python3 -c
    "import chip_smoke as s; s.phase_lm()"."""
    import dataclasses

    import torch

    from dimsum_torch.models.lm import (MAMBA_LM_CONFIGS, MambaLMConfig,
                                        build_lm, generate)
    from dimsum_torch.ops.selective_scan import selective_scan_cuda

    phase_t0 = time.perf_counter()
    ranks = phase_kernel_rank()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = MambaLMConfig(**MAMBA_LM_CONFIGS[LM_MODEL])
    ids = _lm_tokens((1, LM_SCORE_LEN), cfg.vocab_size, seed=21)
    out = {"ranks": ranks}

    def check(ok, rec):
        emit(rec)
        if not ok:
            raise AssertionError(f"lm failed: {rec}")
        return rec

    # full width, LM_PLAIN_LAYERS layers: the kernel against the plain scan
    short = build_lm(dataclasses.replace(cfg, n_layer=LM_PLAIN_LAYERS),
                     "cuda", seed=1)
    with torch.inference_mode():
        selective_scan_cuda.launches = 0
        got = short(ids)
        torch.cuda.synchronize()
        launches = selective_scan_cuda.launches
        for m in _mixers(short):
            m.scan_impl = "ref"
        want = short(ids)
        torch.cuda.synchronize()
    del short
    err, scale = (got - want).abs().max().item(), want.abs().max().item()
    rec = {"phase": "lm-plain", "model": LM_MODEL, "layers": LM_PLAIN_LAYERS,
           "tokens": LM_SCORE_LEN, "dtype": "float32", "tf32": False,
           "launches_per_forward": launches, "max_abs_err": err,
           "max_abs_ref": scale, "tol": 1e-3 * max(1.0, scale),
           "finite": bool(torch.isfinite(got).all())}
    del got, want
    out["plain"] = check(launches == LM_PLAIN_LAYERS and rec["finite"]
                         and err <= rec["tol"], rec)

    for dtype in (torch.float32, torch.bfloat16):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = build_lm(dataclasses.replace(cfg, dtype=dtype), "cuda",
                         seed=0)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        name = str(dtype).split(".")[-1]
        with torch.inference_mode():
            ll, greedy, seconds, launches = _lm_score(model, ids)
        rec = {"phase": "lm-score", "model": LM_MODEL, "dtype": name,
               "layers": cfg.n_layer, "d_model": cfg.d_model,
               "d_inner": cfg.d_inner, "dt_rank": cfg.dt_rank,
               "vocab": cfg.padded_vocab,
               "params": sum(p.numel() for p in model.parameters()),
               "weights_GB": sum(p.numel() * p.element_size()
                                 for p in model.parameters()) / 1e9,
               "build_seconds": build_s, "tokens": LM_SCORE_LEN,
               "loglikelihood": ll, "greedy": greedy, "seconds": seconds,
               "tokens_per_s": LM_SCORE_LEN / seconds,
               "launches": launches, "finite": math.isfinite(ll),
               "max_memory_allocated_GB":
                   torch.cuda.max_memory_allocated() / 1e9}
        out[f"score-{name}"] = check(
            launches == cfg.n_layer and rec["finite"], rec)
        if dtype == torch.float32:
            prompt = _lm_tokens((LM_GEN_BATCH, LM_GEN_PROMPT),
                                cfg.vocab_size, seed=22)
            with torch.inference_mode():
                last = model(prompt)[:, -1]
                top2 = last.topk(2, dim=-1).values
                torch.cuda.synchronize()
                selective_scan_cuda.launches = 0
                t0 = time.perf_counter()
                tokens = generate(model, prompt, LM_GEN_NEW, temperature=0.0)
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
            first_ok = torch.equal(tokens[:, LM_GEN_PROMPT],
                                   last.argmax(-1))
            rec = {"phase": "lm-generate", "model": LM_MODEL,
                   "dtype": name, "batch": LM_GEN_BATCH,
                   "prompt": LM_GEN_PROMPT, "new_tokens": LM_GEN_NEW,
                   "greedy": True, "seconds": seconds,
                   "new_tokens_per_s": LM_GEN_BATCH * LM_GEN_NEW / seconds,
                   "steps_per_s": (LM_GEN_PROMPT + LM_GEN_NEW) / seconds,
                   "scan_launches": selective_scan_cuda.launches,
                   "first_token_is_argmax": first_ok,
                   "min_top2_gap": (top2[:, 0] - top2[:, 1]).min().item(),
                   "shape": list(tokens.shape),
                   "prompt_kept": torch.equal(tokens[:, :LM_GEN_PROMPT],
                                              prompt)}
            out["generate"] = check(
                first_ok and rec["prompt_kept"]
                and rec["shape"] == [LM_GEN_BATCH,
                                     LM_GEN_PROMPT + LM_GEN_NEW]
                and rec["scan_launches"] == 0, rec)
        del model
    gc.collect()
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - phase_t0
    emit({"phase": "lm-seconds", "seconds": out["seconds"]})
    return out


# DiM-XL/2 with the JAX CLI's --block-type linear and its other defaults
# (Mamba v2: a forward and a reversed branch a mixer; LayerNorm; no DiT
# block) at 256 px: 24 blocks at hidden 1152, d_inner 2304, dt_rank 72
XL_LINEAR_ARGS = ["--model", "DiM-XL/2", "--image-size", "256",
                  "--num-classes", "1000", "--label-dropout", "0.1",
                  "--block-type", "linear"]
XL_LINEAR_SCANS = 24    # scan launches a forward, each entry
XL_LINEAR_STEPS = 4     # grid points of its sampling CLI run


def phase_xl_linear():
    """xl-linear: DiM-XL/2 --block-type linear (dt_rank 72, the kernels'
    RMAX 128) at 256 px, full depth, seeded weights: one fp32 CFG forward
    of 24 rows (TF32 off) through the kernels and the plain routes (1e-3
    of scale; 24 launches of the scan's forward and 24 of its reverse
    entry); `python -m dimsum_torch.sample ODE ... --bf16` in a process of
    its own (random weights, Euler over XL_LINEAR_STEPS grid points, CFG
    1.4, 4 images): finite, the launches of its drift calls; one fp32
    training step at depth 2 through kernels 2 and 3 and through the plain
    scan: the loss and every gradient (train-grad's tolerances), 4
    launches of each.  Alone: python3 -c "import chip_smoke as s;
    s.phase_xl_linear()"."""
    import dataclasses
    import os
    import subprocess
    import tempfile

    import torch

    from dimsum_torch.models.dim import build_dim
    from dimsum_torch.ops import selective_scan as ss
    from dimsum_torch.transport import create_transport

    phase_t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}

    def check(ok, rec):
        emit(rec)
        if not ok:
            raise AssertionError(f"xl-linear failed: {rec}")
        return rec

    cfg = _rest_config(XL_LINEAR_ARGS, torch.float32)
    g = torch.Generator(device="cuda").manual_seed(31)
    half = torch.randn((12, 4, 32, 32), generator=g, device="cuda")
    x = torch.cat([half, half])
    t = torch.rand(12, generator=g, device="cuda").repeat(2)
    y = torch.cat([torch.randint(0, 1000, (12,), generator=g,
                                 device="cuda"),
                   torch.full((12,), 1000, device="cuda")])
    rec = _rest_forward("DiM-XL/2-linear", cfg, x, t, y)
    rec.update(phase="xl-linear", block_type=cfg.block_type,
               scan_type=cfg.scan_type, dt_rank=math.ceil(
                   cfg.hidden_size / 16), tol=1e-3 * max(
                       1.0, rec["max_abs_ref"]))
    out["forward"] = check(
        rec["launches"]["scan_fwd"] == XL_LINEAR_SCANS
        and rec["launches"]["scan_reverse"] == XL_LINEAR_SCANS
        and rec["finite"] and rec["max_abs_err"] <= rec["tol"], rec)

    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        res = os.path.join(tmp, "cli.json")
        argv = ["ODE", *XL_LINEAR_ARGS, "--path-type", "GVP", "--bf16",
                "--sample-dir", os.path.join(tmp, "out"),
                "--sampling-method", "euler", "--num-sampling-steps",
                str(XL_LINEAR_STEPS), "--cfg-scale", "1.4",
                "--global-batch-size", "4"]
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-c", "import sys, chip_smoke as s; "
             "s._sample_run(sys.argv[1])", json.dumps([argv, res])],
            cwd=root, capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr)
            raise AssertionError(f"xl-linear: the sampling CLI exited "
                                 f"{proc.returncode}")
        with open(res) as f:
            cli_rec = json.load(f)
    calls = XL_LINEAR_STEPS - 1
    rec = {"phase": "xl-linear-cli", "argv": argv, "process_seconds": wall,
           **cli_rec}
    out["cli"] = check(
        cli_rec["finite"] and cli_rec["shape"] == [4, 4, 32, 32]
        and cli_rec["launches"]["scan_fwd"] == XL_LINEAR_SCANS * calls
        and cli_rec["launches"]["scan_reverse"] == XL_LINEAR_SCANS * calls,
        rec)

    # one fp32 step at depth 2 through kernels 2 and 3 and through the
    # plain scan; tolerances as train-grad
    model = build_dim(dataclasses.replace(cfg, depth=2), "cuda", seed=0,
                      train=True)
    transport = create_transport("GVP", "velocity")
    xs = torch.randn((2, 4, 32, 32), generator=g, device="cuda")
    ys = torch.randint(0, 1000, (2,), generator=g, device="cuda")

    def loss_and_grads():
        gen = torch.Generator(device="cuda").manual_seed(4)
        model.zero_grad(set_to_none=True)
        loss = transport.training_losses(
            lambda xt, t_, **kw: model(xt, t_, train=True, generator=gen,
                                       **kw), xs, gen, {"y": ys}
        )["loss"].mean()
        loss.backward()
        torch.cuda.synchronize()
        return loss.item(), {n: p.grad.clone() for n, p in
                             model.named_parameters() if p.grad is not None}

    counts = _zeroed_scan_counts()
    loss, grads = loss_and_grads()
    launches = {k: c.launches for k, c in counts.items()}
    for m in _mixers(model):
        m.scan_impl = "ref"
    want_loss, want = loss_and_grads()
    del model
    torch.cuda.empty_cache()
    errs = {k: _scaled_err(grads[k], want[k]) for k in want}
    worst = max(errs, key=errs.get)
    rec = {"phase": "xl-linear-train-grad", "depth": 2, "dtype": "float32",
           "batch": 2, "loss": loss, "loss_plain": want_loss,
           "loss_rel_err": abs(loss - want_loss) / abs(want_loss),
           "n_grads": len(want), "same_grad_set": set(grads) == set(want),
           "worst_grad": worst, "worst_grad_scaled_err": errs[worst],
           "tol": 2e-3, "launches": launches}
    out["train"] = check(
        launches == {"selective_scan_fwd": 0, "selective_scan_fwd_train": 4,
                     "selective_scan_bwd": 4}
        and rec["same_grad_set"] and rec["loss_rel_err"] <= 1e-4
        and errs[worst] <= 2e-3, rec)
    out["seconds"] = time.perf_counter() - phase_t0
    emit({"phase": "xl-linear-seconds", "seconds": out["seconds"]})
    return out


def main() -> int:
    smoke_t0 = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs one "
              "NVIDIA card", file=sys.stderr)
        return 1
    from dimsum_torch.ops import cuda_build
    from dimsum_torch.utils.device import card_name_and_power_limit

    card = card_name_and_power_limit(0)
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": card, "kind": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    logs = cuda_build.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "sources": sorted(logs),
          "source_seconds": getattr(cuda_build.build, "seconds", {}),
          "ptxas": [
              line.strip() for log in logs.values() for line in
              log.splitlines() if "registers" in line or "spill" in line]})

    scans = phase_kernel()
    phase_model()
    launches = phase_sample()
    train_scans = phase_kernel_train()
    phase_train_grad()
    launches.update(phase_train())
    phase_train_512()
    attn = phase_kernel_attn()
    phase_model_512()
    phase_model_512_bf16()
    launches["full_attention_sm90"] = \
        phase_sample_512()["full_attention_sm90"]
    states = phase_kernel_state()
    launches["selective_scan_fwd_state"] = \
        phase_sample_sp_512()["selective_scan_fwd_state"]
    norms = phase_kernel_norm()
    convx = phase_kernel_convx()
    phase_model_fused()
    phase_train_grad_fused()
    launches.update(phase_sample_fused())
    phase_sample_fused_512()
    variants = phase_variants()
    xl_linear = phase_xl_linear()
    rest = phase_models_rest()
    lm = phase_lm()
    fp32_launches, fused_fp32_launches = phase_sampling_path()
    for name in ("full_attention_f32", "full_attention_first"):
        launches[name] = fp32_launches[name]
    cli_launches = phase_train_cli()
    phase_train_remat()
    phase_train_ddp()
    parallel = phase_parallel()
    beyond = phase_kernel_cases()

    # the scan at the 256-px mixer shape, with the 512-px one (L 1024) and
    # linear + v2's (dim 2048, r 64) beside it; its reverse entry at the
    # same shapes, with its launches in the variants phase's sampling run
    # of linear + v2, whose reverse branches run at the v2 shape
    main_case, long_case = scans["mixer-bf16"], scans["L1024-bf16"]
    rev_case, rev_long = (scans["mixer-bf16-reverse"],
                          scans["L1024-bf16-reverse"])
    v2_case, rev_v2 = scans["v2-bf16"], scans["v2-bf16-reverse"]
    kernels = [{
        "name": "selective_scan_fwd",
        "route": "cuda",
        "source": "dimsum_torch/csrc/selective_scan_fwd.cu",
        "replaces": "dimsum_tpu/ops/selective_scan.py:426",
        "launches": launches["selective_scan_fwd"],
        "max_abs_err": max(r["max_abs_err"] for r in scans.values()),
        "ms": main_case["ms"],
        "device_ms": main_case["device_ms"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "library_ms": None,
        "L1024_ms": long_case["ms"],
        "L1024_device_ms": long_case["device_ms"],
        "L1024_plain_ms": long_case["plain_ms"],
        "L1024_bound_ms": long_case["bound_ms"],
        "reverse_ms": rev_case["ms"],
        "reverse_device_ms": rev_case["device_ms"],
        "reverse_bound_ms": rev_case["bound_ms"],
        "reverse_plain_ms": rev_case["plain_ms"],
        "reverse_launches": variants["sample"]["launches"]["scan_reverse"],
        "reverse_launches_shape": rev_v2["shape"],
        "reverse_max_abs_err": max(r["max_abs_err"] for r in scans.values()
                                   if r["reverse"]),
        "reverse_L1024_ms": rev_long["ms"],
        "reverse_L1024_device_ms": rev_long["device_ms"],
        "reverse_L1024_plain_ms": rev_long["plain_ms"],
        "reverse_L1024_bound_ms": rev_long["bound_ms"],
        "v2_shape": v2_case["shape"],
        "v2_ms": v2_case["ms"],
        "v2_device_ms": v2_case["device_ms"],
        "v2_plain_ms": v2_case["plain_ms"],
        "v2_bound_ms": v2_case["bound_ms"],
        "reverse_v2_ms": rev_v2["ms"],
        "reverse_v2_device_ms": rev_v2["device_ms"],
        "reverse_v2_plain_ms": rev_v2["plain_ms"],
        "reverse_v2_bound_ms": rev_v2["bound_ms"],
        "reverse_v2_max_abs_err": max(
            r["max_abs_err"] for r in scans.values()
            if r["reverse"] and r["shape"][2:] == rev_v2["shape"][2:]),
    }]
    # the state entry at the sample-sp-512 shape: `ms` the first SP pass
    # (zero state in, the last state out), `h0_ms` the second (seeded)
    sp_case = states["sp-bf16"]
    kernels.append({
        "name": "selective_scan_fwd_state",
        "route": "cuda",
        "source": "dimsum_torch/csrc/selective_scan_fwd.cu",
        "replaces": "dimsum_tpu/ops/selective_scan.py:724",
        "replaces_also": "dimsum_tpu/ops/selective_scan.py:738 (has_h0)",
        "launches": launches["selective_scan_fwd_state"],
        "max_abs_err": max(r["max_abs_err"] for r in states.values()),
        "ms": sp_case["ms"],
        "device_ms": sp_case["device_ms"],
        "plain_ms": sp_case["plain_ms"],
        "bound_ms": sp_case["bound_ms"],
        "bound_by": sp_case["bound_by"],
        "library_ms": None,
        "h0_ms": sp_case["h0_ms"],
        "h0_device_ms": sp_case["h0_device_ms"],
        "h0_bound_ms": sp_case["h0_bound_ms"],
        # --cond-init sampling (models-rest): h0 in, no last state
        "cond_init_launches":
            rest["DiM-L/2-moe-sample"]["launches"]["scan_state"],
    })
    train_case, train_long = train_scans["train-bf16"], \
        train_scans["L1024-bf16"]
    h0_case = train_scans["h0-bf16"]
    rest_train = rest["DiM-L/2-moe-train"]["h0_launches"]
    for name, key, source, replaces in (
            ("selective_scan_fwd_train", "fwd_train",
             "dimsum_torch/csrc/selective_scan_fwd_train.cu",
             "dimsum_tpu/ops/selective_scan_bwd.py:51"),
            ("selective_scan_bwd", "bwd",
             "dimsum_torch/csrc/selective_scan_bwd.cu",
             "dimsum_tpu/ops/selective_scan_bwd.py:96")):
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(r[key]["max_abs_err"]
                               for r in train_scans.values()),
            "ms": train_case[key]["ms"],
            "device_ms": train_case[key]["device_ms"],
            "plain_ms": train_case[key]["plain_ms"],
            "bound_ms": train_case[key]["bound_ms"],
            "bound_by": train_case[key]["bound_by"],
            "library_ms": None,
            "L1024_ms": train_long[key]["ms"],
            "L1024_device_ms": train_long[key]["device_ms"],
            "L1024_plain_ms": train_long[key]["plain_ms"],
            "L1024_bound_ms": train_long[key]["bound_ms"],
            "train_cli_launches": cli_launches[name],
            # the h0 entry (--cond-init training) at the training mixer
            # shape; its launches in models-rest's training steps
            "h0_ms": h0_case[key]["ms"],
            "h0_device_ms": h0_case[key]["device_ms"],
            "h0_plain_ms": h0_case[key]["plain_ms"],
            "h0_bound_ms": h0_case[key]["bound_ms"],
            "h0_max_abs_err": max(r[key]["max_abs_err"]
                                  for r in train_scans.values() if r["h0"]),
            "h0_launches": rest_train[name]})
    # the attention: bf16 at Dh 64 (the bf16 sampling paths) through the
    # sm90 kernel, fp32 at Dh 64 (the default fp32 sampling path,
    # sample-512-fp32) through the fp32 kernel, each with its cross-shape
    # numbers beside the DiT ones, and its Dh-72 numbers (DiT-XL/2 and
    # DiM-XL/2 at 512 px, 8 rows: their DiT heads and DiM-XL/2's cross
    # heads) with the launches of models-rest (bf16: DiT-XL/2's sampling
    # CLI run; fp32: the DiT-XL/2 and DiM-XL/2 forwards).  The first
    # kernel serves Dh 80-128, on no main path (its launches 0): its times
    # on the Dh-72 inputs (bf16, and fp32 beside them) and on the fp32
    # kernel's Dh-64 inputs
    def attention_record(name, source, dit, cross, timed):
        return {
            "name": name, "route": "cuda", "source": source,
            "replaces": "dimsum_tpu/ops/full_attention.py:82",
            "launches": launches[name],
            "max_abs_err": max(timed(dit)["max_abs_err"],
                               timed(cross)["max_abs_err"]),
            "ms": timed(dit)["ms"], "device_ms": timed(dit)["device_ms"],
            "plain_ms": dit["plain_ms"],
            "bound_ms": dit["bound_ms"], "bound_by": dit["bound_by"],
            "library_ms": dit["library_ms"],
            "library_device_ms": dit["library_device_ms"],
            "cross_ms": timed(cross)["ms"],
            "cross_device_ms": timed(cross)["device_ms"],
            "cross_plain_ms": cross["plain_ms"],
            "cross_bound_ms": cross["bound_ms"],
            "cross_library_ms": cross["library_ms"],
            "cross_library_device_ms": cross["library_device_ms"]}

    dh72_launches = {
        "full_attention_sm90":
            rest["DiT-XL/2-512-sample-cli"]["launches"][
                "full_attention_sm90"],
        "full_attention_f32": sum(
            rest[c]["launches"]["full_attention_f32"] for c in (
                "DiT-XL/2-512", "DiT-XL/2-512-fused", "DiM-XL/2-512",
                "DiM-XL/2-512-fused"))}
    for name, case, dtype in (("full_attention_sm90", "bf16", "bfloat16"),
                              ("full_attention_f32", "fp32", "float32")):
        rec = attention_record(
            name, f"dimsum_torch/csrc/{name}.cu", attn[f"dit-{case}"],
            attn[f"cross-{case}"], lambda r: r)
        dh72 = attention_record(
            name, "", attn[f"dh72-{case}"], attn[f"dh72-cross-{case}"],
            lambda r: r)
        rec.update({f"dh72_{k}": v for k, v in dh72.items()
                    if k not in ("name", "route", "source", "replaces",
                                 "launches", "bound_by")})
        rec.update(dh72_shape=attn[f"dh72-{case}"]["shape"],
                   dh72_cross_shape=attn[f"dh72-cross-{case}"]["shape"],
                   dh72_launches=dh72_launches[name],
                   max_abs_err=max(
                       rec["max_abs_err"], dh72["max_abs_err"],
                       attn[f"dh72-{dtype}-logits40"]["max_abs_err"]))
        kernels.append(rec)
    dh72, dh72_fp32 = attn["dh72-bf16"], attn["dh72-fp32"]
    first = attention_record(
        "full_attention_first", "dimsum_torch/csrc/full_attention.cu",
        dh72, dh72, lambda r: r["first_kernel"])
    first = {k: v for k, v in first.items() if not k.startswith("cross_")}
    first.update(
        launches=launches["full_attention_first"]
        + sum(r["launches"]["full_attention_first"] for r in rest.values()
              if isinstance(r, dict) and "launches" in r
              and "full_attention_first" in r["launches"]),
        main_path="none: Dh 80-128, which no model of the zoo has",
        max_abs_err=max(dh72["first_kernel"]["max_abs_err"],
                        dh72_fp32["first_kernel"]["max_abs_err"]),
        shape=dh72["shape"],
        fp32_ms=dh72_fp32["first_kernel"]["ms"],
        fp32_device_ms=dh72_fp32["first_kernel"]["device_ms"],
        fp32_plain_ms=dh72_fp32["plain_ms"],
        fp32_bound_ms=dh72_fp32["bound_ms"],
        fp32_library_ms=dh72_fp32["library_ms"],
        fp32_library_device_ms=dh72_fp32["library_device_ms"],
        dh64_fp32_ms=attn["dit-fp32"]["first_kernel"]["ms"],
        dh64_fp32_device_ms=attn["dit-fp32"]["first_kernel"]["device_ms"],
        dh64_cross_fp32_device_ms=attn["cross-fp32"]["first_kernel"][
            "device_ms"])
    kernels.append(first)
    # the main-path cases: bf16, the add + norm site and norm_2 (no single
    # PyTorch call computes any of the three functions: library_ms null)
    for name, source, replaces, cases, main_case in (
            ("add_norm", "dimsum_torch/csrc/add_norm.cu",
             "dimsum_tpu/ops/norms.py:81", norms["add_norm"], "bfloat16"),
            ("norm_modulate", "dimsum_torch/csrc/norm_modulate.cu",
             "dimsum_tpu/ops/norms.py:349", norms["norm_modulate"],
             "norm_2-bfloat16"),
            ("conv_xproj", "dimsum_torch/csrc/conv_xproj.cu",
             "dimsum_tpu/ops/conv_xproj.py:123", convx, "mixer-bf16")):
        case = cases[main_case]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in cases.values()),
            "ms": case["ms"], "device_ms": case["device_ms"],
            "plain_ms": case["plain_ms"],
            "bound_ms": case["bound_ms"], "bound_by": case["bound_by"],
            "library_ms": None})
    # the bf16 residual stream's case of rows 5 and 6 (add + norm at the
    # blocks' top sites, norm + modulate at the deferred top), timed in
    # kernel-norm; their launches in the parallel phase's bench runs
    bf16_legs = parallel["bf16"]
    for name, case in (
            ("add_norm", norms["add_norm"]["bf16-residual"]),
            ("norm_modulate",
             norms["norm_modulate"]["deferred-top-bf16-residual"])):
        rec = next(r for r in kernels if r["name"] == name)
        rec.update({f"bf16_residual_{k}": case[k] for k in (
            "shape", "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
            "max_abs_err")})
        rec["bf16_residual_launches"] = sum(
            r["launches"][f"{name}_bf16_residual"] for r in bf16_legs)
        rec["max_abs_err"] = max(rec["max_abs_err"], case["max_abs_err"])
    # norm_2 and conv_xproj at the fused 512-px sampling shape (L 1024);
    # norm_2 at 256 px also with a cold L2
    by_name = {rec["name"]: rec for rec in kernels}
    mods = norms["norm_modulate"]
    for name, long_case in (("norm_modulate", mods["norm_2-L1024-bfloat16"]),
                            ("conv_xproj", convx["L1024-bf16"])):
        by_name[name].update({"L1024_ms": long_case["ms"],
                              "L1024_device_ms": long_case["device_ms"],
                              "L1024_plain_ms": long_case["plain_ms"],
                              "L1024_bound_ms": long_case["bound_ms"]})
    by_name["norm_modulate"]["cold_device_ms"] = \
        mods["norm_2-bfloat16"]["cold_device_ms"]
    # conv_xproj's fp32 route at the mixer, L 1024 and DiM-XL/2 shapes, and
    # its launches in the fused fp32 512-px CLI run
    for key, case in (("fp32", "mixer-fp32"), ("fp32_L1024", "L1024-fp32"),
                      ("fp32_xl_R68", "xl-R68-fp32")):
        by_name["conv_xproj"].update({
            f"{key}_{k}": convx[case][v] for k, v in (
                ("shape", "shape"), ("ms", "ms"), ("device_ms", "device_ms"),
                ("plain_ms", "plain_ms"), ("bound_ms", "bound_ms"))})
    by_name["conv_xproj"]["fp32_launches"] = \
        fused_fp32_launches["conv_xproj_fp32"]
    # the ranks above 64 (kernel-rank, in the lm phase): each case's
    # numbers, and the launches of the LM's scoring forwards (fp32, bf16)
    # and of DiM-XL/2 --block-type linear (its forward and sampling CLI
    # run; its training step)
    def rank_case(rec, sub=None):
        r = rec if sub is None else rec[sub]
        return {"case": rec["case"], "shape": rec["shape"],
                "dtype": rec["dtype"], "reverse": rec["reverse"],
                **{k: r[k] for k in ("max_abs_err", "ms", "device_ms",
                                     "plain_ms", "bound_ms", "bound_by",
                                     "bound_ops")}}

    scan_rec = by_name["selective_scan_fwd"]
    scan_rec["rank_cases"] = [rank_case(r)
                              for r in lm["ranks"]["scan"].values()]
    scan_rec["lm_launches"] = {k: lm[f"score-{k}"]["launches"]
                               for k in ("float32", "bfloat16")}
    scan_rec["xl_linear_launches"] = {
        k: xl_linear["forward"]["launches"][k]
        + xl_linear["cli"]["launches"][k]
        for k in ("scan_fwd", "scan_reverse")}
    for name, key in (("selective_scan_fwd_train", "fwd_train"),
                      ("selective_scan_bwd", "bwd")):
        by_name[name]["rank_cases"] = [
            dict(rank_case(r, key), h0=r["h0"])
            for r in lm["ranks"]["train"].values()]
        by_name[name]["xl_linear_launches"] = \
            xl_linear["train"]["launches"][name]
    _add_case_fields(by_name, beyond)
    emit({"phase": "smoke-seconds", "seconds": time.perf_counter() - smoke_t0,
          "variants_seconds": variants["seconds"],
          "models_rest_seconds": rest["seconds"],
          "xl_linear_seconds": xl_linear["seconds"],
          "lm_seconds": lm["seconds"],
          "parallel_seconds": parallel["seconds"],
          "kernel_cases_seconds": beyond["seconds"]})
    emit({"kernels": kernels})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
