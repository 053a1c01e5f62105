"""Drive the PyTorch/CUDA port on one GPU: reconstruction (in the modes
SpeechAutoEncoder and SpokenLLM), completion in the int8 and the int4
serving tiers, streaming (the chunked synthesis and the pipelined
completion), the stage-1 and stage-2 training steps and the stage-2 eval,
the flow's OT-CFM step, the decode-layout tools (profile_lmhead,
profile_fusion), TASLM in the int8 layout, padded flash attention at the
flow's shapes, the model variants (card against host), the offline
user journey through the CLIs (seed, export, import, generate, extract,
eval), and the model axis (the int8 joint decode over two ranks sharing
the card, dryrun_multichip).

    python3 chip_smoke.py

Needs one CUDA device and the CUDA toolkit (nvcc).  Two models in the
bench's serving layouts (`bench.py:755-811` with BENCH_FUSED_MLP=1; the
second with BENCH_QUANT=4) drive the serving paths, a third in bf16 the
training step (step 7): TasteConfig.full() with the f32
tower, everything else bf16, LoRA merged, the Llama int8 (int4) with the
int4 tied head, fused qkv and fused MLPs, the S3 llm stack and its head
int8 (int4) with fused qkv and fused FFN, fused DiT blocks and kernel
convs.  Both take the same weights: random from seed 0 at the bench's
scales in the float layout (with LoRA adapters), through the port's own
quantizer (quant.py).  In order it:

1. prints the card's name and power limit (nvidia-smi);
2. builds the port's CUDA kernels from taste_spokenlm_tpu_torch/csrc (one
   nvcc per source, all started together) and prints the seconds each took;
   checks in the SASS (cuobjdump) that every bf16 flash kernel, the bf16
   rel-pos forward and the backward's three product kernels, every DiT
   GEMM and attention kernel and every tensor-core kernel of the gated
   int8 / int4 MLPs and of the int8 / int4 FFNs (the ones that run M > 1)
   issue tensor-core instructions, that no f32 flash or rel-pos kernel and
   no one-row kernel does, and that no kernel of the gated MLPs or of the
   FFNs (their one-row SIMT kernels too) issues an int-to-float conversion
   (I2F);
3. runs, on the int8 model, the full-width reconstruction (step 4), a
   full-width completion (step 5), the streaming path (step 5s), serving
   and the model axis (step 5m); then
   frees it, builds the int4 model and
   runs the same completion on it (step 6); frees that, runs the serving
   tiers' fidelity gate (step 6), builds the bf16 training model and runs
   the stage-1 step (step 7); frees that and runs
   the decode-layout tools (step 8), then TASLM (step 8t), padded flash
   (step 8p), the variants (step 8v) and the offline journey (step 8c).
   Each counted run
   has every launch count set to 0 just before it and read just after, and
   prints its peak device memory.  The serving paths' conformers run at
   40 and 128 asr tokens and their S3 decode through the KV cache, below
   or off the rel-pos kernel (T >= 256, no cache), so they must launch it
   0 times;
4. reconstruction: B=1, 40 asr tokens and the whisper log-mel of a seeded
   wav; it checks that it went through every kernel the expected number of
   times, that the S3 decode ran at least 64 steps, that the waveform is
   finite and 256 samples per mel frame, that the tower with kernels picks
   the same taste indices as with the plain versions (>= 0.99) and that
   the flow's mel with kernels is within 2e-2 of the plain versions' for
   the same start noise z, on what the estimator added to it (mel - z),
   printing beside it the same error of the plain bf16 flow against an f32
   copy (the bf16 noise floor);
4l. reconstruction in mode "SpokenLLM" ("spokenllm_reconstruction"), on
   the int8 model, the same wav with step 5's 40-token llm prefix: the
   spoken LM's teacher-forced taste (extract_vq's llm indices through the
   Llama's 42 prefix rows, the fused MLP and the int4 head) read back per
   asr token, then the S3 decode, flow and HiFT.  Checks: exact launches
   of every kernel, an S3 decode >= 64 long, a finite waveform of 256
   samples a mel frame, the teacher-forced taste indices with kernels
   against the plain versions (>= 0.99 of the labelled positions), and
   `scoring` on the same inputs finite and within 1e-3 relative of its
   plain run;
5. completion, as bench.py:990-1087: extract_vq on the same wav (a 40-token
   llm prefix with the asr word ids), 64 joint text + taste decode steps
   with the bench's sampler (text top-p 0.3, temperature 0.5, repetition
   penalty 1.1, taste greedy, extra_words 64), the host glue (per-word
   taste rows, 128 asr tokens at 2 per word) and synthesize_from_taste (512
   S3 steps, 904 mel frames).  Checks: >= 32 tokens, an S3 decode >= 64
   long, a finite waveform of rms > 1e-7 and 256 samples per mel frame,
   exact launch counts of all eight kernels, the same token trajectory from
   the same generator state twice, and a greedy decode with kernels
   against one with the plain versions: their text logits within 1.2e-2 of
   max |logit| on every step of their shared history (up to the first
   step at which a text or taste decision differs), the text agreeing on
   >= 0.98 of the steps unless the runs part that way at a near-tie of
   the random weights' logits, zeroed Llama MLPs moving those logits past
   the tolerance, and the prefill hidden states differing;
5s. streaming ("streaming"), on the int8 model, at bench.py:1212-1230's
   geometry (a first chunk of 16 S3 tokens, then 50 and 446, left context
   25, crossfade 2, 512 S3 steps; joint-decode chunks of 16 then 48,
   synthesis from 2 words) with step 5's sampler, taste rows and 128-token
   asr buffers.  StreamingSynthesizer and CompletionStreamer run directly
   (TasteEngine's token buckets and fixed chunks do not fit that
   geometry); TasteEngine's tokenize, reconstruct, synthesize_stream and
   complete_stream run once each at the engine's own.  Checks: the counted synthesis
   stream and pipelined stream each launch ffn_int8, fused_dit_block,
   conv1d_same (and gated_mlp_int8, matmul_int4) exactly as the chunks
   they ran imply (`stream_launches`: prefill rows, executed S3 and joint
   steps, none in a history replay, each window's DiT and conv shapes);
   one seed gives one token stream; the stream's tokens equal
   synthesize_from_taste's on one drawn S3 gumbel; finite chunks, the
   total length within 2 spf a chunk of floor(n mpt) spf and continuous
   seams (tests/test_streaming.py:190-201); in the pipelined stream
   n_words never falls, the last chunk has jd_done and the committed
   tokens are in the vocabulary; a stream resumed after its first chunk
   within LOGIT_TOL of the uninterrupted stream's S3 logits over the next
   chunk (and out of it when its history is replayed out of order);
   the flow's mel - z with kernels within 2e-2 of the plain
   versions' at each window size (32, 134, 816 frames); the engine's
   tokenize agrees with the unpadded tower (>= 0.99), its streams end
   finite and its reconstruction gives finite audio.  It prints stream_first_s (median of 3), ttfa_p50_s (median of
   5), the pipelined wall and RTF (median of 3, with their runs), the
   non-streaming TTFA (the median of three offline completions' decode +
   synthesis walls), the path's wall and peak memory;
5m. the model axis ("model_axis"), on the int8 model's prompt: two
   processes on the one card over gloo (NCCL refuses two ranks on one
   device), each building the int8 serving model from the same seed-0
   float weights and holding its rank's slices (quant.shard_state_dict:
   16 of the 32 query heads and 4 of the 8 key / value heads, gate / up /
   down's half of I = 8192, so gated_mlp_int8 runs at H = 2048, I = 4096;
   half of the int8 embedding's rows; the fused qkv_proj and the int4
   head whole), run a warm-up and a counted greedy joint decode of 64
   steps on step 5's prompt (extract_vq's llm indices, the 40-token
   prefix) while this process runs the same decode on the whole model.
   Checks: each rank's launches exact (gated_mlp_int8 at the 42 prefix
   rows and one row a step at I = 4096, matmul_int4 once a step, nothing
   else) and its collectives exact (one all-reduce per embedding lookup
   and two per layer and pass); the two ranks' trajectories equal and
   their logits bit-identical; the prefill's and the first step's text
   logits within 2e-2 of max |logit| of the one-process run's; every step
   equal to the one-process run's or, where the runs part, the
   one-process run's top-2 margin there below the logit drift measured
   there (a tie, as serving_fidelity reads one).  It prints ms a joint
   step, collectives a step and peak memory per rank beside the
   one-process run's (two ranks sharing one card say nothing of tensor-
   parallel speed).  Then entry.dryrun_multichip(4) on the card: one
   stage-1, one stage-2 and one flow step of TasteConfig.tiny() over four
   processes on a (2, 2) mesh, sharing the card over gloo;
6. the int4 completion: step 5 on the int4 model, where the fused MLPs are
   gated_mlp_int4 / ffn_int4 and every other projection (Llama qkv / o, S3
   qkv / out, the S3 head) runs matmul_int4; it must launch the int8 MLPs
   0 times.  It prints its greedy text agreement with the int8 tier (not a
   gate: JAX's floor for the int4 tier is against f32).  Then the serving
   tiers' fidelity gate, "serving_fidelity"
   (taste_spokenlm_tpu_torch/scripts/serving_fidelity.py --reach, each
   row's model freed before the next is built): an f32 model with LoRA
   adapters at the JAX script's weight scales, and from its weights the
   bf16 merged, int8 and int4 serving layouts, each running 64 greedy joint
   steps, the synthesis of the f32 row's taste rows (512 S3 steps) and the
   flow on the f32 row's S3 tokens from one fixed noise; and, for each
   layout, its float twin: the f32 model on the layout's own weights,
   dequantized.  Each tier's kernels must launch exactly as the rows'
   runs imply, every row's waveform be finite and the f32 row's
   trajectories not degenerate.  Every serving row must stay within
   TWIN_TOL of its twin (text and S3 logits on their shared history,
   relative to max |logit|; the flow's mel - z), and the reach row (int8,
   the S3 FFN W2 scales doubled, against the int8 twin) must leave it.
   The JAX script's floors but tf_taste (greedy text trajectory >= 0.98
   bf16 / int8, >= 0.90 int4; S3 trajectory >= 0.98 bf16, >= 0.95 int8;
   mel rel err <= 0.05 / 0.05 / 0.10) are evaluated and each miss printed,
   beside the twins' own trajectory agreement and the f32 row's top-2
   logit margins: on these weights the twins miss the same floors with
   no serving kernel in their path (PERF.md §6), so a miss does not fail
   the run;
7. the stage-1 training step as bench.py:186-300 runs it: TasteConfig.full()
   in bf16 (segmenter and RVQ f32) from the same seed-0 float weights,
   per-layer remat, the rvq phase (whisper encoder frozen), Adam lr 1e-4
   clipped at a global norm of 5, B = 8 rows of 30 s (3000 mel frames, 96
   asr tokens at 2 per word, 1500 S3 tokens); one warm-up step and three
   counted ones on other random batches.  Checks: finite loss, commit loss
   and grad norm on every step; per step exactly 14 rel-pos forwards (7 S3
   layers, each recomputed by remat), 7 rel-pos backwards and 32 flash
   launches (the frozen encoder under no_grad), every other kernel 0; the
   frozen encoder bit-identical after the steps; every trainable group
   (whisper decoder, RVQ projections, the three S3 stacks, the head) and
   the codebook EMA buffers moved; taste indices in range; one step's
   gradients from the same state and batch with kernels and with plain
   versions (all 8 rows): loss within 1e-3 relative, grad norm and the S3
   stack's layer-0 linear_pos / linear_q / linear_k gradients within 2e-2
   of max|plain|.  It prints the step wall (the min of the three),
   frames/s and peak memory;
7b. the stage-2 step ("stage2_train") at bench.py:343-420's rung: the bf16
   model (LoRA unmerged, bf16 too; per-layer remat), lora_only_mask, Adam
   lr 1e-4 clipped at 5, use_ref_kl (the frozen base, adapters off, in the
   same step), chunked CE + KL; B = 8 x 512 llm tokens (word ids
   arange(T) // 2, taste at word starts, RandomState(100 + seed)).  One
   warm-up step and three timed ones.  Checks: finite loss, text_kl and
   grad norm; every launch counter 0 over each step; every frozen tensor
   bit-identical and every lora_B moved; at B = 2 x 514 rows,
   chunked_ce_kl's CE, KL and gradient within 1e-4 relative of the
   unchunked formula in f32 (both peaks printed); the chunked loss with
   the bf16 tensor-core head (the path's) within 1e-4 of the same loss on
   the table's f32 copy, its bf16 gradient within one bf16 step of the
   largest ("stage2_head_cost"; with --profile it also times both heads
   and the copy made on every head call).  It prints step_s (the min of three),
   tokens/s and peak memory.  Then "stage2_eval":
   forward_spoken_llm with the speech measurement and eval_metrics_stage2
   at B = 2 (96 asr tokens, 500 S3 targets: the S3 stack at T = 599, one
   rel-pos forward per layer exactly), the speech logits with kernels
   within 2e-2 of max |plain|;
7b'. the training harness ("train_harness"), after the stage-1 step's
   model is freed: (a) `train/trainer.py`'s Trainer drives four stage-1
   steps at the same rung (a fresh bf16 model on the same weights, rvq
   phase, per-layer remat, Adam 1e-4 clipped at 5, B = 8 x 30 s batches
   of stage1_batch) with TrainerConfig(total_steps=4, log_every=1,
   save_every=2, max_to_keep=2, best_metric="loss") in
   build/train_harness/trainer: exactly train_launches(cfg, 4) launches,
   four finite metrics.jsonl rows, checkpoints at steps 2 and 4 only; (b)
   one step run twice from the restored step-2 state (must repeat bit for
   bit; where it does not, the differing tensors and the ops that
   torch.use_deterministic_algorithms names are printed and the spread
   becomes the gate), then a fresh model and optimizer restored from
   step 2 run steps 3 and 4: the losses, every parameter, EMA buffer and
   Adam moment, the step and the generator against the uninterrupted
   run's step-4 checkpoint, bit for bit (or within that spread); (c) the
   train CLI (scripts/train.py, --tiny, f32, --synthetic --remat full: cut
   from the full config for the model_axis phase's time, printed as
   `reduced`; (a) and (b) and steps 7-7c run the full width) as
   subprocesses, four chains run concurrently: straight through 4 steps
   (saves at 2 and 4); a run killed with SIGKILL once its step-2
   checkpoint has landed and relaunched, whose steps 3-4 rows must match
   the straight run's (bit for bit, or within (b)'s spread); --stage 2
   and --model flow, 2 steps each: finite losses and "done".  At the tiny
   widths no kernel runs (the whisper frames are below flash's gate),
   each run's launches exact.  It prints the step walls, the save and
   restore seconds, the checkpoint bytes, the peak memory and each CLI
   run's wall;
7c. the flow step ("flow_train"): the full-width flow in f32 with the
   serving config's fused-DiT flag on, B = 8 rows of 512 S3 tokens and
   882 mel frames (flow_mel, on the card, of a seeded 22.05 kHz wav);
   one warm-up and three timed steps.  Checks: finite loss and grad norm,
   every launch counter 0 (the DiT blocks unfused under autograd, no
   HiFT), every parameter moved, the loss bit-identical twice from the
   same draws.  It prints step_s, mel frames/s and peak memory;
8. the decode-layout tools (taste_spokenlm_tpu_torch/scripts), each loop
   a CUDA graph of its decode steps and two eager loops:
   profile_lmhead at V = 128,256, D = 2048, M = 1, 64 steps (the
   fused-convert, logits_int8 and int4 heads), and profile_fusion at the
   Llama-1B shapes (16 layers, 64 steps) and the S3 shapes (7 layers, 512
   steps) in the layouts A, B, P (matmul_int8), Q (matmul_int4), R
   (gated_mlp_int8), S (gated_mlp_int4 + matmul_int4) and C, 5 graph
   replays each.  Checks: each eager loop's launches exactly, the path's
   totals, the int8 head's first-step logits within 1e-3 of the
   fused-convert head's max (argmax where the top-2 gap exceeds twice the
   error), and a one-layer step of every layout finite and within 2e-2 of
   max|plain| of the same step on the plain versions, P within 2e-2 of B.
   It prints each layout's graph and eager ms a step and the share of its
   weight bytes' HBM bound (the tools' weights make x overflow to inf /
   NaN after a few layers; the timing does not depend on the values);
8t. TASLM ("taslm"): TaslmConfig() (Llama-3.2-1B width, 16 layers; 4
   speech channels x 4096, the 1280-wide RVQ space) with seeded random
   weights in bf16, LoRA merged and the Llama quantized by the port's
   quant.py as the int8 serving layout (int8 projections, fused qkv and
   MLP, an int8 table with the int4 tied head); a seeded codebook [4,
   4096, 256] -> 1280.  A sampled decode (B = 1, a 40-token text prompt
   with 60 speech rows, the last 20 forced; 64 steps; text top-p 0.9,
   speech top-p 0.3) counted: exactly 16 gated_mlp_int8 launches over the
   40 prefix rows, 16 a step at one row but the stopping one, one
   matmul_int4 head a step, every other kernel 0; the forced rows
   emitted; the same trajectory again from the same generator state; a
   greedy decode with the kernels against one with the plain versions,
   text and speech logits within LOGIT_TOL of max |logit| over their
   shared history.  Then scoring at B = 2 x 256 (the teacher-forced
   forward with every loss and calculate_log_likelihood, counted: the
   MLPs past 256 rows unfused, the int4 head twice at 512 rows): finite,
   the log-likelihoods within 1e-3 relative of the plain run's.  It
   prints the prefill s, ms a step, the decode wall and the peak memory;
8p. padded flash ("padded_flash"): ops/attention.padded_flash_attention
   at the flow U-Net's shapes (B = 2, T = 904 and 452, 8 heads x 64, f32
   and bf16, key lengths [T, T - 37] and [T, 0]), one counted launch
   each; against the plain masked attention on the valid query rows
   (1e-4 abs f32, 2e-2 of max|plain| bf16), bit-identical twice, finite
   everywhere (the row with no valid key too); times beside the plain
   version and SDPA with the boolean mask;
8v. the variants ("variants"): each module of this slice at
   TasteConfig.full() widths with the depth cut (the Llama 2 layers, the
   whisper encoder 4, the conformers 2 blocks; printed as `reduced`), in
   f32 (TF32 off) on the card and on the host from the same weights: every
   quantizer of the zoo, every bridge, the spoken LM in each audio-embed
   mode and with a weighted-layer out bridge (its greedy decode too), the
   conv-module / macaron conformer under each stem (its train forward's
   BatchNorm statistics too), the speech decoder's concat fusions and
   fuse_normalize (forward and greedy decode), the legacy and the
   add_and_norm towers on the path's mel.  Floats within 1e-3 relative,
   discrete outputs equal on >= 0.99 of the positions; the two towers'
   whisper encoders launch flash exactly 8 times;
8c. the offline journey ("clis"), each CLI a subprocess through run_cli
   (its launches read in that process), at TasteConfig.full() with the
   serving config's kernel flags: create_seed_model (bf16, f32 tower)
   writes a float directory; convert_checkpoint --export-torch writes the
   reference-named composite, which the script cuts into an HF whisper
   dir (pytorch_model.bin), an HF Llama dir (model.safetensors, PEFT names
   with the LoRA adapters), the taste rest, flow.pt and hift.pt
   (weight-norm pairs); the importer's float dict must equal the seed's
   state dict bit for bit; convert_checkpoint imports the files with
   --merge-lora --quantize-llama --quantize-s3-decoder --fuse-qkv
   --fused-mlp --quantize-embed int4head, and the directory must equal a
   model's state dict loaded with quant.serving_state_dict of the seed's
   weights byte for byte, its config quant.serving_config's;
   generate_audio --task completion on a 6 s 44.1 kHz 16-bit stereo wav
   (forced text, the offline tokenizers, a CAM++-shaped x-vector graph
   from onnx_build, greedy text and taste, 64 joint and 512 S3 steps, 904
   mel frames): launches exactly as quantized_launches (and flash, DiT,
   conv) predict, the x-vector on the card within 1e-5 relative of the
   host's (f32, TF32 off), the text and S3 trajectories equal to an
   in-process run on the same inputs, the wav finite and of the length
   its S3 tokens imply; the S3 topline (--use-target-speech-token with an
   S3-tokenizer-shaped graph): its ids on the card equal the host's, >= 16
   distinct, and the CLI vocodes exactly those; extract_vq --synthetic
   (2 x 8 rows) equal to an in-process extract_vq; eval --synthetic (2 x
   4 rows, stages 1 and 2) within 1e-5 of the in-process forwards.  It
   prints each step's wall, generate_audio's StageTimer report and its
   joint_decode_step_bytes / s3_decode_step_bytes;
9. holds each kernel against its plain PyTorch version at the shapes the
   counted runs gave it (the streaming windows' DiT and conv shapes
   too), and times kernel, plain version and a library call that
   computes the same function (CUDA events, median of 20 after warm-up).
   Tolerances: flash attention (float32) 1e-4 abs, as both sides do
   true f32 arithmetic in another summation order, (bf16) 2e-2 of
   max|plain|; V rolled by one key and the values of the ragged last key
   tile scaled by 100 must each move it past 5x the tolerance; the bf16 conv
   2e-2 relative to the plain version's f32-accumulated result, as both
   round to bf16 at the same points but sum in another order, bit-identical
   twice, and the last tap zeroed, the bias dropped and the x rows of the
   last T tile scaled by 100 must each move it past 5x the tolerance; the bf16
   fused DiT block 2e-2 relative on its increment out - x (the residual
   would hide the attention), at the path's key lengths and at ragged
   ones, with fan-in scaled weights and a peaked softmax, and bit-identical
   twice.  The script also checks that zeroed attention and an unmasked key
   range each move that increment by more than 5x the tolerance; each DiT
   row holds its five launches' device times (a short torch.profiler pass)
   and the time of the same block as a chain of library calls.  The int8 /
   int4 kernels, with fan-in scaled random weights through the port's
   quantizer: matmul_int4
   1e-3 relative to max|plain| (both sides form the same exact bf16 x int4
   products with f32 sums, in another order), bit-identical twice, and at
   M <= 8 the contraction of its first slice only must move it past 5x the
   tolerance; the fused MLPs 2e-2 relative
   (their bf16 activation can differ by one bf16 step where the f32 sums
   differ), bit-identical twice; and swapped
   nibble planes, a zeroed gate or first projection, (int4) a second
   projection packed untiled, the Wd / W2 (packed) rows of the
   last slot of the kernel's plan zeroed and, at M = 42, the last 8 rows of
   x scaled by 100 must each move the output by more than 5x the
   tolerance.  Each gated row also times, for information, the same MLP as
   a chain of library calls (cuBLAS bf16 on weights dequantized once: x @
   Wgu, silu * mul, @ Wd) and as the port's own unfused chain (matmul_int8
   / matmul_int4 gate-up, silu * mul, down); each FFN row the library
   chain F.linear, silu, F.linear.  The rel-pos attention at the training
   shape (B=8, T=1599, H=8, dk=128), bf16 and f32, ragged lengths: o within
   2e-2 of max|plain| (bf16) or 1e-4 abs (f32), the LSE within 1e-4, the
   five gradients at the same tolerances of max|plain|, the forward and
   the backward bit-identical twice (the bf16 forward timed beside its
   library chain: torch.bmm for ac and bd, the gather skew, a masked
   softmax, torch.bmm with v; the bf16 backward beside that chain's
   backward under autograd); p zeroed, p shifted by one row, the lengths
   ignored and dp from one batch row must each move it past 5x the
   tolerance, and p shifted by one row must move the backward's dq_v and
   dp past it too.  Times are at the path's lengths, the backward's split
   by launch.  logits_int8 and matmul_int8 at every shape of step 8 and
   at M = 8: 1e-3 relative to max|plain| (the same exact bf16 x int8
   products with f32 sums, in another order), bit-identical twice; the
   scale rolled by one, the
   head's last 256 rows zeroed and the contraction of the first slice only
   must each move the output past 5x the tolerance;
10. prints a {"kernels": [...]} line, then, as the last line,
   {"ok": true, "device": {...}}.

    python3 chip_smoke.py --profile

adds torch.profiler traces of one reconstruction and of its flow, in each
tier one joint decode and one synthesis, one pipelined stream and one
step of stage 1, stage 2 and the flow: the
device's busy time, its idle share of the wall time, the kernels with the
most device time, and whether the trace holds every launch that the
kernels' counters saw (for information only: a trace that misses a launch
does not fail the run).  It also times the stage-2 loss with the
tensor-core head against the f32 head, with the table's f32 copy made
once and on every head call ("stage2_head_cost").

Any failed check ends the run with a non-zero exit code and no last line.
It imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import copy
import gc
import json
import os
import shutil
import signal
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F

from taste_spokenlm_tpu_torch import (from_pretrained, quant,
                                      save_pretrained)
from taste_spokenlm_tpu_torch.config import TasteConfig
from taste_spokenlm_tpu_torch.entry import dryrun_multichip, free_port
from taste_spokenlm_tpu_torch.frontend import streaming
from taste_spokenlm_tpu_torch.frontend.processor import (
    TasteProcessor, transcribe_with_fallback)
from taste_spokenlm_tpu_torch.kernels import (KERNEL_SOURCES, _build, conv1d,
                                              flash_attention, fused_dit,
                                              fused_mlp, int4_matmul,
                                              int8_matmul, launch_counts,
                                              relpos_attention,
                                              reset_launch_counts)
from taste_spokenlm_tpu_torch.models import bridges
from taste_spokenlm_tpu_torch.models import spoken_lm as spoken_lm_module
from taste_spokenlm_tpu_torch.models.audio_tower import TasteAudioTower
from taste_spokenlm_tpu_torch.models.conformer import ConformerEncoder
from taste_spokenlm_tpu_torch.models.flow import MaskedDiffWithXvec
from taste_spokenlm_tpu_torch.models.quantizer import QUANTIZER_CLASSES
from taste_spokenlm_tpu_torch.models.quantizer import Codebook as TasteCodebook
from taste_spokenlm_tpu_torch.models.sampler import (SamplerConfig,
                                                     build_sampler_tables)
from taste_spokenlm_tpu_torch.models.speech_decoder import TasteSpeechDecoder
from taste_spokenlm_tpu_torch.models.spoken_lm import TasteSpokenLM
from taste_spokenlm_tpu_torch.models.taslm import (TaslmConfig,
                                                   TaslmForCausalLM)
from taste_spokenlm_tpu_torch.models.taste import TasteForCausalLM
from taste_spokenlm_tpu_torch.models.whisper import WhisperForASR
from taste_spokenlm_tpu_torch.ops import losses
from taste_spokenlm_tpu_torch.ops.attention import (multi_head_attention,
                                                    padded_flash_attention)
from taste_spokenlm_tpu_torch.ops.audio import flow_mel, whisper_log_mel
from taste_spokenlm_tpu_torch.ops.quantized import (FUSED_MLP_MAX_ROWS,
                                                    INT4_KERNEL_MAX_ROWS)
from taste_spokenlm_tpu_torch.ops.remat import apply_remat
from taste_spokenlm_tpu_torch.ops.sampling import gumbel_noise
from taste_spokenlm_tpu_torch.parallel import mesh
from taste_spokenlm_tpu_torch.serving.server import (TasteEngine,
                                                     create_http_server,
                                                     run_load_test)
from taste_spokenlm_tpu_torch.scripts import (profile_fusion, profile_lmhead,
                                              serving_fidelity)
# seeded random weights at bench.py's scales (norms near 1, fan-in scaled
# DiT matrices, the Llama's RMSNorm at 0.01 x N(0, 1): its docstring says why)
from taste_spokenlm_tpu_torch.scripts.create_seed_model import (
    seed_state_dict as random_state_dict)
from taste_spokenlm_tpu_torch.train import optim, train_step
from taste_spokenlm_tpu_torch.train.trainer import Trainer, TrainerConfig
from taste_spokenlm_tpu_torch.utils.checkpoint import CheckpointManager

# NVIDIA H100 SXM data sheet (dense): HBM3 bytes/s, f32 outside the tensor
# cores, bf16 on the tensor cores
HBM_BPS = 3.35e12
F32_FLOPS = 67e12
BF16_FLOPS = 989e12

B, T_TOK, MAX_SPEECH, MEL_LEN_MAX = 1, 40, 512, 904
# kernel-vs-plain text logits on a shared greedy history, relative to
# max |logit|: between the bf16 floor (0.006-0.007 on an H100) and the
# effect of zeroed Llama MLPs (0.018) on the script's random weights
LOGIT_TOL = 1.2e-2
LM_STEPS, SYN_ASR = 64, 128        # joint decode budget; asr tokens, 2 a word


class CheckFailed(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


def log(obj) -> None:
    print(obj if isinstance(obj, str) else json.dumps(obj), flush=True)


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of fn() over `reps` calls after `warmup`: CUDA
    events around one call, enqueued behind a device sleep of about 2.5 ms,
    so the host's launch overhead is hidden and the events bracket the
    device work alone (a small kernel would otherwise time the Python
    wrapper)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(5_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def tensor_core_check() -> dict:
    """{group: {kernel: issues tensor-core instructions}} from the SASS
    (cuobjdump) of the built flash, rel-pos, DiT and fused-MLP libraries:
    every bf16 flash kernel, the bf16 rel-pos forward and the backward's
    three product kernels, every DiT GEMM and attention kernel and every
    tensor-core kernel of the gated MLPs and of the FFNs must issue HMMA;
    no f32 flash or rel-pos kernel may (those routes stay true f32), nor
    the one-row kernels.  No kernel of the gated MLPs or of the FFNs may
    issue I2F: their weights become floats by bit operations."""
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    i2f = {}

    def kernels(lib):
        sass = subprocess.run([tool, "-sass", _build.library_path(lib)],
                              capture_output=True, text=True,
                              check=True).stdout
        out = {}
        for chunk in sass.split("Function : ")[1:]:
            name = chunk.split("\n", 1)[0].strip()
            out[name] = "HMMA" in chunk or "HGMMA" in chunk
            i2f[name] = "I2F" in chunk
        return out
    flash, relpos, dit, mlp8, mlp4 = (
        kernels(lib) for lib in ("flash_attention", "relpos_attention",
                                 "fused_dit", "fused_mlp", "fused_mlp_int4"))
    # (kernels, expected number, must issue HMMA); "IfE" marks the float
    # instantiations of the rel-pos templates (forward and f32 backward);
    # in the int8 library "ILb0ELb0E" the gated MLP's kernels <Q4 = false,
    # FFN = false, ...> and "ILb0ELb1E" the FFN's <false, true, ...>, in
    # the int4 library "ILb1ELb0E" and "ILb1ELb1E"
    groups = {
        "flash bf16": ({n: u for n, u in flash.items()
                        if "flash_kernel_bf16" in n}, 3, True),
        "flash f32": ({n: u for n, u in flash.items()
                       if "flash_kernel_f32" in n}, 3, False),
        "relpos bf16 forward": ({n: u for n, u in relpos.items()
                                 if "fwd_kernel_mma" in n}, 1, True),
        "relpos bf16 backward": ({n: u for n, u in relpos.items()
                                  if "_kernel_mma" in n and "fwd" not in n},
                                 3, True),
        "relpos f32": ({n: u for n, u in relpos.items() if "IfE" in n}, 6,
                       False),
        "fused_dit": ({n: u for n, u in dit.items()
                       if "gemm_kernel" in n or "attn_kernel" in n}, 4, True),
        # gated_mlp_kernel<Q4, FFN, NC1, NC2> (M > 1),
        # gated_gemv_kernel<Q4, FFN> (M = 1)
        "gated int8 tensor cores": ({n: u for n, u in mlp8.items()
                                     if "gated_mlp_kernelILb0ELb0E" in n},
                                    6, True),
        "gated int4 tensor cores": ({n: u for n, u in mlp4.items()
                                     if "gated_mlp_kernelILb1ELb0E" in n},
                                    6, True),
        "ffn int8 tensor cores": ({n: u for n, u in mlp8.items()
                                   if "gated_mlp_kernelILb0ELb1E" in n},
                                  6, True),
        "ffn int4 tensor cores": ({n: u for n, u in mlp4.items()
                                   if "gated_mlp_kernelILb1ELb1E" in n},
                                  6, True),
        "gated int8 one row": ({n: u for n, u in mlp8.items()
                                if "gated_gemv_kernelILb0ELb0E" in n}, 1,
                               False),
        "gated int4 one row": ({n: u for n, u in mlp4.items()
                                if "gated_gemv_kernelILb1ELb0E" in n}, 1,
                               False),
        "ffn int8 one row": ({n: u for n, u in mlp8.items()
                              if "gated_gemv_kernelILb0ELb1E" in n}, 1,
                             False),
        "ffn int4 one row": ({n: u for n, u in mlp4.items()
                              if "gated_gemv_kernelILb1ELb1E" in n}, 1,
                             False),
    }
    for what, (uses, n, hmma) in groups.items():
        check(len(uses) == n and all(u == hmma for u in uses.values()),
              f"{what} kernels: expected {n}, "
              f"{'all' if hmma else 'none'} with tensor-core instructions: "
              f"{uses}")
        if what.startswith(("gated", "ffn")):
            check(not any(i2f[k] for k in uses),
                  f"{what} kernels convert integers with I2F: "
                  f"{[k for k in uses if i2f[k]]}")
    return {what: uses for what, (uses, _, _) in groups.items()}


def sublaunch_us(fn, labels, calls: int = 10) -> dict:
    """Device microseconds of each launch of one fn() call, from a
    torch.profiler trace of `calls` calls after a warm-up: {label: us}, the
    labels naming the call's launches in their order.  If the trace does not
    hold exactly len(labels) launches a call (the profiler can drop an
    event), {kernel name: us per call} instead."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = sorted((e for e in prof.events()
                     if e.device_type == DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    out = {}
    if len(events) == calls * len(labels):
        for i, e in enumerate(events):
            key = labels[i % len(labels)]
            out[key] = out.get(key, 0.0) + e.time_range.elapsed_us() / calls
        return out
    for e in events:
        key = e.name.replace("(anonymous namespace)::", "").split("(")[0]
        out[key] = out.get(key, 0.0) + e.time_range.elapsed_us() / calls
    return out


DIT_LAUNCHES = ("ln1_qkv", "attention", "out_proj_residual", "ln3_mlp_in_gelu",
                "mlp_out_residual")
# the wrapper clamps the lengths (one elementwise launch), then five kernels
RELPOS_BWD_LAUNCHES = ("lengths_clamp", "delta", "dq", "dk_dv", "dp_windows",
                       "dp_sum")


def dit_params(cfg: TasteConfig, randn) -> dict:
    """One DiT block's flax-layout parameters at the flow's widths: fan-in
    scaled weights with q/k at gain 2, so the softmax is peaked and the
    attention branch is as large as the MLP branch."""
    f = cfg.flow
    c, inner = f.estimator_channels[-1], \
        f.estimator_num_heads * f.estimator_attention_head_dim
    w = lambda n_in, n_out, gain=1.0: randn(  # noqa: E731
        n_in, n_out, scale=gain * n_in ** -0.5)
    vec = lambda n, base=0.0: base + randn(n, scale=0.1)  # noqa: E731
    return {"norm1": {"scale": vec(c, 1.0), "bias": vec(c)},
            "attn1": {"to_q": {"kernel": w(c, inner, 2.0)},
                      "to_k": {"kernel": w(c, inner, 2.0)},
                      "to_v": {"kernel": w(c, inner)},
                      "to_out": {"kernel": w(inner, c), "bias": vec(c)}},
            "norm3": {"scale": vec(c, 1.0), "bias": vec(c)},
            "ff_in": {"kernel": w(c, 4 * c), "bias": vec(4 * c)},
            "ff_out": {"kernel": w(4 * c, c), "bias": vec(c)}}


def dit_library_chain(params, heads: int, hd: int):
    """The DiT block as a chain of PyTorch library calls in bf16 (a yardstick
    for the fused kernel, not one call and not its numerics): F.layer_norm,
    F.linear (qkv), SDPA with the key mask, F.linear + residual,
    F.layer_norm, F.linear, F.gelu, F.linear + residual."""
    at = params["attn1"]
    w_qkv = torch.cat([at[n]["kernel"] for n in ("to_q", "to_k", "to_v")],
                      dim=1).t().contiguous()
    w_o = at["to_out"]["kernel"].t().contiguous()
    w_1 = params["ff_in"]["kernel"].t().contiguous()
    w_2 = params["ff_out"]["kernel"].t().contiguous()

    def run(x, lengths):
        b, t, c = x.shape
        h = F.layer_norm(x, (c,), params["norm1"]["scale"],
                         params["norm1"]["bias"], 1e-5)
        q, k, v = F.linear(h, w_qkv).view(b, t, 3, heads, hd).permute(
            2, 0, 3, 1, 4)
        keep = (torch.arange(t, device=x.device)[None, :]
                < lengths[:, None])[:, None, None, :]
        o = F.scaled_dot_product_attention(q, k, v, attn_mask=keep)
        x = x + F.linear(o.transpose(1, 2).reshape(b, t, heads * hd), w_o,
                         at["to_out"]["bias"])
        h = F.layer_norm(x, (c,), params["norm3"]["scale"],
                         params["norm3"]["bias"], 1e-5)
        f = F.gelu(F.linear(h, w_1, params["ff_in"]["bias"]))
        return x + F.linear(f, w_2, params["ff_out"]["bias"])
    return run


def bound_ms(n_bytes: float, flops: float, peak_flops: float):
    t_bytes, t_ops = n_bytes / HBM_BPS * 1e3, flops / peak_flops * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


# ---------------------------------------------------------------------------
# the shapes each kernel sees in one reconstruction, from the config
# ---------------------------------------------------------------------------


def flash_shapes(cfg: TasteConfig, n_frames: int, b: int = B,
                 dtype: str = "float32"):
    w = cfg.audio_tower.whisper
    t = (n_frames + 1) // 2
    if not flash_attention.can_use_flash(t, t):
        return {}
    return {(b, t, w.encoder_heads, w.d_model // w.encoder_heads, dtype):
            w.encoder_layers}


def dit_shapes(cfg: TasteConfig, mel_len: int, t_mel: int = MEL_LEN_MAX):
    """{(T, valid keys): launches} of the fused DiT block in one flow
    inference over `t_mel` frames, `mel_len` of them valid: the U-Net
    halves T once per down block but the last; 2B rows per call (CFG)."""
    f = cfg.flow
    inner = f.estimator_num_heads * f.estimator_attention_head_dim
    n_ch = len(f.estimator_channels)
    ts, valids = [t_mel], [mel_len]
    for _ in range(n_ch - 1):
        ts.append((ts[-1] + 1) // 2)
        valids.append((valids[-1] + 1) // 2)
    per_call = {}

    def add(level, n):
        key = (ts[level], valids[level])
        c = f.estimator_channels[min(level, n_ch - 1)]
        if fused_dit.can_use_fused_dit(key[0], c, inner):
            per_call[key] = per_call.get(key, 0) + n
    for i in range(n_ch):                       # down path
        add(i, f.estimator_n_blocks)
    add(n_ch - 1, f.estimator_num_mid_blocks * f.estimator_n_blocks)
    for i in range(n_ch):                       # up path
        add(n_ch - 1 - i, f.estimator_n_blocks)
    return {k: v * f.n_timesteps for k, v in per_call.items()}


def conv_shapes(cfg: TasteConfig, t_mel: int = MEL_LEN_MAX):
    """{(C, T, K, D): launches} of conv1d_same in HiFT's ResBlocks over
    `t_mel` mel frames (the kernel takes T >= 4096 only)."""
    h = cfg.hift
    shapes = {}
    t = t_mel
    for i, (u, k) in enumerate(zip(h.upsample_rates, h.upsample_kernel_sizes)):
        ch = h.base_channels // (2 ** (i + 1))
        t = (t - 1) * u + k - 2 * ((k - u) // 2)
        if i == len(h.upsample_rates) - 1:
            t += 1                              # reflection pad (1, 0)
        if ch % 128 or t < 4096:
            continue
        blocks = list(zip(h.resblock_kernel_sizes, h.resblock_dilation_sizes))
        blocks.append((h.source_resblock_kernel_sizes[i],
                       h.source_resblock_dilation_sizes[i]))
        for k_r, dils in blocks:
            for d in dils:
                for key in ((ch, t, k_r, d), (ch, t, k_r, 1)):
                    shapes[key] = shapes.get(key, 0) + 1
    return shapes


# ---------------------------------------------------------------------------
# kernels against their plain versions
# ---------------------------------------------------------------------------


def kernel_rows(cfg: TasteConfig, dev, gen, launches: dict):
    """Each kernel against its plain version at the shapes of the counted
    runs (`launches`: {kernel: {shape: launches}}); -> (name, source,
    replaces, tolerance, per-shape rows)."""
    rows = []
    profiled = []       # (shape row, call, launch labels, calls): traced last

    def randn(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    # flash attention: f32 in the serving tower, bf16 in the training one.
    # Reach: V rolled by one key, and the values of the ragged last key
    # tile (T % 64 keys) scaled by 100, must each move the output past 5x
    # the tolerance (a kernel that drops or mis-masks that tile fails)
    shapes = []
    for (b, t, h, d, dt), n in sorted(launches["flash_attention"].items()):
        f32 = dt == "float32"
        q, k, v = (randn(b, t, h, d, dtype=getattr(torch, dt))
                   for _ in range(3))
        out = flash_attention.flash_attention(q, k, v)
        ref = flash_attention.flash_attention_plain(q, k, v)
        torch.cuda.synchronize()

        def moved(o):     # the gate's measure: max abs (f32), rel (bf16)
            e = (o.float() - ref.float()).abs().max().item()
            return e if f32 else e / ref.float().abs().max().item()
        err = (out.float() - ref.float()).abs().max().item()
        rel = err / ref.float().abs().max().item()
        tol = 1e-4 if f32 else 2e-2
        check((err if f32 else rel) <= tol,
              f"flash_attention err {err} (rel {rel}) > {tol} ({dt}, shape "
              f"{[b, t, h, d]})")
        ragged = t % 64 or 64
        v_tail = v.clone()
        v_tail[:, -ragged:] *= 100
        reach = {"V rolled by one key": moved(
                     flash_attention.flash_attention_plain(
                         q, k, v.roll(1, dims=1))),
                 f"last {ragged} keys' values x 100": moved(
                     flash_attention.flash_attention_plain(q, k, v_tail))}
        for what, e in reach.items():
            check(e > 5 * tol, f"flash_attention check too blunt ({dt}): "
                               f"{what} moves it only {e}")
        qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))
        bnd, by = bound_ms((4 if f32 else 2) * 4 * b * t * h * d,
                           4 * b * h * t * t * d,
                           F32_FLOPS if f32 else BF16_FLOPS)
        shapes.append({
            "shape": [b, t, h, d], "dtype": dt, "launches": n,
            "max_abs_err": err, "rel_err": rel, "broken_input": reach,
            "ms": time_ms(lambda: flash_attention.flash_attention(q, k, v)),
            "plain_ms": time_ms(
                lambda: flash_attention.flash_attention_plain(q, k, v)),
            "library_ms": time_ms(
                lambda: F.scaled_dot_product_attention(qh, kh, vh)),
            "bound_ms": bnd, "bound_by": by})
    rows.append(("flash_attention", "taste_spokenlm_tpu_torch/csrc/flash_attention.cu",
                 "taste_spokenlm_tpu/ops/pallas/flash_attention.py:120",
                 "max abs err <= 1e-4 (f32); rel err <= 2e-2 of max|plain| "
                 "(bf16)", shapes))

    # fused DiT block, bf16 (dit_params: a peaked softmax and an attention
    # branch as large as the MLP's).  The error is taken on the block's
    # increment (out - x), which a wrong attention or key mask moves by far
    # more than the tolerance (the residual x alone would hide both); the
    # output must repeat bit for bit.  Each row also holds each of the five
    # launches' device time (a short torch.profiler pass) and the time of
    # the same block as a chain of library calls (not one call, so
    # library_ms stays null)
    f = cfg.flow
    c, heads, hd = f.estimator_channels[-1], f.estimator_num_heads, \
        f.estimator_attention_head_dim
    inner = heads * hd
    params = dit_params(cfg, randn)
    no_attn = {**params, "attn1": {**params["attn1"], "to_v": {
        "kernel": torch.zeros_like(params["attn1"]["to_v"]["kernel"])}}}
    n_weights = sum(v.numel() for sub in params.values()
                    for v in _leaves(sub))
    block = lambda fn, x, lens, p=params: fn(  # noqa: E731
        x, lens, p, heads=heads, head_dim=hd)
    chain = dit_library_chain(params, heads, hd)
    shapes = []
    for (t, valid), n in sorted(launches["fused_dit_block"].items()):
        x = randn(2 * B, t, c, scale=0.5)
        lengths = torch.full((2 * B,), valid, dtype=torch.int32, device=dev)
        # the path's lengths, and ragged ones with half the keys masked
        ragged = torch.tensor([valid] * (2 * B - 1) + [t // 2],
                              dtype=torch.int32, device=dev)
        errs = []
        for lens in (lengths, ragged):
            ref = block(fused_dit.fused_dit_block_plain, x, lens)
            out = block(fused_dit.fused_dit_block, x, lens)
            err, rel = increment_err(out, ref, x, lens)
            check(rel <= 2e-2, f"fused_dit_block increment rel err {rel} > "
                               f"2e-2 at T={t}, lengths {lens.tolist()}")
            check(torch.equal(block(fused_dit.fused_dit_block, x, lens), out),
                  f"fused_dit_block is not bit-identical twice at T={t}, "
                  f"lengths {lens.tolist()}")
            errs.append((err, rel))
        # the check sees the attention (values zeroed) and the key mask
        # (the ragged rows unmasked): each moves the increment past it
        attn_effect = increment_err(
            block(fused_dit.fused_dit_block_plain, x, ragged, no_attn),
            ref, x, ragged)[1]
        mask_effect = increment_err(
            block(fused_dit.fused_dit_block_plain, x,
                  torch.full_like(ragged, t)), ref, x, ragged)[1]
        check(min(attn_effect, mask_effect) > 5 * 2e-2,
              f"fused_dit_block check too blunt at T={t}: zeroed attention "
              f"moves it {attn_effect}, an unmasked key range {mask_effect}")
        m = 2 * B * t
        flops = (2 * m * c * 3 * inner + 4 * 2 * B * heads * t * valid * hd
                 + 2 * m * inner * c + 2 * 2 * m * c * 4 * c)
        bnd, by = bound_ms(2 * (2 * m * c + n_weights), flops, BF16_FLOPS)
        shapes.append({
            "shape": [2 * B, t, c], "valid_keys": valid,
            "ragged_keys": ragged.tolist(), "dtype": "bfloat16",
            "launches": n, "max_abs_err": max(e for e, _ in errs),
            "rel_err": max(r for _, r in errs), "repeat_identical": True,
            "zeroed_attention_rel": attn_effect,
            "unmasked_keys_rel": mask_effect,
            "ms": time_ms(lambda: block(fused_dit.fused_dit_block, x, lengths)),
            "plain_ms": time_ms(
                lambda: block(fused_dit.fused_dit_block_plain, x, lengths)),
            "library_chain_ms": time_ms(lambda: chain(x, lengths)),
            "library_ms": None, "bound_ms": bnd, "bound_by": by})
        profiled.append((shapes[-1], lambda x=x, lengths=lengths: block(
            fused_dit.fused_dit_block, x, lengths), DIT_LAUNCHES, 10))
    rows.append(("fused_dit_block", "taste_spokenlm_tpu_torch/csrc/fused_dit.cu",
                 "taste_spokenlm_tpu/ops/pallas/fused_dit.py:110",
                 "rel err of the increment out - x <= 2e-2 over valid rows, "
                 "path and ragged lengths (bf16); bit-identical twice", shapes))

    # conv1d same, bf16, channels-last, the bias added in the kernel's
    # epilogue; bit-identical twice.  Reach, each past 5x the tolerance:
    # the last tap's weights zeroed, the bias dropped, and the x rows of
    # the last T tile (ragged at T = 57857) scaled by 100.  The bias is at
    # 0.3 so that dropping it shows
    shapes = []
    for (ch, t, k, d), n in launches["conv1d_same"].items():
        x = randn(B, t, ch)
        w = randn(k, ch, ch, scale=0.02)
        bias = randn(ch, scale=0.3)
        w_oik = w.permute(2, 1, 0).contiguous()
        out = conv1d.conv1d_same(x, w, bias, dilation=d)
        ref = conv1d.conv1d_same_plain(x, w, bias, dilation=d)
        torch.cuda.synchronize()
        ref_max = ref.float().abs().max().item()
        err = (out.float() - ref.float()).abs().max().item()
        rel = err / ref_max
        check(rel <= 2e-2, f"conv1d_same rel err {rel} > 2e-2 at "
                           f"C={ch} T={t} K={k} D={d}")
        check(torch.equal(conv1d.conv1d_same(x, w, bias, dilation=d), out),
              f"conv1d_same is not bit-identical twice at C={ch} T={t} "
              f"K={k} D={d}")
        tile = conv1d.TILES[conv1d.tile_for(t, ch, ch, _build.sm_count(dev))]
        bm = tile[0]
        last_tap = w.clone()
        last_tap[-1] = 0
        tail = x.clone()
        tail[:, (t - 1) // bm * bm:] *= 100
        reach = {}
        for what, (xb, wb, bb) in {
                "last tap zeroed": (x, last_tap, bias),
                "bias dropped": (x, w, None),
                f"x rows of the last {bm}-row T tile x 100": (tail, w, bias),
        }.items():
            moved = conv1d.conv1d_same_plain(xb, wb, bb, dilation=d)
            reach[what] = ((moved.float() - ref.float()).abs().max().item()
                           / ref_max)
            check(reach[what] > 5 * 2e-2,
                  f"conv1d_same check too blunt at C={ch} T={t} K={k} D={d}: "
                  f"{what} moves it only {reach[what]}")
        pad = (k - 1) * d // 2
        bnd, by = bound_ms(2 * (2 * B * t * ch + k * ch * ch + ch),
                           2 * B * t * ch * ch * k, BF16_FLOPS)
        shapes.append({
            "shape": [B, t, ch], "K": k, "D": d, "dtype": "bfloat16",
            "launches": n, "max_abs_err": err, "rel_err": rel,
            "broken_input_rel": reach, "tile_rows_channels_warps_chunk": tile,
            "ms": time_ms(lambda: conv1d.conv1d_same(x, w, bias, dilation=d)),
            "plain_ms": time_ms(lambda: conv1d.conv1d_same_plain(
                x, w, bias, dilation=d)),
            "library_ms": time_ms(lambda: F.conv1d(
                x.transpose(1, 2), w_oik, bias, padding=pad, dilation=d)),
            "bound_ms": bnd, "bound_by": by})
    rows.append(("conv1d_same", "taste_spokenlm_tpu_torch/csrc/conv1d.cu",
                 "taste_spokenlm_tpu/ops/pallas/conv1d.py:45",
                 "rel err <= 2e-2 (bf16); bit-identical twice", shapes))
    rows.extend(quantized_kernel_rows(cfg, dev, gen, launches, randn))
    rows.extend(relpos_kernel_rows(dev, gen, launches, profiled))
    # the profiler passes last: a process that has run the profiler
    # dispatches slower, which would inflate the host-bound plain times
    for shape, fn, labels, calls in profiled:
        shape["sublaunch_us"] = sublaunch_us(fn, labels, calls)
    return rows


def quantized_kernel_rows(cfg: TasteConfig, dev, gen, launches: dict, randn):
    """The fused int8 / int4 MLPs and the int4 products against their plain
    versions, with fan-in scaled random weights through the port's
    quantizer, each with reach checks: a broken input (a zeroed gate,
    swapped nibble planes, a second projection packed untiled) must move
    the output by more than 5x the tolerance."""
    def weights(n_in, n_out):
        return torch.randn(n_in, n_out, generator=gen, device=dev) * n_in ** -0.5

    def q8(n_in, n_out):
        q = quant.quantize_kernel(weights(n_in, n_out))
        return q["base_q"], q["base_scale"]

    def rel(out, ref):
        return ((out - ref).abs().max() / ref.abs().max()).item()

    def swap(wp):
        return ((wp >> 4) | (wp << 4)).contiguous()

    def row(kernel, plain, args, broken, tol, n, n_bytes, flops,
            library=None, repeat=False, **extra):
        out, ref = kernel(*args), plain(*args)
        torch.cuda.synchronize()
        err = rel(out, ref)
        m = args[0].shape[0]
        check(err <= tol, f"{kernel.__name__} rel err {err} > {tol} at M={m}")
        if repeat:
            check(torch.equal(kernel(*args), out),
                  f"{kernel.__name__} is not bit-identical twice at M={m}")
        reach = {}
        for what, broken_args in broken.items():
            reach[what] = rel(plain(*broken_args), ref)
            check(reach[what] > 5 * tol,
                  f"{kernel.__name__} check too blunt at M={m}: {what} moves "
                  f"it only {reach[what]}")
        bnd, by = bound_ms(n_bytes, flops, BF16_FLOPS)
        return {"launches": n, "max_abs_err": (out - ref).abs().max().item(),
                "rel_err": err, "broken_input_rel": reach,
                "ms": time_ms(lambda: kernel(*args)),
                "plain_ms": time_ms(lambda: plain(*args)),
                "library_ms": None if library is None else time_ms(library),
                "bound_ms": bnd, "bound_by": by, **extra}

    def by_weight(kernel):
        """{(d_in, d_out): {rows: launches}} from {(rows, d_in, d_out): n}."""
        grouped = {}
        for (m, d_in, d_out), n in launches[kernel].items():
            grouped.setdefault((d_in, d_out), {})[m] = n
        return sorted(grouped.items())

    out = []
    s3 = cfg.speech_decoder.llm
    sms = _build.sm_count(dev)

    def gated_broken(x, args, start, rows_from):
        """The gated reach checks: Wd's rows from `start` (the last slot)
        zeroed, and at M = 42 the last 8 rows of x scaled by 100."""
        wd = args[4].clone()
        wd[start:] = 0
        broken = {f"Wd rows of the last slot ({start}:) zeroed":
                  (x, *args[:4], wd, args[5])}
        if x.shape[0] == 42:
            far = x.clone()
            far[rows_from:] *= 100
            broken["last 8 rows of x x 100"] = (far, *args)
        return broken

    def chains(x, i, gu, gu_scale, down, down_scale, w16_gu, w16_d, mm):
        """{library_chain_ms, port_chain_ms}: the MLP as cuBLAS bf16 on
        weights dequantized once, and as the port's unfused GEMVs `mm`."""
        def library():
            g_u = x @ w16_gu
            return (F.silu(g_u[:, :i]) * g_u[:, i:]) @ w16_d

        def port():
            g_u = mm(x, gu, gu_scale)
            return mm(F.silu(g_u[:, :i]) * g_u[:, i:], down, down_scale)
        return {"library_chain_ms": time_ms(library),
                "port_chain_ms": time_ms(port),
                "library_call": "x_bf16 @ Wgu_bf16, silu * mul, @ Wd_bf16 "
                                "(cuBLAS, weights dequantized once); "
                                "library_ms null: no one call"}

    shapes = []
    for (h, i), per_m in by_weight("gated_mlp_int8"):
        (wg, sg), (wu, su), (wd, sd) = q8(h, i), q8(h, i), q8(i, h)
        wgu, sgu = torch.cat([wg, wu], 1).contiguous(), torch.cat([sg, su])
        w16_gu = (wgu.float() * sgu).to(torch.bfloat16)
        w16_d = (wd.float() * sd).to(torch.bfloat16)
        for m, n in sorted(per_m.items()):
            x = randn(m, h)
            plan, _, start = fused_mlp.gated_geometry(m, h, i, sms)
            args = (wg, sg, wu, su, wd, sd)
            shapes.append(row(
                fused_mlp.gated_mlp_int8, fused_mlp.gated_mlp_int8_plain,
                (x, *args),
                {"zeroed gate weights": (x, torch.zeros_like(wg), sg, wu, su,
                                         wd, sd),
                 **gated_broken(x, args, start, m - 8)}, 2e-2, n,
                3 * h * i + 4 * (2 * i + h) + m * h * (2 + 4),
                3 * 2 * m * h * i, repeat=True, shape=[m, h, i],
                cluster_cols_slots=plan,
                **chains(x, i, wgu, sgu, wd, sd, w16_gu, w16_d,
                         int8_matmul.matmul_int8)))
        del wg, wu, wd, wgu, w16_gu, w16_d
    out.append(("gated_mlp_int8", "taste_spokenlm_tpu_torch/csrc/fused_mlp.cu",
                "taste_spokenlm_tpu/ops/pallas/fused_mlp.py:102",
                "rel err <= 2e-2 of max|plain| (bf16 activation)", shapes))

    d, i = s3.output_size, s3.linear_units
    (w1, s1), (w2, s2) = q8(d, i), q8(i, d)
    b1 = 0.1 * torch.randn(i, generator=gen, device=dev)
    b2 = 0.1 * torch.randn(d, generator=gen, device=dev)
    # the library chain: F.linear on weights dequantized to bf16 once, the
    # activation, F.linear
    w16_1 = (w1.float() * s1).t().contiguous().to(torch.bfloat16)
    w16_2 = (w2.float() * s2).t().contiguous().to(torch.bfloat16)
    b16_1, b16_2 = b1.to(torch.bfloat16), b2.to(torch.bfloat16)
    shapes = []
    for m, n in sorted(launches["ffn_int8"].items()):
        x = randn(m, d)
        plan, _, start = fused_mlp.gated_geometry(m, d, i, sms, ffn=True)
        w2_cut = w2.clone()
        w2_cut[start:] = 0
        shapes.append(row(
            fused_mlp.ffn_int8, fused_mlp.ffn_int8_plain,
            (x, w1, s1, b1, w2, s2, b2),
            {"zeroed first-projection weights": (
                x, torch.zeros_like(w1), s1, b1, w2, s2, b2),
             f"W2 rows of the last slot ({start}:) zeroed": (
                x, w1, s1, b1, w2_cut, s2, b2)}, 2e-2, n,
            2 * d * i + 4 * (2 * i + 2 * d) + m * d * (2 + 4), 2 * 2 * m * d * i,
            repeat=True, shape=[m, d, i], cluster_cols_slots=plan,
            library_chain_ms=time_ms(lambda x=x: F.linear(
                F.silu(F.linear(x, w16_1, b16_1)), w16_2, b16_2)),
            library_call="F.linear(x, W1_bf16, b1), silu, F.linear(., "
                         "W2_bf16, b2) (cuBLAS, weights dequantized once); "
                         "library_ms null: no one call"))
        del w2_cut
    del w16_1, w16_2
    out.append(("ffn_int8", "taste_spokenlm_tpu_torch/csrc/fused_mlp.cu",
                "taste_spokenlm_tpu/ops/pallas/fused_mlp.py:383",
                "rel err <= 2e-2 of max|plain| (bf16 activation)", shapes))

    # int4: the second projection packed per tile, as quant.py packs it;
    # the same float weights packed untiled are the third broken input
    def q4(n_in, n_out, tiled=False):
        w = weights(n_in, n_out)
        if not tiled:
            return int4_matmul.quantize_int4(w)
        tile = fused_mlp.mlp_tile(n_in)
        return (*fused_mlp.quantize_int4_tiled(w, tile),
                *int4_matmul.quantize_int4(w), n_in // tile)

    def nbytes4(n_in, n_out):         # packed nibbles and their f32 scales
        return n_in * n_out // 2 + 4 * n_in * n_out // int4_matmul._group(n_in)

    shapes = []
    for (h, i), per_m in by_weight("gated_mlp_int4"):
        (wg, sg), (wu, su) = q4(h, i), q4(h, i)
        wd, sd, wd_flat, sd_flat, n_tiles = q4(i, h, tiled=True)
        tile = fused_mlp.mlp_tile(i)
        wgu, sgu = (torch.cat([wg, wu], 1).contiguous(),
                    torch.cat([sg, su], 1).contiguous())
        w16_gu = int4_matmul.dequantize_int4(wgu, sgu).to(torch.bfloat16)
        w16_d = fused_mlp.dequantize_int4_tiled(wd, sd, tile).to(
            torch.bfloat16)
        for m, n in sorted(per_m.items()):
            x = randn(m, h)
            plan, _, start = fused_mlp.gated_geometry(
                m, h, i, sms, tile, (h // 2) // (sg.shape[0] // 2),
                sd.shape[0] // (i // tile))
            args = (wg, sg, wu, su, wd, sd)
            shapes.append(row(
                fused_mlp.gated_mlp_int4, fused_mlp.gated_mlp_int4_plain,
                (x, *args), {
                    "zeroed gate weights": (x, torch.zeros_like(wg), sg, wu,
                                            su, wd, sd),
                    "swapped nibble planes of wd": (x, wg, sg, wu, su,
                                                    swap(wd), sd),
                    f"wd packed untiled ({n_tiles} tiles)": (
                        x, wg, sg, wu, su, wd_flat, sd_flat),
                    **gated_broken(x, args, start, m - 8)}, 2e-2, n,
                2 * nbytes4(h, i) + nbytes4(i, h) + m * h * (2 + 4),
                3 * 2 * m * h * i, repeat=True, shape=[m, h, i],
                cluster_cols_slots=plan,
                **chains(x, i, wgu, sgu, wd_flat, sd_flat, w16_gu, w16_d,
                         int4_matmul.matmul_int4)))
        del wg, wu, wd, wgu, w16_gu, w16_d
    out.append(("gated_mlp_int4",
                "taste_spokenlm_tpu_torch/csrc/fused_mlp_int4.cu",
                "taste_spokenlm_tpu/ops/pallas/fused_mlp.py:192",
                "rel err <= 2e-2 of max|plain| (bf16 activation)", shapes))

    d, i = s3.output_size, s3.linear_units
    w1, s1 = q4(d, i)
    w2, s2, w2_flat, s2_flat, n_tiles = q4(i, d, tiled=True)
    tile = fused_mlp.mlp_tile(i)
    w16_1 = int4_matmul.dequantize_int4(w1, s1).t().contiguous().to(
        torch.bfloat16)
    w16_2 = fused_mlp.dequantize_int4_tiled(w2, s2, tile).t().contiguous().to(
        torch.bfloat16)
    shapes = []
    for m, n in sorted(launches["ffn_int4"].items()):
        x = randn(m, d)
        plan, _, start = fused_mlp.gated_geometry(
            m, d, i, sms, tile, (d // 2) // (s1.shape[0] // 2),
            s2.shape[0] // (i // tile), ffn=True)
        w2_cut = w2.clone()
        w2_cut[start:] = 0
        shapes.append(row(
            fused_mlp.ffn_int4, fused_mlp.ffn_int4_plain,
            (x, w1, s1, b1, w2, s2, b2), {
                "zeroed first-projection weights": (
                    x, torch.zeros_like(w1), s1, b1, w2, s2, b2),
                "swapped nibble planes of w2": (x, w1, s1, b1, swap(w2), s2,
                                                b2),
                f"w2 packed untiled ({n_tiles} tiles)": (
                    x, w1, s1, b1, w2_flat, s2_flat, b2),
                f"W2 packed rows of the last slot ({start}:) zeroed": (
                    x, w1, s1, b1, w2_cut, s2, b2)}, 2e-2, n,
            nbytes4(d, i) + nbytes4(i, d) + 4 * (i + d) + m * d * (2 + 4),
            2 * 2 * m * d * i, repeat=True, shape=[m, d, i],
            cluster_cols_slots=plan,
            library_chain_ms=time_ms(lambda x=x: F.linear(
                F.silu(F.linear(x, w16_1, b16_1)), w16_2, b16_2)),
            library_call="F.linear(x, W1_bf16, b1), silu, F.linear(., "
                         "W2_bf16, b2) (cuBLAS, weights dequantized once); "
                         "library_ms null: no one call"))
        del w2_cut
    del w16_1, w16_2
    out.append(("ffn_int4", "taste_spokenlm_tpu_torch/csrc/fused_mlp_int4.cu",
                "taste_spokenlm_tpu/ops/pallas/fused_mlp.py:312",
                "rel err <= 2e-2 of max|plain| (bf16 activation)", shapes))

    # matmul_int4, bit-identical twice; at M <= 8 the contraction of the
    # first slice alone (both nibble planes' rows of it) must move the
    # output past 5x the tolerance, as a second pass that sums one slice
    # would
    shapes = []
    for (d, n_out), per_m in by_weight("matmul_int4"):
        wp, scale = q4(d, n_out)
        w16 = int4_matmul.dequantize_int4(wp, scale).to(torch.bfloat16)
        group = int4_matmul._group(d)
        for m, n in sorted(per_m.items()):
            # the tied head takes the kernel at any row count (TASLM's
            # scoring: 512 rows); the projections up to 256
            check(m <= INT4_KERNEL_MAX_ROWS
                  or n_out == cfg.spoken_lm.llama.vocab_size,
                  f"matmul_int4 at M={m}")
            x = randn(m, d)
            broken = {"swapped nibble planes": (x, swap(wp), scale)}
            plan = None
            if m <= int4_matmul.SPLIT_MAX_ROWS:
                plan = int4_matmul.split_plan(m, d, n_out, group,
                                              _build.sm_count(dev))
                rows = plan[2]
                if rows < d // 2:
                    first = x.clone()
                    first[:, rows:d // 2] = 0
                    first[:, d // 2 + rows:] = 0
                    broken[f"first of {-(-d // 2 // rows)} slices only"] = (
                        first, wp, scale)
            shapes.append(row(
                int4_matmul.matmul_int4, int4_matmul.matmul_int4_plain,
                (x, wp, scale), broken, 1e-3, n,
                nbytes4(d, n_out) + m * (2 * d + 4 * n_out),
                2 * m * d * n_out, library=lambda: x @ w16, repeat=True,
                shape=[m, d, n_out], lane_bytes_threads_slice_rows=plan,
                library_call="x_bf16 @ W_bf16 (dequantized once)"))
        del wp, scale, w16
    out.append(("matmul_int4", "taste_spokenlm_tpu_torch/csrc/int4_matmul.cu",
                "taste_spokenlm_tpu/ops/pallas/int4_matmul.py:114",
                "rel err <= 1e-3 of max|plain|; bit-identical twice", shapes))

    # int8 weight-only products: int8 in [-127, 127] with the tools' scales
    # (the head's abs(N) * 0.01 + 0.005, the projections' (U + 0.5) / 127),
    # at every shape of the decode-layout path and at M = 8.  Reach: the
    # scale rolled by one; the head's last 256 table rows zeroed (the
    # ragged end of V = 125 * 1024 + 256); where split_plan splits
    # matmul_int8, the contraction of the first slice only (what the last
    # block on a column tile gives if it adds one slice)
    def i8(n_rows, n_cols):
        return torch.randint(-127, 128, (n_rows, n_cols), generator=gen,
                             device=dev, dtype=torch.int8)

    shapes = []
    for (d, v), per_m in by_weight("logits_int8"):
        table = i8(v, d)
        scale = torch.randn(v, generator=gen, device=dev).abs() * 0.01 + 0.005
        zeroed = table.clone()
        zeroed[-256:] = 0
        w16 = (table.float() * scale[:, None]).to(torch.bfloat16)
        for m, n in sorted({8: 0, **per_m}.items()):
            x = randn(m, d, scale=0.1)
            shapes.append(row(
                int8_matmul.logits_int8, int8_matmul.logits_int8_plain,
                (x, table, scale), {
                    "scale rolled by one": (x, table, scale.roll(1)),
                    "last 256 table rows zeroed": (x, zeroed, scale)},
                1e-3, n, v * d + 4 * v + m * (2 * d + 4 * v), 2 * m * d * v,
                library=lambda: F.linear(x, w16), repeat=True,
                shape=[m, d, v],
                library_call="F.linear(x_bf16, W_bf16) (dequantized once)"))
        del table, zeroed, w16
    out.append(("logits_int8", "taste_spokenlm_tpu_torch/csrc/int8_matmul.cu",
                "taste_spokenlm_tpu/ops/pallas/int8_matmul.py:46",
                "rel err <= 1e-3 of max|plain|; bit-identical twice", shapes))

    shapes = []
    for (d, n_out), per_m in by_weight("matmul_int8"):
        w = i8(d, n_out)
        scale = (torch.rand(n_out, generator=gen, device=dev) + 0.5) / 127.0
        w16 = (w.float() * scale).to(torch.bfloat16)
        for m, n in sorted({8: 0, **per_m}.items()):
            x = randn(m, d)
            plan = int8_matmul.split_plan(m, d, n_out, _build.sm_count(dev))
            rows = plan[2]
            broken = {"scale rolled by one": (x, w, scale.roll(1))}
            if rows < d:
                first = x.clone()
                first[:, rows:] = 0
                broken[f"first of {-(-d // rows)} slices only"] = (first, w,
                                                                   scale)
            shapes.append(row(
                int8_matmul.matmul_int8, int8_matmul.matmul_int8_plain,
                (x, w, scale), broken, 1e-3, n,
                d * n_out + 4 * n_out + m * (2 * d + 4 * n_out),
                2 * m * d * n_out, library=lambda: x @ w16, repeat=True,
                shape=[m, d, n_out], lane_bytes_threads_slice_rows=plan,
                library_call="x_bf16 @ W_bf16 (dequantized once)"))
        del w, w16
    out.append(("matmul_int8", "taste_spokenlm_tpu_torch/csrc/int8_matmul.cu",
                "taste_spokenlm_tpu/ops/pallas/int8_matmul.py:90",
                "rel err <= 1e-3 of max|plain|; bit-identical twice", shapes))
    return out


def relpos_library_chain(q_u, q_v, k, v, p):
    """The rel-pos forward at full lengths as a chain of library calls:
    ac = q_u k^T and q_v p^T by torch.bmm, the skew as a gather (score (i,
    j) takes table row (T-1) - i + j), a causal masked softmax, torch.bmm
    with v; -> o [B*H, T, dk]."""
    b, t, h, dk = q_u.shape
    heads = lambda x: x.transpose(1, 2).reshape(b * h, t, dk)  # noqa: E731
    qu, qv, kk, vv = map(heads, (q_u, q_v, k, v))
    table = p[:t].transpose(0, 1).repeat(b, 1, 1)          # [B*H, T, dk]
    i = torch.arange(t, device=q_u.device)
    idx = ((t - 1) - i[:, None] + i[None, :]).clamp_(0, t - 1)
    bd = torch.gather(torch.bmm(qv, table.transpose(1, 2)), 2,
                      idx[None].expand(b * h, t, t))
    s = (torch.bmm(qu, kk.transpose(1, 2)) + bd) * dk ** -0.5
    s = s.masked_fill(i[None, :] > i[:, None], float("-inf"))
    return torch.bmm(torch.softmax(s, -1), vv)


def relpos_chain_bwd_ms(xs, do) -> float:
    """The backward of relpos_library_chain under autograd at full lengths
    (the forward recorded once; torch.autograd.grad timed)."""
    leaves = [x.detach().requires_grad_() for x in xs]
    with torch.enable_grad():
        out = relpos_library_chain(*leaves)
    b, t, h, dk = xs[0].shape
    grad = do.transpose(1, 2).reshape(b * h, t, dk)
    return time_ms(lambda: torch.autograd.grad(out, leaves, grad,
                                               retain_graph=True), reps=5)


def relpos_kernel_rows(dev, gen, launches: dict, profiled: list):
    """The rel-pos attention forward and backward against their plain
    versions at the training path's shape (B, T, H, 128), bf16 (the path's
    type) and f32, with ragged lengths: o within 1e-4 abs (f32) or 2e-2 of
    max|plain| (bf16: the online softmax rounds each tile's probabilities
    to bf16 against its own running max), the LSE within 1e-4, the five
    gradients at the same tolerances relative to max|plain|, and the
    forward and the backward twice bit-identical.  Reach, each past 5x the
    tolerance: p zeroed, p shifted by one row (an off-by-one diagonal), the
    lengths ignored (the ragged rows unmasked), and dp from one batch row
    only.
    -> the forward's and the backward's rows; each backward row's launch
    split is appended to `profiled`, to be traced last."""
    fwd_shapes, bwd_shapes = [], []
    main_key = max(launches["relpos_causal_attention"])
    (b, t, h, dk, _), n_fwd = main_key, launches["relpos_causal_attention"][
        main_key]
    n_bwd = sum(launches["relpos_causal_attention_bwd"].values())
    lens_list = [t, 3 * t // 4, 7 * t // 16, t // 6, t - 1, 5 * t // 8,
                 5 * t // 16, 3 * t // 16][:b]
    lens = torch.tensor(lens_list, dtype=torch.int32, device=dev)
    full = torch.full_like(lens, t)
    # the checks take ragged lengths; the times are taken at the path's
    # own (every row T long), so that launches x ms is the path's time
    pairs = b * h * t * (t + 1) // 2
    plain_fwd = relpos_attention.relpos_causal_attention_plain
    plain_bwd = relpos_attention.relpos_causal_attention_bwd_plain

    def rel(out, ref):
        return ((out.float() - ref.float()).abs().max()
                / ref.float().abs().max()).item()

    for dtype in (torch.bfloat16, torch.float32):
        f32 = dtype == torch.float32
        tol = 1e-4 if f32 else 2e-2
        # q_u, q_v, k and p at 1.5 give scores of std ~3: a peaked softmax,
        # so that keys past a row's length, unmasked, move its output
        xs = [(torch.randn((b, t, h, dk), generator=gen, device=dev) * g
               ).to(dtype) for g in (1.5, 1.5, 1.5, 1.0)]
        xs.append((torch.randn((2 * t - 1, h, dk), generator=gen, device=dev)
                   * 1.5).to(dtype))
        o, lse = relpos_attention.relpos_causal_attention_fwd(*xs, lens)
        o_ref, lse_ref = plain_fwd(*xs, lens)
        again = relpos_attention.relpos_causal_attention_fwd(*xs, lens)
        torch.cuda.synchronize()
        check(torch.equal(again[0], o) and torch.equal(again[1], lse),
              f"relpos forward ({dtype}) is not bit-identical twice")
        del again
        o_abs = (o.float() - o_ref.float()).abs().max().item()
        o_err = o_abs if f32 else rel(o, o_ref)
        lse_err = (lse - lse_ref).abs().max().item()
        check(o_err <= tol, f"relpos forward {dtype} err {o_err} > {tol}")
        check(lse_err <= 1e-4, f"relpos LSE err {lse_err} > 1e-4")
        scale = o_ref.float().abs().max().item() if f32 else 1.0

        def moved(out):      # the forward check's measure, of a broken input
            err = (out.float() - o_ref.float()).abs().max().item()
            return err if f32 else err / o_ref.float().abs().max().item()
        shifted = torch.cat([xs[4][1:], xs[4][:1]])
        reach_fwd = {
            "p zeroed": moved(plain_fwd(*xs[:4], torch.zeros_like(xs[4]),
                                        lens)[0]),
            "p shifted by one row": moved(plain_fwd(*xs[:4], shifted,
                                                    lens)[0]),
            "lengths ignored": moved(plain_fwd(*xs, full)[0])}
        for what, r in reach_fwd.items():
            check(r > 5 * tol, f"relpos forward check too blunt ({dtype}): "
                               f"{what} moves it only {r}")
        do = (torch.randn((b, t, h, dk), generator=gen, device=dev)
              ).to(dtype)
        grads = relpos_attention.relpos_causal_attention_bwd(
            *xs, lens, o, lse, do)
        refs = plain_bwd(*xs, lens, o, lse, do)
        again = relpos_attention.relpos_causal_attention_bwd(
            *xs, lens, o, lse, do)
        torch.cuda.synchronize()
        g_err = {name: rel(g, r) for name, g, r in
                 zip(("dq_u", "dq_v", "dk", "dv", "dp"), grads, refs)}
        for name, e in g_err.items():
            check(e <= tol, f"relpos backward {name} ({dtype}) rel err {e} "
                            f"> {tol}")
        check(all(torch.equal(x, y) for x, y in zip(grads, again)),
              f"relpos backward ({dtype}) is not bit-identical twice")
        check(bool((grads[4][t:] == 0).all()), "relpos dp rows >= T not 0")
        one_row = plain_bwd(*(x[:1] for x in xs[:4]), xs[4], lens[:1],
                            o[:1], lse[:h], do[:1])[4]
        off_by_one = plain_bwd(*xs[:4], shifted, lens, o, lse, do)
        reach_bwd = {"dp from one batch row": rel(one_row, refs[4]),
                     "p shifted by one row: dq_v": rel(off_by_one[1], refs[1]),
                     "p shifted by one row: dp": rel(off_by_one[4], refs[4])}
        for what, r in reach_bwd.items():
            check(r > 5 * tol, f"relpos backward check too blunt ({dtype}): "
                               f"{what} moves it only {r}")
        del off_by_one
        width = 2 if not f32 else 4
        n_el, p_el = b * t * h * dk, (2 * t - 1) * h * dk
        in_bytes = width * (4 * n_el + p_el) + 4 * b    # q_u q_v k v p len
        peak = F32_FLOPS if f32 else BF16_FLOPS
        n_f = n_fwd if not f32 else 0
        n_b = n_bwd if not f32 else 0
        common = {"shape": [b, t, h, dk], "lengths": lens_list,
                  "dtype": str(dtype).split(".")[-1],
                  "timed_at_lengths": t, "causal_pairs": pairs}
        # forward: + o and the LSE written; 3 products of 2 dk flops a pair
        bnd, by = bound_ms(in_bytes + width * n_el + 4 * b * h * t,
                           6 * dk * pairs, peak)
        chain = {} if f32 else {
            "library_chain_ms": time_ms(lambda: relpos_library_chain(*xs),
                                        reps=5),
            "library_call": "torch.bmm for ac and bd, the gather skew, a "
                            "masked softmax, torch.bmm with v (bf16); "
                            "library_ms null: no one call"}
        fwd_shapes.append({
            **common, "launches": n_f, "max_abs_err": o_abs,
            "rel_err": o_err / scale, "lse_err": lse_err,
            "repeat_identical": True, "broken_input": reach_fwd,
            "ms": time_ms(lambda: relpos_attention.relpos_causal_attention_fwd(*xs, full)),
            "plain_ms": time_ms(lambda: plain_fwd(*xs, full), reps=5),
            "ragged_ms": time_ms(lambda: relpos_attention.relpos_causal_attention_fwd(*xs, lens)),
            "library_ms": None, **chain, "bound_ms": bnd, "bound_by": by})
        o_full, lse_full = relpos_attention.relpos_causal_attention_fwd(*xs, full)
        # backward: + o, dO and the LSE read, five gradients written; 8
        # products a pair (the scores' two again, dO.v, dv, dk, dq_u, dq_v,
        # dp)
        bnd, by = bound_ms(in_bytes + 2 * width * n_el + 4 * b * h * t
                           + width * (4 * n_el + p_el), 16 * dk * pairs, peak)
        chain = {} if f32 else {
            "library_chain_ms": relpos_chain_bwd_ms(xs, do),
            "library_call": "the backward of the forward's library chain "
                            "under autograd (bf16); library_ms null: no one "
                            "call"}
        bwd_shapes.append({
            **common, "launches": n_b,
            "max_abs_err": max((g.float() - r.float()).abs().max().item()
                               for g, r in zip(grads, refs)),
            "rel_err": g_err, "repeat_identical": True,
            "broken_input": reach_bwd,
            "ms": time_ms(lambda: relpos_attention.relpos_causal_attention_bwd(
                *xs, full, o_full, lse_full, do)),
            "plain_ms": time_ms(lambda: plain_bwd(*xs, full, o_full, lse_full,
                                                  do), reps=5),
            "ragged_ms": time_ms(
                lambda: relpos_attention.relpos_causal_attention_bwd(
                    *xs, lens, o, lse, do)),
            "library_ms": None, **chain, "bound_ms": bnd, "bound_by": by})
        profiled.append((bwd_shapes[-1], lambda xs=xs, o=o_full, lse=lse_full,
                         do=do: relpos_attention.relpos_causal_attention_bwd(
                             *xs, full, o, lse, do), RELPOS_BWD_LAUNCHES, 3))
        del xs, o, lse, o_ref, lse_ref, grads, refs, again, do, o_full, \
            lse_full
        torch.cuda.empty_cache()
    # the forward's other shapes (the stage-2 eval's teacher-forced S3
    # stack, under no_grad): o and the LSE against the plain version at
    # ragged lengths, bit-identical twice, p shifted by one row past 5x
    # the tolerance, timed at the path's full lengths
    for key, n in sorted(launches["relpos_causal_attention"].items()):
        if key == main_key:
            continue
        b2, t2, h2, dk2, dt = key
        dtype = getattr(torch, dt)
        f32 = dtype == torch.float32
        tol = 1e-4 if f32 else 2e-2
        xs = [(torch.randn((b2, t2, h2, dk2), generator=gen, device=dev) * g
               ).to(dtype) for g in (1.5, 1.5, 1.5, 1.0)]
        xs.append((torch.randn((2 * t2 - 1, h2, dk2), generator=gen,
                               device=dev) * 1.5).to(dtype))
        lens2 = torch.tensor([t2, 3 * t2 // 4, t2 // 3, t2 - 1][:b2],
                             dtype=torch.int32, device=dev)
        full2 = torch.full_like(lens2, t2)
        o, lse = relpos_attention.relpos_causal_attention_fwd(*xs, lens2)
        o_ref, lse_ref = plain_fwd(*xs, lens2)
        again = relpos_attention.relpos_causal_attention_fwd(*xs, lens2)
        torch.cuda.synchronize()
        check(torch.equal(again[0], o) and torch.equal(again[1], lse),
              f"relpos forward at {list(key)} is not bit-identical twice")
        o_abs = (o.float() - o_ref.float()).abs().max().item()
        o_err = o_abs if f32 else rel(o, o_ref)
        lse_err = (lse - lse_ref).abs().max().item()
        check(o_err <= tol and lse_err <= 1e-4,
              f"relpos forward at {list(key)}: err {o_err} (LSE {lse_err})")
        shifted = torch.cat([xs[4][1:], xs[4][:1]])
        moved = rel(plain_fwd(*xs[:4], shifted, lens2)[0], o_ref)
        check(moved > 5 * tol, f"relpos forward check too blunt at "
                               f"{list(key)}: p shifted moves it only {moved}")
        width = 4 if f32 else 2
        n_el, p_el = b2 * t2 * h2 * dk2, (2 * t2 - 1) * h2 * dk2
        pairs2 = b2 * h2 * t2 * (t2 + 1) // 2
        bnd, by = bound_ms(width * (5 * n_el + p_el) + 4 * b2
                           + 4 * b2 * h2 * t2, 6 * dk2 * pairs2,
                           F32_FLOPS if f32 else BF16_FLOPS)
        fwd_shapes.append({
            "shape": [b2, t2, h2, dk2], "lengths": lens2.tolist(),
            "dtype": dt, "timed_at_lengths": t2, "causal_pairs": pairs2,
            "launches": n, "max_abs_err": o_abs, "rel_err": o_err,
            "lse_err": lse_err, "repeat_identical": True,
            "broken_input": {"p shifted by one row": moved},
            "ms": time_ms(lambda: relpos_attention.relpos_causal_attention_fwd(
                *xs, full2)),
            "plain_ms": time_ms(lambda: plain_fwd(*xs, full2), reps=5),
            "library_ms": None,
            **({} if f32 else {
                "library_chain_ms": time_ms(
                    lambda: relpos_library_chain(*xs), reps=5),
                "library_call": "as the training shape's row"}),
            "bound_ms": bnd, "bound_by": by})
        del xs, o, lse, o_ref, lse_ref, again
        torch.cuda.empty_cache()
    tol = ("bf16: rel err <= 2e-2 of max|plain|; f32: max abs err <= 1e-4; "
           "LSE <= 1e-4")
    src = "taste_spokenlm_tpu_torch/csrc/relpos_attention.cu"
    return [("relpos_causal_attention", src,
             "taste_spokenlm_tpu/ops/pallas/relpos_attention.py:114",
             tol, fwd_shapes),
            ("relpos_causal_attention_bwd", src,
             "taste_spokenlm_tpu/ops/pallas/relpos_attention.py:155",
             "each gradient " + tol.replace("max abs err", "rel err")
             .replace("; LSE <= 1e-4", "") + "; bit-identical twice",
             bwd_shapes)]


def increment_err(out, ref, x, lengths):
    """(max abs err, the same over the largest |ref - x|) of out against ref
    over each row's valid positions: the error of a residual block's
    increment.  Padded rows are junk by contract and left out."""
    err = scale = 0.0
    for b, n in enumerate(lengths.tolist()):
        o, r, xb = (a[b, :n].float() for a in (out, ref, x))
        err = max(err, (o - r).abs().max().item())
        scale = max(scale, (r - xb).abs().max().item())
    return err, err / scale


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


# ---------------------------------------------------------------------------
# the full-width reconstruction
# ---------------------------------------------------------------------------


def inputs(cfg: TasteConfig, dev):
    rng = np.random.RandomState(0)
    sr, secs = 16000, 14.0
    tt = np.arange(int(sr * secs)) / sr
    wav = (0.3 * np.sin(2 * np.pi * 180.0 * tt * (1 + 0.1 * np.sin(tt)))
           + 0.02 * rng.randn(tt.size)).astype(np.float32)
    mel = whisper_log_mel(torch.from_numpy(wav).to(dev))
    vocab = cfg.audio_tower.whisper.vocab_size
    return {
        "speaker_embeds": torch.from_numpy(
            rng.randn(B, cfg.speech_decoder.spk_embed_dim).astype(np.float32)).to(dev),
        "asr_token_ids": torch.from_numpy(
            rng.randint(100, 20000, (B, T_TOK)) % vocab).to(dev),
        "asr_token_lengths": torch.full((B,), T_TOK, device=dev),
        "asr_word_ids": (torch.arange(T_TOK, device=dev) // 2)[None].repeat(B, 1),
        "audio_features": mel,
    }


def reconstruct(model, x, gen):
    return model.inference_reconstruction(
        x["speaker_embeds"], x["asr_token_ids"], x["asr_token_lengths"],
        x["asr_word_ids"], x["audio_features"], max_speech_steps=MAX_SPEECH,
        mel_len_max=MEL_LEN_MAX, generator=gen)


@torch.no_grad()
def stage_times(model, x, out, gen):
    """Seconds of each stage of one reconstruction, each ending in a
    synchronize."""
    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0
    tw = model.audio_tower
    enc, t_tower = timed(lambda: tw(x["audio_features"], x["asr_token_ids"],
                                    x["asr_token_lengths"], x["asr_word_ids"]))
    _, t_s3 = timed(lambda: model.speech_decoder.generate(
        x["speaker_embeds"], enc["audio_unit_embeds"], enc["audio_unit_lengths"],
        x["asr_token_ids"], x["asr_token_lengths"], max_steps=MAX_SPEECH,
        generator=gen))
    tokens = torch.clamp(out["speech_token_ids"], min=0)
    vg = model.voice_generator
    (mel, _), t_flow = timed(lambda: vg.flow.inference(
        tokens, out["speech_token_lengths"], x["speaker_embeds"], MEL_LEN_MAX,
        generator=gen))
    _, t_hift = timed(lambda: vg.hift(mel, generator=gen))
    return {"tower_s": t_tower, "s3_decode_s": t_s3, "flow_s": t_flow,
            "hift_s": t_hift}


def flow_parity(model, cfg: TasteConfig, out, x, gen, mel_len: int):
    """The flow's mel with kernels against the plain versions for the same
    start noise z, as the relative error of what the estimator added to z
    (mel - z) over the valid frames; and the same error of the plain bf16
    flow against an f32 copy of it, the bf16 noise floor."""
    dev = x["speaker_embeds"].device
    tokens = torch.clamp(out["speech_token_ids"], min=0)
    z = torch.randn((B, MEL_LEN_MAX, cfg.flow.output_size), generator=gen,
                    device=dev)
    run = lambda flow: flow.inference(  # noqa: E731
        tokens, out["speech_token_lengths"], x["speaker_embeds"], MEL_LEN_MAX,
        z=z)[0]
    flow = model.voice_generator.flow
    mel_k = run(flow)
    model.set_use_kernels(False)
    mel_p = run(flow)
    mel_32 = run(copy.deepcopy(flow).float())
    model.set_use_kernels(True)
    lengths = torch.full((B,), mel_len, device=dev)
    return (increment_err(mel_k, mel_p, z, lengths)[1],
            increment_err(mel_p, mel_32, z, lengths)[1])


def device_profile(run, wall_s: float):
    """Device time of run() from a torch.profiler trace: the union of the
    CUDA kernel intervals against the unprofiled wall time, and the kernels
    with the most device time.  The trace is complete when it holds as many
    launches of our kernels as their counters saw during it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    counts = launch_counts()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        return {"busy_s": None, "note": "the profiler recorded no device time"}
    busy_us, start, end = 0.0, None, None
    for s, e in sorted((k.time_range.start, k.time_range.end) for k in kernels):
        if end is None or s > end:
            busy_us += 0.0 if end is None else end - start
            start, end = s, e
        else:
            end = max(end, e)
    busy_us += end - start
    by_name = {}
    for k in kernels:
        n, us = by_name.get(k.name, (0, 0.0))
        by_name[k.name] = (n + 1, us + k.time_range.elapsed_us())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    # one kernel name per counted launch ("|" joins parts that must all
    # appear): matmul_int4 is int4_kernel or int4_kernel_split; a gated MLP
    # is gated_mlp_kernel<Q4, false, ...> or gated_gemv_kernel<Q4, false>,
    # an FFN the same kernels <Q4, true, ...>; a rel-pos forward is
    # fwd_kernel<float> or fwd_kernel_mma, a backward one dq_kernel
    # (dq_kernel<float> or dq_kernel_mma) among its five launches
    expected = {"gated_|<false, true": counts["ffn_int8"],
                "gated_|<true, true": counts["ffn_int4"],
                "gated_|<false, false": counts["gated_mlp_int8"],
                "gated_|<true, false": counts["gated_mlp_int4"],
                "int4_kernel": counts["matmul_int4"],
                "flash_kernel_": counts["flash_attention"],
                "fwd_kernel": counts["relpos_causal_attention"],
                "dq_kernel": counts["relpos_causal_attention_bwd"]}
    seen = {key: sum(1 for k in kernels
                     if all(part in k.name for part in key.split("|")))
            for key in expected}
    return {"busy_s": busy_us / 1e6, "idle_share": 1.0 - busy_us / 1e6 / wall_s,
            "n_kernel_launches": len(kernels), "trace_complete": seen == expected,
            "traced_launches": seen, "counted_launches": expected,
            "top_kernels": [{"name": n[:90], "launches": c, "ms": us / 1e3}
                            for n, (c, us) in top]}


# ---------------------------------------------------------------------------
# the serving model and the completion
# ---------------------------------------------------------------------------


class VocabScan:
    """A deterministic id -> subword map standing in for the Llama tokenizer
    when building the sampler tables (bench.py:138-147): the tables' shapes
    and the sampler's cost are those of real ones."""

    def decode(self, i):
        return (" the", "ing", ".", " end.", "!!", "a\nb", " word", "s",
                ",'", " no.", "xyz")[i % 11]


def configs():
    """(float layout, {tier: serving layout}) of TasteConfig.full(): the
    serving ones are bench.py:755-811 with BENCH_FUSED_MLP=1, and BENCH_QUANT
    unset ("int8") or 4 ("int4") (quant.serving_config)."""
    cfg = TasteConfig.full()
    cfg = cfg.replace(flow=cfg.flow.replace(fused_dit_serving=True),
                      hift=cfg.hift.replace(pallas_conv=True))
    return cfg, {tier: quant.serving_config(cfg, tier)
                 for tier in ("int8", "int4")}


def build_model(dev, gen, tier: str):
    """The serving model of a tier, its config and the parameter counts;
    the float weights are the first draws of `gen`."""
    float_cfg, serving = configs()
    cfg = serving[tier]
    kw = dict(dtype=torch.bfloat16, tower_dtype=torch.float32, device=dev)
    with torch.device(dev):
        float_model = TasteForCausalLM(float_cfg, **kw)
        n_float = sum(p.numel() for p in float_model.parameters())
        sd = random_state_dict(float_model, gen)
        del float_model
        model = TasteForCausalLM(cfg, **kw)
    model.load_state_dict(quant.serving_state_dict(sd, cfg, tier),
                          strict=True)
    return model.eval(), cfg, n_float


def lm_prefix(cfg: TasteConfig, x, dev):
    """The spoken-LM prefix of the same utterance: 40 llm ids (bench.py:
    836-844) with the asr word ids."""
    rng = np.random.RandomState(1)
    ids = rng.randint(100, 120000, (B, T_TOK)) % cfg.spoken_lm.llama.vocab_size
    return {"llm_token_ids": torch.from_numpy(ids).to(dev),
            "llm_token_lengths": torch.full((B,), T_TOK, device=dev),
            "llm_word_ids": x["asr_word_ids"]}


def synth_batch(cfg: TasteConfig, out, dev):
    """Host glue (bench.py:1030-1042): the decoded taste rows dense per word
    and 128 asr tokens at 2 per word."""
    n_taste = max(int(out["num_taste_words"][0]), 1)
    l = cfg.audio_tower.quantizer.num_quantizers
    taste = torch.zeros((B, LM_STEPS, l), dtype=torch.long, device=dev)
    taste[0, :n_taste] = out["taste_indices"][0, :n_taste].clamp(min=0)
    rng = np.random.RandomState(2)
    ids = rng.randint(100, 20000, (B, SYN_ASR)) % cfg.audio_tower.whisper.vocab_size
    words = np.minimum(np.arange(SYN_ASR) // 2, LM_STEPS - 1)[None].repeat(B, 0)
    return (taste, torch.from_numpy(ids).to(dev),
            torch.full((B,), SYN_ASR, device=dev), torch.from_numpy(words).to(dev))


def joint_decode(model, scfg, tables, lm, llm_indices, seed=None):
    gen = (None if seed is None
           else torch.Generator(device=llm_indices.device).manual_seed(seed))
    return model.generate_completion(
        scfg, tables, llm_indices, lm["llm_token_ids"], lm["llm_token_lengths"],
        lm["llm_word_ids"], "audio", LM_STEPS, generator=gen)


class DecodeRecorder:
    """Within it, every joint decode step's text logits (f32, before the
    sampler's masks) and the sampler's decisions (text id, taste ids) of
    every row are recorded, in `steps`."""

    def __init__(self, model):
        self.lm = model.spoken_lm.language_model
        self.steps = []

    def __enter__(self):
        head, real_step = self.lm.logits, spoken_lm_module.sampler_step
        last = {}

        def logits(hidden):
            out = head(hidden)
            last["lg"] = out[:, 0].float()
            return out

        def step(*args, **kw):
            state, out = real_step(*args, **kw)
            self.steps.append((last["lg"], torch.cat(
                [out.text_id[:, None], out.taste_ids], dim=1)))
            return state, out
        self.lm.logits = logits
        spoken_lm_module.sampler_step = step
        self._real_step = real_step
        return self

    def __exit__(self, *exc):
        del self.lm.logits
        spoken_lm_module.sampler_step = self._real_step

    def row(self, i: int):
        """(text logits [S, V], decisions [S, 1 + L]) of row i."""
        return (torch.stack([lg[i] for lg, _ in self.steps]),
                torch.stack([d[i] for _, d in self.steps]))


def parting(run_a, run_b, ok=None):
    """Two runs of one request, each (text logits [S, V], decisions [S,
    D]): the first step whose decisions differ (None if none does within
    the shorter run), the largest logit difference over the steps up to
    and including it, relative to run b's max |logit| (over the entries
    `ok` keeps), and where they part, run b's top-2 text-logit margin
    there beside the largest logit difference there."""
    (lg_a, dec_a), (lg_b, dec_b) = run_a, run_b
    n = min(len(lg_a), len(lg_b))
    differ = (dec_a[:n] != dec_b[:n]).any(-1)
    first = int(differ.nonzero()[0]) if bool(differ.any()) else None
    last = n - 1 if first is None else first
    lg_a, lg_b = lg_a[:last + 1], lg_b[:last + 1]
    if ok is not None:
        lg_a, lg_b = lg_a[:, ok], lg_b[:, ok]
    diff = (lg_a - lg_b).abs().amax(-1)
    rel = (diff / lg_b.abs().amax(-1)).max().item()
    at = None
    if first is not None:
        top2 = lg_b[-1].topk(2).values
        at = {"top2_margin": (top2[0] - top2[1]).item(),
              "logit_diff": diff[-1].item()}
    return first, rel, at


def greedy_run(model, scfg, tables, lm, llm_indices):
    """A joint decode recorded: -> (its output, (text logits [S, V],
    decisions [S, 1 + L]) of its row)."""
    with DecodeRecorder(model) as rec:
        res = joint_decode(model, scfg, tables, lm, llm_indices)
    return res, rec.row(0)


def prefill_hidden(model, lm, llm_indices):
    """The joint decode's first hidden state (after the prefix prefill)."""
    st = model.spoken_lm.generate_stream_init(
        model._cb(), llm_indices, lm["llm_token_ids"], lm["llm_token_lengths"],
        lm["llm_word_ids"], "audio", 1)
    return st["hidden"].float()


def complete(model, cfg, x, lm, scfg, tables, gen):
    """One completion: extract_vq, the joint decode, the host glue and the
    synthesis, each timed to a synchronize."""
    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0
    (_, idx), t_vq = timed(lambda: model.extract_vq(
        x["asr_token_ids"], x["asr_token_lengths"], x["asr_word_ids"],
        lm["llm_token_ids"], lm["llm_token_lengths"], lm["llm_word_ids"],
        x["audio_features"]))
    out, t_dec = timed(lambda: joint_decode(model, scfg, tables, lm, idx, 5))
    taste, ids, lens, words = synth_batch(cfg, out, idx.device)
    syn, t_syn = timed(lambda: model.synthesize_from_taste(
        x["speaker_embeds"], taste, ids, lens, words,
        max_speech_steps=MAX_SPEECH, mel_len_max=MEL_LEN_MAX, generator=gen))
    return idx, out, syn, {"extract_vq_s": t_vq, "joint_decode_s": t_dec,
                           "synthesis_s": t_syn}


def check_counts(counts: dict, expected: dict, path: str) -> None:
    """Every kernel launched exactly as often as the config implies, and
    each that the path runs at least once."""
    for name, n in counts.items():
        want = expected.get(name, 0)
        check(n == want, f"{path}: {name} launched {n} times, the config "
                         f"implies {want}")
    for name, n in expected.items():
        check(counts[name] > 0, f"{path}: {name} never launched")


def quantized_launches(cfg: TasteConfig, tier: str, steps: int,
                       s3_len: int, lm_tokens: int = T_TOK) -> dict:
    """{kernel: {shape: launches}} of the quantized kernels in one completion
    of a tier, from the config: per Llama layer one prefill of the prefix
    rows (1 + lm_tokens + delay) and one row a joint step; per S3 layer one
    prefill of the 131 prefix rows and one row an S3 step (the one that
    emits EOS included);
    the tied head once a joint step, the S3 head once an S3 step.  In int4
    the Llama's qkv / o and the S3 stack's qkv / out run matmul_int4 too
    (rows, in, out); the S3 linear_pos runs over 2 x 643 - 1 rows, past
    the kernel's limit, once per synthesis."""
    llama, s3 = cfg.spoken_lm.llama, cfg.speech_decoder.llm
    lm_rows = B * (1 + lm_tokens + cfg.spoken_lm.delay)
    s3_rows = B * (3 + SYN_ASR)
    check(max(lm_rows, s3_rows) <= min(FUSED_MLP_MAX_ROWS, INT4_KERNEL_MAX_ROWS),
          "a prefill past the kernels' row limit")
    n_s3 = min(s3_len + 1, MAX_SPEECH)
    per_lm = {1: llama.num_hidden_layers * steps, lm_rows: llama.num_hidden_layers}
    per_s3 = {1: s3.num_blocks * n_s3, s3_rows: s3.num_blocks}
    h = llama.hidden_size
    mm = {(1, h, llama.vocab_size): steps}
    gated = {(m, h, llama.intermediate_size): n for m, n in per_lm.items()}
    if tier == "int8":
        return {"gated_mlp_int8": gated, "ffn_int8": per_s3, "matmul_int4": mm}
    heads = llama.num_attention_heads * llama.head_dim
    qkv = heads + 2 * llama.num_key_value_heads * llama.head_dim
    d = s3.output_size
    for d_in, d_out, rows in ((h, qkv, per_lm), (heads, h, per_lm),
                              (d, 3 * d, per_s3), (d, d, per_s3)):
        for m, n in rows.items():
            mm[(m, d_in, d_out)] = n
    mm[(1, cfg.speech_decoder.llm_output_size,
        cfg.speech_decoder.speech_token_size + 1)] = n_s3
    return {"gated_mlp_int4": gated, "ffn_int4": per_s3, "matmul_int4": mm}


def tf_launches(cfg: TasteConfig, tier: str, rows: int) -> dict:
    """{kernel: {shape: launches}} of one teacher-forced spoken-LM forward
    over `rows` rows in a tier's serving layout: per Llama layer the fused
    MLP over the rows (in int4 also the qkv and o products on
    matmul_int4), and the int4 tied head once over the rows."""
    llama = cfg.spoken_lm.llama
    h, n_layers = llama.hidden_size, llama.num_hidden_layers
    out = {f"gated_mlp_{tier}": {(rows, h, llama.intermediate_size): n_layers},
           "matmul_int4": {(rows, h, llama.vocab_size): 1}}
    if tier == "int4":
        heads = llama.num_attention_heads * llama.head_dim
        qkv = heads + 2 * llama.num_key_value_heads * llama.head_dim
        out["matmul_int4"].update({(rows, h, qkv): n_layers,
                                   (rows, heads, h): n_layers})
    return out


def fidelity_launches(cfg: TasteConfig, fidelity: dict) -> dict:
    """{kernel: launches} of the serving fidelity path, from each row's run:
    a quantized row launches its tier's completion kernels (its own joint
    decode steps and S3 length), the fused DiT over its synthesis and over
    the flow on the f32 row's tokens, the kernel convs once, and its
    teacher-forced forward over the 42-row prefix; the f32 and bf16 rows
    and the float twins launch none of the kernels."""
    total: dict = {}
    rows = B * (1 + T_TOK + cfg.spoken_lm.delay)
    for name, row in fidelity["rows"].items():
        tier = {"int8": "int8", "int4": "int4",
                serving_fidelity.REACH: "int8"}.get(name)
        if tier is None:
            continue
        runs = merge_launches(
            quantized_launches(cfg, tier, row["jd_steps"], row["s3_tokens"]),
            {"fused_dit_block": dit_shapes(cfg, row["syn_mel_frames"]),
             "conv1d_same": conv_shapes(cfg)},
            {"fused_dit_block": dit_shapes(cfg, row["mel_frames"])},
            tf_launches(cfg, tier, rows))
        for kernel, shapes in runs.items():
            total[kernel] = total.get(kernel, 0) + sum(shapes.values())
    return total


def completion_path(model, cfg: TasteConfig, tier: str, x, lm, scfg, tables,
                    gen, n_frames: int, profile: bool):
    """One tier's completion: a warm-up, the counted run and its checks, the
    repeat and the greedy kernels-against-plain checks (and, with
    `profile`, traces of one joint decode and one synthesis).  ->
    ({kernel: {shape: launches}} and the launch counts of the counted run,
    the greedy text ids with kernels, their number of tokens, and the
    counted run's llm indices and joint decode)."""
    complete(model, cfg, x, lm, scfg, tables, gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    idx, dec, syn, walls = complete(model, cfg, x, lm, scfg, tables, gen)
    counts = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    steps, n_tokens = int(dec["steps"]), int(dec["num_tokens"][0])
    check(n_tokens >= LM_STEPS // 2,
          f"{tier}: degenerate joint decode: {n_tokens} tokens")
    s3_len = int(syn["speech_token_lengths"][0])
    check(s3_len >= 64, f"{tier}: degenerate S3 decode length {s3_len}")
    syn_mel = int(model.voice_generator.flow.mel_lengths(
        syn["speech_token_lengths"]).clamp(max=MEL_LEN_MAX)[0])
    wav = syn["waveform"].float()
    check(bool(torch.isfinite(wav).all()), f"{tier}: non-finite waveform")
    rms = wav.pow(2).mean().sqrt().item()
    check(rms > 1e-7, f"{tier}: degenerate completion waveform rms {rms}")
    syn_wav_len = int(syn["waveform_lengths"][0])
    check(syn_wav_len == 256 * syn_mel,
          f"{tier}: completion wav length {syn_wav_len} != 256 x {syn_mel}")
    syn_audio_s = syn_wav_len / cfg.hift.sampling_rate
    launches = {"flash_attention": flash_shapes(cfg, n_frames),
                "fused_dit_block": dit_shapes(cfg, syn_mel),
                "conv1d_same": conv_shapes(cfg),
                **quantized_launches(cfg, tier, steps, s3_len)}
    check_counts(counts, {k: sum(v.values()) for k, v in launches.items()},
                 f"{tier} completion")
    log({f"{tier}_completion": {
        **walls, "joint_decode_steps": steps, "tokens": n_tokens,
        "ms_per_step": 1e3 * walls["joint_decode_s"] / steps,
        "taste_words": int(dec["num_taste_words"][0]),
        "s3_decode_len": s3_len, "mel_frames": syn_mel, "audio_s": syn_audio_s,
        "wav_rms": rms, "completion_rtf": (walls["joint_decode_s"]
                                           + walls["synthesis_s"]) / syn_audio_s,
        "peak_mem_gb": peak_gb, "launches": counts}})

    # the same generator state gives the same trajectory; a greedy decode
    # with the kernels against one with their plain versions
    again = joint_decode(model, scfg, tables, lm, idx, 5)
    check(torch.equal(again["llm_token_ids"], dec["llm_token_ids"])
          and torch.equal(again["taste_indices"], dec["taste_indices"]),
          f"{tier}: the joint decode is not deterministic for one generator "
          "state")
    greedy = scfg._replace(text_top_p=0.0)
    run_k = greedy_run(model, greedy, tables, lm, idx)
    model.set_use_kernels(False)
    run_p = greedy_run(model, greedy, tables, lm, idx)
    h_p = prefill_hidden(model, lm, idx)
    model.set_use_kernels(True)
    h_k = prefill_hidden(model, lm, idx)
    tok_k, tok_p = run_k[0], run_p[0]
    n = max(int(tok_k["num_tokens"][0]), int(tok_p["num_tokens"][0]), 1)
    greedy_agree = (tok_k["llm_token_ids"][0, :n]
                    == tok_p["llm_token_ids"][0, :n]).float().mean().item()
    parted, logit_rel, at = parting(run_k[1], run_p[1], ~tables["banned"])
    hidden_rel = ((h_k - h_p).abs().max() / h_p.abs().max()).item()
    log({f"{tier}_completion_parity": {
        "repeat_identical": True, "greedy_text_agreement": greedy_agree,
        "greedy_tokens": n, "greedy_text_ids": tok_k["llm_token_ids"][0, :8].tolist(),
        "prefill_hidden_rel_err": hidden_rel, "parted_at_step": parted,
        "shared_history_text_logit_rel_err": logit_rel,
        "plain_top2_margin_at_parting": at and at["top2_margin"],
        "logit_diff_at_parting": at and at["logit_diff"]}})
    check(hidden_rel > 0, f"{tier}: the greedy check is blind: the joint "
                          "decode's hidden state is the same with and "
                          "without kernels")
    # random weights leave near-ties among 128,256 logits, which bf16
    # rounding in either run can flip, after which the histories differ:
    # the kernels are held to the plain versions' text logits on every
    # step of the shared history, and to the greedy agreement only where
    # the runs never part
    check(logit_rel <= LOGIT_TOL,
          f"{tier}: kernel-vs-plain text logits {logit_rel} apart (relative "
          f"to max |logit|) on a shared history, > {LOGIT_TOL}")
    check(greedy_agree >= 0.98 or parted is not None,
          f"{tier}: greedy text trajectory agreement {greedy_agree} < 0.98")
    # the check's reach: with every Llama MLP's output zeroed, the text
    # logits leave the tolerance on the shared history
    hooks = [layer.mlp.register_forward_hook(
        lambda mod, args, out: torch.zeros_like(out))
        for layer in model.spoken_lm.language_model.layers]
    try:
        run_z = greedy_run(model, greedy, tables, lm, idx)
    finally:
        for hook in hooks:
            hook.remove()
    reach = parting(run_z[1], run_p[1], ~tables["banned"])[1]
    log({f"{tier}_zeroed_mlps_text_logit_rel_err": reach})
    check(reach > LOGIT_TOL, f"{tier}: the logit check is blind: zeroed "
                             f"MLPs move the text logits only {reach}")
    if profile:
        taste, ids, lens, words = synth_batch(cfg, dec, idx.device)
        log({f"{tier}_joint_decode_device_profile": device_profile(
            lambda: joint_decode(model, scfg, tables, lm, idx, 5),
            walls["joint_decode_s"])})
        log({f"{tier}_synthesis_device_profile": device_profile(
            lambda: model.synthesize_from_taste(
                x["speaker_embeds"], taste, ids, lens, words,
                max_speech_steps=MAX_SPEECH, mel_len_max=MEL_LEN_MAX,
                generator=gen), walls["synthesis_s"])})
    return launches, counts, tok_k["llm_token_ids"][0], n, (idx, dec)


# ---------------------------------------------------------------------------
# the model axis: the int8 joint decode over two ranks sharing the card
# ---------------------------------------------------------------------------

MODEL_AXIS_DIR = os.path.join("build", "model_axis")
MODEL_AXIS_RANKS = 2
MODEL_AXIS_TIMEOUT_S = 600
MODEL_AXIS_TOL = 2e-2      # the prefill's and first step's logits, rel
MODEL_AXIS_WORKER = """
import sys
import chip_smoke
sys.exit(chip_smoke.model_axis_worker(int(sys.argv[1]), sys.argv[2]))
"""


def model_axis_worker(rank: int, port: str) -> int:
    """One rank of "model_axis" (a process of its own): the int8 serving
    model of build_model's weights, split over a (1, 2) mesh, a warm-up and
    a counted greedy joint decode of the prompt in MODEL_AXIS_DIR; writes
    its trajectory, text logits, launches, collectives, walls and peak
    memory to rank<rank>.pt there."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    mesh.init_distributed(f"localhost:{port}", MODEL_AXIS_RANKS, rank,
                          torch.device("cuda"), backend="gloo")
    dev = torch.device("cuda", torch.cuda.current_device())
    axis = mesh.make_mesh(1, MODEL_AXIS_RANKS).model_axis
    float_cfg, serving = configs()
    cfg = serving["int8"]
    kw = dict(dtype=torch.bfloat16, tower_dtype=torch.float32, device=dev)
    with torch.device(dev):
        float_model = TasteForCausalLM(float_cfg, **kw)
        sd = random_state_dict(float_model,
                               torch.Generator(device=dev).manual_seed(0))
        del float_model
        sd = quant.shard_state_dict(quant.serving_state_dict(sd, cfg, "int8"),
                                    axis.rank, axis.size)
        model = TasteForCausalLM(cfg, model_axis=axis, **kw)
    model.load_state_dict(sd, strict=True)
    del sd
    model.eval()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    prompt = torch.load(os.path.join(MODEL_AXIS_DIR, "prompt.pt"),
                        map_location=dev, weights_only=False)
    lm, idx = prompt["lm"], prompt["llm_indices"]
    scfg = SamplerConfig(**prompt["sampler"])
    tables = {k: torch.from_numpy(v).to(dev) for k, v in build_sampler_tables(
        VocabScan(), cfg.spoken_lm.llama.vocab_size).items()}
    model.generate_completion(              # warm-up: the prefill, 4 steps
        scfg, tables, idx, lm["llm_token_ids"], lm["llm_token_lengths"],
        lm["llm_word_ids"], "audio", 4)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    mesh.COLLECTIVES.clear()
    t0 = time.perf_counter()
    res, (logits, decisions) = greedy_run(model, scfg, tables, lm, idx)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, collectives = launch_counts(), dict(mesh.COLLECTIVES)
    peak = torch.cuda.max_memory_allocated() / 1e9
    # one collective of the decode alone: a [1, H] bf16 row over the group
    row = torch.ones((1, cfg.spoken_lm.llama.hidden_size),
                     dtype=torch.bfloat16, device=dev)
    with torch.no_grad():
        for i in range(55):
            if i == 5:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            mesh.reduce_from_model(row, axis)
        torch.cuda.synchronize()
    out = {"steps": int(res["steps"]), "wall_s": wall, "build_s": build_s,
           "counts": counts, "collectives": collectives, "peak_mem_gb": peak,
           "all_reduce_ms": (time.perf_counter() - t0) / 50 * 1e3,
           "logits": logits.cpu(), "decisions": decisions.cpu(),
           **{k: res[k].cpu() for k in ("llm_token_ids", "taste_indices",
                                        "num_tokens", "num_taste_words")}}
    torch.save(out, os.path.join(MODEL_AXIS_DIR, f"rank{rank}.pt"))
    mesh.barrier()
    torch.distributed.destroy_process_group()
    return 0


def model_axis_launches(cfg: TasteConfig, steps: int) -> dict:
    """{kernel: {shape: launches}} of one rank's joint decode of `steps`
    steps: per Llama layer gated_mlp_int8 on the rank's block of I over the
    prefix rows once and one row a step, the int4 head (whole) once a
    step."""
    llama = cfg.spoken_lm.llama
    h, n_layers = llama.hidden_size, llama.num_hidden_layers
    i = llama.intermediate_size // MODEL_AXIS_RANKS
    rows = B * (1 + T_TOK + cfg.spoken_lm.delay)
    return {"gated_mlp_int8": {(rows, h, i): n_layers,
                               (1, h, i): n_layers * steps},
            "matmul_int4": {(1, h, llama.vocab_size): steps}}


def model_axis_path(model, cfg: TasteConfig, lm, idx, scfg, tables, card: str):
    """(5m) the int8 joint decode over two ranks on the card against this
    process's run on the whole model, then dryrun_multichip(4) -> ({kernel:
    {shape: launches}} and the launch counts of both ranks' counted runs)."""
    shutil.rmtree(MODEL_AXIS_DIR, ignore_errors=True)
    os.makedirs(MODEL_AXIS_DIR)
    greedy = scfg._replace(text_top_p=0.0)
    torch.save({"lm": lm, "llm_indices": idx, "sampler": greedy._asdict()},
               os.path.join(MODEL_AXIS_DIR, "prompt.pt"))
    t_path = time.perf_counter()
    port = str(free_port())
    procs, logs = [], []
    for r in range(MODEL_AXIS_RANKS):
        logs.append(os.path.join(MODEL_AXIS_DIR, f"rank{r}.log"))
        with open(logs[-1], "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, "-c", MODEL_AXIS_WORKER, str(r), port],
                stdout=f, stderr=subprocess.STDOUT))
    try:
        # the one-process run meanwhile, on the whole model
        greedy_run(model, greedy, tables, lm, idx)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        one, run_one = greedy_run(model, greedy, tables, lm, idx)
        torch.cuda.synchronize()
        one_wall = time.perf_counter() - t0
        one_peak = torch.cuda.max_memory_allocated() / 1e9
        for r, proc in enumerate(procs):
            rc = proc.wait(timeout=MODEL_AXIS_TIMEOUT_S)
            check(rc == 0, f"model_axis rank {r} exited {rc}: "
                           f"{open(logs[r]).read()[-3000:]}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    ranks = [torch.load(os.path.join(MODEL_AXIS_DIR, f"rank{r}.pt"),
                        weights_only=False) for r in range(MODEL_AXIS_RANKS)]
    a, b = ranks
    traj = ("llm_token_ids", "taste_indices", "num_tokens", "num_taste_words")
    check(all(torch.equal(a[k], b[k]) for k in traj),
          "model_axis: the two ranks decode different trajectories")
    logits_equal = torch.equal(a["logits"], b["logits"])
    check(logits_equal, "model_axis: the two ranks' text logits differ")
    lg_one = run_one[0].cpu()
    drift = [((a["logits"][s] - lg_one[s]).abs().max()
              / lg_one[s].abs().max()).item() for s in (0, 1)]
    check(max(drift) <= MODEL_AXIS_TOL,
          f"model_axis: the prefill's / first step's text logits {drift} "
          f"of max |logit| from the one-process run's, > {MODEL_AXIS_TOL}")
    parted, shared_rel, at = parting(
        (a["logits"], a["decisions"]), (lg_one, run_one[1].cpu()),
        ~tables["banned"].cpu())
    if parted is not None:
        log({"model_axis_parting": {"step": parted, **at}})
        check(at["top2_margin"] < at["logit_diff"],
              f"model_axis: the trajectory parts from the one-process run's "
              f"at step {parted}, where that run's top-2 margin "
              f"{at['top2_margin']} exceeds the logit drift "
              f"{at['logit_diff']}: not a tie")
    steps = a["steps"]
    launches = model_axis_launches(cfg, steps)
    llama = cfg.spoken_lm.llama
    per_pass = 1 + 2 * llama.num_hidden_layers
    # the prefix's two embedding lookups, its prefill, then per step one
    # lookup and one pass (the int4 head is whole: no gather)
    want_collectives = {"all_reduce": 2 + 2 * llama.num_hidden_layers
                        + steps * per_pass}
    for r, res in enumerate(ranks):
        check(res["steps"] == steps, "model_axis: the ranks' step counts")
        check_counts(res["counts"], {k: sum(v.values())
                                     for k, v in launches.items()},
                     f"model_axis rank {r}")
        check(res["collectives"] == want_collectives,
              f"model_axis rank {r}: collectives {res['collectives']}, "
              f"the config implies {want_collectives}")
    n = int(a["num_tokens"][0])
    log({"model_axis": {
        "card": card, "ranks": MODEL_AXIS_RANKS, "backend": "gloo",
        "note": "two ranks share one card: the walls say nothing of "
                "tensor-parallel speed",
        "joint_decode_steps": steps, "tokens": n,
        "ms_per_step": [1e3 * r["wall_s"] / steps for r in ranks],
        "one_process_ms_per_step": 1e3 * one_wall / int(one["steps"]),
        "collectives_per_step": per_pass,
        "collectives": ranks[0]["collectives"],
        "all_reduce_ms": [r["all_reduce_ms"] for r in ranks],
        "peak_mem_gb": [r["peak_mem_gb"] for r in ranks],
        "one_process_peak_mem_gb": one_peak,
        "build_s": [r["build_s"] for r in ranks],
        "ranks_logits_bit_identical": logits_equal,
        "prefill_and_first_step_logit_rel_drift": drift,
        "shared_history_logit_rel_drift": shared_rel,
        "parted_at_step": parted,
        "text_agreement_with_one_process": (
            a["llm_token_ids"][0, :n] == one["llm_token_ids"][0, :n].cpu()
        ).float().mean().item(),
        "launches": ranks[0]["counts"]}})
    t0 = time.perf_counter()
    dryrun_multichip(4)
    log({"model_axis_dryrun_multichip_s": time.perf_counter() - t0,
         "model_axis_path_wall_s": time.perf_counter() - t_path})
    shutil.rmtree(MODEL_AXIS_DIR, ignore_errors=True)
    both = {k: {shape: MODEL_AXIS_RANKS * n for shape, n in v.items()}
            for k, v in launches.items()}
    counts = {k: sum(r["counts"][k] for r in ranks) for k in a["counts"]}
    return both, counts


# ---------------------------------------------------------------------------
# streaming: the chunked synthesis and the pipelined completion
# ---------------------------------------------------------------------------

# bench.py:1212-1230: a first chunk of 16 S3 tokens, then 50 and 446, 25
# tokens of left context, a crossfade of 2; the joint decode in chunks of
# 16, then 48, synthesis from 2 words on
STREAM = dict(chunk_tokens=50, left_ctx_tokens=25, crossfade_tokens=2,
              first_chunk_tokens=16, chunk_schedule=(50, 446),
              max_speech_steps=MAX_SPEECH)
PIPELINE = dict(jd_first_chunk=16, jd_chunk=48, min_start_words=2)
MIN_STREAM_AUDIO_S = 0.5   # a pipelined stream's least audio (bench.py:1313)


def stream_launches(cfg: TasteConfig, model, ran: dict, jd: bool) -> dict:
    """{kernel: {shape: launches}} of one stream, from what it ran
    (the "ran" record its chunks carry): per S3 prefill the 131 prefix rows through every
    layer's ffn_int8, one row per executed S3 step, none in a history
    replay (512 rows, past FUSED_MLP_MAX_ROWS: the unfused math); per
    vocoder window the fused DiT over its mel frames and the kernel convs
    at its lengths; with `jd`, per joint step the tied head's matmul_int4
    and one row of every Llama layer's gated_mlp_int8, and the 42-row
    prefill once."""
    s3, llama = cfg.speech_decoder.llm, cfg.spoken_lm.llama
    out = {"ffn_int8": {1: s3.num_blocks * ran["s3_steps"],
                        B * (3 + SYN_ASR): s3.num_blocks * ran["s3_prefills"]},
           "fused_dit_block": {}, "conv1d_same": {}}
    flow = model.voice_generator.flow
    for mw, n_tok in ran["windows"]:
        valid = int(flow.mel_lengths(torch.tensor(n_tok)).clamp(max=mw))
        out = merge_launches(out, {
            "fused_dit_block": dit_shapes(cfg, valid, mw),
            "conv1d_same": conv_shapes(cfg, mw)})
    if jd:
        h, i = llama.hidden_size, llama.intermediate_size
        out["gated_mlp_int8"] = {
            (1, h, i): llama.num_hidden_layers * ran["jd_steps"],
            (B * (1 + T_TOK + cfg.spoken_lm.delay), h, i):
                llama.num_hidden_layers * ran["jd_prefills"]}
        out["matmul_int4"] = {(1, h, llama.vocab_size): ran["jd_steps"]}
    return {k: {s: n for s, n in v.items() if n} for k, v in out.items()}


def seam_check(chunks, spf: int, mpt: float, what: str) -> dict:
    """tests/test_streaming.py:190-201 on the stream's wav: finite chunks,
    a length within 2 spf a chunk of floor(n mpt) spf, and near each seam
    a first difference within 5x the largest one away from the seams."""
    for c in chunks:
        check(bool(np.isfinite(c["wav"]).all()), f"{what}: a non-finite chunk")
    wav = np.concatenate([c["wav"] for c in chunks], axis=1)
    n = sum(c["n_new"] for c in chunks)
    expect = int(np.floor(n * mpt)) * spf
    check(abs(wav.shape[1] - expect) <= 2 * spf * len(chunks),
          f"{what}: {wav.shape[1]} samples for {n} tokens, expected {expect}")
    d = np.abs(np.diff(wav[0]))
    seams = np.cumsum([c["wav"].shape[1] for c in chunks])[:-1]
    interior = np.ones(len(d), bool)
    for sm in seams:
        interior[max(0, sm - 4):sm + 4] = False
    base = float(d[interior].max())
    worst = max((float(d[max(0, sm - 4):sm + 4].max()) for sm in seams),
                default=0.0)
    check(base > 0 and worst <= 5.0 * base + 1e-6,
          f"{what}: a seam jumps {worst}, 5x the interior's {base}")
    return {"tokens": n, "samples": wav.shape[1], "chunks": len(chunks),
            "seam_max_diff": worst, "interior_max_diff": base}


def recorded_s3_chunk(model, state, steps: int):
    """stream_decode_chunk, recording the S3 logits of every step."""
    logits = []
    hook = model.speech_decoder.llm_decoder.register_forward_hook(
        lambda mod, args, out: logits.append(out.float()))
    try:
        tokens, state = model.stream_decode_chunk(state, steps)
    finally:
        hook.remove()
    return tokens, state, torch.stack(logits)


def resume_check(model, syn_in, gumbel):
    """A stream resumed after its first chunk (re-prefill + the replay of
    its 16 tokens) against the uninterrupted stream, over the next chunk
    of 50: the S3 logits on their shared history, relative to max |logit|
    (the replay writes K / V through cuBLAS and the unfused FFN, the steps
    through the one-row kernels: bf16 rounding apart, not bit for bit); and,
    as the check's reach, the first step resumed from the same tokens
    replayed out of order (rolled by one)."""
    spk, taste, ids, lens, words = syn_in
    fc, c = STREAM["first_chunk_tokens"], STREAM["chunk_tokens"]
    state = model.stream_synth_init(spk, taste, ids, lens, words, MAX_SPEECH,
                                    {"gumbel": gumbel})
    first, state = model.stream_decode_chunk(state, fc)
    tok_u, _, lg_u = recorded_s3_chunk(model, state, c)
    aue = model.spoken_lm.get_audio_embeds_from_taste(model._cb(), lens,
                                                      words, taste)

    def resume(committed):
        hist = torch.zeros((B, MAX_SPEECH), dtype=torch.long,
                           device=spk.device)
        hist[:, :fc] = committed.clamp(min=0)
        return recorded_s3_chunk(model, model.speech_decoder
                                 .generate_stream_resume(
                                     spk, aue, lens, ids, lens, hist, fc,
                                     max_steps=MAX_SPEECH, gumbel=gumbel), c)
    tok_r, _, lg_r = resume(first)
    # the check's reach: the committed tokens replayed out of order move
    # the first resumed step's logits past the tolerance
    lg_x = resume(first.roll(1, dims=1))[2]
    reach = ((lg_x[0] - lg_u[0]).abs().max() / lg_u[0].abs().max()).item()
    steps = min(len(lg_u), len(lg_r))
    parted = (tok_u[0, :steps] != tok_r[0, :steps]).nonzero()
    shared = steps if len(parted) == 0 else int(parted[0]) + 1
    rel = ((lg_r[:shared] - lg_u[:shared]).abs().max()
           / lg_u[:shared].abs().max()).item()
    agree = (tok_u[0, :steps] == tok_r[0, :steps]).float().mean().item()
    return {"logit_rel_err": rel, "shared_steps": shared,
            "token_agreement": agree, "rolled_history_rel_err": reach}


def window_parity(model, cfg: TasteConfig, tokens, spk, gen) -> dict:
    """The flow over one window of each size the stream vocodes (its first
    16, 75 and 471 tokens at 32, 134 and 816 frames): mel - z with kernels
    against the plain versions for one start noise z."""
    flow = model.voice_generator.flow
    mpt = streaming.mel_per_token(cfg.flow)
    lc = STREAM["left_ctx_tokens"]
    out = {}
    for n_tok in (STREAM["first_chunk_tokens"],) + tuple(
            c + lc for c in STREAM["chunk_schedule"]):
        mw = int(np.ceil(n_tok * mpt)) + 4
        if n_tok == STREAM["first_chunk_tokens"]:
            check(mw == streaming.StreamingSynthesizer(
                model, **STREAM)._geometry(n_tok)[3], "first window size")
        win = tokens[:, :n_tok].clamp(min=0)
        lengths = torch.full((B,), win.shape[1], device=spk.device)
        z = torch.randn((B, mw, cfg.flow.output_size), generator=gen,
                        device=spk.device)
        mel_k = flow.inference(win, lengths, spk, mw, z=z)[0]
        model.set_use_kernels(False)
        mel_p = flow.inference(win, lengths, spk, mw, z=z)[0]
        model.set_use_kernels(True)
        valid = flow.mel_lengths(lengths).clamp(max=mw)
        rel = increment_err(mel_k, mel_p, z, valid)[1]
        check(rel <= 2e-2, f"streaming: flow mel rel err {rel} > 2e-2 on "
                           f"mel - z at a {mw}-frame window")
        out[mw] = rel
    return out


@torch.no_grad()
def streaming_path(model, cfg: TasteConfig, x, lm, scfg, tables, gen, run,
                   profile: bool):
    """The streaming path on the int8 model, at the bench's geometry
    (STREAM, PIPELINE) with the completion's taste rows, sampler and 128-
    token asr buffers: StreamingSynthesizer and CompletionStreamer driven
    directly, as TasteEngine's token buckets (16 / 32 / 64) and its fixed
    chunking do not fit that geometry; TasteEngine's own entry points run
    once each at its geometry.  -> ([{kernel: {shape: launches}}] and
    [launch counts], one for each counted stream)."""
    idx, dec = run
    dev = idx.device
    spk = x["speaker_embeds"]
    taste, ids, lens, words = synth_batch(cfg, dec, dev)
    syn_in = (spk, taste, ids, lens, words)
    pipe_in = (spk, idx, lm["llm_token_ids"], lm["llm_token_lengths"],
               lm["llm_word_ids"], ids, words)
    syn = streaming.StreamingSynthesizer(model, **STREAM)
    pipe = streaming.CompletionStreamer(model, scfg, tables, **STREAM,
                                        **PIPELINE)
    mpt = streaming.mel_per_token(cfg.flow)
    vocab = cfg.speech_decoder.speech_token_size
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t_path = time.perf_counter()

    def drain(streamer, *args, **kw):
        t0 = time.perf_counter()
        chunks = list(streamer.stream(*args, **kw))
        return chunks, time.perf_counter() - t0

    def first_chunk_s(streamer, *args, **kw):
        t0 = time.perf_counter()
        it = streamer.stream(*args, **kw)
        first = next(it)
        dt = time.perf_counter() - t0
        it.close()
        check(first["n_new"] > 0, "streaming: an empty first chunk")
        return dt

    # warm-up (cuBLAS plans at the windows' shapes), then the counted
    # stream of the same seed: the same tokens
    warm, _ = drain(syn, 7, *syn_in)
    reset_launch_counts()
    chunks, syn_wall = drain(syn, 7, *syn_in)
    syn_counts = launch_counts()
    syn_ran = chunks[-1]["ran"]
    syn_launches = stream_launches(cfg, model, syn_ran, jd=False)
    check_counts(syn_counts, {k: sum(v.values())
                              for k, v in syn_launches.items()},
                 "streaming synthesis")
    tok = np.concatenate([c["tokens"] for c in chunks], axis=1)
    check(np.array_equal(tok, np.concatenate([c["tokens"] for c in warm],
                                             axis=1)),
          "streaming: one seed gave two token streams")
    check(chunks[-1]["is_last"], "streaming: the last chunk is not last")
    spf = int(np.prod(cfg.hift.upsample_rates)) * cfg.hift.istft_hop_len
    syn_seams = seam_check(chunks, spf, mpt, "streaming synthesis")

    # the stream against synthesize_from_taste on one drawn S3 gumbel
    gumbel = gumbel_noise((MAX_SPEECH, B, vocab + 1), gen, dev)
    offline = model.synthesize_from_taste(*syn_in,
                                          max_speech_steps=MAX_SPEECH,
                                          mel_len_max=MEL_LEN_MAX,
                                          gumbel=gumbel)
    drawn, _ = drain(syn, 7, *syn_in, draws={"s3_gumbel": gumbel})
    tok_d = np.concatenate([c["tokens"] for c in drawn], axis=1)
    n_off = int(offline["speech_token_lengths"][0])
    off = offline["speech_token_ids"][0, :n_off].cpu().numpy()
    check(np.array_equal(tok_d[tok_d >= 0], off),
          f"streaming: the stream's {int((tok_d >= 0).sum())} tokens differ "
          f"from synthesize_from_taste's {n_off} on one S3 gumbel")

    stream_firsts = [first_chunk_s(syn, 20 + i, *syn_in) for i in range(3)]

    # the pipelined completion: a warm-up, the counted stream, first audio
    # five times and the whole stream three times
    drain(pipe, 30, *pipe_in, max_steps=LM_STEPS)
    reset_launch_counts()
    pchunks, _ = drain(pipe, 31, *pipe_in, max_steps=LM_STEPS)
    pipe_counts = launch_counts()
    pipe_ran = pchunks[-1]["ran"]
    pipe_launches = stream_launches(cfg, model, pipe_ran, jd=True)
    check_counts(pipe_counts, {k: sum(v.values())
                               for k, v in pipe_launches.items()},
                 "pipelined completion")
    check(bool(pchunks) and pchunks[-1]["is_last"] and pchunks[-1]["jd_done"],
          "pipelined: the stream did not end with the joint decode done")
    n_words = [c["n_words"] for c in pchunks]
    check(n_words == sorted(n_words), f"pipelined: n_words fell: {n_words}")
    ptok = np.concatenate([c["tokens"] for c in pchunks], axis=1)
    live = ptok[ptok >= 0]
    check(live.size > 0 and bool((live < vocab).all()),
          "pipelined: committed tokens outside the speech vocabulary")
    pipe_seams = seam_check(pchunks, spf, mpt, "pipelined completion")
    ttfa = [first_chunk_s(pipe, 40 + i, *pipe_in, max_steps=LM_STEPS)
            for i in range(5)]
    full = [drain(pipe, 50 + i, *pipe_in, max_steps=LM_STEPS)
            for i in range(3)]
    walls_e2e = [w for _, w in full]
    audio = [sum(c["wav"].shape[1] for c in ch) / cfg.hift.sampling_rate
             for ch, _ in full]
    rtfs = [w / a for w, a in zip(walls_e2e, audio)]
    check(min(audio) > MIN_STREAM_AUDIO_S,
          f"pipelined: degenerate streams {audio} s")
    # the same request served offline: first audio after the whole joint
    # decode and the whole synthesis, three times
    offline_walls = [complete(model, cfg, x, lm, scfg, tables, gen)[3]
                     for _ in range(3)]
    offline_ttfa = [w["joint_decode_s"] + w["synthesis_s"]
                    for w in offline_walls]

    resume = resume_check(model, syn_in, gumbel)
    check(resume["logit_rel_err"] <= LOGIT_TOL,
          f"streaming: a resumed stream's S3 logits {resume['logit_rel_err']} "
          f"from the uninterrupted stream's (relative), > {LOGIT_TOL}")
    check(resume["rolled_history_rel_err"] > LOGIT_TOL,
          "streaming: the resume check is blind: a history replayed out of "
          f"order moves the logits only {resume['rolled_history_rel_err']}")
    windows = window_parity(model, cfg, torch.from_numpy(tok).to(dev), spk,
                            gen)

    # TasteEngine's entry points at its own geometry (token buckets 16 / 32
    # / 64, chunks of 50, 128 S3 steps)
    engine = TasteEngine(model, cfg)
    engine._tables = tables
    asr = x["asr_token_ids"][0].tolist()
    asr_words = x["asr_word_ids"][0].tolist()
    got = engine.tokenize(x["audio_features"][0].cpu().numpy(), asr,
                          asr_words)
    ref = model.audio_tower(x["audio_features"], x["asr_token_ids"],
                            x["asr_token_lengths"], x["asr_word_ids"]
                            )["quantized_indices"][0].cpu().numpy()
    # the engine pads the 40 tokens to its 64-token bucket
    tok_agree = float((got == ref).mean()) if got.shape == ref.shape else 0.0
    check(tok_agree >= 0.99, f"engine: tokenize agrees {tok_agree} with the "
                             "unpadded tower, < 0.99")
    n_taste = max(int(dec["num_taste_words"][0]), 1)
    e_syn = list(engine.synthesize_stream(
        taste[0, :n_taste].cpu().numpy(), asr, asr_words,
        spk[0].cpu().numpy(), seed=3))
    e_pipe = list(engine.complete_stream(
        lm["llm_token_ids"][0].tolist(), lm["llm_word_ids"][0].tolist(),
        idx[0].cpu().numpy(), ids[0, :64].tolist(), words[0, :64].tolist(),
        spk[0].cpu().numpy(), {k_: v for k_, v in scfg._asdict().items()
                               if k_ != "delay"}, seed=3))
    for what, out in (("synthesize_stream", e_syn),
                      ("complete_stream", e_pipe)):
        check(bool(out) and out[-1][1] and all(
            np.isfinite(c[0]).all() for c in out),
            f"engine: {what} gave no finite stream ending in is_last")
    e_wav, e_sr, e_tok, e_rtf = engine.reconstruct(
        x["audio_features"][0].cpu().numpy(), asr, asr_words,
        spk[0].cpu().numpy(), 128, 3)
    check(e_tok > 0 and e_sr == cfg.hift.sampling_rate and e_wav.size > 0
          and bool(np.isfinite(e_wav).all()),
          f"engine: reconstruct gave {e_tok} tokens, {e_wav.size} samples "
          f"at {e_sr} Hz")

    result = {
        "stream_first_s": statistics.median(stream_firsts),
        "stream_first_s_runs": stream_firsts,
        "ttfa_p50_s": statistics.median(ttfa), "ttfa_runs_s": ttfa,
        "pipelined_wall_s": statistics.median(walls_e2e),
        "pipelined_wall_runs_s": walls_e2e,
        "pipelined_audio_s": statistics.median(audio),
        "pipelined_rtf": statistics.median(rtfs),
        "pipelined_rtf_spread": [min(rtfs), max(rtfs)],
        "nonstreaming_ttfa_s": statistics.median(offline_ttfa),
        "nonstreaming_ttfa_runs_s": offline_ttfa,
        "synthesis_stream_wall_s": syn_wall,
        "synthesis": {**syn_seams, "ran": syn_ran},
        "pipelined": {**pipe_seams, "ran": pipe_ran, "n_words": n_words,
                      "first_chunk_tokens": pchunks[0]["n_new"]},
        "offline_tokens_equal": True, "s3_tokens": n_off,
        "resume": resume, "window_mel_rel_err": windows,
        "engine": {"tokenize_agreement": tok_agree,
                   "synthesize_stream_chunks": len(e_syn),
                   "complete_stream_chunks": len(e_pipe),
                   "complete_stream_words": e_pipe[-1][3],
                   "reconstruct_tokens": e_tok,
                   "reconstruct_samples": int(e_wav.size),
                   "reconstruct_rtf": e_rtf},
        "path_wall_s": time.perf_counter() - t_path,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": {"synthesis": syn_counts, "pipelined": pipe_counts}}
    log({"streaming": result})
    log(f"streaming: first audio {result['stream_first_s']:.3f} s "
        f"(synthesis), {result['ttfa_p50_s']:.3f} s (pipelined completion) "
        f"against {result['nonstreaming_ttfa_s']:.3f} s non-streaming; "
        f"pipelined RTF {result['pipelined_rtf']:.3f}")
    if profile:
        log({"pipelined_device_profile": device_profile(
            lambda: drain(pipe, 50, *pipe_in, max_steps=LM_STEPS),
            walls_e2e[0])})
    return [syn_launches, pipe_launches], [syn_counts, pipe_counts]


# ---------------------------------------------------------------------------
# serving: the front end, the batched joint decode, the load test, HTTP and
# the checkpoint round trip
# ---------------------------------------------------------------------------

SERVE_STEPS = 32               # the load test's decode budget (bench.py:1185)
SERVE_NB = (1, 4, 16)          # batched decodes held against solo runs
SOLO_ROWS = (0, 1, 2, 3, 15)   # the rows each batch holds against its solo run
# bench.py:1166-1202: the load test's sampler, 16 requests of 40 tokens
LOAD_KW = dict(extra_words=8, text_top_p=0.3, taste_top_p=0.0,
               text_temperature=0.5, repetition_penalty=1.1)
LOAD_N, LOAD_WINDOW_MS = 16, 200.0
ASR_TOKENS = 64
HTTP_S3_STEPS = 64             # /reconstruct's default budget


class WordTokenizer:
    """A deterministic stand-in tokenizer (the process's hash() is salted):
    one id a word from its characters."""

    def __init__(self, base: int):
        self.base = base

    def encode(self, word, add_special_tokens=False):
        return [self.base + sum(map(ord, word)) % 997]


def processor_check(cfg: TasteConfig, dev):
    """TasteProcessor on a seeded 6 s wav at 24 kHz with stubbed hooks
    (an x-vector from the fbank's statistics, S3 ids from the frame count,
    a fixed transcript): it resamples to 16 kHz, takes the whisper log-mel
    and the speaker fbank; -> (its output, wall seconds, the fbank shapes
    the speaker hook saw)."""
    rng = np.random.RandomState(4)
    sr, secs = 24000, 6.0
    tt = np.arange(int(sr * secs)) / sr
    wav = (0.3 * np.sin(2 * np.pi * 150.0 * tt * (1 + 0.05 * np.sin(tt)))
           + 0.02 * rng.randn(tt.size)).astype(np.float32)
    seen = []

    def embed(feats):
        seen.append(feats.shape)
        return np.resize(np.concatenate([feats.std(axis=(0, 1)),
                                         feats.mean(axis=(0, 1))]), 192)
    proc = TasteProcessor(
        asr_tokenizer=WordTokenizer(100), llm_tokenizer=WordTokenizer(2000),
        speaker_embedder=embed,
        s3_tokenizer=lambda mel, n: np.arange(int(n) // 2) % 4096,
        transcriber=lambda audio: "a seeded sine for the serving path",
        frontend=cfg.frontend, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = proc(wav, sr, ref_audio_list=[wav[: 2 * sr], wav[2 * sr: 5 * sr]])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n16 = int(np.ceil(wav.size * 16000 / sr))
    check(out["audio_features"].shape == (1, cfg.frontend.n_mels, 3000)
          and bool(np.isfinite(out["audio_features"]).all()),
          f"processor: mel {out['audio_features'].shape}")
    check(int(out["audio_feature_lengths"][0]) == n16 // 160,
          f"processor: {out['audio_feature_lengths']} mel frames of {n16} "
          "samples at 16 kHz")
    check(seen == [(1, 1 + (2 * sr - 400) // 160, 80),
                   (1, 1 + (3 * sr - 400) // 160, 80)],
          f"processor: the speaker hook saw fbanks {seen}")
    spk = out["speaker_embeds"]
    check(spk.shape == (1, 192) and bool(np.isfinite(spk).all())
          and abs(float(np.linalg.norm(spk)) - 1.0) < 1e-5,
          f"processor: speaker embedding {spk.shape}, norm "
          f"{np.linalg.norm(spk)}")
    check(out["speech_token_ids"].shape == (1, n16 // 160 // 2)
          and out["llm_token_ids"].shape == out["asr_token_ids"].shape
          == (1, 7), "processor: token shapes")
    return out, wall, seen


def asr_check(model, mel):
    """WhisperForASR over the tower's encoder and decoder, greedy through
    transcribe_with_fallback (one rung, ASR_TOKENS), with the kernels
    (counted) and with their plain versions.  -> (tokens, counts of the
    kernel run, its wall, the parting step, the largest logit difference
    on the shared history relative to max |logit|, steps)."""
    asr = WhisperForASR.from_tower(model.audio_tower)
    table = asr.decoder.embed_tokens.weight.float()

    def set_kernels(flag):
        for m in asr.modules():
            if hasattr(m, "use_kernels"):
                m.use_kernels = flag

    def run(kernels: bool):
        set_kernels(kernels)
        hidden = []
        hook = asr.decoder.register_forward_hook(
            lambda mod, args, out: hidden.append(out[0][:, -1].float()))
        try:
            torch.cuda.synchronize()
            reset_launch_counts()
            t0 = time.perf_counter()
            toks, lp, _ = transcribe_with_fallback(
                lambda m, n, temp, g: asr(m, max_tokens=n, temperature=temp,
                                          generator=g),
                mel, max_tokens=ASR_TOKENS, temperatures=(0.0,))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = launch_counts()
        finally:
            hook.remove()
            set_kernels(True)
        steps = len(hidden) - 1            # the prefill, then one a step
        toks = torch.from_numpy(toks).to(mel.device)
        return (toks, lp, torch.stack(hidden[:steps]) @ table.T, wall,
                counts)

    tok_k, lp_k, lg_k, wall, counts = run(True)
    tok_p, _, lg_p, _, counts_p = run(False)
    check(not any(counts_p.values()),
          f"asr: the plain run launched kernels {counts_p}: the comparison "
          "would hold the kernels against themselves")
    s = min(len(lg_k), len(lg_p))
    first, rel, _ = parting((lg_k[:s, 0], tok_k[0, :s, None]),
                            (lg_p[:s, 0], tok_p[0, :s, None]))
    check(rel > 0, "asr: kernel and plain logits are identical; the plain "
                   "run did not reach the plain versions")
    check(bool(np.isfinite(lp_k).all()) and tok_k.shape == (1, ASR_TOKENS),
          f"asr: tokens {tuple(tok_k.shape)}, logprob {lp_k}")
    return tok_k, counts, wall, first, rel, len(lg_k)


def load_requests(cfg: TasteConfig, lm, idx):
    """bench.py:1166-1180: LOAD_N prompts of 40 random llm ids (a seeded
    RandomState(3)) with the prompt's word ids and taste rows, seeds
    17 i + 1."""
    rng = np.random.RandomState(3)
    vocab = cfg.spoken_lm.llama.vocab_size
    words = lm["llm_word_ids"][0].tolist()
    rows = idx[0].cpu().numpy()
    return [dict(llm_ids=(rng.randint(100, 120000, T_TOK) % vocab).tolist(),
                 llm_word_ids=words, llm_indices=rows, seed=17 * i + 1)
            for i in range(LOAD_N)]


def batch_launches(cfg: TasteConfig, rans) -> dict:
    """{kernel: {shape: launches}} of batched joint decodes from their
    records: per call and Llama layer one gated MLP over the prefill's
    nb x prefix rows (within FUSED_MLP_MAX_ROWS; above it the unfused
    math) and one over nb rows a step; the tied head once a step over nb
    rows."""
    llama = cfg.spoken_lm.llama
    h, i, n_layers = (llama.hidden_size, llama.intermediate_size,
                      llama.num_hidden_layers)
    out = {"gated_mlp_int8": {}, "matmul_int4": {}}

    def add(kernel, key, n):
        if n:
            out[kernel][key] = out[kernel].get(key, 0) + n
    for ran in rans:
        add("gated_mlp_int8", (ran["nb"], h, i), n_layers * ran["steps"])
        if ran["prefill_rows"] <= FUSED_MLP_MAX_ROWS:
            add("gated_mlp_int8", (ran["prefill_rows"], h, i), n_layers)
        add("matmul_int4", (ran["nb"], h, llama.vocab_size), ran["steps"])
    return out


def recon_launches(cfg: TasteConfig, model, n_frames: int, rows: int,
                   s3_len: int, max_steps: int, mel_len_max: int) -> dict:
    """{kernel: {shape: launches}} of one reconstruction: the tower's flash
    attention, the S3 prefill over `rows` rows and one row a step through
    every layer's ffn_int8, the fused DiT and the kernel convs over
    `mel_len_max` frames."""
    s3 = cfg.speech_decoder.llm
    mel_len = int(model.voice_generator.flow.mel_lengths(
        torch.tensor(s3_len)).clamp(max=mel_len_max))
    return {"flash_attention": flash_shapes(cfg, n_frames),
            "fused_dit_block": dit_shapes(cfg, mel_len, mel_len_max),
            "conv1d_same": conv_shapes(cfg, mel_len_max),
            "ffn_int8": {1: s3.num_blocks * min(s3_len + 1, max_steps),
                         rows: s3.num_blocks}}


def http_check(engine: TasteEngine, cfg: TasteConfig, model, x):
    """The HTTP server on a free localhost port: /health, /tokenize (equal
    to engine.tokenize), /reconstruct (PCM of its token count) and a 404,
    counted.  -> ({kernel: {shape: launches}}, counts, results)."""
    import base64
    import urllib.error
    import urllib.request
    server = create_http_server(engine, port=0, host="127.0.0.1")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"

    def post(path, payload):
        req = urllib.request.Request(
            url + path, data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as r:
            return json.load(r)
    mel = x["audio_features"][0].cpu().numpy()
    asr = x["asr_token_ids"][0].tolist()
    words = x["asr_word_ids"][0].tolist()
    spk = x["speaker_embeds"][0].cpu().numpy()
    try:
        reset_launch_counts()
        with urllib.request.urlopen(url + "/health", timeout=60) as r:
            health = json.load(r)
        t0 = time.perf_counter()
        tok = post("/tokenize", {"audio_features": mel.tolist(),
                                 "asr_token_ids": asr, "asr_word_ids": words})
        tokenize_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        rec = post("/reconstruct", {
            "audio_features": mel.tolist(), "asr_token_ids": asr,
            "asr_word_ids": words, "speaker_embedding": spk.tolist(),
            "max_speech_steps": HTTP_S3_STEPS, "seed": 5})
        reconstruct_s = time.perf_counter() - t0
        try:
            urllib.request.urlopen(url + "/nope", timeout=60)
            missing = 200
        except urllib.error.HTTPError as e:
            missing = e.code
        counts = launch_counts()
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    check(health == {"status": "ok"}, f"http: /health {health}")
    check(missing == 404, f"http: an unknown route gave {missing}")
    want = engine.tokenize(mel, asr, words)
    check(np.array_equal(np.asarray(tok["indices"]), want),
          "http: /tokenize differs from engine.tokenize")
    pcm = np.frombuffer(base64.b64decode(rec["pcm16_b64"]), "<i2")
    n_tok = rec["num_speech_tokens"]
    check(n_tok > 0 and pcm.size > 0 and rec["sample_rate"]
          == cfg.hift.sampling_rate and int(np.abs(pcm).max()) > 0,
          f"http: /reconstruct gave {n_tok} tokens, {pcm.size} samples")
    mel_len_max = max(32, int(np.ceil(HTTP_S3_STEPS / 50 * 22050 / 256)) + 8)
    launches = merge_launches(
        {"flash_attention": flash_shapes(cfg, mel.shape[-1])},
        recon_launches(cfg, model, mel.shape[-1], B * (3 + T_TOK), n_tok,
                       HTTP_S3_STEPS, mel_len_max))
    check_counts(counts, {k: sum(v.values()) for k, v in launches.items()},
                 "serving http")
    return launches, counts, {
        "tokenize_s": tokenize_s, "reconstruct_s": reconstruct_s,
        "reconstruct_tokens": n_tok, "reconstruct_samples": int(pcm.size),
        "reconstruct_rtf": rec["rtf"]}


def checkpoint_check(model):
    """save_pretrained of the int8 serving model, from_pretrained of the
    dir (strict, at the dtypes it was saved in), equal state dicts; the dir is removed.  -> seconds and
    sizes."""
    import shutil
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "serving_checkpoint")
    shutil.rmtree(path, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        save_pretrained(model, path)
        save_s = time.perf_counter() - t0
        n_bytes = sum(os.path.getsize(os.path.join(path, f))
                      for f in os.listdir(path))
        t0 = time.perf_counter()
        loaded, _ = from_pretrained(path, device=model.device)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        sa, sb = model.state_dict(), loaded.state_dict()
        check(sa.keys() == sb.keys(), "checkpoint: the loaded model's "
                                      "state dict has other keys")
        for k in sa:
            check(sa[k].dtype == sb[k].dtype and torch.equal(sa[k], sb[k]),
                  f"checkpoint: {k} differs after the round trip")
        n_tensors = len(sa)
        del loaded, sb
    finally:
        shutil.rmtree(path, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return {"save_s": save_s, "load_s": load_s, "bytes": n_bytes,
            "tensors": n_tensors}


def serving_path(model, cfg: TasteConfig, x, lm, scfg, tables, idx,
                 card: str, profile: bool):
    """The serving front end on the int8 model: TasteProcessor, the whisper
    ASR, TasteEngine's batched joint decode at nb = 1, 4, 16 (greedy and
    sampled, rows held against their solo runs), the B = 4 decode
    throughput, the micro-batcher's load test at bench.py's geometry, the
    HTTP server and the checkpoint round trip.  -> ([{kernel: {shape:
    launches}}] and [launch counts], one for each counted phase: the ASR,
    the batched decodes with the load tests, the HTTP requests)."""
    dev = idx.device
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t_path = time.perf_counter()

    proc, proc_s, fbanks = processor_check(cfg, dev)
    mel = torch.from_numpy(proc["audio_features"]).to(dev)
    asr_tok, asr_counts, asr_s, asr_parted, asr_rel, asr_steps = asr_check(
        model, mel)
    asr_launches = {"flash_attention": flash_shapes(cfg, mel.shape[-1])}
    check_counts(asr_counts, {k: sum(v.values())
                              for k, v in asr_launches.items()}, "asr")
    check(asr_rel <= LOGIT_TOL,
          f"asr: kernel-vs-plain logits {asr_rel} apart (relative to max "
          f"|logit|) on the shared history, > {LOGIT_TOL}")

    engine = TasteEngine(model, cfg, token_buckets=(T_TOK,))
    engine._tables = tables
    reqs = load_requests(cfg, lm, idx)
    ok = ~tables["banned"]
    rans = {}

    def batch(nb, kw, steps=SERVE_STEPS, requests=None):
        with DecodeRecorder(model) as rec:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = engine.complete_batch(requests or reqs[:nb], kw, steps)
            wall = time.perf_counter() - t0
        rans[res[0]["ran"]["call"]] = res[0]["ran"]
        return res, rec, wall

    reset_launch_counts()
    greedy_kw = dict(LOAD_KW, text_top_p=0.0)
    solo = {i: {kind: batch(1, kw, requests=[reqs[i]])
                for kind, kw in (("greedy", greedy_kw), ("sampled", LOAD_KW))}
            for i in SOLO_ROWS}
    batched, per_nb = {}, {}
    for nb in SERVE_NB:
        for kind, kw in (("greedy", greedy_kw), ("sampled", LOAD_KW)):
            res, rec, wall = batch(nb, kw)
            rows = {}
            for i in (r for r in SOLO_ROWS if r < nb):
                s_res, s_rec, _ = solo[i][kind]
                same = all(np.array_equal(res[i][k], s_res[0][k]) for k in (
                    "llm_token_ids", "taste_indices", "num_tokens"))
                first, rel, at = parting(rec.row(i), s_rec.row(0), ok)
                rows[i] = {"same_as_solo": same, "parted_at_step": first,
                           "shared_history_logit_rel_err": rel,
                           "at_parting": at}
                # the batch's row reads its solo run's logits on their
                # shared history; where it parts from it, that is at a
                # near-tie those logits decide within the tolerance
                check(rel <= LOGIT_TOL,
                      f"serving: nb={nb} {kind} row {i}: text logits {rel} "
                      f"from its solo run's on the shared history, > "
                      f"{LOGIT_TOL}")
                check(same or first is not None,
                      f"serving: nb={nb} {kind} row {i} differs from its "
                      "solo run with the same decisions at every step")
            check(all(int(r["num_tokens"]) > 0 for r in res),
                  f"serving: nb={nb} {kind}: a row emitted no token")
            batched[(nb, kind)] = rows
            if kind == "sampled":
                steps = res[0]["ran"]["steps"]
                per_nb[nb] = {"wall_s": wall, "steps": steps,
                              "ms_per_step": 1e3 * wall / steps,
                              "tokens": sum(int(r["num_tokens"]) for r in res)}

    # bench.py:1132-1160: B = 4 rows of the completion's prompt (ids
    # shifted by the run), the completion's sampler and budget; the best of
    # three after a warm-up
    comp_kw = {k: v for k, v in scfg._asdict().items()
               if k not in ("delay", "delay_level", "stop_id", "has_prefix")}
    walls4 = []
    for run in range(4):
        ids = ((lm["llm_token_ids"][0] + run) % cfg.spoken_lm.llama.vocab_size
               ).tolist()
        res, _, wall = batch(4, comp_kw, LM_STEPS, [
            dict(reqs[0], llm_ids=ids, seed=300 + 4 * run + j)
            for j in range(4)])
        if run:
            walls4.append(wall)
    b4_tokens = sum(int(r["num_tokens"]) for r in res)

    # the load test: a warm-up, then the counted run
    load = {}
    for what in ("warm_up", "counted"):
        load[what] = run_load_test(engine, reqs, LOAD_KW,
                                   max_steps=SERVE_STEPS, max_batch=LOAD_N,
                                   window_ms=LOAD_WINDOW_MS)
        for r in load[what]["results"]:
            rans[r["ran"]["call"]] = r["ran"]
    counted = load["counted"]
    check(all(int(r["num_tokens"]) > 0 for r in counted["results"]),
          "serving: a load-test request emitted no token")
    dec_counts = launch_counts()
    dec_launches = batch_launches(cfg, rans.values())
    check_counts(dec_counts, {k: sum(v.values())
                              for k, v in dec_launches.items()},
                 "serving batched decodes")
    load_calls = sorted({r["ran"]["call"]: r["ran"]["nb"]
                         for r in counted["results"]}.items())

    http_launches, http_counts, http = http_check(engine, cfg, model, x)
    ckpt = checkpoint_check(model)

    result = {
        "card": card,
        "serving_p50_ms": counted["p50_ms"],
        "serving_p99_ms": counted["p99_ms"],
        "serving_max_ms": counted["max_ms"],
        "serving_tokens_per_sec": counted["tokens_per_sec"],
        "serving_wall_s": counted["wall_s"],
        "serving_total_tokens": counted["total_tokens"],
        "load_calls_nb": [nb for _, nb in load_calls],
        "warm_up_p50_ms": load["warm_up"]["p50_ms"],
        "decode_tokens_per_sec_b4": b4_tokens / min(walls4),
        "b4_walls_s": walls4, "b4_tokens": b4_tokens,
        "batched": {str(nb): v for nb, v in per_nb.items()},
        "rows_vs_solo": {f"{nb}_{kind}": rows
                         for (nb, kind), rows in batched.items()},
        "processor_s": proc_s, "processor_fbanks": fbanks,
        "asr_wall_s": asr_s, "asr_steps": asr_steps,
        "asr_parted_at_step": asr_parted,
        "asr_shared_history_logit_rel_err": asr_rel,
        "asr_tokens": asr_tok[0, :8].tolist(),
        "http": http, "checkpoint": ckpt,
        "decode_calls": len(rans),
        "path_wall_s": time.perf_counter() - t_path,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": {"asr": asr_counts, "batched": dec_counts,
                     "http": http_counts}}
    log({"serving": result})
    log(f"serving ({card}): p50 {result['serving_p50_ms']:.1f} ms, p99 "
        f"{result['serving_p99_ms']:.1f} ms, "
        f"{result['serving_tokens_per_sec']:.1f} tok/s ({LOAD_N} requests, "
        f"{SERVE_STEPS} steps); B=4 decode "
        f"{result['decode_tokens_per_sec_b4']:.1f} tok/s; ms a step at "
        "nb = 1 / 4 / 16: " + " / ".join(
            f"{per_nb[nb]['ms_per_step']:.2f}" for nb in SERVE_NB)
        + f"; ASR {asr_s:.3f} s; path {result['path_wall_s']:.1f} s, peak "
        f"{result['peak_mem_gb']:.2f} GB")
    if profile:
        log({"batched_decode_device_profile": device_profile(
            lambda: engine.complete_batch(reqs, LOAD_KW, SERVE_STEPS),
            per_nb[16]["wall_s"])})
    return ([asr_launches, dec_launches, http_launches],
            [asr_counts, dec_counts, http_counts])


# ---------------------------------------------------------------------------
# the stage-1 training step
# ---------------------------------------------------------------------------

TRAIN_B, TRAIN_TOK, TRAIN_SPEECH, TRAIN_MEL = 8, 96, 1500, 3000
TRAIN_GROUPS = {           # each trainable group and a prefix of its names
    "whisper decoder": "audio_tower.audio_joint_encoder_segmenter."
                       "audio_segmenter.decoder.",
    "vq projections": "audio_tower.vq.rvq.project_",
    "S3 text encoder": "speech_decoder.text_encoder.",
    "S3 audio encoder": "speech_decoder.audio_token_encoder.",
    "S3 llm stack": "speech_decoder.llm.",
    "S3 head": "speech_decoder.llm_decoder."}
ENCODER = "audio_tower.audio_joint_encoder_segmenter.audio_encoder."


def stage1_batch(cfg: TasteConfig, dev, seed: int) -> dict:
    """bench.py:222-238: B rows of 30 s, 96 asr tokens at 2 per word, 1500
    S3 tokens, random from `seed`."""
    r = np.random.RandomState(seed)
    words = np.minimum(np.arange(TRAIN_TOK) // 2, TRAIN_TOK - 1)
    vocab = cfg.audio_tower.whisper.vocab_size
    n = lambda x: torch.from_numpy(np.asarray(x)).to(dev)  # noqa: E731
    return {
        "speaker_embeds": n(r.randn(TRAIN_B, cfg.speech_decoder.spk_embed_dim)
                            .astype(np.float32)),
        "asr_token_ids": n(r.randint(100, 20000, (TRAIN_B, TRAIN_TOK)) % vocab),
        "asr_token_lengths": n([TRAIN_TOK] * TRAIN_B),
        "asr_word_ids": n(words[None].repeat(TRAIN_B, 0)),
        "audio_features": n((r.randn(TRAIN_B, cfg.audio_tower.whisper.n_mels,
                                     TRAIN_MEL) * 0.3).astype(np.float32)),
        "speech_token_ids": n(r.randint(0, cfg.speech_decoder.speech_token_size,
                                        (TRAIN_B, TRAIN_SPEECH))),
        "speech_token_lengths": n([TRAIN_SPEECH] * TRAIN_B)}


def train_launches(cfg: TasteConfig, steps: int) -> dict:
    """{kernel: {shape: launches}} of `steps` stage-1 steps, from the
    config: the frozen whisper encoder's self-attention once a layer (under
    no_grad, not recomputed); the S3 llm stack's rel-pos attention over
    [sos | spk | T_tok | task | S3] twice a layer (the forward, and its
    recompute under per-layer remat in the backward) and its backward once.
    The text and audio encoders run at T = 96 < 256, off the kernel."""
    s3 = cfg.speech_decoder.llm
    t = 3 + TRAIN_TOK + TRAIN_SPEECH
    dk = s3.output_size // s3.attention_heads
    check(relpos_attention.can_use_relpos_flash(t, dk)
          and not relpos_attention.can_use_relpos_flash(TRAIN_TOK, dk),
          "the training shapes are not the relpos kernel's")
    key = (TRAIN_B, t, s3.attention_heads, dk, "bfloat16")
    flash = flash_shapes(cfg, TRAIN_MEL, TRAIN_B, "bfloat16")
    return {"flash_attention": {k: v * steps for k, v in flash.items()},
            "relpos_causal_attention": {key: 2 * s3.num_blocks * steps},
            "relpos_causal_attention_bwd": {key: s3.num_blocks * steps}}


def train_grads(model, batch, names, use_kernels: bool, seed: int = 7):
    """One forward + backward of the stage-1 loss (the RVQ's draws from a
    generator seeded `seed`) -> (loss, global grad norm, {name: grad})."""
    dev = batch["speaker_embeds"].device
    model.set_use_kernels(use_kernels)
    for p in model.parameters():
        p.grad = None
    out = model.forward_speech_autoencoder(
        *(batch[k] for k in train_step.BATCH_KEYS), train=True,
        generator=torch.Generator(device=dev).manual_seed(seed))
    out["loss"].backward()
    params = dict(model.named_parameters())
    norm = optim.global_norm([p.grad for p in params.values()
                              if p.grad is not None]).item()
    grads = {n: params[n].grad.float().clone() for n in names}
    model.set_use_kernels(True)
    for p in model.parameters():
        p.grad = None
    return out["loss"].item(), norm, grads


def train_path(dev, profile: bool):
    """The stage-1 step at full width (bench.py:186-300): bf16, per-layer
    remat, the rvq phase (whisper encoder frozen), Adam lr 1e-4 clipped at
    5, B = 8 x 30 s.  One warm-up step, three counted ones with exact
    launch counts, then the checks.  -> ({kernel: {shape: launches}}, the
    counts over the three steps)."""
    float_cfg, _ = configs()
    cfg = apply_remat(float_cfg, True)
    t0 = time.perf_counter()
    with torch.device(dev):
        model = TasteForCausalLM(cfg, dtype=torch.bfloat16, device=dev)
    # the same float weights as the serving models: the first draws of a
    # generator seeded 0, in the same order
    model.load_state_dict(random_state_dict(
        model, torch.Generator(device=dev).manual_seed(0)), strict=True)
    mask = optim.trainable_mask(model, optim.STAGE1_PHASES["rvq"])
    opt = optim.make_optimizer(model, 1e-4, mask=mask, grad_clip=5.0)
    step = train_step.make_stage1_step(model, opt, trainable_mask=mask)
    params = dict(model.named_parameters())
    frozen_enc = {n: p.detach().clone() for n, p in params.items()
                  if n.startswith(ENCODER)}
    check(frozen_enc and not any(mask[n] for n in frozen_enc),
          "the whisper encoder is not frozen in the rvq phase")
    before = {n: p.detach().clone() for n, p in params.items() if mask[n]}
    rvq = model.audio_tower.vq.rvq
    ema_before = {k: v.clone() for k, v in rvq.state_dict().items()
                  if k.endswith("embed")}
    k_codes = cfg.audio_tower.quantizer.codebook_size
    seen = []
    hook = rvq.register_forward_hook(
        lambda mod, args, out: seen.append(out["quantized_indices"]))
    torch.cuda.synchronize()
    log({"train_model_init_s": time.perf_counter() - t0,
         "trainable_params": sum(p.numel() for n, p in params.items()
                                 if mask[n]),
         "params": sum(p.numel() for p in params.values())})

    warm = stage1_batch(cfg, dev, 0)
    metrics = step(warm)
    float(metrics["loss"])
    batches = [stage1_batch(cfg, dev, i + 1) for i in range(3)]
    per_step = train_launches(cfg, 1)
    torch.cuda.reset_peak_memory_stats()
    walls, runs, all_counts = [], [], []
    for bt in batches:
        reset_launch_counts()
        t0 = time.perf_counter()
        m = step(bt)
        loss = float(m["loss"])
        walls.append(time.perf_counter() - t0)
        counts = launch_counts()
        check_counts(counts, {k: sum(v.values()) for k, v in per_step.items()},
                     "stage-1 step")
        row = {k: float(v) for k, v in m.items()}
        check(all(np.isfinite(v) for v in row.values()),
              f"stage-1 step: non-finite metrics {row}")
        runs.append(row)
        all_counts.append(counts)
        del loss
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    hook.remove()
    for idx in seen:
        check(bool(((idx >= -1) & (idx < k_codes)).all())
              and bool((idx[..., 0] >= 0).all()),
              "stage-1 step: taste indices out of range")
    params = dict(model.named_parameters())
    check(all(torch.equal(params[n], v) for n, v in frozen_enc.items()),
          "stage-1 step: the frozen whisper encoder moved")
    groups = {}
    for group, prefix in TRAIN_GROUPS.items():
        names = [n for n in before if n.startswith(prefix)]
        groups[group] = sum(not torch.equal(params[n], before[n])
                            for n in names)
        check(names and groups[group] > 0,
              f"stage-1 step: the trainable group {group!r} did not move")
    ema_moved = {k: not torch.equal(rvq.state_dict()[k], v)
                 for k, v in ema_before.items()}
    check(all(ema_moved.values()),
          f"stage-1 step: codebook EMA buffers did not move: {ema_moved}")
    wall = min(walls)
    counts = {k: sum(c[k] for c in all_counts) for k in all_counts[0]}
    log({"stage1_train": {
        "batch": f"{TRAIN_B}x30s", "step_walls_s": walls, "step_s": wall,
        "frames_per_s": TRAIN_B * TRAIN_MEL / wall,
        "audio_s_per_s": TRAIN_B * 30.0 / wall, "peak_mem_gb": peak_gb,
        "metrics": runs, "moved_tensors": groups,
        "launches_per_step": all_counts[0]}})
    del before, frozen_enc

    # the same state and batch, one step's gradients with the kernels and
    # with the plain versions (the RVQ's EMA update restored in between)
    s3 = "speech_decoder.llm.encoders.0.self_attn."
    names = [s3 + w for w in ("linear_pos.weight", "linear_q.weight",
                              "linear_k.weight")]
    buffers = {k: v.clone() for k, v in rvq.state_dict().items()}
    opt.zero_grad()
    loss_k, norm_k, g_k = train_grads(model, batches[0], names, True)
    rvq.load_state_dict(buffers)
    loss_p, norm_p, g_p = train_grads(model, batches[0], names, False)
    rvq.load_state_dict(buffers)
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    norm_rel = abs(norm_k - norm_p) / norm_p
    grad_rel = {n.split(".")[-2]: ((g_k[n] - g_p[n]).abs().max()
                                   / g_p[n].abs().max()).item() for n in names}
    log({"stage1_kernels_vs_plain": {
        "rows": TRAIN_B, "loss": [loss_k, loss_p], "loss_rel_err": loss_rel,
        "grad_norm": [norm_k, norm_p], "grad_norm_rel_err": norm_rel,
        "llm_layer0_grad_rel_err": grad_rel}})
    check(loss_rel <= 1e-3, f"stage-1 loss kernels vs plain {loss_rel} > 1e-3")
    check(norm_rel <= 2e-2, f"stage-1 grad norm kernels vs plain {norm_rel} "
                            "> 2e-2")
    for n, e in grad_rel.items():
        check(e <= 2e-2, f"stage-1 {n} gradient kernels vs plain {e} > 2e-2")
    if profile:
        log({"stage1_train_device_profile": device_profile(
            lambda: step(batches[1]), wall)})
    del model, opt, step
    gc.collect()
    torch.cuda.empty_cache()
    return train_launches(cfg, len(batches)), counts


# ---------------------------------------------------------------------------
# the training harness: the Trainer, a checkpoint round trip, the train CLI
# ---------------------------------------------------------------------------

HARNESS_DIR = os.path.join("build", "train_harness")
HARNESS_STEPS = 4
CLI_TIMEOUT_S = 600
TRAIN_CLI = "taste_spokenlm_tpu_torch.scripts.train"
# a CLI module as `python -m` runs it (the module, then its arguments), then
# the process's kernel launch counts (the counters live in the process that
# launches); without TensorBoard, whose import (TensorFlow) takes tens of
# seconds: the train CLI's rows checked are metrics.jsonl's
CLI_WRAPPER = """
import json, runpy, sys
from taste_spokenlm_tpu_torch.kernels import launch_counts
sys.modules["torch.utils.tensorboard"] = None
sys.argv = sys.argv[1:]
try:
    runpy.run_module(sys.argv[0], run_name="__main__")
except SystemExit as e:
    if e.code:
        raise
print("launch_counts " + json.dumps(launch_counts()), flush=True)
"""


def harness_step(dev, cfg):
    """A fresh bf16 model on the serving models' float weights, the rvq
    phase's mask, Adam 1e-4 clipped at 5 -> its stage-1 step."""
    with torch.device(dev):
        model = TasteForCausalLM(cfg, dtype=torch.bfloat16, device=dev)
    model.load_state_dict(random_state_dict(
        model, torch.Generator(device=dev).manual_seed(0)), strict=True)
    mask = optim.trainable_mask(model, optim.STAGE1_PHASES["rvq"])
    opt = optim.make_optimizer(model, 1e-4, mask=mask, grad_clip=5.0)
    return train_step.make_stage1_step(model, opt, trainable_mask=mask)


def state_tensors(state_dict: dict) -> dict:
    """{name: tensor} of a TrainState's state dict: the model's parameters
    and buffers, Adam's moments and the generator's state."""
    out = {f"model.{k}": v for k, v in state_dict["model"].items()}
    for k in ("mu", "nu"):
        out.update({f"{k}.{i}": v for i, v in
                    enumerate(state_dict["optimizer"][k])})
    out["generator"] = state_dict["generator"]
    return out


def state_spread(ref: dict, got: dict) -> dict:
    """{name: max |got - ref| / max |ref|} of the tensors that differ."""
    out = {}
    for k, x in ref.items():
        y = got[k].to(x.device)
        if not torch.equal(x, y):
            x, y = x.double(), y.double()
            out[k] = ((x - y).abs().max()
                      / x.abs().max().clamp(min=1e-30)).item()
    return out


def dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def nondeterministic_ops(step, batch) -> list:
    """The messages torch gives, with deterministic algorithms asked for
    (warn only), for the ops of one step that have none."""
    import warnings
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            step(batch)
            torch.cuda.synchronize()
        finally:
            torch.use_deterministic_algorithms(False)
    return sorted({str(w.message).split("\n")[0] for w in caught
                   if "determinis" in str(w.message)})


def run_cli(name: str, args: list, kill_after: str = None,
            module: str = TRAIN_CLI, log_dir: str = HARNESS_DIR) -> dict:
    """Run a CLI module as a subprocess (output in <log_dir>/<name>.log) ->
    {"wall_s", "counts", "launched", "text"}; the train CLI's also
    {"resumed", "rows"} (its metrics.jsonl), and with `kill_after` (a
    checkpoint directory) it is killed with SIGKILL once that directory
    exists."""
    log_path = os.path.join(log_dir, f"{name}.log")
    t0 = time.perf_counter()
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-c", CLI_WRAPPER, module, *args], stdout=log,
            stderr=subprocess.STDOUT)
        try:
            if kill_after is not None:
                workdir = args[args.index("--workdir") + 1]
                target = os.path.join(workdir, "ckpt", kill_after)
                while not os.path.isdir(target):
                    check(proc.poll() is None and
                          time.perf_counter() - t0 < CLI_TIMEOUT_S,
                          f"{name}: no step-{kill_after} checkpoint before "
                          f"it ended: {open(log_path).read()[-2000:]}")
                    time.sleep(0.05)
                os.kill(proc.pid, signal.SIGKILL)
                proc.wait()
                return {"wall_s": time.perf_counter() - t0,
                        "steps_on_disk": sorted(
                            int(n) for n in os.listdir(os.path.dirname(target))
                            if n.isdigit())}
            rc = proc.wait(timeout=CLI_TIMEOUT_S)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    text = open(log_path).read()
    check(rc == 0, f"{name}: {module} exited {rc}: {text[-3000:]}")
    lines = text.strip().splitlines()
    check(lines[-1].startswith("launch_counts "),
          f"{name}: no launch counts at the end: {text[-2000:]}")
    counts = json.loads(lines[-1].split(" ", 1)[1])
    out = {"wall_s": time.perf_counter() - t0, "counts": counts,
           "launched": {k: n for k, n in counts.items() if n}, "text": text}
    if module == TRAIN_CLI:
        check(lines[-2] == "done",
              f"{name}: the train CLI did not end with 'done': {text[-2000:]}")
        rows = {}
        workdir = args[args.index("--workdir") + 1]
        for line in open(os.path.join(workdir, "metrics.jsonl")):
            row = json.loads(line)
            rows[row["step"]] = row
        out.update(resumed="resuming from step" in text, rows=rows)
    return out


# the train CLI's runs, cut from the full config for the model_axis phase's
# time; the full width trains in-process (steps 7-7c)
CLI_REDUCED = {"train CLI": "TasteConfig.tiny() (--tiny), was TasteConfig.full()"}


def cli_path(spread_gate: float) -> dict:
    """(c): the train CLI at TasteConfig.tiny() (f32, per-layer remat) on
    the synthetic stage-1 stream, straight through and killed-and-resumed,
    and two steps of stage 2 and of the flow.  The four chains of processes
    (straight; victim, then resumed; stage 2; the flow) run concurrently,
    so each wall includes its neighbours' load."""
    cfg = apply_remat(TasteConfig.tiny(), True)
    flash = flash_shapes(cfg, 2 * cfg.audio_tower.whisper.max_source_positions,
                         8, "float32")
    per_step = {"flash_attention": sum(flash.values())} if flash else {}
    base = ["--tiny", "--stage", "1", "--synthetic", "--save-every", "2",
            "--log-every", "1", "--remat", "full"]
    out = {}
    work = {k: os.path.join(HARNESS_DIR, k) for k in
            ("straight", "resumed", "stage2", "flow")}

    def drill():
        victim = run_cli("cli_victim", base + ["--steps", "500", "--workdir",
                                               work["resumed"]], kill_after="2")
        return victim, run_cli("cli_resumed", base + [
            "--steps", "4", "--workdir", work["resumed"]])
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        runs = {"straight": pool.submit(run_cli, "cli_straight", base + [
                    "--steps", "4", "--workdir", work["straight"]]),
                "drill": pool.submit(drill)}
        for name, args in (("stage2", ["--tiny", "--stage", "2"]),
                           ("flow", ["--tiny", "--model", "flow"])):
            runs[name] = pool.submit(run_cli, f"cli_{name}", args + [
                "--synthetic", "--steps", "2", "--log-every", "1",
                "--workdir", work[name]])
        runs = {k: f.result() for k, f in runs.items()}
    straight, (victim, resumed) = runs["straight"], runs["drill"]
    check_counts(straight["counts"], {k: 4 * v for k, v in per_step.items()},
                 "train CLI, straight")
    shutil.rmtree(os.path.join(work["straight"], "ckpt"))
    check(victim["steps_on_disk"][-1] < 4,
          f"the killed run saved {victim['steps_on_disk']}")
    check(resumed["resumed"], "the relaunched CLI did not resume")
    check_counts(resumed["counts"], {k: 2 * v for k, v in per_step.items()},
                 "train CLI, resumed")
    diffs = {}
    for s in (3, 4):
        for k in ("loss", "commit_loss", "grad_norm"):
            a, b = straight["rows"][s][k], resumed["rows"][s][k]
            check(np.isfinite(a), f"train CLI: non-finite {k} at step {s}")
            diffs[f"{k}@{s}"] = abs(a - b) / max(abs(a), 1e-30)
    worst = max(diffs.values())
    check(worst <= spread_gate, f"train CLI: the resumed steps 3-4 part "
                                f"from the straight run's by {worst}")
    shutil.rmtree(os.path.join(work["resumed"], "ckpt"))
    out["stage1"] = {
        "straight_wall_s": straight["wall_s"], "victim_wall_s": victim["wall_s"],
        "victim_steps_on_disk": victim["steps_on_disk"],
        "resumed_wall_s": resumed["wall_s"], "rows_rel_diff": diffs,
        "launches": {"straight": straight["launched"],
                     "resumed": resumed["launched"]},
        "losses": [straight["rows"][s]["loss"] for s in range(1, 5)]}
    for name in ("stage2", "flow"):
        losses = [runs[name]["rows"][s]["loss"] for s in (1, 2)]
        check(all(np.isfinite(losses)), f"train CLI {name}: losses {losses}")
        out[name] = {"wall_s": runs[name]["wall_s"], "losses": losses,
                     "launches": runs[name]["launched"]}
    return out


def harness_path(dev, card: str):
    """The training harness at the bench rung (the docstring's 7b'):
    -> ({kernel: {shape: launches}}, the counts of its in-process steps)."""
    float_cfg, _ = configs()
    cfg = apply_remat(float_cfg, True)
    shutil.rmtree(HARNESS_DIR, ignore_errors=True)
    os.makedirs(HARNESS_DIR)
    t_path = time.perf_counter()
    per_step = {k: sum(v.values()) for k, v in train_launches(cfg, 1).items()}
    batches = [stage1_batch(cfg, dev, 11 + i) for i in range(HARNESS_STEPS)]
    step = harness_step(dev, cfg)
    workdir = os.path.join(HARNESS_DIR, "trainer")
    walls, saves = [], []

    def timed_step(batch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = step(batch)
        float(m["loss"])
        walls.append(time.perf_counter() - t0)
        return m
    trainer = Trainer(TrainerConfig(
        total_steps=HARNESS_STEPS, log_every=1, save_every=2, max_to_keep=2,
        best_metric="loss", workdir=workdir), timed_step,
        schedule=lambda s: 1e-4)
    manager_save = trainer.ckpt.save

    def timed_save(*args, **kw):
        t0 = time.perf_counter()
        saved = manager_save(*args, **kw)
        saves.append(time.perf_counter() - t0)
        return saved
    trainer.ckpt.save = timed_save
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    trainer.fit(trainer.maybe_resume(step.state), iter(batches))
    torch.cuda.synchronize()
    counts = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    all_counts = [counts]
    check_counts(counts, {k: HARNESS_STEPS * v for k, v in per_step.items()},
                 "train_harness Trainer")
    rows = [json.loads(x) for x in open(os.path.join(workdir,
                                                     "metrics.jsonl"))]
    check([r["step"] for r in rows] == [1, 2, 3, 4]
          and all(np.isfinite(v) for r in rows for v in r.values()),
          f"train_harness: metrics rows {rows}")
    check(trainer.ckpt.all_steps() == [2, 4],
          f"train_harness: checkpoints {trainer.ckpt.all_steps()}")
    straight = {r["step"]: r for r in rows}
    ckpt_bytes = dir_bytes(os.path.join(workdir, "ckpt", "2"))

    # (b) one step twice from the restored step-2 state
    t0 = time.perf_counter()
    trainer.ckpt.restore(step.state, 2)
    torch.cuda.synchronize()
    restore_s = [time.perf_counter() - t0]
    reset_launch_counts()
    m_a = step(batches[2])
    snap = {k: v.clone() for k, v in state_tensors(
        step.state.state_dict()).items()}
    trainer.ckpt.restore(step.state, 2)
    m_b = step(batches[2])
    counts = launch_counts()
    check_counts(counts, {k: 2 * v for k, v in per_step.items()},
                 "train_harness repeat")
    all_counts.append(counts)
    repeat = state_spread(snap, state_tensors(step.state.state_dict()))
    repeat.update({f"metric.{k}": abs(float(m_a[k]) - float(m_b[k]))
                   / max(abs(float(m_a[k])), 1e-30)
                   for k in m_a if float(m_a[k]) != float(m_b[k])})
    named = []
    if repeat:
        trainer.ckpt.restore(step.state, 2)
        named = nondeterministic_ops(step, batches[2])
    gate = max(repeat.values(), default=0.0)
    del snap, m_a, m_b, trainer, step
    gc.collect()
    torch.cuda.empty_cache()

    # the round trip: a fresh model and optimizer from step 2, steps 3-4
    fresh = harness_step(dev, cfg)
    manager = CheckpointManager(os.path.join(workdir, "ckpt"), max_to_keep=2,
                                best_metric="loss")
    t0 = time.perf_counter()
    manager.restore(fresh.state, 2)
    torch.cuda.synchronize()
    restore_s.append(time.perf_counter() - t0)
    check(fresh.state.step == 2, "train_harness: restored step")
    reset_launch_counts()
    resumed = [fresh(b) for b in batches[2:]]
    counts = launch_counts()
    check_counts(counts, {k: 2 * v for k, v in per_step.items()},
                 "train_harness resumed")
    all_counts.append(counts)
    metric_diff = {f"{k}@{s}": abs(float(m[k]) - straight[s][k])
                   / max(abs(straight[s][k]), 1e-30)
                   for s, m in zip((3, 4), resumed) for k in m}
    ref = torch.load(os.path.join(workdir, "ckpt", "4", "state.pt"),
                     map_location=dev, weights_only=True)
    check(ref["step"] == fresh.state.step == 4, "train_harness: step 4")
    diff = state_spread(state_tensors(ref),
                        state_tensors(fresh.state.state_dict()))
    worst = max([*diff.values(), *metric_diff.values()])
    bitwise = not diff and worst == 0.0
    log({"train_harness_round_trip": {
        "repeat_bitwise": not repeat, "repeat_spread": repeat,
        "nondeterministic_ops": named, "gate": gate,
        "resumed_bitwise": bitwise, "resumed_max_rel_diff": worst,
        "differing_tensors": dict(sorted(diff.items(),
                                         key=lambda kv: -kv[1])[:10]),
        "tensors_compared": len(state_tensors(ref))}})
    check(worst <= gate, f"train_harness: the resumed run parts from the "
                         f"uninterrupted one by {worst} (the step repeats "
                         f"within {gate})")
    del fresh, ref, resumed
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(os.path.join(workdir, "ckpt"))

    # (c) the train CLI
    cli = cli_path(gate)
    log({"train_harness": {
        "card": card, "batch": f"{TRAIN_B}x30s", "trainer_step_walls_s": walls,
        "trainer_step_s": min(walls), "save_s": saves, "restore_s": restore_s,
        "checkpoint_bytes": ckpt_bytes, "peak_mem_gb": peak_gb,
        "metrics": rows, "cli": cli, "reduced": CLI_REDUCED,
        "path_wall_s": time.perf_counter() - t_path}})
    shutil.rmtree(HARNESS_DIR, ignore_errors=True)
    return train_launches(cfg, HARNESS_STEPS + 4), {
        k: sum(c[k] for c in all_counts) for k in all_counts[0]}


# ---------------------------------------------------------------------------
# reconstruction in mode "SpokenLLM" (the int8 model)
# ---------------------------------------------------------------------------


def spokenllm_path(model, cfg: TasteConfig, x, lm, gen, n_frames: int,
                   card: str):
    """inference_reconstruction(mode="SpokenLLM") on the int8 model: the
    reconstruction's wav (the tower through extract_vq) and the completion
    path's 40-token llm prefix; the spoken LM's teacher-forced taste, read
    back per asr token, drives the S3 decode, the flow and HiFT.  A warm-up
    and a counted run.  Checks: exact launches (the reconstruction's and
    the teacher-forced forward's: the fused MLP over the 42 prefix rows in
    each layer, the int4 head once), an S3 decode >= 64 long, a finite
    waveform of 256 samples a mel frame; the teacher-forced taste indices
    with kernels against the plain versions (>= 0.99 of the labelled
    positions) on the same llm indices; `scoring` on the same inputs finite
    and within 1e-3 relative of its plain run.  -> ({kernel: {shape:
    launches}}, the counts)."""
    llm = (lm["llm_token_ids"], lm["llm_token_lengths"], lm["llm_word_ids"])
    asr = (x["asr_token_ids"], x["asr_token_lengths"], x["asr_word_ids"])

    def run():
        return model.inference_reconstruction(
            x["speaker_embeds"], *asr, x["audio_features"], mode="SpokenLLM",
            max_speech_steps=MAX_SPEECH, mel_len_max=MEL_LEN_MAX,
            llm_token_ids=llm[0], llm_token_lengths=llm[1],
            llm_word_ids=llm[2], generator=gen)
    run()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    dec_len = int(out["speech_token_lengths"].min())
    check(dec_len >= 64, f"SpokenLLM: degenerate S3 decode length {dec_len}")
    mel_len = int(model.voice_generator.flow.mel_lengths(
        out["speech_token_lengths"]).clamp(max=MEL_LEN_MAX)[0])
    wav = out["waveform"]
    check(bool(torch.isfinite(wav).all()), "SpokenLLM: non-finite waveform")
    wav_len = int(out["waveform_lengths"][0])
    check(wav_len == 256 * mel_len,
          f"SpokenLLM: wav length {wav_len} != 256 x {mel_len}")
    rows = B * (1 + T_TOK + cfg.spoken_lm.delay)
    launches = merge_launches(
        recon_launches(cfg, model, n_frames, B * (3 + T_TOK), dec_len,
                       MAX_SPEECH, MEL_LEN_MAX),
        tf_launches(cfg, "int8", rows))
    check_counts(counts, {k: sum(v.values()) for k, v in launches.items()},
                 "spokenllm_reconstruction")

    with torch.no_grad():
        _, llm_idx = model.extract_vq(*asr, *llm, x["audio_features"])
        cb = model._cb()

        def taste():
            o = model.spoken_lm(cb, llm_idx, *llm)
            return o["taste_logits"].argmax(-1), o["taste_labels"]

        def score():
            return float(model.scoring(*asr, *llm, x["audio_features"]))
        taste_k, labels = taste()
        score_k = score()
        model.set_use_kernels(False)
        taste_p, _ = taste()
        score_p = score()
        model.set_use_kernels(True)
    valid = labels != -1
    agree = (taste_k == taste_p)[valid].float().mean().item()
    check(agree >= 0.99, f"SpokenLLM: teacher-forced taste agreement {agree} "
                         "< 0.99")
    score_rel = abs(score_k - score_p) / abs(score_p)
    check(np.isfinite(score_k) and score_rel <= 1e-3,
          f"scoring: kernels {score_k} against plain {score_p} (rel "
          f"{score_rel} > 1e-3)")
    audio_s = wav_len / cfg.hift.sampling_rate
    log({"spokenllm_reconstruction": {
        "card": card, "wall_s": wall, "audio_s": audio_s,
        "rtf": wall / audio_s, "s3_decode_len": dec_len, "mel_frames": mel_len,
        "tf_rows": rows, "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "tf_taste_agreement_kernels_vs_plain": agree,
        "tf_taste_positions": int(valid.sum()),
        "scoring": [score_k, score_p], "scoring_rel_err": score_rel,
        "launches": counts}})
    return launches, counts


# ---------------------------------------------------------------------------
# the stage-2 step and its eval
# ---------------------------------------------------------------------------

S2_B, S2_T, S2_EVAL_B = 8, 512, 2
S2_EVAL_ASR, S2_EVAL_SPEECH = 96, 500     # the eval's S3 stack: T = 599


def stage2_batch(cfg: TasteConfig, dev, b: int, seed: int) -> dict:
    """bench.py:356-369: b rows of 512 llm tokens, word ids arange(T) // 2,
    taste indices at word starts only; indices, then token ids, from
    RandomState(100 + seed)."""
    q = cfg.audio_tower.quantizer
    r = np.random.RandomState(100 + seed)
    words = np.arange(S2_T) // 2
    idx = np.full((b, S2_T, q.num_quantizers), -1, np.int64)
    starts = np.flatnonzero(np.diff(words, prepend=-1) != 0)
    idx[:, starts] = r.randint(0, q.codebook_size,
                               (b, len(starts), q.num_quantizers))
    ids = r.randint(100, 120000, (b, S2_T)) % cfg.spoken_lm.llama.vocab_size
    n = lambda a: torch.from_numpy(np.asarray(a)).to(dev)  # noqa: E731
    return {"llm_indices": n(idx), "llm_token_ids": n(ids),
            "llm_token_lengths": n([S2_T] * b),
            "llm_word_ids": n(words[None].repeat(b, 0))}


def chunked_loss_check(model, dev, gen) -> dict:
    """chunked_ce_kl against the unchunked formula in f32 at B = 2 x 514
    rows (the stage-2 labels: the last two rows ignored), on the model's
    tied table in f32 and a teacher near the student: CE, KL and the
    gradient of 0.1 CE + 0.9 KL with respect to the hidden state within
    1e-4 relative; each side's peak memory above its inputs."""
    lm = model.spoken_lm.language_model
    w = lm.embed_tokens.weight.detach().float()
    v, hdim = w.shape
    rows = 1 + S2_T + model.config.spoken_lm.delay
    hidden = torch.randn((S2_EVAL_B, rows, hdim), generator=gen, device=dev) * 3
    ref = hidden + torch.randn(hidden.shape, generator=gen, device=dev)
    labels = torch.randint(0, v, (S2_EVAL_B, rows), generator=gen, device=dev)
    labels[:, S2_T:] = -1
    head = lambda h: h @ w.T  # noqa: E731
    valid = labels != -1

    def unchunked(h):
        logp = torch.log_softmax(head(h), -1)
        nll = -torch.gather(logp, -1, labels.clamp(min=0)[..., None])[..., 0]
        ce = torch.where(valid, nll, 0.0).sum() / valid.sum()
        with torch.no_grad():
            tp = torch.softmax(head(ref), -1)
            logt = torch.log(torch.clamp(tp, min=1e-20))
        kl = torch.where(valid, (tp * (logt - logp)).sum(-1), 0.0).sum() \
            / valid.sum()
        return ce, kl

    res = {}
    for name, fn in (("unchunked", unchunked),
                     ("chunked", lambda h: losses.chunked_ce_kl(
                         head, h, labels, ref_hidden=ref))):
        h = hidden.clone().requires_grad_()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ce, kl = fn(h)
        (0.1 * ce + 0.9 * kl).backward()
        torch.cuda.synchronize()
        res[name] = (ce.item(), kl.item(), h.grad,
                     (torch.cuda.max_memory_allocated() - base) / 1e9)
    (ce_u, kl_u, g_u, peak_u), (ce_c, kl_c, g_c, peak_c) = (
        res["unchunked"], res["chunked"])
    out = {"rows": [S2_EVAL_B, rows], "ce": [ce_c, ce_u], "kl": [kl_c, kl_u],
           "ce_rel_err": abs(ce_c - ce_u) / abs(ce_u),
           "kl_rel_err": abs(kl_c - kl_u) / abs(kl_u),
           "grad_rel_err": ((g_c - g_u).abs().max()
                            / g_u.abs().max()).item(),
           "peak_gb_chunked": peak_c, "peak_gb_unchunked": peak_u}
    for k in ("ce_rel_err", "kl_rel_err", "grad_rel_err"):
        check(out[k] <= 1e-4, f"chunked_ce_kl against unchunked: {k} "
                              f"{out[k]} > 1e-4")
    check(kl_u > 1e-3, f"chunked_ce_kl check: the teacher is the student "
                       f"(KL {kl_u})")
    return out


def head_cost(model, dev, gen, profile: bool) -> dict:
    """The path's head in the chunked loss at the training shape (B = 8 x
    514 rows, bf16 hidden, a teacher hidden state near it): the bf16
    table on the tensor cores with f32 output (`LlamaModel.logits`, the
    path's head) against an f32 product over the table's f32 copy, the
    loss and its backward once each.  The tensor-core loss's CE and KL
    within 1e-4 relative of the f32 head's, its bf16 gradient within one
    bf16 step (2^-8) of the largest.  With `profile`, also the time of
    the loss and its backward each way (and with the copy made on every
    head call, 36 a loss), of the copy alone, and of one 512-row
    chunk's head as the f32 product and as the bf16 product."""
    lm = model.spoken_lm.language_model
    rows = 1 + S2_T + model.config.spoken_lm.delay
    hdim = lm.config.hidden_size
    hidden = (torch.randn((S2_B, rows, hdim), generator=gen, device=dev)
              ).to(torch.bfloat16)
    ref = (hidden.float() + torch.randn(hidden.shape, generator=gen,
                                        device=dev)).to(torch.bfloat16)
    labels = torch.randint(0, lm.config.vocab_size, (S2_B, rows),
                           generator=gen, device=dev)
    labels[:, S2_T:] = -1
    w = lm.embed_tokens.weight.detach()
    w32 = w.float()
    heads = {"tensor_core": lm.logits,
             "f32_hoisted": lambda h: h.float() @ w32.T}
    if profile:
        heads["f32_per_call"] = lambda h: h.float() @ w.float().T

    def run(head):
        h = hidden.clone().requires_grad_()
        ce, kl = losses.chunked_ce_kl(head, h, labels, ref_hidden=ref)
        (0.1 * ce + 0.9 * kl).backward()
        return ce.item(), kl.item(), h.grad

    out, res = {}, {}
    for name, head in heads.items():
        walls = []
        for _ in range(3 if profile else 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res[name] = run(head)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        if profile:
            out[f"{name}_ms"] = min(walls)
    (ce_t, kl_t, g_t), (ce_f, kl_f, g_f) = res["tensor_core"], res["f32_hoisted"]
    if profile:
        out.update({
            "head_calls_per_loss": 4 * (-(-rows // 64)),
            "upcast_ms": time_ms(lambda: w.float(), reps=10),
            "chunk_f32_product_ms": time_ms(
                lambda: hidden[:, :64].reshape(-1, hdim).float() @ w32.T,
                reps=10),
            "chunk_bf16_product_f32_out_ms": time_ms(
                lambda: torch.mm(hidden[:, :64].reshape(-1, hdim), w.T,
                                 out_dtype=torch.float32), reps=10)})
    out["tensor_core_vs_f32"] = {
        "ce_rel_err": abs(ce_t - ce_f) / abs(ce_f),
        "kl_rel_err": abs(kl_t - kl_f) / abs(kl_f),
        "grad_rel_err": ((g_t.float() - g_f.float()).abs().max()
                         / g_f.float().abs().max()).item()}
    # the gradient is the hidden state's, bf16: where the f32 values on
    # either side straddle a rounding boundary they part by one bf16 step,
    # up to 2^-8 of the largest gradient
    for k, e in out["tensor_core_vs_f32"].items():
        tol = 2.0 ** -8 if k == "grad_rel_err" else 1e-4
        check(e <= tol, f"the tensor-core head against the f32 head: {k} "
                        f"{e} > {tol}")
    return out


def stage2_path(dev, card: str, profile: bool):
    """The stage-2 step at bench.py's rung (bench.py:343-420), then its
    eval.  TasteConfig.full() in bf16 (LoRA adapters unmerged and bf16
    too) with per-layer remat, the same seed-0 weights as the other
    models; lora_only_mask, Adam lr 1e-4 clipped at 5, use_ref_kl (the
    frozen base, adapters off, in the same step); B = 8 x 512 tokens.  One
    warm-up step and three timed ones, each ending in a loss read.
    Checks: finite loss, text_kl and grad norm; every launch counter 0 over
    each step (the Llama's attention and LoRA are plain PyTorch, as in JAX);
    every frozen tensor bit-identical and every lora_B moved after the
    steps; chunked_loss_check.  Then "stage2_eval": forward_spoken_llm
    with the speech measurement (96 asr tokens at 2 a word, 500 S3
    targets: the S3 stack teacher-forced at T = 599, under no_grad) and
    eval_metrics_stage2 at B = 2: exactly one rel-pos forward per S3
    layer and no other launch, the speech logits with kernels within 2e-2
    of max |plain|.  -> ({kernel: {shape: launches}}, [the counts of the
    steps, of the eval])."""
    float_cfg, _ = configs()
    cfg = apply_remat(float_cfg, True)
    t0 = time.perf_counter()
    with torch.device(dev):
        model = TasteForCausalLM(cfg, dtype=torch.bfloat16, device=dev)
    sd = random_state_dict(model, torch.Generator(device=dev).manual_seed(0))
    # the Llama's RMSNorm scales near 1, as a trained Llama's: at the
    # serving models' 0.01 its activations and logits are too small for
    # the adapters to move the text KL or to give q / k a gradient
    norm_gen = torch.Generator(device=dev).manual_seed(1)
    for k, v in sd.items():
        if k.startswith("spoken_lm.language_model.") and k.endswith(
                "norm.weight"):
            sd[k] = (1.0 + 0.02 * torch.randn(v.shape, generator=norm_gen,
                                              device=dev)).to(v.dtype)
    model.load_state_dict(sd, strict=True)
    del sd
    mask = optim.lora_only_mask(model)
    opt = optim.make_optimizer(model, 1e-4, mask=mask, grad_clip=5.0)
    step = train_step.make_stage2_step(model, opt, use_ref_kl=True,
                                       trainable_mask=mask)
    params = dict(model.named_parameters())
    # the frozen copy on the host, so that the step's peak is its own
    frozen = {n: p.detach().cpu() for n, p in params.items() if not mask[n]}
    lora_b = {n: p.detach().clone() for n, p in params.items()
              if n.endswith("lora_B")}
    check(lora_b and not any(n in frozen for n in lora_b)
          and "spoken_lm.language_model.embed_tokens.weight" in frozen,
          "lora_only_mask: the adapters are frozen or the table trains")
    torch.cuda.synchronize()
    log({"stage2_model_init_s": time.perf_counter() - t0,
         "trainable_params": sum(p.numel() for n, p in params.items()
                                 if mask[n])})
    m = step(stage2_batch(cfg, dev, S2_B, 0))
    float(m["loss"])
    batches = [stage2_batch(cfg, dev, S2_B, i + 1) for i in range(3)]
    torch.cuda.reset_peak_memory_stats()
    walls, runs, all_counts = [], [], []
    for bt in batches:
        reset_launch_counts()
        t0 = time.perf_counter()
        m = step(bt)
        float(m["loss"])
        walls.append(time.perf_counter() - t0)
        counts = launch_counts()
        check_counts(counts, {}, "stage-2 step")
        row = {k: float(v) for k, v in m.items()}
        check(set(row) == {"loss", "text_loss", "taste_loss", "text_kl",
                           "grad_norm"}
              and all(np.isfinite(v) for v in row.values()),
              f"stage-2 step: metrics {row}")
        runs.append(row)
        all_counts.append(counts)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    params = dict(model.named_parameters())
    moved_frozen = [n for n, v in frozen.items()
                    if not torch.equal(params[n].detach().cpu(), v)]
    check(not moved_frozen, f"stage-2 step: frozen tensors moved: "
                            f"{moved_frozen[:5]}")
    still = [n for n, v in lora_b.items() if torch.equal(params[n], v)]
    check(not still, f"stage-2 step: lora_B did not move: {still[:5]}")
    del frozen, lora_b
    gc.collect()
    torch.cuda.empty_cache()
    wall = min(walls)
    counts = {k: sum(c[k] for c in all_counts) for k in all_counts[0]}
    log({"stage2_train": {
        "card": card, "batch": f"{S2_B}x{S2_T}tok", "step_walls_s": walls,
        "step_s": wall, "tokens_per_s": S2_B * S2_T / wall,
        "peak_mem_gb": peak_gb, "metrics": runs,
        "frozen_tensors_unchanged": True, "lora_b_moved": True,
        "launches_per_step": all_counts[0]}})
    if profile:
        log({"stage2_train_device_profile": device_profile(
            lambda: step(batches[1]), wall)})
    del batches
    gen = torch.Generator(device=dev).manual_seed(3)
    log({"stage2_chunked_loss": {"card": card,
                                 **chunked_loss_check(model, dev, gen)}})
    log({"stage2_head_cost": {"card": card,
                              **head_cost(model, dev, gen, profile)}})
    opt.zero_grad()
    gc.collect()
    torch.cuda.empty_cache()

    # ---- stage2_eval ----
    r = np.random.RandomState(7)
    n = lambda a: torch.from_numpy(np.asarray(a)).to(dev)  # noqa: E731
    sd = cfg.speech_decoder
    llm = stage2_batch(cfg, dev, S2_EVAL_B, 10)
    ev = {"speaker_embeds": n(r.randn(S2_EVAL_B, sd.spk_embed_dim)
                              .astype(np.float32)),
          "asr_token_ids": n(r.randint(100, 20000, (S2_EVAL_B, S2_EVAL_ASR))
                             % cfg.audio_tower.whisper.vocab_size),
          "asr_token_lengths": n([S2_EVAL_ASR] * S2_EVAL_B),
          "asr_word_ids": n((np.arange(S2_EVAL_ASR) // 2)[None]
                            .repeat(S2_EVAL_B, 0)),
          "speech_token_ids": n(r.randint(0, sd.speech_token_size,
                                          (S2_EVAL_B, S2_EVAL_SPEECH))),
          "speech_token_lengths": n([S2_EVAL_SPEECH] * S2_EVAL_B)}

    def evaluate():
        with torch.no_grad():
            return model.forward_spoken_llm(
                *(llm[k] for k in train_step.STAGE2_KEYS),
                ev["speaker_embeds"], ev["asr_token_ids"],
                ev["asr_token_lengths"], ev["asr_word_ids"],
                ev["speech_token_ids"], ev["speech_token_lengths"])
    evaluate()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    out = evaluate()
    metrics = {k: float(v) for k, v in train_step.eval_metrics_stage2(
        out, cfg.audio_tower.quantizer.num_quantizers).items()}
    eval_wall = time.perf_counter() - t0
    eval_counts = launch_counts()
    s3 = sd.llm
    t_s3 = 3 + S2_EVAL_ASR + S2_EVAL_SPEECH
    dk = s3.output_size // s3.attention_heads
    check(relpos_attention.can_use_relpos_flash(t_s3, dk)
          and not relpos_attention.can_use_relpos_flash(S2_EVAL_ASR, dk),
          "the eval's shapes are not the rel-pos kernel's")
    eval_launches = {"relpos_causal_attention": {
        (S2_EVAL_B, t_s3, s3.attention_heads, dk, "bfloat16"): s3.num_blocks}}
    check_counts(eval_counts, {"relpos_causal_attention": s3.num_blocks},
                 "stage2_eval")
    model.set_use_kernels(False)
    out_p = evaluate()
    model.set_use_kernels(True)
    speech_rel = rel_err(out["speech_logits"], out_p["speech_logits"])
    check(speech_rel <= 2e-2, f"stage2_eval: speech logits kernels vs plain "
                              f"{speech_rel} > 2e-2")
    vals = {k: float(out[k]) for k in ("loss", "text_loss", "taste_loss",
                                       "speech_token_accuracy")}
    check(all(np.isfinite(v) for v in (*vals.values(), *metrics.values())),
          f"stage2_eval: non-finite {vals} {metrics}")
    log({"stage2_eval": {
        "card": card, "batch": f"{S2_EVAL_B}x{S2_T}tok, {S2_EVAL_ASR} asr, "
                               f"{S2_EVAL_SPEECH} S3",
        "wall_s": eval_wall, "peak_mem_gb": torch.cuda.max_memory_allocated()
        / 1e9, **vals, **metrics, "speech_logits_rel_err_vs_plain": speech_rel,
        "launches": eval_counts}})
    del model, opt, step, out, out_p
    gc.collect()
    torch.cuda.empty_cache()
    return eval_launches, [counts, eval_counts]


# ---------------------------------------------------------------------------
# the flow OT-CFM step
# ---------------------------------------------------------------------------

FLOW_B, FLOW_TOK, FLOW_MEL = 8, 512, 882     # 512 S3 tokens at 50 Hz


def flow_batch(cfg: TasteConfig, dev, gen) -> dict:
    """B rows of 512 S3 tokens and their target mels: flow_mel, on the
    card, of a seeded 22.05 kHz wav of 882 x 256 samples (a chirp and
    noise)."""
    f = cfg.flow
    tt = torch.arange(FLOW_MEL * 256, device=dev) / 22050.0
    wav = (0.3 * torch.sin(2 * np.pi * 180.0 * tt * (1 + 0.1 * torch.sin(tt)))
           + 0.05 * torch.randn((FLOW_B, tt.numel()), generator=gen,
                                device=dev))
    feat = flow_mel(wav, n_mels=f.output_size)
    check(tuple(feat.shape) == (FLOW_B, FLOW_MEL, f.output_size),
          f"flow_mel shape {tuple(feat.shape)}")
    return {"speech_token_ids": torch.randint(0, f.vocab_size,
                                              (FLOW_B, FLOW_TOK),
                                              generator=gen, device=dev),
            "speech_token_lengths": torch.full((FLOW_B,), FLOW_TOK,
                                               device=dev),
            "feat": feat, "feat_lengths": torch.full((FLOW_B,), FLOW_MEL,
                                                     device=dev),
            "embedding": torch.randn((FLOW_B, f.spk_embed_dim),
                                     generator=gen, device=dev)}


def flow_train_path(dev, card: str, profile: bool):
    """The flow step at full width in f32 (JAX's default), with the serving
    config's fused DiT flag on (the blocks must run unfused under autograd):
    B = 8 rows of 512 S3 tokens, 882 mel frames each; Adam lr 1e-4 clipped
    at 5; one warm-up step and three timed ones.  Checks: finite loss and
    grad norm, every launch counter 0 (fused_dit_block and conv1d_same
    among them), every parameter moved, and the loss bit-identical twice
    from the same draws.  -> the counts over the three steps."""
    float_cfg, _ = configs()
    check(float_cfg.flow.fused_dit_serving, "the flow config is not fused")
    gen = torch.Generator(device=dev).manual_seed(0)
    with torch.device(dev):
        flow = MaskedDiffWithXvec(float_cfg.flow).to(dev)
    flow.load_state_dict(random_state_dict(flow, gen), strict=True)
    opt = optim.make_optimizer(flow, 1e-4, grad_clip=5.0)
    step = train_step.make_flow_step(flow, opt)
    before = {n: p.detach().clone() for n, p in flow.named_parameters()}
    batches = [flow_batch(float_cfg, dev, gen) for _ in range(4)]
    float(step(batches[0])["loss"])
    torch.cuda.reset_peak_memory_stats()
    walls, runs, all_counts = [], [], []
    for bt in batches[1:]:
        reset_launch_counts()
        t0 = time.perf_counter()
        m = step(bt)
        float(m["loss"])
        walls.append(time.perf_counter() - t0)
        counts = launch_counts()
        check_counts(counts, {}, "flow step")
        row = {k: float(v) for k, v in m.items()}
        check(all(np.isfinite(v) for v in row.values()),
              f"flow step: non-finite metrics {row}")
        runs.append(row)
        all_counts.append(counts)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    still = [n for n, p in flow.named_parameters()
             if torch.equal(p.detach(), before[n])]
    check(not still, f"flow step: parameters did not move: {still[:5]}")
    draws = {"t": torch.rand((FLOW_B,), generator=gen, device=dev),
             "z": torch.randn(batches[1]["feat"].shape, generator=gen,
                              device=dev),
             "keep": torch.rand((FLOW_B,), generator=gen, device=dev) > 0.2}
    twice = [flow(*(batches[1][k] for k in train_step.FLOW_KEYS),
                  **draws)["loss"].detach() for _ in range(2)]
    check(torch.equal(twice[0], twice[1]),
          f"flow loss not bit-identical from the same draws: "
          f"{[float(x) for x in twice]}")
    wall = min(walls)
    log({"flow_train": {
        "card": card, "batch": f"{FLOW_B}x{FLOW_TOK} tokens, {FLOW_MEL} mel "
                               "frames", "step_walls_s": walls,
        "step_s": wall, "mel_frames_per_s": FLOW_B * FLOW_MEL / wall,
        "peak_mem_gb": peak_gb, "metrics": runs,
        "loss_twice": [float(x) for x in twice],
        "launches_per_step": all_counts[0]}})
    if profile:
        log({"flow_train_device_profile": device_profile(
            lambda: step(batches[2]), wall)})
    del flow, opt, step, before, batches
    gc.collect()
    torch.cuda.empty_cache()
    return {k: sum(c[k] for c in all_counts) for k in all_counts[0]}


# ---------------------------------------------------------------------------
# the decode-layout tools
# ---------------------------------------------------------------------------

FUSION_ITERS = 5           # graph replays a layout (the tool's default: 20)
LAYOUT_TOL = 2e-2          # one layer with kernels against plain, and P / B


def rel_err(out, ref) -> float:
    return ((out.float() - ref.float()).abs().max()
            / ref.float().abs().max()).item()


def layout_kernels(h: int, kv: int, i: int) -> dict:
    """{layout: [(kernel, shape), ...]}: each kernel call of one layer of a
    decode step, by layout (A, B and C call none)."""
    fused = [(1, *sh) for sh in profile_fusion.shapes(h, kv, i)[1]]
    return {"P": [("matmul_int8", sh) for sh in fused],
            "Q": [("matmul_int4", sh) for sh in fused],
            "R": [("gated_mlp_int8", (1, h, i))],
            "S": [("gated_mlp_int4", (1, h, i)), ("matmul_int4", fused[0]),
                  ("matmul_int4", fused[1])]}


def layout_checks(stack: dict, dev) -> dict:
    """One step through a one-layer stack of every layout (the tool's
    recipe, x0 = randn): finite, and with the kernels within LAYOUT_TOL of
    max|plain| of the same step on the plain versions; and P (matmul_int8)
    against B (the XLA formulation) on the same int8 weights."""
    h, kv, i = stack["h"], stack["kv"], stack["i"]
    sets = profile_fusion.WeightSets(h, kv, i, 1, dev, seed=1)
    x0 = torch.randn(1, h, generator=torch.Generator(device=dev).manual_seed(1),
                     device=dev)
    errs = {}
    for letter, _, key in profile_fusion.LAYOUTS:
        step, ws = profile_fusion.STEPS[letter], sets.get(key)
        out, ref = step(x0, ws), step(x0, ws, profile_fusion.PLAIN)
        check(bool(torch.isfinite(out).all() and torch.isfinite(ref).all()),
              f"layout {letter} at H={h}: one layer is not finite")
        errs[letter] = rel_err(out, ref)
        check(errs[letter] <= LAYOUT_TOL,
              f"layout {letter} at H={h}: kernels against plain "
              f"{errs[letter]} > {LAYOUT_TOL}")
    ws_b = sets.get("b")
    p_vs_b = rel_err(profile_fusion.step_p(x0, ws_b),
                     profile_fusion.step_b(x0, ws_b))
    check(p_vs_b <= LAYOUT_TOL, f"layout P against B at H={h}: {p_vs_b} > "
                                f"{LAYOUT_TOL}")
    return {"kernels_vs_plain_rel": errs, "p_vs_b_rel": p_vs_b}


def decode_layouts_path(dev):
    """Path 5: profile_lmhead at full width (64 steps) and profile_fusion
    at the Llama shapes (16 layers, 64 steps) and the S3 shapes (7 layers,
    512 steps), each layout a CUDA graph of the loop and two eager loops.
    Checks: each eager loop's launches exactly (P 4 L steps matmul_int8, Q
    4 L steps matmul_int4, R L steps gated_mlp_int8, S L steps
    gated_mlp_int4 and 2 L steps matmul_int4, A / B / C none; the int8
    head `steps` logits_int8, the int4 head `steps` matmul_int4); the
    path's totals against the calls the tools made (warm-up, capture,
    eager, the head's parity call); the int8 head's first-step logits
    within 1e-3 of the fused-convert head's max, with the argmax where the
    top-2 gap exceeds twice the error; then, outside the counted run, one
    layer of every layout (layout_checks).  -> ({kernel: {shape:
    launches}}, the path's counts)."""
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    head = profile_lmhead.main([])
    stacks = {"llama": profile_fusion.main(["--iters", str(FUSION_ITERS)]),
              "s3": profile_fusion.main(["--s3", "--iters",
                                         str(FUSION_ITERS)])}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    launches = {}

    def add(name, shape, n):
        per = launches.setdefault(name, {})
        per[shape] = per.get(shape, 0) + n

    steps, shape = head["steps"], (head["m"], head["d"], head["v"])
    for key, kernel in (("xla", None), ("int8", "logits_int8"),
                        ("int4", "matmul_int4")):
        res = head["heads"][key]
        want = {kernel: steps} if kernel else {}
        check(res["launches"] == want, f"lmhead {key}: one eager loop "
                                       f"launched {res['launches']}, not {want}")
        if kernel:
            add(kernel, shape, res["calls"])
    p8 = head["parity_int8"]
    check(p8["rel_err"] <= 1e-3, f"int8 head against the fused-convert head: "
                                 f"rel err {p8['rel_err']} > 1e-3")
    if p8["ref_top2_gap"] > 2 * p8["max_abs_err"]:
        check(p8["argmax_agree"] == 1.0, f"int8 head argmax agreement "
                                         f"{p8['argmax_agree']} < 1")
    for name, stack in stacks.items():
        per_layer = layout_kernels(stack["h"], stack["kv"], stack["i"])
        n_step = stack["layers"] * stack["steps"]
        for letter, res in stack["layouts"].items():
            want = {}
            for kernel, _ in per_layer.get(letter, ()):
                want[kernel] = want.get(kernel, 0) + n_step
            check(res["launches"] == want,
                  f"{name} layout {letter}: one eager loop launched "
                  f"{res['launches']}, not {want}")
            for kernel, kshape in per_layer.get(letter, ()):
                add(kernel, kshape, stack["layers"] * res["calls"])
    check_counts(counts, {k: sum(v.values()) for k, v in launches.items()},
                 "decode layouts")
    log({"decode_layouts": {"wall_s": wall, "launches": counts,
                            "lmhead": head, **stacks}})
    log({"decode_layouts_checks": {
        "int8_head_vs_fused_convert": p8,
        "int4_head_vs_fused_convert": head["parity_int4"],
        **{name: layout_checks(stack, dev) for name, stack in stacks.items()}}})
    return launches, counts


# ---------------------------------------------------------------------------
# TASLM in the int8 serving layout
# ---------------------------------------------------------------------------

TASLM_STEPS, TASLM_TEXT, TASLM_SPEECH = 64, 40, 60
TASLM_SCORE_B, TASLM_SCORE_T = 2, 256


def taslm_model(dev, gen):
    """(the int8 TASLM model, its config, the codebook): TaslmConfig() at
    Llama-3.2-1B width (16 layers) with 4 speech channels of 4096 and the
    1280-wide RVQ space; random float weights (random_state_dict, LoRA
    adapters too) in bf16, LoRA merged and the Llama quantized by the
    port's quant.py as bench.py's int8 layout (int8 projections, fused qkv
    and MLP, an int8 table with the int4 tied head).  The codebook [4,
    4096, 256] -> 1280 is seeded from `gen`."""
    float_cfg = TaslmConfig()
    pre = "language_model."
    with torch.device(dev):
        model = TaslmForCausalLM(float_cfg, dtype=torch.bfloat16, device=dev)
        n_float = sum(p.numel() for p in model.parameters())
        sd = random_state_dict(model, gen)
        del model
        lora = float_cfg.lora
        lm = quant.quantize_llama_params(
            quant.merge_lora_params({k[len(pre):]: v for k, v in sd.items()
                                     if k.startswith(pre)}, lora.alpha, lora.r),
            include_embed=True, mode="int8", embed_head_mode="int4",
            fuse_qkv=True, fused_mlp=True)
        cfg = float_cfg.replace(use_lora=False, llama=float_cfg.llama.replace(
            quantized_serving="int8", quantized_embed_serving="int4head",
            fused_qkv_serving=True, fused_mlp_serving=True))
        model = TaslmForCausalLM(cfg, dtype=torch.bfloat16, device=dev)
    state = {k: v for k, v in sd.items() if not k.startswith(pre)}
    state.update({pre + k: v for k, v in lm.items()})
    model.load_state_dict(state, strict=True)
    c, v = cfg.speech_num_channels, cfg.speech_vocab_size
    cb = TasteCodebook(
        torch.randn((c, v, 256), generator=gen, device=dev) * 0.5,
        torch.randn((cfg.speech_hidden_size, 256), generator=gen,
                    device=dev) / 16.0,
        torch.zeros(cfg.speech_hidden_size, device=dev))
    return model.eval(), cfg, cb, n_float


def taslm_batch(cfg, dev, b: int, t_text: int, t_speech: int, seed: int):
    """Seeded llm ids [b, t_text] and speech ids [b, t_speech, C], the
    speech bos first."""
    rng = np.random.RandomState(seed)
    text = rng.randint(100, 120000, (b, t_text)) % cfg.llama.vocab_size
    speech = rng.randint(0, cfg.speech_vocab_size,
                         (b, t_speech, cfg.speech_num_channels))
    speech[:, 0] = cfg.speech_bos_id
    return (torch.from_numpy(text).to(dev), torch.from_numpy(speech).to(dev))


class TaslmRecorder:
    """Each decode step's text logits (the head over one row) and speech
    logits (the speech head over one row), f32."""

    def __init__(self, model):
        self.text, self.speech = [], []
        self._lm = model.language_model
        head = self._lm.logits

        def text(h):
            out = head(h)
            if h.shape[:-1] == (1, 1):
                self.text.append(out.float().reshape(-1))
            return out
        self._lm.logits = text
        self._hook = model.speech_head.register_forward_hook(
            lambda mod, args, out: self.speech.append(
                out.float().reshape(-1)) if out.shape[:-1] == (1, 1) else None)

    def close(self):
        del self._lm.logits
        self._hook.remove()


def taslm_launches(cfg, n_steps: int, score_rows: int = 0) -> dict:
    """{kernel: {shape: launches}} of one TASLM decode of `n_steps` steps:
    the fused MLP of each Llama layer over the 40 prefix rows and over one
    row at every step but the last (a stopping step runs no Llama), the
    int4 tied head once a step; and of `score_rows` rows of scoring (two
    teacher-forced forwards: the MLPs past the fused kernel's 256 rows run
    unfused, the head takes the int4 kernel at any row count)."""
    llama = cfg.llama
    h, n_l = llama.hidden_size, llama.num_hidden_layers
    out = {"gated_mlp_int8": {}, "matmul_int4": {}}
    if n_steps:
        out["gated_mlp_int8"] = {(TASLM_TEXT, h, llama.intermediate_size): n_l,
                                 (1, h, llama.intermediate_size):
                                 n_l * (n_steps - 1)}
        out["matmul_int4"] = {(1, h, llama.vocab_size): n_steps}
    if score_rows:
        check(score_rows > FUSED_MLP_MAX_ROWS, "scoring rows take the fused "
                                               "MLP: count them")
        out["matmul_int4"][(score_rows, h, llama.vocab_size)] = 2
    return {k: {s: n for s, n in v.items() if n} for k, v in out.items()
            if any(v.values())}


def taslm_path(dev, card: str):
    """TASLM in the int8 layout ("taslm"): a sampled decode (B = 1, a
    40-token text prompt with 60 speech rows, 20 of them forced, 64 steps,
    JAX's default top-p: text 0.9, speech 0.3) counted, and again from the
    same generator state (the same trajectory); a greedy decode with the
    kernels against one with the plain versions (text and speech logits
    within LOGIT_TOL of max |logit| over the shared history); then scoring
    at B = 2 x 256 (a teacher-forced forward with every loss and
    calculate_log_likelihood, counted): finite, and the log-likelihoods
    within 1e-3 relative of the plain run's.  -> (launches, [counts])."""
    gen = torch.Generator(device=dev).manual_seed(16)
    t0 = time.perf_counter()
    model, cfg, cb, n_float = taslm_model(dev, gen)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    text, speech = taslm_batch(cfg, dev, 1, TASLM_TEXT, TASLM_SPEECH, 3)

    def decode(seed=None, **kw):
        g = None if seed is None else torch.Generator(device=dev).manual_seed(
            seed)
        return model.generate(cb, text, speech, TASLM_TEXT, TASLM_SPEECH,
                              max_steps=TASLM_STEPS, generator=g, **kw)
    decode(5)                                    # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    run = decode(7)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    n = int(run["num_steps"])
    check(n >= 21, f"taslm: the decode stopped after {n} steps, inside its "
                   "20 forced speech rows")
    launches = taslm_launches(cfg, n)
    check_counts(counts, {k: sum(v.values()) for k, v in launches.items()},
                 "taslm decode")
    check(torch.equal(run["speech_ids"][:20].cpu(), speech[0, 40:60].cpu()),
          "taslm: the forced speech rows were not emitted")
    ids = run["text_ids"][:n]
    check(bool(((ids >= 0) & (ids < cfg.llama.vocab_size)).all()) and bool(
        ((run["speech_ids"][:n] >= 0)
         & (run["speech_ids"][:n] < cfg.speech_vocab_size)).all()),
          "taslm: ids out of the vocabularies")
    again = decode(7)
    check(again["num_steps"] == n and torch.equal(again["text_ids"],
                                                  run["text_ids"])
          and torch.equal(again["speech_ids"], run["speech_ids"]),
          "taslm: one generator state gave two trajectories")
    # prefill and step walls: a decode of 1 step is the prefill and a head
    t0 = time.perf_counter()
    decode(7, speech_use_greedy=True, text_top_p=0.0)
    torch.cuda.synchronize()
    greedy_wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    model.generate(cb, text, speech, TASLM_TEXT, TASLM_SPEECH, max_steps=1,
                   speech_use_greedy=True, text_top_p=0.0)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0

    # greedy with kernels against the plain versions on the shared history
    recs = []
    for use in (True, False):
        set_use_kernels(model, use)
        rec = TaslmRecorder(model)
        out = decode(speech_use_greedy=True, text_top_p=0.0)
        rec.close()
        recs.append((out, rec))
    set_use_kernels(model, True)
    (ok_, rk), (op_, rp) = recs
    shared = min(int(ok_["num_steps"]), int(op_["num_steps"]))
    for s in range(shared):
        if not (torch.equal(ok_["text_ids"][s], op_["text_ids"][s])
                and torch.equal(ok_["speech_ids"][s], op_["speech_ids"][s])):
            shared = s + 1       # step s's logits saw the same history
            break
    errs = {}
    for what, a, b in (("text", rk.text, rp.text),
                       ("speech", rk.speech, rp.speech)):
        e = max(((x - y).abs().max() / y.abs().max()).item()
                for x, y in zip(a[:shared], b[:shared]))
        check(e <= LOGIT_TOL, f"taslm: {what} logits with kernels {e} of "
                              f"max|plain| > {LOGIT_TOL}")
        errs[what] = e
    agree = (ok_["speech_ids"][:shared] == op_["speech_ids"][:shared]
             ).float().mean().item()

    # scoring at B = 2 x 256
    st, ss = taslm_batch(cfg, dev, TASLM_SCORE_B, TASLM_SCORE_T,
                         TASLM_SCORE_T, 4)
    lens = torch.tensor([TASLM_SCORE_T, TASLM_SCORE_T - 16], device=dev)
    valid = torch.arange(TASLM_SCORE_T, device=dev)[None] < lens[:, None]
    tl = torch.where(valid, st, torch.full_like(st, -1))
    sl = torch.where(valid[..., None], ss, torch.full_like(ss, -1))

    def score():
        with torch.no_grad():
            out = model(cb, st, ss, tl, sl, lens)
            ll = model.calculate_log_likelihood(cb, st, ss, tl, sl, lens)
        return ({k: float(v) for k, v in out.items() if v.dim() == 0},
                {k: float(v) for k, v in ll.items()})
    score()
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    losses_k, ll_k = score()
    torch.cuda.synchronize()
    score_wall = time.perf_counter() - t0
    score_counts = launch_counts()
    score_launches = taslm_launches(cfg, 0, TASLM_SCORE_B * TASLM_SCORE_T)
    check_counts(score_counts, {k: sum(v.values())
                                for k, v in score_launches.items()},
                 "taslm scoring")
    set_use_kernels(model, False)
    losses_p, ll_p = score()
    set_use_kernels(model, True)
    ll_rel = {k: abs(ll_k[k] - ll_p[k]) / abs(ll_p[k]) for k in ll_k}
    check(all(np.isfinite(v) for v in [*losses_k.values(), *ll_k.values()]),
          f"taslm scoring: non-finite {losses_k} {ll_k}")
    check(max(ll_rel.values()) <= 1e-3,
          f"taslm: log-likelihoods with kernels against plain {ll_rel}")
    log({"taslm": {
        "card": card, "model_init_s": build_s, "float_params": n_float,
        "decode_steps": n, "decode_wall_s": wall,
        "prefill_s": prefill_s,
        "ms_per_step": (greedy_wall - prefill_s) / max(
            int(ok_["num_steps"]) - 1, 1) * 1e3,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "greedy_shared_steps": shared, "greedy_logit_rel_err": errs,
        "greedy_speech_agreement": agree, "scoring_wall_s": score_wall,
        "scoring_losses": losses_k, "log_likelihood": ll_k,
        "log_likelihood_rel_err": ll_rel, "launches": counts,
        "scoring_launches": score_counts}})
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return merge_launches(launches, score_launches), [counts, score_counts]


def set_use_kernels(model, flag: bool) -> None:
    for m in model.modules():
        if hasattr(m, "use_kernels"):
            m.use_kernels = flag


# ---------------------------------------------------------------------------
# padded flash attention at the flow's shapes
# ---------------------------------------------------------------------------

PADDED_FLASH_T = (904, 452)


def padded_flash_path(dev, card: str):
    """ops/attention.padded_flash_attention at the flow U-Net's shapes
    ("padded_flash"): B = 2 (CFG), T = 904 and 452, 8 heads x 64, f32 and
    bf16, key lengths [T, T - 37] and [T, 0]; one counted call each.
    Checks: exact launches; against the plain version (the masked
    attention on the mask) on the valid query rows (1e-4 abs f32, 2e-2 of
    max|plain| bf16); bit-identical twice; finite everywhere (the empty
    row too).  -> (launches, counts)."""
    gen = torch.Generator(device=dev).manual_seed(23)
    cases = []
    for t in PADDED_FLASH_T:
        for dt in (torch.float32, torch.bfloat16):
            q, k, v = (torch.randn((2, t, 8, 64), generator=gen, device=dev
                                   ).to(dt) for _ in range(3))
            for lens in ([t, t - 37], [t, 0]):
                kv = (torch.arange(t, device=dev)[None]
                      < torch.tensor(lens, device=dev)[:, None])
                cases.append((t, dt, lens, q, k, v, kv))
    torch.cuda.synchronize()
    reset_launch_counts()
    outs = [padded_flash_attention(q, k, v, kv)
            for _, _, _, q, k, v, kv in cases]
    torch.cuda.synchronize()
    counts = launch_counts()
    launches = {"flash_attention": {}}
    for t, dt, *_ in cases:
        key = (2, t, 8, 64, str(dt).split(".")[-1])
        launches["flash_attention"][key] = launches[
            "flash_attention"].get(key, 0) + 1
    check_counts(counts, {"flash_attention": len(cases)}, "padded_flash")
    rows = []
    for (t, dt, lens, q, k, v, kv), out in zip(cases, outs):
        f32 = dt == torch.float32
        ref = multi_head_attention(q, k, v, mask=kv[:, None, None, :])
        check(bool(torch.isfinite(out.float()).all()),
              f"padded_flash: non-finite output at T={t} {dt} {lens}")
        err = max(((out[i, :n].float() - ref[i, :n].float()).abs().max()
                   .item() if n else 0.0) for i, n in enumerate(lens))
        scale = ref.float().abs().max().item()
        tol = 1e-4 if f32 else 2e-2
        check((err if f32 else err / scale) <= tol,
              f"padded_flash: err {err} at T={t} {dt} lengths {lens}")
        check(torch.equal(padded_flash_attention(q, k, v, kv), out),
              f"padded_flash: not bit-identical twice at T={t} {dt}")
        qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))
        mask = kv[:, None, None, :]
        rows.append({
            "shape": [2, t, 8, 64], "dtype": str(dt).split(".")[-1],
            "key_lengths": lens, "max_abs_err": err,
            "rel_err": err / scale,
            "ms": time_ms(lambda: padded_flash_attention(q, k, v, kv)),
            "plain_ms": time_ms(lambda: multi_head_attention(
                q, k, v, mask=mask)),
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                qh, kh, vh, attn_mask=mask))})
    log({"padded_flash": {"card": card, "rows": rows, "launches": counts}})
    return launches, counts


# ---------------------------------------------------------------------------
# the model variants, card against host
# ---------------------------------------------------------------------------

VARIANT_TOL, VARIANT_AGREE = 1e-3, 0.99
VARIANT_LLAMA_LAYERS, VARIANT_WHISPER_LAYERS, VARIANT_BLOCKS = 2, 4, 2
STEM_INPUT = 80           # the conv stems' input features (fbank bins)


def variant_weights(module, seed: int) -> dict:
    """random_state_dict on the host from `seed`, with BatchNorm running
    variances positive."""
    sd = random_state_dict(module, torch.Generator().manual_seed(seed))
    for k, v in sd.items():
        if k.endswith("running_var"):
            sd[k] = v.abs() + 0.5
        elif k.endswith("num_batches_tracked"):
            sd[k] = torch.zeros_like(v)
    return sd


def compare_outputs(name: str, host: dict, card: dict) -> dict:
    """Floats within VARIANT_TOL of max |host|; integers (ids, indices)
    equal on >= VARIANT_AGREE of the positions."""
    out = {}
    for k, h in host.items():
        c = card[k].detach().float().cpu() if torch.is_tensor(card[k]) \
            else torch.tensor(float(card[k]))
        h = h.detach().float() if torch.is_tensor(h) else torch.tensor(float(h))
        if k.startswith("ids:"):
            agree = (c == h).float().mean().item()
            check(agree >= VARIANT_AGREE,
                  f"variants: {name} {k} agreement {agree} < {VARIANT_AGREE}")
            out[k] = {"agreement": agree}
        else:
            check(bool(torch.isfinite(c).all()), f"variants: {name} {k} "
                                                 "non-finite on the card")
            err = ((c - h).abs().max() / h.abs().max().clamp_min(1e-30)).item()
            check(err <= VARIANT_TOL, f"variants: {name} {k} rel err {err} > "
                                      f"{VARIANT_TOL}")
            out[k] = {"rel_err": err}
    return out


def on_both(name: str, build, run, dev, seed: int, results: dict,
            walls: dict):
    """`build()` on the host, seeded weights, a copy on the card; `run(m,
    device)` on each (f32, TF32 off) -> {output: tensor}, compared."""
    t0 = time.perf_counter()
    torch.manual_seed(seed)
    host = build().float()
    host.load_state_dict(variant_weights(host, seed), strict=True)
    card = copy.deepcopy(host).to(dev)
    host.eval()
    card.eval()
    with torch.no_grad():
        ref = run(host, torch.device("cpu"))
        got = run(card, dev)
    torch.cuda.synchronize()
    results[name] = compare_outputs(name, ref, got)
    walls[name] = time.perf_counter() - t0
    del host, card
    gc.collect()
    torch.cuda.empty_cache()


def variants_path(dev, card: str, x):
    """Each module this slice ported, at TasteConfig.full() widths with the
    depth cut ("variants"; `reduced` lists each cut), on the card in f32
    (TF32 off) and on the host from the same weights: every quantizer of
    the zoo, every bridge, the spoken LM in each audio-embed mode and with
    a weighted-layer out bridge (its greedy decode too), the conv-module /
    macaron conformer under each stem (and its train forward's BatchNorm
    statistics), the speech decoder's concat fusions and fuse_normalize
    (forward and greedy decode), the legacy and the add_and_norm towers
    (their whisper encoders run flash on the card: 4 launches each,
    counted).  Floats within 1e-3 relative, ids >= 0.99.  -> (launches,
    counts)."""
    full = TasteConfig.full()
    q = full.audio_tower.quantizer
    llama = full.spoken_lm.llama.replace(num_hidden_layers=VARIANT_LLAMA_LAYERS)
    h, a = llama.hidden_size, q.dim
    reduced = {
        "llama_layers": f"{full.spoken_lm.llama.num_hidden_layers} -> "
                        f"{VARIANT_LLAMA_LAYERS}",
        "whisper_encoder_layers": f"{full.audio_tower.whisper.encoder_layers}"
                                  f" -> {VARIANT_WHISPER_LAYERS}, the middle "
                                  f"hidden read at layer "
                                  f"{full.audio_tower.encoder_target_hidden_layer}"
                                  f" -> {VARIANT_WHISPER_LAYERS // 2}",
        "conformer_blocks": "3 / 2 / 7 -> 2",
        "conv_stem_input_size": f"{STEM_INPUT} (the fbank bins of the "
                                "conv2d stems' usual input; the linear "
                                "stem keeps 512)",
        "legacy_tower_quantizer_dim": f"{q.dim} -> "
                                      f"{full.audio_tower.encoder_input_size}"
                                      " (the affine layer's output)"}
    results, walls = {}, {}
    reset_launch_counts()
    seed = iter(range(1000, 2000))
    r = torch.Generator().manual_seed(31)

    def rn(*shape, scale=1.0):
        return torch.randn(shape, generator=r) * scale

    def moved(args, device):
        return [z.to(device) if torch.is_tensor(z) else z for z in args]

    # the quantizer zoo, [1, 64, 1280] rows
    xq, mq = rn(1, 64, a), torch.ones(1, 64, dtype=torch.bool)
    for kind, build in (
            ("rvq", lambda: QUANTIZER_CLASSES["rvq"](q)),
            ("grouped_rvq", lambda: QUANTIZER_CLASSES["grouped_rvq"](
                q.replace(groups=2))),
            ("vq", lambda: QUANTIZER_CLASSES["vq"](q)),
            ("kmeans", lambda: QUANTIZER_CLASSES["kmeans"](
                q.codebook_size, a)),
            ("no", lambda: QUANTIZER_CLASSES["no"](a, q.codebook_dim,
                                                    q.codebook_size))):
        def run(m, device):
            o = m(*moved((xq, mq), device))
            return {"feats": o["quantized_feats"],
                    "ids:indices": o["quantized_indices"]}
        on_both(f"quantizer_{kind}", build, run, dev, next(seed), results,
                walls)

    # every bridge, standalone
    embed = rn(q.num_quantizers, q.codebook_size, q.codebook_dim, scale=0.5)
    text, audio = rn(1, 42, h), rn(1, 42, a)
    hs = tuple(rn(1, 42, h) for _ in range(VARIANT_LLAMA_LAYERS + 1))
    for name in bridges.BRIDGE_FUSION_CLASSES:
        on_both(f"fusion_{name}", lambda: bridges.make_fusion(name, h, a),
                lambda m, device: {"out": m(*moved((text, audio), device))},
                dev, next(seed), results, walls)
    for name in bridges.BRIDGE_EXTRACT_CLASSES:
        base = rn(1, 42, 512)

        def build():
            if name == "reference_mix":
                return bridges.ReferenceMixExtract(h)
            return bridges.make_extract(name, h, q.codebook_size,
                                        q.codebook_dim, q.num_quantizers,
                                        VARIANT_LLAMA_LAYERS + 1)

        def run(m, device):
            kw = {"hidden_states": tuple(z.to(device) for z in hs)}
            if name == "reference_mix":
                kw["audio_embeds"] = base.to(device)
            logits, info = m(text.to(device), TasteCodebook(embed.to(device)),
                             **kw)
            out = {f"info:{k}": v for k, v in info.items()}
            if name.startswith("continue"):
                out["ids:argmax"] = logits.argmax(-1)
            else:
                out["logits"] = logits
            return out
        on_both(f"extract_{name}", build, run, dev, next(seed), results,
                walls)

    # the spoken LM: each audio-embed mode, and a weighted-layer out bridge
    # with its greedy decode (every hidden state each step)
    lm_rng = np.random.RandomState(5)
    word_ids = torch.arange(T_TOK)[None] // 2
    ids = torch.from_numpy(lm_rng.randint(100, 120000, (1, T_TOK))
                           % llama.vocab_size)
    lens = torch.tensor([T_TOK])
    idx = torch.from_numpy(lm_rng.randint(0, q.codebook_size,
                                          (1, T_TOK, q.num_quantizers)))
    idx[:, 1::2] = -1                             # taste at word starts
    proj = rn(a, q.codebook_dim, scale=q.codebook_dim ** -0.5)
    tables = {k: torch.from_numpy(v) for k, v in build_sampler_tables(
        VocabScan(), llama.vocab_size).items()}
    greedy = SamplerConfig(delay=1, delay_level="word", text_top_p=0.0,
                           taste_top_p=0.0, extra_words=8, has_prefix=True)
    slm_cfg = full.spoken_lm.replace(llama=llama)
    for mode, out_mod in (("pad", None), ("embed_a0_only", None),
                          ("get_codes_from_indices", None),
                          (None, "continue_latent_weighted_layer")):
        c = slm_cfg.replace(**({"audio_embed_conv_mode": mode} if mode else
                               {"out_llm_module": out_mod}))

        def run(m, device, decode=out_mod is not None):
            cb = TasteCodebook(embed.to(device), proj.to(device),
                               torch.zeros(a, device=device))
            args = moved((idx, ids, lens, word_ids), device)
            o = m(cb, *args)
            out = {"loss": o["loss"], "text_logits": o["text_logits"],
                   "ids:taste": o["taste_logits"].argmax(-1)}
            if decode:
                g = m.generate(cb, greedy, {k: v.to(device) for k, v in
                                            tables.items()}, *args,
                               max_steps=16)
                out["ids:tokens"] = g["llm_token_ids"]
                out["ids:taste"] = g["taste_indices"]
            return out
        on_both(f"spoken_lm_{mode or out_mod}", lambda: TasteSpokenLM(
            c, audio_dim=a, taste_k=q.codebook_size, taste_d=q.codebook_dim,
            taste_l=q.num_quantizers), run, dev, next(seed), results, walls)

    # the conformer with the conv module and the macaron FFN under each
    # stem (BatchNorm; layer_norm + causal on the linear stem too); the
    # train forward moves the BatchNorm statistics on both sides alike
    enc = full.speech_decoder.text_encoder.replace(
        num_blocks=VARIANT_BLOCKS, use_cnn_module=True, macaron_style=True)
    for stem, norm, causal in (("linear", "batch_norm", False),
                               ("linear", "layer_norm", True),
                               ("conv1d2", "batch_norm", False),
                               ("conv2d", "batch_norm", False),
                               ("conv2d4", "batch_norm", True),
                               ("conv2d6", "batch_norm", False),
                               ("conv2d8", "batch_norm", False)):
        c = enc.replace(input_layer=stem, cnn_module_norm=norm,
                        cnn_causal=causal, input_size=(
                            enc.input_size if stem == "linear"
                            else STEM_INPUT))
        xs = rn(2, 200, c.input_size)
        ls = torch.tensor([200, 150])

        def run(m, device, bn=norm == "batch_norm"):
            out = {"eval": m(*moved((xs, ls), device))}
            if bn:
                out["train"] = m(*moved((xs, ls), device), train=True)
                out["running_var"] = m.encoders[0].conv_module.norm.running_var
            return out
        on_both(f"conformer_{stem}_{norm}{'_causal' if causal else ''}",
                lambda: ConformerEncoder(c), run, dev, next(seed), results,
                walls)

    # the speech decoder's fusions
    sdc = full.speech_decoder
    sdc = sdc.replace(**{k: getattr(sdc, k).replace(num_blocks=VARIANT_BLOCKS)
                         for k in ("text_encoder", "audio_encoder", "llm")})
    spk, aud = rn(1, sdc.spk_embed_dim), rn(1, 40, sdc.audio_encoder_input_size)
    asr = torch.randint(0, sdc.text_token_size, (1, 40), generator=r)
    s3 = torch.randint(0, sdc.speech_token_size, (1, 60), generator=r)
    for fuse in ("concat", "concat_with_sep", "weighted_sum_normalize"):
        c = sdc.replace(**({"fuse_normalize": True}
                           if fuse.startswith("weighted") else
                           {"fuse_type": fuse}))

        def run(m, device):
            args = moved((spk, aud, torch.tensor([40]), asr, torch.tensor([40])),
                         device)
            o = m(*args, s3.to(device), torch.tensor([60], device=device))
            g = m.generate(*args, max_steps=32, sampling_k=1)
            return {"logits": o["logits"], "loss": o["loss"],
                    "ids:s3": g["speech_token_ids"]}
        on_both(f"speech_decoder_{fuse}", lambda: TasteSpeechDecoder(c), run,
                dev, next(seed), results, walls)

    # the legacy and the add_and_norm towers on the path's mel
    tower = full.audio_tower
    tower = tower.replace(
        whisper=tower.whisper.replace(encoder_layers=VARIANT_WHISPER_LAYERS),
        encoder_target_hidden_layer=VARIANT_WHISPER_LAYERS // 2)
    mel = x["audio_features"].float().cpu()
    asr_ids = x["asr_token_ids"].cpu()
    asr_lens = x["asr_token_lengths"].cpu()
    al = torch.sort(torch.rand((1, T_TOK, 2), generator=r), dim=-1).values
    for variant, c in (
            ("legacy", tower.replace(
                is_joint_encoder_segmenter=False,
                quantizer=q.replace(dim=tower.encoder_input_size))),
            ("add_and_norm", tower.replace(fuse_forward_type="add_and_norm"))):
        def run(m, device, legacy=variant == "legacy"):
            kw = ({"asr_token_alignments": al.to(device)} if legacy else
                  {"asr_word_ids": x["asr_word_ids"].to(device)})
            o = m(*moved((mel, asr_ids, asr_lens), device), **kw)
            return {"embeds": o["audio_unit_embeds"],
                    "ids:indices": o["quantized_indices"]}
        on_both(f"tower_{variant}", lambda: TasteAudioTower(c), run, dev,
                next(seed), results, walls)

    torch.cuda.synchronize()
    counts = launch_counts()
    w = tower.whisper
    key = (1, (mel.shape[-1] + 1) // 2, w.encoder_heads,
           w.d_model // w.encoder_heads, "float32")
    launches = {"flash_attention": {key: 2 * VARIANT_WHISPER_LAYERS}}
    check_counts(counts, {"flash_attention": 2 * VARIANT_WHISPER_LAYERS},
                 "variants")
    log({"variants": {"card": card, "reduced": reduced, "results": results,
                      "walls_s": walls, "total_s": sum(walls.values()),
                      "launches": counts}})
    return launches, counts


# ---------------------------------------------------------------------------
# the offline journey: the CLIs as subprocesses at full width
# ---------------------------------------------------------------------------

CLIS_DIR = os.path.join("build", "clis")
CLI_MODULE = "taste_spokenlm_tpu_torch.scripts."
JOURNEY_TEXT = ("a seeded chirp walks through the offline journey from a "
                "reference checkpoint to a spoken continuation")
JOURNEY_SECS, JOURNEY_SR = 6.0, 44100
XVEC_TOL = 1e-5                 # the x-vector, card against host, f32


def campplus_graph(path: str, dim: int) -> None:
    """A CAM++-shaped x-vector graph (onnx_build): fbank [1, T, 80] ->
    conv stem, two dense TDNN blocks (BN -> ReLU -> dilated conv, concat),
    context-aware masking (mean -> Gemm -> Sigmoid gate), mean / std
    pooling -> Gemm -> [1, dim]; fan-in scaled random weights."""
    from taste_spokenlm_tpu_torch.frontend import onnx_build as OB
    r = np.random.RandomState(11)
    c, g = 128, 64

    def w(*shape):
        return (r.randn(*shape) / np.sqrt(np.prod(shape[1:]))).astype(np.float32)

    def bn(tag, ch):
        return {f"{tag}_s": (1 + 0.1 * r.randn(ch)).astype(np.float32),
                f"{tag}_b": (0.1 * r.randn(ch)).astype(np.float32),
                f"{tag}_m": (0.1 * r.randn(ch)).astype(np.float32),
                f"{tag}_v": r.uniform(0.5, 2.0, ch).astype(np.float32)}
    cin = c + 2 * g
    init = {"stem": w(c, 80, 5), "stem_b": np.zeros(c, np.float32),
            "d1": w(g, c, 3), "d2": w(g, c + g, 3), "cam": w(cin, cin),
            "emb": w(2 * cin, dim), "u2": np.asarray([2], np.int64),
            **bn("bn0", c), **bn("bn1", c), **bn("bn2", c + g)}

    def bnode(x, tag, out):
        return OB.node("BatchNormalization", [x, f"{tag}_s", f"{tag}_b",
                                              f"{tag}_m", f"{tag}_v"], [out])
    nodes = [
        OB.node("Transpose", ["fbank"], ["x"], perm=[0, 2, 1]),
        OB.node("Conv", ["x", "stem", "stem_b"], ["h0c"], kernel_shape=[5],
                pads=[2, 2]),
        bnode("h0c", "bn0", "h0n"), OB.node("Relu", ["h0n"], ["h0"]),
        bnode("h0", "bn1", "n1"), OB.node("Relu", ["n1"], ["r1"]),
        OB.node("Conv", ["r1", "d1"], ["c1"], kernel_shape=[3], pads=[1, 1]),
        OB.node("Concat", ["h0", "c1"], ["cat1"], axis=1),
        bnode("cat1", "bn2", "n2"), OB.node("Relu", ["n2"], ["r2"]),
        OB.node("Conv", ["r2", "d2"], ["c2"], kernel_shape=[3], pads=[2, 2],
                dilations=[2]),
        OB.node("Concat", ["cat1", "c2"], ["feat"], axis=1),
        OB.node("ReduceMean", ["feat"], ["ctx"], axes=[2], keepdims=0),
        OB.node("Gemm", ["ctx", "cam"], ["gl"]),
        OB.node("Sigmoid", ["gl"], ["gate"]),
        OB.node("Unsqueeze", ["gate", "u2"], ["gate3"]),
        OB.node("Mul", ["feat", "gate3"], ["gated"]),
        OB.node("ReduceMean", ["gated"], ["mu"], axes=[2], keepdims=1),
        OB.node("Sub", ["gated", "mu"], ["cent"]),
        OB.node("Mul", ["cent", "cent"], ["sq"]),
        OB.node("ReduceMean", ["sq"], ["var"], axes=[2], keepdims=0),
        OB.node("Sqrt", ["var"], ["sd"]),
        OB.node("Squeeze", ["mu"], ["mu2"], axes=[2]),
        OB.node("Concat", ["mu2", "sd"], ["stats"], axis=1),
        OB.node("Gemm", ["stats", "emb"], ["xvec"]),
    ]
    with open(path, "wb") as f:
        f.write(OB.build(nodes, ["fbank"], ["xvec"], init))


def s3_tokenizer_graph(path: str, n_mels: int, vocab: int) -> None:
    """An S3-tokenizer-shaped graph (onnx_build): (mel [1, n_mels, T], len)
    -> conv stem with erf-GELU (stride 2), a decomposed-LayerNorm attention
    block (4 heads x 64, the head split by Reshape with -1), the encoding
    centred over time, the VQ's nearest codebook row (the distance matmul,
    ArgMin) -> int32 ids."""
    from taste_spokenlm_tpu_torch.frontend import onnx_build as OB
    r = np.random.RandomState(12)
    d, h = 256, 4

    def w(*shape):
        return (r.randn(*shape) / np.sqrt(np.prod(shape[1:]))).astype(np.float32)

    def gelu(src, dst):
        return [OB.node("Div", [src, "sqrt2"], [f"{dst}_d"]),
                OB.node("Erf", [f"{dst}_d"], [f"{dst}_e"]),
                OB.node("Add", [f"{dst}_e", "one"], [f"{dst}_a"]),
                OB.node("Mul", [src, f"{dst}_a"], [f"{dst}_m"]),
                OB.node("Mul", [f"{dst}_m", "half"], [dst])]
    # rows of one norm: the nearest row is the one most aligned with the
    # encoding (with free norms the shortest row would win everywhere)
    cb = r.randn(vocab, d)
    cb = (cb * np.sqrt(d) / np.linalg.norm(cb, axis=1, keepdims=True)
          ).astype(np.float32)
    init = {"c1": w(d, n_mels, 3), "c2": w(d, d, 3), "qkv": w(3 * d, d).T.copy(),
            "wo": w(d, d), "ln_g": np.ones(d, np.float32),
            "ln_b": np.zeros(d, np.float32), "cb": cb,
            "sqrt2": np.asarray(np.sqrt(2.0), np.float32),
            "one": np.asarray(1.0, np.float32), "half": np.asarray(0.5, np.float32),
            "two": np.asarray(2.0, np.float32), "eps": np.asarray(1e-5, np.float32),
            "scale": np.asarray(1 / 8.0, np.float32),
            "m2": np.asarray(-2.0, np.float32),
            "heads": np.asarray([1, -1, h, d // h], np.int64),
            "flat": np.asarray([1, -1, d], np.int64)}
    nodes = [
        OB.node("Conv", ["mel", "c1"], ["h1"], kernel_shape=[3], pads=[1, 1]),
        *gelu("h1", "g1"),
        OB.node("Conv", ["g1", "c2"], ["h2"], kernel_shape=[3], strides=[2],
                pads=[1, 1]),
        *gelu("h2", "g2"),
        OB.node("Transpose", ["g2"], ["seq"], perm=[0, 2, 1]),
        OB.node("ReduceMean", ["seq"], ["mu"], axes=[-1], keepdims=1),
        OB.node("Sub", ["seq", "mu"], ["cent"]),
        OB.node("Pow", ["cent", "two"], ["sq"]),
        OB.node("ReduceMean", ["sq"], ["var"], axes=[-1], keepdims=1),
        OB.node("Add", ["var", "eps"], ["ve"]),
        OB.node("Sqrt", ["ve"], ["sd"]),
        OB.node("Div", ["cent", "sd"], ["nrm"]),
        OB.node("Mul", ["nrm", "ln_g"], ["ns"]),
        OB.node("Add", ["ns", "ln_b"], ["x"]),
        OB.node("MatMul", ["x", "qkv"], ["qkv_out"]),
        OB.node("Split", ["qkv_out"], ["q", "k", "v"], axis=-1, num_outputs=3),
        *[OB.node("Reshape", [t, "heads"], [f"{t}4"]) for t in "qkv"],
        OB.node("Transpose", ["q4"], ["qh"], perm=[0, 2, 1, 3]),
        OB.node("Transpose", ["k4"], ["kh"], perm=[0, 2, 3, 1]),
        OB.node("Transpose", ["v4"], ["vh"], perm=[0, 2, 1, 3]),
        OB.node("MatMul", ["qh", "kh"], ["s_raw"]),
        OB.node("Mul", ["s_raw", "scale"], ["s"]),
        OB.node("Softmax", ["s"], ["p"], axis=-1),
        OB.node("MatMul", ["p", "vh"], ["ctx4"]),
        OB.node("Transpose", ["ctx4"], ["ctx_t"], perm=[0, 2, 1, 3]),
        OB.node("Reshape", ["ctx_t", "flat"], ["ctx"]),
        OB.node("MatMul", ["ctx", "wo"], ["att"]),
        OB.node("Add", ["seq", "att"], ["enc0"]),
        # centred over time, so the frames' differences pick the rows
        OB.node("ReduceMean", ["enc0"], ["enc_mu"], axes=[1], keepdims=1),
        OB.node("Sub", ["enc0", "enc_mu"], ["enc"]),
        OB.node("Transpose", ["cb"], ["cbt"], perm=[1, 0]),
        OB.node("MatMul", ["enc", "cbt"], ["ec"]),
        OB.node("Mul", ["ec", "m2"], ["d1"]),
        OB.node("Mul", ["cb", "cb"], ["c2sq"]),
        OB.node("ReduceSum", ["c2sq"], ["css"], axes=[-1], keepdims=0),
        OB.node("Add", ["d1", "css"], ["dist"]),
        OB.node("ArgMin", ["dist"], ["ids"], axis=-1, keepdims=0),
        OB.node("Cast", ["ids"], ["ids32"], to=6),
    ]
    with open(path, "wb") as f:
        f.write(OB.build(nodes, ["mel", "mel_len"], ["ids32"], init))


def journey_wav(path: str) -> None:
    """A seeded chirp with noise, 44.1 kHz 16-bit stereo (the channels
    differ, so the readers' mixdown matters)."""
    rng = np.random.RandomState(13)
    tt = np.arange(int(JOURNEY_SR * JOURNEY_SECS)) / JOURNEY_SR
    x = 0.3 * np.sin(2 * np.pi * 160.0 * tt * (1 + 0.1 * np.sin(tt))) \
        + 0.02 * rng.randn(tt.size)
    pcm = (np.clip(np.stack([x, 0.6 * x], 1), -1, 1) * 32767).astype("<i2")
    import wave
    with wave.open(path, "wb") as f:
        f.setnchannels(2)
        f.setsampwidth(2)
        f.setframerate(JOURNEY_SR)
        f.writeframes(pcm.reshape(-1).tobytes())


def load_state(path: str) -> dict:
    return torch.load(path, map_location="cpu", weights_only=True, mmap=True)


def states_equal(got: dict, want: dict, what: str) -> int:
    """Every tensor of `want` in `got`, same dtype, bit for bit; no other
    key.  -> the bytes compared."""
    check(set(got) == set(want), f"{what}: keys differ: "
          f"{sorted(set(got) ^ set(want))[:8]}")
    n = 0
    for k, v in want.items():
        g = got[k]
        check(g.dtype == v.dtype and g.shape == v.shape
              and torch.equal(g.cpu(), v.cpu()), f"{what}: {k} differs")
        n += v.numel() * v.element_size()
    return n


def cli_step(name: str, script: str, args: list, walls: dict,
             launches: dict, counts: list, expected: dict) -> dict:
    """One CLI as a subprocess through run_cli; its launches exactly
    `expected` ({kernel: {shape: launches}}), added to the phase's."""
    run = run_cli(name, args, module=CLI_MODULE + script, log_dir=CLIS_DIR)
    check_counts(run["counts"], {k: sum(v.values())
                                 for k, v in expected.items()}, f"clis {name}")
    walls[name] = run["wall_s"]
    counts.append(run["counts"])
    for kernel, shapes in expected.items():
        for key, n in shapes.items():
            launches.setdefault(kernel, {})[key] = \
                launches.get(kernel, {}).get(key, 0) + n
    return run


def clis_path(dev, card: str):
    """The offline journey (the docstring's 8c) at full width: seed ->
    export -> reference-named files -> import with the serving flags ->
    generate_audio completion from a wav with the ONNX x-vector ->
    extract_vq -> eval (stages 1 and 2) -> the S3 topline from the
    S3-tokenizer graph.  -> ({kernel: {shape: launches}}, the counts)."""
    from taste_spokenlm_tpu_torch import convert_import
    from taste_spokenlm_tpu_torch.data import native
    from taste_spokenlm_tpu_torch.frontend.processor import (
        s3_tokenizer_from_onnx, speaker_embedder_from_onnx)
    from taste_spokenlm_tpu_torch.ops.audio import speaker_fbank_features
    from taste_spokenlm_tpu_torch.pretrained import WEIGHTS_FILE
    from taste_spokenlm_tpu_torch.scripts import (eval as eval_cli,
                                                  extract_vq as vq_cli,
                                                  generate_audio as ga)
    from taste_spokenlm_tpu_torch.scripts._cli import (load_tokenizers,
                                                       to_device)
    from taste_spokenlm_tpu_torch.utils.profiling import (
        StageTimer, joint_decode_step_bytes, s3_decode_step_bytes)
    t_phase = time.perf_counter()
    float_cfg, serving = configs()
    cfg = serving["int8"]
    shutil.rmtree(CLIS_DIR, ignore_errors=True)
    os.makedirs(CLIS_DIR)
    d = {k: os.path.join(CLIS_DIR, k) for k in (
        "seed", "exported", "ref", "serving", "gen", "topline", "vq")}
    cfg_path = os.path.join(CLIS_DIR, "float_config.json")
    with open(cfg_path, "w") as f:
        f.write(float_cfg.to_json())
    walls, launches, counts, out = {}, {}, [], {}

    # 1-2. the seed (bf16, f32 tower) and its reference-named export
    cli_step("create_seed_model", "create_seed_model",
             ["--config", cfg_path, "--dtype", "bfloat16", "--output",
              d["seed"]], walls, launches, counts, {})
    cli_step("export", "convert_checkpoint",
             ["--export-torch", d["seed"], "--output", d["exported"]],
             walls, launches, counts, {})
    # the composite cut into the importer's files: an HF whisper dir, an HF
    # Llama dir (.safetensors, PEFT names), the taste rest, flow.pt, hift.pt
    t0 = time.perf_counter()
    files = convert_import.split_composite(
        load_state(os.path.join(d["exported"], "pytorch_model.bin")))
    os.makedirs(os.path.join(d["ref"], "whisper"))
    os.makedirs(os.path.join(d["ref"], "llama"))
    paths = {"whisper": os.path.join(d["ref"], "whisper", "pytorch_model.bin"),
             "llama": os.path.join(d["ref"], "llama", "model.safetensors"),
             "taste": os.path.join(d["ref"], "taste.bin"),
             "flow": os.path.join(d["ref"], "flow.pt"),
             "hift": os.path.join(d["ref"], "hift.pt")}
    check(any(k.endswith(".lora_A.default.weight") for k in files["llama"])
          and any(k.endswith(".weight_g") for k in files["hift"]),
          "the export has no PEFT adapters or no weight-norm pairs")
    for name, path in paths.items():
        if name == "llama":
            convert_import.write_safetensors(files[name], path)
        else:
            torch.save(files[name], path)
    del files
    shutil.rmtree(d["exported"])
    walls["split_s"] = time.perf_counter() - t0

    # the float import equals the seed's state dict exactly
    seed_sd = load_state(os.path.join(d["seed"], WEIGHTS_FILE))
    imported = convert_import.import_checkpoint(
        **{k: convert_import.load_weights(p) for k, p in paths.items()})
    out["float_import_bytes"] = states_equal(imported, seed_sd,
                                             "the float import")
    del imported

    # 3. the import with the serving flags, against quant.serving_state_dict
    # of the same weights (the model built as from_pretrained builds it)
    src = []
    for name in ("whisper", "llama"):
        src += [f"--{name}", os.path.dirname(paths[name])]
    for name in ("taste", "flow", "hift"):
        src += [f"--{name}", paths[name]]
    cli_step("convert_serving", "convert_checkpoint", src + [
        "--config", cfg_path, "--output", d["serving"], "--merge-lora",
        "--quantize-llama", "--quantize-s3-decoder", "--fuse-qkv",
        "--fused-mlp", "--quantize-embed", "int4head"],
        walls, launches, counts, {})
    shutil.rmtree(d["ref"])
    with open(os.path.join(d["serving"], "config.json")) as f:
        check(json.load(f) == json.loads(cfg.to_json()),
              "the serving dir's config is not quant.serving_config's")
    with torch.device(dev):
        ref_model = TasteForCausalLM(cfg, dtype=torch.bfloat16,
                                     tower_dtype=torch.float32, device=dev)
    ref_model.load_state_dict(quant.serving_state_dict(
        {k: v.to(dev) for k, v in seed_sd.items()}, cfg, "int8"), strict=True)
    out["serving_bytes"] = states_equal(
        load_state(os.path.join(d["serving"], WEIGHTS_FILE)),
        ref_model.state_dict(), "the serving dir")
    del ref_model, seed_sd
    gc.collect()
    torch.cuda.empty_cache()

    # 4. generate_audio --task completion on a 44.1 kHz stereo wav with the
    # CAM++-shaped x-vector graph; greedy text and taste
    wav_path = os.path.join(CLIS_DIR, "journey.wav")
    journey_wav(wav_path)
    xvec_onnx = os.path.join(CLIS_DIR, "campplus.onnx")
    campplus_graph(xvec_onnx, cfg.speech_decoder.spk_embed_dim)
    gen_args = ["--seed-model", d["serving"], "--task", "completion",
                "--input-wav", wav_path, "--text", JOURNEY_TEXT,
                "--asr-tokenizer", "offline", "--llm-tokenizer", "offline",
                "--campplus-onnx", xvec_onnx, "--text-top-p", "0",
                "--extra-words", str(LM_STEPS), "--max-decode-steps",
                str(LM_STEPS), "--max-speech-steps", str(MAX_SPEECH),
                "--mel-len-max", str(MEL_LEN_MAX), "--output-dir", d["gen"]]
    run = run_cli("generate_audio", gen_args, module=CLI_MODULE +
                  "generate_audio", log_dir=CLIS_DIR)
    walls["generate_audio"] = run["wall_s"]
    with open(os.path.join(d["gen"], "journey.json")) as f:
        meta = json.load(f)
    model, proc = from_pretrained(d["serving"], device=dev)
    n_lm = len(load_tokenizers("offline", "offline", cfg)[1].encode(
        JOURNEY_TEXT))
    s3_len = meta["speech_tokens"]
    syn_mel = int(model.voice_generator.flow.mel_lengths(
        torch.tensor([s3_len], device=dev)).clamp(max=MEL_LEN_MAX)[0])
    expected = {"flash_attention": flash_shapes(cfg, 3000),
                "fused_dit_block": dit_shapes(cfg, syn_mel),
                "conv1d_same": conv_shapes(cfg),
                **quantized_launches(cfg, "int8", meta["joint_decode_steps"],
                                     s3_len, lm_tokens=n_lm)}
    check_counts(run["counts"], {k: sum(v.values())
                                 for k, v in expected.items()},
                 "clis generate_audio")
    counts.append(run["counts"])
    launches = merge_launches(launches, expected)
    # the wav: finite, the length the S3 tokens imply
    wav, sr = native.py_wav_read(os.path.join(d["gen"], "journey.wav"))
    spf = int(np.prod(cfg.hift.upsample_rates)) * cfg.hift.istft_hop_len
    check(sr == cfg.hift.sampling_rate and wav.size == meta["samples"]
          == spf * syn_mel and bool(np.isfinite(wav).all())
          and float(np.abs(wav).max()) > 0,
          f"clis: the journey's wav: {wav.size} samples at {sr} Hz for "
          f"{syn_mel} mel frames")
    check(meta["joint_decode_steps"] >= 1 and s3_len >= 64
          and len(meta["generated_llm_token_ids"]) >= LM_STEPS // 2,
          f"clis: degenerate journey: {meta['joint_decode_steps']} joint "
          f"steps, {len(meta['generated_llm_token_ids'])} tokens, {s3_len} "
          "S3 tokens")
    # the x-vector on the card against the host's, the same fbank
    audio16 = ga.load_audio(wav_path, cfg.frontend.sample_rate)
    feats = speaker_fbank_features(torch.from_numpy(audio16).to(dev)[None])
    x_card = speaker_embedder_from_onnx(xvec_onnx, device=dev)(feats)
    x_host = speaker_embedder_from_onnx(xvec_onnx, device="cpu")(
        feats.cpu().numpy())
    xvec_rel = float(np.abs(x_card - x_host).max() / np.abs(x_host).max())
    check(xvec_rel <= XVEC_TOL, f"clis: the x-vector on the card is "
                                f"{xvec_rel} from the host's (> {XVEC_TOL})")
    # an in-process completion on the same inputs: the same trajectories
    reset_launch_counts()
    p = ga.parser()
    args = p.parse_args(gen_args)
    asr_tok, llm_tok = load_tokenizers("offline", "offline", cfg)
    proc.asr_tokenizer, proc.llm_tokenizer = asr_tok, llm_tok
    proc.speaker_embedder = speaker_embedder_from_onnx(xvec_onnx, device=dev)
    res = ga.run(args, model, proc, asr_tok, llm_tok, StageTimer(), p)
    n_s3 = int(res["speech_token_lengths"][0])
    check(res["generated_llm_token_ids"].tolist()
          == meta["generated_llm_token_ids"]
          and res["speech_token_ids"][0, :n_s3].astype(np.int64).tolist()
          == meta["speech_token_ids"],
          "clis: generate_audio's trajectories differ from an in-process "
          "completion on the same inputs")
    check_counts(launch_counts(), {k: sum(v.values())
                                   for k, v in expected.items()},
                 "clis: the in-process completion")
    counts.append(launch_counts())
    launches = merge_launches(launches, expected)
    ctx = 1 + n_lm + cfg.spoken_lm.delay + meta["joint_decode_steps"]
    out["generate_audio"] = {
        "meta": {k: meta[k] for k in ("speech_tokens", "samples",
                                       "joint_decode_steps", "timing")},
        "generated_tokens": len(meta["generated_llm_token_ids"]),
        "xvec_card_vs_host_rel": xvec_rel, "launches": run["launched"],
        "joint_decode_step_bytes": joint_decode_step_bytes(
            model.spoken_lm.state_dict(), cfg, ctx),
        "s3_decode_step_bytes": s3_decode_step_bytes(
            model.speech_decoder.state_dict(), cfg, 3 + SYN_ASR + s3_len)}

    # 7. the S3 topline from the S3-tokenizer-shaped graph: its ids on the
    # card equal the host's, and the vocoded tokens are those ids
    s3_onnx = os.path.join(CLIS_DIR, "s3.onnx")
    s3_tokenizer_graph(s3_onnx, cfg.audio_tower.whisper.n_mels,
                       cfg.speech_decoder.speech_token_size)
    top = ["--seed-model", d["serving"], "--task", "reconstruction",
           "--use-target-speech-token", "--input-wav", wav_path, "--text",
           JOURNEY_TEXT, "--asr-tokenizer", "offline", "--s3-onnx", s3_onnx,
           "--mel-len-max", str(MEL_LEN_MAX), "--output-dir", d["topline"]]
    data = proc(audio16, cfg.frontend.sample_rate, text=JOURNEY_TEXT)
    n_valid = int(data["audio_feature_lengths"][0])
    ids_card = s3_tokenizer_from_onnx(s3_onnx, device=dev)(
        data["audio_features"], n_valid)
    ids_host = s3_tokenizer_from_onnx(s3_onnx, device="cpu")(
        data["audio_features"], n_valid)
    check(np.unique(ids_host).size >= 16,
          f"clis: the S3 graph's ids are degenerate: {np.unique(ids_host)}")
    check(np.array_equal(ids_card, ids_host)
          and ids_card.size == (n_valid + 1) // 2,
          f"clis: the S3 graph's ids on the card differ from the host's in "
          f"{int((ids_card != ids_host).sum())} of {ids_host.size}")
    top_mel = int(model.voice_generator.flow.mel_lengths(torch.tensor(
        [ids_card.size], device=dev)).clamp(max=MEL_LEN_MAX)[0])
    del model, proc
    gc.collect()
    torch.cuda.empty_cache()
    run = cli_step("s3_topline", "generate_audio", top, walls, launches,
                   counts, {"fused_dit_block": dit_shapes(cfg, top_mel),
                            "conv1d_same": conv_shapes(cfg)})
    with open(os.path.join(d["topline"], "journey.json")) as f:
        tmeta = json.load(f)
    check(tmeta["speech_token_ids"] == ids_card.tolist()
          and tmeta["samples"] == spf * top_mel,
          "clis: the topline did not vocode the S3 graph's ids")
    out["s3_topline"] = {"ids": int(ids_card.size),
                         "distinct_ids": int(np.unique(ids_card).size),
                         "mel_frames": top_mel}

    # 5. extract_vq --synthetic on the seed dir: the in-process indices
    b_vq, b_eval = 8, 4
    flash8 = flash_shapes(cfg, 3000, b_vq)
    flash4 = flash_shapes(cfg, 3000, b_eval)
    run = cli_step("extract_vq", "extract_vq", [
        "--seed-model", d["seed"], "--synthetic", "--num-batches", "2",
        "--batch-size", str(b_vq), "--output", d["vq"]], walls, launches,
        counts, {"flash_attention": {k: 2 * v for k, v in flash8.items()}})
    with open(os.path.join(d["vq"], "part-0.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    model, _ = from_pretrained(d["seed"], device=dev)
    reset_launch_counts()
    i = 0
    with torch.no_grad():
        for batch in vq_cli.synthetic_batches(model.config, 2, b_vq):
            x = to_device(batch, dev, vq_cli.INPUTS)
            asr_idx, llm_idx = model.extract_vq(*(x[k] for k in vq_cli.INPUTS))
            for bi in range(b_vq):
                check(rows[i]["asr_indices"] == asr_idx[bi].tolist()
                      and rows[i]["llm_indices"] == llm_idx[bi].tolist(),
                      f"clis: extract_vq row {i} differs from the in-process "
                      "extract_vq")
                i += 1
    check(i == len(rows) == 2 * b_vq, f"clis: extract_vq wrote {len(rows)} rows")
    # 6. eval --synthetic, stages 1 and 2: the in-process forwards' metrics
    eval_out = os.path.join(CLIS_DIR, "eval.json")
    run = cli_step("eval", "eval", [
        "--seed-model", d["seed"], "--synthetic", "--num-batches", "2",
        "--batch-size", str(b_eval), "--output", eval_out], walls, launches,
        counts, {"flash_attention": {k: 4 * v for k, v in flash4.items()}})
    with open(eval_out) as f:
        metrics = json.load(f)
    sums = {}
    for batch in eval_cli.synthetic_batches(model.config, 2, b_eval, 0):
        x = to_device(batch, dev)
        for fn in (eval_cli.eval_stage1, eval_cli.eval_stage2):
            for k, v in fn(model, x).items():
                sums[k] = sums.get(k, 0.0) + float(v)
    in_process = merge_launches(
        {"flash_attention": {k: 2 * v for k, v in flash8.items()}},
        {"flash_attention": {k: 4 * v for k, v in flash4.items()}})
    check_counts(launch_counts(), {k: sum(v.values())
                                   for k, v in in_process.items()},
                 "clis: the in-process extract_vq and eval")
    counts.append(launch_counts())
    launches = merge_launches(launches, in_process)
    eval_rel = {}
    for k, v in sums.items():
        want = round(v / 2, 5)
        eval_rel[k] = abs(metrics[k] - want) / max(abs(want), 1e-30)
        check(abs(metrics[k] - want) <= 1e-5 * max(abs(want), 1.0),
              f"clis: eval's {k} {metrics[k]} against {want} in-process")
    check(set(metrics) == set(sums), "clis: eval's metrics differ")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(CLIS_DIR, ignore_errors=True)
    out.update(card=card, walls_s=walls, eval=metrics,
               eval_rel_to_in_process=eval_rel,
               path_wall_s=time.perf_counter() - t_phase)
    log({"clis": out})
    log(f"clis ({card}): seed -> export -> reference files -> import "
        f"-> generate_audio {walls['generate_audio']:.1f} s, extract_vq "
        f"{walls['extract_vq']:.1f} s, eval {walls['eval']:.1f} s; "
        f"phase {out['path_wall_s']:.1f} s")
    total = {k: sum(c[k] for c in counts) for k in counts[0]}
    return launches, total


def merge_launches(*paths: dict) -> dict:
    """{kernel: {shape: launches}} summed over paths."""
    out = {}
    for path in paths:
        for name, shapes in path.items():
            for key, n in shapes.items():
                out.setdefault(name, {})[key] = out.get(name, {}).get(key, 0) + n
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also trace one reconstruction, in each tier "
                         "one joint decode and one synthesis, and one "
                         "pipelined stream with torch.profiler (device "
                         "busy time, idle share, top kernels; adds a few "
                         "minutes)")
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log({"torch": torch.__version__, "cuda": torch.version.cuda,
         "device": torch.cuda.get_device_name(0)})

    build_s = _build.build(KERNEL_SOURCES)
    log({"build_s": build_s})
    log({"tensor_cores": tensor_core_check()})

    gen = torch.Generator(device=dev).manual_seed(0)
    t_start = t0 = time.perf_counter()
    model, cfg, n_float = build_model(dev, gen, "int8")
    torch.cuda.synchronize()
    log({"model_init_s": time.perf_counter() - t0,
         "float_params": n_float,
         "serving_bytes": sum(t.numel() * t.element_size() for t in
                              model.state_dict().values())})
    x = inputs(cfg, dev)
    n_frames = x["audio_features"].shape[-1]
    check(tuple(x["audio_features"].shape) == (B, 128, 3000),
          f"mel shape {tuple(x['audio_features'].shape)}")

    # ---- reconstruction: warm-up (cuDNN / cuBLAS plans), then counted ----
    reconstruct(model, x, gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    out = reconstruct(model, x, gen)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    dec_len = int(out["speech_token_lengths"].min())
    check(dec_len >= 64, f"degenerate S3 decode length {dec_len}")
    mel_len = int(model.voice_generator.flow.mel_lengths(
        out["speech_token_lengths"]).clamp(max=MEL_LEN_MAX)[0])
    wav = out["waveform"]
    check(tuple(wav.shape) == (B, 256 * MEL_LEN_MAX), f"wav shape {wav.shape}")
    check(bool(torch.isfinite(wav).all()), "non-finite waveform")
    wav_len = int(out["waveform_lengths"][0])
    check(wav_len == 256 * mel_len, f"wav length {wav_len} != 256 x {mel_len}")
    audio_s = wav_len / cfg.hift.sampling_rate
    check(B * (3 + T_TOK) <= FUSED_MLP_MAX_ROWS,
          "the S3 prefill is past the fused FFN's row limit")
    recon = recon_launches(cfg, model, n_frames, B * (3 + T_TOK), dec_len,
                           MAX_SPEECH, MEL_LEN_MAX)
    check_counts(counts, {k: sum(v.values()) for k, v in recon.items()},
                 "reconstruction")
    all_counts = [counts]
    log({"reconstruction": {
        "wall_s": wall, "audio_s": audio_s, "rtf": wall / audio_s,
        "s3_decode_len": dec_len, "mel_frames": mel_len, "wav_len": wav_len,
        "peak_mem_gb": peak_gb, "launches": counts}})
    stages = stage_times(model, x, out, gen)
    log({"stages": stages})
    if opts.profile:
        log({"device_profile": device_profile(
            lambda: reconstruct(model, x, gen), wall)})
        tokens = torch.clamp(out["speech_token_ids"], min=0)
        log({"flow_device_profile": device_profile(
            lambda: model.voice_generator.flow.inference(
                tokens, out["speech_token_lengths"], x["speaker_embeds"],
                MEL_LEN_MAX, generator=gen), stages["flow_s"])})

    # the tower with kernels against the tower with the plain versions
    args = (x["audio_features"], x["asr_token_ids"], x["asr_token_lengths"],
            x["asr_word_ids"])
    with torch.no_grad():
        idx_k = model.audio_tower(*args)["quantized_indices"]
        model.set_use_kernels(False)
        idx_p = model.audio_tower(*args)["quantized_indices"]
        model.set_use_kernels(True)
    agree = (idx_k == idx_p).float().mean().item()
    check(agree >= 0.99, f"taste-index agreement {agree} < 0.99")

    mel_rel, mel_floor = flow_parity(model, cfg, out, x, gen, mel_len)
    check(mel_rel <= 2e-2, f"flow mel rel err {mel_rel} > 2e-2 on mel - z")
    log({"parity": {"taste_index_agreement": agree, "flow_mel_rel_err": mel_rel,
                    "flow_mel_bf16_vs_f32_rel_err": mel_floor}})
    lm = lm_prefix(cfg, x, dev)

    # ---- reconstruction in mode "SpokenLLM" ----
    launches, counts = spokenllm_path(model, cfg, x, lm, gen, n_frames, card)
    spokenllm = [launches]
    all_counts.append(counts)

    # ---- completion in the int8 tier, then in the int4 tier ----
    llama = cfg.spoken_lm.llama
    tables = {k: torch.from_numpy(v).to(dev) for k, v in
              build_sampler_tables(VocabScan(), llama.vocab_size).items()}
    scfg = SamplerConfig(
        delay=cfg.spoken_lm.delay, delay_level=cfg.spoken_lm.delay_level,
        extra_words=LM_STEPS, text_top_p=0.3, taste_top_p=0.0,
        text_temperature=0.5, repetition_penalty=1.1, has_prefix=True)
    paths, greedy = [recon, *spokenllm], {}
    for tier in ("int8", "int4"):
        if tier == "int4":
            # free the int8 model; the int4 one takes the same float
            # weights: the first draws of a generator seeded 0
            del model
            gc.collect()
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            model, cfg, _ = build_model(
                dev, torch.Generator(device=dev).manual_seed(0), "int4")
            torch.cuda.synchronize()
            log({"int4_model_init_s": time.perf_counter() - t0,
                 "serving_bytes": sum(t.numel() * t.element_size() for t in
                                      model.state_dict().values())})
        launches, counts, ids, n, run = completion_path(
            model, cfg, tier, x, lm, scfg, tables, gen, n_frames, opts.profile)
        paths.append(launches)
        all_counts.append(counts)
        greedy[tier] = (ids, n)
        if tier == "int8":
            launches, counts = streaming_path(
                model, cfg, x, lm, scfg, tables, gen, run, opts.profile)
            paths.extend(launches)
            all_counts.extend(counts)
            launches, counts = serving_path(
                model, cfg, x, lm, scfg, tables, run[0], card, opts.profile)
            paths.extend(launches)
            all_counts.extend(counts)
            launches, counts = model_axis_path(model, cfg, lm, run[0], scfg,
                                               tables, card)
            paths.append(launches)
            all_counts.append(counts)
    n = max(greedy["int8"][1], greedy["int4"][1])
    log({"int4_vs_int8_greedy_text_agreement": (
        greedy["int4"][0][:n] == greedy["int8"][0][:n]).float().mean().item(),
        "note": "information, not a gate"})
    del model
    gc.collect()
    torch.cuda.empty_cache()

    # ---- the serving tiers' fidelity gate ----
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    fidelity = serving_fidelity.main(["--reach"])
    counts = launch_counts()
    check_counts(counts, fidelity_launches(cfg, fidelity), "serving_fidelity")
    for name, row in fidelity["rows"].items():
        check(name == "f32" or all(row.get(m) is not None or m.startswith(
            "jd_taste") for m in serving_fidelity.METRICS),
              f"serving_fidelity: {name} lacks a metric: {row}")
    log({"serving_fidelity": {
        **fidelity, "wall_s": time.perf_counter() - t0,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": counts}})
    log(f"serving fidelity: JAX's trajectory floors "
        f"{'held' if fidelity['floors_pass'] else 'missed'} "
        f"{json.dumps(fidelity['floor_misses'])}")
    # each serving row computes what its own weights define: its logits
    # and its flow's field stay within TWIN_TOL of its float twin's, and
    # the reach row (doubled W2 scales) leaves them
    check(not fidelity["twin_misses"],
          f"serving_fidelity: rows leave their float twins: "
          f"{fidelity['twin_misses']}")
    check(bool(fidelity["reach"]["caught_by"]),
          "serving_fidelity: the gate is blind: the int8 row with doubled "
          "S3 W2 scales stays within every tolerance of its twin")
    gc.collect()
    torch.cuda.empty_cache()

    # ---- the stage-1 training step, then the training harness ----
    launches, counts = train_path(dev, opts.profile)
    paths.append(launches)
    all_counts.append(counts)
    launches, counts = harness_path(dev, card)
    paths.append(launches)
    all_counts.append(counts)

    # ---- the stage-2 step and its eval; the flow step ----
    launches, counts = stage2_path(dev, card, opts.profile)
    paths.append(launches)
    all_counts.extend(counts)
    all_counts.append(flow_train_path(dev, card, opts.profile))

    # ---- the decode-layout tools ----
    launches, counts = decode_layouts_path(dev)
    paths.append(launches)
    all_counts.append(counts)

    # ---- TASLM in the int8 layout; padded flash; the model variants ----
    launches, counts = taslm_path(dev, card)
    paths.append(launches)
    all_counts.extend(counts)
    for path in (padded_flash_path(dev, card), variants_path(dev, card, x)):
        paths.append(path[0])
        all_counts.append(path[1])
    gc.collect()
    torch.cuda.empty_cache()

    # ---- the offline journey: the CLIs as subprocesses ----
    launches, counts = clis_path(dev, card)
    paths.append(launches)
    all_counts.append(counts)

    launches = merge_launches(*paths)
    counts = {name: sum(c[name] for c in all_counts) for name in all_counts[0]}
    for name, shapes in launches.items():
        check(sum(shapes.values()) == counts[name],
              f"{name}: the shapes' launches do not add up to its count")
    with torch.no_grad():
        rows = kernel_rows(cfg, dev, gen, launches)
    kernels = []
    for name, source, replaces, tolerance, shapes in rows:
        check(bool(shapes), f"{name}: no shape of the main path")
        total = lambda key: sum(s[key] * s["launches"] for s in shapes)  # noqa: E731
        lib = (None if any(s["library_ms"] is None for s in shapes)
               else total("library_ms"))
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": counts[name],
            "max_abs_err": max(s["max_abs_err"] for s in shapes),
            "ms": total("ms"), "plain_ms": total("plain_ms"),
            "bound_ms": total("bound_ms"),
            "bound_by": max(shapes, key=lambda s: s["bound_ms"] * s["launches"]
                            )["bound_by"],
            "library_ms": lib, "tolerance": tolerance, "verdict": "pass",
            "per": "the counted runs (reconstruction, the SpokenLLM "
                   "reconstruction, int8 and int4 completion, the "
                   "streaming synthesis and pipelined completion, the "
                   "model axis's two ranks' joint decodes, the "
                   "serving path's ASR, batched decodes, load tests and "
                   "HTTP requests, three stage-1 steps, the training "
                   "harness's eight in-process stage-1 steps, three "
                   "stage-2 steps and the stage-2 eval, three flow "
                   "steps, the "
                   "decode-layout tools, TASLM's decode and scoring, "
                   "padded flash at the flow's shapes, the variants' "
                   "whisper encoders, the offline CLIs' generate_audio "
                   "completion, S3 topline, extract_vq and eval with "
                   "their in-process twins): per-launch times x launches; "
                   "per-shape rows in 'shapes'",
            "shapes": shapes})
    log({"total_s_after_build": time.perf_counter() - t_start})
    log({"kernels": kernels})
    log({"ok": True, "device": {"platform": "gpu",
                                "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
