#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (golf_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
1. environment: versions, the card's name and power limit; TF32 off (for
   every phase, the train phase's step times included);
2. build: the eleven CUDA kernel entry points of the serving, training and
   sharded paths (five sources, one ``nvcc`` each, started together), from
   ``golf_tpu_torch/kernels/csrc``, and ``tools/lookup_unsplit.cu`` and
   ``tools/allpole_tv_pr15.cu`` (B4's entries before the redesign of its
   zi and summary entries) beside them, with ``ptxas``'s registers and
   spills;
3. kernels vs their plain PyTorch versions, on the card, at the shapes the
   serving path (B1, B2 and its adjoint entry, B4 and its adjoint entry)
   and the training path (all seven) give them, with each one's time, its
   plain version's time and its roofline bound; B1 also at a push's window,
   each of its three shapes with ``F.grid_sample``'s time, the floor of a
   back-to-back launch (a one-element ``zero_()``), the split of its grid
   (``ops.lookup.plan_split``) and the time of B1 before the split (one
   CTA a block, ``tools/lookup_unsplit.cu``, built with the kernels);
   B2 and its adjoint entry also against their float64 mirrors
   (``allpole_const_scan64``, ``allpole_const_adjoint_scan64``), and the
   adjoint entry beside the composite it replaces (``golf_tpu``'s flips
   and shifted dots around B2, ``composite_ms``); B4 and its adjoint
   entry also against ``allpole_chunked_plain`` (the same chunked float64
   algorithm in plain PyTorch) and the adjoint entry bit for bit against
   the forward entry on the materialised flipped, column-shifted operands;
   at chunks of 512 (``chunk_for``'s length there) both bit for bit
   against ``tools/allpole_tv_pr15.cu``'s, whose times run in turns with
   theirs (``earlier_ms``);
   B1 and B2 (and its adjoint entry) also at the vocoder's serving shapes
   (``vocoder_shapes``: 601 mel frames a 6 s request); B2 also at LPCNet's
   de-emphasis, (32, 24000) with a (32, 1) of -0.85, within 1e-5 of max|y|
   of its plain version and 1e-6 of its float64 mirror; P1 (the conv
   pyramid's stage, both entries) at the recipe's four stages (B = 64 x
   2 s): within 1.5x cuDNN's fp32 error from float64, bit for bit on a
   second run, with its
   time beside the bound, the plain versions' and
   ``F.conv2d``'s under cuDNN's heuristics and in benchmark mode; then
   each autograd Function's backward through the kernels against the same
   Function on the plain versions, on the same cotangent;
   resonance: on resonant filters (capped at 0.95 and uncapped) B4's error
   against a float64 scan must be no larger than the float32 scan's, and
   B2's y and its adjoint's dx within 1e-6 of a float64 scan (da within
   1e-5 of the float64 mirror);
4. serve: the full-width Interspeech24 autoencoder (the encoder of
   ``cfg/ae/vctk.yaml``) with the GOLF-ff decoder (``golf.yaml``), then the
   GOLF-ss decoder (``golf-precise.yaml``), seeded random weights, answers
   4 synthetic 6 s requests batched as B = 4; each kernel's launch count
   must move (P1's eval entry once a pyramid stage a request batch, its
   bias-only entry never); one 2 s request is held against the port's own
   CPU run;
5. train: the same two models take 3 Adam steps each through the port's
   ``Trainer`` on B = 64 synthetic items of 2 s; every loss must be finite
   and B1, B3b, B2 and B2's adjoint entry (GOLF-ff) or B1, B3b, B4 and
   B4's adjoint entry (GOLF-ss) must launch once each a step, B3a never
   (the phase of the true f0 needs no gradient), P1's bias-only entry once
   a pyramid stage a step (its eval entry never); one step at B = 2 x 1 s
   (dropout 0, train mode) is held against the port's CPU run, loss and
   every gradient; then (phase train_f0) GOLF-ff with the phase from the
   encoder's own f0 (``learn_f0``, no f0 conditioning,
   ``train_with_true_f0`` false, not detached) takes 2 Adam steps: B3a and
   B3b once each a step, B1 never;
6. stream_kernels: B4's initial-state entry (``zi``, streaming) at
   (4, 2400, 22) and (1, 2400, 22) against its plain version (golf_tpu's
   streaming form), a float64 scan from the same state, with a null state
   bit for bit equal to a zero state, and ten chunks chained through
   ``zi_next`` against one-shot B4, and against ``allpole_chunked_plain``
   at ``chunk_for``'s length there (64); its time in turns with
   ``tools/allpole_tv_pr15.cu``'s zi entry (chunks of 512); B1 at a push's
   window shape; times beside the byte bounds;
7. stream: the full-width encoder and GOLF-ss decoder stream B = 4
   requests of 6 s in pushes of 2400 samples (60 pushes and a flush):
   ``StreamingEncoder`` (look-ahead 24 frames) against the offline encoder
   (flushed rows within 1e-4, all rows within 2e-2) and ``GOLFStream``
   against the offline decoder on the same ctrl and noise (5e-4 of
   max|y|); per-push latency of each (p50, p99, slowest), the real-time
   factor (the audio's length over the host time of every push and the
   flush, encoder and decoder together), and B1's and B4's launches a
   push;
8. test: ``test_step`` (MSS and MCD) on B = 4 x 2 s for each decoder, after
   one warm-up call, finite and within 1e-5 relative of the port's CPU
   run;
9. disk: a miniature VCTK tree (24 kHz PCM16 wavs and 5 ms ``.pv`` tracks
   of synthetic voices) under ``runs/``, and ``autoencode_torch.py fit
   --config cfg/ae/vctk.yaml --model cfg/ae/decoder/golf.yaml`` on it for 3
   steps at B = 64 x 2 s; the first batch on the card equal to the CPU
   ``VCTK`` module's bit for bit; B1, B3b, B2 and B2's adjoint entry once
   a step, B3a never;
10. fs: GOLF-fs, that checkpoint params-only in the sample-wise filters of
    ``convert2samplewise(golf.yaml)``: the CLI's ``test``, then
    ``test_step`` on the 64-segment test split card vs CPU within 1e-5
    relative, with its time and peak memory;
11. finetune: the same checkpoint params-only in
    ``golf-precise-stable.yaml``, 3 SGD steps at lr 1e-5 with
    ``coef_smooth_weight`` 0.1 through the CLI's ``fit`` (B1, B3b, B4 and
    B4's adjoint entry once a step, B3a never), and one B = 2 x 1 s SGD
    step card vs CPU;
12. baselines: the Interspeech24 baselines (``nhv.yaml``, ``mlsa.yaml``,
    ``mlsa-taylor.yaml``, ``world.yaml``: ``AdditivePulseTrain`` with
    ``LTVCepFilter``, ``LTVMLSAFilter`` freq-domain and Taylor,
    ``DiffWorldSPFilter``) on the full-width vctk encoder: each serves
    4 x 6 s (a first call, then two timed) with a 2 s request card vs CPU
    (1e-3 of max|y|), takes 3 Adam steps at B = 64 x 2 s (step times, peak
    memory) and one B = 2 x 1 s training step card vs CPU (loss 1e-4
    relative, gradients 1e-3 of max-abs, the conv pyramid 2e-2); then
    ``fit`` (2 steps) and ``test`` through the CLI for nhv and world from
    the VCTK tree; no kernel may launch on this path; a ``baselines`` JSON
    line;
    pyworld: the WORLD baseline (``autoencode_torch.py test --config
    cfg/ae/pyworld.yaml``) on the VCTK tree's test split (16 segments of
    2 s), WORLD on the host, its time; the same batch resynthesised again
    and scored on the card and the CPU, within 1e-5 relative; ``predict``
    of two utterances; no kernel; a ``pyworld`` JSON line;
13. vocoder: the ISMIR23 mel vocoder (``main_torch.py``, ``cfg/vocoder.yaml``,
    full width: 80 mels, Mel2Control 128 x 3) from a miniature MPop600 tree
    it writes (flat ``f1_NNN.wav`` and ``.pv``: 001-003 test, 004-006 valid,
    six train files of 10 s, 102 segments of 2 s at overlap 1.5): ``fit``
    with ``golf-v1.yaml``, 3 Adam steps at B = 64 x 2 s (B3a, B3b, B2 and
    B2's adjoint entry once a step, B1 never: the voicing's gradient reaches
    the phase; the first batch bit for bit the CPU ``MPop600`` module's),
    ``test`` of that checkpoint (finite MSS and f0 cents, its time);
    ``predict_step`` on B = 4 x 6 s (B1 and B2 once a call, at the vocoder's
    shapes), a 14 s request through ``chunked_ola_predict`` (three chunks in
    one call, its real-time factor), ``predict`` through the CLI on
    Synthetic data (one wav an item), a 2 s request card vs CPU (1e-3 of
    max|y|); one recipe training step at B = 2 x 1 s card vs CPU (loss 1e-4
    relative; each gradient within 1e-3 of the CPU's, or within 1e-3 or twice
    the CPU's float32 distance of a float64 CPU run); 3 Adam steps each of
    golf-v1 and ``ddsp.yaml`` (155 harmonics, no kernel) through the
    Trainer, with step times and peak memory; a ``vocoder`` JSON line;
14. lpcnet: the full-width ``cfg/lpcnet.yaml`` (80 mels, Mel2Control 128 x
    1, SampleNet Q 256 with GRUs of 192 and 32, LPC order 22) with seeded
    weights and a non-zero head: 3 steps of the recipe's Adam with amsgrad
    at B = 32 x 1 s (step times, peak memory, no kernel); one step at
    B = 2 x 0.25 s card vs CPU (the float32 loss 1e-4 relative, float64
    gradients 1e-3 of max-abs); one ``generate`` at B = 32 x 1 s (its host
    time, B2 exactly once), and at B = 2 x 0.05 s the sampling loop and
    de-emphasis card vs CPU on the same conditioning and Gumbel draws (1e-4
    of max|y|); ``main_torch.py fit`` (2 steps) and ``test`` (the
    teacher-forced metrics and one autoregressive batch, B2 once) from a
    miniature LJSpeech tree it writes (36 train, 20 test segments of 1 s);
    the float32 card step is also run with cuDNN off (restored in a
    ``finally``), its gradients within 1e-3 of max-abs of the CPU's; an
    ``lpcnet`` JSON line;
15. options: the encoder's options, GOLF's parameterisations and the
    allpass filters at full vctk width (encoder sample_rate 24000): GOLF-ff
    with ``compute_dtype: bfloat16`` and in fp32, 4 Adam steps each at
    B = 64 x 2 s in turns (step times, peak memory, launches exact); one
    B = 2 x 1 s bf16 step card vs CPU, loss and gradients within twice the
    CPU's own bf16-to-fp32 distance plus 2^-8; cuDNN's bf16 LSTM timed
    beside the mirror of golf_tpu's bf16 LSTM (and cuDNN fp32) with its
    distances; GOLF-ss with ``use_lru`` and ``include_env_features``: 3
    steps, a 4 x 6 s predict and a stream (look-ahead 24) whose every row
    is held to 1e-4 of the offline encoder's on the untrained weights; coef,
    conj, real and lsp2lpc (order 21) on golf.yaml and golf-precise.yaml, 2
    steps each, launches exact; each allpass as golf.yaml's room filter, 3
    steps and a predict (B2 and its adjoint twice a step); B2 at the allpass
    ``lfilter``'s training rows (forward and adjoint) and serving rows at
    p = 16, and a ``BatchSecondOrderLPCSynth`` section (12800, 960) at
    p = 2 (11 launches a call), each against its plain version and a
    float64 reference; an ``options`` JSON line;
16. variants: four more encoder backbones (``X2Control``,
    ``F0EnergyEncoder``, ``UNetEncoderV2``, ``TransformerEncoder``) each
    through ``autoencode_torch.py fit --config cfg/ae/vctk.yaml --model
    cfg/ae/decoder/golf.yaml model.init_args.encoder_init_args.
    backbone_type=<class>`` for 3 steps at B = 64 x 2 s from a VCTK tree
    (launches exact, the run's peak memory), each with a B = 2 x 1 s step
    card vs CPU; the ISMIR23 vocoder in the excitation domain
    (``main_torch.py fit --model cfg/ae/decoder/golf.yaml
    model.init_args.inverse_target=true``, 3 steps from an MPop600 tree: B1
    and B3b once a step, no all-pole kernel), ``predict`` of its checkpoint
    and a B = 2 x 1 s step card vs CPU; GOLF-ff with each of
    ``DownsampledWeightedGlottalFlowTable``, ``WeightedGlottalFlowTable``,
    ``UniformNoise``, ``SignFlipNoise``, ``NoiseBand(fs=24000)`` and
    ``LTVPQMF(16, 127)`` swapped in: 2 Adam steps at B = 64 x 2 s and a
    4 x 6 s predict (launches exact, the weighted tables' lookups counted at
    their shapes), a B = 2 x 1 s step card vs CPU (the noise generators on
    the same field); ``WrappedPhaseDownsampledIndexedGlottalFlowTable`` on
    (4, 144 000) wrapped phase card vs CPU (1e-5 of max|y|); B1, B3a and B3b
    at the weighted tables' training shapes, (64, 20, 2400) x
    (64, 21, 2048) and (64, 200, 240) x (64, 201, 2048), each within 2e-6
    of max|ref| of its plain version, with times, bounds and
    ``F.grid_sample``'s; a ``variants`` JSON line;
17. tools (last, on the VCTK tree of phase disk): the host libraries
    (``native/worldlite.cpp``, ``native/pesq862.cpp``) built by ``g++``
    into ``golf_tpu_torch/kernels/build/``, the PESQ label that runs;
    ``test_rtf_torch`` for golf.yaml and golf-precise.yaml at full vctk
    width on a 6 s clip, ``--num 10``: analysis and synthesis ms, RTF, x
    real time, the launch floor, B1 and B2 (GOLF-ff) or B1 and B4 (GOLF-ss)
    exactly once a synthesis at ``main_path_shapes(1, 144000)``, the
    synthesis card vs CPU within 1e-3 of max|y|, and B1, B2 and B4 held
    against their plain versions at those shapes; ``harm_and_noise_torch``
    on the test split (B1 once a chunk, B2 twice a chunk), each wav card
    vs CPU within 1e-3 of max|y|;
    ``eval_pesq_torch`` of the split against its harmonic branch (the
    scores of the card's and the CPU's resampling within 1e-6);
    ``biquads_torch`` card vs CPU (the same keys, 1e-4 relative);
    ``scripts/wav2f0_torch.py``: dio, native and swipe ``.pv`` card ==
    CPU bit for bit, penn's voicing alike on at least 99% of frames;
    PitchNet on the card tracks 110/220/330 Hz sawtooths (voiced above
    0.9, median error under 30 cents) and gates noise (above 90%);
    ``fad_torch`` with logmel, vggish and dac (``--weights random``) on
    the split against its harmonic branch, each embedding of one file card
    vs CPU within 1e-4 of max-abs, DAC's time a 5 s window and its peak
    memory; CREPE (B = 64 x 2 s, train mode; gradients against a float64
    CPU run, within 1e-3 or twice the CPU float32's distance), TTSPN (its
    defaults, the same dropout masks) over TopNGenerator's tokens, and the
    one-way LSTM, each card vs CPU (loss 1e-4 relative, gradients 1e-3 of
    max-abs; the CPU's reference runs with oneDNN off);
    ``tools/lpc_anchor_torch.py`` on a 5.5 s wav of the tree (B4's
    generic-order instantiation, p = 26, exactly once on (1, T) and no other
    kernel; the wav card vs CPU within 1e-4 of max|y|; B4 on those inputs
    against ``allpole_chunked_plain`` and a float64 scan within 1e-5 of
    max|y|, timed beside its byte bound and ``golf_tpu``'s float32 form);
    ``tools/time_l2_torch.py --iters 5`` on the test split's first item
    with phase disk's GOLF-ff checkpoint, in the run's config with
    golf.yaml's and with golf-precise.yaml's decoder (B3a, B2 and B2's
    adjoint, without ``da``, or B3a, B4 and B4's adjoint once an iteration,
    B1 and B2 or B4 once for the last decode; the iteration-0 loss card vs
    CPU within 1e-5 relative, the offsets' gradient within 1e-3 of max-abs
    or twice the CPU's float32 distance of a float64 CPU run), B1, B3a,
    B3b, B2 and B4 at its shapes against their plain versions;
    ``tools/rd_stats_torch.py --items 16`` (no kernel; card vs CPU, every
    Rd within 1e-4 of the mean); ``tools/convert_ckpt_torch.py``, a
    permutation of the head's blocks and its inverse give the checkpoint
    back bit for bit; a ``tools`` JSON line;
18. parallel: data-parallel and time-sharded training at full vctk width
    (2 s segments, dropout 0, seeded weights): ranks spawned on the one
    card over gloo (NCCL refuses two ranks on one device; the tensors and
    every kernel stay on the card, gloo carries the collectives' CUDA
    tensors through the host, and every time printed is gloo on one
    card); B4's initial-state entry, the summary entry
    (``golf_allpole_tv_summary``) and the re-run entry
    (``golf_allpole_tv_rerun``, from the summary's chunk maps) at the
    shards' shapes, (64|32|16, 24 000), each against its plain version and
    float64, the summary also against its tree mirror
    (``allpole_summary_chunked_plain``) and the re-run bit for bit against
    the zi entry, each timed in turns with ``tools/allpole_tv_pr15.cu``,
    and a direction's summary + re-run against the earlier summary + zi
    entry; B2 at a GOLF-ff shard's frames (6400, 960) against its plain
    version and float64; the single-process card step of each
    case, then DP 2 x 1 (GOLF-ss and GOLF-ff, B = 64), time 1 x 2 (both,
    B = 64) and time 2 x 2 (GOLF-ss, B = 32, four ranks), and time 1 x 2 at
    B = 64 for golf-v1, ddsp, nhv, mlsa, mlsa-taylor and world (each with
    the noise field of its unsharded source's length: ddsp's harmonic bank
    ends where its frame-rate amplitudes do), each rank's loss within 2e-4
    relative and every gradient within 5e-4 of max-abs of the
    single-process step's (for the five baselines, which launch no
    kernel, the single-process step also runs in float64, cuDNN off, and
    a gradient beyond 5e-4 passes only within twice the float32 step's own
    distance from it: the Taylor cascade's and the acoustic kernels'
    float32 gradients are that far off), each rank's launches of the
    path's kernels a step (the summary and the re-run entry exactly twice
    on GOLF-ss's time ranks, B4's zi and adjoint entries never: phase 1
    once a direction;
    B1, B3b, B2 and B2's adjoint entry on golf-v1's; none on the five
    baselines', checked 0); B1 and B3b at golf-v1's rank shapes ((64, 10,
    9600) x (64, 11, 2048)) against their plain versions, each rank's
    recorded shapes held to them and B2's to (6400, 960);
    a world-of-one NCCL ``multihost.initialize``; ``autoencode_torch.py
    fit`` under ``torchrun --nproc_per_node=2`` (gloo) for 3 steps, one
    checkpoint from rank 0; ``tools/train_pitchnet_torch.py --steps 50``
    with its time a step and its eval line; a ``parallel`` JSON line;
19. summary: a ``kernels:`` line, the card, then one JSON line with the
    kernel table; B1's and B3b's ``library_ms`` is ``F.grid_sample`` on the
    table padded with its first column, and its backward with respect to
    the table (B3a's is null: no one call returns its three outputs); B1's
    and B3a's rows carry their split, the launch floor and, under
    ``earlier_ms``, the times of ``tools/lookup_unsplit.cu`` (before the
    split) on the same inputs in this run; B4's rows (its entries, at every
    shape) carry ``chunk`` and, under ``earlier_ms``, the times of
    ``tools/allpole_tv_pr15.cu`` in turns with theirs (``turns_ms``:
    earlier, new, new, earlier), and the re-run entry's rows the direction's
    summary + re-run; B1's, B2's and its adjoint's
    rows carry ``vocoder_serve`` (the vocoder's serving shapes and the
    vocoder phase's launches), B2's ``lpcnet`` (LPCNet's de-emphasis shape,
    the lpcnet phase's launches), and B2's and its adjoint's rows the
    options' shapes (``lfilter_train``, ``lfilter_serve``, ``cascade_p2``);
    ``launches`` counts every phase, the vocoder's, LPCNet's, the
    options' and the variants' included; B1's, B3a's and B3b's rows carry
    ``weighted_ds`` and ``weighted`` (the weighted tables' shapes, with the
    variants phase's launches at them); B1's, B2's and B4's rows carry
    ``rtf`` (test_rtf_torch's shapes, the tools phase's launches there);
    the rows of B1, B3a, B3b, B2, B4 and their adjoints carry ``time_l2``
    (its shapes, launches and launches an iteration); one more row,
    ``allpole_tv_p26``: B4's generic-order instantiation at
    lpc_anchor_torch's (1, T, 26), with its float64 error;
20. last line: ``{"ok": true, "device": {...}}``.
Each phase's seconds are printed as it ends.

Needs one CUDA device, and exits non-zero without one. Imports torch and
golf_tpu_torch only.
"""

from __future__ import annotations

import contextlib
import copy
import ctypes
import inspect
import io
import json
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
from scipy.io import wavfile

from golf_tpu_torch import kernels
from golf_tpu_torch.config.registry import (convert2samplewise, instantiate,
                                            load_config)
from golf_tpu_torch.core.sig import Sig, linear_upsample
from golf_tpu_torch.models import dac
from golf_tpu_torch.models.crepe import CREPE
from golf_tpu_torch.models.rnn import LSTM
from golf_tpu_torch.models.tspn import TopNGenerator, TTSPNEncoder
from golf_tpu_torch.ops import lookup as lk
from golf_tpu_torch.ops.allpole import (allpole, allpole_const,
                                        allpole_const_adjoint_cuda,
                                        allpole_const_adjoint_plain,
                                        allpole_const_adjoint_scan64,
                                        allpole_const_cuda,
                                        allpole_const_plain,
                                        allpole_const_scan64,
                                        allpole_adjoint_cuda,
                                        allpole_adjoint_plain,
                                        allpole_chunked_plain, allpole_cuda,
                                        allpole_plain, allpole_scan,
                                        allpole_stream, allpole_stream_plain,
                                        resonant_const_inputs,
                                        resonant_inputs)
from golf_tpu_torch.ops import allpole as tap
from golf_tpu_torch.ops import pyramid as pyr
from golf_tpu_torch.ops.dsp import rc2lpc
from golf_tpu_torch.serve import GOLFStream, StreamingEncoder, chunk_ctrl
from golf_tpu_torch.tasks import cli
from golf_tpu_torch.tasks.ae import VoiceAutoEncoder, build_voice_autoencoder
from golf_tpu_torch.tasks.data import InferenceDataset, SyntheticVoiceDataset
from golf_tpu_torch.tasks.lpcnet import (LPCNetVocoder, build_lpcnet_vocoder,
                                         deemphasis, gumbel_noise)
from golf_tpu_torch.tasks.vocoder import (DDSPVocoder, build_ddsp_vocoder,
                                          chunked_ola_predict)
from golf_tpu_torch.tasks.world_ae import build_world_autoencoder
from golf_tpu_torch.train import checkpoint as ckpt_lib
from golf_tpu_torch.train.loop import (ClippedOptimizer, Trainer,
                                       trainable_parameters)
from golf_tpu_torch.utils import native, pesq862, pitchnet
from golf_tpu_torch.utils.wav import read_wav

import biquads_torch
import eval_pesq_torch
import fad_torch
import harm_and_noise_torch as t_hn
import test_rtf_torch

SEED = 0
SR = 24000
BATCH = 4
SECONDS = 6.0
CHECK_SECONDS = 2.0
TRAIN_BATCH = 64            # cfg/ae/vctk.yaml: batch 64 of 2 s segments
TRAIN_SECONDS = 2.0
TRAIN_STEPS = 3
TRAIN_CHECK_BATCH = 2       # the card-vs-CPU training step
TRAIN_CHECK_SECONDS = 1.0
STREAM_CHUNK = 2400         # samples a push (100 ms at 24 kHz)
STREAM_LOOKAHEAD = 24       # the streaming encoder's look-ahead, frames
STREAM_CHAIN = 10           # chunks chained through zi in stream_kernels
# pushes left out of the latency percentiles: the decoder's first two
# return at once, its next two run the first window of each shape (two and
# three chunks), which meets new FFT sizes
STREAM_WARM_PUSHES = 4
TEST_BATCH = 4
TEST_SECONDS = 2.0
TEST_REL_TOL = 1e-5         # test_step's MSS loss and MCD, card vs CPU
TRAIN_GRAD_TOL = 1e-3       # of each gradient's largest entry
PYRAMID_GRAD_TOL = 2e-2     # the encoder's conv pyramid (phase_train_vs_cpu)
STEP_WEIGHT_TOL = 1e-6      # weights after an optimizer step, of max|w|
# the miniature VCTK tree of the disk, fs and finetune phases
DISK_TRAIN_SPEAKERS = 16    # p300.. x 2 files x 6 s: 288 segments
DISK_VALID = ("p225", "p226")
DISK_TEST = ("p360", "p361", "p362", "p363")
DISK_SECONDS = 6.0
DISK_TEST_SECONDS = 5.5     # 8 segments a file: the test split is 64
DISK_STEPS = 3
FINETUNE_LR = 1e-5          # the SGD finetune's recipe (docs/BENCH.md)
FINETUNE_SMOOTH = 0.1
VOCODER_CONFIG = "cfg/vocoder.yaml"     # main_torch.py's default
LPCNET_CONFIG = "cfg/lpcnet.yaml"
LPCNET_BATCH = 32           # cfg/lpcnet.yaml: batch 32 of 1 s segments
LPCNET_SECONDS = 1.0
LPCNET_CHECK_SECONDS = 0.25  # the card-vs-CPU training step, B = 2
LPCNET_AR_CHECK_SECONDS = 0.05  # the card-vs-CPU generate, B = 2
LPCNET_FIT_STEPS = 2
PYWORLD_CONFIG = "cfg/ae/pyworld.yaml"
# B1 and B3a before their grid was split (one CTA a (batch, block)), built
# from tools/lookup_unsplit.cu with the kernels and timed beside B1 and B3a
# as ``earlier_ms``; they are on no path of the port
_UNSPLIT_SOURCE = str(Path(__file__).resolve().parent / "tools"
                      / "lookup_unsplit.cu")
_P, _I = ctypes.c_void_p, ctypes.c_int
UNSPLIT = kernels.CudaKernel(
    "lookup_unsplit", _UNSPLIT_SOURCE, "golf_lookup_unsplit_fwd",
    [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P], extra_flags=("--fmad=false",))
UNSPLIT_RES = kernels.CudaKernel(
    "lookup_unsplit_res", _UNSPLIT_SOURCE, "golf_lookup_unsplit_fwd_res",
    [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    extra_flags=("--fmad=false",))
# B4's entries before their redesign (tools/allpole_tv_pr15.cu: the zi and
# summary entries' first design, chunks of 512), built with the kernels and
# timed beside B4's entries as ``earlier_ms``; on no path of the port
_EARLIER_TV_SOURCE = str(Path(__file__).resolve().parent / "tools"
                         / "allpole_tv_pr15.cu")
EARLIER_CHUNK = 512
EARLIER_TV = kernels.CudaKernel(
    "allpole_tv_earlier", _EARLIER_TV_SOURCE, "golf_allpole_tv_earlier",
    [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P])
EARLIER_TV_ADJ = kernels.CudaKernel(
    "allpole_tv_adjoint_earlier", _EARLIER_TV_SOURCE,
    "golf_allpole_tv_earlier_adjoint", [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                     _P])
EARLIER_TV_SUMMARY = kernels.CudaKernel(
    "allpole_tv_summary_earlier", _EARLIER_TV_SOURCE,
    "golf_allpole_tv_earlier_summary", [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                     _P])
EARLIER = (UNSPLIT, UNSPLIT_RES, EARLIER_TV, EARLIER_TV_ADJ,
           EARLIER_TV_SUMMARY)
# the encoder's kernels (P1: the conv pyramid's stage) and the decoders'
# (B1-B4): each phase's launch checks count the decoders' kernels; P1's
# launches are checked where the recipe's encoder runs (serve, train)
PYRAMID = (kernels.PYRAMID_CONV, kernels.PYRAMID_CONV_EVAL)
DSP_KERNELS = tuple(k for k in kernels.ALL if k not in PYRAMID)
# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth, fp32 and fp64
# (outside the tensor cores)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
PEAK_FP64_FLOPS = 34e12

# ---------------------------------------------------------------------------
# Model configuration: cfg/ae/vctk.yaml's model.init_args with the decoder
# of cfg/ae/decoder/golf.yaml or golf-precise.yaml (interpolations resolved)
# ---------------------------------------------------------------------------

_ENCODER = {
    "f0_min": 60.0, "f0_max": 1000.0,
    "backbone_type": "models.unet.UNetEncoder",
    "n_fft": 1024, "hop_length": 240,
    "channels": [32, 64, 128, 256], "strides": [4, 4, 4, 4],
    "lstm_hidden_size": 256, "num_layers": 3, "dropout": 0.1,
    "learn_voicing": False, "learn_f0": False,
}
_MODEL = {
    "encoder_class_path": "models.enc.VocoderParameterEncoderInterface",
    "encoder_init_args": _ENCODER,
    "decoder": None,
    "criterion": {"class_path": "loss.spec.MSSLoss",
                  "init_args": {"n_ffts": [509, 1021, 2053], "alpha": 1.0,
                                "window": "hanning", "center": True}},
    "sample_rate": 24000,
    "voicing_loss_weight": 1.0, "f0_loss_weight": 1.0,
    "detach_voicing": True, "detach_f0": True, "train_with_true_f0": True,
}
_HARM = {
    "class_path": "models.synth.DownsampledIndexedGlottalFlowTable",
    "init_args": {"hop_rate": 10, "in_channels": 64, "oversampling": 4,
                  "equal_energy": True, "table_type": "derivative",
                  "normalize_method": "constant_power", "align_peak": True,
                  "trainable": False, "min_R_d": 0.3, "max_R_d": 2.7,
                  "lf_v2": True, "points": 2048},
}
_END_FILTERS = {
    "golf": {"class_path": "models.filters.LTVMinimumPhaseFilter",
             "init_args": {"window": "hanning", "window_length": 960,
                           "lpc_order": 22,
                           "lpc_parameterisation": "rc2lpc"}},
    "golf-precise": {"class_path":
                     "models.filters.LTVMinimumPhaseFilterPrecise",
                     "init_args": {"lpc_order": 22,
                                   "lpc_parameterisation": "rc2lpc"}},
    "golf-precise-stable": {"class_path":
                            "models.filters.LTVMinimumPhaseFilterPrecise",
                            "init_args": {"lpc_order": 22,
                                          "lpc_parameterisation": "rc2lpc",
                                          "max_abs_value": 0.98}},
}


# the Interspeech24 baselines (phase "baselines"): their decoder nodes are
# read from the checkout's YAML
BASELINES = ("nhv", "mlsa", "mlsa-taylor", "world")
_CFG_DIR = Path(__file__).resolve().parent / "cfg" / "ae" / "decoder"


def model_config(decoder: str) -> dict:
    """model.init_args for ``cfg/ae/vctk.yaml`` + ``cfg/ae/decoder/<decoder>
    .yaml``."""
    cfg = copy.deepcopy(_MODEL)
    if decoder not in _END_FILTERS:
        cfg["decoder"] = load_config([str(_CFG_DIR / f"{decoder}.yaml")])[
            "decoder"]
        return cfg
    cfg["decoder"] = {
        "class_path": "models.sf.SourceFilterSynth",
        "init_args": {
            "harm_oscillator": copy.deepcopy(_HARM),
            "noise_generator": {
                "class_path": "models.noise.StandardNormalNoise"},
            "noise_filter": {"class_path":
                             "models.filters.LTVZeroPhaseFIRFilter",
                             "init_args": {"window": "hanning",
                                           "n_mag": 256}},
            "end_filter": copy.deepcopy(_END_FILTERS[decoder]),
            "room_filter": {"class_path": "models.filters.LTIAcousticFilter",
                            "init_args": {"length": 128,
                                          "conv_method": "fft"}},
            "subtract_harmonics": False,
        }}
    return cfg


def main_path_shapes(batch: int, t: int) -> dict:
    """Operand shapes each kernel gets from the serving or training path for
    ``batch`` clips of ``t`` samples at the vctk widths (hop 240, 4x
    oversampling, table hop 10 frames, 960-sample GOLF-ff windows, order
    22). B3b's second shape is that of the table cotangent it returns."""
    hop, os_, p = 240, 4, 22
    frames = -(-t // hop)                      # f0 frames (spectrogram: +1)
    table_rows = (frames + 2 * 5 - 10) // 10 + 1
    t_os = (t - 1) * os_ + 1
    hop_os = hop * 10 * os_
    blocks = -(-t_os // hop_os)
    # the noise filter's frame-wise output is (frames - 1) * hop samples
    t_src = min(t, (frames - 1) * hop)
    t_ss = min(t_src, (frames - 1) * hop + 1)
    n_ff = batch * min((t_ss + 960 - 960) // hop + 1, frames)
    lookup = ((batch, blocks, hop_os), (batch, table_rows, 2048))
    return {
        "lookup": lookup,
        "lookup_res": lookup,
        "lookup_dtab": lookup,
        "allpole_const": ((n_ff, 960), (n_ff, p)),
        "allpole_const_adjoint": ((n_ff, 960), (n_ff, p)),
        "allpole_tv": ((batch, t_ss), (batch, t_ss, p)),
        "allpole_tv_adjoint": ((batch, t_ss), (batch, t_ss, p)),
    }


def stream_shapes(batch: int) -> dict:
    """Operand shapes of B1 and B4 in a streaming push past the first: the
    window of three chunks (4x oversampled, table hop 9600) with three
    table rows and one of look-ahead; B4 on the central chunk."""
    hop_os = 240 * 10 * 4
    blocks = -(-((3 * STREAM_CHUNK - 1) * 4 + 1) // hop_os)
    rows = 3 * STREAM_CHUNK // 2400 + 1
    return {"lookup": ((batch, blocks, hop_os), (batch, rows, 2048)),
            "allpole_tv": ((batch, STREAM_CHUNK), (batch, STREAM_CHUNK, 22))}


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _sleep_cycles_per_ms() -> float:
    """Clock cycles of ``torch.cuda._sleep`` per millisecond, measured."""
    cycles = 10_000_000
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(cycles)
    stop.record()
    torch.cuda.synchronize()
    return cycles / start.elapsed_time(stop)


def cuda_ms(fn, reps: int, warmup: int = 2, strict: bool = True) -> float:
    """Mean device milliseconds per call, by CUDA events around ``reps``
    calls. A short kernel launches faster on the device than the host can
    issue it, so the stream is first held busy (``torch.cuda._sleep``) for
    longer than the host takes to enqueue the ``reps`` calls: the events
    then time the device's back-to-back work, not the host's launch rate.
    If the device reached the start event before the host had enqueued the
    last call (the hold ran out: the SM clock rose after the sleep's
    calibration, or the host ran slower than when it was timed), a
    ``strict`` timing (a kernel's, or one library call's) is repeated with
    twice the hold, up to three times, and then raises rather than report
    the host's rate. A plain version of many launches a call
    (``strict=False``) can fill the device's launch queue, and the host then
    waits for the device whatever the hold: its time is the device's for
    work fed as fast as the host can, that version's own cost."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    hold_ms = 2 * (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    for _ in range(4):
        torch.cuda._sleep(int(hold_ms * _sleep_cycles_per_ms()) + 1000)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        held = not start.query()
        torch.cuda.synchronize()
        if held or not strict:
            return start.elapsed_time(stop) / reps
        hold_ms *= 2
    raise RuntimeError("cuda_ms: the device reached the start event before "
                       "the host had enqueued the timed calls, four times")


def bound(nbytes: float, flops: float, fp64: bool = False):
    """Roofline bound in ms and what sets it: ``flops`` at the fp32 peak,
    or the fp64 peak for a float64 kernel."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / (PEAK_FP64_FLOPS if fp64 else PEAK_FP32_FLOPS) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def lpc_coeffs(gen: torch.Generator, shape, device) -> torch.Tensor:
    """Coefficients as the model makes them: rc2lpc(tanh(logits)). The
    logits' scale (0.2) keeps the plain version's blocked two-pass form
    accurate: its error grows with the filter's gain (about 1e-6 of max|y|
    here, a few percent at a scale of 0.5, on the CPU in fp32). Resonant
    filters, where that form fails, are ``phase_resonance``'s."""
    logits = 0.2 * torch.randn(shape, generator=gen, device=device)
    return rc2lpc(torch.tanh(logits)).contiguous()


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_environment() -> str:
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}  devices {torch.cuda.device_count()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        else f"nvidia-smi failed: {smi.stderr.strip()}"
    print(f"card: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("TF32 off for matmul and cuDNN (parity phases compare fp32)")
    return card


def entry_name(mangled: str) -> str:
    """``ring_kernel<2, 4>`` from a mangled kernel name: the innermost of its
    length-prefixed names and its integer or bool template arguments."""
    i = 3 if mangled.startswith("_ZN") else 2
    name = mangled
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        name, i = mangled[j:j + int(mangled[i:j])], j + int(mangled[i:j])
    args = re.match(r"I((?:L[a-z]\d+E)+)E", mangled[i:])
    if args:
        name += f"<{', '.join(re.findall(r'L[a-z](\d+)E', args.group(1)))}>"
    return name


def phase_build() -> None:
    log: dict = {}
    seconds = kernels.build(kernels.ALL + EARLIER, log)
    print(f"build: {seconds:.1f} s for {len(kernels.ALL)} kernels "
          f"({', '.join(k.source for k in kernels.ALL)}), B1 and B3a "
          f"before the split (tools/lookup_unsplit.cu) and B4 before its "
          f"zi and summary entries' redesign (tools/allpole_tv_pr15.cu)")
    for name, out in log.items():
        entry = "?"
        for ln in out.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", ln)
            if m:
                entry = entry_name(m.group(1))
            elif "registers" in ln or "spill" in ln:
                ln = ln.replace("ptxas info    :", "").strip()
                print(f"  ptxas[{Path(name).name}] {entry}: {ln}")


def earlier_tv(kernel, x: torch.Tensor, a: torch.Tensor,
               zi: torch.Tensor = None) -> torch.Tensor:
    """B4's forward (or adjoint) entry before the redesign, at chunks of
    512, with its scratch: maps of all chunks but the last, then incoming
    states."""
    b, t = x.shape
    p = a.shape[2]
    k = -(-t // EARLIER_CHUNK)
    y = torch.empty_like(x)
    scratch = torch.empty(b * ((k - 1) * (p + 1) * p + k * p),
                          dtype=torch.float64, device=x.device)
    kernel.launch(x.data_ptr(), a.data_ptr(),
                  None if zi is None else zi.data_ptr(), y.data_ptr(),
                  scratch.data_ptr(), b, t, p, EARLIER_CHUNK,
                  x.device.index, torch.cuda.current_stream().cuda_stream)
    return y


def earlier_summary(x: torch.Tensor, a: torch.Tensor):
    """The summary entry before the redesign: (M, v) in float64."""
    b, t = x.shape
    p = a.shape[2]
    m = torch.empty((b, p, p), dtype=torch.float64, device=x.device)
    v = torch.empty((b, p), dtype=torch.float64, device=x.device)
    scratch = torch.empty(b * -(-t // EARLIER_CHUNK) * (p + 1) * p,
                          dtype=torch.float64, device=x.device)
    EARLIER_TV_SUMMARY.launch(
        x.data_ptr(), a.data_ptr(), m.data_ptr(), v.data_ptr(),
        scratch.data_ptr(), b, t, p, EARLIER_CHUNK, x.device.index,
        torch.cuda.current_stream().cuda_stream)
    return m, v


def lookup_inputs(gen, shapes):
    (b, blocks, hop), tab_shape = shapes["lookup"]
    ph = torch.rand((b, blocks, hop), generator=gen, device="cuda")
    tables = torch.randn(tab_shape, generator=gen, device="cuda")
    return ph, tables, hop


def tv_coeffs(gen, b: int, t: int, p: int = 22) -> torch.Tensor:
    """Sample-rate coefficients upsampled from 240-sample frames, as the
    GOLF-ss filter makes them."""
    frames = -(-t // 240) + 1
    return linear_upsample(lpc_coeffs(gen, (b, frames, p), "cuda"), 240,
                           axis=1)[:, :t].contiguous()


def allpole_tv_inputs(gen, shapes):
    """x and the coefficients at B4's shapes in ``shapes``."""
    x_shape, a_shape = shapes["allpole_tv"]
    x = torch.randn(x_shape, generator=gen, device="cuda")
    return x, tv_coeffs(gen, *x_shape, a_shape[2])


def rel_err(out: torch.Tensor, ref: torch.Tensor) -> float:
    return ((out - ref).abs().max() / ref.abs().max()).item()


def grid_sample_operands(ph: torch.Tensor, tables: torch.Tensor, hop: int):
    """B1's lookup as ``F.grid_sample``'s operands (bilinear,
    align_corners): the tables padded with their first column, the wrap
    of ``golf_tpu/ops/lookup_pallas.py`` ((B, 1, rows, S + 1)), and one
    output row of blocks x hop points, x at column ph * S, y at row
    k + i / hop ((B, 1, blocks * hop, 2))."""
    b, blocks, _ = ph.shape
    rows = tables.shape[1]
    padded = torch.cat([tables, tables[..., :1]], dim=-1)[:, None]
    y = (torch.arange(blocks, device=ph.device)[:, None]
         + torch.arange(hop, device=ph.device) / hop)
    gy = (2 * y / (rows - 1) - 1).expand(b, blocks, hop)
    grid = torch.stack([2 * ph - 1, gy], dim=-1).reshape(b, 1, -1, 2)
    return padded.contiguous(), grid.contiguous()


def grid_sample_lookup(padded, grid):
    return torch.nn.functional.grid_sample(
        padded, grid, mode="bilinear", padding_mode="zeros",
        align_corners=True)


def grid_sample_dtab(g, padded, grid):
    """The padded table's cotangent alone (``grid_sample``'s backward with
    the grid's gradient masked off)."""
    return torch.ops.aten.grid_sampler_2d_backward(
        g.reshape(g.shape[0], 1, 1, -1), padded, grid, 0, 0, True,
        [True, False])[0]


def library_lookup_row(ph, tables, hop, label, dtab=False) -> dict:
    """``grid_sample``'s time and error against the plain lookup (B1) and,
    with ``dtab``, its backward's against the plain table cotangent (B3b,
    the padded column folded back into column 0)."""
    padded, grid = grid_sample_operands(ph, tables, hop)
    out = grid_sample_lookup(padded, grid).reshape(ph.shape)
    err = (out - lk.lookup_blocks_plain(ph, tables, hop)).abs().max().item()
    row = {"library_ms": cuda_ms(lambda: grid_sample_lookup(padded, grid),
                                 50),
           "library_err": err}
    print(f"[{label}] library yardstick F.grid_sample (bilinear, "
          f"align_corners, table padded with its first column) "
          f"{tuple(ph.shape)}: {row['library_ms'] * 1e3:.1f} us, max abs "
          f"err against the plain lookup {err:.3e}")
    if dtab:
        g = torch.randn(ph.shape, generator=torch.Generator(
            device="cuda").manual_seed(SEED + 21), device="cuda")
        s = tables.shape[-1]
        d = grid_sample_dtab(g, padded, grid)[:, 0]
        d = torch.cat([d[..., :1] + d[..., s:], d[..., 1:s]], dim=-1)
        rel = rel_err(d, lk.lookup_dtab_plain(ph, g, hop, tables.shape[1], s))
        row.update(dtab_library_ms=cuda_ms(
            lambda: grid_sample_dtab(g, padded, grid), 20),
            dtab_library_err=rel)
        print(f"[{label}] library yardstick grid_sample's backward, table "
              f"only: {row['dtab_library_ms'] * 1e3:.1f} us, error of the "
              f"folded cotangent against the plain B3b {rel:.3e} of max|ref|")
    return row


def launch_floor_ms() -> float:
    """The floor of a back-to-back launch: a one-element ``zero_()``, timed
    as the kernels are."""
    z = torch.zeros(1, device="cuda")
    return cuda_ms(z.zero_, 500)


def split_of(ph, tables) -> dict:
    """The split B1 and B3a launch with (``ops.lookup.plan_split``)."""
    plan = lk.cuda_plan(ph, tables)
    return {"splits": plan.splits, "piece": plan.piece,
            "ctas": ph.shape[0] * ph.shape[1] * plan.splits}


def unsplit_fwd(ph, tables, hop):
    """B1 before the split (tools/lookup_unsplit.cu)."""
    out = torch.empty_like(ph)
    UNSPLIT.launch(ph.data_ptr(), tables.data_ptr(), out.data_ptr(),
                   *ph.shape, *tables.shape[1:], ph.device.index,
                   torch.cuda.current_stream().cuda_stream)
    return out


def unsplit_res(ph, tables, hop):
    """B3a before the split: (out, d_top, d_bot)."""
    outs = [torch.empty_like(ph) for _ in range(3)]
    UNSPLIT_RES.launch(ph.data_ptr(), tables.data_ptr(),
                       *(o.data_ptr() for o in outs), *ph.shape,
                       *tables.shape[1:], ph.device.index,
                       torch.cuda.current_stream().cuda_stream)
    return outs


def lookup_row(ph, tables, hop, label, reps, dtab=False) -> dict:
    """B1 against its plain version (2e-6 absolute), with its time, its
    plain version's, its byte bound, ``F.grid_sample``'s time (and, with
    ``dtab``, its backward's), the launch floor, the split and the time of
    B1 before the split (held to the same tolerance)."""
    ref = lk.lookup_blocks_plain(ph, tables, hop)
    err = (lk.lookup_blocks_cuda(ph, tables, hop) - ref).abs().max().item()
    old_err = (unsplit_fwd(ph, tables, hop) - ref).abs().max().item()
    split = split_of(ph, tables)
    print(f"[{label}] lookup (B1) {tuple(ph.shape)} x "
          f"{tuple(tables.shape)}: max abs err {err:.3e} (tolerance 2e-6; "
          f"before the split {old_err:.3e}); split {split}")
    check(err <= 2e-6, f"lookup vs plain ({label})")
    check(old_err <= 2e-6, f"lookup before the split vs plain ({label})")
    n_el = ph.numel()
    return dict(
        err=err,
        ms=cuda_ms(lambda: lk.lookup_blocks_cuda(ph, tables, hop), reps),
        earlier_ms=cuda_ms(lambda: unsplit_fwd(ph, tables, hop), reps),
        plain_ms=cuda_ms(lambda: lk.lookup_blocks_plain(ph, tables, hop), 10,
                         strict=False),
        bound=bound(4 * (2 * n_el + tables.numel()), 15 * n_el),
        floor_ms=launch_floor_ms(), split=split,
        shapes=[list(ph.shape), list(tables.shape)],
        **library_lookup_row(ph, tables, hop, label, dtab=dtab))


def print_lookup_summary(rows: dict) -> None:
    """B1 at each shape (``rows``: label -> lookup_row) beside its bound,
    grid_sample, the launch floor and its time before the split."""
    for label, r in rows.items():
        sp = r["split"]
        print(f"B1 at {label} {tuple(r['shapes'][0])}: "
              f"{r['ms'] * 1e3:.2f} us (before the split "
              f"{r['earlier_ms'] * 1e3:.2f}), bound "
              f"{r['bound'][0] * 1e3:.2f} us ({r['bound'][0] / r['ms']:.0%}"
              f" of it reached), F.grid_sample "
              f"{r['library_ms'] * 1e3:.2f} us, launch floor "
              f"{r['floor_ms'] * 1e3:.2f} us; {sp['splits']} pieces of "
              f"{sp['piece']} samples a block, {sp['ctas']} CTAs")


def phase_kernels(shapes: dict, which=("lookup", "allpole_const",
                                       "allpole_tv"), label="serve") -> dict:
    """Each kernel against its plain version on the same inputs, with its
    time, the plain version's time and the roofline bound. "allpole_const"
    covers B2 and its adjoint entry."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = {}
    ph, tables, hop = lookup_inputs(gen, shapes)
    n_el = ph.numel()
    if "lookup" in which:
        rows["lookup"] = lookup_row(ph, tables, hop, label,
                                    200 if label == "push" else 100,
                                    dtab="lookup_dtab" in which)
    if "lookup_res" in which:
        outs = lk.lookup_res_cuda(ph, tables, hop)
        refs = lk.lookup_res_plain(ph, tables, hop)
        errs = [(o - r).abs().max().item() for o, r in zip(outs, refs)]
        print(f"[{label}] lookup_res (B3a) {tuple(ph.shape)} x "
              f"{tuple(tables.shape)}: max abs err out {errs[0]:.3e} "
              f"(tolerance 2e-6, as B1), d_top {errs[1]:.3e}, d_bot "
              f"{errs[2]:.3e} (tolerance 0: differences of the same "
              f"gathered values)")
        check(errs[0] <= 2e-6 and errs[1] == 0 and errs[2] == 0,
              "lookup_res vs plain")
        olds = unsplit_res(ph, tables, hop)
        check(all(torch.equal(o, n) for o, n in zip(olds[1:], outs[1:]))
              and (olds[0] - refs[0]).abs().max().item() <= 2e-6,
              "lookup_res before the split vs plain")
        rows["lookup_res"] = dict(
            err=max(errs),
            ms=cuda_ms(lambda: lk.lookup_res_cuda(ph, tables, hop), 50),
            earlier_ms=cuda_ms(lambda: unsplit_res(ph, tables, hop), 50),
            plain_ms=cuda_ms(lambda: lk.lookup_res_plain(ph, tables, hop),
                             5, strict=False),
            bound=bound(4 * (4 * n_el + tables.numel()), 17 * n_el),
            split=split_of(ph, tables))
        r = rows["lookup_res"]
        print(f"B3a at {label} {tuple(ph.shape)}: {r['ms'] * 1e3:.2f} us "
              f"(before the split {r['earlier_ms'] * 1e3:.2f}), bound "
              f"{r['bound'][0] * 1e3:.2f} us; split {r['split']}")
    if "lookup_dtab" in which:
        g = torch.randn(ph.shape, generator=gen, device="cuda")
        frames, s = tables.shape[1], tables.shape[2]
        out = lk.lookup_dtab_cuda(ph, g, hop, frames, s)
        ref = lk.lookup_dtab_plain(ph, g, hop, frames, s)
        err = (out - ref).abs().max().item()
        rel = err / ref.abs().max().item()
        print(f"[{label}] lookup_dtab (B3b) {tuple(ph.shape)} -> "
              f"{tuple(out.shape)}: max abs err {err:.3e}, / max|ref| "
              f"{rel:.3e} (tolerance 1e-5: shared-memory atomics add in "
              f"an order that changes from run to run)")
        check(rel <= 1e-5 and out.shape == tables.shape,
              "lookup_dtab vs plain")
        rows["lookup_dtab"] = dict(
            err=err,
            ms=cuda_ms(lambda: lk.lookup_dtab_cuda(ph, g, hop, frames, s),
                       50),
            plain_ms=cuda_ms(lambda: lk.lookup_dtab_plain(ph, g, hop, frames,
                                                          s), 5,
                             strict=False),
            bound=bound(4 * (2 * n_el + out.numel()), 20 * n_el))

    if "allpole_const" in which:
        x_shape, a_shape = shapes["allpole_const"]
        x = torch.randn(x_shape, generator=gen, device="cuda")
        a = lpc_coeffs(gen, a_shape, "cuda")
        g = torch.randn(x_shape, generator=gen, device="cuda")
        out = allpole_const_cuda(x, a)
        ref = allpole_const_plain(x, a)
        err = (out - ref).abs().max().item()
        rel = err / ref.abs().max().item()
        rel64 = rel_err(out, allpole_const_scan64(x, a))
        print(f"[{label}] allpole_const (B2) {tuple(x.shape)} p={a.shape[1]}:"
              f" max err {err:.3e}, / max|y| {rel:.3e} against "
              f"allpole_const_plain (tolerance 1e-5: float64 sequential vs "
              f"golf_tpu's float32 blocked form); {rel64:.3e} against "
              f"allpole_const_scan64 (tolerance 1e-6: the same float64 "
              f"recurrence, sums in another order)")
        check(rel <= 1e-5 and rel64 <= 1e-6
              and torch.isfinite(out).all().item(), "allpole_const vs plain")
        n, t = x.shape
        p = a.shape[1]
        rows["allpole_const"] = dict(
            err=err, ms=cuda_ms(lambda: allpole_const_cuda(x, a), 50),
            plain_ms=cuda_ms(lambda: allpole_const_plain(x, a), 3,
                             strict=False),
            bound=bound(4 * (2 * n * t + n * p), 2 * p * n * t, fp64=True))

        dx, da = allpole_const_adjoint_cuda(g, out, a)
        dx64, da64 = allpole_const_adjoint_scan64(g, out, a)
        dxp, dap = allpole_const_adjoint_plain(g, out, a)
        errs64 = [rel_err(dx, dx64), rel_err(da, da64)]
        errs = [rel_err(dx, dxp), rel_err(da, dap)]
        print(f"[{label}] allpole_const_adjoint {tuple(g.shape)}: dx "
              f"{errs64[0]:.3e}, da {errs64[1]:.3e} of max|ref| against "
              f"allpole_const_adjoint_scan64 (tolerance 1e-6); dx "
              f"{errs[0]:.3e}, da {errs[1]:.3e} against "
              f"allpole_const_adjoint_plain (tolerance 1e-4: float64 vs "
              f"golf_tpu's float32 blocked run and dots)")
        check(max(errs64) <= 1e-6 and max(errs) <= 1e-4,
              "allpole_const_adjoint vs mirror and plain")
        rows["allpole_const_adjoint"] = dict(
            err=max((dx - dxp).abs().max().item(),
                    (da - dap).abs().max().item()),
            ms=cuda_ms(lambda: allpole_const_adjoint_cuda(g, out, a), 50),
            plain_ms=cuda_ms(lambda: allpole_const_adjoint_plain(g, out, a),
                             3, strict=False),
            composite_ms=cuda_ms(lambda: tap._const_adjoint_composite(
                allpole_const_cuda, g, out, a), 10, strict=False),
            bound=bound(4 * (3 * n * t + 2 * n * p), 4 * p * n * t,
                        fp64=True))

    if "allpole_tv" in which:
        x, a = allpole_tv_inputs(gen, shapes)
        g = torch.randn(x.shape, generator=gen, device="cuda")
        out = allpole_cuda(x, a)
        ref = allpole_plain(x, a)
        rel = rel_err(out, ref)
        print(f"[{label}] allpole_tv (B4) {tuple(x.shape)} p={a.shape[2]}: "
              f"/ max|y| {rel:.3e} against allpole_plain (tolerance 1e-4: "
              f"chunked float64 vs golf_tpu's float32 two-pass blocked "
              f"form)")
        check(rel <= 1e-4 and torch.isfinite(out).all().item(),
              "allpole_tv vs plain")
        dx = allpole_adjoint_cuda(g, a)
        errs = [rel_err(out, allpole_chunked_plain(x, a)),
                rel_err(dx, allpole_chunked_plain(g, a, adjoint=True))]
        c = torch.flip(tap._shift_columns(a), (1,)).contiguous()
        same = torch.equal(dx, torch.flip(allpole_cuda(
            torch.flip(g, (1,)).contiguous(), c), (1,)))
        del c
        print(f"[{label}] allpole_tv (B4) and allpole_tv_adjoint against "
              f"allpole_chunked_plain on the card: {errs[0]:.3e}, "
              f"{errs[1]:.3e} of max|y| (tolerance 1e-5: the same float64 "
              f"algorithm, sums in other orders); adjoint entry == forward "
              f"entry on the materialised flip(_shift_columns(a)), flip(g): "
              f"{same}")
        check(max(errs) <= 1e-5, "allpole_tv and its adjoint vs mirror")
        check(same, "adjoint entry bit for bit")
        chunk = tap.chunk_for(*x.shape)
        # at chunks of 512 the redesign's arithmetic is the earlier
        # design's (only the taps' loads and the maps' stride changed)
        same_old = torch.equal(out, earlier_tv(EARLIER_TV, x, a)) and \
            torch.equal(dx, earlier_tv(EARLIER_TV_ADJ, g, a))
        print(f"[{label}] allpole_tv (B4) at chunk_for's {chunk}: forward "
              f"and adjoint == tools/allpole_tv_pr15.cu's (chunks of 512) "
              f"bit for bit: {same_old}")
        check(same_old or chunk != EARLIER_CHUNK,
              "B4 and its adjoint equal the earlier design at 512")
        nbytes = 4 * (2 * x.numel() + a.numel())
        n_maps = x.shape[0] * (-(-x.shape[1] // chunk) - 1) * chunk
        p = a.shape[2]
        # the design's float64 floor: p (p + 1) FMAs a sample in phase 1,
        # p in phase 3
        floor_ms = 2 * p * ((p + 1) * n_maps + x.numel()) \
            / PEAK_FP64_FLOPS * 1e3
        # earlier design and this one in turns (earlier, new, new,
        # earlier), the rows keep the means
        e1 = cuda_ms(lambda: earlier_tv(EARLIER_TV, x, a), 20)
        n1 = cuda_ms(lambda: allpole_cuda(x, a), 20)
        ea1 = cuda_ms(lambda: earlier_tv(EARLIER_TV_ADJ, g, a), 20)
        na1 = cuda_ms(lambda: allpole_adjoint_cuda(g, a), 20)
        na2 = cuda_ms(lambda: allpole_adjoint_cuda(g, a), 20)
        ea2 = cuda_ms(lambda: earlier_tv(EARLIER_TV_ADJ, g, a), 20)
        n2 = cuda_ms(lambda: allpole_cuda(x, a), 20)
        e2 = cuda_ms(lambda: earlier_tv(EARLIER_TV, x, a), 20)
        rows["allpole_tv"] = dict(
            err=(out - ref).abs().max().item(), ms=(n1 + n2) / 2,
            earlier_ms=(e1 + e2) / 2, turns_ms=[e1, n1, n2, e2],
            chunk=chunk,
            plain_ms=cuda_ms(lambda: allpole_plain(x, a), 1, warmup=1,
                             strict=False),
            bound=bound(nbytes, 2 * a.numel()), fp64_floor_ms=floor_ms)
        dref = allpole_adjoint_plain(g, a)
        rows["allpole_tv_adjoint"] = dict(
            err=(dx - dref).abs().max().item(), ms=(na1 + na2) / 2,
            earlier_ms=(ea1 + ea2) / 2, turns_ms=[ea1, na1, na2, ea2],
            chunk=chunk,
            plain_ms=cuda_ms(lambda: allpole_adjoint_plain(g, a), 1,
                             warmup=1, strict=False),
            bound=bound(nbytes, 2 * a.numel()), fp64_floor_ms=floor_ms)
        for name in ("allpole_tv", "allpole_tv_adjoint"):
            r = rows[name]
            print(f"[{label}] {name} at chunk {chunk}: {r['ms'] * 1e3:.1f} "
                  f"us, before the redesign {r['earlier_ms'] * 1e3:.1f} us "
                  f"(in turns, us: "
                  f"{[round(u * 1e3, 1) for u in r['turns_ms']]})")
        rel = rel_err(dx, dref)
        print(f"[{label}] allpole_tv_adjoint {tuple(g.shape)}: / max|ref| "
              f"{rel:.3e} against allpole_adjoint_plain (tolerance 1e-4, "
              f"as the forward)")
        check(rel <= 1e-4, "allpole_tv_adjoint vs plain")
    return rows


# the recipe's pyramid stages at the training shapes (cfg/ae/vctk.yaml:
# 513 bins; 2 s at hop 240 is 200 frames on the f0 grid): (Cin, Cout, F),
# s = 4
PYRAMID_STAGES = ((1, 32, 513), (32, 64, 128), (64, 128, 32), (128, 256, 8))
PYRAMID_T = 200
PYRAMID_S = 4


def pyramid_stage_inputs(batch: int, cin: int, cout: int, f: int, t: int,
                         s: int, seed: int):
    """x (batch, cin, f, t), a seeded conv and an eval-mode batch norm with
    seeded running statistics and scales of both signs."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    conv = torch.nn.Conv2d(cin, cout, (2 * s + 1, 3), padding=(s, 1)).cuda()
    norm = torch.nn.BatchNorm2d(cout, eps=1e-5).cuda()
    with torch.no_grad():
        conv.weight.copy_(torch.randn(conv.weight.shape, generator=gen,
                                      device="cuda")
                          / (cin * 3 * (2 * s + 1)) ** 0.5)
        conv.bias.copy_(0.1 * torch.randn(cout, generator=gen,
                                          device="cuda"))
        norm.running_var.uniform_(0.5, 2.0, generator=gen)
        norm.running_mean.normal_(0.0, 0.2, generator=gen)
        norm.weight.normal_(0.0, 1.0, generator=gen)
    x = torch.randn((batch, cin, f, t), generator=gen, device="cuda")
    return x, conv.eval(), norm.eval()


def pyramid_stage64(x, conv, norm, s: int) -> torch.Tensor:
    """The eval stage in float64: conv, batch norm, ReLU, the pool."""
    y = torch.nn.functional.conv2d(x.double(), conv.weight.double(),
                                   conv.bias.double(), padding=(s, 1))
    y = torch.nn.functional.batch_norm(
        y, norm.running_mean.double(), norm.running_var.double(),
        norm.weight.double(), norm.bias.double(), False, 0.0, norm.eps)
    return pyr.strided_max(torch.relu(y), s, axis=2)


def phase_pyramid() -> list:
    """P1's two entries at the recipe's four stages, B = 64 x 2 s: each
    one's max-abs error from float64 within 1.5x cuDNN's fp32 error on the
    same inputs (TF32 off; tests/test_torch_cuda.py's criterion); bit for
    bit on a second run; their times beside the bound (operations
    at the fp32 peak, or bytes where more: stage 1's output), their plain
    versions' (``F.conv2d``; the eval chain conv, batch norm, ReLU, pool)
    and the library's: ``F.conv2d`` under cuDNN's heuristics, and under
    ``torch.backends.cudnn.benchmark``, set only around that timing.
    Returns a row a stage."""
    s, t, rows = PYRAMID_S, PYRAMID_T, []
    for i, (cin, cout, f) in enumerate(PYRAMID_STAGES):
        x, conv, norm = pyramid_stage_inputs(TRAIN_BATCH, cin, cout, f, t, s,
                                             SEED + i)
        w, b = conv.weight, conv.bias
        row = {"shapes": [list(x.shape), list(w.shape)]}
        with torch.no_grad():
            for key, fn, plain, ref in (
                    ("conv", lambda v: pyr.pyramid_conv_cuda(v, w, b),
                     lambda v: pyr.pyramid_conv_plain(v, w, b),
                     lambda v: torch.nn.functional.conv2d(
                         v.double(), w.double(), b.double(),
                         padding=(s, 1))),
                    ("eval", lambda v: pyr.pyramid_stage_eval_cuda(
                        v, conv, norm, s),
                     lambda v: pyr.pyramid_stage_eval_plain(v, conv, norm, s),
                     lambda v: pyramid_stage64(v, conv, norm, s))):
                r64 = ref(x)
                got = fn(x)
                err = (got.double() - r64).abs().max().item()
                lib_err = (plain(x).double() - r64).abs().max().item()
                del r64
                same = torch.equal(got, fn(x))
                check(err <= 1.5 * lib_err and same,
                      f"pyramid stage {i + 1} {key}: error {err:.3e} within "
                      f"1.5x cuDNN's {lib_err:.3e}, deterministic {same}")
                rows_c = f if key == "conv" else (f // s) * s
                flops = 2.0 * TRAIN_BATCH * cout * rows_c * t * cin * 3 * \
                    (2 * s + 1)
                out_bytes = 4.0 * got.numel()
                row[key] = dict(
                    err=err, cudnn_err=lib_err,
                    ms=cuda_ms(lambda: fn(x), 10),
                    plain_ms=cuda_ms(lambda: plain(x), 5, strict=False),
                    bound=bound(4.0 * x.numel() + out_bytes, flops),
                    gflop=flops / 1e9)
                row[key]["tflops"] = flops / row[key]["ms"] / 1e9
            lib = lambda: torch.nn.functional.conv2d(  # noqa: E731
                x, w, b, padding=(s, 1))
            row["library_ms"] = cuda_ms(lib, 10)
            prev = torch.backends.cudnn.benchmark
            torch.backends.cudnn.benchmark = True
            try:
                row["library_benchmark_ms"] = cuda_ms(lib, 10, warmup=3)
            finally:
                torch.backends.cudnn.benchmark = prev
        row["plan"] = list(pyr.plan_conv(TRAIN_BATCH, cin, cout, f, t, s))
        row["plan_eval"] = list(pyr.plan_conv(TRAIN_BATCH, cin, cout,
                                              (f // s) * s, t, s))
        c, e = row["conv"], row["eval"]
        print(f"[train] pyramid stage {i + 1} x {tuple(x.shape)} -> {cout}: "
              f"pyramid_conv {c['ms'] * 1e3:.1f} us ({c['tflops']:.1f} "
              f"TFLOP/s, {c['tflops'] / PEAK_FP32_FLOPS * 1e14:.1f}% of "
              f"the fp32 peak; bound {c['bound'][0] * 1e3:.1f} us, "
              f"{c['bound'][1]}), eval entry {e['ms'] * 1e3:.1f} us (bound "
              f"{e['bound'][0] * 1e3:.1f} us); plain {c['plain_ms'] * 1e3:.1f}"
              f" | eval chain {e['plain_ms'] * 1e3:.1f} us; F.conv2d "
              f"heuristics {row['library_ms'] * 1e3:.1f} us, benchmark mode "
              f"{row['library_benchmark_ms'] * 1e3:.1f} us; max abs err "
              f"{c['err']:.3e} | {e['err']:.3e} (cuDNN {c['cudnn_err']:.3e} | "
              f"{e['cudnn_err']:.3e}); tiles {row['plan']} | "
              f"{row['plan_eval']}")
        rows.append(row)
        del x, conv, norm
    torch.cuda.empty_cache()
    return rows


def pyramid_launches() -> list:
    return [k.launches for k in PYRAMID]


def pyramid_since(before: list) -> list:
    """P1's launches (bias-only entry, eval entry) since ``before``."""
    return [n - n0 for n, n0 in zip(pyramid_launches(), before)]


def check_pyramid(label: str, got: list, stages: int, calls: int) -> None:
    """An eval pass under no gradient: P1's eval entry once a stage a
    call of the pyramid, its bias-only entry never."""
    print(f"{label}: P1 (pyramid_conv, pyramid_conv_eval) {got} for "
          f"{calls} pyramid calls of {stages} stages")
    check(got == [0, stages * calls], f"{label}: P1's eval entry once a "
          f"pyramid stage a call, its bias-only entry never: {got}")


def grads_of(fn, inputs, g):
    outs = fn(*inputs)
    return torch.autograd.grad(outs, inputs, g)


def phase_backward(shapes: dict) -> None:
    """Each autograd Function's backward through the kernels against the
    same Function on the plain versions, on the card, at the training
    shapes and on the same cotangent."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    ph, tables, hop = lookup_inputs(gen, shapes)
    ph.requires_grad_()
    tables.requires_grad_()
    g = torch.randn(ph.shape, generator=gen, device="cuda")
    got = grads_of(lambda p_, t: lk.lookup_blocks(p_, t, hop, lk.CUDA_OPS),
                   (ph, tables), g)
    ref = grads_of(lambda p_, t: lk.lookup_blocks(p_, t, hop, lk.PLAIN_OPS),
                   (ph, tables), g)
    errs = [rel_err(u, v) for u, v in zip(got, ref)]
    print(f"backward lookup (B3a, then B3b) d_ph {errs[0]:.3e}, d_tables "
          f"{tuple(got[1].shape)} {errs[1]:.3e} of max|ref| (tolerance "
          f"1e-5: the atomics' order)")
    check(max(errs) <= 1e-5, "lookup backward vs plain")

    x_shape, a_shape = shapes["allpole_const"]
    x = torch.randn(x_shape, generator=gen, device="cuda").requires_grad_()
    a = lpc_coeffs(gen, a_shape, "cuda").requires_grad_()
    g = torch.randn(x_shape, generator=gen, device="cuda")
    got = grads_of(lambda x_, a_: allpole_const(x_, a_, tap.CONST_CUDA_OPS),
                   (x, a), g)
    ref = grads_of(lambda x_, a_: allpole_const(x_, a_, tap.CONST_PLAIN_OPS),
                   (x, a), g)
    errs = [rel_err(u, v) for u, v in zip(got, ref)]
    print(f"backward allpole_const (B2's adjoint entry) dx {errs[0]:.3e}, "
          f"da {errs[1]:.3e} of max|ref| (tolerance 1e-4: sequential "
          f"float64 vs blocked two-pass, da sums 960 products a row)")
    check(max(errs) <= 1e-4, "allpole_const backward vs plain")

    x, a = allpole_tv_inputs(gen, shapes)
    x.requires_grad_()
    a.requires_grad_()
    g = torch.randn(x.shape, generator=gen, device="cuda")
    got = grads_of(lambda x_, a_: allpole(x_, a_, tap.CUDA_OPS), (x, a), g)
    ref = grads_of(lambda x_, a_: allpole(x_, a_, tap.PLAIN_OPS), (x, a), g)
    errs = [rel_err(u, v) for u, v in zip(got, ref)]
    print(f"backward allpole_tv (B4's adjoint entry) dx {errs[0]:.3e}, da "
          f"{errs[1]:.3e} of max|ref| (tolerance 1e-4: chunked float64 vs "
          f"blocked two-pass)")
    check(max(errs) <= 1e-4, "allpole_tv backward vs plain")


def phase_resonance() -> None:
    """B = 4, T = 4800, p = 22 on resonant filters (``resonant_inputs``:
    capped at 0.95, then uncapped). The first seed whose float64 output is
    finite and whose float32 scan is off by at least 1e-5 of max|y| is
    used; B4's error against the float64 scan must be no larger than the
    float32 scan's."""
    for cap in (0.95, None):
        for seed in range(20):
            x, a = (t.cuda() for t in resonant_inputs(seed, cap=cap))
            ref = allpole_scan(x.double(), a.double())
            if not torch.isfinite(ref).all():
                continue
            err32 = rel_err(allpole_scan(x, a).double(), ref)
            if err32 >= 1e-5:
                break
        else:
            raise RuntimeError(f"no resonant seed found at cap {cap}")
        err = rel_err(allpole_cuda(x, a).double(), ref)
        print(f"resonance (cap {cap}, seed {seed}, max|a| "
              f"{a.abs().max().item():.1f}): error against the float64 "
              f"scan, of max|y|: B4 {err:.3e}, float32 scan {err32:.3e}")
        check(err <= err32, f"B4 within the float32 scan's error, cap {cap}")

    # B2 and its adjoint entry on resonant constant filters, N = 256 rows
    # of T = 960 at p = 22 (resonant_const_inputs, seed 0)
    for cap in (0.95, None):
        x, a = (t.cuda() for t in resonant_const_inputs(0, cap=cap))
        n, t = x.shape
        a_tv = a[:, None, :].expand(n, t, a.shape[1])
        g = torch.from_numpy(np.random.default_rng(1).standard_normal(
            (n, t)).astype(np.float32)).cuda()
        ref = allpole_scan(x.double(), a_tv.double())
        dx_ref = torch.flip(allpole_scan(torch.flip(g, (1,)).double(),
                                         a_tv.double()), (1,))
        check(torch.isfinite(ref).all().item()
              and torch.isfinite(dx_ref).all().item(),
              f"float64 scans finite, cap {cap}")
        y = allpole_const_cuda(x, a)
        dx, da = allpole_const_adjoint_cuda(g, y, a)
        # the mirror pairs the same y with its float64 dx, as the kernel
        _, da_ref = allpole_const_adjoint_scan64(g.double(), y, a.double())
        err_y, err_dx = rel_err(y.double(), ref), rel_err(dx.double(), dx_ref)
        err_da = rel_err(da.double(), da_ref)
        err32 = rel_err(allpole_scan(x, a_tv).double(), ref)
        err32_dx = rel_err(torch.flip(allpole_scan(torch.flip(g, (1,)), a_tv),
                                      (1,)).double(), dx_ref)
        print(f"resonance B2 (cap {cap}, N={n}, T={t}, max|a| "
              f"{a.abs().max().item():.1f}): against the float64 scan, of "
              f"max-abs: y {err_y:.3e}, adjoint dx {err_dx:.3e} (tolerance "
              f"1e-6); float32 scan y {err32:.3e}, dx {err32_dx:.3e}; da "
              f"{err_da:.3e} of max|da| against the float64 mirror "
              f"(tolerance 1e-5)")
        check(err_y <= 1e-6 and err_dx <= 1e-6 and err_da <= 1e-5,
              f"B2 and its adjoint on resonant filters, cap {cap}")


def phase_stream_kernels() -> dict:
    """B4's initial-state entry at a push's shape, B = 4 and B = 1, and B1
    at a push's window shape, against their plain versions, with their
    times and byte bounds."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    rows = {}
    for b in (BATCH, 1):
        t = STREAM_CHUNK
        x = torch.randn((b, t), generator=gen, device="cuda")
        a = tv_coeffs(gen, b, t)
        zi = torch.randn((b, a.shape[2]), generator=gen, device="cuda")
        y = allpole_cuda(x, a, zi)
        plain = allpole_stream_plain(x, a, zi)
        rel_plain = rel_err(y, plain)
        rel64 = rel_err(y.double(), allpole_scan(x.double(), a.double(),
                                                 zi.double()))
        same = torch.equal(allpole_cuda(x, a),
                           allpole_cuda(x, a, torch.zeros_like(zi)))
        xs = torch.randn((b, STREAM_CHAIN * t), generator=gen, device="cuda")
        as_ = tv_coeffs(gen, b, STREAM_CHAIN * t)
        z, parts = None, []
        for c in range(STREAM_CHAIN):
            sl = slice(c * t, (c + 1) * t)
            y_c, z = allpole_stream(xs[:, sl], as_[:, sl], z)
            parts.append(y_c)
        rel_chain = rel_err(torch.cat(parts, dim=1), allpole_cuda(xs, as_))
        print(f"[stream] allpole_tv (B4) zi entry {tuple(x.shape)} "
              f"p={a.shape[2]}: / max|y| {rel_plain:.3e} against "
              f"allpole_stream_plain (tolerance 1e-4: float64 chunked vs "
              f"golf_tpu's float32 blocked form from zi), {rel64:.3e} "
              f"against a float64 scan from zi (tolerance 1e-5); null zi == "
              f"zero zi bit for bit: {same}; {STREAM_CHAIN} chunks chained "
              f"through zi_next vs one-shot B4 on "
              f"{tuple(xs.shape)}: {rel_chain:.3e} (tolerance 1e-5: the "
              f"float32 hand-off of zi)")
        check(rel_plain <= 1e-4 and rel64 <= 1e-5
              and torch.isfinite(y).all().item(), f"B4 zi entry, B={b}")
        check(same, "B4 null zi bit for bit")
        check(rel_chain <= 1e-5, "B4 chained chunks vs one-shot")
        chunk = tap.chunk_for(b, t)
        rel_mirror = rel_err(y, allpole_chunked_plain(x, a, zi=zi))
        print(f"[stream] allpole_tv zi entry {tuple(x.shape)} at chunk_for's "
              f"{chunk}: {rel_mirror:.3e} of max|y| against "
              f"allpole_chunked_plain at that chunk (tolerance 1e-5, as at "
              f"the training shape)")
        check(rel_mirror <= 1e-5, f"B4 zi entry vs mirror, B={b}")
        turns = [cuda_ms(lambda: earlier_tv(EARLIER_TV, x, a, zi), 200),
                 cuda_ms(lambda: allpole_cuda(x, a, zi), 200),
                 cuda_ms(lambda: allpole_cuda(x, a, zi), 200),
                 cuda_ms(lambda: earlier_tv(EARLIER_TV, x, a, zi), 200)]
        rows[f"allpole_tv/{b}"] = dict(
            err=(y - plain).abs().max().item(), err64=rel64,
            ms=(turns[1] + turns[2]) / 2,
            earlier_ms=(turns[0] + turns[3]) / 2, turns_ms=turns,
            chunk=chunk,
            plain_ms=cuda_ms(lambda: allpole_stream_plain(x, a, zi), 3,
                             strict=False),
            bound=bound(4 * (2 * x.numel() + a.numel() + 2 * zi.numel()),
                        2 * a.numel()),
            shapes=[list(x.shape), list(a.shape), list(zi.shape)])
    ph, tables, hop = lookup_inputs(gen, stream_shapes(BATCH))
    rows["lookup"] = lookup_row(ph, tables, hop, "stream", 200)
    for name, r in rows.items():
        extra = "" if "floor_ms" not in r else (
            f", F.grid_sample {r['library_ms'] * 1e3:.2f} us, launch floor "
            f"{r['floor_ms'] * 1e3:.2f} us, split {r['split']}, before the "
            f"split {r['earlier_ms'] * 1e3:.2f} us")
        if "chunk" in r:
            extra = (f", chunk {r['chunk']}, before the redesign "
                     f"{r['earlier_ms'] * 1e3:.2f} us (in turns, us: "
                     f"{[round(u * 1e3, 2) for u in r['turns_ms']]})")
        print(f"[stream] {name}: {r['ms'] * 1e3:.2f} us a launch, bound "
              f"{r['bound'][0] * 1e3:.3f} us ({r['bound'][1]}), plain "
              f"{r['plain_ms'] * 1e3:.1f} us{extra}")
    return rows


def timed(fn):
    """(fn(), host seconds around it, synchronised on both sides)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def leaves(raw: dict) -> dict:
    """The raw encoder groups as name -> tensor."""
    out = {}
    for k, v in raw.items():
        for i, sig in enumerate(v if isinstance(v, tuple) else (v,)):
            out[f"{k}[{i}]"] = sig.data
    return out


def stream_encoder(se: StreamingEncoder, xs: Sig, f0s: Sig,
                   each=None) -> tuple:
    """Push ``xs`` and ``f0s`` through the streaming encoder ``se`` in
    pushes of STREAM_CHUNK samples, then flush: (the emitted rows as
    leaves, one dict for each push that emitted and one for the flush; each
    push's latency, host clock around synchronize; the flush's seconds).
    ``each(c)`` runs after push ``c``."""
    parts, lat = [], []
    for c in range(xs.data.shape[1] // STREAM_CHUNK):
        sl = slice(c * STREAM_CHUNK, (c + 1) * STREAM_CHUNK)
        r, dt = timed(lambda: se.push(xs.data[:, sl], f0s.data[:, sl]))
        lat.append(dt)
        if r is not None:
            parts.append(leaves(r))
        if each is not None:
            each(c)
    r, flush_s = timed(se.flush)
    parts.append(leaves(r))
    return parts, lat, flush_s


def cat_rows(parts: list) -> dict:
    """The stream's emitted leaves joined along the frames."""
    return {k: torch.cat([p[k] for p in parts], dim=1) for k in parts[0]}


def row_errors(got: dict, ref: dict, label: str) -> np.ndarray:
    """Per frame, the largest of max|got - ref| over each leaf's
    max-abs."""
    worst = None
    for k, want in ref.items():
        check(got[k].shape == want.shape, f"{label} rows {k} "
              f"{tuple(got[k].shape)} == {tuple(want.shape)}")
        d = (got[k].float().cpu() - want.float().cpu()).abs()
        d = d.amax(dim=tuple(i for i in range(d.ndim) if i != 1))
        d = d.double().numpy() / (want.abs().max().item() + 1e-9)
        worst = d if worst is None else np.maximum(worst, d)
    return worst


def phase_stream(shapes: dict) -> dict:
    """B = 4 streams of 6 s through the full-width encoder and GOLF-ss
    decoder, pushes of STREAM_CHUNK samples: the streaming encoder against
    the offline encoder, the streaming decoder against the offline decoder
    on the offline ctrl with the same noise; per-push latency (host clock
    around synchronize) and launches."""
    dev = torch.device("cuda")
    task = seeded_model("golf-precise", dev)
    x, f0 = requests(BATCH, SECONDS)
    xs, f0s = Sig(x.to(dev), 1), Sig(f0.to(dev), 1)
    task.init_running_stats(xs, f0s)
    task.eval()
    enc, dec = task.encoder, task.decoder
    t = x.shape[1]
    n = t // STREAM_CHUNK
    noise = torch.randn((BATCH, t), device=dev,
                        generator=torch.Generator(dev).manual_seed(SEED + 3))
    with torch.inference_mode():
        raw = enc(xs, f0s)
        ctrl = dec.apply_ctrl({k: v for k, v in raw.items()
                               if k.endswith("_params")})
        phase = task.phase_from_f0(f0s).data
        y_off = dec(Sig(phase, 1), **ctrl, noise=noise).data

    se = StreamingEncoder(enc, lookahead=STREAM_LOOKAHEAD, batch=BATCH)
    stream = GOLFStream(dec, chunk=STREAM_CHUNK)
    dec_parts, dec_lat = [], []

    def decoder_push(c):
        sl = slice(c * STREAM_CHUNK, (c + 1) * STREAM_CHUNK)
        out, dt = timed(lambda: stream.push(
            chunk_ctrl(ctrl, c, STREAM_CHUNK), phase[:, sl], noise[:, sl]))
        dec_lat.append(dt)
        if out is not None:
            dec_parts.append(out)

    windows = []
    conv_window = se._conv_window
    se._conv_window = lambda *a: windows.append(1) or conv_window(*a)
    for k in DSP_KERNELS:
        k.launches = 0
    p1 = pyramid_launches()
    with torch.inference_mode():
        enc_parts, enc_lat, enc_flush_s = stream_encoder(se, xs, f0s,
                                                         decoder_push)
        n_flushed = next(iter(enc_parts[-1].values())).shape[1]
        out, dec_flush_s = timed(lambda: stream.flush(
            chunk_ctrl(ctrl, n, STREAM_CHUNK, rest=True)))
        dec_parts.append(out)
    counts = {k.name: k.launches for k in DSP_KERNELS}
    print(f"stream: {n} pushes of {STREAM_CHUNK} samples and a flush, "
          f"B={BATCH}; launches {counts}")
    check_pyramid("stream encoder", pyramid_since(p1),
                  len(enc.backbone.pyramid.convs), len(windows))
    for name in ("lookup", "allpole_tv"):
        check(counts[name] == n, f"stream launched {name} once an emitted "
              f"chunk: {counts[name]} for {n}")
        k = next(k for k in DSP_KERNELS if k.name == name)
        check(k.last_shapes == shapes[name],
              f"{name} shapes {k.last_shapes} == {shapes[name]}")

    y = torch.cat(dec_parts, dim=1)
    check(y.shape[1] >= y_off.shape[1] and torch.isfinite(y).all().item(),
          "stream output finite and long enough")
    dec_err = rel_err(y[:, :y_off.shape[1]], y_off)
    rows = row_errors(cat_rows(enc_parts), leaves(raw), "stream encoder")
    m = rows.shape[0]
    enc_tail, enc_mid = float(rows[m - n_flushed:].max()), float(rows.max())
    print(f"stream: decoder vs offline decoder (same ctrl and noise) "
          f"{dec_err:.3e} of max|y| (tolerance 5e-4, golf_tpu's bound); "
          f"encoder vs offline encoder, look-ahead {STREAM_LOOKAHEAD}: "
          f"flushed rows ({n_flushed}) {enc_tail:.3e} (tolerance 1e-4), "
          f"all rows {enc_mid:.3e} (tolerance 2e-2) of each leaf's max-abs")
    check(dec_err <= 5e-4, "stream decoder vs offline")
    check(enc_tail <= 1e-4 and enc_mid <= 2e-2, "stream encoder vs offline")

    def pct(lat):
        warm = np.asarray(lat[STREAM_WARM_PUSHES:]) * 1e3
        return float(np.median(warm)), float(np.percentile(warm, 99))

    enc_p50, enc_p99 = pct(enc_lat)
    dec_p50, dec_p99 = pct(dec_lat)
    chunk_ms = STREAM_CHUNK / SR * 1e3
    # the whole window: every push and both flushes, warm-up included
    host_s = sum(enc_lat) + sum(dec_lat) + enc_flush_s + dec_flush_s
    audio_s = y.shape[1] / SR
    result = {
        "pushes": n, "batch": BATCH, "chunk_ms": chunk_ms,
        "enc_push_ms_p50": enc_p50, "enc_push_ms_p99": enc_p99,
        "dec_push_ms_p50": dec_p50, "dec_push_ms_p99": dec_p99,
        "enc_push_ms_max": max(enc_lat) * 1e3,
        "dec_push_ms_max": max(dec_lat) * 1e3,
        "enc_flush_ms": enc_flush_s * 1e3, "dec_flush_ms": dec_flush_s * 1e3,
        "enc_host_s": sum(enc_lat) + enc_flush_s,
        "dec_host_s": sum(dec_lat) + dec_flush_s,
        "audio_s": audio_s, "real_time_factor": audio_s / host_s,
        "algorithmic_latency_ms": {
            "encoder": (STREAM_LOOKAHEAD + se.edge) * 240 / SR * 1e3,
            "decoder": 2 * chunk_ms},
        "launches_per_push": {k: v / n for k, v in counts.items() if v},
        "dec_err": dec_err, "enc_flush_err": enc_tail, "enc_err": enc_mid}
    print(f"stream: per push (host clock around synchronize, pushes "
          f"{STREAM_WARM_PUSHES + 1} to {n}) "
          f"encoder p50 {enc_p50:.2f} ms p99 {enc_p99:.2f} ms, decoder p50 "
          f"{dec_p50:.2f} ms p99 {dec_p99:.2f} ms; slowest of all pushes "
          f"{result['enc_push_ms_max']:.2f} and "
          f"{result['dec_push_ms_max']:.2f} ms; real-time factor "
          f"{result['real_time_factor']:.2f} ({audio_s:g} s of audio a "
          f"stream, {BATCH} streams, over {host_s * 1e3:.1f} ms of host time "
          f"for all {n} pushes and the flush, encoder "
          f"{result['enc_host_s'] * 1e3:.1f} and decoder "
          f"{result['dec_host_s'] * 1e3:.1f})")
    print(json.dumps({"stream": result}))
    return counts


def phase_test(decoder: str) -> dict:
    """``test_step`` (MSS loss and MCD) of the full-width model on
    B = 4 x 2 s on the card, held against the port's CPU run with the same
    weights and noise."""
    dev = torch.device("cuda")
    task = seeded_model(decoder, dev)
    x, f0 = requests(TEST_BATCH, TEST_SECONDS)
    task.init_running_stats(Sig(x.to(dev), 1), Sig(f0.to(dev), 1))
    task.eval()
    noise = torch.randn(x.shape, generator=torch.Generator().manual_seed(9))
    args = (Sig(x.to(dev), 1), Sig(f0.to(dev), 1))
    with torch.inference_mode():
        # one warm-up call: the solver's and the FFT plans' set-up
        _, warm_secs = timed(lambda: task.test_step(*args,
                                                    noise=noise.to(dev)))
        for k in DSP_KERNELS:
            k.launches = 0
        out, secs = timed(lambda: task.test_step(*args, noise=noise.to(dev)))
    counts = {k.name: k.launches for k in DSP_KERNELS}
    cpu_task = seeded_model(decoder, "cpu")
    cpu_task.load_state_dict({k: v.cpu() for k, v in
                              task.state_dict().items()})
    cpu_task.eval()
    with torch.inference_mode():
        ref = cpu_task.test_step(Sig(x, 1), Sig(f0, 1), noise=noise)
    errs = {k: abs(float(out[k]) - float(ref[k])) / abs(float(ref[k]))
            for k in ("loss", "mcd")}
    print(f"test {decoder}: B={TEST_BATCH} x {TEST_SECONDS:g} s, MSS loss "
          f"{float(out['loss']):.5f} (CPU {float(ref['loss']):.5f}, rel "
          f"{errs['loss']:.2e}), MCD {float(out['mcd']):.4f} dB (CPU "
          f"{float(ref['mcd']):.4f}, rel {errs['mcd']:.2e}); tolerance "
          f"{TEST_REL_TOL:g} relative for both; {secs * 1e3:.1f} ms after a "
          f"warm-up call of {warm_secs * 1e3:.1f} ms; launches {counts}")
    check(all(np.isfinite(float(out[k])) for k in ("loss", "mcd")),
          f"{decoder} test metrics finite")
    check(max(errs.values()) <= TEST_REL_TOL,
          f"{decoder} test_step card vs CPU")
    end = {"golf": "allpole_const", "golf-precise": "allpole_tv"}[decoder]
    for name in ("lookup", end):
        check(counts[name] == 1, f"{decoder} test_step launched {name} once")
    return counts


def seeded_model(decoder: str, device, cfg: dict = None) -> VoiceAutoEncoder:
    """Full-width model (``model_config(decoder)``, or ``cfg``) with seeded
    weights; the zero-initialised head and acoustic filter (the room
    filter, or NHV's end filter) get small random values so the LPC and the
    acoustic filter are not the identity. An allpass room filter keeps its
    seeded initialisation."""
    torch.manual_seed(SEED)
    task = build_voice_autoencoder(cfg or model_config(decoder), device="cpu")
    gen = torch.Generator().manual_seed(SEED + 1)
    with torch.no_grad():
        head = task.encoder.backbone.out_linear
        head.weight.copy_(0.004 * torch.randn(head.weight.shape,
                                              generator=gen))
        head.bias.copy_(0.05 * torch.randn(head.bias.shape, generator=gen))
        acoustic = getattr(task.decoder, "room_filter", None) or \
            task.decoder.end_filter
        if hasattr(acoustic, "kernel"):
            acoustic.kernel.copy_(0.01 * torch.randn(acoustic.kernel.shape,
                                                     generator=gen))
    return task.to(device)


def requests(n: int, seconds: float):
    ds = SyntheticVoiceDataset(n, seconds, SR, seed=SEED)
    items = [ds[i] for i in range(n)]
    return (torch.from_numpy(np.stack([x for x, _ in items])),
            torch.from_numpy(np.stack([f for _, f in items])))


def phase_serve(decoder: str, expect: dict) -> tuple:
    dev = torch.device("cuda")
    task = seeded_model(decoder, dev)
    x, f0 = requests(BATCH, SECONDS)
    xs, f0s = Sig(x.to(dev), 1), Sig(f0.to(dev), 1)
    task.init_running_stats(xs, f0s)
    task.eval()
    gen = torch.Generator(device=dev).manual_seed(SEED)

    # the baselines' decoders run no kernel
    path = {"golf": ("lookup", "allpole_const"),
            "golf-precise": ("lookup", "allpole_tv")}.get(decoder, ())
    for k in DSP_KERNELS:
        k.launches = 0
    p1 = pyramid_launches()
    latencies = []
    with torch.inference_mode():
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            y, _ = task.predict_step(xs, f0s, generator=gen)
            torch.cuda.synchronize()
            latencies.append(time.perf_counter() - t0)
    counts = {k.name: k.launches for k in DSP_KERNELS}
    p1 = [n - n0 for n, n0 in zip(pyramid_launches(), p1)]
    stages = len(task.encoder.backbone.pyramid.convs)
    print(f"serve {decoder}: out {tuple(y.shape)}, launches {counts}; P1 "
          f"(pyramid_conv, pyramid_conv_eval) {p1}")
    check(p1 == [0, 3 * stages], f"{decoder} serve: P1's eval entry once a "
          f"pyramid stage a predict, its bias-only entry never: {p1}")
    check(torch.isfinite(y.data).all().item(), f"{decoder} output finite")
    check(y.shape[0] == BATCH and y.shape[1] > 0.99 * SECONDS * SR,
          f"{decoder} output shape {y.shape}")
    for name in path:
        check(counts[name] > 0, f"{decoder} launched {name}")
        k = next(k for k in DSP_KERNELS if k.name == name)
        check(k.last_shapes == expect[name],
              f"{name} shapes {k.last_shapes} == {expect[name]}")
    for name, n in counts.items():
        check(name in path or n == 0, f"{decoder} serve launched {name}")
    print(f"serve {decoder}: latency per request (B={BATCH} x {SECONDS:.0f} "
          f"s, batched) first {latencies[0] * 1e3:.1f} ms, then "
          f"{', '.join(f'{s * 1e3:.1f}' for s in latencies[1:])} ms")

    # one 2 s request against the port's own CPU run, same weights + noise
    n = int(CHECK_SECONDS * SR)
    xc, f0c = x[:1, :n], f0[:1, :n]
    noise = torch.randn((1, n), generator=torch.Generator().manual_seed(7))
    cpu_task = seeded_model(decoder, "cpu")
    cpu_task.load_state_dict({k: v.cpu() for k, v in
                              task.state_dict().items()})
    cpu_task.eval()
    with torch.inference_mode():
        y_gpu, _ = task.predict_step(Sig(xc.to(dev), 1), Sig(f0c.to(dev), 1),
                                     noise=noise.to(dev))
        y_cpu, _ = cpu_task.predict_step(Sig(xc, 1), Sig(f0c, 1),
                                         noise=noise)
    rel = ((y_gpu.data.cpu() - y_cpu.data).abs().max()
           / y_cpu.data.abs().max()).item()
    print(f"serve {decoder}: 2 s request, card vs CPU: max err / max|y| "
          f"{rel:.3e} (tolerance 1e-3: cuDNN LSTM and cuFFT sum in another "
          f"order than the CPU, and the all-pole kernels, where the decoder "
          f"runs them, the sequential (B2) and chunked float64 (B4) forms "
          f"where the CPU runs the blocked float32 forms)")
    check(rel <= 1e-3, f"{decoder} card vs CPU")
    return counts, {"ms": [t * 1e3 for t in latencies], "vs_cpu": rel}


def train_model_config(decoder: str, dropout: float = None,
                       **model_args) -> dict:
    cfg = model_config(decoder)
    if dropout is not None:
        cfg["encoder_init_args"]["dropout"] = dropout
    cfg.update(model_args)
    return cfg


def train_steps(tasks: dict, steps: int, label: str) -> dict:
    """``steps`` Adam steps of each task on B = 64 x 2 s through the port's
    Trainer, the tasks in turns (one step of each, then the next round):
    every loss finite. Per task: its launches, losses, step wall times
    (host clock around synchronize, TF32 off), the last grad norm and the
    peak memory (the largest over its own steps)."""
    dev = torch.device("cuda")
    x, f0 = requests(TRAIN_BATCH, TRAIN_SECONDS)
    xs, f0s = Sig(x.to(dev), 1), Sig(f0.to(dev), 1)
    trainers = {}
    for name, task in tasks.items():
        trainers[name] = Trainer(
            task, run_dir="chiprun_out/chip_smoke_" + label.replace(" ", "_"),
            max_steps=steps, seed=SEED)
        task.init_running_stats(xs, f0s)
    out = {name: {"counts": {k.name: 0 for k in DSP_KERNELS},
                  "pyramid": [0] * len(PYRAMID),
                  "step_ms": [], "losses": [], "peak_gib": 0.0}
           for name in tasks}
    for _ in range(steps):
        for name, trainer in trainers.items():
            for k in DSP_KERNELS:
                k.launches = 0
            torch.cuda.reset_peak_memory_stats()
            p1 = pyramid_launches()
            metrics, secs = timed(lambda: trainer.train_step(xs, f0s))
            trainer.step += 1
            rec = out[name]
            for k in DSP_KERNELS:
                rec["counts"][k.name] += k.launches
            rec["pyramid"] = [a + n - n0 for a, n, n0 in zip(
                rec["pyramid"], pyramid_launches(), p1)]
            rec["step_ms"].append(secs * 1e3)
            rec["losses"].append(metrics["loss"].item())
            rec["grad_norm"] = metrics["grad_norm"].item()
            rec["peak_gib"] = max(rec["peak_gib"],
                                  torch.cuda.max_memory_allocated() / 2 ** 30)
    for name, rec in out.items():
        print(f"{label} {name}: B={TRAIN_BATCH} x {TRAIN_SECONDS:.0f} s, "
              f"losses {', '.join(f'{v:.5f}' for v in rec['losses'])}; step "
              f"wall time (host clock around synchronize, TF32 off) "
              f"{', '.join(f'{t:.1f}' for t in rec['step_ms'])} ms; grad "
              f"norm {rec['grad_norm']:.4g}; peak memory "
              f"{rec['peak_gib']:.2f} GiB; launches {rec['counts']}")
        check(all(np.isfinite(rec["losses"])),
              f"{label} {name} losses finite")
    return out


def phase_train(decoder: str, expect: dict) -> tuple:
    """3 Adam steps of the full-width model on B = 64 x 2 s through the
    port's Trainer; every loss finite; the path's kernels launched at the
    training shapes, no other (none for the baselines). Returns (launches,
    step times and peak memory)."""
    torch.manual_seed(SEED)
    task = seeded_model(decoder, torch.device("cuda"))
    rec = train_steps({decoder: task}, TRAIN_STEPS, "train")[decoder]
    # the phase of the true f0 needs no gradient: B1, not B3a
    path = {"golf": ("lookup", "lookup_dtab", "allpole_const",
                     "allpole_const_adjoint"),
            "golf-precise": ("lookup", "lookup_dtab", "allpole_tv",
                             "allpole_tv_adjoint")}.get(decoder, ())
    counts = rec["counts"]
    check_train_launches(decoder, counts, path, TRAIN_STEPS, expect)
    stages = len(task.encoder.backbone.pyramid.convs)
    check(rec["pyramid"] == [stages * TRAIN_STEPS, 0],
          f"{decoder} train: P1's bias-only entry once a pyramid stage a "
          f"step, its eval entry never: {rec['pyramid']}")
    for name, n in counts.items():
        check(name in path or n == 0, f"{decoder} train launched {name}")
    return counts, {"step_ms": rec["step_ms"], "peak_gib": rec["peak_gib"]}


def check_train_launches(label: str, counts: dict, path, steps: int,
                         expect: dict = None) -> None:
    """Each kernel of ``path`` launched once a step (at the shapes of
    ``expect``, where given); the lookup's other forward (B3a for B1, B1
    for B3a) never."""
    for name in path:
        check(counts[name] == steps,
              f"{label} train launched {name} {counts[name]} times")
        if expect is not None:
            k = next(k for k in DSP_KERNELS if k.name == name)
            check(k.last_shapes == expect[name],
                  f"{name} shapes {k.last_shapes} == {expect[name]}")
    other = "lookup_res" if "lookup" in path else "lookup"
    check(counts[other] == 0,
          f"{label} train launched {other} {counts[other]} times")


def phase_train_f0() -> dict:
    """GOLF-ff with the phase from the encoder's own f0 (``learn_f0``, no
    f0 conditioning, ``train_with_true_f0`` false, ``detach_f0`` false):
    the phase needs a gradient, so the lookup's forward is B3a. 2 Adam
    steps at B = 64 x 2 s; losses finite; B3a and B3b once a step (the
    phase follows the spectrogram's frames, one more than the f0 track's,
    so the lookup has 21 blocks here)."""
    dev = torch.device("cuda")
    torch.manual_seed(SEED)
    cfg = train_model_config("golf", train_with_true_f0=False,
                             detach_f0=False)
    cfg["encoder_init_args"].update(learn_f0=True, f0_conditioning=False)
    task = build_voice_autoencoder(cfg, device="cpu").to(dev)
    x, f0 = requests(TRAIN_BATCH, TRAIN_SECONDS)
    xs, f0s = Sig(x.to(dev), 1), Sig(f0.to(dev), 1)
    trainer = Trainer(task, run_dir="chiprun_out/chip_smoke_train_f0",
                      max_steps=2, seed=SEED)
    task.init_running_stats(xs, f0s)
    for k in DSP_KERNELS:
        k.launches = 0
    losses = []
    for _ in range(2):
        metrics = trainer.train_step(xs, f0s)
        losses.append(metrics["loss"].item())
        trainer.step += 1
    counts = {k.name: k.launches for k in DSP_KERNELS}
    print(f"train_f0 golf (phase from the encoder's f0): B={TRAIN_BATCH} x "
          f"{TRAIN_SECONDS:.0f} s, losses "
          f"{', '.join(f'{v:.5f}' for v in losses)}, f0 loss "
          f"{metrics['f0_loss'].item():.5f}; launches {counts}; lookup "
          f"shapes {kernels.LOOKUP_RES.last_shapes}")
    check(all(np.isfinite(losses)), "train_f0 losses finite")
    check_train_launches("golf f0", counts,
                         ("lookup_res", "lookup_dtab", "allpole_const",
                          "allpole_const_adjoint"), 2)
    return counts


def phase_train_vs_cpu(decoder: str, state: dict = None,
                       optimizer: dict = None, cfg: dict = None,
                       noise_fn=None, **model_args) -> dict:
    """One training step at B = 2 x 1 s, full width, on the card and on the
    CPU: same weights (``seeded_model``'s, or ``state``), noise and random
    f0, dropout 0, train mode (cuDNN has no RNN backward in eval mode, and
    dropout draws differ by device). With ``optimizer`` (the
    ``ClippedOptimizer`` arguments) the step is also applied on both and
    the weights after it compared. ``cfg`` replaces the model
    configuration (its dropout set to 0), ``noise_fn`` (the batch's shape
    -> the noise generator's field) the standard normal field."""
    dev = torch.device("cuda")
    torch.manual_seed(SEED)
    if cfg is None:
        cfg = train_model_config(decoder, 0.0, **model_args)
    else:
        cfg = copy.deepcopy(cfg)
        cfg["encoder_init_args"]["dropout"] = 0.0
    cpu_task = build_voice_autoencoder(cfg, device="cpu")
    if state is None:
        state = seeded_model(decoder, "cpu", cfg).state_dict()
    cpu_task.load_state_dict(state)
    x, f0 = requests(TRAIN_CHECK_BATCH, TRAIN_CHECK_SECONDS)
    # white noise at -20 dB of full scale: without it most spectrogram bins
    # are near silent, and the encoder's log amplifies the two FFT
    # libraries' fp32 rounding there (the conv layers' gradients then
    # differ by ~1e-2 between the card and the CPU)
    x = x + 0.1 * torch.randn(x.shape,
                              generator=torch.Generator().manual_seed(8))
    noise = (noise_fn or torch.randn)(
        x.shape, generator=torch.Generator().manual_seed(7))
    random_f0 = torch.tensor([[90.0], [310.0]])
    cpu_task.init_running_stats(Sig(x, 1), Sig(f0, 1))
    gpu_task = build_voice_autoencoder(cfg, device="cpu")
    gpu_task.load_state_dict(cpu_task.state_dict())
    gpu_task.to(dev)
    grads = []
    losses = []
    for task, d in ((gpu_task, dev), (cpu_task, torch.device("cpu"))):
        task.train()
        loss, _ = task.training_step(Sig(x.to(d), 1), Sig(f0.to(d), 1),
                                     noise=noise.to(d),
                                     random_f0=random_f0.to(d))
        loss.backward()
        losses.append(loss.item())
        grads.append({n: p.grad.detach().cpu()
                      for n, p in task.named_parameters()
                      if p.grad is not None})
        if optimizer is not None:
            ClippedOptimizer(trainable_parameters(task), **optimizer).step()
    rel_loss = abs(losses[0] - losses[1]) / abs(losses[1])
    errs = {}
    for name, ref in grads[1].items():
        got = grads[0][name]
        # zero in exact arithmetic, rounding noise on both sides: a conv's
        # bias in front of a train-mode batch norm, and the attention's key
        # bias (the softmax over keys is blind to it); held against the
        # scale of the weight's gradient instead
        blind = name.endswith(".key.bias") or (
            name.endswith(".bias") and (
                name.startswith("encoder.backbone.pyramid.convs.") or (
                    name == "encoder.backbone.convs.0.bias"
                    and "encoder.backbone.norms.0.weight" in grads[1])))
        if blind:
            w = grads[1][name[:-len("bias")] + "weight"].abs().max()
            err = ((got - ref).abs().max() / w).item()
        else:
            err = ((got - ref).abs().max() / ref.abs().max()).item()
        if name.startswith(("encoder.backbone.pyramid.",
                            "encoder.backbone.convs.0.",
                            "encoder.backbone.embed.")):
            # the conv pyramid (or the first conv, and UNetEncoderV2's
            # embedding in front of its pyramid) reads the log spectrogram,
            # whose small bins carry the FFT libraries' rounding (on the
            # CPU, against golf_tpu, a float64 spectrogram takes these
            # errors from 1e-2 to below 1e-4): held to PYRAMID_GRAD_TOL,
            # scaled here
            err *= TRAIN_GRAD_TOL / PYRAMID_GRAD_TOL
        errs[name] = err
    ranked = sorted(errs, key=errs.get, reverse=True)
    worst, worst_name = errs[ranked[0]], ranked[0]
    print(f"train {decoder}: card vs CPU, largest gradient errors (the "
          f"pyramid's scaled by {TRAIN_GRAD_TOL / PYRAMID_GRAD_TOL:g}): " +
          ", ".join(f"{n} {errs[n]:.2e}" for n in ranked[:4]))
    print(f"train {decoder}: B={TRAIN_CHECK_BATCH} x "
          f"{TRAIN_CHECK_SECONDS:.0f} s, card vs CPU: loss {losses[0]:.6f} "
          f"vs {losses[1]:.6f} (rel {rel_loss:.2e}, tolerance 1e-4), worst "
          f"gradient {worst_name} {worst:.2e} of its max|ref| (tolerance "
          f"{TRAIN_GRAD_TOL:g}, the conv pyramid {PYRAMID_GRAD_TOL:g}: "
          f"cuDNN, cuFFT and the all-pole kernels where the decoder runs "
          f"them (sequential B2, chunked float64 B4) sum in other orders "
          f"than the CPU's oneDNN, pocketfft and blocked forms)")
    check(rel_loss <= 1e-4, f"{decoder} train loss card vs CPU")
    check(worst <= TRAIN_GRAD_TOL, f"{decoder} train gradients card vs CPU")
    summary = {"loss_rel": rel_loss, "worst_grad": worst,
               "worst_grad_name": worst_name}
    if optimizer is not None:
        after = {n: p.detach().cpu() for n, p in gpu_task.named_parameters()}
        ref = dict(cpu_task.named_parameters())
        scale = max(p.abs().max().item() for p in ref.values())
        err = max((after[n] - p.detach()).abs().max().item()
                  for n, p in ref.items())
        print(f"train {decoder}: {optimizer} step card vs CPU: weights "
              f"after it within {err / scale:.2e} of max|w| (tolerance "
              f"{STEP_WEIGHT_TOL:g})")
        check(err <= STEP_WEIGHT_TOL * scale,
              f"{decoder} {optimizer['optimizer']} step card vs CPU")
    return summary


def phase_baselines() -> tuple:
    """The Interspeech24 baselines (NHV, MLSA, MLSA-Taylor, WORLD) on the
    full-width vctk encoder: for each, 4 x 6 s served (``phase_serve``: a
    first call, then two timed) with a 2 s request card vs CPU, 3 Adam steps
    at B = 64 x 2 s (``phase_train``: step times, peak memory) and one
    B = 2 x 1 s training step card vs CPU (``phase_train_vs_cpu``). These
    decoders are FFT and elementwise work: no kernel may launch. Returns
    (launches, the summary for the ``baselines`` line)."""
    counts = {k.name: 0 for k in DSP_KERNELS}
    summary = {}
    for decoder in BASELINES:
        serve_counts, serve = phase_serve(decoder, {})
        train_counts, train = phase_train(decoder, {})
        for c in (serve_counts, train_counts):
            for name, n in c.items():
                counts[name] += n
        summary[decoder] = {"serve": serve, "train": train,
                            "train_vs_cpu": phase_train_vs_cpu(decoder)}
    check(not any(counts.values()), f"the baselines launched {counts}")
    return counts, summary


def phase_baselines_cli(tree: Path, out: Path) -> tuple:
    """``autoencode_torch.py fit`` (2 steps at B = 64 x 2 s) and ``test`` of
    that checkpoint (the 64-segment test split) from the VCTK tree, for nhv
    and world; finite losses and metrics, no kernel launched. Returns
    (launches, the step times and test metrics)."""
    counts = {k.name: 0 for k in DSP_KERNELS}
    summary = {}
    for decoder in ("nhv", "world"):
        yaml_path = str(_CFG_DIR / f"{decoder}.yaml")
        run_dir = out / decoder
        with StepProbe() as probe:
            fit_counts = cli_run(["fit", *disk_args(tree, yaml_path, run_dir),
                                  "trainer.max_steps=2"])
        print(f"baselines CLI fit {decoder}: losses {probe.losses}, step "
              f"wall time {[f'{t * 1e3:.1f}' for t in probe.times]} ms")
        check(len(probe.times) == 2 and all(np.isfinite(probe.losses)),
              f"{decoder} CLI fit: 2 finite steps")
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            test_counts = cli_run(["test", *disk_args(tree, yaml_path,
                                                      out / f"{decoder}-t"),
                                   "--ckpt_path",
                                   str(run_dir / "ckpt" / "last")])
        print(text.getvalue(), end="")
        result = json.loads(text.getvalue().strip().splitlines()[-1])
        check(all(np.isfinite(v) for v in result.values()),
              f"{decoder} CLI test metrics finite")
        for c in (fit_counts, test_counts):
            for name, n in c.items():
                counts[name] += n
        summary[decoder] = {"fit_step_ms": [t * 1e3 for t in probe.times],
                            "test": result}
    check(not any(counts.values()), f"the baselines' CLI launched {counts}")
    return counts, summary


# ---------------------------------------------------------------------------
# the Interspeech24 recipe from disk: fit, GOLF-fs, the SGD finetune
# ---------------------------------------------------------------------------

def write_voice(path: Path, seconds: float, seed: int) -> None:
    """One corpus file: a ``SyntheticVoiceDataset`` item (its own seed) as a
    24 kHz PCM16 wav, and its 5 ms ``.pv`` f0 track beside it."""
    x, f0 = SyntheticVoiceDataset(1, seconds, SR, seed=seed)[0]
    path.parent.mkdir(parents=True, exist_ok=True)
    wavfile.write(str(path), SR,
                  np.round(np.clip(x, -1, 1) * 32767).astype(np.int16))
    hop = SR // 200
    frames = np.minimum(np.arange(len(x) // hop + 1) * hop, len(x) - 1)
    np.savetxt(str(path.with_suffix(".pv")), f0[frames], fmt="%.4f")


def write_vctk_tree(root: Path) -> dict:
    """A miniature VCTK tree: 24 kHz PCM16 ``pNNN/pNNN_XXX_mic1.wav`` files
    with their 5 ms ``.pv`` f0 tracks, each a ``SyntheticVoiceDataset``
    item (its own seed). Train: DISK_TRAIN_SPEAKERS speakers x 2 files x
    6 s (9 segments of 2 s at overlap 1.5 each); valid: DISK_VALID, one
    file of 6 s each; test: DISK_TEST, 2 files x 5.5 s each (8 segments
    each, 64 in all). Returns the segment counts."""
    files = ([(f"p{300 + i}", k, DISK_SECONDS)
              for i in range(DISK_TRAIN_SPEAKERS) for k in range(2)]
             + [(spk, 0, DISK_SECONDS) for spk in DISK_VALID]
             + [(spk, k, DISK_TEST_SECONDS) for spk in DISK_TEST
                for k in range(2)])
    for j, (spk, k, seconds) in enumerate(files):
        write_voice(root / spk / f"{spk}_{k + 1:03d}_mic1.wav", seconds,
                    SEED + 100 + j)
    seg = lambda secs: int((secs - 2.0) / 0.5) + 1  # noqa: E731
    return {"train": 2 * DISK_TRAIN_SPEAKERS * seg(DISK_SECONDS),
            "valid": len(DISK_VALID) * seg(DISK_SECONDS),
            "test": 2 * len(DISK_TEST) * seg(DISK_TEST_SECONDS)}


class StepProbe:
    """Around ``Trainer.train_step`` while a CLI run is in progress: the
    first step's batch as it reached the card, each step's loss, host time
    (synchronised on both sides) and kernel launches."""

    def __init__(self):
        self.batch = None
        self.losses, self.times, self.launches = [], [], []

    def __enter__(self):
        self._orig = Trainer.train_step
        probe = self

        def train_step(trainer, x, f0):
            if probe.batch is None:
                probe.batch = (x.data.cpu().numpy(), f0.data.cpu().numpy())
            before = {k.name: k.launches for k in DSP_KERNELS}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = probe._orig(trainer, x, f0)
            torch.cuda.synchronize()
            probe.times.append(time.perf_counter() - t0)
            probe.losses.append(out["loss"].item())
            probe.launches.append({k.name: k.launches - before[k.name]
                                   for k in DSP_KERNELS})
            return out

        Trainer.train_step = train_step
        return self

    def __exit__(self, *exc):
        Trainer.train_step = self._orig

    def check_steps(self, label: str, path, absent=()) -> None:
        print(f"{label}: {len(self.times)} steps, losses "
              f"{', '.join(f'{v:.5f}' for v in self.losses)}; step wall time "
              f"(host clock around synchronize) "
              f"{', '.join(f'{t * 1e3:.1f}' for t in self.times)} ms; "
              f"launches a step {self.launches}")
        check(len(self.times) == DISK_STEPS, f"{label} took {DISK_STEPS} "
              f"steps")
        check(all(np.isfinite(self.losses)), f"{label} losses finite")
        for n, counts in enumerate(self.launches):
            for name in path:
                check(counts[name] == 1, f"{label} step {n + 1} launched "
                      f"{name} once: {counts[name]}")
            for name in absent:
                check(counts[name] == 0, f"{label} step {n + 1} launched "
                      f"{name}: {counts[name]}")


def cli_run(argv, default_config: str = None) -> dict:
    """``autoencode_torch.py``'s ``run`` (``main_torch.py``'s, given its
    ``default_config``) in this process, with the launches of every kernel
    from 0 over the run; returns them."""
    entry = "main_torch.py" if default_config else "autoencode_torch.py"
    print(f"$ {entry} {' '.join(argv)}", flush=True)
    for k in DSP_KERNELS:
        k.launches = 0
    check(cli.run(argv, default_config=default_config) == 0,
          f"{entry} {argv[0]} returned 0")
    return {k.name: k.launches for k in DSP_KERNELS}


def disk_overrides(tree: Path) -> list:
    return [f"data.init_args.wav_dir={tree}"]


def disk_args(tree: Path, decoder_yaml: str, run_dir: Path) -> list:
    return ["--config", "cfg/ae/vctk.yaml", "--model", decoder_yaml,
            *disk_overrides(tree), "--run_dir", str(run_dir)]


def phase_disk(tree: Path, out: Path) -> tuple:
    """``fit --config cfg/ae/vctk.yaml --model cfg/ae/decoder/golf.yaml``
    from the tree, DISK_STEPS steps at B = 64 x 2 s on the card; the first
    step's batch must equal the CPU ``VCTK`` module's bit for bit (the
    same config, the loader's second pass: the trainer's init reads the
    first). Returns (launches, GOLF-ff checkpoint path, probe)."""
    argv = ["fit", *disk_args(tree, "cfg/ae/decoder/golf.yaml", out / "ff"),
            f"trainer.max_steps={DISK_STEPS}"]
    with StepProbe() as probe:
        counts = cli_run(argv)
    probe.check_steps("disk fit GOLF-ff", ("lookup", "lookup_dtab",
                                           "allpole_const",
                                           "allpole_const_adjoint"),
                      absent=("lookup_res",))
    cfg = load_config(["cfg/ae/vctk.yaml"], "cfg/ae/decoder/golf.yaml",
                      disk_overrides(tree))
    dm = instantiate(cfg["data"])
    check(type(dm).__name__ == "VCTK", "vctk.yaml builds VCTK")
    dm.setup("fit")
    loader = dm.train_dataloader()
    next(iter(loader))
    x, f0 = next(iter(loader))
    same = np.array_equal(probe.batch[0], x) and \
        np.array_equal(probe.batch[1], f0)
    print(f"disk fit: first batch {probe.batch[0].shape} on the card == the "
          f"CPU VCTK module's: {same}; launches over the run {counts}")
    check(same and x.shape == (TRAIN_BATCH, int(TRAIN_SECONDS * SR)),
          "disk fit's first batch bit for bit")
    ckpt = out / "ff" / "ckpt" / "last"
    check(ckpt.exists(), "GOLF-ff checkpoint written")
    return counts, ckpt, probe


def golf_fs_yaml(path: Path) -> str:
    """``cfg/ae/decoder/golf.yaml`` through ``convert2samplewise``."""
    import yaml
    with open(path, "w") as f:
        yaml.safe_dump(convert2samplewise(
            load_config(["cfg/ae/decoder/golf.yaml"])), f)
    return str(path)


def phase_fs(tree: Path, ckpt: Path, out: Path) -> tuple:
    """GOLF-fs: the GOLF-ff checkpoint params-only in the model of
    ``convert2samplewise(golf.yaml)``. The CLI's ``test`` on the card (its
    MSS and MCD, time and peak memory); then ``test_step`` over the test
    split (64 segments: one batch of 64) on the card, timed with its peak
    memory, against the CPU on the same weights and noise, within
    TEST_REL_TOL relative."""
    fs_model = golf_fs_yaml(out / "golf-fs.yaml")
    argv = ["test", *disk_args(tree, fs_model, out / "fs"), "--ckpt_path",
            str(ckpt)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    text = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(text):
        counts = cli_run(argv)
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    cli_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(text.getvalue(), end="")
    result = json.loads(text.getvalue().strip().splitlines()[-1])
    print(f"fs CLI test: {result}; {cli_s:.2f} s for the whole command "
          f"(data, model, restore, test); peak memory {cli_peak:.2f} GiB; "
          f"launches {counts}")
    check(all(np.isfinite(v) for v in result.values()),
          "GOLF-fs CLI test metrics finite")
    check(counts["lookup"] >= 1 and counts["allpole_tv"] >= 1,
          "GOLF-fs test launched B1 and B4")

    cfg = load_config(["cfg/ae/vctk.yaml"], fs_model, disk_overrides(tree))
    dm = instantiate(cfg["data"])
    dm.setup("test")
    (x, f0), = list(dm.test_dataloader())
    check(x.shape[0] == TRAIN_BATCH, f"the test split is one batch of "
          f"{TRAIN_BATCH}: {x.shape}")
    tasks = {}
    for dev in ("cuda", "cpu"):
        tasks[dev] = build_voice_autoencoder(cfg["model"]["init_args"],
                                             device=dev)
        ckpt_lib.restore_params_into(str(ckpt), tasks[dev])
        tasks[dev].eval()
    noise = torch.randn(x.shape, generator=torch.Generator().manual_seed(9))
    xs, f0s = torch.from_numpy(x), torch.from_numpy(f0)
    args = (Sig(xs.cuda(), 1), Sig(f0s.cuda(), 1))
    with torch.inference_mode():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated() / 2 ** 30
        for k in DSP_KERNELS:
            k.launches = 0
        p1 = pyramid_launches()
        got, secs = timed(lambda: tasks["cuda"].test_step(
            *args, noise=noise.cuda()))
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        step_counts = {k.name: k.launches for k in DSP_KERNELS}
        check_pyramid("GOLF-fs test_step", pyramid_since(p1), len(
            tasks["cuda"].encoder.backbone.pyramid.convs), 1)
        t0 = time.perf_counter()
        ref = tasks["cpu"].test_step(Sig(xs, 1), Sig(f0s, 1), noise=noise)
        cpu_s = time.perf_counter() - t0
    errs = {k: abs(float(got[k]) - float(ref[k])) / abs(float(ref[k]))
            for k in ("loss", "mcd")}
    print(f"fs test_step: B={x.shape[0]} x {TRAIN_SECONDS:g} s (the test "
          f"split), MSS loss {float(got['loss']):.5f} (CPU "
          f"{float(ref['loss']):.5f}, rel {errs['loss']:.2e}), MCD "
          f"{float(got['mcd']):.4f} dB (CPU {float(ref['mcd']):.4f}, rel "
          f"{errs['mcd']:.2e}); tolerance {TEST_REL_TOL:g} relative; "
          f"{secs * 1e3:.1f} ms on the card (after the CLI's run), CPU "
          f"{cpu_s:.1f} s; peak memory {peak:.2f} GiB (weights and inputs "
          f"{base:.2f}); launches {step_counts}")
    check(all(np.isfinite(float(got[k])) for k in ("loss", "mcd")),
          "GOLF-fs test_step finite")
    check(max(errs.values()) <= TEST_REL_TOL, "GOLF-fs test_step card vs CPU")
    check(step_counts["lookup"] == 1 and step_counts["allpole_tv"] == 1,
          "GOLF-fs test_step launched B1 and B4 once")
    return counts, {"cli_s": cli_s, "cli_peak_gib": cli_peak,
                    "test_step_ms": secs * 1e3, "peak_gib": peak,
                    "mss": float(got["loss"]), "mcd": float(got["mcd"]),
                    "errs": errs}


def phase_finetune(tree: Path, ckpt: Path, out: Path) -> tuple:
    """The GOLF-ss finetune: the GOLF-ff checkpoint params-only in
    ``golf-precise-stable.yaml`` (cap 0.98), DISK_STEPS SGD steps at lr 1e-5
    with ``coef_smooth_weight`` 0.1 at B = 64 x 2 s through the CLI's
    ``fit``; B3a, B3b, B4 and B4's adjoint entry once a step; the weights
    moved from the checkpoint's by at most lr x clip a step. Then one such
    step at B = 2 x 1 s card vs CPU from the same checkpoint."""
    argv = ["fit", *disk_args(tree, "cfg/ae/decoder/golf-precise-stable.yaml",
                              out / "ss"),
            f"trainer.max_steps={DISK_STEPS}",
            "optimizer.class_path=torch.optim.SGD",
            f"optimizer.init_args.lr={FINETUNE_LR:.5f}",
            f"model.init_args.coef_smooth_weight={FINETUNE_SMOOTH}",
            "ckpt_params_only=true", f"ckpt_path={ckpt}"]
    with StepProbe() as probe:
        counts = cli_run(argv)
    probe.check_steps("finetune GOLF-ss (SGD)",
                      ("lookup", "lookup_dtab", "allpole_tv",
                       "allpole_tv_adjoint"), absent=("lookup_res",))
    start = ckpt_lib.load(str(ckpt), map_location="cpu")["model"]
    end = ckpt_lib.load(str(out / "ss" / "ckpt" / "last"),
                        map_location="cpu")
    # the weights, not the statistics a train-mode forward updates
    cfg = load_config(["cfg/ae/vctk.yaml"],
                      "cfg/ae/decoder/golf-precise-stable.yaml",
                      disk_overrides(tree))
    weights = {n for n, _ in build_voice_autoencoder(
        cfg["model"]["init_args"], device="cpu").named_parameters()}
    moved = max((end["model"][k] - start[k]).abs().max().item()
                for k in weights)
    bound = DISK_STEPS * FINETUNE_LR * 0.5
    print(f"finetune: the optimizer state is {end['optimizer']['optimizer']}"
          f"'s after {end['optimizer']['count']} updates; the weights moved "
          f"at most {moved:.3e} from the GOLF-ff checkpoint (bound "
          f"{bound:.1e}: {DISK_STEPS} steps of lr {FINETUNE_LR:g} under the "
          f"0.5 clip); launches over the run {counts}")
    check(end["optimizer"]["optimizer"] == "sgd", "finetune ran SGD")
    check(0 < moved <= bound, "finetune started from the checkpoint")
    phase_train_vs_cpu("golf-precise-stable", state=start,
                       optimizer={"optimizer": "sgd", "lr": FINETUNE_LR,
                                  "grad_clip": 0.5},
                       coef_smooth_weight=FINETUNE_SMOOTH)
    return counts, probe


# ---------------------------------------------------------------------------
# the ISMIR23 mel vocoder (main_torch.py, cfg/vocoder.yaml)
# ---------------------------------------------------------------------------

def vocoder_cfg(decoder: str) -> dict:
    """model.init_args of ``cfg/vocoder.yaml`` with
    ``cfg/ae/decoder/<decoder>.yaml``."""
    return load_config([VOCODER_CONFIG],
                       f"cfg/ae/decoder/{decoder}.yaml")["model"]["init_args"]


def vocoder_model(decoder: str, device, cfg: dict = None) -> DDSPVocoder:
    """The full-width vocoder (``vocoder_cfg(decoder)``, or ``cfg``) with
    seeded weights; the zero-initialised head and acoustic filter (the
    room filter, or HPN's end filter) get small random values so the
    parameters are off the DSP prior."""
    torch.manual_seed(SEED)
    task = build_ddsp_vocoder(cfg or vocoder_cfg(decoder), device="cpu")
    gen = torch.Generator().manual_seed(SEED + 2)
    with torch.no_grad():
        head = task.encoder.backbone.out_linear
        head.weight.copy_(0.004 * torch.randn(head.weight.shape,
                                              generator=gen))
        head.bias.copy_(0.05 * torch.randn(head.bias.shape, generator=gen))
        acoustic = getattr(task.decoder, "room_filter", None) or \
            task.decoder.end_filter
        acoustic.kernel.copy_(0.01 * torch.randn(acoustic.kernel.shape,
                                                 generator=gen))
    return task.to(device)


def vocoder_shapes(batch: int, t: int, train: bool) -> dict:
    """Operand shapes B1 (serving) or B3a and B3b (training), and B2, get
    from the vocoder for ``batch`` clips of ``t`` samples: mel frames
    t // 240 + 1 (centred), cut to the f0 track's t // 240 in training;
    the 4x oversampled phase in blocks of 9600 with the table rows of the
    downsampler (hop 10 frames, padded to blocks + 1); the LPC on every
    960-sample window of the frames."""
    mel = t // 240 + 1
    frames = t // 240 if train else mel
    blocks = -(-((frames - 1) * 960 + 1) // 9600)
    rows = max((mel + 2 * 5 - 10) // 10 + 1, blocks + 1)
    lookup = ((batch, blocks, 9600), (batch, rows, 2048))
    n_ff = batch * frames
    shapes = {"allpole_const": ((n_ff, 960), (n_ff, 22))}
    if train:
        shapes.update(lookup_res=lookup, lookup_dtab=lookup,
                      allpole_const_adjoint=shapes["allpole_const"])
    else:
        shapes["lookup"] = lookup
    return shapes


def check_shapes(label: str, expect: dict) -> None:
    for name, shapes in expect.items():
        k = next(k for k in DSP_KERNELS if k.name == name)
        check(k.last_shapes == shapes,
              f"{label}: {name} shapes {k.last_shapes} == {shapes}")


def write_mpop_tree(root: Path) -> dict:
    """A miniature MPop600 singer tree: flat 24 kHz PCM16 ``f1_NNN.wav``
    files with their 5 ms ``.pv`` f0 tracks, synthetic voices (one seed a
    file). 001-003 are the test split (4 s each), 004-006 the valid split
    (2.5 s each), 007-012 the train split (10 s each: 17 segments of 2 s at
    overlap 1.5 a file). Returns the segment counts."""
    seconds = {**{i: 4.0 for i in range(1, 4)},
               **{i: 2.5 for i in range(4, 7)},
               **{i: 10.0 for i in range(7, 13)}}
    for i, secs in seconds.items():
        write_voice(root / f"f1_{i:03d}.wav", secs, SEED + 300 + i)
    seg = lambda secs: int((secs - 2.0) / 0.5) + 1  # noqa: E731
    return {split: sum(seg(seconds[i]) for i in ids) for split, ids in
            (("train", range(7, 13)), ("valid", range(4, 7)),
             ("test", range(1, 4)))}


def phase_vocoder_fit(tree: Path, out: Path) -> tuple:
    """``main_torch.py fit --model cfg/ae/decoder/golf-v1.yaml`` from the
    MPop600 tree, DISK_STEPS Adam steps at B = 64 x 2 s: B3a, B3b, B2 and
    B2's adjoint entry once a step, B1 never (the voicing's gradient reaches
    the phase); the first batch equal to the CPU ``MPop600`` module's bit
    for bit. Returns (launches, checkpoint, probe)."""
    over = [f"data.init_args.wav_dir={tree}"]
    argv = ["fit", "--model", "cfg/ae/decoder/golf-v1.yaml", *over,
            "--run_dir", str(out / "v1"), f"trainer.max_steps={DISK_STEPS}"]
    with StepProbe() as probe:
        counts = cli_run(argv, VOCODER_CONFIG)
    probe.check_steps("vocoder fit golf-v1", ("lookup_res", "lookup_dtab",
                                              "allpole_const",
                                              "allpole_const_adjoint"),
                      absent=("lookup",))
    cfg = load_config([VOCODER_CONFIG], "cfg/ae/decoder/golf-v1.yaml", over)
    dm = instantiate(cfg["data"])
    check(type(dm).__name__ == "MPop600", "vocoder.yaml builds MPop600")
    dm.setup("fit")
    loader = dm.train_dataloader()
    next(iter(loader))
    x, f0 = next(iter(loader))
    same = np.array_equal(probe.batch[0], x) and \
        np.array_equal(probe.batch[1], f0)
    print(f"vocoder fit: first batch {probe.batch[0].shape} on the card == "
          f"the CPU MPop600 module's: {same}; launches over the run {counts}")
    check(same and x.shape == (TRAIN_BATCH, int(TRAIN_SECONDS * SR)),
          "vocoder fit's first batch bit for bit")
    ckpt = out / "v1" / "ckpt" / "last"
    check(ckpt.exists(), "vocoder checkpoint written")
    return counts, ckpt, probe


def phase_vocoder_test(tree: Path, ckpt: Path, out: Path) -> tuple:
    """``main_torch.py test`` of the checkpoint on the tree's test split:
    finite ``avg_mss_loss`` and ``avg_f0_loss`` (cents), with the command's
    time and peak memory."""
    argv = ["test", "--model", "cfg/ae/decoder/golf-v1.yaml",
            f"data.init_args.wav_dir={tree}", "--run_dir", str(out / "t"),
            "--ckpt_path", str(ckpt)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    text = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(text):
        counts = cli_run(argv, VOCODER_CONFIG)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(text.getvalue(), end="")
    result = json.loads(text.getvalue().strip().splitlines()[-1])
    print(f"vocoder test: {result}; {secs:.2f} s for the whole command "
          f"(data, model, restore, resynthesis, DIO on the host); peak "
          f"memory {peak:.2f} GiB; launches {counts}")
    check(set(result) == {"avg_mss_loss", "avg_f0_loss"} and
          all(np.isfinite(v) for v in result.values()),
          "vocoder test metrics finite")
    check(counts["lookup"] >= 1 and counts["allpole_const"] >= 1,
          "vocoder test launched B1 and B2")
    return counts, {"test_s": secs, "test_peak_gib": peak, **result}


def capture_noise(task) -> list:
    """The noise fields the decoder's generator draws, as they are drawn."""
    seen = []
    task.decoder.noise_generator.register_forward_hook(
        lambda m, i, o: seen.append(o.data.detach()))
    return seen


def phase_vocoder_serve(out: Path) -> tuple:
    """The vocoder serves: ``predict_step`` on B = 4 x 6 s synthetic
    requests (B1 and B2 once each a predict, at the vocoder's shapes),
    one 14 s request through ``chunked_ola_predict`` (three chunks, the
    output as long as the input), ``main_torch.py predict`` on Synthetic
    data (one wav an item), and one 2 s request card vs the port's CPU run
    on the same weights and noise within 1e-3 of max|y|."""
    dev = torch.device("cuda")
    task = vocoder_model("golf-v1", dev)
    x, f0 = requests(BATCH, SECONDS)
    xs = Sig(x.to(dev), 1)
    task.init_running_stats(xs, Sig(f0.to(dev), 1))
    task.eval()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    for k in DSP_KERNELS:
        k.launches = 0
    latencies = []
    with torch.inference_mode():
        for _ in range(3):
            y, secs = timed(lambda: task.predict_step(xs, generator=gen)[0])
            latencies.append(secs)
    counts = {k.name: k.launches for k in DSP_KERNELS}
    print(f"vocoder serve: out {tuple(y.shape)}, latency per predict (B="
          f"{BATCH} x {SECONDS:.0f} s, batched) first "
          f"{latencies[0] * 1e3:.1f} ms, then "
          f"{', '.join(f'{s * 1e3:.1f}' for s in latencies[1:])} ms; "
          f"launches {counts}")
    check(torch.isfinite(y.data).all().item(), "vocoder output finite")
    check(y.shape[0] == BATCH and y.shape[1] > 0.99 * SECONDS * SR,
          f"vocoder output shape {y.shape}")
    check(counts["lookup"] == 3 and counts["allpole_const"] == 3,
          "vocoder predict launched B1 and B2 once each a call")
    check(sum(counts.values()) == 6, "vocoder predict launched B1 and B2 "
          "only")
    check_shapes("vocoder serve", vocoder_shapes(BATCH, int(SECONDS * SR),
                                                 train=False))

    # one 14 s request in 6 s chunks crossfaded over 0.3 s
    xl, _ = requests(1, 14.0)

    def resynth(frames: np.ndarray) -> np.ndarray:
        yc, _ = task.predict_step(Sig(torch.from_numpy(frames).to(dev), 1),
                                  generator=gen)
        return yc.data.cpu().numpy()

    with torch.inference_mode():
        chunked_ola_predict(resynth, xl.numpy(), SR)      # warm-up
        for k in DSP_KERNELS:
            k.launches = 0
        t0 = time.perf_counter()
        ola = chunked_ola_predict(resynth, xl.numpy(), SR)
        ola_s = time.perf_counter() - t0
    ola_counts = {k.name: k.launches for k in DSP_KERNELS}
    rtf = xl.shape[1] / SR / ola_s
    print(f"vocoder OLA: a 14 s request in 3 chunks of 6 s: out "
          f"{ola.shape}, {ola_s * 1e3:.1f} ms host time with the copies "
          f"(real-time factor {rtf:.1f}); launches {ola_counts}")
    check(ola.shape == (xl.shape[1],) and np.isfinite(ola).all(),
          "OLA output as long as its input")
    check(ola_counts["lookup"] == 1 and ola_counts["allpole_const"] == 1,
          "OLA ran its chunks as one batch")

    # the CLI's predict on Synthetic data
    pred_dir = out / "predict"
    cli_counts = cli_run(
        ["predict", "--model", "cfg/ae/decoder/golf-v1.yaml",
         "data.class_path=ltng.data.Synthetic", "data.init_args.n_items=64",
         "--run_dir", str(pred_dir)], VOCODER_CONFIG)
    wavs = sorted((pred_dir / "predictions").glob("*.wav"))
    print(f"vocoder predict CLI: {len(wavs)} wavs; launches {cli_counts}")
    check(len(wavs) == 8, "predict wrote one wav per Synthetic test item")

    # one 2 s request, card vs CPU, the same weights and noise
    n = int(CHECK_SECONDS * SR)
    cpu_task = vocoder_model("golf-v1", "cpu")
    cpu_task.load_state_dict({k: v.cpu() for k, v in
                              task.state_dict().items()})
    cpu_task.eval()
    noise = capture_noise(cpu_task)
    with torch.inference_mode():
        y_cpu, _ = cpu_task.predict_step(
            Sig(x[:1, :n], 1), generator=torch.Generator().manual_seed(7))
        y_gpu, _ = task.predict_step(Sig(x[:1, :n].to(dev), 1),
                                     noise=noise[0].to(dev))
    rel = ((y_gpu.data.cpu() - y_cpu.data).abs().max()
           / y_cpu.data.abs().max()).item()
    print(f"vocoder serve: 2 s request, card vs CPU: max err / max|y| "
          f"{rel:.3e} (tolerance 1e-3)")
    check(rel <= 1e-3, "vocoder served audio card vs CPU")
    total = {name: counts[name] + ola_counts[name] + cli_counts[name]
             for name in counts}
    return total, {"predict_ms": [s * 1e3 for s in latencies],
                   "ola_ms": ola_s * 1e3, "ola_rtf": rtf,
                   "card_vs_cpu": rel}


def phase_vocoder_train_vs_cpu(decoder: str = "golf-v1",
                               cfg: dict = None) -> dict:
    """One recipe training step (golf-v1, the voicing not detached; or
    ``decoder`` with the configuration ``cfg``) at B = 2 x 1 s, card
    against CPU, same weights and noise, train mode: the loss
    within 1e-4 relative; every gradient within 1e-3 of its max-abs of the
    CPU's, or, where the CPU's float32 gradient itself strays further than
    that from a float64 CPU run (the voicing's gradient through the
    wavetable's phase sums long, nearly cancelling terms), within 1e-3 of
    the float64 gradient or twice the CPU's distance from it (two float32
    evaluations of the same sum in other orders)."""
    dev = torch.device("cuda")
    cpu_task = vocoder_model(decoder, "cpu", cfg)
    x, f0 = requests(TRAIN_CHECK_BATCH, TRAIN_CHECK_SECONDS)
    # white noise at -20 dB of full scale keeps the mel bins off the floor
    x = x + 0.1 * torch.randn(x.shape,
                              generator=torch.Generator().manual_seed(8))
    cpu_task.init_running_stats(Sig(x, 1), Sig(f0, 1))
    state = cpu_task.state_dict()
    noise = capture_noise(cpu_task)
    grads, losses = {}, {}
    for label, task, d, dtype in (
            ("cpu", cpu_task, torch.device("cpu"), torch.float32),
            ("card", vocoder_model(decoder, "cpu", cfg).to(dev), dev,
             torch.float32),
            ("cpu64", vocoder_model(decoder, "cpu", cfg).double(),
             torch.device("cpu"), torch.float64)):
        task.load_state_dict(state)
        task.train()
        kw = {"generator": torch.Generator().manual_seed(7)} \
            if label == "cpu" else {"noise": noise[0].to(d, dtype)}
        loss, _ = task.training_step(Sig(x.to(d, dtype), 1),
                                     Sig(f0.to(d, dtype), 1), **kw)
        loss.backward()
        losses[label] = loss.item()
        # (in the inverse mode the room filter takes no gradient)
        grads[label] = {n: p.grad.detach().cpu().double()
                        for n, p in task.named_parameters()
                        if p.grad is not None}
    rel_loss = abs(losses["card"] - losses["cpu"]) / abs(losses["cpu"])
    errs, failed = {}, []
    for name, ref in grads["cpu"].items():
        got, exact = grads["card"][name], grads["cpu64"][name]
        err = ((got - ref).abs().max() / ref.abs().max()).item()
        scale = exact.abs().max()
        card64 = ((got - exact).abs().max() / scale).item()
        cpu64 = ((ref - exact).abs().max() / scale).item()
        errs[name] = (err, card64, cpu64)
        if err > TRAIN_GRAD_TOL and card64 > max(TRAIN_GRAD_TOL,
                                                 2 * cpu64):
            failed.append(name)
    ranked = sorted(errs, key=lambda n: errs[n][0], reverse=True)
    print(f"vocoder train {decoder}: B={TRAIN_CHECK_BATCH} x "
          f"{TRAIN_CHECK_SECONDS:.0f} s, card vs CPU: loss "
          f"{losses['card']:.6f} vs {losses['cpu']:.6f} (rel {rel_loss:.2e}, tolerance 1e-4; "
          f"float64 {losses['cpu64']:.6f}); largest gradient errors (card "
          f"vs CPU, card vs float64, CPU vs float64, of max-abs): " +
          ", ".join(f"{n} {e[0]:.2e}/{e[1]:.2e}/{e[2]:.2e}" for n, e in
                    ((n, errs[n]) for n in ranked[:4])))
    check(rel_loss <= 1e-4, "vocoder train loss card vs CPU")
    check(not failed, f"vocoder train gradients card vs CPU: {failed}")
    return {"loss_rel": rel_loss,
            "worst_grad": {n: errs[n] for n in ranked[:3]}}


def phase_vocoder_steps(decoder: str, expect: dict) -> tuple:
    """DISK_STEPS Adam steps of the full-width vocoder with ``decoder`` at
    B = 64 x 2 s through the Trainer on synthetic items: losses finite,
    ``expect``'s kernels once a step (none for ddsp), the step's host time
    and peak memory."""
    dev = torch.device("cuda")
    task = vocoder_model(decoder, dev)
    x, f0 = requests(TRAIN_BATCH, TRAIN_SECONDS)
    xs, f0s = Sig(x.to(dev), 1), Sig(f0.to(dev), 1)
    trainer = Trainer(task, run_dir=f"chiprun_out/chip_smoke_{decoder}",
                      max_steps=DISK_STEPS, seed=SEED)
    task.init_running_stats(xs, f0s)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in DSP_KERNELS:
        k.launches = 0
    losses, times = [], []
    for _ in range(DISK_STEPS):
        metrics, secs = timed(lambda: trainer.train_step(xs, f0s))
        losses.append(metrics["loss"].item())
        times.append(secs)
        trainer.step += 1
    counts = {k.name: k.launches for k in DSP_KERNELS}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"vocoder train {decoder}: B={TRAIN_BATCH} x {TRAIN_SECONDS:.0f} s, "
          f"losses {', '.join(f'{v:.5f}' for v in losses)}; step wall time "
          f"(host clock around synchronize, TF32 off) "
          f"{', '.join(f'{t * 1e3:.1f}' for t in times)} ms; peak memory "
          f"{peak:.2f} GiB; launches {counts}")
    check(all(np.isfinite(losses)), f"vocoder {decoder} losses finite")
    for name in counts:
        want = DISK_STEPS if name in expect else 0
        check(counts[name] == want, f"vocoder {decoder} launched {name} "
              f"{counts[name]} times, not {want}")
    check_shapes(f"vocoder train {decoder}", expect)
    return counts, {"step_ms": [t * 1e3 for t in times], "peak_gib": peak}


def phase_vocoder() -> tuple:
    """The ISMIR23 vocoder end to end: the recipe from a miniature MPop600
    tree (fit, test), serving, a training step card vs CPU, and ddsp.yaml
    (155 harmonics, no kernel) at full width. Returns (launches, the
    summary for the ``vocoder`` line)."""
    counts = {k.name: 0 for k in DSP_KERNELS}

    def add(c: dict) -> None:
        for name, n in c.items():
            counts[name] += n

    summary = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_voc_",
                                     dir="runs") as tmp:
        tree, out = Path(tmp) / "mpop600", Path(tmp) / "runs"
        sizes = write_mpop_tree(tree)
        print(f"vocoder: an MPop600 tree of {sizes} segments of 2 s at "
              f"overlap 1.5")
        check(sizes["train"] >= TRAIN_BATCH, "a full training batch")
        fit_counts, ckpt, probe = phase_vocoder_fit(tree, out)
        add(fit_counts)
        summary["fit_step_ms"] = [t * 1e3 for t in probe.times]
        test_counts, summary["test"] = phase_vocoder_test(tree, ckpt, out)
        add(test_counts)
        serve_counts, summary["serve"] = phase_vocoder_serve(out)
        add(serve_counts)
    summary["train_vs_cpu"] = phase_vocoder_train_vs_cpu()
    train = vocoder_shapes(TRAIN_BATCH, int(TRAIN_SECONDS * SR), train=True)
    for decoder, expect in (("golf-v1", train), ("ddsp", {})):
        c, summary[decoder] = phase_vocoder_steps(decoder, expect)
        add(c)
    return counts, summary


# ---------------------------------------------------------------------------
# LPCNet (main_torch.py --config cfg/lpcnet.yaml) and the WORLD baseline
# (autoencode_torch.py --config cfg/ae/pyworld.yaml)
# ---------------------------------------------------------------------------

def lpcnet_b2_shapes(batch: int, t: int) -> tuple:
    """B2's operands in LPCNet's ``generate``: the de-emphasis of ``batch``
    outputs of ``t`` samples, order 1."""
    return ((batch, t), (batch, 1))


def phase_kernels_lpcnet() -> dict:
    """B2 at LPCNet's de-emphasis shape, (32, 24000) with a = -0.85 (32, 1),
    on outputs in [-1, 1] as ``generate``'s: within 1e-5 of max|y| of its
    plain version and 1e-6 of its float64 mirror, with its time, the plain
    version's and the byte bound (the order-1 recurrence needs 2 flops a
    sample; the kernel pads the order to 22)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x_shape, a_shape = lpcnet_b2_shapes(LPCNET_BATCH,
                                        int(LPCNET_SECONDS * SR))
    x = torch.rand(x_shape, generator=gen, device="cuda") * 2 - 1
    a = torch.full(a_shape, -0.85, device="cuda")
    out = allpole_const_cuda(x, a)
    ref = allpole_const_plain(x, a)
    err = (out - ref).abs().max().item()
    rel = err / ref.abs().max().item()
    rel64 = rel_err(out, allpole_const_scan64(x, a))
    print(f"[lpcnet] allpole_const (B2) {x_shape} p=1: max err {err:.3e}, "
          f"/ max|y| {rel:.3e} against allpole_const_plain (tolerance "
          f"1e-5); {rel64:.3e} against allpole_const_scan64 (tolerance "
          f"1e-6)")
    check(rel <= 1e-5 and rel64 <= 1e-6 and torch.isfinite(out).all().item(),
          "allpole_const at LPCNet's shape vs plain and float64")
    n, t = x_shape
    row = dict(err=err, rel64=rel64,
               ms=cuda_ms(lambda: allpole_const_cuda(x, a), 20),
               plain_ms=cuda_ms(lambda: allpole_const_plain(x, a), 3,
                                strict=False),
               bound=bound(4 * (2 * n * t + n), 2 * n * t, fp64=True),
               shapes=[list(x_shape), list(a_shape)])
    print(f"B2 at LPCNet's de-emphasis {x_shape}: {row['ms'] * 1e3:.1f} us, "
          f"bound {row['bound'][0] * 1e3:.2f} us ({row['bound'][1]}), plain "
          f"{row['plain_ms'] * 1e3:.1f} us")
    return row


def lpcnet_model(device) -> LPCNetVocoder:
    """The full-width ``cfg/lpcnet.yaml`` model with seeded weights; the
    frame net's zero-initialised head gets small random values, so the LAR,
    the LPC, the prediction p and the ``match_lpc`` loss are off their
    trivial values (all zero at the initialisation)."""
    torch.manual_seed(SEED)
    task = build_lpcnet_vocoder(
        load_config([LPCNET_CONFIG])["model"]["init_args"], device="cpu")
    gen = torch.Generator().manual_seed(SEED + 3)
    with torch.no_grad():
        head = task.frame_decoder.out_linear
        head.weight.copy_(0.02 * torch.randn(head.weight.shape,
                                             generator=gen))
        head.bias.copy_(0.1 * torch.randn(head.bias.shape, generator=gen))
    return task.to(device)


def lpcnet_batch(n: int, seconds: float):
    """Synthetic voices plus white noise at -30 dB of full scale."""
    x, f0 = requests(n, seconds)
    return x + 0.03 * torch.randn(
        x.shape, generator=torch.Generator().manual_seed(SEED + 9)), f0


def phase_lpcnet_steps() -> dict:
    """DISK_STEPS steps of the recipe's optimizer (Adam with amsgrad, lr
    1e-3 decayed by 1 / (1 + 5e-5 step), clip 0.5) at B = 32 x 1 s through
    the Trainer: losses finite, no kernel launched (B2 runs in ``generate``
    only), the step's host time and peak memory."""
    dev = torch.device("cuda")
    task = lpcnet_model(dev)
    x, f0 = lpcnet_batch(LPCNET_BATCH, LPCNET_SECONDS)
    xs, f0s = Sig(x.to(dev), 1), Sig(f0.to(dev), 1)
    kw = {**cli.trainer_kwargs(load_config([LPCNET_CONFIG])),
          "max_steps": DISK_STEPS}
    check(kw["optimizer"] == "amsgrad" and kw["lr_decay"] == 5e-5 and
          kw["lr"] == 1e-3 and kw["grad_clip"] == 0.5,
          f"cfg/lpcnet.yaml's optimizer: {kw}")
    trainer = Trainer(task, run_dir="runs/chip_smoke_lpcnet", **kw)
    task.init_running_stats(xs, f0s)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in DSP_KERNELS:
        k.launches = 0
    losses, times = [], []
    for _ in range(DISK_STEPS):
        metrics, secs = timed(lambda: trainer.train_step(xs, f0s))
        losses.append(metrics["loss"].item())
        times.append(secs)
        trainer.step += 1
    counts = {k.name: k.launches for k in DSP_KERNELS}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"lpcnet train: B={LPCNET_BATCH} x {LPCNET_SECONDS:.0f} s, losses "
          f"{', '.join(f'{v:.5f}' for v in losses)} (ll "
          f"{metrics['ll'].item():.5f}, lar_l2 {metrics['lar_l2'].item():.5f}"
          f"); step wall time (host clock around synchronize, TF32 off) "
          f"{', '.join(f'{t * 1e3:.1f}' for t in times)} ms; peak memory "
          f"{peak:.2f} GiB; launches {counts}")
    check(all(np.isfinite(losses)), "lpcnet losses finite")
    check(not any(counts.values()), f"lpcnet training launched {counts}")
    return {"step_ms": [t * 1e3 for t in times], "peak_gib": peak,
            "losses": losses}


def phase_lpcnet_vs_cpu() -> dict:
    """One training step at B = 2 x 0.25 s, card against CPU, same weights,
    running min/max and teacher-forcing noise, train mode. float32: the
    loss within 1e-4 relative. float64 on both sides: every gradient within
    1e-3 of its max-abs (the card's cuDNN convolutions, LSTM and GRUs and
    the embedding table's atomics). The float32 gradients with cuDNN are
    printed, not held: the loss is not smooth (the floor of the embeddings'
    and the likelihood's continuous mu-law indices, steep near zero), so the
    frame net's gradient jumps when a forward value moves by ~1e-5
    relative, as cuDNN's float32 convolutions move it against the CPU's (a
    float64 CPU run shows the same 11% jump for a 1e-5 perturbation of one
    conv weight). The same float32 card step with cuDNN off holds every
    gradient within 1e-3 of max-abs of the CPU's: the gap is cuDNN's, not
    the port's."""
    dev = torch.device("cuda")
    x, f0 = lpcnet_batch(TRAIN_CHECK_BATCH, LPCNET_CHECK_SECONDS)
    base = lpcnet_model("cpu")
    base.init_running_stats(Sig(x, 1), Sig(f0, 1))
    state = base.state_dict()
    noise = torch.randn((x.shape[0], x.shape[1] - 1),
                        generator=torch.Generator().manual_seed(SEED + 5))
    losses, grads = {}, {}
    for label, d, dtype in (("card", dev, torch.float32),
                            ("cpu", torch.device("cpu"), torch.float32),
                            ("card64", dev, torch.float64),
                            ("cpu64", torch.device("cpu"), torch.float64),
                            ("card_nocudnn", dev, torch.float32)):
        task = lpcnet_model("cpu")
        task.load_state_dict(state)
        task = task.to(d, dtype).train()
        cudnn = torch.backends.cudnn.enabled
        # the suspect of ROADMAP §C: the same float32 card step with cuDNN
        # off (PyTorch's own CUDA convolutions, LSTM and GRUs)
        torch.backends.cudnn.enabled = label != "card_nocudnn"
        try:
            loss, _ = task.training_step(Sig(x.to(d, dtype), 1),
                                         Sig(f0.to(d, dtype), 1),
                                         noise=noise.to(d, dtype))
            loss.backward()
        finally:
            torch.backends.cudnn.enabled = cudnn
        losses[label] = loss.item()
        # (in the inverse mode the room filter takes no gradient)
        grads[label] = {n: p.grad.detach().cpu().double()
                        for n, p in task.named_parameters()
                        if p.grad is not None}

    def gaps(a: str, b: str) -> dict:
        return {n: ((grads[a][n] - ref).abs().max()
                    / ref.abs().max().clamp(min=1e-30)).item()
                for n, ref in grads[b].items()}

    rel_loss = abs(losses["card"] - losses["cpu"]) / abs(losses["cpu"])
    errs64, errs32 = gaps("card64", "cpu64"), gaps("card", "cpu")
    errs_nc = gaps("card_nocudnn", "cpu")
    worst64 = max(errs64, key=errs64.get)
    worst32 = max(errs32, key=errs32.get)
    worst_nc = max(errs_nc, key=errs_nc.get)
    loss_nc = abs(losses["card_nocudnn"] - losses["cpu"]) / abs(losses["cpu"])
    print(f"lpcnet train: float32 card step with cuDNN off vs CPU: loss "
          f"{loss_nc:.2e} relative; worst gradient {worst_nc} "
          f"{errs_nc[worst_nc]:.2e} of its max|ref| (with cuDNN "
          f"{errs32[worst_nc]:.2e}); the frame net's worst "
          f"{max(v for n, v in errs_nc.items() if n.startswith('frame')):.2e}"
          f" (tolerance {TRAIN_GRAD_TOL:g}: the float32 card-vs-CPU "
          f"gap of the frame net is cuDNN's)")
    sample32 = max((n for n in errs32 if n.startswith("sample_decoder")),
                   key=errs32.get)
    print(f"lpcnet train: B={TRAIN_CHECK_BATCH} x {LPCNET_CHECK_SECONDS} s, "
          f"card vs CPU: loss {losses['card']:.6f} vs {losses['cpu']:.6f} "
          f"(rel {rel_loss:.2e}, tolerance 1e-4); float64 worst gradient "
          f"{worst64} {errs64[worst64]:.2e} of its max|ref| (tolerance 1e-3); "
          f"float32 (not held) worst {worst32} {errs32[worst32]:.2e}, the "
          f"sample net's worst {sample32} {errs32[sample32]:.2e}")
    check(rel_loss <= 1e-4, "lpcnet train loss card vs CPU")
    check(errs64[worst64] <= TRAIN_GRAD_TOL,
          "lpcnet float64 train gradients card vs CPU")
    check(errs_nc[worst_nc] <= TRAIN_GRAD_TOL,
          "lpcnet float32 train gradients card (cuDNN off) vs CPU")
    return {"loss_rel": rel_loss, "worst_grad64": errs64[worst64],
            "worst_grad64_name": worst64, "worst_grad32": errs32[worst32],
            "worst_grad32_name": worst32,
            "worst_sample_net_grad32": errs32[sample32],
            "nocudnn_worst_grad32": errs_nc[worst_nc],
            "nocudnn_worst_grad32_name": worst_nc,
            "nocudnn_loss_rel": loss_nc}


def phase_lpcnet_generate() -> tuple:
    """One ``generate`` at B = 32 x 1 s (eval mode): shape, finite, within
    the de-emphasis's bound 1 / (1 - 0.85), B2 launched exactly once at
    (32, 24000) x (32, 1) and no other kernel; its host time. Then B = 2 x
    0.05 s card against CPU: the sampling loop and the de-emphasis on the
    CPU's conditioning and LPC with the same Gumbel draws, within 1e-4 of
    max|y|. (The whole ``generate`` cannot be compared: cuDNN's float32
    convolutions move the conditioning by ~1e-5 relative, enough to change
    a draw, after which the two outputs are different samples.) Returns
    (launches, summary)."""

    dev = torch.device("cuda")
    task = lpcnet_model(dev)
    x, f0 = lpcnet_batch(LPCNET_BATCH, LPCNET_SECONDS)
    xs = Sig(x.to(dev), 1)
    task.init_running_stats(xs, Sig(f0.to(dev), 1))
    task.eval()
    gen = torch.Generator(dev).manual_seed(SEED)
    for k in DSP_KERNELS:
        k.launches = 0
    with torch.inference_mode():
        y, secs = timed(lambda: task.generate(xs, generator=gen))
    counts = {k.name: k.launches for k in DSP_KERNELS}
    t = int(LPCNET_SECONDS * SR)
    print(f"lpcnet generate: B={LPCNET_BATCH} x {LPCNET_SECONDS:.0f} s, out "
          f"{tuple(y.shape)}, max|y| {y.abs().max().item():.3f}; host time "
          f"{secs:.2f} s ({secs / t * 1e6:.1f} us a sample step, "
          f"{secs / (LPCNET_BATCH * LPCNET_SECONDS):.3f} s a second of "
          f"audio); launches {counts}")
    check(y.shape == (LPCNET_BATCH, t) and torch.isfinite(y).all().item()
          and y.abs().max().item() <= 1 / (1 - 0.85) + 1e-4,
          "lpcnet generate output")
    for name, n in counts.items():
        want = 1 if name == "allpole_const" else 0
        check(n == want, f"lpcnet generate launched {name} {n} times, not "
              f"{want}")
    check_shapes("lpcnet generate",
                 {"allpole_const": lpcnet_b2_shapes(LPCNET_BATCH, t)})
    loop = profile_sample_loop(task, xs, gen)

    n = int(LPCNET_AR_CHECK_SECONDS * SR)
    xc = x[:TRAIN_CHECK_BATCH, :n]
    cpu_task = lpcnet_model("cpu")
    cpu_task.load_state_dict({k: v.cpu() for k, v in
                              task.state_dict().items()})
    cpu_task.eval()
    # drawn in the order sample draws them, one (B, Q) a step
    g = gumbel_noise((n, TRAIN_CHECK_BATCH, task.quantization_channels),
                     torch.Generator().manual_seed(SEED + 4)).transpose(0, 1)
    with torch.inference_mode():
        _, f, up_lpc, _, _, _ = cpu_task._prepare(xc, train=False)
        y_card = deemphasis(task.sample(f.to(dev), up_lpc.to(dev),
                                        noise=g.to(dev)), task.alpha).cpu()
        y_cpu = deemphasis(cpu_task.sample(f, up_lpc, noise=g),
                           cpu_task.alpha)
    rel = ((y_card - y_cpu).abs().max() / y_cpu.abs().max()).item()
    print(f"lpcnet generate: B={TRAIN_CHECK_BATCH} x "
          f"{LPCNET_AR_CHECK_SECONDS} s, the sampling loop and de-emphasis "
          f"card vs CPU on the same conditioning and Gumbel draws: max err / "
          f"max|y| {rel:.3e} (tolerance 1e-4)")
    check(rel <= 1e-4, "lpcnet generate card vs CPU")
    return counts, {"generate_s": secs, "us_per_step": secs / t * 1e6,
                    "vs_cpu": rel, **loop}


def profile_sample_loop(task: LPCNetVocoder, xs: Sig, gen, steps: int = 50
                        ) -> dict:
    """A ``torch.profiler`` window over ``steps`` steps of the sampling loop
    at the batch's width, after a warm-up: the device kernels a step, and
    the device's busy time (the loop runs on one stream, so its kernels do
    not overlap) over the window's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode():
        _, f, up_lpc, _, _, _ = task._prepare(xs.data, train=False)
        f, up_lpc = f[:, :steps], up_lpc[:, :steps]
        task.sample(f, up_lpc, generator=gen)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            task.sample(f, up_lpc, generator=gen)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    spans = [e.time_range for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    busy_ms = sum(r.end - r.start for r in spans) / 1e3
    out = {"kernels_per_step": len(spans) / steps,
           "profiled_us_per_step": wall_ms / steps * 1e3,
           "idle_share": 1 - busy_ms / wall_ms if spans else None}
    print(f"lpcnet sampling loop, profiled over {steps} steps at B="
          f"{f.shape[0]}: {out['kernels_per_step']:.1f} device kernels a "
          f"step, {out['profiled_us_per_step']:.1f} us a step under the "
          f"profiler, device busy {busy_ms:.2f} of {wall_ms:.2f} ms (idle "
          f"share {out['idle_share']})")
    check(len(spans) > 0, "the profiler saw the sampling loop's kernels")
    return out


def write_ljspeech_tree(root: Path) -> dict:
    """A miniature flat LJSpeech tree of synthetic voices: LJ001-0001..0020
    are the test split (1 s each: 20 segments, one batch of the protocol's
    autoregressive resynthesis), LJ001-0021..0022 the valid split (1 s),
    LJ002-0001..0004 the train split (5 s each: 9 segments of 1 s at
    overlap 0.5). Returns the segment counts."""
    for i in range(1, 23):
        write_voice(root / f"LJ001-{i:04d}.wav", 1.0, SEED + 500 + i)
    for i in range(1, 5):
        write_voice(root / f"LJ002-{i:04d}.wav", 5.0, SEED + 600 + i)
    return {"train": 4 * 9, "valid": 2, "test": 20}


def phase_lpcnet_cli(tree: Path, out: Path) -> tuple:
    """``main_torch.py fit --config cfg/lpcnet.yaml`` from the LJSpeech
    tree (LPCNET_FIT_STEPS steps at B = 32 x 1 s: finite losses, no kernel),
    then ``test`` of that checkpoint: the teacher-forced metrics over the
    20 test segments and the autoregressive protocol on their one batch (B2
    once). Returns (launches, summary)."""
    over = ["--config", LPCNET_CONFIG, f"data.init_args.wav_dir={tree}"]
    with StepProbe() as probe:
        fit_counts = cli_run(["fit", *over, "--run_dir", str(out / "lpcnet"),
                              f"trainer.max_steps={LPCNET_FIT_STEPS}"],
                             VOCODER_CONFIG)
    print(f"lpcnet CLI fit: losses {probe.losses}, step wall time "
          f"{[f'{t * 1e3:.1f}' for t in probe.times]} ms, batch "
          f"{probe.batch[0].shape}")
    check(len(probe.times) == LPCNET_FIT_STEPS and
          all(np.isfinite(probe.losses)) and
          probe.batch[0].shape == (LPCNET_BATCH, int(LPCNET_SECONDS * SR)),
          "lpcnet CLI fit: finite steps at B = 32 x 1 s")
    check(not any(fit_counts.values()), f"lpcnet fit launched {fit_counts}")
    text = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(text):
        test_counts = cli_run(
            ["test", *over, "--run_dir", str(out / "lpcnet-t"),
             "--ckpt_path", str(out / "lpcnet" / "ckpt" / "last")],
            VOCODER_CONFIG)
    secs = time.perf_counter() - t0
    print(text.getvalue(), end="")
    result = json.loads(text.getvalue().strip().splitlines()[-1])
    print(f"lpcnet CLI test: {secs:.2f} s for the whole command (data, model, "
          f"restore, teacher-forced metrics, one AR batch of 20 x 1 s, DIO "
          f"on the host); launches {test_counts}")
    check(set(result) == {"avg_loss", "avg_ll", "avg_reg", "avg_lar_l2",
                          "avg_ar_mss", "avg_ar_f0_cents"} and
          all(np.isfinite(v) for v in result.values()),
          "lpcnet CLI test metrics")
    for name, n in test_counts.items():
        want = 1 if name == "allpole_const" else 0
        check(n == want, f"lpcnet test launched {name} {n} times, not "
              f"{want}")
    counts = {name: fit_counts[name] + test_counts[name]
              for name in fit_counts}
    return counts, {"fit_step_ms": [t * 1e3 for t in probe.times],
                    "test_s": secs, "test": result}


def phase_lpcnet() -> tuple:
    """LPCNet end to end: 3 training steps, a step card vs CPU, one
    ``generate`` (and a short one card vs CPU), then fit and test through
    ``main_torch.py`` from a miniature LJSpeech tree. Returns (launches of
    the generate and the CLI, the summary for the ``lpcnet`` line)."""
    summary = {"train": phase_lpcnet_steps(),
               "train_vs_cpu": phase_lpcnet_vs_cpu()}
    gen_counts, summary["generate"] = phase_lpcnet_generate()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_lpc_",
                                     dir="runs") as tmp:
        tree = Path(tmp) / "ljspeech"
        sizes = write_ljspeech_tree(tree)
        print(f"lpcnet: an LJSpeech tree of {sizes} segments of 1 s at "
              f"overlap 0.5")
        cli_counts, summary["cli"] = phase_lpcnet_cli(tree, Path(tmp) / "runs")
    counts = {name: gen_counts[name] + cli_counts[name]
              for name in gen_counts}
    return counts, summary


def phase_pyworld(tree: Path, out: Path) -> tuple:
    """``autoencode_torch.py test --config cfg/ae/pyworld.yaml`` on the VCTK
    tree (its test split at the recipe's 2 s, overlap 0: 16 segments, one
    batch; WORLD on the host, the metrics on the card), with its time; the
    same batch resynthesised once more on the host and scored on the card
    and on the CPU, within 1e-5 relative; then ``predict`` of a tree of two
    test utterances, one wav each. No kernel launches. Returns (launches,
    summary)."""
    over = ["--config", PYWORLD_CONFIG, f"data.init_args.wav_dir={tree}"]
    text = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(text):
        counts = cli_run(["test", *over, "--run_dir", str(out / "pyworld-t")])
    secs = time.perf_counter() - t0
    print(text.getvalue(), end="")
    result = json.loads(text.getvalue().strip().splitlines()[-1])
    print(f"pyworld CLI test: {secs:.2f} s for the whole command (WORLD "
          f"analysis and synthesis on the host, MSS and MCD on the card)")
    check(set(result) == {"avg_mss_loss", "avg_mcd"} and
          all(np.isfinite(v) for v in result.values()),
          "pyworld test metrics")

    cfg = load_config([PYWORLD_CONFIG], None, over[2:])
    dm = instantiate(cfg["data"])
    dm.setup("test")
    x, f0 = next(iter(dm.test_dataloader()))
    card = build_world_autoencoder(cfg["model"]["init_args"], device="cuda")
    cpu = build_world_autoencoder(cfg["model"]["init_args"], device="cpu")
    t0 = time.perf_counter()
    x_hat = card.resynthesize(x, f0)
    host_s = time.perf_counter() - t0
    on_card, on_cpu = card.metrics(x, x_hat), cpu.metrics(x, x_hat)
    rels = {k: abs(on_card[k] - on_cpu[k]) / abs(on_cpu[k])
            for k in ("loss", "mcd")}
    print(f"pyworld: batch {tuple(x.shape)} resynthesised on the host in "
          f"{host_s:.2f} s; metrics card {on_card} vs CPU {on_cpu}: rel "
          f"{rels} (tolerance 1e-5)")
    check(max(rels.values()) <= TEST_REL_TOL, "pyworld metrics card vs CPU")

    two = out / "vctk-two" / "p360"
    two.mkdir(parents=True)
    for k in (1, 2):
        for ext in (".wav", ".pv"):
            name = f"p360_{k:03d}_mic1{ext}"
            shutil.copy(tree / "p360" / name, two / name)
    p_counts = cli_run(["predict", "--config", PYWORLD_CONFIG,
                        f"data.init_args.wav_dir={two.parent}", "--run_dir",
                        str(out / "pyworld-p")])
    wavs = sorted((out / "pyworld-p" / "predictions" / "p360").iterdir())
    ys = [wavfile.read(str(w))[1] for w in wavs]
    print(f"pyworld predict: {[w.name for w in wavs]}, lengths "
          f"{[len(y) for y in ys]}")
    check(len(ys) == 2 and all(len(y) == int(DISK_TEST_SECONDS * SR) and
                               np.isfinite(y).all() for y in ys),
          "pyworld predict: two utterances")
    counts = {name: counts[name] + p_counts[name] for name in counts}
    check(not any(counts.values()), f"pyworld launched {counts}")
    return counts, {"test_s": secs, "test": result,
                    "batch": list(x.shape), "resynthesis_s": host_s,
                    "vs_cpu": rels}


# ---------------------------------------------------------------------------
# phase "options": the encoder's options (bf16, the LRU block, env
# features), GOLF's other LPC parameterisations, the allpass room filters
# and B2 at the shapes they give it
# ---------------------------------------------------------------------------

OPTION_STEPS = 3            # LRU; the allpasses
BF16_STEPS = 4              # bf16 and fp32 in turns (the first is cuDNN's)
PARAM_STEPS = 2             # each parameterisation on each end filter
# golf_tpu's lsp2lpc swaps its P and Q factors at even order, so every
# even-order lsp2lpc filter is unstable (ROADMAP §C): lsp2lpc runs at 21
LSP_ORDER = 21
BF16_PYRAMID_TOL = 0.5      # tests/test_torch_encoder_options.py's bounds
BF16_ABS_TOL = 5e-2
BF16_ABOVE_PARITY = 4e-3    # own bf16-to-fp32 distances held in sum
ALLPASS = ("LTIComplexConjAllpassFilter", "LTIRealCoeffAllpassFilter")


def options_config(decoder: str, encoder: dict = None, end: dict = None,
                   room: str = None) -> dict:
    """``model_config(decoder)`` with encoder options, end filter arguments
    or an allpass room filter (8 roots, golf_tpu's defaults)."""
    cfg = model_config(decoder)
    cfg["encoder_init_args"].update(encoder or {})
    cfg["decoder"]["init_args"]["end_filter"]["init_args"].update(end or {})
    if room is not None:
        cfg["decoder"]["init_args"]["room_filter"] = {
            "class_path": f"models.filters.{room}", "init_args": {}}
    return cfg


def check_exact(label: str, counts: dict, per_step: dict, steps: int
                ) -> None:
    """Each kernel launched exactly ``per_step[name] * steps`` times (0
    for the kernels not named)."""
    for k in DSP_KERNELS:
        want = per_step.get(k.name, 0) * steps
        check(counts[k.name] == want,
              f"{label}: {k.name} launched {counts[k.name]}, not {want}")


FF_STEP = {"lookup": 1, "lookup_dtab": 1, "allpole_const": 1,
           "allpole_const_adjoint": 1}
SS_STEP = {"lookup": 1, "lookup_dtab": 1, "allpole_tv": 1,
           "allpole_tv_adjoint": 1}


def grad_gaps(a: dict, b: dict) -> dict:
    """max|a - b| over max|b|, per gradient."""
    return {n: ((a[n] - ref).abs().max()
                / ref.abs().max().clamp(min=1e-30)).item()
            for n, ref in b.items()}


def phase_options_bf16() -> dict:
    """bf16 against fp32 on GOLF-ff at full width: BF16_STEPS Adam steps
    of each at B = 64 x 2 s in turns (B1, B3b, B2, B2's adjoint once a
    step each); one B = 2 x 1 s training step in bf16 on the card and on the
    CPU and in fp32 on the CPU, the card held to twice the CPU's own
    bf16-to-fp32 distance plus one bf16 step (2^-8), loss and every
    gradient, and within the absolute bounds of the CPU tests (the conv
    pyramid's gradients 0.5 of max-abs, the rest 5e-2); the conv biases in
    front of the train-mode batch norms, zero in exact arithmetic, are
    rounding noise on each side and not held. Summed over the gradients
    whose CPU bf16-to-fp32 distance is at least BF16_ABOVE_PARITY, the
    card's distance from the CPU's bf16 step is at most the CPU's own, and
    its distance from the CPU's fp32 step at least half the CPU's own (the
    loss likewise): the card ran in bf16. Then cuDNN's bf16 LSTM on the
    mirror's weights: its forward and backward time beside the mirror's
    (fp32 cuDNN too), its distance from the mirror and from fp32."""
    dev = torch.device("cuda")
    bf16 = {"compute_dtype": "bfloat16"}
    tasks = {"fp32": seeded_model("golf", dev, options_config("golf")),
             "bf16": seeded_model("golf", dev, options_config("golf", bf16))}
    steps = train_steps(tasks, BF16_STEPS, "options bf16")
    for name, rec in steps.items():
        check_exact(f"bf16 phase {name}", rec["counts"], FF_STEP,
                    BF16_STEPS)

    # one small step: card bf16, CPU bf16, CPU fp32, the same weights
    x, f0 = requests(TRAIN_CHECK_BATCH, TRAIN_CHECK_SECONDS)
    x = x + 0.1 * torch.randn(x.shape,
                              generator=torch.Generator().manual_seed(8))
    noise = torch.randn(x.shape, generator=torch.Generator().manual_seed(7))
    random_f0 = torch.tensor([[90.0], [310.0]])
    base = seeded_model("golf", "cpu", options_config("golf", bf16))
    base.init_running_stats(Sig(x, 1), Sig(f0, 1))
    state = base.state_dict()
    losses, grads = {}, {}
    for label, d, enc in (("card16", dev, bf16), ("cpu16", "cpu", bf16),
                          ("cpu32", "cpu", {})):
        cfg = options_config("golf", {**enc, "dropout": 0.0})
        task = build_voice_autoencoder(cfg, device="cpu")
        task.load_state_dict(state)
        task = task.to(d).train()
        loss, _ = task.training_step(Sig(x.to(d), 1), Sig(f0.to(d), 1),
                                     noise=noise.to(d),
                                     random_f0=random_f0.to(d))
        loss.backward()
        losses[label] = loss.item()
        grads[label] = {n: p.grad.detach().cpu()
                        for n, p in task.named_parameters()
                        if p.requires_grad and not (
                            ".pyramid.convs." in n and n.endswith(".bias"))}
    card = grad_gaps(grads["card16"], grads["cpu16"])
    own = grad_gaps(grads["cpu16"], grads["cpu32"])
    far = grad_gaps(grads["card16"], grads["cpu32"])
    loss_card = abs(losses["card16"] - losses["cpu16"]) / abs(losses["cpu16"])
    loss_own = abs(losses["cpu16"] - losses["cpu32"]) / abs(losses["cpu32"])
    loss_far = abs(losses["card16"] - losses["cpu32"]) / abs(losses["cpu32"])
    ratio = {n: card[n] / (2 * own[n] + 2 ** -8) for n in card}
    worst = max(ratio, key=ratio.get)
    # the gradients where the CPU's own bf16-to-fp32 distance stands well
    # above fp32 parity: summed over them, the card's bf16 step must be
    # nearer the CPU's bf16 step than the CPU's fp32 step is, and as far
    # from the CPU's fp32 step as half the CPU's own distance (a card that
    # ran in fp32 would sit at the fp32 parity of 1e-3 and fail)
    big = [n for n in own if own[n] >= BF16_ABOVE_PARITY]
    sums = {key: sum(d[n] for n in big)
            for key, d in (("card", card), ("own", own), ("far", far))}
    print(f"options bf16: B={TRAIN_CHECK_BATCH} x {TRAIN_CHECK_SECONDS:.0f} "
          f"s step, card vs CPU in bf16: loss {loss_card:.2e} relative (the "
          f"CPU's own bf16 vs fp32 {loss_own:.2e}, the card's bf16 vs the "
          f"CPU's fp32 {loss_far:.2e}); gradient nearest its bound {worst}: "
          f"{card[worst]:.2e} of max-abs against the CPU's own "
          f"{own[worst]:.2e} (bound twice that plus 2^-8); largest card "
          f"distance {max(card.values()):.2e} ({max(card, key=card.get)}); "
          f"over the {len(big)} gradients whose own distance is at least "
          f"{BF16_ABOVE_PARITY:g}, summed: card vs CPU bf16 "
          f"{sums['card']:.3e}, CPU bf16 vs fp32 {sums['own']:.3e}, card "
          f"bf16 vs CPU fp32 {sums['far']:.3e}")
    check(loss_card <= 2 * loss_own + 1e-6, "bf16 loss card vs CPU")
    check(loss_far >= 0.5 * loss_own, "bf16 loss: the card ran in bf16")
    for n in card:
        cap = BF16_PYRAMID_TOL if ".pyramid." in n else BF16_ABS_TOL
        check(card[n] <= 2 * own[n] + 2 ** -8 and card[n] <= cap,
              f"bf16 gradient {n} card vs CPU: {card[n]:.3e}, own "
              f"{own[n]:.3e}")
    check(len(big) > 0 and sums["card"] <= sums["own"],
          "bf16 gradients: the card nearer the CPU's bf16 step than its "
          "fp32 step is")
    check(sums["far"] >= 0.5 * sums["own"],
          "bf16 gradients: the card ran in bf16")
    counts = {name: sum(rec["counts"][name] for rec in steps.values())
              for name in steps["fp32"]["counts"]}
    return counts, {"steps": {k: {kk: v[kk] for kk in ("step_ms", "peak_gib",
                                                "losses")}
                      for k, v in steps.items()},
            "vs_cpu": {"loss_rel": loss_card, "loss_own": loss_own,
                       "loss_far": loss_far, "worst_ratio_name": worst,
                       "worst_ratio": ratio[worst], "sums": sums},
            "cudnn_lstm": cudnn_lstm_finding(tasks["bf16"])}


def cudnn_lstm_finding(task: VoiceAutoEncoder) -> dict:
    """The full-width BiLSTM (3 layers of 256 over the pyramid's 513
    features, B = 64 x 200 frames, dropout off) on the bf16 model's
    weights: the mirror
    of golf_tpu's bf16 LSTM, cuDNN's ``nn.LSTM`` in bf16 (the same weights
    cast) and in fp32; forward plus backward time of each (CUDA events,
    ``cuda_ms``; the loops' launches included), and the outputs'
    distances."""
    # copies without the encoder's dropout: train mode (cuDNN's RNN has no
    # backward in eval mode) and deterministic
    mirror = copy.deepcopy(task.encoder.backbone.lstm).train()
    mirror.lstm.dropout = 0.0
    lstm32 = mirror.lstm
    lstm16 = copy.deepcopy(lstm32).to(torch.bfloat16)
    frames = int(TRAIN_SECONDS * SR) // 240
    x = torch.randn((TRAIN_BATCH, frames, lstm32.input_size),
                    generator=torch.Generator(device="cuda").manual_seed(SEED),
                    device="cuda")
    g = torch.randn((TRAIN_BATCH, frames, 2 * lstm32.hidden_size),
                    generator=torch.Generator(device="cuda").manual_seed(1),
                    device="cuda")

    def fwd_bwd(fn, inp):
        def run():
            xi = inp.detach().requires_grad_(True)
            y = fn(xi)
            y.float().backward(g)
            return y
        return run

    runs = {"mirror": fwd_bwd(mirror, x),
            "cudnn_bf16": fwd_bwd(lambda v: lstm16(v)[0],
                                  x.to(torch.bfloat16)),
            "cudnn_fp32": fwd_bwd(lambda v: lstm32(v)[0], x)}
    with torch.no_grad():
        y_m = mirror(x)
        y16 = lstm16(x.to(torch.bfloat16))[0].float()
        y32 = lstm32(x)[0]
    ms = {k: cuda_ms(fn, 3, strict=False) for k, fn in runs.items()}
    res = {"shape": [TRAIN_BATCH, frames, lstm32.input_size],
           "ms": ms, "cudnn_bf16_vs_mirror": rel_err(y16, y_m),
           "cudnn_bf16_vs_fp32": rel_err(y16, y32),
           "mirror_vs_fp32": rel_err(y_m, y32)}
    print(f"options cuDNN bf16 LSTM {res['shape']}, forward + backward: "
          f"mirror {ms['mirror']:.2f} ms, cuDNN bf16 {ms['cudnn_bf16']:.2f} "
          f"ms, cuDNN fp32 {ms['cudnn_fp32']:.2f} ms; cuDNN bf16 vs the "
          f"mirror {res['cudnn_bf16_vs_mirror']:.3e}, vs fp32 "
          f"{res['cudnn_bf16_vs_fp32']:.3e}, the mirror vs fp32 "
          f"{res['mirror_vs_fp32']:.3e} of max|y| (a finding, not held)")
    return res


def phase_options_lru() -> tuple:
    """GOLF-ss with ``use_lru`` and ``include_env_features`` (encoder
    sample_rate 24000): OPTION_STEPS Adam steps at B = 64 x 2 s (B1, B3b,
    B4, B4's adjoint once a step), then on the trained weights a predict
    of 4 x 6 s (B1 and B4 once) and a stream (look-ahead 24, pushes of
    STREAM_CHUNK). The steps move the zi predictors off their zero
    initialisation, so the stream's first emission predicts each layer's
    carry-in from its newest frame where offline predicts it from the
    utterance's last: the stream departs from offline by design, and the
    departure decays with |lambda|. The card's stream is held to the CPU's
    on the same weights and pushes, and the card's offline rows to the
    CPU's (1e-4 of each leaf's max-abs); the departure is printed for all
    rows and for the second half, and must not grow from the first half to
    the second."""
    dev = torch.device("cuda")
    cfg = options_config("golf-precise", {"use_lru": True,
                                          "include_env_features": True,
                                          "sample_rate": SR})
    task = seeded_model("golf-precise", dev, cfg)
    steps = train_steps({"lru_env": task}, OPTION_STEPS,
                        "options lru")["lru_env"]
    check_exact("lru steps", steps["counts"], SS_STEP, OPTION_STEPS)
    block = task.encoder.backbone.lru_block
    zi_max = max(p.abs().max().item() for n, p in block.named_parameters()
                 if n.startswith("zi_pred_"))
    check(zi_max > 0, "the steps moved the zi predictors off zero")
    x, f0 = requests(BATCH, SECONDS)
    xs, f0s = Sig(x.to(dev), 1), Sig(f0.to(dev), 1)
    task.eval()
    for k in DSP_KERNELS:
        k.launches = 0
    with torch.inference_mode():
        y, predict_s = timed(lambda: task.predict_step(
            xs, f0s, generator=torch.Generator(dev).manual_seed(SEED))[0])
        predict_counts = {k.name: k.launches for k in DSP_KERNELS}
        off = leaves(task.encoder(xs, f0s))
        se = StreamingEncoder(task.encoder, lookahead=STREAM_LOOKAHEAD,
                              batch=BATCH)
        parts, _, _ = stream_encoder(se, xs, f0s)
    check(torch.isfinite(y.data).all().item() and y.shape[0] == BATCH,
          "lru predict finite")
    check_exact("lru predict", predict_counts, {"lookup": 1, "allpole_tv": 1},
                1)
    # the same weights, inputs and pushes on the CPU
    cpu = copy.deepcopy(task.encoder).cpu()
    xc, f0c = Sig(x, 1), Sig(f0, 1)
    t0 = time.perf_counter()
    with torch.inference_mode():
        off_cpu = leaves(cpu(xc, f0c))
        parts_cpu, _, _ = stream_encoder(
            StreamingEncoder(cpu, lookahead=STREAM_LOOKAHEAD, batch=BATCH),
            xc, f0c)
    cpu_s = time.perf_counter() - t0
    got = cat_rows(parts)
    stream_vs_cpu = float(row_errors(got, cat_rows(parts_cpu),
                                     "lru stream").max())
    off_vs_cpu = float(row_errors(off, off_cpu, "lru offline").max())
    rows = row_errors(got, off, "lru stream vs offline")
    rows_cpu = row_errors(cat_rows(parts_cpu), off_cpu, "lru CPU stream")
    m = rows.shape[0]
    n_flushed = next(iter(parts[-1].values())).shape[1]
    print(f"options lru+env: predict 4 x 6 s {predict_s * 1e3:.1f} ms "
          f"(launches {predict_counts}); trained zi predictors (largest "
          f"entry {zi_max:.3e}); stream of {len(parts) - 1} emitting "
          f"pushes and a flush ({n_flushed} rows flushed): card vs CPU "
          f"stream {stream_vs_cpu:.3e}, card vs CPU offline "
          f"{off_vs_cpu:.3e} of each leaf's max-abs (tolerance 1e-4; the "
          f"CPU's encoder, stream and offline, took {cpu_s:.1f} s); the "
          f"stream's departure from offline, card: all {m} rows "
          f"{rows.max():.3e}, first half {rows[:m // 2].max():.3e}, second "
          f"half {rows[m // 2:].max():.3e}, flushed rows "
          f"{rows[m - n_flushed:].max():.3e}; CPU: all rows "
          f"{rows_cpu.max():.3e}, second half {rows_cpu[m // 2:].max():.3e}")
    check(stream_vs_cpu <= 1e-4, "lru stream card vs CPU")
    check(off_vs_cpu <= 1e-4, "lru offline card vs CPU")
    check(rows[m // 2:].max() <= rows[:m // 2].max(),
          "lru stream: the departure from offline does not grow")
    return steps["counts"], {"step_ms": steps["step_ms"],
                             "peak_gib": steps["peak_gib"],
                             "predict_ms": predict_s * 1e3,
                             "stream_vs_cpu": stream_vs_cpu,
                             "offline_vs_cpu": off_vs_cpu,
                             "departure": float(rows.max()),
                             "departure_second_half":
                                 float(rows[m // 2:].max()),
                             "departure_cpu": float(rows_cpu.max())}


def phase_options_params() -> tuple:
    """Each of coef, conj, real and lsp2lpc (order LSP_ORDER) on golf.yaml
    and golf-precise.yaml: PARAM_STEPS Adam steps at B = 64 x 2 s, the
    launches exact (GOLF-ff: B1, B3b, B2 and B2's adjoint once a step;
    GOLF-ss: B1, B3b, B4 and B4's adjoint)."""
    dev = torch.device("cuda")
    counts = {k.name: 0 for k in DSP_KERNELS}
    summary = {}
    for rep in ("coef", "conj", "real", "lsp2lpc"):
        end = {"lpc_parameterisation": rep}
        if rep == "lsp2lpc":
            end["lpc_order"] = LSP_ORDER
        for decoder, per_step in (("golf", FF_STEP),
                                  ("golf-precise", SS_STEP)):
            task = seeded_model(decoder, dev, options_config(decoder, end=end))
            rec = train_steps({f"{rep}/{decoder}": task}, PARAM_STEPS,
                              "options params")[f"{rep}/{decoder}"]
            check_exact(f"{rep} {decoder}", rec["counts"], per_step,
                        PARAM_STEPS)
            for name, v in rec["counts"].items():
                counts[name] += v
            summary[f"{rep}/{decoder}"] = rec["step_ms"]
    return counts, summary


def phase_options_allpass() -> tuple:
    """golf.yaml with each allpass as its room_filter: OPTION_STEPS Adam
    steps at B = 64 x 2 s and a predict of 4 x 6 s. The room filter is
    ``lfilter``, so B2 and its adjoint run twice a step (the end filter's
    windows, then the room filter's rows), B2 twice a predict. Returns
    (launches, summary, the room filter's B2 shapes and B2's and its
    adjoint's launches at those shapes, counted as they ran)."""
    dev = torch.device("cuda")
    counts = {k.name: 0 for k in DSP_KERNELS}
    summary, shapes = {}, {}
    room_launches = {"lfilter_train": 0, "lfilter_train_adjoint": 0,
                     "lfilter_serve": 0}
    x, f0 = requests(BATCH, SECONDS)
    xs, f0s = Sig(x.to(dev), 1), Sig(f0.to(dev), 1)
    fwd, adj = kernels.ALLPOLE_CONST, kernels.ALLPOLE_CONST_ADJ
    for room in ALLPASS:
        task = seeded_model("golf", dev, options_config("golf", room=room))
        fwd.by_shapes.clear()
        adj.by_shapes.clear()
        rec = train_steps({room: task}, OPTION_STEPS,
                          "options allpass")[room]
        check_exact(f"{room} steps", rec["counts"],
                    {**FF_STEP, "allpole_const": 2,
                     "allpole_const_adjoint": 2}, OPTION_STEPS)
        # the room filter's rows: (B, T) with one a of 16 per row; the end
        # filter's windows are the other shape
        train = [sh for sh in fwd.by_shapes if sh[1][1] == 16]
        check(len(train) == 1, f"{room}: one room filter shape in "
              f"training, {list(fwd.by_shapes)}")
        shapes["train"] = train[0]
        room_launches["lfilter_train"] += fwd.by_shapes[train[0]]
        room_launches["lfilter_train_adjoint"] += adj.by_shapes.get(
            train[0], 0)
        task.eval()
        for k in DSP_KERNELS:
            k.launches = 0
        fwd.by_shapes.clear()
        with torch.inference_mode():
            y, secs = timed(lambda: task.predict_step(
                xs, f0s, generator=torch.Generator(dev).manual_seed(SEED))[0])
        serve = [sh for sh in fwd.by_shapes if sh[1][1] == 16]
        check(len(serve) == 1, f"{room}: one room filter shape in predict, "
              f"{list(fwd.by_shapes)}")
        shapes["serve"] = serve[0]
        room_launches["lfilter_serve"] += fwd.by_shapes[serve[0]]
        pc = {k.name: k.launches for k in DSP_KERNELS}
        check_exact(f"{room} predict", pc,
                    {"lookup": 1, "allpole_const": 2}, 1)
        check(torch.isfinite(y.data).all().item(), f"{room} predict finite")
        for c in (rec["counts"], pc):
            for name, v in c.items():
                counts[name] += v
        summary[room] = {"step_ms": rec["step_ms"],
                         "peak_gib": rec["peak_gib"],
                         "predict_ms": secs * 1e3}
        print(f"options {room}: predict 4 x 6 s {secs * 1e3:.1f} ms; the "
              f"room filter's B2 shapes {shapes}")
    want = {"lfilter_train": OPTION_STEPS * len(ALLPASS),
            "lfilter_train_adjoint": OPTION_STEPS * len(ALLPASS),
            "lfilter_serve": len(ALLPASS)}
    print(f"options allpass: B2 launches at the room filters' shapes "
          f"{room_launches}")
    for label, n in want.items():
        check(room_launches[label] == n, f"allpass {label}: "
              f"{room_launches[label]} launches at the room filter's "
              f"shape, not {n}")
    return counts, summary, shapes, room_launches


def b2_row(x: torch.Tensor, a: torch.Tensor, label: str, launches: int,
           f64=None, adjoint: bool = False) -> dict:
    """B2 (or, for ``adjoint``, its adjoint entry on the cotangent x) at one
    shape: against its plain version (tolerance 1e-5 of max|y|, 1e-4 for
    the adjoint's dx and da, as at the training shape) and a float64
    reference ``f64`` (y; for the adjoint a function of the forward's y
    that returns (dx, da)) within 1e-6, its time, the plain version's and
    the byte bound."""
    n, t = x.shape
    p = a.shape[1]
    if not adjoint:
        out = allpole_const_cuda(x, a)
        err = rel_err(out, allpole_const_plain(x, a))
        err64 = rel_err(out, f64)
        check(err <= 1e-5 and err64 <= 1e-6 and
              torch.isfinite(out).all().item(), f"B2 {label}")
        ms = cuda_ms(lambda: allpole_const_cuda(x, a), 5)
        plain_ms = cuda_ms(lambda: allpole_const_plain(x, a), 2,
                           strict=False)
        bnd = bound(4 * (2 * n * t + n * p), 2 * p * n * t, fp64=True)
    else:
        g, y = x, allpole_const_cuda(x, a)
        dx, da = allpole_const_adjoint_cuda(g, y, a)
        dxp, dap = allpole_const_adjoint_plain(g, y, a)
        dx64, da64 = f64(y)
        err = max(rel_err(dx, dxp), rel_err(da, dap))
        err64 = max(rel_err(dx, dx64), rel_err(da, da64))
        check(err <= 1e-4 and err64 <= 1e-6, f"B2 adjoint {label}")
        ms = cuda_ms(lambda: allpole_const_adjoint_cuda(g, y, a), 5)
        plain_ms = cuda_ms(lambda: allpole_const_adjoint_plain(g, y, a), 2,
                           strict=False)
        bnd = bound(4 * (3 * n * t + 2 * n * p), 4 * p * n * t, fp64=True)
    row = {"shapes": [[n, t], [n, p]], "launches": launches,
           "max_abs_err": err, "err_vs_f64": err64, "ms": ms,
           "plain_ms": plain_ms, "bound_ms": bnd[0], "bound_by": bnd[1],
           "library_ms": None}
    print(f"B2{' adjoint' if adjoint else ''} at {label} ({n}, {t}) p={p}: "
          f"{ms * 1e3:.1f} us, bound {bnd[0] * 1e3:.2f} us ({bnd[1]}), plain "
          f"{plain_ms * 1e3:.1f} us; {err:.2e} from plain, {err64:.2e} from "
          f"float64; {launches} launches in phase options")
    return row


def lfilter64(x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """The all-pole part of ``lfilter`` in float64 on the host (scipy):
    x (N, T) and one a (p,) shared by the rows."""
    from scipy.signal import lfilter as sp_lfilter
    den = np.concatenate([[1.0], a.double().cpu().numpy()])
    return torch.from_numpy(sp_lfilter([1.0], den,
                                       x.double().cpu().numpy(), axis=-1))


def phase_options_kernels(shapes: dict, room_launches: dict) -> dict:
    """B2 at the options' new shapes, each against its plain version and a
    float64 reference: ``lfilter``'s all-pole part at the allpass room
    filter's training rows (forward and adjoint) and serving rows, p = 16,
    the coefficients of a seeded ``LTIComplexConjAllpassFilter``; one
    section of ``BatchSecondOrderLPCSynth`` at GOLF-ff's windows (12800,
    960), p = 2 (the float64 mirror ``allpole_const_scan64``), with the
    launches of one cascade call of 11 sections."""
    from golf_tpu_torch.models.filters import LTIComplexConjAllpassFilter
    from golf_tpu_torch.models.lpc import BatchSecondOrderLPCSynth
    from golf_tpu_torch.ops.dsp import coeff_product, complex2biquads
    dev = torch.device("cuda")
    torch.manual_seed(SEED)
    ap = LTIComplexConjAllpassFilter()
    with torch.no_grad():
        mag = torch.sigmoid(ap.magnitude_logits[0]) * ap.max_abs_value
        cos = torch.tanh(ap.cos_logits[0])
        roots = torch.complex(mag * cos, mag * torch.sqrt(1 - cos ** 2))
        a_full = coeff_product(complex2biquads(roots)[:, None, :])[0]
    a16 = (a_full[1:] / a_full[0]).to(dev)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = {}
    for label, (x_shape, _) in (("lfilter_train", shapes["train"]),
                                ("lfilter_serve", shapes["serve"])):
        x = torch.randn(x_shape, generator=gen, device="cuda")
        a = a16.expand(x_shape[0], 16).contiguous()
        rows[label] = b2_row(x, a, label, room_launches[label],
                             lfilter64(x, a16).to(dev))
        if label == "lfilter_train":
            # the cotangent x: dx is the filter run backwards in time, and
            # da[j] = -sum_s y[s] dx[s + 1 + j]
            dx64 = torch.flip(lfilter64(torch.flip(x, (1,)), a16), (1,))

            def adjoint64(y, dx64=dx64):
                yd = y.double().cpu()
                t = yd.shape[1]
                da = -torch.stack([(yd[:, :t - 1 - j] * dx64[:, 1 + j:])
                                   .sum(1) for j in range(16)], -1)
                return dx64.to(dev), da.to(dev)
            rows["lfilter_train_adjoint"] = b2_row(
                x, a, label, room_launches["lfilter_train_adjoint"],
                adjoint64, adjoint=True)
    n_ff = main_path_shapes(TRAIN_BATCH, int(TRAIN_SECONDS * SR))[
        "allpole_const"][0][0]
    p2 = torch.tanh(0.5 * torch.randn((2, n_ff), generator=gen,
                                      device="cuda")) * 0.9
    a2 = torch.stack([2 * p2[0], 0.5 * ((2 - 2 * p2[0].abs()) * p2[1]
                                        + 2 * p2[0].abs())], -1)
    x = torch.randn((n_ff, 960), generator=gen, device="cuda")
    # the cascade's launches: one call at GOLF-ff's frames, 11 sections
    frames = n_ff // TRAIN_BATCH
    synth = BatchSecondOrderLPCSynth(240, 960).to(dev)
    bi = torch.cat([torch.ones((TRAIN_BATCH, frames, 11, 1), device=dev),
                    a2.reshape(TRAIN_BATCH, frames, 1, 2).expand(
                        -1, -1, 11, -1)], -1)
    for k in DSP_KERNELS:
        k.launches = 0
    with torch.inference_mode():
        y = synth(torch.randn((TRAIN_BATCH, frames * 240), generator=gen,
                              device="cuda"),
                  torch.ones((TRAIN_BATCH, frames), device=dev), bi)
    check(torch.isfinite(y).all().item() and
          kernels.ALLPOLE_CONST.launches == 11 and
          kernels.ALLPOLE_CONST.last_shapes == ((n_ff, 960), (n_ff, 2)),
          f"cascade: 11 launches of B2 at ({n_ff}, 960) x ({n_ff}, 2), "
          f"{kernels.ALLPOLE_CONST.launches} at "
          f"{kernels.ALLPOLE_CONST.last_shapes}")
    rows["cascade_p2"] = b2_row(x, a2.contiguous(), "cascade_p2",
                                kernels.ALLPOLE_CONST.launches,
                                allpole_const_scan64(x, a2.contiguous()))
    return rows


def phase_options() -> tuple:
    """The encoder's options, the parameterisations, the allpass room
    filters and B2 at their shapes. Returns (launches, summary, B2's
    rows)."""
    counts = {k.name: 0 for k in DSP_KERNELS}
    summary = {}

    def add(c):
        for name, v in c.items():
            counts[name] += v

    bf16_counts, summary["bf16"] = phase_options_bf16()
    add(bf16_counts)
    lru_counts, summary["lru_env"] = phase_options_lru()
    add(lru_counts)
    param_counts, summary["params_step_ms"] = phase_options_params()
    add(param_counts)
    ap_counts, summary["allpass"], shapes, room_launches = \
        phase_options_allpass()
    add(ap_counts)
    rows = phase_options_kernels(shapes, room_launches)
    print(json.dumps({"options": summary}))
    return counts, summary, rows


# ---------------------------------------------------------------------------
# phase "variants": four more encoder backbones, the inverse
# (excitation-domain) mode, the decoder modules no shipped config names,
# and B1, B3a and B3b at the weighted wavetables' shapes
# ---------------------------------------------------------------------------

BACKBONES = ("models.mel.X2Control", "models.enc.F0EnergyEncoder",
             "models.unet.UNetEncoderV2", "models.unet.TransformerEncoder")
VARIANT_STEPS = 2
# golf.yaml's LF table arguments
_LF = {k: _HARM["init_args"][k] for k in (
    "table_type", "normalize_method", "align_peak", "trainable", "min_R_d",
    "max_R_d", "lf_v2", "points")}
# GOLF-ff's decoder with one module swapped: (slot, config node)
VARIANTS = {
    "DownsampledWeightedGlottalFlowTable": ("harm_oscillator", {
        "class_path": "models.synth.DownsampledWeightedGlottalFlowTable",
        "init_args": {"hop_rate": 10, "in_channels": 64, "table_size": 100,
                      **_LF}}),
    "WeightedGlottalFlowTable": ("harm_oscillator", {
        "class_path": "models.synth.WeightedGlottalFlowTable",
        "init_args": {"table_size": 100, **_LF}}),
    "UniformNoise": ("noise_generator", {
        "class_path": "models.noise.UniformNoise"}),
    "SignFlipNoise": ("noise_generator", {
        "class_path": "models.noise.SignFlipNoise"}),
    "NoiseBand": ("noise_generator", {
        "class_path": "models.noise.NoiseBand", "init_args": {"fs": 24000}}),
    "LTVPQMF": ("noise_filter", {
        "class_path": "models.filters.LTVPQMF",
        "init_args": {"n_mag": 16, "filter_order": 127}}),
}
# the weighted tables' lookup shapes at training (B = 64 x 2 s) and
# serving (B = 4 x 6 s): (ph, tables)
WEIGHTED_SHAPES = {
    "DownsampledWeightedGlottalFlowTable": {
        "train": ((64, 20, 2400), (64, 21, 2048)),
        "serve": ((4, 60, 2400), (4, 61, 2048))},
    "WeightedGlottalFlowTable": {
        "train": ((64, 200, 240), (64, 201, 2048)),
        "serve": ((4, 600, 240), (4, 601, 2048))},
}
WEIGHTED_KEYS = {"DownsampledWeightedGlottalFlowTable": "weighted_ds",
                 "WeightedGlottalFlowTable": "weighted"}
# B1, B3a and B3b at the new shapes, of max|ref| of their plain versions
WEIGHTED_LOOKUP_TOL = 2e-6


def backbone_config(backbone: str) -> dict:
    """``model_config("golf")`` with the vctk encoder's arguments on
    another backbone (each takes those its signature names)."""
    cfg = model_config("golf")
    cfg["encoder_init_args"]["backbone_type"] = backbone
    return cfg


def variant_config(name: str) -> dict:
    cfg = model_config("golf")
    slot, node = VARIANTS[name]
    cfg["decoder"]["init_args"][slot] = copy.deepcopy(node)
    return cfg


def variant_noise(name: str):
    """The noise generator's field for a card-vs-CPU step, from the
    batch's shape: uniform [0, 1), one uniform [-1, 1) a sequence, the
    noise bands' offsets, else standard normal."""
    if name == "UniformNoise":
        return lambda shape, generator: torch.rand(shape, generator=generator)
    if name == "SignFlipNoise":
        return lambda shape, generator: torch.rand(
            shape[:1], generator=generator) * 2 - 1
    if name == "NoiseBand":
        return lambda shape, generator: torch.randint(
            0, 32768, (shape[0], 1024), generator=generator)
    return None


def phase_variants_encoders(tree: Path, out: Path) -> tuple:
    """Each backbone through ``autoencode_torch.py fit --config
    cfg/ae/vctk.yaml --model cfg/ae/decoder/golf.yaml
    model.init_args.encoder_init_args.backbone_type=<class>`` from the VCTK
    tree, DISK_STEPS steps at B = 64 x 2 s (B1, B3b, B2 and B2's adjoint
    once a step, B3a never), with the run's peak memory; one B = 2 x 1 s
    step card vs CPU. Returns (launches, summary)."""
    counts = {k.name: 0 for k in DSP_KERNELS}
    summary = {}
    for backbone in BACKBONES:
        name = backbone.rsplit(".", 1)[1]
        argv = ["fit", *disk_args(tree, "cfg/ae/decoder/golf.yaml",
                                  out / name),
                f"model.init_args.encoder_init_args.backbone_type={backbone}",
                f"trainer.max_steps={DISK_STEPS}"]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with StepProbe() as probe:
            c = cli_run(argv)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        probe.check_steps(f"variants fit {name}", FF_STEP,
                          absent=("lookup_res",))
        print(f"variants fit {name}: peak memory over the run {peak:.2f} "
              f"GiB")
        for k, v in c.items():
            counts[k] += v
        summary[name] = {"step_ms": [t * 1e3 for t in probe.times],
                         "peak_gib": peak,
                         "vs_cpu": phase_train_vs_cpu(
                             "golf", cfg=backbone_config(backbone))}
        if name == "UNetEncoderV2":
            summary[name]["mask_flips"] = harmonic_mask_flips()
    return counts, summary


def harmonic_mask_flips() -> dict:
    """``UNetEncoderV2``'s harmonic mask on the card and on the CPU from
    the training batch's f0 (B = 64 x 2 s at hop 240): the entries that
    differ (a bin on the 0.25 or 0.75 edge of a harmonic can flip)."""
    from golf_tpu_torch.models.unet import UNetEncoderV2
    enc = UNetEncoderV2(1, hop_length=240)
    _, f0 = requests(TRAIN_BATCH, TRAIN_SECONDS)
    f0_d = Sig(f0, 1).set_hop_length(240).data
    n_freq = enc.n_fft // 2 + 1
    card = enc.harmonic_mask(n_freq, f0_d.cuda()).cpu()
    cpu = enc.harmonic_mask(n_freq, f0_d)
    flips = {"differ": int((card != cpu).sum()), "of": cpu.numel()}
    print(f"variants UNetEncoderV2: harmonic mask card vs CPU on "
          f"{tuple(cpu.shape)}: {flips['differ']} of {flips['of']} entries "
          f"differ")
    return flips


def phase_variants_inverse(tree: Path, out: Path) -> tuple:
    """The ISMIR23 vocoder in the excitation domain:
    ``main_torch.py fit --model cfg/ae/decoder/golf.yaml
    model.init_args.inverse_target=true`` from the MPop600 tree, DISK_STEPS
    steps at B = 64 x 2 s (B1 and B3b once a step at (64, 20, 9600) x
    (64, 21, 2048): the detached f0's phase needs no gradient; no all-pole
    kernel: the end filter runs its inverse FIR, the room filter not at
    all), then ``predict`` of that checkpoint on Synthetic data (the
    forward decoder: B1 and B2), and one B = 2 x 1 s step card vs CPU.
    Returns (launches, summary)."""
    over = [f"data.init_args.wav_dir={tree}",
            "model.init_args.inverse_target=true"]
    argv = ["fit", "--model", "cfg/ae/decoder/golf.yaml", *over,
            "--run_dir", str(out / "inverse"), f"trainer.max_steps={DISK_STEPS}"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in DSP_KERNELS:
        k.by_shapes.clear()
    with StepProbe() as probe:
        counts = cli_run(argv, VOCODER_CONFIG)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    probe.check_steps("variants inverse fit", ("lookup", "lookup_dtab"),
                      absent=("lookup_res", "allpole_const",
                              "allpole_const_adjoint", "allpole_tv",
                              "allpole_tv_adjoint"))
    # the training steps' shapes (the validation's batches are smaller)
    lookup = ((TRAIN_BATCH, 20, 9600), (TRAIN_BATCH, 21, 2048))
    for k in (kernels.LOOKUP, kernels.LOOKUP_DTAB):
        check(k.by_shapes.get(lookup, 0) == DISK_STEPS,
              f"variants inverse fit: {k.name} at {lookup} "
              f"{k.by_shapes.get(lookup, 0)} times")
    ckpt = out / "inverse" / "ckpt" / "last"
    check(ckpt.exists(), "inverse-mode checkpoint written")
    pred_dir = out / "inverse_predict"
    pred_counts = cli_run(
        ["predict", "--model", "cfg/ae/decoder/golf.yaml",
         "model.init_args.inverse_target=true",
         "data.class_path=ltng.data.Synthetic", "data.init_args.n_items=64",
         "--ckpt_path", str(ckpt), "--run_dir", str(pred_dir)],
        VOCODER_CONFIG)
    wavs = sorted((pred_dir / "predictions").glob("*.wav"))
    ys = [wavfile.read(str(w))[1] for w in wavs]
    print(f"variants inverse: fit peak memory {peak:.2f} GiB; predict of "
          f"its checkpoint wrote {len(wavs)} wavs; launches {pred_counts}")
    check(len(wavs) == 8 and all(np.isfinite(y).all() for y in ys),
          "inverse-mode checkpoint predicts finite audio")
    check(pred_counts["lookup"] >= 1 and pred_counts["allpole_const"] >= 1,
          "the forward decoder ran B1 and B2 in predict")
    for k, v in pred_counts.items():
        counts[k] += v
    summary = {"fit_step_ms": [t * 1e3 for t in probe.times],
               "fit_peak_gib": peak,
               "vs_cpu": phase_vocoder_train_vs_cpu(
                   "golf", {**vocoder_cfg("golf"), "inverse_target": True})}
    return counts, summary


def phase_variants_decoders() -> tuple:
    """GOLF-ff with each module of VARIANTS swapped in, at full width:
    VARIANT_STEPS Adam steps at B = 64 x 2 s (B1, B3b, B2 and B2's adjoint
    exactly once a step; for the weighted tables at their own shapes,
    counted by shape), a 4 x 6 s predict (B1 and B2 once), and one
    B = 2 x 1 s step card vs CPU. Returns (launches, summary, the weighted
    tables' launches by shape)."""
    dev = torch.device("cuda")
    counts = {k.name: 0 for k in DSP_KERNELS}
    summary = {}
    by_shape = {}
    x, f0 = requests(BATCH, SECONDS)
    xs, f0s = Sig(x.to(dev), 1), Sig(f0.to(dev), 1)
    for name in VARIANTS:
        task = seeded_model("golf", dev, variant_config(name))
        if name == "NoiseBand":
            # variant_noise draws offsets in [0, 32768)
            check(task.decoder.noise_generator.bands.shape == (1024, 32768),
                  "the noise bands at fs 24000")
        for k in DSP_KERNELS:
            k.by_shapes.clear()
        rec = train_steps({name: task}, VARIANT_STEPS, "variants")[name]
        check_exact(f"variants {name} steps", rec["counts"], FF_STEP,
                    VARIANT_STEPS)
        task.eval()
        for k in DSP_KERNELS:
            k.launches = 0
        with torch.inference_mode():
            task.predict_step(xs, f0s,
                              generator=torch.Generator(dev).manual_seed(SEED))
            y, secs = timed(lambda: task.predict_step(
                xs, f0s, generator=torch.Generator(dev).manual_seed(SEED))[0])
        pc = {k.name: k.launches for k in DSP_KERNELS}
        check_exact(f"variants {name} predict", pc,
                    {"lookup": 1, "allpole_const": 1}, 2)
        check(torch.isfinite(y.data).all().item() and
              y.shape[1] > 0.99 * SECONDS * SR, f"variants {name} predict")
        if name in WEIGHTED_SHAPES:
            want = WEIGHTED_SHAPES[name]
            got = {"lookup": kernels.LOOKUP.by_shapes.get(want["train"], 0),
                   "lookup_dtab": kernels.LOOKUP_DTAB.by_shapes.get(
                       want["train"], 0),
                   "lookup_serve": kernels.LOOKUP.by_shapes.get(
                       want["serve"], 0)}
            print(f"variants {name}: launches at {want}: {got}")
            check(got == {"lookup": VARIANT_STEPS,
                          "lookup_dtab": VARIANT_STEPS,
                          "lookup_serve": 2},
                  f"variants {name}: the lookups ran at the weighted shapes")
            by_shape[name] = got
        for c in (rec["counts"], pc):
            for k, v in c.items():
                counts[k] += v
        print(f"variants {name}: predict 4 x 6 s {secs * 1e3:.1f} ms "
              f"(after a first call)")
        summary[name] = {"step_ms": rec["step_ms"],
                         "peak_gib": rec["peak_gib"],
                         "predict_ms": secs * 1e3,
                         "vs_cpu": phase_train_vs_cpu(
                             "golf", cfg=variant_config(name),
                             noise_fn=variant_noise(name))}
        del task
        torch.cuda.empty_cache()
    return counts, summary, by_shape


def phase_variants_wrapped() -> tuple:
    """``WrappedPhaseDownsampledIndexedGlottalFlowTable`` (golf.yaml's LF
    arguments, 100 tables of 2048 points) on (4, 144 000) wrapped phase and
    (4, 601, 64) hidden frames at hop 240: B1 once, at (4, 60, 2400) x
    (4, 61, 2048); card vs the CPU's plain lookup within 1e-5 of max|y|.
    Returns (launches, summary)."""
    from golf_tpu_torch.models.synth import \
        WrappedPhaseDownsampledIndexedGlottalFlowTable as Wrapped
    dev = torch.device("cuda")
    torch.manual_seed(SEED)
    cpu = Wrapped(hop_rate=10, in_channels=64, table_size=100, **_LF)
    card = copy.deepcopy(cpu).to(dev)
    gen = torch.Generator().manual_seed(SEED + 5)
    t = int(SECONDS * SR)
    f0 = 120.0 + 100.0 * torch.rand((BATCH, 1), generator=gen)
    wrapped = torch.remainder(torch.cumsum(
        (f0 / SR).double().expand(BATCH, t), dim=1), 1).float()
    h = torch.randn((BATCH, t // 240 + 1, 64), generator=gen)
    with torch.inference_mode():
        ctrl = card.ctrl(Sig(h.to(dev), 240))
        for k in DSP_KERNELS:
            k.launches = 0
        y, secs = timed(lambda: card(Sig(wrapped.to(dev), 1), *ctrl))
        counts = {k.name: k.launches for k in DSP_KERNELS}
        shapes = kernels.LOOKUP.last_shapes
        ref = cpu(Sig(wrapped, 1), *cpu.ctrl(Sig(h, 240))).data
    rel = ((y.data.cpu() - ref).abs().max() / ref.abs().max()).item()
    print(f"variants wrapped-phase table: out {tuple(y.shape)}, "
          f"{secs * 1e3:.2f} ms, launches {counts} at {shapes}; card vs CPU "
          f"{rel:.2e} of max|y| (tolerance 1e-5)")
    check(counts == {**{k.name: 0 for k in DSP_KERNELS}, "lookup": 1} and
          shapes == ((BATCH, 60, 2400), (BATCH, 61, 2048)),
          "wrapped-phase table launched B1 once at its shape")
    check(rel <= 1e-5 and torch.isfinite(y.data).all().item(),
          "wrapped-phase table card vs CPU")
    return counts, {"ms": secs * 1e3, "vs_cpu": rel}


def weighted_lookup_rows(name: str, launches: dict) -> dict:
    """B1, B3a and B3b at a weighted table's training shape against their
    plain versions (``phase_kernels``; each within 2e-6 of max|ref|), with
    times, bounds and the library's; ``launches`` at that shape in phase
    variants (B3a none: the phase of the true f0 needs no gradient)."""
    ph_shape, tab_shape = WEIGHTED_SHAPES[name]["train"]
    rows = phase_kernels({"lookup": (ph_shape, tab_shape)},
                         ("lookup", "lookup_res", "lookup_dtab"),
                         label=WEIGHTED_KEYS[name])
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    ph, tables, hop = lookup_inputs(gen, {"lookup": (ph_shape, tab_shape)})
    ref = lk.lookup_blocks_plain(ph, tables, hop).abs().max().item()
    g = torch.randn(ph.shape, generator=gen, device="cuda")
    dref = lk.lookup_dtab_plain(ph, g, hop, *tab_shape[1:]).abs().max().item()
    out = {}
    for kname, scale in (("lookup", ref), ("lookup_res", ref),
                         ("lookup_dtab", dref)):
        r = rows[kname]
        rel = r["err"] / scale
        check(rel <= WEIGHTED_LOOKUP_TOL, f"{kname} at {name}'s shape: "
              f"{rel:.2e} of max|ref|")
        out[kname] = {
            "shapes": [list(ph_shape), list(tab_shape)],
            "launches": launches.get(kname, 0), "max_abs_err": r["err"],
            "rel_err": rel, "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
            "library_ms": (r.get("library_ms") if kname == "lookup" else
                           rows["lookup"].get("dtab_library_ms")
                           if kname == "lookup_dtab" else None)}
        if "split" in r:
            out[kname]["split"] = r["split"]
        lib = out[kname]["library_ms"]
        print(f"{kname} at {name}'s shape {out[kname]['shapes']}: "
              f"{r['ms'] * 1e3:.2f} us, bound {r['bound'][0] * 1e3:.2f} us, "
              f"plain {r['plain_ms'] * 1e3:.1f} us, library "
              f"{'null' if lib is None else f'{lib * 1e3:.1f} us'}, "
              f"{rel:.2e} of max|ref|, {out[kname]['launches']} launches")
    return out


def phase_variants() -> tuple:
    """The four backbones, the inverse mode, the decoder variants, the
    wrapped-phase table and the lookups at the weighted tables' shapes.
    Returns (launches, summary, {name: {kernel: row}})."""
    counts = {k.name: 0 for k in DSP_KERNELS}
    summary = {}

    def add(c):
        for name, v in c.items():
            counts[name] += v

    Path("runs").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_var_",
                                     dir="runs") as tmp:
        vctk, mpop, out = (Path(tmp) / "vctk", Path(tmp) / "mpop600",
                           Path(tmp) / "runs")
        write_vctk_tree(vctk)
        write_mpop_tree(mpop)
        c, summary["encoders"] = phase_variants_encoders(vctk, out)
        add(c)
        c, summary["inverse"] = phase_variants_inverse(mpop, out)
        add(c)
    c, summary["decoders"], by_shape = phase_variants_decoders()
    add(c)
    c, summary["wrapped_phase"] = phase_variants_wrapped()
    add(c)
    rows = {WEIGHTED_KEYS[name]: weighted_lookup_rows(name, launches)
            for name, launches in by_shape.items()}
    print(json.dumps({"variants": summary}))
    return counts, summary, rows


# ---------------------------------------------------------------------------
# phase "tools": the host libraries, the real-time factor, the evaluation
# tools, the pitch tools and the set-prediction modules
# ---------------------------------------------------------------------------

TOOLS_SECONDS = 6.0          # test_rtf.py's clip
TOOLS_NUM = 10               # its timed runs
SERVE_TOL = 1e-3             # served audio card vs CPU, of max|y| (PERF.md §2)
BIQUAD_TOL = 1e-4            # biquads_torch's arrays card vs CPU, relative
PENN_AGREE = 0.99            # penn's frames voiced alike on card and CPU
EMBED_TOL = 1e-4             # FAD embeddings card vs CPU, of max-abs
LOSS_TOL = 1e-4              # a model's loss card vs CPU, relative
MODEL_SECONDS = 2.0          # CREPE's batch: B = 64 x 2 s
MODEL_BATCH = 64
TSPN_TOKENS = 10             # TopNGenerator's default top_n
RTF_PATH = {"golf": {"lookup": 1, "allpole_const": 1},
            "golf-precise": {"lookup": 1, "allpole_tv": 1}}


def _script(name: str, folder: str = "scripts"):
    """A module of ``scripts/`` (or ``folder``) by file name."""
    import importlib.util
    path = Path(__file__).resolve().parent / folder / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def zero_counts() -> None:
    for k in DSP_KERNELS:
        k.launches = 0


def read_counts() -> dict:
    return {k.name: k.launches for k in DSP_KERNELS}


def tools_build() -> dict:
    """The two host libraries from ``native/*.cpp`` into
    ``golf_tpu_torch/kernels/build/``; the PESQ label that will run."""
    t0 = time.perf_counter()
    libs = {src: native.build_host_library(src)
            for src in ("worldlite.cpp", "pesq862.cpp")}
    seconds = time.perf_counter() - t0
    for src, lib in libs.items():
        check(lib.exists() and lib.parent == kernels.BUILD,
              f"native/{src} built into {kernels.BUILD}")
    pesq862.library()
    label = eval_pesq_torch.label()
    print(f"tools: host libraries built in {seconds:.1f} s: "
          f"{', '.join(p.name for p in libs.values())}; PESQ label "
          f"{label}")
    check(label == ("PESQ" if eval_pesq_torch.HAS_PESQ
                    else "PESQ(p862-native)"), f"PESQ label {label}")
    return {"build_s": seconds, "pesq_label": label}


def tools_rtf(decoder: str, shapes: dict) -> tuple:
    """``test_rtf_torch.measure`` on the full-width vctk model with
    ``decoder``, seeded weights, a 6 s clip, 10 timed runs; the kernels'
    launches from 0 over it; the synthesis card vs CPU on the same noise."""
    dev = torch.device("cuda")
    task = seeded_model(decoder, dev).eval()
    x_np, f0_np = test_rtf_torch.clip(SR, TOOLS_SECONDS)
    zero_counts()
    res = test_rtf_torch.measure(task, x_np, f0_np, SR, TOOLS_NUM)
    counts = read_counts()
    print(f"rtf {decoder} (vctk, seeded weights, {TOOLS_SECONDS:.0f} s, "
          f"--num {TOOLS_NUM}):")
    test_rtf_torch.report(res)
    per = RTF_PATH[decoder]
    check(res["launches_per_synthesis"] == per,
          f"rtf {decoder}: launches per synthesis "
          f"{res['launches_per_synthesis']} == {per}")
    # one counted synthesis, one warm-up, TOOLS_NUM timed
    for k in DSP_KERNELS:
        want = per.get(k.name, 0) * (TOOLS_NUM + 2)
        check(counts[k.name] == want,
              f"rtf {decoder}: {k.name} launched {counts[k.name]}, not "
              f"{want}")
        if k.name in per:
            check(k.last_shapes == shapes[k.name],
                  f"rtf {decoder}: {k.name} shapes {k.last_shapes} == "
                  f"{shapes[k.name]}")

    cpu_task = seeded_model(decoder, "cpu")
    cpu_task.load_state_dict({k: v.cpu() for k, v in
                              task.state_dict().items()})
    cpu_task.eval()
    ys = []
    for t in (task, cpu_task):
        d = next(t.parameters()).device
        xs = Sig(torch.from_numpy(x_np).to(d), 1)
        f0s = Sig(torch.from_numpy(f0_np).to(d), 1)
        raw = {k: v for k, v in test_rtf_torch.analysis(t, xs, f0s).items()
               if k.endswith("_params")}
        if not ys:
            noise = torch.randn(x_np.shape,
                                generator=torch.Generator().manual_seed(7))
        ys.append(test_rtf_torch.synthesis(
            t, raw, t.cycles(f0s), noise=noise.to(d)).data.cpu())
    rel = rel_err(ys[0], ys[1])
    print(f"rtf {decoder}: synthesis of the 6 s clip, card vs CPU: max err "
          f"/ max|y| {rel:.3e} (tolerance {SERVE_TOL:g}, serving's)")
    check(torch.isfinite(ys[0]).all().item() and rel <= SERVE_TOL,
          f"rtf {decoder} card vs CPU")
    res["vs_cpu"] = rel
    return counts, res


def tools_harm_noise(tree: Path, out: Path) -> tuple:
    """``harm_and_noise_torch`` on the VCTK tree's test split with the
    seeded golf.yaml model: B1 once a chunk, B2 twice (the end filter on
    each branch); each written wav against the CPU's run on the same
    weights and noise."""
    dev = torch.device("cuda")
    task = seeded_model("golf", dev).eval()
    zero_counts()
    t0 = time.perf_counter()
    rels = t_hn.run(task, SR, str(tree), str(out))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_counts()
    ds = InferenceDataset(str(tree), "test")
    chunk, fade = int(6.0 * SR), int(1.0 * SR)
    n_chunks = sum(max(1, (max(len(ds[i][0]) - chunk, 0) + chunk - fade - 1)
                       // (chunk - fade) + 1) for i in range(len(ds)))
    want = {"lookup": n_chunks, "allpole_const": 2 * n_chunks}
    print(f"harm_and_noise: {len(rels)} files, {n_chunks} chunks of 6 s in "
          f"{seconds:.2f} s, launches {counts}")
    check(len(rels) == len(ds) == 2 * len(DISK_TEST),
          f"harm_and_noise wrote {len(rels)} files")
    check_exact("harm_and_noise", counts, want, 1)

    cpu_task = seeded_model("golf", "cpu")
    cpu_task.load_state_dict({k: v.cpu() for k, v in
                              task.state_dict().items()})
    cpu_task.eval()
    noise = t_hn.noise_field(cpu_task, chunk, "cpu")
    worst = 0.0
    for i in range(len(ds)):
        x, f0, rel = ds[i]
        ref = t_hn.utterance(cpu_task, x, f0, chunk, fade, noise)
        for branch, r in zip(("harm", "noise"), ref):
            got, sr = read_wav(str(out / branch / rel))
            r = np.clip(r, -1.0, 1.0).astype(np.float32)
            check(sr == SR and got.shape == r.shape and np.isfinite(got).all(),
                  f"harm_and_noise {branch}/{rel}")
            worst = max(worst, float(np.abs(got - r).max()
                                     / np.abs(r).max()))
    print(f"harm_and_noise: every harm and noise wav, card vs CPU: max err "
          f"/ max|y| {worst:.3e} (tolerance {SERVE_TOL:g})")
    check(worst <= SERVE_TOL, "harm_and_noise card vs CPU")
    return counts, {"files": len(rels), "chunks": n_chunks, "s": seconds,
                    "vs_cpu": worst}


def tools_pesq(tree: Path, harm_dir: Path) -> dict:
    """``eval_pesq_torch`` of the test split against its harmonic
    resynthesis, resampled on the card and on the CPU."""
    t0 = time.perf_counter()
    scores = eval_pesq_torch.evaluate(tree, harm_dir, device="cuda")
    seconds = time.perf_counter() - t0
    cpu = eval_pesq_torch.evaluate(tree, harm_dir, device="cpu")
    gap = float(np.abs(scores - cpu).max())
    print(f"{eval_pesq_torch.label()}: {scores.mean():.3f} +/- "
          f"{scores.std():.3f} (n={len(scores)}) in {seconds:.2f} s; card "
          f"vs CPU resampling: max score gap {gap:.2e} (tolerance 1e-6)")
    check(len(scores) == 2 * len(DISK_TEST) and np.isfinite(scores).all()
          and ((scores > 0.5) & (scores < 5.0)).all(), "PESQ scores")
    check(gap <= 1e-6, "PESQ card vs CPU")
    return {"label": eval_pesq_torch.label(), "mean": float(scores.mean()),
            "std": float(scores.std()), "n": len(scores), "s": seconds,
            "vs_cpu": gap}


def tools_biquads(tree: Path, out: Path) -> dict:
    """``biquads_torch`` on one test file, card vs CPU."""
    wav_path = sorted((tree / DISK_TEST[0]).glob("*.wav"))[0]
    wav, _ = read_wav(str(wav_path))
    task = seeded_model("golf", "cuda").eval()
    got = biquads_torch.extract(task, wav)
    cpu_task = seeded_model("golf", "cpu")
    cpu_task.load_state_dict({k: v.cpu() for k, v in
                              task.state_dict().items()})
    ref = biquads_torch.extract(cpu_task.eval(), wav, init_stats=False)
    np.savez(out, **got)
    keys = sorted(np.load(out).files)
    errs = {k: float(np.abs(got[k] - ref[k]).max() / np.abs(ref[k]).max())
            for k in ref}
    print(f"biquads: {keys}, shapes "
          f"{ {k: list(v.shape) for k, v in got.items()} }; card vs CPU "
          f"relative {errs} (tolerance {BIQUAD_TOL:g})")
    check(keys == sorted(ref) and {"gain", "lpc", "table_weight"} <= set(keys),
          f"biquads keys {keys}")
    check(max(errs.values()) <= BIQUAD_TOL, "biquads card vs CPU")
    return errs


def tools_wav2f0(tree: Path, work: Path) -> dict:
    """``scripts/wav2f0_torch.py``: the host methods on two test files and
    ``penn`` on all of them, on the card and on the CPU."""
    w2f = _script("wav2f0_torch")
    wavs = sorted(p for spk in DISK_TEST for p in (tree / spk).glob("*.wav"))
    out = {}
    for method in ("dio", "native", "swipe"):
        pv = {}
        t0 = time.perf_counter()
        for device in ("cuda", "cpu"):
            d = work / f"{method}-{device}"
            d.mkdir(parents=True, exist_ok=True)
            for w in wavs[:2]:
                w2f.process((w, d / w.with_suffix(".pv").name, 65.0, 1047.0,
                             method, device))
            pv[device] = [(d / w.with_suffix(".pv").name).read_bytes()
                          for w in wavs[:2]]
        same = pv["cuda"] == pv["cpu"]
        out[method] = {"same": same, "s": time.perf_counter() - t0}
        print(f"wav2f0 {method}: 2 files, .pv card == CPU bit for bit: "
              f"{same}")
        check(same, f"wav2f0 {method} card vs CPU")
    d = work / "penn"
    for w in wavs:
        (d / w.parent.name).mkdir(parents=True, exist_ok=True)
        shutil.copy(w, d / w.parent.name / w.name)
    t0 = time.perf_counter()
    check(w2f.main([str(d), "--method", "penn", "--device", "cuda"]) == 0,
          "wav2f0 penn")
    seconds = time.perf_counter() - t0
    agree, voiced = [], []
    for w in wavs:
        got = np.loadtxt(d / w.parent.name / w.with_suffix(".pv").name)
        x, sr = read_wav(str(w))
        ref = w2f.estimate(x, sr, 65.0, 1047.0, "penn", "cpu")
        agree.append(np.equal(got > 0, ref > 0).mean())
        voiced.append((got > 0).mean())
    print(f"wav2f0 penn: {len(wavs)} files on the card in {seconds:.2f} s; "
          f"frames voiced alike on card and CPU {min(agree):.4f} at worst "
          f"(at least {PENN_AGREE}); voiced share {np.mean(voiced):.3f}")
    check(min(agree) >= PENN_AGREE, "wav2f0 penn card vs CPU")
    out["penn"] = {"agree": float(min(agree)), "s": seconds}
    return out


def tools_pitchnet() -> dict:
    """PitchNet on the card tracks 110, 220 and 330 Hz sawtooths and gates
    noise (tests/test_pitchnet.py's checks)."""
    t = np.arange(SR) / SR
    rng = np.random.default_rng(1)
    out = {}
    for f0_true in (110.0, 220.0, 330.0):
        x = sum(np.sin(2 * np.pi * k * f0_true * t) / k for k in range(1, 9))
        x += 0.01 * rng.standard_normal(len(t))
        f0, _ = pitchnet.predict(x.astype(np.float32), SR, device="cuda")
        mid = f0[20:-20]
        v = mid > 0
        cents = float(np.median(1200 * np.abs(np.log2(mid[v] / f0_true)))) \
            if v.any() else float("inf")
        out[f"{f0_true:.0f}"] = {"voiced": float(v.mean()), "cents": cents}
        check(v.mean() > 0.9 and cents < 30,
              f"pitchnet {f0_true} Hz: voiced {v.mean():.3f}, median "
              f"{cents:.1f} cents")
    f0, _ = pitchnet.predict(rng.standard_normal(SR // 2).astype(np.float32),
                             SR, device="cuda")
    out["noise_gated"] = float((f0 == 0).mean())
    print(f"pitchnet on the card: {out}")
    check(out["noise_gated"] > 0.9, "pitchnet gates noise")
    return out


def tools_fad(ref_dir: Path, eval_dir: Path) -> dict:
    """``fad_torch`` with each embedder on the card over the two trees (the
    CLI, in this process), and each embedding of one file card vs CPU;
    DAC's time a 5 s window and its peak memory."""
    wav, sr = read_wav(str(sorted(eval_dir.glob("**/*.wav"))[0]))
    out = {}
    for name in ("logmel", "vggish", "dac"):
        w = None if name == "logmel" else "random"
        weights = ["--weights", w] if w else []
        embs = [fad_torch.make_embedder(name, w, SR, d)[0]
                for d in ("cuda", "cpu")]
        e_gpu, e_cpu = (e.embed(wav, sr) for e in embs)
        err = float(np.abs(e_gpu - e_cpu).max() / np.abs(e_cpu).max())
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = fad_torch.main([str(ref_dir), str(eval_dir), "--embedder",
                                 name, *weights, "--device", "cuda"])
        seconds = time.perf_counter() - t0
        report = buf.getvalue().strip().splitlines()
        out[name] = {"embed_shape": list(e_gpu.shape), "vs_cpu": err,
                     "cli_s": seconds, "mean": report[-1]}
        print(f"fad {name} {' '.join(weights)}: embeddings "
              f"{tuple(e_gpu.shape)} card vs CPU {err:.3e} of max-abs "
              f"(tolerance {EMBED_TOL:g}); the CLI in {seconds:.2f} s:")
        for line in report:
            print(f"  {line}")
        check(rc == 0 and report[-1].startswith("mean ")
              and len(report) == len(DISK_TEST) + 2, f"fad_torch {name}")
        check(err <= EMBED_TOL, f"fad {name} card vs CPU")
        if name == "dac":
            model = embs[0].model
            x = torch.from_numpy(dac.dac_windows(wav, sr)[:1])[:, None].cuda()
            torch.cuda.reset_peak_memory_stats()
            with torch.inference_mode():
                ms = cuda_ms(lambda: model(x), 5, strict=False)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            out[name].update(ms_per_window=ms, peak_gib=peak)
            print(f"fad dac: {ms:.2f} ms a 5 s window (CUDA events, 5 "
                  f"calls), peak {peak:.2f} GiB")
    return out


def model_step(model, inputs, w, **kwargs):
    """(loss, gradients by name) of sum(model(*inputs) * w) / w.numel()."""
    model.zero_grad()
    out = model(*inputs, **kwargs)
    y = out.data if isinstance(out, Sig) else out
    loss = (y * w).sum() / w.numel()
    loss.backward()
    return loss.item(), {n: p.grad.detach().cpu() for n, p in
                         model.named_parameters() if p.grad is not None}


def _to(inputs, kwargs, device=None, dtype=None):
    """The inputs (tensors or Sigs) and keyword tensor lists on ``device``
    and in ``dtype``."""
    def move(t):
        return t.to(device=device, dtype=dtype)
    return ([move(i) if torch.is_tensor(i) else Sig(move(i.data), i.hop)
             for i in inputs],
            {k: [move(m) for m in v] if isinstance(v, list) else v
             for k, v in kwargs.items()})


def card_vs_cpu(name: str, make, inputs, w, zero_bias=(),
                arbiter64=False, **kwargs) -> dict:
    """One forward and backward of ``make()`` in train mode (``train=True``
    where its forward takes it) on the card, timed after a warm-up call,
    and on the CPU, the same weights and inputs: the loss within LOSS_TOL
    relative and each gradient within TRAIN_GRAD_TOL of its max-abs of the
    CPU's. With ``arbiter64`` (a network whose float32 gradients stray far
    from float64 on either device) the gradients are held in float64 on
    both devices instead, each within TRAIN_GRAD_TOL, and the card's
    float32 gradients, against the CPU's float64, may stray no further than
    twice the CPU float32's worst (or TRAIN_GRAD_TOL). A bias whose name
    holds one of ``zero_bias`` (a conv's before a train-mode batch norm,
    the attention's key bias: zero gradient in exact arithmetic) is held
    against its weight's gradient scale."""
    torch.manual_seed(SEED)
    model = make()
    gen = torch.Generator().manual_seed(SEED + 2)
    with torch.no_grad():
        for p in model.parameters():
            if p.requires_grad and not p.any():     # zero-initialised ones
                p.copy_(0.05 * torch.randn(p.shape, generator=gen))
    model.train()
    cpu_model = copy.deepcopy(model)
    model = model.cuda()
    if "train" in inspect.signature(model.forward).parameters:
        kwargs = {**kwargs, "train": True}
    dev_in, dev_kw = _to(inputs, kwargs, "cuda")
    w_dev = w.cuda()
    model_step(model, dev_in, w_dev, **dev_kw)
    torch.cuda.reset_peak_memory_stats()
    (loss_g, grads_g), seconds = timed(
        lambda: model_step(model, dev_in, w_dev, **dev_kw))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    # oneDNN's float32 conv1d backward is wrong at stride 2 on odd lengths
    # (CREPE's last conv, (64, 256, 95): 0.46 of max-abs); the CPU's
    # reference runs PyTorch's own kernels
    with torch.backends.mkldnn.flags(enabled=False):
        loss_c, grads_c = model_step(cpu_model, inputs, w, **kwargs)
    pairs = {"f32": (grads_g, grads_c)}
    if arbiter64:
        in64, kw64 = _to(inputs, kwargs, dtype=torch.float64)
        cpu64 = model_step(copy.deepcopy(cpu_model).double(), in64,
                           w.double(), **kw64)[1]
        in64, kw64 = _to(inputs, kwargs, "cuda", torch.float64)
        card64 = model_step(copy.deepcopy(model).double(), in64,
                            w_dev.double(), **kw64)[1]
        pairs = {"f64": (card64, cpu64), "card32": (grads_g, cpu64),
                 "cpu32": (grads_c, cpu64)}
    loss_err = abs(loss_g - loss_c) / abs(loss_c)
    errs = {}
    for key, (got, ref) in pairs.items():
        check(set(got) == set(ref), f"{name}: the same gradients")
        for n in ref:
            scale = ref[n[:-len("bias")] + "weight"] \
                if n.endswith("bias") and any(z in n for z in zero_bias) \
                else ref[n]
            errs.setdefault(key, {})[n] = float(
                (got[n].double() - ref[n].double()).abs().max()
                / scale.abs().max().double())
    held = "f64" if arbiter64 else "f32"
    worst = max(errs[held].values())
    ranked = sorted(errs[held], key=errs[held].get, reverse=True)[:3]
    note = ""
    if arbiter64:
        w32, c32 = max(errs["card32"].values()), max(errs["cpu32"].values())
        note = (f"; float32 against the CPU's float64: card {w32:.2e}, CPU "
                f"{c32:.2e} at worst (the card at most twice the CPU's)")
        check(w32 <= max(TRAIN_GRAD_TOL, 2 * c32),
              f"{name}: the card's float32 gradients")
    print(f"{name}, train mode: forward and backward {seconds * 1e3:.2f} "
          f"ms on the card, peak {peak:.2f} GiB; card vs CPU loss "
          f"{loss_err:.2e} (tolerance {LOSS_TOL:g}); "
          f"{len(errs[held])} {'float64 ' if arbiter64 else ''}gradients "
          f"card vs CPU {worst:.2e} of max-abs at worst ("
          + ", ".join(f"{n} {errs[held][n]:.2e}" for n in ranked)
          + f"; tolerance {TRAIN_GRAD_TOL:g}){note}")
    check(np.isfinite(loss_g) and loss_err <= LOSS_TOL
          and worst <= TRAIN_GRAD_TOL, f"{name} card vs CPU")
    out = {"ms": seconds * 1e3, "peak_gib": peak, "loss_err": loss_err,
           "grad_err": worst}
    if arbiter64:
        out.update(f32_card_vs_f64=w32, f32_cpu_vs_f64=c32)
    return out


def crepe_frames(t: int) -> int:
    """CREPE's output frames for t samples (each conv padded by k // 2)."""
    for k, s in zip((512, 64, 64, 64, 64, 64), (4, 4, 4, 4, 2, 2)):
        t = (t + 2 * (k // 2) - k) // s + 1
    return t


def tools_models() -> dict:
    """CREPE at B = 64 x 2 s in train mode (batch statistics), TTSPN (its
    defaults: d 128, 4 heads, 2 layers, dropout 0.1 on the same masks on
    both devices) over TopNGenerator's 10 tokens and 200 frames, and the
    one-way LSTM (256 x 1) on those frames, each card vs CPU."""
    gen = torch.Generator().manual_seed(SEED + 3)
    t = int(MODEL_SECONDS * SR)
    frames = t // 240
    x = 0.3 * torch.randn((MODEL_BATCH, t), generator=gen)
    crepe_out = 8
    # float32 gradients stray up to ~5e-2 of max-abs from float64 on either
    # device here: they are held in float64
    out = {"crepe": card_vs_cpu(
        "CREPE (B = 64 x 2 s)", lambda: CREPE(crepe_out), [Sig(x, 1)],
        torch.randn((MODEL_BATCH, crepe_frames(t), crepe_out),
                    generator=gen), zero_bias=("convs.",), arbiter64=True)}
    memory = torch.randn((MODEL_BATCH, frames, 128), generator=gen)
    topn = TopNGenerator()
    with torch.no_grad():
        tokens_gpu = copy.deepcopy(topn).cuda()(memory.cuda()).cpu()
        tokens = topn(memory)
    check(torch.equal(tokens_gpu, tokens),
          "TopNGenerator picks the same embeddings on card and CPU")
    keeps = [((torch.rand((TSPN_TOKENS, frames), generator=gen) < 0.9)
              .float() / 0.9) for _ in range(2)]
    out["tspn"] = card_vs_cpu(
        "TTSPNEncoder (B = 64, 10 tokens x 200 frames)", TTSPNEncoder,
        [tokens, memory], torch.randn((MODEL_BATCH, TSPN_TOKENS, 2),
                                      generator=gen), zero_bias=(".key.",),
        keeps=keeps)
    out["lstm"] = card_vs_cpu(
        "LSTM (256 x 1, B = 64 x 200 frames)", lambda: LSTM(128, 256),
        [memory], torch.randn((MODEL_BATCH, frames, 256), generator=gen))
    return out


ANCHOR_ORDER = 26           # tools/lpc_anchor.py's default
ANCHOR_TOL = 1e-4            # lpc_anchor's wav card vs CPU, of max|y|
P26_TOL = 1e-5               # B4 at p = 26 vs its chunked mirror and float64
TIME_L2_ITERS = 5
TIME_L2_GRAD_TOL = 1e-3      # time_l2's offsets gradient, of max-abs
# a time_l2 iteration's launches: the phase takes a gradient, so B3a runs
# where B1 would; the task is frozen, so no table gradient (B3b) and no da
TIME_L2_PATH = {"golf": {"lookup_res": 1, "allpole_const": 1,
                         "allpole_const_adjoint": 1},
                "golf-precise": {"lookup_res": 1, "allpole_tv": 1,
                                 "allpole_tv_adjoint": 1}}
# and the decode of the best offsets at the end, without a gradient
TIME_L2_DECODE = {"golf": {"lookup": 1, "allpole_const": 1},
                  "golf-precise": {"lookup": 1, "allpole_tv": 1}}
CONVERT_SIZES = (22, 1, 22, 1, 64)
CONVERT_ORDER = (4, 1, 0, 3, 2)


def kernel(name: str) -> kernels.CudaKernel:
    return next(k for k in DSP_KERNELS if k.name == name)


def scan64(x: np.ndarray, a: np.ndarray) -> np.ndarray:
    """The time-varying all-pole on one row in float64, sample by sample:
    x (T,), a (T, p) -> (T,)."""
    t, p = a.shape
    y = np.zeros(t + p)
    for n in range(t):
        y[n + p] = x[n] - a[n] @ y[n + p - 1:n - 1 if n else None:-1]
    return y[p:]


def run_json(main, argv) -> dict:
    """A tool's ``main(argv)``, its output echoed, its last line as JSON."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        check(main(argv) == 0, f"{argv} returned 0")
    print(buf.getvalue().rstrip())
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def tools_lpc_anchor(tree: Path, out: Path) -> tuple:
    """``tools/lpc_anchor_torch.py`` on one 5.5 s wav of the tree: B4 (its
    generic-order instantiation, p = 26) exactly once on (1, T) and no other
    kernel; the written wav against the anchor on the CPU; B4 on those
    inputs against ``allpole_chunked_plain`` and a float64 scan, with its
    time, ``golf_tpu``'s float32 form's and the byte bound."""
    anchor = _script("lpc_anchor_torch", "tools")
    spk = DISK_TEST[0]
    wav = tree / spk / f"{spk}_001_mic1.wav"
    x, sr = read_wav(str(wav))
    zero_counts()
    t0 = time.perf_counter()
    check(anchor.main([str(wav), str(out / "anchor.wav")]) == 0,
          "lpc_anchor_torch ran")
    seconds = time.perf_counter() - t0
    counts = read_counts()
    src, a = anchor.interpolate(*anchor.excitation(x, sr), 80)
    t = len(src)
    shapes = ((1, t), (1, t, ANCHOR_ORDER))
    check_exact("lpc_anchor", counts, {"allpole_tv": 1}, 1)
    check(kernel("allpole_tv").last_shapes == shapes,
          f"lpc_anchor: B4 at {kernel('allpole_tv').last_shapes} == {shapes}")
    got, _ = read_wav(str(out / "anchor.wav"))
    ref = anchor.anchor(x, sr, device="cpu")
    rel = float(np.abs(got - ref).max() / np.abs(ref).max())
    print(f"lpc_anchor: {wav.name} ({len(x) / sr:.1f} s) in {seconds:.2f} s, "
          f"launches {counts}; card vs CPU {rel:.3e} of max|y| (tolerance "
          f"{ANCHOR_TOL:g})")
    check(got.shape == x.shape and np.isfinite(got).all()
          and rel <= ANCHOR_TOL, "lpc_anchor card vs CPU")

    xs = torch.tensor(src[None], dtype=torch.float32, device="cuda")
    as_ = torch.tensor(a[None], dtype=torch.float32,
                       device="cuda").contiguous()
    y = allpole_cuda(xs, as_)
    mirror = allpole_chunked_plain(xs, as_)
    y64 = scan64(xs[0].double().cpu().numpy(), as_[0].double().cpu().numpy())
    plain = allpole_plain(xs, as_)
    peak64 = np.abs(y64).max()
    err64 = float(np.abs(y[0].double().cpu().numpy() - y64).max() / peak64)
    plain64 = float(np.abs(plain[0].double().cpu().numpy() - y64).max()
                    / peak64)
    err = rel_err(y, mirror)
    chunk, nc = tap.chunk_for(1, t), tap.rerun_chunks(1, t, ANCHOR_ORDER)
    print(f"[lpc_anchor] allpole_tv (B4) {shapes[0]} p={ANCHOR_ORDER}, "
          f"chunk {chunk}, re-run chunks {nc}: / max|y| {err:.3e} against "
          f"allpole_chunked_plain, {err64:.3e} against a float64 scan "
          f"(tolerance {P26_TOL:g} each); golf_tpu's float32 form "
          f"(allpole_plain) {plain64:.3e} from the float64 scan")
    check(err <= P26_TOL and err64 <= P26_TOL
          and torch.isfinite(y).all().item(), "B4 at p = 26")
    check(chunk == 512 and nc == 1, "B4 at p = 26: chunk 512, one re-run "
          "chunk a CTA")
    row = dict(err=(y - mirror).abs().max().item(), err64=err64,
               plain_err64=plain64, chunk=chunk,
               ms=cuda_ms(lambda: allpole_cuda(xs, as_), 50),
               plain_ms=cuda_ms(lambda: allpole_plain(xs, as_), 3,
                                strict=False),
               bound=bound(4 * (2 * xs.numel() + as_.numel()),
                           2 * as_.numel()),
               shapes=[list(s) for s in shapes])
    # the p = 22 instantiation (kRingOrder) on a row of the same length
    a22 = tv_coeffs(torch.Generator(device="cuda").manual_seed(SEED), 1, t)
    row["p22_ms"] = cuda_ms(lambda: allpole_cuda(xs, a22), 50)
    print(f"[lpc_anchor] allpole_tv at p={ANCHOR_ORDER}: {row['ms'] * 1e3:.1f} "
          f"us, bound {row['bound'][0] * 1e3:.2f} us ({row['bound'][1]}), "
          f"plain {row['plain_ms'] * 1e3:.1f} us; p = 22 on the same row "
          f"{row['p22_ms'] * 1e3:.1f} us")
    return counts, {"wav": wav.name, "s": seconds, "vs_cpu": rel}, row


def tools_time_l2(run: Path, ckpt: Path, out: Path) -> tuple:
    """``tools/time_l2_torch.py --iters 5`` on the test split's item 0
    with the disk phase's GOLF-ff checkpoint, in the run's config with
    golf.yaml's decoder and with golf-precise.yaml's (the two share one
    layout): each iteration launches
    B3a, B2 and B2's adjoint (GOLF-ss: B4 and its adjoint) once, B2's
    adjoint without ``da``; the loss at iteration 0 card vs CPU (1e-5
    relative) and the offsets' gradient card vs CPU (1e-3 of max-abs, or
    within twice the CPU's float32 distance of a float64 CPU run). Returns
    (launches, summary, the kernels' shapes there)."""
    import yaml

    tl2 = _script("time_l2_torch", "tools")
    total = {k.name: 0 for k in DSP_KERNELS}
    summary = {}
    shapes = None
    for decoder, per in TIME_L2_PATH.items():
        model = f"cfg/ae/decoder/{decoder}.yaml"
        # the run's config with this decoder (a merge over golf.yaml's
        # would keep its frame-wise keys)
        cfg = load_config([str(run / "config.yaml")])
        cfg["model"]["init_args"]["decoder"] = load_config([model])["decoder"]
        config = str(out / f"time_l2_{decoder}.yaml")
        out.mkdir(parents=True, exist_ok=True)
        with open(config, "w") as f:
            yaml.safe_dump(cfg, f, sort_keys=False)
        with_da = []
        orig = tap.CONST_CUDA_OPS

        def adj(g, y, a, flag=True, orig=orig, seen=with_da):
            seen.append(flag)
            return orig.adj(g, y, a, flag)

        tap.CONST_CUDA_OPS = tap.ConstOps(orig.fwd, adj)
        zero_counts()
        p1 = pyramid_launches()
        try:
            t0 = time.perf_counter()
            report = run_json(tl2.main, [
                "--config", config, "--model", model, "--ckpt", str(ckpt),
                "--iters", str(TIME_L2_ITERS), "--out",
                str(out / f"time_l2_{decoder}.wav")])
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        finally:
            tap.CONST_CUDA_OPS = orig
        counts = read_counts()
        # the encoder once, in eval mode under no gradient
        check_pyramid(f"time_l2 {decoder}", pyramid_since(p1), len(
            cfg["model"]["init_args"]["encoder_init_args"]["channels"]), 1)
        for name, n in counts.items():
            total[name] += n
        want = {name: per.get(name, 0) * TIME_L2_ITERS
                + TIME_L2_DECODE[decoder].get(name, 0) for name in counts}
        print(f"time_l2 {decoder}: {TIME_L2_ITERS} iterations in "
              f"{seconds:.2f} s, launches {counts}; B2's adjoint formed da: "
              f"{with_da}")
        check_exact(f"time_l2 {decoder}", counts, want, 1)
        check(not any(with_da) and len(with_da) == counts[
            "allpole_const_adjoint"], f"time_l2 {decoder}: no da")
        check(np.isfinite(report["final_l2"])
              and report["final_mse"] <= report["initial_mse"],
              f"time_l2 {decoder} report")

        grads, losses = [], []
        for dtype, dev in ((torch.float32, "cuda"), (torch.float32, "cpu"),
                           (torch.float64, "cpu")):
            t_, dm, _ = tl2.load(config, model, str(ckpt), dev)
            dm.setup("test")
            x_np, f0_np = dm.test_dataset[0]
            obj = tl2.PhaseOffsetL2(
                t_.to(dtype), torch.from_numpy(x_np)[None].to(dev, dtype),
                torch.from_numpy(f0_np)[None].to(dev, dtype), 1200)
            loss, grad = obj.loss_and_grad(obj.initial_offsets().to(dtype))
            losses.append(float(loss))
            grads.append(grad.double().cpu())
        shapes = main_path_shapes(1, len(x_np))
        for name in per:
            check(kernel(name).last_shapes == shapes[name],
                  f"time_l2 {decoder}: {name} at {kernel(name).last_shapes}"
                  f" == {shapes[name]}")
        loss_rel = abs(losses[0] - losses[1]) / abs(losses[1])
        gap, gap64, cpu64 = (rel_err(grads[0], grads[1]),
                             rel_err(grads[0], grads[2]),
                             rel_err(grads[1], grads[2]))
        print(f"time_l2 {decoder}: iteration 0 card vs CPU: loss "
              f"{loss_rel:.3e} relative (tolerance {TEST_REL_TOL:g}); the "
              f"offsets' gradient {gap:.3e} of max-abs, card {gap64:.3e} and "
              f"CPU float32 {cpu64:.3e} from a float64 CPU run (tolerance "
              f"{TIME_L2_GRAD_TOL:g}, or twice the CPU's)")
        check(loss_rel <= TEST_REL_TOL, f"time_l2 {decoder} loss card vs CPU")
        check(gap <= TIME_L2_GRAD_TOL
              or gap64 <= max(TIME_L2_GRAD_TOL, 2 * cpu64),
              f"time_l2 {decoder} gradient card vs CPU")
        summary[decoder] = {**report, "s": seconds,
                            "launches_per_iteration": per,
                            "loss_vs_cpu": loss_rel, "grad_vs_cpu": gap,
                            "grad_vs_float64": gap64,
                            "cpu_grad_vs_float64": cpu64}
    return total, summary, shapes


def tools_rd_stats(run: Path, ckpt: Path) -> dict:
    """``tools/rd_stats_torch.py --items 16`` with the disk phase's
    checkpoint on the validation split: no kernel launches; card vs CPU,
    every Rd within 1e-4 of the CPU's mean Rd, the counts equal."""
    rd = _script("rd_stats_torch", "tools")
    argv = ["--config", str(run / "config.yaml"), "--ckpt", str(ckpt),
            "--items", "16"]
    zero_counts()
    t0 = time.perf_counter()
    card = run_json(rd.main, argv)
    seconds = time.perf_counter() - t0
    check_exact("rd_stats", read_counts(), {}, 1)
    cpu = run_json(rd.main, [*argv, "--device", "cpu"])
    scale = cpu["rd_mean"]
    gap = max(abs(a - b) for key in ("rd_mean", "rd_std", "rd_min", "rd_max",
                                     "rd_deciles")
              for a, b in zip(np.atleast_1d(card[key]),
                              np.atleast_1d(cpu[key]))) / scale
    print(f"rd_stats: {card['n_voiced_frames']} of {card['n_frames']} frames "
          f"voiced in {seconds:.2f} s; card vs CPU: every Rd within "
          f"{gap:.3e} of the mean Rd (tolerance 1e-4)")
    check(card["n_voiced_frames"] > 0 and all(
        card[k] == cpu[k] for k in ("n_voiced_frames", "n_frames"))
        and gap <= 1e-4, "rd_stats card vs CPU")
    return {**card, "s": seconds, "vs_cpu": gap}


def same_tree(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same_tree(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(same_tree, a, b))
    if torch.is_tensor(a):
        return torch.equal(a, b)
    return a == b


def tools_convert_ckpt(ckpt: Path, out: Path) -> dict:
    """``tools/convert_ckpt_torch.py`` on the disk phase's checkpoint: a
    permutation of the head's blocks, then its inverse, give the checkpoint
    back bit for bit (the optimizer state untouched by both)."""
    conv = _script("convert_ckpt_torch", "tools")
    inverse = [int(i) for i in np.argsort(CONVERT_ORDER)]
    sizes = [CONVERT_SIZES[i] for i in CONVERT_ORDER]
    for src, dst, sz, order in ((ckpt, out / "perm.pt", CONVERT_SIZES,
                                 CONVERT_ORDER),
                                (out / "perm.pt", out / "back.pt", sizes,
                                 inverse)):
        check(conv.main(["--in", str(src), "--out", str(dst), "--old-sizes",
                         *map(str, sz), "--new-order", *map(str, order)])
              == 0, f"convert_ckpt_torch {dst.name}")
    orig, perm, back = (ckpt_lib.load(str(p), map_location="cpu") for p in
                        (ckpt, out / "perm.pt", out / "back.pt"))
    moved = [k for k in orig["model"] if "out_linear" in k]
    changed = all(not torch.equal(perm["model"][k], orig["model"][k])
                  for k in moved)
    same = same_tree(back, orig)
    untouched = same_tree(perm["optimizer"], orig["optimizer"])
    print(f"convert_ckpt: {moved} permuted ({CONVERT_SIZES}, order "
          f"{CONVERT_ORDER}): changed {changed}; the inverse gives the "
          f"checkpoint back bit for bit: {same}; optimizer state untouched: "
          f"{untouched}")
    check(moved and changed and same and untouched, "convert_ckpt round trip")
    return {"keys": moved, "round_trip": same}


def phase_tools(tree: Path, out: Path, shapes: dict, run: Path) -> tuple:
    """The tools phase on the VCTK tree of phase disk and its GOLF-ff run
    directory ``run`` (``config.yaml``, ``ckpt/last``); ``shapes`` are the
    kernels' operands in test_rtf's synthesis. Returns (the launches of
    its kernel paths, a summary, the kernel rows at ``shapes``, the
    launches of each decoder's test_rtf run, B4's row at p = 26 and the
    kernel rows at time_l2's shapes)."""
    summary = {"build": tools_build()}
    counts = {k.name: 0 for k in DSP_KERNELS}
    rtf_counts = {}
    for decoder in RTF_PATH:
        c, summary[f"rtf_{decoder}"] = tools_rtf(decoder, shapes)
        rtf_counts[decoder] = c
        for name, n in c.items():
            counts[name] += n
    rows = phase_kernels(shapes, label="rtf")
    for name in ("lookup", "allpole_const", "allpole_tv"):
        r = rows[name]
        print(f"[rtf] {name} {shapes[name]}: {r['ms'] * 1e3:.2f} us, bound "
              f"{r['bound'][0] * 1e3:.2f} us ({r['bound'][1]}), plain "
              f"{r['plain_ms'] * 1e3:.1f} us"
              + (f", F.grid_sample {r['library_ms'] * 1e3:.2f} us"
                 if r.get("library_ms") else ""))
    c, summary["harm_and_noise"] = tools_harm_noise(tree, out / "hn")
    for name, n in c.items():
        counts[name] += n
    summary["pesq"] = tools_pesq(tree, out / "hn" / "harm")
    summary["biquads"] = tools_biquads(tree, out / "biquads.npz")
    summary["wav2f0"] = tools_wav2f0(tree, out / "wav2f0")
    summary["pitchnet"] = tools_pitchnet()
    summary["fad"] = tools_fad(tree, out / "hn" / "harm")
    summary["models"] = tools_models()
    ckpt = run / "ckpt" / "last"
    c, summary["lpc_anchor"], p26_row = tools_lpc_anchor(tree, out)
    p26_row["launches"] = c["allpole_tv"]
    for name, n in c.items():
        counts[name] += n
    c, summary["time_l2"], l2_shapes = tools_time_l2(run, ckpt, out)
    for name, n in c.items():
        counts[name] += n
    l2_rows = phase_kernels(l2_shapes, ("lookup", "lookup_res",
                                        "lookup_dtab", "allpole_const",
                                        "allpole_tv"), label="time_l2")
    l2_rows = {name: {**r, "shapes": [list(s) for s in l2_shapes[name]],
                      "launches": sum(
                          summary["time_l2"][d]["launches_per_iteration"]
                          .get(name, 0) * TIME_L2_ITERS
                          + TIME_L2_DECODE[d].get(name, 0)
                          for d in TIME_L2_PATH),
                      "launches_per_iteration": {
                          d: summary["time_l2"][d]["launches_per_iteration"]
                          .get(name, 0) for d in TIME_L2_PATH}}
               for name, r in l2_rows.items()}
    summary["rd_stats"] = tools_rd_stats(run, ckpt)
    summary["convert_ckpt"] = tools_convert_ckpt(ckpt, out)
    return counts, summary, rows, rtf_counts, p26_row, l2_rows


# ---------------------------------------------------------------------------
# phase parallel: data-parallel and time-sharded training (gloo, one card)
# ---------------------------------------------------------------------------

PAR_SECONDS = 2.0
PAR_LOSS_TOL = 2e-4          # tests/test_seqpar.py's limits: loss relative,
PAR_GRAD_TOL = 5e-4          # each gradient of its largest entry
# (kind, decoder, (data, time), global batch): DP 2 x 1 and time 1 x 2 for
# GOLF-ss and GOLF-ff at B = 64, time 2 x 2 for GOLF-ss at B = 32, time 1 x
# 2 for the other decoders at B = 64
PAR_BASELINES = ("ddsp", "nhv", "mlsa", "mlsa-taylor", "world")
PAR_CASES = (("dp", "golf-precise", (2, 1), 64), ("dp", "golf", (2, 1), 64),
             ("time", "golf-precise", (1, 2), 64),
             ("time", "golf", (1, 2), 64),
             ("time", "golf-precise", (2, 2), 32),
             ("time", "golf-v1", (1, 2), 64)) + tuple(
                 ("time", d, (1, 2), 64) for d in PAR_BASELINES)
# the kernels each case's path must launch on every rank, once a step
PAR_PATHS = {("dp", "golf-precise"): ("lookup", "lookup_dtab", "allpole_tv",
                                      "allpole_tv_adjoint"),
             ("dp", "golf"): ("lookup", "lookup_dtab", "allpole_const",
                              "allpole_const_adjoint"),
             ("time", "golf-precise"): ("lookup", "lookup_dtab",
                                        "allpole_tv_summary",
                                        "allpole_tv_rerun"),
             ("time", "golf"): ("lookup", "lookup_dtab", "allpole_const",
                                "allpole_const_adjoint"),
             ("time", "golf-v1"): ("lookup", "lookup_dtab", "allpole_const",
                                   "allpole_const_adjoint"),
             **{("time", d): () for d in PAR_BASELINES}}


def v1_rank_shapes(batch: int, t_loc: int) -> dict:
    """golf-v1's kernels' operand shapes on a rank's window at 1 x 2: B1
    and B3b on the window's 4x-oversampled phase in blocks of the table hop
    (9600) and its table rows (one past the window), B2 on its GOLF-ff
    frames (one a hop of 240), order 22."""
    hop_os = 240 * 10 * 4
    blocks = t_loc * 4 // hop_os
    n_ff = batch * t_loc // 240
    lookup = ((batch, blocks, hop_os), (batch, blocks + 1, 2048))
    return {"lookup": lookup, "lookup_dtab": lookup,
            "allpole_const": ((n_ff, 960), (n_ff, 22)),
            "allpole_const_adjoint": ((n_ff, 960), (n_ff, 22))}


def case_label(case) -> str:
    kind, decoder, (d, t), b = case
    return f"{kind} {d}x{t} {decoder} B={b}"


def par_inputs(batch: int):
    """The global batch of a case: synthetic voices with white noise at
    -20 dB (as phase_train_vs_cpu), the noise field and the unvoiced
    frames' f0, all seeded."""
    x, f0 = requests(batch, PAR_SECONDS)
    x = x + 0.1 * torch.randn(x.shape,
                              generator=torch.Generator().manual_seed(8))
    noise = torch.randn(x.shape, generator=torch.Generator().manual_seed(7))
    random_f0 = 50 + 450 * torch.rand(
        (batch, 1), generator=torch.Generator().manual_seed(9))
    return x, f0, noise, random_f0


def par_model(decoder: str, x: torch.Tensor, f0: torch.Tensor):
    """The full-width model of a case on the card (dropout 0, so that every
    layout draws nothing but the given fields), its running min/max from
    the global batch."""
    task = seeded_model(decoder, "cuda", train_model_config(decoder, 0.0))
    task.init_running_stats(Sig(x.cuda(), 1), Sig(f0.cuda(), 1))
    task.train()
    return task


def grad_errors(grads: dict, ref: dict, skip: str = None) -> tuple:
    """(largest error of any gradient over its own largest entry, its name),
    leaving out the names that contain ``skip`` (``leaf_errors``)."""
    errs = {k: e for k, e in leaf_errors(grads, ref).items()
            if not (skip and skip in k)}
    name = max(errs, key=errs.get)
    return errs[name], name


def leaf_errors(grads: dict, ref: dict) -> dict:
    """Each gradient's error over its own largest entry, by name; the conv
    biases in front of a train-mode batch norm, zero in exact arithmetic,
    against their conv weight's gradient (10 x), as the CPU tests hold
    them."""
    out = {}
    for k, r in ref.items():
        scale = r.abs().max().item()
        if ".pyramid.convs." in k and k.endswith(".bias"):
            scale = 10 * ref[k[:-4] + "weight"].abs().max().item()
        out[k] = (grads[k].cpu().double() - r.double()).abs().max().item() \
            / max(scale, 1e-30)
    return out


def beyond_tolerance(grads: dict, ref: dict, ref64: dict = None,
                     skip: str = None) -> list:
    """The gradients further than PAR_GRAD_TOL from the single-process
    step's (leaving out the names that contain ``skip``). With the float64
    single-process step ``ref64`` such a gradient is cleared when it stands
    within twice the single-process float32 step's own distance from it:
    float32 is itself off there (the vocoder phase holds its recipe path
    so). Each: name, error, its error against float64, the single-process
    step's, cleared."""
    errs = leaf_errors(grads, ref)
    bad = [k for k, e in errs.items()
           if e > PAR_GRAD_TOL and not (skip and skip in k)]
    e64 = s64 = {}
    if bad and ref64 is not None:
        e64, s64 = leaf_errors(grads, ref64), leaf_errors(ref, ref64)
    return [{"name": k, "err": errs[k], "err64": e64.get(k),
             "single_err64": s64.get(k),
             "cleared": k in e64 and e64[k] <= 2 * s64[k]} for k in bad]


def beyond_summary(beyond: list) -> dict:
    """``beyond_tolerance``'s rows in one record: how many, the worst, the
    largest ratio of a rank's error against float64 to the single-process
    step's, and whether float64 cleared every one."""
    worst = max(beyond, key=lambda b: b["err"], default=None)
    return {"n": len(beyond), "worst": worst and worst["name"],
            "err": worst and worst["err"],
            "max_ratio_vs_float64": max(
                (b["err64"] / max(b["single_err64"], 1e-30) for b in beyond
                 if b["err64"] is not None), default=None),
            "cleared": all(b["cleared"] for b in beyond)}


def par_rank(rank: int, world: int, store: str, work: str, result_q):
    """One rank of the parallel phase: every case in turn on the leading
    ranks of its layout (the others sit it out), two steps each, the
    second timed with the kernels' counts zeroed just before it."""
    from golf_tpu_torch.parallel.mesh import make_mesh
    from golf_tpu_torch.parallel.seqpar import make_sharded_train_step
    import torch.distributed as dist
    try:
        # the ranks share the card: each returns its freed blocks
        # (empty_cache after every step), and segments grow in place rather
        # than fragment
        import os
        os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                              "expandable_segments:True")
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                world_size=world, rank=rank,
                                timeout=__import__("datetime").timedelta(
                                    seconds=300))
        kernels.build(DSP_KERNELS)          # binds the parent's libraries
        out = {}
        for case in PAR_CASES:
            kind, decoder, layout, batch = case
            mesh = make_mesh(*layout)
            if not mesh.member:
                continue
            d = torch.load(Path(work) / f"{decoder}-{batch}.pt")
            task = par_model(decoder, d["x"], d["f0"])
            x, f0, noise, rf0 = (d[k].cuda() for k in
                                 ("x", "f0", "noise", "random_f0"))
            if kind == "dp":
                trainer = Trainer(task, run_dir=str(Path(work) / "dp"),
                                  mesh=mesh)

                def step():
                    m = trainer.loss_and_grads(Sig(x, 1), Sig(f0, 1),
                                               noise=noise, random_f0=rf0)
                    return float(m["loss"]), {
                        n: p.grad for n, p in task.named_parameters()
                        if p.requires_grad}
            else:
                sharded = make_sharded_train_step(task, mesh)

                def step():
                    loss, grads, _ = sharded(x, f0, noise=noise,
                                             random_f0=rf0)
                    return loss, grads
            ref = torch.load(Path(work) / f"ref-{case_label(case)}.pt")
            loss, grads = step()
            worst, name = grad_errors(grads, ref["grads"])
            worst_np, name_np = grad_errors(grads, ref["grads"], ".pyramid.")
            beyond = beyond_tolerance(grads, ref["grads"], ref.get("grads64"),
                                      ".pyramid.")
            del grads
            torch.cuda.empty_cache()
            # the same step with cuDNN off (native convolutions, batch norm
            # and LSTM), against the single-process step with cuDNN off
            with torch.backends.cudnn.flags(enabled=False):
                loss_off, grads = step()
            worst_off, name_off = grad_errors(grads, ref["grads_off"])
            beyond_off = beyond_tolerance(grads, ref["grads_off"],
                                          ref.get("grads64"))
            del grads
            torch.cuda.empty_cache()
            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated() / 2 ** 30
            torch.cuda.reset_peak_memory_stats()
            for k in DSP_KERNELS:
                k.launches = 0
                k.by_shapes = {}
            (loss2, _), secs = timed(step)
            out[case_label(case)] = {
                "loss": loss, "loss_ref": ref["loss"],
                "loss_rel": abs(loss - ref["loss"]) / abs(ref["loss"]),
                "grad_err": worst, "grad_err_at": name,
                "grad_err_no_pyramid": worst_np,
                "grad_err_no_pyramid_at": name_np,
                "loss_rel_off": abs(loss_off - ref["loss_off"])
                / abs(ref["loss_off"]),
                "grad_err_off": worst_off, "grad_err_off_at": name_off,
                "beyond": beyond, "beyond_off": beyond_off,
                "held_gib": held,
                "second_loss": loss2, "step_ms": secs * 1e3,
                "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                "counts": {k.name: k.launches for k in DSP_KERNELS},
                "shapes": {k.name: [list(map(list, s)) for s in k.by_shapes]
                           for k in DSP_KERNELS if k.by_shapes}}
            del task, step
            torch.cuda.empty_cache()
        dist.destroy_process_group()
        result_q.put((rank, out))
    except BaseException as e:  # noqa: BLE001 - reported to the parent
        import traceback
        result_q.put((rank, f"{type(e).__name__}: {e}\n"
                      f"{traceback.format_exc()}"))


def par_noise_len(task, x: torch.Tensor, f0: torch.Tensor) -> int:
    """The steps of a decoder's noise field on the global batch: those of
    its noise source's reference, the unsharded harmonic source (ddsp's
    ends where its frame-rate amplitudes do, (frames - 1) hop + 1), from
    the shapes of an eval-mode pass (no running statistic moves)."""
    task.eval()
    with torch.no_grad():
        params, _, _ = task.prepare_training(Sig(x.cuda(), 1),
                                             Sig(f0.cuda(), 1), False)
        ctrl = task.decoder.apply_ctrl(
            {k: v for k, v in params.items() if k.endswith("_params")})
    task.train()
    return task.decoder.stage_lens(x.shape[1], voicing=params.get("voicing"),
                                   **ctrl)["harm"]


def par_float64_step(decoder: str, d: dict) -> tuple:
    """The single-process step of a kernel-free decoder in float64 on the
    card (cuDNN off: native float64 convolutions and LSTM), the same
    weights and fields: (loss, gradients on the CPU)."""
    task = seeded_model(decoder, "cuda",
                        train_model_config(decoder, 0.0)).double()
    x, f0, noise, rf0 = (d[k].cuda().double() for k in
                         ("x", "f0", "noise", "random_f0"))
    with torch.backends.cudnn.flags(enabled=False):
        task.init_running_stats(Sig(x, 1), Sig(f0, 1))
        task.train()
        loss, _ = task.training_step(Sig(x, 1), Sig(f0, 1), noise=noise,
                                     random_f0=rf0)
        loss.backward()
    grads = {n: p.grad.cpu() for n, p in task.named_parameters()
             if p.requires_grad}
    loss = loss.item()
    del task
    torch.cuda.empty_cache()
    return loss, grads


def par_references(work: Path) -> dict:
    """The single-process card step of each case on its global batch, the
    same weights, fields and running min/max: its loss and gradients (to
    the CPU, for the ranks), and its step time (a second step, timed). The
    noise field is cut to the decoder's source length and kept for the
    ranks."""
    out = {}
    for case in PAR_CASES:
        kind, decoder, _, batch = case
        path = work / f"{decoder}-{batch}.pt"
        if not path.exists():
            x, f0, noise, rf0 = par_inputs(batch)
            torch.save({"x": x, "f0": f0, "noise": noise, "random_f0": rf0},
                       path)
        d = torch.load(path)
        task = par_model(decoder, d["x"], d["f0"])
        n = par_noise_len(task, d["x"], d["f0"])
        if n != d["noise"].shape[1]:
            d["noise"] = d["noise"][:, :n].contiguous()
            torch.save(d, path)
        x, f0, noise, rf0 = (d[k].cuda() for k in
                             ("x", "f0", "noise", "random_f0"))

        def step():
            for p in task.parameters():
                p.grad = None
            loss, _ = task.training_step(Sig(x, 1), Sig(f0, 1), noise=noise,
                                         random_f0=rf0)
            loss.backward()
            return loss.item()

        loss = step()
        grads = {n: p.grad.cpu() for n, p in task.named_parameters()
                 if p.requires_grad}
        torch.cuda.empty_cache()
        with torch.backends.cudnn.flags(enabled=False):
            loss_off = step()
        grads_off = {n: p.grad.cpu() for n, p in task.named_parameters()
                     if p.requires_grad}
        saved = {"loss": loss, "grads": grads, "loss_off": loss_off,
                 "grads_off": grads_off}
        f64 = None
        if decoder in PAR_BASELINES:
            # no kernel on their path: the same step in float64 arbitrates
            # the gradients whose float32 is itself off
            loss64, saved["grads64"] = par_float64_step(decoder, d)
            f64 = {"loss_rel": abs(loss - loss64) / abs(loss64),
                   "grad_err": grad_errors(grads, saved["grads64"]),
                   "grad_err_off": grad_errors(grads_off, saved["grads64"])}
            print(f"parallel {case_label(case)}: the single-process float32 "
                  f"step against its float64 step (cuDNN off): loss rel "
                  f"{f64['loss_rel']:.2e}, gradients {f64['grad_err']} "
                  f"(cuDNN off {f64['grad_err_off']})")
        torch.save(saved, work / f"ref-{case_label(case)}.pt")
        torch.cuda.empty_cache()
        _, secs = timed(step)
        out[case_label(case)] = {"loss": loss, "step_ms": secs * 1e3,
                                 "float64": f64}
        del task, grads, grads_off
        torch.cuda.empty_cache()
    return out


def sharded_kernel_rows() -> dict:
    """B4's initial-state entry, the summary entry and the re-run entry at
    the shards' shapes ((64, 24 000) a rank at 1 x 2, (16, 24 000) at
    2 x 2, and the (32, 24 000) of a 2 x 2 mesh at B = 64), each against
    its plain version and float64 (the summary also against its tree
    mirror, the re-run bit for bit against the zi entry), with its time,
    the earlier design's (tools/allpole_tv_pr15.cu) in turns and its bound,
    and a direction's summary + re-run against the earlier summary + zi
    entry; B2 on a GOLF-ff shard's frames (64 x 100 windows of 960,
    golf-v1's harmonic filter's too) against its plain version and
    float64; B1 and B3b at golf-v1's rank shapes against their plain
    versions."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 21)
    t_loc = int(PAR_SECONDS * SR) // 2
    rows = {}
    for b in (64, 32, 16):
        x = torch.randn((b, t_loc), generator=gen, device="cuda")
        a = tv_coeffs(gen, b, t_loc)
        zi = torch.randn((b, a.shape[2]), generator=gen, device="cuda")
        p = a.shape[2]
        chunk = tap.chunk_for(b, t_loc)
        y = allpole_cuda(x, a, zi)
        plain = allpole_stream_plain(x, a, zi)
        ref64 = allpole_scan(x.double(), a.double(), zi.double())
        errs = (rel_err(y, plain), rel_err(y.double(), ref64),
                rel_err(y, allpole_chunked_plain(x, a, zi=zi)))
        print(f"[sharded] allpole_tv (B4) zi entry {tuple(x.shape)} p={p} "
              f"at chunk_for's {chunk}: / max|y| {errs[0]:.3e} against "
              f"allpole_stream_plain (tolerance 1e-4), {errs[1]:.3e} "
              f"against a float64 scan from zi (tolerance 1e-5), "
              f"{errs[2]:.3e} against allpole_chunked_plain at that chunk "
              f"(tolerance 1e-5)")
        check(errs[0] <= 1e-4 and errs[1] <= 1e-5 and errs[2] <= 1e-5
              and torch.isfinite(y).all().item(), f"B4 zi at B={b}")
        m, v, maps = tap.allpole_summary_cuda(x, a)
        m32, v32 = tap.allpole_summary_plain(x, a)
        m64, v64 = tap.allpole_summary_plain(x.double(), a.double())
        # the kernel's algorithm in float64 on the card: every chunk's map,
        # composed as the kernel's tree
        mt, vt, maps_t = tap.allpole_summary_chunked_plain(x, a)
        y_re = tap.allpole_rerun_cuda(x, a, zi, maps)
        same = torch.equal(y_re, y)

        # over 24 000 steps M decays below float64's range (the state's
        # memory is short): a floor of 1e-30 keeps 0 / 0 out
        def rel0(u, r):
            return (u - r).abs().max().item() / max(r.abs().max().item(),
                                                    1e-30)
        e64 = max(rel0(m, m64), rel0(v, v64))
        e32 = max(rel0(m, m32.double()), rel0(v, v32.double()))
        e_tree = max(rel0(m, mt), rel0(v, vt), rel0(maps, maps_t))
        end = torch.flip(ref64[:, -p:], (1,))
        e_end = rel_err(torch.einsum("bij,bj->bi", m, zi.double()) + v, end)
        print(f"[sharded] allpole_tv_summary {tuple(x.shape)} p={p} at chunk "
              f"{chunk} ({maps.shape[1]} maps a row, a tree of "
              f"{tap.tree_group(p)} a group): M, v / max|ref| {e64:.3e} "
              f"against the plain version in float64 (tolerance 1e-9), "
              f"{e32:.3e} against it in float32 (tolerance 1e-3: that "
              f"form's own error), {e_tree:.3e} against the tree mirror "
              f"(allpole_summary_chunked_plain, float64, its maps too; "
              f"tolerance 1e-9); the map carries zi to the float64 scan's "
              f"end state within {e_end:.3e} (tolerance 1e-5); the re-run "
              f"from its maps == the zi entry bit for bit: {same}")
        check(e64 <= 1e-9 and e32 <= 1e-3 and e_end <= 1e-5
              and e_tree <= 1e-9, f"summary entry at B={b}")
        check(same, f"re-run from the summary's maps == zi entry at B={b}")

        def shard_direction():
            """A time rank's all-pole work a direction: summary, then the
            re-run from its maps (the exchange between them is gloo's)."""
            m_, v_, maps_ = tap.allpole_summary_cuda(x, a)
            return tap.allpole_rerun_cuda(x, a, zi, maps_)

        def shard_direction_earlier():
            earlier_summary(x, a)
            return earlier_tv(EARLIER_TV, x, a, zi)

        def turns(new, old, reps=20):
            t = [cuda_ms(old, reps), cuda_ms(new, reps), cuda_ms(new, reps),
                 cuda_ms(old, reps)]
            return (t[1] + t[2]) / 2, (t[0] + t[3]) / 2, t

        zi_ms, zi_old, zi_turns = turns(lambda: allpole_cuda(x, a, zi),
                                        lambda: earlier_tv(EARLIER_TV, x, a,
                                                           zi))
        su_ms, su_old, su_turns = turns(
            lambda: tap.allpole_summary_cuda(x, a),
            lambda: earlier_summary(x, a))
        dir_ms, dir_old, dir_turns = turns(shard_direction,
                                           shard_direction_earlier)
        n = x.numel()
        rows[f"allpole_tv/{b}"] = dict(
            err=(y - plain).abs().max().item(), err64=errs[1], ms=zi_ms,
            earlier_ms=zi_old, turns_ms=zi_turns, chunk=chunk,
            plain_ms=cuda_ms(lambda: allpole_stream_plain(x, a, zi), 1,
                             warmup=1, strict=False),
            bound=bound(4 * (2 * n + a.numel() + zi.numel()),
                        2 * a.numel()),
            shapes=[list(x.shape), list(a.shape), list(zi.shape)])
        rows[f"allpole_tv_summary/{b}"] = dict(
            err=max((m - m32.double()).abs().max().item(),
                    (v - v32.double()).abs().max().item()), err64=e64,
            err_tree=e_tree, ms=su_ms, earlier_ms=su_old, turns_ms=su_turns,
            chunk=chunk,
            plain_ms=cuda_ms(lambda: tap.allpole_summary_plain(x, a), 1,
                             warmup=1, strict=False),
            # x and a read once, M and v written; p (p + 1) float64 FMAs a
            # sample (the state map's p + 1 columns)
            bound=bound(4 * (n + a.numel()) + 8 * b * p * (p + 1),
                        2 * p * (p + 1) * n, fp64=True),
            shapes=[list(x.shape), list(a.shape)])
        rows[f"allpole_tv_rerun/{b}"] = dict(
            err=(y_re - plain).abs().max().item(), err64=errs[1],
            bit_for_bit_zi=same,
            ms=cuda_ms(lambda: tap.allpole_rerun_cuda(x, a, zi, maps), 20),
            chunk=chunk,
            plain_ms=cuda_ms(lambda: tap.allpole_rerun_plain(x, a, zi, maps),
                             1, warmup=1, strict=False),
            # x, a, zi and the maps read once, y written; p FMAs a sample
            bound=bound(4 * (2 * n + a.numel() + zi.numel())
                        + 8 * maps.numel(), 2 * a.numel()),
            shapes=[list(x.shape), list(a.shape), list(zi.shape),
                    list(maps.shape)],
            direction_ms=dir_ms, direction_earlier_ms=dir_old,
            direction_turns_ms=dir_turns)
        print(f"[sharded] ({b}, {t_loc}) a direction (summary + re-run): "
              f"{dir_ms * 1e3:.1f} us, before the redesign (summary + zi "
              f"entry, chunks of 512) {dir_old * 1e3:.1f} us; zi entry "
              f"{zi_ms * 1e3:.1f} us ({zi_old * 1e3:.1f}), summary "
              f"{su_ms * 1e3:.1f} us ({su_old * 1e3:.1f}); in turns, us: "
              f"{[round(u * 1e3, 1) for u in dir_turns]}, "
              f"{[round(u * 1e3, 1) for u in zi_turns]}, "
              f"{[round(u * 1e3, 1) for u in su_turns]}")
        del x, a, zi, y, y_re, plain, ref64, maps, maps_t
    n_ff = 64 * t_loc // 240
    x = torch.randn((n_ff, 960), generator=gen, device="cuda")
    a = lpc_coeffs(gen, (n_ff, 22), "cuda")
    out = allpole_const_cuda(x, a)
    ref = allpole_const_plain(x, a)
    errs = (rel_err(out, ref), rel_err(out, allpole_const_scan64(x, a)))
    print(f"[sharded] allpole_const (B2) on a GOLF-ff shard's frames "
          f"{tuple(x.shape)}: / max|y| {errs[0]:.3e} against "
          f"allpole_const_plain (tolerance 1e-5), {errs[1]:.3e} against "
          f"allpole_const_scan64 (tolerance 1e-6)")
    check(errs[0] <= 1e-5 and errs[1] <= 1e-6, "B2 at a shard's frames")
    rows["allpole_const"] = dict(
        err=(out - ref).abs().max().item(), err64=errs[1],
        ms=cuda_ms(lambda: allpole_const_cuda(x, a), 50),
        plain_ms=cuda_ms(lambda: allpole_const_plain(x, a), 3, strict=False),
        bound=bound(4 * (2 * x.numel() + a.numel()), 2 * a.shape[1]
                    * x.numel(), fp64=True),
        shapes=[list(x.shape), list(a.shape)])
    # B1 and B3b at golf-v1's rank shapes (its B2 is the row above)
    v1_shapes = v1_rank_shapes(64, t_loc)
    v1 = phase_kernels(v1_shapes, ("lookup", "lookup_dtab"),
                       label="sharded golf-v1")
    for name in ("lookup", "lookup_dtab"):
        rows[f"{name}/golf-v1"] = dict(
            v1[name], shapes=[list(s) for s in v1_shapes[name]])
    # grid_sample's backward with respect to the table, B3b's library call
    rows["lookup_dtab/golf-v1"]["library_ms"] = v1["lookup"].get(
        "dtab_library_ms")
    for name, r in rows.items():
        print(f"[sharded] {name} {r['shapes'][0]}: {r['ms'] * 1e3:.1f} us, "
              f"bound {r['bound'][0] * 1e3:.1f} us ({r['bound'][1]}), plain "
              f"{r['plain_ms'] * 1e3:.1f} us")
    return rows


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def par_nccl_world_one() -> dict:
    """``multihost.initialize`` on NCCL with a world of one (this process,
    the card): an all-reduce and a barrier through it, then the group is
    destroyed."""
    import torch.distributed as dist
    from golf_tpu_torch.parallel import multihost
    backend = multihost.initialize(
        "nccl", f"tcp://localhost:{free_port()}", world_size=1, rank=0)
    try:
        t = torch.arange(4.0, device="cuda")
        dist.all_reduce(t)
        multihost.sync_global_devices("nccl")
        ok = backend == "nccl" and dist.get_backend() == "nccl" and \
            torch.equal(t.cpu(), torch.arange(4.0))
        obj = multihost.broadcast_one_to_all({"run_dir": "runs/x"})
    finally:
        dist.destroy_process_group()
    print(f"parallel: NCCL initialize with a world of one: backend "
          f"{backend}, all-reduce and barrier ok {ok}, broadcast {obj}")
    check(ok, "NCCL world-of-one initialize")
    return {"backend": backend, "ok": ok}


def par_cli(work: Path) -> dict:
    """``autoencode_torch.py fit`` under ``torchrun --nproc_per_node=2`` on
    the card (gloo: two ranks share it), 3 steps of synthetic.yaml with
    golf.yaml at B = 8 x 1 s; rank 0 alone writes one checkpoint and the
    metrics."""
    run_dir = work / "cli"
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node=2", "autoencode_torch.py", "fit", "--config",
         "cfg/ae/synthetic.yaml", "--model", "cfg/ae/decoder/golf.yaml",
         "data.init_args.n_items=16", "data.init_args.duration=1.0",
         "data.init_args.batch_size=8", "trainer.max_steps=3",
         "--run_dir", str(run_dir)],
        cwd=Path(__file__).resolve().parent, capture_output=True, text=True,
        timeout=600, env={**__import__("os").environ, "OMP_NUM_THREADS": "2"})
    secs = time.perf_counter() - t0
    tail = (out.stdout + out.stderr)[-2000:]
    check(out.returncode == 0, f"torchrun fit exited {out.returncode}: "
          f"{tail}")
    vals = out.stdout.count("[val @ 3]")
    ckpts = sorted(p.name for p in (run_dir / "ckpt").iterdir())
    print(f"parallel: torchrun --nproc_per_node=2 autoencode_torch.py fit "
          f"(gloo on one card) 3 steps in {secs:.1f} s (startup included): "
          f"'[val @ 3]' printed {vals} time(s), checkpoints {ckpts}")
    check(vals == 1 and "last" in ckpts
          and sum(c.startswith("step=") for c in ckpts) == 1,
          "torchrun fit: one validation print, one checkpoint and last, "
          "from rank 0")
    return {"seconds": secs, "checkpoints": ckpts}


def par_pitchnet(work: Path) -> dict:
    """``tools/train_pitchnet_torch.py --steps 50`` on the card."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tools"))
    import train_pitchnet_torch
    res = train_pitchnet_torch.main(["--steps", "50", "--out",
                                     str(work / "pitchnet.msgpack")])
    check(np.isfinite(res["ms_per_step"]) and Path(res["out"]).exists(),
          "train_pitchnet_torch wrote its weights")
    w = pitchnet.load_model(res["out"], "cuda")
    check(all(torch.isfinite(p).all().item() for p in w.parameters()),
          "trained PitchNet reads back finite")
    return res


def phase_parallel() -> tuple:
    """Data-parallel and time-sharded training on the one card (see the
    module docstring); returns (the summed launches of the ranks' timed
    steps, the phase's JSON, the sharded kernel rows)."""
    import torch.multiprocessing as mp
    print("parallel: the ranks are processes spawned on the one card over "
          "gloo (NCCL refuses two ranks on one device); the tensors and "
          "every kernel stay on the card, and gloo carries the collectives' "
          "CUDA tensors through the host. Every time below is gloo on one "
          "card: it is no measure of NCCL on several cards.")
    rows = sharded_kernel_rows()
    Path("runs").mkdir(exist_ok=True)
    tmp = tempfile.TemporaryDirectory(prefix="parallel_", dir="runs")
    work = Path(tmp.name)
    t0 = time.perf_counter()
    refs = par_references(work)
    t_ref = time.perf_counter() - t0
    torch.cuda.empty_cache()
    world = max(d * t for _, _, (d, t), _ in PAR_CASES)
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=par_rank, args=(r, world,
                                                str(work / "store"),
                                                str(work), queue))
             for r in range(world)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    results = {}
    try:
        for _ in range(world):
            rank, out = queue.get(timeout=900)
            check(not isinstance(out, str), f"parallel rank {rank}: {out}")
            results[rank] = out
    finally:
        for p in procs:
            p.join(timeout=120)
            if p.is_alive():
                p.kill()
    t_ranks = time.perf_counter() - t0
    check(all(p.exitcode == 0 for p in procs),
          f"parallel ranks' exit codes {[p.exitcode for p in procs]}")
    counts = {k.name: 0 for k in DSP_KERNELS}
    report = {}
    for case in PAR_CASES:
        kind, decoder, (d, t), batch = case
        label = case_label(case)
        ranks = [results[r][label] for r in range(d * t)]
        path = PAR_PATHS[(kind, decoder)]
        for r, res in enumerate(ranks):
            print(f"parallel {label} rank {r} (gloo): loss {res['loss']:.6f} "
                  f"vs single-process {res['loss_ref']:.6f} (rel "
                  f"{res['loss_rel']:.2e}, tolerance {PAR_LOSS_TOL}); "
                  f"gradients {res['grad_err']:.2e} of max-abs at "
                  f"{res['grad_err_at']}, {res['grad_err_no_pyramid']:.2e} "
                  f"outside the conv pyramid at "
                  f"{res['grad_err_no_pyramid_at']} (tolerance "
                  f"{PAR_GRAD_TOL}); with cuDNN off on both sides loss rel "
                  f"{res['loss_rel_off']:.2e}, gradients "
                  f"{res['grad_err_off']:.2e} at {res['grad_err_off_at']} "
                  f"(tolerance {PAR_GRAD_TOL}); step {res['step_ms']:.1f} "
                  f"ms, held before it {res['held_gib']:.2f} GiB, peak "
                  f"{res['peak_gib']:.2f} GiB; launches {res['counts']}")
            # cuDNN picks a convolution algorithm by shape and by the free
            # memory (which the co-tenant ranks change), so a rank's conv
            # pyramid sums in another order than the single process's: the
            # pyramid is held with cuDNN off on both sides, where only the
            # order of the batch sums differs
            # a gradient beyond the tolerance passes only where the
            # float64 step clears it (the baselines, no kernel on their
            # path); every other case has no float64 step to clear it
            bs = beyond_summary(res["beyond"] + res["beyond_off"])
            if bs["n"]:
                print(f"parallel {label} rank {r}: {bs['n']} gradients "
                      f"(both cuDNN settings) beyond {PAR_GRAD_TOL} of the "
                      f"single-process step, the worst {bs['worst']} "
                      f"{bs['err']:.2e}; against the float64 step each "
                      f"within {bs['max_ratio_vs_float64']} times the "
                      f"single-process float32 step's own distance "
                      f"(cleared at <= 2): {bs['cleared']}")
            check(res["loss_rel"] <= PAR_LOSS_TOL
                  and res["loss_rel_off"] <= PAR_LOSS_TOL and bs["cleared"],
                  f"{label} rank {r} vs the single-process step")
            for name in path:
                check(res["counts"][name] >= 1,
                      f"{label} rank {r} launched {name}")
            if not path:
                check(not any(res["counts"].values()),
                      f"{label} rank {r} launched no kernel: "
                      f"{res['counts']}")
            for name, n in res["counts"].items():
                counts[name] += n
        if kind == "time" and decoder == "golf-precise":
            b_loc = batch // d
            t_loc = int(PAR_SECONDS * SR) // t
            want = [[b_loc, t_loc], [b_loc, t_loc, 22]]
            check(all(want in res["shapes"]["allpole_tv_rerun"]
                      and want in res["shapes"]["allpole_tv_summary"]
                      for res in ranks),
                  f"{label}: the summary and the re-run at {want}")
            # phase 1 once a direction: the summary (phase 1 and the tree)
            # and the re-run from its maps once each in the forward and in
            # the backward, and neither B4 entry that runs its own phase 1
            once = [{name: res["counts"][name] for name in (
                "allpole_tv_summary", "allpole_tv_rerun", "allpole_tv",
                "allpole_tv_adjoint")} for res in ranks]
            print(f"parallel {label}: B4's launches a rank step "
                  f"{once} (phase 1 runs in the summary alone: once a "
                  f"direction)")
            check(all(c == {"allpole_tv_summary": 2, "allpole_tv_rerun": 2,
                            "allpole_tv": 0, "allpole_tv_adjoint": 0}
                      for c in once),
                  f"{label}: phase 1 once a direction")
        if decoder == "golf-v1":
            want = v1_rank_shapes(batch // d, int(PAR_SECONDS * SR) // t)
            for name, shape in want.items():
                shape = [list(s) for s in shape]
                check(all(shape in res["shapes"][name] for res in ranks),
                      f"{label}: {name} at {shape} on every rank "
                      f"({[res['shapes'].get(name) for res in ranks]})")
        report[label] = {
            "backend": "gloo, one card", "ranks": d * t,
            "step_ms": [res["step_ms"] for res in ranks],
            "single_process_step_ms": refs[label]["step_ms"],
            "loss_rel": max(res["loss_rel"] for res in ranks),
            "grad_err": max(res["grad_err"] for res in ranks),
            "grad_err_no_pyramid": max(res["grad_err_no_pyramid"]
                                       for res in ranks),
            "grad_err_cudnn_off": max(res["grad_err_off"] for res in ranks),
            "beyond_tolerance": [beyond_summary(res["beyond"]
                                                + res["beyond_off"])
                                 for res in ranks],
            "single_process_vs_float64": refs[label]["float64"],
            "peak_gib": [res["peak_gib"] for res in ranks],
            "launches_per_rank": [res["counts"] for res in ranks]}
    nccl = par_nccl_world_one()
    cli_res = par_cli(work)
    t0 = time.perf_counter()
    pn = par_pitchnet(work)
    pn["seconds"] = time.perf_counter() - t0
    print(f"parallel: references {t_ref:.1f} s, ranks {t_ranks:.1f} s "
          f"(spawn, build binding and every case)")
    tmp.cleanup()
    return counts, {"cases": report, "nccl_world_one": nccl, "cli": cli_res,
                    "train_pitchnet": pn, "references_s": t_ref,
                    "ranks_s": t_ranks}, rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    phase_s = {}

    def done(name: str, t0: float) -> float:
        phase_s[name] = time.perf_counter() - t0
        print(f"phase {name}: {phase_s[name]:.1f} s", flush=True)
        return time.perf_counter()

    card = phase_environment()
    phase_build()
    t0 = done("build", t_start)
    serve_shapes = main_path_shapes(BATCH, int(SECONDS * SR))
    train_shapes = main_path_shapes(TRAIN_BATCH, int(TRAIN_SECONDS * SR))
    serve_rows = phase_kernels(serve_shapes)
    rows = phase_kernels(train_shapes, [k.name for k in DSP_KERNELS],
                         label="train")
    push_rows = phase_kernels(stream_shapes(BATCH), ("lookup",),
                              label="push")
    voc_shapes = vocoder_shapes(BATCH, int(SECONDS * SR), train=False)
    voc_rows = phase_kernels(voc_shapes, ("lookup", "allpole_const"),
                             label="vocoder serve")
    lpc_row = phase_kernels_lpcnet()
    print_lookup_summary({"push": push_rows["lookup"],
                          "serve": serve_rows["lookup"],
                          "train": rows["lookup"]})
    pyr_rows = phase_pyramid()
    phase_backward(train_shapes)
    phase_resonance()
    t0 = done("kernels", t0)
    counts = {k.name: 0 for k in DSP_KERNELS}

    def add(c: dict) -> dict:
        for name, n in c.items():
            counts[name] += n
        return c

    for decoder in ("golf", "golf-precise"):
        add(phase_serve(decoder, serve_shapes)[0])
    t0 = done("serve", t0)
    for decoder in ("golf", "golf-precise"):
        add(phase_train(decoder, train_shapes)[0])
        phase_train_vs_cpu(decoder)
    t0 = done("train", t0)
    add(phase_train_f0())
    t0 = done("train_f0", t0)
    stream_rows = phase_stream_kernels()
    stream_counts = add(phase_stream(stream_shapes(BATCH)))
    t0 = done("stream", t0)
    for decoder in ("golf", "golf-precise"):
        add(phase_test(decoder))
    t0 = done("test", t0)
    Path("runs").mkdir(exist_ok=True)
    # the VCTK tree of phase disk, kept for phase tools
    disk_tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_", dir="runs")
    tmp = disk_tmp.name
    tree, out = Path(tmp) / "vctk", Path(tmp) / "runs"
    sizes = write_vctk_tree(tree)
    print(f"disk: a VCTK tree of {sizes} segments of 2 s at overlap 1.5")
    disk_counts, ckpt, disk_probe = phase_disk(tree, out)
    add(disk_counts)
    t0 = done("disk", t0)
    fs_counts, fs = phase_fs(tree, ckpt, out)
    add(fs_counts)
    t0 = done("fs", t0)
    ft_counts, ft_probe = phase_finetune(tree, ckpt, out)
    add(ft_counts)
    t0 = done("finetune", t0)
    base_counts, baselines = phase_baselines()
    add(base_counts)
    cli_counts, baselines["cli"] = phase_baselines_cli(tree, out)
    add(cli_counts)
    t0 = done("baselines", t0)
    pw_counts, pyworld = phase_pyworld(tree, out)
    add(pw_counts)
    t0 = done("pyworld", t0)
    voc_counts, vocoder = phase_vocoder()
    add(voc_counts)
    t0 = done("vocoder", t0)
    lpc_counts, lpcnet = phase_lpcnet()
    add(lpc_counts)
    t0 = done("lpcnet", t0)
    opt_counts, options, opt_rows = phase_options()
    add(opt_counts)
    t0 = done("options", t0)
    var_counts, variants, var_rows = phase_variants()
    add(var_counts)
    t0 = done("variants", t0)
    rtf_shapes = main_path_shapes(1, int(TOOLS_SECONDS * SR))
    tools_counts, tools, rtf_rows, rtf_counts, p26_row, l2_rows = \
        phase_tools(tree, out / "tools", rtf_shapes, out / "ff")
    add(tools_counts)
    disk_tmp.cleanup()
    t0 = done("tools", t0)
    par_counts, parallel, par_rows = phase_parallel()
    add(par_counts)
    t0 = done("parallel", t0)
    parallel["phase_s"] = phase_s["parallel"]
    print(json.dumps({"parallel": {**parallel, "launches": par_counts}}))
    for name in ("allpole_tv_summary", "allpole_tv_rerun"):
        rows[name] = par_rows[f"{name}/64"]
        train_shapes[name] = tuple(
            tuple(s) for s in par_rows[f"{name}/64"]["shapes"])
    print(json.dumps({"recipe": {
        "disk_fit_step_ms": [t * 1e3 for t in disk_probe.times],
        "golf_fs": fs,
        "finetune_step_ms": [t * 1e3 for t in ft_probe.times],
        "phase_s": phase_s}}))
    print(json.dumps({"vocoder": {**vocoder, "launches": voc_counts}}))
    print(json.dumps({"baselines": {**baselines, "launches": {
        name: base_counts[name] + cli_counts[name] for name in base_counts}}}))
    print(json.dumps({"lpcnet": {**lpcnet, "launches": lpc_counts}}))
    print(json.dumps({"pyworld": {**pyworld, "launches": pw_counts}}))
    print(json.dumps({"tools": {**tools, "launches": tools_counts}}))

    replaces = {"lookup": "golf_tpu/ops/lookup_pallas.py:107",
                "lookup_res": "golf_tpu/ops/lookup_pallas.py:222",
                "lookup_dtab": "golf_tpu/ops/lookup_pallas.py:128",
                "allpole_const": "golf_tpu/ops/allpole_pallas.py:89",
                # run by golf_tpu's VJP on the reversed cotangent
                # (allpole.py:400), with the shifted dots at allpole.py:403
                "allpole_const_adjoint": "golf_tpu/ops/allpole_pallas.py:89",
                "allpole_tv": "golf_tpu/ops/allpole_pallas.py:33",
                "allpole_tv_adjoint": "golf_tpu/ops/allpole_pallas.py:33",
                # no Pallas kernel: XLA's scan in golf_tpu
                "allpole_tv_summary": "golf_tpu/parallel/seqpar.py:338",
                # the shard's filter from its incoming state, which
                # golf_tpu runs as _allpole_impl (allpole_pallas where its
                # dispatch picks it)
                "allpole_tv_rerun": "golf_tpu/parallel/seqpar.py:397"}
    table = []
    for k in DSP_KERNELS:
        r = rows[k.name]
        entry = {
            "name": k.name, "route": "cuda",
            "source": f"golf_tpu_torch/kernels/csrc/{k.source}",
            "replaces": replaces[k.name], "launches": counts[k.name],
            "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
            "library_ms": r.get("library_ms"),
            "shapes": [list(s) for s in train_shapes[k.name]]}
        if k.name == "lookup_dtab":
            entry["library_ms"] = rows["lookup"]["dtab_library_ms"]
            entry["library"] = ("grid_sample's backward, table only "
                                "(grid_sampler_2d_backward)")
            entry["library_err"] = rows["lookup"]["dtab_library_err"]
        elif k.name == "lookup":
            entry["library"] = ("F.grid_sample, bilinear, align_corners, "
                                "the table padded with its first column")
            entry["library_err"] = r["library_err"]
        elif k.name == "lookup_res":
            entry["library_note"] = (
                "null: no one PyTorch call returns the lookup with its two "
                "corner differences")
        if k.name == "allpole_const_adjoint":
            entry["also_replaces"] = "golf_tpu/ops/allpole.py:403-404"
        if k.name in ("allpole_tv_summary", "allpole_tv_rerun"):
            entry["shapes_note"] = ("a rank's window at 1 x 2, B = 64 x 2 s; "
                                    "launches: the parallel phase's timed "
                                    "steps, every rank")
            entry["err64"] = r["err64"]
        for key in ("chunk", "earlier_ms", "turns_ms", "err_tree",
                    "bit_for_bit_zi", "direction_ms", "direction_earlier_ms",
                    "direction_turns_ms"):
            if key in r:
                entry[key] = r[key]
        if "earlier_ms" in r and k.name.startswith("allpole_tv"):
            entry["earlier"] = ("tools/allpole_tv_pr15.cu (chunks of 512, "
                                "the summary's serial composition), timed "
                                "in this run in turns")
        # the shards' shapes (phase parallel): B4's zi entry and the
        # summary at (64|32|16, 24000), B2 on a GOLF-ff (and golf-v1)
        # shard's frames, B1 and B3b on a golf-v1 rank's window
        sharded = {key.split("/")[1]: row for key, row in par_rows.items()
                   if "/" in key and key.split("/")[0] == k.name}
        if k.name == "allpole_const":
            sharded = {"frames": par_rows["allpole_const"]}
        if sharded:
            entry["sharded"] = {
                b: {"shapes": row["shapes"], "max_abs_err": row["err"],
                    "err_vs_float64": row.get("err64"), "ms": row["ms"],
                    "plain_ms": row["plain_ms"], "bound_ms": row["bound"][0],
                    "bound_by": row["bound"][1],
                    "library_ms": row.get("library_ms"),
                    **{key: row[key] for key in (
                        "chunk", "earlier_ms", "turns_ms", "err_tree",
                        "bit_for_bit_zi", "direction_ms",
                        "direction_earlier_ms", "direction_turns_ms")
                       if key in row}}
                for b, row in sharded.items()}
            entry["sharded_launches_per_rank_step"] = {
                label: case["launches_per_rank"][0][k.name]
                for label, case in parallel["cases"].items()}
        if k.name in ("lookup", "lookup_res"):
            entry["split"] = r["split"]
            entry["earlier_ms"] = r["earlier_ms"]
            entry["earlier"] = ("one CTA a (batch, block), "
                                "tools/lookup_unsplit.cu, timed in this run")
        if "floor_ms" in r:
            entry["floor_ms"] = r["floor_ms"]
        for key in ("fp64_floor_ms", "composite_ms"):
            if key in r:
                entry[key] = r[key]
        stream_row = stream_rows.get(
            "allpole_tv/4" if k.name == "allpole_tv" else k.name)
        if stream_row is not None:
            entry["stream"] = {
                "shapes": stream_row["shapes"],
                "launches": stream_counts[k.name],
                "launches_per_push": stream_counts[k.name]
                / (SECONDS * SR // STREAM_CHUNK),
                "max_abs_err": stream_row["err"], "ms": stream_row["ms"],
                "plain_ms": stream_row["plain_ms"],
                "bound_ms": stream_row["bound"][0],
                "bound_by": stream_row["bound"][1],
                "library_ms": stream_row.get("library_ms")}
            for key in ("split", "floor_ms", "earlier_ms"):
                if key in stream_row:
                    entry["stream"][key] = stream_row[key]
            if k.name == "allpole_tv":
                r1 = stream_rows["allpole_tv/1"]
                entry["stream"]["b1"] = {
                    "shapes": r1["shapes"], "ms": r1["ms"],
                    "plain_ms": r1["plain_ms"], "bound_ms": r1["bound"][0],
                    "earlier_ms": r1["earlier_ms"], "chunk": r1["chunk"],
                    "turns_ms": r1["turns_ms"]}
                for key in ("chunk", "turns_ms", "err64"):
                    entry["stream"][key] = stream_row[key]
        voc_name = "allpole_const" if k.name == "allpole_const_adjoint" \
            else k.name
        if voc_name in voc_shapes:
            vr = voc_rows[k.name]
            entry["vocoder_serve"] = {
                "shapes": [list(s) for s in voc_shapes[voc_name]],
                "launches": voc_counts[k.name], "max_abs_err": vr["err"],
                "ms": vr["ms"], "plain_ms": vr["plain_ms"],
                "bound_ms": vr["bound"][0],
                "library_ms": vr.get("library_ms")}
        if k.name in ("allpole_const", "allpole_const_adjoint"):
            # B2 at the options' shapes: the allpass room filter's lfilter
            # (training, serving) and the biquad cascade
            for key, row in opt_rows.items():
                if key.endswith("_adjoint") == (k.name ==
                                                "allpole_const_adjoint"):
                    entry[key.replace("_adjoint", "")] = row
        for key, by_kernel in var_rows.items():
            # B1, B3a and B3b at the weighted wavetables' shapes
            if k.name in by_kernel:
                entry[key] = by_kernel[k.name]
        if k.name in ("lookup", "allpole_const", "allpole_tv"):
            # test_rtf_torch's synthesis of one 6 s clip (phase tools)
            rr = rtf_rows[k.name]
            entry["rtf"] = {
                "shapes": [list(s) for s in rtf_shapes[k.name]],
                "launches": sum(c[k.name] for c in rtf_counts.values()),
                "launches_per_synthesis": 1,
                "max_abs_err": rr["err"], "ms": rr["ms"],
                "plain_ms": rr["plain_ms"], "bound_ms": rr["bound"][0],
                "bound_by": rr["bound"][1],
                "library_ms": rr.get("library_ms")}
        if k.name in l2_rows:
            # tools/time_l2_torch.py on a 2 s item (phase tools)
            lr = l2_rows[k.name]
            entry["time_l2"] = {
                "shapes": lr["shapes"], "launches": lr["launches"],
                "launches_per_iteration": lr["launches_per_iteration"],
                "max_abs_err": lr["err"], "ms": lr["ms"],
                "plain_ms": lr["plain_ms"], "bound_ms": lr["bound"][0],
                "bound_by": lr["bound"][1],
                "library_ms": lr.get("library_ms")}
        if k.name == "allpole_const":
            entry["lpcnet"] = {
                "shapes": lpc_row["shapes"],
                "launches": lpc_counts[k.name],
                "max_abs_err": lpc_row["err"],
                "err_vs_scan64": lpc_row["rel64"], "ms": lpc_row["ms"],
                "plain_ms": lpc_row["plain_ms"],
                "bound_ms": lpc_row["bound"][0],
                "bound_by": lpc_row["bound"][1], "library_ms": None}
        if k.name in serve_rows:
            sr_ = serve_rows[k.name]
            entry["serve"] = {
                "shapes": [list(s) for s in serve_shapes[k.name]],
                "max_abs_err": sr_["err"], "ms": sr_["ms"],
                "plain_ms": sr_["plain_ms"], "bound_ms": sr_["bound"][0]}
            for key in ("fp64_floor_ms", "composite_ms", "library_ms",
                        "split", "floor_ms", "earlier_ms"):
                if key in sr_:
                    entry["serve"][key] = sr_[key]
        table.append(entry)
    # P1, its two entries over the recipe's four pyramid stages: times
    # and bounds summed over the stages (one forward), each stage's row
    for k, key in ((kernels.PYRAMID_CONV, "conv"),
                   (kernels.PYRAMID_CONV_EVAL, "eval")):
        def total(field):
            return sum(r[key][field] for r in pyr_rows)
        table.append({
            "name": k.name, "route": "cuda",
            "source": f"golf_tpu_torch/kernels/csrc/{k.source}",
            "replaces": ("no Pallas site: golf_tpu/models/unet.py "
                         "ConvPyramid's flax Conv under XLA"),
            "launches": k.launches,
            "max_abs_err": max(r[key]["err"] for r in pyr_rows),
            "ms": total("ms"), "plain_ms": total("plain_ms"),
            "bound_ms": sum(r[key]["bound"][0] for r in pyr_rows),
            "bound_by": "operations (stage 1: bytes)",
            "library_ms": sum(r["library_ms"] for r in pyr_rows),
            "library": "F.conv2d under cuDNN's heuristics, TF32 off",
            "library_benchmark_ms": sum(r["library_benchmark_ms"]
                                        for r in pyr_rows),
            "shapes": [r["shapes"] for r in pyr_rows],
            "stages": [{"shapes": r["shapes"], **r[key],
                        "plan": r["plan" if key == "conv" else "plan_eval"],
                        "library_ms": r["library_ms"],
                        "library_benchmark_ms": r["library_benchmark_ms"]}
                       for r in pyr_rows],
            "note": ("the recipe's four stages at B = 64 x 2 s, summed; "
                     "launches: the run's")})
    # B4's generic-order instantiation (every p but 22), on
    # tools/lpc_anchor_torch.py's one row at p = 26 (phase tools)
    table.append({
        "name": "allpole_tv_p26", "route": "cuda",
        "source": "golf_tpu_torch/kernels/csrc/allpole_tv.cu",
        "replaces": replaces["allpole_tv"], "launches": p26_row["launches"],
        "max_abs_err": p26_row["err"], "ms": p26_row["ms"],
        "plain_ms": p26_row["plain_ms"], "bound_ms": p26_row["bound"][0],
        "bound_by": p26_row["bound"][1], "library_ms": None,
        "shapes": p26_row["shapes"], "chunk": p26_row["chunk"],
        "err_vs_float64": p26_row["err64"],
        "plain_err_vs_float64": p26_row["plain_err64"],
        "p22_ms": p26_row["p22_ms"],
        "note": ("max_abs_err against allpole_chunked_plain; launches: "
                 "one lpc_anchor_torch run, one an utterance; p22_ms: the "
                 "p = 22 instantiation on a row of the same length")})

    def composite_note(e):
        note = ""
        if e.get("composite_ms") is not None:
            note += f", composite {e['composite_ms'] * 1e3:.1f} us"
        if e.get("library_ms") is not None:
            note += f", library {e['library_ms'] * 1e3:.1f} us"
        return note

    def serve_note(e):
        note = ""
        if "serve" in e:
            sv = e["serve"]
            note = (f"; serving shapes {sv['ms'] * 1e3:.1f} us, bound "
                    f"{sv['bound_ms'] * 1e3:.1f} us, plain "
                    f"{sv['plain_ms'] * 1e3:.1f} us" + composite_note(sv))
        for key in ("lfilter_train", "lfilter_serve", "cascade_p2",
                    "weighted_ds", "weighted", "rtf", "time_l2"):
            if key in e:
                r = e[key]
                shape = f"p={r['shapes'][1][1]}" if key.startswith(
                    ("lfilter", "cascade")) else f"x {tuple(r['shapes'][1])}"
                note += (f"; {key} {tuple(r['shapes'][0])} {shape} "
                         f"{r['ms'] * 1e3:.1f} us, bound "
                         f"{r['bound_ms'] * 1e3:.2f} us, plain "
                         f"{r['plain_ms'] * 1e3:.1f} us, {r['launches']} "
                         f"launches")
        if "lpcnet" in e:
            lp = e["lpcnet"]
            note += (f"; LPCNet de-emphasis {lp['ms'] * 1e3:.1f} us, bound "
                     f"{lp['bound_ms'] * 1e3:.2f} us, plain "
                     f"{lp['plain_ms'] * 1e3:.1f} us, {lp['launches']} "
                     f"launches")
        if "stream" in e:
            st = e["stream"]
            note += (f"; stream push {st['ms'] * 1e3:.2f} us, bound "
                     f"{st['bound_ms'] * 1e3:.3f} us, plain "
                     f"{st['plain_ms'] * 1e3:.1f} us{composite_note(st)}, "
                     f"{st['launches_per_push']:g} a push")
        return note

    print("kernels: [" + "; ".join(
        f"{e['name']}: launches {e['launches']}, {e['ms'] * 1e3:.1f} us, "
        f"bound {e['bound_ms'] * 1e3:.1f} us ({e['bound_by']}), plain "
        f"{e['plain_ms'] * 1e3:.1f} us{composite_note(e)} "
        f"({'lpc_anchor' if 'note' in e else 'training'} shapes)"
        f"{serve_note(e)}"
        for e in table) + "]")
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s")
    print(f"card: {card}")
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
