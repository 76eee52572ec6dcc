#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (deeplearning4j_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card (an H100 for the sm_90a kernels) and nvcc; builds the
port's kernels from csrc/ on first use, one nvcc per source, in parallel.
Phases, each printing JSON lines:

1. device — the import rule (an AST walk: no module of the port, the
   data-parallel package's and the Keras import's included, and not
   this script imports JAX, the JAX package or h5py), the card's name and power limit (nvidia-smi), torch
   and CUDA
   versions, kernel build time, and the registers and spills ptxas
   reports for K4, K5 and K6 at each head-dim template (32, 64, 128, 256
   and the wide one) and for K1, K2 and K3 at each body (streaming,
   resident); no spill allowed;
2. kernels — the flash-attention forward kernel (K4, tensor cores in
   3xTF32) against its plain PyTorch version on the card in sixteen cases
   (the slice's shape, ragged T with a row that has no valid key, D = 8,
   32, 128 and 256, bf16, half the keys masked, padded rows whose whole
   key tiles are skipped; heads of 320, 512 and 1024 on the wide
   template), two launches bitwise equal, with kernel / plain / SDPA
   times and the card's bound at the tensor cores' peak and at the f32
   CUDA-core peak; the backward kernels (K5 dq, K6 dk/dv, tensor cores in
   3xTF32) against the plain FA2 backward in the same five cases, a sixth
   with padded rows (lengths 64-256: whole key tiles skipped, their dk/dv
   exactly 0), head dim 256 (f32 masked and not, bf16) and the wide
   template's four cases, with exact zero grads for rows with no valid
   key, two launches bitwise equal, kernel / plain / SDPA-backward times,
   and bounds at the tensor cores' peak and at the f32 CUDA-core peak;
   the LSTM recurrence kernel (K1) against its plain version in nine
   cases (the char-RNN's shape, ragged sizes with a carry, the T=1
   streaming step at 32 rows and at 1, bf16 over 64 steps, also held step
   by step, no peepholes, the resident body's widest H in f32 and bf16
   and the first H past it), two launches bitwise equal, each record
   naming the body and cluster shape the library runs (resident up to
   ``RESIDENT_MAX_HIDDEN``), with kernel / plain / cuDNN LSTM times and
   the bound at the tensor cores' peak (3xTF32 for f32) and at the f32
   CUDA-core peak the kernel runs at;
   the LSTM training kernels (K2 forward with residuals, K3 reverse-time
   backward) against their plain versions in ten cases (the char-RNN's
   tBPTT window, ragged sizes with carries and backward seeds, the short
   last window, bf16, no peepholes, the widest H, the resident bodies'
   widest H and the first past it in f32, and K3's in bf16, where its
   limit is below K2's), K2's hs and c_T equal to K1's bit for bit and
   two launches of each bitwise equal, each record naming the body K2
   and K3 run (resident up to ``RESIDENT_MAX_HIDDEN`` and
   ``BWD_RESIDENT_MAX_HIDDEN``), with kernel / plain / cuDNN
   training-LSTM times and the bounds at the window's shape;
3. slice — the full-width GPT decoder (vocab 96, T 256, d_model 512,
   8 heads, 8 layers, f32, seeded random weights) on the card through
   ``ComputationGraph.output`` (with and without a key mask) and
   ``greedy_generate``, checked against the same net on the CPU, with
   its times and a torch.profiler breakdown of one forward and of 16
   decode steps;
4. lstm slice — the char-RNN (``char_rnn_lstm(96, 256, 2)``: two
   GravesLSTMs of 256, f32, seeded random weights) on the card through
   ``MultiLayerNetwork.output`` (with and without a mask) and
   ``rnn_time_step`` over a [32, 64, 96] batch, checked against the same
   net on the CPU and the stream against the whole-sequence output, with
   its times and a torch.profiler breakdown of one output() and of 16
   streaming steps (each trace must hold the path's kernel launches);
5. train slice — the same full-width GPT trained on the card
   (``ComputationGraph.fit_batch``, Adam at lr 3e-4) on ``char_lm_batches``
   of ``synthetic_char_text`` over a 96-symbol charset, [32, 256] batches:
   the step-1 loss and every parameter's gradient against the same net on
   the CPU, then 2 more steps' losses, the exact K4/K5/K6 launches per
   step, a loss that falls over 20 steps, ms per step and tokens/s, the
   peak memory, the updater's time, and a torch.profiler breakdown of one
   step (kernel, GEMM and attention shares);
6. lstm train slice — the full-width char-RNN trained on the card with
   its own settings (``MultiLayerNetwork.fit_batch``: Adam at lr 1e-3,
   elementwise clipping at 1.0, tBPTT 50/50) on ``char_lm_batches`` of
   ``synthetic_char_text``, [32, 200] batches (4 windows, 4 optimizer
   steps): the first window's loss and every gradient against the same
   net on the CPU, one ``fit_batch``'s 4 window losses against the CPU's,
   the exact K2/K3 launches (8 each per [32, 200] batch, 4 per [32, 64]),
   a ``tbptt_bwd_length = 20`` net whose window heads launch K1, a mean
   loss that falls over 20 calls, ms per batch and window, characters/s,
   the peak memory, the updater's time and a torch.profiler breakdown of
   one ``fit_batch`` (K2+K3 and GEMM shares);
7. wide-head slices — a GPT with heads of 256, the kernels' widest
   register template (d_model 512 over 2 heads, 2 layers), and one with
   heads of 512, their wide template (d_model 1024 over 2 heads, 2
   layers), each through ``output()`` (with and without a key mask), one
   gradient and two ``fit_batch`` calls on the card: the exact K4, K5 and
   K6 launches, the probabilities within 1e-4 of the same net on the CPU,
   every gradient within 1e-4 of its largest |g|, the first loss within
   1e-5 and the second (after an Adam step) within 1e-4, relative;
8. cnn slice — the CNN classifiers on the card, through the containers'
   entry points, each against the same net on the CPU: LeNet-5
   (``lenet_mnist()``, Adam at lr 1e-3) on [64, 28, 28, 1] batches of the
   MNIST stand-in (the step-1 loss; every gradient against the CPU's f64
   one; the next two losses, a loss that falls over 50 steps,
   ``evaluate()`` on 1,024 unseen training-split examples above 0.5
   accuracy, ms per step and images/s); VGG-16-CIFAR
   (``vgg16_cifar10()``, f32) on one [64, 32, 32, 3] batch (``output()``,
   one gradient and ``fit_batch``, ms per ``output()`` and per step);
   ResNet-50 (224x224x3, 1000 classes): an f32 twin at batch 4 (the
   step-1 loss; the loss, gradients and BN states run in f64 on the card
   against the same on the CPU; the f32 gradients and BN states against
   the f64 ones; ``output()`` after a Nesterov step), then the config as
   users get it (bf16, Nesterov at lr 0.1) and
   the same in f32 at [64, 224, 224, 3]: ``output()`` and 20
   ``fit_batch`` calls on a fixed batch with a falling loss, images/s for
   serving and training, ms per step, the peak memory, the updater's
   time and a torch.profiler breakdown of one bf16 step (convolution,
   batch norm and layout-transpose shares). No kernel of K1-K6 is
   launched on this path;
9. serve engine — the full-width GPT behind the token-level serving
   engine (``GenerationScheduler(max_rows=8)``: continuous batching over
   a block-paged KV pool of 64-token pages, a CUDA graph per prefill and
   decode bucket): 16 requests (prompts of 5-128 tokens, 32 new tokens,
   4 sampled, two sharing a 64-token prefix page, an ``evict_page``
   fault mid-wave) from 16 staggered threads, then the same 16 again,
   and one request whose 140 new tokens let an ``evict_page`` fault drop
   a page it then replays. Every request's tokens against its singleton
   ``greedy_generate`` / ``sample_generate`` on the card, 2 of them
   against the same engine on the CPU; the shared prefix page mapped
   once; no capture in the second wave; each decode bucket's graph (1,
   2, 4, 8 rows) and one prefill bucket's against the eager step from
   the same state, bit for bit; the same 8 rows decoded in buckets of
   1, 2, 4 and 8 (bitwise or not, max |dprob|); tokens/s and time to
   first token per wave, captures per bucket, the graphs' and the
   pool's bytes, and graphed against eager decode ms per step at 1, 2,
   4 and 8 rows (host time, in turns) with their kernels, host launches
   and busy share from torch.profiler. No kernel of K1-K6 is launched on
   this path;
10. checkpoint — ``ModelSerializer`` zip archives on the card: the
   full-width GPT (3 ``fit_batch`` calls of [32, 256], Adam), the
   char-RNN (3 tBPTT ``fit_batch`` calls of [32, 200]) and the f32
   ResNet-50 at batch 4 (one Nesterov step; archived without its updater
   state, which the source then restarts) are written, verified and
   restored with ``restore_model`` (``device=None``: onto the card); the
   restored params, layer states and updater leaves equal the source's
   bit for bit, ``output()`` and the next ``fit_batch`` (loss and params)
   too (ResNet-50's with cuDNN in deterministic mode), and the restored
   GPT and char-RNN launch K4/K5/K6 and K1/K2/K3 exactly as often as the
   nets they were written from; a served GPT reloaded with
   ``restore_weights`` between two waves of the serving engine answers
   new prompts with the restored net's singleton tokens, and the
   re-captures that causes are counted; a truncated ``coefficients.bin``
   and a flipped byte in ``updaterState.bin`` of the full-width
   char-RNN's archive each raise ``CheckpointError`` naming the member. Archive
   bytes (raw and compressed, per member), write / verify / restore
   seconds and the host-to-card copy of the coefficients are reported;
11. serve server — ``KerasServer(max_batch=32, max_wait_ms=5.0,
   keep_models=4)`` on the card (admitting 16 at once) serving ``.zip``
   archives of the full-width char-RNN, GPT and f32 ResNet-50, and the
   char-RNN's Keras twin from its ``.h5`` path (imported by the server,
   fed ``.h5`` batch files), to 16
   ``KerasClient`` threads over TCP: per model a ladder (one request per
   bucket, 1-32 rows, alone), then two waves (one for the Keras twin) of
   32 requests of seeded
   feature files of 1, 2, 3, 5 or 8 rows, one in four ``bulk``. Each predict bucket is one CUDA graph over the
   container's ``_infer_fn()`` (the char-RNN's replay K1, the GPT's K4).
   Every answer against its singleton ``output()`` on the card (C2:
   argmax equal, max |dprob| <= 1e-5); each bucket's replay bit for bit
   an eager ``output()`` of the same padded batch; a traced replay holds
   exactly 2 K1 (char-RNN) or 8 K4 (GPT) kernels; no capture in wave two;
   no batch falls back to singletons; the server's ``generate`` (4
   prompts, one sampled) against ``greedy_generate`` /
   ``sample_generate``; a ``fit`` op (two [32, 200] batch files, K2 and
   K3) then a wave that captures nothing and answers the fitted weights;
   a ``fit`` op on the Keras path (two [32, 64] ``.h5`` pairs: 4 K2, 4
   K3);
   ``evaluate`` against ``net.evaluate``; a ``poison_row`` request alone
   ``NONFINITE`` in a full batch; ``health`` / ``readyz`` / ``debug``
   answering under a ``slow_batch`` fault; threads back to their
   baseline after ``drain`` and ``stop``. Per model and wave: requests/s,
   rows/s, round trip and server p50/p99, batch-size mix, flush reasons,
   captures and their seconds, graph pool bytes per bucket, the
   ``serve:batch`` span against the round trip, and the GPT answer's
   JSON cost apart;
12. keras transfer — the Keras import (ROADMAP A7.1, A7.2): the
   char-RNN's Keras twin (``Sequential``: ``Input((None, 96))`` ->
   ``LSTM(256, return_sequences=True)`` x2 -> ``Dense(96, softmax)``,
   911,456 params, seeded Keras-style weights) written in Keras's ``.h5``
   layout by the port's ``Hdf5Writer``, imported onto the card and onto
   the CPU (params bit for bit; the import's seconds: read, build,
   weights), ``output()`` on [32, 64, 96] against the CPU (1e-4), a traced
   ``output()`` holding 2 K1, every committed golden fixture imported on
   the card at its own tolerance; ``TransferLearning`` freezing layer 0
   (Adam 1e-3) under an ``EarlyStoppingTrainer`` (3 epochs of 2 [32, 64]
   batches, scored on 2 held out): the first loss (1e-5) and gradients
   (1e-4 of their largest |g|) against the CPU, 2 K2 and 2 K3 a
   ``fit_batch``, the frozen layer bit for bit, the best score
   reproduced by the calculator; the same run through
   ``EarlyStoppingParallelTrainer`` at world 1 over NCCL bit for bit;
   ``output()`` ms and ms a fine-tune step;
13. train features — the single-card training features (ROADMAP A2) at
   full width: the GPT with ``precision="bf16"`` (bf16 compute, f32
   masters; K4, K5, K6 as bf16 instantiations, read from a traced
   step's kernel symbols) through ``fit`` for 20 steps from a
   ``DevicePrefetchIterator`` under ``ScoreIterationListener``,
   ``PerformanceListener``, ``CollectScoresIterationListener`` and a
   skip_batch ``DivergenceSentinel`` (lag 1), one batch with a NaN
   feature: exactly one skip, the params, moments and device count
   bitwise unchanged across it, 8 launches of each kernel a step; the
   first gradient against the CPU's bf16 plain versions (8 rows); the f32
   twin's distance, bf16 against f32 ms a step in turns, GEMM shares and
   peak memory. remat on and off (dropout on every layer, bf16): bitwise
   gradients, K4 16 a step. The bf16 char-RNN's tBPTT (K2, K3 in bf16, 8
   each a [32, 200] ``fit_batch``, 16 K2 under remat): the first window
   against the CPU, a NaN in the second window skipped with the carries
   guarded, clean guarded steps under
   ``torch.cuda.set_sync_debug_mode("error")``. ``fit(scan_window=4)`` of
   the f32 GPT bitwise 8 ``fit_batch`` calls, with their launches and the
   burst's 8 losses. The bf16 ResNet-50 step fed by
   ``DevicePrefetchIterator`` against the pageable copy in turns
   (images/s, ``data_wait`` share, busy share). An Iris MLP under L-BFGS
   and ``evaluate_roc`` / ``evaluate_regression`` against the CPU;
14. serve fleet — the serving fleet (ROADMAP A5.3) on the card: three
   ``FleetReplica(max_batch=32)`` gateways of the GPT's and the
   char-RNN's ``.zip`` behind one ``FleetRouter``, in this process,
   over TCP. A predict storm of both models from 16 clients (1-8 rows,
   one in four ``bulk``) while ``kill_replica`` hard-kills one replica:
   no client failure, failovers counted, the corpse removed in under
   15 s, every answer against its singleton ``output()`` (C2). A traced
   wave per model through the router: 2 K1 per char-RNN batch and 8 K4
   per GPT batch replayed; the router's hop (the same char-RNN wave
   through it and straight to a replica, in turns); a traced failover
   (both engines warm) with its K4 launches. A streamed generate whose
   replica dies at its 3rd token while a survivor joins: the tokens equal
   the singleton ``greedy_generate`` (C2). A rolling drain-restart of
   every replica under char-RNN load: no failure, no capture by the
   survivors, each successor's seconds to admission and captures. An
   undersized router (``max_concurrency=2``) with a ``FleetAutoscaler``
   (max 3) under ``slow_replica`` stalls: the pool grows, brownout at the
   maximum sheds ``bulk`` with a structured ``SHED`` on a live connection
   while interactive is served on the same one, the pool drains to its
   floor, a ``flap_replica`` rank is quarantined and released. The
   router's ``/api/metrics`` and ``/readyz``; a ``StallWatchdog`` writing
   one bundle under ``hang_backend``; 0 compile-cache evictions, the
   graph pools' bytes against the card's reserved memory; threads back
   to their baseline;
15. train parallel — the data-parallel trainers (ROADMAP A6.1) at full
   width. World 1 over NCCL in this process: ``ParallelTrainer`` on the
   GPT ([32, 256]) for 3 steps bit for bit its twin's ``fit_batch``;
   gradient accumulation 4 within 2e-4 / 2e-5 of the plain step (SGD
   twins), its peak allocation at most one and a half gradients above a
   step on its [8, 256] microbatch (one accumulator);
   ``DelayedSyncTrainer(sync_frequency=1)`` bit for bit
   ``ParallelTrainer``, on the GPT and on the char-RNN's tBPTT windows;
   the char-RNN's tBPTT ([32, 200]) through ``ParallelTrainer`` bit for
   bit its ``fit_batch``;
   ``ParallelWrapper(workers=2, averaging_frequency=2)`` on the char-RNN
   within 1e-5 of two hand-run workers averaged; traced launches per step
   (8 K4/K5/K6 a GPT step, 8 K2/K3 a char-RNN step, 16 a wrapper
   iteration of two workers); ms a step against the plain fit_batch in
   turns; ``FaultTolerantTrainer`` over ``ParallelTrainer`` with sharded
   checkpoints: a ``raise`` fault retried, a cut run resumed by a fresh
   net bit for bit the uninterrupted one, a NaN batch rolled back, the
   checkpoint's write and restore seconds. World 2 in two processes of
   this script (``--parallel-rank``) on this one card over gloo with CUDA
   tensors: the GPT in the off, zero1 and zero2 modes, zero1 and zero2
   bit for bit the replicated mode and the ranks equal, each rank's
   updater state half the replicated bytes (and freed), ms a step, and
   ms of each collective alone on a gradient-sized buffer; the
   ``train_parallel_pipeline`` line (ROADMAP A6.2b): the full-width GPT
   through ``GraphPipelineTrainer`` over two stages (cut at
   ``b3_res2``, the tied head's embedding sent from stage 0 each step)
   at M = 1 and 4 against the plain steps (losses within 1e-5, SGD
   twins within 2e-4 / 2e-5, Adam within the C23 allowance), exactly
   4 M K4/K5/K6 a rank a step, half the params and moments a rank, the
   sends and their bytes, ms a step and of one staged 4 MiB send alone;
   the char-RNN through ``PipelineTrainer`` (stages [[0], [1]], M = 2,
   tBPTT 50 over [32, 200]) against the plain windowed ``fit_batch``,
   its first window's LSTM gradients within 2e-4, exactly 8 K2 and 8 K3
   a rank; the MoE FFN at the GPT's widths (8192 tokens, 8 experts of
   2048) on the card against the CPU and with its experts split over
   the two ranks' 'ep' axis against world 1, within 1e-5; the
   ``train_parallel_moe_dp`` line (ROADMAP A6.2c): an MoE MLP (512 ->
   8 experts of 2048 -> 96, 17.1M params) through ``ParallelTrainer``
   on the data axis, replicated and zero1, 3 steps of 8192 global rows
   against each rank's plain step of the global batch (losses within
   1e-5; the Adam path's params by C31's crossing gate: before each
   step, the Dense and expert units whose ReLU pre-activation has
   another sign than the plain run's on tokens both keep, and every
   W1 / b1 / W2 element outside 2e-4 / 2e-5 in a crossed unit, at most
   64 in the other leaves, none without a crossing; SGD twins none),
   the tokens the global capacity drops on the first batch (at least
   one) beside those a per-rank capacity would, ms a step against the
   plain step, and the bytes the dispatch's collectives move; their
   zero1 checkpoint restored at world 1, its next step within 2e-4 /
   2e-5 of theirs. Then the same two processes join an elastic group
   (ROADMAP A6.3) and train the GPT under ``ElasticTrainer`` (zero1, a
   checkpoint every 2 steps, 5 steps); ``kill_host`` ends rank 1 at step
   3: rank 0 decides the loss from its heartbeats, elects itself, resizes
   in process to world 1, reshard-restores the zero1 checkpoint and
   consumes the unconsumed tail once, its losses and params bit for bit
   a clean world-1 restart from the same checkpoints (here, uncounted);
   the lease reads epoch 1, coordinator 0, world [0]; the seconds from
   the kill to the resume, the heartbeat window among them, and the
   restore; the survivor's K4-K6 launches join the path's. The
   ``device_profile`` windows of every phase open with the same pad
   burst as ``traced_kernels``', taken out of their numbers;
16. analysis — the static analysis (ROADMAP A7.3), no step of
   training: every config the smoke builds (the GPT, the char-RNN,
   LeNet, VGG, ResNet-50, the Keras twin, the MoE MLP) validates with no
   ERROR finding at the card's default budget; the full-width GPT's
   ``memory_report`` equals the live nets exactly (param bytes and Adam
   moments of the training phase's net, zero1 moments at dp = 2 of
   world-2 rank 0's) and its estimate for a [32, 256] step stands beside
   the step's measured peak (ResNet-50's at 64 too, ungated);
   ``kv_pool_plan`` equals the serving engine's pool, and an engine's
   under a byte budget; the budget constants equal the card's;
17. cost_autotune — the cost model, the watchers and the autotuner
   (ROADMAP A7.4): the full-width GPT's ``cost_analysis`` at [32, 256]
   on the card equal, within 0.1%, to 16 times its CPU twin's at
   [2, 256] (the kernels add their plain versions' FLOPs) and within
   0.9-1.2 of 6 N tokens + 12 L T d tokens, its analytic MFU at the
   training phase's measured step; the char-RNN's [32, 200] count equal
   to its CPU twin's (K2 / K3 counted); ResNet-50 f32 at 64 and its MFU
   (printed); an autotune of the full-width GPT at world 1 (batch 32,
   top 2 and the default probed, 2 timed steps each): every
   shortlisted probe completes, each probe step launches 8 K4, K5 and
   K6 a microbatch, read by symbol and input type in a trace of its
   warm-up step (bf16 in a bf16 probe), the winner measures no slower
   than the default, each probe's predicted and measured seconds and
   gap printed; the tuned trainer's 2 steps bit for bit a hand-built
   ``ParallelTrainer(**tuned.trainer_kwargs())``'s, a
   ``DeviceMemoryWatermark`` over them at least the allocator's peak and
   its thread gone after ``stop``, ``TunedConfig`` save / load; the
   ``CompileWatcher`` installed before the build counts exactly the
   nvcc builds that ran and the CUDA-graph captures the engines and
   gateways reported over the whole run;
18. a ``{"kernels": [...]}`` summary line (K2-K6 with their bf16 times,
   bounds and library times at this slice's shapes);
19. last line ``{"ok": true, "device": {...}}``.

Every kernel, plain version and library call is timed by its kernels'
durations in a profiler trace (``device_ms``): K4 runs in less time than
its Python wrapper can take to queue a call, so back-to-back events
would time the host. The updater's time is CUDA events over back-to-back
calls (``cuda_ms``): it is host-bound by design.

Each slice is driven with every kernel's launch count set to 0 just
before it and read just after; a kernel of that path that was not
launched fails the run. Any failed check raises, so the script exits
non-zero before the last line. It imports no JAX. Without a CUDA device
it exits 2 and prints no result.
"""

import collections
import hashlib
import json
import re
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
import zipfile
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.datasets import (
    DataSet, DevicePrefetchIterator, IrisDataSetIterator,
    ListDataSetIterator, MnistDataSetIterator,
)
from deeplearning4j_tpu_torch.earlystopping import (
    DataSetLossCalculator, EarlyStoppingConfiguration,
    EarlyStoppingParallelTrainer, EarlyStoppingTrainer, InMemoryModelSaver,
    MaxEpochsTerminationCondition,
)
from deeplearning4j_tpu_torch.models.char_rnn import char_rnn_lstm
from deeplearning4j_tpu_torch.models.lenet import lenet_mnist
from deeplearning4j_tpu_torch.models.resnet import resnet50
from deeplearning4j_tpu_torch.models.vgg import vgg16_cifar10
from deeplearning4j_tpu_torch.keras.autoscale import FleetAutoscaler
from deeplearning4j_tpu_torch.keras.batching import (
    CompileCache, PredictRunner, _LatencyWindow,
)
from deeplearning4j_tpu_torch.keras.fleet import FleetReplica, FleetRouter
from deeplearning4j_tpu_torch.keras.generation import GenerationScheduler
from deeplearning4j_tpu_torch.keras.hdf5 import Hdf5Archive, Hdf5Writer
from deeplearning4j_tpu_torch.keras.keras_import import KerasModelImport
from deeplearning4j_tpu_torch.keras.server import (
    KerasClient, KerasServer, _load_array,
)
from deeplearning4j_tpu_torch.models.gpt import (
    char_lm_batches, gpt_decoder, greedy_generate, sample_generate,
    synthetic_char_text,
)
from deeplearning4j_tpu_torch.nn.conf import (
    InputType, NeuralNetConfiguration,
)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.netcommon import value_and_grad
from deeplearning4j_tpu_torch.nn.transferlearning import (
    FineTuneConfiguration, TransferLearning,
)
from deeplearning4j_tpu_torch.nn.updater import (
    compute_updates, tree_leaves, tree_map,
)
from deeplearning4j_tpu_torch.optimize.listeners import (
    CollectScoresIterationListener, PerformanceListener,
    ScoreIterationListener,
)
from deeplearning4j_tpu_torch.optimize.solvers import Solver
from deeplearning4j_tpu_torch.optimize.training_stats import TrainingStats
from deeplearning4j_tpu_torch.ops.cuda_build import (
    build_libraries, library_path,
)
from deeplearning4j_tpu_torch.ops.flash_attention import (
    NEG_INF, attention_bwd_plain, attention_dvec, flash_attention,
    flash_attention_bwd_plain, flash_attention_dkv, flash_attention_dq,
    flash_attention_plain,
)
from deeplearning4j_tpu_torch.ops.fused_lstm import (
    BWD_RESIDENT_MAX_HIDDEN, MAX_HIDDEN, RESIDENT_MAX_HIDDEN, fused_lstm,
    launch_plan, lstm_bwd,
    lstm_bwd_plain, lstm_fwd_train, lstm_fwd_train_plain,
    lstm_recurrence, lstm_recurrence_plain,
)
from deeplearning4j_tpu_torch.profiling.cost import analytic_mfu, peak_flops
from deeplearning4j_tpu_torch.profiling.metrics import (
    MetricsRegistry, get_registry, set_registry,
)
from deeplearning4j_tpu_torch.profiling.tracer import (
    Tracer, get_tracer, set_tracer,
)
from deeplearning4j_tpu_torch.profiling.watchdog import (
    BUNDLE_FORMAT, StallWatchdog,
)
from deeplearning4j_tpu_torch.profiling.watchers import (
    CompileWatcher, DeviceMemoryWatermark,
)
from deeplearning4j_tpu_torch.resilience import faultinject
from deeplearning4j_tpu_torch.resilience.faultinject import (
    Fault, FaultSchedule,
)
from deeplearning4j_tpu_torch.resilience.atomic import CheckpointError
from deeplearning4j_tpu_torch.resilience.sentinel import DivergenceSentinel
from deeplearning4j_tpu_torch.resilience.service import Deadline
from deeplearning4j_tpu_torch.util.serializer import ModelSerializer

# H100 SXM published peaks (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12       # CUDA cores: the units K1-K3 run on
# tensor cores: an f32-accurate product is three TF32 products (3xTF32,
# K4, K5 and K6 on f32 inputs); bf16 inputs could take the bf16 rate
TF32X3_FLOPS_PER_S = 495e12 / 3
BF16_FLOPS_PER_S = 989e12

# Tolerances. f32: the kernel and the plain version differ only in the
# order of the f32 sums (the JAX package's own flash tolerance is 2e-5).
# bf16: O is rounded to bf16 on both sides, so two bf16 ulps of 1.0.
TOL_F32 = 2e-5
TOL_BF16_O = 1.6e-2
TOL_LSE = 1e-4
# K5/K6 vs the plain backward, scaled by the largest |g| of each tensor.
# f32: the reference's own grad tolerance, which the kernels' 3xTF32
# products meet with room (about 1e-6 emulated, 1xTF32 5e-4 to 8e-4:
# tests/test_torch_flash_tensorcore.py); bf16: grads round to bf16 on
# both sides, two bf16 ulps
TOL_GRAD_F32 = 5e-5
TOL_GRAD_BF16 = 1.6e-2
# the slice on the card vs the same net on the CPU: f32 GEMMs in another
# order through 8 layers (TF32 off), probabilities of a 96-way softmax
TOL_SLICE = 1e-4
# LSTM recurrence kernel vs its plain version. f32: the order of the f32
# sums only (the JAX package's fused-LSTM forward tolerance is 1e-5).
# bf16: the carry rounds to bf16 on both sides, so a one-ulp flip can feed
# back through the steps: four bf16 ulps of 1.0. h is bounded by 1; the
# cell c sums i * g over the steps and is not, so its tolerance scales
# with its largest magnitude (a relative tolerance where |c| > 1). A flip
# that a unit with its forget gate near 1 keeps grows over the steps, so
# the bf16 case is also held step by step: each of the kernel's own steps
# against the plain step from the same carry
TOL_LSTM_F32 = 1e-5
TOL_LSTM_BF16 = 3.2e-2
# the char-RNN on the card vs the CPU, and streamed vs whole-sequence on
# the card: probabilities of a 96-way softmax after 64 recurrent steps
# whose GEMMs and sums run in another order (TF32 off)
TOL_LSTM_SLICE = 1e-4
# training on the card vs the same net on the CPU: the step-1 loss
# (relative), each gradient tensor against its own largest |g| (f32 GEMMs
# in another order through 8 layers, TF32 off), the next steps' losses
# (relative; Adam's m / sqrt(v) amplifies tiny gradient differences)
TOL_TRAIN_LOSS = 1e-5
TOL_TRAIN_GRAD = 1e-4
TOL_TRAIN_STEPS = 1e-4
# K2 / K3 vs their plain versions: f32 the reference's own tolerances
# (tests/test_pallas_kernels.py: forward 1e-5, gradients 2e-4); bf16 four
# bf16 ulps of 1.0, as K1's; each scaled by max(1, max |x|), since c, dz
# and the backward's carries are not bounded by 1
TOL_K2_F32 = 1e-5
TOL_K3_F32 = 2e-4
TOL_LSTM_TRAIN_BF16 = 3.2e-2
# the CNN slice on the card vs the same net on the CPU (f32 convolutions
# in other algorithms, TF32 off for matmuls and cuDNN): the step-1 loss
# (relative), each gradient tensor against its own largest |g|, the next
# steps' losses (relative), probabilities, and BN's running state after
# a step (times max(1, max |s|): a running variance sits near 1)
TOL_CNN_LOSS = 1e-5
TOL_CNN_GRAD = 1e-4
TOL_CNN_STEPS = 1e-4
TOL_CNN_PROBS = 1e-4
# ResNet-50 run in f64 on the card against the same in f64 on the CPU:
# the loss (relative), every gradient against its largest |g|, the BN
# states; both sides' rounding is ~1e-16 (measured: 4e-13 of the largest
# |g|, states 2e-14)
TOL_CNN_F64 = 1e-9
# ResNet-50's f32 gradients against the f64 ones: 53 BN layers in
# training mode at random init leave the card's and the CPU's f32
# gradients each 2.4-2.8% from f64 in relative L2, some tensors 18-23%
# of their largest |g|, every tensor's cosine above 0.9992 (this script's
# resnet50_f32_twin record); a wrong gradient (a pad off by one, a
# transposed kernel) falls far below
TOL_RESNET_GRAD_L2 = 0.1
TOL_RESNET_GRAD_COS = 0.99
# ResNet-50's f32 BN states after a step against f64, times max(1, max
# |s|): 1.0e-5 on the card and 8.3e-6 on the CPU (the same record),
# above the 1e-5 of the smaller nets
TOL_RESNET_STATE = 1e-4

SLICE = dict(vocab_size=96, seq_len=256, d_model=512, n_heads=8, n_layers=8)
#: heads of 256, the kernels' widest register template
WIDE_SLICE = dict(vocab_size=96, seq_len=256, d_model=512, n_heads=2,
                  n_layers=2)
#: heads of 512, the kernels' wide template (flash_ok passes at T = 256)
WIDE512_SLICE = dict(vocab_size=96, seq_len=256, d_model=1024, n_heads=2,
                     n_layers=2)
WIDE_BATCH = 8
LSTM_SLICE = dict(vocab_size=96, hidden=256, layers=2)
LSTM_BATCH = (32, 64)          # B, T: the char-LSTM traffic of bench.py
LSTM_TRAIN_BATCH = (32, 200)   # B, T of a training batch: 4 windows of 50
SEED = 1234
#: the CNN slice: LeNet-5 on the MNIST stand-in (50 steps of 64, then
#: 1,024 unseen training-split examples), VGG-16-CIFAR at [64, 32, 32, 3],
#: ResNet-50 at 224x224x3 and 1000 classes (an f32 twin at batch 4 against
#: the CPU; bf16 and f32 at batch 64, timed)
LENET_BATCH, LENET_STEPS, LENET_HELD_OUT = 64, 50, 1024
VGG_BATCH = 64
RESNET_TWIN_BATCH, RESNET_BATCH, RESNET_STEPS = 4, 64, 20
RESNET_HW, RESNET_CLASSES = 224, 1000     # resnet50()'s input and classes
#: kernel-name substrings (lower case) of the CNN step's groups
CNN_GROUPS = dict(
    # cuDNN runs some convolutions as GEMMs (cuBLAS's nvjet and CUTLASS
    # kernels among them); the dense head is one GEMM
    conv_and_gemm=["fprop", "dgrad", "wgrad", "conv", "gemm", "nvjet",
                   "cutlass", "xmma"],
    batch_norm=["batch_norm"],
    layout_transpose=["nchwtonhwc", "nhwctonchw", "transpose"],
    pooling=["pool"],
    input_copy=["memcpy"],
    elementwise=["elementwise"],
)
#: the serving engine's traffic on the full-width GPT (SLICE, 8 rows):
#: 16 requests, prompt lengths drawn (seed 23) from SERVE_LENGTHS, 32 new
#: tokens each, submitted from 16 threads staggered by 0-20 ms; requests
#: whose index is a multiple of 4 sample at temperature 0.8 with their
#: index as seed; the first two prompts longer than 64 tokens share their
#: first 64 (one page); an evict_page fault at wave one's 10th decode
#: iteration; then the same 16 requests again
SERVE_ROWS, SERVE_REQUESTS, SERVE_NEW = 8, 16, 32
SERVE_LENGTHS = (5, 17, 33, 64, 100, 128)
SERVE_TEMP, SERVE_PREFIX, SERVE_STAGGER_S = 0.8, 64, 0.020
SERVE_EVICT_AT = 10
#: a page replay at full width: 32 new tokens never fill a 64-token page
#: with decode content alone, so one more request (5 prompt tokens, 140
#: new) takes an evict_page fault at its 130th step, when page 1 (64-127)
#: is decode-written and behind its position
REPLAY_PROMPT, REPLAY_NEW, REPLAY_EVICT_AT = 5, 140, 130
#: requests also run through an engine on the CPU, against the card's
SERVE_CPU_REQUESTS = 2
#: calls per block of the graphed / eager decode timing (in turns)
SERVE_TIMED_CALLS = 30
#: host-side CUDA runtime calls that launch work, in a profiler trace
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaGraphLaunch")
TRAIN_BATCH = 32               # [32, 256] windows per step
#: the checkpoint phase: fit_batch calls before the GPT's and the
#: char-RNN's archives are written (one for ResNet-50), the served
#: reload's requests per wave (prompt lengths, new tokens)
CKPT_STEPS = 3
RELOAD_LENGTHS, RELOAD_NEW = (5, 17, 33, 64, 100, 128, 9, 40), 16
#: 95 printable ASCII characters and the newline: the 96-symbol vocabulary
CHARSET = "".join(chr(i) for i in range(32, 127)) + "\n"
#: the predict server: one KerasServer(max_batch=32, max_wait_ms=5.0,
#: keep_models=4) on the card serving the full-width char-RNN, GPT and f32
#: ResNet-50 from .zip archives; 16 client threads; request rows drawn
#: (seeded) from SERVER_ROWS over a pool of SERVER_FILES feature files per
#: model; one request in four "bulk"; wave one opens with one request per
#: bucket of SERVER_LADDER, alone, so it captures every bucket wave two
#: can form; requests per wave per model in SERVER_WAVES
SERVER_MAX_BATCH, SERVER_WAIT_MS, SERVER_CLIENTS = 32, 5.0, 16
SERVER_ROWS = (1, 2, 3, 5, 8)
SERVER_LADDER = (1, 2, 4, 8, 16, 32)
SERVER_FILES = 24
SERVER_WAVES = {"char_rnn": (32, 32), "gpt": (32, 32), "resnet50": (32, 32),
                "keras_lstm": (32,)}
#: ROADMAP C2: a batched row against its singleton — argmax equal and
#: max |dprob| within this (probabilities are <= 1, so also relative)
TOL_C2 = 1e-5
#: ROADMAP C12: the f32 ResNet-50 at random init moves its probabilities
#: by up to 1.4e-4 between batch sizes (cuDNN picks its algorithms by
#: batch; 53 conv + BN layers amplify f32 rounding, C7), so its answers
#: are held to argmax equal and max |dprob| within this instead
TOL_C2_RESNET = 1e-3
#: the server's generate (prompt lengths, new tokens; the last sampled)
SERVER_GEN_LENGTHS, SERVER_GEN_NEW, SERVER_GEN_TEMP = (5, 17, 33, 64), 16, 0.8
#: the fit op's batch files ([32, 200] windows) and the predict wave after
SERVER_FIT_BATCHES, SERVER_AFTER_FIT = 2, 32
#: the launch counter of each TPU kernel the predict graphs replay
SERVER_KERNEL_COUNTERS = {"lstm_fwd_infer_kernel": "lstm_fwd_infer",
                          "flash_fwd_kernel": "flash_attn_fwd"}
#: kernel-name substrings of the three attention kernels in a trace
ATTENTION_KERNELS = ("flash_fwd_kernel", "flash_dq_kernel",
                     "flash_dkv_kernel")

#: every kernel wrapper of the port, by kernel name
KERNELS = {"flash_attn_fwd": flash_attention,
           "flash_attn_dq": flash_attention_dq,
           "flash_attn_dkv": flash_attention_dkv,
           "lstm_fwd_infer": lstm_recurrence,
           "lstm_fwd_train": lstm_fwd_train,
           "lstm_bwd": lstm_bwd}


#: what earlier phases measured on their live nets, for the analysis
#: phase's memory plan to be held against: the GPT training net's param
#: and moment bytes and its step's peak, ResNet-50's peaks, the serving
#: engine's pool, the Keras twin's imported config
LIVE: dict = {}


def reset_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


#: when the script started: each phase's line carries the seconds since
T_START = time.perf_counter()


def timed(name, fn, *args):
    """Run one phase and print its wall seconds (and the run's so far)
    when it ends."""
    t0 = time.perf_counter()
    out = fn(*args)
    t1 = time.perf_counter()
    emit(dict(phase="phase_seconds", name=name, seconds=t1 - t0,
              run_seconds=t1 - T_START))
    return out


def cuda_ms(fn, iters=20, warmup=3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
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


def device_ms(fn, iters=20, warmup=3) -> float:
    """Device time of one call of ``fn``: each CUDA kernel's mean duration
    in a torch.profiler trace of ``iters`` calls, times its launches per
    call. The kernels' own durations, not the host's time to queue them:
    a Python wrapper can take longer to queue a call than a short kernel
    takes to run, and then back-to-back events time the host. A trace
    that holds no kernel (the tracer sometimes drops a whole window) is
    taken again, three times in all."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        if kernels:
            break
    check(kernels, "the trace holds no kernel")
    return sum(e.self_device_time_total / e.count
               * max(1, round(e.count / iters)) for e in kernels) / 1e3


def host_ms(fn, iters=5, warmup=1) -> float:
    """Median host time of ``fn`` ending in a synchronize."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


#: the pad's tensor and its launches per kernel name (``pad_counts``)
_PAD = {}


def trace_pad():
    """TRACE_PAD small kernels on an int16 tensor that no path of the port
    touches: the burst that opens a profile window (the tracer sometimes
    drops a window's first kernels). The tensor is allocated once, by
    ``pad_counts``, outside every window: a window holds the adds alone."""
    pad = _PAD["tensor"]
    for _ in range(TRACE_PAD):
        pad.add_(1)


def pad_counts() -> dict:
    """The pad's launches per kernel name, from a trace of the pad alone,
    taken once (``main`` takes it first, while nothing else runs on the
    card). A trace that holds other than TRACE_PAD launches is taken
    again, three times in all."""
    from torch.profiler import ProfilerActivity, profile
    if not _PAD:
        _PAD["tensor"] = torch.zeros(1, dtype=torch.int16, device="cuda")
        trace_pad()
        torch.cuda.synchronize()
        for _ in range(3):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                trace_pad()
                torch.cuda.synchronize()
            counts = {e.key: e.count for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA}
            if sum(counts.values()) == TRACE_PAD:
                break
        check(sum(counts.values()) == TRACE_PAD,
              f"a trace of the pad alone holds {counts}")
        _PAD["counts"] = counts
    return _PAD["counts"]


def traced_window(fn):
    """One torch.profiler trace of ``fn`` (every thread's kernels on the
    card), its window opened with ``trace_pad``'s burst: (``fn``'s
    result, its wall time in us, [(kernel name, launches, device us)]),
    each name's launches less the pad's count of it and its time cut in
    proportion."""
    from torch.profiler import ProfilerActivity, profile
    pad = pad_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        trace_pad()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        n = e.count - pad.get(e.key, 0)
        if n > 0:
            kernels.append((e.key, n, e.self_device_time_total * n
                            / e.count))
    return result, wall_us, kernels


def device_profile(fn, expect, top=6, groups=None):
    """One traced run of ``fn`` under torch.profiler: the wall time, the
    summed time of the CUDA kernels, their share of the wall time (the
    card's busy share; the trace itself slows the host, so it reads
    low), the kernel count and the kernels that took the most time.
    The trace is a ``traced_window``: the pad that opens it is taken out
    of every number here. ``expect`` maps a kernel's name to the launches ``fn`` makes
    of it; a trace that holds another count is taken again, three times
    in all, and the run fails if none holds them. ``groups`` maps a name
    to kernel-name substrings (lower case); each group's share of the
    kernel time is returned."""
    fn()
    torch.cuda.synchronize()
    for attempt in range(1, 4):
        _, wall_us, kernels = traced_window(fn)
        traced = {name: sum(n for k, n, _ in kernels if name in k)
                  for name in expect}
        if traced == expect:
            break
    check(traced == expect, f"the trace holds {traced} launches of the "
                            f"path's kernels, not {expect}")
    busy_us = sum(us for _, _, us in kernels)
    kernels.sort(key=lambda k: -k[2])
    shares = {g: sum(us for k, _, us in kernels
                     if any(n in k.lower() for n in names)) / busy_us
              for g, names in (groups or {}).items()}
    return dict(wall_ms=wall_us / 1e3, kernel_ms=busy_us / 1e3,
                kernel_shares=shares,
                busy_share=busy_us / wall_us, traced_path_kernels=traced,
                attempts=attempt,
                kernel_launches=sum(n for _, n, _ in kernels),
                top=[(k[:60], n, us / 1e3) for k, n, us in kernels[:top]])


def attention_bound_ms(B, H, T, D, dtype, causal, mask, n_tensors,
                       n_stats, flop_per_pair):
    """Least time for a flash-attention kernel's work on an H100:
    ``n_tensors`` [B, H, T, D] tensors and ``n_stats`` [B, H, T] f32 rows
    (and the mask) each read or written once over HBM, against
    ``flop_per_pair`` x D FLOP over the (query, key) pairs this input
    needs, at the peak of the kernel's arithmetic: the tensor cores in
    3xTF32 for f32 inputs, bf16 for bf16. Returns (bound ms, "bytes" or
    "operations", flops, bytes, the bound at the f32 CUDA-core peak, the
    peak's name)."""
    es = torch.tensor([], dtype=dtype).element_size()
    nbytes = n_tensors * B * H * T * D * es + n_stats * B * H * T * 4
    valid = torch.ones(B, T) if mask is None else (mask > 0).float().cpu()
    if mask is not None:
        nbytes += B * T * 4
    per_key = (T - torch.arange(T)).float() if causal else torch.full(
        (T,), float(T))
    pairs = H * float((valid * per_key).sum())
    flops = flop_per_pair * D * pairs
    peak, peak_name = ((TF32X3_FLOPS_PER_S, "3xTF32 tensor cores")
                       if dtype == torch.float32
                       else (BF16_FLOPS_PER_S, "bf16 tensor cores"))
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    simt = max(t_bytes, flops / F32_FLOPS_PER_S) * 1e3
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", flops, nbytes,
            simt, peak_name)


def flash_bound_ms(B, H, T, D, dtype, causal, mask):
    """K4's bound (``attention_bound_ms``): q, k, v read and o written, lse
    written; s = q k^T and o += p v, 4 D FLOP a pair."""
    return attention_bound_ms(B, H, T, D, dtype, causal, mask, 4, 1, 4.0)


def check(cond, what):
    if not cond:
        raise AssertionError(what)


#: port modules the import rule must find (the data-parallel package's,
#: the Keras import's, the transfer-learning and the analysis modules')
IMPORT_RULE_REQUIRED = ("parallel/__init__.py", "parallel/mesh.py",
                        "parallel/pipeline.py", "parallel/expert.py",
                        "analysis/graphcheck.py", "analysis/memory.py",
                        "analysis/findings.py",
                        "parallel/multihost.py", "parallel/trainer.py",
                        "parallel/wrapper.py", "parallel/delayed.py",
                        "parallel/strategy.py", "parallel/checkpoint.py",
                        "resilience/manager.py", "resilience/trainer.py",
                        "keras/hdf5.py", "keras/keras_import.py",
                        "nn/transferlearning.py",
                        "earlystopping/__init__.py",
                        "earlystopping/config.py",
                        "earlystopping/trainer.py",
                        "earlystopping/parallel_trainer.py",
                        "gradientcheck/__init__.py",
                        "gradientcheck/check.py",
                        "profiling/cost.py", "profiling/watchers.py",
                        "autotune/__init__.py", "autotune/config.py",
                        "autotune/model.py", "autotune/probe.py",
                        "autotune/space.py", "autotune/tuner.py")


def import_rule() -> dict:
    """The port's import rule, read from its sources: no module of the
    port and not this script imports JAX, anything of the JAX package or
    h5py (an AST walk of every ``import`` and absolute ``from`` import)."""
    import ast
    root = Path(__file__).resolve().parent
    files = sorted((root / "deeplearning4j_tpu_torch").rglob("*.py"))
    files.append(root / "chip_smoke.py")
    names = {str(f.relative_to(root)) for f in files}
    missing = [m for m in IMPORT_RULE_REQUIRED
               if f"deeplearning4j_tpu_torch/{m}" not in names]
    bad = []
    for f in files:
        for node in ast.walk(ast.parse(f.read_text(), str(f))):
            mods = ([a.name for a in node.names]
                    if isinstance(node, ast.Import) else
                    [node.module] if isinstance(node, ast.ImportFrom)
                    and node.level == 0 else [])
            bad += [(str(f.relative_to(root)), m) for m in mods
                    if m.split(".")[0] in ("jax", "jaxlib", "h5py",
                                           "deeplearning4j_tpu")]
    check(not missing and not bad,
          f"import rule: missing {missing}, banned imports {bad}")
    return dict(files=len(files), banned_imports=bad)


def attention_inputs(B, H, T, D, dtype, mask_kind):
    """q, k, v on the card and the case's key mask (or None)."""
    g = torch.Generator().manual_seed(SEED + T + D)
    q, k, v = (torch.randn(B, H, T, D, generator=g).to("cuda", dtype)
               for _ in range(3))
    mask = None
    if mask_kind == "holes":       # batch 0: no valid key; batches 1+:
        mask = torch.ones(B, T)    # key 0 masked (query 0 has none under
        mask[0] = 0.0              # causal)
        mask[1:, 0] = 0.0
        mask[1:, 130:170] = 0.0
    elif mask_kind == "half":
        mask = (torch.rand(B, T, generator=g) < 0.5).float()
    elif mask_kind == "padded":
        # serving rows of lengths 64-256: keys past a row's length are
        # padding, whole 64-key tiles of them in the shorter rows
        lengths = torch.randint(64, T + 1, (B,), generator=g)
        lengths[0] = T
        mask = (torch.arange(T)[None, :] < lengths[:, None]).float()
    if mask is not None:
        mask = mask.cuda()
    return q, k, v, mask


def kernel_case(name, B, H, T, D, causal, dtype, mask_kind, timed=False):
    q, k, v, mask = attention_inputs(B, H, T, D, dtype, mask_kind)
    out, lse = flash_attention(q, k, v, causal=causal, kv_mask=mask,
                               return_lse=True)
    out2, lse2 = flash_attention(q, k, v, causal=causal, kv_mask=mask,
                                 return_lse=True)
    ref, ref_lse = flash_attention_plain(q, k, v, causal=causal,
                                         kv_mask=mask)
    torch.cuda.synchronize()
    err_o = float((out.float() - ref.float()).abs().max())
    err_lse = float((lse - ref_lse).abs().max())
    tol_o = TOL_F32 if dtype == torch.float32 else TOL_BF16_O
    rec = dict(phase="kernel", kernel="flash_attn_fwd", case=name,
               shape=[B, H, T, D], causal=causal, dtype=str(dtype),
               mask=mask_kind, max_abs_err_o=err_o, tol_o=tol_o,
               max_abs_err_lse=err_lse, tol_lse=TOL_LSE,
               bitwise_repeat=bool(torch.equal(out, out2) and
                                   torch.equal(lse, lse2)))
    if mask_kind == "holes":
        rows_ok = bool(torch.all(out[0] == 0) and torch.all(lse[0] == NEG_INF)
                       and torch.all(out[1:, :, 0] == 0)
                       and torch.all(lse[1:, :, 0] == NEG_INF))
        rec["no_valid_key_rows_exact"] = rows_ok
        check(rows_ok, f"case {name}: rows with no valid key are not "
                       "exactly 0 / NEG_INF")
    if mask_kind == "padded":
        rec["padded_key_tiles"] = int((mask.view(B, -1, 32).amax(-1) == 0)
                                      .sum())
    bound, bound_by, flops, nbytes, simt, peak = flash_bound_ms(
        B, H, T, D, dtype, causal, mask)
    rec.update(bound_ms=bound, bound_by=bound_by, bound_peak=peak,
               bound_ms_simt=simt, flops=flops, bytes=nbytes)
    if timed:
        rec["ms"] = device_ms(lambda: flash_attention(
            q, k, v, causal=causal, kv_mask=mask))
        rec["plain_ms"] = device_ms(lambda: flash_attention_plain(
            q, k, v, causal=causal, kv_mask=mask))
        # yardstick only: the port never calls SDPA
        rec["library_ms"] = device_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal)) if mask is None else None
        rec["achieved_tflops"] = flops / (rec["ms"] * 1e-3) / 1e12
    emit(rec)
    check(err_o <= tol_o, f"case {name}: O differs by {err_o} > {tol_o}")
    check(err_lse <= TOL_LSE,
          f"case {name}: lse differs by {err_lse} > {TOL_LSE}")
    check(rec["bitwise_repeat"], f"case {name}: two launches differ")
    return rec


def bwd_bound_ms(B, H, T, D, dtype, causal, mask, part):
    """One backward kernel's bound (``attention_bound_ms``): q, k, v, dO
    read and its outputs (dq; or dk and dv) written, lse and Dvec read; K5
    does s, dp, dq = 6 D FLOP a pair, K6 s, dp, dv, dk = 8 D."""
    if part == "dq":
        return attention_bound_ms(B, H, T, D, dtype, causal, mask, 5, 2, 6.0)
    return attention_bound_ms(B, H, T, D, dtype, causal, mask, 6, 2, 8.0)


def sdpa_backward_ms(q, k, v, d_out, causal):
    """Yardstick only (the port never calls SDPA): the time of SDPA's
    backward at this shape, without a mask, as forward + backward minus
    its forward. It computes dq, dk and dv: K5 and K6 together."""
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))

    def fwd():
        return F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal)

    def fwd_bwd():
        torch.autograd.grad(fwd(), (qg, kg, vg), d_out)
    return device_ms(fwd_bwd) - device_ms(fwd)


def attention_d_out(B, H, T, D, dtype):
    """dO on the card for ``attention_inputs``' q, k, v."""
    g = torch.Generator().manual_seed(SEED + 1 + T + D)
    return torch.randn(B, H, T, D, generator=g).to("cuda", dtype)


def bwd_case(name, B, H, T, D, causal, dtype, mask_kind, timed=False):
    """K5 and K6 against the plain FA2 backward on the card, from the K4
    case's inputs and the K4 kernel's out and lse."""
    q, k, v, mask = attention_inputs(B, H, T, D, dtype, mask_kind)
    d_out = attention_d_out(B, H, T, D, dtype)
    out, lse = flash_attention(q, k, v, causal=causal, kv_mask=mask,
                               return_lse=True)
    dvec = attention_dvec(d_out, out)
    kw = dict(causal=causal, kv_mask=mask)
    dq = flash_attention_dq(q, k, v, d_out, lse, dvec, **kw)
    dk, dv = flash_attention_dkv(q, k, v, d_out, lse, dvec, **kw)
    dq2 = flash_attention_dq(q, k, v, d_out, lse, dvec, **kw)
    dk2, dv2 = flash_attention_dkv(q, k, v, d_out, lse, dvec, **kw)
    ref = flash_attention_bwd_plain(q, k, v, d_out, out, lse, **kw)
    torch.cuda.synchronize()
    rel = TOL_GRAD_F32 if dtype == torch.float32 else TOL_GRAD_BF16
    rec = dict(phase="kernel", kernel="flash_attn_dq+flash_attn_dkv",
               case=name, shape=[B, H, T, D], causal=causal,
               dtype=str(dtype), mask=mask_kind,
               bitwise_repeat=bool(torch.equal(dq, dq2) and
                                   torch.equal(dk, dk2) and
                                   torch.equal(dv, dv2)))
    ok = True
    for part, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
        err = float((got.float() - want.float()).abs().max())
        tol = rel * max(1.0, float(want.float().abs().max()))
        rec[f"max_abs_err_{part}"], rec[f"tol_{part}"] = err, tol
        ok = ok and err <= tol and bool(torch.isfinite(got).all())
    if mask_kind == "holes":
        rows_ok = bool(all(torch.all(t[0] == 0) for t in (dq, dk, dv))
                       and torch.all(dq[1:, :, 0] == 0)
                       and torch.all(dk[1:, :, 0] == 0)
                       and torch.all(dv[1:, :, 0] == 0))
        rec["no_valid_key_grads_exact_zero"] = rows_ok
        check(rows_ok, f"case {name}: grads of rows / keys with no valid "
                       "pair are not exactly 0")
    if mask_kind == "padded":
        pad = (mask == 0)[:, None, :, None].expand_as(dk)
        keys_ok = bool(torch.all(dk[pad] == 0) and torch.all(dv[pad] == 0))
        rec["padded_keys_exact_zero"] = keys_ok
        rec["padded_key_tiles"] = int((mask.view(B, -1, 64).amax(-1) == 0)
                                      .sum()) if T % 64 == 0 else None
        check(keys_ok, f"case {name}: padded keys' dk / dv are not exactly 0")
    for part in ("dq", "dkv"):
        bound, by, flops, nbytes, simt, peak = bwd_bound_ms(
            B, H, T, D, dtype, causal, mask, part)
        rec.update({f"bound_ms_{part}": bound, f"bound_by_{part}": by,
                    f"bound_peak_{part}": peak,
                    f"bound_ms_simt_{part}": simt,
                    f"flops_{part}": flops, f"bytes_{part}": nbytes})
    if timed:
        rec["ms_dq"] = device_ms(lambda: flash_attention_dq(
            q, k, v, d_out, lse, dvec, **kw))
        rec["ms_dkv"] = device_ms(lambda: flash_attention_dkv(
            q, k, v, d_out, lse, dvec, **kw))
        rec["plain_ms_dq"] = device_ms(lambda: attention_bwd_plain(
            q, k, v, d_out, lse, dvec, want_dkv=False, **kw))
        rec["plain_ms_dkv"] = device_ms(lambda: attention_bwd_plain(
            q, k, v, d_out, lse, dvec, want_dq=False, **kw))
        rec["library_ms"] = (sdpa_backward_ms(q, k, v, d_out, causal)
                             if mask is None else None)
        rec["library_covers"] = "dq + dk + dv (K5 and K6 together)"
        for part in ("dq", "dkv"):
            rec[f"achieved_tflops_{part}"] = (
                rec[f"flops_{part}"] / (rec[f"ms_{part}"] * 1e-3) / 1e12)
    emit(rec)
    check(ok, f"case {name}: K5/K6 differ from the plain backward: {rec}")
    check(rec["bitwise_repeat"], f"case {name}: two launches differ")
    return rec


def ptxas_report(names):
    """Registers, stack and spills of every kernel of the named libraries,
    from nvcc's ``-Xptxas -v`` log beside each library: the attention
    kernels' head-dim template (``dmax``, and ``wide`` for the template
    that splits o's columns across blocks), the LSTM kernels' body
    (streaming or resident)."""
    out = []
    for name in names:
        cur = None
        log = Path(f"{library_path(name)}.log").read_text()
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                cur = dict(library=name)
                k = re.search(r"(flash_fwd_kernel|flash_dq_kernel|"
                              r"flash_dkv_kernel)I"
                              r"(f|13__nv_bfloat16)Li(\d+)ELb([01])E",
                              m.group(1))
                if k:
                    cur.update(kernel=k.group(1), dmax=int(k.group(3)),
                               wide=k.group(4) == "1",
                               dtype="float32" if k.group(2) == "f"
                               else "bfloat16")
                k = re.search(r"(lstm_fwd_infer_kernel|lstm_fwd_train_kernel|"
                              r"lstm_bwd_kernel)I(f|13__nv_bfloat16)Lb([01])E",
                              m.group(1))
                if k:
                    cur.update(kernel=k.group(1),
                               body="resident" if k.group(3) == "1"
                               else "streaming",
                               dtype="float32" if k.group(2) == "f"
                               else "bfloat16")
                out.append(cur)
                continue
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", line)
            if m and cur is not None:
                cur.update(stack_bytes=int(m.group(1)),
                           spill_stores=int(m.group(2)),
                           spill_loads=int(m.group(3)))
            m = re.search(r"Used (\d+) registers", line)
            if m and cur is not None:
                cur["registers"] = int(m.group(1))
    return out


def lstm_bounds(nbytes, flops, dtype):
    """(bound ms, "bytes" or "operations", the peak's name, the bound at
    the f32 CUDA-core peak) for K1-K3's work, as ``attention_bound_ms``
    counts it: the products at the card's fastest peak for the input type
    (the tensor cores in 3xTF32 for f32, bf16 for bf16), whatever units
    the kernel runs them on (K1-K3 run theirs as f32 FMAs on CUDA cores,
    the figure kept beside it)."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    peak, peak_name = ((TF32X3_FLOPS_PER_S, "3xTF32 tensor cores")
                       if dtype == torch.float32
                       else (BF16_FLOPS_PER_S, "bf16 tensor cores"))
    t_ops = flops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", peak_name,
            max(t_bytes, flops / F32_FLOPS_PER_S) * 1e3)


def lstm_bound_ms(T, B, H, dtype):
    """Least time for the recurrence on an H100: xz, rw, pw and the carries
    read once and hs, c_T written once over HBM, against the multiply-adds
    of h @ rw over the T steps (``lstm_bounds``). Returns (bound ms, by,
    flops, bytes, peak, bound at the f32 CUDA-core peak)."""
    es = torch.tensor([], dtype=dtype).element_size()
    nbytes = es * (T * B * 4 * H + H * 4 * H + 3 * H + 2 * B * H
                   + T * B * H + B * H)
    flops = 2.0 * B * H * 4 * H * T
    bound, by, peak, simt = lstm_bounds(nbytes, flops, dtype)
    return bound, by, flops, nbytes, peak, simt


def lstm_stepwise(xz, rw, pw, h0, c0, hs, cT, fb):
    """The kernel's T-step launch against T launches of one step each,
    every step started from the carry the previous one returned: they must
    agree bit for bit (the carry lives in the input type both ways). Each
    one-step launch is held against the plain step from the same carry.
    Returns whether all steps agree bit for bit, the largest step errors
    (h, c) and the largest |c| of the plain steps."""
    h, c = h0, c0
    equal = True
    err_h = err_c = c_max = 0.0
    for t in range(xz.shape[0]):
        x_t = xz[t:t + 1]
        hs_t, h_new, c_new = lstm_recurrence(x_t, rw, pw, h, c,
                                             forget_bias=fb)
        _, h_ref, c_ref = lstm_recurrence_plain(x_t, rw, pw, h, c,
                                                forget_bias=fb)
        equal = equal and torch.equal(hs_t[0], hs[t])
        err_h = max(err_h, float((h_new.float() - h_ref.float()).abs().max()))
        err_c = max(err_c, float((c_new.float() - c_ref.float()).abs().max()))
        c_max = max(c_max, float(c_ref.float().abs().max()))
        h, c = h_new, c_new
    return equal and torch.equal(c, cT), err_h, err_c, c_max


def lstm_inputs(T, B, H, dtype, peephole, carry, library=False):
    """K1's inputs on the card, ``(xz, rw, pw, h0, c0)``, and with
    ``library`` the (x, w, b) they come from (x [B, T, F] through
    x @ W + b, F = the char-RNN's vocabulary)."""
    g = torch.Generator().manual_seed(SEED + T + B + H)
    rw = torch.randn(H, 4 * H, generator=g) * H ** -0.5
    pw = (torch.randn(3, H, generator=g) * 0.3 if peephole
          else torch.zeros(3, H))
    h0, c0 = ((torch.randn(B, H, generator=g) * 0.5,
               torch.randn(B, H, generator=g)) if carry
              else (torch.zeros(B, H), torch.zeros(B, H)))
    src = None
    if library:
        F = LSTM_SLICE["vocab_size"]
        x = torch.randn(B, T, F, generator=g)
        w = torch.randn(F, 4 * H, generator=g) * F ** -0.5
        b = torch.randn(4 * H, generator=g) * 0.1
        xz = (x @ w + b).transpose(0, 1)
        src = tuple(a.cuda() for a in (x, w, b))
    else:
        xz = torch.randn(T, B, 4 * H, generator=g)
    return tuple(a.to("cuda", dtype).contiguous()
                 for a in (xz, rw, pw, h0, c0)), src


def lstm_plan(name, B, H, dtype):
    """The body and launch shape K1, K2 or K3 (``name``) runs for (B, H,
    dtype), from the built library; it must be the resident body up to
    ``RESIDENT_MAX_HIDDEN`` (K1, K2) or ``BWD_RESIDENT_MAX_HIDDEN`` (K3)
    and the streaming body past it, and a resident body runs clusters of
    8 CTAs, 4 rows a cluster."""
    plan = launch_plan(name, B, H, dtype)
    limits = BWD_RESIDENT_MAX_HIDDEN if name == "lstm_bwd" \
        else RESIDENT_MAX_HIDDEN
    want = "resident" if H <= limits[dtype] else "streaming"
    check(plan["body"] == want and (want == "streaming" or (
        plan["cluster"], plan["rows_per_cluster"]) == (8, 4)),
          f"{name} at B={B}, H={H}, {dtype}: the library runs {plan}, "
          f"the limit {limits[dtype]} says the {want} body")
    return plan


def lstm_case(name, T, B, H, dtype, peephole, carry, timed=False,
              library=False, stepwise=False):
    """K1 against its plain version on the card. ``library``: the inputs
    come from x [B, T, F] (F = the char-RNN's vocabulary, its first layer's
    input) through x @ W + b, and the whole fused_lstm (the input GEMM and
    the kernel) is timed beside torch.nn.LSTM (cuDNN) on the same weights,
    which has no peepholes. ``stepwise``: also ``lstm_stepwise``."""
    (xz, rw, pw, h0, c0), src = lstm_inputs(T, B, H, dtype, peephole, carry,
                                            library)
    fb = 1.0
    hs, hT, cT = lstm_recurrence(xz, rw, pw, h0, c0, forget_bias=fb)
    ref = lstm_recurrence_plain(xz, rw, pw, h0, c0, forget_bias=fb)
    torch.cuda.synchronize()
    errs = [float((a.float() - r.float()).abs().max())
            for a, r in zip((hs, hT, cT), ref)]
    tol = TOL_LSTM_F32 if dtype == torch.float32 else TOL_LSTM_BF16
    c_max = float(ref[2].float().abs().max())
    tol_c = tol * max(1.0, c_max)
    bound, bound_by, flops, nbytes, peak, simt = lstm_bound_ms(
        T, B, H, dtype)
    rec = dict(phase="kernel", kernel="lstm_fwd_infer", case=name,
               shape=dict(T=T, B=B, H=H), dtype=str(dtype),
               peephole=peephole, nonzero_carry=carry,
               plan=lstm_plan("lstm_fwd_infer", B, H, dtype),
               max_abs_err_hs=errs[0], max_abs_err_hT=errs[1],
               max_abs_err_cT=errs[2], tol=tol, max_abs_cT=c_max,
               tol_cT=tol_c, bound_ms=bound, bound_by=bound_by,
               bound_peak=peak, bound_ms_simt=simt, flops=flops,
               bytes=nbytes, bitwise_repeat=bool(all(
                   torch.equal(a, b) for a, b in zip(
                       (hs, cT), lstm_recurrence(xz, rw, pw, h0, c0,
                                                 forget_bias=fb)[::2]))))
    if stepwise:
        equal, err_h, err_c, c_step = lstm_stepwise(xz, rw, pw, h0, c0, hs,
                                                    cT, fb)
        rec.update(steps_equal_launch=equal, max_abs_err_step_h=err_h,
                   max_abs_err_step_c=err_c,
                   tol_step_c=tol * max(1.0, c_step))
    if timed:
        rec["ms"] = device_ms(lambda: lstm_recurrence(xz, rw, pw, h0, c0,
                                                      forget_bias=fb))
        rec["plain_ms"] = device_ms(lambda: lstm_recurrence_plain(
            xz, rw, pw, h0, c0, forget_bias=fb), iters=5)
        rec["achieved_tflops"] = flops / (rec["ms"] * 1e-3) / 1e12
        rec["library_ms"] = None
    if library:
        x, w, b = src
        F = LSTM_SLICE["vocab_size"]
        # yardstick only: the port never calls cuDNN. Gate order i, f, g, o
        # as in the port; the forget bias folds into cuDNN's input bias
        lstm = torch.nn.LSTM(F, H, batch_first=True).cuda().eval()
        b_fold = b.clone()
        b_fold[H:2 * H] += fb
        with torch.no_grad():
            lstm.weight_ih_l0.copy_(w.t())
            lstm.weight_hh_l0.copy_(rw.t())
            lstm.bias_ih_l0.copy_(b_fold)
            lstm.bias_hh_l0.zero_()
            ys_lib, (h_lib, c_lib) = lstm(x, (h0[None], c0[None]))
            ys, _, c_k = fused_lstm(x, w, rw, b, None, h0, c0,
                                    forget_bias=fb)
            rec["library_ms"] = device_ms(lambda: lstm(x, (h0[None],
                                                           c0[None])))
        rec["kernel_plus_input_gemm_ms"] = device_ms(lambda: fused_lstm(
            x, w, rw, b, None, h0, c0, forget_bias=fb))
        rec["library"] = "torch.nn.LSTM (cuDNN), input GEMM included"
        rec["max_abs_diff_vs_library"] = float(max(
            (ys - ys_lib).abs().max(), (c_k - c_lib[0]).abs().max()))
    emit(rec)
    check(max(errs[:2]) <= tol and errs[2] <= tol_c,
          f"case {name}: LSTM kernel differs by {errs} > ({tol}, {tol}, "
          f"{tol_c})")
    check(rec["bitwise_repeat"], f"case {name}: two launches differ")
    if stepwise:
        check(rec["steps_equal_launch"], f"case {name}: the {T}-step "
              "launch differs from its own one-step launches")
        check(rec["max_abs_err_step_h"] <= tol and
              rec["max_abs_err_step_c"] <= rec["tol_step_c"],
              f"case {name}: a kernel step differs from the plain step")
    return rec


def lstm_train_bound_ms(T, B, H, dtype, part):
    """Least time for K2's (``part="fwd"``) or K3's (``"bwd"``) work on an
    H100: each input read once and each output written once over HBM (K2:
    xz, rw, pw, h0, c0 in; hs, gates, cs out. K3: eps, gates, cs, c0, rw^T,
    pw, dh_T, dc_T in; dz, dh0, dc0 out), against the multiply-adds of
    h @ rw (K2) or dz @ rw^T (K3) over the T steps at the peak of their
    (``lstm_bounds``)."""
    es = torch.tensor([], dtype=dtype).element_size()
    if part == "fwd":
        n = T * B * 4 * H + H * 4 * H + 3 * H + 2 * B * H \
            + T * B * H + T * B * 4 * H + T * B * H
    else:
        n = T * B * H + T * B * 4 * H + T * B * H + B * H + 4 * H * H \
            + 3 * H + 2 * B * H + T * B * 4 * H + 2 * B * H
    nbytes = es * n
    flops = 2.0 * B * H * 4 * H * T
    bound, by, peak, simt = lstm_bounds(nbytes, flops, dtype)
    return bound, by, flops, nbytes, peak, simt


def cudnn_training_ms(B, T, H, g, h0, c0, rw, pw, fb):
    """Yardstick only (the port never calls cuDNN): torch.nn.LSTM (cuDNN,
    no peepholes) in training at the window's shape with the char-RNN's
    first-layer input (F = 96), in the inputs' type: its forward with
    grad enabled, and its backward (forward + backward minus forward:
    dW_ih, dW_hh, the biases). Beside them, on the same x: K2 with the
    input GEMM x @ W + b, and K3 with the weight-gradient GEMMs
    dRW = h_prev^T dz and dW = x^T dz."""
    F_in, dt = LSTM_SLICE["vocab_size"], rw.dtype
    x = torch.randn(B, T, F_in, generator=g).to("cuda", dt)
    w = (torch.randn(F_in, 4 * H, generator=g) * F_in ** -0.5).to("cuda",
                                                                   dt)
    b = (torch.randn(4 * H, generator=g) * 0.1).to("cuda", dt)
    d_out = torch.randn(B, T, H, generator=g).to("cuda", dt)
    lstm = torch.nn.LSTM(F_in, H, batch_first=True).to("cuda", dt).train()
    params = list(lstm.parameters())

    def lib_fwd():
        return lstm(x, (h0[None], c0[None]))[0]

    def lib_fwd_bwd():
        torch.autograd.grad(lib_fwd(), params, d_out)

    def ours_fwd():
        xz = (x.reshape(B * T, F_in) @ w + b).reshape(B, T, 4 * H)
        return lstm_fwd_train(xz.transpose(0, 1).contiguous(), rw, pw, h0,
                              c0, forget_bias=fb)

    hs, gates, cs = ours_fwd()
    eps = d_out.transpose(0, 1).contiguous()
    x_tm = x.transpose(0, 1).reshape(T * B, F_in)
    zeros = torch.zeros_like(h0)

    def ours_bwd():
        dz = lstm_bwd(eps, gates, cs, c0, rw, pw, zeros, zeros)[0]
        h_prev = torch.cat([h0[None], hs[:-1]]).reshape(T * B, H)
        dz = dz.reshape(T * B, 4 * H)
        return h_prev.t() @ dz, x_tm.t() @ dz

    lib_f = device_ms(lib_fwd)
    return dict(library_ms_fwd=lib_f,
                library_ms_bwd=device_ms(lib_fwd_bwd) - lib_f,
                kernel_plus_input_gemm_ms=device_ms(ours_fwd),
                kernel_plus_weight_grad_gemms_ms=device_ms(ours_bwd),
                library="torch.nn.LSTM (cuDNN) in training, no peepholes, "
                        f"x [{B}, {T}, {F_in}] -> H {H}, "
                        f"{str(dt).split('.')[-1]}")


def lstm_train_case(name, T, B, H, dtype, peephole, carry, timed=False):
    """K2 and K3 against their plain versions on the card: K2's hs, gates
    and cells; K2's hs and c_T against K1's bit for bit; K3, on K2's
    residuals, seeded with nonzero (dh_T, dc_T) when ``carry``; two
    launches of each bitwise equal. ``timed``: kernel, plain and cuDNN
    times (``cudnn_training_ms``)."""
    g = torch.Generator().manual_seed(SEED + 7 * T + B + H)
    rw = torch.randn(H, 4 * H, generator=g) * H ** -0.5
    pw = (torch.randn(3, H, generator=g) * 0.3 if peephole
          else torch.zeros(3, H))
    xz = torch.randn(T, B, 4 * H, generator=g)
    h0, c0, dh_T, dc_T = ((torch.randn(B, H, generator=g) * s
                           for s in (0.5, 1.0, 1.0, 1.0)) if carry
                          else (torch.zeros(B, H) for _ in range(4)))
    eps = torch.randn(T, B, H, generator=g)
    xz, rw, pw, h0, c0, dh_T, dc_T, eps = (
        a.to("cuda", dtype).contiguous()
        for a in (xz, rw, pw, h0, c0, dh_T, dc_T, eps))
    fb = 1.0
    fwd = lstm_fwd_train(xz, rw, pw, h0, c0, forget_bias=fb)
    fwd2 = lstm_fwd_train(xz, rw, pw, h0, c0, forget_bias=fb)
    with torch.no_grad():
        hs1, _, cT1 = lstm_recurrence(xz, rw, pw, h0, c0, forget_bias=fb)
    hs, gates, cs = fwd
    bwd = lstm_bwd(eps, gates, cs, c0, rw, pw, dh_T, dc_T)
    bwd2 = lstm_bwd(eps, gates, cs, c0, rw, pw, dh_T, dc_T)
    ref_f = lstm_fwd_train_plain(xz, rw, pw, h0, c0, forget_bias=fb)
    c_prev = torch.cat([c0[None], cs[:-1]])
    ref_b = lstm_bwd_plain(eps, gates, cs, c_prev, rw, pw, dh_T, dc_T)
    torch.cuda.synchronize()
    f32 = dtype == torch.float32
    rel = {"fwd": TOL_K2_F32 if f32 else TOL_LSTM_TRAIN_BF16,
           "bwd": TOL_K3_F32 if f32 else TOL_LSTM_TRAIN_BF16}
    rec = dict(phase="kernel", kernel="lstm_fwd_train+lstm_bwd", case=name,
               shape=dict(T=T, B=B, H=H), dtype=str(dtype),
               peephole=peephole, nonzero_carry=carry,
               plan=lstm_plan("lstm_fwd_train", B, H, dtype),
               plan_bwd=lstm_plan("lstm_bwd", B, H, dtype),
               k2_equals_k1=bool(torch.equal(hs, hs1) and
                                 torch.equal(cs[-1], cT1)),
               bitwise_repeat=bool(
                   all(torch.equal(a, b) for a, b in zip(fwd, fwd2)) and
                   all(torch.equal(a, b) for a, b in zip(bwd, bwd2))))
    ok = True
    for part, names, got, want in (
            ("fwd", ("hs", "gates", "cs"), fwd, ref_f),
            ("bwd", ("dz", "dh0", "dc0"), bwd, ref_b)):
        for n, a, r in zip(names, got, want):
            err = float((a.float() - r.float()).abs().max())
            tol = rel[part] * max(1.0, float(r.float().abs().max()))
            rec[f"max_abs_err_{n}"], rec[f"tol_{n}"] = err, tol
            ok = ok and err <= tol and bool(torch.isfinite(a).all())
        bound, by, flops, nbytes, peak, simt = lstm_train_bound_ms(
            T, B, H, dtype, part)
        rec.update({f"bound_ms_{part}": bound, f"bound_by_{part}": by,
                    f"bound_peak_{part}": peak,
                    f"bound_ms_simt_{part}": simt,
                    f"flops_{part}": flops, f"bytes_{part}": nbytes})
    if timed:
        rec["ms_fwd"] = device_ms(lambda: lstm_fwd_train(
            xz, rw, pw, h0, c0, forget_bias=fb))
        rec["ms_bwd"] = device_ms(lambda: lstm_bwd(eps, gates, cs, c0, rw,
                                                   pw, dh_T, dc_T))
        rec["plain_ms_fwd"] = device_ms(lambda: lstm_fwd_train_plain(
            xz, rw, pw, h0, c0, forget_bias=fb), iters=5)
        rec["plain_ms_bwd"] = device_ms(lambda: lstm_bwd_plain(
            eps, gates, cs, c_prev, rw, pw, dh_T, dc_T), iters=5)
        rec.update(cudnn_training_ms(B, T, H, g, h0, c0, rw, pw, fb))
    emit(rec)
    check(ok, f"case {name}: K2/K3 differ from their plain versions: {rec}")
    check(rec["k2_equals_k1"], f"case {name}: K2's hs / c_T differ from K1's")
    check(rec["bitwise_repeat"], f"case {name}: two launches differ")
    return rec


def gpt_slice(k4_ms):
    """Full-width GPT serving on the card. Returns the flash kernel's
    launches on this path."""
    conf = gpt_decoder(**SLICE)
    net = ComputationGraph(conf, device="cuda").init()
    cpu = ComputationGraph(gpt_decoder(**SLICE), device="cpu").init()
    B, T, V, L = 32, SLICE["seq_len"], SLICE["vocab_size"], \
        SLICE["n_layers"]
    rng = np.random.default_rng(SEED)
    x = np.eye(V, dtype=np.float32)[rng.integers(0, V, (B, T))]
    lengths = rng.integers(T // 4, T + 1, B)
    lengths[0] = T
    mask = (np.arange(T)[None, :] < lengths[:, None]).astype(np.float32)
    prompts = [rng.integers(0, V, n).tolist() for n in (5, 12, 27, 40)]
    n_new = 32

    reset_counts()
    probs = net.output(x)
    torch.cuda.synchronize()
    launches_plain = flash_attention.launches
    probs_m = net.output(x, mask=mask)
    torch.cuda.synchronize()
    launches_masked = flash_attention.launches - launches_plain
    tokens = [greedy_generate(net, p, n_new) for p in prompts]
    main_path = counts()
    # serving runs under no_grad: no backward kernel launches
    check(main_path["flash_attn_fwd"] > 0 and
          main_path["flash_attn_dq"] == main_path["flash_attn_dkv"] == 0 and
          main_path["lstm_fwd_infer"] == main_path["lstm_fwd_train"] ==
          main_path["lstm_bwd"] == 0,
          f"GPT path launches {main_path}")

    check(launches_plain == L and launches_masked == L,
          f"flash kernel launches per forward {launches_plain}, "
          f"{launches_masked} != n_layers {L}")
    check(tuple(probs.shape) == (B, T, V), f"output shape {probs.shape}")
    check(bool(torch.isfinite(probs).all() and torch.isfinite(probs_m).all()),
          "non-finite probabilities")
    sums = probs.sum(-1)
    sums_m = probs_m.sum(-1)
    mask_t = torch.from_numpy(mask).cuda()
    err_sum = float((sums - 1).abs().max())
    err_sum_m = float((sums_m - mask_t).abs().max())
    check(err_sum < 1e-5 and err_sum_m < 1e-5,
          f"probabilities do not sum to 1 (masked rows to 0): {err_sum}, "
          f"{err_sum_m}")
    ref = cpu.output(x)
    ref_m = cpu.output(x, mask=mask)
    err_cpu = float((probs.cpu() - ref).abs().max())
    err_cpu_m = float((probs_m.cpu() - ref_m).abs().max())
    cpu_tokens = [greedy_generate(cpu, p, n_new) for p in prompts]
    emit(dict(phase="slice", config=SLICE, params=net.num_params(),
              batch=[B, T, V], flash_launches_per_forward=[
                  launches_plain, launches_masked],
              main_path_launches=main_path,
              max_abs_err_vs_cpu=err_cpu, max_abs_err_vs_cpu_masked=err_cpu_m,
              tol=TOL_SLICE, prob_sum_err=err_sum,
              prob_sum_err_masked=err_sum_m,
              prompt_lens=[len(p) for p in prompts], new_tokens=n_new,
              tokens_equal_cpu=tokens == cpu_tokens))
    check(err_cpu <= TOL_SLICE and err_cpu_m <= TOL_SLICE,
          f"card vs CPU output differs: {err_cpu}, {err_cpu_m}")
    check(tokens == cpu_tokens, f"greedy tokens differ: {tokens} vs "
                                f"{cpu_tokens}")

    fwd_ms = host_ms(lambda: net.output(x))
    fwd_m_ms = host_ms(lambda: net.output(x, mask=mask))
    gen1 = host_ms(lambda: greedy_generate(net, prompts[2], 1))
    gen_n = host_ms(lambda: greedy_generate(net, prompts[2], n_new))
    emit(dict(phase="slice_timing", forward_ms=fwd_ms,
              forward_tokens_per_s=B * T / (fwd_ms * 1e-3),
              forward_masked_ms=fwd_m_ms,
              attention_kernel_share_of_forward=L * k4_ms / fwd_ms,
              prefill_plus_first_token_ms=gen1,
              decode_ms_per_step=(gen_n - gen1) / (n_new - 1),
              peak_mem_bytes=torch.cuda.max_memory_allocated()))

    _, decode = net.decode_fns()
    caches = net.init_decode_cache(1)
    x1 = torch.zeros((1, 1, V), device="cuda")
    x1[0, 0, 3] = 1.0
    emit(dict(phase="profile", window="output() of the [32, 256, 96] batch",
              **device_profile(lambda: net.output(x),
                               {"flash_fwd_kernel": L})))
    # the decode step is plain torch, as the JAX package leaves it to XLA:
    # no flash launch
    emit(dict(phase="profile", window="16 decode steps, 1 row",
              **device_profile(lambda: [decode(
                  net.params, net.states, caches, x1,
                  torch.tensor([60 + i], device="cuda"))
                  for i in range(16)], {"flash_fwd_kernel": 0})))
    return main_path["flash_attn_fwd"]


def lstm_slice(k1_ms):
    """Full-width char-RNN serving on the card. Returns the LSTM kernel's
    launches on this path."""
    net = MultiLayerNetwork(char_rnn_lstm(**LSTM_SLICE), device="cuda").init()
    cpu = MultiLayerNetwork(char_rnn_lstm(**LSTM_SLICE), device="cpu").init()
    (B, T), V, L = LSTM_BATCH, LSTM_SLICE["vocab_size"], \
        LSTM_SLICE["layers"]
    rng = np.random.default_rng(SEED + 1)
    x = np.eye(V, dtype=np.float32)[rng.integers(0, V, (B, T))]
    lengths = rng.integers(T // 4, T + 1, B)
    lengths[0] = T
    mask = (np.arange(T)[None, :] < lengths[:, None]).astype(np.float32)

    reset_counts()
    probs = net.output(x)
    torch.cuda.synchronize()
    n_out = lstm_recurrence.launches
    probs_m = net.output(x, mask=mask)
    torch.cuda.synchronize()
    n_masked = lstm_recurrence.launches - n_out
    net.rnn_clear_previous_state()
    stream = torch.stack([net.rnn_time_step(x[:, t]) for t in range(T)], 1)
    torch.cuda.synchronize()
    main_path = counts()
    n_stream = main_path["lstm_fwd_infer"] - n_out - n_masked
    check(main_path["lstm_fwd_infer"] > 0 and
          main_path["flash_attn_fwd"] == main_path["flash_attn_dq"] ==
          main_path["flash_attn_dkv"] == main_path["lstm_fwd_train"] ==
          main_path["lstm_bwd"] == 0,
          f"char-RNN path launches {main_path}")
    check(n_out == L and n_masked == 0 and n_stream == L * T,
          f"LSTM kernel launches: output {n_out} (want {L}), masked "
          f"{n_masked} (want 0), stream {n_stream} (want {L * T})")
    check(tuple(probs.shape) == (B, T, V) and stream.shape == probs.shape,
          f"output shapes {probs.shape}, {stream.shape}")
    check(bool(torch.isfinite(probs).all() and torch.isfinite(probs_m).all()
               and torch.isfinite(stream).all()), "non-finite probabilities")
    # the head takes no mask (as in the JAX container): every row sums to 1
    err_sum = float(max((probs.sum(-1) - 1).abs().max(),
                        (probs_m.sum(-1) - 1).abs().max()))
    check(err_sum < 1e-5, f"probabilities do not sum to 1: {err_sum}")
    err_cpu = float((probs.cpu() - cpu.output(x)).abs().max())
    err_cpu_m = float((probs_m.cpu() - cpu.output(x, mask=mask)).abs().max())
    err_stream = float((stream - probs).abs().max())
    emit(dict(phase="lstm_slice", config=LSTM_SLICE,
              params=net.num_params(), batch=[B, T, V],
              lstm_launches=dict(output=n_out, output_masked=n_masked,
                                 stream=n_stream),
              main_path_launches=main_path,
              max_abs_err_vs_cpu=err_cpu, max_abs_err_vs_cpu_masked=err_cpu_m,
              max_abs_err_stream_vs_output=err_stream, tol=TOL_LSTM_SLICE,
              prob_sum_err=err_sum))
    check(max(err_cpu, err_cpu_m) <= TOL_LSTM_SLICE,
          f"card vs CPU output differs: {err_cpu}, {err_cpu_m}")
    check(err_stream <= TOL_LSTM_SLICE,
          f"streamed output differs from output(): {err_stream}")

    fwd_ms = host_ms(lambda: net.output(x))
    fwd_m_ms = host_ms(lambda: net.output(x, mask=mask))
    net.rnn_clear_previous_state()
    step32 = host_ms(lambda: net.rnn_time_step(x[:, 0]), iters=32)
    x1 = x[:1]
    net.rnn_clear_previous_state()
    step1 = host_ms(lambda: net.rnn_time_step(x1[:, 0]), iters=32)
    emit(dict(phase="lstm_slice_timing", output_ms=fwd_ms,
              sequences_per_s=B / (fwd_ms * 1e-3),
              tokens_per_s=B * T / (fwd_ms * 1e-3),
              output_masked_ms=fwd_m_ms,
              lstm_kernel_share_of_output=L * k1_ms / fwd_ms,
              rnn_time_step_ms_b32=step32, rnn_time_step_ms_b1=step1,
              peak_mem_bytes=torch.cuda.max_memory_allocated()))

    emit(dict(phase="profile", window="char-RNN output() of [32, 64, 96]",
              **device_profile(lambda: net.output(x),
                               {"lstm_fwd_infer_kernel": L},
                               groups=dict(lstm_k1=["lstm_fwd_infer_kernel"],
                                           gemm=["gemm"]))))
    net.rnn_clear_previous_state()
    emit(dict(phase="profile", window="16 rnn_time_step calls, 32 rows",
              **device_profile(lambda: [net.rnn_time_step(x[:, t])
                                        for t in range(16)],
                               {"lstm_fwd_infer_kernel": 16 * L})))
    return main_path["lstm_fwd_infer"]


def train_slice():
    """Full-width GPT training on the card. Returns the main path's
    launch counts."""
    conf = gpt_decoder(**SLICE)
    net = ComputationGraph(conf, device="cuda").init()
    cpu = ComputationGraph(gpt_decoder(**SLICE), device="cpu").init()
    B, T, L = TRAIN_BATCH, SLICE["seq_len"], SLICE["n_layers"]
    n_batches = 4
    text = synthetic_char_text(n_batches * B * (T + 1) + 1, seed=SEED)
    batches = char_lm_batches(text, T, B, charset=CHARSET)
    check(len(batches) == n_batches and
          batches[0].features.shape == (B, T, len(CHARSET)),
          f"char batches: {len(batches)}, {batches[0].features.shape}")
    per_step = dict(flash_attn_fwd=L, flash_attn_dq=L, flash_attn_dkv=L,
                    lstm_fwd_infer=0, lstm_fwd_train=0, lstm_bwd=0)

    reset_counts()
    # step 1's gradients at the init params, on the card and the CPU
    grads, loss, _ = net.compute_gradient_and_score(batches[0])
    torch.cuda.synchronize()
    grad_launches = counts()
    cpu_grads, cpu_loss, _ = cpu.compute_gradient_and_score(batches[0])
    loss_rel = abs(float(loss) - float(cpu_loss)) / abs(float(cpu_loss))
    worst, worst_name = grad_rel_err(grads, cpu_grads)
    n_grads = sum(len(p) for p in cpu_grads.values())
    del grads, cpu_grads

    losses, cpu_losses, step_launches = [], [], []
    for i in range(3):
        before = counts()
        losses.append(float(net.fit_batch(batches[i % n_batches])))
        after = counts()
        step_launches.append({k: after[k] - before[k] for k in after})
        cpu_losses.append(float(cpu.fit_batch(batches[i % n_batches])))
    for i in range(3, 20):
        net.fit_batch(batches[i % n_batches])
    after_20 = net.score(batches[0])
    torch.cuda.synchronize()
    main_path = counts()
    steps_rel = [abs(a - b) / abs(b) for a, b in zip(losses, cpu_losses)]
    emit(dict(phase="train_slice", config=SLICE, params=net.num_params(),
              batch=[B, T, len(CHARSET)], updater="adam", lr=3e-4,
              step1_loss=float(loss), step1_loss_cpu=float(cpu_loss),
              step1_loss_rel_err=loss_rel, tol_loss=TOL_TRAIN_LOSS,
              grad_tensors=n_grads, worst_grad_rel_err=worst,
              worst_grad=worst_name, tol_grad=TOL_TRAIN_GRAD,
              losses=losses, losses_cpu=cpu_losses,
              steps_rel_err=steps_rel, tol_steps=TOL_TRAIN_STEPS,
              launches_per_fit_batch=step_launches,
              launches_per_gradient=grad_launches,
              loss_after_20_steps=after_20, main_path_launches=main_path))
    check(grad_launches == per_step,
          f"launches for one gradient {grad_launches} != {per_step}")
    check(all(c == per_step for c in step_launches),
          f"launches per fit_batch {step_launches} != {per_step}")
    check(loss_rel <= TOL_TRAIN_LOSS,
          f"step-1 loss {float(loss)} vs CPU {float(cpu_loss)}")
    check(worst <= TOL_TRAIN_GRAD,
          f"gradient {worst_name} differs from the CPU's by {worst} of "
          "its largest |g|")
    check(max(steps_rel) <= TOL_TRAIN_STEPS,
          f"losses {losses} vs CPU {cpu_losses}")
    check(after_20 < losses[0],
          f"loss after 20 steps {after_20} is not below {losses[0]}")

    torch.cuda.reset_peak_memory_stats()
    step_ms = host_ms(lambda: net.fit_batch(batches[1]), iters=10, warmup=2)
    peak = torch.cuda.max_memory_allocated()
    LIVE["gpt_train"] = dict(param_bytes=param_bytes(net),
                             moment_bytes=moment_bytes(net),
                             step_peak_bytes=peak, step_ms=step_ms)
    # the updater alone, on copies of the params and state
    grads, _, _ = net.compute_gradient_and_score(batches[1])
    params = tree_map(torch.clone, net.params)
    state = {k: v if isinstance(v, int) else tree_map(torch.clone, v)
             for k, v in net.opt_state.items()}
    layers = [conf.nodes[n].layer for n in net._layer_nodes]
    upd_ms = cuda_ms(lambda: compute_updates(
        net._tx, grads, state, params, layers, conf.training), iters=10,
        warmup=2)
    del grads, params, state
    emit(dict(phase="train_timing", ms_per_step=step_ms,
              tokens_per_s=B * T / (step_ms * 1e-3), updater_ms=upd_ms,
              updater_share_of_step=upd_ms / step_ms,
              peak_mem_bytes=peak))
    emit(dict(phase="profile", window="one fit_batch of [32, 256, 96]",
              **device_profile(
                  lambda: net.fit_batch(batches[2]),
                  {name: L for name in ATTENTION_KERNELS}, top=8,
                  groups=dict(attention=list(ATTENTION_KERNELS),
                              gemm=["gemm"]))))
    return main_path


def step_losses(net) -> list:
    """Record the loss of each of ``net``'s optimizer steps (each tBPTT
    window's) until ``del net._step``."""
    losses = []
    step = net._step

    def spy(grads, new_states, loss):
        losses.append(float(loss))
        step(grads, new_states, loss)
    net._step = spy
    return losses


def grad_rel_err(grads, cpu_grads):
    """The worst gradient tensor's max |card - CPU| over its own largest
    |g|, and its name (layer index or graph node, param name). ``grads``
    and ``cpu_grads``: a list of per-layer dicts or a dict of them."""
    keys = (list(cpu_grads) if isinstance(cpu_grads, dict)
            else range(len(cpu_grads)))
    worst, worst_name = 0.0, None
    for key in keys:
        for name, want in cpu_grads[key].items():
            got = grads[key][name].cpu()
            check(bool(torch.isfinite(got).all()),
                  f"{key}.{name}: non-finite gradient")
            err = float((got - want).abs().max()) / max(
                float(want.abs().max()), 1e-30)
            if err > worst:
                worst, worst_name = err, f"{key}.{name}"
    return worst, worst_name


def lstm_train_slice():
    """Full-width char-RNN training with tBPTT on the card. Returns the
    main path's launch counts."""
    conf = char_rnn_lstm(**LSTM_SLICE)
    net = MultiLayerNetwork(conf, device="cuda").init()
    cpu = MultiLayerNetwork(char_rnn_lstm(**LSTM_SLICE), device="cpu").init()
    (B, T), L = LSTM_TRAIN_BATCH, LSTM_SLICE["layers"]
    win = conf.training.tbptt_fwd_length
    n_win, n_batches = -(-T // win), 4
    text = synthetic_char_text(n_batches * B * (T + 1) + 1, seed=SEED + 2)
    batches = char_lm_batches(text, T, B, charset=CHARSET)
    check(len(batches) == n_batches and
          batches[0].features.shape == (B, T, len(CHARSET)),
          f"char batches: {len(batches)}, {batches[0].features.shape}")
    first = DataSet(batches[0].features[:, :win], batches[0].labels[:, :win])
    short = DataSet(batches[1].features[:, :64], batches[1].labels[:, :64])
    none = dict(flash_attn_fwd=0, flash_attn_dq=0, flash_attn_dkv=0)
    per_window = dict(none, lstm_fwd_infer=0, lstm_fwd_train=L, lstm_bwd=L)
    per_fit = {k: n_win * v for k, v in per_window.items()}
    conf20 = char_rnn_lstm(**LSTM_SLICE)
    conf20.training.tbptt_bwd_length = 20
    net20 = MultiLayerNetwork(conf20, device="cuda").init()

    def launched(fn):
        before = counts()
        out = fn()
        torch.cuda.synchronize()
        return out, {k: v - before[k] for k, v in counts().items()}

    reset_counts()
    # the first tBPTT window's gradients at the init params
    (grads, loss, _), grad_launches = launched(
        lambda: net.compute_gradient_and_score(first))
    # one fit_batch of [32, 200]: its window losses, on the card and CPU
    losses = step_losses(net)
    mean, fit_launches = launched(lambda: float(net.fit_batch(batches[0])))
    del net._step
    # a [32, 64] batch: windows of 50 and 14
    _, short_launches = launched(lambda: net.fit_batch(short))
    # bwd < fwd: each window's head [0, 30) runs K1, its tail K2/K3
    loss20, bwd20_launches = launched(
        lambda: float(net20.fit_batch(batches[0])))
    means = [float(net.fit_batch(batches[i % n_batches]))
             for i in range(20)]
    torch.cuda.synchronize()
    main_path = counts()

    cpu_grads, cpu_loss, _ = cpu.compute_gradient_and_score(first)
    loss_rel = abs(float(loss) - float(cpu_loss)) / abs(float(cpu_loss))
    worst, worst_name = grad_rel_err(grads, cpu_grads)
    n_grads = sum(len(p) for p in cpu_grads)
    del grads, cpu_grads
    cpu_losses = step_losses(cpu)
    cpu_mean = float(cpu.fit_batch(batches[0]))
    windows_rel = [abs(a - b) / abs(b) for a, b in zip(losses, cpu_losses)]
    emit(dict(phase="lstm_train_slice", config=LSTM_SLICE,
              params=net.num_params(), batch=[B, T, len(CHARSET)],
              updater="adam", lr=conf.training.updater.learning_rate,
              clip=conf.training.gradient_normalization_threshold,
              tbptt=[win, conf.training.tbptt_bwd_length],
              window1_loss=float(loss), window1_loss_cpu=float(cpu_loss),
              window1_loss_rel_err=loss_rel, tol_loss=TOL_TRAIN_LOSS,
              grad_tensors=n_grads, worst_grad_rel_err=worst,
              worst_grad=worst_name, tol_grad=TOL_TRAIN_GRAD,
              window_losses=losses, window_losses_cpu=cpu_losses,
              windows_rel_err=windows_rel, tol_windows=TOL_TRAIN_STEPS,
              fit_batch_mean=mean, fit_batch_mean_cpu=cpu_mean,
              launches_per_gradient=grad_launches,
              launches_per_fit_batch=fit_launches,
              launches_per_short_batch=short_launches,
              bwd20_loss=loss20, bwd20_launches_per_fit_batch=bwd20_launches,
              means_over_20_calls=means, main_path_launches=main_path))
    check(grad_launches == per_window,
          f"launches for one window's gradient {grad_launches} != "
          f"{per_window}")
    check(fit_launches == per_fit,
          f"launches per fit_batch {fit_launches} != {per_fit}")
    check(short_launches == {k: 2 * v for k, v in per_window.items()},
          f"launches for a [32, 64] batch {short_launches}")
    check(bwd20_launches == dict(per_fit, lstm_fwd_infer=n_win * L),
          f"launches per fit_batch with bwd 20 {bwd20_launches}")
    check(np.isfinite(loss20), f"bwd 20 loss {loss20}")
    check(loss_rel <= TOL_TRAIN_LOSS,
          f"window-1 loss {float(loss)} vs CPU {float(cpu_loss)}")
    check(worst <= TOL_TRAIN_GRAD,
          f"gradient {worst_name} differs from the CPU's by {worst} of its "
          "largest |g|")
    check(len(losses) == len(cpu_losses) == n_win and
          max(windows_rel) <= TOL_TRAIN_STEPS,
          f"window losses {losses} vs CPU {cpu_losses}")
    check(np.mean(means[-n_batches:]) < np.mean(means[:n_batches]),
          f"the mean loss did not fall over 20 calls: {means}")

    torch.cuda.reset_peak_memory_stats()
    fit_ms = host_ms(lambda: net.fit_batch(batches[1]), iters=10, warmup=2)
    peak = torch.cuda.max_memory_allocated()
    # the updater alone, on copies of the params and state
    grads, _, _ = net.compute_gradient_and_score(first)
    params = tree_map(torch.clone, net.params)
    state = {k: v if isinstance(v, int) else tree_map(torch.clone, v)
             for k, v in net.opt_state.items()}
    upd_ms = cuda_ms(lambda: compute_updates(
        net._tx, grads, state, params, net.layers, conf.training), iters=10,
        warmup=2)
    del grads, params, state
    emit(dict(phase="lstm_train_timing", ms_per_fit_batch=fit_ms,
              ms_per_window=fit_ms / n_win,
              chars_per_s=B * T / (fit_ms * 1e-3), updater_ms=upd_ms,
              updater_share_of_fit_batch=n_win * upd_ms / fit_ms,
              peak_mem_bytes=peak))
    emit(dict(phase="profile", window="one fit_batch of [32, 200, 96]",
              **device_profile(
                  lambda: net.fit_batch(batches[2]),
                  {"lstm_fwd_train_kernel": n_win * L,
                   "lstm_bwd_kernel": n_win * L,
                   "lstm_fwd_infer_kernel": 0}, top=8,
                  groups=dict(lstm_k2_k3=["lstm_fwd_train_kernel",
                                          "lstm_bwd_kernel"],
                              lstm_k2=["lstm_fwd_train_kernel"],
                              lstm_k3=["lstm_bwd_kernel"],
                              gemm=["gemm"]))))
    return main_path


def wide_head_slice(config):
    """A GPT with wide heads on the card (``WIDE_SLICE``: heads of 256, the
    kernels' widest register template; ``WIDE512_SLICE``: heads of 512,
    their wide template): ``output()`` with and without a key mask, one
    gradient and two ``fit_batch`` calls through K4, K5 and K6, held
    against the same net on the CPU. Returns the path's launch counts."""
    net = ComputationGraph(gpt_decoder(**config), device="cuda").init()
    cpu = ComputationGraph(gpt_decoder(**config), device="cpu").init()
    B, T, V = WIDE_BATCH, config["seq_len"], config["vocab_size"]
    L = config["n_layers"]
    rng = np.random.default_rng(SEED + 3)
    x = np.eye(V, dtype=np.float32)[rng.integers(0, V, (B, T))]
    lengths = rng.integers(T // 4, T + 1, B)
    lengths[0] = T
    mask = (np.arange(T)[None, :] < lengths[:, None]).astype(np.float32)
    text = synthetic_char_text(B * (T + 1) + 1, seed=SEED + 3)
    batch = char_lm_batches(text, T, B, charset=CHARSET)[0]
    # two forwards, a gradient and two steps: 5 K4 and 3 K5, K6 per layer
    expect = dict(flash_attn_fwd=5 * L, flash_attn_dq=3 * L,
                  flash_attn_dkv=3 * L, lstm_fwd_infer=0, lstm_fwd_train=0,
                  lstm_bwd=0)

    reset_counts()
    probs = net.output(x)
    probs_m = net.output(x, mask=mask)
    grads, _, _ = net.compute_gradient_and_score(batch)
    losses = [float(net.fit_batch(batch)) for _ in range(2)]
    torch.cuda.synchronize()
    launched = counts()
    err = float((probs.cpu() - cpu.output(x)).abs().max())
    err_m = float((probs_m.cpu() - cpu.output(x, mask=mask)).abs().max())
    cpu_grads, _, _ = cpu.compute_gradient_and_score(batch)
    worst, worst_name = grad_rel_err(grads, cpu_grads)
    del grads, cpu_grads
    cpu_losses = [float(cpu.fit_batch(batch)) for _ in range(2)]
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, cpu_losses)]
    emit(dict(phase="wide_head_slice", config=config,
              head_dim=config["d_model"] // config["n_heads"],
              params=net.num_params(), batch=[B, T, V],
              main_path_launches=launched, expected_launches=expect,
              max_abs_err_vs_cpu=err, max_abs_err_vs_cpu_masked=err_m,
              tol=TOL_SLICE, worst_grad_rel_err=worst, worst_grad=worst_name,
              tol_grad=TOL_TRAIN_GRAD, losses=losses, losses_cpu=cpu_losses,
              loss_rel_err=rel, tol_loss=TOL_TRAIN_LOSS,
              tol_steps=TOL_TRAIN_STEPS))
    check(launched == expect,
          f"wide-head GPT launches {launched} != {expect}")
    check(tuple(probs.shape) == (B, T, V) and
          bool(torch.isfinite(probs).all() and torch.isfinite(probs_m).all()),
          f"output {tuple(probs.shape)} or non-finite probabilities")
    check(err <= TOL_SLICE and err_m <= TOL_SLICE,
          f"card vs CPU output differs: {err}, {err_m}")
    check(worst <= TOL_TRAIN_GRAD,
          f"gradient {worst_name} differs from the CPU's by {worst} of "
          "its largest |g|")
    check(rel[0] <= TOL_TRAIN_LOSS and rel[1] <= TOL_TRAIN_STEPS,
          f"losses {losses} vs CPU {cpu_losses}")
    return launched


def state_rel_err(states, ref_states):
    """The worst BN state tensor's max |s - ref| over max(1, its largest
    |ref|), and its name."""
    worst, worst_name = 0.0, None
    for key, st in ref_states.items():
        for name, want in st.items():
            got = states[key][name].detach().cpu().double()
            want = want.detach().cpu().double()
            err = float((got - want).abs().max()) / max(
                1.0, float(want.abs().max()))
            if err > worst:
                worst, worst_name = err, f"{key}.{name}"
    return worst, worst_name


def f64_reference(net, batch, device):
    """(loss, gradients, new states) of ``batch`` at ``net``'s params and
    states cast to f64 on ``device``, the batch cast too: a reference whose
    own rounding (~1e-16) is far below f32's, for gradients f32 cannot
    pin down."""
    p64 = tree_map(lambda t: t.to(device, torch.float64), net.params)
    s64 = tree_map(lambda t: t.to(device, torch.float64), net.states)
    x = torch.from_numpy(batch.features).to(device, torch.float64)
    y = torch.from_numpy(batch.labels).to(device, torch.float64)
    graph = isinstance(net, ComputationGraph)
    args = (({net.conf.network_inputs[0]: x},
             {net.conf.network_outputs[0]: y}) if graph else (x, y))
    loss, aux, grads = value_and_grad(
        lambda p: net._loss_fn(p, s64, *args, None, None, None), p64)
    return float(loss), grads, aux if graph else aux[0]


def grad_agreement(grads, ref):
    """How far ``grads`` lie from ``ref`` (a list of per-layer dicts or a
    dict of them): the worst tensor's max |g - ref| over its largest
    |ref|, the whole gradient's relative L2 distance, and the lowest
    cosine of any tensor with its reference."""
    worst, worst_name = grad_rel_err(grads, tree_map(
        lambda t: t.detach().cpu().double(), ref))
    num = den = 0.0
    cos, cos_name = 1.0, None
    keys = list(ref) if isinstance(ref, dict) else range(len(ref))
    for key in keys:
        for name, r in ref[key].items():
            g = grads[key][name].detach().cpu().double()
            r = r.detach().cpu().double()
            num += float(((g - r) ** 2).sum())
            den += float((r ** 2).sum())
            c = float((g * r).sum() / ((g * g).sum() * (r * r).sum()).sqrt()
                      .clamp(min=1e-300))
            if c < cos:
                cos, cos_name = c, f"{key}.{name}"
    return dict(worst_rel=worst, worst=worst_name,
                global_rel_l2=(num / max(den, 1e-300)) ** 0.5,
                min_cos=cos, min_cos_tensor=cos_name)


def lenet_case(device="cuda"):
    """LeNet-5 trained on the card: the step-1 loss against the same net
    on the CPU and every gradient against the CPU's f64 gradient (the
    CPU's f32 conv2 gradient is 5.6e-4 of its largest |g| from the f64
    one, the card's 4e-7), its next losses, a loss that falls over 50
    Adam steps, ``evaluate()`` on unseen training-split examples, ms per
    step and images/s."""
    net = MultiLayerNetwork(lenet_mnist(), device=device).init()
    cpu = MultiLayerNetwork(lenet_mnist(), device="cpu").init()
    mnist = MnistDataSetIterator(
        LENET_BATCH, num_examples=LENET_BATCH * LENET_STEPS + LENET_HELD_OUT,
        flatten=False, seed=SEED)
    batches = list(mnist)
    train, held_out = batches[:LENET_STEPS], batches[LENET_STEPS:]
    grads, loss, _ = net.compute_gradient_and_score(train[0])
    cpu_grads, cpu_loss, _ = cpu.compute_gradient_and_score(train[0])
    _, ref, _ = f64_reference(cpu, train[0], "cpu")
    vs_f64 = grad_agreement(grads, ref)
    vs_cpu = grad_agreement(grads, cpu_grads)
    cpu_vs_f64 = grad_agreement(cpu_grads, ref)
    del grads, cpu_grads, ref
    losses = [float(net.fit_batch(b)) for b in train[:3]]
    cpu_losses = [float(cpu.fit_batch(b)) for b in train[:3]]
    for b in train[3:]:
        net.fit_batch(b)
    after = net.score(train[0])
    evaluation = net.evaluate(ListDataSetIterator(held_out))
    step_ms = host_ms(lambda: net.fit_batch(train[1]), iters=10, warmup=2)
    return dict(config="lenet_mnist()", batch=[LENET_BATCH, 28, 28, 1],
                updater="adam", lr=1e-3, synthetic=mnist.is_synthetic,
                step1_loss=float(loss), step1_loss_cpu=float(cpu_loss),
                step1_loss_rel_err=abs(float(loss) - float(cpu_loss))
                / abs(float(cpu_loss)),
                grads_vs_cpu_f64=vs_f64, grads_vs_cpu_f32=vs_cpu,
                cpu_f32_grads_vs_f64=cpu_vs_f64,
                losses=losses, losses_cpu=cpu_losses,
                steps_rel_err=[abs(a - b) / abs(b)
                               for a, b in zip(losses, cpu_losses)],
                loss_after_50_steps=after,
                held_out_examples=evaluation.examples,
                held_out_accuracy=evaluation.accuracy(),
                ms_per_step=step_ms,
                images_per_s=LENET_BATCH / (step_ms * 1e-3))


def vgg_case(device="cuda"):
    """VGG-16-CIFAR (f32) at [64, 32, 32, 3]: ``output()``, one gradient
    and one ``fit_batch`` against the same net on the CPU; ms per
    ``output()`` and per step."""
    net = MultiLayerNetwork(vgg16_cifar10(), device=device).init()
    cpu = MultiLayerNetwork(vgg16_cifar10(), device="cpu").init()
    rng = np.random.default_rng(SEED + 5)
    x = rng.random((VGG_BATCH, 32, 32, 3), dtype=np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, VGG_BATCH)]
    batch = DataSet(x, y)
    probs = net.output(x)
    err = float((probs.cpu() - cpu.output(x)).abs().max())
    grads, loss, _ = net.compute_gradient_and_score(batch)
    cpu_grads, cpu_loss, _ = cpu.compute_gradient_and_score(batch)
    worst, worst_name = grad_rel_err(grads, cpu_grads)
    del grads, cpu_grads
    step_loss = float(net.fit_batch(batch))
    cpu_step_loss = float(cpu.fit_batch(batch))
    check(tuple(probs.shape) == (VGG_BATCH, 10)
          and bool(torch.isfinite(probs).all()), "VGG: output")
    return dict(config="vgg16_cifar10()", batch=[VGG_BATCH, 32, 32, 3],
                params=net.num_params(), max_abs_err_vs_cpu=err,
                step1_loss=float(loss), step1_loss_cpu=float(cpu_loss),
                step1_loss_rel_err=abs(float(loss) - float(cpu_loss))
                / abs(float(cpu_loss)),
                worst_grad_rel_err=worst, worst_grad=worst_name,
                fit_batch_loss=step_loss, fit_batch_loss_cpu=cpu_step_loss,
                fit_batch_loss_rel_err=abs(step_loss - cpu_step_loss)
                / abs(cpu_step_loss),
                output_ms=host_ms(lambda: net.output(x), iters=10),
                ms_per_step=host_ms(lambda: net.fit_batch(batch), iters=10,
                                    warmup=2))


def resnet_twin_case(device="cuda"):
    """ResNet-50 in f32 (``resnet50(dtype="float32")``) at batch 4 on the
    card and the CPU. f32 cannot pin its gradients down: 53 BN layers in
    training mode at random init leave the card's and the CPU's f32
    gradients each ~2.5% (relative L2) from the f64 one, some tensors 18-23%
    of their largest |g|. So the net is run in f64 on both (params,
    states and batch cast): the card's f64 gradients, loss and BN states
    against the CPU's show that the card computes the same function; the
    card's f32 ones are held to the CPU's f64 ones at f32's reach. Then
    one Nesterov step on both, and ``output()`` with the running states
    it left."""
    conf = resnet50(dtype="float32")
    net = ComputationGraph(conf, device=device).init()
    cpu = ComputationGraph(resnet50(dtype="float32"), device="cpu").init()
    rng = np.random.default_rng(SEED + 6)
    B, S, C = RESNET_TWIN_BATCH, RESNET_HW, RESNET_CLASSES
    x = rng.random((B, S, S, 3), dtype=np.float32)
    y = np.eye(C, dtype=np.float32)[rng.integers(0, C, B)]
    batch = DataSet(x, y)
    loss64, ref, ref_states = f64_reference(cpu, batch, "cpu")
    card64, grads64, states64 = f64_reference(net, batch, device)
    f64_grads = grad_agreement(grads64, ref)
    f64_states, _ = state_rel_err(states64, ref_states)
    del grads64, states64
    grads, loss, states = net.compute_gradient_and_score(batch)
    cpu_grads, cpu_loss, cpu_states = cpu.compute_gradient_and_score(batch)
    vs_f64 = grad_agreement(grads, ref)
    cpu_vs_f64 = grad_agreement(cpu_grads, ref)
    state_err, state_name = state_rel_err(states, ref_states)
    cpu_state_err, _ = state_rel_err(cpu_states, ref_states)
    del grads, cpu_grads, ref
    step_loss = float(net.fit_batch(batch))
    cpu_step_loss = float(cpu.fit_batch(batch))
    probs = net.output(x)
    err = float((probs.cpu() - cpu.output(x)).abs().max())
    check(tuple(probs.shape) == (B, C)
          and bool(torch.isfinite(probs).all()), "ResNet-50 twin: output")
    return dict(config="resnet50(dtype='float32')", batch=[B, S, S, 3],
                params=net.num_params(),
                f64_loss_rel_err=abs(card64 - loss64) / abs(loss64),
                f64_grads_vs_cpu_f64=f64_grads,
                f64_states_rel_err=f64_states,
                step1_loss=float(loss), step1_loss_cpu=float(cpu_loss),
                loss_f64=loss64,
                step1_loss_rel_err=abs(float(loss) - float(cpu_loss))
                / abs(float(cpu_loss)),
                step1_loss_rel_err_vs_f64=abs(float(loss) - loss64) / loss64,
                grads_vs_cpu_f64=vs_f64, cpu_f32_grads_vs_f64=cpu_vs_f64,
                worst_state_rel_err_vs_f64=state_err,
                worst_state=state_name,
                cpu_f32_worst_state_rel_err_vs_f64=cpu_state_err,
                fit_batch_loss=step_loss, fit_batch_loss_cpu=cpu_step_loss,
                max_abs_err_vs_cpu=err)


def resnet_timed_case(dtype, device="cuda"):
    """ResNet-50 at [64, 224, 224, 3] as users get it (bf16, Nesterov at
    lr 0.1) or in f32: ``output()`` and 20 ``fit_batch`` calls on a fixed
    batch, timed; the peak memory and the updater's time. Returns the
    record and the net, batch and data for the profile."""
    net = ComputationGraph(resnet50(dtype=dtype), device=device).init()
    rng = np.random.default_rng(SEED + 7)
    B, S, C = RESNET_BATCH, RESNET_HW, RESNET_CLASSES
    x = rng.random((B, S, S, 3), dtype=np.float32)
    y = np.eye(C, dtype=np.float32)[rng.integers(0, C, B)]
    batch = DataSet(x, y)
    probs = net.output(x)
    check(tuple(probs.shape) == (B, C)
          and bool(torch.isfinite(probs).all()),
          f"ResNet-50 {dtype}: output")
    output_ms = host_ms(lambda: net.output(x), iters=5)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses = [net.fit_batch(batch) for _ in range(RESNET_STEPS)]
    torch.cuda.synchronize()
    steps_s = time.perf_counter() - t0
    losses = [float(v) for v in losses]
    peak = torch.cuda.max_memory_allocated()
    LIVE[f"resnet50_{dtype}_peak_bytes"] = peak
    step_ms = host_ms(lambda: net.fit_batch(batch), iters=5)
    LIVE[f"resnet50_{dtype}_step_ms"] = step_ms
    grads, _, _ = net.compute_gradient_and_score(batch)
    params = tree_map(torch.clone, net.params)
    state = {k: v if isinstance(v, int) else tree_map(torch.clone, v)
             for k, v in net.opt_state.items()}
    layers = [net.conf.nodes[n].layer for n in net._layer_nodes]
    upd_ms = cuda_ms(lambda: compute_updates(
        net._tx, grads, state, params, layers, net.conf.training), iters=10,
        warmup=2)
    del grads, params, state
    rec = dict(config=f"resnet50(dtype='{dtype}')", batch=[B, S, S, 3],
               updater="nesterovs", lr=0.1, params=net.num_params(),
               output_ms=output_ms, output_images_per_s=B / (output_ms * 1e-3),
               losses=losses, steps_20_s=steps_s,
               ms_per_step=step_ms,
               train_images_per_s=B / (step_ms * 1e-3),
               updater_ms=upd_ms, updater_share_of_step=upd_ms / step_ms,
               peak_mem_bytes=peak)
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"ResNet-50 {dtype}: the loss does not fall: {losses}")
    return rec, net, batch


def cnn_slice():
    """The CNN classifiers on the card: LeNet-5, VGG-16-CIFAR and
    ResNet-50 (an f32 twin against the CPU, then bf16 and f32 at batch 64,
    timed, with a profile of one bf16 step). No kernel of K1-K6 lies on
    this path. Returns the launch counts of the path."""
    reset_counts()
    lenet = lenet_case()
    emit(dict(phase="cnn_slice", model="lenet", tol_loss=TOL_CNN_LOSS,
              tol_grad=TOL_CNN_GRAD, tol_steps=TOL_CNN_STEPS, **lenet))
    check(lenet["step1_loss_rel_err"] <= TOL_CNN_LOSS,
          f"LeNet step-1 loss {lenet['step1_loss']} vs CPU "
          f"{lenet['step1_loss_cpu']}")
    check(lenet["grads_vs_cpu_f64"]["worst_rel"] <= TOL_CNN_GRAD,
          f"LeNet gradients vs the CPU's f64: {lenet['grads_vs_cpu_f64']}")
    check(max(lenet["steps_rel_err"][1:]) <= TOL_CNN_STEPS,
          f"LeNet losses {lenet['losses']} vs CPU {lenet['losses_cpu']}")
    check(lenet["loss_after_50_steps"] < lenet["step1_loss"],
          "LeNet: the loss does not fall over 50 steps")
    check(lenet["held_out_accuracy"] > 0.5,
          f"LeNet accuracy {lenet['held_out_accuracy']} on unseen "
          "training-split examples")

    vgg = vgg_case()
    emit(dict(phase="cnn_slice", model="vgg", tol_probs=TOL_CNN_PROBS,
              tol_loss=TOL_CNN_LOSS, tol_grad=TOL_CNN_GRAD, **vgg))
    check(vgg["max_abs_err_vs_cpu"] <= TOL_CNN_PROBS,
          f"VGG output differs from the CPU's by {vgg['max_abs_err_vs_cpu']}")
    check(vgg["step1_loss_rel_err"] <= TOL_CNN_LOSS
          and vgg["fit_batch_loss_rel_err"] <= TOL_CNN_LOSS,
          f"VGG loss {vgg['step1_loss']} vs CPU {vgg['step1_loss_cpu']}")
    check(vgg["worst_grad_rel_err"] <= TOL_CNN_GRAD,
          f"VGG gradient {vgg['worst_grad']} differs from the CPU's by "
          f"{vgg['worst_grad_rel_err']} of its largest |g|")

    twin = resnet_twin_case()
    emit(dict(phase="cnn_slice", model="resnet50_f32_twin",
              tol_f64=TOL_CNN_F64, tol_loss=TOL_CNN_LOSS,
              tol_grad_rel_l2=TOL_RESNET_GRAD_L2,
              tol_grad_cos=TOL_RESNET_GRAD_COS,
              tol_state=TOL_RESNET_STATE, tol_probs=TOL_CNN_PROBS, **twin))
    check(twin["f64_loss_rel_err"] <= TOL_CNN_F64
          and twin["f64_grads_vs_cpu_f64"]["worst_rel"] <= TOL_CNN_F64
          and twin["f64_states_rel_err"] <= TOL_CNN_F64,
          "ResNet-50 in f64: the card's loss, gradients or BN states differ "
          f"from the CPU's: {twin['f64_loss_rel_err']}, "
          f"{twin['f64_grads_vs_cpu_f64']}, {twin['f64_states_rel_err']}")
    check(twin["step1_loss_rel_err"] <= TOL_CNN_LOSS
          and twin["step1_loss_rel_err_vs_f64"] <= TOL_CNN_LOSS,
          f"ResNet-50 step-1 loss {twin['step1_loss']} vs CPU "
          f"{twin['step1_loss_cpu']}, f64 {twin['loss_f64']}")
    check(twin["grads_vs_cpu_f64"]["global_rel_l2"] <= TOL_RESNET_GRAD_L2
          and twin["grads_vs_cpu_f64"]["min_cos"] >= TOL_RESNET_GRAD_COS,
          f"ResNet-50 f32 gradients vs f64: {twin['grads_vs_cpu_f64']}")
    check(twin["worst_state_rel_err_vs_f64"] <= TOL_RESNET_STATE,
          f"ResNet-50 BN state {twin['worst_state']} differs from f64 by "
          f"{twin['worst_state_rel_err_vs_f64']}")
    check(twin["max_abs_err_vs_cpu"] <= TOL_CNN_PROBS,
          f"ResNet-50 output differs from the CPU's by "
          f"{twin['max_abs_err_vs_cpu']}")

    bf16, net, batch = resnet_timed_case("bfloat16")
    emit(dict(phase="cnn_slice", model="resnet50_bf16", **bf16))
    emit(dict(phase="profile", window="one ResNet-50 bf16 fit_batch of "
                                      "[64, 224, 224, 3]",
              **device_profile(lambda: net.fit_batch(batch), {}, top=30,
                               groups=CNN_GROUPS)))
    del net, batch
    f32, net, batch = resnet_timed_case("float32")
    emit(dict(phase="cnn_slice", model="resnet50_f32", **f32))
    del net, batch
    torch.cuda.synchronize()
    launched = counts()
    check(all(v == 0 for v in launched.values()),
          f"the CNN path launched a kernel of K1-K6: {launched}")
    return launched


def serve_traffic():
    """The 16 requests: prompts, stagger (s), sampling configs, and the
    two requests that share a 64-token prefix."""
    V = SLICE["vocab_size"]
    rng = np.random.default_rng(23)
    lengths = rng.choice(SERVE_LENGTHS, SERVE_REQUESTS)
    stagger = rng.uniform(0.0, SERVE_STAGGER_S, SERVE_REQUESTS)
    prompts = [rng.integers(0, V, int(n)).tolist() for n in lengths]
    shared = [i for i, n in enumerate(lengths) if n > SERVE_PREFIX][:2]
    check(len(shared) == 2, f"fewer than two prompts past {SERVE_PREFIX}")
    a, b = shared
    prompts[b][:SERVE_PREFIX] = prompts[a][:SERVE_PREFIX]
    sampling = [{"temperature": SERVE_TEMP, "seed": i} if i % 4 == 0
                else None for i in range(SERVE_REQUESTS)]
    return prompts, stagger, sampling, shared


def singleton_tokens(net, prompt, n_new, sampling):
    if sampling is None:
        return greedy_generate(net, prompt, n_new)
    return sample_generate(net, prompt, n_new, sampling["temperature"],
                           sampling["seed"])


def serve_wave(sched, net, lock, prompts, stagger, sampling, n_new,
               key="gpt"):
    """Submit every request from its own thread after its stagger; wait
    for all. Returns (results by index, wall seconds)."""
    results, res_lock = {}, threading.Lock()

    def one(i):
        time.sleep(stagger[i])
        try:
            r = sched.submit(key, net, lock, prompts[i], n_new,
                             Deadline(600.0), sampling=sampling[i])
        except Exception as e:  # noqa: BLE001 — reported by the caller
            r = e
        with res_lock:
            results[i] = r

    threads = [threading.Thread(target=one, args=(i,), daemon=True)
               for i in range(len(prompts))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(600.0)
    wall = time.perf_counter() - t0
    check(not any(t.is_alive() for t in threads), "a request never ended")
    bad = {i: repr(r) for i, r in results.items() if isinstance(r, Exception)}
    check(not bad, f"requests failed: {bad}")
    return results, wall


def wave_record(results, wall):
    ttft = sorted(r["ttft_ms"] for r in results.values())
    n_tok = sum(len(r["tokens"]) for r in results.values())
    return dict(wall_s=wall, tokens=n_tok, tokens_per_s=n_tok / wall,
                ttft_p50_ms=float(np.percentile(ttft, 50)),
                ttft_p99_ms=float(np.percentile(ttft, 99)),
                ttft_max_ms=ttft[-1],
                reprefills=sum(r["reprefills"] for r in results.values()))


def clone_pool(pool):
    return {n: {k: v.clone() for k, v in kv.items()} for n, kv in pool.items()}


def restore_pool(pool, snapshot):
    for n, kv in pool.items():
        for k, v in kv.items():
            v.copy_(snapshot[n][k])


def pool_max_abs_diff(a, b):
    return max(float((a[n][k] - b[n][k]).abs().max()) for n in a for k in a[n])


def decode_inputs(rows, eng, rng):
    """x, positions, table (numpy, as the engine builds them) for
    ``rows`` rows over the engine's pool: each row maps a distinct chain
    of pages, at a position past its first page."""
    V, ppr = eng.vocab, eng.pages_per_row
    chains = rng.permutation(np.arange(1, eng.total_pages))
    table = chains[:rows * ppr].reshape(rows, ppr).astype(np.int64)
    positions = rng.integers(eng.page_len, eng.max_len, rows).astype(np.int64)
    x = np.eye(V, dtype=np.float32)[rng.integers(0, V, rows)][:, None, :]
    return x, positions, table


def step_profile(fn, calls):
    """``calls`` calls of ``fn`` under torch.profiler: per call the wall
    ms, the kernels' ms, the kernels launched on the card, the host's
    launch calls (kernel and graph launches, LAUNCH_CALLS) and its
    copies; and the card's busy share of the wall time (the trace slows
    the host, so it reads low)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.key_averages()
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and "memcpy" not in e.key.lower()
               and "memset" not in e.key.lower()]
    busy_us = sum(e.self_device_time_total for e in kernels)
    host = {e.key: e.count for e in events
            if e.device_type == torch.autograd.DeviceType.CPU}
    return dict(wall_ms_per_call=wall_us / 1e3 / calls,
                kernel_ms_per_call=busy_us / 1e3 / calls,
                kernels_per_call=sum(e.count for e in kernels) / calls,
                host_launch_calls_per_call=sum(
                    host.get(k, 0) for k in LAUNCH_CALLS) / calls,
                graph_launches_per_call=host.get("cudaGraphLaunch", 0)
                / calls,
                host_copies_per_call=sum(
                    n for k, n in host.items() if k.startswith("cudaMemcpy"))
                / calls,
                busy_share=busy_us / wall_us if kernels else None)


def serve_graph_checks(net, eng, runners):
    """On the engine's own state after the traffic: each decode bucket's
    graph and one prefill bucket's against the eager step from the same
    state (bitwise), the same 8 rows decoded in buckets of 1, 2, 4 and 8
    (bitwise or not, max |dprob|), and graphed against eager decode
    time, launches and busy share at 1, 2, 4 and 8 rows."""
    pool = eng.pool
    snapshot = clone_pool(pool)
    step = net.paged_decode_fn(eng.page_len)
    rng = np.random.default_rng(SEED)
    dev = torch.device("cuda")

    def eager(x, positions, table):
        probs, _ = step(net.params, net.states, pool,
                        torch.from_numpy(x).to(dev),
                        torch.from_numpy(positions).to(dev),
                        torch.from_numpy(table).to(dev))
        return probs.cpu().numpy()

    def graphed(rows, x, positions, table):
        return runners[("decode", rows)](net.params, net.states, pool, x,
                                         positions, table)[0]

    bitwise = {}
    for rows in (1, 2, 4, 8):
        x, positions, table = decode_inputs(rows, eng, rng)
        if rows > 1:
            table[-1] = 0                  # an unmapped row: scratch page 0
        pe = eager(x, positions, table)
        pool_e = clone_pool(pool)
        restore_pool(pool, snapshot)
        pg = graphed(rows, x, positions, table)
        bitwise[f"decode_{rows}"] = dict(
            probs_equal=bool(np.array_equal(pe, pg)),
            pool_equal=all(torch.equal(pool[n][k], pool_e[n][k])
                           for n in pool for k in pool[n]),
            max_abs_prob_diff=float(np.abs(pe - pg).max()),
            max_abs_pool_diff=pool_max_abs_diff(pool, pool_e))
        restore_pool(pool, snapshot)
    prefill, _ = net.decode_fns()
    bucket = max(b for kind, b in runners if kind == "prefill")
    L = bucket - 3
    x = np.zeros((1, bucket, eng.vocab), np.float32)
    x[0, :L] = np.eye(eng.vocab, dtype=np.float32)[
        rng.integers(0, eng.vocab, L)]
    lengths = np.asarray([L], np.int64)
    pe, ce = prefill(net.params, net.states, net.init_decode_cache(1),
                     torch.from_numpy(x).to(dev),
                     torch.from_numpy(lengths).to(dev))
    pg, cg = runners[("prefill", bucket)](net.params, net.states, x, lengths)
    bitwise[f"prefill_{bucket}"] = dict(
        probs_equal=bool(np.array_equal(pe.cpu().numpy(), pg)),
        cache_equal=all(torch.equal(ce[n][k], cg[n][k])
                        for n in ce for k in ce[n]),
        max_abs_prob_diff=float(np.abs(pe.cpu().numpy() - pg).max()),
        max_abs_cache_diff=pool_max_abs_diff(ce, cg))

    # the same 8 rows in buckets of 1, 2, 4 and 8 (graphed)
    x, positions, table = decode_inputs(8, eng, rng)
    by_bucket = {}
    for rows in (1, 2, 4, 8):
        parts = []
        for lo in range(0, 8, rows):
            sl = slice(lo, lo + rows)
            parts.append(graphed(rows, x[sl], positions[sl], table[sl]))
            restore_pool(pool, snapshot)
        by_bucket[rows] = np.concatenate(parts)
    batch_vs_single = {
        f"rows_{rows}_vs_1": dict(
            bitwise=bool(np.array_equal(by_bucket[rows], by_bucket[1])),
            max_abs_prob_diff=float(np.abs(by_bucket[rows]
                                           - by_bucket[1]).max()),
            argmax_equal=bool((by_bucket[rows].argmax(-1)
                               == by_bucket[1].argmax(-1)).all()))
        for rows in (2, 4, 8)}

    timing = {}
    for rows in (1, 2, 4, 8):
        x, positions, table = decode_inputs(rows, eng, rng)

        def run_eager():
            eager(x, positions, table)

        def run_graph():
            graphed(rows, x, positions, table)
        turns = [host_ms(fn, iters=SERVE_TIMED_CALLS, warmup=3)
                 for fn in (run_eager, run_graph, run_graph, run_eager)]
        timing[rows] = dict(eager_ms=[turns[0], turns[3]],
                            graphed_ms=[turns[1], turns[2]],
                            eager_profile=step_profile(run_eager, 16),
                            graphed_profile=step_profile(run_graph, 16))
        restore_pool(pool, snapshot)
    return bitwise, batch_vs_single, timing


def page_replay_case(sched, net, lock):
    """One request whose 140 new tokens fill page 1 with decode content
    alone; an evict_page fault at its 130th step drops that page, the row
    replays it, and its tokens must be the singleton's."""
    rng = np.random.default_rng(SEED + 1)
    prompt = rng.integers(0, SLICE["vocab_size"], REPLAY_PROMPT).tolist()
    ref = greedy_generate(net, prompt, REPLAY_NEW)
    reg = MetricsRegistry()
    prev = set_registry(reg)
    try:
        faultinject.set_schedule(FaultSchedule(
            [Fault("evict_page", at_call=REPLAY_EVICT_AT)]))
        r = sched.submit("gpt", net, lock, prompt, REPLAY_NEW,
                         Deadline(600.0))
    finally:
        faultinject.clear()
        set_registry(prev)
    ev = reg.get("serving_kv_page_evictions_total")
    return dict(prompt_len=REPLAY_PROMPT, new_tokens=REPLAY_NEW,
                evict_at_iteration=REPLAY_EVICT_AT,
                page_evictions=0 if ev is None else ev.value,
                reprefills=r["reprefills"],
                tokens_equal_singleton=r["tokens"] == ref)


def serve_engine():
    """The token-level serving engine on the card (ROADMAP A5): the
    full-width GPT behind ``GenerationScheduler(max_rows=8)``, two waves
    of the same 16 requests, a page replay, then the graph checks and
    timings on the engine's own state, and 2 of the requests through an
    engine on the CPU. No kernel of K1-K6 lies on this path (the
    engine's prefill and decode are plain torch, as the JAX engine's
    are). Returns the launch counts of the path."""
    net = ComputationGraph(gpt_decoder(**SLICE), device="cuda").init()
    prompts, stagger, sampling, shared = serve_traffic()
    refs = [singleton_tokens(net, p, SERVE_NEW, s)
            for p, s in zip(prompts, sampling)]
    lock = threading.Lock()
    reg = MetricsRegistry()
    prev = set_registry(reg)
    # the decode ladder is captured at engine build, so wave one holds
    # every decode bucket whatever its row counts were
    sched = GenerationScheduler(max_rows=SERVE_ROWS,
                                prewarm_decode_ladder=True)
    try:
        reset_counts()
        faultinject.set_schedule(FaultSchedule(
            [Fault("evict_page", at_call=SERVE_EVICT_AT)]))
        wave1, wall1 = serve_wave(sched, net, lock, prompts, stagger,
                                  sampling, SERVE_NEW)
        faultinject.clear()
        st1 = sched.stats()
        eng = sched._engines["gpt"]
        a, b = shared
        bucket = eng.prefill_bucket(len(prompts[a]))
        pid = eng.prefix_pages.get((bucket, tuple(prompts[a][:SERVE_PREFIX])))
        entries = [eng.prompt_registry.get(
            (eng.prefill_bucket(len(prompts[i])), tuple(prompts[i])))
            for i in shared]
        # after the wave no row is live, so the page's holders are the
        # registry entries that map it: the two prompts', and the
        # re-prefilled history's when the evict_page fault's victim was
        # one of them (its history shares the first 64 tokens)
        holders = sum(pid is not None and pid in e["pages"]
                      for e in eng.prompt_registry.values())
        prefix = dict(requests=shared, bucket=bucket, page=pid,
                      buckets_equal=bucket == eng.prefill_bucket(
                          len(prompts[b])),
                      refcount=None if pid is None else eng.page_ref[pid],
                      registry_holders=holders,
                      both_map_it=all(e is not None and e["pages"][0] == pid
                                      for e in entries))
        page_ev = reg.get("serving_kv_page_evictions_total")
        row_ev = reg.get("serving_kv_evictions_total")
        evicted = dict(
            fault_fired=reg.get("resilience_faults_injected_total").value,
            page_evictions=0 if page_ev is None else page_ev.value,
            row_evictions=0 if row_ev is None else row_ev.value,
            victims=[i for i, r in wave1.items() if r["reprefills"]])
        wave2, wall2 = serve_wave(sched, net, lock, prompts, stagger,
                                  sampling, SERVE_NEW)
        torch.cuda.synchronize()
        st2 = sched.stats()
        main_path = counts()
        replay = page_replay_case(sched, net, lock)
        runners = {(k[2], k[3]): sched._compiled.get(k)
                   for k in sched._compiled.keys()
                   if k[0] == sched._cache_owner and k[1] == "gpt"}
        bitwise, batch_vs_single, timing = serve_graph_checks(net, eng,
                                                              runners)
        pool_tensor_bytes = sum(v.numel() * v.element_size()
                                for kv in eng.pool.values()
                                for v in kv.values())
        graph_bytes = {f"{k}:{b}": r.nbytes for (k, b), r in runners.items()}
        LIVE["engine"] = dict(max_rows=SERVE_ROWS, page_len=eng.page_len,
                              total_pages=eng.total_pages,
                              pool_bytes=eng.pool_bytes)
    finally:
        faultinject.clear()
        sched.stop()
        set_registry(prev)

    # 2 of the requests through the same engine on the CPU
    cpu = ComputationGraph(gpt_decoder(**SLICE), device="cpu").init()
    cpu_sched = GenerationScheduler(max_rows=SERVE_ROWS)
    idx = list(range(SERVE_CPU_REQUESTS))
    try:
        cpu_res, _ = serve_wave(cpu_sched, cpu, threading.Lock(),
                                [prompts[i] for i in idx], [0.0] * len(idx),
                                [sampling[i] for i in idx], SERVE_NEW)
    finally:
        cpu_sched.stop()
    cpu_equal = all(cpu_res[j]["tokens"] == wave1[i]["tokens"]
                    for j, i in enumerate(idx))

    mismatch = {w: [i for i in range(SERVE_REQUESTS)
                    if res[i]["tokens"] != refs[i]]
                for w, res in (("wave1", wave1), ("wave2", wave2))}
    rec = dict(
        phase="serve_engine", config=SLICE, params=net.num_params(),
        max_rows=SERVE_ROWS, page_len=eng.page_len,
        pages_per_row=eng.pages_per_row, page_groups=eng.total_pages,
        page_group_bytes=eng.page_group_bytes, pool_bytes=eng.pool_bytes,
        pool_tensor_bytes=pool_tensor_bytes,
        requests=SERVE_REQUESTS, new_tokens=SERVE_NEW,
        prompt_lens=[len(p) for p in prompts],
        sampled=[i for i, s in enumerate(sampling) if s],
        wave1=wave_record(wave1, wall1), wave2=wave_record(wave2, wall2),
        captures_wave1=st1["compiles"],
        captures_wave2=st2["compiles"] - st1["compiles"],
        capture_s=st2["compile_s"],
        captures_per_bucket=st2["bucket_compiles"],
        graph_pool_bytes=graph_bytes, bucket_mix=st2["bucket_mix"],
        prefix_hits=st2["prefix_hits"], prefill_steps=st2["prefill_steps"],
        shared_prefix=prefix, evict_page=evicted, page_replay=replay,
        tokens_mismatch_singleton=mismatch, cpu_requests=idx,
        cpu_tokens_equal_card=cpu_equal, main_path_launches=main_path)
    emit(rec)
    emit(dict(phase="serve_engine_bitwise", graphed_vs_eager=bitwise,
              batched_vs_singleton=batch_vs_single))
    emit(dict(phase="serve_engine_timing", calls_per_block=SERVE_TIMED_CALLS,
              turns="eager, graphed, graphed, eager",
              decode={str(r): t for r, t in timing.items()}))

    check(all(v == 0 for v in main_path.values()),
          f"the serving engine launched a kernel of K1-K6: {main_path}")
    check(not mismatch["wave1"] and not mismatch["wave2"],
          f"engine tokens differ from the singleton's: {mismatch}")
    check(evicted["fault_fired"] == 1 and (evicted["page_evictions"]
                                           + evicted["row_evictions"]) >= 1,
          f"the evict_page fault did not evict: {evicted}")
    check(replay["page_evictions"] >= 1 and replay["reprefills"] == 0
          and replay["tokens_equal_singleton"],
          f"page replay at full width: {replay}")
    check(prefix["buckets_equal"] and prefix["both_map_it"]
          and prefix["refcount"] == prefix["registry_holders"] >= 2
          and st2["prefix_hits"] >= 1,
          f"shared prefix not mapped once with a refcount of its holders: "
          f"{prefix}, prefix_hits {st2['prefix_hits']}")
    check(rec["captures_wave2"] == 0,
          f"the second wave captured {rec['captures_wave2']} steps")
    check(eng.pool_bytes == pool_tensor_bytes ==
          eng.total_pages * eng.page_group_bytes,
          f"pool bytes {eng.pool_bytes} vs its tensors' {pool_tensor_bytes}")
    check(all(v["probs_equal"] and v.get("pool_equal", v.get("cache_equal"))
              for v in bitwise.values()),
          f"graphed steps differ from the eager ones: {bitwise}")
    check(cpu_equal, "the CPU engine's tokens differ from the card's")
    return main_path


def archive_record(path) -> dict:
    """An archive's bytes on disk, and each member's raw and compressed
    bytes."""
    with zipfile.ZipFile(path) as z:
        members = {i.filename: dict(raw=i.file_size,
                                    compressed=i.compress_size)
                   for i in z.infolist()}
    return dict(file_bytes=Path(path).stat().st_size,
                raw_bytes=sum(m["raw"] for m in members.values()),
                members=members)


def updater_leaves_equal(a, b) -> bool:
    la, lb = a._tx.optax_leaves(a.opt_state), b._tx.optax_leaves(b.opt_state)
    return len(la) == len(lb) and all(
        x.shape == y.shape and torch.equal(x.cpu(), y.cpu())
        for x, y in zip(la, lb))


def states_equal(a, b) -> bool:
    sa = a.states.items() if isinstance(a.states, dict) else enumerate(
        a.states)
    sb = dict(b.states.items() if isinstance(b.states, dict)
              else enumerate(b.states))
    return all(sorted(s) == sorted(sb[i]) and all(
        torch.equal(v, sb[i][k]) for k, v in s.items()) for i, s in sa)


def round_trip_case(name, net, batches, x, path, expect,
                    save_updater=True):
    """Train ``net`` one ``fit_batch`` per batch but the last, write,
    verify and restore it onto the card; hold the restored net's params,
    states, updater, output() and next fit_batch (on the last batch)
    against the source bit for bit (params, states, updater and count
    right after the restore), and its launches of ``expect`` (the
    kernels of that path) against the source's. Without
    ``save_updater`` the archive holds no updater state, and the source
    restarts its updater too, so the next steps still compare. Returns
    (record, restored net)."""
    for batch in batches[:-1]:
        net.fit_batch(batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ModelSerializer.write_model(net, path, save_updater=save_updater)
    write_s = time.perf_counter() - t0
    if not save_updater:
        net.opt_state = net._tx.init(net.params)
    t0 = time.perf_counter()
    ModelSerializer.verify(path)
    verify_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = ModelSerializer.restore_model(path)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    flat = net.params_flat()
    h2d = torch.from_numpy(flat)
    t0 = time.perf_counter()
    h2d.to("cuda")
    torch.cuda.synchronize()
    h2d_s = time.perf_counter() - t0
    check(back.device.type == "cuda", f"{name}: restored on {back.device}")
    # held right after the restore, before either net steps again; with
    # no updater in the archive both states are fresh, so there is
    # nothing to compare (None)
    params_equal = bool(np.array_equal(back.params_flat(), flat))
    states_eq = states_equal(back, net)
    updater_eq = updater_leaves_equal(back, net) if save_updater else None
    count = ([int(net.opt_state["count"]), int(back.opt_state["count"])]
             if save_updater else None)
    launches = {}
    outs, losses = {}, {}
    for who, n in (("source", net), ("restored", back)):
        reset_counts()
        outs[who] = n.output(x)
        losses[who] = n.fit_batch(batches[-1])
        torch.cuda.synchronize()
        launches[who] = counts()
    rec = dict(
        phase="checkpoint", model=name, params=net.num_params(),
        updater_saved=save_updater,
        archive=archive_record(path), write_s=write_s, verify_s=verify_s,
        restore_s=restore_s, h2d_coefficients_s=h2d_s,
        h2d_bytes=flat.nbytes, params_equal=params_equal,
        states_equal=states_eq, updater_equal=updater_eq, count=count,
        output_equal=bool(torch.equal(outs["source"], outs["restored"])),
        output_shape=list(outs["source"].shape),
        output_finite=bool(torch.isfinite(outs["source"]).all()),
        next_loss=[float(losses["source"]), float(losses["restored"])],
        next_loss_equal=bool(torch.equal(losses["source"],
                                         losses["restored"])),
        next_params_equal=bool(np.array_equal(back.params_flat(),
                                              net.params_flat())),
        launches=launches)
    emit(rec)
    check(params_equal and states_eq and (
              not save_updater or (updater_eq and count[0] == count[1])),
          f"{name}: the restore differs from the archive's source: "
          f"params {params_equal}, states {rec['states_equal']}, updater "
          f"{rec['updater_equal']}, count {rec['count']}")
    check(rec["output_equal"] and rec["output_finite"],
          f"{name}: restored output() differs from the source's")
    check(rec["next_loss_equal"] and rec["next_params_equal"],
          f"{name}: the next fit_batch after the restore differs: "
          f"{rec['next_loss']}, params {rec['next_params_equal']}")
    check(launches["source"] == launches["restored"]
          and all(launches["restored"][k] > 0 for k in expect),
          f"{name}: launches {launches}, expected each of {expect}")
    return rec, back


def served_reload_case(path):
    """A GPT behind the serving engine: one wave, then ``restore_weights``
    of another archive (``path``, the trained GPT's) into the served net
    under its lock, then a wave of new prompts of the same lengths (the
    prompt registry keeps prefills of the old weights, ROADMAP C9). Each
    request's tokens against its singleton ``greedy_generate`` on the net
    as served (the restored one for wave two); the captures the reload
    causes are counted."""
    net = ComputationGraph(gpt_decoder(**SLICE), device="cuda").init()
    with zipfile.ZipFile(path) as z:
        archived = np.frombuffer(z.read(ModelSerializer.COEFFICIENTS_NAME),
                                 dtype="<f4")
    V = SLICE["vocab_size"]
    rng = np.random.default_rng(SEED + 11)
    waves = [[rng.integers(0, V, n).tolist() for n in RELOAD_LENGTHS]
             for _ in range(2)]
    zero = [0.0] * len(RELOAD_LENGTHS)
    none = [None] * len(RELOAD_LENGTHS)
    lock = threading.Lock()
    sched = GenerationScheduler(max_rows=SERVE_ROWS,
                                prewarm_decode_ladder=True)
    try:
        refs1 = [greedy_generate(net, p, RELOAD_NEW) for p in waves[0]]
        wave1, _ = serve_wave(sched, net, lock, waves[0], zero, none,
                              RELOAD_NEW)
        before = sched.stats()["compiles"]
        old = net.params_flat()
        ptrs = [t.data_ptr() for t in net._flat_order()]
        t0 = time.perf_counter()
        with lock:
            ModelSerializer.restore_weights(path, net)
            torch.cuda.synchronize()
        reload_s = time.perf_counter() - t0
        same_addresses = [t.data_ptr() for t in net._flat_order()] == ptrs
        refs2 = [greedy_generate(net, p, RELOAD_NEW) for p in waves[1]]
        wave2, _ = serve_wave(sched, net, lock, waves[1], zero, none,
                              RELOAD_NEW)
        recaptures = sched.stats()["compiles"] - before
    finally:
        sched.stop()
    new = net.params_flat()
    mismatch = {w: [i for i, r in enumerate(refs) if res[i]["tokens"] != r]
                for w, res, refs in (("wave1", wave1, refs1),
                                     ("wave2", wave2, refs2))}
    rec = dict(phase="checkpoint_served_reload", requests=len(waves[0]),
               new_tokens=RELOAD_NEW, prompt_lens=list(RELOAD_LENGTHS),
               reload_s=reload_s, recaptures=recaptures,
               same_param_addresses=same_addresses,
               weights_changed=not np.array_equal(old, new),
               restored_equals_archive=bool(np.array_equal(new, archived)),
               tokens_mismatch_singleton=mismatch)
    emit(rec)
    check(rec["weights_changed"] and rec["restored_equals_archive"]
          and same_addresses,
          f"served reload: changed {rec['weights_changed']}, equal to the "
          f"archive {rec['restored_equals_archive']}, addresses kept "
          f"{same_addresses}")
    check(not mismatch["wave1"] and not mismatch["wave2"],
          f"served reload: tokens differ from the singleton's: {mismatch}")
    check(recaptures == 0, f"served reload re-captured {recaptures} steps")
    return rec


def integrity_case(path, tmp):
    """A truncated coefficients.bin and a flipped byte in
    updaterState.bin of a full-width archive (rebuilt stored, with the
    original checksums manifest): ``verify`` raises ``CheckpointError``
    naming each member."""
    with zipfile.ZipFile(path) as z:
        members = {n: z.read(n) for n in z.namelist()}
    out = {}
    for k, (member, damage) in enumerate((
            (ModelSerializer.COEFFICIENTS_NAME, lambda b: b[:-4096]),
            (ModelSerializer.UPDATER_NAME,
             lambda b: b[:len(b) // 2] + bytes([b[len(b) // 2] ^ 0x10])
             + b[len(b) // 2 + 1:]))):
        bad = tmp / f"damaged_{k}.zip"   # a name that names no member
        with zipfile.ZipFile(bad, "w", zipfile.ZIP_STORED) as z:
            for n, data in members.items():
                z.writestr(n, damage(data) if n == member else data)
        try:
            ModelSerializer.verify(bad)
            out[member] = "no error"
        except CheckpointError as e:
            out[member] = str(e)
        bad.unlink()
    emit(dict(phase="checkpoint_integrity", errors=out))
    for member, msg in out.items():
        check(repr(member) in msg, f"a damaged {member} was not named: {msg}")
    return out


def checkpoint_phase():
    """ModelSerializer on the card (ROADMAP A4.4): the GPT, the char-RNN
    and ResNet-50 round trips, a served net reloaded between two waves,
    and the integrity checks on a full-width archive. Returns the
    restored nets' launch counts."""
    tmp = Path(tempfile.mkdtemp(prefix="dl4j_checkpoint_"))
    try:
        B, T = TRAIN_BATCH, SLICE["seq_len"]
        text = synthetic_char_text((CKPT_STEPS + 1) * B * (T + 1) + 1,
                                   seed=SEED + 9)
        batches = char_lm_batches(text, T, B, charset=CHARSET)
        check(len(batches) == CKPT_STEPS + 1, f"{len(batches)} GPT batches")
        gpt = ComputationGraph(gpt_decoder(**SLICE), device="cuda").init()
        gpt_rec, _ = round_trip_case(
            "gpt", gpt, batches, batches[0].features, tmp / "gpt.zip",
            ("flash_attn_fwd", "flash_attn_dq", "flash_attn_dkv"))

        (Bl, Tl) = LSTM_TRAIN_BATCH
        text = synthetic_char_text((CKPT_STEPS + 1) * Bl * (Tl + 1) + 1,
                                   seed=SEED + 10)
        lbatches = char_lm_batches(text, Tl, Bl, charset=CHARSET)
        check(len(lbatches) == CKPT_STEPS + 1,
              f"{len(lbatches)} char-RNN batches")
        rnn = MultiLayerNetwork(char_rnn_lstm(**LSTM_SLICE),
                                device="cuda").init()
        rnn_rec, _ = round_trip_case(
            "char_rnn", rnn, lbatches, lbatches[0].features,
            tmp / "char_rnn.zip",
            ("lstm_fwd_infer", "lstm_fwd_train", "lstm_bwd"))

        # one Nesterov step before the write, at lr 0.01: at the
        # config's 0.1 on random images a random-init ResNet can turn
        # non-finite within two steps, and a NaN equals nothing. Its
        # updater state stays out of the archive, to keep the phase's
        # time (deflate runs on the host at ~14 MB/s)
        rng = np.random.default_rng(SEED + 12)
        S, C = RESNET_HW, RESNET_CLASSES
        rbatches = [DataSet(rng.random((RESNET_TWIN_BATCH, S, S, 3),
                                       dtype=np.float32),
                            np.eye(C, dtype=np.float32)[rng.integers(
                                0, C, RESNET_TWIN_BATCH)])
                    for _ in range(2)]
        resnet = ComputationGraph(resnet50(dtype="float32",
                                           learning_rate=0.01),
                                  device="cuda").init()
        n_bn = sum(1 for s in resnet.states.values() if "mean" in s)
        # cuDNN's default algorithms may sum in a run-dependent order;
        # its deterministic ones make the two nets' steps comparable bit
        # for bit
        prev = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            res_rec, _ = round_trip_case(
                "resnet50_f32", resnet, rbatches, rbatches[0].features,
                tmp / "resnet50.zip", (), save_updater=False)
        finally:
            torch.backends.cudnn.deterministic = prev
        check(n_bn == 53, f"ResNet-50 has {n_bn} batch-norm states, not 53")

        reload_rec = served_reload_case(tmp / "gpt.zip")
        integrity = integrity_case(tmp / "char_rnn.zip", tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return dict(gpt=gpt_rec["launches"]["restored"],
                char_rnn=rnn_rec["launches"]["restored"],
                resnet=res_rec["launches"]["restored"],
                recaptures=reload_rec["recaptures"], integrity=integrity)


def server_models(names=("char_rnn", "gpt", "resnet50")):
    """The predict server's models, full width with seeded random
    weights on the card, each built when the caller reaches it: (name,
    net, feature row shape, one-hot?, the symbol of the TPU kernel its
    predict graphs replay, its launches a replay). ResNet-50 runs no TPU
    kernel."""
    V = SLICE["vocab_size"]
    build = {
        "char_rnn": lambda: (
            MultiLayerNetwork(char_rnn_lstm(**LSTM_SLICE),
                              device="cuda").init(),
            (LSTM_BATCH[1], V), True, "lstm_fwd_infer_kernel",
            LSTM_SLICE["layers"]),
        "gpt": lambda: (
            ComputationGraph(gpt_decoder(**SLICE), device="cuda").init(),
            (SLICE["seq_len"], V), True, "flash_fwd_kernel",
            SLICE["n_layers"]),
        "resnet50": lambda: (
            ComputationGraph(resnet50(dtype="float32"),
                             device="cuda").init(),
            (RESNET_HW, RESNET_HW, 3), False, None, 0)}
    for name in names:
        yield (name,) + build[name]()


def server_features(rng, row, onehot, rows):
    """``rows`` seeded feature rows: one-hot windows, or images."""
    if onehot:
        return np.eye(row[-1], dtype=np.float32)[
            rng.integers(0, row[-1], (rows,) + row[:-1])]
    return rng.random((rows,) + row, dtype=np.float32)


def server_counts(reg) -> dict:
    """The registry's flush reasons and fallbacks so far."""
    fam = reg.get("serving_batch_flushes_total")
    fb = reg.get("serving_batch_fallbacks_total")
    return dict(flush={r: 0.0 if fam is None else fam.labels(reason=r).value
                       for r in ("full", "deadline", "idle")},
                fallbacks=0.0 if fb is None else fb.value)


def server_requests(host, port, reqs, clients):
    """Predicts ``reqs`` (model path, features file, bulk?) from
    ``clients`` threads, each on its own connection, one request at a
    time: returns ({request: (answer, round trip s)}, {request: error},
    wall s). Every client connects before the clock starts (a server's
    listen backlog is socketserver's 5: a burst of connects waits out a
    SYN retry)."""
    todo = collections.deque(range(len(reqs)))
    lock = threading.Lock()
    out, errors = {}, {}
    n = min(clients, len(reqs))
    ready, go = threading.Barrier(n + 1), threading.Event()

    def worker():
        cli = KerasClient(host, port)
        try:
            ready.wait(120.0)
            go.wait(120.0)
            while True:
                with lock:
                    if not todo:
                        return
                    i = todo.popleft()
                model, f, bulk = reqs[i]
                t0 = time.perf_counter()
                try:
                    resp = cli.request(
                        op="predict", features=f, model=model,
                        priority="bulk" if bulk else "interactive")
                    y = np.asarray(resp["predictions"], np.float32)
                    with lock:
                        out[i] = (y, time.perf_counter() - t0)
                except Exception as e:  # noqa: BLE001 — gated below
                    with lock:
                        errors[i] = repr(e)
        finally:
            cli.close()

    threads = [threading.Thread(target=worker, daemon=True)
               for _ in range(n)]
    for t in threads:
        t.start()
    ready.wait(120.0)
    t0 = time.perf_counter()
    go.set()
    for t in threads:
        t.join(600.0)
    check(not any(t.is_alive() for t in threads), "a client never ended")
    return out, errors, time.perf_counter() - t0


def server_wave(srv, reg, name, model, files, rows, picks, bulk,
                clients=SERVER_CLIENTS):
    """One wave against the running server, with a fresh latency window
    and tracer: its answers, and its record (requests/s, rows/s, round
    trip and server p50/p99, batch-size mix, flush reasons, captures and
    their seconds, the serve:batch span against the round trip)."""
    sched = srv._batcher
    sched.latency = _LatencyWindow()
    tracer = Tracer()
    prev_tracer = set_tracer(tracer)
    st0, c0 = sched.stats(), server_counts(reg)
    try:
        out, errors, wall = server_requests(
            srv.host, srv.port,
            [(model, files[p], b) for p, b in zip(picks, bulk)], clients)
    finally:
        set_tracer(prev_tracer)
    st1, c1 = sched.stats(), server_counts(reg)
    rt = sorted(v[1] * 1e3 for v in out.values())
    spans = sorted(e["dur"] / 1e3 for e in tracer.export()["traceEvents"]
                   if e["name"] == "serve:batch")
    p50, p99 = sched.latency.quantiles()
    n_rows = sum(rows[picks[i]] for i in out)
    mix = {k: v - st0["batch_size_mix"].get(k, 0)
           for k, v in st1["batch_size_mix"].items()
           if v - st0["batch_size_mix"].get(k, 0)}
    rec = dict(model=name, requests=len(picks), served=len(out),
               errors=errors, bulk=int(sum(bulk)), rows=n_rows, wall_s=wall,
               requests_per_s=len(out) / wall, rows_per_s=n_rows / wall,
               round_trip_p50_ms=float(np.percentile(rt, 50)) if rt else None,
               round_trip_p99_ms=float(np.percentile(rt, 99)) if rt else None,
               server_p50_ms=None if p50 is None else p50 * 1e3,
               server_p99_ms=None if p99 is None else p99 * 1e3,
               batch_size_mix=mix,
               flush={r: c1["flush"][r] - c0["flush"][r]
                      for r in c1["flush"]},
               fallbacks=c1["fallbacks"] - c0["fallbacks"],
               captures=st1["compiles"] - st0["compiles"],
               capture_s=st1["compile_s"] - st0["compile_s"],
               serve_batch_spans=len(spans),
               serve_batch_p50_ms=(float(np.percentile(spans, 50))
                                   if spans else None),
               serve_batch_p99_ms=(float(np.percentile(spans, 99))
                                   if spans else None))
    return out, rec


def c2_record(answers, picks, refs) -> dict:
    """Each answer against its singleton: argmax equal everywhere, max
    |dprob|, and how many were bitwise equal."""
    diffs, argmax_ok, bitwise, top = [], True, 0, 0.0
    for i, (y, _) in answers.items():
        ref = refs[picks[i]]
        diffs.append(float(np.abs(y - ref).max()))
        argmax_ok &= bool((y.argmax(-1) == ref.argmax(-1)).all())
        bitwise += int(np.array_equal(y, ref))
        top = max(top, float(ref.max()))
    return dict(answers=len(diffs), argmax_equal=argmax_ok,
                max_abs_prob_diff=max(diffs) if diffs else None,
                bitwise=bitwise, max_prob=top)


def server_bucket_checks(srv, path, net, row, files, rows, ladder, symbol,
                         per_replay):
    """For each captured bucket of one model, on the card: the graph's
    replay against an eager ``output()`` of the same padded batch (bit
    for bit), its rows against each member's singleton (C2, or bitwise),
    the graph pool's bytes, and one traced replay's kernels (the TPU
    kernel by symbol)."""
    sched = srv._batcher
    runners = {k[2]: sched._compiled.get(k) for k in sched._compiled.keys()
               if k[0] == sched._cache_owner and k[1] == path
               and k[3][0] == row}
    lock = srv._model_locks[path]
    out = {}
    for bucket, runner in sorted(runners.items()):
        fs, members, used = list(files), [], 0
        for j, r in enumerate(rows):
            if used + r <= bucket:
                members.append(j)
                used += r
        if not members:          # no pool file this small: its ladder file
            fs.append(ladder[SERVER_LADDER.index(bucket)])
            members, used = [len(fs) - 1], bucket
        batch = [_load_array(Path(fs[j])) for j in members]
        x = np.concatenate(batch + [np.zeros((bucket - used,) + row,
                                             np.float32)])
        with lock:
            got = runner(net, x)
            eager = net.output(x).float().cpu().numpy()
            singles = [net.output(b).float().cpu().numpy() for b in batch]
            expect = {symbol: per_replay} if symbol else {}
            prof = device_profile(lambda: runner._graph.replay(), expect)
        ref = np.concatenate(singles)
        out[str(bucket)] = dict(
            graphed=runner.graphed, pool_bytes=runner.nbytes,
            members=[len(b) for b in batch],
            graph_equals_eager=bool(np.array_equal(got, eager)),
            rows_bitwise_singleton=bool(np.array_equal(got[:used], ref)),
            max_abs_prob_diff_singleton=float(np.abs(got[:used]
                                                     - ref).max()),
            argmax_equal_singleton=bool((got[:used].argmax(-1)
                                         == ref.argmax(-1)).all()),
            replay_kernels=prof["kernel_launches"],
            replay_traced=prof["traced_path_kernels"],
            replay_kernel_ms=prof["kernel_ms"])
    return out


def server_wire_costs(files, rows) -> dict:
    """Host costs inside a round trip, apart from the card, for the
    largest file of the pool: np.load of its features, the JSON encode
    of an answer as large as the GPT's for its rows (tolist + dumps), and
    the client's decode."""
    j = int(np.argmax(rows))
    t0 = time.perf_counter()
    np.load(files[j])
    load_ms = (time.perf_counter() - t0) * 1e3
    y = np.random.default_rng(SEED).random(
        (rows[j], SLICE["seq_len"], SLICE["vocab_size"]), dtype=np.float32)
    t0 = time.perf_counter()
    text = json.dumps({"ok": True, "predictions": y.tolist()})
    enc_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    np.asarray(json.loads(text)["predictions"], np.float32)
    dec_ms = (time.perf_counter() - t0) * 1e3
    return dict(rows=rows[j], floats=int(y.size), json_bytes=len(text),
                np_load_ms=load_ms, json_encode_ms=enc_ms,
                json_decode_ms=dec_ms)


def server_chaos(srv, path, net, row, tmp):
    """On the char-RNN: a poison_row request in a full batch of 8 fails
    alone while its 7 batchmates are served (each against its singleton,
    C2); then health, readyz and debug answer while a slow_batch fault
    holds a batch."""
    rng = np.random.default_rng(SEED + 31)
    files = []
    for k in range(8):
        files.append(str(tmp / f"poison_{k}.npy"))
        np.save(files[-1], server_features(rng, row, True, 4))
    sched = srv._batcher
    wait = sched.max_wait_s
    sched.max_wait_s = 5.0       # the 8 requests meet in one full batch
    reg_counts = server_counts(get_registry())
    mix0 = dict(sched.stats()["batch_size_mix"])
    outcomes, answers, lock = {}, {}, threading.Lock()
    start = threading.Barrier(8)

    def one(k):
        cli = KerasClient(srv.host, srv.port)
        try:
            start.wait(30.0)
            y = cli.predict(files[k], model=path)
            with lock:
                outcomes[k], answers[k] = "ok", y
        except RuntimeError as e:
            with lock:
                outcomes[k] = str(e).split(":")[0]
        finally:
            cli.close()

    faultinject.set_schedule(FaultSchedule([Fault("poison_row", at_call=3)]))
    try:
        threads = [threading.Thread(target=one, args=(k,), daemon=True)
                   for k in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120.0)
    finally:
        faultinject.clear()
        sched.max_wait_s = wait
    after = server_counts(get_registry())
    mix1 = sched.stats()["batch_size_mix"]
    diffs = [float(np.abs(answers[k] - net.output(
        np.load(files[k])).float().cpu().numpy()).max()) for k in answers]
    poison = dict(outcomes=[outcomes.get(k) for k in range(8)],
                  full_flushes=after["flush"]["full"]
                  - reg_counts["flush"]["full"],
                  batches_of_8=mix1.get("8", 0) - mix0.get("8", 0),
                  batchmates_max_abs_prob_diff=max(diffs) if diffs else None)

    # a batch held 2 s by slow_batch; the probes answer meanwhile
    faultinject.set_schedule(FaultSchedule(
        [Fault("slow_batch", at_call=1, duration=2.0)]))
    held = {}

    def hold():
        c = KerasClient(srv.host, srv.port)
        try:
            held["y"] = c.predict(files[0], model=path)
        finally:
            c.close()

    holder = threading.Thread(target=hold, daemon=True)
    try:
        holder.start()
        t_end = time.monotonic() + 10.0
        while ("serve:batch" not in get_tracer().open_span_stack()
               and time.monotonic() < t_end):
            time.sleep(0.01)
        probes = {}
        cli = KerasClient(srv.host, srv.port)
        for op in ("health", "readyz", "debug"):
            t0 = time.perf_counter()
            resp = cli.request(op=op)
            probes[op] = dict(ms=(time.perf_counter() - t0) * 1e3,
                              ok=bool(resp.get("ok")))
            if op == "debug":
                spans = [sp["name"] for st in resp["bundle"]["open_spans"]
                         .values() for sp in st]
                probes[op]["open_serve_batch"] = "serve:batch" in spans
        cli.close()
        holder_alive = holder.is_alive()
        holder.join(60.0)
    finally:
        faultinject.clear()
    probes.update(held_during_probes=holder_alive,
                  held_request_served="y" in held)
    return poison, probes


def server_fit_case(srv, path, net, row, files, rows, tmp):
    """On the char-RNN: a ``fit`` op over two [32, 200] batch-file pairs
    (K2 and K3 run), then a predict wave that must capture nothing and
    answer the fitted weights (each answer against the fitted net's
    singleton, C2), and an ``evaluate`` op against ``net.evaluate``."""
    Bt, Tt = LSTM_TRAIN_BATCH
    text = synthetic_char_text(SERVER_FIT_BATCHES * Bt * (Tt + 1) + 1,
                               seed=SEED + 32)
    batches = char_lm_batches(text, Tt, Bt, charset=CHARSET)
    check(len(batches) == SERVER_FIT_BATCHES, f"{len(batches)} fit batches")
    fdir, ldir = tmp / "fit_features", tmp / "fit_labels"
    fdir.mkdir()
    ldir.mkdir()
    for k, b in enumerate(batches):
        np.save(fdir / f"{k:03d}.npy", b.features)
        np.save(ldir / f"{k:03d}.npy", b.labels)
    before = {j: net.output(np.load(f)).float().cpu().numpy()
              for j, f in enumerate(files)}
    cli = KerasClient(srv.host, srv.port)
    try:
        reset_counts()
        t0 = time.perf_counter()
        resp = cli.fit(path, str(fdir), str(ldir), nb_epoch=1)
        fit_s = time.perf_counter() - t0
        fit_launches = counts()
        ev = cli.request(op="evaluate", model=path, features_dir=str(fdir),
                         labels_dir=str(ldir))
    finally:
        cli.close()
    want = net.evaluate(ListDataSetIterator(batches))
    rng = np.random.default_rng(SEED + 33)
    picks = rng.integers(0, len(files), SERVER_AFTER_FIT).tolist()
    bulk = [i % 4 == 3 for i in range(SERVER_AFTER_FIT)]
    answers, rec = server_wave(srv, get_registry(), "char_rnn_after_fit",
                               path, files, rows, picks, bulk)
    refs = {j: net.output(np.load(f)).float().cpu().numpy()
            for j, f in enumerate(files)}
    moved = max(float(np.abs(refs[j] - before[j]).max()) for j in refs)
    return dict(fit_s=fit_s, score=resp["score"],
                fit_launches=fit_launches,
                evaluate=dict(accuracy=ev["accuracy"], f1=ev["f1"],
                              net_accuracy=want.accuracy(),
                              net_f1=want.f1()),
                weights_moved_max_abs_prob=moved, wave=rec,
                c2=c2_record(answers, picks, refs))


def server_keras_fit(srv, path, tmp):
    """A ``fit`` op on the Keras path: SERVER_FIT_BATCHES [32, 64]
    feature / label pairs written as ``.h5`` by the port's writer. The
    imported twin trains by standard backprop: one step a batch, K2 and
    K3 once a layer."""
    B, T = LSTM_BATCH
    batches = text_batches(SERVER_FIT_BATCHES, B, T, SEED + 44)
    fdir, ldir = tmp / "keras_fit_features", tmp / "keras_fit_labels"
    fdir.mkdir()
    ldir.mkdir()
    for k, b in enumerate(batches):
        write_batch_h5(fdir / f"{k:03d}.h5", b.features)
        write_batch_h5(ldir / f"{k:03d}.h5", b.labels)
    cli = KerasClient(srv.host, srv.port)
    try:
        reset_counts()
        t0 = time.perf_counter()
        resp = cli.fit(path, str(fdir), str(ldir), nb_epoch=1)
        fit_s = time.perf_counter() - t0
        launched = counts()
    finally:
        cli.close()
    return dict(fit_s=fit_s, score=resp["score"], fit_launches=launched)


def serve_server():
    """The predict server on the card (ROADMAP A5.2): one KerasServer
    serving the full-width char-RNN, GPT and f32 ResNet-50 from .zip
    archives, and the char-RNN's Keras twin from its .h5 path (ROADMAP
    A7.1, fed .h5 batch files), to 16 client threads over TCP, each
    predict bucket one CUDA graph (the char-RNNs' replay K1, the GPT's
    K4). Gates: every answer against its singleton (C2), each bucket's
    graph bitwise its eager output(), K1/K4 per traced replay, no capture
    in wave two or after a fit, no fallback, the server's generate
    against the singleton decode, fit and evaluate against the net, a
    fit on the Keras path launching 2 K2 and 2 K3 a batch, a poisoned row
    failing alone, probes answering under a held batch, threads back to
    their baseline. Returns the path's launch counts."""
    t_phase = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="dl4j_serve_server_"))
    models, paths = {}, {}
    try:
        for name, net, row, onehot, symbol, per_replay in server_models():
            paths[name] = str(tmp / f"{name}.zip")
            ModelSerializer.write_model(net, paths[name], save_updater=False)
            models[name] = (row, onehot, symbol, per_replay)
            del net
        torch.cuda.empty_cache()
        # the fourth model: the char-RNN's Keras twin, an .h5 the server
        # imports, fed .h5 batch files
        paths["keras_lstm"] = str(tmp / "keras_lstm.h5")
        write_keras_char_rnn(paths["keras_lstm"], **KERAS_TWIN,
                             seed=SEED + 43)
        models["keras_lstm"] = ((LSTM_BATCH[1], KERAS_TWIN["vocab"]), True,
                                "lstm_fwd_infer_kernel", KERAS_TWIN["layers"])
        rng = np.random.default_rng(SEED + 30)
        pools = {}
        for name, (row, onehot, _, _) in models.items():
            save = (write_batch_h5, ".h5") if name == "keras_lstm" else (
                np.save, ".npy")
            rows = [int(r) for r in rng.choice(SERVER_ROWS, SERVER_FILES)]
            files = []
            for j, r in enumerate(rows):
                files.append(str(tmp / f"{name}_{j}{save[1]}"))
                save[0](files[-1], server_features(rng, row, onehot, r))
            ladder = []
            for b in SERVER_LADDER:
                ladder.append(str(tmp / f"{name}_ladder_{b}{save[1]}"))
                save[0](ladder[-1], server_features(rng, row, onehot, b))
            pools[name] = (files, rows, ladder)

        reg = MetricsRegistry()
        prev_reg = set_registry(reg)
        base_threads = set(threading.enumerate())
        srv = KerasServer(max_batch=SERVER_MAX_BATCH,
                          max_wait_ms=SERVER_WAIT_MS, keep_models=4,
                          max_concurrency=SERVER_CLIENTS,
                          queue_depth=2 * SERVER_CLIENTS)
        waves, c2, buckets, ladder_recs, captured = {}, {}, {}, {}, {}
        # the launches of the server's own work: the captures (warm-ups
        # and the captured call) count, replays never do; the singleton
        # references and the bucket checks below are comparisons and are
        # left out
        main_path, path_by_model = collections.Counter(), {}
        try:
            for name, (row, onehot, symbol, per_replay) in models.items():
                files, rows, ladder = pools[name]
                reset_counts()
                # wave one: the ladder, one bucket a request, alone
                lad, lad_rec = server_wave(
                    srv, reg, f"{name}_ladder", paths[name], ladder,
                    list(SERVER_LADDER), list(range(len(ladder))),
                    [False] * len(ladder), clients=1)
                check(not lad_rec["errors"], f"{name} ladder: {lad_rec}")
                ladder_recs[name] = lad_rec
                t_end = time.monotonic() + 300.0
                recs, answers, picks_all = [], [], []
                for n in SERVER_WAVES[name]:
                    if recs:     # wave two starts after the prewarms
                        while (srv._prewarm_inflight
                               and time.monotonic() < t_end):
                            time.sleep(0.05)
                    picks = rng.integers(0, len(files), n).tolist()
                    bulk = [i % 4 == 3 for i in range(n)]
                    ans, rec = server_wave(srv, reg, name, paths[name],
                                           files, rows, picks, bulk)
                    recs.append(rec)
                    answers.append(ans)
                    picks_all.append(picks)
                launched = counts()
                main_path.update(launched)
                path_by_model[name] = launched
                net = srv._models[paths[name]]
                refs = {j: net.output(_load_array(Path(f))).float().cpu()
                        .numpy() for j, f in enumerate(files)}
                refs.update({("ladder", b): net.output(_load_array(Path(f)))
                             .float().cpu().numpy()
                             for b, f in zip(SERVER_LADDER, ladder)})
                lad_c2 = c2_record(
                    {i: v for i, v in lad.items()},
                    [("ladder", b) for b in SERVER_LADDER], refs)
                c2[name] = dict(ladder=lad_c2, **{
                    f"wave{k + 1}": c2_record(a, p, refs)
                    for k, (a, p) in enumerate(zip(answers, picks_all))})
                waves[name] = recs
                buckets[name] = server_bucket_checks(
                    srv, paths[name], net, row, files, rows, ladder, symbol,
                    per_replay)
                batches = sum(sum(r["batch_size_mix"].values())
                              for r in [lad_rec] + recs)
                captured[name] = sum(r["captures"] for r in [lad_rec] + recs)
                emit(dict(phase="serve_server_model", model=name,
                          params=net.num_params(), ladder=lad_rec,
                          waves=recs, c2=c2[name], buckets=buckets[name],
                          launches=launched, captures=captured[name],
                          graph_batches=batches,
                          kernel_replays={symbol: batches * per_replay}
                          if symbol else {}))
            rnn = srv._models[paths["char_rnn"]]
            gpt = srv._models[paths["gpt"]]
            wire = server_wire_costs(*pools["gpt"][:2])
            # generate: 4 prompts at once, the last sampled
            grng = np.random.default_rng(SEED + 34)
            V = SLICE["vocab_size"]
            prompts = [grng.integers(0, V, n).tolist()
                       for n in SERVER_GEN_LENGTHS]
            sampling = [None] * (len(prompts) - 1) + [
                {"temperature": SERVER_GEN_TEMP, "seed": 5}]
            gen_out, gen_lock = {}, threading.Lock()

            def gen_one(k):
                cli = KerasClient(srv.host, srv.port)
                try:
                    r = cli.generate(prompts[k], SERVER_GEN_NEW,
                                     model=paths["gpt"],
                                     **({"sampling": sampling[k]}
                                        if sampling[k] else {}))
                    with gen_lock:
                        gen_out[k] = r["tokens"]
                finally:
                    cli.close()

            gthreads = [threading.Thread(target=gen_one, args=(k,),
                                         daemon=True)
                        for k in range(len(prompts))]
            reset_counts()
            t0 = time.perf_counter()
            for t in gthreads:
                t.start()
            for t in gthreads:
                t.join(300.0)
            gen_s = time.perf_counter() - t0
            main_path.update(counts())
            gen_refs = [greedy_generate(gpt, p, SERVER_GEN_NEW) if s is None
                        else sample_generate(gpt, p, SERVER_GEN_NEW,
                                             s["temperature"], s["seed"])
                        for p, s in zip(prompts, sampling)]
            generate = dict(prompt_lens=list(SERVER_GEN_LENGTHS),
                            new_tokens=SERVER_GEN_NEW, wall_s=gen_s,
                            sampled=[k for k, s in enumerate(sampling) if s],
                            tokens_equal_singleton=[
                                gen_out.get(k) == r
                                for k, r in enumerate(gen_refs)])
            main_path = {k: main_path[k] for k in KERNELS}
            files, rows, _ = pools["char_rnn"]
            fit = server_fit_case(srv, paths["char_rnn"], rnn,
                                  models["char_rnn"][0], files, rows, tmp)
            poison, probes = server_chaos(srv, paths["char_rnn"], rnn,
                                          models["char_rnn"][0], tmp)
            keras_fit = server_keras_fit(srv, paths["keras_lstm"], tmp)
            stats = srv._batcher.stats()
            cache = dict(srv._batcher._compiled.stats(),
                         max_entries=srv._batcher._compiled.max_entries,
                         max_bytes=srv._batcher._compiled.max_bytes)
            total = server_counts(reg)
            ev = reg.get("serving_compile_cache_evictions_total")
            evictions = 0.0 if ev is None else ev.value
        finally:
            drained = srv.drain(10.0)
            srv.stop()
            set_registry(prev_reg)
        t_end = time.monotonic() + 15.0
        while (set(threading.enumerate()) - base_threads
               and time.monotonic() < t_end):
            time.sleep(0.05)
        leaked = sorted(t.name for t in
                        set(threading.enumerate()) - base_threads)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    rec = dict(phase="serve_server", max_batch=SERVER_MAX_BATCH,
               max_wait_ms=SERVER_WAIT_MS, clients=SERVER_CLIENTS,
               rows=list(SERVER_ROWS), ladder=list(SERVER_LADDER),
               main_path_launches=main_path, fit=fit, keras_fit=keras_fit,
               generate=generate,
               poison_row=poison, probes_under_slow_batch=probes,
               wire_costs_gpt=wire, stats=stats, compile_cache=cache,
               fallbacks_total=total["fallbacks"],
               cache_evictions=evictions, drained=drained,
               leaked_threads=leaked,
               phase_s=time.perf_counter() - t_phase)
    emit(rec)

    for name in models:
        recs = waves[name]
        tol = TOL_C2_RESNET if name == "resnet50" else TOL_C2
        check(not any(r["errors"] for r in recs),
              f"{name}: requests failed: {[r['errors'] for r in recs]}")
        for wave, r in c2[name].items():
            check(r["argmax_equal"] and r["max_abs_prob_diff"] <= tol,
                  f"{name} {wave}: answers against their singletons "
                  f"past the C2 gate ({tol}): {r}")
        check(len(recs) < 2 or recs[-1]["captures"] == 0,
              f"{name}: wave two captured {recs[-1]['captures']} buckets")
        check(set(buckets[name]) == {str(b) for b in SERVER_LADDER},
              f"{name}: captured buckets {sorted(buckets[name])}")
        symbol, per_replay = models[name][2:]
        if symbol:
            # each capture launched its kernel in the 2 warm-ups and the
            # captured call; the graph's replays launched it on the card
            # without a count
            kernel = SERVER_KERNEL_COUNTERS[symbol]
            want = (PredictRunner.WARMUP + 1) * per_replay * captured[name]
            check(path_by_model[name][kernel] == want,
                  f"{name}: {path_by_model[name][kernel]} {kernel} launches "
                  f"counted, want {want} for {captured[name]} captures")
        for b, r in buckets[name].items():
            check(r["graphed"] and r["graph_equals_eager"],
                  f"{name} bucket {b}: graph differs from eager: {r}")
            check(r["argmax_equal_singleton"]
                  and r["max_abs_prob_diff_singleton"] <= tol,
                  f"{name} bucket {b}: rows against singletons: {r}")
            if symbol:
                check(r["replay_traced"] == {symbol: per_replay},
                      f"{name} bucket {b}: a traced replay holds "
                      f"{r['replay_traced']}, not {per_replay} {symbol}")
    check(all(generate["tokens_equal_singleton"]),
          f"server generate differs from the singleton decode: {generate}")
    check(fit["fit_launches"]["lstm_fwd_train"] > 0
          and fit["fit_launches"]["lstm_bwd"] > 0,
          f"the fit op launched {fit['fit_launches']}")
    n_keras = KERAS_TWIN["layers"] * SERVER_FIT_BATCHES
    check(keras_fit["fit_launches"]["lstm_fwd_train"] == n_keras
          and keras_fit["fit_launches"]["lstm_bwd"] == n_keras
          and np.isfinite(keras_fit["score"]),
          f"the fit op on the Keras path: {keras_fit}")
    check(fit["wave"]["captures"] == 0 and not fit["wave"]["errors"],
          f"the predict wave after fit: {fit['wave']}")
    check(fit["c2"]["argmax_equal"]
          and fit["c2"]["max_abs_prob_diff"] <= TOL_C2
          and fit["weights_moved_max_abs_prob"] > TOL_C2,
          f"answers after fit against the fitted net: {fit['c2']}, moved "
          f"{fit['weights_moved_max_abs_prob']}")
    check(fit["evaluate"]["accuracy"] == fit["evaluate"]["net_accuracy"],
          f"evaluate op against net.evaluate: {fit['evaluate']}")
    check(sorted(poison["outcomes"]) == ["NONFINITE"] + ["ok"] * 7
          and poison["full_flushes"] == 1 and poison["batches_of_8"] == 1
          and poison["batchmates_max_abs_prob_diff"] <= TOL_C2,
          f"poison_row in a full batch: {poison}")
    check(all(probes[op]["ok"] for op in ("health", "readyz", "debug"))
          and probes["held_during_probes"]
          and probes["debug"]["open_serve_batch"]
          and probes["held_request_served"],
          f"probes under a held batch: {probes}")
    check(total["fallbacks"] == 0,
          f"{total['fallbacks']} batches fell back to singletons")
    check(evictions == 0,
          f"the compile cache evicted {evictions} graphs: {cache}")
    check(drained and not leaked, f"drain {drained}, leaked {leaked}")
    check(main_path["lstm_fwd_infer"] > 0 and main_path["flash_attn_fwd"] > 0,
          f"the predict path launched {main_path}")
    return dict(main_path=main_path, fit=fit["fit_launches"],
                fit_keras=keras_fit["fit_launches"])


# --------------------------------------------------------------------------
# 12. the Keras import, transfer learning and early stopping (ROADMAP A7)
# --------------------------------------------------------------------------

#: the char-RNN's Keras twin: Sequential Input((None, 96)) -> LSTM(256,
#: return_sequences=True) x 2 -> Dense(96, softmax), in the Keras-2 .h5
#: layout of tests/fixtures/keras_lstm.h5, written by the port's writer;
#: imported, its LSTMs run K1 (output) and K2/K3 (fine-tuning)
KERAS_TWIN = dict(vocab=96, hidden=256, layers=2)
KERAS_PARAMS = 911_456
#: keras_transfer: output() on LSTM_BATCH; TransferLearning freezing
#: layer 0, then an EarlyStoppingTrainer of KERAS_EPOCHS epochs over
#: KERAS_TRAIN_BATCHES [32, 64] batches (Adam at KERAS_LR), scored by a
#: DataSetLossCalculator on KERAS_HELD_OUT batches
KERAS_EPOCHS, KERAS_TRAIN_BATCHES, KERAS_HELD_OUT, KERAS_LR = 3, 2, 2, 1e-3
#: the imported twin's probabilities on the card against the CPU
TOL_KERAS = 1e-4
#: the committed golden fixtures (tests/test_keras_golden.py): file, the
#: inputs' keys in keras_goldens.npz, the outputs' key, the tolerance
KERAS_GOLDENS = (
    ("keras_mlp.h5", ("mlp_x",), "mlp_y", 1e-5),
    ("keras_cnn.h5", ("cnn_x",), "cnn_y", 1e-4),
    ("keras_lstm.h5", ("lstm_x",), "lstm_y", 1e-4),
    ("keras_functional.h5", ("functional_x",), "functional_y", 1e-4),
    ("keras_two_input.h5", ("two_xa", "two_xb"), "two_y", 1e-5),
    ("keras_gru.h5", ("gru_x",), "gru_y", 1e-4),
    ("keras_shapes.h5", ("shapes_x",), "shapes_y", 1e-4),
    ("keras_repeat.h5", ("repeat_x",), "repeat_y", 1e-4),
    ("keras_nested.h5", ("nested_x",), "nested_y", 1e-5))
FIXTURES = Path(__file__).resolve().parent / "tests" / "fixtures"


def write_keras_char_rnn(path, vocab, hidden, layers, seed):
    """Write the char-RNN's Keras twin as Keras 2 saves it (``model_config``
    JSON, ``/model_weights/<layer>`` groups with ``weight_names``, the
    weights under ``<model>/<layer>/<cell>/``), with seeded weights drawn
    as Keras initializes them: Glorot-uniform kernels, orthogonal
    recurrent kernels, zero biases but the forget gate's ones
    (``unit_forget_bias``)."""
    rng = np.random.default_rng(seed)

    def glorot(n_in, n_out):
        lim = np.sqrt(6.0 / (n_in + n_out))
        return rng.uniform(-lim, lim, (n_in, n_out)).astype(np.float32)

    def orthogonal(rows, cols):
        q, r = np.linalg.qr(rng.normal(size=(cols, rows)))
        return (q * np.sign(np.diag(r))).T.astype(np.float32)

    names = [f"lstm_{i + 1}" for i in range(layers)] + ["out"]
    lstm = dict(units=hidden, activation="tanh",
                recurrent_activation="sigmoid", use_bias=True,
                return_sequences=True, return_state=False,
                go_backwards=False, stateful=False, unroll=False,
                unit_forget_bias=True, dropout=0.0, recurrent_dropout=0.0)
    config = {"class_name": "Sequential", "config": {
        "name": "char_rnn", "trainable": True, "layers": [
            {"class_name": "InputLayer", "config": {
                "batch_shape": [None, None, vocab], "dtype": "float32",
                "name": "chars"}}]
        + [{"class_name": "LSTM", "config": dict(lstm, name=n)}
           for n in names[:-1]]
        + [{"class_name": "Dense", "config": {
            "name": "out", "units": vocab, "activation": "softmax",
            "use_bias": True}}],
        "build_input_shape": [None, None, vocab]}}
    weights = {}
    n_in = vocab
    for n in names[:-1]:
        bias = np.zeros(4 * hidden, np.float32)
        bias[hidden:2 * hidden] = 1.0
        weights[n] = ("lstm_cell", {
            "kernel": glorot(n_in, 4 * hidden),
            "recurrent_kernel": orthogonal(hidden, 4 * hidden),
            "bias": bias})
        n_in = hidden
    weights["out"] = (None, {"kernel": glorot(hidden, vocab),
                             "bias": np.zeros(vocab, np.float32)})
    with Hdf5Writer(str(path)) as w:
        for obj in ("/", "/model_weights"):
            if obj != "/":
                w.create_group(obj)
            w.write_attr_str(obj, "backend", "torch")
            w.write_attr_str(obj, "keras_version", "3.13.1")
        w.write_attr_str("/", "model_config", json.dumps(config))
        w.write_attr_strlist("/model_weights", "layer_names", names)
        for n, (cell, arrays) in weights.items():
            prefix = f"char_rnn/{n}" + (f"/{cell}" if cell else "")
            group = f"/model_weights/{n}"
            w.create_group(group)
            path_so_far = group
            for part in prefix.split("/"):
                path_so_far += "/" + part
                w.create_group(path_so_far)
            for an, a in arrays.items():
                w.write_dataset(f"{group}/{prefix}/{an}", a)
            w.write_attr_strlist(group, "weight_names",
                                 [f"{prefix}/{an}" for an in arrays])
        w.create_group("/model_weights/top_level_model_weights")
        w.write_attr_strlist("/model_weights/top_level_model_weights",
                             "weight_names", [])


def write_batch_h5(path, array):
    """One batch file as the gateway reads it: a single dataset."""
    with Hdf5Writer(str(path)) as w:
        w.write_dataset("/data", np.asarray(array, np.float32))


def keras_import_seconds(path):
    """The import's seconds onto the card in parts: reading the file
    (parse and every dataset), building the net on the card (config and
    init), loading the weights (read and host-to-card copy), and the
    whole public call; returns (the imported net, the record)."""
    rec = {}
    t0 = time.perf_counter()
    with Hdf5Archive(str(path)) as h5:
        cfg = json.loads(h5.read_attribute_as_string("model_config"))
        n_bytes = 0

        def walk(p):
            nonlocal n_bytes
            for kind, name in h5.list_children(p):
                child = f"{p.rstrip('/')}/{name}"
                if kind == "g":
                    walk(child)
                else:
                    n_bytes += h5.read_dataset(child).nbytes
        walk("/")
    rec["read_s"] = time.perf_counter() - t0
    rec["weight_bytes"] = n_bytes
    t0 = time.perf_counter()
    net = KerasModelImport._build_sequential(cfg["config"]["layers"], None)
    torch.cuda.synchronize()
    rec["build_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    with Hdf5Archive(str(path)) as h5:
        KerasModelImport._load_sequential_weights(h5, net)
    torch.cuda.synchronize()
    rec["weights_read_and_copy_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    net = KerasModelImport.import_keras_model_and_weights(str(path))
    torch.cuda.synchronize()
    rec["import_s"] = time.perf_counter() - t0
    return net, rec


def keras_goldens():
    """Each committed golden fixture imported onto the card against its
    Keras outputs, at its own tolerance."""
    goldens = np.load(FIXTURES / "keras_goldens.npz")
    out = {}
    for name, xs, y, tol in KERAS_GOLDENS:
        net = KerasModelImport.import_keras_model_and_weights(
            str(FIXTURES / name))
        x = [goldens[k] for k in xs]
        got = net.output(x if len(x) > 1 else x[0]).float().cpu().numpy()
        out[name] = dict(max_abs_err=float(np.abs(got - goldens[y]).max()),
                         tol=tol, device=str(net.device))
    return out


def keras_transfer_net(base):
    """TransferLearning on the imported twin: layer 0 frozen, Adam at
    KERAS_LR."""
    return (TransferLearning.builder(base)
            .fine_tune_configuration(FineTuneConfiguration(
                updater="adam", learning_rate=KERAS_LR))
            .set_feature_extractor(0).build())


def keras_early_stopping(net, train, held_out, parallel=False):
    """An EarlyStoppingTrainer (or, ``parallel``, an
    EarlyStoppingParallelTrainer on the running group) over ``train`` for
    KERAS_EPOCHS epochs, scored on ``held_out``; returns (result, the
    calculator, the loss of every step)."""
    calc = DataSetLossCalculator(ListDataSetIterator(held_out))
    cfg = EarlyStoppingConfiguration(
        epoch_termination_conditions=[
            MaxEpochsTerminationCondition(KERAS_EPOCHS)],
        score_calculator=calc, model_saver=InMemoryModelSaver())
    it = ListDataSetIterator(train)
    trainer = (EarlyStoppingParallelTrainer(cfg, net, it) if parallel
               else EarlyStoppingTrainer(cfg, net, it))
    # the step each batch goes through: the net's, or the ParallelTrainer's
    stepper = trainer.trainer if parallel else net
    step, losses = stepper.fit_batch, []

    def spy(batch):
        loss = step(batch)
        losses.append(float(loss))
        return loss
    stepper.fit_batch = spy
    try:
        result = trainer.fit()
    finally:
        del stepper.fit_batch
    return result, calc, losses


def keras_transfer(smi):
    """The Keras import and transfer learning on the card (ROADMAP A7.1,
    A7.2): the char-RNN's Keras twin written by the port's HDF5 writer,
    imported onto the card and onto the CPU (params bit for bit),
    output() against the CPU and a traced one holding 2 K1, each golden
    fixture on the card at its tolerance; TransferLearning freezing layer
    0 and an EarlyStoppingTrainer (first loss and gradients against the
    CPU, 2 K2 and 2 K3 a fit_batch, the frozen layer bit for bit, the
    best score reproduced), and an EarlyStoppingParallelTrainer at world
    1 over NCCL bit for bit the same run. Returns the path's launch
    counts."""
    from deeplearning4j_tpu_torch.parallel import multihost
    tmp = Path(tempfile.mkdtemp(prefix="dl4j_keras_"))
    try:
        path = tmp / "char_rnn_twin.h5"
        write_keras_char_rnn(path, **KERAS_TWIN, seed=SEED + 40)
        reset_counts()
        net, seconds = keras_import_seconds(path)
        LIVE["keras_conf"] = net.conf
        cpu = KerasModelImport.import_keras_model_and_weights(
            str(path), device="cpu")
        rec = dict(phase="keras_transfer", nvidia_smi=smi,
                   params=net.num_params(), import_seconds=seconds,
                   file_bytes=path.stat().st_size,
                   layers=[type(layer).__name__ for layer in net.layers],
                   params_bitwise_cpu=bool(np.array_equal(
                       net.params_flat(), cpu.params_flat())))
        (B, T), V = LSTM_BATCH, KERAS_TWIN["vocab"]
        rng = np.random.default_rng(SEED + 41)
        x = np.eye(V, dtype=np.float32)[rng.integers(0, V, (B, T))]
        probs = net.output(x)
        rec["output_shape"] = list(probs.shape)
        rec["max_abs_err_vs_cpu"] = float(
            (probs.cpu() - uncounted(cpu.output, x)).abs().max())
        rec["output_ms"] = uncounted(host_ms, lambda: net.output(x))
        rec["output_profile"] = uncounted(
            device_profile, lambda: net.output(x),
            {"lstm_fwd_infer_kernel": KERAS_TWIN["layers"]})
        rec["goldens"] = keras_goldens()

        batches = text_batches(KERAS_TRAIN_BATCHES + KERAS_HELD_OUT, B, T,
                               SEED + 42)
        train, held = (batches[:KERAS_TRAIN_BATCHES],
                       batches[KERAS_TRAIN_BATCHES:])
        tl = keras_transfer_net(net)
        tl_cpu = keras_transfer_net(cpu)
        grads, loss, _ = uncounted(tl.compute_gradient_and_score, train[0])
        cpu_grads, cpu_loss, _ = tl_cpu.compute_gradient_and_score(train[0])
        rec["first_loss"], rec["first_loss_cpu"] = float(loss), float(
            cpu_loss)
        rec["grad_rel_err"], rec["grad_worst"] = grad_rel_err(grads,
                                                              cpu_grads)
        frozen0 = {k: t.clone() for k, t in tl.params[0].items()}
        before = counts()
        result, calc, losses = keras_early_stopping(tl, train, held)
        after = counts()
        steps = len(losses)
        es_launches = {k: after[k] - before[k] for k in after}
        rec.update(
            losses=losses, steps=steps, es_launches=es_launches,
            termination=result.termination_reason,
            total_epochs=result.total_epochs,
            best_epoch=result.best_model_epoch,
            best_score=result.best_model_score,
            score_vs_epoch=result.score_vs_epoch,
            frozen_bitwise=all(torch.equal(frozen0[k], tl.params[0][k])
                               for k in frozen0),
            best_score_recomputed=uncounted(calc.calculate_score,
                                            result.best_model))
        path_counts = counts()

        # the same run through EarlyStoppingParallelTrainer at world 1
        check(multihost.initialize(f"file://{tmp}/rdv_keras", 1, 0)
              == "nccl", "a world-1 group on the card runs nccl")
        try:
            par = keras_transfer_net(net)
            pres, _, plosses = uncounted(keras_early_stopping, par, train,
                                         held, True)
        finally:
            multihost.shutdown()
        rec.update(parallel_losses=plosses,
                   parallel_bitwise=(plosses == losses
                                     and params_equal(par, tl)
                                     and pres.score_vs_epoch
                                     == result.score_vs_epoch
                                     and pres.best_model_epoch
                                     == result.best_model_epoch))
        step_net = keras_transfer_net(net)
        rec["fine_tune_ms_per_step"] = uncounted(
            host_ms, lambda: step_net.fit_batch(train[0]))
        rec["main_path_launches"] = path_counts
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit(rec)

    L = KERAS_TWIN["layers"]
    check(rec["params"] == KERAS_PARAMS and rec["params_bitwise_cpu"],
          f"imported twin: {rec['params']} params, bitwise CPU "
          f"{rec['params_bitwise_cpu']}")
    check(rec["output_shape"] == [B, T, V]
          and rec["max_abs_err_vs_cpu"] <= TOL_KERAS,
          f"imported twin's output against the CPU: {rec['output_shape']}, "
          f"{rec['max_abs_err_vs_cpu']}")
    check(rec["output_profile"]["traced_path_kernels"]
          == {"lstm_fwd_infer_kernel": L},
          f"a traced output() holds {rec['output_profile']}")
    for name, g in rec["goldens"].items():
        check(g["max_abs_err"] <= g["tol"] and g["device"] == "cuda",
              f"golden {name} on the card: {g}")
    check(abs(rec["first_loss"] - rec["first_loss_cpu"])
          <= TOL_TRAIN_LOSS * abs(rec["first_loss_cpu"])
          and rec["grad_rel_err"] <= TOL_TRAIN_GRAD,
          f"fine-tune step against the CPU: loss {rec['first_loss']} vs "
          f"{rec['first_loss_cpu']}, gradient {rec['grad_rel_err']} at "
          f"{rec['grad_worst']}")
    check(steps == KERAS_EPOCHS * KERAS_TRAIN_BATCHES
          and es_launches["lstm_fwd_train"] == L * steps
          and es_launches["lstm_bwd"] == L * steps,
          f"early stopping: {steps} steps launched {es_launches}")
    check(rec["frozen_bitwise"], "the frozen layer moved")
    check(rec["termination"] == "EpochTerminationCondition"
          and rec["total_epochs"] == KERAS_EPOCHS
          and abs(rec["best_score_recomputed"] - rec["best_score"])
          <= 1e-6 * abs(rec["best_score"]),
          f"early stopping result: {rec['termination']}, epochs "
          f"{rec['total_epochs']}, best {rec['best_score']} recomputed "
          f"{rec['best_score_recomputed']}")
    check(rec["parallel_bitwise"],
          f"EarlyStoppingParallelTrainer at world 1: {plosses} vs {losses}")
    check(all(np.isfinite(losses)), f"non-finite losses {losses}")
    return rec["main_path_launches"]


# --------------------------------------------------------------------------
# 13. the single-card training features (ROADMAP A2)
# --------------------------------------------------------------------------

#: the train_features phase: 20 fit steps of the bf16 GPT, the batch of
#: step TF_NAN_STEP with a NaN feature; the card-vs-CPU gradient gate on
#: the first TF_CPU_ROWS rows of the first batch (a full-width bf16
#: backward on the CPU's plain versions: the rows cut its time, not its
#: widths); remat's dropout (DL4J's retain probability: 10% dropped);
#: the scan window and its batches; the ResNet-50 input path's batches
#: and its turns; the solver's iterations (parity, then training)
TF_STEPS, TF_NAN_STEP, TF_CPU_ROWS = 20, 7, 8
TF_RETAIN = 0.9
TF_SCAN_WINDOW, TF_SCAN_BATCHES = 4, 8
TF_INPUT_BATCHES, TF_INPUT_TURNS = 8, ("pageable", "prefetch", "prefetch",
                                       "pageable")
TF_SOLVER_PARITY_ITERS, TF_SOLVER_ITERS = 10, 60
#: bf16 on the card against bf16 on the CPU's plain versions: the loss
#: (relative) and each gradient tensor against its largest |g|: two and
#: four bf16 ulps of 1.0, as the bf16 kernel cases
TOL_BF16_LOSS, TOL_BF16_GRAD = 1.6e-2, 3.2e-2
#: the solver on the card against the CPU after TF_SOLVER_PARITY_ITERS
#: iterations (f32 objectives; past ~10 iterations f32 rounding steers
#: Armijo line searches apart on any two devices)
TOL_SOLVER = 1e-5
#: ROC AUC and regression metrics on the card against the CPU (the
#: probabilities differ by f32 rounding only; 100 thresholds)
TOL_EVAL = 1e-4


def kernel_dtypes(fn, names, expect_total):
    """One traced call of ``fn``: for each kernel name, its launches per
    instantiated input type, read from the kernels' symbols in the trace
    (``flash_fwd_kernel<__nv_bfloat16, 64, false>``), in a
    ``traced_window``. A trace that misses launches is taken again,
    three times in all."""
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        _, _, kernels = traced_window(fn)
        out = {n: {"bfloat16": 0, "float32": 0} for n in names}
        for key, count, _ in kernels:
            for n in names:
                if n in key:
                    dt = "bfloat16" if "bfloat16" in key else "float32"
                    out[n][dt] += count
        if sum(sum(v.values()) for v in out.values()) == expect_total:
            break
    return out


class GuardProbe:
    """A listener that copies the params, the optimizer's moments and its
    count after step ``at - 1`` and, after step ``at`` (the bad one),
    records whether they are bitwise what they were."""

    def __init__(self, at: int):
        self.at, self.saved, self.unchanged = at, None, None

    @staticmethod
    def _written(model):
        return (tree_leaves(model.params)
                + [t for k, v in model.opt_state.items() if k != "count"
                   for t in tree_leaves(v)]
                + [torch.as_tensor(model.opt_state["count"])])

    def iteration_done(self, model, iteration, score):
        if iteration == self.at - 1:
            self.saved = [t.clone() for t in self._written(model)]
        elif iteration == self.at and self.saved is not None:
            self.unchanged = all(torch.equal(a, b) for a, b in
                                 zip(self.saved, self._written(model)))
            self.saved = None


def rel_l2(a, b) -> float:
    """||a - b|| / ||b|| over two lists of tensors."""
    num = sum(float(((x.float() - y.float()) ** 2).sum())
              for x, y in zip(a, b))
    den = sum(float((y.float() ** 2).sum()) for y in b)
    return (num / max(den, 1e-30)) ** 0.5


def bf16_vs_cpu(net, cpu, batch):
    """The first gradient of ``batch`` on the card and on the CPU (bf16
    compute, f32 masters): (loss rel err, worst gradient rel err, its
    name, card loss, CPU loss)."""
    grads, loss, _ = net.compute_gradient_and_score(batch)
    cpu_grads, cpu_loss, _ = cpu.compute_gradient_and_score(batch)
    check(all(g.dtype == torch.float32 for g in tree_leaves(grads)),
          "bf16 policy: the gradients are not f32")
    rel = abs(float(loss) - float(cpu_loss)) / abs(float(cpu_loss))
    worst, name = grad_rel_err(grads, cpu_grads)
    return rel, worst, name, float(loss), float(cpu_loss)


def tf_gpt_bf16(text_batches):
    """The bf16 GPT: its first gradient against the CPU's, 20 ``fit``
    steps from a ``DevicePrefetchIterator`` under four listeners and a
    skip_batch sentinel (one NaN batch), the f32 twin's distance, bf16
    against f32 step time in turns, a traced step's kernel symbols and
    GEMM share, peak memory. Returns the fit's launch counts."""
    L = SLICE["n_layers"]
    conf = gpt_decoder(**SLICE, precision="bf16")
    net = ComputationGraph(conf, device="cuda").init()
    cpu = ComputationGraph(gpt_decoder(**SLICE, precision="bf16"),
                           device="cpu").init()
    first = text_batches[0]
    rows = DataSet(first.features[:TF_CPU_ROWS], first.labels[:TF_CPU_ROWS])
    loss_rel, worst, worst_name, loss, cpu_loss = bf16_vs_cpu(net, cpu, rows)
    del cpu

    batches = list(text_batches[:TF_STEPS])
    bad = DataSet(np.array(batches[TF_NAN_STEP - 1].features),
                  batches[TF_NAN_STEP - 1].labels)
    bad.features[1, 5, 5] = np.nan
    batches[TF_NAN_STEP - 1] = bad
    scores = CollectScoresIterationListener()
    perf = PerformanceListener(frequency=1)
    probe = GuardProbe(TF_NAN_STEP)
    sentinel = DivergenceSentinel("skip_batch", lag=1)
    net.set_listeners(ScoreIterationListener(5), perf, scores, probe)
    net.set_divergence_sentinel(sentinel)
    reset_counts()
    t0 = time.perf_counter()
    net.fit(DevicePrefetchIterator(ListDataSetIterator(batches),
                                   dtype="bfloat16"))
    sentinel.flush()
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launched = counts()
    count_fit = int(net.opt_state["count"])
    losses = [s for _, s in scores.scores]
    params_bf16 = [t.clone() for t in tree_leaves(net.params)]

    # the same 20 steps in f32 (same init, same batches, same sentinel)
    f32 = ComputationGraph(gpt_decoder(**SLICE), device="cuda").init()
    f32_scores = CollectScoresIterationListener()
    f32.set_listeners(f32_scores)
    f32.set_divergence_sentinel(DivergenceSentinel("skip_batch", lag=1))
    f32.fit(ListDataSetIterator(batches))
    f32._sentinel.flush()
    dist = rel_l2(params_bf16, tree_leaves(f32.params))
    net.set_listeners()
    f32.set_listeners()
    clean = text_batches[1]

    # step time in turns, each with its peak memory: unguarded, then
    # both nets under a sentinel again (the guard's copies and selects)
    times, peaks = {}, {}
    for guard in ("", "_guarded"):
        for model in (net, f32):
            model.set_divergence_sentinel(
                DivergenceSentinel("skip_batch", lag=1) if guard else None)
        for name in ("bf16", "f32", "f32", "bf16"):
            model = net if name == "bf16" else f32
            torch.cuda.reset_peak_memory_stats()
            times.setdefault(name + guard, []).append(host_ms(
                lambda: model.fit_batch(clean), iters=8, warmup=2))
            peaks[name + guard] = torch.cuda.max_memory_allocated()
    for model in (net, f32):
        model.set_divergence_sentinel(None)
    symbols = kernel_dtypes(lambda: net.fit_batch(clean),
                            ATTENTION_KERNELS, 3 * L)
    prof = device_profile(lambda: net.fit_batch(clean),
                          {k: L for k in ATTENTION_KERNELS}, top=8,
                          groups=dict(attention=list(ATTENTION_KERNELS),
                                      gemm=["gemm", "nvjet", "cutlass",
                                            "xmma"]))
    prof_f32 = device_profile(lambda: f32.fit_batch(clean),
                              {k: L for k in ATTENTION_KERNELS}, top=4,
                              groups=dict(gemm=["gemm", "nvjet", "cutlass",
                                                "xmma"]))
    rec = dict(phase="train_features", case="gpt_bf16", config=SLICE,
               precision="bf16", batch=[TRAIN_BATCH, SLICE["seq_len"],
                                        len(CHARSET)],
               cpu_gate_rows=TF_CPU_ROWS, loss=loss, loss_cpu=cpu_loss,
               loss_rel_err=loss_rel, tol_loss=TOL_BF16_LOSS,
               worst_grad_rel_err=worst, worst_grad=worst_name,
               tol_grad=TOL_BF16_GRAD, fit_steps=TF_STEPS,
               nan_step=TF_NAN_STEP, skipped=sentinel.skipped_batches,
               bad_step_unchanged=probe.unchanged, losses=losses,
               losses_f32=[s for _, s in f32_scores.scores],
               fit_s=fit_s, samples_per_s_listener=[
                   h[1] for h in perf.history],
               params_rel_l2_bf16_vs_f32=dist,
               fit_launches=launched, kernel_symbols=symbols,
               ms_per_step=times, peak_mem_bytes=peaks, profile_bf16=prof,
               profile_f32=prof_f32, count_after_fit=count_fit)
    emit(rec)
    check(loss_rel <= TOL_BF16_LOSS,
          f"bf16 GPT loss {loss} vs the CPU's {cpu_loss}")
    check(worst <= TOL_BF16_GRAD,
          f"bf16 GPT gradient {worst_name} differs from the CPU's by "
          f"{worst} of its largest |g|")
    check(sentinel.skipped_batches == 1 and probe.unchanged is True,
          f"the sentinel skipped {sentinel.skipped_batches} steps; the bad "
          f"step left the params, moments and count unchanged: "
          f"{probe.unchanged}")
    check(len(losses) == TF_STEPS and not np.isfinite(
        losses[TF_NAN_STEP - 1]) and all(np.isfinite(
            losses[:TF_NAN_STEP - 1] + losses[TF_NAN_STEP:])),
          f"bf16 GPT losses {losses}")
    check(count_fit == TF_STEPS - 1,
          f"the device count {count_fit} != {TF_STEPS - 1}")
    per_fit = dict(flash_attn_fwd=L * TF_STEPS, flash_attn_dq=L * TF_STEPS,
                   flash_attn_dkv=L * TF_STEPS, lstm_fwd_infer=0,
                   lstm_fwd_train=0, lstm_bwd=0)
    check(launched == per_fit, f"bf16 fit launches {launched} != {per_fit}")
    check(all(symbols[k] == {"bfloat16": L, "float32": 0}
              for k in ATTENTION_KERNELS),
          f"a traced bf16 step's attention kernels: {symbols}")
    check(np.mean(losses[-4:]) < losses[0], f"bf16 GPT losses {losses}")
    return launched


def tf_gpt_remat(batch):
    """bf16 GPT with dropout on every layer that takes it, remat on and
    off from the same seed: bitwise gradients, K4 twice per layer under
    remat, peak memory of a step each."""
    L = SLICE["n_layers"]
    nets = {}
    for remat in (False, True):
        conf = gpt_decoder(**SLICE, precision="bf16", dropout=TF_RETAIN)
        conf.training.remat = remat
        nets[remat] = ComputationGraph(conf, device="cuda").init()
    grads, launched, peak, losses = {}, {}, {}, {}
    for remat, net in nets.items():
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        g, loss, _ = net.compute_gradient_and_score(batch)
        torch.cuda.synchronize()
        launched[remat] = counts()
        peak[remat] = torch.cuda.max_memory_allocated()
        grads[remat], losses[remat] = tree_leaves(g), loss
    bitwise = bool(torch.equal(losses[True], losses[False]) and all(
        torch.equal(a, b) for a, b in zip(grads[True], grads[False])))
    rec = dict(phase="train_features", case="gpt_remat", retain=TF_RETAIN,
               grads_bitwise=bitwise, launches_remat=launched[True],
               launches_no_remat=launched[False],
               peak_mem_bytes_remat=peak[True],
               peak_mem_bytes_no_remat=peak[False])
    emit(rec)
    check(bitwise, "remat on and off: the gradients differ")
    check(launched[True]["flash_attn_fwd"] == 2 * L
          and launched[True]["flash_attn_dq"] == L
          and launched[True]["flash_attn_dkv"] == L
          and launched[False]["flash_attn_fwd"] == L,
          f"remat launches {launched}")
    return launched[True]


def tf_char_rnn_bf16(text_batches):
    """The bf16 char-RNN's tBPTT: the first window's loss and gradients
    against the CPU's, a fit_batch's K2/K3 launches and symbols, the
    distance from the f32 run, a NaN in the second window under the
    sentinel, clean guarded steps without a host sync. Returns the main
    path's launch counts."""
    Lr = LSTM_SLICE["layers"]
    conf = char_rnn_lstm(**LSTM_SLICE)
    conf.training.precision = "bf16"
    win = conf.training.tbptt_fwd_length
    n_win = -(-LSTM_TRAIN_BATCH[1] // win)
    net = MultiLayerNetwork(conf, device="cuda").init()
    cpu_conf = char_rnn_lstm(**LSTM_SLICE)
    cpu_conf.training.precision = "bf16"
    cpu = MultiLayerNetwork(cpu_conf, device="cpu").init()
    b0 = text_batches[0]
    first = DataSet(b0.features[:, :win], b0.labels[:, :win])
    loss_rel, worst, worst_name, loss, cpu_loss = bf16_vs_cpu(net, cpu,
                                                              first)
    del cpu
    f32 = MultiLayerNetwork(char_rnn_lstm(**LSTM_SLICE), device="cuda").init()
    reset_counts()
    mean = float(net.fit_batch(b0))
    torch.cuda.synchronize()
    launched = counts()
    f32_mean = float(f32.fit_batch(b0))
    dist = rel_l2(tree_leaves(net.params), tree_leaves(f32.params))
    symbols = kernel_dtypes(lambda: net.fit_batch(text_batches[1]),
                            ("lstm_fwd_train_kernel", "lstm_bwd_kernel"),
                            2 * n_win * Lr)

    # a NaN in the second window, under a skip_batch sentinel
    sentinel = DivergenceSentinel("skip_batch", lag=1)
    net.set_divergence_sentinel(sentinel)
    probe = GuardProbe(net.iteration_count + 2)
    net.set_listeners(probe)
    bad = DataSet(np.array(text_batches[2].features),
                  text_batches[2].labels)
    bad.features[1, win + 3, 3] = np.nan
    net.fit_batch(bad)
    net.set_listeners()
    after_bad = float(net.fit_batch(text_batches[3]))
    sentinel.flush()
    finite = bool(all(torch.isfinite(t).all() for t in
                      tree_leaves(net.params)))

    # clean guarded steps with no listener: no host sync (the batches
    # already on the card; the flag of each step read a step late)
    staged = [DataSet(b.features, b.labels) for b in text_batches[4:7]]
    staged = list(DevicePrefetchIterator(ListDataSetIterator(staged)))
    net.fit_batch(staged[0])
    torch.cuda.synchronize()
    sync_error = None
    torch.cuda.set_sync_debug_mode("error")
    try:
        for b in staged[1:]:
            net.fit_batch(b)
    except RuntimeError as e:
        sync_error = str(e)[:300]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    sentinel.flush()
    rec = dict(phase="train_features", case="char_rnn_bf16_tbptt",
               config=LSTM_SLICE, precision="bf16",
               batch=[*LSTM_TRAIN_BATCH, len(CHARSET)], tbptt=win,
               window1_loss=loss, window1_loss_cpu=cpu_loss,
               loss_rel_err=loss_rel, tol_loss=TOL_BF16_LOSS,
               worst_grad_rel_err=worst, worst_grad=worst_name,
               tol_grad=TOL_BF16_GRAD, fit_batch_mean=mean,
               fit_batch_mean_f32=f32_mean,
               params_rel_l2_bf16_vs_f32_after_one_fit_batch=dist,
               launches_per_fit_batch=launched, kernel_symbols=symbols,
               nan_window_skipped=sentinel.skipped_batches,
               bad_window_unchanged=probe.unchanged,
               loss_after_bad_batch=after_bad, params_finite=finite,
               guarded_steps_sync_error=sync_error)
    emit(rec)
    per_fit = dict(flash_attn_fwd=0, flash_attn_dq=0, flash_attn_dkv=0,
                   lstm_fwd_infer=0, lstm_fwd_train=n_win * Lr,
                   lstm_bwd=n_win * Lr)
    check(loss_rel <= TOL_BF16_LOSS,
          f"bf16 char-RNN window-1 loss {loss} vs the CPU's {cpu_loss}")
    check(worst <= TOL_BF16_GRAD,
          f"bf16 char-RNN gradient {worst_name} differs from the CPU's by "
          f"{worst} of its largest |g|")
    check(launched == per_fit, f"bf16 char-RNN launches {launched}")
    check(all(symbols[k] == {"bfloat16": n_win * Lr, "float32": 0}
              for k in symbols), f"bf16 char-RNN kernel symbols {symbols}")
    check(sentinel.skipped_batches == 1 and probe.unchanged is True
          and finite and np.isfinite(after_bad),
          f"the NaN window: skipped {sentinel.skipped_batches}, unchanged "
          f"{probe.unchanged}, finite {finite}, next loss {after_bad}")
    check(sync_error is None, f"a clean guarded step synced: {sync_error}")
    return launched


def tf_remat_char_rnn(batch):
    """The bf16 char-RNN's fit_batch under remat: K2 twice per layer and
    window (forward and recompute), K3 once."""
    Lr = LSTM_SLICE["layers"]
    conf = char_rnn_lstm(**LSTM_SLICE)
    conf.training.precision = "bf16"
    conf.training.remat = True
    n_win = -(-LSTM_TRAIN_BATCH[1] // conf.training.tbptt_fwd_length)
    net = MultiLayerNetwork(conf, device="cuda").init()
    reset_counts()
    net.fit_batch(batch)
    torch.cuda.synchronize()
    launched = counts()
    emit(dict(phase="train_features", case="char_rnn_remat",
              launches_per_fit_batch=launched))
    check(launched["lstm_fwd_train"] == 2 * n_win * Lr
          and launched["lstm_bwd"] == n_win * Lr,
          f"char-RNN remat launches {launched}")
    return launched


def tf_scan_window(text_batches):
    """fit(scan_window=4) of the f32 GPT over 8 batches against 8
    fit_batch calls: bitwise params, the same launches, the burst's 8
    losses."""
    L = SLICE["n_layers"]
    batches = list(text_batches[:TF_SCAN_BATCHES])
    loop = ComputationGraph(gpt_decoder(**SLICE), device="cuda").init()
    scan = ComputationGraph(gpt_decoder(**SLICE), device="cuda").init()
    reset_counts()
    loop_losses = [float(loop.fit_batch(b)) for b in batches]
    torch.cuda.synchronize()
    loop_launches = counts()
    col = CollectScoresIterationListener()
    scan.set_listeners(col)
    reset_counts()
    t0 = time.perf_counter()
    scan.fit(ListDataSetIterator(batches), scan_window=TF_SCAN_WINDOW)
    torch.cuda.synchronize()
    scan_s = time.perf_counter() - t0
    scan_launches = counts()
    bitwise = all(torch.equal(a, b) for a, b in
                  zip(tree_leaves(scan.params), tree_leaves(loop.params)))
    burst = [s for _, s in col.scores]
    emit(dict(phase="train_features", case="scan_window",
              window=TF_SCAN_WINDOW, batches=TF_SCAN_BATCHES,
              params_bitwise=bitwise, burst_losses=burst,
              loop_losses=loop_losses, loop_launches=loop_launches,
              scan_launches=scan_launches, scan_fit_s=scan_s))
    check(bitwise, "fit(scan_window=4) differs from 8 fit_batch calls")
    check(burst == loop_losses,
          f"the burst's losses {burst} != the loop's {loop_losses}")
    check(scan_launches == loop_launches and
          scan_launches["flash_attn_fwd"] == L * TF_SCAN_BATCHES,
          f"scan launches {scan_launches} vs loop {loop_launches}")
    return scan_launches


def tf_input_path():
    """The bf16 ResNet-50 fit_batch of [64, 224, 224, 3] fed by
    DevicePrefetchIterator against the pageable copy, in turns: images/s,
    the data_wait share, the busy share of a traced window."""
    from torch.profiler import ProfilerActivity, profile
    net = ComputationGraph(resnet50(dtype="bfloat16"), device="cuda").init()
    rng = np.random.default_rng(SEED + 11)
    B, S, C = RESNET_BATCH, RESNET_HW, RESNET_CLASSES
    batches = [DataSet(rng.random((B, S, S, 3), dtype=np.float32),
                       np.eye(C, dtype=np.float32)[rng.integers(0, C, B)])
               for _ in range(TF_INPUT_BATCHES)]
    net.fit_batch(batches[0])   # cuDNN's algorithms picked

    def source(kind):
        base = ListDataSetIterator(batches)
        return (DevicePrefetchIterator(base, dtype="bfloat16")
                if kind == "prefetch" else base)

    def batches_of(it):
        # has_next / next, as a training loop reads a fresh iterator (a
        # for loop's reset would restart the prefetch it has begun)
        while it.has_next():
            yield it.next()

    def run(kind):
        stats = TrainingStats()
        torch.cuda.synchronize()
        it = source(kind)
        t0 = time.perf_counter()
        for ds in stats.timed_iter(batches_of(it)):
            with stats.phase("step"):
                net.fit_batch(ds)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if kind == "prefetch":
            it.close()
        e = stats.export()
        return dict(images_per_s=B * TF_INPUT_BATCHES / wall, wall_s=wall,
                    data_wait_s=e["input_stall_s"],
                    data_wait_share=e["input_stall_s"] / wall)

    turns = [dict(kind=k, **run(k)) for k in TF_INPUT_TURNS]
    busy = {}
    for kind in ("pageable", "prefetch"):
        run(kind)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run(kind)
            wall_us = (time.perf_counter() - t0) * 1e6
        dev = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        busy[kind] = dict(
            busy_share=sum(e.self_device_time_total for e in dev) / wall_us,
            memcpy_ms=sum(e.self_device_time_total for e in dev
                          if "memcpy" in e.key.lower()) / 1e3)
    emit(dict(phase="train_features", case="input_path",
              config="resnet50(dtype='bfloat16')", batch=[B, S, S, 3],
              batches=TF_INPUT_BATCHES, turns=turns, traced=busy))
    check(all(np.isfinite(t["images_per_s"]) for t in turns),
          f"input path turns {turns}")


def tf_solver_and_eval():
    """An Iris MLP under L-BFGS on the card against the CPU (the scores
    after the parity iterations, then a longer run that trains), and
    evaluate_roc / evaluate_regression on the card against the CPU."""
    ds = next(iter(IrisDataSetIterator(150)))

    def mlp(device, params=None):
        conf = (NeuralNetConfiguration.builder().seed(1)
                .optimization_algo("lbfgs").list()
                .layer(DenseLayer(n_out=12, activation="tanh"))
                .layer(OutputLayer(n_out=3, activation="softmax"))
                .set_input_type(InputType.feed_forward(4)).build())
        return MultiLayerNetwork(conf, device=device).init(params)

    card, cpu = mlp("cuda"), mlp("cpu")
    s_card = Solver(card, max_iterations=TF_SOLVER_PARITY_ITERS).optimize(ds)
    s_cpu = Solver(cpu, max_iterations=TF_SOLVER_PARITY_ITERS).optimize(ds)
    solver_rel = abs(s_card - s_cpu) / abs(s_cpu)
    trained = mlp("cuda")
    s0 = trained.score(ds)
    s1 = Solver(trained, max_iterations=TF_SOLVER_ITERS).optimize(ds)
    acc = trained.evaluate(IrisDataSetIterator(150)).accuracy()

    rng = np.random.default_rng(SEED + 13)
    x = rng.normal(size=(256, 4)).astype(np.float32)
    y2 = np.eye(2, dtype=np.float32)[(x.sum(1) > 0).astype(int)]
    yr = (x @ rng.normal(size=(4, 2))).astype(np.float32)

    def head(n_out, act, loss, device, params=None):
        conf = (NeuralNetConfiguration.builder().seed(1)
                .updater("adam", learning_rate=0.05).weight_init("xavier")
                .list().layer(DenseLayer(n_out=16, activation="tanh"))
                .layer(OutputLayer(n_out=n_out, activation=act, loss=loss))
                .set_input_type(InputType.feed_forward(4)).build())
        return MultiLayerNetwork(conf, device=device).init(params)

    evals = {}
    for kind, (y, args) in {"roc": (y2, (2, "softmax", "mcxent")),
                            "regression": (yr, (2, "identity", "mse"))
                            }.items():
        src = head(*args, "cpu")
        it = ListDataSetIterator([DataSet(x, y)])
        src.fit(it, epochs=30, use_async=False)
        params = [{k: t.clone() for k, t in p.items()} for p in src.params]
        on_card = head(*args, "cuda", params)
        if kind == "roc":
            a, b = on_card.evaluate_roc(it), src.evaluate_roc(it)
            m = on_card.evaluate_roc_multi_class(it)
            evals[kind] = dict(auc_card=a.calculate_auc(),
                               auc_cpu=b.calculate_auc(),
                               auc_class1_card=m.calculate_auc(1))
            evals[kind]["diff"] = abs(evals[kind]["auc_card"]
                                      - evals[kind]["auc_cpu"])
        else:
            a, b = on_card.evaluate_regression(it), src.evaluate_regression(it)
            evals[kind] = dict(mse_card=a.average_mean_squared_error(),
                               mse_cpu=b.average_mean_squared_error(),
                               r_card=[a.correlation_r2(c) for c in (0, 1)])
            evals[kind]["diff"] = abs(evals[kind]["mse_card"]
                                      - evals[kind]["mse_cpu"]) / abs(
                evals[kind]["mse_cpu"])
    emit(dict(phase="train_features", case="solver_and_eval",
              solver="lbfgs", parity_iterations=TF_SOLVER_PARITY_ITERS,
              score_card=s_card, score_cpu=s_cpu, score_rel_err=solver_rel,
              tol_solver=TOL_SOLVER, trained_iterations=TF_SOLVER_ITERS,
              score_before=s0, score_after=s1, iris_accuracy=acc,
              eval=evals, tol_eval=TOL_EVAL))
    check(solver_rel <= TOL_SOLVER,
          f"L-BFGS on the card {s_card} vs the CPU {s_cpu}")
    check(s1 < 0.5 * s0 and acc > 0.9,
          f"L-BFGS on the card: score {s0} -> {s1}, accuracy {acc}")
    check(evals["roc"]["diff"] <= TOL_EVAL
          and evals["regression"]["diff"] <= TOL_EVAL
          and evals["roc"]["auc_card"] > 0.9,
          f"evaluation on the card vs the CPU: {evals}")


def train_features():
    """The single-card training features on the card: the bf16 GPT (K4,
    K5, K6 in bf16) through fit, a prefetching iterator, listeners and a
    sentinel; remat; the bf16 char-RNN's tBPTT (K2, K3 in bf16); a scan
    window; the input path; a solver and the ROC / regression
    evaluators. Returns the main path's launch counts: the bf16 fit's
    (K4-K6) and the bf16 char-RNN fit_batch's (K2, K3)."""
    B, T = TRAIN_BATCH, SLICE["seq_len"]
    n = max(TF_STEPS, TF_SCAN_BATCHES)
    text = synthetic_char_text(n * B * (T + 1) + 1, seed=SEED + 21)
    gpt_batches = char_lm_batches(text, T, B, charset=CHARSET)
    check(len(gpt_batches) >= n, f"{len(gpt_batches)} GPT batches")
    (Bl, Tl) = LSTM_TRAIN_BATCH
    text = synthetic_char_text(8 * Bl * (Tl + 1) + 1, seed=SEED + 22)
    lstm_batches = char_lm_batches(text, Tl, Bl, charset=CHARSET)
    t0 = time.perf_counter()
    gpt = tf_gpt_bf16(gpt_batches)
    remat = tf_gpt_remat(gpt_batches[2])
    lstm = tf_char_rnn_bf16(lstm_batches)
    lstm_remat = tf_remat_char_rnn(lstm_batches[0])
    scan = tf_scan_window(gpt_batches)
    tf_input_path()
    tf_solver_and_eval()
    emit(dict(phase="train_features", case="summary",
              seconds=time.perf_counter() - t0))
    return dict(gpt=gpt, char_rnn=lstm, gpt_remat=remat,
                char_rnn_remat=lstm_remat, scan=scan)


# --------------------------------------------------------------------------
# 14. the serving fleet (ROADMAP A5.3)
# --------------------------------------------------------------------------

#: the fleet: replicas behind the router; the kill storm's requests per
#: model (one in four bulk); the kill's address (rank 0's 3rd admitted
#: request); the mid-stream kill's token; the streamed generate's prompt
#: length and new tokens; the traced failover's new tokens (the victim
#: dies at its FLEET_KILL_TOKEN-th token, the survivor streams the rest,
#: fewer than that, and lives); the router-hop wave; the rolling
#: restart's loaders; the watchdog's deadline and the hung dispatch
FLEET_REPLICAS, FLEET_STORM, FLEET_KILL_AT = 3, 32, 3
FLEET_KILL_TOKEN, FLEET_PROMPT, FLEET_NEW = 3, 17, 16
FLEET_TRACED_NEW = 4
FLEET_HOP_REQUESTS, FLEET_ROLL_LOADERS = 16, 4
FLEET_WATCH_S, FLEET_HANG_S = 0.5, 2.0
#: the autoscale stage: stalls a request on every rank the controller
#: may spawn (the sustained overload), its loaders (interactive, bulk)
FLEET_STALL_S, FLEET_LOADERS = 0.15, (6, 3)
#: small kernels that open a traced window, ahead of the counted ones
TRACE_PAD = 256
#: the metric families the router's /api/metrics must carry
FLEET_METRICS = ("fleet_replicas", "fleet_epoch", "fleet_dispatches_total",
                 "fleet_failovers_total", "fleet_admissions_total",
                 "fleet_removals_total", "fleet_generate_resumes_total",
                 "fleet_hedges_total", "fleet_retry_budget_tokens",
                 "fleet_brownout", "fleet_brownout_sheds_total",
                 "fleet_quarantines_total", "fleet_autoscale_up_total",
                 "fleet_autoscale_down_total",
                 "fleet_autoscale_decisions_total",
                 "fleet_target_replicas")


def fleet_replica(fdir, rank, model):
    """One replica as the gateway phase runs its server, on the card
    (``device=None``)."""
    return FleetReplica(fdir, rank, model=model,
                        max_batch=SERVER_MAX_BATCH,
                        max_wait_ms=SERVER_WAIT_MS, keep_models=4,
                        max_concurrency=SERVER_CLIENTS,
                        queue_depth=2 * SERVER_CLIENTS,
                        default_deadline_ms=120_000)


def wait_for(cond, timeout_s, what):
    """Poll ``cond`` until it holds; fails the run after ``timeout_s``.
    Returns the seconds it took."""
    t0 = time.monotonic()
    while not cond():
        check(time.monotonic() - t0 < timeout_s, f"timed out: {what}")
        time.sleep(0.01)
    return time.monotonic() - t0


def spawn_admitted(router, fdir, rank, model, timeout_s=120.0):
    """Spawn a replica and wait for the router to admit it: (replica,
    seconds from spawn to admission, the replica's captures before it)."""
    t0 = time.monotonic()
    rep = fleet_replica(fdir, rank, model)
    wait_for(lambda: rank in router.replicas(), timeout_s,
             f"replica {rank} admitted")
    admit_s = time.monotonic() - t0
    st = rep.server._batcher.stats()
    return rep, dict(rank=rank, spawn_to_admission_s=admit_s,
                     captures_before_admission=st["compiles"],
                     capture_s_before_admission=st["compile_s"])


def warm_ladder(rep, paths, ladders, names):
    """One request per bucket and model, straight to the replica: every
    predict bucket of each model captured before the router's traffic."""
    cli = KerasClient(rep.host, rep.port)
    try:
        for name in names:
            for f in ladders[name]:
                cli.predict(f, model=paths[name])
    finally:
        cli.close()


def latency_record(out, errors, wall) -> dict:
    rt = sorted(v[1] * 1e3 for v in out.values())
    return dict(served=len(out), errors=errors, wall_s=wall,
                requests_per_s=len(out) / wall,
                round_trip_p50_ms=float(np.percentile(rt, 50)) if rt else None,
                round_trip_p99_ms=float(np.percentile(rt, 99)) if rt else None,
                round_trip_max_ms=rt[-1] if rt else None)


def fleet_c2(out, reqs, refs) -> dict:
    """Each answer against its singleton ``output()`` on the card (C2),
    per model."""
    by_model = collections.defaultdict(dict)
    for i, v in out.items():
        by_model[reqs[i][0]][i] = v
    return {m: c2_record(a, {i: reqs[i][1] for i in a}, refs)
            for m, a in by_model.items()}


def stream_generate(host, port, tokens, max_new, model):
    """A raw streaming generate: (partial tokens, final answer)."""
    partials = []
    with socket.create_connection((host, port), timeout=300) as s:
        f = s.makefile("rwb")
        f.write((json.dumps({"op": "generate", "tokens": tokens,
                             "max_new_tokens": max_new, "model": model,
                             "stream": True}) + "\n").encode())
        f.flush()
        while True:
            line = f.readline()
            check(line, "the router closed a streamed generate")
            resp = json.loads(line)
            if resp.get("partial"):
                partials.append(int(resp["t"]))
                continue
            f.close()
            return partials, resp


def raw_exchange(host, port, reqs):
    """Several requests on ONE connection: each answer, in order."""
    out = []
    with socket.create_connection((host, port), timeout=120) as s:
        f = s.makefile("rwb")
        for req in reqs:
            f.write((json.dumps(req) + "\n").encode())
            f.flush()
            line = f.readline()
            check(line, f"the router hung up on {req}")
            out.append(json.loads(line))
        f.close()
    return out


def batches_by_model(reps, rows) -> dict:
    """Predict batches dispatched so far by the live replicas, per model
    (a model's feature row shape keys its bucket mix)."""
    out = collections.Counter()
    for rep in reps:
        for key, n in rep.server._batcher.stats()["bucket_mix"].items():
            for name, row in rows.items():
                if key.startswith(f"{row}:"):
                    out[name] += n
    return out


def traced_kernels(fn, names):
    """One ``traced_window`` of ``fn``: the launches of each kernel-name
    substring, and of all its kernels (the pad's taken out) under
    ``"all"``."""
    result, _, kernels = traced_window(fn)
    found = {n: sum(c for k, c, _ in kernels if n in k) for n in names}
    found["all"] = sum(c for _, c, _ in kernels)
    return result, found


def uncounted(fn, *args):
    """Run a comparison (a singleton reference) with the kernel wrappers'
    counts left as they were: its launches are not the path's."""
    saved = counts()
    try:
        return fn(*args)
    finally:
        for name, wrapper in KERNELS.items():
            wrapper.launches = saved[name]


def traced_waves(router, reps, paths, pools, rows):
    """A wave per model through the router under a trace: the K1 (char-
    RNN) and K4 (GPT) replays against the batches the replicas
    dispatched. A trace that drops a window's first kernels is taken
    again, five times in all."""
    rng = np.random.default_rng(SEED + 61)
    out = {}
    for name, symbol, per in (("char_rnn", "lstm_fwd_infer_kernel",
                               LSTM_SLICE["layers"]),
                              ("gpt", "flash_fwd_kernel",
                               SLICE["n_layers"])):
        files = pools[name][0]
        for attempt in range(1, 6):
            reqs = [(paths[name], files[j], False)
                    for j in rng.integers(0, len(files), 16)]
            b0 = batches_by_model(reps, rows)
            (_, errors, _), traced = traced_kernels(
                lambda: server_requests(router.host, router.port, reqs,
                                        SERVER_CLIENTS), [symbol])
            batches = batches_by_model(reps, rows)[name] - b0[name]
            check(not errors, f"traced {name} wave: {errors}")
            if traced[symbol] == per * batches:
                break
        out[name] = dict(symbol=symbol, batches=batches,
                         traced=traced[symbol], per_batch=per,
                         attempts=attempt)
    return out


def router_hop(router, rep, paths, pools):
    """The same char-RNN wave through the router and straight to one
    replica, in turns: requests/s and round trip."""
    rng = np.random.default_rng(SEED + 62)
    files = pools["char_rnn"][0]
    picks = rng.integers(0, len(files), FLEET_HOP_REQUESTS)
    reqs = [(paths["char_rnn"], files[j], i % 4 == 3)
            for i, j in enumerate(picks)]
    out = {}
    via = ("router", router.host, router.port)
    direct = ("replica", rep.host, rep.port)
    for where, host, port in (via, direct, direct, via):
        rec = latency_record(*server_requests(host, port, reqs,
                                              SERVER_CLIENTS))
        check(not rec["errors"], f"router hop wave ({where}): {rec}")
        out.setdefault(where, []).append(rec)
    return out


def fleet_pool_bytes(reps) -> dict:
    """The compile cache's bytes per live replica (its graphs' pools:
    predict buckets and the engine's steps), by the cache's owner."""
    cache = reps[0].server._batcher._compiled
    entries = cache.keys()
    out = {}
    for rep in reps:
        owners = (rep.server._batcher._cache_owner,
                  rep.server._gen._cache_owner)
        out[rep.rank] = sum(
            CompileCache.compiled_nbytes(cache.get(k))
            for k in entries if k[0] in owners and cache.get(k) is not None)
    return out


def fleet_memory(reps) -> dict:
    cache = reps[0].server._batcher._compiled
    per = fleet_pool_bytes(reps)
    return dict(pool_bytes_per_replica=per,
                pool_bytes_sum=sum(per.values()),
                cache=cache.stats(), cache_budget_bytes=cache.max_bytes,
                memory_reserved=torch.cuda.memory_reserved(),
                memory_allocated=torch.cuda.memory_allocated())


def fleet_kill_storm(router, reps, paths, pools, refs):
    """Stage 1: a predict storm on both models while ``kill_replica``
    hard-kills rank 0 at its FLEET_KILL_AT-th admitted request. Returns
    the record; the gates read it."""
    rng = np.random.default_rng(SEED + 60)
    reqs = []
    for i in range(2 * FLEET_STORM):
        name = ("char_rnn", "gpt")[i % 2]
        files = pools[name][0]
        reqs.append((paths[name], files[int(rng.integers(0, len(files)))],
                     i % 4 == 3))
    kill = Fault("kill_replica", rank=0, at_call=FLEET_KILL_AT)
    captures0 = {r.rank: r.server._batcher.stats()["compiles"] for r in reps}
    failovers0 = fleet_counter("fleet_failovers_total")
    dead, removed = {}, {}
    stop = threading.Event()

    def watch():
        # when the corpse died, and when the router let it go
        while not stop.is_set() and "t" not in removed:
            if "t" not in dead and not reps[0].alive:
                dead["t"] = time.monotonic()
            if "t" in dead and 0 not in router.replicas():
                removed["t"] = time.monotonic()
            time.sleep(0.005)

    watcher = threading.Thread(target=watch, daemon=True)
    faultinject.set_schedule(FaultSchedule([kill]))
    watcher.start()
    try:
        out, errors, wall = server_requests(router.host, router.port,
                                            reqs, SERVER_CLIENTS)
        wait_for(lambda: "t" in removed, 30.0, "the corpse removed")
    finally:
        stop.set()
        watcher.join(5.0)
        faultinject.clear()
    rec = latency_record(out, errors, wall)
    rec.update(requests=len(reqs), kill_fired=kill.fired,
               failovers=fleet_counter("fleet_failovers_total") - failovers0,
               removal_s=removed["t"] - dead["t"],
               members_after=router.replicas(),
               captures={r.rank: r.server._batcher.stats()["compiles"]
                         - captures0[r.rank] for r in reps if r.alive},
               c2=fleet_c2(out, reqs, refs))
    return rec


def fleet_counter(name) -> float:
    m = get_registry().get(name)
    return 0.0 if m is None else m.value


def fleet_traced_failover(router, reps, paths, prompt_rng):
    """A failover under a trace, both engines warm: every member dies at
    its FLEET_KILL_TOKEN-th streamed token; the first replica the router
    picks does, the survivor streams the FLEET_TRACED_NEW - 2 tokens
    left and lives. Returns the trace's K4 launches and all its kernels:
    the victim's prefill, the survivor's re-prefill and the decode steps
    (the engine's prefill attends through ``attention_reference``, as the
    JAX engine's does, so a re-prefill launches no K4)."""
    V = SLICE["vocab_size"]
    for rep in reps:             # warm each engine straight, not routed
        cli = KerasClient(rep.host, rep.port)
        try:
            cli.generate(prompt_rng.integers(0, V, FLEET_PROMPT).tolist(),
                         FLEET_TRACED_NEW, model=paths["gpt"])
        finally:
            cli.close()
    prompt = prompt_rng.integers(0, V, FLEET_PROMPT).tolist()
    faultinject.set_schedule(FaultSchedule(
        [Fault("kill_replica", rank=r.rank, step=FLEET_KILL_TOKEN)
         for r in reps]))
    try:
        (partials, final), traced = traced_kernels(
            lambda: stream_generate(router.host, router.port, prompt,
                                    FLEET_TRACED_NEW, paths["gpt"]),
            ["flash_fwd_kernel"])
    finally:
        faultinject.clear()
    return prompt, partials, final, traced


def fleet_midstream(router, fdir, victim, paths, prompt):
    """Stage 2: the victim alone serves a streamed generate and dies at
    its FLEET_KILL_TOKEN-th token; a survivor spawned after the stream
    began joins behind the readyz gate and re-prefills from prompt +
    tokens so far. Returns (survivor, its admission record, partials,
    final answer)."""
    wait_for(lambda: router.replicas() == [victim.rank], 30.0,
             "the victim alone in the fleet")
    kill = Fault("kill_replica", rank=victim.rank, step=FLEET_KILL_TOKEN)
    resumes0 = fleet_counter("fleet_generate_resumes_total")
    res = {}

    def gen():
        try:
            res["out"] = stream_generate(router.host, router.port, prompt,
                                         FLEET_NEW, paths["gpt"])
        except Exception as e:  # noqa: BLE001 — gated below
            res["error"] = repr(e)

    faultinject.set_schedule(FaultSchedule([kill]))
    t = threading.Thread(target=gen, daemon=True)
    try:
        t.start()
        survivor, adm = spawn_admitted(router, fdir, 10, paths["gpt"])
        t.join(300.0)
    finally:
        faultinject.clear()
    check(not t.is_alive() and "out" in res,
          f"the mid-stream generate: {res}")
    partials, final = res["out"]
    return survivor, adm, partials, final, dict(
        kill_fired=kill.fired,
        resumes=fleet_counter("fleet_generate_resumes_total") - resumes0)


def fleet_rolling(router, fdir, olds, paths, pools):
    """Stage 3: replace every replica (admit the successor, then drain
    the predecessor) under continuous char-RNN load from
    FLEET_ROLL_LOADERS clients, one request in four bulk."""
    rng = np.random.default_rng(SEED + 63)
    files = pools["char_rnn"][0]
    stop = threading.Event()
    lock = threading.Lock()
    rts, failures = [], []

    def load(i):
        cli = KerasClient(router.host, router.port)
        k = 0
        try:
            while not stop.is_set():
                with lock:
                    f = files[int(rng.integers(0, len(files)))]
                t0 = time.perf_counter()
                try:
                    cli.request(op="predict", features=f,
                                model=paths["char_rnn"],
                                priority="bulk" if k % 4 == 3
                                else "interactive")
                except Exception as e:  # noqa: BLE001 — gated below
                    with lock:
                        failures.append(f"loader {i}: {e!r}")
                    return
                with lock:
                    rts.append((time.perf_counter() - t0) * 1e3)
                k += 1
        finally:
            cli.close()

    olds = list(olds)
    captures0 = {r.rank: r.server._batcher.stats()["compiles"]
                 for r in olds}
    f0 = fleet_counter("fleet_failovers_total")
    r0 = fleet_counter("fleet_retries_total")
    loaders = [threading.Thread(target=load, args=(i,), daemon=True)
               for i in range(FLEET_ROLL_LOADERS)]
    for t in loaders:
        t.start()
    news, admissions, drains = [], [], []
    try:
        time.sleep(0.5)
        for old in olds:
            new, adm = spawn_admitted(router, fdir, old.rank + 10,
                                      paths["gpt"])
            news.append(new)
            t0 = time.monotonic()
            emptied = old.drain(grace_s=15.0)
            wait_for(lambda: old.rank not in router.replicas(), 15.0,
                     f"drained replica {old.rank} removed")
            drains.append(dict(rank=old.rank, emptied=emptied,
                               drain_to_removal_s=time.monotonic() - t0,
                               captures_while_serving=old.server._batcher
                               .stats()["compiles"] - captures0[old.rank]))
            admissions.append(adm)
        time.sleep(0.5)
    finally:
        stop.set()
        for t in loaders:
            t.join(60.0)
    succ = {r.rank: r.server._batcher.stats() for r in news}
    rt = sorted(rts)
    return news, dict(
        requests=len(rts), failures=failures, admissions=admissions,
        drains=drains, members_after=router.replicas(),
        failovers=fleet_counter("fleet_failovers_total") - f0,
        reroutes=fleet_counter("fleet_retries_total") - r0,
        successor_captures={k: v["compiles"] for k, v in succ.items()},
        successor_capture_s={k: v["compile_s"] for k, v in succ.items()},
        round_trip_p50_ms=float(np.percentile(rt, 50)) if rt else None,
        round_trip_p99_ms=float(np.percentile(rt, 99)) if rt else None,
        round_trip_max_ms=rt[-1] if rt else None)


def fleet_autoscale(tmp, paths, pools):
    """Stage 4 on the char-RNN: an undersized router (max_concurrency
    2) over one replica, a FleetAutoscaler (max 3) and ``slow_replica``
    stalls on every rank it may spawn; the pool grows, sustained breach
    at the maximum flips brownout (bulk SHED on a live connection,
    interactive served on the same one), the storm ends and the fleet
    drains back to its floor; then a ``flap_replica`` rank is
    quarantined and released. Returns (router, seed replica, autoscaler,
    flapper, record) for the observability stage."""
    fdir = str(tmp / "fleet_auto")
    router = FleetRouter(fdir, poll_s=0.1, heartbeat_timeout_s=1.5,
                         max_concurrency=2, queue_depth=24,
                         max_queue_wait_s=10.0, metrics_port=0,
                         default_deadline_ms=60_000, flap_window_s=10.0,
                         flap_strikes=2, flap_quarantine_base_s=1.5,
                         flap_quarantine_max_s=6.0)
    rep0 = fleet_replica(fdir, 0, paths["char_rnn"])
    auto = FleetAutoscaler(
        router, lambda rank: fleet_replica(fdir, rank, paths["char_rnn"]),
        min_replicas=1, max_replicas=FLEET_REPLICAS, queue_high=2,
        up_ticks=2, down_ticks=4, up_cooldown_s=1.0, down_cooldown_s=1.0,
        tick_s=0.25, brownout=True, brownout_enter_ticks=6,
        brownout_exit_ticks=4, drain_grace_s=15.0)
    files = pools["char_rnn"][0]
    model = paths["char_rnn"]
    stop = threading.Event()
    lock = threading.Lock()
    failures, sheds, served = [], {"n": 0, "structured": True}, {"n": 0}
    rec = {}

    def interactive(i):
        cli = KerasClient(router.host, router.port)
        try:
            while not stop.is_set():
                try:
                    cli.predict(files[i % len(files)], model=model)
                except Exception as e:  # noqa: BLE001 — gated below
                    with lock:
                        failures.append(f"interactive {i}: {e!r}")
                    return
                with lock:
                    served["n"] += 1
        finally:
            cli.close()

    def bulk(i):
        try:
            with socket.create_connection((router.host, router.port),
                                          timeout=120) as s:
                f = s.makefile("rwb")
                while not stop.is_set():
                    f.write((json.dumps(
                        {"op": "predict", "features": files[i],
                         "model": model, "priority": "bulk"})
                        + "\n").encode())
                    f.flush()
                    line = f.readline()
                    if not line:
                        raise ConnectionError("hangup on a bulk request")
                    resp = json.loads(line)
                    if resp.get("error") == "SHED":
                        with lock:
                            sheds["n"] += 1
                            if resp.get("retry_after_ms") is None:
                                sheds["structured"] = False
                        time.sleep(0.05)
                    elif resp.get("error") not in (None, "DEADLINE"):
                        raise RuntimeError(str(resp))
                f.close()
        except Exception as e:  # noqa: BLE001 — gated below
            with lock:
                failures.append(f"bulk {i}: {e!r}")

    loaders = []
    try:
        wait_for(lambda: router.replicas() == [0], 60.0, "seed admitted")
        faultinject.set_schedule(FaultSchedule([
            Fault("slow_replica", rank=r, at_call=i, duration=FLEET_STALL_S)
            for r in range(FLEET_REPLICAS + 3) for i in range(1, 400)]))
        n_int, n_bulk = FLEET_LOADERS
        loaders = ([threading.Thread(target=interactive, args=(i,),
                                     daemon=True) for i in range(n_int)]
                   + [threading.Thread(target=bulk, args=(i,), daemon=True)
                      for i in range(n_bulk)])
        t0 = time.monotonic()
        for t in loaders:
            t.start()
        rec["scale_up_s"] = wait_for(
            lambda: len(router.replicas()) >= FLEET_REPLICAS, 90.0,
            "the autoscaler grew the pool to its maximum")
        rec["max_members"] = router.replicas()
        rec["brownout_s"] = wait_for(lambda: router.brownout, 60.0,
                                     "brownout at the maximum") \
            + rec["scale_up_s"]
        rz = router._readyz()
        rec["readyz_in_brownout"] = dict(ready=rz["ready"],
                                         brownout=rz["brownout"],
                                         reasons=rz["reasons"])
        # a bulk SHED and an interactive answer on ONE connection
        shed, ok = raw_exchange(router.host, router.port, [
            {"op": "predict", "features": files[0], "model": model,
             "priority": "bulk"},
            {"op": "predict", "features": files[0], "model": model,
             "priority": "interactive"}])
        rec["same_connection"] = dict(
            bulk_error=shed.get("error"),
            retry_after_ms=shed.get("retry_after_ms"),
            interactive_ok=bool(ok.get("ok")))
        time.sleep(2.0)                 # serve a while inside brownout
        faultinject.clear()
        stop.set()
        for t in loaders:
            t.join(120.0)
        rec["storm_s"] = time.monotonic() - t0
        rec["brownout_exit_s"] = wait_for(lambda: not router.brownout,
                                          60.0, "brownout exits")
        rec["scale_down_s"] = wait_for(lambda: router.replicas() == [0],
                                       90.0, "the pool drains to its floor")
        rec.update(failures=failures, served_interactive=served["n"],
                   sheds=sheds["n"], sheds_structured=sheds["structured"],
                   ups=fleet_counter("fleet_autoscale_up_total"),
                   downs=fleet_counter("fleet_autoscale_down_total"),
                   handles_after=sorted(auto.handles()))
        # the flap quarantine: rank 5 crash-loops twice, then is healthy
        faultinject.set_schedule(FaultSchedule([
            Fault("flap_replica", rank=5, count=2, duration=0.2)]))
        q0 = fleet_counter("fleet_quarantines_total")
        flapper = fleet_replica(fdir, 5, model)
        spawns = 1
        t_end = time.monotonic() + 60.0
        while (fleet_counter("fleet_quarantines_total") == q0
               and time.monotonic() < t_end):
            # the launcher restarts a dead incarnation once the router
            # dropped it: a successor that read the dead one's lease
            # world would start its kill clock before its own admission
            if not flapper.alive and 5 not in router.replicas():
                flapper = fleet_replica(fdir, 5, model)
                spawns += 1
            time.sleep(0.05)
        rec["quarantined"] = router.quarantined(5)
        if not flapper.alive:
            wait_for(lambda: 5 not in router.replicas(), 30.0,
                     "the dead incarnation dropped")
            flapper = fleet_replica(fdir, 5, model)
            spawns += 1
        rec["released_s"] = wait_for(lambda: 5 in router.replicas(), 60.0,
                                     "the healthy incarnation admitted")
        rec.update(flap_spawns=spawns, flapper_alive=flapper.alive,
                   quarantines=fleet_counter("fleet_quarantines_total") - q0)
        return router, rep0, auto, flapper, rec
    except BaseException:
        stop.set()
        faultinject.clear()
        for t in loaders:
            t.join(10.0)
        auto.drain(drain_owned=True)
        router.close()
        rep0.drain(grace_s=5.0)
        raise


def fleet_observability(router, tmp, paths, pools):
    """Stage 5: the router's /api/metrics and /readyz, and a
    StallWatchdog over ``keras_server`` while a ``hang_backend`` fault
    holds one dispatch."""
    base = f"http://{router.host}:{router.metrics_port}"
    with urllib.request.urlopen(f"{base}/api/metrics", timeout=30) as r:
        text = r.read().decode()
    with urllib.request.urlopen(f"{base}/api/metrics.json",
                                timeout=30) as r:
        as_json = json.loads(r.read())
    try:
        with urllib.request.urlopen(f"{base}/readyz", timeout=30) as r:
            readyz_status = r.status
    except urllib.error.HTTPError as e:  # a 503 is an answer too
        readyz_status = e.code
    names = {line.split("{")[0].split(" ")[0] for line in text.splitlines()
             if line and not line.startswith("#")}
    bundle_dir = tmp / "bundles"
    tracer = Tracer()
    prev_tracer = set_tracer(tracer)
    wd = StallWatchdog(str(bundle_dir), interval_s=0.05)
    try:
        wd.watch("keras_server", FLEET_WATCH_S)
        faultinject.set_schedule(FaultSchedule([
            Fault("hang_backend", at_call=1, duration=FLEET_HANG_S)]))
        cli = KerasClient(router.host, router.port)
        try:
            hung = cli.predict(pools["char_rnn"][0][0],
                               model=paths["char_rnn"])
        finally:
            cli.close()
        time.sleep(5 * 0.05)
    finally:
        faultinject.clear()
        wd.close()
        set_tracer(prev_tracer)
    bundles = sorted(bundle_dir.glob("*.json"))
    bundle = json.loads(bundles[0].read_text()) if bundles else {}
    return dict(metrics_missing=[n for n in FLEET_METRICS
                                 if n not in names],
                metrics_json_has_replicas="fleet_replicas" in as_json,
                readyz_status=readyz_status, bundles=len(bundles),
                bundle_format=bundle.get("format"),
                bundle_stale=(bundle.get("stale") or {}).get("subsystem"),
                culprit=bundle.get("culprit"),
                hung_request_answered=bool(len(hung)))


def serve_fleet():
    """The serving fleet on the card (ROADMAP A5.3): FleetReplica
    gateways of the full-width GPT and char-RNN, three at a time on the
    one card, behind a FleetRouter, over TCP. Stages: a replica killed
    under a predict storm; a traced failover and the router's hop; a
    mid-stream generate failover; a rolling drain-restart; autoscaling,
    brownout and the flap quarantine; metrics, readiness and a stall
    bundle. Returns the path's launch counts (captures; the replays are
    read from traces)."""
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    tmp = Path(tempfile.mkdtemp(prefix="dl4j_serve_fleet_"))
    reg = MetricsRegistry()
    prev_reg = set_registry(reg)
    base_threads = set(threading.enumerate())
    paths, pools, refs, rows = {}, {}, {}, {}
    live, routers, rec = [], [], {}
    auto_parts = None
    try:
        rng = np.random.default_rng(SEED + 59)
        for name, net, row, onehot, _, _ in server_models(("char_rnn",
                                                           "gpt")):
            paths[name] = str(tmp / f"{name}.zip")
            ModelSerializer.write_model(net, paths[name], save_updater=False)
            rows[name] = row
            rws = [int(r) for r in rng.choice(SERVER_ROWS, SERVER_FILES)]
            files = []
            for j, r in enumerate(rws):
                files.append(str(tmp / f"{name}_{j}.npy"))
                np.save(files[-1], server_features(rng, row, onehot, r))
            ladder = []
            for b in SERVER_LADDER:
                ladder.append(str(tmp / f"{name}_ladder_{b}.npy"))
                np.save(ladder[-1], server_features(rng, row, onehot, b))
            pools[name] = (files, rws, ladder)
            del net
        torch.cuda.empty_cache()
        reset_counts()
        ev0 = fleet_counter("serving_compile_cache_evictions_total")
        fdir = str(tmp / "fleet")
        router = FleetRouter(fdir, poll_s=0.1, heartbeat_timeout_s=1.5,
                             max_concurrency=SERVER_CLIENTS,
                             queue_depth=4 * SERVER_CLIENTS,
                             empty_pool_wait_s=60.0, metrics_port=0,
                             default_deadline_ms=300_000)
        routers.append(router)
        spawned = []
        for r in range(FLEET_REPLICAS):
            rep, adm = spawn_admitted(router, fdir, r, paths["gpt"])
            live.append(rep)
            spawned.append(adm)
        t0 = time.perf_counter()
        for rep in live:
            # one at a time (their captures would take turns on
            # CAPTURE_LOCK anyway); the char-RNN first: its load must not
            # prewarm on the GPT's bucket mix
            warm_ladder(rep, paths, {k: v[2] for k, v in pools.items()},
                        ("char_rnn", "gpt"))
        warm = dict(seconds=time.perf_counter() - t0,
                    captures={r.rank: r.server._batcher.stats()["compiles"]
                              for r in live},
                    capture_s={r.rank: r.server._batcher.stats()["compile_s"]
                               for r in live},
                    memory=fleet_memory(live))
        for name in paths:
            net = ModelSerializer.restore_model(paths[name])
            refs.update(uncounted(lambda: {
                f: net.output(np.load(f)).float().cpu().numpy()
                for f in pools[name][0]}))
            if name == "gpt":
                gpt_ref = net
            del net
        rec["spawn"] = spawned
        rec["warm"] = warm

        # ---- 1. a replica killed under a predict storm --------------
        rec["kill"] = fleet_kill_storm(router, live, paths, pools, refs)
        emit(dict(phase="serve_fleet", stage="kill", **rec["kill"]))
        live = [r for r in live if r.alive]

        # ---- 6. kernels through the router; the router's hop ---------
        rec["traced"] = traced_waves(router, live, paths, pools, rows)
        rec["hop"] = router_hop(router, live[0], paths, pools)
        prng = np.random.default_rng(SEED + 64)
        prompt, partials, final, traced = fleet_traced_failover(
            router, live, paths, prng)
        rec["traced_failover"] = dict(
            prompt_len=len(prompt), new=FLEET_TRACED_NEW,
            tokens=final.get("tokens"), partials=partials,
            failovers=final.get("failovers"),
            k4_launches=traced["flash_fwd_kernel"],
            kernels_traced=traced["all"],
            tokens_equal_singleton=(
                final.get("tokens") == partials == uncounted(
                    greedy_generate, gpt_ref, prompt, FLEET_TRACED_NEW)))
        emit(dict(phase="serve_fleet", stage="traced",
                  traced=rec["traced"], hop=rec["hop"],
                  traced_failover=rec["traced_failover"]))
        live = [r for r in live if r.alive]

        # ---- 2. mid-stream generate failover on the GPT --------------
        prompt = prng.integers(0, SLICE["vocab_size"],
                               FLEET_PROMPT).tolist()
        ref = uncounted(greedy_generate, gpt_ref, prompt, FLEET_NEW)
        survivor, adm, partials, final, mid = fleet_midstream(
            router, fdir, live[0], paths, prompt)
        live = [r for r in live if r.alive] + [survivor]
        rec["midstream"] = dict(
            prompt_len=FLEET_PROMPT, new=FLEET_NEW, survivor=adm,
            ok=bool(final.get("ok")), tokens=final.get("tokens"),
            partials=partials, reference=ref,
            failovers=final.get("failovers"),
            tokens_equal_singleton=final.get("tokens") == partials == ref,
            **mid)
        emit(dict(phase="serve_fleet", stage="midstream",
                  **rec["midstream"]))

        # ---- 3. a rolling drain-restart under load -------------------
        for r in range(1, FLEET_REPLICAS):
            rep, adm = spawn_admitted(router, fdir, 10 + r, paths["gpt"])
            live.append(rep)
        for rep in live:
            warm_ladder(rep, paths, {k: v[2] for k, v in pools.items()},
                        ("char_rnn",))
        news, rec["rolling"] = fleet_rolling(router, fdir, live, paths,
                                             pools)
        live = news
        rec["rolling"]["memory"] = fleet_memory(live)
        emit(dict(phase="serve_fleet", stage="rolling", **rec["rolling"]))

        # ---- 4. autoscale, brownout and the flap quarantine ----------
        auto_parts = fleet_autoscale(tmp, paths, pools)
        router4, rep0, auto, flapper, rec["autoscale"] = auto_parts
        emit(dict(phase="serve_fleet", stage="autoscale",
                  **rec["autoscale"]))

        # ---- 5. observability ----------------------------------------
        rec["observability"] = fleet_observability(router4, tmp, paths,
                                                   pools)
        rec["memory_end"] = fleet_memory(live + [rep0])
        rec["evictions"] = (fleet_counter(
            "serving_compile_cache_evictions_total") - ev0)
        rec["counters"] = {n: fleet_counter(n) for n in (
            "fleet_dispatches_total", "fleet_failovers_total",
            "fleet_retries_total", "fleet_hedges_total",
            "fleet_hedge_wins_total", "fleet_admissions_total",
            "fleet_removals_total", "fleet_generate_resumes_total")}
        launched = counts()
    finally:
        faultinject.clear()
        if auto_parts is not None:
            router4, rep0, auto, flapper, _ = auto_parts
            auto.drain(drain_owned=True)
            router4.close()
            flapper.drain(grace_s=5.0)
            rep0.drain(grace_s=5.0)
        for router in routers:
            router.close()
        for rep in live:
            rep.drain(grace_s=10.0)
        set_registry(prev_reg)
        t_end = time.monotonic() + 20.0
        while (set(threading.enumerate()) - base_threads
               and time.monotonic() < t_end):
            time.sleep(0.05)
        leaked = sorted(t.name for t in
                        set(threading.enumerate()) - base_threads)
        shutil.rmtree(tmp, ignore_errors=True)
    rec["leaked_threads"] = leaked
    rec["launches"] = launched
    rec["peak_memory_allocated"] = torch.cuda.max_memory_allocated()
    rec["phase_s"] = time.perf_counter() - t_phase
    emit(dict(phase="serve_fleet", stage="summary",
              **{k: rec[k] for k in ("spawn", "warm", "memory_end",
                                     "evictions", "counters",
                                     "observability", "leaked_threads",
                                     "launches", "peak_memory_allocated",
                                     "phase_s")}))

    kill = rec["kill"]
    check(kill["kill_fired"] and not kill["errors"]
          and kill["served"] == kill["requests"] and kill["failovers"] > 0,
          f"kill under load: {kill['errors']}, fired {kill['kill_fired']}, "
          f"failovers {kill['failovers']}")
    check(kill["removal_s"] < 15.0 and 0 not in kill["members_after"],
          f"the corpse left the fleet in {kill['removal_s']} s")
    for model, c2 in kill["c2"].items():
        check(c2["argmax_equal"] and c2["max_abs_prob_diff"] <= TOL_C2,
              f"fleet answers against singletons past C2: {model} {c2}")
    check(not any(kill["captures"].values()),
          f"the storm captured {kill['captures']}")
    for name, t in rec["traced"].items():
        check(t["batches"] > 0 and t["traced"] == t["per_batch"]
              * t["batches"], f"traced {name} wave through the router: {t}")
    tf = rec["traced_failover"]
    check(tf["tokens_equal_singleton"] and (tf["failovers"] or 0) >= 1,
          f"the traced failover's tokens: {tf}")
    check(tf["kernels_traced"] > 0 and tf["k4_launches"] == 0,
          f"the traced failover's kernels: {tf} (a prefill attends "
          f"through attention_reference: no K4)")
    mid = rec["midstream"]
    check(mid["ok"] and mid["kill_fired"] and mid["resumes"] >= 1
          and (mid["failovers"] or 0) >= 1,
          f"mid-stream failover: {mid}")
    check(mid["tokens_equal_singleton"],
          f"mid-stream failover tokens differ from the singleton "
          f"greedy_generate on the card (ROADMAP C2): {mid}")
    roll = rec["rolling"]
    check(not roll["failures"] and roll["requests"] > 0
          and all(d["emptied"] for d in roll["drains"])
          and roll["members_after"] == sorted(r.rank for r in live),
          f"rolling restart: {roll['failures']}, {roll['drains']}")
    check(not any(d["captures_while_serving"] for d in roll["drains"]),
          f"a survivor captured during the roll: {roll['drains']}")
    au = rec["autoscale"]
    check(not au["failures"] and au["ups"] >= 2 and au["downs"] >= 2
          and au["handles_after"] == [],
          f"autoscale: failures {au['failures'][:3]}, ups {au['ups']}, "
          f"downs {au['downs']}, owned {au['handles_after']}")
    check(au["readyz_in_brownout"]["brownout"]
          and au["readyz_in_brownout"]["ready"]
          and au["sheds"] > 0 and au["sheds_structured"]
          and au["same_connection"]["bulk_error"] == "SHED"
          and au["same_connection"]["retry_after_ms"] is not None
          and au["same_connection"]["interactive_ok"],
          f"brownout: {au}")
    check(au["quarantined"] and au["quarantines"] >= 1
          and au["flapper_alive"], f"flap quarantine: {au}")
    ob = rec["observability"]
    check(not ob["metrics_missing"] and ob["metrics_json_has_replicas"]
          and ob["readyz_status"] == 200,
          f"the router's metrics and readyz: {ob}")
    check(ob["bundles"] == 1 and ob["bundle_format"] == BUNDLE_FORMAT
          and ob["bundle_stale"] == "keras_server"
          and (ob["culprit"] or {}).get("span") == "serve:predict",
          f"the stall watchdog's bundle: {ob}")
    mem = rec["memory_end"]
    check(rec["evictions"] == 0,
          f"the compile cache evicted {rec['evictions']} graphs: {mem}")
    check(mem["pool_bytes_sum"] <= mem["memory_reserved"]
          and mem["cache"]["bytes"] <= mem["memory_reserved"],
          f"the graph pools' bytes past what the card reserved: {mem}")
    check(not leaked, f"threads leaked past the fleet's teardown: {leaked}")
    check(launched["lstm_fwd_infer"] > 0 and launched["flash_attn_fwd"] > 0,
          f"the fleet's path launched {launched}")
    return dict(launched=launched, traced=rec["traced"],
                reprefill_k4=tf["k4_launches"])


# ---------------------------------------------------------------------------
# 15. the data-parallel trainers (ROADMAP A6.1)
# ---------------------------------------------------------------------------

#: the train_parallel phase: 3 synchronized steps of [32, 256] per mode;
#: world 2 runs as two processes on this one card over gloo with CUDA
#: tensors (NCCL refuses two ranks on one device)
PAR_STEPS, PAR_WORLD = 3, 2
#: gradient accumulation 4 against the plain step (SGD twins, as
#: tests/test_parallel.py:58-80), and the world-1 restore's next step
#: against the world-2 run's: rtol / atol on every param
TOL_PAR_RTOL, TOL_PAR_ATOL = 2e-4, 2e-5
#: ParallelWrapper against hand-run workers averaged, times max(1, |p|)
TOL_WRAPPER = 1e-5
#: the kernels a step of the parallel trainers launches, by symbol
PAR_KERNELS = ATTENTION_KERNELS + ("lstm_fwd_train_kernel",
                                   "lstm_bwd_kernel")
#: the fault-tolerant runs: batches of the GPT, a checkpoint every 2 steps
FT_BATCHES, FT_EVERY = 4, 2
#: the elastic case (ROADMAP A6.3): the GPT under zero1 on two gloo ranks,
#: kill_host on rank 1 at step ELASTIC_KILL of ELASTIC_STEPS, a checkpoint
#: every ELASTIC_EVERY steps, a heartbeat stale after ELASTIC_HB_S
ELASTIC_STEPS, ELASTIC_KILL, ELASTIC_EVERY, ELASTIC_HB_S = 5, 3, 2, 2.0
#: the world-2 group's model- and sp-axis modes (ROADMAP A6.2a), after
#: off / zero1 / zero2: PAR_STEPS steps of [PAR_MESH_BATCH, 256] each on
#: the full-width GPT (rows cut from TRAIN_BATCH's 32 so that each rank
#: also runs the world-1 plain reference; widths and T as SLICE), held
#: to the plain steps at loss rtol TOL_MESH_LOSS and TOL_PAR_* params
PAR_MESH_BATCH = 8
PAR_MESH_MODES = {"tp": dict(n_data=1, n_model=2),
                  "sp": dict(n_data=1, n_seq=2)}
TOL_MESH_LOSS = 1e-5
#: Adam's first update of an element is lr * sign(g) (bias-corrected m /
#: sqrt(v)): an element whose gradient sums to rounding noise takes the
#: sign its summation order gives it, and a model- or sp-axis step sums
#: in another order (ROADMAP C23). So the Adam path's params may hold up
#: to PAR_MESH_FLIPS elements (of 25.4M) outside TOL_PAR_* of the plain
#: steps, each by at most 2 lr a step; its SGD twins, whose update is
#: linear in g, are held to TOL_PAR_* on every element
PAR_MESH_FLIPS = 64
#: the SGD twins' learning rate (3e-4 diverges by the third step)
PAR_MESH_SGD_LR = 1e-4
#: the world-2 group's pipeline modes (ROADMAP A6.2b), after tp / sp:
#: GraphPipelineTrainer on the full-width GPT over 2 stages at M
#: microbatches, PAR_STEPS steps of [PAR_MESH_BATCH, 256], held to the
#: plain steps at the tp / sp modes' gates
PP_GPT_MODES = {"pp_gpt_m1": 1, "pp_gpt_m4": 4}
#: the attention layers a GPT stage holds (8 blocks over 2 stages)
PP_STAGE_LAYERS = SLICE["n_layers"] // 2
#: PipelineTrainer on the char-RNN: stages [[0], [1]], PP_RNN_M
#: microbatches of one LSTM_TRAIN_BATCH batch (4 tBPTT windows of 50);
#: its first window's LSTM gradients against the plain window's, and
#: its SGD twin's learning rate
PP_RNN_M, TOL_PP_RNN_GRAD, PP_RNN_SGD_LR = 2, 2e-4, 0.1
#: the MoE FFN at the GPT's widths: EP_TOKENS tokens of d_model, EP_EXPERTS
#: experts of hidden EP_HIDDEN; world 1 on the card against the CPU, and
#: the experts split over the two ranks' 'ep' axis against world 1
EP_TOKENS, EP_EXPERTS, EP_HIDDEN, TOL_EP = 8192, 8, 2048, 1e-5
#: the MoE MLP over the world-2 group's data axis (ROADMAP A6.2c), after
#: ep: Dense(512, relu) -> MoELayer(EP_EXPERTS experts of EP_HIDDEN,
#: capacity factor 1.0, aux weight 1e-2) -> Output(96, softmax) on
#: feed_forward(512), f32 (17.1M params, the experts at the ep mode's
#: widths). MOE_DP_STEPS steps of MOE_DP_BATCH global rows (half a rank)
#: through ParallelTrainer at dp = 2 in each of MOE_DP_MODES, held to each
#: rank's plain world-1 fit_batch of the global batch at the tp / sp
#: modes' gates, with an SGD twin at MOE_DP_SGD_LR
MOE_DP_BATCH, MOE_DP_STEPS, MOE_DP_CLASSES = 8192, 3, 96
MOE_DP_MODES = ("off", "zero1")
MOE_DP_LR, MOE_DP_SGD_LR = 1e-3, 0.05
#: The Adam path's gate names the elements it lets past TOL_PAR_*
#: (moe_crossing_gate): a rounding-level difference between the mesh
#: step and the plain one can put a ReLU pre-activation on the other
#: side of 0 for a token both keep; that unit's gradient then differs by
#: the token's share, which Adam's scale-free update turns into up to lr
#: a step. So every W1 / b1 / W2 element outside lies in a crossed
#: expert unit's column, entry or row, the other leaves hold at most
#: PAR_MESH_FLIPS (C23), and a run with no crossing holds every element


def text_batches(n, B, T, seed):
    """``n`` one-hot [B, T] batches of the synthetic text."""
    text = synthetic_char_text(n * B * (T + 1) + 1, seed=seed)
    out = char_lm_batches(text, T, B, charset=CHARSET)[:n]
    check(len(out) == n, f"{len(out)} text batches of {B} x {T}")
    return out


#: each seed's initial GPT params, drawn once a process (the host draw
#: of 25.4M params takes seconds; the copies are the same tensors)
_PAR_GPT_PARAMS: dict = {}


def par_gpt(**kw):
    """The full-width GPT on the card (``kw``: gpt_decoder's options),
    its params the config seed's draw, taken once a process."""
    conf = gpt_decoder(**SLICE, **kw)
    seed = conf.training.seed
    if seed not in _PAR_GPT_PARAMS:
        net = ComputationGraph(conf, device="cuda").init()
        _PAR_GPT_PARAMS[seed] = {k: {n: t.cpu() for n, t in v.items()}
                                 for k, v in net.params.items()}
        return net
    return ComputationGraph(conf, device="cuda").init(_PAR_GPT_PARAMS[seed])


def par_char_rnn():
    return MultiLayerNetwork(char_rnn_lstm(**LSTM_SLICE),
                             device="cuda").init()


def params_equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a.params),
                                                 tree_leaves(b.params)))


def params_close(a, b, rtol, atol):
    """Whether every param of ``a`` lies within atol + rtol |b| of ``b``'s,
    and the largest |a - b|."""
    ok, worst = True, 0.0
    for x, y in zip(tree_leaves(a.params), tree_leaves(b.params)):
        d = (x - y).abs()
        ok = ok and bool((d <= atol + rtol * y.abs()).all())
        worst = max(worst, float(d.max()))
    return ok, worst


def peak_excess_bytes(fn) -> int:
    """The most bytes allocated on the card while ``fn`` runs, above what
    was allocated before it."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


def moment_bytes(net) -> int:
    return sum(t.numel() * t.element_size() for k, v in
               net.opt_state.items() if k != "count" for t in tree_leaves(v))


def par_world1(mesh):
    """World 1 over NCCL in this process: ParallelTrainer on the GPT
    against the plain fit_batch, accumulation 4 (and its peak memory
    against one microbatch's step), DelayedSyncTrainer (k=1), the
    char-RNN's tBPTT through ParallelTrainer, DelayedSyncTrainer (k=1)
    and ParallelWrapper(workers=2, averaging_frequency=2) against
    hand-run workers, launches per step from traces, ms a step in
    turns."""
    from deeplearning4j_tpu_torch.parallel import (
        DelayedSyncTrainer, ParallelTrainer, ParallelWrapper,
    )
    from deeplearning4j_tpu_torch.parallel.mesh import take_rows
    rec = dict(backend=mesh.backend, world=mesh.world)
    batches = text_batches(PAR_STEPS, TRAIN_BATCH, SLICE["seq_len"], SEED)
    plain, par = par_gpt(), par_gpt()
    tp = ParallelTrainer(par, mesh)
    rec["losses"] = [float(tp.fit_batch(b)) for b in batches]
    rec["losses_plain"] = uncounted(
        lambda: [float(plain.fit_batch(b)) for b in batches])
    rec["gpt_bitwise_plain"] = (rec["losses"] == rec["losses_plain"]
                                and params_equal(par, plain))
    dly = par_gpt()
    td = DelayedSyncTrainer(dly, mesh, sync_frequency=1)
    rec["delayed_losses"] = [float(td.fit_batch(b)) for b in batches]
    rec["delayed_k1_bitwise"] = (rec["delayed_losses"] == rec["losses"]
                                 and params_equal(dly, par))
    del dly, td
    sgd_plain = par_gpt(updater="sgd", learning_rate=0.1)
    sgd_acc = par_gpt(updater="sgd", learning_rate=0.1)
    uncounted(sgd_plain.fit_batch, batches[0])
    t4 = ParallelTrainer(sgd_acc, mesh, gradient_accumulation=4)
    t4.fit_batch(batches[0])
    rec["accum4_within_gate"], rec["accum4_max_abs_diff"] = params_close(
        sgd_acc, sgd_plain, TOL_PAR_RTOL, TOL_PAR_ATOL)
    # peak memory: accumulation 4 holds one accumulator beside what one
    # step on its [8, 256] microbatch holds, never the 4 gradient trees
    quarter = take_rows(batches[0], slice(0, TRAIN_BATCH // 4))
    t1 = ParallelTrainer(sgd_acc, mesh)
    rec["gradient_bytes"] = sum(t.numel() * t.element_size()
                                for t in tree_leaves(sgd_acc.params))
    rec["accum4_peak_excess_bytes"] = peak_excess_bytes(
        lambda: t4.fit_batch(batches[1]))
    rec["quarter_step_peak_excess_bytes"] = peak_excess_bytes(
        lambda: t1.fit_batch(quarter))
    del sgd_plain, sgd_acc, t4, t1
    _, rec["gpt_step_trace"] = traced_kernels(
        lambda: tp.fit_batch(batches[0]), PAR_KERNELS)
    rec["ms_per_step_in_turns"] = [dict(
        plain=uncounted(host_ms, lambda: plain.fit_batch(batches[1]), 3, 1),
        parallel=host_ms(lambda: tp.fit_batch(batches[1]), 3, 1))
        for _ in range(3)]
    del plain, par, tp

    Bt, Tt = LSTM_TRAIN_BATCH
    lbatches = text_batches(2, Bt, Tt, SEED + 1)
    rnn_plain, rnn_par = par_char_rnn(), par_char_rnn()
    trnn = ParallelTrainer(rnn_par, mesh)
    rnn_losses = [float(trnn.fit_batch(b)) for b in lbatches]
    rnn_plain_losses = uncounted(
        lambda: [float(rnn_plain.fit_batch(b)) for b in lbatches])
    rec["char_rnn_tbptt_bitwise_plain"] = (
        rnn_losses == rnn_plain_losses and params_equal(rnn_par, rnn_plain))
    _, rec["char_rnn_step_trace"] = traced_kernels(
        lambda: trnn.fit_batch(lbatches[0]), PAR_KERNELS)
    rnn_dly, rnn_twin = par_char_rnn(), par_char_rnn()
    td, tt = (DelayedSyncTrainer(rnn_dly, mesh, sync_frequency=1),
              ParallelTrainer(rnn_twin, mesh))
    rec["char_rnn_delayed_k1_bitwise"] = (
        [float(td.fit_batch(b)) for b in lbatches]
        == [float(tt.fit_batch(b)) for b in lbatches]
        and params_equal(rnn_dly, rnn_twin))
    del rnn_dly, rnn_twin, td, tt

    wrapped = par_char_rnn()
    manual = [par_char_rnn() for _ in range(2)]
    pw = ParallelWrapper(wrapped, workers=2, averaging_frequency=2,
                         mesh=mesh)
    for b in lbatches:
        pw.fit_batch(b)
        uncounted(lambda: [m.fit_batch(h) for m, h in
                           zip(manual, b.batch_by(Bt // 2))])
    worst, scale = 0.0, 1.0
    for got, m0, m1 in zip(tree_leaves(wrapped.params),
                           tree_leaves(manual[0].params),
                           tree_leaves(manual[1].params)):
        want = (m0 + m1) / 2
        worst = max(worst, float((got - want).abs().max()))
        scale = max(scale, float(want.abs().max()))
    rec["wrapper_max_abs_diff"] = worst
    rec["wrapper_within_gate"] = worst <= TOL_WRAPPER * scale
    rec["wrapper_replicas_equal"] = params_equal(pw.replica(0),
                                                 pw.replica(1))
    _, rec["wrapper_fit_batch_trace"] = traced_kernels(
        lambda: pw.fit_batch(lbatches[0]), PAR_KERNELS)
    return rec


def par_fault_tolerant(mesh, tmp):
    """FaultTolerantTrainer over ParallelTrainer on the GPT, sharded
    checkpoints every FT_EVERY steps: a ``raise`` fault retried; a run cut
    before its 4th step resumed by a fresh net from the cursor, bit for
    bit the uninterrupted run; a NaN batch under a rollback sentinel
    rolled back to the last checkpoint. Checkpoint write and restore
    seconds."""
    from deeplearning4j_tpu_torch.parallel import ParallelTrainer
    from deeplearning4j_tpu_torch.resilience import (
        CheckpointManager, FaultInjected, FaultTolerantTrainer,
    )
    batches = text_batches(FT_BATCHES, TRAIN_BATCH, SLICE["seq_len"],
                           SEED + 2)
    prev = set_registry(MetricsRegistry())

    def run(name, net=None, max_retries=3, sentinel=None):
        net = net or par_gpt()
        mgr = CheckpointManager(tmp / name, sharded=True, mesh_ctx=mesh,
                                keep_last=2)
        FaultTolerantTrainer(net, mgr, trainer=ParallelTrainer(net, mesh),
                             checkpoint_every=FT_EVERY, sentinel=sentinel,
                             max_retries=max_retries, backoff_base=0.001,
                             backoff_max=0.01).fit(batches, epochs=1)
        return net, mgr

    rec = {}
    try:
        faultinject.set_schedule(FaultSchedule([Fault("raise", step=2)]))
        whole, mgr = run("whole")
        faultinject.clear()
        rec["retries"] = get_registry().snapshot("resilience_")[
            "resilience_retries_total"]
        faultinject.set_schedule(FaultSchedule([Fault("raise", step=4)]))
        try:
            run("cut", max_retries=0)
            rec["cut_raised"] = False
        except FaultInjected:
            rec["cut_raised"] = True
        faultinject.clear()
        resumed, _ = run("cut", net=par_gpt(seed=7))
        rec["resumed_iterations"] = resumed.iteration_count
        rec["resumed_bitwise"] = params_equal(resumed, whole)
        del resumed
        faultinject.set_schedule(FaultSchedule([Fault("nan", step=3)]))
        rolled, _ = run("nan", sentinel=DivergenceSentinel("rollback",
                                                           lag=0))
        faultinject.clear()
        rec["rollbacks"] = get_registry().snapshot("resilience_")[
            "resilience_rollbacks_total"]
        rec["rolled_finite"] = all(bool(torch.isfinite(t).all())
                                   for t in tree_leaves(rolled.params))
        rec["rolled_iterations"] = rolled.iteration_count
        del rolled
        t0 = time.perf_counter()
        path = mgr.save(whole, step=99)
        rec["checkpoint_write_s"] = time.perf_counter() - t0
        rec["checkpoint_bytes"] = sum(f.stat().st_size
                                      for f in path.iterdir())
        fresh = par_gpt(seed=7)
        t0 = time.perf_counter()
        mgr.restore(fresh, mgr.latest_valid())
        torch.cuda.synchronize()
        rec["checkpoint_restore_s"] = time.perf_counter() - t0
        rec["restore_bitwise"] = params_equal(fresh, whole)
    finally:
        faultinject.clear()
        set_registry(prev)
    return rec


def param_bytes(net) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(net.params))


def par_mesh_collective_ms(mesh, mode) -> dict:
    """ms of each model- or sp-axis collective a step of ``mode`` issues,
    alone, 3 times each, at the GPT's activation sizes (fp32, [8, 256,
    d]): the model axis' gather of a [.., 256] column shard to 512 and
    of a [.., 1024] one to 2048 (the MLP's), and the all-reduce of a
    512-wide gradient (``copy_to_model``'s backward); the sp ring's shift
    of one layer's stacked K/V shard ([2, 8, 8, 128, 64])."""
    B, T, D = PAR_MESH_BATCH, SLICE["seq_len"], SLICE["d_model"]

    def ms(fn):
        out = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
        return out
    with torch.no_grad():
        if mode == "tp":
            half = torch.zeros(B, T, D // 2, device="cuda")
            ff = torch.zeros(B, T, 2 * D, device="cuda")
            whole = torch.zeros(B, T, D, device="cuda")
            return dict(
                gather_512_bytes=whole.numel() * 4,
                gather_512=ms(lambda: mesh.gather_model(half)),
                gather_2048=ms(lambda: mesh.gather_model(ff)),
                all_reduce_512=ms(lambda: mesh.all_reduce_(whole,
                                                           axis="model")))
        H = SLICE["n_heads"]
        kv = torch.zeros(2, B, H, T // 2, D // H, device="cuda")
        return dict(shift_bytes=kv.numel() * 4,
                    ring_shift=ms(lambda: mesh.ring_shift(kv)))


def par_mesh_mode(mode, batches, plain) -> dict:
    """One rank's run of ``mode`` (PAR_MESH_MODES): a ParallelTrainer on
    that mesh over the world-2 group, PAR_STEPS steps of the full-width
    GPT. The losses and (after ``gather_params``) the params against
    ``plain["adam"]`` (the world-1 plain steps' losses and net), and an
    uncounted SGD twin's against ``plain["sgd"]``; the kernel
    wrappers' launches over the run and, in a traced_window of step 2,
    the attention kernels by symbol; the head count of every q the
    layers handed K4; the sp ring's shifts; the param and moment bytes
    this rank holds against world 1's; ms a step (step 2, the traced
    one, left out) and the collectives' ms alone."""
    from deeplearning4j_tpu_torch.nn.layers import attention as attn_mod
    from deeplearning4j_tpu_torch.parallel import (
        MeshContext, ParallelTrainer,
    )
    mesh = MeshContext.create(**PAR_MESH_MODES[mode])
    net = par_gpt()
    whole_p, whole_m = param_bytes(net), moment_bytes(net)
    tr = ParallelTrainer(net, mesh)
    heads, shifts = [], [0]
    flash, shift = attn_mod.flash_attention, MeshContext.ring_shift

    def flash_heads(q, *a, **kw):
        heads.append(int(q.shape[1]))
        return flash(q, *a, **kw)

    def counted_shift(self, t):
        shifts[0] += 1
        return shift(self, t)
    attn_mod.flash_attention = flash_heads
    MeshContext.ring_shift = counted_shift
    losses, ms, traced = [], [], None
    reset_counts()
    try:
        for i, b in enumerate(batches):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if i == 1:
                loss, traced = traced_kernels(lambda: tr.fit_batch(b),
                                              ATTENTION_KERNELS)
            else:
                loss = tr.fit_batch(b)
            losses.append(float(loss))
            torch.cuda.synchronize()
            if i != 1:
                ms.append((time.perf_counter() - t0) * 1e3)
    finally:
        attn_mod.flash_attention = flash
        MeshContext.ring_shift = shift
    launches = counts()
    rank_p, rank_m = param_bytes(net), moment_bytes(net)
    coll = par_mesh_collective_ms(mesh, mode)
    tr.gather_params()
    flat = torch.cat([p.reshape(-1) for p in
                      tree_leaves(net.params)]).cpu().numpy()
    rec = dict(layout=list(mesh.coords),
               **mesh_parity(losses, net, *plain["adam"]),
               params_sha256=hashlib.sha256(flat.tobytes()).hexdigest(),
               launches=launches, traced_step=traced,
               q_heads=sorted(set(heads)), k4_calls=len(heads),
               ring_shifts_forward=shifts[0],
               param_bytes_rank=rank_p, param_bytes_world1=whole_p,
               moment_bytes_rank=rank_m, moment_bytes_world1=whole_m,
               ms_per_step=ms, collective_ms=coll)
    del tr, net

    def sgd_twin():
        twin = par_gpt(updater="sgd", learning_rate=PAR_MESH_SGD_LR)
        tr = ParallelTrainer(twin, mesh)
        losses = [float(tr.fit_batch(b)) for b in batches]
        tr.gather_params()
        return mesh_parity(losses, twin, *plain["sgd"])
    rec["sgd"] = uncounted(sgd_twin)
    return rec


def mesh_parity(losses, net, plain_losses, plain_net) -> dict:
    """A mesh run's losses and (gathered) params against the plain
    steps': the largest relative loss gap, the elements outside TOL_PAR_*
    and the largest |diff|."""
    outside, worst = 0, 0.0
    for x, y in zip(tree_leaves(net.params), tree_leaves(plain_net.params)):
        d = (x - y).abs()
        outside += int((d > TOL_PAR_ATOL + TOL_PAR_RTOL * y.abs()).sum())
        worst = max(worst, float(d.max()))
    return dict(losses=losses, plain_losses=plain_losses,
                loss_max_rel=max(abs(a - b) / abs(b) for a, b in
                                 zip(losses, plain_losses)),
                params_outside_gate=outside, params_max_abs_diff=worst)


def par_pp_gpt(M, batches, plain) -> dict:
    """One rank's run of a pipeline mode (PP_GPT_MODES): a
    GraphPipelineTrainer over the world-2 group's 'pp' axis, PAR_STEPS
    steps of the full-width GPT at M microbatches (embedding and blocks
    0-3 on stage 0, blocks 4-7, ln_f and the tied head on stage 1). The
    losses and (after ``gather_params``) the params against
    ``plain["adam"]``, an uncounted SGD twin's against ``plain["sgd"]``;
    the kernel wrappers' launches and, in a traced_window of step 2, the
    attention kernels by symbol; the sends a step and their bytes; the
    param and moment bytes this rank holds against world 1's; ms a
    step (step 2, the traced one, left out)."""
    from deeplearning4j_tpu_torch.parallel import MeshContext
    from deeplearning4j_tpu_torch.parallel.pipeline import (
        GraphPipelineTrainer,
    )
    mesh = MeshContext.create(n_pipe=2)
    net = par_gpt()
    whole_p, whole_m = param_bytes(net), moment_bytes(net)
    tr = GraphPipelineTrainer(net, mesh, n_microbatches=M)
    rank_p, rank_m = param_bytes(net), moment_bytes(net)
    sent, post = [], MeshContext._post

    def counted_post(self, t, peer, tag):
        sent.append(t.numel() * t.element_size())
        return post(self, t, peer, tag)
    MeshContext._post = counted_post
    losses, ms, traced = [], [], None
    reset_counts()
    try:
        for i, b in enumerate(batches):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if i == 1:
                loss, traced = traced_kernels(lambda: tr.fit_batch(b),
                                              ATTENTION_KERNELS)
            else:
                loss = tr.fit_batch(b)
            losses.append(float(loss))
            torch.cuda.synchronize()
            if i != 1:
                ms.append((time.perf_counter() - t0) * 1e3)
    finally:
        MeshContext._post = post
    launches = counts()
    stages = [len(st) for st in tr.stages]
    tr.gather_params()
    flat = torch.cat([p.reshape(-1) for p in
                      tree_leaves(net.params)]).cpu().numpy()
    rec = dict(stage=mesh.pipe_index, stage_nodes=stages,
               boundary=tr.boundaries[1],
               **mesh_parity(losses, net, *plain["adam"]),
               params_sha256=hashlib.sha256(flat.tobytes()).hexdigest(),
               launches=launches, traced_step=traced,
               sends_per_step=len(sent) / len(batches),
               send_bytes=sorted(set(sent)),
               activation_bytes=(PAR_MESH_BATCH // M) * SLICE["seq_len"]
               * SLICE["d_model"] * 4,
               param_bytes_rank=rank_p, param_bytes_world1=whole_p,
               moment_bytes_rank=rank_m, moment_bytes_world1=whole_m,
               ms_per_step=ms)
    del tr, net

    def sgd_twin():
        twin = par_gpt(updater="sgd", learning_rate=PAR_MESH_SGD_LR)
        tr = GraphPipelineTrainer(twin, mesh, n_microbatches=M)
        losses = [float(tr.fit_batch(b)) for b in batches]
        tr.gather_params()
        return mesh_parity(losses, twin, *plain["sgd"])
    rec["sgd"] = uncounted(sgd_twin)
    return rec


def par_p2p_ms() -> dict:
    """ms of one staged send of a GPT activation ([8, 256, 512] f32, 4
    MiB) from stage 0 to stage 1 alone, through host buffers (gloo), 3
    times after a warm-up, each after a barrier: the sender's post and
    wait, the receiver's receive."""
    from deeplearning4j_tpu_torch.parallel import MeshContext
    mesh = MeshContext.create(n_pipe=2)
    t = torch.zeros(PAR_MESH_BATCH, SLICE["seq_len"], SLICE["d_model"],
                    device="cuda")
    out = []
    with torch.no_grad():
        for i in range(4):
            mesh.all_reduce_(torch.zeros(1, device="cuda"), axis="pp")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if mesh.pipe_index == 0:
                mesh.send_stage(t, 1, 1000 + i)
                mesh.wait_sends()
            else:
                mesh.recv_stage(t.shape, t.dtype, 0, 1000 + i)
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
    return dict(bytes=t.numel() * t.element_size(),
                side="send" if mesh.pipe_index == 0 else "receive",
                ms=out[1:])


def par_pp_char_rnn() -> dict:
    """One rank's run of the pp_char_rnn mode: PipelineTrainer over the
    'pp' axis on the char-RNN, stages [[0], [1]], PP_RNN_M microbatches of
    one [32, 200] batch (4 tBPTT windows). Each window's loss and (after
    ``gather_params``) the params against the plain windowed
    ``fit_batch``; this stage's LSTM gradients of the first window
    against the plain window's; an uncounted SGD twin; the K2 / K3
    launches; ms the batch."""
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.parallel import MeshContext
    from deeplearning4j_tpu_torch.parallel.pipeline import PipelineTrainer
    B, T = LSTM_TRAIN_BATCH
    batch = text_batches(1, B, T, SEED + 9)[0]
    mesh = MeshContext.create(n_pipe=2)

    def pipelined(net):
        scores = CollectScoresIterationListener()
        net.set_listeners(scores)
        tr = PipelineTrainer(net, mesh, stages=[[0], [1]],
                             n_microbatches=PP_RNN_M)
        return tr, scores

    net = par_char_rnn()
    tr, scores = pipelined(net)
    first, apply = [], tr._apply

    def keep_first(grads, loss):
        if not first:
            first.append(tree_map(lambda t: t.detach().clone(), grads))
        return apply(grads, loss)
    tr._apply = keep_first
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr.fit_batch(batch)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = counts()
    own = tr._stage_keys(mesh.pipe_index)
    tr.gather_params()
    fwd = net.conf.training.tbptt_fwd_length

    def plain_run(updater, lr):
        ref = MultiLayerNetwork(char_rnn_lstm(**LSTM_SLICE, updater=updater,
                                              learning_rate=lr),
                                device="cuda").init()
        grads, _, _ = ref.compute_gradient_and_score(DataSet(
            batch.features[:, :fwd], batch.labels[:, :fwd]))
        losses = step_losses(ref)
        ref.fit_batch(batch)
        del ref._step
        return grads, losses, ref
    conf = char_rnn_lstm(**LSTM_SLICE)
    grads, plain_losses, ref = uncounted(
        plain_run, conf.training.updater.name,
        conf.training.updater.learning_rate)
    err, worst = grad_rel_err(
        {k: first[0][k] for k in own},
        {k: {n: g.cpu() for n, g in grads[k].items()} for k in own})
    rec = dict(stage=mesh.pipe_index, own_layers=own,
               **mesh_parity([s for _, s in scores.scores], net,
                             plain_losses, ref),
               grad_rel_err=err, grad_worst=worst, launches=launches,
               ms_per_batch=ms)
    del tr, net, ref

    def sgd_twin():
        twin = MultiLayerNetwork(char_rnn_lstm(
            **LSTM_SLICE, updater="sgd", learning_rate=PP_RNN_SGD_LR),
            device="cuda").init()
        ttr, tscores = pipelined(twin)
        ttr.fit_batch(batch)
        ttr.gather_params()
        _, losses, ref = plain_run("sgd", PP_RNN_SGD_LR)
        return mesh_parity([s for _, s in tscores.scores], twin, losses, ref)
    rec["sgd"] = uncounted(sgd_twin)
    return rec


def par_ep() -> dict:
    """One rank's run of the ep mode: the MoE FFN (``parallel/expert.
    moe_ffn``) at the GPT's widths (EP_TOKENS tokens of 512, EP_EXPERTS
    experts of EP_HIDDEN), the gradients of sum(out**2) + aux. World 1 on
    the card against the same on the CPU; then each rank holding its
    half of the experts on the world-2 group's 'ep' axis (the same
    tokens) against world 1: the output's and every gradient's max |diff|
    over its largest |value|, and ms of each on the card."""
    import math
    from deeplearning4j_tpu_torch.parallel import MeshContext
    from deeplearning4j_tpu_torch.parallel.expert import (
        EXPERT_PARAMS, expert_rows, expert_span, moe_ffn,
    )
    gen = torch.Generator().manual_seed(SEED + 11)
    N, Fd, E, H = EP_TOKENS, SLICE["d_model"], EP_EXPERTS, EP_HIDDEN

    def w(*shape):
        return torch.randn(shape, generator=gen) / math.sqrt(shape[-2])
    params = {"Wg": w(Fd, E), "W1": w(E, Fd, H),
              "b1": 0.1 * torch.randn(E, H, generator=gen),
              "W2": w(E, H, Fd), "b2": 0.1 * torch.randn(E, Fd, generator=gen)}
    x = torch.randn(N, Fd, generator=gen)

    def run(p, x, mesh=None):
        p = {k: v.detach().clone().requires_grad_() for k, v in p.items()}
        x = x.detach().clone().requires_grad_()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, aux = moe_ffn(p, x, "relu", 1.25, mesh=mesh)
        ((out ** 2).sum() + aux).backward()
        torch.cuda.synchronize()
        grads = {k: v.grad for k, v in p.items()}
        grads["x"] = x.grad
        return (out.detach(), aux.detach(), grads,
                (time.perf_counter() - t0) * 1e3)

    def rel(a, b):
        a, b = a.float().cpu(), b.float().cpu()
        return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)

    def gaps(got, want, rows=None):
        g = {"out": rel(got[0], want[0]), "aux": rel(got[1], want[1])}
        for k, v in got[2].items():
            ref = want[2][k]
            g[k] = rel(v, ref[rows] if rows is not None and
                       k in EXPERT_PARAMS else ref)
        return g
    cpu = run(params, x)
    dev = {k: v.cuda() for k, v in params.items()}
    world1 = run(dev, x.cuda())
    mesh = MeshContext.create(n_expert=2)
    span = expert_span(E, mesh)
    sharded = run(expert_rows(dev, mesh), x.cuda(), mesh)
    return dict(tokens=N, d_model=Fd, experts=E, hidden=H,
                span=[span.start, span.stop],
                world1_vs_cpu=gaps(world1, cpu),
                ep_vs_world1=gaps(sharded, world1, span),
                ms_world1=world1[3], ms_ep=sharded[3], ms_cpu=cpu[3])


def moe_dp_conf(updater="adam", lr=MOE_DP_LR):
    """The moe_dp mode's MoE MLP (MOE_DP_*), the same seed on every rank."""
    from deeplearning4j_tpu_torch.parallel.expert import MoELayer
    D = SLICE["d_model"]
    return (NeuralNetConfiguration.builder().seed(SEED + 60)
            .updater(updater, learning_rate=lr).weight_init("xavier")
            .list()
            .layer(DenseLayer(n_out=D, activation="relu"))
            .layer(MoELayer(n_experts=EP_EXPERTS, hidden=EP_HIDDEN,
                            capacity_factor=1.0, aux_loss_weight=1e-2,
                            activation="relu"))
            .layer(OutputLayer(n_out=MOE_DP_CLASSES, activation="softmax",
                               loss="mcxent"))
            .set_input_type(InputType.feed_forward(D)).build())


def moe_dp_batches():
    """MOE_DP_STEPS global batches of MOE_DP_BATCH rows (normal features,
    one-hot labels), drawn from a seed."""
    rng = np.random.default_rng(SEED + 61)
    D, C = SLICE["d_model"], MOE_DP_CLASSES
    return [DataSet(rng.standard_normal((MOE_DP_BATCH, D), dtype=np.float32),
                    np.eye(C, dtype=np.float32)[
                        rng.integers(0, C, MOE_DP_BATCH)])
            for _ in range(MOE_DP_STEPS)]


def moe_route(net, batch):
    """The expert the MoE MLP's gate picks for each row of ``batch`` at
    ``net``'s params."""
    x = torch.as_tensor(batch.features, device=net.device)
    with torch.no_grad():
        h = torch.relu(x @ net.params[0]["W"] + net.params[0]["b"])
        return (h @ net.params[1]["Wg"]).argmax(dim=-1)


def moe_drops(net, batch, n_data):
    """(tokens the global capacity drops routing ``batch`` at ``net``'s
    params, tokens a per-rank capacity would drop with its rows cut over
    ``n_data`` ranks): the counts past each expert's capacity."""
    layer = net.layers[1]
    idx = moe_route(net, batch)

    def dropped(part):
        cap = max(1, int(layer.capacity_factor * part.numel()
                         / layer.n_experts))
        counts = torch.bincount(part, minlength=layer.n_experts)
        return int((counts - cap).clamp_min(0).sum())
    return dropped(idx), sum(dropped(p) for p in idx.chunk(n_data))


def moe_preacts(params, x, n_parts, capacity_factor):
    """The MoE MLP's ReLU pre-activations at ``params`` (a Dense layer,
    then an ``MoELayer``) on the global batch ``x``, computed as a step
    over ``n_parts`` data ranks computes them: each rank's rows through
    the Dense layer and the gate, the experts' slots at the global
    positions, one batched product for every slot. Returns (the Dense
    pre-activations ``[N, D]``, the token in each expert slot ``[E, C]``
    (-1 where empty), the experts' pre-activations ``[E, C, H]``)."""
    dense, moe = params[0], params[1]
    with torch.no_grad():
        z = torch.cat([xp @ dense["W"] + dense["b"]
                       for xp in x.chunk(n_parts)])
        h = torch.relu(z)
        gates = torch.cat([torch.softmax(hp @ moe["Wg"], dim=-1)
                           for hp in h.chunk(n_parts)])
        N, E = gates.shape
        C = max(1, int(capacity_factor * N / E))
        idx = gates.argmax(dim=-1)
        pos = (F.one_hot(idx, E).cumsum(dim=0) - 1).gather(
            1, idx[:, None])[:, 0]
        kept = pos < C
        slot = torch.full((E, C), -1, dtype=torch.int64, device=x.device)
        slot[idx[kept], pos[kept]] = torch.arange(N, device=x.device)[kept]
        expert_in = h.new_zeros((E, C, h.shape[-1]))
        expert_in[idx[kept], pos[kept]] = h[kept]
        pre = (torch.einsum("ecf,efh->ech", expert_in, moe["W1"])
               + moe["b1"][:, None, :])
    return z, slot, pre


def moe_crossings(params, plain_params, x, n_parts, capacity_factor):
    """The units whose ReLU pre-activation has another sign under
    ``params`` (a mesh step's net over ``n_parts`` data ranks) than under
    ``plain_params`` (the plain step's), on tokens both keep in the same
    slot: ``{"dense": bool [D], "expert": bool [E, H]}``."""
    zm, slot_m, pm = moe_preacts(params, x, n_parts, capacity_factor)
    zp, slot_p, pp = moe_preacts(plain_params, x, 1, capacity_factor)
    both = (slot_m == slot_p) & (slot_m >= 0)
    return dict(dense=((zm > 0) != (zp > 0)).any(dim=0),
                expert=(((pm > 0) != (pp > 0)) & both[..., None]).any(dim=1))


class Crossings:
    """The units a mesh run crossed (:func:`moe_crossings`) before each of
    its steps against the plain run's params before the same step (its
    ``plain`` snapshots, a step each), or-ed over the steps."""

    def __init__(self, plain, n_parts, capacity_factor):
        self.plain, self.n_parts, self.cf = plain, n_parts, capacity_factor
        self.units, self.per_step = {}, []

    def before(self, i, params, x) -> None:
        got = moe_crossings(params, self.plain[i], x, self.n_parts, self.cf)
        self.per_step.append((int(got["dense"].sum()),
                              int(got["expert"].sum())))
        for k, v in got.items():
            self.units[k] = self.units[k] | v if k in self.units else v


def moe_crossing_gate(params, plain_params, crossed) -> dict:
    """C31's gate on the MoE MLP's params after a mesh run against the
    plain run's, given the units ``crossed`` before any of its steps
    (:func:`moe_crossings`, or-ed over the steps): the W1 / b1 / W2
    elements outside TOL_PAR_* and those of them outside every crossed
    unit's column, entry or row (``unexplained``), the elements outside
    in the other leaves, and whether the gate holds."""
    units = crossed["expert"]
    allowed = {"W1": units[:, None, :], "b1": units, "W2": units[:, :, None]}
    expert = unexplained = other = 0
    for i, (p, q) in enumerate(zip(params, plain_params)):
        for k in sorted(p):
            out = (p[k] - q[k]).abs() > TOL_PAR_ATOL + TOL_PAR_RTOL * q[k].abs()
            if i == 1 and k in allowed:
                expert += int(out.sum())
                unexplained += int((out & ~allowed[k]).sum())
            else:
                other += int(out.sum())
    n_dense, n_expert = int(crossed["dense"].sum()), int(units.sum())
    return dict(crossed_dense_units=n_dense, crossed_expert_units=n_expert,
                expert_outside=expert, unexplained=unexplained,
                other_outside=other,
                holds=(unexplained == 0 and other <= PAR_MESH_FLIPS
                       and (n_dense + n_expert > 0 or expert + other == 0)))


def par_moe_dp() -> dict:
    """One rank's run of the moe_dp mode: the MoE MLP (MOE_DP_*) through
    ParallelTrainer over the world-2 group's data axis, replicated and
    under zero1, each MOE_DP_STEPS steps of the global batches, against
    this rank's plain world-1 fit_batch of the same batches (losses and
    params, mesh_parity), with an SGD twin each. Also: the tokens the
    global capacity drops on the first batch at the init params, and
    those a per-rank capacity would drop; ms a step of each against the
    plain step; the bytes the dispatch's collectives (the per-expert
    counts' all-gather, the gate sums' all-reduce forward and back) move
    a step; the first step's gradient through the global dispatch against
    the plain one, element by element; the Adam path's params outside
    the gate by leaf, and the rows its gate routes apart from the plain
    steps' before each step."""
    from deeplearning4j_tpu_torch.nn.netcommon import global_batch_stats
    from deeplearning4j_tpu_torch.parallel import MeshContext, ParallelTrainer
    from deeplearning4j_tpu_torch.parallel.mesh import GlobalBatch, take_rows
    mesh = MeshContext.create()
    batches = moe_dp_batches()

    def steps(fit, net=None, before=None):
        """(losses, ms a step, and with ``net`` the gate's pick for each
        batch's rows before its step); ``before(i, b)`` runs before step
        i, untimed"""
        losses, ms, routes = [], [], []
        for i, b in enumerate(batches):
            if before is not None:
                before(i, b)
            if net is not None:
                routes.append(moe_route(net, b))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(float(fit(b)))
            ms.append((time.perf_counter() - t0) * 1e3)
        return losses, ms, routes

    def net_of(updater, lr):
        return MultiLayerNetwork(moe_dp_conf(updater, lr),
                                 device="cuda").init()
    plain, snaps = {}, {}
    for u, lr in (("adam", MOE_DP_LR), ("sgd", MOE_DP_SGD_LR)):
        net = net_of(u, lr)
        # the plain params before each step, for the crossings
        snaps[u] = []
        losses, ms, routes = steps(
            net.fit_batch, net, lambda i, b, net=net, u=u: snaps[u].append(
                tree_map(lambda t: t.detach().clone(), net.params)))
        plain[u] = (losses, net, ms, routes)

    def crossing_run(net, u):
        """(the step hook that records each step's crossings against the
        plain ``u`` run's, the ``Crossings`` it fills)"""
        crossed = Crossings(snaps[u], mesh.n_data,
                            net.layers[1].capacity_factor)
        return (lambda i, b: crossed.before(i, net.params, torch.as_tensor(
            b.features, device=net.device))), crossed
    first = net_of("adam", MOE_DP_LR)
    drops = moe_drops(first, batches[0], mesh.n_data)
    # the first step's gradient at the init params, whole and through the
    # global dispatch on this rank's rows (mean over the data axis): each
    # element's gap over |g|, by leaf
    plain_g = tree_leaves(first.compute_gradient_and_score(batches[0])[0])
    rows = take_rows(batches[0], mesh.batch_slice(MOE_DP_BATCH))
    with global_batch_stats(first, GlobalBatch(mesh)):
        rank_g = tree_leaves(first.compute_gradient_and_score(rows)[0])
    flat = torch.cat([g.reshape(-1) for g in rank_g])
    mesh.all_reduce_(flat).div_(mesh.n_data)
    grad_abs = [g.abs().reshape(-1) for g in plain_g]
    gaps = [(a - b.reshape(-1)).abs() / g.clamp_min(1e-30) for a, b, g in
            zip(flat.split([g.numel() for g in plain_g]), plain_g,
                grad_abs)]
    rec = dict(grad_rel_err_median_by_leaf=[float(g.median())
                                            for g in gaps])
    del plain_g, rank_g, flat
    rec.update(params=first.num_params(), global_batch=MOE_DP_BATCH,
               rows_per_rank=MOE_DP_BATCH // mesh.n_data,
               experts=EP_EXPERTS, hidden=EP_HIDDEN,
               capacity_global=int(MOE_DP_BATCH / EP_EXPERTS),
               capacity_per_rank=int(MOE_DP_BATCH / mesh.n_data
                                     / EP_EXPERTS),
               dropped_global_capacity=drops[0],
               dropped_per_rank_capacity=drops[1],
               plain_ms_per_step=plain["adam"][2],
               gradient_bytes=param_bytes(first))
    del first
    moved = []
    counts, total = GlobalBatch.token_counts, GlobalBatch.token_sum

    def counted_counts(self, c):
        moved.append(("all_gather", c.numel() * 8 * self.mesh.n_data))
        return counts(self, c)

    def counted_sum(self, t):
        # the all-reduce forward, and its twin in the backward
        moved.append(("all_reduce", 2 * t.numel() * t.element_size()))
        return total(self, t)
    GlobalBatch.token_counts = counted_counts
    GlobalBatch.token_sum = counted_sum
    try:
        for mode in MOE_DP_MODES:
            net = net_of("adam", MOE_DP_LR)
            tr = ParallelTrainer(net, mesh, weight_update_sharding=mode)
            del moved[:]
            before, crossed = crossing_run(net, "adam")
            losses, ms, routes = steps(tr.fit_batch, net, before)
            flat = torch.cat([p.reshape(-1) for p in
                              tree_leaves(net.params)]).cpu().numpy()
            plain_net = plain["adam"][1]
            out = [(x - y).abs() > TOL_PAR_ATOL + TOL_PAR_RTOL * y.abs()
                   for x, y in zip(tree_leaves(net.params),
                                   tree_leaves(plain_net.params))]
            flips = torch.cat([g[o.reshape(-1)] for g, o in zip(gaps, out)])
            flip_abs = torch.cat([g[o.reshape(-1)]
                                  for g, o in zip(grad_abs, out)])
            names = [f"{i}/{n}" for i, p in enumerate(plain_net.params)
                     for n in sorted(p)]
            q = flips.new_tensor([0.1, 0.5, 0.9])
            rec[mode] = dict(
                **mesh_parity(losses, net, *plain["adam"][:2]),
                outside_by_leaf={n: int(o.sum())
                                 for n, o in zip(names, out) if o.any()},
                # rows the gate sends elsewhere than the plain steps' gate
                # does, before each step
                routed_apart=[int((a != b).sum()) for a, b in
                              zip(routes, plain["adam"][3])],
                # the elements outside: the 10th, 50th and 90th
                # percentiles of their first-step gradient gaps and |g|
                flip_grad_rel_err=(flips.quantile(q).tolist()
                                   if flips.numel() else []),
                flip_grad_abs=(flip_abs.quantile(q).tolist()
                               if flips.numel() else []),
                # C31: the units crossed before each step (dense,
                # expert) and the gate over the elements outside
                crossings_per_step=crossed.per_step,
                crossing_gate=moe_crossing_gate(net.params, plain_net.params,
                                                crossed.units),
                ms_per_step=ms, aux_loss=float(net.states[1]["aux_loss"]),
                params_sha256=hashlib.sha256(flat.tobytes()).hexdigest(),
                dispatch_collectives_per_step=len(moved) / MOE_DP_STEPS,
                dispatch_bytes_per_step=sum(b for _, b in moved)
                / MOE_DP_STEPS,
                moment_bytes_rank=moment_bytes(net))
            del tr, net
            twin = net_of("sgd", MOE_DP_SGD_LR)
            tr = ParallelTrainer(twin, mesh, weight_update_sharding=mode)
            before, crossed = crossing_run(twin, "sgd")
            losses = steps(tr.fit_batch, before=before)[0]
            rec[mode]["sgd"] = mesh_parity(losses, twin, *plain["sgd"][:2])
            rec[mode]["sgd"]["crossing_gate"] = moe_crossing_gate(
                twin.params, plain["sgd"][1].params, crossed.units)
            del tr, twin
    finally:
        GlobalBatch.token_counts = counts
        GlobalBatch.token_sum = total
    return rec


def par_rank(rank, world, init, out):
    """One rank of the world-2 group (this script run with
    ``--parallel-rank``): the GPT through ParallelTrainer in the off,
    zero1 and zero2 modes, PAR_STEPS steps each, then on a model axis
    and on an sp axis (``par_mesh_mode``); the updater state's
    bytes before and after sharding; ms a step; zero1 saves a sharded
    checkpoint after its second step, and rank 0 keeps the third step's
    loss and params for the world-1 restore. Writes its record to
    ``<out>/rank<r>.json``, then runs the elastic case in the same
    process (``par_elastic_rank``: rank 1 ends there, killed). The MoE
    MLP over the data axis (``par_moe_dp``) runs after the ep mode."""
    from deeplearning4j_tpu_torch.parallel import (
        MeshContext, ParallelTrainer, multihost,
    )
    from deeplearning4j_tpu_torch.resilience import CheckpointManager
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = Path(out)
    multihost.initialize(init, world, rank, backend="gloo")
    rec = dict(rank=rank, world=world)
    try:
        mesh = MeshContext.create()
        rec["backend"] = mesh.backend
        batches = text_batches(PAR_STEPS, TRAIN_BATCH, SLICE["seq_len"],
                               SEED)
        ref = None
        for mode in ("off", "zero1", "zero2"):
            net = par_gpt()
            full = moment_bytes(net)
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            tr = ParallelTrainer(net, mesh, weight_update_sharding=mode)
            torch.cuda.synchronize()
            after = torch.cuda.memory_allocated()
            reset_counts()
            losses, ms = [], []
            for i, b in enumerate(batches):
                if mode == "zero1" and i == PAR_STEPS - 1:
                    mgr = CheckpointManager(
                        out / "ckpt", sharded=True, mesh_ctx=mesh,
                        weight_update_sharding=mode)
                    t0 = time.perf_counter()
                    mgr.save(net)
                    rec["zero1_checkpoint_write_s"] = \
                        time.perf_counter() - t0
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                losses.append(float(tr.fit_batch(b)))
                ms.append((time.perf_counter() - t0) * 1e3)
            flat = torch.cat([p.reshape(-1) for p in
                              tree_leaves(net.params)]).cpu().numpy()
            rec[mode] = dict(
                losses=losses, ms_per_step=ms, launches=counts(),
                params_sha256=hashlib.sha256(flat.tobytes()).hexdigest(),
                state_bytes_replicated=full,
                state_bytes_rank=moment_bytes(net),
                allocated_before_sharding=before,
                allocated_after_sharding=after,
                bitwise_off=(None if ref is None else
                             losses == ref[0] and params_equal(net, ref[1])))
            if mode == "off":
                ref = (losses, net)
            if mode == "zero1" and rank == 0:
                np.save(out / "zero1_last_params.npy", flat)
            del tr
            if mode != "off":
                del net
        rec["collective_ms"] = par_collective_ms(mesh, ref[1])
        del ref
        mesh_batches = [b for b in text_batches(
            PAR_STEPS, PAR_MESH_BATCH, SLICE["seq_len"], SEED + 5)]

        def plain_steps(updater):
            net = par_gpt(updater=updater) if updater == "adam" else \
                par_gpt(updater=updater, learning_rate=PAR_MESH_SGD_LR)
            return [float(net.fit_batch(b)) for b in mesh_batches], net
        plain = {u: uncounted(plain_steps, u) for u in ("adam", "sgd")}
        for mode in PAR_MESH_MODES:
            rec[mode] = par_mesh_mode(mode, mesh_batches, plain)
        for mode, M in PP_GPT_MODES.items():
            rec[mode] = par_pp_gpt(M, mesh_batches, plain)
        del plain
        rec["pp_p2p"] = par_p2p_ms()
        rec["pp_char_rnn"] = par_pp_char_rnn()
        rec["ep"] = par_ep()
        rec["moe_dp"] = par_moe_dp()
    finally:
        multihost.shutdown()
    (out / f"rank{rank}.json").write_text(json.dumps(rec))
    return par_elastic_rank(rank, world, init, out / "elastic")


def elastic_trainer(ckpt):
    """The elastic case's trainer over ``ckpt`` (the full-width GPT, zero1
    asked for: replicated at world 1)."""
    from deeplearning4j_tpu_torch.resilience import ElasticTrainer
    return ElasticTrainer(par_gpt, ckpt, weight_update_sharding="zero1",
                          checkpoint_every=ELASTIC_EVERY, keep_last=10,
                          step_timeout_s=120.0, heartbeat_interval_s=0.2,
                          heartbeat_timeout_s=ELASTIC_HB_S,
                          commit_timeout_s=120.0)


def elastic_batches():
    return text_batches(ELASTIC_STEPS, TRAIN_BATCH, SLICE["seq_len"],
                        SEED + 3)


def flat_params(net) -> np.ndarray:
    return torch.cat([p.reshape(-1) for p in
                      tree_leaves(net.params)]).cpu().numpy()


def par_elastic_rank(rank, world, init, out):
    """One rank of the elastic case, after the world-2 modes in the same
    process: an elastic gloo group on this card (its store is the file
    ``<init>.rdv0``, not the plain group's), the GPT through
    ElasticTrainer, rank 1 killed by ``kill_host`` at step ELASTIC_KILL
    (it stamps the time first). The survivor writes its trajectory,
    counters, launches, params and the times of the kill's detection, of
    its resume and of its checkpoint restores."""
    from deeplearning4j_tpu_torch.parallel import multihost
    from deeplearning4j_tpu_torch.resilience import (
        CheckpointManager, ElasticTrainer,
    )
    out = Path(out)
    out.mkdir(exist_ok=True)
    multihost.initialize(init, world, rank, backend="gloo", elastic=True,
                         timeout_s=120.0)
    marks, restores = {}, []
    if rank == 1:
        kill = faultinject.check_kill

        def stamped(step):
            if step == ELASTIC_KILL:
                (out / "kill_time").write_text(repr(time.time()))
            kill(step)
        faultinject.check_kill = stamped
        faultinject.set_schedule(FaultSchedule([Fault("kill_host",
                                                      step=ELASTIC_KILL)]))
    restore = CheckpointManager.restore

    def timed_restore(self, *args, **kw):
        t0 = time.perf_counter()
        cursor = restore(self, *args, **kw)
        torch.cuda.synchronize()
        restores.append(time.perf_counter() - t0)
        return cursor
    CheckpointManager.restore = timed_restore
    lost = ElasticTrainer._on_hosts_lost

    def on_lost(self, verdict):
        marks["detected"] = time.time()
        lost(self, verdict)
        marks["resumed"] = time.time()
    ElasticTrainer._on_hosts_lost = on_lost
    reset_counts()
    trainer = elastic_trainer(out / "ckpt")
    try:
        trainer.fit(elastic_batches(), epochs=1)
    finally:
        trainer.close()
    np.save(out / f"elastic_params_r{rank}.npy", flat_params(trainer.net))
    reg = get_registry()
    rec = dict(rank=rank, trajectory=trainer.trajectory, world=trainer.world,
               dp=trainer.dp_width, launches=counts(), marks=marks,
               restore_s=restores,
               cursor_step=None if trainer._cursor is None
               else trainer._cursor.step,
               runtime_faults=multihost.runtime_fault_count(),
               quarantined=multihost.group_quarantined(),
               topology=trainer.manager.topology(),
               metrics=dict(reg.snapshot("elastic_"),
                            **reg.snapshot("resilience_host")))
    multihost.shutdown()
    (out / f"elastic_r{rank}.json").write_text(json.dumps(rec))
    return 0


def par_elastic(tmp):
    """The elastic case's verdict, after the world-2 group ended: rank 1
    died at step ELASTIC_KILL and rank 0 resized to world 1 and resumed.
    Then, uncounted, a clean world-1 ElasticTrainer restart from the
    checkpoints the survivor resumed from: its losses and params against
    the survivor's, bit for bit. Returns the record and the survivor's
    launches."""
    from deeplearning4j_tpu_torch.resilience import read_lease
    out = tmp / "world2" / "elastic"
    surv = json.loads((out / "elastic_r0.json").read_text())
    cut = surv["cursor_step"]
    check(cut is not None and 0 < cut < ELASTIC_KILL,
          f"the survivor resumed from step {cut}")
    ref = tmp / "elastic_clean"
    shutil.copytree(out / "ckpt", ref,
                    ignore=shutil.ignore_patterns("heartbeats"))
    for d in ref.glob("ckpt-*"):
        if int(d.name.split("-")[1]) > cut:
            shutil.rmtree(d)

    def clean_restart():
        trainer = elastic_trainer(ref)
        try:
            trainer.fit(elastic_batches(), epochs=1)
        finally:
            trainer.close()
        return trainer
    clean = uncounted(clean_restart)
    from deeplearning4j_tpu_torch.parallel import multihost
    multihost.set_rendezvous_epoch(0)
    tail = [e["loss"] for e in surv["trajectory"] if e["step"] > cut]
    lease = read_lease(out / "ckpt" / "heartbeats")
    kill_t = float((out / "kill_time").read_text())
    rec = dict(
        resumed_from_step=cut,
        consumed=[e["index"] for e in surv["trajectory"]],
        world=surv["world"], dp=surv["dp"], metrics=surv["metrics"],
        runtime_faults=surv["runtime_faults"],
        quarantined=surv["quarantined"], topology=surv["topology"],
        lease={k: lease[k] for k in ("epoch", "coordinator", "world")},
        tail_losses=tail,
        clean_losses=[e["loss"] for e in clean.trajectory],
        tail_bitwise=tail == [e["loss"] for e in clean.trajectory],
        params_bitwise=np.load(out / "elastic_params_r0.npy").tobytes()
        == flat_params(clean.net).tobytes(),
        kill_to_detect_s=surv["marks"]["detected"] - kill_t,
        kill_to_resume_s=surv["marks"]["resumed"] - kill_t,
        heartbeat_window_s=ELASTIC_HB_S,
        restore_s=surv["restore_s"][-1],
        survivor_launches=surv["launches"])
    del clean
    return rec


def par_collective_ms(mesh, net) -> dict:
    """ms of each collective a step issues, alone, on a buffer of the
    net's gradient size (fp32; padded to divide by the world), 3 times
    each: what a world-2 step spends in the transport."""
    n = sum(t.numel() for t in tree_leaves(net.params))
    flat = torch.zeros(-(-n // mesh.world) * mesh.world, device="cuda")
    row = torch.zeros(flat.numel() // mesh.world, device="cuda")

    def ms(fn):
        out = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
        return out
    return dict(gradient_bytes=4 * n,
                all_reduce=ms(lambda: mesh.all_reduce_(flat)),
                reduce_scatter=ms(lambda: mesh.reduce_scatter(flat)),
                all_gather=ms(lambda: mesh.all_gather(row)))


def par_world2(tmp):
    """The world-2 group: two processes of this script on this card (the
    elastic case after it: rank 1 ends by its fault); the world-1
    restore of their zero1 checkpoint, and its next step against
    theirs."""
    from deeplearning4j_tpu_torch.parallel import (
        MeshContext, ParallelTrainer,
    )
    from deeplearning4j_tpu_torch.resilience import CheckpointManager
    out = tmp / "world2"
    out.mkdir()
    init = f"file://{tmp}/rdv_world2"
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--parallel-rank",
         str(r), str(PAR_WORLD), init, str(out)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(PAR_WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=600)[0].decode(
                errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    # rank 1 ends in the elastic case, by its kill_host fault
    for r, p in enumerate(procs):
        want = faultinject.KILL_HOST_EXIT_CODE if r == 1 else 0
        check(p.returncode == want,
              f"world-2 rank {r} exited {p.returncode}, not {want}: "
              f"{logs[r][-3000:]}")
    ranks = [json.loads((out / f"rank{r}.json").read_text())
             for r in range(PAR_WORLD)]
    rec = dict(group_seconds=time.perf_counter() - t0, ranks=ranks)
    net = par_gpt(seed=7)
    mesh = MeshContext.create()
    mgr = CheckpointManager(out / "ckpt", sharded=True, mesh_ctx=mesh)
    t0 = time.perf_counter()
    cursor = mgr.restore(net, reshard=True)
    torch.cuda.synchronize()
    rec["world1_restore_s"] = time.perf_counter() - t0
    rec["restored_step"] = None if cursor is None else cursor.step
    batch = text_batches(PAR_STEPS, TRAIN_BATCH, SLICE["seq_len"],
                         SEED)[PAR_STEPS - 1]
    loss = float(ParallelTrainer(net, mesh).fit_batch(batch))
    want = torch.from_numpy(np.load(out / "zero1_last_params.npy")).cuda()
    got = torch.cat([p.reshape(-1) for p in tree_leaves(net.params)])
    diff = (got - want).abs()
    rec["world1_next_loss"] = loss
    rec["world2_next_loss"] = ranks[0]["zero1"]["losses"][-1]
    rec["world1_next_within_gate"] = bool(
        (diff <= TOL_PAR_ATOL + TOL_PAR_RTOL * want.abs()).all())
    rec["world1_next_max_abs_diff"] = float(diff.max())
    return rec


def train_parallel(smi):
    """The data-parallel trainers on the card (ROADMAP A6.1): world 1
    over NCCL in this process (ParallelTrainer, DelayedSyncTrainer,
    ParallelWrapper, FaultTolerantTrainer), then world 2 over gloo in two
    processes on this one card (zero1 / zero2 bitwise the replicated
    mode, the sharded state's bytes, a checkpoint restored at world 1;
    tensor and sequence parallelism, ROADMAP A6.2a: the tp and sp modes
    against the plain steps, K4-K6 on 4 heads and none on the ring;
    pipeline and expert parallelism, ROADMAP A6.2b: the GPT's two
    stages at M = 1 and 4, the char-RNN's two stages under tBPTT, the
    MoE FFN's experts split over the ranks; an MoE MLP over the data
    axis, ROADMAP A6.2c),
    then the elastic case in those processes (ROADMAP A6.3: a kill, a
    resize to world 1, a resume bit for bit a clean restart). Returns
    the path's launch counts: this process's and the elastic
    survivor's."""
    from deeplearning4j_tpu_torch.parallel import MeshContext, multihost
    tmp = Path(tempfile.mkdtemp(prefix="dl4j_parallel_"))
    try:
        check(multihost.initialize(f"file://{tmp}/rdv_world1", 1, 0)
              == "nccl", "a world-1 group on the card runs nccl")
        try:
            mesh = MeshContext.create()
            reset_counts()
            w1 = par_world1(mesh)
            ft = par_fault_tolerant(mesh, tmp)
        finally:
            multihost.shutdown()
        w2 = par_world2(tmp)
        LIVE["world2"] = w2
        el = par_elastic(tmp)
        launched = counts()
        # the survivor's launches (its own process): the elastic run's,
        # and rank 0's model-, sp- and pp-axis runs
        for k, n in el.pop("survivor_launches").items():
            launched[k] += n
        for mode in (*PAR_MESH_MODES, *PP_GPT_MODES, "pp_char_rnn"):
            for k, n in w2["ranks"][0][mode]["launches"].items():
                launched[k] += n
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    L, W = SLICE["n_layers"], LSTM_SLICE["layers"]
    n_win = LSTM_TRAIN_BATCH[1] // char_rnn_lstm(
        **LSTM_SLICE).training.tbptt_fwd_length
    emit(dict(phase="train_parallel", nvidia_smi=smi, world1=w1,
              fault_tolerant=ft, world2=w2, main_path_launches=launched))
    emit(dict(phase="train_parallel_elastic", nvidia_smi=smi,
              kill_to_resume_s=el["kill_to_resume_s"],
              kill_to_detect_s=el["kill_to_detect_s"],
              heartbeat_window_s=el["heartbeat_window_s"],
              restore_s=el["restore_s"],
              elastic_resizes_total=el["metrics"]["elastic_resizes_total"],
              **{k: v for k, v in el.items() if k not in (
                  "kill_to_resume_s", "kill_to_detect_s",
                  "heartbeat_window_s", "restore_s")}))
    emit(dict(phase="train_parallel_mesh", nvidia_smi=smi,
              **{mode: {k: w2["ranks"][0][mode][k] for k in (
                  "losses", "plain_losses", "loss_max_rel",
                  "params_outside_gate", "params_max_abs_diff", "sgd",
                  "traced_step", "q_heads",
                  "ring_shifts_forward", "param_bytes_rank",
                  "param_bytes_world1", "moment_bytes_rank",
                  "moment_bytes_world1", "ms_per_step", "collective_ms")}
                 for mode in PAR_MESH_MODES}))
    emit(dict(phase="train_parallel_pipeline", nvidia_smi=smi,
              **{f"rank{r['rank']}": {
                  **{mode: {k: r[mode][k] for k in (
                      "stage", "stage_nodes", "boundary", "losses",
                      "plain_losses", "loss_max_rel", "params_outside_gate",
                      "params_max_abs_diff", "sgd", "traced_step",
                      "launches", "sends_per_step", "send_bytes",
                      "activation_bytes", "param_bytes_rank",
                      "param_bytes_world1", "moment_bytes_rank",
                      "moment_bytes_world1", "ms_per_step")}
                     for mode in PP_GPT_MODES},
                  "pp_p2p": r["pp_p2p"], "pp_char_rnn": r["pp_char_rnn"],
                  "ep": r["ep"]} for r in w2["ranks"]}))
    emit(dict(phase="train_parallel_moe_dp", nvidia_smi=smi,
              **{f"rank{r['rank']}": r["moe_dp"] for r in w2["ranks"]}))
    gpt_step = {k: L for k in ATTENTION_KERNELS}
    gpt_step.update(lstm_fwd_train_kernel=0, lstm_bwd_kernel=0)
    rnn_step = {k: 0 for k in ATTENTION_KERNELS}
    rnn_step.update(lstm_fwd_train_kernel=n_win * W,
                    lstm_bwd_kernel=n_win * W)
    wrap_step = dict(rnn_step, lstm_fwd_train_kernel=2 * n_win * W,
                     lstm_bwd_kernel=2 * n_win * W)
    for name, want in (("gpt_step_trace", gpt_step),
                       ("char_rnn_step_trace", rnn_step),
                       ("wrapper_fit_batch_trace", wrap_step)):
        got = {k: w1[name][k] for k in want}
        check(got == want, f"{name}: {got} != {want}")
    check(w1["backend"] == "nccl" and w1["world"] == 1,
          f"world 1: {w1['backend']}, {w1['world']}")
    check(w1["gpt_bitwise_plain"], "ParallelTrainer (world 1) is not the "
          f"plain fit_batch bit for bit: {w1['losses']} vs "
          f"{w1['losses_plain']}")
    check(w1["delayed_k1_bitwise"], "DelayedSyncTrainer(k=1) is not "
          "ParallelTrainer bit for bit")
    check(w1["accum4_within_gate"], "accumulation 4 off the plain step by "
          f"{w1['accum4_max_abs_diff']}")
    check(w1["accum4_peak_excess_bytes"]
          <= w1["quarter_step_peak_excess_bytes"]
          + 1.5 * w1["gradient_bytes"],
          f"accumulation 4 peaks at {w1['accum4_peak_excess_bytes']} bytes "
          f"against {w1['quarter_step_peak_excess_bytes']} for one "
          "microbatch's step: more than one accumulator")
    check(w1["char_rnn_delayed_k1_bitwise"], "DelayedSyncTrainer(k=1) on "
          "the char-RNN's tBPTT windows is not ParallelTrainer bit for bit")
    check(w1["char_rnn_tbptt_bitwise_plain"], "the char-RNN's tBPTT "
          "through ParallelTrainer is not its fit_batch bit for bit")
    check(w1["wrapper_within_gate"] and w1["wrapper_replicas_equal"],
          "ParallelWrapper against hand-run workers: "
          f"{w1['wrapper_max_abs_diff']}")
    check(ft["retries"] == 1 and ft["cut_raised"]
          and ft["resumed_iterations"] == FT_BATCHES
          and ft["resumed_bitwise"], f"fault-tolerant resume: {ft}")
    check(ft["rollbacks"] == 1 and ft["rolled_finite"]
          and ft["rolled_iterations"] == FT_BATCHES and
          ft["restore_bitwise"], f"fault-tolerant rollback: {ft}")
    r0, r1 = w2["ranks"]
    for r in (r0, r1):
        check(r["backend"] == "gloo", f"world 2 runs {r['backend']}")
        for mode in ("zero1", "zero2"):
            check(r[mode]["bitwise_off"], f"rank {r['rank']}: {mode} is "
                  "not the replicated mode bit for bit")
            check(r[mode]["state_bytes_rank"]
                  <= 0.51 * r[mode]["state_bytes_replicated"],
                  f"rank {r['rank']} {mode}: {r[mode]['state_bytes_rank']}"
                  " updater bytes, not half")
            freed = (r[mode]["allocated_before_sharding"]
                     - r[mode]["allocated_after_sharding"])
            check(freed >= 0.9 * (r[mode]["state_bytes_replicated"]
                                  - r[mode]["state_bytes_rank"]),
                  f"rank {r['rank']} {mode}: sharding freed {freed} bytes")
        for mode in ("off", "zero1", "zero2"):
            check(r[mode]["launches"]["flash_attn_fwd"] == PAR_STEPS * L,
                  f"rank {r['rank']} {mode}: {r[mode]['launches']}")
    for mode in ("off", "zero1", "zero2"):
        check(r0[mode]["params_sha256"] == r1[mode]["params_sha256"]
              and r0[mode]["losses"] == r1[mode]["losses"],
              f"{mode}: the two ranks' params differ")
    for r in (r0, r1):
        for mode, heads, per_step in (("tp", SLICE["n_heads"] // 2, L),
                                      ("sp", None, 0)):
            got = r[mode]
            lr = gpt_decoder(**SLICE).training.updater.learning_rate
            check(got["loss_max_rel"] <= TOL_MESH_LOSS
                  and got["params_outside_gate"] <= PAR_MESH_FLIPS
                  and got["params_max_abs_diff"]
                  <= 2 * lr * PAR_STEPS + TOL_PAR_ATOL,
                  f"rank {r['rank']} {mode}: {got['losses']} vs the plain "
                  f"{got['plain_losses']}, {got['params_outside_gate']} "
                  f"params outside the gate, off by up to "
                  f"{got['params_max_abs_diff']}")
            twin = got["sgd"]
            check(twin["loss_max_rel"] <= TOL_MESH_LOSS
                  and twin["params_outside_gate"] == 0,
                  f"rank {r['rank']} {mode} (SGD twin): {twin}")
            want = {k: per_step for k in ATTENTION_KERNELS}
            traced = {k: got["traced_step"][k] for k in ATTENTION_KERNELS}
            check(traced == want, f"rank {r['rank']} {mode}: a step "
                  f"launched {traced}, not {want}")
            for k in ("flash_attn_fwd", "flash_attn_dq", "flash_attn_dkv"):
                check(got["launches"][k] == PAR_STEPS * per_step,
                      f"rank {r['rank']} {mode}: {got['launches']}")
            if heads is not None:
                check(got["q_heads"] == [heads],
                      f"rank {r['rank']} tp: K4 ran on {got['q_heads']} "
                      f"heads, not {heads}")
                check(got["param_bytes_rank"]
                      <= 0.51 * got["param_bytes_world1"],
                      f"rank {r['rank']} tp: {got['param_bytes_rank']} "
                      f"param bytes of {got['param_bytes_world1']}")
            else:
                check(got["ring_shifts_forward"] == PAR_STEPS * L,
                      f"rank {r['rank']} sp: {got['ring_shifts_forward']} "
                      f"ring shifts in {PAR_STEPS} steps")
    for mode in (*PAR_MESH_MODES, *PP_GPT_MODES):
        check(r0[mode]["params_sha256"] == r1[mode]["params_sha256"],
              f"{mode}: gather_params() differs between the ranks")
    gpt_lr = gpt_decoder(**SLICE).training.updater.learning_rate
    rnn_conf = char_rnn_lstm(**LSTM_SLICE)
    rnn_lr = rnn_conf.training.updater.learning_rate
    for r in (r0, r1):
        for mode, M in PP_GPT_MODES.items():
            got = r[mode]
            check(got["stage"] == r["rank"] and got["stage_nodes"] == [29, 29]
                  and got["boundary"] == ["b3_res2"],
                  f"rank {r['rank']} {mode}: stage {got['stage']} of "
                  f"{got['stage_nodes']} nodes, cut at {got['boundary']}")
            check(got["loss_max_rel"] <= TOL_MESH_LOSS
                  and got["params_outside_gate"] <= PAR_MESH_FLIPS
                  and got["params_max_abs_diff"]
                  <= 2 * gpt_lr * PAR_STEPS + TOL_PAR_ATOL,
                  f"rank {r['rank']} {mode}: {got['losses']} vs the plain "
                  f"{got['plain_losses']}, {got['params_outside_gate']} "
                  f"params outside the gate, off by up to "
                  f"{got['params_max_abs_diff']}")
            twin = got["sgd"]
            check(twin["loss_max_rel"] <= TOL_MESH_LOSS
                  and twin["params_outside_gate"] == 0,
                  f"rank {r['rank']} {mode} (SGD twin): {twin}")
            want = {k: PP_STAGE_LAYERS * M for k in ATTENTION_KERNELS}
            traced = {k: got["traced_step"][k] for k in ATTENTION_KERNELS}
            check(traced == want, f"rank {r['rank']} {mode}: a step "
                  f"launched {traced}, not {want}")
            for k in ("flash_attn_fwd", "flash_attn_dq", "flash_attn_dkv"):
                check(got["launches"][k] == PAR_STEPS * PP_STAGE_LAYERS * M,
                      f"rank {r['rank']} {mode}: {got['launches']}")
            check(got["param_bytes_rank"] <= 0.55 * got["param_bytes_world1"]
                  and got["moment_bytes_rank"]
                  <= 0.55 * got["moment_bytes_world1"],
                  f"rank {r['rank']} {mode}: {got['param_bytes_rank']} "
                  f"param / {got['moment_bytes_rank']} moment bytes of "
                  f"{got['param_bytes_world1']} / "
                  f"{got['moment_bytes_world1']}")
            check(got["activation_bytes"] in got["send_bytes"]
                  and got["sends_per_step"] == M + 1,
                  f"rank {r['rank']} {mode}: sends {got['send_bytes']}, "
                  f"{got['sends_per_step']} a step")
        got = r["pp_char_rnn"]
        n_win = LSTM_TRAIN_BATCH[1] // rnn_conf.training.tbptt_fwd_length
        for k in ("lstm_fwd_train", "lstm_bwd"):
            check(got["launches"][k] == n_win * PP_RNN_M,
                  f"rank {r['rank']} pp_char_rnn: {got['launches']}")
        check(got["own_layers"] == ([0] if r["rank"] == 0 else [1, 2]),
              f"rank {r['rank']} pp_char_rnn holds {got['own_layers']}")
        check(got["loss_max_rel"] <= TOL_MESH_LOSS
              and len(got["losses"]) == n_win
              and got["params_outside_gate"] <= PAR_MESH_FLIPS
              and got["params_max_abs_diff"]
              <= 2 * rnn_lr * n_win + TOL_PAR_ATOL
              and got["grad_rel_err"] <= TOL_PP_RNN_GRAD,
              f"rank {r['rank']} pp_char_rnn: {got}")
        check(got["sgd"]["loss_max_rel"] <= TOL_MESH_LOSS
              and got["sgd"]["params_outside_gate"] == 0,
              f"rank {r['rank']} pp_char_rnn (SGD twin): {got['sgd']}")
        ep = r["ep"]
        check(max(ep["world1_vs_cpu"].values()) <= TOL_EP
              and max(ep["ep_vs_world1"].values()) <= TOL_EP
              and ep["span"] == [4 * r["rank"], 4 * r["rank"] + 4],
              f"rank {r['rank']} ep: {ep}")
        moe = r["moe_dp"]
        check(moe["dropped_global_capacity"] >= 1,
              f"rank {r['rank']} moe_dp: the global capacity drops no "
              f"token: {moe}")
        for mode in MOE_DP_MODES:
            got = moe[mode]
            check(got["loss_max_rel"] <= TOL_MESH_LOSS
                  and got["crossing_gate"]["holds"]
                  and got["params_max_abs_diff"]
                  <= 2 * MOE_DP_LR * MOE_DP_STEPS + TOL_PAR_ATOL,
                  f"rank {r['rank']} moe_dp {mode}: {got['losses']} vs "
                  f"the plain {got['plain_losses']}, "
                  f"{got['params_outside_gate']} params outside the gate "
                  f"({got['crossing_gate']}, crossings a step "
                  f"{got['crossings_per_step']}), "
                  f"off by up to {got['params_max_abs_diff']}")
            check(got["sgd"]["loss_max_rel"] <= TOL_MESH_LOSS
                  and got["sgd"]["params_outside_gate"] == 0
                  and got["sgd"]["crossing_gate"]["holds"],
                  f"rank {r['rank']} moe_dp {mode} (SGD twin): "
                  f"{got['sgd']}")
            check(got["dispatch_collectives_per_step"] == 2,
                  f"rank {r['rank']} moe_dp {mode}: "
                  f"{got['dispatch_collectives_per_step']} dispatch "
                  "collectives a step, not an all-gather and a sum")
    for mode in MOE_DP_MODES:
        check(r0["moe_dp"][mode]["params_sha256"]
              == r1["moe_dp"][mode]["params_sha256"],
              f"moe_dp {mode}: the two ranks' params differ")
    m = el["metrics"]
    check(m["elastic_resizes_total"] == 1
          and m["elastic_elections_total"] == 1
          and m["resilience_host_failures_total"] == 1
          and m["elastic_reshard_restores_total"] == 1
          and el["world"] == [0] and el["dp"] == 1 and el["quarantined"],
          f"the elastic survivor did not resize to world 1: {el}")
    check(el["consumed"] == list(range(ELASTIC_STEPS)),
          f"the elastic run consumed {el['consumed']}, not each batch once")
    check(el["lease"] == {"epoch": 1, "coordinator": 0, "world": [0]},
          f"the lease after the kill: {el['lease']}")
    check(el["topology"]["rendezvous_epoch"] == 1
          and el["topology"]["dp"] == 1, f"topology {el['topology']}")
    check(el["tail_bitwise"] and el["params_bitwise"],
          "the survivor's tail is not a clean world-1 restart bit for bit: "
          f"{el['tail_losses']} vs {el['clean_losses']}")
    # the verdict waits for the victim's heartbeat to go stale: its last
    # beat (up to one 0.2 s interval before the kill) plus the window
    check(el["kill_to_detect_s"] >= ELASTIC_HB_S - 0.5,
          f"the loss was decided {el['kill_to_detect_s']} s after the "
          f"kill, inside the {ELASTIC_HB_S} s heartbeat window")
    check(w2["restored_step"] == PAR_STEPS - 1
          and w2["world1_next_within_gate"]
          and abs(w2["world1_next_loss"] - w2["world2_next_loss"])
          <= TOL_PAR_RTOL * abs(w2["world2_next_loss"]),
          f"the world-1 restore's next step: {w2}")
    return launched


def analysis(smi):
    """The static analysis on the card's configs (ROADMAP A7.3), no step
    of training: every config the smoke builds validates with no ERROR
    finding at the card's default budget; the full-width GPT's
    memory_report against the live nets of earlier phases, exactly (its
    param bytes and Adam moments against the training phase's net, the
    zero1 moments at dp = 2 against world-2 rank 0's), and its estimate
    for a [32, 256] step beside the step's measured peak (ResNet-50's at
    64 too, ungated); kv_pool_plan against the serving engine's pool, and
    against an engine under a byte budget built here for one request;
    the budget constants against the card."""
    from deeplearning4j_tpu_torch.analysis import memory as mem
    from deeplearning4j_tpu_torch.analysis.findings import Severity
    props = torch.cuda.get_device_properties(0)
    gpt = gpt_decoder(**SLICE)
    confs = {
        "gpt": (gpt, TRAIN_BATCH, None),
        "char_rnn": (char_rnn_lstm(**LSTM_SLICE), LSTM_TRAIN_BATCH[0], None),
        "lenet": (lenet_mnist(), LENET_BATCH, None),
        "vgg16": (vgg16_cifar10(), VGG_BATCH, None),
        "resnet50": (resnet50(), RESNET_BATCH, None),
        "keras_twin": (LIVE["keras_conf"], LSTM_BATCH[0], None),
        "moe_mlp": (moe_dp_conf(), MOE_DP_BATCH, {"dp": PAR_WORLD}),
    }
    findings, errors, validate_ms = {}, {}, {}
    for name, (conf, batch, mesh) in confs.items():
        t0 = time.perf_counter()
        got = conf.validate(mesh=mesh, batch_size=batch)
        validate_ms[name] = (time.perf_counter() - t0) * 1e3
        findings[name] = [f"{f.rule} {f.severity} {f.location}" for f in got]
        errors[name] = [str(f) for f in got if f.severity == Severity.ERROR]
    live = LIVE["gpt_train"]
    rep = gpt.memory_report(batch_size=TRAIN_BATCH)
    zero1 = mem.memory_report(gpt, batch_size=TRAIN_BATCH,
                              weight_update_sharding="zero1", dp=PAR_WORLD)
    rank0_zero1 = LIVE["world2"]["ranks"][0]["zero1"]["state_bytes_rank"]
    resnet = {}
    for dtype in ("float32", "bfloat16"):
        r = mem.memory_report(resnet50(dtype=dtype), batch_size=RESNET_BATCH)
        resnet[dtype] = dict(total_hbm_bytes=r.total_hbm_bytes,
                             measured_peak_bytes=LIVE[
                                 f"resnet50_{dtype}_peak_bytes"],
                             params=r.total_params)
    engine = LIVE["engine"]
    plan = mem.kv_pool_plan(gpt, engine["max_rows"])
    # an engine under a byte budget of 20.5 page groups: 20 usable pages
    pgb = mem.kv_page_group_bytes(gpt)
    budget = 20 * pgb + pgb // 2
    net = ComputationGraph(gpt, device="cuda").init()
    sched = GenerationScheduler(max_rows=SERVE_ROWS,
                                cache_budget_bytes=budget)
    try:
        answer = sched.submit("gpt", net, threading.Lock(), [1, 2, 3, 4, 5],
                              4, Deadline(120.0))
        eng = sched._engines["gpt"]
        budgeted = dict(page_len=eng.page_len, total_pages=eng.total_pages,
                        pool_bytes=eng.pool_bytes,
                        tokens=len(answer["tokens"]))
    finally:
        sched.stop()
    del net
    plan_b = mem.kv_pool_plan(gpt, SERVE_ROWS, budget_bytes=budget)
    rec = dict(
        phase="analysis", nvidia_smi=smi, findings=findings,
        validate_ms=validate_ms,
        device_total_memory=props.total_memory,
        default_hbm_bytes=mem.DEFAULT_HBM_BYTES,
        device_l2_bytes=props.L2_cache_size, l2_bytes=mem.L2_BYTES,
        gpt=dict(total_params=rep.total_params,
                 param_bytes=rep.param_bytes,
                 live_param_bytes=live["param_bytes"],
                 updater_state_bytes=rep.updater_state_bytes,
                 live_moment_bytes=live["moment_bytes"],
                 zero1_updater_state_bytes=zero1.updater_state_bytes,
                 world2_rank0_zero1_moment_bytes=rank0_zero1,
                 step=[TRAIN_BATCH, SLICE["seq_len"]],
                 total_hbm_bytes=rep.total_hbm_bytes,
                 activation_bytes=rep.activation_bytes,
                 measured_step_peak_bytes=live["step_peak_bytes"],
                 vmem_pressure=rep.vmem_pressure()),
        resnet50=dict(batch=RESNET_BATCH, **resnet),
        kv_pool=dict(plan=dict(page_len=plan.page_len,
                               total_pages=plan.total_pages,
                               total_bytes=plan.total_bytes),
                     engine=engine, budget_bytes=budget,
                     plan_budget=dict(page_len=plan_b.page_len,
                                      total_pages=plan_b.total_pages,
                                      total_bytes=plan_b.total_bytes),
                     engine_budget=budgeted))
    emit(rec)
    check(not any(errors.values()), f"configs with ERROR findings: {errors}")
    check(props.total_memory == mem.DEFAULT_HBM_BYTES
          and props.L2_cache_size == mem.L2_BYTES,
          f"the card has {props.total_memory} bytes and an L2 of "
          f"{props.L2_cache_size}; analysis/memory.py assumes "
          f"{mem.DEFAULT_HBM_BYTES} and {mem.L2_BYTES}")
    check(rep.total_params == 25_384_448
          and rep.param_bytes == live["param_bytes"]
          and rep.updater_state_bytes == live["moment_bytes"]
          and zero1.updater_state_bytes == rank0_zero1,
          f"the GPT's memory_report against the live nets: {rec['gpt']}")
    check(plan.page_len == engine["page_len"]
          and plan.total_pages == engine["total_pages"]
          and plan.total_bytes == engine["pool_bytes"]
          and plan_b.page_len == budgeted["page_len"]
          and plan_b.total_pages == budgeted["total_pages"]
          and plan_b.total_bytes == budgeted["pool_bytes"]
          and plan_b.total_pages < plan.total_pages,
          f"kv_pool_plan against the engines: {rec['kv_pool']}")



# ---------------------------------------------------------------------------
# the cost model, the watchers and the autotuner (ROADMAP A7.4)
# ---------------------------------------------------------------------------

#: the GPT's cost batch on the card, and its CPU twin's rows (the count is
#: linear in the rows: the card's is COST_TWIN_SCALE times the twin's)
COST_ROWS, COST_TWIN_ROWS = 32, 2
#: the card's count against the CPU twin's (relative), and the band the
#: GPT's count must lie in against 6 N tokens + 12 L T d tokens
TOL_COST_TWIN, COST_BAND = 1e-3, (0.9, 1.2)
#: the autotune of the full-width GPT at world 1
AUTOTUNE_TOP_K, AUTOTUNE_PROBE_STEPS = 2, 2


class CompileTally:
    """What the port's compile sites report, counted two ways from
    ``install``: a ``CompileWatcher`` on a registry of its own, and the
    compiles the serving engines and gateways count themselves
    (``GenerationScheduler._count_capture``,
    ``BatchScheduler._count_compile``), less the eager runners they
    count for a CPU model (a step runner that is not graphed), which
    capture nothing; and the kernel sources that had no library when it
    was installed (the nvcc builds this process runs)."""

    def install(self):
        from deeplearning4j_tpu_torch.keras.batching import (
            BatchScheduler, PredictRunner,
        )
        from deeplearning4j_tpu_torch.keras.generation import StepRunner
        self.registry = MetricsRegistry()
        self.watcher = CompileWatcher(registry=self.registry,
                                      tracer=Tracer()).install()
        self.to_build = [n for n in KERNELS if not library_path(n).exists()]
        self.reported = self.eager = 0
        self._saved = []

        def tally(cls, name, after):
            real = getattr(cls, name)

            def counted(obj, *args, **kw):
                out = real(obj, *args, **kw)
                after(obj)
                return out
            self._saved.append((cls, name, real))
            setattr(cls, name, counted)

        def reported(_):
            self.reported += 1

        def eager(runner):
            self.eager += not runner.graphed
        tally(GenerationScheduler, "_count_capture", reported)
        tally(BatchScheduler, "_count_compile", reported)
        tally(StepRunner, "__init__", eager)
        tally(PredictRunner, "__init__", eager)
        return self

    @property
    def captures(self) -> int:
        """The captures the engines and gateways reported."""
        return self.reported - self.eager

    def uninstall(self) -> None:
        self.watcher.uninstall()
        for cls, name, real in self._saved:
            setattr(cls, name, real)


COMPILES = CompileTally()


def cost_gpt(smi) -> dict:
    """The full-width GPT's cost on the card at [32, 256] against its CPU
    twin at [2, 256] and the 6 N tokens + 12 L T d tokens rule, with the
    analytic MFU at the training phase's measured step."""
    B, T = COST_ROWS, SLICE["seq_len"]
    batch = text_batches(1, B, T, SEED + 90)[0]
    net = par_gpt()
    t0 = time.perf_counter()
    card = net.cost_analysis(batch)
    card_s = time.perf_counter() - t0
    twin = ComputationGraph(gpt_decoder(**SLICE), device="cpu").init()
    t0 = time.perf_counter()
    cpu = twin.cost_analysis(DataSet(batch.features[:COST_TWIN_ROWS],
                                     batch.labels[:COST_TWIN_ROWS]))
    cpu_s = time.perf_counter() - t0
    N, L, d = net.num_params(), SLICE["n_layers"], SLICE["d_model"]
    tokens = B * T
    rule = 6 * N * tokens + 12 * L * T * d * tokens
    step_ms = LIVE["gpt_train"]["step_ms"]
    scale = B // COST_TWIN_ROWS
    rec = dict(card=card, cpu_twin=cpu, card_s=card_s, cpu_twin_s=cpu_s,
               twin_rel=abs(card["flops_per_step"]
                            - scale * cpu["flops_per_step"])
               / (scale * cpu["flops_per_step"]),
               rule_flops=rule, vs_rule=card["flops_per_step"] / rule,
               params=N, tokens=tokens, train_step_ms=step_ms,
               analytic_mfu=analytic_mfu(card["flops_per_step"],
                                         step_ms * 1e-3,
                                         card["peak_flops_per_chip"]),
               nvidia_smi=smi)
    check(card["device_kind"] == torch.cuda.get_device_name(0)
          and card["peak_flops_per_chip"] == peak_flops(
              torch.cuda.get_device_name(0)),
          f"the card's cost names {card['device_kind']} at "
          f"{card['peak_flops_per_chip']}")
    check(rec["twin_rel"] <= TOL_COST_TWIN,
          f"the GPT's FLOPs on the card {card['flops_per_step']} are not "
          f"{scale} x the CPU twin's {cpu['flops_per_step']}")
    check(COST_BAND[0] <= rec["vs_rule"] <= COST_BAND[1],
          f"the GPT's FLOPs {card['flops_per_step']} are {rec['vs_rule']}x "
          f"6 N tokens + 12 L T d tokens = {rule}")
    return rec


def cost_char_rnn() -> dict:
    """The char-RNN's [32, 200] cost on the card against its CPU twin's:
    K2's and K3's formulas counted where the counter sees no kernel."""
    (B, T) = LSTM_TRAIN_BATCH
    batch = text_batches(1, B, T, SEED + 91)[0]
    card = MultiLayerNetwork(char_rnn_lstm(**LSTM_SLICE),
                             device="cuda").init().cost_analysis(batch)
    cpu = MultiLayerNetwork(char_rnn_lstm(**LSTM_SLICE),
                            device="cpu").init().cost_analysis(batch)
    rel = abs(card["flops_per_step"] - cpu["flops_per_step"]) \
        / cpu["flops_per_step"]
    check(rel <= TOL_COST_TWIN,
          f"the char-RNN's FLOPs on the card {card['flops_per_step']} are "
          f"not the CPU twin's {cpu['flops_per_step']}")
    return dict(card=card, cpu_twin=cpu, twin_rel=rel)


def cost_resnet() -> dict:
    """ResNet-50 f32 at 64: its cost on the card and the analytic MFU at
    the CNN phase's measured f32 step (printed, not gated)."""
    rng = np.random.default_rng(SEED + 92)
    B, S, C = RESNET_BATCH, RESNET_HW, RESNET_CLASSES
    batch = DataSet(rng.random((B, S, S, 3), dtype=np.float32),
                    np.eye(C, dtype=np.float32)[rng.integers(0, C, B)])
    net = ComputationGraph(resnet50(dtype="float32"), device="cuda").init()
    c = net.cost_analysis(batch)
    step_ms = LIVE["resnet50_float32_step_ms"]
    return dict(card=c, train_step_ms=step_ms,
                analytic_mfu=analytic_mfu(c["flops_per_step"],
                                          step_ms * 1e-3,
                                          c["peak_flops_per_chip"]))


def traced_probe(records):
    """A probe function for ``autotune``: ``measure_candidate`` with each
    step's K4 / K5 / K6 launches counted and its warm-up step traced,
    the kernels read by symbol and input type, into ``records`` by the
    candidate's slug."""
    from deeplearning4j_tpu_torch.autotune.probe import measure_candidate
    from deeplearning4j_tpu_torch.parallel import ParallelTrainer
    names = ("flash_attn_fwd", "flash_attn_dq", "flash_attn_dkv")

    def probe(net, cand, batch, **kw):
        rec = records.setdefault(cand.slug(), dict(
            steps=[], traced=None, accum=cand.gradient_accumulation,
            precision=cand.precision))
        fit = ParallelTrainer.fit_batch

        def fit_batch(trainer, b):
            before = counts()
            if rec["traced"] is None:
                out, _, kernels = traced_window(lambda: fit(trainer, b))
                rec["traced"] = {
                    n: {dt: sum(c for k, c, _ in kernels if n in k
                                and ("bfloat16" in k) == (dt == "bfloat16"))
                        for dt in ("bfloat16", "float32")}
                    for n in ATTENTION_KERNELS}
            else:
                out = fit(trainer, b)
            after = counts()
            rec["steps"].append({n: after[n] - before[n] for n in names})
            return out
        ParallelTrainer.fit_batch = fit_batch
        try:
            return measure_candidate(net, cand, batch, **kw)
        finally:
            ParallelTrainer.fit_batch = fit
    return probe


def cost_autotune_gpt(smi) -> dict:
    """An autotune of the full-width GPT at world 1 (every shortlisted
    candidate probed, its steps' K4-K6 counted and traced), then the
    tuned trainer bitwise against a hand-built one for 2 steps (their
    device memory sampled by a ``DeviceMemoryWatermark``), and the
    config's save / load."""
    from deeplearning4j_tpu_torch.autotune import TunedConfig, autotune
    from deeplearning4j_tpu_torch.autotune import model as cost_model
    from deeplearning4j_tpu_torch.autotune import tuner as tuner_mod
    from deeplearning4j_tpu_torch.autotune.space import default_candidate
    from deeplearning4j_tpu_torch.parallel import MeshContext, ParallelTrainer
    B, T, L = COST_ROWS, SLICE["seq_len"], SLICE["n_layers"]
    batch = text_batches(1, B, T, SEED + 93)[0]
    net = par_gpt()
    records = {}
    t0 = time.perf_counter()
    tuned = autotune(net, batch=batch, global_batch=B, top_k=AUTOTUNE_TOP_K,
                     probe_steps=AUTOTUNE_PROBE_STEPS,
                     probe_fn=traced_probe(records))
    tune_s = time.perf_counter() - t0
    # the shortlist autotune probes: the analytic top-k and the default
    survivors, _ = tuner_mod.analytic_search(
        cost_model.census_from_net(net, batch), 1, B,
        hardware=cost_model.Hardware.detect(net.device))
    shortlist = [c.slug() for c, _ in survivors[:AUTOTUNE_TOP_K]]
    default = default_candidate(1, B).slug()
    if default not in shortlist:
        shortlist.append(default)
    probes = {p.config: p for p in tuned.probes}
    check(tuned.search["probes"] == len(shortlist)
          and sorted(probes) == sorted(shortlist),
          f"autotune probed {sorted(probes)}, not the shortlist "
          f"{sorted(shortlist)}")
    for slug, rec in records.items():
        want = L * rec["accum"]
        dt = "bfloat16" if rec["precision"] == "bf16" else "float32"
        check(all(st == dict(flash_attn_fwd=want, flash_attn_dq=want,
                             flash_attn_dkv=want) for st in rec["steps"])
              and len(rec["steps"]) == 1 + AUTOTUNE_PROBE_STEPS,
              f"probe {slug}: K4 / K5 / K6 a step {rec['steps']}, not "
              f"{L} a microbatch x {rec['accum']}")
        check(all(v[dt] == want and sum(v.values()) == want
                  for v in rec["traced"].values()),
              f"probe {slug}: the traced step holds {rec['traced']}, not "
              f"{want} {dt} launches of each")
    check(tuned.measured_step_s <= probes[default].measured_step_s,
          f"the winner {tuned.candidate.slug()} measured "
          f"{tuned.measured_step_s} s, slower than the default's "
          f"{probes[default].measured_step_s}")

    # the tuned trainer against a hand-built one, bit for bit, with the
    # device memory sampled over the tuned run
    wm = DeviceMemoryWatermark(registry=MetricsRegistry(), interval_s=0.005)

    def run(build, watch=False):
        fresh = par_gpt()
        trainer = build(fresh)
        if watch:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            wm.start()
        losses = [trainer.fit_batch(batch) for _ in range(2)]
        torch.cuda.synchronize()
        peak = None
        if watch:
            wm.sample()
            peak = torch.cuda.max_memory_allocated()
            wm.stop()
        flat = torch.cat([t.reshape(-1) for t in
                          tree_leaves(fresh.params)]).cpu().numpy()
        return [float(x) for x in losses], flat, peak
    before = set(threading.enumerate())
    tuned_run = run(lambda n: tuned.trainer(n), watch=True)
    sampler_gone = set(threading.enumerate()) <= before
    hand_run = run(lambda n: ParallelTrainer(
        n, MeshContext.create(device="cuda"), **tuned.trainer_kwargs()))
    bitwise = (tuned_run[0] == hand_run[0]
               and tuned_run[1].tobytes() == hand_run[1].tobytes())
    check(bitwise, f"the tuned trainer's losses {tuned_run[0]} (or params) "
                   f"differ from the hand-built one's {hand_run[0]}")
    check(wm.watermark_bytes >= tuned_run[2] and sampler_gone,
          f"the memory watermark {wm.watermark_bytes} is below the step's "
          f"peak {tuned_run[2]}, or its thread outlived stop()")
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "tuned.json")
        tuned.save(path)
        round_trip = TunedConfig.load(path) == tuned
    check(round_trip, "TunedConfig.save then load differs")
    return dict(
        winner=tuned.candidate.slug(), tune_s=tune_s, shortlist=shortlist,
        search=tuned.search, predicted_mfu=tuned.predicted_mfu,
        probes=[dict(config=p.config, predicted_s=p.predicted_step_s,
                     measured_s=p.measured_step_s,
                     gap=p.measured_vs_predicted_gap, warmup_s=p.compile_s,
                     launches_per_step=records[p.config]["steps"],
                     traced_warmup=records[p.config]["traced"])
                for p in tuned.probes],
        tuned_vs_hand_bitwise=bitwise, losses=tuned_run[0],
        watermark_bytes=wm.watermark_bytes,
        max_memory_allocated=tuned_run[2], sampler_gone=sampler_gone,
        save_load_round_trip=round_trip, nvidia_smi=smi)


def cost_autotune(smi) -> dict:
    """The cost model on the card (the GPT against its CPU twin and the
    6 N tokens rule, the char-RNN against its twin, ResNet-50), the
    autotune of the full-width GPT, and the compile watcher's counts
    since the start of the run against what the engines, the gateways and
    the builds reported. Returns the phase's K4-K6 launches."""
    gpt = cost_gpt(smi)
    rnn = cost_char_rnn()
    resnet = cost_resnet()
    reset_counts()
    tune = cost_autotune_gpt(smi)
    launched = counts()
    watched = COMPILES.watcher.counts()
    COMPILES.uninstall()
    compiles = dict(watched=watched, reported_captures=COMPILES.captures,
                    reported_compiles=COMPILES.reported,
                    eager_runners=COMPILES.eager,
                    nvcc_builds_expected=len(COMPILES.to_build),
                    built=COMPILES.to_build,
                    capture_seconds=COMPILES.registry.counter(
                        "cuda_graph_capture_seconds_total").value,
                    nvcc_seconds=COMPILES.registry.counter(
                        "nvcc_build_seconds_total").value)
    check(watched["cuda_graph"] == COMPILES.captures
          and watched["nvcc"] == len(COMPILES.to_build),
          f"the compile watcher counted {watched}, the engines and gateways "
          f"reported {COMPILES.captures} captures ({COMPILES.reported} "
          f"compiles, {COMPILES.eager} of them eager CPU runners) and "
          f"{len(COMPILES.to_build)} sources were built")
    check(all(launched[n] > 0 for n in ("flash_attn_fwd", "flash_attn_dq",
                                        "flash_attn_dkv")),
          f"the autotune's path launched {launched}")
    emit(dict(phase="cost_autotune", nvidia_smi=smi, gpt=gpt, char_rnn=rnn,
              resnet50_f32=resnet, autotune=tune, compiles=compiles,
              launches=launched))
    print(f"cost_autotune: {smi}: GPT {gpt['card']['flops_per_step']:.4e} "
          f"FLOP a [32, 256] step ({gpt['vs_rule']:.3f}x the rule), "
          f"analytic MFU {gpt['analytic_mfu']:.4f} at the measured "
          f"{gpt['train_step_ms']:.2f} ms fit_batch; ResNet-50 f32 "
          f"{resnet['card']['flops_per_step']:.4e} FLOP, MFU "
          f"{resnet['analytic_mfu']:.4f} at {resnet['train_step_ms']:.2f} "
          f"ms; autotune winner {tune['winner']}: " + "; ".join(
              f"{p['config']} predicted {p['predicted_s']:.6f} s, measured "
              f"{p['measured_s']:.6f} s, gap {p['gap']:.2f}x"
              for p in tune["probes"]), flush=True)
    return launched


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 1. device -------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    # every compile of the run: the nvcc builds below, the engines' and
    # gateways' CUDA-graph captures (checked in cost_autotune)
    COMPILES.install()
    pad_counts()
    t0 = time.perf_counter()
    build_libraries(list(KERNELS))
    build_s = time.perf_counter() - t0
    emit(dict(phase="import_rule", **import_rule()))
    emit(dict(phase="device", nvidia_smi=smi,
              name=torch.cuda.get_device_name(0),
              torch=torch.__version__, cuda=torch.version.cuda,
              kernel_build_s=build_s))
    ptxas = ptxas_report(["flash_attn_fwd", "flash_attn_dq",
                          "flash_attn_dkv"])
    ptxas_lstm = ptxas_report(["lstm_fwd_infer", "lstm_fwd_train",
                               "lstm_bwd"])
    emit(dict(phase="ptxas", kernels=ptxas + ptxas_lstm))

    def no_spill(recs):
        return all(r.get("registers") and r.get("spill_stores") == 0 and
                   r.get("spill_loads") == 0 for r in recs)
    check(len(ptxas) == 30 and no_spill(ptxas),
          "K4 / K5 / K6: ptxas reports a spill, or not 3 kernels x 2 types "
          f"x 5 head-dim templates (32, 64, 128, 256, wide): {ptxas}")
    check(len(ptxas_lstm) == 12 and no_spill(ptxas_lstm),
          "K1 / K2 / K3: ptxas reports a spill, or not 3 kernels x 2 types "
          f"x 2 bodies (streaming, resident): {ptxas_lstm}")

    # ---- 2. kernels against their plain versions ---------------------------
    a = kernel_case("a_slice", 32, 8, 256, 64, True, torch.float32, None,
                    timed=True)
    kernel_case("b_T300_masked", 2, 8, 300, 64, True, torch.float32,
                "holes")
    kernel_case("c_D8_full", 4, 8, 256, 8, False, torch.float32, None)
    # the bf16 GPT's shape (train_features): timed beside SDPA in bf16
    a16 = kernel_case("d_bf16", 32, 8, 256, 64, True, torch.bfloat16, None,
                      timed=True)
    kernel_case("e_slice_half_keys", 32, 8, 256, 64, True, torch.float32,
                "half", timed=True)
    f = kernel_case("f_slice_padded", 32, 8, 256, 64, True, torch.float32,
                    "padded", timed=True)
    kernel_case("g_D128", 8, 4, 256, 128, True, torch.float32, "holes")
    kernel_case("g_D128_bf16", 8, 4, 256, 128, True, torch.bfloat16,
                "holes")
    kernel_case("h_D32", 8, 8, 200, 32, True, torch.float32, "half")
    wide = (WIDE_BATCH, WIDE_SLICE["n_heads"], 256, 256, True)
    kernel_case("i_D256_masked", *wide, torch.float32, "holes")
    kernel_case("i_D256_bf16", *wide, torch.bfloat16, "padded")
    i = kernel_case("i_D256_wide_slice", *wide, torch.float32, None,
                    timed=True)
    # heads past 256: the wide template (o's columns in chunks of 256)
    kernel_case("j_D320_masked", 2, 4, 256, 320, True, torch.float32,
                "holes", timed=True)
    kernel_case("j_D512_bf16", WIDE_BATCH, 2, 256, 512, True,
                torch.bfloat16, "padded", timed=True)
    kernel_case("j_D1024_T128", 4, 2, 128, 1024, True, torch.float32, None,
                timed=True)
    w512 = (WIDE_BATCH, WIDE512_SLICE["n_heads"], 256, 512, True)
    j = kernel_case("j_D512_wide_slice", *w512, torch.float32, None,
                    timed=True)
    (B, T), H = LSTM_BATCH, LSTM_SLICE["hidden"]
    k1 = lstm_case("a_slice", T, B, H, torch.float32, True, False,
                   timed=True)
    lstm_case("b_ragged_carry", 7, 3, 100, torch.float32, True, True)
    lstm_case("c_stream_T1", 1, B, H, torch.float32, True, True, timed=True)
    lstm_case("d_bf16", T, B, H, torch.bfloat16, True, False, stepwise=True)
    k1e = lstm_case("e_no_peephole", T, B, H, torch.float32, False, False,
                    timed=True, library=True)
    # the resident body's widest H, and the first H past it (streaming)
    res = RESIDENT_MAX_HIDDEN[torch.float32]
    lstm_case("f_resident_widest", 9, 11, res, torch.float32, True, True,
              timed=True)
    lstm_case("f_resident_widest_bf16", 9, 11,
              RESIDENT_MAX_HIDDEN[torch.bfloat16], torch.bfloat16, True,
              True)
    lstm_case("g_streaming_narrowest", 9, 11, res + 1, torch.float32, True,
              True, timed=True)
    lstm_case("h_stream_T1_B1", 1, 1, H, torch.float32, True, True,
              timed=True)
    (Bt, Tt), W = LSTM_TRAIN_BATCH, char_rnn_lstm(
        **LSTM_SLICE).training.tbptt_fwd_length
    k23 = lstm_train_case("a_slice", W, Bt, H, torch.float32, True, False,
                          timed=True)
    lstm_train_case("b_ragged_carry", 7, 3, 100, torch.float32, True, True)
    lstm_train_case("c_last_window", 64 - W, Bt, H, torch.float32, True,
                    True)
    # the bf16 char-RNN's window (train_features): timed beside cuDNN's
    # bf16 LSTM
    k23b = lstm_train_case("d_bf16", W, Bt, H, torch.bfloat16, True, False,
                           timed=True)
    lstm_train_case("e_no_peephole", W, Bt, H, torch.float32, False, False)
    lstm_train_case("f_widest", 3, 2, MAX_HIDDEN, torch.float32, True, True)
    lstm_train_case("g_resident_widest", 9, 11, res, torch.float32, True,
                    True, timed=True)
    lstm_train_case("h_streaming_narrowest", 9, 11, res + 1, torch.float32,
                    True, True, timed=True)
    # K3's widest resident H in bf16 (below K2's) and the first past it
    res3 = BWD_RESIDENT_MAX_HIDDEN[torch.bfloat16]
    lstm_train_case("i_bwd_resident_widest_bf16", 9, 11, res3,
                    torch.bfloat16, True, True)
    lstm_train_case("j_bwd_streaming_narrowest_bf16", 9, 11, res3 + 1,
                    torch.bfloat16, True, True)
    g = bwd_case("a_slice", 32, 8, 256, 64, True, torch.float32, None,
                 timed=True)
    bwd_case("b_T300_masked", 2, 8, 300, 64, True, torch.float32, "holes")
    bwd_case("c_D8_full", 4, 8, 256, 8, False, torch.float32, None)
    g16 = bwd_case("d_bf16", 32, 8, 256, 64, True, torch.bfloat16, None,
                   timed=True)
    bwd_case("e_slice_half_keys", 32, 8, 256, 64, True, torch.float32,
             "half", timed=True)
    bwd_case("f_slice_padded", 32, 8, 256, 64, True, torch.float32,
             "padded", timed=True)
    bwd_case("g_D256_masked", *wide, torch.float32, "holes")
    bwd_case("g_D256_bf16", *wide, torch.bfloat16, "padded")
    gi = bwd_case("g_D256_wide_slice", *wide, torch.float32, None,
                  timed=True)
    bwd_case("h_D320_masked", 2, 4, 256, 320, True, torch.float32, "holes",
             timed=True)
    bwd_case("h_D512_bf16", WIDE_BATCH, 2, 256, 512, True, torch.bfloat16,
             "padded", timed=True)
    bwd_case("h_D1024_T128", 4, 2, 128, 1024, True, torch.float32, None,
             timed=True)
    gj = bwd_case("h_D512_wide_slice", *w512, torch.float32, None,
                  timed=True)

    # ---- 3. the slice: full-width GPT serving on the card ------------------
    flash_launches = timed("slice", gpt_slice, a["ms"])

    # ---- 4. the slice: full-width char-RNN serving on the card -------------
    lstm_launches = timed("lstm_slice", lstm_slice, k1["ms"])

    # ---- 5. the slice: full-width GPT training on the card ----------------
    train_path = timed("train_slice", train_slice)

    # ---- 6. the slice: full-width char-RNN training on the card ----------
    lstm_train_path = timed("lstm_train_slice", lstm_train_slice)

    # ---- 7. wide heads on the card: 256 (the widest register template),
    # 512 (the wide template) --------------------------------------------
    wide_path = timed("wide_head_256", wide_head_slice, WIDE_SLICE)
    wide512_path = timed("wide_head_512", wide_head_slice,
                         WIDE512_SLICE)

    # ---- 8. the CNN classifiers on the card: LeNet-5, VGG-16-CIFAR,
    # ResNet-50 (no kernel of K1-K6 on this path) ---------------------------
    timed("cnn_slice", cnn_slice)

    # ---- 9. the token-level serving engine on the card: CUDA graphs per
    # bucket over the block-paged KV pool (no kernel of K1-K6 on this path)
    timed("serve_engine", serve_engine)

    # ---- 10. ModelSerializer archives on the card: the GPT, the char-RNN
    # and ResNet-50 round trips, a served reload, integrity ------------------
    timed("checkpoint", checkpoint_phase)

    # ---- 11. the predict server on the card: KerasServer / KerasClient
    # over TCP, a CUDA graph per predict bucket replaying K1 and K4 ---------
    server_path = timed("serve_server", serve_server)
    served, fitted = server_path["main_path"], server_path["fit"]
    fitted_keras = server_path["fit_keras"]

    # ---- 12. the Keras import: the char-RNN's Keras twin on the card (K1),
    # TransferLearning and early stopping (K2/K3), the golden fixtures ----
    keras = timed("keras_transfer", keras_transfer, smi)

    # ---- 13. the single-card training features: bf16 GPT (K4-K6 in bf16)
    # and char-RNN (K2/K3 in bf16), listeners, sentinel, remat, scan
    # windows, the prefetching iterator, solvers, ROC / regression --------
    tf_path = timed("train_features", train_features)
    tf_gpt, tf_lstm = tf_path["gpt"], tf_path["char_rnn"]

    # ---- 14. the serving fleet: FleetRouter over three FleetReplica
    # gateways, failover, rolling restart, autoscale and brownout ---------
    fleet = timed("serve_fleet", serve_fleet)
    fleet_launched = fleet["launched"]

    # ---- 15. the data-parallel trainers: world 1 over NCCL here, world 2
    # over gloo in two processes on this card, sharded checkpoints ---------
    par = timed("train_parallel", train_parallel, smi)

    # ---- 16. the static analysis: every config validated, the GPT's
    # memory plan against the live nets and the serving engine's pool -----
    timed("analysis", analysis, smi)

    # ---- 17. the cost model, the watchers and the autotuner: the GPT's,
    # the char-RNN's and ResNet-50's counts on the card, an autotune of the
    # full-width GPT (K4-K6 in each probe, bf16 among them) --------------
    tuned_launched = timed("cost_autotune", cost_autotune, smi)

    # ---- 18. summary of every ported kernel -------------------------------
    emit({"kernels": [
        dict(name="flash_attn_fwd", route="cuda",
             source="deeplearning4j_tpu_torch/csrc/flash_attn_fwd.cu",
             replaces="deeplearning4j_tpu/ops/pallas_attention.py:72",
             # serving, training and the predict server's captures (a
             # captured launch replays with every batch of its bucket)
             launches=flash_launches + train_path["flash_attn_fwd"]
             + served["flash_attn_fwd"] + tf_gpt["flash_attn_fwd"]
             + fleet_launched["flash_attn_fwd"] + par["flash_attn_fwd"]
             + tuned_launched["flash_attn_fwd"],
             launches_train_parallel=par["flash_attn_fwd"],
             launches_cost_autotune=tuned_launched["flash_attn_fwd"],
             launches_serve_fleet=fleet_launched["flash_attn_fwd"],
             replays_serve_fleet_traced_wave=fleet["traced"]["gpt"],
             launches_serve_fleet_traced_failover=fleet["reprefill_k4"],
             launches_bf16_train_features=tf_gpt["flash_attn_fwd"],
             ms_bf16=a16["ms"], plain_ms_bf16=a16["plain_ms"],
             bound_ms_bf16=a16["bound_ms"], bound_by_bf16=a16["bound_by"],
             library_ms_bf16=a16["library_ms"],
             max_abs_err_bf16=a16["max_abs_err_o"],
             launches_serve_server=served["flash_attn_fwd"],
             replays_per_bucket_serve_server=SLICE["n_layers"],
             launches_d256=wide_path["flash_attn_fwd"],
             max_abs_err=a["max_abs_err_o"],
             ms=a["ms"], plain_ms=a["plain_ms"], bound_ms=a["bound_ms"],
             bound_by=a["bound_by"], bound_peak=a["bound_peak"],
             bound_ms_simt=a["bound_ms_simt"], library_ms=a["library_ms"],
             ms_padded=f["ms"], ms_d256=i["ms"],
             bound_ms_d256=i["bound_ms"], library_ms_d256=i["library_ms"],
             launches_wide=wide512_path["flash_attn_fwd"], ms_wide=j["ms"],
             bound_ms_wide=j["bound_ms"], library_ms_wide=j["library_ms"],
             wide_case="heads of 512: B=8, H=2, T=256, causal, f32"),
        dict(name="lstm_fwd_infer", route="cuda",
             source="deeplearning4j_tpu_torch/csrc/lstm_fwd_infer.cu",
             replaces="deeplearning4j_tpu/ops/pallas_kernels.py:99",
             # serving, the heads of tBPTT windows when bwd < fwd, the
             # predict server's captures (the Keras twin's among them)
             # and the imported Keras models
             launches=lstm_launches + lstm_train_path["lstm_fwd_infer"]
             + served["lstm_fwd_infer"] + fleet_launched["lstm_fwd_infer"]
             + keras["lstm_fwd_infer"],
             launches_keras_transfer=keras["lstm_fwd_infer"],
             launches_serve_fleet=fleet_launched["lstm_fwd_infer"],
             replays_serve_fleet_traced_wave=fleet["traced"]["char_rnn"],
             launches_serve_server=served["lstm_fwd_infer"],
             replays_per_bucket_serve_server=LSTM_SLICE["layers"],
             max_abs_err=max(k1["max_abs_err_hs"], k1["max_abs_err_hT"]),
             ms=k1["ms"], plain_ms=k1["plain_ms"], bound_ms=k1["bound_ms"],
             bound_by=k1["bound_by"], bound_peak=k1["bound_peak"],
             bound_ms_simt=k1["bound_ms_simt"],
             body=k1["plan"]["body"], plan=k1["plan"],
             library_ms=k1e["library_ms"],
             # cuDNN has no peepholes and computes the input projection
             # too: its time is held against the kernel plus x @ W + b on
             # the same inputs, not against ms
             library_vs_ms=k1e["kernel_plus_input_gemm_ms"],
             library_case="e_no_peephole: x [32, 64, 96] -> H 256, f32, "
                          "input GEMM included on both sides"),
        dict(name="flash_attn_dq", route="cuda",
             source="deeplearning4j_tpu_torch/csrc/flash_attn_dq.cu",
             replaces="deeplearning4j_tpu/ops/pallas_attention.py:152",
             launches=train_path["flash_attn_dq"] + tf_gpt["flash_attn_dq"]
             + par["flash_attn_dq"] + tuned_launched["flash_attn_dq"],
             launches_train_parallel=par["flash_attn_dq"],
             launches_cost_autotune=tuned_launched["flash_attn_dq"],
             launches_bf16_train_features=tf_gpt["flash_attn_dq"],
             ms_bf16=g16["ms_dq"], plain_ms_bf16=g16["plain_ms_dq"],
             bound_ms_bf16=g16["bound_ms_dq"],
             bound_by_bf16=g16["bound_by_dq"],
             library_ms_bf16=g16["library_ms"],
             max_abs_err_bf16=g16["max_abs_err_dq"],
             launches_d256=wide_path["flash_attn_dq"],
             ms_d256=gi["ms_dq"], bound_ms_d256=gi["bound_ms_dq"],
             library_ms_d256=gi["library_ms"],
             launches_wide=wide512_path["flash_attn_dq"], ms_wide=gj["ms_dq"],
             bound_ms_wide=gj["bound_ms_dq"], library_ms_wide=gj["library_ms"],
             max_abs_err=g["max_abs_err_dq"], ms=g["ms_dq"],
             plain_ms=g["plain_ms_dq"], bound_ms=g["bound_ms_dq"],
             bound_by=g["bound_by_dq"], bound_peak=g["bound_peak_dq"],
             bound_ms_simt=g["bound_ms_simt_dq"],
             library_ms=g["library_ms"],
             library_covers=g["library_covers"]),
        dict(name="flash_attn_dkv", route="cuda",
             source="deeplearning4j_tpu_torch/csrc/flash_attn_dkv.cu",
             replaces="deeplearning4j_tpu/ops/pallas_attention.py:192",
             launches=train_path["flash_attn_dkv"]
             + tf_gpt["flash_attn_dkv"] + par["flash_attn_dkv"]
             + tuned_launched["flash_attn_dkv"],
             launches_train_parallel=par["flash_attn_dkv"],
             launches_cost_autotune=tuned_launched["flash_attn_dkv"],
             launches_bf16_train_features=tf_gpt["flash_attn_dkv"],
             ms_bf16=g16["ms_dkv"], plain_ms_bf16=g16["plain_ms_dkv"],
             bound_ms_bf16=g16["bound_ms_dkv"],
             bound_by_bf16=g16["bound_by_dkv"],
             library_ms_bf16=g16["library_ms"],
             max_abs_err_bf16=max(g16["max_abs_err_dk"],
                                  g16["max_abs_err_dv"]),
             launches_d256=wide_path["flash_attn_dkv"],
             ms_d256=gi["ms_dkv"], bound_ms_d256=gi["bound_ms_dkv"],
             library_ms_d256=gi["library_ms"],
             launches_wide=wide512_path["flash_attn_dkv"],
             ms_wide=gj["ms_dkv"], bound_ms_wide=gj["bound_ms_dkv"],
             library_ms_wide=gj["library_ms"],
             max_abs_err=max(g["max_abs_err_dk"], g["max_abs_err_dv"]),
             ms=g["ms_dkv"], plain_ms=g["plain_ms_dkv"],
             bound_ms=g["bound_ms_dkv"], bound_by=g["bound_by_dkv"],
             bound_peak=g["bound_peak_dkv"],
             bound_ms_simt=g["bound_ms_simt_dkv"],
             library_ms=g["library_ms"],
             library_covers=g["library_covers"]),
        dict(name="lstm_fwd_train", route="cuda",
             source="deeplearning4j_tpu_torch/csrc/lstm_fwd_train.cu",
             replaces="deeplearning4j_tpu/ops/pallas_kernels.py:63",
             launches=lstm_train_path["lstm_fwd_train"]
             + fitted["lstm_fwd_train"] + tf_lstm["lstm_fwd_train"]
             + par["lstm_fwd_train"] + keras["lstm_fwd_train"]
             + fitted_keras["lstm_fwd_train"],
             launches_keras_transfer=keras["lstm_fwd_train"],
             launches_serve_server_keras_fit=fitted_keras["lstm_fwd_train"],
             launches_train_parallel=par["lstm_fwd_train"],
             launches_bf16_train_features=tf_lstm["lstm_fwd_train"],
             ms_bf16=k23b["ms_fwd"], plain_ms_bf16=k23b["plain_ms_fwd"],
             bound_ms_bf16=k23b["bound_ms_fwd"],
             bound_by_bf16=k23b["bound_by_fwd"],
             library_ms_bf16=k23b["library_ms_fwd"],
             library_vs_ms_bf16=k23b["kernel_plus_input_gemm_ms"],
             max_abs_err_bf16=max(k23b["max_abs_err_hs"],
                                  k23b["max_abs_err_gates"],
                                  k23b["max_abs_err_cs"]),
             launches_serve_server_fit=fitted["lstm_fwd_train"],
             max_abs_err=max(k23["max_abs_err_hs"],
                             k23["max_abs_err_gates"],
                             k23["max_abs_err_cs"]),
             ms=k23["ms_fwd"], plain_ms=k23["plain_ms_fwd"],
             bound_ms=k23["bound_ms_fwd"], bound_by=k23["bound_by_fwd"],
             bound_peak=k23["bound_peak_fwd"],
             bound_ms_simt=k23["bound_ms_simt_fwd"],
             body=k23["plan"]["body"], plan=k23["plan"],
             library_ms=k23["library_ms_fwd"],
             library_vs_ms=k23["kernel_plus_input_gemm_ms"],
             library_covers="cuDNN LSTM forward with grad enabled, no "
                            "peepholes, input GEMM included; held against "
                            "K2 + x @ W + b (library_vs_ms)"),
        dict(name="lstm_bwd", route="cuda",
             source="deeplearning4j_tpu_torch/csrc/lstm_bwd.cu",
             replaces="deeplearning4j_tpu/ops/pallas_kernels.py:161",
             launches=lstm_train_path["lstm_bwd"] + fitted["lstm_bwd"]
             + tf_lstm["lstm_bwd"] + par["lstm_bwd"] + keras["lstm_bwd"]
             + fitted_keras["lstm_bwd"],
             launches_keras_transfer=keras["lstm_bwd"],
             launches_serve_server_keras_fit=fitted_keras["lstm_bwd"],
             launches_train_parallel=par["lstm_bwd"],
             launches_bf16_train_features=tf_lstm["lstm_bwd"],
             ms_bf16=k23b["ms_bwd"], plain_ms_bf16=k23b["plain_ms_bwd"],
             bound_ms_bf16=k23b["bound_ms_bwd"],
             bound_by_bf16=k23b["bound_by_bwd"],
             library_ms_bf16=k23b["library_ms_bwd"],
             library_vs_ms_bf16=k23b["kernel_plus_weight_grad_gemms_ms"],
             max_abs_err_bf16=max(k23b["max_abs_err_dz"],
                                  k23b["max_abs_err_dh0"],
                                  k23b["max_abs_err_dc0"]),
             launches_serve_server_fit=fitted["lstm_bwd"],
             max_abs_err=max(k23["max_abs_err_dz"], k23["max_abs_err_dh0"],
                             k23["max_abs_err_dc0"]),
             ms=k23["ms_bwd"], plain_ms=k23["plain_ms_bwd"],
             bound_ms=k23["bound_ms_bwd"], bound_by=k23["bound_by_bwd"],
             bound_peak=k23["bound_peak_bwd"],
             bound_ms_simt=k23["bound_ms_simt_bwd"],
             body=k23["plan_bwd"]["body"], plan=k23["plan_bwd"],
             library_ms=k23["library_ms_bwd"],
             library_vs_ms=k23["kernel_plus_weight_grad_gemms_ms"],
             library_covers="cuDNN LSTM backward (dW_ih, dW_hh, biases), no "
                            "peepholes; held against K3 + the dRW and dW "
                            "GEMMs (library_vs_ms)")]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--parallel-rank"]:
        # one rank of train_parallel's world-2 group
        sys.exit(par_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
                          sys.argv[5]))
    sys.exit(main())
