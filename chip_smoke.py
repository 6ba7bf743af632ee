"""Serve, train and stream the bench.py mixing console on one NVIDIA GPU
through grafx_tpu_torch, serve and train it with FactorizedCompressor as
its compressor, run each of those paths compiled (CUDA-graph replays)
and through serving.py's exported programs, run the packaged fit loop
(mixing_console -> GraphParameterOptimizer.fit -> save/restore, with
MultitapDelay and the neural parameter predictor), serve, train and
stream the console on the default IIR backend (the frequency-sampled
FIRs, fused into FusedFIRChains), fit the gain -> delay console fused,
serve, train and stream the console with the filtered-noise reverb (on
keys) and with the feedback delay network, hold each new processor
class against the CPU at full width, render the console under every
schedule (one-by-one included), into the array buffer and batched with
``batch_grafx``, time the convolution forms, render and train the
console sharded over ``torch.distributed`` ranks, export and load the
fsm console, run the README's six examples (``examples_torch/``), hold
every library class no earlier phase ran against the CPU at full width
(gradients and streams included), serve, train and stream the console
with gain-smoothed dynamics (the dynamics chain: every walk of a
gain-smoothed run in one kernel), fit the README's single-source
builders, hold the chain at ragged shapes and against the composed path,
and check every hand-written kernel on the way.

Run from the root of the repository, on a machine with the card:

    python3 chip_smoke.py

Phases (each prints one line or more; any failure exits non-zero
before the result line):

1. device: the card's name, power limit and maximum SM clock, TF32
   switched off;
2. build: the CUDA kernels compiled from ``grafx_tpu_torch/csrc``;
3. kernels: each of the ten kernels against its plain PyTorch version
   on the card, at small shapes and at the shapes the console gives it,
   with their times beside their bounds (the plain ballistics walk #7
   also split in two, carrying its state, against one walk; #2, #5 and
   #6 also at the factorized console's gate members, 68 x 2^17; the plain
   smoother's forward with residuals #8, its adjoint #9 and the reverse
   scan #10 at N = 2, 8, 17, 68 and L = 64, 128, 200, 4096, 4109, timed
   at the factorized console's frame calls, with the host's ms to enqueue
   a call, and at 68 x 2^17, #9 and #10 also checked there, #10 also
   timed over chunk lengths 64-1024). The adjoints' chunked reverse walk
   (#10 is the same walk with its coefficient read): each line of #4,
   #6 and #9 prints its chunk length and count; #4 (68 rows) and #6 (8
   rows) are also held at forced chunk lengths (one tile, 256, the whole
   row, their own pick) on L = 4109 and 2^17 + 13, and timed at their
   console shapes over chunk lengths 64-1024 (``chunk_sweep``). The
   forward walks (a block a row): each timed line of #1, #2, #3, #5, #7
   and #8 prints its stage length T; #1, #2, #3 and #5 are also held
   against their plain versions at N = 1, 37, 68 and L = 4109, 8205 (row
   starts not 16-byte aligned), at their own T and at T = 96; at 68 x
   (2^17 + 13) each of the six forward kernels on the first 2^17 samples
   equals the first 2^17 columns of its call on the whole rows, bit for
   bit (causality); #8 at 68 x 2^17, #5 at 8 x 2^17 and #3 at 68 x 2^17
   are timed over T = 64-1024 (#3 also as two #8 walks with the knees
   between in PyTorch) (``walk_sweep``); and #3 on twice as many rows as
   the card has SMs, whose blocks share SMs, equals its call on the first
   half of the rows bit for bit and is timed beside that half;
4. exactness: the exact IIR cascade against scipy float64;
5. serve: three requests of (4, 17, 2, 2^17) through the fused console,
   with every kernel's launch count (#1 and #2 once a request, nothing
   else);
6. train: three gradient steps of ``bench_trainer(17)`` at (4, 17, 2,
   2^17), with device ms per step, peak memory, the losses, which leaves
   moved, and every kernel's launch count (#3-#6 once a step, nothing
   else);
7. grad card vs CPU: the trainer's loss and every parameter gradient at
   batch 1, L = 2^14, on the card and on the CPU;
8. card vs CPU: the served console at batch 1, L = 2^14, on the card and
   on the CPU;
9. stream: (17, 2, 2^17) through ``StreamRenderer`` in 32 blocks of
   4096, with device and host ms per block, the real-time factor, peak
   memory and every kernel's launch count (#7 twice a block, nothing
   else), the streamed output
   against the one-shot render on the card, and ``step_many`` (4 blocks)
   against single steps;
10. factorized: the console with ``FactorizedCompressor(frame_len=1024)``
    as its compressor at (4, 17, 2, 2^17): one served request (launches:
    #2 once, #7 twice, nothing else) and three gradient steps as in phase
    6 (launches per step: #5 and #6 once, #8 and #9 twice, nothing else);
11. factorized grad card vs CPU: that step's loss and every parameter
    gradient at batch 1, L = 2^14, on the card and on the CPU;
12. compiled request: ``make_render_fn(jit=True)`` (a CUDA-graph replay)
    beside ``jit=False`` at (4, 17, 2, 2^17): replays against eager (two
    inputs, and every parameter changed between replays) equal to eager
    bit for bit (COMPILED_REL), their outputs distinct, warm calls of
    each timed by CUDA events, peak memory, the capture's seconds and
    reserved memory, and the capture's launch counts;
13. and 14. compiled steps: three steps of ``bench_trainer(17)`` and of
    the factorized console with ``jit=True`` (the whole update captured)
    and three with ``jit=False`` from the same start, losses and every
    leaf equal bit for bit after each step, then timed as in 12;
15. compiled stream: the stream of phase 9 through ``StreamRenderer`` with
    and without ``jit``, in turns block by block (device and wall ms, the
    real-time factor), each block equal bit for bit; ``step_many(4)`` (one
    graph of four block steps) against eager and timed a block;
16. serving, after every timed phase: ``serving.py`` on the card, the
    console's render exported and loaded against the live render (and
    with changed parameters), the stream step exported for one block and
    for four against the live stream;
17. fit: ``mixing_console(16)`` (70 nodes) on synthetic stems (16, 2,
    2^17), seed 0; the target is the ground truth (initial parameters +
    0.3 N(0, 1)) through ``render_current``, whose capture launches #2
    once per compressor stage; ``GraphParameterOptimizer`` with its
    defaults (MR-STFT, Adam lr 1e-2, ``jit=True``) fits 20 steps, the loss
    must fall, the second step's capture launches #5 and #6 once per
    compressor stage; compiled and eager ms a step, capture seconds, peak
    memory; the first step against the CPU's at full width: render and
    loss <= -60 dB, the render's backward (the gradient of an MSE against
    the target) <= -60 dB and each leaf <= -40 dB, and the default loss's
    gradient no further from the CPU's than the CPU's own gradient moves
    when the stems move by as much as the two renders differ, plus 6 dB
    (its log-magnitude L1 term is a sum of per-bin signs; see
    ``step_card_vs_cpu``);
18. resume: ``save`` after 5 steps; a fresh optimizer takes two (its graph
    captured), then ``restore``: parameters and Adam state bit-equal to
    the saved ones and the same tensors (``data_ptr``), and 5 more steps
    whose losses equal steps 6-10 of the uninterrupted run's bit for bit;
    a ``save_session``/``load_session`` round trip onto the card;
19. delay: the fit console with ``MultitapDelay(segment_len=1500,
    num_segments=10)`` after each track's gain (86 nodes): one
    ``render_current`` and one step, and that step against the CPU's as in
    phase 17;
20. predictor: ``ParameterPredictor`` on the fit console, each node
    conditioned on its stem's ``audio_features`` (the bus and the send on
    the mix's): the first loss against the CPU's on the same weights (<=
    -60 dB), then 10 eager Adam steps through the render, the loss must
    fall (#5 and #6 once per compressor stage a step);
21. fsm serve: the console with its equalizers on the default backend,
    ``bench_processors(backend="fsm")``: its fused types (9
    ``fused(eq+geq)`` and one ``fused(eq+gain)`` node, each a
    ``FusedFIRChain``), three eager requests as in phase 5, the compiled
    request as in phase 12, card vs CPU as in phase 8, and the fsm render
    against the exact console's on the same parameters in dB (the FSM
    approximation's own gap; printed, not gated);
22. fsm train: three eager steps as in phase 6, three compiled beside
    three eager as in phase 13, the loss and every gradient card vs CPU
    as in phase 7;
23. fsm stream: the fsm console streamed as in phase 9 (eager) and as
    in phase 15 (compiled beside eager, without ``step_many``);
24. fused delay: the console of phase 19 with
    ``GraphParameterOptimizer(fuse=True)``, on the exact and on the fsm
    backend: gain -> delay folds into ``FusedFIRChain`` on the 16 tracks;
    one eager ``render_current`` (#2 once a compressor stage) and one
    eager step (#5 and #6 once a compressor stage), the fused render
    within 3e-5 of max|ref| of the unfused one; the compiled step
    captured (its launches one eager step's) and timed;
25. noise console: bench.py's console with ``FilteredNoiseShapingReverb()``
    (60000 taps, 12 bands, midside, pseudo-random) and
    ``PiecewiseTanhDistortion()``: three eager requests as in phase 5;
    requests compiled with a fresh key each (``rng``, a captured
    argument) beside eager on the same keys, each equal bit for bit, the
    same key rendering the same bit for bit and a new key another; card
    vs CPU on one key; three eager steps as in phase 6 (the distortion's
    hardness and threshold may get no gradient: its input stays below the
    threshold at init), three compiled beside three eager as in phase 13
    (the eager trainer's keyless crop pinned to the capture's), the loss
    and every gradient card vs CPU; the console streamed on a key as in
    phases 9 and 15 (without ``step_many``), against the one-shot render
    on that key;
26. FDN console: the same with ``FeedbackDelayNetwork()`` (30000 taps, 6
    lines, stereo) and ``ChebyshevDistortion()``, where a new key leaves
    the render as it was, bit for bit (nothing draws noise);
27. library: each new class at 68 x 2 x 2^17 (the filtered-noise, FDN and
    per-call STFT reverbs, the stereo tools, the three distortions) card
    vs CPU on the same parameters and key (<= -60 dB) with its device ms,
    ``PowerDistortion``'s gradient where a third of its input is exactly
    0 (finite, card vs CPU), ``DryWet`` with its weight through
    ``common_parameters`` and rng through a ``SerialChain`` rendered card
    vs CPU (the same key the same render, a new key another);
28. schedules: the exact console scheduled by ``"beam"``, ``"greedy"``,
    ``"fixed"`` (the beam's type sequence as ``fixed_order``) and
    ``"one-by-one"``: the host's set-up seconds (fusion, parameter
    migration, conversion, scheduling, plan; the native C++ beam search
    against the numpy one, which must agree), the stage count, three eager
    requests each with #1 and #2 launched once a stage of their types
    (one-by-one: once a node), each render within -120 dB of the beam
    plan's on the same parameters (rebound to each schedule's rows);
29. array buffer: the beam plan with ``buffer_mode="array"``, eager and
    compiled (its capture one eager request's launches), equal to
    ``"stages"`` bit for bit; a step of ``GraphParameterOptimizer(
    method="one-by-one")`` on the beam trainer's parameters and inputs,
    its loss and every gradient within -60 dB of the beam step's (#3-#6
    once a node), its second step captured, timed beside the beam step;
30. batched graphs: ``batch_grafx`` of four consoles (400 nodes) with
    their own parameter seeds, fused and rendered from (68, 2, 2^17), each
    console within -120 dB of its render alone (#1 and #2 once), with the
    native and numpy beam searches' seconds on the batched graph;
31. convolution forms: ``fft_convolve`` (one FFT) against
    ``fft_convolve_os`` and ``fft_convolve_upols`` (and the overlap-save
    block ``grafx_tpu`` would pick) at 68 x 2 x 2^17 with 30000 and 60000
    taps and at 68 x 2 x 2^18 with 2000, within -100 dB of one another,
    each timed by ``profiling.device_time_ms`` and by CUDA events;
    ``FIRFilter(overlap_save=True)`` against ``False``; and
    ``profiling.device_time_ms`` (a sum) beside ``device_busy_ms`` (a
    union) on the compiled request;
32. parallel: ``grafx_tpu_torch.parallel`` over ``torch.distributed``,
    each rank a process started here (``torch.multiprocessing``, a
    FileStore in a temporary directory): (a) one rank a card over NCCL
    (every card of the machine): three data-parallel steps of
    ``bench_trainer(17)`` with its render through ``shard_render_step``,
    the whole update captured, against the unsharded compiled step from
    the same start (loss and every leaf equal bit for bit), the
    capture launching #3-#6 once each and nothing else, ms a step beside
    the unsharded step's and phase 13's; a captured sharded request
    against phase 12's output; (b) NCCL's answer to two ranks on one card
    (printed), then two ranks sharing the card over gloo, eager: which
    collectives gloo takes on the card, a capture refused, the
    data-parallel request and step (2 rows a rank), the node-sharded
    request (3-dim, the fused stages' 17 chains split 9/8) and the
    time-sharded request, renders within rtol 1e-5 / atol 1e-6 and
    gradients within rtol 2e-4 / atol 1e-7 of one rank's on the card,
    with each rank's launches and the rows it launched them on; then
    phase 16 again on the fsm console (``bench_processors(backend=
    "fsm")``), its loaded programs launching what phases 21 and 23's eager
    runs launch;
33. determinism: every path above repeats bit for bit on the card with
    default settings: each of these runs twice eagerly and twice compiled
    (``jit=True``; warm-up, capture, replays), from fresh objects built
    with the same seed, and each pair is ``torch.equal`` in every output,
    loss, parameter and gradient: the exact console's request (phase 5's
    input) and three steps of ``bench_trainer(17)``, the factorized
    console's three steps, 32 stream blocks, five ``mixing_console(16)``
    fit steps on the MR-STFT loss (Adam), the fsm console's request and
    three steps, the noise and FDN consoles' requests on one fixed key,
    the exact console's request and three steps under
    ``buffer_mode="array"``, and phase 35's gain-smoothed console's
    request, three steps and 32 blocks; each line prints whether the compiled runs
    equal the eager ones bit for bit and how far apart they are.  Then, in
    a process of its own with ``CUBLAS_WORKSPACE_CONFIG=:4096:8``, the same
    paths once eagerly under ``torch.use_deterministic_algorithms(True)``:
    none may raise, and each output lies within COMPILED_REL of max|the
    default eager run's| (its bit-equality printed).  The package sets no
    such flag: the paths are deterministic by their formulation;
34. examples: the six scripts of ``examples_torch/`` through their
    ``main``, at the JAX examples' widths, lengths and step counts, each
    with every launch counter at 0 just before it and read just after,
    held to exact counts (``EXAMPLE_LAUNCHES``): ``fused_mastering`` (17
    shelf/peak/shelf/low-pass chains at (4, 17, 2, 2^17), fused against
    unfused below 1e-4, both SGD steps compiled and timed; no kernel),
    ``streaming_console`` (the unfused console, one-shot against 32
    blocks of 4096 <= -60 dB, the real-time factor, ``step_many`` at 4
    and 16 blocks; #2 once a compressor and a gate stage for the one-shot
    render, #7 once a compressor stage a block for the eager and the
    capturing calls), ``serve_stream_wav`` (eq -> geq -> comp -> gain ->
    reverb exported and served from the loaded artifact, within
    COMPILED_REL of a live ``StreamRenderer``; #7 in the artifact's eager
    and capturing blocks), ``match_mix`` (200 steps; #2 for the target, #5 and #6 for
    the eager and the capturing step), ``neural_mixing`` (150 captured
    momentum steps of the predictor; as match_mix) and ``multihost_dp``
    (two gloo ranks sharing the card: each rank's three steps launch #5
    and #6 once a step, rank 0's single-process check three more).
    While each main runs, the forward kernels' launchers keep a copy of
    the inputs of their first launch at each shape and kind
    (``KernelInputs``; multihost_dp's ranks are other processes, so its
    inputs come from one forward and backward of its console at a rank's
    and at rank 0's batch in this process); on each, every kernel of the
    family is held against its plain version (``check_path_inputs``: the
    primal, the forward and the adjoint of #2/#5/#6, #7 split in two), and
    a kernel launched on no checked input fails the phase.  match_mix's
    and neural_mixing's target render and first step at the example's
    sizes are held against the port's CPU path as phase 18 holds the fit
    console's (``example_card_vs_cpu``: target and loss <= -60 dB, the
    MSE gradient <= -60 dB and each leaf <= -40 dB, the MR-STFT gradient
    within the CPU's own spread + 6 dB);
35. library on the card (``library_card_phase``), three parts:
    (a) each class that no earlier phase ran, at 68 x 2 x 2^17: the seven
    filters ``AllPassFilter``, ``BandPassFilter``, ``BandRejectFilter``,
    ``BiquadFilter``, ``HighPassFilter``, ``PoleZeroFilter`` and
    ``StateVariableFilter`` on their default backend (fsm) and on
    ``backend="exact"``, ``ZeroPhaseFIREqualizer``,
    ``NewZeroPhaseFIREqualizer``, ``ApproxCompressor``,
    ``ApproxNoiseGate``, ``IIREnvelopeFollower`` (energy, rms_channel),
    ``BallisticsEnvelopeFollower`` (energy, amplitude), ``Compressor()``
    and ``NoiseGate()`` at their defaults (the truncated one-pole FIR),
    ``Compressor(energy_smoother="ballistics")`` with the hard and the
    exponential knee, ``ParallelMix`` (an all-pass beside a hard-knee
    compressor) and ``GainStagingRegularization(PoleZeroFilter(
    backend="exact"))``; parameters and input (-40 dB passages) drawn with
    numpy, the same on the card and the CPU.  Each line: the card's
    forward ms and launches, the gradient's launches, and the forward, the
    loss (sum of output x a drawn weight, plus a container's auxiliary
    loss) and the gradient of every parameter and of the input held
    against the port's CPU path, <= -60 dB (each leaf <= -40 dB, zero
    leaves zero), at full width, or at 68 x 2 x 2^15 on both where the CPU
    path runs the plain ballistics walk (the card's calls above stay at
    full width).  A class smoothed by the truncated one-pole FIR (an FFT
    convolution whose round-off scales with the loudest sample), and the
    pole-zero and state-variable filters, whose parameters are drawn to put
    poles within 1e-4 of the unit circle (LIBRARY_STD), that miss one of
    these bounds are held instead to the CPU's own float32 spread against
    float64, + 6 dB (printed beside it, with the reason).  A class that
    streams streams 32 blocks of 4096 on the card, within -60 dB (max abs
    over peak) of its one-shot render; the zero-phase equalizers and the
    truncated-FIR compressor and gate refuse to stream, as in grafx_tpu.
    (b) the gain-smoothed console: bench.py's with
    ``Compressor(energy_smoother="ballistics", gain_smoother="ballistics")``
    and ``NoiseGate(energy_smoother="iir_exact", gain_smoother=
    "ballistics", gain_smooth_in_log=True)``, fused as bench.py fuses it
    (no pair walk: its gate -> compressor composites and its bus
    compressors each run the dynamics chain, #11), parameters
    drawn on the unfused graph and migrated, at (4, 17, 2, 2^17): served
    (phase 5, then compiled as phase 12), card vs CPU (phase 8), trained
    (phase 6, then compiled as phase 13), its gradients card vs CPU (phase
    7, a leaf that float32 determines less well held to the CPU's own
    spread against float64 + 6 dB), streamed (phase 9, then compiled with
    ``step_many(4)`` as phase 15), each with exact launches: the chain's
    primal twice a request and a block, its forward with residuals and
    its adjoint twice each a step (the composites' four walks, gate energy
    and gain, compressor energy and gain, over 68 rows, then the bus
    compressors' two over 8; a block 17 and 2); then the chain's three
    entry points held against their plain versions on the inputs this
    console gave them (``KernelInputs``, ``check_path_inputs``,
    ``check_chain``; the first 2^15 samples of each row, where the plain
    loop takes seconds) and timed on them (68 and 8 rows x 2^17, the
    plain versions on the first 2^15 samples); (c) ``simple_chain()`` and ``mastering_chain()`` (exact
    backend) through ``GraphParameterOptimizer(device="cuda")`` on one
    stereo source (1, 2, 2^17): the target's capture (#2 once), 10 fit
    steps (the capture of the second: #5 and #6 once), the loss falling,
    the first step against the CPU's as phase 17's (the MR-STFT gradient
    within -60 dB, phase 7's bound, where it lies below the CPU's own
    spread: these renders agree to the last bits), and #2, #5 and #6 held
    against their plain versions on the inputs of the first eager render
    and step (one row x 2^17, the reverse walk's own chunk pick).
36. the dynamics chain (``chain_phase``; #11, the port's own kernel:
    ``grafx_tpu`` composes these walks): its forms (``CHAIN_SPECS``: the
    console's composite and bus runs, a lone gate, a gate without a gain
    smoother before a log-smoothed compressor, and the reverse order)
    against its plain versions at N = 1, 37, 68 x L = 4109, 8205 and
    2^17 + 13 (that one compared on its first 2^15 samples), at its own
    stage length and at T = 96 (``[chain] case=`` lines: primal and
    forward max abs < 2e-5, the primal's gain equal to the forward's,
    the adjoint's du <= 1e-5 and each gradient row <= 1e-4 of its max,
    an absent member's gain exactly 1 and its gradients exactly 0); a
    row split in two calls carrying the final states against one call,
    and the first 2^17 samples against the whole 68 x (2^17 + 13) call,
    bit for bit; and the console's composite (68 rows, its absent gates)
    and bus compressor (8 rows) through the chain against the composed
    path on the card (output and every gradient, -60 dB, or the CPU's
    own float32 spread + 6 dB where float32 determines less).

Eager renders repeat bit for bit (phases 12 and 16 gate it, 25 and 26
gate the same key's render, 18 the resumed losses, 33 every path).

Phases 5-11 (and the eager runs of 21-26) run the eager paths
(``jit=False``), whose launch counts count every run.  A replay runs
exactly the launches its capture made, so phases 12-16 and 21-26 set
every count to 0 just before each capturing call (the request, the
steps, the stream block, ``step_many(4)`` and the loaded render and
stream steps), read them just after, and check that they equal one eager
run's (four blocks' for ``step_many(4)``); the kernels' line keeps them
under ``launches_per_run`` (``request_compiled``, ``step_compiled``,
``step_factorized_compiled``, ``stream_block_compiled``,
``step_many4_compiled``, ``load_render``, ``load_stream_step``,
``load_stream_step4``; and the eager ``request_fsm``, ``step_fsm``,
``stream_block_fsm``, ``step_fused_delay`` and ``step_fused_delay_fsm``,
``request_noise``, ``step_noise``, ``stream_block_noise``,
``request_fdn``, ``step_fdn`` and ``stream_block_fdn`` with each one's
``_compiled``; and phases 28-30's ``request_beam``, ``request_greedy``,
``request_fixed``, ``request_one_by_one``, ``request_array_compiled``,
``step_one_by_one`` (eager) and ``_compiled``, ``request_batched``; and
phase 32's ``parallel_{step,request}_compiled_nccl_rank<r>``,
``parallel_{data,node,time,step}_gloo_rank<r>``, ``load_render_fsm``,
``load_stream_step_fsm`` and ``load_stream_step4_fsm``; and phase 34's
``example_<name>``, the launches of one ``main``, and
``example_multihost_dp_rank<r>``; and phase 35's ``library35 <class>
forward`` and ``gradient``, ``request_gs``, ``step_gs``,
``stream_block_gs`` and each with ``_compiled``,
``stream_block_gs_step_many4_compiled``,
``fit_render_<chain>_compiled`` and ``fit_step_<chain>_compiled``; the
chain's entries carry their time at the gain-smoothed console's bus
input, 8 x 2^17, under ``more_shapes``, their plain versions' shape
under ``plain_shape`` and their derived serial floor).

The line before the last is ``{"kernels": [...]}``: per kernel its
errors, times, launches on its path and per run of each path, and its
bound (bytes over 3.35 TB/s or operations over 67 TFLOP/s), and for the
forward walks their stage length; the last line is ``{"ok": true,
"device": {...}}``.

``--profile DIR`` adds, after phase 5, one more warm request, after phase
6, one more warm step, after phase 9, one more warm block and, after
phase 10, one more warm factorized step under ``torch.profiler``, and
after phases 12-15 one more warm call of each compiled path: each prints
its device ms (CUDA events), host wall ms, busy device ms and the card's
idle share, and writes its per-op table to ``DIR/profile_<run>.txt``
(``request``, ``step``, ``stream_block``, ``step_factorized``, and each
with ``_compiled``); in phases 17 and 19 one more compiled fit step and
delay-console step (``fit_step_compiled``, ``delay_step_compiled``),
from whose busy times the delays' share of the step is derived; and in
phases 21-24 the same for the fsm paths (``request_fsm``, ``step_fsm``,
``stream_block_fsm``, each also ``_compiled``, and
``step_fused_delay_compiled``, ``step_fused_delay_fsm_compiled``); in
phases 25 and 26 the same for their consoles (``request_noise``,
``step_noise``, ``stream_block_noise``, ``request_fdn``, ``step_fdn``,
``stream_block_fdn``, each also ``_compiled``).
"""

import argparse
import contextlib
import copy
import functools
import importlib
import json
import os
import shutil
import statistics
import time
import subprocess
import sys
import tempfile
import warnings

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from grafx_tpu_torch import parallel, profiling
from grafx_tpu_torch._native import native_available
from grafx_tpu_torch.checkpoint import PARAMS_FILE, load_parameters, load_session, save_session
from grafx_tpu_torch.data import GRAFX, NodeConfigs, batch_grafx, convert_to_tensor
from grafx_tpu_torch.models import (
    GraphParameterOptimizer,
    ParameterPredictor,
    audio_features,
    bench_console,
    bench_trainer,
    mastering_chain,
    mixing_console,
    simple_chain,
)
from grafx_tpu_torch.models.console import bench_graph, bench_processors
from grafx_tpu_torch.models.optimize import OPT_STATE_FILE
from grafx_tpu_torch.models.predictor import features_per_type
from grafx_tpu_torch.ops import _cuda
from grafx_tpu_torch.ops import ballistics as bal
from grafx_tpu_torch.ops.fftconv import _auto_os_block, fft_convolve, fft_convolve_os, fft_convolve_upols
from grafx_tpu_torch.ops.iir import exactness_check_db
from grafx_tpu_torch import random
from grafx_tpu_torch.processors import (
    AllPassFilter,
    ApproxCompressor,
    ApproxNoiseGate,
    BallisticsEnvelopeFollower,
    BandPassFilter,
    BandRejectFilter,
    BiquadFilter,
    ChebyshevDistortion,
    Compressor,
    DryWet,
    FactorizedCompressor,
    FeedbackDelayNetwork,
    FilteredNoiseShapingReverb,
    FIRFilter,
    GainStagingRegularization,
    HighPassFilter,
    IIREnvelopeFollower,
    MidSideToStereo,
    MonoToStereo,
    NewZeroPhaseFIREqualizer,
    NoiseGate,
    ParallelMix,
    PiecewiseTanhDistortion,
    PoleZeroFilter,
    PowerDistortion,
    SerialChain,
    SideGainImager,
    StateVariableFilter,
    STFTMaskedNoiseReverb,
    StereoGain,
    StereoToMidSide,
    ZeroPhaseFIREqualizer,
)
from grafx_tpu_torch.ops.losses import mse_loss, multi_resolution_stft_loss
from grafx_tpu_torch.render import (
    StreamRenderer,
    compute_render_order,
    fuse_parameters,
    fuse_serial_lti,
    make_render_fn,
    prepare_render,
    reorder_for_fast_render,
)
from grafx_tpu_torch.render.fuse import FusedDynamicsChain, _scheduled_type_rows
from grafx_tpu_torch.render.order import beam_search
from grafx_tpu_torch.serving import export_render, export_stream_step, load_render, load_stream_step
from grafx_tpu_torch.utils import create_empty_parameters, tree_items, tree_leaves, tree_map

GAIN_SRC = "grafx_tpu_torch/csrc/ballistics_gain.cu"
GRAD_SRC = "grafx_tpu_torch/csrc/ballistics_grad.cu"
# name -> (source, the TPU kernel it replaces), in the order of PERF.md's table
KERNELS = {
    "ballistics_gain_pair_core": (GAIN_SRC, "grafx_tpu/ops/ballistics_tpu.py:826"),
    "ballistics_gain_core": (GAIN_SRC, "grafx_tpu/ops/ballistics_tpu.py:587"),
    "ballistics_gain_pair_fwd": (GAIN_SRC, "grafx_tpu/ops/ballistics_tpu.py:747"),
    "ballistics_gain_pair_bwd": (GRAD_SRC, "grafx_tpu/ops/ballistics_tpu.py:892"),
    "ballistics_gain_fwd": (GAIN_SRC, "grafx_tpu/ops/ballistics_tpu.py:449"),
    "ballistics_gain_bwd": (GRAD_SRC, "grafx_tpu/ops/ballistics_tpu.py:496"),
    "ballistics_core": (GAIN_SRC, "grafx_tpu/ops/ballistics_tpu.py:35"),
    "ballistics_fwd": (GAIN_SRC, "grafx_tpu/ops/ballistics_tpu.py:73"),
    "ballistics_bwd": (GRAD_SRC, "grafx_tpu/ops/ballistics_tpu.py:111"),
    "reverse_scan": (GRAD_SRC, "grafx_tpu/ops/ballistics_tpu.py:178"),
    # the port's own kernel: no pallas_call; grafx_tpu composes a
    # gain-smoothed run's walks (its members' gain_from_energy, threaded)
    "ballistics_chain_core": (GAIN_SRC, "grafx_tpu/render/fuse.py:423"),
    "ballistics_chain_fwd": (GAIN_SRC, "grafx_tpu/render/fuse.py:423"),
    "ballistics_chain_bwd": (GRAD_SRC, "grafx_tpu/render/fuse.py:423"),
}
NO_PATH = {"reverse_scan": "no caller in grafx_tpu/ or in the port"}
CHAIN_KERNELS = ("ballistics_chain_core", "ballistics_chain_fwd", "ballistics_chain_bwd")
OWN_KERNEL = ("the port's own kernel, no pallas_call: grafx_tpu runs the composed path"
              " (grafx_tpu/render/fuse.py:423, grafx_tpu/processors/dynamics.py:95), each walk"
              " its own ballistics_core call")
# the natural-layout experiment computes #7's function: the same kernel replaces it
LAYOUT_ROW = ("ballistics_core", GAIN_SRC, "benchmarks/ballistics_layout_ab.py:36")
SERVE_KERNELS = ("ballistics_gain_pair_core", "ballistics_gain_core")
TRAIN_KERNELS = ("ballistics_gain_pair_fwd", "ballistics_gain_pair_bwd",
                 "ballistics_gain_fwd", "ballistics_gain_bwd")
# launches per run of the console's paths (exact and fsm alike): the pair
# stage and the bus-compressor stage each launch once
SERVE_REQUEST = {"ballistics_gain_pair_core": 1, "ballistics_gain_core": 1}
TRAIN_STEP = {name: 1 for name in TRAIN_KERNELS}
STREAM_BLOCK = {"ballistics_core": 2}
FUSED_DELAY_STEP = ("ballistics_gain_core", "ballistics_gain_fwd", "ballistics_gain_bwd")
# launches per run of the factorized console's paths, and nothing else
FACTORIZED_REQUEST = {"ballistics_gain_core": 1, "ballistics_core": 2}
FACTORIZED_STEP = {"ballistics_gain_fwd": 1, "ballistics_gain_bwd": 1,
                   "ballistics_fwd": 2, "ballistics_bwd": 2}
# chunk lengths forced on the reverse walk: one tile, 256, the whole row, and
# None, the wrapper's own pick
FORCED_CHUNKS = (32, 256, "whole", None)
SWEEP_CHUNKS = (64, 128, 256, 512, 1024)  # timed at the console's shapes
# the forward walks' stage lengths T timed at the console's shapes, and the
# one forced on the ragged checks (many stages, a ring refilled many times)
SWEEP_SAMPLES = (64, 128, 256, 512, 1024)
FORCED_SAMPLES = 96
RAGGED_ROWS, RAGGED_LENGTHS = (1, 37, 68), (4096 + 13, 8192 + 13)
FORWARDS = ("ballistics_gain_pair_core", "ballistics_gain_pair_fwd", "ballistics_gain_core",
            "ballistics_gain_fwd", "ballistics_core", "ballistics_fwd")
MAX_ABS = 2e-5  # the bound benchmarks/verify_ballistics_tpu.py uses on the TPU
# a compiled or loaded path against its eager form, and a run under
# torch.use_deterministic_algorithms against the default one: max abs <= this
# x max|eager|.  Every such pair is equal bit for bit on the card (no fan-in
# adds by atomics, and a capture keeps eager's kernels), so equality is held.
COMPILED_REL = 0.0
FUSED_REL = 3e-5  # a fused render against the unfused one: max abs <= this x max|ref| (tests/graph/test_fuse.py)
WARM_CALLS = 5  # warm calls timed of each form of a compiled path
DU_REL = 1e-5  # du: max abs error <= DU_REL * max |ref|
GRAD_REL = 1e-4  # per-row gradients: max abs error <= GRAD_REL * max |ref|
BATCH, CHAINS, AUDIO_LEN = 4, 17, 2**17
BLOCK_LEN, SAMPLE_RATE = 4096, 44100
FRAME_LEN = 1024  # FactorizedCompressor's documented frame (BASELINE.md, "documented fast path")
FIT_TRACKS = 16  # mixing_console(16): the paper's console width (models/console.py)
PREDICTOR_STEPS = 10
# The card's published peaks (H100 SXM, 700 W): device memory and float32
# outside the tensor cores; the kernels do no matrix products.
MEM_BYTES_PER_S, F32_OPS_PER_S = 3.35e12, 67e12
# Per kernel: (arrays of N x L float32 moved, per-row float32 values moved,
# operations a sample).  The bytes count each input once and each output
# once.  Operations count the formula's float operations (log and exp one
# each): a forward walk 5 (two FMAs, a compare, a select), its residual 1,
# a knee gain 12, a reverse walk step 7, a knee adjoint 20.
KERNEL_WORK = {
    "ballistics_gain_pair_core": (2, 10, 37),
    "ballistics_gain_core": (2, 6, 17),
    "ballistics_gain_pair_fwd": (4, 12, 39),
    "ballistics_gain_pair_bwd": (5, 22, 86),
    "ballistics_gain_fwd": (3, 7, 18),
    "ballistics_gain_bwd": (4, 12, 40),
    "ballistics_core": (2, 3, 5),
    "ballistics_fwd": (3, 3, 6),
    "ballistics_bwd": (3, 5, 7),
    "reverse_scan": (3, 0, 2),
    # the chain at the console's composite (4 walks, 2 members): u in, gain
    # out, d of each walk with residuals; the adjoint reads u, 4 d, gg and
    # writes du.  A walk 5, a knee with its log 12, an exp 1, the product
    # and next energy 4; a reverse walk 7, a knee adjoint 20, the rebuild
    # 26, the cotangents 10
    "ballistics_chain_core": (2, 24, 52),
    "ballistics_chain_fwd": (6, 24, 56),
    "ballistics_chain_bwd": (7, 40, 104),
}
# the chain's work with 2 walks, 1 member (the bus compressors)
CHAIN_WORK_ONE = {"ballistics_chain_core": (2, 12, 24), "ballistics_chain_fwd": (4, 12, 26),
                  "ballistics_chain_bwd": (5, 20, 52)}


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def say(phase, **fields):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def gain_consts(gen, n, kind, onepole=False, absent=None):
    """(at, rt, th, cf, hk) on the card; ``absent`` rows get cf = 0."""
    def u(lo, hi):
        return lo + (hi - lo) * torch.rand(n, generator=gen, device="cuda")

    at, rt = u(0.05, 0.9), u(0.01, 0.3)
    if onepole:
        at = rt = u(0.02, 0.5)
    th = u(-3.0, 1.0)
    cf = u(-0.9, -0.2) if kind == "compressor" else u(0.5, 3.0)
    if absent is not None:
        cf = torch.where(absent, 0.0, cf)
    return [at, rt, th, cf, u(0.1, 1.0)]


def energy(gen, n, length):
    x = torch.randn(n, 2, length, generator=gen, device="cuda")
    return torch.mean(torch.square(x), dim=-2)


def console_input(shape, generator, device):
    """Noise with quiet passages (-40 dB in half of 32 blocks), so that
    the gates and the compressors' knees act and have gradients."""
    block = shape[-1] // 32
    x = torch.randn(shape, generator=generator, device=device)
    loud = torch.rand(shape[:-2] + (1, 32), generator=generator, device=device) < 0.5
    return x * torch.where(loud, 1.0, 0.01).repeat_interleave(block, dim=-1)


def device_ms(fn, reps):
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def host_ms(fn, reps):
    """Host wall ms per call of ``fn`` to enqueue it, over ``reps`` calls
    (the card is synchronised before and after, not between)."""
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(reps):
        fn()
    ms = (time.perf_counter() - start) * 1e3 / reps
    torch.cuda.synchronize()
    return ms


def max_err(got, ref):
    return (got - ref).abs().max().item()


def bound(name, n, length, work=None):
    """``(bound_ms, bound_by)`` of one call on ``(n, length)`` rows: the
    larger of its bytes over the memory rate and its operations over the
    float32 rate (``work`` in place of the kernel's KERNEL_WORK)."""
    arrays, per_row, ops = work or KERNEL_WORK[name]
    bytes_ms = 1e3 * 4 * (arrays * n * length + per_row * n) / MEM_BYTES_PER_S
    ops_ms = 1e3 * ops * n * length / F32_OPS_PER_S
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def read_launches(path, runs, stats, kernels, exact=None):
    """Check the launch counts of ``runs`` runs of a path: every wrapper in
    ``kernels`` launched (``exact``: so many times a run), every other
    none.  A kernel's ``launches`` is the count of the first path that
    runs it, its main path; ``per_run`` keeps every path's."""
    launches = bal.launch_counts()
    for name, count in launches.items():
        if name in kernels:
            check(count > 0, f"{name} was not launched on the {path} path")
            if exact is not None:
                check(count == runs * exact[name],
                      f"{name} launched {count} times in {runs} runs of the {path} path,"
                      f" not {exact[name]} a run")
            stats[name].setdefault("launches", count)
        else:
            check(count == 0, f"{name} was launched on the {path} path")
        stats[name]["per_run"][path] = count / runs
    return launches


class KernelCase:
    """One call of a kernel pair (primal-only #1/#2, or forward #3/#5 with
    its adjoint #4/#6) with its plain versions on the same inputs."""

    def __init__(self, pair, u, consts, kinds, inits, gg):
        self.pair, self.u, self.consts, self.gg = pair, u, consts, gg
        self.kinds, self.inits = kinds, inits

    def _kw(self, inits=True):
        if not self.pair:
            return {"kind": self.kinds}
        return {"kinds": self.kinds, "inits": self.inits} if inits else {"kinds": self.kinds}

    def primal(self, plain=False):
        fn = ((bal.ballistics_gain_pair_plain if plain else bal.ballistics_gain_pair_core)
              if self.pair else (bal.ballistics_gain_plain if plain else bal.ballistics_gain_core))
        return fn(self.u, *self.consts, **self._kw())

    def forward(self, plain=False):
        fn = ((bal.ballistics_gain_pair_fwd_plain if plain else bal.ballistics_gain_pair_fwd)
              if self.pair else (bal.ballistics_gain_fwd_plain if plain else bal.ballistics_gain_fwd))
        return fn(self.u, *self.consts, **self._kw())

    def backward(self, res, plain=False, chunk=None):
        """The adjoint on the residuals ``res`` of a forward (the kernel's
        reverse walk in chunks of ``chunk`` samples, None: its own pick)."""
        kw = self._kw(inits=False) if plain else {**self._kw(inits=False), "chunk": chunk}
        if self.pair:
            fn = bal.ballistics_gain_pair_bwd_plain if plain else bal.ballistics_gain_pair_bwd
            return fn(self.u, *res[1:], self.gg, *self.consts, **kw)
        fn = bal.ballistics_gain_bwd_plain if plain else bal.ballistics_gain_bwd
        return fn(self.u, res[1], res[2], self.gg, *self.consts[1:], **kw)

    @property
    def names(self):
        fwd = "ballistics_gain_pair_fwd" if self.pair else "ballistics_gain_fwd"
        return ("ballistics_gain_pair_core" if self.pair else "ballistics_gain_core",
                fwd, fwd.replace("_fwd", "_bwd"))


def kernel_cases(gen, length=2**13):
    """Cases at small shapes: N = 68, 8 and 37 rows, both kinds, a
    one-pole member with init 0, absent members; (label, case, absent
    rows per member)."""
    cases = []
    for n in (68, 8, 37):
        u = energy(gen, n, length)
        gg = torch.randn(n, length, generator=gen, device="cuda")
        for kind in ("compressor", "noisegate"):
            zi = torch.rand(n, generator=gen, device="cuda")
            absent = torch.arange(n, device="cuda") % 5 == 0
            c = [zi] + gain_consts(gen, n, kind, absent=absent)
            cases.append((f"N={n} {kind}", KernelCase(False, u, c, kind, None, gg), (absent,)))
        for kinds, inits in ((("noisegate", "compressor"), (0.0, 1.0)),
                             (("compressor", "noisegate"), (1.0, 1.0))):
            absent = torch.arange(n, device="cuda") % 3 != 0
            c = gain_consts(gen, n, kinds[0], onepole=inits[0] == 0.0, absent=absent)
            c += gain_consts(gen, n, kinds[1])
            cases.append((f"N={n} {'/'.join(kinds)} inits={inits}",
                          KernelCase(True, u, c, kinds, inits, gg), (absent, None)))
    return cases


def console_cases(gen):
    """The gain kernels' calls at full width, over 2^17 samples, as
    ``(case, path)``: the exact console's 17 gate -> compressor composites
    at batch 4 (68 rows; 11 of every 17 gates absent) and its two bus
    compressors (8 rows), whose times are the kernels' rows (``path``
    None); and the factorized console's gate members (68 rows of the
    one-pole gate from 0; an absent gate's gain is selected to 1 after
    the kernel, so every row keeps its cf) and the fit console's 16 track
    compressors (phases 17-20, 16 rows), extra shapes of #2/#5/#6."""
    n = BATCH * CHAINS
    absent = (torch.arange(n, device="cuda") % CHAINS) % 3 != 0
    u = energy(gen, n, AUDIO_LEN)
    c = gain_consts(gen, n, "noisegate", onepole=True, absent=absent) + gain_consts(gen, n, "compressor")
    gg = torch.randn(n, AUDIO_LEN, generator=gen, device="cuda")
    pair = KernelCase(True, u, c, ("noisegate", "compressor"), (0.0, 1.0), gg)
    u3 = energy(gen, n, AUDIO_LEN)
    c3 = [torch.zeros(n, device="cuda")] + gain_consts(gen, n, "noisegate", onepole=True)
    gg3 = torch.randn(n, AUDIO_LEN, generator=gen, device="cuda")
    gate = KernelCase(False, u3, c3, "noisegate", None, gg3)
    n = BATCH * 2
    u2 = energy(gen, n, AUDIO_LEN)
    c2 = [torch.ones(n, device="cuda")] + gain_consts(gen, n, "compressor")
    gg2 = torch.randn(n, AUDIO_LEN, generator=gen, device="cuda")
    u4 = energy(gen, FIT_TRACKS, AUDIO_LEN)
    c4 = [torch.ones(FIT_TRACKS, device="cuda")] + gain_consts(gen, FIT_TRACKS, "compressor")
    gg4 = torch.randn(FIT_TRACKS, AUDIO_LEN, generator=gen, device="cuda")
    return [(pair, None), (KernelCase(False, u2, c2, "compressor", None, gg2), None),
            (gate, "factorized gate member"),
            (KernelCase(False, u4, c4, "compressor", None, gg4), "fit track compressors")]


def chunking(shape, chunk=None):
    """The reverse walk's ``{"chunk": T, "chunks": C}`` for rows of
    ``shape``."""
    n, length = shape
    t = bal.walk_chunk(n, length, chunk, bal.walk_slots("cuda"))
    return {"chunk": t, "chunks": -(-length // t)}


def walk_stage(name, shape):
    """A forward kernel's stage at ``shape`` as the wrapper picks it,
    ``{"samples": T}``; other kernels ``{}``."""
    return {"samples": bal.walk_samples(shape[1])} if name in FORWARDS else {}


def grad_names(case):
    if case.pair:
        return [f"d{p}_{m}" for m in "ab" for p in ("at", "rt", "th", "cf", "hk")]
    return ["dzi", "dat", "drt", "dth", "dcf", "dhk"]


def check_case(label, case, stats, absent=None, timed=False, path=None):
    """Hold the primal kernel, the forward and the adjoint against their
    plain versions.  With ``timed``, each plain version's one run is
    timed, then each kernel over 5 runs after a warm-up: the times of the
    kernels' rows, or with ``path`` an extra shape of them on that path."""
    prim_name, fwd_name, bwd_name = case.names
    plain_ms = {}

    def plain(name, fn):
        if not timed:
            return fn()
        plain_ms[name], out = device_ms(fn, reps=1)
        return out

    prim, fwd = case.primal(), case.forward()
    bwd = case.backward(fwd)
    if timed:
        prim_ref = plain(prim_name, lambda: case.primal(plain=True))
        fwd_ref = plain(fwd_name, lambda: case.forward(plain=True))
    else:
        # the plain primal is the plain forward's gain (ops/ballistics.py)
        fwd_ref = case.forward(plain=True)
        prim_ref = fwd_ref[0]
    # the kernel's residuals for both: #4/#6 alone
    bwd_ref = plain(bwd_name, lambda: case.backward(fwd, plain=True))
    torch.cuda.synchronize()

    err = max_err(prim, prim_ref)
    check(err < MAX_ABS, f"{prim_name} {label}: max abs err {err} >= {MAX_ABS}")
    stats[prim_name]["max_abs_err"] = max(stats[prim_name]["max_abs_err"], err)
    check(torch.equal(fwd[0], prim), f"{fwd_name} {label}: the gain differs from {prim_name}'s")
    ferr = max(max_err(a, b) for a, b in zip(fwd, fwd_ref))
    check(ferr < MAX_ABS, f"{fwd_name} {label}: gain/residual max abs err {ferr} >= {MAX_ABS}")
    stats[fwd_name]["max_abs_err"] = max(stats[fwd_name]["max_abs_err"], ferr)

    du_err, du_scale, rel = check_adjoint(label, case, bwd, bwd_ref, stats, absent)
    say("kernels", case=label, primal_err=f"{err:.3g}", fwd_err=f"{ferr:.3g}",
        du_err=f"{du_err:.3g}", du_scale=f"{du_scale:.3g}", grad_rel_err=f"{rel:.3g}",
        **chunking(case.u.shape))
    if timed:
        shape = tuple(case.u.shape)
        for name, kern in ((prim_name, case.primal), (fwd_name, case.forward),
                           (bwd_name, lambda: case.backward(fwd))):
            kern()  # warm-up
            ms = device_ms(kern, reps=5)[0]
            more = chunking(shape) if name == bwd_name else walk_stage(name, shape)
            if path is None:
                stats[name].update(ms=ms, plain_ms=plain_ms[name], shape=shape, **more)
            else:
                stats[name]["more"].append({"path": path, "shape": list(shape), "ms": ms,
                                            "plain_ms": plain_ms[name],
                                            "bound_ms": bound(name, *shape)[0], **more})
            say("kernels", kernel=name, shape=shape, **({"path": repr(path)} if path else {}),
                kernel_ms=f"{ms:.3f}", plain_ms=f"{plain_ms[name]:.1f}", **more)
        # the chunk length against the kernel's time at this shape
        for chunk in SWEEP_CHUNKS:
            kern = functools.partial(case.backward, fwd, chunk=chunk)
            kern()  # warm-up
            ms = device_ms(kern, reps=5)[0]
            stats[bwd_name]["chunk_sweep"].append({"shape": list(shape), "ms": ms,
                                                   **chunking(shape, chunk)})
            say("kernels", sweep=bwd_name, shape=shape, kernel_ms=f"{ms:.3f}",
                **chunking(shape, chunk))


def check_adjoint(label, case, bwd, bwd_ref, stats, absent=None):
    """Hold the adjoint's outputs ``bwd`` against its plain version's:
    ``du`` within DU_REL and each per-row gradient within GRAD_REL of its
    max|ref|, and an absent member's gradients exactly 0.  Returns
    ``(du_err, du_scale, worst gradient error over its scale)``."""
    bwd_name = case.names[2]
    du_err, du_scale = max_err(bwd[0], bwd_ref[0]), bwd_ref[0].abs().max().item()
    check(du_err <= DU_REL * du_scale, f"{bwd_name} {label}: du err {du_err} > {DU_REL} x {du_scale}")
    rel = 0.0
    for name, g, r in zip(grad_names(case), bwd[1:], bwd_ref[1:]):
        e, scale = max_err(g, r), r.abs().max().item()
        check(e <= GRAD_REL * scale, f"{bwd_name} {label} {name}: err {e} > {GRAD_REL} x {scale}")
        rel = max(rel, e / scale if scale > 0 else 0.0)
        stats[bwd_name]["max_abs_err"] = max(stats[bwd_name]["max_abs_err"], e)
    stats[bwd_name]["max_abs_err"] = max(stats[bwd_name]["max_abs_err"], du_err)
    if absent is not None:
        # an absent member (cf = 0) gets no gradient through its walk or
        # knee; dcf is the cotangent of the masked cf, which the mask zeroes
        for m, rows in zip(("a", "b") if case.pair else ("",), absent):
            if rows is None:
                continue
            for name, g in zip(grad_names(case), bwd[1:]):
                if name.endswith(m) and not name.startswith("dcf"):
                    check(bool((g[rows] == 0).all()), f"{bwd_name} {label}: absent {name} != 0")
            if not case.pair:
                check(bool((bwd[0][rows] == 0).all()), f"{bwd_name} {label}: absent du != 0")
    return du_err, du_scale, rel


def check_forced_chunks(gen, stats):
    """#4 (68 rows) and #6 (8 rows) on ragged lengths, 4109 and 2^17 + 13,
    with their reverse walks at forced chunk lengths (one tile, 256, the
    whole row) and their own pick, each against the plain adjoint on the
    kernel forward's residuals; absent members' gradients exactly 0."""
    for length in (BLOCK_LEN + 13, AUDIO_LEN + 13):
        for pair, n in ((True, BATCH * CHAINS), (False, BATCH * 2)):
            u = energy(gen, n, length)
            gg = torch.randn(n, length, generator=gen, device="cuda")
            if pair:
                absent = torch.arange(n, device="cuda") % 3 != 0
                c = gain_consts(gen, n, "noisegate", onepole=True, absent=absent)
                c += gain_consts(gen, n, "compressor")
                case, rows = KernelCase(True, u, c, ("noisegate", "compressor"), (0.0, 1.0), gg), (absent, None)
            else:
                absent = torch.arange(n, device="cuda") % 5 == 0
                c = [torch.ones(n, device="cuda")] + gain_consts(gen, n, "compressor", absent=absent)
                case, rows = KernelCase(False, u, c, "compressor", None, gg), (absent,)
            fwd = case.forward()
            ref = case.backward(fwd, plain=True)
            for chunk in FORCED_CHUNKS:
                forced = -(-length // 32) * 32 if chunk == "whole" else chunk
                got = case.backward(fwd, chunk=forced)
                torch.cuda.synchronize()
                du_err, du_scale, rel = check_adjoint(f"forced chunk {forced}", case, got, ref,
                                                      stats, rows)
                say("kernels", case=f"{case.names[2]} {tuple(u.shape)} forced chunk",
                    du_err=f"{du_err:.3g}", du_scale=f"{du_scale:.3g}", grad_rel_err=f"{rel:.3g}",
                    **chunking(u.shape, forced))


def forward_at(case, res, samples):
    """#1 / #3 (``case.pair``) or #2 / #5 (``res``: with residuals) with
    stages of a forced ``samples``, or the wrapper's pick for None."""
    if case.pair:
        return bal._pair_fwd_cuda("forced stage", case.u, case.consts, case.kinds, case.inits, res,
                                  samples)
    return bal._gain_fwd_cuda("forced stage", case.u, case.consts, case.kinds, res, samples)


def check_ragged_forwards(gen, stats):
    """#1, #2, #3 and #5 against their plain versions at N = 1, 37, 68 and
    L = 4109, 8205: row starts that are not 16-byte aligned, at the
    wrapper's stage length and at FORCED_SAMPLES; #1's gain equals #3's
    and #2's #5's, bit for bit, and an absent single member's gain is
    exactly 1."""
    for n in RAGGED_ROWS:
        for length in RAGGED_LENGTHS:
            u = energy(gen, n, length)
            absent = torch.arange(n, device="cuda") % 5 == 0
            single = KernelCase(False, u, [torch.rand(n, generator=gen, device="cuda")]
                                + gain_consts(gen, n, "compressor", absent=absent),
                                "compressor", None, None)
            gate = torch.arange(n, device="cuda") % 3 != 0
            pair = KernelCase(True, u, gain_consts(gen, n, "noisegate", onepole=True, absent=gate)
                              + gain_consts(gen, n, "compressor"),
                              ("noisegate", "compressor"), (0.0, 1.0), None)
            for case in (single, pair):
                prim_name, fwd_name, _ = case.names
                ref = case.forward(plain=True)
                for samples in (None, FORCED_SAMPLES):
                    prim, fwd = forward_at(case, False, samples), forward_at(case, True, samples)
                    torch.cuda.synchronize()
                    label = f"ragged ({n}, {length}) T {samples or 'picked'}"
                    err = max_err(prim, ref[0])
                    ferr = max(max_err(a, b) for a, b in zip(fwd, ref))
                    check(err < MAX_ABS, f"{prim_name} {label}: max abs err {err} >= {MAX_ABS}")
                    check(ferr < MAX_ABS, f"{fwd_name} {label}: max abs err {ferr} >= {MAX_ABS}")
                    check(torch.equal(fwd[0], prim), f"{fwd_name} {label}: the gain differs from {prim_name}'s")
                    if not case.pair:
                        check(bool((prim[absent] == 1.0).all()), f"{prim_name} {label}: absent gain != 1")
                    stats[prim_name]["max_abs_err"] = max(stats[prim_name]["max_abs_err"], err)
                    stats[fwd_name]["max_abs_err"] = max(stats[fwd_name]["max_abs_err"], ferr)
                    say("kernels", case=f"{prim_name}/{fwd_name} {label}", primal_err=f"{err:.3g}",
                        fwd_err=f"{ferr:.3g}", gain_bit_equal=True)


def check_causality(gen):
    """At 68 x (2^17 + 13), whose row starts are not 16-byte aligned, each
    forward kernel (#1, #2, #3, #5, #7, #8) on the first 2^17 samples
    equals the first 2^17 columns of its call on the whole rows, bit for
    bit, in every per-sample output."""
    n = BATCH * CHAINS
    u = energy(gen, n, AUDIO_LEN + 13)
    head = u[:, :AUDIO_LEN].contiguous()
    pair = gain_consts(gen, n, "noisegate", onepole=True) + gain_consts(gen, n, "compressor")
    pair_kw = {"kinds": ("noisegate", "compressor"), "inits": (0.0, 1.0)}
    single = [torch.rand(n, generator=gen, device="cuda")] + gain_consts(gen, n, "compressor")
    calls = {
        "ballistics_gain_pair_core": lambda x: [bal.ballistics_gain_pair_core(x, *pair, **pair_kw)],
        "ballistics_gain_pair_fwd": lambda x: bal.ballistics_gain_pair_fwd(x, *pair, **pair_kw)[:3],
        "ballistics_gain_core": lambda x: [bal.ballistics_gain_core(x, *single)],
        "ballistics_gain_fwd": lambda x: bal.ballistics_gain_fwd(x, *single)[:2],
        "ballistics_core": lambda x: [bal.ballistics_core(x, *single[:3])],
        "ballistics_fwd": lambda x: list(bal.ballistics_fwd(x, *single[:3])),
    }
    for name, call in calls.items():
        whole, part = call(u), call(head)
        torch.cuda.synchronize()
        for i, (w, p) in enumerate(zip(whole, part)):
            check(torch.equal(w[:, :AUDIO_LEN], p),
                  f"{name}: output {i} on the first {AUDIO_LEN} samples differs from the whole call's")
    say("kernels", causality=f"({n}, {AUDIO_LEN + 13}) vs ({n}, {AUDIO_LEN})", kernels=len(calls),
        bit_equal=True)


def split_pair(u, consts, kinds, inits, samples):
    """#3's outputs the unfused way: two #8 walks with stages of
    ``samples``, with the knees between them in PyTorch (the pair kernel's
    yardstick)."""
    at_a, rt_a, th_a, cf_a, hk_a, at_b, rt_b, th_b, cf_b, hk_b = consts
    v, d_a = bal._walk_fwd_cuda("split pair", u, (torch.full_like(at_a, inits[0]), at_a, rt_a),
                                True, samples)
    ga = bal._knee_gain(v, th_a, cf_a, hk_a, kinds[0])
    ec = ga * ga * u
    u2, d_b = bal._walk_fwd_cuda("split pair", ec, (torch.full_like(at_b, inits[1]), at_b, rt_b),
                                 True, samples)
    return ga * bal._knee_gain(u2, th_b, cf_b, hk_b, kinds[1]), d_a, d_b, v[:, -1], u2[:, -1]


def walk_sweep(gen, stats):
    """The forward walks' stage length against their time: #8 at 68 x
    2^17, #5 at 8 x 2^17 and #3 at 68 x 2^17 over SWEEP_SAMPLES, #3 fused
    and split (:func:`split_pair`), the split one first held to the fused
    one; each over 3 calls after a warm-up."""
    (pair, _), (bus, _) = console_cases(gen)[:2]
    walk = walk_args(gen, BATCH * CHAINS, AUDIO_LEN)
    fused = pair.forward()
    split = split_pair(pair.u, pair.consts, pair.kinds, pair.inits, None)
    torch.cuda.synchronize()
    err = max(max_err(a, b) for a, b in zip(split, fused))
    check(err < MAX_ABS, f"split pair vs fused pair: max abs err {err} >= {MAX_ABS}")
    say("kernels", split_pair_vs_fused_err=f"{err:.3g}")
    for samples in SWEEP_SAMPLES:
        entries = [
            ("ballistics_fwd", walk[0].shape, {},
             lambda: bal._walk_fwd_cuda("sweep", walk[0], walk[1:], True, samples)),
            ("ballistics_gain_fwd", bus.u.shape, {}, lambda: forward_at(bus, True, samples)),
            ("ballistics_gain_pair_fwd", pair.u.shape, {"structure": "fused"},
             lambda: forward_at(pair, True, samples)),
            ("ballistics_gain_pair_fwd", pair.u.shape, {"structure": "split"},
             lambda: split_pair(pair.u, pair.consts, pair.kinds, pair.inits, samples)),
        ]
        for name, shape, extra, fn in entries:
            fn()  # warm-up
            ms = device_ms(fn, reps=3)[0]
            stats[name]["walk_sweep"].append({"shape": list(shape), "samples": samples, **extra,
                                              "ms": ms})
            say("kernels", sweep=name, shape=tuple(shape), samples=samples, **extra,
                kernel_ms=f"{ms:.3f}")


def check_many_rows(gen, stats):
    """#3 on twice as many rows as the card has SMs, so that two blocks
    share each SM (their rings sized to fit together): its first half of
    the rows equals the call on that half alone (one block an SM, a larger
    ring), bit for bit, in every output; each call timed over 3 calls
    after a warm-up."""
    name, sms = "ballistics_gain_pair_fwd", torch.cuda.get_device_properties(0).multi_processor_count
    n = 2 * sms
    u = energy(gen, n, AUDIO_LEN)
    consts = gain_consts(gen, n, "noisegate", onepole=True) + gain_consts(gen, n, "compressor")
    kw = {"kinds": ("noisegate", "compressor"), "inits": (0.0, 1.0)}
    half_u, half_c = u[:sms].contiguous(), [c[:sms].contiguous() for c in consts]
    whole = bal.ballistics_gain_pair_fwd(u, *consts, **kw)
    half = bal.ballistics_gain_pair_fwd(half_u, *half_c, **kw)
    torch.cuda.synchronize()
    for i, (w, h) in enumerate(zip(whole, half)):
        check(torch.equal(w[:sms], h), f"{name}: output {i} of {n} rows differs on its first {sms}")
    del whole, half
    times = {}
    for rows, call in ((sms, lambda: bal.ballistics_gain_pair_fwd(half_u, *half_c, **kw)),
                       (n, lambda: bal.ballistics_gain_pair_fwd(u, *consts, **kw))):
        call()  # warm-up
        times[rows] = device_ms(call, reps=3)[0]
        stats[name]["more"].append({"path": "rows sharing SMs" if rows > sms else "a row an SM",
                                    "shape": [rows, AUDIO_LEN], "ms": times[rows], "plain_ms": None,
                                    "bound_ms": bound(name, rows, AUDIO_LEN)[0],
                                    **walk_stage(name, (rows, AUDIO_LEN))})
    say("kernels", many_rows=name, sms=sms, bit_equal=True,
        **{f"kernel_ms_{rows}_rows": f"{ms:.3f}" for rows, ms in times.items()})


def check_walk(label, u, zi, at, rt, stats, timed=False):
    """Hold kernel #7 against its plain version, and the walk split in
    two halves (the second from the first's last sample) against one
    walk, bit for bit.  With ``timed``, the plain version's one run and
    the kernel over 5 runs after a warm-up are timed."""
    name = "ballistics_core"
    y = bal.ballistics_core(u, zi, at, rt)
    if timed:
        stats[name]["plain_ms"], ref = device_ms(lambda: bal.ballistics_plain(u, zi, at, rt), reps=1)
    else:
        ref = bal.ballistics_plain(u, zi, at, rt)
    half = u.shape[1] // 2
    first = bal.ballistics_core(u[:, :half], zi, at, rt)
    second = bal.ballistics_core(u[:, half:], first[:, -1], at, rt)
    torch.cuda.synchronize()
    err = max_err(y, ref)
    check(err < MAX_ABS, f"{name} {label}: max abs err {err} >= {MAX_ABS}")
    check(torch.equal(torch.cat([first, second], dim=1), y),
          f"{name} {label}: the walk split at {half} differs from one walk")
    stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"], err)
    say("kernels", case=f"{name} {label}", err=f"{err:.3g}", split_at=half, state_carry="exact")
    if timed:
        bal.ballistics_core(u, zi, at, rt)  # warm-up
        stats[name]["ms"] = device_ms(lambda: bal.ballistics_core(u, zi, at, rt), reps=5)[0]
        stats[name]["shape"] = tuple(u.shape)
        stats[name].update(walk_stage(name, tuple(u.shape)))
        say("kernels", kernel=name, shape=tuple(u.shape), kernel_ms=f"{stats[name]['ms']:.3f}",
            plain_ms=f"{stats[name]['plain_ms']:.1f}", **walk_stage(name, tuple(u.shape)))


def walk_args(gen, n, length):
    """(u, zi, at, rt) on the card for kernel #7."""
    at, rt = gain_consts(gen, n, "compressor")[:2]
    return energy(gen, n, length), torch.rand(n, generator=gen, device="cuda"), at, rt


def smoother_case(gen, n, length):
    """(u, zi, at, rt, g, a) on the card for #8-#10: the walk's inputs, an
    output cotangent and the reverse scan's coefficients in [0.1, 0.99)."""
    g = torch.randn(n, length, generator=gen, device="cuda")
    a = 0.1 + 0.89 * torch.rand(n, length, generator=gen, device="cuda")
    return (*walk_args(gen, n, length), g, a)


def smoother_calls(case):
    """{name: (kernel call, plain call)} of #8, #9 (on #8's residual) and
    #10."""
    u, zi, at, rt, g, a = case
    _, d = bal.ballistics_fwd(u, zi, at, rt)
    return {
        "ballistics_fwd": (lambda: bal.ballistics_fwd(u, zi, at, rt),
                           lambda: bal.ballistics_fwd_plain(u, zi, at, rt)),
        "ballistics_bwd": (lambda: bal.ballistics_bwd(d, g, at, rt),
                           lambda: bal.ballistics_bwd_plain(d, g, at, rt)),
        "reverse_scan": (lambda: bal.reverse_scan(a, g), lambda: bal.reverse_scan_plain(a, g)),
    }


def check_smoother_bwd(label, got, ref, shape):
    """Hold #9's ``(du, dzi, dat, drt)`` against its plain version's: du
    within DU_REL of max|ref| (bit for bit where one chunk walks the row),
    the rest within GRAD_REL.  Returns ``(max abs err, du_err, du_scale,
    worst gradient error over its scale)``."""
    du, du_ref = got[0], ref[0]
    du_err, du_scale = max_err(du, du_ref), du_ref.abs().max().item()
    check(du_err <= DU_REL * du_scale, f"ballistics_bwd {label}: du err {du_err} > {DU_REL} x {du_scale}")
    if chunking(shape)["chunks"] == 1:
        check(torch.equal(du, du_ref), f"ballistics_bwd {label}: one chunk, du differs from the plain walk's")
    err, rel = du_err, 0.0
    for name, v, r in zip(("dzi", "dat", "drt"), got[1:], ref[1:]):
        e, scale = max_err(v, r), r.abs().max().item()
        check(e <= GRAD_REL * scale, f"ballistics_bwd {label} {name}: err {e} > {GRAD_REL} x {scale}")
        err = max(err, e)
        rel = max(rel, e / scale if scale > 0 else 0.0)
    return err, du_err, du_scale, rel


def check_smoother(label, case, stats):
    """Hold #8 (y, d), #9 (du; dzi, dat, drt) and #10 (gh) against their
    plain versions on one case; #8's walk is #7's bit for bit."""
    calls = smoother_calls(case)
    got = {name: kern() for name, (kern, _) in calls.items()}
    ref = {name: plain() for name, (_, plain) in calls.items()}
    walk = bal.ballistics_core(*case[:4])
    torch.cuda.synchronize()
    y, d = got["ballistics_fwd"]
    check(torch.equal(y, walk), f"ballistics_fwd {label}: y differs from ballistics_core's walk")
    errs = {}
    ferr = max(max_err(a, b) for a, b in zip(got["ballistics_fwd"], ref["ballistics_fwd"]))
    check(ferr < MAX_ABS, f"ballistics_fwd {label}: y/d max abs err {ferr} >= {MAX_ABS}")
    errs["ballistics_fwd"] = ferr
    errs["ballistics_bwd"], du_err, du_scale, rel = check_smoother_bwd(
        label, got["ballistics_bwd"], ref["ballistics_bwd"], d.shape)
    errs["reverse_scan"], gh_err, gh_scale = check_scan(label, got["reverse_scan"],
                                                        ref["reverse_scan"])
    for name, e in errs.items():
        stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"], e)
    say("kernels", case=f"smoother {label}", fwd_err=f"{ferr:.3g}", du_err=f"{du_err:.3g}",
        du_scale=f"{du_scale:.3g}", grad_rel_err=f"{rel:.3g}", gh_err=f"{gh_err:.3g}",
        gh_scale=f"{gh_scale:.3g}", **chunking(d.shape))


def check_scan(label, gh, gh_ref):
    """Hold #10's ``gh`` against its plain version's: within DU_REL of
    max|ref| (the adjoint walk's du gate; #10 is that chunked walk with
    the coefficient read), bit for bit where one chunk walks the row.
    Returns ``(max abs err, max abs err, max|ref|)``."""
    gh_err, gh_scale = max_err(gh, gh_ref), gh_ref.abs().max().item()
    check(gh_err <= DU_REL * gh_scale, f"reverse_scan {label}: gh err {gh_err} > {DU_REL} x {gh_scale}")
    if chunking(tuple(gh.shape))["chunks"] == 1:
        check(torch.equal(gh, gh_ref), f"reverse_scan {label}: one chunk, gh differs from the plain scan's")
    return gh_err, gh_err, gh_scale


def check_smoother_bwd_at(label, case, stats):
    """#9 and #10 against their plain versions on one case (a shape whose
    plain #8 would take too long), #9 on #8's residual; then #10 timed
    over the chunk lengths of SWEEP_CHUNKS."""
    u, zi, at, rt, g, a = case
    _, d = bal.ballistics_fwd(u, zi, at, rt)
    got, ref = bal.ballistics_bwd(d, g, at, rt), bal.ballistics_bwd_plain(d, g, at, rt)
    torch.cuda.synchronize()
    err, du_err, du_scale, rel = check_smoother_bwd(label, got, ref, d.shape)
    stats["ballistics_bwd"]["max_abs_err"] = max(stats["ballistics_bwd"]["max_abs_err"], err)
    say("kernels", case=f"ballistics_bwd {label}", du_err=f"{du_err:.3g}", du_scale=f"{du_scale:.3g}",
        grad_rel_err=f"{rel:.3g}", **chunking(d.shape))
    gh = bal.reverse_scan(a, g)
    err, gh_err, gh_scale = check_scan(label, gh, bal.reverse_scan_plain(a, g))
    stats["reverse_scan"]["max_abs_err"] = max(stats["reverse_scan"]["max_abs_err"], err)
    say("kernels", case=f"reverse_scan {label}", gh_err=f"{gh_err:.3g}", gh_scale=f"{gh_scale:.3g}",
        **chunking(d.shape))
    shape = tuple(d.shape)
    for chunk in SWEEP_CHUNKS:
        kern = functools.partial(bal.reverse_scan, a, g, chunk=chunk)
        kern()  # warm-up
        ms = device_ms(kern, reps=5)[0]
        stats["reverse_scan"]["chunk_sweep"].append({"shape": list(shape), "ms": ms,
                                                     **chunking(shape, chunk)})
        say("kernels", sweep="reverse_scan", shape=shape, kernel_ms=f"{ms:.3f}",
            **chunking(shape, chunk))


def time_smoother(case, stats, plain, main):
    """Time #8-#10 on one case: each kernel over 5 calls after a warm-up
    (and its busy device time under the profiler) and, with ``plain``,
    the host's time to enqueue it over 100 calls and each plain version's
    one call.  ``main``: the times of the kernel's row, else an extra
    shape of it."""
    shape = tuple(case[0].shape)
    for name, (kern, ref) in smoother_calls(case).items():
        kern()  # warm-up
        ms = device_ms(kern, reps=5)[0]
        busy = device_busy_ms(kern, reps=5)
        host = host_ms(kern, reps=100) if plain else None
        plain_ms = device_ms(ref, reps=1)[0] if plain else None
        bound_ms, bound_by = bound(name, *shape)
        more = (chunking(shape) if name in ("ballistics_bwd", "reverse_scan")
                else walk_stage(name, shape))
        if main:
            stats[name].update(ms=ms, plain_ms=plain_ms, shape=shape, device_busy_ms=busy,
                               host_ms=host, **more)
        else:
            stats[name]["more"].append({"shape": list(shape), "ms": ms, "device_busy_ms": busy,
                                        "host_ms": host, "plain_ms": plain_ms, "bound_ms": bound_ms,
                                        **more})
        say("kernels", kernel=name, shape=shape, kernel_ms=f"{ms:.4f}", device_busy_ms=f"{busy:.4f}",
            host_ms="not timed" if host is None else f"{host:.4f}",
            plain_ms="not timed" if plain_ms is None else f"{plain_ms:.1f}",
            bound_ms=f"{bound_ms:.3g}", bound_by=bound_by, **more)


def db(err, ref):
    return 20.0 * torch.log10(torch.linalg.norm(err) / torch.linalg.norm(ref)).item()


def busy_ms(events):
    """``(ms, ops)``: the union of the profiled device ops' intervals and
    their number (but the marker kernels')."""
    spans = sorted(
        (e.time_range.start, e.time_range.end)
        for e in events
        if e.device_type == torch.autograd.DeviceType.CUDA and profiling._MARKER not in e.name
    )
    check(spans, "the profiler recorded no device op")
    busy_us, (start, end) = 0.0, spans[0]
    for s, e in spans[1:]:
        if s > end:
            busy_us, start, end = busy_us + end - start, s, e
        else:
            end = max(end, e)
    return (busy_us + end - start) / 1e3, len(spans)


def device_busy_ms(fn, reps):
    """Busy device ms per call of ``fn``, over ``reps`` calls under
    torch.profiler: the card's own time for a call whose CUDA-event time
    is the host's (a short call waits on its wrapper's Python)."""
    from torch.profiler import ProfilerActivity

    # the profiler may lose a short window's device events: bracket the
    # calls with two marker kernels and widen the window's margins until
    # it holds both (profiling.device_time_ms's rule)
    for margin in profiling._MARGINS_S:
        with profiling._window(margin, [ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1)
            for _ in range(reps):
                fn()
            torch.cuda._sleep(1)
        events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        if sum(profiling._MARKER in e.name for e in events) == 2:
            return busy_ms(events)[0] / reps
    raise SmokeFailure(f"the profiler lost device events with {profiling._MARGINS_S[-1]} s margins")


def profile_run(fn, out_dir, name, card):
    """One warm run of ``fn`` under torch.profiler.  The busy time is the
    union of the device ops' intervals; the idle share is the rest of the
    span the CUDA events measure."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ms, _ = device_ms(fn, reps=1)
        wall_ms = 1e3 * (time.perf_counter() - t0)
    busy, ops = busy_ms(prof.events())
    os.makedirs(out_dir, exist_ok=True)
    table = os.path.join(out_dir, f"profile_{name}.txt")
    with open(table, "w") as f:
        f.write(f"{card}\n")
        f.write(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=60))
    say("profile", run=name, device_ms=f"{ms:.3f}", host_wall_ms=f"{wall_ms:.3f}",
        device_busy_ms=f"{busy:.3f}", device_ops=ops,
        idle_share=f"{max(0.0, 1.0 - busy / ms):.3f}", table=table, card=repr(card))
    return busy


def serve_phase(args, smi, stats, phase, path, make_processors, exact=SERVE_REQUEST):
    """Phases 5 and 21: three eager requests of (4, 17, 2, 2^17) through the
    fused console built on ``make_processors()``, the kernels of ``exact``
    so many times a request (#1 and #2 once each) and nothing else;
    returns the console."""
    console = bench_console(CHAINS, seed=0, device="cuda", processors=make_processors())
    render = make_render_fn(console.fused_processors, console.plan, jit=False)
    requests = []
    for seed in (1, 2, 3):
        g = torch.Generator(device="cuda").manual_seed(seed)
        requests.append(torch.randn(BATCH, CHAINS, 2, AUDIO_LEN, generator=g, device="cuda"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    bal.reset_launch_counts()
    request_ms = []
    with torch.inference_mode():
        for x in requests:
            ms, (y, _, _) = device_ms(lambda x=x: render(x, console.params), reps=1)
            check(y.shape == (BATCH, 1, 2, AUDIO_LEN), f"{phase}: output shape {tuple(y.shape)}")
            check(bool(torch.isfinite(y).all()), f"{phase}: non-finite output")
            request_ms.append(ms)
    launches = read_launches(path, len(requests), stats, exact, exact)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    say(phase, requests=len(request_ms), request_ms=[round(t, 3) for t in request_ms],
        median_ms=f"{statistics.median(request_ms):.3f}", peak_mem_gib=f"{peak_gb:.2f}",
        launches=launches, card=repr(smi))
    if args.profile:
        with torch.inference_mode():
            profile_run(lambda: render(requests[-1], console.params), args.profile, path, smi)
    return console


def train_phase(args, smi, stats, phase, path, make_processors, nonzero=lambda leaf: True,
                exact=TRAIN_STEP):
    """Phases 6, 22, 25 and 26: three eager gradient steps of
    ``bench_trainer(17)`` on ``make_processors()`` at (4, 17, 2, 2^17),
    the kernels of ``exact`` so many times a step (#3-#6 once each) and
    nothing else (``nonzero`` as for :func:`train_steps`)."""
    trainer = bench_trainer(CHAINS, seed=0, device="cuda", processors=make_processors(), jit=False)
    g = torch.Generator(device="cuda").manual_seed(7)
    x = console_input((BATCH, CHAINS, 2, AUDIO_LEN), g, "cuda")
    target = torch.randn(BATCH, 1, 2, AUDIO_LEN, generator=g, device="cuda")
    fields = train_steps(trainer, x, target, nonzero=nonzero)
    launches = read_launches(path, fields["steps"], stats, exact, exact)
    say(phase, **fields, launches=launches, card=repr(smi))
    if args.profile:
        profile_run(lambda: trainer.step(x, target), args.profile, path, smi)


def render_card_vs_cpu(phase, make_processors, key_seed=None):
    """Phases 8, 21, 25 and 26: the served console on ``make_processors()``
    at batch 1, L = 2^14, on the card against the port's CPU path, on the
    key ``PRNGKey(key_seed)`` where one is given, <= -60 dB."""
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((1, CHAINS, 2, 2**14)).astype(np.float32))
    outs = {}
    for device in ("cuda", "cpu"):
        c = bench_console(CHAINS, seed=5, device=device, processors=make_processors())
        key = None if key_seed is None else random.PRNGKey(key_seed, device=device)
        with torch.inference_mode():
            outs[device] = make_render_fn(c.fused_processors, c.plan, jit=False)(
                x.to(device), c.params, rng=key)[0].cpu()
    card_db = db(outs["cuda"] - outs["cpu"], outs["cpu"])
    say(phase, db=f"{card_db:.1f}")
    check(bool(torch.isfinite(outs["cuda"]).all()), f"{phase}: non-finite card output")
    check(card_db <= -60.0, f"{phase}: card vs CPU at {card_db:.1f} dB > -60 dB")


def stream_phase(args, smi, stats, phase="stream", path="stream_block", make_processors=bench_processors,
                 key_seed=None, exact=STREAM_BLOCK):
    """Phases 9, 23, 25 and 26: the console on ``make_processors()``
    streamed in blocks (``StreamRenderer(rng=PRNGKey(key_seed))`` where a
    seed is given), the kernels of ``exact`` so many times a block (#7
    twice), against its one-shot render on the same key."""
    console = bench_console(CHAINS, seed=0, device="cuda", processors=make_processors())
    key = None if key_seed is None else random.PRNGKey(key_seed, device="cuda")
    streamer = StreamRenderer(console.fused_processors, console.plan, console.params,
                              block_len=BLOCK_LEN, jit=False, rng=key)
    g = torch.Generator(device="cuda").manual_seed(9)
    x = console_input((CHAINS, 2, AUDIO_LEN), g, "cuda")
    x_blocks = list(x.split(BLOCK_LEN, dim=-1))
    state = streamer.init_state()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    bal.reset_launch_counts()
    outs, block_ms, wall_ms = [], [], []
    with torch.inference_mode():
        for xb in x_blocks:
            t0 = time.perf_counter()
            ms, (y, state) = device_ms(lambda xb=xb, state=state: streamer(xb, state), reps=1)
            wall_ms.append(1e3 * (time.perf_counter() - t0))
            block_ms.append(ms)
            check(y.shape == (1, 2, BLOCK_LEN), f"stream block shape {tuple(y.shape)}")
            outs.append(y)
    launches = read_launches(path, len(x_blocks), stats, exact, exact)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    streamed = torch.cat(outs, dim=-1)
    check(bool(torch.isfinite(streamed).all()), "non-finite streamed output")
    wall = statistics.median(wall_ms[1:])
    block_s = BLOCK_LEN / SAMPLE_RATE
    say(phase, blocks=len(outs), block_len=BLOCK_LEN,
        block_ms=[round(t, 3) for t in block_ms], host_wall_ms=[round(t, 3) for t in wall_ms],
        warm_median_ms=f"{statistics.median(block_ms[1:]):.3f}", warm_median_wall_ms=f"{wall:.3f}",
        real_time_factor=f"{1e3 * block_s / wall:.2f}", peak_mem_gib=f"{peak_gb:.3f}",
        launches=launches, card=repr(smi))

    with torch.inference_mode():
        full = make_render_fn(console.fused_processors, console.plan, jit=False)(
            x, console.params, rng=key)[0]
        many, _ = streamer.step_many(torch.stack(x_blocks[:4]), streamer.init_state())
    peak_db = 20.0 * torch.log10((streamed - full).abs().max() / full.abs().max()).item()
    check(peak_db <= -60.0, f"{phase}: stream vs one-shot render at {peak_db:.1f} dB (max-abs/peak) > -60 dB")
    for k, (a, b) in enumerate(zip(outs, many)):
        check(torch.allclose(b, a, rtol=2e-5, atol=2e-6), f"{phase}: step_many block {k} != single step")
    say(phase, vs_one_shot_db=f"{peak_db:.1f}", step_many_k=len(many), step_many="equal")
    if args.profile:
        with torch.inference_mode():
            profile_run(lambda: streamer(x_blocks[-1], state), args.profile, path, smi)


def train_steps(trainer, x, target, steps=3, nonzero=lambda leaf: True):
    """``steps`` gradient steps, each timed by CUDA events; every trainable
    leaf gets a finite gradient, nonzero where ``nonzero(leaf path)``,
    every ``_absent`` mask stays frozen, and every other leaf moves or
    each of its SGD steps was below float32 resolution.  Returns the
    fields of the phase's line."""
    leaves = tree_items(trainer.params)
    start = {k: p.detach().clone() for k, p in leaves}
    lr = trainer.optimizer.param_groups[0]["lr"]
    largest_step = {k: torch.zeros_like(p) for k, p in leaves if p.requires_grad}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    bal.reset_launch_counts()
    step_ms, step_losses, zero_grad = [], [], set()
    for _ in range(steps):
        ms, (_, audio) = device_ms(lambda: trainer.step(x, target), reps=1)
        step_ms.append(ms)
        step_losses.append(audio.item())
        for k, p in leaves:
            if p.requires_grad:
                check(p.grad is not None and bool(torch.isfinite(p.grad).all()),
                      f"no finite gradient reached {k}")
                if not bool((p.grad != 0).any()):
                    check(not nonzero(k), f"no nonzero gradient reached {k}")
                    zero_grad.add(k)
                largest_step[k] = torch.maximum(largest_step[k], lr * p.grad.abs())
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    check(all(np.isfinite(step_losses)), f"non-finite losses {step_losses}")
    moved, frozen, below_ulp = 0, 0, []
    for k, p in leaves:
        same = torch.equal(p.detach(), start[k])
        if k.endswith("_absent"):
            check(same and not p.requires_grad, f"the absent mask {k} changed or trains")
            frozen += 1
        elif not same:
            moved += 1
        else:
            # a leaf may keep its value only where every SGD step was
            # below float32 resolution (half an ulp, within 2x) of it
            resolution = 0.5 * torch.finfo(torch.float32).eps * p.detach().abs()
            check(bool((largest_step[k] <= resolution).all()),
                  f"the trainable leaf {k} did not change, with steps above float32 resolution")
            below_ulp.append(k)
    return dict(steps=len(step_ms), step_ms=[round(t, 3) for t in step_ms],
                warm_median_ms=f"{statistics.median(step_ms[1:]):.3f}", peak_mem_gib=f"{peak_gb:.2f}",
                losses=[f"{v:.6f}" for v in step_losses], leaves_moved=moved,
                leaves_below_float32_step=below_ulp, absent_unchanged=frozen,
                **({"zero_gradient_leaves": sorted(zero_grad)} if zero_grad else {}))


def grad_card_vs_cpu(phase, make_processors, float64_spread=False):
    """The trainer's loss and every parameter gradient at batch 1, L =
    2^14, on the card against the port's CPU path: loss and concatenated
    gradient <= -60 dB, each nonzero leaf <= -40 dB (or, with
    ``float64_spread``, within the CPU's own float32 spread: see
    :func:`compare_card_cpu`), zero leaves zero."""
    g = torch.Generator().manual_seed(4)
    x = console_input((1, CHAINS, 2, 2**14), g, "cpu")
    target = torch.randn(1, 1, 2, 2**14, generator=g)
    losses, grads = {}, {}
    for device in ("cuda", "cpu"):
        tr = bench_trainer(CHAINS, seed=5, device=device, processors=make_processors())
        total, audio = tr.loss(x.to(device), target.to(device))
        total.backward()
        losses[device], grads[device] = audio, leaf_grads(tr.params)

    def cpu_float64():
        tr = bench_trainer(CHAINS, seed=5, device="cpu", processors=make_processors(), jit=False)
        for proc in tr.processors.values():
            proc.double()
        tr.params = tree_map(lambda p: p.detach().double().requires_grad_(p.requires_grad), tr.params)
        total, audio = tr.loss(x.double(), target.double())
        total.backward()
        return audio.detach(), leaf_grads(tr.params)

    say(phase, **compare_card_cpu(phase, losses, grads, cpu_float64 if float64_spread else None))


def leaf_grads(params):
    """``{leaf path: gradient on the CPU}``, zeros where a leaf has none."""
    return {k: torch.zeros(p.shape) if p.grad is None else p.grad.cpu()
            for k, p in tree_items(params)}


SPREAD_DB = 6.0  # a result held to the CPU's own float32 spread against float64: that spread + this


def spread_held(label, key, card, cpu, ref):
    """The CPU-spread rule for a result that float32 itself determines
    less well than a fixed bound asks: the card's ``card`` passes if it is
    no further from the CPU's float64 ``ref`` than the CPU's float32
    ``cpu`` is, plus SPREAD_DB.  Returns both distances."""
    ref = ref.double()
    card_db, cpu_db = db(card.double() - ref, ref), db(cpu.double() - ref, ref)
    check(card_db <= cpu_db + SPREAD_DB, f"{label}: {key} card vs float64 at {card_db:.1f} dB, above the CPU's"
                                         f" own float32 spread {cpu_db:.1f} dB + {SPREAD_DB} dB")
    return {"card_vs_float64_db": round(card_db, 1), "cpu_vs_float64_db": round(cpu_db, 1)}


def compare_card_cpu(phase, losses, grads, float64=None, whole=False):
    """Hold the card's loss and gradients (``{"cuda": ..., "cpu": ...}``)
    against the CPU's: loss and concatenated gradient <= -60 dB, each
    nonzero leaf <= -40 dB, leaves zero on the CPU zero on the card.
    Where a leaf is determined by float32 only to less than that (a
    gate's attack/release decisions on a smoothed log gain and a knee's
    few samples flip under rounding), ``float64`` gives the CPU's ``(loss,
    gradients)`` in double: a leaf above -40 dB then passes by
    :func:`spread_held`; with ``whole`` (phase 35 (a)'s classes whose
    every result float32 determines less well), so do the loss and the
    concatenated gradient above -60 dB.  Prints every leaf's dB first,
    then checks; returns the fields of the phase's line."""
    losses = {d: v.detach().cpu().double() for d, v in losses.items()}
    loss_db = db(losses["cuda"] - losses["cpu"], losses["cpu"])
    cat = {d: torch.cat([v.double().ravel() for v in grads[d].values()]) for d in grads}
    grad_db = db(cat["cuda"] - cat["cpu"], cat["cpu"])
    leaf_db, zero_leaves = {}, []
    for k, ref in grads["cpu"].items():
        if bool((ref != 0).any()):
            leaf_db[k] = db(grads["cuda"][k] - ref, ref)
        else:
            zero_leaves.append(k)
    say(phase, leaf_db={k: round(v, 1) for k, v in leaf_db.items()}, zero_leaves=zero_leaves)
    check(bool(torch.isfinite(cat["cuda"]).all()), f"{phase}: non-finite card gradient")
    bounds = {"loss": (loss_db, -60.0), "gradient": (grad_db, -60.0),
              **{f"gradient of {k}": (v, -40.0) for k, v in leaf_db.items()}}
    missed = [k for k, (v, bound_db) in bounds.items() if v > bound_db]
    held = [k for k in missed if whole or k.startswith("gradient of ")] if float64 is not None else []
    spread = {}
    if held:
        loss64, grads64 = float64()
        results = {"loss": (losses["cuda"], losses["cpu"], loss64),
                   "gradient": (cat["cuda"], cat["cpu"], torch.cat([v.double().ravel() for v in grads64.values()])),
                   **{f"gradient of {k}": (grads["cuda"][k], grads["cpu"][k], grads64[k]) for k in leaf_db}}
        spread = {k: spread_held(phase, k, *results[k]) for k in held}
        say(phase, held_to_the_cpu_float32_spread=spread)
    for k in missed:
        check(k in spread, f"{phase}: {k} card vs CPU at {bounds[k][0]:.1f} dB > {bounds[k][1]} dB")
    for k in zero_leaves:
        check(bool((grads["cuda"][k] == 0).all()), f"{phase}: gradient of {k} is zero on the CPU, not on the card")
    worst = max(leaf_db, key=leaf_db.get)
    return dict(loss_db=f"{loss_db:.1f}", grad_db=f"{grad_db:.1f}", worst_leaf_db=f"{leaf_db[worst]:.1f}",
                worst_leaf=worst, zero_leaves=len(zero_leaves), leaves=len(grads["cpu"]),
                **({"held_to_the_cpu_float32_spread": spread} if spread else {}))


def factorized_processors():
    """The bench.py console's processors with the documented factorized
    compressor in place of its compressors."""
    return {**bench_processors(), "compressor": FactorizedCompressor(frame_len=FRAME_LEN)}


def factorized_phase(args, smi, stats):
    """Phase 10: serve the factorized console once and take three of its
    gradient steps at full width, with the exact launch counts."""
    console = bench_console(CHAINS, seed=0, device="cuda", processors=factorized_processors())
    render = make_render_fn(console.fused_processors, console.plan, jit=False)
    x = torch.randn(BATCH, CHAINS, 2, AUDIO_LEN, generator=torch.Generator(device="cuda").manual_seed(1),
                    device="cuda")
    torch.cuda.synchronize()
    bal.reset_launch_counts()
    with torch.inference_mode():
        ms, (y, _, _) = device_ms(lambda: render(x, console.params), reps=1)
    check(y.shape == (BATCH, 1, 2, AUDIO_LEN), f"factorized output shape {tuple(y.shape)}")
    check(bool(torch.isfinite(y).all()), "non-finite factorized output")
    launches = read_launches("factorized_request", 1, stats, FACTORIZED_REQUEST, FACTORIZED_REQUEST)
    say("factorized", run="request", frame_len=FRAME_LEN, request_ms=f"{ms:.3f}",
        launches=launches, card=repr(smi))
    del console, render, x, y

    trainer = bench_trainer(CHAINS, seed=0, device="cuda", processors=factorized_processors(),
                            jit=False)
    g = torch.Generator(device="cuda").manual_seed(7)
    x = console_input((BATCH, CHAINS, 2, AUDIO_LEN), g, "cuda")
    target = torch.randn(BATCH, 1, 2, AUDIO_LEN, generator=g, device="cuda")
    # the frame means smooth away the short dips that reach a knee, so a
    # knee may get no gradient; every smoothing coefficient must (#6, #9)
    fields = train_steps(trainer, x, target, nonzero=lambda leaf: leaf.endswith("z_alpha_pre"))
    launches = read_launches("factorized_step", fields["steps"], stats, FACTORIZED_STEP,
                             FACTORIZED_STEP)
    say("factorized", run="train", **fields, launches=launches, card=repr(smi))
    if args.profile:
        profile_run(lambda: trainer.step(x, target), args.profile, "step_factorized", smi)


def rel_err(got, ref):
    """max |got - ref| over max |ref| (the max abs difference where ref
    is all zero)."""
    err, scale = max_err(got, ref), ref.abs().max().item()
    return err / scale if scale > 0 else err


def check_compiled(label, got, ref):
    """Hold a compiled path's output against its eager form's within
    COMPILED_REL of max|eager|; returns ``(relative error, bit-equal)``."""
    err = rel_err(got, ref)
    check(err <= COMPILED_REL, f"{label}: compiled vs eager at {err:.3g} of max|eager| > {COMPILED_REL}")
    return err, torch.equal(got, ref)


def call_ms(fn, calls=WARM_CALLS):
    """CUDA-event ms of each of ``calls`` calls of ``fn``."""
    return [device_ms(fn, reps=1)[0] for _ in range(calls)]


def peak_gib(fn):
    """Peak allocated device GiB over one call of ``fn``, from what is held
    before it."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() / 2**30


def eager_run(stats, path, runs=1):
    """Each kernel's launches in ``runs`` runs of an eager path (phases
    5-10), from its ``launches_per_run``."""
    return {name: runs * s["per_run"][path] for name, s in stats.items()}


def capturing_call(fn, label, expected, stats, path):
    """The call that captures a path, with every launch counter at 0 just
    before it and read just after.  A replay runs exactly the launches
    that were captured, so each kernel's count must equal ``expected``
    (:func:`eager_run`); it is kept as the kernel's ``launches_per_run``
    of ``path``.  Returns ``(its result, its wall seconds, the device GiB
    it reserved, the counts)``; the graph's pool is most of that memory."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_reserved()
    bal.reset_launch_counts()
    start = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    counts = bal.launch_counts()
    for name, count in counts.items():
        check(count == expected[name], f"{label}: the capture launched {name} {count} times,"
                                       f" an eager run {expected[name]:g}")
        stats[name]["per_run"][path] = count
    return out, seconds, (torch.cuda.memory_reserved() - before) / 2**30, counts


def perturbed(params):
    """Every parameter leaf plus 0.01; the ``_absent`` masks unchanged."""
    return {k: v if k == "_absent" else perturbed(v) if isinstance(v, dict) else v + 0.01
            for k, v in params.items()}


def ms_fields(eager_ms, compiled_ms):
    return dict(eager_ms=[round(t, 3) for t in eager_ms], compiled_ms=[round(t, 3) for t in compiled_ms],
                eager_median_ms=f"{statistics.median(eager_ms):.3f}",
                compiled_median_ms=f"{statistics.median(compiled_ms):.3f}")


def compiled_request_phase(args, smi, stats, path="request", make_processors=bench_processors):
    """Phases 12 and 21: the request of the console on
    ``make_processors()`` through ``make_render_fn(jit=True)`` (a call warms
    it, the next captures it) beside ``jit=False``: three replays (two
    inputs; one with every parameter changed) against eager, their outputs
    distinct; the capture's launches equal to an eager request's (of
    ``path``); warm calls of each timed, peaks, capture seconds."""
    console = bench_console(CHAINS, seed=0, device="cuda", processors=make_processors())
    eager = make_render_fn(console.fused_processors, console.plan, jit=False)
    compiled = make_render_fn(console.fused_processors, console.plan)
    xs = [torch.randn(BATCH, CHAINS, 2, AUDIO_LEN, generator=torch.Generator(device="cuda").manual_seed(s),
                      device="cuda") for s in (1, 2)]
    params, changed = console.params, perturbed(console.params)
    with torch.inference_mode():
        compiled(xs[0], params)  # warm-up: eager, on a side stream
        (y0, _, _), call_s, reserved, captured = capturing_call(
            lambda: compiled(xs[0], params), path, eager_run(stats, path), stats,
            f"{path}_compiled")
        y_changed, y1 = compiled(xs[0], changed)[0], compiled(xs[1], params)[0]
        refs = [eager(xs[0], params)[0], eager(xs[0], changed)[0], eager(xs[1], params)[0]]
        # eager against itself: the fan-in adds in a fixed order (no atomics)
        eager_repeat_equal = torch.equal(eager(xs[0], params)[0], refs[0])
        check(eager_repeat_equal, "request: the eager render of the same input differs from itself")
        errs = [check_compiled(f"request {k}", y, r) for k, (y, r) in enumerate(zip((y0, y_changed, y1), refs))]
        check(not torch.equal(y_changed, y0), "request: changed parameters left the replay's output as it was")
        check(len({y.data_ptr() for y in (y0, y_changed, y1)}) == 3, "request: two replays' outputs alias")
        eager_ms = call_ms(lambda: eager(xs[1], params))
        compiled_ms = call_ms(lambda: compiled(xs[1], params))
        peaks = peak_gib(lambda: eager(xs[1], params)), peak_gib(lambda: compiled(xs[1], params))
    say("compiled", path=path, **ms_fields(eager_ms, compiled_ms),
        max_rel_err=f"{max(e for e, _ in errs):.3g}", bit_equal=all(b for _, b in errs),
        eager_repeat_bit_equal=eager_repeat_equal, parameter_change="honoured", outputs_alias=False,
        captured_launches=captured, capture_s=f"{compiled.capture_seconds[-1]:.3f}", capturing_call_s=f"{call_s:.3f}",
        capture_reserved_gib=f"{reserved:.3f}", eager_peak_gib=f"{peaks[0]:.3f}",
        compiled_peak_gib=f"{peaks[1]:.3f}", card=repr(smi))
    if args.profile:
        with torch.inference_mode():
            profile_run(lambda: compiled(xs[1], params), args.profile, f"{path}_compiled", smi)
    return y0


def compiled_step_phase(args, smi, stats, path, eager_path, make_processors):
    """Phases 13 and 14: three steps of ``bench_trainer(jit=True)`` (the
    first eager on a side stream, the second captures the whole update)
    and three of ``jit=False`` from the same start: losses and every leaf
    within COMPILED_REL after each step; the capture's launches equal to
    an eager step's (``eager_path``); warm steps of each timed, peaks,
    capture seconds.  A keyless pseudo-random reverb draws a new crop on
    each eager call and keeps its capture's in every replay, so the eager
    trainer's third step draws its second crop again (``pin_crops``)."""
    g = torch.Generator(device="cuda").manual_seed(7)
    x = console_input((BATCH, CHAINS, 2, AUDIO_LEN), g, "cuda")
    target = torch.randn(BATCH, 1, 2, AUDIO_LEN, generator=g, device="cuda")
    eager = bench_trainer(CHAINS, seed=0, device="cuda", processors=make_processors(), jit=False)
    compiled = bench_trainer(CHAINS, seed=0, device="cuda", processors=make_processors())
    worst, bit_equal = 0.0, True
    for step in range(3):
        if step == 1:
            pinned = pin_crops(eager.processors)
        elif step == 2:
            pinned()
        total, audio = eager.step(x, target)
        if step == 1:
            (c_total, c_audio), call_s, reserved, captured = capturing_call(
                lambda: compiled.step(x, target), path, eager_run(stats, eager_path), stats,
                f"{path}_compiled")
        else:
            c_total, c_audio = compiled.step(x, target)
        torch.cuda.synchronize()
        pairs = [("loss", c_audio, audio), ("total", c_total, total)]
        pairs += [(k, p.detach(), q.detach())
                  for (k, p), (_, q) in zip(tree_items(compiled.params), tree_items(eager.params))]
        for k, got, ref in pairs:
            err, same = check_compiled(f"{path} step {step + 1} {k}", got, ref)
            worst, bit_equal = max(worst, err), bit_equal and same
    eager_ms = call_ms(lambda: eager.step(x, target))
    compiled_ms = call_ms(lambda: compiled.step(x, target))
    peaks = peak_gib(lambda: eager.step(x, target)), peak_gib(lambda: compiled.step(x, target))
    say("compiled", path=path, steps_compared=3, **ms_fields(eager_ms, compiled_ms),
        max_rel_err=f"{worst:.3g}", bit_equal=bit_equal, captured_launches=captured,
        capture_s=f"{compiled._update.capture_seconds[-1]:.3f}", capturing_call_s=f"{call_s:.3f}",
        capture_reserved_gib=f"{reserved:.3f}", eager_peak_gib=f"{peaks[0]:.3f}",
        compiled_peak_gib=f"{peaks[1]:.3f}", card=repr(smi))
    if args.profile:
        profile_run(lambda: compiled.step(x, target), args.profile, f"{path}_compiled", smi)
    return statistics.median(compiled_ms)


def compiled_stream_phase(args, smi, stats, path="stream_block", make_processors=bench_processors,
                          step_many=True, key_seed=None):
    """Phase 15: the stream of phase 9 through ``StreamRenderer(jit=True)``
    and ``jit=False`` in turns, block by block (block 1 warms the compiled
    step, block 2 captures it): each block against eager, device and wall
    ms a block, real-time factors; ``step_many(4)`` compiled (one graph of
    four block steps) against eager and timed a block; each capture's
    launches equal to one eager block's (four for ``step_many(4)``).
    Phases 23, 25 and 26 run it on their consoles (``path``), without
    ``step_many``, 25 and 26 with both streamers on ``PRNGKey(key_seed)``."""
    console = bench_console(CHAINS, seed=0, device="cuda", processors=make_processors())
    key = None if key_seed is None else random.PRNGKey(key_seed, device="cuda")
    streamers = {"eager": StreamRenderer(console.fused_processors, console.plan, console.params,
                                         block_len=BLOCK_LEN, jit=False, rng=key),
                 "compiled": StreamRenderer(console.fused_processors, console.plan, console.params,
                                            block_len=BLOCK_LEN, rng=key)}
    x = console_input((CHAINS, 2, AUDIO_LEN), torch.Generator(device="cuda").manual_seed(9), "cuda")
    blocks = list(x.split(BLOCK_LEN, dim=-1))
    states = {k: s.init_state() for k, s in streamers.items()}
    outs, ms, wall = ({k: [] for k in streamers} for _ in range(3))
    with torch.inference_mode():
        for i, xb in enumerate(blocks):
            for k, streamer in streamers.items():
                call = functools.partial(streamer, xb, states[k])
                start = time.perf_counter()
                if k == "compiled" and i == 1:  # block 2 captures the compiled step
                    t, (out, _, _, captured) = device_ms(functools.partial(
                        capturing_call, call, path, eager_run(stats, path),
                        stats, f"{path}_compiled"), reps=1)
                else:
                    t, out = device_ms(call, reps=1)
                wall[k].append(1e3 * (time.perf_counter() - start))
                y, states[k] = out
                ms[k].append(t)
                outs[k].append(y)
        errs = [check_compiled(f"stream block {i}", a, b) for i, (a, b) in
                enumerate(zip(outs["compiled"], outs["eager"]))]
        check(len({y.data_ptr() for y in outs["compiled"]}) == len(blocks), "stream: two blocks' outputs alias")
        compiled = streamers["compiled"]
        many_fields = step_many_check(streamers, blocks, stats, path) if step_many else {}
    block_s = BLOCK_LEN / SAMPLE_RATE
    fields = {}
    for k in streamers:  # blocks 3-32: past the compiled step's warm-up and capture
        med_ms, med_wall = statistics.median(ms[k][2:]), statistics.median(wall[k][2:])
        fields.update({f"{k}_median_ms": f"{med_ms:.3f}", f"{k}_median_wall_ms": f"{med_wall:.3f}",
                       f"{k}_real_time_factor": f"{1e3 * block_s / med_wall:.2f}"})
    say("compiled", path=path, blocks=len(blocks), block_len=BLOCK_LEN,
        eager_ms=[round(t, 3) for t in ms["eager"]], compiled_ms=[round(t, 3) for t in ms["compiled"]],
        compiled_wall_ms=[round(t, 3) for t in wall["compiled"]], **fields,
        max_rel_err=f"{max(e for e, _ in errs):.3g}", bit_equal=all(b for _, b in errs),
        captured_launches=captured, capture_s=[round(t, 3) for t in compiled._step_fn.capture_seconds],
        **many_fields, card=repr(smi))
    if args.profile:
        with torch.inference_mode():
            profile_run(lambda: compiled(blocks[-1], states["compiled"]), args.profile,
                        f"{path}_compiled", smi)


def step_many_check(streamers, blocks, stats, path="stream_block"):
    """``step_many(4)`` compiled (one graph of four block steps) against
    eager, its capture's launches four eager blocks' of ``path``, timed a
    block; returns the fields of the phase's line."""
    many = {k: [torch.stack(blocks[4 * i:4 * i + 4]) for i in range(3)] for k in streamers}
    m_eager = streamers["eager"].step_many(many["eager"][0], streamers["eager"].init_state())[0]
    compiled = streamers["compiled"]
    compiled.step_many(many["compiled"][0], compiled.init_state())  # warm-up
    (m_compiled, _), call_s, reserved, captured4 = capturing_call(
        lambda: compiled.step_many(many["compiled"][0], compiled.init_state()), "step_many(4)",
        eager_run(stats, path, runs=4), stats,
        "step_many4_compiled" if path == "stream_block" else f"{path}_step_many4_compiled")
    m_err = check_compiled("step_many(4)", m_compiled, m_eager)
    per_block = {k: [t / 4 for t in call_ms(lambda s=s, xs=many[k][1]: s.step_many(xs, s.init_state()))]
                 for k, s in streamers.items()}
    return {**{f"{k}_step_many4_ms_a_block": f"{statistics.median(per_block[k]):.3f}" for k in streamers},
            "step_many4_rel_err": f"{m_err[0]:.3g}", "step_many4_bit_equal": m_err[1],
            "step_many4_captured_launches": captured4, "step_many4_capturing_call_s": f"{call_s:.3f}",
            "step_many4_capture_reserved_gib": f"{reserved:.3f}"}


def serving_phase(smi, stats, make_processors=bench_processors, tag=""):
    """Phase 16, after every timed phase: ``serving.py`` on the card.  The
    console's render exported and loaded (three calls: warm-up, capture,
    replay; and changed parameters) against the live eager render; the
    stream step exported for one block (8 blocks, each against the live
    eager stream) and with ``blocks_per_step=4`` (3 calls against single
    live steps, the JAX test's rtol 2e-5 / atol 2e-6); each loaded
    program's capture launches what an eager request, block or four blocks
    launch.  Phase 32 runs it on the fsm console (``tag="_fsm"``: its
    complex FIR spectra become the artifact's constants), against the
    launches of phases 21 and 23."""
    console = bench_console(CHAINS, seed=0, device="cuda", processors=make_processors())
    live = make_render_fn(console.fused_processors, console.plan, jit=False)
    blobs, seconds = {}, {}
    start = time.perf_counter()
    # the example inputs fix shapes only
    blobs["render"] = export_render(make_render_fn(console.fused_processors, console.plan),
                                    torch.empty(BATCH, CHAINS, 2, AUDIO_LEN, device="cuda"),
                                    console.params)
    seconds["render"] = time.perf_counter() - start
    streamer = StreamRenderer(console.fused_processors, console.plan, console.params,
                              block_len=BLOCK_LEN)
    for name, k in (("stream_step", 1), ("stream_step4", 4)):
        start = time.perf_counter()
        blobs[name] = export_stream_step(streamer, torch.empty(CHAINS, 2, BLOCK_LEN, device="cuda"),
                                         blocks_per_step=k)
        seconds[name] = time.perf_counter() - start
    del streamer

    x = torch.randn(BATCH, CHAINS, 2, AUDIO_LEN, generator=torch.Generator(device="cuda").manual_seed(3),
                    device="cuda")
    params, changed = console.params, perturbed(console.params)
    start = time.perf_counter()
    served = load_render(blobs["render"])
    load_s = time.perf_counter() - start
    errs = []
    with torch.inference_mode():
        ref, ref_changed = live(x, params)[0], live(x, changed)[0]
        # eager against itself: the fan-in adds in a fixed order (no atomics)
        live_repeat_equal = torch.equal(live(x, params)[0], ref)
        check(live_repeat_equal, "serving: the live render of the same input differs from itself")
        errs.append(check_compiled("load_render call 1", served(x, params), ref))
        y, _, _, captured = capturing_call(lambda: served(x, params), f"load_render{tag}",
                                           eager_run(stats, f"request{tag}"), stats, f"load_render{tag}")
        errs.append(check_compiled("load_render call 2", y, ref))
        errs.append(check_compiled("load_render call 3", served(x, params), ref))
        errs.append(check_compiled("load_render, changed parameters", served(x, changed), ref_changed))
    say("serving", console=tag[1:] or "exact", run="render", export_s=f"{seconds['render']:.2f}", load_s=f"{load_s:.2f}",
        artifact_mib=f"{len(blobs['render']) / 2**20:.2f}", max_rel_err=f"{max(e for e, _ in errs):.3g}",
        bit_equal=all(b for _, b in errs), live_repeat_bit_equal=live_repeat_equal,
        captured_launches=captured)
    del served, ref, ref_changed, y

    blocks = list(console_input((CHAINS, 2, 12 * BLOCK_LEN), torch.Generator(device="cuda").manual_seed(9),
                                "cuda").split(BLOCK_LEN, dim=-1))
    start = time.perf_counter()
    step, state = load_stream_step(blobs["stream_step"])
    load_s = time.perf_counter() - start
    many, many_state = load_stream_step(blobs["stream_step4"])
    live_stream = StreamRenderer(console.fused_processors, console.plan, params, block_len=BLOCK_LEN,
                                 jit=False)
    live_state, errs, many_err = live_stream.init_state(), [], 0.0
    with torch.inference_mode():
        singles = []
        for xb in blocks:
            y, live_state = live_stream(xb, live_state)
            singles.append(y)
        for k, xb in enumerate(blocks[:8]):
            if k == 1:  # the loaded step's capture
                (y, state), _, _, captured = capturing_call(
                    functools.partial(step, xb, state), f"load_stream_step{tag}",
                    eager_run(stats, f"stream_block{tag}"), stats, f"load_stream_step{tag}")
            else:
                y, state = step(xb, state)
            errs.append(check_compiled(f"load_stream_step block {k + 1}", y, singles[k]))
        for i in range(3):
            call = functools.partial(many, torch.stack(blocks[4 * i:4 * i + 4]), many_state)
            if i == 1:
                (ys, many_state), _, _, captured4 = capturing_call(
                    call, f"load_stream_step{tag}(blocks_per_step=4)",
                    eager_run(stats, f"stream_block{tag}", runs=4), stats, f"load_stream_step4{tag}")
            else:
                ys, many_state = call()
            for k in range(4):
                ref = singles[4 * i + k]
                check(torch.allclose(ys[k], ref, rtol=2e-5, atol=2e-6),
                      f"load_stream_step(blocks_per_step=4) call {i + 1} block {k + 1} != single steps")
                many_err = max(many_err, max_err(ys[k], ref))
    say("serving", console=tag[1:] or "exact", run="stream_step", export_s=f"{seconds['stream_step']:.2f}",
        export4_s=f"{seconds['stream_step4']:.2f}", load_s=f"{load_s:.2f}",
        artifact_mib=f"{len(blobs['stream_step']) / 2**20:.2f}",
        max_rel_err=f"{max(e for e, _ in errs):.3g}", bit_equal=all(b for _, b in errs),
        blocks_per_step4_max_abs_err=f"{many_err:.3g}", captured_launches=captured,
        blocks_per_step4_captured_launches=captured4, card=repr(smi))


def synthetic_stems(num_tracks, length, generator):
    """Tonal and noisy stems with a spectrum of their own each, panned
    across the field (examples/match_mix.py's), ``(num_tracks, 2, length)``."""
    t = torch.arange(length) / SAMPLE_RATE
    stems = []
    for i in range(num_tracks):
        f0 = 80.0 * 2.0 ** (i / 2.0)
        tone = 0.3 * torch.sin(2 * np.pi * f0 * t) * torch.exp(-((t % 0.5) * 4))
        mono = tone + 0.05 * torch.randn(length, generator=generator)
        pan = i / max(num_tracks - 1, 1)
        stems.append(torch.stack([mono * (1 - 0.5 * pan), mono * (0.5 + 0.5 * pan)]))
    return torch.stack(stems)


def fit_console(delay=False, backend="exact"):
    """The fit console, ``mixing_console(16)`` (eq -> compressor -> gain a
    track, geq -> compressor on the bus, a reverb send: 70 nodes), with a
    delay after each track's gain where asked (86 nodes), its equalizers on
    the IIR ``backend``."""
    chain = ("eq", "compressor", "gain", "delay") if delay else ("eq", "compressor", "gain")
    return mixing_console(num_tracks=FIT_TRACKS, track_chain=chain, backend=backend)


def fit_optimizer(device, delay=False, jit=True, backend="exact", fuse=False):
    """The packaged fit loop on the fit console with its defaults
    (MR-STFT loss, Adam lr 1e-2), parameters drawn from seed 1 (on the
    unfused graph, whatever ``fuse``)."""
    return GraphParameterOptimizer(*fit_console(delay, backend), generator=torch.Generator().manual_seed(1),
                                   device=device, jit=jit, fuse=fuse)


def compressor_stages(plan):
    return sum(stage.node_type == "compressor" for stage in plan.iter_list)


def optimizer_model(make_optimizer):
    """A model for :func:`first_step`: ``device -> (forward, leaves)`` of
    the optimizer that ``make_optimizer(device)`` builds, ``forward(x) ->
    (output, auxiliary loss)`` its render at its parameters, ``leaves``
    its trainable ``(path, tensor)``s."""
    def model(device):
        opt = make_optimizer(device)

        def forward(x):
            out, intermediates, _ = opt.render(x, opt.params)
            return out, sum(v.sum() for inter in intermediates for v in tree_leaves(inter))

        return forward, [(k, p) for k, p in tree_items(opt.params) if p.requires_grad]

    return model


def fit_model(delay):
    """:func:`first_step`'s model of the fit optimizer (with ``delay``s),
    eager."""
    return optimizer_model(lambda device: fit_optimizer(device, delay=delay, jit=False))


def first_step(model, device, stems, target, perturb=0.0):
    """A first step at full width on ``device``: the output of
    ``model(device)``'s forward, the total and the audio (MR-STFT) loss,
    and every gradient of the total and of the MSE against the target;
    ``perturb`` scales relative noise on the stems."""
    forward, named = model(device)
    x = stems.to(device)
    if perturb:
        x = x * (1 + perturb * torch.randn(x.shape, generator=torch.Generator().manual_seed(5)).to(device))
    y = target.to(device)
    start = time.perf_counter()
    out, aux = forward(x)
    audio = multi_resolution_stft_loss(out, y)
    total = audio + aux
    names, leaves = [k for k, _ in named], [p for _, p in named]

    def grads(loss, retain):
        return {k: g.cpu() for k, g in zip(names, torch.autograd.grad(loss, leaves, retain_graph=retain))}

    result = dict(out=out.detach().cpu(), audio=audio.detach(), total=total.detach(),
                  grads=grads(total, True), mse_grads=grads(mse_loss(out, y), False))
    torch.cuda.synchronize()
    result["seconds"] = time.perf_counter() - start
    return result


def step_card_vs_cpu(phase, model, stems, target, mrstft_db=None):
    """``model``'s first step (:func:`first_step`) on the card against
    the CPU's at full width.  Gates: render, MR-STFT and total loss <=
    -60 dB; the render's backward, through the MSE's gradient, <= -60 dB
    (each leaf <= -40 dB).  The default loss's gradient is determined only
    as far as float32 lets its log-magnitude L1 term be: that gradient is
    a sum of per-bin signs, and where the card's render differs from the
    CPU's (by ``r``), bins near their target flip.  So it is held to the
    CPU's own spread: the CPU gradient with the stems moved by relative
    noise of size ``r``, plus 6 dB.  With ``mrstft_db``, a gradient within
    that many dB of the CPU's also passes.  Only phase 35 (c) passes it
    (-60 dB, phase 7's bound): its single-source chains' renders agree so
    closely (-134 dB) that ``r`` moves the CPU by less than float32
    resolves, and the spread falls below a gradient that is right.
    Phases 17, 19 and 34 go without it, so their checks stay what they
    were: their spreads (-9.9 to -45 dB) lie far above -60 dB, where such
    a floor could not change an outcome.  Returns the fields of the
    line."""
    card = first_step(model, "cuda", stems, target)
    cpu = first_step(model, "cpu", stems, target)
    render_db = db(card["out"] - cpu["out"], cpu["out"])
    check(bool(torch.isfinite(card["out"]).all()), f"{phase}: non-finite render")
    check(render_db <= -60.0, f"{phase}: render card vs CPU at {render_db:.1f} dB > -60 dB")
    total = {d: r["total"].cpu().double() for d, r in (("cuda", card), ("cpu", cpu))}
    total_db = db(total["cuda"] - total["cpu"], total["cpu"])
    check(total_db <= -60.0, f"{phase}: total loss card vs CPU at {total_db:.1f} dB > -60 dB")
    mse = compare_card_cpu(f"{phase} mse", {"cuda": card["audio"], "cpu": cpu["audio"]},
                           {"cuda": card["mse_grads"], "cpu": cpu["mse_grads"]})
    rel = torch.linalg.norm(card["out"] - cpu["out"]) / torch.linalg.norm(cpu["out"])
    moved = first_step(model, "cpu", stems, target, perturb=rel.item())
    cat = {k: torch.cat([v.ravel() for v in r["grads"].values()]) for k, r in
           (("cuda", card), ("cpu", cpu), ("moved", moved))}
    grad_db = db(cat["cuda"] - cat["cpu"], cat["cpu"])
    spread_db = db(cat["moved"] - cat["cpu"], cat["cpu"])
    leaf_db = {k: round(db(card["grads"][k] - v, v), 1) for k, v in cpu["grads"].items() if bool((v != 0).any())}
    say(phase, mrstft_leaf_db=leaf_db)
    check(bool(torch.isfinite(cat["cuda"]).all()), f"{phase}: non-finite card gradient")
    check(grad_db <= spread_db + 6.0 or (mrstft_db is not None and grad_db <= mrstft_db),
          f"{phase}: MR-STFT gradient card vs CPU at {grad_db:.1f} dB, above the CPU's own spread"
          f" {spread_db:.1f} dB + 6 dB" + ("" if mrstft_db is None else f" and above {mrstft_db} dB"))
    return dict(render_db=f"{render_db:.1f}", loss_db=mse["loss_db"], total_loss_db=f"{total_db:.1f}",
                mse_grad_db=mse["grad_db"], mse_worst_leaf_db=mse["worst_leaf_db"],
                mse_worst_leaf=mse["worst_leaf"], mrstft_grad_db=f"{grad_db:.1f}",
                mrstft_cpu_spread_db=f"{spread_db:.1f}", render_rel=f"{rel.item():.3g}",
                cpu_seconds=f"{cpu['seconds']:.1f}"), cpu


def fit_phase(args, smi, stats):
    """Phase 17: the packaged fit loop at full width.  The target: the
    ground truth (initial parameters + 0.3 N(0, 1), as
    examples/match_mix.py draws it) through ``render_current``, whose
    capture launches #2 once per compressor stage; then a fresh
    ``GraphParameterOptimizer`` with its defaults fits 20 steps (the
    second captures the whole update: #5 and #6 once per compressor
    stage), timed compiled and eager; its first step against the CPU's.
    Returns the stems, the target and (with ``--profile``) the compiled
    step's busy device ms."""
    stems = synthetic_stems(FIT_TRACKS, AUDIO_LEN, torch.Generator().manual_seed(0)).cuda()
    truth = fit_optimizer("cuda")
    stages = compressor_stages(truth.render_data)
    noise = torch.Generator().manual_seed(8)
    with torch.no_grad():
        for _, p in tree_items(truth.params):
            p.add_(0.3 * torch.randn(p.shape, generator=noise).cuda())
    truth.render_current(stems)  # warm-up: eager, on a side stream
    expected = {name: stages if name == "ballistics_gain_core" else 0 for name in KERNELS}
    target, _, _, render_launches = capturing_call(
        lambda: truth.render_current(stems), "fit render_current", expected, stats, "fit_render_compiled")
    check(target.shape == (1, 2, AUDIO_LEN) and bool(torch.isfinite(target).all()), "fit: bad target")

    opt = fit_optimizer("cuda")
    first_total, first_audio = opt.step(stems, target)  # eager, on a side stream
    first_grads = leaf_grads(opt.params)
    expected = {name: stages if name in ("ballistics_gain_fwd", "ballistics_gain_bwd") else 0
                for name in KERNELS}
    (_, audio), call_s, reserved, step_launches = capturing_call(
        lambda: opt.step(stems, target), "fit step", expected, stats, "fit_step_compiled")
    history = [first_audio.item(), audio.item()] + opt.fit(stems, target, num_steps=18)
    check(all(np.isfinite(history)), f"fit: non-finite losses {history}")
    check(history[-1] < history[0], f"fit: the loss did not fall ({history[0]} -> {history[-1]})")
    compiled_ms = call_ms(lambda: opt.step(stems, target))
    compiled_peak = peak_gib(lambda: opt.step(stems, target))
    eager = fit_optimizer("cuda", jit=False)
    eager_ms = call_ms(lambda: eager.step(stems, target), calls=3)
    eager_peak = peak_gib(lambda: eager.step(stems, target))
    say("fit", nodes=opt.G.number_of_nodes(), stems=tuple(stems.shape), steps=len(history),
        loss_first=f"{history[0]:.6f}", loss_last=f"{history[-1]:.6f}",
        losses=[round(v, 6) for v in history], compressor_stages=stages,
        compiled_ms=[round(t, 3) for t in compiled_ms],
        compiled_median_ms=f"{statistics.median(compiled_ms):.3f}",
        eager_ms=[round(t, 3) for t in eager_ms], eager_warm_median_ms=f"{statistics.median(eager_ms[1:]):.3f}",
        capture_s=f"{opt._update.capture_seconds[-1]:.3f}", capturing_call_s=f"{call_s:.3f}",
        capture_reserved_gib=f"{reserved:.3f}", compiled_peak_gib=f"{compiled_peak:.3f}",
        eager_peak_gib=f"{eager_peak:.3f}", render_captured_launches=render_launches,
        step_captured_launches=step_launches, card=repr(smi))
    fit_busy = None
    if args.profile:
        fit_busy = profile_run(lambda: opt.step(stems, target), args.profile, "fit_step_compiled", smi)
    del eager, truth

    fields, cpu = step_card_vs_cpu("fit_card_vs_cpu", fit_model(False), stems, target)
    # the compiled optimizer's own first step: the same loss and gradient
    first_db = db(first_audio.cpu().double() - cpu["audio"].double(), cpu["audio"].double())
    check(first_db <= -60.0, f"fit: the first step's loss against the CPU's at {first_db:.1f} dB > -60 dB")
    step_db = db(torch.cat([first_grads[k].ravel() for k in cpu["grads"]])
                 - torch.cat([v.ravel() for v in cpu["grads"].values()]),
                 torch.cat([v.ravel() for v in cpu["grads"].values()]))
    say("fit_card_vs_cpu", step=1, **fields, compiled_first_step_loss_db=f"{first_db:.1f}",
        compiled_first_step_grad_db=f"{step_db:.1f}")
    return stems, target, fit_busy


def resume_phase(stems, target):
    """Phase 18: save after 5 compiled steps; a fresh optimizer takes two
    (its graph captured), then restores: its parameters and Adam moments
    bit-equal to the saved ones in the same tensors, and 5 more steps
    whose losses equal those of steps 6-10 of the uninterrupted run bit
    for bit; a session round trip onto the card."""
    with tempfile.TemporaryDirectory() as directory:
        run = fit_optimizer("cuda")
        losses = run.fit(stems, target, num_steps=5)
        run.save(directory, metadata={"step": 5})
        losses += run.fit(stems, target, num_steps=5)

        resumed = fit_optimizer("cuda")
        resumed.fit(stems, target, num_steps=2)
        check(resumed._update.capture_seconds, "resume: the fresh optimizer captured no graph")
        tensors = [p for _, p in tree_items(resumed.params)]
        tensors += [v for state in resumed.optimizer.state.values() for v in state.values()]
        ptrs = [t.data_ptr() for t in tensors]
        check(resumed.restore(directory) == {"step": 5}, "resume: metadata lost")
        now = [p for _, p in tree_items(resumed.params)]
        now += [v for state in resumed.optimizer.state.values() for v in state.values()]
        check(all(a is b for a, b in zip(tensors, now)) and len(now) == len(tensors)
              and [t.data_ptr() for t in now] == ptrs, "resume: restore replaced a live tensor")
        saved_params = load_parameters(os.path.join(directory, PARAMS_FILE))
        check(all(torch.equal(p.detach().cpu(), saved)
                  for (_, p), (_, saved) in zip(tree_items(resumed.params), tree_items(saved_params))),
              "resume: the restored parameters differ from the saved ones")
        saved_state = torch.load(os.path.join(directory, OPT_STATE_FILE), weights_only=True)["state"]
        params = resumed.optimizer.param_groups[0]["params"]
        moments = 0
        for i, values in saved_state.items():
            live = resumed.optimizer.state[params[i]]
            for name, v in values.items():
                check(torch.equal(live[name].cpu(), v), f"resume: {name} of leaf {i} differs")
                moments += 1
        resumed_losses = resumed.fit(stems, target, num_steps=5)
        rel = max(abs(a - b) / abs(b) for a, b in zip(resumed_losses, losses[5:]))
        check(resumed_losses == losses[5:], f"resume: losses {resumed_losses} vs {losses[5:]}, rel {rel:.3g}")

        session = os.path.join(directory, "session")
        save_session(session, run.G, run.params, metadata={"steps": 10})
        G2, params2, meta = load_session(session, like=run.params)
        check(meta == {"steps": 10} and G2.number_of_nodes() == run.G.number_of_nodes(),
              "session: graph or metadata lost")
        check(all(q.is_cuda and torch.equal(q, p.detach())
                  for (_, p), (_, q) in zip(tree_items(run.params), tree_items(params2))),
              "session: parameters changed in the round trip")
    say("resume", saved_at=5, restored_after_captured_steps=2, tensors_in_place=len(tensors),
        state_entries_bit_equal=moments, params_bit_equal=True,
        losses_uninterrupted=[round(v, 7) for v in losses[5:]],
        losses_resumed=[round(v, 7) for v in resumed_losses], max_rel=f"{rel:.3g}",
        bit_equal=True, session_round_trip="equal, on the card")


def delay_phase(args, smi, stats, stems, target, fit_busy):
    """Phase 19: the fit console with a MultitapDelay after each track's
    gain: one render_current and one step on the card, and the step
    against the CPU's (step_card_vs_cpu); with ``--profile``, the
    delays' share of a compiled step's busy device time, derived against
    the fit step's."""
    opt = fit_optimizer("cuda", delay=True)
    bal.reset_launch_counts()
    out = opt.render_current(stems)
    total, audio = opt.step(stems, target)
    stages = compressor_stages(opt.render_data)
    read_launches("delay_render_and_step", 1, stats, ("ballistics_gain_core", "ballistics_gain_fwd",
                                                     "ballistics_gain_bwd"),
                  {"ballistics_gain_core": stages, "ballistics_gain_fwd": stages,
                   "ballistics_gain_bwd": stages})
    check(bool(torch.isfinite(out).all()) and bool(torch.isfinite(total)), "delay: non-finite render or loss")
    fields, cpu = step_card_vs_cpu("delay_card_vs_cpu", fit_model(True), stems, target)
    render_db = db(out.cpu() - cpu["out"], cpu["out"])
    check(render_db <= -60.0, f"delay: render_current card vs CPU at {render_db:.1f} dB > -60 dB")
    say("delay", nodes=opt.G.number_of_nodes(), render_current_db=f"{render_db:.1f}",
        radii_reg=f"{(total - audio).item():.4f}", **fields, card=repr(smi))
    if args.profile:
        opt.step(stems, target)  # captures
        delay_busy = profile_run(lambda: opt.step(stems, target), args.profile, "delay_step_compiled", smi)
        say("delay", share_of_step_busy=f"{1.0 - fit_busy / delay_busy:.3f}",
            derived="1 - busy(fit step) / busy(delay step), both compiled")


def predictor_loss(predictor, device, stems, target):
    """``() -> MR-STFT loss`` of the fit console rendered eagerly with the
    parameters ``predictor`` gives, each node conditioned on its stem's
    audio_features (the bus and the send on the mix's), on ``device``;
    and the number of compressor stages."""
    G, procs = fit_console()
    for proc in procs.values():
        proc.to(device)
    plan = prepare_render(reorder_for_fast_render(convert_to_tensor(G), method="beam"))
    render = make_render_fn(procs, plan, jit=False)
    x, y = stems.to(device), target.to(device)
    feats = audio_features(torch.cat([x, x.sum(0, keepdim=True)]))
    per_type = features_per_type(G, procs, feats[:FIT_TRACKS], feats[FIT_TRACKS])
    stages = compressor_stages(plan)
    return (lambda: multi_resolution_stft_loss(render(x, predictor(per_type))[0], y)), stages


def predictor_phase(smi, stats, stems, target):
    """Phase 20: ParameterPredictor on the fit console: its first loss on
    the card against the CPU's on the same weights, then 10 eager Adam
    steps of its weights through the render (#5 and #6 once per
    compressor stage a step); the loss must fall."""
    predictor = ParameterPredictor(fit_console()[1], generator=torch.Generator().manual_seed(2))
    cpu_loss, _ = predictor_loss(predictor, "cpu", stems, target)
    start = time.perf_counter()
    with torch.no_grad():
        loss_cpu = cpu_loss().double()
    cpu_s = time.perf_counter() - start
    loss_fn, stages = predictor_loss(predictor.cuda(), "cuda", stems, target)
    opt = torch.optim.Adam(predictor.parameters(), lr=3e-3)

    def train_step():
        opt.zero_grad(set_to_none=True)
        loss = loss_fn()
        loss.backward()
        opt.step()
        return loss.detach()

    bal.reset_launch_counts()
    history, step_ms = [], []
    for _ in range(PREDICTOR_STEPS):
        ms, loss = device_ms(train_step, reps=1)
        history.append(loss.item())
        step_ms.append(ms)
    launches = read_launches("predictor_step", PREDICTOR_STEPS, stats,
                             ("ballistics_gain_fwd", "ballistics_gain_bwd"),
                             {"ballistics_gain_fwd": stages, "ballistics_gain_bwd": stages})
    check(all(np.isfinite(history)) and history[-1] < history[0],
          f"predictor: the loss did not fall: {history}")
    loss_db = db(torch.tensor(history[0], dtype=torch.float64) - loss_cpu, loss_cpu)
    check(loss_db <= -60.0, f"predictor: first loss card vs CPU at {loss_db:.1f} dB > -60 dB")
    say("predictor", steps=len(history), losses=[round(v, 6) for v in history],
        step_ms=[round(t, 3) for t in step_ms], warm_median_ms=f"{statistics.median(step_ms[1:]):.3f}",
        first_loss_card_vs_cpu_db=f"{loss_db:.1f}", cpu_seconds=f"{cpu_s:.1f}",
        weights=sum(p.numel() for p in predictor.parameters()), compressor_stages=stages,
        launches=launches, card=repr(smi))


def fsm_processors():
    """The bench.py console's processors with their equalizers on the
    default IIR backend, the frequency-sampled FIR (fsm)."""
    return bench_processors(backend="fsm")


def fused_types(G, processors):
    """``{fused type: (processor class, nodes)}`` of a fused graph."""
    return {t: (type(p).__name__, sum(G.nodes[n]["node_type"] == t for n in G.nodes))
            for t, p in processors.items() if t.startswith("fused(")}


def fsm_serve_phase(args, smi, stats):
    """Phase 21: the console on fsm equalizers served at full width: its
    FIR chains, three eager requests (#1 and #2 once each), the compiled
    request against eager (phase 12's checks), the card against the CPU,
    and the fsm render's own distance from the exact console's on the same
    parameters (the FSM approximation's gap, printed, not gated)."""
    console = serve_phase(args, smi, stats, "fsm_serve", "request_fsm", fsm_processors)
    types = fused_types(console.fused_graph, console.fused_processors)
    say("fsm_serve", fused_types=types)
    check(types.get("fused(eq+geq)") == ("FusedFIRChain", 9), f"fsm: eq -> geq runs fused as {types}")
    check(types.get("fused(eq+gain)") == ("FusedFIRChain", 1), f"fsm: the master eq -> gain fused as {types}")
    compiled_request_phase(args, smi, stats, "request_fsm", fsm_processors)
    render_card_vs_cpu("fsm_card_vs_cpu", fsm_processors)
    exact = bench_console(CHAINS, seed=0, device="cuda")
    x = torch.randn(BATCH, CHAINS, 2, AUDIO_LEN, generator=torch.Generator(device="cuda").manual_seed(1),
                    device="cuda")
    with torch.inference_mode():
        y = {name: make_render_fn(c.fused_processors, c.plan, jit=False)(x, c.params)[0]
             for name, c in (("fsm", console), ("exact", exact))}
    say("fsm_serve", fsm_vs_exact_db=f"{db(y['fsm'] - y['exact'], y['exact']):.1f}",
        note="the FSM approximation's own gap (4000-tap sampled FIRs), not gated")


def fused_delay_phase(args, smi, stats, stems, target):
    """Phase 24: the fit console with a delay after each track's gain,
    ``GraphParameterOptimizer(fuse=True)`` on the exact and the fsm
    backends: gain -> delay folds into FusedFIRChain on the 16 tracks; one
    eager ``render_current`` (#2 once a compressor stage) and one eager step
    (#5 and #6 once a compressor stage); the fused render against the
    unfused one (``fuse=False``, the same parameters) within FUSED_REL of
    max|ref|; the compiled step captured (its launches one eager step's)
    and timed."""
    for backend in ("exact", "fsm"):
        unfused = fit_optimizer("cuda", delay=True, jit=False, backend=backend)
        fused = fit_optimizer("cuda", delay=True, jit=False, backend=backend, fuse=True)
        types = fused_types(fused.G, fused.processors)
        check(types == {"fused(gain+delay)": ("FusedFIRChain", FIT_TRACKS)},
              f"fused delay console ({backend}): fused types {types}")
        stages = compressor_stages(fused.render_data)
        reference = unfused.render_current(stems)
        bal.reset_launch_counts()
        out = fused.render_current(stems)
        total, audio = fused.step(stems, target)
        path = "step_fused_delay" if backend == "exact" else "step_fused_delay_fsm"
        launches = read_launches(path, 1, stats, FUSED_DELAY_STEP, {name: stages for name in FUSED_DELAY_STEP})
        check(bool(torch.isfinite(out).all()) and bool(torch.isfinite(total)),
              f"fused delay console ({backend}): non-finite render or loss")
        err = rel_err(out, reference)
        check(err <= FUSED_REL, f"fused delay console ({backend}): fused vs unfused render at {err:.3g}"
                                f" of max|ref| > {FUSED_REL}")
        del unfused
        compiled = fit_optimizer("cuda", delay=True, backend=backend, fuse=True)
        compiled.step(stems, target)  # warm-up: eager, on a side stream
        expected = {name: stages if name in FUSED_DELAY_STEP[1:] else 0 for name in KERNELS}
        (_, c_audio), call_s, reserved, captured = capturing_call(
            lambda: compiled.step(stems, target), f"fused delay step ({backend})", expected, stats,
            f"{path}_compiled")
        compiled_ms = call_ms(lambda: compiled.step(stems, target))
        eager_ms = call_ms(lambda: fused.step(stems, target), calls=3)
        compiled_peak = peak_gib(lambda: compiled.step(stems, target))
        say("fused_delay", backend=backend, nodes=fused.G.number_of_nodes(), fused_types=types,
            compressor_stages=stages, fused_vs_unfused_rel=f"{err:.3g}", loss=f"{audio.item():.6f}",
            radii_reg=f"{(total - audio).item():.4f}", launches=launches, captured_launches=captured,
            compiled_ms=[round(t, 3) for t in compiled_ms],
            compiled_median_ms=f"{statistics.median(compiled_ms):.3f}",
            eager_ms=[round(t, 3) for t in eager_ms], eager_warm_median_ms=f"{statistics.median(eager_ms[1:]):.3f}",
            capture_s=f"{compiled._update.capture_seconds[-1]:.3f}", capturing_call_s=f"{call_s:.3f}",
            capture_reserved_gib=f"{reserved:.3f}", compiled_peak_gib=f"{compiled_peak:.3f}", card=repr(smi))
        if args.profile:
            profile_run(lambda: compiled.step(stems, target), args.profile, f"{path}_compiled", smi)
        del fused, compiled


def pin_crops(processors):
    """Save the host draw state of every keyless pseudo-random reverb in
    ``processors`` (a fused chain's members included); the returned call
    restores it, so that their next draws repeat."""
    reverbs = [m for p in processors.values() for m in p.modules()
               if isinstance(m, FilteredNoiseShapingReverb)]
    saved = [copy.deepcopy(r._crop_rng) for r in reverbs]

    def restore():
        for r, state in zip(reverbs, saved):
            r._crop_rng = copy.deepcopy(state)

    return restore


def noise_processors():
    """Phase 25's console: bench.py's processors, exact backend, with the
    filtered-noise reverb (its defaults: ir_len 60000, 12 bands, midside,
    pseudo-random) and the piecewise tanh distortion."""
    return {**bench_processors(), "reverb": FilteredNoiseShapingReverb(),
            "dist": PiecewiseTanhDistortion()}


def fdn_processors():
    """Phase 26's console: bench.py's processors with the feedback delay
    network (ir_len 30000, 6 lines, stereo) and the Chebyshev distortion."""
    return {**bench_processors(), "reverb": FeedbackDelayNetwork(), "dist": ChebyshevDistortion()}


def keyed_request_phase(args, smi, stats, phase, path, make_processors, noisy):
    """Phases 25 and 26: the console's request through
    ``make_render_fn(jit=True)`` with a fresh key each request (the key is
    a captured argument) beside ``jit=False`` on the same keys: each replay
    within COMPILED_REL of eager; the same key renders the same, bit for
    bit, and a new key another render where the console draws noise
    (``noisy``), the same bit for bit where it does not; the capture's
    launches one eager request's; warm calls of each timed with fresh keys,
    peaks."""
    console = bench_console(CHAINS, seed=0, device="cuda", processors=make_processors())
    eager = make_render_fn(console.fused_processors, console.plan, jit=False)
    compiled = make_render_fn(console.fused_processors, console.plan)
    x = torch.randn(BATCH, CHAINS, 2, AUDIO_LEN, generator=torch.Generator(device="cuda").manual_seed(1),
                    device="cuda")
    keys = [random.fold_in(random.PRNGKey(25, device="cuda"), i) for i in range(4 + 2 * WARM_CALLS)]
    params = console.params
    with torch.inference_mode():
        compiled(x, params, rng=keys[0])  # warm-up: eager, on a side stream
        (y0, _, _), call_s, reserved, captured = capturing_call(
            lambda: compiled(x, params, rng=keys[1]), phase, eager_run(stats, path), stats,
            f"{path}_compiled")
        replays = [compiled(x, params, rng=k)[0] for k in keys[1:4]]
        refs = [eager(x, params, rng=k)[0] for k in keys[1:4]]
        errs = [check_compiled(f"{phase} request {k}", y, r) for k, (y, r) in enumerate(zip(replays, refs))]
        same = rel_err(replays[0], y0)
        check(torch.equal(replays[0], y0), f"{phase}: the same key rendered {same:.3g} of max|ref| apart")
        other = rel_err(replays[1], replays[0])
        if noisy:
            check(other > 1e-3, f"{phase}: a new key left the render as it was ({other:.3g})")
        else:
            check(torch.equal(replays[1], replays[0]),
                  f"{phase}: a new key changed a render that draws no noise ({other:.3g})")
        fresh = iter(keys[4:])
        eager_ms = call_ms(lambda: eager(x, params, rng=next(fresh)))
        compiled_ms = call_ms(lambda: compiled(x, params, rng=next(fresh)))
        peaks = peak_gib(lambda: eager(x, params, rng=keys[0])), peak_gib(lambda: compiled(x, params, rng=keys[0]))
        check(all(bool(torch.isfinite(y).all()) for y in replays), f"{phase}: non-finite replay")
    say("compiled", path=path, **ms_fields(eager_ms, compiled_ms),
        max_rel_err=f"{max(e for e, _ in errs):.3g}", same_key_rel=f"{same:.3g}",
        new_key_rel=f"{other:.3g}", captured_launches=captured,
        capture_s=f"{compiled.capture_seconds[-1]:.3f}", capturing_call_s=f"{call_s:.3f}",
        capture_reserved_gib=f"{reserved:.3f}", eager_peak_gib=f"{peaks[0]:.3f}",
        compiled_peak_gib=f"{peaks[1]:.3f}", card=repr(smi))
    if args.profile:
        with torch.inference_mode():
            profile_run(lambda: compiled(x, params, rng=keys[0]), args.profile, f"{path}_compiled", smi)


def console_phases(args, smi, stats, tag, make_processors, noisy, key_seed, nonzero=lambda leaf: True):
    """Phases 25 and 26: the console on ``make_processors()`` served
    (eager requests, #1 and #2 once each; compiled requests on fresh keys;
    card vs CPU on one key), trained (eager steps, #3-#6 once each, every
    leaf where ``nonzero`` with a nonzero gradient; compiled steps against
    eager; the loss and gradients card vs CPU) and streamed on a key
    (eager, #7 twice a block, against the one-shot render on that key;
    compiled against eager)."""
    serve_phase(args, smi, stats, f"{tag}_serve", f"request_{tag}", make_processors)
    keyed_request_phase(args, smi, stats, f"{tag}_request", f"request_{tag}", make_processors, noisy)
    render_card_vs_cpu(f"{tag}_card_vs_cpu", make_processors, key_seed=key_seed)
    train_phase(args, smi, stats, f"{tag}_train", f"step_{tag}", make_processors, nonzero)
    compiled_step_phase(args, smi, stats, f"step_{tag}", f"step_{tag}", make_processors)
    grad_card_vs_cpu(f"{tag}_grad_card_vs_cpu", make_processors)
    stream_phase(args, smi, stats, f"{tag}_stream", f"stream_block_{tag}", make_processors,
                 key_seed=key_seed)
    compiled_stream_phase(args, smi, stats, f"stream_block_{tag}", make_processors, step_many=False,
                          key_seed=key_seed)


LIBRARY_ROWS, LIBRARY_LEN = BATCH * CHAINS, AUDIO_LEN  # 68 x 2 x 2^17, as phase 27 runs each class


def library_cases():
    """Phase 27's ``(name, processor factory, channels in, keyed)``: each
    class this slice ported, at its defaults."""
    return [
        ("FilteredNoiseShapingReverb", FilteredNoiseShapingReverb, 2, True),
        ("FeedbackDelayNetwork", FeedbackDelayNetwork, 2, False),
        ("STFTMaskedNoiseReverb(fixed_noise=False)",
         functools.partial(STFTMaskedNoiseReverb, fixed_noise=False), 2, True),
        ("SideGainImager", SideGainImager, 2, False),
        ("MonoToStereo", MonoToStereo, 1, False),
        ("StereoToMidSide", StereoToMidSide, 2, False),
        ("PiecewiseTanhDistortion", PiecewiseTanhDistortion, 2, False),
        ("PowerDistortion", PowerDistortion, 2, False),
        ("ChebyshevDistortion", ChebyshevDistortion, 2, False),
    ]


def library_phase(smi):
    """Phase 27: each class of this slice at 68 x 2 x 2^17 (MonoToStereo on
    one channel; MidSideToStereo on StereoToMidSide's two outlets), on the
    card against the port's CPU path on the same parameters and key, <=
    -60 dB, with its device ms; PowerDistortion's gradient at input that is
    a third exact zeros, finite on the card and against the CPU's; and two
    renders card vs CPU: DryWet(PiecewiseTanhDistortion) with its weight
    through ``common_parameters``, and rng through a SerialChain (gain ->
    filtered-noise reverb), whose same key renders the same and new key
    another."""
    rng = np.random.default_rng(27)
    for name, make, channels, keyed in library_cases():
        procs = {d: make().to(d) for d in ("cuda", "cpu")}
        x = torch.from_numpy(
            (0.5 * rng.standard_normal((LIBRARY_ROWS, channels, LIBRARY_LEN))).astype(np.float32))
        params = {k: torch.from_numpy((0.5 * rng.standard_normal(
            (LIBRARY_ROWS,) + ((v,) if isinstance(v, int) else tuple(v)))).astype(np.float32))
            for k, v in procs["cpu"].parameter_size().items()}
        outs, ms = {}, None
        for d, proc in procs.items():
            kw = {"noise_key": random.PRNGKey(27, device=d)} if keyed else {}
            p = {k: v.to(d) for k, v in params.items()}
            with torch.inference_mode():
                call = functools.partial(proc, x.to(d), **p, **kw)
                out = call()
                if d == "cuda":
                    ms = device_ms(call, reps=3)[0]
                outs[d] = [y.cpu() for y in (out if isinstance(out, list) else [out])]
        if name == "StereoToMidSide":
            with torch.inference_mode():
                outs = {d: outs[d] + [MidSideToStereo()(*[y.to(d) for y in outs[d]]).cpu()] for d in outs}
        card_db = max(db(a - b, b) for a, b in zip(outs["cuda"], outs["cpu"]))
        check(all(bool(torch.isfinite(y).all()) for y in outs["cuda"]), f"library: {name} non-finite on the card")
        check(card_db <= -60.0, f"library: {name} card vs CPU at {card_db:.1f} dB > -60 dB")
        say("library", cls=name, shape=(LIBRARY_ROWS, channels, LIBRARY_LEN), card_vs_cpu_db=f"{card_db:.1f}",
            card_ms=f"{ms:.3f}", card=repr(smi))
        del procs, outs

    # PowerDistortion's gradient where the input is exactly 0
    x = (0.5 * rng.standard_normal((LIBRARY_ROWS, 2, LIBRARY_LEN))).astype(np.float32)
    x[:, :, ::3] = 0.0
    w = rng.standard_normal((LIBRARY_ROWS, 10)).astype(np.float32) * 0.3
    g = (0.1 * rng.standard_normal((LIBRARY_ROWS, 1))).astype(np.float32)
    grads = {}
    for d in ("cuda", "cpu"):
        xt = torch.tensor(x, device=d, requires_grad=True)
        wt, gt = torch.tensor(w, device=d, requires_grad=True), torch.tensor(g, device=d, requires_grad=True)
        PowerDistortion()(xt, wt, gt).square().sum().backward()
        grads[d] = [t.grad.cpu() for t in (xt, wt, gt)]
    check(all(bool(torch.isfinite(t).all()) for t in grads["cuda"]), "library: PowerDistortion gradient at 0 non-finite")
    grad_db = max(db(a - b, b) for a, b in zip(grads["cuda"], grads["cpu"]))
    check(grad_db <= -60.0, f"library: PowerDistortion gradient card vs CPU at {grad_db:.1f} dB > -60 dB")
    say("library", cls="PowerDistortion gradient, a third of the input exactly 0",
        card_vs_cpu_db=f"{grad_db:.1f}", finite=True)
    del grads

    # DryWet through common_parameters, and rng through a container
    x = torch.from_numpy((0.5 * rng.standard_normal((BATCH, 1, 2, LIBRARY_LEN))).astype(np.float32))
    for label, make, common, keys in (
        ("drywet_common_parameters",
         lambda: {"fx": DryWet(PiecewiseTanhDistortion(), external_param=True)}, True, (None,)),
        ("rng_through_container",
         lambda: {"fx": SerialChain({"gain": StereoGain(), "rev": FilteredNoiseShapingReverb(
             processor_channel="stereo")})}, False, (3, 3, 4)),
    ):
        outs = {}
        for d in ("cuda", "cpu"):
            G = GRAFX(config=NodeConfigs(["fx"]))
            G.add_serial_chain(["in", "fx", "fx", "out"])
            procs = {k: v.to(d) for k, v in make().items()}
            plan = prepare_render(reorder_for_fast_render(convert_to_tensor(G), method="greedy"))
            params = tree_map(lambda v: v.to(d), create_empty_parameters(
                procs, G, std=0.5, generator=torch.Generator().manual_seed(27)))
            kw = {"common_parameters": {"drywet_weight": torch.linspace(
                -2.0, 2.0, G.number_of_nodes(), device=d)[:, None]}} if common else {}
            render = make_render_fn(procs, plan, jit=False)
            with torch.inference_mode():
                outs[d] = [render(x.to(d), params, rng=None if k is None else random.PRNGKey(k, device=d),
                                  **kw)[0].cpu() for k in keys]
        card_db = max(db(a - b, b) for a, b in zip(outs["cuda"], outs["cpu"]))
        check(card_db <= -60.0, f"library: {label} card vs CPU at {card_db:.1f} dB > -60 dB")
        fields = {}
        if len(keys) == 3:
            same, other = rel_err(outs["cuda"][1], outs["cuda"][0]), rel_err(outs["cuda"][2], outs["cuda"][0])
            check(same == 0.0 and other > 1e-3,
                  f"library: {label}: same key {same:.3g} apart, new key {other:.3g} apart")
            fields = dict(same_key_rel=f"{same:.3g}", new_key_rel=f"{other:.3g}")
        say("library", render=label, shape=tuple(x.shape), card_vs_cpu_db=f"{card_db:.1f}", **fields)


# phases 28-31: the rest of the render engine, the public surface's host
# pieces and the convolution forms
PAIR_TYPE = "fused(noisegate+compressor)"  # the console's gate -> compressor composite (#1, #3/#4)
SCHEDULE_DB = -120.0  # a schedule's render against the beam plan's (and a batched render against its parts)
STEP_DB = -60.0  # a one-by-one step's loss and gradients against the beam trainer's
CONV_DB = -100.0  # the convolution forms against one another
BATCHED_CONSOLES = 4
# phase 31's shapes: (label, rows, channels, signal length, taps)
CONV_CASES = (
    ("console reverb", BATCH * CHAINS, 2, AUDIO_LEN, 30000),
    ("filtered-noise reverb", BATCH * CHAINS, 2, AUDIO_LEN, 60000),
    ("crossover FIR", BATCH * CHAINS, 2, 2 * AUDIO_LEN, 2000),
)


def median_s(fn, reps=5):
    """Median host seconds of ``reps`` calls of ``fn``; its last result."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        times.append(time.perf_counter() - t0)
    return statistics.median(times), out


def rebind(params, G, method, **order_kwargs):
    """``params`` of ``G`` (per-type rows bound to nodes by the beam
    schedule, as ``fuse_parameters`` binds them) bound instead by
    ``method``'s schedule, so that every node keeps its own values."""
    src = _scheduled_type_rows(G, "beam")
    dst = _scheduled_type_rows(G, method, **order_kwargs)
    out = {}
    for t, sub in params.items():
        rows = {dst[n]: src[n] for n in G.nodes if G.nodes[n]["node_type"] == t}
        idx = [rows[r] for r in range(len(rows))]
        out[t] = tree_map(lambda a, idx=idx: a[torch.as_tensor(idx, device=a.device)], sub)
    return out


def stage_launches(plan):
    """#1 and #2's launches in one request of a console plan: one a stage
    of the pair composite and of the plain compressor."""
    types = [s.node_type for s in plan.iter_list]
    return {"ballistics_gain_pair_core": types.count(PAIR_TYPE),
            "ballistics_gain_core": types.count("compressor")}


def schedules_phase(smi, stats, device="cuda"):
    """Phase 28: the exact console scheduled by ``"beam"``, ``"greedy"``,
    ``"fixed"`` (the beam's own type sequence as ``fixed_order``) and
    ``"one-by-one"``, with the host's set-up seconds (the native beam
    search against the numpy one, both the same schedule), three eager
    requests each, #1 and #2 once a stage of their types (one-by-one:
    once a node; beam: once each), and each render against the beam
    plan's, <= SCHEDULE_DB."""
    check(native_available(), "the native scheduler did not build (g++)")
    G, procs = bench_graph(CHAINS), bench_processors()
    fuse_s, (G_f, procs_f) = median_s(lambda: fuse_serial_lti(
        G, procs, kinds=("fir", "iir", "dynamics"), dynamics_pad="auto"))
    params = create_empty_parameters(procs, G, generator=torch.Generator().manual_seed(0))
    migrate_s, params_f = median_s(lambda: fuse_parameters(params, G, G_f, procs_f))
    params_f = tree_map(lambda a: a.to(device), params_f)
    for p in procs_f.values():
        p.to(device)
    beam_s = {}
    for label, graph in (("unfused", G), ("fused", G_f)):
        G_t = convert_to_tensor(graph)
        native_s, native = median_s(lambda: beam_search(G_t, use_native=True))
        numpy_s, numpy_ = median_s(lambda: beam_search(G_t, use_native=False))
        check(all(np.array_equal(a, b) for a, b in zip(native, numpy_)),
              f"schedules: native and numpy beam searches differ on the {label} console")
        beam_s[label] = {"nodes": G_t.num_nodes, "native_s": f"{native_s:.6f}", "numpy_s": f"{numpy_s:.6f}"}
    say("schedules", native_available=True, fuse_s=f"{fuse_s:.4f}", fuse_parameters_s=f"{migrate_s:.4f}",
        beam_search=beam_s)
    beam_seq, _ = compute_render_order(convert_to_tensor(G_f), method="beam")
    requests = [torch.randn(BATCH, CHAINS, 2, AUDIO_LEN, generator=torch.Generator(device=device).manual_seed(s),
                            device=device) for s in (1, 2, 3)]
    ref = None
    results = {}
    for method, kw in (("beam", {}), ("greedy", {}), ("fixed", {"fixed_order": beam_seq}), ("one-by-one", {})):
        convert_s, G_t = median_s(lambda: convert_to_tensor(G_f))
        schedule_s, G_t = median_s(lambda: reorder_for_fast_render(G_t, method=method, **kw))
        prepare_s, plan = median_s(lambda: prepare_render(G_t))
        p = params_f if method == "beam" else rebind(params_f, G_f, method, **kw)
        render = make_render_fn(procs_f, plan, jit=False)
        path = "request_" + method.replace("-", "_")
        expected = stage_launches(plan)
        if method == "beam":
            check(expected == SERVE_REQUEST, f"schedules: beam launches {expected}, not {SERVE_REQUEST}")
        elif method == "one-by-one":
            nodes = [G_f.nodes[n]["node_type"] for n in G_f.nodes]
            check(expected == {"ballistics_gain_pair_core": nodes.count(PAIR_TYPE),
                               "ballistics_gain_core": nodes.count("compressor")},
                  f"schedules: one-by-one plan has stages {expected}, not one a node")
        bal.reset_launch_counts()
        request_ms, outs = [], []
        with torch.inference_mode():
            for x in requests:
                ms, (y, _, _) = device_ms(lambda x=x: render(x, p), reps=1)
                check(y.shape == (BATCH, 1, 2, AUDIO_LEN) and bool(torch.isfinite(y).all()),
                      f"schedules: {method} output {tuple(y.shape)} not finite or of the wrong shape")
                request_ms.append(ms)
                outs.append(y)
        launches = read_launches(path, len(requests), stats, SERVE_KERNELS, expected)
        if ref is None:
            ref = outs
        err_db = max(db(y - r, r) for y, r in zip(outs, ref)) if method != "beam" else None
        if err_db is not None:
            check(err_db <= SCHEDULE_DB, f"schedules: {method} render vs beam at {err_db:.1f} dB > {SCHEDULE_DB}")
        results[method] = statistics.median(request_ms)
        say("schedules", method=method, stages=plan.max_order + 1, convert_s=f"{convert_s:.5f}",
            schedule_s=f"{schedule_s:.5f}", prepare_s=f"{prepare_s:.5f}",
            request_ms=[round(t, 3) for t in request_ms], median_ms=f"{results[method]:.3f}",
            vs_beam_db="reference" if err_db is None else f"{err_db:.1f}", launches=launches,
            card=repr(smi))
        del outs
    say("schedules", one_by_one_over_beam=f"{results['one-by-one'] / results['beam']:.2f}")


def array_buffer_phase(smi, stats, device="cuda"):
    """Phase 29: the beam plan rendered with ``buffer_mode="array"``, eager
    and compiled, against ``"stages"`` (within COMPILED_REL of max|y|; the
    capture launches one eager request's); then a gradient step of
    ``GraphParameterOptimizer(method="one-by-one")`` against the beam
    trainer's on the same parameters and inputs (the loss and every
    gradient <= STEP_DB), and its second step captured (one eager
    one-by-one step's launches) against the beam trainer's second."""
    console = bench_console(CHAINS, seed=0, device=device)
    stages = make_render_fn(console.fused_processors, console.plan, jit=False)
    eager = make_render_fn(console.fused_processors, console.plan, jit=False, buffer_mode="array")
    compiled = make_render_fn(console.fused_processors, console.plan, buffer_mode="array")
    x = torch.randn(BATCH, CHAINS, 2, AUDIO_LEN, generator=torch.Generator(device=device).manual_seed(1),
                    device=device)
    params = console.params
    with torch.inference_mode():
        ref = stages(x, params)[0]
        y_eager, _, buf = eager(x, params)
        check(buf.shape == (BATCH, console.plan.num_buffers, 2, AUDIO_LEN),
              f"array buffer of shape {tuple(buf.shape)}")
        del buf
        compiled(x, params)  # warm-up: eager, on a side stream
        (y_compiled, _, _), call_s, reserved, captured = capturing_call(
            lambda: compiled(x, params), "array buffer", eager_run(stats, "request"), stats,
            "request_array_compiled")
        errs = [check_compiled(f"array buffer {label}", y, ref)
                for label, y in (("eager", y_eager), ("compiled", y_compiled))]
        eager_ms = call_ms(lambda: eager(x, params))
        compiled_ms = call_ms(lambda: compiled(x, params))
        peak = peak_gib(lambda: eager(x, params))
    say("array_buffer", **ms_fields(eager_ms, compiled_ms), eager_vs_stages_rel=f"{errs[0][0]:.3g}",
        compiled_vs_stages_rel=f"{errs[1][0]:.3g}", captured_launches=captured,
        capture_s=f"{compiled.capture_seconds[-1]:.3f}", eager_peak_gib=f"{peak:.3f}", card=repr(smi))
    del console, stages, eager, compiled, x, ref, y_eager, y_compiled

    g = torch.Generator(device=device).manual_seed(7)
    x = console_input((BATCH, CHAINS, 2, AUDIO_LEN), g, device)
    target = torch.randn(BATCH, 1, 2, AUDIO_LEN, generator=g, device=device)
    beam = bench_trainer(CHAINS, seed=0, device=device, jit=False)
    one = GraphParameterOptimizer(bench_graph(CHAINS), bench_processors(), loss_fn=mse_loss,
                                  optimizer=lambda ps: torch.optim.SGD(ps, lr=1e-3),
                                  generator=torch.Generator().manual_seed(0), fuse="pad-auto",
                                  device=device, method="one-by-one")
    with torch.no_grad():
        for (_, a), (_, b) in zip(tree_items(one.params), tree_items(rebind(beam.params, one.G, "one-by-one"))):
            a.copy_(b)
    nodes = [one.G.nodes[n]["node_type"] for n in one.G.nodes]
    per_node = {"ballistics_gain_pair_fwd": nodes.count(PAIR_TYPE), "ballistics_gain_pair_bwd": nodes.count(PAIR_TYPE),
                "ballistics_gain_fwd": nodes.count("compressor"), "ballistics_gain_bwd": nodes.count("compressor")}
    bal.reset_launch_counts()
    ms, (_, loss_one) = device_ms(lambda: one.step(x, target), reps=1)  # eager, on a side stream
    launches = read_launches("step_one_by_one", 1, stats, TRAIN_KERNELS, per_node)
    _, loss_beam = beam.step(x, target)
    grads = {}
    for name, trainer in (("beam", beam), ("one", one)):
        tree = tree_map(lambda q: torch.zeros_like(q) if q.grad is None else q.grad.detach().clone(),
                        trainer.params)
        grads[name] = tree if name == "one" else rebind(tree, one.G, "one-by-one")
    loss_db = db((loss_one - loss_beam).double(), loss_beam.double())
    leaf_db, zero = {}, 0
    for (k, a), (_, b) in zip(tree_items(grads["one"]), tree_items(grads["beam"])):
        if bool((b != 0).any()):
            leaf_db[k] = db(a - b, b)
        else:
            check(bool((a == 0).all()), f"one-by-one step: gradient of {k} nonzero where the beam step's is zero")
            zero += 1
    check(loss_db <= STEP_DB, f"one-by-one step: loss vs beam at {loss_db:.1f} dB > {STEP_DB}")
    worst = max(leaf_db, key=leaf_db.get)
    check(leaf_db[worst] <= STEP_DB,
          f"one-by-one step: gradient of {worst} vs beam at {leaf_db[worst]:.1f} dB > {STEP_DB}")
    (_, loss_one2), call_s, reserved, captured = capturing_call(
        lambda: one.step(x, target), "one-by-one step", eager_run(stats, "step_one_by_one"), stats,
        "step_one_by_one_compiled")
    _, loss_beam2 = beam.step(x, target)
    loss2_db = db((loss_one2 - loss_beam2).double(), loss_beam2.double())
    check(loss2_db <= STEP_DB, f"one-by-one captured step: loss vs beam at {loss2_db:.1f} dB > {STEP_DB}")
    compiled_ms = call_ms(lambda: one.step(x, target), calls=3)
    beam_ms = call_ms(lambda: beam.step(x, target), calls=3)
    say("one_by_one_step", eager_first_step_ms=f"{ms:.3f}", loss_db=f"{loss_db:.1f}",
        worst_leaf_db=f"{leaf_db[worst]:.1f}", worst_leaf=worst, leaves=len(leaf_db), zero_leaves=zero,
        second_step_loss_db=f"{loss2_db:.1f}", launches=launches, captured_launches=captured,
        capture_s=f"{one._update.capture_seconds[-1]:.3f}", compiled_ms=[round(t, 3) for t in compiled_ms],
        beam_eager_ms=[round(t, 3) for t in beam_ms], card=repr(smi))


def batched_parameters(params, graphs, GB):
    """Per-type parameters of ``batch_grafx(graphs)`` (bound by its beam
    schedule) from each graph's ``params[i]`` (bound by that graph's)."""
    rows_b = _scheduled_type_rows(GB, "beam")
    rows = [_scheduled_type_rows(G, "beam") for G in graphs]
    offsets = [sum(G.number_of_nodes() for G in graphs[:i]) for i in range(len(graphs))]
    out = {}
    for t in params[0]:
        picks = sorted((rows_b[n + offsets[i]], i, rows[i][n]) for i, G in enumerate(graphs)
                       for n in G.nodes if G.nodes[n]["node_type"] == t)
        out[t] = tree_map(lambda *leaves: torch.stack([leaves[i][r] for _, i, r in picks]),
                          *[p[t] for p in params])
    return out


def batched_phase(smi, stats, device="cuda"):
    """Phase 30: ``batch_grafx`` of BATCHED_CONSOLES exact consoles, each
    with parameters from its own seed, fused and rendered as one graph
    from a 3-dim input (one source a row) against each console rendered
    alone (<= SCHEDULE_DB), #1 and #2 once each, with the native and numpy
    beam searches' seconds on the batched graph."""
    G0 = bench_graph(CHAINS)
    graphs = [G0.copy() for _ in range(BATCHED_CONSOLES)]
    batch_s, GB = median_s(lambda: batch_grafx(graphs))
    check(GB.batch and GB.counter == [G0.number_of_nodes() * (i + 1) for i in range(BATCHED_CONSOLES)],
          f"batch_grafx: counter {GB.counter}")
    procs = bench_processors()
    kw = dict(kinds=("fir", "iir", "dynamics"), dynamics_pad="auto")
    GB_f, procs_bf = fuse_serial_lti(GB, procs, **kw)
    G1_f, procs_1f = fuse_serial_lti(G0, procs, **kw)
    params = [create_empty_parameters(procs, G, std=0.1, generator=torch.Generator().manual_seed(30 + i))
              for i, G in enumerate(graphs)]
    beam_s = {}
    for label, graph in (("unfused", GB), ("fused", GB_f)):
        G_t = convert_to_tensor(graph)
        native_s, native = median_s(lambda: beam_search(G_t, use_native=True))
        numpy_s, numpy_ = median_s(lambda: beam_search(G_t, use_native=False))
        check(all(np.array_equal(a, b) for a, b in zip(native, numpy_)),
              f"batched: native and numpy beam searches differ on the {label} graph")
        beam_s[label] = {"nodes": G_t.num_nodes, "native_s": f"{native_s:.6f}", "numpy_s": f"{numpy_s:.6f}"}
    plan_b = prepare_render(reorder_for_fast_render(convert_to_tensor(GB_f), method="beam"))
    plan_1 = prepare_render(reorder_for_fast_render(convert_to_tensor(G1_f), method="beam"))
    params_b = tree_map(lambda a: a.to(device),
                        fuse_parameters(batched_parameters(params, graphs, GB), GB, GB_f, procs_bf))
    for p in (*procs_bf.values(), *procs_1f.values()):
        p.to(device)
    x = torch.randn(BATCHED_CONSOLES * CHAINS, 2, AUDIO_LEN, device=device,
                    generator=torch.Generator(device=device).manual_seed(30))
    render_b = make_render_fn(procs_bf, plan_b, jit=False)
    render_1 = make_render_fn(procs_1f, plan_1, jit=False)
    with torch.inference_mode():
        bal.reset_launch_counts()
        batched_ms, (y, _, _) = device_ms(lambda: render_b(x, params_b), reps=1)
        launches = read_launches("request_batched", 1, stats, SERVE_KERNELS, SERVE_REQUEST)
        check(y.shape == (BATCHED_CONSOLES, 2, AUDIO_LEN), f"batched: output shape {tuple(y.shape)}")
        alone_ms, errs = [], []
        for i in range(BATCHED_CONSOLES):
            p_i = tree_map(lambda a: a.to(device), fuse_parameters(params[i], graphs[i], G1_f, procs_1f))
            ms, (y_i, _, _) = device_ms(lambda: render_1(x[i * CHAINS:(i + 1) * CHAINS], p_i), reps=1)
            alone_ms.append(ms)
            errs.append(db(y[i] - y_i[0], y_i[0]))
    worst = max(errs)
    check(bool(torch.isfinite(y).all()), "batched: non-finite output")
    check(worst <= SCHEDULE_DB, f"batched: a console vs its render alone at {worst:.1f} dB > {SCHEDULE_DB}")
    spread = max(rel_err(y[i], y[0]) for i in range(1, BATCHED_CONSOLES))
    check(spread > 1e-3, "batched: the consoles' parameter seeds rendered the same")
    say("batched", graphs=BATCHED_CONSOLES, nodes=GB.number_of_nodes(), fused_nodes=GB_f.number_of_nodes(),
        batch_grafx_s=f"{batch_s:.5f}", beam_search=beam_s, stages=plan_b.max_order + 1,
        batched_ms=f"{batched_ms:.3f}", alone_ms=[round(t, 3) for t in alone_ms],
        vs_alone_db=[round(e, 1) for e in errs], launches=launches, card=repr(smi))


def conv_forms_phase(smi, device="cuda"):
    """Phase 31: ``fft_convolve`` (one full-length FFT, the port's
    default) against ``fft_convolve_os`` and ``fft_convolve_upols`` at
    CONV_CASES, the forms within CONV_DB of one another, each timed by
    ``profiling.device_time_ms`` (the sum of its device ops, within 0.5-1.1
    of the CUDA-event time of this work on one stream, the least of three
    spans of five calls) and by CUDA events,
    beside the form ``grafx_tpu`` would pick there
    (``_auto_os_block``, tuned on the TPU); ``FIRFilter(overlap_save=True)``
    against ``overlap_save=False``."""
    gen = torch.Generator(device=device).manual_seed(31)
    for label, rows, channels, length, taps in CONV_CASES:
        x = torch.randn(rows, channels, length, generator=gen, device=device)
        h = torch.randn(rows, channels, taps, generator=gen, device=device) / taps ** 0.5
        pick = _auto_os_block(length, taps, 0)
        forms = {"one_shot": lambda: fft_convolve(x, h, mode="causal"),
                 "os": lambda: fft_convolve_os(x, h, mode="causal"),
                 "upols": lambda: fft_convolve_upols(x, h, mode="causal")}
        if pick is not None and pick[0] == "os":
            forms["os_reference_block"] = lambda: fft_convolve_os(x, h, mode="causal", block=pick[1])
        fields, outs = {}, {}
        with torch.inference_mode():
            for name, fn in forms.items():
                outs[name] = fn()  # warm-up: cuFFT plans
                summed = profiling.device_time_ms(fn)
                # the span of 5 calls, the least of 3 spans: a host stall of a
                # few ms between two enqueues (seen on the card's shared host)
                # idles the card inside one span and stretches it
                spans = [device_ms(fn, reps=5)[0] for _ in range(3)]
                ms = min(spans)
                # one stream: the call's device ops fit in its CUDA-event span
                check(0.5 * ms <= summed <= 1.1 * ms,
                      f"conv_forms: {label} {name}: device_time_ms {summed:.3f} against {ms:.3f} ms"
                      f" (spans {[round(t, 3) for t in spans]})")
                fields[name] = {"ms": f"{ms:.3f}", "device_time_ms": f"{summed:.3f}"}
        ref = outs["one_shot"]
        for name, y in outs.items():
            check(bool(torch.isfinite(y).all()), f"conv_forms: {label} {name} non-finite")
            if name != "one_shot":
                err = db(y - ref, ref)
                check(err <= CONV_DB, f"conv_forms: {label} {name} vs one-shot at {err:.1f} dB > {CONV_DB}")
                fields[name]["vs_one_shot_db"] = f"{err:.1f}"
        say("conv_forms", case=label, shape=(rows, channels, length), taps=taps,
            reference_pick="one_shot" if pick is None else list(pick), forms=fields, card=repr(smi))
        del x, h, outs, ref
    x = torch.randn(BATCH * CHAINS, 2, AUDIO_LEN, generator=gen, device=device)
    fir = 0.1 * torch.randn(BATCH * CHAINS, 1, 1023, generator=gen, device=device)
    with torch.inference_mode():
        ys = {flag: FIRFilter(overlap_save=flag)(x, fir) for flag in (False, True)}
        ms = {flag: device_ms(lambda flag=flag: FIRFilter(overlap_save=flag)(x, fir), reps=5)[0]
              for flag in (False, True)}
    err = db(ys[True] - ys[False], ys[False])
    check(err <= CONV_DB, f"conv_forms: FIRFilter(overlap_save=True) vs False at {err:.1f} dB > {CONV_DB}")
    say("conv_forms", case="FIRFilter(fir_len=1023)", shape=tuple(x.shape), overlap_save_db=f"{err:.1f}",
        one_shot_ms=f"{ms[False]:.3f}", overlap_save_ms=f"{ms[True]:.3f}", card=repr(smi))


def device_time_cross_check(smi, device="cuda"):
    """Phase 31's last line: ``profiling.device_time_ms`` (a sum of the
    device ops' durations) against this script's ``device_busy_ms`` (the
    union of their intervals) on two replays of the compiled request.  On
    one replay the sum is never below the union; across two it may be by
    their spread, so the gate is 0.95 of it."""
    console = bench_console(CHAINS, seed=0, device=device)
    compiled = make_render_fn(console.fused_processors, console.plan)
    x = torch.randn(BATCH, CHAINS, 2, AUDIO_LEN, generator=torch.Generator(device=device).manual_seed(1),
                    device=device)
    with torch.inference_mode():
        for _ in range(3):  # warm-up, capture, a replay
            compiled(x, console.params)
        summed = profiling.device_time_ms(lambda: compiled(x, console.params))
        union = device_busy_ms(lambda: compiled(x, console.params), reps=1)
    check(summed >= 0.95 * union, f"device_time_ms {summed:.3f} below 0.95 of the busy union {union:.3f}")
    say("device_time", path="request_compiled", device_time_ms_sum=f"{summed:.3f}",
        device_busy_ms_union=f"{union:.3f}", sum_over_union=f"{summed / union:.3f}", card=repr(smi))


# phase 32: parallel/ on torch.distributed, each rank a process of its own
PARALLEL_TIMEOUT_S = 360  # one spawn of ranks, their set-up included
SHARED_NCCL_TIMEOUT_S = 120
RANK_RENDER_TOL = dict(rtol=1e-5, atol=1e-6)  # tests/test_parallel.py:60
RANK_GRAD_TOL = dict(rtol=2e-4, atol=1e-7)  # tests/test_parallel.py:247
GLOO_NEEDED = ("all_gather", "all_reduce")  # what parallel/ calls


def rank_init(rank, world, directory, store, backend, device_index):
    """Join the ranks of one spawn: rendezvous on a FileStore in
    ``directory``, the card ``device_index``, TF32 off as in phase 1."""
    torch.cuda.set_device(device_index)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kwargs = {"device_id": torch.device("cuda", device_index)} if backend == "nccl" else {}
    dist.init_process_group(backend, store=dist.FileStore(os.path.join(directory, store), world),
                            rank=rank, world_size=world, **kwargs)


def write_rank(directory, name, rank, result):
    with open(os.path.join(directory, f"{name}_rank{rank}.json"), "w") as f:
        json.dump(result, f)


def run_ranks(fn, world, directory, name, timeout=PARALLEL_TIMEOUT_S, allow_timeout=False):
    """Spawn ``world`` ranks of ``fn(rank, world, directory)``, wait for
    them (a rank that raises fails the phase, and the others are
    stopped), and return each rank's JSON result; every process is gone
    on return.  With ``allow_timeout`` ranks still running at ``timeout``
    are killed and ``None`` is returned."""
    context = mp.start_processes(fn, args=(world, directory), nprocs=world, join=False,
                                 start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not context.join(timeout=5):
            if time.monotonic() > deadline:
                if allow_timeout:
                    return None
                raise SmokeFailure(f"parallel: {name} ranks still running after {timeout} s")
    finally:
        for process in context.processes:
            if process.is_alive():
                process.kill()
            process.join()
    results = []
    for rank in range(world):
        with open(os.path.join(directory, f"{name}_rank{rank}.json")) as f:
            results.append(json.load(f))
    return results


def log_rows():
    """Have every kernel launch log its rows: ``{wrapper: [rows, ...]}``,
    cleared by the caller."""
    rows = {}
    launch = bal._run

    def logged(name, fn_name, u, *args):
        rows.setdefault(name, []).append(int(u.shape[0]))
        return launch(name, fn_name, u, *args)

    bal._run = logged
    return rows


def launched():
    return {k: v for k, v in bal.launch_counts().items() if v}


def nccl_rank(rank, world, directory):
    """Phase 32 (a), one rank over NCCL, one card each: three captured
    data-parallel steps of ``bench_trainer(17)`` (its render through
    ``shard_render_step``) against the unsharded compiled step from the
    same start, the captured step's launches, ms a step (both, and the
    sharded step eager); one captured sharded request against phase 12's
    output, and its ms beside the eager sharded request's.  One rank is
    held within COMPILED_REL; more ranks (a machine with more cards)
    within the gradients' rtol 2e-4."""
    rank_init(rank, world, directory, "store_nccl", "nccl", rank)
    try:
        rows = log_rows()
        mesh = parallel.make_mesh()
        sharding = parallel.batch_sharding(mesh)
        g = torch.Generator(device="cuda").manual_seed(7)
        x = console_input((BATCH, CHAINS, 2, AUDIO_LEN), g, "cuda")
        target = torch.randn(BATCH, 1, 2, AUDIO_LEN, generator=g, device="cuda")
        local = parallel.local_shard(x, sharding)
        ref = bench_trainer(CHAINS, seed=0, device="cuda")
        dp = bench_trainer(CHAINS, seed=0, device="cuda")
        dp.render = parallel.shard_render_step(dp.render, mesh, jit=False)
        # one rank computes what the unsharded step does; more ranks walk
        # and transform fewer rows a call (other chunks and cuFFT plans)
        limit = COMPILED_REL if world == 1 else RANK_GRAD_TOL["rtol"]
        worst = 0.0
        for step in range(3):
            _, r_audio = ref.step(x, target)
            if step == 1:  # the capture: launches of one step
                torch.cuda.synchronize()
                bal.reset_launch_counts()
                rows.clear()
            _, audio = dp.step(local, target)
            torch.cuda.synchronize()
            if step == 1:
                captured, step_rows = bal.launch_counts(), copy.deepcopy(rows)
            pairs = [("loss", audio, r_audio)] + [
                (k, p.detach(), q.detach())
                for (k, p), (_, q) in zip(tree_items(dp.params), tree_items(ref.params))]
            for k, got, want in pairs:
                worst = max(worst, rel_err(got, want))
            check(worst <= limit, f"rank {rank}: data-parallel step {step + 1} at {worst:.3g} of max|unsharded|")
        for name, count in captured.items():
            check(count == TRAIN_STEP.get(name, 0),
                  f"rank {rank}: the captured data-parallel step launched {name} {count} times")
        step_ms = {"sharded_compiled": call_ms(lambda: dp.step(local, target)),
                   "unsharded_compiled": call_ms(lambda: ref.step(x, target))}
        del ref
        eager = bench_trainer(CHAINS, seed=0, device="cuda", jit=False)
        eager.render = parallel.shard_render_step(eager.render, mesh, jit=False)
        step_ms["sharded_eager"] = call_ms(lambda: eager.step(local, target))
        del eager, dp

        console = bench_console(CHAINS, seed=0, device="cuda")
        plain = make_render_fn(console.fused_processors, console.plan, jit=False)
        request = parallel.shard_render_step(plain, mesh)
        request_eager = parallel.shard_render_step(plain, mesh, jit=False)
        x1 = torch.randn(BATCH, CHAINS, 2, AUDIO_LEN, device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(1))
        local1 = parallel.local_shard(x1, sharding)
        y12 = torch.load(os.path.join(directory, "request_phase12.pt"), map_location=f"cuda:{rank}")
        with torch.inference_mode():
            request(local1, console.params)  # warm-up: eager, on a side stream
            torch.cuda.synchronize()
            bal.reset_launch_counts()
            rows.clear()
            request(local1, console.params)  # the capture
            torch.cuda.synchronize()
            request_captured, request_rows = launched(), copy.deepcopy(rows)
            y = request(local1, console.params)[0]
            request_err, request_bit_equal = rel_err(y, y12), torch.equal(y, y12)
            check(request_err <= limit, f"rank {rank}: the sharded request at {request_err:.3g} of max|phase 12's|")
            request_ms = {"sharded_compiled": call_ms(lambda: request(local1, console.params)),
                          "sharded_eager": call_ms(lambda: request_eager(local1, console.params))}
        check(request_captured == SERVE_REQUEST,
              f"rank {rank}: the captured sharded request launched {request_captured}")
        write_rank(directory, "nccl", rank, {
            "rank": rank, "card": torch.cuda.get_device_name(rank), "backend": dist.get_backend(),
            "local_rows": local.shape[0], "step_max_rel_err": worst,
            "step_captured_launches": {k: v for k, v in captured.items() if v}, "step_rows": step_rows,
            "request_rows": request_rows,
            "step_ms": step_ms, "request_rel_err": request_err,
            "request_bit_equal": request_bit_equal, "request_captured_launches": request_captured,
            "request_ms": request_ms,
            "capture_s": request.captured.capture_seconds})
    finally:
        dist.destroy_process_group()


def nccl_shared_rank(rank, world, directory):
    """Phase 32 (b)'s question: does NCCL take two ranks on one card?"""
    torch.cuda.set_device(0)
    try:
        rank_init(rank, world, directory, "store_nccl_shared", "nccl", 0)
        t = torch.ones(4, device="cuda")
        dist.all_reduce(t)
        torch.cuda.synchronize()
        answer = "accepted"
    except Exception as e:  # noqa: BLE001 - the refusal is the answer
        answer = f"{type(e).__name__}: {' '.join(str(e).split())[:300]}"
    write_rank(directory, "nccl_shared", rank, {"answer": answer})
    os._exit(0)  # a communicator that failed to form is not torn down


def gloo_collectives():
    """Which collectives gloo takes on tensors on the card."""
    k = dist.get_world_size()

    def vec(n=8):
        return torch.ones(n, device="cuda")

    probes = {
        "all_reduce": lambda: dist.all_reduce(vec()),
        "all_gather": lambda: dist.all_gather([vec() for _ in range(k)], vec()),
        "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(vec(8 * k), vec()),
        "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(vec(), vec(8 * k)),
        "broadcast": lambda: dist.broadcast(vec(), 0),
        "all_to_all_single": lambda: dist.all_to_all_single(vec(8 * k), vec(8 * k)),
    }
    out = {}
    for name, probe in probes.items():
        try:
            probe()
            torch.cuda.synchronize()
            out[name] = "ok"
        except Exception as e:  # noqa: BLE001 - each refusal is recorded
            out[name] = f"{type(e).__name__}: {' '.join(str(e).split())[:160]}"
    return out


def gloo_rank(rank, world, directory):
    """Phase 32 (b), one of two ranks sharing the card over gloo, eager:
    the data-parallel request and step (2 rows a rank), the node-sharded
    request (the fused stages' 17 chains split 9/8) and the time-sharded
    request, each against the one-rank render (or step) on the card, with
    the kernels this rank launched and their rows."""
    rank_init(rank, world, directory, "store_gloo", "gloo", 0)
    try:
        rows = log_rows()
        result = {"rank": rank, "collectives": gloo_collectives()}
        for name in GLOO_NEEDED:
            check(result["collectives"][name] == "ok",
                  f"gloo on the card refuses {name}: {result['collectives'][name]}")
        mesh = parallel.make_mesh()
        console = bench_console(CHAINS, seed=0, device="cuda")
        plain = make_render_fn(console.fused_processors, console.plan, jit=False)
        x = torch.randn(BATCH, CHAINS, 2, AUDIO_LEN, device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(1))
        try:
            parallel.shard_render_step(plain, mesh)(parallel.local_shard(
                x, parallel.batch_sharding(mesh)), console.params)
            result["capture_refused"] = None
        except ValueError as e:
            result["capture_refused"] = str(e)
        check(result["capture_refused"] is not None, "a gloo mesh on the card was let capture")

        def sharded(sharding):
            return parallel.make_sharded_render_fn(console.fused_processors, console.plan, sharding,
                                                   jit=False)

        batch, node = parallel.batch_sharding(mesh), parallel.node_sharding(mesh)
        time_4 = parallel.time_sharding(mesh, ndim=4)
        requests = {  # name: (render, sharding, input, even)
            "data": (parallel.shard_render_step(plain, mesh, jit=False), batch, x, True),
            "node": (sharded(node), node, x[0], False),
            "time": (sharded(time_4), time_4, x, True),
        }
        with torch.inference_mode():
            refs = {4: plain(x, console.params)[0], 3: plain(x[0], console.params)[0]}
            for name, (render, sharding, xin, even) in requests.items():
                local = parallel.local_shard(xin, sharding, even=even)
                render(local, console.params)  # warm-up
                torch.cuda.synchronize()
                bal.reset_launch_counts()
                rows.clear()
                start = time.perf_counter()
                ms, (y, _, _) = device_ms(lambda: render(local, console.params), reps=1)
                wall_ms = 1e3 * (time.perf_counter() - start)
                ref = refs[xin.dim()]
                check(bool(torch.allclose(y, ref, **RANK_RENDER_TOL)),
                      f"rank {rank}: the {name}-sharded request is {max_err(y, ref):.3g} from one rank's")
                result[name] = {"local_shape": list(local.shape), "launches": launched(),
                                "rows": copy.deepcopy(rows), "max_abs_err": max_err(y, ref), "ms": ms,
                                "wall_ms": wall_ms}
        del refs

        g = torch.Generator(device="cuda").manual_seed(7)
        x7 = console_input((BATCH, CHAINS, 2, AUDIO_LEN), g, "cuda")
        target = torch.randn(BATCH, 1, 2, AUDIO_LEN, generator=g, device="cuda")
        ref = bench_trainer(CHAINS, seed=0, device="cuda", jit=False)
        dp = bench_trainer(CHAINS, seed=0, device="cuda", jit=False)
        dp.render = parallel.shard_render_step(dp.render, mesh, jit=False)
        _, r_audio = ref.step(x7, target)
        local = parallel.local_shard(x7, batch)
        torch.cuda.synchronize()
        bal.reset_launch_counts()
        rows.clear()
        ms, (_, audio) = device_ms(lambda: dp.step(local, target), reps=1)
        check(bool(torch.allclose(audio, r_audio, rtol=RANK_GRAD_TOL["rtol"])),
              f"rank {rank}: the data-parallel loss {audio.item()} against {r_audio.item()}")
        grad_err = 0.0
        for (k, p), (_, q) in zip(tree_items(dp.params), tree_items(ref.params)):
            if p.requires_grad:
                check(bool(torch.allclose(p.grad, q.grad, **RANK_GRAD_TOL)),
                      f"rank {rank}: the data-parallel gradient of {k} is {max_err(p.grad, q.grad):.3g}"
                      " from one rank's")
                grad_err = max(grad_err, max_err(p.grad, q.grad))
        result["step"] = {"local_shape": list(local.shape), "launches": launched(), "rows": copy.deepcopy(rows),
                          "loss": audio.item(), "loss_one_rank": r_audio.item(),
                          "grad_max_abs_err": grad_err, "ms": ms}
        write_rank(directory, "gloo", rank, result)
    finally:
        dist.destroy_process_group()


def parallel_phase(smi, stats, request_y, step13_ms):
    """Phase 32: ``parallel/`` on the card, each rank a process started
    here (a FileStore in a temporary directory): (a) NCCL over every
    card (one on the usual machine), (b) NCCL's answer to two ranks on
    one card, then two ranks sharing it over gloo, eager."""
    directory = tempfile.mkdtemp(prefix="grafx_parallel_")
    try:
        torch.save(request_y, os.path.join(directory, "request_phase12.pt"))
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        world = torch.cuda.device_count()
        start = time.perf_counter()
        for r in run_ranks(nccl_rank, world, directory, "nccl"):
            rank = r["rank"]
            for key in ("step_captured_launches", "request_captured_launches"):
                for name in KERNELS:
                    stats[name]["per_run"][f"parallel_{key.split('_')[0]}_compiled_nccl_rank{rank}"] = \
                        r[key].get(name, 0)
            say("parallel", part="a", world=world, rank=rank, backend=r["backend"], card=repr(r["card"]),
                local_rows=r["local_rows"], step_max_rel_err=f"{r['step_max_rel_err']:.3g}",
                step_captured_launches=r["step_captured_launches"], step_rows=r["step_rows"],
                **{f"step_{k}_median_ms": f"{statistics.median(v):.3f}" for k, v in r["step_ms"].items()},
                phase13_step_compiled_median_ms=f"{step13_ms:.3f}",
                request_rel_err=f"{r['request_rel_err']:.3g}", request_bit_equal=r["request_bit_equal"],
                request_captured_launches=r["request_captured_launches"], request_rows=r["request_rows"],
                **{f"request_{k}_median_ms": f"{statistics.median(v):.3f}" for k, v in r["request_ms"].items()},
                capture_s=[round(t, 3) for t in r["capture_s"]])
        nccl_s = time.perf_counter() - start

        start = time.perf_counter()
        shared = run_ranks(nccl_shared_rank, 2, directory, "nccl_shared", SHARED_NCCL_TIMEOUT_S,
                           allow_timeout=True)
        answers = ([r["answer"] for r in shared] if shared is not None
                   else [f"no answer in {SHARED_NCCL_TIMEOUT_S} s"])
        say("parallel", part="b", nccl_two_ranks_one_card=answers)
        results = run_ranks(gloo_rank, 2, directory, "gloo")
        say("parallel", part="b", gloo_collectives_on_the_card=results[0]["collectives"],
            capture_refused=repr(results[0]["capture_refused"]))
        for r in results:
            rank = r["rank"]
            for path in ("data", "node", "time", "step"):
                entry = r[path]
                for name in KERNELS:
                    stats[name]["per_run"][f"parallel_{path}_gloo_rank{rank}"] = \
                        entry["launches"].get(name, 0)
                say("parallel", part="b", rank=rank, path=path, local_shape=entry["local_shape"],
                    launches=entry["launches"], rows=entry["rows"], ms=f"{entry['ms']:.3f}",
                    **({"wall_ms": f"{entry['wall_ms']:.3f}", "max_abs_err": f"{entry['max_abs_err']:.3g}"}
                       if path != "step" else
                       {"loss": f"{entry['loss']:.6f}", "loss_one_rank": f"{entry['loss_one_rank']:.6f}",
                        "grad_max_abs_err": f"{entry['grad_max_abs_err']:.3g}"}))
        say("parallel", nccl_s=f"{nccl_s:.1f}", gloo_s=f"{time.perf_counter() - start:.1f}", card=repr(smi))
    finally:
        shutil.rmtree(directory, ignore_errors=True)


# phase 33: every path repeats bit for bit
DETERMINISTIC_CUBLAS = ":4096:8"  # CUBLAS_WORKSPACE_CONFIG, set for the deterministic-algorithms run only
DETERMINISM_CHILD_TIMEOUT_S = 300
FIT_STEPS_33 = 5


def det_request(jit, make_processors=bench_processors, buffer_mode="auto", key_seed=None):
    """Phase 5's first request through a fresh console on
    ``make_processors()`` (on ``PRNGKey(key_seed)`` where given); compiled:
    the replay after a warm-up and a capture."""
    console = bench_console(CHAINS, seed=0, device="cuda", processors=make_processors())
    render = make_render_fn(console.fused_processors, console.plan, jit=jit, buffer_mode=buffer_mode)
    x = torch.randn(BATCH, CHAINS, 2, AUDIO_LEN, generator=torch.Generator(device="cuda").manual_seed(1),
                    device="cuda")
    key = None if key_seed is None else random.PRNGKey(key_seed, device="cuda")
    with torch.inference_mode():
        for _ in range(3 if jit else 1):
            y = render(x, console.params, rng=key)[0]
    return {"output": y}


def optimizer_run(opt, x, target, steps):
    """``steps`` steps of ``opt``: each step's losses, then every
    parameter and gradient."""
    out = {}
    for i in range(steps):
        out[f"step{i + 1}/total"], out[f"step{i + 1}/loss"] = opt.step(x, target)
    for k, p in tree_items(opt.params):
        out[f"param/{k}"] = p.detach().clone()
        if p.grad is not None:
            out[f"grad/{k}"] = p.grad.clone()
    return out


def det_steps(jit, make_processors=bench_processors, buffer_mode=None):
    """Three steps of a fresh ``bench_trainer(17)`` on ``make_processors()``
    from phase 6's input (compiled: warm-up, capture, replay); with
    ``buffer_mode``, its update renders through that buffer."""
    trainer = bench_trainer(CHAINS, seed=0, device="cuda", processors=make_processors(), jit=jit)
    if buffer_mode is not None:
        trainer.render = make_render_fn(trainer.processors, trainer.render_data, jit=False,
                                        buffer_mode=buffer_mode)
    g = torch.Generator(device="cuda").manual_seed(7)
    x = console_input((BATCH, CHAINS, 2, AUDIO_LEN), g, "cuda")
    target = torch.randn(BATCH, 1, 2, AUDIO_LEN, generator=g, device="cuda")
    return optimizer_run(trainer, x, target, steps=3)


def det_stream(jit, make_processors=bench_processors):
    """Phase 9's 32 blocks through a fresh ``StreamRenderer`` of the
    console on ``make_processors()``."""
    console = bench_console(CHAINS, seed=0, device="cuda", processors=make_processors())
    streamer = StreamRenderer(console.fused_processors, console.plan, console.params,
                              block_len=BLOCK_LEN, jit=jit)
    x = console_input((CHAINS, 2, AUDIO_LEN), torch.Generator(device="cuda").manual_seed(9), "cuda")
    state, out = streamer.init_state(), {}
    with torch.inference_mode():
        for i, xb in enumerate(x.split(BLOCK_LEN, dim=-1)):
            out[f"block{i + 1}"], state = streamer(xb, state)
    return out


def det_fit(jit):
    """Five steps of a fresh fit optimizer (``mixing_console(16)``, its
    defaults: MR-STFT loss, Adam) on phase 17's stems, towards a target
    mix of its own."""
    stems = synthetic_stems(FIT_TRACKS, AUDIO_LEN, torch.Generator().manual_seed(0)).cuda()
    target = synthetic_stems(1, AUDIO_LEN, torch.Generator().manual_seed(3)).cuda()
    return optimizer_run(fit_optimizer("cuda", jit=jit), stems, target, steps=FIT_STEPS_33)


DETERMINISM_PATHS = {
    "request": det_request,
    "step": det_steps,
    "step_factorized": functools.partial(det_steps, make_processors=factorized_processors),
    "stream_block": det_stream,
    "fit_step": det_fit,
    "request_fsm": functools.partial(det_request, make_processors=fsm_processors),
    "step_fsm": functools.partial(det_steps, make_processors=fsm_processors),
    "request_noise": functools.partial(det_request, make_processors=noise_processors, key_seed=11),
    "request_fdn": functools.partial(det_request, make_processors=fdn_processors, key_seed=12),
    "request_array": functools.partial(det_request, buffer_mode="array"),
    "step_array": functools.partial(det_steps, buffer_mode="array"),
    # phase 35's gain-smoothed console (defined below, looked up when run)
    "request_gs": lambda jit: det_request(jit, make_processors=gain_smoothed_processors),
    "step_gs": lambda jit: det_steps(jit, make_processors=gain_smoothed_processors),
    "stream_block_gs": lambda jit: det_stream(jit, make_processors=gain_smoothed_processors),
}


def determinism_child(directory):
    """Phase 33's second half, in a process whose environment sets
    ``CUBLAS_WORKSPACE_CONFIG``: each path once, eagerly, under
    ``torch.use_deterministic_algorithms(True)``.  Writes each path's
    outputs (``<path>.pt``) and ``report.json``: the errors the paths
    raised and every warning that names determinism."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.use_deterministic_algorithms(True)
    errors = {}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for name, run in DETERMINISM_PATHS.items():
            try:
                out = run(jit=False)
            except RuntimeError as e:
                errors[name] = str(e)[:2000]
                continue
            torch.save({k: v.cpu() for k, v in out.items()}, os.path.join(directory, f"{name}.pt"))
            del out
    notes = sorted({str(w.message)[:500] for w in caught if "determinis" in str(w.message)})
    with open(os.path.join(directory, "report.json"), "w") as f:
        json.dump({"errors": errors, "warnings": notes}, f)


def determinism_phase(smi):
    """Phase 33 (module docstring): each path twice eagerly and twice
    compiled, every pair ``torch.equal``; then each once under
    ``torch.use_deterministic_algorithms(True)`` in a child process,
    within COMPILED_REL of the default eager run."""
    eager_runs = {}
    for name, run in DETERMINISM_PATHS.items():
        start = time.perf_counter()
        fields = {}
        for form in ("eager", "compiled"):
            a, b = run(jit=form == "compiled"), run(jit=form == "compiled")
            check(a.keys() == b.keys(), f"determinism {name}: two {form} runs returned other tensors")
            differ = {k: f"{rel_err(a[k], b[k]):.3g}" for k in a if not torch.equal(a[k], b[k])}
            fields[f"{form}_bit_equal"] = not differ
            if differ:
                say("determinism", path=name, form=form, tensors=len(a), tensors_differing=len(differ),
                    differ=dict(list(differ.items())[:8]))
            check(not differ, f"determinism {name}: two {form} runs differ in {len(differ)} of {len(a)}"
                              f" tensors")
            if form == "eager":
                eager_runs[name] = {k: v.cpu() for k, v in a.items()}
            else:
                ref = eager_runs[name]
                fields["compiled_vs_eager_bit_equal"] = all(torch.equal(v.cpu(), ref[k]) for k, v in a.items())
                fields["compiled_vs_eager_rel"] = f"{max(rel_err(v.cpu(), ref[k]) for k, v in a.items()):.3g}"
            del a, b
            torch.cuda.empty_cache()
        say("determinism", path=name, tensors=len(eager_runs[name]), **fields,
            seconds=f"{time.perf_counter() - start:.1f}", card=repr(smi))

    start = time.perf_counter()
    with tempfile.TemporaryDirectory() as directory:
        env = {**os.environ, "CUBLAS_WORKSPACE_CONFIG": DETERMINISTIC_CUBLAS}
        child = subprocess.run(
            [sys.executable, "-c", f"import chip_smoke; chip_smoke.determinism_child({directory!r})"],
            cwd=os.path.dirname(os.path.abspath(__file__)), env=env, capture_output=True, text=True,
            timeout=DETERMINISM_CHILD_TIMEOUT_S)
        if child.returncode != 0:
            print(child.stdout[-4000:], child.stderr[-8000:], sep="\n", file=sys.stderr, flush=True)
        check(child.returncode == 0, f"determinism: the deterministic-algorithms run exited {child.returncode}")
        with open(os.path.join(directory, "report.json")) as f:
            report = json.load(f)
        say("determinism", run="use_deterministic_algorithms", cublas_workspace_config=DETERMINISTIC_CUBLAS,
            errors=report["errors"], warnings=report["warnings"])
        check(not report["errors"], f"determinism: use_deterministic_algorithms(True) refused"
                                    f" {sorted(report['errors'])}")
        for name, ref in eager_runs.items():
            got = torch.load(os.path.join(directory, f"{name}.pt"), weights_only=True)
            check(got.keys() == ref.keys(), f"determinism {name}: the deterministic run returned other tensors")
            worst = max(rel_err(got[k], v) for k, v in ref.items())
            same = all(torch.equal(got[k], v) for k, v in ref.items())
            say("determinism", run="use_deterministic_algorithms", path=name, rel=f"{worst:.3g}", bit_equal=same)
            check(worst <= COMPILED_REL, f"determinism {name}: under use_deterministic_algorithms at {worst:.3g}"
                                         f" of max|default| > {COMPILED_REL}")
    say("determinism", run="use_deterministic_algorithms", seconds=f"{time.perf_counter() - start:.1f}")


# phase 34: the README's examples (examples_torch/) on the card
STREAM_DB = -60.0  # a streamed console against its one-shot render (phase 9's bound)


def _stream_launches(out, k_blocks=(4, 16)):
    """streaming_console's launches: #2 once a compressor and once a gate
    stage for the one-shot render (the gates' exact one-pole smoother
    runs the same kernel), and #7 once a compressor stage a block, in the
    eager and the capturing call of each step (one block, then k blocks a
    call; the streamed gates run no kernel); replays launch nothing."""
    n, stages = out["blocks"], out["compressor_stages"]
    calls = min(n, 2) + sum(k * min(n // k, 2) for k in k_blocks if n % k == 0)
    return {"ballistics_gain_core": stages + out["gate_stages"], "ballistics_core": stages * calls}


def _fit_launches(out):
    """A no-grad target render (#2 once a compressor stage), then the
    training step's eager and capturing calls (#5 and #6 once a stage
    each)."""
    stages = out["compressor_stages"]
    return {"ballistics_gain_core": stages, "ballistics_gain_fwd": 2 * stages,
            "ballistics_gain_bwd": 2 * stages}


# name: its main's output -> {kernel: launches in one main}
EXAMPLE_LAUNCHES = {
    "fused_mastering": lambda out: {},
    "streaming_console": _stream_launches,
    "serve_stream_wav": lambda out: {"ballistics_core": min(out["blocks"], 2)},
    "match_mix": _fit_launches,
    "neural_mixing": _fit_launches,
    "multihost_dp": lambda out: {},  # the parent launches nothing; each rank's own below
}


def _launch_fields(counts):
    return {name: count for name, count in counts.items() if count}


def _example_fields(name, out):
    """The numbers an example printed, for its ``[examples]`` line."""
    if name == "fused_mastering":
        return dict(rel=f"{out['rel']:.3g}", unfused_step_ms=f"{out['unfused_ms']:.3f}",
                    fused_step_ms=f"{out['fused_ms']:.3f}", speedup=f"{out['speedup']:.2f}",
                    nodes=f"{out['nodes']}->{out['fused_nodes']}")
    if name == "streaming_console":
        return dict(nodes=out["nodes"], vs_one_shot_db=f"{out['err_db']:.1f}",
                    block_ms=f"{out['block_ms']:.3f}", rtf=f"{out['rtf']:.1f}",
                    **{f"step_many{k}_{f}": (f"{v[f]:.3f}" if f == "block_ms" else f"{v[f]:.1f}")
                       for k, v in out["step_many"].items() for f in ("block_ms", "rtf")},
                    **{f"step_many{k}_db": f"{20 * np.log10(v['err_rel'] + 1e-12):.1f}"
                       for k, v in out["step_many"].items()})
    if name == "serve_stream_wav":
        return dict(artifact_mb=f"{out['artifact_mb']:.2f}", blocks=out["blocks"],
                    block_ms=f"{out['block_ms']:.3f}", rtf_incl_capture=f"{out['rtf']:.1f}")
    if name in ("match_mix", "neural_mixing"):
        return dict(steps=out["steps"], loss=f"{out['loss_first']:.4f}->{out['loss_last']:.4f}",
                    step_ms=f"{out['step_ms']:.3f}", compressor_stages=out["compressor_stages"])
    return dict(rel=f"{out['rel']:.3g}", max_param_diff=f"{out['p_err']:.3g}",
                rank_ms=[round(r["ms"], 3) for r in out["ranks"]])


def _served_against_live(module, out):
    """The artifact's output of serve_stream_wav against a live
    ``StreamRenderer`` on the card: ``(relative error, bit-equal)``."""
    _, audio = module.load_input(None)
    procs, plan, params = module.build(torch.device("cuda"))
    streamer = StreamRenderer(procs, plan, params, block_len=out["block"])
    state, live = streamer.init_state(), []
    x = torch.from_numpy(np.ascontiguousarray(audio[:, : out["blocks"] * out["block"]])).cuda()
    with torch.no_grad():
        for xb in x.split(out["block"], dim=-1):
            y, state = streamer(xb[None], state)
            live.append(y[0])
    live = torch.cat(live, dim=-1).cpu()
    got = torch.from_numpy(out["output"])
    return rel_err(got, live), torch.equal(got, live)


# the wrappers' launchers whose inputs a path's kernel checks take:
# launcher -> the wrappers that reach it (a forward and its adjoint share
# the forward's inputs)
LAUNCHERS = {
    "_gain_fwd_cuda": ("ballistics_gain_core", "ballistics_gain_fwd", "ballistics_gain_bwd"),
    "_walk_fwd_cuda": ("ballistics_core", "ballistics_fwd", "ballistics_bwd"),
    "_pair_fwd_cuda": ("ballistics_gain_pair_core", "ballistics_gain_pair_fwd", "ballistics_gain_pair_bwd"),
    "_chain_fwd_cuda": CHAIN_KERNELS,
}


class KernelInputs:
    """While entered, keeps a copy of the inputs of the first launch of
    each forward kernel at each ``(rows, length)`` and kind, as the path
    gives them (outside CUDA-graph captures, whose replays repeat the
    shapes of the eager call before them): ``self.cases`` maps
    ``(launcher, shape, kind)`` to ``(u, consts, kinds, inits)``; for the
    dynamics chain ``kind`` is its spec and ``inits`` the walks' initial
    states ``zi``."""

    def __init__(self):
        self.cases, self._saved = {}, {}
        self.plain_ms = {}  # the chain's plain versions' ms by case (check_path_inputs)

    def _keep(self, launcher, u, consts, kinds, inits):
        key = (launcher, tuple(u.shape), kinds)
        if key not in self.cases and not torch.cuda.is_current_stream_capturing():
            self.cases[key] = (u.detach().clone(), [c.detach().clone() for c in consts], kinds, inits)

    def __enter__(self):
        self._saved = {name: getattr(bal, name) for name in LAUNCHERS}
        gain, walk, pair, chain = (self._saved[name] for name in LAUNCHERS)

        def gain_fwd(name, u, consts, kind, res, samples=None):
            self._keep("_gain_fwd_cuda", u, consts, kind, None)
            return gain(name, u, consts, kind, res, samples)

        def walk_fwd(name, u, consts, res, samples=None):
            self._keep("_walk_fwd_cuda", u, consts, None, None)
            return walk(name, u, consts, res, samples)

        def pair_fwd(name, u, consts, kinds, inits, res, samples=None):
            self._keep("_pair_fwd_cuda", u, consts, tuple(kinds), tuple(inits))
            return pair(name, u, consts, kinds, inits, res, samples)

        def chain_fwd(name, u, consts, zi, spec, res, samples=None):
            key = ("_chain_fwd_cuda", tuple(u.shape), tuple(spec))
            if key not in self.cases and not torch.cuda.is_current_stream_capturing():
                self.cases[key] = (u.detach().clone(), consts.detach().clone(), tuple(spec),
                                   zi.detach().clone())
            return chain(name, u, consts, zi, spec, res, samples)

        bal._gain_fwd_cuda, bal._walk_fwd_cuda, bal._pair_fwd_cuda = gain_fwd, walk_fwd, pair_fwd
        bal._chain_fwd_cuda = chain_fwd
        return self

    def __exit__(self, *exc):
        for name, fn in self._saved.items():
            setattr(bal, name, fn)


def check_path_inputs(label, inputs, launches, stats):
    """Hold every kernel that a path launched against its plain version on
    the inputs the path gave it (``inputs``, a :class:`KernelInputs`): the
    primal, the forward and the adjoint (on a drawn cotangent) of each
    gain and pair case, #7 of each walk case (and #8/#9 where the path
    trained through the walk).  Fails where a launched kernel has no
    case.  Returns the checked ``"rows x length"`` shapes by launcher."""
    gen = torch.Generator(device="cuda").manual_seed(34)
    checked = {}
    for (launcher, shape, kinds), (u, consts, _, inits) in sorted(inputs.cases.items(), key=str):
        case_label = f"{label} {shape} {kinds or ''}".strip()
        if launcher == "_chain_fwd_cuda":
            inputs.plain_ms[(launcher, shape, kinds)] = check_chain(case_label, u, consts, inits, kinds, stats,
                                                                    gen, timed=True)
        elif launcher == "_walk_fwd_cuda":
            check_walk(case_label, u, *consts, stats)
            if launches.get("ballistics_fwd") or launches.get("ballistics_bwd"):
                case = (u, *consts, torch.randn(shape, generator=gen, device="cuda"),
                        0.1 + 0.89 * torch.rand(shape, generator=gen, device="cuda"))
                check_smoother(case_label, case, stats)
        else:
            pair = launcher == "_pair_fwd_cuda"
            gg = torch.randn(shape, generator=gen, device="cuda")
            check_case(case_label, KernelCase(pair, u, consts, kinds, inits, gg), stats)
        checked.setdefault(launcher, []).append(f"{shape[0]}x{shape[1]}" + (f" {kinds}" if kinds else ""))
    for launcher, wrappers in LAUNCHERS.items():
        ran = [w for w in wrappers if launches.get(w)]
        check(not ran or launcher in checked, f"{label}: {ran} launched on no input that was checked")
    return checked


def predictor_model(module, tracks, stems):
    """:func:`first_step`'s model of neural_mixing's predictor (seed 1) on
    its console, conditioned on ``stems``' features: the render of the
    predicted parameters, and the predictor's weights."""
    def model(device):
        G, processors, plan = module.console(tracks, device)
        predictor, per_type = module.conditioning(G, processors, stems.to(device),
                                                  torch.Generator().manual_seed(1))
        render = make_render_fn(processors, plan, jit=False)
        return (lambda x: (render(x, predictor(per_type))[0], 0.0)), list(predictor.named_parameters())

    return model


def example_card_vs_cpu(name, module, out):
    """match_mix's and neural_mixing's target render and first training
    step at the example's sizes, card against the port's CPU path: the
    target within -60 dB, the first step by :func:`step_card_vs_cpu` on
    the CPU's stems and target.  Returns the fields of the line."""
    problems = {device: module.problem(out["tracks"], out["length"], torch.device(device))
                for device in ("cuda", "cpu")}
    target = {device: p[-1].cpu() for device, p in problems.items()}
    target_db = db(target["cuda"] - target["cpu"], target["cpu"])
    check(bool(torch.isfinite(target["cuda"]).all()), f"examples {name}: non-finite target on the card")
    check(target_db <= -60.0, f"examples {name}: target card vs CPU at {target_db:.1f} dB > -60 dB")
    stems = problems["cpu"][-2]
    if name == "match_mix":
        model = optimizer_model(lambda device: GraphParameterOptimizer(
            *module.console(out["tracks"]), generator=torch.Generator().manual_seed(1), device=device,
            jit=False))
    else:
        model = predictor_model(module, out["tracks"], stems)
    fields, _ = step_card_vs_cpu(f"{name}_card_vs_cpu", model, stems, target["cpu"])
    return {"target_card_vs_cpu_db": f"{target_db:.1f}", **{f"first_step_{k}": v for k, v in fields.items()}}


def multihost_inputs(module, out):
    """multihost_dp's kernel inputs, made in this process (its ranks are
    other processes): one forward and backward of the example's console
    at each rank's local batch and at rank 0's whole batch."""
    inputs = KernelInputs()
    shapes = {tuple(r["local_shape"]) for r in out["ranks"]}
    shapes.add((module.GLOBAL_BATCH, *out["ranks"][0]["local_shape"][1:]))
    with inputs:
        for shape in sorted(shapes):
            procs, plan, params = module.console(torch.device("cuda"))
            for leaf in tree_leaves(params):
                leaf.requires_grad_(True)
            x = torch.randn(shape, generator=torch.Generator().manual_seed(1)).cuda()
            torch.mean(make_render_fn(procs, plan, jit=False)(x, params)[0] ** 2).backward()
    return inputs


def examples_phase(smi, stats):
    """Phase 34 (module docstring): each example's ``main`` on the card,
    its launches held to ``EXAMPLE_LAUNCHES``, its kernels held against
    their plain versions on the inputs it gave them, and the training
    examples' first step against the CPU's."""
    directory = tempfile.mkdtemp(prefix="grafx_examples_")
    try:
        for name, expected_of in EXAMPLE_LAUNCHES.items():
            module = importlib.import_module(f"examples_torch.{name}")
            argv = []
            if name == "serve_stream_wav":  # the synthetic program, written to a temp dir
                argv = ["", os.path.join(directory, "served.wav"), "4096"]
            torch.cuda.synchronize()
            bal.reset_launch_counts()
            start = time.perf_counter()
            with KernelInputs() as inputs:
                out = module.main(argv + ["--device", "cuda"])
            torch.cuda.synchronize()
            seconds = time.perf_counter() - start
            launches = path_launches = bal.launch_counts()
            expected = expected_of(out)
            for kernel, count in launches.items():
                check(count == expected.get(kernel, 0),
                      f"examples {name}: {kernel} launched {count} times, not {expected.get(kernel, 0)}")
                stats[kernel]["per_run"][f"example_{name}"] = count
            fields = _example_fields(name, out)
            if name == "streaming_console":
                check(out["err_db"] <= STREAM_DB,
                      f"examples {name}: streamed vs one-shot at {out['err_db']:.1f} dB > {STREAM_DB} dB")
                for k, v in out["step_many"].items():
                    check(v["err_rel"] <= 10 ** (STREAM_DB / 20),
                          f"examples {name}: step_many({k}) vs one-shot at {v['err_rel']:.3g}")
            if name == "serve_stream_wav":
                check(bool(np.isfinite(out["output"]).all()), f"examples {name}: non-finite output")
                err, same = _served_against_live(module, out)
                check(err <= COMPILED_REL, f"examples {name}: served vs live stream at {err:.3g}"
                                           f" of max|live| > {COMPILED_REL}")
                fields.update(vs_live_rel=f"{err:.3g}", vs_live_bit_equal=same)
            if name in ("match_mix", "neural_mixing"):
                check(np.isfinite(out["loss_last"]) and out["loss_last"] < out["loss_first"],
                      f"examples {name}: the loss did not fall")
            if name == "multihost_dp":
                for r in out["ranks"]:
                    # each rank's steps, and rank 0's single-process check as many
                    steps = out["steps"] * r["compressor_stages"] * (2 if r["rank"] == 0 else 1)
                    got = r["launches_with_oracle"] if r["rank"] == 0 else r["launches"]
                    want = {"ballistics_gain_fwd": steps, "ballistics_gain_bwd": steps}
                    for kernel, count in got.items():
                        check(count == want.get(kernel, 0),
                              f"examples {name}: rank {r['rank']} launched {kernel} {count} times,"
                              f" not {want.get(kernel, 0)}")
                        stats[kernel]["per_run"][f"example_{name}_rank{r['rank']}"] = count
                    fields[f"rank{r['rank']}_launches"] = _launch_fields(got)
                inputs = multihost_inputs(module, out)
                path_launches = {k: sum(r["launches_with_oracle" if r["rank"] == 0 else "launches"][k]
                                        for r in out["ranks"]) for k in launches}
            if name in ("match_mix", "neural_mixing"):
                fields.update(example_card_vs_cpu(name, module, out))
            with torch.no_grad():
                fields["kernel_inputs_checked"] = check_path_inputs(f"examples {name}", inputs,
                                                                    path_launches, stats)
            say("examples", example=name, **fields, launches=_launch_fields(launches),
                seconds=f"{seconds:.1f}", card=repr(smi))
    finally:
        shutil.rmtree(directory, ignore_errors=True)


# phase 35: the library classes no card path had run, the gain-smoothed
# console (#7-#9 at full rate) and the README's single-source builders
LIBRARY_WALK_LEN = 2**15  # the CPU comparison's length where the CPU path runs the plain walk
# leaves drawn wider than the rest (0.5): PoleZeroFilter's poles reach a
# radius tanh(|p|) above 0.99 on about a fifth of the rows and the SVF's
# 2R falls to ~0.04, so the exact backend runs long, lightly damped
# recursions
LIBRARY_STD = {"poles": 1.5, "twoR": 2.0}
LIBRARY_FILTERS = (AllPassFilter, BandPassFilter, BandRejectFilter, BiquadFilter, HighPassFilter,
                   PoleZeroFilter, StateVariableFilter)
# the gain-smoothed console's launches a run: the dynamics chain over the
# composites' four walks (gate energy and gain, compressor energy and
# gain; 68 rows), then over the bus compressors' two (energy, gain; 8
# rows); a block: 17 and 2
GS_REQUEST = {"ballistics_chain_core": 2}
GS_STEP = {"ballistics_chain_fwd": 2, "ballistics_chain_bwd": 2}
GS_BLOCK = {"ballistics_chain_core": 2}
BUILDER_STEPS = 10


# why a case's float32 result may sit further from the CPU's than the
# fixed bounds, so that it is held to the CPU's own float32 spread instead
TRUNCATED = "the truncated one-pole FIR: an FFT convolution whose round-off scales with the loudest sample"
NEAR_CIRCLE = ("poles within 1e-4 of the unit circle (LIBRARY_STD): the response divides by |A| down to"
               " ~1e-4, and a decay of ~10^4 samples carries the round-off")


class LibraryCase:
    """One class of phase 35 (a): ``make()`` builds it; ``walks``: it runs
    the ballistics walk (#7, under autograd #8/#9), whose plain version the
    CPU path runs; ``streams``: True (it streams), False (its
    ``stream_init`` refuses, as in grafx_tpu) or None (no stream
    contract); ``spread``: why float32 may determine its result less
    well than the fixed bounds ask (TRUNCATED, NEAR_CIRCLE), or None."""

    def __init__(self, name, make, walks=False, streams=None, spread=None):
        self.name, self.make, self.walks = name, make, walks
        self.streams, self.spread = streams, spread


def library_slice_cases():
    """Phase 35 (a)'s cases, each class at its defaults unless named."""
    cases = [LibraryCase(f"{cls.__name__}({kw})", functools.partial(cls, **({"backend": "exact"} if kw else {})),
                         streams=True, spread=NEAR_CIRCLE if cls in (PoleZeroFilter, StateVariableFilter) else None)
             for cls in LIBRARY_FILTERS for kw in ("", "backend='exact'")]
    cases += [LibraryCase(f"{cls.__name__}()", cls, streams=False)
              for cls in (ZeroPhaseFIREqualizer, NewZeroPhaseFIREqualizer)]
    gated = lambda knee: functools.partial(Compressor, energy_smoother="ballistics", knee=knee)  # noqa: E731
    cases += [
        LibraryCase("ApproxCompressor()", ApproxCompressor, spread=TRUNCATED),
        LibraryCase("ApproxNoiseGate()", ApproxNoiseGate, spread=TRUNCATED),
        LibraryCase("IIREnvelopeFollower()", IIREnvelopeFollower, spread=TRUNCATED),
        LibraryCase("IIREnvelopeFollower(detect_with='rms_channel')",
                    functools.partial(IIREnvelopeFollower, detect_with="rms_channel"), spread=TRUNCATED),
        LibraryCase("BallisticsEnvelopeFollower()", BallisticsEnvelopeFollower, walks=True),
        LibraryCase("BallisticsEnvelopeFollower(detect_with='amplitude')",
                    functools.partial(BallisticsEnvelopeFollower, detect_with="amplitude"), walks=True),
        LibraryCase("Compressor()", Compressor, streams=False, spread=TRUNCATED),
        LibraryCase("NoiseGate()", NoiseGate, streams=False, spread=TRUNCATED),
        LibraryCase("Compressor(energy_smoother='ballistics', knee='hard')", gated("hard"), walks=True,
                    streams=True),
        LibraryCase("Compressor(energy_smoother='ballistics', knee='exponential')", gated("exponential"),
                    walks=True, streams=True),
        LibraryCase("ParallelMix({'allpass': AllPassFilter(), 'compressor': Compressor("
                    "energy_smoother='ballistics', knee='hard')})",
                    lambda: ParallelMix({"allpass": AllPassFilter(), "compressor": gated("hard")()}),
                    walks=True, streams=True),
        LibraryCase("GainStagingRegularization(PoleZeroFilter(backend='exact'))",
                    lambda: GainStagingRegularization(PoleZeroFilter(backend="exact")), streams=True,
                    spread=NEAR_CIRCLE),
    ]
    return cases


def numpy_parameters(sizes, rows, rng, std=0.5):
    """A parameter tree of ``sizes`` (``parameter_size()``, nested for a
    container) drawn with numpy: ``std`` N(0, 1), LIBRARY_STD's leaves
    wider."""
    out = {}
    for k, v in sizes.items():
        if isinstance(v, dict):
            out[k] = numpy_parameters(v, rows, rng, std)
        else:
            shape = (rows,) + ((v,) if isinstance(v, int) else tuple(v))
            out[k] = (LIBRARY_STD.get(k, std) * rng.standard_normal(shape)).astype(np.float32)
    return out


def library_input(rng, length):
    """``(68, 2, length)`` noise with -40 dB passages (half of 32 blocks), so
    that gates, knees and followers act."""
    x = rng.standard_normal((LIBRARY_ROWS, 2, length), dtype=np.float32)
    loud = rng.random((LIBRARY_ROWS, 1, 32)) < 0.5
    return x * np.where(loud, 1.0, 0.01).astype(np.float32).repeat(length // 32, axis=-1)


def processor_output(proc, x, params):
    """``(output, auxiliary loss or None)`` of one call: a container returns
    its intermediates beside its output, and their sum is the auxiliary
    loss, as ``GraphParameterOptimizer`` adds it."""
    out = proc(x, **params)
    if not isinstance(out, tuple):
        return out, None
    out, intermediates = out
    leaves = tree_leaves(intermediates or {})
    return out, sum(v.sum() for v in leaves) if leaves else None


def on(device, tree, dtype=torch.float32, grad=False):
    return tree_map(lambda v: torch.tensor(v, device=device, dtype=dtype, requires_grad=grad), tree)


def library_forward(proc, x, params, device, dtype=torch.float32):
    with torch.inference_mode():
        return processor_output(proc, on(device, x, dtype), on(device, params, dtype))[0].cpu()


def library_gradient(proc, x, params, w, device, dtype=torch.float32):
    """The gradient of ``sum(output * w)`` plus the auxiliary loss in every
    parameter leaf and in the input: ``(loss, {leaf: gradient on the
    CPU})``, the input's under ``"input"``."""
    xt, leaves = on(device, x, dtype, grad=True), on(device, params, dtype, grad=True)
    out, aux = processor_output(proc, xt, leaves)
    loss = (out * on(device, w, dtype)).sum()
    if aux is not None:
        loss = loss + aux
    loss.backward()
    grads = {k: torch.zeros(v.shape, dtype=dtype) if v.grad is None else v.grad.cpu()
             for k, v in tree_items(leaves)}
    return loss.detach().cpu(), {"input": xt.grad.cpu(), **grads}


def library_compare(case, card, cpu, float64):
    """Hold the card's forward, loss and gradients (``(forward, loss,
    grads)``) against the CPU's: the forward <= -60 dB here, the loss and
    gradients by :func:`compare_card_cpu`.  Where the case has a
    ``spread`` reason, ``float64()`` gives the CPU's ``(forward, loss,
    grads)`` in double, and a result that misses its bound is held to the
    CPU's own float32 spread instead (:func:`spread_held`).  Returns the
    fields of the case's line."""
    label = f"library35 {case.name}"
    float64 = functools.cache(float64)
    forward_db = db(card[0].double() - cpu[0].double(), cpu[0].double())
    check(bool(torch.isfinite(card[0]).all()), f"{label}: non-finite forward on the card")
    fields = {"forward_db": f"{forward_db:.1f}"}
    if forward_db > -60.0:
        check(case.spread is not None, f"{label}: forward card vs CPU at {forward_db:.1f} dB > -60 dB")
        fields["forward_held_to_the_cpu_float32_spread"] = spread_held(label, "forward", card[0], cpu[0],
                                                                       float64()[0])
    fields.update(compare_card_cpu(label, {"cuda": card[1], "cpu": cpu[1]}, {"cuda": card[2], "cpu": cpu[2]},
                                   float64=(lambda: float64()[1:]) if case.spread else None, whole=True))
    if {"forward_held_to_the_cpu_float32_spread", "held_to_the_cpu_float32_spread"} & fields.keys():
        fields["why"] = case.spread
    return fields


def library_stream(case, proc, x, params, one_shot):
    """Stream the card's processor in blocks of 4096 over the whole 2^17
    against its one-shot render (max abs over peak <= -60 dB, phase 9's
    bound), or check that it refuses as grafx_tpu's does; returns the
    fields of the case's line."""
    if case.streams is None:
        check(not hasattr(proc, "stream_init"), f"library35 {case.name}: an unexpected stream contract")
        return {"stream": "no stream contract (as in grafx_tpu)"}
    if not case.streams:
        try:
            proc.stream_init(2, BLOCK_LEN, **params)
        except NotImplementedError as e:
            return {"stream": f"refused (as in grafx_tpu): {str(e)[:60]}"}
        raise SmokeFailure(f"library35 {case.name}: stream_init did not refuse")
    state, cache = proc.stream_init(2, BLOCK_LEN, **params)
    torch.cuda.synchronize()
    bal.reset_launch_counts()
    outs = []
    with torch.inference_mode():
        for xb in x.split(BLOCK_LEN, dim=-1):
            y, state = proc.stream_step(xb, state, cache)
            outs.append(y)
    torch.cuda.synchronize()
    launches = launched()
    streamed = torch.cat(outs, dim=-1).cpu()
    check(bool(torch.isfinite(streamed).all()), f"library35 {case.name}: non-finite stream")
    peak_db = 20.0 * torch.log10((streamed - one_shot).abs().max() / one_shot.abs().max()).item()
    check(peak_db <= STREAM_DB, f"library35 {case.name}: stream vs one-shot at {peak_db:.1f} dB > {STREAM_DB} dB")
    return {"stream_blocks": len(outs), "stream_vs_one_shot_db": f"{peak_db:.1f}",
            "stream_launches_a_block": {k: v / len(outs) for k, v in launches.items()}}


def library_slice_phase(smi, stats):
    """Phase 35 (a): each case at 68 x 2 x 2^17 on the card, forward (timed,
    its launches) and the gradient of every parameter and of the input (its
    launches), held against the port's CPU path on the same numpy
    parameters and input (``library_compare``): at full width (the card's
    forward and gradient above are the ones compared), or where the CPU
    path runs the plain walk (~5 s a call at 2^17), every row at
    LIBRARY_WALK_LEN on both; then streamed on the card
    (``library_stream``)."""
    rng = np.random.default_rng(35)
    for case in library_slice_cases():
        start = time.perf_counter()
        card_proc, cpu_proc = case.make().to("cuda"), case.make()
        params = numpy_parameters(cpu_proc.parameter_size(), LIBRARY_ROWS, rng)
        x = library_input(rng, LIBRARY_LEN)
        xc, pc = on("cuda", x), on("cuda", params)
        torch.cuda.synchronize()
        bal.reset_launch_counts()
        with torch.inference_mode():
            y = processor_output(card_proc, xc, pc)[0]
            torch.cuda.synchronize()
            forward_launches = launched()
            ms = device_ms(lambda: processor_output(card_proc, xc, pc)[0], reps=3)[0]
        w = rng.standard_normal(tuple(y.shape), dtype=np.float32)
        bal.reset_launch_counts()
        full_gradient = library_gradient(card_proc, x, params, w, "cuda")
        torch.cuda.synchronize()
        grad_launches = launched()
        for kind, counts in (("forward", forward_launches), ("gradient", grad_launches)):
            for name, count in counts.items():
                stats[name]["per_run"][f"library35 {case.name} {kind}"] = count
        n = LIBRARY_WALK_LEN if case.walks else LIBRARY_LEN
        xs, ws = x[..., :n], w[..., :n]
        one_shot = y.cpu()
        card = ((one_shot, *full_gradient) if n == LIBRARY_LEN else
                (library_forward(card_proc, xs, params, "cuda"), *library_gradient(card_proc, xs, params, ws, "cuda")))
        cpu = (library_forward(cpu_proc, xs, params, "cpu"), *library_gradient(cpu_proc, xs, params, ws, "cpu"))

        def float64():
            proc64 = case.make().double()
            return (library_forward(proc64, xs, params, "cpu", torch.float64),
                    *library_gradient(proc64, xs, params, ws, "cpu", torch.float64))

        fields = library_compare(case, card, cpu, float64)
        fields.update(library_stream(case, card_proc, xc, pc, one_shot))
        say("library35", cls=case.name, shape=(LIBRARY_ROWS, 2, LIBRARY_LEN),
            compared_at=f"{LIBRARY_ROWS} x 2 x {n}" + (" (the CPU runs the plain walk)" if case.walks else ""),
            **fields, card_ms=f"{ms:.3f}", forward_launches=forward_launches, gradient_launches=grad_launches,
            seconds=f"{time.perf_counter() - start:.1f}", card=repr(smi))
        del card_proc, xc, pc, y, card, cpu, full_gradient
        torch.cuda.empty_cache()


# phase 36 (and 35 (b)'s kernel checks): the dynamics chain
CHAIN_SWEEP_SAMPLES = (128, 256, 512, 1024)  # the chain's stage lengths timed at the console's shapes
CHAIN_PLAIN_LEN = 2**15  # the plain chain's loop takes ~7 s a forward at 2^15 (four walks): checks cut rows there
CHAIN_SPECS = (  # the console's composite and bus runs, then the other forms the kernel takes
    (("noisegate", "log"), ("compressor", "linear")),
    (("compressor", "linear"),),
    (("noisegate", "linear"),),
    (("noisegate", None), ("compressor", "log")),
    (("compressor", "log"), ("noisegate", None)),
)


def chain_operands(gen, n, spec):
    """``(consts, zi)`` of a chain on the card: per member the ranges of
    :func:`gain_consts` (a leading gate of two smooths its energy as the
    exact one-pole, from 0), its gain walk's at/rt from the compressor's
    ranges; member 0 absent on every third row and member 1 on every
    fifth; initial states 1 (the one-pole 0), as a request's."""
    rows, zi = [], []
    for i, (kind, smooth) in enumerate(spec):
        onepole = i == 0 and len(spec) == 2 and kind == "noisegate"
        rows += gain_consts(gen, n, kind, onepole=onepole)
        at_g, rt_g = gain_consts(gen, n, "compressor")[:2] if smooth else (torch.zeros(n, device="cuda"),) * 2
        keep = (torch.arange(n, device="cuda") % (3 if i == 0 else 5) != 1).float()
        rows += [at_g, rt_g, keep]
        zi += [0.0 if onepole else 1.0] + ([1.0] if smooth else [])
    return torch.stack(rows), torch.stack([torch.full((n,), v, device="cuda") for v in zi])


def check_chain(label, u, consts, zi, spec, stats, gen, samples=(None,), timed=False):
    """The chain's three entry points against their plain versions on the
    first CHAIN_PLAIN_LEN samples of ``u``'s rows (all where shorter), at
    each stage length of ``samples`` (None: the wrapper's pick), every
    stage length's outputs equal bit for bit: (a) the primal's gain and
    (b) the forward's gain and residuals within MAX_ABS (and the final
    states where the rows are not cut), (a)'s gain and states equal to
    (b)'s; (c) the adjoint on (b)'s residuals and a drawn cotangent, at
    the chunk its wrapper picks for ``u``'s whole rows (the main path's:
    288 at 68 x 2^17, with the carry pass), within DU_REL (du) and
    GRAD_REL (each constant's and initial state's row); an
    absent member's gain rows exactly 1 (a lone member) and its gradient
    rows exactly 0.  Each plain version runs once; with ``timed``, timed,
    and the primal's own plain version is the primal's reference (else
    the plain forward's gain).  Returns the plain versions' ms
    (``timed``)."""
    n, length = u.shape
    cut = min(length, CHAIN_PLAIN_LEN)
    head = u[:, :cut].contiguous()
    plain_ms = {}

    def plain(name, fn):
        if not timed:
            return fn()
        plain_ms[name], out = device_ms(fn, reps=1)
        return out

    ref = plain("ballistics_chain_fwd", lambda: bal.ballistics_chain_fwd_plain(head, consts, zi, spec))
    prim_ref = (plain("ballistics_chain_core", lambda: bal.ballistics_chain_plain(head, consts, zi, spec))
                if timed else (ref[0], ref[2]))
    first = None
    for t in samples:
        prim, last = bal._chain_fwd_cuda("check", u, consts, zi, spec, False, t)
        fwd = bal._chain_fwd_cuda("check", u, consts, zi, spec, True, t)
        torch.cuda.synchronize()
        at = f"{label} T {t or 'picked'}"
        check(torch.equal(fwd[0], prim) and torch.equal(fwd[2], last),
              f"ballistics_chain_fwd {at}: the gain or final states differ from the primal's")
        if first is None:
            first = fwd
        else:
            check(all(torch.equal(a, b) for a, b in zip(fwd, first)),
                  f"ballistics_chain_fwd {at}: differs from its call at T {samples[0] or 'picked'}")
        err = max_err(prim[:, :cut], prim_ref[0])
        ferr = max(max_err(fwd[0][:, :cut], ref[0]), max_err(fwd[1][..., :cut], ref[1]))
        if cut == length:
            err = max(err, max_err(last, prim_ref[1]))
            ferr = max(ferr, max_err(last, ref[2]))
        check(err < MAX_ABS, f"ballistics_chain_core {at}: max abs err {err} >= {MAX_ABS}")
        check(ferr < MAX_ABS, f"ballistics_chain_fwd {at}: max abs err {ferr} >= {MAX_ABS}")
        stats["ballistics_chain_core"]["max_abs_err"] = max(stats["ballistics_chain_core"]["max_abs_err"], err)
        stats["ballistics_chain_fwd"]["max_abs_err"] = max(stats["ballistics_chain_fwd"]["max_abs_err"], ferr)
    fwd_head = first if cut == length else bal._chain_fwd_cuda("check", head, consts, zi, spec, True, samples[0])
    gg = torch.randn(n, cut, generator=gen, device="cuda")
    # the reverse walk's chunk as the wrapper picks it for u's whole rows (the main path's)
    chunk = chunking((n, length))["chunk"]
    bwd = bal.ballistics_chain_bwd(head, fwd_head[1], fwd_head[2], gg, consts, spec, chunk=chunk)
    bwd_ref = plain("ballistics_chain_bwd",
                    lambda: bal.ballistics_chain_bwd_plain(head, fwd_head[1], fwd_head[2], gg, consts, spec))
    torch.cuda.synchronize()
    du_err, du_scale = max_err(bwd[0], bwd_ref[0]), bwd_ref[0].abs().max().item()
    check(du_err <= DU_REL * du_scale, f"ballistics_chain_bwd {label}: du err {du_err} > {DU_REL} x {du_scale}")
    rel, worst = 0.0, du_err
    for q, (g, r) in enumerate(zip(torch.cat(bwd[1:]), torch.cat(bwd_ref[1:]))):
        e, scale = max_err(g, r), r.abs().max().item()
        if scale == 0.0:
            check(bool((g == 0).all()), f"ballistics_chain_bwd {label}: gradient row {q} is 0 in the plain"
                                        " version, not in the kernel's")
        check(e <= GRAD_REL * scale, f"ballistics_chain_bwd {label}: gradient row {q} err {e} > {GRAD_REL} x {scale}")
        rel, worst = max(rel, e / scale if scale > 0 else 0.0), max(worst, e)
    stats["ballistics_chain_bwd"]["max_abs_err"] = max(stats["ballistics_chain_bwd"]["max_abs_err"], worst)
    members = bwd[1].reshape(len(spec), len(bal.CHAIN_ROWS), n)
    for i in range(len(spec)):
        rows = consts[8 * i + 7] <= 0.5
        check(bool((members[i][:, rows] == 0).all()), f"ballistics_chain_bwd {label}: absent member {i}'s"
                                                       " gradients are not 0")
        if len(spec) == 1:
            check(bool((prim[rows] == 1.0).all()), f"ballistics_chain_core {label}: absent gain != 1")
            check(bool((bwd[0][rows] == 0).all()), f"ballistics_chain_bwd {label}: absent du != 0")
    say("chain", case=label, spec=spec, samples=[t or "picked" for t in samples], plain_compared_at=f"{n} x {cut}",
        primal_err=f"{err:.3g}", fwd_err=f"{ferr:.3g}", du_err=f"{du_err:.3g}", du_scale=f"{du_scale:.3g}",
        grad_rel_err=f"{rel:.3g}", primal_equals_fwd=True, stage_lengths_bit_equal=True,
        adjoint_chunk_picked_for=(n, length), **chunking((n, cut), chunk),
        **({"plain_ms": {k: round(v, 1) for k, v in plain_ms.items()}} if timed else {}))
    return plain_ms


def time_chain(u, consts, zi, spec, stats, where, main, plain_ms):
    """The chain's three entry points on ``u``'s rows, 5 calls each after
    a warm-up (CUDA events), beside the plain versions' ``plain_ms``
    (:func:`check_chain`'s, at the first CHAIN_PLAIN_LEN samples); then
    the forwards over CHAIN_SWEEP_SAMPLES (``walk_sweep``) and the
    adjoint over SWEEP_CHUNKS (``chunk_sweep``), 3 calls each;
    ``main``: the kernels' row (the console's composite), else an extra
    shape."""
    n, length = u.shape
    plain_n = min(length, CHAIN_PLAIN_LEN)
    fwd = bal.ballistics_chain_fwd(u, consts, zi, spec)
    gg = torch.randn(u.shape, device="cuda")
    kernel = {
        "ballistics_chain_core": lambda: bal._chain_fwd_cuda("time", u, consts, zi, spec, False),
        "ballistics_chain_fwd": lambda: bal._chain_fwd_cuda("time", u, consts, zi, spec, True),
        "ballistics_chain_bwd": lambda: bal.ballistics_chain_bwd(u, fwd[1], fwd[2], gg, consts, spec),
    }
    work = None if len(bal.chain_walks(spec)) == 4 else CHAIN_WORK_ONE
    fields = {}
    for name in CHAIN_KERNELS:
        kernel[name]()  # warm-up
        ms = device_ms(kernel[name], reps=5)[0]
        more = chunking((n, length)) if name == "ballistics_chain_bwd" else walk_stage("ballistics_core", (n, length))
        entry = {"path": where, "shape": [n, length], "ms": ms, "plain_ms": plain_ms[name],
                 "plain_shape": [n, plain_n], "bound_ms": bound(name, n, length, work and work[name])[0],
                 "floor_ms": 0.662 * length / 2**17 if name != "ballistics_chain_bwd" else None, **more}
        if main:
            stats[name].update(ms=ms, plain_ms=plain_ms[name], plain_shape=[n, plain_n], shape=(n, length), **more)
        else:
            stats[name]["more"].append(entry)
        fields[name] = f"{ms:.3f} (plain {plain_ms[name]:.1f} at {n}x{plain_n}, bound {entry['bound_ms']:.4f})"
    say("chain", timed=where, shape=(n, length), spec=spec, kernel_ms=fields)
    # the forwards' stage length and the adjoint's chunk against their time, 3 calls after a warm-up
    sweeps = [(name, "walk_sweep", {"samples": t}, lambda t=t, res=res: bal._chain_fwd_cuda("sweep", u, consts, zi,
                                                                                           spec, res, t))
              for name, res in (("ballistics_chain_core", False), ("ballistics_chain_fwd", True))
              for t in CHAIN_SWEEP_SAMPLES]
    sweeps += [("ballistics_chain_bwd", "chunk_sweep", chunking((n, length), c),
                lambda c=c: bal.ballistics_chain_bwd(u, fwd[1], fwd[2], gg, consts, spec, chunk=c))
               for c in SWEEP_CHUNKS]
    swept = {}
    for name, key, at, fn in sweeps:
        fn()  # warm-up
        ms = device_ms(fn, reps=3)[0]
        stats[name][key].append({"path": where, "shape": [n, length], **at, "ms": ms})
        swept.setdefault(name, {})[next(iter(at.values()))] = round(ms, 4)
    say("chain", sweep=where, shape=(n, length), by_samples_or_chunk_ms=swept)
    return fields


@contextlib.contextmanager
def composed_dynamics(proc):
    """While entered, ``proc``'s dynamics processors compose (each walk
    its own ``ballistics_core``, the knees in PyTorch), as before the
    chain op: its yardstick on the card.  Their ``chain_spec``, the walk
    op decided at construction, is unset meanwhile."""
    saved = [(m, m.chain_spec) for m in proc.modules() if getattr(m, "chain_spec", None) is not None]
    for m, _ in saved:
        m.chain_spec = None
    try:
        yield
    finally:
        for m, spec in saved:
            m.chain_spec = spec


def chain_vs_composed(label, proc, x, params, w):
    """``proc`` (a gain-smoothed member or composite) on the card through
    the chain and composed: its output and the gradients of ``sum(y w)``
    in every parameter, within -60 dB (output, concatenated gradient), or
    where float32 determines less, within the CPU's own float32 spread +
    SPREAD_DB (:func:`spread_held`: the composed path on the CPU, float32
    and float64).  Prints every leaf's dB, and the forward's ms (no
    gradient; 5 calls after a warm-up, CUDA events) both ways."""
    def run(device, dtype=torch.float32, composed=False):
        p = tree_map(lambda v: v.detach().to(device, dtype).clone().requires_grad_(True), params)
        if "_absent" in p:
            p["_absent"] = p["_absent"].detach()
        proc.to(device, dtype)
        if composed:
            with composed_dynamics(proc):
                y = proc(x.to(device, dtype), **p)
        else:
            y = proc(x.to(device, dtype), **p)
        (y * w.to(device, dtype)).sum().backward()
        grads = {k: v.grad.detach().cpu().double() for k, v in tree_items(p) if v.grad is not None}
        proc.to("cuda", torch.float32)
        return y.detach().cpu().double(), grads

    y, g = run("cuda")
    y_c, g_c = run("cuda", composed=True)
    forward_ms = {}  # the forward alone, no gradient: the chain against the walks and knees it replaced
    with torch.no_grad():
        xc, pc = x.cuda(), tree_map(lambda v: v.cuda(), params)
        for how in ("chain", "composed"):
            with composed_dynamics(proc) if how == "composed" else contextlib.nullcontext():
                proc(xc, **pc)  # warm-up
                forward_ms[how] = round(device_ms(lambda: proc(xc, **pc), reps=5)[0], 4)
        del xc, pc
    cat = lambda d: torch.cat([d[k].ravel() for k in sorted(d)])  # noqa: E731
    results = {"output": (y, y_c), "gradient": (cat(g), cat(g_c))}
    dbs = {k: db(a - b, b) for k, (a, b) in results.items()}
    leaf_db = {k: round(db(g[k] - g_c[k], g_c[k]), 1) for k in g_c if bool((g_c[k] != 0).any())}
    held = {}
    missed = [k for k, v in dbs.items() if v > -60.0]
    if missed:
        y32, g32 = run("cpu", composed=True)
        y64, g64 = run("cpu", torch.float64, composed=True)
        cpu = {"output": (y32, y64), "gradient": (cat(g32), cat(g64))}
        held = {k: spread_held(f"chain vs composed {label}", k, results[k][0], *cpu[k]) for k in missed}
    say("chain", vs_composed=label, rows=x.shape[0], length=x.shape[-1], output_db=f"{dbs['output']:.1f}",
        grad_db=f"{dbs['gradient']:.1f}", leaf_db=leaf_db, forward_ms=forward_ms, bound="-60 dB" if not held else
        {"-60 dB": [k for k in dbs if k not in held], "cpu float32 spread + 6 dB": held})


def chain_phase(smi, stats):
    """Phase 36: the dynamics chain beyond the console's own inputs (phase
    35 (b) holds it there): its forms (CHAIN_SPECS) against the plain
    versions at N = 1, 37, 68 x L = 4109, 8205 and 2^17 + 13 (that one
    compared on its first 2^15 samples), at its own stage length and at T
    = 96; a row split in two calls carrying the final states against one
    call and causality at 68 x (2^17 + 13), bit for bit; and the
    console's member configurations through the chain against the
    composed path on the card."""
    gen = torch.Generator(device="cuda").manual_seed(36)
    start = time.perf_counter()
    with torch.no_grad():
        k = 0
        for n in RAGGED_ROWS:
            for length in RAGGED_LENGTHS + (AUDIO_LEN + 13,):
                spec = CHAIN_SPECS[k % len(CHAIN_SPECS)]
                k += 1
                u = energy(gen, n, length)
                consts, zi = chain_operands(gen, n, spec)
                check_chain(f"ragged ({n}, {length})", u, consts, zi, spec, stats, gen, (None, FORCED_SAMPLES))
        # the split call and causality at 68 x (2^17 + 13) (row starts not 16-byte aligned)
        n, spec = BATCH * CHAINS, CHAIN_SPECS[0]
        u = energy(gen, n, AUDIO_LEN + 13)
        consts, zi = chain_operands(gen, n, spec)
        whole = bal._chain_fwd_cuda("split", u, consts, zi, spec, True)
        prim, last = bal._chain_fwd_cuda("split", u, consts, zi, spec, False)
        cut = AUDIO_LEN // 2 + 7
        first, mid = bal._chain_fwd_cuda("split", u[:, :cut].contiguous(), consts, zi, spec, False)
        second, end = bal._chain_fwd_cuda("split", u[:, cut:].contiguous(), consts, mid, spec, False)
        head = bal._chain_fwd_cuda("split", u[:, :AUDIO_LEN].contiguous(), consts, zi, spec, True)
        torch.cuda.synchronize()
        check(torch.equal(torch.cat([first, second], dim=1), prim) and torch.equal(end, last),
              f"ballistics_chain_core: the row split at {cut} differs from one call")
        check(torch.equal(head[0], whole[0][:, :AUDIO_LEN]) and torch.equal(head[1], whole[1][..., :AUDIO_LEN]),
              f"ballistics_chain_fwd: the first {AUDIO_LEN} samples differ from the whole call's")
        say("chain", split_at=cut, shape=tuple(u.shape), state_carry="exact",
            causality=f"({n}, {AUDIO_LEN + 13}) vs ({n}, {AUDIO_LEN})", bit_equal=True)
        del u, whole, prim, first, second, head
    # the console's member configurations, composed against the chain
    rng = np.random.default_rng(36)
    gs = gain_smoothed_processors()
    composite = FusedDynamicsChain([("0_noisegate", gs["noisegate"]), ("1_compressor", gs["compressor"])])
    for label, proc, n in (("composite", composite, BATCH * CHAINS), ("bus compressor", gs["compressor"], BATCH * 2)):
        g = torch.Generator().manual_seed(n)
        x = console_input((n, 2, AUDIO_LEN), g, "cpu")
        params = tree_map(torch.from_numpy, numpy_parameters(proc.parameter_size(), n, rng, std=0.1))
        if "_absent" in params:  # the console's: 11 of every 17 gates absent
            params["_absent"] = torch.stack([(torch.arange(n) % CHAINS) % 3 != 0,
                                             torch.zeros(n, dtype=torch.bool)], dim=1).float()
        chain_vs_composed(label, proc.cuda(), x, params, torch.randn(n, 2, AUDIO_LEN, generator=g))
    say("chain", phase_36_s=f"{time.perf_counter() - start:.1f}", card=repr(smi))



def gain_smoothed_processors():
    """Phase 35 (b)'s console: bench.py's processors with the compressor
    and the gate smoothing their gains (tests/test_torch_dynamics.py's two
    composed configurations), each smoother an exact recursion."""
    return {**bench_processors(),
            "compressor": Compressor(energy_smoother="ballistics", gain_smoother="ballistics"),
            "noisegate": NoiseGate(energy_smoother="iir_exact", gain_smoother="ballistics",
                                   gain_smooth_in_log=True)}


def gain_smoothed_kernels(smi, stats):
    """Phase 35 (b)'s kernel checks: an eager request and an eager step of
    the console at full width, with the chain's inputs kept
    (:class:`KernelInputs`), and its three entry points held against their
    plain versions on them (:func:`check_path_inputs`, :func:`check_chain`:
    the first 2^15 samples of each row); the chain timed on the composites'
    68-row input (the kernels' row) and the bus compressors' 8 rows."""
    console = bench_console(CHAINS, seed=0, device="cuda", processors=gain_smoothed_processors())
    render = make_render_fn(console.fused_processors, console.plan, jit=False)
    trainer = bench_trainer(CHAINS, seed=0, device="cuda", processors=gain_smoothed_processors(), jit=False)
    g = torch.Generator(device="cuda").manual_seed(7)
    x = console_input((BATCH, CHAINS, 2, AUDIO_LEN), g, "cuda")
    target = torch.randn(BATCH, 1, 2, AUDIO_LEN, generator=g, device="cuda")
    torch.cuda.synchronize()
    bal.reset_launch_counts()
    with KernelInputs() as inputs:
        with torch.inference_mode():
            render(x, console.params)
        trainer.step(x, target)
    torch.cuda.synchronize()
    launches = launched()
    check(launches == {**GS_REQUEST, **GS_STEP}, f"gain-smoothed kernels: a request and a step launched {launches}")
    del console, render, trainer
    with torch.no_grad():
        checked = check_path_inputs("gain-smoothed console", inputs, launches, stats)
        timed = {}
        for (launcher, shape, spec), (u, consts, _, zi) in sorted(inputs.cases.items(), key=str):
            if launcher == "_chain_fwd_cuda" and shape[1] == AUDIO_LEN:
                main = shape[0] == BATCH * CHAINS
                where = "gain-smoothed console, " + ("composites" if main else "bus compressors")
                timed[f"{shape[0]}x{shape[1]}"] = time_chain(u, consts, zi, spec, stats, where, main,
                                                             inputs.plain_ms[(launcher, shape, spec)])
    check(len(timed) == 2, f"gain-smoothed kernels: the chain timed at {list(timed)}, not at 68 and 8 rows")
    say("gain_smoothed", kernels_checked=checked, launches_a_request_and_a_step=launches,
        chain_ms=timed, card=repr(smi))


def gain_smoothed_phase(args, smi, stats):
    """Phase 35 (b): the gain-smoothed console served, trained and streamed
    at (4, 17, 2, 2^17), eager and compiled, card against CPU, with the
    exact launch counts; then its kernels on its own inputs."""
    make = gain_smoothed_processors
    serve_phase(args, smi, stats, "gs_serve", "request_gs", make, exact=GS_REQUEST)
    compiled_request_phase(args, smi, stats, "request_gs", make)
    render_card_vs_cpu("gs_card_vs_cpu", make)
    train_phase(args, smi, stats, "gs_train", "step_gs", make, exact=GS_STEP)
    compiled_step_phase(args, smi, stats, "step_gs", "step_gs", make)
    grad_card_vs_cpu("gs_grad_card_vs_cpu", make, float64_spread=True)
    stream_phase(args, smi, stats, "gs_stream", "stream_block_gs", make, exact=GS_BLOCK)
    compiled_stream_phase(args, smi, stats, "stream_block_gs", make)
    gain_smoothed_kernels(smi, stats)


def builders_phase(smi, stats):
    """Phase 35 (c): ``simple_chain()`` and ``mastering_chain()`` (exact
    backend) through ``GraphParameterOptimizer(device="cuda")`` on one
    stereo source (1, 2, 2^17): the target, the render of their seed-1
    parameters + 0.3 N(0, 1) (``render_current``'s capture: #2 once a
    compressor stage); BUILDER_STEPS fit steps with the defaults (MR-STFT,
    Adam lr 1e-2; the second step's capture #5 and #6 once a compressor
    stage), the loss falling; the first step against the CPU's
    (:func:`step_card_vs_cpu`; its MR-STFT gradient within -60 dB, phase
    7's bound, or within the CPU's own spread + 6 dB).  The kernels of
    these paths (#2, #5, #6 at one row x 2^17) are held against their
    plain versions on the inputs of the first eager render and step
    (:class:`KernelInputs`, :func:`check_path_inputs`)."""
    stems = synthetic_stems(1, AUDIO_LEN, torch.Generator().manual_seed(0)).cuda()
    for name, build in (("simple_chain", simple_chain), ("mastering_chain", mastering_chain)):
        start = time.perf_counter()

        def make(device, jit=True, build=build):
            return GraphParameterOptimizer(*build(backend="exact"), generator=torch.Generator().manual_seed(1),
                                           device=device, jit=jit)

        truth = make("cuda")
        stages = compressor_stages(truth.render_data)
        noise = torch.Generator().manual_seed(8)
        with torch.no_grad():
            for _, p in tree_items(truth.params):
                p.add_(0.3 * torch.randn(p.shape, generator=noise).cuda())
        with KernelInputs() as inputs:
            truth.render_current(stems)  # warm-up: eager, on a side stream
            expected = {k: stages if k == "ballistics_gain_core" else 0 for k in KERNELS}
            target, _, _, render_launches = capturing_call(
                lambda: truth.render_current(stems), f"{name} render_current", expected, stats,
                f"fit_render_{name}_compiled")
            check(target.shape == (1, 2, AUDIO_LEN) and bool(torch.isfinite(target).all()), f"{name}: bad target")
            opt = make("cuda")
            _, first = opt.step(stems, target)  # eager, on a side stream
            expected = {k: stages if k in ("ballistics_gain_fwd", "ballistics_gain_bwd") else 0 for k in KERNELS}
            (_, second), _, _, step_launches = capturing_call(
                lambda: opt.step(stems, target), f"{name} step", expected, stats, f"fit_step_{name}_compiled")
        with torch.no_grad():
            checked = check_path_inputs(name, inputs, {k: render_launches[k] + step_launches[k] for k in KERNELS},
                                        stats)
        history = [first.item(), second.item()] + opt.fit(stems, target, num_steps=BUILDER_STEPS - 2)
        check(all(np.isfinite(history)), f"{name}: non-finite losses {history}")
        check(history[-1] < history[0], f"{name}: the loss did not fall ({history[0]} -> {history[-1]})")
        compiled_ms = call_ms(lambda: opt.step(stems, target))
        del truth, opt
        fields, _ = step_card_vs_cpu(f"{name}_card_vs_cpu", optimizer_model(functools.partial(make, jit=False)),
                                     stems, target, mrstft_db=-60.0)
        say("builders", chain=name, stems=tuple(stems.shape), compressor_stages=stages, steps=len(history),
            loss_first=f"{history[0]:.6f}", loss_last=f"{history[-1]:.6f}",
            losses=[round(v, 6) for v in history], compiled_median_ms=f"{statistics.median(compiled_ms):.3f}",
            render_captured_launches=render_launches, step_captured_launches=step_launches,
            kernel_inputs_checked=checked,
            **{f"first_step_{k}": v for k, v in fields.items()}, seconds=f"{time.perf_counter() - start:.1f}",
            card=repr(smi))


def library_card_phase(args, smi, stats):
    """Phase 35 (module docstring): (a), (b) and (c), each timed."""
    for part, run in (("a", lambda: library_slice_phase(smi, stats)),
                      ("b", lambda: gain_smoothed_phase(args, smi, stats)),
                      ("c", lambda: builders_phase(smi, stats))):
        start = time.perf_counter()
        run()
        say("library35", part=part, seconds=f"{time.perf_counter() - start:.1f}")


def kernel_row(name, source, replaces, stats):
    """The kernel's entry of the ``{"kernels": [...]}`` line."""
    s = stats[name]
    bound_ms, bound_by = bound(name, *s["shape"])
    row = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
           "launches": s.get("launches", 0), "max_abs_err": s["max_abs_err"], "ms": s["ms"],
           "plain_ms": s["plain_ms"], "bound_ms": bound_ms, "bound_by": bound_by,
           "library_ms": None, "shape": list(s["shape"]), "launches_per_run": s["per_run"]}
    for key in ("device_busy_ms", "host_ms", "chunk", "chunks", "samples", "plain_shape"):
        if key in s:
            row[key] = s[key]
    if name in CHAIN_KERNELS:
        row["counterpart"] = OWN_KERNEL
        if name != "ballistics_chain_bwd":
            row["floor_ms"] = 0.662 * s["shape"][1] / 2**17  # one walk's serial chain (PERF.md section 6)
    if s["more"]:
        row["more_shapes"] = s["more"]
    if s["chunk_sweep"]:
        row["chunk_sweep"] = s["chunk_sweep"]
    if s["walk_sweep"]:
        row["walk_sweep"] = s["walk_sweep"]
    if name in NO_PATH:
        row["path"] = NO_PATH[name]
    return row


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--profile", metavar="DIR",
                        help="profile one more warm request, step, stream block and factorized"
                             " step; write their tables to DIR")
    args = parser.parse_args()
    t_start = time.perf_counter()

    # 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.split()[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    say("device", name=repr(kind), count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda, max_sm_clock_mhz=clock_mhz,
        matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
        cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)
    # 2. build
    lib = _cuda.library()
    say("build", seconds=f"{lib.build_seconds:.2f}", libraries=list(lib.paths.values()))
    for line in lib.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print("  nvcc:", line.strip(), flush=True)

    # 3. kernels against their plain versions on the card
    gen = torch.Generator(device="cuda").manual_seed(0)
    stats = {name: {"max_abs_err": 0.0, "per_run": {}, "more": [], "chunk_sweep": [],
                    "walk_sweep": []}
             for name in KERNELS}
    say("kernels", walk_slots=bal.walk_slots("cuda"))
    with torch.inference_mode():
        for label, case, absent in kernel_cases(gen):
            check_case(label, case, stats, absent)
        for case, path in console_cases(gen):
            check_case(f"console {tuple(case.u.shape)}" + (f" {path}" if path else ""), case,
                       stats, timed=True, path=path)
        check_forced_chunks(gen, stats)
        check_ragged_forwards(gen, stats)
        check_causality(gen)
        walk_sweep(gen, stats)
        check_many_rows(gen, stats)
        # #7 at the stream's row counts (17 chain and 2 bus compressors)
        # and more, at a block, a ragged block and a call shorter than its
        # 8-tile ring; timed at the stream's call
        for n in (17, 2, 37, 68):
            for length in (BLOCK_LEN, BLOCK_LEN + 13, 200):
                check_walk(f"N={n} L={length}", *walk_args(gen, n, length), stats)
        check_walk(f"stream call ({CHAINS}, {BLOCK_LEN})", *walk_args(gen, CHAINS, BLOCK_LEN),
                   stats, timed=True)
        big = walk_args(gen, BATCH * CHAINS, AUDIO_LEN)
        bal.ballistics_core(*big)  # warm-up
        big_ms = device_ms(lambda: bal.ballistics_core(*big), reps=5)[0]
        stats["ballistics_core"]["more"].append(
            {"shape": list(big[0].shape), "ms": big_ms, "plain_ms": None,
             "bound_ms": bound("ballistics_core", *big[0].shape)[0],
             **walk_stage("ballistics_core", tuple(big[0].shape))})
        say("kernels", kernel="ballistics_core", shape=tuple(big[0].shape), kernel_ms=f"{big_ms:.3f}",
            **walk_stage("ballistics_core", tuple(big[0].shape)))
        del big
        # #8-#10 at small and ragged shapes (the frame calls' 128 included),
        # then timed at the factorized console's frame calls (68 gate ->
        # compressor chains and 8 bus compressors x 128 frames) and at 68 x 2^17
        for n in (2, 8, 17, 68):
            for length in (64, 128, 200, BLOCK_LEN, BLOCK_LEN + 13):
                check_smoother(f"N={n} L={length}", smoother_case(gen, n, length), stats)
        frames = AUDIO_LEN // FRAME_LEN
        time_smoother(smoother_case(gen, BATCH * CHAINS, frames), stats, plain=True, main=True)
        time_smoother(smoother_case(gen, BATCH * 2, frames), stats, plain=True, main=False)
        big = smoother_case(gen, BATCH * CHAINS, AUDIO_LEN)
        check_smoother_bwd_at(f"N={BATCH * CHAINS} L={AUDIO_LEN}", big, stats)
        time_smoother(big, stats, plain=False, main=False)
        del big
    del case  # the last console case, so that it counts in no later phase's peak memory

    # 4. exactness of the exact IIR cascade on the card
    exact_db = exactness_check_db(device="cuda")
    say("exactness", db=f"{exact_db:.1f}")
    check(exact_db <= -60.0, f"exact IIR cascade at {exact_db:.1f} dB > -60 dB")

    # 5. serve the full-width console
    serve_phase(args, smi, stats, "serve", "request", bench_processors)

    # 6. train the full-width console: three gradient steps
    train_phase(args, smi, stats, "train", "step", bench_processors)

    # 7. the card's loss and gradients against the port's CPU path
    grad_card_vs_cpu("grad_card_vs_cpu", bench_processors)

    # 8. the served console, card against the port's CPU path
    render_card_vs_cpu("card_vs_cpu", bench_processors)

    # 9. stream the full-width console block by block
    stream_phase(args, smi, stats)

    # 10. serve and train the console with the factorized compressor
    factorized_phase(args, smi, stats)

    # 11. its step's loss and gradients, card against the port's CPU path
    grad_card_vs_cpu("factorized_grad_card_vs_cpu", factorized_processors)

    # 12-15. the compiled paths (CUDA-graph replays) beside their eager forms
    phases_at = time.perf_counter()
    request_y = compiled_request_phase(args, smi, stats)
    step13_ms = compiled_step_phase(args, smi, stats, "step", "step", bench_processors)
    compiled_step_phase(args, smi, stats, "step_factorized", "factorized_step", factorized_processors)
    compiled_stream_phase(args, smi, stats)
    compiled_s = time.perf_counter() - phases_at

    # 16. serving.py: exported render and stream steps against the live paths
    serving_phase(smi, stats)
    say("compiled", phases_12_15_s=f"{compiled_s:.1f}",
        phase_16_s=f"{time.perf_counter() - phases_at - compiled_s:.1f}")

    # 17-20. the packaged fit loop: fit, resume, the delay console, the predictor
    phases_at = time.perf_counter()
    stems, target, fit_busy = fit_phase(args, smi, stats)
    resume_phase(stems, target)
    delay_phase(args, smi, stats, stems, target, fit_busy)
    predictor_phase(smi, stats, stems, target)
    say("fit", phases_17_20_s=f"{time.perf_counter() - phases_at:.1f}")

    # 21-24. the console on fsm equalizers served, trained and streamed, and
    # the fused-delay fit console
    phases_at = time.perf_counter()
    fsm_serve_phase(args, smi, stats)
    train_phase(args, smi, stats, "fsm_train", "step_fsm", fsm_processors)
    compiled_step_phase(args, smi, stats, "step_fsm", "step_fsm", fsm_processors)
    grad_card_vs_cpu("fsm_grad_card_vs_cpu", fsm_processors)
    stream_phase(args, smi, stats, "fsm_stream", "stream_block_fsm", fsm_processors)
    compiled_stream_phase(args, smi, stats, "stream_block_fsm", fsm_processors, step_many=False)
    fused_delay_phase(args, smi, stats, stems, target)
    say("fsm", phases_21_24_s=f"{time.perf_counter() - phases_at:.1f}")

    # 25-27. the rest of the processor library: the noise console and the
    # FDN console served, trained and streamed, then each new class alone
    phases_at = time.perf_counter()
    # the piecewise distortion's input stays below its threshold at the
    # parameters' init (sigmoid(0) = 0.5; max |x| 0.10 on a 5-chain CPU
    # render), where its hardness and threshold have no gradient
    console_phases(args, smi, stats, "noise", noise_processors, noisy=True, key_seed=11,
                   nonzero=lambda leaf: leaf not in ("dist/log_hardness", "dist/z_threshold"))
    console_phases(args, smi, stats, "fdn", fdn_processors, noisy=False, key_seed=12)
    say("library", phases_25_26_s=f"{time.perf_counter() - phases_at:.1f}")
    phases_at = time.perf_counter()
    library_phase(smi)
    say("library", phase_27_s=f"{time.perf_counter() - phases_at:.1f}")

    # 28-31. the rest of the render engine: schedules, the array buffer and
    # the one-by-one step, batched graphs, the convolution forms
    phases_at = time.perf_counter()
    schedules_phase(smi, stats)
    array_buffer_phase(smi, stats)
    batched_phase(smi, stats)
    conv_forms_phase(smi)
    device_time_cross_check(smi)
    say("engine", phases_28_31_s=f"{time.perf_counter() - phases_at:.1f}")

    # 32. parallel/: sharded renders and steps, each rank a process; then
    # the fsm console's render and stream step exported and loaded
    phases_at = time.perf_counter()
    parallel_phase(smi, stats, request_y, step13_ms)
    del request_y
    serving_phase(smi, stats, fsm_processors, tag="_fsm")
    say("parallel", phase_32_s=f"{time.perf_counter() - phases_at:.1f}")

    # 33. every path repeats bit for bit, and runs under
    # torch.use_deterministic_algorithms(True)
    phases_at = time.perf_counter()
    determinism_phase(smi)
    say("determinism", phase_33_s=f"{time.perf_counter() - phases_at:.1f}")

    # 34. the README's six examples through their main, on the card
    phases_at = time.perf_counter()
    examples_phase(smi, stats)
    say("examples", phase_34_s=f"{time.perf_counter() - phases_at:.1f}")

    # 35. the library classes no card path had run, the gain-smoothed
    # console (#7-#9 at full rate) and the single-source builders
    phases_at = time.perf_counter()
    library_card_phase(args, smi, stats)
    say("library35", phase_35_s=f"{time.perf_counter() - phases_at:.1f}")

    # 36. the dynamics chain at ragged shapes, split, causal, against the
    # composed path on the card
    phases_at = time.perf_counter()
    chain_phase(smi, stats)
    say("chain", phase_36_s_whole=f"{time.perf_counter() - phases_at:.1f}")

    for name in KERNELS:
        check(name in NO_PATH or "launches" in stats[name], f"{name} ran on no path")
    say("done", seconds=f"{time.perf_counter() - t_start:.1f}")
    print(json.dumps({"kernels": [
        kernel_row(name, source, replaces, stats)
        for name, source, replaces in [(n, *v) for n, v in KERNELS.items()] + [LAYOUT_ROW]
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
