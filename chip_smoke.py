#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py            # every phase
    python3 chip_smoke.py stream     # B1 and phase 19 alone
    python3 chip_smoke.py stale      # B1, B2 and phase 20 alone

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc`` with
``nvcc`` and drives the port's paths on the card:

0. setup: the card's name and power limit, versions, both kernels' builds
   (one ``nvcc`` per source, started together);
1. decode: the kernels' table-driven η decode against the plain rule on
   the card over all ``2**24`` inputs (bitwise), and the count that differ
   from numpy's fp64 ``log`` on the host; the kernels' division-free site
   pick against ``w0 % n_v`` on the card over ``2**24`` words for each
   n_v of ``SITE_N_VS``;
2. B1 against its plain version: ``pdes_multistep_counter`` at the main
   path's shape (L = 10,000 PEs, B = 448 rings, K = 16 and a K = 5
   remainder chunk), τ/ucount/min/max bitwise, the sums to a stated
   tolerance; then both timed with CUDA events, and the kernel also at
   the paper-figure L = 1000 (``L_PAPER``);
3. B1's path: an in-process ``SweepService`` drain of three requests at
   L = 10,000, N_V = 10 on the ``pallas_multistep`` backend, every
   response bit-identical to a direct ``run_window_sweep``, physics bounds
   asserted, B1's launch count read;
4. B2 against its plain version: ``pdes_step`` at B = 448, Lc = 10,000
   over N_V, ``rd_mode``, ``border_both``, static Δ, a folded Δ column and
   a stale base, and the same cases at every (B, Lc) of ``STEP_SHAPES``
   (a ``--pdes-core`` shard's 8-block clusters, the commavoid edge
   strip's shared blocks, odd and long rows); τ′/ucount/min/max bitwise,
   the sums to tolerance; a row's six moments bitwise the same in a
   larger batch, alone and at B = 1; timed with CUDA events, at every
   shape beside its bytes bound, with the host-side pieces of one engine
   step;
5. B2's path, the ``pallas`` backend: (a) 256 exact-window steps bitwise
   equal to ``pallas_multistep``; (b) a stale-window ``SweepService``
   drain, every response equal to a direct run, stale ``u`` at most exact
   ``u`` + 0.01; (c) ``refine_optimal_window`` through one service; B2's
   launch count read over the phase;
6. the threefry generator (``kernels/threefry.py``, no TPU counterpart)
   against its plain version over one K = 16 chunk at B = 448,
   L = 10,000, bitwise; the plain cipher on the card on the Random123
   known-answer vectors; the words against JAX's own, committed below;
   timed;
7. B3 against its plain version: ``pdes_multistep`` on generator words at
   B = 448, L = 10,000, K = 16 and a K = 5 remainder chunk over N_V, Δ,
   ``rd_mode`` and ``border_both``; τ/ucount/min/max bitwise, the sums to
   tolerance; timed, and the kernel also at L = 1000;
8. B3's path: (a) ``ops.simulate`` for 1024 steps with the kernels against
   the same call with the plain versions on the card, bitwise; (b)
   ``simulate`` against ``horizon.run`` at the JAX test's shape and
   tolerances, and at full width over 64 steps (reported, not bitwise);
   (c) ``ensemble.steady_state(backend=None)`` against the
   ``pallas_multistep`` engine at the same depth; B3's and the
   generator's launch counts on (a), the generator's on (c); a profiler
   split of three chunks;
9. the sharded backend (``core/distributed.py``) in this process as the
   one rank of an NCCL process group: (a) the exact mode over 256 steps
   at Δ = 16 and (b) the commavoid mode (K = 16), each bitwise in τ, the
   offsets, ``u`` and ``gvt`` against the ``pallas_multistep`` (exact)
   or stale ``pallas`` engine and held to ``run_reference``, also at the
   JAX test's shape; (c) a ``SweepService(mesh=)`` drain of phase 3's
   requests at phase 5's cut depth, each response bitwise a direct
   ``run_window_sweep(mesh=)`` and equal in ``u`` and GVT rate to
   ``pallas_multistep``; (d) wall per chunk beside the ``pallas``
   backend's, B2's launches, a profile with the NCCL calls' share;
10. the serve daemon, telemetry and ``--mesh``: (a) an in-process
   ``serve_daemon`` (telemetry off) on two intake files, one a round:
   phase 3's three requests, then dave (alice's spec at 2048 steps, her
   burn-in from the state cache), every response equal to a direct run,
   B1's launches read; (b) ``python -m repro_torch.service serve`` with
   the state cache, metrics and trace, crashed by fault injection after
   its first pass and restarted: every response equal to (a)'s bit for
   bit, dave's 256 rows all from the cache, the time to recover split;
   (c) ``python -m repro_torch.obs summarize --check`` on (b)'s files;
   (d) phase 9(c)'s requests through ``python -m repro_torch.service
   --mesh data=1,model=1`` (one NCCL rank), equal to phase 9(c)'s
   responses bit for bit, B2's launches read in the rank, and a mesh
   larger than the GPUs refused with exit 2; (e) (a)'s wall with
   telemetry on against off, five drains each in turns;
11. the language-model serve path (``repro_torch.models``,
   ``repro_torch.serve``; no TPU kernel lies on it, so it adds none): (a)
   llama3.2-1b at full width (16 layers, d 2048, vocab 128,256; fp32
   parameters, bf16 compute), drawn on the card from generator seed 0,
   serving 16 requests through ``ServeEngine`` (8 lanes, Δ = 16): every
   result present and in range; each batch's prefill and every decode
   step timed with CUDA events, tokens/s, peak memory, the idle share of 8
   profiled decode steps, lane utilization beside ``u_RD(Δ)``, and the
   bounds; (b) the same widths cut to 2 layers in fp32 (TF32 off): 64
   tokens fed one by one through ``decode_step`` give ``prefill``'s
   logits to 2e-3; (c) reduced llama3.2-1b, gemma2-2b and mixtral-8x7b in
   fp32 on the card against the same parameters on the CPU: prefill
   logits, the cache and 8 decode steps to rtol 1e-4, and a 4-request
   ``ServeEngine`` drain token for token;
12. the ssm, hybrid and encdec families (no TPU kernel lies on them
   either): (a) zamba2-2.7b and (b) mamba2-130m at their published widths
   and depths, fp32 parameters and bf16 compute, each served through
   phase 11's engine and request mix with prompts of 128 to 512 tokens in
   steps of the SSM chunk (``SSM_PROMPTS``), with phase 11's timings,
   bounds, profile and lane utilization; (c) whisper-base at full width:
   encode 8 x 1024 frame embeddings, the cross K/V for a 448-slot
   decoder, 64 greedy decode steps from token 0, each timed; (d) in fp32
   with TF32 off, decode fed token by token against prefill for
   mamba2-130m at full width and depth and zamba2-2.7b's widths cut to
   one group (6 SSM layers, one shared block), to 2e-3; (e) the reduced
   mamba2-130m, zamba2-2.7b and whisper-base in fp32 on the card against
   the same parameters on the CPU: prefill logits, every cache leaf and 8
   decode steps to rtol 1e-4, and the same greedy tokens;
13. the port's PDES examples as subprocesses: ``quickstart_torch.py`` as
   it is, ``pdes_scaling_study_torch.py`` and ``paper_figures_torch.py``
   with ``--fast --backend pallas_multistep`` (B1 under new entry
   points; the figures' claims asserted), each one's wall, B1's and the
   generator's launches;
14. training (``repro_torch.train``; no TPU kernel lies on it, so it adds
   none): (a) mamba2-130m at full width, B 4 x S 512, remat full,
   ce_chunk 256, fp32 parameters and bf16 compute, 48 steps through
   ``TrainController`` uninterrupted and again with failures injected at
   steps 20 and 37 (a checkpoint every 16): 2 restarts, the final loss
   within rtol 1e-5 of the uninterrupted run's (bitwise reported), the
   loss falling, every gradient norm finite; each step timed with CUDA
   events, tokens/s, peak memory, the bound and a profile; then the
   trained module's ``prefill`` equal to a fresh module's loaded through
   the bridge; (b) ``python -m repro_torch.launch.train --arch
   llama3.2-1b --steps 8 --batch 4 --seq 2048 --ckpt-every 4 --fail-at
   6`` as a subprocess (exit 0, 1 restart, a finite, falling loss), then
   4 steps in this process timed and split (flash forward and backward,
   AdamW, the chunked cross-entropy) and 2 profiled; (c) every reduced
   arch's loss and gradients, card against CPU in fp32 with TF32 off;
   (d) (a)'s trained state saved on the card, restored on the CPU and
   back, bitwise;
15. the sharding rules (``repro_torch.distributed.sharding``, DTensor)
   and the dry run (``repro_torch.launch.dryrun``): (a) phase 14(b)'s
   llama step, 2 steps with ``par`` on a (1, 1) ``("data", "model")``
   mesh over NCCL, the losses and every parameter bitwise equal to the
   ``par=None`` steps, step ms (CUDA events) and peak memory; (b) the dry
   run of that cell on a one-rank fake group, its predicted flops, bytes,
   peak memory and roofline beside (a)'s measurement; (c) llama's
   train_4k at its full 16 layers, prefill_32k and decode_32k on the
   256-rank production mesh, each loop counted once and scaled by its
   trip count (``launch.cost.scan``): each trace's wall, per-device
   memory, flops, collectives, dominant roofline term; (d)
   ``--pdes-core`` on the single mesh, one rank's shard of L = 2^20 x 512
   trials x 64 steps run on the card (both modes), every B2 launch held
   against its plain version, the collective bytes and messages a step,
   B2's launches, ms and share of its bytes bound;
16. the causality linter (``repro_torch.analysis``), after the kernels
   are built: ``python -m repro_torch.analysis --backend all --format
   json -o <file>`` as a subprocess, exit 0 and each backend's report
   equal to ``tests/golden/analysis_<backend>.json``; every kernel's
   launch plan at L = 10,000, ``tiling.MAX_RING_L``, 65,536, 131,072,
   911,360 (16 blocks), 2^20 and ``tiling.MAX_GRID_RING_L`` with the
   registers, static shared bytes and spills of this run's ptxas logs
   (the ring kernels' grid instantiations, which must spill nothing, at
   the last five),
   against one block's budget, and B2's
   plan (cluster size, rows a block) at 10,000, 65,536 and
   ``MAX_RING_L``; the six seeded fixtures, each firing its own rule and
   only it;
17. long rings of 2 to 16 blocks over the cooperative grid
   (``tiling.ring_plan``):
   (a) B1 against its plain version at B = 448 x L = 65,536 (2 blocks a
   ring) and 131,072 (3), 32 x 524,288 (10) and 8 x 911,360 (16), over
   phase 2's five cases with the step
   counter wrapping, τ/ucount/min/max bitwise and the sums to tolerance;
   a row's moments bitwise the same at B = 448, 32 and 1 at 131,072; the
   rings the card holds at once on each plan's tier;
   (b) B3 the same at B = 8, L = 65,536 and 524,288, and ``ops.simulate``
   there with the kernels against the plain versions; (c) phase 3's
   requests through ``SweepService`` at L = 131,072 (1024 + 1024 steps),
   every response bitwise a direct ``run_window_sweep``, the drain wall
   and B1's launches; (d) each (a) and (b) shape timed (CUDA events,
   plain, kernel, kernel, plain) beside its bound;
18. rings over a cooperative grid (``tiling.ring_plan``'s third tier,
   the paper's production ring L = 2^20 in 22 blocks): (a) B1 against its
   plain version at B = 8 x 2^20 (6 rings at once, two waves) and 1 x
   ``MAX_GRID_RING_L`` (132 blocks) over phase 2's five cases with the
   step counter wrapping, τ/ucount/min/max bitwise and the sums to
   tolerance; a row's moments bitwise the same at B = 8, 6 and 1; (b) B3
   and ``ops.simulate`` at 2 x 2^20 against the plain versions; (c) phase
   3's requests through ``SweepService`` at L = 2^20 (depth cut to 256 +
   256 steps), every response bitwise a direct ``run_window_sweep``, the
   drain wall and B1's launches; (d) the dry run's production core,
   ``PDESEngine(PDESConfig(L=2^20, n_v=100, delta=100),
   backend="pallas_multistep")`` with 512 trials for 64 steps: its wall,
   PE-steps/s and ``max_memory_allocated``, its observables in range and
   two of its trials run alone equal to theirs bit for bit; (e) each (a)
   and (b) shape timed beside its bound;
19. rings past shared memory (``tiling.ring_plan``'s stream tier, B1
   alone): (a) B1 against its plain version at 1 x (``MAX_GRID_RING_L`` +
   32) (one row of each segment in device memory) and 1 and 2 x 2^23
   (6,592 PEs of each segment there) over phase 2's five cases with the
   step counter wrapping, τ/ucount/min/max bitwise and the sums to
   tolerance, the plan, its bytes in device memory a chunk and the stream
   instantiation's ptxas figures printed; a row's moments bitwise the
   same at B = 2 and alone (its second wave against its first); (b) an
   exact request at 2^23 through ``SweepService``, bitwise a direct
   ``run_window_sweep``; (c) the (a) shapes of one ring timed beside their
   bound.  ``python3 chip_smoke.py stream`` builds B1 and runs this phase
   alone;
20. the stale window on B1 (``pallas_multistep``, ``window="stale"``):
   (a) the ptxas figures of B1's 18 instantiations (the ``kStale`` ones
   beside the exact ones), none spilling; B1's stale kernel at the main
   pass of the stale cell (``STALE_B1``, 28 x 2^20, the grid tier)
   against its plain version, ``rebase`` off and on, a K = 16 chunk and
   a K = 5 one each with the step counter wrapping: τ, ucount, min and
   max bitwise, the sums to tolerance, and its ucount not the exact
   window's; then that shape timed beside its bound in both windows;
   (b) a stale drain at L = 2^20 through ``SweepService``: alice, bob and
   carol (alice's duplicate) over a burn-in of chunks and a remainder,
   then dave (alice at twice the steps, from the burned-state cache),
   every response bitwise a direct ``run_window_sweep``, every pass
   naming the stale window and counting all the phase's B1 launches
   (``b1_rebased_launches``); (c) the same drains on ``pallas`` (B2, a
   launch a step), equal in ``u`` and the GVT rate bit for bit and the
   sums to tolerance; both walls.  ``python3 chip_smoke.py stale`` builds
   B1 and B2 and runs this phase alone;
21. the last lines: one JSON object per kernel (times, bound, launches;
   B1's also its stale chunk's, phase 20(a), under ``stale``),
   then ``{"ok": true, "device": {...}}``.

Every phase asserts; any failure exits non-zero with no result line.
Without CUDA, or outside a checkout of the repository, it exits 1.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import math
import os
import pathlib
import shutil
import subprocess
import sys
import tempfile
import textwrap
import time

#: Ring length and volume load of the main path (10x the L = 1000 of the
#: paper-figure benchmarks).
L_MAIN = 10_000
N_V_MAIN = 10
#: The ring length of the paper-figure benchmarks (benchmarks/run.py), at
#: which phases 2 and 7 also time B1 and B3.
L_PAPER = 1000
#: The n_v values at which phase 1 checks the site pick: every shape of its
#: multiply-high constants, up to the largest uint32.
SITE_N_VS = (1, 2, 3, 10, 1000, 2**31 + 1, 2**32 - 1)
#: Rings in the main path's coalesced pass: alice's 4 x 64 + bob's 3 x 64.
REPLICAS = 64
B_MAIN = 7 * REPLICAS
K_MAIN = 16
BURN_MAIN = 4096
STEPS_MAIN = 1024
#: Largest η the decode gives: -ln(2**-25).
ETA_MAX = 17.4
#: The sums (sum, sumsq, sumabs) are reduced in another order by the
#: kernel than by the plain version: relative tolerance, and an absolute
#: one for sumabs of a nearly synchronized ring (near zero), where one ulp
#: of the ring mean moves sumabs by up to (PEs below - PEs above) ulps.
SUM_RTOL = 1e-5
SUM_ATOL = 1e-2
EXACT_KEYS = ("ucount", "min", "max")

#: H100 SXM published peaks: HBM rate (``main`` reads it, with the bf16
#: peak, from ``repro_torch.launch.mesh``), and the fp32 rate outside the
#: tensor cores, the only non-tensor 32-bit rate the datasheet gives; the
#: kernel's integer hash and fp32 work are counted at it.
HBM_BYTES_PER_S = None
SCALAR_OPS_PER_S = 67e12
#: Operations of the kernel (see the note in its source): per PE-step
#: 23 integer (PE hash, word 0, site pick) and 11 fp32 (rules, moments,
#: sumabs); per PE that updates, 15 more (word 1, decode, log, add).
OPS_PER_PE_STEP = 34
OPS_PER_UPDATE = 15
#: Operations of B2 (see the note in its source): per PE 14 (site pick,
#: border compares, rules, moments, sumabs); per PE that updates, 6 more
#: (decode, log, add).  No hash: the bits come from memory.
STEP_OPS_PER_PE = 14
STEP_OPS_PER_UPDATE = 6
#: Phase 4: the shapes (B, Lc) at which B2 is also held to its plain
#: version and timed, beside the main path's: a ``--pdes-core`` shard (512
#: trials over 16 ``data`` ranks, 2^20 PEs over 16 ``model`` ranks), one
#: Δ's replicas, the commavoid shard step's K = 16 edge strip, the JAX
#: tests' odd row, and a row past B1's shared memory (None:
#: ``tiling.MAX_RING_L`` + 1000); and the rows of its batch-invariance
#: check, launched in a larger batch, alone and one by one.
STEP_SHAPES = ((32, 65_536), (64, 10_000), (32, 16), (3, 37), (2, None))
BATCH_ROWS = 32
#: Clock cycles the card sleeps while ``device_ms`` queues its calls
#: (about 10 ms, longer than the host takes to queue 200 launches).
SLEEP_CYCLES = 20_000_000
#: The cut depth of phase 5: burn-in and measured steps of the stale drain
#: and of the refinement (default_burn_in asks for 32,143 at Δ = 64), and
#: the steps of the exact-window comparison.
BURN_SLICE = 1024
STEPS_SLICE = 1024
STEPS_EXACT = 256
#: Operations of the generator (see the note in its source): 73 integer
#: operations a word (threefry2x32 and the final xor).
GEN_OPS_PER_WORD = 73
#: Operations of B3 (see the note in its source): as B2's, per PE-step and
#: per PE that updates.
B3_OPS_PER_PE_STEP = 14
B3_OPS_PER_UPDATE = 6
#: Phase 8: the window of B3's path, its simulated steps, the steps of the
#: full-width simulate/horizon.run comparison, and the cut depth of the
#: threefry steady state (default_burn_in asks for 23,036 at Δ = 16).
DELTA_SIM = 16.0
STEPS_SIM = 1024
STEPS_CMP = 64
BURN_THREEFRY = 1024
STEPS_THREEFRY = 1024
#: Chunks in the profiled ``simulate`` call of phase 8: the kernel counts
#: show whether the profiler dropped a launch.
PROFILE_CHUNKS = 3
#: Phase 9: the window and steps of the sharded runs held against the
#: engines, the chunks of each timed call and the rounds of timed calls
#: (host-bound walls: each round runs every path, in turns).  The service
#: drain runs at phase 5's cut depth (``BURN_SLICE``, ``STEPS_SLICE``).
DELTA_SHARDED = 16.0
STEPS_SHARDED = 256
TIMED_CHUNKS = 8
TIMED_ROUNDS = 5
#: Phase 10: dave's measured steps (alice's spec, longer: her stream prefix
#: and burn-in), the rounds of timed drains of (e), each run in turns with
#: telemetry off and on, and the seconds each subprocess is allowed.
STEPS_DAVE = 2048
SERVE_ROUNDS = 5
SUBPROCESS_S = 300
#: Phase 11(a): the model served at full width, the engine's lanes, cache
#: length and window, the requests (prompt lengths and new tokens drawn
#: uniformly from these ranges; every batch's padded length stays within
#: the config's q_block of 512) and the decode steps profiled.
LM_ARCH = "llama3.2-1b"
LM_LANES = 8
LM_MAX_LEN = 1024
LM_DELTA = 16.0
LM_REQUESTS = 16
LM_PROMPT = (64, 512)
LM_NEW = (16, 64)
LM_PROFILE_STEPS = 8
#: The H100 SXM's dense bf16 tensor-core peak (data sheet), for the
#: prefill bound; ``main`` reads it from ``repro_torch.launch.mesh``.
BF16_FLOPS_PER_S = None
#: Phase 11(b): layers kept of the full widths, and tokens fed one by one;
#: phase 11(c): the reduced archs held card against CPU, the decode steps
#: compared and the requests drained on both.
LM_CHECK_LAYERS = 2
LM_CHECK_TOKENS = 64
LM_CPU_ARCHS = ("llama3.2-1b", "gemma2-2b", "mixtral-8x7b")
LM_CPU_STEPS = 8
LM_CPU_REQUESTS = 4
#: Tolerances: (b) ``tests/test_models.py``'s decode-against-prefill one;
#: (c) the CPU parity tests' (fp32 sums in another order).
LM_DECODE_TOL = 2e-3
LM_RTOL, LM_ATOL = 1e-4, 1e-5
#: Phase 12(a, b): the hybrid and the Mamba2 decoder served at full width
#: through phase 11's engine and request mix, prompt lengths drawn from
#: these (every padded batch a multiple of the SSM chunk, 128, and within
#: the hybrid's flash q_block of 512, as the reference requires).
SSM_ARCHS = ("zamba2-2.7b", "mamba2-130m")
SSM_PROMPTS = (128, 256, 384, 512)
#: Phase 12(c): whisper-base's batch, encoder frames (the released 1500
#: break the reference's flash blocking: neither at most q_block = 1024
#: nor a multiple of it), decoder cache (the released target length) and
#: greedy decode steps.
WHISPER_ARCH = "whisper-base"
WHISPER_BATCH = 8
WHISPER_FRAMES = 1024
WHISPER_MAX_DECODE = 448
WHISPER_STEPS = 64
#: Phase 12(d): decode fed token by token against prefill, fp32, TF32
#: off: (arch, layers kept (None = all), tokens).
FAMILY_CHECKS = (("mamba2-130m", None, 64), ("zamba2-2.7b", 6, 64))
#: Phase 12(e): the reduced archs held card against CPU, decode steps.
FAMILY_CPU_ARCHS = ("mamba2-130m", "zamba2-2.7b", "whisper-base")
#: Phase 14(a): mamba2-130m trained at full width with
#: ``examples/train_lm_torch.py``'s batch and sequence, uninterrupted and
#: with injected failures; a checkpoint every ``TRAIN_SSM_CKPT`` steps.
TRAIN_SSM_ARCH = "mamba2-130m"
TRAIN_SSM_SHAPE = (4, 512)
TRAIN_SSM_STEPS = 48
TRAIN_SSM_CKPT = 16
TRAIN_SSM_FAILS = (20, 37)
#: Phase 14(b): llama3.2-1b through the launcher as a subprocess, then
#: steps timed in the process; steps profiled in (a) and (b).
TRAIN_LM_ARGS = ("--arch", "llama3.2-1b", "--steps", "8", "--batch", "4",
                 "--seq", "2048", "--ckpt-every", "4", "--fail-at", "6")
TRAIN_LM_TIMED = 4
TRAIN_PROFILE_STEPS = 2
#: Phase 14(c): every reduced arch, card against CPU in fp32 (TF32 off):
#: the batch, the loss's rtol, and each gradient leaf's tolerance as a
#: share of its largest entry, plus ``LM_ATOL`` (a gradient that is zero
#: but for rounding, as whisper's key biases', is all noise).  (a)'s
#: recovered run against the uninterrupted one: the JAX test's rtol on
#: the final loss.
TRAIN_CPU_SHAPE = (2, 64)
TRAIN_RTOL = 1e-5
TRAIN_GRAD_TOL = 1e-4
#: The H100's float32 rate outside the tensor cores (data sheet): the
#: port's attention and cross-entropy products run in fp32.
FP32_FLOPS_PER_S = 67e12
#: Phase 15: (a) phase 14(b)'s llama step, sharded on a (1, 1) mesh over
#: NCCL against the one-device step, ``SHARDED_STEPS`` steps each;
#: (c) the production mesh's dry run of ``DRY_CELLS`` at full depth;
#: (d) the PDES core's shard at the reference's dry-run size.
SHARDED_STEPS = 2
DRY_CELLS = ("train_4k", "prefill_32k", "decode_32k")
PDES_CORE = dict(L=1 << 20, trials=512, steps=64)
#: Phase 13: the port's PDES examples, run as subprocesses from the root.
EXAMPLES = (
    ("examples/quickstart_torch.py", ()),
    ("examples/pdes_scaling_study_torch.py",
     ("--fast", "--backend", "pallas_multistep")),
    ("examples/paper_figures_torch.py",
     ("--fast", "--backend", "pallas_multistep")),
)
#: Phase 10(b)'s restart: the CLI's own ``main`` with the clock read
#: (CLOCK_MONOTONIC, shared with the parent) after the torch import and
#: CUDA init, after loading B1's library and around the state cache's
#: load, written to ``STAMPS`` at exit.
RESTART = textwrap.dedent("""
    import json, os, sys, time
    stamps = {}
    import torch
    if os.environ["DEVICE"] == "cuda":
        torch.zeros(1, device="cuda")
        torch.cuda.synchronize()
    stamps["cuda"] = time.perf_counter()
    from repro_torch.kernels import _build
    if os.environ["DEVICE"] == "cuda":
        _build.load("pdes_multistep_counter")
    stamps["library"] = time.perf_counter()
    from repro_torch.service import state_cache
    from repro_torch.service.__main__ import main
    load = state_cache.StateCache.load

    def timed_load(self, path):
        t0 = time.perf_counter()
        n = load(self, path)
        stamps["cache"] = [t0, time.perf_counter()]
        return n

    state_cache.StateCache.load = timed_load
    try:
        rc = main()
    finally:
        with open(os.environ["STAMPS"], "w") as fh:
            json.dump(stamps, fh)
    sys.exit(rc)
""")
#: Phase 10(d)'s ``--mesh`` drain: the CLI's own ``main``; every rank (the
#: launcher starts copies of this command line) writes B2's launch count
#: to ``COUNTS/rank<r>`` at exit.
COUNTED = textwrap.dedent("""
    import atexit, os, sys
    from repro_torch.kernels import pdes_step
    from repro_torch.service.__main__ import main

    def count():
        path = os.path.join(os.environ["COUNTS"], "rank" + os.environ["RANK"])
        with open(path, "w") as fh:
            fh.write(str(pdes_step.launches))

    if "RANK" in os.environ:
        atexit.register(count)
    sys.exit(main())
""")
#: Phase 13's example runs: the script (argv[1]) as ``__main__``, with
#: B1's and the generator's launch counts written to ``COUNTS`` at exit.
EXAMPLE = textwrap.dedent("""
    import atexit, json, os, runpy, sys
    from repro_torch.kernels import pdes_multistep, threefry

    def count():
        with open(os.environ["COUNTS"], "w") as fh:
            json.dump({"B1": pdes_multistep.launches,
                       "threefry_bits": threefry.launches}, fh)

    atexit.register(count)
    sys.argv = sys.argv[1:]
    runpy.run_path(sys.argv[0], run_name="__main__")
""")
#: JAX's own words: (step, b, l, word 0, word 1) of
#: repro.core.horizon.event_bits(jax.random.key(7), step, (448, 10000)),
#: made on the CPU with jax 0.9.0 by
#:   w = np.asarray(horizon.event_bits(jax.random.key(7), jnp.uint32(step),
#:                                     (448, 10000)))
#: and read at w[b, l, 0] and w[b, l, 1].
JAX_WORDS = [
    (3, 0, 0, 0x3B38B794, 0x5108BA83),
    (3, 0, 1, 0xCAA8A765, 0x88E2AE98),
    (3, 223, 5000, 0x96A28762, 0xB9F3F838),
    (3, 447, 9998, 0x8DC79F7C, 0x166EC9EF),
    (3, 447, 9999, 0x60421E03, 0xCA883E06),
    (2147483647, 0, 0, 0x7BF73FCE, 0x9784C588),
    (2147483647, 0, 1, 0xC09C994F, 0x25AD6E62),
    (2147483647, 223, 5000, 0x702F800B, 0xABF74FAC),
    (2147483647, 447, 9998, 0x014826ED, 0x1D12F2E9),
    (2147483647, 447, 9999, 0x82F29DDC, 0xB97A3D6B),
]
#: Random123's known-answer vectors of threefry2x32: (k0, k1, x0, x1) ->
#: (y0, y1).
THREEFRY_KAT = [
    ((0, 0, 0, 0), (0x6B200159, 0x99BA4EFE)),
    ((0xFFFFFFFF,) * 4, (0x1CB996FC, 0xBB002BE7)),
    ((0x13198A2E, 0x03707344, 0x243F6A88, 0x85A308D3),
     (0xC4923A9C, 0x483DF7A0)),
]


#: Phase 17: rings longer than one block's shared memory, of 2 to 16
#: blocks of the cooperative grid (``tiling.ring_plan``).  (B, L) of B1's
#: checks: 2, 3, 10 (the JAX package's one-row VMEM budget ends at
#: 524,285) and 16 blocks (16 x ``tiling.MAX_RING_SEG``); B3's through
#: ``ops.simulate``;
#: the rows of the batch-independence check at ``L_LONG`` (a launch of 32
#: and one of 1 out of the 448); the ring, burn-in and timed launches of
#: the service drain of (c), the paper's large-L regime at 13 times
#: ``L_MAIN``.
LONG_B1 = ((448, 65_536), (448, 131_072), (32, 524_288), (8, 911_360))
LONG_B3 = ((8, 65_536), (8, 524_288))
LONG_ROWS = (slice(400, 432), slice(446, 447))
L_LONG = 131_072
BURN_LONG = 1024
LONG_STEPS_SIM = 2 * K_MAIN + 5
#: Phase 18: rings over a cooperative grid.  The paper's production ring
#: (``src/repro/launch/dryrun.py:170``, 22 blocks); B1 at 8 of them (6 at
#: once on 132 SMs, so two waves) and at one ring of the cap (132 blocks),
#: rows 0-5 (one wave), 6 and 7 (the second) and 0 alone held to the batch
#: of 8; B3 and ``simulate`` at 2; the service drain at ``L_PROD``, its
#: depth cut to ``BURN_PROD`` + ``STEPS_PROD``; the production core
#: (``PDES_CORE``) through the engine.
L_PROD = 1 << 20
GRID_B1 = ((8, L_PROD), (1, None))
GRID_ROWS = (slice(0, 6), slice(6, 7), slice(7, 8), slice(0, 1))
GRID_B3 = 2
BURN_PROD = 256
STEPS_PROD = 256
#: Phase 19: rings past one card's shared memory (B1's stream tier).  (B,
#: L) of B1's checks (None: one row past ``tiling.MAX_GRID_RING_L``); the
#: rows held to the batch at ``L_STREAM``; the service request there.
L_STREAM = 1 << 23
STREAM_B1 = ((1, None), (1, L_STREAM), (2, L_STREAM))
STREAM_ROWS = (slice(0, 1), slice(1, 2))
#: Phase 20: the stale window.  B1's stale kernel at the main pass of the
#: cell stale_fused_mix.ring1m (28 rows of ``L_PROD``, N_V 100, the
#: configuration's Δs), held to its plain version and timed; the drain at
#: ``L_PROD``: its burn-in (two chunks and a remainder), measured steps
#: and replicas a Δ.
STALE_B1 = (28, L_PROD)
N_V_STALE = 100
DELTAS_STALE = (10.0, 30.0, 100.0, 300.0, math.inf)
BURN_STALE = 2 * K_MAIN + 8
STEPS_STALE = 64
REPLICAS_STALE = 2


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    return 1


def check(ok: bool, msg) -> None:
    """Raise unless ``ok`` (an ``assert`` that ``python -O`` keeps)."""
    if not ok:
        raise AssertionError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def sync(torch, dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def cuda_ms(fn, reps: int) -> float:
    """Mean ms of ``fn`` over ``reps`` back-to-back calls (CUDA events)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int) -> float:
    """Mean ms of ``fn`` over ``reps`` calls queued while the card sleeps
    (CUDA events): the kernels then run back to back with no host time
    between them, so a call whose host work outlasts its kernel shows the
    kernel's time, not the host's."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def phase_decode(torch, horizon, pm, dev):
    """Kernel decode == plain rule on the card; count against the host.
    Kernel site pick == ``%`` on the card."""
    import numpy as np
    w1 = torch.arange(1 << 24, device=dev, dtype=torch.int64) << 8
    plain = horizon.decode_eta(w1)
    for table in (False, True):     # the library log; the kernels' table
        kern = pm.decode_eta_cuda(w1, table=table)
        n_bad = int((kern.view(torch.int32) != plain.view(torch.int32)).sum())
        check(n_bad == 0, f"kernel decode (table={table}) differs from the "
                          f"plain rule on {n_bad} of 2**24 inputs")
    kh = np.arange(1 << 24, dtype=np.uint32)
    x = kh.astype(np.float32) * np.float32(2.0**-24) + np.float32(2.0**-25)
    host = (-np.log(x.astype(np.float64))).astype(np.float32)
    got = kern.cpu().numpy()
    diff = np.flatnonzero(got.view(np.int32) != host.view(np.int32))
    print(f"[decode] kernel decodes (library log, table) == plain rule on the "
          f"card on all 2**24 inputs; table decode "
          f"differs from numpy fp64 log on the host on {diff.size} inputs"
          + (f" (first k: {diff[:8].tolist()})" if diff.size else ""))
    gen = torch.Generator(device=dev).manual_seed(1)
    for n_v in SITE_N_VS:
        edges = [0, 1, n_v - 1, n_v, n_v + 1, 2**32 - 2, 2**32 - 1]
        for m in (2, 3, (2**32 - 1) // n_v):
            edges += [m * n_v - 1, m * n_v, m * n_v + 1]
        edges = torch.tensor([e for e in edges if 0 <= e < 2**32],
                             dtype=torch.int64, device=dev)
        words = torch.randint(0, 2**32, ((1 << 24) - edges.numel(),),
                              generator=gen, device=dev, dtype=torch.int64)
        words = torch.cat([edges, words])
        sites = pm.site_pick_cuda(words, n_v)
        n_bad = int((sites != words % n_v).sum())
        check(n_bad == 0, f"kernel site pick differs from % {n_v} on "
                          f"{n_bad} of {words.numel()} words")
    print(f"[decode] kernel site pick == w0 % n_v on the card over 2**24 "
          f"words (edges and random) for n_v in {SITE_N_VS}")
    return int(diff.size)


def _kernel_inputs(torch, rng, B: int, L: int, dev):
    import numpy as np
    tau = rng.exponential(4.0, size=(B, L)).astype(np.float32)
    deltas = np.array([1.0, 4.0, 16.0, 64.0, np.inf], np.float32)
    dcol = deltas[np.arange(B) % deltas.size][:, None]
    trials = np.arange(B, dtype=np.int64)
    pad = min(REPLICAS, B)
    trials[-pad:] = -1 - np.arange(pad)     # the service's pad indices
    return (torch.as_tensor(tau, device=dev),
            torch.as_tensor(dcol, device=dev),
            torch.as_tensor(trials[:, None], device=dev))


def _hold_kernel(torch, got, want, what) -> float:
    """A kernel's (tau, moments) against its plain version's: tau, ucount,
    min and max bitwise, the sums within tolerance; returns the sums' max
    |err|."""
    check(torch.equal(got[0], want[0]), f"tau differs: {what}")
    err = 0.0
    for key in want[1]:
        a, b = got[1][key], want[1][key]
        if key in EXACT_KEYS:
            check(torch.equal(a, b), f"{key} differs: {what}")
        else:
            check(torch.allclose(a, b, rtol=SUM_RTOL, atol=SUM_ATOL),
                  f"{key} beyond tolerance: {what}")
        err = max(err, float((a - b).abs().max()))
    return err


def phase_kernel(torch, pm, ref, build, dev, timer=cuda_ms):
    """Kernel against its plain version at the main path's shape."""
    import numpy as np
    rng = np.random.default_rng(0)
    tau0, dcol, tcol = _kernel_inputs(torch, rng, B_MAIN, L_MAIN, dev)
    # (n_v, rd_mode, border_both, per-row columns or scalar b0 + static Δ)
    cases = [(1, False, False, True), (10, False, False, True),
             (10, True, False, True), (10, False, True, True),
             (10, False, False, False)]
    max_err = 0.0
    for n_v, rd_mode, border_both, cols in cases:
        case = dict(n_v=n_v, rd_mode=rd_mode, border_both=border_both)
        tau = tau0
        step0 = 0xFFFFFFF0            # the step counter wraps mid-run
        for k in (K_MAIN, K_MAIN, K_MAIN, 5):
            ctr = torch.tensor([[7, step0, 0 if cols else 3, 0]])
            args = (tau, ctr, dcol if cols else None, tcol if cols else None)
            kw = dict(k_steps=k, delta=math.inf if cols else 16.0, **case)
            got = pm.pdes_multistep_counter(*args, **kw)
            max_err = max(max_err, _hold_kernel(
                torch, got, ref.pdes_multistep_counter_ref(*args, **kw),
                f"{case} cols={cols} K={k}"))
            tau = got[0]
            step0 = (step0 + k) & 0xFFFFFFFF
    print(f"[kernel] tau/ucount/min/max bitwise equal to the plain version "
          f"over {len(cases)} cases x 4 chunks at B={B_MAIN} L={L_MAIN}; "
          f"max |err| of the sums {max_err:.3g}")

    # timing at the main path's operands: per-row Δ and trial columns
    ctr = torch.tensor([[0, 0, 0, 0]])
    kw = dict(k_steps=K_MAIN, n_v=N_V_MAIN, delta=math.inf)

    def kern():
        return pm.pdes_multistep_counter(tau0, ctr, dcol, tcol, **kw)

    def plain():
        return ref.pdes_multistep_counter_ref(tau0, ctr, dcol, tcol, **kw)

    p1 = timer(plain, 3)
    k1 = timer(kern, 20)
    k2 = timer(kern, 20)
    p2 = timer(plain, 3)
    k_ms, p_ms = min(k1, k2), min(p1, p2)
    # the kernel alone, without the wrapper's host work, at both L
    raw = {}
    for L in (L_MAIN, L_PAPER):
        tau_l, dcol_l, tcol_l = ((tau0, dcol, tcol) if L == L_MAIN else
                                 _kernel_inputs(torch, rng, B_MAIN, L, dev))
        tcol_l = build.u32_bits(tcol_l).reshape(B_MAIN, 1).contiguous()
        out = torch.empty_like(tau_l)
        stats = torch.empty((6, K_MAIN, B_MAIN), device=dev)
        raw[L] = min(timer(lambda: pm.counter_launch(
            tau_l, out, stats, dcol_l, tcol_l, (0, 0, 0, 0), n_v=N_V_MAIN,
            delta=math.inf, rd_mode=False, border_both=False), 20)
            for _ in range(2))
    print(f"[kernel] the kernel alone (raw launch): K={K_MAIN} chunk at "
          f"B={B_MAIN} L={L_MAIN} {raw[L_MAIN]:.5f} ms, L={L_PAPER} "
          f"{raw[L_PAPER]:.5f} ms")
    pe_steps = B_MAIN * L_MAIN * K_MAIN
    print(f"[kernel] K={K_MAIN} chunk at B={B_MAIN} L={L_MAIN} N_V={N_V_MAIN}:"
          f" kernel {k1:.4f} / {k2:.4f} ms, plain {p1:.4f} / {p2:.4f} ms "
          f"(order plain, kernel, kernel, plain); kernel "
          f"{pe_steps / (k_ms * 1e-3):.4g} PE-steps/s, plain "
          f"{pe_steps / (p_ms * 1e-3):.4g} PE-steps/s")
    _, m = kern()
    ucount = float(m["ucount"].sum())
    n_bytes = 8 * B_MAIN * L_MAIN + 4 * len(m) * K_MAIN * B_MAIN + 8 * B_MAIN
    n_ops = OPS_PER_PE_STEP * pe_steps + OPS_PER_UPDATE * ucount
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / SCALAR_OPS_PER_S * 1e3
    print(f"[kernel] bound: {n_bytes} bytes -> {bytes_ms:.4g} ms, "
          f"{n_ops:.4g} operations (utilization {ucount / pe_steps:.4f}) -> "
          f"{ops_ms:.4g} ms")
    print(f"[kernel] kernel at {max(bytes_ms, ops_ms) / k_ms:.3f} of the "
          f"bound")
    return dict(max_abs_err=max_err, ms=k_ms, plain_ms=p_ms,
                bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations")


def phase_main_path(torch, pm, sweep, api, trace, dev, chunk_ms, L=L_MAIN,
                    burn_in=BURN_MAIN, tag="main", n_steps=STEPS_MAIN):
    """The service drain on the card, through the kernel.

    ``chunk_ms`` is the kernel's time for one K = 16 chunk at B = 448 from
    phase 2: every chunk of this drain has that shape, so launches x
    ``chunk_ms`` is the kernel's share of the drain.  Phases 17(c) and
    18(c) drive the same requests at a longer ring ``L`` with their own
    ``burn_in`` and ``n_steps``.
    """
    sync(torch, dev)
    pm.launches = 0
    responses, st, wall = _drain(torch, sweep, api, dev, L, burn_in, n_steps)
    launches = pm.launches
    for resp in responses:
        check(resp.error is None, (resp.requester, resp.error))
    check(launches > 0, "the main path launched no kernel")
    check(st.n_deduped == 1 and st.n_passes == 1, st)
    check(st.rows_computed == B_MAIN, st)
    pe_steps = st.engine_row_steps * L
    print(f"[{tag}] drain of {len(responses)} requests: {wall:.3f} s wall, "
          f"{st.n_passes} coalesced pass, {st.rows_computed} rows, "
          f"{pe_steps:.4g} PE-steps, {pe_steps / wall:.4g} PE-steps/s, "
          f"{launches} kernel launches")
    print(f"[{tag}] kernel time {launches} x {chunk_ms:.4f} ms = "
          f"{launches * chunk_ms:.1f} ms of {wall * 1e3:.1f} ms wall "
          f"({launches * chunk_ms / (wall * 1e3):.3f} of the drain)")
    tracer = trace.TraceRecorder()
    prev = trace.set_tracer(tracer)
    direct = {}
    for resp in responses:
        spec = resp.spec
        if spec not in direct:
            direct[spec] = sweep.run_window_sweep(spec, device=dev)
        check(resp.result.as_dict() == direct[spec].as_dict(),
              f"{resp.requester}: response differs from a direct run")
        for rec in resp.result.records:
            check(0.0 < rec.u <= 1.0, rec)
            check(math.isfinite(rec.w2) and math.isfinite(rec.rate), rec)
            if math.isfinite(rec.delta):
                check(rec.spread <= rec.delta + ETA_MAX, rec)
            print(f"[{tag}] {resp.requester:5s} delta={rec.delta:<5g} "
                  f"u={rec.u:.6f}+-{rec.u_err:.2g} w2={rec.w2:.5g} "
                  f"spread={rec.spread:.5g} rate={rec.rate:.6f}")
    trace.set_tracer(prev)
    for ev in tracer.events:
        print(f"[{tag}] direct run_window_sweep span {ev['name']:7s} "
              f"{ev['dur'] / 1e3:9.3f} ms  {ev.get('args', {})}")
    print(f"[{tag}] every response equals a direct run_window_sweep "
          "bit for bit; u in (0, 1]; spread <= delta + 17.4")
    return launches


def _drain(torch, sweep, api, dev, L, burn_in, n_steps):
    """Phase 3's three requests (alice, bob, carol = alice) at ring ``L``
    through a new ``SweepService``: ``(responses, stats, wall s)``."""
    common = dict(Ls=(L,), n_vs=(N_V_MAIN,), replicas=REPLICAS,
                  n_steps=n_steps, burn_in=burn_in,
                  backend="pallas_multistep", k_fuse=K_MAIN, seed=0)
    specs = {
        "alice": sweep.WindowSweep(deltas=(1.0, 4.0, 16.0, 64.0), **common),
        "bob": sweep.WindowSweep(deltas=(4.0, 16.0, math.inf), **common),
        "carol": sweep.WindowSweep(deltas=(1.0, 4.0, 16.0, 64.0), **common),
    }
    svc = api.SweepService(device=dev)
    for who, spec in specs.items():
        svc.submit(spec, requester=who)
    sync(torch, dev)
    t0 = time.perf_counter()
    responses = svc.drain()
    sync(torch, dev)
    return responses, svc.stats, time.perf_counter() - t0


def _step_bytes(B: int, Lc: int) -> int:
    """Bytes B2 must move on (B, Lc): tau_h read once, the words, tau'
    written once, the gvt column and the six moment rows."""
    return 4 * B * (Lc + 2) + 8 * B * Lc + 4 * B + 4 * B * Lc + 4 * 6 * B


def _step_cases(gvt, stale, dcol):
    """(n_v, rd_mode, border_both, window base, static Δ) of phase 4."""
    return [(1, False, False, gvt, 16.0), (10, False, False, gvt, 16.0),
            (10, False, False, gvt, math.inf), (10, True, False, gvt, 4.0),
            (10, False, True, gvt, 16.0), (10, False, False, stale, 16.0),
            (10, False, False, gvt + dcol, 0.0),
            (10, False, False, stale + dcol, 0.0)]


def _step_inputs(torch, ops, events, B, Lc, seed, dev):
    """Phase 4's operands at (B, Lc): counter bits with the service's
    negative pad trials, a Δ column with inf rows, the exact base."""
    import numpy as np
    tau, dcol, tcol = _kernel_inputs(torch, np.random.default_rng(seed), B,
                                     Lc, dev)
    bits = events.counter_bits_block(7, 0xFFFFFFFF, tcol[:, 0], 0, B, Lc)
    gvt = torch.amin(tau, dim=-1, keepdim=True)
    return tau, ops.ring_halo(tau), bits, gvt, dcol


def _hold_step(torch, ps, ref, tau_h, bits, base, kw, what) -> float:
    """B2 against its plain version on one input: tau'/ucount/min/max
    bitwise, the sums within tolerance; returns the sums' max |err|."""
    t_p, _, m_p = ref.pdes_step_ref(tau_h, bits, base, **kw)
    return _hold_kernel(torch, ps.pdes_step(tau_h, bits, base, **kw),
                      (t_p, m_p), what)


def phase_step(torch, ps, ref, ops, events, build, dev, timer=cuda_ms,
               dev_timer=device_ms):
    """B2 against its plain version at the main path's shape and at
    ``STEP_SHAPES``, its moments the same at any batch, then timed: the
    shapes with the card's queue filled first (``device_ms``), so a
    launch-bound shape shows the kernel's time, not the host's."""
    from repro_torch.kernels.tiling import MAX_RING_L, step_plan
    tau, tau_h, bits, gvt, dcol = _step_inputs(torch, ops, events, B_MAIN,
                                               L_MAIN, 1, dev)
    stale = gvt - 3.0                 # a stale base below the row minimum
    max_err = 0.0
    cases = _step_cases(gvt, stale, dcol)
    for n_v, rd_mode, border_both, base, delta in cases:
        kw = dict(n_v=n_v, delta=delta, rd_mode=rd_mode,
                  border_both=border_both)
        max_err = max(max_err, _hold_step(
            torch, ps, ref, tau_h, bits, base, kw,
            f"{kw} stale={base is stale}"))
    print(f"[step] tau'/ucount/min/max bitwise equal to the plain version "
          f"over {len(cases)} cases at B={B_MAIN} Lc={L_MAIN}; max |err| of "
          f"the sums {max_err:.3g}")
    shapes = [(B, Lc or MAX_RING_L + 1000) for B, Lc in STEP_SHAPES]
    inputs = {}
    for i, (B, Lc) in enumerate(shapes):
        _, th, bt, g, dc = inputs[B, Lc] = _step_inputs(
            torch, ops, events, B, Lc, 10 + i, dev)
        err = 0.0
        for n_v, rd_mode, border_both, base, delta in _step_cases(
                g, g - 3.0, dc):
            kw = dict(n_v=n_v, delta=delta, rd_mode=rd_mode,
                      border_both=border_both)
            err = max(err, _hold_step(torch, ps, ref, th, bt, base, kw,
                                      f"{kw} at B={B} Lc={Lc}"))
        max_err = max(max_err, err)
        print(f"[step] B={B} Lc={Lc} ({step_plan(Lc)}): tau'/ucount/min/max "
              f"bitwise over {len(cases)} cases; max |err| of the sums "
              f"{err:.3g}")

    # the same rows give the same moments, bit for bit, at any batch
    kw = dict(n_v=N_V_MAIN, delta=0.0)
    for B, Lc in ((B_MAIN, L_MAIN), (64, 65_536), (64, 16)):
        _, th, bt, g, dc = ((tau, tau_h, bits, gvt, dcol) if Lc == L_MAIN
                            else _step_inputs(torch, ops, events, B, Lc, 20,
                                              dev))
        base = g + dc
        t_all, m_all = ps.pdes_step(th, bt, base, **kw)
        runs = [(slice(0, BATCH_ROWS), 0)] + [
            (slice(r, r + 1), r) for r in range(BATCH_ROWS)]
        for rows, r0 in runs:
            t_b, m_b = ps.pdes_step(th[rows], bt[rows], base[rows], **kw)
            n = t_b.shape[0]
            check(torch.equal(t_all[r0:r0 + n], t_b),
                  f"tau' of rows {rows} depends on the batch at Lc={Lc}")
            for key, v in m_b.items():
                check(torch.equal(m_all[key][r0:r0 + n], v),
                      f"{key} of rows {rows} depends on the batch "
                      f"(B={B} against {n}) at Lc={Lc}")
        print(f"[step] batch invariance at Lc={Lc}: the first {BATCH_ROWS} "
              f"rows of a B={B} launch give all six moments and tau' bit for "
              f"bit as at B={BATCH_ROWS} and each at B=1")

    # timing at the main path's operands: N_V = 10, the folded Δ column
    base = gvt + dcol
    kw = dict(n_v=N_V_MAIN, delta=0.0, rd_mode=False, border_both=False)
    words = build.u32_bits(bits).reshape(bits.shape).contiguous()
    out = torch.empty((B_MAIN, L_MAIN), dtype=torch.float32, device=dev)
    stats = torch.empty((6, B_MAIN), dtype=torch.float32, device=dev)

    def kern():
        ps.launch(tau_h, words, base, out, stats, **kw)

    def plain():
        return ref.pdes_step_ref(tau_h, bits, base, **kw)

    p1 = timer(plain, 5)
    k1 = timer(kern, 200)
    k2 = timer(kern, 200)
    p2 = timer(plain, 5)
    k_ms, p_ms = min(k1, k2), min(p1, p2)
    print(f"[step] one step at B={B_MAIN} Lc={L_MAIN} N_V={N_V_MAIN}: kernel "
          f"{k1:.5f} / {k2:.5f} ms, plain {p1:.4f} / {p2:.4f} ms (order "
          f"plain, kernel, kernel, plain)")
    # the kernel alone at every shape, beside its bytes bound
    for B, Lc in shapes:
        _, th, bt, g, dc = inputs[B, Lc]
        w = build.u32_bits(bt).reshape(bt.shape).contiguous()
        o = torch.empty((B, Lc), dtype=torch.float32, device=dev)
        st = torch.empty((6, B), dtype=torch.float32, device=dev)
        b = g + dc
        t1, t2 = (dev_timer(lambda: ps.launch(th, w, b, o, st, **kw), 200)
                  for _ in range(2))
        b_ms = _step_bytes(B, Lc) / HBM_BYTES_PER_S * 1e3
        print(f"[step] kernel at B={B} Lc={Lc}: {t1:.5f} / {t2:.5f} ms; "
              f"bytes bound {_step_bytes(B, Lc)} B -> {b_ms:.5f} ms, share "
              f"{b_ms / min(t1, t2):.3f}; plan {ps.launch_plan(B, Lc)}")

    # the host-side pieces of one `pallas` engine step, at the same shape
    trials = torch.arange(B_MAIN, device=dev)
    pieces = {
        "counter_bits_block": lambda: events.counter_bits_block(
            0, 5, trials, 0, B_MAIN, L_MAIN),
        "int64->uint32 words": lambda: build.u32_bits(bits),
        "ring_halo": lambda: ops.ring_halo(tau),
        "amin (exact GVT)": lambda: torch.amin(tau, dim=-1, keepdim=True),
        "wrapper (int64 bits)": lambda: ps.pdes_step(tau_h, bits, base,
                                                     **kw),
    }
    for name, fn in pieces.items():
        print(f"[step] piece {name:22s} {timer(fn, 20):.5f} ms")
    ucount = float(ps.pdes_step(tau_h, bits, base, **kw)[1]["ucount"].sum())
    n_pe = B_MAIN * L_MAIN
    n_bytes = _step_bytes(B_MAIN, L_MAIN)
    n_ops = STEP_OPS_PER_PE * n_pe + STEP_OPS_PER_UPDATE * ucount
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / SCALAR_OPS_PER_S * 1e3
    print(f"[step] bound: {n_bytes} bytes -> {bytes_ms:.4g} ms, {n_ops:.4g} "
          f"operations (utilization {ucount / n_pe:.4f}) -> {ops_ms:.4g} ms; "
          f"kernel at {bytes_ms / k_ms:.3f} of the bytes bound")
    return dict(max_abs_err=max_err, ms=k_ms, plain_ms=p_ms,
                bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations")


def _profile(torch, dev, fn, warm=True, host=True):
    """Device time by kernel over one call of ``fn`` (run once before,
    unprofiled, if ``warm``), from torch.profiler; None where the profiler
    gives no device time.  ``comm_host_us`` is the host time of the
    collectives' ``c10d::`` operators in the call (with ``host``: the
    host's operators are recorded too, which costs a train step's 10**5
    of them tens of seconds)."""
    from torch.profiler import ProfilerActivity, profile
    if warm:
        fn()
    sync(torch, dev)
    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host
                                            else [])
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        sync(torch, dev)
        wall_us = (time.perf_counter() - t0) * 1e6
    rows, comm_host_us = [], 0.0
    for ev in prof.key_averages():
        if not str(ev.device_type).endswith("CUDA"):
            if ev.key.startswith("c10d::"):
                comm_host_us += ev.cpu_time_total
            continue                  # host ops: their kernels are listed
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0.0))
        if us > 0:
            rows.append((us, ev.key, ev.count))
    if not rows:
        return None
    rows.sort(reverse=True)
    return dict(wall_us=wall_us, busy_us=sum(r[0] for r in rows), rows=rows,
                comm_host_us=comm_host_us)


def _profile_steps(torch, engine_cls, cfg, dev, deltas, trials):
    """The profiler over one 16-step chunk of the stale `pallas` path."""
    eng = engine_cls(cfg, backend="pallas", window="stale", k_fuse=K_MAIN,
                     device=dev)
    st = eng.init(B_MAIN)
    return _profile(torch, dev, lambda: eng.run(st, 0, K_MAIN, deltas=deltas,
                                                trial_base=trials))


def phase_slice(torch, ps, sweep, api, opt, engine_mod, dev, step_ms):
    """B2's path: the `pallas` backend, exact and stale, with Δ* tuning.

    ``step_ms`` is B2's time for one step at B = 448 from phase 4; every
    step of part (b)'s drain has that shape.
    """
    times = {}
    ps.launches = 0
    # (a) exact window: pallas == pallas_multistep at the service's columns
    deltas = torch.tensor([d for d in (1.0, 4.0, 16.0, 64.0)
                           for _ in range(REPLICAS)]
                          + [d for d in (4.0, 16.0, math.inf)
                             for _ in range(REPLICAS)], device=dev)
    trials = torch.cat([torch.arange(4 * REPLICAS, device=dev),
                        torch.arange(3 * REPLICAS, device=dev)])
    cfg = engine_mod.PDESConfig(L=L_MAIN, n_v=N_V_MAIN)
    runs = {}
    for backend in ("pallas", "pallas_multistep"):
        eng = engine_mod.PDESEngine(cfg, backend=backend, k_fuse=K_MAIN,
                                    device=dev)
        sync(torch, dev)
        t0 = time.perf_counter()
        runs[backend] = eng.run(eng.init(B_MAIN), 0, STEPS_EXACT,
                                deltas=deltas, trial_base=trials)
        sync(torch, dev)
        times[f"a_{backend}"] = time.perf_counter() - t0
    (sa, a), (sb, b) = runs["pallas"], runs["pallas_multistep"]
    for f in ("tau", "offset", "offset_comp"):
        check(torch.equal(getattr(sa, f), getattr(sb, f)),
              f"pallas {f} differs from pallas_multistep")
    bitwise = []
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        if f in ("utilization", "gvt"):
            check(torch.equal(x, y), f"pallas {f} differs")
        else:
            check(torch.allclose(x, y, rtol=SUM_RTOL, atol=SUM_ATOL),
                  f"pallas {f} beyond tolerance")
        if torch.equal(x, y):
            bitwise.append(f)
    print(f"[slice a] {STEPS_EXACT} exact-window steps at B={B_MAIN} "
          f"L={L_MAIN}: pallas {times['a_pallas']:.3f} s, pallas_multistep "
          f"{times['a_pallas_multistep']:.3f} s; tau, offsets, utilization "
          f"and gvt bitwise equal; bitwise StepStats fields: {bitwise}")

    # (b) the stale-window service drain
    common = dict(Ls=(L_MAIN,), n_vs=(N_V_MAIN,), replicas=REPLICAS,
                  n_steps=STEPS_SLICE, burn_in=BURN_SLICE, backend="pallas",
                  window="stale", k_fuse=K_MAIN, seed=0)
    specs = {
        "alice": sweep.WindowSweep(deltas=(1.0, 4.0, 16.0, 64.0), **common),
        "bob": sweep.WindowSweep(deltas=(4.0, 16.0, math.inf), **common),
        "carol": sweep.WindowSweep(deltas=(1.0, 4.0, 16.0, 64.0), **common),
    }
    svc = api.SweepService(device=dev)
    for who, spec in specs.items():
        svc.submit(spec, requester=who)
    sync(torch, dev)
    n0 = ps.launches
    t0 = time.perf_counter()
    responses = svc.drain()
    sync(torch, dev)
    times["b_drain"] = wall = time.perf_counter() - t0
    drain_launches = ps.launches - n0
    st = svc.stats
    for resp in responses:
        check(resp.error is None, (resp.requester, resp.error))
    check(st.n_deduped == 1 and st.n_passes == 1, st)
    check(st.rows_computed == B_MAIN, st)
    pe_steps = st.engine_row_steps * L_MAIN
    print(f"[slice b] stale drain of {len(responses)} requests: {wall:.3f} s "
          f"wall, {st.n_passes} coalesced pass, {st.rows_computed} rows, "
          f"{pe_steps:.4g} PE-steps, {pe_steps / wall:.4g} PE-steps/s, "
          f"{drain_launches} B2 launches")
    print(f"[slice b] B2 time {drain_launches} x {step_ms:.5f} ms = "
          f"{drain_launches * step_ms:.1f} ms of {wall * 1e3:.1f} ms wall "
          f"({drain_launches * step_ms / (wall * 1e3):.4f} of the drain); "
          f"{wall * 1e3 / (BURN_SLICE + STEPS_SLICE):.4f} ms wall per "
          f"engine step")
    t0 = time.perf_counter()
    direct, exact = {}, {}
    for resp in responses:
        spec = resp.spec
        if spec not in direct:
            direct[spec] = sweep.run_window_sweep(spec, device=dev)
            ex = sweep.run_window_sweep(
                sweep.WindowSweep(**{**common, "deltas": spec.deltas,
                                     "backend": "pallas_multistep",
                                     "window": "exact"}), device=dev)
            exact.update({(spec, r.delta): r.u for r in ex.records})
        check(resp.result.as_dict() == direct[spec].as_dict(),
              f"{resp.requester}: response differs from a direct run")
        for rec in resp.result.records:
            check(0.0 < rec.u <= 1.0, rec)
            check(math.isfinite(rec.w2) and math.isfinite(rec.rate), rec)
            if math.isfinite(rec.delta):
                check(rec.spread <= rec.delta + ETA_MAX, rec)
            u_ex = exact[(spec, rec.delta)]
            check(rec.u <= u_ex + 0.01,
                  f"stale u {rec.u} above exact u {u_ex} + 0.01")
            print(f"[slice b] {resp.requester:5s} delta={rec.delta:<5g} "
                  f"u={rec.u:.6f}+-{rec.u_err:.2g} (exact {u_ex:.6f}) "
                  f"w2={rec.w2:.5g} "
                  f"spread={rec.spread:.5g} rate={rec.rate:.6f}")
    sync(torch, dev)
    times["b_direct"] = time.perf_counter() - t0
    print(f"[slice b] every stale response equals a direct run_window_sweep "
          f"bit for bit; u in (0, 1]; spread <= delta + 17.4; stale u <= "
          f"exact u + 0.01 (direct and exact runs {times['b_direct']:.3f} s)")

    # (c) Δ* through one service
    coarse = sweep.WindowSweep(
        deltas=(1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0), **common)
    svc = api.SweepService(device=dev)
    t0 = time.perf_counter()
    refined = opt.refine_optimal_window(coarse, service=svc)
    sync(torch, dev)
    times["c_refine"] = time.perf_counter() - t0
    check(refined.bracket[0] <= refined.delta_star <= refined.bracket[1],
          refined)
    check(all(math.isfinite(e) for _, e in refined.evaluations), refined)
    check(svc.stats.rows_from_state_cache > 0,
          "the polish did not use the state cache")
    print(f"[slice c] refine_optimal_window: delta*={refined.delta_star:.6g} "
          f"bracket={refined.bracket} interior={refined.interior} "
          f"rounds={refined.rounds} eff*={refined.eff_star:.6g} "
          f"u*={refined.u_star:.6f} w*={refined.w_star:.6g}; "
          f"{svc.stats.n_requests} probes in {svc.stats.n_passes} passes, "
          f"{svc.stats.rows_from_state_cache} rows from the state cache, "
          f"{times['c_refine']:.3f} s")
    print("[slice c] evaluations (delta, efficiency): "
          + json.dumps([[d, e] for d, e in refined.evaluations]))
    launches = ps.launches
    check(launches > 0, "B2's path launched no kernel")
    total = sum(times.values())
    print(f"[slice] B2 launches over the phase: {launches}; wall "
          + ", ".join(f"{k} {v:.3f} s" for k, v in times.items())
          + f"; total {total:.3f} s")
    prof = _profile_steps(torch, engine_mod.PDESEngine, cfg, dev, deltas,
                          trials)
    if prof is None:
        print("[slice] torch.profiler gave no device time: idle share "
              "not measured")
    else:
        print(f"[slice] profiler, one {K_MAIN}-step stale chunk at "
              f"B={B_MAIN}: wall {prof['wall_us'] / 1e3:.3f} ms, device busy "
              f"{prof['busy_us'] / 1e3:.3f} ms (idle share "
              f"{1 - prof['busy_us'] / prof['wall_us']:.3f})")
        for us, key, count in prof["rows"][:12]:
            print(f"[slice] profiler {us / 1e3:9.3f} ms {count:6d}x  "
                  f"{key[:90]}")
    return launches



def _bound(n_bytes, n_ops):
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / SCALAR_OPS_PER_S * 1e3
    return bytes_ms, ops_ms, dict(
        bound_ms=max(bytes_ms, ops_ms),
        bound_by="bytes" if bytes_ms >= ops_ms else "operations")


def phase_generator(torch, tf, prng, dev, timer=cuda_ms):
    """The generator against its plain version, the KATs and JAX's words."""
    cols = torch.tensor([k for k, _ in THREEFRY_KAT], device=dev).T
    y0, y1 = prng.threefry2x32(*cols)
    got = list(zip(y0.tolist(), y1.tolist()))
    check(got == [w for _, w in THREEFRY_KAT],
          f"threefry2x32 fails the known-answer vectors: {got}")
    key = prng.key(7, dev)
    shape = (B_MAIN, L_MAIN)
    step0 = 2**31 - 8                 # the chunk crosses the int32 boundary
    got = tf.threefry_bits(key, step0, K_MAIN, shape)
    want = tf.threefry_bits_plain(key, step0, K_MAIN, shape)
    n_bad = int((got != want).sum())
    check(n_bad == 0, f"generator differs from the plain version on "
                      f"{n_bad} words")
    max_err = float((got.to(torch.int64) - want.to(torch.int64)).abs().max())
    del want
    for step in sorted({w[0] for w in JAX_WORDS}):
        words = tf.threefry_bits(key, step, 1, shape)[0]
        words = words.to(torch.int64).cpu() & 0xFFFFFFFF
        for s, b, l, w0, w1 in JAX_WORDS:
            if s == step:
                pair = (int(words[b, l, 0]), int(words[b, l, 1]))
                check(pair == (w0, w1),
                      f"generator word ({s}, {b}, {l}) {pair} is not JAX's")
    print(f"[gen] threefry2x32 on the card gives the {len(THREEFRY_KAT)} "
          f"known-answer vectors; a K={K_MAIN} chunk at B={B_MAIN} "
          f"L={L_MAIN} (steps {step0}..{step0 + K_MAIN - 1}) equals the "
          f"plain version on all {got.numel()} words; the {len(JAX_WORDS)} "
          f"committed JAX words match")
    del got
    buf = torch.empty((K_MAIN, B_MAIN, L_MAIN, 2), dtype=torch.int32,
                      device=dev)

    def kern():
        return tf.threefry_bits(key, 0, K_MAIN, shape, out=buf)

    def plain():
        return tf.threefry_bits_plain(key, 0, K_MAIN, shape, out=buf)

    p1 = timer(plain, 2)
    k1 = timer(kern, 20)
    k2 = timer(kern, 20)
    p2 = timer(plain, 2)
    k_ms, p_ms = min(k1, k2), min(p1, p2)
    n_words = 2 * K_MAIN * B_MAIN * L_MAIN
    n_bytes, n_ops = 4 * n_words + 16, GEN_OPS_PER_WORD * n_words
    bytes_ms, ops_ms, bound = _bound(n_bytes, n_ops)
    print(f"[gen] K={K_MAIN} chunk at B={B_MAIN} L={L_MAIN}: kernel "
          f"{k1:.5f} / {k2:.5f} ms, plain {p1:.4f} / {p2:.4f} ms (order "
          f"plain, kernel, kernel, plain); {n_words / (k_ms * 1e-3):.4g} "
          f"words/s")
    print(f"[gen] bound: {n_bytes} bytes -> {bytes_ms:.4g} ms, {n_ops:.4g} "
          f"operations -> {ops_ms:.4g} ms at 67 T/s; kernel at "
          f"{bound['bound_ms'] / k_ms:.3f} of the bound")
    return dict(max_abs_err=max_err, ms=k_ms, plain_ms=p_ms, **bound)


def phase_bits_kernel(torch, pm, tf, prng, ref, dev, timer=cuda_ms):
    """B3 against its plain version on generator words, then timed."""
    import numpy as np
    rng = np.random.default_rng(2)
    tau0 = torch.as_tensor(
        rng.exponential(4.0, size=(B_MAIN, L_MAIN)).astype(np.float32),
        device=dev)
    key = prng.key(7, dev)
    shape = (B_MAIN, L_MAIN)
    buf = torch.empty((K_MAIN, *shape, 2), dtype=torch.int32, device=dev)
    # (n_v, Δ, rd_mode, border_both)
    cases = [(1, 16.0, False, False), (10, 16.0, False, False),
             (10, math.inf, False, False), (10, 16.0, True, False),
             (10, 16.0, False, True)]
    max_err = 0.0
    for n_v, delta, rd_mode, border_both in cases:
        kw = dict(n_v=n_v, delta=delta, rd_mode=rd_mode,
                  border_both=border_both)
        tau, step = tau0, 0
        for k in (K_MAIN, 5):
            bits = tf.threefry_bits(key, step, k, shape, out=buf[:k])
            got = pm.pdes_multistep(tau, bits, **kw)
            max_err = max(max_err, _hold_kernel(
                torch, got, ref.pdes_multistep_ref(tau, bits, **kw),
                f"{kw} K={k}"))
            tau, step = got[0], step + k
    print(f"[b3] tau/ucount/min/max bitwise equal to the plain version over "
          f"{len(cases)} cases x chunks K={K_MAIN} and K=5 at B={B_MAIN} "
          f"L={L_MAIN}; max |err| of the sums {max_err:.3g}")

    bits = tf.threefry_bits(key, 0, K_MAIN, shape, out=buf)
    kw = dict(n_v=N_V_MAIN, delta=DELTA_SIM)

    def kern():
        return pm.pdes_multistep(tau0, bits, **kw)

    def plain():
        return ref.pdes_multistep_ref(tau0, bits, **kw)

    p1 = timer(plain, 3)
    k1 = timer(kern, 20)
    k2 = timer(kern, 20)
    p2 = timer(plain, 3)
    k_ms, p_ms = min(k1, k2), min(p1, p2)
    # the kernel alone, without the wrapper's host work, at both L
    raw = {}
    for L in (L_MAIN, L_PAPER):
        tau_l = tau0 if L == L_MAIN else torch.as_tensor(
            rng.exponential(4.0, size=(B_MAIN, L)).astype(np.float32),
            device=dev)
        bits_l = bits if L == L_MAIN else \
            tf.threefry_bits(key, 0, K_MAIN, (B_MAIN, L))
        out = torch.empty_like(tau_l)
        stats = torch.empty((6, K_MAIN, B_MAIN), device=dev)
        raw[L] = min(timer(lambda: pm.bits_launch(
            tau_l, bits_l, out, stats, rd_mode=False, border_both=False,
            **kw), 20) for _ in range(2))
    print(f"[b3] the kernel alone (raw launch): K={K_MAIN} chunk at "
          f"B={B_MAIN} L={L_MAIN} {raw[L_MAIN]:.5f} ms, L={L_PAPER} "
          f"{raw[L_PAPER]:.5f} ms")
    pe_steps = B_MAIN * L_MAIN * K_MAIN
    print(f"[b3] K={K_MAIN} chunk at B={B_MAIN} L={L_MAIN} N_V={N_V_MAIN} "
          f"delta={DELTA_SIM:g}: kernel {k1:.5f} / {k2:.5f} ms, plain "
          f"{p1:.4f} / {p2:.4f} ms (order plain, kernel, kernel, plain); "
          f"{pe_steps / (k_ms * 1e-3):.4g} PE-steps/s")
    ucount = float(kern()[1]["ucount"].sum())
    n_bytes = 8 * pe_steps + 8 * B_MAIN * L_MAIN + 4 * 6 * K_MAIN * B_MAIN
    n_ops = B3_OPS_PER_PE_STEP * pe_steps + B3_OPS_PER_UPDATE * ucount
    bytes_ms, ops_ms, bound = _bound(n_bytes, n_ops)
    print(f"[b3] bound: {n_bytes} bytes -> {bytes_ms:.4g} ms, {n_ops:.4g} "
          f"operations (utilization {ucount / pe_steps:.4f}) -> "
          f"{ops_ms:.4g} ms; kernel at {bytes_ms / k_ms:.3f} of the bytes "
          f"bound, {n_bytes / (k_ms * 1e-3) / 1e12:.3f} TB/s")
    return dict(max_abs_err=max_err, ms=k_ms, plain_ms=p_ms, **bound)


def _profile_chunks(torch, ops, state, key, cfg, dev):
    """The profiler over ``PROFILE_CHUNKS`` K-step ``simulate`` chunks."""
    n_steps = PROFILE_CHUNKS * K_MAIN
    return _profile(torch, dev, lambda: ops.simulate(state, key, cfg, n_steps,
                                                     k_fuse=K_MAIN))


class plain_simulate:
    """Within the block, ``ops.simulate`` runs the plain versions of B3 and
    of the generator on the card, with the same chunking: what the kernels
    are held against."""

    def __init__(self, ops, ref, tf):
        self.ops, self.saved = ops, (ops.pdes_multistep, ops.threefry_bits)
        self.plain = (ref.pdes_multistep_ref, tf.threefry_bits_plain)

    def __enter__(self):
        self.ops.pdes_multistep, self.ops.threefry_bits = self.plain

    def __exit__(self, *exc):
        self.ops.pdes_multistep, self.ops.threefry_bits = self.saved


def phase_threefry_path(torch, ops, pm, tf, ref, horizon, prng, ensemble,
                        dev):
    """B3's path: ``simulate``, ``horizon.run`` and the threefry ensemble."""
    cfg = horizon.PDESConfig(L=L_MAIN, n_v=N_V_MAIN, delta=DELTA_SIM)
    key = prng.key(0, dev)
    st0 = horizon.init_state(cfg, B_MAIN, dev)
    times = {}
    sync(torch, dev)
    pm.bits_launches = tf.launches = 0
    # (a) simulate with the kernels == with the plain versions, bitwise
    t0 = time.perf_counter()
    st_k, out_k = ops.simulate(st0, key, cfg, STEPS_SIM, k_fuse=K_MAIN)
    sync(torch, dev)
    times["a_kernels"] = time.perf_counter() - t0
    a_launches = (pm.bits_launches, tf.launches)
    check(a_launches == (STEPS_SIM // K_MAIN,) * 2,
          f"simulate launched B3 and the generator {a_launches} times")
    with plain_simulate(ops, ref, tf):
        t0 = time.perf_counter()
        st_p, out_p = ops.simulate(st0, key, cfg, STEPS_SIM, k_fuse=K_MAIN)
        sync(torch, dev)
        times["a_plain"] = time.perf_counter() - t0
    check((pm.bits_launches, tf.launches) == a_launches,
          "the plain simulate launched a kernel")
    for f in ("tau", "offset", "offset_comp"):
        check(torch.equal(getattr(st_k, f), getattr(st_p, f)),
              f"simulate {f} differs from the plain versions")
    for name in ("u", "gvt"):
        check(torch.equal(out_k[name], out_p[name]),
              f"simulate {name} differs from the plain versions")
    check(torch.allclose(out_k["w2"], out_p["w2"], rtol=SUM_RTOL,
                         atol=SUM_ATOL), "simulate w2 beyond tolerance")
    u_last = float(out_k["u"][-K_MAIN:].mean())
    check(0.0 < u_last <= 1.0, u_last)
    pe_steps = STEPS_SIM * B_MAIN * L_MAIN
    print(f"[path a] simulate {STEPS_SIM} steps at B={B_MAIN} L={L_MAIN} "
          f"N_V={N_V_MAIN} delta={DELTA_SIM:g}: kernels "
          f"{times['a_kernels']:.3f} s ({times['a_kernels'] * 1e3 * K_MAIN / STEPS_SIM:.4f} "
          f"ms a chunk, {pe_steps / times['a_kernels']:.4g} PE-steps/s), "
          f"plain {times['a_plain']:.3f} s; tau, offsets, u and gvt "
          f"bitwise equal, w2 to tolerance; u over the last chunk "
          f"{u_last:.6f}; launches B3 {a_launches[0]}, generator "
          f"{a_launches[1]}")

    # (b) simulate against horizon.run: the JAX test's shape and bounds ...
    small = horizon.PDESConfig(L=64, n_v=4, delta=8.0)
    for n_steps, k_fuse in ((5, 8), (16, 8), (37, 8), (24, 6)):
        s0 = horizon.init_state(small, 8, dev)
        sa, stats_a = horizon.run(s0, prng.key(3, dev), small, n_steps)
        sb, out_b = ops.simulate(s0, prng.key(3, dev), small, n_steps,
                                 k_fuse=k_fuse)
        check(torch.allclose(stats_a.utilization, out_b["u"], rtol=1e-6,
                             atol=0), f"u: simulate != run ({n_steps})")
        check(torch.allclose(stats_a.w2, out_b["w2"], rtol=1e-4, atol=1e-4),
              f"w2: simulate != run ({n_steps})")
        check(torch.allclose(sa.tau + sa.offset[:, None],
                             sb.tau + sb.offset[:, None], rtol=1e-5,
                             atol=1e-4), f"tau: simulate != run ({n_steps})")
    # ... and at full width from (a)'s burned state: reported, not bitwise
    sync(torch, dev)
    t0 = time.perf_counter()
    sr, stats_r = horizon.run(st_k, key, cfg, STEPS_CMP)
    sync(torch, dev)
    times["b_run"] = time.perf_counter() - t0
    ss, out_s = ops.simulate(st_k, key, cfg, STEPS_CMP, k_fuse=K_MAIN)
    du = (stats_r.utilization.mean(1) - out_s["u"].mean(1)).abs().max()
    du = float(du)
    check(du <= 1e-4, f"ensemble-mean u per step differs by {du}")
    abs_r = sr.tau.double() + sr.offset.double()[:, None]
    abs_s = ss.tau.double() + ss.offset.double()[:, None]
    outside = float(((abs_r - abs_s).abs() > 1e-5 * abs_s.abs()).double()
                    .mean())
    spread = (stats_r.max_dev + stats_r.min_dev).max()
    check(float(spread) <= DELTA_SIM + ETA_MAX, f"spread {float(spread)}")
    print(f"[path b] simulate == horizon.run at L=64 N_V=4 delta=8 B=8 for "
          f"(n_steps, k_fuse) in (5, 8), (16, 8), (37, 8), (24, 6) to the "
          f"JAX test's bounds; at full width over {STEPS_CMP} steps after "
          f"{STEPS_SIM}: max |ensemble-mean u per step| difference {du:.3g}, "
          f"share of PEs outside rtol 1e-5 {outside:.6g}; horizon.run "
          f"{times['b_run'] * 1e3 / STEPS_CMP:.4f} ms a step; largest spread "
          f"{float(spread):.5g} <= delta + 17.4")

    # (c) the threefry ensemble (backend=None) against pallas_multistep
    common = dict(n_trials=B_MAIN, seed=0, burn_in_steps=BURN_THREEFRY,
                  measure_steps=STEPS_THREEFRY, device=dev)
    steps = BURN_THREEFRY + STEPS_THREEFRY
    sync(torch, dev)
    pm.bits_launches = tf.launches = 0
    t0 = time.perf_counter()
    tfry = ensemble.steady_state(cfg, backend=None, **common)
    sync(torch, dev)
    times["c_threefry"] = time.perf_counter() - t0
    c_launches = (pm.bits_launches, tf.launches)
    check(c_launches == (0, steps), f"steady_state(backend=None) launched "
                                    f"B3 and the generator {c_launches} "
                                    f"times, not (0, {steps})")
    t0 = time.perf_counter()
    ctr = ensemble.steady_state(cfg, backend="pallas_multistep",
                                engine_opts={"k_fuse": K_MAIN}, **common)
    sync(torch, dev)
    times["c_counter"] = time.perf_counter() - t0
    for rec in (tfry, ctr):
        check(0.0 < rec.utilization <= 1.0, rec)
        check(math.isfinite(rec.w2) and math.isfinite(rec.rate), rec)
    tol = max(0.01, 6 * math.hypot(tfry.utilization_err,
                                   ctr.utilization_err))
    diff = abs(tfry.utilization - ctr.utilization)
    check(diff <= tol, f"threefry u {tfry.utilization} vs counter u "
                       f"{ctr.utilization}: {diff} > {tol}")
    print(f"[path c] steady_state at B={B_MAIN} L={L_MAIN} N_V={N_V_MAIN} "
          f"delta={DELTA_SIM:g}, burn {BURN_THREEFRY} + measure "
          f"{STEPS_THREEFRY} (default_burn_in {ensemble.default_burn_in(cfg)}"
          f"): threefry u={tfry.utilization:.6f}+-"
          f"{tfry.utilization_err:.2g} w={tfry.w:.5g} "
          f"rate={tfry.rate:.6f} in {times['c_threefry']:.3f} s "
          f"({times['c_threefry'] * 1e3 / steps:.4f} ms a step); counter "
          f"stream (pallas_multistep) u={ctr.utilization:.6f}+-"
          f"{ctr.utilization_err:.2g} w={ctr.w:.5g} rate={ctr.rate:.6f} in "
          f"{times['c_counter']:.3f} s; |du| {diff:.3g} <= {tol:.3g}; "
          f"generator launches {c_launches[1]}, one a step")
    print(f"[path] launches on the simulate path (a): B3 {a_launches[0]}, "
          f"generator {a_launches[1]}; wall "
          + ", ".join(f"{k} {v:.3f} s" for k, v in times.items()))
    prof = _profile_chunks(torch, ops, st_k, key, cfg, dev)
    if prof is None:
        print("[path] torch.profiler gave no device time: idle share "
              "not measured")
    else:
        print(f"[path] profiler, {PROFILE_CHUNKS} {K_MAIN}-step simulate "
              f"chunks at B={B_MAIN}: wall {prof['wall_us'] / 1e3:.3f} ms, "
              f"device busy {prof['busy_us'] / 1e3:.3f} ms (idle share "
              f"{1 - prof['busy_us'] / prof['wall_us']:.3f})")
        for us, name, count in prof["rows"][:8]:
            print(f"[path] profiler {us / 1e3:9.3f} ms {count:6d}x  "
                  f"{name[:90]}")
    return a_launches


def phase_sharded(torch, ps, engine_mod, D, mesh_mod, sweep, api, dev):
    """The sharded backend on the card: one rank of a process group of
    one (NCCL on the card), B2 as each shard's step.  Returns B2's
    launches on the sharded service drain."""
    import datetime
    import torch.distributed as dist
    backend = "nccl" if torch.device(dev).type == "cuda" else "gloo"
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    try:
        mesh = mesh_mod.make_mesh((1, 1), ("data", "model"), device=dev)
        print(f"[sharded] {backend} process group of one rank, {mesh}")
        return _sharded_runs(torch, ps, engine_mod, D, mesh, sweep, api, dev)
    finally:
        dist.destroy_process_group()


def _sharded_runs(torch, ps, engine_mod, D, mesh, sweep, api, dev):
    cfg = engine_mod.PDESConfig(L=L_MAIN, n_v=N_V_MAIN, delta=DELTA_SHARDED)
    z = torch.zeros(B_MAIN, device=dev)
    tau0 = torch.zeros((B_MAIN, L_MAIN), device=dev)
    phase_launches = 0
    # (a) exact and (b) commavoid against the engines with their rebase
    # schedule (bitwise), and against the unsharded oracle, which never
    # rebases, so its times round differently after the first chunk
    for part, mode, window, backend in (("a", "exact", "exact",
                                         "pallas_multistep"),
                                        ("b", "commavoid", "stale",
                                         "pallas")):
        dc = D.DistConfig(mode=mode, k_chunk=K_MAIN)
        sync(torch, dev)
        ps.launches = 0
        t0 = time.perf_counter()
        tau, off, comp, st = D.run_sharded_state(
            cfg, mesh, n_steps=STEPS_SHARDED, seed=0, dist=dc, tau0=tau0,
            off0=z, comp0=z)
        sync(torch, dev)
        wall = time.perf_counter() - t0
        launches = ps.launches
        phase_launches += launches
        per_step = 1 if mode == "exact" else 3
        check(launches == per_step * STEPS_SHARDED,
              f"sharded {mode} launched B2 {launches} times")
        eng = engine_mod.PDESEngine(cfg, backend=backend, window=window,
                                    k_fuse=K_MAIN, device=dev)
        s_e, st_e = eng.run(eng.init(B_MAIN), 0, STEPS_SHARDED)
        for name, a, b in (("tau", tau, s_e.tau), ("offset", off, s_e.offset),
                           ("offset_comp", comp, s_e.offset_comp),
                           ("u", st["u"], st_e.utilization),
                           ("gvt", st["gvt"], st_e.gvt)):
            check(torch.equal(a, b),
                  f"sharded {mode} {name} differs from {backend}")
        for name in ("w2", "mean_tau", "max_dev", "min_dev"):
            check(torch.allclose(st[name], getattr(st_e, name),
                                 rtol=SUM_RTOL, atol=SUM_ATOL),
                  f"sharded {mode} {name} beyond tolerance of {backend}")
        tau_r, st_r = D.run_reference(
            cfg, n_trials=B_MAIN, n_steps=STEPS_SHARDED, seed=0,
            stale_every=None if mode == "exact" else K_MAIN, device=dev)
        u_s, u_r = st["u"].mean(0), st_r["u"].mean(0)   # per-row time means
        du = abs(float(u_s.mean() - u_r.mean()))
        tol = max(0.01, 6 * math.hypot(float(u_s.std()), float(u_r.std()))
                  / math.sqrt(B_MAIN))
        check(du <= tol, f"sharded {mode} u differs from run_reference by "
                         f"{du} > {tol}")
        same = float((tau + off[:, None] == tau_r).double().mean())
        spread = float((st["max_dev"] + st["min_dev"]).max())
        check(spread <= DELTA_SHARDED + ETA_MAX, f"spread {spread}")
        print(f"[sharded {part}] {mode}: {STEPS_SHARDED} steps at B={B_MAIN}"
              f" L={L_MAIN} N_V={N_V_MAIN} delta={DELTA_SHARDED:g} in "
              f"{wall:.3f} s, {launches} B2 launches; tau, offsets, u and gvt"
              f" bitwise equal to the {backend} engine ({window} window), "
              f"w2/mean/max_dev/min_dev to tolerance; against run_reference "
              f"(no rebase): mean u {float(u_s.mean()):.6f} vs "
              f"{float(u_r.mean()):.6f}, |du| {du:.3g} <= {tol:.3g}, share of"
              f" tau bitwise equal {same:.4f}; largest spread {spread:.5g}")
    # the JAX test's shape against the oracle, to its tolerances
    for delta, n_v, mode, k in ((5.0, 1, "exact", 8), (math.inf, 1, "exact",
                                                      8),
                                (5.0, 10, "commavoid", 4),
                                (10.0, 3, "commavoid", 8)):
        small = engine_mod.PDESConfig(L=32, n_v=n_v, delta=delta)
        t_s, s_s = D.run_sharded(small, mesh, n_trials=6, n_steps=24, seed=7,
                                 dist=D.DistConfig(mode=mode, k_chunk=k))
        t_r, s_r = D.run_reference(small, n_trials=6, n_steps=24, seed=7,
                                   stale_every=None if mode == "exact"
                                   else k, device=dev)
        e_tau = float((t_s - t_r).abs().max())
        e_u = float((s_s["u"] - s_r["u"]).abs().max())
        check(e_tau < 1e-4 and e_u < 1e-6,
              f"{mode} delta={delta} n_v={n_v}: tau {e_tau}, u {e_u}")
    print("[sharded] run_sharded == run_reference at L=32, 6 trials, 24 "
          "steps (tests/test_distributed_pdes.py's cases and bounds)")

    # (c) the service drain of phase 3's requests on the sharded backend
    common = dict(Ls=(L_MAIN,), n_vs=(N_V_MAIN,), replicas=REPLICAS,
                  n_steps=STEPS_SLICE, burn_in=BURN_SLICE, backend="sharded",
                  k_fuse=K_MAIN, seed=0)
    specs = {
        "alice": sweep.WindowSweep(deltas=(1.0, 4.0, 16.0, 64.0), **common),
        "bob": sweep.WindowSweep(deltas=(4.0, 16.0, math.inf), **common),
        "carol": sweep.WindowSweep(deltas=(1.0, 4.0, 16.0, 64.0), **common),
    }
    svc = api.SweepService(mesh=mesh)
    for who, spec in specs.items():
        svc.submit(spec, requester=who)
    sync(torch, dev)
    ps.launches = 0
    t0 = time.perf_counter()
    responses = svc.drain()
    sync(torch, dev)
    wall = drain_wall = time.perf_counter() - t0
    drain_launches = ps.launches
    phase_launches += drain_launches
    st = svc.stats
    for resp in responses:
        check(resp.error is None, (resp.requester, resp.error))
    check(drain_launches > 0, "the sharded drain launched no B2")
    check(st.n_deduped == 1 and st.n_passes == 1, st)
    check(st.rows_computed == B_MAIN, st)
    pe_steps = st.engine_row_steps * L_MAIN
    print(f"[sharded c] drain of {len(responses)} requests: {wall:.3f} s "
          f"wall, {st.n_passes} coalesced pass, {st.rows_computed} rows, "
          f"{pe_steps:.4g} PE-steps, {pe_steps / wall:.4g} PE-steps/s, "
          f"{drain_launches} B2 launches")
    direct, fused = {}, {}
    t0 = time.perf_counter()
    for resp in responses:
        spec = resp.spec
        if spec not in direct:
            direct[spec] = sweep.run_window_sweep(spec, mesh=mesh)
            fused[spec] = sweep.run_window_sweep(
                sweep.WindowSweep(**{**common, "deltas": spec.deltas,
                                     "backend": "pallas_multistep"}),
                device=dev)
        # JSON spells the NaN wa of the sharded backend alike on both sides
        check(json.dumps(resp.result.as_dict())
              == json.dumps(direct[spec].as_dict()),
              f"{resp.requester}: response differs from a direct run")
        for rec, ref in zip(resp.result.records, fused[spec].records):
            check((rec.u, rec.u_err, rec.rate, rec.rate_err)
                  == (ref.u, ref.u_err, ref.rate, ref.rate_err),
                  f"{resp.requester}: {rec} vs pallas_multistep {ref}")
            check(math.isclose(rec.w2, ref.w2, rel_tol=SUM_RTOL),
                  f"{resp.requester}: w2 {rec.w2} vs {ref.w2}")
            check(0.0 < rec.u <= 1.0, rec)
            check(math.isfinite(rec.w2) and math.isfinite(rec.rate), rec)
            if math.isfinite(rec.delta):
                check(rec.spread <= rec.delta + ETA_MAX, rec)
            print(f"[sharded c] {resp.requester:5s} delta={rec.delta:<5g} "
                  f"u={rec.u:.6f}+-{rec.u_err:.2g} w2={rec.w2:.5g} "
                  f"spread={rec.spread:.5g} rate={rec.rate:.6f}")
    sync(torch, dev)
    print(f"[sharded c] every response equals a direct run_window_sweep("
          f"mesh=) bit for bit; u, u_err, rate, rate_err equal to "
          f"pallas_multistep at the same depth, w2 within {SUM_RTOL:g}; "
          f"u in (0, 1]; spread <= delta + 17.4 (direct runs "
          f"{time.perf_counter() - t0:.3f} s)")

    # (d) wall per chunk, beside the pallas backend's, and a profile
    n_steps = TIMED_CHUNKS * K_MAIN
    walls = {}
    runs = {
        "sharded exact": lambda: D.run_sharded_state(
            cfg, mesh, n_steps=n_steps, seed=0, tau0=tau0, off0=z, comp0=z,
            dist=D.DistConfig(mode="exact", k_chunk=K_MAIN)),
        "sharded commavoid": lambda: D.run_sharded_state(
            cfg, mesh, n_steps=n_steps, seed=0, tau0=tau0, off0=z, comp0=z,
            dist=D.DistConfig(mode="commavoid", k_chunk=K_MAIN))}
    for window in ("exact", "stale"):
        eng = engine_mod.PDESEngine(cfg, backend="pallas", window=window,
                                    k_fuse=K_MAIN, device=dev)
        runs[f"pallas {window}"] = (
            lambda eng=eng: eng.run(eng.init(B_MAIN), 0, n_steps))
    for fn in runs.values():
        fn()
    for r in range(TIMED_ROUNDS):             # in turns, the order flipped
        for name in (list(runs) if r % 2 == 0 else list(runs)[::-1]):
            sync(torch, dev)
            t0 = time.perf_counter()
            runs[name]()
            sync(torch, dev)
            walls.setdefault(name, []).append(
                (time.perf_counter() - t0) * 1e3 / TIMED_CHUNKS)
    med = {k: sorted(v)[len(v) // 2] for k, v in walls.items()}
    for name, v in walls.items():
        print(f"[sharded d] wall per {K_MAIN}-step chunk at B={B_MAIN} "
              f"L={L_MAIN}, {name}: median {med[name]:.3f} ms of "
              f"{TIMED_ROUNDS} calls of {TIMED_CHUNKS} chunks ("
              + ", ".join(f"{x:.3f}" for x in v) + ")")
    print(f"[sharded d] medians: sharded exact / pallas exact "
          f"{med['sharded exact'] / med['pallas exact']:.3f}, sharded "
          f"commavoid / pallas stale "
          f"{med['sharded commavoid'] / med['pallas stale']:.3f}")
    print(f"[sharded] B2 launches in the phase (sharded runs a, b, c): "
          f"{phase_launches}")
    one = D.DistConfig(mode="exact", k_chunk=K_MAIN)
    prof = _profile(torch, dev, lambda: D.run_sharded_state(
        cfg, mesh, n_steps=K_MAIN, seed=0, dist=one, tau0=tau0, off0=z,
        comp0=z))
    if prof is None:
        print("[sharded] torch.profiler gave no device time: idle share "
              "not measured")
    else:
        nccl_us = sum(us for us, key, _ in prof["rows"]
                      if "nccl" in key.lower())
        print(f"[sharded] profiler, one {K_MAIN}-step exact chunk at "
              f"B={B_MAIN}: wall {prof['wall_us'] / 1e3:.3f} ms, device busy "
              f"{prof['busy_us'] / 1e3:.3f} ms (idle share "
              f"{1 - prof['busy_us'] / prof['wall_us']:.3f}); NCCL kernels "
              f"{nccl_us / 1e3:.4f} ms of device time "
              f"({nccl_us / prof['busy_us']:.4f} of busy), c10d operators "
              f"{prof['comm_host_us'] / 1e3:.3f} ms of host time "
              f"({prof['comm_host_us'] / prof['wall_us']:.4f} of wall)")
        for us, key, count in prof["rows"][:10]:
            print(f"[sharded] profiler {us / 1e3:9.3f} ms {count:6d}x  "
                  f"{key[:90]}")
    return drain_launches, {
        "wall": drain_wall,
        "results": {resp.requester: json.dumps(resp.result.as_dict())
                    for resp in responses}}


def _write_queue(path, wire, specs) -> None:
    path.write_text("".join(json.dumps(wire.encode_request(spec, who)) + "\n"
                            for who, spec in specs.items()))


def _lines(path) -> dict:
    """Response lines of a JSONL file by requester (errors fail)."""
    out = {}
    for line in path.read_text().strip().splitlines():
        obj = json.loads(line)
        check("error" not in obj, obj)
        out[obj["requester"]] = obj
    return out


def _run(cmd, env, what, ok=(0,)):
    proc = subprocess.run(cmd, env=env, cwd=env["ROOT"], capture_output=True,
                          text=True, timeout=SUBPROCESS_S)
    check(proc.returncode in ok, f"{what} exited {proc.returncode}:\n"
          f"{proc.stderr[-3000:]}")
    return proc


def _series(metrics_dir) -> dict:
    snap = json.loads((metrics_dir / "metrics.json").read_text())
    return {s["name"]: s for s in snap["series"] if not s["labels"]}


def phase_service(torch, pm, ps, sweep, wire, daemon, api, trace, dev, root,
                  sharded):
    """The serve daemon, telemetry and ``--mesh`` on the card.

    ``sharded`` is phase 9's: its service drain's wall and results.
    Returns B1's launches on the reference drain (a) and B2's in the
    ``--mesh`` CLI drain (d).
    """
    common = dict(Ls=(L_MAIN,), n_vs=(N_V_MAIN,), replicas=REPLICAS,
                  n_steps=STEPS_MAIN, burn_in=BURN_MAIN,
                  backend="pallas_multistep", k_fuse=K_MAIN, seed=0)
    alice = sweep.WindowSweep(deltas=(1.0, 4.0, 16.0, 64.0), **common)
    q1 = {"alice": alice,
          "bob": sweep.WindowSweep(deltas=(4.0, 16.0, math.inf), **common),
          "carol": alice}
    q2 = {"dave": dataclasses.replace(alice, n_steps=STEPS_DAVE)}
    specs = {**q1, **q2}
    work = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_serve_"))
    env = dict(os.environ, PYTHONPATH=str(root / "src"), ROOT=str(root))
    env.pop("RANK", None)
    on_cpu = torch.device(dev).type == "cpu"
    device_args = ["--device", "cpu"] if on_cpu else []

    def intake(name):
        d = work / name / "intake"
        d.mkdir(parents=True)
        _write_queue(d / "q1.jsonl", wire, q1)
        _write_queue(d / "q2.jsonl", wire, q2)
        return d

    def serve(name, telemetry):
        """An in-process daemon over both files; (wall, stats, lines)."""
        d = intake(name)
        cfg = daemon.DaemonConfig(
            intake_dir=str(d), out_path=str(d.parent / "responses.jsonl"),
            poll_interval_s=0.01, idle_exit_rounds=1, max_files_per_round=1,
            metrics_dir=str(d.parent / "metrics") if telemetry else None,
            trace_path=str(d.parent / "trace.json") if telemetry else None)
        log = []
        sync(torch, dev)
        t0 = time.perf_counter()
        stats = daemon.serve_daemon(cfg, service=api.SweepService(device=dev),
                                    log=log.append)
        sync(torch, dev)
        wall = time.perf_counter() - t0
        check(sorted(os.listdir(d)) == ["q1.jsonl.done", "q2.jsonl.done"],
              os.listdir(d))
        return wall, stats, _lines(d.parent / "responses.jsonl"), log

    try:
        # (a) the reference drain, telemetry off, B1's launches read
        pm.launches = 0
        wall_a, st, ref, log = serve("a", telemetry=False)
        b1_launches = pm.launches
        check(b1_launches > 0, "the daemon's drain launched no B1")
        check(set(ref) == set(specs), sorted(ref))
        check(st.n_passes == 2 and st.n_deduped == 1, st)
        check(st.rows_from_state_cache == 4 * REPLICAS, st)
        check(st.rows_burned == B_MAIN, st)
        for line in log:
            print(f"[serve a] {line}")
        direct = {}
        for who, spec in specs.items():
            if spec not in direct:
                direct[spec] = json.dumps(
                    sweep.run_window_sweep(spec, device=dev).as_dict())
            check(json.dumps(ref[who]["result"]) == direct[spec],
                  f"{who}: daemon response differs from a direct run")
            for rec in ref[who]["result"]["records"]:
                check(0.0 < rec["u"] <= 1.0, rec)
        print(f"[serve a] in-process daemon, 2 intake files one a round: "
              f"{wall_a:.3f} s wall, {st.n_passes} passes ({st.rows_burned}"
              f" rows burned, {st.rows_from_state_cache} from the state "
              f"cache), {b1_launches} B1 launches; every response equals a "
              f"direct run_window_sweep bit for bit")

        # (b) crash after the first pass, restart from the state cache
        d = intake("b")
        out, cache = d.parent / "responses.jsonl", d.parent / "cache.npz"
        mdir, tpath = d.parent / "metrics", d.parent / "trace.json"
        args = ["serve", "--intake", str(d), "--out", str(out),
                "--state-cache", str(cache), "--metrics-dir", str(mdir),
                "--trace", str(tpath), "--max-files-per-round", "1",
                "--poll", "0.05", *device_args]
        t0 = time.perf_counter()
        crash = _run([sys.executable, "-m", "repro_torch.service", *args,
                      "--crash-after-passes", "1"], env, "the crash run",
                     ok=(70,))
        wall_crash = time.perf_counter() - t0
        check("fault injection" in crash.stderr, crash.stderr[-2000:])
        check(sorted(os.listdir(d)) == ["q1.jsonl.done", "q2.jsonl"],
              os.listdir(d))
        check(len(_lines(out)) == 3 and cache.exists() and tpath.exists(),
              "the crash run left no responses, cache or trace")
        stamps_path = work / "stamps.json"
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-c", RESTART, *args, "--idle-exit-rounds", "1"],
            env=dict(env, STAMPS=str(stamps_path), DEVICE=dev), cwd=root,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        try:
            while len(out.read_text().splitlines()) < 4:
                check(proc.poll() is None, "the restart exited before dave")
                check(time.perf_counter() - t0 < SUBPROCESS_S,
                      "the restart never answered dave")
                time.sleep(0.002)
            t_dave = time.perf_counter()
            _, err = proc.communicate(timeout=SUBPROCESS_S)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        check(proc.returncode == 0, f"the restart exited {proc.returncode}:"
              f"\n{err[-3000:]}")
        check(f"restored {B_MAIN} burned row(s)" in err, err[-2000:])
        check(f"{4 * REPLICAS} rows from state cache" in err, err[-2000:])
        got = _lines(out)
        check(got == ref, "crash and restart (telemetry on) differ from the "
                          "uninterrupted drain (telemetry off)")
        series = _series(mdir)
        check(series["repro_service_rows_burned"]["value"] == 0, series)
        check(series["repro_service_rows_from_state_cache"]["value"]
              == 4 * REPLICAS, series)
        stamps = json.loads(stamps_path.read_text())
        events = json.loads(tpath.read_text())["traceEvents"]
        (dave_pass,) = [e for e in events if e["name"] == "pass"]
        check(dave_pass["args"]["rows_from_cache"] == 4 * REPLICAS
              and dave_pass["args"]["rows_burned"] == 0, dave_pass)
        split = {
            "process start, torch import, CUDA init": stamps["cuda"] - t0,
            "library load": stamps["library"] - stamps["cuda"],
            "cache load": stamps["cache"][1] - stamps["cache"][0],
            "dave's pass": dave_pass["dur"] / 1e6}
        recover = t_dave - t0
        split["the rest"] = recover - sum(split.values())
        print(f"[serve b] crash run (pass 1, then os._exit(70)) "
              f"{wall_crash:.3f} s; restart restored {B_MAIN} rows, dave's "
              f"{4 * REPLICAS} rows all from the state cache, 0 burned "
              f"(metrics snapshot); responses equal (a)'s bit for bit")
        print(f"[serve b] time to recover, process start to dave's response "
              f"on disk: {recover:.3f} s = "
              + ", ".join(f"{k} {v:.3f} s" for k, v in split.items()))

        # (c) the summaries of (b)'s files
        summ = _run([sys.executable, "-m", "repro_torch.obs", "summarize",
                     "--check", str(mdir), str(tpath)], env, "summarize")
        check(summ.stdout.count("check ok") == 2, summ.stdout[-2000:])
        for name in ("repro_pass_u", "repro_pass_w2", "repro_pass_gvt_rate",
                     "repro_pass_window_occupancy"):
            check(series[name]["count"] >= 1, f"{name} never observed")
        print("[serve c] summarize --check: metrics and trace ok; <u>, "
              "<w2>, GVT rate and window occupancy observed")

        # (d) --mesh data=1,model=1: phase 9(c)'s requests through the CLI
        mcommon = dict(common, n_steps=STEPS_SLICE, burn_in=BURN_SLICE,
                       backend="sharded")
        mspecs = {
            "alice": sweep.WindowSweep(deltas=(1.0, 4.0, 16.0, 64.0),
                                       **mcommon),
            "bob": sweep.WindowSweep(deltas=(4.0, 16.0, math.inf), **mcommon),
            "carol": sweep.WindowSweep(deltas=(1.0, 4.0, 16.0, 64.0),
                                       **mcommon)}
        # alice's and bob's specs at seed 1: a second pass of the same
        # shapes in the same rank, to part a fresh process's first-use cost
        # from the pass itself
        warm = {"erin": dataclasses.replace(mspecs["alice"], seed=1),
                "frank": dataclasses.replace(mspecs["bob"], seed=1)}
        queue = work / "mesh.jsonl"
        _write_queue(queue, wire, {**mspecs, **warm})
        counts = work / "counts"
        counts.mkdir()
        mout, mmet, mtr = (work / "mesh_out.jsonl", work / "mesh_metrics",
                           work / "mesh_trace.json")
        t0 = time.perf_counter()
        _run([sys.executable, "-c", COUNTED, str(queue), "--mesh",
              "data=1,model=1", "--out", str(mout), "--metrics-dir",
              str(mmet), "--trace", str(mtr), *device_args],
             dict(env, COUNTS=str(counts)), "the --mesh drain")
        wall_mesh = time.perf_counter() - t0
        b2_launches = int((counts / "rank0").read_text())
        check(sorted(p.name for p in counts.iterdir()) == ["rank0"],
              "one rank")
        check(b2_launches > 0, "the --mesh drain launched no B2")
        mgot = _lines(mout)
        check(set(mgot) == set(mspecs) | set(warm), sorted(mgot))
        for who in mspecs:
            check(json.dumps(mgot[who]["result"])
                  == sharded["results"][who],
                  f"{who}: --mesh response differs from phase 9(c)'s")
        for who in warm:
            for rec in mgot[who]["result"]["records"]:
                check(0.0 < rec["u"] <= 1.0, rec)
                check(rec["delta"] == "inf"
                      or rec["spread"] <= rec["delta"] + ETA_MAX, rec)
        passes = [e for e in json.loads(mtr.read_text())["traceEvents"]
                  if e["name"] == "pass"]
        check([e["args"]["seed"] for e in passes] == [0, 1], passes)
        cold, hot = (e["dur"] / 1e6 for e in passes)
        _run([sys.executable, "-m", "repro_torch.obs", "summarize",
              "--check", str(mmet), str(mtr)], env, "summarize (mesh)")
        print(f"[serve d] python -m repro_torch.service --mesh "
              f"data=1,model=1: {wall_mesh:.3f} s wall (launcher and one "
              f"rank, imports and process group included); its seed-0 pass "
              f"(phase 9(c)'s requests, the rank's first) {cold:.3f} s, the "
              f"seed-1 pass of the same shapes {hot:.3f} s; phase 9(c)'s "
              f"in-process drain {sharded['wall']:.3f} s; {b2_launches} B2 "
              f"launches; every seed-0 response equals phase 9(c)'s bit for "
              f"bit")
        if not on_cpu:
            n = torch.cuda.device_count()
            big = _run([sys.executable, "-m", "repro_torch.service",
                        str(queue), "--mesh", f"data={n + 1},model=1"], env,
                       "the oversized mesh", ok=(2,))
            check(f"needs {n + 1} GPU(s)" in big.stderr
                  and "does not fall back" in big.stderr, big.stderr)
            print(f"[serve d] --mesh data={n + 1},model=1 on {n} GPU(s): "
                  f"exit 2, {big.stderr.strip().splitlines()[-1]}")

        # (e) telemetry on against off, in turns
        walls, writes = {"off": [], "on": []}, []
        # the snapshot and trace writes (tmp, fsync, rename) timed apart
        write_snapshot, save = daemon.write_snapshot, trace.TraceRecorder.save

        def timed(fn):
            def run(*a, **k):
                t = time.perf_counter()
                try:
                    return fn(*a, **k)
                finally:
                    writes[-1] += time.perf_counter() - t
            return run

        daemon.write_snapshot = timed(write_snapshot)
        trace.TraceRecorder.save = timed(save)
        try:
            for r in range(SERVE_ROUNDS):
                for mode in (("off", "on") if r % 2 == 0 else ("on", "off")):
                    writes.append(0.0)
                    wall, _, lines, _ = serve(f"e{r}{mode}", mode == "on")
                    check(lines == ref, f"telemetry {mode}: responses differ")
                    walls[mode].append(wall)
        finally:
            daemon.write_snapshot, trace.TraceRecorder.save = \
                write_snapshot, save
        writes = [w for w in writes if w]
        med = {k: sorted(v)[len(v) // 2] for k, v in walls.items()}
        for mode, v in walls.items():
            print(f"[serve e] in-process daemon drain, telemetry {mode}: "
                  f"median {med[mode]:.4f} s of {SERVE_ROUNDS} ("
                  + ", ".join(f"{x:.4f}" for x in v) + ")")
        check(len(writes) == SERVE_ROUNDS, writes)
        print(f"[serve e] telemetry on / off: {med['on'] / med['off']:.4f}; "
              f"of each drain with telemetry on, the 3 metrics snapshots and "
              f"the trace save (tmp, fsync, rename) took median "
              f"{sorted(writes)[len(writes) // 2] * 1e3:.2f} ms ("
              + ", ".join(f"{w * 1e3:.2f}" for w in writes)
              + "); responses bitwise equal in every drain")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return b1_launches, b2_launches


def _lm_requests(serve, vocab, n, prompt, new, seed=0, lengths=None):
    """``n`` requests from ``default_rng(seed)``: prompt length (uniform on
    ``prompt``, or one of ``lengths``), prompt tokens and new tokens drawn
    in turn for each."""
    import numpy as np
    rng = np.random.default_rng(seed)
    reqs = []
    for uid in range(n):
        length = int(rng.integers(prompt[0], prompt[1] + 1) if lengths is None
                     else rng.choice(lengths))
        reqs.append(serve.Request(
            uid, rng.integers(0, vocab, length).astype(np.int32),
            int(rng.integers(new[0], new[1] + 1))))
    return reqs


def _timed_calls(torch, model, name, store):
    """Record a CUDA event pair and the host clock around every call of
    ``model.<name>`` (an instance attribute over the method; ``del`` it to
    restore)."""
    fn = getattr(model, name)

    def run(*args, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        out = fn(*args, **kw)
        end.record()
        store.append((start, end, t0, args))
        return out
    setattr(model, name, run)


def _lm_bounds(cfg, B, S):
    """Least ms of a decode step (the bf16 weights read once) and of a
    prefill of B x S tokens (2 FLOP a parameter a token for the layers, the
    output table for the last token only, causal attention's half of the
    QK and PV products), at the H100's published rates."""
    n = cfg.n_params()
    decode_ms = n * 2 / HBM_BYTES_PER_S * 1e3
    table = cfg.vocab_size * cfg.d_model
    layers = n - table
    attn = 2 * B * S * S * cfg.n_heads * cfg.head_dim * cfg.n_layers
    flops = 2 * layers * B * S + 2 * table * B + attn
    return decode_ms, flops / BF16_FLOPS_PER_S * 1e3


def _ssm_bounds(cfg, n_params, B, S):
    """``_lm_bounds`` of the ssm and hybrid families over ``n_params``
    weights: decode also reads and writes the fp32 SSM state and reads the
    shared block's K/V (S slots); prefill adds the chunked scan's causal
    half of the intra-chunk products and its two state products. Returns
    (decode ms, prefill ms, decode bytes)."""
    s = cfg.ssm
    Q = min(s.chunk, S)
    n_shared = cfg.n_layers // cfg.hybrid_period if cfg.hybrid_period else 0
    table = cfg.vocab_size * cfg.d_model
    state = cfg.n_layers * B * s.n_heads * s.head_dim * s.d_state * 4
    kv = n_shared * B * S * cfg.n_kv_heads * cfg.head_dim * 2 * 2
    n_bytes = n_params * 2 + 2 * state + kv
    scan = cfg.n_layers * B * S * (Q * s.d_state + Q * s.d_inner
                                   + 4 * s.d_inner * s.d_state)
    attn = n_shared * 2 * B * S * S * cfg.n_heads * cfg.head_dim
    flops = 2 * (n_params - table) * B * S + 2 * table * B + scan + attn
    return (n_bytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS_PER_S * 1e3,
            n_bytes)


def phase_lm_serve(torch, configs, models, serve, theory, dev, arch=LM_ARCH,
                   tag="lm", lengths=None):
    """Phase 11(a), and 12(a, b): ``arch`` served at full width on the
    card through ``ServeEngine``; prompt lengths uniform on ``LM_PROMPT``
    or drawn from ``lengths``."""
    import numpy as np
    cfg = configs.get_config(arch)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = models.build_model(cfg, device=dev, seed=0)
    model.compute_params()
    sync(torch, dev)
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    if cfg.ssm is None:
        widths = (f"{cfg.n_heads} heads / {cfg.n_kv_heads} kv, hd "
                  f"{cfg.head_dim}, d_ff {cfg.d_ff}")

        def bounds(B, S):
            return (*_lm_bounds(cfg, B, S), cfg.n_params() * 2)
    else:
        widths = (f"d_state {cfg.ssm.d_state}, {cfg.ssm.n_heads} SSM heads "
                  f"of {cfg.ssm.head_dim}, chunk {cfg.ssm.chunk}")
        if cfg.hybrid_period:
            widths += (f"; a shared block after every {cfg.hybrid_period} "
                       f"({cfg.n_layers // cfg.hybrid_period} applications),"
                       f" {cfg.n_heads} heads of {cfg.head_dim}, d_ff "
                       f"{cfg.d_ff}")

        def bounds(B, S):
            return _ssm_bounds(cfg, n_params, B, S)
    print(f"[{tag}] {arch}: {cfg.n_layers} layers, d {cfg.d_model}, "
          f"{widths}, vocab {cfg.vocab_size}, {cfg.n_params():,} params "
          f"(config; {n_params:,} tensors' elements; {cfg.param_dtype}, "
          f"compute {cfg.compute_dtype}); drawn and cast on the card in "
          f"{init_s:.3f} s; memory {torch.cuda.memory_allocated() / 2**30:.3f}"
          f" GiB")
    # warm-up outside the timed drain: the first use of every operator
    warm = model.prefill({"tokens": torch.zeros((LM_LANES, 64),
                                                dtype=torch.long, device=dev)})
    model.decode_step(warm[1], torch.zeros((LM_LANES, 1), dtype=torch.long,
                                           device=dev), 64)
    del warm
    sync(torch, dev)
    eng = serve.ServeEngine(model, batch_lanes=LM_LANES, max_len=LM_MAX_LEN,
                            delta=LM_DELTA, seed=0, device=dev)
    reqs = _lm_requests(serve, cfg.vocab_size, LM_REQUESTS, LM_PROMPT, LM_NEW,
                        lengths=lengths)
    for r in reqs:
        eng.submit(r)
    prefills, decodes = [], []
    _timed_calls(torch, model, "prefill", prefills)
    _timed_calls(torch, model, "decode_step", decodes)
    try:
        t0 = time.perf_counter()
        results = eng.run()
        sync(torch, dev)
        wall = time.perf_counter() - t0
    finally:
        del model.prefill, model.decode_step
    peak = torch.cuda.max_memory_allocated()
    check(sorted(results) == [r.uid for r in reqs],
          f"results for {sorted(results)}, not all {LM_REQUESTS} requests")
    for r in reqs:
        toks = results[r.uid].tokens
        check(1 <= len(toks) <= r.max_new_tokens,
              f"request {r.uid}: {len(toks)} tokens of {r.max_new_tokens}")
        check(all(0 <= t < cfg.vocab_size for t in toks),
              f"request {r.uid}: a token outside the vocabulary")
    util = eng.lane_utilization
    check(0.0 < util <= 1.0, f"lane utilization {util}")
    n_tokens = sum(len(res.tokens) for res in results.values())
    for start, end, _, args in prefills:
        B, S = args[0]["tokens"].shape
        print(f"[{tag}] prefill {B} x {S}: {start.elapsed_time(end):.3f} ms "
              f"(CUDA events; bound {bounds(B, S)[1]:.3f} ms)")
    step_ms = np.array([s.elapsed_time(e) for s, e, _, _ in decodes])
    host_ms = np.diff([t for _, _, t, _ in decodes]) * 1e3
    decode_bound, prefill_bound, n_bytes = bounds(LM_LANES, LM_PROMPT[1])
    print(f"[{tag}] decode: {len(step_ms)} steps, {np.median(step_ms):.3f} ms "
          f"a step median (CUDA events; min {step_ms.min():.3f}, p90 "
          f"{np.percentile(step_ms, 90):.3f}, max {step_ms.max():.3f}); host "
          f"clock between step starts median {np.median(host_ms):.3f} ms; "
          f"bound {decode_bound:.4f} ms ({n_bytes / 1e9:.4f} GB at "
          f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s: the bf16 weights read once"
          + ("" if cfg.ssm is None else ", the fp32 SSM state read and "
             "written" + (", the shared block's K/V over a "
                          f"{LM_PROMPT[1]}-slot cache read"
                          if cfg.hybrid_period else ""))
          + ")")
    print(f"[{tag}] drain: {LM_REQUESTS} requests, {n_tokens} tokens "
          f"generated in {wall:.3f} s wall: {n_tokens / wall:.1f} tokens/s; "
          f"peak memory {peak / 2**30:.3f} GiB (max_memory_allocated); "
          f"prefill bound of {LM_LANES} x {LM_PROMPT[1]} tokens "
          f"{prefill_bound:.3f} ms (2 x params x tokens less the output table "
          f"for all but the last token, plus causal attention"
          + ("" if cfg.ssm is None else " and the chunked scan") + ")")
    print(f"[{tag}] lane utilization {util:.4f} beside u_RD({LM_DELTA:g}) = "
          f"{float(theory.u_rd(LM_DELTA)):.4f}")
    logits, cache = model.prefill({"tokens": torch.randint(
        0, cfg.vocab_size, (LM_LANES, LM_PROMPT[1]), device=dev)})
    tok = torch.argmax(logits, -1)[:, None]

    def steps():
        for i in range(LM_PROFILE_STEPS):
            model.decode_step(cache, tok, LM_PROMPT[1] + i)
    t1 = time.perf_counter()
    _print_profile(torch, dev, steps, tag,
                   f"{LM_PROFILE_STEPS} decode steps at B={LM_LANES}, cache "
                   f"{LM_PROMPT[1]}", LM_PROFILE_STEPS)
    print(f"[{tag}] walls: build {init_s:.3f} s, drain {wall:.3f} s, the "
          f"profiled steps and their tables {time.perf_counter() - t1:.3f} s")
    del model, eng, logits, cache
    torch.cuda.empty_cache()
    return n_tokens


def _print_profile(torch, dev, fn, tag, what, n_steps, host=True):
    """Print the profiler's wall, device busy time, idle share and kernel
    launches a step over one call of ``fn`` (``n_steps`` steps), and its
    eight largest kernels."""
    prof = _profile(torch, dev, fn, host=host)
    if prof is None:
        print(f"[{tag}] torch.profiler gave no device time: idle share not "
              f"measured")
        return
    launches = sum(count for _, _, count in prof["rows"])
    print(f"[{tag}] profiler, {what}: wall {prof['wall_us'] / 1e3:.3f} ms, "
          f"device busy {prof['busy_us'] / 1e3:.3f} ms (idle share "
          f"{1 - prof['busy_us'] / prof['wall_us']:.3f}), "
          f"{launches / n_steps:.0f} kernel launches a step")
    for us, key, count in prof["rows"][:8]:
        print(f"[{tag}] profiler {us / 1e3:9.3f} ms {count:6d}x  {key[:90]}")


def _assert_close(got, want, what):
    err = (got.double().cpu() - want.double().cpu()).abs()
    bad = err > LM_ATOL + LM_RTOL * want.double().cpu().abs()
    check(not bool(bad.any()), f"{what}: {int(bad.sum())} elements beyond "
          f"rtol {LM_RTOL}, atol {LM_ATOL} (max abs err {float(err.max())})")
    return float(err.max())


def phase_lm_checks(torch, configs, models, serve, bridge, dev):
    """Phase 11(b) and (c), in fp32 with TF32 off."""
    import numpy as np
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        # (b) decode token by token against prefill, the widths cut in depth
        cfg = dataclasses.replace(configs.get_config(LM_ARCH),
                                  n_layers=LM_CHECK_LAYERS,
                                  compute_dtype="float32")
        model = models.build_model(cfg, device=dev, seed=0)
        gen = torch.Generator(device=dev).manual_seed(1)
        toks = torch.randint(0, cfg.vocab_size, (2, LM_CHECK_TOKENS),
                             generator=gen, device=dev)
        want, _ = model.prefill({"tokens": toks})
        cache = model.cache_spec(2, LM_CHECK_TOKENS)
        for i in range(LM_CHECK_TOKENS):
            got, cache = model.decode_step(cache, toks[:, i:i + 1], i)
        err = (got - want).abs()
        check(bool((err <= LM_DECODE_TOL * (1 + want.abs())).all()),
              f"decode against prefill: max abs err {float(err.max())}")
        print(f"[lm] (b) {LM_ARCH} widths, {LM_CHECK_LAYERS} layers, fp32: "
              f"{LM_CHECK_TOKENS} tokens decoded one by one give prefill's "
              f"logits, max abs err {float(err.max()):.3e} (tolerance "
              f"{LM_DECODE_TOL:g})")
        del model, cache
        torch.cuda.empty_cache()
        # (c) card against CPU on one parameter set
        for arch in LM_CPU_ARCHS:
            cfg = configs.get_config(arch).reduced()
            on_cpu = models.build_model(cfg, device="cpu", seed=0)
            on_card = models.build_model(cfg, device=dev, seed=1)
            bridge.lm_params_from_numpy(on_card,
                                        bridge.lm_params_to_numpy(on_cpu))
            rng = np.random.default_rng(2)
            toks = rng.integers(0, cfg.vocab_size, (2, 64))
            lc, cc = on_cpu.prefill({"tokens": torch.as_tensor(toks)})
            lg, cg = on_card.prefill({"tokens": torch.as_tensor(toks,
                                                                device=dev)})
            worst = 0.0
            for step in range(LM_CPU_STEPS + 1):
                what = f"{arch} " + ("prefill" if step == 0
                                     else f"decode step {step}")
                worst = max(worst, _assert_close(lg, lc, what))
                for k in cc:
                    worst = max(worst, _assert_close(cg[k], cc[k],
                                                     f"{what} cache {k}"))
                if step == LM_CPU_STEPS:
                    break
                tok = torch.argmax(lc, -1)[:, None]
                lc, cc = on_cpu.decode_step(cc, tok, 64 + step)
                lg, cg = on_card.decode_step(cg, tok.to(dev), 64 + step)
            drains = []
            for model, device in ((on_cpu, "cpu"), (on_card, dev)):
                eng = serve.ServeEngine(model, batch_lanes=2, max_len=128,
                                        delta=8.0, seed=0, device=device)
                for r in _lm_requests(serve, cfg.vocab_size, LM_CPU_REQUESTS,
                                      (4, 24), (8, 24), seed=3):
                    eng.submit(r)
                drains.append({u: r.tokens for u, r in eng.run().items()})
            check(drains[0] == drains[1], f"{arch}: the card's served "
                  f"tokens differ from the CPU's: {drains}")
            print(f"[lm] (c) {arch} reduced, fp32: card = CPU in prefill "
                  f"logits, cache and {LM_CPU_STEPS} decode steps (max abs "
                  f"err {worst:.3e}); a {LM_CPU_REQUESTS}-request drain "
                  f"gives the same tokens ({sum(map(len, drains[0].values()))}"
                  f" tokens)")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def phase_whisper(torch, configs, models, dev):
    """Phase 12(c): whisper-base at full width: encode a batch of frame
    embeddings, seed the cross K/V, decode greedily from token 0."""
    import numpy as np
    cfg = configs.get_config(WHISPER_ARCH)
    model = models.build_model(cfg, device=dev, seed=0)
    model.compute_params()
    n_params = sum(p.numel() for p in model.parameters())
    B, S = WHISPER_BATCH, WHISPER_FRAMES
    gen = torch.Generator(device=dev).manual_seed(0)
    batch = {"enc_embeddings": torch.randn((B, S, cfg.d_model), generator=gen,
                                           device=dev) * 0.1}
    encode_ms = cuda_ms(lambda: model.encode(batch["enc_embeddings"]), 3)
    prefill_ms = cuda_ms(lambda: model.prefill(
        batch, max_decode_len=WHISPER_MAX_DECODE), 3)
    logits, cache = model.prefill(batch, max_decode_len=WHISPER_MAX_DECODE)
    check(tuple(logits.shape) == (B, cfg.vocab_size) and
          not bool(logits.any()), "prefill: the logits are not zeros")
    check(tuple(cache["xk"].shape) == (cfg.n_layers, B, S, cfg.n_kv_heads,
                                       cfg.head_dim), "cross K/V shape")
    tok = torch.zeros((B, 1), dtype=torch.long, device=dev)
    step_ms, tokens = [], []
    for pos in range(WHISPER_STEPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        logits, cache = model.decode_step(cache, tok, pos)
        end.record()
        tok = torch.argmax(logits, -1)[:, None]
        step_ms.append((start, end))
        tokens.append(tok)
    sync(torch, dev)
    step_ms = np.array([a.elapsed_time(b) for a, b in step_ms])
    toks = torch.cat(tokens, dim=1)
    check(tuple(logits.shape) == (B, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()), "decode logits not finite")
    check(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
          "a token outside the vocabulary")
    enc_params = sum(p.numel() for p in model.params["enc_layers"].parameters())
    dec_params = sum(p.numel() for p in model.params["dec_layers"].parameters())
    table = cfg.vocab_size * cfg.d_model
    enc_flops = 2 * enc_params * B * S \
        + 4 * B * S * S * cfg.n_heads * cfg.head_dim * cfg.encoder_layers
    kv_bytes = 2 * cache["xk"].numel() * cache["xk"].element_size()
    dec_bytes = 2 * (dec_params + table) + kv_bytes
    print(f"[whisper] {WHISPER_ARCH}: {cfg.encoder_layers} + {cfg.n_layers} "
          f"layers, d {cfg.d_model}, {cfg.n_heads} heads of {cfg.head_dim}, "
          f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, {n_params:,} tensors' "
          f"elements ({cfg.param_dtype}, compute {cfg.compute_dtype}); batch "
          f"{B} x {S} frames, decoder cache {WHISPER_MAX_DECODE}")
    print(f"[whisper] encode {encode_ms:.3f} ms (CUDA events, mean of 3; "
          f"bound {enc_flops / BF16_FLOPS_PER_S * 1e3:.3f} ms: 2 x encoder "
          f"params x frames plus bidirectional attention at bf16 peak); "
          f"prefill (encode and the cross K/V) {prefill_ms:.3f} ms")
    print(f"[whisper] decode: {WHISPER_STEPS} greedy steps from token 0, "
          f"{np.median(step_ms):.3f} ms a step median (CUDA events; min "
          f"{step_ms.min():.3f}, p90 {np.percentile(step_ms, 90):.3f}); bound "
          f"{dec_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms (the decoder's and the "
          f"table's bf16 weights and the cross K/V read once, "
          f"{dec_bytes / 1e9:.4f} GB); {len(set(toks.flatten().tolist()))} "
          f"distinct tokens")

    def steps():
        for i in range(LM_PROFILE_STEPS):
            model.decode_step(cache, tok, WHISPER_STEPS + i)
    _print_profile(torch, dev, steps, "whisper",
                   f"{LM_PROFILE_STEPS} decode steps at B={B}", LM_PROFILE_STEPS)
    del model, cache, logits, batch
    torch.cuda.empty_cache()


def _leaves(cache, prefix=""):
    """``(path, tensor)`` of every leaf of a (nested) cache, in order."""
    for k, v in cache.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield prefix + k, v


def phase_family_checks(torch, configs, models, bridge, dev):
    """Phase 12(d) and (e), in fp32 with TF32 off."""
    import numpy as np
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        # (d) decode token by token against prefill
        for arch, layers, n_tok in FAMILY_CHECKS:
            cfg = dataclasses.replace(configs.get_config(arch),
                                      compute_dtype="float32")
            if layers is not None:
                cfg = dataclasses.replace(cfg, n_layers=layers)
            model = models.build_model(cfg, device=dev, seed=0)
            gen = torch.Generator(device=dev).manual_seed(1)
            toks = torch.randint(0, cfg.vocab_size, (2, n_tok), generator=gen,
                                 device=dev)
            want, _ = model.prefill({"tokens": toks})
            cache = (model.init_cache(2) if cfg.family == "ssm"
                     else model.init_cache(2, n_tok))
            for i in range(n_tok):
                got, cache = model.decode_step(cache, toks[:, i:i + 1], i)
            err = (got - want).abs()
            check(bool((err <= LM_DECODE_TOL * (1 + want.abs())).all()),
                  f"{arch}: decode against prefill: max abs err "
                  f"{float(err.max())}")
            print(f"[family] (d) {arch} widths, {cfg.n_layers} layers, fp32: "
                  f"{n_tok} tokens decoded one by one give prefill's logits, "
                  f"max abs err {float(err.max()):.3e} (tolerance "
                  f"{LM_DECODE_TOL:g})")
            del model, cache
            torch.cuda.empty_cache()
        # (e) card against CPU on one parameter set
        for arch in FAMILY_CPU_ARCHS:
            cfg = configs.get_config(arch).reduced()
            on_cpu = models.build_model(cfg, device="cpu", seed=0)
            on_card = models.build_model(cfg, device=dev, seed=1)
            bridge.lm_params_from_numpy(on_card,
                                        bridge.lm_params_to_numpy(on_cpu))
            rng = np.random.default_rng(2)
            if cfg.family == "encdec":
                batch = {"enc_embeddings": torch.as_tensor((rng.standard_normal(
                    (2, 64, cfg.d_model)) * 0.1).astype(np.float32))}
                kw, pos0 = {"max_decode_len": 16}, 0
            else:
                batch = {"tokens": torch.as_tensor(
                    rng.integers(0, cfg.vocab_size, (2, 64)))}
                kw, pos0 = {}, 64
            lc, cc = on_cpu.prefill(batch, **kw)
            lg, cg = on_card.prefill({k: v.to(dev) for k, v in batch.items()},
                                     **kw)
            worst, tokens = 0.0, []
            for step in range(LM_CPU_STEPS + 1):
                what = f"{arch} " + ("prefill" if step == 0
                                     else f"decode step {step}")
                worst = max(worst, _assert_close(lg, lc, what))
                for (k, want), (_, got) in zip(_leaves(cc), _leaves(cg)):
                    worst = max(worst, _assert_close(got, want,
                                                     f"{what} cache {k}"))
                tok = torch.argmax(lc, -1)[:, None]
                check(torch.equal(torch.argmax(lg, -1)[:, None].cpu(), tok),
                      f"{what}: the card's greedy tokens differ")
                tokens.append(tok)
                if step == LM_CPU_STEPS:
                    break
                lc, cc = on_cpu.decode_step(cc, tok, pos0 + step)
                lg, cg = on_card.decode_step(cg, tok.to(dev), pos0 + step)
            print(f"[family] (e) {arch} reduced, fp32: card = CPU in prefill "
                  f"logits, every cache leaf and {LM_CPU_STEPS} decode steps "
                  f"(max abs err {worst:.3e}), the same greedy tokens "
                  f"{torch.cat(tokens, 1)[0].tolist()}")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def phase_examples(root):
    """Phase 13: the port's PDES examples as subprocesses, each counting
    B1's and the generator's launches in its process."""
    work = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_examples_"))
    env = dict(os.environ, PYTHONPATH=str(root / "src"), ROOT=str(root))
    counts = {"B1": 0, "threefry_bits": 0}
    try:
        for i, (script, args) in enumerate(EXAMPLES):
            out = work / f"out{i}"
            env["COUNTS"] = str(work / f"counts{i}.json")
            extra = () if script.endswith("quickstart_torch.py") else (
                "--out", str(out))
            t0 = time.perf_counter()
            res = _run([sys.executable, "-c", EXAMPLE, script, *args, *extra],
                       env, script)
            wall = time.perf_counter() - t0
            got = json.loads(pathlib.Path(env["COUNTS"]).read_text())
            for k in counts:
                counts[k] += got[k]
            lines = res.stdout.strip().splitlines()
            if script.endswith("paper_figures_torch.py"):
                check("all paper-figure claims hold" in lines,
                      f"{script}: the claims line is missing")
                check(len(list((out / "figures").glob("*.json"))) == 4,
                      f"{script}: not four figures")
            if script.endswith("pdes_scaling_study_torch.py"):
                data = json.loads((out / "example_scaling.json").read_text())
                check(all(0 < u <= 1 for k, v in data.items() if k != "backend"
                          for u in v["u"]), f"{script}: u outside (0, 1]")
            print(f"[examples] {script} {' '.join(args)}: exit 0 in "
                  f"{wall:.3f} s wall; B1 launches {got['B1']}, generator "
                  f"launches {got['threefry_bits']}; last line: {lines[-1]}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return counts


def _train_flops(cfg, n_params, B, S):
    """``(bf16 FLOP, fp32 FLOP)`` of one train step as the port runs it
    with full remat (the forward twice, the backward's two products a
    product): the layers' products in the compute dtype (8 x params x
    tokens, the output table left out), and in fp32 the cross-entropy's
    logits (forward, its chunk's recompute, two backward products) and
    flash's tiles (every q/k tile, masked or not: two products forward,
    twice, and seven in the backward's two passes), or the SSD scan's
    products for an SSM."""
    T = B * S
    table = cfg.vocab_size * cfg.d_model
    bf16 = 8 * (n_params - table) * T
    fp32 = 4 * 2 * T * cfg.d_model * cfg.vocab_size
    if cfg.ssm is None:
        qb, kb = min(cfg.q_block, S), min(cfg.k_block, S)
        tiles = (S // qb) * (S // kb)
        fp32 += cfg.n_layers * tiles * 11 * 2 * B * cfg.n_heads * qb * kb \
            * cfg.head_dim
    else:
        s = cfg.ssm
        Q = min(s.chunk, S)
        fp32 += 4 * cfg.n_layers * 2 * B * S * (Q * s.d_state + Q * s.d_inner
                                                + 2 * s.d_inner * s.d_state)
    return bf16, fp32


def _train_bound(cfg, n_params, B, S):
    """Least ms of one train step (the same work, every product at the
    bf16 tensor-core peak; 6 x params x tokens, the remat forward and
    causal attention's useful half) against the bytes AdamW must move
    (28 a parameter: fp32 parameter, gradient, m and v read, and
    parameter, m and v written): ``(ms, "operations" or "bytes")``."""
    T = B * S
    table = cfg.vocab_size * cfg.d_model
    flops = 8 * (n_params - table) * T + 8 * T * cfg.d_model * cfg.vocab_size
    if cfg.ssm is None:
        flops += 4 * 2 * B * S * S * cfg.n_heads * cfg.head_dim * cfg.n_layers
    else:
        s = cfg.ssm
        Q = min(s.chunk, S)
        flops += 4 * cfg.n_layers * B * S * (Q * s.d_state + Q * s.d_inner
                                             + 4 * s.d_inner * s.d_state)
    ops_ms = flops / BF16_FLOPS_PER_S * 1e3
    bytes_ms = 28 * n_params / HBM_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms \
        else "bytes"


def _timed_steps(torch, step_fn, store):
    """``step_fn`` with a CUDA event pair and the host clock around every
    call."""
    def run(state, batch):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        out = step_fn(state, batch)
        end.record()
        store.append((start, end, t0))
        return out
    return run


def _report_train(torch, tag, cfg, n_params, B, S, step_ms, peak):
    import numpy as np
    step_ms = np.asarray(step_ms)
    med = float(np.median(step_ms))
    bound, by = _train_bound(cfg, n_params, B, S)
    bf16, fp32 = _train_flops(cfg, n_params, B, S)
    print(f"[{tag}] train step at B {B} x S {S}: {med:.3f} ms median of "
          f"{len(step_ms)} (CUDA events; min {step_ms.min():.3f}, max "
          f"{step_ms.max():.3f}), {B * S / med * 1e3:.1f} tokens/s; peak "
          f"memory {peak / 2**30:.3f} GiB (max_memory_allocated); bound "
          f"{bound:.3f} ms ({by}: every product at the bf16 peak, AdamW's "
          f"28 B a parameter at {HBM_BYTES_PER_S / 1e12:.2f} TB/s), the step "
          f"at {bound / med:.4f} of it; as the port runs it, "
          f"{bf16 / 1e12:.3f} TFLOP in bf16 and {fp32 / 1e12:.3f} TFLOP in "
          f"fp32 (the fp32 alone >= {fp32 / FP32_FLOPS_PER_S * 1e3:.3f} ms "
          f"at {FP32_FLOPS_PER_S / 1e12:.0f} TFLOP/s)")


def _close_trees(torch, a, b):
    """``(bitwise, max abs difference)`` over the leaves of two trees."""
    from repro_torch.tree import tree_leaves
    same, worst = True, 0.0
    with torch.no_grad():
        for x, y in zip(tree_leaves(a), tree_leaves(b)):
            same = same and torch.equal(x, y)
            worst = max(worst, float((x.double() - y.double()).abs().max()))
    return same, worst


def phase_train_ssm(torch, configs, dev):
    """Phase 14(a): mamba2-130m trained at full width, uninterrupted and
    with injected failures, then served.  Returns the trained state (for
    (d))."""
    import numpy as np
    from repro_torch import bridge, models
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.fault import (FaultInjector, RecoveryConfig,
                                         TrainController)
    from repro_torch.train.train_step import init_train_state, make_train_step
    B, S = TRAIN_SSM_SHAPE
    cfg = dataclasses.replace(configs.get_config(TRAIN_SSM_ARCH),
                              ce_chunk=min(256, S))
    opt = AdamWConfig(warmup_steps=max(TRAIN_SSM_STEPS // 20, 5),
                      total_steps=TRAIN_SSM_STEPS)
    dc = DataConfig(cfg.vocab_size, S, B)
    work = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_train_"))
    runs = {}
    try:
        for name, fails in (("uninterrupted", None),
                            ("recovered", TRAIN_SSM_FAILS)):
            torch.cuda.reset_peak_memory_stats()
            model, step = make_train_step(cfg, None, opt, device=dev, seed=0)
            timed = []
            ctl = TrainController(
                _timed_steps(torch, step, timed), init_train_state(model),
                lambda i: make_batch(dc, i, dev),
                RecoveryConfig(ckpt_dir=str(work / name),
                               ckpt_every=TRAIN_SSM_CKPT),
                injector=FaultInjector(fails) if fails else None)
            t0 = time.perf_counter()
            log = ctl.run(TRAIN_SSM_STEPS)
            sync(torch, dev)
            runs[name] = dict(model=model, step=step, ctl=ctl, log=log,
                              wall=time.perf_counter() - t0,
                              ms=[a.elapsed_time(b) for a, b, _ in timed],
                              peak=torch.cuda.max_memory_allocated())
    finally:
        shutil.rmtree(work, ignore_errors=True)
    a, b = runs["uninterrupted"], runs["recovered"]
    check(b["ctl"].restarts == 2, f"restarts {b['ctl'].restarts}, not 2")
    replayed = sum(f - f // TRAIN_SSM_CKPT * TRAIN_SSM_CKPT
                   for f in TRAIN_SSM_FAILS)
    check(len(a["log"]) == TRAIN_SSM_STEPS and
          len(b["log"]) == TRAIN_SSM_STEPS + replayed,
          f"logs of {len(a['log'])} and {len(b['log'])} steps")
    la, lb = a["log"][-1]["loss"], b["log"][-1]["loss"]
    check(abs(la - lb) <= TRAIN_RTOL * abs(la),
          f"recovered final loss {lb!r} against {la!r}")
    bitwise, worst = _close_trees(torch, a["ctl"].state, b["ctl"].state)
    for run in (a, b):
        check(all(math.isfinite(m["grad_norm"]) and math.isfinite(m["loss"])
                  for m in run["log"]), "a loss or gradient norm not finite")
    losses = [m["loss"] for m in a["log"]]
    first, last = float(np.mean(losses[:8])), float(np.mean(losses[-8:]))
    check(last < first, f"the loss does not fall: {first} -> {last}")
    n_params = sum(p.numel() for p in a["model"].parameters())
    print(f"[train a] {TRAIN_SSM_ARCH}: {cfg.n_layers} layers, d "
          f"{cfg.d_model}, vocab {cfg.vocab_size}, {n_params:,} parameters "
          f"({cfg.param_dtype}, compute {cfg.compute_dtype}, remat "
          f"{cfg.remat}, ce_chunk {cfg.ce_chunk}); {TRAIN_SSM_STEPS} steps "
          f"uninterrupted in {a['wall']:.3f} s wall; loss {losses[0]:.4f} "
          f"-> {losses[-1]:.4f} (mean of the first 8 {first:.4f}, of the "
          f"last 8 {last:.4f}); every gradient norm finite")
    print(f"[train a] failures injected at steps {TRAIN_SSM_FAILS}, a "
          f"checkpoint every {TRAIN_SSM_CKPT}: {b['ctl'].restarts} restarts, "
          f"{len(b['log'])} steps run in {b['wall']:.3f} s wall; final loss "
          f"{lb!r} against {la!r} uninterrupted (rtol {TRAIN_RTOL:g}); final "
          f"state bitwise equal: {bitwise} (max abs difference {worst:.3e})")
    _report_train(torch, "train a", cfg, n_params, B, S, a["ms"], a["peak"])
    # the serve path reads the trained parameters
    fresh = models.build_model(cfg, device=dev, seed=1)
    bridge.lm_params_from_numpy(fresh, bridge.lm_params_to_numpy(a["model"]))
    toks = make_batch(dc, 10 ** 6, dev)["tokens"]
    got, cache = a["model"].prefill({"tokens": toks})
    want, want_cache = fresh.prefill({"tokens": toks})
    check(torch.equal(got, want) and all(
        torch.equal(cache[k], want_cache[k]) for k in cache),
        "prefill of the trained module differs from a fresh one's")
    print(f"[train a] prefill of the trained module ({B} x {S}) equals a "
          f"fresh module's loaded through the bridge, logits and cache bit "
          f"for bit")
    del fresh, cache, want_cache, b, runs
    state = a["ctl"].state
    batches = [make_batch(dc, i, dev) for i in range(TRAIN_PROFILE_STEPS)]

    def steps():
        nonlocal state
        for batch in batches:
            state, _ = a["step"](state, batch)
    _print_profile(torch, dev, steps, "train a", f"{TRAIN_PROFILE_STEPS} "
                   f"train steps", TRAIN_PROFILE_STEPS, host=False)
    return a["model"], state


def _parse_launch(stdout: str) -> dict:
    """The numbers of ``launch.train``'s last lines."""
    import re
    out = {}
    for line in stdout.splitlines():
        for k, v in re.findall(r"(\w+)=([-\d.]+|nan|inf)", line):
            out.setdefault(k, float(v))
    return out


def phase_train_lm(torch, configs, dev, root):
    """Phase 14(b): llama3.2-1b through ``python -m
    repro_torch.launch.train`` (a failure injected), then steps timed and
    split in this process."""
    import numpy as np
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.models import flash, transformer
    from repro_torch.optim import adamw
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.train_step import init_train_state, make_train_step
    work = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_launch_"))
    env = dict(os.environ, PYTHONPATH=str(root / "src"), ROOT=str(root))
    try:
        t0 = time.perf_counter()
        res = _run([sys.executable, "-m", "repro_torch.launch.train",
                    *TRAIN_LM_ARGS, "--ckpt-dir", str(work)], env,
                   "launch.train")
        wall = time.perf_counter() - t0
    finally:
        shutil.rmtree(work, ignore_errors=True)
    got = _parse_launch(res.stdout)
    args = dict(zip(TRAIN_LM_ARGS[::2], TRAIN_LM_ARGS[1::2]))
    steps, every = int(args["--steps"]), int(args["--ckpt-every"])
    fail = int(args["--fail-at"])
    check(got.get("restarts") == 1 and
          got.get("steps") == steps + fail - fail // every * every,
          f"launch.train: {res.stdout}")
    check(all(math.isfinite(got[k]) for k in ("first", "last", "min")),
          f"launch.train: a loss not finite: {res.stdout}")
    check(got["last"] < got["first"], f"launch.train: the loss does not "
          f"fall: {res.stdout}")
    for line in res.stdout.strip().splitlines():
        print(f"[train b] launch.train: {line}")
    print(f"[train b] python -m repro_torch.launch.train "
          f"{' '.join(TRAIN_LM_ARGS)}: exit 0 in {wall:.3f} s wall")
    # the same step, timed in this process
    B, S = int(args["--batch"]), int(args["--seq"])
    cfg = configs.get_config(args["--arch"])
    cfg = dataclasses.replace(cfg, ce_chunk=min(cfg.ce_chunk, S))
    torch.cuda.reset_peak_memory_stats()
    model, step = make_train_step(cfg, None, AdamWConfig(
        warmup_steps=5, total_steps=100), device=dev, seed=0)
    state = init_train_state(model)
    dc = DataConfig(cfg.vocab_size, S, B)
    state, _ = step(state, make_batch(dc, 0, dev))          # warm-up
    parts = {"flash forward": [], "flash backward": [], "AdamW": []}
    q_blocks = []

    def timed(fn, key):
        def run(*a, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*a, **kw)
            end.record()
            parts[key].append((start, end))
            return out
        return run

    def bwd(q, *a, **kw):
        q_blocks.append(q.shape[1] // min(kw.get("q_block", a[8]),
                                          q.shape[1]))
        return bwd_timed(q, *a, **kw)
    originals = (flash.flash_forward, flash.flash_backward, adamw.update)
    bwd_timed = timed(flash.flash_backward, "flash backward")
    flash.flash_forward = timed(flash.flash_forward, "flash forward")
    flash.flash_backward = bwd
    adamw.update = timed(adamw.update, "AdamW")
    step_events = []
    try:
        run = _timed_steps(torch, step, step_events)
        for i in range(TRAIN_LM_TIMED):
            state, met = run(state, make_batch(dc, 1 + i, dev))
            check(math.isfinite(float(met["loss"])), "loss not finite")
        sync(torch, dev)
    finally:
        flash.flash_forward, flash.flash_backward, adamw.update = originals
    peak = torch.cuda.max_memory_allocated()
    check(set(q_blocks) == {S // min(cfg.q_block, S)} and
          len(q_blocks) == TRAIN_LM_TIMED * cfg.n_layers,
          f"flash's backward ran over {set(q_blocks)} q blocks, "
          f"{len(q_blocks)} times")
    ms = [a.elapsed_time(b) for a, b, _ in step_events]
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[train b] {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, "
          f"{cfg.n_heads} heads / {cfg.n_kv_heads} kv of {cfg.head_dim}, "
          f"vocab {cfg.vocab_size}, {n_params:,} parameters ({cfg.param_dtype}"
          f", compute {cfg.compute_dtype}, remat {cfg.remat}, ce_chunk "
          f"{cfg.ce_chunk}); flash's backward over {q_blocks[0]} q blocks of "
          f"{cfg.q_block} in each of the {cfg.n_layers} layers")
    _report_train(torch, "train b", cfg, n_params, B, S, ms, peak)
    split = {k: sum(a.elapsed_time(b) for a, b in v) / TRAIN_LM_TIMED
             for k, v in parts.items()}
    # the chunked cross-entropy, forward and backward, on this step's shapes
    h = torch.randn((B, S, cfg.d_model), device=dev, dtype=torch.bfloat16,
                    requires_grad=True)
    table = model.params["embed"]["table"].detach().to(
        torch.bfloat16).requires_grad_(True)
    labels = make_batch(dc, 0, dev)["labels"]
    split["chunked CE (fwd + bwd, alone)"] = cuda_ms(
        lambda: torch.autograd.grad(transformer.chunked_ce(
            h, table, labels, cfg, transformer._noop)[0], (h, table)), 2)
    del h, table
    print(f"[train b] split of a step ({np.median(ms):.3f} ms median): "
          + "; ".join(f"{k} {v:.3f} ms" for k, v in split.items())
          + " (CUDA events around each call, a step's sum)")
    batches = [make_batch(dc, 10 + i, dev) for i in range(TRAIN_PROFILE_STEPS)]

    def steps():
        nonlocal state
        for batch in batches:
            state, _ = step(state, batch)
    t1 = time.perf_counter()
    prof = _profile(torch, dev, steps, warm=False, host=False)
    if prof is None:
        print("[train b] torch.profiler gave no device time: idle share not "
              "measured")
    else:
        gemm = [(us, k.lower()) for us, k, _ in prof["rows"]
                if any(t in k.lower() for t in ("gemm", "nvjet", "xmma",
                                                "cutlass"))]
        fp32 = sum(us for us, k in gemm
                   if any(t in k for t in ("f32f32", "sgemm", "ffma")))
        launches = sum(c for _, _, c in prof["rows"])
        n = TRAIN_PROFILE_STEPS
        products = sum(u for u, _ in gemm)
        print(f"[train b] profiler, {n} steps: wall "
              f"{prof['wall_us'] / 1e3:.3f} ms, device busy "
              f"{prof['busy_us'] / 1e3:.3f} ms (idle share "
              f"{1 - prof['busy_us'] / prof['wall_us']:.3f}), "
              f"{launches / n:.0f} kernel launches a step; a step's product "
              f"kernels {products / n / 1e3:.3f} ms: fp32 (f32f32, sgemm, "
              f"ffma) {fp32 / n / 1e3:.3f} ms, the rest (bf16 on the tensor "
              f"cores) {(products - fp32) / n / 1e3:.3f} ms; the other "
              f"kernels {(prof['busy_us'] - products) / n / 1e3:.3f} ms")
        for us, key, count in prof["rows"][:12]:
            print(f"[train b] profiler {us / 1e3:9.3f} ms {count:6d}x  "
                  f"{key[:90]}")
    print(f"[train b] walls: the launcher {wall:.3f} s, the profiled steps "
          f"and their tables {time.perf_counter() - t1:.3f} s")
    del model, state
    torch.cuda.empty_cache()


def phase_train_checks(torch, configs, dev, trained):
    """Phase 14(c) every reduced arch's loss and gradients, card against
    CPU in fp32 with TF32 off; (d) a checkpoint of (a)'s trained state
    saved on the card restores on the CPU and back, bitwise."""
    import numpy as np
    from repro_torch import bridge, models
    from repro_torch.train import checkpoint
    from repro_torch.train.train_step import init_train_state
    from repro_torch.tree import tree_leaves, tree_map
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for arch in configs.ARCH_IDS:
            cfg = configs.get_config(arch).reduced()
            on_cpu = models.build_model(cfg, device="cpu", seed=0)
            on_card = models.build_model(cfg, device=dev, seed=1)
            bridge.lm_params_from_numpy(on_card,
                                        bridge.lm_params_to_numpy(on_cpu))
            rng = np.random.default_rng(3)
            B, S = TRAIN_CPU_SHAPE
            batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)),
                     "labels": rng.integers(0, cfg.vocab_size, (B, S))}
            batch["labels"][0, :5] = -1
            if cfg.family == "encdec":
                batch["enc_embeddings"] = (rng.standard_normal(
                    (B, S, cfg.d_model)) * 0.1).astype(np.float32)
            out = []
            for model in (on_cpu, on_card):
                loss, _ = model.loss({k: torch.as_tensor(v, device=model.device)
                                      for k, v in batch.items()})
                leaves = model.trainable_leaves()
                grads = torch.autograd.grad(loss, list(leaves.values()),
                                            materialize_grads=True)
                out.append((float(loss.detach()), dict(zip(leaves, grads))))
            (lc, gc), (lg, gg) = out
            check(abs(lg - lc) <= TRAIN_RTOL * abs(lc),
                  f"{arch}: loss {lg!r} on the card, {lc!r} on the CPU")
            worst = 0.0
            for k, want in gc.items():
                got = gg[k].cpu()
                tol = TRAIN_GRAD_TOL * float(want.abs().max()) + LM_ATOL
                err = float((got - want).abs().max())
                check(err <= tol, f"{arch}: gradient {k} differs by {err} "
                      f"(tolerance {tol})")
                worst = max(worst, err / tol)
            print(f"[train c] {arch} reduced, fp32: loss on the card {lg!r}, "
                  f"on the CPU {lc!r}; {len(gc)} gradient leaves, the worst "
                  f"at {worst:.3e} of its tolerance")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    model, state = trained
    work = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_ckpt_"))
    try:
        t0 = time.perf_counter()
        checkpoint.save(state, work / "card", step=int(state["step"]))
        save_s = time.perf_counter() - t0
        host = models.build_model(model.cfg, device="cpu", seed=2)
        t0 = time.perf_counter()
        host_state = checkpoint.restore(work / "card", init_train_state(host))
        restore_s = time.perf_counter() - t0
        same = all(torch.equal(a.cpu(), b) for a, b in
                   zip(tree_leaves(state), tree_leaves(host_state)))
        check(same, "the card's checkpoint restored on the CPU differs")
        checkpoint.save(host_state, work / "host", step=int(state["step"]))
        before = tree_map(lambda t: t.clone(), state)
        with torch.no_grad():
            for t in tree_leaves(state):
                t.zero_()
        back = checkpoint.restore(work / "host", state)
        check(all(torch.equal(a, b) for a, b in
                  zip(tree_leaves(before), tree_leaves(back))) and
              back["params"]["embed"]["table"] is
              model.params["embed"]["table"],
              "the CPU's checkpoint restored on the card differs")
        size = (work / "card.npz").stat().st_size
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"[train d] {model.cfg.name}'s trained state saved on the card "
          f"({size / 2**20:.1f} MiB in {save_s:.3f} s), restored on the CPU "
          f"into a fresh module ({restore_s:.3f} s) and back into the card's "
          f"own tensors: bitwise both ways")


def phase_sharded_train(torch, configs, dev):
    """Phase 15(a): phase 14(b)'s llama step with ``par`` on a ``(1, 1)``
    ``("data", "model")`` mesh over NCCL against the ``par=None`` step from
    the same seed and batches: the losses and every parameter bitwise."""
    import datetime
    import numpy as np
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.distributed.sharding import Parallelism
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.train_step import init_train_state, make_train_step
    from repro_torch.tree import tree_leaves_with_path
    args = dict(zip(TRAIN_LM_ARGS[::2], TRAIN_LM_ARGS[1::2]))
    B, S = int(args["--batch"]), int(args["--seq"])
    cfg = configs.get_config(args["--arch"])
    cfg = dataclasses.replace(cfg, ce_chunk=min(cfg.ce_chunk, S))
    dc = DataConfig(cfg.vocab_size, S, B)
    batches = [make_batch(dc, i, dev) for i in range(SHARDED_STEPS)]

    def run(par):
        torch.cuda.reset_peak_memory_stats()
        model, step = make_train_step(cfg, par, AdamWConfig(
            warmup_steps=5, total_steps=100), device=dev, seed=0)
        state = init_train_state(model)
        losses, events = [], []
        run_step = _timed_steps(torch, step, events)
        for batch in batches:
            state, met = run_step(state, batch)
            losses.append(met["loss"].item())
        sync(torch, dev)
        peak = torch.cuda.max_memory_allocated()
        params = {k: (v.full_tensor() if isinstance(v, DTensor) else v)
                  .detach().to("cpu", copy=True)
                  for k, v in tree_leaves_with_path(state["params"])}
        ms = [a.elapsed_time(b) for a, b, _ in events]
        n_params.append(sum(p.numel() for p in model.parameters()))
        del model, state
        torch.cuda.empty_cache()
        return losses, params, ms, peak

    n_params = []
    plain = run(None)
    kind = torch.device(dev).type
    backend = "nccl" if kind == "cuda" else "gloo"
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1,
                            timeout=datetime.timedelta(seconds=120))
    try:
        mesh = make_host_mesh((1, 1), ("data", "model"), device_type=kind)
        sharded = run(Parallelism(mesh))
    finally:
        dist.destroy_process_group()
    same = plain[0] == sharded[0] and all(
        torch.equal(plain[1][k], sharded[1][k]) for k in plain[1])
    worst = max(float((plain[1][k].double() - sharded[1][k].double())
                      .abs().max()) for k in plain[1])
    check(same, f"the (1, 1)-mesh step differs from the one-device step: "
          f"losses {plain[0]} vs {sharded[0]}, max |param diff| {worst:.3g}")
    for tag, (losses, _, ms, peak) in (("par=None", plain),
                                      ("par (1, 1) mesh", sharded)):
        print(f"[shard a] {cfg.name} B {B} x S {S}, {tag}: losses "
              f"{', '.join(f'{x:.6f}' for x in losses)}; step ms "
              f"{', '.join(f'{x:.3f}' for x in ms)} (CUDA events; the "
              f"first includes warm-up), peak memory {peak / 2**30:.3f} GiB "
              f"(max_memory_allocated)")
    print(f"[shard a] {SHARDED_STEPS} steps with par on a (1, 1) "
          f"(\"data\", \"model\") {backend} mesh: losses and all "
          f"{len(plain[1])} parameters bitwise equal to par=None")
    return dict(cfg=cfg, B=B, S=S, n_params=n_params[0], peak=sharded[3],
                ms=float(np.median(sharded[2][1:] or sharded[2])))


def phase_dryrun(torch, configs, measured):
    """Phase 15(b) and (c): the dry run of phase 15(a)'s cell on a
    one-rank fake group beside what (a) measured, then llama's train_4k
    and decode_32k on the 256-rank production mesh."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.dryrun import lower_cell
    from repro_torch.launch.mesh import (fake_world, make_host_mesh,
                                         make_production_mesh)
    cfg, B, S = measured["cfg"], measured["B"], measured["S"]
    shape = ShapeConfig(f"train_b{B}_s{S}", S, B, "train")
    t0 = time.perf_counter()
    with fake_world(1):
        rec, _ = lower_cell(cfg.name, shape, make_host_mesh((1, 1)),
                            overrides={"ce_chunk": cfg.ce_chunk})
    rl, mem = rec["roofline"], rec["memory"]
    bf16, fp32 = _train_flops(cfg, measured["n_params"], B, S)
    print(f"[shard b] dry run of (a)'s cell on a (1, 1) fake mesh "
          f"({time.perf_counter() - t0:.1f} s): predicted "
          f"{rl['flops_per_dev'] / 1e12:.3f} TFLOP (products counted; phase "
          f"14's reckoning {(bf16 + fp32) / 1e12:.3f}), "
          f"{rl['bytes_per_dev'] / 1e12:.3f} TB moved (eager ops' inputs and "
          f"outputs), peak {mem['peak_gib']:.3f} GiB against "
          f"{measured['peak'] / 2**30:.3f} GiB measured in (a); roofline "
          f"{max(rl['compute_s'], rl['memory_s']) * 1e3:.3f} ms "
          f"({rl['dominant']}) against {measured['ms']:.3f} ms measured")
    with fake_world(256):
        mesh = make_production_mesh()
        for name in DRY_CELLS:
            t1 = time.perf_counter()
            rec, cost = lower_cell("llama3.2-1b", name, mesh)
            rl, mem = rec["roofline"], rec["memory"]
            coll = {k: v for k, v in rl["coll_detail"].items() if v}
            check(rl["flops_per_dev"] > 0 and mem["peak_gib"] > 0,
                  f"dry run of {name} counted nothing")
            print(f"[shard c] llama3.2-1b {name} on 16 x 16, full depth, "
                  f"loops counted once (traced in "
                  f"{time.perf_counter() - t1:.1f} s): per device peak "
                  f"{mem['peak_gib']:.3f} GiB (arguments "
                  f"{mem['argument_gib']:.3f}), {rl['flops_per_dev'] / 1e12:.3f}"
                  f" TFLOP, {rl['bytes_per_dev'] / 1e12:.3f} TB, collective "
                  f"bytes {cost.coll_bytes:.6g} in {cost.coll_msgs:.0f} "
                  f"messages {coll}; roofline compute "
                  f"{rl['compute_s'] * 1e3:.3f} ms, memory "
                  f"{rl['memory_s'] * 1e3:.3f} ms, collective "
                  f"{rl['collective_s'] * 1e3:.3f} ms: {rl['dominant']}")


def phase_pdes_core(torch, ps, ops, ref, _build, dev, timer=cuda_ms):
    """Phase 15(d): ``--pdes-core`` on the single mesh, one rank's shard
    run for real on the card; every B2 launch of it held against the plain
    version on the same inputs.  Returns B2's launches in the runs."""
    from repro_torch.launch.dryrun import pdes_core_record
    from repro_torch.launch.mesh import fake_world
    original = ops.pdes_step
    held = []

    def checked(tau_h, bits, base, **kw):
        out = original(tau_h, bits, base, **kw)
        t_p, _, m_p = ref.pdes_step_ref(tau_h, bits, base, **kw)
        check(torch.equal(out[0], t_p), f"B2's tau' differs from the plain "
              f"version at {tuple(tau_h.shape)}")
        for key, a in out[1].items():
            check(torch.equal(a, m_p[key]) if key in EXACT_KEYS else
                  torch.allclose(a, m_p[key], rtol=SUM_RTOL, atol=SUM_ATOL),
                  f"B2's {key} differs from the plain version")
        held.append(max(float(((out[1][k] - m_p[k]).abs()
                               / m_p[k].abs().clamp(min=1)).max())
                        for k in m_p))
        return out
    ps.launches = 0
    ops.pdes_step = checked
    try:
        with fake_world(256):
            recs = [pdes_core_record(mode, "single", device=dev, **PDES_CORE)
                    for mode in ("exact", "commavoid")]
    finally:
        ops.pdes_step = original
    launches = ps.launches
    check(launches == len(held) > 0, f"B2 launches {launches}, held "
          f"{len(held)}")
    B_l, L_l = PDES_CORE["trials"] // 16, PDES_CORE["L"] // 16
    tau = torch.zeros((B_l, L_l + 2), device=dev)
    bits = torch.randint(0, 2**32, (B_l, L_l, 2), device=dev,
                         dtype=torch.int64)
    base = torch.zeros((B_l, 1), device=dev)
    kw = dict(n_v=100, delta=100.0, rd_mode=False, border_both=False)
    words = _build.u32_bits(bits).reshape(bits.shape).contiguous()
    out = torch.empty((B_l, L_l), device=dev)
    stats = torch.empty((6, B_l), device=dev)
    k_ms = timer(lambda: ps.launch(tau, words, base, out, stats, **kw), 200)
    w_ms = timer(lambda: original(tau, bits, base, **kw), 50)
    for rec in recs:
        print(f"[shard d] pdes-core {rec['mode']} on 16 x 16, one shard of "
              f"{B_l} x {L_l} on the card: {rec['coll_bytes_per_step']:.1f} "
              f"collective bytes and {rec['coll_msgs_per_step']:.4f} "
              f"messages a step ({ {k: v for k, v in rec['collectives']
                                      .items() if v} }), temp memory "
              f"{rec['memory_temp_gib'] * 2**30 / 2**20:.3f} MiB")
    b_ms = _step_bytes(B_l, L_l) / HBM_BYTES_PER_S * 1e3
    print(f"[shard d] B2 launches {launches}, each held against the plain "
          f"version (tau'/ucount/min/max bitwise, the sums within rtol "
          f"{SUM_RTOL}: max relative error {max(held):.3g}); one step at "
          f"{B_l} x {L_l}: the kernel {k_ms:.5f} ms ({b_ms:.5f} ms bytes "
          f"bound, share {b_ms / k_ms:.3f}; plan "
          f"{ps.launch_plan(B_l, L_l)}), the wrapper with its int64 -> "
          f"uint32 word conversion {w_ms:.5f} ms (CUDA events)")
    return launches


def phase_linter(root):
    """Phase 16: the causality linter over every backend (a subprocess,
    its report held to the goldens), each kernel's launch plan and this
    run's ptxas figures against one block's budget, and the six seeded
    fixtures."""
    from repro_torch.analysis import analyze_probe
    from repro_torch.analysis.fixtures import FIXTURES
    from repro_torch.analysis.rules import vmem
    from repro_torch.kernels.tiling import MAX_GRID_RING_L, MAX_RING_L
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        out = pathlib.Path(tmp) / "analysis.json"
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.analysis", "--backend", "all",
             "--format", "json", "-o", str(out)], cwd=root,
            env=dict(os.environ, PYTHONPATH=str(root / "src")),
            capture_output=True, text=True, timeout=600)
        check(proc.returncode == 0, "python -m repro_torch.analysis exited "
              f"{proc.returncode}:\n{proc.stdout[-3000:]}{proc.stderr[-3000:]}")
        report = json.loads(out.read_text())
    for rep in report["backends"]:
        golden = json.loads((root / "tests" / "golden" /
                             f"analysis_{rep['backend']}.json").read_text())
        check(rep == golden, f"the linter's report for {rep['backend']} "
              f"differs from its golden: {rep}")
    print(f"[linter] python -m repro_torch.analysis --backend all: exit 0, "
          f"{len(report['backends'])} backends equal to their goldens, "
          f"{report['n_findings']} findings ({time.perf_counter() - t0:.1f} s)")
    from repro_torch.kernels import pdes_step as ps
    for L in (10_000, MAX_RING_L, 65_536, L_LONG, LONG_B1[-1][1], L_PROD,
              MAX_GRID_RING_L):
        for row in vmem.kernel_budgets(L):
            info = row["ptxas"]
            check(info is not None, f"no ptxas log for {row['kernel']}")
            check(not row["over"], f"{row['kernel']} at L={L}: {row['over']}")
            check(row.get("ring_grid", 1) == 1 or info["spill_stores"] == 0,
                  f"{row['kernel']}'s grid instantiation spills "
                  f"{info['spill_stores']} B")
            check(row["kernel"] != "pdes_step"
                  or info["static_smem"] == ps.STATIC_SMEM,
                  f"pdes_step's static shared memory: ptxas "
                  f"{info['static_smem']} B, the plan {ps.STATIC_SMEM} B")
            check(info["static_smem"] <= row["static_smem"],
                  f"{row['kernel']}'s static shared memory at L={L}")
            print(f"[linter] {row['kernel']} at L={L}: grid {row['grid']}, "
                  f"cluster {row.get('cluster', 1)}, ring grid "
                  f"{row.get('ring_grid', 1)}, {row['threads']} threads, "
                  f"shared {row['dynamic_smem']} B "
                  f"dynamic + {row['static_smem']} B static of "
                  f"{vmem.DEFAULT_BUDGET} B; ptxas: {info['registers']} "
                  f"registers ({info['registers'] * row['threads']} of "
                  f"{vmem.REGISTERS_PER_SM} a block), {info['static_smem']} B "
                  f"static shared, spills {info['spill_stores']} B stored / "
                  f"{info['spill_loads']} B loaded, stack {info['stack']} B")
    for L in (10_000, 65_536, MAX_RING_L):
        plan = ps.launch_plan(B_MAIN, L)
        row = vmem.budget_of("pdes_step", plan)
        check(not row["over"], f"pdes_step at L={L}: {row['over']}")
        print(f"[linter] pdes_step's plan at L={L}, B={B_MAIN}: cluster "
              f"{plan['cluster']}, {plan['rows']} row(s) a block, grid "
              f"{plan['grid']}, {plan['threads']} threads, "
              f"{plan['dynamic_smem']} B dynamic shared a block, "
              f"{ps.resident_clusters(L)} clusters on the card at once "
              f"({ps.step_plan(L)})")
    for name in sorted(FIXTURES):
        probe, rule = FIXTURES[name]()
        fired = {f.rule for f in analyze_probe(probe)}
        check(fired == {rule}, f"fixture {name} fired {sorted(fired)}, "
              f"expected only {rule}")
        print(f"[linter] fixture {name}: fires {rule} and only it")


def phase_long_rings(torch, pm, tf, ref, ops, horizon, prng, sweep, api,
                     trace, build, dev, timer=cuda_ms):
    """Phase 17: B1 and B3 on rings of 2 to 16 blocks of the cooperative
    grid, held to their plain
    versions at ``LONG_B1`` and ``LONG_B3`` (phase 2's five cases, the
    step counter wrapping), a row's moments bitwise the same at B = 448, 32
    and 1, the service's drain at ``L_LONG`` equal to direct runs, and each
    shape timed beside its bound.  Returns B1's launches in (c), B3's in
    (b)'s ``simulate`` and the timings."""
    import numpy as np
    from repro_torch.kernels.tiling import ring_plan
    rng = np.random.default_rng(17)
    timings = {}

    # (a) B1 against its plain version, then timed
    for B, L in LONG_B1:
        plan = ring_plan(L)
        check(plan.tier == "grid", f"B1's plan at L={L}: {plan}")
        tau0, dcol, tcol = _kernel_inputs(torch, rng, B, L, dev)
        err = _hold_b1_cases(torch, pm, ref, tau0, dcol, tcol)
        if L == L_LONG:      # a ring's result whatever batch it runs in
            _hold_rows(torch, pm, tau0, dcol, tcol, LONG_ROWS)
            print(f"[long a] B1 at L={L}: rows 400-431 launched as B=32 and "
                  f"row 446 as B=1 give tau and all six moments bitwise as "
                  f"in the launch of B={B}")
        ms = _time_ring(torch, pm, ref, build, tau0, dcol, tcol, timer)
        timings[("B1", B, L)] = ms
        print(f"[long a] B1 at B={B} L={L}: plan {plan}, "
              f"{pm.rings_at_once(L)} rings on the card at once on the "
              f"{plan.tier} tier; tau/ucount/min/max bitwise "
              f"equal to the plain version over {len(RING_CASES)} cases x "
              f"chunks K={K_MAIN} and K=5; max |err| of the sums {err:.3g}")

    # (b) B3 against its plain version, and through ops.simulate
    b3_launches = 0
    for B, L in LONG_B3:
        tau0 = torch.as_tensor(
            rng.exponential(4.0, size=(B, L)).astype(np.float32), device=dev)
        key = prng.key(L, dev)
        err = _hold_b3_cases(torch, pm, tf, ref, tau0, key)
        n = _hold_simulate(torch, pm, tf, ref, ops, horizon, key, B, L, dev)
        b3_launches += n
        bits = tf.threefry_bits(key, 0, K_MAIN, (B, L))
        ms = _time_ring(torch, pm, ref, build, tau0, None, None, timer,
                        bits=bits)
        timings[("B3", B, L)] = ms
        print(f"[long b] B3 at B={B} L={L}: plan {ring_plan(L)}, "
              f"{pm.rings_at_once(L, bits=True)} rings on the card at "
              f"once; tau/ucount/min/max bitwise equal to the plain version "
              f"over {len(RING_CASES)} cases x chunks K={K_MAIN} and K=5 (max "
              f"|err| of the sums {err:.3g}); ops.simulate over "
              f"{LONG_STEPS_SIM} steps: tau, offsets, u and gvt bitwise the "
              f"plain versions', w2 to tolerance, {n} B3 launches")

    # (c) the service's drain at L_LONG through B1
    t0 = time.perf_counter()
    b1_launches = phase_main_path(torch, pm, sweep, api, trace, dev,
                                  timings[("B1", B_MAIN, L_LONG)]["ms"],
                                  L=L_LONG, burn_in=BURN_LONG, tag="long c")
    print(f"[long c] SweepService at L={L_LONG}: {BURN_LONG} + {STEPS_MAIN} "
          f"steps, {b1_launches} B1 launches; the phase with its direct "
          f"runs {time.perf_counter() - t0:.2f} s")
    return b1_launches, b3_launches, timings


#: Phase 2's five cases of the ring kernels: (n_v, rd_mode, border_both,
#: per-row columns or a scalar b0 and a static Δ).
RING_CASES = ((1, False, False, True), (10, False, False, True),
              (10, True, False, True), (10, False, True, True),
              (10, False, False, False))


def _hold_b1_cases(torch, pm, ref, tau0, dcol, tcol) -> float:
    """B1 against its plain version over ``RING_CASES``, a K = 16 chunk and
    a K = 5 one each, the step counter wrapping mid-chunk; returns the
    sums' max |err|."""
    B, L = tau0.shape
    err = 0.0
    for n_v, rd_mode, border_both, cols in RING_CASES:
        tau, step0 = tau0, 0xFFFFFFF8       # the counter wraps mid-chunk
        for k in (K_MAIN, 5):
            ctr = torch.tensor([[7, step0, 0 if cols else 3, 0]])
            args = (tau, ctr, dcol if cols else None, tcol if cols else None)
            kw = dict(k_steps=k, delta=math.inf if cols else 16.0, n_v=n_v,
                      rd_mode=rd_mode, border_both=border_both)
            got = pm.pdes_multistep_counter(*args, **kw)
            err = max(err, _hold_kernel(
                torch, got, ref.pdes_multistep_counter_ref(*args, **kw),
                f"B1 {B} x {L} {kw}"))
            tau, step0 = got[0], (step0 + k) & 0xFFFFFFFF
    return err


def _hold_rows(torch, pm, tau0, dcol, tcol, row_sets) -> None:
    """Each set of rows launched on its own gives tau and all six moments
    of B1 bitwise as in the launch of the whole batch."""
    ctr = torch.tensor([[3, 11, 0, 0]])
    kw = dict(k_steps=K_MAIN, n_v=N_V_MAIN, delta=math.inf)
    full = pm.pdes_multistep_counter(tau0, ctr, dcol, tcol, **kw)
    for rows in row_sets:
        part = pm.pdes_multistep_counter(tau0[rows], ctr, dcol[rows],
                                         tcol[rows], **kw)
        check(torch.equal(part[0], full[0][rows]),
              f"tau of rows {rows} differs in a batch of {tau0.shape[0]}")
        for key, v in part[1].items():
            check(torch.equal(v, full[1][key][:, rows]),
                  f"{key} of rows {rows} differs in a batch of "
                  f"{tau0.shape[0]}")


def _hold_b3_cases(torch, pm, tf, ref, tau0, key) -> float:
    """B3 against its plain version on generator words over
    ``RING_CASES``, a K = 16 chunk and a K = 5 one each; returns the sums'
    max |err|."""
    B, L = tau0.shape
    err = 0.0
    for n_v, rd_mode, border_both, cols in RING_CASES:
        kw = dict(n_v=n_v, delta=16.0 if cols else math.inf,
                  rd_mode=rd_mode, border_both=border_both)
        tau, step = tau0, 0
        for k in (K_MAIN, 5):
            bits = tf.threefry_bits(key, step, k, (B, L))
            got = pm.pdes_multistep(tau, bits, **kw)
            err = max(err, _hold_kernel(
                torch, got, ref.pdes_multistep_ref(tau, bits, **kw),
                f"B3 {B} x {L} {kw}"))
            tau, step = got[0], step + k
    return err


def _hold_simulate(torch, pm, tf, ref, ops, horizon, key, B, L, dev) -> int:
    """``ops.simulate`` over ``LONG_STEPS_SIM`` steps with the kernels
    against the same call with the plain versions: tau, offsets, u and gvt
    bitwise, w2 to tolerance.  Returns B3's launches in the kernels' run."""
    cfg = horizon.PDESConfig(L=L, n_v=N_V_MAIN, delta=DELTA_SIM)
    st0 = horizon.init_state(cfg, B, dev)
    sync(torch, dev)
    pm.bits_launches = 0
    st_k, out_k = ops.simulate(st0, key, cfg, LONG_STEPS_SIM, k_fuse=K_MAIN)
    sync(torch, dev)
    launches = pm.bits_launches
    check(launches == -(-LONG_STEPS_SIM // K_MAIN),
          f"simulate launched B3 {launches} times")
    with plain_simulate(ops, ref, tf):
        st_p, out_p = ops.simulate(st0, key, cfg, LONG_STEPS_SIM,
                                   k_fuse=K_MAIN)
    for f in ("tau", "offset", "offset_comp"):
        check(torch.equal(getattr(st_k, f), getattr(st_p, f)),
              f"simulate {f} differs from the plain versions at L={L}")
    for name in ("u", "gvt"):
        check(torch.equal(out_k[name], out_p[name]),
              f"simulate {name} differs from the plain versions")
    check(torch.allclose(out_k["w2"], out_p["w2"], rtol=SUM_RTOL,
                         atol=SUM_ATOL), "simulate w2 beyond tolerance")
    return launches


def phase_grid_rings(torch, pm, tf, ref, ops, horizon, prng, sweep, api,
                     trace, engine_mod, build, dev, timer=cuda_ms):
    """Phase 18: B1 and B3 on rings split over the blocks of a cooperative
    grid: held to their plain versions at ``GRID_B1`` and ``GRID_B3``
    (phase 2's five cases, the step counter wrapping), a row's moments
    bitwise the same in two waves, one wave and alone, ``simulate`` at the
    production ring, the service's drain at ``L_PROD`` equal to direct
    runs, the production core through the engine, and each shape timed
    beside its bound.  Returns B1's launches in (c) and (d), B3's in (b)'s
    ``simulate`` and the timings."""
    import numpy as np
    from repro_torch.kernels.tiling import MAX_GRID_RING_L, ring_plan
    rng = np.random.default_rng(18)
    timings = {}

    # (a) B1 against its plain version, a row in any wave, then timed
    for B, L in [(B, L or MAX_GRID_RING_L) for B, L in GRID_B1]:
        tau0, dcol, tcol = _kernel_inputs(torch, rng, B, L, dev)
        err = _hold_b1_cases(torch, pm, ref, tau0, dcol, tcol)
        if L == L_PROD:
            _hold_rows(torch, pm, tau0, dcol, tcol, GRID_ROWS)
            print(f"[grid a] B1 at L={L}: rows 0-5 launched as B=6 (one "
                  f"wave), rows 6 and 7 (the second wave of B={B}) and row 0 "
                  f"each as B=1 give tau and all six moments bitwise as in "
                  f"the launch of B={B}")
        timings[("B1", B, L)] = _time_ring(torch, pm, ref, build, tau0, dcol,
                                           tcol, timer, tag="grid e")
        print(f"[grid a] B1 at B={B} L={L}: plan {ring_plan(L)}, "
              f"{pm.resident_rings(L)} rings on the card at once; "
              f"tau/ucount/min/max bitwise equal to the plain version over "
              f"{len(RING_CASES)} cases x chunks K={K_MAIN} and K=5; max "
              f"|err| of the sums {err:.3g}")

    # (b) B3 against its plain version, and through ops.simulate
    B, L = GRID_B3, L_PROD
    tau0 = torch.as_tensor(
        rng.exponential(4.0, size=(B, L)).astype(np.float32), device=dev)
    key = prng.key(18, dev)
    err = _hold_b3_cases(torch, pm, tf, ref, tau0, key)
    b3_launches = _hold_simulate(torch, pm, tf, ref, ops, horizon, key, B, L,
                                 dev)
    bits = tf.threefry_bits(key, 0, K_MAIN, (B, L))
    timings[("B3", B, L)] = _time_ring(torch, pm, ref, build, tau0, None,
                                       None, timer, bits=bits, tag="grid e")
    print(f"[grid b] B3 at B={B} L={L}: plan {ring_plan(L)}, "
          f"{pm.resident_rings(L, bits=True)} rings on the card at once; "
          f"tau/ucount/min/max bitwise equal to the plain version over "
          f"{len(RING_CASES)} cases x chunks K={K_MAIN} and K=5 (max |err| of "
          f"the sums {err:.3g}); ops.simulate over {LONG_STEPS_SIM} steps: "
          f"tau, offsets, u and gvt bitwise the plain versions', w2 to "
          f"tolerance, {b3_launches} B3 launches")

    # (c) the service's drain at L_PROD through B1, its chunk's kernel time
    tau = torch.empty((B_MAIN, L_PROD), device=dev).exponential_(0.25)
    dcol = torch.tensor([1.0, 4.0, 16.0, 64.0, 4.0, 16.0, math.inf],
                        device=dev).repeat_interleave(REPLICAS)[:, None]
    tcol = torch.arange(B_MAIN, dtype=torch.int32, device=dev)[:, None]
    out, stats = torch.empty_like(tau), torch.empty((6, K_MAIN, B_MAIN),
                                                    device=dev)
    chunk_ms = timer(lambda: pm.counter_launch(
        tau, out, stats, dcol, tcol, (0, 0, 0, 0), n_v=N_V_MAIN,
        delta=math.inf, rd_mode=False, border_both=False), 2)
    del tau, out
    t0 = time.perf_counter()
    b1_launches = phase_main_path(torch, pm, sweep, api, trace, dev, chunk_ms,
                                  L=L_PROD, burn_in=BURN_PROD,
                                  n_steps=STEPS_PROD, tag="grid c")
    print(f"[grid c] SweepService at L={L_PROD}: {BURN_PROD} + {STEPS_PROD} "
          f"steps (cut from {BURN_MAIN} + {STEPS_MAIN}), {b1_launches} B1 "
          f"launches; the phase with its direct runs "
          f"{time.perf_counter() - t0:.2f} s")
    _, _, warm = _drain(torch, sweep, api, dev, L_PROD, BURN_PROD, STEPS_PROD)
    print(f"[grid c] the same drain again, warm: {warm:.3f} s wall, "
          f"{b1_launches} x {chunk_ms:.4f} ms = "
          f"{b1_launches * chunk_ms / 1e3:.3f} s of B1 in it")

    # (d) the paper's production core on one card, through the engine
    cfg = horizon.PDESConfig(L=PDES_CORE["L"], n_v=100, delta=100.0)
    eng = engine_mod.PDESEngine(cfg, backend="pallas_multistep",
                                k_fuse=K_MAIN, device=dev)
    n, steps = PDES_CORE["trials"], PDES_CORE["steps"]
    st0 = eng.init(n)
    sync(torch, dev)
    torch.cuda.reset_peak_memory_stats()
    pm.launches = 0
    t0 = time.perf_counter()
    st, rec = eng.run(st0, 0, steps)
    sync(torch, dev)
    wall = time.perf_counter() - t0
    core_launches = pm.launches
    peak = torch.cuda.max_memory_allocated()
    check(core_launches == -(-steps // K_MAIN),
          f"the production core launched B1 {core_launches} times")
    u = rec.utilization
    check(bool(((u > 0) & (u <= 1)).all()) and all(
        bool(torch.isfinite(x).all()) for x in rec),
          "the production core's observables are out of range")
    ends = torch.tensor([0, n - 1])
    small_st, small = eng.run(eng.init(2), 0, steps, trial_base=ends)
    for f in ("tau", "offset", "offset_comp"):
        check(torch.equal(getattr(small_st, f), getattr(st, f)[ends]),
              f"the production core's {f}: trials 0 and {n - 1} alone differ")
    for f in ("utilization", "gvt"):
        check(torch.equal(getattr(small, f), getattr(rec, f)[:, ends]),
              f"the production core's {f}: trials 0 and {n - 1} alone differ")
    pe_steps = n * PDES_CORE["L"] * steps
    print(f"[grid d] the production core, PDESEngine(L={PDES_CORE['L']}, "
          f"n_v=100, delta=100, pallas_multistep), {n} trials x {steps} "
          f"steps: {wall:.4f} s wall, {pe_steps / wall:.4g} PE-steps/s, "
          f"{core_launches} B1 launches, max_memory_allocated "
          f"{peak / 2**30:.3f} GiB; u in (0, 1] and every observable finite; "
          f"u at the last step {float(u[-1].mean()):.6f}; trials 0 and "
          f"{n - 1} run alone equal theirs bit for bit")
    return b1_launches + core_launches, b3_launches, timings


def phase_stream_rings(torch, pm, ref, sweep, api, build, dev,
                       timer=cuda_ms):
    """Phase 19: B1 on rings past the shared memory of the card's blocks
    (the stream tier): held to its plain version at ``STREAM_B1`` (phase
    2's five cases, the step counter wrapping), a row's moments bitwise
    the same in its batch and alone, an exact request through the service
    at ``L_STREAM`` equal to a direct run, and each ring timed beside its
    bound.  Returns B1's launches in (b) and the timings."""
    import json as _json
    import numpy as np
    from repro_torch.kernels.tiling import MAX_GRID_RING_L, ring_plan
    rng = np.random.default_rng(19)
    timings = {}
    info = build.ptxas_info("pdes_multistep_counter",
                            "multistep_counter_stream_kernel")
    print(f"[stream a] ptxas, multistep_counter_stream_kernel: {info}")

    # (a) B1 against its plain version, a row in either wave, then timed
    for B, L in [(B, L or MAX_GRID_RING_L + 32) for B, L in STREAM_B1]:
        p = ring_plan(L)
        check(p.tier == "stream", f"L={L} is not on the stream tier: {p}")
        tau0, dcol, tcol = _kernel_inputs(torch, rng, B, L, dev)
        err = _hold_b1_cases(torch, pm, ref, tau0, dcol, tcol)
        if B > 1:
            _hold_rows(torch, pm, tau0, dcol, tcol, STREAM_ROWS)
            print(f"[stream a] B1 at L={L}: each row launched alone gives "
                  f"tau and all six moments bitwise as in the launch of "
                  f"B={B} (one ring on the card at a time: row 1 is the "
                  f"second wave there)")
        else:
            timings[("B1", B, L)] = _time_ring(torch, pm, ref, build, tau0,
                                               dcol, tcol, timer,
                                               tag="stream c")
        print(f"[stream a] B1 at B={B} L={L}: plan {p}, {p.keep} PEs of "
              f"each segment in shared memory and {p.offchip_seg} in device "
              f"memory ({p.offchip_pes(L)} of the ring, "
              f"{pm.offchip_bytes_of(B, L, K_MAIN)} bytes a K={K_MAIN} chunk "
              f"read and written there), {pm.resident_rings(L)} rings on "
              f"the card at once; tau/ucount/min/max bitwise equal to the "
              f"plain version over {len(RING_CASES)} cases x chunks "
              f"K={K_MAIN} and K=5; max |err| of the sums {err:.3g}")
        del tau0, dcol, tcol

    # (b) an exact request through the service at L_STREAM
    spec = sweep.WindowSweep(Ls=(L_STREAM,), n_vs=(N_V_MAIN,),
                             deltas=(4.0, math.inf), replicas=2, n_steps=32,
                             burn_in=16, backend="pallas_multistep",
                             k_fuse=K_MAIN, seed=19)
    svc = api.SweepService(device=dev, state_cache_rows=8)
    svc.submit(spec, requester="a")
    before = pm.launches
    t0 = time.perf_counter()
    (resp,) = svc.drain()
    wall = time.perf_counter() - t0
    launches = pm.launches - before
    check(resp.error is None, f"the service's stream request: {resp.error}")
    direct = sweep.run_window_sweep(spec, device=dev).as_dict()
    check(_json.dumps(resp.result.as_dict()) == _json.dumps(direct),
          "the service's answer at L_STREAM differs from a direct run")
    print(f"[stream b] SweepService at L={L_STREAM}: {spec.burn_in} + "
          f"{spec.n_steps} steps x {spec.n_trajectories} rows, {launches} "
          f"B1 launches, {wall:.3f} s wall; bitwise a direct run")
    return launches, timings


def _time_ring(torch, pm, ref, build, tau, dcol, tcol, timer, bits=None,
               tag="long d", n_v=N_V_MAIN, stale=False):
    """Phases 17(d), 18(e) and 20(a): one K = 16 chunk of B1 (``bits``
    None, with the Δ and trial columns; ``stale`` its stale window) or B3
    (on ``bits``) by CUDA events, plain, kernel, kernel, plain, through
    the raw launch; the bound from phase 2's (B1) or phase 7's (B3)
    operation and byte counts, at this run's utilization."""
    B, L = tau.shape
    out = torch.empty_like(tau)
    stats = torch.empty((6, K_MAIN, B), device=tau.device)
    rule = dict(n_v=n_v, rd_mode=False, border_both=False)
    if bits is None:
        ctr = torch.tensor([[0, 0, 0, 0]])
        tbits = build.u32_bits(tcol).reshape(B, 1).contiguous()

        def kern():
            pm.counter_launch(tau, out, stats, dcol, tbits, (0, 0, 0, 0),
                              delta=math.inf, stale=stale, **rule)

        def plain():
            return ref.pdes_multistep_counter_ref(
                tau, ctr, dcol, tcol, k_steps=K_MAIN, delta=math.inf,
                n_v=n_v, stale=stale)
    else:
        def kern():
            pm.bits_launch(tau, bits, out, stats, delta=DELTA_SIM, **rule)

        def plain():
            return ref.pdes_multistep_ref(tau, bits, n_v=N_V_MAIN,
                                          delta=DELTA_SIM)
    p1 = timer(plain, 1)
    k1 = timer(kern, 5)
    k2 = timer(kern, 5)
    p2 = timer(plain, 1)
    k_ms, p_ms = min(k1, k2), min(p1, p2)
    kern()
    ucount = float(stats[0].sum())
    pe_steps = B * L * K_MAIN
    if bits is None:
        n_bytes = 8 * B * L + 4 * 6 * K_MAIN * B + 8 * B
        n_ops = OPS_PER_PE_STEP * pe_steps + OPS_PER_UPDATE * ucount
    else:
        n_bytes = 8 * pe_steps + 8 * B * L + 4 * 6 * K_MAIN * B
        n_ops = B3_OPS_PER_PE_STEP * pe_steps + B3_OPS_PER_UPDATE * ucount
    bytes_ms, ops_ms, bound = _bound(n_bytes, n_ops)
    what = "B3" if bits is not None else "B1 stale" if stale else "B1"
    print(f"[{tag}] {what} K={K_MAIN} chunk at "
          f"B={B} L={L}: kernel {k1:.5f} / {k2:.5f} ms, plain {p1:.4f} / "
          f"{p2:.4f} ms (order plain, kernel, kernel, plain); "
          f"{pe_steps / (k_ms * 1e-3):.4g} PE-steps/s; bound "
          f"{bound['bound_ms']:.5f} ms by {bound['bound_by']} ({n_bytes} "
          f"bytes -> {bytes_ms:.5f} ms, {n_ops:.4g} operations at "
          f"utilization {ucount / pe_steps:.4f} -> {ops_ms:.5f} ms), "
          f"kernel at {bound['bound_ms'] / k_ms:.3f} of it")
    return dict(ms=k_ms, plain_ms=p_ms, **bound)


def _stale_rounds(torch, sweep, api, trace, dev, backend):
    """Phase 20's two rounds on ``backend`` in the stale window: alice,
    bob, carol (= alice), then dave (alice at twice the steps).  Returns
    the responses, the ``pass`` spans' args and the wall seconds."""
    from repro_torch import obs as tobs
    common = dict(Ls=(L_PROD,), n_vs=(100,), replicas=REPLICAS_STALE,
                  n_steps=STEPS_STALE, burn_in=BURN_STALE, backend=backend,
                  window="stale", k_fuse=K_MAIN, seed=20)
    alice = sweep.WindowSweep(deltas=(10.0, 30.0, 100.0, 300.0), **common)
    rounds = [{"alice": alice,
               "bob": sweep.WindowSweep(deltas=(30.0, 100.0, math.inf),
                                        **common),
               "carol": alice},
              {"dave": dataclasses.replace(alice, n_steps=2 * STEPS_STALE)}]
    svc = api.SweepService(device=dev)
    tel = tobs.Telemetry(tracer=tobs.TraceRecorder())
    svc.attach_telemetry(tel)
    responses, wall = [], 0.0
    for specs in rounds:
        for who, spec in specs.items():
            svc.submit(spec, requester=who)
        sync(torch, dev)
        t0 = time.perf_counter()
        responses += svc.drain()
        sync(torch, dev)
        wall += time.perf_counter() - t0
    check(svc.stats.rows_from_state_cache == alice.n_trajectories,
          f"dave's rows did not come from the state cache: {svc.stats}")
    args = [e["args"] for e in tel.tracer.events if e["name"] == "pass"]
    return responses, args, wall


def _hold_stale_b1(torch, pm, ref, tau0, dcol, tcol) -> float:
    """Phase 20(a): B1's stale kernel against its plain version, ``rebase``
    off and on, a K = 16 chunk and a K = 5 one each, the step counter
    wrapping mid-chunk; its ucount differs from the exact window's.
    Returns the sums' max |err|."""
    B, L = tau0.shape
    err = 0.0
    for rebase in (False, True):
        tau, step0 = tau0, 0xFFFFFFF8
        for k in (K_MAIN, 5):
            args = (tau, torch.tensor([[20, step0, 0, 0]]), dcol, tcol)
            kw = dict(k_steps=k, n_v=N_V_STALE, delta=math.inf,
                      rebase=rebase, stale=True)
            got = pm.pdes_multistep_counter(*args, **kw)
            err = max(err, _hold_kernel(
                torch, got, ref.pdes_multistep_counter_ref(*args, **kw),
                f"stale B1 {B} x {L} {kw}"))
            tau, step0 = got[0], (step0 + k) & 0xFFFFFFFF
    args = (tau0, torch.tensor([[20, 0, 0, 0]]), dcol, tcol)
    kw = dict(k_steps=K_MAIN, n_v=N_V_STALE, delta=math.inf)
    stale = pm.pdes_multistep_counter(*args, stale=True, **kw)[1]["ucount"]
    exact = pm.pdes_multistep_counter(*args, **kw)[1]["ucount"]
    check(torch.equal(stale[0], exact[0]) and not torch.equal(stale, exact),
          "the stale kernel's updates are the exact window's")
    return err


def phase_stale_fused(torch, pm, ref, sweep, api, trace, build, dev,
                      timer=cuda_ms):
    """Phase 20: the stale window on B1: its kernel at the stale cell's
    main pass against its plain version and timed beside the exact one,
    then through the service at ``L_PROD`` against direct runs and
    against B2's stale path.  Returns B1's launches and the stale chunk's
    timing."""
    import json as _json
    import numpy as np
    from repro_torch.kernels.tiling import ring_plan
    log = build.library_path("pdes_multistep_counter").with_suffix(".log")
    for fn, info in sorted(build.parse_ptxas(log.read_text()).items()):
        if "multistep_counter" in fn:
            print(f"[stale a] ptxas {fn}: {info}")
            check(info["spill_stores"] == info["spill_loads"] == 0,
                  f"{fn} spills: {info}")

    # (a) the kernel at the cell's main pass, then timed in both windows
    B, L = STALE_B1
    rng = np.random.default_rng(20)
    tau0, _, tcol = _kernel_inputs(torch, rng, B, L, dev)
    dcol = torch.tensor(DELTAS_STALE, device=dev)[
        torch.arange(B, device=dev) % len(DELTAS_STALE)][:, None]
    before = pm.launches
    err = _hold_stale_b1(torch, pm, ref, tau0, dcol, tcol)
    print(f"[stale a] B1 stale at B={B} L={L} (plan {ring_plan(L)}): "
          f"tau/ucount/min/max bitwise equal to the plain version, rebase "
          f"off and on, chunks K={K_MAIN} and K=5; max |err| of the sums "
          f"{err:.3g}; the updates differ from the exact window's")
    exact = _time_ring(torch, pm, ref, build, tau0, dcol, tcol, timer,
                       tag="stale a", n_v=N_V_STALE)
    stale = _time_ring(torch, pm, ref, build, tau0, dcol, tcol, timer,
                       tag="stale a", n_v=N_V_STALE, stale=True)
    print(f"[stale a] the stale chunk at {stale['ms'] / exact['ms']:.4f} "
          f"of the exact one's time")

    # (b) the service's drain, every pass in the stale window
    mid = pm.launches
    fused, args, wall = _stale_rounds(torch, sweep, api, trace, dev,
                                      "pallas_multistep")
    launches = pm.launches - mid
    check(launches > 0 and {a["window"] for a in args} == {"stale"} and
          sum(a["b1_rebased_launches"] for a in args) == launches, args)
    for resp in fused:
        check(resp.error is None, (resp.requester, resp.error))
        direct = sweep.run_window_sweep(resp.spec, device=dev).as_dict()
        check(_json.dumps(resp.result.as_dict()) == _json.dumps(direct),
              f"{resp.requester}: the stale answer differs from a direct run")
        for rec in resp.result.records:
            print(f"[stale b] {resp.requester:5s} delta={rec.delta:<5g} "
                  f"u={rec.u:.6f}+-{rec.u_err:.2g} w2={rec.w2:.5g} "
                  f"spread={rec.spread:.5g} rate={rec.rate:.6f}")
    pe_steps = sum(len(r.spec.deltas) * r.spec.replicas
                   * (r.spec.burn_in + r.spec.n_steps) * L_PROD
                   for r in fused)
    print(f"[stale b] SweepService, stale window on B1 at L={L_PROD}: "
          f"{len(fused)} responses, {launches} B1 launches (passes "
          f"{[(a['window'], a['b1_rebased_launches']) for a in args]}), "
          f"{wall:.3f} s wall, {pe_steps / wall:.4g} PE-steps/s served; "
          f"every response bitwise a direct run")
    b2, _, wall2 = _stale_rounds(torch, sweep, api, trace, dev, "pallas")
    for got, want in zip(fused, b2):
        for g, w in zip(got.result.records, want.result.records):
            check((g.u, g.u_err, g.rate, g.rate_err) ==
                  (w.u, w.u_err, w.rate, w.rate_err),
                  f"{got.requester} delta={g.delta}: B1 {g} B2 {w}")
            for f in ("w2", "w", "wa", "spread"):
                a, b = getattr(g, f), getattr(w, f)
                check(abs(a - b) <= 1e-5 * abs(b) + 1e-6,
                      f"{got.requester} delta={g.delta} {f}: {a} {b}")
    print(f"[stale c] the same rounds on pallas (B2): {wall2:.3f} s wall, "
          f"{pe_steps / wall2:.4g} PE-steps/s; u and rate bitwise B1's, "
          f"the sums to 1e-5")
    return mid - before + launches, stale


def main() -> int:
    global HBM_BYTES_PER_S, BF16_FLOPS_PER_S
    try:
        import torch
    except ImportError:
        return fail("torch is not installed")
    if not torch.cuda.is_available():
        return fail("CUDA is not available: this smoke runs on a GPU")
    root = pathlib.Path(__file__).resolve().parent
    if not (root / "src" / "repro_torch").is_dir():
        return fail(f"no src/repro_torch beside {__file__}: run it from a "
                    f"checkout of the repository")
    sys.path.insert(0, str(root / "src"))
    from repro_torch.launch import mesh as launch_mesh
    HBM_BYTES_PER_S = launch_mesh.HBM_BYTES_PER_S
    BF16_FLOPS_PER_S = launch_mesh.BF16_FLOPS_PER_S
    from repro_torch.core import distributed as D
    from repro_torch.core import engine as engine_mod
    from repro_torch.core import ensemble, events, horizon, prng
    from repro_torch.core import mesh as mesh_mod
    from repro_torch.experiments import optimal_window as opt
    from repro_torch.experiments import sweep
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import pdes_multistep as pm
    from repro_torch.kernels import pdes_step as ps
    from repro_torch.kernels import threefry as tf
    from repro_torch.obs import trace
    from repro_torch.service import api, daemon, wire
    from repro_torch import bridge
    from repro_torch import configs, models, serve
    from repro_torch.core import theory

    card = card_line()
    print(card)
    if sys.argv[1:] == ["stream"]:      # B1's stream tier alone
        _build.build("pdes_multistep_counter")
        launches, _ = phase_stream_rings(torch, pm, ref, sweep, api, _build,
                                         "cuda")
        print(card)
        print(json.dumps({"ok": True, "phase": 19, "b1_launches": launches}))
        return 0
    if sys.argv[1:] == ["stale"]:       # the stale window on B1 alone
        _build.build("pdes_multistep_counter")
        _build.build("pdes_step")
        launches, _ = phase_stale_fused(torch, pm, ref, sweep, api, trace,
                                        _build, "cuda")
        print(card)
        print(json.dumps({"ok": True, "phase": 20, "b1_launches": launches}))
        return 0
    print(f"[setup] python {sys.version.split()[0]}, torch {torch.__version__},"
          f" CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    names = ("pdes_multistep_counter", "pdes_step", "pdes_multistep",
             "threefry_bits")
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        libs = list(pool.map(_build.build, names))   # one nvcc each, at once
    print(f"[setup] built {', '.join(lib.name for lib in libs)} in "
          f"{time.perf_counter() - t0:.2f} s")
    for lib in libs:
        print(lib.with_suffix(".log").read_text().strip())

    t = {}
    t0 = time.perf_counter()
    phase_decode(torch, horizon, pm, "cuda")
    t["1 decode"] = time.perf_counter() - t0
    kstats = phase_kernel(torch, pm, ref, _build, "cuda")
    t["2 B1"] = time.perf_counter() - t0 - sum(t.values())
    b1_launches = phase_main_path(torch, pm, sweep, api, trace, "cuda",
                                  kstats["ms"])
    t["3 B1 path"] = time.perf_counter() - t0 - sum(t.values())
    sstats = phase_step(torch, ps, ref, ops, events, _build, "cuda")
    t["4 B2"] = time.perf_counter() - t0 - sum(t.values())
    b2_launches = phase_slice(torch, ps, sweep, api, opt, engine_mod,
                              "cuda", sstats["ms"])
    t["5 B2 path"] = time.perf_counter() - t0 - sum(t.values())
    gstats = phase_generator(torch, tf, prng, "cuda")
    t["6 generator"] = time.perf_counter() - t0 - sum(t.values())
    b3stats = phase_bits_kernel(torch, pm, tf, prng, ref, "cuda")
    t["7 B3"] = time.perf_counter() - t0 - sum(t.values())
    b3_launches, gen_launches = phase_threefry_path(
        torch, ops, pm, tf, ref, horizon, prng, ensemble, "cuda")
    t["8 B3 path"] = time.perf_counter() - t0 - sum(t.values())
    b2_sharded, sharded = phase_sharded(torch, ps, engine_mod, D, mesh_mod,
                                        sweep, api, "cuda")
    t["9 sharded"] = time.perf_counter() - t0 - sum(t.values())
    b1_serve, b2_serve = phase_service(torch, pm, ps, sweep, wire, daemon, api,
                                       trace, "cuda", root, sharded)
    t["10 serve"] = time.perf_counter() - t0 - sum(t.values())
    phase_lm_serve(torch, configs, models, serve, theory, "cuda")
    phase_lm_checks(torch, configs, models, serve, bridge, "cuda")
    t["11 LM serve"] = time.perf_counter() - t0 - sum(t.values())
    for arch in SSM_ARCHS:
        phase_lm_serve(torch, configs, models, serve, theory, "cuda", arch,
                       arch.split("-")[0], SSM_PROMPTS)
    phase_whisper(torch, configs, models, "cuda")
    phase_family_checks(torch, configs, models, bridge, "cuda")
    t["12 ssm/hybrid/encdec"] = time.perf_counter() - t0 - sum(t.values())
    ex_launches = phase_examples(root)
    t["13 examples"] = time.perf_counter() - t0 - sum(t.values())
    trained = phase_train_ssm(torch, configs, "cuda")
    phase_train_lm(torch, configs, "cuda", root)
    phase_train_checks(torch, configs, "cuda", trained)
    del trained
    t["14 training"] = time.perf_counter() - t0 - sum(t.values())
    measured = phase_sharded_train(torch, configs, "cuda")
    phase_dryrun(torch, configs, measured)
    b2_core = phase_pdes_core(torch, ps, ops, ref, _build, "cuda")
    t["15 sharding"] = time.perf_counter() - t0 - sum(t.values())
    phase_linter(root)
    t["16 linter"] = time.perf_counter() - t0 - sum(t.values())
    b1_long, b3_long, _ = phase_long_rings(torch, pm, tf, ref, ops, horizon,
                                           prng, sweep, api, trace, _build,
                                           "cuda")
    t["17 long rings"] = time.perf_counter() - t0 - sum(t.values())
    b1_grid, b3_grid, _ = phase_grid_rings(torch, pm, tf, ref, ops, horizon,
                                           prng, sweep, api, trace,
                                           engine_mod, _build, "cuda")
    t["18 grid rings"] = time.perf_counter() - t0 - sum(t.values())
    b1_stream, _ = phase_stream_rings(torch, pm, ref, sweep, api, _build,
                                      "cuda")
    t["19 stream rings"] = time.perf_counter() - t0 - sum(t.values())
    b1_stale, stale_stats = phase_stale_fused(torch, pm, ref, sweep, api,
                                              trace, _build, "cuda")
    t["20 stale window"] = time.perf_counter() - t0 - sum(t.values())
    print("[setup] phase wall: "
          + ", ".join(f"{k} {v:.2f} s" for k, v in t.items()))

    kernels = [
        dict(name="pdes_multistep_counter", route="cuda",
             source="src/repro_torch/kernels/csrc/pdes_multistep_counter.cu",
             replaces="src/repro/kernels/pdes_multistep.py:169",
             launches=(b1_launches + b1_serve + ex_launches["B1"] + b1_long
                       + b1_grid + b1_stream + b1_stale),
             library_ms=None, **kstats, stale=stale_stats),
        dict(name="pdes_step", route="cuda",
             source="src/repro_torch/kernels/csrc/pdes_step.cu",
             replaces="src/repro/kernels/pdes_step.py:69",
             launches=b2_launches + b2_sharded + b2_serve + b2_core,
             library_ms=None, **sstats),
        dict(name="pdes_multistep", route="cuda",
             source="src/repro_torch/kernels/csrc/pdes_multistep.cu",
             replaces="src/repro/kernels/pdes_multistep.py:129",
             launches=b3_launches + b3_long + b3_grid, library_ms=None,
             **b3stats),
        dict(name="threefry_bits", route="cuda",
             source="src/repro_torch/kernels/csrc/threefry_bits.cu",
             replaces="jax.random.bits (XLA, outside Pallas)",
             launches=gen_launches + ex_launches["threefry_bits"],
             library_ms=None, **gstats)]
    print(f"[launches] B1: phase 3 {b1_launches}, phase 10(a) {b1_serve}, "
          f"phase 13 {ex_launches['B1']}, phase 17(c) {b1_long}, phase 18(c, "
          f"d) {b1_grid}, phase 19(b) {b1_stream}, phase 20(a, b) {b1_stale}; "
          f"B2: phase 5 {b2_launches}, "
          f"phase 9(c) {b2_sharded}, "
          f"phase 10(d) {b2_serve}, phase 15(d) {b2_core}; B3: phase 8(a) "
          f"{b3_launches}, phase 17(b) {b3_long}, phase 18(b) {b3_grid}; "
          f"generator: phase 8(a) {gen_launches}, phase 13 "
          f"{ex_launches['threefry_bits']}")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
