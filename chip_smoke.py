#!/usr/bin/env python3
"""Run the PyTorch/CUDA port end to end on one NVIDIA GPU and check it.

Usage, from the repository root on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

Phases (each ends with ``torch.cuda.synchronize()``; any failure exits
non-zero):

1. device and build — the card's name and power limit, the torch and CUDA
   versions, and the build of every ``src/repro_torch/kernels/csrc/*.cu``
   (one ``nvcc`` per source, all started together);
2. each CUDA kernel against its plain PyTorch version on the card, bitwise
   (``torch.equal``), with kernel and plain times, the kernel's device-only
   time (``device_ms``, from the profiler) and the least time the card
   could take (``bound_ms``); every kernel but the LIF kernel also on a
   holed and an empty-slot gate pattern of the same events:
   a. the three per-step scatters at the Fig. 6 layer shapes (8 slots),
      under every dtype pairing, beside PyTorch's library route to the
      same slab (checked against the kernel to float32 rounding); and the
      per-step conv on a DAVIS346-sized slab (264x350x8, K = 5) that its
      first design refused;
   b. the three fused window kernels on the inputs the main path gives
      them in a real window (8 slots, T = 4, after three served windows of
      the 1.2% cohort), under both window pairings, with an all-ones
      bitmap and with the sparse bitmap ``window_tile_maps`` gives; beside
      PyTorch's route (the library scatter per timestep plus the LIF as
      torch ops, T times) and the per-step CUDA path for the same window;
   c. the fused-network megakernel on the same real window, whole network,
      both pairings, sparse and all-ones bitmaps, beside the port's
      fused-window lowering and PyTorch's route on that window (and on the
      gate patterns of its layer-0 events, all-ones bitmaps); and the
      fused LIF kernel on the conv1 slab's shape and an odd size, dt 0, 1
      and 5, clip on and off;
3. the trained tiny checkpoint served through the port's engine under
   ``ExecutionPolicy()`` (fused-window, tile sparsity on), tile sparsity
   off, fused-network and per-step, both dtype policies, against
   ``tests/golden/tiny_gesture_trained_serve.npz``, key for key;
4. the main path: the full-width Fig. 6 network (``dvs_gesture_net()``,
   128x128x2, T = 100, seeded random weights quantised to int4) serving
   two cohorts of 8 synthetic DVS recordings (about 1.2% and 4.9% input
   activity) on 8 slots, under the default fused-window lowering, under
   fused-network (warnings are errors there: no fallback may fire) and
   under per-step, both dtype policies; every request must agree bitwise
   across lowerings and policies; each lowering's kernels must have
   launched (launch counts set to 0 just before each lowering's run and
   read just after; fused-network exactly one launch per window and no
   other kernel); one cohort of each lowering is traced; a T = 8 cut of
   two requests is also served by the plain CPU path and must agree
   bitwise;
5. the streaming runtime on the card: the same network serving a cohort
   of 16 requests of the 4.9% recipe on 8 slots, under every lowering and
   both dtype policies: the synchronous ``EventServeEngine.run`` (the
   oracle), then ``StreamingRuntime`` closed loop (all 16 submitted at
   once) and open loop (Poisson arrivals at 1.5x the oracle's requests/s),
   each request bitwise equal to the oracle, the runtime's collect and
   launch phases under ``torch.cuda.set_sync_debug_mode("error")`` (a
   launch that waits on the device fails the phase); and, under the
   default policy, the open loop with an SLO of the open loop's p50
   end-to-end latency (reported), and the burst of all 16 with an SLO of
   the closed loop's p50 end-to-end latency, which must evict and
   complete; every completed request bitwise equal to the oracle.  Launch counts are set to 0 before
   each lowering's runtime runs and read after them;
6. training on the card: one train-mode forward and backward of a B = 2
   batch from dyadic weights on the card and on the CPU (every layer's
   spikes bitwise, gradients within rtol 1e-4 plus 1e-6 of the layer's
   largest); ``fit`` of the full-width Fig. 6 network, 6 steps of B = 8
   with QAT and checkpoints every 3 steps (finite losses, conv/fc
   weights moved, pool weights bitwise frozen); the step-6 checkpoint
   deleted and the run resumed from step 3 (losses 3-5 and final weights
   bitwise); a dispatch spy holds every operation of the B = 2 card step
   and of the resumed steps to the card, and every convolution to
   ``dense_math``'s scope (cuDNN off, TF32 off, deterministic); one more
   step traced; ``evaluate`` on 16 held-out samples; the trained net,
   ``quantize_net(per_channel=False)``, serving 8 of them on 8 slots
   under every lowering and both dtype policies, class counts bitwise
   equal across the six runs and to the card's ``dense_apply`` for
   every request without drops (launch counts set to 0 before each
   lowering's runs and read after them);
7. the single-stream event path (``event_predict`` / ``event_apply``, the
   paper's Listing 1) on the card at full width: phase 4's network and
   its two cohorts, 16 recordings, under both dtype policies, with output
   buffers that cannot drop (``default_capacities(spec, activity=1.0,
   slack=1.0)``): no layer drops, every request's class counts equal the
   engine's under all three lowerings of phase 4, the output stream and
   every ``EConvStats`` counter bitwise across the policies, one request
   per policy bitwise equal to the same call on the CPU, the trained tiny
   checkpoint on the bundled recording equal to the golden's class counts;
   one traced inference per cohort and policy launches at most 40 device
   kernels per boundary and layer, and the per-step scatter kernels
   (their N = 1 faces) at most once per segment (launch counts set to 0
   before the phase and read after it).  ms per inference, launches,
   busy share, the per-layer counters and the SNE ASIC model's energy
   estimate for them are printed and kept under ``"event_path"``;
8. the mesh backend (``ExecutionPolicy(backend="mesh")``, slot shards)
   on the card with repeated devices: phase 4's network, cohorts and
   8 slots, the 1.2% cohort at 2 and 4 shards (``devices=["cuda:0"] * D``)
   and the 4.9% cohort at 2, under every lowering and both dtype
   policies, every request bitwise equal to phase 4's local answer;
   the two dispatch paths' windows adding up to the mesh's windows, and
   the real launches (``LAUNCHES``, set to 0 before each run and read
   after it) equal to D per counted launch of the global path plus the
   shards' own; ragged requests (unequal lengths, idle tails) that take
   both paths in one run, bitwise equal to the local engine; one request
   pinned to slot 0, whose idle shard launches nothing; the streaming
   runtime over the 2-shard mesh, closed loop, collect and launch under
   ``torch.cuda.set_sync_debug_mode("error")``, bitwise equal to phase 4;
   with two or more cards also one shard per card (``devices=None``).
   Each run's p50 window ms and requests/s beside phase 4's local ones
   are printed and kept under ``"mesh"``;
9. LM serving at full width: recurrentgemma-2b (``get_config``, bf16,
   weights drawn on the card from ``torch.Generator("cuda")`` seeded 0)
   served by ``ServeEngine(batch_slots=4, cache_len=4096)``: 8 greedy
   requests of 256-3000 prompt tokens (numpy seed 0; the longer ones wrap
   the 2048-slot rings of the local-attention layers), 32 tokens each.
   Every request must finish with 32 tokens (or end on EOS); for the
   longest and the shortest prompt, the served logits of prefill and 16
   decode steps must agree with the teacher-forced ``forward`` over the
   same tokens within the bfloat16 tolerance of ``_bf16_tol``; the engine
   with ``sd_decode_frac=1.0``, teacher-forced to the plain run's tokens,
   must agree with it call for call within that tolerance, its own token
   equal to the plain one wherever the plain top-2 margin exceeds twice
   the tolerance; the float32 smoke config must give the same logits on
   the card and on the CPU over a prefill and 8 decode steps within
   1e-4 (TF32 off); and the LM path must launch none of the port's eight
   kernels (counts set to 0 before the phase and read after it).  The
   parameter count, peak device memory, prefill tokens/s, the p50
   batched decode step and decode tokens/s beside the step's HBM bound,
   one traced step's device busy share and kernels, and
   ``sd_decode_frac=0.25``'s p50 step, weight bytes per layer and token
   and largest logit drift are printed and kept under ``"lm_serve"``;
10. every remaining LM architecture on the card (weights drawn on the card
   from ``torch.Generator("cuda")`` seeded 0, prompts from numpy seed 0,
   TF32 off for every float32 check, each model freed before the next):
   a. olmoe-1b-7b at full width, bf16, served by
      ``ServeEngine(batch_slots=4, cache_len=2048)``: 8 greedy requests of
      128-1500 prompt tokens, 32 tokens each; parameters, peak memory,
      prefill tokens/s, the p50 batched decode step beside its HBM bound
      (every expert is read at B = 4), decode tokens/s, one traced step,
      and the forward's ``aux_loss`` / ``dropped_frac`` over the longest
      prompt at the published capacity;
   b. at the relaxed capacity 8.0 (the reference's own check), the prefill
      and 16 decode steps of the longest and the shortest prompt on a
      one-slot engine, teacher-forced, against the forward over the same
      tokens, in bf16 within ``_bf16_tol`` and in float32 (the same
      weights, 27.7 GB) within ``F32_REL_TOL`` of the logit scale, at the
      positions where the top-8 sets agree in every layer (the count of
      the others is reported);
   c. ``quant_lm.quantize_model`` on the card, its codes and scales of the
      embedding, layer 0's router and layer 0's gate expert stack equal to
      the CPU's bitwise; then the first 4 requests through
      ``dequant_params`` and ``decode_step`` (16 batched steps,
      teacher-forced to the bf16 tokens): storage bytes, p50 step, peak
      memory, largest logit drift against bf16;
   d. xlstm-1.3b at full width, bf16, ``ServeEngine(batch_slots=4,
      cache_len=512)``: 6 greedy requests of 64-256 prompt tokens, 16
      tokens each; the longest against the teacher-forced forward within
      ``_bf16_tol``; the p50 step beside its bound (weights read, decode
      state read and written), prefill tokens/s;
   e. whisper-medium at full width, bf16: B = 2 stub mel frames (2, 1500,
      80), ``prefill(frames=, cache_len=448)`` of 64-token prompts and 16
      greedy decode steps against the teacher-forced ``forward(frames=)``
      within ``_bf16_tol``; the encoder's ms and the p50 step;
   f. internvl2-26b at full widths, depth cut to 8 of 48 layers: 256 stub
      patch embeddings, ``prefill(patches=)`` of a 512-token prompt and 8
      greedy decode steps against ``forward(patches=)`` within
      ``_bf16_tol``;
   g. the float32 smoke configs of olmoe, llama4-maverick (capacity 0.25,
      which overflows), xlstm, whisper and internvl2, the same weights on
      the card and on the CPU: prefill and 8 decode steps within 1e-4, the
      forward's ``dropped_frac`` and every MoE layer's kept (expert,
      token) routes equal, and two card runs bitwise equal;
   and the phase must launch none of the port's eight kernels.  Its
   numbers are kept under ``"lm_archs"``;
11. LM training on the card (no kernel build; the phase launches none of
   the port's eight kernels, counts set to 0 before it and read after):
   a. gemma3-1b at full width (``get_config``: 26 layers, d_model 1152,
      vocab 262144, tied, bf16, remat, float32 moments), weights from
      ``torch.Generator("cuda")`` seeded 0, the port's ``lm_ds`` on the
      card (B = 8, S = 1024), loss chunk 128, ``warmup_cosine(3e-4, 2,
      6)``: ``train_loop`` for 6 steps with checkpoints every 3 into a
      temporary directory; then the step-6 checkpoint deleted and the run
      resumed from step 3: losses 3-5, params and moments bitwise equal
      to the uninterrupted run, every loss finite, every leaf moved;
      parameters, peak memory, p50 step (steps 2-6) beside the step's
      FLOP bound (forward, backward and remat GEMMs plus attention at 989
      TFLOP/s bf16), tokens/s, checkpoint bytes and ms per save, and one
      traced step's device kernels and busy share;
   b. ``launch.train.main([--arch, <id>, --smoke, --steps, 3])`` on the
      card for each of the ten archs: every loss finite;
   c. each float32 smoke config, one ``make_train_step`` on the card and
      on the CPU from the same weights and batch, TF32 off: loss and
      grad_norm within 1e-5 relative, every gradient leaf within 1e-4 of
      its largest magnitude plus 1e-6, MoE's dropped fraction equal; and
      granite smoke's remat off / ``"full"`` / ``"boundaries"`` steps
      bitwise equal on the card, ``grad_accum=4`` against 1 within the
      reference's tolerance;
   d. granite smoke, 60 steps on the card: the loss falls by more than
      1.0 (the reference's ``test_lm_training_learns``).
   Its numbers are kept under ``"lm_train"``.
12. the sharded LM paths on meshes of repeated ``cuda:0`` (``Mesh(shape,
   devices=["cuda:0"] * n)``; weights drawn on the card from
   ``torch.Generator("cuda")`` seeded 0, each model freed before the
   next; the phase launches none of the port's eight kernels, counts set
   to 0 before it and read after):
   a. olmoe-1b-7b at full width, bf16, ``forward`` of B = 4, S = 512 with
      ``moe_impl="shardmap"`` on (data, model) = (1, 4) and (2, 2), and on
      (1, 4) with ``seq_shard``: every layer's shard-map call against
      ``moe_apply`` on each token shard's tokens (outputs within
      ``_bf16_tol``, kept (expert, token) routes equal, ``dropped_frac``
      equal to the mean of the shards' fractions), each forward twice
      bitwise; then 4 requests on ``ServeEngine`` with the shard-map
      config on (1, 4), teacher-forced for 16 decode steps to the gather
      engine's tokens, logits within ``_bf16_tol`` of its, both p50 steps;
   b. recurrentgemma-2b at full width on ``ServeEngine`` (B = 4) under a
      (4, 1) mesh: at ``sd_decode_frac=1.0`` 16 teacher-forced steps
      within ``_bf16_tol`` of the unsharded sd engine; at 0.25 the drift
      against the dense engine beside the unsharded drift, and the events
      per RG-LRU layer and token;
   c. granite-8b at full width, bf16, ``forward`` of B = 1, S = 4096
      (4 q chunks of 1024) with ``causal_fold`` on and off, twice each:
      all four outputs bitwise equal; both times;
   d. ``flash_decode_shardmap`` at granite-8b's attention shape (B = 4,
      H = 32, Hk = 8, hd = 128, a bf16 cache of S = 32768) with the
      sequence over "model" on (1, 4) and with batch and sequence on
      (2, 2), twice bitwise, within ``_bf16_tol`` of ``decode_attention``;
      both times;
   e. ``ef_compress`` over a float32 gradient tree shaped like full-width
      gemma3-1b (999,812,736 values), 3 error-feedback steps, the first
      step's codes and scales of the embedding and layer 0 equal to the
      CPU's bitwise, ``compression_ratio``; ``int8_psum`` over a (4, 1)
      mesh equal to the CPU's bitwise and within ``n_shards * scale / 2``
      of the float32 psum.
   Its numbers are kept under ``"lm_sharded"``.
13. the multi-pod dry-run (``launch.dryrun``; no kernel build; the phase
   launches none of the port's eight kernels, counts set to 0 before it
   and read after):
   a. every supported decode_32k and long_500k cell on both production
      meshes (16 x 16 and 2 x 16 x 16 ``meta`` devices) and gemma3-1b
      train_4k on the single-pod one, at full width on ``meta`` tensors:
      every status ok and ``torch.cuda.memory_allocated()`` unchanged
      across them; each cell's run time, FLOPs and state bytes per device
      (against 80 GB) and wire bytes;
   b. phase 11's cell (gemma3-1b, B = 8, S = 1024, chunk 128, remat)
      through ``build_step_fn`` on a 1 x 1 mesh, on meta and on the card
      (weights from ``torch.Generator("cuda")`` seeded 0): the meta FLOP
      count equal to ``FlopCounterMode`` around one real step on the card,
      ``state_bytes_per_device`` equal to the bytes of the parameters and
      moments the card holds, ``_train_step_flops`` within 0.5% of the
      count; the meta peak live bytes beside ``max_memory_allocated``;
   c. phase 9's (recurrentgemma-2b, B = 4, cache 4096) and phase 10's
      (olmoe-1b-7b, B = 4, cache 2048) decode cells, meta against the
      card, FLOPs exactly equal; state bytes over 3.35 TB/s beside the
      phases' HBM bounds;
   d. olmoe smoke with ``moe_impl="shardmap"`` on a (2, 2) mesh, a train
      step and a decode step: the collective rows issued on ``meta`` equal
      those issued on repeated ``cuda:0`` with real data.
   Its numbers are kept under ``"dryrun"``.
14. the examples (``repro_torch.examples``), each through its ``main([...])``
   in process on ``cuda:0``, launch counts set to 0 before each run and
   read after it:
   a. ``kernels.event_conv.ref.selfcheck_batched_bitexact`` at the Fig. 6
      conv1 shape (8 slots, 32x32, K = 5, 2 -> 16 channels, 512 events):
      the batched kernel == its N = 1 face slot by slot == the plain
      version on the card, bitwise; the layer program's accounting of the
      Fig. 6 net (``state_bytes`` equal to the engine's resident slabs on
      the card, ``window_scratch_bytes`` per lowering within the card's
      shared memory);
   b. quickstart on the card and on the CPU (weights and the sample made
      on the CPU): event path == dense path, and both equal the CPU's run,
      bitwise;
   c. serve_events ``--source file --weights trained`` (the bundled
      recording, the trained tiny checkpoint) under each lowering and
      dtype policy, synchronous and streaming, and on the mesh backend
      with ``--devices cuda:0,cuda:0``: class counts, predictions,
      per-layer events and both drop counts equal the golden key for key;
      the lowering's kernels launched, launches per window as
      ``LAUNCHES`` counts them;
   d. train_dvs_gesture ``--scale full --qat --steps 4 --batch 8 --test-n
      8 --save-net``: the Fig. 6 net at full width (128x128x2, T = 100);
      every loss finite, the saved net loaded back bitwise; p50 step ms,
      the event path's ms per inference, dense and event accuracy, their
      agreement and the drops, as they are;
   e. event_sparsity on the card and on the CPU: R^2 > 0.999 (the
      example asserts it), part 1's events and SOPs and part 2's event
      fractions equal;
   f. serve_lm on granite smoke, greedy, 4 requests: every request done.
   Its numbers are kept under ``"examples"``.

The line before the last holds the card's ``nvidia-smi`` name and power
limit; before it, one JSON line of per-kernel numbers; the last line is
the device JSON.  Without a CUDA device, or without the repository's
``src/repro_torch`` beside this file, it prints no result and exits
non-zero.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time
from functools import partial

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "golden",
                      "tiny_gesture_trained_serve.npz")
N_SLOTS = 8
WINDOW = 4
WINDOW_US = 1000
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory rate (data sheet)
FP32_OPS_PER_S = 67e12        # H100 SXM float32 outside the tensor cores
LIB_RTOL, LIB_ATOL = 1e-4, 1e-3   # library yardstick vs kernel (f32 order)
COHORTS = (("1.2%", 450e3), ("4.9%", 3.4e6))   # (target activity, rate_hz)
# phase 5: requests of the 4.9% recipe, twice the slots, so that they
# queue; the open loop's Poisson rate over the oracle's requests/s
STREAM_REQUESTS, OPEN_LOOP_LOAD = 16, 1.5
# the layer-0 cohort whose windows feed phase 2b, and how many windows
# it serves first (so the membranes are those of a running request)
WINDOW_COHORT, WARM_WINDOWS = 0, 3
# operations per site and alive timestep of a window's sweeps: leak
# (subtract, max), clip (min, max), fire (compare), reset (select)
SWEEP_OPS = 6
REPLACES = {
    "event_conv_batched": "src/repro/kernels/event_conv/kernel.py:114",
    "event_pool_batched": "src/repro/kernels/event_pool/kernel.py:102",
    "event_fc_batched": "src/repro/kernels/event_fc/kernel.py:95",
    "event_conv_window": "src/repro/kernels/event_conv/kernel.py:272",
    "event_pool_window": "src/repro/kernels/event_pool/kernel.py:233",
    "event_fc_window": "src/repro/kernels/event_fc/kernel.py:197",
    "network_window": "src/repro/kernels/network_window/kernel.py:247",
    "lif_fused": "src/repro/kernels/lif/kernel.py:46",
}
# the lowering whose serving run launches each kernel (None: no serving
# path reaches it; only its public op calls it)
PATH_OF = {"event_conv_batched": "per-step", "event_pool_batched": "per-step",
           "event_fc_batched": "per-step",
           "event_conv_window": "fused-window",
           "event_pool_window": "fused-window",
           "event_fc_window": "fused-window",
           "network_window": "fused-network", "lif_fused": None}
LOWERINGS = ("fused-window", "fused-network", "per-step")
SOURCES = {
    "event_conv_batched": "src/repro_torch/kernels/csrc/event_conv.cu",
    "event_pool_batched": "src/repro_torch/kernels/csrc/event_pool.cu",
    "event_fc_batched": "src/repro_torch/kernels/csrc/event_fc.cu",
    "event_conv_window": "src/repro_torch/kernels/csrc/event_conv_window.cu",
    "event_pool_window": "src/repro_torch/kernels/csrc/event_pool_window.cu",
    "event_fc_window": "src/repro_torch/kernels/csrc/event_fc_window.cu",
    "network_window": "src/repro_torch/kernels/csrc/network_window.cu",
    "lif_fused": "src/repro_torch/kernels/csrc/lif_fused.cu",
}


def log(*a):
    """Progress line on stdout (flushed: the run is read after the fact)."""
    print(*a, flush=True)


def nvidia_smi() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds of ``fn()`` on the device (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def device_ms(fn, name: str, reps: int = 10, tries: int = 5):
    """Mean device-only milliseconds of one launch of the CUDA kernel
    ``name`` over ``reps`` calls of ``fn()``: the profiler's (CUPTI) device
    time of the kernels named ``<name>_kernel``, summed, over the count of
    them the profiler saw.  Unlike :func:`cuda_ms` it leaves out the
    wrapper's host cost.  CUPTI now and then delivers no record of a
    session, sometimes of several in a row: a session that sees fewer
    than half the launches is run again after a pause, at most ``tries``
    times in all, and if none does the time is not measured (None).  It
    is a measurement, never a check."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    pad = torch.zeros(1, device="cuda")
    seen = []
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            for _ in range(4):      # so that no launch of ours comes last
                pad.add_(1)
            torch.cuda.synchronize()
        found = [e for e in prof.key_averages()
                 if str(e.device_type).endswith("CUDA")
                 and f"{name}_kernel" in e.key]
        count = sum(e.count for e in found)
        if 2 * count >= reps and count <= reps:
            return sum(e.self_device_time_total for e in found) / 1e3 / count
        seen.append(count)
        time.sleep(0.2)
    log(f"  {name}: device time not measured (the profiler saw {seen} "
        f"launches of {reps} in {tries} sessions)")
    return None


def _ms_text(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def _as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


def _flat(out) -> list:
    """The tensors of a kernel's result, nested tuples flattened."""
    if isinstance(out, tuple):
        return [t for o in out for t in _flat(o)]
    return [out]


def _gate_variants(gate, seed: int) -> dict:
    """Gate patterns beyond the main path's gated prefix, on its events:
    ``holed`` (half the gated events switched off, and in every other slot
    the list's last event switched on, so the walk runs to the end past
    the holes) and ``empty_slot`` (slot 0 gated off).  ``gate`` is (N, E)
    or (N, T, E)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    keep = torch.from_numpy(rng.random(tuple(gate.shape)) < 0.5)
    holed = torch.where(keep.to(gate.device), gate, torch.zeros_like(gate))
    holed[1::2, ..., -1] = 1
    empty = gate.clone()
    empty[0] = 0
    return {"holed": holed, "empty_slot": empty}


def _pattern_rows(name, layer, pairing, gate, call, seed, bound) -> list:
    """A kernel on the :func:`_gate_variants` of its main-path gates,
    bitwise against its plain version; ``call(which, g)`` runs the kernel
    (``"kern"``) or the plain version (``"plain"``) on gates ``g``, and
    ``bound(g)`` gives the least time for that work, ``(ms, bound_by)``."""
    import torch
    rows = []
    for pattern, g in _gate_variants(gate, seed).items():
        kern, plain = partial(call, "kern", g), partial(call, "plain", g)
        got, want = _flat(kern()), _flat(plain())
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            if a.dtype != b.dtype or not torch.equal(a, b):
                diff = (a.double() - b.double()).abs().max().item()
                raise AssertionError(f"{name} layer {layer} {pairing} "
                                     f"{pattern}: kernel != plain (max "
                                     f"|diff| {diff})")
        bound_ms, bound_by = bound(g)
        row = {"kernel": name, "layer": layer, "pairing": pairing,
               "pattern": pattern, "main": False,
               "gated_events": int((g != 0).sum()), "ms": cuda_ms(kern, 20),
               "device_ms": device_ms(kern, name), "bound_ms": bound_ms,
               "bound_by": bound_by, "max_abs_err": 0.0}
        rows.append(row)
        log(f"  {name:20s} layer {layer} {pairing:6s} {pattern:10s} "
            f"gated={row['gated_events']:6d}  kernel {row['ms']:.4f} ms  "
            f"device {_ms_text(row['device_ms'])}  bound {bound_ms:.5f} ms "
            f"({bound_by})  equal")
    return rows


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain version at the Fig. 6 shapes
# ---------------------------------------------------------------------------

def _layer_inputs(op, rng, pairing: str, dev):
    """Slab, weights, events and gates for one layer at the main path's
    shapes: layer 0 gets a collector bucket at a mid ladder rung; later
    layers get what ``route_frame`` routes from a frame with that many
    spikes (``min(cap, sites)`` events, the spikes first)."""
    import numpy as np
    import torch
    from repro_torch.kernels.window_common import route_frame
    from repro_torch.serve.event_engine import event_bucket_ladder
    spec = op.spec
    H, W, C = spec.in_shape
    Ho, Wo, Co = spec.out_shape
    h = op.halo
    ladder = event_bucket_ladder(op.step_capacity)
    rung = ladder[len(ladder) // 2]
    N = N_SLOTS
    if op.index == 0:
        E = rung
        xyc = np.stack([rng.integers(0, H, (N, E)), rng.integers(0, W, (N, E)),
                        rng.integers(0, C, (N, E))], -1).astype(np.int32)
        gate = np.zeros((N, E), np.float32)
        gate[:, : (4 * E) // 5] = 1.0
        xyc_t = torch.from_numpy(xyc).to(dev)
        gate_t = torch.from_numpy(gate).to(dev)
    else:
        frame = np.zeros((N, H * W * C), np.float32)
        for n in range(N):
            frame[n, rng.choice(H * W * C, min(rung, H * W * C),
                                replace=False)] = 1.0
        xyc_t, gate_t, _ = route_frame(
            torch.from_numpy(frame.reshape(N, H, W, C)).to(dev),
            op.step_capacity)
    if spec.kind == "conv":
        xyc_t = xyc_t + torch.tensor([spec.padding, spec.padding, 0],
                                     dtype=torch.int32, device=dev)
    wshape = spec.weight_shape
    slab = (N, Ho + 2 * h, Wo + 2 * h, Co)
    if pairing == "f32":
        # unquantised float weights: accumulation order is visible
        w = rng.standard_normal(wshape).astype(np.float32)
        v = rng.standard_normal(slab).astype(np.float32)
        gdt, out_dtype = torch.float32, torch.float32
    else:
        w = rng.integers(-8, 8, wshape).astype(np.int8)
        if pairing == "int8":
            v = rng.integers(-127, 128, slab).astype(np.int8)
            gdt = torch.int8
        else:
            v = rng.integers(-1000, 1000, slab).astype(np.int32)
            gdt = torch.int32
        out_dtype = torch.int32
    return (torch.from_numpy(v).to(dev), torch.from_numpy(w).to(dev),
            xyc_t.contiguous(), gate_t.to(gdt).contiguous(), out_dtype)


def _bound(op, v, w, xyc, gate, out_dtype):
    """Least time for one launch's work: bytes (each input read once, each
    output written once; every gate, but the coordinates and, for fc, the
    weight rows of gated events only) over the memory rate, or operations
    (one multiply and one add per neuron update of a gated event) over the
    float32 rate — the larger."""
    import torch
    spec = op.spec
    active = gate != 0
    n_active = int(active.sum())
    if spec.kind == "fc":
        Hi, Wi, Ci = spec.in_shape
        rows = (xyc[..., 0].long() * Wi + xyc[..., 1].long()) * Ci \
            + xyc[..., 2].long()
        w_bytes = int(torch.unique(rows[active]).numel()) * w.shape[1] \
            * w.element_size()
    else:
        w_bytes = w.numel() * w.element_size()
    out_bytes = v.numel() * torch.empty((), dtype=out_dtype).element_size()
    nbytes = (v.numel() * v.element_size() + out_bytes + w_bytes
              + n_active * 3 * 4 + gate.numel() * gate.element_size())
    return _bound_of(nbytes, 2 * n_active * spec.updates_per_event())


def _library_call(op, w, xyc, gate):
    """PyTorch's own route to the same scatter (f32 only), as a function of
    the slab ``v``, timed whole: the events are summed into a dense frame
    with ``index_add_`` and one library call applies the weights — a
    transposed convolution whose output is the (Hp, Wp) slab, added to
    ``v``, for conv; ``index_add`` into ``v`` for pool; one ``addmm`` onto
    ``v`` for fc.  Returns the slab the kernel returns, (N, Hp, Wp, Co)."""
    import torch
    import torch.nn.functional as F
    spec = op.spec
    N = xyc.shape[0]
    H, W, C = spec.in_shape

    def coords():
        x, y, c = (xyc[..., k].long() for k in range(3))
        return torch.arange(N, device=xyc.device)[:, None].expand_as(x), \
            x, y, c

    def frame(shape, flat):
        # (N, *shape) zeros with each event's gate added at its flat site
        size = shape[0] * shape[1] * shape[2]
        return torch.zeros(N * size, device=xyc.device).index_add_(
            0, flat.reshape(-1), gate.reshape(-1)).reshape(N, *shape)

    if spec.kind == "conv":
        K = w.shape[0]

        def conv(v):
            Hf, Wf = v.shape[1] - K + 1, v.shape[2] - K + 1
            # events are in halo coordinates: a (Hp-K+1, Wp-K+1) frame
            # transposed-convolved by K gives the (Hp, Wp) slab
            nid, x, y, c = coords()
            dense = frame((C, Hf, Wf), ((nid * C + c) * Hf + x) * Wf + y)
            wt = torch.flip(w, (0, 1)).permute(2, 3, 0, 1)
            return v + F.conv_transpose2d(dense, wt).permute(0, 2, 3, 1)
        return conv
    if spec.kind == "pool":
        Ho, Wo, Co = spec.out_shape
        s = spec.stride

        def pool(v):
            # the Fig. 6 pools tile their input exactly: no VALID drops
            nid, x, y, c = coords()
            site = ((nid * Ho + x // s) * Wo + y // s) * Co + c
            return v.reshape(-1).index_add(0, site.reshape(-1),
                                           (w[c] * gate).reshape(-1)
                                           ).reshape(v.shape)
        return pool

    def fc(v):
        nid, x, y, c = coords()
        A = frame((1, 1, w.shape[0]), nid * w.shape[0] + (x * W + y) * C + c)
        return torch.addmm(v.reshape(N, -1), A.reshape(N, -1),
                           w).reshape(v.shape)
    return fc


def phase_kernels(program, dev) -> list:
    """Every per-step kernel against its plain version, every pairing,
    bitwise."""
    import numpy as np
    import torch
    from repro_torch.kernels.event_conv.ops import event_conv_batched
    from repro_torch.kernels.event_conv.ref import event_conv_batched_ref
    from repro_torch.kernels.event_fc.ops import event_fc_batched
    from repro_torch.kernels.event_fc.ref import event_fc_batched_ref
    from repro_torch.kernels.event_pool.ops import event_pool_batched
    from repro_torch.kernels.event_pool.ref import event_pool_batched_ref
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(1234)
    rows = []
    for op in program.ops:
        spec = op.spec
        for pairing in ("f32", "int8", "int32"):
            v, w, xyc, gate, out_dtype = _layer_inputs(op, rng, pairing, dev)
            if spec.kind == "conv":
                name = "event_conv_batched"
                args = (v, w, xyc, gate, out_dtype)
                kern = partial(event_conv_batched, *args)
                plain = partial(event_conv_batched_ref, *args)
            elif spec.kind == "pool":
                name = "event_pool_batched"
                args = (v, w, xyc, gate, spec.stride, out_dtype)
                kern = partial(event_pool_batched, *args)
                plain = partial(event_pool_batched_ref, *args)
            else:
                name = "event_fc_batched"
                args = (v, w, xyc, gate, spec.in_shape, out_dtype)
                kern = partial(event_fc_batched, *args)
                plain = partial(event_fc_batched_ref, *args)
            got, want = kern(), plain()
            torch.cuda.synchronize()
            if got.dtype != want.dtype or not torch.equal(got, want):
                diff = (got.double() - want.double()).abs().max().item()
                raise AssertionError(f"{name} layer {op.index} {pairing}: "
                                     f"kernel != plain (max |diff| {diff})")
            err = (got.double() - want.double()).abs().max().item()
            bound_ms, bound_by = _bound(op, v, w, xyc, gate, out_dtype)
            lib_ms = lib_err = None
            if pairing == "f32":
                lib = partial(_library_call(op, w, xyc, gate), v)
                lib_out = lib()
                lib_err = (lib_out.double() - got.double()).abs().max().item()
                # the library sums in another order (atomics, GEMM tiles):
                # equal to float32 rounding, not bitwise
                if not torch.allclose(lib_out, got, rtol=LIB_RTOL,
                                      atol=LIB_ATOL):
                    raise AssertionError(
                        f"{name} layer {op.index}: the library yardstick "
                        f"computes another function (max |diff| {lib_err})")
                lib_ms = cuda_ms(lib, 20)
            row = {"kernel": name, "layer": op.index, "pairing": pairing,
                   "N": v.shape[0], "slab": list(v.shape[1:]),
                   "E": int(xyc.shape[1]),
                   "gated_events": int((gate != 0).sum()),
                   "ms": cuda_ms(kern, 20), "device_ms": device_ms(kern, name),
                   "plain_ms": cuda_ms(plain, 1, 1),
                   "library_ms": lib_ms, "library_max_abs_err": lib_err,
                   "bound_ms": bound_ms,
                   "bound_by": bound_by, "max_abs_err": err}
            rows.append(row)
            log(f"  {name:20s} layer {op.index} {pairing:5s} slab "
                f"{tuple(v.shape)} E={row['E']:5d} gated={row['gated_events']:5d}"
                f"  kernel {row['ms']:.4f} ms  device "
                f"{_ms_text(row['device_ms'])}  plain {row['plain_ms']:.2f} ms"
                f"  library {lib_ms if lib_ms is None else round(lib_ms, 4)}"
                f" ms  bound {bound_ms:.5f} ms ({bound_by})  equal")
            # the conv, pool and fc walks on holed and empty-slot gates
            def call(which, g, kern=kern, plain=plain, args=args):
                fn = kern if which == "kern" else plain
                return fn.func(*args[:3], g, *args[4:])

            def bound(g, op=op, v=v, w=w, xyc=xyc, out=out_dtype):
                return _bound(op, v, w, xyc, g, out)
            rows += _pattern_rows(name, op.index, pairing, gate, call,
                                  op.index, bound)
    rows.append(_large_conv_row(dev))
    torch.cuda.synchronize()
    return rows


def _large_conv_row(dev) -> dict:
    """The per-step conv on a slab its first design refused (one block held
    a slot's whole slab): 2 slots of a DAVIS346 sensor (260x346) at K = 5,
    a 264x350x8 slab, 2048 events of which the first 80% are gated,
    bitwise against its plain version."""
    import numpy as np
    import torch
    from repro_torch.kernels.event_conv.ops import event_conv_batched
    from repro_torch.kernels.event_conv.ref import event_conv_batched_ref
    N, E, Hp, Wp, Co, K, Ci = 2, 2048, 264, 350, 8, 5, 2
    rng = np.random.default_rng(77)
    xyc = np.stack([rng.integers(0, Hp - K + 1, (N, E)),
                    rng.integers(0, Wp - K + 1, (N, E)),
                    rng.integers(0, Ci, (N, E))], -1).astype(np.int32)
    gate = np.zeros((N, E), np.float32)
    gate[:, : (4 * E) // 5] = 1.0
    v = rng.standard_normal((N, Hp, Wp, Co)).astype(np.float32)
    w = rng.standard_normal((K, K, Ci, Co)).astype(np.float32)
    args = [torch.from_numpy(a).to(dev) for a in (v, w, xyc, gate)]
    kern = partial(event_conv_batched, *args)
    plain = partial(event_conv_batched_ref, *args)
    got, want = kern(), plain()
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        diff = (got - want).abs().max().item()
        raise AssertionError(f"event_conv_batched on a {Hp}x{Wp}x{Co} slab: "
                             f"kernel != plain (max |diff| {diff})")
    n_active = int((args[3] != 0).sum())
    bound_ms, bound_by = _bound_of(
        2 * v.nbytes + w.nbytes + n_active * 3 * 4 + gate.nbytes,
        2 * n_active * K * K * Co)
    row = {"kernel": "event_conv_batched", "layer": "davis346",
           "pairing": "f32", "main": False, "N": N,
           "slab": [Hp, Wp, Co], "E": E, "gated_events": n_active,
           "ms": cuda_ms(kern, 20),
           "device_ms": device_ms(kern, "event_conv_batched"),
           "plain_ms": cuda_ms(plain, 1, 1), "library_ms": None,
           "bound_ms": bound_ms, "bound_by": bound_by, "max_abs_err": 0.0}
    log(f"  event_conv_batched   large slab {(N, Hp, Wp, Co)} K={K} "
        f"E={E} gated={n_active}  kernel {row['ms']:.4f} ms  device "
        f"{_ms_text(row['device_ms'])}  plain {row['plain_ms']:.2f} ms  "
        f"bound {bound_ms:.5f} ms ({bound_by})  equal (a slab its first "
        f"design refused)")
    return row


# ---------------------------------------------------------------------------
# phase 2b: the window kernels on a real window of the main path
# ---------------------------------------------------------------------------

def _capture_window(eng):
    """Serve the engine's next window and return the arguments the engine
    gave ``window_step`` for it: ``(params, states, (ev_xyc, ev_gate,
    alive, pre_dt), program)``, copied before the step ran."""
    from repro_torch.core import layer_program as lp
    from repro_torch.serve import event_engine
    seen = []

    def record(params, states, class_counts, *window, program):
        seen.append((params, tuple(v.clone() for v in states),
                     tuple(t.clone() for t in window), program))
        return lp.window_step(params, states, class_counts, *window,
                              program=program)
    event_engine.window_step = record
    try:
        eng.step()
    finally:
        event_engine.window_step = lp.window_step
    if len(seen) != 1:
        raise AssertionError(f"the window made {len(seen)} window_step calls")
    return seen[0]


def _window_work(op, v, w, xyc, gate, alive, tiles, acc_dtype) -> dict:
    """What one layer's window needs at least, by part (bytes, and the
    operations under ``"ops"``): the slab in and out once, the weights
    (fc: only the rows the gated events name), the coordinates of the
    gated events on alive timesteps (they come first in each bucket; the
    padding behind them is never needed), every gate, the liveness, the
    bitmap and T spike frames written.  The operations: a multiply and an
    add per neuron update of such an event, plus ``SWEEP_OPS`` per
    interior site of a hot tile and alive timestep."""
    import torch
    from repro_torch.kernels.window_common import tile_grid, tiles_to_sites
    spec = op.spec
    Ho, Wo, C = spec.out_shape
    live = alive > 0                                          # (N, T)
    active = (gate != 0) & live[:, :, None]
    n_active = int(active.sum())
    if tiles is None:
        hot = torch.full((v.shape[0],), Ho * Wo, device=v.device)
    else:
        grid = tile_grid(Ho, Wo)
        hot = tiles_to_sites(tiles.float(), grid, (Ho, Wo)).sum(dim=(1, 2))
    sweep_sites = int((hot * live.sum(dim=1)).sum()) * C
    if spec.kind == "fc":
        Hi, Wi, Ci = spec.in_shape
        rows = (xyc[..., 0].long() * Wi + xyc[..., 1].long()) * Ci \
            + xyc[..., 2].long()
        w_bytes = int(torch.unique(rows[active]).numel()) * w.shape[1] \
            * w.element_size()
    else:
        w_bytes = w.numel() * w.element_size()
    acc_size = torch.empty((), dtype=acc_dtype).element_size()
    N, T = alive.shape
    return {"slab": 2 * v.numel() * v.element_size(), "weights": w_bytes,
            "events": n_active * 3 * 4, "gates": gate.numel() * acc_size,
            "alive": alive.numel() * 4,
            "tiles": 0 if tiles is None else tiles.numel() * 4,
            "frames": N * T * Ho * Wo * C * acc_size,
            "ops": (2 * n_active * spec.updates_per_event()
                    + SWEEP_OPS * sweep_sites)}


def _bound_of(nbytes: int, ops: int):
    """(ms, what bounds it): bytes over the memory rate or operations over
    the float32 rate, the larger."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def _window_bound(op, v, w, xyc, gate, alive, tiles, acc_dtype):
    """Least time for one window launch (:func:`_window_work`, all of it)."""
    work = _window_work(op, v, w, xyc, gate, alive, tiles, acc_dtype)
    ops = work.pop("ops")
    return _bound_of(sum(work.values()), ops)


def phase_window_kernels(spec, qn, dev):
    """Every window kernel against its plain version on a real window of
    the main path, both pairings, all-ones and sparse bitmaps, bitwise.
    Returns the rows and, per pairing, the captured window."""
    import torch
    from repro_torch.core import layer_program as lp
    from repro_torch.core.policies import ExecutionPolicy
    from repro_torch.kernels.event_conv import (event_conv_window,
                                                event_conv_window_ref)
    from repro_torch.kernels.event_fc import (event_fc_window,
                                              event_fc_window_ref)
    from repro_torch.kernels.event_pool import (event_pool_window,
                                                event_pool_window_ref)
    from repro_torch.kernels.window_common import (fused_window_ref,
                                                   window_acc_dtype)
    from repro_torch.serve import EventServeEngine
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    fns = {"conv": (event_conv_window, event_conv_window_ref),
           "pool": (event_pool_window, event_pool_window_ref),
           "fc": (event_fc_window, event_fc_window_ref)}
    rows, captured = [], {}
    for dp, pairing in (("f32-carrier", "f32"), ("int8-native", "native")):
        eng = EventServeEngine(qn.spec, qn.params_for(dp), n_slots=N_SLOTS,
                               window=WINDOW, device=dev,
                               policy=ExecutionPolicy(dtype_policy=dp))
        for r in _cohort(spec, COHORTS[WINDOW_COHORT][1], 100, N_SLOTS,
                         spec.n_timesteps):
            if not eng.try_admit(r):
                raise AssertionError("the cohort must fill the slots")
        for _ in range(WARM_WINDOWS):
            eng.step()
        captured[pairing] = _capture_window(eng)
        params, states, window, program = captured[pairing]
        for lw, p in zip(lp.fused_window_layers(params, states, *window,
                                                program=program),
                         params):
            op, vp, xyc, gate, alive, tiles = lw[:6]
            spec_l = op.spec
            kind = spec_l.kind
            name = f"event_{kind}_window"
            native = pairing == "native"
            acc = window_acc_dtype(vp.dtype, native)
            x_k = xyc
            kw = {"lif": op.lif, "native": native}
            if kind == "conv":
                x_k = (xyc + torch.tensor([spec_l.padding, spec_l.padding, 0],
                                          dtype=torch.int32, device=dev)
                       ).contiguous()
                kw["halo"] = op.halo
            elif kind == "pool":
                kw["stride"] = spec_l.stride
            else:
                kw["in_shape"] = spec_l.in_shape
            gate_k = gate.to(acc)
            bitmaps = ({"none": None} if kind == "fc" else
                       {"ones": torch.ones_like(tiles), "sparse": tiles})
            for bm, t_bm in bitmaps.items():
                kwb = dict(kw) if kind == "fc" else dict(kw, tiles=t_bm)
                args = (vp, p.w, x_k, gate_k, alive)
                kern = partial(fns[kind][0], *args, **kwb)
                plain = partial(fns[kind][1], *args, **kwb)
                got, want = kern(), plain()
                torch.cuda.synchronize()
                for g, x in zip(got, want):
                    if g.dtype != x.dtype or not torch.equal(g, x):
                        diff = (g.double() - x.double()).abs().max().item()
                        raise AssertionError(
                            f"{name} layer {op.index} {pairing} {bm}: kernel"
                            f" != plain (max |diff| {diff})")
                bound_ms, bound_by = _window_bound(op, vp, p.w, xyc, gate_k,
                                                   alive, t_bm, acc)
                row = {"kernel": name, "layer": op.index,
                       "pairing": pairing, "bitmap": bm,
                       "N": vp.shape[0], "T": xyc.shape[1],
                       "slab": list(vp.shape[1:]), "E": int(xyc.shape[2]),
                       "gated_events": int((gate != 0).sum()),
                       "hot_tiles": None if t_bm is None else int(t_bm.sum()),
                       "tiles": None if t_bm is None else t_bm.numel(),
                       "ms": cuda_ms(kern, 20),
                       "device_ms": device_ms(kern, name),
                       "plain_ms": cuda_ms(plain, 1, 1),
                       "bound_ms": bound_ms, "bound_by": bound_by,
                       "max_abs_err": 0.0, "library_ms": None,
                       "per_step_ms": None}
                if pairing == "f32" and bm != "ones":
                    # PyTorch's route: the library scatter per timestep and
                    # the LIF as torch ops (dense: the library has no
                    # bitmap); equal to the kernel up to float32 rounding
                    def lib_scatter(a, x_t, g_t, op=op, w=p.w):
                        return _library_call(op, w, x_t, g_t)(a)
                    lib = partial(fused_window_ref, vp, x_k, gate_k, alive,
                                  lib_scatter, lif=op.lif, halo=op.halo,
                                  native=False)
                    for g, x in zip(got, lib()):
                        if not torch.allclose(g, x, rtol=LIB_RTOL,
                                              atol=LIB_ATOL):
                            raise AssertionError(
                                f"{name} layer {op.index}: the library "
                                f"route computes another function")
                    row["library_ms"] = cuda_ms(lib, 5)

                    # the per-step CUDA path for the same window

                    def per_step(op=op, p=p, vp=vp, xyc=xyc, gate=gate,
                                 alive=alive):
                        v = vp
                        for t in range(xyc.shape[1]):
                            v, _ = lp.layer_timestep(
                                op, p, v, xyc[:, t].contiguous(),
                                gate[:, t].contiguous(), alive[:, t])
                        return v
                    if not torch.equal(per_step(), got[0]):
                        raise AssertionError(f"{name} layer {op.index}: "
                                             f"per-step != fused")
                    row["per_step_ms"] = cuda_ms(per_step, 5)
                rows.append(row)
                lib_txt = ("" if row["library_ms"] is None else
                           f"  library {row['library_ms']:.4f} ms  per-step "
                           f"{row['per_step_ms']:.4f} ms")
                tiles_txt = ("" if t_bm is None else
                             f" hot {row['hot_tiles']}/{row['tiles']}")
                log(f"  {name:18s} layer {op.index} {pairing:6s} {bm:6s}"
                    f"{tiles_txt} slab {tuple(vp.shape)} T={row['T']} "
                    f"E={row['E']:5d} "
                    f"gated={row['gated_events']:6d}  kernel "
                    f"{row['ms']:.4f} ms  device "
                    f"{_ms_text(row['device_ms'])}  plain {row['plain_ms']:.2f} ms"
                    f"{lib_txt}  bound {bound_ms:.5f} ms ({bound_by})  "
                    f"equal")
            # every walk on holed and empty-slot gates; the variants may
            # gate padding on: an all-ones bitmap (fc takes none)
            ones = None if kind == "fc" else torch.ones_like(tiles)

            def call(which, g, args=(vp, p.w, x_k), alive=alive,
                     kw=kw if kind == "fc" else dict(kw, tiles=ones),
                     fn=fns[kind]):
                return fn[0 if which == "kern" else 1](*args, g, alive, **kw)

            def bound(g, op=op, vp=vp, w=p.w, xyc=xyc, alive=alive,
                      ones=ones, acc=acc):
                return _window_bound(op, vp, w, xyc, g, alive, ones, acc)
            rows += _pattern_rows(name, op.index, pairing, gate_k, call,
                                  10 + op.index, bound)
    torch.cuda.synchronize()
    return rows, captured


# ---------------------------------------------------------------------------
# phase 2c: the fused-network megakernel and the fused LIF kernel
# ---------------------------------------------------------------------------

def _network_bound(layer_windows, launch, acc_dtype):
    """Least time for one fused-network launch: of each layer's window
    work (:func:`_window_work`, on the events the fused-window lowering
    routes on the same window, which are the megakernel's) only what
    crosses device memory: every slab in and out and the weights; layer
    0's gated coordinates, gates and liveness; the bitmaps; the last
    layer's frames; the counts and drops.  The routed events and inner
    frames stay on chip (the kernel keeps them in its cluster's shared
    memory).  Every layer's operations."""
    nbytes = ops = 0
    L = len(layer_windows)
    for l, lw in enumerate(layer_windows):
        tiles = None if launch.tiles is None else launch.tiles[l]
        work = _window_work(lw.op, launch.states[l], launch.weights[l],
                            lw.xyc, lw.gate.to(acc_dtype), lw.alive, tiles,
                            acc_dtype)
        nbytes += work["slab"] + work["weights"] + work["tiles"]
        ops += work["ops"]
        if l == 0:
            nbytes += work["events"] + work["gates"] + work["alive"]
        if l == L - 1:
            nbytes += work["frames"]
    nbytes += 2 * launch.alive.shape[0] * L * 4
    return _bound_of(nbytes, ops)


def _equal_outputs(got, want, what: str) -> None:
    """Every output of a fused-network launch equal, dtype included."""
    import torch
    for g, x in zip(got[0] + got[1:], want[0] + want[1:]):
        if g.dtype != x.dtype or not torch.equal(g, x):
            diff = (g.double() - x.double()).abs().max().item()
            raise AssertionError(f"{what} (max |diff| {diff})")


def phase_network_kernel(captured, dev) -> list:
    """The megakernel against its plain version on the window phase 2b
    captured, both pairings, the sparse bitmaps of the main path and
    all-ones ones; beside the fused-window lowering on the same window
    (which it must equal) and PyTorch's route."""
    import torch
    from repro_torch.core import layer_program as lp
    from repro_torch.core.policies import ExecutionPolicy
    from repro_torch.kernels.network_window import ref as nw_ref
    from repro_torch.kernels.window_common import window_acc_dtype
    rows = []
    for pairing, (params, states, window, program) in captured.items():
        net_prog = lp.compile_program(
            program.spec, program.step_capacities, ExecutionPolicy(
                dtype_policy=program.dtype_policy,
                fusion_policy="fused-network",
                tile_sparsity=program.tile_sparsity), device=dev)
        if lp.effective_fusion(net_prog) != "fused-network":
            raise AssertionError("Fig. 6 must fit the shared-memory budget")
        launch = lp.network_launch(params, states, *window, program=net_prog)
        acc = window_acc_dtype(states[0].dtype, launch.native)
        fw = list(lp.fused_window_layers(params, states, *window,
                                         program=program))
        fw_out = (tuple(lw.vp_new for lw in fw), fw[-1].spikes,
                  torch.stack([lw.gate.sum(dim=(1, 2)).to(torch.int32)
                               for lw in fw], 1),
                  torch.stack([lw.drops for lw in fw], 1))
        for bm in ("sparse", "ones"):
            run = launch if bm == "sparse" else launch._replace(
                tiles=tuple(torch.ones_like(t) for t in launch.tiles))
            kern = run.run
            plain = partial(run.run, nw_ref.network_window_ref)
            got, want = kern(), plain()
            torch.cuda.synchronize()
            _equal_outputs(got, want, f"network_window {pairing} {bm}: "
                           f"kernel != plain")
            _equal_outputs(got, fw_out, f"network_window {pairing} {bm}: "
                           f"!= the fused-window lowering")
            bound_ms, bound_by = _network_bound(fw, run, acc)
            row = {"kernel": "network_window", "layer": "all",
                   "pairing": pairing, "bitmap": bm,
                   "N": launch.xyc.shape[0], "T": launch.xyc.shape[1],
                   "E0": int(launch.xyc.shape[2]),
                   "routed_events": [int((lw.gate != 0).sum()) for lw in fw],
                   "hot_tiles": [int(t.sum()) for t in run.tiles],
                   "ms": cuda_ms(kern, 20),
                   "device_ms": device_ms(kern, "network_window"),
                   "plain_ms": cuda_ms(plain, 1, 1),
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "max_abs_err": 0.0, "library_ms": None,
                   "fused_window_ms": None, "network_step_ms": None}
            if pairing == "f32" and bm == "sparse":
                cc = torch.zeros((launch.xyc.shape[0],
                                  program.spec.n_classes), device=dev)
                row["fused_window_ms"] = cuda_ms(partial(
                    lp.window_step, params, states, cc, *window,
                    program=program), 5)
                row["network_step_ms"] = cuda_ms(partial(
                    lp.window_step, params, states, cc, *window,
                    program=net_prog), 5)
                row["library_ms"] = _network_library_ms(run, program, params,
                                                        got)
            rows.append(row)
            extra = ("" if row["library_ms"] is None else
                     f"  library {row['library_ms']:.4f} ms  fused-window "
                     f"lowering {row['fused_window_ms']:.4f} ms  fused-"
                     f"network lowering {row['network_step_ms']:.4f} ms")
            log(f"  network_window     {pairing:6s} {bm:6s} N={row['N']} "
                f"T={row['T']} E0={row['E0']} routed {row['routed_events']}"
                f" hot {row['hot_tiles']}  kernel {row['ms']:.4f} ms  device "
                f"{_ms_text(row['device_ms'])}  plain "
                f"{row['plain_ms']:.2f} ms{extra}  bound {bound_ms:.5f} ms "
                f"({bound_by})  equal")
        # holed and empty-slot layer-0 gates, all-ones bitmaps (the
        # variants may gate padding on); the bound from what the dense
        # fused-window lowering routes on the same window
        ones = tuple(torch.ones_like(t) for t in launch.tiles)
        dense = lp.compile_program(
            program.spec, program.step_capacities, ExecutionPolicy(
                dtype_policy=program.dtype_policy,
                fusion_policy="fused-window", tile_sparsity=False),
            device=dev)
        xyc_tm, _, alive_tm, pre_dt = window

        def call(which, g, launch=launch, ones=ones):
            run = launch._replace(gate=g, tiles=ones)
            return run.run() if which == "kern" else \
                run.run(nw_ref.network_window_ref)

        def bound(g, launch=launch, ones=ones, params=params, states=states,
                  xyc_tm=xyc_tm, alive_tm=alive_tm, pre_dt=pre_dt,
                  dense=dense, acc=acc):
            fwd = list(lp.fused_window_layers(
                params, states, xyc_tm, g.transpose(0, 1).contiguous(),
                alive_tm, pre_dt, program=dense))
            return _network_bound(fwd, launch._replace(gate=g, tiles=ones),
                                  acc)
        rows += _pattern_rows("network_window", "all", pairing, launch.gate,
                              call, 40, bound)
    torch.cuda.synchronize()
    return rows


def _network_library_ms(run, program, params, got) -> float:
    """PyTorch's route over the same window: the plain sequence with each
    layer's scatter done by the library call of :func:`_library_call`
    (checked against the kernel to float32 rounding); its mean ms."""
    import torch
    from repro_torch.kernels.network_window import ref as nw_ref
    op_of = {p.w.data_ptr(): op for op, p in zip(program.ops, params)}

    def lib_scatter(nl, w, acc, xyc, gate):
        return _library_call(op_of[w.data_ptr()], w, xyc, gate)(acc)
    plain_scatter = nw_ref._scatter
    nw_ref._scatter = lib_scatter
    try:
        lib = partial(run.run, nw_ref.network_window_ref)
        out = lib()
        for g, x in zip(got[0] + got[1:], out[0] + out[1:]):
            if not torch.allclose(g.double(), x.double(), rtol=LIB_RTOL,
                                  atol=LIB_ATOL):
                raise AssertionError("network_window: the library route "
                                     "computes another function")
        return cuda_ms(lib, 3)
    finally:
        nw_ref._scatter = plain_scatter


def phase_lif_kernel(dev) -> list:
    """The fused LIF kernel against its plain version (the torch
    composition), bitwise, on the conv1 slab's shape and an odd size."""
    import numpy as np
    import torch
    from repro_torch.kernels.lif import lif_fused, lif_fused_ref
    rows = []
    for shape in ((N_SLOTS, 40, 40, 16), (1000, 7)):
        for dt in (0, 1, 5):
            for clip in (None, 3.0):
                rng = np.random.default_rng(dt + len(shape))
                v = torch.from_numpy(rng.normal(size=shape).astype(
                    np.float32) * 2).to(dev)
                syn = torch.from_numpy(rng.normal(size=shape).astype(
                    np.float32)).to(dev)
                args = (v, syn, torch.tensor(float(dt), device=dev), 0.1,
                        0.9, clip)
                kern = partial(lif_fused, *args)
                plain = partial(lif_fused_ref, *args)
                got, want = kern(), plain()
                torch.cuda.synchronize()
                for g, x in zip(got, want):
                    if not torch.equal(g, x):
                        raise AssertionError(f"lif_fused {shape} dt={dt} "
                                             f"clip={clip}: kernel != plain")
                # v and syn read, v_next and spikes written, dt read;
                # about ten operations an element
                bound_ms, bound_by = _bound_of(16 * v.numel() + 4,
                                               10 * v.numel())
                row = {"kernel": "lif_fused", "pairing": "f32",
                       "shape": list(shape), "dt": dt, "clip": clip,
                       "main": shape[1:] == (40, 40, 16) and dt == 1
                       and clip is None,
                       "ms": cuda_ms(kern, 20),
                       "device_ms": device_ms(kern, "lif_fused"),
                       "plain_ms": cuda_ms(plain, 20),
                       "bound_ms": bound_ms, "bound_by": bound_by,
                       "max_abs_err": 0.0, "library_ms": None}
                rows.append(row)
                log(f"  lif_fused {str(tuple(shape)):18s} dt={dt} clip="
                    f"{clip}  kernel {row['ms']:.4f} ms  device "
                    f"{_ms_text(row['device_ms'])}  plain (torch ops) "
                    f"{row['plain_ms']:.4f} ms  bound {bound_ms:.5f} ms "
                    f"({bound_by})  equal")
    return rows


# ---------------------------------------------------------------------------
# phases 3 and 4: serving through the engine
# ---------------------------------------------------------------------------

def serve(qn, reqs, policy, n_slots, dev, window_ms=None):
    """Serve ``reqs`` on a fresh engine under ``policy`` (an
    ``ExecutionPolicy``); return (requests, engine, wall s)."""
    from repro_torch.serve import EventServeEngine
    eng = EventServeEngine(qn.spec, qn.params_for(policy.dtype_policy),
                           n_slots=n_slots, window=WINDOW, device=dev,
                           policy=policy)
    return drive(eng, reqs, window_ms)


def drive(eng, reqs, window_ms=None):
    """Admit and step ``reqs`` through ``eng`` until drained, each window
    waited for on every card the engine uses (its ms appended to
    ``window_ms``); return (requests, engine, wall s)."""
    import torch
    cards = {d for d in (eng.devices if hasattr(eng, "devices")
                         else (eng.device,)) if d.type == "cuda"}
    pending = list(reqs)
    for r in pending:
        eng.validate_request(r)
    t0 = time.perf_counter()
    while True:
        while pending and eng.try_admit(pending[0]):
            pending.pop(0)
        tw = time.perf_counter()
        n = eng.step()
        for d in cards:
            torch.cuda.synchronize(d)
        if window_ms is not None and n:
            window_ms.append(1e3 * (time.perf_counter() - tw))
        if n == 0 and not pending:
            break
    return reqs, eng, time.perf_counter() - t0


def results(reqs) -> dict:
    """The per-request outputs compared across runs (wall time excluded)."""
    import numpy as np
    tele = [r.telemetry for r in reqs]
    out = {
        "class_counts": np.stack([r.class_counts for r in reqs]),
        "predictions": np.asarray([r.prediction for r in reqs], np.int64),
        "per_layer_events": np.stack([np.asarray(t.per_layer_events)
                                      for t in tele]),
        "inter_layer_dropped": np.stack([np.asarray(t.inter_layer_dropped)
                                         for t in tele]),
        "input_dropped": np.asarray([t.input_dropped for t in tele], np.int64),
    }
    for f in ("n_windows", "activity", "sne_time_s", "sne_time_par_s",
              "sne_energy_j", "sne_power_w", "n_dense_timesteps",
              "n_skipped_windows"):
        out[f] = np.asarray([getattr(t, f) for t in tele])
    return out


def assert_same(a: dict, b: dict, what: str) -> None:
    """Every key equal, exactly."""
    import numpy as np
    for k in a:
        if not np.array_equal(a[k], b[k]):
            raise AssertionError(f"{what}: {k} differs")


def _policies(dp: str):
    """The lowerings every serving phase runs: the default fused-window
    (the main path), fused-window without tile sparsity, fused-network and
    per-step."""
    from repro_torch.core.policies import ExecutionPolicy
    return (ExecutionPolicy(dtype_policy=dp),
            ExecutionPolicy(dtype_policy=dp, tile_sparsity=False),
            ExecutionPolicy(dtype_policy=dp, fusion_policy="fused-network"),
            ExecutionPolicy(dtype_policy=dp, fusion_policy="per-step"))


def phase_golden(dev) -> None:
    """The trained checkpoint through the engine equals the golden npz."""
    import numpy as np
    import torch
    from repro_torch.core.quant import quantize_net
    from repro_torch.core.sne_net import tiny_net
    from repro_torch.data.events_ds import (load_recording,
                                            sample_recording_path,
                                            segment_recording)
    from repro_torch.weights import load_net
    spec = tiny_net()
    params, _ = load_net(sample_recording_path("tiny_gesture_trained.npz"),
                         spec, device=dev)
    qn = quantize_net(params, spec, per_channel=False)
    gold = np.load(GOLDEN)
    for dp in ("f32-carrier", "int8-native"):
        for pol in _policies(dp):
            reqs = segment_recording(load_recording(sample_recording_path()),
                                     qn.spec.in_shape, qn.spec.n_timesteps,
                                     WINDOW_US)
            reqs, _, wall = serve(qn, reqs, pol, 2, dev)
            res = results(reqs)
            for k in gold.files:
                if not np.array_equal(res[k], gold[k]):
                    raise AssertionError(
                        f"trained golden {pol}: {k} differs:\n{res[k]}\n"
                        f"vs\n{gold[k]}")
            log(f"  {pol}: {len(reqs)} requests equal the golden "
                f"({', '.join(gold.files)}), {wall:.3f} s")
    torch.cuda.synchronize()


def _cohort(spec, rate_hz: float, seed0: int, n: int, T: int):
    from repro_torch.data.events_ds import (segment_recording,
                                            synthesize_recording)
    H, W, _ = spec.in_shape
    reqs = []
    for i in range(n):
        rec = synthesize_recording(seed=seed0 + i, width=W, height=H,
                                   duration_us=T * WINDOW_US,
                                   rate_hz=rate_hz, label=i % 11)
        reqs += segment_recording(rec, spec.in_shape, T, WINDOW_US,
                                  uid_base=seed0 + i)
    return reqs


def phase_full_width(spec, qn, dev, smi: str) -> dict:
    """The main path: full-width Fig. 6 serving under every lowering
    (fused-window, the default; fused-network; per-step), both dtype
    policies, every request bitwise equal."""
    import warnings
    import numpy as np
    import torch
    from repro_torch.core import layer_program as lp
    from repro_torch.core.policies import ExecutionPolicy
    from repro_torch.core.quant import quantize_net
    from repro_torch.core.sne_net import dvs_gesture_net, init_snn
    from repro_torch.kernels import LAUNCHES, reset_launch_counts
    T = spec.n_timesteps
    H, W, C = spec.in_shape
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    outputs, report, launches, plans = {}, [], {}, {}
    for fusion in LOWERINGS:
        reset_launch_counts()      # each lowering's run is read on its own
        for dp in ("f32-carrier", "int8-native"):
            for ci, (label, rate) in enumerate(COHORTS):
                reqs = _cohort(spec, rate, 100 * ci, N_SLOTS, T)
                before = dict(LAUNCHES)
                win_ms = []
                with warnings.catch_warnings():
                    if fusion == "fused-network":
                        warnings.simplefilter("error")   # no fallback
                    reqs, eng, wall = serve(
                        qn, reqs, ExecutionPolicy(dtype_policy=dp,
                                                  fusion_policy=fusion),
                        N_SLOTS, dev, win_ms)
                res = results(reqs)
                outputs[(fusion, dp, label)] = res
                n_in = sum(float(r.telemetry.per_layer_events[0])
                           for r in reqs)
                act = n_in / (len(reqs) * T * H * W * C)
                n_launch = sum(LAUNCHES[k] - before[k] for k in LAUNCHES)
                row = {"fusion": fusion, "policy": dp, "cohort": label,
                       "rate_hz": rate, "requests": len(reqs),
                       "input_activity": act, "wall_s": wall,
                       "requests_per_s": len(reqs) / wall,
                       "input_events_per_s": n_in / wall,
                       "windows": len(win_ms),
                       "p50_window_ms": float(np.percentile(win_ms, 50)),
                       "kernel_launches_per_window": n_launch / len(win_ms),
                       "hot_tiles": eng.stats["hot_tiles"],
                       "total_tiles": eng.stats["total_tiles"],
                       "predictions": res["predictions"].tolist()}
                report.append(row)
                log(f"  {fusion} {dp} cohort {label} ({rate:.0f} Hz): "
                    f"activity {act:.4%}, {row['requests_per_s']:.3f} req/s, "
                    f"{row['input_events_per_s']:.0f} input events/s, p50 "
                    f"window {row['p50_window_ms']:.3f} ms, "
                    f"{row['kernel_launches_per_window']:.2f} launches/window,"
                    f" layer-0 tiles hot {row['hot_tiles']}/"
                    f"{row['total_tiles']} [{smi}]")
                counts = res["class_counts"]
                if counts.shape != (len(reqs), spec.n_classes) or \
                        not np.isfinite(counts).all():
                    raise AssertionError(f"bad class counts {counts.shape}")
                if fusion == "fused-network":
                    # one launch per window, of the megakernel alone
                    net = LAUNCHES["network_window"] - before["network_window"]
                    if not (lp.effective_fusion(eng.program) == fusion
                            and n_launch == net == len(win_ms)
                            == eng.stats["step_calls"]
                            == eng.stats["kernel_launches"]):
                        raise AssertionError(
                            f"fused-network {dp} {label}: {n_launch} launches "
                            f"({net} network_window) over {len(win_ms)} "
                            f"windows, {eng.stats['step_calls']} step calls")
                    plan = lp.network_window_plan(eng.program)
                    plans[dp] = {
                        "smem_bytes": plan.smem_bytes,
                        "smem_budget": lp.SMEM_BUDGET,
                        **dataclasses.asdict(plan)}
        torch.cuda.synchronize()
        launches[fusion] = dict(LAUNCHES)
        log(f"  launches on the {fusion} path: {launches[fusion]}")
    peak = torch.cuda.max_memory_allocated(dev)
    log(f"  peak device memory {peak / 2**20:.1f} MiB [{smi}]")
    log(f"  fused-network plan per slot: {plans}")
    for key, res in outputs.items():
        oracle = outputs[("per-step", "f32-carrier", key[2])]
        assert_same(res, oracle, f"{key} vs per-step f32-carrier")
    log("  fused-window, fused-network and per-step, f32-carrier and "
        "int8-native agree bitwise on every request")
    missing = [k for k in LAUNCHES
               if PATH_OF[k] and launches[PATH_OF[k]][k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on their path: "
                             f"{missing}")
    # a kernel of no serving path must not have launched under any lowering
    stray = {k: [launches[f][k] for f in LOWERINGS] for k in LAUNCHES
             if PATH_OF[k] is None and any(launches[f][k] for f in LOWERINGS)}
    if stray:
        raise AssertionError(f"kernels of no serving path launched while "
                             f"serving (per lowering {LOWERINGS}): {stray}")
    # the same path cut to T = 8, served by the card and by the plain CPU
    # path, must agree bitwise
    short = dvs_gesture_net(n_timesteps=8)
    qs = quantize_net(init_snn(np.random.default_rng(0), short, device=dev),
                      short)
    qc = quantize_net(init_snn(np.random.default_rng(0), short,
                               device="cpu"), short)
    for dp in ("f32-carrier", "int8-native"):
        for fusion in LOWERINGS:
            pol = ExecutionPolicy(dtype_policy=dp, fusion_policy=fusion)
            got = results(serve(qs, _cohort(short, 2e6, 7, 2, 8), pol, 2,
                                dev)[0])
            want = results(serve(qc, _cohort(short, 2e6, 7, 2, 8), pol, 2,
                                 torch.device("cpu"))[0])
            assert_same(got, want, f"full width T=8 {pol}: card vs plain CPU")
    log("  full width, T = 8: card equals the plain CPU path, every "
        "lowering, both policies")
    return {"launches": launches, "serving": report, "plans": plans,
            "outputs": outputs, "peak_device_memory_bytes": peak,
            "trace": {fusion: trace_cohort(spec, qn, dev, smi, fusion)
                      for fusion in LOWERINGS}}


def trace_cohort(spec, qn, dev, smi: str, fusion: str) -> dict:
    """Serve the 4.9% cohort once more (f32 carrier, ``fusion``) under
    ``torch.profiler``: see :func:`_device_summary`."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.policies import ExecutionPolicy
    reqs = _cohort(spec, COHORTS[1][1], 100, N_SLOTS, spec.n_timesteps)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, _, wall = serve(qn, reqs, ExecutionPolicy(fusion_policy=fusion),
                           N_SLOTS, dev)
    return _device_summary(prof, wall, f"{fusion} cohort", smi)


def _device_summary(prof, wall: float, what: str, smi: str) -> dict:
    """From a profile over ``wall`` seconds: the device-busy share of the
    traced wall time, the device kernels launched, the device time by
    kernel name of the ten largest, and of each of the port's kernels
    that ran, however small (the trace itself is too large to keep)."""
    kernels = [e for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA")]
    kernel_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]
    out = {"wall_ms": 1e3 * wall, "device_kernel_ms": kernel_ms,
           "device_busy_share": kernel_ms / (1e3 * wall) if kernel_ms
           else None,
           "device_kernel_launches": sum(e.count for e in kernels),
           "top_kernels": [{"name": e.key[:80], "calls": e.count,
                            "device_ms": e.self_device_time_total / 1e3}
                           for e in top],
           "port_kernels": {}}
    for e in kernels:
        for name in SOURCES:
            if f"{name}_kernel" in e.key:
                k = out["port_kernels"].setdefault(name, {"calls": 0,
                                                          "device_ms": 0.0})
                k["calls"] += e.count
                k["device_ms"] += e.self_device_time_total / 1e3
    share = ("not measured (no device time in the trace)"
             if out["device_busy_share"] is None
             else f"{out['device_busy_share']:.2%}")
    log(f"  traced {what}: wall {out['wall_ms']:.1f} ms, device kernels "
        f"{kernel_ms:.1f} ms in {out['device_kernel_launches']} launches, "
        f"device busy {share} [{smi}]")
    for k in out["top_kernels"]:
        log(f"    {k['device_ms']:9.2f} ms  {k['calls']:6d} calls  "
            f"{k['name']}")
    for name, k in out["port_kernels"].items():
        log(f"    port kernel {name}: {k['device_ms']:.2f} ms, "
            f"{k['calls']} calls")
    return out


# ---------------------------------------------------------------------------
# phase 5: the streaming runtime on the card
# ---------------------------------------------------------------------------

def _no_sync(fn):
    """``fn`` run under ``torch.cuda.set_sync_debug_mode("error")``: any
    operation in it that waits on the device raises."""
    import torch

    def strict(*args, **kwargs):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return fn(*args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return strict


def _engine(qn, policy, dev):
    from repro_torch.serve import EventServeEngine
    return EventServeEngine(qn.spec, qn.params_for(policy.dtype_policy),
                            n_slots=N_SLOTS, window=WINDOW, device=dev,
                            policy=policy)


def _runtime(qn, policy, dev):
    """A fresh engine under ``policy`` whose collect and launch phases may
    not wait on the device, wrapped by a ``StreamingRuntime`` with a queue
    of :data:`STREAM_REQUESTS` on a wall clock that starts now (build the
    requests first: arrival times count from the clock's zero)."""
    from repro_torch.serve.runtime import StreamingRuntime, WallClock
    eng = _engine(qn, policy, dev)
    eng._collect_phase = _no_sync(eng._collect_phase)
    eng._launch_phase = _no_sync(eng._launch_phase)
    return StreamingRuntime(eng, queue_capacity=STREAM_REQUESTS,
                            clock=WallClock(), policy=policy), eng


def _same_as_oracle(reqs, oracle: dict, what: str) -> int:
    """Every completed request of ``reqs`` equals the oracle's request of
    its uid, exactly; returns how many completed."""
    import numpy as np
    uids = list(oracle["uids"])
    done = [r for r in reqs if r.done]
    if done:
        rows = [uids.index(r.uid) for r in done]
        assert_same(results(done), {k: np.asarray(v)[rows]
                                    for k, v in oracle.items()
                                    if k != "uids"}, what)
    return len(done)


def _report_line(rep: dict) -> str:
    return (f"p50/p99 window {rep['p50_window_latency_ms']:.3f}/"
            f"{rep['p99_window_latency_ms']:.3f} ms, p50/p99 end to end "
            f"{rep['p50_e2e_latency_ms']:.1f}/{rep['p99_e2e_latency_ms']:.1f}"
            f" ms, mean queue wait {rep['mean_queue_wait_ms']:.1f} ms, "
            f"{rep['sustained_events_per_s']:.0f} events/s sustained")


def _slo_run(qn, policy, dev, oracle, reqs, slo_ms, rate, what, smi):
    """Serve ``reqs`` under an SLO of ``slo_ms``: open loop at ``rate``
    (Poisson, seed 0), or, when ``rate`` is None, all submitted at once,
    the first :data:`N_SLOTS` under ``slo_ms[0]`` and the rest under
    ``slo_ms[1]``; every completed request must equal the oracle
    exactly, and the engine's evictions the runtime's.  Returns the
    report."""
    import torch
    from repro_torch.serve.runtime import PoissonLoadGen
    rt, eng = _runtime(qn, policy, dev)
    eng.evict_slot = _no_sync(eng.evict_slot)
    if rate is None:
        slo = [ms / 1e3 for ms in slo_ms]
        rt.submit(reqs[:N_SLOTS], slo_s=slo[0])
        rt.submit(reqs[N_SLOTS:], slo_s=slo[1])
        rep = rt.serve()
    else:
        slo = slo_ms / 1e3
        rep = rt.serve(PoissonLoadGen(reqs, rate_hz=rate, seed=0, slo_s=slo,
                                      start_s=rt.clock.now()))
    torch.cuda.synchronize()
    n_done = _same_as_oracle(reqs, oracle, what)
    if not (n_done == rep["completed"]
            and eng.stats["evicted"] == rep["evicted_deadline"]):
        raise AssertionError(f"{what}: {rep}, engine {eng.stats}")
    reused = sum(1 for s in rt.requests if s.status == "done"
                 and any(v.status == "evicted" and v.slot == s.slot
                         and v.finish_s <= s.admit_s for v in rt.requests))
    log(f"  {what} {slo_ms} ms: {rep['evicted_deadline']} evicted, "
        f"{rep['expired_in_queue']} expired in the queue, {n_done} "
        f"completed ({reused} in a slot an eviction freed), every completed "
        f"one bitwise equal to sync; {_report_line(rep)} [{smi}]")
    return {**rep, "slo_s": slo, "completed_in_evicted_slots": reused}


def phase_streaming(spec, qn, dev, smi: str) -> dict:
    """The streaming runtime under every lowering and both dtype policies:
    synchronous oracle, closed loop, open loop, and one eviction run."""
    import torch
    from repro_torch.core.policies import ExecutionPolicy
    from repro_torch.kernels import LAUNCHES, reset_launch_counts
    from repro_torch.serve.runtime import PoissonLoadGen
    T = spec.n_timesteps

    base = _cohort(spec, COHORTS[1][1], 100, STREAM_REQUESTS, T)

    def cohort():
        # fresh request objects on the same (read-only) streams: building
        # a full-width cohort takes seconds of host time
        return [dataclasses.replace(r) for r in base]
    rows, launches = [], {}
    for fusion in LOWERINGS:
        runtime_launches = {k: 0 for k in LAUNCHES}
        step_calls = 0
        for dp in ("f32-carrier", "int8-native"):
            pol = ExecutionPolicy(dtype_policy=dp, fusion_policy=fusion)
            what = f"streaming {fusion} {dp}"
            # the synchronous oracle and the closed loop in turns (sync,
            # closed, closed, sync): host time swings between runs
            sync_rps, closed_rps, closed, oracle = [], [], None, None
            for which in ("sync", "closed", "closed", "sync"):
                reqs = cohort()
                if which == "sync":
                    eng = _engine(qn, pol, dev)
                    t0 = time.perf_counter()
                    eng.run(reqs)
                    torch.cuda.synchronize()
                    sync_rps.append(len(reqs) / (time.perf_counter() - t0))
                    if oracle is None:
                        oracle = {"uids": [r.uid for r in reqs],
                                  **results(reqs)}
                    else:
                        _same_as_oracle(reqs, oracle, f"{what} sync again")
                    continue
                reset_launch_counts()
                rt, eng = _runtime(qn, pol, dev)
                t0 = time.perf_counter()
                rt.submit(reqs)
                rep = rt.serve()
                torch.cuda.synchronize()
                closed_rps.append(len(reqs) / (time.perf_counter() - t0))
                for k in LAUNCHES:
                    runtime_launches[k] += LAUNCHES[k]
                step_calls += eng.stats["step_calls"]
                if _same_as_oracle(reqs, oracle, f"{what} closed loop") \
                        != len(reqs):
                    raise AssertionError(f"{what} closed loop: not every "
                                         f"request completed: {rep}")
                closed = closed or rep
            rps_sync = sum(sync_rps) / len(sync_rps)
            ratio = sum(closed_rps) / len(closed_rps) / rps_sync
            row = {"fusion": fusion, "policy": dp, "requests": len(reqs),
                   "sync_requests_per_s": sync_rps,
                   "closed_loop_requests_per_s": closed_rps,
                   "closed_over_sync": ratio, "closed_loop": closed}

            reqs = cohort()
            reset_launch_counts()
            rt, eng = _runtime(qn, pol, dev)
            rate = OPEN_LOOP_LOAD * rps_sync
            opened = rt.serve(PoissonLoadGen(reqs, rate_hz=rate, seed=0,
                                             start_s=rt.clock.now()))
            torch.cuda.synchronize()
            for k in LAUNCHES:
                runtime_launches[k] += LAUNCHES[k]
            step_calls += eng.stats["step_calls"]
            if _same_as_oracle(reqs, oracle, f"{what} open loop") != len(
                    reqs):
                raise AssertionError(f"{what} open loop: not every request "
                                     f"completed: {opened}")
            row["open_loop"] = {**opened, "rate_hz": rate}
            log(f"  {fusion} {dp}: req/s sync, closed, closed, sync "
                f"{sync_rps[0]:.3f}, {closed_rps[0]:.3f}, {closed_rps[1]:.3f},"
                f" {sync_rps[1]:.3f} (closed / sync {ratio:.3f}x); closed "
                f"loop {_report_line(closed)}; open loop at {rate:.3f} "
                f"req/s: {_report_line(opened)}; bitwise equal to sync "
                f"[{smi}]")

            if fusion == "fused-window" and dp == "f32-carrier":
                p50, p99 = (closed[f"p{q}_e2e_latency_ms"] for q in (50, 99))
                row["eviction"] = {
                    # the open loop under an SLO of its p50 end to end:
                    # its latencies are nearly all one service time, so
                    # whether this evicts is up to the host's noise;
                    # reported, every completed request checked
                    "open_loop": _slo_run(qn, pol, dev, oracle, cohort(),
                                          opened["p50_e2e_latency_ms"],
                                          rate, f"{what} open-loop SLO",
                                          smi),
                    # the burst (all submitted at once): the first wave
                    # fills every slot under a quarter of a service time
                    # (the closed loop's p50 end to end is about 1.5 of
                    # them), so it is admitted at once and evicted mid-
                    # service; the second waits for the slots the
                    # evictions free, under four times the closed loop's
                    # p99, so it completes.  Both hold while the host's
                    # speed stays within 4x of the closed loop's: an SLO
                    # between one and two service times did not (its
                    # burst ran 0.73x and 1.5x the loop a run before)
                    "burst": _slo_run(qn, pol, dev, oracle, cohort(),
                                      [p50 / 6, 4 * p99], None,
                                      f"{what} burst SLO", smi)}
                burst = row["eviction"]["burst"]
                if not (burst["evicted_deadline"] >= 1
                        and burst["completed"] >= 1
                        and burst["completed_in_evicted_slots"] >= 1):
                    raise AssertionError(f"{what} burst SLO run: {burst}")
            rows.append(row)
        launches[fusion] = runtime_launches
        missing = [k for k in LAUNCHES
                   if PATH_OF[k] == fusion and runtime_launches[k] == 0]
        if missing:
            raise AssertionError(f"the {fusion} runtime runs launched no "
                                 f"{missing}")
        if fusion == "fused-network" and not (
                sum(runtime_launches.values())
                == runtime_launches["network_window"] == step_calls):
            raise AssertionError(f"fused-network runtime: {runtime_launches}"
                                 f" over {step_calls} windows")
        log(f"  launches of the {fusion} runtime runs: {runtime_launches}")
    torch.cuda.synchronize()
    return {"runs": rows, "launches": launches}


# ---------------------------------------------------------------------------
# phase 7: the single-stream event path at full width
# ---------------------------------------------------------------------------

# the per-step scatter kernels, whose N = 1 faces the event path launches
EVENT_PATH_KERNELS = ("event_conv_batched", "event_pool_batched",
                      "event_fc_batched")
# device kernels one traced inference may launch per boundary and layer
LAUNCHES_PER_BOUNDARY = 40
DTYPE_POLICIES = ("f32-carrier", "int8-native")


def _on(stream, dev):
    from repro_torch.core import events as ev
    return ev.EventStream(*(f.to(dev) for f in stream))


def _stats_rows(stats) -> list:
    """Per-layer ``EConvStats`` as ints (one host read)."""
    import torch
    table = torch.stack([torch.stack(list(st)) for st in stats.per_layer])
    keys = stats.per_layer[0]._fields
    return [dict(zip(keys, row)) for row in table.cpu().tolist()]


def _same_run(a, b, what: str) -> None:
    """Output streams and per-layer counters bitwise equal."""
    import torch
    (sa, sta), (sb, stb) = a, b
    for f, x, y in zip(sa._fields, sa, sb):
        if not torch.equal(x.cpu(), y.cpu()):
            raise AssertionError(f"{what}: output stream field {f} differs")
    if _stats_rows(sta) != _stats_rows(stb):
        raise AssertionError(f"{what}: counters differ: {_stats_rows(sta)} "
                             f"vs {_stats_rows(stb)}")


def _event_golden(dev) -> None:
    """The trained tiny checkpoint through ``event_predict`` on the six
    segments of the bundled recording equals the golden's class counts."""
    import numpy as np
    from repro_torch.core.quant import quantize_net
    from repro_torch.core.sne_net import (default_capacities, event_predict,
                                          tiny_net)
    from repro_torch.data.events_ds import (load_recording,
                                            sample_recording_path,
                                            segment_recording)
    from repro_torch.weights import load_net
    spec = tiny_net()
    params, _ = load_net(sample_recording_path("tiny_gesture_trained.npz"),
                         spec, device=dev)
    qn = quantize_net(params, spec, per_channel=False)
    reqs = segment_recording(load_recording(sample_recording_path()),
                             qn.spec.in_shape, qn.spec.n_timesteps, WINDOW_US)
    gold = np.load(GOLDEN)["class_counts"]
    caps = default_capacities(qn.spec)
    for dp in DTYPE_POLICIES:
        got = np.stack([event_predict(
            qn.params_for(dp), qn.spec, _on(r.stream, dev), caps,
            dtype_policy=dp, device=dev)[1].cpu().numpy() for r in reqs])
        if not np.array_equal(got, gold):
            raise AssertionError(f"event path {dp}: trained golden class "
                                 f"counts differ:\n{got}\nvs\n{gold}")
    log(f"  trained tiny checkpoint: event_predict on {len(reqs)} segments "
        f"equals the golden's class counts under both policies")


def phase_event_path(spec, qn, dev, smi: str, served: dict) -> dict:
    """The single-stream event path at full width: see the module
    docstring, phase 7.  ``served`` holds phase 4's per-request outputs
    keyed ``(lowering, dtype policy, cohort)``."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.econv import EConvParams
    from repro_torch.core.engine import (SneConfig, boundary_time_s,
                                         inference_energy_j, power_w)
    from repro_torch.core.sne_net import (default_capacities, event_apply,
                                          event_predict)
    from repro_torch.kernels import LAUNCHES, reset_launch_counts
    t_phase = time.perf_counter()
    T, L = spec.n_timesteps, len(spec.layers)
    H, W, C = spec.in_shape
    caps = default_capacities(spec, activity=1.0, slack=1.0)
    cfg = SneConfig()
    params = {dp: qn.params_for(dp) for dp in DTYPE_POLICIES}
    torch.cuda.synchronize()
    reset_launch_counts()
    report, cpu_checked = [], []
    for ci, (label, rate) in enumerate(COHORTS):
        reqs = _cohort(spec, rate, 100 * ci, N_SLOTS, T)
        streams = [_on(r.stream, dev) for r in reqs]
        runs = {}
        for dp in DTYPE_POLICIES:
            runs[dp] = [event_apply(params[dp], qn.spec, s, caps,
                                    dtype_policy=dp, device=dev)
                        for s in streams]
            ms, launches, counts, rows = [], [], [], []
            for i, s in enumerate(streams):
                before = {k: LAUNCHES[k] for k in EVENT_PATH_KERNELS}
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                _, cnt, stats = event_predict(params[dp], qn.spec, s, caps,
                                              dtype_policy=dp, device=dev)
                cnt = cnt.cpu().numpy()
                ms.append(1e3 * (time.perf_counter() - t0))
                launches.append(sum(LAUNCHES[k] - before[k]
                                    for k in EVENT_PATH_KERNELS))
                rows.append(_stats_rows(stats))
                counts.append(cnt)
                n_bnd = sum(r["n_boundaries"] for r in rows[-1])
                if launches[-1] > n_bnd + L:
                    raise AssertionError(
                        f"event path {label} {dp} request {i}: "
                        f"{launches[-1]} scatter launches for at most "
                        f"{n_bnd + L} segments")
                if any(r["n_dropped"] for r in rows[-1]):
                    raise AssertionError(f"event path {label} {dp} request "
                                         f"{i} dropped: {rows[-1]}")
                if rows[-1] != _stats_rows(runs[dp][i][1]):
                    raise AssertionError(f"event path {label} {dp} request "
                                         f"{i}: event_predict's counters "
                                         f"differ from event_apply's")
                for (fusion, edp, elabel), res in served.items():
                    if elabel == label and not np.array_equal(
                            res["class_counts"][i], cnt):
                        raise AssertionError(
                            f"event path {label} {dp} request {i}: class "
                            f"counts {cnt} vs the engine's "
                            f"{res['class_counts'][i]} ({fusion} {edp})")
            # one traced inference of the cohort under this policy
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                _, _, stats = event_predict(params[dp], qn.spec, streams[0],
                                            caps, dtype_policy=dp,
                                            device=dev)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            trace = _device_summary(prof, wall, f"event path {label} {dp} "
                                    f"inference", smi)
            traced = _stats_rows(stats)
            bound = LAUNCHES_PER_BOUNDARY * (
                sum(r["n_boundaries"] for r in traced) + L)
            if trace["device_kernel_launches"] > bound:
                raise AssertionError(
                    f"event path {label} {dp}: {trace['device_kernel_launches']}"
                    f" device kernels in one inference > {bound}")
            per_layer = {k: np.mean([[r[k] for r in rr] for rr in rows],
                                    axis=0).tolist() for k in rows[0][0]}
            n_in = float(np.mean([rr[0]["n_update_events"] for rr in rows]))
            act = n_in / (T * H * W * C)
            tot_ev = float(np.sum(per_layer["n_update_events"]))
            n_bnd = float(np.sum(per_layer["n_boundaries"]))
            row = {
                "cohort": label, "rate_hz": rate, "policy": dp,
                "requests": len(reqs), "input_activity": act,
                "p50_ms_per_inference": float(np.percentile(ms, 50)),
                "ms_per_inference": ms,
                "input_events": n_in, "per_layer": per_layer,
                "total": {k: float(np.sum(v)) for k, v in per_layer.items()},
                "scatter_launches_per_inference": float(np.mean(launches)),
                "traced_device_kernel_launches":
                    trace["device_kernel_launches"],
                "traced_launch_bound": bound,
                "traced_device_busy_share": trace["device_busy_share"],
                "trace": trace,
                "sne_model_energy_j": inference_energy_j(cfg, tot_ev, act),
                "sne_model_boundary_energy_j":
                    power_w(cfg, act) * boundary_time_s(cfg, n_bnd),
                "predictions": [int(np.argmax(c)) for c in counts],
                "card": smi}
            report.append(row)
            busy = trace["device_busy_share"]
            log(f"  event path {label} {dp}: activity {act:.4%}, p50 "
                f"{row['p50_ms_per_inference']:.3f} ms per inference; per "
                f"inference {n_in:.0f} input events, update events "
                f"{np.round(per_layer['n_update_events'], 1).tolist()} "
                f"(total {tot_ev:.0f}), SOPs {row['total']['n_sops']:.0f}, "
                f"boundaries {np.round(per_layer['n_boundaries'], 1).tolist()}"
                f", drops {row['total']['n_dropped']:.0f}; scatter launches "
                f"{row['scatter_launches_per_inference']:.1f} (LAUNCHES), "
                f"traced device kernels {trace['device_kernel_launches']} "
                f"(bound {bound}), busy "
                f"{'not measured' if busy is None else f'{busy:.2%}'} "
                f"[{smi}]")
            log(f"    SNE ASIC model's estimate for these counts (not an H100 "
                f"measurement): {row['sne_model_energy_j'] * 1e6:.3f} uJ of "
                f"events + {row['sne_model_boundary_energy_j'] * 1e6:.3f} uJ "
                f"of boundaries per inference")
        for i in range(len(streams)):
            _same_run(runs["f32-carrier"][i], runs["int8-native"][i],
                      f"event path {label} request {i}: f32 vs int8")
        if ci == 0:
            # one request on the card against the same call on the CPU
            for dp in DTYPE_POLICIES:
                t0 = time.perf_counter()
                want = event_apply(
                    [EConvParams(w=p.w.cpu()) for p in params[dp]], qn.spec,
                    reqs[0].stream, caps, dtype_policy=dp, device="cpu")
                _same_run(runs[dp][0], want, f"event path {label} {dp}: "
                          f"card vs CPU")
                cpu_checked.append({"policy": dp, "cpu_s":
                                    time.perf_counter() - t0})
    torch.cuda.synchronize()
    launches = {k: LAUNCHES[k] for k in EVENT_PATH_KERNELS}
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"phase 7: kernels never launched on the event "
                             f"path: {missing}")
    log(f"  16 requests x 2 policies: no drops; class counts equal the "
        f"engine's under all three lowerings; streams and counters bitwise "
        f"across policies; card equals CPU ({cpu_checked}); launches "
        f"{launches}")
    _event_golden(dev)
    wall = time.perf_counter() - t_phase
    log(f"  phase 7 wall {wall:.1f} s [{smi}]")
    return {"capacities": caps, "runs": report, "card_vs_cpu": cpu_checked,
            "launches": launches, "wall_s": wall, "card": smi}


# ---------------------------------------------------------------------------
# phase 6: surrogate-gradient training at full width, and serving its net
# ---------------------------------------------------------------------------

def _dense_spy():
    """A dispatch mode that records, for every operation it sees (the
    backward's included), the devices of its tensor arguments, the cuDNN
    flags in force at each convolution and the float32 matmul precision
    at each matmul."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    # the copies that move weights, checkpoints and read-backs between
    # host and card, and views of their host ends; every other operation
    # must take card tensors only
    transfers = {"_to_copy", "copy_", "lift_fresh", "lift_fresh_copy",
                 "_local_scalar_dense", "detach", "alias"}

    class Spy(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.on_card, self.off_card = 0, set()
            self.convs, self.matmuls = [], set()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = str(func)
            op = name.split(".")[1] if "." in name else name
            devs = {a.device.type for a in args
                    if isinstance(a, torch.Tensor)}
            if (kwargs or {}).get("device") is not None:
                devs.add(torch.device(kwargs["device"]).type)
            if op not in transfers:
                if devs - {"cuda"}:
                    self.off_card.add((name, tuple(sorted(devs))))
                else:
                    self.on_card += 1
            if op.startswith("convolution"):
                b = torch.backends.cudnn
                self.convs.append((name, b.enabled, b.allow_tf32,
                                   b.deterministic, b.benchmark))
            elif op in ("mm", "addmm", "bmm", "matmul"):
                self.matmuls.add(torch.get_float32_matmul_precision())
            return func(*args, **(kwargs or {}))

        def check(self, what: str) -> None:
            """Fail unless every operation but a host transfer ran on the
            card, every convolution inside ``dense_math``'s scope (cuDNN
            off, TF32 off, deterministic, no autotuning) and every matmul
            in float32."""
            if self.off_card or self.on_card < 100:
                raise AssertionError(
                    f"{what}: {self.on_card} operations on the card; off "
                    f"it: {sorted(self.off_card)[:5]}")
            kinds = {c[0] for c in self.convs}
            if not any("backward" in k for k in kinds):
                raise AssertionError(f"{what}: no convolution backward seen "
                                     f"({kinds})")
            bad = [c for c in self.convs
                   if c[1:] != (False, False, True, False)]
            if bad:
                raise AssertionError(
                    f"{what}: convolutions outside the dense path's scope "
                    f"(cuDNN off, no TF32, deterministic, no autotuning; "
                    f"enabled, allow_tf32, deterministic, benchmark): "
                    f"{bad[:3]}")
            if self.matmuls != {"highest"}:
                raise AssertionError(f"{what}: matmul precision "
                                     f"{self.matmuls}")
    return Spy()


def _dyadic_net(spec, rng):
    """Weights on a 2^-k grid (k from the fan-in, |code| <= 7, code 7 in
    every layer), so every partial sum and every fake-quantised weight is
    exact in float32 whatever the order of summation."""
    import math
    import numpy as np
    out = []
    for l in spec.layers:
        if l.kind == "pool":
            out.append(np.ones(l.weight_shape, np.float32))
            continue
        q = rng.integers(-7, 8, l.weight_shape)
        q.reshape(-1)[0] = 7
        k = max(3, math.ceil(math.log2(l.fan_in) / 2))
        out.append((q * 2.0 ** -k).astype(np.float32))
    return out


def _card_against_cpu(spec, cfg, dev) -> dict:
    """One train-mode forward and backward of a B = 2 batch from dyadic
    weights, on the card (under the spy) and on the CPU: every layer's
    spikes bitwise equal; gradients within rtol 1e-4 plus 1e-6 of the
    layer's largest gradient (float32 sums of up to 2x10^5 terms in
    other orders)."""
    import numpy as np
    import torch
    from repro_torch.core.econv import EConvParams, dense_math
    from repro_torch.core.layer_program import (compile_program,
                                                dense_program_forward)
    from repro_torch.core.sne_net import ce_loss
    from repro_torch.data.events_ds import DVS_GESTURE, batch_at
    arrays = _dyadic_net(spec, np.random.default_rng(6))
    x, lab = batch_at(cfg.seed, 0, 2, DVS_GESTURE, device=dev)
    got = []
    for d in (dev, torch.device("cpu")):
        leaves = [torch.from_numpy(a).to(d).requires_grad_() for a in arrays]
        program, xd, ld = compile_program(spec, device=d), x.to(d), lab.to(d)
        spy = _dense_spy()
        with spy, dense_math():
            out, acts = dense_program_forward(
                program, [EConvParams(w=w) for w in leaves], xd, train=True,
                qat=cfg.qat)
            loss = ce_loss(out, ld).mean()
            grads = torch.autograd.grad(loss, leaves)
        if d.type == "cuda":
            torch.cuda.synchronize()
            spy.check("card step")
        got.append(([a.detach().cpu() for a in acts],
                    [g.cpu() for g in grads], float(loss.detach())))
    (ga, gg, gl), (ca, cg, cl) = got
    for i, (a, b) in enumerate(zip(ga, ca)):
        if not torch.equal(a, b):
            raise AssertionError(f"card vs CPU: layer {i} spikes differ")
    worst, beyond = 0.0, 0
    for i, (a, b) in enumerate(zip(gg, cg)):
        err = (a - b).abs()
        lim = 1e-4 * b.abs() + 1e-6 * float(b.abs().max())
        if not bool((err <= lim).all()):
            raise AssertionError(f"card vs CPU: layer {i} gradients differ "
                                 f"(max abs err {float(err.max()):.3e})")
        worst = max(worst, float(err.max() / b.abs().max().clamp(min=1e-30)))
        beyond += int((err > 1e-4 * b.abs()).sum())
    acts_mean = [float(a.mean()) for a in ga]
    n_grads = sum(g.numel() for g in cg)
    log(f"  card vs CPU, one step at B = 2 (dyadic weights): spikes bitwise "
        f"(layer activity {[round(m, 4) for m in acts_mean]}), loss "
        f"{gl!r} vs {cl!r}; largest gradient error {worst:.3e} of its "
        f"layer's largest gradient, {beyond} of {n_grads} gradients beyond "
        f"rtol 1e-4 alone; every op on the card, convolutions float32 and "
        f"deterministic, cuDNN off")
    return {"loss_card": gl, "loss_cpu": cl, "max_scaled_grad_err": worst,
            "grads_beyond_rtol": beyond, "grads": n_grads,
            "layer_activity": acts_mean}


def _trace_train_step(spec, cfg, params, dev, smi: str) -> dict:
    """One more train step (batch ``cfg.steps``, fresh optimizer state)
    under ``torch.profiler``, after an untraced one: see
    :func:`_device_summary`."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.layer_program import compile_program
    from repro_torch.data.events_ds import DVS_GESTURE, batch_at
    from repro_torch.train.snn_loop import init_opt, make_train_step
    step = make_train_step(compile_program(spec, device=dev), cfg)
    x, lab = batch_at(cfg.seed, cfg.steps, cfg.batch, DVS_GESTURE,
                      device=dev)
    float(step(params, init_opt(params, cfg), x, lab)[2]["loss"])
    opt = init_opt(params, cfg)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        float(step(params, opt, x, lab)[2]["loss"])
        wall = time.perf_counter() - t0
    return _device_summary(prof, wall, f"train step (B = {cfg.batch})",
                           smi)


def phase_training(dev, smi: str) -> dict:
    """Train the full-width Fig. 6 net, resume it bitwise, evaluate it, and
    serve its quantised net bitwise under every lowering."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    from repro_torch.core.policies import ExecutionPolicy
    from repro_torch.core.quant import quantize_net
    from repro_torch.core.sne_net import (dense_apply, dvs_gesture_net,
                                          init_snn, spike_counts)
    from repro_torch.data.events_ds import DVS_GESTURE, batch_at
    from repro_torch.kernels import LAUNCHES, reset_launch_counts
    from repro_torch.serve.event_engine import EventRequest
    from repro_torch.train.snn_loop import TrainConfig, evaluate, fit
    t0 = time.perf_counter()
    spec = dvs_gesture_net()
    cfg = TrainConfig(steps=6, batch=8, qat=True)
    card_cpu = _card_against_cpu(spec, cfg, dev)

    ckpt = tempfile.mkdtemp(prefix="sne_train_")
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        first = fit(spec, DVS_GESTURE, cfg, ckpt_dir=ckpt, ckpt_every=3,
                    device=dev, log_fn=log)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev)
        shutil.rmtree(os.path.join(ckpt, f"step_{cfg.steps:08d}"))
        spy = _dense_spy()
        with spy:
            second = fit(spec, DVS_GESTURE, cfg, ckpt_dir=ckpt,
                         ckpt_every=3, device=dev, log_fn=log)
            torch.cuda.synchronize()
        spy.check("resumed fit")
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    losses = first.losses
    if len(losses) != cfg.steps or not np.isfinite(losses).all():
        raise AssertionError(f"training losses {losses}")
    init = init_snn(np.random.default_rng(cfg.seed), spec, device=dev)
    for i, (p0, p1, l) in enumerate(zip(init, first.params, spec.layers)):
        if p1.w.device != dev:
            raise AssertionError(f"layer {i} trained on {p1.w.device}")
        if torch.equal(p0.w, p1.w) != (l.kind == "pool"):
            raise AssertionError(f"layer {i} ({l.kind}): pool weights must "
                                 f"stay bitwise, conv/fc weights must move")
    if second.start_step != 3 or not np.array_equal(second.losses,
                                                    losses[3:]):
        raise AssertionError(f"resume: start {second.start_step}, losses "
                             f"{second.losses} vs {losses[3:]}")
    for i, (a, b) in enumerate(zip(first.params, second.params)):
        if not torch.equal(a.w, b.w):
            raise AssertionError(f"resume: layer {i} weights differ")
    step_ms = 1e3 * np.asarray(first.step_s)
    p50 = float(np.percentile(step_ms[1:], 50))
    n_in = [float(batch_at(cfg.seed, i, cfg.batch, DVS_GESTURE,
                           device=dev)[0].sum()) for i in range(1, cfg.steps)]
    events_per_s = sum(n_in) / (1e-3 * float(step_ms[1:].sum()))
    log(f"  trained {cfg.steps} steps of B = {cfg.batch}, QAT: losses "
        f"{losses.tolist()}; step ms {np.round(step_ms, 3).tolist()}; p50 of "
        f"steps 2-{cfg.steps} {p50:.3f} ms, {cfg.batch / p50 * 1e3:.3f} "
        f"samples/s, {events_per_s:.0f} input events/s trained; peak device "
        f"memory {peak / 2**20:.1f} MiB [{smi}]")
    log(f"  resumed from step 3: losses {second.losses.tolist()} and final "
        f"weights bitwise the uninterrupted run's; every op of the resumed "
        f"steps on the card, convolutions float32 and deterministic, cuDNN "
        f"off")

    trace = _trace_train_step(spec, cfg, first.params, dev, smi)

    x, _ = batch_at(1, 10 ** 6, 16, DVS_GESTURE, device=dev)
    acc = evaluate(spec, first.params, DVS_GESTURE, n=16, qat=True,
                   device=dev)
    log(f"  evaluate on 16 held-out samples: accuracy {acc:.4f} (chance "
        f"{1 / spec.n_classes:.4f}; 6 steps)")

    qn = quantize_net(first.params, spec, per_channel=False)
    xs = x[:8]
    with torch.no_grad():
        want = spike_counts(dense_apply(qn.params_for("f32-carrier"),
                                        qn.spec, xs)[0]).cpu().numpy()
    runs, launches = {}, {}
    for fusion in LOWERINGS:
        reset_launch_counts()
        for dp in ("f32-carrier", "int8-native"):
            reqs = [EventRequest.from_dense(i, xs[i].cpu())
                    for i in range(len(xs))]
            reqs, _, wall = serve(qn, reqs, ExecutionPolicy(
                dtype_policy=dp, fusion_policy=fusion), N_SLOTS, dev)
            runs[(fusion, dp)] = results(reqs)
            log(f"  served the trained net, {fusion} {dp}: {len(reqs)} "
                f"requests in {wall:.3f} s")
        torch.cuda.synchronize()
        launches[fusion] = dict(LAUNCHES)
    missing = [k for k in LAUNCHES if PATH_OF[k]
               and launches[PATH_OF[k]][k] == 0]
    if missing:
        raise AssertionError(f"phase 6: kernels never launched on their "
                             f"path: {missing}")
    oracle = runs[("per-step", "f32-carrier")]
    for key, res in runs.items():
        assert_same(res, oracle, f"trained net {key} vs per-step f32")
    counts = oracle["class_counts"]
    clean = [i for i in range(len(xs))
             if oracle["input_dropped"][i] == 0
             and not oracle["inter_layer_dropped"][i].any()]
    if not clean:
        raise AssertionError("every request of the trained net dropped "
                             "events: nothing to hold against the dense "
                             "forward")
    for i in clean:
        if not np.array_equal(counts[i].astype(np.float64),
                              want[i].astype(np.float64)):
            raise AssertionError(f"request {i}: served {counts[i]} vs the "
                                 f"card's dense forward {want[i]}")
    log(f"  the trained net's class counts agree bitwise across the three "
        f"lowerings and both dtype policies; {len(clean)} of {len(xs)} "
        f"requests had no drop and equal the card's dense forward; "
        f"{len(xs) - len(clean)} requests had drops; launches per lowering "
        f"{launches}")
    wall = time.perf_counter() - t0
    log(f"  phase 6 wall {wall:.1f} s (kernels already built) [{smi}]")
    return {"steps": cfg.steps, "batch": cfg.batch, "qat": cfg.qat,
            "losses": losses.tolist(), "step_ms": step_ms.tolist(),
            "p50_step_ms": p50, "samples_per_s": cfg.batch / p50 * 1e3,
            "input_events_per_s": events_per_s,
            "peak_device_memory_bytes": peak, "eval_accuracy": acc,
            "served_requests": len(xs), "requests_with_drops":
                len(xs) - len(clean), "launches": launches,
            "card_vs_cpu": card_cpu, "trace": trace, "wall_s": wall,
            "card": smi}


# ---------------------------------------------------------------------------
# phase 8: the mesh backend, slot shards on the card
# ---------------------------------------------------------------------------

# (cohort index, shards): the 1.2% cohort at D = 2 and 4, the 4.9% at D = 2
MESH_RUNS = ((0, 2), (0, 4), (1, 2))
# ragged requests, (timesteps, timesteps with events): the router deals
# them to the two shards in turn, so shard 1 (odd positions, at most 20
# windows) runs dry five windows before shard 0, and four requests fall
# idle while their shard's other slots still step (frozen rows)
RAGGED = ((100, 100), (20, 20), (60, 24), (48, 48), (12, 12), (60, 40),
          (100, 40), (80, 80))


def _fresh(reqs):
    """New request objects on the same (read-only) streams."""
    return [dataclasses.replace(r, done=False, class_counts=None,
                                prediction=None, telemetry=None)
            for r in reqs]


def _mesh_engine(qn, policy, devices):
    """A mesh engine of :data:`N_SLOTS` slots over ``devices`` under
    ``policy`` (its backend set to ``"mesh"``)."""
    from repro_torch.serve import EventServeEngine
    pol = dataclasses.replace(policy, backend="mesh")
    return EventServeEngine(qn.spec, qn.params_for(pol.dtype_policy),
                            n_slots=N_SLOTS, window=WINDOW, policy=pol,
                            devices=devices)


def _ragged(spec, rate_hz: float):
    from repro_torch.data.events_ds import (segment_recording,
                                            synthesize_recording)
    H, W, _ = spec.in_shape
    reqs = []
    for i, (T, active) in enumerate(RAGGED):
        rec = synthesize_recording(seed=900 + i, width=W, height=H,
                                   duration_us=active * WINDOW_US,
                                   rate_hz=rate_hz, label=i % 11)
        reqs += segment_recording(rec, spec.in_shape, T, WINDOW_US,
                                  uid_base=900 + i)
    return reqs


def _mesh_counts(eng, what: str) -> dict:
    """The mesh's counters after a run whose launch counts were set to 0
    just before it: the two paths add up to its windows, and the real
    launches (``LAUNCHES``, and the mesh's ``device_kernel_launches``)
    are D per counted launch of the global path plus the shards' own."""
    from repro_torch.kernels import LAUNCHES
    st = eng.stats
    own = sum(sh.stats["kernel_launches"] for sh in eng.shards)
    real = sum(LAUNCHES.values())
    want = eng.D * (st["kernel_launches"] - own) + own
    if st["mesh_global_windows"] + st["mesh_shard_windows"] \
            != st["windows"] or not real == want \
            == st["device_kernel_launches"]:
        raise AssertionError(f"{what}: {real} launches, expected {want}; "
                             f"stats {st}")
    return {"windows": st["windows"],
            "mesh_global_windows": st["mesh_global_windows"],
            "mesh_shard_windows": st["mesh_shard_windows"],
            "counted_launches": st["kernel_launches"],
            "real_launches": real,
            "skipped_slot_windows": st["skipped_slot_windows"]}


def phase_mesh(spec, qn, dev, smi: str, main_path: dict) -> dict:
    """The mesh backend (``ExecutionPolicy(backend="mesh")``) at full
    width on one card with repeated devices: see the module docstring,
    phase 8.  ``main_path`` is phase 4's result: its per-request outputs
    are the oracle, its serving rows the local numbers shown beside."""
    import warnings
    import numpy as np
    import torch
    from repro_torch.core.policies import ExecutionPolicy
    from repro_torch.kernels import LAUNCHES, reset_launch_counts
    from repro_torch.serve.runtime import StreamingRuntime, WallClock
    t_phase = time.perf_counter()
    T = spec.n_timesteps
    outputs = main_path["outputs"]
    local = {(r["fusion"], r["policy"], r["cohort"]): r
             for r in main_path["serving"]}
    cohorts = {label: _cohort(spec, rate, 100 * ci, N_SLOTS, T)
               for ci, (label, rate) in enumerate(COHORTS)}
    torch.cuda.synchronize()
    mesh_launches = {k: 0 for k in LAUNCHES}

    def run(eng, reqs, what, window_ms=None):
        """Drive ``eng`` (launch counts set to 0 just before, read just
        after) and check its counters."""
        reset_launch_counts()
        with warnings.catch_warnings():
            if eng.fusion_policy == "fused-network":
                warnings.simplefilter("error")       # no fallback
            reqs, _, wall = drive(eng, reqs, window_ms)
        for k in LAUNCHES:
            mesh_launches[k] += LAUNCHES[k]
        return reqs, wall, _mesh_counts(eng, what)

    rows = []
    by_lowering = {f: {k: 0 for k in LAUNCHES} for f in LOWERINGS}
    for ci, D in MESH_RUNS:
        label = COHORTS[ci][0]
        for fusion in LOWERINGS:
            for dp in DTYPE_POLICIES:
                pol = ExecutionPolicy(dtype_policy=dp, fusion_policy=fusion)
                what = f"mesh D={D} {fusion} {dp} cohort {label}"
                win_ms = []
                reqs, wall, counts = run(
                    _mesh_engine(qn, pol, [dev] * D),
                    _fresh(cohorts[label]), what, win_ms)
                for k in LAUNCHES:
                    by_lowering[fusion][k] += LAUNCHES[k]
                assert_same(results(reqs), outputs[(fusion, dp, label)],
                            f"{what} vs phase 4's local engine")
                loc = local[(fusion, dp, label)]
                row = {"shards": D, "fusion": fusion, "policy": dp,
                       "cohort": label, "requests": len(reqs),
                       "wall_s": wall, "requests_per_s": len(reqs) / wall,
                       "p50_window_ms": float(np.percentile(win_ms, 50)),
                       "local_p50_window_ms": loc["p50_window_ms"],
                       "local_requests_per_s": loc["requests_per_s"],
                       **counts}
                rows.append(row)
                log(f"  {what}: p50 window {row['p50_window_ms']:.3f} ms "
                    f"(local {loc['p50_window_ms']:.3f}), "
                    f"{row['requests_per_s']:.3f} req/s (local "
                    f"{loc['requests_per_s']:.3f}); windows global "
                    f"{counts['mesh_global_windows']} / per-shard "
                    f"{counts['mesh_shard_windows']}, launches counted "
                    f"{counts['counted_launches']}, real "
                    f"{counts['real_launches']}; bitwise equal to phase 4 "
                    f"[{smi}]")
    missing = [k for k in LAUNCHES if PATH_OF[k]
               and by_lowering[PATH_OF[k]][k] == 0]
    if missing:
        raise AssertionError(f"mesh runs launched no {missing}")

    # both paths in one run: ragged requests against the local engine
    ragged = _ragged(spec, COHORTS[1][1])
    both = []
    for fusion in LOWERINGS:
        for dp in DTYPE_POLICIES:
            pol = ExecutionPolicy(dtype_policy=dp, fusion_policy=fusion)
            what = f"mesh D=2 ragged {fusion} {dp}"
            want = results(serve(qn, _fresh(ragged), pol, N_SLOTS, dev)[0])
            reqs, _, counts = run(_mesh_engine(qn, pol, [dev] * 2),
                                  _fresh(ragged), what)
            assert_same(results(reqs), want, f"{what} vs the local engine")
            if not (counts["mesh_global_windows"] > 0
                    and counts["mesh_shard_windows"] > 0
                    and counts["skipped_slot_windows"] > 0):
                raise AssertionError(f"{what}: not both paths: {counts}")
            both.append({"fusion": fusion, "policy": dp, **counts})
    log(f"  ragged requests (timesteps, with events) {RAGGED} at D = 2: "
        f"both paths taken under every lowering and policy, idle slots "
        f"frozen on the global path, every answer bitwise the local "
        f"engine's: {[(b['mesh_global_windows'], b['mesh_shard_windows']) for b in both]}"
        f" (global, per-shard) windows")

    # an idle shard launches nothing
    eng = _mesh_engine(qn, ExecutionPolicy(), [dev] * 2)
    (req,) = _fresh(cohorts["1.2%"][:1])
    if not eng.try_admit(req, slot=0):
        raise AssertionError("slot 0 of an empty mesh refused a request")
    reset_launch_counts()
    for _ in range(4 * T):
        if req.done:
            break
        eng.step()
    torch.cuda.synchronize()
    for k in LAUNCHES:
        mesh_launches[k] += LAUNCHES[k]
    real = sum(LAUNCHES.values())
    st, own0 = eng.stats, eng.shards[0].stats["kernel_launches"]
    if not (req.done and st["mesh_global_windows"] == 0
            and eng.shards[1].stats["kernel_launches"] == 0
            and real == own0 == st["device_kernel_launches"] > 0):
        raise AssertionError(f"idle shard: done {req.done}, {real} launches, "
                             f"shard 0 {own0}, stats {st}")
    assert_same(results([req]),
                {k: v[:1] for k, v in
                 outputs[("fused-window", "f32-carrier", "1.2%")].items()},
                "the pinned request vs phase 4")
    idle = {"windows": st["windows"], "launches": real,
            "shard0_launches": own0, "shard1_launches": 0}
    log(f"  one request pinned to slot 0 at D = 2: {st['windows']} windows, "
        f"all per-shard; shard 0 launched {own0} (LAUNCHES {real}), shard 1 "
        f"nothing; answer bitwise phase 4's")

    # the streaming runtime over the mesh, closed loop, no device wait in
    # collect or launch
    labels = [c[0] for c in COHORTS]
    oracle = {"uids": [r.uid for l in labels for r in cohorts[l]],
              **{k: np.concatenate([
                  outputs[("fused-window", "f32-carrier", l)][k]
                  for l in labels]) for k in outputs[
                  ("fused-window", "f32-carrier", labels[0])]}}
    mpol = ExecutionPolicy(backend="mesh")
    eng = _mesh_engine(qn, mpol, [dev] * 2)
    eng._collect_phase = _no_sync(eng._collect_phase)
    eng._launch_phase = _no_sync(eng._launch_phase)
    rt = StreamingRuntime(eng, queue_capacity=2 * N_SLOTS, clock=WallClock(),
                          policy=mpol)
    reqs = _fresh([r for l in labels for r in cohorts[l]])
    reset_launch_counts()
    t0 = time.perf_counter()
    rt.submit(reqs)
    rep = rt.serve()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for k in LAUNCHES:
        mesh_launches[k] += LAUNCHES[k]
    counts = _mesh_counts(eng, "runtime over mesh")
    if _same_as_oracle(reqs, oracle, "runtime over the mesh") != len(reqs):
        raise AssertionError(f"runtime over the mesh: not every request "
                             f"completed: {rep}")
    runtime = {"requests": len(reqs), "wall_s": wall,
               "requests_per_s": len(reqs) / wall, "report": rep, **counts}
    log(f"  StreamingRuntime closed loop over the D = 2 mesh, "
        f"{len(reqs)} requests (both cohorts): {runtime['requests_per_s']:.3f}"
        f" req/s; {_report_line(rep)}; collect and launch under "
        f"sync-debug 'error'; every request bitwise phase 4's [{smi}]")

    # one shard per distinct card, where there are several
    n_cards = torch.cuda.device_count()
    distinct = None
    if n_cards >= 2:
        label = COHORTS[0][0]
        reqs, wall, counts = run(_mesh_engine(qn, ExecutionPolicy(), None),
                                 _fresh(cohorts[label]),
                                 "mesh over every card")
        assert_same(results(reqs),
                    outputs[("fused-window", "f32-carrier", label)],
                    "mesh over every card vs phase 4")
        distinct = {"cards": n_cards, "wall_s": wall, **counts}
        log(f"  one shard per card over {n_cards} cards: bitwise phase 4's")
    else:
        log("  only one card is visible: the distinct-card case "
            "(devices=None, one shard per card) did not run")
    wall = time.perf_counter() - t_phase
    log(f"  phase 8 wall {wall:.1f} s [{smi}]")
    return {"runs": rows, "ragged": both, "idle_shard": idle,
            "runtime": runtime, "distinct_cards": distinct,
            "launches": mesh_launches, "wall_s": wall, "card": smi}


# ---------------------------------------------------------------------------
# phase 9: LM serving at full width (recurrentgemma-2b)
# ---------------------------------------------------------------------------

LM_ARCH = "recurrentgemma-2b"
LM_SLOTS, LM_CACHE = 4, 4096
LM_REQUESTS, LM_TOKENS = 8, 32
LM_PROMPT_LENS = (256, 3000)   # numpy seed 0 draws each prompt's length
LM_FORCED = 16                 # decode steps held to the teacher-forced forward
LM_SD_FRAC = 0.25
LM_F32_ATOL = 1e-4             # float32 card vs CPU, TF32 off


def _bf16_tol(want, n_adds: int) -> float:
    """Two bfloat16 runs of one model that round in other places (GEMMs of
    other shapes, blockwise vs single-row attention, scan vs step) drift
    apart like a random walk over its residual adds (2L for L layers of a
    mixer and an FFN): four standard deviations of a 2^-8 relative
    rounding over ``n_adds`` steps, at the logits' scale (the rule of
    tests/test_torch_lm.py's bf16 case)."""
    import numpy as np
    return 4 * 2.0 ** -8 * n_adds ** 0.5 * max(
        1.0, float(np.abs(want).max()))


class _Recorder:
    """Records every sampling call of a ``ServeEngine``: the request it
    serves, its logits (host float32) and the engine's own choice, and
    times each ``step`` (host wall, which ends in the step's one device
    read) and each prefill (synchronised).  With ``forced`` ({uid: tokens})
    the engine takes those tokens instead of its own (teacher forcing)."""

    def __init__(self, eng, forced=None):
        import numpy as np
        import torch
        self.calls, self.step_s, self.prefill = [], [], []
        own_sample, own_admit = eng._sample, eng.try_admit
        own_step, own_prefill = eng.step, eng._prefill
        ctx = []

        def sample(logits):
            uid = ctx.pop(0)
            choice = own_sample(logits)
            n = len(self.by_uid(uid))
            self.calls.append((uid, logits.copy(), choice))
            return int(forced[uid][n]) if forced else choice

        def try_admit(req):
            ctx[:] = [req.uid]
            return own_admit(req)

        def step():
            ctx[:] = [eng.slot_req[s].uid for s in np.nonzero(eng.active)[0]]
            t0 = time.perf_counter()
            n = own_step()
            if n:
                self.step_s.append((time.perf_counter() - t0, n))
            return n

        def prefill(tokens):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = own_prefill(tokens)
            torch.cuda.synchronize()
            self.prefill.append((time.perf_counter() - t0, tokens.shape[1]))
            return out

        eng._sample, eng.try_admit = sample, try_admit
        eng.step, eng._prefill = step, prefill

    def by_uid(self, uid):
        return [(lg, c) for u, lg, c in self.calls if u == uid]

    def p50_step_ms(self) -> float:
        import numpy as np
        return 1e3 * float(np.median([s for s, _ in self.step_s]))


def _lm_requests(cfg, n=LM_REQUESTS, lens=LM_PROMPT_LENS,
                 max_tokens=LM_TOKENS):
    """``n`` requests (numpy seed 0 draws each prompt's length in ``lens``,
    then the prompts)."""
    import numpy as np
    from repro_torch.serve.engine import Request
    rng = np.random.default_rng(0)
    sizes = rng.integers(lens[0], lens[1] + 1, size=n)
    return [Request(i, rng.integers(2, cfg.vocab_size, size=int(k)),
                    max_tokens) for i, k in enumerate(sizes)]


def _lm_serve(cfg, params, dev, forced=None, slots=LM_SLOTS,
              cache_len=LM_CACHE, reqs=None):
    from repro_torch.serve.engine import ServeEngine
    eng = ServeEngine(cfg, params, batch_slots=slots, cache_len=cache_len,
                      device=dev)
    rec = _Recorder(eng, forced)
    reqs = _lm_requests(cfg) if reqs is None else reqs
    t0 = time.perf_counter()
    eng.run(reqs)
    return eng, rec, reqs, time.perf_counter() - t0


def _lm_against(rec, plain, n_layers: int, what: str) -> dict:
    """A teacher-forced run's logits against the plain run's, call for
    call: the largest difference, the bf16 tolerance, and how many of the
    run's own tokens equal the plain ones (all wherever the plain top-2
    margin exceeds twice the tolerance)."""
    import numpy as np
    worst, same, flips_allowed = 0.0, 0, 0
    if [c[0] for c in rec.calls] != [c[0] for c in plain.calls]:
        raise AssertionError(f"{what}: the sampling calls differ")
    for (_, lg, mine), (_, plg, theirs) in zip(rec.calls, plain.calls):
        tol = _bf16_tol(plg, 2 * n_layers)
        diff = float(np.abs(lg - plg).max())
        worst = max(worst, diff / tol)
        top = np.sort(plg)[-2:]
        if mine == theirs:
            same += 1
        elif top[1] - top[0] > 2 * tol:
            raise AssertionError(f"{what}: token {mine} != {theirs} with a "
                                 f"margin {top[1] - top[0]:.4f} > 2 x tol")
        else:
            flips_allowed += 1
    return {"worst_diff_over_tol": worst, "same_tokens": same,
            "calls": len(rec.calls), "near_tie_flips": flips_allowed}


def _lm_card_vs_cpu(dev) -> float:
    """The float32 smoke config from the same weights on the card and on
    the CPU (TF32 off): prefill and 8 decode steps; the largest logit
    difference."""
    import numpy as np
    import torch
    from repro_torch.configs import get_smoke
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import tree_map
    cfg = get_smoke(LM_ARCH)
    p = T.init_model(torch.Generator().manual_seed(0), cfg, "cpu")
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, size=(2, 28)))
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        out = {}
        for d, params in (("cpu", p), (dev, tree_map(lambda w: w.to(dev),
                                                     p))):
            t = toks.to(d)
            lg, cache, _ = T.prefill(params, cfg, t[:, :20], cache_len=32)
            rows = [lg]
            for i in range(20, 28):
                lg, cache, _ = T.decode_step(params, cfg, cache,
                                             t[:, i:i + 1], i)
                rows.append(lg)
            out[str(d)] = torch.cat(rows, 1).cpu()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return float((out["cpu"] - out[str(dev)]).abs().max())


def phase_lm(dev, smi: str) -> dict:
    """Phase 9 (see the module docstring): full-width recurrentgemma-2b
    served by ``ServeEngine`` in bfloat16."""
    import dataclasses
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.core.sd_decode import read_bytes_per_layer
    from repro_torch.kernels import LAUNCHES, reset_launch_counts
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import tree_leaves
    from repro_torch.serve.engine import Request, ServeEngine
    t_phase = time.perf_counter()
    reset_launch_counts()
    cfg = get_config(LM_ARCH)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    params = T.init_model(torch.Generator(device=dev).manual_seed(0), cfg,
                          dev)
    n_params = T.param_count(cfg)
    weight_bytes = sum(w.numel() * w.element_size()
                       for _, w in tree_leaves(params))
    log(f"  {LM_ARCH}: {n_params} parameters, {weight_bytes / 1e9:.3f} GB "
        f"of {cfg.dtype} weights, {cfg.n_layers} layers, d_model "
        f"{cfg.d_model} [{smi}]")
    # warm the GEMM and allocator paths on a short request (not measured)
    warm = ServeEngine(cfg, params, batch_slots=LM_SLOTS, cache_len=LM_CACHE,
                       device=dev)
    warm.run([Request(-1, np.arange(2, 2 + LM_PROMPT_LENS[0]), 4)])

    eng, plain, reqs, wall = _lm_serve(cfg, params, dev)
    for r in reqs:
        n = len(r.out_tokens)
        if not r.done or (n != LM_TOKENS and r.out_tokens[-1] != eng.eos):
            raise AssertionError(f"phase 9: request {r.uid} ended with {n} "
                                 f"tokens, done={r.done}")
    tokens = {r.uid: r.out_tokens for r in reqs}
    pre_s = sum(s for s, _ in plain.prefill)
    pre_tok = sum(n for _, n in plain.prefill)
    dec_s = sum(s for s, _ in plain.step_s)
    dec_tok = sum(n for _, n in plain.step_s)
    p50 = plain.p50_step_ms()
    cache_bytes = sum(t.numel() * t.element_size()
                      for _, t in tree_leaves(eng.cache))
    bound_ms = 1e3 * (weight_bytes + cache_bytes) / HBM_BYTES_PER_S
    peak = torch.cuda.max_memory_allocated(dev)
    log(f"  served {len(reqs)} requests ({[len(r.prompt) for r in reqs]} "
        f"prompt tokens) on {LM_SLOTS} slots, cache {LM_CACHE}: "
        f"{eng.stats}, wall {wall:.2f} s [{smi}]")
    log(f"  prefill {pre_tok} tokens in {pre_s:.3f} s: "
        f"{pre_tok / pre_s:.1f} tokens/s [{smi}]")
    log(f"  decode: {len(plain.step_s)} batched steps, p50 {p50:.3f} ms, "
        f"{dec_tok / dec_s:.1f} tokens/s; bound {bound_ms:.3f} ms "
        f"({(weight_bytes + cache_bytes) / 1e9:.3f} GB of weights and "
        f"caches at 3.35 TB/s), p50 / bound {p50 / bound_ms:.2f}x; peak "
        f"device memory {peak / 2**30:.2f} GiB [{smi}]")

    # decode == teacher-forced forward, for the longest and the shortest
    order = sorted(reqs, key=lambda r: len(r.prompt))
    forward_check = []
    for r in (order[-1], order[0]):
        P = len(r.prompt)
        toks = np.concatenate([r.prompt, tokens[r.uid][:LM_FORCED]])
        x, _, _ = T.forward(params, cfg,
                            torch.as_tensor(toks)[None].to(dev))
        full = T.unembed(params, cfg, x[:, P - 1:P + LM_FORCED])[
            0, :, :cfg.vocab_size].float().cpu().numpy()
        served = np.stack([lg for lg, _ in plain.by_uid(r.uid)[
            :LM_FORCED + 1]])
        diff = float(np.abs(served - full).max())
        tol = _bf16_tol(full, 2 * cfg.n_layers)
        log(f"  request {r.uid} (prompt {P}): prefill + {LM_FORCED} decode "
            f"steps vs the teacher-forced forward: max |diff| {diff:.4f}, "
            f"tolerance {tol:.4f} (logit scale "
            f"{float(np.abs(full).max()):.3f}) [{smi}]")
        if diff > tol:
            raise AssertionError(f"phase 9: decode vs forward {diff} > {tol}")
        forward_check.append({"uid": r.uid, "prompt": P, "max_diff": diff,
                              "tol": tol})

    # sigma-delta decode, teacher-forced to the plain tokens
    sd_runs = {}
    for frac in (1.0, LM_SD_FRAC):
        cfg_sd = dataclasses.replace(cfg, sd_decode_frac=frac)
        eng_sd, rec, _, wall_sd = _lm_serve(cfg_sd, params, dev, tokens)
        if eng_sd.stats != eng.stats:
            raise AssertionError(f"phase 9: sd {frac} stats {eng_sd.stats} "
                                 f"!= {eng.stats}")
        worst = max(float(np.abs(lg - plg).max()) for (_, lg, _), (
            _, plg, _) in zip(rec.calls, plain.calls))
        row = {"frac": frac, "p50_step_ms": rec.p50_step_ms(),
               "max_logit_drift": worst, "wall_s": wall_sd,
               "read_bytes_per_layer_token": read_bytes_per_layer(
                   cfg.d_model, cfg.lru_dim, cfg.d_ff, frac),
               "plain_read_bytes_per_layer_token": read_bytes_per_layer(
                   cfg.d_model, cfg.lru_dim, cfg.d_ff, 1.0)}
        if frac == 1.0:
            row.update(_lm_against(rec, plain, cfg.n_layers,
                                   "sd 1.0 vs plain"))
        sd_runs[str(frac)] = row
        log(f"  sd_decode_frac {frac}: p50 step {row['p50_step_ms']:.3f} ms "
            f"(plain {p50:.3f}), largest logit drift vs plain "
            f"{worst:.4f} over {len(rec.calls)} sampling calls; weight "
            f"bytes per RG-LRU layer and token "
            f"{row['read_bytes_per_layer_token'] / 1e6:.3f} MB against "
            f"{row['plain_read_bytes_per_layer_token'] / 1e6:.3f} MB [{smi}]")
    one = sd_runs["1.0"]
    log(f"  sd 1.0 vs plain: {one['same_tokens']} of {one['calls']} tokens "
        f"equal ({one['near_tie_flips']} near-tie flips), largest diff "
        f"{one['worst_diff_over_tol']:.3f} x the bf16 tolerance [{smi}]")
    if one["worst_diff_over_tol"] > 1.0:
        raise AssertionError("phase 9: sd 1.0 logits outside the bf16 "
                             "tolerance of the plain decode")

    # one traced batched step with every slot busy
    eng_t = ServeEngine(cfg, params, batch_slots=LM_SLOTS,
                        cache_len=LM_CACHE, device=dev)
    for r in _lm_requests(cfg)[:LM_SLOTS]:
        eng_t.try_admit(r)
    for _ in range(2):
        eng_t.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng_t.step()
        torch.cuda.synchronize()
        traced_wall = time.perf_counter() - t0
    trace = _device_summary(prof, traced_wall, "LM decode step (4 slots)",
                            smi)

    card_cpu = _lm_card_vs_cpu(dev)
    log(f"  smoke {LM_ARCH} float32, TF32 off: card vs CPU max |diff| "
        f"{card_cpu:.2e} over prefill + 8 decode steps (tolerance "
        f"{LM_F32_ATOL}) [{smi}]")
    if card_cpu > LM_F32_ATOL:
        raise AssertionError(f"phase 9: card vs CPU {card_cpu}")
    stray = {k: v for k, v in LAUNCHES.items() if v}
    if stray:
        raise AssertionError(f"phase 9: the LM path launched port kernels "
                             f"{stray}")
    log("  the LM path launched none of the port's eight kernels (counts "
        "set to 0 before the phase, read after)")
    wall_phase = time.perf_counter() - t_phase
    log(f"  phase 9 wall {wall_phase:.1f} s [{smi}]")
    return {"arch": LM_ARCH, "dtype": cfg.dtype, "params": n_params,
            "weight_bytes": weight_bytes, "cache_bytes": cache_bytes,
            "slots": LM_SLOTS, "cache_len": LM_CACHE,
            "prompt_lens": [len(r.prompt) for r in reqs],
            "stats": eng.stats, "wall_s": wall,
            "prefill_tokens_per_s": pre_tok / pre_s,
            "decode_steps": len(plain.step_s), "p50_step_ms": p50,
            "step_ms": [1e3 * s for s, _ in plain.step_s],
            "decode_tokens_per_s": dec_tok / dec_s,
            "bound_ms": bound_ms, "p50_over_bound": p50 / bound_ms,
            "peak_device_memory_bytes": peak,
            "forward_check": forward_check, "sd": sd_runs,
            "trace": trace, "card_vs_cpu_max_diff": card_cpu,
            "phase_wall_s": wall_phase, "card": smi}


# ---------------------------------------------------------------------------
# phase 10: every remaining LM architecture on the card
# ---------------------------------------------------------------------------

MOE_ARCH, MOE_CACHE = "olmoe-1b-7b", 2048
MOE_PROMPT_LENS = (128, 1500)  # 8 requests of 32 tokens on 4 slots
MOE_RELAXED = 8.0       # the reference's capacity for decode == forward
F32_REL_TOL = 1e-3      # float32 decode vs forward, of the logit scale
XLSTM_ARCH, XLSTM_CACHE = "xlstm-1.3b", 512
XLSTM_REQUESTS, XLSTM_PROMPT_LENS, XLSTM_TOKENS = 6, (64, 256), 16
WHISPER_ARCH, WHISPER_CACHE, WHISPER_PROMPT = "whisper-medium", 448, 64
VLM_ARCH, VLM_LAYERS, VLM_PROMPT, VLM_STEPS = "internvl2-26b", 8, 512, 8
# the f32 smoke configs held card vs CPU; llama4's capacity overflows
SMOKE_ARCHS = (("olmoe-1b-7b", None), ("llama4-maverick-400b-a17b", 0.25),
               ("xlstm-1.3b", None), ("whisper-medium", None),
               ("internvl2-26b", None))


@contextlib.contextmanager
def _moe_routes():
    """Records every MoE layer call while open: which experts each token
    was routed to ((T, E) bool, on the host) and the (expert, token)
    routes its experts kept.  It wraps ``transformer._moe`` and recomputes
    the routing on the call's own input (the same operations, so the same
    choice)."""
    from repro_torch.models import moe
    from repro_torch.models import transformer as T
    calls, own = [], T._moe

    def wrapped(p, cfg, h):
        xf = h.reshape(-1, h.shape[-1])
        _, sel = moe.route(p["router"], xf, cfg.top_k)
        cap = moe._capacity(xf.shape[0], cfg.n_experts, cfg.top_k,
                            cfg.capacity_factor)
        _, idx, valid = moe.dispatch(sel, cap)
        kept = frozenset((e, int(idx[e, c]))
                         for e, c in valid.nonzero().tolist())
        calls.append(((sel > 0).cpu(), kept))
        return own(p, cfg, h)
    T._moe = wrapped
    try:
        yield calls
    finally:
        T._moe = own


def _free():
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def _bytes(tree) -> int:
    from repro_torch.models.layers import tree_leaves
    return sum(t.numel() * t.element_size() for _, t in tree_leaves(tree))


def _forced_vs_forward(cfg, params, req, toks, dev):
    """``req``'s prefill and ``len(toks) - 1`` decode steps on a one-slot
    engine, teacher-forced to ``toks``, against the forward over the prompt
    and those tokens.  Returns the served and the forward logits
    (len(toks), V) and, per position, whether every MoE layer routed it to
    the same top-k experts in both (all true without MoE)."""
    import numpy as np
    import torch
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import Request, ServeEngine
    P, L, n = len(req.prompt), cfg.n_layers, len(toks)
    eng = ServeEngine(cfg, params, batch_slots=1, cache_len=P + 2 * n,
                      eos_id=-1, device=dev)
    rec = _Recorder(eng, {req.uid: toks})
    with _moe_routes() as calls:
        eng.run([Request(req.uid, req.prompt, n)])
    served = np.stack([lg for lg, _ in rec.by_uid(req.uid)])
    seq = torch.as_tensor(np.concatenate([req.prompt, toks[:n - 1]]))
    with _moe_routes() as fcalls:
        x, _, _ = T.forward(params, cfg, seq[None].to(dev))
    full = T.unembed(params, cfg, x[:, P - 1:P - 1 + n])[
        0, :, :cfg.vocab_size].float().cpu().numpy()
    if not cfg.n_experts:
        return served, full, np.ones(n, bool)
    # call k of a layer: the prefill's row P - 1, then decode step k's row
    rows = [[calls[l][0][P - 1] for l in range(L)]] + [
        [calls[L * k + l][0][0] for l in range(L)] for k in range(1, n)]
    agree = np.array([all(torch.equal(rows[k][l], fcalls[l][0][P - 1 + k])
                          for l in range(L)) for k in range(n)])
    return served, full, agree


def _moe_decode_vs_forward(cfg, params, reqs, tokens, dev, smi) -> list:
    """Item 2: the longest and the shortest prompt at the relaxed
    capacity, in the params' dtype, against the forward: logits within
    the dtype's tolerance where the top-k sets agree in every layer."""
    import numpy as np
    order = sorted(reqs, key=lambda r: len(r.prompt))
    out = []
    for r in (order[-1], order[0]):
        toks = tokens[r.uid][:LM_FORCED + 1]
        if len(toks) < LM_FORCED + 1:
            raise AssertionError(f"phase 10: request {r.uid} ended early")
        served, full, agree = _forced_vs_forward(cfg, params, r, toks, dev)
        scale = max(1.0, float(np.abs(full).max()))
        tol = (_bf16_tol(full, 2 * cfg.n_layers) if cfg.dtype == "bfloat16"
               else F32_REL_TOL * scale)
        diff = np.abs(served - full).max(axis=1)
        worst = float(diff[agree].max()) if agree.any() else None
        log(f"  {cfg.dtype} capacity {cfg.capacity_factor}, request {r.uid} "
            f"(prompt {len(r.prompt)}): prefill + {LM_FORCED} decode steps "
            f"vs the forward: top-{cfg.top_k} sets agree in every layer at "
            f"{int(agree.sum())} of {len(agree)} positions; there max "
            f"|diff| {worst}, tolerance {tol:.5f} (logit scale {scale:.3f}); "
            f"elsewhere {float(diff[~agree].max()) if (~agree).any() else '-'}"
            f" [{smi}]")
        if worst is None or worst > tol:
            raise AssertionError(f"phase 10: {cfg.dtype} decode vs forward "
                                 f"{worst} > {tol} where the routes agree "
                                 f"({agree.tolist()})")
        out.append({"uid": r.uid, "prompt": len(r.prompt), "dtype": cfg.dtype,
                    "max_diff": worst, "tol": tol,
                    "positions": len(agree), "agree": int(agree.sum()),
                    "max_diff_where_routes_differ":
                        float(diff[~agree].max()) if (~agree).any()
                        else None})
    return out


def _int8_check(params, q, cfg) -> dict:
    """Item 3's bitwise check: the card's codes and scales of the
    embedding, layer 0's router and layer 0's gate expert stack against
    the same quantiser on the CPU (the stacks' scales shared over every
    layer, as ``quantize_model`` shares them)."""
    import torch
    from repro_torch.models import quant_lm as Q
    if Q.layer_stacks(cfg) != [list(range(cfg.n_layers))]:
        raise AssertionError(f"phase 10: {cfg.name} is not one stack")
    out = {}

    def same(name, got, amax, w0):
        s = Q.scale_of(amax)
        ok = torch.equal(got[Q.S_KEY].cpu(), s) and torch.equal(
            got[Q.Q_KEY].cpu(), Q.codes_of(w0, s))
        out[name] = ok
        if not ok:
            raise AssertionError(f"phase 10: int8 {name} card != CPU")
    e = params["embed"].cpu()
    same("embed", q["embed"], Q.column_amax(e), e)
    for key in ("router", "gate"):
        amax = None
        for layer in params["layers"]:
            a = Q.column_amax(layer["moe"][key].cpu())
            amax = a if amax is None else torch.maximum(amax, a)
        same(f"layers[0].moe.{key}", q["layers"][0]["moe"][key], amax,
             params["layers"][0]["moe"][key].cpu())
    return out


def _phase_olmoe(dev, smi: str) -> dict:
    """Items 1-3: olmoe-1b-7b at full width, bf16, int8."""
    import dataclasses
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import tree_map
    from repro_torch.models.quant_lm import dequant_params, quantize_model
    from repro_torch.serve.engine import Request, ServeEngine
    cfg = get_config(MOE_ARCH)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    params = T.init_model(torch.Generator(device=dev).manual_seed(0), cfg,
                          dev)
    n_params, weight_bytes = T.param_count(cfg), _bytes(params)
    log(f"  {MOE_ARCH}: {n_params} parameters ({T.active_param_count(cfg)} "
        f"active a token), {weight_bytes / 1e9:.3f} GB of {cfg.dtype} "
        f"weights, {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_experts} experts, top-{cfg.top_k} [{smi}]")
    warm = ServeEngine(cfg, params, batch_slots=LM_SLOTS, cache_len=MOE_CACHE,
                       device=dev)
    warm.run([Request(-1, np.arange(2, 2 + MOE_PROMPT_LENS[0]), 4)])
    del warm

    # 1. the engine at the published capacity
    reqs = _lm_requests(cfg, lens=MOE_PROMPT_LENS)
    eng, plain, reqs, wall = _lm_serve(cfg, params, dev, cache_len=MOE_CACHE,
                                       reqs=reqs)
    for r in reqs:
        n = len(r.out_tokens)
        if not r.done or (n != LM_TOKENS and r.out_tokens[-1] != eng.eos):
            raise AssertionError(f"phase 10: request {r.uid} ended with {n} "
                                 f"tokens, done={r.done}")
    tokens = {r.uid: r.out_tokens for r in reqs}
    pre_s = sum(s for s, _ in plain.prefill)
    pre_tok = sum(k for _, k in plain.prefill)
    dec_s = sum(s for s, _ in plain.step_s)
    dec_tok = sum(k for _, k in plain.step_s)
    p50 = plain.p50_step_ms()
    cache_bytes = _bytes(eng.cache)
    bound_ms = 1e3 * (weight_bytes + cache_bytes) / HBM_BYTES_PER_S
    peak = torch.cuda.max_memory_allocated(dev)
    log(f"  served {len(reqs)} requests ({[len(r.prompt) for r in reqs]} "
        f"prompt tokens) on {LM_SLOTS} slots, cache {MOE_CACHE}: "
        f"{eng.stats}, wall {wall:.2f} s [{smi}]")
    log(f"  prefill {pre_tok} tokens in {pre_s:.3f} s: "
        f"{pre_tok / pre_s:.1f} tokens/s [{smi}]")
    log(f"  decode: {len(plain.step_s)} batched steps, p50 {p50:.3f} ms, "
        f"{dec_tok / dec_s:.1f} tokens/s; bound {bound_ms:.3f} ms "
        f"({weight_bytes / 1e9:.3f} GB of weights, all {cfg.n_experts} "
        f"experts at B = {LM_SLOTS}, and {cache_bytes / 1e9:.3f} GB of "
        f"caches at 3.35 TB/s; weights alone "
        f"{1e3 * weight_bytes / HBM_BYTES_PER_S:.3f} ms), p50 / bound "
        f"{p50 / bound_ms:.2f}x; peak device memory {peak / 2**30:.2f} GiB "
        f"[{smi}]")
    serve_stats = dict(eng.stats)
    del eng
    eng_t = ServeEngine(cfg, params, batch_slots=LM_SLOTS,
                        cache_len=MOE_CACHE, device=dev)
    for r in _lm_requests(cfg, lens=MOE_PROMPT_LENS)[:LM_SLOTS]:
        eng_t.try_admit(r)
    for _ in range(2):
        eng_t.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng_t.step()
        torch.cuda.synchronize()
        traced_wall = time.perf_counter() - t0
    trace = _device_summary(prof, traced_wall,
                            f"{MOE_ARCH} decode step (4 slots)", smi)
    del eng_t
    longest = max(reqs, key=lambda r: len(r.prompt))
    _, st, _ = T.forward(params, cfg, torch.as_tensor(longest.prompt)[
        None].to(dev))
    stats = {"aux_loss": float(st.aux_loss),
             "dropped_frac": float(st.dropped_frac)}
    log(f"  forward over the longest prompt ({len(longest.prompt)} tokens) "
        f"at capacity {cfg.capacity_factor}: aux_loss {stats['aux_loss']:.6f}"
        f", dropped_frac {stats['dropped_frac']:.6f} [{smi}]")
    _free()

    # 2. decode vs the teacher-forced forward at the relaxed capacity
    relaxed = dataclasses.replace(cfg, capacity_factor=MOE_RELAXED)
    check = _moe_decode_vs_forward(relaxed, params, reqs, tokens, dev, smi)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        p32 = tree_map(lambda w: w.float(), params)
        check += _moe_decode_vs_forward(
            dataclasses.replace(relaxed, dtype="float32"), p32, reqs, tokens,
            dev, smi)
        del p32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    _free()

    # 3. int8 storage: quantize_model on the card, dequantised every step
    q = quantize_model(params, cfg)
    int8_bitwise = _int8_check(params, q, cfg)
    q_bytes = _bytes(q)
    log(f"  int8: quantize_model on the card equals the CPU's bitwise for "
        f"{sorted(int8_bitwise)}; storage {q_bytes / 1e9:.3f} GB (codes and "
        f"scales) against {weight_bytes / 1e9:.3f} GB of bf16 [{smi}]")
    del params
    _free()
    torch.cuda.reset_peak_memory_stats(dev)
    eng = ServeEngine(cfg, q, batch_slots=LM_SLOTS, cache_len=MOE_CACHE,
                      eos_id=-1, device=dev)

    def prefill(toks):
        logits, cache, _ = T.prefill(dequant_params(q, cfg.tdtype), cfg,
                                     toks, cache_len=eng.S)
        return logits[:, -1, :], cache

    def decode(cache, toks, pos):
        logits, cache, _ = T.decode_step(dequant_params(q, cfg.tdtype), cfg,
                                         cache, toks[:, None], pos)
        return logits[:, 0, :], cache
    eng._prefill, eng._decode = prefill, decode
    rec = _Recorder(eng, tokens)
    first = [Request(r.uid, r.prompt, LM_FORCED + 1)
             for r in reqs[:LM_SLOTS]]
    eng.run(first)
    drift = max(float(np.abs(lg - plg).max())
                for r in first for (lg, _), (plg, _) in zip(
                    rec.by_uid(r.uid), plain.by_uid(r.uid)))
    if not np.isfinite(drift) or len(rec.step_s) != LM_FORCED:
        raise AssertionError(f"phase 10: int8 run drift {drift}, "
                             f"{len(rec.step_s)} steps")
    int8 = {"storage_bytes": q_bytes, "bf16_bytes": weight_bytes,
            "p50_step_ms": rec.p50_step_ms(), "steps": len(rec.step_s),
            "peak_device_memory_bytes": torch.cuda.max_memory_allocated(dev),
            "max_logit_drift_vs_bf16": drift, "bitwise": int8_bitwise}
    log(f"  int8: {int8['steps']} batched decode steps (dequant_params + "
        f"decode_step), p50 {int8['p50_step_ms']:.3f} ms (bf16 {p50:.3f}); "
        f"peak device memory {int8['peak_device_memory_bytes'] / 2**30:.2f} "
        f"GiB; largest logit drift vs bf16 {drift:.4f} [{smi}]")
    del eng, q
    _free()
    return {"arch": MOE_ARCH, "dtype": cfg.dtype, "params": n_params,
            "active_params": T.active_param_count(cfg),
            "weight_bytes": weight_bytes, "cache_bytes": cache_bytes,
            "slots": LM_SLOTS, "cache_len": MOE_CACHE,
            "prompt_lens": [len(r.prompt) for r in reqs],
            "stats": serve_stats, "wall_s": wall,
            "prefill_tokens_per_s": pre_tok / pre_s,
            "decode_steps": len(plain.step_s), "p50_step_ms": p50,
            "decode_tokens_per_s": dec_tok / dec_s, "bound_ms": bound_ms,
            "weights_bound_ms": 1e3 * weight_bytes / HBM_BYTES_PER_S,
            "p50_over_bound": p50 / bound_ms,
            "peak_device_memory_bytes": peak, "trace": trace,
            "forward_stats": stats, "decode_vs_forward": check,
            "int8": int8}


def _phase_xlstm(dev, smi: str) -> dict:
    """Item 4: xlstm-1.3b at full width, bf16, on the engine; its decode
    against the forward in bf16 and, with the same weights, in float32."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import tree_map
    from repro_torch.serve.engine import Request, ServeEngine
    cfg = get_config(XLSTM_ARCH)
    torch.cuda.reset_peak_memory_stats(dev)
    params = T.init_model(torch.Generator(device=dev).manual_seed(0), cfg,
                          dev)
    weight_bytes = _bytes(params)
    warm = ServeEngine(cfg, params, batch_slots=LM_SLOTS,
                       cache_len=XLSTM_CACHE, device=dev)
    warm.run([Request(-1, np.arange(2, 10), 2)])
    del warm
    reqs = _lm_requests(cfg, XLSTM_REQUESTS, XLSTM_PROMPT_LENS, XLSTM_TOKENS)
    eng, rec, reqs, wall = _lm_serve(cfg, params, dev,
                                     cache_len=XLSTM_CACHE, reqs=reqs)
    for r in reqs:
        n = len(r.out_tokens)
        if not r.done or (n != XLSTM_TOKENS and r.out_tokens[-1] != eng.eos):
            raise AssertionError(f"phase 10: xlstm request {r.uid} ended "
                                 f"with {n} tokens")
    state_bytes = _bytes(eng.cache)
    bound_ms = 1e3 * (weight_bytes + 2 * state_bytes) / HBM_BYTES_PER_S
    pre_s = sum(s for s, _ in rec.prefill)
    pre_tok = sum(k for _, k in rec.prefill)
    dec_s = sum(s for s, _ in rec.step_s)
    dec_tok = sum(k for _, k in rec.step_s)
    p50 = rec.p50_step_ms()
    r = max(reqs, key=lambda q: len(q.prompt))
    P, n = len(r.prompt), len(r.out_tokens)
    seq = np.concatenate([r.prompt, r.out_tokens[:n - 1]])
    x, _, _ = T.forward(params, cfg, torch.as_tensor(seq)[None].to(dev))
    full = T.unembed(params, cfg, x[:, P - 1:])[
        0, :, :cfg.vocab_size].float().cpu().numpy()
    served = np.stack([lg for lg, _ in rec.by_uid(r.uid)])
    diff = float(np.abs(served - full).max())
    # a block rounds through two GEMM stages on each side of its
    # recurrence (up, then the per-head q/k/v; h, then down), as an
    # attention layer and an FFN do together: two adds' worth a block
    tol = _bf16_tol(full, 2 * cfg.n_layers)
    out = {"arch": XLSTM_ARCH, "params": T.param_count(cfg),
           "weight_bytes": weight_bytes, "state_bytes": state_bytes,
           "prompt_lens": [len(q.prompt) for q in reqs],
           "stats": dict(eng.stats), "wall_s": wall,
           "prefill_tokens_per_s": pre_tok / pre_s, "p50_step_ms": p50,
           "decode_tokens_per_s": dec_tok / dec_s, "bound_ms": bound_ms,
           "p50_over_bound": p50 / bound_ms,
           "peak_device_memory_bytes": torch.cuda.max_memory_allocated(dev),
           "forward_check": {"uid": r.uid, "prompt": P, "max_diff": diff,
                             "tol": tol}}
    log(f"  {XLSTM_ARCH}: {out['params']} parameters, "
        f"{weight_bytes / 1e9:.3f} GB bf16, decode state "
        f"{state_bytes / 1e9:.3f} GB at {LM_SLOTS} slots; {len(reqs)} "
        f"requests ({out['prompt_lens']} prompt tokens): prefill "
        f"{pre_tok / pre_s:.1f} tokens/s; decode p50 {p50:.3f} ms, "
        f"{dec_tok / dec_s:.1f} tokens/s; bound {bound_ms:.3f} ms (weights "
        f"read, state read and written), p50 / bound {p50 / bound_ms:.2f}x;"
        f" peak {out['peak_device_memory_bytes'] / 2**30:.2f} GiB [{smi}]")
    log(f"  request {r.uid} (prompt {P}): prefill + {n - 1} decode steps vs "
        f"the forward: max |diff| {diff:.4f}, tolerance {tol:.4f} [{smi}]")
    if diff > tol:
        raise AssertionError(f"phase 10: xlstm decode vs forward {diff}")
    del eng
    # the same weights in float32 (TF32 off), the shortest prompt
    short = min(reqs, key=lambda q: len(q.prompt))
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        p32 = tree_map(lambda w: w.float(), params)
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        served, full, _ = _forced_vs_forward(cfg32, p32, short,
                                             short.out_tokens, dev)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    diff32 = float(np.abs(served - full).max())
    tol32 = F32_REL_TOL * max(1.0, float(np.abs(full).max()))
    out["forward_check_f32"] = {"uid": short.uid, "prompt": len(
        short.prompt), "max_diff": diff32, "tol": tol32}
    log(f"  float32 (TF32 off), request {short.uid} (prompt "
        f"{len(short.prompt)}): prefill + {len(served) - 1} decode steps "
        f"vs the "
        f"forward: max |diff| {diff32:.3e}, tolerance {tol32:.5f} [{smi}]")
    if diff32 > tol32:
        raise AssertionError(f"phase 10: xlstm f32 decode vs forward "
                             f"{diff32}")
    del params, p32
    _free()
    return out


def _greedy(params, cfg, toks, steps: int, cache_len: int, **stub):
    """prefill and ``steps`` greedy decode steps of (B, P) ``toks``: the
    logits of every position served (steps + 1, B, V) on the host, the
    tokens, and each decode step's synchronised seconds."""
    import numpy as np
    import torch
    from repro_torch.models import transformer as T
    P = toks.shape[1]
    logits, cache, _ = T.prefill(params, cfg, toks, cache_len=cache_len,
                                 **stub)
    rows, out, secs = [logits[:, 0, :cfg.vocab_size]], [], []
    for t in range(steps):
        tok = rows[-1].argmax(-1)
        out.append(tok)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache, _ = T.decode_step(params, cfg, cache, tok[:, None],
                                         P + t)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        rows.append(logits[:, 0, :cfg.vocab_size])
    served = np.stack([r.float().cpu().numpy() for r in rows])
    return served, torch.stack(out, 1), secs


def _stub_vs_forward(cfg, dev, smi, toks, steps, n_adds, cache_len,
                     **stub) -> dict:
    """Items 5 and 6: greedy prefill + decode with the stub inputs against
    the teacher-forced forward over the same tokens."""
    import numpy as np
    import torch
    from repro_torch.models import transformer as T
    torch.cuda.reset_peak_memory_stats(dev)
    params = T.init_model(torch.Generator(device=dev).manual_seed(0), cfg,
                          dev)
    weight_bytes = _bytes(params)
    _greedy(params, cfg, toks, 1, cache_len, **stub)          # warm
    served, gen, secs = _greedy(params, cfg, toks, steps, cache_len, **stub)
    P = toks.shape[1]
    x, _, _ = T.forward(params, cfg, torch.cat([toks, gen], 1), **stub)
    full = T.unembed(params, cfg, x[:, P - 1:])[
        :, :, :cfg.vocab_size].float().cpu().numpy().transpose(1, 0, 2)
    diff = float(np.abs(served - full).max())
    tol = _bf16_tol(full, n_adds)
    out = {"arch": cfg.name, "n_layers": cfg.n_layers,
           "params": T.param_count(cfg), "weight_bytes": weight_bytes,
           "batch": toks.shape[0], "prompt": P, "decode_steps": steps,
           "p50_step_ms": 1e3 * float(np.median(secs)),
           "peak_device_memory_bytes": torch.cuda.max_memory_allocated(dev),
           "max_diff": diff, "tol": tol}
    if cfg.encoder is not None:
        frames = stub["frames"]
        T._encoder_forward(params, cfg, frames)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        T._encoder_forward(params, cfg, frames)
        torch.cuda.synchronize()
        out["encoder_ms"] = 1e3 * (time.perf_counter() - t0)
    log(f"  {cfg.name}: {out['params']} parameters, {cfg.n_layers} layers, "
        f"{weight_bytes / 1e9:.3f} GB bf16; B = {toks.shape[0]}, prompt {P}"
        f", {steps} decode steps, p50 step {out['p50_step_ms']:.3f} ms"
        + (f", encoder {out['encoder_ms']:.3f} ms" if "encoder_ms" in out
           else "")
        + f"; vs the teacher-forced forward max |diff| {diff:.4f}, "
        f"tolerance {tol:.4f}; peak "
        f"{out['peak_device_memory_bytes'] / 2**30:.2f} GiB [{smi}]")
    if diff > tol:
        raise AssertionError(f"phase 10: {cfg.name} decode vs forward "
                             f"{diff} > {tol}")
    del params
    _free()
    return out


def _smoke_card_vs_cpu(dev, smi) -> list:
    """Item 7: each f32 smoke config from the same weights on the card and
    on the CPU (TF32 off): prefill and 8 decode steps within 1e-4; for
    MoE, the forward's dropped_frac and every layer's kept (expert, token)
    routes equal, and a second card run bitwise the first."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_smoke
    from repro_torch.models import transformer as T
    from repro_torch.models.frontend import frontend_feature_shape
    from repro_torch.models.layers import tree_map
    rows = []
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for arch, cap in SMOKE_ARCHS:
            cfg = get_smoke(arch)
            if cap is not None:
                cfg = dataclasses.replace(cfg, capacity_factor=cap)
            p = T.init_model(torch.Generator().manual_seed(0), cfg, "cpu")
            rng = np.random.default_rng(1)
            toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 28)))
            shape = frontend_feature_shape(cfg, 2)
            stub = {} if shape is None else {
                "frames" if cfg.frontend == "audio" else "patches":
                torch.as_tensor(rng.normal(size=shape).astype(np.float32))}
            runs = []
            for d in ("cpu", dev, dev):
                params = p if d == "cpu" else tree_map(lambda w: w.to(d), p)
                kw = {k: v.to(d) for k, v in stub.items()}
                t = toks.to(d)
                with _moe_routes() as calls:
                    _, st, _ = T.forward(params, cfg, t, **kw)
                lg, cache, _ = T.prefill(params, cfg, t[:, :20], cache_len=32,
                                         **kw)
                out = [lg]
                for i in range(20, 28):
                    lg, cache, _ = T.decode_step(params, cfg, cache,
                                                 t[:, i:i + 1], i)
                    out.append(lg)
                runs.append((torch.cat(out, 1).cpu(), float(st.dropped_frac),
                             [c[1] for c in calls]))
            (c_lg, c_drop, c_kept), (g_lg, g_drop, g_kept), (g2, d2, k2) = \
                runs
            diff = float((c_lg - g_lg).abs().max())
            row = {"arch": arch, "capacity_factor": cfg.capacity_factor,
                   "max_diff": diff, "dropped_frac": g_drop,
                   "dropped_equal": c_drop == g_drop,
                   "kept_equal": c_kept == g_kept,
                   "moe_layers_recorded": len(g_kept),
                   "card_runs_bitwise": torch.equal(g_lg, g2)
                   and g_drop == d2 and g_kept == k2}
            rows.append(row)
            what = "" if cap is None else f" capacity {cap}"
            log(f"  smoke {arch} f32{what}: card vs CPU max |diff| "
                f"{diff:.2e} over prefill + 8 decode"
                f" steps (tolerance {LM_F32_ATOL}); dropped_frac {g_drop:.6f}"
                f" (CPU {c_drop:.6f}), kept routes equal {row['kept_equal']} "
                f"over {len(g_kept)} MoE calls; two card runs bitwise "
                f"{row['card_runs_bitwise']} [{smi}]")
            if diff > LM_F32_ATOL or not (row["dropped_equal"]
                                          and row["kept_equal"]
                                          and row["card_runs_bitwise"]):
                raise AssertionError(f"phase 10: smoke {arch} card vs CPU "
                                     f"{row}")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    if rows[1]["dropped_frac"] <= 0:
        raise AssertionError("phase 10: the llama4 smoke run did not "
                             "overflow")
    return rows


def phase_lm_archs(dev, smi: str) -> dict:
    """Phase 10 (see the module docstring): olmoe-1b-7b (bf16, relaxed
    capacity in bf16 and f32, int8), xlstm-1.3b, whisper-medium and
    internvl2-26b (depth cut) on the card, and five smoke configs card vs
    CPU."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import LAUNCHES, reset_launch_counts
    t_phase = time.perf_counter()
    reset_launch_counts()
    out = {"olmoe": _phase_olmoe(dev, smi), "xlstm": _phase_xlstm(dev, smi)}

    rng = np.random.default_rng(0)
    cfg = get_config(WHISPER_ARCH)
    frames = torch.as_tensor(rng.normal(size=(
        2, cfg.encoder.n_frames, cfg.encoder.d_input)).astype(np.float32))
    toks = torch.as_tensor(rng.integers(2, cfg.vocab_size,
                                        (2, WHISPER_PROMPT)))
    out["whisper"] = _stub_vs_forward(
        cfg, dev, smi, toks.to(dev), LM_FORCED, 3 * cfg.n_layers,
        WHISPER_CACHE, frames=frames.to(dev, cfg.tdtype))
    full = get_config(VLM_ARCH)
    cfg = dataclasses.replace(full, n_layers=VLM_LAYERS,
                              layers=full.layers[:VLM_LAYERS])
    patches = torch.as_tensor(rng.normal(size=(
        1, cfg.n_patches, cfg.d_model)).astype(np.float32))
    toks = torch.as_tensor(rng.integers(2, cfg.vocab_size, (1, VLM_PROMPT)))
    out["internvl2"] = _stub_vs_forward(
        cfg, dev, smi, toks.to(dev), VLM_STEPS, 2 * cfg.n_layers,
        VLM_PROMPT + 2 * VLM_STEPS, patches=patches.to(dev, cfg.tdtype))
    out["internvl2"]["published_layers"] = full.n_layers
    out["smoke_card_vs_cpu"] = _smoke_card_vs_cpu(dev, smi)
    stray = {k: v for k, v in LAUNCHES.items() if v}
    if stray:
        raise AssertionError(f"phase 10: the LM archs launched port kernels "
                             f"{stray}")
    log("  phase 10 launched none of the port's eight kernels (counts set "
        "to 0 before the phase, read after)")
    out["phase_wall_s"] = time.perf_counter() - t_phase
    out["card"] = smi
    log(f"  phase 10 wall {out['phase_wall_s']:.1f} s [{smi}]")
    return out


# ---------------------------------------------------------------------------
# phase 11: LM training on the card
# ---------------------------------------------------------------------------

TRAIN_ARCH = "gemma3-1b"
TRAIN_B, TRAIN_S, TRAIN_CHUNK = 8, 1024, 128
TRAIN_STEPS, TRAIN_CKPT_EVERY = 6, 3
TRAIN_LR, TRAIN_WARMUP = 3e-4, 2
BF16_OPS_PER_S = 989e12       # H100 SXM dense bf16 tensor-core peak
GEMM_NAMES = ("nvjet", "gemm", "cutlass", "xmma")   # cuBLAS kernel names
SMOKE_CHUNK, SMOKE_B, SMOKE_S = 16, 4, 32
LEARN_STEPS, LEARN_B, LEARN_S = 60, 8, 32   # the reference's learning test
TRAIN_REL_TOL, GRAD_TOL = 1e-5, 1e-4        # card vs CPU, float32


def _train_step_flops(cfg, B: int, S: int) -> dict:
    """The operations one ``make_train_step`` of ``cfg`` does at (B, S),
    reckoned from the code: the layer GEMMs run forward, again under
    remat, and backward (two GEMMs each), except that the remat pass stops
    before each layer's FFN down projection (non-reentrant
    ``torch.utils.checkpoint`` stops recomputing once every tensor the
    backward saved is back, and no backward needs that GEMM's output); the
    unembedding GEMM forward, again inside its checkpointed CE chunk, and
    backward; the blockwise attention computes every (q, kv) block, masked
    or not (``Cq = Ckv = S`` here), QK^T and PV, forward, again under
    remat, and backward (twice each).  Dense attention layers and dense
    FFNs only.  Phase 13b holds it to the dry-run's FLOP count."""
    from repro_torch.models import config as C
    d, H, Hk, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    per_layer = 0
    for spec in cfg.layers:
        assert spec.mixer in (C.ATTN_GLOBAL, C.ATTN_LOCAL) and \
            spec.ffn == C.FFN_DENSE and not spec.cross_attn, spec
        per_layer += d * H * hd + 2 * d * Hk * hd + H * hd * d \
            + 3 * d * cfg.d_ff
    T_ = B * S
    layers = 2 * T_ * per_layer                  # one forward
    down = 2 * T_ * cfg.d_ff * d * cfg.n_layers  # not recomputed
    head = 2 * T_ * d * cfg.vocab_padded
    remat = 1 if cfg.remat else 0
    gemm = layers * (1 + remat + 2) - remat * down + head * (1 + 1 + 2)
    attn_fwd = cfg.n_layers * 2 * (2 * B * H * S * S * hd)
    attn = attn_fwd * (1 + remat + 2)
    return {"gemm_flop": gemm, "attention_flop": attn,
            "total_flop": gemm + attn,
            "bound_ms": 1e3 * (gemm + attn) / BF16_OPS_PER_S}


@contextlib.contextmanager
def _timed_saves():
    """Times every ``train.checkpoint.save`` while open and records the
    bytes it wrote: a list of (seconds, bytes)."""
    from repro_torch.train import checkpoint as ck
    own, saves = ck.save, []

    def save(ckpt_dir, step, tree, *a, **kw):
        t0 = time.perf_counter()
        final = own(ckpt_dir, step, tree, *a, **kw)
        saves.append((time.perf_counter() - t0, sum(
            os.path.getsize(os.path.join(final, f))
            for f in os.listdir(final))))
        return final

    ck.save = save
    try:
        yield saves
    finally:
        ck.save = own


def _trees_equal(a, b) -> bool:
    import torch
    from repro_torch.models.layers import tree_leaves
    la, lb = list(tree_leaves(a)), list(tree_leaves(b))
    return [p for p, _ in la] == [p for p, _ in lb] and all(
        torch.equal(x, y) for (_, x), (_, y) in zip(la, lb))


def _phase_train_full(dev, smi: str) -> dict:
    """11a: full-width gemma3-1b through ``train_loop``, 6 steps with
    checkpoints every 3, resumed from step 3 bitwise; one step traced."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.data.lm_ds import LmDatasetSpec, stream
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import tree_leaves
    from repro_torch.optim.schedules import warmup_cosine
    from repro_torch.train.loop import make_train_step, train_loop
    cfg = get_config(TRAIN_ARCH)
    if not (cfg.remat and cfg.moment_dtype == "float32"
            and cfg.dtype == "bfloat16"):
        raise AssertionError(f"phase 11: {TRAIN_ARCH} is not the bf16 remat "
                             f"config with float32 moments")
    n_params = T.param_count(cfg)
    flops = _train_step_flops(cfg, TRAIN_B, TRAIN_S)
    log(f"  {TRAIN_ARCH}: {n_params} parameters, {cfg.n_layers} layers, "
        f"d_model {cfg.d_model}, vocab {cfg.vocab_size}, {cfg.dtype}, remat "
        f"{cfg.remat_policy}, {cfg.moment_dtype} moments; B = {TRAIN_B}, "
        f"S = {TRAIN_S}, loss chunk {TRAIN_CHUNK}; a step's work "
        f"{flops['gemm_flop'] / 1e12:.2f} TFLOP of GEMMs + "
        f"{flops['attention_flop'] / 1e12:.2f} TFLOP of attention, bound "
        f"{flops['bound_ms']:.2f} ms at 989 TFLOP/s bf16 [{smi}]")
    ds = LmDatasetSpec(vocab_size=cfg.vocab_size, seq_len=TRAIN_S)
    sched = warmup_cosine(TRAIN_LR, TRAIN_WARMUP, TRAIN_STEPS)

    def batches(start):
        for t, l in stream(ds, 0, TRAIN_B, start_index=start, device=dev):
            yield {"tokens": t, "labels": l}

    ckdir = tempfile.mkdtemp(prefix="chip_smoke_lm_")
    kw = dict(seed=0, ckpt_dir=ckdir, ckpt_every=TRAIN_CKPT_EVERY,
              log_every=1, loss_chunk=TRAIN_CHUNK, device=dev)
    try:
        _free()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        with _timed_saves() as saves:
            full = train_loop(cfg, batches(0), TRAIN_STEPS, sched,
                              log_fn=lambda s: log("  " + s), **kw)
        run_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev)
        losses = [h["loss"] for h in full["history"]]
        step_ms = [1e3 * h["step_time_s"] for h in full["history"]]
        p50 = float(np.median(step_ms[1:]))
        tok_s = TRAIN_B * TRAIN_S / (p50 / 1e3)
        if not all(np.isfinite(losses)) or len(losses) != TRAIN_STEPS:
            raise AssertionError(f"phase 11: losses {losses}")
        init = T.init_model(torch.Generator(dev).manual_seed(0), cfg, dev)
        moved = {"/".join(map(str, p)): float((a != b).float().mean())
                 for (p, a), (_, b) in zip(tree_leaves(init),
                                           tree_leaves(full["params"]))}
        del init
        if min(moved.values()) <= 0.0:
            raise AssertionError(f"phase 11: leaves that did not move "
                                 f"{[k for k, v in moved.items() if v <= 0]}")
        frac_moved = float(np.mean(list(moved.values())))
        log(f"  6 steps: losses {[round(x, 4) for x in losses]}; step ms "
            f"{[round(x, 1) for x in step_ms]}, p50 of steps 2-6 {p50:.1f} "
            f"ms = {p50 / flops['bound_ms']:.2f}x the {flops['bound_ms']:.2f}"
            f" ms bound ({flops['total_flop'] / (p50 / 1e3) / 1e12:.1f} "
            f"TFLOP/s), {tok_s:.0f} tokens/s; peak device memory "
            f"{peak / 2**30:.2f} GiB; every leaf moved (mean share of "
            f"elements {frac_moved:.3f}) [{smi}]")
        log(f"  checkpoints: {len(saves)} saves of "
            f"{[round(b / 1e9, 3) for _, b in saves]} GB in "
            f"{[round(1e3 * s, 1) for s, _ in saves]} ms (run wall "
            f"{run_s:.1f} s) [{smi}]")

        shutil.rmtree(os.path.join(ckdir, f"step_{TRAIN_STEPS:08d}"))
        t0 = time.perf_counter()
        msgs = []
        res = train_loop(cfg, batches(TRAIN_CKPT_EVERY), TRAIN_STEPS, sched,
                         log_fn=msgs.append, **kw)
        resume_s = time.perf_counter() - t0
        r_losses = [h["loss"] for h in res["history"]]
        same = (r_losses == losses[TRAIN_CKPT_EVERY:]
                and _trees_equal(res["params"], full["params"])
                and _trees_equal(res["opt_state"].mu, full["opt_state"].mu)
                and _trees_equal(res["opt_state"].nu, full["opt_state"].nu)
                and int(res["opt_state"].step) == TRAIN_STEPS)
        log(f"  resumed ({msgs[0]}): losses {[round(x, 4) for x in r_losses]}"
            f", losses 3-5, params and moments bitwise equal to the "
            f"uninterrupted run: {same} (wall {resume_s:.1f} s) [{smi}]")
        if not same:
            raise AssertionError("phase 11: the resumed run differs")

        params, opt = res["params"], res["opt_state"]
        del full, res
        _free()
        step = make_train_step(cfg, sched, TRAIN_CHUNK)
        batch = next(batches(TRAIN_STEPS))
        params, opt, _ = step(params, opt, batch)      # warm, not measured
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            params, opt, m = step(params, opt, batch)
            float(m["loss"])
            torch.cuda.synchronize()
            traced_wall = time.perf_counter() - t0
        trace = _device_summary(prof, traced_wall,
                                f"{TRAIN_ARCH} train step (B = {TRAIN_B}, "
                                f"S = {TRAIN_S})", smi)
        kernels = [e for e in prof.key_averages()
                   if str(e.device_type).endswith("CUDA")]
        trace["gemm_ms"] = sum(
            e.self_device_time_total for e in kernels
            if any(w in e.key.lower() for w in GEMM_NAMES)) / 1e3
        if not trace["gemm_ms"]:
            raise AssertionError("phase 11: no GEMM kernel in the trace")
        log(f"  of its {trace['device_kernel_ms']:.1f} ms of device time, "
            f"GEMM kernels {trace['gemm_ms']:.1f} ms "
            f"({flops['gemm_flop'] / (trace['gemm_ms'] / 1e3) / 1e12:.0f} "
            f"TFLOP/s over them); device time over the untraced p50 "
            f"{trace['device_kernel_ms'] / p50:.2%} [{smi}]")
        del params, opt, prof, kernels
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
        _free()
    return {"arch": TRAIN_ARCH, "params": n_params, "batch": TRAIN_B,
            "seq": TRAIN_S, "loss_chunk": TRAIN_CHUNK, "losses": losses,
            "step_ms": step_ms, "p50_step_ms": p50, "tokens_per_s": tok_s,
            "peak_device_memory_bytes": peak, **flops,
            "p50_over_bound": p50 / flops["bound_ms"],
            "checkpoint_saves": [{"ms": 1e3 * s, "bytes": b}
                                 for s, b in saves],
            "resumed_losses": r_losses, "resume_bitwise": same,
            "resume_wall_s": resume_s, "mean_share_moved": frac_moved,
            "trace": trace}


def _phase_train_launcher(smi: str) -> list:
    """11b: ``launch.train.main`` for every arch's smoke config, 3 steps,
    on the card (its default device)."""
    import io
    import numpy as np
    from repro_torch.configs import ARCH_IDS
    from repro_torch.launch import train as launch_train
    rows = []
    for arch in ARCH_IDS:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as out:
            res = launch_train.main(["--arch", arch, "--smoke", "--steps",
                                     "3"])
        losses = [h["loss"] for h in res["history"]]
        rows.append({"arch": arch, "losses": losses,
                     "wall_s": time.perf_counter() - t0})
        log(f"  launcher {arch} --smoke --steps 3: losses "
            f"{[round(x, 4) for x in losses]} in {rows[-1]['wall_s']:.1f} s"
            f" ({out.getvalue().strip().splitlines()[-1]}) [{smi}]")
        if len(losses) != 3 or not all(np.isfinite(losses)):
            raise AssertionError(f"phase 11: launcher {arch} {losses}")
    return rows


def _smoke_state(cfg, dev, seed: int = 0):
    """The smoke config's training state drawn on the CPU from ``seed``,
    and a copy on ``dev``."""
    import torch
    from repro_torch.models.layers import tree_map
    from repro_torch.optim.optimizers import AdamWState
    from repro_torch.train.loop import init_train_state
    p, o = init_train_state(torch.Generator().manual_seed(seed), cfg, "cpu")

    def on(d):
        return (tree_map(lambda t: t.to(d), p), AdamWState(
            o.step.to(d), tree_map(lambda t: t.to(d), o.mu),
            tree_map(lambda t: t.to(d), o.nu)))
    return on("cpu"), on(dev)


def _smoke_batch(cfg, rng, B=SMOKE_B, S=SMOKE_S, ignore=True) -> dict:
    """numpy-drawn tokens, labels (with ``ignore``, 15% set to -1) and stub
    inputs, as CPU tensors."""
    import numpy as np
    import torch
    from repro_torch.models.frontend import frontend_feature_shape
    labels = rng.integers(0, cfg.vocab_size, (B, S))
    if ignore:
        labels[rng.random((B, S)) < 0.15] = -1
    b = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)),
         "labels": labels}
    shape = frontend_feature_shape(cfg, B)
    if shape is not None:
        b["frames" if cfg.frontend == "audio" else "patches"] = \
            rng.normal(size=shape).astype(np.float32)
    return {k: torch.as_tensor(v) for k, v in b.items()}


def _grads(params, cfg, batch) -> list:
    from repro_torch.train.loop import loss_and_grads, make_loss_fn
    return loss_and_grads(make_loss_fn(cfg, SMOKE_CHUNK), params, batch)[2]


def _phase_train_card_vs_cpu(dev, smi: str) -> dict:
    """11c: every float32 smoke config, one step on the card and on the
    CPU (TF32 off); granite's remat policies bitwise on the card and its
    grad_accum 4 against 1."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import ARCH_IDS, get_smoke
    from repro_torch.models.layers import tree_leaves
    from repro_torch.optim.schedules import constant
    from repro_torch.train.loop import make_train_step
    rows = []
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for arch in ARCH_IDS:
            cfg = get_smoke(arch)
            (cp, co), (gp, go) = _smoke_state(cfg, dev)
            b = _smoke_batch(cfg, np.random.default_rng(7))
            gb = {k: v.to(dev) for k, v in b.items()}
            step = make_train_step(cfg, constant(1e-3), SMOKE_CHUNK)
            cm, gm = step(cp, co, b)[2], step(gp, go, gb)[2]
            worst = 0.0
            for c, g in zip(_grads(cp, cfg, b), _grads(gp, cfg, gb)):
                tol = GRAD_TOL * float(c.abs().max()) + 1e-6
                worst = max(worst, float((g.cpu() - c).abs().max()) / tol)
            rel = {k: abs(float(gm[k]) - float(cm[k])) / abs(float(cm[k]))
                   for k in ("loss", "grad_norm")}
            row = {"arch": arch, "loss_rel": rel["loss"],
                   "grad_norm_rel": rel["grad_norm"],
                   "grad_err_over_tol": worst,
                   "moe_dropped": float(gm["moe_dropped"]),
                   "dropped_equal": float(gm["moe_dropped"])
                   == float(cm["moe_dropped"])}
            rows.append(row)
            log(f"  smoke {arch} f32 step card vs CPU: loss rel "
                f"{rel['loss']:.2e}, grad_norm rel {rel['grad_norm']:.2e} "
                f"(tolerance {TRAIN_REL_TOL}), largest grad error "
                f"{worst:.3f} x its tolerance, moe_dropped "
                f"{row['moe_dropped']:.6f} equal {row['dropped_equal']} "
                f"[{smi}]")
            if max(rel.values()) > TRAIN_REL_TOL or worst > 1.0 \
                    or not row["dropped_equal"]:
                raise AssertionError(f"phase 11: smoke {arch} {row}")

        base = get_smoke("granite-8b")
        _, (gp, go) = _smoke_state(base, dev)
        # every label counted, as in the reference's accumulation test (a
        # microbatch's mean is over its own labels)
        gb = {k: v.to(dev) for k, v in _smoke_batch(
            base, np.random.default_rng(8), B=8, ignore=False).items()}
        runs = {}
        for remat, policy in ((False, "full"), (True, "full"),
                              (True, "boundaries")):
            cfg = dataclasses.replace(base, remat=remat, remat_policy=policy)
            runs[f"{remat}/{policy}"] = make_train_step(
                cfg, constant(1e-3), SMOKE_CHUNK)(gp, go, gb)
        (p0, o0, m0), *rest = runs.values()
        remat_same = all(
            all(torch.equal(m0[k], m[k]) for k in m0)
            and _trees_equal([p0, o0.mu, o0.nu], [p, o.mu, o.nu])
            for p, o, m in rest)
        cfg4 = dataclasses.replace(base, grad_accum=4)
        p4, _, m4 = make_train_step(cfg4, constant(1e-3), SMOKE_CHUNK)(
            gp, go, gb)
        loss_diff = abs(float(m4["loss"]) - float(m0["loss"]))
        accum_ok = loss_diff < 1e-3 and all(
            torch.allclose(a, c, rtol=2e-2, atol=2e-4)
            for (_, a), (_, c) in zip(tree_leaves(p4), tree_leaves(p0)))
        log(f"  granite smoke on the card: remat off / full / boundaries "
            f"bitwise {remat_same}; grad_accum 4 vs 1: loss diff "
            f"{loss_diff:.2e}, params within rtol 2e-2 / atol 2e-4 "
            f"{accum_ok} [{smi}]")
        if not (remat_same and accum_ok):
            raise AssertionError("phase 11: remat or grad_accum on the card")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return {"smoke": rows, "remat_bitwise": remat_same,
            "accum_loss_diff": loss_diff}


def _phase_train_learns(dev, smi: str) -> dict:
    """11d: granite smoke, 60 steps on the card on the port's token
    pipeline: the loss must fall by more than 1.0."""
    import torch
    from repro_torch.configs import get_smoke
    from repro_torch.data.lm_ds import LmDatasetSpec, batch_at
    from repro_torch.optim.schedules import warmup_cosine
    from repro_torch.train.loop import init_train_state, make_train_step
    cfg = get_smoke("granite-8b")
    ds = LmDatasetSpec(vocab_size=cfg.vocab_size, seq_len=LEARN_S)
    params, opt = init_train_state(torch.Generator(dev).manual_seed(0), cfg,
                                   dev)
    step = make_train_step(cfg, warmup_cosine(3e-3, 5, LEARN_STEPS),
                           loss_chunk=16)
    t0 = time.perf_counter()
    losses = []
    for i in range(LEARN_STEPS):
        t, l = batch_at(ds, 0, i, LEARN_B, device=dev)
        params, opt, m = step(params, opt, {"tokens": t, "labels": l})
        losses.append(m["loss"])
    losses = [float(x) for x in losses]
    wall = time.perf_counter() - t0
    log(f"  granite smoke, {LEARN_STEPS} steps of B = {LEARN_B}, S = "
        f"{LEARN_S}: loss {losses[0]:.4f} -> {losses[-1]:.4f} (drop "
        f"{losses[0] - losses[-1]:.4f}, needs > 1.0) in {wall:.1f} s "
        f"[{smi}]")
    if not losses[-1] < losses[0] - 1.0:
        raise AssertionError(f"phase 11: granite smoke did not learn "
                             f"{losses[0]} -> {losses[-1]}")
    return {"losses": losses, "wall_s": wall}


def phase_lm_train(dev, smi: str) -> dict:
    """Phase 11 (see the module docstring): LM training on the card."""
    from repro_torch.kernels import LAUNCHES, reset_launch_counts
    t_phase = time.perf_counter()
    reset_launch_counts()
    out, walls = {}, {}
    for name, run in (("full_width", lambda: _phase_train_full(dev, smi)),
                      ("launcher", lambda: _phase_train_launcher(smi)),
                      ("card_vs_cpu",
                       lambda: _phase_train_card_vs_cpu(dev, smi)),
                      ("learns", lambda: _phase_train_learns(dev, smi))):
        t0 = time.perf_counter()
        out[name] = run()
        walls[name] = time.perf_counter() - t0
        _free()
    stray = {k: v for k, v in LAUNCHES.items() if v}
    if stray:
        raise AssertionError(f"phase 11: LM training launched port kernels "
                             f"{stray}")
    log("  phase 11 launched none of the port's eight kernels (counts set "
        "to 0 before the phase, read after)")
    out["part_wall_s"] = walls
    out["phase_wall_s"] = time.perf_counter() - t_phase
    out["card"] = smi
    log(f"  phase 11 wall {out['phase_wall_s']:.1f} s ("
        + ", ".join(f"{k} {v:.1f} s" for k, v in walls.items())
        + f") [{smi}]")
    return out


# ---------------------------------------------------------------------------
# phase 12: the sharded LM paths (meshes on repeated cuda:0)
# ---------------------------------------------------------------------------

SHARD_ARCH = "olmoe-1b-7b"
SHARD_MESHES = (((1, 4), False), ((2, 2), False), ((1, 4), True))
SHARD_B, SHARD_S = 4, 512
SHARD_PROMPT_LENS, SHARD_STEPS = (128, 512), 16
SD_MESH = (4, 1)
FOLD_ARCH, FOLD_S = "granite-8b", 4096
FD_B, FD_H, FD_HK, FD_HD, FD_S, FD_POS = 4, 32, 8, 128, 32768, 30000
FD_MESHES = (((1, 4), ("model",), None), ((2, 2), ("model",), "data"))
COMP_ARCH, COMP_STEPS, PSUM_ROWS = "gemma3-1b", 3, 1 << 22
PR22_SD_DRIFT = 6.984   # PERF.md, PR 22's phase 9 (8 requests, 32 tokens)


def _mesh_on(shape, dev):
    from repro_torch.distributed import Mesh
    return Mesh(shape, ("data", "model"), [dev] * (shape[0] * shape[1]))


@contextlib.contextmanager
def _installed(mesh, seq_shard=False):
    from repro_torch.distributed import sharding as S
    S.set_mesh_rules(mesh, S.default_rules(False, seq_shard=seq_shard))
    try:
        yield mesh
    finally:
        S.clear_mesh_rules()


def _route_keys(out, n_tokens):
    """A dispatch's kept (expert, token) routes as sorted keys ``e * T +
    t`` (on the device)."""
    import torch
    _, idx, valid = out
    e = torch.arange(idx.shape[0], device=idx.device)[:, None]
    return torch.sort((e * n_tokens + idx)[valid > 0]).values


@contextlib.contextmanager
def _dispatch_keys():
    """Records the kept routes of every ``moe.dispatch`` call while open
    (``_route_keys``)."""
    from repro_torch.models import moe
    keys, own = [], moe.dispatch

    def dispatch(sel, capacity):
        out = own(sel, capacity)
        keys.append(_route_keys(out, sel.shape[0]))
        return out
    moe.dispatch = dispatch
    try:
        yield keys
    finally:
        moe.dispatch = own


@contextlib.contextmanager
def _shardmap_calls():
    """Records every ``moe_apply_shardmap`` call while open: its params,
    input, output, stats and each shard's kept routes (one ``dispatch``
    a shard, in shard order)."""
    from repro_torch.models import transformer as T
    calls, own = [], T.moe_apply_shardmap

    def shardmap(p, x, **kw):
        first = len(keys)
        out, st = own(p, x, **kw)
        calls.append({"p": p, "x": x, "out": out, "stats": st,
                      "routes": keys[first:], "kw": kw})
        return out, st
    T.moe_apply_shardmap = shardmap
    try:
        with _dispatch_keys() as keys:
            yield calls
    finally:
        T.moe_apply_shardmap = own


def _shardmap_vs_moe_apply(call) -> dict:
    """One layer's shard-map call against ``moe_apply`` on each token
    shard's tokens: outputs within ``_bf16_tol``, kept routes equal, and
    ``dropped_frac`` equal to the mean of the token shards' fractions (in
    the pmean's order)."""
    import numpy as np
    import torch
    from repro_torch.distributed import collectives as col
    from repro_torch.distributed.sharding import PartitionSpec as P
    from repro_torch.models import moe
    kw = dict(call["kw"])
    mesh, seq = kw.pop("mesh"), kw.pop("seq_shard")
    kw.pop("model_axis", None)
    axes = ("data", "model") if seq else ("data",)
    spec = P("data", "model" if seq else None, None)
    xs = col.split(call["x"], spec, mesh)
    outs = col.split(call["out"], spec, mesh)
    worst, bitwise, fracs, ref = 0.0, 0, [], {}
    for s in range(mesh.size):
        key = col.axis_index(mesh, axes, s)
        if key not in ref:
            with _dispatch_keys() as seen:
                o, st = moe.moe_apply(call["p"], xs[s], **kw)
            ref[key] = (o, st, seen[0])
            fracs.append(st.dropped_frac)
        o, _, keys = ref[key]
        if not torch.equal(call["routes"][s], keys):
            raise AssertionError(f"phase 12: shard {s}'s kept routes differ "
                                 f"from moe_apply's on its tokens")
        diff = float((outs[s].float() - o.float()).abs().max())
        tol = _bf16_tol(np.float32(o.float().abs().max().item()), 1)
        if diff > tol:
            raise AssertionError(f"phase 12: shard {s} output {diff} > {tol}")
        worst = max(worst, diff / tol)
        bitwise += int(torch.equal(outs[s], o))
    mean = fracs[0]
    for f in fracs[1:]:
        mean = mean + f
    mean = mean / len(fracs)
    if not torch.equal(call["stats"].dropped_frac, mean):
        raise AssertionError(f"phase 12: dropped_frac "
                             f"{float(call['stats'].dropped_frac)} != the "
                             f"mean of the shards' {float(mean)}")
    return {"worst_over_tol": worst, "bitwise_shards": bitwise,
            "shards": mesh.size, "token_shards": len(ref),
            "dropped_frac": float(mean)}


def _sharded_moe(dev, smi: str) -> dict:
    """12a: olmoe-1b-7b's shard-map forward on three meshes, each layer
    against per-shard ``moe_apply``, twice bitwise; then the shard-map
    engine on (1, 4) against the gather engine."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    cfg = get_config(SHARD_ARCH)
    params = T.init_model(torch.Generator(device=dev).manual_seed(0), cfg,
                          dev)
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        2, cfg.vocab_size, size=(SHARD_B, SHARD_S))).to(dev)
    gather_ms = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            x_gather, _, _ = T.forward(params, cfg, toks)
        torch.cuda.synchronize()
        gather_ms.append(1e3 * (time.perf_counter() - t0))
    log(f"  {SHARD_ARCH} gather forward B={SHARD_B} S={SHARD_S}: "
        f"{gather_ms[0]:.1f} / {gather_ms[1]:.1f} ms [{smi}]")
    out = {"arch": SHARD_ARCH, "B": SHARD_B, "S": SHARD_S,
           "gather_forward_ms": gather_ms, "runs": []}
    for shape, seq in SHARD_MESHES:
        scfg = dataclasses.replace(cfg, moe_impl="shardmap", seq_shard=seq)
        mesh = _mesh_on(shape, dev)
        with _installed(mesh, seq):
            runs, ms = [], []
            for _ in range(2):
                with _shardmap_calls() as calls, torch.no_grad():
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    x, st, _ = T.forward(params, scfg, toks)
                    torch.cuda.synchronize()
                    ms.append(1e3 * (time.perf_counter() - t0))
                runs.append((x, st, calls))
        (x1, st1, calls), (x2, st2, _) = runs
        if not (torch.equal(x1, x2) and torch.equal(st1.dropped_frac,
                                                    st2.dropped_frac)):
            raise AssertionError(f"phase 12: the {shape} forward does not "
                                 f"repeat bitwise")
        if len(calls) != cfg.n_layers:
            raise AssertionError(f"phase 12: {len(calls)} shard-map calls "
                                 f"for {cfg.n_layers} layers")
        layers = [_shardmap_vs_moe_apply(c) for c in calls]
        diff_gather = float((x1.float() - x_gather.float()).abs().max())
        row = {"mesh": list(shape), "seq_shard": seq, "forward_ms": ms,
               "bitwise_repeat": True,
               "worst_layer_over_tol": max(r["worst_over_tol"]
                                           for r in layers),
               "bitwise_layer_shards": sum(r["bitwise_shards"]
                                           for r in layers),
               "layer_shards": sum(r["shards"] for r in layers),
               "dropped_frac": float(st1.dropped_frac),
               "aux_loss": float(st1.aux_loss),
               "max_diff_vs_gather_forward": diff_gather}
        out["runs"].append(row)
        log(f"  {SHARD_ARCH} shard-map forward B={SHARD_B} S={SHARD_S} on "
            f"{shape}{' seq_shard' if seq else ''}: {ms[0]:.1f} / "
            f"{ms[1]:.1f} ms, bitwise twice; every layer's shards equal "
            f"moe_apply on their tokens (routes equal, outputs "
            f"{row['bitwise_layer_shards']} of {row['layer_shards']} "
            f"bitwise, worst {row['worst_layer_over_tol']:.3f} x _bf16_tol);"
            f" dropped_frac {row['dropped_frac']:.6f}, |x - gather forward| "
            f"{diff_gather:.4f} [{smi}]")
        del runs, calls, x1, x2
        _free()

    # the shard-map engine on (1, 4) against the gather engine
    reqs = _lm_requests(cfg, n=LM_SLOTS, lens=SHARD_PROMPT_LENS,
                        max_tokens=SHARD_STEPS + 1)
    _lm_serve(cfg, params, dev, cache_len=1024, reqs=_lm_requests(
        cfg, n=1, lens=(64, 64), max_tokens=4))            # warm-up
    eng, plain, reqs, _ = _lm_serve(cfg, params, dev, cache_len=1024,
                                    reqs=reqs)
    tokens = {r.uid: r.out_tokens for r in reqs}
    scfg = dataclasses.replace(cfg, moe_impl="shardmap")
    with _installed(_mesh_on((1, 4), dev)):
        seng, rec, _, _ = _lm_serve(scfg, params, dev, forced=tokens,
                                    cache_len=1024, reqs=_lm_requests(
                                        cfg, n=LM_SLOTS,
                                        lens=SHARD_PROMPT_LENS,
                                        max_tokens=SHARD_STEPS + 1))
    if seng.stats != eng.stats:
        raise AssertionError(f"phase 12: engine stats {seng.stats} != "
                             f"{eng.stats}")
    against = _lm_against(rec, plain, cfg.n_layers, "shard-map engine")
    if against["worst_diff_over_tol"] > 1.0:
        raise AssertionError(f"phase 12: shard-map engine logits "
                             f"{against['worst_diff_over_tol']} x tol")
    out["engine"] = {"mesh": [1, 4], "steps": len(rec.step_s),
                     "p50_step_ms": rec.p50_step_ms(),
                     "gather_p50_step_ms": plain.p50_step_ms(), **against}
    log(f"  shard-map ServeEngine on (1, 4), {LM_SLOTS} requests "
        f"({[len(r.prompt) for r in reqs]} prompt tokens), teacher-forced "
        f"{SHARD_STEPS} steps: logits within "
        f"{against['worst_diff_over_tol']:.3f} x _bf16_tol of the gather "
        f"engine's, {against['same_tokens']} of {against['calls']} own "
        f"tokens equal; p50 step "
        f"{rec.p50_step_ms():.3f} ms (gather {plain.p50_step_ms():.3f} ms) "
        f"[{smi}]")
    del params, eng, seng
    _free()
    return out


def _sd_events(cfg, frac: float, n_data: int) -> dict:
    """Input events (weight rows read) per RG-LRU layer and token, over
    its four event sets (x1 drives w_in and w_gate, x2 w_out, xf the FFN's
    gate and up, xd its down), unsharded and at ``n_data`` row shards."""
    from repro_torch.core.sd_decode import sd_cap
    sets = ((cfg.d_model, 2 * cfg.lru_dim), (cfg.lru_dim, cfg.d_model),
            (cfg.d_model, 2 * cfg.d_ff), (cfg.d_ff, cfg.d_model))
    plain = sharded = rows_plain = rows_sharded = 0
    for d_in, d_out in sets:
        cap = sd_cap(d_in, frac)
        local = max(4, min(d_in // n_data, -(-cap // n_data)))
        plain += cap
        sharded += n_data * local
        rows_plain += cap * d_out
        rows_sharded += n_data * local * d_out
    return {"events": plain, "events_sharded": sharded,
            "weight_bytes": 2 * rows_plain,
            "weight_bytes_sharded": 2 * rows_sharded}


def _sharded_sd(dev, smi: str) -> dict:
    """12b: recurrentgemma-2b's row-sharded sigma-delta decode under a
    (4, 1) mesh against the unsharded engine."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    cfg = get_config(LM_ARCH)
    params = T.init_model(torch.Generator(device=dev).manual_seed(0), cfg,
                          dev)

    def reqs():
        return _lm_requests(cfg, n=LM_SLOTS, lens=SHARD_PROMPT_LENS,
                            max_tokens=SHARD_STEPS + 1)
    _, dense, rs, _ = _lm_serve(cfg, params, dev, cache_len=1024,
                                reqs=reqs())
    tokens = {r.uid: r.out_tokens for r in rs}
    out = {"arch": LM_ARCH, "mesh": list(SD_MESH)}
    for frac in (1.0, LM_SD_FRAC):
        sd = dataclasses.replace(cfg, sd_decode_frac=frac)
        _, plain, _, _ = _lm_serve(sd, params, dev, forced=tokens,
                                   cache_len=1024, reqs=reqs())
        with _installed(_mesh_on(SD_MESH, dev)):
            _, shard, _, _ = _lm_serve(sd, params, dev, forced=tokens,
                                       cache_len=1024, reqs=reqs())
        drift = [max(float(np.abs(lg - d).max()) for (_, lg, _), (
            _, d, _) in zip(r.calls, dense.calls)) for r in (plain, shard)]
        row = {"frac": frac, "drift_vs_dense": drift[1],
               "unsharded_drift_vs_dense": drift[0],
               "p50_step_ms": shard.p50_step_ms(),
               "unsharded_p50_step_ms": plain.p50_step_ms(),
               **_sd_events(cfg, frac, SD_MESH[0])}
        if frac == 1.0:
            row.update(_lm_against(shard, plain, cfg.n_layers,
                                   "sharded sd 1.0"))
            if row["worst_diff_over_tol"] > 1.0:
                raise AssertionError(f"phase 12: sharded sd 1.0 "
                                     f"{row['worst_diff_over_tol']} x tol")
        out[str(frac)] = row
        log(f"  {LM_ARCH} sd_decode_frac {frac} on {SD_MESH}: drift vs "
            f"dense {drift[1]:.4f} (unsharded {drift[0]:.4f}; PR 22's "
            f"phase 9: {PR22_SD_DRIFT}), events per RG-LRU layer and token "
            f"{row['events_sharded']} (unsharded {row['events']}), "
            f"{row['weight_bytes_sharded'] / 1e6:.3f} MB of weights; p50 "
            f"step {row['p50_step_ms']:.3f} ms (unsharded "
            f"{row['unsharded_p50_step_ms']:.3f})"
            + (f"; within {row['worst_diff_over_tol']:.3f} x _bf16_tol of "
               f"the unsharded sd engine" if frac == 1.0 else "")
            + f" [{smi}]")
    del params
    _free()
    return out


def _folded(dev, smi: str) -> dict:
    """12c: granite-8b's forward at S = 4096, folded against plain."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    cfg = get_config(FOLD_ARCH)
    params = T.init_model(torch.Generator(device=dev).manual_seed(0), cfg,
                          dev)
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        2, cfg.vocab_size, size=(1, FOLD_S))).to(dev)
    res = {}
    for fold in (False, True, True, False):
        c = dataclasses.replace(cfg, causal_fold=fold)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            x, _, _ = T.forward(params, c, toks)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        if fold in res and not torch.equal(res[fold][0], x):
            raise AssertionError(f"phase 12: fold={fold} does not repeat")
        res.setdefault(fold, [x, []])[1].append(ms)
    if not torch.equal(res[True][0], res[False][0]):
        raise AssertionError("phase 12: the folded forward differs from the "
                             "plain one")
    nq = FOLD_S // cfg.attn_chunk_q
    out = {"arch": FOLD_ARCH, "S": FOLD_S, "Nq": nq,
           "kv_blocks_fold": nq * (nq + 1) // 2, "kv_blocks_plain": nq * nq,
           "fold_ms": res[True][1], "plain_ms": res[False][1],
           "bitwise": True}
    log(f"  {FOLD_ARCH} forward B=1 S={FOLD_S} (Nq {nq}): causal_fold "
        f"{res[True][1][0]:.1f} / {res[True][1][1]:.1f} ms, plain "
        f"{res[False][1][0]:.1f} / {res[False][1][1]:.1f} ms; the fold "
        f"computes {out['kv_blocks_fold']} of {out['kv_blocks_plain']} kv "
        f"blocks a layer, outputs bitwise equal [{smi}]")
    del params, res
    _free()
    return out


def _flash_decode(dev, smi: str) -> list:
    """12d: ``flash_decode_shardmap`` at granite-8b's attention shape
    against ``decode_attention``."""
    import torch
    from repro_torch.models.attention import (decode_attention,
                                              flash_decode_shardmap)
    g = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn(FD_B, 1, FD_H, FD_HD, generator=g, device=dev).to(
        torch.bfloat16)
    k, v = (torch.randn(FD_B, FD_S, FD_HK, FD_HD, generator=g,
                        device=dev).to(torch.bfloat16) for _ in range(2))
    want = decode_attention(q, k, v, FD_POS)
    plain_ms = cuda_ms(lambda: decode_attention(q, k, v, FD_POS), 10)
    # the least time: the caches and q read once, the output written once
    bound_ms = 1e3 * (k.numel() + v.numel() + 2 * q.numel()) * 2 \
        / HBM_BYTES_PER_S
    rows = []
    for shape, seq_axes, batch_axis in FD_MESHES:
        mesh = _mesh_on(shape, dev)

        def run():
            return flash_decode_shardmap(q, k, v, FD_POS, mesh, seq_axes,
                                         batch_axis)
        got = run()
        if not torch.equal(got, run()):
            raise AssertionError(f"phase 12: flash decode {shape} does not "
                                 f"repeat")
        w = want.float().cpu().numpy()
        diff = float((got.float() - want.float()).abs().max())
        tol = _bf16_tol(w, 1)
        if diff > tol:
            raise AssertionError(f"phase 12: flash decode {shape} {diff} > "
                                 f"{tol}")
        row = {"mesh": list(shape), "seq_axes": list(seq_axes),
               "batch_axis": batch_axis, "max_diff": diff, "tol": tol,
               "ms": cuda_ms(run, 10), "decode_attention_ms": plain_ms,
               "bound_ms": bound_ms}
        rows.append(row)
        log(f"  flash_decode_shardmap B={FD_B} H={FD_H} Hk={FD_HK} "
            f"hd={FD_HD} bf16 cache S={FD_S} on {shape} (seq {seq_axes}, "
            f"batch {batch_axis}): {row['ms']:.3f} ms, decode_attention "
            f"{plain_ms:.3f} ms, bound {bound_ms:.4f} ms (the bf16 caches "
            f"read once at 3.35 TB/s); max |diff| {diff:.5f}, tolerance "
            f"{tol:.5f} [{smi}]")
    return rows


def _compression(dev, smi: str) -> dict:
    """12e: error-feedback int8 compression of a gemma3-1b-shaped float32
    gradient tree, and ``int8_psum`` on a (4, 1) mesh, each against the
    CPU."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.distributed import collectives as col
    from repro_torch.distributed import compression as C
    from repro_torch.distributed.sharding import PartitionSpec as P
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import tree_leaves, tree_map
    cfg = get_config(COMP_ARCH)
    g = torch.Generator(device=dev).manual_seed(0)
    grads = tree_map(lambda d: torch.randn(d.shape, generator=g, device=dev)
                     * 1e-3, T.model_decls(cfg))
    n = sum(t.numel() for _, t in tree_leaves(grads))
    ef = C.ef_init(grads)
    ms = []
    for step in range(COMP_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        q8, scales, new = C.ef_compress(grads, ef)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        if step == 0:       # the card against the CPU, from zero residuals
            checked = []
            for path in (("embed",), ("layers", 0)):
                sub = [grads, q8, scales]
                for k in path:
                    sub = [t[k] for t in sub]
                for (p, gl), (_, ql), (_, sl) in zip(*map(
                        lambda t: list(tree_leaves(t)), sub)):
                    cq, cs, _ = C._compress_leaf(gl.cpu(), torch.zeros(
                        gl.shape))
                    if not (torch.equal(cq, ql.cpu())
                            and torch.equal(cs, sl.cpu())):
                        raise AssertionError(f"phase 12: int8 codes of "
                                             f"{path + p} card != CPU")
                    checked.append(".".join(map(str, path + p)))
        ef = new
        del q8, scales
    ratio = C.compression_ratio(grads)
    del grads, ef, new
    _free()
    mesh, cpu = _mesh_on((4, 1), dev), _mesh_on((4, 1), "cpu")
    x = torch.randn(4 * PSUM_ROWS, generator=g, device=dev)
    got = col.join(C.int8_psum(col.split(x, P("data"), mesh), "data", mesh),
                   P(), mesh)
    xc = x.cpu()
    want = col.join(C.int8_psum(col.split(xc, P("data"), cpu), "data", cpu),
                    P(), cpu)
    exact = col.join(col.psum(col.split(xc, P("data"), cpu), "data", cpu),
                     P(), cpu)
    scale = float(xc.abs().max()) / 127.0
    err = float((want - exact).abs().max())
    if not torch.equal(got.cpu(), want) or err > 4 * scale / 2:
        raise AssertionError(f"phase 12: int8_psum card == CPU "
                             f"{torch.equal(got.cpu(), want)}, error {err} "
                             f"against {4 * scale / 2}")
    out = {"arch": COMP_ARCH, "values": n, "leaves_checked": checked,
           "ef_compress_ms": ms, "compression_ratio": ratio,
           "int8_psum_rows": PSUM_ROWS, "int8_psum_max_err": err,
           "int8_psum_bound": 4 * scale / 2}
    log(f"  ef_compress over a {COMP_ARCH}-shaped float32 tree ({n} "
        f"values): {', '.join(f'{m:.1f}' for m in ms)} ms a step; codes and "
        f"scales card == CPU bitwise for {len(checked)} leaves (embed, "
        f"layer 0); compression_ratio {ratio:.6f}; int8_psum over (4, 1), "
        f"{PSUM_ROWS} values a shard: card == CPU bitwise, max error "
        f"{err:.3e} <= n * scale / 2 = {4 * scale / 2:.3e} [{smi}]")
    return out


def phase_lm_sharded(dev, smi: str) -> dict:
    """Phase 12 (see the module docstring): the sharded LM paths."""
    from repro_torch.kernels import LAUNCHES, reset_launch_counts
    t_phase = time.perf_counter()
    reset_launch_counts()
    out, walls = {}, {}
    for name, run in (("moe", _sharded_moe), ("sd", _sharded_sd),
                      ("fold", _folded), ("flash_decode", _flash_decode),
                      ("compression", _compression)):
        t0 = time.perf_counter()
        out[name] = run(dev, smi)
        walls[name] = time.perf_counter() - t0
        _free()
    stray = {k: v for k, v in LAUNCHES.items() if v}
    if stray:
        raise AssertionError(f"phase 12: the sharded paths launched port "
                             f"kernels {stray}")
    log("  phase 12 launched none of the port's eight kernels (counts set "
        "to 0 before the phase, read after)")
    out["part_wall_s"] = walls
    out["phase_wall_s"] = time.perf_counter() - t_phase
    out["card"] = smi
    log(f"  phase 12 wall {out['phase_wall_s']:.1f} s ("
        + ", ".join(f"{k} {v:.1f} s" for k, v in walls.items())
        + f") [{smi}]")
    return out


DRY_DECODE = (("recurrentgemma-2b", 4, 4096, 1.608),    # phase 9's cell
              ("olmoe-1b-7b", 4, 2048, 4.451))         # phase 10's
DEVICE_BYTES = 80e9                                    # H100 80GB HBM3


def _meta_mesh():
    from repro_torch.distributed.mesh import Mesh
    return Mesh((1, 1), ("data", "model"), ["meta"])


def _card_flops(fn, args) -> int:
    """``FlopCounterMode`` around one real run of ``fn`` on the card."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as fc:
        out = fn(*args)
        del out
    torch.cuda.synchronize()
    return fc.get_total_flops()


def _dryrun_cells(smi: str) -> list:
    """13a: every supported decode_32k and long_500k cell on both
    production meshes and gemma3-1b train_4k on the single-pod one, on
    meta tensors: every status ok, no byte allocated on the card."""
    import torch
    from repro_torch.configs import ARCH_IDS, cell_supported
    from repro_torch.launch import dryrun as D
    before = torch.cuda.memory_allocated()
    cells = [(a, n, mp) for a in ARCH_IDS for n in ("decode_32k", "long_500k")
             if cell_supported(a, n)[0] for mp in (False, True)]
    cells.append(("gemma3-1b", "train_4k", False))
    out = []
    for arch, name, mp in cells:
        rec = D.run_cell(arch, name, mp, verbose=False)
        if rec["status"] != "ok":
            raise AssertionError(f"phase 13a: {arch} x {name}: {rec}")
        row = {k: rec[k] for k in ("arch", "shape", "mesh", "run_s",
                                   "flops_global", "flops_per_device",
                                   "state_bytes_per_device",
                                   "peak_live_bytes_global",
                                   "bytes_global_unfused")}
        row["wire_bytes_per_device"] = rec["collectives"]["total_wire_bytes"]
        out.append(row)
        log(f"  {arch} x {name} x {rec['mesh']}: run {rec['run_s']:.2f} s, "
            f"{rec['flops_per_device']:.4e} FLOP/device, state "
            f"{rec['state_bytes_per_device']:.4e} B/device "
            f"({rec['state_bytes_per_device'] / DEVICE_BYTES:.2%} of 80 GB), "
            f"wire {row['wire_bytes_per_device']:.4e} B/device")
    after = torch.cuda.memory_allocated()
    if after != before:
        raise AssertionError(f"phase 13a: the meta cells allocated "
                             f"{after - before} bytes on the card")
    log(f"  13a: {len(out)} cells ok on meta, card memory unchanged "
        f"({after} bytes allocated before and after) [{smi}]")
    return out


def _dryrun_train_cell(dev, smi: str) -> dict:
    """13b: phase 11's cell through ``build_step_fn`` on a 1 x 1 mesh, on
    meta and on the card: FLOPs and state bytes exactly equal."""
    import torch
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.distributed.mesh import Mesh
    from repro_torch.distributed.sharding import default_rules
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import specs as SP
    from repro_torch.models.layers import tree_leaves
    cfg = get_config(TRAIN_ARCH)
    shape = ShapeSpec("phase11", TRAIN_S, TRAIN_B, "train")
    rules = default_rules(False)
    fn, args, _ = D.build_step_fn(cfg, shape, _meta_mesh(), rules,
                                  loss_chunk=TRAIN_CHUNK)
    meta = D.measure(fn, args)
    del fn, args
    _free()
    torch.cuda.reset_peak_memory_stats()
    fn, args, state = D.build_step_fn(
        cfg, shape, Mesh((1, 1), ("data", "model"), [dev]), rules,
        device=dev, loss_chunk=TRAIN_CHUNK,
        gen=torch.Generator(dev).manual_seed(0))
    params, opt, _ = args
    held = sum(t.numel() * t.element_size() for t in
               [x for _, x in tree_leaves(params)] + [opt.step]
               + [x for _, x in tree_leaves(opt.mu)]
               + [x for _, x in tree_leaves(opt.nu)])
    state_bytes = SP.state_bytes_per_device(state)
    card = _card_flops(fn, args)
    peak = torch.cuda.max_memory_allocated()
    del fn, args, params, opt
    _free()
    if card != meta["flops"]:
        raise AssertionError(f"phase 13b: meta counts {meta['flops']} FLOPs,"
                             f" the card step {card}")
    if state_bytes != held:
        raise AssertionError(f"phase 13b: state bytes {state_bytes} != the "
                             f"{held} bytes the card holds")
    formula = _train_step_flops(cfg, TRAIN_B, TRAIN_S)
    rel = meta["flops"] / formula["total_flop"] - 1.0
    log(f"  13b: {TRAIN_ARCH} B = {TRAIN_B}, S = {TRAIN_S}, chunk "
        f"{TRAIN_CHUNK}: {card} FLOPs on the card == {meta['flops']} on meta "
        f"({meta['flops_by_op']}); _train_step_flops {formula['total_flop']}"
        f" ({rel:+.4%}); state {state_bytes:.0f} B == held; peak live "
        f"{meta['peak_live_bytes'] / 2**30:.2f} GiB (meta) beside "
        f"max_memory_allocated {peak / 2**30:.2f} GiB; meta run "
        f"{meta['run_s']:.1f} s [{smi}]")
    if abs(rel) > 0.005:
        raise AssertionError(f"phase 13b: _train_step_flops is {rel:+.3%} "
                             f"off the count")
    return {"flops": card, "flops_by_op": meta["flops_by_op"],
            "formula_flops": formula["total_flop"], "formula_rel": rel,
            "formula_bound_ms": formula["bound_ms"],
            "state_bytes": state_bytes, "peak_live_bytes_meta":
            meta["peak_live_bytes"], "max_memory_allocated": peak,
            "meta_run_s": meta["run_s"]}


def _dryrun_decode_cells(dev, smi: str) -> list:
    """13c: phase 9's and phase 10's decode cells, meta against the card:
    FLOPs exactly equal; state bytes over 3.35 TB/s beside their HBM
    bounds."""
    import torch
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.distributed.mesh import Mesh
    from repro_torch.distributed.sharding import default_rules
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import specs as SP
    out = []
    for arch, B, S, bound_ms in DRY_DECODE:
        cfg = get_config(arch)
        shape = ShapeSpec("decode", S, B, "decode")
        rules = default_rules(False)
        fn, args, state = D.build_step_fn(cfg, shape, _meta_mesh(), rules)
        meta = D.measure(fn, args)
        del fn, args
        fn, args, _ = D.build_step_fn(
            cfg, shape, Mesh((1, 1), ("data", "model"), [dev]), rules,
            device=dev, gen=torch.Generator(dev).manual_seed(0))
        card = _card_flops(fn, args)
        del fn, args
        _free()
        if card != meta["flops"]:
            raise AssertionError(f"phase 13c: {arch}: meta counts "
                                 f"{meta['flops']} FLOPs, the card {card}")
        sb = SP.state_bytes_per_device(state)
        ms = 1e3 * sb / HBM_BYTES_PER_S
        log(f"  13c: {arch} B = {B}, cache {S}: {card} FLOPs card == meta; "
            f"state {sb:.0f} B / 3.35 TB/s = {ms:.3f} ms beside the "
            f"{bound_ms} ms HBM bound of its phase [{smi}]")
        out.append({"arch": arch, "B": B, "S": S, "flops": card,
                    "state_bytes": sb, "state_ms": ms,
                    "phase_bound_ms": bound_ms})
    return out


def _dryrun_issued(dev, smi: str) -> dict:
    """13d: olmoe smoke with the shard-map MoE on a (2, 2) mesh: the
    collectives issued on meta equal those issued on repeated cuda:0 with
    real data."""
    import torch
    from repro_torch.configs import ShapeSpec, get_smoke
    from repro_torch.distributed import collectives as col
    from repro_torch.distributed.mesh import Mesh
    from repro_torch.distributed.sharding import (clear_mesh_rules,
                                                  default_rules,
                                                  set_mesh_rules)
    from repro_torch.launch import dryrun as D
    cfg = dataclasses.replace(get_smoke("olmoe-1b-7b"), moe_impl="shardmap")
    rules = default_rules(False)
    out = {}
    for kind in ("train", "decode"):
        got = {}
        for device in ("meta", dev):
            mesh = Mesh((2, 2), ("data", "model"), [device] * 4)
            set_mesh_rules(mesh, rules)
            try:
                fn, args, _ = D.build_step_fn(
                    cfg, ShapeSpec("s", 32, 4, kind), mesh, rules,
                    device=device)
                with col.counting() as rows:
                    fn(*args)
                torch.cuda.synchronize()
            finally:
                clear_mesh_rules()
            got[str(device)] = rows
        meta, card = got["meta"], got[str(dev)]
        if meta != card or not meta:
            raise AssertionError(f"phase 13d: {kind}: issued rows differ "
                                 f"(meta {len(meta)}, card {len(card)})")
        summ = D.summarize_collectives(meta)
        log(f"  13d: olmoe smoke shard-map {kind} on (2, 2): {len(meta)} "
            f"issued rows equal on meta and on cuda:0 x 4; wire "
            f"{summ['total_wire_bytes']:.0f} B/device [{smi}]")
        out[kind] = {"rows": len(meta), "wire_bytes":
                     summ["total_wire_bytes"]}
    return out


def phase_dryrun(dev, smi: str) -> dict:
    """Phase 13 (see the module docstring): the dry-run."""
    from repro_torch.kernels import LAUNCHES, reset_launch_counts
    t_phase = time.perf_counter()
    reset_launch_counts()
    out, walls = {}, {}
    for name, run in (("cells", lambda: _dryrun_cells(smi)),
                      ("train_cell", lambda: _dryrun_train_cell(dev, smi)),
                      ("decode_cells", lambda: _dryrun_decode_cells(dev, smi)),
                      ("issued", lambda: _dryrun_issued(dev, smi))):
        t0 = time.perf_counter()
        out[name] = run()
        walls[name] = time.perf_counter() - t0
        _free()
    stray = {k: v for k, v in LAUNCHES.items() if v}
    if stray:
        raise AssertionError(f"phase 13: the dry-run launched port kernels "
                             f"{stray}")
    log("  phase 13 launched none of the port's eight kernels (counts set "
        "to 0 before the phase, read after)")
    out["part_wall_s"] = walls
    out["phase_wall_s"] = time.perf_counter() - t_phase
    out["card"] = smi
    log(f"  phase 13 wall {out['phase_wall_s']:.1f} s ("
        + ", ".join(f"{k} {v:.1f} s" for k, v in walls.items())
        + f") [{smi}]")
    return out


EXAMPLE_TRAINED = ["--source", "file", "--weights", "trained"]
GOLDEN_KEYS = ("class_counts", "predictions", "per_layer_events",
               "inter_layer_dropped", "input_dropped")
# the kernels each lowering launches (``kernels.LAUNCHES`` names)
LOWERING_KERNELS = {
    "per-step": ("event_conv_batched", "event_pool_batched",
                 "event_fc_batched"),
    "fused-window": ("event_conv_window", "event_pool_window",
                     "event_fc_window"),
    "fused-network": ("network_window",)}


def _example(main, argv, want=(), what: str = ""):
    """One example's ``main(argv)`` (its printout on stderr) with the
    launch counts set to 0 just before and read just after, each kernel of
    ``want`` required among them: ``(result, launches, wall s)``."""
    import torch
    from repro_torch.kernels import LAUNCHES, reset_launch_counts
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        out = main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = {k: v for k, v in LAUNCHES.items() if v}
    missing = [k for k in want if not got.get(k)]
    if missing:
        raise AssertionError(f"phase 14 {what}: {missing} never launched "
                             f"({got})")
    return out, got, wall


def _examples_accounting(dev, smi: str) -> dict:
    """14a: the selfcheck at the conv1 shape and the Fig. 6 accounting."""
    import numpy as np
    import torch
    from repro_torch.core import layer_program as lp
    from repro_torch.core.policies import ExecutionPolicy
    from repro_torch.core.quant import quantize_net
    from repro_torch.core.sne_net import dvs_gesture_net, init_snn
    from repro_torch.kernels.event_conv.ref import selfcheck_batched_bitexact
    from repro_torch.kernels.network_window import SMEM_BUDGET
    t0 = time.perf_counter()
    selfcheck_batched_bitexact(N_SLOTS, 32, 32, 16, 5, 2, 512, seed=0,
                               device=dev)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    spec = dvs_gesture_net()
    specs = {"f32-carrier": spec, "int8-native": quantize_net(init_snn(
        np.random.default_rng(0), spec, device="cpu"), spec).spec}
    out = {"selfcheck_ms": ms, "state_bytes": {}, "scratch_bytes": {}}
    for dp in DTYPE_POLICIES:
        progs = {f: lp.compile_program(specs[dp], policy=ExecutionPolicy(
            dtype_policy=dp, fusion_policy=f), device=dev)
            for f in LOWERINGS}
        prog = progs["fused-window"]
        held = sum(lp.padded_state(op, N_SLOTS, device=dev).nbytes
                   for op in prog.ops)
        if lp.state_bytes(prog, N_SLOTS) != held:
            raise AssertionError(f"phase 14 {dp}: state_bytes "
                                 f"{lp.state_bytes(prog, N_SLOTS)} != the "
                                 f"{held} bytes the card holds")
        out["state_bytes"][dp] = held
        out["scratch_bytes"][dp] = {
            f: lp.window_scratch_bytes(p, WINDOW, n_slots=N_SLOTS)
            for f, p in progs.items()}
        if max(out["scratch_bytes"][dp].values()) > SMEM_BUDGET:
            raise AssertionError(f"phase 14 {dp}: {out['scratch_bytes']}")
    log(f"  14a selfcheck_batched_bitexact at conv1 (8 x 32x32, K 5, 2 -> "
        f"16, 512 events): batched == N = 1 faces == plain, bitwise, "
        f"{ms:.1f} ms; Fig. 6 state bytes at 8 slots {out['state_bytes']}, "
        f"shared memory per block {out['scratch_bytes']} [{smi}]")
    return out


def _examples_quickstart(dev, smi: str) -> dict:
    """14b: quickstart on the card against itself and the CPU."""
    import numpy as np
    from repro_torch.examples import quickstart
    card, launched, wall = _example(
        quickstart.main, ["--device", str(dev)],
        LOWERING_KERNELS["per-step"], "quickstart")
    with contextlib.redirect_stdout(sys.stderr):
        cpu = quickstart.main(["--device", "cpu"])
    for k in ("pred_dense", "pred_event", "total_events", "total_sops"):
        if card[k] != cpu[k]:
            raise AssertionError(f"quickstart {k}: card {card[k]} != CPU "
                                 f"{cpu[k]}")
    if not np.array_equal(card["class_counts"], cpu["class_counts"]):
        raise AssertionError("quickstart class counts: card != CPU")
    log(f"  14b quickstart: event path == dense path == the CPU's run, "
        f"bitwise (class {card['pred_event']}, {card['total_events']:.0f} "
        f"events, {card['total_sops']:.0f} SOPs); {wall:.2f} s, launches "
        f"{launched} [{smi}]")
    return {"wall_s": wall, "launches": launched,
            "total_events": card["total_events"]}


def _examples_serve(dev, smi: str) -> dict:
    """14c: serve_events on the bundled recording, every lowering, dtype
    policy and mode, and on a mesh of repeated ``cuda:0``."""
    import numpy as np
    from repro_torch.examples import serve_events
    gold = np.load(GOLDEN)
    runs, total = [], {}
    cells = [(f, dp, mode, []) for f in LOWERINGS for dp in DTYPE_POLICIES
             for mode in ("sync", "streaming")]
    cells += [("fused-window", dp, "sync",
               ["--backend", "mesh", "--devices", f"{dev},{dev}"])
              for dp in DTYPE_POLICIES]
    for f, dp, mode, extra in cells:
        what = f"serve_events {f} {dp} {mode} {' '.join(extra)}".strip()
        out, launched, wall = _example(
            serve_events.main,
            ["--device", str(dev)] + EXAMPLE_TRAINED
            + ["--fusion-policy", f, "--dtype-policy", dp, "--mode", mode]
            + extra, LOWERING_KERNELS[f], what)
        for k in GOLDEN_KEYS:
            if not np.array_equal(out[k], gold[k]):
                raise AssertionError(f"{what}: {k} differs from the golden:"
                                     f"\n{out[k]}\nvs\n{gold[k]}")
        windows = out["stats"]["windows"]
        n = sum(launched.values())
        if mode == "sync" and f == "fused-network" and not extra \
                and n != out["stats"]["kernel_launches"]:
            raise AssertionError(f"{what}: LAUNCHES {n} != the engine's "
                                 f"{out['stats']['kernel_launches']}")
        for k, v in launched.items():
            total[k] = total.get(k, 0) + v
        runs.append({"lowering": f, "dtype_policy": dp, "mode": mode,
                     "mesh": bool(extra), "windows": windows,
                     "launches": launched,
                     "launches_per_window": n / max(windows, 1),
                     "engine_kernel_launches":
                         out["stats"]["kernel_launches"],
                     "wall_s": wall})
        log(f"  14c {what}: {len(out['predictions'])} requests equal the "
            f"golden ({', '.join(GOLDEN_KEYS)}); {windows} windows, "
            f"{n / max(windows, 1):.2f} launches a window (LAUNCHES), "
            f"{wall:.2f} s [{smi}]")
    return {"runs": runs, "launches": total}


def _examples_train(dev, smi: str) -> dict:
    """14d: train_dvs_gesture at full width, the saved net read back."""
    import tempfile
    import numpy as np
    import torch
    from repro_torch.core.sne_net import dvs_gesture_net
    from repro_torch.examples import train_dvs_gesture
    from repro_torch.weights import load_net
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "fig6.npz")
        out, launched, wall = _example(
            train_dvs_gesture.main,
            ["--device", str(dev), "--scale", "full", "--qat", "--steps",
             "4", "--batch", "8", "--test-n", "8", "--save-net", path],
            LOWERING_KERNELS["per-step"], "train_dvs_gesture")
        back, meta = load_net(path, dvs_gesture_net(), device=dev)
    if not np.isfinite(out["losses"]).all() or len(out["losses"]) != 4:
        raise AssertionError(f"train_dvs_gesture losses {out['losses']}")
    for a, b in zip(back, out["params"]):
        if not torch.equal(a.w, b.w):
            raise AssertionError("train_dvs_gesture: the saved net does not "
                                 "load back bitwise")
    res = {"losses": [float(x) for x in out["losses"]],
           "step_ms": [1e3 * float(x) for x in out["step_s"]],
           "p50_step_ms": 1e3 * float(np.median(out["step_s"][1:])),
           "event_ms": [float(x) for x in out["event_ms"]],
           "p50_event_ms": float(np.median(out["event_ms"])),
           "eval_acc": out["eval_acc"], "acc_dense": out["acc_dense"],
           "acc_event": out["acc_event"], "agreement": out["agreement"],
           "mean_events": out["mean_events"],
           "input_dropped": int(out["input_dropped"]),
           "layer_dropped": out["layer_dropped"], "launches": launched,
           "wall_s": wall}
    log(f"  14d train_dvs_gesture --scale full (Fig. 6, 128x128x2, T = "
        f"100, B = 8, QAT): losses {[round(x, 4) for x in res['losses']]}, "
        f"p50 step (steps 2-4) {res['p50_step_ms']:.1f} ms; event path "
        f"{res['p50_event_ms']:.1f} ms an inference (p50 of 8); accuracy "
        f"dense {res['acc_dense']:.3f}, event {res['acc_event']:.3f}, "
        f"agreement {res['agreement']:.3f}; dropped: input "
        f"{res['input_dropped']}, per layer {res['layer_dropped']}; saved "
        f"net loaded back bitwise; {wall:.1f} s [{smi}]")
    return res


def _examples_sparsity(dev, smi: str) -> dict:
    """14e: event_sparsity on the card against the CPU's run."""
    from repro_torch.examples import event_sparsity
    card, launched, wall = _example(
        event_sparsity.main, ["--device", str(dev)],
        LOWERING_KERNELS["per-step"], "event_sparsity")
    with contextlib.redirect_stdout(sys.stderr):
        cpu = event_sparsity.main(["--device", "cpu"])
    for a, b in zip(card["activity"], cpu["activity"]):
        if (a["events"], a["sops"]) != (b["events"], b["sops"]):
            raise AssertionError(f"event_sparsity part 1: card {a} != CPU "
                                 f"{b}")
    for a, b in zip(card["sigma_delta"], cpu["sigma_delta"]):
        if a["event_frac"] != b["event_frac"]:
            raise AssertionError(f"event_sparsity part 2: card {a} != CPU "
                                 f"{b}")
    log(f"  14e event_sparsity: R^2 {card['r2']:.6f} (> 0.999), part 1 "
        f"events {[r['events'] for r in card['activity']]} and SOPs equal "
        f"the CPU's, part 2 event fractions equal; {wall:.2f} s, launches "
        f"{launched} [{smi}]")
    return {"r2": card["r2"], "activity": card["activity"],
            "sigma_delta": card["sigma_delta"], "wall_s": wall,
            "launches": launched}


def _examples_lm(dev, smi: str) -> dict:
    """14f: serve_lm on granite smoke, greedy, 4 requests."""
    from repro_torch.examples import serve_lm
    out, launched, wall = _example(
        serve_lm.main, ["--device", str(dev), "--arch", "granite-8b",
                        "--requests", "4", "--temperature", "0"],
        (), "serve_lm")
    if not all(out["done"]) or launched:
        raise AssertionError(f"serve_lm: done {out['done']}, launches "
                             f"{launched}")
    log(f"  14f serve_lm granite smoke: 4 of 4 requests done, "
        f"{out['stats']['generated']} tokens in {out['wall_s']:.2f} s, no "
        f"port kernel [{smi}]")
    return {"stats": out["stats"], "wall_s": out["wall_s"]}


def phase_examples(dev, smi: str) -> dict:
    """Phase 14 (see the module docstring): the examples."""
    t_phase = time.perf_counter()
    out, walls = {}, {}
    for name, run in (("accounting", _examples_accounting),
                      ("quickstart", _examples_quickstart),
                      ("serve_events", _examples_serve),
                      ("train_dvs_gesture", _examples_train),
                      ("event_sparsity", _examples_sparsity),
                      ("serve_lm", _examples_lm)):
        t0 = time.perf_counter()
        out[name] = run(dev, smi)
        walls[name] = time.perf_counter() - t0
        _free()
    # the main-path launches of the examples, per kernel
    launches = dict(out["serve_events"]["launches"])
    for name in ("quickstart", "train_dvs_gesture", "event_sparsity"):
        for k, v in out[name]["launches"].items():
            launches[k] = launches.get(k, 0) + v
    out["launches"] = launches
    out["part_wall_s"] = walls
    out["phase_wall_s"] = time.perf_counter() - t_phase
    out["card"] = smi
    log(f"  phase 14 launches {launches}; wall {out['phase_wall_s']:.1f} s ("
        + ", ".join(f"{k} {v:.1f} s" for k, v in walls.items())
        + f") [{smi}]")
    return out


def _kernel_entry(name, mine, launches):
    """One kernel's line of the JSON: the main path's configuration (f32;
    the window kernels and the megakernel with the sparse bitmaps the main
    path gives them; the LIF kernel on the conv1 slab's shape, dt = 1, no
    clip), summed over the layers of its kind."""
    main = [r for r in mine if r.get("main", r["pairing"] == "f32"
                                     and r.get("bitmap", "sparse")
                                     in ("sparse", "none"))]
    lib = [r["library_ms"] for r in main]
    dev = [r["device_ms"] for r in main]
    return {
        "name": name, "route": "cuda", "source": SOURCES[name],
        "replaces": REPLACES[name], "launches": launches[name],
        "max_abs_err": max(r["max_abs_err"] for r in mine),
        "ms": sum(r["ms"] for r in main),
        "device_ms": None if None in dev else sum(dev),
        "plain_ms": sum(r["plain_ms"] for r in main),
        "bound_ms": sum(r["bound_ms"] for r in main),
        "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in main)
        else "operations",
        "library_ms": None if None in lib else sum(lib),
        "layers": [r.get("layer") for r in main],
        "per_shape": mine,
    }


def main() -> int:
    """Run every phase; 0 only if all passed."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device — this script runs the port on "
              "the GPU only", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 3
    from repro_torch.core.layer_program import compile_program
    from repro_torch.core.quant import quantize_net
    from repro_torch.core.sne_net import dvs_gesture_net, init_snn
    from repro_torch.kernels import _build
    import numpy as np

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    smi = nvidia_smi()
    log(f"phase 1: device and build — {smi}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    secs = _build.build_all()
    n_src = len(list(_build.CSRC.glob("*.cu")))
    log(f"  built {len(_build.BUILD_LOG)} of {n_src} CUDA sources in "
        f"{secs:.1f} s (the rest were already built)")
    for src, text in sorted(_build.BUILD_LOG.items()):
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"  {src}: {line.strip()}")
    torch.cuda.synchronize()

    spec = dvs_gesture_net()
    qn = quantize_net(init_snn(np.random.default_rng(0), spec, device=dev),
                      spec)
    log("phase 2a: per-step kernels against their plain versions at the "
        "Fig. 6 shapes")
    rows = phase_kernels(compile_program(qn.spec, device=dev), dev)
    log("phase 2b: window kernels against their plain versions on a real "
        "window of the main path")
    rows_b, captured = phase_window_kernels(spec, qn, dev)
    rows += rows_b
    log("phase 2c: the fused-network megakernel on the same window, and the "
        "fused LIF kernel")
    rows += phase_network_kernel(captured, dev)
    rows += phase_lif_kernel(dev)

    log("phase 3: trained checkpoint against the golden")
    phase_golden(dev)

    log("phase 4: full-width Fig. 6 serving (the main path)")
    main_path = phase_full_width(spec, qn, dev, smi)

    log("phase 5: the streaming runtime on the full-width Fig. 6 network")
    streaming = phase_streaming(spec, qn, dev, smi)

    log("phase 6: surrogate-gradient training of the full-width Fig. 6 "
        "network, resumed, evaluated and served")
    training = phase_training(dev, smi)

    log("phase 7: the single-stream event path on the full-width Fig. 6 "
        "network")
    event_path = phase_event_path(spec, qn, dev, smi, main_path["outputs"])

    log("phase 8: the mesh backend (slot shards) on the full-width Fig. 6 "
        "network")
    mesh = phase_mesh(spec, qn, dev, smi, main_path)

    log("phase 9: LM serving, full-width recurrentgemma-2b on ServeEngine")
    lm_serve = phase_lm(dev, smi)
    _free()

    log("phase 10: LM architectures on the card (olmoe-1b-7b bf16 and int8,"
        " xlstm-1.3b, whisper-medium, internvl2-26b cut to 8 layers)")
    lm_archs = phase_lm_archs(dev, smi)
    _free()

    log("phase 11: LM training on the card (gemma3-1b at full width, the "
        "launcher on every smoke config, card vs CPU, learning)")
    lm_train = phase_lm_train(dev, smi)
    _free()

    log("phase 12: the sharded LM paths on meshes of repeated cuda:0 "
        "(olmoe-1b-7b expert-parallel MoE, recurrentgemma-2b row-sharded "
        "sigma-delta decode, granite-8b folded causal attention, flash-decode"
        " combine, int8 gradient compression)")
    lm_sharded = phase_lm_sharded(dev, smi)
    _free()

    log("phase 13: the multi-pod dry-run on meta tensors (every decode and "
        "long-context cell on both production meshes, gemma3-1b train_4k), "
        "meta against the card")
    dryrun = phase_dryrun(dev, smi)
    _free()

    log("phase 14: the examples (quickstart, serve_events on the bundled "
        "recording under every lowering and mode, train_dvs_gesture at full "
        "width, event_sparsity, serve_lm)")
    examples = phase_examples(dev, smi)

    # a kernel of no serving path reports its count summed over every
    # lowering's run (phase 4 holds it at 0); the per-step scatters add the
    # event path's launches to the per-step lowering's, and every serving
    # kernel the mesh runs' launches and the examples' (phase 14)
    launches = {k: (main_path["launches"][PATH_OF[k]][k] if PATH_OF[k]
                    else sum(main_path["launches"][f][k] for f in LOWERINGS))
                + event_path["launches"].get(k, 0) + mesh["launches"][k]
                + examples["launches"].get(k, 0)
                for k in REPLACES}
    kernels = [_kernel_entry(name, [r for r in rows if r["kernel"] == name],
                             launches) for name in REPLACES]
    summary = {"serving": main_path["serving"],
               "fused_network_plan": main_path["plans"],
               "peak_device_memory_bytes":
                   main_path["peak_device_memory_bytes"],
               "trace": main_path["trace"], "streaming": streaming,
               "training": training, "event_path": event_path,
               "mesh": mesh, "lm_serve": lm_serve, "lm_archs": lm_archs,
               "lm_train": lm_train, "lm_sharded": lm_sharded,
               "dryrun": dryrun, "examples": examples, "build_s": secs,
               "total_s": time.perf_counter() - t_start, "card": smi}
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"kernels": kernels, **summary}, f, indent=1)
    log(json.dumps({k: v for k, v in summary.items()
                    if k not in ("trace", "streaming", "training",
                                 "event_path", "mesh", "lm_serve",
                                 "lm_archs", "lm_train", "lm_sharded",
                                 "dryrun", "examples")}))
    log(json.dumps({"kernels": [{k: v for k, v in kk.items()
                                 if k != "per_shape"} for kk in kernels]}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
